"""Import hygiene of the port: ``muax_tpu_torch`` (every module of it) and
``chip_smoke`` import neither JAX nor the JAX package; and the port's
packages export the JAX package's public names."""
import importlib
import importlib.util
import inspect
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import muax_tpu_torch
names = [m.name for m in pkgutil.walk_packages(muax_tpu_torch.__path__,
                                                "muax_tpu_torch.")]
for name in names:
  try:
    importlib.import_module(name)
  except ImportError as e:
    # The sb3 bridge needs stable-baselines3, which neither machine has;
    # its gate raises this.
    if not (name.endswith(".sb3_bridge") and "stable-baselines3" in str(e)):
      raise
import chip_smoke
banned = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "haiku", "flax",
                                       "optax", "muax_tpu"))
print(len(names), banned)
print(" ".join(names))
"""

# The modules of the training slice and of the generic search engine,
# besides those of self-play.
TRAINING = ("ops.gradients", "models.losses", "models.optimizers",
            "models.fused_learner", "replay.buffer", "replay.fused_sampler",
            "utils.debug", "train.learner", "train.checkpoint", "train.fit",
            "fused_status")
ENGINE = ("search.seq_halving", "search.tree", "search.qtransforms",
          "search.action_selection", "search.core", "search.policies",
          "examples.parity_cartpole")
# The acme categorical slice's modules (the kernels' categorical modes live
# in search.fused and models.fused_learner).
ACME = ("models.acme_networks", "models.convert", "train.inference",
        "config", "search.fused", "train.actor")
# Stochastic MuZero's modules (its kernel's wrapper lives in search.fused,
# the sampler's per_step_obs mode in replay.fused_sampler).
SMZ = ("models.stochastic_networks", "models.stochastic_losses",
       "search.types", "search.policies", "train.learner", "fused_status")
# Reanalyze, the board games, AlphaZero and the env models.
BOARD = ("train.reanalyze", "envs.catch", "envs.board", "envs.tictactoe",
         "envs.connect4", "models.az_networks", "train.selfplay",
         "models.env_model")
# The conv and pixel path and the helpers ported beside it.
PIXEL = ("models.networks", "ops.normalize", "ops.frames",
         "ops.augmentations", "ops.gradients", "ops.returns", "envs.pixel",
         "envs.wrappers", "utils.debug")
# The host environments, their registry and the 2048 example.
HOST = ("envs.registry", "envs.gym_adapter", "envs.native2048",
        "envs.atari", "envs.open_spiel_adapter", "examples.run_2048")
# The remaining search policies and the host-facing surface.
SURFACE = ("models.diffusion", "models.diffusion_networks",
           "models.diffusion_losses", "search.sampled_policy",
           "search.diffusion_policy", "replay.tracer", "agents",
           "agents.muzero", "agents.stochastic", "agents.diffusion",
           "monitor", "utils.profiling", "adapters", "adapters.sb3",
           "adapters.sb3.buffers", "adapters.sb3.sb3_bridge")
# The parallel layer over torch.distributed.
PARALLEL = ("parallel", "parallel.mesh", "parallel.sharded",
            "parallel.multihost", "parallel.model_parallel",
            "parallel.launch")


def test_port_imports_no_jax():
  out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
  assert out.returncode == 0, out.stderr
  head, names = out.stdout.strip().splitlines()
  count, banned = head.split(" ", 1)
  assert int(count) >= 45, out.stdout  # every module of the port was loaded
  for name in (TRAINING + ENGINE + ACME + SMZ + BOARD + PIXEL + HOST
               + SURFACE + PARALLEL):
    assert "muax_tpu_torch." + name in names.split(), name
  assert banned == "[]", banned


def _public(module):
  return {n for n in vars(module) if not n.startswith("_")
          and n not in ("annotations",)}


@pytest.mark.parametrize("package", ["", "search", "models", "replay",
                                     "utils", "agents", "parallel"])
def test_port_exports_the_jax_public_names(package):
  """Every public name of ``muax_tpu.<package>`` is one of
  ``muax_tpu_torch.<package>``'s; a submodule needs its counterpart
  module."""
  suffix = "." + package if package else ""
  ref = importlib.import_module("muax_tpu" + suffix)
  port = importlib.import_module("muax_tpu_torch" + suffix)
  missing = []
  for name in sorted(_public(ref)):
    if inspect.ismodule(getattr(ref, name)):
      # A submodule (imported there by any module): its counterpart exists.
      if importlib.util.find_spec(f"muax_tpu_torch{suffix}.{name}") is None:
        missing.append(name)
    elif not hasattr(port, name):
      missing.append(name)
  assert not missing, missing
