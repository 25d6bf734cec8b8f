"""Import hygiene of the port: ``muax_tpu_torch`` (every module of it) and
``chip_smoke`` import neither JAX nor the JAX package."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import muax_tpu_torch
names = [m.name for m in pkgutil.walk_packages(muax_tpu_torch.__path__,
                                                "muax_tpu_torch.")]
for name in names:
  importlib.import_module(name)
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


def test_port_imports_no_jax():
  out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
  assert out.returncode == 0, out.stderr
  head, names = out.stdout.strip().splitlines()
  count, banned = head.split(" ", 1)
  assert int(count) >= 45, out.stdout  # every module of the port was loaded
  for name in TRAINING + ENGINE + ACME + SMZ + BOARD + PIXEL + HOST:
    assert "muax_tpu_torch." + name in names.split(), name
  assert banned == "[]", banned
