"""The port's example scripts (``muax_tpu_torch/examples/run_*.py``) on the
CPU, against the JAX package's (``examples/run_*.py``).

- Each port script's ``main`` runs in-process with ``--device cpu`` at the
  command lines of ``tests/test_examples.py`` (a checkpoint directory under
  the test's own where the script takes one); the LunarLander case is
  Box2D-gated as there.
- Each builds the JAX script's configuration: both scripts run at the same
  command line with their entry (``fit``, ``make_az_selfplay_fn``, or the
  MCTS policy factory) replaced by a stub that stops them, the JAX script in
  one subprocess for every case; the calls to the factories (networks,
  optimizers, config, pools, policies) and the entry are recorded with
  their bound arguments, and every argument the two signatures share must
  agree (configs field by field, envs and pools by their spec).
- ``run_mcts``'s ``net_loss`` and its gradient match the JAX expression of
  ``examples/run_mcts.py:103-123`` on seeded numpy inputs, rtol 1e-5.
"""
import importlib
import inspect
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muax_tpu.models.az_networks import make_az_mlp as j_make_az_mlp
from muax_tpu.ops import segment_n_step_returns as j_returns
from muax_tpu_torch.models import make_az_mlp
from muax_tpu_torch.models.convert import (az_grads_to_numpy,
                                           az_params_from_numpy)
from muax_tpu_torch.examples import run_mcts
from tests.test_torch_parity import one_thread  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_examples.py's command lines (its lines 34-77), by script.
CASES = {
    "cartpole": ("run_cartpole",
                 ["--num_iterations", "2", "--num_simulations", "2",
                  "--num_envs", "8", "--batch_size", "8"]),
    "acme_regime": ("run_acme_regime",
                    ["--num_iterations", "2", "--num_envs", "8"]),
    "tictactoe": ("run_tictactoe_alphazero",
                  ["--iterations", "2", "--num_simulations", "4",
                   "--num_envs", "8"]),
    "connect4": ("run_connect4",
                 ["--iterations", "2", "--num_simulations", "4",
                  "--num_envs", "8", "--batch_size", "16", "--eval_every",
                  "2", "--num_blocks", "1", "--channels", "8"]),
    "mcts": ("run_mcts", ["--iterations", "2", "--num_simulations", "4",
                          "--num_envs", "8"]),
    "mcts_learned": ("run_mcts", ["--nosimulator", "--iterations", "2",
                                  "--num_simulations", "4", "--num_envs",
                                  "8"]),
    "pixel": ("run_pixel",
              ["--num_iterations", "2", "--num_simulations", "2",
               "--num_envs", "8", "--batch_size", "8", "--scale", "2",
               "--channels", "4"]),
    "atari_measure": ("run_atari", ["--fake", "--measure_pool",
                                    "--num_envs", "2"]),
    "2048": ("run_2048",
             ["--num_iterations", "1", "--num_simulations", "2",
              "--num_envs", "4", "--batch_size", "8",
              "--updates_per_iteration", "1"]),
    "lunarlander": ("run_lunarlander",
                    ["--num_iterations", "1", "--num_simulations", "2",
                     "--num_envs", "4", "--batch_size", "8",
                     "--updates_per_iteration", "1"]),
}
# The scripts whose configuration is captured: the training cases above,
# and run_atari's fake training (its --measure_pool case builds none).
CAPTURED = {k: v for k, v in CASES.items() if k != "atari_measure"}
CAPTURED["atari"] = ("run_atari", ["--fake", "--num_envs", "2"])
# Scripts that take a checkpoint directory.
MODEL_DIR = ("run_cartpole", "run_pixel", "run_2048", "run_lunarlander")
# The acme regime's first greedy evaluation (32 CartPole envs x 50
# simulations through the plain search, about 0.25 s a step on one thread)
# runs until the longest episode ends, up to 500 steps. Its case caps the
# evaluation's episodes at EVAL_STEPS steps through fit's ``eval_env``; the
# rest of main runs as the script has it, and the capture test below holds
# its configuration.
SHORT_EVAL, EVAL_STEPS = ("run_acme_regime",), 10


def _box2d(key):
  if key == "lunarlander":
    pytest.importorskip("Box2D", reason="gymnasium[box2d] not installed")


def _short_eval(module, monkeypatch):
  """``module.fit`` with a greedy evaluation on a CartPole whose episodes
  end after EVAL_STEPS steps."""
  from muax_tpu_torch.envs import CartPole
  real = module.fit
  env = CartPole()
  env.spec = env.spec._replace(max_episode_steps=EVAL_STEPS)
  monkeypatch.setattr(module, "fit",
                      lambda *a, **kw: real(*a, eval_env=env, **kw))


@pytest.mark.parametrize("key", sorted(CASES))
def test_port_example_runs(key, tmp_path, one_thread, capsys, monkeypatch):
  _box2d(key)
  name, argv = CASES[key]
  module = importlib.import_module(f"muax_tpu_torch.examples.{name}")
  if name in MODEL_DIR:
    argv = argv + ["--model_dir", str(tmp_path / "models")]
  if name in SHORT_EVAL:
    _short_eval(module, monkeypatch)
  out = module.main(argv + ["--device", "cpu"])
  assert out is not None
  text = capsys.readouterr().out
  if name == "run_mcts":
    loss, rate, model = out
    assert np.isfinite(loss) and 0.0 <= rate <= 1.0
    assert (model is None) == ("--nosimulator" not in argv)
  elif name in ("run_tictactoe_alphazero", "run_connect4"):
    # connect4 evaluates every 2 iterations; tictactoe every 20.
    assert len(out) == (1 if name == "run_connect4" else 0)
    for *_, score in out:
      assert -1.0 <= score <= 1.0
  elif name == "run_atari":
    assert out > 0 and "host pool ceiling" in text
  else:
    _, results = out
    assert results["history"]
    if name in SHORT_EVAL:
      assert np.isfinite(results["history"][0]["test_G"])
    for row in results["history"]:
      assert all(np.isfinite(v) for v in row.values()), row


# ---- the configuration each script builds ---------------------------------

# The factories and entries recorded on both sides (by name, in every loaded
# module of the package that holds them and in ``optax``), and each
# script's entry, where the stub stops it.
RECORDED = ("make_mlp_networks", "make_efficientzero_networks", "make_az_mlp",
            "make_az_resnet", "muzero_optimizer", "create_optimizer",
            "acme_defaults", "adam", "make_mlp_transition_model",
            "model_replay_init", "make_model_update_fn",
            "make_model_policy_fn", "make_simulator_policy_fn",
            "make_az_selfplay_fn", "make_az_update_fn", "fit")
ENTRIES = ("fit", "make_az_selfplay_fn", "make_model_policy_fn",
           "make_simulator_policy_fn")
# Arguments that differ by design: the device, where checkpoints go, and
# the log function.
IGNORED = ("device", "model_dir", "log_fn")

_CAPTURE = textwrap.dedent('''
    import dataclasses, enum, inspect, json, os, runpy, sys
    sys.path.insert(0, %(repo)r)
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    jax.config.update("jax_platform_name", "cpu")
    from absl import flags
    import optax
    import muax_tpu, muax_tpu.models, muax_tpu.train.fit
    import muax_tpu.train.selfplay, muax_tpu.models.env_model
    from muax_tpu.envs import gym_adapter
    from muax_tpu.models import az_networks
    # The capture reads the scripts' calls, not what they compute: no probe
    # of the backend and no AlphaZero weights (haiku's eager init).
    gym_adapter.ensure_host_callback_backend = lambda *a, **k: True
    az_networks.AZNetwork.init_params = (
        lambda self, rng, obs: az_networks.AZParams(network={},
                                                    temperature=None))
    %(normalize)s
    RECORDED, ENTRIES = %(recorded)r, %(entries)r

    class Stop(Exception):
      pass

    calls = {}

    def patch():
      for mod in [m for n, m in list(sys.modules.items())
                  if n.split(".")[0] in ("muax_tpu", "optax") and m]:
        for name in RECORDED:
          fn = getattr(mod, name, None)
          if fn is None or getattr(fn, "recorder", False):
            continue
          def rec(*a, _fn=fn, _name=name, **kw):
            bound = inspect.signature(_fn).bind(*a, **kw)
            bound.apply_defaults()
            calls.setdefault(_name, normalize(dict(bound.arguments)))
            if _name in ENTRIES:
              raise Stop()
            return _fn(*a, **kw)
          rec.recorder = True
          setattr(mod, name, rec)

    out = {}
    for key, script, argv in json.loads(sys.argv[1]):
      before = set(flags.FLAGS)
      g = runpy.run_path(os.path.join(%(repo)r, "examples", script + ".py"),
                         run_name="capture")
      flags.FLAGS.unparse_flags()
      flags.FLAGS([script] + argv)
      calls.clear()
      patch()
      try:
        g["main"]([])
      except Stop:
        pass
      out[key] = dict(calls)
      for name in set(flags.FLAGS) - before:
        delattr(flags.FLAGS, name)
    print("CAPTURED " + json.dumps(out))
''')


def normalize(x):
  """A JSON-able picture of an argument: configs field by field, envs and
  pools by their spec, dtypes by name; other objects (networks, params,
  optimizers' states) stand for nothing the comparison reads."""
  import dataclasses
  if isinstance(x, dict):
    return {str(k): normalize(v) for k, v in x.items()}
  if hasattr(x, "_asdict"):
    return normalize(x._asdict())
  if dataclasses.is_dataclass(x) and not isinstance(x, type):
    return normalize({f.name: getattr(x, f.name)
                      for f in dataclasses.fields(x)})
  if isinstance(x, (list, tuple)):
    return [normalize(v) for v in x]
  if x is None or isinstance(x, (bool, int, float, str)):
    return x
  if hasattr(x, "spec") and hasattr(x.spec, "observation_shape"):
    return {"spec": normalize(x.spec)}
  name = getattr(x, "__name__", None) or getattr(x, "name", None)
  if "dtype" in type(x).__name__.lower() or str(x).startswith("torch."):
    return str(name or x).replace("torch.", "")
  if isinstance(x, type) and name in ("uint8", "float32", "int8"):
    return name
  if callable(x):
    return "<callable>"
  return "<object>"


@pytest.fixture(scope="module")
def jax_calls():
  """The JAX scripts' recorded calls, every case in one subprocess."""
  cases = [(key, name, argv) for key, (name, argv) in CAPTURED.items()
           if key != "lunarlander" or _has_box2d()]
  code = _CAPTURE % {"repo": REPO,
                     "normalize": inspect.getsource(normalize),
                     "recorded": RECORDED, "entries": ENTRIES}
  proc = subprocess.run([sys.executable, "-c", code, json.dumps(cases)],
                        capture_output=True, text=True, timeout=600,
                        cwd=REPO)
  line = [l for l in proc.stdout.splitlines() if l.startswith("CAPTURED ")]
  assert proc.returncode == 0 and line, proc.stderr[-4000:]
  return json.loads(line[0][len("CAPTURED "):])


def _has_box2d():
  try:
    import Box2D  # noqa: F401
    return True
  except ImportError:
    return False


def _port_calls(name, argv, monkeypatch):
  """The port script's recorded calls at ``argv`` on the CPU, stopped at
  its entry."""
  class Stop(Exception):
    pass

  calls = {}
  module = importlib.import_module(f"muax_tpu_torch.examples.{name}")
  for mod in [m for n, m in list(sys.modules.items())
              if n.split(".")[0] == "muax_tpu_torch" and m]:
    for fname in RECORDED:
      fn = getattr(mod, fname, None)
      if fn is None:
        continue
      # A module imported under an earlier case's patch still holds that
      # case's recorder: record from its original.
      fn = getattr(fn, "recorded", fn)

      def rec(*a, _fn=fn, _name=fname, **kw):
        bound = inspect.signature(_fn).bind(*a, **kw)
        bound.apply_defaults()
        calls.setdefault(_name, normalize(dict(bound.arguments)))
        if _name in ENTRIES:
          raise Stop()
        return _fn(*a, **kw)
      rec.recorded = fn
      monkeypatch.setattr(mod, fname, rec)
  with pytest.raises(Stop):
    module.main(argv + ["--device", "cpu"])
  return calls


def _agree(port, ref, where):
  if isinstance(ref, dict) and isinstance(port, dict):
    for k in sorted(set(ref) & set(port) - set(IGNORED)):
      _agree(port[k], ref[k], f"{where}.{k}")
  elif isinstance(ref, float) or isinstance(port, float):
    assert port == pytest.approx(ref, rel=1e-12), where
  else:
    assert port == ref, where


@pytest.mark.parametrize("key", sorted(CAPTURED))
def test_setup_builds_the_jax_scripts_config(key, jax_calls, monkeypatch,
                                             one_thread):
  _box2d(key)
  name, argv = CAPTURED[key]
  ref = jax_calls[key]
  port = _port_calls(name, argv, monkeypatch)
  entry = [n for n in ENTRIES if n in ref]
  assert len(entry) == 1 and entry[0] in port, (sorted(ref), sorted(port))
  # Every factory the JAX script called, the port's called too.
  assert set(ref) - {"adam"} <= set(port) | {"create_optimizer"}, (
      sorted(ref), sorted(port))
  for fname in sorted(set(ref) & set(port)):
    _agree(port[fname], ref[fname], f"{key}:{fname}")


# ---- run_mcts's network update --------------------------------------------

def test_mcts_net_loss_matches_jax():
  T, B, A, n = 10, 8, 3, 10
  obs_shape = (5, 5)
  j_net = j_make_az_mlp(A, hidden=(128, 128))
  j_params = j_net.init_params(jax.random.PRNGKey(0),
                               jnp.zeros((1,) + obs_shape))
  net = make_az_mlp(A, hidden=(128, 128), device="cpu")
  params = az_params_from_numpy(jax.tree.map(np.asarray, j_params.network),
                                net, obs_shape)
  rng = np.random.default_rng(3)
  steps = dict(
      obs=(rng.uniform(size=(T, B) + obs_shape) < 0.2).astype(np.float32),
      reward=rng.choice([-1.0, 0.0, 1.0], (T, B), p=[0.1, 0.8, 0.1])
      .astype(np.float32),
      done=rng.uniform(size=(T, B)) < 0.15,
      value=rng.uniform(-1, 1, (T, B)).astype(np.float32),
      pi=rng.dirichlet(np.ones(A), (T, B)).astype(np.float32))

  # examples/run_mcts.py:103-123, on the JAX package.
  def j_loss_fn(p):
    z = j_returns(jnp.asarray(steps["reward"]), jnp.asarray(steps["value"]),
                  jnp.asarray(steps["done"]).astype(jnp.float32),
                  discount=1.0, n=n)
    obs = jnp.asarray(steps["obs"]).reshape((-1,) + obs_shape)
    pi = jnp.asarray(steps["pi"]).reshape((-1, A))
    logits, value = j_net.apply(p, obs)
    policy_loss = -jnp.mean(jnp.sum(
        jax.lax.stop_gradient(pi) * jax.nn.log_softmax(logits, -1), -1))
    value_loss = jnp.mean(jnp.square(value - jax.lax.stop_gradient(
        z.reshape(-1))))
    return policy_loss + value_loss

  j_loss, j_grads = jax.value_and_grad(j_loss_fn)(j_params)
  loss = run_mcts.net_loss(net, params,
                           {k: torch.from_numpy(v) for k, v in steps.items()},
                           n)
  grads = torch.autograd.grad(loss, list(params.parameters()))
  np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
  port = az_grads_to_numpy(params, torch.cat([g.reshape(-1) for g in grads]))
  for module, leaves in jax.tree.map(np.asarray, j_grads.network).items():
    for leaf, ref in leaves.items():
      np.testing.assert_allclose(port[module][leaf], ref, rtol=1e-5,
                                 atol=1e-7, err_msg=f"{module}/{leaf}")
