"""Shared helpers of the port's parity tests (the same seeded numpy inputs
for the JAX package and ``muax_tpu_torch``, and their comparison), and the
tests of the converters between the two."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muax_tpu.models import make_mlp_networks as j_make
from muax_tpu.replay.buffer import replay_add as j_replay_add
from muax_tpu.replay.buffer import replay_init as j_replay_init
from muax_tpu.types import Transition as JTransition
from muax_tpu_torch.models import make_mlp_networks, mlp_params_from_numpy
from muax_tpu_torch.models.convert import replay_state_from_numpy
from muax_tpu_torch.types import Transition

TOWERS = ("representation", "prediction", "dynamic")


@pytest.fixture
def one_thread():
  """One intra-op thread for the test, restored after it. Under the
  suite's parallel workers, a test of many small CPU ops (the conv nets'
  generic-engine searches) otherwise waits on contended OpenMP threads:
  ``fit`` on pixel Catch took 700 s there against 7 s alone."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)
FIELDS = ("obs", "action", "reward", "done", "rn", "value", "pi", "weight",
          "mask")

# The network configurations of tests/test_fused_learner.py:35-40.
NET_CONFIGS = [
    dict(num_actions=2, embedding_dim=8, support_size=10),
    dict(num_actions=4, embedding_dim=10, support_size=20,
         repr_layers=(12,), pred_layers=(16, 12), dyn_layers=(16, 12)),
    dict(num_actions=3, embedding_dim=6, support_size=5, repr_layers=()),
]


def nets(cfg, obs_dim=4, seed=0):
  """JAX networks and params, and the port's (on the CPU) from the same
  numbers."""
  j_net = j_make(**cfg)
  j_params = jax.jit(j_net.init_params)(jax.random.PRNGKey(seed),
                                        jnp.zeros((1, obs_dim)))
  tree = {name: jax.tree.map(np.asarray, getattr(j_params, name))
          for name in TOWERS}
  net = make_mlp_networks(device="cpu", **cfg)
  return j_net, j_params, net, mlp_params_from_numpy(tree, net)


def batch_numpy(seed, B=32, L=5, obs_dim=4, num_actions=2, with_masks=True):
  """A seeded [B, L] window batch as numpy arrays (field -> array)."""
  rng = np.random.default_rng(seed)
  mask = np.ones((B, L), np.float32)
  if with_masks:
    lengths = rng.integers(1, L + 1, B)
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
  return dict(
      obs=rng.standard_normal((B, L, obs_dim)).astype(np.float32),
      action=rng.integers(0, num_actions, (B, L)).astype(np.int32),
      reward=rng.standard_normal((B, L)).astype(np.float32),
      done=np.zeros((B, L), bool),
      rn=(rng.standard_normal((B, L)) * 5).astype(np.float32),
      value=np.zeros((B, L), np.float32),
      pi=rng.dirichlet(np.ones(num_actions), (B, L)).astype(np.float32),
      weight=(rng.uniform(size=B) + 0.5).astype(np.float32),
      mask=mask)


def jax_batch(arrays) -> JTransition:
  return JTransition(**{k: jnp.asarray(arrays[k]) for k in FIELDS})


def torch_batch(arrays, device="cpu") -> Transition:
  return Transition(**{k: torch.from_numpy(np.array(arrays[k])).to(device)
                       for k in FIELDS})


def ring_numpy(seed, C=16, L=8, O=4, A=2, filled=12, done_rate=0.15,
               prios=None):
  """Seeded segments and priorities to fill a ring of capacity C."""
  rng = np.random.default_rng(seed)
  segs = dict(
      obs=rng.standard_normal((filled, L, O)).astype(np.float32),
      action=rng.integers(0, A, (filled, L)).astype(np.int32),
      reward=rng.uniform(size=(filled, L)).astype(np.float32),
      done=rng.uniform(size=(filled, L)) < done_rate,
      rn=(rng.uniform(size=(filled, L)) * 4 - 2).astype(np.float32),
      value=np.zeros((filled, L), np.float32),
      pi=rng.dirichlet(np.ones(A), (filled, L)).astype(np.float32),
      weight=np.ones((filled,), np.float32),
      mask=np.ones((filled, L), np.float32))
  if prios is None:
    prios = (rng.uniform(size=(filled, L)) + 0.1).astype(np.float32)
  return segs, prios


def jax_ring(segs, prios, C, L, O, A):
  return j_replay_add(j_replay_init(C, L, (O,), A), jax_batch(segs),
                      jnp.asarray(prios))


def torch_ring(j_state, device="cpu"):
  """The port's ring holding exactly the JAX ring's numbers."""
  return replay_state_from_numpy(jax.tree.map(np.asarray, j_state),
                                 device=device)


def assert_trees_close(port_tree, jax_tree, rtol, atol):
  """Leaf by leaf, haiku names on both sides."""
  jax_tree = {name: jax.tree.map(np.asarray, jax_tree[name])
              for name in TOWERS}
  assert set(port_tree) == set(jax_tree)
  for name in TOWERS:
    assert set(port_tree[name]) == set(jax_tree[name]), name
    for module, leaves in jax_tree[name].items():
      for key, ref in leaves.items():
        np.testing.assert_allclose(port_tree[name][module][key], ref,
                                   rtol=rtol, atol=atol,
                                   err_msg=f"{name}/{module}/{key}")


def test_converters_round_trip():
  """A haiku tree into the port's modules and back through the flat buffer
  gives the same tree; a JAX ring into the port's gives the same ring."""
  from muax_tpu_torch.models.convert import mlp_grads_to_numpy
  from muax_tpu_torch.models.optimizers import flat_parameters
  _, j_params, _, params = nets(NET_CONFIGS[1])
  back = mlp_grads_to_numpy(params, flat_parameters(params))
  assert_trees_close(back, j_params._asdict(), rtol=0, atol=0)
  segs, prios = ring_numpy(0)
  j_state = jax_ring(segs, prios, 16, 8, 4, 2)
  state = torch_ring(j_state)
  for name in ("obs", "action", "done", "pi", "step_priorities",
               "target_step"):
    np.testing.assert_array_equal(getattr(state, name).numpy(),
                                  np.asarray(getattr(j_state, name)))
  assert (state.cursor, state.total_added) == (12, 12)
