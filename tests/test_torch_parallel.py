"""The port's parallel layer (``muax_tpu_torch/parallel``) on the CPU: four
gloo ranks, spawned, against ``tests/test_parallel.py``'s virtual
8-device mesh.

One group of four processes (``tests/torch_parallel_workers.py``, which
imports nothing of JAX) runs every multi-rank scenario once, under a
timeout that kills it; the tests below read its results. The JAX side runs
here: its init parameters go to the ranks as numpy arrays, and its
``shard_map`` update and replicated AlphaZero apply are what the ranks'
results are held against.
"""
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from muax_tpu_torch.models import make_az_resnet
from muax_tpu_torch.models.convert import _leaves
from muax_tpu_torch.parallel import sharded_fraction
from muax_tpu_torch.parallel.launch import spawn_group
from muax_tpu_torch.parallel.model_parallel import (az_partition_spec,
                                                    local_shard)

WORLD = 4
GROUP_TIMEOUT_S = 170
TOWERS = ("representation", "prediction", "dynamic")
AZ_OBS_SHAPE = (6, 7, 2)


def _jax_inputs():
  import jax
  import jax.numpy as jnp

  from muax_tpu.models import make_mlp_networks as j_make
  from muax_tpu.models.az_networks import make_az_resnet as j_az

  j_net = j_make(**workers.NET)
  j_params = j_net.init_params(jax.random.PRNGKey(0), jnp.zeros((1, 4)))
  az = j_az(7, channels=16, num_blocks=2)
  az_params = az.init_params(jax.random.PRNGKey(0),
                             jnp.zeros((1,) + AZ_OBS_SHAPE))
  obs = jax.random.normal(jax.random.PRNGKey(1), (8,) + AZ_OBS_SHAPE)
  logits, value = az.apply(az_params, obs)
  return {
      "j_net": j_net, "j_params": j_params,
      "ranks": {"mlp_tree": {n: jax.tree.map(np.asarray, getattr(j_params, n))
                             for n in TOWERS},
                "az_tree": jax.tree.map(np.asarray, az_params.network),
                "az_obs": np.asarray(obs)},
      "az_logits": np.asarray(logits), "az_value": np.asarray(value)}


@pytest.fixture(scope="module")
def jax_side():
  return _jax_inputs()


@pytest.fixture(scope="module")
def ranks(jax_side):
  """Every rank's results (a list in rank order)."""
  return spawn_group(workers.worker, WORLD, (jax_side["ranks"],),
                     timeout=GROUP_TIMEOUT_S)


# ---- the sharded program (tests/test_parallel.py:30-122) -------------------


def test_runs_and_replicates_params(ranks):
  config = workers.small_config()
  for r in ranks:
    states = r["sharded"]["states"]
    assert states[2]["step"] == 3 * config.train.updates_per_iteration
    assert all(np.isfinite(r["sharded"]["losses"]))
  # Every rank holds the same replicated parameters after every iteration,
  # starting from rank 0's broadcast ones.
  for r in ranks[1:]:
    assert np.array_equal(r["sharded"]["init"]["params"],
                          ranks[0]["sharded"]["init"]["params"])
    for mine, first in zip(r["sharded"]["states"][:3],
                           ranks[0]["sharded"]["states"][:3]):
      assert np.array_equal(mine["params"], first["params"])


def test_shards_fill_independently(ranks):
  config = workers.small_config()
  for r in ranks:
    # Every shard wrote num_envs / 4 segments into its own ring.
    assert r["sharded"]["total_added"][0] == config.train.num_envs // WORLD


def test_matches_gradients_across_shards(ranks):
  """The averaged update keeps parameters and optimizer state
  bit-identical on every rank, and it did move them."""
  first = ranks[0]["sharded"]["states"][0]
  assert not np.array_equal(first["params"],
                            ranks[0]["sharded"]["init"]["params"])
  for r in ranks[1:]:
    mine = r["sharded"]["states"][0]
    assert np.array_equal(mine["params"], first["params"])
    assert np.array_equal(mine["opt"], first["opt"])


def test_rejects_bad_divisibility(ranks):
  for r in ranks:
    errors = r["sharded"]["divisibility_errors"]
    assert "num_envs=10" in errors[0]
    assert "batch_size=18" in errors[1]
    assert "reanalyze_segments=6" in errors[2]


def test_reanalyze_on_the_mesh(ranks):
  """program.reanalyze refreshes every rank's own ring: the segments are
  summed over the ranks, the newest stamp of every ring is the step, the
  targets change, and the next iteration's staleness does not grow."""
  for r in ranks:
    re = r["sharded"]["reanalyze"]
    assert re["segments"] == 16
    assert np.isfinite(re["value_shift"])
    assert re["newest_stamp"] == re["step"]
    assert re["pi_changed"]
    assert re["staleness_after"] < re["staleness_before"] + 1.0


def test_no_reanalyze_by_default(ranks):
  assert all(r["sharded"]["default_reanalyze"] is None for r in ranks)


# ---- the learner's group against JAX's axis_name (:205-289) ---------------


def _jax_shard_map_update(jax_side):
  """JAX's ``make_multi_update_fn(..., axis_name=DATA_AXIS)`` under
  ``shard_map`` on four of the virtual devices, on its XLA path, over the
  same window-invariant rings (``TestFusedPathUnderShardMap``)."""
  import jax
  import jax.numpy as jnp
  import optax
  from jax import shard_map
  from jax.sharding import NamedSharding, PartitionSpec as P

  from muax_tpu.config import (MuZeroConfig, ReplayConfig, SearchConfig,
                               TrainConfig)
  from muax_tpu.parallel import DATA_AXIS, make_mesh
  from muax_tpu.replay.buffer import replay_add, replay_init
  from muax_tpu.train.learner import TrainState, make_multi_update_fn
  from muax_tpu.types import Transition

  def uniform_replay(shard, capacity=16, L=8):
    K = capacity
    segs = Transition(
        obs=jnp.full((K, L, 4), 0.1 + 0.05 * shard),
        action=jnp.ones((K, L), jnp.int32),
        reward=jnp.full((K, L), 0.25), done=jnp.zeros((K, L), bool),
        rn=jnp.full((K, L), 0.5 + 0.1 * shard), value=jnp.zeros((K, L)),
        pi=jnp.full((K, L, 2), 0.5), weight=jnp.ones((K,)),
        mask=jnp.ones((K, L)))
    return replay_add(replay_init(capacity, L, (4,), 2), segs,
                      jnp.ones((K, L)))

  mesh = make_mesh(devices=jax.devices()[:WORLD])
  config = MuZeroConfig(
      search=SearchConfig(num_simulations=4),
      replay=ReplayConfig(capacity=16, min_fill=4),
      train=TrainConfig(num_envs=8, collect_steps=8, batch_size=128,
                        updates_per_iteration=1, unroll_steps=3,
                        n_bootstrap=4, presample_updates=1,
                        fused_learner=False, fused_sampler=False))
  opt = optax.sgd(1e-2)
  params = jax_side["j_params"]
  ts = TrainState(params=params, opt_state=opt.init(params),
                  step=jnp.asarray(0, jnp.int32))
  mu = make_multi_update_fn(jax_side["j_net"], opt, config,
                            axis_name=DATA_AXIS)
  locals_ = [uniform_replay(i) for i in range(WORLD)]
  global_replay = jax.tree.map(
      lambda *xs: jnp.stack(xs).reshape((-1,) + xs[0].shape[1:])
      if xs[0].ndim else jnp.stack(xs), *locals_)
  global_replay = jax.device_put(global_replay,
                                 NamedSharding(mesh, P(DATA_AXIS)))

  def local_fn(ts, rs, rng):
    rs = rs.replace(cursor=rs.cursor[0], total_added=rs.total_added[0])
    rng = jax.random.fold_in(rng, jax.lax.axis_index(DATA_AXIS))
    return mu(ts, rs, rng)[0]

  step = jax.jit(shard_map(local_fn, mesh=mesh,
                           in_specs=(P(), P(DATA_AXIS), P()), out_specs=P(),
                           check_vma=False))
  out = step(ts, global_replay, jax.random.PRNGKey(3))
  return {n: jax.tree.map(np.asarray, getattr(out.params, n))
          for n in TOWERS}


@pytest.fixture(scope="module")
def jax_update(jax_side):
  return _jax_shard_map_update(jax_side)


@pytest.mark.parametrize("path", list(workers.PATHS))
def test_update_matches_jax_shard_map(ranks, jax_update, path):
  """Four ranks' averaged update, on each of the port's learner paths (raw
  and hybrid through the kernels' plain versions, and generic), agrees with
  JAX's pmean'd update from the same init (SGD 1e-2), and the ranks agree
  bit for bit."""
  from muax_tpu_torch.models import make_mlp_networks, mlp_params_from_numpy
  from muax_tpu_torch.models.optimizers import flat_parameters

  net = make_mlp_networks(device="cpu", **workers.NET)
  ref = flat_parameters(mlp_params_from_numpy(jax_update, net)).numpy()
  assert ranks[0]["learner"][f"mode_{path}"] == (
      None if path == "generic" else path)
  for r in ranks:
    np.testing.assert_allclose(r["learner"][f"params_{path}"], ref,
                               rtol=3e-4, atol=3e-4)
    assert np.array_equal(r["learner"][f"params_{path}"],
                          ranks[0]["learner"][f"params_{path}"])


def test_group_of_one_gives_the_same_bits(ranks):
  """A group of one rank issues no collective, as a pmean over an axis of
  size 1 costs nothing, and changes no bit of the update (two updates with
  adam)."""
  for r in ranks:
    alone, none = r["learner"]["world1_alone"], r["learner"]["world1_none"]
    assert alone["all_reduces"] == none["all_reduces"] == 0
    assert np.array_equal(alone["params"], none["params"])
    assert np.array_equal(alone["opt"], none["opt"])


@pytest.mark.parametrize("path", list(workers.PATHS))
def test_one_all_reduce_an_update(ranks, path):
  """Over the 4 ranks' group, every path of the learner issues exactly one
  all-reduce for its one update: the gradient's."""
  for r in ranks:
    assert r["learner"][f"all_reduces_{path}"] == 1


# ---- the channel-sharded AlphaZero tower (:125-203) -------------------------


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_model_parallel_matches_replicated(ranks, jax_side, shape):
  """``make_az_resnet(7, 16, 2)`` with its channels split over the model
  axis gives each data shard JAX's replicated outputs; a [3, 3, 16, 16]
  conv's shard has 16 / model output channels."""
  data, model = shape
  n = 8 // data
  for r in ranks:
    out = r["model_parallel"][shape]
    assert out["conv_global"] == (16, 16, 3, 3)
    assert out["conv_local"] == (16 // model, 16, 3, 3)
    rows = slice(out["data_index"] * n, (out["data_index"] + 1) * n)
    np.testing.assert_allclose(out["logits"], jax_side["az_logits"][rows],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out["value"], jax_side["az_value"][rows],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("model_size", [2, 3, 4])
def test_partition_rule_matches_jax(model_size):
  """``az_partition_spec`` on each torch parameter gives JAX's spec for its
  haiku counterpart (``models/convert.py`` pairs them)."""
  import jax
  import jax.numpy as jnp
  from jax.sharding import PartitionSpec as P

  from muax_tpu.models.az_networks import make_az_resnet as j_az
  from muax_tpu.parallel.model_parallel import az_partition_spec as j_spec

  shapes = jax.eval_shape(j_az(7, channels=16, num_blocks=2).init_params,
                          jax.random.PRNGKey(0),
                          jnp.zeros((1,) + AZ_OBS_SHAPE)).network
  params = make_az_resnet(7, channels=16, num_blocks=2,
                          device="cpu").init_params(AZ_OBS_SHAPE)
  for name, module in params.network.haiku_modules():
    for leaf, p, _, _ in _leaves(module):
      assert P(*az_partition_spec(p, model_size)) == j_spec(
          shapes[name][leaf], model_size), (name, leaf)


def test_go_scale_sharded_fraction():
  """The Go resnet (19 blocks x 256 channels on 19 x 19 x 17 planes): the
  rule shards over 90 % of its 20M+ parameters on a 4-way model axis, as
  many as JAX's rule on the same shapes, and a 256-channel conv's shard
  has 64 output channels."""
  import jax
  import jax.numpy as jnp

  from muax_tpu.models.az_networks import make_az_resnet as j_az
  from muax_tpu.parallel import MODEL_AXIS
  from muax_tpu.parallel import make_mesh as j_make_mesh
  from muax_tpu.parallel import sharded_fraction as j_fraction

  shapes = jax.eval_shape(j_az(19 * 19 + 1, channels=256,
                               num_blocks=19).init_params,
                          jax.random.PRNGKey(0), jnp.zeros((1, 19, 19, 17)))
  j_mesh = j_make_mesh((2, 4), axis_names=("data", MODEL_AXIS))
  params = make_az_resnet(19 * 19 + 1, channels=256, num_blocks=19,
                          device="cpu").init_params((19, 19, 17))
  assert sum(p.numel() for p in params.parameters()) > 20e6
  frac = sharded_fraction(params, 4)
  assert frac > 0.9, frac
  assert frac == j_fraction(shapes.network, j_mesh)
  conv = params.network.blocks[0].conv_in.weight
  assert conv.shape[0] == 256
  shards = [local_shard(conv, 4, i) for i in range(4)]
  assert all(s.shape == (64, 256, 3, 3) for s in shards)
  assert torch.equal(torch.cat(shards), conv)
