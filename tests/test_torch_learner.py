"""The port's grouped learner (``make_multi_update_fn``) on the CPU.

One fused group is held against the JAX package's fused path (its Pallas
kernels in interpret mode, through the CPU test seam
``_ALLOW_FUSED_SAMPLER_ON_CPU``) with the JAX draws injected: the same
windows, two updates of ``muzero_optimizer``, the parameters after the group
at rtol 1e-4 / atol 1e-6 (two Adam steps on gradients that agree at
rtol 2e-4), and the refreshed priorities at rtol 1e-4 on the same windows. The properties ``tests/test_learner.py:245-318`` pins follow:
the gate counts global updates, a fully gated group leaves the priorities
alone, and the online tail spreads across chunks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import muax_tpu.train.learner as j_learner
from muax_tpu.config import MuZeroConfig as JConfig
from muax_tpu.config import ReplayConfig as JReplay
from muax_tpu.config import SearchConfig as JSearch
from muax_tpu.config import TrainConfig as JTrain
from muax_tpu.models.optimizers import muzero_optimizer as j_optimizer
from muax_tpu.replay.buffer import replay_add as j_replay_add
from muax_tpu_torch.config import (MuZeroConfig, ReplayConfig, SearchConfig,
                                   TrainConfig)
from muax_tpu_torch.models.convert import mlp_params_from_numpy
from muax_tpu_torch.models.optimizers import muzero_optimizer
from muax_tpu_torch.replay.buffer import replay_add
from muax_tpu_torch.train import learner
from tests.test_torch_parity import (TOWERS, jax_batch, jax_ring, nets,
                                     ring_numpy, torch_batch, torch_ring)

C, L, B, K = 32, 8, 64, 3
NET = dict(num_actions=2, embedding_dim=8, support_size=20)


def _config(cls_m=MuZeroConfig, cls_s=SearchConfig, cls_r=ReplayConfig,
            cls_t=TrainConfig, **train):
  kwargs = dict(num_envs=4, collect_steps=L, batch_size=B, unroll_steps=K,
                updates_per_iteration=2, presample_updates=2)
  kwargs.update(train)
  return cls_m(search=cls_s(num_simulations=2),
               replay=cls_r(capacity=C, min_fill=4, offline_fraction=0.5,
                            online_queue_size=8),
               train=cls_t(**kwargs))


def _setup(seed=1, **train):
  j_net, j_params, net, params = nets(NET)
  segs, prios = ring_numpy(seed, C, L, filled=24)
  j_rs = jax_ring(segs, prios, C, L, 4, 2)
  opt = muzero_optimizer(warmup_steps=2)
  config = _config(**train)
  ts = learner.TrainState(params=params, opt_state=opt.init(params), step=0)
  mu = learner.make_multi_update_fn(net, opt, config)
  return j_net, j_params, j_rs, net, params, ts, torch_ring(j_rs), mu


def test_one_fused_group_matches_jax(monkeypatch):
  monkeypatch.setattr(j_learner, "_ALLOW_FUSED_SAMPLER_ON_CPU", True)
  j_net, j_params, j_rs, net, params, ts, rs, mu = _setup()
  W = 2 * B
  j_opt = j_optimizer(warmup_steps=2)
  j_ts = j_learner.TrainState(params=j_params, opt_state=j_opt.init(j_params),
                              step=jnp.asarray(0, jnp.int32))
  j_mu = j_learner.make_multi_update_fn(
      j_net, j_opt, _config(JConfig, JSearch, JReplay, JTrain))
  assert j_mu.fused_group_status(j_ts, j_rs)[0] == "raw"
  key = jax.random.PRNGKey(2)
  j_ts2, j_rs2, j_metrics = j_mu(j_ts, j_rs, key)

  # The draws of the JAX group: split(key, 1) -> (segments, Gumbel); the
  # segment key splits again into the uniforms and the online offsets.
  seg_rng, gum_rng = jax.random.split(jax.random.split(key, 1)[0])
  u_rng, online_rng = jax.random.split(seg_rng)
  uniforms = np.array(jax.random.uniform(u_rng, (W,)))
  offsets = np.array(jax.random.randint(online_rng, (W // 2,), 1, 9))
  gumbel = np.array(jax.random.gumbel(gum_rng, (L, W), jnp.float32))
  prios_before = rs.step_priorities.clone()

  assert mu.fused_group_status(ts, rs)[0] == "raw"
  ts2, sums, done = mu.run_fused_group(
      ts, rs, 0, torch.from_numpy(uniforms), torch.from_numpy(offsets),
      torch.from_numpy(gumbel))
  assert done == 2 and ts2.step == 2 == int(j_ts2.step)
  np.testing.assert_allclose(float(sums[0]) / 2, float(j_metrics["loss"]),
                             rtol=1e-5)

  ref = mlp_params_from_numpy(
      {name: jax.tree.map(np.asarray, getattr(j_ts2.params, name))
       for name in TOWERS}, net)
  for name, p in ts2.params.named_parameters():
    np.testing.assert_allclose(p.detach().numpy(),
                               dict(ref.named_parameters())[name].detach()
                               .numpy(), rtol=1e-4, atol=1e-6, err_msg=name)

  new, ref_new = rs.step_priorities.numpy(), np.asarray(j_rs2.step_priorities)
  changed = ref_new != prios_before.numpy()
  assert changed.sum() > 20
  np.testing.assert_array_equal(new != prios_before.numpy(), changed)
  np.testing.assert_allclose(new, ref_new, rtol=1e-4)


def _jax_group_draws(key, g, num_groups, W, L, window):
  """The draws of group g of the JAX package's fused multi-update: the
  call key splits into one key per group, each into (segments, Gumbel); the
  segment key splits again into the uniforms and the online offsets."""
  seg_rng, gum_rng = jax.random.split(jax.random.split(key, num_groups)[g])
  u_rng, online_rng = jax.random.split(seg_rng)
  uniforms = np.array(jax.random.uniform(u_rng, (W,)))
  offsets = np.array(jax.random.randint(online_rng, (W // 2,), 1,
                                        window + 1))
  gumbel = np.array(jax.random.gumbel(gum_rng, (L, W), jnp.float32))
  return (torch.from_numpy(uniforms), torch.from_numpy(offsets),
          torch.from_numpy(gumbel))


def test_fused_route_tracks_jax_across_iterations(monkeypatch):
  """The fused sampler and learner route as ``fit`` drives it: three
  iterations of two groups, with new segments entering both rings between
  iterations, the JAX draws injected. Each iteration starts from the JAX
  ring's priorities, so that a near-tie that f32 noise broke the other way
  in an earlier level-1 draw does not change every later window. After
  every iteration the priorities
  each route leaves in the ring agree (the same windows refreshed, values
  at rtol 1e-4 / atol 1e-3: a priority is |v0 - rn0|^0.5, whose slope
  0.5 / |v0 - rn0|^0.5 turns the f32 noise of v0, about 1e-4 after h^-1,
  into 5e-4 where v0 nearly equals rn0), and so do the parameters (rtol
  1e-4 / atol 1e-6) and the updates' loss."""
  monkeypatch.setattr(j_learner, "_ALLOW_FUSED_SAMPLER_ON_CPU", True)
  train = dict(updates_per_iteration=4, presample_updates=2)
  j_net, j_params, j_rs, net, params, ts, rs, mu = _setup(**train)
  j_opt = j_optimizer(warmup_steps=2)
  j_ts = j_learner.TrainState(params=j_params, opt_state=j_opt.init(j_params),
                              step=jnp.asarray(0, jnp.int32))
  j_mu = j_learner.make_multi_update_fn(
      j_net, j_opt, _config(JConfig, JSearch, JReplay, JTrain, **train))
  W = 2 * B
  for it in range(3):
    if it:  # new segments at the cursor, as each iteration's rollout adds
      segs, prios = ring_numpy(10 + it, C, L, filled=6)
      j_rs = j_replay_add(j_rs, jax_batch(segs), jnp.asarray(prios),
                          step=int(j_ts.step))
      replay_add(rs, torch_batch(segs), torch.from_numpy(prios), step=ts.step)
    key = jax.random.PRNGKey(20 + it)
    rs.step_priorities.copy_(torch.from_numpy(np.array(j_rs.step_priorities)))
    before = rs.step_priorities.clone()
    j_ts, j_rs, j_metrics = j_mu(j_ts, j_rs, key)
    loss = 0.0
    for g in range(2):
      draws = _jax_group_draws(key, g, 2, W, L, min(8, rs.size))
      ts, sums, done = mu.run_fused_group(ts, rs, g, *draws)
      loss += float(sums[0]) / 4
    assert ts.step == int(j_ts.step) == 4 * (it + 1)
    np.testing.assert_allclose(loss, float(j_metrics["loss"]), rtol=1e-4)
    ref_prios = np.asarray(j_rs.step_priorities)
    np.testing.assert_array_equal(rs.step_priorities.numpy() != before.numpy(),
                                  ref_prios != before.numpy())
    np.testing.assert_allclose(rs.step_priorities.numpy(), ref_prios,
                               rtol=1e-4, atol=1e-3)
    ref = mlp_params_from_numpy(
        {name: jax.tree.map(np.asarray, getattr(j_ts.params, name))
         for name in TOWERS}, net)
    for name, p in ts.params.named_parameters():
      np.testing.assert_allclose(p.detach().numpy(),
                                 dict(ref.named_parameters())[name].detach()
                                 .numpy(), rtol=1e-4, atol=1e-6,
                                 err_msg=f"iteration {it}: {name}")


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("allowed,expected", [(0, 0), (1, 1), (3, 3),
                                              (4, 4), (9, 4)])
def test_num_allowed_counts_global_updates(fused, allowed, expected):
  *_, ts, rs, mu = _setup(updates_per_iteration=4, fused_sampler=fused)
  before = rs.step_priorities.clone()
  flat = torch.cat([p.detach().reshape(-1) for p in ts.params.parameters()])
  ts, rs, metrics = mu(ts, rs, torch.Generator().manual_seed(0), allowed)
  assert ts.step == expected and metrics["updates_done"] == expected
  assert bool(torch.isfinite(metrics["loss"]))
  if expected == 0:  # a fully gated call moves nothing
    torch.testing.assert_close(rs.step_priorities, before, rtol=0, atol=0)
    after = torch.cat([p.detach().reshape(-1)
                       for p in ts.params.parameters()])
    torch.testing.assert_close(after, flat, rtol=0, atol=0)
  else:
    assert not torch.equal(rs.step_priorities, before)


def test_online_tail_spreads_across_chunks():
  group, Bc, num_online = 8, 32, 128
  tag = torch.cat([torch.zeros(group * Bc - num_online),
                   torch.ones(num_online)])
  big = learner.Transition(*(tag for _ in range(9)))
  chunks = learner._interleave_chunks(big, group, Bc)
  torch.testing.assert_close(chunks.obs.sum(1),
                             torch.full((group,), num_online / group))
  back = learner._deinterleave_flat(chunks.obs, Bc)
  torch.testing.assert_close(back, tag)
  # The fused path's lane permutation gives each chunk the same share.
  p = torch.arange(group * Bc)
  perm = (p % Bc) * group + p // Bc
  online = (perm >= group * Bc - num_online).reshape(group, Bc).sum(1)
  assert online.tolist() == [num_online // group] * group


def test_dispatch_reasons():
  *_, ts, rs, _ = _setup()
  net = nets(NET)[2]

  def status(**train):
    mu = learner.make_multi_update_fn(net, muzero_optimizer(),
                                      _config(**train))
    return mu.fused_group_status(ts, rs)

  assert status()[0] == "raw"
  assert status(fused_sampler=False)[2] == "disabled by config (fused_sampler)"
  assert status(fused_learner=False) == ("hybrid", None, "active (hybrid)")
  assert "observation_transform" in status(
      observation_transform=lambda g, o: o)[2]
  assert "exceeds" in status(unroll_steps=L + 1)[2]


def test_generic_and_hybrid_paths_train():
  """The generic group path with the fused learner in batch mode; the
  hybrid path (fused_learner off: the fused sampler's per-step rows feed
  autograd over muzero_loss); and make_update_fn."""
  for train, mode in ((dict(fused_sampler=False), None),
                      (dict(fused_learner=False), "hybrid")):
    *_, ts, rs, mu = _setup(**train)
    assert mu.fused_group_status(ts, rs)[0] == mode
    ts, rs, metrics = mu(ts, rs, torch.Generator().manual_seed(1))
    assert ts.step == 2 and metrics["updates_done"] == 2
    assert all(bool(torch.isfinite(v)) for k, v in metrics.items()
               if k != "updates_done")
  *_, net, params, ts, rs, _ = _setup()
  update = learner.make_update_fn(net, muzero_optimizer(),
                                  dataclasses.replace(_config()))
  ts, rs, metrics = update(ts, rs, torch.Generator().manual_seed(2))
  assert ts.step == 1 and float(metrics["target_staleness"]) == 0.0
