"""Stochastic MuZero's training path in the port against the JAX package's,
on the CPU.

* ``stochastic_muzero_loss`` and its autograd gradient against
  ``jax.grad`` on one seeded batch (gradients rtol 2e-4 / atol 1e-6, loss
  metrics rtol 1e-5, priorities rtol 1e-4: ``tests/test_fused_learner.py``'s
  tolerances);
* the sampler's ``per_step_obs`` rows (its plain version) against the JAX
  Pallas sampler in interpret mode: exactly equal
  (``tests/test_fused_sampler.py:242-258``);
* one hybrid group of the grouped learner against the JAX package's
  ``_fused_multi_update`` in hybrid mode, through its CPU test seam
  ``_ALLOW_FUSED_SAMPLER_ON_CPU`` with the JAX draws injected: parameters
  atol = rtol = 3e-5 after two Adam steps, loss rtol 1e-4
  (``tests/test_fused_sampler.py:310-334``);
* ``fit`` with the five nets on the CPU for 3 iterations, and a resume
  that reproduces the uninterrupted run bit for bit.
"""
import os

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
from muax_tpu.models.stochastic_losses import \
    stochastic_muzero_loss as j_loss
from muax_tpu.replay.fused_sampler import fused_sample_group as j_sample
from muax_tpu.replay.fused_sampler import transpose_ring
from muax_tpu_torch.config import (MuZeroConfig, ReplayConfig, SearchConfig,
                                   TrainConfig)
from muax_tpu_torch.envs import CartPole
from muax_tpu_torch.models import (make_stochastic_mlp_networks,
                                   smz_params_from_numpy)
from muax_tpu_torch.models.convert import smz_grads_to_numpy
from muax_tpu_torch.models.optimizers import muzero_optimizer
from muax_tpu_torch.models.stochastic_losses import stochastic_muzero_grad
from muax_tpu_torch.replay.fused_sampler import (fused_sample_group,
                                                 make_raw_layout)
from muax_tpu_torch.train import learner
from muax_tpu_torch.train.checkpoint import load_checkpoint
from muax_tpu_torch.train.fit import fit
from tests.test_torch_parity import (batch_numpy, jax_batch, jax_ring,
                                     ring_numpy, torch_batch, torch_ring)
from tests.test_torch_smz_networks import CONFIGS, TOWERS, smz_nets

KW = dict(l2_coef=1e-4, gradient_scale=0.5, priority_alpha=0.5)
METRICS = ("total", "reward_loss", "value_loss", "policy_loss", "chance_loss",
           "afterstate_value_loss", "commitment_loss", "l2_loss")


@pytest.mark.parametrize("cfg", CONFIGS[:2])
def test_loss_and_grads_match_jax_grad(cfg):
  j_net, j_params, _, net, params = smz_nets(cfg)
  arrays = batch_numpy(4, B=32, L=5, obs_dim=5,
                       num_actions=cfg["num_actions"])
  ref_grads, ref = jax.jit(jax.grad(
      lambda p, b: j_loss(p, b, j_net, **KW), has_aux=True))(
          j_params, jax_batch(arrays))
  grads, metrics = stochastic_muzero_grad(params, torch_batch(arrays), net,
                                          **KW)

  port = smz_grads_to_numpy(params, grads)
  for name in TOWERS:
    ref_tree = jax.tree.map(np.asarray, getattr(ref_grads, name))
    for module, leaves in ref_tree.items():
      for key, value in leaves.items():
        np.testing.assert_allclose(port[name][module][key], value,
                                   rtol=2e-4, atol=1e-6,
                                   err_msg=f"{name}/{module}/{key}")
  for name in METRICS:
    np.testing.assert_allclose(float(getattr(metrics, name)),
                               float(getattr(ref, name)), rtol=1e-5,
                               err_msg=name)
  np.testing.assert_allclose(metrics.priorities.numpy(),
                             np.asarray(ref.priorities), rtol=1e-4,
                             atol=1e-6)


@pytest.mark.parametrize("C,L,K,W,filled,done_rate", [
    (16, 8, 3, 128, 12, 0.15),
    (32, 20, 5, 256, 24, 0.3),   # smz_training's L and K
])
def test_per_step_obs_rows_equal_jax_kernel(C, L, K, W, filled, done_rate):
  segs, prios = ring_numpy(C + K, C, L, filled=filled, done_rate=done_rate)
  ref_state = jax_ring(segs, prios, C, L, 4, 2)
  seg_idx = np.random.default_rng(K).integers(0, filled, W)
  gum_rng = jax.random.PRNGKey(K)
  ref, ref_lay = j_sample(transpose_ring(ref_state),
                          ref_state.step_priorities, ref_state.target_step,
                          jnp.asarray(seg_idx, jnp.int32), gum_rng, K,
                          interpret=True, per_step_obs=True)
  gumbel = np.array(jax.random.gumbel(gum_rng, (L, W), jnp.float32))
  raw, lay = fused_sample_group(torch_ring(ref_state),
                                torch.from_numpy(seg_idx),
                                torch.from_numpy(gumbel), K,
                                per_step_obs=True)
  assert lay == make_raw_layout(4, K, 2, per_step_obs=True) == ref_lay
  np.testing.assert_array_equal(raw.numpy(), np.asarray(ref))


SMZ = dict(num_actions=2, num_chance_outcomes=4, embedding_dim=8,
           support_size=10, hidden=(16,))
C, L, B, K = 32, 8, 64, 3


def _config(cls_m=MuZeroConfig, cls_s=SearchConfig, cls_r=ReplayConfig,
            cls_t=TrainConfig):
  return cls_m(search=cls_s(policy="stochastic", num_simulations=2),
               replay=cls_r(capacity=C, min_fill=4, offline_fraction=0.5,
                            online_queue_size=8),
               train=cls_t(num_envs=4, collect_steps=L, batch_size=B,
                           unroll_steps=K, updates_per_iteration=2,
                           presample_updates=2))


def test_hybrid_group_matches_jax(monkeypatch):
  monkeypatch.setattr(j_learner, "_ALLOW_FUSED_SAMPLER_ON_CPU", True)
  j_net, j_params, _, net, params = smz_nets(SMZ, obs_dim=4)
  segs, prios = ring_numpy(1, C, L, filled=24)
  j_rs = jax_ring(segs, prios, C, L, 4, 2)
  rs = torch_ring(j_rs)
  j_opt = j_optimizer(warmup_steps=2)
  j_ts = j_learner.TrainState(params=j_params, opt_state=j_opt.init(j_params),
                              step=jnp.asarray(0, jnp.int32))
  j_mu = j_learner.make_multi_update_fn(
      j_net, j_opt, _config(JConfig, JSearch, JReplay, JTrain))
  assert j_mu.fused_group_status(j_ts, j_rs)[0] == "hybrid"
  key = jax.random.PRNGKey(2)
  j_ts2, j_rs2, j_metrics = j_mu(j_ts, j_rs, key)

  # The draws of the JAX group: split(key, 1) -> (segments, Gumbel); the
  # segment key splits again into the uniforms and the online offsets.
  W = 2 * B
  seg_rng, gum_rng = jax.random.split(jax.random.split(key, 1)[0])
  u_rng, online_rng = jax.random.split(seg_rng)
  uniforms = np.array(jax.random.uniform(u_rng, (W,)))
  offsets = np.array(jax.random.randint(online_rng, (W // 2,), 1, 9))
  gumbel = np.array(jax.random.gumbel(gum_rng, (L, W), jnp.float32))

  opt = muzero_optimizer(warmup_steps=2)
  ts = learner.TrainState(params=params, opt_state=opt.init(params), step=0)
  mu = learner.make_multi_update_fn(net, opt, _config())
  assert mu.fused_group_status(ts, rs)[:2] == ("hybrid", None)
  prios_before = rs.step_priorities.clone()
  ts2, sums, done = mu.run_fused_group(
      ts, rs, 0, torch.from_numpy(uniforms), torch.from_numpy(offsets),
      torch.from_numpy(gumbel), mode="hybrid")
  assert done == 2 and ts2.step == 2 == int(j_ts2.step)
  np.testing.assert_allclose(float(sums[0]) / 2, float(j_metrics["loss"]),
                             rtol=1e-4)
  ref = smz_params_from_numpy(
      {name: jax.tree.map(np.asarray, getattr(j_ts2.params, name))
       for name in TOWERS}, net)
  ref_named = dict(ref.named_parameters())
  for name, p in ts2.params.named_parameters():
    np.testing.assert_allclose(p.detach().numpy(),
                               ref_named[name].detach().numpy(), rtol=3e-5,
                               atol=3e-5, err_msg=name)
  # The same windows' priorities were refreshed.
  changed = np.asarray(j_rs2.step_priorities) != prios_before.numpy()
  assert changed.sum() > 20
  np.testing.assert_array_equal(
      rs.step_priorities.numpy() != prios_before.numpy(), changed)
  np.testing.assert_allclose(rs.step_priorities.numpy(),
                             np.asarray(j_rs2.step_priorities), rtol=1e-4,
                             atol=1e-3)


def _fit(tmp, fused=True, **kwargs):
  """tests/test_e2e.py's Stochastic MuZero smoke config, with
  muzero_optimizer."""
  config = MuZeroConfig(
      search=SearchConfig(policy="stochastic", num_simulations=6,
                          num_chance_outcomes=4, fused=fused),
      replay=ReplayConfig(capacity=64, min_fill=8),
      train=TrainConfig(num_envs=8, collect_steps=8, batch_size=8,
                        updates_per_iteration=2, unroll_steps=3,
                        n_bootstrap=5))
  net = make_stochastic_mlp_networks(2, num_chance_outcomes=4,
                                     embedding_dim=16, support_size=10,
                                     hidden=(32,), device="cpu")
  lines = []
  state, results = fit(CartPole(), net, config,
                       muzero_optimizer(warmup_steps=2), eval_every=2,
                       log_every=1, seed=3, model_dir=str(tmp),
                       log_fn=lines.append, **kwargs)
  return state, results, lines


@pytest.mark.parametrize("fused", [True, False])
def test_fit_smoke(tmp_path, fused):
  state, results, lines = _fit(tmp_path, fused, num_iterations=3)
  assert state.step == 6 and len(results["history"]) == 3
  assert results["model_path"] is not None
  assert os.path.exists(results["model_path"])
  for row in results["history"]:
    for k, v in row.items():
      assert np.isfinite(v), (k, v)
  search = "search=on" if fused else "search=OFF"
  assert search in lines[0] and "sampler=on" in lines[0]


def test_fit_resume_is_bit_exact(tmp_path):
  state_a, results_a, _ = _fit(tmp_path, num_iterations=3,
                               checkpoint_every=2, save_best=False)
  mid = os.path.join(str(tmp_path), "ckpt_it000002.pkl")
  assert load_checkpoint(mid)["iteration"] == 2
  state_b, results_b, _ = _fit(tmp_path / "resumed", num_iterations=3,
                               resume_from=mid, save_best=False)
  for (name, a), b in zip(state_a.params.state_dict().items(),
                          state_b.params.state_dict().values()):
    assert torch.equal(a, b), name
  assert torch.equal(state_a.opt_state.mu, state_b.opt_state.mu)
  drop = ("env_steps_per_s",)
  assert [{k: v for k, v in row.items() if k not in drop}
          for row in results_a["history"]] == [
              {k: v for k, v in row.items() if k not in drop}
              for row in results_b["history"]]
