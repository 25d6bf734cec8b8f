"""The port's learner on the acme categorical family, on the CPU: the fused
learner's plain version (autograd over the categorical ``muzero_loss``)
against the JAX package's Pallas learner on the categorical ``LearnerSpec``
in interpret mode, in batch mode and on the JAX sampler's raw rows; the
learner's dispatch; and ``fit`` end to end with a bit-exact resume.

Tolerances as ``tests/test_fused_learner.py:156-162`` and ``:199-205``:
gradients rtol 5e-4 / atol 1e-6, total rtol 1e-5, priorities rtol 1e-4.
The CUDA kernel is held against the plain version on the card in
``tests/test_torch_categorical_kernels.py``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muax_tpu.models import fused_learner as jfl
from muax_tpu.replay.fused_sampler import fused_sample_group as j_sample_group
from muax_tpu.replay.fused_sampler import transpose_ring
from muax_tpu_torch.config import (MuZeroConfig, ReplayConfig, SearchConfig,
                                   TrainConfig)
from muax_tpu_torch.envs import CartPole
from muax_tpu_torch.fused_status import format_fused_status, fused_status
from muax_tpu_torch.models import (fused_learner, make_categorical_mlp_networks,
                                   make_fc_resnet_networks)
from muax_tpu_torch.models.convert import mlp_grads_to_numpy
from muax_tpu_torch.models.optimizers import muzero_optimizer
from muax_tpu_torch.replay import replay_init
from muax_tpu_torch.train import learner
from muax_tpu_torch.train.fit import fit
from tests.test_torch_acme_networks import acme_nets
from tests.test_torch_parity import (assert_trees_close, batch_numpy,
                                     jax_batch, jax_ring, ring_numpy,
                                     torch_batch)

KW = dict(l2_coef=1e-4, gradient_scale=0.5, priority_alpha=0.5)
# tests/test_fused_learner.py:113-115's widths.
NET = dict(embedding_dim=16, num_bins=21, vmin=-15.0, vmax=15.0,
           layer_sizes=(24, 24))


def _assert_close(grads, metrics, params, ref_grads, ref, rtol=5e-4,
                  atol=1e-6):
  assert_trees_close(mlp_grads_to_numpy(params, grads), ref_grads._asdict(),
                     rtol=rtol, atol=atol)
  np.testing.assert_allclose(float(metrics.total), float(ref.total),
                             rtol=1e-5)
  np.testing.assert_allclose(metrics.priorities.numpy(),
                             np.asarray(ref.priorities), rtol=1e-4,
                             atol=1e-6)


def test_spec_follows_the_parameter_order():
  j_net, j_params, net, params = acme_nets(**NET)
  spec = fused_learner.extract_categorical_learner_spec(net, params)
  ref = jfl.extract_categorical_learner_spec(j_net, j_params)
  assert spec.repr_kinds == tuple(k for k, _ in ref.repr_layers)
  assert spec.pred_kinds == ("ln_tanh", "elu")
  assert (spec.num_bins, spec.vmin, spec.vmax) == (21, -15.0, 15.0)
  assert spec.flat.numel() == sum(p.numel() for p in params.parameters())
  assert fused_learner.extract_learner(net, params).flat is spec.flat
  fc = acme_nets("fc_resnet")
  assert fused_learner.extract_learner(fc[2], fc[3]) is None


def test_batch_mode_matches_jax_kernel():
  j_net, j_params, net, params = acme_nets(**NET)
  arrays = batch_numpy(1, B=32, L=5, num_actions=3)
  arrays["rn"] = arrays["rn"] * 3
  ref_grads, ref = jfl.fused_muzero_grad(
      j_params, jax_batch(arrays), j_net,
      jfl.extract_categorical_learner_spec(j_net, j_params), interpret=True,
      **KW)
  spec = fused_learner.extract_categorical_learner_spec(net, params)
  before = fused_learner.categorical_launches
  grads, metrics = fused_learner.fused_muzero_grad(
      params, torch_batch(arrays), net, spec, **KW)
  assert fused_learner.categorical_launches == before  # the plain version
  _assert_close(grads, metrics, params, ref_grads, ref)


def test_raw_mode_matches_jax_kernel_and_batch_mode():
  """On the JAX sampler's raw rows: the JAX raw kernel, and the port's raw
  path against its own batch path on the same windows."""
  j_net, j_params, net, params = acme_nets(**NET)
  C, L, K, W = 32, 8, 5, 128
  segs, prios = ring_numpy(1, C, L, A=3, filled=24)
  segs["rn"] = segs["rn"] * 8
  rs = jax_ring(segs, prios, C, L, 4, 3)
  seg_idx = jax.random.randint(jax.random.PRNGKey(2), (W,), 0, 24)
  raw, lay = j_sample_group(transpose_ring(rs), rs.step_priorities,
                            rs.target_step, seg_idx, jax.random.PRNGKey(3), K,
                            interpret=True)
  w_raw = raw[lay.weight]
  coef = w_raw / jnp.maximum(jnp.mean(w_raw), 1e-9) / raw[lay.denom] / W
  ref_grads, ref = jfl.fused_muzero_grad_raw(
      j_params, raw, coef, lay, j_net,
      jfl.extract_categorical_learner_spec(j_net, j_params), interpret=True,
      **KW)
  spec = fused_learner.extract_categorical_learner_spec(net, params)
  raw_t = torch.from_numpy(np.array(raw))
  coef_t = torch.from_numpy(np.array(coef))
  grads, metrics = fused_learner.fused_muzero_grad_raw(
      params, raw_t, coef_t, lay, net, spec, **KW)
  _assert_close(grads, metrics, params, ref_grads, ref)

  batch = fused_learner.batch_from_raw(raw_t, coef_t, lay)
  g_batch, m_batch = fused_learner.fused_muzero_grad(params, batch, net,
                                                     spec, **KW)
  torch.testing.assert_close(grads, g_batch, rtol=1e-5, atol=1e-7)
  torch.testing.assert_close(metrics.total, m_batch.total, rtol=1e-6, atol=0)


def _config(**train):
  kwargs = dict(num_envs=8, collect_steps=6, batch_size=8,
                updates_per_iteration=2, unroll_steps=2, n_bootstrap=3)
  kwargs.update(train)
  return MuZeroConfig(search=SearchConfig(num_simulations=4),
                      replay=ReplayConfig(capacity=64, min_fill=8),
                      train=TrainConfig(**kwargs))


def _networks(family="categorical"):
  if family == "fc_resnet":
    return make_fc_resnet_networks(2, embedding_dim=8, num_bins=11,
                                   vmin=0.0, vmax=10.0, num_blocks=1,
                                   device="cpu")
  return make_categorical_mlp_networks(2, embedding_dim=8, num_bins=11,
                                       vmin=-10.0, vmax=10.0,
                                       layer_sizes=(16, 16), device="cpu")


def test_dispatch_and_status():
  rs = replay_init(16, 6, (4,), 2, device="cpu")
  for family, line in (
      ("categorical", "fused: search=on learner=on sampler=on"),
      ("fc_resnet", None)):
    net = _networks(family)
    params = net.init_params((4,), torch.Generator().manual_seed(0))
    report = fused_status(net, _config(), params, rs)
    mu = learner.make_multi_update_fn(net, muzero_optimizer(), _config())
    ts = learner.TrainState(params, None, 0)
    mode, lw, reason = mu.fused_group_status(ts, rs)
    if line is not None:
      assert format_fused_status(report) == line
      assert mode == "raw" and isinstance(lw, fused_learner.LearnerSpec)
      assert "categorical" in report["fused_learner"]["reason"]
    else:
      assert mode is None and "A.4" in reason
      assert not report["fused_search"]["active"]
      assert not report["fused_learner"]["active"]


def _fit(tmp, family="categorical", **kwargs):
  args = dict(eval_every=2, log_every=1, log_fn=lambda s: None, seed=5,
              model_dir=str(tmp), save_best=False)
  args.update(kwargs)
  return fit(CartPole(), _networks(family), _config(),
             muzero_optimizer(warmup_steps=2), **args)


def test_fit_three_iterations_and_bit_exact_resume(tmp_path):
  state_a, results_a = _fit(tmp_path, num_iterations=3, checkpoint_every=1)
  assert state_a.step == 6 and len(results_a["history"]) == 3
  for row in results_a["history"]:
    for k, v in row.items():
      assert np.isfinite(v), (k, v)
  mid = os.path.join(str(tmp_path), "ckpt_it000001.pkl")
  state_b, results_b = _fit(tmp_path / "resumed", num_iterations=3,
                            resume_from=mid)
  for (name, a), b in zip(state_a.params.state_dict().items(),
                          state_b.params.state_dict().values()):
    assert torch.equal(a, b), name
  assert torch.equal(state_a.opt_state.nu, state_b.opt_state.nu)
  drop = ("env_steps_per_s",)
  assert [{k: v for k, v in row.items() if k not in drop}
          for row in results_a["history"]] == [
              {k: v for k, v in row.items() if k not in drop}
              for row in results_b["history"]]


def test_fit_fc_resnet_takes_the_generic_paths(tmp_path):
  state, results = _fit(tmp_path, family="fc_resnet", num_iterations=1)
  assert state.step == 2
  assert all(np.isfinite(v) for v in results["history"][0].values())
