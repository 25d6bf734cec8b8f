"""The port's fused learner (its plain version, autograd over the port's
``muzero_loss``, on the CPU) against the JAX package's Pallas learner in
interpret mode, in raw mode and in batch mode.

Tolerances as ``tests/test_fused_learner.py:67-79``: gradients rtol 2e-4 /
atol 1e-6, loss metrics rtol 1e-5, priorities rtol 1e-4. The CUDA kernel is
held against the plain version on the card in
``tests/test_torch_fused_learner_kernel.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muax_tpu.models import fused_learner as jfl
from muax_tpu.replay.fused_sampler import fused_sample_group as j_sample_group
from muax_tpu.replay.fused_sampler import transpose_ring
from muax_tpu_torch.models import fused_learner
from muax_tpu_torch.models.convert import mlp_grads_to_numpy
from tests.test_torch_parity import (NET_CONFIGS, assert_trees_close,
                                     batch_numpy, jax_batch, jax_ring, nets,
                                     ring_numpy, torch_batch)

KW = dict(l2_coef=1e-4, gradient_scale=0.5, priority_alpha=0.5)


def _assert_metrics_close(metrics, ref):
  for name in ("total", "reward_loss", "value_loss", "policy_loss",
               "l2_loss"):
    np.testing.assert_allclose(float(getattr(metrics, name)),
                               float(getattr(ref, name)), rtol=1e-5,
                               err_msg=name)
  np.testing.assert_allclose(metrics.priorities.numpy(),
                             np.asarray(ref.priorities), rtol=1e-4,
                             atol=1e-6)


@pytest.mark.parametrize("cfg,B", [(NET_CONFIGS[0], 32), (NET_CONFIGS[1], 32),
                                   (NET_CONFIGS[2], 32),
                                   (NET_CONFIGS[0], 20)])  # padded lanes
def test_batch_mode_matches_jax_kernel(cfg, B):
  j_net, j_params, net, params = nets(cfg)
  arrays = batch_numpy(1, B=B, L=5, num_actions=cfg["num_actions"])
  ref_grads, ref = jfl.fused_muzero_grad(
      j_params, jax_batch(arrays), j_net,
      jfl.extract_learner_weights(j_net, j_params), interpret=True, **KW)
  lw = fused_learner.extract_learner_weights(net, params)
  before = fused_learner.launches
  grads, metrics = fused_learner.fused_muzero_grad(
      params, torch_batch(arrays), net, lw, **KW)
  assert fused_learner.launches == before
  assert_trees_close(mlp_grads_to_numpy(params, grads), ref_grads._asdict(),
                     rtol=2e-4, atol=1e-6)
  _assert_metrics_close(metrics, ref)


def test_raw_mode_matches_jax_kernel():
  """On the JAX sampler's raw rows (the training regime's K = 5 and L = 20,
  flagship widths)."""
  cfg = dict(num_actions=2, embedding_dim=8, support_size=20)
  j_net, j_params, net, params = nets(cfg)
  C, L, K, W = 32, 20, 5, 256
  segs, prios = ring_numpy(1, C, L, filled=24, done_rate=0.1)
  rs = jax_ring(segs, prios, C, L, 4, 2)
  seg_idx = jax.random.randint(jax.random.PRNGKey(2), (W,), 0, 24)
  raw, lay = j_sample_group(transpose_ring(rs), rs.step_priorities,
                            rs.target_step, seg_idx, jax.random.PRNGKey(3), K,
                            interpret=True)
  w_raw = raw[lay.weight]
  coef = w_raw / jnp.maximum(jnp.mean(w_raw), 1e-9) / raw[lay.denom] / W
  ref_grads, ref = jfl.fused_muzero_grad_raw(
      j_params, raw, coef, lay, j_net,
      jfl.extract_learner_weights(j_net, j_params), interpret=True, **KW)

  port_lay = fused_learner.make_raw_layout(4, K, 2)
  assert port_lay == lay
  grads, metrics = fused_learner.fused_muzero_grad_raw(
      params, torch.from_numpy(np.array(raw)),
      torch.from_numpy(np.array(coef)), port_lay, net,
      fused_learner.extract_learner_weights(net, params), **KW)
  assert_trees_close(mlp_grads_to_numpy(params, grads), ref_grads._asdict(),
                     rtol=2e-4, atol=1e-6)
  _assert_metrics_close(metrics, ref)


def test_batch_packs_into_raw_rows():
  """``raw_from_batch`` (how batch mode feeds the kernel on the card) and
  ``batch_from_raw`` stand for the same loss as the batch itself."""
  _, _, net, params = nets(NET_CONFIGS[1])
  batch = torch_batch(batch_numpy(4, B=24, L=5, num_actions=4))
  raw, coef, lay = fused_learner.raw_from_batch(batch, 5)
  g_raw, m_raw = fused_learner.fused_muzero_grad_raw_reference(
      params, raw, coef, lay, net, **KW)
  g_batch, m_batch = fused_learner.fused_muzero_grad_reference(
      params, batch, net, **KW)
  torch.testing.assert_close(g_raw, g_batch, rtol=1e-5, atol=1e-7)
  torch.testing.assert_close(m_raw.total, m_batch.total, rtol=1e-6, atol=0)
  torch.testing.assert_close(m_raw.priorities, m_batch.priorities)


def test_other_families_have_no_kernel():
  _, _, net, params = nets(NET_CONFIGS[0])
  assert fused_learner.extract_learner_weights(object(), params) is None
  batch = torch_batch(batch_numpy(0, B=4))
  with pytest.raises(NotImplementedError, match="hybrid"):
    fused_learner.fused_muzero_grad(params, batch, net, None)
