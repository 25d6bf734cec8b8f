"""The port's ``muzero_loss`` and its autograd gradient against the JAX
package's ``muzero_loss`` and ``jax.grad`` on the same seeded batch and
weights.

Tolerances are those of ``tests/test_fused_learner.py:67-79``: gradients
rtol 2e-4 / atol 1e-6, loss metrics rtol 1e-5, priorities rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muax_tpu.models.losses import muzero_loss as j_loss
from muax_tpu.ops.normalize import min_max_normalize as j_minmax
from muax_tpu_torch.models.convert import mlp_grads_to_numpy
from muax_tpu_torch.models.losses import muzero_grad, muzero_loss
from muax_tpu_torch.ops import min_max_normalize, scale_gradient
from tests.test_torch_parity import (NET_CONFIGS, assert_trees_close,
                                     batch_numpy, jax_batch, nets,
                                     torch_batch)

KW = dict(l2_coef=1e-4, gradient_scale=0.5, priority_alpha=0.5)


@pytest.mark.parametrize("cfg", NET_CONFIGS)
def test_grads_match_jax_grad(cfg):
  j_net, j_params, net, params = nets(cfg)
  arrays = batch_numpy(1, B=32, L=5, num_actions=cfg["num_actions"])
  ref_grads, ref = jax.jit(jax.grad(
      lambda p, b: j_loss(p, b, j_net, **KW), has_aux=True))(
          j_params, jax_batch(arrays))
  grads, metrics = muzero_grad(params, torch_batch(arrays), net, **KW)

  assert_trees_close(mlp_grads_to_numpy(params, grads), ref_grads._asdict(),
                     rtol=2e-4, atol=1e-6)
  for name in ("total", "reward_loss", "value_loss", "policy_loss",
               "l2_loss"):
    np.testing.assert_allclose(float(getattr(metrics, name)),
                               float(getattr(ref, name)), rtol=1e-5,
                               err_msg=name)
  np.testing.assert_allclose(metrics.priorities.numpy(),
                             np.asarray(ref.priorities), rtol=1e-4,
                             atol=1e-6)


def test_masked_steps_do_not_count():
  _, _, net, params = nets(NET_CONFIGS[0])
  arrays = batch_numpy(2, B=16, L=5, with_masks=False)
  arrays["mask"][:, 2:] = 0.0
  clean, _ = muzero_loss(params, torch_batch(arrays), net)
  arrays["rn"][:, 2:] = 1e6
  poisoned, _ = muzero_loss(params, torch_batch(arrays), net)
  np.testing.assert_allclose(clean.item(), poisoned.item(), rtol=1e-6)


def test_min_max_ties_split_the_gradient():
  """Tied minima and maxima share their gradient as jnp.min/jnp.max do
  (torch.max(dim) would send it all to one index)."""
  x = np.array([[0.5, -1.0, 2.0, -1.0, 2.0, 0.0],
                [1.0, 1.0, 1.0, 1.0, 1.0, 1.0]], np.float32)
  dy = np.random.default_rng(0).standard_normal(x.shape).astype(np.float32)
  ref = jax.grad(lambda v: jnp.sum(j_minmax(v) * dy))(jnp.asarray(x))
  t = torch.from_numpy(x).requires_grad_()
  (min_max_normalize(t) * torch.from_numpy(dy)).sum().backward()
  np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), rtol=1e-5,
                             atol=1e-6)


def test_scale_gradient_is_identity_forward_and_scales_backward():
  t = torch.tensor([1.5, -2.0], requires_grad=True)
  y = scale_gradient(t, 0.25)
  torch.testing.assert_close(y, t.detach())
  y.sum().backward()
  torch.testing.assert_close(t.grad, torch.full((2,), 0.25))
