"""The k-step unrolled MuZero loss (``muax_tpu/models/losses.py``).

Value and reward targets are cross-entropies against two-hot supports of
h-transformed scalars (the MLP family) or linear two-hots over [vmin, vmax]
(the acme families, which carry ``num_bins``; ``_target_codec``), the policy target is the search's visit distribution,
the hidden state's gradient is scaled by ``gradient_scale`` where it enters
the dynamics, every target is detached, each window's loss is divided by its
count of valid steps, the batch mean is weighted by the PER weights, and the
L2 term is ``l2_coef * 0.5 * sum(p^2)`` over every tower parameter. Fresh
priorities ``|v0 - rn0|^alpha`` come back beside the loss.

Autograd over this function is the port's generic gradient path, and the
plain version that the fused learner kernel is held against.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from muax_tpu_torch.models.networks import MZNetworks, MZParams
from muax_tpu_torch.ops import (scalar_to_support, scalar_to_two_hot,
                                scale_gradient, support_to_scalar,
                                two_hot_to_scalar)
from muax_tpu_torch.types import Transition


def _target_codec(networks):
  """(scalar -> probs, probs -> scalar) for either value-head convention."""
  if hasattr(networks, "num_bins"):
    return (lambda x: scalar_to_two_hot(x, networks.num_bins, networks.vmin,
                                        networks.vmax),
            lambda p: two_hot_to_scalar(p, networks.vmin, networks.vmax))
  return (lambda x: scalar_to_support(x, networks.support_size),
          lambda p: support_to_scalar(p, networks.support_size))


class LossMetrics(NamedTuple):
  total: torch.Tensor
  reward_loss: torch.Tensor
  value_loss: torch.Tensor
  policy_loss: torch.Tensor
  l2_loss: torch.Tensor
  priorities: torch.Tensor  # [B] fresh PER priorities (detached)


def _ce(logits: torch.Tensor, target_probs: torch.Tensor) -> torch.Tensor:
  """Per-example softmax cross-entropy against detached targets."""
  return -torch.sum(target_probs.detach() * torch.log_softmax(logits, -1), -1)


def l2_sum(params: MZParams) -> torch.Tensor:
  """sum(p^2) over the three towers' parameters (not the temperature)."""
  return sum(torch.sum(torch.square(p)) for p in params.parameters())


def _tower(module: torch.nn.Module, compute_dtype, remat: bool):
  """``module``'s forward, on parameters cast to ``compute_dtype`` (cast
  once per loss call), and checkpointed under ``remat``."""
  fn = module
  if compute_dtype is not None:
    cast = {name: p.to(compute_dtype) if p.is_floating_point() else p
            for name, p in module.named_parameters()}
    fn = lambda *args: torch.func.functional_call(module, cast, args)
  if remat:
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)
  return fn


def muzero_loss(
    params: MZParams,
    batch: Transition,
    networks: MZNetworks,
    *,
    num_unroll_steps: Optional[int] = None,
    l2_coef: float = 1e-4,
    gradient_scale: float = 0.5,
    priority_alpha: float = 0.5,
    compute_dtype: Optional[torch.dtype] = None,
    remat: bool = False,
):
  """The unrolled loss on a [B, L, ...] batch; returns (total, LossMetrics).

  The dynamics chain runs first and prediction runs once on the K stacked
  latents, as the JAX package's default ``batched_prediction`` does.

  ``compute_dtype=torch.bfloat16`` runs the towers on bf16 casts of the
  parameters (autograd carries the gradients back through the casts, so
  they stay f32 master gradients) and on a bf16 cast of a floating
  observation; the cross-entropies, the target encodes and L2 stay f32.
  ``remat=True`` recomputes the representation's and each dynamics step's
  activations in the backward pass instead of keeping them
  (``torch.utils.checkpoint``). Both are the conv families' memory levers.
  """
  encode, decode = _target_codec(networks)
  num_steps = num_unroll_steps or batch.action.shape[1]
  batch_size = batch.action.shape[0]
  representation = _tower(params.representation, compute_dtype, remat)
  prediction = _tower(params.prediction, compute_dtype, False)
  dynamic = _tower(params.dynamic, compute_dtype, remat)

  obs0 = batch.obs[:, 0]
  if compute_dtype is not None and obs0.is_floating_point():
    obs0 = obs0.to(compute_dtype)
  s = representation(obs0)
  value_targets = encode(batch.rn[:, :num_steps])
  reward_targets = encode(batch.reward[:, :num_steps])
  mask = batch.mask.to(torch.float32)

  reward_loss = torch.zeros(batch_size, device=s.device)
  step_states = [s]
  for i in range(num_steps):
    s = scale_gradient(s, gradient_scale)
    reward_logits, s = dynamic(s, batch.action[:, i])
    reward_loss = reward_loss + mask[:, i] * _ce(reward_logits.float(),
                                                 reward_targets[:, i])
    if i < num_steps - 1:
      step_states.append(s)
  policy_logits, value_logits = prediction(torch.cat(step_states, 0))
  policy_logits = policy_logits.float().reshape(num_steps, batch_size, -1)
  value_logits = value_logits.float().reshape(num_steps, batch_size, -1)
  value_loss = torch.zeros_like(reward_loss)
  policy_loss = torch.zeros_like(reward_loss)
  for i in range(num_steps):
    value_loss = value_loss + mask[:, i] * _ce(value_logits[i],
                                               value_targets[:, i])
    policy_loss = policy_loss + mask[:, i] * _ce(policy_logits[i],
                                                 batch.pi[:, i])
  first_value = decode(torch.softmax(value_logits[0], -1))

  denom = torch.clamp(torch.sum(mask, 1), min=1.0)
  reward_loss = reward_loss / denom
  value_loss = value_loss / denom
  policy_loss = policy_loss / denom
  weighted = torch.mean(batch.weight * (reward_loss + value_loss
                                        + policy_loss))
  l2 = l2_coef * 0.5 * l2_sum(params)
  total = weighted + l2

  priorities = torch.abs(first_value - batch.rn[:, 0]) ** priority_alpha
  return total, LossMetrics(
      total=total,
      reward_loss=torch.mean(reward_loss),
      value_loss=torch.mean(value_loss),
      policy_loss=torch.mean(policy_loss),
      l2_loss=l2,
      priorities=priorities.detach(),
  )


def muzero_grad(params: MZParams, batch: Transition, networks: MZNetworks,
                **kwargs):
  """Autograd over ``muzero_loss``: (flat gradient in the order of
  ``params.parameters()``, detached LossMetrics). ``kwargs`` go to
  ``muzero_loss``."""
  with torch.enable_grad():
    total, metrics = muzero_loss(params, batch, networks, **kwargs)
    grads = torch.autograd.grad(total, list(params.parameters()))
  return (torch.cat([g.reshape(-1) for g in grads]),
          LossMetrics(*(m.detach() for m in metrics)))
