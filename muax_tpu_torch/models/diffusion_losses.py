"""The Diffusion MuZero k-step unrolled loss, with flow matching as the
chance model (``muax_tpu/models/diffusion_losses.py``).

Per step i of an L window (L - 1 chance transitions):
  * policy and value cross-entropies at s_i (prediction net);
  * decision(s_i, a_i) -> (afterstate, av_logits); the afterstate value's
    cross-entropy against the same step's return target;
  * flow matching: v(x_t, t | afterstate) regressed onto the straight-path
    velocity toward x0 = sg(repr(obs_{i+1})), the true next latent;
  * the reward cross-entropy on the readout of the true next latent;
  * the unroll continues through the flow's conditional-mean readout
    v(0, 0 | afterstate) (``DMZNetworks.mean_next_state``), with the
    gradient scaled by 0.5 where the state enters and leaves the dynamics.

Each window's loss is divided by its count of valid steps, the batch mean
is weighted by the PER weights, L2 covers the five towers, and the
priorities are |v - Rn|^alpha at the root step, as in ``losses.muzero_loss``.
Each step's flow-matching pair (t, eps) is drawn from the generator, or
injected through ``draws``. Autograd over this function is the family's
gradient: the JAX package has no learner kernel for it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from muax_tpu_torch.models.diffusion import batch_mul, flow_matching_draws
from muax_tpu_torch.models.diffusion_networks import DMZNetworks, DMZParams
from muax_tpu_torch.models.losses import _ce, l2_sum
from muax_tpu_torch.ops import (scalar_to_support, scale_gradient,
                                support_to_scalar)
from muax_tpu_torch.types import Transition


class DMZLossMetrics(NamedTuple):
  total: torch.Tensor
  reward_loss: torch.Tensor
  value_loss: torch.Tensor
  policy_loss: torch.Tensor
  afterstate_value_loss: torch.Tensor
  flow_loss: torch.Tensor
  l2_loss: torch.Tensor
  priorities: torch.Tensor  # [B] fresh PER priorities (detached)


def diffusion_muzero_loss(
    params: DMZParams,
    batch: Transition,
    networks: DMZNetworks,
    generator: Optional[torch.Generator],
    *,
    num_unroll_steps: Optional[int] = None,
    l2_coef: float = 1e-4,
    gradient_scale: float = 0.5,
    flow_coef: float = 1.0,
    priority_alpha: float = 0.5,
    draws: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None,
):
  """The unrolled loss on a [B, L, ...] batch; returns (total,
  DMZLossMetrics). ``draws``, when given, holds the L - 1 flow-matching
  pairs (t [B], eps [B, E]) in unroll order, in place of fresh draws from
  ``generator``."""
  support = networks.support_size
  flow = networks.flow
  num_steps = num_unroll_steps or batch.action.shape[1]
  batch_size = batch.action.shape[0]
  mask = batch.mask.to(torch.float32)

  s = params.representation(batch.obs[:, 0])
  zeros = torch.zeros(batch_size, device=s.device)
  reward_loss, value_loss, policy_loss = zeros, zeros, zeros
  av_loss, flow_loss = zeros, zeros
  first_value = None

  for i in range(num_steps):
    policy_logits, value_logits = params.prediction(s)
    value_loss = value_loss + mask[:, i] * _ce(
        value_logits, scalar_to_support(batch.rn[:, i], support))
    policy_loss = policy_loss + mask[:, i] * _ce(policy_logits,
                                                 batch.pi[:, i])
    if i == 0:
      first_value = support_to_scalar(torch.softmax(value_logits, -1),
                                      support)
    if i == num_steps - 1:
      break  # no next observation to supervise the transition with

    next_mask = mask[:, i + 1]
    z_next = params.representation(batch.obs[:, i + 1]).detach()

    s = scale_gradient(s, gradient_scale)
    afterstate, av_logits = params.decision(s, batch.action[:, i])
    av_loss = av_loss + next_mask * _ce(
        av_logits, scalar_to_support(batch.rn[:, i], support))

    # Flow matching toward the true next latent, per example so that the
    # segment mask applies (models/diffusion.flow_matching_loss).
    t, eps = (draws[i] if draws is not None
              else flow_matching_draws(generator, z_next))
    mean, std = flow.marginal_prob(z_next, t)
    x_t = mean + batch_mul(std, eps)
    target = z_next - flow.sigma * eps
    pred_v = params.velocity(x_t, t, afterstate)
    flow_loss = flow_loss + next_mask * torch.mean(
        torch.square(pred_v - target), -1)

    reward_logits = params.reward(z_next)
    reward_loss = reward_loss + next_mask * _ce(
        reward_logits, scalar_to_support(batch.reward[:, i], support))

    s = scale_gradient(networks.mean_next_state(params, afterstate),
                       gradient_scale)

  denom = torch.clamp(torch.sum(mask, 1), min=1.0)
  per_example = (reward_loss + value_loss + policy_loss + av_loss
                 + flow_coef * flow_loss) / denom
  weighted = torch.mean(batch.weight * per_example)
  l2 = l2_coef * 0.5 * l2_sum(params)
  total = weighted + l2
  priorities = torch.abs(first_value - batch.rn[:, 0]) ** priority_alpha
  return total, DMZLossMetrics(
      total=total,
      reward_loss=torch.mean(reward_loss / denom),
      value_loss=torch.mean(value_loss / denom),
      policy_loss=torch.mean(policy_loss / denom),
      afterstate_value_loss=torch.mean(av_loss / denom),
      flow_loss=torch.mean(flow_loss / denom),
      l2_loss=l2,
      priorities=priorities.detach(),
  )


def diffusion_muzero_grad(params: DMZParams, batch: Transition,
                          networks: DMZNetworks,
                          generator: Optional[torch.Generator], **kwargs):
  """Autograd over ``diffusion_muzero_loss``: (flat gradient in the order
  of ``params.parameters()``, detached DMZLossMetrics)."""
  with torch.enable_grad():
    total, metrics = diffusion_muzero_loss(params, batch, networks,
                                           generator, **kwargs)
    grads = torch.autograd.grad(total, list(params.parameters()))
  return (torch.cat([g.reshape(-1) for g in grads]),
          DMZLossMetrics(*(m.detach() for m in metrics)))
