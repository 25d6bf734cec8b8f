"""The Stochastic MuZero k-step unrolled loss
(``muax_tpu/models/stochastic_losses.py``).

Per unroll step: the chance outcome between t and t+1 is encoded from the
next observation as a straight-through one-hot code; the decision net maps
(state, action) to (afterstate, chance logits, afterstate value); the chance
net maps (afterstate, code) to (next state, reward). Losses: reward, value
and policy cross-entropies, the chance outcome (chance logits against the
detached code), the afterstate value (against the same step's n-step
return) and the VQ-VAE commitment beta * mean((softmax(enc) - sg(code))^2).
The last unroll step has no next observation, so the chance chain runs
K - 1 steps. The L2 term covers the five nets, not the temperature.

Autograd over this function is the port's gradient for the family: the
JAX package has no learner kernel for it either.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from muax_tpu_torch.models.losses import _ce, l2_sum
from muax_tpu_torch.models.stochastic_networks import (SMZNetworks, SMZParams,
                                                       straight_through_code)
from muax_tpu_torch.ops import (scalar_to_support, scale_gradient,
                                support_to_scalar)
from muax_tpu_torch.types import Transition


class SMZLossMetrics(NamedTuple):
  total: torch.Tensor
  reward_loss: torch.Tensor
  value_loss: torch.Tensor
  policy_loss: torch.Tensor
  chance_loss: torch.Tensor
  afterstate_value_loss: torch.Tensor
  commitment_loss: torch.Tensor
  l2_loss: torch.Tensor
  priorities: torch.Tensor  # [B] fresh PER priorities (detached)


def stochastic_muzero_loss(
    params: SMZParams,
    batch: Transition,
    networks: SMZNetworks,
    *,
    num_unroll_steps: Optional[int] = None,
    l2_coef: float = 1e-4,
    gradient_scale: float = 0.5,
    vqvae_beta: float = 0.25,
    priority_alpha: float = 0.5,
):
  """The unrolled loss on a [B, L, ...] batch; returns (total,
  SMZLossMetrics)."""
  support = networks.support_size
  num_steps = num_unroll_steps or batch.action.shape[1]
  batch_size = batch.action.shape[0]
  mask = batch.mask.to(torch.float32)

  s = params.representation(batch.obs[:, 0])
  zeros = torch.zeros(batch_size, device=s.device)
  reward_loss, value_loss, policy_loss = zeros, zeros, zeros
  chance_loss, av_loss, commit_loss = zeros, zeros, zeros
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
      break  # no next observation to encode the chance outcome from

    next_mask = mask[:, i + 1]
    enc_logits = params.encoder(batch.obs[:, i + 1])
    code = straight_through_code(enc_logits)

    s = scale_gradient(s, gradient_scale)
    afterstate, chance_logits, av_logits = params.decision(
        s, batch.action[:, i])
    av_loss = av_loss + next_mask * _ce(
        av_logits, scalar_to_support(batch.rn[:, i], support))
    chance_loss = chance_loss + next_mask * _ce(chance_logits, code)
    commit_loss = commit_loss + next_mask * torch.mean(
        torch.square(torch.softmax(enc_logits, -1) - code.detach()), -1)

    afterstate = scale_gradient(afterstate, gradient_scale)
    s, reward_logits = params.chance(afterstate, code)
    reward_loss = reward_loss + next_mask * _ce(
        reward_logits, scalar_to_support(batch.reward[:, i], support))

  denom = torch.clamp(torch.sum(mask, 1), min=1.0)
  per_example = (reward_loss + value_loss + policy_loss + chance_loss
                 + av_loss + vqvae_beta * commit_loss) / denom
  weighted = torch.mean(batch.weight * per_example)
  l2 = l2_coef * 0.5 * l2_sum(params)
  total = weighted + l2
  priorities = torch.abs(first_value - batch.rn[:, 0]) ** priority_alpha
  return total, SMZLossMetrics(
      total=total,
      reward_loss=torch.mean(reward_loss / denom),
      value_loss=torch.mean(value_loss / denom),
      policy_loss=torch.mean(policy_loss / denom),
      chance_loss=torch.mean(chance_loss / denom),
      afterstate_value_loss=torch.mean(av_loss / denom),
      commitment_loss=torch.mean(commit_loss / denom),
      l2_loss=l2,
      priorities=priorities.detach(),
  )


def stochastic_muzero_grad(params: SMZParams, batch: Transition,
                           networks: SMZNetworks, **kwargs):
  """Autograd over ``stochastic_muzero_loss``: (flat gradient in the order
  of ``params.parameters()``, detached SMZLossMetrics)."""
  with torch.enable_grad():
    total, metrics = stochastic_muzero_loss(params, batch, networks,
                                            **kwargs)
    grads = torch.autograd.grad(total, list(params.parameters()))
  return (torch.cat([g.reshape(-1) for g in grads]),
          SMZLossMetrics(*(m.detach() for m in metrics)))
