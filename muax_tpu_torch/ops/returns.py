"""Bootstrapped return targets over on-device batches
(``muax_tpu/ops/returns.py``)."""
from __future__ import annotations

import torch


def n_step_bootstrapped_returns(
    r_t: torch.Tensor,
    discount_t: torch.Tensor,
    v_t: torch.Tensor,
    n: int,
    lambda_t: float = 1.0,
) -> torch.Tensor:
  """n-step lambda-bootstrapped return targets along the last time axis.

  For each t: G_t = r_t + d_t * [(1-l) v_t + l * G_{t+1}], truncated n steps
  ahead by bootstrapping with v. ``r_t``, ``discount_t`` and ``v_t`` are
  [..., T] at times 1..T (discount 0 at a terminal). Returns [..., T].
  """
  seq_len = r_t.shape[-1]
  lead = r_t.shape[:-1]
  lambda_t = torch.ones_like(discount_t) * lambda_t

  # Pad with n-1 zero rewards / unit discounts / copies of the last value so
  # every position can look n steps ahead, then extend the recursion one step
  # deeper per pass.
  pad = n - 1
  r_t = torch.cat([r_t, r_t.new_zeros(lead + (pad,))], -1)
  discount_t = torch.cat([discount_t, discount_t.new_ones(lead + (pad,))], -1)
  lambda_t = torch.cat([lambda_t, lambda_t.new_ones(lead + (pad,))], -1)
  v_t = torch.cat([v_t, v_t[..., -1:].expand(lead + (pad,))], -1)

  targets = v_t[..., n - 1:]
  for i in reversed(range(n)):
    r_ = r_t[..., i:i + seq_len]
    d_ = discount_t[..., i:i + seq_len]
    l_ = lambda_t[..., i:i + seq_len]
    v_ = v_t[..., i:i + seq_len]
    targets = r_ + d_ * ((1.0 - l_) * v_ + l_ * targets)
  return targets.detach()


def batched_n_step_returns(r: torch.Tensor, d: torch.Tensor,
                           v: torch.Tensor, n: int,
                           lambda_t: float = 1.0) -> torch.Tensor:
  """``n_step_bootstrapped_returns`` of each row of [B, T] inputs (the JAX
  package's vmap over a leading batch dim; the recursion here already runs
  along the last axis of any batch)."""
  return n_step_bootstrapped_returns(r, d, v, n, lambda_t)


def segment_n_step_returns(
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    discount: float,
    n: int,
    lambda_t: float = 1.0,
) -> torch.Tensor:
  """Episode-boundary-aware n-step returns for auto-reset rollout segments.

  The recursion never crosses a terminal (at a done step the target is the
  reward), and positions whose n-step window is cut by the segment end
  bootstrap with the stored search value at the cut.

  Args:
    rewards: [T] or [T, B] rewards observed after acting at t.
    values: [T] or [T, B] search values at t.
    dones: [T] or [T, B] terminal flags for the step taken at t.

  Returns:
    Rn targets, same shape as rewards.
  """
  d = (1.0 - dones.to(rewards.dtype)) * discount
  # v_t[i] bootstraps after reward r[i]: pass the values shifted one left.
  v_next = torch.cat([values[1:], values[-1:]], dim=0)
  if rewards.ndim == 1:
    return n_step_bootstrapped_returns(rewards, d, v_next, n, lambda_t)
  out = n_step_bootstrapped_returns(rewards.transpose(0, 1),
                                    d.transpose(0, 1),
                                    v_next.transpose(0, 1), n, lambda_t)
  return out.transpose(0, 1)
