"""Shared data structures flowing between rollout, replay, and learner."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Transition:
  """A window of experience, batched [B, L, ...] (``muax_tpu/types.py``).

  ``mask`` marks steps that belong to the episode (pre-terminal); targets
  after a terminal are invalid and the loss zeroes them.
  """
  obs: torch.Tensor        # [B, L, ...]
  action: torch.Tensor     # [B, L] int32
  reward: torch.Tensor     # [B, L]
  done: torch.Tensor       # [B, L] bool
  rn: torch.Tensor         # [B, L] n-step bootstrapped return target
  value: torch.Tensor      # [B, L] search value at t
  pi: torch.Tensor         # [B, L, A] search action weights
  weight: torch.Tensor     # [B] PER importance weight
  mask: torch.Tensor       # [B, L] validity of each unroll step
