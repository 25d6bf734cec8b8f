"""Categorical value-support transforms (the MuZero "two-hot" trick).

Two flavors, as in ``muax_tpu/ops/support.py``:
  * integer support [-S, S] with the invertible h(x) value scaling, and
  * linear two-hot over ``[vmin, vmax]`` with ``num_bins`` bins.

h(x) = sign(x) * (sqrt(|x| + 1) - 1) + eps * x  (arXiv:1805.11593).
All functions work over leading batch dims.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_EPS = 1e-3


def value_transform(x: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
  """Invertible scaling h(x) compressing value/reward magnitudes."""
  return torch.sign(x) * (torch.sqrt(torch.abs(x) + 1.0) - 1.0) + eps * x


def inv_value_transform(x: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
  """Inverse of :func:`value_transform` (closed form)."""
  return torch.sign(x) * (
      torch.square(
          (torch.sqrt(4.0 * eps * (torch.abs(x) + 1.0 + eps) + 1.0) - 1.0)
          / (2.0 * eps))
      - 1.0)


def _two_hot(pos: torch.Tensor, offset: int, num_bins: int) -> torch.Tensor:
  """Two-hot over ``num_bins`` bins at fractional position ``pos`` whose
  bin 0 sits at ``-offset``."""
  low = torch.floor(pos)
  prob_high = pos - low
  low_idx = low.long() + offset
  high_idx = torch.clamp(low_idx + 1, 0, num_bins - 1)
  onehot_low = F.one_hot(low_idx, num_bins).to(pos.dtype)
  onehot_high = F.one_hot(high_idx, num_bins).to(pos.dtype)
  return (onehot_low * (1.0 - prob_high)[..., None]
          + onehot_high * prob_high[..., None])


def scalar_to_support(x: torch.Tensor, support_size: int) -> torch.Tensor:
  """Scalar [...] -> two-hot probabilities [..., 2S+1] over [-S, S] after h."""
  x = torch.clamp(value_transform(x), -support_size, support_size)
  return _two_hot(x, support_size, 2 * support_size + 1)


def support_to_scalar(probs: torch.Tensor, support_size: int) -> torch.Tensor:
  """Categorical over [-S, S] -> scalar expectation, then h^-1."""
  bins = torch.arange(-support_size, support_size + 1, dtype=probs.dtype,
                      device=probs.device)
  return inv_value_transform(torch.sum(probs * bins, dim=-1))


def logits_to_scalar(logits: torch.Tensor, support_size: int) -> torch.Tensor:
  """Softmax over logits then :func:`support_to_scalar`."""
  return support_to_scalar(torch.softmax(logits, dim=-1), support_size)


def scalar_to_two_hot(x: torch.Tensor, num_bins: int, vmin: float,
                      vmax: float) -> torch.Tensor:
  """rlax-style linear two-hot over ``num_bins`` bins spanning [vmin, vmax]
  (no h scaling)."""
  x = torch.clamp(x, vmin, vmax)
  step = (vmax - vmin) / (num_bins - 1)
  return _two_hot((x - vmin) / step, 0, num_bins)


def two_hot_to_scalar(probs: torch.Tensor, vmin: float,
                      vmax: float) -> torch.Tensor:
  """Expectation of a linear two-hot categorical."""
  bins = torch.linspace(vmin, vmax, probs.shape[-1], dtype=probs.dtype,
                        device=probs.device)
  return torch.sum(probs * bins, dim=-1)


def two_hot_logits_to_scalar(logits: torch.Tensor, vmin: float,
                             vmax: float) -> torch.Tensor:
  return two_hot_to_scalar(torch.softmax(logits, dim=-1), vmin, vmax)
