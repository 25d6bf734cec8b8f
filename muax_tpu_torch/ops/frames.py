"""Frame-level observation transforms (``muax_tpu/ops/frames.py``): the
Pascal-matrix frame differencing and a discrete action broadcast into an
image plane."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch


def diff_transform_matrix(num_frames: int, dtype=torch.float32,
                          device=None) -> torch.Tensor:
  """[num_frames, num_frames] matrix of alternating-sign binomial
  coefficients. Column k holds the finite-difference stencil of order k,
  so ``frames @ M`` maps stacked frames to (last frame, 1st difference, 2nd
  difference, ...)."""
  n = num_frames
  m = np.zeros((n, n), dtype=np.float64)
  for k in range(n):
    for i in range(k + 1):
      m[n - 1 - i, k] = ((-1) ** i) * math.comb(k, i)
  return torch.as_tensor(m, dtype=dtype, device=device)


def diff_transform(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
  """The Pascal diff transform over the trailing frame-stack axis."""
  m = diff_transform_matrix(x.shape[-1], dtype=dtype, device=x.device)
  return x.to(dtype) @ m


def action2plane(action: torch.Tensor, shape: Sequence[int],
                 num_actions: Optional[int] = None,
                 dtype=torch.float32) -> torch.Tensor:
  """Broadcast actions [...] to constant planes [..., *shape]: the value is
  ``a / num_actions`` when ``num_actions`` is given (the AlphaZero-style
  scaled plane), else the raw action."""
  a = torch.as_tensor(action).to(dtype)
  if num_actions is not None:
    a = a / num_actions
  return a.reshape(tuple(a.shape) + (1,) * len(shape)).expand(
      tuple(a.shape) + tuple(shape))
