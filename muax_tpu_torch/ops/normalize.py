"""Hidden-state normalization used by MuZero-family nets
(``muax_tpu/ops/normalize.py``)."""
from __future__ import annotations

from typing import Sequence, Union

import torch


def min_max_normalize(s: torch.Tensor,
                      dim: Union[int, Sequence[int]] = -1,
                      eps: float = 1e-8) -> torch.Tensor:
  """Min-max scaling to [0, 1] over ``dim`` (an int or a tuple, as JAX's
  ``axis``): per row of an embedding by default."""
  s_min = torch.amin(s, dim=dim, keepdim=True)
  s_max = torch.amax(s, dim=dim, keepdim=True)
  return (s - s_min) / torch.clamp(s_max - s_min, min=eps)


def min_max_normalize2d(s: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
  """Per-feature-map min-max scaling of conv latents [..., C, H, W] (NCHW:
  over the last two dims; the JAX package reduces (-3, -2) of NHWC)."""
  return min_max_normalize(s, (-2, -1), eps)
