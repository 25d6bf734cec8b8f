"""Hidden-state normalization used by MuZero-family nets
(``muax_tpu/ops/normalize.py``)."""
from __future__ import annotations

import torch


def min_max_normalize(s: torch.Tensor, dim: int = -1,
                      eps: float = 1e-8) -> torch.Tensor:
  """Per-row min-max scaling of an embedding to [0, 1]."""
  s_min = torch.amin(s, dim=dim, keepdim=True)
  s_max = torch.amax(s, dim=dim, keepdim=True)
  return (s - s_min) / torch.clamp(s_max - s_min, min=eps)
