"""Gradient-flow utilities (``muax_tpu/ops/gradients.py``)."""
from __future__ import annotations

import torch


def scale_gradient(t: torch.Tensor, scale: float) -> torch.Tensor:
  """Identity in the forward pass; multiplies the gradient by ``scale``.

  Used to halve gradient flow through the dynamics unroll (MuZero
  appendix G).
  """
  return t * scale + t.detach() * (1.0 - scale)
