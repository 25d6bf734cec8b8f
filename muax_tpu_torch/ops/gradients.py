"""Gradient-flow utilities (``muax_tpu/ops/gradients.py``)."""
from __future__ import annotations

import torch


def scale_gradient(t: torch.Tensor, scale: float) -> torch.Tensor:
  """Identity in the forward pass; multiplies the gradient by ``scale``.

  Used to halve gradient flow through the dynamics unroll (MuZero
  appendix G).
  """
  return t * scale + t.detach() * (1.0 - scale)


class _ClipGradient(torch.autograd.Function):

  @staticmethod
  def forward(ctx, t, clip):
    ctx.clip = clip
    return t.view_as(t)

  @staticmethod
  def backward(ctx, grad):
    return torch.clamp(grad, -ctx.clip, ctx.clip), None


def clip_gradient(t: torch.Tensor, clip: float) -> torch.Tensor:
  """Identity in the forward pass; clamps the gradient elementwise to
  [-clip, clip] in the backward pass."""
  return _ClipGradient.apply(t, clip)
