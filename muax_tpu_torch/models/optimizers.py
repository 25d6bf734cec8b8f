"""The canonical MuZero optimizer over one flat parameter vector
(``muax_tpu/models/optimizers.py:18-70``).

The chain is clip-by-global-norm, Adam scaling, a warm-up then exponential
decay schedule, and a sign flip: optax's ``clip_by_global_norm``,
``scale_by_adam``, ``scale_by_schedule(warmup_exponential_decay_schedule)``
and ``scale(-1)``, with their arithmetic written out in float32 so the port
steps as optax does. It runs over one flat f32 vector: the towers'
parameters are views of that vector (``flat_parameters``), so one update is
a handful of elementwise ops, whatever the number of layers.

The actor temperature is a buffer, not a parameter, and is not in the
vector; the JAX package gives it a zero gradient, which moves nothing.
``torch.nn.utils.clip_grad_norm_`` is not used: it divides by
``norm + 1e-6``, which optax does not.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import nn


class OptState(NamedTuple):
  """Shared step count (read by the schedule before it increments) and the
  Adam moments, flat f32 vectors."""
  count: int
  mu: torch.Tensor
  nu: torch.Tensor


class GradientTransformation(NamedTuple):
  init: Callable
  update: Callable


def flat_parameters(module: nn.Module) -> torch.Tensor:
  """The flat f32 buffer that ``module``'s parameters are views of, in
  ``module.parameters()`` order (for the MLP triplet: each tower's linears
  in haiku's creation order, weight [out, in] then bias).

  The first call moves the parameters into one new buffer; later calls
  return the same buffer as long as every parameter still views it.
  Updating the buffer in place updates the modules.
  """
  params = list(module.parameters())
  flat = getattr(module, "_flat_buffer", None)
  if flat is not None:
    offset, ok = 0, True
    base = flat.data_ptr()
    for p in params:
      if (p.data_ptr() != base + 4 * offset or not p.is_contiguous()
          or p.dtype != torch.float32):
        ok = False
        break
      offset += p.numel()
    if ok and offset == flat.numel():
      return flat
  with torch.no_grad():
    flat = torch.cat([p.detach().reshape(-1).to(torch.float32)
                      for p in params])
    offset = 0
    for p in params:
      n = p.numel()
      p.data = flat[offset:offset + n].view(p.shape)
      offset += n
  module._flat_buffer = flat
  return flat


def apply_updates(params: nn.Module, updates: torch.Tensor) -> None:
  """``params += updates`` in place, through the flat buffer."""
  with torch.no_grad():
    flat_parameters(params).add_(updates)


def warmup_exponential_decay_schedule(init_value: float, peak_value: float,
                                      warmup_steps: int,
                                      transition_steps: int,
                                      decay_rate: float,
                                      end_value: float) -> Callable:
  """count -> learning rate, in float32 as optax computes it: linear from
  ``init_value`` to ``peak_value`` over ``warmup_steps``, then
  ``peak * decay_rate ** ((count - warmup) / transition_steps)`` floored at
  ``end_value``."""
  f32 = np.float32

  def schedule(count: int) -> float:
    if count < warmup_steps:
      frac = f32(1.0) - f32(min(max(count, 0), warmup_steps)) / f32(
          warmup_steps)
      return float((f32(init_value) - f32(peak_value)) * frac
                   + f32(peak_value))
    decayed = count - warmup_steps
    value = f32(peak_value)
    if decayed > 0:
      value = f32(peak_value) * f32(decay_rate) ** (
          f32(decayed) / f32(transition_steps))
    return float(max(value, f32(end_value)))

  return schedule


def _muzero_chain(schedule, clip_norm: float, b1: float = 0.9,
                  b2: float = 0.999, eps: float = 1e-8
                  ) -> GradientTransformation:
  """clip_by_global_norm -> scale_by_adam -> scale_by_schedule -> scale(-1)
  over one flat vector."""
  f32 = np.float32

  def init(flat: torch.Tensor) -> OptState:
    return OptState(count=0, mu=torch.zeros_like(flat),
                    nu=torch.zeros_like(flat))

  def update(grads: torch.Tensor, state: OptState):
    norm = torch.sqrt(torch.sum(grads * grads))
    grads = torch.where(norm < clip_norm, grads, grads / norm * clip_norm)
    mu = grads * (1.0 - b1) + state.mu * b1
    nu = grads * grads * (1.0 - b2) + state.nu * b2
    count = state.count + 1
    mu_hat = mu / float(f32(1.0) - f32(b1) ** f32(count))
    nu_hat = nu / float(f32(1.0) - f32(b2) ** f32(count))
    updates = mu_hat / (torch.sqrt(nu_hat) + eps)
    # The schedule reads the count before it increments: the first update
    # is scaled by schedule(0), which is exactly zero from init 0.
    updates = updates * schedule(state.count) * -1.0
    return updates, OptState(count=count, mu=mu, nu=nu)

  return GradientTransformation(init, update)


def flatten_optimizer(
    optimizer: GradientTransformation) -> GradientTransformation:
  """A flat-vector chain over a module: ``init`` takes the module (its
  ``flat_parameters``), ``update`` takes the flat gradient vector or the
  per-parameter gradients in ``parameters()`` order."""

  def init(params: nn.Module) -> OptState:
    return optimizer.init(flat_parameters(params).detach())

  def update(grads, state: OptState):
    if not isinstance(grads, torch.Tensor):
      grads = torch.cat([g.reshape(-1) for g in grads])
    return optimizer.update(grads, state)

  return GradientTransformation(init, update)


def muzero_optimizer(
    peak_lr: float = 2e-2,
    end_lr: float = 1e-3,
    warmup_steps: int = 1_000,
    transition_steps: int = 10_000,
    decay_rate: float = 0.8,
    clip_by_global_norm: float = 1.0,
    init_lr: float = 0.0,
) -> GradientTransformation:
  """The canonical muax optimizer chain (coax/model.py:23-71 defaults)."""
  schedule = warmup_exponential_decay_schedule(
      init_value=init_lr, peak_value=peak_lr, warmup_steps=warmup_steps,
      transition_steps=transition_steps, decay_rate=decay_rate,
      end_value=end_lr)
  return flatten_optimizer(_muzero_chain(schedule, clip_by_global_norm))
