"""Optimizers over one flat parameter vector (``muax_tpu/models/optimizers.py``):
the canonical MuZero chain and the name-keyed factory ``create_optimizer``.

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

``create_optimizer`` builds optax's adam, adamw, sgd, rmsprop, adagrad and
lion, with optax's defaults, over the same flat vector, optionally under
one of five learning-rate schedules. Each transformation here steps a flat
f32 vector: ``update(grads, state, params)`` takes the flat gradients and,
for the weight decay of adamw and lion, the flat parameters. Schedules and
bias corrections are computed in float32 on the host from a Python step
count, as optax computes them from its int32 count.
"""
from __future__ import annotations

from typing import Callable, Mapping, NamedTuple, Optional, Sequence

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


# --------------------------------------------------------------------------
# optax's transformations over one flat f32 vector.
# --------------------------------------------------------------------------

_f32 = np.float32


class ScheduleState(NamedTuple):
  count: int


class TraceState(NamedTuple):
  trace: torch.Tensor


class ScaleByRmsState(NamedTuple):
  nu: torch.Tensor


class ScaleByRssState(NamedTuple):
  sum_of_squares: torch.Tensor


class ScaleByLionState(NamedTuple):
  count: int
  mu: torch.Tensor


class EmptyState(NamedTuple):
  pass


def chain(*transforms: GradientTransformation) -> GradientTransformation:
  """optax.chain over flat vectors: the state is the tuple of the
  transformations' states."""

  def init(flat):
    return tuple(t.init(flat) for t in transforms)

  def update(grads, state, params=None):
    new_state = []
    for t, s in zip(transforms, state):
      grads, s = t.update(grads, s, params)
      new_state.append(s)
    return grads, tuple(new_state)

  return GradientTransformation(init, update)


def _stateless(fn) -> GradientTransformation:
  return GradientTransformation(lambda flat: EmptyState(),
                                lambda g, state, params=None: (
                                    fn(g, params), state))


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
  """optax.clip_by_global_norm over the flat gradient vector."""
  def clip(g, params):
    norm = torch.sqrt(torch.sum(g * g))
    return torch.where(norm < max_norm, g, g / norm * max_norm)
  return _stateless(clip)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
  """updates + weight_decay * params (the flat parameters before the step,
  or the module they belong to: its ``flat_parameters`` are looked up here,
  so optimizers without weight decay never pay for the lookup)."""
  def decay(g, params):
    if params is None:
      raise ValueError("weight decay needs the parameters: pass params to "
                       "update")
    if isinstance(params, nn.Module):
      params = flat_parameters(params)
    return g + params * weight_decay
  return _stateless(decay)


def scale_by_learning_rate(learning_rate) -> GradientTransformation:
  """-learning_rate, a float or a schedule of the count (read before it
  increments: the first update takes schedule(0))."""
  if not callable(learning_rate):
    return _stateless(lambda g, params: g * -learning_rate)

  def update(g, state: ScheduleState, params=None):
    step = float(_f32(-learning_rate(state.count)))
    return g * step, ScheduleState(state.count + 1)

  return GradientTransformation(lambda flat: ScheduleState(0), update)


def _bias_correction(decay: float, count: int) -> float:
  return float(_f32(1.0) - _f32(decay) ** _f32(count))


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransformation:
  """Adam's moments with bias correction from the first step; eps outside
  the square root (optax's eps_root = 0)."""

  def init(flat):
    return OptState(count=0, mu=torch.zeros_like(flat),
                    nu=torch.zeros_like(flat))

  def update(g, state: OptState, params=None):
    mu = g * (1.0 - b1) + state.mu * b1
    nu = g * g * (1.0 - b2) + state.nu * b2
    count = state.count + 1
    mu_hat = mu / _bias_correction(b1, count)
    nu_hat = nu / _bias_correction(b2, count)
    return mu_hat / (torch.sqrt(nu_hat) + eps), OptState(count, mu, nu)

  return GradientTransformation(init, update)


def trace(decay: float) -> GradientTransformation:
  """Momentum: trace = g + decay * trace, and the update is the trace."""

  def update(g, state: TraceState, params=None):
    t = g + state.trace * decay
    return t, TraceState(t)

  return GradientTransformation(
      lambda flat: TraceState(torch.zeros_like(flat)), update)


def scale_by_rms(decay: float = 0.9, eps: float = 1e-8,
                 initial_scale: float = 0.0) -> GradientTransformation:
  """g / sqrt(nu + eps), nu the moving average of g^2 (eps inside the
  root, no bias correction: optax's rmsprop defaults)."""

  def update(g, state: ScaleByRmsState, params=None):
    nu = g * g * (1.0 - decay) + state.nu * decay
    return torch.rsqrt(nu + eps) * g, ScaleByRmsState(nu)

  return GradientTransformation(
      lambda flat: ScaleByRmsState(torch.full_like(flat, initial_scale)),
      update)


def scale_by_rss(initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7) -> GradientTransformation:
  """Adagrad: g / sqrt(sum of g^2 + eps), the sum starting at 0.1."""

  def update(g, state: ScaleByRssState, params=None):
    sos = g * g + state.sum_of_squares
    inv = torch.where(sos > 0, torch.rsqrt(sos + eps),
                      torch.zeros_like(sos))
    return inv * g, ScaleByRssState(sos)

  return GradientTransformation(
      lambda flat: ScaleByRssState(
          torch.full_like(flat, initial_accumulator_value)), update)


def scale_by_lion(b1: float = 0.9, b2: float = 0.99
                  ) -> GradientTransformation:
  """sign((1 - b1) g + b1 mu), then mu = (1 - b2) g + b2 mu."""

  def update(g, state: ScaleByLionState, params=None):
    direction = torch.sign(g * (1.0 - b1) + state.mu * b1)
    mu = g * (1.0 - b2) + state.mu * b2
    return direction, ScaleByLionState(state.count + 1, mu)

  return GradientTransformation(
      lambda flat: ScaleByLionState(0, torch.zeros_like(flat)), update)


def _muzero_chain(schedule, clip_norm: float, b1: float = 0.9,
                  b2: float = 0.999, eps: float = 1e-8
                  ) -> GradientTransformation:
  """clip_by_global_norm -> scale_by_adam -> scale_by_schedule -> scale(-1)
  over one flat vector, its state Adam's ``OptState``."""
  clip = clip_by_global_norm(clip_norm)
  adam = scale_by_adam(b1, b2, eps)

  def update(grads: torch.Tensor, state: OptState, params=None):
    updates, new_state = adam.update(clip.update(grads, None)[0], state)
    # The schedule reads the count before it increments: the first update
    # is scaled by schedule(0), which is exactly zero from init 0.
    return updates * schedule(state.count) * -1.0, new_state

  return GradientTransformation(adam.init, update)


def flatten_optimizer(
    optimizer: GradientTransformation) -> GradientTransformation:
  """A flat-vector chain over a module: ``init`` takes the module (its
  ``flat_parameters``), ``update`` takes the flat gradient vector or the
  per-parameter gradients in ``parameters()`` order, and the parameters as
  a module or as their flat vector, which only weight decay reads."""

  def init(params: nn.Module) -> OptState:
    return optimizer.init(flat_parameters(params).detach())

  def update(grads, state: OptState, params=None):
    if not isinstance(grads, torch.Tensor):
      grads = torch.cat([g.reshape(-1) for g in grads])
    return optimizer.update(grads, state, params)

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


# --------------------------------------------------------------------------
# The name-keyed factory (``muax_tpu/models/optimizers.py:73-138``).
# --------------------------------------------------------------------------

def adam(learning_rate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
  return chain(scale_by_adam(b1, b2, eps),
               scale_by_learning_rate(learning_rate))


def adamw(learning_rate, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4
          ) -> GradientTransformation:
  return chain(scale_by_adam(b1, b2, eps), add_decayed_weights(weight_decay),
               scale_by_learning_rate(learning_rate))


def sgd(learning_rate, momentum: Optional[float] = None
        ) -> GradientTransformation:
  head = (trace(momentum),) if momentum is not None else ()
  return chain(*head, scale_by_learning_rate(learning_rate))


def rmsprop(learning_rate, decay: float = 0.9,
            eps: float = 1e-8) -> GradientTransformation:
  return chain(scale_by_rms(decay, eps), scale_by_learning_rate(learning_rate))


def adagrad(learning_rate, initial_accumulator_value: float = 0.1,
            eps: float = 1e-7) -> GradientTransformation:
  return chain(scale_by_rss(initial_accumulator_value, eps),
               scale_by_learning_rate(learning_rate))


def lion(learning_rate, b1: float = 0.9, b2: float = 0.99,
         weight_decay: float = 1e-3) -> GradientTransformation:
  return chain(scale_by_lion(b1, b2), add_decayed_weights(weight_decay),
               scale_by_learning_rate(learning_rate))


def polynomial_schedule(init_value: float, end_value: float, power,
                        transition_steps: int) -> Callable:
  """(init - end) * (1 - count / steps) ** power + end, the count clipped
  to [0, steps]."""
  if transition_steps <= 0:
    return lambda count: init_value

  def schedule(count: int) -> float:
    c = min(max(count, 0), transition_steps)
    frac = _f32(1.0) - _f32(c) / _f32(transition_steps)
    # An integer power multiplies exactly, as XLA's integer pow does.
    scaled = frac ** power if isinstance(power, int) else (
        frac ** _f32(power))
    return float(_f32(init_value - end_value) * scaled + _f32(end_value))

  return schedule


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float,
                      end_value: Optional[float] = None) -> Callable:
  """init * decay_rate ** (count / steps), clipped at ``end_value``."""
  if transition_steps <= 0 or decay_rate == 0:
    return lambda count: init_value

  def schedule(count: int) -> float:
    if count <= 0:
      value = _f32(init_value)
    else:
      value = _f32(init_value) * _f32(decay_rate) ** (
          _f32(count) / _f32(transition_steps))
    if end_value is not None:
      clip = max if decay_rate < 1.0 else min
      value = clip(value, _f32(end_value))
    return float(value)

  return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable:
  """init * ((1 - alpha) * (1 + cos(pi * count / steps)) / 2 + alpha),
  the count capped at ``decay_steps``."""
  if not decay_steps > 0:
    raise ValueError("cosine_decay_schedule needs positive decay_steps, got "
                     f"{decay_steps}")

  def schedule(count: int) -> float:
    c = _f32(min(count, decay_steps))
    cosine = _f32(0.5) * (_f32(1.0) + np.cos(
        _f32(np.pi) * c / _f32(decay_steps)))
    return float(_f32(init_value) * (_f32(1.0 - alpha) * cosine
                                     + _f32(alpha)))

  return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Callable:
  """Linear from ``init_value`` to ``peak_value`` over ``warmup_steps``,
  then a cosine decay to ``end_value`` at ``decay_steps``."""
  alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
  warmup = polynomial_schedule(init_value, peak_value, 1, warmup_steps)
  decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                alpha)
  return lambda count: (warmup(count) if count < warmup_steps
                        else decay(count - warmup_steps))


def piecewise_constant_schedule(
    init_value: float,
    boundaries_and_scales: Optional[Mapping[int, float]] = None) -> Callable:
  """``init_value`` times every scale whose boundary the count has
  reached."""
  if boundaries_and_scales and any(
      s < 0 for s in boundaries_and_scales.values()):
    raise ValueError("piecewise_constant_schedule expects non-negative "
                     "scale factors")

  def schedule(count: int) -> float:
    v = _f32(init_value)
    for threshold, scale in sorted((boundaries_and_scales or {}).items()):
      indicator = _f32(max(0.0, np.sign(threshold - count)))
      v = v * indicator + (_f32(1.0) - indicator) * _f32(scale) * v
    return float(v)

  return schedule


def _create_scheduler(name: Optional[str], lr: float, **kwargs):
  if name is None:
    return lr
  if name == "warmup_cosine_decay":
    return warmup_cosine_decay_schedule(
        init_value=kwargs.get("init_value", 0.0),
        peak_value=kwargs.get("peak_value", lr),
        warmup_steps=kwargs.get("warmup_steps", 1_000),
        decay_steps=kwargs.get("decay_steps", 10_000),
        end_value=kwargs.get("end_value", 0.0))
  if name == "exponential_decay":
    return exponential_decay(
        init_value=lr,
        transition_steps=kwargs.get("transition_steps", 10_000),
        decay_rate=kwargs.get("decay_rate", 0.96),
        end_value=kwargs.get("end_value"))
  if name == "cosine_decay":
    return cosine_decay_schedule(
        init_value=lr, decay_steps=kwargs.get("decay_steps", 10_000),
        alpha=kwargs.get("alpha", 0.0))
  if name == "polynomial":
    return polynomial_schedule(
        init_value=lr, end_value=kwargs.get("end_value", 1e-4),
        power=kwargs.get("power", 1.0),
        transition_steps=kwargs.get("transition_steps", 10_000))
  if name == "piecewise_constant":
    return piecewise_constant_schedule(
        init_value=lr,
        boundaries_and_scales=kwargs.get("boundaries_and_scales", {}))
  raise ValueError(f"Unknown scheduler: {name!r}")


_BASE_OPTIMIZERS = {
    "adam": adam,
    "adamw": adamw,
    "sgd": sgd,
    "rmsprop": rmsprop,
    "adagrad": adagrad,
    "lion": lion,
}


def create_optimizer(
    name: str = "adam",
    lr: float = 1e-3,
    scheduler: Optional[str] = None,
    extra_transforms: Sequence[GradientTransformation] = (),
    **kwargs,
) -> GradientTransformation:
  """The name-keyed factory over a module's flat parameters: the base
  optimizer ``name`` at learning rate ``lr`` or under ``scheduler``, with
  ``extra_transforms`` (flat-vector transformations such as
  ``clip_by_global_norm``) chained in front. ``momentum`` reaches sgd and
  ``weight_decay`` adamw; the other keywords configure the scheduler."""
  if name not in _BASE_OPTIMIZERS:
    raise ValueError(
        f"Unknown optimizer {name!r}; choose from {sorted(_BASE_OPTIMIZERS)}")
  schedule = _create_scheduler(scheduler, lr, **kwargs)
  opt_kwargs = {}
  if name == "sgd" and "momentum" in kwargs:
    opt_kwargs["momentum"] = kwargs["momentum"]
  if name == "adamw" and "weight_decay" in kwargs:
    opt_kwargs["weight_decay"] = kwargs["weight_decay"]
  base = _BASE_OPTIMIZERS[name](schedule, **opt_kwargs)
  return flatten_optimizer(chain(*extra_transforms, base)
                           if extra_transforms else base)
