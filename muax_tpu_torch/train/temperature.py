"""Visit-count temperature schedules (``muax_tpu/train/temperature.py``).

The standalone 3-stage schedule 1.0/0.5/0.25 at 50%/75%, the acme 4-stage
1.0/0.5/0.1/0 at 20/40/60%, and a piecewise-constant schedule from
((fraction_boundary, value), ...). Each returns a float32 scalar tensor.
"""
from __future__ import annotations

import torch


def _fraction(max_steps, current_step) -> torch.Tensor:
  current = torch.as_tensor(current_step, dtype=torch.float32)
  return current / torch.clamp(torch.as_tensor(max_steps,
                                               dtype=torch.float32), min=1.0)


def _piecewise(frac: torch.Tensor, boundaries, values) -> torch.Tensor:
  temp = torch.full_like(frac, float(values[-1]))
  for boundary, value in reversed(list(zip(boundaries, values[:-1]))):
    temp = torch.where(frac < boundary, torch.full_like(frac, float(value)),
                       temp)
  return temp


def standalone_temperature(max_steps, current_step) -> torch.Tensor:
  return _piecewise(_fraction(max_steps, current_step), (0.5, 0.75),
                    (1.0, 0.5, 0.25))


def acme_temperature(max_steps, current_step) -> torch.Tensor:
  return _piecewise(_fraction(max_steps, current_step), (0.2, 0.4, 0.6),
                    (1.0, 0.5, 0.1, 0.0))


def schedule_temperature(schedule, max_steps, current_step) -> torch.Tensor:
  """Piecewise-constant from ((frac_boundary, value), ...) tuples."""
  boundaries = [b for b, _ in schedule[:-1]]
  values = [v for _, v in schedule]
  return _piecewise(_fraction(max_steps, current_step), boundaries, values)
