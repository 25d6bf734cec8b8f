"""Numerics guards (``muax_tpu/utils/debug.py``): a NaN/Inf check on the
learner's gradients that costs nothing unless it is turned on."""
from __future__ import annotations

import torch

_CHECK_NUMERICS = False


def set_check_numerics(enabled: bool) -> None:
  """Turn the ``check_numerics`` guard on or off for the whole process."""
  global _CHECK_NUMERICS
  _CHECK_NUMERICS = enabled


def check_numerics(x: torch.Tensor, name: str = "value") -> torch.Tensor:
  """Identity that, when enabled, raises ``FloatingPointError`` if ``x``
  holds a NaN or an Inf (it then waits for the device to read one flag).
  Returns ``x`` so it can be used inline."""
  if _CHECK_NUMERICS and x.is_floating_point() and not bool(
      torch.isfinite(x).all()):
    raise FloatingPointError(f"[muax_tpu_torch] non-finite values in {name}")
  return x
