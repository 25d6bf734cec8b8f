"""Numerics guards (``muax_tpu/utils/debug.py``): a NaN/Inf check on the
learner's gradients that costs nothing unless it is turned on, an eager
finiteness assertion for tests and scripts, and ``nan_guard``, a scope that
turns on every check the port has."""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch

_CHECK_NUMERICS = False


def set_check_numerics(enabled: bool) -> None:
  """Turn the ``check_numerics`` guard on or off for the whole process."""
  global _CHECK_NUMERICS
  _CHECK_NUMERICS = enabled


def check_numerics_enabled() -> bool:
  return _CHECK_NUMERICS


def check_numerics(x: torch.Tensor, name: str = "value") -> torch.Tensor:
  """Identity that, when enabled, raises ``FloatingPointError`` if ``x``
  holds a NaN or an Inf (it then waits for the device to read one flag).
  Returns ``x`` so it can be used inline."""
  if _CHECK_NUMERICS and x.is_floating_point() and not bool(
      torch.isfinite(x).all()):
    raise FloatingPointError(f"[muax_tpu_torch] non-finite values in {name}")
  return x


@contextlib.contextmanager
def nan_guard():
  """Within this scope ``check_numerics`` raises on a NaN or an Inf, and
  autograd's anomaly mode names the forward op whose backward made a NaN.
  Both settings are restored on exit."""
  prev_check, prev_anomaly = _CHECK_NUMERICS, torch.is_anomaly_enabled()
  set_check_numerics(True)
  torch.autograd.set_detect_anomaly(True)
  try:
    yield
  finally:
    set_check_numerics(prev_check)
    torch.autograd.set_detect_anomaly(prev_anomaly)


def _leaves(tree: Any, path: str):
  """(path, tensor) for every tensor of a tensor, a module's parameters and
  buffers, or a dict, list, tuple or dataclass of them."""
  if isinstance(tree, torch.Tensor):
    yield path, tree
  elif isinstance(tree, torch.nn.Module):
    for name, t in tree.state_dict(keep_vars=True).items():
      yield f"{path}.{name}", t
  elif isinstance(tree, dict):
    for k, v in tree.items():
      yield from _leaves(v, f"{path}[{k!r}]")
  elif isinstance(tree, (list, tuple)):
    for i, v in enumerate(tree):
      yield from _leaves(v, f"{path}[{i}]")
  elif dataclasses.is_dataclass(tree):
    for f in dataclasses.fields(tree):
      yield from _leaves(getattr(tree, f.name), f"{path}.{f.name}")


def assert_finite(tree: Any, name: str = "value") -> None:
  """Eager assertion that every floating tensor of ``tree`` (a tensor, a
  module's parameters and buffers, or a nested dict, list, tuple or
  dataclass) is finite; raises ``FloatingPointError`` naming the first
  that is not."""
  for path, t in _leaves(tree, name):
    if t.is_floating_point() and not bool(torch.isfinite(t).all()):
      raise FloatingPointError(f"non-finite values in {path}")
