"""Device selection for the port's entry points, and the card's limits
that the kernels' launch plans size by."""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from muax_tpu_torch import _build


def resolve_device(device) -> torch.device:
  """``device`` as a ``torch.device``; raises when CUDA is asked for and absent.

  Nothing falls back to the CPU on its own: a caller that wants the CPU
  passes ``device="cpu"``. A bare ``"cuda"`` becomes the current card
  (``cuda:<index>``), so it compares equal to the device of the tensors made
  there.
  """
  device = torch.device(device)
  if device.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError(
        "CUDA is not available: muax_tpu_torch runs on the GPU by default; "
        "pass device='cpu' to run on the CPU")
  if device.type == "cuda" and device.index is None:
    device = torch.device("cuda", torch.cuda.current_device())
  return device


class DeviceLimits(NamedTuple):
  """What a card offers the kernels: SMs, shared memory in bytes per SM,
  per block (opt-in) and reserved per block, and registers per SM."""
  sms: int
  smem_per_sm: int
  smem_per_block: int
  smem_reserved: int
  regs_per_sm: int = 65536


def device_limits(device: torch.device) -> DeviceLimits:
  """The card's ``DeviceLimits``, read once per card with the CUDA
  runtime."""
  index = device.index if device.index is not None else (
      torch.cuda.current_device())
  return _device_limits(index)


@functools.lru_cache(maxsize=None)
def _device_limits(index: int) -> DeviceLimits:
  # csrc/fused_search.cu holds the query (``mz_device_limits``).
  lib = _build.load("fused_search")
  lib.mz_device_limits.argtypes = [ctypes.c_int, ctypes.c_void_p]
  lib.mz_device_limits.restype = ctypes.c_int
  lib.mz_error_string.argtypes = [ctypes.c_int]
  lib.mz_error_string.restype = ctypes.c_char_p
  out = (ctypes.c_int * 5)()
  err = lib.mz_device_limits(index, out)
  if err != 0:
    raise RuntimeError("device limits: " + lib.mz_error_string(err).decode())
  return DeviceLimits(*out)
