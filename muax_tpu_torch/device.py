"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


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
