"""One host's process group in one call: ``spawn_group`` starts one process
per rank through ``torch.multiprocessing.start_processes`` with the
``spawn`` method (safe after the parent touched CUDA), gives them a
``file://`` rendezvous in a fresh temporary directory, and collects what
each rank's function returns. A rank that fails has the others stopped by
``ProcessContext.join``; a group that outlives its timeout has every
process killed, so a hung collective cannot hold the caller. Multi-host
runs start one process per rank themselves (``multihost.py``).
"""
from __future__ import annotations

import os
import tempfile
import time

import torch.multiprocessing as mp


def _entry(rank, fn, world_size, init_method, results, args):
  results.put((rank, fn(rank, world_size, init_method, *args)))


def _drain(results, out):
  while not results.empty():
    rank, value = results.get()
    out[rank] = value


def spawn_group(fn, world_size: int, args=(), timeout: float = 180.0):
  """Run ``fn(rank, world_size, init_method, *args)`` in ``world_size``
  spawned processes and return their results in rank order. ``fn`` must be
  importable by name (a module's top-level function) and return something
  picklable without CUDA tensors; ``init_method`` is the group's
  ``file://`` rendezvous for ``torch.distributed.init_process_group``.

  Raises ``torch.multiprocessing.ProcessRaisedException`` with the failing
  rank's traceback when a rank raises (``ProcessExitedException`` when it
  dies), and ``TimeoutError`` when the group has not finished within
  ``timeout`` seconds; either way no process of the group is left
  running."""
  results = mp.get_context("spawn").SimpleQueue()
  out = {}
  with tempfile.TemporaryDirectory(prefix="spawn_group_") as tmp:
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    group = mp.start_processes(
        _entry, (fn, world_size, init_method, results, tuple(args)),
        nprocs=world_size, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
      # Drain while waiting: a rank's put blocks once the pipe is full.
      while not group.join(timeout=1.0, grace_period=5.0):
        _drain(results, out)
        if time.monotonic() > deadline:
          raise TimeoutError(
              f"process group of {world_size} did not finish within "
              f"{timeout} s (ranks done: {sorted(out)})")
    finally:
      for p in group.processes:
        if p.is_alive():
          p.kill()
        p.join()
  _drain(results, out)
  return [out[r] for r in range(world_size)]
