"""Profiling hooks (``muax_tpu/utils/profiling.py``).

``step_annotation`` names a region in a profiler trace, as the JAX
package's ``StepTraceAnnotation`` does (``torch.profiler.record_function``:
``with step_annotation("update"): ...``); ``trace`` records the enclosed
block with ``torch.profiler`` and writes a Chrome trace (viewable in
Perfetto or ``chrome://tracing``; no tensorboard package needed);
``Stopwatch`` keeps wall-clock phase timings with running means.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity

step_annotation = torch.profiler.record_function


@contextlib.contextmanager
def trace(log_dir: str):
  """Capture a trace of the enclosed block, the card's kernels too where
  there is a card: ``with profiling.trace("traces"): run_iterations()``
  writes ``traces/trace_<pid>_<ns>.json``. Yields the profiler."""
  os.makedirs(log_dir, exist_ok=True)
  activities = [ProfilerActivity.CPU]
  if torch.cuda.is_available():
    activities.append(ProfilerActivity.CUDA)
  prof = torch.profiler.profile(activities=activities)
  prof.start()
  try:
    yield prof
  finally:
    prof.stop()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class Stopwatch:
  """Wall-clock phase timing (rollout/update/eval) with running means."""

  def __init__(self):
    self.totals: dict[str, float] = {}
    self.counts: dict[str, int] = {}

  @contextlib.contextmanager
  def time(self, name: str):
    t0 = time.perf_counter()
    try:
      yield
    finally:
      dt = time.perf_counter() - t0
      self.totals[name] = self.totals.get(name, 0.0) + dt
      self.counts[name] = self.counts.get(name, 0) + 1

  def means_ms(self) -> dict[str, float]:
    return {k: 1000.0 * self.totals[k] / max(self.counts[k], 1)
            for k in self.totals}
