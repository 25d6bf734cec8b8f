"""Host-side training monitor and tensorboard logging
(``muax_tpu/monitor.py``, plain Python, kept as the port's own copy).

The reference's ``TrainMonitor`` gym wrapper (muax/wrappers.py:131-440)
adapted to the vectorized training loop: episode and step counters, smoothed
metric averaging, terminal logging, tensorboard scalars, and counter
save/load. The tensorboard writer (torch's ``SummaryWriter``, which needs
the tensorboard package) is imported only when a directory is given;
counters persist through gzip and pickle.
"""
from __future__ import annotations

import gzip
import os
import pickle
import time
from collections import deque
from typing import Optional

import numpy as np


class StreamingSample:
  """Reservoir sampler over a stream (parity: muax/wrappers.py:98-128) —
  keeps a uniform random sample of the values seen so far in O(maxlen)."""

  def __init__(self, maxlen: int, seed: int = 0):
    self.maxlen = maxlen
    self._rng = np.random.RandomState(seed)
    self._sample: list = []
    self._count = 0

  def reset(self):
    self._sample = []
    self._count = 0

  def append(self, value):
    self._count += 1
    if len(self._sample) < self.maxlen:
      self._sample.append(value)
    else:
      j = self._rng.randint(self._count)
      if j < self.maxlen:
        self._sample[j] = value

  def extend(self, values):
    for v in values:
      self.append(v)

  @property
  def values(self) -> list:
    return list(self._sample)

  def __len__(self):
    return len(self._sample)


class TrainMonitor:
  """Accumulates training counters/metrics and optionally writes
  tensorboard scalars. Metric names match the reference (`ep`, `T`, `G`,
  `avg_G`, `dt_ms`, plus anything recorded via record_metrics)."""

  def __init__(self, tensorboard_dir: Optional[str] = None,
               smoothing: int = 10):
    self.T = 0             # total env steps
    self.ep = 0            # total episodes
    self.t = 0             # steps in current reporting window
    self.G = 0.0           # last episode return
    self._recent_G = deque(maxlen=smoothing)
    self._metrics: dict[str, tuple[float, int]] = {}
    self._last_time = time.time()
    self._writer = None
    if tensorboard_dir is not None:
      from torch.utils.tensorboard import SummaryWriter
      self._writer = SummaryWriter(tensorboard_dir)

  @property
  def avg_G(self) -> float:
    return float(np.mean(self._recent_G)) if self._recent_G else 0.0

  @property
  def dt_ms(self) -> float:
    if self.t == 0:
      return 0.0
    return 1000.0 * (time.time() - self._last_time) / self.t

  def record_metrics(self, metrics: dict):
    """Accumulate averaged metrics until the next flush (the reference's
    smoothed metric reduction, wrappers.py:259-293)."""
    for name, value in metrics.items():
      total, count = self._metrics.get(name, (0.0, 0))
      self._metrics[name] = (total + float(value), count + 1)

  def observe_rollout(self, num_steps: int, episodes_finished: int,
                      mean_episode_return: float):
    self.T += int(num_steps)
    self.t += int(num_steps)
    finished = int(episodes_finished)
    if finished > 0:
      self.ep += finished
      self.G = float(mean_episode_return)
      self._recent_G.append(self.G)

  def flush(self, step: Optional[int] = None) -> dict:
    """Average accumulated metrics, write tensorboard, reset the window."""
    step = self.T if step is None else step
    out = {name: total / max(count, 1)
           for name, (total, count) in self._metrics.items()}
    out.update(T=self.T, ep=self.ep, G=self.G, avg_G=self.avg_G,
               dt_ms=self.dt_ms)
    if self._writer is not None:
      for name, value in out.items():
        self._writer.add_scalar(name, value, global_step=step)
      self._writer.flush()
    self._metrics.clear()
    self.t = 0
    self._last_time = time.time()
    return out

  def add_histogram(self, name: str, values, step: Optional[int] = None):
    if self._writer is not None:
      self._writer.add_histogram(name, np.asarray(values),
                                 global_step=step or self.T)

  # -- counter persistence (wrappers.py:416-440) ---------------------------
  def save_counters(self, path: str):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    state = {"T": self.T, "ep": self.ep, "G": self.G,
             "recent_G": list(self._recent_G)}
    with gzip.open(path, "wb") as f:
      pickle.dump(state, f)

  def load_counters(self, path: str):
    with gzip.open(path, "rb") as f:
      state = pickle.load(f)
    self.T = state["T"]
    self.ep = state["ep"]
    self.G = state["G"]
    self._recent_G.extend(state["recent_G"])
    return self

  def close(self):
    if self._writer is not None:
      self._writer.close()
