"""Host-side episode tracers and trajectory replay
(``muax_tpu/replay/tracer.py``), in numpy.

The on-device ring (``replay/buffer.py``) is the performance path; these
classes serve host-driven workflows (one env stepped by hand, notebook
loops):

  * ``NStep`` / ``PNStep`` — short-horizon caches computing the n-step
    bootstrapped return Rn at pop, PNStep adding the PER weight |v-Rn|^alpha
    (reference muax/episode_tracer.py:114-249),
  * ``Trajectory`` — an episode of transitions, ``finalize()`` transposing to
    one batched [1, T, ...] Transition (muax/replay_buffer.py:61-70),
  * ``TrajectoryReplayBuffer`` — ring of trajectories with two-level weighted
    window sampling to [B, L, ...] (muax/replay_buffer.py:154-240).

Everything stays numpy on the host, with the JAX package's
``np.random.RandomState(seed)`` draws in the same order, so a sample is the
JAX one bit for bit; ``Transition`` is the port's, with numpy fields, which
the agents' ``update`` moves to the device.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Deque, List, Optional

import numpy as np

from muax_tpu_torch.types import Transition


@dataclass
class Step:
  obs: np.ndarray
  action: int
  reward: float
  done: bool
  value: float = 0.0
  pi: Optional[np.ndarray] = None
  rn: float = 0.0
  weight: float = 1.0


class NStep:
  """n-step bootstrapped-return cache: Rn = sum gamma^i r_i + gamma^n v."""

  def __init__(self, n: int = 10, discount: float = 0.997):
    self.n = n
    self.discount = discount
    self._deque: Deque[Step] = collections.deque()
    self._done_seen = False

  def reset(self):
    self._deque.clear()
    self._done_seen = False

  def add(self, obs, action, reward, done, value=0.0, pi=None):
    self._deque.append(Step(obs=np.asarray(obs), action=int(action),
                            reward=float(reward), done=bool(done),
                            value=float(value),
                            pi=None if pi is None else np.asarray(pi)))
    if done:
      self._done_seen = True

  def __bool__(self):
    """Poppable when the window is full or the episode has terminated."""
    return bool(self._deque) and (len(self._deque) > self.n
                                  or self._done_seen)

  def __len__(self):
    return len(self._deque)

  def _compute_rn(self) -> float:
    rn = 0.0
    discount = 1.0
    steps = list(self._deque)
    horizon = min(self.n, len(steps))
    for i in range(horizon):
      rn += discount * steps[i].reward
      discount *= self.discount
      if steps[i].done:
        return rn
    if len(steps) > self.n:
      rn += discount * steps[self.n].value
    return rn

  def pop(self) -> Step:
    step = self._deque[0]
    step.rn = self._compute_rn()
    self._deque.popleft()
    if not self._deque:
      self._done_seen = False
    return step


class PNStep(NStep):
  """NStep + prioritized weight w = |v - Rn|^alpha
  (muax/episode_tracer.py:197-249)."""

  def __init__(self, n: int = 10, discount: float = 0.997,
               alpha: float = 0.5):
    super().__init__(n, discount)
    self.alpha = alpha

  def pop(self) -> Step:
    step = super().pop()
    step.weight = float(np.abs(step.value - step.rn) ** self.alpha) + 1e-6
    return step


class Trajectory:
  """One episode of popped steps; finalize() -> [1, T, ...] Transition."""

  def __init__(self):
    self.steps: List[Step] = []

  def add(self, step: Step):
    self.steps.append(step)

  def __len__(self):
    return len(self.steps)

  @property
  def batched_transitions(self) -> Transition:
    return self.finalize()

  def finalize(self) -> Transition:
    if not self.steps:
      raise ValueError("empty trajectory")
    num_actions = (len(self.steps[0].pi)
                   if self.steps[0].pi is not None else 1)
    T = len(self.steps)
    return Transition(
        obs=np.stack([s.obs for s in self.steps])[None],
        action=np.asarray([s.action for s in self.steps], np.int32)[None],
        reward=np.asarray([s.reward for s in self.steps], np.float32)[None],
        done=np.asarray([s.done for s in self.steps], bool)[None],
        rn=np.asarray([s.rn for s in self.steps], np.float32)[None],
        value=np.asarray([s.value for s in self.steps], np.float32)[None],
        pi=np.stack([
            s.pi if s.pi is not None else np.zeros(num_actions)
            for s in self.steps]).astype(np.float32)[None],
        weight=np.asarray([np.mean([s.weight for s in self.steps])],
                          np.float32),
        mask=np.ones((1, T), np.float32),
    )


class TrajectoryReplayBuffer:
  """Ring of finalized trajectories with two-level weighted sampling
  (muax/replay_buffer.py:154-240 semantics, numpy implementation)."""

  def __init__(self, capacity: int = 500, seed: int = 0,
               window_alpha: float = 0.5):
    self.capacity = capacity
    self.window_alpha = window_alpha
    self._trajectories: Deque[Transition] = collections.deque(
        maxlen=capacity)
    self._weights: Deque[float] = collections.deque(maxlen=capacity)
    self._rng = np.random.RandomState(seed)

  def add(self, trajectory, weight: Optional[float] = None):
    t = (trajectory.finalize() if isinstance(trajectory, Trajectory)
         else trajectory)
    self._trajectories.append(t)
    self._weights.append(float(weight if weight is not None
                               else np.mean(t.weight)))

  def __len__(self):
    return len(self._trajectories)

  def sample(self, num_trajectory: int, sample_per_trajectory: int = 1,
             k_steps: int = 10) -> Transition:
    """[num_trajectory * sample_per_trajectory, k_steps, ...] batch."""
    if not self._trajectories:
      raise ValueError("buffer is empty")
    weights = np.asarray(self._weights, np.float64)
    probs = weights / weights.sum()
    traj_ids = self._rng.choice(len(self._trajectories),
                                size=num_trajectory, p=probs)
    batches = []
    for tid in traj_ids:
      traj = self._trajectories[tid]
      T = traj.action.shape[1]
      starts_max = max(T - k_steps, 0)
      # Within-trajectory WEIGHTED window starts (the reference's second
      # sampling level, muax/replay_buffer.py:73-110): start t drawn with
      # probability ∝ |v_t - Rn_t|^alpha, uniform when priorities vanish.
      step_prio = np.abs(
          np.asarray(traj.value)[0, :starts_max + 1]
          - np.asarray(traj.rn)[0, :starts_max + 1]) ** self.window_alpha
      total = step_prio.sum()
      start_probs = (step_prio / total if total > 0
                     else np.full(starts_max + 1, 1.0 / (starts_max + 1)))
      for _ in range(sample_per_trajectory):
        start = self._rng.choice(starts_max + 1, p=start_probs)
        end = start + k_steps
        sliced = {}
        for name in ("obs", "action", "reward", "done", "rn", "value",
                     "pi", "mask"):
          arr = np.asarray(getattr(traj, name))[0]
          window = arr[start:min(end, T)]
          if window.shape[0] < k_steps:  # pad at episode end
            pad = k_steps - window.shape[0]
            pad_block = np.repeat(window[-1:], pad, axis=0)
            if name == "mask":
              pad_block = np.zeros_like(pad_block)
            window = np.concatenate([window, pad_block], 0)
          sliced[name] = window
        if T < k_steps or end > T:
          sliced["mask"] = sliced["mask"].copy()
          sliced["mask"][min(T - start, k_steps):] = 0.0
        batches.append(Transition(weight=np.asarray(
            self._weights[tid], np.float32), **sliced))
    return Transition(*[np.stack([getattr(b, f) for b in batches])
                        for f in Transition.__dataclass_fields__])
