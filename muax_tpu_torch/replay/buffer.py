"""Prioritized trajectory replay on the device (``muax_tpu/replay/buffer.py``).

Storage is a ring of fixed-shape tensors ``[capacity, L, ...]`` on the
device. Sampling is two-level: a segment by its aggregate priority (inverse
CDF over the filled slots, optionally mixed with a uniform draw from the
newest segments), then a window start inside it by the Gumbel-argmax of its
log step priorities. Priorities are written at insert and refreshed in place
from the learner.

Unlike the JAX package, whose arrays are immutable, ``replay_add`` and
``replay_update_priorities`` update the ring in place and return it: the
ring is the largest state of the trainer and is never copied. The cursor
and the count of added segments are Python ints, so nothing waits on the
device to read them.

Every random draw comes from a ``torch.Generator`` on the ring's device; the
``*_from_draws`` functions take the draws as tensors, so the tests can feed
them the JAX package's draws.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from muax_tpu_torch.device import resolve_device
from muax_tpu_torch.types import Transition


@dataclasses.dataclass
class ReplayState:
  """Ring storage of trajectory segments. Tensors: [C, L, ...]."""
  obs: torch.Tensor
  action: torch.Tensor           # [C, L] int32
  reward: torch.Tensor
  done: torch.Tensor             # [C, L] bool
  rn: torch.Tensor
  value: torch.Tensor
  pi: torch.Tensor               # [C, L, A]
  step_priorities: torch.Tensor  # [C, L] f32 (already alpha-exponentiated)
  target_step: torch.Tensor      # [C] int32: learner step of the targets
  cursor: int = 0                # next write slot
  total_added: int = 0           # lifetime segments added

  @property
  def capacity(self) -> int:
    return self.action.shape[0]

  @property
  def segment_length(self) -> int:
    return self.action.shape[1]

  @property
  def size(self) -> int:
    return min(self.total_added, self.capacity)


def replay_init(capacity: int, segment_length: int,
                observation_shape: Tuple[int, ...], num_actions: int,
                obs_dtype=torch.float32, device="cuda") -> ReplayState:
  C, L = capacity, segment_length
  dev = resolve_device(device)

  def zeros(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device=dev)

  return ReplayState(
      obs=zeros((C, L) + tuple(observation_shape), obs_dtype),
      action=zeros((C, L), torch.int32),
      reward=zeros((C, L)),
      done=zeros((C, L), torch.bool),
      rn=zeros((C, L)),
      value=zeros((C, L)),
      pi=zeros((C, L, num_actions)),
      step_priorities=zeros((C, L)),
      target_step=zeros((C,), torch.int32),
  )


def replay_add(state: ReplayState, segments: Transition,
               step_priorities: torch.Tensor, step: int = 0) -> ReplayState:
  """Insert K segments ([K, L, ...]) at the cursor, wrapping around, in
  place. ``step`` stamps the targets' freshness into ``target_step``.

  With K > capacity only the newest ``capacity`` segments are kept, so that
  no slot is written twice. Priorities are floored at 1e-9 so the
  inverse-CDF draw never sees an all-zero filled region.
  """
  C = state.capacity
  k = segments.action.shape[0]
  if k > C:
    segments = Transition(**{f.name: getattr(segments, f.name)[-C:]
                             for f in dataclasses.fields(Transition)})
    step_priorities = step_priorities[-C:]
    k = C
  dev = state.action.device
  idx = (state.cursor + torch.arange(k, device=dev)) % C
  for name in ("obs", "action", "reward", "done", "rn", "value", "pi"):
    getattr(state, name)[idx] = getattr(segments, name).to(
        getattr(state, name).dtype)
  state.step_priorities[idx] = torch.clamp(step_priorities, min=1e-9)
  state.target_step[idx] = int(step)
  state.cursor = (state.cursor + k) % C
  state.total_added += k
  return state


def _window_validity_mask(done: torch.Tensor) -> torch.Tensor:
  """[B, K]: step t is valid iff no done strictly before t in the window."""
  d = done.to(torch.int32)
  return ((torch.cumsum(d, 1) - d) == 0).to(torch.float32)


def draw_level1(state: ReplayState, generator: torch.Generator, num: int,
                offline_fraction: float = 1.0, online_queue_size: int = 0):
  """The level-1 draws: ``num`` uniforms in [0, 1) and, when part of the
  draw comes from the online queue, its offsets back from the cursor
  (uniform in [1, min(online_queue_size, size)]); else None."""
  dev = state.action.device
  uniforms = torch.rand((num,), generator=generator, device=dev)
  num_online = num - int(round(num * offline_fraction))
  offsets = None
  if num_online > 0 and online_queue_size > 0:
    window = max(min(online_queue_size, state.size), 1)
    offsets = torch.randint(1, window + 1, (num_online,), generator=generator,
                            device=dev)
  return uniforms, offsets


def segments_from_draws(state: ReplayState, uniforms: torch.Tensor,
                        offsets: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
  """Level 1 from given draws: the segment whose cumulative priority bin
  holds ``u * total`` (filled slots only), then the online-queue rows, last,
  as ``cursor - offset``. Returns int64 [num]."""
  C = state.capacity
  dev = state.action.device
  filled = torch.arange(C, device=dev) < state.size
  seg_weights = torch.where(filled, torch.sum(state.step_priorities, 1),
                            torch.zeros((), device=dev))
  cdf = torch.cumsum(seg_weights, 0)
  u = uniforms * cdf[-1]
  # searchsorted(side='right') is the count of cdf entries <= u, as the
  # JAX package's compare-and-count computes it.
  seg_idx = torch.searchsorted(cdf, u, right=True).clamp(max=C - 1)
  if offsets is not None:
    seg_idx[len(seg_idx) - len(offsets):] = (state.cursor - offsets) % C
  return seg_idx


def replay_sample_from_draws(state: ReplayState, uniforms: torch.Tensor,
                             gumbel: torch.Tensor,
                             offsets: Optional[torch.Tensor],
                             k_steps: int):
  """``replay_sample`` on given draws: ``uniforms`` [B], ``gumbel`` [B, L]
  and the online ``offsets`` (or None)."""
  L = state.segment_length
  num_starts = L - k_steps + 1
  dev = state.action.device
  seg_idx = segments_from_draws(state, uniforms, offsets)

  row_prios = state.step_priorities[seg_idx]                 # [B, L]
  valid = torch.arange(L, device=dev) < num_starts
  start_logits = torch.where(valid, torch.log(row_prios + 1e-9),
                             torch.full((), -torch.inf, device=dev))
  starts = torch.argmax(start_logits + gumbel, -1)           # first maximum

  window_t = starts[:, None] + torch.arange(k_steps, device=dev)[None, :]
  rows = seg_idx[:, None]

  def gather(arr):
    return arr[rows, window_t]

  done = gather(state.done)
  weight = gather(state.step_priorities)[:, 0]
  weight = weight / torch.clamp(torch.mean(weight), min=1e-9)
  batch = Transition(
      obs=gather(state.obs),
      action=gather(state.action),
      reward=gather(state.reward),
      done=done,
      rn=gather(state.rn),
      value=gather(state.value),
      pi=gather(state.pi),
      weight=weight,
      mask=_window_validity_mask(done),
  )
  return batch, seg_idx, starts


def gumbel_noise(generator: torch.Generator, shape, device) -> torch.Tensor:
  """Standard Gumbel noise, -log(-log(U)) with U in [tiny, 1)."""
  tiny = torch.finfo(torch.float32).tiny
  u = torch.rand(shape, generator=generator, device=device).clamp(min=tiny)
  return -torch.log(-torch.log(u))


def replay_sample(state: ReplayState, generator: torch.Generator,
                  batch_size: int, k_steps: int,
                  offline_fraction: float = 1.0, online_queue_size: int = 0):
  """Two-level weighted sample of [batch_size, k_steps] windows. Returns
  (batch, segment_indices, window_starts); the indices let the learner
  refresh priorities in place afterwards.

  ``offline_fraction`` < 1 draws the last
  ``batch_size - round(batch_size * offline_fraction)`` rows uniformly from
  the ``online_queue_size`` newest segments (the reference's two-table mix).
  """
  uniforms, offsets = draw_level1(state, generator, batch_size,
                                  offline_fraction, online_queue_size)
  gumbel = gumbel_noise(generator, (batch_size, state.segment_length),
                        state.action.device)
  return replay_sample_from_draws(state, uniforms, gumbel, offsets, k_steps)


def last_writers(keys: torch.Tensor, size: int) -> torch.Tensor:
  """For each position i of ``keys`` (int64 in [0, size)), the last
  position j with ``keys[j] == keys[i]``.

  A scatter of rows at repeated indices keeps, on the CPU, the row written
  last in index order, and on the card whichever thread lands last. Writing
  ``rows[last_writers(keys, size)]`` instead gives every copy of a slot the
  same row, the last one, so the result is that of the CPU on any device.
  The positions are reduced by an integer max, which is exact."""
  pos = torch.arange(keys.numel(), device=keys.device)
  last = torch.zeros(size, dtype=torch.int64, device=keys.device)
  last.scatter_reduce_(0, keys, pos, reduce="amax", include_self=False)
  return last[keys]


def replay_update_priorities(state: ReplayState, seg_idx: torch.Tensor,
                             starts: torch.Tensor,
                             new_priorities: torch.Tensor) -> ReplayState:
  """Refresh the sampled windows' start-step priorities in place, floored
  at 1e-9. A window drawn more than once gets the value of its last
  occurrence in index order, on every device (the JAX package leaves the
  winner unspecified; any fixed one is its semantics)."""
  L = state.segment_length
  prios = torch.clamp(new_priorities, min=1e-9)
  winners = last_writers(seg_idx * L + starts, state.capacity * L)
  state.step_priorities[seg_idx, starts] = prios[winners]
  return state
