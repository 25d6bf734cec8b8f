"""Fused replay sampling: window-start draw and window extraction as one
kernel (``muax_tpu/replay/fused_sampler.py``, both modes).

For each of W windows, given its segment (drawn outside by
``draw_segments``, the level-1 draw of ``replay_sample``) and a column of
Gumbel noise (drawn outside, so no generator lives in the kernel), it picks
the start as the Gumbel-argmax over ``log(prio + 1e-9)`` of the valid starts
(ties to the first), and writes the window as ``RawLayout`` rows of a
[R, W] f32 tensor: the start observation, per-step actions, rewards, n-step
returns, step-major policy targets, the validity mask, and the start, the
start-step priority, the mask denominator and the segment's target step.
That is what the fused learner kernel reads. With ``per_step_obs=True`` the
observation rows hold the observation at every window step (row
``f * K + j`` is feature f of step j), from which the learner rebuilds a
[B, K, ...] ``Transition`` for the families without a learner kernel (the
hybrid feed); every other row is the same.

On a CUDA tensor ``fused_sample_group`` launches the hand-written kernel
``csrc/fused_sampler.cu``; on a CPU tensor it runs
``fused_sample_group_reference``, its plain PyTorch version. The kernel
reads the ring in its own [C, L, ...] layout by direct indexing: the JAX
package's ``transpose_ring`` and one-hot matmul gather exist only because
XLA's gather was slow on the TPU, and have no counterpart here. The ring's
observations may be f32 or uint8 (pixel frames); the kernel converts each
element to f32 as it writes it, as the plain version's assignment does.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from muax_tpu_torch import _build
from muax_tpu_torch.replay.buffer import (ReplayState, _window_validity_mask,
                                          draw_level1, segments_from_draws)

# Launches of the CUDA kernel; the plain version does not count.
launches = 0


class RawLayout(NamedTuple):
  """Static row offsets into the [R, W] raw output."""
  O: int            # obs feature rows
  K: int            # unroll steps
  A: int            # actions (pi rows = K * A, step-major)
  obs: int          # rows [obs : obs+obs_rows]
  action: int       # rows [action : action+K]
  reward: int
  rn: int
  pi: int           # rows [pi : pi + K*A], row j*A + a
  mask: int
  start: int        # 1 row
  weight: int       # 1 row — start-step priority (unnormalized)
  denom: int        # 1 row — max(sum(mask), 1)
  tstep: int        # 1 row — segment target_step (staleness ledger)
  rows: int         # total (padded to a multiple of 8)
  # per_step_obs=False: obs rows carry only the WINDOW-START observation
  # (row f) — what the raw-input learner kernel consumes. True: obs at
  # EVERY window step (row f*K + j) so a full [B, K, obs] Transition can
  # be reconstructed — the hybrid path feeding families without a raw
  # kernel (stochastic 5-net, fc-resnet) from the fused sampler.
  per_step_obs: bool = False
  obs_rows: int = 0


def make_raw_layout(obs_features: int, k_steps: int, num_actions: int,
                    per_step_obs: bool = False) -> RawLayout:
  O, K, A = obs_features, k_steps, num_actions
  obs_rows = O * K if per_step_obs else O
  obs = 0
  action = obs + obs_rows
  reward = action + K
  rn = reward + K
  pi = rn + K
  mask = pi + K * A
  start = mask + K
  weight = start + 1
  denom = weight + 1
  tstep = denom + 1
  rows = tstep + 1
  rows = ((rows + 7) // 8) * 8
  return RawLayout(O=O, K=K, A=A, obs=obs, action=action, reward=reward,
                   rn=rn, pi=pi, mask=mask, start=start, weight=weight,
                   denom=denom, tstep=tstep, rows=rows,
                   per_step_obs=per_step_obs, obs_rows=obs_rows)


def draw_segments(state: ReplayState, generator: torch.Generator, num: int,
                  offline_fraction: float = 1.0,
                  online_queue_size: int = 0) -> torch.Tensor:
  """Level-1 segment draw, the same logic as ``replay_sample``'s first
  stage (priority CDF plus the online-queue tail). int64 [num]."""
  uniforms, offsets = draw_level1(state, generator, num, offline_fraction,
                                  online_queue_size)
  return segments_from_draws(state, uniforms, offsets)


def _layout_of(state: ReplayState, k_steps: int,
               per_step_obs: bool = False) -> RawLayout:
  obs_features = 1
  for d in state.obs.shape[2:]:
    obs_features *= d
  return make_raw_layout(obs_features, k_steps, state.pi.shape[-1],
                         per_step_obs)


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def fused_sample_group_reference(state: ReplayState, seg_idx: torch.Tensor,
                                 gumbel: torch.Tensor, k_steps: int,
                                 per_step_obs: bool = False):
  """Plain PyTorch version of the fused sampler. Returns ([R, W] raw,
  layout)."""
  lay = _layout_of(state, k_steps, per_step_obs)
  L, K = state.segment_length, k_steps
  num_starts = L - K + 1
  W = seg_idx.shape[0]
  dev = state.action.device
  seg = seg_idx.long()

  prios = state.step_priorities[seg]                           # [W, L]
  logits = torch.log(prios[:, :num_starts] + 1e-9) + gumbel[:num_starts].T
  start = torch.argmax(logits, -1)                             # first max
  t = start[:, None] + torch.arange(K, device=dev)[None, :]
  rows = seg[:, None]
  mask = _window_validity_mask(state.done[rows, t])

  raw = torch.zeros((lay.rows, W), dtype=torch.float32, device=dev)
  if per_step_obs:  # row f*K + j: feature f of step j
    raw[lay.obs:lay.obs + lay.obs_rows] = state.obs[rows, t].reshape(
        W, K, lay.O).permute(2, 1, 0).reshape(lay.obs_rows, W)
  else:
    raw[lay.obs:lay.obs + lay.O] = state.obs[seg, start].reshape(W, -1).T
  raw[lay.action:lay.action + K] = state.action[rows, t].T.float()
  raw[lay.reward:lay.reward + K] = state.reward[rows, t].T
  raw[lay.rn:lay.rn + K] = state.rn[rows, t].T
  raw[lay.pi:lay.pi + K * lay.A] = state.pi[rows, t].reshape(W, -1).T
  raw[lay.mask:lay.mask + K] = mask.T
  raw[lay.start] = start.float()
  raw[lay.weight] = prios[torch.arange(W, device=dev), start]
  raw[lay.denom] = torch.clamp(mask.sum(1), min=1.0)
  raw[lay.tstep] = state.target_step[seg].float()
  return raw, lay


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


def _load_kernel():
  lib = _build.load("fused_sampler")
  fn = lib.mz_fused_sample_group
  if fn.argtypes is None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr, i32] + [ptr] * 10 + [i32] * 6 + [i32] * 12 + [ptr]
    fn.restype = i32
    lib.mz_sampler_error_string.argtypes = [i32]
    lib.mz_sampler_error_string.restype = ctypes.c_char_p
  return lib


# The kernel's observation types (the C entry point's obs_dtype).
_OBS_DTYPES = {torch.float32: 0, torch.uint8: 1}


def _check(name: str, t: torch.Tensor, dtypes, shape, device):
  dtypes = dtypes if isinstance(dtypes, tuple) else (dtypes,)
  if t.device != device or t.dtype not in dtypes:
    raise ValueError(f"{name}: expected {' or '.join(map(str, dtypes))} on "
                     f"{device}, got {t.dtype} on {t.device}")
  if tuple(t.shape) != tuple(shape):
    raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                     f"{tuple(t.shape)}")
  if not t.is_contiguous():
    raise ValueError(f"{name}: expected a contiguous tensor")


def _sample_cuda(state: ReplayState, seg_idx: torch.Tensor,
                 gumbel: torch.Tensor, k_steps: int, per_step_obs: bool):
  global launches
  lay = _layout_of(state, k_steps, per_step_obs)
  dev = state.action.device
  C, L, K, O, A = state.capacity, state.segment_length, k_steps, lay.O, lay.A
  W = seg_idx.shape[0]
  if not 1 <= K <= L:
    raise ValueError(f"unroll {K} does not fit segments of length {L}")
  f32 = torch.float32
  # A uint8 ring (pixel frames) is read as bytes by the kernel itself.
  _check("obs", state.obs, tuple(_OBS_DTYPES),
         (C, L) + tuple(state.obs.shape[2:]), dev)
  _check("action", state.action, torch.int32, (C, L), dev)
  _check("reward", state.reward, f32, (C, L), dev)
  _check("rn", state.rn, f32, (C, L), dev)
  _check("pi", state.pi, f32, (C, L, A), dev)
  _check("done", state.done, torch.bool, (C, L), dev)
  _check("step_priorities", state.step_priorities, f32, (C, L), dev)
  _check("target_step", state.target_step, torch.int32, (C,), dev)
  _check("seg_idx", seg_idx, torch.int64, (W,), dev)
  _check("gumbel", gumbel, f32, (L, W), dev)

  raw = torch.empty((lay.rows, W), dtype=f32, device=dev)
  lib = _load_kernel()
  err = lib.mz_fused_sample_group(
      state.obs.data_ptr(), _OBS_DTYPES[state.obs.dtype],
      state.action.data_ptr(), state.reward.data_ptr(),
      state.rn.data_ptr(), state.pi.data_ptr(), state.done.data_ptr(),
      state.step_priorities.data_ptr(), state.target_step.data_ptr(),
      seg_idx.data_ptr(), gumbel.data_ptr(), raw.data_ptr(),
      C, L, O, A, K, W,
      int(per_step_obs), lay.obs, lay.action, lay.reward, lay.rn, lay.pi,
      lay.mask, lay.start, lay.weight, lay.denom, lay.tstep, lay.rows,
      torch.cuda.current_stream(dev).cuda_stream)
  if err != 0:
    raise RuntimeError("fused sampler kernel: "
                       + lib.mz_sampler_error_string(err).decode())
  launches += 1
  return raw, lay


def fused_sample_group(state: ReplayState, seg_idx: torch.Tensor,
                       gumbel: torch.Tensor, k_steps: int,
                       per_step_obs: bool = False):
  """Start draw and extraction of W windows; returns ([R, W] raw, layout).

  ``seg_idx`` [W] int64 from ``draw_segments``, values in [0, capacity);
  ``gumbel`` [L, W] f32. The ring's live ``step_priorities`` and
  ``target_step`` are read at the call. ``per_step_obs`` writes the
  observation of every window step, not only the start's. CUDA tensors go
  to the kernel (or the call raises); CPU tensors go to the plain version.
  """
  if state.action.device.type == "cuda":
    return _sample_cuda(state, seg_idx, gumbel, k_steps, per_step_obs)
  if state.action.device.type == "cpu":
    return fused_sample_group_reference(state, seg_idx, gumbel, k_steps,
                                        per_step_obs)
  raise ValueError(f"no fused sampler for device {state.action.device}")
