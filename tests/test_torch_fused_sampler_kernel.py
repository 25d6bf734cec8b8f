"""The fused sampler's CUDA kernel against its plain PyTorch version, on the
card. Every test here needs a CUDA card (and ``nvcc`` to build the kernel)
and skips without one; the file imports nothing of the JAX package:

  python -m pytest tests/test_torch_fused_sampler_kernel.py -m gpu -q

Where the kernel and the plain version pick the same start, every raw row
must be exactly equal (both copy the same values); ``logf`` and
``torch.log`` may differ by an ulp, so a near-tie may pick another start,
on at most 0.01 % of windows. Batches that end inside a block, segments
outside the ring (all-zero windows) and windows longer than a group of 8
lanes (K = 12) are covered, in both modes. A uint8 ring (pixel frames,
50 features) is read by the kernel itself: its raw rows equal the plain
version's where the start agrees, and equal bit for bit the kernel's rows
of the same ring cast to f32.
"""
import dataclasses

import pytest
import torch

from muax_tpu_torch.replay import fused_sampler, replay_add, replay_init
from muax_tpu_torch.replay.buffer import gumbel_noise
from muax_tpu_torch.types import Transition

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the kernel has no CPU mode")
  return torch.device("cuda", torch.cuda.current_device())


def _ring(device, C, L, A, filled, seed=0, frame=None):
  """A seeded ring: 4 f32 features, or uint8 frames of shape ``frame``."""
  gen = torch.Generator(device=device).manual_seed(seed)

  def rand(*shape):
    return torch.rand(shape, generator=gen, device=device)

  if frame is None:
    state = replay_init(C, L, (4,), A, device=device)
    obs = torch.randn((filled, L, 4), generator=gen, device=device)
  else:
    state = replay_init(C, L, frame, A, obs_dtype=torch.uint8, device=device)
    obs = torch.randint(0, 256, (filled, L) + frame, generator=gen,
                        device=device, dtype=torch.uint8)
  segs = Transition(
      obs=obs,
      action=torch.randint(0, A, (filled, L), generator=gen, device=device,
                           dtype=torch.int32),
      reward=rand(filled, L), done=rand(filled, L) < 0.2,
      rn=rand(filled, L) * 4 - 2, value=rand(filled, L),
      pi=torch.softmax(torch.randn((filled, L, A), generator=gen,
                                   device=device), -1),
      weight=torch.ones(filled, device=device),
      mask=torch.ones((filled, L), device=device))
  replay_add(state, segs, rand(filled, L) + 0.05, step=3)
  return state, gen


def compare_raw(raw, ref, lay):
  """Share of windows with the same start; raises if a window with the same
  start differs in any row."""
  same = raw[lay.start] == ref[lay.start]
  assert torch.equal(raw[:, same], ref[:, same])
  return float(same.float().mean())


@pytest.mark.parametrize("C,L,K,A,W,filled", [
    (2048, 20, 5, 2, 65536, 2048),   # the training regime
    (64, 20, 5, 2, 1000, 32),        # a half-filled ring
    (16, 8, 8, 3, 77, 16),           # one start per segment
])
def test_kernel_matches_plain(cuda, C, L, K, A, W, filled):
  state, gen = _ring(cuda, C, L, A, filled)
  seg_idx = torch.randint(0, filled, (W,), generator=gen, device=cuda)
  gumbel = gumbel_noise(gen, (L, W), cuda)
  before = fused_sampler.launches
  raw, lay = fused_sampler.fused_sample_group(state, seg_idx, gumbel, K)
  torch.cuda.synchronize()
  assert fused_sampler.launches == before + 1
  ref, ref_lay = fused_sampler.fused_sample_group_reference(state, seg_idx,
                                                            gumbel, K)
  assert lay == ref_lay
  assert compare_raw(raw, ref, lay) >= 0.9999


def test_wrapper_rejects_bad_inputs(cuda):
  state, gen = _ring(cuda, 16, 8, 2, 16)
  seg_idx = torch.randint(0, 16, (64,), generator=gen, device=cuda)
  gumbel = gumbel_noise(gen, (8, 64), cuda)
  with pytest.raises(ValueError, match="int64"):
    fused_sampler.fused_sample_group(state, seg_idx.int(), gumbel, 3)
  with pytest.raises(ValueError, match="shape"):
    fused_sampler.fused_sample_group(state, seg_idx, gumbel[:, :10], 3)
  with pytest.raises(ValueError, match="contiguous"):
    fused_sampler.fused_sample_group(
        state, seg_idx, torch.cat([gumbel, gumbel], 1)[:, ::2], 3)
  with pytest.raises(ValueError, match="unroll"):
    fused_sampler.fused_sample_group(state, seg_idx, gumbel, 9)


@pytest.mark.parametrize("per_step_obs", [False, True])
@pytest.mark.parametrize("C,L,K,A,W,filled", [
    (64, 20, 5, 3, 1003, 48),   # W not a multiple of a block's windows
    (64, 20, 5, 3, 8, 48),      # one partial block
    (32, 20, 12, 4, 200, 32),   # K = 12 steps: more than 8 lanes
])
def test_kernel_ragged_batches_and_segments_outside_the_ring(
    cuda, per_step_obs, C, L, K, A, W, filled):
  state, gen = _ring(cuda, C, L, A, filled)
  seg_idx = torch.randint(0, filled, (W,), generator=gen, device=cuda)
  col = torch.arange(W, device=cuda)
  outside = col % 7 == 3
  seg_idx = torch.where(outside, torch.where(col % 2 == 0, -1, C), seg_idx)
  gumbel = gumbel_noise(gen, (L, W), cuda)
  raw, lay = fused_sampler.fused_sample_group(state, seg_idx, gumbel, K,
                                              per_step_obs=per_step_obs)
  torch.cuda.synchronize()
  assert torch.equal(raw[:, outside], torch.zeros_like(raw[:, outside]))
  inside = ~outside
  ref, ref_lay = fused_sampler.fused_sample_group_reference(
      state, seg_idx[inside], gumbel[:, inside].contiguous(), K,
      per_step_obs=per_step_obs)
  assert lay == ref_lay
  assert compare_raw(raw[:, inside], ref, lay) >= 0.9999


@pytest.mark.parametrize("per_step_obs", [False, True])
def test_kernel_reads_uint8_rings(cuda, per_step_obs):
  """PixelCatch(10, 5, scale=1)'s frames: 50 uint8 features, W = 16,384."""
  state, gen = _ring(cuda, 256, 20, 3, 256, frame=(10, 5, 1))
  W, K = 16384, 5
  seg_idx = torch.randint(0, 256, (W,), generator=gen, device=cuda)
  gumbel = gumbel_noise(gen, (20, W), cuda)
  raw, lay = fused_sampler.fused_sample_group(state, seg_idx, gumbel, K,
                                              per_step_obs=per_step_obs)
  ref, _ = fused_sampler.fused_sample_group_reference(
      state, seg_idx, gumbel, K, per_step_obs=per_step_obs)
  assert lay.O == 50
  assert compare_raw(raw, ref, lay) >= 0.9999
  as_f32 = dataclasses.replace(state, obs=state.obs.float())
  raw_f32, _ = fused_sampler.fused_sample_group(as_f32, seg_idx, gumbel, K,
                                                per_step_obs=per_step_obs)
  assert torch.equal(raw, raw_f32)
  with pytest.raises(ValueError, match="uint8"):
    fused_sampler.fused_sample_group(
        dataclasses.replace(state, obs=state.obs.half()), seg_idx, gumbel, K)
