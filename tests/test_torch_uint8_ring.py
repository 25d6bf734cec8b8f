"""uint8 observation rings (pixel frames) through the port's learner on the
CPU: the fused sampler's plain version reads them as the same ring in f32
does, the learner's gate sends a ring of more than 64 observation
features to ``replay_sample`` (as the JAX package's gate does,
``muax_tpu/train/learner.py:287-289``) and a smaller uint8 ring to the
hybrid route, whose updates equal those on the ring cast to f32.
Tolerance: none (exact equality)."""
import numpy as np
import pytest
import torch

from muax_tpu_torch.config import (MuZeroConfig, ReplayConfig, SearchConfig,
                                   TrainConfig)
from muax_tpu_torch.fused_status import format_fused_status, fused_status
from muax_tpu_torch.models import (make_efficientzero_networks,
                                   muzero_optimizer)
from muax_tpu_torch.replay import fused_sampler, replay_add, replay_init
from muax_tpu_torch.replay.buffer import gumbel_noise
from muax_tpu_torch.train import TrainState, make_multi_update_fn
from muax_tpu_torch.types import Transition
from tests.test_torch_parity import one_thread, ring_numpy  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

C, L, A = 16, 8, 3


def _rings(frame, seed=0):
  """The same seeded segments in a uint8 ring and in an f32 ring of frames
  ``frame`` [H, W, 1]."""
  O = int(np.prod(frame))
  segs, prios = ring_numpy(seed, C=C, L=L, O=O, A=A)
  segs["obs"] = np.random.default_rng(seed + 1).integers(
      0, 256, (12, L) + frame).astype(np.uint8)
  rings = []
  for dtype in (torch.uint8, torch.float32):
    ring = replay_init(C, L, frame, A, obs_dtype=dtype, device="cpu")
    replay_add(ring, Transition(**{k: torch.from_numpy(v)
                                   for k, v in segs.items()}),
               torch.from_numpy(prios))
    rings.append(ring)
  assert rings[0].obs.dtype == torch.uint8
  assert torch.equal(rings[0].obs.float(), rings[1].obs)
  return rings


@pytest.mark.parametrize("per_step_obs", [False, True])
def test_plain_sampler_reads_uint8_as_f32(per_step_obs):
  u8, f32 = _rings((10, 5, 1))
  gen = torch.Generator().manual_seed(0)
  seg_idx = fused_sampler.draw_segments(u8, gen, 40)
  gumbel = gumbel_noise(gen, (L, 40), torch.device("cpu"))
  raw_u8, lay = fused_sampler.fused_sample_group(u8, seg_idx, gumbel, 4,
                                                 per_step_obs=per_step_obs)
  raw_f32, _ = fused_sampler.fused_sample_group(f32, seg_idx, gumbel, 4,
                                                per_step_obs=per_step_obs)
  assert lay.O == 50 and raw_u8.dtype == torch.float32
  assert torch.equal(raw_u8, raw_f32)


def _config():
  return MuZeroConfig(
      search=SearchConfig(num_simulations=2),
      replay=ReplayConfig(capacity=C, min_fill=4),
      train=TrainConfig(num_envs=4, collect_steps=L, batch_size=6,
                        updates_per_iteration=4, presample_updates=2,
                        unroll_steps=3))


def _net(downsample):
  return make_efficientzero_networks(A, support_size=5, channels=4,
                                     num_blocks=1, downsample=downsample,
                                     device="cpu")


def test_gate_sends_pixel_rings_to_replay_sample():
  """bench.py's 80 x 40 x 1 frames: 3200 features, so the generic path,
  with the reason in ``fused_status``; no kernel takes the conv triplet."""
  net = _net(True)
  ring = replay_init(C, L, (80, 40, 1), A, obs_dtype=torch.uint8,
                     device="cpu")
  params = net.init_params((80, 40, 1), torch.Generator().manual_seed(0))
  config = _config()
  mu = make_multi_update_fn(net, muzero_optimizer(), config)
  mode, lw, reason = mu.fused_group_status(TrainState(params, None, 0), ring)
  assert (mode, lw) == (None, None)
  assert reason == "obs features 3200 > 64 (pixel rings take replay_sample)"
  report = fused_status(net, config, params, ring)
  assert format_fused_status(report) == (
      "fused: search=OFF(conv network family has no search kernel: generic "
      "engine) learner=OFF(network family has no learner kernel: autograd "
      "over its loss, hybrid feed) sampler=OFF(obs features 3200 > 64 "
      "(pixel rings take replay_sample))")


def test_small_uint8_ring_takes_the_hybrid_route():
  """PixelCatch(10, 5, scale=1)'s 50 uint8 features: the fused sampler in
  its per_step_obs mode feeds autograd over the conv triplet's loss. The
  updates on the uint8 ring equal those on the ring cast to f32."""
  net = _net(False)
  config = _config()
  results = []
  for ring in _rings((10, 5, 1), seed=3):
    params = net.init_params((10, 5, 1), torch.Generator().manual_seed(0))
    optimizer = muzero_optimizer()
    mu = make_multi_update_fn(net, optimizer, config)
    ts = TrainState(params, optimizer.init(params), 0)
    mode, _, reason = mu.fused_group_status(ts, ring)
    assert (mode, reason) == ("hybrid", "active (hybrid)")
    ts, ring, metrics = mu(ts, ring, torch.Generator().manual_seed(1))
    assert metrics["updates_done"] == 4
    results.append((torch.cat([p.detach().reshape(-1)
                               for p in ts.params.parameters()]),
                    ring.step_priorities.clone(),
                    {k: float(v) for k, v in metrics.items()}))
  (p_u8, prio_u8, m_u8), (p_f32, prio_f32, m_f32) = results
  assert torch.equal(p_u8, p_f32) and torch.equal(prio_u8, prio_f32)
  assert m_u8 == m_f32
  assert all(np.isfinite(v) for v in m_u8.values())
