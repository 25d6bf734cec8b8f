"""The port's replay ring against the JAX package's: the same inserts give
the same ring, and the same draws (the JAX sampler's uniforms, Gumbel noise
and online offsets, injected) give exactly the same indices and windows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muax_tpu.replay.buffer import replay_add as j_add
from muax_tpu.replay.buffer import replay_init as j_init
from muax_tpu.replay.buffer import replay_sample as j_sample
from muax_tpu.replay.fused_sampler import draw_segments as j_draw
from muax_tpu_torch.replay import (replay_add, replay_init, replay_sample,
                                   replay_update_priorities)
from muax_tpu_torch.replay.buffer import (replay_sample_from_draws,
                                          segments_from_draws)
from tests.test_torch_parity import (jax_batch, jax_ring, ring_numpy,
                                     torch_batch, torch_ring)

RING = ("obs", "action", "reward", "done", "rn", "value", "pi",
        "step_priorities", "target_step")


def _assert_rings_equal(port, ref):
  for name in RING:
    np.testing.assert_array_equal(getattr(port, name).numpy(),
                                  np.asarray(getattr(ref, name)), name)
  assert port.cursor == int(ref.cursor)
  assert port.total_added == int(ref.total_added)


def test_add_wraps_and_keeps_the_newest():
  C, L = 8, 4
  ref = j_init(C, L, (3,), 2)
  port = replay_init(C, L, (3,), 2, device="cpu")
  for seed, k, step in ((0, 5, 0), (1, 6, 3), (2, 11, 7)):  # 11 > C
    segs, prios = ring_numpy(seed, C, L, 3, 2, filled=k)
    prios[0, 0] = 0.0  # floored at 1e-9
    ref = j_add(ref, jax_batch(segs), jnp.asarray(prios), step=step)
    replay_add(port, torch_batch(segs), torch.from_numpy(prios), step=step)
    _assert_rings_equal(port, ref)


def _online_draws(key, state, num, offline_fraction, queue):
  """The draws of the JAX level 1 for ``key`` (replay_sample's split)."""
  seg_rng, win_rng, online_rng = jax.random.split(key, 3)
  u = np.array(jax.random.uniform(seg_rng, (num,)))
  num_online = num - int(round(num * offline_fraction))
  window = max(min(queue, int(state.size)), 1)
  offsets = np.array(jax.random.randint(online_rng, (num_online,), 1,
                                          window + 1))
  return u, win_rng, offsets


@pytest.mark.parametrize("offline_fraction,queue", [(1.0, 0), (0.5, 4)])
def test_sample_matches_jax_on_injected_draws(offline_fraction, queue):
  C, L, K, B = 16, 8, 3, 64
  segs, prios = ring_numpy(3, C, L, filled=12)
  ref_state = jax_ring(segs, prios, C, L, 4, 2)
  state = torch_ring(ref_state)
  key = jax.random.PRNGKey(5)
  ref, ref_seg, ref_starts = j_sample(
      ref_state, key, B, K, offline_fraction=offline_fraction,
      online_queue_size=queue)
  u, win_rng, offsets = _online_draws(key, ref_state, B, offline_fraction,
                                      queue)
  gumbel = np.array(jax.random.gumbel(win_rng, (B, L)))
  batch, seg, starts = replay_sample_from_draws(
      state, torch.from_numpy(u), torch.from_numpy(gumbel),
      torch.from_numpy(offsets) if queue else None, K)
  np.testing.assert_array_equal(seg.numpy(), np.asarray(ref_seg))
  np.testing.assert_array_equal(starts.numpy(), np.asarray(ref_starts))
  for name in ("obs", "action", "reward", "done", "rn", "pi", "mask"):
    np.testing.assert_array_equal(getattr(batch, name).numpy(),
                                  np.asarray(getattr(ref, name)), name)
  np.testing.assert_allclose(batch.weight.numpy(), np.asarray(ref.weight),
                             rtol=1e-6)
  if queue:
    assert set(seg[B // 2:].tolist()) <= {8, 9, 10, 11}


def test_draw_segments_matches_jax_on_injected_draws():
  C, L, W = 16, 8, 256
  segs, prios = ring_numpy(4, C, L, filled=12)
  ref_state = jax_ring(segs, prios, C, L, 4, 2)
  key = jax.random.PRNGKey(9)
  ref = j_draw(ref_state, key, W, offline_fraction=0.75, online_queue_size=4)
  seg_rng, online_rng = jax.random.split(key)
  u = np.array(jax.random.uniform(seg_rng, (W,)))
  offsets = np.array(jax.random.randint(online_rng, (W // 4,), 1, 5))
  seg = segments_from_draws(torch_ring(ref_state), torch.from_numpy(u),
                            torch.from_numpy(offsets))
  np.testing.assert_array_equal(seg.numpy(), np.asarray(ref))


def test_sample_from_a_generator_and_refresh():
  C, L, K, B = 16, 8, 3, 32
  segs, prios = ring_numpy(6, C, L, filled=10)
  state = torch_ring(jax_ring(segs, prios, C, L, 4, 2))
  batch, seg, starts = replay_sample(state, torch.Generator().manual_seed(0),
                                     B, K, offline_fraction=0.5,
                                     online_queue_size=3)
  assert batch.obs.shape == (B, K, 4) and batch.pi.shape == (B, K, 2)
  assert int(seg.max()) < 10 and int((starts + K).max()) <= L
  assert set(seg[B // 2:].tolist()) <= {7, 8, 9}
  torch.testing.assert_close(batch.weight.mean(), torch.tensor(1.0))
  replay_update_priorities(state, seg, starts, torch.zeros(B))
  assert float(state.step_priorities[seg, starts].min()) == pytest.approx(
      1e-9)
