"""The port's fused sampler (its plain version, on the CPU) against the JAX
package's Pallas sampler in interpret mode.

Both get the same ring, the same segment indices and the Gumbel noise that
``jax.random.gumbel(gum_rng, (L, W))`` draws inside the JAX sampler. Every
raw row must be exactly equal: the JAX kernel's one-hot gather copies
values, and both draw the start by the first maximum of the same f32 sums.

The CUDA kernel is held against the plain version on the card in
``tests/test_torch_fused_sampler_kernel.py``.
"""
import jax
import numpy as np
import pytest
import torch

from muax_tpu.replay.fused_sampler import fused_sample_group as j_sample_group
from muax_tpu.replay.fused_sampler import transpose_ring
from muax_tpu_torch.replay import fused_sampler
from muax_tpu_torch.replay.fused_sampler import (fused_sample_group,
                                                 make_raw_layout)
from tests.test_torch_parity import jax_ring, ring_numpy, torch_ring


@pytest.mark.parametrize("C,L,K,W,filled,done_rate", [
    (16, 8, 3, 128, 12, 0.15),
    (32, 20, 5, 256, 24, 0.3),   # the training regime's L and K
    (16, 8, 8, 128, 16, 0.0),    # one start per segment, no dones
])
def test_raw_rows_equal_jax_kernel(C, L, K, W, filled, done_rate):
  segs, prios = ring_numpy(C + K, C, L, filled=filled, done_rate=done_rate)
  ref_state = jax_ring(segs, prios, C, L, 4, 2)
  ref_state = ref_state.replace(
      target_step=jax.numpy.arange(C, dtype=jax.numpy.int32) * 3)
  seg_idx = np.random.default_rng(K).integers(0, filled, W)
  gum_rng = jax.random.PRNGKey(K)
  ref, ref_lay = j_sample_group(transpose_ring(ref_state),
                                ref_state.step_priorities,
                                ref_state.target_step,
                                jax.numpy.asarray(seg_idx, jax.numpy.int32),
                                gum_rng, K, interpret=True)
  gumbel = np.array(jax.random.gumbel(gum_rng, (L, W), jax.numpy.float32))

  before = fused_sampler.launches
  raw, lay = fused_sample_group(torch_ring(ref_state),
                                torch.from_numpy(seg_idx),
                                torch.from_numpy(gumbel), K)
  assert fused_sampler.launches == before  # the plain version launches nothing
  assert lay == make_raw_layout(4, K, 2) == ref_lay
  np.testing.assert_array_equal(raw.numpy(), np.asarray(ref))
  # The target-step row is not overwritten by the zero padding after it.
  np.testing.assert_array_equal(raw[lay.tstep].numpy(), seg_idx * 3.0)


def test_per_step_obs_rows():
  """The per-step-observation mode runs (it was refused before Stochastic
  MuZero was ported): row f*K + j holds feature f of window step j, and
  every other row is that of the start-observation mode, shifted by the
  extra observation rows (tests/test_fused_sampler.py:242-258). The JAX
  kernel's rows are held in tests/test_torch_smz_learner.py."""
  segs, prios = ring_numpy(0)
  state = torch_ring(jax_ring(segs, prios, 16, 8, 4, 2))
  K, W = 3, 64
  seg_idx = torch.from_numpy(np.random.default_rng(5).integers(0, 12, W))
  gumbel = torch.from_numpy(np.random.default_rng(6).gumbel(
      size=(8, W)).astype(np.float32))
  raw, lay = fused_sample_group(state, seg_idx, gumbel, K, per_step_obs=True)
  assert lay == make_raw_layout(4, K, 2, per_step_obs=True)
  start = raw[lay.start].long()
  for f in range(4):
    for j in range(K):
      torch.testing.assert_close(raw[lay.obs + f * K + j],
                                 state.obs[seg_idx, start + j, f],
                                 rtol=0, atol=0)
  plain, plain_lay = fused_sample_group(state, seg_idx, gumbel, K)
  torch.testing.assert_close(raw[lay.action:lay.tstep + 1],
                             plain[plain_lay.action:plain_lay.tstep + 1],
                             rtol=0, atol=0)
