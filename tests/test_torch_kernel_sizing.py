"""The host-side sizing of the categorical family's kernels, on the CPU: the
tiled search's cluster, tree placement, grid, shared memory and device
scratch, and the categorical learner's block count. The kernels check the
same figures on the card and refuse a launch that disagrees
(``tests/test_torch_categorical_kernels.py``).
"""
import pytest

from muax_tpu_torch.models import fused_learner
from muax_tpu_torch.search import fused

# An H100 SXM: 132 SMs, 228 KB of shared memory per SM, 227 KB per block
# (opt-in), 1 KB reserved per block.
H100 = fused.DeviceLimits(sms=132, smem_per_sm=233472, smem_per_block=232448,
                          smem_reserved=1024)
# bench.py's categorical widths: 51 bins, towers (256, 256, 256), E = 64.
BENCH_WIDTHS = [51] + [256] * 6


@pytest.mark.parametrize("batch,A,sims,cluster,smem_trees,grid", [
    (1, 2, 64, 4, True, 4),
    (203, 2, 64, 4, True, 52),
    (512, 2, 64, 4, True, 128),     # categorical_training: one block per SM
    (1003, 2, 64, 4, True, 252),
    (1056, 2, 64, 4, True, 264),
    (1057, 2, 64, 2, True, 134),
    (2048, 2, 64, 2, True, 256),    # muzero_categorical: two blocks per SM
    # Trees too large for eight of them in a block: four blocks keep theirs
    # in shared memory while one block per SM holds every tile ...
    (512, 18, 64, 4, True, 128),
    # ... and past that, two blocks keep theirs in the device scratch.
    (2048, 18, 64, 2, False, 256),
    (2048, 2, 400, 2, False, 256),
    (1024, 2, 400, 2, False, 128),
    (2048, 2, 372, 2, True, 256),   # the last simulation count that fits
])
def test_tiled_search_cluster_and_grid(batch, A, sims, cluster, smem_trees,
                                       grid):
  plan = fused.tiled_plan(batch, A, 64, sims, BENCH_WIDTHS, H100)
  assert plan == (cluster, smem_trees)
  assert fused.tiled_grid(batch, cluster) == grid
  assert grid // cluster * fused.TILE_ENVS >= batch  # every env has a tile
  smem = fused.tiled_smem_bytes(cluster, smem_trees, A, 64, sims,
                                BENCH_WIDTHS)
  assert smem <= H100.smem_per_block
  if not smem_trees:  # the trees did not fit in shared memory
    assert fused.tiled_smem_bytes(cluster, True, A, 64, sims,
                                  BENCH_WIDTHS) > H100.smem_per_block


def test_tiled_search_smem_bytes():
  # muzero_categorical at 2048 envs: rows of 260, 100 and 68 floats; eight
  # trees of 5 x 65 x 3 floats, their invalid masks and slots.
  rows = 16 * (2 * 260 + 100 + 68)
  assert fused.tiled_smem_bytes(2, True, 2, 64, 64, BENCH_WIDTHS) == 4 * (
      rows + 8 * (975 + 2 + 4))
  assert fused.tiled_smem_bytes(4, False, 2, 64, 64, BENCH_WIDTHS) == 4 * (
      rows + 4 * (2 + 4))


def test_tiled_search_rejects_rows_past_shared_memory():
  with pytest.raises(ValueError, match="shared memory"):
    fused.tiled_plan(16, 2, 64, 8, [51, 4096], H100)


def test_tiled_search_scratch_floats():
  # muzero_categorical: 2048 envs, E = 64, 64 simulations (65 nodes): the
  # embeddings alone while the trees live in shared memory, then the trees.
  assert fused.tiled_scratch_floats(2048, 2, 64, 64, True) == 2048 * 65 * 64
  assert fused.tiled_scratch_floats(2048, 2, 64, 64, False) == 2048 * (
      65 * 64 + 5 * 65 + 5 * 65 * 2)
  assert fused.tiled_scratch_floats(1, 3, 16, 1, True) == 2 * 16
  assert fused.tiled_tree_floats(18, 64) == 5 * 65 * 19


@pytest.mark.parametrize("batch,blocks", [(1, 1), (8, 1), (9, 2), (300, 38),
                                          (1024, 128)])
def test_categorical_learner_blocks(batch, blocks):
  assert fused_learner.CATEGORICAL_TILE == 8
  assert fused_learner.categorical_grad_blocks(batch) == blocks
