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


# ---- the MLP search's launch plan (``fused_search_kernel<policy, G>``) ----

FLAGSHIP_E, FLAGSHIP_BINS, FLAGSHIP_HIDDEN = 8, 41, 16


def _mlp_n_weights(A, E=FLAGSHIP_E, bins=FLAGSHIP_BINS, h=FLAGSHIP_HIDDEN):
  """Floats of the towers with one hidden layer of h in each."""
  dyn = (E + A) * h + h + h * (bins + E) + bins + E
  pred = E * h + h + h * (bins + A) + bins + A
  return dyn + pred


def _parent_accepts(A, E, sims, n_weights, bins, hidden, gumbel, limits):
  """Whether the one-warp-per-env kernel (the whole tree, embeddings
  and two activation rows in shared memory) launched this shape: one
  environment's floats beside the towers within a block's limit."""
  n = sims + 1
  act = max(E + A, bins, *hidden)
  floats = 4 * n + 5 * n * A + n * E + 2 * act + A + (n + A if gumbel else 0)
  return 4 * (-(-n_weights // 4) * 4 + floats) <= limits.smem_per_block


@pytest.mark.parametrize(
    "batch,A,sims,gumbel,group,envs,smem_emb,resident,warps", [
        # bench.py's rollout and gumbel_mlp: every env resident, 8 lanes'
        # worth of warps on each SM, the embeddings in the scratch.
        (8192, 2, 64, False, 4, 32, False, True, 8),
        (8192, 2, 64, True, 4, 32, False, True, 8),
        # training_regime and gumbel_training: a warp per env.
        (1024, 2, 64, False, 32, 4, True, True, 8),
        (1024, 2, 64, True, 32, 4, True, True, 8),
        (2048, 2, 64, False, 32, 8, True, True, 16),
        (1003, 4, 64, False, 32, 4, True, True, 8),
        (1, 2, 64, False, 32, 1, True, True, 1),
        # An Atari-sized action set and long searches: no launch holds
        # 8192 trees at once, and whole warps walk them.
        (8192, 18, 64, False, 32, 8, True, False, 16),
        (2048, 18, 64, False, 32, 8, True, True, 16),
        (8192, 2, 400, False, 32, 8, False, False, 16),
        (8192, 2, 400, True, 32, 4, False, False, 12),
    ])
def test_mlp_search_plan(batch, A, sims, gumbel, group, envs, smem_emb,
                         resident, warps):
  n_weights = _mlp_n_weights(A)
  widths = [FLAGSHIP_BINS, FLAGSHIP_HIDDEN, FLAGSHIP_HIDDEN]
  plan = fused.mlp_search_plan(batch, A, FLAGSHIP_E, sims, n_weights, widths,
                               gumbel, H100)
  assert (plan.group, plan.envs_per_block, plan.smem_emb, plan.resident,
          plan.warps_per_sm) == (group, envs, smem_emb, resident, warps)
  assert plan.grid * plan.envs_per_block >= batch  # every env has a group
  threads = plan.group * plan.envs_per_block
  assert threads <= fused.MLP_BLOCK_THREADS and threads % 32 == 0
  floats = fused.mlp_env_floats(A, FLAGSHIP_E, sims,
                                fused.mlp_act_width(A, FLAGSHIP_E, widths),
                                gumbel, plan.smem_emb)
  smem = fused.mlp_smem_bytes(n_weights, plan.envs_per_block, floats)
  assert smem <= H100.smem_per_block
  assert plan.blocks_per_sm * (smem + H100.smem_reserved) <= H100.smem_per_sm
  assert plan.resident == (plan.grid <= plan.blocks_per_sm * H100.sms)
  assert _parent_accepts(A, FLAGSHIP_E, sims, n_weights, FLAGSHIP_BINS,
                         [FLAGSHIP_HIDDEN], gumbel, H100)


@pytest.mark.parametrize("gumbel", [False, True])
@pytest.mark.parametrize("A,E,hidden", [(1, 1, 4), (2, 8, 16), (5, 16, 64),
                                        (18, 32, 64), (64, 8, 16)])
def test_mlp_plan_takes_every_shape_the_warp_kernel_took(gumbel, A, E,
                                                        hidden):
  # Past the largest tree one warp's block holds, both refuse; below it,
  # the plan never refuses what the one-warp-per-env kernel launched.
  bins = 41
  n_weights = _mlp_n_weights(A, E, bins, hidden)
  for sims in (1, 16, 64, 200, 400, 1000, 2000, 4000, 6000, 20000):
    parent = _parent_accepts(A, E, sims, n_weights, bins, [hidden], gumbel,
                             H100)
    try:
      fused.mlp_search_plan(8192, A, E, sims, n_weights, [bins, hidden],
                            gumbel, H100)
      ok = True
    except RuntimeError as err:
      assert "do not fit" in str(err)
      ok = False
    assert ok or not parent, (sims, "refused where the warp kernel ran")
    if sims == 20000:
      assert not ok  # one tree of 20,001 nodes exceeds a block


# examples/run_2048.py's triplet: A = 4, embedding 64, support 300 (601
# bins), towers (256, 256): 492,278 floats of dynamics and prediction, 1.97
# MB, past a block's 227 KB of shared memory.
T2048 = dict(A=4, E=64, bins=601, hidden=(256, 256))


def _towers_floats(A, E, bins, hidden):
  """Floats of the search's two towers (the kernel's flat layout)."""
  def tower(d_in, heads):
    n = 0
    for h in hidden:
      n += d_in * h + h
      d_in = h
    return n + sum(d_in * o + o for o in heads)
  return tower(E + A, (bins, E)) + tower(E, (bins, A))


@pytest.mark.parametrize("gumbel", [False, True])
@pytest.mark.parametrize("batch,envs,warps", [(64, 1, 1), (1024, 4, 8)])
def test_mlp_search_plan_reads_wide_towers_from_device_memory(batch, envs,
                                                              warps, gumbel):
  # run_2048's 64 boards (and 1024) x 50 simulations: no launch stages the
  # towers, so every launch reads them from device memory, a warp an env.
  n_weights = _towers_floats(**T2048)
  assert n_weights == 492278
  widths = [T2048["bins"], *T2048["hidden"], *T2048["hidden"]]
  plan = fused.mlp_search_plan(batch, T2048["A"], T2048["E"], 50, n_weights,
                               widths, gumbel, H100)
  assert not plan.smem_weights
  assert (plan.group, plan.envs_per_block, plan.smem_emb, plan.resident,
          plan.warps_per_sm) == (32, envs, True, True, warps)
  floats = fused.mlp_env_floats(T2048["A"], T2048["E"], 50,
                                fused.mlp_act_width(T2048["A"], T2048["E"],
                                                    widths),
                                gumbel, plan.smem_emb)
  assert fused.mlp_smem_bytes(n_weights, 1, floats) > H100.smem_per_block
  smem = fused.mlp_smem_bytes(0, plan.envs_per_block, floats)
  assert smem <= H100.smem_per_block
  assert plan.blocks_per_sm * (smem + H100.smem_reserved) <= H100.smem_per_sm
  # The bench-width shapes keep their staged towers.
  assert fused.mlp_search_plan(batch, 2, FLAGSHIP_E, 64, _mlp_n_weights(2),
                               [FLAGSHIP_BINS, 16, 16], gumbel,
                               H100).smem_weights


def test_mlp_search_plan_refuses_only_a_tree_past_shared_memory():
  # With the towers in device memory only one environment's own slice has
  # to fit a block: 2,000 simulations of run_2048's tree do, 20,000 not.
  n_weights = _towers_floats(**T2048)
  widths = [T2048["bins"], *T2048["hidden"], *T2048["hidden"]]
  plan = fused.mlp_search_plan(64, T2048["A"], T2048["E"], 2000, n_weights,
                               widths, False, H100)
  assert not plan.smem_weights and not plan.smem_emb
  with pytest.raises(RuntimeError, match="tree exceeds"):
    fused.mlp_search_plan(64, T2048["A"], T2048["E"], 20000, n_weights,
                          widths, False, H100)


def test_mlp_env_floats():
  # The flagship tree: 4 N + 2 N A = 520 floats, two activation buffers of
  # 41 (the bins), the invalid mask: 604; Gumbel adds N + A; the embeddings
  # N E; rounded up to odd.
  assert fused.mlp_env_floats(2, 8, 64, 41, False, False) == 605
  assert fused.mlp_env_floats(2, 8, 64, 41, True, False) == 604 + 67
  assert fused.mlp_env_floats(2, 8, 64, 41, False, True) == 604 + 520 + 1
  assert fused.mlp_act_width(2, 8, [41, 16, 16]) == 41
  assert fused.mlp_smem_bytes(1884, 32, 605) == 4 * (1884 + 32 * 605)


# ---- the MLP learner's launch plan (``mlp_tile_kernel``) --------------------

def _learner_shapes(A, repr_layers, layers, support, E=8, O=4):
  return fused_learner.LearnerWeights(
      repr_layers=tuple(repr_layers), pred_layers=tuple(layers),
      dyn_layers=tuple(layers), obs_dim=O, embedding_dim=E, num_actions=A,
      support_size=support, flat=None)


def _parent_learner_accepts(lw, K, limits):
  """Whether the one-warp-per-window kernel launched this shape: one warp's
  slice (its gradient sum, its window's activations, scratch rows) beside
  the weights within a block's shared memory."""
  def up4(n):
    return -(-n // 4) * 4

  E, A, S41 = lw.embedding_dim, lw.num_actions, 2 * lw.support_size + 1
  n_weights = fused_learner.mlp_learner_floats(lw, K)[0]
  widths = (*lw.repr_layers, *lw.pred_layers, *lw.dyn_layers)
  max_w = max(S41, E, A, *widths)
  step = 2 * E + sum(lw.pred_layers) + 2 * S41 + A + sum(lw.dyn_layers)
  scratch = (up4(n_weights) + lw.obs_dim + sum(lw.repr_layers) + E
             + K * step)
  warp = up4(scratch + 3 * E + 4 * max_w)
  return 4 * (up4(n_weights) + warp) <= limits.smem_per_block


def test_learner_floats_at_the_flagship():
  # Arena rows padded to 4 mod 8: 16 -> 20, 41 -> 44, 8 and 10 -> 12.
  assert [fused_learner.learner_padded(n) for n in (1, 4, 5, 8, 10, 12, 13,
                                                    16, 41, 64)] == [
      4, 4, 12, 12, 12, 12, 20, 20, 44, 68]
  lw = _learner_shapes(2, (16,), (16,), 20)
  # 2,100 parameters, held in shared memory as they are; the arena of 16
  # windows x 5 steps: 19,440 floats (77.8 KB).
  assert fused_learner.mlp_learner_floats(lw, 5) == (2100, 2100, 19440)


@pytest.mark.parametrize("A,repr_layers,layers,support,E,B,K,smem_arena,"
                         "smem,per_sm,warps", [
    # training_regime: 256 blocks, two an SM, one wave.
    (2, (16,), (16,), 20, 8, 4096, 5, True, 86160, 2, 16),
    (2, (16,), (16,), 20, 8, 4097, 5, True, 86160, 2, 16),
    (2, (16,), (16,), 20, 8, 1, 5, True, 86160, 2, 8),
    # The CartPole notebook towers at K = 11: the arena (546 KB) lies in
    # the device scratch, the weights alone in shared memory.
    (2, (), (64, 64, 16), 20, 10, 256, 11, False, 54336, 2, 8),
])
def test_learner_plan(A, repr_layers, layers, support, E, B, K, smem_arena,
                      smem, per_sm, warps):
  lw = _learner_shapes(A, repr_layers, layers, support, E)
  plan = fused_learner.mlp_learner_plan(B, K, lw, H100)
  n_weights, weights, arena = fused_learner.mlp_learner_floats(lw, K)
  assert plan.blocks == -(-B // fused_learner.LEARNER_TILE)
  assert (plan.smem_arena, plan.smem_bytes, plan.blocks_per_sm,
          plan.warps_per_sm) == (smem_arena, smem, per_sm, warps)
  assert plan.scratch_floats == plan.blocks * (
      n_weights + (0 if smem_arena else arena))
  assert plan.smem_bytes <= H100.smem_per_block
  assert plan.blocks_per_sm * (plan.smem_bytes + H100.smem_reserved) <= (
      H100.smem_per_sm)


def _learner_cases():
  """Every shape the kernel is held at: the gpu tests' and chip_smoke.py's
  phase 5 (the flagship, the edge shape, the notebook towers and the wide
  towers)."""
  from tests.test_torch_fused_learner_kernel import (EMBEDDING_32_CASE,
                                                     RAW_MODE_CASES)
  return ([(*case, 8) for case in RAW_MODE_CASES] + [(*EMBEDDING_32_CASE, 32)]
          + [(2, (16,), (16,), 20, 4096, 5, 8),
             (4, (16,), (16, 16), 10, 1000, 5, 8),
             (2, (), (64, 64, 16), 20, 256, 11, 10),
             (2, (16,), (128,), 20, 300, 5, 8)])


def test_learner_plan_takes_every_shape_the_warp_kernel_took():
  # The shapes the kernel is tested at, then a sweep of towers and unrolls:
  # wherever the one-warp-per-window kernel launched, the plan does too.
  for A, repr_layers, layers, support, B, K, E in _learner_cases():
    lw = _learner_shapes(A, repr_layers, layers, support, E)
    assert _parent_learner_accepts(lw, K, H100)
    fused_learner.mlp_learner_plan(B, K, lw, H100)
  took = 0
  for width in (8, 16, 64, 128, 256):
    for depth in (1, 2, 3):
      for K in (1, 5, 11, 20, 50):
        for A, support, E in ((2, 20, 8), (18, 10, 32), (4, 300, 64)):
          lw = _learner_shapes(A, (width,), (width,) * depth, support, E)
          if not _parent_learner_accepts(lw, K, H100):
            continue
          took += 1
          plan = fused_learner.mlp_learner_plan(4096, K, lw, H100)
          assert plan.smem_bytes <= H100.smem_per_block
  assert took > 100


def test_learner_plan_refuses_weights_past_shared_memory():
  # Towers of (256, 256) hold about 150 K floats of weights: more than a
  # block's 58 K, which the one-warp-per-window kernel refused. The plan
  # takes them: the weights stay in device memory, the arena in the
  # scratch, and no shared memory is left to size.
  lw = _learner_shapes(2, (256,), (256, 256), 20)
  assert not _parent_learner_accepts(lw, 5, H100)
  plan = fused_learner.mlp_learner_plan(4096, 5, lw, H100)
  n_weights, weights, arena = fused_learner.mlp_learner_floats(lw, 5)
  assert 4 * weights > H100.smem_per_block
  assert (plan.smem_weights, plan.smem_arena, plan.smem_bytes) == (
      False, False, 0)
  assert plan.scratch_floats == plan.blocks * (n_weights + arena)


@pytest.mark.parametrize("B,blocks,per_sm,warps", [(256, 16, 2, 8),
                                                   (16, 1, 2, 8)])
def test_learner_plan_at_the_2048_example(B, blocks, per_sm, warps):
  # run_2048's triplet (observations 4 x 4, towers (256, 256) in all three,
  # embedding 64, 601 bins, A = 4) at its batch 256, unroll K = 5: 2.3 MB
  # of weights, read from device memory.
  lw = fused_learner.LearnerWeights(
      repr_layers=(256, 256), pred_layers=(256, 256), dyn_layers=(256, 256),
      obs_dim=16, embedding_dim=64, num_actions=4, support_size=300,
      flat=None)
  n_weights, _, arena = fused_learner.mlp_learner_floats(lw, 5)
  assert n_weights == 578870
  plan = fused_learner.mlp_learner_plan(B, 5, lw, H100)
  assert plan == fused_learner.LearnerPlan(
      blocks, False, 0, blocks * (n_weights + arena), per_sm, warps, False)


# ---- the Stochastic MuZero launch plan (``fused_smz_kernel``) ---------------

# bench.py's smz_mlp widths: A = 2, 32 chance outcomes, embedding 32,
# hidden (64,), 41 bins.
SMZ_MLP = dict(A=2, C=32, E=32, hidden=64, bins=41)


# examples/run_2048.py's widths in make_stochastic_mlp_networks (A = 4, 32
# chance outcomes, embedding 64, support 300: 601 bins, hidden (256, 256)):
# 762,031 floats, 3.05 MB of towers, past a block's shared memory.
WIDE_2048 = dict(A=4, C=32, E=64, hidden=256, bins=601, layers=2)


def _smz_n_weights(A, C, E, hidden, bins, layers=1):
  """Floats of the three towers at ``layers`` hidden layers of width
  ``hidden`` (the kernel's flat layout: per linear W then b)."""
  def tower(inputs, heads):
    return (inputs * hidden + hidden + (layers - 1) * (hidden + 1) * hidden
            + sum(hidden * h + h for h in heads))
  return (tower(E + A, (E, C, bins)) + tower(E + C, (E, bins))
          + tower(E, (A, bins)))


def _smz_parent_accepts(A, C, E, hidden, bins, sims, limits):
  """Whether the one-warp-per-env kernel launched this shape: its node
  arrays (4 N floats), three activation buffers and the invalid mask
  beside the weights within a block's shared memory."""
  def up4(n):
    return -(-n // 4) * 4

  act = up4(max(E + max(A, C), E, C, bins, hidden))
  warp = 4 * (sims + 1) + 3 * act + up4(A)
  return 4 * (up4(_smz_n_weights(A, C, E, hidden, bins)) + warp) <= (
      limits.smem_per_block)


def test_smz_weights_at_smz_mlp():
  # The 22,877 floats the kernel stages (PERF.md, chip_smoke.py phase 16).
  assert _smz_n_weights(**SMZ_MLP) == 22877


def test_smz_env_bytes():
  # smz_mlp at 200 simulations: N = 201, K = max(A, C) = 32; the tree's
  # f32 visits, values, rewards, prior scales (4 N) and priors (N K), int16
  # children (N K) and a path of 201: 42,210 bytes, to 42,224; the work
  # buffers X 32, H0 and H1 64, Y 32 + 32 + 41 (to 108), Z 2 + 41 (to 44),
  # the mask 2 (to 4) and 8 control words: 324 floats; the embeddings
  # 201 x 32 floats.
  n, k = 201, 32
  assert 4 * (4 * n + n * k) + 2 * (n * k + n) == 42210
  assert fused.smz_env_bytes(2, 32, 32, 41, 200, 200, 64) == (
      42224, 4 * 324, 4 * 201 * 32)
  # A depth cap shortens the path: 33 entries, 41,874 bytes, to 41,888.
  assert fused.smz_env_bytes(2, 32, 32, 41, 200, 32, 64)[0] == 41888


@pytest.mark.parametrize(
    "batch,sims,max_depth,widths,envs,smem_tree,smem_emb,grid,waves", [
        # stochastic_200sims: two envs a block, trees and embeddings in
        # shared memory, one block on each of 128 SMs.
        (256, 200, 200, SMZ_MLP, 2, True, True, 128, 1),
        # stochastic_200sims_512: the same blocks in two waves.
        (512, 200, 200, SMZ_MLP, 2, True, True, 256, 2),
        # The deep-tree cases of the gpu tests and phase 16.
        (64, 200, 32, SMZ_MLP, 1, True, True, 64, 1),
        (64, 200, 200, SMZ_MLP, 1, True, True, 64, 1),
        # Phase 16's edge shape.
        (37, 64, 2, dict(A=3, C=4, E=8, hidden=16, bins=21), 1, True, True,
         37, 1),
        # Longer searches: one tree still fits beside the towers at 400
        # simulations; at 800 the trees go to the device scratch.
        (256, 400, 400, SMZ_MLP, 1, True, True, 256, 2),
        (256, 800, 800, SMZ_MLP, 1, False, False, 256, 1),
        # Wide C: rows of 256 slots.
        (64, 100, 100, dict(A=3, C=256, E=16, hidden=32, bins=41), 1, False,
         False, 64, 1),
    ])
def test_smz_search_plan(batch, sims, max_depth, widths, envs, smem_tree,
                         smem_emb, grid, waves):
  A, C, E = widths["A"], widths["C"], widths["E"]
  hidden, bins = widths["hidden"], widths["bins"]
  n_weights = _smz_n_weights(A, C, E, hidden, bins)
  plan = fused.smz_search_plan(batch, A, C, E, bins, sims, max_depth,
                               n_weights, hidden, H100)
  assert (plan.envs_per_block, plan.smem_tree, plan.smem_emb, plan.grid,
          plan.waves) == (envs, smem_tree, smem_emb, grid, waves)
  assert plan.grid * plan.envs_per_block >= batch
  tree, work, emb = fused.smz_env_bytes(A, C, E, bins, sims, max_depth,
                                        hidden)
  assert plan.smem_bytes == 4 * (-(-n_weights // 4) * 4) + envs * (
      work + tree * smem_tree + emb * smem_emb)
  assert plan.scratch_bytes == tree * (not smem_tree) + emb * (not smem_emb)
  assert plan.smem_bytes <= H100.smem_per_block
  assert plan.blocks_per_sm * (plan.smem_bytes + H100.smem_reserved) <= (
      H100.smem_per_sm)
  assert plan.waves == -(-plan.grid // (plan.blocks_per_sm * H100.sms))
  if not smem_tree:  # no block holds even one tree beside the towers
    assert 4 * (-(-n_weights // 4) * 4) + work + tree > H100.smem_per_block


@pytest.mark.parametrize("widths", [
    SMZ_MLP, dict(A=3, C=4, E=8, hidden=16, bins=21),
    dict(A=4, C=8, E=16, hidden=24, bins=41),
    dict(A=18, C=64, E=64, hidden=128, bins=101)])
def test_smz_plan_takes_every_shape_the_warp_kernel_took(widths):
  A, C, E = widths["A"], widths["C"], widths["E"]
  hidden, bins = widths["hidden"], widths["bins"]
  n_weights = _smz_n_weights(A, C, E, hidden, bins)
  for sims in (1, 16, 64, 200, 400, 1000, 4000, 8000, 16000, 32766):
    parent = _smz_parent_accepts(A, C, E, hidden, bins, sims, H100)
    try:
      fused.smz_search_plan(256, A, C, E, bins, sims, sims, n_weights,
                            hidden, H100)
      ok = True
    except RuntimeError as err:
      assert "do not fit" in str(err)
      ok = False
    assert ok or not parent, (sims, "refused where the warp kernel ran")


def test_smz_plan_refuses_what_the_kernel_cannot_take():
  # Towers past a block's shared memory (hidden 256 at C = 64: 67 K
  # floats) are read from device memory, the trees kept in shared memory;
  # only trees past int16 node indices are refused.
  wide = dict(A=2, C=64, E=64, hidden=256, bins=101)
  n_weights = _smz_n_weights(**wide)
  assert 4 * n_weights > H100.smem_per_block
  plan = fused.smz_search_plan(256, 2, 64, 64, 101, 200, 200, n_weights,
                               256, H100)
  assert not plan.smem_weights and plan.smem_tree
  tree, work, emb = fused.smz_env_bytes(2, 64, 64, 101, 200, 200, 256)
  assert plan.smem_bytes == plan.envs_per_block * (
      work + tree + emb * plan.smem_emb) <= H100.smem_per_block
  with pytest.raises(RuntimeError, match="do not fit"):
    fused.smz_search_plan(256, 2, 32, 32, 41, 32767, 32767,
                          _smz_n_weights(**SMZ_MLP), 64, H100)
  with pytest.raises(RuntimeError, match="do not fit"):
    fused.smz_search_plan(256, 2, 32, 32, 41, 32767, 32767, n_weights, 256,
                          H100)


def test_smz_env_bytes_at_2048_widths():
  # N = 201, K = 32: the tree as at smz_mlp (42,224 bytes); the work
  # buffers X 64, H0 and H1 256, Y 64 + 32 + 601 (to 700), Z 4 + 601 (to
  # 608), the mask 4 and 8 control words: 1,896 floats; the embeddings
  # 201 x 64 floats.
  assert _smz_n_weights(**WIDE_2048) == 762031
  assert fused.smz_env_bytes(4, 32, 64, 601, 200, 200, 256) == (
      42224, 4 * 1896, 4 * 201 * 64)


@pytest.mark.parametrize("batch,envs,smem_emb,grid,per_sm,waves", [
    # 64 boards: one env a block with its tree and embeddings, two blocks
    # an SM, every env resident.
    (64, 1, True, 64, 2, 1),
    # 1024 boards: the embeddings go to the scratch so that four blocks
    # fit an SM (the limit of the instance's 128 registers a thread), two
    # waves instead of four.
    (1024, 1, False, 1024, 4, 2),
])
def test_smz_plan_reads_wide_towers_from_device_memory(batch, envs, smem_emb,
                                                       grid, per_sm, waves):
  A, C, E, hidden, bins = 4, 32, 64, 256, 601
  n_weights = _smz_n_weights(**WIDE_2048)
  assert 4 * n_weights > H100.smem_per_block
  plan = fused.smz_search_plan(batch, A, C, E, bins, 200, 200, n_weights,
                               hidden, H100)
  tree, work, emb = fused.smz_env_bytes(A, C, E, bins, 200, 200, hidden)
  assert plan == fused.SMZPlan(
      envs, True, smem_emb, grid, per_sm, waves,
      envs * (work + tree + emb * smem_emb), emb * (not smem_emb), False)
  # Two environments' trees, work buffers and embeddings fit a block; a
  # third does not.
  assert 2 * (tree + work + emb) <= H100.smem_per_block
  assert 3 * (tree + work + emb) > H100.smem_per_block


def test_smz_plan_at_smz_mlp_keeps_its_staged_towers():
  # bench.py's smz_mlp at 256 envs x 200 simulations: the plan it had
  # before the towers could stay in device memory.
  plan = fused.smz_search_plan(256, 2, 32, 32, 41, 200, 200,
                               _smz_n_weights(**SMZ_MLP), 64, H100)
  assert plan == fused.SMZPlan(2, True, True, 128, 1, 1, 230016, 0, True)
