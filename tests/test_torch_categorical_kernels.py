"""The categorical modes of the search kernel, the categorical learner's two
kernels and their shared tensor-core tile product against their plain
PyTorch versions, on the card. Every test here
needs a CUDA card (and ``nvcc`` to build the kernels) and skips without one;
the file imports nothing of the JAX package:

  python -m pytest tests/test_torch_categorical_kernels.py -m gpu -q

Search: visits sum to the simulation count, at least 99 % of environments
within 2 visits of the plain version, and there root value and q within
rtol = atol = 1e-3 (``tests/test_fused.py:54-60``); Gumbel: the policy's
action on at least 99 % of environments. Learner: gradients rtol 5e-4 /
atol 1e-6, total rtol 1e-5, priorities rtol 1e-4
(``tests/test_fused_learner.py:156-162``), and two launches on the same
inputs give bit-identical gradients. Tile product (``csrc/tc_tile.cuh``,
3xTF32): within 1e-5 of sum_k |a_mk| |b_kn| of a float64 product, which a
single TF32 pass (about 5e-4) misses, and bit-identical on a repeat.
"""
import ctypes

import pytest
import torch

from muax_tpu_torch import _build
from muax_tpu_torch.envs import CartPole
from muax_tpu_torch.models import fused_learner, make_categorical_mlp_networks
from muax_tpu_torch.replay.buffer import gumbel_noise
from muax_tpu_torch.search import fused
from muax_tpu_torch.search.policies import _mask_invalid
from muax_tpu_torch.train.inference import make_root_fn
from muax_tpu_torch.types import Transition

pytestmark = pytest.mark.gpu
KW = dict(l2_coef=1e-4, gradient_scale=0.5, priority_alpha=0.5)
SMALL = dict(embedding_dim=16, num_bins=21, vmin=-10.0, vmax=10.0,
             layer_sizes=(32, 32))
BENCH = dict(embedding_dim=64, num_bins=51, vmin=-150.0, vmax=150.0,
             layer_sizes=(256, 256, 256))


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the kernel has no CPU mode")
  torch.backends.cuda.matmul.allow_tf32 = False
  return torch.device("cuda", torch.cuda.current_device())


def _search_inputs(device, A, widths, B, with_invalid, seed=0):
  net = make_categorical_mlp_networks(A, device=device, **widths)
  params = net.init_params((4,), torch.Generator().manual_seed(seed))
  gen = torch.Generator(device=device).manual_seed(seed)
  _, obs = CartPole().reset(gen, B)
  invalid = None
  if with_invalid:
    pick = torch.randint(0, A, (B,), generator=gen, device=device)
    invalid = torch.nn.functional.one_hot(pick, A).float()
  with torch.no_grad():
    root = make_root_fn(net)(params, obs)
  spec = fused.extract_categorical_fused_weights(net, params)
  return root, spec, invalid, gen


def _compare(out, ref, sims):
  visits, value, q = out
  ref_visits, ref_value, ref_q = ref
  assert bool((visits.sum(-1) == sims).all())
  dv = (visits - ref_visits).abs().amax(-1)
  near, exact = dv <= 2, dv == 0
  assert float(near.float().mean()) >= 0.99
  torch.testing.assert_close(value[near], ref_value[near], rtol=1e-3,
                             atol=1e-3)
  torch.testing.assert_close(q[exact], ref_q[exact], rtol=1e-3, atol=1e-3)


# The products of the learner's first pass (shape 0: rows of a tile of 8
# windows, or all K = 5 steps of it; W [out, in] read transposed in the
# forward, as is in the backward), of the search (shape 1: 16 rows, one
# cluster block's quarter of the columns) and of the weight-gradient pass
# (shape 2: dZ [rows, out] read transposed against X [rows, in]), at the
# bench widths and at ragged edges. (shape, M, N, K, A transposed, B
# transposed).
PRODUCTS = [
    (0, 8, 256, 4, False, True),     # representation's first layer
    (0, 8, 256, 256, False, True),
    (0, 40, 51, 256, False, True),   # value head over K steps
    (0, 40, 256, 51, False, False),  # value head's backward
    (0, 8, 66, 256, False, False),   # gradient into concat(s, a)
    (0, 13, 37, 29, False, True),    # ragged everywhere
    (1, 16, 64, 256, False, False),
    (1, 16, 16, 66, False, False),   # a quarter of 51 bins over E + A
    (1, 16, 2, 256, False, False),   # policy head
    (1, 11, 13, 21, False, False),
    (2, 256, 256, 40, True, False),
    (2, 51, 256, 40, True, False),
    (2, 256, 4, 8, True, False),     # representation's first layer's dW
    (2, 37, 45, 24, True, False),
]


@pytest.mark.parametrize("shape,M,N,K,ta,tb", PRODUCTS)
def test_tile_product_matches_float64(cuda, shape, M, N, K, ta, tb):
  lib = _build.load("tc_tile_check")
  ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
  lib.mz_tc_product.argtypes = [i32, i32, i32, i32, ptr, i64, i64, ptr, i64,
                                i64, ptr, i32, ptr]
  lib.mz_tc_product.restype = i32
  gen = torch.Generator(device=cuda).manual_seed(M * 1000 + N * 10 + K)
  a = torch.randn((K, M) if ta else (M, K), generator=gen, device=cuda)
  b = torch.randn((N, K) if tb else (K, N), generator=gen, device=cuda)
  sa = (1, M) if ta else (K, 1)  # (sam, sak)
  sb = (1, K) if tb else (N, 1)  # (sbk, sbn)

  def run():
    c = torch.full((M, N), float("nan"), device=cuda)
    err = lib.mz_tc_product(shape, M, N, K, a.data_ptr(), *sa, b.data_ptr(),
                            *sb, c.data_ptr(), cuda.index,
                            torch.cuda.current_stream(cuda).cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    return c

  c = run()
  A64 = (a.T if ta else a).double()
  B64 = (b.T if tb else b).double()
  ref = A64 @ B64
  scale = A64.abs() @ B64.abs()
  assert float(((c.double() - ref).abs() / scale).max()) <= 1e-5
  assert torch.equal(c, run())


# Searches whose trees do not fit a block's shared memory beside the
# activation rows at 2048 envs, so that they live in the device scratch.
PAST_SMEM = [(18, BENCH, 2048, 64, False, None),
             (2, BENCH, 2048, 400, False, None)]


@pytest.mark.parametrize("A,widths,B,sims,invalid,max_depth", [
    (2, BENCH, 256, 32, False, None),
    (2, BENCH, 512, 64, False, None),  # categorical_training's envs
    (3, SMALL, 203, 16, True, 2),
] + PAST_SMEM)
def test_muzero_mode_matches_plain(cuda, A, widths, B, sims, invalid,
                                   max_depth):
  root, spec, inv, gen = _search_inputs(cuda, A, widths, B, invalid)
  logits = fused.noised_root_logits(gen, root.prior_logits, inv)
  args = (root.embedding.contiguous(), logits, root.value.contiguous(), spec)
  kw = dict(num_simulations=sims, discount=0.997, invalid_actions=inv,
            max_depth=max_depth)
  before = (fused.launches, fused.categorical_launches)
  out = fused.fused_muzero_search(*args, **kw)
  torch.cuda.synchronize()
  assert (fused.launches, fused.categorical_launches) == (before[0],
                                                          before[1] + 1)
  _compare(out, fused.fused_muzero_search_reference(*args, **kw), sims)
  if inv is not None:
    assert float(out[0][inv > 0].abs().max()) == 0.0


@pytest.mark.parametrize("A,widths,B,sims,invalid,max_depth", [
    (2, BENCH, 256, 32, False, None),
    (2, BENCH, 512, 64, False, None),
    (3, SMALL, 203, 16, True, 2),
] + PAST_SMEM)
def test_gumbel_mode_matches_plain(cuda, A, widths, B, sims, invalid,
                                   max_depth):
  root, spec, inv, gen = _search_inputs(cuda, A, widths, B, invalid)
  logits = _mask_invalid(root.prior_logits, inv).contiguous()
  gumbel = gumbel_noise(gen, (B, A), cuda)
  score, schedule = fused.gumbel_root_inputs(
      logits, gumbel, inv, max_num_considered_actions=16,
      num_simulations=sims)
  args = (root.embedding.contiguous(), logits, root.value.contiguous(), spec)
  kw = dict(num_simulations=sims, discount=0.997, invalid_actions=inv,
            max_depth=max_depth)
  before = fused.categorical_gumbel_launches
  out = fused.fused_gumbel_search(*args, gumbel=gumbel,
                                  max_num_considered_actions=16, **kw)
  torch.cuda.synchronize()
  assert fused.categorical_gumbel_launches == before + 1
  ref = fused.fused_gumbel_search_reference(*args, root_score=score,
                                            schedule=schedule, **kw)
  _compare(out, ref, sims)
  action, _ = fused.gumbel_action(out[0], out[2], gumbel, logits, inv)
  ref_action, _ = fused.gumbel_action(ref[0], ref[2], gumbel, logits, inv)
  assert float((action == ref_action).float().mean()) >= 0.99


@pytest.mark.parametrize("A,widths,B,sims,invalid,max_depth", PAST_SMEM)
def test_trees_past_shared_memory_go_to_scratch(cuda, A, widths, B, sims,
                                                invalid, max_depth):
  net_widths = [widths["num_bins"], *widths["layer_sizes"] * 2]
  plan = fused.tiled_plan(B, A, widths["embedding_dim"], sims, net_widths,
                          fused.device_limits(cuda))
  assert not plan.smem_trees


def _batch(device, A, B, K, seed=0):
  gen = torch.Generator(device=device).manual_seed(seed)
  lengths = torch.randint(1, K + 1, (B,), generator=gen, device=device)
  return Transition(
      obs=torch.randn((B, K, 4), generator=gen, device=device),
      action=torch.randint(0, A, (B, K), generator=gen, device=device),
      reward=torch.randn((B, K), generator=gen, device=device) * 3,
      done=torch.zeros((B, K), dtype=torch.bool, device=device),
      rn=torch.randn((B, K), generator=gen, device=device) * 40,
      value=torch.zeros((B, K), device=device),
      pi=torch.softmax(torch.randn((B, K, A), generator=gen, device=device),
                       -1),
      weight=torch.rand((B,), generator=gen, device=device) + 0.5,
      mask=(torch.arange(K, device=device)[None] < lengths[:, None]).float())


@pytest.mark.parametrize("A,widths,B,K", [
    (3, SMALL, 100, 5),
    (2, BENCH, 1024, 5),  # the wide towers of bench.py's categorical runs
    (2, BENCH, 300, 5),   # a batch the last block does not fill
])
def test_learner_matches_plain(cuda, A, widths, B, K):
  net = make_categorical_mlp_networks(A, device=cuda, **widths)
  params = net.init_params((4,), torch.Generator().manual_seed(1))
  raw, coef, lay = fused_learner.raw_from_batch(_batch(cuda, A, B, K), K)
  spec = fused_learner.extract_categorical_learner_spec(net, params)
  before = fused_learner.categorical_launches
  grads, metrics = fused_learner.fused_muzero_grad_raw(
      params, raw, coef, lay, net, spec, **KW)
  again, _ = fused_learner.fused_muzero_grad_raw(params, raw, coef, lay, net,
                                                 spec, **KW)
  torch.cuda.synchronize()
  assert fused_learner.categorical_launches == before + 2
  assert torch.equal(grads, again)
  ref_grads, ref = fused_learner.fused_muzero_grad_raw_reference(
      params, raw, coef, lay, net, **KW)
  torch.testing.assert_close(grads, ref_grads, rtol=5e-4, atol=1e-6)
  torch.testing.assert_close(metrics.total, ref.total, rtol=1e-5, atol=0)
  torch.testing.assert_close(metrics.priorities, ref.priorities, rtol=1e-4,
                             atol=1e-6)
