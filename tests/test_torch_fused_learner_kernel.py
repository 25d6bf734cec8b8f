"""The fused learner's CUDA kernel against its plain PyTorch version
(autograd over ``muzero_loss``), on the card. Every test here needs a CUDA
card (and ``nvcc`` to build the kernel) and skips without one; the file
imports nothing of the JAX package:

  python -m pytest tests/test_torch_fused_learner_kernel.py -m gpu -q

Tolerances: gradients rtol 2e-4 / atol 1e-6 and loss metrics rtol 1e-5, as
the JAX kernel's tests; the kernel sums the batch in another order than
autograd, which these cover. Priorities rtol 1e-4 / atol 1e-4: they are
|v0 - rn0|^0.5, and v0 is h^-1 of a 2S+1-bin expectation, which amplifies
f32 rounding to about 1e-4 at |v0| ~ 10. Two launches on the same inputs
must give bit-identical gradients (no float atomics).
"""
import copy

import pytest
import torch

from muax_tpu_torch.models import fused_learner, make_mlp_networks
from muax_tpu_torch.types import Transition

pytestmark = pytest.mark.gpu
KW = dict(l2_coef=1e-4, gradient_scale=0.5, priority_alpha=0.5)


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the kernel has no CPU mode")
  torch.backends.cuda.matmul.allow_tf32 = False
  return torch.device("cuda", torch.cuda.current_device())


def _setup(device, A, repr_layers, layers, support, B, K, seed=0, E=8,
           obs_dim=4, rn_scale=5.0):
  net = make_mlp_networks(A, embedding_dim=E, support_size=support,
                          repr_layers=repr_layers, pred_layers=layers,
                          dyn_layers=layers, device=device)
  params = net.init_params((obs_dim,), torch.Generator().manual_seed(seed))
  gen = torch.Generator(device=device).manual_seed(seed)
  lengths = torch.randint(1, K + 1, (B,), generator=gen, device=device)
  batch = Transition(
      obs=torch.randn((B, K, obs_dim), generator=gen, device=device),
      action=torch.randint(0, A, (B, K), generator=gen, device=device),
      reward=torch.randn((B, K), generator=gen, device=device),
      done=torch.zeros((B, K), dtype=torch.bool, device=device),
      rn=torch.randn((B, K), generator=gen, device=device) * rn_scale,
      value=torch.zeros((B, K), device=device),
      pi=torch.softmax(torch.randn((B, K, A), generator=gen, device=device),
                       -1),
      weight=torch.rand((B,), generator=gen, device=device) + 0.5,
      mask=(torch.arange(K, device=device)[None] < lengths[:, None]).float())
  return net, params, batch


def check_close(grads, metrics, ref_grads, ref_metrics, priorities=True):
  torch.testing.assert_close(grads, ref_grads, rtol=2e-4, atol=1e-6)
  for name in ("total", "reward_loss", "value_loss", "policy_loss",
               "l2_loss"):
    torch.testing.assert_close(getattr(metrics, name),
                               getattr(ref_metrics, name), rtol=1e-5,
                               atol=0, msg=name)
  if priorities:
    torch.testing.assert_close(metrics.priorities, ref_metrics.priorities,
                               rtol=1e-4, atol=1e-4)


# Every (A, repr_layers, layers, support, B, K) the kernel is held at here;
# tests/test_torch_kernel_sizing.py checks that the launch plan takes each.
RAW_MODE_CASES = [
    (2, (16,), (16,), 20, 4096, 5),     # the training regime
    (4, (16,), (16, 16), 10, 1000, 5),  # an edge shape
    (3, (), (12,), 5, 77, 3),
    # The CartPole notebook towers: their arena lies in the device scratch.
    (2, (), (64, 64, 16), 20, 256, 11),
    # Batches that are not a multiple of the 16-window tile.
    (2, (16,), (16,), 20, 1, 5),
    (2, (16,), (16,), 20, 4097, 5),
    # A last dynamics width over 112: the first step of the dynamics'
    # backward leaves no warp idle, and the prediction tower's weight
    # gradients wait for the last pass.
    (2, (), (128,), 20, 300, 5),
]


def poison_scratch(lw, B, K, device):
  """Leaves NaN in the memory that the launch's scratch (the blocks'
  rows of weight gradients) is handed next: the caching allocator gives a
  freed block of the same size back first. A row the kernel leaves
  unwritten then shows in the gradients."""
  plan = fused_learner.mlp_learner_plan(B, K, lw,
                                        fused_learner.device_limits(device))
  torch.full((plan.scratch_floats,), float("nan"), device=device)


def hold_against_plain(cuda, net, params, batch, B, K, priorities=True):
  """Two launches on the batch's raw rows: bit-identical, and close to
  the plain version; returns the kernel's metrics and the plain
  version's."""
  raw, coef, lay = fused_learner.raw_from_batch(batch, K)
  lw = fused_learner.extract_learner_weights(net, params)
  before = fused_learner.launches
  poison_scratch(lw, B, K, cuda)
  grads, metrics = fused_learner.fused_muzero_grad_raw(
      params, raw, coef, lay, net, lw, **KW)
  poison_scratch(lw, B, K, cuda)
  again, _ = fused_learner.fused_muzero_grad_raw(params, raw, coef, lay, net,
                                                 lw, **KW)
  torch.cuda.synchronize()
  assert fused_learner.launches == before + 2
  assert torch.equal(grads, again)
  ref = fused_learner.fused_muzero_grad_raw_reference(params, raw, coef, lay,
                                                      net, **KW)
  check_close(grads, metrics, *ref, priorities=priorities)
  return metrics, ref[1]


@pytest.mark.parametrize("A,repr_layers,layers,support,B,K", RAW_MODE_CASES)
def test_raw_mode_matches_plain(cuda, A, repr_layers, layers, support, B, K):
  net, params, batch = _setup(cuda, A, repr_layers, layers, support, B, K)
  hold_against_plain(cuda, net, params, batch, B, K)


# Embedding 32. Here the priorities of the windows whose v0 lies near z
# stand up to 2.65 of the priority check's tolerance (1e-4) from a float64
# run of the plain version, in the plain version as in the kernel
# (tools/kernel_split.py priority_probe), so that the two float32 results
# may stand more than it apart. The priorities are held against float64
# instead, at a tolerance both float32 results are held to.
EMBEDDING_32_CASE = (3, (16,), (24,), 10, 300, 4)


@pytest.mark.parametrize("seed", range(4))
def test_raw_mode_matches_plain_at_embedding_32(cuda, seed):
  net, params, batch = _setup(cuda, *EMBEDDING_32_CASE, seed=seed, E=32)
  metrics, plain = hold_against_plain(cuda, net, params, batch,
                                      *EMBEDDING_32_CASE[4:],
                                      priorities=False)
  raw, coef, lay = fused_learner.raw_from_batch(batch, EMBEDDING_32_CASE[5])
  _, exact = fused_learner.fused_muzero_grad_raw_reference(
      copy.deepcopy(params).double(), raw.double(), coef.double(), lay, net,
      **KW)
  for got in (metrics.priorities, plain.priorities):
    torch.testing.assert_close(got.double(), exact.priorities, rtol=3e-4,
                               atol=3e-4)


# examples/run_2048.py's triplet: A = 4, embedding 64, support 300 (601
# bins), towers (256, 256) in all three nets, 16 observation features, at
# its batch 256 and unroll 5: 2.3 MB of weights, which the cluster pass
# stages from device memory a chunk at a time (the plan's cluster is 8: 8
# blocks a tile of 16 windows), then the weight-gradient pass over every
# tile.
WIDE_CASE = dict(A=4, repr_layers=(256, 256), layers=(256, 256), support=300,
                 B=256, K=5)


def test_wide_towers_read_from_device_memory(cuda):
  import ctypes
  net, params, batch = _setup(cuda, **WIDE_CASE, E=64, obs_dim=16,
                              rn_scale=50.0)
  lw = fused_learner.extract_learner_weights(net, params)
  plan = fused_learner.mlp_learner_plan(256, 5, lw,
                                        fused_learner.device_limits(cuda))
  assert (plan.smem_arena, plan.smem_bytes) == (
      False, fused_learner.LEARNER_CLUSTER_SMEM)
  assert (plan.cluster, plan.blocks) == (8, 128)
  # The plan's blocks an SM are the runtime's for the compiled cluster
  # pass, and the card holds every cluster of the launch at once.
  assert fused_learner.learner_blocks_per_sm(plan, cuda) == plan.blocks_per_sm
  assert fused_learner.learner_active_clusters(plan, cuda) >= 16
  wide = fused_learner.wide_launches
  lib = fused_learner._load_kernel()
  out = (ctypes.c_long * 2)()
  towers = fused_learner._widths(fused_learner._shapes(lw)[:3])
  assert lib.mz_mlp_learner_floats(16, 64, 4, 601, 5, *towers, out) == 0
  assert (out[0], out[1]) == fused_learner.mlp_learner_floats(lw, 5)[1:]
  assert lib.mz_learner_cluster_smem_bytes() == plan.smem_bytes
  hold_against_plain(cuda, net, params, batch, 256, 5)
  assert fused_learner.wide_launches == wide + 2


def test_batch_mode_and_column_blocks(cuda):
  """Batch mode packs into raw rows; raw mode reads a column block of a
  wider group tensor."""
  net, params, batch = _setup(cuda, 2, (16,), (16,), 20, 512, 5)
  lw = fused_learner.extract_learner_weights(net, params)
  grads, metrics = fused_learner.fused_muzero_grad(params, batch, net, lw,
                                                   **KW)
  check_close(grads, metrics, *fused_learner.fused_muzero_grad_reference(
      params, batch, net, **KW))
  raw, coef, lay = fused_learner.raw_from_batch(batch, 5)
  wide = torch.cat([torch.zeros_like(raw), raw], 1)
  block, _ = fused_learner.fused_muzero_grad_raw(
      params, wide[:, 512:], coef, lay, net, lw, **KW)
  assert torch.equal(block, grads)


@pytest.mark.parametrize("layers,K,smem_arena", [((16,), 5, True),
                                                 ((64, 64, 16), 11, False),
                                                 ((128,), 5, False)])
def test_plan_agrees_with_the_kernel(cuda, layers, K, smem_arena):
  """The launch plan's shared memory and scratch are the kernel's own
  (``mz_mlp_learner_floats``), and a launch that disagrees is refused."""
  import ctypes
  net, params, batch = _setup(cuda, 2, (), layers, 20, 64, K)
  lw = fused_learner.extract_learner_weights(net, params)
  plan = fused_learner.mlp_learner_plan(64, K, lw,
                                        fused_learner.device_limits(cuda))
  assert plan.smem_arena == smem_arena
  n_weights, weights, arena = fused_learner.mlp_learner_floats(lw, K)
  lib = fused_learner._load_kernel()
  out = (ctypes.c_long * 2)()
  towers = fused_learner._widths(fused_learner._shapes(lw)[:3])
  assert lib.mz_mlp_learner_floats(4, 8, 2, 41, K, *towers, out) == 0
  assert (out[0], out[1]) == (weights, arena)
  assert n_weights == lw.flat.numel()
  # The plan's blocks an SM are the runtime's (which counts the compiled
  # instance's registers, as ptxas gave them).
  assert fused_learner.learner_blocks_per_sm(plan, cuda) == plan.blocks_per_sm
  raw, coef, lay = fused_learner.raw_from_batch(batch, K)
  wrong = plan._replace(smem_bytes=plan.smem_bytes + 4)
  chosen = fused_learner.mlp_learner_plan
  fused_learner.mlp_learner_plan = lambda *a: wrong
  try:
    with pytest.raises(RuntimeError, match="do not fit"):
      fused_learner.fused_muzero_grad_raw(params, raw, coef, lay, net, lw,
                                          **KW)
  finally:
    fused_learner.mlp_learner_plan = chosen
