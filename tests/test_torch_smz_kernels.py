"""The Stochastic MuZero forest kernel (``csrc/fused_smz.cu``) and the
sampler kernel's ``per_step_obs`` mode against their plain PyTorch versions,
on the card. Every test here needs a CUDA card (and ``nvcc`` to build the
kernels) and skips without one; the file imports nothing of the JAX package:

  python -m pytest tests/test_torch_smz_kernels.py -m gpu -q

Search: the decision visits sum to the simulation count, at least 99 % of
envs are within 2 visits of the plain version (a score tie that f32
rounding breaks the other way moves a visit, and the subtree differs from
then on), their root values within rtol = atol = 1e-3, and where the visits
agree exactly the decision q too; a second launch gives the same bits. The
cases cover bench.py's smz_mlp widths at 256 and 512 envs (trees and
embeddings in shared memory), a deep-tree net (one action and one outcome
made to dominate, so that the simulations extend one chain) with and
without the depth cap, and trees that go to the device scratch (800
simulations, or 256 chance outcomes), whose memory is filled with NaN
before each launch; and the towers of examples/run_2048.py's widths (3.05
MB, read from device memory) on masked roots, held by the rule of
``chip_smoke.py``'s phase 33. Sampler: where both pick the same start,
every raw row is exactly equal (both copy the same values).
"""
import pytest
import torch

from muax_tpu_torch.models import make_stochastic_mlp_networks
from muax_tpu_torch.replay import fused_sampler, replay_add, replay_init
from muax_tpu_torch.replay.buffer import gumbel_noise
from muax_tpu_torch.search import fused
from muax_tpu_torch.train.inference import make_smz_fns
from muax_tpu_torch.types import Transition

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the kernel has no CPU mode")
  return torch.device("cuda", torch.cuda.current_device())


# Added to the first entry of the policy head's and of the chance head's
# bias: one action and one outcome dominate, and the trees grow chains.
DEEP_BIAS = 8.0


def _search_inputs(device, B, A, C, E, hidden, support, with_invalid,
                   seed=0, deep=False):
  net = make_stochastic_mlp_networks(A, num_chance_outcomes=C,
                                     embedding_dim=E, support_size=support,
                                     hidden=hidden, device=device)
  params = net.init_params((4,), torch.Generator().manual_seed(seed))
  if deep:
    with torch.no_grad():
      params.prediction.linears()[-2].bias[0] += DEEP_BIAS
      params.decision.linears()[-2].bias[0] += DEEP_BIAS
  gen = torch.Generator(device=device).manual_seed(seed)
  obs = torch.randn((B, 4), generator=gen, device=device)
  invalid = None
  if with_invalid:
    pick = torch.randint(0, A, (B,), generator=gen, device=device)
    invalid = torch.nn.functional.one_hot(pick, A).float()
  with torch.no_grad():
    root = make_smz_fns(net, 0.997)[0](params, obs)
  logits = fused.noised_root_logits(gen, root.prior_logits, invalid)
  return ((root.embedding.contiguous(), logits, root.value.contiguous(),
           fused.extract_smz_fused_weights(net, params)), invalid)


def _poison_scratch(args, kwargs):
  """Leaves NaN in the memory that the launch's scratch is handed next
  (the caching allocator gives a freed block of the same size back
  first), so that a tree or embedding the kernel reads before it writes
  shows in the outputs."""
  plan = fused.smz_launch_plan(args[0], args[3], **kwargs)
  n = args[0].shape[0] * plan.scratch_bytes
  if n:
    torch.full((n // 4,), float("nan"), device=args[0].device)
  return plan


@pytest.mark.parametrize(
    "B,sims,A,C,E,hidden,with_invalid,max_depth,deep", [
        (256, 200, 2, 32, 32, (64,), False, None, False),  # smz_mlp
        (512, 200, 2, 32, 32, (64,), False, None, False),  # two waves
        (64, 200, 2, 32, 32, (64,), False, None, True),    # deep trees
        (64, 200, 2, 32, 32, (64,), False, 32, True),      # ... capped
        (37, 64, 3, 4, 8, (16,), True, 2, False),   # edge: masks, depth cap
        (100, 50, 4, 8, 16, (24, 16), True, None, False),  # two layers
        (48, 800, 2, 32, 32, (64,), False, None, False),   # trees: scratch
        (64, 100, 3, 256, 16, (32,), True, None, False),   # wide C: scratch
        (64, 50, 18, 4, 16, (32,), True, None, False),     # lanes split A
    ])
def test_smz_kernel_matches_plain(cuda, B, sims, A, C, E, hidden,
                                  with_invalid, max_depth, deep):
  args, invalid = _search_inputs(cuda, B, A, C, E, hidden, 20, with_invalid,
                                 deep=deep)
  kwargs = dict(num_simulations=sims, support_size=20, discount=0.997,
                invalid_actions=invalid, max_depth=max_depth)
  before = fused.smz_launches
  plan = _poison_scratch(args, kwargs)
  visits, value, q = fused.fused_smz_search(*args, **kwargs)
  _poison_scratch(args, kwargs)
  again = fused.fused_smz_search(*args, **kwargs)
  torch.cuda.synchronize()
  assert fused.smz_launches == before + 2
  for a, b in zip((visits, value, q), again):
    assert torch.equal(a, b)
  assert plan.smem_tree == (sims <= 200 and C <= 32)
  ref_visits, ref_value, ref_q = fused.fused_smz_search_reference(*args,
                                                                  **kwargs)
  assert bool((visits.sum(-1) == sims).all())
  assert bool((ref_visits.sum(-1) == sims).all())
  dv = (visits - ref_visits).abs().amax(-1)
  near, exact = dv <= 2, dv == 0
  assert float(near.float().mean()) >= 0.99
  torch.testing.assert_close(value[near], ref_value[near], rtol=1e-3,
                             atol=1e-3)
  torch.testing.assert_close(q[exact], ref_q[exact], rtol=1e-3, atol=1e-3)
  if invalid is not None:
    assert float(visits[invalid > 0].abs().max()) == 0.0


def wide_smz_inputs(device, batch, seed=0):
  """Roots of Stochastic MuZero at examples/run_2048.py's widths (A = 4, 32
  chance outcomes, embedding 64, support 300, hidden (256, 256): 762,031
  floats of towers, past a block's shared memory) on random 4 x 4 boards
  of tile exponents, and a random legal mask a row with at least one legal
  move, as the 2048 pool gives; the logits masked with -1e9."""
  net = make_stochastic_mlp_networks(4, num_chance_outcomes=32,
                                     embedding_dim=64, support_size=300,
                                     hidden=(256, 256), device=device)
  params = net.init_params((4, 4), torch.Generator().manual_seed(seed))
  gen = torch.Generator(device=device).manual_seed(seed + 1)
  boards = torch.randint(0, 12, (batch, 4, 4), generator=gen,
                         device=device).float()
  legal = (torch.rand((batch, 4), generator=gen, device=device) < 0.7).float()
  legal[torch.arange(batch, device=device),
        torch.randint(0, 4, (batch,), generator=gen, device=device)] = 1.0
  invalid = 1.0 - legal
  with torch.no_grad():
    root = make_smz_fns(net, 0.999)[0](params, boards)
  logits = torch.where(invalid > 0, -1e9, root.prior_logits)
  return ((root.embedding.contiguous(), logits.contiguous(),
           root.value.contiguous(),
           fused.extract_smz_fused_weights(net, params)), invalid)


@pytest.mark.parametrize("batch", [64, 1024])
def test_wide_towers_read_from_device_memory(cuda, batch):
  # 64 boards (and 1024) x 200 simulations: the towers stay in device
  # memory (the plan's smem_weights is False), the trees in shared memory;
  # a repeated launch gives the same bits, and the outputs hold against
  # the plain version by phase 33's rule (chip_smoke.compare_masked_smz).
  from chip_smoke import compare_masked_smz

  args, invalid = wide_smz_inputs(cuda, batch)
  kwargs = dict(num_simulations=200, support_size=300, discount=0.999,
                invalid_actions=invalid, max_depth=None)
  plan = _poison_scratch(args, kwargs)
  assert not plan.smem_weights and plan.smem_tree
  before = fused.smz_launches
  out = fused.fused_smz_search(*args, **kwargs)
  _poison_scratch(args, kwargs)
  again = fused.fused_smz_search(*args, **kwargs)
  torch.cuda.synchronize()
  assert fused.smz_launches == before + 2
  for a, b in zip(out, again):
    assert torch.equal(a, b)
  assert bool(torch.isfinite(out[2]).all())
  compare_masked_smz(out, args, kwargs)


def test_smz_plan_agrees_with_the_kernel(cuda):
  """The plan's Python copy of an environment's layout against the
  kernel's own (``mz_smz_env_bytes``), and its blocks per SM against the
  CUDA runtime's count for the compiled kernel."""
  import ctypes
  lib = fused._load_smz_kernel()
  for A, C, E, bins, sims, depth, hidden in (
      (2, 32, 32, 41, 200, 200, 64), (3, 4, 8, 21, 64, 2, 16),
      (3, 256, 16, 41, 100, 100, 32), (4, 8, 16, 41, 50, 50, 24)):
    out = (ctypes.c_long * 3)()
    lib.mz_smz_env_bytes(A, C, E, bins, sims, depth, hidden, out)
    assert tuple(out) == fused.smz_env_bytes(A, C, E, bins, sims, depth,
                                             hidden)
  # Each instance: smz_mlp's towers staged with the trees in shared memory
  # (200 simulations) or in the scratch (800); the 2048 widths' towers in
  # device memory with the trees in shared memory (64 and 1024 boards) or
  # in the scratch (4000 simulations).
  args, _ = _search_inputs(cuda, 256, 2, 32, 32, (64,), 20, False)
  wide = {batch: wide_smz_inputs(cuda, batch)[0] for batch in (64, 1024)}
  for args, sims, smem_tree, smem_weights in (
      (args, 200, True, True), (args, 800, False, True),
      (wide[64], 200, True, False), (wide[1024], 200, True, False),
      (wide[64], 4000, False, False)):
    plan = fused.smz_launch_plan(args[0], args[3], num_simulations=sims)
    assert (plan.smem_tree, plan.smem_weights) == (smem_tree, smem_weights)
    assert fused.smz_blocks_per_sm(plan, cuda) == plan.blocks_per_sm, plan
  out = (ctypes.c_long * 3)()
  lib.mz_smz_env_bytes(4, 32, 64, 601, 200, 200, 256, out)
  assert tuple(out) == fused.smz_env_bytes(4, 32, 64, 601, 200, 200, 256)


def test_smz_wrapper_rejects_bad_inputs(cuda):
  (emb, logits, value, weights), _ = _search_inputs(cuda, 8, 2, 4, 8, (16,),
                                                    10, False)
  kwargs = dict(num_simulations=8, support_size=10, discount=0.99)
  with pytest.raises(ValueError, match="shape"):
    fused.fused_smz_search(emb, logits[:, :1].contiguous(), value, weights,
                           **kwargs)
  with pytest.raises(ValueError, match="contiguous"):
    fused.fused_smz_search(emb, logits.t().contiguous().t(), value, weights,
                           **kwargs)
  with pytest.raises(ValueError, match="support"):
    fused.fused_smz_search(emb, logits, value, weights, num_simulations=8,
                           support_size=5, discount=0.99)


def _ring(device, C, L, A, filled, seed=0):
  gen = torch.Generator(device=device).manual_seed(seed)

  def rand(*shape):
    return torch.rand(shape, generator=gen, device=device)

  state = replay_init(C, L, (4,), A, device=device)
  segs = Transition(
      obs=torch.randn((filled, L, 4), generator=gen, device=device),
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


@pytest.mark.parametrize("C,L,K,A,W,filled", [
    (2048, 20, 5, 2, 16384, 2048),   # smz_training's ring and group
    (64, 20, 5, 3, 1000, 32),        # a half-filled ring
])
def test_sampler_per_step_obs_matches_plain(cuda, C, L, K, A, W, filled):
  state, gen = _ring(cuda, C, L, A, filled)
  seg_idx = torch.randint(0, filled, (W,), generator=gen, device=cuda)
  gumbel = gumbel_noise(gen, (L, W), cuda)
  before = fused_sampler.launches
  raw, lay = fused_sampler.fused_sample_group(state, seg_idx, gumbel, K,
                                              per_step_obs=True)
  torch.cuda.synchronize()
  assert fused_sampler.launches == before + 1
  ref, ref_lay = fused_sampler.fused_sample_group_reference(
      state, seg_idx, gumbel, K, per_step_obs=True)
  assert lay == ref_lay and lay.obs_rows == 4 * K
  same = raw[lay.start] == ref[lay.start]
  assert float(same.float().mean()) >= 0.9999
  assert torch.equal(raw[:, same], ref[:, same])
