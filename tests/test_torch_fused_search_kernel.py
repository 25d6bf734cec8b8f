"""The fused search's CUDA kernel against its plain PyTorch version, on the
card. Every test here needs a CUDA card (and ``nvcc`` to build the kernel)
and skips without one; the file imports nothing of the JAX package, so it
runs on a machine with a card:

  python -m pytest tests/test_torch_fused_search_kernel.py -m gpu -q

Checks as in ``tests/test_fused.py``: visits sum to the simulation count,
every env at most 2 visits apart, root value rtol = atol = 1e-3, and root q
the same where the visits agree. A score tie that f32 rounding (the kernel
contracts multiply-adds into FMAs) breaks the other way moves a visit. The
wide towers of ``examples/run_2048.py`` on masked roots are held as
``chip_smoke.py`` holds masked launches (phase 22's rule, the near-ties
shown by phase 21's ``tie_proof``: ``assert_matches_plain_masked``).

The launches of 8192 trees of 400 simulations or 18 actions are held to the
same, except that at most 8 envs (0.1 %) may have their value or q further
off: below the root a near-tie that the two float32 versions break apart
moves a subtree without moving the root's visits. On these inputs one env
of the 8192 does so in two of the four cases, and the one-warp-per-env
kernel, whose rounding this kernel keeps, gives the same outputs bit for
bit (``tools/kernel_split.py --against`` on the older checkout).
"""
import pytest
import torch

from muax_tpu_torch.envs import CartPole
from muax_tpu_torch.models import make_mlp_networks
from muax_tpu_torch.search import fused
from muax_tpu_torch.train.inference import make_root_fn

pytestmark = pytest.mark.gpu
SUPPORT = 20


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the kernel has no CPU mode")
  return torch.device("cuda", torch.cuda.current_device())


def _inputs(device, num_actions, layers, batch, with_invalid):
  net = make_mlp_networks(num_actions, embedding_dim=8, support_size=SUPPORT,
                          pred_layers=layers, dyn_layers=layers,
                          device=device)
  params = net.init_params((4,), torch.Generator().manual_seed(0))
  gen = torch.Generator(device=device).manual_seed(1)
  _, obs = CartPole().reset(gen, batch)
  invalid = None
  with torch.no_grad():
    root = make_root_fn(net)(params, obs * 20)  # spread the roots
  logits = root.prior_logits
  if with_invalid:
    pick = torch.randint(0, num_actions, (batch,), generator=gen,
                         device=device)
    invalid = torch.nn.functional.one_hot(pick, num_actions).float()
    logits = torch.where(invalid > 0, -1e9, logits)
  return ((root.embedding.contiguous(), logits.contiguous(),
           root.value.contiguous(), fused.extract_fused_weights(net, params)),
          invalid)


@pytest.fixture
def forced_plan(monkeypatch):
  """Fix the launch plan's G and the embeddings' place."""
  chosen = fused.mlp_search_plan

  def force(group, smem_emb):
    def plan(*args, **kwargs):
      return chosen(*args, group=group, **kwargs)._replace(
          smem_emb=smem_emb)
    monkeypatch.setattr(fused, "mlp_search_plan", plan)
  return force


def assert_matches_plain(out, ref, sims, apart=0):
  """Kernel against plain as the module says: visits sum to ``sims``, every
  env within 2 visits, root values within rtol = atol = 1e-3, and root q
  the same where the visits agree; on at most ``apart`` envs the value or q
  may be further off."""
  visits, value, q = out
  ref_visits, ref_value, ref_q = ref
  assert bool((visits.sum(-1) == sims).all())
  assert bool(torch.isfinite(q).all())
  assert float((visits - ref_visits).abs().max()) <= 2
  same = (visits == ref_visits).all(-1)
  if apart:
    off = ~torch.isclose(value, ref_value, rtol=1e-3, atol=1e-3) | (
        same & ~torch.isclose(q, ref_q, rtol=1e-3, atol=1e-3).all(-1))
    assert int(off.sum()) <= apart
  else:
    torch.testing.assert_close(value, ref_value, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(q[same], ref_q[same], rtol=1e-3, atol=1e-3)


def assert_matches_plain_masked(out, ref, sims, invalid, args, kwargs):
  """Kernel against plain on masked roots of the wide towers, by phase 22's
  rule (``chip_smoke.compare_masked_search``): visits sum to ``sims`` and
  miss every invalid action, every env within 2 visits, and the root
  value within rtol = atol = 1e-3 on at least 99 % of envs, where every
  other env with the same visits is a near-tie that rounding breaks,
  shown by ``chip_smoke.tie_proof`` (phase 21's proof: one-ulp nudges of
  its root embedding and of the weights move it past the tolerance in the
  kernel or the plain version, or the plain version in f32 and f64
  disagree on it, where the launch ran or, with the kernel's values
  within tolerance of that run, on the CPU). ``args`` and ``kwargs`` are
  the launch's, as ``fused._fused_search_cuda`` takes them. The towers' 256-input sums
  round apart in the kernel (input by input) and in the plain version
  (torch's products), so a tie below a root breaks differently on about
  one env in a thousand of these random boards, which an ulp of the root
  embedding alone (phase 22's proof) does not always move."""
  from chip_smoke import outside, tie_proof

  visits, value, q = out
  ref_visits, ref_value, _ = ref
  assert bool((visits.sum(-1) == sims).all())
  assert bool(torch.isfinite(q).all())
  assert float(visits[invalid > 0].abs().max()) == 0.0
  dv = (visits - ref_visits).abs().amax(-1)
  assert float(dv.max()) <= 2
  off = outside(value, ref_value)
  assert float(off.float().mean()) <= 0.01
  idx = torch.nonzero(off & (dv == 0))[:, 0]
  if len(idx):
    assert bool(tie_proof(args, kwargs, out)(idx).all()), idx


def _run_and_compare(args, invalid, sims, max_depth, apart=0):
  kwargs = dict(num_simulations=sims, support_size=SUPPORT, discount=0.997,
                invalid_actions=invalid, max_depth=max_depth)
  before = fused.launches
  out = fused.fused_muzero_search(*args, **kwargs)
  torch.cuda.synchronize()
  assert fused.launches == before + 1
  ref = fused.fused_muzero_search_reference(*args, **kwargs)
  assert_matches_plain(out, ref, sims, apart)
  if invalid is not None:
    assert float(out[0][invalid > 0].abs().max()) == 0.0


def _plan(cuda, args, sims):
  emb, logits, _, weights = args
  widths = [2 * SUPPORT + 1] + [w.shape[1] for w, _ in (
      *weights.dyn_hidden, *weights.pred_hidden)]
  return fused.mlp_search_plan(emb.shape[0], logits.shape[1], emb.shape[1],
                               sims, weights.flat().numel(), widths, False,
                               fused.device_limits(cuda))


@pytest.mark.parametrize("num_actions,layers,batch,sims,max_depth,invalid", [
    (2, (16,), 2048, 64, None, False),
    (2, (16,), 1024, 64, None, False),   # training_regime's envs
    (4, (16, 16), 1003, 40, 2, True),
    (3, (32,), 77, 17, None, True),
])
def test_kernel_matches_plain(cuda, num_actions, layers, batch, sims,
                              max_depth, invalid):
  args, invalid = _inputs(cuda, num_actions, layers, batch, invalid)
  _run_and_compare(args, invalid, sims, max_depth)


@pytest.mark.parametrize("group", fused.MLP_GROUPS)
@pytest.mark.parametrize("smem_emb", [True, False])
def test_each_group_and_embedding_place(cuda, forced_plan, group, smem_emb):
  # Every instance the plan can pick, with the embeddings beside the trees
  # and in the device scratch; a ragged last block and a depth cap.
  forced_plan(group, smem_emb)
  args, invalid = _inputs(cuda, 3, (16, 16), 1003, True)
  _run_and_compare(args, invalid, 40, 3)


@pytest.mark.parametrize("num_actions,sims", [(18, 64), (2, 400)])
def test_large_trees_take_whole_warps(cuda, num_actions, sims):
  # Trees so large that the card cannot hold 8192 at once: the plan takes
  # G = 32, one environment a warp.
  args, _ = _inputs(cuda, num_actions, (16,), 8192, False)
  assert _plan(cuda, args, sims).group == 32
  _run_and_compare(args, None, sims, None, apart=8)


def wide_inputs(device, batch, seed=0):
  """Roots of examples/run_2048.py's triplet (A = 4, embedding 64, support
  300, towers (256, 256): 1.97 MB of search weights, past a block's shared
  memory) on random 4 x 4 boards of tile exponents, and a random legal
  mask a row with at least one legal move, as the 2048 pool gives."""
  net = make_mlp_networks(4, embedding_dim=64, support_size=300,
                          repr_layers=(256, 256), pred_layers=(256, 256),
                          dyn_layers=(256, 256), device=device)
  params = net.init_params((4, 4), torch.Generator().manual_seed(seed))
  gen = torch.Generator(device=device).manual_seed(seed + 1)
  boards = torch.randint(0, 12, (batch, 4, 4), generator=gen,
                         device=device).float()
  legal = (torch.rand((batch, 4), generator=gen, device=device) < 0.7).float()
  legal[torch.arange(batch, device=device),
        torch.randint(0, 4, (batch,), generator=gen, device=device)] = 1.0
  invalid = 1.0 - legal
  with torch.no_grad():
    root = make_root_fn(net)(params, boards)
  logits = torch.where(invalid > 0, -1e9, root.prior_logits)
  return ((root.embedding.contiguous(), logits.contiguous(),
           root.value.contiguous(), fused.extract_fused_weights(net, params)),
          invalid, gen)


def wide_plan(cuda, batch, gumbel=False):
  """The plan the wrapper takes for run_2048's towers on ``batch`` roots."""
  index = cuda.index if cuda.index is not None else 0
  return fused.mlp_search_plan(batch, 4, 64, 50, 492278,
                               [601, 256, 256, 256, 256], gumbel,
                               fused.device_limits(cuda),
                               clusters=fused.wide_active_clusters(index))


@pytest.fixture
def forced_wide(monkeypatch):
  """Fix the tile kernel's instance (tile rows, cluster blocks)."""
  def force(tile, cluster):
    only = [i for i in fused.WIDE_INSTANCES if i[:2] == (tile, cluster)]
    monkeypatch.setattr(fused, "WIDE_INSTANCES", tuple(only))

    def plan(batch, A, E, sims, n_weights, widths, gumbel, limits, **kw):
      return fused.wide_search_plan(batch, A, E, sims, widths[0],
                                    *kw["towers"], gumbel, limits,
                                    kw["clusters"])
    monkeypatch.setattr(fused, "mlp_search_plan", plan)
  return force


@pytest.mark.parametrize("batch", [64, 1024])
def test_wide_towers_read_from_device_memory(cuda, batch):
  # run_2048's 64 boards (and 1024) x 50 simulations: no block stages the
  # whole towers, so the tile kernel runs (at 64 boards its blocks keep
  # their shares resident, at 1024 they stream them), held to the plain
  # version as the other cases are; a repeated launch gives the same bits.
  args, invalid, _ = wide_inputs(cuda, batch)
  kwargs = dict(num_simulations=50, support_size=300, discount=0.999,
                invalid_actions=invalid, max_depth=None)
  plan = wide_plan(cuda, batch)
  assert isinstance(plan, fused.WidePlan)
  assert plan.resident == (batch == 64)
  before, wide = fused.launches, fused.wide_launches
  out = fused.fused_muzero_search(*args, **kwargs)
  again = fused.fused_muzero_search(*args, **kwargs)
  torch.cuda.synchronize()
  assert (fused.launches, fused.wide_launches) == (before + 2, wide + 2)
  assert all(torch.equal(a, b) for a, b in zip(out, again))
  ref = fused.fused_muzero_search_reference(*args, **kwargs)
  assert_matches_plain_masked(out, ref, 50, invalid, args, kwargs)


@pytest.mark.parametrize("tile,cluster", [(16, 16), (48, 4)])
def test_each_wide_instance(cuda, forced_wide, tile, cluster):
  # Every instance of the tile kernel, resident (16 x 16) or streaming its
  # share of the towers through the ring (48 x 4, whose trees lie in the
  # device scratch), on 64 boards and a ragged 77, with a depth cap.
  forced_wide(tile, cluster)
  for batch, depth in ((64, None), (77, 3)):
    args, invalid, _ = wide_inputs(cuda, batch, seed=batch)
    kwargs = dict(num_simulations=50, support_size=300, discount=0.999,
                  invalid_actions=invalid, max_depth=depth)
    out = fused.fused_muzero_search(*args, **kwargs)
    ref = fused.fused_muzero_search_reference(*args, **kwargs)
    assert_matches_plain_masked(out, ref, 50, invalid, args, kwargs)


@pytest.mark.parametrize("batch", [64, 1024])
@pytest.mark.parametrize("gumbel", [False, True])
def test_wide_plan_agrees_with_the_kernel(cuda, batch, gumbel):
  # The plan's layout is the kernel's own (mz_wide_layout), its count of
  # clusters the card holds at once the runtime's
  # (cudaOccupancyMaxActiveClusters for the compiled instance), and every
  # tile of run_2048's 64 and 1024 boards is resident in one wave.
  plan = wide_plan(cuda, batch, gumbel)
  lay = fused.wide_plan_layout(plan, 4, 64, 601, 50, (256, 256), (256, 256))
  assert fused.wide_kernel_layout(plan, batch, 4, 64, 601, 50, (256, 256),
                                  (256, 256)) == (
      plan.smem_bytes, lay.rank_floats, lay.bias_floats, lay.n_pieces,
      lay.slot_floats)
  assert lay.smem_bytes == plan.smem_bytes
  index = cuda.index if cuda.index is not None else 0
  lib = fused._load_kernel()
  import ctypes
  out = ctypes.c_int(0)
  assert lib.mz_wide_active_clusters(int(gumbel), plan.tile, plan.cluster,
                                     plan.smem_bytes, index,
                                     ctypes.byref(out)) == 0
  assert plan.active_clusters == out.value > 0
  assert plan.one_wave


def test_wrapper_rejects_bad_inputs(cuda):
  (emb, logits, value, weights), _ = _inputs(cuda, 2, (16,), 64, False)
  kwargs = dict(num_simulations=8, support_size=SUPPORT, discount=0.997)
  with pytest.raises(ValueError, match="float32"):
    fused.fused_muzero_search(emb.double(), logits, value, weights, **kwargs)
  with pytest.raises(ValueError, match="contiguous"):
    fused.fused_muzero_search(
        torch.cat([emb, emb], 1)[:, ::2], logits, value, weights, **kwargs)
  with pytest.raises(ValueError, match="shape"):
    fused.fused_muzero_search(emb, logits, value[:10], weights, **kwargs)
  with pytest.raises(ValueError, match="support size"):
    fused.fused_muzero_search(emb, logits, value, weights,
                              num_simulations=8, support_size=10,
                              discount=0.997)
  # One env's tree of 20,000 nodes does not fit a block's shared memory,
  # in any launch plan.
  with pytest.raises(RuntimeError, match="do not fit"):
    fused.fused_muzero_search(emb, logits, value, weights,
                              num_simulations=20000, support_size=SUPPORT,
                              discount=0.997)
