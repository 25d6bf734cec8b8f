"""The Gumbel mode of the fused search's CUDA kernel against its plain
PyTorch version, on the card. Every test here needs a CUDA card (and
``nvcc`` to build the kernel) and skips without one; the file imports
nothing of the JAX package, so it runs on a machine with a card:

  python -m pytest tests/test_torch_fused_gumbel_kernel.py -m gpu -q

Checks as in ``tests/test_fused.py``: visits sum to the simulation count,
at most 2 visits apart, root value and completed q rtol = atol = 1e-3 where
the visits agree. A score tie that f32 rounding (the kernel contracts
multiply-adds into FMAs) breaks the other way moves a visit. The launches
of 8192 trees of 400 simulations or 18 actions may have at most 8 envs whose
value or q are further off, for the reason and with the evidence that
``test_torch_fused_search_kernel`` gives (``assert_matches_plain``); the
wide towers on masked roots as that file holds them
(``assert_matches_plain_masked``), with the policy's action the same on at
least 99 % of envs, as ``chip_smoke.py`` phases 22 and 30 hold it.
"""
import pytest
import torch

from muax_tpu_torch.envs import CartPole
from muax_tpu_torch.models import make_mlp_networks
from muax_tpu_torch.replay.buffer import gumbel_noise
from muax_tpu_torch.search import fused
from muax_tpu_torch.train.inference import make_root_fn
from test_torch_fused_search_kernel import (assert_matches_plain,
                                            assert_matches_plain_masked,
                                            wide_inputs)

pytestmark = pytest.mark.gpu
SUPPORT = 20


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the kernel has no CPU mode")
  return torch.device("cuda", torch.cuda.current_device())


def _inputs(device, num_actions, layers, batch, invalid_kind):
  net = make_mlp_networks(num_actions, embedding_dim=8, support_size=SUPPORT,
                          pred_layers=layers, dyn_layers=layers,
                          device=device)
  params = net.init_params((4,), torch.Generator().manual_seed(0))
  gen = torch.Generator(device=device).manual_seed(1)
  _, obs = CartPole().reset(gen, batch)
  with torch.no_grad():
    root = make_root_fn(net)(params, obs * 20)  # spread the roots
  logits = root.prior_logits
  invalid = None
  if invalid_kind == "one":
    pick = torch.randint(0, num_actions, (batch,), generator=gen,
                         device=device)
    invalid = torch.nn.functional.one_hot(pick, num_actions).float()
  elif invalid_kind == "all":
    invalid = torch.ones((batch, num_actions), device=device)
  if invalid is not None:
    logits = torch.where(invalid > 0, -1e9, logits)
  return ((root.embedding.contiguous(), logits.contiguous(),
           root.value.contiguous(), fused.extract_fused_weights(net, params)),
          invalid, gumbel_noise(gen, (batch, num_actions), device))


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


@pytest.mark.parametrize(
    "num_actions,layers,batch,sims,max_depth,invalid,m", [
        (2, (16,), 2048, 64, None, None, 16),
        (2, (16,), 1024, 64, None, None, 16),  # gumbel_training's envs
        (4, (16, 16), 1003, 40, 2, "one", 16),
        (5, (32,), 77, 17, None, "one", 4),
        (3, (16,), 64, 12, None, "all", 16),
    ])
def test_kernel_matches_plain(cuda, num_actions, layers, batch, sims,
                              max_depth, invalid, m):
  _run_and_compare(cuda, num_actions, layers, batch, sims, max_depth,
                   invalid, m)


@pytest.mark.parametrize("group", fused.MLP_GROUPS)
@pytest.mark.parametrize("smem_emb", [True, False])
def test_each_group_and_embedding_place(cuda, forced_plan, group, smem_emb):
  # Every instance the plan can pick, with the embeddings beside the trees
  # and in the device scratch; a ragged last block and a depth cap.
  forced_plan(group, smem_emb)
  _run_and_compare(cuda, 5, (16, 16), 1003, 40, 3, "one", 4)


@pytest.mark.parametrize("num_actions,sims", [(18, 64), (2, 400)])
def test_large_trees_take_whole_warps(cuda, num_actions, sims):
  # Trees so large that the card cannot hold 8192 at once: the plan takes
  # G = 32, one environment a warp.
  net_args, _, _ = _inputs(cuda, num_actions, (16,), 8192, None)
  emb, logits, _, weights = net_args
  widths = [2 * SUPPORT + 1] + [w.shape[1] for w, _ in (
      *weights.dyn_hidden, *weights.pred_hidden)]
  plan = fused.mlp_search_plan(8192, num_actions, emb.shape[1], sims,
                               weights.flat().numel(), widths, True,
                               fused.device_limits(cuda))
  assert plan.group == 32
  _run_and_compare(cuda, num_actions, (16,), 8192, sims, None, None, 16,
                   apart=8)


def _run_and_compare(cuda, num_actions, layers, batch, sims, max_depth,
                     invalid, m, apart=0):
  args, invalid, gumbel = _inputs(cuda, num_actions, layers, batch, invalid)
  kwargs = dict(num_simulations=sims, support_size=SUPPORT, discount=0.997,
                invalid_actions=invalid, max_depth=max_depth)
  root_score, schedule = fused.gumbel_root_inputs(
      args[1], gumbel, invalid, max_num_considered_actions=m,
      num_simulations=sims)
  before = (fused.launches, fused.gumbel_launches)
  out = fused.fused_gumbel_search(
      *args, gumbel=gumbel, max_num_considered_actions=m, **kwargs)
  torch.cuda.synchronize()
  assert (fused.launches, fused.gumbel_launches) == (before[0],
                                                     before[1] + 1)
  ref = fused.fused_gumbel_search_reference(
      *args, root_score=root_score, schedule=schedule, **kwargs)
  assert_matches_plain(out, ref, sims, apart)
  visits = out[0]
  if invalid is not None and not bool(invalid.all()):
    assert float(visits[invalid > 0].abs().max()) == 0.0
  if invalid is not None and bool(invalid.all()):
    # No root score is eligible: every simulation takes action 0.
    assert bool((visits[:, 0] == sims).all())


@pytest.mark.parametrize("batch", [64, 1024])
def test_wide_towers_read_from_device_memory(cuda, batch):
  # run_2048's triplet under legal masks: the tile kernel's Gumbel mode
  # (its towers resident at 64 boards, streamed at 1024); a repeated
  # launch gives the same bits.
  args, invalid, gen = wide_inputs(cuda, batch)
  gumbel = gumbel_noise(gen, (batch, 4), cuda)
  kwargs = dict(num_simulations=50, support_size=300, discount=0.999,
                invalid_actions=invalid, max_depth=None)
  root_score, schedule = fused.gumbel_root_inputs(
      args[1], gumbel, invalid, max_num_considered_actions=16,
      num_simulations=50)
  before, wide = fused.gumbel_launches, fused.wide_gumbel_launches
  out = fused.fused_gumbel_search(
      *args, gumbel=gumbel, max_num_considered_actions=16, **kwargs)
  again = fused.fused_gumbel_search(
      *args, gumbel=gumbel, max_num_considered_actions=16, **kwargs)
  torch.cuda.synchronize()
  assert (fused.gumbel_launches, fused.wide_gumbel_launches) == (
      before + 2, wide + 2)
  assert all(torch.equal(a, b) for a, b in zip(out, again))
  kwargs.update(root_score=root_score, schedule=schedule)
  ref = fused.fused_gumbel_search_reference(*args, **kwargs)
  assert_matches_plain_masked(out, ref, 50, invalid, args, kwargs)

  def act(res):  # the policy's action: max visits, then score + sigma(q)
    visits, _, cq = res
    score = torch.where(visits == visits.amax(-1, keepdim=True),
                        root_score + cq, -torch.inf)
    return torch.argmax(torch.where(invalid > 0, -torch.inf, score), -1)
  assert float((act(out) == act(ref)).float().mean()) >= 0.99


def test_wrapper_rejects_bad_schedule(cuda):
  args, _, gumbel = _inputs(cuda, 2, (16,), 64, None)
  kwargs = dict(num_simulations=8, support_size=SUPPORT, discount=0.997,
                invalid_actions=None, max_depth=None)
  root_score, schedule = fused.gumbel_root_inputs(
      args[1], gumbel, None, max_num_considered_actions=16,
      num_simulations=8)
  with pytest.raises(ValueError, match="schedule"):
    fused._fused_search_cuda(*args, root_score=root_score,
                             schedule=schedule[:, :4].contiguous(), **kwargs)
  with pytest.raises(ValueError, match="root_score"):
    fused._fused_search_cuda(*args, root_score=root_score.double(),
                             schedule=schedule, **kwargs)
