"""The categorical modes of the search kernel and the categorical learner
kernel against their plain PyTorch versions, on the card. Every test here
needs a CUDA card (and ``nvcc`` to build the kernels) and skips without one;
the file imports nothing of the JAX package:

  python -m pytest tests/test_torch_categorical_kernels.py -m gpu -q

Search: visits sum to the simulation count, at least 99 % of environments
within 2 visits of the plain version, and there root value and q within
rtol = atol = 1e-3 (``tests/test_fused.py:54-60``); Gumbel: the policy's
action on at least 99 % of environments. Learner: gradients rtol 5e-4 /
atol 1e-6, total rtol 1e-5, priorities rtol 1e-4
(``tests/test_fused_learner.py:156-162``), and two launches on the same
inputs give bit-identical gradients.
"""
import pytest
import torch

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


@pytest.mark.parametrize("A,widths,B,sims,invalid,max_depth", [
    (2, BENCH, 256, 32, False, None),
    (3, SMALL, 203, 16, True, 2),
])
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
    (3, SMALL, 203, 16, True, 2),
])
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
