"""The Stochastic MuZero forest kernel (``csrc/fused_smz.cu``) and the
sampler kernel's ``per_step_obs`` mode against their plain PyTorch versions,
on the card. Every test here needs a CUDA card (and ``nvcc`` to build the
kernels) and skips without one; the file imports nothing of the JAX package:

  python -m pytest tests/test_torch_smz_kernels.py -m gpu -q

Search: the decision visits sum to the simulation count, at least 99 % of
envs are within 2 visits of the plain version (a score tie that f32
rounding breaks the other way moves a visit, and the subtree differs from
then on), their root values within rtol = atol = 1e-3, and where the visits
agree exactly the decision q too. Sampler: where both pick the same start,
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


def _search_inputs(device, B, A, C, E, hidden, support, with_invalid,
                   seed=0):
  net = make_stochastic_mlp_networks(A, num_chance_outcomes=C,
                                     embedding_dim=E, support_size=support,
                                     hidden=hidden, device=device)
  params = net.init_params((4,), torch.Generator().manual_seed(seed))
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


@pytest.mark.parametrize("B,sims,A,C,E,hidden,with_invalid,max_depth", [
    (256, 200, 2, 32, 32, (64,), False, None),  # bench.py's smz_mlp
    (37, 64, 3, 4, 8, (16,), True, 2),          # edge: masks, depth cap
    (100, 50, 4, 8, 16, (24, 16), True, None),  # two hidden layers
])
def test_smz_kernel_matches_plain(cuda, B, sims, A, C, E, hidden,
                                  with_invalid, max_depth):
  args, invalid = _search_inputs(cuda, B, A, C, E, hidden, 20, with_invalid)
  kwargs = dict(num_simulations=sims, support_size=20, discount=0.997,
                invalid_actions=invalid, max_depth=max_depth)
  before = fused.smz_launches
  visits, value, q = fused.fused_smz_search(*args, **kwargs)
  torch.cuda.synchronize()
  assert fused.smz_launches == before + 1
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
