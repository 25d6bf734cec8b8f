"""The fused search's CUDA kernel against its plain PyTorch version, on the
card. Every test here needs a CUDA card (and ``nvcc`` to build the kernel)
and skips without one; the file imports nothing of the JAX package, so it
runs on a machine with a card:

  python -m pytest tests/test_torch_fused_search_kernel.py -m gpu -q

Checks as in ``tests/test_fused.py``: visits sum to the simulation count,
at most 2 visits apart, root value rtol = atol = 1e-3. A score tie that f32
rounding (the kernel contracts multiply-adds into FMAs) breaks the other way
moves a visit.
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


@pytest.mark.parametrize("num_actions,layers,batch,sims,max_depth,invalid", [
    (2, (16,), 2048, 64, None, False),
    (4, (16, 16), 1003, 40, 2, True),
    (3, (32,), 77, 17, None, True),
])
def test_kernel_matches_plain(cuda, num_actions, layers, batch, sims,
                              max_depth, invalid):
  args, invalid = _inputs(cuda, num_actions, layers, batch, invalid)
  kwargs = dict(num_simulations=sims, support_size=SUPPORT, discount=0.997,
                invalid_actions=invalid, max_depth=max_depth)
  before = fused.launches
  visits, value, q = fused.fused_muzero_search(*args, **kwargs)
  torch.cuda.synchronize()
  assert fused.launches == before + 1
  ref_visits, ref_value, _ = fused.fused_muzero_search_reference(*args,
                                                                 **kwargs)
  assert bool((visits.sum(-1) == sims).all())
  assert float((visits - ref_visits).abs().max()) <= 2
  torch.testing.assert_close(value, ref_value, rtol=1e-3, atol=1e-3)
  assert bool(torch.isfinite(q).all())
  if invalid is not None:
    assert float(visits[invalid > 0].abs().max()) == 0.0


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
  # One env's tree of 20,000 nodes does not fit a block's shared memory.
  with pytest.raises(RuntimeError, match="do not fit"):
    fused.fused_muzero_search(emb, logits, value, weights,
                              num_simulations=20000, support_size=SUPPORT,
                              discount=0.997)
