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


def _setup(device, A, repr_layers, layers, support, B, K, seed=0):
  net = make_mlp_networks(A, embedding_dim=8, support_size=support,
                          repr_layers=repr_layers, pred_layers=layers,
                          dyn_layers=layers, device=device)
  params = net.init_params((4,), torch.Generator().manual_seed(seed))
  gen = torch.Generator(device=device).manual_seed(seed)
  lengths = torch.randint(1, K + 1, (B,), generator=gen, device=device)
  batch = Transition(
      obs=torch.randn((B, K, 4), generator=gen, device=device),
      action=torch.randint(0, A, (B, K), generator=gen, device=device),
      reward=torch.randn((B, K), generator=gen, device=device),
      done=torch.zeros((B, K), dtype=torch.bool, device=device),
      rn=torch.randn((B, K), generator=gen, device=device) * 5,
      value=torch.zeros((B, K), device=device),
      pi=torch.softmax(torch.randn((B, K, A), generator=gen, device=device),
                       -1),
      weight=torch.rand((B,), generator=gen, device=device) + 0.5,
      mask=(torch.arange(K, device=device)[None] < lengths[:, None]).float())
  return net, params, batch


def check_close(grads, metrics, ref_grads, ref_metrics):
  torch.testing.assert_close(grads, ref_grads, rtol=2e-4, atol=1e-6)
  for name in ("total", "reward_loss", "value_loss", "policy_loss",
               "l2_loss"):
    torch.testing.assert_close(getattr(metrics, name),
                               getattr(ref_metrics, name), rtol=1e-5,
                               atol=0, msg=name)
  torch.testing.assert_close(metrics.priorities, ref_metrics.priorities,
                             rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("A,repr_layers,layers,support,B,K", [
    (2, (16,), (16,), 20, 4096, 5),     # the training regime
    (4, (16,), (16, 16), 10, 1000, 5),  # an edge shape
    (3, (), (12,), 5, 77, 3),
    # The CartPole notebook towers: too wide for eight warps per block.
    (2, (), (64, 64, 16), 20, 256, 11),
])
def test_raw_mode_matches_plain(cuda, A, repr_layers, layers, support, B, K):
  net, params, batch = _setup(cuda, A, repr_layers, layers, support, B, K)
  raw, coef, lay = fused_learner.raw_from_batch(batch, K)
  lw = fused_learner.extract_learner_weights(net, params)
  before = fused_learner.launches
  grads, metrics = fused_learner.fused_muzero_grad_raw(
      params, raw, coef, lay, net, lw, **KW)
  again, _ = fused_learner.fused_muzero_grad_raw(params, raw, coef, lay, net,
                                                 lw, **KW)
  torch.cuda.synchronize()
  assert fused_learner.launches == before + 2
  assert torch.equal(grads, again)
  ref = fused_learner.fused_muzero_grad_raw_reference(params, raw, coef, lay,
                                                      net, **KW)
  check_close(grads, metrics, *ref)


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
