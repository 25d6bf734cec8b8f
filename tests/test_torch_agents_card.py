"""The agents' ``update`` on the card against the same update on the CPU.
Every test here needs a CUDA card and skips without one; the file imports
nothing of the JAX package:

  python -m pytest tests/test_torch_agents_card.py -m gpu -q

From the same parameters, optimizer state and numpy batch (Diffusion
MuZero: the same injected flow-matching draws), one step of
``create_optimizer("adam", 1e-3)`` gives parameters within rtol 1e-4 /
atol 1e-6 on the card and on the CPU, and the same loss at rtol 1e-5, with
TF32 off. No kernel of the port serves the agents: these are autograd and
the generic engine on each device.
"""
import numpy as np
import pytest
import torch

from muax_tpu_torch.agents import DiffusionMuZero, MuZero, StochasticMuZero
from muax_tpu_torch.models import (create_optimizer,
                                   make_diffusion_mlp_networks,
                                   make_mlp_networks,
                                   make_stochastic_mlp_networks)
from muax_tpu_torch.types import Transition

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  yield torch.device("cuda", torch.cuda.current_device())
  torch.backends.cuda.matmul.allow_tf32 = matmul
  torch.backends.cudnn.allow_tf32 = cudnn


def batch(seed, B=64, L=6, A=2):
  rng = np.random.default_rng(seed)
  mask = (np.arange(L)[None] < rng.integers(2, L + 1, B)[:, None])
  return Transition(
      obs=rng.standard_normal((B, L, 4)).astype(np.float32),
      action=rng.integers(0, A, (B, L)).astype(np.int32),
      reward=rng.standard_normal((B, L)).astype(np.float32),
      done=np.zeros((B, L), bool),
      rn=(rng.standard_normal((B, L)) * 3).astype(np.float32),
      value=np.zeros((B, L), np.float32),
      pi=rng.dirichlet(np.ones(A), (B, L)).astype(np.float32),
      weight=(rng.uniform(size=B) + 0.5).astype(np.float32),
      mask=mask.astype(np.float32))


def twin_agents(make_agent, make_net, device):
  """An agent on the CPU and one on ``device`` with the same parameters."""
  cpu = make_agent(make_net("cpu"))
  cpu.init(0, np.zeros((1, 4), np.float32))
  card = make_agent(make_net(device))
  params = card.networks.init_params((4,))
  params.load_state_dict(cpu.params.state_dict())
  card.init(None, np.zeros((1, 4), np.float32), params=params)
  return cpu, card


def assert_same_step(cpu, card, data, cpu_kwargs=None, card_kwargs=None):
  loss_cpu = cpu.update(data, **(cpu_kwargs or {}))
  loss_card = card.update(data, **(card_kwargs or {}))
  np.testing.assert_allclose(loss_card, loss_cpu, rtol=1e-5)
  for (name, a), b in zip(cpu.params.named_parameters(),
                          card.params.parameters()):
    np.testing.assert_allclose(b.detach().cpu().numpy(), a.detach().numpy(),
                               rtol=1e-4, atol=1e-6, err_msg=name)


def test_muzero_update_on_the_card_matches_the_cpu(cuda):
  cpu, card = twin_agents(
      lambda net: MuZero(net, optimizer=create_optimizer("adam", 1e-3),
                         unroll_steps=6),
      lambda dev: make_mlp_networks(2, embedding_dim=10, support_size=20,
                                    repr_layers=(), pred_layers=(64, 64, 16),
                                    dyn_layers=(64, 64, 16), device=dev),
      cuda)
  assert_same_step(cpu, card, batch(0))


def test_stochastic_update_on_the_card_matches_the_cpu(cuda):
  cpu, card = twin_agents(
      lambda net: StochasticMuZero(
          net, optimizer=create_optimizer("adam", 1e-3), unroll_steps=6),
      lambda dev: make_stochastic_mlp_networks(2, device=dev), cuda)
  assert_same_step(cpu, card, batch(1))


def test_diffusion_update_on_the_card_matches_the_cpu(cuda):
  cpu, card = twin_agents(
      lambda net: DiffusionMuZero(
          net, optimizer=create_optimizer("adam", 1e-3), unroll_steps=6),
      lambda dev: make_diffusion_mlp_networks(2, device=dev), cuda)
  g = torch.Generator().manual_seed(2)
  draws = [(torch.rand(64, generator=g), torch.randn(64, 16, generator=g))
           for _ in range(5)]
  assert_same_step(cpu, card, batch(2), cpu_kwargs=dict(draws=draws),
                   card_kwargs=dict(draws=[(t.to(cuda), e.to(cuda))
                                           for t, e in draws]))
