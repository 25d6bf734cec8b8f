"""The Diffusion MuZero network set: continuous chance transitions through a
conditional rectified flow (``muax_tpu/models/diffusion_networks.py``).

representation: obs -> state [B, E]                       (min-max normalized)
prediction:     state -> (policy_logits [B, A], value_logits [B, 2S+1])
decision:       (state, action) -> (afterstate [B, E], av_logits [B, 2S+1])
velocity:       (x [B, E], t [B], afterstate [B, E]) -> dx/dt [B, E]
reward:         next_state [B, E] -> reward_logits [B, 2S+1]

The chance outcome is the next latent itself, drawn by integrating the
velocity field from the flow's prior (``models/diffusion.RectifiedFlow``);
the candidates are exchangeable, so the search gives them a uniform prior.
Every tower is ELU hidden layers and linear heads in haiku's creation
order: the hidden layers first, then the heads in call order (prediction:
policy, value; decision: afterstate, value), which ``models/convert.py``
relies on.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from muax_tpu_torch.device import resolve_device
from muax_tpu_torch.models.diffusion import RectifiedFlow, euler_integrate
from muax_tpu_torch.models.stochastic_networks import (MLPTower, Prediction,
                                                       Representation)
from muax_tpu_torch.ops import min_max_normalize


class Decision(MLPTower):
  """(state, action) -> (normalized afterstate, afterstate value logits)."""

  def __init__(self, embedding_dim, num_actions, *args, **kwargs):
    super().__init__(embedding_dim + num_actions, *args, **kwargs)
    self.num_actions = num_actions

  def forward(self, s: torch.Tensor, a: torch.Tensor):
    sa = torch.cat([s, F.one_hot(a.long(), self.num_actions).to(s.dtype)],
                   -1)
    afterstate, value_logits = super().forward(sa)
    return min_max_normalize(afterstate), value_logits


class Velocity(MLPTower):
  """(x, t, afterstate) -> velocity, on concat(x, t, afterstate)."""

  def forward(self, x: torch.Tensor, t: torch.Tensor, cond: torch.Tensor):
    return super().forward(torch.cat([x, t[..., None], cond], -1))[0]


class Reward(MLPTower):

  def forward(self, next_state: torch.Tensor) -> torch.Tensor:
    return super().forward(next_state)[0]


class DMZParams(nn.Module):
  """The five towers plus the actor temperature (a buffer, outside the
  optimizer's parameters), the counterpart of the JAX package's
  ``DMZParams``."""

  TOWERS = ("representation", "prediction", "decision", "velocity",
            "reward")

  def __init__(self, representation: nn.Module, prediction: nn.Module,
               decision: nn.Module, velocity: nn.Module, reward: nn.Module,
               temperature: float = 1.0):
    super().__init__()
    self.representation = representation
    self.prediction = prediction
    self.decision = decision
    self.velocity = velocity
    self.reward = reward
    self.register_buffer("temperature",
                         torch.tensor(temperature, dtype=torch.float32))


@dataclasses.dataclass(frozen=True)
class DMZNetworks:
  """Architecture of the dense diffusion set; ``init_params`` builds its
  modules on ``device``."""
  num_actions: int
  num_samples: int          # candidate next states per afterstate (C)
  support_size: int
  embedding_dim: int
  hidden: Tuple[int, ...]
  flow: RectifiedFlow
  device: torch.device

  @property
  def full_support(self) -> int:
    return 2 * self.support_size + 1

  def init_params(self, observation_shape: Sequence[int],
                  generator: Optional[torch.Generator] = None) -> DMZParams:
    """Fresh modules on ``self.device``, drawn from a CPU ``generator``."""
    obs_dim = math.prod(observation_shape)
    E, A, S = self.embedding_dim, self.num_actions, self.full_support
    h, g = self.hidden, generator
    params = DMZParams(
        Representation(obs_dim, h, (E,), g),
        Prediction(E, h, (A, S), g),
        Decision(E, A, h, (E, S), g),
        Velocity(2 * E + 1, h, (E,), g),
        Reward(E, h, (S,), g))
    return params.to(self.device)

  def velocity_fn(self, params: DMZParams):
    """The (x, t, cond) -> v closure of the flow's samplers and loss."""
    return params.velocity

  def sample_candidates(self, params: DMZParams,
                        generator: Optional[torch.Generator],
                        afterstate: torch.Tensor,
                        num_steps: Optional[int] = None, *,
                        prior: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """``num_samples`` next-state candidates an afterstate, by integrating
    the flow from its prior: [B, E] -> [B, C, E]. ``prior`` [B * C, E] (row
    b * C + c conditions on afterstate b), when given, replaces the draw
    from ``generator``."""
    B, E = afterstate.shape
    C = self.num_samples
    if prior is None:
      prior = self.flow.prior_sampling(generator, (B * C, E))
    cond = torch.repeat_interleave(afterstate, C, dim=0)          # [B*C, E]
    flat = euler_integrate(params.velocity, prior,
                           int(num_steps or self.flow.num_steps), cond)
    return min_max_normalize(flat).reshape(B, C, E)

  def mean_next_state(self, params: DMZParams,
                      afterstate: torch.Tensor) -> torch.Tensor:
    """The conditional-mean next state, one velocity read at (x = 0,
    t = 0): that point lies on the eps = 0 path of every pairing, where the
    regression target is x0 itself, so v(0, 0 | a) learns E[x0 | a]."""
    zeros = torch.zeros_like(afterstate)
    t0 = torch.zeros(afterstate.shape[0], dtype=afterstate.dtype,
                     device=afterstate.device)
    return min_max_normalize(params.velocity(zeros, t0, afterstate))


def make_diffusion_mlp_networks(
    num_actions: int,
    num_samples: int = 4,
    embedding_dim: int = 16,
    support_size: int = 20,
    hidden: Sequence[int] = (64,),
    sigma: float = 1.0,
    ode_steps: int = 8,
    device="cuda",
) -> DMZNetworks:
  """The dense diffusion set; defaults as in the JAX package."""
  return DMZNetworks(num_actions=num_actions, num_samples=num_samples,
                     support_size=support_size, embedding_dim=embedding_dim,
                     hidden=tuple(hidden),
                     flow=RectifiedFlow(sigma=sigma, num_steps=ode_steps),
                     device=resolve_device(device))
