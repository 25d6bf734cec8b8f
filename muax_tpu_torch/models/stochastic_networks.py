"""The Stochastic MuZero five-network set
(``muax_tpu/models/stochastic_networks.py``).

encoder:        obs [B, ...] -> chance-code logits [B, C]
representation: obs -> min-max normalized state [B, E]
prediction:     state -> (policy_logits [B, A], value_logits [B, 2S+1])
decision:       (state, action [B]) -> (normalized afterstate [B, E],
                                        chance_logits [B, C],
                                        afterstate_value_logits [B, 2S+1])
chance:         (afterstate, code [B, C]) -> (normalized next state [B, E],
                                             reward_logits [B, 2S+1])

Every tower is ELU hidden layers and linear heads, registered in haiku's
creation order, which the converter (``models/convert.py``) and the fused
search's weight extraction rely on: decision is hidden..., afterstate,
chance, value; chance is hidden..., state, reward; prediction is hidden...,
policy, value (the policy head before the value head, the opposite of the
MLP triplet). Linear layers start as haiku's do.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from muax_tpu_torch.device import resolve_device
from muax_tpu_torch.models.networks import _elu_stack, _haiku_linears, _linear
from muax_tpu_torch.ops import min_max_normalize


class MLPTower(nn.Module):
  """ELU hidden layers from ``in_dim`` and one linear head per
  ``head_dims`` entry on the last hidden activation."""

  def __init__(self, in_dim: int, hidden: Sequence[int],
               head_dims: Sequence[int], generator=None):
    super().__init__()
    self.hidden, width = _elu_stack(in_dim, hidden, generator)
    self.heads = nn.ModuleList(_linear(width, d, generator)
                               for d in head_dims)

  def linears(self):
    """Linear layers in haiku's creation order."""
    return [*self.hidden, *self.heads]

  def haiku_modules(self):
    return _haiku_linears(self.linears())

  def forward(self, x: torch.Tensor):
    for layer in self.hidden:
      x = F.elu(layer(x))
    return tuple(head(x) for head in self.heads)


class Encoder(MLPTower):

  def forward(self, obs: torch.Tensor) -> torch.Tensor:
    return super().forward(obs.flatten(1))[0]


class Representation(MLPTower):

  def forward(self, obs: torch.Tensor) -> torch.Tensor:
    return min_max_normalize(super().forward(obs.flatten(1))[0])


class Prediction(MLPTower):
  """-> (policy_logits, value_logits)."""


class Decision(MLPTower):

  def __init__(self, embedding_dim, num_actions, *args, **kwargs):
    super().__init__(embedding_dim + num_actions, *args, **kwargs)
    self.num_actions = num_actions

  def forward(self, s: torch.Tensor, a: torch.Tensor):
    sa = torch.cat([s, F.one_hot(a.long(), self.num_actions).to(s.dtype)],
                   -1)
    afterstate, chance_logits, value_logits = super().forward(sa)
    return min_max_normalize(afterstate), chance_logits, value_logits


class Chance(MLPTower):

  def forward(self, afterstate: torch.Tensor, code: torch.Tensor):
    next_state, reward_logits = super().forward(
        torch.cat([afterstate, code], -1))
    return min_max_normalize(next_state), reward_logits


class SMZParams(nn.Module):
  """The five towers plus the actor temperature (a buffer, outside the
  optimizer's parameters), the counterpart of the JAX package's
  ``SMZParams``."""

  TOWERS = ("encoder", "representation", "prediction", "decision", "chance")

  def __init__(self, encoder: nn.Module, representation: nn.Module,
               prediction: nn.Module, decision: nn.Module, chance: nn.Module,
               temperature: float = 1.0):
    super().__init__()
    self.encoder = encoder
    self.representation = representation
    self.prediction = prediction
    self.decision = decision
    self.chance = chance
    self.register_buffer("temperature",
                         torch.tensor(temperature, dtype=torch.float32))


@dataclasses.dataclass(frozen=True)
class SMZNetworks:
  """Architecture of the dense five-network set; ``init_params`` builds
  its modules."""
  num_actions: int
  num_chance_outcomes: int
  support_size: int
  embedding_dim: int
  hidden: Tuple[int, ...]
  device: torch.device

  @property
  def full_support(self) -> int:
    return 2 * self.support_size + 1

  def init_params(self, observation_shape: Sequence[int],
                  generator: Optional[torch.Generator] = None) -> SMZParams:
    """Fresh modules on ``self.device``, drawn from a CPU ``generator``."""
    obs_dim = math.prod(observation_shape)
    E, A, C, S = (self.embedding_dim, self.num_actions,
                  self.num_chance_outcomes, self.full_support)
    h, g = self.hidden, generator
    params = SMZParams(
        Encoder(obs_dim, h, (C,), g),
        Representation(obs_dim, h, (E,), g),
        Prediction(E, h, (A, S), g),
        Decision(E, A, h, (E, C, S), g),
        Chance(E + C, h, (E, S), g))
    return params.to(self.device)


def straight_through_code(encoder_logits: torch.Tensor) -> torch.Tensor:
  """One-hot of the argmax with a straight-through gradient, in the JAX
  package's arithmetic: probs + sg(one_hot - probs)."""
  probs = torch.softmax(encoder_logits, -1)
  quantized = F.one_hot(torch.argmax(encoder_logits, -1),
                        encoder_logits.shape[-1]).to(encoder_logits.dtype)
  return probs + (quantized - probs).detach()


def make_stochastic_mlp_networks(
    num_actions: int,
    num_chance_outcomes: int = 32,
    embedding_dim: int = 32,
    support_size: int = 20,
    hidden: Sequence[int] = (64,),
    device="cuda",
) -> SMZNetworks:
  """The dense SMZ set; defaults as in the JAX package."""
  return SMZNetworks(num_actions=num_actions,
                     num_chance_outcomes=num_chance_outcomes,
                     support_size=support_size, embedding_dim=embedding_dim,
                     hidden=tuple(hidden), device=resolve_device(device))
