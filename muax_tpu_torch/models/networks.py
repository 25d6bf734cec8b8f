"""The MuZero MLP triplet (``muax_tpu/models/networks.py``, MLP family).

representation: obs [B, ...] -> min-max normalized embedding [B, E]
prediction:     embedding -> (policy_logits [B, A], value_logits [B, 2S+1])
dynamic:        (embedding, action [B]) -> (reward_logits [B, 2S+1],
                                            normalized next embedding)

Layer order follows the JAX package's creation order, which the parameter
converter (``models/convert.py``) and the fused search rely on: prediction
is hidden layers, value head, policy head; dynamic is hidden layers on
concat(s, one_hot(a)), reward head, next-state head. Linear layers start as
haiku's do: truncated normal weights with std 1/sqrt(fan_in) cut at two
standard deviations, and zero biases.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from muax_tpu_torch.device import resolve_device
from muax_tpu_torch.ops import min_max_normalize


def _linear(in_dim: int, out_dim: int,
            generator: Optional[torch.Generator]) -> nn.Linear:
  layer = nn.Linear(in_dim, out_dim)
  std = 1.0 / math.sqrt(in_dim)
  with torch.no_grad():
    nn.init.trunc_normal_(layer.weight, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    layer.bias.zero_()
  return layer


def _haiku_linears(linears):
  """(haiku name, module) for linears in creation order."""
  return [("linear" if i == 0 else f"linear_{i}", layer)
          for i, layer in enumerate(linears)]


def _elu_stack(in_dim: int, sizes: Sequence[int],
               generator) -> Tuple[nn.ModuleList, int]:
  layers = nn.ModuleList()
  for size in sizes:
    layers.append(_linear(in_dim, size, generator))
    in_dim = size
  return layers, in_dim


class Representation(nn.Module):

  def __init__(self, obs_dim: int, embedding_dim: int, layers: Sequence[int],
               generator=None):
    super().__init__()
    self.hidden, width = _elu_stack(obs_dim, layers, generator)
    self.embedding = _linear(width, embedding_dim, generator)

  def linears(self):
    """Linear layers in haiku's creation order."""
    return [*self.hidden, self.embedding]

  def haiku_modules(self):
    return _haiku_linears(self.linears())

  def forward(self, obs: torch.Tensor) -> torch.Tensor:
    h = obs.flatten(1)
    for layer in self.hidden:
      h = F.elu(layer(h))
    return min_max_normalize(self.embedding(h))


class Prediction(nn.Module):

  def __init__(self, embedding_dim: int, num_actions: int, full_support: int,
               layers: Sequence[int], generator=None):
    super().__init__()
    self.hidden, width = _elu_stack(embedding_dim, layers, generator)
    self.value = _linear(width, full_support, generator)
    self.policy = _linear(width, num_actions, generator)

  def linears(self):
    """Linear layers in haiku's creation order."""
    return [*self.hidden, self.value, self.policy]

  def haiku_modules(self):
    return _haiku_linears(self.linears())

  def forward(self, s: torch.Tensor):
    h = s
    for layer in self.hidden:
      h = F.elu(layer(h))
    return self.policy(h), self.value(h)


class Dynamic(nn.Module):

  def __init__(self, embedding_dim: int, num_actions: int, full_support: int,
               layers: Sequence[int], generator=None):
    super().__init__()
    self.num_actions = num_actions
    self.hidden, width = _elu_stack(embedding_dim + num_actions, layers,
                                    generator)
    self.reward = _linear(width, full_support, generator)
    self.state = _linear(width, embedding_dim, generator)

  def linears(self):
    """Linear layers in haiku's creation order."""
    return [*self.hidden, self.reward, self.state]

  def haiku_modules(self):
    return _haiku_linears(self.linears())

  def forward(self, s: torch.Tensor, a: torch.Tensor):
    h = torch.cat([s, F.one_hot(a.long(), self.num_actions).to(s.dtype)], -1)
    for layer in self.hidden:
      h = F.elu(layer(h))
    return self.reward(h), min_max_normalize(self.state(h))


class MZParams(nn.Module):
  """The triplet's modules plus the actor temperature (a buffer), the
  counterpart of the JAX package's ``MZParams``."""

  def __init__(self, representation: nn.Module, prediction: nn.Module,
               dynamic: nn.Module, temperature: float = 1.0):
    super().__init__()
    self.representation = representation
    self.prediction = prediction
    self.dynamic = dynamic
    self.register_buffer("temperature",
                         torch.tensor(temperature, dtype=torch.float32))


@dataclasses.dataclass(frozen=True)
class MZNetworks:
  """Architecture of the MLP triplet; ``init_params`` builds its modules."""
  num_actions: int
  support_size: int
  embedding_dim: int
  repr_layers: Tuple[int, ...]
  pred_layers: Tuple[int, ...]
  dyn_layers: Tuple[int, ...]
  device: torch.device

  @property
  def full_support(self) -> int:
    return 2 * self.support_size + 1

  def init_params(self, observation_shape: Sequence[int],
                  generator: Optional[torch.Generator] = None) -> MZParams:
    """Fresh modules on ``self.device``, drawn from a CPU ``generator``."""
    obs_dim = math.prod(observation_shape)
    params = MZParams(
        Representation(obs_dim, self.embedding_dim, self.repr_layers,
                       generator),
        Prediction(self.embedding_dim, self.num_actions, self.full_support,
                   self.pred_layers, generator),
        Dynamic(self.embedding_dim, self.num_actions, self.full_support,
                self.dyn_layers, generator))
    return params.to(self.device)


def make_mlp_networks(
    num_actions: int,
    embedding_dim: int = 8,
    support_size: int = 10,
    repr_layers: Sequence[int] = (16,),
    pred_layers: Sequence[int] = (16,),
    dyn_layers: Sequence[int] = (16,),
    device="cuda",
) -> MZNetworks:
  """Small dense triplet; defaults as in the JAX package (embed 8,
  support 10, hidden (16,))."""
  return MZNetworks(num_actions=num_actions, support_size=support_size,
                    embedding_dim=embedding_dim,
                    repr_layers=tuple(repr_layers),
                    pred_layers=tuple(pred_layers),
                    dyn_layers=tuple(dyn_layers),
                    device=resolve_device(device))
