"""AlphaZero-style policy/value networks, no learned dynamics
(``muax_tpu/models/az_networks.py``): the search walks the real game and the
network evaluates its leaves. The value head is a tanh scalar in [-1, 1],
the two-player outcome convention.

``network(obs [B, ...]) -> (policy_logits [B, A], value [B])``. The conv
tower takes plane observations [B, H, W, P] as the games give them (NHWC)
and runs in NCHW; it flattens in NHWC order, as haiku does, so the heads'
weights carry over unchanged. Modules are registered in haiku's creation
order and ``haiku_modules()`` names them as haiku does, for
``models/convert.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from muax_tpu_torch.device import resolve_device
from muax_tpu_torch.models.networks import (ResidualConvBlock,
                                            _haiku_linears, _linear, conv3x3)


class AZParams(nn.Module):
  """The network and the actor temperature (a buffer)."""

  def __init__(self, network: nn.Module, temperature: float = 1.0):
    super().__init__()
    self.network = network
    self.register_buffer("temperature",
                         torch.tensor(temperature, dtype=torch.float32))


class AZMLP(nn.Module):
  """Flatten -> relu linears -> policy logits and a tanh value."""

  def __init__(self, obs_dim: int, num_actions: int, hidden: Sequence[int],
               generator=None):
    super().__init__()
    self.hidden = nn.ModuleList()
    width = obs_dim
    for size in hidden:
      self.hidden.append(_linear(width, size, generator))
      width = size
    self.policy = _linear(width, num_actions, generator)
    self.value = _linear(width, 1, generator)

  def haiku_modules(self):
    return _haiku_linears([*self.hidden, self.policy, self.value])

  def forward(self, obs: torch.Tensor):
    h = obs.flatten(1).to(torch.float32)
    for layer in self.hidden:
      h = F.relu(layer(h))
    return self.policy(h), torch.tanh(self.value(h))[:, 0]


class AZResNet(nn.Module):
  """A 3x3 conv stem, ``num_blocks`` residual blocks, relu, then a policy
  linear and a 64-wide relu value tower on the NHWC-flattened planes."""

  def __init__(self, observation_shape: Tuple[int, int, int],
               num_actions: int, channels: int, num_blocks: int,
               generator=None):
    super().__init__()
    height, width, planes = observation_shape
    self.stem = conv3x3(planes, channels, generator)
    self.blocks = nn.ModuleList(
        ResidualConvBlock(channels, generator=generator)
        for _ in range(num_blocks))
    flat = height * width * channels
    self.policy = _linear(flat, num_actions, generator)
    self.value_hidden = _linear(flat, 64, generator)
    self.value = _linear(64, 1, generator)

  def haiku_modules(self):
    mods = [("conv2_d", self.stem)]
    for i, block in enumerate(self.blocks):
      mods += [(f"block_{i}/{name}", m) for name, m in block.haiku_modules()]
    return mods + _haiku_linears([self.policy, self.value_hidden,
                                  self.value])

  def forward(self, obs: torch.Tensor):
    h = self.stem(obs.to(torch.float32).permute(0, 3, 1, 2))
    for block in self.blocks:
      h = block(h)
    flat = F.relu(h).permute(0, 2, 3, 1).flatten(1)
    value = torch.tanh(self.value(F.relu(self.value_hidden(flat))))
    return self.policy(flat), value[:, 0]


@dataclasses.dataclass(frozen=True)
class AZNetwork:
  """An AlphaZero network's architecture; ``init_params`` builds it.

  ``build(observation_shape, generator)`` makes the network module.
  """
  build: Callable[..., nn.Module]
  num_actions: int
  device: torch.device

  def init_params(self, observation_shape: Sequence[int],
                  generator: Optional[torch.Generator] = None) -> AZParams:
    """Fresh modules on ``self.device``, drawn from a CPU ``generator``."""
    return AZParams(self.build(tuple(observation_shape), generator)).to(
        self.device)

  def apply(self, params: AZParams, obs: torch.Tensor):
    return params.network(obs)


def make_az_mlp(num_actions: int, hidden: Sequence[int] = (128, 128),
                device="cuda") -> AZNetwork:
  return AZNetwork(
      build=lambda shape, gen: AZMLP(math.prod(shape), num_actions,
                                     tuple(hidden), gen),
      num_actions=num_actions, device=resolve_device(device))


def make_az_resnet(num_actions: int, channels: int = 64, num_blocks: int = 4,
                   device="cuda") -> AZNetwork:
  """The conv tower for plane observations [B, H, W, P] (the Go resnet
  shape at a configurable width and depth)."""
  return AZNetwork(
      build=lambda shape, gen: AZResNet(shape, num_actions, channels,
                                        num_blocks, gen),
      num_actions=num_actions, device=resolve_device(device))
