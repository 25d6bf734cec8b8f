"""acme-style network families with linear two-hot heads
(``muax_tpu/models/acme_networks.py``).

* ``make_categorical_mlp_networks``: LayerNormMLP towers (the first layer
  Linear -> LayerNorm -> tanh, the rest Linear -> elu) with linear two-hot
  value and reward heads over ``num_bins`` bins spanning [vmin, vmax]
  (51 bins over +-150 by default).
* ``make_fc_resnet_networks``: a pre-LayerNorm fully-connected residual
  tower with a 0..600 two-hot support (601 bins).

Both give the triplet interface of ``networks.MZNetworks`` (representation,
prediction, dynamic); ``num_bins`` tells the loss and the inference which
head convention to use. Every module is registered in haiku's creation
order, so ``parameters()`` (and with it the flat parameter buffer of
``optimizers.flat_parameters``, which the learner kernel indexes) follows
it: a LayerNormMLP tower is linear, layer_norm, linear_1, ..., then its
heads. Prediction creates its policy head before its value head, the
opposite of the MLP family. ``haiku_modules()`` names each module as haiku
does, for the converters in ``models/convert.py``. Linear layers start as
haiku's do (truncated normal, std 1/sqrt(fan_in), zero bias), LayerNorms
with scale 1 and offset 0, eps 1e-5.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from muax_tpu_torch.device import resolve_device
from muax_tpu_torch.models.networks import MZParams, _linear
from muax_tpu_torch.ops import min_max_normalize

LN_EPS = 1e-5


def _layer_norm(width: int) -> nn.LayerNorm:
  return nn.LayerNorm(width, eps=LN_EPS)


def _names(mods) -> List[str]:
  """haiku's names for a flat sequence of modules: linear, linear_1, ...
  and layer_norm, layer_norm_1, ..., counted per kind."""
  counts = {}
  names = []
  for m in mods:
    kind = "layer_norm" if isinstance(m, nn.LayerNorm) else "linear"
    k = counts.get(kind, 0)
    names.append(kind if k == 0 else f"{kind}_{k}")
    counts[kind] = k + 1
  return names


class LayerNormMLPTower(nn.Module):
  """A LayerNormMLP trunk and its linear heads, in creation order."""

  def __init__(self, in_dim: int, layer_sizes: Sequence[int],
               head_dims: Sequence[int], generator=None):
    super().__init__()
    mods = []
    width = in_dim
    for i, size in enumerate(layer_sizes):
      mods.append(_linear(width, size, generator))
      if i == 0:
        mods.append(_layer_norm(size))
      width = size
    for dim in head_dims:
      mods.append(_linear(width, dim, generator))
    self.layers = nn.ModuleList(mods)
    self.num_hidden = len(layer_sizes)
    self.num_heads = len(head_dims)

  def haiku_modules(self) -> List[Tuple[str, nn.Module]]:
    return list(zip(_names(self.layers), self.layers))

  def hidden(self) -> List[Tuple[str, tuple]]:
    """The trunk as (kind, modules): ("ln_tanh", (linear, layer_norm)) for
    the first layer, ("elu", (linear,)) for the others."""
    out, mods = [], list(self.layers)
    if self.num_hidden:
      out.append(("ln_tanh", (mods[0], mods[1])))
      out += [("elu", (m,)) for m in mods[2:2 + self.num_hidden - 1]]
    return out

  def heads(self) -> List[nn.Linear]:
    return list(self.layers)[len(self.layers) - self.num_heads:]

  def trunk(self, x: torch.Tensor) -> torch.Tensor:
    for kind, mods in self.hidden():
      x = mods[0](x)
      x = torch.tanh(mods[1](x)) if kind == "ln_tanh" else F.elu(x)
    return x


class CategoricalRepresentation(nn.Module):

  def __init__(self, obs_dim, embedding_dim, layer_sizes, generator=None):
    super().__init__()
    self.tower = LayerNormMLPTower(obs_dim, layer_sizes, (embedding_dim,),
                                   generator)

  def haiku_modules(self):
    return self.tower.haiku_modules()

  def forward(self, obs: torch.Tensor) -> torch.Tensor:
    h = self.tower.trunk(obs.flatten(1))
    return min_max_normalize(self.tower.heads()[0](h))


class CategoricalPrediction(nn.Module):
  """Policy head first, then the value head (haiku's creation order)."""

  def __init__(self, embedding_dim, num_actions, num_bins, layer_sizes,
               generator=None):
    super().__init__()
    self.tower = LayerNormMLPTower(embedding_dim, layer_sizes,
                                   (num_actions, num_bins), generator)

  def haiku_modules(self):
    return self.tower.haiku_modules()

  def forward(self, s: torch.Tensor):
    h = self.tower.trunk(s)
    policy, value = self.tower.heads()
    return policy(h), value(h)


class CategoricalDynamic(nn.Module):

  def __init__(self, embedding_dim, num_actions, num_bins, layer_sizes,
               generator=None):
    super().__init__()
    self.num_actions = num_actions
    self.tower = LayerNormMLPTower(embedding_dim + num_actions, layer_sizes,
                                   (num_bins, embedding_dim), generator)

  def haiku_modules(self):
    return self.tower.haiku_modules()

  def forward(self, s: torch.Tensor, a: torch.Tensor):
    h = torch.cat([s, F.one_hot(a.long(), self.num_actions).to(s.dtype)], -1)
    h = self.tower.trunk(h)
    reward, state = self.tower.heads()
    return reward(h), min_max_normalize(state(h))


class PreLNResBlock(nn.Module):
  """x + Linear(elu(Linear(LayerNorm(x))))."""

  def __init__(self, width: int, generator=None):
    super().__init__()
    self.norm = _layer_norm(width)
    self.inner = _linear(width, width, generator)
    self.outer = _linear(width, width, generator)

  def haiku_modules(self, prefix: str):
    return [(f"{prefix}/layer_norm", self.norm),
            (f"{prefix}/linear", self.inner),
            (f"{prefix}/linear_1", self.outer)]

  def forward(self, x):
    return x + self.outer(F.elu(self.inner(self.norm(x))))


class FCResNetTower(nn.Module):
  """Linear(width), ``num_blocks`` pre-LN residual blocks, LayerNorm; then
  the heads (named linear_1, linear_2, ... after the input linear)."""

  def __init__(self, in_dim, width, num_blocks, head_dims, generator=None):
    super().__init__()
    self.input = _linear(in_dim, width, generator)
    self.blocks = nn.ModuleList(PreLNResBlock(width, generator)
                                for _ in range(num_blocks))
    self.norm = _layer_norm(width)
    self.head_layers = nn.ModuleList(_linear(width, d, generator)
                                     for d in head_dims)

  def haiku_modules(self):
    mods = [("linear", self.input)]
    for i, block in enumerate(self.blocks):
      mods += block.haiku_modules(f"block_{i}")
    mods.append(("layer_norm", self.norm))
    mods += [(f"linear_{i + 1}", m) for i, m in enumerate(self.head_layers)]
    return mods

  def forward(self, x):
    h = self.input(x)
    for block in self.blocks:
      h = block(h)
    return self.norm(h)


class FCResNetRepresentation(nn.Module):

  def __init__(self, obs_dim, embedding_dim, num_blocks, generator=None):
    super().__init__()
    self.tower = FCResNetTower(obs_dim, embedding_dim, num_blocks, (),
                               generator)

  def haiku_modules(self):
    return self.tower.haiku_modules()

  def forward(self, obs):
    return min_max_normalize(self.tower(obs.flatten(1)))


class FCResNetPrediction(nn.Module):

  def __init__(self, embedding_dim, num_actions, num_bins, generator=None):
    super().__init__()
    self.block = PreLNResBlock(embedding_dim, generator)
    self.policy = _linear(embedding_dim, num_actions, generator)
    self.value = _linear(embedding_dim, num_bins, generator)

  def haiku_modules(self):
    return self.block.haiku_modules("pred_block") + [
        ("linear", self.policy), ("linear_1", self.value)]

  def forward(self, s):
    h = self.block(s)
    return self.policy(h), self.value(h)


class FCResNetDynamic(nn.Module):

  def __init__(self, embedding_dim, num_actions, num_bins, num_blocks,
               generator=None):
    super().__init__()
    self.num_actions = num_actions
    self.tower = FCResNetTower(embedding_dim + num_actions, embedding_dim,
                               num_blocks, (num_bins, embedding_dim),
                               generator)

  def haiku_modules(self):
    return self.tower.haiku_modules()

  def forward(self, s, a):
    h = torch.cat([s, F.one_hot(a.long(), self.num_actions).to(s.dtype)], -1)
    h = self.tower(h)
    reward, state = self.tower.head_layers
    return reward(h), min_max_normalize(state(h))


@dataclasses.dataclass(frozen=True)
class CategoricalMZNetworks:
  """Architecture of an acme family (``family`` "mlp": LayerNormMLP towers
  of ``layer_sizes``; "fc_resnet": ``num_blocks`` residual blocks);
  ``init_params`` builds its modules."""
  num_actions: int
  num_bins: int
  vmin: float
  vmax: float
  embedding_dim: int
  family: str
  layer_sizes: Tuple[int, ...]
  num_blocks: int
  device: torch.device

  def init_params(self, observation_shape: Sequence[int],
                  generator: Optional[torch.Generator] = None) -> MZParams:
    """Fresh modules on ``self.device``, drawn from a CPU ``generator`` in
    the order representation, prediction, dynamic."""
    obs_dim = math.prod(observation_shape)
    E, A, bins = self.embedding_dim, self.num_actions, self.num_bins
    if self.family == "mlp":
      towers = (
          CategoricalRepresentation(obs_dim, E, self.layer_sizes, generator),
          CategoricalPrediction(E, A, bins, self.layer_sizes, generator),
          CategoricalDynamic(E, A, bins, self.layer_sizes, generator))
    else:
      towers = (
          FCResNetRepresentation(obs_dim, E, self.num_blocks, generator),
          FCResNetPrediction(E, A, bins, generator),
          FCResNetDynamic(E, A, bins, self.num_blocks, generator))
    return MZParams(*towers).to(self.device)


def make_categorical_mlp_networks(
    num_actions: int,
    embedding_dim: int = 64,
    num_bins: int = 51,
    vmin: float = -150.0,
    vmax: float = 150.0,
    layer_sizes: Sequence[int] = (256, 256, 256),
    device="cuda",
) -> CategoricalMZNetworks:
  """LayerNormMLP towers and linear two-hot heads (the JAX package's
  defaults: embedding 64, 51 bins over +-150, towers (256, 256, 256))."""
  return CategoricalMZNetworks(
      num_actions=num_actions, num_bins=num_bins, vmin=float(vmin),
      vmax=float(vmax), embedding_dim=embedding_dim, family="mlp",
      layer_sizes=tuple(layer_sizes), num_blocks=0,
      device=resolve_device(device))


def make_fc_resnet_networks(
    num_actions: int,
    embedding_dim: int = 256,
    num_bins: int = 601,
    vmin: float = 0.0,
    vmax: float = 600.0,
    num_blocks: int = 10,
    device="cuda",
) -> CategoricalMZNetworks:
  """The fully-connected residual tower with a 0..600 support (the 2048-style
  config). No kernel takes it: it runs the generic engine and learner."""
  return CategoricalMZNetworks(
      num_actions=num_actions, num_bins=num_bins, vmin=float(vmin),
      vmax=float(vmax), embedding_dim=embedding_dim, family="fc_resnet",
      layer_sizes=(), num_blocks=num_blocks, device=resolve_device(device))
