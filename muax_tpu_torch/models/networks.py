"""The MuZero triplets (``muax_tpu/models/networks.py``): the MLP family,
and the conv families (EfficientZero and ResNet) with their residual block.

representation: obs [B, ...] -> min-max normalized embedding [B, E]
                (conv families: [B, C, h, w], normalized per map)
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
from typing import ClassVar, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from muax_tpu_torch.device import resolve_device
from muax_tpu_torch.ops import min_max_normalize, min_max_normalize2d


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


# ---------------------------------------------------------------------------
# Residual conv blocks (``muax_tpu/models/networks.py:121-144``), shared by
# the conv families. Tensors are NCHW; haiku's are NHWC.
# ---------------------------------------------------------------------------

_TRUNC_NORMAL_STD = 0.87962566103423978  # std of a unit normal cut at +-2


def same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
  """haiku's (XLA's) SAME padding of the last two dims of ``x`` for a
  ``kernel`` x ``kernel`` window at ``stride``: the output has ceil(n /
  stride) positions, and the pad total max((out - 1) * stride + kernel - n,
  0) goes ``total // 2`` before and the rest after. So on an even size at
  stride 2 the pad is 0 before and 1 after, which torch's symmetric
  ``padding=`` cannot give."""
  pads = []
  for n in (x.shape[-1], x.shape[-2]):  # F.pad takes the last dim first
    out = -(-n // stride)
    total = max((out - 1) * stride + kernel - n, 0)
    pads += [total // 2, total - total // 2]
  return F.pad(x, pads)


class SameConv2d(nn.Conv2d):
  """haiku's ``Conv2D(out_channels, kernel, stride)`` (SAME padding, with
  bias) in NCHW. Weights start as haiku's: truncated normal with std
  sqrt(1 / fan_in) / 0.8796, cut at two standard deviations, and zero
  biases."""

  def __init__(self, in_channels: int, out_channels: int, kernel: int,
               stride: int = 1, generator=None):
    super().__init__(in_channels, out_channels, kernel, stride=stride)
    std = math.sqrt(1.0 / (in_channels * kernel * kernel)) / _TRUNC_NORMAL_STD
    with torch.no_grad():
      nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std,
                            generator=generator)
      self.bias.zero_()

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return super().forward(same_pad(x, self.kernel_size[0], self.stride[0]))


def conv3x3(in_channels: int, out_channels: int,
            generator=None) -> SameConv2d:
  """haiku's ``Conv2D(out_channels, 3)``: stride 1, SAME padding."""
  return SameConv2d(in_channels, out_channels, 3, 1, generator)


def avg_pool_same(x: torch.Tensor, window: int = 3,
                  stride: int = 2) -> torch.Tensor:
  """haiku's ``AvgPool((window, window, 1), (stride, stride, 1), "SAME")``
  in NCHW: each window's sum over the SAME-padded input, divided by its
  count of valid (unpadded) cells."""
  sums = F.avg_pool2d(same_pad(x, window, stride), window, stride,
                      divisor_override=1)
  ones = torch.ones((1, 1) + tuple(x.shape[-2:]), dtype=x.dtype,
                    device=x.device)
  counts = F.avg_pool2d(same_pad(ones, window, stride), window, stride,
                        divisor_override=1)
  return sums / counts


class ChannelLayerNorm(nn.Module):
  """haiku's ``LayerNorm(axis=(-3, -2, -1))`` in NCHW: normalised over all
  of (C, H, W) with eps 1e-5, then a per-channel scale and offset (haiku
  keeps them per channel, the last axis of NHWC)."""

  def __init__(self, channels: int, eps: float = 1e-5):
    super().__init__()
    self.eps = eps
    self.weight = nn.Parameter(torch.ones(channels))
    self.bias = nn.Parameter(torch.zeros(channels))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    h = F.layer_norm(x, x.shape[1:], eps=self.eps)
    return h * self.weight[:, None, None] + self.bias[:, None, None]


class ResidualConvBlock(nn.Module):
  """LayerNorm pre-activation residual conv block (EfficientZero-style):
  h = relu(LN(x)); conv3x3 at ``stride`` -> LN -> relu -> conv3x3, plus
  the shortcut: ``x``, or with ``use_projection`` a 1x1 conv at ``stride``
  of ``h`` (the normalized and activated input, as in the JAX block). The
  EfficientZero encoder's ``enc_down_1`` takes both options
  (``in_channels`` -> ``channels`` at stride 2). Modules are registered in
  haiku's creation order: the projection comes before the main conv."""

  def __init__(self, channels: int, stride: int = 1,
               use_projection: bool = False,
               in_channels: Optional[int] = None, generator=None):
    super().__init__()
    in_channels = in_channels or channels
    self.norm_in = ChannelLayerNorm(in_channels)
    self.projection = (SameConv2d(in_channels, channels, 1, stride,
                                  generator) if use_projection else None)
    self.conv_in = SameConv2d(in_channels, channels, 3, stride, generator)
    self.norm_mid = ChannelLayerNorm(channels)
    self.conv_out = conv3x3(channels, channels, generator)

  def haiku_modules(self):
    """(haiku name inside the block, module) in creation order."""
    convs = [self.conv_in]
    if self.projection is not None:
      convs.insert(0, self.projection)
    last = f"conv2_d_{len(convs)}"
    return ([("layer_norm", self.norm_in)]
            + [("conv2_d" if i == 0 else f"conv2_d_{i}", c)
               for i, c in enumerate(convs)]
            + [("layer_norm_1", self.norm_mid), (last, self.conv_out)])

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    h = F.relu(self.norm_in(x))
    shortcut = x if self.projection is None else self.projection(h)
    h = self.conv_in(h)
    return self.conv_out(F.relu(self.norm_mid(h))) + shortcut


# ---------------------------------------------------------------------------
# Conv families (``muax_tpu/models/networks.py:147-265``): EfficientZero's
# stack for pixel observations and an AlphaZero-flavoured ResNet for board
# planes. Observations come in as NHWC (the ring's layout), latents are
# NCHW [B, C, h, w] and the heads read them in NHWC order, so every weight
# carries over from haiku unchanged.
# ---------------------------------------------------------------------------


def _prefixed(prefix: str, block: ResidualConvBlock):
  return [(f"{prefix}/{name}", m) for name, m in block.haiku_modules()]


def _nhwc_flat(h: torch.Tensor) -> torch.Tensor:
  """haiku's ``Flatten`` of the NHWC tensor that ``h`` [B, C, H, W] is."""
  return h.permute(0, 2, 3, 1).flatten(1)


def _conv_out(n: int, stride: int) -> int:
  return -(-n // stride)


class ConvRepresentation(nn.Module):
  """obs [B, H, W, C] -> normalized latent [B, channels, h, w]. With
  ``downsample``, the EfficientZero encoder: conv s2 (channels // 2) ->
  block -> block s2 with projection -> block -> avgpool s2 -> block ->
  avgpool s2 -> block (16x fewer rows and columns). Without, a 3x3 conv
  and ``num_blocks`` blocks."""

  def __init__(self, in_channels: int, channels: int, num_blocks: int,
               downsample: bool, generator=None):
    super().__init__()
    self.downsample = downsample
    if downsample:
      half = max(channels // 2, 1)
      self.stem = SameConv2d(in_channels, half, 3, 2, generator)
      self.blocks = nn.ModuleList([
          ResidualConvBlock(half, generator=generator),
          ResidualConvBlock(channels, 2, True, half, generator),
          ResidualConvBlock(channels, generator=generator),
          ResidualConvBlock(channels, generator=generator),
          ResidualConvBlock(channels, generator=generator)])
      self.names = ["enc_block_0", "enc_down_1", "enc_block_1",
                    "enc_block_2", "enc_block_3"]
    else:
      self.stem = conv3x3(in_channels, channels, generator)
      self.blocks = nn.ModuleList(
          ResidualConvBlock(channels, generator=generator)
          for _ in range(num_blocks))
      self.names = [f"block_{i}" for i in range(num_blocks)]

  def haiku_modules(self):
    mods = [("conv2_d", self.stem)]
    for name, block in zip(self.names, self.blocks):
      mods += _prefixed(name, block)
    return mods

  @staticmethod
  def latent_hw(height: int, width: int, downsample: bool):
    """The latent's (rows, columns) for an H x W observation."""
    if not downsample:
      return height, width
    for _ in range(4):  # stem, enc_down_1 and the two pools halve each
      height, width = _conv_out(height, 2), _conv_out(width, 2)
    return height, width

  def forward(self, obs: torch.Tensor) -> torch.Tensor:
    # Integer frames (uint8 pixel storage) up-cast to the weights' dtype
    # (f32, or bf16 under the loss's compute_dtype: exact for bytes); float
    # frames keep theirs.
    x = obs if obs.is_floating_point() else obs.to(self.stem.weight.dtype)
    h = self.stem(x.permute(0, 3, 1, 2))
    if self.downsample:
      b0, down, b1, b2, b3 = self.blocks
      h = b1(down(b0(h)))
      h = b2(avg_pool_same(h))
      h = b3(avg_pool_same(h))
    else:
      for block in self.blocks:
        h = block(h)
    return min_max_normalize2d(h)


class ConvPrediction(nn.Module):
  """latent -> (policy_logits, value_logits): a residual block, then the
  heads on its NHWC flattening: relu(linear 128), value linear, policy
  linear (haiku's ``linear``, ``linear_1``, ``linear_2``)."""

  def __init__(self, channels: int, latent_cells: int, num_actions: int,
               full_support: int, generator=None):
    super().__init__()
    self.block = ResidualConvBlock(channels, generator=generator)
    self.torso = _linear(latent_cells * channels, 128, generator)
    self.value = _linear(128, full_support, generator)
    self.policy = _linear(128, num_actions, generator)

  def haiku_modules(self):
    return _prefixed("pred_block", self.block) + _haiku_linears(
        [self.torso, self.value, self.policy])

  def forward(self, s: torch.Tensor):
    torso = F.relu(self.torso(_nhwc_flat(self.block(s))))
    return self.policy(torso), self.value(torso)


class ConvDynamic(nn.Module):
  """(latent, action [B]) -> (reward_logits, normalized next latent): the
  plane a / num_actions appended as the last channel, a 3x3 conv,
  ``num_blocks`` blocks; the reward head reads relu(h) flattened in NHWC
  order through relu(linear 64). haiku builds the reward head's outer
  linear first, so it is ``linear`` and the 64-wide hidden layer
  ``linear_1``."""

  def __init__(self, channels: int, latent_cells: int, num_actions: int,
               full_support: int, num_blocks: int, generator=None):
    super().__init__()
    self.num_actions = num_actions
    self.stem = conv3x3(channels + 1, channels, generator)
    self.blocks = nn.ModuleList(
        ResidualConvBlock(channels, generator=generator)
        for _ in range(num_blocks))
    self.reward = _linear(64, full_support, generator)
    self.reward_hidden = _linear(latent_cells * channels, 64, generator)

  def haiku_modules(self):
    mods = [("conv2_d", self.stem)]
    for i, block in enumerate(self.blocks):
      mods += _prefixed(f"dyn_block_{i}", block)
    return mods + _haiku_linears([self.reward, self.reward_hidden])

  def forward(self, s: torch.Tensor, a: torch.Tensor):
    plane = (a.to(s.dtype) / self.num_actions)[:, None, None, None].expand(
        s.shape[0], 1, s.shape[2], s.shape[3])
    h = self.stem(torch.cat([s, plane], 1))
    for block in self.blocks:
      h = block(h)
    hidden = F.relu(self.reward_hidden(_nhwc_flat(F.relu(h))))
    return self.reward(hidden), min_max_normalize2d(h)


@dataclasses.dataclass(frozen=True)
class ConvMZNetworks:
  """Architecture of a conv triplet (EfficientZero's or the ResNet);
  ``init_params`` builds its modules. Its ``family`` is "conv", fixed by
  the class: no search or learner kernel takes it (the JAX package sends
  it to its XLA engine too), so it runs the generic engine and the hybrid
  or generic learner."""
  num_actions: int
  support_size: int
  channels: int
  num_blocks: int
  downsample: bool
  device: torch.device
  family: ClassVar[str] = "conv"

  @property
  def full_support(self) -> int:
    return 2 * self.support_size + 1

  def latent_shape(self, observation_shape: Sequence[int]):
    """[C, h, w] of the latent for observations [H, W, C_obs]."""
    height, width, _ = observation_shape
    h, w = ConvRepresentation.latent_hw(height, width, self.downsample)
    return (self.channels, h, w)

  def init_params(self, observation_shape: Sequence[int],
                  generator: Optional[torch.Generator] = None) -> MZParams:
    """Fresh modules on ``self.device`` for observations [H, W, C], drawn
    from a CPU ``generator`` in the order representation, prediction,
    dynamic."""
    _, h, w = self.latent_shape(observation_shape)
    C, A, S = self.channels, self.num_actions, self.full_support
    params = MZParams(
        ConvRepresentation(observation_shape[-1], C, self.num_blocks,
                           self.downsample, generator),
        ConvPrediction(C, h * w, A, S, generator),
        ConvDynamic(C, h * w, A, S, self.num_blocks, generator))
    return params.to(self.device)


def make_efficientzero_networks(num_actions: int, support_size: int = 20,
                                channels: int = 32, num_blocks: int = 2,
                                downsample: bool = True,
                                device="cuda") -> ConvMZNetworks:
  """The EfficientZero conv triplet for pixel observations [B, H, W, C].
  ``downsample`` runs the full encoder (16x fewer rows and columns: 80 x 40
  frames give 5 x 3 latents); ``num_blocks`` counts the dynamics' blocks,
  and the representation's when ``downsample`` is off."""
  return ConvMZNetworks(num_actions=num_actions, support_size=support_size,
                        channels=channels, num_blocks=num_blocks,
                        downsample=downsample, device=resolve_device(device))


def make_resnet_networks(num_actions: int, support_size: int = 20,
                         channels: int = 64, num_blocks: int = 4,
                         device="cuda") -> ConvMZNetworks:
  """The AlphaZero-flavoured ResNet triplet for board planes [B, H, W, P]:
  no downsampling, ``num_blocks`` blocks in the representation and in the
  dynamics."""
  return ConvMZNetworks(num_actions=num_actions, support_size=support_size,
                        channels=channels, num_blocks=num_blocks,
                        downsample=False, device=resolve_device(device))
