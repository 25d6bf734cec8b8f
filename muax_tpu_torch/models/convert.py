"""Haiku parameter trees and replay rings, given as numpy arrays, into the
port's modules and tensors, and the port's gradients back into haiku's
names.

The tree has the JAX package's layout::

  {'representation' | 'prediction' | 'dynamic'
   (Stochastic MuZero: 'encoder' | 'representation' | 'prediction' |
   'decision' | 'chance'; Diffusion MuZero: 'representation' |
   'prediction' | 'decision' | 'velocity' | 'reward'):
      {'linear', 'linear_1', ...: {'w': [in, out], 'b': [out]},
       'layer_norm', 'block_0/layer_norm', ...: {'scale': [d], 'offset': [d]}}}

The conv triplets' towers add ``conv2_d`` and ``enc_block_0/layer_norm``
style names. The AlphaZero networks and the env model's transition network
are one haiku tree each, with names such as ``conv2_d``, ``block_0/layer_norm``,
``linear_1`` or ``obs_h0``.

Each tower names its modules as haiku does (``haiku_modules()`` of the
port's towers, in creation order): the MLP triplet has linears only, the
acme families add LayerNorms (``models/acme_networks.py``). Linear weights
are transposed into ``nn.Linear``'s [out, in], conv kernels go from
haiku's HWIO to ``nn.Conv2d``'s OIHW; a LayerNorm's scale and offset are
its weight and bias (per channel in the conv blocks, as haiku keeps
them). Only numpy arrays cross this boundary;
turning JAX parameters into numpy is the caller's business.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from muax_tpu_torch.models.diffusion_networks import DMZParams
from muax_tpu_torch.models.networks import ChannelLayerNorm, MZParams
from muax_tpu_torch.models.stochastic_networks import SMZParams
from muax_tpu_torch.replay.buffer import ReplayState

_TOWERS = ("representation", "prediction", "dynamic")


def _same(x):
  return x


def _transpose(x):
  return x.T


def _hwio_to_oihw(x):
  return x.transpose(3, 2, 0, 1)


def _oihw_to_hwio(x):
  return x.transpose(2, 3, 1, 0)


def _leaves(module: nn.Module):
  """(haiku key, port tensor, haiku -> port layout, port -> haiku layout)
  for one module's parameters: a linear's [in, out] is ``nn.Linear``'s
  [out, in], a conv's HWIO is ``nn.Conv2d``'s OIHW, a LayerNorm's scale and
  offset are its weight and bias."""
  if isinstance(module, (nn.LayerNorm, ChannelLayerNorm)):
    return (("scale", module.weight, _same, _same),
            ("offset", module.bias, _same, _same))
  if isinstance(module, nn.Conv2d):
    return (("w", module.weight, _hwio_to_oihw, _oihw_to_hwio),
            ("b", module.bias, _same, _same))
  return (("w", module.weight, _transpose, _transpose),
          ("b", module.bias, _same, _same))


def _load_modules(mods, tree: Mapping, label: str) -> None:
  """Copy a numpy haiku tree into the (haiku name, module) pairs
  ``mods``; raises ``ValueError`` where names or shapes do not fit."""
  if set(tree) != {key for key, _ in mods}:
    raise ValueError(f"{label}: tree has modules {sorted(tree)}, the "
                     f"networks {sorted(key for key, _ in mods)}")
  for key, module in mods:
    for leaf, target, to_port, _ in _leaves(module):
      # np.array copies: the tree may be read-only.
      value = to_port(np.array(tree[key][leaf], np.float32))
      if value.shape != tuple(target.shape):
        raise ValueError(f"{label}/{key}/{leaf}: shape {value.shape} does "
                         f"not fit {tuple(target.shape)}")
      with torch.no_grad():
        target.copy_(torch.from_numpy(np.ascontiguousarray(value)))


def _load_towers(params: nn.Module, tree: Mapping, towers) -> None:
  """Copy every tower of a numpy haiku tree into ``params``' modules."""
  for name in towers:
    _load_modules(getattr(params, name).haiku_modules(), tree[name], name)


def mlp_params_from_numpy(tree: Mapping, networks,
                          temperature: float = 1.0) -> MZParams:
  """Build ``MZParams`` on ``networks.device`` from a numpy haiku tree, for
  the MLP triplet or an acme family.

  Raises ``ValueError`` when the tree's modules do not fit ``networks``.
  """
  obs_dim = np.asarray(tree["representation"]["linear"]["w"]).shape[0]
  params = networks.init_params((obs_dim,))
  params.temperature.fill_(temperature)
  _load_towers(params, tree, _TOWERS)
  return params


def smz_params_from_numpy(tree: Mapping, networks,
                          temperature: float = 1.0) -> SMZParams:
  """Build ``SMZParams`` on ``networks.device`` from the numpy haiku trees
  of the five nets (keys ``SMZParams.TOWERS``).

  Raises ``ValueError`` when the tree's modules do not fit ``networks``.
  """
  obs_dim = np.asarray(tree["representation"]["linear"]["w"]).shape[0]
  params = networks.init_params((obs_dim,))
  params.temperature.fill_(temperature)
  _load_towers(params, tree, SMZParams.TOWERS)
  return params


def dmz_params_from_numpy(tree: Mapping, networks,
                          temperature: float = 1.0) -> DMZParams:
  """Build ``DMZParams`` on ``networks.device`` from the numpy haiku trees
  of the five nets (keys ``DMZParams.TOWERS``).

  Raises ``ValueError`` when the tree's modules do not fit ``networks``.
  """
  obs_dim = np.asarray(tree["representation"]["linear"]["w"]).shape[0]
  params = networks.init_params((obs_dim,))
  params.temperature.fill_(temperature)
  _load_towers(params, tree, DMZParams.TOWERS)
  return params


def _modules_to_numpy(params: nn.Module, flat_grads: torch.Tensor,
                      mods) -> dict:
  """A flat vector in the order of ``params.parameters()`` as a numpy
  haiku tree over the (haiku name, module) pairs ``mods``."""
  flat = flat_grads.detach().cpu().numpy()
  where = {}
  offset = 0
  for p in params.parameters():
    where[id(p)] = (offset, tuple(p.shape))
    offset += p.numel()
  if offset != flat.size:
    raise ValueError(f"gradient of {flat.size} floats does not fit params "
                     f"of {offset}")
  tree = {}
  for key, module in mods:
    tree[key] = {}
    for leaf, p, _, to_haiku in _leaves(module):
      start, shape = where[id(p)]
      value = flat[start:start + p.numel()].reshape(shape)
      tree[key][leaf] = np.ascontiguousarray(to_haiku(value))
  return tree


def _grads_to_numpy(params: nn.Module, flat_grads: torch.Tensor,
                    towers) -> dict:
  return {name: _modules_to_numpy(params, flat_grads,
                                  getattr(params, name).haiku_modules())
          for name in towers}


def mlp_grads_to_numpy(params: MZParams, flat_grads: torch.Tensor) -> dict:
  """A flat gradient in the order of ``params.parameters()`` (what the
  port's learner returns) as a numpy haiku tree with the names of
  ``mlp_params_from_numpy``'s input."""
  return _grads_to_numpy(params, flat_grads, _TOWERS)


def smz_grads_to_numpy(params: SMZParams, flat_grads: torch.Tensor) -> dict:
  """The same for the five nets, with the names of
  ``smz_params_from_numpy``'s input."""
  return _grads_to_numpy(params, flat_grads, SMZParams.TOWERS)


def dmz_grads_to_numpy(params: DMZParams, flat_grads: torch.Tensor) -> dict:
  """The same for the diffusion set's five nets, with the names of
  ``dmz_params_from_numpy``'s input."""
  return _grads_to_numpy(params, flat_grads, DMZParams.TOWERS)


def conv_params_from_numpy(tree: Mapping, networks, observation_shape,
                          temperature: float = 1.0) -> MZParams:
  """Build ``MZParams`` on ``networks.device`` from the numpy haiku tree of
  a conv triplet (``make_efficientzero_networks`` or
  ``make_resnet_networks``) for observations [H, W, C]. Each tower's
  modules are matched by haiku's names, which follow haiku's build order
  (``haiku_modules()``): in a block with a projection ``conv2_d`` is the
  1x1 shortcut, and in the dynamics ``linear`` is the reward head and
  ``linear_1`` the layer before it.

  Raises ``ValueError`` when the tree's modules do not fit ``networks``.
  """
  params = networks.init_params(tuple(observation_shape))
  params.temperature.fill_(temperature)
  _load_towers(params, tree, _TOWERS)
  return params


def conv_grads_to_numpy(params: MZParams, flat_grads: torch.Tensor) -> dict:
  """A flat gradient in the order of ``params.parameters()`` as a numpy
  haiku tree with the names of ``conv_params_from_numpy``'s input (conv
  kernels back to HWIO)."""
  return _grads_to_numpy(params, flat_grads, _TOWERS)


_RING_FIELDS = ("obs", "action", "reward", "done", "rn", "value", "pi",
                "step_priorities", "target_step")


def replay_state_from_numpy(ring, device) -> ReplayState:
  """The JAX package's ``ReplayState`` with numpy leaves as the port's ring
  on ``device``."""
  def tensor(name):
    return torch.from_numpy(np.array(getattr(ring, name))).to(device)

  return ReplayState(**{name: tensor(name) for name in _RING_FIELDS},
                     cursor=int(ring.cursor),
                     total_added=int(ring.total_added))


def az_params_from_numpy(tree: Mapping, network, observation_shape,
                         temperature: float = 1.0):
  """Build ``AZParams`` on ``network.device`` from the numpy haiku tree of
  ``make_az_mlp`` or ``make_az_resnet`` (``AZParams.network`` in the JAX
  package). Raises ``ValueError`` when the tree does not fit."""
  params = network.init_params(observation_shape)
  params.temperature.fill_(temperature)
  _load_modules(params.network.haiku_modules(), tree, "network")
  return params


def az_grads_to_numpy(params, flat_grads: torch.Tensor) -> dict:
  """A flat gradient in the order of ``params.parameters()`` as a numpy
  haiku tree with the names of ``az_params_from_numpy``'s input."""
  return _modules_to_numpy(params, flat_grads,
                           params.network.haiku_modules())


def env_model_params_from_numpy(tree: Mapping, model):
  """Build the transition network of ``make_mlp_transition_model`` on
  ``model.device`` from its numpy haiku tree. Raises ``ValueError`` when
  the tree does not fit."""
  params = model.init_params()
  _load_modules(params.haiku_modules(), tree, "model")
  return params


def env_model_grads_to_numpy(params, flat_grads: torch.Tensor) -> dict:
  """A flat gradient in the order of ``params.parameters()`` as a numpy
  haiku tree with the names of ``env_model_params_from_numpy``'s input."""
  return _modules_to_numpy(params, flat_grads, params.haiku_modules())
