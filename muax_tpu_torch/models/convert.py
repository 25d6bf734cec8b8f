"""Haiku parameter trees and replay rings, given as numpy arrays, into the
port's modules and tensors, and the port's gradients back into haiku's
names.

The tree has the JAX package's layout::

  {'representation' | 'prediction' | 'dynamic':
      {'linear', 'linear_1', ...: {'w': [in, out], 'b': [out]},
       'layer_norm', 'block_0/layer_norm', ...: {'scale': [d], 'offset': [d]}}}

Each tower names its modules as haiku does (``haiku_modules()`` of the
port's towers, in creation order): the MLP triplet has linears only, the
acme families add LayerNorms (``models/acme_networks.py``). Linear weights
are transposed into ``nn.Linear``'s [out, in]; a LayerNorm's scale and
offset are its weight and bias. Only numpy arrays cross this boundary;
turning JAX parameters into numpy is the caller's business.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from muax_tpu_torch.models.networks import MZParams
from muax_tpu_torch.replay.buffer import ReplayState

_TOWERS = ("representation", "prediction", "dynamic")


def _leaves(module: nn.Module):
  """(haiku key, port tensor, transpose) for one module's parameters."""
  if isinstance(module, nn.LayerNorm):
    return (("scale", module.weight, False), ("offset", module.bias, False))
  return (("w", module.weight, True), ("b", module.bias, False))


def mlp_params_from_numpy(tree: Mapping, networks,
                          temperature: float = 1.0) -> MZParams:
  """Build ``MZParams`` on ``networks.device`` from a numpy haiku tree, for
  the MLP triplet or an acme family.

  Raises ``ValueError`` when the tree's modules do not fit ``networks``.
  """
  obs_dim = np.asarray(tree["representation"]["linear"]["w"]).shape[0]
  params = networks.init_params((obs_dim,))
  params.temperature.fill_(temperature)
  for name in _TOWERS:
    mods = getattr(params, name).haiku_modules()
    if set(tree[name]) != {key for key, _ in mods}:
      raise ValueError(f"{name}: tree has modules {sorted(tree[name])}, the "
                       f"networks {sorted(key for key, _ in mods)}")
    for key, module in mods:
      for leaf, target, transpose in _leaves(module):
        # np.array copies: the tree may be read-only.
        value = np.array(tree[name][key][leaf], np.float32)
        if transpose:
          value = value.T
        if value.shape != tuple(target.shape):
          raise ValueError(f"{name}/{key}/{leaf}: shape {value.shape} does "
                           f"not fit {tuple(target.shape)}")
        with torch.no_grad():
          target.copy_(torch.from_numpy(np.ascontiguousarray(value)))
  return params


def mlp_grads_to_numpy(params: MZParams, flat_grads: torch.Tensor) -> dict:
  """A flat gradient in the order of ``params.parameters()`` (what the
  port's learner returns) as a numpy haiku tree with the names of
  ``mlp_params_from_numpy``'s input."""
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
  for name in _TOWERS:
    tree[name] = {}
    for key, module in getattr(params, name).haiku_modules():
      tree[name][key] = {}
      for leaf, p, transpose in _leaves(module):
        start, shape = where[id(p)]
        value = flat[start:start + p.numel()].reshape(shape)
        tree[name][key][leaf] = np.ascontiguousarray(
            value.T if transpose else value)
  return tree


_RING_FIELDS = ("obs", "action", "reward", "done", "rn", "value", "pi",
                "step_priorities", "target_step")


def replay_state_from_numpy(ring, device="cpu") -> ReplayState:
  """The JAX package's ``ReplayState`` with numpy leaves as the port's ring
  on ``device``."""
  def tensor(name):
    return torch.from_numpy(np.array(getattr(ring, name))).to(device)

  return ReplayState(**{name: tensor(name) for name in _RING_FIELDS},
                     cursor=int(ring.cursor),
                     total_added=int(ring.total_added))
