"""Haiku parameter trees and replay rings, given as numpy arrays, into the
port's modules and tensors, and the port's gradients back into haiku's
names.

The tree has the JAX package's layout::

  {'representation' | 'prediction' | 'dynamic':
      {'linear', 'linear_1', ...: {'w': [in, out], 'b': [out]}}}

with each tower's linears in haiku's creation order (``linear`` first, then
``linear_1``, ...): representation is hidden layers then the embedding head,
prediction is hidden layers then the value and policy heads, dynamic is
hidden layers then the reward and next-state heads. Weights are transposed
into ``nn.Linear``'s [out, in]. Only numpy arrays cross this boundary; turning
JAX parameters into numpy is the caller's business.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from muax_tpu_torch.models.networks import MZNetworks, MZParams
from muax_tpu_torch.replay.buffer import ReplayState

_TOWERS = ("representation", "prediction", "dynamic")


def _creation_order(module_tree: Mapping) -> list:
  def index(key: str) -> int:
    if key == "linear":
      return 0
    if key.startswith("linear_") and key[len("linear_"):].isdigit():
      return int(key[len("linear_"):])
    raise ValueError(f"unexpected module {key!r} in an MLP tower")
  keys = sorted(module_tree, key=index)
  return [module_tree[k] for k in keys]


def mlp_params_from_numpy(tree: Mapping, networks: MZNetworks,
                          temperature: float = 1.0) -> MZParams:
  """Build ``MZParams`` on ``networks.device`` from a numpy haiku tree.

  Raises ``ValueError`` when the tree's layers do not fit ``networks``.
  """
  obs_dim = np.asarray(
      _creation_order(tree["representation"])[0]["w"]).shape[0]
  params = networks.init_params((obs_dim,))
  params.temperature.fill_(temperature)
  for name in _TOWERS:
    layers = _creation_order(tree[name])
    targets = getattr(params, name).linears()
    if len(layers) != len(targets):
      raise ValueError(f"{name}: tree has {len(layers)} linears, the "
                       f"networks have {len(targets)}")
    for i, (layer, target) in enumerate(zip(layers, targets)):
      w = np.array(layer["w"], np.float32)  # copies: the tree may be read-only
      b = np.array(layer["b"], np.float32)
      if w.shape != (target.in_features, target.out_features) or b.shape != (
          target.out_features,):
        raise ValueError(
            f"{name} linear {i}: w {w.shape}, b {b.shape} do not fit "
            f"[{target.in_features}, {target.out_features}]")
      with torch.no_grad():
        target.weight.copy_(torch.from_numpy(np.ascontiguousarray(w.T)))
        target.bias.copy_(torch.from_numpy(b))
  return params


def _module_name(i: int) -> str:
  return "linear" if i == 0 else f"linear_{i}"


def mlp_grads_to_numpy(params: MZParams, flat_grads: torch.Tensor) -> dict:
  """A flat gradient in the order of ``params.parameters()`` (what the
  port's learner returns) as a numpy haiku tree: ``{tower: {'linear',
  'linear_1', ...: {'w': [in, out], 'b': [out]}}}``."""
  flat = flat_grads.detach().cpu().numpy()
  tree, offset = {}, 0
  for name in _TOWERS:
    tree[name] = {}
    for i, layer in enumerate(getattr(params, name).linears()):
      out_dim, in_dim = layer.weight.shape
      w = flat[offset:offset + out_dim * in_dim].reshape(out_dim, in_dim)
      offset += out_dim * in_dim
      b = flat[offset:offset + out_dim]
      offset += out_dim
      tree[name][_module_name(i)] = {"w": np.ascontiguousarray(w.T),
                                     "b": b.copy()}
  if offset != flat.size:
    raise ValueError(f"gradient of {flat.size} floats does not fit params "
                     f"of {offset}")
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
