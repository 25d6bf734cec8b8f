"""Haiku parameter trees, given as numpy arrays, into the port's modules.

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
