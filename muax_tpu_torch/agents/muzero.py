"""The standalone MuZero agent, the host-facing convenience API
(``muax_tpu/agents/muzero.py``).

An agent holds the networks, the search policy, the optimizer and the loss,
and exposes ``init / act / update / save / load`` plus the
``representation / prediction / dynamic`` helpers. It runs on
``networks.device``: ``act`` searches with the generic engine on that
device, as the JAX agents do (no fused kernel), and ``update`` is autograd
over the family's loss followed by the port's optimizer over the flat
parameter vector. ``act`` takes one observation or, with
``obs_from_batch=True``, a batch [B, ...], searched as one batch.

Randomness comes from a ``torch.Generator`` on the agent's device (or an
int seed for one), where the JAX agents take a key. Checkpoints are the
port's own (``train/checkpoint.py`` pickles with numpy leaves): the
parameters' ``state_dict``, the optimizer's flat ``OptState`` and the
observation shape.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from muax_tpu_torch.config import SearchConfig
from muax_tpu_torch.models.losses import muzero_grad
from muax_tpu_torch.models.networks import MZNetworks
from muax_tpu_torch.models.optimizers import (GradientTransformation,
                                              apply_updates, muzero_optimizer)
from muax_tpu_torch.ops import logits_to_scalar
from muax_tpu_torch.search import gumbel_muzero_policy, muzero_policy
from muax_tpu_torch.train.checkpoint import load_pytree, save_pytree, to_torch
from muax_tpu_torch.train.inference import make_recurrent_fn, make_root_fn
from muax_tpu_torch.types import Transition

GeneratorLike = Union[torch.Generator, int]

# numpy dtypes that the JAX package narrows (64-bit types are off there).
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32}


def _numpy(x) -> np.ndarray:
  a = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else (
      np.asarray(x))
  return np.ascontiguousarray(a.astype(_NARROW.get(a.dtype, a.dtype),
                                       copy=False))


def transition_to_device(batch, device: torch.device) -> Transition:
  """``batch`` (a ``Transition`` of numpy arrays or tensors, or anything
  with its fields) as a ``Transition`` on ``device``, moved in one copy:
  the fields are packed into one host byte buffer, which goes to the
  device at once, and viewed back there. 64-bit floats and ints become
  32-bit, as in the JAX package. A batch already on ``device`` is returned
  as it is."""
  names = [f.name for f in dataclasses.fields(Transition)]
  values = [getattr(batch, n) for n in names]
  if all(isinstance(v, torch.Tensor) and v.device == device for v in values):
    return Transition(*values)
  arrays = [_numpy(v) for v in values]
  offsets, total = [], 0
  for a in arrays:
    offsets.append(total)
    total += -(-a.nbytes // 8) * 8  # 8-byte aligned views
  host = np.empty(total, np.uint8)
  for a, off in zip(arrays, offsets):
    host[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
  packed = torch.from_numpy(host).to(device)
  fields = {}
  for name, a, off in zip(names, arrays, offsets):
    dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
    fields[name] = packed[off:off + a.nbytes].view(dtype).reshape(a.shape)
  return Transition(**fields)


def as_observation(obs, device: torch.device) -> torch.Tensor:
  """An observation (numpy, tensor, list) on ``device``; float64 becomes
  float32, as ``jnp.asarray`` does."""
  if isinstance(obs, torch.Tensor):
    obs = obs.to(device)
    return obs.float() if obs.dtype == torch.float64 else obs
  return torch.from_numpy(_numpy(obs)).to(device)


class Agent:
  """What the three agents share: ``init``, ``act``'s batching,
  ``update``'s step through the optimizer, ``save`` and ``load``. A family
  gives ``_plan`` (one search over a batch of observations) and ``_grad``
  (the loss's flat gradient and metrics)."""

  DEFAULT_SIMULATIONS = 50

  def __init__(self, networks, optimizer: Optional[GradientTransformation],
               discount: float, search_config: SearchConfig,
               unroll_steps: int):
    self.networks = networks
    self.optimizer = optimizer or muzero_optimizer()
    self.discount = discount
    self.search = search_config
    self.unroll_steps = unroll_steps
    self.params = None
    self.opt_state = None
    self.observation_shape: Optional[tuple] = None

  @property
  def device(self) -> torch.device:
    return self.networks.device

  # -- init ---------------------------------------------------------------
  def init(self, generator: Optional[GeneratorLike], sample_input,
           params=None):
    """Fresh parameters for observations shaped like ``sample_input``
    [B, ...], drawn from the CPU ``generator`` (or an int seed), and the
    optimizer's state. ``params``, when given (weights converted from the
    JAX package, say), are taken instead of fresh ones."""
    shape = (sample_input.shape if hasattr(sample_input, "shape")
             else np.shape(sample_input))
    self.observation_shape = tuple(shape[1:])
    if params is None:
      if isinstance(generator, int):
        generator = torch.Generator().manual_seed(generator)
      params = self.networks.init_params(self.observation_shape, generator)
    self.params = params
    self.opt_state = self.optimizer.init(self.params)
    return self.params

  # -- acting -------------------------------------------------------------
  def _generator(self, generator: GeneratorLike) -> torch.Generator:
    if isinstance(generator, int):
      return torch.Generator(self.device).manual_seed(generator)
    if torch.device(generator.device).type != self.device.type:
      raise ValueError(f"the generator lies on {generator.device}, the "
                       f"agent on {self.device}")
    return generator

  def _plan(self, generator, obs, temperature, num_simulations, **kwargs):
    raise NotImplementedError

  def act(self, generator: GeneratorLike, obs, *, with_pi: bool = False,
          with_value: bool = False, obs_from_batch: bool = False,
          num_simulations: Optional[int] = None, temperature: float = 1.0,
          **kwargs):
    """Search and return the action (and optionally pi and the root
    value), as tensors on the agent's device. Without ``obs_from_batch``
    the observation is one [...]: it is searched as a batch of one and
    the results come back without the batch axis."""
    obs = as_observation(obs, self.device)
    if not obs_from_batch:
      obs = obs[None]
    with torch.no_grad():
      action, pi, value = self._plan(
          self._generator(generator), obs, temperature,
          num_simulations or self.DEFAULT_SIMULATIONS, **kwargs)
    if not obs_from_batch:
      action, pi, value = action[0], pi[0], value[0]
    out = (action,)
    if with_pi:
      out += (pi,)
    if with_value:
      out += (value,)
    return out if len(out) > 1 else out[0]

  # -- learning -----------------------------------------------------------
  def _grad(self, batch: Transition, **kwargs):
    raise NotImplementedError

  def update(self, batch, **kwargs) -> float:
    """One gradient step on a [B, L, ...] batch (numpy or torch, moved to
    the device in one copy); returns the loss before the step."""
    batch = transition_to_device(batch, self.device)
    grads, metrics = self._grad(batch, **kwargs)
    updates, self.opt_state = self.optimizer.update(grads, self.opt_state,
                                                    self.params)
    apply_updates(self.params, updates)
    return float(metrics.total)

  # -- checkpointing ------------------------------------------------------
  def save(self, path: str):
    save_pytree(path, {"params": dict(self.params.state_dict()),
                       "opt_state": self.opt_state,
                       "observation_shape": self.observation_shape})

  def load(self, path: str):
    """Parameters and optimizer state from ``save``'s file, into this
    agent's parameters (built first where ``init`` was not called)."""
    ckpt = load_pytree(path)
    if self.params is None:
      self.observation_shape = tuple(ckpt["observation_shape"])
      self.params = self.networks.init_params(self.observation_shape)
    self.params.load_state_dict(to_torch(ckpt["params"], self.device))
    self.opt_state = to_torch(ckpt["opt_state"], self.device)
    return self


class MuZero(Agent):
  """Network triplet + search policy + optimizer, bundled for host loops.
  ``policy`` is "muzero" or "gumbel"."""

  def __init__(
      self,
      networks: MZNetworks,
      policy: str = "muzero",
      optimizer: Optional[GradientTransformation] = None,
      discount: float = 0.997,
      search_config: Optional[SearchConfig] = None,
      unroll_steps: int = 5,
  ):
    search = search_config or SearchConfig(policy=policy)
    search.policy = policy
    super().__init__(networks, optimizer, discount, search, unroll_steps)
    self._root_fn = make_root_fn(networks)
    self._recurrent_fn = make_recurrent_fn(networks, discount)

  def _plan(self, generator, obs, temperature, num_simulations,
            max_depth: Optional[int] = None):
    root = self._root_fn(self.params, obs)
    if self.search.policy == "gumbel":
      out = gumbel_muzero_policy(
          self.params, generator, root, self._recurrent_fn,
          num_simulations=num_simulations, max_depth=max_depth,
          max_num_considered_actions=self.search.max_num_considered_actions,
          gumbel_scale=self.search.gumbel_scale)
    else:
      out = muzero_policy(
          self.params, generator, root, self._recurrent_fn,
          num_simulations=num_simulations, max_depth=max_depth,
          dirichlet_fraction=self.search.dirichlet_fraction,
          dirichlet_alpha=self.search.dirichlet_alpha,
          pb_c_init=self.search.pb_c_init, pb_c_base=self.search.pb_c_base,
          temperature=temperature)
    return out.action, out.action_weights, out.search_tree.summary().value

  # -- network helpers (the reference's coax API) ---------------------------
  @torch.no_grad()
  def representation(self, obs) -> torch.Tensor:
    return self.params.representation(as_observation(obs, self.device))

  @torch.no_grad()
  def prediction(self, embedding):
    """(policy_logits, value) of embeddings."""
    policy_logits, value_logits = self.params.prediction(embedding)
    return policy_logits, logits_to_scalar(value_logits,
                                           self.networks.support_size)

  @torch.no_grad()
  def dynamic(self, embedding, action):
    """(reward, next_embedding) of embeddings and actions."""
    action = torch.as_tensor(action, device=self.device)
    reward_logits, next_embedding = self.params.dynamic(embedding, action)
    return logits_to_scalar(reward_logits,
                            self.networks.support_size), next_embedding

  def _grad(self, batch: Transition):
    return muzero_grad(self.params, batch, self.networks,
                       num_unroll_steps=self.unroll_steps)
