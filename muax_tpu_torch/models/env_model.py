"""Environment models for planning in observation space
(``muax_tpu/models/env_model.py``).

Two "models" plug into the generic search engine as its recurrent
function:

- ``make_simulator_recurrent_fn``: the environment is the model. The tree's
  embeddings are batched env states, so every child carries its own state
  and nothing is copied back and forth.
- ``make_mlp_transition_model`` + ``make_model_recurrent_fn``: a learned MLP
  (obs, action) -> (next obs, reward, continue logit), searched in
  observation space. A node whose predicted sigmoid(continue) falls below
  ``terminal_tol`` gets discount 0, which ends its subtree.

The transition model learns online from a uniform transition ring on the
device (``model_replay_*``), written in place, by ``make_model_update_fn``.
The policy/value network that evaluates the leaves is an ``AZNetwork``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from muax_tpu_torch.device import resolve_device
from muax_tpu_torch.envs.base import Environment
from muax_tpu_torch.models.networks import _linear
from muax_tpu_torch.models.optimizers import (GradientTransformation,
                                              apply_updates)
from muax_tpu_torch.search import muzero_policy
from muax_tpu_torch.search.types import RecurrentFnOutput, RootFnOutput

_HEADS = ("obs", "reward", "continue")


class TransitionMLP(nn.Module):
  """Three separate relu towers over concat(flat obs, one_hot(action)): the
  next observation (a delta on the current one when ``residual``), the
  reward and the continue logit. Modules are registered in haiku's creation
  order, named ``<head>_h<i>`` and ``<head>_out``."""

  def __init__(self, observation_shape: Tuple[int, ...], num_actions: int,
               hidden: Sequence[int], residual: bool, generator=None):
    super().__init__()
    self.observation_shape = tuple(observation_shape)
    self.num_actions = num_actions
    self.residual = residual
    obs_size = math.prod(observation_shape)
    self.towers = nn.ModuleList()
    for out_size in (obs_size, 1, 1):
      layers, width = nn.ModuleList(), obs_size + num_actions
      for size in hidden:
        layers.append(_linear(width, size, generator))
        width = size
      layers.append(_linear(width, out_size, generator))
      self.towers.append(layers)

  def haiku_modules(self):
    return [(f"{head}_h{i}" if i < len(tower) - 1 else f"{head}_out", layer)
            for head, tower in zip(_HEADS, self.towers)
            for i, layer in enumerate(tower)]

  def forward(self, obs: torch.Tensor, action: torch.Tensor):
    flat = obs.flatten(1).to(torch.float32)
    inputs = torch.cat(
        [flat, F.one_hot(action.long(), self.num_actions).to(flat.dtype)],
        dim=-1)

    def tower(layers):
      h = inputs
      for layer in layers[:-1]:
        h = F.relu(layer(h))
      return layers[-1](h)

    next_flat = tower(self.towers[0])
    if self.residual:
      next_flat = next_flat + flat
    next_obs = next_flat.reshape((obs.shape[0],) + self.observation_shape)
    return next_obs, tower(self.towers[1])[:, 0], tower(self.towers[2])[:, 0]


@dataclasses.dataclass(frozen=True)
class EnvModel:
  """A learned transition model: ``apply(params, obs [B, ...], action [B])
  -> (next_obs [B, ...], reward [B], continue_logit [B])``."""
  num_actions: int
  observation_shape: Tuple[int, ...]
  hidden: Tuple[int, ...]
  residual: bool
  device: torch.device

  def init_params(self, generator: Optional[torch.Generator] = None
                  ) -> TransitionMLP:
    """A fresh network on ``self.device``, drawn from a CPU
    ``generator``."""
    return TransitionMLP(self.observation_shape, self.num_actions,
                         self.hidden, self.residual, generator).to(
                             self.device)

  def apply(self, params: TransitionMLP, obs: torch.Tensor,
            action: torch.Tensor):
    return params(obs, action)


def make_mlp_transition_model(num_actions: int,
                              observation_shape: Tuple[int, ...],
                              hidden: Sequence[int] = (64, 64),
                              residual: bool = True,
                              device="cuda") -> EnvModel:
  """MLP (obs, one_hot(a)) -> (next_obs, reward, continue_logit); with
  ``residual`` it predicts the observation's change."""
  return EnvModel(num_actions=num_actions,
                  observation_shape=tuple(observation_shape),
                  hidden=tuple(hidden), residual=residual,
                  device=resolve_device(device))


# --------------------------------------------------------------------------
# The model's transition ring on the device: uniform sampling, in-place add
# with wraparound.
# --------------------------------------------------------------------------


@dataclasses.dataclass
class ModelReplayState:
  obs: torch.Tensor        # [C, ...]
  action: torch.Tensor     # [C] int32
  reward: torch.Tensor     # [C] f32
  next_obs: torch.Tensor   # [C, ...]
  done: torch.Tensor       # [C] bool
  cursor: int = 0
  size: int = 0

  @property
  def capacity(self) -> int:
    return self.action.shape[0]


def model_replay_init(capacity: int, observation_shape: Tuple[int, ...],
                      obs_dtype=torch.float32,
                      device="cuda") -> ModelReplayState:
  dev = resolve_device(device)
  shape = (capacity,) + tuple(observation_shape)
  return ModelReplayState(
      obs=torch.zeros(shape, dtype=obs_dtype, device=dev),
      action=torch.zeros((capacity,), dtype=torch.int32, device=dev),
      reward=torch.zeros((capacity,), dtype=torch.float32, device=dev),
      next_obs=torch.zeros(shape, dtype=obs_dtype, device=dev),
      done=torch.zeros((capacity,), dtype=torch.bool, device=dev))


def model_replay_add(state: ModelReplayState, obs, action, reward, next_obs,
                     done) -> ModelReplayState:
  """Insert K transitions at the cursor, in place; with K > capacity only
  the newest ``capacity`` are kept, so no slot is written twice."""
  C = state.capacity
  if action.shape[0] > C:
    obs, action, reward, next_obs, done = (
        x[-C:] for x in (obs, action, reward, next_obs, done))
  k = action.shape[0]
  idx = (state.cursor + torch.arange(k, device=state.action.device)) % C
  state.obs[idx] = obs.to(state.obs.dtype)
  state.action[idx] = action.to(torch.int32)
  state.reward[idx] = reward.to(torch.float32)
  state.next_obs[idx] = next_obs.to(state.next_obs.dtype)
  state.done[idx] = done.to(torch.bool)
  state.cursor = (state.cursor + k) % C
  state.size = min(state.size + k, C)
  return state


def model_replay_sample(state: ModelReplayState, generator: torch.Generator,
                        batch_size: int):
  """A uniform minibatch over the filled slots: (obs, action, reward,
  next_obs, done)."""
  idx = torch.randint(0, max(state.size, 1), (batch_size,),
                      generator=generator, device=state.action.device)
  return (state.obs[idx], state.action[idx], state.reward[idx],
          state.next_obs[idx], state.done[idx])


# --------------------------------------------------------------------------
# Online model learning.
# --------------------------------------------------------------------------


def env_model_loss(params: TransitionMLP, model: EnvModel, obs, action,
                   reward, next_obs, done):
  """MSE(next_obs) + MSE(reward) + binary cross-entropy of the continue
  logit against not-done. Returns (total, metrics)."""
  pred_next, pred_reward, continue_logit = model.apply(params, obs, action)
  obs_loss = torch.mean(torch.square(pred_next - next_obs))
  reward_loss = torch.mean(torch.square(pred_reward - reward))
  continue_loss = F.binary_cross_entropy_with_logits(
      continue_logit, 1.0 - done.to(torch.float32))
  return obs_loss + reward_loss + continue_loss, {
      "model_obs_loss": obs_loss,
      "model_reward_loss": reward_loss,
      "model_continue_loss": continue_loss,
  }


def make_model_update_fn(model: EnvModel,
                         optimizer: GradientTransformation,
                         batch_size: int = 16, num_sgd_steps: int = 1):
  """update(params, opt_state, replay_state, generator) -> (params,
  opt_state, metrics of the last step): ``num_sgd_steps`` steps, each on a
  uniform minibatch of the ring, the parameters stepped in place. While the
  ring holds fewer than ``batch_size`` transitions a step's gradient (and
  its reported loss) is zeroed, so zero-initialised slots never train the
  model."""

  def update(params: TransitionMLP, opt_state,
             replay_state: ModelReplayState, generator: torch.Generator):
    ready = float(replay_state.size >= batch_size)
    for _ in range(num_sgd_steps):
      batch = model_replay_sample(replay_state, generator, batch_size)
      loss, metrics = env_model_loss(params, model, *batch)
      grads = [g * ready for g in torch.autograd.grad(
          loss, list(params.parameters()))]
      updates, opt_state = optimizer.update(grads, opt_state, params)
      apply_updates(params, updates)
      metrics = {k: v.detach() for k, v in metrics.items()}
      metrics["model_loss"] = loss.detach() * ready
    return params, opt_state, metrics

  return update


# --------------------------------------------------------------------------
# The search's recurrent functions over the learned model and the real env.
# --------------------------------------------------------------------------


class ModelSearchParams(NamedTuple):
  """The evaluation network's params (``AZParams``) and the transition
  model's, together for the search."""
  network: Any
  model: Any


def make_model_recurrent_fn(model: EnvModel, network, discount: float = 1.0,
                            terminal_tol: float = 0.1):
  """The search's dynamics is the learned model; embeddings are
  observations. A node predicted terminal (sigmoid(continue) <
  ``terminal_tol``) gets discount 0 and value 0."""

  def recurrent_fn(params: ModelSearchParams, generator, action, embedding):
    del generator
    next_obs, reward, continue_logit = model.apply(params.model, embedding,
                                                   action)
    alive = torch.sigmoid(continue_logit) >= terminal_tol
    policy_logits, value = network.apply(params.network, next_obs)
    out = RecurrentFnOutput(
        reward=reward,
        discount=torch.where(alive, discount, 0.0),
        prior_logits=policy_logits,
        value=torch.where(alive, value, 0.0))
    return out, next_obs

  return recurrent_fn


def make_simulator_recurrent_fn(env: Environment, network,
                                discount: float = 1.0):
  """The search's dynamics is the batched env itself (single player; the
  two-player flip is ``train/selfplay.py``'s). Embeddings are env
  states."""

  def recurrent_fn(params, generator, action, embedding):
    del generator
    new_state, obs, reward, done = env.step(embedding, action)
    policy_logits, value = network.apply(params, obs)
    out = RecurrentFnOutput(
        reward=reward,
        discount=torch.where(done, 0.0, discount),
        prior_logits=policy_logits,
        value=torch.where(done, 0.0, value))
    return out, new_state

  return recurrent_fn


def _policy_output(out):
  return out.action, out.action_weights, out.search_tree.summary().value


def make_model_policy_fn(model: EnvModel, network,
                         num_simulations: int = 64, discount: float = 1.0,
                         terminal_tol: float = 0.1,
                         dirichlet_fraction: float = 0.25,
                         dirichlet_alpha: float = 0.3,
                         max_depth: Optional[int] = None):
  """(search_params, generator, obs [B, ...], temperature) ->
  (action, pi, root_value): batched MCTS over the learned model."""
  recurrent_fn = make_model_recurrent_fn(model, network, discount,
                                         terminal_tol)

  @torch.no_grad()
  def policy_fn(params: ModelSearchParams, generator, obs, temperature):
    policy_logits, value = network.apply(params.network, obs)
    root = RootFnOutput(prior_logits=policy_logits, value=value,
                        embedding=obs)
    return _policy_output(muzero_policy(
        params, generator, root, recurrent_fn, num_simulations,
        max_depth=max_depth, dirichlet_fraction=dirichlet_fraction,
        dirichlet_alpha=dirichlet_alpha, temperature=temperature))

  return policy_fn


def make_simulator_policy_fn(env: Environment, network,
                             num_simulations: int = 64,
                             discount: float = 1.0,
                             dirichlet_fraction: float = 0.25,
                             dirichlet_alpha: float = 0.3,
                             max_depth: Optional[int] = None):
  """(params, generator, state, obs, temperature) -> (action, pi,
  root_value): batched MCTS over the real env, from batched env states
  and their observations."""
  recurrent_fn = make_simulator_recurrent_fn(env, network, discount)

  @torch.no_grad()
  def policy_fn(params, generator, state, obs, temperature):
    policy_logits, value = network.apply(params, obs)
    root = RootFnOutput(prior_logits=policy_logits, value=value,
                        embedding=state)
    return _policy_output(muzero_policy(
        params, generator, root, recurrent_fn, num_simulations,
        max_depth=max_depth, dirichlet_fraction=dirichlet_fraction,
        dirichlet_alpha=dirichlet_alpha, temperature=temperature))

  return policy_fn
