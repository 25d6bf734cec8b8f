"""Observation wrappers over batched envs (``muax_tpu/envs/wrappers.py``).

* ``FrameStackingEnv``: the last N observations stacked on a new axis
  (``stack=True``) or concatenated along the last axis (``stack=False``);
* ``ActionHistoryEnv``: the last N actions appended to the observation,
  as one-hots for 1-D observations and as planes ``a / A`` for images;
* ``PoolFrameStacking``: channel-stacked frames over an auto-resetting
  batched env, refilled with the post-reset frame on ``done``.

The JAX wrappers wrap one environment and are vmapped; these hold the
histories of all B environments ([B, N, ...] frames, [B, N] actions). The
first two are ``Environment`` s whose state is a dataclass of (inner state,
history), so ``AutoResetWrapper`` resets a done env's history with it.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from muax_tpu_torch.envs.base import AutoResetState, Environment, EnvSpec


@dataclasses.dataclass
class StackState:
  env_state: Any
  frames: torch.Tensor  # [B, N, ...obs], newest last


class FrameStackingEnv(Environment):
  """Stack the last ``num_frames`` observations along a new axis after the
  batch (``stack=True``) or concatenate them along the last axis
  (``stack=False``)."""

  def __init__(self, env: Environment, num_frames: int = 4,
               stack: bool = True):
    self.env = env
    self.num_frames = num_frames
    self.stack = stack
    inner = env.spec
    if stack:
      obs_shape = (num_frames,) + tuple(inner.observation_shape)
    else:
      obs_shape = tuple(inner.observation_shape[:-1]) + (
          inner.observation_shape[-1] * num_frames,)
    self.spec = EnvSpec(observation_shape=obs_shape,
                        num_actions=inner.num_actions,
                        max_episode_steps=inner.max_episode_steps,
                        obs_dtype=inner.obs_dtype)

  def _obs(self, frames: torch.Tensor) -> torch.Tensor:
    if self.stack:
      return frames
    return torch.cat(frames.unbind(1), -1)

  def reset(self, generator: torch.Generator, batch_size: int):
    env_state, obs = self.env.reset(generator, batch_size)
    frames = obs[:, None].repeat_interleave(self.num_frames, 1)
    return StackState(env_state=env_state, frames=frames), self._obs(frames)

  def step(self, state: StackState, action: torch.Tensor):
    env_state, obs, reward, done = self.env.step(state.env_state, action)
    frames = torch.cat([state.frames[:, 1:], obs[:, None]], 1)
    return (StackState(env_state=env_state, frames=frames),
            self._obs(frames), reward, done)


@dataclasses.dataclass
class ActionHistoryState:
  env_state: Any
  history: torch.Tensor  # [B, N] int32, the latest action last


class ActionHistoryEnv(Environment):
  """Append the last N actions to the observation: flattened one-hots for
  1-D observations, constant planes ``a / A`` for images. The spec drops
  ``obs_dtype``, as the JAX wrapper's does: the planes are fractions."""

  def __init__(self, env: Environment, num_actions_history: int = 4):
    self.env = env
    self.n = num_actions_history
    inner = env.spec
    if len(inner.observation_shape) == 1:
      obs_shape = (inner.observation_shape[0]
                   + self.n * inner.num_actions,)
    else:
      obs_shape = tuple(inner.observation_shape[:-1]) + (
          inner.observation_shape[-1] + self.n,)
    self.spec = EnvSpec(observation_shape=obs_shape,
                        num_actions=inner.num_actions,
                        max_episode_steps=inner.max_episode_steps)

  def _obs(self, obs: torch.Tensor, history: torch.Tensor) -> torch.Tensor:
    num_actions = self.env.spec.num_actions
    B = obs.shape[0]
    if len(self.env.spec.observation_shape) == 1:
      onehots = F.one_hot(history.long(), num_actions).to(obs.dtype)
      return torch.cat([obs, onehots.reshape(B, -1)], -1)
    dtype = obs.dtype if obs.is_floating_point() else torch.float32
    planes = (history.to(dtype) / num_actions).reshape(
        (B,) + (1,) * (obs.ndim - 2) + (self.n,)).expand(
            tuple(obs.shape[:-1]) + (self.n,))
    return torch.cat([obs.to(dtype), planes], -1)

  def reset(self, generator: torch.Generator, batch_size: int):
    env_state, obs = self.env.reset(generator, batch_size)
    history = torch.zeros((batch_size, self.n), dtype=torch.int32,
                          device=obs.device)
    return (ActionHistoryState(env_state=env_state, history=history),
            self._obs(obs, history))

  def step(self, state: ActionHistoryState, action: torch.Tensor):
    env_state, obs, reward, done = self.env.step(state.env_state, action)
    history = torch.cat([state.history[:, 1:],
                         action[:, None].to(torch.int32)], 1)
    return (ActionHistoryState(env_state=env_state, history=history),
            self._obs(obs, history), reward, done)


class PoolFrameStacking:
  """Frame stacking over a batched auto-resetting env (``AutoResetWrapper``
  or anything with its interface): observations become [B, ..., C * N],
  the newest frame last. On ``done`` the history refills with the
  post-reset frame, so an episode never sees frames of the one before.
  ``legal_action_mask`` reads the inner env's."""

  def __init__(self, env, num_stack: int = 4):
    self.env = env
    self.num_stack = num_stack
    s = env.spec
    c = s.observation_shape[-1]
    self.spec = EnvSpec(
        observation_shape=tuple(s.observation_shape[:-1]) + (c * num_stack,),
        num_actions=s.num_actions,
        max_episode_steps=s.max_episode_steps,
        obs_dtype=s.obs_dtype)

  def legal_action_mask(self, carry: AutoResetState):
    return self.env.legal_action_mask(carry.env_state[0])

  def _stacked(self, frames: torch.Tensor) -> torch.Tensor:
    # [B, N, ..., C] -> [B, ..., N*C], newest last.
    return torch.cat(frames.unbind(1), -1)

  def reset(self, generator: torch.Generator,
            batch_size: int) -> AutoResetState:
    inner = self.env.reset(generator, batch_size)
    frames = inner.obs[:, None].repeat_interleave(self.num_stack, 1)
    return AutoResetState(env_state=(inner, frames),
                          obs=self._stacked(frames),
                          episode_step=inner.episode_step,
                          episode_return=inner.episode_return)

  def step(self, carry: AutoResetState, action: torch.Tensor,
           generator: torch.Generator):
    inner, frames = carry.env_state
    new_inner, reward, done, info = self.env.step(inner, action, generator)
    frames = torch.cat([frames[:, 1:], new_inner.obs[:, None]], 1)
    fresh = new_inner.obs[:, None].repeat_interleave(self.num_stack, 1)
    d = done.reshape((-1,) + (1,) * (frames.ndim - 1))
    frames = torch.where(d, fresh, frames)
    new_carry = AutoResetState(env_state=(new_inner, frames),
                               obs=self._stacked(frames),
                               episode_step=new_inner.episode_step,
                               episode_return=new_inner.episode_return)
    return new_carry, reward, done, info
