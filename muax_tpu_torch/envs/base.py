"""Batched environment API on the device (``muax_tpu/envs/base.py``).

Environments step B instances at once as tensors; there is no vmap. Reset
and step draw their randomness from an explicit ``torch.Generator`` that lies
on the environments' device. The step semantics are (state, obs, reward,
done) with auto-reset layered on top.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, NamedTuple, Tuple

import torch


class EnvSpec(NamedTuple):
  observation_shape: Tuple[int, ...]
  num_actions: int
  max_episode_steps: int
  # Storage dtype of observations (None = float32).
  obs_dtype: Any = None


class Environment(abc.ABC):
  """Batched env: every method works on B instances at once."""

  spec: EnvSpec

  @abc.abstractmethod
  def reset(self, generator: torch.Generator, batch_size: int):
    """(generator, B) -> (state, obs [B, ...]) on the generator's device."""

  @abc.abstractmethod
  def step(self, state, action: torch.Tensor):
    """(state, action [B]) -> (state, obs, reward [B], terminated [B])

    Time-limit truncation is the wrapper's business.
    """


def _select(done: torch.Tensor, fresh, cur):
  """``where(done, fresh, cur)`` over a tensor or a dataclass of tensors."""
  if dataclasses.is_dataclass(cur):
    return dataclasses.replace(cur, **{
        f.name: _select(done, getattr(fresh, f.name), getattr(cur, f.name))
        for f in dataclasses.fields(cur)})
  d = done.reshape(done.shape + (1,) * (cur.ndim - 1))
  return torch.where(d, fresh, cur)


@dataclasses.dataclass
class AutoResetState:
  env_state: Any
  obs: torch.Tensor
  episode_step: torch.Tensor    # [B] int32
  episode_return: torch.Tensor  # [B] f32 accumulated return (monitoring)


class AutoResetWrapper:
  """Batched auto-reset: a done env is immediately re-seeded in place.

  The post-step observation exposed for storage is the *new* episode's first
  observation, matching vectorized rollout buffers.
  """

  def __init__(self, env: Environment):
    self.env = env
    self.spec = env.spec

  def legal_action_mask(self, carry: AutoResetState):
    """[B, A] float mask (1 = legal) of the current states, or None for an
    env without ``legal_actions``."""
    if hasattr(self.env, "legal_actions"):
      return self.env.legal_actions(carry.env_state)
    return None

  def reset(self, generator: torch.Generator,
            batch_size: int) -> AutoResetState:
    state, obs = self.env.reset(generator, batch_size)
    return AutoResetState(
        env_state=state,
        obs=obs,
        episode_step=torch.zeros(batch_size, dtype=torch.int32,
                                 device=obs.device),
        episode_return=torch.zeros(batch_size, dtype=torch.float32,
                                   device=obs.device),
    )

  def step(self, carry: AutoResetState, action: torch.Tensor,
           generator: torch.Generator):
    """Returns (new_carry, reward, done, info dict)."""
    batch_size = action.shape[0]
    state, obs, reward, terminated = self.env.step(carry.env_state, action)
    episode_step = carry.episode_step + 1
    truncated = episode_step >= self.spec.max_episode_steps
    done = terminated | truncated

    # Every env draws a fresh start so the generator advances by the same
    # amount whatever the dones are.
    fresh_state, fresh_obs = self.env.reset(generator, batch_size)

    episode_return = carry.episode_return + reward
    new_carry = AutoResetState(
        env_state=_select(done, fresh_state, state),
        obs=_select(done, fresh_obs, obs),
        episode_step=torch.where(done, torch.zeros_like(episode_step),
                                 episode_step),
        episode_return=torch.where(done, torch.zeros_like(episode_return),
                                   episode_return),
    )
    info = {
        "terminated": terminated,
        "truncated": truncated,
        "episode_return": episode_return,  # valid where done
    }
    return new_carry, reward, done, info
