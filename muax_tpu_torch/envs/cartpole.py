"""Batched CartPole-v1 in f32 on the device (``muax_tpu/envs/cartpole.py``).

Gymnasium CartPole-v1 semantics: Euler integration at tau=0.02, termination
at |x| > 2.4 or |theta| > 12 degrees, reward 1 per step; the 500-step limit
is applied by ``AutoResetWrapper`` from ``spec.max_episode_steps``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from muax_tpu_torch.envs.base import Environment, EnvSpec

_GRAVITY = 9.8
_MASSCART = 1.0
_MASSPOLE = 0.1
_TOTAL_MASS = _MASSCART + _MASSPOLE
_LENGTH = 0.5  # half pole length
_POLEMASS_LENGTH = _MASSPOLE * _LENGTH
_FORCE_MAG = 10.0
_TAU = 0.02
_THETA_LIMIT = 12 * 2 * math.pi / 360
_X_LIMIT = 2.4


@dataclasses.dataclass
class CartPoleState:
  x: torch.Tensor          # [B] f32
  x_dot: torch.Tensor
  theta: torch.Tensor
  theta_dot: torch.Tensor


class CartPole(Environment):

  spec = EnvSpec(observation_shape=(4,), num_actions=2,
                 max_episode_steps=500)

  def reset(self, generator: torch.Generator, batch_size: int):
    vals = torch.rand((4, batch_size), generator=generator,
                      device=generator.device) * 0.1 - 0.05
    state = CartPoleState(x=vals[0], x_dot=vals[1], theta=vals[2],
                          theta_dot=vals[3])
    return state, self._obs(state)

  def step(self, state: CartPoleState, action: torch.Tensor):
    force = torch.where(action == 1, _FORCE_MAG, -_FORCE_MAG).to(
        state.x.dtype)
    cos_t = torch.cos(state.theta)
    sin_t = torch.sin(state.theta)
    temp = (force + _POLEMASS_LENGTH * state.theta_dot**2 * sin_t
            ) / _TOTAL_MASS
    theta_acc = (_GRAVITY * sin_t - cos_t * temp) / (
        _LENGTH * (4.0 / 3.0 - _MASSPOLE * cos_t**2 / _TOTAL_MASS))
    x_acc = temp - _POLEMASS_LENGTH * theta_acc * cos_t / _TOTAL_MASS

    new = CartPoleState(
        x=state.x + _TAU * state.x_dot,
        x_dot=state.x_dot + _TAU * x_acc,
        theta=state.theta + _TAU * state.theta_dot,
        theta_dot=state.theta_dot + _TAU * theta_acc,
    )
    done = (torch.abs(new.x) > _X_LIMIT) | (torch.abs(new.theta)
                                             > _THETA_LIMIT)
    reward = torch.ones_like(new.x)
    return new, self._obs(new), reward, done

  @staticmethod
  def _obs(state: CartPoleState) -> torch.Tensor:
    return torch.stack([state.x, state.x_dot, state.theta, state.theta_dot],
                       dim=-1).to(torch.float32)
