"""Host gymnasium environments beside the device program
(``muax_tpu/envs/gym_adapter.py``).

The way to train on environments that do not run on the device
(LunarLander, Atari, open_spiel games, the native 2048 pool): a pool of N
host environments is stepped by one plain host call per rollout step. The
device program is the same as for every other env; only the transition
crosses between host and device: the actions come to the host once a step
(one device-to-host copy, which waits for the search), and the
observations, rewards and done flags go to the pool's device in one
host-to-device copy.

``GymVectorPool`` speaks the ``AutoResetWrapper`` interface (reset(generator,
batch), step(carry, action, generator), legal_action_mask(carry)), with the
auto-reset done on the host, so ``make_rollout_fn`` and ``fit`` take it as
it is. ``HostPool`` is the device-facing half every host pool shares.

Each step costs one host round trip over the whole batch; the on-device
envs remain the fast path. The JAX package's ``ensure_host_callback_backend``
(a probe of JAX backends for ``io_callback``) has no counterpart: a host
call needs no backend support here.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from muax_tpu_torch.device import resolve_device
from muax_tpu_torch.envs.base import AutoResetState, EnvSpec


class HostPool:
  """The device-facing half of a host pool: subclasses set ``num_envs``,
  ``spec`` and ``device`` and give ``_host_reset_all() -> obs`` and
  ``_host_step(action) -> (obs, reward, done)`` over numpy arrays; a pool
  that carries state to the device (the 2048 pool's legal mask) overrides
  ``reset`` and ``step`` through ``_start`` and ``_advance``."""

  num_envs: int
  spec: EnvSpec
  device: torch.device

  def _upload(self, *arrays: np.ndarray) -> Tuple[torch.Tensor, ...]:
    """The arrays (a leading batch axis each) on the pool's device, in one
    host-to-device copy of their float32 concatenation."""
    n = self.num_envs
    flat = [np.asarray(a, np.float32).reshape(n, -1) for a in arrays]
    packed = torch.from_numpy(np.concatenate(flat, axis=1)).to(self.device)
    out, col = [], 0
    for a, f in zip(arrays, flat):
      out.append(packed[:, col:col + f.shape[1]].reshape(np.shape(a)))
      col += f.shape[1]
    return tuple(out)

  def _check_batch(self, batch_size: int):
    if batch_size != self.num_envs:
      raise ValueError(f"batch_size {batch_size} != pool size "
                       f"{self.num_envs}")

  def _start(self, obs, env_state=()) -> AutoResetState:
    zeros = torch.zeros(self.num_envs, device=self.device)
    return AutoResetState(env_state=env_state, obs=obs,
                          episode_step=zeros.to(torch.int32),
                          episode_return=zeros)

  def _advance(self, carry: AutoResetState, obs, reward, done,
               env_state=(), **info):
    """The carry after a host step: obs, reward [B] and done [B] (bool) on
    the device; ``info`` adds entries to the step's info dict."""
    episode_return = carry.episode_return + reward
    new_carry = AutoResetState(
        env_state=env_state, obs=obs,
        episode_step=torch.where(done, torch.zeros_like(carry.episode_step),
                                 carry.episode_step + 1),
        episode_return=torch.where(done, torch.zeros_like(episode_return),
                                   episode_return))
    return new_carry, reward, done, {
        "terminated": done, "truncated": torch.zeros_like(done),
        "episode_return": episode_return, **info}

  def legal_action_mask(self, carry: AutoResetState):
    """None: a gym pool has no legal-action mask."""
    del carry
    return None

  def reset(self, generator: torch.Generator,
            batch_size: int) -> AutoResetState:
    del generator  # the host envs draw from their own seeds
    self._check_batch(batch_size)
    obs, = self._upload(self._host_reset_all())
    return self._start(obs)

  def step(self, carry: AutoResetState, action: torch.Tensor,
           generator: torch.Generator):
    del generator
    obs, reward, done = self._host_step(action.cpu().numpy())
    obs, reward, done = self._upload(obs, reward, done)
    return self._advance(carry, obs, reward, done > 0)


class GymVectorPool(HostPool):
  """N host gymnasium envs with host-side auto-reset; each reset of env i
  takes the next of its seeds seed + i, seed + i + N, ...

  The pool lies on ``device`` (the card by default; ``device="cpu"`` for
  the CPU): its observations, rewards and done flags are made there.
  """

  def __init__(self, env_id: str, num_envs: int, seed: int = 0,
               device="cuda", **kwargs):
    import gymnasium

    self.device = resolve_device(device)
    self.num_envs = num_envs
    self._envs = [gymnasium.make(env_id, **kwargs) for _ in range(num_envs)]
    self._seeds = list(range(seed, seed + num_envs))
    env0 = self._envs[0]
    self.spec = EnvSpec(
        observation_shape=tuple(env0.observation_space.shape),
        num_actions=int(env0.action_space.n),
        max_episode_steps=env0.spec.max_episode_steps or 1000)

  # -- host side -----------------------------------------------------------
  def _reset_env(self, i):
    o, _ = self._envs[i].reset(seed=self._seeds[i])
    self._seeds[i] += self.num_envs
    return o

  def _host_reset_all(self):
    obs = np.zeros((self.num_envs,) + self.spec.observation_shape,
                   np.float32)
    for i in range(self.num_envs):
      obs[i] = self._reset_env(i)
    return obs

  def _host_step(self, action):
    obs = np.zeros((self.num_envs,) + self.spec.observation_shape,
                   np.float32)
    rew = np.zeros((self.num_envs,), np.float32)
    done = np.zeros((self.num_envs,), bool)
    for i, env in enumerate(self._envs):
      o, r, terminated, truncated, _ = env.step(int(action[i]))
      if terminated or truncated:
        done[i] = True
        o = self._reset_env(i)
      obs[i] = o
      rew[i] = r
    return obs, rew, done
