"""stable-baselines3 bridge classes (``muax_tpu/adapters/sb3/sb3_bridge.py``;
the reference's muax/frameworks/sb3/common/policies.py:17-108 and
on_policy_algorithm.py:15-219), driving a port agent's ``act`` and
``update``. Importing this module requires stable-baselines3; everything
dependency-free lives in ``buffers.py``.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

try:
  import stable_baselines3  # noqa: F401
  from stable_baselines3.common.base_class import BaseAlgorithm
  from stable_baselines3.common.policies import BasePolicy
except ImportError as e:
  raise ImportError(
      "muax_tpu_torch.adapters.sb3's policy/algorithm classes need "
      "stable-baselines3 (`pip install stable-baselines3`); "
      "MuaxRolloutBuffer has no sb3 dependency and imports without it."
  ) from e

from muax_tpu_torch.adapters.sb3.buffers import MuaxRolloutBuffer


def _host(x) -> np.ndarray:
  return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else (
      np.asarray(x))


class MuaxPolicy(BasePolicy):
  """Bridges a port agent (root inference + search) into the sb3
  ``predict`` contract: takes numpy observations from a VecEnv, returns
  numpy actions. Its searches draw from one generator on the agent's
  device, seeded with 0 (the JAX bridge's ``PRNGKey(0)``)."""

  def __init__(self, observation_space, action_space, agent,
               deterministic_temperature: float = 0.0, **kwargs):
    kwargs.pop("lr_schedule", None)
    super().__init__(observation_space=observation_space,
                     action_space=action_space, **kwargs)
    self.agent = agent
    self.deterministic_temperature = deterministic_temperature
    self._generator = torch.Generator(agent.device).manual_seed(0)

  def prepare_obs(self, observation):
    obs = np.asarray(observation, np.float32)
    vectorized = obs.ndim > len(self.observation_space.shape)
    if not vectorized:
      obs = obs[None]
    return obs, vectorized

  def _predict(self, observation, deterministic: bool = False):
    temperature = (self.deterministic_temperature if deterministic
                   else float(self.agent.params.temperature))
    action = self.agent.act(self._generator, observation,
                            obs_from_batch=True, temperature=temperature)
    return _host(action)

  def predict(self, observation, state=None, episode_start=None,
              deterministic: bool = False):
    observation, vectorized = self.prepare_obs(observation)
    actions = self._predict(observation, deterministic=deterministic)
    actions = np.array(actions).reshape((-1,) + self.action_space.shape)
    if not vectorized:
      actions = actions.squeeze(axis=0)
    return actions, state

  def forward(self, *args, **kwargs):  # sb3 abstract hook
    raise NotImplementedError


class OnPolicyAlgorithmMuax(BaseAlgorithm):
  """On-policy loop over an sb3 VecEnv: collect ``n_steps`` from every
  env into a MuaxRolloutBuffer, bootstrap truncation timeouts with the
  agent's value, compute Rn and PER weights at rollout end, then hand
  minibatches to the agent's update."""

  def __init__(self, agent, env, n_steps: int = 128, k_steps: int = 5,
               n_step_bootstrapping: int = 10, gamma: float = 0.99,
               batch_size: int = 64,
               update_fn: Optional[Callable[[Any], float]] = None,
               policy_kwargs=None, **kwargs):
    self.agent = agent
    self._custom_update = update_fn
    super().__init__(policy=MuaxPolicy, env=env, learning_rate=0.0,
                     policy_kwargs=policy_kwargs or {}, **kwargs)
    self.n_steps = n_steps
    self.batch_size = batch_size
    self.rollout_buffer = MuaxRolloutBuffer(
        buffer_size=n_steps,
        obs_shape=self.observation_space.shape,
        action_shape=self.action_space.shape,
        pi_shape=(getattr(self.action_space, "n", 0),),
        n_envs=env.num_envs, k_steps=k_steps,
        n_step_bootstrapping=n_step_bootstrapping, gamma_t=gamma)
    self._last_obs = None
    self._last_episode_starts = None

  def _setup_model(self) -> None:
    self.policy = MuaxPolicy(self.observation_space, self.action_space,
                             self.agent, **self.policy_kwargs)

  def collect_rollouts(self, env, rollout_buffer: MuaxRolloutBuffer):
    if self._last_obs is None:
      self._last_obs = env.reset()
      self._last_episode_starts = np.ones((env.num_envs,), np.float32)
    rollout_buffer.reset()
    generator = torch.Generator(self.agent.device).manual_seed(
        int(self.num_timesteps))
    for _ in range(self.n_steps):
      action, pi, value = self.agent.act(
          generator, np.asarray(self._last_obs, np.float32),
          obs_from_batch=True, with_pi=True, with_value=True)
      actions = _host(action)
      new_obs, rewards, dones, infos = env.step(actions)
      # Timeout bootstrap: truncated episodes get the agent's value of the
      # terminal observation added to the reward.
      for i, info in enumerate(infos):
        if (dones[i] and info.get("TimeLimit.truncated", False)
            and "terminal_observation" in info):
          term_obs = np.asarray(info["terminal_observation"],
                                np.float32)[None]
          _, _, term_value = self.agent.act(
              generator, term_obs, obs_from_batch=True, with_pi=True,
              with_value=True)
          rewards[i] += self.rollout_buffer.gamma_t * float(
              _host(term_value)[0])
      rollout_buffer.add(self._last_obs, actions, rewards, _host(value),
                         _host(pi), self._last_episode_starts)
      self._last_obs = new_obs
      self._last_episode_starts = dones.astype(np.float32)
      self.num_timesteps += env.num_envs

    _, _, last_values = self.agent.act(
        generator, np.asarray(self._last_obs, np.float32),
        obs_from_batch=True, with_pi=True, with_value=True)
    rollout_buffer.compute_Rn_and_weights(_host(last_values),
                                          self._last_episode_starts)
    return True

  def train(self) -> None:
    for batch in self.rollout_buffer.get(self.batch_size):
      if self._custom_update is not None:
        self._custom_update(batch)
      else:
        self.agent.update(batch)

  def learn(self, total_timesteps: int, **kwargs):
    while self.num_timesteps < total_timesteps:
      self.collect_rollouts(self.env, self.rollout_buffer)
      self.train()
    return self
