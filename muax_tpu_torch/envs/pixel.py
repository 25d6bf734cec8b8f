"""Pixel-observation environments on the device (``muax_tpu/envs/pixel.py``).

* ``PixelObsEnv`` renders a 2-D board env's observations [B, H, W] as
  images [B, H * scale, W * scale, 1] (nearest-neighbour upsample);
* ``PixelCatch`` is Catch at pixel scale, the conv families' test bed.

Dynamics, rewards and termination pass through unchanged. A non-f32
``dtype`` (uint8, as Atari frames are stored) becomes the spec's
``obs_dtype``, so the replay ring stores raw bytes and the conv
representation up-casts them on entry. Compose with
``FrameStackingEnv(stack=False)`` or ``PoolFrameStacking`` for
channel-stacked frames (``envs/wrappers.py``).
"""
from __future__ import annotations

import torch

from muax_tpu_torch.envs.base import Environment, EnvSpec
from muax_tpu_torch.envs.catch import Catch


class PixelObsEnv(Environment):
  """Wrap a 2-D-observation env; observations become [B, H*s, W*s, 1]
  images of ``dtype``."""

  def __init__(self, env: Environment, scale: int = 8,
               dtype=torch.float32):
    if len(env.spec.observation_shape) != 2:
      raise ValueError("PixelObsEnv wraps 2D-board observations, got "
                       f"{env.spec.observation_shape}")
    self.env = env
    self.scale = scale
    self.dtype = dtype
    h, w = env.spec.observation_shape
    self.spec = EnvSpec(
        observation_shape=(h * scale, w * scale, 1),
        num_actions=env.spec.num_actions,
        max_episode_steps=env.spec.max_episode_steps,
        obs_dtype=None if dtype == torch.float32 else dtype)

  def _render(self, board: torch.Tensor) -> torch.Tensor:
    img = board.repeat_interleave(self.scale, 1).repeat_interleave(
        self.scale, 2)
    return img[..., None].to(self.dtype)

  def reset(self, generator: torch.Generator, batch_size: int):
    state, obs = self.env.reset(generator, batch_size)
    return state, self._render(obs)

  def step(self, state, action: torch.Tensor):
    state, obs, reward, done = self.env.step(state, action)
    return state, self._render(obs), reward, done


class PixelCatch(PixelObsEnv):
  """Catch rendered as pixels. ``PixelCatch(10, 5, scale=8)`` gives
  80 x 40 x 1 frames; ``dtype=torch.uint8`` stores them as bytes end to
  end, the replay ring included."""

  def __init__(self, rows: int = 10, columns: int = 5, scale: int = 8,
               dtype=torch.float32):
    super().__init__(Catch(rows=rows, columns=columns), scale=scale,
                     dtype=dtype)
