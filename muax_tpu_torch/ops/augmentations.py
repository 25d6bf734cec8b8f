"""Image augmentations for the learner's ``observation_transform`` hook
(``muax_tpu/ops/augmentations.py``): the DrQ pair that EfficientZero trains
with, a random shift and a random intensity, over [B, H, W, C] or
[B, L, H, W, C] batches with one draw per window, shared across its unroll
so the dynamics' targets stay valid.

Each is split into a draw from the generator and a pure apply
(``shift_obs``, ``scale_intensity``), so the same draws can be fed to both
sides of a comparison. ``transform(generator, obs)`` is the hook's
signature (``train/learner.py``).
"""
from __future__ import annotations

import torch


def shift_obs(obs: torch.Tensor, shift: torch.Tensor,
              pad: int) -> torch.Tensor:
  """Translate each window's frames by ``shift`` [B, 2] (row, column offsets
  in [0, 2 * pad]) within the frame edge-padded by ``pad``: output pixel
  (h, w) reads padded pixel (h + shift_row, w + shift_col), and a padded
  pixel is the nearest edge pixel."""
  windowed = obs.ndim == 5
  if not windowed:
    obs = obs[:, None]
  B, L, H, W, _ = obs.shape
  dev = obs.device
  shift = shift.to(dev, torch.long)
  rows = torch.clamp(shift[:, :1] + torch.arange(H, device=dev) - pad, 0,
                     H - 1)
  cols = torch.clamp(shift[:, 1:] + torch.arange(W, device=dev) - pad, 0,
                     W - 1)
  out = obs[torch.arange(B, device=dev)[:, None, None, None],
            torch.arange(L, device=dev)[None, :, None, None],
            rows[:, None, :, None], cols[:, None, None, :]]
  return out if windowed else out[:, 0]


def random_shift(generator: torch.Generator, obs: torch.Tensor,
                 pad: int = 4) -> torch.Tensor:
  """A random translation of +-``pad`` pixels with edge padding, one per
  window."""
  shift = torch.randint(0, 2 * pad + 1, (obs.shape[0], 2),
                        generator=generator, device=obs.device)
  return shift_obs(obs, shift, pad)


def scale_intensity(obs: torch.Tensor, noise: torch.Tensor,
                    scale: float) -> torch.Tensor:
  """obs * (1 + scale * noise), one ``noise`` [B] entry per window."""
  factor = 1.0 + scale * noise.to(obs.device)
  return obs * factor.reshape((obs.shape[0],) + (1,) * (obs.ndim - 1))


def random_intensity(generator: torch.Generator, obs: torch.Tensor,
                     scale: float = 0.05) -> torch.Tensor:
  """A multiplicative intensity jitter per window: n ~ N(0, 1) clipped to
  [-2, 2] (the EfficientZero setting)."""
  noise = torch.randn((obs.shape[0],), generator=generator,
                      device=obs.device)
  return scale_intensity(obs, torch.clamp(noise, -2.0, 2.0), scale)


def drq_augmentation(pad: int = 4, intensity_scale: float = 0.05):
  """The shift then the intensity jitter, ready for
  ``TrainConfig.observation_transform``."""

  def transform(generator: torch.Generator,
                obs: torch.Tensor) -> torch.Tensor:
    return random_intensity(generator, random_shift(generator, obs, pad),
                            intensity_scale)

  transform.__name__ = f"drq_pad{pad}_int{intensity_scale}"
  return transform
