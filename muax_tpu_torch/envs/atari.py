"""Real-ALE Atari through the host pool (``muax_tpu/envs/atari.py``).

The reference runs Atari through acme's GymAtariAdapter and AtariWrapper
(examples/rl_discrete/helpers.py:71-107): 84 x 84 grayscale, a max-pool
over the last two raw frames, action repeat 4, an episode cap of 108,000
raw frames, terminal on life loss, and frame stacking on the actor's
side. Here the same preprocessing runs on the host for each env of the
pool (``AtariPreprocessing``, numpy, with cv2's area resize where cv2
imports), the pool steps N envs in one host call (``AtariVectorPool``),
and frame stacking stays on the device (``envs.wrappers.PoolFrameStacking``),
so the device program is that of every other pixel env.

ALE (``ale_py``) is optional: building the pool without it raises.
``AtariPreprocessing`` depends on nothing and works on any gymnasium-style
env of RGB or grayscale frames, which is how the tests drive it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from muax_tpu_torch.device import resolve_device
from muax_tpu_torch.envs.base import EnvSpec
from muax_tpu_torch.envs.gym_adapter import GymVectorPool


class AtariPreprocessing:
  """Standard Atari preprocessing (Machado et al. 2018, the MuZero
  appendix), acme's AtariWrapper chain on the host (reference
  helpers.py:84-102):

    * action repeat ``frame_skip`` (default 4), rewards summed,
    * max-pool over the last two raw frames (flicker),
    * grayscale and resize to ``screen_size`` x ``screen_size``,
    * observations scaled to [0, 1] float32, shape [H, W, 1],
    * ``terminal_on_life_loss``: a lost life ends the agent's episode (the
      env goes on from its state at the next reset),
    * sticky actions with probability ``repeat_action_probability``,
    * a cap of ``max_episode_steps`` raw frames (reference: 108,000).

  Works with any env whose ``step`` returns gymnasium's 5-tuple and whose
  observations are uint8 or float RGB or grayscale frames.
  """

  def __init__(self, env, *, frame_skip: int = 4, screen_size: int = 84,
               terminal_on_life_loss: bool = True,
               repeat_action_probability: float = 0.0,
               max_episode_steps: int = 108_000, seed: Optional[int] = None):
    if frame_skip < 1:
      raise ValueError("frame_skip must be >= 1")
    self.env = env
    self.frame_skip = frame_skip
    self.screen_size = screen_size
    self.terminal_on_life_loss = terminal_on_life_loss
    self.repeat_action_probability = repeat_action_probability
    self.max_episode_steps = max_episode_steps
    self._rng = np.random.RandomState(seed)
    self._last_action = 0
    self._lives = 0
    self._steps = 0
    self._needs_real_reset = True
    shape = env.observation_space.shape
    self._pool_buf = np.zeros((2,) + tuple(shape[:2]), np.float32)

  # -- helpers --------------------------------------------------------------
  def _ale_lives(self) -> int:
    ale = getattr(getattr(self.env, "unwrapped", self.env), "ale", None)
    return int(ale.lives()) if ale is not None else 0

  def _to_gray(self, frame: np.ndarray) -> np.ndarray:
    frame = np.asarray(frame, np.float32)
    if frame.ndim == 3 and frame.shape[-1] == 3:
      # ITU-R 601 luma, what cv2.cvtColor(RGB2GRAY) computes.
      frame = (0.299 * frame[..., 0] + 0.587 * frame[..., 1]
               + 0.114 * frame[..., 2])
    elif frame.ndim == 3:
      frame = frame[..., 0]
    return frame

  def _resize(self, frame: np.ndarray) -> np.ndarray:
    s = self.screen_size
    if frame.shape == (s, s):
      return frame
    try:
      import cv2
      return cv2.resize(frame, (s, s), interpolation=cv2.INTER_AREA)
    except ImportError:
      # Nearest neighbour without cv2.
      ys = (np.arange(s) * frame.shape[0] // s).clip(0, frame.shape[0] - 1)
      xs = (np.arange(s) * frame.shape[1] // s).clip(0, frame.shape[1] - 1)
      return frame[np.ix_(ys, xs)]

  def _observation(self) -> np.ndarray:
    pooled = self._pool_buf.max(axis=0)  # frames kept in grayscale
    obs = self._resize(pooled)
    return (obs / 255.0).astype(np.float32)[..., None]

  # -- gym-style API --------------------------------------------------------
  def reset(self, seed: Optional[int] = None):
    if self._needs_real_reset or not self.terminal_on_life_loss:
      kwargs = {} if seed is None else {"seed": seed}
      frame, info = self.env.reset(**kwargs)
      self._steps = 0
    else:
      # After a lost life the underlying episode goes on with a no-op
      # step (acme's AtariWrapper).
      frame, _, terminated, truncated, info = self.env.step(0)
      if terminated or truncated:
        frame, info = self.env.reset()
        self._steps = 0
    self._needs_real_reset = False
    self._lives = self._ale_lives()
    self._last_action = 0
    gray = self._to_gray(frame)
    self._pool_buf[0] = gray
    self._pool_buf[1] = gray
    return self._observation(), info

  def step(self, action: int):
    if (self.repeat_action_probability > 0.0
        and self._rng.rand() < self.repeat_action_probability):
      action = self._last_action
    self._last_action = action

    total_reward = 0.0
    terminated = truncated = False
    info = {}
    frames_stepped = 0
    for t in range(self.frame_skip):
      frame, reward, terminated, truncated, info = self.env.step(action)
      frames_stepped += 1
      total_reward += float(reward)
      # Pool over the last two raw frames only (ALE's pooling).
      if t >= self.frame_skip - 2:
        self._pool_buf[t - (self.frame_skip - 2)] = self._to_gray(frame)
      if terminated or truncated:
        break
    if frames_stepped < self.frame_skip or self.frame_skip == 1:
      # An episode that ended inside the skip (or no pooling window): the
      # observation is the last frame seen, not a pool of the previous
      # step's frames.
      self._pool_buf[0] = self._to_gray(frame)
      self._pool_buf[1] = self._pool_buf[0]

    self._steps += frames_stepped
    if self._steps >= self.max_episode_steps:
      truncated = True

    life_lost = False
    if self.terminal_on_life_loss:
      lives = self._ale_lives()
      life_lost = 0 < lives < self._lives
      self._lives = lives
    self._needs_real_reset = terminated or truncated
    done_for_agent = terminated or life_lost
    return (self._observation(), total_reward, done_for_agent, truncated,
            info)


class AtariVectorPool(GymVectorPool):
  """N preprocessed ALE envs stepped by one host call; ``fit`` and
  ``make_rollout_fn`` take it as any pool. Pair it with
  ``envs.wrappers.PoolFrameStacking`` on the device for the reference's
  stacked frames (helpers.py:99-104)."""

  def __init__(self, game: str, num_envs: int, seed: int = 0,
               frame_skip: int = 4, screen_size: int = 84,
               terminal_on_life_loss: bool = True,
               repeat_action_probability: float = 0.0,
               max_episode_steps: int = 108_000, device="cuda"):
    try:
      import ale_py  # noqa: F401
      import gymnasium
      gymnasium.register_envs(ale_py)
    except ImportError as e:
      raise ImportError(
          "AtariVectorPool needs ale_py (`pip install ale-py "
          "gymnasium[atari]`); the preprocessing (AtariPreprocessing) has "
          "no ALE dependency and is tested on synthetic frames.") from e
    import gymnasium

    self.device = resolve_device(device)
    self.num_envs = num_envs
    env_id = game if "/" in game or game.endswith("-v5") else f"ALE/{game}-v5"
    self._envs = [
        AtariPreprocessing(
            # frameskip=1 and no sticky actions inside ALE: the wrapper
            # does all the preprocessing, as acme's does.
            gymnasium.make(env_id, frameskip=1,
                           repeat_action_probability=0.0),
            frame_skip=frame_skip, screen_size=screen_size,
            terminal_on_life_loss=terminal_on_life_loss,
            repeat_action_probability=repeat_action_probability,
            max_episode_steps=max_episode_steps, seed=seed + i)
        for i in range(num_envs)
    ]
    self._seeds = list(range(seed, seed + num_envs))
    self.spec = EnvSpec(
        observation_shape=(screen_size, screen_size, 1),
        num_actions=int(self._envs[0].env.action_space.n),
        max_episode_steps=max_episode_steps // frame_skip)

  def _host_step(self, action):
    # GymVectorPool's step over AtariPreprocessing's (obs, reward, done,
    # truncated, info), with the life-loss resets.
    obs = np.zeros((self.num_envs,) + self.spec.observation_shape,
                   np.float32)
    rew = np.zeros((self.num_envs,), np.float32)
    done = np.zeros((self.num_envs,), bool)
    for i, env in enumerate(self._envs):
      o, r, d, truncated, _ = env.step(int(action[i]))
      if d or truncated:
        done[i] = True
        o = self._reset_env(i)
      obs[i] = o
      rew[i] = r
    return obs, rew, done
