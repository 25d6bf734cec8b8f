"""Vectorized-env rollout buffer with MuZero targets
(``muax_tpu/adapters/sb3/buffers.py``, numpy, kept as the port's own copy):
the capability of the reference's sb3 ``MuaxRolloutBuffer``
(muax/frameworks/sb3/common/buffers.py:95-282) as standalone numpy (no
stable-baselines3 dependency; the sb3 classes only supplied storage
plumbing there).

Semantics preserved:
  * fixed ``[buffer_size, n_envs]`` storage of obs/action/reward/value/
    pi/episode_starts filled by ``add`` (buffers.py:189-207),
  * ``compute_Rn_and_weights``: n-step / lambda bootstrapped returns that
    honor episode starts, padded past the buffer end with the provided
    ``last_values``/``dones`` (buffers.py:154-187) — here computed with n
    vectorized passes over the whole ``[T, n_envs]`` block instead of the
    reference's O(T*n) Python loop,
  * PER weights ``|v - Rn| ** alpha`` and importance-sampling correction
    ``((1/N) * (sum w / w)) ** beta`` at sample time (buffers.py:180,
    258-265),
  * ``get``: k-step window minibatches over feasible start indices
    (windows that would cross an episode start or the buffer tail are
    masked out), uniform-shuffled or priority-sampled (buffers.py:208-250).

One deliberate divergence: the reference flattens ``[T, n_envs]``
TIME-major, so a "window" of consecutive flat indices interleaves
different envs — correct only for ``n_envs == 1`` (consistent with the
adapter's "not recommended yet" status). This implementation flattens
ENV-major so every window is consecutive in time within one env, and
masks windows that would cross an env boundary.
"""
from __future__ import annotations

from typing import Generator, NamedTuple, Optional, Tuple

import numpy as np


class MuaxRolloutBufferSamples(NamedTuple):
  """One minibatch of [batch, k_steps, ...] windows (type parity with
  sb3/common/type_aliases.py:9-26)."""
  observations: np.ndarray
  actions: np.ndarray
  rewards: np.ndarray
  Rn: np.ndarray
  pi: np.ndarray
  weights: np.ndarray


class MuaxRolloutBuffer:
  """Fixed-size on-policy rollout buffer over n_envs vectorized envs."""

  def __init__(
      self,
      buffer_size: int,
      obs_shape: Tuple[int, ...],
      action_shape: Tuple[int, ...] = (),
      pi_shape: Tuple[int, ...] = (),
      n_envs: int = 1,
      k_steps: int = 5,
      n_step_bootstrapping: int = 10,
      lambda_t: float = 1.0,
      gamma_t: float = 0.99,
      prioritized_sampling: bool = False,
      prioritized_alpha: float = 1.0,
      prioritized_beta: float = 1.0,
      seed: Optional[int] = None,
  ):
    self.buffer_size = buffer_size
    self.obs_shape = tuple(obs_shape)
    self.action_shape = tuple(action_shape)
    self.pi_shape = tuple(pi_shape)
    self.n_envs = n_envs
    self.k_steps = k_steps
    self.n_step_bootstrapping = n_step_bootstrapping
    self.lambda_t = lambda_t
    self.gamma_t = gamma_t
    self.prioritized_sampling = prioritized_sampling
    self.prioritized_alpha = prioritized_alpha
    self.prioritized_beta = prioritized_beta
    self._rng = np.random.default_rng(seed)
    self.reset()

  def reset(self) -> None:
    T, E = self.buffer_size, self.n_envs
    self.observations = np.zeros((T, E) + self.obs_shape, np.float32)
    self.actions = np.zeros((T, E) + self.action_shape, np.float32)
    self.rewards = np.zeros((T, E), np.float32)
    self.Rn = np.zeros((T, E), np.float32)
    self.values = np.zeros((T, E), np.float32)
    self.pi = np.zeros((T, E) + self.pi_shape, np.float32)
    self.weights = np.ones((T, E), np.float32)
    self.episode_starts = np.zeros((T, E), np.float32)
    self.pos = 0
    self.full = False

  def add(self, obs, action, reward, value, pi, episode_start) -> None:
    E = self.n_envs
    self.observations[self.pos] = np.reshape(obs, (E,) + self.obs_shape)
    self.actions[self.pos] = np.reshape(action, (E,) + self.action_shape)
    self.rewards[self.pos] = np.reshape(reward, (E,))
    self.values[self.pos] = np.reshape(value, (E,))
    self.pi[self.pos] = np.reshape(pi, (E,) + self.pi_shape)
    self.episode_starts[self.pos] = np.reshape(episode_start, (E,))
    self.pos += 1
    if self.pos == self.buffer_size:
      self.full = True

  def compute_Rn_and_weights(self, last_values, dones,
                             n: Optional[int] = None,
                             lambda_t: Optional[float] = None,
                             gamma_t: Optional[float] = None) -> None:
    """Backward n-step / lambda returns for every buffer step, vectorized:

      G_n[s]   = (1 - start[s+n]) * v[s+n]
      G_j[s]   = r[s+j] + gamma * (1 - start[s+j+1])
                 * (lambda * G_{j+1}[s] + (1-lambda) * v[s+j+1])
      Rn[s]    = G_0[s]

    identical to the reference's per-step inner loop
    (buffers.py:154-181), evaluated as n elementwise passes over the
    whole [T, n_envs] block.
    """
    n = self.n_step_bootstrapping if n is None else n
    lam = self.lambda_t if lambda_t is None else lambda_t
    gamma = self.gamma_t if gamma_t is None else gamma_t
    T, E = self.buffer_size, self.n_envs
    last_values = np.reshape(last_values, (E,)).astype(np.float32)
    dones = np.reshape(dones, (E,)).astype(np.float32)

    r = np.concatenate([self.rewards, np.zeros((n, E), np.float32)])
    v = np.concatenate(
        [self.values, np.tile(last_values, (n, 1)).astype(np.float32)])
    starts = np.concatenate(
        [self.episode_starts, np.tile(dones, (n, 1)).astype(np.float32)])

    s = np.arange(T)
    G = (1.0 - starts[s + n]) * v[s + n]
    for j in reversed(range(n)):
      cont = 1.0 - starts[s + j + 1]
      G = r[s + j] + gamma * cont * (lam * G + (1.0 - lam) * v[s + j + 1])
    self.Rn = G.astype(np.float32)
    self.weights = (np.abs(self.values - self.Rn)
                    ** self.prioritized_alpha).astype(np.float32)

  # -- sampling ------------------------------------------------------------
  def _flatten(self, arr: np.ndarray) -> np.ndarray:
    """ENV-major flatten: index = env * T + t (windows stay within one
    env's timeline; see module docstring for the divergence note)."""
    return np.swapaxes(arr, 0, 1).reshape(
        (self.n_envs * self.buffer_size,) + arr.shape[2:])

  def _feasible_starts(self, k: int) -> np.ndarray:
    T, E = self.buffer_size, self.n_envs
    starts = self._flatten(self.episode_starts)  # [E*T]
    mask = np.ones(E * T, bool)
    # A window starting at i spans [i, i+k); an episode start strictly
    # inside it (offset 1..k-1) invalidates it (buffers.py:214-220).
    start_idx = np.nonzero(starts)[0]
    for off in range(1, k):
      prev = start_idx - off
      mask[prev[prev >= 0]] = False
    # Windows may not cross the env-tail boundary.
    tail = np.arange(E)[:, None] * T + np.arange(T - k + 1, T)[None, :]
    mask[tail.ravel()] = False
    return np.nonzero(mask)[0]

  def get(self, batch_size: Optional[int] = None,
          k_steps: Optional[int] = None,
          ) -> Generator[MuaxRolloutBufferSamples, None, None]:
    assert self.full, "buffer must be full before sampling"
    k = self.k_steps if k_steps is None else k_steps
    idx = self._feasible_starts(k)
    if batch_size is None:
      batch_size = len(idx)

    flat = {name: self._flatten(getattr(self, name)) for name in
            ("observations", "actions", "rewards", "Rn", "pi", "weights")}
    windows = idx[:, None] + np.arange(k)[None, :]  # [N, k]

    def emit(window_rows):
      w = flat["weights"][window_rows]  # [b, k]
      if self.prioritized_sampling:
        # Importance-sampling correction (1/N * sum w / w) ** beta
        # (buffers.py:258-265).
        weights = ((1.0 / len(w)) * (np.sum(w, axis=0) / np.maximum(
            w, 1e-12))) ** self.prioritized_beta
      else:
        weights = np.ones_like(w)
      return MuaxRolloutBufferSamples(
          observations=flat["observations"][window_rows],
          actions=flat["actions"][window_rows],
          rewards=flat["rewards"][window_rows],
          Rn=flat["Rn"][window_rows],
          pi=flat["pi"][window_rows],
          weights=weights.astype(np.float32),
      )

    if not self.prioritized_sampling:
      order = self._rng.permutation(len(idx))
      for lo in range(0, len(idx), batch_size):
        yield emit(windows[order[lo:lo + batch_size]])
    else:
      probs = flat["weights"][idx] + 1e-12
      probs = probs / probs.sum()
      for _ in range(int(np.ceil(len(idx) / batch_size))):
        rows = self._rng.choice(len(idx), size=batch_size, p=probs)
        yield emit(windows[rows])
