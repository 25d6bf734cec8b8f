"""open_spiel games through the host pool
(``muax_tpu/envs/open_spiel_adapter.py``).

The reference's open_spiel path (examples/open_spiel/go/run_alphazero.py)
wraps pyspiel games in an acme OpenSpielWrapper that builds the AlphaZero
observation of 8 x 2 board-history planes and a current-player plane
(run_alphazero.py:49-127). Here the board games that run on the device
(TicTacToe, Connect Four) search with the game as the model
(``train/selfplay.py``); any pyspiel game comes through this pool, the
MuZero path with a learned model: the search runs in latent space on the
device and only the real transition crosses to the host, one host call a
rollout step, as in ``envs/gym_adapter.py``. Rewards are the mover's, so
that a negative discount flips the value between the two players.

``AlphaZeroPlanes`` (the observation builder) depends on nothing;
``OpenSpielVectorPool`` needs pyspiel and raises an ImportError without
it. ``OpenSpielVectorPool._from_game`` builds a pool over any object
shaped like a pyspiel game, which is how the tests drive it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from muax_tpu_torch.device import resolve_device
from muax_tpu_torch.envs.base import AutoResetState, EnvSpec
from muax_tpu_torch.envs.gym_adapter import HostPool


class AlphaZeroPlanes:
  """A game's converter to the AlphaZero observation stack (reference
  run_alphazero.py:84-99): planes [black_0, white_0, black_1, white_1,
  ..., current_player], the newest history first, zeros where the game is
  younger than the history.

  ``obs_extract(tensor, rows, cols) -> (black [H, W], white [H, W],
  player)`` adapts any game's observation tensor; the default reads
  open_spiel's Go and chess layout: black at plane 0, white at plane 1,
  the player at plane 3 (go.cc's observation order).
  """

  def __init__(self, rows: int, cols: int, history_size: int = 8,
               obs_extract=None):
    self.rows, self.cols = rows, cols
    self.history_size = history_size
    self.num_planes = 2 * history_size + 1
    self._extract = obs_extract or self._default_extract
    self.reset()

  @staticmethod
  def _default_extract(tensor: np.ndarray, rows: int, cols: int):
    t = np.asarray(tensor, np.float32)
    if t.ndim != 3:
      # pyspiel ravels observation_tensor in observation_tensor_shape
      # order, plane-major [P, H, W] for go, chess and tic_tac_toe:
      # reshape plane-major, then move the planes last. (The reference
      # example's channels-last reshape, run_alphazero.py:90, scrambles
      # pyspiel's planes; the JAX package departs from it on purpose.)
      t = t.reshape(-1, rows, cols).transpose(1, 2, 0)
    elif t.shape[:2] == (rows, cols) and t.shape[1:] == (rows, cols):
      # [P, H, W] with P == H == W cannot be told from channels-last by
      # its shape: pass the flat tensor or an obs_extract.
      raise ValueError(
          f"ambiguous {t.shape} observation for a {rows}x{cols} board: "
          "plane-major vs channels-last cannot be inferred when planes == "
          "rows; pass the flat observation_tensor or a custom obs_extract")
    elif t.shape[:2] != (rows, cols) and t.shape[1:] == (rows, cols):
      t = t.transpose(1, 2, 0)  # 3-D but plane-major
    player = float(t[0, 0, 3]) if t.shape[-1] > 3 else 0.0
    return t[..., 0], t[..., 1], player

  def reset(self):
    self._history = []

  def observe(self, observation_tensor) -> np.ndarray:
    black, white, player = self._extract(observation_tensor, self.rows,
                                         self.cols)
    self._history.append((black, white, player))
    if len(self._history) > self.history_size:
      self._history.pop(0)
    out = np.zeros((self.rows, self.cols, self.num_planes), np.float32)
    for i, (b, w, _) in enumerate(reversed(self._history)):
      out[:, :, 2 * i] = b
      out[:, :, 2 * i + 1] = w
    out[:, :, -1] = self._history[-1][2]
    return out


class OpenSpielVectorPool(HostPool):
  """N pyspiel games with host-side auto-reset, stepped by one host call
  (the ``AutoResetWrapper`` interface, so ``make_rollout_fn`` and ``fit``
  take it as it is).

  Each step applies the given action for the current player of each game,
  samples through chance nodes, and returns the mover's change of return
  as the reward. ``legal_action_mask`` reads the live games' legal
  actions for the search's masks.
  """

  def __init__(self, game_name: str, num_envs: int, seed: int = 0,
               history_size: int = 8, rows: Optional[int] = None,
               cols: Optional[int] = None, device="cuda"):
    try:
      import pyspiel
    except ImportError as e:
      raise ImportError(
          "OpenSpielVectorPool needs open_spiel (`pip install "
          "open_spiel`); AlphaZeroPlanes (the observation builder) has no "
          "pyspiel dependency and is tested against a fake game.") from e
    self._init_common(pyspiel.load_game(game_name), num_envs, seed,
                      history_size, rows, cols, device)

  @classmethod
  def _from_game(cls, game, num_envs: int, seed: int = 0,
                 history_size: int = 8, rows=None, cols=None,
                 device="cuda"):
    """A pool over any object shaped like a pyspiel game (for tests)."""
    self = cls.__new__(cls)
    self._init_common(game, num_envs, seed, history_size, rows, cols,
                      device)
    return self

  def _init_common(self, game, num_envs, seed, history_size, rows, cols,
                   device):
    self.device = resolve_device(device)
    self._game = game
    self.num_envs = num_envs
    self._rng = np.random.RandomState(seed)
    shape = tuple(game.observation_tensor_shape())
    if rows is None:
      # [planes, H, W] (open_spiel's order) or [H, W, planes].
      rows, cols = (shape[1], shape[2]) if len(shape) == 3 else (shape[0], 1)
    self._rows, self._cols = rows, cols
    self._planes = [AlphaZeroPlanes(rows, cols, history_size)
                    for _ in range(num_envs)]
    self._states = [None] * num_envs
    self._num_actions = int(game.num_distinct_actions())
    self.spec = EnvSpec(
        observation_shape=(rows, cols, 2 * history_size + 1),
        num_actions=self._num_actions,
        max_episode_steps=int(game.max_game_length()))

  # -- host side -----------------------------------------------------------
  def _obs_tensor(self, state):
    return np.asarray(state.observation_tensor(state.current_player()),
                      np.float32)

  def _resolve_chance(self, state):
    while (not state.is_terminal()) and state.is_chance_node():
      actions, probs = zip(*state.chance_outcomes())
      state.apply_action(self._rng.choice(actions, p=np.asarray(probs)))

  def _reset_one(self, i):
    state = self._game.new_initial_state()
    self._resolve_chance(state)
    self._states[i] = state
    self._planes[i].reset()
    return self._planes[i].observe(self._obs_tensor(state))

  def _host_reset_all(self):
    obs = np.zeros((self.num_envs,) + self.spec.observation_shape,
                   np.float32)
    for i in range(self.num_envs):
      obs[i] = self._reset_one(i)
    return obs

  def _host_step(self, action):
    obs = np.zeros((self.num_envs,) + self.spec.observation_shape,
                   np.float32)
    rew = np.zeros((self.num_envs,), np.float32)
    done = np.zeros((self.num_envs,), bool)
    for i in range(self.num_envs):
      state = self._states[i]
      mover = state.current_player()
      legal = state.legal_actions()
      a = int(action[i])
      if a not in legal:  # the search masks illegal actions already
        a = int(legal[0])
      before = state.returns()[mover] if not state.is_terminal() else 0.0
      state.apply_action(a)
      self._resolve_chance(state)
      rew[i] = state.returns()[mover] - before
      if state.is_terminal():
        done[i] = True
        obs[i] = self._reset_one(i)
      else:
        obs[i] = self._planes[i].observe(self._obs_tensor(state))
    return obs, rew, done

  def _host_legal_mask(self):
    mask = np.zeros((self.num_envs, self._num_actions), np.float32)
    for i, state in enumerate(self._states):
      mask[i, state.legal_actions()] = 1.0
    return mask

  # -- device-facing API ---------------------------------------------------
  def legal_action_mask(self, carry: AutoResetState) -> torch.Tensor:
    """[B, A] (1 = legal) of the live games on the host, on the device."""
    del carry  # legality is the host games' state
    mask, = self._upload(self._host_legal_mask())
    return mask
