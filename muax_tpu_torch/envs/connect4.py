"""Batched Connect Four on the device (``muax_tpu/envs/connect4.py``): a
6 x 7 board with gravity and 69 four-in-a-row lines.

Observation: [B, 6, 7, 2] planes (the mover's stones, the opponent's),
always from the perspective of the player to move; row 5 is the bottom.
Actions are columns. Reward on termination is +1 / -1 / 0 from the
perspective of the player who just moved; dropping into a full column, or
any move in a finished game, loses at once.
"""
from __future__ import annotations

import numpy as np
import torch

from muax_tpu_torch.envs.base import Environment, EnvSpec
from muax_tpu_torch.envs.board import BoardState, fresh_boards, place, planes

ROWS, COLS = 6, 7


def _win_lines() -> np.ndarray:
  """[69, 4] flat indices (row * 7 + col) of every 4-in-a-row line."""
  lines = []
  for r in range(ROWS):
    for c in range(COLS):
      for dr, dc in ((0, 1), (1, 0), (1, 1), (1, -1)):
        rr, cc = r + 3 * dr, c + 3 * dc
        if 0 <= rr < ROWS and 0 <= cc < COLS:
          lines.append([(r + i * dr) * COLS + (c + i * dc)
                        for i in range(4)])
  return np.asarray(lines, np.int64)


_LINES = _win_lines()

Connect4State = BoardState


class ConnectFour(Environment):

  spec = EnvSpec(observation_shape=(ROWS, COLS, 2), num_actions=COLS,
                 max_episode_steps=ROWS * COLS)

  def reset(self, generator: torch.Generator, batch_size: int):
    state = fresh_boards(batch_size, ROWS * COLS, generator.device)
    return state, self.observation(state)

  def observation(self, state: BoardState) -> torch.Tensor:
    return planes(state, ROWS, COLS)

  def legal_actions(self, state: BoardState) -> torch.Tensor:
    """[B, 7] 1.0 where the column's top cell is empty and the game is
    live."""
    top_empty = (state.board[:, :COLS] == 0).to(torch.float32)
    return torch.where(state.done[:, None], 0.0, top_empty)

  def step(self, state: BoardState, action: torch.Tensor):
    column = action.long()
    batch = column.shape[0]
    grid = state.board.reshape(batch, ROWS, COLS)
    rows = torch.arange(batch, device=column.device)
    n_empty = torch.sum(grid[rows, :, column] == 0, dim=-1)
    illegal = (n_empty == 0) | state.done
    # Stones stack up from row 5; a full column's move changes nothing.
    landing_row = torch.clamp(n_empty - 1, min=0)
    lines = torch.as_tensor(_LINES, device=column.device)
    new, reward, done = place(state, landing_row * COLS + column, illegal,
                              lines)
    return new, self.observation(new), reward, done
