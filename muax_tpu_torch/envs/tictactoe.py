"""Batched TicTacToe on the device (``muax_tpu/envs/tictactoe.py``), the
two-player zero-sum testbed (perfect play draws).

Observation: [B, 3, 3, 2] planes (the mover's stones, the opponent's),
always from the perspective of the player to move. Reward on termination is
+1 / -1 / 0 from the perspective of the player who just moved;
``legal_actions`` masks the occupied cells and every cell of a finished
game.
"""
from __future__ import annotations

import numpy as np
import torch

from muax_tpu_torch.envs.base import Environment, EnvSpec
from muax_tpu_torch.envs.board import BoardState, fresh_boards, place, planes

_LINES = np.asarray([
    [0, 1, 2], [3, 4, 5], [6, 7, 8],   # rows
    [0, 3, 6], [1, 4, 7], [2, 5, 8],   # columns
    [0, 4, 8], [2, 4, 6],              # diagonals
])

TicTacToeState = BoardState


class TicTacToe(Environment):

  spec = EnvSpec(observation_shape=(3, 3, 2), num_actions=9,
                 max_episode_steps=9)

  def reset(self, generator: torch.Generator, batch_size: int):
    state = fresh_boards(batch_size, 9, generator.device)
    return state, self.observation(state)

  def observation(self, state: BoardState) -> torch.Tensor:
    return planes(state, 3, 3)

  def legal_actions(self, state: BoardState) -> torch.Tensor:
    """[B, 9] 1.0 where the cell is empty and the game is live."""
    empty = (state.board == 0).to(torch.float32)
    return torch.where(state.done[:, None], 0.0, empty)

  def step(self, state: BoardState, action: torch.Tensor):
    cell = action.long()
    rows = torch.arange(cell.shape[0], device=cell.device)
    illegal = (state.board[rows, cell] != 0) | state.done
    lines = torch.as_tensor(_LINES, device=cell.device)
    new, reward, done = place(state, cell, illegal, lines)
    return new, self.observation(new), reward, done
