"""What the two-player board games share (``muax_tpu/envs/tictactoe.py``
and ``connect4.py``): the state, the planes relative to the player to
move, and the end of a move.

Boards are [B, cells] int8 (0 empty, 1 the first player's stone, 2 the
second's). Rewards are +1 / -1 / 0 from the perspective of the player who
just moved; a move into an occupied cell or a full column, or any move in a
finished game, is illegal and loses at once (masked search never makes
one, but the semantics stay total).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class BoardState:
  board: torch.Tensor    # [B, cells] int8
  to_play: torch.Tensor  # [B] int32: 0 or 1
  done: torch.Tensor     # [B] bool


def fresh_boards(batch_size: int, cells: int, device) -> BoardState:
  return BoardState(
      board=torch.zeros((batch_size, cells), dtype=torch.int8,
                        device=device),
      to_play=torch.zeros(batch_size, dtype=torch.int32, device=device),
      done=torch.zeros(batch_size, dtype=torch.bool, device=device))


def planes(state: BoardState, rows: int, columns: int) -> torch.Tensor:
  """[B, rows, columns, 2]: the mover's stones, the opponent's."""
  me = (state.board == (state.to_play + 1)[:, None].to(torch.int8))
  opp = (state.board == (2 - state.to_play)[:, None].to(torch.int8))
  batch = state.board.shape[0]
  return torch.stack([me.to(torch.float32).reshape(batch, rows, columns),
                      opp.to(torch.float32).reshape(batch, rows, columns)],
                     dim=-1)


def place(state: BoardState, cell: torch.Tensor, illegal: torch.Tensor,
          lines: torch.Tensor):
  """Put the mover's stone on ``cell`` [B] unless ``illegal``, then score:
  a win on any of ``lines`` [n, k], a full board, or the illegal move ends
  the game. Returns (state, reward [B] f32, done [B])."""
  rows = torch.arange(state.board.shape[0], device=state.board.device)
  stone = (state.to_play + 1).to(torch.int8)
  board = state.board.clone()
  current = board[rows, cell]
  board[rows, cell] = torch.where(illegal, current, stone)
  won = torch.any(torch.all(board[:, lines] == stone[:, None, None], dim=-1),
                  dim=-1)
  full = torch.all(board != 0, dim=-1)
  done = won | full | illegal
  reward = torch.where(illegal, -1.0, torch.where(won, 1.0, 0.0))
  new = BoardState(board=board, to_play=1 - state.to_play, done=done)
  return new, reward.to(torch.float32), done
