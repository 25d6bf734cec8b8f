"""Batched Catch (bsuite-style) on the device (``muax_tpu/envs/catch.py``):
a ball falls down a ``rows`` x ``columns`` board, a paddle on the bottom row
catches it.

Actions: 0 = left, 1 = stay, 2 = right. The episode ends when the ball
reaches the row above the paddle's, with reward +1 if the paddle is under
it and -1 if not. The observation is the board with the ball and the
paddle set to 1.
"""
from __future__ import annotations

import dataclasses

import torch

from muax_tpu_torch.envs.base import Environment, EnvSpec


@dataclasses.dataclass
class CatchState:
  ball_row: torch.Tensor    # [B] int32
  ball_col: torch.Tensor    # [B] int32
  paddle_col: torch.Tensor  # [B] int32


class Catch(Environment):

  def __init__(self, rows: int = 10, columns: int = 5):
    self.rows = rows
    self.columns = columns
    self.spec = EnvSpec(observation_shape=(rows, columns), num_actions=3,
                        max_episode_steps=rows + 1)

  def reset(self, generator: torch.Generator, batch_size: int):
    device = generator.device
    state = CatchState(
        ball_row=torch.zeros(batch_size, dtype=torch.int32, device=device),
        ball_col=torch.randint(0, self.columns, (batch_size,),
                               generator=generator, device=device,
                               dtype=torch.int32),
        paddle_col=torch.full((batch_size,), self.columns // 2,
                              dtype=torch.int32, device=device))
    return state, self.observation(state)

  def step(self, state: CatchState, action: torch.Tensor):
    move = action.to(torch.int32) - 1
    paddle = torch.clamp(state.paddle_col + move, 0, self.columns - 1)
    ball_row = state.ball_row + 1
    new = CatchState(ball_row=ball_row, ball_col=state.ball_col,
                     paddle_col=paddle)
    done = ball_row >= self.rows - 1
    caught = paddle == state.ball_col
    reward = torch.where(done, torch.where(caught, 1.0, -1.0), 0.0)
    return new, self.observation(new), reward.to(torch.float32), done

  def observation(self, state: CatchState) -> torch.Tensor:
    batch = state.ball_row.shape[0]
    rows = torch.arange(batch, device=state.ball_row.device)
    board = torch.zeros((batch, self.rows, self.columns), dtype=torch.float32,
                        device=state.ball_row.device)
    ball_row = torch.clamp(state.ball_row, 0, self.rows - 1).long()
    board[rows, ball_row, state.ball_col.long()] = 1.0
    board[rows, self.rows - 1, state.paddle_col.long()] = 1.0
    return board
