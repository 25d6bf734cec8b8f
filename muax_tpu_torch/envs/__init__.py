"""Batched environments on the device (CartPole, Catch and the board games
TicTacToe and Connect Four) and the auto-reset wrapper."""

from muax_tpu_torch.envs.base import (
    Environment,
    EnvSpec,
    AutoResetWrapper,
    AutoResetState,
)
from muax_tpu_torch.envs.cartpole import CartPole, CartPoleState
from muax_tpu_torch.envs.catch import Catch, CatchState
from muax_tpu_torch.envs.connect4 import Connect4State, ConnectFour
from muax_tpu_torch.envs.tictactoe import TicTacToe, TicTacToeState
