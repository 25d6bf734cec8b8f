"""Batched environments on the device (CartPole, Catch, the board games
TicTacToe and Connect Four, and pixel Catch), the auto-reset wrapper and
the observation wrappers."""

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
from muax_tpu_torch.envs.pixel import PixelCatch, PixelObsEnv
from muax_tpu_torch.envs.wrappers import (ActionHistoryEnv,
                                          ActionHistoryState,
                                          FrameStackingEnv, PoolFrameStacking,
                                          StackState)
