"""Batched environments on the device (CartPole, Catch, the board games
TicTacToe and Connect Four, and pixel Catch), the auto-reset wrapper and
the observation wrappers; the host pools (gymnasium, Atari, open_spiel,
the native 2048 pool) and the registry of env ids."""

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
from muax_tpu_torch.envs.gym_adapter import GymVectorPool, HostPool
from muax_tpu_torch.envs.atari import AtariPreprocessing, AtariVectorPool
from muax_tpu_torch.envs.native2048 import Native2048Pool
from muax_tpu_torch.envs.open_spiel_adapter import (AlphaZeroPlanes,
                                                    OpenSpielVectorPool)
from muax_tpu_torch.envs.registry import make, register, registered
