"""Batched environments on the device and the auto-reset wrapper."""

from muax_tpu_torch.envs.base import (
    Environment,
    EnvSpec,
    AutoResetWrapper,
    AutoResetState,
)
from muax_tpu_torch.envs.cartpole import CartPole, CartPoleState
