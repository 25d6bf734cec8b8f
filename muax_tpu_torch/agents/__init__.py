"""Standalone host-facing agents."""

from muax_tpu_torch.agents.muzero import MuZero
from muax_tpu_torch.agents.stochastic import StochasticMuZero
from muax_tpu_torch.agents.diffusion import DiffusionMuZero
