"""muax_tpu_torch — the PyTorch and CUDA port of muax_tpu.

Module names mirror the JAX package: the counterpart of ``muax_tpu/x/y.py``
is ``muax_tpu_torch/x/y.py``. The port imports ``torch`` and ``numpy`` and
nothing of JAX or of ``muax_tpu``. Entry points run on the CUDA card unless
the caller passes ``device="cpu"``; every hand-written kernel has a plain
PyTorch version beside it that serves CPU tensors only.

The top-level spellings are the JAX package's: ``MuZero``,
``StochasticMuZero``, ``NStep``, ``PNStep``, ``Trajectory``,
``TrajectoryReplayBuffer``, ``fit`` and ``make_evaluate_fn``.
"""

__version__ = "0.1.0"

from muax_tpu_torch import ops
from muax_tpu_torch import search
from muax_tpu_torch import models
from muax_tpu_torch import envs
from muax_tpu_torch import replay
from muax_tpu_torch import train
from muax_tpu_torch import agents
from muax_tpu_torch import adapters
from muax_tpu_torch import parallel

from muax_tpu_torch.agents import MuZero, StochasticMuZero
from muax_tpu_torch.replay import (
    NStep,
    PNStep,
    Trajectory,
    TrajectoryReplayBuffer,
)
from muax_tpu_torch.train.fit import fit, make_evaluate_fn
