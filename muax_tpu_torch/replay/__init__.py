"""On-device prioritized replay, the fused window sampler, and the host-side
episode tracers and trajectory replay."""

from muax_tpu_torch.replay.buffer import (
    ReplayState,
    replay_init,
    replay_add,
    replay_sample,
    replay_update_priorities,
)
from muax_tpu_torch.replay.tracer import (
    NStep,
    PNStep,
    Trajectory,
    TrajectoryReplayBuffer,
)
