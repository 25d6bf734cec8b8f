"""On-device prioritized replay and the fused window sampler."""

from muax_tpu_torch.replay.buffer import (
    ReplayState,
    replay_init,
    replay_add,
    replay_sample,
    replay_update_priorities,
)
