"""The actor (self-play rollout), the learner, checkpoints and the fit
loop, inference closures and schedules."""

from muax_tpu_torch.train.actor import make_rollout_fn, make_policy_fn
from muax_tpu_torch.train.inference import make_root_fn, make_recurrent_fn
from muax_tpu_torch.train.learner import (TrainState, make_update_fn,
                                          make_multi_update_fn)
from muax_tpu_torch.train import temperature
