"""Numerics: value-support transforms, normalization, returns."""

from muax_tpu_torch.ops.support import (
    value_transform,
    inv_value_transform,
    scalar_to_support,
    support_to_scalar,
    logits_to_scalar,
    scalar_to_two_hot,
    two_hot_to_scalar,
    two_hot_logits_to_scalar,
)
from muax_tpu_torch.ops.returns import (
    n_step_bootstrapped_returns,
    segment_n_step_returns,
)
from muax_tpu_torch.ops.normalize import min_max_normalize
from muax_tpu_torch.ops.gradients import scale_gradient
