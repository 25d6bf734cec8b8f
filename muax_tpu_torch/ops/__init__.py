"""Numerics: value-support transforms, normalization, returns, gradient
utilities, frame transforms and image augmentations."""

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
    batched_n_step_returns,
    segment_n_step_returns,
)
from muax_tpu_torch.ops.normalize import min_max_normalize, min_max_normalize2d
from muax_tpu_torch.ops.gradients import clip_gradient, scale_gradient
from muax_tpu_torch.ops.frames import (action2plane, diff_transform,
                                       diff_transform_matrix)
from muax_tpu_torch.ops.augmentations import (
    drq_augmentation,
    random_intensity,
    random_shift,
    scale_intensity,
    shift_obs,
)
