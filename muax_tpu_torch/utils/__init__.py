"""Debugging and profiling utilities."""

from muax_tpu_torch.utils.debug import (assert_finite, check_numerics,
                                        check_numerics_enabled, nan_guard,
                                        set_check_numerics)
from muax_tpu_torch.utils.profiling import Stopwatch, step_annotation, trace
