"""Debugging utilities."""

from muax_tpu_torch.utils.debug import check_numerics, set_check_numerics
