"""Batched search: the fused MuZero search kernel and its policy."""

from muax_tpu_torch.search.types import RootFnOutput, RecurrentFnOutput
from muax_tpu_torch.search.fused import (
    FusedMLPWeights,
    extract_fused_weights,
    fused_muzero_search,
    fused_muzero_search_reference,
    fused_mlp_muzero_policy,
)
