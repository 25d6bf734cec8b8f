"""Batched search: the generic engine with its MuZero, Gumbel MuZero,
Stochastic MuZero, Sampled MuZero and Diffusion MuZero policies, the fused
search kernel in its modes with its policies, and the Stochastic MuZero
forest kernel with its policy."""

from muax_tpu_torch.search.types import (
    RootFnOutput,
    RecurrentFnOutput,
    DecisionRecurrentFnOutput,
    ChanceRecurrentFnOutput,
    StochasticRecurrentState,
    PolicyOutput,
)
from muax_tpu_torch.search.tree import Tree, SearchSummary, ROOT_INDEX
from muax_tpu_torch.search.core import search
from muax_tpu_torch.search.policies import (
    muzero_policy,
    gumbel_muzero_policy,
    stochastic_muzero_policy,
)
from muax_tpu_torch.search.sampled_policy import (
    ContinuousRecurrentFnOutput,
    SampledPolicyOutput,
    SampledRecurrentState,
    make_factored_bin_sample_fn,
    make_gaussian_sample_fn,
    sampled_muzero_policy,
)
from muax_tpu_torch.search import qtransforms
from muax_tpu_torch.search import seq_halving
from muax_tpu_torch.search import action_selection
from muax_tpu_torch.search.fused import (
    FusedMLPWeights,
    extract_fused_weights,
    fused_muzero_search,
    fused_muzero_search_reference,
    fused_mlp_muzero_policy,
    fused_gumbel_search,
    fused_gumbel_search_reference,
    fused_mlp_gumbel_policy,
    FusedSMZWeights,
    extract_smz_fused_weights,
    fused_smz_search,
    fused_smz_search_reference,
    fused_smz_policy,
)
