"""Functional interfaces between networks and the search
(``muax_tpu/search/types.py``). All fields are batched on the leading axis B.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Generic, TypeVar

import torch

T = TypeVar("T")


@dataclasses.dataclass
class RootFnOutput:
  """Output of root inference: repr -> pred on the current observation."""
  prior_logits: torch.Tensor   # [B, A]
  value: torch.Tensor          # [B]
  embedding: Any               # [B, ...]


@dataclasses.dataclass
class RecurrentFnOutput:
  """Output of one dynamics+prediction step inside the search."""
  reward: torch.Tensor         # [B]
  discount: torch.Tensor       # [B]
  prior_logits: torch.Tensor   # [B, A]
  value: torch.Tensor          # [B]


@dataclasses.dataclass
class DecisionRecurrentFnOutput:
  """Stochastic MuZero decision step: (state, action) -> afterstate."""
  chance_logits: torch.Tensor     # [B, C]
  afterstate_value: torch.Tensor  # [B]


@dataclasses.dataclass
class ChanceRecurrentFnOutput:
  """Stochastic MuZero chance step: (afterstate, outcome) -> next state."""
  action_logits: torch.Tensor  # [B, A]
  value: torch.Tensor          # [B]
  reward: torch.Tensor         # [B]


@dataclasses.dataclass
class StochasticRecurrentState:
  """Embedding of the interleaved decision/chance search: ``state`` is the
  state or the afterstate latent, ``is_decision_node`` which of the two
  each batch element holds. The search tree stores one tensor per field."""
  state: torch.Tensor             # [B, ...]
  is_decision_node: torch.Tensor  # [B] bool


@dataclasses.dataclass
class PolicyOutput(Generic[T]):
  """What a search policy returns to the actor."""
  action: torch.Tensor          # [B] int32
  action_weights: torch.Tensor  # [B, A]
  search_tree: T


# recurrent_fn(params, generator, action [B], embedding) ->
# (RecurrentFnOutput, next_embedding)
RecurrentFn = Callable[[Any, torch.Generator, torch.Tensor, Any],
                       tuple[RecurrentFnOutput, Any]]
# decision_recurrent_fn(params, generator, action [B], state) ->
# (DecisionRecurrentFnOutput, afterstate)
DecisionRecurrentFn = Callable[[Any, torch.Generator, torch.Tensor, Any],
                               tuple[DecisionRecurrentFnOutput, Any]]
# chance_recurrent_fn(params, generator, outcome [B], afterstate) ->
# (ChanceRecurrentFnOutput, next_state)
ChanceRecurrentFn = Callable[[Any, torch.Generator, torch.Tensor, Any],
                             tuple[ChanceRecurrentFnOutput, Any]]
