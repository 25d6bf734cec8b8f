"""Sampled MuZero: batched search over sampled continuous or factored
actions (``muax_tpu/search/sampled_policy.py``).

Each node holds K jointly sampled candidate actions and the tree searches
the K slots with PUCT; the continuous action is the chosen slot's
candidate. Candidates are drawn afresh at every expanded node.

Interfaces (batched on B):
  sample_fn(params, generator, state) -> (actions [B, K, ...],
                                          log_probs [B, K] or None)
      K candidate actions from the proposal at a state; ``None`` log-probs
      give the slots a uniform prior (the empirical-prior recipe for iid
      draws from the prior).
  recurrent_fn(params, generator, action_values [B, ...], state)
      -> (ContinuousRecurrentFnOutput, next_state)

The two proposals, factored bins and a diagonal Gaussian, each split into a
draw (``factored_bin_draw``, ``gaussian_draw``) and a pure function of the
draw (``factored_bin_actions``, ``gaussian_actions``) that gives the
actions and their log-probabilities, so the tests can feed both packages
the same draw.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from muax_tpu_torch.search import action_selection as selection_lib
from muax_tpu_torch.search import qtransforms
from muax_tpu_torch.search.core import search
from muax_tpu_torch.search.policies import (_add_dirichlet_noise,
                                            _apply_temperature,
                                            _get_logits_from_probs)
from muax_tpu_torch.search.tree import Tree, batch_rows, map_embedding
from muax_tpu_torch.search.types import RecurrentFnOutput, RootFnOutput


@dataclasses.dataclass
class ContinuousRecurrentFnOutput:
  """One dynamics step on a continuous action: no prior logits, the slot
  priors come from ``sample_fn``."""
  reward: torch.Tensor    # [B]
  discount: torch.Tensor  # [B]
  value: torch.Tensor     # [B]


@dataclasses.dataclass
class SampledRecurrentState:
  """Tree embedding: the latent state and this node's K candidate
  actions."""
  state: Any              # [B, ...]
  candidate_actions: Any  # [B, K, ...]


@dataclasses.dataclass
class SampledPolicyOutput:
  """Continuous-action policy output: slot statistics and the gathered
  actions."""
  action: Any                   # [B, ...] the chosen slot's action
  action_slot: torch.Tensor     # [B] int32 index into the K root candidates
  action_weights: torch.Tensor  # [B, K] visit distribution over the slots
  sampled_actions: Any          # [B, K, ...] the root's candidates
  search_tree: Tree


def _slot_priors(log_probs: Optional[torch.Tensor], batch: int,
                 num_samples: int, like: torch.Tensor) -> torch.Tensor:
  if log_probs is None:
    return torch.zeros((batch, num_samples), dtype=like.dtype,
                       device=like.device)
  return torch.log_softmax(log_probs, -1).to(like.dtype)


def _take_slot(candidates, slot: torch.Tensor):
  """Each row's candidate at ``slot`` [B] of [B, K, ...] candidates."""
  rows = batch_rows(slot)
  return map_embedding(lambda c: c[rows, slot.long()], candidates)


@torch.no_grad()
def sampled_muzero_policy(
    params: Any,
    generator: torch.Generator,
    root: RootFnOutput,
    sample_fn: Callable,
    recurrent_fn: Callable,
    num_simulations: int,
    num_samples: int,
    max_depth: Optional[int] = None,
    *,
    qtransform=qtransforms.qtransform_by_parent_and_siblings,
    dirichlet_fraction: float = 0.25,
    dirichlet_alpha: float = 0.3,
    pb_c_init: float = 1.25,
    pb_c_base: float = 19652.0,
    temperature=1.0,
) -> SampledPolicyOutput:
  """PUCT search over K sampled candidate actions a node.

  ``root.prior_logits`` is ignored (the slot priors come from
  ``sample_fn``), as in the JAX package; pass any [B, *] tensor.
  """
  batch_size = root.value.shape[0]
  root_actions, root_logp = sample_fn(params, generator, root.embedding)
  probs = torch.softmax(_slot_priors(root_logp, batch_size, num_samples,
                                     root.value), -1)
  if dirichlet_fraction > 0.0:
    probs = _add_dirichlet_noise(generator, probs,
                                 fraction=dirichlet_fraction,
                                 alpha=dirichlet_alpha)
  extended_root = RootFnOutput(
      prior_logits=_get_logits_from_probs(probs),
      value=root.value,
      embedding=SampledRecurrentState(state=root.embedding,
                                      candidate_actions=root_actions))

  def slot_recurrent_fn(params_, generator_, slot,
                        emb: SampledRecurrentState):
    chosen = _take_slot(emb.candidate_actions, slot)
    out, next_state = recurrent_fn(params_, generator_, chosen, emb.state)
    next_actions, next_logp = sample_fn(params_, generator_, next_state)
    output = RecurrentFnOutput(
        reward=out.reward, discount=out.discount,
        prior_logits=_slot_priors(next_logp, batch_size, num_samples,
                                  out.value),
        value=out.value)
    return output, SampledRecurrentState(state=next_state,
                                         candidate_actions=next_actions)

  select_fn = selection_lib.make_muzero_action_selection(
      pb_c_init=pb_c_init, pb_c_base=pb_c_base, qtransform=qtransform)
  tree = search(
      params, generator, root=extended_root, recurrent_fn=slot_recurrent_fn,
      root_action_selection_fn=select_fn,
      interior_action_selection_fn=select_fn,
      num_simulations=num_simulations, max_depth=max_depth)

  action_weights = tree.summary().visit_probs
  slot_logits = _apply_temperature(_get_logits_from_probs(action_weights),
                                   temperature)
  slot = torch.multinomial(torch.softmax(slot_logits, -1), 1,
                           generator=generator)[:, 0].to(torch.int32)
  return SampledPolicyOutput(action=_take_slot(root_actions, slot),
                             action_slot=slot, action_weights=action_weights,
                             sampled_actions=root_actions, search_tree=tree)


def factored_bin_draw(generator: torch.Generator, logits: torch.Tensor,
                      num_samples: int) -> torch.Tensor:
  """K independent bins a dimension from ``logits`` [B, D, bins]:
  [B, K, D] int64."""
  batch, dims, num_bins = logits.shape
  probs = torch.softmax(logits.float(), -1).reshape(batch * dims, num_bins)
  bins = torch.multinomial(probs, num_samples, replacement=True,
                           generator=generator)           # [B*D, K]
  return bins.reshape(batch, dims, num_samples).transpose(1, 2)


def factored_bin_actions(logits: torch.Tensor, bins: torch.Tensor, low,
                         high, num_bins: int):
  """The bins' centers ``low + (bin + 0.5) * (high - low) / num_bins``
  [B, K, D] and their factored log-probabilities [B, K] (the sum over
  dimensions of each chosen bin's log-probability)."""
  low = torch.as_tensor(low, dtype=torch.float32, device=logits.device)
  high = torch.as_tensor(high, dtype=torch.float32, device=logits.device)
  log_probs_all = torch.log_softmax(logits, -1)           # [B, D, bins]
  num_samples = bins.shape[1]
  picked = torch.gather(
      log_probs_all[:, None].expand(-1, num_samples, -1, -1), -1,
      bins.long()[..., None])[..., 0]                     # [B, K, D]
  width = (high - low) / num_bins
  actions = low + (bins.to(torch.float32) + 0.5) * width
  return actions, torch.sum(picked, -1)


def make_factored_bin_sample_fn(dim_logits_fn: Callable, low, high,
                                num_bins: int, num_samples: int) -> Callable:
  """A per-dimension binned proposal: ``dim_logits_fn(params, state) ->
  [B, D, num_bins]`` scores the bins of each action dimension; each of the
  K candidates draws one bin a dimension and takes its center. The
  ``sample_fn`` gives (actions [B, K, D], log_probs [B, K])."""

  def sample_fn(params, generator, state):
    logits = dim_logits_fn(params, state)
    bins = factored_bin_draw(generator, logits, num_samples)
    return factored_bin_actions(logits, bins, low, high, num_bins)

  return sample_fn


def gaussian_draw(generator: torch.Generator, mu: torch.Tensor,
                  num_samples: int) -> torch.Tensor:
  """Standard normal eps [B, K, ...] for K candidates around ``mu``."""
  return torch.randn((mu.shape[0], num_samples) + tuple(mu.shape[1:]),
                     generator=generator, device=generator.device,
                     dtype=mu.dtype)


def gaussian_actions(mu: torch.Tensor, log_std: torch.Tensor,
                     eps: torch.Tensor, low=None, high=None):
  """Candidates ``mu + std * eps`` [B, K, D], clipped to [low, high] where
  given, and the log-probabilities [B, K] of the unclipped draws."""
  std = torch.exp(log_std)
  actions = mu[:, None] + std[:, None] * eps
  log_probs = torch.sum(-0.5 * torch.square(eps) - log_std[:, None]
                        - 0.5 * math.log(2 * math.pi), -1)
  if low is not None or high is not None:
    lo = None if low is None else torch.as_tensor(
        low, dtype=actions.dtype, device=actions.device)
    hi = None if high is None else torch.as_tensor(
        high, dtype=actions.dtype, device=actions.device)
    actions = torch.clamp(actions, lo, hi)
  return actions, log_probs


def make_gaussian_sample_fn(gaussian_params_fn: Callable, num_samples: int,
                            low=None, high=None) -> Callable:
  """A diagonal-Gaussian proposal: ``gaussian_params_fn(params, state) ->
  (mu [B, D], log_std [B, D])``; K candidates drawn iid and clipped to
  [low, high] where given. The log-probs are those of the unclipped
  draws."""

  def sample_fn(params, generator, state):
    mu, log_std = gaussian_params_fn(params, state)
    eps = gaussian_draw(generator, mu, num_samples)
    return gaussian_actions(mu, log_std, eps, low, high)

  return sample_fn
