"""Q-value completion and normalization transforms for action selection
(``muax_tpu/search/qtransforms.py``): batched functions
``(tree, node_index [B]) -> [B, A]``. MuZero uses
``qtransform_by_parent_and_siblings``, Gumbel MuZero
``qtransform_completed_by_mix_value`` (muax/policy.py defaults).
"""
from __future__ import annotations

import torch

from muax_tpu_torch.search.tree import Tree, batch_rows, qvalues_at


def qtransform_by_parent_and_siblings(tree: Tree, node_index: torch.Tensor,
                                      *, epsilon: float = 1e-8
                                      ) -> torch.Tensor:
  """Normalize child Qs to [0,1] by the min/max over {parent value, visited
  children}; unvisited children get the minimum. Shape [B, A]."""
  rows = batch_rows(node_index)
  qvalues = qvalues_at(tree, node_index)
  visit_counts = tree.children_visits[rows, node_index]
  node_value = tree.node_values[rows, node_index]               # [B]
  safe_q = torch.where(visit_counts > 0, qvalues, node_value[:, None])
  min_value = torch.minimum(node_value, torch.amin(safe_q, dim=-1))
  max_value = torch.maximum(node_value, torch.amax(safe_q, dim=-1))
  completed = torch.where(visit_counts > 0, qvalues, min_value[:, None])
  return (completed - min_value[:, None]) / torch.clamp(
      max_value - min_value, min=epsilon)[:, None]


def qtransform_by_min_max(tree: Tree, node_index: torch.Tensor, *,
                          min_value: float, max_value: float) -> torch.Tensor:
  """Fixed-range normalization; unvisited children get ``min_value``."""
  rows = batch_rows(node_index)
  qvalues = qvalues_at(tree, node_index)
  visit_counts = tree.children_visits[rows, node_index]
  completed = torch.where(visit_counts > 0, qvalues,
                          torch.full_like(qvalues, min_value))
  return (completed - min_value) / (max_value - min_value)


def _compute_mixed_value(raw_value, qvalues, visit_counts, prior_probs,
                         epsilon: float = 1e-8):
  """Interpolation of the raw network value with visited-children Q values,
  weighted by the prior (Gumbel MuZero paper, eq. for v_mix). Shape [B].
  ``visit_counts`` are the children's: their sum and max, not the node's own
  count, which differs from it after a depth-capped re-evaluation."""
  visit_counts = visit_counts.to(qvalues.dtype)
  sum_visits = torch.sum(visit_counts, dim=-1)
  visited_probs = torch.where(visit_counts > 0, prior_probs,
                              torch.zeros_like(prior_probs))
  sum_probs = torch.sum(visited_probs, dim=-1)
  weighted_q = torch.sum(visited_probs * qvalues, dim=-1) / torch.clamp(
      sum_probs, min=epsilon)
  return (raw_value + sum_visits * weighted_q) / (sum_visits + 1.0)


def qtransform_completed_by_mix_value(
    tree: Tree, node_index: torch.Tensor, *,
    value_scale: float = 0.1,
    maxvisit_init: float = 50.0,
    rescale_values: bool = True,
    use_mixed_value: bool = True,
    epsilon: float = 1e-8) -> torch.Tensor:
  """Complete unvisited Qs with the mixed value, optionally min-max rescale,
  then scale by (maxvisit_init + max visit) * value_scale: the sigma(q)
  monotone transform of the Gumbel MuZero paper. Shape [B, A]."""
  rows = batch_rows(node_index)
  qvalues = qvalues_at(tree, node_index)
  visit_counts = tree.children_visits[rows, node_index]
  raw_value = tree.node_raw_values[rows, node_index]            # [B]
  prior_probs = torch.softmax(tree.children_prior_logits[rows, node_index],
                              dim=-1)
  if use_mixed_value:
    value = _compute_mixed_value(raw_value, qvalues, visit_counts,
                                 prior_probs, epsilon)
  else:
    value = raw_value
  completed = torch.where(visit_counts > 0, qvalues, value[:, None])
  if rescale_values:
    low = torch.amin(completed, dim=-1, keepdim=True)
    high = torch.amax(completed, dim=-1, keepdim=True)
    completed = (completed - low) / torch.clamp(high - low, min=epsilon)
  maxvisit = torch.amax(visit_counts, dim=-1).to(completed.dtype)
  visit_scale = maxvisit_init + maxvisit
  return visit_scale[:, None] * value_scale * completed
