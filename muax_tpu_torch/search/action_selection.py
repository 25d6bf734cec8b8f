"""In-tree action selection rules, batched
(``muax_tpu/search/action_selection.py``).

Selection fn signature: ``fn(generator, tree, node_index [B], depth, sim) ->
action [B]`` (int64), where ``depth`` is the level of the lockstep descent
front and ``sim`` the simulation index (the sequential-halving root rule
reads it). Random tie-break noise comes from ``generator``.

PUCT with pb_c 1.25/19652 (muax/policy.py:17-30), the Gumbel root and
interior rules (muax/policy.py:33-47) and the reference's exploration zoo
(acme/tf/mcts/search.py:456-685).
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from muax_tpu_torch.search import qtransforms
from muax_tpu_torch.search.tree import Tree, batch_rows, qvalues_at

# fn(generator, tree, node_index [B], depth, sim) -> action [B]
ActionSelectionFn = Callable[[torch.Generator, Tree, torch.Tensor, int, int],
                             torch.Tensor]


def _mask_invalid(logits: torch.Tensor, invalid: torch.Tensor
                  ) -> torch.Tensor:
  return torch.where(invalid > 0, torch.full_like(logits, -torch.inf), logits)


def _mask_root_invalid(score: torch.Tensor, tree: Tree,
                       depth: int) -> torch.Tensor:
  """Invalid actions are only known (and only matter) at the root."""
  return _mask_invalid(score, tree.root_invalid_actions) if depth == 0 \
      else score


def _tie_noise(generator: torch.Generator, like: torch.Tensor
               ) -> torch.Tensor:
  """Uniform noise of 1e-7 that breaks ties between equal scores without
  reordering distinct ones."""
  return torch.rand(like.shape, generator=generator, dtype=like.dtype,
                    device=like.device) * 1e-7


def muzero_action_selection(
    generator: torch.Generator,
    tree: Tree,
    node_index: torch.Tensor,
    depth: int,
    sim: int,
    *,
    pb_c_init: float = 1.25,
    pb_c_base: float = 19652.0,
    qtransform=qtransforms.qtransform_by_parent_and_siblings,
) -> torch.Tensor:
  """PUCT: argmax_a [ Q(a) + P(a) * sqrt(N) / (1 + n(a)) * pb_c ]."""
  del sim
  rows = batch_rows(node_index)
  visit_counts = tree.children_visits[rows, node_index].to(torch.float32)
  node_visit = tree.node_visits[rows, node_index].to(torch.float32)   # [B]
  pb_c = pb_c_init + torch.log((node_visit + pb_c_base + 1.0) / pb_c_base)
  prior_probs = torch.softmax(tree.children_prior_logits[rows, node_index],
                              dim=-1)
  policy_score = (torch.sqrt(node_visit) * pb_c)[:, None] * prior_probs / (
      visit_counts + 1.0)
  value_score = qtransform(tree, node_index)
  to_argmax = _mask_root_invalid(
      value_score + policy_score + _tie_noise(generator, policy_score), tree,
      depth)
  return torch.argmax(to_argmax, dim=-1)


def gumbel_muzero_root_action_selection(
    generator: torch.Generator,
    tree: Tree,
    node_index: torch.Tensor,
    depth: int,
    sim: int,
    *,
    table: torch.Tensor,  # [max_considered + 1, num_simulations] int32
    max_num_considered_actions: int,
    qtransform=qtransforms.qtransform_completed_by_mix_value,
) -> torch.Tensor:
  """Sequential halving: among considered actions whose visit count equals the
  scheduled count, argmax of g + logits + sigma(q-hat)."""
  del generator, depth
  rows = batch_rows(node_index)
  visit_counts = tree.children_visits[rows, node_index]
  prior_logits = tree.children_prior_logits[rows, node_index]
  completed_q = qtransform(tree, node_index)
  gumbel = tree.extra_data.root_gumbel
  num_valid = torch.sum(1 - tree.root_invalid_actions, dim=-1).to(torch.long)
  num_considered = torch.clamp(num_valid, max=max_num_considered_actions)
  considered_visit = table[num_considered, sim]                        # [B]
  score = torch.where(visit_counts == considered_visit[:, None],
                      gumbel + prior_logits + completed_q,
                      torch.full_like(completed_q, -torch.inf))
  score = _mask_invalid(score, tree.root_invalid_actions)
  return torch.argmax(score, dim=-1)


def gumbel_muzero_interior_action_selection(
    generator: torch.Generator,
    tree: Tree,
    node_index: torch.Tensor,
    depth: int,
    sim: int,
    *,
    qtransform=qtransforms.qtransform_completed_by_mix_value,
) -> torch.Tensor:
  """Deterministic improved-policy tracking: argmax pi'(a) - n(a)/(1+N).

  Drives empirical visit proportions toward the improved policy
  softmax(logits + sigma(q-hat)) (Gumbel MuZero paper, sec. 5).
  """
  del generator, depth, sim
  rows = batch_rows(node_index)
  visit_counts = tree.children_visits[rows, node_index].to(torch.float32)
  prior_logits = tree.children_prior_logits[rows, node_index]
  completed_q = qtransform(tree, node_index)
  probs = torch.softmax(prior_logits + completed_q, dim=-1)
  to_argmax = probs - visit_counts / (
      1.0 + torch.sum(visit_counts, dim=-1, keepdim=True))
  return torch.argmax(to_argmax, dim=-1)


def make_exploration_selection(
    kind: str = "puct",
    pb_c_init: float = 1.25,
    pb_c_base: float = 19652.0,
) -> ActionSelectionFn:
  """The reference's selection-policy zoo over the batched tree.

  Semantics of acme/tf/mcts/search.py:456-685 (flag puct/pucb/ucb/ltr/pltr/
  pnltr/bfs in run_alphazero.py:292-304), on raw child Q values
  Q(a) = r + discount * V(child) (unvisited children score Q=0 like the
  reference's fresh Node.value). Zero-prior (illegal) actions are masked.
  """
  if kind not in ("bfs", "puct", "pucb", "ucb", "ltr", "pltr", "pnltr"):
    raise ValueError(f"unknown selection kind {kind!r}")

  def fn(generator, tree, node_index, depth, sim):
    del sim
    rows = batch_rows(node_index)
    visit_counts = tree.children_visits[rows, node_index].to(torch.float32)
    node_visit = torch.clamp(
        tree.node_visits[rows, node_index].to(torch.float32),
        min=1.0)[:, None]                                        # [B, 1]
    priors = torch.softmax(tree.children_prior_logits[rows, node_index],
                           dim=-1)
    qvalues = torch.where(visit_counts > 0, qvalues_at(tree, node_index),
                          torch.zeros_like(visit_counts))
    inv_n = 1.0 / (visit_counts + 1.0)
    log_term = torch.log(node_visit + 1e-8)

    if kind == "bfs":
      score = -visit_counts
    elif kind == "puct":
      pb_c = torch.log((node_visit + pb_c_base + 1.0) / pb_c_base) + pb_c_init
      score = qvalues + pb_c * priors * torch.sqrt(node_visit) * inv_n
    elif kind == "pucb":
      score = qvalues + priors * torch.sqrt(log_term * inv_n)
    elif kind == "ucb":
      score = qvalues + torch.sqrt(log_term * inv_n)
    elif kind == "ltr":
      score = qvalues + torch.sqrt(node_visit * log_term) * inv_n
    elif kind == "pltr":
      score = qvalues + priors * torch.sqrt(node_visit * log_term) * inv_n
    else:  # pnltr
      pb_c = torch.sqrt(
          torch.log((node_visit + pb_c_base + 1.0) / pb_c_base) + pb_c_init)
      score = qvalues + pb_c * priors * torch.sqrt(
          node_visit * log_term) * inv_n

    if kind != "bfs":
      score = torch.where(priors > 1e-9, score,
                          torch.full_like(score, -torch.inf))
    score = score + _tie_noise(generator, score)
    return torch.argmax(_mask_root_invalid(score, tree, depth), dim=-1)

  return fn


def switching_action_selection(
    root_fn: ActionSelectionFn,
    interior_fn: ActionSelectionFn,
) -> ActionSelectionFn:
  """Dispatch on depth: root rule at depth 0, interior rule below. ``depth``
  is the level of the lockstep descent, one Python int for the batch."""

  def fn(generator, tree, node_index, depth, sim):
    rule = root_fn if depth == 0 else interior_fn
    return rule(generator, tree, node_index, depth, sim)

  return fn


def make_muzero_action_selection(pb_c_init: float = 1.25,
                                 pb_c_base: float = 19652.0,
                                 qtransform=qtransforms
                                 .qtransform_by_parent_and_siblings
                                 ) -> ActionSelectionFn:
  return functools.partial(muzero_action_selection, pb_c_init=pb_c_init,
                           pb_c_base=pb_c_base, qtransform=qtransform)
