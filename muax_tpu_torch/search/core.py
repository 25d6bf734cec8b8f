"""The generic batched search loop: simulate -> expand -> backward
(``muax_tpu/search/core.py``).

B independent trees are searched in lockstep; the network (``recurrent_fn``)
runs once per simulation on the whole batch. The tree walks advance every
element one level per loop iteration, and elements that reached their leaf
are frozen by masks until the deepest walker finishes. This is the
composable core the policies in ``policies.py`` build on. It runs on
whichever device the tree lies on; the tree is updated in place.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from muax_tpu_torch.search import tree as tree_lib
from muax_tpu_torch.search.action_selection import (
    ActionSelectionFn, switching_action_selection)
from muax_tpu_torch.search.tree import (ROOT_INDEX, UNVISITED, Tree,
                                        batch_rows)
from muax_tpu_torch.search.types import RecurrentFn, RootFnOutput


def simulate(generator: torch.Generator, tree: Tree,
             action_selection_fn: ActionSelectionFn, max_depth: int,
             sim: int) -> tuple[torch.Tensor, torch.Tensor]:
  """Descend every tree from its root until hitting an unexpanded child (or
  the depth cap). Returns (parent_index [B], action [B])."""
  batch_size = tree.node_visits.shape[0]
  dev = tree.node_visits.device
  rows = torch.arange(batch_size, device=dev)
  node_index = torch.full((batch_size,), tree_lib.NO_PARENT,
                          dtype=torch.long, device=dev)
  action = torch.full_like(node_index, tree_lib.NO_PARENT)
  next_node_index = torch.full_like(node_index, ROOT_INDEX)
  is_continuing = torch.ones(batch_size, dtype=torch.bool, device=dev)
  depth = 0
  while bool(is_continuing.any()):
    # Frozen elements may point at UNVISITED: they read the root instead,
    # and what is selected for them is discarded.
    at = torch.where(is_continuing, next_node_index,
                     torch.zeros_like(next_node_index))
    chosen = action_selection_fn(generator, tree, at, depth, sim)
    child = tree.children_index[rows, at, chosen]
    node_index = torch.where(is_continuing, at, node_index)
    action = torch.where(is_continuing, chosen, action)
    next_node_index = torch.where(is_continuing, child, next_node_index)
    depth += 1
    is_continuing = is_continuing & (next_node_index != UNVISITED) & (
        depth < max_depth)
  return node_index, action


def update_tree_node(tree: Tree, node_index: torch.Tensor,
                     prior_logits: torch.Tensor, value: torch.Tensor,
                     embedding) -> Tree:
  """Batched node (re)initialization with running-mean value blending."""
  rows = batch_rows(node_index)
  count = tree.node_visits[rows, node_index].to(value.dtype)
  old_value = tree.node_values[rows, node_index]
  tree.node_values[rows, node_index] = (old_value * count + value) / (
      count + 1.0)
  tree.node_visits[rows, node_index] += 1
  tree.node_raw_values[rows, node_index] = value
  tree.children_prior_logits[rows, node_index] = prior_logits
  tree_lib.set_embedding(tree.embeddings, rows, node_index, embedding)
  return tree


def expand(params: Any, generator: torch.Generator, tree: Tree,
           recurrent_fn: RecurrentFn, parent_index: torch.Tensor,
           action: torch.Tensor, next_node_index: torch.Tensor) -> Tree:
  """Evaluate the model once on the whole batch and install the new nodes."""
  rows = batch_rows(parent_index)
  embedding = tree_lib.gather_embedding(tree.embeddings, rows, parent_index)
  step, next_embedding = recurrent_fn(params, generator, action, embedding)
  update_tree_node(tree, next_node_index, step.prior_logits, step.value,
                   next_embedding)
  tree.parents[rows, next_node_index] = parent_index
  tree.action_from_parent[rows, next_node_index] = action
  tree.children_index[rows, parent_index, action] = next_node_index
  tree.children_rewards[rows, parent_index, action] = step.reward
  tree.children_discounts[rows, parent_index, action] = step.discount
  return tree


def backward(tree: Tree, leaf_index: torch.Tensor) -> Tree:
  """Propagate the new leaf values to the roots along parent pointers.

  Every element climbs one edge per loop iteration; elements whose walker
  already reached the root write back what they read. The walk starts from
  the leaf's blended node value (``core.py:186``), not its raw value.
  """
  rows = batch_rows(leaf_index)
  index = leaf_index
  leaf_value = tree.node_values[rows, leaf_index]
  while bool((index != ROOT_INDEX).any()):
    active = index != ROOT_INDEX
    parent = torch.where(active, tree.parents[rows, index],
                         torch.zeros_like(index))
    action = torch.where(active, tree.action_from_parent[rows, index],
                         torch.zeros_like(index))
    count = tree.node_visits[rows, parent].to(leaf_value.dtype)
    reward = tree.children_rewards[rows, parent, action]
    discount = tree.children_discounts[rows, parent, action]
    new_leaf_value = reward + discount * leaf_value
    parent_value = (tree.node_values[rows, parent] * count
                    + new_leaf_value) / (count + 1.0)
    child_value = tree.node_values[rows, index]
    tree.node_values[rows, parent] = torch.where(
        active, parent_value, tree.node_values[rows, parent])
    tree.node_visits[rows, parent] += active.to(torch.int32)
    tree.children_values[rows, parent, action] = torch.where(
        active, child_value, tree.children_values[rows, parent, action])
    tree.children_visits[rows, parent, action] += active.to(torch.int32)
    leaf_value = torch.where(active, new_leaf_value, leaf_value)
    index = torch.where(active, parent, index)
  return tree


@torch.no_grad()
def search(
    params: Any,
    generator: torch.Generator,
    *,
    root: RootFnOutput,
    recurrent_fn: RecurrentFn,
    root_action_selection_fn: ActionSelectionFn,
    interior_action_selection_fn: ActionSelectionFn,
    num_simulations: int,
    max_depth: Optional[int] = None,
    invalid_actions: Optional[torch.Tensor] = None,
    extra_data: Any = (),
) -> Tree:
  """Run ``num_simulations`` batched simulations from ``root``.

  Selection dispatches root vs interior rule by depth; each simulation
  expands exactly one node per batch element into slot ``sim + 1`` (unless
  the depth cap re-visits an existing node, which is then re-evaluated).
  Per-edge discounts come from ``recurrent_fn``. Nothing is recorded for
  autograd.
  """
  batch_size, num_actions = root.prior_logits.shape
  if max_depth is None:
    max_depth = num_simulations
  if invalid_actions is None:
    invalid_actions = torch.zeros((batch_size, num_actions),
                                  dtype=root.prior_logits.dtype,
                                  device=root.prior_logits.device)
  if root_action_selection_fn is interior_action_selection_fn:
    # One rule for all depths (MuZero PUCT handles the root mask itself).
    action_selection_fn = root_action_selection_fn
  else:
    action_selection_fn = switching_action_selection(
        root_action_selection_fn, interior_action_selection_fn)

  tree = tree_lib.instantiate_tree_from_root(
      root, num_simulations, invalid_actions, extra_data)
  rows = torch.arange(batch_size, device=root.prior_logits.device)
  for sim in range(num_simulations):
    parent_index, action = simulate(generator, tree, action_selection_fn,
                                    max_depth, sim)
    # Slot for this simulation's node; if the depth cap stopped the descent
    # at an already-expanded child, reuse (and re-evaluate) that node.
    next_node_index = tree.children_index[rows, parent_index, action]
    next_node_index = torch.where(next_node_index == UNVISITED,
                                  torch.full_like(next_node_index, sim + 1),
                                  next_node_index)
    expand(params, generator, tree, recurrent_fn, parent_index, action,
           next_node_index)
    backward(tree, next_node_index)
  return tree
