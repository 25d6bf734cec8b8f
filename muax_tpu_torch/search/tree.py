"""Array-of-structs search tree, batched over the leading axis
(``muax_tpu/search/tree.py``).

The whole forest lives in fixed-shape tensors ``[B, N, ...]``; one node slot
is consumed per simulation, so capacity N = num_simulations + 1 with the root
in slot 0. Nodes are addressed with advanced indexing, ``x[rows, idx]`` with
``rows = arange(B)``: the one-hot masked gathers of the JAX package exist
because the TPU has no fast per-row gather, and are not carried over. Index
fields are int64 so that they index directly; visit counts are int32 as in
JAX. The search updates a tree in place.

An embedding is a tensor [B, ...] or a dataclass whose fields are tensors or
dataclasses again (Stochastic MuZero's ``StochasticRecurrentState``: the
latent and its node-type flag; Sampled MuZero's state and its [B, K, ...]
candidate actions; Diffusion MuZero's state, its [B, C, ...] candidate next
states and a bool flag); the tree stores one [B, N, ...] tensor per leaf, in
the leaf's own dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

ROOT_INDEX = 0
NO_PARENT = -1
UNVISITED = -1


def batch_rows(x: torch.Tensor) -> torch.Tensor:
  """arange(B) on ``x``'s device, the row index of a batched access."""
  return torch.arange(x.shape[0], device=x.device)


def embedding_fields(embedding) -> list:
  """The tensors of an embedding in field order, nested dataclasses
  flattened depth first."""
  if isinstance(embedding, torch.Tensor):
    return [embedding]
  return [leaf for f in dataclasses.fields(embedding)
          for leaf in embedding_fields(getattr(embedding, f.name))]


def map_embedding(fn, embedding, *others):
  """``fn`` applied to every tensor of an embedding (with the matching
  tensors of ``others``, embeddings of the same structure), keeping its
  structure."""
  if isinstance(embedding, torch.Tensor):
    return fn(embedding, *others)
  return dataclasses.replace(embedding, **{
      f.name: map_embedding(fn, getattr(embedding, f.name),
                            *(getattr(o, f.name) for o in others))
      for f in dataclasses.fields(embedding)})


def gather_embedding(embeddings, rows: torch.Tensor, node_index: torch.Tensor):
  """The [B, ...] embedding of node ``node_index`` [B] of each tree."""
  return map_embedding(lambda x: x[rows, node_index], embeddings)


def set_embedding(embeddings, rows: torch.Tensor, node_index: torch.Tensor,
                  value) -> None:
  """Write a [B, ...] embedding into node ``node_index`` of each tree."""
  for store, v in zip(embedding_fields(embeddings), embedding_fields(value)):
    store[rows, node_index] = v


def qvalues_at(tree: "Tree", node_index: torch.Tensor) -> torch.Tensor:
  """Batched child Q values r + discount * V(child) at node_index [B] ->
  [B, A]."""
  rows = batch_rows(node_index)
  return (tree.children_rewards[rows, node_index]
          + tree.children_discounts[rows, node_index]
          * tree.children_values[rows, node_index])


@dataclasses.dataclass
class SearchSummary:
  visit_counts: torch.Tensor  # [B, A] f32
  visit_probs: torch.Tensor   # [B, A]
  value: torch.Tensor         # [B]
  qvalues: torch.Tensor       # [B, A]


@dataclasses.dataclass
class Tree:
  """Batched search tree. Every field has leading dims [B, N] or [B, N, A]
  except ``root_invalid_actions`` [B, A]."""
  node_visits: torch.Tensor            # [B, N] int32
  node_values: torch.Tensor            # [B, N] f32, running-mean backup value
  node_raw_values: torch.Tensor        # [B, N] f32, network value at expansion
  parents: torch.Tensor                # [B, N] int64
  action_from_parent: torch.Tensor     # [B, N] int64
  children_index: torch.Tensor         # [B, N, A] int64 (UNVISITED = -1)
  children_prior_logits: torch.Tensor  # [B, N, A] f32
  children_visits: torch.Tensor        # [B, N, A] int32
  children_rewards: torch.Tensor       # [B, N, A] f32
  children_discounts: torch.Tensor     # [B, N, A] f32
  children_values: torch.Tensor        # [B, N, A] f32
  embeddings: Any                      # [B, N, ...] per embedding field
  root_invalid_actions: torch.Tensor   # [B, A] f32 (1 = invalid)
  extra_data: Any                      # policy-specific (root gumbel noise)

  def summary(self) -> SearchSummary:
    """Root statistics of every tree of the batch."""
    visit_counts = self.children_visits[:, ROOT_INDEX].to(torch.float32)
    total = torch.sum(visit_counts, dim=-1, keepdim=True)
    visit_probs = visit_counts / torch.clamp(total, min=1.0)
    visit_probs = torch.where(total > 0, visit_probs,
                              torch.full_like(visit_probs,
                                              1.0 / visit_probs.shape[-1]))
    return SearchSummary(
        visit_counts=visit_counts,
        visit_probs=visit_probs,
        value=self.node_values[:, ROOT_INDEX],
        qvalues=(self.children_rewards[:, ROOT_INDEX]
                 + self.children_discounts[:, ROOT_INDEX]
                 * self.children_values[:, ROOT_INDEX]),
    )


def instantiate_tree_from_root(root, num_simulations: int,
                               root_invalid_actions: torch.Tensor,
                               extra_data: Any) -> Tree:
  """Allocate a batched tree and install the (already evaluated) root."""
  batch_size, num_actions = root.prior_logits.shape
  num_nodes = num_simulations + 1
  dtype = root.prior_logits.dtype
  dev = root.prior_logits.device

  def zeros(*shape, dtype=dtype):
    return torch.zeros(shape, dtype=dtype, device=dev)

  def full(*shape, value):
    return torch.full(shape, value, dtype=torch.long, device=dev)

  embeddings = map_embedding(
      lambda x: zeros(batch_size, num_nodes, *x.shape[1:], dtype=x.dtype),
      root.embedding)
  set_embedding(embeddings, slice(None), ROOT_INDEX, root.embedding)
  tree = Tree(
      node_visits=zeros(batch_size, num_nodes, dtype=torch.int32),
      node_values=zeros(batch_size, num_nodes),
      node_raw_values=zeros(batch_size, num_nodes),
      parents=full(batch_size, num_nodes, value=NO_PARENT),
      action_from_parent=full(batch_size, num_nodes, value=NO_PARENT),
      children_index=full(batch_size, num_nodes, num_actions,
                          value=UNVISITED),
      children_prior_logits=zeros(batch_size, num_nodes, num_actions),
      children_visits=zeros(batch_size, num_nodes, num_actions,
                            dtype=torch.int32),
      children_rewards=zeros(batch_size, num_nodes, num_actions),
      children_discounts=zeros(batch_size, num_nodes, num_actions),
      children_values=zeros(batch_size, num_nodes, num_actions),
      embeddings=embeddings,
      root_invalid_actions=root_invalid_actions,
      extra_data=extra_data,
  )
  tree.node_visits[:, ROOT_INDEX] = 1
  tree.node_values[:, ROOT_INDEX] = root.value
  tree.node_raw_values[:, ROOT_INDEX] = root.value
  tree.children_prior_logits[:, ROOT_INDEX] = root.prior_logits
  return tree
