"""Search policies over the generic engine, MuZero, Gumbel MuZero and
Stochastic MuZero, and the root-noising and action-sampling helpers that the
fused policies share (``muax_tpu/search/policies.py``).

Each policy is a function over the batched ``search()`` core. Randomness
comes from one ``torch.Generator`` on the roots' device: the Dirichlet
noise, the tie-break noise of PUCT, the Gumbel draw and the sampled action.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import torch

from muax_tpu_torch.replay.buffer import gumbel_noise
from muax_tpu_torch.search import action_selection as selection_lib
from muax_tpu_torch.search import qtransforms
from muax_tpu_torch.search import seq_halving
from muax_tpu_torch.search.core import search
from muax_tpu_torch.search.tree import ROOT_INDEX, Tree, batch_rows
from muax_tpu_torch.search.types import (ChanceRecurrentFn,
                                         DecisionRecurrentFn, PolicyOutput,
                                         RecurrentFn, RecurrentFnOutput,
                                         RootFnOutput,
                                         StochasticRecurrentState)

_BIG_NEG = -1e9


def _get_logits_from_probs(probs: torch.Tensor) -> torch.Tensor:
  tiny = torch.finfo(probs.dtype).tiny
  return torch.log(torch.clamp(probs, min=tiny))


def _apply_temperature(logits: torch.Tensor, temperature) -> torch.Tensor:
  """temperature -> 0 degrades gracefully to argmax."""
  logits = logits - torch.amax(logits, dim=-1, keepdim=True)
  tiny = torch.finfo(logits.dtype).tiny
  temperature = torch.as_tensor(temperature, dtype=logits.dtype,
                                device=logits.device)
  return logits / torch.clamp(temperature, min=tiny)


def _mask_invalid(logits: torch.Tensor, invalid: Optional[torch.Tensor]):
  if invalid is None:
    return logits
  return torch.where(invalid > 0, torch.full_like(logits, _BIG_NEG), logits)


def _sample_gamma(alpha: float, shape, generator: torch.Generator
                  ) -> torch.Tensor:
  """Gamma(alpha, 1) draws from ``generator`` on its device (f32).

  Marsaglia and Tsang's squeeze for shape >= 1; a shape below 1 draws
  Gamma(alpha + 1) and scales by U^(1/alpha). Rejected candidates are
  redrawn until every entry is accepted (acceptance is above 95%).
  """
  device = generator.device
  boost = alpha < 1.0
  d = (alpha + 1.0 if boost else alpha) - 1.0 / 3.0
  c = 1.0 / (9.0 * d) ** 0.5
  out = torch.zeros(shape, dtype=torch.float32, device=device)
  todo = torch.ones(shape, dtype=torch.bool, device=device)
  while bool(todo.any()):
    x = torch.randn(shape, generator=generator, device=device)
    u = torch.rand(shape, generator=generator, device=device)
    v = (1.0 + c * x) ** 3
    ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                    + d * torch.log(torch.clamp(v, min=1e-30)))
    take = todo & ok
    out = torch.where(take, d * v, out)
    todo = todo & ~ok
  if boost:
    u = torch.rand(shape, generator=generator, device=device)
    out = out * u ** (1.0 / alpha)
  return out


def _add_dirichlet_noise(generator: torch.Generator, probs: torch.Tensor, *,
                         fraction: float, alpha: float) -> torch.Tensor:
  """(1 - fraction) * probs + fraction * Dirichlet(alpha), one draw per row."""
  gammas = _sample_gamma(alpha, probs.shape, generator)
  tiny = torch.finfo(gammas.dtype).tiny
  noise = gammas / torch.clamp(torch.sum(gammas, dim=-1, keepdim=True),
                               min=tiny)
  return (1.0 - fraction) * probs + fraction * noise


@torch.no_grad()
def muzero_policy(
    params: Any,
    generator: torch.Generator,
    root: RootFnOutput,
    recurrent_fn: RecurrentFn,
    num_simulations: int,
    invalid_actions: Optional[torch.Tensor] = None,
    max_depth: Optional[int] = None,
    *,
    qtransform=qtransforms.qtransform_by_parent_and_siblings,
    dirichlet_fraction: float = 0.25,
    dirichlet_alpha: float = 0.3,
    pb_c_init: float = 1.25,
    pb_c_base: float = 19652.0,
    temperature=1.0,
) -> PolicyOutput[Tree]:
  """Vanilla MuZero: Dirichlet-noised PUCT search, visit-count^(1/T) action.

  Defaults match the reference's MuZeroPolicy (muax/policy.py:13-30).
  """
  probs = torch.softmax(root.prior_logits, dim=-1)
  if dirichlet_fraction > 0.0:
    probs = _add_dirichlet_noise(generator, probs,
                                 fraction=dirichlet_fraction,
                                 alpha=dirichlet_alpha)
  root = dataclasses.replace(root, prior_logits=_mask_invalid(
      _get_logits_from_probs(probs), invalid_actions))

  select_fn = selection_lib.make_muzero_action_selection(
      pb_c_init=pb_c_init, pb_c_base=pb_c_base, qtransform=qtransform)
  tree = search(
      params, generator, root=root, recurrent_fn=recurrent_fn,
      root_action_selection_fn=select_fn,
      interior_action_selection_fn=select_fn,
      num_simulations=num_simulations, max_depth=max_depth,
      invalid_actions=invalid_actions)

  action_weights = tree.summary().visit_probs
  action_logits = _apply_temperature(_get_logits_from_probs(action_weights),
                                     temperature)
  action = torch.multinomial(torch.softmax(action_logits, dim=-1), 1,
                             generator=generator)[:, 0]
  return PolicyOutput(action=action.to(torch.int32),
                      action_weights=action_weights, search_tree=tree)


@dataclasses.dataclass
class GumbelExtraData:
  root_gumbel: torch.Tensor  # [B, A]


@torch.no_grad()
def gumbel_muzero_policy(
    params: Any,
    generator: torch.Generator,
    root: RootFnOutput,
    recurrent_fn: RecurrentFn,
    num_simulations: int,
    invalid_actions: Optional[torch.Tensor] = None,
    max_depth: Optional[int] = None,
    *,
    qtransform=qtransforms.qtransform_completed_by_mix_value,
    max_num_considered_actions: int = 16,
    gumbel_scale: float = 1.0,
    gumbel: Optional[torch.Tensor] = None,
) -> PolicyOutput[Tree]:
  """Gumbel MuZero: sequential-halving root search, policy-improvement
  weights softmax(logits + sigma(q-hat)).

  Defaults match the reference's GumbelMuZeroPolicy (muax/policy.py:33-47).
  ``gumbel`` [B, A], when given, is the root noise already scaled, in place
  of ``gumbel_scale`` times a draw from ``generator``; the tests inject the
  JAX package's draw through it.
  """
  prior_logits = _mask_invalid(root.prior_logits, invalid_actions)
  root = dataclasses.replace(root, prior_logits=prior_logits)
  if gumbel is None:
    gumbel = gumbel_scale * gumbel_noise(generator, prior_logits.shape,
                                         prior_logits.device)
  table = torch.from_numpy(seq_halving.considered_visit_table(
      max_num_considered_actions, num_simulations)).to(prior_logits.device)
  root_fn = functools.partial(
      selection_lib.gumbel_muzero_root_action_selection,
      table=table, max_num_considered_actions=max_num_considered_actions,
      qtransform=qtransform)
  interior_fn = functools.partial(
      selection_lib.gumbel_muzero_interior_action_selection,
      qtransform=qtransform)

  tree = search(
      params, generator, root=root, recurrent_fn=recurrent_fn,
      root_action_selection_fn=root_fn,
      interior_action_selection_fn=interior_fn,
      num_simulations=num_simulations, max_depth=max_depth,
      invalid_actions=invalid_actions,
      extra_data=GumbelExtraData(root_gumbel=gumbel))

  # Final action: among actions at the most-advanced schedule stage (max
  # visit count), argmax of g + logits + sigma(q-hat).
  visit_counts = tree.summary().visit_counts
  completed_q = qtransform(tree, torch.full(
      (prior_logits.shape[0],), ROOT_INDEX, dtype=torch.long,
      device=prior_logits.device))
  considered_visit = torch.amax(visit_counts, dim=-1, keepdim=True)
  score = torch.where(visit_counts == considered_visit,
                      gumbel + prior_logits + completed_q,
                      torch.full_like(completed_q, -torch.inf))
  action = torch.argmax(_mask_invalid(score, invalid_actions), dim=-1)
  action_weights = torch.softmax(
      _mask_invalid(prior_logits + completed_q, invalid_actions), dim=-1)
  return PolicyOutput(action=action.to(torch.int32),
                      action_weights=action_weights, search_tree=tree)


def _make_stochastic_recurrent_fn(
    decision_recurrent_fn: DecisionRecurrentFn,
    chance_recurrent_fn: ChanceRecurrentFn,
    num_actions: int,
    num_chance_outcomes: int,
    discount,
) -> RecurrentFn:
  """Interleave decision and chance steps over A' = A + C extended actions.

  Both branches run on the whole batch and are blended by
  ``is_decision_node``, as in the JAX package. After a decision action the
  new node is an afterstate (a chance node: its children are outcomes, the
  edge carries reward 0 and discount 1); after an outcome it is a state (a
  decision node), and the edge carries the reward and the discount.
  """

  def fn(params, generator, action, state: StochasticRecurrentState):
    a = torch.clamp(action, 0, num_actions - 1)
    outcome = torch.clamp(action - num_actions, 0, num_chance_outcomes - 1)
    dec_out, afterstate = decision_recurrent_fn(params, generator, a,
                                                state.state)
    ch_out, next_state = chance_recurrent_fn(params, generator, outcome,
                                             state.state)
    is_dec = state.is_decision_node
    batch = is_dec.shape[0]
    pad_a = torch.full((batch, num_actions), _BIG_NEG,
                       dtype=dec_out.chance_logits.dtype,
                       device=is_dec.device)
    pad_c = torch.full((batch, num_chance_outcomes), _BIG_NEG,
                       dtype=ch_out.action_logits.dtype, device=is_dec.device)
    afterstate_priors = torch.cat([pad_a, dec_out.chance_logits], -1)
    state_priors = torch.cat([ch_out.action_logits, pad_c], -1)
    output = RecurrentFnOutput(
        reward=torch.where(is_dec, torch.zeros_like(ch_out.reward),
                           ch_out.reward),
        discount=torch.where(is_dec, torch.ones_like(ch_out.reward),
                             torch.full_like(ch_out.reward, discount)),
        prior_logits=torch.where(is_dec[:, None], afterstate_priors,
                                 state_priors),
        value=torch.where(is_dec, dec_out.afterstate_value, ch_out.value))
    flag = is_dec.reshape((-1,) + (1,) * (afterstate.ndim - 1))
    return output, StochasticRecurrentState(
        state=torch.where(flag, afterstate, next_state),
        is_decision_node=~is_dec)

  return fn


def _stochastic_interior_selection(generator, tree: Tree, node_index,
                                   depth: int, sim: int, *, num_actions: int,
                                   pb_c_init: float, pb_c_base: float,
                                   qtransform) -> torch.Tensor:
  """Decision nodes: PUCT over the decision slots (with the 1e-7 tie
  noise). Chance nodes: argmax p(o) - n(o)/(1 + N) over the outcome slots,
  so visits track the chance prior. Invalid actions masked at depth 0."""
  del sim
  rows = batch_rows(node_index)
  num_total = tree.children_visits.shape[-1]
  is_dec = tree.embeddings.is_decision_node[rows, node_index]        # [B]
  slot = torch.arange(num_total, device=node_index.device)
  valid_slots = torch.where(is_dec[:, None], slot[None] < num_actions,
                            slot[None] >= num_actions)              # [B, A']
  visit_counts = tree.children_visits[rows, node_index].to(torch.float32)
  node_visit = tree.node_visits[rows, node_index].to(torch.float32)
  pb_c = pb_c_init + torch.log((node_visit + pb_c_base + 1.0) / pb_c_base)
  prior_probs = torch.softmax(tree.children_prior_logits[rows, node_index],
                              -1)
  policy_score = (torch.sqrt(node_visit) * pb_c)[:, None] * prior_probs / (
      visit_counts + 1.0)
  decision_score = (qtransform(tree, node_index) + policy_score
                    + selection_lib._tie_noise(generator, policy_score))
  chance_score = prior_probs - visit_counts / (
      1.0 + torch.sum(visit_counts, -1, keepdim=True))
  score = torch.where(is_dec[:, None], decision_score, chance_score)
  score = torch.where(valid_slots, score, torch.full_like(score, -torch.inf))
  if depth == 0:
    score = selection_lib._mask_invalid(score, tree.root_invalid_actions)
  return torch.argmax(score, -1)


@torch.no_grad()
def stochastic_muzero_policy(
    params: Any,
    generator: torch.Generator,
    root: RootFnOutput,
    decision_recurrent_fn: DecisionRecurrentFn,
    chance_recurrent_fn: ChanceRecurrentFn,
    num_simulations: int,
    num_chance_outcomes: int,
    invalid_actions: Optional[torch.Tensor] = None,
    max_depth: Optional[int] = None,
    *,
    qtransform=qtransforms.qtransform_by_parent_and_siblings,
    dirichlet_fraction: float = 0.25,
    dirichlet_alpha: float = 0.3,
    pb_c_init: float = 1.25,
    pb_c_base: float = 19652.0,
    temperature=1.0,
    discount=1.0,
) -> PolicyOutput[Tree]:
  """Stochastic MuZero over the extended action space A' = A + C: decision
  and chance steps interleave down the tree, and rewards and the discount
  apply on chance transitions. The action weights are the root's decision
  visits, normalized."""
  batch_size, num_actions = root.prior_logits.shape
  dev = root.prior_logits.device
  probs = torch.softmax(root.prior_logits, dim=-1)
  if dirichlet_fraction > 0.0:
    probs = _add_dirichlet_noise(generator, probs,
                                 fraction=dirichlet_fraction,
                                 alpha=dirichlet_alpha)
  noised_logits = _mask_invalid(_get_logits_from_probs(probs),
                                invalid_actions)
  pad_c = torch.full((batch_size, num_chance_outcomes), _BIG_NEG,
                     dtype=root.prior_logits.dtype, device=dev)
  extended_root = RootFnOutput(
      prior_logits=torch.cat([noised_logits, pad_c], -1),
      value=root.value,
      embedding=StochasticRecurrentState(
          state=root.embedding,
          is_decision_node=torch.ones(batch_size, dtype=torch.bool,
                                      device=dev)))
  if invalid_actions is None:
    invalid_actions = torch.zeros((batch_size, num_actions),
                                  dtype=root.prior_logits.dtype, device=dev)
  # Chance slots are never valid at the (decision) root.
  extended_invalid = torch.cat([invalid_actions, torch.ones(
      (batch_size, num_chance_outcomes), dtype=invalid_actions.dtype,
      device=dev)], -1)
  select_fn = functools.partial(
      _stochastic_interior_selection, num_actions=num_actions,
      pb_c_init=pb_c_init, pb_c_base=pb_c_base, qtransform=qtransform)
  tree = search(
      params, generator, root=extended_root,
      recurrent_fn=_make_stochastic_recurrent_fn(
          decision_recurrent_fn, chance_recurrent_fn, num_actions,
          num_chance_outcomes, discount),
      root_action_selection_fn=select_fn,
      interior_action_selection_fn=select_fn,
      num_simulations=num_simulations, max_depth=max_depth,
      invalid_actions=extended_invalid)

  decision_probs = tree.summary().visit_probs[:, :num_actions]
  decision_probs = decision_probs / torch.clamp(
      torch.sum(decision_probs, -1, keepdim=True), min=1e-12)
  action_logits = _apply_temperature(_get_logits_from_probs(decision_probs),
                                     temperature)
  action = torch.multinomial(torch.softmax(action_logits, dim=-1), 1,
                             generator=generator)[:, 0]
  return PolicyOutput(action=action.to(torch.int32),
                      action_weights=decision_probs, search_tree=tree)
