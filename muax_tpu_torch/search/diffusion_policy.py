"""Diffusion MuZero: stochastic search over continuous next-state samples
(``muax_tpu/search/diffusion_policy.py``).

The chance branch of the stochastic search draws C candidate next states
from a generative sampler (the rectified flow's Euler ODE,
``models/diffusion.py``) instead of a discrete codebook; the tree's extended
action space is A' = A + C, where chance slot i means "transition into
sample i". The policy is a composition over the generic ``search()`` core.

Interfaces:
  decision_recurrent_fn(params, generator, action, state)
      -> (DecisionRecurrentFnOutput, afterstate)        # as Stochastic MuZero
  sample_fn(params, generator, afterstate) -> samples [B, C, ...]
  chance_eval_fn(params, generator, next_state) -> ChanceRecurrentFnOutput
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import torch

from muax_tpu_torch.search import qtransforms
from muax_tpu_torch.search.core import search
from muax_tpu_torch.search.policies import (_BIG_NEG, _add_dirichlet_noise,
                                            _apply_temperature,
                                            _get_logits_from_probs,
                                            _mask_invalid,
                                            _stochastic_interior_selection)
from muax_tpu_torch.search.tree import Tree, batch_rows, map_embedding
from muax_tpu_torch.search.types import (PolicyOutput, RecurrentFnOutput,
                                         RootFnOutput)


@dataclasses.dataclass
class DiffusionRecurrentState:
  """Tree embedding: the latent (a state or an afterstate), the candidate
  next states drawn at an afterstate, and which of the two a node is."""
  state: Any                      # [B, ...]
  next_state_samples: Any         # [B, C, ...]
  is_decision_node: torch.Tensor  # [B] bool


def _make_diffusion_recurrent_fn(decision_recurrent_fn, sample_fn,
                                 chance_eval_fn, num_actions: int,
                                 num_samples: int, discount):
  """Both branches run on every row and are blended by
  ``is_decision_node``, as in the JAX package: a decision node's child is
  an afterstate with freshly drawn candidates (reward 0, discount 1), a
  chance node's child is the chosen candidate, evaluated."""

  def fn(params, generator, action, emb: DiffusionRecurrentState):
    a = torch.clamp(action, 0, num_actions - 1)
    sample_idx = torch.clamp(action - num_actions, 0, num_samples - 1)
    rows = batch_rows(action)

    dec_out, afterstate = decision_recurrent_fn(params, generator, a,
                                                emb.state)
    samples = sample_fn(params, generator, afterstate)         # [B, C, ...]

    chosen = map_embedding(lambda s: s[rows, sample_idx],
                           emb.next_state_samples)
    ch_out = chance_eval_fn(params, generator, chosen)

    batch = action.shape[0]
    pad_a = torch.full((batch, num_actions), _BIG_NEG,
                       dtype=dec_out.chance_logits.dtype,
                       device=action.device)
    pad_c = torch.full((batch, num_samples), _BIG_NEG,
                       dtype=ch_out.action_logits.dtype, device=action.device)
    afterstate_priors = torch.cat([pad_a, dec_out.chance_logits], -1)
    state_priors = torch.cat([ch_out.action_logits, pad_c], -1)

    is_dec = emb.is_decision_node
    discount_t = torch.as_tensor(discount, dtype=ch_out.reward.dtype,
                                 device=action.device).expand(batch)
    output = RecurrentFnOutput(
        reward=torch.where(is_dec, torch.zeros_like(ch_out.reward),
                           ch_out.reward),
        discount=torch.where(is_dec, torch.ones_like(ch_out.reward),
                             discount_t),
        prior_logits=torch.where(is_dec[:, None], afterstate_priors,
                                 state_priors),
        value=torch.where(is_dec, dec_out.afterstate_value, ch_out.value))

    def blend(dec_leaf, ch_leaf):
      d = is_dec.reshape((batch,) + (1,) * (dec_leaf.ndim - 1))
      return torch.where(d, dec_leaf, ch_leaf)

    return output, DiffusionRecurrentState(
        state=map_embedding(blend, afterstate, chosen),
        next_state_samples=map_embedding(blend, samples,
                                         emb.next_state_samples),
        is_decision_node=~is_dec)

  return fn


@torch.no_grad()
def diffusion_muzero_policy(
    params: Any,
    generator: torch.Generator,
    root: RootFnOutput,
    decision_recurrent_fn,
    sample_fn: Callable,
    chance_eval_fn: Callable,
    num_simulations: int,
    num_samples: int,
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
  """Search with diffusion-sampled chance transitions; the action weights
  are the root's decision visits, normalized."""
  batch_size, num_actions = root.prior_logits.shape
  dev = root.prior_logits.device
  probs = torch.softmax(root.prior_logits, -1)
  if dirichlet_fraction > 0.0:
    probs = _add_dirichlet_noise(generator, probs,
                                 fraction=dirichlet_fraction,
                                 alpha=dirichlet_alpha)
  noised_logits = _mask_invalid(_get_logits_from_probs(probs),
                                invalid_actions)

  # The root's candidate set, unused until a chance step, fixes the
  # embedding's structure.
  seed_samples = sample_fn(params, generator, root.embedding)
  extended_root = RootFnOutput(
      prior_logits=torch.cat([noised_logits, torch.full(
          (batch_size, num_samples), _BIG_NEG, dtype=root.prior_logits.dtype,
          device=dev)], -1),
      value=root.value,
      embedding=DiffusionRecurrentState(
          state=root.embedding, next_state_samples=seed_samples,
          is_decision_node=torch.ones(batch_size, dtype=torch.bool,
                                      device=dev)))
  if invalid_actions is None:
    invalid_actions = torch.zeros((batch_size, num_actions),
                                  dtype=root.prior_logits.dtype, device=dev)
  # Chance slots are never valid at the (decision) root.
  extended_invalid = torch.cat([invalid_actions, torch.ones(
      (batch_size, num_samples), dtype=invalid_actions.dtype, device=dev)],
      -1)

  combined = _make_diffusion_recurrent_fn(
      decision_recurrent_fn, sample_fn, chance_eval_fn, num_actions,
      num_samples, discount)
  select_fn = functools.partial(
      _stochastic_interior_selection, num_actions=num_actions,
      pb_c_init=pb_c_init, pb_c_base=pb_c_base, qtransform=qtransform)
  tree = search(
      params, generator, root=extended_root, recurrent_fn=combined,
      root_action_selection_fn=select_fn,
      interior_action_selection_fn=select_fn,
      num_simulations=num_simulations, max_depth=max_depth,
      invalid_actions=extended_invalid)

  decision_probs = tree.summary().visit_probs[:, :num_actions]
  decision_probs = decision_probs / torch.clamp(
      torch.sum(decision_probs, -1, keepdim=True), min=1e-12)
  action_logits = _apply_temperature(_get_logits_from_probs(decision_probs),
                                     temperature)
  action = torch.multinomial(torch.softmax(action_logits, -1), 1,
                             generator=generator)[:, 0]
  return PolicyOutput(action=action.to(torch.int32),
                      action_weights=decision_probs, search_tree=tree)
