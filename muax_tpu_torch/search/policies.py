"""Search policies over the generic engine, MuZero and Gumbel MuZero, and
the root-noising and action-sampling helpers that the fused policies share
(``muax_tpu/search/policies.py:37-170``).

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
from muax_tpu_torch.search.tree import ROOT_INDEX, Tree
from muax_tpu_torch.search.types import (PolicyOutput, RecurrentFn,
                                         RootFnOutput)

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
