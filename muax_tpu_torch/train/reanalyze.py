"""Reanalyze: refresh stale replay targets with a fresh search
(``muax_tpu/train/reanalyze.py``).

Between training iterations, the search re-runs with the current
parameters over the stored observations of ``num_segments`` whole
segments, drawn stalest first, and rewrites their ``pi`` (fresh visit
distributions), ``value`` (fresh root values), ``rn`` (n-step returns
bootstrapped from the fresh values), step priorities and ``target_step``,
in place. The search is one ``policy_fn`` call over all K x L stored
observations: on the card, one launch of the fused search kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from muax_tpu_torch.config import MuZeroConfig
from muax_tpu_torch.device import resolve_device
from muax_tpu_torch.ops import segment_n_step_returns
from muax_tpu_torch.replay.buffer import ReplayState, last_writers
from muax_tpu_torch.train.actor import make_policy_fn


def stalest_first(replay_state: ReplayState, uniforms: torch.Tensor,
                  step: int) -> torch.Tensor:
  """Segments drawn in proportion to 1 + the age of their targets (filled
  slots only) by inverse CDF: the count of cumulative weights <= u x total,
  as the JAX package counts it. The weights are integers, so the f32 CDF is
  exact below 2^24. Returns int64 [K]."""
  C = replay_state.capacity
  dev = replay_state.target_step.device
  filled = torch.arange(C, device=dev) < replay_state.size
  age = (step - replay_state.target_step).to(torch.float32)
  weights = torch.where(filled, 1.0 + torch.clamp(age, min=0.0),
                        torch.zeros((), device=dev))
  cdf = torch.cumsum(weights, 0)
  return torch.searchsorted(cdf, uniforms * cdf[-1], right=True).clamp(
      max=C - 1)


def make_reanalyze_fn(networks, config: MuZeroConfig, num_segments: int,
                      device="cuda"):
  """Build reanalyze(params, replay_state, generator, step=0,
  uniforms=None) -> (replay_state, metrics).

  ``config.search.reanalyze_simulations``, when set, replaces the search
  budget (the ReZero recipe: cheaper searches over more of the buffer).
  The search runs in eval mode: no Dirichlet noise at the roots.
  ``uniforms`` [num_segments] in [0, 1) are the stalest-first draws; when
  None they come from ``generator``, which also feeds the search.
  Segments are drawn with replacement; a segment drawn twice keeps the
  rows of its last draw, on every device.
  """
  if config.search.reanalyze_simulations is not None:
    config = dataclasses.replace(config, search=dataclasses.replace(
        config.search,
        num_simulations=config.search.reanalyze_simulations))
  device = resolve_device(device)
  policy_fn = make_policy_fn(networks, config, config.train.discount,
                             eval_mode=True, device=device)
  tcfg = config.train
  alpha = config.replay.priority_alpha

  @torch.no_grad()
  def reanalyze(params, replay_state: ReplayState,
                generator: torch.Generator, step: int = 0,
                uniforms: Optional[torch.Tensor] = None):
    if uniforms is None:
      uniforms = torch.rand((num_segments,), generator=generator,
                            device=device)
    seg_idx = stalest_first(replay_state, uniforms, step)
    K, L = num_segments, replay_state.segment_length
    obs = replay_state.obs[seg_idx]                       # [K, L, ...]
    _, pi, root_value = policy_fn(
        params, generator, obs.reshape((K * L,) + tuple(obs.shape[2:])),
        params.temperature)
    pi = pi.reshape(K, L, -1)
    values = root_value.reshape(K, L)

    # The returns run over the segment's time axis: [L, K].
    rn = segment_n_step_returns(
        replay_state.reward[seg_idx].T, values.T,
        replay_state.done[seg_idx].T.to(torch.float32), tcfg.discount,
        tcfg.n_bootstrap, tcfg.bootstrap_lambda).T
    priorities = torch.abs(values - rn) ** alpha + 1e-6
    old_values = replay_state.value[seg_idx]
    age = (step - replay_state.target_step[seg_idx]).to(torch.float32)

    # A segment drawn twice keeps the rows of its last draw on every device.
    last = last_writers(seg_idx, replay_state.capacity)
    replay_state.pi[seg_idx] = pi[last]
    replay_state.value[seg_idx] = values[last]
    replay_state.rn[seg_idx] = rn[last]
    replay_state.step_priorities[seg_idx] = priorities[last]
    replay_state.target_step[seg_idx] = int(step)
    metrics = {
        "reanalyzed_segments": torch.tensor(num_segments),
        "reanalyze_value_shift": torch.mean(torch.abs(values - old_values)),
        "reanalyzed_target_age": torch.mean(age),
    }
    return replay_state, metrics

  return reanalyze
