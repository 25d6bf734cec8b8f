"""The vectorized actor: {search -> env.step -> write} over T steps of B envs
(``muax_tpu/train/actor.py``).

Self-play searches with MuZero, Gumbel MuZero or Stochastic MuZero. With
``search.fused`` (the default) the MLP triplet and the acme categorical
family go through the fused search: on the card its CUDA kernel (the
categorical family in the kernel's categorical modes), on the CPU its plain
version; Stochastic MuZero's five nets go through the fused forest search
(``csrc/fused_smz.cu`` on the card, its plain version on the CPU). With
``search.fused=False``, and for a family the kernel does not take (the
fc-resnet and the conv triplets, as in the JAX package), it goes through
the generic engine
(``search/core.py``) on whichever device the caller chose; that route is
picked from the configuration and the family, never as a fallback after a
failure. On an env with ``legal_actions`` (the board games) every route
searches under the legal-action mask of the states it acts in.
"""
from __future__ import annotations

import torch

from muax_tpu_torch.config import MuZeroConfig
from muax_tpu_torch.device import resolve_device
from muax_tpu_torch.envs.base import AutoResetState, AutoResetWrapper
from muax_tpu_torch.models.networks import MZNetworks, MZParams
from muax_tpu_torch.models.stochastic_networks import SMZNetworks
from muax_tpu_torch.ops import segment_n_step_returns
from muax_tpu_torch.search.fused import (extract_search_weights,
                                         extract_smz_fused_weights,
                                         fused_mlp_gumbel_policy,
                                         fused_mlp_muzero_policy,
                                         fused_smz_policy)
from muax_tpu_torch.search.policies import (gumbel_muzero_policy,
                                            muzero_policy,
                                            stochastic_muzero_policy)
from muax_tpu_torch.train.inference import (make_recurrent_fn, make_root_fn,
                                            make_smz_fns)
from muax_tpu_torch.types import Transition


def uses_fused_search(networks, config: MuZeroConfig) -> bool:
  """Whether ``make_policy_fn`` takes the fused search: ``search.fused`` and
  a family with a kernel (the MLP triplet, the categorical LayerNormMLP,
  Stochastic MuZero's five nets). The conv triplets (``ConvMZNetworks``,
  family "conv") and the fc-resnet have none."""
  if not config.search.fused:
    return False
  return isinstance(networks, (MZNetworks, SMZNetworks)) or (
      getattr(networks, "family", None) == "mlp"
      and bool(networks.layer_sizes))


def _stochastic_policy(networks, config: MuZeroConfig, discount: float,
                       dirichlet_fraction: float):
  """(params, generator, obs, temperature, invalid_actions) -> (action, pi,
  root value) for Stochastic MuZero: the fused forest search under
  ``search.fused``, the generic engine otherwise."""
  if not isinstance(networks, SMZNetworks):
    raise ValueError("policy 'stochastic' needs Stochastic MuZero networks "
                     "(make_stochastic_mlp_networks)")
  search = config.search
  root_fn, decision_fn, chance_fn = make_smz_fns(networks, discount)
  common = dict(num_simulations=search.num_simulations,
                max_depth=search.max_depth,
                dirichlet_fraction=dirichlet_fraction,
                dirichlet_alpha=search.dirichlet_alpha,
                pb_c_init=search.pb_c_init, pb_c_base=search.pb_c_base)

  def fused(params, generator, obs, temperature, invalid_actions):
    return fused_smz_policy(
        params, generator, root_fn(params, obs),
        extract_smz_fused_weights(networks, params),
        support_size=networks.support_size, discount=discount,
        temperature=temperature, invalid_actions=invalid_actions, **common)

  def generic(params, generator, obs, temperature, invalid_actions):
    out = stochastic_muzero_policy(
        params, generator, root_fn(params, obs), decision_fn, chance_fn,
        num_chance_outcomes=networks.num_chance_outcomes,
        temperature=temperature, discount=discount,
        invalid_actions=invalid_actions, **common)
    return (out.action, out.action_weights,
            out.search_tree.summary().value)

  return fused if uses_fused_search(networks, config) else generic


def _triplet_policy(networks, config: MuZeroConfig, discount: float,
                    dirichlet_fraction: float):
  """(params, generator, obs, temperature, invalid_actions) -> (action, pi,
  root value) for MuZero and Gumbel MuZero over a triplet family: the fused
  search for a family with a kernel under ``search.fused``, the generic
  engine otherwise."""
  if isinstance(networks, SMZNetworks):
    raise ValueError("Stochastic MuZero networks search with policy "
                     "'stochastic'")
  search = config.search
  root_fn = make_root_fn(networks)
  recurrent_fn = make_recurrent_fn(networks, discount)

  def fused(params, generator, obs, temperature, invalid_actions):
    root = root_fn(params, obs)
    weights = extract_search_weights(networks, params)
    common = dict(num_simulations=search.num_simulations,
                  support_size=getattr(networks, "support_size", None),
                  discount=discount, max_depth=search.max_depth,
                  invalid_actions=invalid_actions)
    if search.policy == "gumbel":
      return fused_mlp_gumbel_policy(
          params, generator, root, weights,
          max_num_considered_actions=search.max_num_considered_actions,
          gumbel_scale=search.gumbel_scale, **common)
    return fused_mlp_muzero_policy(
        params, generator, root, weights,
        dirichlet_fraction=dirichlet_fraction,
        dirichlet_alpha=search.dirichlet_alpha, pb_c_init=search.pb_c_init,
        pb_c_base=search.pb_c_base, temperature=temperature, **common)

  def generic(params, generator, obs, temperature, invalid_actions):
    root = root_fn(params, obs)
    common = dict(num_simulations=search.num_simulations,
                  max_depth=search.max_depth,
                  invalid_actions=invalid_actions)
    if search.policy == "gumbel":
      out = gumbel_muzero_policy(
          params, generator, root, recurrent_fn,
          max_num_considered_actions=search.max_num_considered_actions,
          gumbel_scale=search.gumbel_scale, **common)
    else:
      out = muzero_policy(
          params, generator, root, recurrent_fn,
          dirichlet_fraction=dirichlet_fraction,
          dirichlet_alpha=search.dirichlet_alpha,
          pb_c_init=search.pb_c_init, pb_c_base=search.pb_c_base,
          temperature=temperature, **common)
    return (out.action, out.action_weights,
            out.search_tree.summary().value)

  return fused if uses_fused_search(networks, config) else generic


def make_policy_fn(networks, config: MuZeroConfig, discount: float,
                   eval_mode: bool = False, device="cuda"):
  """(params, generator, obs, temperature, invalid_actions=None) ->
  (action [B] int32, pi [B, A], root_value [B]).

  ``eval_mode`` disables the Dirichlet exploration noise on the MuZero and
  Stochastic MuZero root prior. ``invalid_actions`` [B, A] (1 = invalid)
  masks actions out of the search and the choice. ``obs`` must lie on
  ``device``; ``generator`` on the same device.
  """
  device = resolve_device(device)
  search = config.search
  dirichlet_fraction = 0.0 if eval_mode else search.dirichlet_fraction
  if search.policy == "stochastic":
    run = _stochastic_policy(networks, config, discount, dirichlet_fraction)
  elif search.policy in ("muzero", "gumbel"):
    run = _triplet_policy(networks, config, discount, dirichlet_fraction)
  else:
    raise ValueError(f"unknown search policy {search.policy!r}")

  @torch.no_grad()
  def policy_fn(params, generator: torch.Generator, obs: torch.Tensor,
                temperature, invalid_actions=None):
    if obs.device != device:
      raise ValueError(f"obs lies on {obs.device}, the policy on {device}")
    return run(params, generator, obs, temperature, invalid_actions)

  return policy_fn


def make_rollout_fn(networks: MZNetworks, env: AutoResetWrapper,
                    config: MuZeroConfig, device="cuda"):
  """Build rollout(params, env_carry, generator, temperature) ->
  (env_carry, segments [B, T, ...], step_priorities [B, T], metrics).

  Steps are written into preallocated [T, B, ...] tensors. At segment end
  come the n-step targets Rn (bootstrapped from the stored search values)
  and the priorities |v - Rn|^alpha + 1e-6. On an env with legal actions,
  each step searches under the mask of the states it acts in.
  """
  device = resolve_device(device)
  policy_fn = make_policy_fn(networks, config, config.train.discount,
                             device=device)
  tcfg = config.train
  num_actions = env.spec.num_actions

  @torch.no_grad()
  def rollout(params: MZParams, carry: AutoResetState,
              generator: torch.Generator, temperature):
    T = tcfg.collect_steps
    B = carry.obs.shape[0]
    obs = torch.empty((T,) + tuple(carry.obs.shape), dtype=carry.obs.dtype,
                      device=device)
    action = torch.empty((T, B), dtype=torch.int32, device=device)
    reward = torch.empty((T, B), dtype=torch.float32, device=device)
    done = torch.empty((T, B), dtype=torch.bool, device=device)
    value = torch.empty((T, B), dtype=torch.float32, device=device)
    pi = torch.empty((T, B, num_actions), dtype=torch.float32, device=device)
    episode_return = torch.empty((T, B), dtype=torch.float32, device=device)

    for t in range(T):
      obs[t] = carry.obs
      legal = env.legal_action_mask(carry)
      invalid = None if legal is None else 1.0 - legal
      action[t], pi[t], value[t] = policy_fn(params, generator, carry.obs,
                                             temperature, invalid)
      carry, reward[t], done[t], info = env.step(carry, action[t], generator)
      episode_return[t] = info["episode_return"]

    rn = segment_n_step_returns(reward, value, done.to(torch.float32),
                                tcfg.discount, tcfg.n_bootstrap,
                                tcfg.bootstrap_lambda)
    priorities = torch.abs(value - rn) ** config.replay.priority_alpha

    def to_bt(x):  # [T, B, ...] -> [B, T, ...]
      return x.transpose(0, 1).contiguous()

    segments = Transition(
        obs=to_bt(obs),
        action=to_bt(action),
        reward=to_bt(reward),
        done=to_bt(done),
        rn=to_bt(rn),
        value=to_bt(value),
        pi=to_bt(pi),
        weight=torch.ones((B,), dtype=torch.float32, device=device),
        mask=torch.ones((B, T), dtype=torch.float32, device=device),
    )
    num_episodes = torch.sum(done)
    metrics = {
        "episodes_finished": num_episodes,
        # Mean return over episodes that finished in this segment.
        "mean_episode_return": torch.sum(
            torch.where(done, episode_return, torch.zeros_like(
                episode_return))) / torch.clamp(num_episodes, min=1),
        "mean_root_value": torch.mean(value),
    }
    return carry, segments, to_bt(priorities) + 1e-6, metrics

  return rollout
