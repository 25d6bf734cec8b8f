"""The vectorized actor: {search -> env.step -> write} over T steps of B envs
(``muax_tpu/train/actor.py``).

Self-play searches with MuZero or Gumbel MuZero. With ``search.fused`` (the
default) the MLP triplet and the acme categorical family go through the
fused search: on the card its CUDA kernel (the categorical family in the
kernel's categorical modes), on the CPU its plain version. With
``search.fused=False``, and for a family the kernel does not take (the
fc-resnet, as in the JAX package), it goes through the generic engine
(``search/core.py``) on whichever device the caller chose; that route is
picked from the configuration and the family, never as a fallback after a
failure. Paths of the JAX
actor that the port does not have yet raise ``NotImplementedError`` naming
the ROADMAP item that brings them.
"""
from __future__ import annotations

import torch

from muax_tpu_torch.config import MuZeroConfig
from muax_tpu_torch.device import resolve_device
from muax_tpu_torch.envs.base import AutoResetState, AutoResetWrapper
from muax_tpu_torch.models.networks import MZNetworks, MZParams
from muax_tpu_torch.ops import segment_n_step_returns
from muax_tpu_torch.search.fused import (extract_search_weights,
                                         fused_mlp_gumbel_policy,
                                         fused_mlp_muzero_policy)
from muax_tpu_torch.search.policies import (gumbel_muzero_policy,
                                            muzero_policy)
from muax_tpu_torch.train.inference import make_recurrent_fn, make_root_fn
from muax_tpu_torch.types import Transition

_NOT_PORTED = {
    "stochastic": "Stochastic MuZero is not ported yet (ROADMAP.md A.4)",
    "legal": ("legal-action masks come with the board environments "
              "(ROADMAP.md A.7)"),
}


def uses_fused_search(networks, config: MuZeroConfig) -> bool:
  """Whether ``make_policy_fn`` takes the fused search: ``search.fused`` and
  a family with a kernel (the MLP triplet, the categorical LayerNormMLP)."""
  if not config.search.fused:
    return False
  return isinstance(networks, MZNetworks) or (
      getattr(networks, "family", None) == "mlp"
      and bool(networks.layer_sizes))


def make_policy_fn(networks: MZNetworks, config: MuZeroConfig,
                   discount: float, eval_mode: bool = False, device="cuda"):
  """(params, generator, obs, temperature, invalid_actions=None) ->
  (action [B] int32, pi [B, A], root_value [B]).

  ``eval_mode`` disables the Dirichlet exploration noise on the MuZero root
  prior. ``obs`` must lie on ``device``; ``generator`` on the same device.
  """
  device = resolve_device(device)
  search = config.search
  if search.policy not in ("muzero", "gumbel"):
    raise NotImplementedError(_NOT_PORTED.get(
        search.policy, f"unknown search policy {search.policy!r}"))
  dirichlet_fraction = 0.0 if eval_mode else search.dirichlet_fraction
  root_fn = make_root_fn(networks)
  recurrent_fn = make_recurrent_fn(networks, discount)

  def fused(params, generator, root, temperature):
    weights = extract_search_weights(networks, params)
    common = dict(num_simulations=search.num_simulations,
                  support_size=getattr(networks, "support_size", None),
                  discount=discount, max_depth=search.max_depth)
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

  def generic(params, generator, root, temperature):
    common = dict(num_simulations=search.num_simulations,
                  max_depth=search.max_depth)
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

  run = fused if uses_fused_search(networks, config) else generic

  @torch.no_grad()
  def policy_fn(params: MZParams, generator: torch.Generator,
                obs: torch.Tensor, temperature, invalid_actions=None):
    if invalid_actions is not None:
      raise NotImplementedError(_NOT_PORTED["legal"])
    if obs.device != device:
      raise ValueError(f"obs lies on {obs.device}, the policy on {device}")
    return run(params, generator, root_fn(params, obs), temperature)

  return policy_fn


def make_rollout_fn(networks: MZNetworks, env: AutoResetWrapper,
                    config: MuZeroConfig, device="cuda"):
  """Build rollout(params, env_carry, generator, temperature) ->
  (env_carry, segments [B, T, ...], step_priorities [B, T], metrics).

  Steps are written into preallocated [T, B, ...] tensors. At segment end
  come the n-step targets Rn (bootstrapped from the stored search values)
  and the priorities |v - Rn|^alpha + 1e-6.
  """
  if hasattr(env.env, "legal_actions"):
    raise NotImplementedError(_NOT_PORTED["legal"])
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
      action[t], pi[t], value[t] = policy_fn(params, generator, carry.obs,
                                             temperature)
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
