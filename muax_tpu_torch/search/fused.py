"""Fused search: every simulation of every environment as one kernel.

The port of ``muax_tpu/search/fused.py`` for the MLP triplet and the acme
categorical family (``FusedNetSpec``: LayerNorm-tanh first layers and a
linear [vmin, vmax] two-hot decode), each in two policy modes: MuZero PUCT
and Gumbel MuZero. On a CUDA tensor,
``fused_muzero_search`` and ``fused_gumbel_search`` launch the hand-written
kernel ``csrc/fused_search.cu`` (built at first use by ``_build.py``); on a
CPU tensor they run ``fused_muzero_search_reference`` and
``fused_gumbel_search_reference``, the plain PyTorch versions of the same
functions, which the tests hold against the JAX package and the card holds
the kernel against. There is no other route.

Semantics are the JAX kernel's (and, up to tie-breaking, the generic
engine's ``policies.muzero_policy`` and ``gumbel_muzero_policy``). MuZero:
PUCT with the parent-and-siblings qtransform, invalid actions masked at
depth 0. Gumbel: a sequential-halving root step over g + logits + sigma(q)
among the actions whose visits equal the row's schedule, the improved-policy
interior softmax(log prior + sigma(q)) - n / (1 + sum n), both under
``completed_by_mix_value`` (which reads each node's raw network value), and
the completed root q as the third output. Both: ties to the lowest action,
descent capped at ``max_depth`` with in-place re-evaluation of an existing
child, h-support (MLP) or linear two-hot (categorical) decode, min-max
normalized next states, running-mean
install and backup. The backup starts from the raw network value of the
expanded node, as the JAX kernel's does.

Stochastic MuZero has its own kernel, ``csrc/fused_smz.cu``, behind
``fused_smz_search`` (plain version ``fused_smz_search_reference``) and
``fused_smz_policy``; its semantics are set out at the section's head below.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from muax_tpu_torch import _build
from muax_tpu_torch.device import DeviceLimits, device_limits
from muax_tpu_torch.models.acme_networks import LN_EPS, CategoricalMZNetworks
from muax_tpu_torch.models.networks import MZNetworks, MZParams
from muax_tpu_torch.models.stochastic_networks import SMZNetworks, SMZParams
from muax_tpu_torch.ops import inv_value_transform
from muax_tpu_torch.replay.buffer import gumbel_noise
from muax_tpu_torch.search import seq_halving
from muax_tpu_torch.search.policies import (_add_dirichlet_noise,
                                            _apply_temperature,
                                            _get_logits_from_probs,
                                            _mask_invalid)

_NEG = -1e30
# completed_by_mix_value's defaults (muax_tpu/search/qtransforms.py:58-59).
_VALUE_SCALE, _MAXVISIT_INIT = 0.1, 50.0

# Launches of the CUDA kernel, by mode; the plain version does not count.
launches = 0                     # MLP triplet, policy="muzero"
gumbel_launches = 0              # MLP triplet, policy="gumbel"
# Of those, the launches of the wide-tower kernel (fused_search_wide_kernel).
wide_launches = 0                # policy="muzero"
wide_gumbel_launches = 0         # policy="gumbel"
categorical_launches = 0         # categorical family, policy="muzero"
categorical_gumbel_launches = 0  # categorical family, policy="gumbel"
smz_launches = 0                 # Stochastic MuZero forest (csrc/fused_smz.cu)
# Of those, the launches of its wide-tower kernel (fused_smz_wide_kernel).
smz_wide_launches = 0

Linear = Tuple[torch.Tensor, torch.Tensor]  # (W [in, out], b [out])


class FusedMLPWeights(NamedTuple):
  """The dynamics and prediction towers as (W [in, out], b [out]) pairs."""
  dyn_hidden: Tuple[Linear, ...]  # first W has in_dim = E + A
  dyn_reward: Linear              # W [H, 2S+1]
  dyn_state: Linear               # W [H, E]
  pred_hidden: Tuple[Linear, ...]
  pred_value: Linear              # W [H, 2S+1]
  pred_policy: Linear             # W [H, A]

  def layers(self):
    """Every linear in the kernel's order."""
    return (*self.dyn_hidden, self.dyn_reward, self.dyn_state,
            *self.pred_hidden, self.pred_value, self.pred_policy)

  def flat(self) -> torch.Tensor:
    """One contiguous f32 buffer: W then b for each linear of ``layers``."""
    return torch.cat([t.reshape(-1) for pair in self.layers() for t in pair])


def extract_fused_weights(networks: MZNetworks,
                          params: MZParams) -> FusedMLPWeights:
  """The towers of ``params`` in the kernel's layout (detached)."""
  def pair(layer):
    return (layer.weight.detach().t().contiguous(), layer.bias.detach())

  *d_hidden, d_reward, d_state = [pair(l) for l in params.dynamic.linears()]
  *p_hidden, p_value, p_policy = [pair(l) for l in params.prediction.linears()]
  return FusedMLPWeights(
      dyn_hidden=tuple(d_hidden), dyn_reward=d_reward, dyn_state=d_state,
      pred_hidden=tuple(p_hidden), pred_value=p_value, pred_policy=p_policy)


class FusedNetSpec(NamedTuple):
  """The towers as a layer program (``muax_tpu/search/fused.py``
  ``FusedNetSpec``). ``dyn_layers`` / ``pred_layers``: tuples of
  ("elu", (W [in, out], b)) or ("ln_tanh", (W, b, scale, offset)) hidden
  layers; the heads are (W, b) pairs. ``decode``: "h_support" (integer
  h-transform two-hot over 2S+1 bins) or "linear" (``num_bins`` bins over
  [vmin, vmax])."""
  dyn_layers: tuple
  pred_layers: tuple
  dyn_reward: Linear
  dyn_state: Linear
  pred_value: Linear
  pred_policy: Linear
  decode: str
  num_bins: int
  support_size: int
  vmin: float
  vmax: float

  def flat(self) -> torch.Tensor:
    """One contiguous f32 buffer, the kernel's: per hidden layer W, b (and
    scale, offset for ln_tanh), then the heads; dynamics first (reward,
    next state), then prediction (value, policy)."""
    parts = [t for _, ts in self.dyn_layers for t in ts]
    parts += [*self.dyn_reward, *self.dyn_state]
    parts += [t for _, ts in self.pred_layers for t in ts]
    parts += [*self.pred_value, *self.pred_policy]
    return torch.cat([t.reshape(-1) for t in parts])


def _mlp_weights_to_spec(weights: FusedMLPWeights,
                         support_size: int) -> FusedNetSpec:
  return FusedNetSpec(
      dyn_layers=tuple(("elu", pair) for pair in weights.dyn_hidden),
      pred_layers=tuple(("elu", pair) for pair in weights.pred_hidden),
      dyn_reward=weights.dyn_reward, dyn_state=weights.dyn_state,
      pred_value=weights.pred_value, pred_policy=weights.pred_policy,
      decode="h_support", num_bins=2 * support_size + 1,
      support_size=support_size, vmin=0.0, vmax=0.0)


def extract_categorical_fused_weights(networks,
                                      params: MZParams
                                      ) -> Optional[FusedNetSpec]:
  """The ``FusedNetSpec`` of the acme categorical family (LayerNormMLP
  towers, linear two-hot heads), detached; None for any other family (the
  fc-resnet's residual towers have no kernel)."""
  if not isinstance(networks, CategoricalMZNetworks) or (
      networks.family != "mlp" or not networks.layer_sizes):
    return None

  def pair(layer):
    return (layer.weight.detach().t().contiguous(), layer.bias.detach())

  def program(tower):
    out = []
    for kind, mods in tower.hidden():
      ts = pair(mods[0])
      if kind == "ln_tanh":
        ts += (mods[1].weight.detach(), mods[1].bias.detach())
      out.append((kind, ts))
    return tuple(out)

  reward, state = params.dynamic.tower.heads()
  policy, value = params.prediction.tower.heads()
  return FusedNetSpec(
      dyn_layers=program(params.dynamic.tower),
      pred_layers=program(params.prediction.tower),
      dyn_reward=pair(reward), dyn_state=pair(state),
      pred_value=pair(value), pred_policy=pair(policy),
      decode="linear", num_bins=networks.num_bins, support_size=0,
      vmin=networks.vmin, vmax=networks.vmax)


def extract_search_weights(networks, params: MZParams):
  """The kernel's weights for ``networks``: ``FusedMLPWeights`` for the MLP
  triplet, a ``FusedNetSpec`` for the categorical family, else None."""
  if isinstance(networks, MZNetworks):
    return extract_fused_weights(networks, params)
  return extract_categorical_fused_weights(networks, params)


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _decode(logits: torch.Tensor, spec: FusedNetSpec) -> torch.Tensor:
  """[B, bins] logits -> softmax expectation over the bins: -S..S then h^-1
  ("h_support"), or vmin + j (vmax - vmin) / (bins - 1) ("linear")."""
  probs = torch.softmax(logits, dim=-1)
  idx = torch.arange(spec.num_bins, dtype=logits.dtype, device=logits.device)
  if spec.decode == "linear":
    bins = spec.vmin + idx * ((spec.vmax - spec.vmin) / (spec.num_bins - 1))
    return torch.sum(probs * bins, dim=-1)
  return inv_value_transform(
      torch.sum(probs * (idx - spec.support_size), dim=-1))


def _elu(x: torch.Tensor) -> torch.Tensor:
  return torch.where(x > 0, x, torch.exp(x) - 1.0)


def _completed_q(cur, rows, nraw, cvis, cpri, crew, cval, discount):
  """qtransform_completed_by_mix_value over node ``cur`` [B] of the fused
  tree (probabilities stored, not logits). Returns (sigma(q-hat) [B, A], the
  children's visits [B, A], their sum [B, 1])."""
  cv = cvis[rows, cur]
  q = crew[rows, cur] + discount * cval[rows, cur]
  visited = cv > 0
  sum_visits = cv.sum(-1, keepdim=True)
  visited_probs = torch.where(visited, cpri[rows, cur], torch.zeros_like(q))
  sum_probs = visited_probs.sum(-1, keepdim=True)
  weighted_q = (visited_probs * q).sum(-1, keepdim=True) / torch.clamp(
      sum_probs, min=1e-8)
  v_mix = (nraw[rows, cur][:, None] + sum_visits * weighted_q) / (
      sum_visits + 1.0)
  completed = torch.where(visited, q, v_mix)
  low = completed.amin(-1, keepdim=True)
  high = completed.amax(-1, keepdim=True)
  completed = (completed - low) / torch.clamp(high - low, min=1e-8)
  maxvisit = cv.amax(-1, keepdim=True)
  return (_MAXVISIT_INIT + maxvisit) * _VALUE_SCALE * completed, cv, sum_visits


def _as_spec(weights, support_size) -> FusedNetSpec:
  if isinstance(weights, FusedNetSpec):
    return weights
  if support_size is None:
    raise ValueError("support_size is required with FusedMLPWeights")
  return _mlp_weights_to_spec(weights, support_size)


class PlainForest(NamedTuple):
  """The plain version's trees after the search, [B, N] node and [B, N, A]
  edge arrays: node visits, values, raw network values, the reward written
  at each install of the node, parents, actions; edge children, priors,
  visits, rewards, values; the embeddings [B, N, E]."""
  nvis: torch.Tensor
  nval: torch.Tensor
  nraw: torch.Tensor
  nrew: torch.Tensor
  npar: torch.Tensor
  nact: torch.Tensor
  cidx: torch.Tensor
  cpri: torch.Tensor
  cvis: torch.Tensor
  crew: torch.Tensor
  cval: torch.Tensor
  embs: torch.Tensor


def _plain_search(root_embedding, root_prior_logits, root_value,
                  spec: FusedNetSpec, *, num_simulations, discount,
                  invalid_actions, max_depth, pb_c_init=1.25,
                  pb_c_base=19652.0, root_score=None, schedule=None):
  """Every mode of the plain version: the root summaries of
  ``_plain_forest``'s trees. ``root_score`` and ``schedule`` select the
  Gumbel mode."""
  f = _plain_forest(root_embedding, root_prior_logits, root_value, spec,
                    num_simulations=num_simulations, discount=discount,
                    invalid_actions=invalid_actions, max_depth=max_depth,
                    pb_c_init=pb_c_init, pb_c_base=pb_c_base,
                    root_score=root_score, schedule=schedule)
  if root_score is not None:
    root = torch.zeros(f.nvis.shape[0], dtype=torch.long,
                       device=f.nvis.device)
    root_q, _, _ = _completed_q(root, torch.arange(f.nvis.shape[0],
                                                   device=f.nvis.device),
                                f.nraw, f.cvis, f.cpri, f.crew, f.cval,
                                discount)
  else:
    root_q = f.crew[:, 0] + discount * f.cval[:, 0]
  return f.cvis[:, 0], f.nval[:, 0], root_q


def _plain_forest(root_embedding, root_prior_logits, root_value,
                  spec: FusedNetSpec, *, num_simulations, discount,
                  invalid_actions, max_depth, pb_c_init=1.25,
                  pb_c_base=19652.0, root_score=None, schedule=None
                  ) -> PlainForest:
  """The plain search, batched over [B, N] and [B, N, A] tensors with a
  lockstep descent; returns the final trees."""
  gumbel = root_score is not None
  B, E = root_embedding.shape
  A = root_prior_logits.shape[-1]
  N = num_simulations + 1
  if max_depth is None:
    max_depth = num_simulations
  dev = root_embedding.device
  # f32 on every route of the port; f64 roots (an exact reference for
  # checks) keep their precision.
  dt = (torch.float64 if root_embedding.dtype == torch.float64
        else torch.float32)
  rows = torch.arange(B, device=dev)
  invalid = (torch.zeros(B, A, dtype=dt, device=dev)
             if invalid_actions is None else invalid_actions.to(dt))

  nvis = torch.zeros(B, N, dtype=dt, device=dev)
  nvis[:, 0] = 1.0
  nval = torch.zeros(B, N, dtype=dt, device=dev)
  nval[:, 0] = root_value.to(dt)
  nraw = nval.clone()
  nrew = torch.zeros(B, N, dtype=dt, device=dev)
  npar = torch.full((B, N), -1, dtype=torch.long, device=dev)
  nact = torch.full((B, N), -1, dtype=torch.long, device=dev)
  cidx = torch.full((B, N, A), -1, dtype=torch.long, device=dev)
  cpri = torch.zeros(B, N, A, dtype=dt, device=dev)
  cpri[:, 0] = torch.softmax(root_prior_logits.to(dt), dim=-1)
  cvis = torch.zeros(B, N, A, dtype=dt, device=dev)
  crew = torch.zeros(B, N, A, dtype=dt, device=dev)
  cval = torch.zeros(B, N, A, dtype=dt, device=dev)
  embs = torch.zeros(B, N, E, dtype=dt, device=dev)
  embs[:, 0] = root_embedding.to(dt)

  def completed_q(cur):
    return _completed_q(cur, rows, nraw, cvis, cpri, crew, cval, discount)

  def puct(cur: torch.Tensor, depth: int) -> torch.Tensor:
    nvisit = nvis[rows, cur][:, None]
    nvalue = nval[rows, cur][:, None]
    cv = cvis[rows, cur]
    q = crew[rows, cur] + discount * cval[rows, cur]
    visited = cv > 0
    safe_q = torch.where(visited, q, nvalue)
    minv = torch.minimum(nvalue, safe_q.amin(-1, keepdim=True))
    maxv = torch.maximum(nvalue, safe_q.amax(-1, keepdim=True))
    completed = torch.where(visited, q, minv)
    qn = (completed - minv) / torch.clamp(maxv - minv, min=1e-8)
    pb_c = pb_c_init + torch.log((nvisit + pb_c_base + 1.0) / pb_c_base)
    score = qn + (torch.sqrt(nvisit) * pb_c) * cpri[rows, cur] / (cv + 1.0)
    if depth == 0:
      score = torch.where(invalid > 0, torch.full_like(score, _NEG), score)
    return score

  def gumbel_root(s: int) -> torch.Tensor:
    """Sequential halving: among the actions whose visits equal the
    schedule, g + logits + sigma(q-hat); invalid actions masked (finite)."""
    cq, cv, _ = completed_q(torch.zeros_like(rows))
    score = torch.where(cv == schedule[:, s:s + 1], root_score + cq,
                        torch.full_like(cq, _NEG))
    return torch.where(invalid > 0, torch.full_like(score, _NEG), score)

  def gumbel_interior(cur: torch.Tensor) -> torch.Tensor:
    """Improved-policy tracking softmax(log prior + sigma(q-hat)) -
    n / (1 + sum n)."""
    cq, cv, sum_visits = completed_q(cur)
    logp = torch.log(torch.clamp(cpri[rows, cur], min=1e-30)) + cq
    e = torch.exp(logp - logp.amax(-1, keepdim=True))
    probs = e / torch.clamp(e.sum(-1, keepdim=True), min=1e-30)
    return probs - cv / (1.0 + sum_visits)

  def tower(x, layers):
    for kind, ts in layers:
      h = x @ ts[0] + ts[1]
      if kind == "elu":
        x = _elu(h)
      else:  # ln_tanh: Linear -> LayerNorm -> tanh
        mean = h.mean(-1, keepdim=True)
        var = torch.square(h - mean).mean(-1, keepdim=True)
        x = torch.tanh((h - mean) * torch.rsqrt(var + LN_EPS) * ts[2]
                       + ts[3])
    return x

  for s in range(num_simulations):
    # Descent; envs that stopped keep their (parent, action, cur). In the
    # Gumbel mode depth 0 is the sequential-halving root step.
    cur = torch.zeros(B, dtype=torch.long, device=dev)
    parent = torch.full((B,), -1, dtype=torch.long, device=dev)
    act = torch.full((B,), -1, dtype=torch.long, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    depth = 0
    while bool(active.any()):
      at = cur.clamp(min=0)
      if not gumbel:
        score = puct(at, depth)
      elif depth == 0:
        score = gumbel_root(s)
      else:
        score = gumbel_interior(at)
      a = torch.argmax(score, dim=-1)  # first maximum
      child = cidx[rows, at, a]
      parent = torch.where(active, at, parent)
      act = torch.where(active, a, act)
      cur = torch.where(active, child, cur)
      depth += 1
      active = active & (child >= 0) & (depth < max_depth)

    existing = cidx[rows, parent, act]
    slot = torch.where(existing < 0, torch.full_like(existing, s + 1),
                       existing)

    # Expansion.
    x = torch.cat([embs[rows, parent], F.one_hot(act, A).to(dt)], -1)
    h = tower(x, spec.dyn_layers)
    reward = _decode(h @ spec.dyn_reward[0] + spec.dyn_reward[1], spec)
    ns = h @ spec.dyn_state[0] + spec.dyn_state[1]
    ns_min = ns.amin(-1, keepdim=True)
    ns_max = ns.amax(-1, keepdim=True)
    ns = (ns - ns_min) / torch.clamp(ns_max - ns_min, min=1e-8)
    g = tower(ns, spec.pred_layers)
    value = _decode(g @ spec.pred_value[0] + spec.pred_value[1], spec)
    pol = torch.softmax(g @ spec.pred_policy[0] + spec.pred_policy[1],
                        dim=-1)

    # Install (running mean; a re-evaluated node's raw value is replaced).
    count = nvis[rows, slot]
    nval[rows, slot] = (nval[rows, slot] * count + value) / (count + 1.0)
    nvis[rows, slot] = count + 1.0
    nraw[rows, slot] = value
    nrew[rows, slot] = reward
    npar[rows, slot] = parent
    nact[rows, slot] = act
    cpri[rows, slot] = pol
    embs[rows, slot] = ns
    crew[rows, parent, act] = reward
    cidx[rows, parent, act] = slot

    # Backup from the raw value; envs at the root write back what they read.
    idx = slot
    v = value
    while bool((idx != 0).any()):
      on = idx != 0
      par = npar[rows, idx].clamp(min=0)
      a_b = nact[rows, idx].clamp(min=0)
      cnt = nvis[rows, par]
      vnew = crew[rows, par, a_b] + discount * v
      child_val = nval[rows, idx]
      nval[rows, par] = torch.where(
          on, (nval[rows, par] * cnt + vnew) / (cnt + 1.0), nval[rows, par])
      nvis[rows, par] = torch.where(on, cnt + 1.0, cnt)
      cval[rows, par, a_b] = torch.where(on, child_val, cval[rows, par, a_b])
      cvis[rows, par, a_b] = cvis[rows, par, a_b] + on.to(dt)
      v = torch.where(on, vnew, v)
      idx = torch.where(on, par, idx)

  return PlainForest(nvis, nval, nraw, nrew, npar, nact, cidx, cpri, cvis,
                     crew, cval, embs)


def fused_muzero_search_reference(
    root_embedding: torch.Tensor,      # [B, E]
    root_prior_logits: torch.Tensor,   # [B, A] (noise/masking applied)
    root_value: torch.Tensor,          # [B]
    weights,                           # FusedMLPWeights or FusedNetSpec
    *,
    num_simulations: int,
    discount: float,
    support_size: Optional[int] = None,
    invalid_actions: Optional[torch.Tensor] = None,
    max_depth: Optional[int] = None,
    pb_c_init: float = 1.25,
    pb_c_base: float = 19652.0,
):
  """Plain PyTorch version of the fused MuZero search. Returns
  (visit_counts [B, A], root_value [B], root_qvalues [B, A]), all f32.
  ``support_size`` is needed with ``FusedMLPWeights`` only."""
  return _plain_search(root_embedding, root_prior_logits, root_value,
                       _as_spec(weights, support_size),
                       num_simulations=num_simulations, discount=discount,
                       invalid_actions=invalid_actions, max_depth=max_depth,
                       pb_c_init=pb_c_init, pb_c_base=pb_c_base)


def fused_gumbel_search_reference(
    root_embedding: torch.Tensor,      # [B, E]
    root_prior_logits: torch.Tensor,   # [B, A] masked logits, no noise
    root_value: torch.Tensor,          # [B]
    weights,                           # FusedMLPWeights or FusedNetSpec
    *,
    root_score: torch.Tensor,          # [B, A] gumbel + masked logits
    schedule: torch.Tensor,            # [B, num_simulations] f32 visits
    num_simulations: int,
    discount: float,
    support_size: Optional[int] = None,
    invalid_actions: Optional[torch.Tensor] = None,
    max_depth: Optional[int] = None,
):
  """Plain PyTorch version of the fused Gumbel MuZero search (the kernel's
  inputs: ``gumbel_root_inputs`` makes ``root_score`` and ``schedule``).
  Returns (visit_counts [B, A], root_value [B], root_completed_q [B, A])."""
  return _plain_search(root_embedding, root_prior_logits, root_value,
                       _as_spec(weights, support_size),
                       num_simulations=num_simulations, discount=discount,
                       invalid_actions=invalid_actions, max_depth=max_depth,
                       root_score=root_score, schedule=schedule)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


def _load_kernel():
  lib = _build.load("fused_search")
  if lib.mz_fused_muzero_search.argtypes is None:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [i32, ptr, i32, ptr, i32, ptr]  # towers, device, stream
    # emb scratch, G, envs, embeddings' place
    plan = [ptr, ctypes.c_long, i32, i32, i32]
    lib.mz_fused_muzero_search.argtypes = [
        ptr, ptr, ptr, ptr, ptr, i32, *plan, ptr, ptr, ptr,
        i32, i32, i32, i32, i32, i32, i32, f32, f32, f32] + tail
    lib.mz_fused_gumbel_search.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, *plan, ptr, ptr, ptr,
        i32, i32, i32, i32, i32, i32, i32, f32] + tail
    lib.mz_fused_tiled_search.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, ptr, ctypes.c_long, i32, i32,
        i32, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, f32, f32,
        i32, i32, f32, f32, f32,
        i32, ptr, ptr, i32, ptr, ptr, i32, ptr]
    lib.mz_mlp_blocks_per_sm.argtypes = [i32, i32, i32, ctypes.c_long, i32,
                                         ptr]
    lib.mz_fused_wide_search.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ctypes.c_long, ptr,
        ctypes.c_long, i32, i32, i32, i32, i32, ptr, ptr, ptr,
        i32, i32, i32, i32, i32, i32, i32, f32, f32, f32] + tail
    lib.mz_wide_layout.argtypes = [i32, i32, i32, i32, i32, i32, ptr, i32,
                                   ptr, i32, i32, i32, i32, i32, ptr]
    lib.mz_wide_active_clusters.argtypes = [i32, i32, i32, ctypes.c_long,
                                            i32, ptr]
    for fn in (lib.mz_fused_muzero_search, lib.mz_fused_gumbel_search,
               lib.mz_fused_tiled_search, lib.mz_mlp_blocks_per_sm,
               lib.mz_fused_wide_search, lib.mz_wide_layout,
               lib.mz_wide_active_clusters):
      fn.restype = i32
    lib.mz_error_string.argtypes = [i32]
    lib.mz_error_string.restype = ctypes.c_char_p
  return lib


# The categorical modes' launch (``kTileEnvs`` in csrc/fused_search.cu): a
# tile of 16 environments per cluster of blocks, each block walking its
# share of the tile's trees and computing its share of every layer's
# columns.
TILE_ENVS = 16
# Blocks of the categorical kernel an SM can hold at most: its
# ``__launch_bounds__(256, 2)``.
_TILED_BLOCKS_PER_SM = 2


class TiledPlan(NamedTuple):
  """How a categorical-mode launch runs: ``cluster`` blocks per tile of
  ``TILE_ENVS`` envs, and the trees' node and edge arrays in shared memory
  (``smem_trees``) or in the device scratch."""
  cluster: int
  smem_trees: bool


def _padded_row(n: int) -> int:
  # Rows 4 floats longer than a multiple of 32 (``row`` in the kernel).
  return -(-n // 32) * 32 + 4


def tiled_tree_floats(num_actions: int, num_simulations: int) -> int:
  """Floats of one tree's node and edge arrays: 5 N + 5 N A."""
  n = num_simulations + 1
  return 5 * n + 5 * n * num_actions


def tiled_smem_bytes(cluster: int, smem_trees: bool, num_actions: int,
                     embedding_dim: int, num_simulations: int,
                     widths) -> int:
  """Shared memory of one block (the kernel's ``launch_tiled``): four
  activation buffers of the tile's rows, and per env of the block its
  invalid mask, four slots and, with ``smem_trees``, its tree. ``widths``:
  the bins and every hidden layer's width."""
  A, E = num_actions, embedding_dim
  rows = (2 * _padded_row(max(widths)) + _padded_row(E + A)
          + _padded_row(max(E, A)))
  tree = tiled_tree_floats(A, num_simulations) if smem_trees else 0
  return 4 * (TILE_ENVS * rows + TILE_ENVS // cluster * (tree + A + 4))


def tiled_plan(batch: int, num_actions: int, embedding_dim: int,
               num_simulations: int, widths,
               limits: DeviceLimits) -> TiledPlan:
  """Four blocks per tile while the card keeps them all resident at once,
  else two (with four, a launch over 2048 envs at the bench widths would
  run in two waves of blocks; ``tools/kernel_split.py`` times both); the
  trees in shared memory where they fit a block, else in the device
  scratch. Raises ValueError when even the activation rows do not fit."""

  def size(cluster, smem_trees):
    return tiled_smem_bytes(cluster, smem_trees, num_actions, embedding_dim,
                            num_simulations, widths)

  def place(cluster):
    plan = TiledPlan(cluster, size(cluster, True) <= limits.smem_per_block)
    return plan if size(*plan) <= limits.smem_per_block else None

  four, two = place(4), place(2)  # two needs at least what four does
  if four is None:
    raise ValueError("the categorical search's activation rows do not fit "
                     "a block's shared memory")
  per_sm = min(_TILED_BLOCKS_PER_SM,
               limits.smem_per_sm // (size(*four) + limits.smem_reserved))
  if two is None or -(-batch // TILE_ENVS) * 4 <= per_sm * limits.sms:
    return four
  return two


def tiled_grid(batch: int, cluster: int) -> int:
  """Blocks of a categorical-mode launch over ``batch`` environments."""
  return -(-batch // TILE_ENVS) * cluster


def tiled_scratch_floats(batch: int, num_actions: int, embedding_dim: int,
                         num_simulations: int, smem_trees: bool) -> int:
  """Floats of device scratch of a categorical-mode launch: the embeddings
  of every environment's N = num_simulations + 1 nodes and, unless the
  trees stay in shared memory, their node and edge arrays."""
  emb = batch * (num_simulations + 1) * embedding_dim
  if smem_trees:
    return emb
  return emb + batch * tiled_tree_floats(num_actions, num_simulations)


# The MLP modes' launch (``fused_search_kernel<policy, G>``): a group of G
# lanes per environment, blocks of at most 256 threads and at most 64
# registers a thread at G = 32, 128 at G = 4 (its ``__launch_bounds__(256,
# 4)`` and ``(256, 2)``), and an SM holds at most 32 blocks and 2048
# threads. G = 4 gives eight environments a warp,
# every lane busy in the towers; G = 32 a warp per environment, for batches
# too small to fill the card otherwise and for trees too large to keep many
# at once (``tools/kernel_split.py`` times both at 8192 and 1024 envs).
MLP_GROUPS = (4, 32)
MLP_BLOCK_THREADS = 256
_MLP_REGISTERS = {4: 128, 32: 64}  # per thread, by G
_SM_BLOCKS, _SM_THREADS = 32, 2048
# Warps per SM that the plan aims for to hide each environment's chain of
# dependent steps behind others' (past eight warps an SM the smaller G wins,
# by issuing fewer instructions per environment).
MLP_TARGET_WARPS = 8


class MLPPlan(NamedTuple):
  """How an MLP-mode launch with the towers staged in each block's shared
  memory runs: ``group`` lanes per environment, ``envs_per_block``
  environments a block, the embeddings in shared memory (``smem_emb``) or
  in a device scratch; ``grid`` blocks, of which an SM holds
  ``blocks_per_sm`` at once, ``warps_per_sm`` on the busiest SM, and
  whether every block is resident in one wave."""
  group: int
  envs_per_block: int
  smem_emb: bool
  grid: int
  blocks_per_sm: int
  warps_per_sm: int
  resident: bool


def mlp_act_width(num_actions: int, embedding_dim: int, widths) -> int:
  """Floats of one activation buffer: the state, a hidden layer, a head's
  bins, the next state or the Gumbel interior's per-action scores
  (``widths``: the bins and every hidden layer's width)."""
  return max(embedding_dim, num_actions, *widths)


def mlp_env_floats(num_actions: int, embedding_dim: int,
                   num_simulations: int, act_width: int, gumbel: bool,
                   smem_emb: bool) -> int:
  """Floats of shared memory of one environment (the kernel's
  ``make_args``): the compact tree 4 N + 2 N A, two activation buffers, the
  invalid mask; the Gumbel mode's raw values [N] and root score [A]; the
  embeddings [N, E] with ``smem_emb``; rounded up to an odd count."""
  n, A = num_simulations + 1, num_actions
  floats = 4 * n + 2 * n * A + 2 * act_width + A
  if gumbel:
    floats += n + A
  if smem_emb:
    floats += n * embedding_dim
  return floats | 1


def mlp_smem_bytes(n_weights: int, envs_per_block: int, env_floats: int
                   ) -> int:
  """Shared memory of one block: the towers (``n_weights`` floats), then
  each environment's slice."""
  return 4 * (-(-n_weights // 4) * 4 + envs_per_block * env_floats)


def _mlp_candidate(batch, group, smem_emb, env_floats, n_weights,
                   limits: DeviceLimits) -> Optional[MLPPlan]:
  """The launch with G = ``group``: 256 threads a block, halved while the
  block's shared memory does not fit or the grid would leave SMs without
  a block, and while halving lets an SM hold more environments of a
  launch that does not fit the card at once; down to one warp. None when
  one warp's environments do not fit beside the towers."""
  least = max(1, 32 // group)

  def plan(envs):
    size = mlp_smem_bytes(n_weights, envs, env_floats)
    if size > limits.smem_per_block:
      return None
    threads = envs * group
    per_sm = min(_SM_BLOCKS, _SM_THREADS // threads,
                 limits.regs_per_sm // (_MLP_REGISTERS[group] * threads),
                 limits.smem_per_sm // (size + limits.smem_reserved))
    grid = -(-batch // envs)
    busiest = min(per_sm, -(-grid // limits.sms))
    return MLPPlan(group, envs, smem_emb, grid, per_sm,
                   busiest * threads // 32, grid <= per_sm * limits.sms)

  envs = MLP_BLOCK_THREADS // group
  while envs > least and (plan(envs) is None
                          or -(-batch // envs) < limits.sms):
    envs //= 2
  best = plan(envs)
  while best is not None and not best.resident and envs > least:
    envs //= 2
    smaller = plan(envs)
    if (smaller.blocks_per_sm * smaller.envs_per_block
        <= best.blocks_per_sm * best.envs_per_block):
      break
    best = smaller
  return best


def mlp_search_plan(batch: int, num_actions: int, embedding_dim: int,
                    num_simulations: int, n_weights: int, widths,
                    gumbel: bool, limits: DeviceLimits,
                    group: Optional[int] = None, towers=None,
                    clusters: Optional[Callable] = None
                    ) -> Union[MLPPlan, "WidePlan"]:
  """The MLP modes' launch plan. Where some launch stages the towers in
  shared memory beside one warp's environments, an ``MLPPlan``: among the
  launches that keep every environment resident in one wave, the smallest
  G that still gives the busiest SM ``MLP_TARGET_WARPS`` warps (fewer lanes
  per environment waste fewer lanes), else the largest G (the most warps);
  the embeddings in shared memory where that keeps them all resident.
  Where no launch keeps them all, the most environments resident per SM,
  then the largest G. Towers wider than that (the 2048 example's (256,
  256) at 601 bins: 1.97 MB) take the tile kernel: ``wide_search_plan``'s
  ``WidePlan``. ``widths``: the bins and every hidden layer's width;
  ``towers``: (dynamics widths, prediction widths), by default the hidden
  widths of ``widths`` halved between the two; ``group`` fixes G (for
  timing each); ``clusters`` as ``wide_search_plan`` takes it, which the
  wide plan needs. Raises RuntimeError where one environment's tree alone
  does not fit a block's shared memory, as the kernels would. The plan of
  a shape is worked out once and kept."""
  widths = tuple(widths)
  if towers is None:
    half = (len(widths) - 1) // 2
    towers = (widths[1:1 + half], widths[1 + half:])
  towers = (tuple(towers[0]), tuple(towers[1]))
  return _mlp_search_plan(batch, num_actions, embedding_dim,
                          num_simulations, n_weights, widths, gumbel,
                          limits, group, towers, clusters)


@functools.lru_cache(maxsize=None)
def _mlp_search_plan(batch, num_actions, embedding_dim, num_simulations,
                     n_weights, widths, gumbel, limits, group, towers,
                     clusters):
  act_width = mlp_act_width(num_actions, embedding_dim, widths)
  plans = []
  for g in (MLP_GROUPS if group is None else (group,)):
    for smem_emb in (True, False):
      floats = mlp_env_floats(num_actions, embedding_dim, num_simulations,
                              act_width, gumbel, smem_emb)
      plan = _mlp_candidate(batch, g, smem_emb, floats, n_weights, limits)
      if plan is not None:
        plans.append(plan)
  if not plans:
    # The tile kernel takes the towers no block can stage, where one
    # environment's compact tree alone would fit a block (past that, the
    # shapes are refused, as before the tile kernel).
    floats = mlp_env_floats(num_actions, embedding_dim, num_simulations,
                            act_width, gumbel, False)
    if mlp_smem_bytes(0, 1, floats) > limits.smem_per_block:
      raise RuntimeError("fused search kernel: shapes do not fit the fused "
                         "search kernel (one environment's tree exceeds a "
                         "block's shared memory)")
    if clusters is None:
      raise ValueError("the wide plan needs clusters: the card's count of "
                       "clusters it holds at once")
    return wide_search_plan(batch, num_actions, embedding_dim,
                            num_simulations, widths[0], *towers, gumbel,
                            limits, clusters)
  resident = [p for p in plans if p.resident]
  if resident:
    full = [p for p in resident if p.warps_per_sm >= MLP_TARGET_WARPS]
    if full:
      return min(full, key=lambda p: (p.group, not p.smem_emb))
    return max(resident, key=lambda p: (p.group, p.smem_emb))
  return max(plans, key=lambda p: (p.blocks_per_sm * p.envs_per_block,
                                   p.group, p.smem_emb))


def mlp_blocks_per_sm(plan: MLPPlan, n_weights: int, env_floats: int,
                      gumbel: bool, device: torch.device) -> int:
  """Blocks of ``plan`` that one SM of ``device`` holds at once, as the CUDA
  runtime reckons it from the compiled kernel (its registers included)."""
  index = device.index if device.index is not None else (
      torch.cuda.current_device())
  out = ctypes.c_int(0)
  lib = _load_kernel()
  err = lib.mz_mlp_blocks_per_sm(
      int(gumbel), plan.group, plan.envs_per_block * plan.group,
      mlp_smem_bytes(n_weights, plan.envs_per_block, env_floats), index,
      ctypes.byref(out))
  if err != 0:
    raise RuntimeError("fused search kernel: "
                       + lib.mz_error_string(err).decode())
  return out.value


# The wide modes' launch (``fused_search_wide_kernel<policy, tile, cluster,
# ntw>``): a tile of ``tile`` environments on a cluster of ``cluster``
# blocks of 256 threads, each block a ``cluster``-th of every phase's
# columns (a hidden layer; the dynamics' reward and next-state heads side
# by side; the prediction's value and policy heads side by side), at most
# ``ntw`` tiles of 8 columns a warp. The instances the kernel has, in the
# order the plan prefers them: 16 x 16 keeps a small batch's towers
# resident (64 boards), 48 x 4 streams them for a large one (1024).
WIDE_INSTANCES = ((16, 16, 1), (48, 4, 3))
WIDE_THREADS = 256
WIDE_PIECE_ROWS = 32  # rows of a streamed piece of a phase's weights
WIDE_MAX_RING = 8
_WIDE_BARRIER_FLOATS = 64


class WideLayout(NamedTuple):
  """The wide kernel's layout (its ``wide_layout``): per phase its input
  width, rows in the pack (a multiple of 8), output width, columns ``nb``
  of each block, and the offsets of its biases and weights in a rank's
  pack; pieces a simulation, the floats of a rank's pack, of its biases and
  of a ring slot, and a block's shared memory in bytes."""
  ins: tuple
  in8: tuple
  widths: tuple
  nb: tuple
  b_off: tuple
  w_off: tuple
  n_pieces: int
  rank_floats: int
  bias_floats: int
  slot_floats: int
  smem_bytes: int


def _round(n: int, k: int) -> int:
  return -(-n // k) * k


def wide_layout(tile: int, cluster: int, ntw: int, num_actions: int,
                embedding_dim: int, bins: int, num_simulations: int,
                dyn_widths, pred_widths, resident: bool, ring: int,
                smem_trees: bool) -> Optional[WideLayout]:
  """The layout of one wide launch, or None where a phase has more column
  tiles than the instance's warps can own. A copy of the kernel's
  ``wide_layout`` (``mz_wide_layout``), so that the CPU tests size the plan
  without the library; a ``gpu`` test ties the two."""
  A, E = num_actions, embedding_dim
  phases, d_in = [], E + A
  for w in dyn_widths:
    phases.append((d_in, w))
    d_in = w
  phases.append((d_in, bins + E))
  d_in = E
  for w in pred_widths:
    phases.append((d_in, w))
    d_in = w
  phases.append((d_in, bins + A))
  ins = tuple(i for i, _ in phases)
  widths = tuple(w for _, w in phases)
  in8 = tuple(_round(i, 8) for i in ins)
  nb = tuple(_round(-(-w // cluster), 8) for w in widths)
  for n in nb:
    nt, split = n // 8, 1
    while nt * split * 2 <= WIDE_THREADS // 32:
      split *= 2
    if -(-nt // (WIDE_THREADS // 32 // split)) > ntw:
      return None
  b_off = tuple(sum(nb[:p]) for p in range(len(nb)))
  bias_floats = _round(sum(nb), 8)
  w_off = tuple(bias_floats + sum(in8[q] * nb[q] for q in range(p))
                for p in range(len(nb)))
  rank_floats = bias_floats + sum(i * n for i, n in zip(in8, nb))
  slot = max(WIDE_PIECE_ROWS * n for n in nb)
  n_pieces = sum(-(-i // WIDE_PIECE_ROWS) for i in in8)
  row = _padded_row
  hidden = max([1, *dyn_widths, *pred_widths])
  envs = tile // cluster
  tree = _round(5 * (num_simulations + 1) * (1 + A), 4)
  floats = _WIDE_BARRIER_FLOATS + sum(_round(n, 4) for n in (
      rank_floats if resident else bias_floats,
      0 if resident else ring * slot,
      tile * row(hidden), tile * row(hidden), tile * row(E + A),
      tile * row(E), envs * row(bins), envs * row(A),
      (WIDE_THREADS // 32) * (tile // 16) * 128, envs * A, 4 * envs,
      envs * tree if smem_trees else 0))
  return WideLayout(ins, in8, widths, nb, b_off, w_off, n_pieces,
                    rank_floats, bias_floats, slot, 4 * floats)


class WidePlan(NamedTuple):
  """How a wide-mode launch runs: tiles of ``tile`` environments on
  clusters of ``cluster`` blocks; the towers ``resident`` in shared memory
  for the launch, or streamed through a ring of ``ring`` pieces; the trees
  in shared memory (``smem_trees``) or in the device scratch;
  ``smem_bytes`` a block; ``grid`` blocks; ``active_clusters`` clusters the
  card holds at once (the CUDA runtime's count on the card) and whether
  every tile is resident in one wave."""
  tile: int
  cluster: int
  resident: bool
  ring: int
  smem_trees: bool
  smem_bytes: int
  grid: int
  active_clusters: int
  one_wave: bool


def wide_search_plan(batch: int, num_actions: int, embedding_dim: int,
                     num_simulations: int, bins: int, dyn_widths,
                     pred_widths, gumbel: bool, limits: DeviceLimits,
                     clusters: Callable) -> WidePlan:
  """The wide modes' plan. For each instance (``WIDE_INSTANCES``): the
  towers resident where a rank's pack fits a block beside the tile's
  buffers, else streamed through as many ring slots as fit (two to
  ``WIDE_MAX_RING``); the trees in shared memory where they fit, else in
  the device scratch. The first instance whose tiles are all resident in
  one wave of clusters wins, else the one with the most environments in
  flight (then the larger tile). ``clusters(gumbel, tile, cluster,
  smem_bytes)`` gives the clusters the card holds at once
  (``wide_active_clusters``: the CUDA runtime's count). Raises
  RuntimeError where no instance fits."""
  plans = []
  for tile, cluster, ntw in WIDE_INSTANCES:
    for smem_trees in (True, False):
      def layout(resident, ring):
        lay = wide_layout(tile, cluster, ntw, num_actions, embedding_dim,
                          bins, num_simulations, dyn_widths, pred_widths,
                          resident, ring, smem_trees)
        return lay if lay and lay.smem_bytes <= limits.smem_per_block \
            else None
      resident, ring, lay = True, 0, layout(True, 0)
      if lay is None:
        resident, ring, lay = False, 2, layout(False, 2)
        if lay is not None:
          ring = min(WIDE_MAX_RING, 2 + (limits.smem_per_block
                                         - lay.smem_bytes)
                     // (4 * lay.slot_floats))
          lay = layout(False, ring)
      if lay is not None:
        break
    if lay is None:
      continue
    active = clusters(gumbel, tile, cluster, lay.smem_bytes)
    tiles = -(-batch // tile)
    plans.append(WidePlan(tile, cluster, resident, ring, smem_trees,
                          lay.smem_bytes, tiles * cluster, active,
                          0 < tiles <= active))
  plans = [p for p in plans if p.active_clusters > 0]
  if not plans:
    raise RuntimeError("fused search kernel: shapes do not fit the fused "
                       "search kernel (one environment's tree exceeds a "
                       "block's shared memory)")
  for p in plans:
    if p.one_wave:
      return p
  return max(plans, key=lambda p: (p.active_clusters * p.tile, p.tile))


@functools.lru_cache(maxsize=None)
def wide_active_clusters(index: int) -> Callable:
  """``clusters`` for ``wide_search_plan`` on card ``index``: the CUDA
  runtime's ``cudaOccupancyMaxActiveClusters`` for the compiled instance
  (one function a card, so that plans stay cached)."""
  @functools.lru_cache(maxsize=None)
  def clusters(gumbel, tile, cluster, smem_bytes):
    out = ctypes.c_int(0)
    lib = _load_kernel()
    err = lib.mz_wide_active_clusters(int(gumbel), tile, cluster,
                                      smem_bytes, index, ctypes.byref(out))
    if err != 0:
      raise RuntimeError("fused search kernel: "
                         + lib.mz_error_string(err).decode())
    return out.value
  return clusters


def wide_plan_layout(plan: WidePlan, num_actions: int, embedding_dim: int,
                     bins: int, num_simulations: int, dyn_widths,
                     pred_widths) -> WideLayout:
  """The layout of ``plan`` (its instance's ``wide_layout``)."""
  ntw = {(t, c): n for t, c, n in WIDE_INSTANCES}[plan.tile, plan.cluster]
  return wide_layout(plan.tile, plan.cluster, ntw, num_actions,
                     embedding_dim, bins, num_simulations, dyn_widths,
                     pred_widths, plan.resident, plan.ring, plan.smem_trees)


@functools.lru_cache(maxsize=None)
def _wide_pack_index(cluster: int, num_actions: int, embedding_dim: int,
                     bins: int, dyn_widths, pred_widths) -> np.ndarray:
  """Indices into the flat towers with one zero appended (index n_weights)
  of every float of the packs of ``cluster`` ranks (``pack_wide_towers``)."""
  A, E = num_actions, embedding_dim
  lay = wide_layout(16, cluster, 1 << 20, A, E, bins, 0, dyn_widths,
                    pred_widths, False, 2, False)
  # Each phase's linears as (W offset, in, out) in the flat buffer, whose
  # columns lie side by side in the phase's output.
  linears, off, d_in = [], 0, E + A
  def take(d_in, d_out):
    nonlocal off
    at = off
    off += d_in * d_out + d_out
    return (at, d_in, d_out)
  for w in dyn_widths:
    linears.append([take(d_in, w)])
    d_in = w
  linears.append([take(d_in, bins), take(d_in, E)])
  d_in = E
  for w in pred_widths:
    linears.append([take(d_in, w)])
    d_in = w
  linears.append([take(d_in, bins), take(d_in, A)])
  zero = off
  idx = np.full((cluster, lay.rank_floats), zero, dtype=np.int64)
  for p, parts in enumerate(linears):
    col_w, col_b, col_out = [], [], []  # per output column
    for at, d_in, d_out in parts:
      col_w += [at + c for c in range(d_out)]
      col_b += [at + d_in * d_out + c for c in range(d_out)]
      col_out += [d_out] * d_out
    col_w, col_b, col_out = map(np.asarray, (col_w, col_b, col_out))
    nb, rows = lay.nb[p], lay.ins[p]
    for r in range(cluster):
      cols = r * nb + np.arange(nb)
      ok = cols < lay.widths[p]
      c = np.where(ok, cols, 0)
      idx[r, lay.b_off[p]:lay.b_off[p] + nb] = np.where(ok, col_b[c], zero)
      k = np.arange(lay.in8[p])[:, None]
      w = col_w[c][None, :] + k * col_out[c][None, :]
      w = np.where(ok[None, :] & (k < rows), w, zero)
      idx[r, lay.w_off[p]:lay.w_off[p] + lay.in8[p] * nb] = w.reshape(-1)
  return idx.reshape(-1)


@functools.lru_cache(maxsize=8)
def _wide_pack_index_on(device: torch.device, *key) -> torch.Tensor:
  return torch.from_numpy(_wide_pack_index(*key)).to(device)


def pack_wide_towers(flat: torch.Tensor, cluster: int, num_actions: int,
                     embedding_dim: int, bins: int, dyn_widths,
                     pred_widths) -> torch.Tensor:
  """The flat towers cut for the wide kernel: for each of the ``cluster``
  ranks its biases, then each phase's [in8, nb] slice of its columns
  (zeros past the input rows and the phase's width): one gather a launch."""
  index = _wide_pack_index_on(flat.device, cluster, num_actions,
                              embedding_dim, bins, tuple(dyn_widths),
                              tuple(pred_widths))
  return torch.cat((flat, flat.new_zeros(1)))[index]


def wide_kernel_layout(plan: WidePlan, batch: int, num_actions: int,
                       embedding_dim: int, bins: int, num_simulations: int,
                       dyn_widths, pred_widths) -> Tuple[int, ...]:
  """The kernel's own layout of ``plan`` (``mz_wide_layout``): shared
  memory bytes a block, floats of a rank's pack, of its biases, pieces a
  simulation, floats of a ring slot."""
  lib = _load_kernel()
  out = (ctypes.c_long * 5)()
  err = lib.mz_wide_layout(
      batch, num_actions, embedding_dim, bins, num_simulations,
      len(dyn_widths), _ints(dyn_widths), len(pred_widths),
      _ints(pred_widths), plan.tile, plan.cluster, int(plan.resident),
      plan.ring, int(plan.smem_trees), out)
  if err != 0:
    raise RuntimeError("fused search kernel: "
                       + lib.mz_error_string(err).decode())
  return tuple(out)


def _check(name: str, t: torch.Tensor, shape, device: torch.device):
  if t.device != device or t.dtype != torch.float32:
    raise ValueError(f"{name}: expected float32 on {device}, got {t.dtype} "
                     f"on {t.device}")
  if tuple(t.shape) != tuple(shape):
    raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                     f"{tuple(t.shape)}")
  if not t.is_contiguous():
    raise ValueError(f"{name}: expected a contiguous tensor")


def _ints(values):
  return (ctypes.c_int * max(len(values), 1))(*values)


def _fused_search_cuda(root_embedding, root_prior_logits, root_value,
                       weights, *, num_simulations, discount,
                       invalid_actions, max_depth, support_size=None,
                       pb_c_init=1.25, pb_c_base=19652.0, root_score=None,
                       schedule=None):
  """Launch one mode of the kernel: ``FusedMLPWeights`` take the MLP modes
  (lane groups per environment with the towers staged in shared memory, or,
  for towers wider than that, clusters of blocks per tile of environments
  sharing every tower read; ``mlp_search_plan`` picks), a ``FusedNetSpec``
  the categorical
  modes (clusters of blocks per tile of environments, tensor-core products
  over weights read from device memory);
  ``root_score`` and ``schedule`` select the Gumbel policy."""
  global launches, gumbel_launches, wide_launches, wide_gumbel_launches
  global categorical_launches, categorical_gumbel_launches
  device = root_embedding.device
  B, E = root_embedding.shape
  A = root_prior_logits.shape[-1]
  _check("root_embedding", root_embedding, (B, E), device)
  _check("root_prior_logits", root_prior_logits, (B, A), device)
  _check("root_value", root_value, (B,), device)
  if invalid_actions is not None:
    _check("invalid_actions", invalid_actions, (B, A), device)
  gumbel = root_score is not None
  if gumbel:
    _check("root_score", root_score, (B, A), device)
    _check("schedule", schedule, (B, num_simulations), device)
  tiled = isinstance(weights, FusedNetSpec)
  spec = _as_spec(weights, support_size)
  flat = weights.flat()
  _check("weights", flat, flat.shape, device)
  dyn_width = [ts[0].shape[1] for _, ts in spec.dyn_layers]
  pred_width = [ts[0].shape[1] for _, ts in spec.pred_layers]
  bins = spec.num_bins
  if not spec.dyn_layers or not spec.pred_layers or (
      spec.dyn_layers[0][1][0].shape[0] != E + A
      or spec.dyn_reward[0].shape[1] != bins
      or spec.pred_value[0].shape[1] != bins
      or spec.dyn_state[0].shape[1] != E
      or spec.pred_policy[0].shape[1] != A):
    raise ValueError("weights do not fit the root shapes and support size")

  visits = torch.empty((B, A), dtype=torch.float32, device=device)
  value = torch.empty((B,), dtype=torch.float32, device=device)
  qvalues = torch.empty((B, A), dtype=torch.float32, device=device)
  lib = _load_kernel()
  max_depth = num_simulations if max_depth is None else max_depth
  roots = (root_embedding.data_ptr(), root_prior_logits.data_ptr(),
           root_value.data_ptr(),
           None if invalid_actions is None else invalid_actions.data_ptr())
  dev_index = (device.index if device.index is not None
               else torch.cuda.current_device())
  stream = torch.cuda.current_stream(device).cuda_stream
  if tiled:
    kind = {"elu": 0, "ln_tanh": 1}
    plan = tiled_plan(B, A, E, num_simulations,
                      [bins, *dyn_width, *pred_width], device_limits(device))
    n_scratch = tiled_scratch_floats(B, A, E, num_simulations,
                                     plan.smem_trees)
    scratch = torch.empty((n_scratch,), dtype=torch.float32, device=device)
    err = lib.mz_fused_tiled_search(
        *roots, root_score.data_ptr() if gumbel else None,
        schedule.data_ptr() if gumbel else None,
        flat.data_ptr(), flat.numel(), scratch.data_ptr(), n_scratch,
        plan.cluster, int(plan.smem_trees), tiled_grid(B, plan.cluster),
        visits.data_ptr(), value.data_ptr(), qvalues.data_ptr(),
        B, A, E, bins, int(spec.decode == "linear"), spec.support_size,
        spec.vmin, spec.vmax, num_simulations, max_depth, discount,
        pb_c_init, pb_c_base,
        len(dyn_width), _ints(dyn_width),
        _ints([kind[k] for k, _ in spec.dyn_layers]),
        len(pred_width), _ints(pred_width),
        _ints([kind[k] for k, _ in spec.pred_layers]), dev_index, stream)
  else:
    plan = mlp_search_plan(B, A, E, num_simulations, flat.numel(),
                           [bins, *dyn_width, *pred_width], gumbel,
                           device_limits(device),
                           towers=(dyn_width, pred_width),
                           clusters=wide_active_clusters(dev_index))
  if not tiled and isinstance(plan, WidePlan):
    pack = pack_wide_towers(flat, plan.cluster, A, E, bins, dyn_width,
                            pred_width)
    n_scratch = B * (num_simulations + 1) * E + (
        0 if plan.smem_trees
        else B * _round(tiled_tree_floats(A, num_simulations), 4))
    scratch = torch.empty((n_scratch,), dtype=torch.float32, device=device)
    err = lib.mz_fused_wide_search(
        *roots, root_score.data_ptr() if gumbel else None,
        schedule.data_ptr() if gumbel else None, pack.data_ptr(),
        pack.numel(), scratch.data_ptr(), n_scratch, plan.tile,
        plan.cluster, int(plan.resident), plan.ring, int(plan.smem_trees),
        visits.data_ptr(), value.data_ptr(), qvalues.data_ptr(),
        B, A, E, bins, spec.support_size, num_simulations, max_depth,
        discount, pb_c_init, pb_c_base, len(dyn_width), _ints(dyn_width),
        len(pred_width), _ints(pred_width), dev_index, stream)
  elif not tiled:
    n_scratch = 0 if plan.smem_emb else B * (num_simulations + 1) * E
    scratch = torch.empty((n_scratch,), dtype=torch.float32, device=device)
    buffers = (flat.data_ptr(), flat.numel(),
               scratch.data_ptr() if n_scratch else None, n_scratch,
               plan.group, plan.envs_per_block, int(plan.smem_emb),
               visits.data_ptr(), value.data_ptr(),
               qvalues.data_ptr(),
               B, A, E, bins, spec.support_size, num_simulations, max_depth,
               discount)
    tail = (len(dyn_width), _ints(dyn_width), len(pred_width),
            _ints(pred_width), dev_index, stream)
    if gumbel:
      err = lib.mz_fused_gumbel_search(
          *roots, root_score.data_ptr(), schedule.data_ptr(), *buffers,
          *tail)
    else:
      err = lib.mz_fused_muzero_search(*roots, *buffers, pb_c_init,
                                       pb_c_base, *tail)
  if err != 0:
    raise RuntimeError("fused search kernel: "
                       + lib.mz_error_string(err).decode())
  if tiled and gumbel:
    categorical_gumbel_launches += 1
  elif tiled:
    categorical_launches += 1
  elif gumbel:
    gumbel_launches += 1
    wide_gumbel_launches += isinstance(plan, WidePlan)
  else:
    launches += 1
    wide_launches += isinstance(plan, WidePlan)
  return visits, value, qvalues


def _dispatch(cuda_fn, plain_fn, root_embedding, *args, **kwargs):
  """CUDA tensors go to the kernel (or the call raises); CPU tensors go to
  the plain version; any other device raises."""
  if root_embedding.device.type == "cuda":
    return cuda_fn(root_embedding, *args, **kwargs)
  if root_embedding.device.type == "cpu":
    return plain_fn(root_embedding, *args, **kwargs)
  raise ValueError(f"no fused search for device {root_embedding.device}")


def fused_muzero_search(
    root_embedding: torch.Tensor,
    root_prior_logits: torch.Tensor,
    root_value: torch.Tensor,
    weights,
    *,
    num_simulations: int,
    discount: float,
    support_size: Optional[int] = None,
    invalid_actions: Optional[torch.Tensor] = None,
    max_depth: Optional[int] = None,
    pb_c_init: float = 1.25,
    pb_c_base: float = 19652.0,
):
  """Run the fused MuZero PUCT search on ``FusedMLPWeights`` (with
  ``support_size``) or a ``FusedNetSpec``. Returns (visit_counts [B, A]
  f32, root_value [B], root_qvalues [B, A]).

  CUDA tensors go to the kernel (or the call raises); CPU tensors go to the
  plain version.
  """
  return _dispatch(_fused_search_cuda, fused_muzero_search_reference,
                   root_embedding, root_prior_logits, root_value, weights,
                   num_simulations=num_simulations,
                   support_size=support_size, discount=discount,
                   invalid_actions=invalid_actions, max_depth=max_depth,
                   pb_c_init=pb_c_init, pb_c_base=pb_c_base)


def gumbel_root_inputs(root_prior_logits: torch.Tensor, gumbel: torch.Tensor,
                       invalid_actions: Optional[torch.Tensor], *,
                       max_num_considered_actions: int,
                       num_simulations: int):
  """The Gumbel kernel's two extra inputs: the root score g + logits
  [B, A] and each row's considered-visit schedule [B, num_simulations] (f32,
  exact small integers): the ``considered_visit_table`` row for
  min(max considered, number of valid actions)."""
  B, A = root_prior_logits.shape
  dev = root_prior_logits.device
  table = torch.from_numpy(seq_halving.considered_visit_table(
      max_num_considered_actions, num_simulations)).to(dev, torch.float32)
  if invalid_actions is None:
    num_valid = torch.full((B,), A, dtype=torch.long, device=dev)
  else:
    num_valid = torch.sum(1 - invalid_actions, dim=-1).to(torch.long)
  num_considered = torch.clamp(num_valid, max=max_num_considered_actions)
  schedule = table[num_considered][:, :num_simulations].contiguous()
  return (gumbel + root_prior_logits).to(torch.float32).contiguous(), schedule


def fused_gumbel_search(
    root_embedding: torch.Tensor,
    root_prior_logits: torch.Tensor,   # masked original logits (no noise)
    root_value: torch.Tensor,
    weights,
    *,
    gumbel: torch.Tensor,              # [B, A] scaled Gumbel noise
    max_num_considered_actions: int,
    num_simulations: int,
    discount: float,
    support_size: Optional[int] = None,
    invalid_actions: Optional[torch.Tensor] = None,
    max_depth: Optional[int] = None,
):
  """Run the fused Gumbel MuZero search (sequential-halving root,
  improved-policy interior, completed_by_mix_value) on ``FusedMLPWeights``
  (with ``support_size``) or a ``FusedNetSpec``. Returns (visit_counts
  [B, A], root_value [B], root_completed_q [B, A]).

  CUDA tensors go to the kernel (or the call raises); CPU tensors go to the
  plain version.
  """
  root_score, schedule = gumbel_root_inputs(
      root_prior_logits, gumbel, invalid_actions,
      max_num_considered_actions=max_num_considered_actions,
      num_simulations=num_simulations)
  return _dispatch(_fused_search_cuda, fused_gumbel_search_reference,
                   root_embedding, root_prior_logits, root_value, weights,
                   root_score=root_score, schedule=schedule,
                   num_simulations=num_simulations,
                   support_size=support_size, discount=discount,
                   invalid_actions=invalid_actions, max_depth=max_depth)


def noised_root_logits(generator: torch.Generator,
                       prior_logits: torch.Tensor,
                       invalid_actions: Optional[torch.Tensor] = None, *,
                       dirichlet_fraction: float = 0.25,
                       dirichlet_alpha: float = 0.3) -> torch.Tensor:
  """The root logits the MuZero policy searches from: softmax, Dirichlet
  noise mixed in at ``dirichlet_fraction``, log, invalid actions masked.
  Contiguous [B, A]."""
  probs = torch.softmax(prior_logits, dim=-1)
  if dirichlet_fraction > 0.0:
    probs = _add_dirichlet_noise(generator, probs,
                                 fraction=dirichlet_fraction,
                                 alpha=dirichlet_alpha)
  return _mask_invalid(_get_logits_from_probs(probs),
                       invalid_actions).contiguous()


def fused_mlp_muzero_policy(
    params: MZParams,
    generator: torch.Generator,
    root,                      # RootFnOutput from make_root_fn
    weights,                   # FusedMLPWeights or FusedNetSpec
    *,
    num_simulations: int,
    discount: float,
    support_size: Optional[int] = None,
    invalid_actions: Optional[torch.Tensor] = None,
    max_depth: Optional[int] = None,
    dirichlet_fraction: float = 0.25,
    dirichlet_alpha: float = 0.3,
    pb_c_init: float = 1.25,
    pb_c_base: float = 19652.0,
    temperature=1.0,
):
  """MuZero policy on the fused search: Dirichlet-noised root, search,
  visit-count^(1/T) action. Returns (action [B] int32, action_weights [B, A],
  root_value [B]). Randomness comes from ``generator`` (on the roots'
  device)."""
  del params
  noised_logits = noised_root_logits(
      generator, root.prior_logits, invalid_actions,
      dirichlet_fraction=dirichlet_fraction, dirichlet_alpha=dirichlet_alpha)
  visit_counts, root_value, _ = fused_muzero_search(
      root.embedding.contiguous(), noised_logits,
      root.value.contiguous(), weights,
      num_simulations=num_simulations, support_size=support_size,
      discount=discount, invalid_actions=invalid_actions,
      max_depth=max_depth, pb_c_init=pb_c_init, pb_c_base=pb_c_base)

  total = torch.sum(visit_counts, dim=-1, keepdim=True)
  action_weights = torch.where(
      total > 0, visit_counts / torch.clamp(total, min=1.0),
      torch.full_like(visit_counts, 1.0 / visit_counts.shape[-1]))
  action_logits = _apply_temperature(_get_logits_from_probs(action_weights),
                                     temperature)
  action = torch.multinomial(torch.softmax(action_logits, dim=-1), 1,
                             generator=generator)[:, 0]
  return action.to(torch.int32), action_weights, root_value


def fused_mlp_gumbel_policy(
    params: MZParams,
    generator: torch.Generator,
    root,                      # RootFnOutput from make_root_fn
    weights,                   # FusedMLPWeights or FusedNetSpec
    *,
    num_simulations: int,
    discount: float,
    support_size: Optional[int] = None,
    invalid_actions: Optional[torch.Tensor] = None,
    max_depth: Optional[int] = None,
    max_num_considered_actions: int = 16,
    gumbel_scale: float = 1.0,
    gumbel: Optional[torch.Tensor] = None,
):
  """Gumbel MuZero policy on the fused search, with the output semantics of
  ``policies.gumbel_muzero_policy``: the action is the argmax of
  g + logits + sigma(q-hat) among the max-visit actions, the weights are
  softmax(masked logits + completed q). Returns (action [B] int32,
  action_weights [B, A], root_value [B]). ``gumbel`` [B, A], when given, is
  the scaled root noise in place of a draw from ``generator``."""
  del params
  masked_logits = _mask_invalid(root.prior_logits, invalid_actions)
  if gumbel is None:
    gumbel = gumbel_scale * gumbel_noise(generator, masked_logits.shape,
                                         masked_logits.device)
  visit_counts, root_value, completed_q = fused_gumbel_search(
      root.embedding.contiguous(), masked_logits.contiguous(),
      root.value.contiguous(), weights, gumbel=gumbel,
      max_num_considered_actions=max_num_considered_actions,
      num_simulations=num_simulations, support_size=support_size,
      discount=discount, invalid_actions=invalid_actions,
      max_depth=max_depth)

  action, action_weights = gumbel_action(visit_counts, completed_q, gumbel,
                                         masked_logits, invalid_actions)
  return action, action_weights, root_value


def gumbel_action(visit_counts: torch.Tensor, completed_q: torch.Tensor,
                  gumbel: torch.Tensor, masked_logits: torch.Tensor,
                  invalid_actions: Optional[torch.Tensor] = None):
  """The Gumbel policy's output from a search's root: the argmax of
  g + logits + sigma(q-hat) among the max-visit actions (int32 [B]), and
  the weights softmax(masked logits + completed q) [B, A]."""
  considered_visit = torch.amax(visit_counts, dim=-1, keepdim=True)
  score = torch.where(visit_counts == considered_visit,
                      gumbel + masked_logits + completed_q,
                      torch.full_like(completed_q, -torch.inf))
  action = torch.argmax(_mask_invalid(score, invalid_actions), dim=-1)
  action_weights = torch.softmax(
      _mask_invalid(masked_logits + completed_q, invalid_actions), dim=-1)
  return action.to(torch.int32), action_weights


# ---------------------------------------------------------------------------
# Stochastic MuZero: the decision/chance forest over A' = A + C
# ---------------------------------------------------------------------------
#
# The port of the JAX package's second kernel (``fused_smz_search``,
# ``_make_smz_kernel``): on a CUDA tensor ``fused_smz_search`` launches
# ``csrc/fused_smz.cu``, on a CPU tensor it runs
# ``fused_smz_search_reference``. Semantics (those of
# ``policies.stochastic_muzero_policy`` up to tie-breaking): a node created
# by a chance outcome (slot >= A), and the root, is a decision node, every
# other node a chance node. Decision nodes score their A slots with PUCT
# under the parent-and-siblings qtransform, q = r + gamma v; chance nodes
# score their C slots by p(o) - n(o)/(1 + N). Invalid actions are masked at
# depth 0, ties go to the first slot, the descent stops at an unexpanded
# child or at ``max_depth`` (a depth-capped descent re-evaluates the existing
# child in place). A decision parent expands through the decision tower
# (afterstate, chance prior, afterstate value); a chance parent through the
# chance tower (next state, reward) and the prediction tower (policy,
# value). Rewards and the discount sit on chance edges only: decision edges
# carry r = 0 and gamma = 1. Install is a running mean; the backup starts
# from the raw network value.


class FusedSMZWeights(NamedTuple):
  """The decision, chance and prediction towers as (W [in, out], b [out])
  pairs (``muax_tpu/search/fused.py`` ``FusedSMZWeights``)."""
  dec_layers: Tuple[Linear, ...]   # ELU hidden; first W has in = E + A
  dec_state: Linear                # W [H, E], the afterstate head
  dec_chance: Linear               # W [H, C]
  dec_value: Linear                # W [H, 2S+1]
  ch_layers: Tuple[Linear, ...]    # first W has in = E + C
  ch_state: Linear                 # W [H, E]
  ch_reward: Linear                # W [H, 2S+1]
  pred_layers: Tuple[Linear, ...]  # first W has in = E
  pred_policy: Linear              # W [H, A]
  pred_value: Linear               # W [H, 2S+1]

  def layers(self):
    """Every linear in the kernel's order."""
    return (*self.dec_layers, self.dec_state, self.dec_chance,
            self.dec_value, *self.ch_layers, self.ch_state, self.ch_reward,
            *self.pred_layers, self.pred_policy, self.pred_value)

  def flat(self) -> torch.Tensor:
    """One contiguous f32 buffer: W then b for each linear of ``layers``."""
    return torch.cat([t.reshape(-1) for pair in self.layers() for t in pair])


def extract_smz_fused_weights(networks, params: SMZParams
                              ) -> Optional[FusedSMZWeights]:
  """The three interior towers of ``params`` in the kernel's layout
  (detached); None for a family other than ``SMZNetworks``."""
  if not isinstance(networks, SMZNetworks):
    return None

  def pairs(tower):
    return [(layer.weight.detach().t().contiguous(), layer.bias.detach())
            for layer in tower.linears()]

  *d_hidden, d_state, d_chance, d_value = pairs(params.decision)
  *c_hidden, c_state, c_reward = pairs(params.chance)
  *p_hidden, p_policy, p_value = pairs(params.prediction)
  return FusedSMZWeights(
      dec_layers=tuple(d_hidden), dec_state=d_state, dec_chance=d_chance,
      dec_value=d_value, ch_layers=tuple(c_hidden), ch_state=c_state,
      ch_reward=c_reward, pred_layers=tuple(p_hidden), pred_policy=p_policy,
      pred_value=p_value)


def _plain_smz_search(root_embedding, root_prior_logits, root_value,
                      weights: FusedSMZWeights, *, num_simulations: int,
                      support_size: int, discount: float, invalid_actions,
                      max_depth, pb_c_init: float, pb_c_base: float):
  """The plain forest search, batched over [B, N] and [B, N, A'] tensors
  with a lockstep descent; only the towers each env needs run. Returns
  (visits [B, A], root value [B], decision q [B, A], the count [B] of
  expansions under a chance node)."""
  B, E = root_embedding.shape
  A = root_prior_logits.shape[-1]
  C = weights.dec_chance[0].shape[1]
  AP, N = A + C, num_simulations + 1
  if max_depth is None:
    max_depth = num_simulations
  dev = root_embedding.device
  f32 = torch.float32
  rows = torch.arange(B, device=dev)
  dec_slot = torch.arange(AP, device=dev) < A
  gamma = torch.where(dec_slot, 1.0, discount).to(f32)
  invalid = torch.ones(B, AP, dtype=f32, device=dev)
  invalid[:, :A] = (0.0 if invalid_actions is None
                    else invalid_actions.to(f32))
  bins = torch.arange(2 * support_size + 1, dtype=f32, device=dev)

  def decode(logits):  # softmax expectation over -S..S, then h^-1
    probs = torch.softmax(logits, dim=-1)
    return inv_value_transform(torch.sum(probs * (bins - support_size), -1))

  nvis = torch.zeros(B, N, dtype=f32, device=dev)
  nvis[:, 0] = 1.0
  nval = torch.zeros(B, N, dtype=f32, device=dev)
  nval[:, 0] = root_value.to(f32)
  npar = torch.full((B, N), -1, dtype=torch.long, device=dev)
  nact = torch.full((B, N), -1, dtype=torch.long, device=dev)
  cidx = torch.full((B, N, AP), -1, dtype=torch.long, device=dev)
  cpri = torch.zeros(B, N, AP, dtype=f32, device=dev)
  cpri[:, 0, :A] = torch.softmax(root_prior_logits.to(f32), dim=-1)
  cvis = torch.zeros(B, N, AP, dtype=f32, device=dev)
  crew = torch.zeros(B, N, AP, dtype=f32, device=dev)
  cval = torch.zeros(B, N, AP, dtype=f32, device=dev)
  embs = torch.zeros(B, N, E, dtype=f32, device=dev)
  embs[:, 0] = root_embedding.to(f32)
  chance_expansions = torch.zeros(B, dtype=torch.long, device=dev)

  def is_decision(node):
    return (nact[rows, node] >= A) | (node == 0)

  def score(cur, depth):
    fdec = is_decision(cur)[:, None]
    nvisit = nvis[rows, cur][:, None]
    nvalue = nval[rows, cur][:, None]
    cv = cvis[rows, cur]
    pri = cpri[rows, cur]
    q = crew[rows, cur] + gamma * cval[rows, cur]
    visited = cv > 0
    safe_q = torch.where(visited, q, nvalue)
    minv = torch.minimum(nvalue, safe_q.amin(-1, keepdim=True))
    maxv = torch.maximum(nvalue, safe_q.amax(-1, keepdim=True))
    completed = torch.where(visited, q, minv)
    qn = (completed - minv) / torch.clamp(maxv - minv, min=1e-8)
    pb_c = pb_c_init + torch.log((nvisit + pb_c_base + 1.0) / pb_c_base)
    dec_score = qn + (torch.sqrt(nvisit) * pb_c) * pri / (cv + 1.0)
    ch_score = pri - cv / (1.0 + cv.sum(-1, keepdim=True))
    out = torch.where(fdec, dec_score, ch_score)
    out = torch.where(dec_slot[None] == fdec, out, torch.full_like(out, _NEG))
    if depth == 0:
      out = torch.where(invalid > 0, torch.full_like(out, _NEG), out)
    return out

  def tower(x, layers):
    for w, b in layers:
      x = _elu(x @ w + b)
    return x

  def normalized(x):
    lo = x.amin(-1, keepdim=True)
    hi = x.amax(-1, keepdim=True)
    return (x - lo) / torch.clamp(hi - lo, min=1e-8)

  def head(h, linear):
    return h @ linear[0] + linear[1]

  for s in range(num_simulations):
    cur = torch.zeros(B, dtype=torch.long, device=dev)
    parent = torch.full((B,), -1, dtype=torch.long, device=dev)
    act = torch.full((B,), -1, dtype=torch.long, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    depth = 0
    while bool(active.any()):
      at = cur.clamp(min=0)
      a = torch.argmax(score(at, depth), dim=-1)  # first maximum
      child = cidx[rows, at, a]
      parent = torch.where(active, at, parent)
      act = torch.where(active, a, act)
      cur = torch.where(active, child, cur)
      depth += 1
      active = active & (child >= 0) & (depth < max_depth)

    existing = cidx[rows, parent, act]
    slot = torch.where(existing < 0, torch.full_like(existing, s + 1),
                       existing)

    # Expansion: the decision tower under a decision parent, the chance and
    # prediction towers under a chance parent.
    f = is_decision(parent)
    pe = embs[rows, parent]
    value = torch.zeros(B, dtype=f32, device=dev)
    reward = torch.zeros(B, dtype=f32, device=dev)
    prior = torch.zeros(B, AP, dtype=f32, device=dev)
    new_emb = torch.zeros(B, E, dtype=f32, device=dev)
    h = tower(torch.cat([pe[f], F.one_hot(act[f], A).to(f32)], -1),
              weights.dec_layers)
    new_emb[f] = normalized(head(h, weights.dec_state))
    prior[f, A:] = torch.softmax(head(h, weights.dec_chance), -1)
    value[f] = decode(head(h, weights.dec_value))
    c = ~f
    h = tower(torch.cat([pe[c], F.one_hot(act[c] - A, C).to(f32)], -1),
              weights.ch_layers)
    ns = normalized(head(h, weights.ch_state))
    reward[c] = decode(head(h, weights.ch_reward))
    g = tower(ns, weights.pred_layers)
    new_emb[c] = ns
    prior[c, :A] = torch.softmax(head(g, weights.pred_policy), -1)
    value[c] = decode(head(g, weights.pred_value))
    chance_expansions += c.long()

    # Install (running mean; a re-evaluated node keeps its children).
    count = nvis[rows, slot]
    nval[rows, slot] = (nval[rows, slot] * count + value) / (count + 1.0)
    nvis[rows, slot] = count + 1.0
    npar[rows, slot] = parent
    nact[rows, slot] = act
    cpri[rows, slot] = prior
    embs[rows, slot] = new_emb
    crew[rows, parent, act] = reward
    cidx[rows, parent, act] = slot

    # Backup from the raw value with each edge's discount.
    idx, v = slot, value
    while bool((idx != 0).any()):
      on = idx != 0
      par = npar[rows, idx].clamp(min=0)
      a_b = nact[rows, idx].clamp(min=0)
      cnt = nvis[rows, par]
      vnew = crew[rows, par, a_b] + gamma[a_b] * v
      child_val = nval[rows, idx]
      nval[rows, par] = torch.where(
          on, (nval[rows, par] * cnt + vnew) / (cnt + 1.0), nval[rows, par])
      nvis[rows, par] = torch.where(on, cnt + 1.0, cnt)
      cval[rows, par, a_b] = torch.where(on, child_val, cval[rows, par, a_b])
      cvis[rows, par, a_b] = cvis[rows, par, a_b] + on.to(f32)
      v = torch.where(on, vnew, v)
      idx = torch.where(on, par, idx)

  # Decision-edge q is the afterstate's value (r = 0, gamma = 1).
  return (cvis[:, 0, :A], nval[:, 0], cval[:, 0, :A], chance_expansions)


def fused_smz_search_reference(
    root_embedding: torch.Tensor,      # [B, E]
    root_prior_logits: torch.Tensor,   # [B, A] decision logits (noised)
    root_value: torch.Tensor,          # [B]
    weights: FusedSMZWeights,
    *,
    num_simulations: int,
    support_size: int,
    discount: float,
    invalid_actions: Optional[torch.Tensor] = None,
    max_depth: Optional[int] = None,
    pb_c_init: float = 1.25,
    pb_c_base: float = 19652.0,
):
  """Plain PyTorch version of the fused Stochastic MuZero search. Returns
  (decision visit_counts [B, A], root_value [B], decision q [B, A])."""
  return _plain_smz_search(
      root_embedding, root_prior_logits, root_value, weights,
      num_simulations=num_simulations, support_size=support_size,
      discount=discount, invalid_actions=invalid_actions,
      max_depth=max_depth, pb_c_init=pb_c_init, pb_c_base=pb_c_base)[:3]


# The Stochastic MuZero launch (``fused_smz_kernel<smem_tree>``): four warps
# an environment and one to three environments a block (its
# ``__launch_bounds__(384, 1)``: at most 168 registers a thread; ``ptxas``
# gives each instance fewer, ``_SMZ_REGISTERS``), the three towers staged
# once per block in shared memory where they fit beside one environment;
# wider towers (the 2048 example's widths: 762,031 floats) take the tile
# kernel, ``fused_smz_wide_kernel`` (``smz_wide_plan``). Each environment's
# compact tree (a float4 per node: visits, value, reward, and the PUCT
# prior scale or the children's visits; per slot of a row of max(A, C) the
# child index and prior; the last descent's path) and its embeddings [N, E]
# lie in shared memory where the block has room, else in a device scratch;
# the work buffers always in shared memory.
SMZ_ENV_THREADS = 128
SMZ_MAX_ENVS = 3
# Registers a thread of each instance, by smem_tree, as
# ``ptxas`` reports them for sm_90a (chip_smoke.py phase 0); an SM allocates
# them in steps of 8 a thread. ``smz_blocks_per_sm`` reads the CUDA
# runtime's count for the compiled kernel, and the gpu tests hold the two
# to agree.
_SMZ_REGISTERS = {True: 119, False: 128}
_SMZ_MAX_NODES = 32767  # int16 node indices


class SMZPlan(NamedTuple):
  """How a Stochastic MuZero launch of ``fused_smz_kernel`` runs:
  ``envs_per_block`` environments a block, the trees (``smem_tree``) and
  the embeddings (``smem_emb``) in shared memory or in the device scratch;
  ``grid`` blocks, of which an SM holds ``blocks_per_sm`` at once, in
  ``waves`` waves; ``smem_bytes`` of shared memory a block and
  ``scratch_bytes`` of device scratch an environment. The towers are
  staged in shared memory, once a block."""
  envs_per_block: int
  smem_tree: bool
  smem_emb: bool
  grid: int
  blocks_per_sm: int
  waves: int
  smem_bytes: int
  scratch_bytes: int


def _round16(n: int) -> int:
  return -(-n // 16) * 16


def smz_tree_bytes(num_actions: int, num_outcomes: int, num_simulations: int,
                   max_depth: int) -> int:
  """Bytes of one compact tree (the kernel's ``tree_bytes_of``): float4
  nodes (4 N floats) and priors (N K), int16 children (N K) and path
  (min(max_depth, sims) + 1), K = max(A, C)."""
  n, k = num_simulations + 1, max(num_actions, num_outcomes)
  path = min(max_depth, num_simulations) + 1
  return _round16(4 * (4 * n + n * k) + 2 * (n * k + path))


def smz_env_bytes(num_actions: int, num_outcomes: int, embedding_dim: int,
                  bins: int, num_simulations: int, max_depth: int,
                  max_hidden: int) -> Tuple[int, int, int]:
  """Bytes of one environment's compact tree, work buffers and embeddings
  (the kernel's ``mz_smz_env_bytes``): the tree (``smz_tree_bytes``); the
  buffers X [E], two hidden [max_hidden], Y [E + C + bins], Z [A + bins]
  and the invalid mask [A], each rounded up to 4 floats, and 8 control
  words; the embeddings [N, E]."""
  A, C, E = num_actions, num_outcomes, embedding_dim
  n = num_simulations + 1
  tree = smz_tree_bytes(A, C, num_simulations, max_depth)
  floats = sum(-(-f // 4) * 4 for f in (
      E, max_hidden, max_hidden, E + C + bins, A + bins, A)) + 8
  return tree, 4 * floats, _round16(4 * n * E)


def smz_search_plan(batch: int, num_actions: int, num_outcomes: int,
                    embedding_dim: int, bins: int, num_simulations: int,
                    max_depth: int, n_weights: int, max_hidden: int,
                    limits: DeviceLimits, towers=None,
                    clusters: Optional[Callable] = None
                    ) -> Union[SMZPlan, "SMZWidePlan"]:
  """The Stochastic MuZero launch plan. Where some plan stages the towers
  in shared memory beside one environment's work buffers, an ``SMZPlan``:
  the trees in shared memory where one fits a block (a level of a walk is
  then a shared-memory access, not an L2 round trip), then the fewest
  waves, then the embeddings in shared memory, then the fewest
  environments a block (the most SMs at work). Towers wider than that
  take the tile kernel, ``smz_wide_plan``'s ``SMZWidePlan``, for which
  ``towers`` gives the (decision, chance, prediction) hidden widths (by
  default one layer of ``max_hidden`` each) and ``clusters`` the card's
  count of clusters it holds at once (``smz_wide_active_clusters``), at
  every batch. The tile kernel replaced an instance of
  ``fused_smz_kernel`` that read the towers from device memory through
  ``__ldg``. At 200 simulations of the 2048 example's widths, medians of
  ten launches each in alternating processes (``tools/kernel_split.py
  --against <parent> --only wide_smz``, H100 80GB HBM3, 700 W, two
  calls): 1024 boards 36.53 and 36.57 ms against its 47.71 and 47.68, 112
  boards 14.23 and 14.30 against 14.32 and 14.39; on phase 33's 64 roots
  14.42 and 14.52 against 14.27 and 14.31, the old instance faster; on
  two other sets of 64 roots 14.30 and 14.25 against 14.33 and 14.29.
  Which kernel wins at 64 boards follows the roots, not the batch, so no
  batch cut-off would pick the faster one. Raises RuntimeError where the
  tree's nodes pass int16, as the kernels would. The plan of a shape is
  worked out once and kept."""
  if towers is None:
    towers = ((max_hidden,),) * 3
  towers = tuple(tuple(w) for w in towers)
  return _smz_search_plan(batch, num_actions, num_outcomes, embedding_dim,
                          bins, num_simulations, max_depth, n_weights,
                          max_hidden, limits, towers, clusters)


@functools.lru_cache(maxsize=None)
def _smz_search_plan(batch, num_actions, num_outcomes, embedding_dim, bins,
                     num_simulations, max_depth, n_weights, max_hidden,
                     limits, towers, clusters):
  if num_simulations + 1 > _SMZ_MAX_NODES:
    raise RuntimeError("fused SMZ search kernel: shapes do not fit the "
                       f"kernel ({num_simulations} simulations pass its "
                       "int16 node indices)")
  tree, work, emb = smz_env_bytes(num_actions, num_outcomes, embedding_dim,
                                  bins, num_simulations, max_depth,
                                  max_hidden)

  weights = 16 * -(-n_weights // 4)
  found = None
  for smem_tree, smem_emb in ((True, True), (True, False), (False, False)):
    env_smem = work + tree * smem_tree + emb * smem_emb
    for envs in range(1, SMZ_MAX_ENVS + 1):
      size = weights + envs * env_smem
      if size > limits.smem_per_block:
        break
      threads = envs * SMZ_ENV_THREADS
      regs = -(-_SMZ_REGISTERS[smem_tree] // 8) * 8
      per_sm = min(_SM_BLOCKS, _SM_THREADS // threads,
                   limits.regs_per_sm // (regs * threads),
                   limits.smem_per_sm // (size + limits.smem_reserved))
      grid = -(-batch // envs)
      waves = -(-grid // (per_sm * limits.sms))
      plan = SMZPlan(envs, smem_tree, smem_emb, grid, per_sm, waves, size,
                     tree * (not smem_tree) + emb * (not smem_emb))
      key = (not smem_tree, waves, not smem_emb, envs)
      if found is None or key < found[0]:
        found = (key, plan)
  if found is not None:
    return found[1]
  if clusters is None:
    raise ValueError("the wide SMZ plan needs clusters: the card's count of "
                     "clusters it holds at once")
  return smz_wide_plan(batch, num_actions, num_outcomes, embedding_dim, bins,
                       num_simulations, max_depth, *towers, limits, clusters)


# The wide launch (``fused_smz_wide_kernel<tile, cluster, ntw>``): a tile
# of ``tile`` environments on a cluster of ``cluster`` blocks of 256
# threads, each block a ``cluster``-th of every product's columns, at most
# ``ntw`` tiles of 8 columns a warp. The instances, in the order the plan
# prefers them: 16 x 16 for a small batch (64 boards: four clusters), 48 x
# 4 for a large one (1024 boards: 22 clusters, one wave of the card's 30).
SMZ_WIDE_INSTANCES = ((16, 16, 1), (48, 4, 3))
SMZ_WIDE_PIECE_ROWS = 32  # rows of a piece of the widest streamed part
SMZ_WIDE_MAX_RING = 8
SMZ_WIDE_MIN_RING = 4     # slots the plan keeps where parts stream, if it can
_SMZ_WIDE_CTL = 8         # control words of an environment
# What a part's sums become (the kernel's WideKind), its input buffer
# (WideBuf) and its one-hot row (WideHot).
_HIDDEN, _DEC_HEADS, _CH_HEADS, _PRED_HEADS = range(4)
_BUF_X, _BUF_H0, _BUF_H1 = range(3)
_HOT_NONE, _HOT_ACTION, _HOT_OUTCOME = range(3)


class SMZWidePart(NamedTuple):
  """One product of the wide kernel (its ``wide_layout``): the tower
  ("dec", "ch", "pred") and layer (the heads at the tower's depth), input
  width and rows in the pack, output width, columns ``nb`` a block, input
  buffer, kind, hidden output buffer, one-hot row, its offsets in a rank's
  pack and the rows of its pieces."""
  tower: str
  layer: int
  ins: int
  in8: int
  width: int
  nb: int
  src: int
  kind: int
  dst: int
  hot: int
  w_off: int
  b_off: int
  h_off: int
  prow: int


class SMZWideLayout(NamedTuple):
  """The wide kernel's layout: its parts in the order they run, the part
  after which the decision and chance heads are whole; floats of a rank's
  pack and of its staged prefix, streamed pieces a simulation, floats of a
  ring slot, bytes of a tree and of a block's shared memory."""
  parts: Tuple[SMZWidePart, ...]
  mid: int
  rank_floats: int
  res_floats: int
  n_stream: int
  slot_floats: int
  tree_bytes: int
  smem_bytes: int


def _warp_tiles(nb: int, warps: int = 8) -> int:
  """Column tiles a warp owns at most in a product of nb columns
  (``mz_wide::warp_tiles``)."""
  nt, split = nb // 8, 1
  while nt * split * 2 <= warps:
    split *= 2
  return -(-nt // (warps // split))


def smz_wide_layout(tile: int, cluster: int, ntw: int, num_actions: int,
                    num_outcomes: int, embedding_dim: int, bins: int,
                    num_simulations: int, max_depth: int, dec_widths,
                    ch_widths, pred_widths, n_resident: int, ring: int
                    ) -> Optional[SMZWideLayout]:
  """The layout of one wide launch, or None where a part has more column
  tiles than the instance's warps can own or the plan's resident parts and
  ring do not go together. A copy of the kernel's ``wide_layout``
  (``mz_smz_wide_layout``), so that the CPU tests size the plan without the
  library; a ``gpu`` test ties the two."""
  A, C, E, S = num_actions, num_outcomes, embedding_dim, bins
  raw = []
  for tower, widths, heads, kind, hot in (
      ("dec", dec_widths, E + C + S, _DEC_HEADS, _HOT_ACTION),
      ("ch", ch_widths, E + S, _CH_HEADS, _HOT_OUTCOME),
      ("pred", pred_widths, A + S, _PRED_HEADS, _HOT_NONE)):
    for l in range(len(widths) + 1):
      ins = E if l == 0 else widths[l - 1]
      width = widths[l] if l < len(widths) else heads
      raw.append((tower, l, ins, _round(ins, 8), width,
                  _round(-(-width // cluster), 8),
                  _BUF_X if l == 0 else _BUF_H0 + (l - 1) % 2,
                  _HIDDEN if l < len(widths) else kind, _BUF_H0 + l % 2,
                  hot if l == 0 else _HOT_NONE))
  mid = len(dec_widths) + len(ch_widths) + 1
  n = len(raw)
  if not 0 <= n_resident <= n or (n_resident < n and ring < 2):
    return None
  if any(_warp_tiles(r[5]) > ntw for r in raw):
    return None
  fixed, b_off, h_off = 0, [], []
  for r in raw:
    b_off.append(fixed)
    fixed += r[5]
    h_off.append(fixed)
    fixed += r[5] * {_HOT_ACTION: A, _HOT_OUTCOME: C}.get(r[9], 0)
  w_off, weights = [], _round(fixed, 8)
  for r in raw:
    w_off.append(weights)
    weights += r[3] * r[5]
  res_floats = w_off[n_resident] if n_resident < n else weights
  slot_nb = max([0] + [r[5] for r in raw[n_resident:]])
  slot = SMZ_WIDE_PIECE_ROWS * slot_nb
  ring = ring if n_resident < n else 0
  prow = [r[3] if slot_nb == 0 else max(8, min(r[3], slot // r[5] // 8 * 8))
          for r in raw]
  n_stream = sum(-(-r[3] // pr) for r, pr in zip(raw[n_resident:],
                                                  prow[n_resident:]))
  parts = tuple(SMZWidePart(*r, w, b, h, pr)
                for r, w, b, h, pr in zip(raw, w_off, b_off, h_off, prow))
  row = _padded_row
  hidden = max([1, *dec_widths, *ch_widths, *pred_widths])
  envs = tile // cluster
  split = any(r[5] // 8 * 2 <= 8 for r in raw)
  floats = 64 + sum(_round(f, 4) for f in (
      res_floats, ring * slot, tile * row(E), tile * row(hidden),
      tile * row(hidden), envs * row(max(E + C + S, A + S)),
      8 * (tile // 16) * 128 if split else 0, envs * A,
      envs * _SMZ_WIDE_CTL, tile))
  return SMZWideLayout(parts, mid, weights, res_floats, n_stream, slot,
                       smz_tree_bytes(A, C, num_simulations, max_depth),
                       4 * floats)


class SMZWidePlan(NamedTuple):
  """How a wide Stochastic MuZero launch runs: tiles of ``tile``
  environments on clusters of ``cluster`` blocks; the first ``n_resident``
  parts staged in shared memory for the launch and the rest streamed
  through a ring of ``ring`` slots; ``smem_bytes`` a block; ``grid``
  blocks; ``active_clusters`` clusters the card holds at once (the CUDA
  runtime's count) and whether every tile is resident in one wave;
  ``scratch_bytes`` of device scratch an environment (its embeddings and
  its compact tree)."""
  tile: int
  cluster: int
  n_resident: int
  ring: int
  smem_bytes: int
  grid: int
  active_clusters: int
  one_wave: bool
  scratch_bytes: int


def smz_wide_plan(batch: int, num_actions: int, num_outcomes: int,
                  embedding_dim: int, bins: int, num_simulations: int,
                  max_depth: int, dec_widths, ch_widths, pred_widths,
                  limits: DeviceLimits, clusters: Callable) -> SMZWidePlan:
  """The wide plan. For each instance (``SMZ_WIDE_INSTANCES``): the
  longest prefix of parts resident beside a ring of ``SMZ_WIDE_MIN_RING``
  slots (of two where four do not fit), the ring then grown into what is
  left, up to ``SMZ_WIDE_MAX_RING``: at 64 boards all parts but the
  prediction heads resident beside four slots took 14.03 ms a launch,
  six beside eight 14.71 and none beside eight 18.35
  (``tools/kernel_split.py --only wide_smz``, H100 80GB HBM3, 700 W). The
  first instance whose tiles are all resident
  in one wave of clusters wins, else the one with the most environments in
  flight (then the larger tile). ``clusters(tile, cluster, smem_bytes)``
  gives the clusters the card holds at once (``smz_wide_active_clusters``:
  the CUDA runtime's count). Raises RuntimeError where no instance fits."""
  args = (num_actions, num_outcomes, embedding_dim, bins, num_simulations,
          max_depth, tuple(dec_widths), tuple(ch_widths), tuple(pred_widths))
  plans = []
  for tile, cluster, ntw in SMZ_WIDE_INSTANCES:
    def fit(k, ring):
      lay = smz_wide_layout(tile, cluster, ntw, *args, k, ring)
      return lay if lay and lay.smem_bytes <= limits.smem_per_block else None

    n = len(dec_widths) + len(ch_widths) + len(pred_widths) + 3
    chosen = None
    for least in (SMZ_WIDE_MIN_RING, 2):
      k = next((k for k in range(n, -1, -1) if fit(k, least)), None)
      if k is not None:
        ring = least if k < n else 0
        while 0 < ring < SMZ_WIDE_MAX_RING and fit(k, ring + 1):
          ring += 1
        chosen = (k, ring)
        break
    if chosen is None:
      continue
    lay = fit(*chosen)
    active = clusters(tile, cluster, lay.smem_bytes)
    tiles = -(-batch // tile)
    scratch = _round16(4 * (num_simulations + 1) * embedding_dim) + (
        lay.tree_bytes)
    plans.append(SMZWidePlan(tile, cluster, *chosen, lay.smem_bytes,
                             tiles * cluster, active, 0 < tiles <= active,
                             scratch))
  plans = [p for p in plans if p.active_clusters > 0]
  if not plans:
    raise RuntimeError("fused SMZ search kernel: shapes do not fit the "
                       "kernel (no wide instance fits a block's shared "
                       "memory)")
  for p in plans:
    if p.one_wave:
      return p
  return max(plans, key=lambda p: (p.active_clusters * p.tile, p.tile))


def smz_wide_plan_layout(plan: SMZWidePlan, num_actions: int,
                         num_outcomes: int, embedding_dim: int, bins: int,
                         num_simulations: int, max_depth: int, dec_widths,
                         ch_widths, pred_widths) -> SMZWideLayout:
  """The layout of ``plan`` (its instance's ``smz_wide_layout``)."""
  ntw = {(t, c): n for t, c, n in SMZ_WIDE_INSTANCES}[plan.tile,
                                                      plan.cluster]
  return smz_wide_layout(plan.tile, plan.cluster, ntw, num_actions,
                         num_outcomes, embedding_dim, bins, num_simulations,
                         max_depth, dec_widths, ch_widths, pred_widths,
                         plan.n_resident, plan.ring)


@functools.lru_cache(maxsize=None)
def smz_wide_active_clusters(index: int) -> Callable:
  """``clusters`` for ``smz_wide_plan`` on card ``index``: the CUDA
  runtime's ``cudaOccupancyMaxActiveClusters`` for the compiled instance
  (one function a card, so that plans stay cached)."""
  @functools.lru_cache(maxsize=None)
  def clusters(tile, cluster, smem_bytes):
    out = ctypes.c_int(0)
    lib = _load_smz_kernel()
    err = lib.mz_smz_wide_active_clusters(tile, cluster, smem_bytes, index,
                                          ctypes.byref(out))
    if err != 0:
      raise RuntimeError("fused SMZ search kernel: "
                         + lib.mz_smz_error_string(err).decode())
    return out.value
  return clusters


@functools.lru_cache(maxsize=None)
def _smz_wide_pack_index(cluster: int, num_actions: int, num_outcomes: int,
                         embedding_dim: int, bins: int, dec_widths,
                         ch_widths, pred_widths) -> np.ndarray:
  """Indices into the flat towers with one zero appended (index n_weights)
  of every float of the packs of ``cluster`` ranks
  (``pack_smz_wide_towers``)."""
  A, C, E, S = num_actions, num_outcomes, embedding_dim, bins
  lay = smz_wide_layout(16, cluster, 1 << 20, A, C, E, S, 1, 1, dec_widths,
                        ch_widths, pred_widths, 0, 2)
  # Each tower's linears as (W offset, in, out) in the flat buffer, in the
  # kernel's order; a tower's heads lie side by side in its heads part.
  off = 0

  def take(d_in, d_out):
    nonlocal off
    at = off
    off += d_in * d_out + d_out
    return (at, d_in, d_out)

  linears = {}
  for tower, in0, widths, heads in (
      ("dec", E + A, dec_widths, (E, C, S)), ("ch", E + C, ch_widths, (E, S)),
      ("pred", E, pred_widths, (A, S))):
    d_in = in0
    for l, w in enumerate(widths):
      linears[tower, l] = [take(d_in, w)]
      d_in = w
    linears[tower, len(widths)] = [take(d_in, h) for h in heads]
  zero = off
  idx = np.full((cluster, lay.rank_floats), zero, dtype=np.int64)
  for part in lay.parts:
    col_w, col_b, col_out = [], [], []  # per output column
    for at, d_in, d_out in linears[part.tower, part.layer]:
      col_w += [at + c for c in range(d_out)]
      col_b += [at + d_in * d_out + c for c in range(d_out)]
      col_out += [d_out] * d_out
    col_w, col_b, col_out = map(np.asarray, (col_w, col_b, col_out))
    nb = part.nb
    n_hot = {_HOT_ACTION: A, _HOT_OUTCOME: C}.get(part.hot, 0)
    for r in range(cluster):
      cols = r * nb + np.arange(nb)
      ok = cols < part.width
      c = np.where(ok, cols, 0)
      idx[r, part.b_off:part.b_off + nb] = np.where(ok, col_b[c], zero)
      k = np.arange(part.in8)[:, None]
      w = col_w[c][None, :] + k * col_out[c][None, :]
      w = np.where(ok[None, :] & (k < part.ins), w, zero)
      idx[r, part.w_off:part.w_off + part.in8 * nb] = w.reshape(-1)
      if n_hot:  # rows E.. of the first layer's W: the one-hot input
        k = part.ins + np.arange(n_hot)[:, None]
        w = np.where(ok[None, :], col_w[c][None, :] + k * col_out[c][None, :],
                     zero)
        idx[r, part.h_off:part.h_off + n_hot * nb] = w.reshape(-1)
  return idx.reshape(-1)


@functools.lru_cache(maxsize=8)
def _smz_wide_pack_index_on(device: torch.device, *key) -> torch.Tensor:
  return torch.from_numpy(_smz_wide_pack_index(*key)).to(device)


def pack_smz_wide_towers(flat: torch.Tensor, cluster: int, num_actions: int,
                         num_outcomes: int, embedding_dim: int, bins: int,
                         dec_widths, ch_widths, pred_widths) -> torch.Tensor:
  """The flat towers cut for the wide kernel: for each of the ``cluster``
  ranks every part's biases and one-hot rows, then each part's [in8, nb]
  slice of its columns (zeros past the input rows and the part's width):
  one gather a launch."""
  index = _smz_wide_pack_index_on(flat.device, cluster, num_actions,
                                  num_outcomes, embedding_dim, bins,
                                  tuple(dec_widths), tuple(ch_widths),
                                  tuple(pred_widths))
  return torch.cat((flat, flat.new_zeros(1)))[index]


def smz_wide_kernel_layout(plan: SMZWidePlan, batch: int, num_actions: int,
                           num_outcomes: int, embedding_dim: int, bins: int,
                           num_simulations: int, max_depth: int, dec_widths,
                           ch_widths, pred_widths) -> Tuple[int, ...]:
  """The kernel's own layout of ``plan`` (``mz_smz_wide_layout``): shared
  memory bytes a block, floats of a rank's pack, of its staged prefix,
  streamed pieces a simulation, floats of a ring slot, bytes of a tree,
  parts, the part after which the decision and chance heads are whole."""
  lib = _load_smz_kernel()
  out = (ctypes.c_long * 8)()
  err = lib.mz_smz_wide_layout(
      batch, num_actions, num_outcomes, embedding_dim, bins, num_simulations,
      max_depth, len(dec_widths), _ints(dec_widths), len(ch_widths),
      _ints(ch_widths), len(pred_widths), _ints(pred_widths), plan.tile,
      plan.cluster, plan.n_resident, plan.ring, out)
  if err != 0:
    raise RuntimeError("fused SMZ search kernel: "
                       + lib.mz_smz_error_string(err).decode())
  return tuple(out)


def _smz_widths(weights: "FusedSMZWeights"):
  return [[w.shape[1] for w, _ in layers] for layers in (
      weights.dec_layers, weights.ch_layers, weights.pred_layers)]


def smz_launch_plan(root_embedding: torch.Tensor, weights: "FusedSMZWeights",
                    *, num_simulations: int, max_depth=None, **_
                    ) -> Union[SMZPlan, SMZWidePlan]:
  """The plan that ``fused_smz_search`` launches these inputs with (on
  ``root_embedding``'s card)."""
  B, E = root_embedding.shape
  A = weights.pred_policy[0].shape[1]
  C = weights.dec_chance[0].shape[1]
  bins = weights.pred_value[0].shape[1]
  max_depth = num_simulations if max_depth is None else max_depth
  n_weights = sum(w.numel() + b.numel() for w, b in weights.layers())
  widths = _smz_widths(weights)
  device = root_embedding.device
  index = device.index if device.index is not None else (
      torch.cuda.current_device())
  return smz_search_plan(B, A, C, E, bins, num_simulations, max_depth,
                         n_weights, max(max(w) for w in widths),
                         device_limits(device), towers=widths,
                         clusters=smz_wide_active_clusters(index))


def smz_blocks_per_sm(plan: SMZPlan, device: torch.device) -> int:
  """Blocks of ``plan`` that one SM of ``device`` holds at once, as the CUDA
  runtime reckons it from the compiled kernel (its registers included)."""
  index = device.index if device.index is not None else (
      torch.cuda.current_device())
  out = ctypes.c_int(0)
  lib = _load_smz_kernel()
  err = lib.mz_smz_blocks_per_sm(plan.envs_per_block, int(plan.smem_tree),
                                 plan.smem_bytes, index, ctypes.byref(out))
  if err != 0:
    raise RuntimeError("fused SMZ search kernel: "
                       + lib.mz_smz_error_string(err).decode())
  return out.value


def _load_smz_kernel():
  lib = _build.load("fused_smz")
  fn = lib.mz_fused_smz_search
  if fn.argtypes is None:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    i64 = ctypes.c_long
    towers = [i32, ptr, i32, ptr, i32, ptr, i32, ptr]  # widths, device, stream
    fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, ptr, i64, i32, i32, i32,
                   i64, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
                   i32, i32, f32, f32, f32] + towers
    fn.restype = i32
    lib.mz_fused_smz_wide_search.argtypes = [
        ptr, ptr, ptr, ptr, ptr, i64, ptr, i64, i32, i32, i32, i32,
        ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32, f32, f32,
        f32] + towers
    lib.mz_smz_wide_layout.argtypes = [i32] * 7 + [i32, ptr] * 3 + [i32] * 4 \
        + [ptr]
    lib.mz_smz_wide_active_clusters.argtypes = [i32, i32, i64, i32, ptr]
    for f in (lib.mz_fused_smz_wide_search, lib.mz_smz_wide_layout,
              lib.mz_smz_wide_active_clusters):
      f.restype = i32
    lib.mz_smz_env_bytes.argtypes = [i32] * 7 + [ptr]
    lib.mz_smz_env_bytes.restype = None
    lib.mz_smz_blocks_per_sm.argtypes = [i32, i32, i64, i32, ptr]
    lib.mz_smz_blocks_per_sm.restype = i32
    lib.mz_smz_error_string.argtypes = [i32]
    lib.mz_smz_error_string.restype = ctypes.c_char_p
  return lib


def _fused_smz_search_cuda(root_embedding, root_prior_logits, root_value,
                           weights: FusedSMZWeights, *, num_simulations,
                           support_size, discount, invalid_actions,
                           max_depth, pb_c_init, pb_c_base):
  """Launch ``csrc/fused_smz.cu`` on the current stream, laid out by
  ``smz_search_plan``: ``fused_smz_kernel``, or for towers wider than a
  block's shared memory the tile kernel on the towers packed by rank."""
  global smz_launches, smz_wide_launches
  device = root_embedding.device
  B, E = root_embedding.shape
  A = root_prior_logits.shape[-1]
  C = weights.dec_chance[0].shape[1]
  S41 = 2 * support_size + 1
  _check("root_embedding", root_embedding, (B, E), device)
  _check("root_prior_logits", root_prior_logits, (B, A), device)
  _check("root_value", root_value, (B,), device)
  if invalid_actions is not None:
    _check("invalid_actions", invalid_actions, (B, A), device)
  flat = weights.flat()
  _check("weights", flat, flat.shape, device)
  widths = _smz_widths(weights)
  if not all(widths) or (
      weights.dec_layers[0][0].shape[0] != E + A
      or weights.ch_layers[0][0].shape[0] != E + C
      or weights.pred_layers[0][0].shape[0] != E
      or weights.dec_state[0].shape[1] != E
      or weights.ch_state[0].shape[1] != E
      or weights.pred_policy[0].shape[1] != A
      or {weights.dec_value[0].shape[1], weights.ch_reward[0].shape[1],
          weights.pred_value[0].shape[1]} != {S41}):
    raise ValueError("weights do not fit the root shapes and support size")

  lib = _load_smz_kernel()
  visits = torch.empty((B, A), dtype=torch.float32, device=device)
  value = torch.empty((B,), dtype=torch.float32, device=device)
  qvalues = torch.empty((B, A), dtype=torch.float32, device=device)
  plan = smz_launch_plan(root_embedding, weights,
                         num_simulations=num_simulations, max_depth=max_depth)
  max_depth = num_simulations if max_depth is None else max_depth
  wide = isinstance(plan, SMZWidePlan)
  n_scratch = B * plan.scratch_bytes
  scratch = torch.empty((n_scratch,), dtype=torch.uint8, device=device)
  roots = (root_embedding.data_ptr(), root_prior_logits.data_ptr(),
           root_value.data_ptr(),
           None if invalid_actions is None else invalid_actions.data_ptr())
  outs = (visits.data_ptr(), value.data_ptr(), qvalues.data_ptr(),
          B, A, C, E, S41, support_size, num_simulations, max_depth, discount,
          pb_c_init, pb_c_base,
          len(widths[0]), _ints(widths[0]), len(widths[1]), _ints(widths[1]),
          len(widths[2]), _ints(widths[2]),
          device.index if device.index is not None
          else torch.cuda.current_device(),
          torch.cuda.current_stream(device).cuda_stream)
  if wide:
    pack = pack_smz_wide_towers(flat, plan.cluster, A, C, E, S41, *widths)
    err = lib.mz_fused_smz_wide_search(
        *roots, pack.data_ptr(), pack.numel(), scratch.data_ptr(), n_scratch,
        plan.tile, plan.cluster, plan.n_resident, plan.ring, *outs)
  else:
    err = lib.mz_fused_smz_search(
        *roots, flat.data_ptr(), flat.numel(),
        scratch.data_ptr() if n_scratch else None, n_scratch,
        plan.envs_per_block, int(plan.smem_tree), int(plan.smem_emb),
        plan.smem_bytes, *outs)
  if err != 0:
    raise RuntimeError("fused SMZ search kernel: "
                       + lib.mz_smz_error_string(err).decode())
  smz_launches += 1
  smz_wide_launches += wide
  return visits, value, qvalues


def fused_smz_search(
    root_embedding: torch.Tensor,      # [B, E]
    root_prior_logits: torch.Tensor,   # [B, A] decision logits (noised)
    root_value: torch.Tensor,          # [B]
    weights: FusedSMZWeights,
    *,
    num_simulations: int,
    support_size: int,
    discount: float,
    invalid_actions: Optional[torch.Tensor] = None,
    max_depth: Optional[int] = None,
    pb_c_init: float = 1.25,
    pb_c_base: float = 19652.0,
):
  """Run the fused Stochastic MuZero search. Returns (decision
  visit_counts [B, A] f32, root_value [B], decision q [B, A]).

  CUDA tensors go to the kernel (or the call raises); CPU tensors go to the
  plain version.
  """
  return _dispatch(_fused_smz_search_cuda, fused_smz_search_reference,
                   root_embedding, root_prior_logits, root_value, weights,
                   num_simulations=num_simulations,
                   support_size=support_size, discount=discount,
                   invalid_actions=invalid_actions, max_depth=max_depth,
                   pb_c_init=pb_c_init, pb_c_base=pb_c_base)


def fused_smz_policy(
    params: SMZParams,
    generator: torch.Generator,
    root,                      # RootFnOutput of the decision root
    weights: FusedSMZWeights,
    *,
    num_simulations: int,
    support_size: int,
    discount: float,
    invalid_actions: Optional[torch.Tensor] = None,
    max_depth: Optional[int] = None,
    dirichlet_fraction: float = 0.25,
    dirichlet_alpha: float = 0.3,
    pb_c_init: float = 1.25,
    pb_c_base: float = 19652.0,
    temperature=1.0,
):
  """``policies.stochastic_muzero_policy`` on the fused search: the same
  root noising, the decision visits as the action weights,
  visit-count^(1/T) action. Returns (action [B] int32, action_weights
  [B, A], root_value [B])."""
  del params
  noised_logits = noised_root_logits(
      generator, root.prior_logits, invalid_actions,
      dirichlet_fraction=dirichlet_fraction, dirichlet_alpha=dirichlet_alpha)
  visit_counts, root_value, _ = fused_smz_search(
      root.embedding.contiguous(), noised_logits, root.value.contiguous(),
      weights, num_simulations=num_simulations, support_size=support_size,
      discount=discount, invalid_actions=invalid_actions,
      max_depth=max_depth, pb_c_init=pb_c_init, pb_c_base=pb_c_base)
  total = torch.sum(visit_counts, dim=-1, keepdim=True)
  action_weights = torch.where(
      total > 0, visit_counts / torch.clamp(total, min=1.0),
      torch.full_like(visit_counts, 1.0 / visit_counts.shape[-1]))
  action_logits = _apply_temperature(_get_logits_from_probs(action_weights),
                                     temperature)
  action = torch.multinomial(torch.softmax(action_logits, dim=-1), 1,
                             generator=generator)[:, 0]
  return action.to(torch.int32), action_weights, root_value
