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
from typing import NamedTuple, Optional, Tuple

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
categorical_launches = 0         # categorical family, policy="muzero"
categorical_gumbel_launches = 0  # categorical family, policy="gumbel"
smz_launches = 0                 # Stochastic MuZero forest (csrc/fused_smz.cu)

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
    # emb scratch, G, envs, embeddings' place, weights' place
    plan = [ptr, ctypes.c_long, i32, i32, i32, i32]
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
    lib.mz_mlp_blocks_per_sm.argtypes = [i32, i32, i32, i32, ctypes.c_long,
                                         i32, ptr]
    for fn in (lib.mz_fused_muzero_search, lib.mz_fused_gumbel_search,
               lib.mz_fused_tiled_search, lib.mz_mlp_blocks_per_sm):
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
  """How an MLP-mode launch runs: ``group`` lanes per environment,
  ``envs_per_block`` environments a block, the embeddings in shared memory
  (``smem_emb``) or in a device scratch; ``grid`` blocks, of which an SM
  holds ``blocks_per_sm`` at once, ``warps_per_sm`` on the busiest SM, and
  whether every block is resident in one wave; the towers staged in each
  block's shared memory (``smem_weights``) or read from device memory,
  which L2 holds (towers wider than a block's shared memory)."""
  group: int
  envs_per_block: int
  smem_emb: bool
  grid: int
  blocks_per_sm: int
  warps_per_sm: int
  resident: bool
  smem_weights: bool = True


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
  """Shared memory of one block: the towers (``n_weights`` floats, 0 where
  they stay in device memory), then each environment's slice."""
  return 4 * (-(-n_weights // 4) * 4 + envs_per_block * env_floats)


def _mlp_candidate(batch, group, smem_emb, env_floats, n_weights,
                   limits: DeviceLimits, smem_weights=True
                   ) -> Optional[MLPPlan]:
  """The launch with G = ``group``: 256 threads a block, halved while the
  block's shared memory does not fit or the grid would leave SMs without
  a block, and while halving lets an SM hold more environments of a
  launch that does not fit the card at once; down to one warp. None when
  one warp's environments do not fit. Without ``smem_weights`` the towers
  take no shared memory."""
  least = max(1, 32 // group)
  staged = n_weights if smem_weights else 0

  def plan(envs):
    size = mlp_smem_bytes(staged, envs, env_floats)
    if size > limits.smem_per_block:
      return None
    threads = envs * group
    per_sm = min(_SM_BLOCKS, _SM_THREADS // threads,
                 limits.regs_per_sm // (_MLP_REGISTERS[group] * threads),
                 limits.smem_per_sm // (size + limits.smem_reserved))
    grid = -(-batch // envs)
    busiest = min(per_sm, -(-grid // limits.sms))
    return MLPPlan(group, envs, smem_emb, grid, per_sm,
                   busiest * threads // 32, grid <= per_sm * limits.sms,
                   smem_weights)

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
                    group: Optional[int] = None) -> MLPPlan:
  """The MLP modes' launch plan. Among the launches that keep every
  environment resident in one wave, the smallest G that still gives the
  busiest SM ``MLP_TARGET_WARPS`` warps (fewer lanes per environment waste
  fewer lanes), else the largest G (the most warps); the embeddings in
  shared memory where that keeps them all resident. Where no launch keeps
  them all, the most environments resident per SM, then the largest G.
  The towers are staged in shared memory where some launch fits them there
  beside one warp's environments; else every launch reads them from device
  memory (``smem_weights`` False; the 2048 example's towers (256, 256) at
  601 bins are 1.97 MB) and the same rules choose among those.
  ``widths``: the bins and every hidden layer's width; ``group`` fixes G
  (for timing each). Raises RuntimeError where one environment's tree
  alone does not fit a block's shared memory, as the kernel would. The
  plan of a shape is worked out once and kept."""
  return _mlp_search_plan(batch, num_actions, embedding_dim,
                          num_simulations, n_weights, tuple(widths), gumbel,
                          limits, group)


@functools.lru_cache(maxsize=None)
def _mlp_search_plan(batch, num_actions, embedding_dim, num_simulations,
                     n_weights, widths, gumbel, limits, group) -> MLPPlan:
  act_width = mlp_act_width(num_actions, embedding_dim, widths)
  plans = []
  for smem_weights in (True, False):
    for g in (MLP_GROUPS if group is None else (group,)):
      for smem_emb in (True, False):
        floats = mlp_env_floats(num_actions, embedding_dim, num_simulations,
                                act_width, gumbel, smem_emb)
        plan = _mlp_candidate(batch, g, smem_emb, floats, n_weights, limits,
                              smem_weights)
        if plan is not None:
          plans.append(plan)
    if plans:
      break
  if not plans:
    raise RuntimeError("fused search kernel: shapes do not fit the fused "
                       "search kernel (one environment's tree exceeds a "
                       "block's shared memory)")
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
  staged = n_weights if plan.smem_weights else 0
  err = lib.mz_mlp_blocks_per_sm(
      int(gumbel), plan.group, int(plan.smem_weights),
      plan.envs_per_block * plan.group,
      mlp_smem_bytes(staged, plan.envs_per_block, env_floats), index,
      ctypes.byref(out))
  if err != 0:
    raise RuntimeError("fused search kernel: "
                       + lib.mz_error_string(err).decode())
  return out.value


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
  (lane groups per environment, the towers staged in shared memory or read
  from device memory, laid out by ``mlp_search_plan``), a ``FusedNetSpec``
  the categorical
  modes (clusters of blocks per tile of environments, tensor-core products
  over weights read from device memory);
  ``root_score`` and ``schedule`` select the Gumbel policy."""
  global launches, gumbel_launches
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
                           device_limits(device))
    n_scratch = 0 if plan.smem_emb else B * (num_simulations + 1) * E
    scratch = torch.empty((n_scratch,), dtype=torch.float32, device=device)
    buffers = (flat.data_ptr(), flat.numel(),
               scratch.data_ptr() if n_scratch else None, n_scratch,
               plan.group, plan.envs_per_block, int(plan.smem_emb),
               int(plan.smem_weights), visits.data_ptr(), value.data_ptr(),
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
  else:
    launches += 1
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


# The Stochastic MuZero launch (``fused_smz_kernel<smem_tree,
# smem_weights>``): four warps an environment and one to three environments
# a block (its ``__launch_bounds__(384, 1)``: at most 168 registers a
# thread; ``ptxas`` gives each instance fewer, ``_SMZ_REGISTERS``), the
# three towers staged once per block in shared memory where
# they fit beside one environment, else read from device memory (the 2048
# example's widths: 762,031 floats). Each environment's compact
# tree (a float4 per node: visits, value, reward, and the PUCT prior scale
# or the children's visits; per slot of a row of max(A, C) the child index
# and prior; the last descent's path) and its embeddings [N, E] lie in
# shared memory where the block has room, else in a device scratch; the
# work buffers always in shared memory.
SMZ_ENV_THREADS = 128
SMZ_MAX_ENVS = 3
# Registers a thread of each instance, by (smem_tree, smem_weights), as
# ``ptxas`` reports them for sm_90a (chip_smoke.py phase 0); an SM allocates
# them in steps of 8 a thread. ``smz_blocks_per_sm`` reads the CUDA
# runtime's count for the compiled kernel, and the gpu tests hold the two
# to agree.
_SMZ_REGISTERS = {(True, True): 119, (True, False): 128, (False, True): 128,
                  (False, False): 146}
_SMZ_MAX_NODES = 32767  # int16 node indices


class SMZPlan(NamedTuple):
  """How a Stochastic MuZero launch runs: ``envs_per_block`` environments a
  block, the trees (``smem_tree``) and the embeddings (``smem_emb``) in
  shared memory or in the device scratch; ``grid`` blocks, of which an SM
  holds ``blocks_per_sm`` at once, in ``waves`` waves; ``smem_bytes`` of
  shared memory a block and ``scratch_bytes`` of device scratch an
  environment; the towers staged in shared memory (``smem_weights``) or
  read from device memory."""
  envs_per_block: int
  smem_tree: bool
  smem_emb: bool
  grid: int
  blocks_per_sm: int
  waves: int
  smem_bytes: int
  scratch_bytes: int
  smem_weights: bool = True


def _round16(n: int) -> int:
  return -(-n // 16) * 16


def smz_env_bytes(num_actions: int, num_outcomes: int, embedding_dim: int,
                  bins: int, num_simulations: int, max_depth: int,
                  max_hidden: int) -> Tuple[int, int, int]:
  """Bytes of one environment's compact tree, work buffers and embeddings
  (the kernel's ``mz_smz_env_bytes``): the tree's float4 nodes (4 N
  floats) and priors (N K), int16 children (N K) and path (min(max_depth, sims) +
  1); the buffers X [E], two hidden [max_hidden], Y [E + C + bins], Z [A +
  bins] and the invalid mask [A], each rounded up to 4 floats, and 8
  control words; the embeddings [N, E]."""
  A, C, E = num_actions, num_outcomes, embedding_dim
  n, k = num_simulations + 1, max(num_actions, num_outcomes)
  path = min(max_depth, num_simulations) + 1
  tree = _round16(4 * (4 * n + n * k) + 2 * (n * k + path))
  floats = sum(-(-f // 4) * 4 for f in (
      E, max_hidden, max_hidden, E + C + bins, A + bins, A)) + 8
  return tree, 4 * floats, _round16(4 * n * E)


def smz_search_plan(batch: int, num_actions: int, num_outcomes: int,
                    embedding_dim: int, bins: int, num_simulations: int,
                    max_depth: int, n_weights: int, max_hidden: int,
                    limits: DeviceLimits) -> SMZPlan:
  """The Stochastic MuZero launch plan. The towers staged in shared memory
  where some plan fits them there beside one environment's work buffers;
  else every plan reads them from device memory (``smem_weights`` False)
  and the same rules choose among those: the trees in shared memory where
  one fits a block (a level of a walk is then a shared-memory access, not
  an L2 round trip), then the fewest waves, then the embeddings in shared
  memory, then the fewest environments a block (the most SMs at work).
  Raises RuntimeError where one environment's work buffers alone exceed a
  block's shared memory (its tree can go to the device scratch), or the
  tree's nodes pass int16, as the kernel would. The plan of a shape is
  worked out once and kept."""
  return _smz_search_plan(batch, num_actions, num_outcomes, embedding_dim,
                          bins, num_simulations, max_depth, n_weights,
                          max_hidden, limits)


@functools.lru_cache(maxsize=None)
def _smz_search_plan(batch, num_actions, num_outcomes, embedding_dim, bins,
                     num_simulations, max_depth, n_weights, max_hidden,
                     limits) -> SMZPlan:
  if num_simulations + 1 > _SMZ_MAX_NODES:
    raise RuntimeError("fused SMZ search kernel: shapes do not fit the "
                       f"kernel ({num_simulations} simulations pass its "
                       "int16 node indices)")
  tree, work, emb = smz_env_bytes(num_actions, num_outcomes, embedding_dim,
                                  bins, num_simulations, max_depth,
                                  max_hidden)
  best = None
  for smem_weights in (True, False):
    weights = 16 * -(-n_weights // 4) if smem_weights else 0
    for smem_tree, smem_emb in ((True, True), (True, False), (False, False)):
      env_smem = work + tree * smem_tree + emb * smem_emb
      for envs in range(1, SMZ_MAX_ENVS + 1):
        size = weights + envs * env_smem
        if size > limits.smem_per_block:
          break
        threads = envs * SMZ_ENV_THREADS
        regs = -(-_SMZ_REGISTERS[smem_tree, smem_weights] // 8) * 8
        per_sm = min(_SM_BLOCKS, _SM_THREADS // threads,
                     limits.regs_per_sm // (regs * threads),
                     limits.smem_per_sm // (size + limits.smem_reserved))
        grid = -(-batch // envs)
        waves = -(-grid // (per_sm * limits.sms))
        plan = SMZPlan(envs, smem_tree, smem_emb, grid, per_sm, waves, size,
                       tree * (not smem_tree) + emb * (not smem_emb),
                       smem_weights)
        key = (not smem_tree, waves, not smem_emb, envs)
        if best is None or key < best[0]:
          best = (key, plan)
    if best is not None:
      return best[1]
  raise RuntimeError("fused SMZ search kernel: shapes do not fit the "
                     "kernel (one environment's work buffers exceed a "
                     "block's shared memory)")


def _smz_widths(weights: "FusedSMZWeights"):
  return [[w.shape[1] for w, _ in layers] for layers in (
      weights.dec_layers, weights.ch_layers, weights.pred_layers)]


def smz_launch_plan(root_embedding: torch.Tensor, weights: "FusedSMZWeights",
                    *, num_simulations: int, max_depth=None, **_) -> SMZPlan:
  """The plan that ``fused_smz_search`` launches these inputs with (on
  ``root_embedding``'s card)."""
  B, E = root_embedding.shape
  A = weights.pred_policy[0].shape[1]
  C = weights.dec_chance[0].shape[1]
  bins = weights.pred_value[0].shape[1]
  max_depth = num_simulations if max_depth is None else max_depth
  n_weights = sum(w.numel() + b.numel() for w, b in weights.layers())
  return smz_search_plan(B, A, C, E, bins, num_simulations, max_depth,
                         n_weights, max(max(w) for w in _smz_widths(weights)),
                         device_limits(root_embedding.device))


def smz_blocks_per_sm(plan: SMZPlan, device: torch.device) -> int:
  """Blocks of ``plan`` that one SM of ``device`` holds at once, as the CUDA
  runtime reckons it from the compiled kernel (its registers included)."""
  index = device.index if device.index is not None else (
      torch.cuda.current_device())
  out = ctypes.c_int(0)
  lib = _load_smz_kernel()
  err = lib.mz_smz_blocks_per_sm(plan.envs_per_block, int(plan.smem_tree),
                                 int(plan.smem_weights), plan.smem_bytes,
                                 index, ctypes.byref(out))
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
    fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, ptr, i64, i32, i32, i32,
                   i32, i64, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
                   i32, i32, f32, f32, f32, i32, ptr, i32, ptr, i32, ptr,
                   i32, ptr]
    fn.restype = i32
    lib.mz_smz_env_bytes.argtypes = [i32] * 7 + [ptr]
    lib.mz_smz_env_bytes.restype = None
    lib.mz_smz_blocks_per_sm.argtypes = [i32, i32, i32, i64, i32, ptr]
    lib.mz_smz_blocks_per_sm.restype = i32
    lib.mz_smz_error_string.argtypes = [i32]
    lib.mz_smz_error_string.restype = ctypes.c_char_p
  return lib


def _fused_smz_search_cuda(root_embedding, root_prior_logits, root_value,
                           weights: FusedSMZWeights, *, num_simulations,
                           support_size, discount, invalid_actions,
                           max_depth, pb_c_init, pb_c_base):
  """Launch ``csrc/fused_smz.cu`` on the current stream, laid out by
  ``smz_search_plan``."""
  global smz_launches
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
  n_scratch = B * plan.scratch_bytes
  scratch = torch.empty((n_scratch,), dtype=torch.uint8, device=device)
  err = lib.mz_fused_smz_search(
      root_embedding.data_ptr(), root_prior_logits.data_ptr(),
      root_value.data_ptr(),
      None if invalid_actions is None else invalid_actions.data_ptr(),
      flat.data_ptr(), flat.numel(),
      scratch.data_ptr() if n_scratch else None, n_scratch,
      plan.envs_per_block, int(plan.smem_tree), int(plan.smem_emb),
      int(plan.smem_weights), plan.smem_bytes, visits.data_ptr(),
      value.data_ptr(),
      qvalues.data_ptr(),
      B, A, C, E, S41, support_size, num_simulations, max_depth, discount,
      pb_c_init, pb_c_base,
      len(widths[0]), _ints(widths[0]), len(widths[1]), _ints(widths[1]),
      len(widths[2]), _ints(widths[2]),
      device.index if device.index is not None
      else torch.cuda.current_device(),
      torch.cuda.current_stream(device).cuda_stream)
  if err != 0:
    raise RuntimeError("fused SMZ search kernel: "
                       + lib.mz_smz_error_string(err).decode())
  smz_launches += 1
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
