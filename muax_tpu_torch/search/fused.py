"""Fused search: every simulation of every environment as one kernel.

The port of ``muax_tpu/search/fused.py`` for the MLP triplet, in its two
policy modes: MuZero PUCT and Gumbel MuZero. On a CUDA tensor,
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
child, h-support decode, min-max normalized next states, running-mean
install and backup. The backup starts from the raw network value of the
expanded node, as the JAX kernel's does.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from muax_tpu_torch import _build
from muax_tpu_torch.models.networks import MZNetworks, MZParams
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
launches = 0         # policy="muzero"
gumbel_launches = 0  # policy="gumbel"

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


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _decode(logits: torch.Tensor, support_size: int) -> torch.Tensor:
  """[B, 2S+1] logits -> softmax expectation over -S..S -> h^-1."""
  probs = torch.softmax(logits, dim=-1)
  bins = torch.arange(-support_size, support_size + 1, dtype=logits.dtype,
                      device=logits.device)
  return inv_value_transform(torch.sum(probs * bins, dim=-1))


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


def _plain_search(root_embedding, root_prior_logits, root_value,
                  weights: FusedMLPWeights, *, num_simulations, support_size,
                  discount, invalid_actions, max_depth, pb_c_init=1.25,
                  pb_c_base=19652.0, root_score=None, schedule=None):
  """Both modes of the plain version, batched over [B, N] and [B, N, A]
  tensors with a lockstep descent. ``root_score`` and ``schedule`` select
  the Gumbel mode."""
  gumbel = root_score is not None
  B, E = root_embedding.shape
  A = root_prior_logits.shape[-1]
  N = num_simulations + 1
  if max_depth is None:
    max_depth = num_simulations
  dev = root_embedding.device
  f32 = torch.float32
  rows = torch.arange(B, device=dev)
  invalid = (torch.zeros(B, A, dtype=f32, device=dev)
             if invalid_actions is None else invalid_actions.to(f32))

  nvis = torch.zeros(B, N, dtype=f32, device=dev)
  nvis[:, 0] = 1.0
  nval = torch.zeros(B, N, dtype=f32, device=dev)
  nval[:, 0] = root_value.to(f32)
  nraw = nval.clone()
  npar = torch.full((B, N), -1, dtype=torch.long, device=dev)
  nact = torch.full((B, N), -1, dtype=torch.long, device=dev)
  cidx = torch.full((B, N, A), -1, dtype=torch.long, device=dev)
  cpri = torch.zeros(B, N, A, dtype=f32, device=dev)
  cpri[:, 0] = torch.softmax(root_prior_logits.to(f32), dim=-1)
  cvis = torch.zeros(B, N, A, dtype=f32, device=dev)
  crew = torch.zeros(B, N, A, dtype=f32, device=dev)
  cval = torch.zeros(B, N, A, dtype=f32, device=dev)
  embs = torch.zeros(B, N, E, dtype=f32, device=dev)
  embs[:, 0] = root_embedding.to(f32)

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

  def tower(x, hidden):
    for w, b in hidden:
      x = _elu(x @ w + b)
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
    x = torch.cat([embs[rows, parent], F.one_hot(act, A).to(f32)], -1)
    h = tower(x, weights.dyn_hidden)
    reward = _decode(h @ weights.dyn_reward[0] + weights.dyn_reward[1],
                     support_size)
    ns = h @ weights.dyn_state[0] + weights.dyn_state[1]
    ns_min = ns.amin(-1, keepdim=True)
    ns_max = ns.amax(-1, keepdim=True)
    ns = (ns - ns_min) / torch.clamp(ns_max - ns_min, min=1e-8)
    g = tower(ns, weights.pred_hidden)
    value = _decode(g @ weights.pred_value[0] + weights.pred_value[1],
                    support_size)
    pol = torch.softmax(g @ weights.pred_policy[0] + weights.pred_policy[1],
                        dim=-1)

    # Install (running mean; a re-evaluated node's raw value is replaced).
    count = nvis[rows, slot]
    nval[rows, slot] = (nval[rows, slot] * count + value) / (count + 1.0)
    nvis[rows, slot] = count + 1.0
    nraw[rows, slot] = value
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
      cvis[rows, par, a_b] = cvis[rows, par, a_b] + on.to(f32)
      v = torch.where(on, vnew, v)
      idx = torch.where(on, par, idx)

  if gumbel:
    root_q, _, _ = completed_q(torch.zeros_like(rows))
  else:
    root_q = crew[:, 0] + discount * cval[:, 0]
  return cvis[:, 0], nval[:, 0], root_q


def fused_muzero_search_reference(
    root_embedding: torch.Tensor,      # [B, E]
    root_prior_logits: torch.Tensor,   # [B, A] (noise/masking applied)
    root_value: torch.Tensor,          # [B]
    weights: FusedMLPWeights,
    *,
    num_simulations: int,
    support_size: int,
    discount: float,
    invalid_actions: Optional[torch.Tensor] = None,
    max_depth: Optional[int] = None,
    pb_c_init: float = 1.25,
    pb_c_base: float = 19652.0,
):
  """Plain PyTorch version of the fused MuZero search. Returns
  (visit_counts [B, A], root_value [B], root_qvalues [B, A]), all f32."""
  return _plain_search(root_embedding, root_prior_logits, root_value,
                       weights, num_simulations=num_simulations,
                       support_size=support_size, discount=discount,
                       invalid_actions=invalid_actions, max_depth=max_depth,
                       pb_c_init=pb_c_init, pb_c_base=pb_c_base)


def fused_gumbel_search_reference(
    root_embedding: torch.Tensor,      # [B, E]
    root_prior_logits: torch.Tensor,   # [B, A] masked logits, no noise
    root_value: torch.Tensor,          # [B]
    weights: FusedMLPWeights,
    *,
    root_score: torch.Tensor,          # [B, A] gumbel + masked logits
    schedule: torch.Tensor,            # [B, num_simulations] f32 visits
    num_simulations: int,
    support_size: int,
    discount: float,
    invalid_actions: Optional[torch.Tensor] = None,
    max_depth: Optional[int] = None,
):
  """Plain PyTorch version of the fused Gumbel MuZero search (the kernel's
  inputs: ``gumbel_root_inputs`` makes ``root_score`` and ``schedule``).
  Returns (visit_counts [B, A], root_value [B], root_completed_q [B, A])."""
  return _plain_search(root_embedding, root_prior_logits, root_value,
                       weights, num_simulations=num_simulations,
                       support_size=support_size, discount=discount,
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
    lib.mz_fused_muzero_search.argtypes = [
        ptr, ptr, ptr, ptr, ptr, i32, ptr, ptr, ptr,
        i32, i32, i32, i32, i32, i32, i32, f32, f32, f32] + tail
    lib.mz_fused_gumbel_search.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, ptr, ptr, ptr,
        i32, i32, i32, i32, i32, i32, i32, f32] + tail
    lib.mz_fused_muzero_search.restype = i32
    lib.mz_fused_gumbel_search.restype = i32
    lib.mz_error_string.argtypes = [i32]
    lib.mz_error_string.restype = ctypes.c_char_p
  return lib


def _check(name: str, t: torch.Tensor, shape, device: torch.device):
  if t.device != device or t.dtype != torch.float32:
    raise ValueError(f"{name}: expected float32 on {device}, got {t.dtype} "
                     f"on {t.device}")
  if tuple(t.shape) != tuple(shape):
    raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                     f"{tuple(t.shape)}")
  if not t.is_contiguous():
    raise ValueError(f"{name}: expected a contiguous tensor")


def _fused_search_cuda(root_embedding, root_prior_logits, root_value,
                       weights: FusedMLPWeights, *, num_simulations,
                       support_size, discount, invalid_actions, max_depth,
                       pb_c_init=1.25, pb_c_base=19652.0, root_score=None,
                       schedule=None):
  """Launch either mode of the kernel; ``root_score`` and ``schedule``
  select the Gumbel mode."""
  global launches, gumbel_launches
  device = root_embedding.device
  B, E = root_embedding.shape
  A = root_prior_logits.shape[-1]
  S41 = 2 * support_size + 1
  _check("root_embedding", root_embedding, (B, E), device)
  _check("root_prior_logits", root_prior_logits, (B, A), device)
  _check("root_value", root_value, (B,), device)
  if invalid_actions is not None:
    _check("invalid_actions", invalid_actions, (B, A), device)
  gumbel = root_score is not None
  if gumbel:
    _check("root_score", root_score, (B, A), device)
    _check("schedule", schedule, (B, num_simulations), device)
  flat = weights.flat()
  _check("weights", flat, flat.shape, device)
  dyn_width = [w.shape[1] for w, _ in weights.dyn_hidden]
  pred_width = [w.shape[1] for w, _ in weights.pred_hidden]
  if weights.dyn_hidden[0][0].shape[0] != E + A or (
      weights.dyn_reward[0].shape[1] != S41
      or weights.pred_value[0].shape[1] != S41
      or weights.dyn_state[0].shape[1] != E
      or weights.pred_policy[0].shape[1] != A):
    raise ValueError("weights do not fit the root shapes and support size")

  visits = torch.empty((B, A), dtype=torch.float32, device=device)
  value = torch.empty((B,), dtype=torch.float32, device=device)
  qvalues = torch.empty((B, A), dtype=torch.float32, device=device)
  lib = _load_kernel()
  roots = (root_embedding.data_ptr(), root_prior_logits.data_ptr(),
           root_value.data_ptr(),
           None if invalid_actions is None else invalid_actions.data_ptr())
  buffers = (flat.data_ptr(), flat.numel(), visits.data_ptr(),
             value.data_ptr(), qvalues.data_ptr(),
             B, A, E, S41, support_size, num_simulations,
             num_simulations if max_depth is None else max_depth, discount)
  tail = (len(dyn_width), (ctypes.c_int * len(dyn_width))(*dyn_width),
          len(pred_width), (ctypes.c_int * len(pred_width))(*pred_width),
          device.index if device.index is not None
          else torch.cuda.current_device(),
          torch.cuda.current_stream(device).cuda_stream)
  if gumbel:
    err = lib.mz_fused_gumbel_search(
        *roots, root_score.data_ptr(), schedule.data_ptr(), *buffers, *tail)
  else:
    err = lib.mz_fused_muzero_search(*roots, *buffers, pb_c_init, pb_c_base,
                                     *tail)
  if err != 0:
    raise RuntimeError("fused search kernel: "
                       + lib.mz_error_string(err).decode())
  if gumbel:
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
    weights: FusedMLPWeights,
    *,
    num_simulations: int,
    support_size: int,
    discount: float,
    invalid_actions: Optional[torch.Tensor] = None,
    max_depth: Optional[int] = None,
    pb_c_init: float = 1.25,
    pb_c_base: float = 19652.0,
):
  """Run the fused MuZero PUCT search. Returns (visit_counts [B, A] f32,
  root_value [B], root_qvalues [B, A]).

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
    weights: FusedMLPWeights,
    *,
    gumbel: torch.Tensor,              # [B, A] scaled Gumbel noise
    max_num_considered_actions: int,
    num_simulations: int,
    support_size: int,
    discount: float,
    invalid_actions: Optional[torch.Tensor] = None,
    max_depth: Optional[int] = None,
):
  """Run the fused Gumbel MuZero search (sequential-halving root,
  improved-policy interior, completed_by_mix_value). Returns
  (visit_counts [B, A], root_value [B], root_completed_q [B, A]).

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
    weights: FusedMLPWeights,
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
    weights: FusedMLPWeights,
    *,
    num_simulations: int,
    support_size: int,
    discount: float,
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
