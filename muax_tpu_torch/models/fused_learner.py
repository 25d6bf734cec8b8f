"""Fused MuZero learner: the K-step unrolled loss and its backward as one
kernel (``muax_tpu/models/fused_learner.py``): the MLP triplet
(``LearnerWeights``) and the acme categorical family (``LearnerSpec``:
LayerNorm-tanh first layers, linear [vmin, vmax] two-hot heads).

``fused_muzero_grad_raw`` reads the fused sampler's raw rows (the mode the
grouped learner takes) and ``fused_muzero_grad`` a ``Transition`` batch,
which it packs into the same rows: the kernel builds the two-hot targets and
the action one-hots itself, so both modes compute the same function. Both
return the gradient as one flat vector in the order of
``params.parameters()`` (the layout of ``optimizers.flat_parameters``) and
the ``LossMetrics`` of ``muzero_loss``, with the semantics of autograd over
``muzero_loss``.

On CUDA tensors they launch the hand-written kernels of
``csrc/fused_learner.cu``, each spec a pair on the tensor cores: the MLP
spec's tile pass (16 windows a block, laid out by ``mlp_learner_plan``) and
its finish pass, or the categorical spec's per-tile forward and backward
and its weight-gradient pass; on CPU tensors they run the plain version,
autograd over ``models/losses.py`` ``muzero_loss`` on the equivalent batch.
The kernel returns gradients directly and is never called under autograd.
The fc-resnet family has no kernel, as in the JAX package: its residual
blocks' backward is not hand-derived.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from muax_tpu_torch import _build
from muax_tpu_torch.models.acme_networks import CategoricalMZNetworks
from muax_tpu_torch.models.losses import LossMetrics, muzero_grad
from muax_tpu_torch.models.networks import MZNetworks, MZParams
from muax_tpu_torch.models.optimizers import flat_parameters
from muax_tpu_torch.replay.fused_sampler import RawLayout, make_raw_layout
from muax_tpu_torch.device import DeviceLimits, device_limits
from muax_tpu_torch.types import Transition

# Launches of the CUDA kernel, by mode; the plain version does not count.
launches = 0              # MLP triplet
wide_launches = 0         # of those, the cluster pass (towers past a block)
categorical_launches = 0  # categorical LearnerSpec


class LearnerWeights(NamedTuple):
  """The MLP triplet as the kernel reads it: hidden widths per tower and the
  flat parameter buffer (per linear W [out, in] then b, in the modules'
  parameter order)."""
  repr_layers: Tuple[int, ...]
  pred_layers: Tuple[int, ...]
  dyn_layers: Tuple[int, ...]
  obs_dim: int
  embedding_dim: int
  num_actions: int
  support_size: int
  flat: torch.Tensor


def extract_learner_weights(networks, params: MZParams
                            ) -> Optional[LearnerWeights]:
  """``LearnerWeights`` for the MLP triplet with integer-support heads and at
  least one hidden layer in prediction and dynamics; None for any other
  family. Moves the parameters into one flat buffer
  (``optimizers.flat_parameters``) if they are not there yet."""
  if not isinstance(networks, MZNetworks):
    return None
  rep = params.representation.linears()
  pred = params.prediction.linears()
  dyn = params.dynamic.linears()
  if len(pred) < 3 or len(dyn) < 3:
    return None
  A, E = networks.num_actions, rep[-1].out_features
  S41 = 2 * networks.support_size + 1
  ok = (pred[-2].out_features == S41 and pred[-1].out_features == A
        and dyn[-2].out_features == S41 and dyn[-1].out_features == E
        and dyn[0].in_features == E + A and pred[0].in_features == E)
  if not ok:
    return None
  return LearnerWeights(
      repr_layers=tuple(l.out_features for l in rep[:-1]),
      pred_layers=tuple(l.out_features for l in pred[:-2]),
      dyn_layers=tuple(l.out_features for l in dyn[:-2]),
      obs_dim=rep[0].in_features, embedding_dim=E, num_actions=A,
      support_size=networks.support_size, flat=flat_parameters(params))


class LearnerSpec(NamedTuple):
  """The acme categorical family as the kernel reads it: per tower the
  hidden layers' kinds ("ln_tanh" or "elu") and widths, and the flat
  parameter buffer in the modules' parameter order (haiku's creation
  order: per hidden layer W [out, in] and b, the first layer followed by
  its LayerNorm's scale and offset; then the heads: representation's
  embedding, prediction's policy and value, dynamics' reward and next
  state)."""
  repr_kinds: Tuple[str, ...]
  repr_layers: Tuple[int, ...]
  pred_kinds: Tuple[str, ...]
  pred_layers: Tuple[int, ...]
  dyn_kinds: Tuple[str, ...]
  dyn_layers: Tuple[int, ...]
  obs_dim: int
  embedding_dim: int
  num_actions: int
  num_bins: int
  vmin: float
  vmax: float
  flat: torch.Tensor


def extract_categorical_learner_spec(networks, params: MZParams
                                     ) -> Optional[LearnerSpec]:
  """``LearnerSpec`` for the acme categorical family (LayerNormMLP towers
  of at least one layer); None for any other family, the fc-resnet
  included. Moves the parameters into one flat buffer."""
  if not isinstance(networks, CategoricalMZNetworks) or (
      networks.family != "mlp" or not networks.layer_sizes):
    return None

  def program(tower):
    hidden = tower.hidden()
    return (tuple(kind for kind, _ in hidden),
            tuple(mods[0].out_features for _, mods in hidden))

  repr_kinds, repr_layers = program(params.representation.tower)
  pred_kinds, pred_layers = program(params.prediction.tower)
  dyn_kinds, dyn_layers = program(params.dynamic.tower)
  return LearnerSpec(
      repr_kinds=repr_kinds, repr_layers=repr_layers,
      pred_kinds=pred_kinds, pred_layers=pred_layers,
      dyn_kinds=dyn_kinds, dyn_layers=dyn_layers,
      obs_dim=params.representation.tower.hidden()[0][1][0].in_features,
      embedding_dim=networks.embedding_dim,
      num_actions=networks.num_actions, num_bins=networks.num_bins,
      vmin=networks.vmin, vmax=networks.vmax, flat=flat_parameters(params))


def extract_learner(networks, params: MZParams):
  """The kernel's view of ``networks``: ``LearnerWeights`` (MLP triplet),
  ``LearnerSpec`` (categorical family) or None (no kernel)."""
  return (extract_learner_weights(networks, params)
          or extract_categorical_learner_spec(networks, params))


def _finish_metrics(met, l2, coef, denom, rn0, priority_alpha):
  """Per-window sums [4, B] (value, policy, reward CE; v0) -> LossMetrics."""
  v_sum, p_sum, r_sum, v0 = met
  per_example = (r_sum + v_sum + p_sum) / denom
  total = torch.sum(coef * per_example * denom) + l2
  return LossMetrics(
      total=total,
      reward_loss=torch.mean(r_sum / denom),
      value_loss=torch.mean(v_sum / denom),
      policy_loss=torch.mean(p_sum / denom),
      l2_loss=l2,
      priorities=torch.abs(v0 - rn0) ** priority_alpha,
  )


# ---------------------------------------------------------------------------
# Plain PyTorch version: autograd over muzero_loss
# ---------------------------------------------------------------------------


def batch_from_raw(raw: torch.Tensor, coef: torch.Tensor,
                   lay: RawLayout) -> Transition:
  """The [B, K] ``Transition`` whose loss the raw rows stand for (``obs``
  holds the start observation only; ``done`` and ``value`` are not carried
  and no loss reads them). ``weight`` is ``coef * denom * B``."""
  K, A = lay.K, lay.A
  B = raw.shape[1]

  def rows(base, n):
    return raw[base:base + n].T

  denom = raw[lay.denom]
  return Transition(
      obs=rows(lay.obs, lay.O)[:, None, :],
      action=rows(lay.action, K).to(torch.int64),
      reward=rows(lay.reward, K),
      done=torch.zeros((B, K), dtype=torch.bool, device=raw.device),
      rn=rows(lay.rn, K),
      value=torch.zeros((B, K), device=raw.device),
      pi=rows(lay.pi, K * A).reshape(B, K, A),
      weight=coef * denom * B,
      mask=rows(lay.mask, K))


def fused_muzero_grad_raw_reference(params, raw, coef, raw_layout, networks,
                                    *, l2_coef=1e-4, gradient_scale=0.5,
                                    priority_alpha=0.5):
  """Plain version of the raw mode: autograd over ``muzero_loss`` on
  ``batch_from_raw``."""
  return muzero_grad(params, batch_from_raw(raw, coef, raw_layout),
                       networks, l2_coef=l2_coef,
                       gradient_scale=gradient_scale,
                       priority_alpha=priority_alpha)


def fused_muzero_grad_reference(params, batch, networks, *, l2_coef=1e-4,
                                gradient_scale=0.5, priority_alpha=0.5,
                                num_unroll_steps=None):
  """Plain version of the batch mode: autograd over ``muzero_loss``."""
  return muzero_grad(params, batch, networks, l2_coef=l2_coef,
                       gradient_scale=gradient_scale,
                       priority_alpha=priority_alpha,
                       num_unroll_steps=num_unroll_steps)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


def _load_kernel():
  lib = _build.load("fused_learner")
  fn = lib.mz_fused_muzero_grad
  if fn.argtypes is None:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    i64 = ctypes.c_long
    fn.argtypes = ([ptr, i32, ptr, ptr, i32, ptr, ptr, ptr, ptr, i64, i32,
                    i32, i32, i64] + [i32] * 7 + [i32, ptr, i32, ptr, i32, ptr]
                   + [i32] * 6 + [f32, f32, i32, ptr])
    fn.restype = i32
    lib.mz_mlp_learner_floats.argtypes = ([i32] * 5 + [i32, ptr] * 3
                                          + [ptr])
    lib.mz_mlp_learner_floats.restype = i32
    lib.mz_learner_blocks_per_sm.argtypes = [i32, i32, i64, i32, ptr]
    lib.mz_learner_blocks_per_sm.restype = i32
    lib.mz_learner_active_clusters.argtypes = [i32, i32, ptr]
    lib.mz_learner_active_clusters.restype = i32
    lib.mz_learner_cluster_smem_bytes.argtypes = []
    lib.mz_learner_cluster_smem_bytes.restype = i64
    lib.mz_fused_categorical_grad.argtypes = (
        [ptr, i32, ptr, ptr, i32, ptr, ptr, ptr, ptr, ctypes.c_long, i32]
        + [i32] * 5 + [f32, f32, i32]
        + [i32, ptr, ptr] * 3 + [i32] * 6 + [f32, f32, i32, ptr])
    lib.mz_fused_categorical_grad.restype = i32
    lib.mz_categorical_scratch_floats.argtypes = (
        [i32] * 6 + [i32, ptr, ptr] * 3)
    lib.mz_categorical_scratch_floats.restype = ctypes.c_long
    lib.mz_learner_error_string.argtypes = [i32]
    lib.mz_learner_error_string.restype = ctypes.c_char_p
  return lib


def _check_raw(lw, raw: torch.Tensor, coef: torch.Tensor, lay: RawLayout):
  dev = raw.device
  B = raw.shape[1]
  if raw.dtype != torch.float32 or raw.dim() != 2 or raw.shape[0] != lay.rows:
    raise ValueError(f"raw: expected float32 [{lay.rows}, B], got "
                     f"{raw.dtype} {tuple(raw.shape)}")
  if raw.stride(1) != 1:
    raise ValueError("raw: expected rows with unit stride")
  if lay.O != lw.obs_dim or lay.A != lw.num_actions:
    raise ValueError("raw layout does not fit the networks")
  for name, t, shape in (("coef", coef, (B,)),
                         ("weights", lw.flat, tuple(lw.flat.shape))):
    if (t.device != dev or t.dtype != torch.float32
        or tuple(t.shape) != shape or not t.is_contiguous()):
      raise ValueError(f"{name}: expected contiguous float32 {shape} on "
                       f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


# The MLP spec's launch (``mlp_tile_kernel`` in csrc/fused_learner.cu): a
# block of ``LEARNER_THREADS`` threads per tile of ``LEARNER_TILE`` windows
# (the M of a tensor-core tile product), the towers' weights in shared
# memory where they fit (else in device memory), and at most two blocks an
# SM (its ``__launch_bounds__(256, 2)`` gives a thread 128 registers: two
# blocks fill the register file).
LEARNER_TILE = 16
LEARNER_THREADS = 256
_LEARNER_BLOCKS_PER_SM = 2
# Blocks a tile of the cluster pass (``mlp_cluster_kernel``), in the order
# the plan prefers them, and the shared memory of each block: its ring of
# three staged chunks of 4,096 floats and the split-k sums of 8 warp tiles
# (the kernel's ``mz_learner_cluster_smem_bytes``).
LEARNER_CLUSTERS = (8, 4, 2)
LEARNER_CLUSTER_SMEM = 4 * (3 * 4096 + 8 * 16 * 16)


class LearnerPlan(NamedTuple):
  """How an MLP-spec launch runs: ``blocks`` blocks, one tile each
  (``cluster`` 0) or ``cluster`` a tile; the arena (the forward's
  activations and the backward's gradients) in shared memory
  (``smem_arena``) or in the device scratch; ``smem_bytes`` of shared
  memory a block; ``scratch_floats`` of device scratch (the blocks' rows of
  weight gradients, then their arenas unless ``smem_arena``; with clusters
  the tiles' arenas alone); an SM holds ``blocks_per_sm`` blocks at once,
  and the busiest SM ``warps_per_sm`` warps (theoretical, capped by the
  grid). With clusters the towers' weights lie in device memory, and each
  block stages its columns' chunks through ``smem_bytes`` of shared
  memory."""
  blocks: int
  smem_arena: bool
  smem_bytes: int
  scratch_floats: int
  blocks_per_sm: int
  warps_per_sm: int
  cluster: int = 0


def learner_padded(n: int) -> int:
  """Floats of a row of n in the kernel's arena (its ``padded``): n padded
  to 4 mod 8, so that a tile product's lanes read distinct banks."""
  return 4 if n <= 4 else (n + 3) // 8 * 8 + 4


def _mlp_linears(lw):
  """(in, out, rows in tiles: 1 for the representation, K otherwise, and
  whether its gradient takes the place of its logits) of every linear, in
  the parameters' order."""
  E, A = lw.embedding_dim, lw.num_actions
  S41 = 2 * lw.support_size + 1
  out = []

  def tower(in_dim, hidden, heads, steps):
    for h in hidden:
      out.append((in_dim, h, steps, False))
      in_dim = h
    for h, softmax in heads:
      out.append((in_dim, h, steps, softmax))

  tower(lw.obs_dim, lw.repr_layers, ((E, False),), False)
  tower(E, lw.pred_layers, ((S41, True), (A, True)), True)
  tower(E + A, lw.dyn_layers, ((S41, True), (E, False)), True)
  return out


def mlp_learner_floats(lw, num_steps: int) -> Tuple[int, int, int]:
  """(parameters, shared-memory floats of the weights, floats of one
  block's arena) of the MLP spec with ``lw``'s shapes (``flat`` is not
  read) over ``num_steps`` unroll steps: the kernel's
  ``mz_mlp_learner_floats``. The arena holds, in rows of 16 windows (16 K
  for the steps), the start observations, the tile's raw rows of actions,
  rewards, returns, policies and masks and its coef, s_i with
  one_hot(a_i), the gradient into s_i, every linear's outputs and, but for
  the softmax heads, their gradients apart, and the cross-entropies and
  v0.

  A copy of the kernel's ``mlp_layout`` (with ``learner_padded`` and
  ``_mlp_linears``), so that the plan is sized without the library, as the
  CPU tests size it; ``test_plan_agrees_with_the_kernel``
  (tests/test_torch_fused_learner_kernel.py) ties the two together."""
  pad = learner_padded
  T, R = LEARNER_TILE, LEARNER_TILE * num_steps
  E, A = lw.embedding_dim, lw.num_actions
  n_weights = 0
  arena = (T * pad(lw.obs_dim) + (4 * num_steps + num_steps * A + 1) * T
           + R * pad(E + A) + R * pad(E) + 3 * R + T)
  for d_in, d_out, steps, softmax in _mlp_linears(lw):
    n_weights += (d_in + 1) * d_out
    arena += (R if steps else T) * pad(d_out) * (1 if softmax else 2)
  return n_weights, -(-n_weights // 4) * 4, -(-arena // 4) * 4


def _shapes(lw) -> tuple:
  return (lw.repr_layers, lw.pred_layers, lw.dyn_layers, lw.obs_dim,
          lw.embedding_dim, lw.num_actions, lw.support_size)


def mlp_learner_plan(batch: int, num_steps: int, lw,
                     limits: DeviceLimits) -> LearnerPlan:
  """The MLP spec's launch plan: one block per 16 windows; the arena in
  shared memory beside the weights where both fit a block, else in the
  device scratch; where the weights alone do not fit a block (the 2048
  example's towers (256, 256) at 601 bins, 2.3 MB), a cluster of blocks
  per 16 windows (``LEARNER_CLUSTERS``: the largest whose blocks the card
  holds at once, two an SM) with the arenas in the scratch and the weights
  in device memory, staged a chunk at a time. ``lw``: ``LearnerWeights``
  (only its shapes are read). The plan of a shape is worked out once and
  kept."""
  return _mlp_learner_plan(batch, num_steps, _shapes(lw), limits)


@functools.lru_cache(maxsize=None)
def _mlp_learner_plan(batch, num_steps, shapes, limits) -> LearnerPlan:
  n_weights, weights, arena = mlp_learner_floats(
      LearnerWeights(*shapes, flat=None), num_steps)
  tiles = -(-batch // LEARNER_TILE)
  for smem_arena in (True, False):
    smem = 4 * (weights + (arena if smem_arena else 0))
    if smem <= limits.smem_per_block:
      per_sm = min(_LEARNER_BLOCKS_PER_SM,
                   limits.smem_per_sm // (smem + limits.smem_reserved))
      busiest = min(per_sm, -(-tiles // limits.sms))
      return LearnerPlan(
          tiles, smem_arena, smem,
          tiles * (n_weights + (0 if smem_arena else arena)), per_sm,
          busiest * LEARNER_THREADS // 32)
  cluster = next((c for c in LEARNER_CLUSTERS
                  if tiles * c <= _LEARNER_BLOCKS_PER_SM * limits.sms),
                 LEARNER_CLUSTERS[-1])
  blocks = tiles * cluster
  smem = LEARNER_CLUSTER_SMEM
  per_sm = min(_LEARNER_BLOCKS_PER_SM,
               limits.smem_per_sm // (smem + limits.smem_reserved))
  busiest = min(per_sm, -(-blocks // limits.sms))
  return LearnerPlan(blocks, False, smem, tiles * arena, per_sm,
                     busiest * LEARNER_THREADS // 32, cluster)


def learner_blocks_per_sm(plan: LearnerPlan, device: torch.device) -> int:
  """Blocks of the plan's tile pass (or cluster pass) that one SM of
  ``device`` holds at once, by the CUDA occupancy calculator."""
  out = ctypes.c_int()
  lib = _load_kernel()
  err = lib.mz_learner_blocks_per_sm(
      int(plan.smem_arena), plan.cluster, plan.smem_bytes,
      _device_index(device), ctypes.byref(out))
  if err != 0:
    raise RuntimeError("fused learner kernel: "
                       + lib.mz_learner_error_string(err).decode())
  return out.value


def learner_active_clusters(plan: LearnerPlan, device: torch.device) -> int:
  """Clusters of the plan's cluster pass that ``device`` holds at once
  (``cudaOccupancyMaxActiveClusters``)."""
  out = ctypes.c_int()
  lib = _load_kernel()
  err = lib.mz_learner_active_clusters(plan.cluster, _device_index(device),
                                       ctypes.byref(out))
  if err != 0:
    raise RuntimeError("fused learner kernel: "
                       + lib.mz_learner_error_string(err).decode())
  return out.value


def _device_index(device: torch.device) -> int:
  return device.index if device.index is not None else (
      torch.cuda.current_device())


# Windows per block of the categorical kernel's first pass
# (``kCatTile`` in csrc/fused_learner.cu): 128 blocks at batch 1024.
CATEGORICAL_TILE = 8


def categorical_grad_blocks(batch: int) -> int:
  """Blocks of the categorical kernel's first pass over ``batch`` windows;
  each keeps its windows' activations in its own part of the scratch."""
  return -(-batch // CATEGORICAL_TILE)


def _categorical_grad_cuda(spec: LearnerSpec, raw: torch.Tensor,
                           coef: torch.Tensor, lay: RawLayout, *,
                           l2_coef: float, gradient_scale: float):
  """Launch the categorical learner (the per-tile forward and backward,
  then the weight-gradient pass); returns (grads [n], met [4, B], l2 [])."""
  global categorical_launches
  _check_raw(spec, raw, coef, lay)
  dev = raw.device
  B = raw.shape[1]
  lib = _load_kernel()
  n = spec.flat.numel()
  kind = {"elu": 0, "ln_tanh": 1}

  def tower(kinds, widths):
    return (len(widths), (ctypes.c_int * max(len(widths), 1))(*widths),
            (ctypes.c_int * max(len(kinds), 1))(*(kind[k] for k in kinds)))

  towers = (*tower(spec.repr_kinds, spec.repr_layers),
            *tower(spec.pred_kinds, spec.pred_layers),
            *tower(spec.dyn_kinds, spec.dyn_layers))
  shapes = (lay.O, spec.embedding_dim, spec.num_actions, spec.num_bins,
            lay.K)
  G = categorical_grad_blocks(B)
  n_scratch = lib.mz_categorical_scratch_floats(G, *shapes, *towers)
  if n_scratch < 0:
    raise RuntimeError("fused learner kernel: shapes do not fit the "
                       "categorical kernel")
  scratch = torch.empty((max(n_scratch, 1),), dtype=torch.float32,
                        device=dev)
  grads = torch.empty((n,), dtype=torch.float32, device=dev)
  met = torch.empty((4, B), dtype=torch.float32, device=dev)
  l2 = torch.empty((1,), dtype=torch.float32, device=dev)
  err = lib.mz_fused_categorical_grad(
      raw.data_ptr(), raw.stride(0), coef.data_ptr(), spec.flat.data_ptr(),
      n, grads.data_ptr(), met.data_ptr(), l2.data_ptr(), scratch.data_ptr(),
      n_scratch, G, B, *shapes[:4], spec.vmin,
      spec.vmax, lay.K, *towers,
      lay.obs, lay.action, lay.reward, lay.rn, lay.pi, lay.mask,
      gradient_scale, l2_coef,
      _device_index(dev),
      torch.cuda.current_stream(dev).cuda_stream)
  if err != 0:
    raise RuntimeError("fused learner kernel: "
                       + lib.mz_learner_error_string(err).decode())
  categorical_launches += 1
  return grads, met, l2[0]


@functools.lru_cache(maxsize=None)
def _widths(towers):
  """(count, ctypes array) of each tower's hidden widths."""
  return tuple(x for ws in towers
               for x in (len(ws), (ctypes.c_int * max(len(ws), 1))(*ws)))


def _grad_cuda(lw: LearnerWeights, raw: torch.Tensor, coef: torch.Tensor,
               lay: RawLayout, *, l2_coef: float, gradient_scale: float):
  """Launch the kernel in the mode of ``lw`` (``LearnerWeights`` or
  ``LearnerSpec``); returns (grads [n], met [4, B], l2 [])."""
  global launches, wide_launches
  if isinstance(lw, LearnerSpec):
    return _categorical_grad_cuda(lw, raw, coef, lay, l2_coef=l2_coef,
                                  gradient_scale=gradient_scale)
  _check_raw(lw, raw, coef, lay)
  dev = raw.device
  B = raw.shape[1]
  lib = _load_kernel()
  n = lw.flat.numel()
  plan = mlp_learner_plan(B, lay.K, lw, device_limits(dev))
  scratch = torch.empty((plan.scratch_floats,), dtype=torch.float32,
                        device=dev)
  out = torch.empty((n + 4 * B + 1,), dtype=torch.float32, device=dev)
  grads, met, l2 = out[:n], out[n:n + 4 * B].view(4, B), out[n + 4 * B:]
  n_repr, repr_w, n_pred, pred_w, n_dyn, dyn_w = _widths(_shapes(lw)[:3])
  err = lib.mz_fused_muzero_grad(
      raw.data_ptr(), raw.stride(0), coef.data_ptr(), lw.flat.data_ptr(), n,
      grads.data_ptr(), met.data_ptr(), l2.data_ptr(), scratch.data_ptr(),
      plan.scratch_floats, plan.blocks // max(plan.cluster, 1),
      int(plan.smem_arena), plan.cluster, plan.smem_bytes, B, lay.O,
      lw.embedding_dim,
      lw.num_actions, 2 * lw.support_size + 1, lw.support_size, lay.K,
      n_repr, repr_w, n_pred, pred_w, n_dyn, dyn_w,
      lay.obs, lay.action, lay.reward, lay.rn, lay.pi, lay.mask,
      gradient_scale, l2_coef,
      _device_index(dev),
      torch.cuda.current_stream(dev).cuda_stream)
  if err != 0:
    raise RuntimeError("fused learner kernel: "
                       + lib.mz_learner_error_string(err).decode())
  launches += 1
  wide_launches += plan.cluster > 0
  return grads, met, l2[0]


def _require(lw):
  if lw is None:
    raise NotImplementedError(
        "this network family has no learner kernel: the MLP triplet and the "
        "categorical LayerNormMLP have one; the fc-resnet and Stochastic "
        "MuZero take autograd over their loss, fed by the fused sampler's "
        "per_step_obs rows (the learner's hybrid mode)")


def fused_muzero_grad_raw(
    params: MZParams,
    raw: torch.Tensor,           # [R, B] fused-sampler rows (RawLayout)
    coef: torch.Tensor,          # [B] = weight / denom / B
    raw_layout: RawLayout,
    networks,
    lw,                          # LearnerWeights or LearnerSpec
    *,
    l2_coef: float = 1e-4,
    gradient_scale: float = 0.5,
    priority_alpha: float = 0.5,
):
  """(flat grads, LossMetrics) of ``muzero_loss`` on the windows of the raw
  rows. ``raw`` may be a column block of a wider [R, W] tensor. CUDA tensors
  go to the kernel (or the call raises); CPU tensors go to the plain
  version."""
  _require(lw)
  kwargs = dict(l2_coef=l2_coef, gradient_scale=gradient_scale,
                priority_alpha=priority_alpha)
  if raw.device.type == "cpu":
    return fused_muzero_grad_raw_reference(params, raw, coef, raw_layout,
                                           networks, **kwargs)
  if raw.device.type != "cuda":
    raise ValueError(f"no fused learner for device {raw.device}")
  grads, met, l2 = _grad_cuda(lw, raw, coef, raw_layout, l2_coef=l2_coef,
                              gradient_scale=gradient_scale)
  return grads, _finish_metrics(met, l2, coef, raw[raw_layout.denom],
                                raw[raw_layout.rn], priority_alpha)


def raw_from_batch(batch: Transition, num_steps: int):
  """Pack a [B, L, ...] batch into ``RawLayout`` rows of its first
  ``num_steps`` steps; returns (raw [R, B], coef [B], layout)."""
  B = batch.action.shape[0]
  K = num_steps
  obs0 = batch.obs[:, 0].reshape(B, -1).to(torch.float32)
  A = batch.pi.shape[-1]
  lay = make_raw_layout(obs0.shape[1], K, A)
  mask = batch.mask.to(torch.float32)
  denom = torch.clamp(torch.sum(mask, 1), min=1.0)
  raw = torch.zeros((lay.rows, B), dtype=torch.float32,
                    device=batch.action.device)
  raw[lay.obs:lay.obs + lay.O] = obs0.T
  raw[lay.action:lay.action + K] = batch.action[:, :K].T.to(torch.float32)
  raw[lay.reward:lay.reward + K] = batch.reward[:, :K].T
  raw[lay.rn:lay.rn + K] = batch.rn[:, :K].T
  raw[lay.pi:lay.pi + K * A] = batch.pi[:, :K].reshape(B, K * A).T
  raw[lay.mask:lay.mask + K] = mask[:, :K].T
  raw[lay.denom] = denom
  coef = (batch.weight / denom / B).to(torch.float32)
  return raw, coef, lay


def fused_muzero_grad(
    params: MZParams,
    batch: Transition,
    networks,
    lw,                          # LearnerWeights or LearnerSpec
    *,
    l2_coef: float = 1e-4,
    gradient_scale: float = 0.5,
    priority_alpha: float = 0.5,
    num_unroll_steps: Optional[int] = None,
):
  """(flat grads, LossMetrics) with the semantics of autograd over
  ``muzero_loss`` on a [B, L, ...] batch. CUDA tensors go to the kernel
  (through ``raw_from_batch``), or the call raises; CPU tensors go to the
  plain version."""
  _require(lw)
  kwargs = dict(l2_coef=l2_coef, gradient_scale=gradient_scale,
                priority_alpha=priority_alpha)
  if batch.action.device.type == "cpu":
    return fused_muzero_grad_reference(params, batch, networks,
                                       num_unroll_steps=num_unroll_steps,
                                       **kwargs)
  if batch.action.device.type != "cuda":
    raise ValueError(f"no fused learner for device {batch.action.device}")
  raw, coef, lay = raw_from_batch(batch,
                                  num_unroll_steps or batch.action.shape[1])
  grads, met, l2 = _grad_cuda(lw, raw, coef, lay, l2_coef=l2_coef,
                              gradient_scale=gradient_scale)
  return grads, _finish_metrics(met, l2, coef, raw[lay.denom],
                                batch.rn[:, 0], priority_alpha)
