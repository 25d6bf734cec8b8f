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

On CUDA tensors they launch the hand-written kernel
``csrc/fused_learner.cu`` (its MLP kernel, or its tiled categorical
kernel); on CPU tensors they run the plain version, autograd over
``models/losses.py`` ``muzero_loss`` on the equivalent batch. The kernel
returns gradients directly and is never called under autograd. The
fc-resnet family has no kernel, as in the JAX package: its residual
blocks' backward is not hand-derived.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from muax_tpu_torch import _build
from muax_tpu_torch.models.acme_networks import CategoricalMZNetworks
from muax_tpu_torch.models.losses import LossMetrics, muzero_grad
from muax_tpu_torch.models.networks import MZNetworks, MZParams
from muax_tpu_torch.models.optimizers import flat_parameters
from muax_tpu_torch.replay.fused_sampler import RawLayout, make_raw_layout
from muax_tpu_torch.types import Transition

# Launches of the CUDA kernel, by mode; the plain version does not count.
launches = 0              # MLP triplet
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
    fn.argtypes = ([ptr, i32, ptr, ptr, i32, ptr, ptr, ptr, ptr, i32]
                   + [i32] * 7 + [i32, ptr, i32, ptr, i32, ptr]
                   + [i32] * 6 + [f32, f32, i32, ptr])
    fn.restype = i32
    lib.mz_fused_grad_blocks.argtypes = [i32]
    lib.mz_fused_grad_blocks.restype = i32
    lib.mz_fused_categorical_grad.argtypes = (
        [ptr, i32, ptr, ptr, i32, ptr, ptr, ptr, ptr, i32, ptr, ctypes.c_long]
        + [i32] * 5 + [f32, f32, i32]
        + [i32, ptr, ptr] * 3 + [i32] * 6 + [f32, f32, i32, ptr])
    lib.mz_fused_categorical_grad.restype = i32
    lib.mz_categorical_grad_blocks.argtypes = [i32]
    lib.mz_categorical_grad_blocks.restype = i32
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


def _categorical_grad_cuda(spec: LearnerSpec, raw: torch.Tensor,
                           coef: torch.Tensor, lay: RawLayout, *,
                           l2_coef: float, gradient_scale: float):
  """Launch the tiled categorical kernel; returns (grads [n], met [4, B],
  l2 [])."""
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
  G = lib.mz_categorical_grad_blocks(B)
  n_scratch = lib.mz_categorical_scratch_floats(G, *shapes, *towers)
  if n_scratch < 0:
    raise RuntimeError("fused learner kernel: shapes do not fit the "
                       "categorical kernel")
  partial = torch.empty((G, n), dtype=torch.float32, device=dev)
  scratch = torch.empty((max(n_scratch, 1),), dtype=torch.float32,
                        device=dev)
  grads = torch.empty((n,), dtype=torch.float32, device=dev)
  met = torch.empty((4, B), dtype=torch.float32, device=dev)
  l2 = torch.empty((1,), dtype=torch.float32, device=dev)
  err = lib.mz_fused_categorical_grad(
      raw.data_ptr(), raw.stride(0), coef.data_ptr(), spec.flat.data_ptr(),
      n, grads.data_ptr(), met.data_ptr(), l2.data_ptr(), partial.data_ptr(),
      G, scratch.data_ptr(), n_scratch, B, *shapes[:4], spec.vmin,
      spec.vmax, lay.K, *towers,
      lay.obs, lay.action, lay.reward, lay.rn, lay.pi, lay.mask,
      gradient_scale, l2_coef,
      dev.index if dev.index is not None else torch.cuda.current_device(),
      torch.cuda.current_stream(dev).cuda_stream)
  if err != 0:
    raise RuntimeError("fused learner kernel: "
                       + lib.mz_learner_error_string(err).decode())
  categorical_launches += 1
  return grads, met, l2[0]


def _grad_cuda(lw: LearnerWeights, raw: torch.Tensor, coef: torch.Tensor,
               lay: RawLayout, *, l2_coef: float, gradient_scale: float):
  """Launch the kernel in the mode of ``lw`` (``LearnerWeights`` or
  ``LearnerSpec``); returns (grads [n], met [4, B], l2 [])."""
  global launches
  if isinstance(lw, LearnerSpec):
    return _categorical_grad_cuda(lw, raw, coef, lay, l2_coef=l2_coef,
                                  gradient_scale=gradient_scale)
  _check_raw(lw, raw, coef, lay)
  dev = raw.device
  B = raw.shape[1]
  lib = _load_kernel()
  n = lw.flat.numel()
  G = lib.mz_fused_grad_blocks(B)
  partial = torch.empty((G, n), dtype=torch.float32, device=dev)
  grads = torch.empty((n,), dtype=torch.float32, device=dev)
  met = torch.empty((4, B), dtype=torch.float32, device=dev)
  l2 = torch.empty((1,), dtype=torch.float32, device=dev)

  def widths(ws):
    return len(ws), (ctypes.c_int * max(len(ws), 1))(*ws)

  n_repr, repr_w = widths(lw.repr_layers)
  n_pred, pred_w = widths(lw.pred_layers)
  n_dyn, dyn_w = widths(lw.dyn_layers)
  err = lib.mz_fused_muzero_grad(
      raw.data_ptr(), raw.stride(0), coef.data_ptr(), lw.flat.data_ptr(), n,
      grads.data_ptr(), met.data_ptr(), l2.data_ptr(), partial.data_ptr(), G,
      B, lay.O, lw.embedding_dim, lw.num_actions, 2 * lw.support_size + 1,
      lw.support_size, lay.K, n_repr, repr_w, n_pred, pred_w, n_dyn, dyn_w,
      lay.obs, lay.action, lay.reward, lay.rn, lay.pi, lay.mask,
      gradient_scale, l2_coef,
      dev.index if dev.index is not None else torch.cuda.current_device(),
      torch.cuda.current_stream(dev).cuda_stream)
  if err != 0:
    raise RuntimeError("fused learner kernel: "
                       + lib.mz_learner_error_string(err).decode())
  launches += 1
  return grads, met, l2[0]


def _require(lw):
  if lw is None:
    raise NotImplementedError(
        "this network family has no learner kernel: the MLP triplet and the "
        "categorical LayerNormMLP have one; the fc-resnet takes the generic "
        "learner (autograd over muzero_loss) until the fused sampler's "
        "hybrid feed comes (ROADMAP.md A.4)")


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
