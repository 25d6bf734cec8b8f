"""Tensor (model) parallelism for the big conv towers: the ``model`` mesh
axis with real sharding rules behind it (``muax_tpu/parallel/
model_parallel.py``).

Every conv kernel of the AlphaZero resnet is sharded on its OUTPUT-CHANNEL
dim over the ``model`` axis, the channel vectors with it, and the dense
layers on their contraction dim. Where XLA's GSPMD inserts the collectives
in the JAX package, the apply here writes them out on the model axis's
process group:
  * before each conv, an all-gather of the channel-sharded activation (a
    conv reads every input channel),
  * in each LayerNorm, which runs over (H, W, C), an all-reduce of the
    per-sample partial sums of the mean and then of the variance,
  * after each dense layer, an all-reduce of the partial products: a dense
    layer's ``in`` shard is a contiguous block of the NHWC-flattened rows,
    not a channel slice, and a sharded bias (the value tower's 64-wide one)
    is added into its columns of the partial product before the sum.
MuZero-scale MLPs do not need this; the AlphaZero resnet at Go scale (19
blocks x 256 channels) is the workload it exists for.

Composes with data parallelism: a ('data', 'model') mesh splits the batch
on ``data`` and the channels on ``model``.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from muax_tpu_torch.models.networks import same_pad
from muax_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_size


def _jax_shape(x: torch.Tensor) -> tuple:
  """``x``'s shape in the JAX package's layout: a conv kernel [out, in, kh,
  kw] as [kh, kw, in, out], a linear weight [out, in] as [in, out]."""
  shape = tuple(x.shape)
  if len(shape) == 4:
    return shape[2], shape[3], shape[1], shape[0]
  if len(shape) == 2:
    return shape[1], shape[0]
  return shape


def az_partition_spec(x: torch.Tensor, model_size: int) -> tuple:
  """Partition rule for one AZ-resnet parameter, stated in the JAX layout
  (a ``PartitionSpec`` as a tuple):

  conv kernels [kh, kw, in, out] -> shard out-channels; 1-D channel vectors
  (conv biases, LayerNorm scale and offset) of size over 1 that divides ->
  shard; dense weights [in, out] -> shard the contraction (in) dim; anything
  else -> replicate, ``()``.
  """
  shape = _jax_shape(x)
  if len(shape) == 4 and shape[-1] % model_size == 0:
    return (None, None, None, MODEL_AXIS)
  if len(shape) == 2 and shape[0] % model_size == 0:
    return (MODEL_AXIS, None)
  if len(shape) == 1 and shape[0] % model_size == 0 and shape[0] > 1:
    return (MODEL_AXIS,)
  return ()


def shard_dim(x: torch.Tensor, model_size: int):
  """The torch dim of ``x`` that ``az_partition_spec`` shards (out-channels
  0 of a conv kernel, ``in`` 1 of a linear weight, 0 of a vector), or
  None."""
  if not az_partition_spec(x, model_size):
    return None
  return 1 if x.ndim == 2 else 0


def local_shard(x: torch.Tensor, model_size: int, index: int):
  """Shard ``index`` of ``model_size`` of ``x`` under the rule (``x`` itself
  where the rule replicates it)."""
  dim = shard_dim(x, model_size)
  if dim is None:
    return x
  n = x.shape[dim] // model_size
  return x.narrow(dim, index * n, n).contiguous()


def _modules(params):
  """An ``AZParams``'s network module (or the module given)."""
  return getattr(params, "network", params)


def _model_coords(mesh: DeviceMesh):
  """(model-axis size, this rank's index on it, the axis's group)."""
  size = axis_size(mesh, MODEL_AXIS)
  if size == 1:
    return 1, 0, None
  group = mesh.get_group(MODEL_AXIS)
  return size, dist.get_group_rank(group, dist.get_rank()), group


def shard_az_params(params: Any, mesh: DeviceMesh) -> dict:
  """Each rank's shard of every AZ-resnet parameter under
  ``az_partition_spec`` over the mesh's ``model`` axis (replicated over
  ``data``): name -> this rank's local tensor. ``params`` is an
  ``AZParams`` (or its network module), the same on every rank."""
  size, index, _ = _model_coords(mesh)
  return {name: local_shard(x.detach(), size, index)
          for name, x in _modules(params).named_parameters()}


def make_model_parallel_apply(network, mesh: DeviceMesh):
  """(sharded params, obs [B, H, W, P]) -> (policy_logits, value) of this
  rank's data shard: the batch is split on ``data`` (B must divide it) and
  the channels on ``model``. ``sharded params`` come from
  :func:`shard_az_params`; the outputs are the same on every rank of the
  model axis and agree with ``network.apply`` on the replicated parameters
  up to the order of the sums.

  ``network`` is the ``make_az_resnet`` network; every rank of the mesh
  must call the apply, as it makes collectives on the model axis."""
  size, index, group = _model_coords(mesh)
  data_size = axis_size(mesh, DATA_AXIS)
  data_index = (0 if data_size == 1 else dist.get_group_rank(
      mesh.get_group(DATA_AXIS), dist.get_rank()))
  rule = {}  # observation shape -> {name: the dim the rule shards or None}

  def shard_dims(obs_shape):
    """``shard_dim`` of every parameter at its replicated shape, from the
    network built on the meta device (shapes without memory)."""
    if obs_shape not in rule:
      with torch.device("meta"):
        full = network.build(obs_shape, None)
      rule[obs_shape] = {name: shard_dim(x, size)
                         for name, x in full.named_parameters()}
    return rule[obs_shape]

  def gather(x, dim):
    """``x`` whole along ``dim``, on which the model axis shards it."""
    if size == 1:
      return x
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)

  def channels(h, sharded):
    """The whole channel dim of an activation [B, c, H, W]."""
    return gather(h, 1) if sharded else h

  def all_sum(x):
    if group is not None:
      dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x

  def conv(x, p, dims, prefix):
    """A SAME 3x3 conv of the full input; the output is sharded on the
    channels where the kernel is."""
    w, b = p[prefix + ".weight"], p[prefix + ".bias"]
    return (F.conv2d(same_pad(x, w.shape[-1], 1), w, b),
            dims[prefix + ".weight"] is not None)

  def layer_norm(h, sharded, p, prefix, eps=1e-5):
    """haiku's LayerNorm over (C, H, W) of an activation whose channels
    may be sharded: the mean, then the variance, summed over the shards."""
    scale, offset = p[prefix + ".weight"], p[prefix + ".bias"]
    count = h[0].numel() * (size if sharded else 1)
    reduce = all_sum if sharded else (lambda x: x)
    mean = reduce(h.sum((1, 2, 3))) / count
    d = h - mean[:, None, None, None]
    var = reduce((d * d).sum((1, 2, 3))) / count
    out = d * torch.rsqrt(var + eps)[:, None, None, None]
    return out * scale[:, None, None] + offset[:, None, None]

  def dense(x, p, dims, prefix):
    """x [B, in] (whole) @ W + b, with W sharded on ``in``: the partial
    product of this rank's block of rows, summed over the shards."""
    w, b = p[prefix + ".weight"], p[prefix + ".bias"]
    bdim = dims[prefix + ".bias"]
    if dims[prefix + ".weight"] is None:
      return x @ w.T + (b if bdim is None else gather(b, 0))
    k = w.shape[1]
    y = x[:, index * k:(index + 1) * k] @ w.T
    if bdim is not None:
      n = b.shape[0]
      y[:, index * n:(index + 1) * n] += b
    elif index == 0:
      y += b
    return all_sum(y)

  def apply(params: dict, obs: torch.Tensor):
    B = obs.shape[0]
    if B % data_size:
      raise ValueError(f"batch {B} must divide the data-axis size "
                       f"{data_size}")
    n = B // data_size
    dims = shard_dims(tuple(obs.shape[1:]))
    x = obs[data_index * n:(data_index + 1) * n].to(torch.float32)
    h, sharded = conv(x.permute(0, 3, 1, 2), params, dims, "stem")
    num_blocks = len({k.split(".")[1] for k in params
                      if k.startswith("blocks.")})
    for i in range(num_blocks):
      blk = f"blocks.{i}."
      pre = F.relu(layer_norm(h, sharded, params, blk + "norm_in"))
      mid, _ = conv(channels(pre, sharded), params, dims, blk + "conv_in")
      mid = F.relu(layer_norm(mid, sharded, params, blk + "norm_mid"))
      out, _ = conv(channels(mid, sharded), params, dims,
                    blk + "conv_out")
      h = out + h
    flat = channels(F.relu(h), sharded).permute(0, 2, 3, 1).flatten(1)
    value_h = F.relu(dense(flat, params, dims, "value_hidden"))
    value = torch.tanh(dense(value_h, params, dims, "value"))
    return dense(flat, params, dims, "policy"), value[:, 0]

  return apply


def sharded_fraction(params: Any, mesh) -> float:
  """Fraction of the parameter COUNT that is actually sharded over
  ``model``, a placement diagnostic (1.0 would mean every tensor sharded).
  ``mesh`` is a ``DeviceMesh`` or the model axis's size."""
  size = mesh if isinstance(mesh, int) else axis_size(mesh, MODEL_AXIS)
  total = sharded = 0
  for x in _modules(params).parameters():
    total += x.numel()
    if az_partition_spec(x, size):
      sharded += x.numel()
  return sharded / max(total, 1)
