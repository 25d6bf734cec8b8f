"""The learner: sample -> unrolled loss gradient -> optimizer -> priority
refresh (``muax_tpu/train/learner.py``).

Group paths, chosen by ``fused_group_status`` from what the setup is:

* the fused path in mode "raw" (the default for the MLP triplet and the
  acme categorical family): per group of updates, ``draw_segments`` -> the
  interleave permutation -> the fused sampler kernel -> one fused learner
  kernel launch per update -> the optimizer -> one priority refresh for the
  group;
* the fused path in mode "hybrid" (a family without a learner kernel:
  Stochastic MuZero's five nets, the fc-resnet; or ``fused_learner`` off):
  the same, with the sampler in its ``per_step_obs`` mode, whose rows
  ``_transition_from_raw`` turns back into a [B, K, ...] batch for autograd
  over the family's loss;
* the generic path (``fused_sampler`` off, an ``observation_transform``,
  or more than 64 observation features, as for the pixel rings):
  ``replay_sample`` -> ``_interleave_chunks`` -> one gradient step per chunk
  (the fused learner in batch mode, or autograd over the family's loss).

With ``group`` (the JAX package's ``axis_name``), every update's gradient
is averaged over a process group before the optimizer
(``parallel/sharded.py``). On the card both kernels run; on the CPU the
same fused path runs through the kernels' plain versions. Training state
is updated in place: the parameters are views of one flat buffer that the
optimizer steps, and the ring's priorities are overwritten. The functions
return the state objects all the same, so callers read like the JAX
package's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist

from muax_tpu_torch.config import MuZeroConfig
from muax_tpu_torch.models.fused_learner import (extract_learner,
                                                 fused_muzero_grad,
                                                 fused_muzero_grad_raw)
from muax_tpu_torch.models.losses import muzero_grad
from muax_tpu_torch.models.networks import MZParams
from muax_tpu_torch.models.optimizers import (GradientTransformation,
                                              OptState, apply_updates)
from muax_tpu_torch.models.stochastic_losses import stochastic_muzero_grad
from muax_tpu_torch.models.stochastic_networks import SMZNetworks
from muax_tpu_torch.replay.buffer import (ReplayState, draw_level1,
                                          gumbel_noise, replay_sample,
                                          replay_update_priorities,
                                          segments_from_draws)
from muax_tpu_torch.replay.fused_sampler import fused_sample_group
from muax_tpu_torch.types import Transition
from muax_tpu_torch.utils.debug import check_numerics

METRIC_KEYS = ("loss", "reward_loss", "value_loss", "policy_loss", "l2_loss",
               "grad_norm")


@dataclasses.dataclass
class TrainState:
  """Parameters, optimizer state and the count of learner steps."""
  params: MZParams
  opt_state: OptState
  step: int = 0


def _make_finish(optimizer: GradientTransformation, group=None):
  """The shared tail of one gradient step: check_numerics -> the mean over
  ``group`` -> optimizer -> apply. Returns (train_state, priorities [B],
  stacked metrics [6]); ``grad_norm`` is the reduced gradient's.

  ``group``, a ``torch.distributed`` process group (e.g.
  ``mesh.get_group(DATA_AXIS)``), stands for the JAX package's
  ``axis_name``: the flat gradient is all-reduced over it once and divided
  by its size, as ``jax.lax.pmean`` averages over the named axis. A group
  of one issues no collective, as a ``pmean`` over an axis of size 1 costs
  nothing: the mean of one gradient is that gradient, bit for bit."""
  size = 1 if group is None else dist.get_world_size(group)

  def _finish(train_state: TrainState, grads: torch.Tensor, metrics):
    grads = check_numerics(grads, "grads")
    if size > 1:
      grads = grads.contiguous()
      dist.all_reduce(grads, op=dist.ReduceOp.SUM, group=group)
      grads = grads / size
    updates, opt_state = optimizer.update(grads, train_state.opt_state,
                                          train_state.params)
    apply_updates(train_state.params, updates)
    stacked = torch.stack([
        metrics.total, metrics.reward_loss, metrics.value_loss,
        metrics.policy_loss, metrics.l2_loss,
        torch.sqrt(torch.sum(grads * grads))])
    return (TrainState(train_state.params, opt_state, train_state.step + 1),
            metrics.priorities, stacked)

  return _finish


def _make_grad_step(networks, optimizer: GradientTransformation,
                    config: MuZeroConfig, group=None):
  """(train_state, batch) -> (train_state, priorities [B], metrics [6]):
  the fused learner in batch mode, or autograd over ``muzero_loss`` when
  ``fused_learner`` is off or the family has no kernel (the fc-resnet, as
  in the JAX package), or over ``stochastic_muzero_loss`` for Stochastic
  MuZero. ``group`` as in ``_make_finish``."""
  tcfg = config.train
  _finish = _make_finish(optimizer, group)
  kwargs = dict(l2_coef=tcfg.l2_coef, gradient_scale=tcfg.gradient_scale,
                priority_alpha=config.replay.priority_alpha)

  def grad_step(train_state: TrainState, batch: Transition):
    if isinstance(networks, SMZNetworks):
      grads, metrics = stochastic_muzero_grad(train_state.params, batch,
                                              networks, **kwargs)
      return _finish(train_state, grads, metrics)
    lw = (extract_learner(networks, train_state.params)
          if tcfg.fused_learner else None)
    if lw is not None:
      grads, metrics = fused_muzero_grad(train_state.params, batch, networks,
                                         lw, **kwargs)
    else:
      grads, metrics = muzero_grad(train_state.params, batch, networks,
                                   **kwargs)
    return _finish(train_state, grads, metrics)

  return grad_step


def _named(stacked: torch.Tensor) -> dict:
  return {k: stacked[i] for i, k in enumerate(METRIC_KEYS)}


def make_update_fn(networks, optimizer: GradientTransformation,
                   config: MuZeroConfig, group=None):
  """Build update(train_state, replay_state, generator) ->
  (train_state, replay_state, metrics): one sampled batch, one step.
  ``group`` (the JAX package's ``axis_name``): the process group over which
  the gradient is averaged before the optimizer; every rank of it must call
  ``update`` the same number of times."""
  tcfg = config.train
  grad_step = _make_grad_step(networks, optimizer, config, group)

  def update(train_state: TrainState, replay_state: ReplayState,
             generator: torch.Generator):
    batch, seg_idx, starts = replay_sample(
        replay_state, generator, tcfg.batch_size, tcfg.unroll_steps,
        offline_fraction=config.replay.offline_fraction,
        online_queue_size=config.replay.online_queue_size)
    if tcfg.observation_transform is not None:
      batch = dataclasses.replace(
          batch, obs=tcfg.observation_transform(generator, batch.obs))
    # How old, in learner steps, the sampled windows' targets are.
    staleness = torch.mean(
        (train_state.step - replay_state.target_step[seg_idx]).float())
    train_state, priorities, stacked = grad_step(train_state, batch)
    replay_update_priorities(replay_state, seg_idx, starts, priorities + 1e-6)
    return train_state, replay_state, {**_named(stacked),
                                       "target_staleness": staleness}

  return update


def _interleave_chunks(big: Transition, group: int, B: int) -> Transition:
  """[group*B, ...] mega-batch -> [group, B, ...] chunks, column-major:
  mega-batch row i lands in chunk ``i % group`` at position ``i // group``,
  so the online-queue rows (the last rows) spread evenly over the chunks."""
  return Transition(**{
      f.name: getattr(big, f.name).reshape(
          (B, group) + tuple(getattr(big, f.name).shape[1:])).transpose(0, 1)
      for f in dataclasses.fields(Transition)})


def _deinterleave_flat(per_chunk: torch.Tensor, B: int) -> torch.Tensor:
  """Inverse of ``_interleave_chunks`` for per-row outputs: [group, B] ->
  [group*B] in mega-batch row order."""
  return per_chunk.transpose(0, 1).reshape(-1)


def _transition_from_raw(raw: torch.Tensor, lay, obs_shape,
                         weight: torch.Tensor) -> Transition:
  """A [R, B] block of the sampler's ``per_step_obs`` rows as the [B, K, ...]
  ``Transition`` the losses take. ``done`` and ``value`` are not in the
  rows; no loss reads them (validity is in ``mask``, priorities use
  ``rn``)."""
  B = raw.shape[1]
  K, O, A = lay.K, lay.O, lay.A
  dev = raw.device
  obs = (raw[lay.obs:lay.obs + O * K].reshape(O, K, B).permute(2, 1, 0)
         .reshape((B, K) + tuple(obs_shape)))
  pi = raw[lay.pi:lay.pi + K * A].reshape(K, A, B).permute(2, 0, 1)
  return Transition(
      obs=obs,
      action=raw[lay.action:lay.action + K].T.to(torch.int32),
      reward=raw[lay.reward:lay.reward + K].T,
      done=torch.zeros((B, K), dtype=torch.bool, device=dev),
      rn=raw[lay.rn:lay.rn + K].T,
      value=torch.zeros((B, K), dtype=torch.float32, device=dev),
      pi=pi,
      weight=weight,
      mask=raw[lay.mask:lay.mask + K].T)


def make_multi_update_fn(networks, optimizer: GradientTransformation,
                         config: MuZeroConfig, group=None):
  """N = ``updates_per_iteration`` updates per call, presampled in groups
  of ``gcd(N, presample_updates)``: every batch of a group is drawn against
  the priorities as of the group start, and the refreshed priorities land
  before the next group samples (the reference's dataset batching and its
  once-per-learner-step priority mutation).

  ``multi_update(train_state, replay_state, generator, num_allowed=None)``:
  when ``num_allowed`` (a Python int) is given, only the first
  ``num_allowed`` of the N updates run; the windows of the others keep their
  priorities, and the sampler still draws the whole group. That is the hook
  of ``fit``'s samples-per-insert gate.

  ``group`` stands for the JAX package's ``axis_name``: a process group
  (e.g. ``mesh.get_group(DATA_AXIS)``) over which every update's gradient
  is all-reduced and averaged before the optimizer, on the raw, hybrid and
  generic paths alike. The all-reduce is a collective: every rank of the
  group must make the same calls in the same order, so each must run the
  same number of groups with the same ``num_allowed``.

  Returns (train_state, replay_state, metrics): each metric's mean over the
  updates that ran, ``updates_done`` and ``target_staleness``.
  """
  tcfg = config.train
  grad_step = _make_grad_step(networks, optimizer, config, group)
  _finish = _make_finish(optimizer, group)
  n = tcfg.updates_per_iteration
  group_size = math.gcd(n, max(1, tcfg.presample_updates))
  num_groups = n // group_size
  B = tcfg.batch_size
  W = group_size * B
  K = tcfg.unroll_steps
  loss_kwargs = dict(l2_coef=tcfg.l2_coef, gradient_scale=tcfg.gradient_scale,
                     priority_alpha=config.replay.priority_alpha)

  def _fused_group_status(train_state: TrainState,
                          replay_state: ReplayState):
    """(mode, learner_weights, reason): mode "raw" takes the fused sampler
    and the raw-input learner kernel, "hybrid" the fused sampler's
    ``per_step_obs`` rows and the gradient step, None the generic path, and
    the reason says why (``fused_status`` reports it)."""
    if not tcfg.fused_sampler:
      return None, None, "disabled by config (fused_sampler)"
    if tcfg.observation_transform is not None:
      return None, None, "observation_transform runs on the sampled batch"
    O = math.prod(replay_state.obs.shape[2:])
    if O > 64:
      # The sampler writes O (hybrid: O x K) f32 rows a window: about 1 GB
      # a group of 16,384 pixel windows, where replay_sample gathers the
      # batch's uint8 windows.
      return None, None, (f"obs features {O} > 64 (pixel rings take "
                          "replay_sample)")
    L = replay_state.segment_length
    if L - K + 1 < 1:
      return None, None, f"unroll {K} exceeds segment length {L}"
    lw = (extract_learner(networks, train_state.params)
          if tcfg.fused_learner else None)
    if lw is None:
      return "hybrid", None, "active (hybrid)"
    return "raw", lw, "active (raw)"

  def _executed(g: int, num_allowed: Optional[int]) -> int:
    """Updates of group g that run under the gate."""
    if num_allowed is None:
      return group_size
    return min(max(num_allowed - g * group_size, 0), group_size)

  def _refresh(rs, seg_idx, starts, prios, keep):
    current = rs.step_priorities[seg_idx, starts]
    replay_update_priorities(rs, seg_idx, starts,
                             torch.where(keep, prios + 1e-6, current))

  def run_fused_group(ts: TrainState, rs: ReplayState, g: int,
                      uniforms: torch.Tensor, offsets, gumbel: torch.Tensor,
                      num_allowed: Optional[int] = None, mode: str = "raw"):
    """One group of the fused path in ``mode`` ("raw" or "hybrid") on given
    draws (``draw_level1``'s uniforms and offsets for W = group*B windows,
    Gumbel noise [L, W]). Returns (train_state, summed metrics [7]: the six
    of ``METRIC_KEYS`` and the staleness, each summed over the updates that
    ran, and their count)."""
    dev = rs.action.device
    hybrid = mode == "hybrid"
    # Lane q of the group holds mega-row perm[q]: chunk j (lanes
    # [j*B, (j+1)*B)) gets the rows i with i % group_size == j, as
    # _interleave_chunks gives them.
    p = torch.arange(W, device=dev)
    perm = (p % B) * group_size + p // B
    seg_idx = segments_from_draws(rs, uniforms, offsets)[perm]
    raw, lay = fused_sample_group(rs, seg_idx, gumbel, K,
                                  per_step_obs=hybrid)
    starts = raw[lay.start].long()
    w_raw = raw[lay.weight]
    weight = w_raw / torch.clamp(torch.mean(w_raw), min=1e-9)
    coef = (weight / raw[lay.denom] / B).contiguous()
    staleness = ts.step - torch.mean(raw[lay.tstep])

    done = _executed(g, num_allowed)
    sums = torch.zeros(len(METRIC_KEYS) + 1, device=dev)
    prios = torch.zeros((group_size, B), device=dev)
    for j in range(done):
      cols = slice(j * B, (j + 1) * B)
      if hybrid:
        batch_j = _transition_from_raw(raw[:, cols], lay,
                                       rs.obs.shape[2:], weight[cols])
        ts, prios[j], stacked = grad_step(ts, batch_j)
      else:
        lw = extract_learner(networks, ts.params)
        grads, metrics = fused_muzero_grad_raw(
            ts.params, raw[:, cols], coef[cols], lay, networks, lw,
            **loss_kwargs)
        ts, prios[j], stacked = _finish(ts, grads, metrics)
      sums[:-1] += stacked
    sums[-1] = staleness * done
    # Chunks are contiguous lanes here, so [group, B] flattens to lane order.
    keep = torch.arange(W, device=dev) < done * B
    _refresh(rs, seg_idx, starts, prios.reshape(-1), keep)
    return ts, sums, done

  def run_generic_group(ts: TrainState, rs: ReplayState, g: int,
                        generator: torch.Generator,
                        num_allowed: Optional[int] = None):
    """One group of the generic path; returns as ``run_fused_group``."""
    dev = rs.action.device
    big, seg_idx, starts = replay_sample(
        rs, generator, W, K, offline_fraction=config.replay.offline_fraction,
        online_queue_size=config.replay.online_queue_size)
    if tcfg.observation_transform is not None:
      big = dataclasses.replace(
          big, obs=tcfg.observation_transform(generator, big.obs))
    chunks = _interleave_chunks(big, group_size, B)
    staleness = torch.mean((ts.step - rs.target_step[seg_idx]).float())

    done = _executed(g, num_allowed)
    sums = torch.zeros(len(METRIC_KEYS) + 1, device=dev)
    prios = torch.zeros((group_size, B), device=dev)
    for j in range(done):
      batch_j = Transition(**{f.name: getattr(chunks, f.name)[j]
                              for f in dataclasses.fields(Transition)})
      ts, prios[j], stacked = grad_step(ts, batch_j)
      sums[:-1] += stacked
    sums[-1] = staleness * done
    keep = torch.arange(W, device=dev) % group_size < done
    _refresh(rs, seg_idx, starts, _deinterleave_flat(prios, B), keep)
    return ts, sums, done

  def multi_update(train_state: TrainState, replay_state: ReplayState,
                   generator: torch.Generator,
                   num_allowed: Optional[int] = None):
    mode, _, _ = _fused_group_status(train_state, replay_state)
    dev = replay_state.action.device
    total = torch.zeros(len(METRIC_KEYS) + 1, device=dev)
    updates_done = 0
    for g in range(num_groups):
      if mode is not None:
        uniforms, offsets = draw_level1(
            replay_state, generator, W, config.replay.offline_fraction,
            config.replay.online_queue_size)
        gumbel = gumbel_noise(generator, (replay_state.segment_length, W),
                              dev)
        train_state, sums, done = run_fused_group(
            train_state, replay_state, g, uniforms, offsets, gumbel,
            num_allowed, mode)
      else:
        train_state, sums, done = run_generic_group(
            train_state, replay_state, g, generator, num_allowed)
      total += sums
      updates_done += done
    mean = total / max(updates_done, 1)
    metrics = {**_named(mean[:-1]), "target_staleness": mean[-1],
               "updates_done": updates_done}
    return train_state, replay_state, metrics

  # Seams for fused_status and the tests.
  multi_update.fused_group_status = _fused_group_status
  multi_update.run_fused_group = run_fused_group
  return multi_update
