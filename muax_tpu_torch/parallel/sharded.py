"""The sharded training program (``muax_tpu/parallel/sharded.py``).

One iteration runs the whole actor-learner on every rank of the mesh:
  * environments, search trees and replay live on the ``data`` axis: each
    rank owns ``num_envs / shards`` envs and its own ring of ``capacity /
    shards`` segments, as plain tensors on its own device (the torch
    counterpart of the JAX package's global arrays with a leading shard
    axis),
  * parameters and optimizer state are replicated: drawn from the same seed
    on every rank, then broadcast from rank 0,
  * every update's gradient is all-reduced and averaged over the data axis
    before the optimizer (the learner's ``group``, the JAX package's
    ``axis_name``), so the replicas stay bit-identical.

Several processes or several hosts: the same program in every process of
the world (``parallel/multihost.py``); nothing else changes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from muax_tpu_torch.config import MuZeroConfig
from muax_tpu_torch.envs.base import AutoResetWrapper
from muax_tpu_torch.models.optimizers import (GradientTransformation,
                                              flat_parameters)
from muax_tpu_torch.parallel.mesh import DATA_AXIS, axis_size
from muax_tpu_torch.replay.buffer import replay_add, replay_init
from muax_tpu_torch.train.actor import make_rollout_fn
from muax_tpu_torch.train.learner import TrainState, make_multi_update_fn
from muax_tpu_torch.train.reanalyze import make_reanalyze_fn


class ShardedProgram(NamedTuple):
  init: Callable       # (seed) -> (train_state, replay_state, env_carry)
  iteration: Callable  # (train_state, replay, env, seed) -> (..., metrics)
  mesh: DeviceMesh
  local_config: MuZeroConfig
  # (train_state, replay_state, seed) -> (replay_state, metrics); present
  # when reanalyze_segments > 0: every rank refreshes its own ring with a
  # fresh search under the current parameters.
  reanalyze: Callable | None = None


def _local_config(config: MuZeroConfig, num_shards: int) -> MuZeroConfig:
  """Per-shard view: env batch, learner batch and replay capacity divide;
  ``updates_per_iteration`` stays."""
  return dataclasses.replace(
      config,
      train=dataclasses.replace(
          config.train,
          num_envs=config.train.num_envs // num_shards,
          batch_size=config.train.batch_size // num_shards),
      replay=dataclasses.replace(
          config.replay,
          capacity=max(1, config.replay.capacity // num_shards)),
  )


def _all_reduce_metrics(metrics: dict, summed: str, group,
                        device) -> dict:
  """One all-reduce of the stacked metrics over ``group``: ``summed``
  added up, every other metric averaged (a group of one issues none).
  Returns 0-d tensors."""
  keys = sorted(metrics)
  stacked = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32,
                                         device=device).reshape(())
                         for k in keys])
  n = dist.get_world_size(group)
  if n > 1:
    dist.all_reduce(stacked, op=dist.ReduceOp.SUM, group=group)
  return {k: stacked[i] if k == summed else stacked[i] / n
          for i, k in enumerate(keys)}


def shard_generator(seed: int, shard: int, device) -> torch.Generator:
  """The shard's generator: ``seed`` and the shard's index mixed by numpy's
  ``SeedSequence``, as the JAX package folds the data-axis index into its
  key."""
  state = np.random.SeedSequence([int(seed), int(shard)]).generate_state(
      1, np.uint64)[0]
  return torch.Generator(device=device).manual_seed(int(state))


def make_sharded_program(
    networks,
    env: AutoResetWrapper,
    config: MuZeroConfig,
    optimizer: GradientTransformation,
    mesh: DeviceMesh,
    reanalyze_segments: int = 0,
) -> ShardedProgram:
  """Build the sharded iteration. ``config`` values are GLOBAL (whole
  mesh); the env batch and the learner batch must divide the data axis.
  Runs on ``networks.device``.

  ``reanalyze_segments`` > 0 also builds ``program.reanalyze``: one call on
  every rank refreshes that many stale segments GLOBALLY, split across
  the shards, each searching its own ring. Raises ``ValueError`` when a
  count does not divide the data axis."""
  num_shards = axis_size(mesh, DATA_AXIS)
  group = mesh.get_group(DATA_AXIS)
  shard = dist.get_group_rank(group, dist.get_rank())
  device = networks.device
  tcfg = config.train
  if tcfg.num_envs % num_shards or tcfg.batch_size % num_shards:
    raise ValueError(
        f"num_envs={tcfg.num_envs} and batch_size={tcfg.batch_size} must "
        f"divide the data-axis size {num_shards}")
  if reanalyze_segments % num_shards:
    raise ValueError(
        f"reanalyze_segments={reanalyze_segments} must divide the "
        f"data-axis size {num_shards}")

  local = _local_config(config, num_shards)
  rollout = make_rollout_fn(networks, env, local, device=device)
  multi_update = make_multi_update_fn(networks, optimizer, local,
                                      group=group)

  def iteration(train_state, replay_state, env_carry, seed: int):
    generator = shard_generator(seed, shard, device)
    env_carry, segments, priorities, roll_metrics = rollout(
        train_state.params, env_carry, generator,
        train_state.params.temperature)
    replay_add(replay_state, segments, priorities, step=train_state.step)
    train_state, replay_state, learn_metrics = multi_update(
        train_state, replay_state, generator)
    metrics = _all_reduce_metrics({**roll_metrics, **learn_metrics},
                                  "episodes_finished", group, device)
    return train_state, replay_state, env_carry, metrics

  reanalyze = None
  if reanalyze_segments:
    local_reanalyze = make_reanalyze_fn(
        networks, local, reanalyze_segments // num_shards, device=device)

    def reanalyze(train_state, replay_state, seed: int):
      replay_state, metrics = local_reanalyze(
          train_state.params, replay_state,
          shard_generator(seed, shard, device), train_state.step)
      return replay_state, _all_reduce_metrics(
          metrics, "reanalyzed_segments", group, device)

  def init(seed: int):
    obs_shape = env.spec.observation_shape
    params = networks.init_params(obs_shape,
                                  torch.Generator().manual_seed(seed))
    # Every rank drew the same numbers; rank 0's are the ones kept.
    dist.broadcast(flat_parameters(params), src=0)
    train_state = TrainState(params=params, opt_state=optimizer.init(params),
                             step=0)
    env_carry = env.reset(shard_generator(seed, shard, device),
                          local.train.num_envs)
    replay_state = replay_init(
        local.replay.capacity, local.train.collect_steps, obs_shape,
        networks.num_actions,
        obs_dtype=getattr(env.spec, "obs_dtype", None) or torch.float32,
        device=device)
    return train_state, replay_state, env_carry

  return ShardedProgram(init=init, iteration=iteration, mesh=mesh,
                        local_config=local, reanalyze=reanalyze)
