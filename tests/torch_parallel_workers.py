"""The ranks of ``tests/test_torch_parallel.py``'s process groups: CPU,
gloo, one intra-op thread each. This module imports nothing of JAX or of
the JAX package; its inputs arrive as numpy arrays, and each rank returns
numpy arrays to the parent, which holds them against the JAX package."""
import copy

import numpy as np
import torch
import torch.distributed as dist

from muax_tpu_torch.config import (MuZeroConfig, ReplayConfig, SearchConfig,
                                   TrainConfig)
from muax_tpu_torch.envs import AutoResetWrapper, CartPole
from muax_tpu_torch.models import (az_params_from_numpy, create_optimizer,
                                   make_az_resnet, make_mlp_networks,
                                   mlp_params_from_numpy)
from muax_tpu_torch.models.optimizers import flat_parameters, sgd
from muax_tpu_torch.parallel import (DATA_AXIS, MODEL_AXIS,
                                     make_mesh, make_model_parallel_apply,
                                     make_sharded_program, shard_az_params)
from muax_tpu_torch.replay import replay_add, replay_init
from muax_tpu_torch.train import TrainState, make_multi_update_fn
from muax_tpu_torch.types import Transition

NET = dict(num_actions=2, embedding_dim=8, support_size=10)


def small_config(num_envs=16, batch_size=16):
  """``tests/test_parallel.py``'s ``small_config``."""
  return MuZeroConfig(
      search=SearchConfig(num_simulations=4),
      replay=ReplayConfig(capacity=64, min_fill=8),
      train=TrainConfig(num_envs=num_envs, collect_steps=8,
                        batch_size=batch_size, updates_per_iteration=2,
                        unroll_steps=3, n_bootstrap=5))


# The learner's paths: (fused_learner, fused_sampler) of each.
PATHS = {"raw": (True, True), "hybrid": (False, True),
         "generic": (False, False)}


def parity_config(path: str):
  """``TestFusedPathUnderShardMap``'s config, one update of 128 windows, on
  one of the learner's ``PATHS``."""
  fused_learner, fused_sampler = PATHS[path]
  return MuZeroConfig(
      search=SearchConfig(num_simulations=4),
      replay=ReplayConfig(capacity=16, min_fill=4),
      train=TrainConfig(num_envs=8, collect_steps=8, batch_size=128,
                        updates_per_iteration=1, unroll_steps=3,
                        n_bootstrap=4, presample_updates=1,
                        fused_learner=fused_learner,
                        fused_sampler=fused_sampler))


def uniform_replay(shard: int, capacity: int = 16, L: int = 8):
  """A window-invariant ring, ``TestFusedPathUnderShardMap._uniform_replay``:
  every segment constant in time, uniform priorities, so that any draw
  gives the same batch; its values depend on the shard."""
  K = capacity
  segs = Transition(
      obs=torch.full((K, L, 4), 0.1 + 0.05 * shard),
      action=torch.ones((K, L), dtype=torch.int32),
      reward=torch.full((K, L), 0.25),
      done=torch.zeros((K, L), dtype=torch.bool),
      rn=torch.full((K, L), 0.5 + 0.1 * shard),
      value=torch.zeros((K, L)),
      pi=torch.full((K, L, 2), 0.5),
      weight=torch.ones((K,)),
      mask=torch.ones((K, L)))
  rs = replay_init(capacity, L, (4,), 2, device="cpu")
  return replay_add(rs, segs, torch.ones((K, L)))


def _tensors(tree):
  """Every tensor of a (nested) optimizer state tuple."""
  if isinstance(tree, torch.Tensor):
    yield tree
  elif isinstance(tree, (tuple, list)):
    for x in tree:
      yield from _tensors(x)


def _flat_opt(opt_state) -> np.ndarray:
  leaves = [x.reshape(-1).double() for x in _tensors(opt_state)]
  return torch.cat(leaves).numpy() if leaves else np.zeros(0)


def _state(ts) -> dict:
  return {"params": flat_parameters(ts.params).numpy().copy(),
          "opt": _flat_opt(ts.opt_state), "step": ts.step}


def _counted(fn):
  """``fn()`` and the number of ``torch.distributed.all_reduce`` calls it
  made."""
  inner, calls = dist.all_reduce, []

  def counting(*args, **kwargs):
    calls.append(1)
    return inner(*args, **kwargs)

  dist.all_reduce = counting
  try:
    return fn(), len(calls)
  finally:
    dist.all_reduce = inner


def sharded_scenarios(rank):
  """The counterparts of ``tests/test_parallel.py``'s ``TestShardedProgram``
  on a 1-D data mesh of every rank."""
  out = {}
  mesh = make_mesh(device="cpu")
  net = make_mlp_networks(device="cpu", **NET)
  env = AutoResetWrapper(CartPole())
  config = small_config()
  program = make_sharded_program(net, env, config,
                                 create_optimizer("adam", 1e-3), mesh,
                                 reanalyze_segments=16)
  ts, rs, carry = program.init(0)
  out["init"] = _state(ts)
  out["states"], out["total_added"], out["losses"] = [], [], []
  for i in range(4):
    ts, rs, carry, metrics = program.iteration(ts, rs, carry, i)
    out["states"].append(_state(ts))
    out["total_added"].append(rs.total_added)
    out["losses"].append(float(metrics["loss"]))
  stale_before = float(metrics["target_staleness"])
  pi_before = rs.pi.clone()
  rs, re_metrics = program.reanalyze(ts, rs, 99)
  out["reanalyze"] = {
      "segments": float(re_metrics["reanalyzed_segments"]),
      "value_shift": float(re_metrics["reanalyze_value_shift"]),
      "newest_stamp": int(rs.target_step.max()), "step": ts.step,
      "pi_changed": not torch.equal(pi_before, rs.pi)}
  ts, rs, carry, metrics = program.iteration(ts, rs, carry, 5)
  out["reanalyze"]["staleness_after"] = float(metrics["target_staleness"])
  out["reanalyze"]["staleness_before"] = stale_before

  out["default_reanalyze"] = make_sharded_program(
      net, env, config, create_optimizer("adam", 1e-3), mesh).reanalyze
  errors = []
  for cfg, segments in ((small_config(num_envs=10), 0),
                        (small_config(batch_size=18), 0), (config, 6)):
    try:
      make_sharded_program(net, env, cfg, create_optimizer("adam", 1e-3),
                           mesh, reanalyze_segments=segments)
      errors.append(None)
    except ValueError as e:
      errors.append(str(e))
  out["divisibility_errors"] = errors
  return out


def learner_scenarios(rank, tree):
  """One averaged update on this rank's window-invariant ring, from the JAX
  package's init ``tree``, over the world's group on each of the learner's
  paths (raw and hybrid through the kernels' plain versions, and generic);
  then, on a group of this rank alone, two updates with and without the
  group."""
  out = {}
  group = make_mesh(device="cpu").get_group(DATA_AXIS)
  net = make_mlp_networks(device="cpu", **NET)
  for path in PATHS:
    params = mlp_params_from_numpy(tree, net)
    opt = sgd(1e-2)
    ts = TrainState(params, opt.init(params), 0)
    mu = make_multi_update_fn(net, opt, parity_config(path), group=group)
    rs = uniform_replay(rank)
    out[f"mode_{path}"] = mu.fused_group_status(ts, rs)[0]
    (ts, _, _), out[f"all_reduces_{path}"] = _counted(
        lambda: mu(ts, rs, torch.Generator().manual_seed(3)))
    out[f"params_{path}"] = flat_parameters(ts.params).numpy().copy()

  # A world of one: every rank makes every single-rank group, in order.
  alone = [dist.new_group([r]) for r in range(dist.get_world_size())][rank]
  for name, g in (("alone", alone), ("none", None)):
    params = mlp_params_from_numpy(tree, net)
    opt = create_optimizer("adam", 1e-3)
    ts = TrainState(params, opt.init(params), 0)
    cfg = copy.deepcopy(parity_config("raw"))
    cfg.train.updates_per_iteration = 2
    mu = make_multi_update_fn(net, opt, cfg, group=g)
    (ts, _, _), calls = _counted(lambda: mu(
        ts, uniform_replay(rank), torch.Generator().manual_seed(7)))
    out[f"world1_{name}"] = dict(_state(ts), all_reduces=calls)
  return out


def model_parallel_scenarios(rank, az_tree, obs):
  """The channel-sharded AZ resnet on (1, 4) and (2, 2) meshes: each rank's
  data shard of the outputs and its shard of a [3, 3, 16, 16] conv."""
  out = {}
  network = make_az_resnet(7, channels=16, num_blocks=2, device="cpu")
  params = az_params_from_numpy(az_tree, network, obs.shape[1:])
  for shape in ((1, 4), (2, 2)):
    mesh = make_mesh(shape, (DATA_AXIS, MODEL_AXIS), device="cpu")
    sharded = shard_az_params(params, mesh)
    apply = make_model_parallel_apply(network, mesh)
    with torch.no_grad():
      logits, value = apply(sharded, torch.from_numpy(obs))
    out[shape] = {"logits": logits.numpy(), "value": value.numpy(),
                  "conv_local": tuple(
                      sharded["blocks.0.conv_in.weight"].shape),
                  "conv_global": tuple(
                      params.network.blocks[0].conv_in.weight.shape),
                  "data_index": mesh.get_coordinate()[0]}
  return out


def worker(rank, world_size, init_method, inputs):
  torch.set_num_threads(1)
  dist.init_process_group("gloo", init_method=init_method,
                          world_size=world_size, rank=rank)
  try:
    return {"sharded": sharded_scenarios(rank),
            "learner": learner_scenarios(rank, inputs["mlp_tree"]),
            "model_parallel": model_parallel_scenarios(
                rank, inputs["az_tree"], inputs["az_obs"])}
  finally:
    dist.destroy_process_group()
