"""The end-to-end training loop (``muax_tpu/train/fit.py``): buffer
warm-up, then per iteration rollout -> replay add -> the learner's updates,
with the temperature schedule, the samples-per-insert gate, logging,
greedy evaluation, the best-model checkpoint and full checkpoints that
resume deterministically.

The env is an on-device ``Environment``, a host pool (``GymVectorPool``,
``Native2048Pool``, ``AtariVectorPool``, ``OpenSpielVectorPool``: anything
that speaks the ``AutoResetWrapper`` interface) or a string, which the
registry resolves (``envs/registry.py``). Everything runs on
``networks.device``: the card unless the networks were made with
``device="cpu"``; a pool must lie on the same device. All randomness after
the parameter init comes from one generator on that device, seeded from
``seed`` (host pools draw from their own seeds).
"""
from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from muax_tpu_torch.config import MuZeroConfig, config_hash
from muax_tpu_torch.device import resolve_device
from muax_tpu_torch.envs import registry
from muax_tpu_torch.envs.base import AutoResetWrapper, Environment
from muax_tpu_torch.fused_status import format_fused_status, fused_status
from muax_tpu_torch.models.networks import MZNetworks
from muax_tpu_torch.models.optimizers import (GradientTransformation,
                                              muzero_optimizer)
from muax_tpu_torch.replay.buffer import replay_add, replay_init
from muax_tpu_torch.train.actor import make_policy_fn, make_rollout_fn
from muax_tpu_torch.train.checkpoint import (load_checkpoint,
                                             save_checkpoint, save_pytree)
from muax_tpu_torch.train.learner import TrainState, make_multi_update_fn
from muax_tpu_torch.train.reanalyze import make_reanalyze_fn
from muax_tpu_torch.train.temperature import schedule_temperature


def make_evaluate_fn(networks: MZNetworks, env: AutoResetWrapper,
                     config: MuZeroConfig, num_envs: Optional[int] = None,
                     device="cuda"):
  """Greedy evaluation (no root noise, temperature 0): evaluate(params,
  generator) -> mean return of each env's first episode (a 0-d tensor).

  It stops once every env has finished its first episode, at most after
  ``max_episode_steps`` steps. ``num_envs`` defaults to the env's own
  ``num_envs`` where it has one (a host pool takes no other batch), else
  32.
  """
  device = resolve_device(device)
  if num_envs is None:
    num_envs = getattr(env, "num_envs", 32)
  policy_fn = make_policy_fn(networks, config, config.train.discount,
                             eval_mode=True, device=device)
  max_steps = env.spec.max_episode_steps

  @torch.no_grad()
  def evaluate(params, generator: torch.Generator) -> torch.Tensor:
    carry = env.reset(generator, num_envs)
    finished = torch.zeros(num_envs, dtype=torch.bool, device=device)
    returns = torch.zeros(num_envs, dtype=torch.float32, device=device)
    for _ in range(max_steps):
      legal = env.legal_action_mask(carry)
      invalid = None if legal is None else 1.0 - legal
      action, _, _ = policy_fn(params, generator, carry.obs, 0.0, invalid)
      carry, reward, done, _ = env.step(carry, action, generator)
      returns += torch.where(finished, torch.zeros_like(reward), reward)
      finished |= done
      if bool(finished.all()):
        break
    return torch.mean(returns)

  return evaluate


def _opt_structure(opt_state) -> tuple:
  return (type(opt_state).__name__,
          tuple(tuple(v.shape) if hasattr(v, "shape") else type(v).__name__
                for v in opt_state))


def fit(
    env,
    networks: MZNetworks,
    config: Optional[MuZeroConfig] = None,
    optimizer: Optional[GradientTransformation] = None,
    *,
    num_iterations: int = 500,
    seed: int = 42,
    eval_every: int = 20,
    log_every: int = 10,
    model_dir: str = "models",
    save_best: bool = True,
    target_reward: Optional[float] = None,
    log_fn: Callable[[str], None] = print,
    reanalyze_every: Optional[int] = None,
    reanalyze_segments: int = 64,
    eval_env=None,
    checkpoint_every: Optional[int] = None,
    resume_from: Optional[str] = None,
):
  """Train MuZero on a batched on-device env, a host pool or an env id.
  Returns (train_state, results): ``results['model_path']`` is the best
  checkpoint, ``results['history']`` the logged metrics.

  A string ``env`` resolves through the registry with ``num_envs`` envs of
  the config, a string ``eval_env`` with min(8, num_envs). Greedy
  evaluation runs on ``eval_env`` where given, else on ``env`` for an
  on-device env, which every reset mints anew. A host pool holds its
  episodes on the host, so evaluating on the training pool would break
  them: a pool without ``eval_env`` skips evaluation and tracks the best
  model by the rollout's mean episode return.

  ``reanalyze_every=N`` refreshes the targets of ``reanalyze_segments``
  segments of the ring, stalest first, after every N-th iteration
  (``train/reanalyze.py``), from the same generator as the rest of the run.

  ``checkpoint_every=K`` snapshots the full state to
  ``model_dir/ckpt_itNNNNNN.pkl`` every K iterations (hard-linked as
  ``ckpt_latest.pkl``, the last 5 kept). ``resume_from=path`` continues
  from such a snapshot; called with the same config, num_iterations and
  seed on the CPU, it reproduces the uninterrupted run bit for bit.
  """
  config = config or MuZeroConfig()
  optimizer = optimizer or muzero_optimizer()
  tcfg = config.train
  device = networks.device
  if isinstance(env, str):
    env = registry.make(env, num_envs=tcfg.num_envs, device=device)
  if isinstance(eval_env, str):
    eval_env = registry.make(eval_env, num_envs=min(8, tcfg.num_envs),
                             device=device)

  # An on-device Environment gets the auto-reset wrapper; a host pool
  # speaks the wrapper's interface already.
  def wrap(e):
    return AutoResetWrapper(e) if isinstance(e, Environment) else e

  wrapped = wrap(env)
  rollout = make_rollout_fn(networks, wrapped, config, device=device)
  multi_update = make_multi_update_fn(networks, optimizer, config)
  if eval_env is not None:
    evaluate = make_evaluate_fn(networks, wrap(eval_env), config,
                                device=device)
  elif isinstance(env, Environment):
    evaluate = make_evaluate_fn(networks, wrapped, config, num_envs=32,
                                device=device)
  else:
    evaluate = None
    log_fn("[muax_tpu_torch] host pool without eval_env: greedy eval "
           "disabled; best model tracked by rollout mean_episode_return")
  reanalyze = (make_reanalyze_fn(networks, config, reanalyze_segments,
                                 device=device)
               if reanalyze_every else None)

  params = networks.init_params(env.spec.observation_shape,
                                torch.Generator().manual_seed(seed))
  generator = torch.Generator(device=device).manual_seed(seed)
  train_state = TrainState(params=params, opt_state=optimizer.init(params),
                           step=0)
  env_carry = wrapped.reset(generator, tcfg.num_envs)
  replay_state = replay_init(
      config.replay.capacity, tcfg.collect_steps, env.spec.observation_shape,
      networks.num_actions,
      obs_dtype=getattr(env.spec, "obs_dtype", None) or torch.float32,
      device=device)
  log_fn("[muax_tpu_torch] " + format_fused_status(
      fused_status(networks, config, params, replay_state,
                   optimizer=optimizer)))

  def iteration(train_state, replay_state, env_carry, learn: bool,
                num_allowed=None):
    env_carry, segments, priorities, roll_metrics = rollout(
        train_state.params, env_carry, generator,
        train_state.params.temperature)
    replay_add(replay_state, segments, priorities, step=train_state.step)
    learn_metrics = {}
    if learn:
      train_state, replay_state, learn_metrics = multi_update(
          train_state, replay_state, generator, num_allowed)
    return train_state, replay_state, env_carry, {**roll_metrics,
                                                  **learn_metrics}

  env_steps_per_iter = tcfg.num_envs * tcfg.collect_steps
  warm_iters = max(1, config.replay.min_fill // tcfg.num_envs)
  history = []
  best_reward = -np.inf
  best_path = None
  start_it = 0
  steps_inserted = warm_iters * env_steps_per_iter
  windows_sampled = 0
  warmup_episodes = 0

  if resume_from is not None:
    ckpt = load_checkpoint(resume_from, device=device)
    saved_hash = ckpt["counters"].get("config_hash")
    if saved_hash is not None and saved_hash != config_hash(config):
      raise ValueError(
          f"checkpoint {resume_from} was written with config hash "
          f"{saved_hash} but fit() was called with {config_hash(config)}; "
          "resume requires the identical config (SPI/warm-up counters are "
          "not transferable). Pass the original config or start fresh.")
    saved = ckpt["train_state"]
    if _opt_structure(saved.opt_state) != _opt_structure(
        train_state.opt_state):
      raise ValueError(
          f"checkpoint {resume_from} holds an optimizer state shaped "
          f"{_opt_structure(saved.opt_state)} but the optimizer passed to "
          f"fit() makes {_opt_structure(train_state.opt_state)}; resume "
          "with the optimizer the checkpoint was written with.")
    params.load_state_dict(saved.params)  # in place: keeps the flat buffer
    train_state = TrainState(params=params, opt_state=saved.opt_state,
                             step=saved.step)
    replay_state = ckpt["replay_state"]
    env_carry = ckpt["env_carry"]
    generator.set_state(ckpt["generator"])
    start_it = int(ckpt["iteration"])
    c = ckpt["counters"]
    best_reward = c.get("best_reward", -np.inf)
    best_path = c.get("best_path")
    steps_inserted = c.get("steps_inserted", steps_inserted)
    windows_sampled = c.get("windows_sampled", 0)
    history = list(c.get("history", []))
    warmup_episodes = c.get("warmup_episodes", 0)
    log_fn(f"[muax_tpu_torch] resumed from {resume_from} at iteration "
           f"{start_it}")
  else:
    for _ in range(warm_iters):
      train_state, replay_state, env_carry, wm = iteration(
          train_state, replay_state, env_carry, False)
      warmup_episodes += int(wm["episodes_finished"])

  t_start = time.time()
  timed_steps = 0
  spi = tcfg.samples_per_insert

  for it in range(start_it, num_iterations):
    temperature = schedule_temperature(tcfg.temperature_schedule,
                                       num_iterations, it)
    train_state.params.temperature.fill_(float(temperature))
    steps_inserted += env_steps_per_iter
    num_allowed = None
    if spi is not None:
      # Samples-per-insert gate (Reverb's SampleToInsertRatio): sampled
      # windows may not outrun spi * inserted steps * (1 + tolerance).
      budget = spi * steps_inserted * (1.0 + tcfg.spi_tolerance)
      num_allowed = int(np.clip((budget - windows_sampled) // tcfg.batch_size,
                                0, tcfg.updates_per_iteration))
      windows_sampled += num_allowed * tcfg.batch_size
    train_state, replay_state, env_carry, metrics = iteration(
        train_state, replay_state, env_carry, True, num_allowed)
    # One readback per iteration keeps the host at most one iteration ahead.
    float(metrics["loss"])
    timed_steps += env_steps_per_iter

    if reanalyze is not None and (it + 1) % reanalyze_every == 0:
      replay_state, re_metrics = reanalyze(train_state.params, replay_state,
                                           generator, train_state.step)
      metrics = {**metrics, **re_metrics}

    if (it + 1) % log_every == 0 or it == 0:
      metrics = {k: float(v) for k, v in metrics.items()}
      elapsed = time.time() - t_start
      metrics.update(iteration=it + 1,
                     env_steps=(it + 1 + warm_iters) * env_steps_per_iter,
                     env_steps_per_s=timed_steps / max(elapsed, 1e-9))
      t_start, timed_steps = time.time(), 0

      if (it + 1) % eval_every == 0 or it == 0:
        if evaluate is not None:
          score = float(evaluate(train_state.params, generator))
          metrics["test_G"] = score
        else:
          score = metrics.get("mean_episode_return", -np.inf)
        if score > best_reward:
          best_reward = score
          if save_best:
            best_path = os.path.join(model_dir, f"best_it{it + 1}.ckpt")
            save_pytree(best_path, {
                "params": dict(train_state.params.state_dict()),
                "opt_state": train_state.opt_state,
                "step": train_state.step,
            })
      history.append(metrics)
      log_fn("[muax_tpu_torch] " + " ".join(
          f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
          for k, v in sorted(metrics.items())))
      if (target_reward is not None
          and metrics.get("test_G", -np.inf) >= target_reward):
        log_fn(f"[muax_tpu_torch] target reward {target_reward} reached at "
               f"iteration {it + 1}")
        break

    if checkpoint_every and (it + 1) % checkpoint_every == 0:
      ckpt_path = os.path.join(model_dir, f"ckpt_it{it + 1:06d}.pkl")
      save_checkpoint(
          ckpt_path, train_state=train_state, replay_state=replay_state,
          env_carry=env_carry, generator=generator, iteration=it + 1,
          counters=dict(best_reward=best_reward, best_path=best_path,
                        steps_inserted=steps_inserted,
                        windows_sampled=windows_sampled, history=history,
                        warmup_episodes=warmup_episodes,
                        config_hash=config_hash(config)))
      latest = os.path.join(model_dir, "ckpt_latest.pkl")
      if os.path.exists(ckpt_path):  # only rank 0 writes in a process group
        if os.path.lexists(latest):
          os.remove(latest)
        os.link(ckpt_path, latest)
        stamped = sorted(f for f in os.listdir(model_dir)
                         if f.startswith("ckpt_it") and f.endswith(".pkl"))
        for old in stamped[:-5]:
          os.remove(os.path.join(model_dir, old))

  return train_state, {
      "model_path": best_path,
      "warmup_episodes": warmup_episodes,
      "best_reward": best_reward,
      "history": history,
  }
