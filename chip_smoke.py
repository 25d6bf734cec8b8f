"""Smoke run of the PyTorch port (``muax_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments:

  python3 chip_smoke.py

Phase 0 builds every CUDA kernel of the port from the sources in the
checkout, one ``nvcc`` per source, all at once. Phases 1 and 2 hold the
search kernel against its plain PyTorch version at the rollout's shapes and
at edge shapes. Phase 3 drives self-play, MuZero on CartPole
(``make_rollout_fn`` at 8192 envs x 64 simulations x 20 steps, the rollout
of ``bench.py``'s default run), counts the kernel launches it makes and
checks what it returns; then it times the search kernel and its plain
version on the inputs of that run.

Phases 4 to 7 do the same for training, at ``bench.py``'s
``training_regime`` (1024 envs x 64 simulations x 20 steps, batch 4096,
samples per insert 32 -> 160 updates in groups of 16, ring of 2048
segments, unroll 5). Phase 4 holds the sampler kernel against its plain
version on a ring filled by the port's own rollouts (65,536 windows), then
at an edge shape; phase 5 holds the learner kernel against its plain
version (autograd over ``muzero_loss``) on phase 4's windows and at an edge
shape, and checks that a repeated launch gives bit-identical gradients.
Phase 6 drives the training iteration (rollout -> ``replay_add`` ->
``make_multi_update_fn``), checks its launch counts exactly and times it and
each kernel. Phase 7 runs ``fit`` through its normal entry for 3 iterations
with evaluation and checkpoints.

Phases 8 to 11 drive Gumbel MuZero and the generic search engine. Phase 8
holds the search kernel's Gumbel mode against its plain version at 8192
envs x 64 simulations (A = 2, at most 16 considered actions) and at an edge
shape (1003 envs, A = 4 with one invalid action, so 3 considered, depth cap
2, towers (16, 16)), and checks that the policy's action agrees. Phase 9
drives ``make_rollout_fn`` with ``policy="gumbel"`` at ``bench.py``'s
``gumbel_mlp`` (8192 envs x 64 simulations x 20 steps): exactly 20 Gumbel
launches and no MuZero launch per rollout. Phase 10 drives the training
iteration at ``gumbel_training`` (1024 envs, batch 4096, samples per insert
32, presample 16): exactly 20 + 10 + 160 launches. Phase 11 runs one policy
step of the generic engine (``search.fused=False``) for each policy at 1024
envs x 64 simulations on the card: no kernel launch, and visits within 2 of
the kernel's.

Every failed check raises, so the script exits non-zero and prints no result.
Without a CUDA card, or without the package beside it, it fails the same way.
The line before the last lists every kernel with its launches, error, times
and bound; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": <card>, "count": <cards>}}.
"""
import json
import math
import os
import subprocess
import sys
import time

import torch

SEED = 0
# The main path: bench.py's default rollout (flagship MLP triplet, CartPole).
MAIN_ENVS, MAIN_SIMS, MAIN_STEPS = 8192, 64, 20
EMBED, SUPPORT = 8, 20
# Edge shapes: a batch that does not fill the kernel's last block.
EDGE_ENVS = 1003
WARMUP_ROLLOUTS, TIMED_ROLLOUTS = 2, 3
# The training path: bench.py's training_regime (bench.py:463-467).
TRAIN_ENVS, TRAIN_BATCH, TRAIN_SPI, TRAIN_PRESAMPLE = 1024, 4096, 32.0, 16
TRAIN_CAPACITY, TRAIN_UNROLL, TRAIN_NSTEP = 2048, 5, 10
TRAIN_UPDATES = -(-int(TRAIN_SPI) * TRAIN_ENVS * MAIN_STEPS // TRAIN_BATCH)
TRAIN_GROUP = 16  # gcd(160, 16)
WARMUP_ITERATIONS, TIMED_ITERATIONS = 2, 3
# Published peaks of the H100 SXM (NVIDIA's data sheet): f32 outside the
# tensor cores, and HBM3.
PEAK_F32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12


def check(cond, message):
  if not cond:
    raise RuntimeError(f"check failed: {message}")


def card_line():
  """The card's name and power limit, as nvidia-smi prints them."""
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, check=True)
  return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps):
  """Mean device time of ``fn`` over ``reps`` calls, after one warm-up, with
  CUDA events around the whole run."""
  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  end.synchronize()
  return start.elapsed_time(end) / reps


def search_bound_ms(batch, sims, weights, with_invalid, gumbel=False):
  """Least time for one search launch: the larger of its operations over
  the f32 peak and its bytes over the memory rate. Operations are the two
  towers' multiply-adds, once per expansion (batch x sims expansions); bytes
  are each input read once and each output written once. The Gumbel mode
  also reads the root score [B, A] and the schedule [B, sims]."""
  macs = sum(w.shape[0] * w.shape[1] for w, _ in weights.layers())
  flops = 2.0 * macs * batch * sims
  num_actions = weights.pred_policy[0].shape[1]
  embed = weights.dyn_state[0].shape[1]
  floats = batch * (embed + num_actions + 1)       # roots
  floats += batch * num_actions * with_invalid     # invalid mask
  floats += weights.flat().numel()
  floats += batch * (2 * num_actions + 1)          # visits, value, q
  floats += batch * (num_actions + sims) * gumbel  # root score, schedule
  t_ops = flops / PEAK_F32_FLOPS * 1e3
  t_bytes = 4.0 * floats / PEAK_BYTES_PER_S * 1e3
  return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def compare_search(out, ref, sims, invalid=None):
  """Kernel against plain: visits sum to ``sims``; at least 99 % of envs
  within 2 visits of the plain version, their root values within
  rtol = atol = 1e-3, and, where the visits agree exactly, the root q within
  the same. A score tie that f32 rounding breaks the other way moves a
  visit, and the subtree under it differs from then on."""
  visits, value, q = out
  ref_visits, ref_value, ref_q = ref
  check(bool((visits.sum(-1) == sims).all()), "visits sum to num_simulations")
  check(bool((ref_visits.sum(-1) == sims).all()),
        "plain visits sum to num_simulations")
  dv = (visits - ref_visits).abs().amax(-1)
  near, exact = dv <= 2, dv == 0
  share = float(near.float().mean())
  check(share >= 0.99, f"{share:.4f} of envs within 2 visits (need 0.99)")
  check(torch.allclose(value[near], ref_value[near], rtol=1e-3, atol=1e-3),
        "root values agree")
  check(torch.allclose(q[exact], ref_q[exact], rtol=1e-3, atol=1e-3),
        "root q agree where visits agree")
  if invalid is not None:
    check(float(visits[invalid > 0].abs().max()) == 0.0,
          "invalid actions get no visits")
  err = max(float((value[exact] - ref_value[exact]).abs().max()),
            float((q[exact] - ref_q[exact]).abs().max()))
  return {"within_2_visits": share, "exact_visits": float(
      exact.float().mean()), "max_abs_err": err}


def kernel_against_plain(device, num_actions, layers, batch, sims,
                         max_depth=None, with_invalid=False):
  """Phase 1 or 2: seeded weights, roots from random CartPole observations
  through make_root_fn, the kernel and the plain version on the same
  inputs."""
  from muax_tpu_torch.envs import CartPole
  from muax_tpu_torch.models import make_mlp_networks
  from muax_tpu_torch.search import fused
  from muax_tpu_torch.train.inference import make_root_fn

  net = make_mlp_networks(num_actions, embedding_dim=EMBED,
                          support_size=SUPPORT, pred_layers=layers,
                          dyn_layers=layers, device=device)
  params = net.init_params((4,), torch.Generator().manual_seed(SEED))
  gen = torch.Generator(device=device).manual_seed(SEED)
  _, obs = CartPole().reset(gen, batch)
  invalid = None
  if with_invalid:
    pick = torch.randint(0, num_actions, (batch,), generator=gen,
                         device=device)
    invalid = torch.nn.functional.one_hot(pick, num_actions).float()
  with torch.no_grad():
    root = make_root_fn(net)(params, obs)
    logits = fused.noised_root_logits(gen, root.prior_logits, invalid)
  weights = fused.extract_fused_weights(net, params)
  args = (root.embedding.contiguous(), logits, root.value.contiguous(),
          weights)
  kwargs = dict(num_simulations=sims, support_size=SUPPORT, discount=0.997,
                invalid_actions=invalid, max_depth=max_depth)
  before = fused.launches
  out = fused.fused_muzero_search(*args, **kwargs)
  torch.cuda.synchronize()
  check(fused.launches == before + 1, "the wrapper launched the kernel")
  ref = fused.fused_muzero_search_reference(*args, **kwargs)
  return compare_search(out, ref, sims, invalid)


def gumbel_kernel_against_plain(device, num_actions, layers, batch, sims,
                                max_depth=None, with_invalid=False,
                                max_considered=16):
  """Phase 8: the Gumbel mode of the kernel against its plain version on
  the same inputs (roots from random CartPole observations, Gumbel noise
  from SEED), as compare_search; then the policy's action from either
  output, which must agree on at least 99 % of envs."""
  from muax_tpu_torch.envs import CartPole
  from muax_tpu_torch.models import make_mlp_networks
  from muax_tpu_torch.replay.buffer import gumbel_noise
  from muax_tpu_torch.search import fused
  from muax_tpu_torch.search.policies import _mask_invalid
  from muax_tpu_torch.train.inference import make_root_fn

  net = make_mlp_networks(num_actions, embedding_dim=EMBED,
                          support_size=SUPPORT, pred_layers=layers,
                          dyn_layers=layers, device=device)
  params = net.init_params((4,), torch.Generator().manual_seed(SEED))
  gen = torch.Generator(device=device).manual_seed(SEED)
  _, obs = CartPole().reset(gen, batch)
  invalid = None
  if with_invalid:
    pick = torch.randint(0, num_actions, (batch,), generator=gen,
                         device=device)
    invalid = torch.nn.functional.one_hot(pick, num_actions).float()
  with torch.no_grad():
    root = make_root_fn(net)(params, obs)
  logits = _mask_invalid(root.prior_logits, invalid).contiguous()
  gumbel = gumbel_noise(gen, (batch, num_actions), device)
  root_score, schedule = fused.gumbel_root_inputs(
      logits, gumbel, invalid, max_num_considered_actions=max_considered,
      num_simulations=sims)
  args = (root.embedding.contiguous(), logits, root.value.contiguous(),
          fused.extract_fused_weights(net, params))
  kwargs = dict(num_simulations=sims, support_size=SUPPORT, discount=0.997,
                invalid_actions=invalid, max_depth=max_depth)
  before = (fused.launches, fused.gumbel_launches)
  out = fused.fused_gumbel_search(*args, gumbel=gumbel,
                                  max_num_considered_actions=max_considered,
                                  **kwargs)
  torch.cuda.synchronize()
  check((fused.launches, fused.gumbel_launches)
        == (before[0], before[1] + 1), "the wrapper launched the Gumbel mode")
  ref = fused.fused_gumbel_search_reference(
      *args, root_score=root_score, schedule=schedule, **kwargs)
  figures = compare_search(out, ref, sims, invalid)
  action, _ = fused.gumbel_action(out[0], out[2], gumbel, logits, invalid)
  ref_action, _ = fused.gumbel_action(ref[0], ref[2], gumbel, logits,
                                      invalid)
  same = float((action == ref_action).float().mean())
  check(same >= 0.99, f"{same:.4f} of envs take the plain version's action "
        "(need 0.99)")
  if invalid is not None:
    check(not bool(invalid[torch.arange(batch, device=device),
                           action.long()].any()),
          "no env takes an invalid action")
  figures["same_action"] = same
  return figures


def drive_main_path(device, policy="muzero"):
  """Phase 3 (MuZero) or 9 (Gumbel): make_rollout_fn at the main path's
  size. Every rollout launches the kernel in ``policy``'s mode once per
  step and the other mode never. Returns the launch count of the run, its
  figures and the kernel's inputs on its last state."""
  from muax_tpu_torch.config import MuZeroConfig, SearchConfig, TrainConfig
  from muax_tpu_torch.envs import AutoResetWrapper, CartPole
  from muax_tpu_torch.models import make_mlp_networks
  from muax_tpu_torch.replay.buffer import gumbel_noise
  from muax_tpu_torch.search import fused
  from muax_tpu_torch.train import make_rollout_fn
  from muax_tpu_torch.train.inference import make_root_fn

  env = AutoResetWrapper(CartPole())
  net = make_mlp_networks(num_actions=2, embedding_dim=EMBED,
                          support_size=SUPPORT, device=device)
  params = net.init_params(env.spec.observation_shape,
                           torch.Generator().manual_seed(SEED))
  config = MuZeroConfig(
      search=SearchConfig(policy=policy, num_simulations=MAIN_SIMS),
      train=TrainConfig(num_envs=MAIN_ENVS, collect_steps=MAIN_STEPS))
  rollout = make_rollout_fn(net, env, config, device=device)
  gen = torch.Generator(device=device).manual_seed(SEED)
  carry = env.reset(gen, MAIN_ENVS)
  gumbel = policy == "gumbel"

  def counts():
    return (fused.launches, fused.gumbel_launches)

  def one(carry):
    before = counts()
    carry, seg, prio, metrics = rollout(params, carry, gen,
                                        params.temperature)
    got = tuple(a - b for a, b in zip(counts(), before))
    want = (0, MAIN_STEPS) if gumbel else (MAIN_STEPS, 0)
    check(got == want, f"(muzero, gumbel) kernel launches {got} in a "
          f"{policy} rollout of {MAIN_STEPS} steps, not {want}")
    return carry, seg, prio, metrics

  fused.launches = fused.gumbel_launches = 0
  finished = 0
  for _ in range(WARMUP_ROLLOUTS):
    carry, seg, prio, metrics = one(carry)
    finished += int(metrics["episodes_finished"])
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(TIMED_ROLLOUTS):
    carry, seg, prio, metrics = one(carry)
    finished += int(metrics["episodes_finished"])
  end.record()
  end.synchronize()
  launches = counts()[1 if gumbel else 0]
  rollout_ms = start.elapsed_time(end) / TIMED_ROLLOUTS

  B, T = MAIN_ENVS, MAIN_STEPS
  shapes = {"obs": (B, T, 4), "action": (B, T), "reward": (B, T),
            "done": (B, T), "rn": (B, T), "value": (B, T),
            "pi": (B, T, 2), "weight": (B,), "mask": (B, T)}
  for name, shape in shapes.items():
    got = tuple(getattr(seg, name).shape)
    check(got == shape, f"segment {name} has shape {got}, not {shape}")
    if name not in ("action", "done"):
      check(bool(torch.isfinite(getattr(seg, name)).all()),
            f"segment {name} is finite")
  check(tuple(prio.shape) == (B, T) and bool(torch.isfinite(prio).all()),
        "priorities [B, T] are finite")
  check(bool(((seg.action >= 0) & (seg.action < 2)).all()), "actions valid")
  check(torch.allclose(seg.pi.sum(-1), torch.ones(B, T, device=device),
                       atol=1e-5), "pi rows sum to 1")
  check(finished > 0, "at least one episode finished")

  with torch.no_grad():
    root = make_root_fn(net)(params, carry.obs)
  kwargs = dict(num_simulations=MAIN_SIMS, support_size=SUPPORT,
                discount=config.train.discount)
  if gumbel:
    logits = root.prior_logits.contiguous()
    kwargs.update(invalid_actions=None, max_depth=None)
    kwargs["root_score"], kwargs["schedule"] = fused.gumbel_root_inputs(
        logits, gumbel_noise(gen, logits.shape, device), None,
        max_num_considered_actions=config.search.max_num_considered_actions,
        num_simulations=MAIN_SIMS)
  else:
    logits = fused.noised_root_logits(gen, root.prior_logits)
  search_in = ((root.embedding.contiguous(), logits, root.value.contiguous(),
                fused.extract_fused_weights(net, params)), kwargs)
  figures = {"rollout_ms": rollout_ms,
             "env_steps_per_s": B * T / (rollout_ms / 1e3),
             "episodes_finished": finished, "launches": launches}
  return launches, figures, search_in


def training_config(policy="muzero"):
  """bench.py's training_regime (bench.py:463-467, run_config), or with
  ``policy="gumbel"`` its gumbel_training (bench.py:306-309)."""
  from muax_tpu_torch.config import (MuZeroConfig, ReplayConfig,
                                     SearchConfig, TrainConfig)
  return MuZeroConfig(
      search=SearchConfig(policy=policy, num_simulations=MAIN_SIMS),
      replay=ReplayConfig(capacity=TRAIN_CAPACITY, min_fill=64),
      train=TrainConfig(num_envs=TRAIN_ENVS, collect_steps=MAIN_STEPS,
                        batch_size=TRAIN_BATCH,
                        updates_per_iteration=TRAIN_UPDATES,
                        unroll_steps=TRAIN_UNROLL, n_bootstrap=TRAIN_NSTEP,
                        presample_updates=TRAIN_PRESAMPLE))


def training_setup(device, policy="muzero"):
  """The training regime built from the port's entry points, with random
  weights from SEED: networks, rollout, learner, ring, env carry."""
  from types import SimpleNamespace

  from muax_tpu_torch.envs import AutoResetWrapper, CartPole
  from muax_tpu_torch.models import make_mlp_networks, muzero_optimizer
  from muax_tpu_torch.replay import replay_init
  from muax_tpu_torch.train import (TrainState, make_multi_update_fn,
                                    make_rollout_fn)

  config = training_config(policy)
  env = AutoResetWrapper(CartPole())
  net = make_mlp_networks(num_actions=2, embedding_dim=EMBED,
                          support_size=SUPPORT, device=device)
  params = net.init_params((4,), torch.Generator().manual_seed(SEED))
  optimizer = muzero_optimizer()
  gen = torch.Generator(device=device).manual_seed(SEED)
  return SimpleNamespace(
      config=config, env=env, net=net, gen=gen,
      rollout=make_rollout_fn(net, env, config, device=device),
      multi_update=make_multi_update_fn(net, optimizer, config),
      ts=TrainState(params, optimizer.init(params), 0),
      rs=replay_init(TRAIN_CAPACITY, MAIN_STEPS, (4,), 2, device=device),
      carry=env.reset(gen, TRAIN_ENVS))


def loss_kwargs(config):
  return dict(l2_coef=config.train.l2_coef,
              gradient_scale=config.train.gradient_scale,
              priority_alpha=config.replay.priority_alpha)


def compare_raw(raw, ref, lay):
  """Sampler kernel against plain: the start agrees on at least 99.99 % of
  windows (logf and torch.log may differ by an ulp at a near-tie), and
  where it agrees every raw row is exactly equal."""
  same = raw[lay.start] == ref[lay.start]
  share = float(same.float().mean())
  check(share >= 0.9999, f"{share:.6f} of windows with the same start "
        "(need 0.9999)")
  err = float((raw[:, same] - ref[:, same]).abs().max())
  check(err == 0.0, f"raw rows differ by {err} where the start agrees")
  return {"same_start": share, "max_abs_err": err}


def fill_ring(t):
  """Two rollouts of the port fill the ring (2048 segments); returns the
  last segments and priorities."""
  from muax_tpu_torch.replay import replay_add

  for _ in range(2):
    t.carry, seg, prio, _ = t.rollout(t.ts.params, t.carry, t.gen,
                                      t.ts.params.temperature)
    replay_add(t.rs, seg, prio, step=t.ts.step)
  check(t.rs.size == TRAIN_CAPACITY, "two rollouts fill the ring")
  return seg, prio


def sampler_against_plain(device, t):
  """Phase 4: fill the ring with two rollouts of the port (2048 segments),
  draw W = 16 x 4096 windows as the learner does, kernel against plain;
  then W = 1000 from a half-filled ring of 64 segments with dones."""
  from muax_tpu_torch.replay import fused_sampler, replay_add, replay_init
  from muax_tpu_torch.replay.buffer import gumbel_noise
  from muax_tpu_torch.types import Transition

  seg, prio = fill_ring(t)

  def one(state, W):
    seg_idx = fused_sampler.draw_segments(state, t.gen, W)
    gumbel = gumbel_noise(t.gen, (MAIN_STEPS, W), device)
    before = fused_sampler.launches
    raw, lay = fused_sampler.fused_sample_group(state, seg_idx, gumbel,
                                                TRAIN_UNROLL)
    torch.cuda.synchronize()
    check(fused_sampler.launches == before + 1, "the sampler launched")
    ref, _ = fused_sampler.fused_sample_group_reference(state, seg_idx,
                                                        gumbel, TRAIN_UNROLL)
    return compare_raw(raw, ref, lay), (seg_idx, gumbel, raw, lay)

  main, inputs = one(t.rs, TRAIN_GROUP * TRAIN_BATCH)
  edge_ring = replay_init(64, MAIN_STEPS, (4,), 2, device=device)
  replay_add(edge_ring, Transition(**{
      k: v[:32] for k, v in vars(seg).items()}), prio[:32])
  check(bool(edge_ring.done[:32].any()), "the edge ring holds dones")
  edge, _ = one(edge_ring, 1000)
  return main, edge, inputs


def grads_close(grads, ref, rtol, atol):
  """Largest |kernel - plain| and the largest share of the tolerance
  atol + rtol |plain| that an element uses; fails above 1."""
  err = (grads - ref).abs()
  used = float((err / (atol + rtol * ref.abs())).max())
  check(used <= 1.0, f"gradients differ by up to {float(err.max()):.3g} "
        f"({used:.3g} of the tolerance rtol {rtol} / atol {atol})")
  return float(err.max()), used


def metrics_close(metrics, ref):
  for name in ("total", "reward_loss", "value_loss", "policy_loss",
               "l2_loss"):
    a, b = float(getattr(metrics, name)), float(getattr(ref, name))
    check(abs(a - b) <= 1e-5 * abs(b), f"{name}: {a} against plain {b}")
  # Priorities are |v0 - rn0|^0.5, and v0 is h^-1 of a 41-bin expectation,
  # which amplifies f32 rounding: |v0| ~ 10 carries errors of ~1e-4.
  check(torch.allclose(metrics.priorities, ref.priorities, rtol=1e-4,
                       atol=1e-4), "priorities agree")


def learner_against_plain(device, t, raw, lay):
  """Phase 5: the learner kernel against autograd over muzero_loss on the
  first 4096 of phase 4's windows (the flagship triplet), and on a seeded
  batch of 1000 windows with masks (A = 4, towers (16, 16), support 10);
  two launches on the same inputs give bit-identical gradients."""
  from muax_tpu_torch.models import fused_learner, make_mlp_networks
  from muax_tpu_torch.types import Transition

  kw = loss_kwargs(t.config)

  def one(net, params, raw_b, coef, lay):
    lw = fused_learner.extract_learner_weights(net, params)
    before = fused_learner.launches
    grads, metrics = fused_learner.fused_muzero_grad_raw(
        params, raw_b, coef, lay, net, lw, **kw)
    again, _ = fused_learner.fused_muzero_grad_raw(params, raw_b, coef, lay,
                                                   net, lw, **kw)
    torch.cuda.synchronize()
    check(fused_learner.launches == before + 2, "the learner launched")
    check(torch.equal(grads, again), "a repeated launch gives bit-identical "
          "gradients")
    ref_grads, ref_metrics = fused_learner.fused_muzero_grad_raw_reference(
        params, raw_b, coef, lay, net, **kw)
    err, used = grads_close(grads, ref_grads, 2e-4, 1e-6)
    metrics_close(metrics, ref_metrics)
    return {"max_abs_err": err, "tolerance_used": used}

  B = TRAIN_BATCH
  raw_b = raw[:, :B]
  w_raw = raw_b[lay.weight]
  coef = (w_raw / torch.clamp(w_raw.mean(), min=1e-9) / raw_b[lay.denom]
          / B).contiguous()
  main = one(t.net, t.ts.params, raw_b, coef, lay)

  A, Be, K = 4, 1000, TRAIN_UNROLL
  net = make_mlp_networks(A, embedding_dim=EMBED, support_size=10,
                          pred_layers=(16, 16), dyn_layers=(16, 16),
                          device=device)
  params = net.init_params((4,), torch.Generator().manual_seed(SEED + 1))
  gen = torch.Generator(device=device).manual_seed(SEED + 1)
  lengths = torch.randint(1, K + 1, (Be,), generator=gen, device=device)
  batch = Transition(
      obs=torch.randn((Be, K, 4), generator=gen, device=device),
      action=torch.randint(0, A, (Be, K), generator=gen, device=device),
      reward=torch.randn((Be, K), generator=gen, device=device),
      done=torch.zeros((Be, K), dtype=torch.bool, device=device),
      rn=torch.randn((Be, K), generator=gen, device=device) * 5,
      value=torch.zeros((Be, K), device=device),
      pi=torch.softmax(torch.randn((Be, K, A), generator=gen,
                                   device=device), -1),
      weight=torch.rand((Be,), generator=gen, device=device) + 0.5,
      mask=(torch.arange(K, device=device)[None] < lengths[:, None]).float())
  edge = one(net, params, *fused_learner.raw_from_batch(batch, K))
  return main, edge


def sampler_bound_ms(lay, W, L):
  """Least time for one sampler launch: per window its index (8 bytes),
  num_starts Gumbels and priorities, the start observation, K actions,
  rewards, returns and dones (one byte), K x A policy entries and the
  target step read once, and the raw rows written once; against that the
  log, add and compare of each valid start."""
  num_starts = L - lay.K + 1
  per_window = (8 + 8 * num_starts + 4 * lay.O + 13 * lay.K
                + 4 * lay.K * lay.A + 4 + 4 * lay.rows)
  t_bytes = W * per_window / PEAK_BYTES_PER_S * 1e3
  t_ops = 3.0 * W * num_starts / PEAK_F32_FLOPS * 1e3
  return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def learner_bound_ms(net, lay, B, n_weights):
  """Least time for one learner launch. Operations: per window the
  forward's multiply-adds (representation, then K x prediction and
  dynamics) and twice as many for the backward; bytes: the raw rows, coef
  and weights read once, gradients, metrics and l2 written once."""
  E, A, S41 = net.embedding_dim, net.num_actions, net.full_support

  def tower(in_dim, hidden, heads):
    macs = 0
    for h in hidden:
      macs += in_dim * h
      in_dim = h
    return macs + in_dim * sum(heads)

  fwd = (tower(lay.O, net.repr_layers, (E,))
         + lay.K * (tower(E, net.pred_layers, (S41, A))
                    + tower(E + A, net.dyn_layers, (S41, E))))
  t_ops = 2.0 * 3.0 * fwd * B / PEAK_F32_FLOPS * 1e3
  floats = lay.rows * B + B + 2 * n_weights + 4 * B + 1
  t_bytes = 4.0 * floats / PEAK_BYTES_PER_S * 1e3
  return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def profile_iteration(one):
  """One more training iteration under torch.profiler: device time by
  kernel (self CUDA time summed over launches), the device's busy time and
  the count of kernel launches. Profiling slows the host, so the busy time
  is set against the unprofiled iteration time by the caller."""
  from torch.profiler import ProfilerActivity, profile

  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    one()
    torch.cuda.synchronize()
  kernels = [e for e in prof.key_averages()
             if getattr(e, "device_type", None) is not None
             and "CUDA" in str(e.device_type)]
  busy_us = sum(e.self_device_time_total for e in kernels)
  if busy_us <= 0:
    return {"device_busy_ms": None, "kernel_launches": None, "top": None}
  top = sorted(kernels, key=lambda e: e.self_device_time_total,
               reverse=True)[:8]
  return {"device_busy_ms": busy_us / 1e3,
          "kernel_launches": sum(e.count for e in kernels),
          "top": [[e.key[:60], e.self_device_time_total / 1e3, e.count]
                  for e in top]}


def drive_training(device, t):
  """Phase 6 (MuZero) or 10 (Gumbel): the training iteration, rollout ->
  replay_add -> make_multi_update_fn, 2 warm-up and 3 timed iterations.
  Every iteration launches exactly 20 searches in the config's mode (and
  none in the other), 10 samplers and 160 learners."""
  from muax_tpu_torch.models import fused_learner
  from muax_tpu_torch.replay import fused_sampler, replay_add
  from muax_tpu_torch.search import fused

  gumbel = t.config.search.policy == "gumbel"
  # Launch counters: search in this mode, sampler, learner, the other mode.
  counters = [(fused, "gumbel_launches" if gumbel else "launches"),
              (fused_sampler, "launches"), (fused_learner, "launches"),
              (fused, "launches" if gumbel else "gumbel_launches")]
  expected = (MAIN_STEPS, TRAIN_UPDATES // TRAIN_GROUP, TRAIN_UPDATES, 0)

  def read():
    return tuple(getattr(module, name) for module, name in counters)

  marks = []  # per timed iteration: events before, between and after

  def one(timed=False):
    before = read()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    events[0].record()
    t.carry, seg, prio, _ = t.rollout(t.ts.params, t.carry, t.gen,
                                      t.ts.params.temperature)
    replay_add(t.rs, seg, prio, step=t.ts.step)
    events[1].record()
    t.ts, t.rs, metrics = t.multi_update(t.ts, t.rs, t.gen)
    events[2].record()
    if timed:
      marks.append(events)
    got = tuple(a - b for a, b in zip(read(), before))
    check(got == expected, f"launches (search, sampler, learner, other "
          f"search mode) {got} in one iteration, not {expected}")
    return metrics

  for module, name in counters:
    setattr(module, name, 0)
  runs = [one() for _ in range(WARMUP_ITERATIONS)]
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  runs += [one(timed=True) for _ in range(TIMED_ITERATIONS)]
  end.record()
  end.synchronize()
  launches = list(read()[:3])
  iteration_ms = start.elapsed_time(end) / TIMED_ITERATIONS
  profile = profile_iteration(one)
  for metrics in runs:
    check(metrics["updates_done"] == TRAIN_UPDATES,
          f"{metrics['updates_done']} updates, not {TRAIN_UPDATES}")
    for k, v in metrics.items():
      check(math.isfinite(float(v)), f"metric {k} = {float(v)} is finite")
  figures = {
      "iteration_ms": iteration_ms,
      "env_steps_per_s": TRAIN_ENVS * MAIN_STEPS / (iteration_ms / 1e3),
      "learner_windows_per_s": TRAIN_UPDATES * TRAIN_BATCH
                               / (iteration_ms / 1e3),
      "rollout_ms": sum(a.elapsed_time(b) for a, b, _ in marks)
                    / TIMED_ITERATIONS,
      "learner_ms": sum(b.elapsed_time(c) for _, b, c in marks)
                    / TIMED_ITERATIONS,
      "launches": dict(zip(("search", "sampler", "learner"), launches)),
      "loss": float(runs[-1]["loss"]),
      "profile": profile,
  }
  if profile["device_busy_ms"] is not None:
    profile["device_idle_share"] = 1.0 - profile["device_busy_ms"] / (
        iteration_ms)
  return launches, figures


def drive_fit(device, root):
  """Phase 7: fit through its normal entry, 3 iterations of the training
  regime with eval_every=2 and checkpoint_every=2, into a temporary
  directory under build/."""
  import tempfile

  from muax_tpu_torch.envs import CartPole
  from muax_tpu_torch.models import fused_learner, make_mlp_networks
  from muax_tpu_torch.replay import fused_sampler
  from muax_tpu_torch.search import fused
  from muax_tpu_torch.train.fit import fit

  net = make_mlp_networks(num_actions=2, embedding_dim=EMBED,
                          support_size=SUPPORT, device=device)
  lines = []
  modules = (fused, fused_sampler, fused_learner)
  for m in modules:
    m.launches = 0
  os.makedirs(os.path.join(root, "build"), exist_ok=True)
  t0 = time.perf_counter()
  with tempfile.TemporaryDirectory(dir=os.path.join(root, "build")) as d:
    _, results = fit(CartPole(), net, training_config(), num_iterations=3,
                     seed=SEED, eval_every=2, log_every=1,
                     checkpoint_every=2, model_dir=d, log_fn=lines.append)
    check(results["model_path"] is not None
          and os.path.exists(results["model_path"]), "best model written")
    check(os.path.exists(os.path.join(d, "ckpt_latest.pkl")),
          "ckpt_latest.pkl written")
  seconds = time.perf_counter() - t0
  launches = [m.launches for m in modules]
  check(launches[1] == 3 * TRAIN_UPDATES // TRAIN_GROUP
        and launches[2] == 3 * TRAIN_UPDATES and launches[0] >= 4 * MAIN_STEPS,
        f"fit launched (search, sampler, learner) {launches}")
  check(len(results["history"]) == 3, "three logged iterations")
  for row in results["history"]:
    for k, v in row.items():
      check(math.isfinite(v), f"fit metric {k} = {v} is finite")
  last = results["history"][-1]
  return {"seconds": seconds, "status": lines[0],
          "launches": dict(zip(("search", "sampler", "learner"), launches)),
          "test_G": last["test_G"] if "test_G" in last else None,
          "loss": last["loss"], "best_reward": results["best_reward"]}


def generic_engine(device):
  """Phase 11: the generic engine (``search.fused=False``) on the card, one
  policy step of ``make_policy_fn`` for each policy at 1024 envs x 64
  simulations, timed, with no kernel launch; then the generic policy's
  visits against the kernel's on the same roots (no Dirichlet noise; for
  Gumbel the same noise): within 2 visits on at least 99 % of envs (PUCT's
  random tie-break and the network's own matmul against the kernel's FMAs
  may move a visit)."""
  from muax_tpu_torch.config import MuZeroConfig, SearchConfig
  from muax_tpu_torch.envs import CartPole
  from muax_tpu_torch.models import make_mlp_networks
  from muax_tpu_torch.replay.buffer import gumbel_noise
  from muax_tpu_torch.search import fused, policies
  from muax_tpu_torch.train import make_policy_fn
  from muax_tpu_torch.train.inference import make_recurrent_fn, make_root_fn

  B, discount = TRAIN_ENVS, 0.997
  net = make_mlp_networks(2, embedding_dim=EMBED, support_size=SUPPORT,
                          device=device)
  params = net.init_params((4,), torch.Generator().manual_seed(SEED))
  gen = torch.Generator(device=device).manual_seed(SEED)
  _, obs = CartPole().reset(gen, B)
  weights = fused.extract_fused_weights(net, params)
  recurrent_fn = make_recurrent_fn(net, discount)
  with torch.no_grad():
    root = make_root_fn(net)(params, obs)
  emb, value = root.embedding.contiguous(), root.value.contiguous()
  figures = {}
  for policy in ("muzero", "gumbel"):
    config = MuZeroConfig(search=SearchConfig(
        policy=policy, num_simulations=MAIN_SIMS, fused=False))
    policy_fn = make_policy_fn(net, config, discount, device=device)
    outs = []
    before = (fused.launches, fused.gumbel_launches)
    step_ms = time_ms(lambda: outs.append(policy_fn(params, gen, obs, 1.0)),
                      2)
    check((fused.launches, fused.gumbel_launches) == before,
          f"the generic {policy} policy launched no search kernel")
    action, pi, root_value = outs[-1]
    check(tuple(action.shape) == (B,) and bool(
        ((action >= 0) & (action < 2)).all()), "generic actions valid")
    check(torch.allclose(pi.sum(-1), torch.ones(B, device=device),
                         atol=1e-5), "generic pi rows sum to 1")
    check(bool(torch.isfinite(root_value).all()), "generic values finite")

    if policy == "muzero":
      out = policies.muzero_policy(params, gen, root, recurrent_fn,
                                   MAIN_SIMS, dirichlet_fraction=0.0)
      kernel = fused.fused_muzero_search(
          emb, fused.noised_root_logits(gen, root.prior_logits,
                                        dirichlet_fraction=0.0),
          value, weights, num_simulations=MAIN_SIMS, support_size=SUPPORT,
          discount=discount)
    else:
      g = gumbel_noise(gen, root.prior_logits.shape, device)
      out = policies.gumbel_muzero_policy(params, gen, root, recurrent_fn,
                                          MAIN_SIMS, gumbel=g)
      kernel = fused.fused_gumbel_search(
          emb, root.prior_logits.contiguous(), value, weights, gumbel=g,
          max_num_considered_actions=16, num_simulations=MAIN_SIMS,
          support_size=SUPPORT, discount=discount)
    visits = out.search_tree.summary().visit_counts
    check(bool((visits.sum(-1) == MAIN_SIMS).all()),
          "generic visits sum to num_simulations")
    dv = (visits - kernel[0]).abs().amax(-1)
    share = float((dv <= 2).float().mean())
    check(share >= 0.99, f"{share:.4f} of envs within 2 visits of the "
          f"{policy} kernel (need 0.99)")
    figures[policy] = {"step_ms": step_ms, "within_2_visits": share,
                       "exact_visits": float((dv == 0).float().mean())}
  return figures


def run(device):
  from muax_tpu_torch import _build
  from muax_tpu_torch.replay.buffer import gumbel_noise
  from muax_tpu_torch.search import fused

  card = card_line()
  print(card)
  t0 = time.perf_counter()
  logs = _build.build_all()
  build_s = time.perf_counter() - t0
  for name, log in logs.items():
    for line in log.splitlines():
      if "registers" in line or "spill" in line:
        print(f"  nvcc {name}: {line.strip()}")
  print("phase 0 build: " + json.dumps({
      "seconds": build_s, "sources": list(logs), "torch": torch.__version__,
      "cuda": torch.version.cuda}))

  t0 = time.perf_counter()
  main_cmp = kernel_against_plain(device, 2, (16,), MAIN_ENVS, MAIN_SIMS)
  print(f"phase 1 kernel vs plain, B={MAIN_ENVS} sims={MAIN_SIMS} A=2 "
        f"E={EMBED} S={SUPPORT} H=(16,): {json.dumps(main_cmp)} "
        f"({time.perf_counter() - t0:.1f} s)")

  t0 = time.perf_counter()
  edge_cmp = kernel_against_plain(device, 4, (16, 16), EDGE_ENVS, MAIN_SIMS,
                                  max_depth=2, with_invalid=True)
  print(f"phase 2 kernel vs plain, B={EDGE_ENVS} sims={MAIN_SIMS} A=4 with "
        f"one invalid action, max_depth=2, H=(16, 16): "
        f"{json.dumps(edge_cmp)} ({time.perf_counter() - t0:.1f} s)")

  t0 = time.perf_counter()
  launches, figures, (args, kwargs) = drive_main_path(device)
  figures["search_ms"] = time_ms(lambda: fused.fused_muzero_search(
      *args, **kwargs), 10)
  figures["plain_search_ms"] = time_ms(
      lambda: fused.fused_muzero_search_reference(*args, **kwargs), 1)
  bound_ms, bound_by = search_bound_ms(MAIN_ENVS, MAIN_SIMS, args[3], False)
  print(f"phase 3 rollout, {MAIN_ENVS} envs x {MAIN_SIMS} sims x "
        f"{MAIN_STEPS} steps: {json.dumps(figures)} "
        f"({time.perf_counter() - t0:.1f} s)")

  # ---- training: the ring, the sampler, the learner, the iteration, fit --
  from muax_tpu_torch.models import fused_learner
  from muax_tpu_torch.replay import fused_sampler

  t0 = time.perf_counter()
  t = training_setup(device)
  sampler_main, sampler_edge, (seg_idx, gumbel, raw, lay) = (
      sampler_against_plain(device, t))
  print(f"phase 4 sampler vs plain, C={TRAIN_CAPACITY} L={MAIN_STEPS} "
        f"K={TRAIN_UNROLL} W={TRAIN_GROUP * TRAIN_BATCH} on a ring of "
        f"rollouts: {json.dumps(sampler_main)}; W=1000 on a half-filled "
        f"ring with dones: {json.dumps(sampler_edge)} "
        f"({time.perf_counter() - t0:.1f} s)")

  t0 = time.perf_counter()
  learner_main, learner_edge = learner_against_plain(device, t, raw, lay)
  print(f"phase 5 learner vs plain, B={TRAIN_BATCH} on phase 4's windows: "
        f"{json.dumps(learner_main)}; B=1000 A=4 H=(16, 16) S=10 with "
        f"masks: {json.dumps(learner_edge)}; repeated launches bit-identical "
        f"({time.perf_counter() - t0:.1f} s)")

  t0 = time.perf_counter()
  train_launches, train = drive_training(device, t)
  W = TRAIN_GROUP * TRAIN_BATCH
  seg_idx = fused_sampler.draw_segments(t.rs, t.gen, W)
  gumbel = gumbel_noise(t.gen, (MAIN_STEPS, W), device)
  sample_args = (t.rs, seg_idx, gumbel, TRAIN_UNROLL)
  train["sampler_ms"] = time_ms(
      lambda: fused_sampler.fused_sample_group(*sample_args), 20)
  train["plain_sampler_ms"] = time_ms(
      lambda: fused_sampler.fused_sample_group_reference(*sample_args), 3)
  raw, lay = fused_sampler.fused_sample_group(*sample_args)
  raw_b = raw[:, :TRAIN_BATCH]
  w_raw = raw_b[lay.weight]
  coef = (w_raw / torch.clamp(w_raw.mean(), min=1e-9) / raw_b[lay.denom]
          / TRAIN_BATCH).contiguous()
  lw = fused_learner.extract_learner_weights(t.net, t.ts.params)
  kw = loss_kwargs(t.config)
  learn_args = (t.ts.params, raw_b, coef, lay, t.net)
  # The kernel's wrapper alone (block sums and their fixed-order reduction),
  # without the loss metrics that fused_muzero_grad_raw derives after it.
  train["learner_kernel_ms"] = time_ms(
      lambda: fused_learner._grad_cuda(
          lw, raw_b, coef, lay, l2_coef=kw["l2_coef"],
          gradient_scale=kw["gradient_scale"]), 20)
  train["plain_learner_ms"] = time_ms(
      lambda: fused_learner.fused_muzero_grad_raw_reference(*learn_args,
                                                            **kw), 5)
  sampler_bound, sampler_by = sampler_bound_ms(lay, W, MAIN_STEPS)
  learner_bound, learner_by = learner_bound_ms(t.net, lay, TRAIN_BATCH,
                                               lw.flat.numel())
  train.update(sampler_bound_ms=sampler_bound,
               learner_bound_ms=learner_bound)
  print(f"phase 6 training iteration, {TRAIN_ENVS} envs x {MAIN_SIMS} sims "
        f"x {MAIN_STEPS} steps, {TRAIN_UPDATES} updates of {TRAIN_BATCH} in "
        f"groups of {TRAIN_GROUP}: {json.dumps(train)} "
        f"({time.perf_counter() - t0:.1f} s)")

  t0 = time.perf_counter()
  fit_figures = drive_fit(device, os.path.dirname(os.path.abspath(__file__)))
  print(f"phase 7 fit, 3 iterations, eval_every=2, checkpoint_every=2: "
        f"{json.dumps(fit_figures)} ({time.perf_counter() - t0:.1f} s)")

  # ---- Gumbel MuZero and the generic engine ------------------------------
  t0 = time.perf_counter()
  gumbel_main = gumbel_kernel_against_plain(device, 2, (16,), MAIN_ENVS,
                                            MAIN_SIMS)
  gumbel_edge = gumbel_kernel_against_plain(device, 4, (16, 16), EDGE_ENVS,
                                            MAIN_SIMS, max_depth=2,
                                            with_invalid=True)
  print(f"phase 8 Gumbel kernel vs plain, B={MAIN_ENVS} sims={MAIN_SIMS} "
        f"A=2 max_considered=16 H=(16,): {json.dumps(gumbel_main)}; "
        f"B={EDGE_ENVS} A=4 with one invalid action (3 considered), "
        f"max_depth=2, H=(16, 16): {json.dumps(gumbel_edge)} "
        f"({time.perf_counter() - t0:.1f} s)")

  t0 = time.perf_counter()
  _, gumbel_figures, (args, kwargs) = drive_main_path(device, "gumbel")
  gumbel_figures["search_ms"] = time_ms(
      lambda: fused._fused_search_cuda(*args, **kwargs), 10)
  gumbel_figures["plain_search_ms"] = time_ms(
      lambda: fused.fused_gumbel_search_reference(*args, **kwargs), 1)
  gumbel_bound, gumbel_by = search_bound_ms(MAIN_ENVS, MAIN_SIMS, args[3],
                                            False, gumbel=True)
  gumbel_figures["bound_ms"] = gumbel_bound
  print(f"phase 9 Gumbel rollout, {MAIN_ENVS} envs x {MAIN_SIMS} sims x "
        f"{MAIN_STEPS} steps: {json.dumps(gumbel_figures)} "
        f"({time.perf_counter() - t0:.1f} s)")

  t0 = time.perf_counter()
  tg = training_setup(device, "gumbel")
  fill_ring(tg)
  gumbel_train_launches, gumbel_train = drive_training(device, tg)
  print(f"phase 10 Gumbel training iteration, {TRAIN_ENVS} envs x "
        f"{MAIN_SIMS} sims x {MAIN_STEPS} steps, {TRAIN_UPDATES} updates of "
        f"{TRAIN_BATCH} in groups of {TRAIN_GROUP}: {json.dumps(gumbel_train)}"
        f" ({time.perf_counter() - t0:.1f} s)")

  t0 = time.perf_counter()
  generic = generic_engine(device)
  print(f"phase 11 generic engine (search.fused=False), {TRAIN_ENVS} envs x "
        f"{MAIN_SIMS} sims, one policy step: {json.dumps(generic)} "
        f"({time.perf_counter() - t0:.1f} s)")

  kernels = [{
      "name": "fused_muzero_search", "route": "cuda",
      "source": "muax_tpu_torch/csrc/fused_search.cu",
      "replaces": "muax_tpu/search/fused.py:759",
      "launches": train_launches[0], "max_abs_err": main_cmp["max_abs_err"],
      "ms": figures["search_ms"], "plain_ms": figures["plain_search_ms"],
      "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
  }, {
      "name": "fused_sample_group", "route": "cuda",
      "source": "muax_tpu_torch/csrc/fused_sampler.cu",
      "replaces": "muax_tpu/replay/fused_sampler.py:280",
      "launches": train_launches[1],
      "max_abs_err": sampler_main["max_abs_err"],
      "ms": train["sampler_ms"], "plain_ms": train["plain_sampler_ms"],
      "bound_ms": sampler_bound, "bound_by": sampler_by, "library_ms": None,
  }, {
      "name": "fused_muzero_grad_raw", "route": "cuda",
      "source": "muax_tpu_torch/csrc/fused_learner.cu",
      "replaces": "muax_tpu/models/fused_learner.py:665",
      "launches": train_launches[2],
      "max_abs_err": learner_main["max_abs_err"],
      "ms": train["learner_kernel_ms"], "plain_ms": train["plain_learner_ms"],
      "bound_ms": learner_bound, "bound_by": learner_by, "library_ms": None,
  }, {
      "name": "fused_gumbel_search", "route": "cuda",
      "source": "muax_tpu_torch/csrc/fused_search.cu",
      "replaces": 'muax_tpu/search/fused.py:759 (policy="gumbel")',
      "launches": gumbel_train_launches[0],
      "max_abs_err": gumbel_main["max_abs_err"],
      "ms": gumbel_figures["search_ms"],
      "plain_ms": gumbel_figures["plain_search_ms"],
      "bound_ms": gumbel_bound, "bound_by": gumbel_by, "library_ms": None,
  }]
  print(card)
  print(json.dumps({"kernels": kernels}))
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))


def main():
  if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA card; the port's kernels run only on one")
  root = os.path.dirname(os.path.abspath(__file__))
  if not os.path.isdir(os.path.join(root, "muax_tpu_torch")):
    sys.exit(f"chip_smoke: no muax_tpu_torch package beside {__file__}")
  sys.path.insert(0, root)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  run(torch.device("cuda", 0))


if __name__ == "__main__":
  main()
