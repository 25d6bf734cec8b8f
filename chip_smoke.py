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

Phases 12 to 15 drive the acme categorical family (``bench.py``'s
``make_networks("categorical")``: embedding 64, LayerNormMLP towers (256,
256, 256), 51 linear bins over +-150) through the categorical modes of the
search kernel and the categorical learner kernel. Phase 12 holds both
policy modes of the search kernel against their plain version at
``muzero_categorical``'s shape (2048 envs x 64 simulations, A = 2) and at an
edge shape (1003 envs, A = 3 with an invalid action, depth cap 2, towers
(48, 32), 21 bins). Phase 13 drives ``make_rollout_fn`` at
``muzero_categorical`` (2048 envs x 64 simulations x 20 steps) in each
policy: exactly 20 launches of that mode and none of the others per
rollout. Phase 14 holds the categorical learner kernel against autograd
over the categorical ``muzero_loss`` on 1024 windows sampled from a ring of
the family's own rollouts, and at an edge shape, with bit-identical
repeats. Phase 15 drives one training iteration at ``categorical_training``
(512 envs x 64 simulations x 20 steps, batch 1024, samples per insert 32,
presample 16): exactly 20 + 20 + 320 launches, timed and profiled.

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
# The acme categorical family: bench.py's make_networks("categorical") and
# its muzero_categorical (bench.py:310-313) and categorical_training
# (bench.py:351-354) regimes.
CAT_NET = dict(embedding_dim=64, layer_sizes=(256, 256, 256), num_bins=51,
               vmin=-150.0, vmax=150.0)
CAT_EDGE_NET = dict(embedding_dim=16, layer_sizes=(48, 32), num_bins=21,
                    vmin=-10.0, vmax=10.0)
CAT_ENVS = 2048
CAT_TRAIN_ENVS, CAT_BATCH = 512, 1024
CAT_UPDATES = -(-int(TRAIN_SPI) * CAT_TRAIN_ENVS * MAIN_STEPS // CAT_BATCH)
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


def search_macs(weights):
  """Multiply-adds of one expansion: every linear of both towers, for the
  MLP triplet's weights or a categorical FusedNetSpec."""
  if hasattr(weights, "layers"):
    linears = [w for w, _ in weights.layers()]
  else:
    linears = [ts[0] for _, ts in weights.dyn_layers + weights.pred_layers]
    linears += [weights.dyn_reward[0], weights.dyn_state[0],
                weights.pred_value[0], weights.pred_policy[0]]
  return sum(w.shape[0] * w.shape[1] for w in linears)


def search_bound_ms(batch, sims, weights, with_invalid, gumbel=False):
  """Least time for one search launch: the larger of its operations over
  the f32 peak and its bytes over the memory rate. Operations are the two
  towers' multiply-adds, once per expansion (batch x sims expansions); bytes
  are each input read once and each output written once. The Gumbel mode
  also reads the root score [B, A] and the schedule [B, sims]."""
  flops = 2.0 * search_macs(weights) * batch * sims
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


def make_net(device, family="mlp", num_actions=2, **widths):
  """The flagship MLP triplet (bench.py:69-71) or the acme categorical
  family (bench.py:72-75) on ``device``; ``widths`` replace the towers."""
  from muax_tpu_torch.models import (make_categorical_mlp_networks,
                                     make_mlp_networks)
  if family == "categorical":
    return make_categorical_mlp_networks(num_actions, device=device,
                                         **(widths or CAT_NET))
  return make_mlp_networks(num_actions, embedding_dim=EMBED,
                           support_size=SUPPORT, device=device, **widths)


def search_counts():
  """Launches of the search kernel by mode: MLP MuZero, MLP Gumbel,
  categorical MuZero, categorical Gumbel."""
  from muax_tpu_torch.search import fused
  return (fused.launches, fused.gumbel_launches, fused.categorical_launches,
          fused.categorical_gumbel_launches)


def reset_counts():
  from muax_tpu_torch.models import fused_learner
  from muax_tpu_torch.replay import fused_sampler
  from muax_tpu_torch.search import fused
  fused.launches = fused.gumbel_launches = 0
  fused.categorical_launches = fused.categorical_gumbel_launches = 0
  fused_sampler.launches = 0
  fused_learner.launches = fused_learner.categorical_launches = 0


def search_mode(policy, family):
  """The index of ``search_counts`` that a rollout of this kind moves."""
  return (2 if family == "categorical" else 0) + (policy == "gumbel")


def search_against_plain(device, policy, family, num_actions, batch,
                         widths=None, with_invalid=False, max_depth=None):
  """Phases 1-2, 8 and 12: one mode of the search kernel against its plain
  version on the same inputs (seeded weights, roots from random CartPole
  observations, Dirichlet or Gumbel noise from SEED), as compare_search;
  in the Gumbel modes the policy's action must also agree on at least 99 %
  of envs, and no env may take an invalid action."""
  from muax_tpu_torch.envs import CartPole
  from muax_tpu_torch.replay.buffer import gumbel_noise
  from muax_tpu_torch.search import fused
  from muax_tpu_torch.search.policies import _mask_invalid
  from muax_tpu_torch.train.inference import make_root_fn

  net = make_net(device, family, num_actions, **(widths or {}))
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
  weights = fused.extract_search_weights(net, params)
  kwargs = dict(num_simulations=MAIN_SIMS, discount=0.997,
                support_size=getattr(net, "support_size", None),
                invalid_actions=invalid, max_depth=max_depth)
  mode = search_mode(policy, family)
  before = search_counts()
  if policy == "gumbel":
    logits = _mask_invalid(root.prior_logits, invalid).contiguous()
    gumbel = gumbel_noise(gen, (batch, num_actions), device)
    args = (root.embedding.contiguous(), logits, root.value.contiguous(),
            weights)
    out = fused.fused_gumbel_search(*args, gumbel=gumbel,
                                    max_num_considered_actions=16, **kwargs)
    root_score, schedule = fused.gumbel_root_inputs(
        logits, gumbel, invalid, max_num_considered_actions=16,
        num_simulations=MAIN_SIMS)
    ref = fused.fused_gumbel_search_reference(
        *args, root_score=root_score, schedule=schedule, **kwargs)
  else:
    logits = fused.noised_root_logits(gen, root.prior_logits, invalid)
    args = (root.embedding.contiguous(), logits, root.value.contiguous(),
            weights)
    out = fused.fused_muzero_search(*args, **kwargs)
    ref = fused.fused_muzero_search_reference(*args, **kwargs)
  torch.cuda.synchronize()
  got = tuple(a - b for a, b in zip(search_counts(), before))
  check(got == tuple(int(i == mode) for i in range(4)),
        f"the wrapper launched the {family} {policy} mode once, not {got}")
  figures = compare_search(out, ref, MAIN_SIMS, invalid)
  if policy == "gumbel":
    action, _ = fused.gumbel_action(out[0], out[2], gumbel, logits, invalid)
    ref_action, _ = fused.gumbel_action(ref[0], ref[2], gumbel, logits,
                                        invalid)
    same = float((action == ref_action).float().mean())
    check(same >= 0.99, f"{same:.4f} of envs take the plain version's "
          "action (need 0.99)")
    if invalid is not None:
      check(not bool(invalid[torch.arange(batch, device=device),
                             action.long()].any()),
            "no env takes an invalid action")
    figures["same_action"] = same
  return figures


def drive_main_path(device, policy="muzero", family="mlp"):
  """Phase 3 (MuZero) or 9 (Gumbel) on the MLP triplet, 13 on the
  categorical family: make_rollout_fn at the path's size. Every rollout
  launches the kernel in its mode once per step and the other modes never.
  Returns the launch count of the run, its figures and the kernel's inputs
  on its last state."""
  from muax_tpu_torch.config import MuZeroConfig, SearchConfig, TrainConfig
  from muax_tpu_torch.envs import AutoResetWrapper, CartPole
  from muax_tpu_torch.replay.buffer import gumbel_noise
  from muax_tpu_torch.search import fused
  from muax_tpu_torch.train import make_rollout_fn
  from muax_tpu_torch.train.inference import make_root_fn

  categorical = family == "categorical"
  envs = CAT_ENVS if categorical else MAIN_ENVS
  warmup, timed = (1, 2) if categorical else (WARMUP_ROLLOUTS,
                                              TIMED_ROLLOUTS)
  env = AutoResetWrapper(CartPole())
  net = make_net(device, family)
  params = net.init_params(env.spec.observation_shape,
                           torch.Generator().manual_seed(SEED))
  config = MuZeroConfig(
      search=SearchConfig(policy=policy, num_simulations=MAIN_SIMS),
      train=TrainConfig(num_envs=envs, collect_steps=MAIN_STEPS))
  rollout = make_rollout_fn(net, env, config, device=device)
  gen = torch.Generator(device=device).manual_seed(SEED)
  carry = env.reset(gen, envs)
  gumbel = policy == "gumbel"
  mode = search_mode(policy, family)
  want = tuple(MAIN_STEPS if i == mode else 0 for i in range(4))

  def one(carry):
    before = search_counts()
    carry, seg, prio, metrics = rollout(params, carry, gen,
                                        params.temperature)
    got = tuple(a - b for a, b in zip(search_counts(), before))
    check(got == want, f"search launches by mode {got} in a {family} "
          f"{policy} rollout of {MAIN_STEPS} steps, not {want}")
    return carry, seg, prio, metrics

  reset_counts()
  finished = 0
  for _ in range(warmup):
    carry, seg, prio, metrics = one(carry)
    finished += int(metrics["episodes_finished"])
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(timed):
    carry, seg, prio, metrics = one(carry)
    finished += int(metrics["episodes_finished"])
  end.record()
  end.synchronize()
  launches = search_counts()[mode]
  rollout_ms = start.elapsed_time(end) / timed

  B, T = envs, MAIN_STEPS
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
  kwargs = dict(num_simulations=MAIN_SIMS, discount=config.train.discount,
                support_size=getattr(net, "support_size", None),
                invalid_actions=None, max_depth=None)
  if gumbel:
    logits = root.prior_logits.contiguous()
    kwargs["root_score"], kwargs["schedule"] = fused.gumbel_root_inputs(
        logits, gumbel_noise(gen, logits.shape, device), None,
        max_num_considered_actions=config.search.max_num_considered_actions,
        num_simulations=MAIN_SIMS)
  else:
    logits = fused.noised_root_logits(gen, root.prior_logits)
  search_in = ((root.embedding.contiguous(), logits, root.value.contiguous(),
                fused.extract_search_weights(net, params)), kwargs)
  figures = {"rollout_ms": rollout_ms,
             "env_steps_per_s": B * T / (rollout_ms / 1e3),
             "episodes_finished": finished, "launches": launches}
  return launches, figures, search_in


def training_config(policy="muzero", family="mlp"):
  """bench.py's training_regime (bench.py:463-467, run_config), or with
  ``policy="gumbel"`` its gumbel_training (bench.py:306-309), or with
  ``family="categorical"`` its categorical_training (bench.py:351-354)."""
  from muax_tpu_torch.config import (MuZeroConfig, ReplayConfig,
                                     SearchConfig, TrainConfig)
  categorical = family == "categorical"
  return MuZeroConfig(
      search=SearchConfig(policy=policy, num_simulations=MAIN_SIMS),
      replay=ReplayConfig(capacity=TRAIN_CAPACITY, min_fill=64),
      train=TrainConfig(
          num_envs=CAT_TRAIN_ENVS if categorical else TRAIN_ENVS,
          collect_steps=MAIN_STEPS,
          batch_size=CAT_BATCH if categorical else TRAIN_BATCH,
          updates_per_iteration=CAT_UPDATES if categorical
          else TRAIN_UPDATES,
          unroll_steps=TRAIN_UNROLL, n_bootstrap=TRAIN_NSTEP,
          presample_updates=TRAIN_PRESAMPLE))


def training_setup(device, policy="muzero", family="mlp"):
  """The training regime built from the port's entry points, with random
  weights from SEED: networks, rollout, learner, ring, env carry."""
  import math
  from types import SimpleNamespace

  from muax_tpu_torch.envs import AutoResetWrapper, CartPole
  from muax_tpu_torch.models import muzero_optimizer
  from muax_tpu_torch.replay import replay_init
  from muax_tpu_torch.train import (TrainState, make_multi_update_fn,
                                    make_rollout_fn)

  config = training_config(policy, family)
  tcfg = config.train
  env = AutoResetWrapper(CartPole())
  net = make_net(device, family)
  params = net.init_params((4,), torch.Generator().manual_seed(SEED))
  optimizer = muzero_optimizer()
  gen = torch.Generator(device=device).manual_seed(SEED)
  return SimpleNamespace(
      config=config, env=env, net=net, gen=gen, family=family,
      envs=tcfg.num_envs, batch=tcfg.batch_size,
      updates=tcfg.updates_per_iteration,
      group=math.gcd(tcfg.updates_per_iteration, tcfg.presample_updates),
      rollout=make_rollout_fn(net, env, config, device=device),
      multi_update=make_multi_update_fn(net, optimizer, config),
      ts=TrainState(params, optimizer.init(params), 0),
      rs=replay_init(TRAIN_CAPACITY, MAIN_STEPS, (4,), 2, device=device),
      carry=env.reset(gen, tcfg.num_envs))


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
  """Two rollouts of the port fill the ring (2048 segments; 1024 of the
  categorical regime's 512 envs); returns the last segments and
  priorities."""
  from muax_tpu_torch.replay import replay_add

  for _ in range(2):
    t.carry, seg, prio, _ = t.rollout(t.ts.params, t.carry, t.gen,
                                      t.ts.params.temperature)
    replay_add(t.rs, seg, prio, step=t.ts.step)
  check(t.rs.size == min(TRAIN_CAPACITY, 2 * t.envs),
        "two rollouts fill the ring")
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


def categorical_learner_against_plain(device, t, raw, lay):
  """Phase 14: the categorical learner kernel against autograd over the
  categorical muzero_loss on the first 1024 of W sampled windows of a ring
  of the family's rollouts (bench widths), and on a seeded batch of 300
  windows with masks (A = 3, towers (48, 32), 21 bins); gradients rtol 5e-4
  / atol 1e-6, loss metrics rtol 1e-5, priorities rtol 1e-4
  (tests/test_fused_learner.py:156-162); two launches on the same inputs
  give bit-identical gradients."""
  from muax_tpu_torch.models import fused_learner
  from muax_tpu_torch.types import Transition

  kw = loss_kwargs(t.config)

  def one(net, params, raw_b, coef, lay):
    spec = fused_learner.extract_categorical_learner_spec(net, params)
    before = fused_learner.categorical_launches
    grads, metrics = fused_learner.fused_muzero_grad_raw(
        params, raw_b, coef, lay, net, spec, **kw)
    again, _ = fused_learner.fused_muzero_grad_raw(params, raw_b, coef, lay,
                                                   net, spec, **kw)
    torch.cuda.synchronize()
    check(fused_learner.categorical_launches == before + 2,
          "the categorical learner launched")
    check(torch.equal(grads, again), "a repeated launch gives bit-identical "
          "gradients")
    ref_grads, ref_metrics = fused_learner.fused_muzero_grad_raw_reference(
        params, raw_b, coef, lay, net, **kw)
    err, used = grads_close(grads, ref_grads, 5e-4, 1e-6)
    metrics_close(metrics, ref_metrics)
    return {"max_abs_err": err, "tolerance_used": used}

  B = t.batch
  raw_b = raw[:, :B]
  w_raw = raw_b[lay.weight]
  coef = (w_raw / torch.clamp(w_raw.mean(), min=1e-9) / raw_b[lay.denom]
          / B).contiguous()
  main = one(t.net, t.ts.params, raw_b, coef, lay)

  A, Be, K = 3, 300, TRAIN_UNROLL
  net = make_net(device, "categorical", A, **CAT_EDGE_NET)
  params = net.init_params((4,), torch.Generator().manual_seed(SEED + 1))
  gen = torch.Generator(device=device).manual_seed(SEED + 1)
  lengths = torch.randint(1, K + 1, (Be,), generator=gen, device=device)
  batch = Transition(
      obs=torch.randn((Be, K, 4), generator=gen, device=device),
      action=torch.randint(0, A, (Be, K), generator=gen, device=device),
      reward=torch.randn((Be, K), generator=gen, device=device) * 3,
      done=torch.zeros((Be, K), dtype=torch.bool, device=device),
      rn=torch.randn((Be, K), generator=gen, device=device) * 8,
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
  E, A = net.embedding_dim, net.num_actions
  if hasattr(net, "num_bins"):
    bins = net.num_bins
    repr_h = pred_h = dyn_h = net.layer_sizes
  else:
    bins = net.full_support
    repr_h, pred_h, dyn_h = net.repr_layers, net.pred_layers, net.dyn_layers

  def tower(in_dim, hidden, heads):
    macs = 0
    for h in hidden:
      macs += in_dim * h
      in_dim = h
    return macs + in_dim * sum(heads)

  fwd = (tower(lay.O, repr_h, (E,))
         + lay.K * (tower(E, pred_h, (bins, A))
                    + tower(E + A, dyn_h, (bins, E))))
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
  """Phase 6 (MuZero), 10 (Gumbel) or 15 (categorical): the training
  iteration, rollout -> replay_add -> make_multi_update_fn, 2 warm-up and 3
  timed iterations. Every iteration launches exactly 20 searches in the
  config's mode, updates / group samplers and one learner per update in the
  family's mode, and no search or learner in any other mode."""
  from muax_tpu_torch.models import fused_learner
  from muax_tpu_torch.replay import fused_sampler, replay_add

  mode = search_mode(t.config.search.policy, t.family)
  categorical = t.family == "categorical"
  learner_names = ("launches", "categorical_launches")

  def read():
    searches = search_counts()
    learners = [getattr(fused_learner, n) for n in learner_names]
    return (searches[mode], fused_sampler.launches, learners[categorical],
            sum(searches) - searches[mode] + learners[not categorical])

  # Launches (search, sampler, learner, any other mode) per iteration.
  expected = (MAIN_STEPS, t.updates // t.group, t.updates, 0)
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
          f"modes) {got} in one iteration, not {expected}")
    return metrics

  reset_counts()
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
    check(metrics["updates_done"] == t.updates,
          f"{metrics['updates_done']} updates, not {t.updates}")
    for k, v in metrics.items():
      check(math.isfinite(float(v)), f"metric {k} = {float(v)} is finite")
  figures = {
      "iteration_ms": iteration_ms,
      "env_steps_per_s": t.envs * MAIN_STEPS / (iteration_ms / 1e3),
      "learner_windows_per_s": t.updates * t.batch / (iteration_ms / 1e3),
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
  mlp = dict(pred_layers=(16,), dyn_layers=(16,))
  mlp_edge = dict(pred_layers=(16, 16), dyn_layers=(16, 16))
  main_cmp = search_against_plain(device, "muzero", "mlp", 2, MAIN_ENVS, mlp)
  print(f"phase 1 kernel vs plain, B={MAIN_ENVS} sims={MAIN_SIMS} A=2 "
        f"E={EMBED} S={SUPPORT} H=(16,): {json.dumps(main_cmp)} "
        f"({time.perf_counter() - t0:.1f} s)")

  t0 = time.perf_counter()
  edge_cmp = search_against_plain(device, "muzero", "mlp", 4, EDGE_ENVS,
                                  mlp_edge, with_invalid=True, max_depth=2)
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
  gumbel_main = search_against_plain(device, "gumbel", "mlp", 2, MAIN_ENVS,
                                     mlp)
  gumbel_edge = search_against_plain(device, "gumbel", "mlp", 4, EDGE_ENVS,
                                     mlp_edge, with_invalid=True,
                                     max_depth=2)
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

  # ---- the acme categorical family ---------------------------------------
  t0 = time.perf_counter()
  cat_cmp = {}
  for policy in ("muzero", "gumbel"):
    cat_cmp[policy] = {
        "main": search_against_plain(device, policy, "categorical", 2,
                                     CAT_ENVS, CAT_NET),
        "edge": search_against_plain(device, policy, "categorical", 3,
                                     EDGE_ENVS, CAT_EDGE_NET,
                                     with_invalid=True, max_depth=2)}
  print(f"phase 12 categorical search kernel vs plain, B={CAT_ENVS} "
        f"sims={MAIN_SIMS} A=2 E=64 H=(256, 256, 256) 51 bins +-150; "
        f"B={EDGE_ENVS} A=3 with one invalid action, max_depth=2, H=(48, "
        f"32), 21 bins: {json.dumps(cat_cmp)} "
        f"({time.perf_counter() - t0:.1f} s)")

  t0 = time.perf_counter()
  cat_roll = {}
  for policy in ("muzero", "gumbel"):
    _, cat_figures, (args, kwargs) = drive_main_path(device, policy,
                                                     "categorical")
    gumbel = policy == "gumbel"
    plain = (fused.fused_gumbel_search_reference if gumbel
             else fused.fused_muzero_search_reference)
    cat_figures["search_ms"] = time_ms(
        lambda: fused._fused_search_cuda(*args, **kwargs), 5)
    cat_figures["plain_search_ms"] = time_ms(lambda: plain(*args, **kwargs),
                                             1)
    cat_figures["bound_ms"], cat_figures["bound_by"] = search_bound_ms(
        CAT_ENVS, MAIN_SIMS, args[3], False, gumbel=gumbel)
    cat_figures["macs_per_expansion"] = search_macs(args[3])
    cat_roll[policy] = cat_figures
  print(f"phase 13 categorical rollout, {CAT_ENVS} envs x {MAIN_SIMS} sims x "
        f"{MAIN_STEPS} steps, each policy: {json.dumps(cat_roll)} "
        f"({time.perf_counter() - t0:.1f} s)")

  t0 = time.perf_counter()
  tc = training_setup(device, "muzero", "categorical")
  fill_ring(tc)
  W = TRAIN_PRESAMPLE * CAT_BATCH
  seg_idx = fused_sampler.draw_segments(tc.rs, tc.gen, W)
  gumbel = gumbel_noise(tc.gen, (MAIN_STEPS, W), device)
  raw, lay = fused_sampler.fused_sample_group(tc.rs, seg_idx, gumbel,
                                              TRAIN_UNROLL)
  cat_learn_main, cat_learn_edge = categorical_learner_against_plain(
      device, tc, raw, lay)
  raw_b = raw[:, :CAT_BATCH]
  w_raw = raw_b[lay.weight]
  coef = (w_raw / torch.clamp(w_raw.mean(), min=1e-9) / raw_b[lay.denom]
          / CAT_BATCH).contiguous()
  spec = fused_learner.extract_categorical_learner_spec(tc.net, tc.ts.params)
  kw = loss_kwargs(tc.config)
  cat_learner = {
      "main": cat_learn_main, "edge": cat_learn_edge,
      "kernel_ms": time_ms(lambda: fused_learner._grad_cuda(
          spec, raw_b, coef, lay, l2_coef=kw["l2_coef"],
          gradient_scale=kw["gradient_scale"]), 10),
      "plain_ms": time_ms(
          lambda: fused_learner.fused_muzero_grad_raw_reference(
              tc.ts.params, raw_b, coef, lay, tc.net, **kw), 3),
      "n_weights": spec.flat.numel()}
  cat_learner["bound_ms"], cat_learner["bound_by"] = learner_bound_ms(
      tc.net, lay, CAT_BATCH, spec.flat.numel())
  print(f"phase 14 categorical learner vs plain, B={CAT_BATCH} on sampled "
        f"windows (bench widths), B=300 A=3 H=(48, 32) with masks; repeated "
        f"launches bit-identical: {json.dumps(cat_learner)} "
        f"({time.perf_counter() - t0:.1f} s)")

  t0 = time.perf_counter()
  cat_train_launches, cat_train = drive_training(device, tc)
  print(f"phase 15 categorical training iteration, {CAT_TRAIN_ENVS} envs x "
        f"{MAIN_SIMS} sims x {MAIN_STEPS} steps, {CAT_UPDATES} updates of "
        f"{CAT_BATCH} in groups of {tc.group}: {json.dumps(cat_train)} "
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
  }, {
      "name": "fused_categorical_search", "route": "cuda",
      "source": "muax_tpu_torch/csrc/fused_search.cu",
      "replaces": 'muax_tpu/search/fused.py:759 (decode="linear", ln_tanh)',
      "launches": cat_train_launches[0],
      "max_abs_err": cat_cmp["muzero"]["main"]["max_abs_err"],
      "ms": cat_roll["muzero"]["search_ms"],
      "plain_ms": cat_roll["muzero"]["plain_search_ms"],
      "bound_ms": cat_roll["muzero"]["bound_ms"],
      "bound_by": cat_roll["muzero"]["bound_by"], "library_ms": None,
  }, {
      "name": "fused_categorical_gumbel_search", "route": "cuda",
      "source": "muax_tpu_torch/csrc/fused_search.cu",
      "replaces": 'muax_tpu/search/fused.py:759 (decode="linear", ln_tanh, '
                  'policy="gumbel")',
      "launches": cat_roll["gumbel"]["launches"],
      "max_abs_err": cat_cmp["gumbel"]["main"]["max_abs_err"],
      "ms": cat_roll["gumbel"]["search_ms"],
      "plain_ms": cat_roll["gumbel"]["plain_search_ms"],
      "bound_ms": cat_roll["gumbel"]["bound_ms"],
      "bound_by": cat_roll["gumbel"]["bound_by"], "library_ms": None,
  }, {
      "name": "fused_categorical_grad_raw", "route": "cuda",
      "source": "muax_tpu_torch/csrc/fused_learner.cu",
      "replaces": "muax_tpu/models/fused_learner.py:665 (categorical "
                  "LearnerSpec)",
      "launches": cat_train_launches[2],
      "max_abs_err": cat_learner["main"]["max_abs_err"],
      "ms": cat_learner["kernel_ms"], "plain_ms": cat_learner["plain_ms"],
      "bound_ms": cat_learner["bound_ms"],
      "bound_by": cat_learner["bound_by"], "library_ms": None,
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
