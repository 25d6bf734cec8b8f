"""Smoke run of the PyTorch port (``muax_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments:

  python3 chip_smoke.py

Phase 0 builds every CUDA kernel of the port from the sources in the
checkout. Phases 1 and 2 hold each kernel against its plain PyTorch version
on the card, at the main path's shapes and at edge shapes. Phase 3 drives the
main path, MuZero self-play on CartPole (``make_rollout_fn`` at 8192 envs x
64 simulations x 20 steps, the rollout of ``bench.py``'s default run), counts
the kernel launches it makes and checks what it returns; then it times each
kernel and its plain version on the inputs of that run.

Every failed check raises, so the script exits non-zero and prints no result.
Without a CUDA card, or without the package beside it, it fails the same way.
The line before the last lists every kernel with its launches, error, times
and bound; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": <card>, "count": <cards>}}.
"""
import json
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


def search_bound_ms(batch, sims, weights, with_invalid):
  """Least time for one search launch: the larger of its operations over
  the f32 peak and its bytes over the memory rate. Operations are the two
  towers' multiply-adds, once per expansion (batch x sims expansions); bytes
  are each input read once and each output written once."""
  macs = sum(w.shape[0] * w.shape[1] for w, _ in weights.layers())
  flops = 2.0 * macs * batch * sims
  num_actions = weights.pred_policy[0].shape[1]
  embed = weights.dyn_state[0].shape[1]
  floats = batch * (embed + num_actions + 1)       # roots
  floats += batch * num_actions * with_invalid     # invalid mask
  floats += weights.flat().numel()
  floats += batch * (2 * num_actions + 1)          # visits, value, q
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


def drive_main_path(device):
  """Phase 3: make_rollout_fn at the main path's size. Returns the launch
  count of the run, its figures and the search inputs of its last state."""
  from muax_tpu_torch.config import MuZeroConfig, SearchConfig, TrainConfig
  from muax_tpu_torch.envs import AutoResetWrapper, CartPole
  from muax_tpu_torch.models import make_mlp_networks
  from muax_tpu_torch.search import fused
  from muax_tpu_torch.train import make_rollout_fn
  from muax_tpu_torch.train.inference import make_root_fn

  env = AutoResetWrapper(CartPole())
  net = make_mlp_networks(num_actions=2, embedding_dim=EMBED,
                          support_size=SUPPORT, device=device)
  params = net.init_params(env.spec.observation_shape,
                           torch.Generator().manual_seed(SEED))
  config = MuZeroConfig(
      search=SearchConfig(num_simulations=MAIN_SIMS),
      train=TrainConfig(num_envs=MAIN_ENVS, collect_steps=MAIN_STEPS))
  rollout = make_rollout_fn(net, env, config, device=device)
  gen = torch.Generator(device=device).manual_seed(SEED)
  carry = env.reset(gen, MAIN_ENVS)

  def one(carry):
    before = fused.launches
    carry, seg, prio, metrics = rollout(params, carry, gen,
                                        params.temperature)
    check(fused.launches - before == MAIN_STEPS,
          f"{fused.launches - before} kernel launches in a rollout of "
          f"{MAIN_STEPS} steps")
    return carry, seg, prio, metrics

  fused.launches = 0
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
  launches = fused.launches
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
    logits = fused.noised_root_logits(gen, root.prior_logits)
  search_in = ((root.embedding.contiguous(), logits, root.value.contiguous(),
                fused.extract_fused_weights(net, params)),
               dict(num_simulations=MAIN_SIMS, support_size=SUPPORT,
                    discount=config.train.discount))
  figures = {"rollout_ms": rollout_ms,
             "env_steps_per_s": B * T / (rollout_ms / 1e3),
             "episodes_finished": finished, "launches": launches}
  return launches, figures, search_in


def run(device):
  from muax_tpu_torch import _build
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

  kernels = [{
      "name": "fused_muzero_search", "route": "cuda",
      "source": "muax_tpu_torch/csrc/fused_search.cu",
      "replaces": "muax_tpu/search/fused.py:759",
      "launches": launches, "max_abs_err": main_cmp["max_abs_err"],
      "ms": figures["search_ms"], "plain_ms": figures["plain_search_ms"],
      "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
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
