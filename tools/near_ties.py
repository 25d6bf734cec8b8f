"""Broken near-ties in the MLP search kernel's masked searches.

Runs ``make_rollout_fn`` on TicTacToe (A = 9, legal-action masks) at 1003
envs x 64 simulations x 21 steps with the MLP triplet at bench widths,
records every launch of the search kernel, and for each step prints how
many envs leave rtol = atol = 1e-3 of the plain version's root value, how
many envs the plain version itself moves that far when the root embedding
(up and down) or the root logits move by one ulp, and how many the kernel
moves for an ulp of the embedding; then, for up to three envs that leave
the tolerance, the root q of each side. Needs a CUDA card; run from the
repository's root:

  python3 tools/near_ties.py

With ``--ring N`` it reads instead the reanalyze launches of
``chip_smoke.py``'s phase 21, N times over: each time it trains phase 6's
MLP regime afresh (without phases 4 and 5, so not ``chip_smoke.py``'s own
ring; training repeats its bits, so every ring of a call is the same),
draws 64 segments of 20 steps from the ring at 64 and at 16 simulations,
gives the same counts for each launch, and whether phase 1's check
(``compare_search``) holds on it, alone and with phase 21's near-tie proof
(``tie_proof``); for each env outside the tolerance, which part of the
proof holds:

  python3 tools/near_ties.py --ring 4

With ``--smoke`` it rebuilds the ring of ``chip_smoke.py``'s own run (its
phases 4, 5 and 6 on the training state they share, then the draws that
follow phase 6; training repeats its bits, so this is that run's ring)
and runs phase 21 on it, printing for each env that leaves the tolerance
the visits, root values and q of the kernel, the plain version in f32
and in f64, and which nudges move it (8 and 64 trials, the embedding
alone and with the weights):

  python3 tools/near_ties.py --smoke
"""
import os
import sys

import torch

sys.path.insert(0, os.getcwd())


def report(cs, label, args, kwargs, out):
  """Prints one launch's counts; returns the envs outside the tolerance."""
  ulp = 2.0 ** -23
  ref = cs.fused_reference(args, kwargs)
  tol = 1e-3 + 1e-3 * ref[1].abs()
  bad = (out[1] - ref[1]).abs() > tol
  nudged = []
  for which, scale in ((0, 1 + ulp), (0, 1 - ulp), (1, 1 + ulp)):
    moved_args = list(args)
    moved_args[which] = moved_args[which] * scale
    r2 = cs.fused_reference(tuple(moved_args), kwargs)
    moved = (r2[1] - ref[1]).abs() > tol
    nudged.append((int(moved.sum()), int((moved & bad).sum())))
  k2 = cs.fused_cuda((args[0] * (1 + ulp),) + tuple(args[1:]), kwargs)
  kernel_moved = int(((k2[1] - out[1]).abs() > tol).sum())
  dv = (out[0] - ref[0]).abs().amax(-1)
  print(f"{label}: {int(bad.sum())} envs outside (visits moved on "
        f"{int((dv > 0).sum())}, by more than 2 on {int((dv > 2).sum())}); "
        f"the plain version moved by an ulp of the embedding (+, -) and of "
        f"the logits (envs, of them outside): {nudged}; the kernel moved by "
        f"an ulp of the embedding: {kernel_moved}", flush=True)
  for i in torch.nonzero(bad)[:3, 0].tolist():
    print(f"  env {i}: visits {out[0][i].tolist()} / "
          f"{ref[0][i].tolist()}, q kernel "
          f"{[round(x, 4) for x in out[2][i].tolist()]}, q plain "
          f"{[round(x, 4) for x in ref[2][i].tolist()]}", flush=True)
  return int(bad.sum())


def board(cs, dev):
  """TicTacToe's masked rollout."""
  from muax_tpu_torch.config import MuZeroConfig, SearchConfig, TrainConfig
  from muax_tpu_torch.envs import AutoResetWrapper, TicTacToe
  from muax_tpu_torch.train import make_rollout_fn

  env = AutoResetWrapper(TicTacToe())
  net = cs.make_net(dev, "mlp", 9)
  params = net.init_params((3, 3, 2), torch.Generator().manual_seed(0))
  config = MuZeroConfig(search=SearchConfig(num_simulations=64),
                        train=TrainConfig(num_envs=1003, collect_steps=21))
  rollout = make_rollout_fn(net, env, config, device=dev)
  gen = torch.Generator(device=dev).manual_seed(0)
  with cs.SearchRecorder(keep=21) as rec:
    rollout(params, env.reset(gen, 1003), gen, params.temperature)
  total = sum(report(cs, f"step {step}", *call)
              for step, call in enumerate(rec.calls))
  print(f"total {total} envs outside the tolerance over 21 steps")


def ring(cs, dev, repeats):
  """Phase 21's reanalyze launches on ``repeats`` freshly trained rings."""
  import dataclasses

  from muax_tpu_torch.train.reanalyze import make_reanalyze_fn

  K = cs.REANALYZE_SEGMENTS
  failed = {}
  for r in range(repeats):
    t = cs.training_setup(dev)
    cs.drive_training(dev, t)
    for sims in (cs.MAIN_SIMS, cs.REANALYZE_SIMS):
      config = dataclasses.replace(t.config, search=dataclasses.replace(
          t.config.search, reanalyze_simulations=sims))
      reanalyze = make_reanalyze_fn(t.net, config, K, device=dev)
      uniforms = torch.rand((K,), generator=t.gen, device=dev)
      with cs.SearchRecorder(keep=1) as rec:
        reanalyze(t.ts.params, t.rs, t.gen, t.ts.step + 7,
                  uniforms=uniforms)
      args, kwargs, out = rec.calls[0]
      report(cs, f"ring {r} sims={sims}", args, kwargs, out)
      ref = cs.fused_reference(args, kwargs)
      dv = (out[0] - ref[0]).abs().amax(-1)
      off = (dv <= 2) & (cs.outside(out[1], ref[1]) | (
          (dv == 0) & cs.outside(out[2], ref[2]).any(-1)))
      idx = torch.nonzero(off)[:, 0]
      if len(idx):
        sub_args, sub_kwargs = cs.sub_launch(args, kwargs, idx)
        _, v64, _ = cs.fused_reference(
            cs.tensor_map(torch.Tensor.double, sub_args), sub_kwargs)
        emb_only = cs.ulp_sensitive(args, kwargs, idx, weights=False)
        print(f"  outside: envs {idx.tolist()}, value kernel "
              f"{out[1][idx].tolist()}, plain {ref[1][idx].tolist()}, "
              f"plain in f64 {v64.tolist()}; an ulp of the embedding "
              f"moves them {emb_only.tolist()}, of the embedding and the "
              f"weights {cs.ulp_sensitive(args, kwargs, idx).tolist()}; "
              f"f32 rounding alone decides them "
              f"{cs.f64_disagrees(args, kwargs, idx, out).tolist()}",
              flush=True)
      for label, proof in (("alone", None),
                           ("with the near-tie proof",
                            cs.tie_proof(args, kwargs, out))):
        try:
          figures = cs.compare_search(out, ref, sims, tie_proof=proof)
          print(f"  compare_search {label} holds: {figures}", flush=True)
        except RuntimeError as e:
          failed[label] = failed.get(label, 0) + 1
          print(f"  compare_search {label} fails: {e}", flush=True)
  print(f"compare_search failed, of {2 * repeats} launches: {failed}")


def descent_gaps(cs, args, kwargs, n, dtype):
  """The plain version's tree of one env after ``n`` simulations in
  ``dtype``, then the next simulation's descent: at each depth the action
  taken and the gap between the two best PUCT scores over the best, by the
  plain version's own formula."""
  import math

  from muax_tpu_torch.search import fused

  if dtype == torch.float64:
    args = cs.tensor_map(torch.Tensor.double, args)
  spec = fused._as_spec(args[3], kwargs.get("support_size"))
  sims = kwargs["num_simulations"]
  f = fused._plain_forest(args[0], args[1], args[2], spec,
                          num_simulations=n, discount=kwargs["discount"],
                          invalid_actions=kwargs.get("invalid_actions"),
                          max_depth=kwargs.get("max_depth") or sims)
  disc = kwargs["discount"]
  c_init, c_base = kwargs.get("pb_c_init", 1.25), kwargs.get("pb_c_base",
                                                              19652.0)
  cur, depth, gaps = 0, 0, []
  while True:
    cv, nvalue = f.cvis[0, cur], f.nval[0, cur]
    q = f.crew[0, cur] + disc * f.cval[0, cur]
    visited = cv > 0
    safe = torch.where(visited, q, nvalue)
    lo, hi = torch.minimum(nvalue, safe.min()), torch.maximum(nvalue,
                                                              safe.max())
    qn = (torch.where(visited, q, lo) - lo) / torch.clamp(hi - lo, min=1e-8)
    nv = f.nvis[0, cur]
    pb_c = c_init + math.log((float(nv) + c_base + 1.0) / c_base)
    score = qn + (math.sqrt(float(nv)) * pb_c) * f.cpri[0, cur] / (cv + 1.0)
    top = torch.topk(score, 2).values
    a = int(torch.argmax(score))
    gaps.append((depth, a, float((top[0] - top[1]) / top[0].abs())))
    child = int(f.cidx[0, cur, a])
    depth += 1
    if child < 0:
      return gaps
    cur = child


def scan_env(cs, args, kwargs, idx):
  """One env's search at every budget from 1 simulation, kernel against
  the plain version (the first budget where they part, and the rows around
  it), and at the full budget with each lane-group size forced; its inputs
  saved to ``build/near_tie_env.pt``."""
  from muax_tpu_torch.search import fused

  sub_args, sub_kwargs = cs.sub_launch(args, kwargs, idx)
  rows = []
  for n in range(1, kwargs["num_simulations"] + 1):
    kw = dict(sub_kwargs, num_simulations=n)
    k, p = cs.fused_cuda(sub_args, kw), cs.fused_reference(sub_args, kw)
    rows.append((n, k[0][0].tolist(), p[0][0].tolist(), k[1].item(),
                 p[1].item(), k[2][0].tolist(), p[2][0].tolist()))
  parted = [r for r in rows if abs(r[3] - r[4]) > 1e-5 * abs(r[4]) + 1e-6
            or r[1] != r[2]]
  first = parted[0][0] if parted else None
  print(f"  env {idx.item()}: kernel and plain part first at {first} "
        f"simulations", flush=True)
  for r in rows:
    if first is not None and first - 3 <= r[0] <= first + 3 or r[0] in (
        1, 16, 32, 48, 64):
      print(f"    n={r[0]}: visits {r[1]} / {r[2]}, value {r[3]:.6f} / "
            f"{r[4]:.6f}, q {r[5]} / {r[6]}", flush=True)
  if first is not None:
    for dt in (torch.float32, torch.float64):
      gaps = descent_gaps(cs, sub_args, sub_kwargs, first - 1, dt)
      print(f"    {dt} plain tree after {first - 1} simulations, then the "
            f"next descent (depth, action, gap of the two best scores over "
            f"the best): {gaps}", flush=True)
  chosen = fused.mlp_search_plan
  for group in (4, 32):
    fused.mlp_search_plan = lambda *a, **kw: chosen(*a, group=group, **kw)
    try:
      k = cs.fused_cuda(sub_args, sub_kwargs)
    finally:
      fused.mlp_search_plan = chosen
    print(f"    G={group}: value {k[1].item():.6f}, q {k[2][0].tolist()}",
          flush=True)
  os.makedirs("build", exist_ok=True)
  torch.save({"args": cs.tensor_map(lambda t: t.cpu(), sub_args),
              "kwargs": {k: v.cpu() if torch.is_tensor(v) else v
                         for k, v in sub_kwargs.items()}},
             os.path.join("build", "near_tie_env.pt"))


def smoke(cs, dev):
  """Phase 21 on the ring of ``chip_smoke.py``'s run, with each proof
  explained."""
  from muax_tpu_torch.replay import fused_sampler
  from muax_tpu_torch.replay.buffer import gumbel_noise

  t = cs.training_setup(dev)
  _, _, (_, _, raw, lay) = cs.sampler_against_plain(dev, t)
  cs.learner_against_plain(dev, t, raw, lay)
  cs.drive_training(dev, t)
  W = cs.TRAIN_GROUP * cs.TRAIN_BATCH
  fused_sampler.draw_segments(t.rs, t.gen, W)
  gumbel_noise(t.gen, (cs.MAIN_STEPS, W), dev)
  proof = cs.tie_proof

  def explained(args, kwargs, out):
    base = proof(args, kwargs, out)

    def run(idx):
      proven = base(idx)
      sub_out = cs.fused_cuda(*cs.sub_launch(args, kwargs, idx))
      sub_args, sub_kwargs = cs.sub_launch(args, kwargs, idx)
      ref = cs.fused_reference(sub_args, sub_kwargs)
      r64 = cs.fused_reference(cs.tensor_map(torch.Tensor.double, sub_args),
                               sub_kwargs)
      moved = {f"{label}, {n} trials": cs.ulp_sensitive(
          args, kwargs, idx, trials=n, weights=w).tolist()
          for n in (8, 64) for label, w in (("embedding", False),
                                            ("embedding and weights", True))}
      by_f64 = cs.f64_disagrees(args, kwargs, idx, out)
      print(f"sims={kwargs['num_simulations']}: envs {idx.tolist()} proven "
            f"{proven.tolist()}; nudges that move them: {moved}; f32 "
            f"rounding alone decides them: {by_f64.tolist()}", flush=True)
      for j, i in enumerate(idx.tolist()):
        print(f"  env {i}: visits kernel {sub_out[0][j].tolist()}, plain "
              f"{ref[0][j].tolist()}, f64 {r64[0][j].tolist()}; value "
              f"{sub_out[1][j].item():.6f} / {ref[1][j].item():.6f} / "
              f"{r64[1][j].item():.6f}; q {sub_out[2][j].tolist()} / "
              f"{ref[2][j].tolist()} / {r64[2][j].tolist()}", flush=True)
      for j in torch.nonzero(~proven)[:, 0].tolist():
        scan_env(cs, args, kwargs, idx[j:j + 1])
      return proven
    return run

  cs.tie_proof = explained
  try:
    print(f"phase 21 holds: {cs.reanalyze_phase(dev, t)}", flush=True)
  except RuntimeError as e:
    print(f"phase 21 fails: {e}", flush=True)


def main():
  import chip_smoke as cs

  if not torch.cuda.is_available():
    sys.exit("near_ties: needs a CUDA card")
  dev = torch.device("cuda", 0)
  torch.backends.cuda.matmul.allow_tf32 = False
  print(cs.card_line(), flush=True)
  if len(sys.argv) == 3 and sys.argv[1] == "--ring":
    ring(cs, dev, int(sys.argv[2]))
  elif sys.argv[1:] == ["--smoke"]:
    torch.backends.cudnn.allow_tf32 = False
    smoke(cs, dev)
  else:
    board(cs, dev)


if __name__ == "__main__":
  main()
