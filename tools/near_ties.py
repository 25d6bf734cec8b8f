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
MLP regime afresh (its learner's atomics make each ring differ a little),
draws 64 segments of 20 steps from the ring at 64 and at 16 simulations,
gives the same counts for each launch, and whether phase 1's check
(``compare_search``) holds on it, alone and with phase 21's near-tie proof
(``tie_proof``); for each env outside the tolerance, which part of the
proof holds:

  python3 tools/near_ties.py --ring 4
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
              f"the plain version in f32 and f64 disagree "
              f"{cs.f64_disagrees(args, kwargs, idx).tolist()}", flush=True)
      for label, proof in (("alone", None), ("with the near-tie proof",
                                             cs.tie_proof(args, kwargs))):
        try:
          figures = cs.compare_search(out, ref, sims, tie_proof=proof)
          print(f"  compare_search {label} holds: {figures}", flush=True)
        except RuntimeError as e:
          failed[label] = failed.get(label, 0) + 1
          print(f"  compare_search {label} fails: {e}", flush=True)
  print(f"compare_search failed, of {2 * repeats} launches: {failed}")


def main():
  import chip_smoke as cs

  if not torch.cuda.is_available():
    sys.exit("near_ties: needs a CUDA card")
  dev = torch.device("cuda", 0)
  torch.backends.cuda.matmul.allow_tf32 = False
  print(cs.card_line(), flush=True)
  if len(sys.argv) == 3 and sys.argv[1] == "--ring":
    ring(cs, dev, int(sys.argv[2]))
  else:
    board(cs, dev)


if __name__ == "__main__":
  main()
