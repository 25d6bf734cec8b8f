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
"""
import os
import sys

import torch

sys.path.insert(0, os.getcwd())


def main():
  import chip_smoke as cs
  from muax_tpu_torch.config import MuZeroConfig, SearchConfig, TrainConfig
  from muax_tpu_torch.envs import AutoResetWrapper, TicTacToe
  from muax_tpu_torch.train import make_rollout_fn

  if not torch.cuda.is_available():
    sys.exit("near_ties: needs a CUDA card")
  dev = torch.device("cuda", 0)
  env = AutoResetWrapper(TicTacToe())
  net = cs.make_net(dev, "mlp", 9)
  params = net.init_params((3, 3, 2), torch.Generator().manual_seed(0))
  config = MuZeroConfig(search=SearchConfig(num_simulations=64),
                        train=TrainConfig(num_envs=1003, collect_steps=21))
  rollout = make_rollout_fn(net, env, config, device=dev)
  gen = torch.Generator(device=dev).manual_seed(0)
  with cs.SearchRecorder(keep=21) as rec:
    rollout(params, env.reset(gen, 1003), gen, params.temperature)
  ulp = 2.0 ** -23
  total = 0
  for step, (args, kwargs, out) in enumerate(rec.calls):
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
    total += int(bad.sum())
    print(f"step {step}: {int(bad.sum())} envs outside; the plain version "
          f"moved by an ulp of the embedding (+, -) and of the logits "
          f"(envs, of them outside): {nudged}; the kernel moved by an ulp "
          f"of the embedding: {kernel_moved}", flush=True)
    for i in torch.nonzero(bad)[:3, 0].tolist():
      print(f"  env {i}: visits {out[0][i].tolist()} / "
            f"{ref[0][i].tolist()}, q kernel "
            f"{[round(x, 4) for x in out[2][i].tolist()]}, q plain "
            f"{[round(x, 4) for x in ref[2][i].tolist()]}", flush=True)
  print(f"total {total} envs outside the tolerance over 21 steps")


if __name__ == "__main__":
  main()
