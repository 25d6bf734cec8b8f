"""Phase 31 of ``chip_smoke.py`` alone: the host-facing surface (Sampled
MuZero, the MuZero, Stochastic MuZero and Diffusion MuZero agents, the
tracers, the monitor and the stopwatch) on the card, with no kernel
launch. Builds nothing: no kernel serves this path. Prints the card and
one JSON line. Needs a CUDA card; run from the repository's root:

  python3 tools/agents_phase.py [--out FILE]
"""
import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.getcwd())


def main():
  import chip_smoke as cs

  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--out", default=None, help="also write the JSON here")
  opts = parser.parse_args()
  if not torch.cuda.is_available():
    sys.exit("agents_phase: needs a CUDA card")
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device("cuda", 0)
  card = cs.card_line()
  print(card)
  t0 = time.perf_counter()
  out = {"card": card, "31": cs.surface_phase(dev)}
  out["seconds"] = time.perf_counter() - t0
  print(f"phase 31: {json.dumps(out['31'])} ({out['seconds']:.1f} s)",
        flush=True)
  if opts.out:
    with open(opts.out, "w") as f:
      json.dump(out, f)


if __name__ == "__main__":
  main()
