"""Phases 33 and 34 of ``chip_smoke.py`` alone: the Stochastic MuZero
search's wide-tower kernel (tiles of environments sharing every tower read)
at ``examples/run_2048.py``'s widths (33), and the port's example scripts
on the card (34).

Builds every kernel (printing the ``ptxas`` figures of the SMZ search's
instances, staged and wide), then runs the phases, printing one JSON line
each. Needs a CUDA card; run from the repository's root:

  python3 tools/examples_phase.py [--only 33|34] [--out FILE]
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
  from muax_tpu_torch import _build

  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--only", choices=("33", "34"), default=None)
  parser.add_argument("--out", default=None, help="also write the JSON here")
  opts = parser.parse_args()
  if not torch.cuda.is_available():
    sys.exit("examples_phase: needs a CUDA card")
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device("cuda", 0)
  card = cs.card_line()
  print(card)
  ptxas = cs.ptxas_figures(_build.build_all())
  for label, fig in ptxas.items():
    if label.startswith("fused_smz:"):
      print(f"  ptxas {label}: {json.dumps(fig)}")
  out = {"card": card, "ptxas": ptxas}
  if opts.only in (None, "33"):
    t0 = time.perf_counter()
    out["33"], _ = cs.wide_smz_phase(dev)
    print(f"phase 33: {json.dumps(out['33'])} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
  if opts.only in (None, "34"):
    t0 = time.perf_counter()
    out["34"] = cs.examples_phase(os.getcwd())
    print(f"phase 34: {json.dumps(out['34'])} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if isinstance(out["34"]["run_lunarlander"], str):
      print(f"phase 34 run_lunarlander: {out['34']['run_lunarlander']}")
  if opts.out:
    with open(opts.out, "w") as f:
      json.dump(out, f)


if __name__ == "__main__":
  main()
