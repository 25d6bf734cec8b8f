"""Phase 32 of ``chip_smoke.py`` alone: the parallel layer over
``torch.distributed`` on the card (the sharded program on a world of one
through NCCL; two ranks sharing the card through gloo; the reduced
gradient's meaning; reanalyze across the ranks; the channel-sharded Go
tower), after phase 6's training iteration for the comparison.

Builds every kernel, prints the card and one JSON line. Needs a CUDA card;
run from the repository's root:

  python3 tools/parallel_phase.py [--out FILE]
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
  parser.add_argument("--out", default=None, help="also write the JSON here")
  opts = parser.parse_args()
  if not torch.cuda.is_available():
    sys.exit("parallel_phase: needs a CUDA card")
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device("cuda", 0)
  card = cs.card_line()
  print(card)
  _build.build_all()
  t0 = time.perf_counter()
  _, train = cs.drive_training(dev, cs.training_setup(dev))
  out = {"card": card, "6": {k: train[k] for k in (
      "iteration_ms", "env_steps_per_s", "launches", "loss")}}
  print(f"phase 6: {json.dumps(out['6'])} ({time.perf_counter() - t0:.1f} s)",
        flush=True)
  t0 = time.perf_counter()
  out["32"] = cs.parallel_phase(train["iteration_ms"])
  out["seconds"] = time.perf_counter() - t0
  print(f"phase 32: {json.dumps(out['32'])} ({out['seconds']:.1f} s)",
        flush=True)
  if opts.out:
    with open(opts.out, "w") as f:
      json.dump(out, f)


if __name__ == "__main__":
  main()
