"""The conv and pixel path's phases of ``chip_smoke.py`` (25-29) alone.

Builds every kernel, then runs the sampler kernel on a uint8 ring (25),
the conv triplets on the card against the CPU (26), the
``muzero_ez_conv_pixel`` rollout (27), ``ez_conv_training`` and
``ez_conv_training_b1024`` (28) and ``fit`` through the hybrid route (29),
printing one JSON line each. ``--full`` runs phase 28's iterations whole
(640 and 160 updates, about a minute of host work on an H100 machine),
where ``chip_smoke.py`` times one group of updates. Needs a CUDA card; run
from the repository's root:

  python3 tools/ez_phases.py [--full] [--only 27,28] [--out FILE]
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
  parser.add_argument("--full", action="store_true",
                      help="phase 28's iterations with all their updates")
  parser.add_argument("--only", default="25,26,27,28,29",
                      help="comma-separated phases")
  parser.add_argument("--out", default=None, help="also write the JSON here")
  opts = parser.parse_args()
  if not torch.cuda.is_available():
    sys.exit("ez_phases: needs a CUDA card")
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device("cuda", 0)
  phases = {"25": lambda: cs.uint8_sampler_phase(dev),
            "26": lambda: cs.conv_against_cpu(dev),
            "27": lambda: cs.ez_rollout_phase(dev),
            "28": lambda: cs.ez_training_phase(dev, full=opts.full),
            "29": lambda: cs.ez_fit_phase(dev, os.getcwd())}
  card = cs.card_line()
  print(card)
  _build.build_all()
  out = {"card": card}
  for name in opts.only.split(","):
    t0 = time.perf_counter()
    out[name] = phases[name]()
    print(f"phase {name}: {json.dumps(out[name])} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
  if opts.out:
    with open(opts.out, "w") as f:
      json.dump(out, f)


if __name__ == "__main__":
  main()
