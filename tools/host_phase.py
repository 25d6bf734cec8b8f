"""Phase 30 of ``chip_smoke.py`` alone: the 2048 host path at
``examples/run_2048.py``'s width.

Builds every kernel (printing the ``ptxas`` figures of the wide search's
and learner's instances), then holds the search kernel's wide mode
(``fused_search_wide_kernel``, MuZero and Gumbel, 64 and 1024 boards x 50
simulations under legal masks) and the learner's (``mlp_cluster_kernel``
with the weight-gradient pass, batch 256, K = 5) against their plain
versions,
and runs ``fit`` on the native 2048 pool at the example's config, printing
one JSON line. Needs a CUDA card; run from the repository's root:

  python3 tools/host_phase.py [--out FILE]
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
    sys.exit("host_phase: needs a CUDA card")
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device("cuda", 0)
  card = cs.card_line()
  print(card)
  ptxas = cs.ptxas_figures(_build.build_all())
  for label, fig in ptxas.items():
    if ("fused_search_wide_kernel" in label or "mlp_cluster_kernel" in label
        or "categorical_dw_kernel" in label):
      print(f"  ptxas {label}: {json.dumps(fig)}")
  t0 = time.perf_counter()
  out = {"card": card, "30": cs.host_2048_phase(dev, os.getcwd(), ptxas)}
  print(f"phase 30: {json.dumps(out['30'])} "
        f"({time.perf_counter() - t0:.1f} s)", flush=True)
  if opts.out:
    with open(opts.out, "w") as f:
      json.dump(out, f)


if __name__ == "__main__":
  main()
