"""Run the JAX package's CartPole parity (``scripts/parity_cartpole.py``,
unchanged) for several seeds, with its checkpoints in ``--model_dir``
instead of the script's fixed ``/tmp/parity_cartpole``, one JSON per seed.

  python tools/parity_cartpole_jax.py --seeds 1,3 --num_iterations 150 \\
      --model_dir build/parity_jax --out_prefix build/parity_jax_seed

It is the JAX side of the seeds-by-routes comparison of ``PERF.md``; the
port's side is ``python -m muax_tpu_torch.examples.parity_cartpole``.
"""
import argparse
import importlib
import os
import runpy
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument("--seeds", default="42")
  p.add_argument("--num_iterations", type=int, default=800)
  p.add_argument("--model_dir", default=os.path.join("build", "parity_jax"))
  p.add_argument("--out_prefix",
                 default=os.path.join("build", "parity_jax_seed"))
  args = p.parse_args()
  sys.path.insert(0, ROOT)
  # The module, not the package's re-exported function of the same name.
  fit_module = importlib.import_module("muax_tpu.train.fit")
  fit = fit_module.fit

  def fit_in_model_dir(*a, **kw):
    kw["model_dir"] = args.model_dir
    return fit(*a, **kw)

  fit_module.fit = fit_in_model_dir
  for seed in args.seeds.split(","):
    sys.argv = ["parity_cartpole.py", "--cpu", "--seed", seed,
                "--num_iterations", str(args.num_iterations),
                "--out", f"{args.out_prefix}{seed}.json"]
    runpy.run_path(os.path.join(ROOT, "scripts", "parity_cartpole.py"),
                   run_name="__main__")


if __name__ == "__main__":
  main()
