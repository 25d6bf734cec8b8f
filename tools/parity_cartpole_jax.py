"""Run the JAX package's CartPole parity for several seeds on the CPU, with
its checkpoints in ``--model_dir`` instead of the script's fixed paths, one
JSON per seed.

``--config parity`` (the default) runs ``scripts/parity_cartpole.py``
unchanged, which writes the JSON itself:

  python tools/parity_cartpole_jax.py --seeds 1,3 --num_iterations 150 \\
      --model_dir build/parity_jax --out_prefix build/parity_jax_seed

``--config quickstart`` runs ``examples/run_cartpole.py`` unchanged through
its absl ``main``, with ``fit`` wrapped to move ``model_dir`` and to log
every iteration, so that every finished episode counts; the tool counts
them with the port's ``episodes_to_solve`` and writes the JSON:

  python tools/parity_cartpole_jax.py --config quickstart --seeds 0,4,8 \\
      --num_iterations 300 --out_prefix build/quickstart_jax_seed

About 8 s an iteration on 8 cores beside other runs. It is the JAX side of
the seeds-by-routes comparison of ``PERF.md``; the port's side is
``python -m muax_tpu_torch.examples.parity_cartpole``.
"""
import argparse
import importlib
import json
import os
import runpy
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_quickstart(seeds, num_iterations, model_dir, out_prefix, fit_module):
  """``examples/run_cartpole.py``'s ``main`` once a seed in this process,
  its flags parsed anew for each."""
  import jax
  jax.config.update("jax_platform_name", "cpu")
  from absl import flags

  from muax_tpu_torch.examples.parity_cartpole import episodes_to_solve
  script = runpy.run_path(os.path.join(ROOT, "examples", "run_cartpole.py"),
                          run_name="run_cartpole")
  fit = fit_module.fit
  captured = {}

  def fit_logging_every_iteration(*a, **kw):
    kw["model_dir"] = model_dir
    kw["log_every"] = 1
    captured["results"] = fit(*a, **kw)[1]
    return None, captured["results"]

  fit_module.fit = fit_logging_every_iteration
  for seed in seeds:
    flags.FLAGS.unparse_flags()
    flags.FLAGS(["run_cartpole.py", "--seed", str(seed),
                 "--num_iterations", str(num_iterations),
                 "--model_dir", model_dir])
    t0 = time.time()
    script["main"](None)
    results = captured.pop("results")
    out = {"config": "quickstart", "policy": "muzero", "route": "jax",
           "seed": seed, **episodes_to_solve(results),
           "warmup_episodes": int(results.get("warmup_episodes", 0)),
           "iterations": results["history"][-1]["iteration"],
           "best_test_G": results["best_reward"],
           "wall_seconds": time.time() - t0,
           "device": str(jax.devices()[0])}
    with open(f"{out_prefix}{seed}.json", "w") as f:
      json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "eval_curve"}),
          flush=True)


def main():
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument("--config", choices=("parity", "quickstart"),
                 default="parity")
  p.add_argument("--seeds", default="42")
  p.add_argument("--num_iterations", type=int, default=800)
  p.add_argument("--model_dir", default=os.path.join("build", "parity_jax"))
  p.add_argument("--out_prefix",
                 default=os.path.join("build", "parity_jax_seed"))
  args = p.parse_args()
  sys.path.insert(0, ROOT)
  os.makedirs(args.model_dir, exist_ok=True)
  os.makedirs(os.path.dirname(args.out_prefix) or ".", exist_ok=True)
  # The module, not the package's re-exported function of the same name.
  fit_module = importlib.import_module("muax_tpu.train.fit")
  seeds = [int(s) for s in args.seeds.split(",")]
  if args.config == "quickstart":
    run_quickstart(seeds, args.num_iterations, args.model_dir,
                   args.out_prefix, fit_module)
    return
  fit = fit_module.fit

  def fit_in_model_dir(*a, **kw):
    kw["model_dir"] = args.model_dir
    return fit(*a, **kw)

  fit_module.fit = fit_in_model_dir
  for seed in seeds:
    sys.argv = ["parity_cartpole.py", "--cpu", "--seed", str(seed),
                "--num_iterations", str(args.num_iterations),
                "--out", f"{args.out_prefix}{seed}.json"]
    runpy.run_path(os.path.join(ROOT, "scripts", "parity_cartpole.py"),
                   run_name="__main__")


if __name__ == "__main__":
  main()
