"""CartPole-v1 solved within the reference's episode budget, on the port.

The port of ``scripts/parity_cartpole.py``: the same notebook config
(embedding 10, support 20, towers (64, 64, 16), 50 simulations, unroll 10,
n-step 10, peak lr 2e-2; 8 envs x 20 steps per iteration), run through
``fit`` with ``log_every=1`` so that every iteration's finished episodes
count. It writes a JSON of the episodes it took until a greedy evaluation
first returned 500 (the reference needs about 500, README.md:141-143), the
wall time and the card, one entry per seed. From the root of a checkout,
on the card:

  python -m muax_tpu_torch.examples.parity_cartpole --policy gumbel \
      --seeds 42,7 --route fused --out build/parity_cartpole_gumbel.json

``--route`` picks the search and learner paths: ``fused`` (the default:
the search kernel, the fused sampler and the fused learner), ``generic``
(``search.fused=False`` and ``train.fused_sampler=False``: the generic
engine and the generic learner) or ``sampler`` (the generic search engine
with the fused sampler and learner).

``--config quickstart`` runs the quickstart instead, ``run_cartpole`` at
its defaults (its ``setup``: 16 envs x 25 steps, a warm-up of 64 segments,
a greedy evaluation every 10 iterations), counting its episodes in the
same way:

  python -m muax_tpu_torch.examples.parity_cartpole --config quickstart \
      --seeds 42,7 --out build/quickstart.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import tempfile
import time

import torch

from muax_tpu_torch.config import (MuZeroConfig, ReplayConfig, SearchConfig,
                                   TrainConfig)
from muax_tpu_torch.envs import CartPole
from muax_tpu_torch.examples import run_cartpole
from muax_tpu_torch.models import make_mlp_networks, muzero_optimizer
from muax_tpu_torch.train.fit import fit

TARGET = 500.0
ROUTES = ("fused", "generic", "sampler")
CONFIGS = ("parity", "quickstart")


def on_route(config: MuZeroConfig, route: str) -> MuZeroConfig:
  """``config`` with the search and learner paths of ``route``."""
  if route not in ROUTES:
    raise ValueError(f"route {route!r} is not one of {ROUTES}")
  return dataclasses.replace(
      config,
      search=dataclasses.replace(config.search, fused=route == "fused"),
      train=dataclasses.replace(config.train,
                                fused_sampler=route != "generic"))


def parity_config(policy: str, route: str = "fused") -> MuZeroConfig:
  """The notebook config (examples/run_cartpole.py defaults), episode-frugal:
  8 envs x 20 steps per iteration with a minimal warm-up, on ``route``."""
  return on_route(MuZeroConfig(
      search=SearchConfig(policy=policy, num_simulations=50),
      replay=ReplayConfig(capacity=2048, min_fill=8, priority_alpha=0.5),
      train=TrainConfig(num_envs=8, collect_steps=20, batch_size=256,
                        updates_per_iteration=64, unroll_steps=10,
                        n_bootstrap=10, discount=0.997)), route)


def episodes_to_solve(results: dict) -> dict:
  """Episodes finished (warm-up included) up to the first evaluation that
  reached the target, and the evaluation curve."""
  episodes = int(results.get("warmup_episodes", 0))
  solved_at = solve_iteration = None
  curve = []
  for row in results["history"]:
    episodes += int(row.get("episodes_finished", 0))
    if "test_G" in row:
      curve.append({"iteration": row["iteration"], "episodes": episodes,
                    "test_G": row["test_G"]})
      if row["test_G"] >= TARGET and solved_at is None:
        solved_at, solve_iteration = episodes, row["iteration"]
  return {"solved": solved_at is not None, "episodes_to_solve": solved_at,
          "solve_iteration": solve_iteration, "total_episodes": episodes,
          "eval_curve": curve}


def card() -> str:
  """The card's name and power limit as nvidia-smi prints them, or the
  device the run used where there is no card."""
  if not torch.cuda.is_available():
    return "cpu"
  out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
  return out.stdout.strip().splitlines()[0]


def make_run(policy: str, route: str, device: str,
             config: str = "parity"):
  """(env, networks, config, optimizer, eval_every) of the notebook config
  (``config="parity"``) or of the quickstart's (``"quickstart"``) on
  ``route``."""
  if config == "quickstart":
    env, networks, cfg, optimizer = run_cartpole.setup(policy=policy,
                                                       device=device)
    return env, networks, on_route(cfg, route), optimizer, 10
  networks = make_mlp_networks(num_actions=2, embedding_dim=10,
                               support_size=20, repr_layers=(),
                               pred_layers=(64, 64, 16),
                               dyn_layers=(64, 64, 16), device=device)
  optimizer = muzero_optimizer(peak_lr=2e-2, end_lr=1e-4,
                               warmup_steps=2000, transition_steps=10000,
                               decay_rate=0.8)
  return CartPole(), networks, parity_config(policy, route), optimizer, 5


def solve(policy: str, route: str, seed: int, num_iterations: int,
          device: str, model_dir: str, config: str = "parity") -> dict:
  """One CartPole run of the notebook config (``config="parity"``) or of
  the quickstart's (``"quickstart"``); its entry of the JSON."""
  env, networks, cfg, optimizer, eval_every = make_run(policy, route, device,
                                                       config)
  t0 = time.time()
  with tempfile.TemporaryDirectory(dir=model_dir) as d:
    _, results = fit(env, networks, cfg, optimizer,
                     num_iterations=num_iterations, seed=seed,
                     eval_every=eval_every, log_every=1, model_dir=d,
                     target_reward=TARGET,
                     log_fn=lambda m: print(m, flush=True))
  return {"config": config, "policy": policy, "route": route, "seed": seed,
          **episodes_to_solve(results),
          "warmup_episodes": int(results.get("warmup_episodes", 0)),
          "iterations": results["history"][-1]["iteration"],
          "best_test_G": results["best_reward"],
          "wall_seconds": time.time() - t0}


def main():
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument("--policy", choices=("muzero", "gumbel"), default="muzero")
  p.add_argument("--route", choices=ROUTES, default="fused")
  p.add_argument("--config", choices=CONFIGS, default="parity")
  p.add_argument("--seeds", default="42",
                 help="comma-separated seeds, run one after the other")
  p.add_argument("--num_iterations", type=int, default=800)
  p.add_argument("--device", default="cuda")
  p.add_argument("--out", default=None,
                 help="JSON path (default build/parity_cartpole_<policy>_"
                      "<route>.json)")
  args = p.parse_args()
  prefix = "parity_cartpole" if args.config == "parity" else "quickstart"
  out_path = args.out or os.path.join(
      "build", f"{prefix}_{args.policy}_{args.route}.json")
  os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
  out = {
      "claim": "CartPole-v1 test_G=500 within <=500 episodes "
               "(reference ~500 episodes, README.md:141-143)",
      "config": ("notebook config: embed 10, support 20, towers (64,64,16), "
                 "50 sims, unroll 10, n-step 10, peak lr 2e-2; "
                 + ("8 envs x 20 steps" if args.config == "parity" else
                    "run_cartpole's defaults: 16 envs x 25 steps")),
      "device": card() if args.device != "cpu" else "cpu", "runs": []}
  for seed in (int(s) for s in args.seeds.split(",")):
    run = solve(args.policy, args.route, seed, args.num_iterations,
                args.device, os.path.dirname(out_path) or ".", args.config)
    out["runs"].append(run)
    with open(out_path, "w") as f:  # rewritten after each seed
      json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in run.items() if k != "eval_curve"}),
          flush=True)


if __name__ == "__main__":
  main()
