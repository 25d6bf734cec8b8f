"""CartPole-v1 solved within the reference's episode budget, on the port.

The port of ``scripts/parity_cartpole.py``: the same notebook config
(embedding 10, support 20, towers (64, 64, 16), 50 simulations, unroll 10,
n-step 10, peak lr 2e-2; 8 envs x 20 steps per iteration), run through
``fit`` with ``log_every=1`` so that every iteration's finished episodes
count. It writes a JSON of the episodes it took until a greedy evaluation
first returned 500 (the reference needs about 500, README.md:141-143), the
wall time and the card. From the root of a checkout, on the card:

  python -m muax_tpu_torch.examples.parity_cartpole --policy gumbel \
      --out build/parity_cartpole_gumbel.json
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import torch

from muax_tpu_torch.config import (MuZeroConfig, ReplayConfig, SearchConfig,
                                   TrainConfig)
from muax_tpu_torch.envs import CartPole
from muax_tpu_torch.models import make_mlp_networks, muzero_optimizer
from muax_tpu_torch.train.fit import fit

TARGET = 500.0


def parity_config(policy: str) -> MuZeroConfig:
  """The notebook config (examples/run_cartpole.py defaults), episode-frugal:
  8 envs x 20 steps per iteration with a minimal warm-up."""
  return MuZeroConfig(
      search=SearchConfig(policy=policy, num_simulations=50),
      replay=ReplayConfig(capacity=2048, min_fill=8, priority_alpha=0.5),
      train=TrainConfig(num_envs=8, collect_steps=20, batch_size=256,
                        updates_per_iteration=64, unroll_steps=10,
                        n_bootstrap=10, discount=0.997))


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


def main():
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument("--policy", choices=("muzero", "gumbel"), default="muzero")
  p.add_argument("--seed", type=int, default=42)
  p.add_argument("--num_iterations", type=int, default=800)
  p.add_argument("--device", default="cuda")
  p.add_argument("--out", default=None,
                 help="JSON path (default build/parity_cartpole_<policy>"
                      ".json)")
  args = p.parse_args()
  out_path = args.out or os.path.join("build",
                                      f"parity_cartpole_{args.policy}.json")
  os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)

  networks = make_mlp_networks(num_actions=2, embedding_dim=10,
                               support_size=20, repr_layers=(),
                               pred_layers=(64, 64, 16),
                               dyn_layers=(64, 64, 16), device=args.device)
  optimizer = muzero_optimizer(peak_lr=2e-2, end_lr=1e-4, warmup_steps=2000,
                               transition_steps=10000, decay_rate=0.8)
  t0 = time.time()
  with tempfile.TemporaryDirectory(dir=os.path.dirname(out_path) or ".") as d:
    _, results = fit(CartPole(), networks, parity_config(args.policy),
                     optimizer, num_iterations=args.num_iterations,
                     seed=args.seed, eval_every=5, log_every=1,
                     model_dir=d, target_reward=TARGET,
                     log_fn=lambda m: print(m, flush=True))
  wall = time.time() - t0
  out = {
      "claim": "CartPole-v1 test_G=500 within <=500 episodes "
               "(reference ~500 episodes, README.md:141-143)",
      "config": "notebook config: embed 10, support 20, towers (64,64,16), "
                "50 sims, unroll 10, n-step 10, peak lr 2e-2",
      "policy": args.policy, "seed": args.seed,
      **episodes_to_solve(results),
      "warmup_episodes": int(results.get("warmup_episodes", 0)),
      "best_test_G": results["best_reward"],
      "wall_seconds": wall, "device": card(),
  }
  with open(out_path, "w") as f:
    json.dump(out, f, indent=1)
  print(json.dumps({k: v for k, v in out.items() if k != "eval_curve"}))


if __name__ == "__main__":
  main()
