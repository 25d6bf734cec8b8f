"""AlphaZero self-play on Connect Four with the conv resnet tower, on the
port.

``examples/run_connect4.py`` with its flags, defaults and configuration:
the game as the search's model with legal masks and alternating players
(the generic engine, no kernel), 256 games x 21 moves an iteration at 96
simulations, ``make_az_resnet`` at 32 channels x 4 blocks, batch 512, 8
updates an iteration, a ring of 4096, adam at 2e-3, an evaluation against
a random player over 256 games every 20 iterations (target: a mean
outcome of at least +0.9). ``--out_json`` writes the learning curve and
the config, with the card's name as the device. From the root of a
checkout:

  python -m muax_tpu_torch.examples.run_connect4 --iterations 300

``--device cpu`` runs it on the CPU.
"""
from __future__ import annotations

import json

import torch

from muax_tpu_torch.envs import ConnectFour
from muax_tpu_torch.examples import flags
from muax_tpu_torch.examples.run_tictactoe_alphazero import train
from muax_tpu_torch.models.az_networks import make_az_resnet
from muax_tpu_torch.models.optimizers import adam, flatten_optimizer
from muax_tpu_torch.train.selfplay import AZConfig

EVAL_GAMES = 256


def setup(num_simulations: int = 96, num_envs: int = 256,
          batch_size: int = 512, updates_per_iteration: int = 8,
          channels: int = 32, num_blocks: int = 4, device="cuda"):
  """The example's game, network, config and optimizer
  (``examples/run_connect4.py:50-59``)."""
  network = make_az_resnet(7, channels=channels, num_blocks=num_blocks,
                           device=device)
  config = AZConfig(num_simulations=num_simulations, num_envs=num_envs,
                    collect_steps=21, batch_size=batch_size,
                    updates_per_iteration=updates_per_iteration,
                    replay_capacity=4096)
  return ConnectFour(), network, config, flatten_optimizer(adam(2e-3))


def device_name(device) -> str:
  """The card's name (``torch.cuda.get_device_name``), or "cpu"."""
  device = torch.device(device)
  return (torch.cuda.get_device_name(device) if device.type == "cuda"
          else "cpu")


def main(argv=None):
  """Parses ``argv`` (the command line by default), trains, and returns
  the evaluations (``run_tictactoe_alphazero.train``'s second output)."""
  p = flags.parser(__doc__)
  p.add_argument("--iterations", type=int, default=300)
  p.add_argument("--num_simulations", type=int, default=96)
  p.add_argument("--num_envs", type=int, default=256)
  p.add_argument("--batch_size", type=int, default=512)
  p.add_argument("--updates_per_iteration", type=int, default=8)
  p.add_argument("--channels", type=int, default=32)
  p.add_argument("--num_blocks", type=int, default=4)
  p.add_argument("--eval_every", type=int, default=20)
  p.add_argument("--seed", type=int, default=0)
  p.add_argument("--out_json", default="",
                 help="write the learning curve + config here")
  opts = p.parse_args(argv)
  game, network, config, optimizer = setup(
      opts.num_simulations, opts.num_envs, opts.batch_size,
      opts.updates_per_iteration, opts.channels, opts.num_blocks,
      opts.device)
  _, curve = train(game, network, config, optimizer, opts.iterations,
                   opts.seed, opts.eval_every, EVAL_GAMES,
                   device=opts.device,
                   log=lambda m: print(m, flush=True))
  best = max([-1.0] + [score for *_, score in curve])
  print(f"final best eval_vs_random: {best:+.3f}")
  if opts.out_json:
    payload = {
        "experiment": "connect4_alphazero_vs_random",
        "threshold": 0.9,
        "threshold_met": best >= 0.9,
        "best_eval_vs_random": round(float(best), 4),
        "curve": [{"iteration": it, "seconds": round(sec, 1),
                   "loss": round(loss, 4),
                   "eval_vs_random": round(float(score), 4)}
                  for it, sec, loss, score in curve],
        "config": {
            "iterations": opts.iterations,
            "num_simulations": opts.num_simulations,
            "num_envs": opts.num_envs,
            "batch_size": opts.batch_size,
            "updates_per_iteration": opts.updates_per_iteration,
            "channels": opts.channels,
            "num_blocks": opts.num_blocks,
            "seed": opts.seed,
            "eval_games": EVAL_GAMES,
        },
        "device": device_name(opts.device),
    }
    with open(opts.out_json, "w") as f:
      json.dump(payload, f, indent=1)
    print("wrote", opts.out_json)
  return curve


if __name__ == "__main__":
  main()
