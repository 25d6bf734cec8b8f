"""AlphaZero self-play on TicTacToe, on the port.

``examples/run_tictactoe_alphazero.py`` with its flags, defaults and
configuration: the game itself as the search's model (the generic engine,
no kernel), 128 games x 18 moves an iteration at 48 simulations, the MLP
tower (128, 128), batch 256, 8 updates an iteration, adam at 1e-3, an
evaluation against a random player over 128 games every 20 iterations;
the temperature drops from 1 to 0.5 halfway. From the root of a checkout:

  python -m muax_tpu_torch.examples.run_tictactoe_alphazero --iterations 200

``--device cpu`` runs it on the CPU.
"""
from __future__ import annotations

import time

import torch

from muax_tpu_torch.device import resolve_device
from muax_tpu_torch.envs.tictactoe import TicTacToe
from muax_tpu_torch.examples import flags
from muax_tpu_torch.models.az_networks import make_az_mlp
from muax_tpu_torch.models.optimizers import adam, flatten_optimizer
from muax_tpu_torch.replay.buffer import replay_add, replay_init
from muax_tpu_torch.train.selfplay import (AZConfig, evaluate_vs_random,
                                           make_az_selfplay_fn,
                                           make_az_update_fn)

def setup(num_simulations: int = 48, num_envs: int = 128,
          batch_size: int = 256, updates_per_iteration: int = 8,
          device="cuda"):
  """The example's game, network, config and optimizer
  (``examples/run_tictactoe_alphazero.py:44-50``)."""
  network = make_az_mlp(9, hidden=(128, 128), device=device)
  config = AZConfig(num_simulations=num_simulations, num_envs=num_envs,
                    collect_steps=18, batch_size=batch_size,
                    updates_per_iteration=updates_per_iteration)
  return TicTacToe(), network, config, flatten_optimizer(adam(1e-3))


def train(game, network, config, optimizer, iterations: int, seed: int,
          eval_every: int, eval_games: int, device="cuda", log=print):
  """The self-play loop of the AlphaZero examples: each iteration plays
  ``config.collect_steps`` moves of every game, adds them to the ring and
  runs ``config.updates_per_iteration`` updates; every ``eval_every``
  iterations the agent plays ``eval_games`` games against a random
  player. Returns (params, the evaluations as (iteration, seconds, loss,
  score))."""
  device = resolve_device(device)
  gen = torch.Generator(device=device).manual_seed(seed)
  params = network.init_params(game.spec.observation_shape,
                               torch.Generator().manual_seed(seed))
  opt_state = optimizer.init(params)
  state, _ = game.reset(gen, config.num_envs)
  replay = replay_init(config.replay_capacity, config.collect_steps,
                       game.spec.observation_shape, network.num_actions,
                       device=device)
  selfplay = make_az_selfplay_fn(game, network, config)
  update = make_az_update_fn(network, optimizer, config)
  t0 = time.time()
  curve = []
  for it in range(iterations):
    temperature = 1.0 if it < iterations // 2 else 0.5
    state, segments, priorities, metrics = selfplay(params, state, gen,
                                                    temperature)
    replay_add(replay, segments, priorities)
    for _ in range(config.updates_per_iteration):
      params, opt_state, replay, m = update(params, opt_state, replay, gen)
    if (it + 1) % eval_every == 0:
      score = evaluate_vs_random(game, network, params, gen,
                                 num_games=eval_games,
                                 num_simulations=config.num_simulations)
      curve.append((it + 1, time.time() - t0, float(m["loss"]), score))
      log(f"[{time.time()-t0:6.0f}s] it {it+1}: "
          f"loss={float(m['loss']):.3f} "
          f"eps={int(metrics['episodes_finished'])} "
          f"eval_vs_random={score:+.3f}")
  return params, curve


def main(argv=None):
  """Parses ``argv`` (the command line by default), trains, and returns
  the evaluations (``train``'s second output)."""
  p = flags.parser(__doc__)
  p.add_argument("--iterations", type=int, default=200)
  p.add_argument("--num_simulations", type=int, default=48)
  p.add_argument("--num_envs", type=int, default=128)
  p.add_argument("--batch_size", type=int, default=256)
  p.add_argument("--updates_per_iteration", type=int, default=8)
  p.add_argument("--seed", type=int, default=0)
  opts = p.parse_args(argv)
  game, network, config, optimizer = setup(
      opts.num_simulations, opts.num_envs, opts.batch_size,
      opts.updates_per_iteration, opts.device)
  _, curve = train(game, network, config, optimizer, opts.iterations,
                   opts.seed, eval_every=20, eval_games=128,
                   device=opts.device,
                   log=lambda m: print(m, flush=True))
  return curve


if __name__ == "__main__":
  main()
