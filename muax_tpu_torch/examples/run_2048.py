"""MuZero on the native C++ 2048 pool, on the port: ``examples/run_2048.py``
with its configuration unchanged (64 boards x 50 simulations, the MLP
triplet at embedding 64, support 300 and towers (256, 256), batch 256, 16
updates an iteration, a ring of 2048 segments of 32 steps, min_fill 128,
and a greedy evaluation pool of 16 boards at seed + 10,000).

The towers are wider than a block's shared memory, so the search and the
learner kernels read their weights from device memory (``smem_weights``
False in their plans). From the root of a checkout, on the card:

  python -m muax_tpu_torch.examples.run_2048 --num_iterations 500

``--device cpu`` runs it on the CPU through the kernels' plain versions.
"""
from __future__ import annotations

from muax_tpu_torch.config import (MuZeroConfig, ReplayConfig, SearchConfig,
                                   TrainConfig)
from muax_tpu_torch.envs.native2048 import Native2048Pool
from muax_tpu_torch.examples import flags
from muax_tpu_torch.models import make_mlp_networks, muzero_optimizer
from muax_tpu_torch.train.fit import fit


def setup(num_envs: int = 64, num_simulations: int = 50,
          batch_size: int = 256, updates_per_iteration: int = 16,
          seed: int = 0, policy: str = "muzero", device="cuda"):
  """The example's pool, evaluation pool, networks, config and optimizer
  (``examples/run_2048.py:42-59``); fit's own keywords are the caller's."""
  pool = Native2048Pool(num_envs=num_envs, seed=seed, device=device)
  # A pool of its own for the greedy evaluation: it must not step the
  # training boards.
  eval_pool = Native2048Pool(num_envs=min(16, num_envs), seed=seed + 10_000,
                             device=device)
  config = MuZeroConfig(
      search=SearchConfig(policy=policy, num_simulations=num_simulations),
      replay=ReplayConfig(capacity=2048, min_fill=128),
      train=TrainConfig(num_envs=num_envs, collect_steps=32,
                        batch_size=batch_size,
                        updates_per_iteration=updates_per_iteration,
                        unroll_steps=5, n_bootstrap=10, discount=0.999))
  # A 2048-style dense triplet with a wide support (the reference's
  # game2048 config uses support 0..600; the integer support 300 of the
  # h-transform covers rewards up to about 10^5).
  networks = make_mlp_networks(num_actions=4, embedding_dim=64,
                               support_size=300, repr_layers=(256, 256),
                               pred_layers=(256, 256),
                               dyn_layers=(256, 256), device=device)
  optimizer = muzero_optimizer(peak_lr=1e-2, end_lr=1e-4, warmup_steps=2000,
                               transition_steps=20000, decay_rate=0.8)
  return pool, eval_pool, networks, config, optimizer


def main(argv=None):
  """Parses ``argv`` (the command line by default), trains, and returns
  fit's (train_state, results)."""
  parser = flags.parser(__doc__)
  parser.add_argument("--num_iterations", type=int, default=500)
  parser.add_argument("--num_simulations", type=int, default=50)
  parser.add_argument("--num_envs", type=int, default=64)
  parser.add_argument("--batch_size", type=int, default=256)
  parser.add_argument("--updates_per_iteration", type=int, default=16)
  parser.add_argument("--seed", type=int, default=0)
  parser.add_argument("--policy", default="muzero", help="muzero | gumbel")
  parser.add_argument("--model_dir", default="models/torch/2048")
  opts = parser.parse_args(argv)
  pool, eval_pool, networks, config, optimizer = setup(
      opts.num_envs, opts.num_simulations, opts.batch_size,
      opts.updates_per_iteration, opts.seed, opts.policy, opts.device)
  state, results = fit(pool, networks, config, optimizer,
                       num_iterations=opts.num_iterations, seed=opts.seed,
                       eval_every=25, log_every=10,
                       model_dir=opts.model_dir, eval_env=eval_pool)
  print("best mean score:", results["best_reward"])
  return state, results


if __name__ == "__main__":
  main()
