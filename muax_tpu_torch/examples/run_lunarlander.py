"""Gumbel MuZero on LunarLander-v3 through the host gym pool, on the port.

``examples/run_lunarlander.py`` with its flags, defaults and
configuration (the reference's lunarlander notebook: 64 simulations of
Gumbel MuZero, n-step 50, discount 0.999, peak lr 2e-3): the physics on
the host (``GymVectorPool``), search, replay and learner on the device,
and a pool of its own for the greedy evaluation. It needs gymnasium with
Box2D. From the root of a checkout:

  python -m muax_tpu_torch.examples.run_lunarlander --num_iterations 2000

``--device cpu`` runs it on the CPU through the kernels' plain versions.
"""
from __future__ import annotations

from muax_tpu_torch.config import (MuZeroConfig, ReplayConfig, SearchConfig,
                                   TrainConfig)
from muax_tpu_torch.envs.gym_adapter import GymVectorPool
from muax_tpu_torch.examples import flags
from muax_tpu_torch.models import make_mlp_networks, muzero_optimizer
from muax_tpu_torch.train.fit import fit


def make_pool(num_envs: int, seed: int, device="cuda") -> GymVectorPool:
  try:
    return GymVectorPool("LunarLander-v3", num_envs=num_envs, seed=seed,
                         device=device)
  except Exception:  # older gymnasium naming
    return GymVectorPool("LunarLander-v2", num_envs=num_envs, seed=seed,
                         device=device)


def setup(num_simulations: int = 64, num_envs: int = 16,
          batch_size: int = 256, updates_per_iteration: int = 32,
          seed: int = 0, device="cuda"):
  """The example's pool, evaluation pool, networks, config and optimizer
  (``examples/run_lunarlander.py:42-65``)."""
  pool = make_pool(num_envs, seed, device)
  # A pool of its own for the greedy evaluation: it must not step the
  # training envs.
  eval_pool = make_pool(min(8, num_envs), seed + 10_000, device)
  config = MuZeroConfig(
      search=SearchConfig(policy="gumbel", num_simulations=num_simulations),
      replay=ReplayConfig(capacity=4096, min_fill=128, priority_alpha=0.5),
      train=TrainConfig(num_envs=num_envs, collect_steps=25,
                        batch_size=batch_size,
                        updates_per_iteration=updates_per_iteration,
                        unroll_steps=10, n_bootstrap=50, discount=0.999))
  networks = make_mlp_networks(num_actions=pool.spec.num_actions,
                               embedding_dim=10, support_size=20,
                               repr_layers=(), pred_layers=(64, 64, 16),
                               dyn_layers=(64, 64, 16), device=device)
  optimizer = muzero_optimizer(peak_lr=2e-3, end_lr=1e-4, warmup_steps=2000,
                               transition_steps=20000, decay_rate=0.8)
  return pool, eval_pool, networks, config, optimizer


def main(argv=None):
  """Parses ``argv`` (the command line by default), trains, and returns
  fit's (train_state, results)."""
  p = flags.parser(__doc__)
  p.add_argument("--num_iterations", type=int, default=2000)
  p.add_argument("--num_simulations", type=int, default=64)
  p.add_argument("--num_envs", type=int, default=16)
  p.add_argument("--batch_size", type=int, default=256)
  p.add_argument("--updates_per_iteration", type=int, default=32)
  p.add_argument("--seed", type=int, default=0)
  p.add_argument("--model_dir", default="models/torch/lunarlander")
  opts = p.parse_args(argv)
  pool, eval_pool, networks, config, optimizer = setup(
      opts.num_simulations, opts.num_envs, opts.batch_size,
      opts.updates_per_iteration, opts.seed, opts.device)
  state, results = fit(pool, networks, config, optimizer,
                       num_iterations=opts.num_iterations, seed=opts.seed,
                       eval_every=25, log_every=10, model_dir=opts.model_dir,
                       target_reward=200.0, eval_env=eval_pool)
  print("best test_G:", results["best_reward"])
  return state, results


if __name__ == "__main__":
  main()
