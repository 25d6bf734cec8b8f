"""Train MuZero on CartPole-v1, the canonical quickstart, on the port.

``examples/run_cartpole.py`` with its flags, defaults and configuration:
16 envs x 25 steps an iteration, 50 simulations, batch 256, 64 updates
an iteration, unroll 10, n-step 10, discount 0.997, the notebook triplet
(embedding 10, support 20, towers (64, 64, 16)) and its optimizer, a
greedy evaluation every 10 iterations, stopping at a return of 500. On
the card the search, the sampler and the learner run their kernels. From
the root of a checkout:

  python -m muax_tpu_torch.examples.run_cartpole --num_iterations 800

``--device cpu`` runs it on the CPU through the kernels' plain versions.
"""
from __future__ import annotations

from muax_tpu_torch.config import (MuZeroConfig, ReplayConfig, SearchConfig,
                                   TrainConfig)
from muax_tpu_torch.envs import CartPole
from muax_tpu_torch.examples import flags
from muax_tpu_torch.models import make_mlp_networks, muzero_optimizer
from muax_tpu_torch.monitor import TrainMonitor
from muax_tpu_torch.train.fit import fit


def setup(num_simulations: int = 50, num_envs: int = 16,
          batch_size: int = 256, updates_per_iteration: int = 64,
          policy: str = "muzero", device="cuda"):
  """The example's env, networks, config and optimizer
  (``examples/run_cartpole.py:36-55``)."""
  config = MuZeroConfig(
      search=SearchConfig(policy=policy, num_simulations=num_simulations),
      replay=ReplayConfig(capacity=2048, min_fill=64, priority_alpha=0.5),
      train=TrainConfig(num_envs=num_envs, collect_steps=25,
                        batch_size=batch_size,
                        updates_per_iteration=updates_per_iteration,
                        unroll_steps=10, n_bootstrap=10, discount=0.997))
  # The working notebook config: embed 10, support 20, deep heads
  # (examples/cartpole.ipynb in the reference).
  networks = make_mlp_networks(num_actions=2, embedding_dim=10,
                               support_size=20, repr_layers=(),
                               pred_layers=(64, 64, 16),
                               dyn_layers=(64, 64, 16), device=device)
  optimizer = muzero_optimizer(peak_lr=2e-2, end_lr=1e-4, warmup_steps=2000,
                               transition_steps=10000, decay_rate=0.8)
  return CartPole(), networks, config, optimizer


def main(argv=None):
  """Parses ``argv`` (the command line by default), trains, and returns
  fit's (train_state, results)."""
  p = flags.parser(__doc__)
  p.add_argument("--num_iterations", type=int, default=800)
  p.add_argument("--num_simulations", type=int, default=50)
  p.add_argument("--num_envs", type=int, default=16)
  p.add_argument("--batch_size", type=int, default=256)
  p.add_argument("--updates_per_iteration", type=int, default=64)
  p.add_argument("--seed", type=int, default=42)
  p.add_argument("--model_dir", default="models/torch/cartpole")
  p.add_argument("--policy", default="muzero", help="muzero | gumbel")
  p.add_argument("--reanalyze_every", type=int, default=0,
                 help="reanalyze cadence (0 = off)")
  p.add_argument("--tensorboard_dir", default="",
                 help="tensorboard log dir (optional)")
  opts = p.parse_args(argv)
  env, networks, config, optimizer = setup(
      opts.num_simulations, opts.num_envs, opts.batch_size,
      opts.updates_per_iteration, opts.policy, opts.device)
  if opts.tensorboard_dir:
    # The JAX script's monitor: it opens the tensorboard log directory.
    TrainMonitor(opts.tensorboard_dir)

  def log(msg):
    print(msg, flush=True)

  state, results = fit(
      env, networks, config, optimizer,
      num_iterations=opts.num_iterations, seed=opts.seed, eval_every=10,
      log_every=10, model_dir=opts.model_dir, target_reward=500.0,
      log_fn=log, reanalyze_every=opts.reanalyze_every or None)
  print(f"best test_G: {results['best_reward']} "
        f"checkpoint: {results['model_path']}")
  return state, results


if __name__ == "__main__":
  main()
