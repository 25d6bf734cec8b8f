"""MuZero on CartPole at the reference's acme data regime, on the port.

``examples/run_acme_regime.py`` with its flags, defaults and
configuration: ``acme_defaults`` (50 simulations, batch 32 x 8 gradient
steps an update, unroll 5, n-step 10, discount 0.99, a 50/50
offline/online replay mix and the samples-per-insert gate at 32 with 10 %
tolerance) at 64 envs x 20 steps and batch 256, the notebook triplet
without a representation tower, and acme's optimizer, adamw at 1e-4. The
gate holds the learner to 32 sampled windows per inserted env step.
Checkpoints go to a temporary directory. From the root of a checkout, on
the card:

  python -m muax_tpu_torch.examples.run_acme_regime --num_iterations 300

``--device cpu`` runs it on the CPU through the kernels' plain versions.
"""
from __future__ import annotations

import tempfile

from muax_tpu_torch.config import acme_defaults
from muax_tpu_torch.envs import CartPole
from muax_tpu_torch.examples import flags
from muax_tpu_torch.models import create_optimizer, make_mlp_networks
from muax_tpu_torch.train.fit import fit


def setup(num_envs: int = 64, device="cuda"):
  """The example's env, networks, config and optimizer
  (``examples/run_acme_regime.py:31-39``)."""
  config = acme_defaults(num_envs=num_envs, collect_steps=20,
                         batch_size=256)
  networks = make_mlp_networks(num_actions=2, embedding_dim=10,
                               support_size=20, pred_layers=(64, 64, 16),
                               dyn_layers=(64, 64, 16), device=device)
  # The acme reference optimizer: adamw 1e-4 (config.py:38).
  optimizer = create_optimizer("adamw", lr=1e-4)
  return CartPole(), networks, config, optimizer


def main(argv=None):
  """Parses ``argv`` (the command line by default), trains, and returns
  fit's (train_state, results)."""
  p = flags.parser(__doc__)
  p.add_argument("--num_iterations", type=int, default=300)
  p.add_argument("--num_envs", type=int, default=64)
  p.add_argument("--seed", type=int, default=42)
  opts = p.parse_args(argv)
  env, networks, config, optimizer = setup(opts.num_envs, opts.device)
  with tempfile.TemporaryDirectory(prefix="muax_acme_regime_") as model_dir:
    state, results = fit(
        env, networks, config, optimizer,
        num_iterations=opts.num_iterations, seed=opts.seed, eval_every=20,
        log_every=10, model_dir=model_dir, target_reward=500.0)
  print(f"best eval return: {results['best_reward']:.1f}; "
        f"learner steps: {int(state.step)} "
        f"(SPI-gated at 32 windows per inserted step)")
  return state, results


if __name__ == "__main__":
  main()
