"""Train MuZero from pixels with the EfficientZero conv family, on the port.

``examples/run_pixel.py`` with its flags, defaults and configuration:
PixelCatch renders Catch at 80 x 40 x 1 uint8 frames (scale 8), four
frames concatenated along the channels (``FrameStackingEnv``), 64 envs x
12 steps, 25 simulations, batch 128, 16 updates an iteration, the
EfficientZero triplet (16 channels, 1 block, support 5, downsampled) and
adam at 1e-3. The conv triplet has no search or learner kernel, as in
the JAX package: the search runs the generic engine and the learner
autograd; a ring of more than 64 observation features is sampled by
``replay_sample``. From the root of a checkout, on the card:

  python -m muax_tpu_torch.examples.run_pixel --num_iterations 300

``--device cpu`` runs it on the CPU.
"""
from __future__ import annotations

import torch

from muax_tpu_torch.config import (MuZeroConfig, ReplayConfig, SearchConfig,
                                   TrainConfig)
from muax_tpu_torch.envs import PixelCatch
from muax_tpu_torch.envs.wrappers import FrameStackingEnv
from muax_tpu_torch.examples import flags
from muax_tpu_torch.models import (create_optimizer,
                                   make_efficientzero_networks)
from muax_tpu_torch.train.fit import fit


def setup(num_simulations: int = 25, num_envs: int = 64,
          batch_size: int = 128, updates_per_iteration: int = 16,
          rows: int = 10, columns: int = 5, scale: int = 8,
          num_frames: int = 4, channels: int = 16, num_blocks: int = 1,
          device="cuda"):
  """The example's env, networks, config and optimizer
  (``examples/run_pixel.py:44-62``)."""
  # uint8 frames (the reference ALE convention): the replay ring stores
  # raw bytes and the conv net up-casts on entry.
  env = FrameStackingEnv(
      PixelCatch(rows=rows, columns=columns, scale=scale, dtype=torch.uint8),
      num_frames=num_frames, stack=False)
  config = MuZeroConfig(
      search=SearchConfig(num_simulations=num_simulations,
                          dirichlet_alpha=1.0),
      replay=ReplayConfig(capacity=1024, min_fill=64),
      train=TrainConfig(num_envs=num_envs, collect_steps=12,
                        batch_size=batch_size,
                        updates_per_iteration=updates_per_iteration,
                        unroll_steps=5, n_bootstrap=10, discount=0.997))
  networks = make_efficientzero_networks(
      num_actions=3, support_size=5, channels=channels,
      num_blocks=num_blocks, downsample=True, device=device)
  optimizer = create_optimizer("adam", lr=1e-3)
  return env, networks, config, optimizer


def main(argv=None):
  """Parses ``argv`` (the command line by default), trains, and returns
  fit's (train_state, results)."""
  p = flags.parser(__doc__)
  p.add_argument("--num_iterations", type=int, default=300)
  p.add_argument("--num_simulations", type=int, default=25)
  p.add_argument("--num_envs", type=int, default=64)
  p.add_argument("--batch_size", type=int, default=128)
  p.add_argument("--updates_per_iteration", type=int, default=16)
  p.add_argument("--rows", type=int, default=10)
  p.add_argument("--columns", type=int, default=5)
  p.add_argument("--scale", type=int, default=8,
                 help="pixels per board cell (8 -> 80x40 frames)")
  p.add_argument("--num_frames", type=int, default=4)
  p.add_argument("--channels", type=int, default=16)
  p.add_argument("--num_blocks", type=int, default=1)
  p.add_argument("--seed", type=int, default=42)
  p.add_argument("--model_dir", default="models/torch/pixel")
  opts = p.parse_args(argv)
  env, networks, config, optimizer = setup(
      opts.num_simulations, opts.num_envs, opts.batch_size,
      opts.updates_per_iteration, opts.rows, opts.columns, opts.scale,
      opts.num_frames, opts.channels, opts.num_blocks, opts.device)
  state, results = fit(
      env, networks, config, optimizer,
      num_iterations=opts.num_iterations, seed=opts.seed, eval_every=20,
      log_every=10, model_dir=opts.model_dir, target_reward=0.95,
      log_fn=lambda m: print(m, flush=True))
  print(f"best test_G: {results['best_reward']} "
        f"checkpoint: {results['model_path']}")
  return state, results


if __name__ == "__main__":
  main()
