"""MuZero on Atari through the real-ALE host pool, on the port.

``examples/run_atari.py`` with its flags, defaults and configuration:
acme's Atari preprocessing on the host (``AtariPreprocessing``: 84 x 84
grayscale, a max-pool of the last two raw frames, action repeat 4, the
108k-frame cap), the pool stepping every env in one host call, frame
stacking on the device (``PoolFrameStacking``), and the EfficientZero
triplet (32 channels, 2 blocks, support 20) on the generic engine and
autograd, as in the JAX package (no kernel takes the conv family; the
ring's 28,224 features a window are sampled by ``replay_sample``).

  python -m muax_tpu_torch.examples.run_atari --game Breakout --num_envs 32
  python -m muax_tpu_torch.examples.run_atari --fake          # no ALE
  python -m muax_tpu_torch.examples.run_atari --measure_pool  # pool only

``--fake`` puts a synthetic RGB env (random pixels, random rewards)
behind the same preprocessing, pool and device program, so the whole
stack runs on images without ``ale_py``; without it the pool needs ALE
(``AtariVectorPool`` raises where ``ale_py`` does not import).
``--device cpu`` runs it on the CPU.
"""
from __future__ import annotations

import tempfile
import time

import numpy as np

from muax_tpu_torch.config import (MuZeroConfig, ReplayConfig, SearchConfig,
                                   TrainConfig)
from muax_tpu_torch.device import resolve_device
from muax_tpu_torch.envs.atari import AtariPreprocessing, AtariVectorPool
from muax_tpu_torch.envs.base import EnvSpec
from muax_tpu_torch.envs.wrappers import PoolFrameStacking
from muax_tpu_torch.examples import flags
from muax_tpu_torch.models import (make_efficientzero_networks,
                                   muzero_optimizer)
from muax_tpu_torch.train.fit import fit


class FakeRGBEnv:
  """A synthetic 210 x 160 x 3 env with gymnasium's 5-tuple API: it stands
  in for ALE where ``ale_py`` is absent, with Atari's frame shapes."""

  class _Space:
    def __init__(self, shape=None, n=None):
      self.shape, self.n = shape, n

  def __init__(self, seed=0):
    self._rng = np.random.RandomState(seed)
    self.observation_space = self._Space(shape=(210, 160, 3))
    self.action_space = self._Space(n=6)
    self._t = 0

  def reset(self, seed=None):
    self._t = 0
    return self._frame(), {}

  def step(self, action):
    self._t += 1
    done = self._t >= 500 and self._rng.rand() < 0.05
    return (self._frame(), float(self._rng.rand() < 0.1), done, False, {})

  def _frame(self):
    return self._rng.randint(0, 256, (210, 160, 3), dtype="uint8")


def make_pool(num_envs: int, seed: int, fake: bool, game: str = "Pong",
              device="cuda") -> AtariVectorPool:
  """The ALE pool of ``game``, or with ``fake`` the same preprocessing and
  pool over ``FakeRGBEnv``s."""
  if not fake:
    return AtariVectorPool(game, num_envs, seed=seed, device=device)
  pool = AtariVectorPool.__new__(AtariVectorPool)
  pool.device = resolve_device(device)
  pool.num_envs = num_envs
  pool._envs = [
      AtariPreprocessing(FakeRGBEnv(seed + i), frame_skip=4,
                         terminal_on_life_loss=False, seed=seed + i)
      for i in range(num_envs)
  ]
  pool._seeds = list(range(seed, seed + num_envs))
  pool.spec = EnvSpec(observation_shape=(84, 84, 1), num_actions=6,
                      max_episode_steps=108_000 // 4)
  return pool


def setup(pool, num_stack: int = 4, num_simulations: int = 50,
          collect_steps: int = 20, device="cuda"):
  """The example's stacked env, networks, config and optimizer over
  ``pool`` (``examples/run_atari.py:124-135``)."""
  stacked = PoolFrameStacking(pool, num_stack=num_stack)
  config = MuZeroConfig(
      search=SearchConfig(policy="muzero", num_simulations=num_simulations),
      replay=ReplayConfig(capacity=2048, min_fill=pool.num_envs,
                          priority_alpha=1.0),
      train=TrainConfig(num_envs=pool.num_envs, collect_steps=collect_steps,
                        batch_size=64, updates_per_iteration=4,
                        unroll_steps=5, n_bootstrap=10, discount=0.997))
  networks = make_efficientzero_networks(
      num_actions=stacked.spec.num_actions, support_size=20, channels=32,
      num_blocks=2, device=device)
  return stacked, networks, config, muzero_optimizer(peak_lr=7e-3)


def measure_pool(pool, steps: int = 50) -> float:
  """The host pool's raw ceiling: preprocessed env-steps/s of ``steps``
  batched host steps, no search or learning."""
  pool._host_reset_all()
  actions = np.zeros(pool.num_envs, np.int32)
  t0 = time.time()
  for _ in range(steps):
    pool._host_step(actions)
  return steps * pool.num_envs / (time.time() - t0)


def main(argv=None):
  """Parses ``argv`` (the command line by default); with
  ``--measure_pool`` returns the pool's env-steps/s, else trains and
  returns fit's (train_state, results)."""
  p = flags.parser(__doc__)
  p.add_argument("--game", default="Pong", help="ALE game (Pong, Breakout)")
  flags.add_bool(p, "fake", False, "use a synthetic RGB env instead of ALE")
  flags.add_bool(p, "measure_pool", False,
                 "only measure the host pool's raw step throughput")
  p.add_argument("--num_envs", type=int, default=32)
  p.add_argument("--num_stack", type=int, default=4)
  p.add_argument("--num_simulations", type=int, default=50)
  p.add_argument("--iterations", type=int, default=100)
  p.add_argument("--collect_steps", type=int, default=20)
  p.add_argument("--seed", type=int, default=0)
  opts = p.parse_args(argv)
  pool = make_pool(opts.num_envs, opts.seed, opts.fake, opts.game,
                   opts.device)
  if opts.measure_pool:
    rate = measure_pool(pool)
    print(f"host pool ceiling: {rate:,.0f} preprocessed env-steps/s "
          f"({opts.num_envs} envs, frame_skip=4 -> {4 * rate:,.0f} raw "
          "frames/s)")
    return rate

  stacked, networks, config, optimizer = setup(
      pool, opts.num_stack, opts.num_simulations, opts.collect_steps,
      opts.device)
  t0 = time.time()
  with tempfile.TemporaryDirectory(prefix="muax_atari_") as model_dir:
    state, results = fit(
        stacked, networks, config, optimizer,
        num_iterations=opts.iterations, seed=opts.seed, eval_every=50,
        log_every=10, model_dir=model_dir)
  print(f"done in {time.time() - t0:,.0f}s; "
        f"best eval return {results['best_reward']:.1f}")
  return state, results


if __name__ == "__main__":
  main()
