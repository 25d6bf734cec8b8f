"""The port's ``fit`` over host pools, as ``tests/test_fit_pool.py`` holds
the JAX one: a fake host pool (a deterministic counter env speaking the
``AutoResetWrapper`` interface through host calls) without and with a
dedicated evaluation pool, and two small iterations on the native 2048
pool, every action legal under its board's mask. On the CPU."""
import numpy as np
import torch

from muax_tpu_torch.config import (MuZeroConfig, ReplayConfig, SearchConfig,
                                   TrainConfig)
from muax_tpu_torch.envs.base import AutoResetState, EnvSpec
from muax_tpu_torch.models import make_mlp_networks
from muax_tpu_torch.models.optimizers import muzero_optimizer
from muax_tpu_torch.train.fit import fit
from tests.test_torch_parity import one_thread  # noqa: F401


class FakeHostPool:
  """A host pool of the interface's minimum: obs = [t, t, t, a_prev],
  reward = the action, episodes of 5 steps; it counts its host steps."""

  def __init__(self, num_envs: int):
    self.num_envs = num_envs
    self.spec = EnvSpec(observation_shape=(4,), num_actions=2,
                        max_episode_steps=5)
    self._t = np.zeros(num_envs, np.int64)
    self.host_steps = 0

  def legal_action_mask(self, carry):
    return None

  def reset(self, generator, batch_size):
    assert batch_size == self.num_envs, (batch_size, self.num_envs)
    self._t[:] = 0
    return AutoResetState(env_state=(), obs=torch.zeros(self.num_envs, 4),
                          episode_step=torch.zeros(self.num_envs,
                                                   dtype=torch.int32),
                          episode_return=torch.zeros(self.num_envs))

  def step(self, carry, action, generator):
    self.host_steps += 1
    action = action.numpy()
    self._t += 1
    done = self._t >= 5
    self._t[done] = 0
    obs = np.tile(self._t[:, None], (1, 4)).astype(np.float32)
    obs[:, 3] = action
    reward = torch.from_numpy(action.astype(np.float32))
    done = torch.from_numpy(done)
    episode_return = carry.episode_return + reward
    new_carry = AutoResetState(
        env_state=(), obs=torch.from_numpy(obs),
        episode_step=torch.where(done, 0, carry.episode_step + 1).to(
            torch.int32),
        episode_return=torch.where(done, 0.0, episode_return))
    return new_carry, reward, done, {"terminated": done,
                                     "truncated": torch.zeros_like(done),
                                     "episode_return": episode_return}


def _config(num_envs):
  return MuZeroConfig(
      search=SearchConfig(num_simulations=4),
      replay=ReplayConfig(capacity=64, min_fill=8),
      train=TrainConfig(num_envs=num_envs, collect_steps=6, batch_size=8,
                        updates_per_iteration=2, unroll_steps=2,
                        n_bootstrap=3))


def _networks():
  return make_mlp_networks(num_actions=2, embedding_dim=4, support_size=5,
                           device="cpu")


def test_fit_over_pool_without_eval_env():
  # Evaluation is skipped, not run on the training pool, and the best
  # model follows the rollouts' returns.
  pool = FakeHostPool(num_envs=4)
  logs = []
  _, results = fit(pool, _networks(), _config(4), muzero_optimizer(),
                   num_iterations=3, eval_every=1, log_every=1,
                   save_best=False, log_fn=logs.append)
  assert len(results["history"]) == 3
  assert all("test_G" not in h for h in results["history"])
  assert results["best_reward"] > -np.inf
  assert any("eval disabled" in line for line in logs)
  warm_iters = max(1, 8 // 4)
  assert pool.host_steps == (warm_iters + 3) * 6


def test_fit_over_pool_with_dedicated_eval_env():
  # A second pool of another size serves the greedy evaluation; the
  # training pool steps only for training.
  pool, eval_pool = FakeHostPool(num_envs=4), FakeHostPool(num_envs=2)
  _, results = fit(pool, _networks(), _config(4), muzero_optimizer(),
                   num_iterations=2, eval_every=1, log_every=1,
                   save_best=False, eval_env=eval_pool)
  assert all("test_G" in h for h in results["history"])
  assert results["best_reward"] >= 0.0  # rewards are the actions, 0 or 1
  assert eval_pool.host_steps > 0
  warm_iters = max(1, 8 // 4)
  assert pool.host_steps == (warm_iters + 2) * 6


def test_fit_on_the_2048_pool_takes_legal_moves(one_thread):
  # examples/run_2048.py's setup cut to 8 boards x 4 simulations and a
  # small triplet: two iterations, every move of either pool legal on the
  # board it is made on, the evaluation on its own pool.
  from muax_tpu_torch.envs.native2048 import Native2048Pool
  pool = Native2048Pool(num_envs=8, seed=0, device="cpu")
  eval_pool = Native2048Pool(num_envs=4, seed=10_000, device="cpu")
  taken = []
  for p in (pool, eval_pool):
    def step(carry, action, gen, real=p.step):
      taken.append(carry.env_state.gather(1, action.long()[:, None]))
      return real(carry, action, gen)
    p.step = step
  config = MuZeroConfig(
      search=SearchConfig(num_simulations=4),
      replay=ReplayConfig(capacity=32, min_fill=8),
      train=TrainConfig(num_envs=8, collect_steps=8, batch_size=16,
                        updates_per_iteration=2, unroll_steps=5,
                        n_bootstrap=10, discount=0.999))
  net = make_mlp_networks(4, embedding_dim=8, support_size=30,
                          repr_layers=(16,), pred_layers=(16,),
                          dyn_layers=(16,), device="cpu")
  _, results = fit(pool, net, config, muzero_optimizer(),
                   num_iterations=2, eval_every=1, log_every=1,
                   save_best=False, eval_env=eval_pool, seed=0)
  assert len(results["history"]) == 2
  for row in results["history"]:
    assert np.isfinite(row["loss"]) and row["test_G"] > 0
  taken = torch.cat(taken)
  assert len(taken) > 3 * 8 * 8 and bool((taken == 1).all())
