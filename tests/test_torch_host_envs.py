"""The port's host environments against the JAX package's, on the CPU:
the gym pool over CartPole-v1 and the native 2048 pool step for step with
the same seeded actions (exact equality), the Atari preprocessing on the
synthetic frames of ``tests/test_atari.py``, the AlphaZero planes and the
open_spiel pool on the fake game of ``tests/test_open_spiel_adapter.py``
(also under the port's ``make_rollout_fn``), the three optional
dependencies' gates, and the registry's names, suffixes and errors. The
JAX pools run eagerly (their ``io_callback`` outside ``jit``); the port's
pools lie on the CPU (``device="cpu"``).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muax_tpu.envs import atari as jatari
from muax_tpu.envs import open_spiel_adapter as jspiel
from muax_tpu.envs import registry as jregistry
from muax_tpu_torch.config import (MuZeroConfig, ReplayConfig, SearchConfig,
                                   TrainConfig)
from muax_tpu_torch.envs import (CartPole, Catch, ConnectFour, PixelCatch,
                                 TicTacToe, atari, native2048,
                                 open_spiel_adapter, registry)
from muax_tpu_torch.envs.gym_adapter import GymVectorPool
from muax_tpu_torch.models import make_mlp_networks
from muax_tpu_torch.train.actor import make_rollout_fn
from tests.test_atari import FakeAtariEnv
from tests.test_open_spiel_adapter import FakeGame


def _assert_step(t, port, ref, names):
  for name, a, b in zip(names, port, ref):
    np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                  err_msg=f"{name}, step {t}")


def _assert_carry(t, carry, j_carry):
  _assert_step(t, (carry.obs, carry.episode_step, carry.episode_return),
               (j_carry.obs, j_carry.episode_step, j_carry.episode_return),
               ("obs", "episode_step", "episode_return"))


# ---- the gym pool ----------------------------------------------------------

def test_gym_pool_matches_jax_through_resets():
  pytest.importorskip("gymnasium")
  from muax_tpu.envs.gym_adapter import GymVectorPool as JGymVectorPool
  j_pool = JGymVectorPool("CartPole-v1", num_envs=3, seed=0)
  pool = GymVectorPool("CartPole-v1", num_envs=3, seed=0, device="cpu")
  assert pool.spec == (j_pool.spec.observation_shape,
                       j_pool.spec.num_actions,
                       j_pool.spec.max_episode_steps, None)
  gen = torch.Generator()
  j_carry = j_pool.reset(jax.random.PRNGKey(0), 3)
  carry = pool.reset(gen, 3)
  _assert_carry(-1, carry, j_carry)
  assert pool.legal_action_mask(carry) is None
  actions = np.random.default_rng(0).integers(0, 2, (200, 3))
  dones = 0
  for t, action in enumerate(actions):
    j_carry, j_reward, j_done, j_info = j_pool.step(
        j_carry, jnp.asarray(action, jnp.int32), jax.random.PRNGKey(t))
    carry, reward, done, info = pool.step(
        carry, torch.from_numpy(action.astype(np.int32)), gen)
    _assert_step(t, (reward, done, info["episode_return"]),
                 (j_reward, j_done, j_info["episode_return"]),
                 ("reward", "done", "episode_return"))
    _assert_carry(t, carry, j_carry)
    assert carry.obs.dtype == torch.float32 and done.dtype == torch.bool
    dones += int(done.sum())
  assert dones >= 3  # random CartPole episodes end within 200 steps


# ---- the native 2048 pool --------------------------------------------------

def _snapshot(path):
  return {name: os.stat(os.path.join(path, name)).st_mtime_ns
          for name in sorted(os.listdir(path))}


def test_native_2048_matches_jax_bit_for_bit(tmp_path, monkeypatch):
  from muax_tpu.envs.native2048 import Native2048Pool as JNative2048Pool
  j_pool = JNative2048Pool(num_envs=8, seed=3)
  # The port builds its own library (here into a fresh directory) and
  # leaves native/ as it was: the same files, the same mtimes.
  native_dir = os.path.dirname(native2048.SOURCE)
  before = _snapshot(native_dir)
  monkeypatch.setattr(native2048, "BUILD_DIR", tmp_path / "native")
  monkeypatch.setattr(native2048, "_lib", None)
  pool = native2048.Native2048Pool(num_envs=8, seed=3, device="cpu")
  assert _snapshot(native_dir) == before
  assert [p.name for p in (tmp_path / "native").iterdir()] == [
      native2048.library_path().name]
  gen = torch.Generator()
  j_carry = j_pool.reset(jax.random.PRNGKey(0), 8)
  carry = pool.reset(gen, 8)
  _assert_carry(-1, carry, j_carry)
  np.testing.assert_array_equal(pool.legal_action_mask(carry).numpy(),
                                np.asarray(j_carry.env_state))
  rng = np.random.default_rng(1)
  dones = 0
  for t in range(300):
    mask = pool.legal_action_mask(carry).numpy()
    action = np.array([rng.choice(np.flatnonzero(m)) if m.any() else 0
                       for m in mask], np.int32)
    j_carry, j_reward, j_done, j_info = j_pool.step(
        j_carry, jnp.asarray(action), jax.random.PRNGKey(t))
    carry, reward, done, info = pool.step(carry, torch.from_numpy(action),
                                          gen)
    _assert_step(t, (reward, done, info["legal_mask"], carry.env_state),
                 (j_reward, j_done, j_info["legal_mask"], j_carry.env_state),
                 ("reward", "done", "legal_mask", "env_state"))
    _assert_carry(t, carry, j_carry)
    dones += int(done.sum())
  assert dones > 0  # boards of random legal moves fill within 300 moves
  assert _snapshot(native_dir) == before


def test_native_2048_rejects_another_batch():
  pool = native2048.Native2048Pool(num_envs=2, seed=0, device="cpu")
  with pytest.raises(ValueError, match="batch_size"):
    pool.reset(torch.Generator(), 3)


# ---- Atari preprocessing ---------------------------------------------------

@pytest.mark.parametrize("kwargs,fake,actions,lives_lost_at", [
    # Frames, the two-frame max-pool and reward sums over the skip.
    (dict(frame_skip=4, screen_size=8, terminal_on_life_loss=False), {},
     [0, 1, 2, 3, 0], None),
    # A life lost at step 2 ends the agent's episode; the next reset goes
    # on with a no-op step.
    (dict(frame_skip=1, terminal_on_life_loss=True), dict(lives=3),
     [0, 0, 0, 1], 2),
    # Sticky actions, seeded.
    (dict(frame_skip=1, repeat_action_probability=0.5, seed=3,
          terminal_on_life_loss=False), {}, [3, 1, 2, 0, 3, 1, 2, 2], None),
    # The step cap, and an episode that ends inside the skip.
    (dict(frame_skip=4, max_episode_steps=8, terminal_on_life_loss=False),
     dict(terminate_at=6), [0, 0, 0], None),
    (dict(frame_skip=4, screen_size=84), dict(terminate_at=5), [0, 0, 0],
     None),
])
def test_atari_preprocessing_matches_jax(kwargs, fake, actions,
                                         lives_lost_at):
  j_fake, p_fake = FakeAtariEnv(**fake), FakeAtariEnv(**fake)
  j_env = jatari.AtariPreprocessing(j_fake, **kwargs)
  env = atari.AtariPreprocessing(p_fake, **kwargs)
  np.testing.assert_array_equal(env.reset()[0], j_env.reset()[0])
  for t, action in enumerate(actions):
    if t == lives_lost_at:
      j_fake.lives -= 1
      p_fake.lives -= 1
    out, ref = env.step(action), j_env.step(action)
    np.testing.assert_array_equal(out[0], ref[0], err_msg=f"obs, step {t}")
    assert out[1:4] == ref[1:4], t  # reward, done, truncated
    if out[2] or out[3]:
      np.testing.assert_array_equal(env.reset()[0], j_env.reset()[0])
  assert p_fake.actions_taken == j_fake.actions_taken
  assert p_fake.t == j_fake.t


def test_atari_preprocessing_without_cv2(monkeypatch):
  monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 raises
  obs, _ = atari.AtariPreprocessing(FakeAtariEnv(), frame_skip=2,
                                    screen_size=84).reset()
  ref, _ = jatari.AtariPreprocessing(FakeAtariEnv(), frame_skip=2,
                                     screen_size=84).reset()
  assert obs.shape == (84, 84, 1)
  np.testing.assert_array_equal(obs, ref)


# ---- open_spiel ------------------------------------------------------------

def test_alphazero_planes_match_jax():
  rng = np.random.default_rng(0)
  planes = open_spiel_adapter.AlphaZeroPlanes(2, 3, history_size=3)
  j_planes = jspiel.AlphaZeroPlanes(2, 3, history_size=3)
  for _ in range(5):
    tensor = rng.integers(0, 2, (4, 2, 3)).astype(np.float32).ravel()
    np.testing.assert_array_equal(planes.observe(tensor),
                                  j_planes.observe(tensor))
  with pytest.raises(ValueError, match="ambiguous"):
    open_spiel_adapter.AlphaZeroPlanes._default_extract(
        np.zeros((3, 3, 3), np.float32), 3, 3)


def test_open_spiel_pool_matches_jax():
  pool = open_spiel_adapter.OpenSpielVectorPool._from_game(
      FakeGame(), 4, seed=0, history_size=2, rows=1, cols=3, device="cpu")
  j_pool = jspiel.OpenSpielVectorPool._from_game(
      FakeGame(), 4, seed=0, history_size=2, rows=1, cols=3)
  gen = torch.Generator()
  carry = pool.reset(gen, 4)
  j_carry = j_pool.reset(jax.random.PRNGKey(0), 4)
  _assert_carry(-1, carry, j_carry)
  rng = np.random.default_rng(2)
  for t in range(12):
    mask = pool.legal_action_mask(carry)
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(j_pool.legal_action_mask(j_carry)))
    action = np.array([rng.choice(np.flatnonzero(m)) for m in mask.numpy()],
                      np.int32)
    j_carry, j_reward, j_done, _ = j_pool.step(
        j_carry, jnp.asarray(action), jax.random.PRNGKey(t))
    carry, reward, done, _ = pool.step(carry, torch.from_numpy(action), gen)
    _assert_step(t, (reward, done), (j_reward, j_done), ("reward", "done"))
    _assert_carry(t, carry, j_carry)


def test_open_spiel_pool_composes_with_rollout():
  pool = open_spiel_adapter.OpenSpielVectorPool._from_game(
      FakeGame(), 4, seed=0, history_size=2, rows=1, cols=3, device="cpu")
  config = MuZeroConfig(
      search=SearchConfig(num_simulations=2),
      replay=ReplayConfig(capacity=16),
      train=TrainConfig(num_envs=4, collect_steps=6, batch_size=4,
                        unroll_steps=2, n_bootstrap=2, discount=-1.0))
  net = make_mlp_networks(3, embedding_dim=4, support_size=5, device="cpu")
  params = net.init_params((1, 3, 5), torch.Generator().manual_seed(0))
  rollout = make_rollout_fn(net, pool, config, device="cpu")
  gen = torch.Generator().manual_seed(1)
  carry, segments, priorities, metrics = rollout(
      params, pool.reset(gen, 4), gen, 1.0)
  assert segments.obs.shape == (4, 6, 1, 3, 5)
  assert int(metrics["episodes_finished"]) > 0  # 3-move games end soon
  # Every action was legal where it was taken: no cell is claimed twice.
  assert bool(torch.isfinite(priorities).all())


# ---- the optional dependencies' gates ---------------------------------------

def test_gates_raise_without_their_packages(monkeypatch):
  for name in ("gymnasium", "ale_py", "pyspiel"):
    monkeypatch.setitem(sys.modules, name, None)  # import raises
  with pytest.raises(ImportError):
    GymVectorPool("CartPole-v1", num_envs=1, device="cpu")
  with pytest.raises(ImportError, match="ale_py"):
    atari.AtariVectorPool("Pong", num_envs=2, device="cpu")
  with pytest.raises(ImportError, match="open_spiel"):
    open_spiel_adapter.OpenSpielVectorPool("go", num_envs=1, device="cpu")


def test_pools_raise_without_cuda_unless_on_the_cpu():
  if torch.cuda.is_available():
    pytest.skip("a CUDA card is present")
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    native2048.Native2048Pool(num_envs=2)
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    GymVectorPool("CartPole-v1", num_envs=1)


# ---- the registry ----------------------------------------------------------

def test_registry_names_suffixes_and_errors():
  assert registry.registered() == jregistry.registered()
  for env_id, kind in (("CartPole-v1", CartPole), ("cartpole", CartPole),
                       ("Catch-v0", Catch), ("PixelCatch", PixelCatch),
                       ("TicTacToe-v3", TicTacToe),
                       ("ConnectFour", ConnectFour),
                       ("connect4-v5", ConnectFour)):
    assert type(registry.make(env_id)) is kind, env_id
  with pytest.raises(ValueError, match="num_envs"):
    registry.make("LunarLander-v3")
  pytest.importorskip("gymnasium")
  pool = registry.make("LunarLander-v3", num_envs=2, seed=5, device="cpu")
  assert isinstance(pool, GymVectorPool) and pool.device.type == "cpu"
  assert pool.spec.observation_shape == (8,) and pool.spec.num_actions == 4
  registry.register("MyCatch", lambda: Catch(2, 3))
  try:
    assert registry.make("mycatch-v1").spec.observation_shape == (2, 3)
  finally:
    registry._REGISTRY.pop("mycatch")
