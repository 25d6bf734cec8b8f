"""The port's pixel path against the JAX package on the CPU: the pixel envs
(``envs/pixel.py``), the observation wrappers (``envs/wrappers.py``), the
frame transforms (``ops/frames.py``) and the augmentations
(``ops/augmentations.py``); and ``fit`` learning PixelCatch through the
EfficientZero triplet, the JAX test's criterion
(``tests/test_pixel.py:104-129``).

The port's envs draw their resets from torch generators, so each
comparison starts the JAX env from the port's reset state and then steps
both with the same seeded actions. The augmentations' applies get the JAX
package's own draws. Tolerance: none (exact equality), except CartPole's
observations (rtol 1e-5 / atol 1e-6, as ``tests/test_torch_envs.py``: f32
physics in other op orders; the appended one-hots exactly), the intensity
jitter (rtol 1e-6) and the diff transform (atol 1e-6: a matrix
product).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muax_tpu.envs.base import AutoResetState as JAutoResetState
from muax_tpu.envs.cartpole import CartPole as JCartPole
from muax_tpu.envs.cartpole import CartPoleState as JCartPoleState
from muax_tpu.envs.catch import CatchState as JCatchState
from muax_tpu.envs.pixel import PixelCatch as JPixelCatch
from muax_tpu.envs.wrappers import ActionHistoryEnv as JActionHistoryEnv
from muax_tpu.envs.wrappers import ActionHistoryState as JActionHistoryState
from muax_tpu.envs.wrappers import FrameStackingEnv as JFrameStackingEnv
from muax_tpu.envs.wrappers import PoolFrameStacking as JPoolFrameStacking
from muax_tpu.envs.wrappers import StackState as JStackState
from muax_tpu.ops import augmentations as j_aug
from muax_tpu.ops import frames as j_frames
from muax_tpu_torch.config import (MuZeroConfig, ReplayConfig, SearchConfig,
                                   TrainConfig)
from muax_tpu_torch.envs import (ActionHistoryEnv, ActionHistoryState,
                                 AutoResetWrapper,
                                 CartPole, Catch, FrameStackingEnv,
                                 PixelCatch, PixelObsEnv, PoolFrameStacking)
from muax_tpu_torch.models import (create_optimizer,
                                   make_efficientzero_networks)
from muax_tpu_torch.ops import (action2plane, diff_transform,
                                diff_transform_matrix, drq_augmentation,
                                scale_intensity, shift_obs)
from muax_tpu_torch.train.fit import fit
from tests.test_torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

B = 8


def _j_catch_state(state):
  """The JAX package's CatchState of the port's."""
  return JCatchState(ball_row=jnp.asarray(state.ball_row.numpy()),
                     ball_col=jnp.asarray(state.ball_col.numpy()),
                     paddle_col=jnp.asarray(state.paddle_col.numpy()))


def _j_pixel_obs(j_env, j_state):
  return jax.vmap(lambda s: j_env._render(j_env.env._obs(s)))(j_state)


def _actions(seed, steps, num_actions=3):
  return np.random.default_rng(seed).integers(0, num_actions, (steps, B))


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_pixel_catch_matches_jax(dtype):
  """test_pixel.py's checks (shape, upsample, dynamics passed through) on a
  board sequence that the JAX env steps alongside."""
  env = PixelCatch(rows=4, columns=3, scale=4, dtype=getattr(torch, dtype))
  j_env = JPixelCatch(rows=4, columns=3, scale=4, dtype=getattr(jnp, dtype))
  assert env.spec.observation_shape == j_env.spec.observation_shape == (
      16, 12, 1)
  assert (env.spec.obs_dtype is None) == (dtype == "float32")
  state, obs = env.reset(torch.Generator().manual_seed(0), B)
  assert obs.dtype == getattr(torch, dtype)
  board = Catch(4, 3).observation(state)
  assert float(obs.float().sum()) == float(board.sum()) * 16
  blocks = obs[..., 0].reshape(B, 4, 4, 3, 4)
  assert bool((blocks == blocks[:, :, :1, :, :1]).all())
  j_state = _j_catch_state(state)
  np.testing.assert_array_equal(obs.numpy(),
                                np.asarray(_j_pixel_obs(j_env, j_state)))
  j_step = jax.jit(jax.vmap(j_env.step))
  for t, action in enumerate(_actions(1, 5)):
    state, obs, reward, done = env.step(state, torch.from_numpy(action))
    j_state, j_obs, j_reward, j_done = j_step(j_state, jnp.asarray(action))
    np.testing.assert_array_equal(obs.numpy(), np.asarray(j_obs),
                                  err_msg=f"step {t}")
    np.testing.assert_array_equal(reward.numpy(), np.asarray(j_reward))
    np.testing.assert_array_equal(done.numpy(), np.asarray(j_done))


def test_pixel_env_rejects_non_2d():
  with pytest.raises(ValueError):
    PixelObsEnv(CartPole())


@pytest.mark.parametrize("stack", [True, False])
def test_frame_stacking_matches_jax(stack):
  env = FrameStackingEnv(PixelCatch(4, 3, scale=2, dtype=torch.uint8), 4,
                         stack=stack)
  j_env = JFrameStackingEnv(JPixelCatch(4, 3, scale=2, dtype=jnp.uint8), 4,
                            stack=stack)
  assert env.spec == j_env.spec._replace(obs_dtype=torch.uint8)
  state, obs = env.reset(torch.Generator().manual_seed(0), B)
  j_inner = _j_catch_state(state.env_state)
  j_frame = _j_pixel_obs(j_env.env, j_inner)
  j_state = JStackState(env_state=j_inner,
                        frames=jnp.repeat(j_frame[:, None], 4, axis=1))
  np.testing.assert_array_equal(obs.numpy(),
                                np.asarray(jax.vmap(j_env._obs)(
                                    j_state.frames)))
  j_step = jax.jit(jax.vmap(j_env.step))
  for t, action in enumerate(_actions(2, 4)):
    state, obs, _, _ = env.step(state, torch.from_numpy(action))
    j_state, j_obs, _, _ = j_step(j_state, jnp.asarray(action))
    np.testing.assert_array_equal(obs.numpy(), np.asarray(j_obs),
                                  err_msg=f"step {t}")


def _cartpole_pair(seed):
  env = CartPole()
  state, _ = env.reset(torch.Generator().manual_seed(seed), B)
  j_state = JCartPoleState(**{k: jnp.asarray(getattr(state, k).numpy())
                              for k in ("x", "x_dot", "theta",
                                        "theta_dot")})
  return state, j_state


@pytest.mark.parametrize("inner", ["cartpole", "pixel"])
def test_action_history_matches_jax(inner):
  """One-hots after a 1-D observation (CartPole), planes a / A after an
  image's channels (uint8 PixelCatch; the planes make the observation
  f32, and the spec drops obs_dtype as the JAX one does)."""
  if inner == "cartpole":
    env, j_env = ActionHistoryEnv(CartPole(), 3), JActionHistoryEnv(
        JCartPole(), 3)
    state, j_inner = _cartpole_pair(0)
    num_actions = 2
  else:
    env = ActionHistoryEnv(PixelCatch(4, 3, scale=2, dtype=torch.uint8), 3)
    j_env = JActionHistoryEnv(JPixelCatch(4, 3, scale=2, dtype=jnp.uint8), 3)
    state, _ = env.env.reset(torch.Generator().manual_seed(0), B)
    j_inner = _j_catch_state(state)
    num_actions = 3
  assert env.spec == j_env.spec and env.spec.obs_dtype is None
  _, obs = env.reset(torch.Generator().manual_seed(0), B)
  assert tuple(obs.shape[1:]) == env.spec.observation_shape
  history = torch.zeros((B, 3), dtype=torch.int32)
  state = ActionHistoryState(env_state=state, history=history)
  j_state = JActionHistoryState(env_state=j_inner,
                                history=jnp.zeros((B, 3), jnp.int32))
  j_step = jax.jit(jax.vmap(j_env.step))
  for t, action in enumerate(_actions(3, 5, num_actions)):
    state, obs, _, _ = env.step(state, torch.from_numpy(action))
    j_state, j_obs, _, _ = j_step(j_state, jnp.asarray(action))
    assert obs.dtype == torch.float32
    np.testing.assert_allclose(obs.numpy(), np.asarray(j_obs), rtol=1e-5,
                               atol=1e-6, err_msg=f"step {t}")
    # The appended actions are exact.
    width = 3 * num_actions if inner == "cartpole" else 3
    np.testing.assert_array_equal(obs.numpy()[..., -width:],
                                  np.asarray(j_obs)[..., -width:])


class _Replay:
  """A batched env (the ``AutoResetWrapper`` interface) that replays the
  port's recorded ``AutoResetWrapper(PixelCatch)`` carries, so the JAX
  package's ``PoolFrameStacking`` sees the same frames and dones."""

  def __init__(self, spec, carries, dones):
    self.spec, self.carries, self.dones, self.t = spec, carries, dones, 0

  def reset(self, rng, batch_size):
    self.t = 0
    return self.carries[0]

  def step(self, carry, action, rng):
    self.t += 1
    return self.carries[self.t], None, self.dones[self.t - 1], {}


def test_pool_frame_stacking_matches_jax():
  """Over an auto-resetting PixelCatch (episodes of 3 steps), the history
  refills with the post-reset frame on done; the same frames and dones go
  through the JAX wrapper."""
  base = AutoResetWrapper(PixelCatch(3, 3, scale=2, dtype=torch.uint8))
  env = PoolFrameStacking(base, num_stack=3)
  assert env.spec.observation_shape == (6, 6, 3)
  assert env.spec.obs_dtype == torch.uint8
  assert env.legal_action_mask(env.reset(torch.Generator(), 2)) is None
  gen = torch.Generator().manual_seed(0)
  carry = env.reset(gen, B)
  records, dones, stacked = [carry.env_state[0]], [], [carry.obs]
  for action in _actions(4, 7):
    carry, _, done, _ = env.step(carry, torch.from_numpy(action), gen)
    records.append(carry.env_state[0])
    dones.append(done)
    stacked.append(carry.obs)
  assert bool(torch.stack(dones).any()), "an episode ended"
  j_records = [JAutoResetState(env_state=None,
                               obs=jnp.asarray(r.obs.numpy()),
                               episode_step=jnp.asarray(
                                   r.episode_step.numpy()),
                               episode_return=jnp.asarray(
                                   r.episode_return.numpy()))
               for r in records]
  j_env = JPoolFrameStacking(
      _Replay(base.spec, j_records, [jnp.asarray(d.numpy()) for d in dones]),
      num_stack=3)
  j_carry = j_env.reset(None, B)
  np.testing.assert_array_equal(stacked[0].numpy(), np.asarray(j_carry.obs))
  for t in range(len(dones)):
    j_carry, _, _, _ = j_env.step(j_carry, None, None)
    np.testing.assert_array_equal(stacked[t + 1].numpy(),
                                  np.asarray(j_carry.obs),
                                  err_msg=f"step {t}")


def test_frame_transforms_match_jax():
  for n in (1, 3, 4):
    np.testing.assert_array_equal(diff_transform_matrix(n).numpy(),
                                  np.asarray(j_frames.diff_transform_matrix(n)))
  x = np.random.default_rng(0).uniform(size=(2, 5, 6, 4)).astype(np.float32)
  np.testing.assert_allclose(diff_transform(torch.from_numpy(x)).numpy(),
                             np.asarray(j_frames.diff_transform(
                                 jnp.asarray(x))), atol=1e-6)
  a = np.array([0, 2, 1], np.int32)
  for num_actions in (None, 3):
    np.testing.assert_array_equal(
        action2plane(torch.from_numpy(a), (4, 5), num_actions).numpy(),
        np.asarray(j_frames.action2plane(jnp.asarray(a), (4, 5),
                                         num_actions)))


@pytest.mark.parametrize("windowed", [False, True])
def test_augmentations_match_jax_draws(windowed):
  """``shift_obs`` and ``scale_intensity`` on the JAX package's own draws
  give ``random_shift``, ``random_intensity`` and ``drq_augmentation``'s
  output; one shift per window, shared across its unroll."""
  shape = (6, 3, 9, 7, 2) if windowed else (6, 9, 7, 2)
  obs = np.random.default_rng(1).uniform(size=shape).astype(np.float32)
  key = jax.random.PRNGKey(5)
  pad = 2
  shift = np.array(jax.random.randint(key, (6, 2), 0, 2 * pad + 1))
  np.testing.assert_array_equal(
      shift_obs(torch.from_numpy(obs), torch.from_numpy(shift), pad).numpy(),
      np.asarray(j_aug.random_shift(key, jnp.asarray(obs), pad)))
  noise = np.clip(np.asarray(jax.random.normal(key, (6,))), -2.0, 2.0)
  np.testing.assert_allclose(
      scale_intensity(torch.from_numpy(obs), torch.from_numpy(noise),
                      0.1).numpy(),
      np.asarray(j_aug.random_intensity(key, jnp.asarray(obs), 0.1)),
      rtol=1e-6)
  k1, k2 = jax.random.split(key)
  drq = scale_intensity(
      shift_obs(torch.from_numpy(obs), torch.from_numpy(np.array(
          jax.random.randint(k1, (6, 2), 0, 2 * pad + 1))), pad),
      torch.from_numpy(np.clip(np.asarray(jax.random.normal(k2, (6,))),
                               -2.0, 2.0)), 0.05)
  np.testing.assert_allclose(
      drq.numpy(), np.asarray(j_aug.drq_augmentation(pad)(
          key, jnp.asarray(obs))), rtol=1e-6)
  out = drq_augmentation(pad)(torch.Generator().manual_seed(0),
                              torch.from_numpy(obs))
  assert out.shape == obs.shape and bool(torch.isfinite(out).all())


def test_pixel_catch_learns():
  """``tests/test_pixel.py``'s learning test through the port: the EZ
  triplet without downsampling (channels 8, 1 block, support 3) on
  2-row PixelCatch (8 x 12 x 1 frames, 96 features, so the generic
  replay path), adam 3e-3; the best greedy evaluation within 40
  iterations scores above 0.3."""
  env = PixelCatch(rows=2, columns=3, scale=4)
  config = MuZeroConfig(
      search=SearchConfig(num_simulations=8, dirichlet_alpha=1.0),
      replay=ReplayConfig(capacity=256, min_fill=16),
      train=TrainConfig(num_envs=16, collect_steps=6, batch_size=32,
                        updates_per_iteration=8, unroll_steps=2,
                        n_bootstrap=3, discount=0.99,
                        temperature_schedule=((0.5, 1.0), (1.0, 0.5))))
  net = make_efficientzero_networks(num_actions=3, support_size=3,
                                    channels=8, num_blocks=1,
                                    downsample=False, device="cpu")
  lines = []
  _, results = fit(env, net, config, create_optimizer("adam", lr=3e-3),
                   num_iterations=40, eval_every=10, log_every=10,
                   save_best=False, log_fn=lines.append, target_reward=0.9)
  assert "sampler=OFF(obs features 96 > 64" in lines[0], lines[0]
  assert "search=OFF(conv network family" in lines[0], lines[0]
  test_gs = [row["test_G"] for row in results["history"] if "test_G" in row]
  assert max(test_gs) > 0.3, f"no learning progress: {test_gs}"
