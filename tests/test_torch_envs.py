"""The port's CartPole and AutoResetWrapper against the JAX package, stepped
from the same states with the same actions (atol 1e-6 on a single f32 step;
multi-step trajectories may drift by a few ulps per step)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muax_tpu.envs import AutoResetWrapper as JAutoReset
from muax_tpu.envs import CartPole as JCartPole
from muax_tpu.envs.base import AutoResetState as JCarry
from muax_tpu.envs.cartpole import CartPoleState as JState
from muax_tpu_torch.envs import AutoResetWrapper, CartPole, CartPoleState
from muax_tpu_torch.envs.base import AutoResetState

FIELDS = ("x", "x_dot", "theta", "theta_dot")


def _states(seed, batch, scale):
  vals = (np.random.default_rng(seed).uniform(-1, 1, (4, batch)) * np.asarray(
      scale, np.float32)[:, None]).astype(np.float32)
  port = CartPoleState(*(torch.from_numpy(v.copy()) for v in vals))
  ref = JState(*(jnp.asarray(v) for v in vals))
  return port, ref


def _close(port, ref, atol=1e-6):
  np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol,
                             rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cartpole_single_step(seed):
  # Wide states so that some envs terminate on x and some on theta.
  port_s, ref_s = _states(seed, 256, [2.5, 2.0, 0.25, 2.0])
  actions = np.random.default_rng(seed + 10).integers(0, 2, 256)
  port_s2, port_obs, port_r, port_d = CartPole().step(
      port_s, torch.from_numpy(actions))
  ref_s2, ref_obs, ref_r, ref_d = jax.vmap(JCartPole().step)(
      ref_s, jnp.asarray(actions, jnp.int32))
  for f in FIELDS:
    _close(getattr(port_s2, f), getattr(ref_s2, f))
  _close(port_obs, ref_obs)
  _close(port_r, ref_r)
  assert port_d.any() and not port_d.all()
  np.testing.assert_array_equal(port_d.numpy(), np.asarray(ref_d))


def test_cartpole_trajectory():
  port_s, ref_s = _states(3, 64, [0.05] * 4)
  rng = np.random.default_rng(4)
  for _ in range(30):
    a = rng.integers(0, 2, 64)
    port_s, port_obs, _, port_d = CartPole().step(port_s, torch.from_numpy(a))
    ref_s, ref_obs, _, ref_d = jax.vmap(JCartPole().step)(
        ref_s, jnp.asarray(a, jnp.int32))
    _close(port_obs, ref_obs, atol=1e-5)
    np.testing.assert_array_equal(port_d.numpy(), np.asarray(ref_d))


def test_cartpole_reset_range():
  state, obs = CartPole().reset(torch.Generator().manual_seed(0), 1000)
  assert obs.shape == (1000, 4) and obs.dtype == torch.float32
  assert float(obs.abs().max()) <= 0.05
  torch.testing.assert_close(obs[:, 2], state.theta)


@pytest.mark.parametrize("start_step", [0, 497])
def test_auto_reset_wrapper(start_step):
  """Same carry, same actions: reward, done, terminated, truncated and the
  episode return agree, obs agree where no reset happened, and done envs
  restart with a fresh obs, step 0 and return 0. From step 497 every env
  not terminated before is truncated at the 500-step limit."""
  batch = 128
  port_s, ref_s = _states(5, batch, [2.3, 1.0, 0.2, 1.0])
  port_env = AutoResetWrapper(CartPole())
  ref_env = JAutoReset(JCartPole())
  ret0 = np.random.default_rng(6).uniform(0, 100, batch).astype(np.float32)
  step0 = np.full(batch, start_step, np.int32)
  port_c = AutoResetState(port_s, CartPole._obs(port_s),
                          torch.from_numpy(step0.copy()),
                          torch.from_numpy(ret0.copy()))
  ref_c = JCarry(ref_s, JCartPole._obs(ref_s), jnp.asarray(step0),
                 jnp.asarray(ret0))
  gen = torch.Generator().manual_seed(7)
  rng = np.random.default_rng(8)
  ever_truncated = False
  for t in range(4):
    a = rng.integers(0, 2, batch)
    port_c, port_r, port_d, port_i = port_env.step(
        port_c, torch.from_numpy(a), gen)
    ref_c, ref_r, ref_d, ref_i = ref_env.step(
        ref_c, jnp.asarray(a, jnp.int32), jax.random.PRNGKey(t))
    _close(port_r, ref_r)
    done = np.array(ref_d)
    np.testing.assert_array_equal(port_d.numpy(), done)
    for key in ("terminated", "truncated"):
      np.testing.assert_array_equal(port_i[key].numpy(),
                                    np.asarray(ref_i[key]))
    _close(port_i["episode_return"], ref_i["episode_return"])
    ever_truncated |= bool(port_i["truncated"].any())
    keep = ~done
    _close(port_c.obs.numpy()[keep], np.asarray(ref_c.obs)[keep])
    np.testing.assert_array_equal(port_c.episode_step.numpy(),
                                  np.asarray(ref_c.episode_step))
    _close(port_c.episode_return, ref_c.episode_return)
    if done.any():
      assert float(port_c.obs[torch.from_numpy(done)].abs().max()) <= 0.05
    # Stepping on from different resets would compare different episodes:
    # give the JAX side the port's fresh starts.
    ref_c = JCarry(JState(*(jnp.asarray(getattr(port_c.env_state, f).numpy())
                            for f in FIELDS)),
                   jnp.asarray(port_c.obs.numpy()), ref_c.episode_step,
                   ref_c.episode_return)
  assert ever_truncated == (start_step > 0)
