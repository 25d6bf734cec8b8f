"""The port's Catch, TicTacToe and Connect Four against the JAX package's,
bit for bit: from the same start states, the same seeded action sequences
give the same observations, rewards, dones and legal-action masks at every
step. The actions are mostly legal (drawn from the JAX side's mask) and
sometimes any action, so illegal moves and moves in finished games, which
lose at once, are covered too. Tolerance: none (exact equality).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muax_tpu.envs.catch import Catch as JCatch
from muax_tpu.envs.catch import CatchState as JCatchState
from muax_tpu.envs.connect4 import ConnectFour as JConnectFour
from muax_tpu.envs.tictactoe import TicTacToe as JTicTacToe
from muax_tpu_torch.envs import (AutoResetWrapper, CartPole, Catch,
                                 CatchState, ConnectFour, TicTacToe)

B = 32


def _run(j_env, env, j_state, state, steps, seed, legal_share=0.9):
  """Steps both envs with the same actions and compares every output."""
  rng = np.random.default_rng(seed)
  j_step = jax.jit(jax.vmap(j_env.step))
  j_legal = (jax.jit(jax.vmap(j_env.legal_actions))
             if hasattr(j_env, "legal_actions") else None)
  A = j_env.spec.num_actions
  for t in range(steps):
    action = rng.integers(0, A, B)
    if j_legal is not None:
      legal = np.asarray(j_legal(j_state))
      np.testing.assert_array_equal(env.legal_actions(state).numpy(), legal,
                                    err_msg=f"legal, step {t}")
      for b in range(B):
        if legal[b].any() and rng.uniform() < legal_share:
          action[b] = rng.choice(np.flatnonzero(legal[b]))
    j_state, j_obs, j_reward, j_done = j_step(j_state,
                                              jnp.asarray(action, jnp.int32))
    state, obs, reward, done = env.step(
        state, torch.from_numpy(action.astype(np.int32)))
    np.testing.assert_array_equal(obs.numpy(), np.asarray(j_obs),
                                  err_msg=f"obs, step {t}")
    np.testing.assert_array_equal(reward.numpy(), np.asarray(j_reward),
                                  err_msg=f"reward, step {t}")
    np.testing.assert_array_equal(done.numpy(), np.asarray(j_done),
                                  err_msg=f"done, step {t}")
    assert obs.dtype == torch.float32 and reward.dtype == torch.float32
  return j_state, state


@pytest.mark.parametrize("rows,columns", [(10, 5), (2, 3)])
def test_catch_matches_jax(rows, columns):
  j_env, env = JCatch(rows, columns), Catch(rows, columns)
  ball = np.random.default_rng(0).integers(0, columns, B).astype(np.int32)
  j_state = JCatchState(ball_row=jnp.zeros(B, jnp.int32),
                        ball_col=jnp.asarray(ball),
                        paddle_col=jnp.full(B, columns // 2, jnp.int32))
  state = CatchState(ball_row=torch.zeros(B, dtype=torch.int32),
                     ball_col=torch.from_numpy(ball),
                     paddle_col=torch.full((B,), columns // 2,
                                           dtype=torch.int32))
  np.testing.assert_array_equal(
      env.observation(state).numpy(),
      np.asarray(jax.vmap(j_env._obs)(j_state)))
  _run(j_env, env, j_state, state, rows + 2, seed=1)
  assert env.spec == j_env.spec[:3] + (None,)


@pytest.mark.parametrize("games", ["tictactoe", "connect4"])
def test_board_game_matches_jax(games):
  j_env, env = ((JTicTacToe(), TicTacToe()) if games == "tictactoe"
                else (JConnectFour(), ConnectFour()))
  j_state, j_obs = jax.vmap(j_env.reset)(
      jax.random.split(jax.random.PRNGKey(0), B))
  state, obs = env.reset(torch.Generator().manual_seed(0), B)
  np.testing.assert_array_equal(obs.numpy(), np.asarray(j_obs))
  steps = env.spec.max_episode_steps + 3
  j_state, state = _run(j_env, env, j_state, state, steps, seed=2)
  np.testing.assert_array_equal(state.board.numpy(),
                                np.asarray(j_state.board))
  np.testing.assert_array_equal(state.to_play.numpy(),
                                np.asarray(j_state.to_play))
  assert state.done.all()  # every game ended within the steps
  # A game of only legal moves lasts: some end in a win, none illegal.
  j_state, _ = jax.vmap(j_env.reset)(jax.random.split(
      jax.random.PRNGKey(1), B))
  state, _ = env.reset(torch.Generator().manual_seed(1), B)
  _run(j_env, env, j_state, state, steps, seed=3, legal_share=1.0)


def test_auto_reset_legal_action_mask():
  """The wrapper's mask is the env's ``legal_actions`` of the current
  states, or None without one."""
  gen = torch.Generator().manual_seed(0)
  env = AutoResetWrapper(ConnectFour())
  carry = env.reset(gen, 4)
  torch.testing.assert_close(env.legal_action_mask(carry), torch.ones(4, 7))
  for _ in range(6):  # fill column 0 in every game
    carry, _, done, _ = env.step(carry, torch.zeros(4, dtype=torch.int32),
                                 gen)
  assert not done.any()
  mask = env.legal_action_mask(carry)
  assert mask[:, 0].eq(0).all() and mask[:, 1:].eq(1).all()
  assert AutoResetWrapper(CartPole()).legal_action_mask(
      AutoResetWrapper(CartPole()).reset(gen, 2)) is None
