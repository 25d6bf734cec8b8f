"""The port's AlphaZero path (``models/az_networks.py``,
``train/selfplay.py``) against the JAX package's, and the behaviour that
``tests/test_selfplay.py`` checks.

Both AZ nets get the JAX package's weights through ``az_params_from_numpy``
(haiku's HWIO conv kernels become OIHW, NHWC planes run as NCHW) and the
same seeded observations: outputs within rtol 1e-5 / atol 1e-5. ``az_loss``
and its gradients on the same windows: the loss rtol 1e-5, every gradient
leaf rtol 1e-4 / atol 1e-6 (f32 convolutions summed in other orders). One
``make_az_update_fn`` step with the same sampled windows and adam: the
parameters and refreshed priorities rtol 1e-4 / atol 1e-6. The AZ policy,
with the same Dirichlet noise injected on both sides, through the generic
engines (whose PUCT ties break by 1e-7 noise): visits within 2 of the JAX
engine's and root values rtol = atol = 1e-3, as the search parity tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import muax_tpu.search.policies as j_policies
import muax_tpu.train.selfplay as j_selfplay
from muax_tpu.envs.connect4 import ConnectFour as JConnectFour
from muax_tpu.envs.tictactoe import TicTacToe as JTicTacToe
from muax_tpu.models.az_networks import make_az_mlp as j_az_mlp
from muax_tpu.models.az_networks import make_az_resnet as j_az_resnet
from muax_tpu.replay.buffer import replay_sample as j_replay_sample
from muax_tpu.types import Transition as JTransition
from muax_tpu_torch.envs import ConnectFour, TicTacToe
from muax_tpu_torch.envs.board import BoardState
from muax_tpu_torch.models import make_az_mlp, make_az_resnet
from muax_tpu_torch.models.convert import (az_grads_to_numpy,
                                           az_params_from_numpy)
from muax_tpu_torch.models.optimizers import create_optimizer
from muax_tpu_torch.replay import replay_add, replay_init
from muax_tpu_torch.search import policies
from muax_tpu_torch.train import selfplay
from muax_tpu_torch.train.selfplay import (AZConfig, az_loss,
                                           evaluate_vs_random,
                                           make_az_policy_fn,
                                           make_az_selfplay_fn,
                                           make_az_update_fn)
from muax_tpu_torch.types import Transition
from tests.test_torch_parity import FIELDS, jax_ring, ring_numpy, torch_ring

C4_SHAPE, TTT_SHAPE = (6, 7, 2), (3, 3, 2)


def _az(kind, seed=0):
  """JAX network and params, the port's from the same numbers, and the
  observation shape."""
  if kind == "resnet":
    j_net, shape = j_az_resnet(7, channels=8, num_blocks=2), C4_SHAPE
    net = make_az_resnet(7, channels=8, num_blocks=2, device="cpu")
  else:
    j_net, shape = j_az_mlp(9, hidden=(32, 16)), TTT_SHAPE
    net = make_az_mlp(9, hidden=(32, 16), device="cpu")
  j_params = j_net.init_params(jax.random.PRNGKey(seed),
                               jnp.zeros((1,) + shape))
  tree = jax.tree.map(np.asarray, j_params.network)
  return j_net, j_params, net, az_params_from_numpy(tree, net, shape), shape


def _planes(seed, batch, shape):
  return (np.random.default_rng(seed).uniform(size=(batch,) + shape)
          < 0.3).astype(np.float32)


@pytest.mark.parametrize("kind", ["mlp", "resnet"])
def test_az_networks_match_jax(kind):
  j_net, j_params, net, params, shape = _az(kind)
  obs = _planes(1, 16, shape)
  j_logits, j_value = j_net.apply(j_params, jnp.asarray(obs))
  with torch.no_grad():
    logits, value = net.apply(params, torch.from_numpy(obs))
  np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                             rtol=1e-5, atol=1e-5)
  np.testing.assert_allclose(value.numpy(), np.asarray(j_value), rtol=1e-5,
                             atol=1e-5)
  # Back through the flat buffer to haiku's names and layouts.
  from muax_tpu_torch.models.optimizers import flat_parameters
  back = az_grads_to_numpy(params, flat_parameters(params))
  for module, leaves in jax.tree.map(np.asarray, j_params.network).items():
    for leaf, ref in leaves.items():
      np.testing.assert_array_equal(back[module][leaf], ref,
                                    err_msg=f"{module}/{leaf}")


def _windows(seed, batch, shape, num_actions):
  """[B, 1] windows as numpy arrays (field -> array)."""
  rng = np.random.default_rng(seed)
  return dict(
      obs=_planes(seed, batch, shape)[:, None],
      action=rng.integers(0, num_actions, (batch, 1)).astype(np.int32),
      reward=rng.uniform(-1, 1, (batch, 1)).astype(np.float32),
      done=np.zeros((batch, 1), bool),
      rn=rng.uniform(-1, 1, (batch, 1)).astype(np.float32),
      value=np.zeros((batch, 1), np.float32),
      pi=rng.dirichlet(np.ones(num_actions), (batch, 1)).astype(np.float32),
      weight=(rng.uniform(size=batch) + 0.5).astype(np.float32),
      mask=np.ones((batch, 1), np.float32))


@pytest.mark.parametrize("kind", ["mlp", "resnet"])
def test_az_loss_and_grads_match_jax(kind):
  j_net, j_params, net, params, shape = _az(kind)
  arrays = _windows(2, 24, shape, 7 if kind == "resnet" else 9)
  j_batch = JTransition(**{k: jnp.asarray(v) for k, v in arrays.items()})
  (j_total, j_metrics), j_grads = jax.value_and_grad(
      j_selfplay.az_loss, has_aux=True)(j_params, j_batch, j_net, 1e-3)
  batch = Transition(**{k: torch.from_numpy(v) for k, v in arrays.items()})
  total, metrics = az_loss(params, batch, net, 1e-3)
  grads = torch.autograd.grad(total, list(params.parameters()))
  np.testing.assert_allclose(total.item(), float(j_total), rtol=1e-5)
  for name in ("policy_loss", "value_loss"):
    np.testing.assert_allclose(metrics[name].item(), float(j_metrics[name]),
                               rtol=1e-5)
  np.testing.assert_allclose(metrics["priorities"].numpy(),
                             np.asarray(j_metrics["priorities"]), rtol=1e-5,
                             atol=1e-6)
  port = az_grads_to_numpy(params, torch.cat([g.reshape(-1) for g in grads]))
  for module, leaves in jax.tree.map(np.asarray, j_grads.network).items():
    for leaf, ref in leaves.items():
      np.testing.assert_allclose(port[module][leaf], ref, rtol=1e-4,
                                 atol=1e-6, err_msg=f"{module}/{leaf}")


def test_az_update_step_matches_jax(monkeypatch):
  """One update: the same windows (drawn once by the JAX sampler and handed
  to both sides), adam at 1e-3 on each side, the priorities refreshed in
  the ring."""
  j_net, j_params, net, params, shape = _az("mlp")
  obs_dim = int(np.prod(shape))
  segs, prios = ring_numpy(3, C=16, L=6, O=obs_dim, A=9, filled=12)
  j_state = jax_ring(segs, prios, 16, 6, obs_dim, 9)
  state = torch_ring(j_state)
  config = AZConfig(batch_size=8)
  j_batch, j_seg, j_starts = j_replay_sample(j_state, jax.random.PRNGKey(4),
                                             8, 1)
  monkeypatch.setattr(j_selfplay, "replay_sample",
                      lambda *a, **k: (j_batch, j_seg, j_starts))
  batch = Transition(**{k: torch.from_numpy(np.array(getattr(j_batch, k)))
                        for k in FIELDS})
  drawn = (batch, torch.from_numpy(np.array(j_seg)).long(),
           torch.from_numpy(np.array(j_starts)).long())
  monkeypatch.setattr(selfplay, "replay_sample", lambda *a, **k: drawn)

  j_opt = optax.adam(1e-3)
  j_new, _, j_ring, j_metrics = jax.jit(j_selfplay.make_az_update_fn(
      j_net, j_opt, config))(j_params, j_opt.init(j_params), j_state,
                             jax.random.PRNGKey(5))
  opt = create_optimizer("adam", lr=1e-3)
  params, _, state, metrics = make_az_update_fn(net, opt, config)(
      params, opt.init(params), state, torch.Generator().manual_seed(0))
  np.testing.assert_allclose(float(metrics["loss"]), float(j_metrics["loss"]),
                             rtol=1e-5)
  from muax_tpu_torch.models.optimizers import flat_parameters
  port = az_grads_to_numpy(params, flat_parameters(params))
  for module, leaves in jax.tree.map(np.asarray, j_new.network).items():
    for leaf, ref in leaves.items():
      np.testing.assert_allclose(port[module][leaf], ref, rtol=1e-4,
                                 atol=1e-6, err_msg=f"{module}/{leaf}")
  np.testing.assert_allclose(state.step_priorities.numpy(),
                             np.asarray(j_ring.step_priorities), rtol=1e-4,
                             atol=1e-6)


def _positions(j_game, game, batch, seed):
  """``batch`` Connect Four positions after six seeded legal moves, on both
  sides; every third game fills column 3 (no win: the stones alternate),
  which is then illegal."""
  rng = np.random.default_rng(seed)
  j_state, _ = jax.vmap(j_game.reset)(jax.random.split(
      jax.random.PRNGKey(0), batch))
  state, _ = game.reset(torch.Generator().manual_seed(0), batch)
  j_step = jax.jit(jax.vmap(j_game.step))
  for _ in range(6):
    legal = np.asarray(game.legal_actions(state))
    action = np.array([rng.choice(np.flatnonzero(row)) for row in legal],
                      np.int32)
    action = np.where(np.arange(batch) % 3 == 0, 3, action).astype(np.int32)
    j_state, *_ = j_step(j_state, jnp.asarray(action))
    state, *_ = game.step(state, torch.from_numpy(action))
  np.testing.assert_array_equal(state.board.numpy(),
                                np.asarray(j_state.board))
  return j_state, BoardState(state.board, state.to_play, state.done)


@pytest.mark.parametrize("search_policy", [None, "puct"])
def test_az_policy_matches_jax(search_policy, monkeypatch):
  """``make_az_policy_fn`` on Connect Four positions (the resnet), with the
  same Dirichlet noise on both sides for MuZero's PUCT, and with the zoo's
  puct over raw Q values at every depth (no noise). The zoo's log-based
  rules (pucb, ucb, ltr) tie every child of a node on its first visit,
  log(1) = 0, and break the ties at random on each side, so their visits
  are not comparable."""
  j_net, j_params, net, params, _ = _az("resnet")
  B, sims = 12, 24
  j_state, state = _positions(JConnectFour(), ConnectFour(), B, 6)
  noise = np.random.default_rng(7).dirichlet(np.full(7, 0.3), B).astype(
      np.float32)
  monkeypatch.setattr(j_policies, "_add_dirichlet_noise",
                      lambda rng, probs, *, fraction, alpha:
                      (1.0 - fraction) * probs + fraction * noise)
  monkeypatch.setattr(policies, "_add_dirichlet_noise",
                      lambda generator, probs, *, fraction, alpha:
                      (1.0 - fraction) * probs
                      + fraction * torch.from_numpy(noise))
  j_policy = j_selfplay.make_az_policy_fn(JConnectFour(), j_net, sims,
                                          search_policy=search_policy)
  _, j_pi, j_value = jax.jit(j_policy)(j_params, jax.random.PRNGKey(1),
                                       j_state, 1.0)
  policy = make_az_policy_fn(ConnectFour(), net, sims,
                             search_policy=search_policy)
  action, pi, value = policy(params, torch.Generator().manual_seed(1), state,
                             1.0)
  legal = ConnectFour().legal_actions(state)
  assert bool((legal[::3, 3] == 0).all()) and not bool(state.done.any())
  assert not bool((legal[torch.arange(B), action.long()] == 0).any())
  assert float(pi[legal == 0].abs().max()) == 0.0
  visits = np.rint(pi.numpy() * sims)
  np.testing.assert_allclose(visits.sum(-1), sims)
  assert np.abs(visits - np.rint(np.asarray(j_pi) * sims)).max() <= 2
  np.testing.assert_allclose(value.numpy(), np.asarray(j_value), rtol=1e-3,
                             atol=1e-3)


# ---- tests/test_selfplay.py's checks on the port ---------------------------

def _ttt_after(moves, copies=4):
  game = TicTacToe()
  state, _ = game.reset(torch.Generator(), copies)
  for a in moves:
    state, *_ = game.step(state, torch.full((copies,), a, dtype=torch.int32))
  return game, state


@pytest.mark.parametrize("moves,sims,expect_positive", [
    ([0, 8, 1, 7], 64, True),   # X to move takes the win at 2
    ([0, 8, 1], 128, False)])   # O to move blocks at 2
def test_search_takes_win_and_blocks_loss(moves, sims, expect_positive):
  """The two-player backup (discount -1, terminals end their subtree):
  the search finds the immediate win, and the block of the opponent's."""
  game, state = _ttt_after(moves)
  net = make_az_mlp(9, hidden=(32,), device="cpu")
  params = net.init_params(TTT_SHAPE, torch.Generator().manual_seed(0))
  policy = make_az_policy_fn(game, net, num_simulations=sims,
                             dirichlet_fraction=0.0)
  action, _, value = policy(params, torch.Generator().manual_seed(1), state,
                            0.0)
  np.testing.assert_array_equal(action.numpy(), 2)
  if expect_positive:
    assert bool((value > 0.3).all())


def test_selfplay_update_and_evaluation():
  game = TicTacToe()
  net = make_az_mlp(9, hidden=(32,), device="cpu")
  params = net.init_params(TTT_SHAPE, torch.Generator().manual_seed(0))
  config = AZConfig(num_simulations=8, num_envs=8, collect_steps=10,
                    batch_size=16, replay_capacity=64)
  gen = torch.Generator().manual_seed(2)
  state, _ = game.reset(gen, 8)
  state, segments, priorities, metrics = make_az_selfplay_fn(
      game, net, config)(params, state, gen, 1.0)
  assert segments.obs.shape == (8, 10, 3, 3, 2)
  assert int(metrics["episodes_finished"]) > 0
  # z_t = r_t - z_{t+1}: before a terminal, the targets alternate in sign.
  z, done = segments.rn.numpy(), segments.done.numpy()
  b, t = np.argwhere(done[:, 1:])[0]
  np.testing.assert_allclose(z[b, t], segments.reward[b, t].item()
                             - z[b, t + 1], atol=1e-6)
  replay = replay_init(64, 10, TTT_SHAPE, 9, device="cpu")
  replay_add(replay, segments, priorities)
  opt = create_optimizer("adam", lr=1e-3)
  before = [p.detach().clone() for p in params.parameters()]
  params, _, replay, m = make_az_update_fn(net, opt, config)(
      params, opt.init(params), replay, gen)
  assert np.isfinite(float(m["loss"]))
  assert max(float((p.detach() - b).abs().max())
             for p, b in zip(params.parameters(), before)) > 0
  score = evaluate_vs_random(game, net, params, gen, num_games=8,
                             num_simulations=4)
  assert -1.0 <= score <= 1.0
