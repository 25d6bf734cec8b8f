"""The slice as a whole: the port's self-play rollout, MuZero and Gumbel,
against loops built from the JAX package's pieces, on CartPole and, with
legal-action masks, on TicTacToe; and the policy routes, with and without
masks.

The port runs ``make_rollout_fn`` on the CPU (plain search, no Dirichlet
noise, temperature 0). The reference loop, written here, runs JAX
``make_root_fn``, the Pallas ``fused_muzero_search`` in interpret mode, an
argmax over visits and ``CartPole.step`` from the same start states with the
same weights. With 15 simulations over 2 actions the visits cannot tie, so
both pick the same action while their trees agree. After an env's first
done the two reset it from different random streams, so each env is
compared up to and including its first done.

Tolerances: obs atol 1e-5 (a few f32 steps of the same Euler update); root
values and pi as decoded scalars, atol 5e-4 and rtol 1e-4 (see
tests/test_torch_networks.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muax_tpu.envs.cartpole import CartPole as JCartPole
from muax_tpu.envs.cartpole import CartPoleState as JState
from muax_tpu.models import make_mlp_networks as j_make
from muax_tpu.search import fused as jfused
from muax_tpu.train.inference import make_root_fn as j_root
from muax_tpu_torch.config import MuZeroConfig, SearchConfig, TrainConfig
from muax_tpu_torch.envs import AutoResetWrapper, CartPole, CartPoleState
from muax_tpu_torch.envs.base import AutoResetState
from muax_tpu_torch.models import make_mlp_networks, mlp_params_from_numpy
from muax_tpu_torch.search import fused
from muax_tpu_torch.train import make_policy_fn, make_rollout_fn

B, T, SIMS, SUPPORT, DISCOUNT = 8, 6, 15, 20, 0.997
FIELDS = ("x", "x_dot", "theta", "theta_dot")


def _config():
  return MuZeroConfig(
      search=SearchConfig(num_simulations=SIMS, dirichlet_fraction=0.0),
      train=TrainConfig(num_envs=B, collect_steps=T, discount=DISCOUNT))


def _start_states():
  """Small random states, and three envs that end within a few steps: two
  past |x| = 2.4, one past 12 degrees."""
  s = np.random.default_rng(0).uniform(-0.05, 0.05, (4, B)).astype(np.float32)
  s[:, 0] = [2.39, 1.0, 0.0, 0.0]
  s[:, 1] = [-2.37, -1.5, 0.01, 0.0]
  s[:, 2] = [0.0, 0.0, 0.2, 1.0]
  return s


def _reference(j_net, j_params, start):
  """The loop of the JAX pieces; returns [T, B, ...] numpy arrays."""
  root_fn = jax.jit(j_root(j_net))
  weights = jfused.extract_fused_weights(j_net, j_params)
  step = jax.jit(jax.vmap(JCartPole().step))
  state = JState(*(jnp.asarray(v) for v in start))
  obs = jnp.asarray(start.T)
  out = {k: [] for k in ("obs", "action", "reward", "done", "value", "pi")}
  for _ in range(T):
    root = root_fn(j_params, obs)
    probs = jax.nn.softmax(root.prior_logits, -1)
    logits = jnp.log(jnp.maximum(probs, jnp.finfo(probs.dtype).tiny))
    visits, value, _ = jfused.fused_muzero_search(
        root.embedding, logits, root.value, weights, num_simulations=SIMS,
        support_size=SUPPORT, discount=DISCOUNT)
    action = jnp.argmax(visits, -1).astype(jnp.int32)
    out["obs"].append(obs)
    out["action"].append(action)
    out["value"].append(value)
    out["pi"].append(visits / visits.sum(-1, keepdims=True))
    state, obs, reward, done = step(state, action)
    out["reward"].append(reward)
    out["done"].append(done)
  return {k: np.stack([np.asarray(x) for x in v]) for k, v in out.items()}


def test_rollout_matches_jax_loop():
  j_net = j_make(2, embedding_dim=8, support_size=SUPPORT)
  j_params = j_net.init_params(jax.random.PRNGKey(0), jnp.zeros((1, 4)))
  tree = {name: jax.tree.map(np.asarray, getattr(j_params, name))
          for name in ("representation", "prediction", "dynamic")}
  net = make_mlp_networks(2, embedding_dim=8, support_size=SUPPORT,
                          device="cpu")
  params = mlp_params_from_numpy(tree, net)

  start = _start_states()
  state = CartPoleState(*(torch.from_numpy(v.copy()) for v in start))
  carry = AutoResetState(state, CartPole._obs(state),
                         torch.zeros(B, dtype=torch.int32), torch.zeros(B))
  env = AutoResetWrapper(CartPole())
  rollout = make_rollout_fn(net, env, _config(), device="cpu")
  before = fused.launches
  carry, seg, prio, metrics = rollout(params, carry,
                                      torch.Generator().manual_seed(1), 0.0)
  assert fused.launches == before  # the CPU path never reaches the kernel

  assert seg.obs.shape == (B, T, 4) and seg.pi.shape == (B, T, 2)
  for name in ("action", "reward", "done", "rn", "value", "mask"):
    assert getattr(seg, name).shape == (B, T), name
  assert prio.shape == (B, T) and bool(torch.isfinite(prio).all())
  assert seg.action.dtype == torch.int32 and seg.done.dtype == torch.bool

  ref = _reference(j_net, j_params, start)
  done = ref["done"].T  # [B, T]
  assert done[:3].any(axis=1).all() and not done[3:].any()
  assert int(metrics["episodes_finished"]) == int(seg.done.sum())
  for b in range(B):
    n = int(np.argmax(done[b])) + 1 if done[b].any() else T
    np.testing.assert_allclose(seg.obs[b, :n].numpy(), ref["obs"][:n, b],
                               atol=1e-5)
    np.testing.assert_array_equal(seg.action[b, :n].numpy(),
                                  ref["action"][:n, b])
    np.testing.assert_array_equal(seg.reward[b, :n].numpy(),
                                  ref["reward"][:n, b])
    np.testing.assert_array_equal(seg.done[b, :n].numpy(), done[b, :n])
    np.testing.assert_allclose(seg.value[b, :n].numpy(), ref["value"][:n, b],
                               atol=5e-4, rtol=1e-4)
    np.testing.assert_allclose(seg.pi[b, :n].numpy(), ref["pi"][:n, b],
                               atol=1e-6)


def test_entry_points_need_cuda_by_default():
  if torch.cuda.is_available():
    pytest.skip("a CUDA card is present: the default device is valid")
  with pytest.raises(RuntimeError, match="device='cpu'"):
    make_mlp_networks(2)
  net = make_mlp_networks(2, device="cpu")
  with pytest.raises(RuntimeError, match="device='cpu'"):
    make_policy_fn(net, _config(), DISCOUNT)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    make_rollout_fn(net, AutoResetWrapper(CartPole()), _config())


@pytest.mark.parametrize("change,match", [
    (dict(policy="stochastic"), "Stochastic MuZero networks"),
    (dict(policy="stochastic", fused=False), "Stochastic MuZero networks"),
])
def test_unported_branches_raise(change, match):
  """Stochastic MuZero is ported (its routes are held against the JAX
  package in tests/test_torch_smz_*.py); either route refuses a family
  other than its five nets."""
  net = make_mlp_networks(2, device="cpu")
  config = MuZeroConfig(search=SearchConfig(**change))
  with pytest.raises(ValueError, match=match):
    make_policy_fn(net, config, DISCOUNT, device="cpu")


@pytest.mark.parametrize("policy,fused_search", [
    ("gumbel", True), ("gumbel", False), ("muzero", False)])
def test_policy_routes(policy, fused_search, monkeypatch):
  """Gumbel through the fused search, and both policies through the
  generic engine: the fused route reaches the Gumbel plain version (no
  kernel on the CPU), the generic route no fused search at all."""
  net = make_mlp_networks(3, device="cpu")
  params = net.init_params((4,), torch.Generator().manual_seed(0))
  config = MuZeroConfig(search=SearchConfig(
      policy=policy, fused=fused_search, num_simulations=6))
  policy_fn = make_policy_fn(net, config, DISCOUNT, device="cpu")
  calls = []
  for fn in (fused.fused_gumbel_search_reference,
             fused.fused_muzero_search_reference):
    def counted(*args, _fn=fn, **kwargs):
      calls.append(_fn.__name__)
      return _fn(*args, **kwargs)
    monkeypatch.setattr(fused, fn.__name__, counted)
  obs = torch.randn(5, 4, generator=torch.Generator().manual_seed(1))
  action, pi, value = policy_fn(params, torch.Generator().manual_seed(2),
                                obs, 1.0)
  assert calls == (["fused_gumbel_search_reference"] if fused_search
                   else [])
  assert action.shape == (5,) and action.dtype == torch.int32
  assert bool(((action >= 0) & (action < 3)).all())
  torch.testing.assert_close(pi.sum(-1), torch.ones(5))
  assert value.shape == (5,) and bool(torch.isfinite(value).all())


def _gumbel_reference(j_net, j_params, start, noise):
  """The Gumbel loop of the JAX pieces with the noise of each step given:
  the Pallas ``fused_gumbel_search``, then the action and weights of
  ``fused_mlp_gumbel_policy`` (muax_tpu/search/fused.py:923-930)."""
  root_fn = jax.jit(j_root(j_net))
  weights = jfused.extract_fused_weights(j_net, j_params)
  step = jax.jit(jax.vmap(JCartPole().step))
  state = JState(*(jnp.asarray(v) for v in start))
  obs = jnp.asarray(start.T)
  out = {k: [] for k in ("obs", "action", "reward", "done", "value", "pi")}
  for t in range(T):
    root = root_fn(j_params, obs)
    g = jnp.asarray(noise[t])
    visits, value, cq = jfused.fused_gumbel_search(
        root.embedding, root.prior_logits, root.value, weights, gumbel=g,
        max_num_considered_actions=16, num_simulations=SIMS,
        support_size=SUPPORT, discount=DISCOUNT)
    score = jnp.where(visits == visits.max(-1, keepdims=True),
                      g + root.prior_logits + cq, -jnp.inf)
    action = jnp.argmax(score, -1).astype(jnp.int32)
    out["obs"].append(obs)
    out["action"].append(action)
    out["value"].append(value)
    out["pi"].append(jax.nn.softmax(root.prior_logits + cq, -1))
    state, obs, reward, done = step(state, action)
    out["reward"].append(reward)
    out["done"].append(done)
  return {k: np.stack([np.asarray(x) for x in v]) for k, v in out.items()}


def test_gumbel_rollout_matches_jax_loop(monkeypatch):
  """``make_rollout_fn`` with ``policy="gumbel"`` on the CPU against the
  JAX loop, the same Gumbel noise injected at every step. Weights within
  rtol 1e-4 / atol 1e-5 as ``tests/test_fused.py:196-202``."""
  j_net = j_make(2, embedding_dim=8, support_size=SUPPORT)
  j_params = j_net.init_params(jax.random.PRNGKey(0), jnp.zeros((1, 4)))
  tree = {name: jax.tree.map(np.asarray, getattr(j_params, name))
          for name in ("representation", "prediction", "dynamic")}
  net = make_mlp_networks(2, embedding_dim=8, support_size=SUPPORT,
                          device="cpu")
  params = mlp_params_from_numpy(tree, net)
  noise = np.random.default_rng(4).gumbel(size=(T, B, 2)).astype(np.float32)
  steps = iter(noise)
  monkeypatch.setattr(fused, "gumbel_noise", lambda generator, shape,
                      device: torch.from_numpy(next(steps)))

  start = _start_states()
  state = CartPoleState(*(torch.from_numpy(v.copy()) for v in start))
  carry = AutoResetState(state, CartPole._obs(state),
                         torch.zeros(B, dtype=torch.int32), torch.zeros(B))
  config = MuZeroConfig(
      search=SearchConfig(policy="gumbel", num_simulations=SIMS),
      train=TrainConfig(num_envs=B, collect_steps=T, discount=DISCOUNT))
  rollout = make_rollout_fn(net, AutoResetWrapper(CartPole()), config,
                            device="cpu")
  before = (fused.launches, fused.gumbel_launches)
  carry, seg, prio, _ = rollout(params, carry,
                                torch.Generator().manual_seed(1), 1.0)
  assert (fused.launches, fused.gumbel_launches) == before
  assert prio.shape == (B, T) and bool(torch.isfinite(prio).all())

  ref = _gumbel_reference(j_net, j_params, start, noise)
  done = ref["done"].T  # [B, T]
  assert done[:3].any(axis=1).all()
  for b in range(B):
    n = int(np.argmax(done[b])) + 1 if done[b].any() else T
    np.testing.assert_allclose(seg.obs[b, :n].numpy(), ref["obs"][:n, b],
                               atol=1e-5)
    np.testing.assert_array_equal(seg.action[b, :n].numpy(),
                                  ref["action"][:n, b])
    np.testing.assert_array_equal(seg.done[b, :n].numpy(), done[b, :n])
    np.testing.assert_allclose(seg.value[b, :n].numpy(), ref["value"][:n, b],
                               atol=5e-4, rtol=1e-4)
    np.testing.assert_allclose(seg.pi[b, :n].numpy(), ref["pi"][:n, b],
                               rtol=1e-4, atol=1e-5)




# ---- legal-action masks: TicTacToe (A = 9) --------------------------------

TTT_B, TTT_T, TTT_SIMS = 6, 10, 16


def _ttt_reference(j_net, j_params, policy, actions, noise):
  """The JAX loop on TicTacToe with the mask of each step: the Pallas
  search in interpret mode, no root noise, and for MuZero the port's
  actions (visit ties may break either way at temperature 0), for Gumbel
  its own action from the given noise. Games that end restart from the
  empty board, as the port's auto-reset does."""
  from muax_tpu.envs.tictactoe import TicTacToe as JTicTacToe
  from muax_tpu.search.policies import _mask_invalid as j_mask
  game = JTicTacToe()
  root_fn = jax.jit(j_root(j_net))
  weights = jfused.extract_fused_weights(j_net, j_params)
  step = jax.jit(jax.vmap(game.step))
  legal_fn = jax.jit(jax.vmap(game.legal_actions))
  obs_fn = jax.jit(jax.vmap(game.observation))
  reset = jax.vmap(game.reset)(jax.random.split(jax.random.PRNGKey(0),
                                                TTT_B))[0]
  state = reset
  out = {k: [] for k in ("obs", "legal", "visits", "action", "reward",
                         "done", "value", "pi")}
  for t in range(TTT_T):
    obs = obs_fn(state)
    legal = legal_fn(state)
    invalid = 1.0 - legal
    root = root_fn(j_params, obs.reshape(TTT_B, -1))
    if policy == "muzero":
      probs = jax.nn.softmax(root.prior_logits, -1)
      logits = j_mask(jnp.log(jnp.maximum(probs, jnp.finfo(
          probs.dtype).tiny)), invalid)
      visits, value, _ = jfused.fused_muzero_search(
          root.embedding, logits, root.value, weights,
          num_simulations=TTT_SIMS, support_size=SUPPORT, discount=DISCOUNT,
          invalid_actions=invalid)
      action = jnp.asarray(actions[t])
      pi = visits / visits.sum(-1, keepdims=True)
    else:
      g = jnp.asarray(noise[t])
      masked = j_mask(root.prior_logits, invalid)
      visits, value, cq = jfused.fused_gumbel_search(
          root.embedding, masked, root.value, weights, gumbel=g,
          max_num_considered_actions=16, num_simulations=TTT_SIMS,
          support_size=SUPPORT, discount=DISCOUNT, invalid_actions=invalid)
      score = jnp.where(visits == visits.max(-1, keepdims=True),
                        g + masked + cq, -jnp.inf)
      action = jnp.argmax(j_mask(score, invalid), -1).astype(jnp.int32)
      pi = jax.nn.softmax(j_mask(masked + cq, invalid), -1)
    for k, v in (("obs", obs), ("legal", legal), ("visits", visits),
                 ("action", action), ("value", value), ("pi", pi)):
      out[k].append(v)
    state, _, reward, done = step(state, action)
    out["reward"].append(reward)
    out["done"].append(done)
    state = jax.tree.map(lambda f, c: jnp.where(
        done.reshape((-1,) + (1,) * (c.ndim - 1)), f, c), reset, state)
  return {k: np.stack([np.asarray(x) for x in v]) for k, v in out.items()}


@pytest.mark.parametrize("policy", ["muzero", "gumbel"])
def test_masked_rollout_matches_jax_loop(policy, monkeypatch):
  """``make_rollout_fn`` on TicTacToe, which reads the legal mask of the
  current states before every step, against the JAX loop over 10 steps (a
  game lasts at most 9, and TicTacToe resets to the empty board on both
  sides). Every action is legal and no visit or weight lands on an
  illegal one; MuZero's action is one of the JAX kernel's most-visited,
  Gumbel's is the JAX policy's. Tolerances as above: visits within 2 (pi
  within 2 / sims), root values atol 5e-4 / rtol 1e-4; the Gumbel weights,
  softmax(logits + completed q) over 9 actions, rtol 2e-3 / atol 1e-5, what
  the completed q's rtol = atol = 1e-3 (``tests/test_fused.py:196-202``)
  allows them."""
  from muax_tpu_torch.envs import TicTacToe
  j_net = j_make(9, embedding_dim=8, support_size=SUPPORT)
  j_params = j_net.init_params(jax.random.PRNGKey(0), jnp.zeros((1, 18)))
  tree = {name: jax.tree.map(np.asarray, getattr(j_params, name))
          for name in ("representation", "prediction", "dynamic")}
  net = make_mlp_networks(9, embedding_dim=8, support_size=SUPPORT,
                          device="cpu")
  params = mlp_params_from_numpy(tree, net)
  noise = np.random.default_rng(6).gumbel(
      size=(TTT_T, TTT_B, 9)).astype(np.float32)
  steps = iter(noise)
  monkeypatch.setattr(fused, "gumbel_noise", lambda generator, shape,
                      device: torch.from_numpy(next(steps)))
  config = MuZeroConfig(
      search=SearchConfig(policy=policy, num_simulations=TTT_SIMS,
                          dirichlet_fraction=0.0),
      train=TrainConfig(num_envs=TTT_B, collect_steps=TTT_T,
                        discount=DISCOUNT))
  env = AutoResetWrapper(TicTacToe())
  rollout = make_rollout_fn(net, env, config, device="cpu")
  gen = torch.Generator().manual_seed(1)
  _, seg, prio, metrics = rollout(params, env.reset(gen, TTT_B), gen, 0.0)
  assert bool(torch.isfinite(prio).all())

  action = seg.action.numpy().T          # [T, B]
  ref = _ttt_reference(j_net, j_params, policy, action, noise)
  legal = ref["legal"]                   # [T, B, 9]
  np.testing.assert_array_equal(seg.obs.numpy().transpose(1, 0, 2, 3, 4),
                                ref["obs"])
  assert np.take_along_axis(legal, action[..., None], -1).all(), (
      "an illegal action was taken")
  pi = seg.pi.numpy().transpose(1, 0, 2)
  assert np.all(pi[legal == 0] == 0.0), "weight on an illegal action"
  np.testing.assert_array_equal(seg.reward.numpy().T, ref["reward"])
  np.testing.assert_array_equal(seg.done.numpy().T, ref["done"])
  assert ref["done"].any(axis=0).all()   # every env finished a game
  np.testing.assert_allclose(seg.value.numpy().T, ref["value"], atol=5e-4,
                             rtol=1e-4)
  if policy == "muzero":
    visits = ref["visits"]
    most = np.take_along_axis(visits, action[..., None], -1)[..., 0]
    np.testing.assert_array_equal(most, visits.max(-1))
    np.testing.assert_allclose(pi, ref["pi"], atol=2.0 / TTT_SIMS + 1e-6)
  else:
    np.testing.assert_array_equal(action, ref["action"])
    np.testing.assert_allclose(pi, ref["pi"], rtol=2e-3, atol=1e-5)


@pytest.mark.parametrize("route", [
    dict(policy="muzero"), dict(policy="gumbel"),
    dict(policy="muzero", fused=False), dict(policy="gumbel", fused=False),
    dict(policy="muzero", family="categorical"),
    dict(policy="stochastic"), dict(policy="stochastic", fused=False)])
def test_masked_policy_routes(route):
  """``make_policy_fn(...)(..., invalid_actions)`` through every route: the
  fused search (MLP and categorical), the generic engine, Stochastic
  MuZero's fused forest and generic engine. No route gives weight to, or
  takes, an invalid action; a row with one valid action takes it."""
  from muax_tpu_torch.models import (make_categorical_mlp_networks,
                                     make_stochastic_mlp_networks)
  route = dict(route)
  family = route.pop("family", "mlp")
  A = 5
  if route["policy"] == "stochastic":
    net = make_stochastic_mlp_networks(A, num_chance_outcomes=3,
                                       embedding_dim=6, support_size=5,
                                       hidden=(8,), device="cpu")
  elif family == "categorical":
    net = make_categorical_mlp_networks(A, embedding_dim=8,
                                        layer_sizes=(16,), num_bins=11,
                                        device="cpu")
  else:
    net = make_mlp_networks(A, device="cpu")
  params = net.init_params((4,), torch.Generator().manual_seed(0))
  config = MuZeroConfig(search=SearchConfig(num_simulations=12, **route))
  policy_fn = make_policy_fn(net, config, DISCOUNT, device="cpu")
  gen = torch.Generator().manual_seed(2)
  obs = torch.randn(8, 4, generator=gen)
  invalid = (torch.rand(8, A, generator=gen) < 0.5).float()
  invalid[:, 0] = 0.0
  invalid[0] = torch.tensor([0.0, 1.0, 1.0, 1.0, 1.0])
  action, pi, value = policy_fn(params, gen, obs, 1.0, invalid)
  assert not bool(invalid[torch.arange(8), action.long()].any())
  assert float(pi[invalid > 0].abs().max()) == 0.0
  torch.testing.assert_close(pi.sum(-1), torch.ones(8))
  assert int(action[0]) == 0 and bool(torch.isfinite(value).all())
