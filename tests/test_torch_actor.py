"""The slice as a whole: the port's self-play rollout, MuZero and Gumbel,
against loops built from the JAX package's pieces, and the policy routes.

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


def test_legal_action_masks_raise():
  net = make_mlp_networks(2, device="cpu")
  params = net.init_params((4,), torch.Generator().manual_seed(0))
  policy = make_policy_fn(net, _config(), DISCOUNT, device="cpu")
  with pytest.raises(NotImplementedError, match="A.7"):
    policy(params, torch.Generator(), torch.zeros(3, 4), 1.0,
           invalid_actions=torch.zeros(3, 2))
