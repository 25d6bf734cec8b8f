"""The port's Sampled MuZero against the JAX package's, on the CPU.

* The JAX file's six behavioural cases (``tests/test_sampled.py``) run on
  the port, with its own assertions.
* ``sampled_muzero_policy`` against JAX on a small MLP recurrent function
  (the same numpy weights on both sides) with deterministic candidate grids
  and state-dependent slot log-probabilities, without root noise: slot
  visits within 2 and root values at rtol = atol = 1e-3
  (``tests/test_fused.py:56-60``: the engines break ties with 1e-7 noise
  from their own streams); the chosen actions are the root grid's.
* The pure halves of both proposals (``factored_bin_actions``,
  ``gaussian_actions``) against the JAX sample functions on the JAX draws
  (the same bins and eps): actions exactly equal, log-probabilities rtol
  1e-6.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muax_tpu import search as jmx
from muax_tpu_torch.search import (ContinuousRecurrentFnOutput, RootFnOutput,
                                   make_factored_bin_sample_fn,
                                   make_gaussian_sample_fn,
                                   sampled_muzero_policy)
from muax_tpu_torch.search.sampled_policy import (factored_bin_actions,
                                                  factored_bin_draw,
                                                  gaussian_actions,
                                                  gaussian_draw)
from tests.test_torch_parity import one_thread  # noqa: F401

# Many small CPU ops: one intra-op thread under the suite's workers.
pytestmark = pytest.mark.usefixtures("one_thread")


def _gen(seed):
  return torch.Generator().manual_seed(seed)


# ---- the JAX file's cases on the port --------------------------------------

def test_continuous_bandit_finds_best_action():
  """reward = -(a - 0.7)^2 with discount 0: the policy commits to the
  candidate closest to 0.7."""
  B, K = 4, 8
  grid = torch.linspace(-1.0, 1.0, K)  # closest to 0.7: grid[6] ~ 0.714

  def sample_fn(params, generator, state):
    return grid[None, :, None].expand(state.shape[0], K, 1), None

  def recurrent_fn(params, generator, action, state):
    reward = -torch.square(action[:, 0] - 0.7)
    return ContinuousRecurrentFnOutput(
        reward=reward, discount=torch.zeros_like(reward),
        value=torch.zeros_like(reward)), state

  root = RootFnOutput(prior_logits=torch.zeros(B, K), value=torch.zeros(B),
                      embedding=torch.zeros(B, 2))
  out = sampled_muzero_policy((), _gen(0), root, sample_fn=sample_fn,
                              recurrent_fn=recurrent_fn, num_simulations=192,
                              num_samples=K, dirichlet_fraction=0.0,
                              temperature=0.0)
  np.testing.assert_allclose(out.action[:, 0].numpy(), float(grid[6]),
                             rtol=1e-5)
  assert out.action_weights.shape == (B, K)
  assert out.sampled_actions.shape == (B, K, 1)
  assert out.action_slot.dtype == torch.int32


def test_delayed_reward_needs_lookahead():
  """Slot 1 pays 1 now; slot 0 pays nothing now but 10 one step later
  (0.9-discounted: 9 > 1). Only a deeper search prefers slot 0."""
  B, K = 2, 2
  grid = torch.tensor([0.0, 1.0])

  def sample_fn(params, generator, state):
    return grid[None, :, None].expand(state.shape[0], K, 1), None

  def recurrent_fn(params, generator, action, state):
    entered_delayed = state[:, 0]
    reward = torch.where(entered_delayed > 0.5, 10.0,
                         torch.where(action[:, 0] > 0.5, 1.0, 0.0))
    out = ContinuousRecurrentFnOutput(
        reward=reward,
        discount=torch.where(entered_delayed > 0.5, 0.0, 0.9),
        value=torch.zeros_like(reward))
    next_state = torch.where(action[:, 0:1] < 0.5, torch.ones_like(state),
                             torch.zeros_like(state))
    return out, next_state

  root = RootFnOutput(prior_logits=torch.zeros(B, K), value=torch.zeros(B),
                      embedding=torch.zeros(B, 1))
  out = sampled_muzero_policy((), _gen(0), root, sample_fn=sample_fn,
                              recurrent_fn=recurrent_fn, num_simulations=64,
                              num_samples=K, max_depth=2,
                              dirichlet_fraction=0.0, temperature=0.0)
  np.testing.assert_allclose(out.action[:, 0].numpy(), 0.0, atol=1e-6)


def test_factored_bin_centers_and_log_probs():
  D, BINS, K = 3, 4, 16
  low = torch.tensor([-1.0, 0.0, 2.0])
  high = torch.tensor([1.0, 4.0, 3.0])

  def dim_logits_fn(params, state):
    logits = torch.full((state.shape[0], D, BINS), -10.0)
    logits[:, :, 2] = 10.0  # strongly favour bin 2 in every dimension
    return logits

  sample_fn = make_factored_bin_sample_fn(dim_logits_fn, low, high, BINS, K)
  actions, log_probs = sample_fn((), _gen(0), torch.zeros(5, 7))
  assert actions.shape == (5, K, D) and log_probs.shape == (5, K)
  expected = (low + 2.5 * (high - low) / BINS).expand(5, K, D)
  np.testing.assert_allclose(actions.numpy(), expected.numpy(), rtol=1e-5)
  assert bool((log_probs > -1e-2).all())


def test_factored_bins_in_range():
  sample_fn = make_factored_bin_sample_fn(
      lambda p, s: torch.zeros(s.shape[0], 2, 8),
      low=torch.tensor([-2.0, 0.0]), high=torch.tensor([2.0, 1.0]),
      num_bins=8, num_samples=32)
  actions, _ = sample_fn((), _gen(1), torch.zeros(3, 4))
  a = actions.numpy()
  assert a[..., 0].min() >= -2.0 and a[..., 0].max() <= 2.0
  assert a[..., 1].min() >= 0.0 and a[..., 1].max() <= 1.0


def test_gaussian_shapes_and_clipping():
  def gparams(params, state):
    mu = torch.zeros(state.shape[0], 2)
    return mu, torch.zeros_like(mu)  # std = 1

  sample_fn = make_gaussian_sample_fn(gparams, num_samples=64, low=-0.5,
                                      high=0.5)
  actions, log_probs = sample_fn((), _gen(0), torch.zeros(4, 3))
  assert actions.shape == (4, 64, 2) and log_probs.shape == (4, 64)
  assert float(actions.abs().max()) <= 0.5


def test_end_to_end_with_gaussian():
  """Gaussian proposal with a uniform empirical prior and a quadratic
  reward: the search commits to the best sampled candidate in every row."""
  B, K = 8, 4

  def gparams(params, state):
    return torch.zeros(state.shape[0], 1), torch.zeros(state.shape[0], 1)

  gaussian = make_gaussian_sample_fn(gparams, num_samples=K)

  def sample_fn(params, generator, state):
    actions, _ = gaussian(params, generator, state)
    return actions, None

  def recurrent_fn(params, generator, action, state):
    reward = -torch.square(action[:, 0] - 1.0)
    return ContinuousRecurrentFnOutput(
        reward=reward, discount=torch.zeros_like(reward),
        value=torch.zeros_like(reward)), state

  root = RootFnOutput(prior_logits=torch.zeros(B, K), value=torch.zeros(B),
                      embedding=torch.zeros(B, 1))
  out = sampled_muzero_policy((), _gen(3), root, sample_fn=sample_fn,
                              recurrent_fn=recurrent_fn, num_simulations=64,
                              num_samples=K, dirichlet_fraction=0.0,
                              temperature=0.0)
  best_slot = torch.argmin((out.sampled_actions[..., 0] - 1.0).abs(), 1)
  np.testing.assert_array_equal(out.action_slot.numpy(), best_slot.numpy())


# ---- the policy against JAX -------------------------------------------------

E, D, K, H = 6, 2, 4, 16


def _mlp_weights(seed=0):
  rng = np.random.default_rng(seed)
  f = lambda *shape, scale=1.0: (rng.standard_normal(shape)
                                 * scale).astype(np.float32)
  return dict(w1=f(E + D, H, scale=0.5), b1=f(H, scale=0.1),
              w2=f(H, E, scale=0.5), wr=f(E, scale=0.7), wv=f(E, scale=0.7),
              wp=f(E, K), grid=f(K, D))


def _jax_side(w):
  w = {k: jnp.asarray(v) for k, v in w.items()}

  def sample_fn(params, rng, state):
    actions = jnp.broadcast_to(w["grid"][None], (state.shape[0], K, D))
    return actions, jnp.tanh(state @ w["wp"])

  def recurrent_fn(params, rng, action, state):
    h = jnp.tanh(jnp.concatenate([state, action], -1) @ w["w1"] + w["b1"])
    nxt = jnp.tanh(h @ w["w2"])
    return jmx.ContinuousRecurrentFnOutput(
        reward=nxt @ w["wr"], discount=jnp.full((state.shape[0],), 0.9),
        value=nxt @ w["wv"]), nxt

  return sample_fn, recurrent_fn


def _torch_side(w):
  w = {k: torch.from_numpy(v) for k, v in w.items()}

  def sample_fn(params, generator, state):
    actions = w["grid"][None].expand(state.shape[0], K, D)
    return actions, torch.tanh(state @ w["wp"])

  def recurrent_fn(params, generator, action, state):
    h = torch.tanh(torch.cat([state, action], -1) @ w["w1"] + w["b1"])
    nxt = torch.tanh(h @ w["w2"])
    return ContinuousRecurrentFnOutput(
        reward=nxt @ w["wr"], discount=torch.full((state.shape[0],), 0.9),
        value=nxt @ w["wv"]), nxt

  return sample_fn, recurrent_fn


@pytest.mark.parametrize("sims,max_depth", [(16, None), (12, 2)])
def test_policy_matches_jax_on_an_mlp_model(sims, max_depth):
  w = _mlp_weights()
  B = 4
  rng = np.random.default_rng(1)
  state = rng.standard_normal((B, E)).astype(np.float32)
  value = rng.standard_normal(B).astype(np.float32)
  kw = dict(num_simulations=sims, num_samples=K, max_depth=max_depth,
            dirichlet_fraction=0.0)
  j_sample, j_recurrent = _jax_side(w)
  j_root = jmx.RootFnOutput(prior_logits=jnp.zeros((B, K)),
                            value=jnp.asarray(value),
                            embedding=jnp.asarray(state))
  ref = jax.jit(functools.partial(
      jmx.sampled_muzero_policy, sample_fn=j_sample,
      recurrent_fn=j_recurrent, **kw))((), jax.random.PRNGKey(0), j_root)
  sample, recurrent = _torch_side(w)
  root = RootFnOutput(prior_logits=torch.zeros(B, K),
                      value=torch.from_numpy(value),
                      embedding=torch.from_numpy(state))
  out = sampled_muzero_policy((), _gen(0), root, sample_fn=sample,
                              recurrent_fn=recurrent, **kw)
  ref_summary = ref.search_tree.summary()
  summary = out.search_tree.summary()
  visits = summary.visit_counts.numpy()
  assert np.abs(visits - np.asarray(ref_summary.visit_counts)).max() <= 2
  np.testing.assert_array_equal(visits.sum(-1), sims)
  np.testing.assert_allclose(summary.value.numpy(),
                             np.asarray(ref_summary.value), rtol=1e-3,
                             atol=1e-3)
  np.testing.assert_array_equal(out.sampled_actions.numpy(),
                                np.asarray(ref.sampled_actions))
  np.testing.assert_array_equal(
      out.action.numpy(), w["grid"][out.action_slot.numpy().astype(int)])
  # The tree stores each node's K candidates: [B, N, K, D].
  assert out.search_tree.embeddings.candidate_actions.shape == (
      B, sims + 1, K, D)


# ---- the proposals' pure halves against JAX --------------------------------

def test_factored_bin_actions_match_jax_on_the_same_bins():
  B, Dm, BINS, KK = 5, 3, 6, 7
  rng = np.random.default_rng(2)
  logits = rng.standard_normal((B, Dm, BINS)).astype(np.float32)
  low = np.asarray([-1.0, 0.0, 2.0], np.float32)
  high = np.asarray([1.0, 4.0, 3.0], np.float32)
  key = jax.random.PRNGKey(4)
  j_fn = jmx.make_factored_bin_sample_fn(lambda p, s: jnp.asarray(logits),
                                         low, high, BINS, KK)
  ref_actions, ref_logp = j_fn((), key, jnp.zeros((B, 1)))
  bins = jax.random.categorical(key, jnp.asarray(logits)[:, None], axis=-1,
                                shape=(B, KK, Dm))
  actions, logp = factored_bin_actions(torch.from_numpy(logits),
                                       torch.from_numpy(np.array(bins)),
                                       low, high, BINS)
  np.testing.assert_array_equal(actions.numpy(), np.asarray(ref_actions))
  np.testing.assert_allclose(logp.numpy(), np.asarray(ref_logp), rtol=1e-6)
  # The port's own draw: [B, K, D] bins in range, by the same pure half.
  drawn = factored_bin_draw(_gen(0), torch.from_numpy(logits), KK)
  assert drawn.shape == (B, KK, Dm)
  assert int(drawn.min()) >= 0 and int(drawn.max()) < BINS


@pytest.mark.parametrize("clip", [None, (-0.5, 0.8)])
def test_gaussian_actions_match_jax_on_the_same_eps(clip):
  B, Dm, KK = 4, 3, 5
  rng = np.random.default_rng(3)
  mu = rng.standard_normal((B, Dm)).astype(np.float32)
  log_std = (rng.standard_normal((B, Dm)) * 0.3).astype(np.float32)
  low, high = clip if clip is not None else (None, None)
  key = jax.random.PRNGKey(5)
  j_fn = jmx.make_gaussian_sample_fn(
      lambda p, s: (jnp.asarray(mu), jnp.asarray(log_std)), KK, low, high)
  ref_actions, ref_logp = j_fn((), key, jnp.zeros((B, 1)))
  eps = jax.random.normal(key, (B, KK, Dm), jnp.float32)
  actions, logp = gaussian_actions(torch.from_numpy(mu),
                                   torch.from_numpy(log_std),
                                   torch.from_numpy(np.array(eps)), low, high)
  np.testing.assert_allclose(actions.numpy(), np.asarray(ref_actions),
                             rtol=1e-6, atol=0)
  np.testing.assert_allclose(logp.numpy(), np.asarray(ref_logp), rtol=1e-6)
  assert gaussian_draw(_gen(0), torch.from_numpy(mu), KK).shape == (B, KK,
                                                                    Dm)
