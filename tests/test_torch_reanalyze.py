"""The port's reanalyze (``muax_tpu_torch/train/reanalyze.py``) against the
JAX package's (``muax_tpu/train/reanalyze.py``), and the three cases of
``tests/test_reanalyze.py``.

Both sides get the same ring (a seeded JAX ring converted to the port's),
the same weights and the same stalest-first draws: the port takes the
uniforms that the JAX function draws from its key. On the CPU the JAX
actor would search with the XLA engine; the reference here routes the JAX
function's ``make_policy_fn`` to the JAX package's fused searches (the
Pallas kernels in interpret mode), which the port's fused route mirrors,
with the Gumbel noise injected on both sides. Tolerances are those of the
search parity tests: visits within 2 of the JAX kernel's (pi within
2 / sims), root values rtol = atol = 1e-3 (``tests/test_fused.py:54-60``),
the Gumbel weights rtol 1e-4 / atol 1e-5 (``tests/test_fused.py:196-202``);
the recomputed returns and priorities agree with the JAX package's
``segment_n_step_returns`` over the port's own values within 1e-5, and
slots not drawn stay bit for bit as they were.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import muax_tpu.train.reanalyze as j_reanalyze_module
from muax_tpu.config import MuZeroConfig as JConfig
from muax_tpu.config import ReplayConfig as JReplayConfig
from muax_tpu.config import SearchConfig as JSearchConfig
from muax_tpu.config import TrainConfig as JTrainConfig
from muax_tpu.ops import segment_n_step_returns as j_returns
from muax_tpu.replay.buffer import replay_add as j_replay_add
from muax_tpu.replay.buffer import replay_init as j_replay_init
from muax_tpu.search import fused as jfused
from muax_tpu.train.inference import make_root_fn as j_root
from muax_tpu.train.inference import make_smz_fns as j_smz_fns
from muax_tpu_torch.config import (MuZeroConfig, ReplayConfig, SearchConfig,
                                   TrainConfig)
from muax_tpu_torch.models import make_mlp_networks
from muax_tpu_torch.replay import replay_add, replay_init
from muax_tpu_torch.search import fused
from muax_tpu_torch.train.reanalyze import make_reanalyze_fn, stalest_first
from muax_tpu_torch.types import Transition
from tests.test_torch_parity import jax_batch, nets, ring_numpy, torch_ring
from tests.test_torch_smz_networks import smz_nets

C, L, K, SIMS, DISCOUNT = 16, 6, 5, 8, 0.97
STEP = 7
# A key whose K draws over the ring hit K different segments: which of two
# duplicate draws a scatter keeps is unspecified on either side.
KEY = 4


def _configs(policy, num_actions):
  kw = dict(num_envs=4, collect_steps=L, batch_size=4, unroll_steps=2,
            n_bootstrap=3, discount=DISCOUNT)
  search = dict(policy=policy, num_simulations=SIMS)
  return (JConfig(search=JSearchConfig(**search),
                  replay=JReplayConfig(capacity=C),
                  train=JTrainConfig(**kw)),
          MuZeroConfig(search=SearchConfig(**search),
                       replay=ReplayConfig(capacity=C),
                       train=TrainConfig(**kw)))


def _fused_policy_factory(policy, gumbel):
  """make_policy_fn for the JAX reanalyze: the JAX fused searches, no root
  noise, the given Gumbel noise."""

  def make(networks, config, discount, eval_mode=False):
    assert eval_mode

    def policy_fn(params, rng, obs, temperature, invalid_actions=None):
      if policy == "stochastic":
        root = j_smz_fns(networks, discount)[0](params, obs)
        return jfused.fused_smz_policy(
            params, rng, root, jfused.extract_smz_fused_weights(
                networks, params),
            num_simulations=SIMS,
            num_chance_outcomes=networks.num_chance_outcomes,
            support_size=networks.support_size, discount=discount,
            dirichlet_fraction=0.0, temperature=temperature)
      root = j_root(networks)(params, obs)
      weights = jfused.extract_fused_weights(networks, params)
      if policy == "muzero":
        return jfused.fused_mlp_muzero_policy(
            params, rng, root, weights, num_simulations=SIMS,
            support_size=networks.support_size, discount=discount,
            dirichlet_fraction=0.0, temperature=temperature)
      visits, value, cq = jfused.fused_gumbel_search(
          root.embedding, root.prior_logits, root.value, weights,
          gumbel=gumbel, max_num_considered_actions=16,
          num_simulations=SIMS, support_size=networks.support_size,
          discount=discount)
      pi = jax.nn.softmax(root.prior_logits + cq, -1)
      return jnp.argmax(visits, -1).astype(jnp.int32), pi, value

    return policy_fn

  return make


def _jax_ring(segs, prios, obs_dim, num_actions):
  """Twelve segments added at steps 0, 3 and 5, so that ages differ."""
  state = j_replay_init(C, L, (obs_dim,), num_actions)
  for lo, hi, step in ((0, 4, 0), (4, 9, 3), (9, 12, 5)):
    state = j_replay_add(
        state, jax_batch({k: v[lo:hi] for k, v in segs.items()}),
        jnp.asarray(prios[lo:hi]), step=step)
  return state


@pytest.mark.parametrize("policy", ["muzero", "gumbel", "stochastic"])
def test_reanalyze_matches_jax(policy, monkeypatch):
  if policy == "stochastic":
    cfg = dict(num_actions=3, num_chance_outcomes=4, embedding_dim=8,
               support_size=10, hidden=(16,))
    j_net, j_params, _, net, params = smz_nets(cfg, obs_dim=5)
    obs_dim, A = 5, 3
  else:
    cfg = dict(num_actions=3, embedding_dim=8, support_size=10)
    j_net, j_params, net, params = nets(cfg)
    obs_dim, A = 4, 3
  segs, prios = ring_numpy(0, C=C, L=L, O=obs_dim, A=A, filled=12)
  j_state = _jax_ring(segs, prios, obs_dim, A)
  state = torch_ring(j_state)
  before = {k: getattr(state, k).clone() for k in (
      "obs", "pi", "value", "rn", "step_priorities", "target_step")}

  noise = np.random.default_rng(5).gumbel(size=(K * L, A)).astype(
      np.float32)
  monkeypatch.setattr(j_reanalyze_module, "make_policy_fn",
                      _fused_policy_factory(policy, jnp.asarray(noise)))
  monkeypatch.setattr(fused, "gumbel_noise", lambda generator, shape,
                      device: torch.from_numpy(noise))
  j_config, config = _configs(policy, A)
  rng = jax.random.PRNGKey(KEY)
  u = np.array(jax.random.uniform(jax.random.split(rng)[0], (K,)))
  j_new, j_metrics = jax.jit(j_reanalyze_module.make_reanalyze_fn(
      j_net, j_config, K))(j_params, j_state, rng, STEP)
  new, metrics = make_reanalyze_fn(net, config, K, device="cpu")(
      params, state, torch.Generator().manual_seed(0), STEP,
      uniforms=torch.from_numpy(u))

  seg = stalest_first(torch_ring(j_state), torch.from_numpy(u),
                      STEP).numpy()
  assert len(set(seg.tolist())) == K, "the key must draw distinct segments"
  np.testing.assert_array_equal(new.target_step.numpy(),
                                np.asarray(j_new.target_step))
  drawn = np.zeros(C, bool)
  drawn[seg] = True
  for name, ref in before.items():
    np.testing.assert_array_equal(getattr(new, name)[~drawn].numpy(),
                                  ref[~drawn].numpy(), err_msg=name)
  np.testing.assert_array_equal(new.obs.numpy(), before["obs"].numpy())
  if policy == "gumbel":
    np.testing.assert_allclose(new.pi[drawn].numpy(),
                               np.asarray(j_new.pi)[drawn], rtol=1e-4,
                               atol=1e-5)
  else:
    np.testing.assert_allclose(new.pi[drawn].numpy(),
                               np.asarray(j_new.pi)[drawn],
                               atol=2.0 / SIMS + 1e-6)
  np.testing.assert_allclose(new.value[drawn].numpy(),
                             np.asarray(j_new.value)[drawn], rtol=1e-3,
                             atol=1e-3)
  # The port's returns and priorities from its own values, by the JAX
  # package's recursion.
  values = new.value[drawn].numpy()
  rewards = new.reward[drawn].numpy()
  dones = new.done[drawn].numpy().astype(np.float32)
  rn = np.asarray(jax.vmap(lambda r, v, d: j_returns(
      r, v, d, DISCOUNT, 3))(rewards, values, dones))
  np.testing.assert_allclose(new.rn[drawn].numpy(), rn, rtol=1e-5,
                             atol=1e-5)
  np.testing.assert_allclose(new.step_priorities[drawn].numpy(),
                             np.abs(values - rn) ** 0.5 + 1e-6, rtol=1e-5,
                             atol=1e-5)
  assert int(metrics["reanalyzed_segments"]) == K
  np.testing.assert_allclose(float(metrics["reanalyzed_target_age"]),
                             float(j_metrics["reanalyzed_target_age"]),
                             rtol=1e-6)
  np.testing.assert_allclose(float(metrics["reanalyze_value_shift"]),
                             float(j_metrics["reanalyze_value_shift"]),
                             rtol=1e-3, atol=1e-3)


def test_stalest_first_is_the_inverse_cdf():
  """Weights 1 + age over the filled slots; u x total lands in the bin
  whose cumulative weight first exceeds it (a u on a boundary goes to the
  next slot, as the JAX package's count of cdf <= u)."""
  state = replay_init(6, 2, (1,), 2, device="cpu")
  state.total_added = 4
  state.target_step = torch.tensor([10, 8, 10, 0, 0, 0], dtype=torch.int32)
  # step 10: weights [1, 3, 1, 11, 0, 0], cdf [1, 4, 5, 16, 16, 16]
  u = torch.tensor([0.0, 0.5, 3.5, 4.0, 15.5]) / 16.0
  np.testing.assert_array_equal(stalest_first(state, u, 10).numpy(),
                                [0, 0, 1, 2, 3])


# ---- the three cases of tests/test_reanalyze.py ---------------------------

def _segments(obs, reward, rn, value, pi):
  K_, L_ = obs.shape[:2]
  return Transition(obs=obs, action=torch.zeros((K_, L_), dtype=torch.int32),
                    reward=reward, done=torch.zeros((K_, L_), dtype=torch.bool),
                    rn=rn, value=value, pi=pi, weight=torch.ones(K_),
                    mask=torch.ones((K_, L_)))


def _net_params():
  net = make_mlp_networks(2, embedding_dim=8, support_size=10, device="cpu")
  return net, net.init_params((4,), torch.Generator().manual_seed(0))


def test_reanalyze_rewrites_targets():
  config = MuZeroConfig(
      search=SearchConfig(num_simulations=4),
      replay=ReplayConfig(capacity=16, min_fill=4),
      train=TrainConfig(num_envs=4, collect_steps=6, batch_size=4,
                        unroll_steps=3, n_bootstrap=5))
  net, params = _net_params()
  gen = torch.Generator().manual_seed(1)
  n, length = 8, 6
  replay = replay_init(16, length, (4,), 2, device="cpu")
  replay_add(replay, _segments(
      torch.randn((n, length, 4), generator=gen),
      torch.ones((n, length)), torch.full((n, length), 123.0),
      torch.full((n, length), 123.0),
      torch.ones((n, length, 2)) * torch.tensor([0.9, 0.1])),
      torch.ones((n, length)))
  new, metrics = make_reanalyze_fn(net, config, 16, device="cpu")(
      params, replay, torch.Generator().manual_seed(2))
  vals = new.value[:8].numpy()
  refreshed = np.any(vals != 123.0, axis=1)
  assert refreshed.sum() >= 4
  assert np.all(np.abs(vals[refreshed]) < 100.0)
  np.testing.assert_allclose(new.pi[:8][refreshed].sum(-1).numpy(), 1.0,
                             rtol=1e-4)
  assert np.all(new.rn[:8][refreshed].numpy() < 100.0)
  assert float(metrics["reanalyze_value_shift"]) > 0.0


def test_reanalyze_only_touches_filled_slots():
  config = MuZeroConfig(
      search=SearchConfig(num_simulations=2),
      train=TrainConfig(num_envs=2, collect_steps=4, batch_size=2,
                        unroll_steps=2, n_bootstrap=2))
  net, params = _net_params()
  replay = replay_init(8, 4, (4,), 2, device="cpu")
  replay_add(replay, _segments(
      torch.zeros((2, 4, 4)), torch.zeros((2, 4)), torch.zeros((2, 4)),
      torch.zeros((2, 4)), torch.ones((2, 4, 2)) / 2), torch.ones((2, 4)))
  new, _ = make_reanalyze_fn(net, config, 8, device="cpu")(
      params, replay, torch.Generator().manual_seed(1))
  np.testing.assert_array_equal(new.obs[2:].numpy(), 0.0)
  np.testing.assert_array_equal(new.value[2:].numpy(), 0.0)
  np.testing.assert_array_equal(new.target_step[2:].numpy(), 0)


def test_reduced_budget_reanalyze(monkeypatch):
  """``reanalyze_simulations`` sets the search budget (the search sees 2
  simulations), rewrites the targets, and leaves the config as it was;
  duplicate draws of one segment agree bit for bit (MuZero in eval mode is
  deterministic)."""
  config = MuZeroConfig(
      search=SearchConfig(num_simulations=16, reanalyze_simulations=2),
      train=TrainConfig(num_envs=2, collect_steps=4, batch_size=2,
                        unroll_steps=2, n_bootstrap=2))
  net, params = _net_params()
  replay = replay_init(8, 4, (4,), 2, device="cpu")
  replay_add(replay, _segments(
      torch.randn((4, 4, 4), generator=torch.Generator().manual_seed(3)),
      torch.ones((4, 4)), torch.zeros((4, 4)), torch.zeros((4, 4)),
      torch.ones((4, 4, 2)) / 2), torch.ones((4, 4)))
  seen = []
  search = fused.fused_muzero_search

  def counted(*args, **kwargs):
    seen.append(kwargs["num_simulations"])
    out = search(*args, **kwargs)
    seen.append(out)
    return out

  monkeypatch.setattr(fused, "fused_muzero_search", counted)
  new, metrics = make_reanalyze_fn(net, config, 4, device="cpu")(
      params, replay, torch.Generator().manual_seed(1),
      uniforms=torch.tensor([0.1, 0.1, 0.6, 0.9]))
  assert config.search.num_simulations == 16
  assert seen[0] == 2 and len(seen) == 2  # one search over all K x L roots
  visits = seen[1][0].reshape(4, 4, 2)
  assert torch.equal(visits[0], visits[1])  # the duplicated segment
  assert int(metrics["reanalyzed_segments"]) == 4
  assert float(new.rn[:4].abs().max()) > 0.1
  np.testing.assert_allclose(new.pi[:4].sum(-1).numpy(), 1.0, rtol=1e-5)
