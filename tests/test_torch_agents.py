"""The port's agents (``muax_tpu_torch.agents``) against the JAX package's,
on the CPU.

* ``tests/test_agents.py``'s cases (and the agent cases of
  ``tests/test_diffusion.py``) on the port, for the three agents, with
  their own assertions.
* One ``update`` of each agent from converted parameters on one numpy
  batch, against the JAX agent's (``create_optimizer("adam", 1e-3)`` on
  both sides; Diffusion MuZero with the JAX flow-matching draws injected):
  the parameters after the step agree to rtol 1e-5 / atol 1e-6, the
  returned loss to rtol 1e-5.
* ``act``'s pi with ``dirichlet_fraction=0`` within 2 visits of JAX's on
  the same parameters (a batch of 4 observations, 16 simulations; Diffusion
  MuZero with one fixed prior draw on both sides): the engines break ties
  with 1e-7 noise from their own streams (``tests/test_fused.py:56-60``).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muax_tpu.agents import DiffusionMuZero as JDiffusionMuZero
from muax_tpu.agents import MuZero as JMuZero
from muax_tpu.agents import StochasticMuZero as JStochasticMuZero
from muax_tpu.config import SearchConfig as JSearch
from muax_tpu.models import create_optimizer as j_create_optimizer
from muax_tpu.models import make_mlp_networks as j_make_mlp
from muax_tpu.models.diffusion_networks import \
    make_diffusion_mlp_networks as j_make_dmz
from muax_tpu.models.stochastic_networks import \
    make_stochastic_mlp_networks as j_make_smz
from muax_tpu_torch.agents import DiffusionMuZero, MuZero, StochasticMuZero
from muax_tpu_torch.agents.muzero import transition_to_device
from muax_tpu_torch.config import SearchConfig
from muax_tpu_torch.models import (create_optimizer, dmz_params_from_numpy,
                                   make_diffusion_mlp_networks,
                                   make_mlp_networks,
                                   make_stochastic_mlp_networks,
                                   mlp_params_from_numpy,
                                   smz_params_from_numpy)
from muax_tpu_torch.models.convert import (dmz_grads_to_numpy,
                                           mlp_grads_to_numpy,
                                           smz_grads_to_numpy)
from muax_tpu_torch.models.optimizers import flat_parameters
from muax_tpu_torch.models.stochastic_losses import stochastic_muzero_loss
from muax_tpu_torch.models.stochastic_networks import straight_through_code
from muax_tpu_torch.ops import scalar_to_support
from muax_tpu_torch.types import Transition
from tests.test_torch_diffusion import jax_flow_draws, torch_draws
from tests.test_torch_parity import one_thread  # noqa: F401
from tests.test_torch_parity import FIELDS, batch_numpy, jax_batch

# Many small CPU ops: one intra-op thread under the suite's workers.
pytestmark = pytest.mark.usefixtures("one_thread")

MZ_NET = dict(num_actions=2, embedding_dim=8, support_size=10)
SMZ_NET = dict(num_actions=2, num_chance_outcomes=4, embedding_dim=16,
               support_size=10, hidden=(32,))
DMZ_NET = dict(num_actions=3, embedding_dim=8, support_size=10,
               num_samples=3)


def numpy_transition(arrays) -> Transition:
  return Transition(**{k: np.array(arrays[k]) for k in FIELDS})


def make_batch(seed, B=8, L=4, num_actions=2):
  """``tests/test_agents.py``'s batch shape (B = 8, L = 4, obs 4, full
  masks, uniform pi), from numpy."""
  rng = np.random.default_rng(seed)
  return numpy_transition(dict(
      obs=rng.standard_normal((B, L, 4)).astype(np.float32),
      action=rng.integers(0, num_actions, (B, L)).astype(np.int32),
      reward=rng.uniform(size=(B, L)).astype(np.float32),
      done=np.zeros((B, L), bool),
      rn=(rng.uniform(size=(B, L)) * 2).astype(np.float32),
      value=np.zeros((B, L), np.float32),
      pi=np.full((B, L, num_actions), 1.0 / num_actions, np.float32),
      weight=np.ones(B, np.float32), mask=np.ones((B, L), np.float32)))


def toy_batch(seed, num_actions, B=16, L=6, obs_dim=4):
  """``tests/test_diffusion.py``'s toy MDP (obs rotates by one and shifts
  by 0.1 a, reward = obs[0]), from numpy."""
  rng = np.random.default_rng(seed)
  obs = rng.standard_normal((B, obs_dim)).astype(np.float32)
  actions = rng.integers(0, num_actions, (B, L)).astype(np.int32)
  seq = []
  for i in range(L):
    seq.append(obs)
    obs = np.roll(obs, 1, -1) + 0.1 * actions[:, i:i + 1].astype(np.float32)
  obs_seq = np.stack(seq, 1)
  logits = rng.standard_normal((B, L, num_actions))
  pi = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
  reward = obs_seq[..., 0].copy()
  return numpy_transition(dict(
      obs=obs_seq, action=actions, reward=reward,
      done=np.zeros((B, L), bool), rn=reward, value=reward,
      pi=pi.astype(np.float32), weight=np.ones(B, np.float32),
      mask=np.ones((B, L), np.float32)))


def _mz_agent(**kw):
  agent = MuZero(make_mlp_networks(device="cpu", **MZ_NET),
                 optimizer=create_optimizer("adam", 1e-3), unroll_steps=4,
                 **kw)
  agent.init(0, np.zeros((1, 4), np.float32))
  return agent


def _smz_agent():
  agent = StochasticMuZero(
      make_stochastic_mlp_networks(device="cpu", **SMZ_NET),
      optimizer=create_optimizer("adam", 1e-3), unroll_steps=4)
  agent.init(0, np.zeros((1, 4), np.float32))
  return agent


def _dmz_agent(**kw):
  agent = DiffusionMuZero(
      make_diffusion_mlp_networks(device="cpu", **{**DMZ_NET, **kw}))
  agent.init(0, np.zeros((1, 4), np.float32))
  return agent


# ---- tests/test_agents.py on the port ---------------------------------------

class TestMuZeroAgent:

  def test_act_single_obs(self):
    a = _mz_agent().act(1, np.zeros(4, np.float32), num_simulations=8)
    assert a.shape == () and int(a) in (0, 1)

  def test_act_with_pi_and_value(self):
    a, pi, v = _mz_agent().act(torch.Generator().manual_seed(1),
                               torch.zeros(4), with_pi=True, with_value=True,
                               num_simulations=8)
    assert pi.shape == (2,)
    np.testing.assert_allclose(float(pi.sum()), 1.0, rtol=1e-5)
    assert np.isfinite(float(v))

  def test_act_batched(self):
    a = _mz_agent().act(1, np.zeros((16, 4)), obs_from_batch=True,
                        num_simulations=8)
    assert a.shape == (16,)

  def test_gumbel_policy_acts(self):
    agent = _mz_agent(policy="gumbel")
    a, pi = agent.act(1, np.zeros((3, 4)), obs_from_batch=True,
                      with_pi=True, num_simulations=8)
    assert a.shape == (3,) and pi.shape == (3, 2)
    assert agent.search.policy == "gumbel"

  def test_network_helpers(self):
    agent = _mz_agent()
    s = agent.representation(np.zeros((2, 4)))
    pi_logits, v = agent.prediction(s)
    assert pi_logits.shape == (2, 2) and v.shape == (2,)
    r, ns = agent.dynamic(s, np.zeros(2, np.int32))
    assert r.shape == (2,) and ns.shape == s.shape

  def test_update_decreases_loss(self):
    agent = _mz_agent()
    batch = make_batch(2)
    losses = [agent.update(batch) for _ in range(30)]
    assert losses[-1] < losses[0]

  def test_save_load_roundtrip(self, tmp_path):
    agent = _mz_agent()
    agent.update(make_batch(2))
    path = str(tmp_path / "model.ckpt")
    agent.save(path)
    agent2 = _mz_agent()
    agent2.load(path)
    for a, b in zip(agent.params.state_dict().values(),
                    agent2.params.state_dict().values()):
      assert torch.equal(a, b)
    assert agent2.opt_state[0].count == agent.opt_state[0].count == 1
    # The loaded agent goes on stepping as the saved one does.
    assert agent2.update(make_batch(3)) == agent.update(make_batch(3))
    for a, b in zip(agent.params.parameters(), agent2.params.parameters()):
      assert torch.equal(a, b)


class TestStochasticMuZeroAgent:

  def test_act(self):
    a, pi, v = _smz_agent().act(1, np.zeros(4), with_pi=True,
                                with_value=True, num_simulations=12)
    assert int(a) in (0, 1) and pi.shape == (2,)
    np.testing.assert_allclose(float(pi.sum()), 1.0, rtol=1e-4)
    assert _smz_agent().search.num_simulations == 200

  def test_update_decreases_loss(self):
    agent = _smz_agent()
    batch = make_batch(2)
    losses = [agent.update(batch) for _ in range(30)]
    assert losses[-1] < losses[0]

  def test_loss_components(self):
    agent = _smz_agent()
    batch = transition_to_device(make_batch(1), torch.device("cpu"))
    total, metrics = stochastic_muzero_loss(agent.params, batch,
                                            agent.networks)
    assert np.isfinite(float(total))
    for name in ("reward_loss", "value_loss", "policy_loss", "chance_loss",
                 "afterstate_value_loss", "commitment_loss"):
      assert np.isfinite(float(getattr(metrics, name))), name

  def test_afterstate_value_indexing_matches_reference(self):
    """The reference's loop (decision at s_{i-1} with action[:, i-1], the
    afterstate value against value_target[:, i-1]) and the port's, which
    indexes by the decision step, sum the same cross-entropy."""
    agent = _smz_agent()
    params, net = agent.params, agent.networks
    batch = transition_to_device(make_batch(1, B=8, L=5), torch.device("cpu"))
    L = batch.action.shape[1]

    def ce(logits, target):
      return -torch.sum(target * torch.log_softmax(logits, -1), -1)

    with torch.no_grad():
      s = params.representation(batch.obs[:, 0])
      av_ref = torch.zeros(batch.action.shape[0])
      for i in range(1, L):
        code = straight_through_code(params.encoder(batch.obs[:, i]))
        ae, _, av = params.decision(s, batch.action[:, i - 1])
        av_ref += ce(av, scalar_to_support(batch.rn[:, i - 1],
                                           net.support_size))
        s, _ = params.chance(ae, code)
      _, metrics = stochastic_muzero_loss(params, batch, net)
    np.testing.assert_allclose(float(metrics.afterstate_value_loss),
                               float(torch.mean(av_ref / L)), rtol=1e-5)


class TestDiffusionMuZeroAgent:

  def test_act_update_save_load(self, tmp_path):
    agent = _dmz_agent()
    obs = np.random.RandomState(0).randn(4).astype(np.float32)
    a, pi, v = agent.act(1, obs, with_pi=True, with_value=True,
                         num_simulations=8)
    assert 0 <= int(a) < 3 and pi.shape == (3,)
    np.testing.assert_allclose(float(pi.sum()), 1.0, rtol=1e-5)
    # Without a generator every update draws from a fresh seed-0 stream.
    # L = 5 for the default unroll of 5: the JAX file's case passes L = 4,
    # which the JAX loss reads past the window's end by JAX's clamped
    # indexing; the port's indexing raises there.
    batch = toy_batch(2, 3, B=8, L=5)
    first = _dmz_agent().update(batch)
    assert first == _dmz_agent().update(batch)
    agent.update(batch)
    path = str(tmp_path / "dmz.ckpt")
    agent.save(path)
    restored = DiffusionMuZero(agent.networks).load(path)
    for x, y in zip(agent.params.state_dict().values(),
                    restored.params.state_dict().values()):
      assert torch.equal(x, y)

  def test_training_reduces_loss_and_flow_learns_dynamics(self):
    """SGD on the unrolled loss reduces it, and the flow's
    conditional-mean readout then approximates the true next latent
    better than the untrained one."""
    net = make_diffusion_mlp_networks(device="cpu", num_actions=3,
                                      embedding_dim=8, support_size=10,
                                      hidden=(32,))
    agent = DiffusionMuZero(net, optimizer=create_optimizer("adam", 3e-3),
                            unroll_steps=4)
    agent.init(0, np.zeros((1, 4)))
    params0 = net.init_params((4,))
    params0.load_state_dict(agent.params.state_dict())
    batch = toy_batch(1, 3, B=32)
    g = torch.Generator().manual_seed(1)
    losses = [agent.update(batch, generator=g) for _ in range(150)]
    assert np.mean(losses[-10:]) < 0.5 * np.mean(losses[:10])

    tb = transition_to_device(batch, torch.device("cpu"))

    def flow_error(params):
      with torch.no_grad():
        s = params.representation(tb.obs[:, 0])
        z_next = params.representation(tb.obs[:, 1])
        after, _ = params.decision(s, tb.action[:, 0])
        pred = net.mean_next_state(params, after)
      return float(torch.mean(torch.square(pred - z_next)))

    assert flow_error(agent.params) < flow_error(params0)


def test_transition_to_device_packs_every_field():
  batch = make_batch(0)
  batch = dataclasses.replace(batch, reward=batch.reward.astype(np.float64),
                              action=batch.action.astype(np.int64))
  out = transition_to_device(batch, torch.device("cpu"))
  for name in FIELDS:
    ref = getattr(batch, name)
    got = getattr(out, name)
    assert got.shape == ref.shape, name
    np.testing.assert_array_equal(got.numpy(), ref.astype(got.numpy().dtype))
  assert out.reward.dtype == torch.float32 and out.action.dtype == torch.int32
  assert out.done.dtype == torch.bool
  assert transition_to_device(out, torch.device("cpu")).obs is out.obs


def test_generator_on_another_device_is_refused():
  agent = _mz_agent()
  with pytest.raises(ValueError):
    agent.act(types.SimpleNamespace(device=torch.device("cuda", 0)),
              np.zeros(4))


# ---- one update against the JAX agents --------------------------------------

def _port_tree(to_numpy, params):
  return to_numpy(params, flat_parameters(params))


def _assert_params_close(port_tree, j_params, towers):
  for name in towers:
    ref_tree = jax.tree.map(np.asarray, getattr(j_params, name))
    for module, leaves in ref_tree.items():
      for key, value in leaves.items():
        np.testing.assert_allclose(port_tree[name][module][key], value,
                                   rtol=1e-5, atol=1e-6,
                                   err_msg=f"{name}/{module}/{key}")


def _jax_agent(cls, j_net, **kw):
  """A JAX agent initialised as its ``init(PRNGKey(0), zeros((1, 4)))``
  does, with the networks' init jitted (eager haiku init takes seconds)."""
  j_agent = cls(j_net, **kw)
  j_agent.params = jax.jit(j_net.init_params)(jax.random.PRNGKey(0),
                                              jnp.zeros((1, 4)))
  j_agent.opt_state = j_agent.optimizer.init(j_agent.params)
  return j_agent


def _jax_params(j_agent, towers):
  return {n: jax.tree.map(np.asarray, getattr(j_agent.params, n))
          for n in towers}


def test_muzero_update_matches_jax():
  towers = ("representation", "prediction", "dynamic")
  j_agent = _jax_agent(JMuZero, j_make_mlp(**MZ_NET),
                       optimizer=j_create_optimizer("adam", 1e-3),
                       unroll_steps=4)
  net = make_mlp_networks(device="cpu", **MZ_NET)
  agent = MuZero(net, optimizer=create_optimizer("adam", 1e-3),
                 unroll_steps=4)
  agent.init(None, np.zeros((1, 4)),
             params=mlp_params_from_numpy(_jax_params(j_agent, towers), net))
  arrays = batch_numpy(6, B=16, L=4, obs_dim=4, num_actions=2)
  ref_loss = j_agent.update(jax_batch(arrays))
  loss = agent.update(numpy_transition(arrays))
  np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-5)
  _assert_params_close(_port_tree(mlp_grads_to_numpy, agent.params),
                       j_agent.params, towers)


def test_stochastic_update_matches_jax():
  towers = ("encoder", "representation", "prediction", "decision", "chance")
  j_agent = _jax_agent(JStochasticMuZero, j_make_smz(**SMZ_NET),
                       optimizer=j_create_optimizer("adam", 1e-3),
                       unroll_steps=4)
  net = make_stochastic_mlp_networks(device="cpu", **SMZ_NET)
  agent = StochasticMuZero(net, optimizer=create_optimizer("adam", 1e-3),
                           unroll_steps=4)
  agent.init(None, np.zeros((1, 4)),
             params=smz_params_from_numpy(_jax_params(j_agent, towers), net))
  arrays = batch_numpy(7, B=16, L=4, obs_dim=4, num_actions=2)
  ref_loss = j_agent.update(jax_batch(arrays))
  loss = agent.update(numpy_transition(arrays))
  np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-5)
  _assert_params_close(_port_tree(smz_grads_to_numpy, agent.params),
                       j_agent.params, towers)


def test_diffusion_update_matches_jax_with_injected_draws():
  towers = ("representation", "prediction", "decision", "velocity", "reward")
  j_agent = _jax_agent(JDiffusionMuZero, j_make_dmz(**DMZ_NET),
                       optimizer=j_create_optimizer("adam", 1e-3),
                       unroll_steps=4)
  net = make_diffusion_mlp_networks(device="cpu", **DMZ_NET)
  agent = DiffusionMuZero(net, optimizer=create_optimizer("adam", 1e-3),
                          unroll_steps=4)
  agent.init(None, np.zeros((1, 4)),
             params=dmz_params_from_numpy(_jax_params(j_agent, towers), net))
  arrays = batch_numpy(8, B=16, L=4, obs_dim=4, num_actions=3)
  key = jax.random.PRNGKey(9)
  ref_loss = j_agent.update(jax_batch(arrays), key)
  draws = torch_draws(jax_flow_draws(key, 16, DMZ_NET["embedding_dim"], 4))
  loss = agent.update(numpy_transition(arrays), draws=draws)
  np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-5)
  _assert_params_close(_port_tree(dmz_grads_to_numpy, agent.params),
                       j_agent.params, towers)


# ---- act against the JAX agents ---------------------------------------------

SIMS = 16


def _compare_pi(pi, ref_pi):
  assert np.abs(pi.numpy() - np.asarray(ref_pi)).max() * SIMS <= 2 + 1e-4
  np.testing.assert_allclose(pi.sum(-1).numpy(), 1.0, rtol=1e-5)


def _obs(seed=11, B=4):
  return np.random.default_rng(seed).standard_normal((B, 4)).astype(
      np.float32)


def test_muzero_act_pi_matches_jax():
  towers = ("representation", "prediction", "dynamic")
  j_agent = _jax_agent(JMuZero, j_make_mlp(**MZ_NET),
                       search_config=JSearch(dirichlet_fraction=0.0))
  net = make_mlp_networks(device="cpu", **MZ_NET)
  agent = MuZero(net, search_config=SearchConfig(dirichlet_fraction=0.0))
  agent.init(None, np.zeros((1, 4)),
             params=mlp_params_from_numpy(_jax_params(j_agent, towers), net))
  obs = _obs()
  _, ref_pi = j_agent.act(jax.random.PRNGKey(1), obs, with_pi=True,
                          obs_from_batch=True, num_simulations=SIMS)
  _, pi = agent.act(1, obs, with_pi=True, obs_from_batch=True,
                    num_simulations=SIMS)
  _compare_pi(pi, ref_pi)


def test_stochastic_act_pi_matches_jax():
  towers = ("encoder", "representation", "prediction", "decision", "chance")
  j_agent = _jax_agent(JStochasticMuZero, j_make_smz(**SMZ_NET),
                       search_config=JSearch(policy="stochastic",
                                             dirichlet_fraction=0.0))
  net = make_stochastic_mlp_networks(device="cpu", **SMZ_NET)
  agent = StochasticMuZero(net, search_config=SearchConfig(
      policy="stochastic", dirichlet_fraction=0.0))
  agent.init(None, np.zeros((1, 4)),
             params=smz_params_from_numpy(_jax_params(j_agent, towers), net))
  obs = _obs()
  _, ref_pi = j_agent.act(jax.random.PRNGKey(1), obs, with_pi=True,
                          obs_from_batch=True, num_simulations=SIMS)
  _, pi = agent.act(1, obs, with_pi=True, obs_from_batch=True,
                    num_simulations=SIMS)
  _compare_pi(pi, ref_pi)


def test_diffusion_act_pi_matches_jax_with_a_fixed_prior():
  towers = ("representation", "prediction", "decision", "velocity", "reward")
  j_net = j_make_dmz(**DMZ_NET)
  j_agent = _jax_agent(JDiffusionMuZero, j_net,
                       search_config=JSearch(policy="stochastic",
                                             dirichlet_fraction=0.0))
  net = make_diffusion_mlp_networks(device="cpu", **DMZ_NET)
  agent = DiffusionMuZero(net, search_config=SearchConfig(
      policy="stochastic", dirichlet_fraction=0.0))
  agent.init(None, np.zeros((1, 4)),
             params=dmz_params_from_numpy(_jax_params(j_agent, towers), net))
  obs = _obs()
  prior = np.random.default_rng(12).standard_normal(
      (4 * DMZ_NET["num_samples"], DMZ_NET["embedding_dim"])).astype(
          np.float32)
  j_net.flow.prior_sampling = lambda rng, shape: jnp.asarray(prior)
  net.flow.prior_sampling = lambda generator, shape: torch.from_numpy(prior)
  _, ref_pi = j_agent.act(jax.random.PRNGKey(1), obs, with_pi=True,
                          obs_from_batch=True, num_simulations=SIMS)
  _, pi = agent.act(1, obs, with_pi=True, obs_from_batch=True,
                    num_simulations=SIMS)
  _compare_pi(pi, ref_pi)
