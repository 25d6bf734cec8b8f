"""The port's Stochastic MuZero searches against the JAX package's, on the
same roots and weights (the sizes of ``tests/test_fused_smz.py``: batch 4,
A = 3, C = 4, E = 8, hidden (16,), 24-32 simulations).

Both port routes, the generic engine's ``stochastic_muzero_policy`` and the
fused search's plain version ``fused_smz_search_reference``, are held
against both JAX routes, the fused kernel ``fused_smz_search`` (in interpret
mode) and the XLA engine's ``stochastic_muzero_policy``: decision visits
within 2 (ties break deterministically in the kernels and by 1e-7 noise in
the engines) and root values at rtol = atol = 1e-3
(``tests/test_fused_smz.py:58-66``), with the depth cap too; the policy's
action weights within 2.5 / sims (``:117-119``). A deep-tree case biases
the JAX params' policy and chance heads (one action and one outcome
dominate, so the simulations extend one chain) before conversion. The CUDA kernel is held
against the plain version on the card (``test_torch_smz_kernels.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muax_tpu.search import stochastic_muzero_policy as j_policy
from muax_tpu.search.fused import extract_smz_fused_weights as j_extract
from muax_tpu.search.fused import fused_smz_search as j_fused_search
from muax_tpu.train.inference import make_smz_fns as j_make_smz_fns
from muax_tpu_torch.config import MuZeroConfig, SearchConfig, TrainConfig
from muax_tpu_torch.envs import AutoResetWrapper, CartPole
from muax_tpu_torch.models import make_stochastic_mlp_networks
from muax_tpu_torch.search import fused, policies
from muax_tpu_torch.search.types import RootFnOutput
from muax_tpu_torch.train import make_policy_fn, make_rollout_fn
from muax_tpu_torch.train.inference import make_smz_fns
from muax_tpu_torch.models.convert import smz_params_from_numpy
from tests.test_torch_smz_networks import CONFIGS, TOWERS, smz_nets

DISCOUNT = 0.95
# Added to the first entry of the policy head's and of the chance head's
# bias in the deep-tree case.
DEEP_BIAS = 8.0


def _deep_tree(j_params):
  """``j_params`` with DEEP_BIAS on the first bias entry of the policy head
  (the prediction tower's second-to-last linear) and of the chance head
  (the decision tower's)."""
  def biased(tower):
    names = sorted(tower, key=lambda k: 0 if k == "linear"
                   else int(k.rsplit("_", 1)[1]))
    head = dict(tower[names[-2]])
    head["b"] = head["b"].at[0].add(DEEP_BIAS)
    return {**tower, names[-2]: head}

  return j_params._replace(prediction=biased(j_params.prediction),
                           decision=biased(j_params.decision))


def _setup(cfg=CONFIGS[0], batch=4, deep=False):
  """JAX networks, params and root, and the port's networks, params and
  the same root as torch tensors; ``deep`` biases the heads first."""
  j_net, j_params, _, net, params = smz_nets(cfg)
  if deep:
    j_params = _deep_tree(j_params)
    params = smz_params_from_numpy(
        {name: jax.tree.map(np.asarray, getattr(j_params, name))
         for name in TOWERS}, net)
  obs = jax.random.normal(jax.random.PRNGKey(1), (batch, 5))
  j_fns = j_make_smz_fns(j_net, DISCOUNT)
  j_root = j_fns[0](j_params, obs)
  root = RootFnOutput(
      prior_logits=torch.from_numpy(np.array(j_root.prior_logits)),
      value=torch.from_numpy(np.array(j_root.value)),
      embedding=torch.from_numpy(np.array(j_root.embedding)))
  return j_net, j_params, j_fns, j_root, net, params, root


def _agree(visits, value, ref_visits, ref_value, sims):
  visits, ref_visits = np.asarray(visits), np.asarray(ref_visits)
  np.testing.assert_allclose(visits.sum(-1), sims)
  np.testing.assert_allclose(ref_visits.sum(-1), sims)
  assert np.abs(visits - ref_visits).max() <= 2
  np.testing.assert_allclose(np.asarray(value), np.asarray(ref_value),
                             rtol=1e-3, atol=1e-3)


def _port_routes(net, params, root, sims, invalid=None, max_depth=None,
                 logits=None):
  """(visits, value) of the generic policy and of the plain fused search."""
  logits = root.prior_logits if logits is None else logits
  _, dec_fn, ch_fn = make_smz_fns(net, DISCOUNT)
  out = policies.stochastic_muzero_policy(
      params, torch.Generator().manual_seed(0),
      RootFnOutput(prior_logits=logits, value=root.value,
                   embedding=root.embedding), dec_fn, ch_fn, sims,
      net.num_chance_outcomes, invalid_actions=invalid, max_depth=max_depth,
      dirichlet_fraction=0.0, discount=DISCOUNT)
  summary = out.search_tree.summary()
  generic = (summary.visit_counts[:, :net.num_actions], summary.value)
  before = fused.smz_launches
  visits, value, q = fused.fused_smz_search(
      root.embedding, logits, root.value,
      fused.extract_smz_fused_weights(net, params), num_simulations=sims,
      support_size=net.support_size, discount=DISCOUNT,
      invalid_actions=invalid, max_depth=max_depth)
  assert fused.smz_launches == before  # the plain version launches nothing
  assert q.shape == visits.shape
  return generic, (visits, value)


@pytest.mark.parametrize("max_depth", [None, 2])
def test_searches_match_jax(max_depth):
  j_net, j_params, (_, j_dec, j_ch), j_root, net, params, root = _setup()
  sims = 24
  ref_engine = j_policy(
      j_params, jax.random.PRNGKey(2), j_root, decision_recurrent_fn=j_dec,
      chance_recurrent_fn=j_ch, num_simulations=sims,
      num_chance_outcomes=net.num_chance_outcomes, dirichlet_fraction=0.0,
      discount=DISCOUNT, max_depth=max_depth).search_tree.summary()
  ref_kernel = j_fused_search(
      j_root.embedding, j_root.prior_logits, j_root.value,
      j_extract(j_net, j_params), num_simulations=sims,
      num_chance_outcomes=net.num_chance_outcomes,
      support_size=net.support_size, discount=DISCOUNT, max_depth=max_depth,
      interpret=True)
  engine_ref = (np.asarray(ref_engine.visit_counts)[:, :net.num_actions],
                ref_engine.value)
  for visits, value in _port_routes(net, params, root, sims,
                                    max_depth=max_depth):
    _agree(visits, value, ref_kernel[0], ref_kernel[1], sims)
    _agree(visits, value, *engine_ref, sims)


@pytest.mark.parametrize("max_depth", [None, 8])
def test_deep_tree_searches_match_jax(max_depth):
  """The deep-tree net: the port's routes against the JAX kernel and
  engine at batch 4, 32 simulations; the descents run as deep as the
  simulations allow (or to the cap), and the cap re-evaluates in place."""
  j_net, j_params, (_, j_dec, j_ch), j_root, net, params, root = _setup(
      deep=True)
  sims = 32
  ref_engine = j_policy(
      j_params, jax.random.PRNGKey(2), j_root, decision_recurrent_fn=j_dec,
      chance_recurrent_fn=j_ch, num_simulations=sims,
      num_chance_outcomes=net.num_chance_outcomes, dirichlet_fraction=0.0,
      discount=DISCOUNT, max_depth=max_depth).search_tree.summary()
  ref_kernel = j_fused_search(
      j_root.embedding, j_root.prior_logits, j_root.value,
      j_extract(j_net, j_params), num_simulations=sims,
      num_chance_outcomes=net.num_chance_outcomes,
      support_size=net.support_size, discount=DISCOUNT, max_depth=max_depth,
      interpret=True)
  engine_ref = (np.asarray(ref_engine.visit_counts)[:, :net.num_actions],
                ref_engine.value)
  for visits, value in _port_routes(net, params, root, sims,
                                    max_depth=max_depth):
    _agree(visits, value, ref_kernel[0], ref_kernel[1], sims)
    _agree(visits, value, *engine_ref, sims)


def test_chance_children_track_prior():
  """One legal action: every simulation descends through one afterstate,
  whose outcome children are visited in proportion to the chance prior
  (``tests/test_fused_smz.py:70-85``)."""
  cfg = dict(CONFIGS[0], num_actions=2, num_chance_outcomes=3)
  j_net, j_params, _, j_root, net, params, root = _setup(cfg)
  invalid = np.zeros((4, 2), np.float32)
  invalid[:, 1] = 1.0
  logits = np.where(invalid > 0, -1e9, np.asarray(j_root.prior_logits))
  sims = 30
  ref = j_fused_search(
      j_root.embedding, jnp.asarray(logits, jnp.float32), j_root.value,
      j_extract(j_net, j_params), num_simulations=sims,
      num_chance_outcomes=3, support_size=net.support_size,
      discount=DISCOUNT, invalid_actions=jnp.asarray(invalid),
      interpret=True)
  for visits, value in _port_routes(
      net, params, root, sims, invalid=torch.from_numpy(invalid),
      logits=torch.from_numpy(logits.astype(np.float32))):
    assert np.all(np.asarray(visits)[:, 1] == 0.0)
    _agree(visits, value, ref[0], ref[1], sims)


def test_policy_weights_match_jax():
  """``fused_smz_policy``'s action weights (normalized decision visits)
  against the XLA policy's, within 2.5 / sims."""
  j_net, j_params, (_, j_dec, j_ch), j_root, net, params, root = _setup()
  sims = 32
  ref = j_policy(
      j_params, jax.random.PRNGKey(2), j_root, decision_recurrent_fn=j_dec,
      chance_recurrent_fn=j_ch, num_simulations=sims, num_chance_outcomes=4,
      dirichlet_fraction=0.0, temperature=1.0, discount=DISCOUNT)
  action, weights, value = fused.fused_smz_policy(
      params, torch.Generator().manual_seed(3), root,
      fused.extract_smz_fused_weights(net, params), num_simulations=sims,
      support_size=net.support_size, discount=DISCOUNT,
      dirichlet_fraction=0.0, temperature=1.0)
  np.testing.assert_allclose(weights.numpy(),
                             np.asarray(ref.action_weights), atol=2.5 / sims)
  np.testing.assert_allclose(weights.sum(-1).numpy(), 1.0, rtol=1e-5)
  assert action.dtype == torch.int32 and action.shape == (4,)
  assert bool(((action >= 0) & (action < 3)).all())
  np.testing.assert_allclose(value.numpy(),
                             np.asarray(ref.search_tree.summary().value),
                             rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("fused_search", [True, False])
def test_policy_fn_routes_and_rollout(fused_search, monkeypatch):
  """``make_policy_fn`` with ``policy="stochastic"``: ``search.fused`` takes
  the fused search (its plain version on the CPU), ``fused=False`` the
  generic engine; ``make_rollout_fn`` returns the segments of either."""
  net = make_stochastic_mlp_networks(2, num_chance_outcomes=4,
                                     embedding_dim=8, support_size=5,
                                     hidden=(16,), device="cpu")
  params = net.init_params((4,), torch.Generator().manual_seed(0))
  config = MuZeroConfig(
      search=SearchConfig(policy="stochastic", num_simulations=8,
                          fused=fused_search),
      train=TrainConfig(num_envs=5, collect_steps=4))
  calls = []
  plain = fused.fused_smz_search_reference

  def counted(*args, **kwargs):
    calls.append(1)
    return plain(*args, **kwargs)

  monkeypatch.setattr(fused, "fused_smz_search_reference", counted)
  policy_fn = make_policy_fn(net, config, DISCOUNT, device="cpu")
  obs = torch.randn(5, 4, generator=torch.Generator().manual_seed(1))
  action, pi, value = policy_fn(params, torch.Generator().manual_seed(2),
                                obs, 1.0)
  assert len(calls) == int(fused_search)
  assert action.shape == (5,) and action.dtype == torch.int32
  assert bool(((action >= 0) & (action < 2)).all())
  torch.testing.assert_close(pi.sum(-1), torch.ones(5))
  assert bool(torch.isfinite(value).all())

  env = AutoResetWrapper(CartPole())
  gen = torch.Generator().manual_seed(3)
  rollout = make_rollout_fn(net, env, config, device="cpu")
  _, seg, prio, metrics = rollout(params, env.reset(gen, 5), gen, 1.0)
  assert seg.obs.shape == (5, 4, 4) and seg.pi.shape == (5, 4, 2)
  assert prio.shape == (5, 4) and bool(torch.isfinite(prio).all())
  assert len(calls) == 5 * int(fused_search)
