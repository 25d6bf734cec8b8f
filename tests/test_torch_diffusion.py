"""The port's diffusion family against the JAX package's, on the CPU: the
flow library, the five nets, the unrolled loss and the search policy.

Tolerances:

* ``RectifiedFlow``: ``marginal_prob``, ``prior_logp`` and the Euler
  integration from one numpy prior draw, rtol 1e-6 (atol 1e-6 for the
  integration: the same f32 operations, a velocity field's products summed
  in another order);
* the five towers through ``dmz_params_from_numpy`` against haiku's own
  init: rtol 1e-5, atol 1e-6;
* ``sample_candidates`` and ``mean_next_state`` with the prior draw
  injected (on the JAX side through the test's own ``RectifiedFlow``
  instance): rtol 1e-4, atol 1e-6 (eight chained network evaluations, then
  a min-max normalization);
* ``diffusion_muzero_loss`` with the JAX (t, eps) draws injected:
  gradients rtol 1e-4 / atol 1e-6, loss metrics rtol 1e-5, priorities
  rtol 1e-4;
* ``diffusion_muzero_policy`` with a deterministic ``sample_fn``, no root
  noise and a depth cap: decision visits within 2, root value rtol = atol
  = 1e-3
  (``tests/test_fused.py:56-60``: the engines break ties with 1e-7 noise
  from their own streams); and the JAX file's behavioural cases on the
  port.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muax_tpu.agents import DiffusionMuZero as JDiffusionMuZero
from muax_tpu.models.diffusion import RectifiedFlow as JFlow
from muax_tpu.models.diffusion_losses import \
    diffusion_muzero_loss as j_loss
from muax_tpu.models.diffusion_networks import \
    make_diffusion_mlp_networks as j_make
from muax_tpu.search.diffusion_policy import \
    diffusion_muzero_policy as j_policy
from muax_tpu_torch import search as mx
from muax_tpu_torch.agents import DiffusionMuZero
from muax_tpu_torch.models import (DMZParams, RectifiedFlow,
                                   dmz_params_from_numpy, flow_matching_loss,
                                   make_diffusion_mlp_networks)
from muax_tpu_torch.models.convert import dmz_grads_to_numpy
from muax_tpu_torch.models.diffusion import euler_integrate
from muax_tpu_torch.models.diffusion_losses import (diffusion_muzero_grad,
                                                    diffusion_muzero_loss)
from muax_tpu_torch.models.optimizers import (apply_updates,
                                              create_optimizer,
                                              flat_parameters)
from muax_tpu_torch.search.diffusion_policy import diffusion_muzero_policy
from tests.test_torch_parity import one_thread  # noqa: F401
from tests.test_torch_parity import batch_numpy, jax_batch, torch_batch

# Many small CPU ops: one intra-op thread under the suite's workers.
pytestmark = pytest.mark.usefixtures("one_thread")

TOWERS = DMZParams.TOWERS
CONFIGS = [
    dict(num_actions=3, num_samples=3, embedding_dim=8, support_size=10,
         hidden=(16,)),
    dict(num_actions=2, num_samples=4, embedding_dim=6, support_size=5,
         hidden=(12, 10)),
    dict(num_actions=4, num_samples=2, embedding_dim=5, support_size=4,
         hidden=()),
]
KW = dict(l2_coef=1e-4, gradient_scale=0.5, priority_alpha=0.5)
METRICS = ("total", "reward_loss", "value_loss", "policy_loss",
           "afterstate_value_loss", "flow_loss", "l2_loss")


def dmz_nets(cfg, obs_dim=4, seed=0):
  """JAX networks and params, the numpy tree, and the port's networks and
  params (on the CPU) from the same numbers."""
  j_net = j_make(**cfg)
  j_params = jax.jit(j_net.init_params)(jax.random.PRNGKey(seed),
                                        jnp.zeros((1, obs_dim)))
  tree = {name: jax.tree.map(np.asarray, getattr(j_params, name))
          for name in TOWERS}
  net = make_diffusion_mlp_networks(device="cpu", **cfg)
  return j_net, j_params, tree, net, dmz_params_from_numpy(tree, net)


def _close(port, ref, rtol=1e-5, atol=1e-6):
  np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                             rtol=rtol, atol=atol)


# ---- the flow library -------------------------------------------------------

def _velocity_pair(dim, seed=0):
  """The same smooth velocity field v(x, t, cond) in jnp and in torch."""
  rng = np.random.default_rng(seed)
  w = rng.standard_normal((2 * dim + 1, dim)).astype(np.float32) * 0.5
  b = rng.standard_normal(dim).astype(np.float32) * 0.1

  def j_vel(x, t, cond):
    return jnp.tanh(jnp.concatenate([x, t[:, None], cond], -1) @ w + b)

  tw, tb = torch.from_numpy(w), torch.from_numpy(b)

  def t_vel(x, t, cond):
    return torch.tanh(torch.cat([x, t[:, None], cond], -1) @ tw + tb)

  return j_vel, t_vel


def test_marginal_prob_and_prior_logp_match_jax():
  rng = np.random.default_rng(0)
  x0 = rng.standard_normal((5, 3)).astype(np.float32)
  t = rng.uniform(size=5).astype(np.float32)
  z = rng.standard_normal((5, 2, 3)).astype(np.float32)
  j_flow, flow = JFlow(sigma=1.7), RectifiedFlow(sigma=1.7)
  for port, ref in zip(flow.marginal_prob(torch.from_numpy(x0),
                                          torch.from_numpy(t)),
                       j_flow.marginal_prob(jnp.asarray(x0), jnp.asarray(t))):
    _close(port, ref, rtol=1e-6, atol=0)
  _close(flow.prior_logp(torch.from_numpy(z)),
         j_flow.prior_logp(jnp.asarray(z)), rtol=1e-6, atol=0)
  # The JAX file's fixed points.
  mean, std = RectifiedFlow(sigma=2.0).marginal_prob(
      torch.ones(4, 3), torch.full((4,), 0.5))
  assert torch.allclose(mean, torch.full((4, 3), 0.5))
  assert torch.allclose(std, torch.ones(4))
  np.testing.assert_allclose(
      RectifiedFlow().prior_logp(torch.zeros(2, 4)).numpy(),
      -0.5 * 4 * np.log(2 * np.pi), rtol=1e-6)


@pytest.mark.parametrize("steps", [1, 8, 30])
def test_euler_integration_from_one_prior_matches_jax(steps):
  B, D = 6, 3
  rng = np.random.default_rng(steps)
  prior = rng.standard_normal((B, D)).astype(np.float32)
  cond = rng.standard_normal((B, D)).astype(np.float32)
  j_vel, t_vel = _velocity_pair(D)
  j_flow = JFlow(sigma=1.0, num_steps=steps)
  j_flow.prior_sampling = lambda rng_, shape: jnp.asarray(prior)
  ref = j_flow.euler_ode(j_vel, jax.random.PRNGKey(0), (B, D),
                         cond=jnp.asarray(cond))
  ref_z, ref_x = j_flow.reflow_pairs(j_vel, jax.random.PRNGKey(0), (B, D),
                                     cond=jnp.asarray(cond))
  out = euler_integrate(t_vel, torch.from_numpy(prior), steps,
                        torch.from_numpy(cond))
  _close(out, ref, rtol=1e-6, atol=1e-6)
  flow = RectifiedFlow(sigma=1.0, num_steps=steps)
  flow.prior_sampling = lambda generator, shape: torch.from_numpy(prior)
  z, x = flow.reflow_pairs(t_vel, None, (B, D), torch.from_numpy(cond))
  _close(z, ref_z, rtol=0, atol=0)
  _close(x, ref_x, rtol=1e-6, atol=1e-6)
  _close(flow.euler_ode(t_vel, None, (B, D), torch.from_numpy(cond)), ref,
         rtol=1e-6, atol=1e-6)


def test_prior_sampling_draws_on_the_generator():
  flow = RectifiedFlow(sigma=2.0)
  a = flow.prior_sampling(torch.Generator().manual_seed(3), (4096, 2))
  b = flow.prior_sampling(torch.Generator().manual_seed(3), (4096, 2))
  assert torch.equal(a, b) and a.shape == (4096, 2)
  assert abs(float(a.std()) - 2.0) < 0.1


def test_flow_matching_learns_point_mass():
  """The JAX file's case on the port: a velocity net trained by flow
  matching transports N(0, 1) to a point mass at mu."""
  flow = RectifiedFlow(sigma=1.0, num_steps=30)
  mu = torch.tensor([2.0, -1.0])
  g = torch.Generator().manual_seed(0)
  net = torch.nn.Sequential(torch.nn.Linear(3, 64), torch.nn.ReLU(),
                            torch.nn.Linear(64, 2))

  def vel(x, t, cond):
    del cond
    return net(torch.cat([x, t[:, None]], -1))

  opt = create_optimizer("adam", 1e-2)
  opt_state = opt.init(net)
  x0 = mu.expand(256, 2)
  for _ in range(300):
    loss = flow_matching_loss(vel, g, x0, flow=flow)
    grads = torch.autograd.grad(loss, list(net.parameters()))
    updates, opt_state = opt.update(grads, opt_state)
    apply_updates(net, updates)
  with torch.no_grad():
    samples = flow.euler_ode(vel, g, (128, 2))
  err = (samples.mean(0) - mu).abs()
  assert bool((err < 0.3).all()), err


# ---- the networks -----------------------------------------------------------

@pytest.mark.parametrize("cfg", CONFIGS)
def test_five_nets_match_haiku(cfg):
  j_net, j_params, tree, net, params = dmz_nets(cfg)
  rng = np.random.default_rng(1)
  B, A = 6, cfg["num_actions"]
  obs = rng.standard_normal((B, 4)).astype(np.float32)
  action = rng.integers(0, A, B).astype(np.int32)
  x = rng.standard_normal((B, cfg["embedding_dim"])).astype(np.float32)
  tt = rng.uniform(size=B).astype(np.float32)

  @jax.jit
  def towers(p):
    s = j_net.representation.apply(p.representation, obs)
    after, av = j_net.decision.apply(p.decision, s, action)
    return (s, j_net.prediction.apply(p.prediction, s), (after, av),
            j_net.velocity.apply(p.velocity, x, tt, after),
            j_net.reward.apply(p.reward, after))

  s, pred, dec, vel, rew = jax.tree.map(np.asarray, towers(j_params))
  t = torch.from_numpy
  _close(params.representation(t(obs)), s)
  for port, ref in zip(params.prediction(t(s)), pred):
    _close(port, ref)
  for port, ref in zip(params.decision(t(s), t(action)), dec):
    _close(port, ref)
  _close(params.velocity(t(x), t(tt), t(dec[0])), vel)
  _close(params.reward(t(dec[0])), rew)
  assert float(params.temperature) == float(j_params.temperature) == 1.0
  # Back through the flat order of parameters() to the same haiku tree.
  back = dmz_grads_to_numpy(params, flat_parameters(params))
  for name in TOWERS:
    assert set(back[name]) == set(tree[name]), name
    for module, leaves in tree[name].items():
      for key, value in leaves.items():
        np.testing.assert_array_equal(back[name][module][key], value)


def test_networks_default_to_the_card():
  """Without ``device="cpu"`` the diffusion set (and so its agent and
  policy) runs on the card, and raises where there is none."""
  if torch.cuda.is_available():
    assert make_diffusion_mlp_networks(2).device.type == "cuda"
  else:
    with pytest.raises(RuntimeError, match="device='cpu'"):
      make_diffusion_mlp_networks(2)


def test_converter_refuses_a_tree_that_does_not_fit():
  small = make_diffusion_mlp_networks(device="cpu", **CONFIGS[0])
  params = small.init_params((4,))
  tree = dmz_grads_to_numpy(params, flat_parameters(params))
  net = make_diffusion_mlp_networks(device="cpu", **{**CONFIGS[0],
                                                     "hidden": (16, 16)})
  with pytest.raises(ValueError):
    dmz_params_from_numpy(tree, net)


def test_sample_candidates_and_mean_next_state_match_jax():
  cfg = CONFIGS[1]
  j_net, j_params, _, net, params = dmz_nets(cfg)
  B, C, E = 5, cfg["num_samples"], cfg["embedding_dim"]
  rng = np.random.default_rng(2)
  after = rng.uniform(size=(B, E)).astype(np.float32)
  prior = rng.standard_normal((B * C, E)).astype(np.float32)
  j_net.flow.prior_sampling = lambda rng_, shape: jnp.asarray(prior)
  ref = j_net.sample_candidates(j_params, jax.random.PRNGKey(0),
                                jnp.asarray(after))
  out = net.sample_candidates(params, None, torch.from_numpy(after),
                              prior=torch.from_numpy(prior))
  assert out.shape == (B, C, E)
  _close(out, ref, rtol=1e-4, atol=1e-6)
  _close(net.mean_next_state(params, torch.from_numpy(after)),
         j_net.mean_next_state(j_params, jnp.asarray(after)),
         rtol=1e-4, atol=1e-6)
  # Without an injected prior the generator draws one of the same shape.
  drawn = net.sample_candidates(params, torch.Generator().manual_seed(0),
                                torch.from_numpy(after), num_steps=2)
  assert drawn.shape == (B, C, E) and bool(torch.isfinite(drawn).all())


# ---- the loss ---------------------------------------------------------------

def jax_flow_draws(rng, B, E, L):
  """The (t, eps) pairs that ``diffusion_muzero_loss`` draws from ``rng``,
  step by step, as numpy."""
  draws = []
  for _ in range(L - 1):
    rng, t_rng, eps_rng = jax.random.split(rng, 3)
    draws.append((np.asarray(jax.random.uniform(t_rng, (B,), jnp.float32)),
                  np.asarray(jax.random.normal(eps_rng, (B, E),
                                               jnp.float32))))
  return draws


def torch_draws(draws, device="cpu"):
  return [(torch.tensor(t, device=device), torch.tensor(e, device=device))
          for t, e in draws]


def test_loss_and_grads_match_jax_grad():
  cfg = CONFIGS[1]
  j_net, j_params, _, net, params = dmz_nets(cfg)
  B, L = 16, 5
  arrays = batch_numpy(4, B=B, L=L, obs_dim=4,
                       num_actions=cfg["num_actions"])
  key = jax.random.PRNGKey(7)
  ref_grads, ref = jax.jit(jax.grad(
      lambda p, b: j_loss(p, b, j_net, key, **KW), has_aux=True))(
          j_params, jax_batch(arrays))
  draws = torch_draws(jax_flow_draws(key, B, cfg["embedding_dim"], L))
  grads, metrics = diffusion_muzero_grad(params, torch_batch(arrays), net,
                                         None, draws=draws, **KW)
  port = dmz_grads_to_numpy(params, grads)
  for name in TOWERS:
    ref_tree = jax.tree.map(np.asarray, getattr(ref_grads, name))
    for module, leaves in ref_tree.items():
      for k, value in leaves.items():
        np.testing.assert_allclose(port[name][module][k], value,
                                   rtol=1e-4, atol=1e-6,
                                   err_msg=f"{name}/{module}/{k}")
  for name in METRICS:
    np.testing.assert_allclose(float(getattr(metrics, name)),
                               float(getattr(ref, name)), rtol=1e-5,
                               err_msg=name)
  np.testing.assert_allclose(metrics.priorities.numpy(),
                             np.asarray(ref.priorities), rtol=1e-4,
                             atol=1e-6)


def test_loss_masks_post_terminal_steps_and_draws_from_generator():
  """The JAX file's mask case on the port: the loss is blind to what lies
  past the mask, and without injected draws the generator's give the same
  loss for the same seed."""
  _, _, _, net, params = dmz_nets(CONFIGS[0])
  arrays = batch_numpy(5, B=16, L=6, obs_dim=4, num_actions=3,
                       with_masks=False)
  arrays["mask"][:, 3:] = 0.0
  b1 = torch_batch(arrays)
  for name in ("obs", "reward", "rn"):
    arrays[name][:, 4:] = 1e6
  b2 = torch_batch(arrays)
  t1, m1 = diffusion_muzero_loss(params, b1, net,
                                 torch.Generator().manual_seed(2))
  t2, _ = diffusion_muzero_loss(params, b2, net,
                                torch.Generator().manual_seed(2))
  np.testing.assert_allclose(float(t1), float(t2), rtol=1e-5)
  assert m1.priorities.shape == (16,)
  for name in METRICS:
    assert np.isfinite(float(getattr(m1, name))), name


# ---- the search policy ------------------------------------------------------

def test_policy_matches_jax_with_deterministic_samples():
  """The search over the agents' closures (root, decision with a uniform
  chance prior, flow sampling, chance evaluation) on both sides, each flow
  drawing the same fixed prior."""
  cfg, sims, max_depth = CONFIGS[0], 16, 4
  j_net, j_params, _, net, params = dmz_nets(cfg)
  B, C, E = 4, cfg["num_samples"], cfg["embedding_dim"]
  rng = np.random.default_rng(3)
  obs = rng.standard_normal((B, 4)).astype(np.float32)
  prior = rng.standard_normal((B * C, E)).astype(np.float32)
  j_net.flow.prior_sampling = lambda rng_, shape: jnp.asarray(prior)
  net.flow.prior_sampling = lambda generator, shape: torch.from_numpy(prior)
  j_agent, agent = JDiffusionMuZero(j_net), DiffusionMuZero(net)
  kw = dict(num_simulations=sims, num_samples=C, max_depth=max_depth,
            dirichlet_fraction=0.0, discount=0.95)
  j_out = jax.jit(functools.partial(
      j_policy, decision_recurrent_fn=j_agent._decision_fn,
      sample_fn=j_agent._sample_fn, chance_eval_fn=j_agent._chance_eval_fn,
      **kw))(j_params, jax.random.PRNGKey(1),
             j_agent._root_fn(j_params, obs))
  out = diffusion_muzero_policy(
      params, torch.Generator().manual_seed(1),
      agent._root_fn(params, torch.from_numpy(obs)),
      decision_recurrent_fn=agent._decision_fn, sample_fn=agent._sample_fn,
      chance_eval_fn=agent._chance_eval_fn, **kw)
  ref_summary = j_out.search_tree.summary()
  summary = out.search_tree.summary()
  visits = summary.visit_counts.numpy()
  assert np.abs(visits - np.asarray(ref_summary.visit_counts)).max() <= 2
  np.testing.assert_array_equal(visits[:, :3].sum(-1), sims)
  np.testing.assert_allclose(summary.value.numpy(),
                             np.asarray(ref_summary.value), rtol=1e-3,
                             atol=1e-3)
  np.testing.assert_allclose(out.action_weights.sum(-1).numpy(), 1.0,
                             rtol=1e-6)


def test_policy_finds_best_action():
  """The JAX file's case: afterstate = state + action, candidates =
  afterstate + small noise, reward = the committed state's first
  coordinate, so action 2 is best."""
  num_actions, num_samples = 3, 4

  def decision_fn(params, generator, action, state):
    batch = action.shape[0]
    return mx.DecisionRecurrentFnOutput(
        chance_logits=torch.zeros(batch, num_samples),
        afterstate_value=torch.zeros(batch)), state + action[:, None].float()

  def sample_fn(params, generator, afterstate):
    noise = 0.01 * torch.randn((afterstate.shape[0], num_samples)
                               + tuple(afterstate.shape[1:]),
                               generator=generator)
    return afterstate[:, None] + noise

  def chance_eval_fn(params, generator, next_state):
    batch = next_state.shape[0]
    return mx.ChanceRecurrentFnOutput(
        action_logits=torch.zeros(batch, num_actions),
        value=torch.zeros(batch), reward=next_state[:, 0])

  root = mx.RootFnOutput(prior_logits=torch.zeros(2, num_actions),
                         value=torch.zeros(2), embedding=torch.zeros(2, 2))
  out = diffusion_muzero_policy(
      (), torch.Generator().manual_seed(0), root,
      decision_recurrent_fn=decision_fn, sample_fn=sample_fn,
      chance_eval_fn=chance_eval_fn, num_simulations=96,
      num_samples=num_samples, dirichlet_fraction=0.0, temperature=0.0,
      discount=0.5)
  assert out.action.tolist() == [2, 2]
  assert out.action_weights.shape == (2, num_actions)
  np.testing.assert_allclose(out.action_weights.sum(-1).numpy(), 1.0,
                             rtol=1e-6)


def test_policy_alternates_decision_and_chance_levels():
  """The JAX file's case: every visited node's type differs from its
  parent's, and the samples are stored [B, N, C, E] in their own order."""
  num_actions, num_samples = 2, 3

  def decision_fn(params, generator, action, state):
    batch = action.shape[0]
    return mx.DecisionRecurrentFnOutput(
        chance_logits=torch.zeros(batch, num_samples),
        afterstate_value=torch.zeros(batch)), state + 1.0

  def sample_fn(params, generator, afterstate):
    offsets = torch.arange(num_samples, dtype=torch.float32)[None, :, None]
    return afterstate[:, None] + 10.0 * offsets

  def chance_eval_fn(params, generator, next_state):
    batch = next_state.shape[0]
    return mx.ChanceRecurrentFnOutput(
        action_logits=torch.zeros(batch, num_actions),
        value=torch.zeros(batch), reward=torch.zeros(batch))

  root = mx.RootFnOutput(prior_logits=torch.zeros(1, num_actions),
                         value=torch.zeros(1), embedding=torch.zeros(1, 2))
  out = diffusion_muzero_policy(
      (), torch.Generator().manual_seed(0), root,
      decision_recurrent_fn=decision_fn, sample_fn=sample_fn,
      chance_eval_fn=chance_eval_fn, num_simulations=12,
      num_samples=num_samples)
  tree = out.search_tree
  emb = tree.embeddings
  assert emb.is_decision_node.dtype == torch.bool
  assert emb.next_state_samples.shape == (1, 13, num_samples, 2)
  is_dec = emb.is_decision_node[0]
  visits = tree.node_visits[0]
  parents = tree.parents[0]
  for node in range(1, 13):
    if visits[node] == 0:
      continue
    assert bool(is_dec[node]) != bool(is_dec[parents[node]])
    if not bool(is_dec[node]):  # an afterstate: its samples in slot order
      samples = emb.next_state_samples[0, node]
      np.testing.assert_allclose(
          (samples - samples[0]).numpy()[:, 0], [0.0, 10.0, 20.0])
