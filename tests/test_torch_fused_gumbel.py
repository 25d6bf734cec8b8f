"""The port's fused Gumbel MuZero search against the JAX package's Pallas
kernel in its Gumbel mode.

On the CPU the port's ``fused_gumbel_search`` runs its plain PyTorch version;
the JAX kernel runs in Pallas interpret mode, as ``tests/test_fused.py``
runs it. Both get the same seeded numpy roots, the same Gumbel noise and the
same weights. Sequential halving is deterministic given the noise, so the
visits must agree exactly (``tests/test_fused.py:175-180``); root value and
completed q within rtol = atol = 1e-3, the policy's weights within rtol 1e-4
/ atol 1e-5 and its actions exactly (``tests/test_fused.py:196-202``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muax_tpu.search import fused as jfused
from muax_tpu.search.types import RootFnOutput as JRoot
from muax_tpu_torch.search import fused
from muax_tpu_torch.search.types import RootFnOutput

from test_torch_fused_search import SUPPORT, _nets, _roots, _torch


def _gumbel(seed, batch, num_actions):
  return np.random.default_rng(seed + 100).gumbel(
      size=(batch, num_actions)).astype(np.float32)


def _jax_and_port(sims, num_actions, hidden, invalid_kind, max_depth,
                  max_considered, batch=16, discount=0.97):
  j_net, j_params, net, params = _nets(num_actions, hidden)
  emb, logits, value, invalid = _roots(sims, batch, num_actions,
                                       invalid_kind is not None)
  if invalid_kind == "all":
    invalid = np.ones((batch, num_actions), np.float32)
    logits = np.full_like(logits, -1e9)
  gumbel = _gumbel(sims, batch, num_actions)
  kwargs = dict(gumbel=gumbel, max_num_considered_actions=max_considered,
                num_simulations=sims, support_size=SUPPORT,
                discount=discount, max_depth=max_depth)
  ref = jfused.fused_gumbel_search(
      jnp.asarray(emb), jnp.asarray(logits), jnp.asarray(value),
      jfused.extract_fused_weights(j_net, j_params),
      invalid_actions=None if invalid is None else jnp.asarray(invalid),
      **{**kwargs, "gumbel": jnp.asarray(gumbel)})
  before = (fused.launches, fused.gumbel_launches)
  out = fused.fused_gumbel_search(
      _torch(emb), _torch(logits), _torch(value),
      fused.extract_fused_weights(net, params),
      invalid_actions=_torch(invalid),
      **{**kwargs, "gumbel": _torch(gumbel)})
  assert (fused.launches, fused.gumbel_launches) == before  # plain version
  return [np.asarray(x) for x in ref], [x.numpy() for x in out], invalid


@pytest.mark.parametrize("sims,num_actions,hidden,invalid,max_depth,m", [
    (24, 4, (16,), None, None, 4),
    (24, 3, (16,), None, None, 16),
    (15, 4, (16, 16), "half", 2, 4),
    (32, 2, (16,), "half", None, 16),
])
def test_plain_matches_jax_kernel(sims, num_actions, hidden, invalid,
                                  max_depth, m):
  """``half``: the last action invalid on every other row, so those rows
  consider one action fewer (a schedule of 3 actions for A = 4)."""
  ref, out, invalid = _jax_and_port(sims, num_actions, hidden, invalid,
                                    max_depth, m)
  np.testing.assert_array_equal(out[0].sum(-1), np.full(len(out[0]), sims))
  np.testing.assert_array_equal(out[0], ref[0])
  np.testing.assert_allclose(out[1], ref[1], rtol=1e-3, atol=1e-3)
  np.testing.assert_allclose(out[2], ref[2], rtol=1e-3, atol=1e-3)
  if invalid is not None:
    assert np.all(out[0][invalid > 0] == 0.0)


def test_all_masked_root_picks_action_zero():
  """Every action invalid: no root score is eligible, so every simulation
  takes action 0, as the JAX kernel's lowest-row tie-break does."""
  ref, out, _ = _jax_and_port(12, 3, (16,), "all", None, 4, batch=4)
  np.testing.assert_array_equal(out[0], ref[0])
  np.testing.assert_array_equal(out[0], np.tile([12.0, 0.0, 0.0], (4, 1)))
  assert np.all(np.isfinite(out[1])) and np.all(np.isfinite(out[2]))


def test_invalid_actions_never_visited():
  _, _, net, params = _nets(4, (16,))
  emb, logits, value, _ = _roots(3, 8, 4, False)
  invalid = np.zeros((8, 4), np.float32)
  invalid[:, 1] = 1.0
  visits, _, _ = fused.fused_gumbel_search(
      _torch(emb), _torch(np.where(invalid > 0, -1e9, logits)),
      _torch(value), fused.extract_fused_weights(net, params),
      gumbel=_torch(_gumbel(3, 8, 4)), max_num_considered_actions=4,
      num_simulations=12, support_size=SUPPORT, discount=0.99,
      invalid_actions=_torch(invalid))
  np.testing.assert_array_equal(visits.sum(-1).numpy(), 12.0)
  assert float(visits[:, 1].abs().max()) == 0.0


@pytest.mark.parametrize("with_invalid", [False, True])
def test_policy_matches_jax(with_invalid):
  """The port's policy with the JAX policy's own Gumbel draw injected."""
  j_net, j_params, net, params = _nets(4, (16,))
  emb, logits, value, invalid = _roots(5, 8, 4, with_invalid)
  rng = jax.random.PRNGKey(5)
  _, gumbel_rng, _ = jax.random.split(rng, 3)
  gumbel = jax.random.gumbel(gumbel_rng, (8, 4), jnp.float32)
  kwargs = dict(num_simulations=16, support_size=SUPPORT, discount=0.99,
                max_num_considered_actions=4)
  j_inv = None if invalid is None else jnp.asarray(invalid)
  ref = jfused.fused_mlp_gumbel_policy(
      j_params, rng,
      JRoot(prior_logits=jnp.asarray(logits), value=jnp.asarray(value),
            embedding=jnp.asarray(emb)),
      jfused.extract_fused_weights(j_net, j_params), invalid_actions=j_inv,
      **kwargs)
  action, weights, root_value = fused.fused_mlp_gumbel_policy(
      params, torch.Generator().manual_seed(0),
      RootFnOutput(prior_logits=_torch(logits), value=_torch(value),
                   embedding=_torch(emb)),
      fused.extract_fused_weights(net, params),
      invalid_actions=_torch(invalid), gumbel=_torch(np.array(gumbel)),
      **kwargs)
  assert action.dtype == torch.int32
  np.testing.assert_array_equal(action.numpy(), np.asarray(ref[0]))
  np.testing.assert_allclose(weights.numpy(), np.asarray(ref[1]),
                             rtol=1e-4, atol=1e-5)
  np.testing.assert_allclose(root_value.numpy(), np.asarray(ref[2]),
                             rtol=1e-3, atol=1e-3)


def test_policy_draws_its_noise_from_the_generator():
  _, _, net, params = _nets(3, (16,))
  emb, logits, value, _ = _roots(7, 16, 3, False)
  root = RootFnOutput(prior_logits=_torch(logits), value=_torch(value),
                      embedding=_torch(emb))

  def run(seed):
    return fused.fused_mlp_gumbel_policy(
        params, torch.Generator().manual_seed(seed), root,
        fused.extract_fused_weights(net, params), num_simulations=8,
        support_size=SUPPORT, discount=0.99)

  a1, w1, _ = run(1)
  a2, w2, _ = run(1)
  assert torch.equal(a1, a2) and torch.equal(w1, w2)
  torch.testing.assert_close(w1.sum(-1), torch.ones(16))
  actions = torch.stack([run(seed)[0] for seed in range(2, 8)])
  assert len(torch.unique(actions)) > 1  # the noise reaches the action
