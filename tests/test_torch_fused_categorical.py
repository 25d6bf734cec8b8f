"""The port's fused search in its categorical modes (LayerNorm-tanh towers,
linear [vmin, vmax] two-hot decode) against the JAX package's Pallas kernel
on a ``FusedNetSpec``, in interpret mode as ``tests/test_fused.py:124-141``
runs it.

On the CPU the port runs its plain PyTorch version. Both sides get the same
seeded numpy roots and the same weights (the JAX tests' small widths: 3
actions, embedding 16, 21 bins, towers (32, 32)). MuZero: at most 2 visits
apart, value rtol = atol = 1e-3 (``tests/test_fused.py:138-141``); Gumbel:
the same visits exactly and value and completed q within rtol = atol = 1e-3
(``tests/test_fused.py:175-180``); with and without invalid actions. The
kernel itself is held against the plain version on the card in
``tests/test_torch_categorical_kernels.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muax_tpu.search import fused as jfused
from muax_tpu_torch.config import MuZeroConfig, SearchConfig, TrainConfig
from muax_tpu_torch.envs import AutoResetWrapper, CartPole
from muax_tpu_torch.models import make_categorical_mlp_networks
from muax_tpu_torch.search import fused
from muax_tpu_torch.train import make_rollout_fn
from muax_tpu_torch.train.actor import uses_fused_search
from tests.test_torch_acme_networks import acme_nets

EMBED, A = 16, 3


def _roots(seed, batch, with_invalid):
  rng = np.random.default_rng(seed)
  emb = rng.uniform(0, 1, (batch, EMBED)).astype(np.float32)
  logits = rng.standard_normal((batch, A)).astype(np.float32)
  value = (rng.standard_normal(batch) * 2).astype(np.float32)
  invalid = None
  if with_invalid:
    invalid = np.zeros((batch, A), np.float32)
    invalid[::2, A - 1] = 1.0
    logits = np.where(invalid > 0, -1e9, logits).astype(np.float32)
  return emb, logits, value, invalid


def _t(x):
  return None if x is None else torch.from_numpy(x)


def test_spec_parses_layernorm_towers():
  j_net, j_params, net, params = acme_nets()
  spec = fused.extract_categorical_fused_weights(net, params)
  ref = jfused.extract_categorical_fused_weights(j_net, j_params)
  assert spec.decode == "linear" and spec.num_bins == 21
  assert [k for k, _ in spec.dyn_layers] == ["ln_tanh", "elu"]
  assert [k for k, _ in spec.pred_layers] == [k for k, _ in ref.pred_layers]
  for ours, theirs in ((spec.pred_policy, ref.pred_policy),
                       (spec.pred_value, ref.pred_value),
                       (spec.dyn_layers[0][1], ref.dyn_layers[0][1])):
    for a, b in zip(ours, theirs):
      np.testing.assert_array_equal(a.numpy().reshape(-1),
                                    np.asarray(b).reshape(-1))
  fc = acme_nets("fc_resnet")
  assert fused.extract_categorical_fused_weights(fc[2], fc[3]) is None
  assert fused.extract_search_weights(net, params) is not None
  assert not uses_fused_search(fc[2], MuZeroConfig())


@pytest.mark.parametrize("policy,with_invalid,max_depth", [
    ("muzero", False, None), ("muzero", True, 2),
    ("gumbel", False, None), ("gumbel", True, 2)])
def test_plain_matches_jax_kernel(policy, with_invalid, max_depth):
  j_net, j_params, net, params = acme_nets()
  sims, batch, discount = 20, 6, 0.99
  emb, logits, value, invalid = _roots(sims + int(with_invalid), batch,
                                       with_invalid)
  j_spec = jfused.extract_categorical_fused_weights(j_net, j_params)
  spec = fused.extract_categorical_fused_weights(net, params)
  kw = dict(num_simulations=sims, discount=discount, max_depth=max_depth)
  j_inv = None if invalid is None else jnp.asarray(invalid)
  counters = (fused.categorical_launches, fused.categorical_gumbel_launches)
  if policy == "muzero":
    ref = jfused._fused_search(jnp.asarray(emb), jnp.asarray(logits),
                               jnp.asarray(value), j_spec, policy="muzero",
                               invalid_actions=j_inv, **kw)
    out = fused.fused_muzero_search(_t(emb), _t(logits), _t(value), spec,
                                    invalid_actions=_t(invalid), **kw)
  else:
    gumbel = np.random.default_rng(7).gumbel(size=(batch, A)).astype(
        np.float32)
    ref = jfused.fused_gumbel_search(
        jnp.asarray(emb), jnp.asarray(logits), jnp.asarray(value), j_spec,
        gumbel=jnp.asarray(gumbel), max_num_considered_actions=4,
        invalid_actions=j_inv, **kw)
    out = fused.fused_gumbel_search(
        _t(emb), _t(logits), _t(value), spec, gumbel=_t(gumbel),
        max_num_considered_actions=4, invalid_actions=_t(invalid), **kw)
  assert (fused.categorical_launches,
          fused.categorical_gumbel_launches) == counters  # plain version
  visits, ref_visits = out[0].numpy(), np.asarray(ref[0])
  np.testing.assert_array_equal(visits.sum(-1), np.full(batch, sims))
  if policy == "gumbel":
    np.testing.assert_array_equal(visits, ref_visits)
    np.testing.assert_allclose(out[2].numpy(), np.asarray(ref[2]), rtol=1e-3,
                               atol=1e-3)
  else:
    assert np.abs(visits - ref_visits).max() <= 2
  np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]), rtol=1e-3,
                             atol=1e-3)
  if invalid is not None:
    assert np.all(visits[invalid > 0] == 0.0)


@pytest.mark.parametrize("policy", ["muzero", "gumbel"])
def test_rollout_takes_the_categorical_mode(policy):
  """make_rollout_fn with categorical networks goes through the fused
  search (its plain version here) and writes finite segments."""
  net = make_categorical_mlp_networks(2, embedding_dim=8, num_bins=11,
                                      layer_sizes=(16, 16), device="cpu")
  params = net.init_params((4,), torch.Generator().manual_seed(0))
  config = MuZeroConfig(search=SearchConfig(policy=policy, num_simulations=6),
                        train=TrainConfig(num_envs=4, collect_steps=3))
  env = AutoResetWrapper(CartPole())
  rollout = make_rollout_fn(net, env, config, device="cpu")
  gen = torch.Generator().manual_seed(0)
  carry, seg, prio, _ = rollout(params, env.reset(gen, 4), gen,
                                params.temperature)
  assert tuple(seg.pi.shape) == (4, 3, 2)
  torch.testing.assert_close(seg.pi.sum(-1), torch.ones(4, 3))
  assert bool(torch.isfinite(prio).all() and torch.isfinite(seg.value).all())
