"""The port's Stochastic MuZero five-network set against the JAX package's:
the converter (``smz_params_from_numpy`` and back), and each net's outputs
on the same seeded inputs and the same weights (rtol 1e-5, atol 1e-6: the
same f32 products in another order), the straight-through code and the
inference closures of ``make_smz_fns``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muax_tpu.models import make_stochastic_mlp_networks as j_make
from muax_tpu.models.stochastic_networks import \
    straight_through_code as j_straight_through
from muax_tpu.train.inference import make_smz_fns as j_make_smz_fns
from muax_tpu_torch.models import (SMZParams, make_stochastic_mlp_networks,
                                   smz_params_from_numpy)
from muax_tpu_torch.models.convert import smz_grads_to_numpy
from muax_tpu_torch.models.optimizers import flat_parameters
from muax_tpu_torch.models.stochastic_networks import straight_through_code
from muax_tpu_torch.train.inference import make_smz_fns

TOWERS = SMZParams.TOWERS
# tests/test_fused_smz.py's sizes (whose nets the search tests and the
# inference closures run), and a deeper and a shallower variant.
CONFIGS = [
    dict(num_actions=3, num_chance_outcomes=4, embedding_dim=8,
         support_size=10, hidden=(16,)),
    dict(num_actions=2, num_chance_outcomes=6, embedding_dim=6,
         support_size=5, hidden=(12, 10)),
    dict(num_actions=4, num_chance_outcomes=3, embedding_dim=5,
         support_size=4, hidden=()),
]
RTOL, ATOL = 1e-5, 1e-6


def smz_nets(cfg, obs_dim=5, seed=0):
  """JAX networks and params, the numpy tree, and the port's networks and
  params (on the CPU) from the same numbers."""
  j_net = j_make(**cfg)
  j_params = j_net.init_params(jax.random.PRNGKey(seed),
                               jnp.zeros((1, obs_dim)))
  tree = {name: jax.tree.map(np.asarray, getattr(j_params, name))
          for name in TOWERS}
  net = make_stochastic_mlp_networks(device="cpu", **cfg)
  return j_net, j_params, tree, net, smz_params_from_numpy(tree, net)


def _close(port, ref):
  np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                             rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cfg", CONFIGS[1:])
def test_five_nets_match_haiku(cfg):
  j_net, j_params, _, net, params = smz_nets(cfg)
  rng = np.random.default_rng(1)
  B, A, C = 6, cfg["num_actions"], cfg["num_chance_outcomes"]
  obs = rng.standard_normal((B, 5)).astype(np.float32)
  action = rng.integers(0, A, B).astype(np.int32)
  code = np.eye(C, dtype=np.float32)[rng.integers(0, C, B)]
  t = torch.from_numpy

  _close(params.encoder(t(obs)),
         j_net.encoder.apply(j_params.encoder, obs))
  s = j_net.representation.apply(j_params.representation, obs)
  _close(params.representation(t(obs)), s)
  s = np.array(s)
  for port, ref in zip(params.prediction(t(s)),
                       j_net.prediction.apply(j_params.prediction, s)):
    _close(port, ref)
  ref_dec = j_net.decision.apply(j_params.decision, s, action)
  for port, ref in zip(params.decision(t(s), t(action)), ref_dec):
    _close(port, ref)
  after = np.array(ref_dec[0])
  for port, ref in zip(params.chance(t(after), t(code)),
                       j_net.chance.apply(j_params.chance, after, code)):
    _close(port, ref)
  assert float(params.temperature) == float(j_params.temperature) == 1.0


@pytest.mark.parametrize("cfg", CONFIGS[:2])
def test_converter_round_trip_and_order(cfg):
  """The tree into the port's modules and back through the flat buffer is
  the same tree; a tree that does not fit raises."""
  _, _, tree, net, params = smz_nets(cfg)
  back = smz_grads_to_numpy(params, flat_parameters(params))
  for name in TOWERS:
    assert set(back[name]) == set(tree[name])
    for module, leaves in tree[name].items():
      for key, ref in leaves.items():
        np.testing.assert_array_equal(back[name][module][key], ref)
  # haiku's creation order: the decision tower's heads are afterstate,
  # chance, value; prediction's are policy, value.
  heads = [m.out_features for m in params.decision.heads]
  assert heads == [cfg["embedding_dim"], cfg["num_chance_outcomes"],
                   2 * cfg["support_size"] + 1]
  assert params.prediction.heads[0].out_features == cfg["num_actions"]
  bad = dict(tree, chance={"linear": tree["chance"]["linear"]})
  with pytest.raises(ValueError, match="chance"):
    smz_params_from_numpy(bad, net)


def test_straight_through_code():
  rng = np.random.default_rng(2)
  logits = rng.standard_normal((5, 7)).astype(np.float32)
  x = torch.from_numpy(logits).requires_grad_(True)
  code = straight_through_code(x)
  np.testing.assert_allclose(code.detach().numpy(),
                             np.asarray(j_straight_through(logits)),
                             rtol=0, atol=1e-7)
  # The gradient is the softmax's.
  weights = torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32))
  (g,) = torch.autograd.grad((code * weights).sum(), x)
  ref = jax.grad(lambda z: jnp.sum(j_straight_through(z) * weights.numpy()))(
      logits)
  np.testing.assert_allclose(g.numpy(), np.asarray(ref), rtol=1e-5,
                             atol=1e-7)


def test_inference_closures_match():
  cfg = CONFIGS[0]
  j_net, j_params, _, net, params = smz_nets(cfg)
  rng = np.random.default_rng(3)
  obs = rng.standard_normal((4, 5)).astype(np.float32)
  j_root_fn, j_dec_fn, j_ch_fn = j_make_smz_fns(j_net, 0.95)
  root_fn, dec_fn, ch_fn = make_smz_fns(net, 0.95)
  j_root = j_root_fn(j_params, obs)
  with torch.no_grad():
    root = root_fn(params, torch.from_numpy(obs))
    _close(root.prior_logits, j_root.prior_logits)
    _close(root.value, j_root.value)
    _close(root.embedding, j_root.embedding)
    state = np.asarray(j_root.embedding)
    action = np.array([0, 2, 1, 2], np.int32)
    j_out, j_after = j_dec_fn(j_params, None, action, state)
    out, after = dec_fn(params, None, torch.from_numpy(action),
                        torch.from_numpy(state))
    _close(after, j_after)
    _close(out.chance_logits, j_out.chance_logits)
    _close(out.afterstate_value, j_out.afterstate_value)
    outcome = np.array([3, 0, 1, 2], np.int32)
    j_out, j_next = j_ch_fn(j_params, None, outcome, np.asarray(j_after))
    out, nxt = ch_fn(params, None, torch.from_numpy(outcome),
                     torch.from_numpy(np.asarray(j_after)))
    _close(nxt, j_next)
    for name in ("action_logits", "value", "reward"):
      _close(getattr(out, name), getattr(j_out, name))
