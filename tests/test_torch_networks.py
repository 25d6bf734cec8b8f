"""The port's MLP triplet and inference closures against the JAX package:
haiku parameters, turned into numpy and converted, give the same embedding,
logits and values.

Tolerances: atol 1e-5 on the outputs of the f32 dense layers (embedding,
policy, value and reward logits). Decoded scalars get atol 5e-4, rtol 1e-4:
logits that agree to 1e-6 move the expectation over the bins -S..S (S = 20)
by up to 20 times that, and h^-1 multiplies by its slope 2 sqrt(|v| + 1)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muax_tpu.models import make_mlp_networks as j_make
from muax_tpu.train.inference import make_recurrent_fn as j_recurrent
from muax_tpu.train.inference import make_root_fn as j_root
from muax_tpu_torch.models import make_mlp_networks, mlp_params_from_numpy
from muax_tpu_torch.train.inference import make_recurrent_fn, make_root_fn

TOWERS = ("representation", "prediction", "dynamic")


def _numpy_tree(params):
  return {name: jax.tree.map(np.asarray, getattr(params, name))
          for name in TOWERS}


def _pair(hidden, num_actions=2, support=20, obs_dim=4):
  kwargs = dict(repr_layers=hidden, pred_layers=hidden, dyn_layers=hidden)
  j_net = j_make(num_actions, embedding_dim=8, support_size=support, **kwargs)
  j_params = j_net.init_params(jax.random.PRNGKey(0),
                               jnp.zeros((1, obs_dim)))
  net = make_mlp_networks(num_actions, embedding_dim=8, support_size=support,
                          device="cpu", **kwargs)
  params = mlp_params_from_numpy(_numpy_tree(j_params), net)
  return j_net, j_params, net, params


def _close(port, ref, atol=1e-5, rtol=1e-5):
  np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                             atol=atol, rtol=rtol)


def _close_decoded(port, ref):
  _close(port, ref, atol=5e-4, rtol=1e-4)


@pytest.mark.parametrize("hidden", [(16,), (16, 16)])
def test_root_fn_matches_jax(hidden):
  j_net, j_params, net, params = _pair(hidden)
  obs = np.random.default_rng(1).standard_normal((32, 4)).astype(np.float32)
  ref = j_root(j_net)(j_params, jnp.asarray(obs))
  out = make_root_fn(net)(params, torch.from_numpy(obs))
  _close(out.embedding, ref.embedding)
  _close(out.prior_logits, ref.prior_logits)
  _close(params.prediction(out.embedding)[1],
         j_net.prediction.apply(j_params.prediction, ref.embedding)[1])
  _close_decoded(out.value, ref.value)


@pytest.mark.parametrize("hidden", [(16,), (16, 16)])
def test_recurrent_fn_matches_jax(hidden):
  j_net, j_params, net, params = _pair(hidden, num_actions=3)
  rng = np.random.default_rng(2)
  emb = rng.uniform(0, 1, (32, 8)).astype(np.float32)
  action = rng.integers(0, 3, 32)
  ref, ref_next = j_recurrent(j_net, 0.997)(
      j_params, None, jnp.asarray(action, jnp.int32), jnp.asarray(emb))
  out, nxt = make_recurrent_fn(net, 0.997)(
      params, None, torch.from_numpy(action), torch.from_numpy(emb))
  _close(nxt, ref_next)
  _close(out.prior_logits, ref.prior_logits)
  _close(params.dynamic(torch.from_numpy(emb), torch.from_numpy(action))[0],
         j_net.dynamic.apply(j_params.dynamic, jnp.asarray(emb),
                             jnp.asarray(action, jnp.int32))[0])
  _close_decoded(out.reward, ref.reward)
  _close_decoded(out.value, ref.value)
  _close(out.discount, ref.discount)


def test_converter_rejects_mismatched_tree():
  j_net, j_params, net, _ = _pair((16,))
  narrow = make_mlp_networks(2, embedding_dim=8, support_size=10,
                             device="cpu")
  with pytest.raises(ValueError):
    mlp_params_from_numpy(_numpy_tree(j_params), narrow)
  tree = _numpy_tree(j_params)
  tree["dynamic"] = {"conv": tree["dynamic"]["linear"]}
  with pytest.raises(ValueError):
    mlp_params_from_numpy(tree, net)


def test_init_matches_haiku_statistics():
  """Own init: truncated normal (two std) with std 1/sqrt(fan_in), zero
  bias, reproducible from a generator."""
  net = make_mlp_networks(2, embedding_dim=64, support_size=20,
                          repr_layers=(256,), device="cpu")
  params = net.init_params((400,), torch.Generator().manual_seed(0))
  again = net.init_params((400,), torch.Generator().manual_seed(0))
  w = params.representation.hidden[0].weight.detach()
  assert w.shape == (256, 400)
  std = 1.0 / np.sqrt(400)
  assert float(w.abs().max()) <= 2 * std
  # Truncation at two std leaves 0.88 of the std.
  np.testing.assert_allclose(float(w.std()), 0.8796 * std, rtol=0.02)
  assert float(params.representation.hidden[0].bias.detach().abs().max()) == 0.0
  torch.testing.assert_close(w, again.representation.hidden[0].weight)
  assert float(params.temperature) == 1.0
