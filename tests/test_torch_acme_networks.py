"""The port's acme families (``muax_tpu_torch/models/acme_networks.py``)
against the JAX package's haiku modules, and the categorical loss and
decoder against the JAX package's, on the same numbers.

The modules get the haiku parameters through ``mlp_params_from_numpy`` and
must give the same outputs within atol 1e-5 (f32 matmuls and LayerNorms
summed in another order); the flat parameter buffer must convert back to
the same haiku tree exactly. ``muzero_loss`` with linear two-hot targets
and its autograd gradients are held against ``jax.grad`` at the tolerances
of ``tests/test_fused_learner.py:67-79`` (gradients rtol 2e-4 / atol 1e-6,
metrics rtol 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muax_tpu.models import acme_networks as jacme
from muax_tpu.models.losses import _target_codec as j_codec
from muax_tpu.models.losses import muzero_loss as j_loss
from muax_tpu.train.inference import make_recurrent_fn as j_recurrent_fn
from muax_tpu.train.inference import make_root_fn as j_root_fn
from muax_tpu_torch.models import (make_categorical_mlp_networks,
                                   make_fc_resnet_networks,
                                   mlp_params_from_numpy)
from muax_tpu_torch.models.convert import mlp_grads_to_numpy
from muax_tpu_torch.models.losses import _target_codec, muzero_grad
from muax_tpu_torch.models.optimizers import flat_parameters
from muax_tpu_torch.train.inference import make_recurrent_fn, make_root_fn
from tests.test_torch_parity import (TOWERS, assert_trees_close, batch_numpy,
                                     jax_batch, torch_batch)

# The JAX tests' small categorical widths (tests/test_fused.py:103-105).
CATEGORICAL = dict(num_actions=3, embedding_dim=16, num_bins=21, vmin=-10.0,
                   vmax=10.0, layer_sizes=(32, 32))
FC_RESNET = dict(num_actions=3, embedding_dim=16, num_bins=11, vmin=0.0,
                 vmax=10.0, num_blocks=2)
FAMILIES = {
    "categorical": (jacme.make_categorical_mlp_networks,
                    make_categorical_mlp_networks, CATEGORICAL),
    "fc_resnet": (jacme.make_fc_resnet_networks, make_fc_resnet_networks,
                  FC_RESNET),
}


def acme_nets(family="categorical", obs_dim=4, seed=0, **overrides):
  """JAX networks and params of ``family``, and the port's (on the CPU)
  from the same numbers."""
  j_make, make, cfg = FAMILIES[family]
  cfg = {**cfg, **overrides}
  j_net = j_make(**cfg)
  j_params = j_net.init_params(jax.random.PRNGKey(seed),
                               jnp.zeros((1, obs_dim)))
  tree = {name: jax.tree.map(np.asarray, getattr(j_params, name))
          for name in TOWERS}
  net = make(device="cpu", **cfg)
  return j_net, j_params, net, mlp_params_from_numpy(tree, net)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_modules_match_haiku(family):
  j_net, j_params, net, params = acme_nets(family, obs_dim=5)
  rng = np.random.default_rng(0)
  obs = rng.standard_normal((6, 5)).astype(np.float32)
  action = rng.integers(0, 3, 6).astype(np.int32)
  s_j = j_net.representation.apply(j_params.representation, jnp.asarray(obs))
  with torch.no_grad():
    s = params.representation(torch.from_numpy(obs))
    outs = [s, *params.prediction(s),
            *params.dynamic(s, torch.from_numpy(action))]
  refs = [s_j, *j_net.prediction.apply(j_params.prediction, s_j),
          *j_net.dynamic.apply(j_params.dynamic, s_j, jnp.asarray(action))]
  for out, ref in zip(outs, refs):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_flat_buffer_round_trip(family):
  """The flat buffer converts back into the haiku tree exactly, and the
  categorical towers keep haiku's creation order (policy head before the
  value head)."""
  _, j_params, _, params = acme_nets(family)
  back = mlp_grads_to_numpy(params, flat_parameters(params))
  assert_trees_close(back, j_params._asdict(), rtol=0, atol=0)
  names = [n for n, _ in params.prediction.haiku_modules()]
  if family == "categorical":
    assert names == ["linear", "layer_norm", "linear_1", "linear_2",
                     "linear_3"]
    policy, value = params.prediction.tower.heads()
    assert (policy.out_features, value.out_features) == (3, 21)


def test_init_is_haiku_like():
  net = make_categorical_mlp_networks(device="cpu", **CATEGORICAL)
  params = net.init_params((4,), torch.Generator().manual_seed(0))
  first, norm = params.dynamic.tower.hidden()[0][1]
  weight = first.weight.detach()
  assert torch.all(norm.weight == 1) and torch.all(norm.bias == 0)
  assert torch.all(first.bias == 0)
  bound = 2.0 / np.sqrt(first.in_features)
  assert float(weight.abs().max()) <= bound
  np.testing.assert_allclose(float(weight.std()),
                             0.88 / np.sqrt(first.in_features), rtol=0.1)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_target_codec_and_decoder(family):
  j_net, j_params, net, params = acme_nets(family)
  x = np.array([-200.0, -3.7, 0.0, 0.26, 5.0, 9.99, 700.0], np.float32)
  enc, dec = _target_codec(net)
  j_enc, j_dec = j_codec(j_net)
  probs = enc(torch.from_numpy(x))
  np.testing.assert_allclose(probs.numpy(), np.asarray(j_enc(jnp.asarray(x))),
                             atol=1e-6)
  np.testing.assert_allclose(dec(probs).numpy(),
                             np.asarray(j_dec(jnp.asarray(probs.numpy()))),
                             rtol=1e-5, atol=1e-5)
  obs = np.random.default_rng(1).standard_normal((5, 4)).astype(np.float32)
  with torch.no_grad():
    root = make_root_fn(net)(params, torch.from_numpy(obs))
    out, _ = make_recurrent_fn(net, 0.99)(
        params, None, torch.tensor([0, 1, 2, 0, 1]), root.embedding)
  j_root = j_root_fn(j_net)(j_params, jnp.asarray(obs))
  j_out, _ = j_recurrent_fn(j_net, 0.99)(
      j_params, None, jnp.asarray([0, 1, 2, 0, 1]), j_root.embedding)
  np.testing.assert_allclose(root.value.numpy(), np.asarray(j_root.value),
                             rtol=1e-5, atol=1e-4)
  np.testing.assert_allclose(out.reward.numpy(), np.asarray(j_out.reward),
                             rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_and_grads_match_jax(family):
  j_net, j_params, net, params = acme_nets(family)
  arrays = batch_numpy(2, B=16, L=5, num_actions=3)
  arrays["rn"] = arrays["rn"] * 2  # reach past the +-10 support
  kw = dict(l2_coef=1e-4, gradient_scale=0.5, priority_alpha=0.5)
  ref_grads, ref = jax.grad(
      lambda p: j_loss(p, jax_batch(arrays), j_net, **kw),
      has_aux=True)(j_params)
  grads, metrics = muzero_grad(params, torch_batch(arrays), net, **kw)
  assert_trees_close(mlp_grads_to_numpy(params, grads), ref_grads._asdict(),
                     rtol=2e-4, atol=1e-6)
  for name in ("total", "reward_loss", "value_loss", "policy_loss",
               "l2_loss"):
    np.testing.assert_allclose(float(getattr(metrics, name)),
                               float(getattr(ref, name)), rtol=1e-5,
                               err_msg=name)
  np.testing.assert_allclose(metrics.priorities.numpy(),
                             np.asarray(ref.priorities), rtol=1e-4,
                             atol=1e-6)
