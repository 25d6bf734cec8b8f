"""The port's conv families (``models/networks.py``: the EfficientZero and
ResNet triplets and their residual block, ``models/convert.py``'s conv
converters) and ``muzero_loss``'s bf16 and remat options, against the JAX
package on the CPU.

Weights cross from haiku by ``conv_params_from_numpy`` (HWIO -> OIHW, by
haiku's names). Network outputs: rtol 1e-5 / atol 1e-5 (f32 convolutions
summed in other orders). The loss on the same windows: rtol 1e-5; every
gradient leaf rtol 1e-4 / atol 1e-6 after ``conv_grads_to_numpy``. The bf16
and remat options against the port's own f32 loss, with the JAX package's
criteria (``tests/test_learner.py:374-405``): gradient cosine above 0.98 and
loss within 5 % under bf16 + remat, f32 master gradients, and remat alone
within atol 1e-6 of no remat.
"""
import haiku as hk
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muax_tpu.models import make_efficientzero_networks as j_ez
from muax_tpu.models import make_resnet_networks as j_resnet
from muax_tpu.models.losses import muzero_loss as j_muzero_loss
from muax_tpu.models.networks import MZParams as JParams
from muax_tpu.models.networks import ResidualConvBlock as JBlock
from muax_tpu_torch.config import MuZeroConfig, SearchConfig
from muax_tpu_torch.models import (ResidualConvBlock,
                                   conv_grads_to_numpy,
                                   conv_params_from_numpy,
                                   make_efficientzero_networks,
                                   make_resnet_networks)
from muax_tpu_torch.models.convert import _modules_to_numpy
from muax_tpu_torch.models.fused_learner import extract_learner
from muax_tpu_torch.models.losses import muzero_grad
from muax_tpu_torch.search import fused
from muax_tpu_torch.search.fused import extract_search_weights
from muax_tpu_torch.train import actor
from muax_tpu_torch.train.actor import make_policy_fn, uses_fused_search
from tests.test_torch_parity import one_thread  # noqa: F401
from tests.test_torch_parity import batch_numpy, jax_batch, torch_batch

pytestmark = pytest.mark.usefixtures("one_thread")

TOWERS = ("representation", "prediction", "dynamic")
RTOL = ATOL = 1e-5


def _nchw(x):
  return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2).contiguous()


def _nhwc(t):
  return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("hw", [(10, 8), (9, 7)], ids=["even", "odd"])
def test_strided_projection_block_matches_haiku(hw):
  """``ResidualConvBlock(stride=2, use_projection=True)``, 4 -> 8
  channels: haiku's SAME padding (0 before and 1 after on an even size, 1
  and 1 on an odd one) and the 1x1 shortcut of the activated input."""
  block = hk.without_apply_rng(hk.transform(
      lambda x: JBlock(8, stride=2, use_projection=True, name="b")(x)))
  x = np.random.default_rng(0).standard_normal((2,) + hw + (4,)).astype(
      np.float32)
  port = ResidualConvBlock(8, stride=2, use_projection=True, in_channels=4,
                           generator=torch.Generator().manual_seed(0))
  with torch.no_grad():  # LayerNorm scales and offsets away from 1 and 0
    for norm in (port.norm_in, port.norm_mid):
      norm.weight.uniform_(0.5, 1.5)
      norm.bias.uniform_(-0.5, 0.5)
  tree = _modules_to_numpy(port, torch.cat(
      [p.detach().reshape(-1) for p in port.parameters()]),
      port.haiku_modules())
  j_params = {f"b/{k}": v for k, v in tree.items()}
  assert [n for n, _ in port.haiku_modules()][1] == "conv2_d"
  assert port.projection.weight.shape == (8, 4, 1, 1)
  np.testing.assert_allclose(_nhwc(port(_nchw(x))),
                             np.asarray(jax.jit(block.apply)(j_params, x)),
                             rtol=RTOL, atol=ATOL)


FAMILIES = {
    "ez_down": (lambda **k: j_ez(downsample=True, **k),
                lambda **k: make_efficientzero_networks(downsample=True,
                                                        **k)),
    "ez_flat": (lambda **k: j_ez(downsample=False, **k),
                lambda **k: make_efficientzero_networks(downsample=False,
                                                        **k)),
    "resnet": (j_resnet, make_resnet_networks),
}
# bench.py's 80 x 40 x 1 uint8 frame (its pyramid 80x40 -> 40x20 -> 20x10
# -> 10x5 -> 5x3 pads an odd size in the last pool) and a 16 x 12 float one.
FRAMES = {"u8_80x40": ((80, 40, 1), np.uint8),
          "f32_16x12": ((16, 12, 2), np.float32)}


def _frames(shape, dtype, seed, batch=2):
  rng = np.random.default_rng(seed)
  if dtype == np.uint8:
    return rng.integers(0, 256, (batch,) + shape).astype(np.uint8)
  return rng.uniform(size=(batch,) + shape).astype(np.float32)


def _conv_nets(family, shape, seed=0, num_actions=3, support_size=5):
  """The port's conv triplet (channels 8, 1 block) from a seeded init, its
  weights as a numpy haiku tree (``conv_grads_to_numpy`` of the flat
  parameters) loaded back by ``conv_params_from_numpy``, and the JAX
  triplet. haiku's apply checks every module's name and shape against its
  own, so a tree in the wrong names or layout fails there (skipping the
  JAX package's init, whose compile takes seconds)."""
  j_make, make = FAMILIES[family]
  kwargs = dict(num_actions=num_actions, support_size=support_size,
                channels=8, num_blocks=1)
  net = make(device="cpu", **kwargs)
  fresh = net.init_params(shape, torch.Generator().manual_seed(seed))
  tree = conv_grads_to_numpy(fresh, torch.cat(
      [p.detach().reshape(-1) for p in fresh.parameters()]))
  params = conv_params_from_numpy(tree, net, shape)
  for a, b in zip(fresh.parameters(), params.parameters()):
    assert torch.equal(a, b)
  j_net = j_make(**kwargs)
  j_params = JParams(representation=tree["representation"],
                     prediction=tree["prediction"], dynamic=tree["dynamic"],
                     temperature=jnp.asarray(1.0, jnp.float32))
  return j_net, j_params, net, params


@pytest.mark.parametrize("frame", list(FRAMES))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_conv_triplet_matches_haiku(family, frame):
  shape, dtype = FRAMES[frame]
  j_net, j_params, net, params = _conv_nets(family, shape)
  obs = _frames(shape, dtype, seed=1)
  j_s = jax.jit(j_net.representation.apply)(j_params.representation,
                                            jnp.asarray(obs))
  with torch.no_grad():
    s = params.representation(torch.from_numpy(obs))
  assert tuple(s.shape[1:]) == net.latent_shape(shape)
  np.testing.assert_allclose(_nhwc(s), np.asarray(j_s), rtol=RTOL, atol=ATOL)
  j_pol, j_val = jax.jit(j_net.prediction.apply)(j_params.prediction, j_s)
  action = np.array([0, 2], np.int32)
  j_rew, j_next = jax.jit(j_net.dynamic.apply)(j_params.dynamic, j_s,
                                               jnp.asarray(action))
  with torch.no_grad():
    pol, val = params.prediction(_nchw(j_s))
    rew, nxt = params.dynamic(_nchw(j_s), torch.from_numpy(action))
  for port, ref in ((pol, j_pol), (val, j_val), (rew, j_rew)):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
  np.testing.assert_allclose(_nhwc(nxt), np.asarray(j_next), rtol=RTOL,
                             atol=ATOL)


def test_converter_follows_haikus_build_order():
  """haiku names modules in the order it builds them: the dynamics' reward
  head is ``linear`` (480 -> 64 is ``linear_1``), and enc_down_1's 1x1
  projection is ``conv2_d``. Loading by call order would swap them."""
  _, j_params, net, params = _conv_nets("ez_down", (80, 40, 1))
  assert j_params.dynamic["linear"]["w"].shape == (64, 11)
  assert j_params.dynamic["linear_1"]["w"].shape == (8 * 5 * 3, 64)
  mods = dict(params.dynamic.haiku_modules())
  assert mods["linear"] is params.dynamic.reward
  assert mods["linear_1"] is params.dynamic.reward_hidden
  down = dict(params.representation.haiku_modules())
  assert down["enc_down_1/conv2_d"] is params.representation.blocks[1].projection
  np.testing.assert_array_equal(
      down["enc_down_1/conv2_d"].weight.detach().numpy(),
      np.asarray(j_params.representation["enc_down_1/conv2_d"]["w"]
                 ).transpose(3, 2, 0, 1))
  # haiku's own init gives the same names and shapes.
  shapes = jax.eval_shape(j_ez(3, 5, 8, 1).init_params,
                          jax.random.PRNGKey(0), jnp.zeros((1, 80, 40, 1)))
  for tower in TOWERS:
    ref = getattr(shapes, tower)
    assert set(ref) == set(getattr(j_params, tower)), tower
    for mod, leaves in ref.items():
      for leaf, value in leaves.items():
        assert value.shape == getattr(j_params, tower)[mod][leaf].shape


def _loss_setup(seed=0):
  """``tests/test_learner.py``'s mixed-precision setup: the EZ net at
  channels 8, 1 block, support 10, A = 3, on 16 x 16 x 1 frames, B = 4,
  L = 3; the windows from numpy with a masked step."""
  shape = (16, 16, 1)
  j_net, j_params, net, params = _conv_nets("ez_down", shape, seed,
                                            support_size=10)
  arrays = batch_numpy(seed + 1, B=4, L=3, obs_dim=1, num_actions=3)
  arrays["obs"] = np.random.default_rng(seed + 2).uniform(
      size=(4, 3) + shape).astype(np.float32)
  arrays["mask"][2, 2] = 0.0
  return j_net, j_params, net, params, arrays


def test_muzero_loss_and_grads_match_jax():
  j_net, j_params, net, params, arrays = _loss_setup()
  (j_total, j_metrics), j_grads = jax.jit(jax.value_and_grad(
      lambda p, b: j_muzero_loss(p, b, j_net), has_aux=True))(
          j_params, jax_batch(arrays))
  grads, metrics = muzero_grad(params, torch_batch(arrays), net)
  np.testing.assert_allclose(float(metrics.total), float(j_total), rtol=1e-5)
  np.testing.assert_allclose(metrics.priorities.numpy(),
                             np.asarray(j_metrics.priorities), rtol=1e-4,
                             atol=1e-6)
  tree = conv_grads_to_numpy(params, grads)
  for tower in TOWERS:
    ref = getattr(j_grads, tower)
    assert set(tree[tower]) == set(ref)
    for mod, leaves in ref.items():
      for leaf, value in leaves.items():
        np.testing.assert_allclose(tree[tower][mod][leaf], np.asarray(value),
                                   rtol=1e-4, atol=1e-6,
                                   err_msg=f"{tower}/{mod}/{leaf}")


def test_bf16_remat_grads_track_f32():
  _, _, net, params, arrays = _loss_setup()
  batch = torch_batch(arrays)
  g0, m0 = muzero_grad(params, batch, net)
  g1, m1 = muzero_grad(params, batch, net, compute_dtype=torch.bfloat16,
                       remat=True)
  assert g1.dtype == torch.float32
  assert all(p.dtype == torch.float32 for p in params.parameters())
  cos = float(torch.dot(g0, g1) / (g0.norm() * g1.norm() + 1e-12))
  assert cos > 0.98, cos
  assert abs(float(m0.total) - float(m1.total)) < 0.05 * abs(float(m0.total))


def test_remat_alone_matches_no_remat():
  _, _, net, params, arrays = _loss_setup()
  batch = torch_batch(arrays)
  g0, m0 = muzero_grad(params, batch, net)
  g2, m2 = muzero_grad(params, batch, net, remat=True)
  torch.testing.assert_close(g2, g0, rtol=0, atol=1e-6)
  assert float(m2.total) == float(m0.total)


@pytest.mark.parametrize("policy", ["muzero", "gumbel"])
def test_conv_nets_take_the_generic_engine(policy, monkeypatch):
  """Under ``search.fused=True`` (the default) the conv triplet has no
  kernel: ``make_policy_fn`` takes the generic engine, and neither the
  search's nor the learner's extractor takes the towers."""
  net = make_efficientzero_networks(3, support_size=5, channels=8,
                                    num_blocks=1, device="cpu")
  config = MuZeroConfig(search=SearchConfig(policy=policy,
                                            num_simulations=4))
  assert config.search.fused and not uses_fused_search(net, config)
  params = net.init_params((16, 12, 1), torch.Generator().manual_seed(0))
  assert extract_search_weights(net, params) is None
  assert extract_learner(net, params) is None

  def refuse(*args, **kwargs):
    raise AssertionError("the fused search took a conv triplet")

  monkeypatch.setattr(actor, "fused_mlp_muzero_policy", refuse)
  monkeypatch.setattr(actor, "fused_mlp_gumbel_policy", refuse)
  before = (fused.launches, fused.gumbel_launches)
  obs = torch.from_numpy(_frames((16, 12, 1), np.uint8, seed=3, batch=4))
  action, pi, value = make_policy_fn(net, config, 0.99, device="cpu")(
      params, torch.Generator().manual_seed(1), obs, 1.0)
  assert tuple(action.shape) == (4,) and tuple(pi.shape) == (4, 3)
  assert bool(torch.isfinite(value).all())
  assert (fused.launches, fused.gumbel_launches) == before
