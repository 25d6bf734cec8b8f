"""The port's numerics, config and schedules against the JAX package, on the
same seeded numpy inputs.

Tolerances: atol 1e-6, rtol 1e-5 where both sides run the same f32 formula.
Decoded scalars (h^-1 of a bin expectation) get rtol 1e-4: h^-1 computes
sqrt(1 + 4 eps (|x| + 1 + eps)) - 1, which cancels about two digits, so one
ulp of difference between XLA's and PyTorch's sqrt shows as up to 3e-5
relative in the result."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muax_tpu import config as jcfg
from muax_tpu import ops as jops
from muax_tpu.train import temperature as jtemp
from muax_tpu_torch import config as tcfg
from muax_tpu_torch import ops as tops
from muax_tpu_torch.train import temperature as ttemp

ATOL, RTOL = 1e-6, 1e-5
DECODE_RTOL = 1e-4


def _close(port, ref, atol=ATOL, rtol=RTOL):
  np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol,
                             rtol=rtol)


def _values(seed=0, shape=(64,), scale=50.0):
  return (np.random.default_rng(seed).standard_normal(shape) * scale
          ).astype(np.float32)


@pytest.mark.parametrize("name", ["value_transform", "inv_value_transform"])
def test_h_transforms(name):
  x = _values()
  x[:3] = [0.0, 1e-4, -1e-4]
  rtol = DECODE_RTOL if name == "inv_value_transform" else RTOL
  _close(getattr(tops, name)(torch.from_numpy(x)),
         getattr(jops, name)(jnp.asarray(x)), rtol=rtol)


def test_h_round_trip():
  x = torch.from_numpy(_values())
  _close(tops.inv_value_transform(tops.value_transform(x)), x, atol=1e-3,
         rtol=1e-4)


@pytest.mark.parametrize("support_size", [10, 20])
def test_scalar_to_support(support_size):
  x = _values(1, (8, 16))
  _close(tops.scalar_to_support(torch.from_numpy(x), support_size),
         jops.scalar_to_support(jnp.asarray(x), support_size))


@pytest.mark.parametrize("support_size", [10, 20])
def test_support_and_logits_to_scalar(support_size):
  logits = _values(2, (32, 2 * support_size + 1), scale=2.0)
  probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
  _close(tops.support_to_scalar(torch.from_numpy(probs), support_size),
         jops.support_to_scalar(jnp.asarray(probs), support_size),
         rtol=DECODE_RTOL)
  _close(tops.logits_to_scalar(torch.from_numpy(logits), support_size),
         jops.logits_to_scalar(jnp.asarray(logits), support_size),
         rtol=DECODE_RTOL)


def test_linear_two_hot_pair():
  x = _values(3, (40,), scale=8.0)
  args = (21, -10.0, 10.0)
  port = tops.scalar_to_two_hot(torch.from_numpy(x), *args)
  _close(port, jops.scalar_to_two_hot(jnp.asarray(x), *args))
  _close(tops.two_hot_to_scalar(port, -10.0, 10.0),
         jops.two_hot_to_scalar(jnp.asarray(port.numpy()), -10.0, 10.0),
         atol=1e-5)
  logits = _values(4, (40, 21), scale=2.0)
  _close(tops.two_hot_logits_to_scalar(torch.from_numpy(logits), -10, 10),
         jops.two_hot_logits_to_scalar(jnp.asarray(logits), -10, 10),
         atol=1e-5)


def test_min_max_normalize():
  s = _values(5, (16, 8), scale=3.0)
  s[0] = 1.5  # a constant row divides by eps
  _close(tops.min_max_normalize(torch.from_numpy(s)),
         jops.min_max_normalize(jnp.asarray(s)))


@pytest.mark.parametrize("axis", [-1, (0, 2), (-3, -2)])
def test_min_max_normalize_over_axes(axis):
  """``dim`` takes a tuple, as JAX's ``axis`` does; the 2-D form reduces
  the spatial dims of NCHW latents, JAX's those of NHWC."""
  s = _values(8, (3, 5, 4), scale=2.0)
  _close(tops.min_max_normalize(torch.from_numpy(s), axis),
         jops.min_max_normalize(jnp.asarray(s), axis))
  maps = _values(9, (2, 4, 3, 6), scale=2.0)  # NHWC
  _close(tops.min_max_normalize2d(
      torch.from_numpy(maps).permute(0, 3, 1, 2)).permute(0, 2, 3, 1),
         jops.min_max_normalize2d(jnp.asarray(maps)))


def test_clip_gradient_matches_jax_grad():
  import jax
  x = _values(10, (32,), scale=1.0)
  w = _values(11, (32,), scale=4.0)  # upstream gradients, half above 1.0
  ref = jax.grad(lambda t: jnp.sum(jops.clip_gradient(t, 1.0) ** 2
                                   * jnp.asarray(w)))(jnp.asarray(x))
  t = torch.from_numpy(x).requires_grad_()
  out = tops.clip_gradient(t, 1.0)
  assert torch.equal(out, t)
  (grad,) = torch.autograd.grad(torch.sum(out ** 2 * torch.from_numpy(w)),
                                t)
  _close(grad, ref)
  assert float(grad.abs().max()) == 1.0


@pytest.mark.parametrize("shape", [(20,), (20, 6)])
@pytest.mark.parametrize("n,lam", [(10, 1.0), (3, 0.8)])
def test_segment_n_step_returns(shape, n, lam):
  rng = np.random.default_rng(6)
  rewards = rng.standard_normal(shape).astype(np.float32)
  values = rng.standard_normal(shape).astype(np.float32) * 5
  dones = (rng.random(shape) < 0.15).astype(np.float32)
  port = tops.segment_n_step_returns(
      torch.from_numpy(rewards), torch.from_numpy(values),
      torch.from_numpy(dones), 0.997, n, lam)
  ref = jops.segment_n_step_returns(jnp.asarray(rewards), jnp.asarray(values),
                                    jnp.asarray(dones), 0.997, n, lam)
  _close(port, ref, atol=1e-5)


def test_n_step_bootstrapped_returns():
  rng = np.random.default_rng(7)
  r, v = (rng.standard_normal((4, 12)).astype(np.float32) for _ in range(2))
  d = np.full((4, 12), 0.99, np.float32)
  ref = jops.batched_n_step_returns(jnp.asarray(r), jnp.asarray(d),
                                    jnp.asarray(v), 5, 0.9)
  for fn in (tops.n_step_bootstrapped_returns, tops.batched_n_step_returns):
    port = fn(torch.from_numpy(r), torch.from_numpy(d), torch.from_numpy(v),
              5, 0.9)
    _close(port, ref, atol=1e-5)


def test_debug_guards():
  """``assert_finite`` over a tensor, a module and a nested structure;
  ``nan_guard`` turns on ``check_numerics`` and anomaly mode and restores
  both."""
  from muax_tpu_torch.utils import debug
  debug.assert_finite({"a": [torch.ones(3)], "m": torch.nn.Linear(2, 2)})
  layer = torch.nn.Linear(2, 2)
  with torch.no_grad():
    layer.bias[1] = float("nan")
  with pytest.raises(FloatingPointError, match=r"net\.bias"):
    debug.assert_finite(layer, "net")
  with pytest.raises(FloatingPointError, match=r"x\[1\]"):
    debug.assert_finite((torch.zeros(2), torch.tensor([float("inf")])), "x")
  assert not debug.check_numerics_enabled()
  assert not torch.is_anomaly_enabled()
  with debug.nan_guard():
    assert debug.check_numerics_enabled() and torch.is_anomaly_enabled()
    with pytest.raises(FloatingPointError):
      debug.check_numerics(torch.tensor([float("nan")]), "grads")
  assert not debug.check_numerics_enabled()
  assert not torch.is_anomaly_enabled()
  debug.check_numerics(torch.tensor([float("nan")]))  # off: no check


@pytest.mark.parametrize("step", [0, 10, 19, 20, 40, 55, 61, 74, 75, 99, 100])
def test_temperature_schedules(step):
  _close(ttemp.standalone_temperature(100, step),
         jtemp.standalone_temperature(100, step))
  _close(ttemp.acme_temperature(100, step), jtemp.acme_temperature(100, step))
  schedule = jcfg.TrainConfig().temperature_schedule
  _close(ttemp.schedule_temperature(schedule, 100, step),
         jtemp.schedule_temperature(schedule, 100, step))


def test_config_mirrors_jax_config():
  for port_cls, ref_cls in [(tcfg.SearchConfig, jcfg.SearchConfig),
                            (tcfg.ReplayConfig, jcfg.ReplayConfig),
                            (tcfg.TrainConfig, jcfg.TrainConfig)]:
    assert dataclasses.asdict(port_cls()) == dataclasses.asdict(ref_cls())
  port = tcfg.MuZeroConfig(search=tcfg.SearchConfig(num_simulations=64),
                           train=tcfg.TrainConfig(collect_steps=7))
  ref = jcfg.MuZeroConfig(search=jcfg.SearchConfig(num_simulations=64),
                          train=jcfg.TrainConfig(collect_steps=7))
  assert port.replay.segment_length == 7
  assert tcfg.config_hash(port) == jcfg.config_hash(ref)
