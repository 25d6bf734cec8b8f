"""The port's ``muzero_optimizer`` against optax's chain, step for step, on
the same flat gradients; and the flat parameter buffer it steps.

Warm-up 3 so that both branches of the schedule run in 10 steps; gradients
alternate between norms above and below the clip threshold 1.0. Tolerance
rtol 1e-6: both sides compute in float32 with the same formulas. The
gradients are multiples of a power of two whose squares sum exactly in
float32, so the global norm does not depend on the order of the sum (XLA's
and PyTorch's differ by a few ulps, which Adam's moment ratio amplifies
where the moments nearly cancel).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muax_tpu.models.optimizers import muzero_optimizer as j_optimizer
from muax_tpu_torch.models import make_mlp_networks
from muax_tpu_torch.models.optimizers import (apply_updates, flat_parameters,
                                              muzero_optimizer)


def test_ten_steps_match_optax():
  n = 64
  rng = np.random.default_rng(0)
  grads = [(rng.integers(-8, 9, n) * (0.25 if i % 2 else 2.0 ** -10))
           .astype(np.float32) for i in range(10)]
  j_opt = j_optimizer(warmup_steps=3, transition_steps=4)
  opt = muzero_optimizer(warmup_steps=3, transition_steps=4)
  params = jnp.zeros((n,), jnp.float32)
  j_state = j_opt.init(params)
  state = opt.init(torch.nn.Linear(7, 8))   # 64 parameters
  for i, g in enumerate(grads):
    j_upd, j_state = j_opt.update(jnp.asarray(g), j_state, params)
    upd, state = opt.update(torch.from_numpy(g), state)
    if i == 0:  # the schedule reads the count before it increments
      assert float(upd.abs().max()) == 0.0
    np.testing.assert_allclose(upd.numpy(), np.asarray(j_upd), rtol=1e-6,
                               atol=1e-12, err_msg=f"step {i}")
  assert state.count == 10


def test_flat_parameters_are_the_modules_storage():
  net = make_mlp_networks(2, device="cpu")
  params = net.init_params((4,), torch.Generator().manual_seed(0))
  before = [p.detach().clone() for p in params.parameters()]
  flat = flat_parameters(params)
  assert flat_parameters(params) is flat
  assert flat.numel() == sum(p.numel() for p in params.parameters())
  torch.testing.assert_close(flat, torch.cat([b.reshape(-1) for b in before]))
  apply_updates(params, torch.ones_like(flat))
  for p, b in zip(params.parameters(), before):
    torch.testing.assert_close(p.detach(), b + 1.0)
  # A module whose parameters were replaced gets a fresh buffer.
  params.prediction.value.weight.data = torch.zeros(21, 16)
  assert flat_parameters(params) is not flat


@pytest.mark.parametrize("peak,warmup,count,expected", [
    (2e-2, 1000, 0, 0.0), (2e-2, 1000, 500, 1e-2), (2e-2, 1000, 1000, 2e-2)])
def test_schedule_points(peak, warmup, count, expected):
  from muax_tpu_torch.models.optimizers import (
      warmup_exponential_decay_schedule)
  schedule = warmup_exponential_decay_schedule(0.0, peak, warmup, 10_000,
                                               0.8, 1e-3)
  np.testing.assert_allclose(schedule(count), expected, rtol=1e-6)


# ---- create_optimizer: every base optimizer under every schedule ---------

_SCHEDULERS = {
    None: {},
    "warmup_cosine_decay": dict(warmup_steps=3, decay_steps=8,
                                end_value=1e-4),
    "exponential_decay": dict(transition_steps=4, decay_rate=0.5,
                              end_value=2e-4),
    "cosine_decay": dict(decay_steps=7, alpha=0.1),
    "polynomial": dict(transition_steps=6, power=2.0),
    "piecewise_constant": dict(boundaries_and_scales={3: 0.5, 6: 0.1}),
}
_EXTRA = {"sgd": dict(momentum=0.9), "adamw": dict(weight_decay=0.05)}


@pytest.mark.parametrize("scheduler", list(_SCHEDULERS))
@pytest.mark.parametrize("name", ["adam", "adamw", "sgd", "rmsprop",
                                  "adagrad", "lion"])
def test_create_optimizer_matches_optax(name, scheduler):
  """Ten steps of ``create_optimizer(name, scheduler=...)`` against the JAX
  package's on the same gradients, both sides applying their updates to
  the same starting parameters (adamw's and lion's weight decay read
  them). Tolerance rtol 1e-5 / atol 1e-9 on the updates and the
  parameters: both compute in float32 by optax's formulas, and XLA's and
  numpy's cos and pow, and rsqrt on either side, may differ by an ulp."""
  from muax_tpu.models.optimizers import create_optimizer as j_create
  from muax_tpu_torch.models.optimizers import create_optimizer
  n = 64
  rng = np.random.default_rng(1)
  grads = [(rng.integers(-8, 9, n) * (0.25 if i % 2 else 2.0 ** -10))
           .astype(np.float32) for i in range(10)]
  kwargs = dict(_SCHEDULERS[scheduler], **_EXTRA.get(name, {}))
  j_opt = j_create(name, lr=1e-2, scheduler=scheduler, **kwargs)
  opt = create_optimizer(name, lr=1e-2, scheduler=scheduler, **kwargs)
  start = rng.standard_normal(n).astype(np.float32)
  j_params = jnp.asarray(start)
  module = torch.nn.Linear(7, 8)   # 64 parameters
  flat = flat_parameters(module)
  with torch.no_grad():
    flat.copy_(torch.from_numpy(start))
  j_state, state = j_opt.init(j_params), opt.init(module)
  for i, g in enumerate(grads):
    j_upd, j_state = j_opt.update(jnp.asarray(g), j_state, j_params)
    j_params = j_params + j_upd
    upd, state = opt.update(torch.from_numpy(g), state, module)
    apply_updates(module, upd)
    np.testing.assert_allclose(upd.numpy(), np.asarray(j_upd), rtol=1e-5,
                               atol=1e-9, err_msg=f"step {i}")
  np.testing.assert_allclose(flat.numpy(), np.asarray(j_params), rtol=1e-5,
                             atol=1e-9)


def test_create_optimizer_extra_transforms_and_names():
  """``extra_transforms`` run in front (a clip to norm 1 then sgd at lr 1
  steps by the clipped gradient); unknown names raise as in JAX."""
  from muax_tpu_torch.models.optimizers import (clip_by_global_norm,
                                                create_optimizer)
  opt = create_optimizer("sgd", lr=1.0,
                         extra_transforms=[clip_by_global_norm(1.0)])
  module = torch.nn.Linear(1, 2)   # 4 parameters
  state = opt.init(module)
  upd, _ = opt.update(torch.tensor([3.0, 4.0, 0.0, 0.0]), state, module)
  torch.testing.assert_close(upd, torch.tensor([-0.6, -0.8, 0.0, 0.0]))
  with pytest.raises(ValueError, match="Unknown optimizer"):
    create_optimizer("adamax")
  with pytest.raises(ValueError, match="Unknown scheduler"):
    create_optimizer("adam", scheduler="linear")
