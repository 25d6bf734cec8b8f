"""The port's fused MuZero search against the JAX package's Pallas kernel.

On the CPU the port's ``fused_muzero_search`` runs its plain PyTorch version;
the JAX kernel runs in Pallas interpret mode, as ``tests/test_fused.py`` runs
it. Both get the same seeded numpy roots (embedding, noised logits, value,
invalid mask) and the same weights. The two implement the same arithmetic
with the same first-maximum tie-break, so exact agreement is expected; the
checks allow what ``tests/test_fused.py`` allows (at most 2 visits apart,
value rtol = atol = 1e-3), since a score tie that f32 rounding breaks the
other way moves one visit.

The kernel itself runs only on a CUDA card, and is held against the plain
version in ``tests/test_torch_fused_search_kernel.py``, which imports nothing
of the JAX package so that it runs on a machine with a card and no haiku.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muax_tpu.models import make_mlp_networks as j_make
from muax_tpu.search import fused as jfused
from muax_tpu_torch.models import make_mlp_networks, mlp_params_from_numpy
from muax_tpu_torch.search import fused
from muax_tpu_torch.search import policies
from muax_tpu_torch.train.inference import make_root_fn

SUPPORT = 10
EMBED = 8
TOWERS = ("representation", "prediction", "dynamic")


def _nets(num_actions, hidden, device="cpu"):
  """JAX networks and params, and the port's on ``device`` from the same
  numbers."""
  kwargs = dict(repr_layers=hidden, pred_layers=hidden, dyn_layers=hidden)
  j_net = j_make(num_actions, embedding_dim=EMBED, support_size=SUPPORT,
                 **kwargs)
  j_params = j_net.init_params(jax.random.PRNGKey(0), jnp.zeros((1, 4)))
  tree = {name: jax.tree.map(np.asarray, getattr(j_params, name))
          for name in TOWERS}
  net = make_mlp_networks(num_actions, embedding_dim=EMBED,
                          support_size=SUPPORT, device=device, **kwargs)
  return j_net, j_params, net, mlp_params_from_numpy(tree, net)


def _roots(seed, batch, num_actions, with_invalid):
  """Seeded roots: embedding in [0, 1], logits with invalid actions masked
  to -1e9 as the policy masks them, value, and the invalid mask."""
  rng = np.random.default_rng(seed)
  emb = rng.uniform(0, 1, (batch, EMBED)).astype(np.float32)
  logits = rng.standard_normal((batch, num_actions)).astype(np.float32)
  value = (rng.standard_normal(batch) * 2).astype(np.float32)
  invalid = None
  if with_invalid:
    invalid = np.zeros((batch, num_actions), np.float32)
    invalid[::2, num_actions - 1] = 1.0  # half the rows lose their last action
    logits = np.where(invalid > 0, -1e9, logits).astype(np.float32)
  return emb, logits, value, invalid


def _torch(x, device="cpu"):
  return None if x is None else torch.from_numpy(x).to(device)


def _check_close(visits, value, q, ref_visits, ref_value, ref_q, sims):
  visits, ref_visits = np.asarray(visits), np.asarray(ref_visits)
  np.testing.assert_array_equal(visits.sum(-1), np.full(len(visits), sims))
  assert np.abs(visits - ref_visits).max() <= 2
  np.testing.assert_allclose(np.asarray(value), np.asarray(ref_value),
                             rtol=1e-3, atol=1e-3)
  same = (visits == ref_visits) & (visits > 0)
  np.testing.assert_allclose(np.asarray(q)[same], np.asarray(ref_q)[same],
                             rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("sims,num_actions,hidden,edge", [
    (15, 2, (16,), False),
    (24, 3, (16,), False),
    (15, 3, (16, 16), True),
    (24, 2, (16,), True),
])
def test_plain_matches_jax_kernel(sims, num_actions, hidden, edge):
  """``edge``: one invalid action on half the rows and ``max_depth=2``."""
  j_net, j_params, net, params = _nets(num_actions, hidden)
  emb, logits, value, invalid = _roots(sims, 16, num_actions, edge)
  max_depth = 2 if edge else None
  kwargs = dict(num_simulations=sims, support_size=SUPPORT, discount=0.997,
                max_depth=max_depth)
  ref = jfused.fused_muzero_search(
      jnp.asarray(emb), jnp.asarray(logits), jnp.asarray(value),
      jfused.extract_fused_weights(j_net, j_params),
      invalid_actions=None if invalid is None else jnp.asarray(invalid),
      **kwargs)
  before = fused.launches
  out = fused.fused_muzero_search(
      _torch(emb), _torch(logits), _torch(value),
      fused.extract_fused_weights(net, params),
      invalid_actions=_torch(invalid), **kwargs)
  assert fused.launches == before  # the plain version launches nothing
  _check_close(*out, *ref, sims)
  if edge:
    assert float(out[0][torch.from_numpy(invalid) > 0].abs().max()) == 0.0


def test_dirichlet_moments():
  """Dirichlet(0.3) over 3 actions: mean 1/3, variance
  a (a0 - a) / (a0^2 (a0 + 1)) = 0.1170; 20,000 draws give standard errors
  of 0.0024 (mean) and 0.0012 (variance)."""
  gen = torch.Generator().manual_seed(0)
  gammas = policies._sample_gamma(0.3, (20000, 3), gen)
  assert float(gammas.min()) >= 0.0
  np.testing.assert_allclose(float(gammas.mean()), 0.3, atol=0.01)
  np.testing.assert_allclose(float(gammas.var()), 0.3, atol=0.02)
  zeros = torch.zeros(20000, 3)
  noise = policies._add_dirichlet_noise(gen, zeros, fraction=1.0, alpha=0.3)
  torch.testing.assert_close(noise.sum(-1), torch.ones(20000))
  np.testing.assert_allclose(noise.mean(0).numpy(), 1 / 3, atol=0.01)
  np.testing.assert_allclose(noise.var(0).numpy(), 0.3 * 0.6 / (0.81 * 1.9),
                             atol=0.005)
  mixed = policies._add_dirichlet_noise(gen, torch.full((4, 3), 1 / 3),
                                        fraction=0.25, alpha=0.3)
  assert float(mixed.min()) >= 0.75 / 3 - 1e-6


def _policy(temperature, gen, dirichlet_fraction=0.25):
  _, _, net, params = _nets(3, (16,))
  obs = torch.from_numpy(
      np.random.default_rng(1).standard_normal((16, 4)).astype(np.float32))
  root = make_root_fn(net)(params, obs)
  return fused.fused_mlp_muzero_policy(
      params, gen, root, fused.extract_fused_weights(net, params),
      num_simulations=12, support_size=SUPPORT, discount=0.997,
      dirichlet_fraction=dirichlet_fraction, temperature=temperature)


def test_policy_weights_and_counter():
  before = fused.launches
  action, weights, value = _policy(1.0, torch.Generator().manual_seed(3))
  assert fused.launches == before  # CPU tensors never reach the kernel
  assert action.shape == (16,) and action.dtype == torch.int32
  assert bool(((action >= 0) & (action < 3)).all())
  torch.testing.assert_close(weights.sum(-1), torch.ones(16))
  torch.testing.assert_close(weights * 12, torch.round(weights * 12))
  assert bool(torch.isfinite(value).all())


def test_temperature_zero_is_argmax():
  for seed in range(3):
    action, weights, _ = _policy(0.0, torch.Generator().manual_seed(seed))
    # 12 visits over 3 actions can tie; ties resolve to one of the maxima.
    top = weights.max(-1, keepdim=True).values
    picked = weights.gather(1, action.long()[:, None])
    torch.testing.assert_close(picked, top)


def test_build_needs_nvcc(monkeypatch):
  from muax_tpu_torch import _build
  monkeypatch.setattr(_build.shutil, "which", lambda name: None)
  monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
  with pytest.raises(RuntimeError, match="nvcc"):
    _build._nvcc()
