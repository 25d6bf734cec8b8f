"""The grouped learner's hybrid mode outside Stochastic MuZero, against the
JAX package's, on the CPU.

The hybrid mode is the fused sampler's ``per_step_obs`` rows, then
``_transition_from_raw``, then autograd over ``muzero_loss``. It serves
every family without a learner kernel: the MLP triplet with
``fused_learner=False`` and the acme fc-resnet. One hybrid group of each is
held against the JAX package's ``_fused_multi_update`` in hybrid mode,
through its CPU test seam ``_ALLOW_FUSED_SAMPLER_ON_CPU``, with the JAX
draws injected, at ``tests/test_torch_smz_learner.py``'s sizes and
tolerances: parameters atol = rtol = 3e-5 after two Adam steps, loss rtol
1e-4, and the refreshed priorities on the same windows at rtol 1e-4 /
atol 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import muax_tpu.train.learner as j_learner
from muax_tpu.config import MuZeroConfig as JConfig
from muax_tpu.config import ReplayConfig as JReplay
from muax_tpu.config import SearchConfig as JSearch
from muax_tpu.config import TrainConfig as JTrain
from muax_tpu.models.optimizers import muzero_optimizer as j_optimizer
from muax_tpu_torch.config import (MuZeroConfig, ReplayConfig, SearchConfig,
                                   TrainConfig)
from muax_tpu_torch.models.convert import mlp_params_from_numpy
from muax_tpu_torch.models.optimizers import muzero_optimizer
from muax_tpu_torch.train import learner
from tests.test_torch_acme_networks import acme_nets
from tests.test_torch_parity import TOWERS, jax_ring, nets, ring_numpy, \
    torch_ring

C, L, B, K = 32, 8, 64, 3
MLP = dict(num_actions=2, embedding_dim=8, support_size=20)


def _config(fused_learner, cls_m=MuZeroConfig, cls_s=SearchConfig,
            cls_r=ReplayConfig, cls_t=TrainConfig):
  return cls_m(search=cls_s(num_simulations=2),
               replay=cls_r(capacity=C, min_fill=4, offline_fraction=0.5,
                            online_queue_size=8),
               train=cls_t(num_envs=4, collect_steps=L, batch_size=B,
                           unroll_steps=K, updates_per_iteration=2,
                           presample_updates=2,
                           fused_learner=fused_learner))


def _family(name):
  """(JAX net, JAX params, port net, port params, fused_learner flag)."""
  if name == "mlp":
    return (*nets(MLP), False)
  return (*acme_nets("fc_resnet", num_actions=2), True)


@pytest.mark.parametrize("family", ["mlp", "fc_resnet"])
def test_hybrid_group_matches_jax(monkeypatch, family):
  monkeypatch.setattr(j_learner, "_ALLOW_FUSED_SAMPLER_ON_CPU", True)
  j_net, j_params, net, params, fused_learner = _family(family)
  segs, prios = ring_numpy(1, C, L, filled=24)
  j_rs = jax_ring(segs, prios, C, L, 4, 2)
  rs = torch_ring(j_rs)
  j_opt = j_optimizer(warmup_steps=2)
  j_ts = j_learner.TrainState(params=j_params, opt_state=j_opt.init(j_params),
                              step=jnp.asarray(0, jnp.int32))
  j_mu = j_learner.make_multi_update_fn(
      j_net, j_opt,
      _config(fused_learner, JConfig, JSearch, JReplay, JTrain))
  assert j_mu.fused_group_status(j_ts, j_rs)[0] == "hybrid"
  key = jax.random.PRNGKey(2)
  j_ts2, j_rs2, j_metrics = j_mu(j_ts, j_rs, key)

  # The draws of the JAX group: split(key, 1) -> (segments, Gumbel); the
  # segment key splits again into the uniforms and the online offsets.
  W = 2 * B
  seg_rng, gum_rng = jax.random.split(jax.random.split(key, 1)[0])
  u_rng, online_rng = jax.random.split(seg_rng)
  uniforms = np.array(jax.random.uniform(u_rng, (W,)))
  offsets = np.array(jax.random.randint(online_rng, (W // 2,), 1, 9))
  gumbel = np.array(jax.random.gumbel(gum_rng, (L, W), jnp.float32))

  opt = muzero_optimizer(warmup_steps=2)
  ts = learner.TrainState(params=params, opt_state=opt.init(params), step=0)
  mu = learner.make_multi_update_fn(net, opt, _config(fused_learner))
  assert mu.fused_group_status(ts, rs)[:2] == ("hybrid", None)
  prios_before = rs.step_priorities.clone()
  ts2, sums, done = mu.run_fused_group(
      ts, rs, 0, torch.from_numpy(uniforms), torch.from_numpy(offsets),
      torch.from_numpy(gumbel), mode="hybrid")
  assert done == 2 and ts2.step == 2 == int(j_ts2.step)
  np.testing.assert_allclose(float(sums[0]) / 2, float(j_metrics["loss"]),
                             rtol=1e-4)
  ref = mlp_params_from_numpy(
      {name: jax.tree.map(np.asarray, getattr(j_ts2.params, name))
       for name in TOWERS}, net)
  ref_named = dict(ref.named_parameters())
  for name, p in ts2.params.named_parameters():
    np.testing.assert_allclose(p.detach().numpy(),
                               ref_named[name].detach().numpy(), rtol=3e-5,
                               atol=3e-5, err_msg=name)
  # The same windows' priorities were refreshed.
  changed = np.asarray(j_rs2.step_priorities) != prios_before.numpy()
  assert changed.sum() > 20
  np.testing.assert_array_equal(
      rs.step_priorities.numpy() != prios_before.numpy(), changed)
  np.testing.assert_allclose(rs.step_priorities.numpy(),
                             np.asarray(j_rs2.step_priorities), rtol=1e-4,
                             atol=1e-3)
