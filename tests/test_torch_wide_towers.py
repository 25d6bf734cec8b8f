"""The plain versions of the MLP search and learner, and of the Stochastic
MuZero search, at ``examples/run_2048.py``'s widths (A = 4, embedding 64,
support 300: 601 bins, towers (256, 256); Stochastic MuZero with 32 chance
outcomes), whose weights no longer fit a block's shared memory, against
the JAX package on the CPU: the searches against the Pallas kernels in
interpret mode (4 envs x 16 simulations, under legal masks), the learner
against the Pallas learner in interpret mode (batch 16, K = 5).

Tolerances as ``tests/test_fused.py:56-60`` (at most 2 visits apart, root
value rtol = atol = 1e-3, q where the visits agree) and
``tests/test_fused_learner.py:67-79`` (gradients rtol 2e-4 / atol 1e-6,
loss metrics rtol 1e-5, priorities rtol 1e-4); the Stochastic MuZero
search as ``tests/test_fused_smz.py:58-66`` (decision visits within 2,
root values rtol = atol = 1e-3). The kernels' global-weight modes are
held against these plain versions on the card
(``tests/test_torch_fused_search_kernel.py``,
``tests/test_torch_fused_gumbel_kernel.py``,
``tests/test_torch_fused_learner_kernel.py``,
``tests/test_torch_smz_kernels.py``).
"""
import jax.numpy as jnp
import numpy as np
import torch

from muax_tpu.models import fused_learner as jfl
from muax_tpu.search import fused as jfused
from muax_tpu.train.inference import make_smz_fns as j_make_smz_fns
from muax_tpu_torch.models import fused_learner
from muax_tpu_torch.models.convert import mlp_grads_to_numpy
from muax_tpu_torch.search import fused
from tests.test_torch_fused_learner import KW, _assert_metrics_close
from tests.test_torch_fused_search import _check_close
from tests.test_torch_parity import (assert_trees_close, batch_numpy,
                                     jax_batch, nets, torch_batch)
from tests.test_torch_smz_networks import smz_nets

WIDE = dict(num_actions=4, embedding_dim=64, support_size=300,
            repr_layers=(256, 256), pred_layers=(256, 256),
            dyn_layers=(256, 256))
SMZ_WIDE = dict(num_actions=4, num_chance_outcomes=32, embedding_dim=64,
                support_size=300, hidden=(256, 256))


def test_plain_search_matches_jax_kernel_at_2048_widths():
  j_net, j_params, net, params = nets(WIDE, obs_dim=16)
  rng = np.random.default_rng(7)
  B, sims = 4, 16
  emb = rng.uniform(0, 1, (B, 64)).astype(np.float32)
  invalid = np.zeros((B, 4), np.float32)
  invalid[0, 1] = invalid[1, 3] = invalid[2, :2] = 1.0  # board-like masks
  logits = np.where(invalid > 0, -1e9,
                    rng.standard_normal((B, 4))).astype(np.float32)
  value = (rng.standard_normal(B) * 20).astype(np.float32)
  kwargs = dict(num_simulations=sims, support_size=300, discount=0.999,
                max_depth=None)
  ref = jfused.fused_muzero_search(
      jnp.asarray(emb), jnp.asarray(logits), jnp.asarray(value),
      jfused.extract_fused_weights(j_net, j_params),
      invalid_actions=jnp.asarray(invalid), **kwargs)
  weights = fused.extract_fused_weights(net, params)
  assert weights.flat().numel() == 492278  # past a block's shared memory
  out = fused.fused_muzero_search(
      torch.from_numpy(emb), torch.from_numpy(logits),
      torch.from_numpy(value), weights,
      invalid_actions=torch.from_numpy(invalid), **kwargs)
  _check_close(*out, *ref, sims)
  assert float(out[0][torch.from_numpy(invalid) > 0].abs().max()) == 0.0


def test_plain_learner_matches_jax_kernel_at_2048_widths():
  j_net, j_params, net, params = nets(WIDE, obs_dim=16)
  arrays = batch_numpy(3, B=16, L=5, obs_dim=16, num_actions=4)
  arrays["rn"] = arrays["rn"] * 10  # returns over many of the 601 bins
  ref_grads, ref = jfl.fused_muzero_grad(
      j_params, jax_batch(arrays), j_net,
      jfl.extract_learner_weights(j_net, j_params), interpret=True, **KW)
  lw = fused_learner.extract_learner_weights(net, params)
  assert lw.flat.numel() == 578870
  grads, metrics = fused_learner.fused_muzero_grad(
      params, torch_batch(arrays), net, lw, **KW)
  assert_trees_close(mlp_grads_to_numpy(params, grads), ref_grads._asdict(),
                     rtol=2e-4, atol=1e-6)
  _assert_metrics_close(metrics, ref)


def test_plain_smz_search_matches_jax_kernel_at_2048_widths():
  j_net, j_params, _, net, params = smz_nets(SMZ_WIDE, obs_dim=16)
  rng = np.random.default_rng(7)
  B, sims = 4, 16
  obs = rng.standard_normal((B, 16)).astype(np.float32)
  j_root = j_make_smz_fns(j_net, 0.999)[0](j_params, jnp.asarray(obs))
  invalid = np.zeros((B, 4), np.float32)
  invalid[0, 1] = invalid[1, 3] = invalid[2, :2] = 1.0  # board-like masks
  logits = np.where(invalid > 0, -1e9,
                    np.asarray(j_root.prior_logits)).astype(np.float32)
  value = np.array(j_root.value)
  emb = np.array(j_root.embedding)
  kwargs = dict(num_simulations=sims, support_size=300, discount=0.999,
                max_depth=None)
  ref = jfused.fused_smz_search(
      jnp.asarray(emb), jnp.asarray(logits), jnp.asarray(value),
      jfused.extract_smz_fused_weights(j_net, j_params),
      num_chance_outcomes=32, invalid_actions=jnp.asarray(invalid),
      interpret=True, **kwargs)
  weights = fused.extract_smz_fused_weights(net, params)
  assert weights.flat().numel() == 762031  # past a block's shared memory
  visits, root_value, _ = fused.fused_smz_search(
      torch.from_numpy(emb), torch.from_numpy(logits),
      torch.from_numpy(value), weights,
      invalid_actions=torch.from_numpy(invalid), **kwargs)
  ref_visits = np.asarray(ref[0])
  np.testing.assert_allclose(visits.sum(-1).numpy(), sims)
  np.testing.assert_allclose(ref_visits.sum(-1), sims)
  assert np.abs(visits.numpy() - ref_visits).max() <= 2
  np.testing.assert_allclose(root_value.numpy(), np.asarray(ref[1]),
                             rtol=1e-3, atol=1e-3)
  assert float(visits[torch.from_numpy(invalid) > 0].abs().max()) == 0.0
