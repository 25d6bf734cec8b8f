"""The port's env models (``muax_tpu_torch/models/env_model.py``) against the
JAX package's (``muax_tpu/models/env_model.py``), on Catch.

The transition model and the AZ evaluation network get the JAX package's
weights through the converters and the same seeded inputs: outputs rtol
1e-5 / atol 1e-6; the loss rtol 1e-5 and every gradient leaf rtol 1e-4 /
atol 1e-6. One ``make_model_update_fn`` call of two SGD steps on the same
minibatches (the JAX update's draws handed to the port): the
parameters rtol 1e-5 / atol 1e-6. Both recurrent functions (the learned
model's and the simulator's) on the same embeddings and actions: every
output within rtol 1e-5 / atol 1e-6, the terminal cut exact. The policies
and the ring run on the port alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

import muax_tpu.models.env_model as j_env_model
from muax_tpu.envs.catch import Catch as JCatch
from muax_tpu.envs.catch import CatchState as JCatchState
from muax_tpu.models.az_networks import make_az_mlp as j_az_mlp
from muax_tpu_torch.envs import Catch, CatchState
from muax_tpu_torch.models import env_model, make_az_mlp
from muax_tpu_torch.models.convert import (az_params_from_numpy,
                                           env_model_grads_to_numpy,
                                           env_model_params_from_numpy)
from muax_tpu_torch.models.env_model import (ModelSearchParams,
                                             env_model_loss,
                                             make_mlp_transition_model,
                                             make_model_policy_fn,
                                             make_model_recurrent_fn,
                                             make_model_update_fn,
                                             make_simulator_policy_fn,
                                             make_simulator_recurrent_fn,
                                             model_replay_add,
                                             model_replay_init,
                                             model_replay_sample)
from muax_tpu_torch.models.optimizers import create_optimizer

ROWS, COLS, A = 4, 3, 3
SHAPE = (ROWS, COLS)


def _models(seed=0):
  j_model = j_env_model.make_mlp_transition_model(A, SHAPE, hidden=(16, 8))
  j_mparams = j_model.init_params(jax.random.PRNGKey(seed),
                                  jnp.zeros((1,) + SHAPE))
  model = make_mlp_transition_model(A, SHAPE, hidden=(16, 8), device="cpu")
  mparams = env_model_params_from_numpy(
      jax.tree.map(np.asarray, j_mparams), model)
  j_net = j_az_mlp(A, hidden=(16,))
  j_nparams = j_net.init_params(jax.random.PRNGKey(seed + 1),
                                jnp.zeros((1,) + SHAPE))
  net = make_az_mlp(A, hidden=(16,), device="cpu")
  nparams = az_params_from_numpy(jax.tree.map(np.asarray, j_nparams.network),
                                 net, SHAPE)
  return (j_model, j_mparams, model, mparams, j_net, j_nparams, net,
          nparams)


def _transitions(seed, n):
  rng = np.random.default_rng(seed)
  return (rng.uniform(size=(n,) + SHAPE).astype(np.float32),
          rng.integers(0, A, n).astype(np.int32),
          rng.uniform(-1, 1, n).astype(np.float32),
          rng.uniform(size=(n,) + SHAPE).astype(np.float32),
          rng.uniform(size=n) < 0.3)


def _torch(arrays):
  return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _close_trees(port, ref, rtol, atol):
  for module, leaves in jax.tree.map(np.asarray, ref).items():
    for leaf, value in leaves.items():
      np.testing.assert_allclose(port[module][leaf], value, rtol=rtol,
                                 atol=atol, err_msg=f"{module}/{leaf}")


def test_transition_model_loss_and_grads_match_jax():
  j_model, j_mparams, model, mparams, *_ = _models()
  batch = _transitions(1, 24)
  j_out = j_model.apply(j_mparams, jnp.asarray(batch[0]),
                        jnp.asarray(batch[1]))
  with torch.no_grad():
    out = model.apply(mparams, *_torch(batch[:2]))
  for a, b in zip(out, j_out):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                               atol=1e-6)
  (j_loss, j_metrics), j_grads = jax.value_and_grad(
      j_env_model.env_model_loss, has_aux=True)(
          j_mparams, j_model, *(jnp.asarray(a) for a in batch))
  loss, metrics = env_model_loss(mparams, model, *_torch(batch))
  grads = torch.autograd.grad(loss, list(mparams.parameters()))
  np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
  for name, value in j_metrics.items():
    np.testing.assert_allclose(metrics[name].item(), float(value), rtol=1e-5)
  _close_trees(env_model_grads_to_numpy(
      mparams, torch.cat([g.reshape(-1) for g in grads])), j_grads, 1e-4,
               1e-6)


def test_model_update_matches_jax(monkeypatch):
  """Two SGD steps (sgd at lr 0.1 with momentum from the port's
  ``create_optimizer``, optax's sgd on the JAX side) on the same
  minibatches."""
  j_model, j_mparams, model, mparams, *_ = _models()
  data = _transitions(2, 40)
  j_ring = j_env_model.model_replay_add(
      j_env_model.model_replay_init(64, SHAPE),
      *(jnp.asarray(a) for a in data))
  ring = model_replay_add(model_replay_init(64, SHAPE, device="cpu"),
                          *_torch(data))
  assert (ring.size, ring.cursor) == (40, 40)
  # The JAX update draws step k's minibatch from the k-th split of its key.
  draws = iter([j_env_model.model_replay_sample(j_ring, key, 16)
                for key in jax.random.split(jax.random.PRNGKey(9), 2)])
  monkeypatch.setattr(env_model, "model_replay_sample",
                      lambda *a: _torch(next(draws)))
  j_opt = optax.sgd(0.1, momentum=0.9)
  j_new, _, j_metrics = j_env_model.make_model_update_fn(
      j_model, j_opt, batch_size=16, num_sgd_steps=2)(
          j_mparams, j_opt.init(j_mparams), j_ring, jax.random.PRNGKey(9))
  opt = create_optimizer("sgd", lr=0.1, momentum=0.9)
  mparams, _, metrics = make_model_update_fn(
      model, opt, batch_size=16, num_sgd_steps=2)(
          mparams, opt.init(mparams), ring, torch.Generator())
  np.testing.assert_allclose(metrics["model_loss"].item(),
                             float(j_metrics["model_loss"]), rtol=1e-5)
  from muax_tpu_torch.models.optimizers import flat_parameters
  _close_trees(env_model_grads_to_numpy(mparams, flat_parameters(mparams)),
               j_new, 1e-5, 1e-6)


def test_underfilled_ring_zeroes_the_step():
  """Fewer transitions than the batch: the step changes nothing and
  reports a zero loss."""
  _, _, model, mparams, *_ = _models()
  ring = model_replay_add(model_replay_init(8, SHAPE, device="cpu"),
                          *_torch(_transitions(3, 4)))
  before = [p.detach().clone() for p in mparams.parameters()]
  opt = create_optimizer("sgd", lr=0.1)
  mparams, _, metrics = make_model_update_fn(model, opt, batch_size=16)(
      mparams, opt.init(mparams), ring, torch.Generator().manual_seed(0))
  assert metrics["model_loss"].item() == 0.0
  for p, b in zip(mparams.parameters(), before):
    assert torch.equal(p, b)
  # A ring written past its capacity keeps the newest transitions.
  data = _transitions(4, 12)
  model_replay_add(ring, *_torch(data))
  assert (ring.size, ring.cursor) == (8, 4)
  np.testing.assert_array_equal(ring.action.numpy(),
                                np.roll(data[1][-8:], 4))


def test_recurrent_fns_match_jax():
  (j_model, j_mparams, model, mparams, j_net, j_nparams, net,
   nparams) = _models()
  obs, action = _transitions(5, 12)[:2]
  # The learned model; a negative continue bias makes some nodes terminal.
  j_fn = j_env_model.make_model_recurrent_fn(j_model, j_net, 0.9, 0.45)
  j_out, j_next = j_fn(j_env_model.ModelSearchParams(j_nparams, j_mparams),
                       None, jnp.asarray(action), jnp.asarray(obs))
  with torch.no_grad():
    out, nxt = make_model_recurrent_fn(model, net, 0.9, 0.45)(
        ModelSearchParams(nparams, mparams), None,
        torch.from_numpy(action), torch.from_numpy(obs))
  np.testing.assert_allclose(nxt.numpy(), np.asarray(j_next), rtol=1e-5,
                             atol=1e-6)
  for name in ("reward", "discount", "prior_logits", "value"):
    np.testing.assert_allclose(getattr(out, name).numpy(),
                               np.asarray(getattr(j_out, name)), rtol=1e-5,
                               atol=1e-6, err_msg=name)
  # The simulator on Catch states, some one step from the end.
  rng = np.random.default_rng(6)
  rows = rng.integers(0, ROWS - 1, 12).astype(np.int32)
  cols = rng.integers(0, COLS, (2, 12)).astype(np.int32)
  j_state = JCatchState(*(jnp.asarray(v) for v in (rows, cols[0], cols[1])))
  state = CatchState(*(torch.from_numpy(v) for v in (rows, cols[0],
                                                      cols[1])))
  j_out, j_next = j_env_model.make_simulator_recurrent_fn(
      JCatch(ROWS, COLS), j_net, 0.9)(j_nparams, None, jnp.asarray(action),
                                      j_state)
  with torch.no_grad():
    out, nxt = make_simulator_recurrent_fn(Catch(ROWS, COLS), net, 0.9)(
        nparams, None, torch.from_numpy(action), state)
  np.testing.assert_array_equal(nxt.paddle_col.numpy(),
                                np.asarray(j_next.paddle_col))
  assert bool((out.discount == 0).any()) and bool((out.discount > 0).any())
  for name in ("reward", "discount", "prior_logits", "value"):
    np.testing.assert_allclose(getattr(out, name).numpy(),
                               np.asarray(getattr(j_out, name)), rtol=1e-5,
                               atol=1e-6, err_msg=name)


def test_model_and_simulator_policies():
  """One step of each policy on Catch: shapes, pi sums to 1, finite."""
  _, _, model, mparams, _, _, net, nparams = _models()
  game = Catch(ROWS, COLS)
  gen = torch.Generator().manual_seed(0)
  state, obs = game.reset(gen, 16)
  for out in (
      make_simulator_policy_fn(game, net, num_simulations=12)(
          nparams, gen, state, obs, 1.0),
      make_model_policy_fn(model, net, num_simulations=12)(
          ModelSearchParams(nparams, mparams), gen, obs, 1.0)):
    action, pi, value = out
    assert action.shape == (16,) and pi.shape == (16, A)
    torch.testing.assert_close(pi.sum(-1), torch.ones(16))
    assert bool(torch.isfinite(value).all())
    assert bool(((action >= 0) & (action < A)).all())
  assert model_replay_sample(model_replay_init(4, SHAPE, device="cpu"),
                             gen, 3)[0].shape == (3,) + SHAPE
