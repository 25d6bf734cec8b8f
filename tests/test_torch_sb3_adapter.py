"""The port's sb3 adapter (``muax_tpu_torch/adapters/sb3``), on the CPU:
the JAX file's recurrence check on ``MuaxRolloutBuffer`` (its vectorized
n-step/lambda returns against a direct transcription of the reference's
per-step loop, rtol = atol = 1e-5), the port's buffer bit for bit against
the JAX package's (targets, weights and every minibatch of both sampling
modes, from the same seed), and the gate: without stable-baselines3 the
policy and algorithm classes raise a descriptive ImportError."""
import numpy as np
import pytest

from muax_tpu.adapters.sb3 import MuaxRolloutBuffer as JBuffer
from muax_tpu_torch.adapters.sb3 import MuaxRolloutBuffer
from tests.test_sb3_adapter import naive_rn

FIELDS = ("observations", "actions", "rewards", "Rn", "pi", "weights")


def fill(cls, T=16, E=3, seed=0, **kwargs):
  rng = np.random.default_rng(seed)
  buf = cls(buffer_size=T, obs_shape=(4,), pi_shape=(2,), n_envs=E,
            seed=seed, **kwargs)
  for t in range(T):
    buf.add(obs=rng.normal(size=(E, 4)),
            action=rng.integers(0, 2, size=(E,)),
            reward=rng.normal(size=(E,)), value=rng.normal(size=(E,)),
            pi=rng.dirichlet(np.ones(2), size=E),
            episode_start=(rng.random(E) < 0.2).astype(np.float32)
            if t > 0 else np.ones(E, np.float32))
  return buf, rng


@pytest.mark.parametrize("lam,gamma,n", [(1.0, 0.99, 5), (0.9, 0.95, 3),
                                         (0.0, 0.9, 4)])
def test_rn_matches_reference_recurrence(lam, gamma, n):
  buf, rng = fill(MuaxRolloutBuffer, n_step_bootstrapping=n, lambda_t=lam,
                  gamma_t=gamma)
  last_values = rng.normal(size=3)
  dones = (rng.random(3) < 0.5).astype(np.float32)
  buf.compute_Rn_and_weights(last_values, dones)
  expected = naive_rn(buf.rewards, buf.values, buf.episode_starts,
                      last_values, dones, n, lam, gamma)
  np.testing.assert_allclose(buf.Rn, expected, rtol=1e-5, atol=1e-5)
  np.testing.assert_allclose(
      buf.weights, np.abs(buf.values - buf.Rn) ** buf.prioritized_alpha,
      rtol=1e-5)


@pytest.mark.parametrize("prioritized", [False, True])
def test_buffer_equals_jax_bit_for_bit(prioritized):
  kw = dict(k_steps=4, n_step_bootstrapping=3, lambda_t=0.9,
            prioritized_sampling=prioritized, prioritized_alpha=0.7)
  got, rng = fill(MuaxRolloutBuffer, **kw)
  ref, _ = fill(JBuffer, **kw)
  last_values = rng.normal(size=3)
  dones = (rng.random(3) < 0.5).astype(np.float32)
  got.compute_Rn_and_weights(last_values, dones)
  ref.compute_Rn_and_weights(last_values, dones)
  np.testing.assert_array_equal(got.Rn, ref.Rn)
  np.testing.assert_array_equal(got.weights, ref.weights)
  np.testing.assert_array_equal(got._feasible_starts(4),
                                ref._feasible_starts(4))
  batches = list(zip(got.get(batch_size=5), ref.get(batch_size=5)))
  assert batches
  for a, b in batches:
    for name in FIELDS:
      np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                    err_msg=name)


def test_sb3_classes_gate_without_sb3():
  try:
    import stable_baselines3  # noqa: F401
    pytest.skip("sb3 installed; the gate is not exercisable")
  except ImportError:
    pass
  import muax_tpu_torch.adapters.sb3 as sb3_adapter
  for name in ("MuaxPolicy", "OnPolicyAlgorithmMuax"):
    with pytest.raises(ImportError, match="stable-baselines3"):
      getattr(sb3_adapter, name)
  with pytest.raises(AttributeError):
    getattr(sb3_adapter, "NoSuchClass")
