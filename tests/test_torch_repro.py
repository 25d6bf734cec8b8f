"""The ring's write rule on the CPU, and the episode count of the JAX
quickstart runner.

Where a scatter of the port's ring repeats a slot (the learner's priority
refresh over windows drawn twice, reanalyze over segments drawn twice),
the last occurrence in index order wins, on every device
(``replay/buffer.py`` ``last_writers``); ``tests/test_torch_repro_card.py``
runs the same cases on the card. With no slot repeated, the refresh gives
the JAX package's ``replay_update_priorities`` bit for bit. The JAX
quickstart runner (``tools/parity_cartpole_jax.py --config quickstart``)
counts episodes to the first greedy 500 with the port's
``episodes_to_solve``, checked here on stub results.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muax_tpu.replay.buffer import replay_update_priorities as j_update
from muax_tpu_torch.examples.parity_cartpole import episodes_to_solve
from muax_tpu_torch.replay.buffer import last_writers, replay_update_priorities
from tests.test_torch_parity import jax_ring, ring_numpy, torch_ring
from tests.test_torch_repro_card import reanalyze_repeated, refresh_repeated


def refresh_distinct_against_jax():
  """Distinct (segment, start) pairs: the JAX package's result exactly."""
  C, L, O, A = 16, 8, 4, 2
  segs, prios = ring_numpy(2, C=C, L=L, O=O, A=A, filled=12)
  j_state = jax_ring(segs, prios, C, L, O, A)
  state = torch_ring(j_state)
  rng = np.random.default_rng(3)
  flat = rng.choice(12 * L, 40, replace=False)
  seg, starts = flat // L, flat % L
  new = rng.uniform(0.0, 3.0, 40).astype(np.float32)
  new[::5] = 0.0
  want = j_update(j_state, jnp.asarray(seg), jnp.asarray(starts),
                  jnp.asarray(new)).step_priorities
  replay_update_priorities(state, torch.from_numpy(seg),
                           torch.from_numpy(starts), torch.from_numpy(new))
  np.testing.assert_array_equal(state.step_priorities.numpy(),
                                np.asarray(want))


@pytest.mark.parametrize("case", ["refresh_repeated",
                                  "refresh_distinct_against_jax",
                                  "reanalyze_repeated"])
def test_repeated_slots_keep_the_last_write(case, monkeypatch):
  if case == "refresh_repeated":
    refresh_repeated("cpu")
  elif case == "refresh_distinct_against_jax":
    refresh_distinct_against_jax()
  else:
    reanalyze_repeated("cpu", monkeypatch)


def test_last_writers():
  keys = torch.tensor([3, 1, 3, 0, 1, 3, 4])
  np.testing.assert_array_equal(last_writers(keys, 6).numpy(),
                                [5, 4, 5, 3, 4, 5, 6])


def _history(test_g):
  """Rows of fit's history at log_every=1: episodes finished in each
  iteration (2, 4, 1, 3, 0, over and over: 10 every 5 iterations), a
  greedy return at iteration 1 and every 10th."""
  return [{"iteration": it, "episodes_finished": (it * 7) % 5,
           **({"test_G": test_g(it)} if it == 1 or it % 10 == 0 else {})}
          for it in range(1, 41)]


@pytest.mark.parametrize("curve, want", [
    (lambda it: 500.0 if it >= 30 else 20.0 + it, (83, 30)),
    (lambda it: 500.0, (25, 1)),
    (lambda it: 499.0, (None, None)),
    (lambda it: 500.0 if it in (20, 40) else 9.0, (63, 20)),
])
def test_jax_runner_counts_episodes_as_the_port(curve, want):
  """The JAX quickstart runner counts with the port's ``episodes_to_solve``:
  every finished episode, warm-up included, up to and including the
  iteration whose greedy evaluation first reaches 500."""
  got = episodes_to_solve({"warmup_episodes": 23,
                           "history": _history(curve)})
  assert (got["episodes_to_solve"], got["solve_iteration"]) == want
  assert got["solved"] == (want[0] is not None)
  assert got["total_episodes"] == 23 + 80
  assert [row["iteration"] for row in got["eval_curve"]] == [1, 10, 20, 30,
                                                               40]
