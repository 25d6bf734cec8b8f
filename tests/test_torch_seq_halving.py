"""The port's copy of the sequential-halving schedule against the JAX
package's: the same table, entry for entry."""
import numpy as np
import pytest

from muax_tpu.search import seq_halving as jseq
from muax_tpu_torch.search import seq_halving


@pytest.mark.parametrize("sims", [1, 7, 16, 50, 64])
def test_table_matches_jax(sims):
  for m in range(17):
    table = seq_halving.considered_visit_table(m, sims)
    assert table.dtype == np.int32
    np.testing.assert_array_equal(table, jseq.considered_visit_table(m, sims))
    assert seq_halving.considered_visit_sequence(m, sims) == (
        jseq.considered_visit_sequence(m, sims))


def test_two_actions_alternate():
  assert seq_halving.considered_visit_sequence(2, 10) == (
      0, 0, 1, 1, 2, 2, 3, 3, 4, 4)
