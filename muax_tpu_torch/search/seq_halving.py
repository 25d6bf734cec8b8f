"""Sequential halving schedule for Gumbel MuZero root exploration
(``muax_tpu/search/seq_halving.py``, the port's own copy).

Implements the budget-splitting schedule from "Policy improvement by planning
with Gumbel" (Danihelka et al., ICLR 2022): the simulation budget is divided
over ceil(log2(m)) phases; each phase gives every still-considered action an
equal number of extra visits, then halves the considered set. The schedule is
static, so it is computed on the host into a numpy visit table once per
search.
"""
from __future__ import annotations

import math

import numpy as np


def considered_visit_sequence(max_num_considered: int,
                              num_simulations: int) -> tuple[int, ...]:
  """For each simulation index, the visit count a considered action must have
  to be eligible for selection at that simulation."""
  if max_num_considered <= 1:
    return tuple(range(num_simulations))
  log2max = int(math.ceil(math.log2(max_num_considered)))
  sequence: list[int] = []
  visits = [0] * max_num_considered
  num_considered = max_num_considered
  while len(sequence) < num_simulations:
    num_extra_visits = max(1, num_simulations // (log2max * num_considered))
    for _ in range(num_extra_visits):
      sequence.extend(visits[:num_considered])
      for i in range(num_considered):
        visits[i] += 1
    # Halve the considered set, never below 2.
    num_considered = max(2, num_considered // 2)
  return tuple(sequence[:num_simulations])


def considered_visit_table(max_num_considered: int,
                           num_simulations: int) -> np.ndarray:
  """[max_num_considered + 1, num_simulations] table: row m is the schedule
  when m actions are considered (m = min(max_considered, num valid actions))."""
  table = np.zeros((max_num_considered + 1, max(num_simulations, 1)),
                   dtype=np.int32)
  for m in range(max_num_considered + 1):
    table[m, :num_simulations] = considered_visit_sequence(m, num_simulations)
  return table
