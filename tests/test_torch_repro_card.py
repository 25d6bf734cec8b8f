"""A training run on the card repeats its bits for one seed, and the ring's
scatters keep the last occurrence of a repeated slot there. Every test
here needs a CUDA card and skips without one; the file imports nothing of
the JAX package (``tests/test_torch_repro.py`` runs the same write cases
on the CPU):

  python -m pytest tests/test_torch_repro_card.py -m gpu -q --noconftest

``fit`` at the parity config (8 envs x 20 steps, 64 updates of batch 256
an iteration) for 3 iterations, twice in one process with one seed, gives
the same digest after every stage of ``tools/repro_fit.py`` and the same
parameters, optimizer state, ring and episodes.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from muax_tpu_torch.config import (MuZeroConfig, ReplayConfig, SearchConfig,
                                   TrainConfig)
from muax_tpu_torch.models import make_mlp_networks
from muax_tpu_torch.replay import replay_add, replay_init
from muax_tpu_torch.replay.buffer import last_writers, replay_update_priorities
from muax_tpu_torch.train import reanalyze as reanalyze_module
from muax_tpu_torch.types import Transition

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, L, A, K = 16, 6, 3, 5


def repro_tool():
  spec = importlib.util.spec_from_file_location(
      "repro_fit", os.path.join(ROOT, "tools", "repro_fit.py"))
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def refresh_repeated(device):
  """``replay_update_priorities`` over W windows that hit few slots, many
  of them several times: each slot holds the value of its last occurrence,
  every other slot is unchanged."""
  rng = np.random.default_rng(0)
  state = replay_init(C, L, (4,), A, device=device)
  state.step_priorities.copy_(torch.from_numpy(
      rng.uniform(0.5, 1.5, (C, L)).astype(np.float32)))
  before = state.step_priorities.cpu().numpy().copy()
  W = 65536
  seg = rng.integers(0, 4, W)
  starts = rng.integers(0, 3, W)
  prios = rng.uniform(0.0, 2.0, W).astype(np.float32)
  prios[::7] = 0.0  # floored at 1e-9
  replay_update_priorities(
      state, torch.from_numpy(seg).to(device),
      torch.from_numpy(starts).to(device), torch.from_numpy(prios).to(device))
  want = before.copy()
  for i in range(W):  # in index order: the last write wins
    want[seg[i], starts[i]] = max(prios[i], 1e-9)
  np.testing.assert_array_equal(state.step_priorities.cpu().numpy(), want)


def reanalyze_repeated(device, monkeypatch):
  """Reanalyze with draws that repeat segments 2 and 9: each keeps the rows
  (pi, value, rn, priorities) of its last draw. The search's outputs are
  shifted by their row's index, so that the copies' rows differ."""
  rng = np.random.default_rng(1)
  net = make_mlp_networks(num_actions=A, embedding_dim=8, support_size=10,
                          device=device)
  params = net.init_params((4,), torch.Generator().manual_seed(0))
  config = MuZeroConfig(
      search=SearchConfig(policy="muzero", num_simulations=8),
      replay=ReplayConfig(capacity=C),
      train=TrainConfig(num_envs=4, collect_steps=L, batch_size=4,
                        unroll_steps=2, n_bootstrap=3, discount=0.97))
  filled = 12
  state = replay_init(C, L, (4,), A, device=device)

  def t(x):
    return torch.from_numpy(x).to(device)

  replay_add(state, Transition(
      obs=t(rng.standard_normal((filled, L, 4)).astype(np.float32)),
      action=t(rng.integers(0, A, (filled, L)).astype(np.int32)),
      reward=t(rng.uniform(size=(filled, L)).astype(np.float32)),
      done=t(rng.uniform(size=(filled, L)) < 0.15),
      rn=t(np.zeros((filled, L), np.float32)),
      value=t(np.zeros((filled, L), np.float32)),
      pi=t(np.full((filled, L, A), 1.0 / A, np.float32)),
      weight=t(np.ones(filled, np.float32)),
      mask=t(np.ones((filled, L), np.float32))),
      t(np.ones((filled, L), np.float32)))
  # Equal ages: u = (i + 0.5) / filled draws segment i.
  segs = np.array([2, 9, 2, 5, 9])
  uniforms = t(((segs + 0.5) / filled).astype(np.float32))
  outputs = []
  make = reanalyze_module.make_policy_fn

  def recording_policy_fn(*a, **kw):
    policy_fn = make(*a, **kw)

    def wrapped(*pa, **pkw):
      action, pi, value = policy_fn(*pa, **pkw)
      row = torch.arange(len(value), device=value.device,
                         dtype=value.dtype)
      out = (action, pi * (1.0 + row[:, None]), value + row)
      outputs.append(out)
      return out
    return wrapped

  monkeypatch.setattr(reanalyze_module, "make_policy_fn",
                      recording_policy_fn)
  fn = reanalyze_module.make_reanalyze_fn(net, config, K, device=device)
  new, _ = fn(params, state, torch.Generator(device=device).manual_seed(3),
              4, uniforms=uniforms)
  (_, pi, value), = outputs
  pi, value = pi.reshape(K, L, A), value.reshape(K, L)
  for seg, first, last in ((2, 0, 2), (9, 1, 4)):
    assert not torch.equal(pi[first], pi[last]), "the copies must differ"
    assert torch.equal(new.pi[seg], pi[last])
    assert torch.equal(new.value[seg], value[last])
  assert torch.equal(new.pi[5], pi[3])
  # rn and the priorities follow the kept values, row by row.
  from muax_tpu_torch.ops import segment_n_step_returns
  rows = torch.tensor([2, 3, 4], device=device)
  keep = segs[[2, 3, 4]]
  rn = segment_n_step_returns(new.reward[keep].T, value[rows].T,
                              new.done[keep].T.to(torch.float32), 0.97, 3,
                              config.train.bootstrap_lambda).T
  assert torch.equal(new.rn[keep], rn)
  assert torch.equal(new.step_priorities[keep],
                     torch.abs(value[rows] - rn)
                     ** config.replay.priority_alpha + 1e-6)


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
def test_last_occurrence_wins_on_the_card(cuda, monkeypatch):
  keys = torch.randint(0, 8, (100_000,), generator=torch.Generator()
                       .manual_seed(0))
  want = torch.zeros(8, dtype=torch.int64)
  for i, k in enumerate(keys.tolist()):
    want[k] = i
  assert torch.equal(last_writers(keys.to(cuda), 8).cpu(), want[keys])
  refresh_repeated(cuda)
  reanalyze_repeated(cuda, monkeypatch)


@pytest.mark.gpu
def test_fit_repeats_its_bits_on_the_card(cuda):
  tool = repro_tool()
  runs = [tool.run_digests("parity", "muzero", "cuda", seed=5,
                           iterations=3) for _ in range(2)]
  assert runs[0]["records"], "no stage was recorded"
  assert tool.first_difference(*runs) is None
  assert runs[0]["final"] == runs[1]["final"]
