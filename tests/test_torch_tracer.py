"""The port's host-side tracers, trajectory replay, training monitor and
profiling hooks, on the CPU.

* ``NStep``/``PNStep`` returns and weights, ``Trajectory.finalize`` and
  ``TrajectoryReplayBuffer.sample`` against the JAX package's
  (``muax_tpu/replay/tracer.py``), over one seeded stream of steps with
  episode ends and trajectories shorter than the window (padding and
  mask): equal bit for bit (the same numpy arithmetic and the same
  ``RandomState`` draws).
* ``TrainMonitor``'s counters, smoothing and counter save/load, and
  ``StreamingSample``, against the JAX package's: equal.
* ``Stopwatch``'s counts and means; ``trace`` writes a Chrome trace of the
  enclosed block, with ``step_annotation``'s named region in it.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

from muax_tpu.monitor import StreamingSample as JStreamingSample
from muax_tpu.monitor import TrainMonitor as JTrainMonitor
from muax_tpu.replay import tracer as j_tracer
from muax_tpu_torch.monitor import StreamingSample, TrainMonitor
from muax_tpu_torch.replay import tracer
from muax_tpu_torch.types import Transition
from muax_tpu_torch.utils import Stopwatch, step_annotation, trace

FIELDS = ("obs", "action", "reward", "done", "rn", "value", "pi", "weight",
          "mask")


def episodes(seed, lengths=(3, 12, 1, 7, 15, 5), A=2):
  """Seeded episodes of (obs, action, reward, done, value, pi) steps; the
  last step of each is terminal."""
  rng = np.random.default_rng(seed)
  out = []
  for T in lengths:
    out.append([(rng.standard_normal(4).astype(np.float32),
                 int(rng.integers(0, A)), float(rng.uniform(-1, 2)),
                 t == T - 1, float(rng.standard_normal()),
                 rng.dirichlet(np.ones(A)).astype(np.float32))
                for t in range(T)])
  return out


def trace_episodes(mod, eps, n=4, discount=0.9, prioritized=True):
  """The reference workflow: steps into an (P)NStep, popped steps into a
  Trajectory per episode; returns the popped steps and the trajectories."""
  tracer_ = mod.PNStep(n, discount, 0.5) if prioritized else mod.NStep(
      n, discount)
  popped, trajectories = [], []
  for ep in eps:
    traj = mod.Trajectory()
    for step in ep:
      tracer_.add(*step)
      while tracer_:
        s = tracer_.pop()
        popped.append(s)
        traj.add(s)
    trajectories.append(traj)
  assert len(tracer_) == 0
  return popped, trajectories


@pytest.mark.parametrize("prioritized", [False, True])
def test_nstep_returns_and_weights_equal_jax(prioritized):
  eps = episodes(0)
  ref, _ = trace_episodes(j_tracer, eps, prioritized=prioritized)
  got, _ = trace_episodes(tracer, eps, prioritized=prioritized)
  assert len(got) == len(ref) == sum(len(e) for e in eps)
  for a, b in zip(got, ref):
    assert (a.rn, a.weight, a.action, a.done) == (b.rn, b.weight, b.action,
                                                  b.done)
  if prioritized:
    assert all(s.weight > 0 for s in got)
  # A hand-computed return: the first step of the 3-step episode.
  (r0, r1, r2) = [s[2] for s in eps[0]]
  np.testing.assert_allclose(got[0].rn, r0 + 0.9 * r1 + 0.81 * r2,
                             rtol=1e-12)


def test_trajectory_finalize_equals_jax():
  eps = episodes(1)
  _, ref = trace_episodes(j_tracer, eps)
  _, got = trace_episodes(tracer, eps)
  for a, b in zip(got, ref):
    ta, tb = a.finalize(), b.batched_transitions
    assert isinstance(ta, Transition)
    for name in FIELDS:
      x, y = getattr(ta, name), np.asarray(getattr(tb, name))
      assert x.dtype == y.dtype and x.shape == y.shape, name
      np.testing.assert_array_equal(x, y, err_msg=name)
  with pytest.raises(ValueError):
    tracer.Trajectory().finalize()


@pytest.mark.parametrize("k_steps,per_traj", [(4, 3), (10, 2)])
def test_replay_buffer_samples_equal_jax(k_steps, per_traj):
  eps = episodes(2)
  _, j_trajs = trace_episodes(j_tracer, eps)
  _, trajs = trace_episodes(tracer, eps)
  j_buf = j_tracer.TrajectoryReplayBuffer(capacity=5, seed=3)
  buf = tracer.TrajectoryReplayBuffer(capacity=5, seed=3)
  for jt, t in zip(j_trajs, trajs):  # six into five: the ring drops one
    j_buf.add(jt)
    buf.add(t)
  assert len(buf) == len(j_buf) == 5
  for _ in range(3):
    ref = j_buf.sample(4, per_traj, k_steps)
    got = buf.sample(4, per_traj, k_steps)
    assert isinstance(got, Transition)
    for name in FIELDS:
      x, y = getattr(got, name), np.asarray(getattr(ref, name))
      assert x.dtype == y.dtype and x.shape == y.shape, name
      np.testing.assert_array_equal(x, y, err_msg=name)
    assert got.obs.shape == (4 * per_traj, k_steps, 4)
  # Windows past a short episode's end are padded and masked.
  assert (got.mask == 0).any()
  with pytest.raises(ValueError):
    tracer.TrajectoryReplayBuffer().sample(1)


def test_monitor_counters_and_save_load_equal_jax(tmp_path):
  mons = (TrainMonitor(None, smoothing=3), JTrainMonitor(None, smoothing=3))
  for mon in mons:
    for i in range(5):
      mon.observe_rollout(20, i % 2, 10.0 * i)
      mon.record_metrics({"loss": 1.0 / (i + 1)})
    mon.record_metrics({"loss": 0.5, "lr": 1e-3})
  outs = [mon.flush() for mon in mons]
  for key in ("T", "ep", "G", "avg_G", "loss", "lr"):
    assert outs[0][key] == outs[1][key], key
  assert outs[0]["T"] == 100 and outs[0]["ep"] == 2
  assert outs[0]["avg_G"] == np.mean([10.0, 30.0])
  assert mons[0].flush()["T"] == 100 and "loss" not in mons[0].flush()
  path = str(tmp_path / "sub" / "counters.pkl.gz")
  mons[0].save_counters(path)
  back = TrainMonitor(None, smoothing=3).load_counters(path)
  assert (back.T, back.ep, back.G, back.avg_G) == (
      mons[0].T, mons[0].ep, mons[0].G, mons[0].avg_G)
  back.close()


def test_streaming_sample_equals_jax():
  got, ref = StreamingSample(5, seed=1), JStreamingSample(5, seed=1)
  got.extend(range(40))
  ref.extend(range(40))
  assert got.values == ref.values and len(got) == 5
  got.reset()
  assert len(got) == 0


def test_stopwatch_counts_and_means():
  sw = Stopwatch()
  for _ in range(3):
    with sw.time("update"):
      time.sleep(0.002)
  with sw.time("rollout"):
    pass
  means = sw.means_ms()
  assert sw.counts == {"update": 3, "rollout": 1}
  assert means["update"] >= 2.0 and means["rollout"] >= 0.0
  with pytest.raises(RuntimeError):
    with sw.time("failing"):
      raise RuntimeError("inside")
  assert sw.counts["failing"] == 1


def test_trace_writes_a_chrome_trace(tmp_path):
  log_dir = str(tmp_path / "traces")
  with trace(log_dir):
    with step_annotation("muax_step"):
      torch.ones(64, 64) @ torch.ones(64, 64)
  files = os.listdir(log_dir)
  assert len(files) == 1 and files[0].endswith(".json")
  with open(os.path.join(log_dir, files[0])) as f:
    events = json.load(f)["traceEvents"]
  assert any(e.get("name") == "muax_step" for e in events)
