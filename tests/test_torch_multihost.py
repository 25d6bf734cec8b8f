"""The port's multi-process entry (``muax_tpu_torch/parallel/multihost.py``)
and the checkpoints' rank rules, as ``tests/test_multihost.py`` tests the
JAX package's:

  1. the single-process case: a world of one, which coordinates,
  2. plumbing through arguments and through torchrun's variables into
     ``torch.distributed.init_process_group``,
  3. a REAL two-process rendezvous over TCP on 127.0.0.1: both processes
     run one sharded iteration (gloo) and must end with bit-identical
     parameters, compared through the group; each writes its own
     ``per_host`` checkpoint, and only rank 0 writes through
     ``save_pytree``. Unlike the JAX test this one cannot skip: gloo runs
     collectives across processes here.
"""
import os
import socket
import subprocess
import sys
import textwrap

import pytest
import torch
import torch.distributed as dist

from muax_tpu_torch.parallel import multihost
from muax_tpu_torch.train import checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROCESS_TIMEOUT_S = 150


def test_single_process_fallback_builds_local_mesh():
  assert not dist.is_initialized()
  try:
    mesh = multihost.initialize_and_make_mesh(device="cpu")
    assert mesh.size() == 1 and dist.get_world_size() == 1
    assert mesh.mesh_dim_names == ("data",)
    assert multihost.is_coordinator()
  finally:
    dist.destroy_process_group()
  assert multihost.is_coordinator()  # no process group at all


def _record_init(monkeypatch):
  calls = {}
  monkeypatch.setattr(dist, "init_process_group",
                      lambda **kw: calls.update(kw))
  monkeypatch.setattr(multihost, "make_mesh", lambda **kw: kw)
  for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
    monkeypatch.delenv(var, raising=False)
  return calls


def test_initialize_plumbing_args(monkeypatch):
  calls = _record_init(monkeypatch)
  mesh = multihost.initialize_and_make_mesh(
      coordinator_address="10.0.0.1:1234", num_processes=4, process_id=2,
      device="cpu")
  assert calls == {"backend": "gloo", "init_method": "tcp://10.0.0.1:1234",
                   "world_size": 4, "rank": 2}
  assert mesh == {"axis_names": ("data",), "device": torch.device("cpu")}


def test_initialize_plumbing_env_vars(monkeypatch):
  calls = _record_init(monkeypatch)
  monkeypatch.setenv("MASTER_ADDR", "host")
  monkeypatch.setenv("MASTER_PORT", "9")
  monkeypatch.setenv("WORLD_SIZE", "2")
  monkeypatch.setenv("RANK", "1")
  multihost.initialize_and_make_mesh(device="cpu")
  assert calls == {"backend": "gloo", "init_method": "tcp://host:9",
                   "world_size": 2, "rank": 1}


_WORKER = textwrap.dedent("""
    import os, sys
    pid, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    sys.path.insert(0, %(repo)r)
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)

    from muax_tpu_torch.parallel import multihost
    mesh = multihost.initialize_and_make_mesh(
        coordinator_address="127.0.0.1:" + port, num_processes=2,
        process_id=pid, device="cpu")
    print("RENDEZVOUS-OK", pid, "world", dist.get_world_size(), flush=True)

    # Every process runs the same seeded program and must end with
    # identical (replicated) parameters: the digests go through the group.
    from muax_tpu_torch.config import (MuZeroConfig, ReplayConfig,
                                       SearchConfig, TrainConfig)
    from muax_tpu_torch.envs import AutoResetWrapper, CartPole
    from muax_tpu_torch.models import create_optimizer, make_mlp_networks
    from muax_tpu_torch.models.optimizers import flat_parameters
    from muax_tpu_torch.parallel import make_sharded_program
    from muax_tpu_torch.train import checkpoint

    n = mesh.size()
    config = MuZeroConfig(
        search=SearchConfig(num_simulations=2),
        replay=ReplayConfig(capacity=8 * n, min_fill=n),
        train=TrainConfig(num_envs=2 * n, collect_steps=6,
                          batch_size=2 * n, updates_per_iteration=1,
                          unroll_steps=2, n_bootstrap=3))
    networks = make_mlp_networks(2, embedding_dim=4, support_size=5,
                                 device="cpu")
    program = make_sharded_program(
        networks, AutoResetWrapper(CartPole()), config,
        create_optimizer("adam", 1e-3), mesh)
    ts, rs, ec = program.init(0)
    ts, rs, ec, metrics = program.iteration(ts, rs, ec, 1)
    digest = repr(float(flat_parameters(ts.params).double().abs().sum()))
    print("DIGEST", pid, digest, flush=True)
    digests = [None, None]
    dist.all_gather_object(digests, digest)
    assert digests[0] == digests[1], digests
    print("DIGESTS-MATCH", pid, flush=True)

    path = os.path.join(out, "ckpt.pkl")
    checkpoint.save_checkpoint(path, train_state=ts, replay_state=rs,
                               env_carry=ec,
                               generator=torch.Generator().manual_seed(pid),
                               iteration=pid + 1, per_host=True)
    checkpoint.save_pytree(os.path.join(out, f"tree_{pid}.pkl"), {"a": pid})
    dist.barrier()
    loaded = checkpoint.load_checkpoint(path, per_host=True)
    assert loaded["iteration"] == pid + 1, loaded["iteration"]
    assert loaded["replay_state"].total_added == rs.total_added
    print("PER-HOST-OK", pid, flush=True)
    dist.destroy_process_group()
""")


def _free_port():
  s = socket.socket()
  s.bind(("127.0.0.1", 0))
  port = s.getsockname()[1]
  s.close()
  return port


@pytest.fixture(scope="module")
def rendezvous(tmp_path_factory):
  """Two real processes through ``initialize_and_make_mesh`` against one
  TCP rendezvous; both are killed if either outlives the timeout.
  Returns (their outputs, the directory they wrote to)."""
  tmp = tmp_path_factory.mktemp("multihost")
  script = tmp / "worker.py"
  script.write_text(_WORKER % {"repo": ROOT})
  out = tmp / "out"
  out.mkdir()
  port = _free_port()
  env = {k: v for k, v in os.environ.items()
         if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
  procs = [subprocess.Popen(
      [sys.executable, str(script), str(i), str(port), str(out)],
      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
      for i in range(2)]
  outs = []
  try:
    for p in procs:
      outs.append(p.communicate(timeout=PROCESS_TIMEOUT_S)[0])
  finally:
    for p in procs:
      if p.poll() is None:
        p.kill()
        p.communicate()
  return outs, out


def test_two_process_rendezvous_and_spmd_digest(rendezvous):
  outs, _ = rendezvous
  assert all("RENDEZVOUS-OK" in o and "world 2" in o for o in outs), outs
  assert all("DIGESTS-MATCH" in o for o in outs), outs
  d0 = [l for l in outs[0].splitlines() if l.startswith("DIGEST ")]
  d1 = [l for l in outs[1].splitlines() if l.startswith("DIGEST ")]
  assert d0[0].split()[-1] == d1[0].split()[-1], (d0, d1)


def test_per_host_checkpoints_and_rank0_writes(rendezvous):
  """``save_checkpoint(per_host=True)`` writes ``.host0`` and ``.host1``
  (each read back by its own rank); ``save_pytree`` writes only on rank
  0."""
  outs, out = rendezvous
  assert all("PER-HOST-OK" in o for o in outs), outs
  names = sorted(os.listdir(out))
  assert names == ["ckpt.pkl.host0", "ckpt.pkl.host1", "tree_0.pkl"], names


def test_fit_on_a_rank_other_than_zero_writes_nothing(tmp_path, monkeypatch):
  """On rank 1 of a world of 2, ``fit`` with ``checkpoint_every`` neither
  raises (it links ``ckpt_latest.pkl`` only where the checkpoint exists) nor
  writes a file."""
  from muax_tpu_torch.config import (MuZeroConfig, ReplayConfig,
                                     SearchConfig, TrainConfig)
  from muax_tpu_torch.envs import CartPole
  from muax_tpu_torch.models import make_mlp_networks
  from muax_tpu_torch.train.fit import fit

  monkeypatch.setattr(checkpoint, "_rank_and_world", lambda: (1, 2))
  config = MuZeroConfig(
      search=SearchConfig(num_simulations=4),
      replay=ReplayConfig(capacity=64, min_fill=8),
      train=TrainConfig(num_envs=8, collect_steps=6, batch_size=8,
                        updates_per_iteration=2, unroll_steps=2,
                        n_bootstrap=3))
  model_dir = tmp_path / "models"
  state, results = fit(CartPole(), make_mlp_networks(
      2, embedding_dim=4, support_size=5, device="cpu"), config,
                       num_iterations=2, checkpoint_every=1, eval_every=1,
                       log_every=1, log_fn=lambda s: None,
                       model_dir=str(model_dir))
  assert state.step == 4
  assert not model_dir.exists()
