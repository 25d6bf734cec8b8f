"""Multi-process entry (``muax_tpu/parallel/multihost.py``).

Every process runs THIS same program; ``torch.distributed`` wires them into
one world and the mesh spans its ranks, one card per process. The sharded
program's all-reduces ride NCCL on the cards (gloo on the CPU). No RPC
topology and no variable client: the collectives keep the parameters
replicated.

Usage (the same command in every process):

    from muax_tpu_torch.parallel import multihost
    mesh = multihost.initialize_and_make_mesh(
        coordinator_address="10.0.0.1:1234",
        num_processes=4, process_id=<this process's rank>)
    program = make_sharded_program(networks, env, config, optimizer, mesh)

Under ``torchrun`` no argument is needed: its ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` stand for the
JAX package's ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and
``JAX_PROCESS_ID``. With neither, the world is this one process.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from muax_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh


def initialize_and_make_mesh(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    axis_names: Sequence[str] = (DATA_AXIS,),
    device="cuda",
):
  """Join (or make) the process group and build the mesh over every rank.

  ``coordinator_address`` ("host:port", rank 0's) falls back to torchrun's
  ``MASTER_ADDR`` and ``MASTER_PORT``, ``num_processes`` to
  ``WORLD_SIZE``, ``process_id`` to ``RANK``; without an address the world
  is this process alone. The backend is NCCL for the card and gloo for
  ``device="cpu"``. On the card, ``LOCAL_RANK`` (default 0) picks this
  process's card. A process group that already exists is kept.
  """
  device = torch.device(device)
  if device.type == "cuda":
    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
  if not dist.is_initialized():
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
      coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                             f"{os.environ['MASTER_PORT']}")
    backend = "nccl" if device.type == "cuda" else "gloo"
    if coordinator_address:
      num_processes = (num_processes if num_processes is not None
                       else int(os.environ["WORLD_SIZE"]))
      process_id = (process_id if process_id is not None
                    else int(os.environ["RANK"]))
      dist.init_process_group(backend=backend,
                              init_method="tcp://" + coordinator_address,
                              world_size=num_processes, rank=process_id)
    else:
      dist.init_process_group(backend=backend, store=dist.HashStore(),
                              world_size=1, rank=0)
  return make_mesh(axis_names=axis_names, device=device)


def is_coordinator() -> bool:
  """True on the process that should own logging, checkpoints and
  evaluation: rank 0, or a process outside any process group."""
  return not dist.is_initialized() or dist.get_rank() == 0
