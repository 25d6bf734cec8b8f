"""Checkpoints: full training-state snapshots and a deterministic resume
(``muax_tpu/train/checkpoint.py``).

A checkpoint holds the train state (parameters, optimizer state, step), the
replay ring, the environments' carry, the generator's state and the
loop's counters, so ``fit(resume_from=...)`` continues where it stopped:
on the CPU the resumed run is bit-exact. Tensors are stored as numpy
arrays; containers (dicts, lists, tuples, named tuples, dataclasses) keep
their types. A ``torch.Generator`` goes in through ``get_state`` and comes
back through ``set_state``. Files are pickles: load only files this program
wrote.

Several processes (a ``torch.distributed`` world): only rank 0 writes, and
the other ranks do nothing, as in the JAX package only process 0 does.
State of a sharded run is replicated (parameters) or the rank's own (its
replay shard and env carry); for the latter pass ``per_host=True``, which
writes and reads one file per rank, ``path + ".host{rank}"``.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

CHECKPOINT_VERSION = 2


def _map(fn, tree):
  """Apply ``fn`` to every tensor or array leaf, keeping containers."""
  if isinstance(tree, (torch.Tensor, np.ndarray)):
    return fn(tree)
  if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
    return dataclasses.replace(tree, **{
        f.name: _map(fn, getattr(tree, f.name))
        for f in dataclasses.fields(tree)})
  if isinstance(tree, tuple) and hasattr(tree, "_fields"):
    return type(tree)(*(_map(fn, v) for v in tree))
  if isinstance(tree, (list, tuple)):
    return type(tree)(_map(fn, v) for v in tree)
  if isinstance(tree, dict):
    return type(tree)((k, _map(fn, v)) for k, v in tree.items())
  return tree


def to_numpy(tree: Any) -> Any:
  """Every tensor leaf as a numpy array (a copy on the host)."""
  return _map(lambda x: x.detach().cpu().numpy()
              if isinstance(x, torch.Tensor) else x, tree)


def to_torch(tree: Any, device) -> Any:
  """Every numpy leaf as a tensor on ``device``."""
  return _map(lambda x: torch.from_numpy(np.array(x)).to(device)
              if isinstance(x, np.ndarray) else x, tree)


def _rank_and_world() -> tuple:
  """This process's rank and the world's size; (0, 1) without a process
  group."""
  if dist.is_available() and dist.is_initialized():
    return dist.get_rank(), dist.get_world_size()
  return 0, 1


def _write(path: str, tree: Any) -> None:
  os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
  tmp = path + ".tmp"
  with open(tmp, "wb") as f:
    pickle.dump(to_numpy(tree), f)
  os.replace(tmp, path)  # atomic: a crash mid-write cannot corrupt the file


def save_pytree(path: str, tree: Any) -> None:
  """Pickle ``tree`` with numpy leaves; atomic (written then renamed). On a
  rank other than 0 it writes nothing."""
  if _rank_and_world()[0] == 0:
    _write(path, tree)


def _host_path(path: str, per_host: bool) -> str:
  rank, world = _rank_and_world()
  if per_host and world > 1:
    return f"{path}.host{rank}"
  return path


def load_pytree(path: str) -> Any:
  """The tree of ``save_pytree``, numpy leaves."""
  with open(path, "rb") as f:
    return pickle.load(f)


def save_checkpoint(path: str, *, train_state, replay_state, env_carry,
                    generator: torch.Generator, iteration: int,
                    counters: Optional[dict] = None,
                    per_host: bool = False) -> None:
  """Snapshot everything ``fit`` needs to continue deterministically.
  ``train_state.params`` goes in as its ``state_dict``. With ``per_host``
  in a world of more than one process, every rank writes its own
  ``path + ".host{rank}"``; otherwise only rank 0 writes ``path``."""
  payload = {
      "version": CHECKPOINT_VERSION,
      "train_state": dataclasses.replace(
          train_state, params=dict(train_state.params.state_dict())),
      "replay_state": replay_state,
      "env_carry": env_carry,
      "generator": generator.get_state(),
      "iteration": iteration,
      "counters": dict(counters or {}),
  }
  target = _host_path(path, per_host)
  if target != path:
    _write(target, payload)
  else:
    save_pytree(path, payload)


def load_checkpoint(path: str, device=None, per_host: bool = False) -> dict:
  """Load a snapshot. With ``device``, the train state, ring and env carry
  come back as tensors there; the generator state always comes back as the
  CPU byte tensor that ``torch.Generator.set_state`` takes. ``per_host``
  reads this rank's file of ``save_checkpoint(per_host=True)``."""
  payload = load_pytree(_host_path(path, per_host))
  version = payload.get("version")
  if version != CHECKPOINT_VERSION:
    raise ValueError(f"checkpoint version {version} != "
                     f"{CHECKPOINT_VERSION} at {path}")
  out = dict(payload)
  out["generator"] = torch.from_numpy(np.array(payload["generator"]))
  if device is not None:
    for key in ("train_state", "replay_state", "env_carry"):
      out[key] = to_torch(payload[key], device)
  return out
