"""Device mesh construction (``muax_tpu/parallel/mesh.py``).

The JAX package runs the whole agent as one SPMD program over a
``jax.sharding.Mesh``; the port runs one process per rank of a
``torch.distributed`` world and lays the ranks out as a
``torch.distributed.device_mesh.DeviceMesh``. Axes:
  * ``data``  — env-batch, search-batch and replay sharding (the scaling
    axis),
  * ``model`` — optional channel sharding of the AlphaZero conv tower
    (``parallel/model_parallel.py``).

The process group must exist first: ``parallel/multihost.py``'s
``initialize_and_make_mesh`` makes it and the mesh in one call.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(mesh_shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = (DATA_AXIS,),
              device="cuda") -> DeviceMesh:
  """A mesh over every rank of the world, on ``device``'s type (the card
  unless the caller passes ``device="cpu"``).

  Default: a 1-D data mesh over every rank, ``(world,) + (1,) * (n - 1)``
  for ``n`` axis names. Raises ``ValueError`` when the shape does not cover
  the world.
  """
  if not dist.is_initialized():
    raise RuntimeError("make_mesh needs a process group: call "
                       "torch.distributed.init_process_group (or "
                       "multihost.initialize_and_make_mesh) first")
  world = dist.get_world_size()
  if mesh_shape is None:
    mesh_shape = (world,) + (1,) * (len(axis_names) - 1)
  mesh_shape = tuple(int(n) for n in mesh_shape)
  if math.prod(mesh_shape) != world:
    raise ValueError(f"mesh shape {mesh_shape} does not cover {world} ranks")
  if len(mesh_shape) != len(axis_names):
    raise ValueError(f"mesh shape {mesh_shape} does not match the axis "
                     f"names {tuple(axis_names)}")
  return init_device_mesh(torch.device(device).type, mesh_shape,
                          mesh_dim_names=tuple(axis_names))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
  """Ranks along ``axis`` of ``mesh`` (1 for an axis the mesh lacks)."""
  names = mesh.mesh_dim_names or ()
  return mesh.size(names.index(axis)) if axis in names else 1


# ``torch.distributed.tensor`` takes about a second to import: it is
# imported where DTensor placements are made, not with the package.


def data_sharding(mesh: DeviceMesh) -> tuple:
  """Leading-axis sharding over the data axis, as DTensor placements."""
  from torch.distributed.tensor import Replicate, Shard
  return tuple(Shard(0) if name == DATA_AXIS else Replicate()
               for name in mesh.mesh_dim_names)


def replicated(mesh: DeviceMesh) -> tuple:
  from torch.distributed.tensor import Replicate
  return tuple(Replicate() for _ in mesh.mesh_dim_names)
