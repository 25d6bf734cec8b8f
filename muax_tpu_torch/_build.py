"""Build and load the port's CUDA kernels at first use.

Each source under ``csrc/`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. Libraries
land in ``build/kernels/`` at the root of the checkout, named by a hash of
the source, the headers beside it and the flags, so an edited source or
header is rebuilt and an unchanged one is not. ``build_all`` starts one ``nvcc`` per source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = ("fused_search", "fused_sampler", "fused_learner")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
  path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
  if not os.path.exists(path):
    raise RuntimeError("nvcc not found: the CUDA kernels of muax_tpu_torch "
                       "are built with the CUDA toolkit's nvcc")
  return path


def library_path(name: str) -> pathlib.Path:
  source = (_CSRC / f"{name}.cu").read_bytes()
  headers = b"".join(p.read_bytes() for p in sorted(_CSRC.glob("*.cuh")))
  digest = hashlib.sha256(source + headers + " ".join(NVCC_FLAGS).encode())
  return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
  """Start nvcc for ``name`` into a temporary file; None if already built."""
  out = library_path(name)
  if out.exists():
    return None
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
  os.close(fd)
  proc = subprocess.Popen(
      [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(_CSRC / f"{name}.cu")],
      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
  return proc, tmp, out


def _finish(name: str, job) -> str:
  """Wait for a job of ``_start``; returns nvcc's output (register and
  shared-memory use of each kernel)."""
  if job is None:
    return ""
  proc, tmp, out = job
  log, _ = proc.communicate()
  if proc.returncode != 0:
    os.unlink(tmp)
    raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
  os.replace(tmp, out)  # atomic: a concurrent build leaves one good file
  return log


def build_all() -> dict:
  """Build every kernel source in parallel; returns nvcc's output by name."""
  jobs = {name: _start(name) for name in SOURCES}
  return {name: _finish(name, job) for name, job in jobs.items()}


def load(name: str) -> ctypes.CDLL:
  """The loaded library of ``csrc/<name>.cu``, building it if needed."""
  with _lock:
    lib = _loaded.get(name)
    if lib is None:
      _finish(name, _start(name))
      lib = ctypes.CDLL(str(library_path(name)))
      _loaded[name] = lib
    return lib
