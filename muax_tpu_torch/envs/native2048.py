"""Batched 2048 through the native C++ pool (``muax_tpu/envs/native2048.py``
over ``native/env2048.cpp``).

The C++ pool advances all N boards in worker threads; the device program
sees one host call per rollout step. The pool speaks the
``AutoResetWrapper`` interface, so ``fit`` and ``make_rollout_fn`` take it
as it is; the legal-move mask that the C++ step computes rides in the
carry's ``env_state`` and reaches the search as ``invalid_actions``.

The library is built from ``native/env2048.cpp`` with ``g++ -O3 -shared
-fPIC -pthread`` at first use, into ``build/native/`` at the root of the
checkout, named by a hash of the source and the flags (as ``_build.py``
names the kernels). ``native/`` is only read: neither its source nor the
library beside it is written or loaded.
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
from typing import Optional

import numpy as np
import torch

from muax_tpu_torch.device import resolve_device
from muax_tpu_torch.envs.base import AutoResetState, EnvSpec
from muax_tpu_torch.envs.gym_adapter import HostPool

_ROOT = pathlib.Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "env2048.cpp"
BUILD_DIR = _ROOT / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> pathlib.Path:
  digest = hashlib.sha256(SOURCE.read_bytes()
                          + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
  return BUILD_DIR / f"libenv2048-{digest}.so"


def _build() -> pathlib.Path:
  out = library_path()
  if out.exists():
    return out
  gxx = shutil.which("g++")
  if gxx is None:
    raise RuntimeError("g++ not found: the 2048 pool builds native/"
                       "env2048.cpp with it")
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
  os.close(fd)
  proc = subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, str(SOURCE)],
                        capture_output=True, text=True)
  if proc.returncode != 0:
    os.unlink(tmp)
    raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{proc.stderr}")
  os.replace(tmp, out)  # atomic: a concurrent build leaves one good file
  return out


def load_library() -> ctypes.CDLL:
  """The pool's library, built at first use."""
  global _lib
  with _lock:
    if _lib is None:
      lib = ctypes.CDLL(str(_build()))
      lib.env2048_create.restype = ctypes.c_void_p
      lib.env2048_create.argtypes = [ctypes.c_int, ctypes.c_uint64,
                                     ctypes.c_int]
      lib.env2048_destroy.argtypes = [ctypes.c_void_p]
      ptr = ctypes.c_void_p
      lib.env2048_observe.argtypes = [ptr, ptr, ptr]
      lib.env2048_reset_all.argtypes = [ptr]
      lib.env2048_step.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr]
      _lib = lib
    return _lib


class Native2048Pool(HostPool):
  """N native 2048 boards; observations [4, 4] of tile exponents (float32)
  on ``device`` (the card by default; ``device="cpu"`` for the CPU)."""

  def __init__(self, num_envs: int, seed: int = 0,
               num_threads: Optional[int] = None,
               max_episode_steps: int = 2048, device="cuda"):
    self.device = resolve_device(device)
    self._lib = load_library()
    self.num_envs = num_envs
    threads = num_threads or min(8, os.cpu_count() or 1)
    self._handle = ctypes.c_void_p(self._lib.env2048_create(
        num_envs, seed, threads))
    self.spec = EnvSpec(observation_shape=(4, 4), num_actions=4,
                        max_episode_steps=max_episode_steps)
    # The host's buffers, reused every step.
    self._obs = np.zeros((num_envs, 16), np.float32)
    self._reward = np.zeros((num_envs,), np.float32)
    self._done = np.zeros((num_envs,), np.uint8)
    self._mask = np.zeros((num_envs, 4), np.float32)
    self._action = np.zeros((num_envs,), np.int32)

  def __del__(self):
    if getattr(self, "_handle", None):
      self._lib.env2048_destroy(self._handle)
      self._handle = None

  # -- host side -----------------------------------------------------------
  def _host_reset_all(self):
    self._lib.env2048_reset_all(self._handle)
    self._lib.env2048_observe(self._handle, self._obs.ctypes.data,
                              self._mask.ctypes.data)
    return self._obs.reshape(self.num_envs, 4, 4), self._mask

  def _host_step(self, action):
    self._action[:] = action
    self._lib.env2048_step(
        self._handle, self._action.ctypes.data, self._obs.ctypes.data,
        self._reward.ctypes.data, self._done.ctypes.data,
        self._mask.ctypes.data)
    return (self._obs.reshape(self.num_envs, 4, 4), self._reward,
            self._done, self._mask)

  # -- device-facing API ---------------------------------------------------
  def legal_action_mask(self, carry: AutoResetState) -> torch.Tensor:
    """The [B, 4] legal mask (1 = legal) that the C++ step computed, which
    the carry holds on the device in ``env_state``."""
    return carry.env_state

  def reset(self, generator: torch.Generator,
            batch_size: int) -> AutoResetState:
    del generator  # the boards draw from their own seeds
    self._check_batch(batch_size)
    obs, mask = self._upload(*self._host_reset_all())
    return self._start(obs, env_state=mask)

  def step(self, carry: AutoResetState, action: torch.Tensor,
           generator: torch.Generator):
    del generator
    obs, reward, done, mask = self._upload(
        *self._host_step(action.cpu().numpy()))
    return self._advance(carry, obs, reward, done > 0, env_state=mask,
                         legal_mask=mask)
