"""Environment registry (``muax_tpu/envs/registry.py``): the reference's
selection of an env by string (muax/train.py:26-50 takes
``env_id='CartPole-v1'``).

``make(env_id, num_envs=...)`` resolves, in order:
  1. the port's on-device envs by registered name (case-insensitive,
     gym-style ``-vN`` suffixes accepted), the fast path;
  2. any other string to a ``GymVectorPool`` of host gymnasium envs, which
     needs ``num_envs``.
"""
from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def register(name: str, factory: Callable) -> None:
  """Register an on-device env's factory under ``name`` (matched in lower
  case)."""
  _REGISTRY[name.lower()] = factory


def _canonical(env_id: str) -> str:
  name = env_id.lower()
  # gym-style version suffixes map onto the on-device envs.
  for suffix in ("-v0", "-v1", "-v2", "-v3", "-v4", "-v5"):
    if name.endswith(suffix):
      return name[: -len(suffix)]
  return name


def make(env_id: str, num_envs: int = 0, seed: int = 0, device="cuda",
         **kwargs):
  """``env_id`` as an env: a registered on-device env, which ignores
  ``num_envs``, ``seed`` and ``device`` (it batches at reset, on the
  device of the generator it is given), else a ``GymVectorPool`` of
  ``num_envs`` host envs on ``device``. ``kwargs`` go to the factory or
  to ``gymnasium.make``."""
  key = _canonical(env_id)
  if key in _REGISTRY:
    return _REGISTRY[key](**kwargs)
  from muax_tpu_torch.envs.gym_adapter import GymVectorPool
  if num_envs <= 0:
    raise ValueError(
        f"{env_id!r} is not a registered on-device env "
        f"({sorted(_REGISTRY)}); pass num_envs to build a host gym pool")
  return GymVectorPool(env_id, num_envs=num_envs, seed=seed, device=device,
                       **kwargs)


def registered() -> tuple:
  return tuple(sorted(_REGISTRY))


def _install_defaults():
  from muax_tpu_torch.envs.cartpole import CartPole
  from muax_tpu_torch.envs.catch import Catch
  from muax_tpu_torch.envs.connect4 import ConnectFour
  from muax_tpu_torch.envs.pixel import PixelCatch
  from muax_tpu_torch.envs.tictactoe import TicTacToe
  register("cartpole", CartPole)
  register("catch", Catch)
  register("pixelcatch", PixelCatch)
  register("tictactoe", TicTacToe)
  register("connectfour", ConnectFour)
  register("connect4", ConnectFour)


_install_defaults()
