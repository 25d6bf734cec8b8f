"""Configuration tree: the same dataclasses, fields and defaults as
``muax_tpu/config.py``, kept as the port's own copy."""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Callable, Optional


@dataclasses.dataclass
class SearchConfig:
  """Search policy settings (reference defaults: muax/policy.py:13-67,
  acme/jax/muzero/config.py:17-35)."""
  policy: str = "muzero"          # muzero | gumbel | stochastic
  num_simulations: int = 50
  max_depth: Optional[int] = None
  dirichlet_fraction: float = 0.25
  dirichlet_alpha: float = 0.3
  pb_c_init: float = 1.25
  pb_c_base: float = 19652.0
  max_num_considered_actions: int = 16  # gumbel
  gumbel_scale: float = 1.0             # gumbel
  num_chance_outcomes: int = 32         # stochastic codebook size
  # Use the fused search kernel (search/fused.py) for the MLP triplet.
  fused: bool = True
  # Batch-tile rows of the JAX package's kernel; the port's kernel sizes its
  # own blocks and ignores it.
  batch_tile: Optional[int] = None
  # Search budget for reanalyze target refresh (None = num_simulations).
  reanalyze_simulations: Optional[int] = None


@dataclasses.dataclass
class ReplayConfig:
  capacity: int = 4096            # segments per shard
  segment_length: int = 20
  min_fill: int = 128             # segments before learning starts
  priority_alpha: float = 0.5     # PNStep alpha (episode_tracer.py:197-249)
  # Fraction of each learner batch drawn by priority over the whole ring;
  # the remainder is drawn uniformly from the `online_queue_size` newest
  # segments. 1.0 = pure PER.
  offline_fraction: float = 1.0
  online_queue_size: int = 1024


@dataclasses.dataclass
class TrainConfig:
  """End-to-end training settings; defaults target the CartPole parity run
  (BASELINE.md CartPole configs)."""
  num_envs: int = 128
  collect_steps: int = 20          # env steps per iteration (= seg length)
  batch_size: int = 256            # windows per update
  updates_per_iteration: int = 8
  unroll_steps: int = 5            # k
  n_bootstrap: int = 10            # n-step return horizon
  bootstrap_lambda: float = 1.0
  discount: float = 0.997
  l2_coef: float = 1e-4
  gradient_scale: float = 0.5      # hidden-state grad scaling in unroll
  # Temperature schedule (train.py:16-23): fractions of total steps.
  temperature_schedule: tuple = ((0.5, 1.0), (0.75, 0.5), (1.0, 0.25))
  # Samples-per-insert rate gate; None disables it.
  samples_per_insert: Optional[float] = None
  spi_tolerance: float = 0.1
  # Fused learner kernel (loss + backward as one op for the MLP family).
  fused_learner: bool = True
  # Fused replay sampler kernel feeding the raw-input learner kernel.
  fused_sampler: bool = True
  # Updates per one replay sample call (presampled group).
  presample_updates: int = 8
  # Dataset-side observation transform applied to sampled observations in
  # the learner only. Signature: transform(generator, obs[B, L, ...]) -> obs.
  observation_transform: Optional[Callable] = None


@dataclasses.dataclass
class MuZeroConfig:
  search: SearchConfig = dataclasses.field(default_factory=SearchConfig)
  replay: ReplayConfig = dataclasses.field(default_factory=ReplayConfig)
  train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

  def __post_init__(self):
    if self.replay.segment_length != self.train.collect_steps:
      # Segments are produced by the rollout; keep the shapes consistent.
      self.replay.segment_length = self.train.collect_steps


def config_hash(config: MuZeroConfig) -> str:
  """Deterministic 16-hex digest of the config tree (the same digest the
  JAX package computes for an equal config)."""
  d = dataclasses.asdict(config)
  blob = json.dumps(
      d, sort_keys=True,
      # Callables (observation_transform) hash by name, not identity, so the
      # digest is stable across processes.
      default=lambda o: getattr(o, "__name__", o.__class__.__name__))
  return hashlib.sha256(blob.encode()).hexdigest()[:16]
