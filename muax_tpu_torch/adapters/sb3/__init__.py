"""stable-baselines3 adapter (``muax_tpu/adapters/sb3``; the reference's
muax/frameworks/sb3, marked "not recommended yet" at sb3/README.md:1-3).

``MuaxRolloutBuffer`` is dependency-free numpy and always importable;
``MuaxPolicy`` / ``OnPolicyAlgorithmMuax`` require stable-baselines3 and
raise a descriptive ImportError without it.
"""
from muax_tpu_torch.adapters.sb3.buffers import (
    MuaxRolloutBuffer,
    MuaxRolloutBufferSamples,
)

__all__ = ["MuaxRolloutBuffer", "MuaxRolloutBufferSamples",
           "MuaxPolicy", "OnPolicyAlgorithmMuax"]


def __getattr__(name):
  if name in ("MuaxPolicy", "OnPolicyAlgorithmMuax"):
    from muax_tpu_torch.adapters.sb3 import sb3_bridge
    return getattr(sb3_bridge, name)
  raise AttributeError(name)
