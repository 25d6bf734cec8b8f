"""Root noising and action-sampling helpers of the search policies
(``muax_tpu/search/policies.py:37-59``).

Only the helpers that the fused MuZero policy uses live here so far; the
generic ``muzero_policy`` comes with the generic search engine.
"""
from __future__ import annotations

from typing import Optional

import torch

_BIG_NEG = -1e9


def _get_logits_from_probs(probs: torch.Tensor) -> torch.Tensor:
  tiny = torch.finfo(probs.dtype).tiny
  return torch.log(torch.clamp(probs, min=tiny))


def _apply_temperature(logits: torch.Tensor, temperature) -> torch.Tensor:
  """temperature -> 0 degrades gracefully to argmax."""
  logits = logits - torch.amax(logits, dim=-1, keepdim=True)
  tiny = torch.finfo(logits.dtype).tiny
  temperature = torch.as_tensor(temperature, dtype=logits.dtype,
                                device=logits.device)
  return logits / torch.clamp(temperature, min=tiny)


def _mask_invalid(logits: torch.Tensor, invalid: Optional[torch.Tensor]):
  if invalid is None:
    return logits
  return torch.where(invalid > 0, torch.full_like(logits, _BIG_NEG), logits)


def _sample_gamma(alpha: float, shape, generator: torch.Generator
                  ) -> torch.Tensor:
  """Gamma(alpha, 1) draws from ``generator`` on its device (f32).

  Marsaglia and Tsang's squeeze for shape >= 1; a shape below 1 draws
  Gamma(alpha + 1) and scales by U^(1/alpha). Rejected candidates are
  redrawn until every entry is accepted (acceptance is above 95%).
  """
  device = generator.device
  boost = alpha < 1.0
  d = (alpha + 1.0 if boost else alpha) - 1.0 / 3.0
  c = 1.0 / (9.0 * d) ** 0.5
  out = torch.zeros(shape, dtype=torch.float32, device=device)
  todo = torch.ones(shape, dtype=torch.bool, device=device)
  while bool(todo.any()):
    x = torch.randn(shape, generator=generator, device=device)
    u = torch.rand(shape, generator=generator, device=device)
    v = (1.0 + c * x) ** 3
    ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                    + d * torch.log(torch.clamp(v, min=1e-30)))
    take = todo & ok
    out = torch.where(take, d * v, out)
    todo = todo & ~ok
  if boost:
    u = torch.rand(shape, generator=generator, device=device)
    out = out * u ** (1.0 / alpha)
  return out


def _add_dirichlet_noise(generator: torch.Generator, probs: torch.Tensor, *,
                         fraction: float, alpha: float) -> torch.Tensor:
  """(1 - fraction) * probs + fraction * Dirichlet(alpha), one draw per row."""
  gammas = _sample_gamma(alpha, probs.shape, generator)
  tiny = torch.finfo(gammas.dtype).tiny
  noise = gammas / torch.clamp(torch.sum(gammas, dim=-1, keepdim=True),
                               min=tiny)
  return (1.0 - fraction) * probs + fraction * noise
