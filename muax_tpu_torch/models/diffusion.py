"""SDE and flow-matching library of Diffusion MuZero
(``muax_tpu/models/diffusion.py``).

An ``SDE`` base class (marginal_prob, prior_sampling, prior_logp, the
Euler-Maruyama ``discretize``, and ``reverse``: the reverse SDE or the
probability-flow ODE) and its ``RectifiedFlow`` instance (zero drift,
sigma_t = (1 - t) * sigma, a Gaussian prior, the Euler ODE sampler, reflow
pairs), the flow-matching loss and the ``batch_mul``/``batch_add`` helpers.

Convention: t runs 0 -> 1 from the prior to the data, so
``x_t = t * x0 + (1 - t) * sigma * eps`` and the target velocity of the
straight path is ``x0 - sigma * eps``. Samplers integrate the learned
velocity field from t = 0 to t = 1.

Randomness comes from a ``torch.Generator`` where the JAX package takes a
key, and is drawn apart from the arithmetic: ``euler_integrate`` is a pure
function of its starting point, and ``flow_matching_draws`` gives the (t,
eps) pair that the losses consume (``diffusion_muzero_loss`` also takes it
injected), so that both packages can start from the same numbers.
"""
from __future__ import annotations

import abc
import math
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

VelocityFn = Callable[[torch.Tensor, torch.Tensor, Any], torch.Tensor]


def batch_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Multiply a per-example vector ``a [B]`` into ``b [B, ...]``."""
  return a.reshape(a.shape + (1,) * (b.ndim - a.ndim)) * b


def batch_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Add a per-example vector ``a [B]`` onto ``b [B, ...]``."""
  return a.reshape(a.shape + (1,) * (b.ndim - a.ndim)) + b


class SDE(abc.ABC):
  """Forward SDE ``dx = f(x, t) dt + g(t) dw`` on t in [0, 1]."""

  def __init__(self, num_steps: int = 100):
    self.num_steps = int(num_steps)

  @abc.abstractmethod
  def sde(self, x: torch.Tensor,
          t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drift f(x, t) [B, ...] and diffusion g(t) [B]."""

  @abc.abstractmethod
  def marginal_prob(self, x0: torch.Tensor,
                    t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean [B, ...] and std [B] of x_t | x0."""

  @abc.abstractmethod
  def prior_sampling(self, generator: torch.Generator, shape) -> torch.Tensor:
    """Draw from the t = 0 prior on the generator's device."""

  @abc.abstractmethod
  def prior_logp(self, z: torch.Tensor) -> torch.Tensor:
    """Log-density of the prior at z, reduced over non-batch dims -> [B]."""

  def discretize(self, x: torch.Tensor,
                 t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Euler-Maruyama step: returns (f(x,t)*dt, g(t)*sqrt(dt))."""
    dt = 1.0 / self.num_steps
    drift, diffusion = self.sde(x, t)
    return drift * dt, diffusion * math.sqrt(dt)

  def reverse(self, score_fn: Callable, probability_flow: bool = False):
    """Reverse-time process: the reverse SDE
    ``dx = [f - g^2 score] dt + g dw`` or the probability-flow ODE
    ``dx = [f - 0.5 g^2 score] dt`` (zero diffusion)."""
    fwd_sde, num_steps = self.sde, self.num_steps

    class _Reverse:

      def sde(self, x, t):
        drift, diffusion = fwd_sde(x, t)
        scale = 0.5 if probability_flow else 1.0
        rev_drift = drift - scale * batch_mul(diffusion**2, score_fn(x, t))
        rev_diffusion = (torch.zeros_like(diffusion) if probability_flow
                         else diffusion)
        return rev_drift, rev_diffusion

      def discretize(self, x, t):
        dt = 1.0 / num_steps
        drift, diffusion = self.sde(x, t)
        return drift * dt, diffusion * math.sqrt(dt)

    return _Reverse()


def euler_integrate(velocity_fn: VelocityFn, x0: torch.Tensor,
                    num_steps: int, cond: Any = None) -> torch.Tensor:
  """Integrate dx/dt = v(x, t, cond) from ``x0`` at t = 0 to t = 1 in
  ``num_steps`` fixed Euler steps; step i evaluates at t = i * dt, rounded
  in float32 as the JAX package's loop counter times dt is."""
  dt = np.float32(1.0 / num_steps)
  x = x0
  for i in range(num_steps):
    t = torch.full((x0.shape[0],), float(np.float32(i) * dt), dtype=x.dtype,
                   device=x.device)
    x = x + float(dt) * velocity_fn(x, t, cond)
  return x


class RectifiedFlow(SDE):
  """Straight-path transport N(0, sigma^2) -> data: zero drift,
  sigma_t = (1 - t) * sigma."""

  def __init__(self, sigma: float = 1.0, num_steps: int = 100):
    super().__init__(num_steps=num_steps)
    self.sigma = float(sigma)

  def sde(self, x, t):
    return torch.zeros_like(x), torch.zeros(x.shape[0], dtype=x.dtype,
                                            device=x.device)

  def marginal_prob(self, x0, t):
    return batch_mul(t, x0), (1.0 - t) * self.sigma

  def prior_sampling(self, generator, shape):
    return self.sigma * torch.randn(shape, generator=generator,
                                    device=generator.device)

  def prior_logp(self, z):
    dims = math.prod(z.shape[1:])
    quad = torch.sum(torch.square(z.reshape(z.shape[0], -1)), -1)
    return (-0.5 * dims * math.log(2 * math.pi * self.sigma**2)
            - quad / (2 * self.sigma**2))

  def euler_ode(self, velocity_fn: VelocityFn, generator: torch.Generator,
                shape, cond: Any = None, num_steps: Optional[int] = None
                ) -> torch.Tensor:
    """Integrate the velocity field from a prior draw (t = 0) to t = 1
    with a fixed-step Euler scheme."""
    return euler_integrate(velocity_fn,
                           self.prior_sampling(generator, shape),
                           int(num_steps or self.num_steps), cond)

  def reflow_pairs(self, velocity_fn: VelocityFn, generator: torch.Generator,
                   shape, cond: Any = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(noise, generated sample) couplings for reflow retraining."""
    z = self.prior_sampling(generator, shape)
    return z, euler_integrate(velocity_fn, z, self.num_steps, cond)


def flow_matching_draws(generator: torch.Generator, x0: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
  """The (t [B] uniform, eps [B, ...] normal) pair of one flow-matching
  loss, from ``generator``."""
  t = torch.rand((x0.shape[0],), generator=generator,
                 device=generator.device, dtype=x0.dtype)
  eps = torch.randn(x0.shape, generator=generator, device=generator.device,
                    dtype=x0.dtype)
  return t, eps


def flow_matching_loss(velocity_fn: VelocityFn, generator: torch.Generator,
                       x0: torch.Tensor, *, flow: RectifiedFlow,
                       cond: Any = None) -> torch.Tensor:
  """Rectified-flow matching: regress the velocity net onto the straight
  path's constant velocity ``x0 - sigma * eps`` at a random time."""
  t, eps = flow_matching_draws(generator, x0)
  mean, std = flow.marginal_prob(x0, t)
  x_t = mean + batch_mul(std, eps)
  target = x0 - flow.sigma * eps
  pred = velocity_fn(x_t, t, cond)
  return torch.mean(torch.square(pred - target))
