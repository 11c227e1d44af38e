"""Short-rate models: Vasicek, CIR and Hull–White (extended Vasicek).

The port of ``montecarlo_tpu/processes/shortrate.py``.  Each is a
scalar-state process whose observable (``prices``) is the short rate r_t;
the bond pricers of :mod:`montecarlo_tpu_torch.engine.rates` discount by
the trapezoid integral of it.  They have no ``log_prices``.

- **Vasicek** ``dr = kappa (theta - r) dt + sigma dW``, the exact
  Ornstein–Uhlenbeck transition:
  ``r' = (theta + (r - theta) decay) + scale z``, ``decay =
  exp32((-kappa) dt)``, ``scale = sigma sqrt((1 - exp32(((-2) kappa) dt))
  / (2 kappa))``.
- **CIR** ``dr = kappa (theta - r) dt + sigma sqrt(r) dW``, full-truncation
  Euler: ``r' = (r + (kappa dt) (theta - r+)) + ((sigma sqrt(dt))
  sqrt(r+)) z``, ``r+ = max(r, 0)``.
- **Hull–White** ``dr = (theta(t) - a r) dt + sigma dW``, the exact OU
  transition with theta frozen within a step, read from a per-step curve:
  ``r' = (r decay + (theta_t / a)(1 - decay)) + scale z``.  The curve is
  stored as given (the JAX package pads it to a multiple of 128 for
  Mosaic's layout; a JAX process's padded curve comes across as it is); a
  step past its end raises ``ValueError`` (``max_steps``).

Every step uses the float32 operations of the JAX package, in its order.
K2, K3 and K4 run them as ``RateProc<mc::VasicekStep, 1>``,
``RateProc<mc::CirStep, 1>`` and ``RateProc<mc::HullWhiteStep, 1>``
(``csrc/rate_steps.cuh``, ``csrc/fused_rates.cu``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, NamedTuple

import numpy as np
import torch

from montecarlo_tpu_torch.device import resolve_device
from montecarlo_tpu_torch.processes.base import (NormalDrawsMixin,
                                                 curve_at, f32_leaves)
from montecarlo_tpu_torch.rng.normal import exp32


class RateState(NamedTuple):
    r: torch.Tensor  # (n_paths,)


class _RateMixin(NormalDrawsMixin):
    n_draws: ClassVar[int] = 1

    def init_state(self, path_ids) -> RateState:
        return RateState(r=self.r0.expand(path_ids.shape).clone())

    def prices(self, state: RateState):
        return state.r


def ou_decay_scale(k: torch.Tensor, sigma: torch.Tensor, dt: torch.Tensor):
    """(decay, scale) of the exact OU step over ``dt`` at mean reversion
    ``k``: ``exp32((-k) dt)`` and ``sigma sqrt((1 - exp32(((-2) k) dt)) /
    (2 k))``, float32, in the JAX package's order."""
    decay = exp32(-k * dt)
    scale = sigma * torch.sqrt((1.0 - exp32(-2.0 * k * dt)) / (2.0 * k))
    return decay, scale


@dataclass(frozen=True)
class Vasicek(_RateMixin):
    """Ornstein–Uhlenbeck short rate, exact per-step transition.  Every
    field is a 0-d float32 tensor."""

    r0: torch.Tensor
    kappa: torch.Tensor
    theta: torch.Tensor
    sigma: torch.Tensor
    dt: torch.Tensor

    @classmethod
    def create(cls, r0, kappa, theta, sigma, dt, device="cuda") -> "Vasicek":
        return cls(**f32_leaves(device, r0=r0, kappa=kappa, theta=theta,
                                sigma=sigma, dt=dt))

    def step(self, state: RateState, eps, t) -> RateState:
        decay, scale = ou_decay_scale(self.kappa, self.sigma, self.dt)
        return RateState(r=self.theta + (state.r - self.theta) * decay
                         + scale * eps[0])


@dataclass(frozen=True)
class CIR(_RateMixin):
    """Cox–Ingersoll–Ross square-root rate, full-truncation Euler.  Every
    field is a 0-d float32 tensor."""

    r0: torch.Tensor
    kappa: torch.Tensor
    theta: torch.Tensor
    sigma: torch.Tensor
    dt: torch.Tensor

    @classmethod
    def create(cls, r0, kappa, theta, sigma, dt, device="cuda") -> "CIR":
        return cls(**f32_leaves(device, r0=r0, kappa=kappa, theta=theta,
                                sigma=sigma, dt=dt))

    def step(self, state: RateState, eps, t) -> RateState:
        r_plus = torch.clamp(state.r, min=0.0)
        kdt = self.kappa * self.dt
        vol = self.sigma * torch.sqrt(self.dt)
        return RateState(r=state.r + kdt * (self.theta - r_plus)
                         + vol * torch.sqrt(r_plus) * eps[0])


@dataclass(frozen=True)
class HullWhite(_RateMixin):
    """Hull–White one-factor, ``theta_t`` a per-step curve (per unit time)
    of any length >= 1.  ``r0``, ``a``, ``sigma`` and ``dt`` are 0-d
    float32 tensors, ``theta_t`` a 1-d float32 tensor."""

    r0: torch.Tensor
    a: torch.Tensor
    sigma: torch.Tensor
    theta_t: torch.Tensor
    dt: torch.Tensor

    @classmethod
    def create(cls, r0, a, sigma, theta_curve, dt,
               device="cuda") -> "HullWhite":
        theta_curve = np.asarray(theta_curve, np.float64).reshape(-1)
        if theta_curve.size < 1:
            raise ValueError("the theta curve needs at least one step")
        dev = resolve_device(device)
        as_ = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
        return cls(r0=as_(r0), a=as_(a), sigma=as_(sigma),
                   theta_t=as_(theta_curve), dt=as_(dt))

    @classmethod
    def from_forward_curve(cls, forwards, a, sigma, dt,
                           device="cuda") -> "HullWhite":
        """Fit theta(t) to market instantaneous forwards ``forwards[k] =
        f(0, k dt)``, k = 0..n_steps: the no-arbitrage drift (Hull–White
        1990) ``theta(t) = df/dt + a f(t) + sigma^2 / (2a) (1 - e^{-2at})``
        at the step midpoints, in float64 as the JAX package computes it,
        so the model reprices P(0, T) = exp(-int f) up to O(dt^2)."""
        f = np.asarray(forwards, np.float64)
        if f.size < 2:
            raise ValueError("need forwards on the step grid (>= 2 points)")
        dt_f = float(dt)
        n_steps = f.size - 1
        t_mid = (np.arange(n_steps) + 0.5) * dt_f
        dfdt = np.diff(f) / dt_f
        f_mid = 0.5 * (f[:-1] + f[1:])
        a_f, s_f = float(a), float(sigma)
        theta = dfdt + a_f * f_mid + (s_f**2 / (2.0 * a_f)
                                      * (1.0 - np.exp(-2.0 * a_f * t_mid)))
        return cls.create(f[0], a, sigma, theta, dt, device)

    @property
    def max_steps(self) -> int:
        return self.theta_t.numel()

    def step(self, state: RateState, eps, t) -> RateState:
        theta = curve_at(self.theta_t, t)
        decay, scale = ou_decay_scale(self.a, self.sigma, self.dt)
        mean_term = (theta / self.a) * (1.0 - decay)
        return RateState(r=state.r * decay + mean_term + scale * eps[0])
