"""Equity x stochastic rates: GBM under a Vasicek short rate, with the
exact joint transition.

    dS/S = r_t dt + sigma_s dW_s
    dr   = kappa (theta - r) dt + sigma_r dW_r,   corr(dW_s, dW_r) = rho

The port of ``montecarlo_tpu/processes/hybrid.py``.  Over one step the
triple (r_{t+dt}, int_t^{t+dt} r du, sigma_s W_s(dt)) is jointly Gaussian
given r_t with a state-independent covariance, factored once by ``create``
(host float64 Cholesky, a 1e-18 jitter for rho = +-1); each step maps
three unit normals through it:

    log S += X2 - sigma_s^2 dt / 2 + X3,   integ += X2,   r = X1,

so the discount ``exp(-integ)`` is exact along each path and a run has no
time-discretization error.  Every float operation is the JAX package's,
in its order; the leaves keep ``create``'s dtype and are cast in
``step``.  No kernel runs the hybrid (the JAX package runs it under its
own scan): ``hybrid_price_mc`` walks the state on the torch loop with
the plain sampler, keyed ``key_from_seed(seed, 0)``, the words of JAX's
``key_from_seed_dynamic(seed, 0)``.

``hybrid_call_closed_form`` is the T-forward-measure Black price with the
integrated equity and bond variance (Merton 1973), host float64.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import ClassVar, NamedTuple

import numpy as np
import torch

from montecarlo_tpu_torch.device import resolve_device
from montecarlo_tpu_torch.processes.base import (NormalDrawsMixin,
                                                 grad_safe_sqrt)
from montecarlo_tpu_torch.rng.normal import exp32, log32


class HybridState(NamedTuple):
    log_s: torch.Tensor  # (n_paths,)
    r: torch.Tensor      # (n_paths,) short rate
    integ: torch.Tensor  # (n_paths,) exact running integral of r du


def _transition_constants(kappa: float, sigma_r: float, sigma_s: float,
                          rho: float, dt: float):
    """(e^{-kappa dt}, B(dt), the (3, 3) Cholesky factor) of one step's
    (r', int r, sigma_s W_s) given r, host float64."""
    k = float(kappa)
    e1 = math.exp(-k * dt)
    b1 = (1.0 - e1) / k
    c2 = (1.0 - math.exp(-2.0 * k * dt)) / (2.0 * k)
    cov = np.array([
        [sigma_r**2 * c2,
         sigma_r**2 * (b1 - c2) / k,
         rho * sigma_s * sigma_r * b1],
        [sigma_r**2 * (b1 - c2) / k,
         sigma_r**2 * (dt - 2.0 * b1 + c2) / k**2,
         rho * sigma_s * sigma_r * (dt - b1) / k],
        [rho * sigma_s * sigma_r * b1,
         rho * sigma_s * sigma_r * (dt - b1) / k,
         sigma_s**2 * dt],
    ], np.float64)
    chol = np.linalg.cholesky(cov + 1e-18 * np.eye(3))
    return e1, b1, chol


@dataclass(frozen=True)
class EquityVasicekHybrid(NormalDrawsMixin):
    """GBM equity under Vasicek short rates, exact joint transition.
    Every field is a tensor in ``create``'s dtype (0-d, and ``chol``
    (3, 3))."""

    s0: torch.Tensor
    r0: torch.Tensor
    kappa: torch.Tensor
    theta: torch.Tensor
    sigma_r: torch.Tensor
    sigma_s: torch.Tensor
    rho: torch.Tensor
    dt: torch.Tensor
    decay: torch.Tensor  # e^{-kappa dt}
    b1: torch.Tensor     # B(dt)
    chol: torch.Tensor   # (3, 3) transition Cholesky factor

    n_draws: ClassVar[int] = 3
    #: The exposure components: equity trades mark off the spot, rate
    #: trades off the short rate, and the running integral discounts.
    exposure_components: ClassVar[tuple] = ("s", "r", "integ")
    exposure_discount_kind: ClassVar[str] = "exact"

    @classmethod
    def create(cls, s0, r0, kappa, theta, sigma_r, sigma_s, rho, dt,
               dtype=torch.float32, device="cuda") -> "EquityVasicekHybrid":
        if float(kappa) <= 0.0:
            raise ValueError("kappa must be positive")
        if not -1.0 <= float(rho) <= 1.0:
            raise ValueError("need -1 <= rho <= 1")
        e1, b1, chol = _transition_constants(float(kappa), float(sigma_r),
                                             float(sigma_s), float(rho),
                                             float(dt))
        dev = resolve_device(device)
        as_ = lambda v: torch.as_tensor(v, dtype=dtype, device=dev)
        return cls(s0=as_(s0), r0=as_(r0), kappa=as_(kappa),
                   theta=as_(theta), sigma_r=as_(sigma_r),
                   sigma_s=as_(sigma_s), rho=as_(rho), dt=as_(dt),
                   decay=as_(e1), b1=as_(b1), chol=as_(chol))

    def init_state(self, path_ids) -> HybridState:
        shape = path_ids.shape
        return HybridState(log_s=log32(self.s0).expand(shape).clone(),
                           r=self.r0.expand(shape).clone(),
                           integ=torch.zeros(shape, dtype=self.s0.dtype,
                                             device=self.s0.device))

    def step(self, state: HybridState, eps, t) -> HybridState:
        dtype = state.log_s.dtype
        z1, z2, z3 = eps
        ch = self.chol.to(dtype)
        # The stochastic parts of (r', int r, sigma_s W_s).
        x1 = ch[0, 0] * z1
        x2 = ch[1, 0] * z1 + ch[1, 1] * z2
        x3 = ch[2, 0] * z1 + ch[2, 1] * z2 + ch[2, 2] * z3
        theta = self.theta.to(dtype)
        dev = state.r - theta
        r_new = theta + dev * self.decay.to(dtype) + x1
        inc_i = theta * self.dt.to(dtype) + dev * self.b1.to(dtype) + x2
        half_var = (0.5 * torch.square(self.sigma_s) * self.dt).to(dtype)
        return HybridState(log_s=state.log_s + (inc_i - half_var + x3),
                           r=r_new, integ=state.integ + inc_i)

    def prices(self, state: HybridState):
        return exp32(state.log_s)

    def log_prices(self, state: HybridState):
        return state.log_s

    def discount(self, state: HybridState):
        """The exact pathwise discount e^{-int_0^t r du}."""
        return exp32(-state.integ)

    # --- exposure protocol -----------------------------------------------
    def exposure_obs(self, state: HybridState):
        """(n_paths, 3): (S, r, int r du)."""
        return torch.stack([exp32(state.log_s), state.r, state.integ],
                           dim=-1)

    def pathwise_discount(self, obs):
        """Exact D(0, t_k) rows from (..., C, N) observations."""
        return exp32(-obs[..., 2, :])

    def wwr_state(self, obs):
        """The equity spot: the wrong-way intensity's state."""
        return obs[..., 0, :]

    def im_norm(self, dvs, obs, mpor):
        """Delta-normal IM std over the margin period: the equity shock
        ``S sigma_s sqrt(mpor)``, the rate shock the exact OU conditional
        std, folded with rho; the integral carries none."""
        dtype = dvs.dtype
        as_ = lambda v: torch.as_tensor(v, dtype=dtype, device=dvs.device)
        kap, m = as_(self.kappa), as_(mpor)
        sd_s = (as_(self.sigma_s) * torch.sqrt(m)) * obs[..., 0, :]
        sd_r = as_(self.sigma_r) * torch.sqrt(
            (1.0 - torch.exp(-2.0 * kap * m))
            / torch.clamp(2.0 * kap, min=1e-12))
        rho = as_(self.rho)
        a = dvs[..., 0, :] * sd_s
        b = dvs[..., 1, :] * sd_r
        # A matured book's rows are exactly zero: a finite gradient there.
        return grad_safe_sqrt(a * a + b * b + 2.0 * rho * a * b)


def hybrid_price_mc(process: EquityVasicekHybrid, payoff_fn, n_paths: int,
                    n_steps: int, *, seed: int, dtype=torch.float32) -> dict:
    """E[e^{-int r} payoff(S_T)] under the hybrid on the torch loop (the
    discount lives in the state).  Returns ``{"price", "std_err",
    "n_paths"}``, the mean and ``std(ddof=1)/sqrt(n)`` in ``dtype``."""
    from montecarlo_tpu_torch.engine.simulate import simulate

    vals = simulate(process, n_paths, n_steps, seed=seed, dtype=dtype,
                    observe=lambda p, s: p.discount(s)
                    * payoff_fn(p.prices(s)))
    n = torch.as_tensor(n_paths, dtype=dtype, device=vals.device)
    return {"price": torch.mean(vals),
            "std_err": torch.std(vals, correction=1) / torch.sqrt(n),
            "n_paths": n_paths}


def hybrid_call_closed_form(s0, strike, T, r0, kappa, theta, sigma_r,
                            sigma_s, rho):
    """The European call under the hybrid, exact: Black under the
    T-forward measure with variance ``sigma_s^2 T + 2 rho sigma_s sigma_r
    (T - B)/kappa + sigma_r^2 (T - 2B + C2)/kappa^2`` (host float64)."""
    from scipy.stats import norm

    from montecarlo_tpu_torch.engine.rates import vasicek_zcb

    k = float(kappa)
    b = (1.0 - math.exp(-k * T)) / k
    c2 = (1.0 - math.exp(-2.0 * k * T)) / (2.0 * k)
    v = (sigma_s**2 * T
         + 2.0 * rho * sigma_s * sigma_r * (T - b) / k
         + sigma_r**2 * (T - 2.0 * b + c2) / k**2)
    p0t = float(vasicek_zcb(r0, kappa, theta, sigma_r, T))
    d1 = (math.log(s0 / (strike * p0t)) + 0.5 * v) / math.sqrt(v)
    d2 = d1 - math.sqrt(v)
    return s0 * norm.cdf(d1) - strike * p0t * norm.cdf(d2)


__all__ = ["EquityVasicekHybrid", "HybridState", "hybrid_call_closed_form",
           "hybrid_price_mc"]
