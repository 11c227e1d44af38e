"""Heston with the accrued variance in its state: equity and volatility
netting sets on one simulation.

The port of ``montecarlo_tpu/processes/heston_exposure.py``.  The step is
``processes.heston.Heston``'s full-truncation Euler (the same grouping of
the log-price increment, the same double ``where`` around the root at v+
= 0) plus the left-point accrual ``ivar += v+ dt``, the realized leg a
variance-swap mark needs.  The drift ``mu`` is the flat risk-neutral
rate.  The leaves keep ``create``'s dtype and are cast in ``step``.  No
kernel runs it: the JAX package's exposure engines run it under their
scan, and no command of the port reaches it yet (the ``xva`` command is
ROADMAP Queue 1 item 11b).

Trades on the (3, N) state columns (s, v, ivar):
``heston_forward_value_fn`` (``S - K e^{-r (T - t)}``) and
``heston_varswap_value_fn`` (the affine CIR mark ``e^{-r tau} ([ivar +
E(int_t^T v du | v)] / T - K)``, zero after T); the par variance strike
times T is ``heston_varswap_expected_total`` (host float64).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, NamedTuple

import numpy as np
import torch

from montecarlo_tpu_torch.device import resolve_device
from montecarlo_tpu_torch.processes.base import (NormalDrawsMixin,
                                                 grad_safe_sqrt)
from montecarlo_tpu_torch.rng.normal import exp32, log32


class HestonExposureState(NamedTuple):
    log_s: torch.Tensor  # (n_paths,)
    v: torch.Tensor      # (n_paths,); may go negative, truncated at use
    ivar: torch.Tensor   # (n_paths,) accrued sum v+ dt


@dataclass(frozen=True)
class HestonExposure(NormalDrawsMixin):
    """Heston full-truncation Euler with the accrued variance, exposing the
    components (s, v, ivar).  Every field is a 0-d tensor in ``create``'s
    dtype."""

    s0: torch.Tensor
    v0: torch.Tensor
    mu: torch.Tensor      # the flat risk-neutral rate r
    kappa: torch.Tensor
    theta: torch.Tensor
    xi: torch.Tensor
    rho: torch.Tensor
    dt: torch.Tensor

    n_draws: ClassVar[int] = 2
    exposure_components: ClassVar[tuple] = ("s", "v", "ivar")
    exposure_discount_kind: ClassVar[str] = "flat"

    @classmethod
    def create(cls, s0, v0, r, kappa, theta, xi, rho, dt,
               dtype=torch.float32, device="cuda") -> "HestonExposure":
        if float(kappa) <= 0.0:
            raise ValueError("kappa must be positive")
        if not -1.0 <= float(rho) <= 1.0:
            raise ValueError("need -1 <= rho <= 1")
        dev = resolve_device(device)
        as_ = lambda v: torch.as_tensor(v, dtype=dtype, device=dev)
        return cls(s0=as_(s0), v0=as_(v0), mu=as_(r), kappa=as_(kappa),
                   theta=as_(theta), xi=as_(xi), rho=as_(rho), dt=as_(dt))

    def init_state(self, path_ids) -> HestonExposureState:
        shape = path_ids.shape
        return HestonExposureState(
            log_s=log32(self.s0).expand(shape).clone(),
            v=self.v0.expand(shape).clone(),
            ivar=torch.zeros(shape, dtype=self.s0.dtype,
                             device=self.s0.device))

    def step(self, state: HestonExposureState, eps, t) -> HestonExposureState:
        dtype = state.log_s.dtype
        z1, z2 = eps[0], eps[1]
        rho = self.rho.to(dtype)
        z_v = rho * z1 + torch.sqrt(1.0 - torch.square(rho)) * z2
        dt = self.dt.to(dtype)
        v_plus = torch.clamp(state.v, min=0.0)
        positive = v_plus > 0
        v_safe = torch.where(positive, v_plus, 1.0)
        sq_vdt = torch.where(positive, torch.sqrt(v_safe * dt), 0.0)
        log_s = state.log_s + ((self.mu.to(dtype) - 0.5 * v_plus) * dt
                               + sq_vdt * z1)
        v = (state.v
             + self.kappa.to(dtype) * (self.theta.to(dtype) - v_plus) * dt
             + self.xi.to(dtype) * sq_vdt * z_v)
        # The left-point accrual: the v+ dt the log-price drift consumed.
        return HestonExposureState(log_s=log_s, v=v,
                                   ivar=state.ivar + v_plus * dt)

    def prices(self, state: HestonExposureState):
        return exp32(state.log_s)

    def log_prices(self, state: HestonExposureState):
        return state.log_s

    # --- exposure protocol -----------------------------------------------
    def exposure_obs(self, state: HestonExposureState):
        """(n_paths, 3): (S, v, accrued variance)."""
        return torch.stack([exp32(state.log_s), state.v, state.ivar],
                           dim=-1)

    def wwr_state(self, obs):
        """The variance: the wrong-way intensity's state."""
        return obs[..., 1, :]

    def im_norm(self, dvs, obs, mpor):
        """Delta-normal IM std over the margin period: the equity shock
        ``S sqrt(v+) sqrt(mpor)``, the variance shock ``xi sqrt(v+)
        sqrt(mpor)``, folded with rho; the accrued variance carries
        none."""
        dtype = dvs.dtype
        as_ = lambda v: torch.as_tensor(v, dtype=dtype, device=dvs.device)
        v_plus = torch.clamp(obs[..., 1, :], min=0.0)
        sq_vm = torch.sqrt(v_plus * as_(mpor))
        a = dvs[..., 0, :] * obs[..., 0, :] * sq_vm
        b = dvs[..., 1, :] * as_(self.xi) * sq_vm
        rho = as_(self.rho)
        # v+ = 0 zeroes the form exactly: a finite gradient there.
        return grad_safe_sqrt(a * a + b * b + 2.0 * rho * a * b)


def heston_forward_value_fn(model: HestonExposure, strike: float,
                            maturity: float, dtype=None):
    """An equity forward on the (3, N) state columns: ``S - K e^{-r (T -
    t)}`` at the model's flat rate."""
    dtype = model.xi.dtype if dtype is None else dtype
    as_ = lambda v: torch.as_tensor(v, dtype=dtype, device=model.xi.device)
    r, k, t_mat = as_(model.mu), as_(strike), as_(maturity)

    def value(cols, t):
        tau = torch.clamp(t_mat - as_(t), min=0.0)
        return cols[0] - k * torch.exp(-r * tau)

    return value


def heston_varswap_expected_total(model: HestonExposure,
                                  maturity: float) -> float:
    """E[int_0^T v du] off the initial state (the par variance strike
    times T; host float64, the exact CIR expectation)."""
    v0, th = float(model.v0), float(model.theta)
    kap, t = float(model.kappa), float(maturity)
    return (v0 - th) * (1.0 - np.exp(-kap * t)) / kap + th * t


def heston_varswap_value_fn(model: HestonExposure, strike_var: float,
                            maturity: float, *, notional: float = 1.0,
                            dtype=None):
    """A variance swap paying ``N (RV_{0,T} - K)`` at T on the (3, N)
    state columns, marked by the affine closed form in (v, ivar); zero
    after T.  ``strike_var`` in variance units."""
    dtype = model.xi.dtype if dtype is None else dtype
    as_ = lambda v: torch.as_tensor(v, dtype=dtype, device=model.xi.device)
    r, kap, th = as_(model.mu), as_(model.kappa), as_(model.theta)
    k, n, t_mat = as_(strike_var), as_(notional), as_(maturity)

    def value(cols, t):
        tau = torch.clamp(t_mat - as_(t), min=0.0)
        alive = tau > 1e-9
        # E[int_t^T v du | v_t], the affine CIR conditional expectation.
        rem = (cols[1] - th) * (1.0 - torch.exp(-kap * tau)) / kap \
            + th * tau
        total = (cols[2] + rem) / t_mat
        return torch.where(alive, n * torch.exp(-r * tau) * (total - k),
                           torch.zeros_like(cols[2]))

    return value


__all__ = ["HestonExposure", "HestonExposureState",
           "heston_forward_value_fn", "heston_varswap_expected_total",
           "heston_varswap_value_fn"]
