"""Characteristic-function option pricing (Gil-Pelaez), the oracles of the
jump and Levy processes.

The port of ``montecarlo_tpu/engine/cf_pricing.py``, in complex128 numpy
on the host:

    C = S0 P1 - K e^{-rT} P2
    P2 = 1/2 + 1/pi int Re[e^{-iu ln K} phi(u)       / (iu)          ] du
    P1 = 1/2 + 1/pi int Re[e^{-iu ln K} phi(u - i)   / (iu phi(-i))  ] du

by Gauss-Legendre on [0, u_max] (the JAX package's nodes), for any
log-price CF ``phi``: Merton's, Kou's, NIG's and VG's here, Bates's
(and with no jumps Heston's) in ``processes.bates``.

The same pricer on torch tensors, :func:`cf_call_price_impl`, with torch
forms of the four CFs (``*_log_cf_tensor``), runs in the dtype (complex64
for float32, complex128 for float64) and on the device of its inputs and
keeps their autograd graph (numbers and arrays join the tensors' type,
``engine.payoffs.common_operands``): the calibrators
(``engine.heston_analytic``, ``engine.levy_calibration``) differentiate
through it.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from montecarlo_tpu_torch.engine.payoffs import common_operands


def quad_nodes(n_quad: int, u_max: float):
    """Gauss-Legendre nodes and weights on [0, u_max]."""
    x, w = np.polynomial.legendre.leggauss(n_quad)
    return 0.5 * u_max * (x + 1.0), 0.5 * u_max * w


def cf_call_price(phi, s0, strike, T, r, *, n_quad: int = 256,
                  u_max: float = 200.0) -> float:
    """European call from the risk-neutral CF ``phi`` of ln S_T (a
    function of a complex array)."""
    u, w = quad_nodes(n_quad, u_max)
    lnk = np.log(strike)
    disc = np.exp(-r * T)
    phi_m_i = phi(np.asarray([-1j]))[0]  # = E[S_T]

    def p_term(us, denom):
        vals = np.real(np.exp(-1j * u * lnk) * phi(us) / (1j * u * denom))
        return 0.5 + np.dot(w, vals) / np.pi

    p1 = p_term(u - 1j, phi_m_i)
    p2 = p_term(u + 0j, 1.0)
    return float(s0 * p1 - disc * strike * p2)


def merton_log_cf(s0, r, sigma, lam, jump_mean, jump_std, T):
    """Risk-neutral CF of ln S_T under Merton jump-diffusion."""
    m = np.exp(jump_mean + 0.5 * jump_std**2) - 1.0
    drift = np.log(s0) + (r - lam * m - 0.5 * sigma**2) * T

    def phi(us):
        iu = 1j * us
        jump_cf = np.exp(iu * jump_mean - 0.5 * jump_std**2 * us * us)
        return np.exp(iu * drift - 0.5 * sigma**2 * us * us * T
                      + lam * T * (jump_cf - 1.0))
    return phi


def kou_log_cf(s0, r, sigma, lam, p_up, eta1, eta2, T):
    """Risk-neutral CF of ln S_T under Kou double-exponential jumps."""
    m = p_up * eta1 / (eta1 - 1.0) + (1.0 - p_up) * eta2 / (eta2 + 1.0) - 1.0
    drift = np.log(s0) + (r - lam * m - 0.5 * sigma**2) * T

    def phi(us):
        iu = 1j * us
        jump_cf = (p_up * eta1 / (eta1 - iu)
                   + (1.0 - p_up) * eta2 / (eta2 + iu))
        return np.exp(iu * drift - 0.5 * sigma**2 * us * us * T
                      + lam * T * (jump_cf - 1.0))
    return phi


def nig_log_cf(s0, r, alpha, beta, delta, T):
    """Risk-neutral CF of ln S_T under NIG, with the process's martingale
    correction ``omega = delta (sqrt(alpha^2 - (beta + 1)^2) - gamma)``."""
    gamma = np.sqrt(alpha * alpha - beta * beta)
    omega = delta * (np.sqrt(alpha * alpha - (beta + 1.0) ** 2) - gamma)
    drift = np.log(s0) + (r + omega) * T

    def phi(us):
        iu = 1j * us
        root = np.sqrt(alpha * alpha - (beta + iu) ** 2)
        return np.exp(iu * drift + delta * T * (gamma - root))
    return phi


def vg_log_cf(s0, r, sigma, theta, nu, T):
    """Risk-neutral CF of ln S_T under variance gamma, with the process's
    martingale correction ``omega = log(1 - theta nu - sigma^2 nu/2)/nu``
    (the CF base has a positive real part: the principal log is
    continuous)."""
    omega = np.log(1.0 - theta * nu - 0.5 * sigma * sigma * nu) / nu
    drift = np.log(s0) + (r + omega) * T

    def phi(us):
        iu = 1j * us
        base = 1.0 - iu * theta * nu + 0.5 * sigma * sigma * nu * us * us
        return np.exp(iu * drift - (T / nu) * np.log(base))
    return phi


# --- torch forms: the calibrators' pricer ----------------------------------

_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}


@functools.lru_cache(maxsize=32)
def quad_nodes_tensor(n_quad: int, u_max: float, dtype, device):
    """:func:`quad_nodes` as tensors of ``dtype`` on ``device``, made once
    per (n_quad, u_max, dtype, device): a calibration step reads them
    without a host-to-device copy.  Never edited in place."""
    u, w = quad_nodes(n_quad, u_max)
    return (torch.as_tensor(u, dtype=dtype, device=device),
            torch.as_tensor(w, dtype=dtype, device=device))


def cf_call_price_impl(phi, s0, strike, T, r, *, n_quad: int = 256,
                       u_max: float = 200.0) -> torch.Tensor:
    """The European call from the risk-neutral CF ``phi`` of ln S_T, on
    tensors: ``phi(us)`` takes a complex tensor of nodes shaped ``(n_quad,
    1, ...)`` against the broadcast batch of ``strike`` and ``T`` and
    returns the CF there.  ``C = s0 P1 - e^{-rT} K P2`` with the passed
    spot, as in the JAX package; the integrals are the weighted sums of
    the nodes' values (``tensordot`` over the node axis)."""
    s0, strike, T, r = common_operands(s0, strike, T, r)
    cdt = _COMPLEX[s0.dtype]
    batch = torch.broadcast_shapes(strike.shape, T.shape)
    u, w = quad_nodes_tensor(n_quad, u_max, s0.dtype, s0.device)
    u = u.reshape((n_quad,) + (1,) * len(batch))
    lnk = torch.log(strike)
    disc = torch.exp(-r * T)
    phi_m_i = phi(torch.full((), -1j, dtype=cdt, device=s0.device))

    def p_term(us, denom):
        vals = torch.real(torch.exp(-1j * u * lnk) * phi(us)
                          / (1j * u * denom))
        return 0.5 + torch.tensordot(w, vals, dims=1) / math.pi

    p1 = p_term(u - 1j, phi_m_i)
    p2 = p_term(u.to(cdt), 1.0)
    return s0 * p1 - disc * strike * p2


def merton_log_cf_tensor(s0, r, sigma, lam, jump_mean, jump_std, T):
    """:func:`merton_log_cf` on tensors (any parameter may carry a
    graph; numbers and arrays join the tensors' type)."""
    s0, r, sigma, lam, jump_mean, jump_std, T = common_operands(
        s0, r, sigma, lam, jump_mean, jump_std, T)
    m = torch.exp(jump_mean + 0.5 * jump_std ** 2) - 1.0
    drift = torch.log(s0) + (r - lam * m - 0.5 * sigma ** 2) * T

    def phi(us):
        iu = 1j * us
        jump_cf = torch.exp(iu * jump_mean - 0.5 * jump_std ** 2 * us * us)
        return torch.exp(iu * drift - 0.5 * sigma ** 2 * us * us * T
                         + lam * T * (jump_cf - 1.0))
    return phi


def kou_log_cf_tensor(s0, r, sigma, lam, p_up, eta1, eta2, T):
    """:func:`kou_log_cf` on tensors."""
    s0, r, sigma, lam, p_up, eta1, eta2, T = common_operands(
        s0, r, sigma, lam, p_up, eta1, eta2, T)
    m = p_up * eta1 / (eta1 - 1.0) + (1.0 - p_up) * eta2 / (eta2 + 1.0) \
        - 1.0
    drift = torch.log(s0) + (r - lam * m - 0.5 * sigma ** 2) * T

    def phi(us):
        iu = 1j * us
        jump_cf = (p_up * eta1 / (eta1 - iu)
                   + (1.0 - p_up) * eta2 / (eta2 + iu))
        return torch.exp(iu * drift - 0.5 * sigma ** 2 * us * us * T
                         + lam * T * (jump_cf - 1.0))
    return phi


def nig_log_cf_tensor(s0, r, alpha, beta, delta, T):
    """:func:`nig_log_cf` on tensors, with the process's martingale
    correction."""
    s0, r, alpha, beta, delta, T = common_operands(s0, r, alpha, beta,
                                                  delta, T)
    gamma = torch.sqrt(alpha * alpha - beta * beta)
    omega = delta * (torch.sqrt(alpha * alpha - (beta + 1.0) ** 2) - gamma)
    drift = torch.log(s0) + (r + omega) * T

    def phi(us):
        iu = 1j * us
        root = torch.sqrt(alpha * alpha - (beta + iu) ** 2)
        return torch.exp(iu * drift + delta * T * (gamma - root))
    return phi


def vg_log_cf_tensor(s0, r, sigma, theta, nu, T, *, floor=None):
    """:func:`vg_log_cf` on tensors.  ``floor``: the martingale
    correction's argument ``1 - theta nu - sigma^2 nu / 2`` floored there
    (the VG calibrator's guard, 1e-4), None for the exact CF."""
    s0, r, sigma, theta, nu, T = common_operands(s0, r, sigma, theta, nu, T)
    base_m = 1.0 - theta * nu - 0.5 * sigma * sigma * nu
    if floor is not None:
        base_m = torch.clamp(base_m, min=floor)
    omega = torch.log(base_m) / nu
    drift = torch.log(s0) + (r + omega) * T

    def phi(us):
        iu = 1j * us
        base = 1.0 - iu * theta * nu + 0.5 * sigma * sigma * nu * us * us
        return torch.exp(iu * drift - (T / nu) * torch.log(base))
    return phi
