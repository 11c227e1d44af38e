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
"""

from __future__ import annotations

import numpy as np


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
