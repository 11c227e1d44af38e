"""GARCH(1,1) parameter estimation by Gaussian quasi-MLE.

The port of ``montecarlo_tpu/processes/garch_fit.py``: the quasi-likelihood

    var_t = omega + alpha r_{t-1}^2 + beta var_{t-1}
    -2 logL = sum_t [ log var_t + r_t^2 / var_t ]

maximized with Adam (optax's formula: b1 0.9, b2 0.999, eps 1e-8, bias
corrected) on the same unconstrained parameterization (softplus for
omega, sigmoid for alpha + beta < 1).

JAX runs the recurrence as a 1259-step scan inside one jitted program; an
eager loop would be ~10^6 small launches.  The recurrence is linear in the
variance, so every var_t is a product with powers of beta, which autograd
differentiates exactly.  One n x n product would take 256 MB at n = 8000,
so the series is cut into blocks of B ~ sqrt(n): one (B x B) product gives
every block's forced response from zero, a second one of (n/B x n/B) the
variance entering each block; two float32 products per evaluation, taken
in true float32 (``precision.factor_product``).  The sums run in another
order than the scan, so the fitted parameters agree with JAX's to the
tolerance tests/test_torch_garch.py states, not bitwise.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from montecarlo_tpu_torch.device import resolve_device
from montecarlo_tpu_torch.precision import factor_product


class GARCHParams(NamedTuple):
    omega: float
    alpha: float
    beta: float


def _constrain(raw: torch.Tensor):
    """Unconstrained R^3 -> (omega > 0, alpha > 0, beta > 0, alpha + beta
    < 1): alpha = persistence * share, beta = persistence * (1 - share)."""
    omega = F.softplus(raw[0]) * 1e-5
    persistence = torch.sigmoid(raw[1])
    share = torch.sigmoid(raw[2])
    return omega, persistence * share, persistence * (1.0 - share)


def _powers(beta: torch.Tensor, size: int, scale: int = 1) -> torch.Tensor:
    """(size, size) lower-triangular L[i, j] = beta^(scale (i - 1 - j)) for
    j < i, else 0.  The exponent is clamped at 0 before the power, so no
    masked entry overflows into the gradient."""
    i = torch.arange(size, device=beta.device)
    e = (i[:, None] - 1 - i[None, :]).clamp(min=0).to(beta.dtype)
    return torch.where(i[:, None] > i[None, :], beta ** (scale * e), 0.0)


def _variances(omega, alpha, beta, r: torch.Tensor, var0) -> torch.Tensor:
    """var_t for t < n from var_0 = var0 and var_{t+1} = omega + alpha
    r_t^2 + beta var_t, by blocks of B."""
    n = r.numel()
    b = max(1, math.isqrt(n))
    nb = -(-n // b)
    f = F.pad(omega + alpha * (r * r), (0, nb * b - n)).reshape(nb, b)
    # Within each block from a zero start: z[k, i] = sum_{j<i} beta^(i-1-j)
    # f[k, j]; the block's exit forcing y[k] = sum_j beta^(b-1-j) f[k, j].
    z = factor_product(f, _powers(beta, b).T)
    tail = beta ** torch.arange(b - 1, -1, -1, device=r.device).to(r.dtype)
    y = factor_product(f, tail[:, None])[:, 0]
    # The variance entering block k: v_k = beta^(bk) var0 + sum_{m<k}
    # beta^(b(k-1-m)) y_m.
    k = torch.arange(nb, device=r.device).to(r.dtype)
    v = beta ** (b * k) * var0 + factor_product(_powers(beta, nb, b),
                                                y[:, None])[:, 0]
    i = torch.arange(b, device=r.device).to(r.dtype)
    var = beta ** i[None, :] * v[:, None] + z
    return var.reshape(-1)[:n]


def _neg_log_likelihood(raw, r, var0):
    omega, alpha, beta = _constrain(raw)
    var = _variances(omega, alpha, beta, r, var0)
    return torch.mean(torch.log(var) + (r * r) / var)


def _fit(r: torch.Tensor, var0: torch.Tensor, n_iters: int = 500,
         lr: float = 0.05):
    raw = torch.tensor([1.0, 2.0, 0.0], dtype=torch.float32,
                       device=r.device)  # ~ (1e-5, .44, .44)
    mu = torch.zeros_like(raw)
    nu = torch.zeros_like(raw)
    b1, b2, eps = 0.9, 0.999, 1e-8
    for count in range(1, n_iters + 1):
        raw.requires_grad_(True)
        loss = _neg_log_likelihood(raw, r, var0)
        (g,) = torch.autograd.grad(loss, raw)
        with torch.no_grad():
            mu = b1 * mu + (1.0 - b1) * g
            nu = b2 * nu + (1.0 - b2) * (g * g)
            mu_hat = mu / (1.0 - b1 ** count)
            nu_hat = nu / (1.0 - b2 ** count)
            raw = raw.detach() - lr * mu_hat / (torch.sqrt(nu_hat) + eps)
    return raw


def fit_garch(returns, n_iters: int = 500, device="cuda") -> GARCHParams:
    """Estimate (omega, alpha, beta) from a log-return history, de-meaned,
    from the sample variance as the initial variance (standard QMLE
    practice), on ``device``."""
    dev = resolve_device(device)
    r = np.asarray(returns, np.float64)
    r = r[~np.isnan(r)]
    r = r - r.mean()  # GARCH models the innovation variance
    var0 = torch.tensor(r.var(), dtype=torch.float32, device=dev)
    raw = _fit(torch.as_tensor(r, dtype=torch.float32, device=dev), var0,
               n_iters=n_iters)
    omega, alpha, beta = (float(v) for v in _constrain(raw))
    return GARCHParams(omega=omega, alpha=alpha, beta=beta)
