"""Gamma variates by table inversion, float32 (the variance-gamma
subordinator).

The port of the table path of ``montecarlo_tpu/rng/gamma.py``.  By the
boost identity ``Gamma(a) = Gamma(1 + a) U^(1/a)`` (a in (0, 1]) the hard
inversion happens at shape b = 1 + a, where a create-time float64 table
of the residual log-quantile

    resid(z) = log Q_b(Phi(z)) - log(Phi(z)) / b

on 512 uniform knots of z in [-5.45, 5.45] (``gamma_icdf_resid_table64``,
host numpy, solved by bisection on the regularized incomplete gamma) is
read at ``z = ndtri32(u)`` by cubic Hermite interpolation; the power law
``log(u) / b`` is added back from the sampled uniform.  The small-shape
factor ``U^(1/a)`` is ``expneg_wide32(log32(U) / a)``.  Everything on the
device is float32 mul/add, ``exp32``/``log32`` and ``ndtri32``, in the JAX
package's order; the table is read by plain indexing (the JAX package's
lane gather ``_hermite_rows_gather`` exists for the TPU's vector unit).

The same functions are ``mc::expneg_wide32`` and
``mc::gamma_from_uniforms_table32`` in ``csrc/rng.cuh``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from montecarlo_tpu_torch.rng.normal import _f32, exp32, log32, ndtri32

TABLE_Z_LO = -5.45   # ndtri32(6e-8) ~ -5.38: covers the clipped u range
TABLE_Z_HI = 5.45
TABLE_SIZE = 512
U_LO, U_HI = _f32(6e-8), _f32(1.0 - 6e-8)  # the inversion's clipped range


def _regularized_gamma_f64(b: float, x, n_series: int = 256,
                           n_cf: int = 256):
    """P(b, x) in float64: the lower series below b + 1, the Lentz
    continued fraction of the upper tail above."""
    x = np.asarray(x, np.float64)
    lg = math.lgamma(b)
    out = np.empty_like(x)
    lo = x < b + 1.0
    xs = x[lo]
    term = np.ones_like(xs)
    acc = np.ones_like(xs)
    for n in range(1, n_series):
        term = term * xs / (b + n)
        acc += term
    out[lo] = acc * np.exp(b * np.log(np.maximum(xs, 1e-300)) - xs
                           - lg - np.log(b))
    xc = x[~lo]
    tiny = 1e-300
    bb = xc + 1.0 - b
    c = np.full_like(xc, 1e300)
    d = 1.0 / np.maximum(bb, tiny)
    h = d.copy()
    for i in range(1, n_cf):
        an = -i * (i - b)
        bb = bb + 2.0
        d = an * d + bb
        d = np.where(np.abs(d) < tiny, tiny, d)
        c = bb + an / c
        c = np.where(np.abs(c) < tiny, tiny, c)
        d = 1.0 / d
        h = h * d * c
    out[~lo] = 1.0 - h * np.exp(b * np.log(xc) - xc - lg)
    return out


def gamma_icdf_resid_table64(b: float, n: int = TABLE_SIZE):
    """``(z0, dz, resid, dresid)``: the first knot and the spacing as
    float32 scalars, the residual log-quantile of Gamma(b, 1) and its
    z-derivative on ``n`` knots as float32 arrays; b in (1, 2]."""
    if n % 128 != 0:
        raise ValueError("table size must be a multiple of 128 lanes")
    if not 1.0 < b <= 2.0:
        raise ValueError("table covers shapes b in (1, 2]")
    z = np.linspace(TABLE_Z_LO, TABLE_Z_HI, n)
    erf = np.vectorize(math.erf)
    u = 0.5 * (1.0 + erf(z / math.sqrt(2.0)))
    phi = np.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
    lo = np.full(n, 1e-30)
    hi = np.full(n, 80.0)
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        below = _regularized_gamma_f64(b, mid) < u
        lo = np.where(below, mid, lo)
        hi = np.where(below, hi, mid)
    q = 0.5 * (lo + hi)
    log_q = np.log(q)
    resid = log_q - np.log(u) / b
    pdf = np.exp((b - 1.0) * log_q - q - math.lgamma(b))
    dlogq = phi / (pdf * q)
    dresid = dlogq - phi / (u * b)
    return (np.float32(z[0]), np.float32(z[1] - z[0]),
            resid.astype(np.float32), dresid.astype(np.float32))


def expneg_wide32(x: torch.Tensor) -> torch.Tensor:
    """exp(x) for x in [-88, 0] as ``exp32(x / 8)^8``; inputs clamp to
    that range."""
    x = torch.clamp(x.to(torch.float32), -88.0, 0.0)
    e = exp32(x * 0.125)
    e2 = e * e
    e4 = e2 * e2
    return e4 * e4


def gamma_from_uniforms_table32(a, u_w, u_boost, z0, dz, resid, dresid):
    """One Gamma(a, 1) variate per element from two uniforms, a in (0, 1]:
    the shape-(1 + a) quantile of ``u_w`` from the residual table ``(z0,
    dz, resid, dresid)`` of ``gamma_icdf_resid_table64(1 + a)``, times
    ``u_boost^(1/a)``."""
    u = torch.clamp(u_w.to(torch.float32), U_LO, U_HI)
    z = ndtri32(u)
    n = resid.numel()
    t = (z - z0) / dz
    i = torch.clamp(torch.floor(t).to(torch.int32), 0, n - 2)
    frac = torch.clamp(t - i.to(torch.float32), 0.0, 1.0)
    i = i.to(torch.int64)
    g0, g1, d0, d1 = resid[i], resid[i + 1], dresid[i], dresid[i + 1]
    m0 = d0 * dz
    m1 = d1 * dz
    f2 = frac * frac
    f3 = f2 * frac
    h = (g0 * (2.0 * f3 - 3.0 * f2 + 1.0)
         + m0 * (f3 - 2.0 * f2 + frac)
         + g1 * (-2.0 * f3 + 3.0 * f2)
         + m1 * (f3 - f2))
    b = 1.0 + a
    log_w = torch.clamp(h + log32(u) / b, -20.0, 20.0)
    w = exp32(log_w)
    return w * expneg_wide32(log32(u_boost.to(torch.float32)) / a)
