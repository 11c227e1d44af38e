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

The table's Newton counterpart, ``gamma_from_uniforms32`` over
``gamma_icdf_boost32``, inverts the regularized incomplete gamma directly:
Wilson-Hilferty seeds (the small-u power law below u = 0.02), then 4
damped Newton steps in log probability, the residual from the lower series
(20 terms) below b + 1 and from the Lentz continued fraction of the upper
tail (18 terms) above, with ``gamma1p32``'s minimax Gamma(1 + a).  Float32
torch over ``exp32``/``log32``/``ndtri32``, the JAX package's iteration
counts and order of operations.  No kernel calls it (VG's kernels read the
table).
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

# The Newton inversion's counts (the JAX package's, tuned to the float32
# floor: quantile error <= 1.6e-6 against float64 over u in [1e-6, 1 -
# 6e-8], b in (1, 2]).
N_SERIES = 20   # lower-gamma series terms (x <= b + 1 <= 3)
N_CF = 18       # upper-gamma Lentz iterations (x >= b + 1)
N_NEWTON = 4    # log-Newton quantile steps


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


# --- the Newton inversion ----------------------------------------------------

#: Abramowitz-Stegun 6.1.36, highest power first, then 1.
_GAMMA1P = tuple(_f32(c) for c in (
    0.035868343, -0.193527818, 0.482199394, -0.756704078, 0.918206857,
    -0.897056937, 0.988205891, -0.577191652, 1.0))


def gamma1p32(a) -> torch.Tensor:
    """Gamma(1 + a) for a in [0, 1]: the minimax polynomial of
    Abramowitz-Stegun 6.1.36 (|error| <= 3e-7), float32, by Horner."""
    a = torch.as_tensor(a, dtype=torch.float32)
    p = torch.full_like(a, _GAMMA1P[0])
    for c in _GAMMA1P[1:]:
        p = p * a + c
    return p


def _lower_series(b, x):
    """The lower-incomplete-gamma series sum_{n>=0} x^n / ((b+1)...(b+n)),
    ``N_SERIES`` terms; accurate for x <= b + 1."""
    term = torch.ones_like(x)
    acc = torch.ones_like(x)
    for n in range(1, N_SERIES):
        term = term * x / (b + float(n))
        acc = acc + term
    return acc


def _upper_cf(b, x):
    """The Lentz continued fraction of the upper tail (the Numerical
    Recipes gcf form), ``N_CF`` iterations; accurate for x >= b + 1."""
    tiny = _f32(1e-30)
    bb = x + 1.0 - b
    c = torch.full_like(x, _f32(1e30))
    d = 1.0 / torch.clamp(bb, min=tiny)
    h = d
    for i in range(1, N_CF):
        an = -float(i) * (float(i) - b)
        bb = bb + 2.0
        d = an * d + bb
        d = torch.where(torch.abs(d) < tiny, tiny, d)
        c = bb + an / c
        c = torch.where(torch.abs(c) < tiny, tiny, c)
        d = 1.0 / d
        h = h * d * c
    return h


def gamma_icdf_boost32(b, u) -> torch.Tensor:
    """The quantile x = P^{-1}(b, u) of Gamma(b, 1), shape b in (1, 2],
    float32.  Seeds: Wilson-Hilferty ``b (1 - c + z sqrt(c))^3`` (c =
    1/(9b), z = ndtri32(u), clipped to [1e-8, 40]), the exact small-x
    power law ``(u Gamma(b+1))^(1/b)`` below u = 0.02; then ``N_NEWTON``
    Newton steps in log probability (log P - log u on the series side, log
    Q - log(1 - u) on the continued fraction's), each damped to [-8, x/2]
    and x kept in [1e-12, 44]."""
    u = torch.as_tensor(u, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32, device=u.device)
    g1p = gamma1p32(b - 1.0)                # Gamma(b)
    gb1 = b * g1p                           # Gamma(b + 1)
    inv_gb = 1.0 / g1p
    inv_gb1 = 1.0 / gb1
    z = ndtri32(torch.clamp(u, U_LO, U_HI))
    c = 1.0 / (9.0 * b)
    base = (1.0 - c) + z * torch.sqrt(c)
    wh = b * (base * (base * base))
    x_small = exp32(log32(u * gb1) / b)
    x = torch.where(u < _f32(0.02), x_small,
                    torch.clamp(wh, _f32(1e-8), 40.0))
    log_u = log32(u)
    log_uq = log32(1.0 - u)
    floor = _f32(1e-35)
    for _ in range(N_NEWTON):
        logx = log32(torch.clamp(x, min=_f32(1e-30)))
        pref = expneg_wide32(torch.clamp(b * logx - x, -88.0, 0.0))
        use_series = x < b + 1.0
        # The unselected branch is evaluated too: both stay finite.
        p_low = pref * inv_gb1 * _lower_series(b, torch.minimum(x, b + 1.0))
        q_high = pref * inv_gb * _upper_cf(b, torch.maximum(x, b + 1.0))
        pdf = pref * inv_gb / torch.clamp(x, min=_f32(1e-30))
        pdf_f = torch.clamp(pdf, min=floor)
        step = torch.where(
            use_series,
            (log32(torch.clamp(p_low, min=floor)) - log_u) * p_low / pdf_f,
            -(log32(torch.clamp(q_high, min=floor)) - log_uq) * q_high
            / pdf_f)
        step = torch.minimum(torch.clamp(step, min=-8.0), x * 0.5)
        x = torch.clamp(x - step, _f32(1e-12), 44.0)
    return x


def gamma_from_uniforms32(a, u_w, u_boost) -> torch.Tensor:
    """One Gamma(a, 1) variate per element from two uniforms, a in (0, 1]:
    ``W U^(1/a)`` with W = Gamma(1 + a) by ``gamma_icdf_boost32`` of
    ``u_w`` (the boost identity), 0 where the boost factor underflows
    float32 (quantiles <= ~1e-38)."""
    a = torch.as_tensor(a, dtype=torch.float32)
    w = gamma_icdf_boost32(a + 1.0, u_w)
    return w * expneg_wide32(log32(torch.as_tensor(
        u_boost, dtype=torch.float32)) / a)
