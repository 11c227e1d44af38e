"""Shared cases of tests/test_torch_term_basket.py and
tests/test_torch_mgarch.py: the multi-asset state processes TermBasketGBM,
CCC-GARCH and DCC-GARCH built once by the JAX package (float32, pinned:
conftest.py turns x64 on) and carried to the port with
``convert.process_from_numpy``, and the checks that hold the port's paths
against JAX's scan and K2-K4's plain versions against the port's own torch
loop.

Tolerances, and why:

- Against JAX's scan, per path: rtol SCAN_RTOL = 2e-6.  The normals differ
  by each platform's log, sin and cos inside Box-Muller (within 4.8e-7
  absolute), XLA:CPU may contract an a*b + c into an FMA where the port
  rounds twice, and DCC's row scale is 1 / sqrt(q_ii) in the port where
  JAX takes lax.rsqrt (within a few ULPs of it).  Measured at 8192 paths x
  17 steps: at most 4.7e-7 (A = 3) and 3.5e-7 (A = 5 and 8).
- Inside the port (K2-K4's plain versions against the torch loop):
  bitwise, under every draw source the kernels take (Threefry plain and
  antithetic, Sobol).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

from montecarlo_tpu.engine import simulate as jsimulate
from montecarlo_tpu.processes import CCCGarch as JCCC
from montecarlo_tpu.processes import DCCGarch as JDCC
from montecarlo_tpu.processes import TermBasketGBM as JTermBasket
from montecarlo_tpu_torch.convert import process_from_numpy
from montecarlo_tpu_torch.engine import (ARITH_MEAN, RUNNING_MIN,
                                         VanillaPayoff, kernel_route,
                                         simulate, simulate_functionals)
from montecarlo_tpu_torch.ops import (fused_block_moments_reference,
                                      fused_functionals_reference,
                                      fused_terminal_reference)
from montecarlo_tpu_torch.ops.fused_engine import _merge_rows, _row_moments
from montecarlo_tpu_torch.rng.sobol import SobolDeviceSampler
from montecarlo_tpu_torch.samplers import AntitheticSampler

SCAN_RTOL = 2e-6
#: Paths of the scan parity runs; ids from OFFSET cross 2^30.
N_SCAN, N_PATHS, OFFSET = 8192, 2048, (1 << 30) - 1000
#: The JAX tests' 3-asset book (tests/test_ccc_garch.py,
#: tests/test_dcc_garch.py): correlation, spots, variances, weights.
CORR3 = np.array([[1.0, 0.5, 0.2], [0.5, 1.0, 0.4], [0.2, 0.4, 1.0]])
S0_3, VAR0_3, W_3 = [100.0, 50.0, 75.0], [2e-4, 4e-4, 3e-4], [0.5, 0.3, 0.2]


def book(a_n: int):
    """(corr, s0, var0, weights) of an A-asset book: the JAX tests' at A =
    3; otherwise a seeded correlation (half a sample correlation, half the
    identity), spots in [50, 150], daily variances in [1e-4, 4e-4] and
    equal weights."""
    if a_n == 3:
        return CORR3, S0_3, VAR0_3, W_3
    rng = np.random.default_rng(a_n)
    c = np.corrcoef(rng.normal(size=(a_n, 4 * a_n)))
    corr = 0.5 * c + 0.5 * np.eye(a_n)
    return (corr, rng.uniform(50.0, 150.0, a_n),
            rng.uniform(1e-4, 4e-4, a_n), np.full(a_n, 1.0 / a_n))


def jax_process(kind: str, a_n: int, n_steps: int = 17):
    """The JAX package's ``kind`` ("term-basket", "ccc-garch" or
    "dcc-garch") on the A-asset book, float32: GARCH(1,1) at (1e-5, 0.1,
    0.85) for every asset, DCC at (a, b) = (0.05, 0.9), the term basket on
    seeded curves of ``n_steps`` entries at dt = 1/64."""
    corr, s0, var0, w = book(a_n)
    f32 = jnp.float32
    g = dict(omega=[1e-5] * a_n, alpha=[0.1] * a_n, beta=[0.85] * a_n)
    if kind == "ccc-garch":
        return JCCC.create(s0=s0, var0=var0, corr=corr, weights=w,
                           dtype=f32, **g)
    if kind == "dcc-garch":
        return JDCC.create(s0=s0, var0=var0, qbar=corr, weights=w,
                           a_dcc=0.05, b_dcc=0.9, dtype=f32, **g)
    if kind == "term-basket":
        rng = np.random.default_rng(100 + n_steps)
        return JTermBasket.create(s0, rng.uniform(0.0, 0.05, (a_n, n_steps)),
                                  rng.uniform(0.1, 0.3, (a_n, n_steps)),
                                  corr, w, 1 / 64, dtype=f32)
    raise KeyError(kind)


def numpy_fields(jp) -> dict:
    return {k: np.asarray(v) for k, v in jp._asdict().items()}


def pair(kind: str, a_n: int, n_steps: int = 17):
    """JAX's process and the port's (on the CPU) from the same leaves."""
    jp = jax_process(kind, a_n, n_steps)
    return jp, process_from_numpy(kind, numpy_fields(jp), device="cpu")


def hold_scan(kind: str, a_n: int, n_steps: int = 17, seed: int = 3):
    """The port's torch loop against JAX's scan, terminal values."""
    jp, tp = pair(kind, a_n, n_steps)
    got = simulate(tp, N_SCAN, n_steps, seed=seed,
                   path_offset=OFFSET).numpy()
    want = np.asarray(jsimulate(jp, N_SCAN, n_steps, seed=seed,
                                path_offset=OFFSET, dtype=jnp.float32))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=SCAN_RTOL)


def samplers(tp, n_steps: int) -> dict:
    """The draw sources K2-K4 take for ``tp``: the torch loop's sampler
    and the wrappers' keywords."""
    sobol = SobolDeviceSampler.create(n_steps, tp.n_draws, scramble_seed=7,
                                      device="cpu")
    return {"plain": (None, {}),
            "antithetic": (AntitheticSampler(), {"antithetic": True}),
            "sobol": (sobol, {"sampler": sobol})}


def hold_plain_versions(tp, n_steps: int, source: str, seed: int = 11):
    """K2, K3 (a put at the loop's median) and K4 ({avg, mn}) plain
    versions under ``source`` against the port's torch loop, bitwise; the
    gate takes every one of these runs."""
    sampler, kw = samplers(tp, n_steps)[source]
    assert kernel_route(tp, sampler, n_steps)
    kw = dict(seed=seed, path_offset=OFFSET, **kw)
    loop = simulate(tp, N_PATHS, n_steps, seed=seed, path_offset=OFFSET,
                    sampler=sampler)
    k2 = fused_terminal_reference(tp, N_PATHS, n_steps, **kw)
    assert torch.isfinite(k2).all()
    assert torch.equal(k2, loop)
    pay = VanillaPayoff("put", float(np.median(loop.numpy())))
    k3 = fused_block_moments_reference(tp, pay, 4096, n_steps, **kw)
    loop4096 = simulate(tp, 4096, n_steps, seed=seed, path_offset=OFFSET,
                        sampler=sampler)
    want = _merge_rows(_row_moments(pay(loop4096)))
    for f in ("count", "mean", "m2"):
        assert torch.equal(getattr(k3, f), getattr(want, f)), f
    fns = {"avg": ARITH_MEAN, "mn": RUNNING_MIN}
    k4 = fused_functionals_reference(tp, N_PATHS, n_steps, functionals=fns,
                                     **kw)
    loop = simulate_functionals(tp, N_PATHS, n_steps, seed=seed,
                                path_offset=OFFSET, functionals=fns,
                                sampler=sampler, prefer_fused=False)
    assert sorted(k4) == sorted(loop) == ["avg", "mn", "terminal"]
    for k in k4:
        assert torch.equal(k4[k], loop[k]), k
