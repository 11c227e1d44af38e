"""Shared cases of tests/test_torch_rates.py and tests/test_torch_term_gbm.py:
Euler GBM, term-structure GBM, Vasicek, CIR, Hull-White and G2++ built
once by the JAX package (float32, pinned: conftest.py turns x64 on) and
carried to the port with ``convert.process_from_numpy``, and the checks
that hold the port's paths against JAX's scan and K2-K4's plain versions
against the port's own torch loop.

Tolerances, and why:

- The normals differ by each platform's log, sin and cos inside
  Box-Muller (within NORMAL_ATOL = 4.8e-7), and XLA:CPU may contract a
  step's a*b + c into an FMA where the port rounds twice (an ULP of the
  state a step).  The GBMs' prices move with their level: within
  GBM_RTOL = 2e-6 per path (measured 7.2e-7 at 2048 x 32).  Rates cross
  zero under Vasicek and Hull-White, so they are held absolutely, a step
  adding at most NORMAL_ATOL times the step's noise scale (sigma sqrt(dt),
  which bounds the OU scale) and two ULPs of a rate below 1/16 (2^-27):
  ``rate_atol`` (measured 2.2e-8 at 2048 x 32 against 2.7e-7 allowed).
- Inside the port (K2-K4's plain versions against the torch loop):
  bitwise, under every draw source the kernels take for the process
  (Threefry plain and antithetic, Sobol, and the bridge for one draw).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

from montecarlo_tpu.engine import simulate as jsimulate
from montecarlo_tpu.processes import CIR as JCIR
from montecarlo_tpu.processes import EulerGBM as JEuler
from montecarlo_tpu.processes import HullWhite as JHullWhite
from montecarlo_tpu.processes import TermStructureGBM as JTerm
from montecarlo_tpu.processes import Vasicek as JVasicek
from montecarlo_tpu.processes.g2pp import G2PP as JG2PP
from montecarlo_tpu_torch.convert import process_from_numpy
from montecarlo_tpu_torch.engine import (ARITH_MEAN, VanillaPayoff,
                                         kernel_route, simulate,
                                         simulate_functionals,
                                         trapezoid_integral)
from montecarlo_tpu_torch.ops import (fused_block_moments_reference,
                                      fused_functionals_reference,
                                      fused_terminal_reference)
from montecarlo_tpu_torch.ops.fused_engine import _merge_rows, _row_moments
from montecarlo_tpu_torch.rng.sobol import (SobolBridgeKernelSampler,
                                            SobolDeviceSampler)
from montecarlo_tpu_torch.samplers import AntitheticSampler

NORMAL_ATOL = 4.8e-7
GBM_RTOL = 2e-6
#: Paths of the parity runs; ids from OFFSET cross 2^30.
N_PATHS, OFFSET = 2048, (1 << 30) - 1000

#: The bond CLI's parameters (r0, kappa, theta, sigma) and G2++'s (b, eta,
#: rho); the price CLI's GBM (s0, mu, sigma).
R0, KAPPA, THETA, SIGMA = 0.03, 0.8, 0.05, 0.015
G2_B, G2_ETA, G2_RHO = 0.1, 0.01, -0.7
S0, MU, VOL = 100.0, 0.03, 0.2
#: Each kind's convert.PROCESSES name.
KINDS = ("euler-gbm", "term-gbm", "vasicek", "cir", "hull-white", "g2pp")
RATES = ("vasicek", "cir", "hull-white", "g2pp")


def jax_process(kind: str, n_steps: int, T: float = 2.0):
    """The JAX package's ``kind`` over ``n_steps`` steps to T, float32:
    the bond CLI's (Hull-White on its sloped synthetic forward curve)
    and, for the GBMs, the price CLI's GBM (term-structure GBM on curves
    from a seeded numpy generator)."""
    dt = T / n_steps
    f32 = jnp.float32
    if kind == "euler-gbm":
        return JEuler.create(S0, MU, VOL, dt, dtype=f32)
    if kind == "term-gbm":
        rng = np.random.default_rng(n_steps)
        return JTerm.from_curves(S0, rng.uniform(0.0, 0.05, n_steps),
                                 rng.uniform(0.1, 0.3, n_steps), dt,
                                 dtype=f32)
    if kind == "vasicek":
        return JVasicek.create(R0, KAPPA, THETA, SIGMA, dt, dtype=f32)
    if kind == "cir":
        return JCIR.create(R0, KAPPA, THETA, SIGMA, dt, dtype=f32)
    if kind == "hull-white":
        fwd = R0 + 0.005 * np.arange(n_steps + 1) * dt
        return JHullWhite.from_forward_curve(fwd, a=KAPPA, sigma=SIGMA,
                                             dt=dt, dtype=f32)
    if kind == "g2pp":
        return JG2PP.create(R0, KAPPA, SIGMA, G2_B, G2_ETA, G2_RHO, dt,
                            dtype=f32)
    raise KeyError(kind)


def pair(kind: str, n_steps: int, T: float = 2.0):
    """JAX's process and the port's (on the CPU) from the same leaves."""
    jp = jax_process(kind, n_steps, T)
    fields = {k: np.asarray(v) for k, v in jp._asdict().items()}
    return jp, process_from_numpy(kind, fields, device="cpu")


def rate_atol(jp, n_steps: int) -> float:
    """The absolute tolerance of a rate path after ``n_steps`` steps."""
    sigma = max(float(getattr(jp, k, 0.0)) for k in ("sigma", "eta"))
    return n_steps * (NORMAL_ATOL * sigma * float(np.sqrt(jp.dt))
                      + 2.0 ** -27)


def hold_scan(kind: str, n_steps: int, seed: int = 3):
    """The port's torch loop against JAX's scan, terminal values."""
    jp, tp = pair(kind, n_steps)
    got = simulate(tp, N_PATHS, n_steps, seed=seed,
                   path_offset=OFFSET).numpy()
    want = np.asarray(jsimulate(jp, N_PATHS, n_steps, seed=seed,
                                path_offset=OFFSET, dtype=jnp.float32))
    assert np.isfinite(got).all()
    if kind in RATES:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=rate_atol(jp, n_steps))
    else:
        np.testing.assert_allclose(got, want, rtol=GBM_RTOL)
    return got, want


def samplers(tp, n_steps: int) -> dict:
    """The draw sources K2-K4 take for ``tp``: the torch loop's sampler
    and the wrappers' keywords."""
    out = {"plain": (None, {}),
           "antithetic": (AntitheticSampler(), {"antithetic": True})}
    sobol = SobolDeviceSampler.create(n_steps, tp.n_draws, scramble_seed=7,
                                      device="cpu")
    out["sobol"] = (sobol, {"sampler": sobol})
    if tp.n_draws == 1:
        bridge = SobolBridgeKernelSampler.create(n_steps, scramble_seed=7,
                                                 device="cpu")
        out["bridge"] = (bridge, {"sampler": bridge})
    return out


def hold_plain_versions(tp, n_steps: int, source: str, seed: int = 11):
    """K2, K3 and K4 ({trap} and {avg}) plain versions under ``source``
    against the port's torch loop, bitwise; every route the gate takes."""
    sampler, kw = samplers(tp, n_steps)[source]
    assert kernel_route(tp, sampler, n_steps)
    kw = dict(seed=seed, path_offset=OFFSET, **kw)
    loop = simulate(tp, N_PATHS, n_steps, seed=seed, path_offset=OFFSET,
                    sampler=sampler)
    k2 = fused_terminal_reference(tp, N_PATHS, n_steps, **kw)
    assert torch.isfinite(k2).all()
    assert torch.equal(k2, loop)
    pay = VanillaPayoff("digital", float(np.median(loop.numpy())))
    k3 = fused_block_moments_reference(tp, pay, 4096, n_steps, **kw)
    loop4096 = simulate(tp, 4096, n_steps, seed=seed, path_offset=OFFSET,
                        sampler=sampler)
    want = _merge_rows(_row_moments(pay(loop4096)))
    for f in ("count", "mean", "m2"):
        assert torch.equal(getattr(k3, f), getattr(want, f)), f
    fns = {"trap": trapezoid_integral(float(tp.dt)), "avg": ARITH_MEAN}
    k4 = fused_functionals_reference(tp, N_PATHS, n_steps, functionals=fns,
                                     **kw)
    loop = simulate_functionals(tp, N_PATHS, n_steps, seed=seed,
                                path_offset=OFFSET, functionals=fns,
                                sampler=sampler, prefer_fused=False)
    assert sorted(k4) == sorted(loop) == ["avg", "terminal", "trap"]
    for k in k4:
        assert torch.equal(k4[k], loop[k]), k
