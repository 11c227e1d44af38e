"""Shared cases of tests/test_torch_jumps.py and
tests/test_torch_qe_vg_sabr.py: the eight jump, Levy, QE and SABR
processes built once by the JAX package and carried to the port with
``convert.process_from_numpy``, and the checks that hold the port's paths,
draws and CLI output against JAX's (``hold_cli`` and ``hold_kernel_paths``
also serve tests/test_torch_local_vol.py and tests/test_torch_slv.py, with
their own tolerances).

Tolerances, and why:

- Threefry words and uniforms (and their mirror 1 - u) are integer or
  exact float32 work: bitwise.  Normals differ by each platform's log,
  sin and cos inside Box-Muller: within NORMAL_ATOL = 4.8e-7.
- XLA:CPU may contract a step's a*b + c into an FMA where the port rounds
  twice, and ndtri32 (HestonQE, BatesQE, VG) calls each platform's log:
  terminal prices within PATH_RTOL = 1e-5 per path.  Three steps turn a
  float into a discrete choice (the Poisson count, NIG's root, VG's knot
  index), where a last-ULP difference can move one path by a whole jump:
  at most FLIP_SHARE = 1e-3 of the paths may differ by more than
  PATH_RTOL, and the mean price stays within PRICE_RTOL = 1e-5.
- Inside the port (K2-K4's plain versions against the torch loop):
  bitwise.
"""

from __future__ import annotations

import argparse
import json

import jax.numpy as jnp
import numpy as np

from montecarlo_tpu.cli import pricing as jpricing
from montecarlo_tpu.cli.pricing_models import build_process
from montecarlo_tpu.engine import functionals as jf
from montecarlo_tpu.engine import simulate as jsimulate
from montecarlo_tpu.ops.fused_engine import fused_terminal_pallas
from montecarlo_tpu.stats.welford import moments_from_array
from montecarlo_tpu_torch.convert import process_from_numpy
from montecarlo_tpu_torch.engine import (ARITH_MEAN, GEO_MEAN, RUNNING_MAX,
                                         VanillaPayoff)
from montecarlo_tpu_torch.ops import (fused_block_moments, fused_functionals,
                                      fused_terminal)

NORMAL_ATOL = 4.8e-7
PATH_RTOL = 1e-5
PRICE_RTOL = 1e-5
FLIP_SHARE = 1e-3
#: The paths and steps of the JAX tests' kernel parity runs.
N_PATHS, N_STEPS = 16384, 17



def pair(kind: str, n_steps: int = N_STEPS):
    """The process the JAX CLI builds for ``price --process kind --steps
    n_steps`` (its defaults) and the port's (on the CPU) from the same
    leaves."""
    parser = argparse.ArgumentParser()
    jpricing.add_parsers(parser.add_subparsers())
    args = parser.parse_args(["price", "--process", kind, "--steps",
                              str(n_steps)])
    jp = build_process(args, args.maturity / n_steps)
    fields = {k: np.asarray(v) for k, v in jp._asdict().items()}
    return jp, process_from_numpy(kind, fields, device="cpu")


def hold_paths(got, want, msg=""):
    """Per-path prices within PATH_RTOL except at most FLIP_SHARE of the
    paths; the mean within PRICE_RTOL."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, msg
    assert np.isfinite(got).all(), msg
    off = np.abs(got - want) > PATH_RTOL * np.abs(want)
    assert off.mean() <= FLIP_SHARE, (msg, int(off.sum()))
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=PRICE_RTOL,
                               err_msg=msg)


def hold_draws(got, want, kinds):
    """One step's draws: uniforms bitwise, normals within NORMAL_ATOL."""
    assert len(got) == len(want) == len(kinds)
    for g, w, kind in zip(got, want, kinds):
        g, w = g.numpy(), np.asarray(w)
        if kind == "uniform":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=NORMAL_ATOL)


def run_cli(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def hold_cli(got, want, rqmc: bool = False):
    """The port's ``price`` JSON against the JAX CLI's: the same keys and
    path count, the estimate within PRICE_RTOL (std-err too), the CF
    oracle within 1e-10.  ``rqmc``: a Sobol run's std-err is the spread of
    nearly equal replicate means, so it gets an absolute floor of
    PRICE_RTOL times the price (tests/test_torch_qmc.py's rule)."""
    assert sorted(got) == sorted(want)
    assert got["n_paths"] == want["n_paths"]
    floor = PRICE_RTOL * abs(want["price"]) if rqmc else 0.0
    for k in ("price", "std_err"):
        np.testing.assert_allclose(got[k], want[k], rtol=PRICE_RTOL,
                                   atol=floor, err_msg=k)
    if "cf_price" in want:
        np.testing.assert_allclose(got["cf_price"], want["cf_price"],
                                   rtol=1e-10)


def hold_kernel_paths(jp, tp, n_steps: int, rtol: float, seed: int = 5):
    """K2's plain version (the CPU route of ``ops.fused_terminal``) against
    JAX's scan and an interpret-mode ``fused_terminal_pallas`` run at
    4096 paths; K3's block moments against JAX's moments of the same scan
    (each framework sums in its own order: rtol 1e-5); K4's {avg, geo, mx}
    against JAX's functional scan within ``rtol``."""
    n = 4096
    got = fused_terminal(tp, n, n_steps, seed=seed).numpy()
    scan = np.asarray(jsimulate(jp, n, n_steps, seed=seed,
                                dtype=jnp.float32))
    kernel = np.asarray(fused_terminal_pallas(jp, n, n_steps, seed=seed,
                                              block_rows=32, interpret=True))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, scan, rtol=rtol, err_msg="K2 vs scan")
    np.testing.assert_allclose(got, kernel, rtol=rtol,
                               err_msg="K2 vs interpret-mode kernel")
    pay = VanillaPayoff("call", 100.0)
    k3 = fused_block_moments(tp, pay, n, n_steps, seed=seed)
    want = moments_from_array(
        jnp.maximum(jnp.asarray(scan) - 100.0, 0.0).reshape(-1, 4096),
        axis=-1)
    for f in ("mean", "m2"):
        np.testing.assert_allclose(getattr(k3, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-5,
                                   err_msg=f"K3 {f}")
    fns = {"avg": ARITH_MEAN, "geo": GEO_MEAN, "mx": RUNNING_MAX}
    got_f = fused_functionals(tp, n, n_steps, seed=seed, functionals=fns)
    want_f = jf._simulate_functionals(
        jp, n, n_steps, seed, 0, None, jnp.float32, 0,
        (("avg", jf.ARITH_MEAN), ("geo", jf.GEO_MEAN),
         ("mx", jf.RUNNING_MAX)))
    for k in want_f:
        np.testing.assert_allclose(got_f[k].numpy(), np.asarray(want_f[k]),
                                   rtol=rtol, err_msg=f"K4 {k}")
