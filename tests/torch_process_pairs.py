"""Shared cases of tests/test_torch_jumps.py and
tests/test_torch_qe_vg_sabr.py: the eight jump, Levy, QE and SABR
processes built once by the JAX package and carried to the port with
``convert.process_from_numpy``, and the checks that hold the port's paths,
draws and CLI output against JAX's.

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

import numpy as np

from montecarlo_tpu.cli import pricing as jpricing
from montecarlo_tpu.cli.pricing_models import build_process
from montecarlo_tpu_torch.convert import process_from_numpy

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


def hold_cli(got, want):
    """The port's ``price`` JSON against the JAX CLI's: the same keys and
    path count, the estimate within PRICE_RTOL (std-err too), the CF
    oracle within 1e-10."""
    assert sorted(got) == sorted(want)
    assert got["n_paths"] == want["n_paths"]
    for k in ("price", "std_err"):
        np.testing.assert_allclose(got[k], want[k], rtol=PRICE_RTOL,
                                   err_msg=k)
    if "cf_price" in want:
        np.testing.assert_allclose(got["cf_price"], want["cf_price"],
                                   rtol=1e-10)
