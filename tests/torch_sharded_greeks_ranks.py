"""Rank side of tests/test_torch_sharded_greeks.py: one gloo rank of a
spawn.

Run as ``python tests/torch_sharded_greeks_ranks.py RANK WORLD INIT_FILE
OUT_DIR`` by each of the WORLD processes the test module starts.  It
imports torch and the port only (neither JAX nor the root conftest),
builds a mesh of each size in ``SIZES`` over consecutive ranks (every
rank sits in one mesh of each size), runs ``sharded_price_and_greeks`` on
each process of ``processes()`` there, and writes its results to
``OUT_DIR/rank<RANK>.pt``.  The test module builds the same processes
from the constants below.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from montecarlo_tpu_torch.parallel import (make_mesh,
                                           sharded_price_and_greeks, subgroup)
from montecarlo_tpu_torch.processes import GBM, GARCHBootstrap, Heston

N_PATHS, N_STEPS, BLOCK = 1 << 14, 16, 1024
S0, STRIKE, DISCOUNT = 100.0, 105.0, 0.97
GBM_ARGS = (S0, 0.03, 0.2, 1 / 252)
HESTON_KW = dict(s0=S0, v0=0.04, mu=0.03, kappa=2.0, theta=0.04, xi=0.5,
                 rho=-0.7, dt=1 / 252)
#: The bootstrap GARCH (a table leaf: one backward pass a block) at fewer
#: paths.
GARCH_PATHS, GARCH_SEED = 1 << 12, 0
SIZES = (1, 2, 4)


def garch_returns():
    return np.random.default_rng(GARCH_SEED).normal(0, 0.02, 300)


def call(s):
    return torch.clamp(s - STRIKE, min=0.0)


def processes() -> dict:
    return {"gbm": GBM.create(*GBM_ARGS, device="cpu"),
            "heston": Heston.create(**HESTON_KW, device="cpu"),
            "garch": GARCHBootstrap.create(garch_returns(), s0=S0,
                                           var0=4e-4, device="cpu")}


def plain(res: dict) -> dict:
    """The result as numpy arrays: price, std_err, n_paths, and per field
    its gradient and error."""
    out = {k: res[k].numpy() for k in ("price", "std_err", "n_paths")}
    for key in ("grads", "grad_std_err"):
        g = res[key]
        out[key] = {f.name: getattr(g, f.name).numpy()
                    for f in dataclasses.fields(g)}
    return out


def estimates(mesh, procs) -> dict:
    out = {}
    for name, proc in procs.items():
        n = GARCH_PATHS if name == "garch" else N_PATHS
        out[name] = plain(sharded_price_and_greeks(
            proc, call, n, N_STEPS, seed=11, mesh=mesh, discount=DISCOUNT,
            block_size=BLOCK))
    return out


def main(rank: int, world: int, init_file: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        procs = processes()
        results = {}
        for size in SIZES:
            first = rank - rank % size
            group = None if size == world else subgroup(
                range(first, first + size))
            mesh = make_mesh(size, group=group, device="cpu")
            results[size] = {"coords": dict(mesh.coords),
                             **estimates(mesh, procs)}
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
