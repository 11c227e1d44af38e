"""Rank side of tests/test_torch_mlmc.py: one gloo rank of a spawn.

Run as ``python tests/torch_mlmc_ranks.py RANK WORLD INIT_FILE OUT_DIR`` by
each of the WORLD processes the test module starts.  It imports torch and
the port only (neither JAX nor the root conftest), builds a mesh of each
size in ``SIZES`` over consecutive ranks, runs one MLMC level of each case
of ``CASES`` there (``mlmc_level_moments(..., mesh=mesh)``) and an
adaptive ``mlmc_estimate`` over the largest mesh (with its chunks
simulated together, then one chunk a run), and writes its results
to ``OUT_DIR/rank<RANK>.pt``.  The test module builds the same levels from
the constants below.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import torch
import torch.distributed as dist

from montecarlo_tpu_torch.engine import mlmc
from montecarlo_tpu_torch.engine.mlmc import (mlmc_estimate,
                                              mlmc_level_moments)
from montecarlo_tpu_torch.parallel import make_mesh, subgroup
from montecarlo_tpu_torch.processes import EulerGBM, Heston

S0, R, SIGMA, T, STRIKE = 100.0, 0.05, 0.2, 1.0, 100.0
N_PATHS, SEED, N0 = 1 << 14, 31, 4
SIZES = (1, 2, 4)
#: (name, process, level, payoff_on, dtype): level 0 through K2's and
#: K4's plain versions, coupled levels on the torch loop.
CASES = (("euler-l0", "euler", 0, "terminal", torch.float32),
         ("euler-l2", "euler", 2, "terminal", torch.float32),
         ("euler-l2-f64", "euler", 2, "terminal", torch.float64),
         ("heston-l1", "heston", 1, "terminal", torch.float32),
         ("euler-mean-l0", "euler", 0, "mean", torch.float32),
         ("euler-mean-l2", "euler", 2, "mean", torch.float32))


def make(kind: str, dtype=torch.float32):
    """``n_steps -> process`` on the CPU; float64 leaves for float64."""
    def f(n):
        if kind == "euler":
            vals = dict(s0=S0, mu=R, sigma=SIGMA, dt=T / n)
            proc = EulerGBM.create(**vals, device="cpu")
        else:
            vals = dict(s0=S0, v0=0.04, mu=R, kappa=1.5, theta=0.04, xi=0.4,
                        rho=-0.6, dt=T / n)
            proc = Heston.create(**vals, device="cpu")
        if dtype == torch.float64:
            proc = dataclasses.replace(proc, **{
                k: torch.tensor(v, dtype=dtype) for k, v in vals.items()})
        return proc
    return f


def call(s):
    return torch.clamp(s - STRIKE, min=0.0)


def level(name, kind, lvl, payoff_on, dtype, mesh=None):
    """(Y's and P's moment states as (count, mean, m2) tuples)."""
    out = mlmc_level_moments(make(kind, dtype), call, lvl, N_PATHS,
                             seed=SEED, n0_steps=N0, dtype=dtype,
                             payoff_on=payoff_on, mesh=mesh)
    return tuple(tuple(v.clone() for v in st) for st in out)


def estimate(mesh=None, chunk_paths=100_000):
    res = mlmc_estimate(make("euler"), call, target_rmse=0.08, seed=23,
                        n0_steps=N0, chunk_paths=chunk_paths, mesh=mesh)
    return {"price": res["price"], "std_err": res["std_err"],
            "levels": [tuple(l) for l in res["levels"]]}


def main(rank: int, world: int, init_file: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        results = {}
        for size in SIZES:
            first = rank - rank % size
            group = None if size == world else subgroup(
                range(first, first + size))
            mesh = make_mesh(size, group=group, device="cpu")
            results[size] = {case[0]: level(*case, mesh=mesh)
                             for case in CASES}
            if size == world:
                results["estimate"] = estimate(mesh)
                # 16384-path chunks (the 4-rank quantum) simulated
                # together, then one a run, as the JAX package samples.
                results["estimate_16k"] = estimate(mesh, 1 << 14)
                mlmc.RUN_PATHS = 1
                results["estimate_16k_chunk_a_run"] = estimate(mesh, 1 << 14)
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
