"""Rank side of tests/test_torch_sharded.py: one gloo rank of a spawn.

Run as ``python tests/torch_sharded_ranks.py RANK WORLD INIT_FILE OUT_DIR``
by each of the WORLD processes the test module starts.  It imports torch
and the port only (neither JAX nor the root conftest), builds every mesh
layout of ``LAYOUTS`` that holds this rank side by side with the meshes
of the other ranks, runs the sharded estimators in each, and writes its
results to ``OUT_DIR/rank<RANK>.pt`` (``torch.save`` of a dict of
tensors, numbers and strings).  The test module builds the same processes
from the constants below, for the JAX side.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from montecarlo_tpu_torch.engine import (ARITH_MEAN, asian_call,
                                         european_call, max_call,
                                         trapezoid_integral)
from montecarlo_tpu_torch.engine.path_sketch import sharded_path_percentiles
from montecarlo_tpu_torch.engine.streaming import streaming_estimate
from montecarlo_tpu_torch.api import portfolio_var
from montecarlo_tpu_torch.engine.american import lsm_policy
from montecarlo_tpu_torch.parallel import (make_mesh,
                                           sharded_andersen_broadie_bound,
                                           sharded_basket_estimate,
                                           sharded_functional_estimate,
                                           sharded_lsm_price,
                                           sharded_mc_estimate,
                                           sharded_rbergomi_estimate,
                                           sharded_terminal,
                                           sharded_terminal_sketch, subgroup)
from montecarlo_tpu_torch.processes import (GBM, BasketGBM, Heston,
                                            MultiGBM, Vasicek)
from montecarlo_tpu_torch.processes.rough_bergomi import RoughBergomi
from montecarlo_tpu_torch.rng.sobol import SobolDeviceSampler

N_PATHS, N_STEPS, BLOCK = 1 << 15, 32, 1024
S0, STRIKE = 100.0, 105.0
GBM_ARGS = (S0, 0.03, 0.2, 1 / 252)
HESTON_KW = dict(s0=S0, v0=0.04, mu=0.03, kappa=2.0, theta=0.04, xi=0.5,
                 rho=-0.7, dt=1 / 252)
MULTI_KW = dict(s0=[100.0, 50.0, 75.0], mu=[0.03, 0.02, 0.04],
                sigma=[0.2, 0.3, 0.25],
                corr=[[1.0, 0.5, 0.2], [0.5, 1.0, 0.4], [0.2, 0.4, 1.0]],
                dt=1 / 252)
SOBOL_SEED = 3
#: The bond CLI's Vasicek (r0, kappa, theta, sigma, dt) over 2 years: its
#: zero-coupon bond by the discount integral (engine/rates.py).
VASICEK_ARGS = (0.03, 0.8, 0.05, 0.015, 2.0 / N_STEPS)
#: Rough Bergomi: tests/test_sharded_rbergomi.py's model and sizes.
RB_ARGS, RB_STEPS, RB_PATHS, RB_BLOCK = ((100.0, 0.235 ** 2, 1.9, -0.9,
                                          0.07), 32, 4096, 512)
#: The sketch and percentile grids.
SK_LO, SK_HI, SK_BINS, PCT_BINS, PCT_STEPS = 40.0, 250.0, 512, 256, 8
#: tests/test_sharding.py's 4-asset basket.
BASKET_KW = dict(s0=[100.0, 50.0, 75.0, 120.0], mu=[0.03] * 4,
                 sigma=[0.2, 0.3, 0.25, 0.15],
                 corr=(np.eye(4) * 0.6 + 0.4).tolist(),
                 weights=[0.25] * 4, dt=1 / 252)
BASKET_PATHS, BASKET_STEPS, BASKET_BLOCK, BASKET_STRIKE = 1 << 13, 16, 512, 85.0
#: The streaming route over a mesh: tests/test_streaming.py's sizes.
ST_STEPS, ST_CHUNK, ST_TOTAL, ST_BLOCK = 16, 4096, 4 * 4096, 1024
ST_LO, ST_HI, ST_BINS = 40.0, 260.0, 512

#: The sharded LSM (its paths, steps and blocks) and the dual (outer
#: paths, inner samples, blocks) on the American put of
#: tests/test_american.py, in float32 and float64 (float64 leaves).
LSM_PATHS, LSM_STEPS, LSM_BLOCK = 8192, 16, 1024
AB_OUTER, AB_INNER, AB_BLOCK, POLICY_PATHS = 1024, 32, 128, 4096
AM_GBM = dict(s0=36.0, mu=0.06, sigma=0.2, dt=1 / LSM_STEPS)
AM_STRIKE = 40.0

#: name -> (n_path_shards, n_asset_shards, n_slices); the mesh's ranks are
#: consecutive, so each rank is in one mesh of every size.
LAYOUTS = {
    "flat1": (1, 1, 1), "flat2": (2, 1, 1), "flat4": (4, 1, 1),
    "flat8": (8, 1, 1), "s2p2": (2, 1, 2), "s2p4": (4, 1, 2),
    "p2a2": (2, 2, 1), "p4a2": (4, 2, 1),
}


def call(s):
    return european_call(s, STRIKE)


def processes():
    cpu = dict(device="cpu")
    return {"gbm": GBM.create(*GBM_ARGS, **cpu),
            "heston": Heston.create(**HESTON_KW, **cpu),
            "multigbm": MultiGBM.create(**MULTI_KW, **cpu)}


def put(s):
    return torch.clamp(AM_STRIKE - s, min=0.0)


def american_gbm(dtype):
    """The American put's GBM on ``dtype`` leaves."""
    return GBM(**{k: torch.tensor(v, dtype=dtype)
                  for k, v in AM_GBM.items()})


def american(mesh) -> dict:
    """The sharded LSM and dual in float32 and float64; the dual's policy
    is the unsharded ``lsm_policy``'s on every rank."""
    out = {}
    for tag, dtype in (("32", torch.float32), ("64", torch.float64)):
        gbm = american_gbm(dtype)
        kw = dict(rate=AM_GBM["mu"], dt=AM_GBM["dt"], degree=3, dtype=dtype)
        out[f"lsm{tag}"] = sharded_lsm_price(
            gbm, put, LSM_PATHS, LSM_STEPS, seed=1, mesh=mesh,
            block_size=LSM_BLOCK, **kw)
        _, policy = lsm_policy(gbm, put, POLICY_PATHS, LSM_STEPS, seed=1,
                               **kw)
        out[f"ab{tag}"] = sharded_andersen_broadie_bound(
            gbm, put, policy, AB_OUTER, AB_INNER, LSM_STEPS, seed=2,
            mesh=mesh, block_size=AB_BLOCK, **kw)
    return out


def path_estimates(mesh, procs) -> dict:
    """Every estimator on a ([slices,] paths) mesh."""
    out = american(mesh)
    for kind, payoff in (("gbm", call), ("heston", call),
                         ("multigbm", lambda s: max_call(s, STRIKE))):
        out[kind] = sharded_mc_estimate(procs[kind], payoff, N_PATHS,
                                        N_STEPS, seed=11, mesh=mesh,
                                        block_size=BLOCK)
    sobol = SobolDeviceSampler.create(N_STEPS, 1, scramble_seed=SOBOL_SEED,
                                      device="cpu")
    out["sobol"] = sharded_mc_estimate(procs["gbm"], call, N_PATHS, N_STEPS,
                                       seed=11, mesh=mesh, sampler=sobol,
                                       block_size=BLOCK)
    out["asian"] = sharded_functional_estimate(
        procs["gbm"], {"avg": ARITH_MEAN},
        lambda o: asian_call(o["avg"], STRIKE), N_PATHS, N_STEPS, seed=11,
        mesh=mesh, block_size=BLOCK)
    dt = VASICEK_ARGS[-1]
    out["vasicek_zcb"] = sharded_functional_estimate(
        Vasicek.create(*VASICEK_ARGS, device="cpu"),
        {"I": trapezoid_integral(dt)}, lambda o: torch.exp(-o["I"]),
        N_PATHS, N_STEPS, seed=13, mesh=mesh, block_size=BLOCK)
    sk, mo = sharded_terminal_sketch(procs["gbm"], N_PATHS, N_STEPS, seed=7,
                                     mesh=mesh, lo=SK_LO, hi=SK_HI,
                                     bins=SK_BINS, block_size=BLOCK)
    out["sketch"] = {**sk._asdict(), **{f"m_{k}": v
                                        for k, v in mo._asdict().items()}}
    out["rbergomi"] = sharded_rbergomi_estimate(
        RoughBergomi.create(*RB_ARGS, n_steps=RB_STEPS, T=1.0,
                            device="cpu"),
        lambda s: torch.clamp(s - 100.0, min=0.0), RB_PATHS, seed=5,
        mesh=mesh, block_size=RB_BLOCK)
    out["percentiles"] = sharded_path_percentiles(
        procs["gbm"], N_PATHS, PCT_STEPS, seed=2, mesh=mesh, lo=60.0,
        hi=140.0, bins=PCT_BINS)
    out["terminal"] = sharded_terminal(procs["gbm"], N_PATHS, N_STEPS,
                                       seed=3, mesh=mesh)
    out["half_b"] = sharded_mc_estimate(procs["gbm"], call, N_PATHS // 2,
                                        N_STEPS, seed=17, mesh=mesh,
                                        block_size=BLOCK,
                                        path_offset=N_PATHS // 2)
    st = streaming_estimate(procs["gbm"], ST_TOTAL, ST_STEPS, seed=5,
                            chunk_paths=ST_CHUNK, block_size=ST_BLOCK,
                            lo=ST_LO, hi=ST_HI, bins=ST_BINS, mesh=mesh)
    out["streaming"] = {"block_mean": st.block_mean, "block_m2": st.block_m2,
                        "counts": st.sketch.counts,
                        "mean": float(st.moments().mean)}
    out["var"] = portfolio_var(procs["gbm"], ST_TOTAL, ST_STEPS, 100.0,
                               seed=5, mesh=mesh, bins=ST_BINS,
                               block_size=ST_BLOCK)
    return out


def asset_estimates(mesh, procs) -> dict:
    """The (paths, assets) mesh: the basket, and GBM over the paths axis."""
    basket = BasketGBM.create(**BASKET_KW, device="cpu")
    return {
        "basket": sharded_basket_estimate(
            basket, lambda v: torch.clamp(v - BASKET_STRIKE, min=0.0),
            BASKET_PATHS, BASKET_STEPS, seed=9, mesh=mesh,
            block_size=BASKET_BLOCK),
        "gbm": sharded_mc_estimate(procs["gbm"], call, N_PATHS, N_STEPS,
                                   seed=11, mesh=mesh, block_size=BLOCK)}


def mesh_errors() -> dict:
    """The message of each refused mesh, as seen by rank 0 of 8."""
    out = {}
    for name, kw in (("slices_range", dict(n_slices=9)),
                     ("slices_assets", dict(n_path_shards=2,
                                            n_asset_shards=2, n_slices=2)),
                     ("assets_range", dict(n_asset_shards=9)),
                     ("uneven", dict(n_asset_shards=3)),
                     ("zero_paths", dict(n_path_shards=0)),
                     ("too_many", dict(n_path_shards=5, n_asset_shards=2))):
        try:
            make_mesh(device="cpu", **kw)
            out[name] = "no error"
        except ValueError as e:
            out[name] = f"ValueError: {e}"
    mesh = make_mesh(n_path_shards=2, n_slices=2, group=subgroup(range(4)),
                     device="cpu")
    try:
        sharded_mc_estimate(processes()["gbm"], call, 24 * BLOCK, N_STEPS,
                            seed=1, mesh=mesh, block_size=BLOCK)
        out["two_level"] = "no error"
    except ValueError as e:
        out["two_level"] = f"ValueError: {e}"
    return out


def plain(x):
    """Tensors to numpy, recursively, for the parent."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    return x


def main(rank: int, world: int, init_file: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        procs = processes()
        results = {}
        for name, (p, a, s) in LAYOUTS.items():
            size = p * a * s
            first = rank - rank % size
            group = None if size == world else subgroup(
                range(first, first + size))
            mesh = make_mesh(p, a, n_slices=s, group=group, device="cpu")
            results[name] = {
                "shape": dict(mesh.shape), "coords": dict(mesh.coords),
                **plain(asset_estimates(mesh, procs) if a > 1
                        else path_estimates(mesh, procs))}
        if rank == 0:
            results["errors"] = mesh_errors()
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
