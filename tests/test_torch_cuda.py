"""The CUDA kernels K0-K7 against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA GPU and
skips without one.  The file imports no JAX (the card's machine has none);
run it there from the repo root with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Kernel and plain version run the same float32 operations in the same order
(nvcc -fmad=false, no fast math; K3 sums rows in tree_sum's order), so they
must agree bitwise; Box-Muller and log32 go through the card's libm on both
sides and are held to 1e-6 absolute in case the two builds differ.  K4
folds the path functionals from their device forms (host-folded float32
parameters); its plain version folds the torch closures over the same
float32 constants, and the torch time loop on the card agrees with both:
bitwise.  K5 and K6 (rough Bergomi) run the same draws and the same
float32 operations as their plain versions: bitwise; the factor product
between them runs in true float32 whatever the process-wide setting.  K7
(the packed basket) and K2-K4 on the correlated basket (BasketProc, 16 and
128 asset capacities) run their plain versions' counters and float32
operations: bitwise.  So do K2-K4 on the bootstrap GARCH (GarchProc: a
uniform per step, a table read, an IEEE sqrt, the mirror 1 - u), and the
per-process mirror leaves every other process's antithetic draws the
negation they were.  Under Sobol and bridge-Sobol draws (the randomized
Sobol normal of K0: integer words, the Owen hash, ndtri32 with the same
logf and sqrtf on both sides) K2-K4 equal their plain versions and the
torch loop bitwise too, odd step counts on exact-size tables, ids across
2^30, the bridge's normals held per tree level (T up to 1024, whose dims
span several chunks of Owen keys).  K4's folds fixed at compile time (the
sets of csrc/functionals.cuh's FixedFolds) equal the generic fold's plain
version bitwise under every draw source, each launch counted as fixed.  The jump, Levy, QE
and SABR functors (Merton, Kou, Bates, NIG, HestonQE, BatesQE, VG, SABR:
their draws_pair layouts, second key streams, per-draw mirror, Poisson
select chains, the inverse normal, the QE step in its selected and
warp-uniform forms and VG's interleaved gamma table) equal their plain
versions and the torch loop bitwise on K2-K4, SABR under Sobol draws too;
the device build of the gamma-table inversion equals its plain version,
and the QE and VG functors' one-rational inverse normal equals ndtri32 on
every float32 of its range.  So
do the local-vol surfaces (LocalVolProc on the CEV and a time-dependent
surface, SlvProc's exact rows read through a pointer and an offset, its
clamp past the last row, SLVKnots on SlvProc) under every draw source each
takes; the row builder of the surfaces on time knots equals blend_rows
bitwise and runs once per (process, n_steps); SABR's Box-Muller pairs
from one sincosf equal its plain version's sin and cos; two calibrations
at one seed give the same leverage bits.  Euler GBM, term-structure GBM,
Vasicek, CIR, Hull-White and G2++ (RateProc over csrc/rate_steps.cuh, in
csrc/fused_rates.cu) equal their plain versions and the torch loop bitwise
on K2-K4 under every draw source each takes; a run longer than a curve is
refused before any launch; ``bond`` on the card gives the CPU route's
JSON within rtol 1e-5 and atol 1e-7 (the CPU's libm and sqrt are not
the card's).  TermBasketGBM, CCC-GARCH and DCC-GARCH (StateProc over
csrc/mgarch_steps.cuh, at every asset count 1..8 of their functors) equal
their plain versions and the torch loop bitwise on K2-K4 under Threefry
and Sobol draws, at odd and even step counts; CCC's and DCC's kernels
take their constants by value and, at an even A, draw a step at a time,
the same normals as the pair's; nine assets take the torch loop, and the
bridge and a run past the term basket's curves are refused, before any
launch.  Every ``calibrate`` demo recovers its parameters on the card (the
seven in processes of their own, at once) to the JAX tests' tolerances,
and every tensor a card fit saves for its backward pass lies on the card;
MLMC's level 0 through K2 or K4 ({avg}) is the bits of its torch loop; the
gamma Newton sampler on the card is within 64 ULPs of the CPU's.
American and Bermudan exercise (LSM, the Andersen-Broadie dual,
policy-frozen greeks, the Vasicek Bermudan swaption) run the torch loop
and launch no kernel; ``price --american --american-bound`` brackets the
binomial put; in float64 the LSM, the dual and the Bermudan on the card
are within rtol 1e-9 of the CPU's (the platforms' float64 log, sin and
cos, sums in each device's order); the dual's per-path maxima over four
emulated ranks' ids are the unsharded run's bits.  The LIBOR market
model, the equity-Vasicek hybrid and Heston exposure run the torch loop
(no kernel): the LMM's one-call draws are the per-draw stream's bits on
the card; their paths on the card are within rtol 1e-5 of the CPU's in
float32 (the card's log, sin, cos and sqrt are not the CPU's; the LMM's
two products through cuBLAS in true float32, the CPU's BLAS in its own
order), states that cross or touch 0 (the hybrid's short rate and
integral, Heston's variance) held absolutely within 1e-6 (the LMM's
within 1e-7), and 1e-12 in float64 (1e-9 for the LMM's products).  A float32 stress grid on GBM or
Heston runs K2, one launch a scenario, bitwise its torch loop; the
``stress`` command launches K2 34 times at ``--grid 5``.
"""

import math

import numpy as np
import pytest
import torch

from montecarlo_tpu_torch.bench import bench_basket
from montecarlo_tpu_torch.data import generate_ohlcv
from montecarlo_tpu_torch.engine import (ARITH_MEAN, GEO_MEAN, RUNNING_MAX,
                                         RUNNING_MIN, VanillaPayoff,
                                         autocallable, barrier_survival_up,
                                         cliquet_sum, realized_variance,
                                         simulate, simulate_functionals,
                                         trapezoid_integral,
                                         worst_of_autocallable)
from montecarlo_tpu_torch.ops import (PATH_KERNELS, fused_block_moments,
                                      fused_block_moments_reference,
                                      fused_functionals,
                                      fused_functionals_reference,
                                      fused_terminal, fused_terminal_reference,
                                      gbm_terminal, gbm_terminal_reference,
                                      normal_matrix, normal_matrix_reference,
                                      packed_basket_terminal,
                                      packed_basket_terminal_reference,
                                      rbergomi_terminal,
                                      rbergomi_terminal_reference)
from montecarlo_tpu_torch.ops.rbergomi_kernel import (
    boxmuller_angles, boxmuller_angles_reference)
from montecarlo_tpu_torch.processes import (GBM, GARCHBootstrap, Heston,
                                            RoughBergomi, rbergomi_simulate)
from montecarlo_tpu_torch.precision import factor_product
from montecarlo_tpu_torch.samplers import AntitheticSampler


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_paths", [1000, 4096 * 3])
@pytest.mark.parametrize("n_steps", [1, 17, 252])
def test_cuda_k1_k2_bitwise_equal_plain(cuda, n_paths, n_steps):
    tp = GBM.create(100.0, 0.03, 0.2, 1 / 252, device=cuda)
    kw = dict(seed=7, path_offset=2**32 - 500)
    k1 = PATH_KERNELS["gbm_terminal"].launches
    assert torch.equal(gbm_terminal(tp, n_paths, n_steps, **kw),
                       gbm_terminal_reference(tp, n_paths, n_steps, **kw))
    assert PATH_KERNELS["gbm_terminal"].launches == k1 + 1
    for anti in (False, True):
        assert torch.equal(
            fused_terminal(tp, n_paths, n_steps, antithetic=anti, **kw),
            fused_terminal_reference(tp, n_paths, n_steps, antithetic=anti,
                                     **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["call", "put", "digital"])
@pytest.mark.parametrize("antithetic", [False, True])
def test_cuda_k3_bitwise_equal_plain(cuda, kind, antithetic):
    tp = GBM.create(100.0, 0.03, 0.2, 1 / 17, device=cuda)
    pay = VanillaPayoff(kind, 100.0)
    k3 = PATH_KERNELS["fused_block_moments"].launches
    got = fused_block_moments(tp, pay, 3 * 4096, 17, seed=1,
                              path_offset=999, antithetic=antithetic)
    assert PATH_KERNELS["fused_block_moments"].launches == k3 + 1
    want = fused_block_moments_reference(tp, pay, 3 * 4096, 17, seed=1,
                                         path_offset=999,
                                         antithetic=antithetic)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_cuda_k0_device_math_equals_plain(cuda):
    from montecarlo_tpu_torch.ops.rng_check import (rng_check,
                                                    rng_check_reference)

    r = np.random.default_rng(0)
    n = 1 << 16
    c0 = torch.from_numpy(r.integers(0, 2**32, n)).to(cuda)
    c1 = torch.from_numpy(r.integers(0, 2**32, n)).to(cuda)
    xe = torch.from_numpy(r.uniform(-25, 25, n).astype(np.float32)).to(cuda)
    xl = torch.from_numpy(np.exp(r.uniform(-19, 19, n)).astype(
        np.float32)).to(cuda)
    got = rng_check(123, 456, c0, c1, xe, xl)
    want = rng_check_reference(123, 456, c0, c1, xe, xl)
    for name in ("bits0", "bits1", "u0", "u1", "exp32"):
        assert torch.equal(got[name], want[name]), name
    for name in ("z0", "z1", "log32"):
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=1e-6)


def _process(kind, n_steps, device):
    if kind == "heston":
        return Heston.create(100.0, 0.04, 0.03, 2.0, 0.04, 0.5, -0.7,
                             1 / n_steps, device=device)
    return GBM.create(100.0, 0.03, 0.2, 1 / n_steps, device=device)


def _functionals(group, n_steps):
    """Every device functional, in K4's groups of at most four."""
    dt = 1 / n_steps
    period = n_steps // 4 if n_steps % 4 == 0 else n_steps
    return [
        {"avg": ARITH_MEAN, "geo": GEO_MEAN, "mx": RUNNING_MAX,
         "mn": RUNNING_MIN},
        {"surv": barrier_survival_up(104.0, 0.2, dt),
         "cl": cliquet_sum(4, -0.02, 0.03), "rv": realized_variance(),
         "tr": trapezoid_integral(dt)},
        {"ac": autocallable(period, 100.5, 0.02, 0.03 * dt, 97.0, 100.0),
         "avg": ARITH_MEAN},
    ][group]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gbm", "heston"])
@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("n_steps", [17, 252])
@pytest.mark.parametrize("group", [0, 1, 2])
def test_cuda_k4_bitwise_equal_plain(cuda, kind, antithetic, n_steps, group):
    tp = _process(kind, n_steps, cuda)
    fns = _functionals(group, n_steps)
    kw = dict(seed=3, path_offset=2**32 - 500, functionals=fns)
    k4 = PATH_KERNELS["fused_functionals"].launches
    got = fused_functionals(tp, 1000, n_steps, antithetic=antithetic, **kw)
    assert PATH_KERNELS["fused_functionals"].launches == k4 + 1
    want = fused_functionals_reference(tp, 1000, n_steps,
                                       antithetic=antithetic, **kw)
    scan = simulate_functionals(
        tp, 1000, n_steps, prefer_fused=False,
        sampler=AntitheticSampler() if antithetic else None, **kw)
    assert set(got) == set(want) == {"terminal", *fns}
    for k in want:
        assert torch.isfinite(got[k]).all(), k
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(scan[k], want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("n_paths", [1000, 4096 * 3])
def test_cuda_k2_k3_heston_bitwise_equal_plain(cuda, antithetic, n_paths):
    tp = _process("heston", 17, cuda)
    kw = dict(seed=9, path_offset=77, antithetic=antithetic)
    assert torch.equal(fused_terminal(tp, n_paths, 17, **kw),
                       fused_terminal_reference(tp, n_paths, 17, **kw))
    if n_paths % 4096 == 0:
        pay = VanillaPayoff("call", 100.0)
        got = fused_block_moments(tp, pay, n_paths, 17, **kw)
        want = fused_block_moments_reference(tp, pay, n_paths, 17, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def _fixed_sets(n_steps):
    """The functional sets K4 runs with a fixed fold (FixedFolds)."""
    dt = 1 / n_steps
    return {
        "avg": {"avg": ARITH_MEAN},
        "avg_mx_mn": {"avg": ARITH_MEAN, "mx": RUNNING_MAX,
                      "mn": RUNNING_MIN},
        "surv": {"surv": barrier_survival_up(104.0, 0.2, dt)},
        "autocall": {"ac": autocallable(3, 100.5, 0.02, 0.03 * dt, 97.0,
                                        100.0)},
        "cliquet": {"cl": cliquet_sum(3, -0.02, 0.03)},
    }


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["plain", "antithetic", "sobol",
                                    "bridge"])
@pytest.mark.parametrize("n_steps", [18, 63])
@pytest.mark.parametrize("fold", ["avg", "avg_mx_mn", "surv", "autocall",
                                  "cliquet"])
def test_cuda_k4_fixed_fold_bitwise_equal_plain(cuda, source, n_steps, fold):
    """GBM's K4 with each fixed fold, under each draw source, against the
    plain version (the torch closures) bitwise; the launch is counted as
    a fixed fold's."""
    from montecarlo_tpu_torch.rng.sobol import (SobolBridgeKernelSampler,
                                                SobolDeviceSampler)

    tp = _process("gbm", n_steps, cuda)
    fns = _fixed_sets(n_steps)[fold]
    kw = dict(seed=3, path_offset=2**32 - 500, functionals=fns)
    suffix = ""
    if source == "antithetic":
        kw["antithetic"] = True
    elif source == "sobol":
        kw["sampler"] = SobolDeviceSampler.create(n_steps, 1, device=cuda)
        suffix = "_sobol"
    elif source == "bridge":
        kw["sampler"] = SobolBridgeKernelSampler.create(n_steps, device=cuda)
        suffix = "_bridge"
    fixed = PATH_KERNELS["fused_functionals_fixed" + suffix].launches
    got = fused_functionals(tp, 1000, n_steps, **kw)
    assert PATH_KERNELS["fused_functionals_fixed" + suffix].launches == (
        fixed + 1)
    want = fused_functionals_reference(tp, 1000, n_steps, **kw)
    for k in want:
        assert torch.isfinite(got[k]).all(), k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
def test_cuda_k4_generic_fold_outside_fixed_sets(cuda):
    """A set outside FixedFolds ({avg, geo}; {mx, avg}, the app's set in
    another order) and a fixed set on a functor it is not built for
    (local vol) run the generic fold: counted as K4 launches only."""
    from montecarlo_tpu_torch.cli.pricing import cli_process

    tp = _process("gbm", 17, cuda)
    cev = cli_process(["--process", "cev", "--steps", "17"], cuda)[0]
    runs = [(tp, {"avg": ARITH_MEAN, "geo": GEO_MEAN}),
            (tp, {"mx": RUNNING_MAX, "avg": ARITH_MEAN}),
            (cev, {"avg": ARITH_MEAN})]
    for proc, fns in runs:
        k4 = PATH_KERNELS["fused_functionals"].launches
        fixed = PATH_KERNELS["fused_functionals_fixed"].launches
        got = fused_functionals(proc, 1000, 17, seed=2, functionals=fns)
        want = fused_functionals_reference(proc, 1000, 17, seed=2,
                                           functionals=fns)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        assert PATH_KERNELS["fused_functionals"].launches == k4 + 1
        assert PATH_KERNELS["fused_functionals_fixed"].launches == fixed


@pytest.mark.cuda
@pytest.mark.parametrize("n_steps", [256, 300, 1024])
def test_cuda_bridge_levels_past_one_key_chunk(cuda, n_steps):
    """The bridge at T past 256, where its dims in tree order span several
    chunks of Owen keys (all staged once per block): K2 and K4 {avg}
    bitwise equal to their plain versions."""
    from montecarlo_tpu_torch.rng.sobol import SobolBridgeKernelSampler

    tp = _process("gbm", n_steps, cuda)
    smp = SobolBridgeKernelSampler.create(n_steps, device=cuda)
    kw = dict(seed=4, path_offset=2**32 - 40, sampler=smp)
    assert torch.equal(fused_terminal(tp, 300, n_steps, **kw),
                       fused_terminal_reference(tp, 300, n_steps, **kw))
    fns = {"avg": ARITH_MEAN}
    got = fused_functionals(tp, 300, n_steps, functionals=fns, **kw)
    want = fused_functionals_reference(tp, 300, n_steps, functionals=fns,
                                       **kw)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
def test_cuda_k4_raises_instead_of_falling_back(cuda):
    tp = _process("gbm", 16, cuda)
    k4 = PATH_KERNELS["fused_functionals"].launches
    worst = worst_of_autocallable(4, 1.0, 0.02, 0.001, 0.7, [100.0])
    with pytest.raises(TypeError, match="'worst'"):
        simulate_functionals(tp, 256, 16, seed=0,
                             functionals={"worst": worst})
    with pytest.raises(TypeError, match="GBM and Heston"):
        fused_functionals(object(), 256, 16, seed=0,
                          functionals={"avg": ARITH_MEAN})
    assert PATH_KERNELS["fused_functionals"].launches == k4


WRAP = 2**32 - 500


def _rbergomi(n_steps, device):
    return RoughBergomi.create(100.0, 0.04, 1.5, -0.7, 0.1, n_steps, 0.5,
                               device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("n_paths", [1000, 4096 * 3])
@pytest.mark.parametrize("n_cols", [1, 37, 64])
def test_cuda_k5_bitwise_equal_plain(cuda, n_paths, n_cols):
    k5 = PATH_KERNELS["normal_matrix"].launches
    got = normal_matrix(7, 2, n_paths, n_cols, path_offset=WRAP, device=cuda)
    assert PATH_KERNELS["normal_matrix"].launches == k5 + 1
    want = normal_matrix_reference(7, 2, n_paths, n_cols, path_offset=WRAP,
                                   device=cuda)
    assert got.shape == (n_cols, n_paths)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n_paths", [1000, 1001, 4096 * 3, 4097])
@pytest.mark.parametrize("n_steps", [1, 2, 16, 17, 252, 300])
def test_cuda_k6_bitwise_equal_plain(cuda, n_paths, n_steps):
    """Both forms: the ring for n_paths % 4 == 0 (T not a multiple of its
    stage, an odd T's last half pair), the plain loads otherwise."""
    model = _rbergomi(n_steps, cuda)
    z = normal_matrix(5, 1, n_paths, 2 * n_steps, path_offset=WRAP,
                      device=cuda)
    args = (factor_product(model.chol, z), model.tpow(),
            model.kernel_params(), 5, 1)
    kw = dict(n_steps=n_steps, path_offset=WRAP)
    form = ("rbergomi_terminal" if n_paths % 4 == 0
            else "rbergomi_terminal_unaligned")
    before = {k: PATH_KERNELS[k].launches
              for k in ("rbergomi_terminal", "rbergomi_terminal_unaligned")}
    got = rbergomi_terminal(*args, **kw)
    for k, n in before.items():
        assert PATH_KERNELS[k].launches == n + (k == form), k
    want = rbergomi_terminal_reference(*args, **kw)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_k6_boxmuller_angles_bitwise_equal_plain(cuda):
    """The one sincosf of K6 and SabrProc (rng.cuh's
    boxmuller_angle_sincos) gives torch.sin's and torch.cos's bits on
    every one of the 2^23 angles Box-Muller takes from a word."""
    got = boxmuller_angles(cuda)
    want = boxmuller_angles_reference(cuda)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_k6_misaligned_matrix_takes_the_plain_loads(cuda):
    """A contiguous matrix that starts 4 bytes past 16 (n_paths % 4 == 0):
    its rows are not on 16 bytes, so the plain-load form runs, bitwise."""
    n_steps, n_paths = 17, 4096
    model = _rbergomi(n_steps, cuda)
    z = normal_matrix(5, 1, n_paths, 2 * n_steps, device=cuda)
    flat = torch.empty(2 * n_steps * n_paths + 1, device=cuda)
    joint = flat[1:].view(2 * n_steps, n_paths)
    joint.copy_(factor_product(model.chol, z))
    assert joint.data_ptr() % 16 == 4
    args = (joint, model.tpow(), model.kernel_params(), 5, 1)
    ring = PATH_KERNELS["rbergomi_terminal"].launches
    plain = PATH_KERNELS["rbergomi_terminal_unaligned"].launches
    got = rbergomi_terminal(*args, n_steps=n_steps)
    assert PATH_KERNELS["rbergomi_terminal"].launches == ring
    assert PATH_KERNELS["rbergomi_terminal_unaligned"].launches == plain + 1
    assert torch.equal(got, rbergomi_terminal_reference(*args,
                                                        n_steps=n_steps))


@pytest.mark.cuda
def test_cuda_rbergomi_simulate_guards_the_product_precision(cuda):
    """Under a process-wide TF32 setting the sampler still runs its factor
    product in true float32, launches K5 and K6 once each and leaves the
    setting as it found it.  True float32 stays within the dot-product
    bound gamma_2T = 2T*u/(1 - 2T*u), u = 2^-24, of |chol| @ |z| against a
    float64 product, in any summation order; TF32 rounds each operand to
    11 significant bits and misses it on the first row alone, a single
    product."""
    n_steps, n = 17, 1000
    model = _rbergomi(n_steps, cuda)
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        k5 = PATH_KERNELS["normal_matrix"].launches
        k6 = PATH_KERNELS["rbergomi_terminal"].launches
        s_t = rbergomi_simulate(model, n, seed=3, path_offset=WRAP)
        assert PATH_KERNELS["normal_matrix"].launches == k5 + 1
        assert PATH_KERNELS["rbergomi_terminal"].launches == k6 + 1
        assert torch.get_float32_matmul_precision() == "high"
        z = normal_matrix_reference(3, 0, n, 2 * n_steps, path_offset=WRAP,
                                    device=cuda)
        joint = factor_product(model.chol, z)
        assert torch.get_float32_matmul_precision() == "high"
        torch.set_float32_matmul_precision("highest")
        assert torch.equal(joint, torch.matmul(model.chol, z))
        chol, z64 = model.chol.double(), z.double()
        nu = 2 * n_steps * 2.0**-24
        bound = (chol.abs() @ z64.abs()) * (nu / (1 - nu))
        assert ((joint.double() - chol @ z64).abs() <= bound).all()
        assert torch.equal(s_t, rbergomi_terminal_reference(
            joint, model.tpow(), model.kernel_params(), 3, 0,
            n_steps=n_steps, path_offset=WRAP))
        v, s_paths = rbergomi_simulate(model, n, seed=3, mode="paths")
        assert v.shape == (n, n_steps) and s_paths.shape == (n,)
        assert torch.isfinite(v).all() and torch.isfinite(s_paths).all()
    finally:
        torch.set_float32_matmul_precision(before)


@pytest.mark.cuda
@pytest.mark.parametrize("a_n", [1, 2, 5, 16, 17, 20, 33, 64, 65, 127, 128])
@pytest.mark.parametrize("n_steps", [0, 7, 8])
def test_cuda_k7_bitwise_equal_plain(cuda, a_n, n_steps):
    basket = bench_basket(a_n, device=cuda)
    kw = dict(seed=3, path_offset=WRAP)
    k7 = PATH_KERNELS["packed_basket_terminal"].launches
    got = packed_basket_terminal(basket, 1000, n_steps, **kw)
    assert PATH_KERNELS["packed_basket_terminal"].launches == k7 + 1
    want = packed_basket_terminal_reference(basket, 1000, n_steps, **kw)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("a_n", [1, 2, 3, 4, 5, 8, 9, 16, 17])
@pytest.mark.parametrize("antithetic", [False, True])
def test_cuda_basket_k2_k3_k4_bitwise_equal_plain(cuda, a_n, antithetic):
    """BasketFixed<A> (one instantiation per A up to 16: the smallest, odd
    and even counts, the edges 8, 9 and 16) and BasketProc<128> (17 on),
    against the plain versions and the torch loop."""
    basket = bench_basket(a_n, device=cuda)
    kw = dict(seed=4, path_offset=WRAP, antithetic=antithetic)
    before = dict((k, PATH_KERNELS[k].launches) for k in (
        "fused_terminal", "fused_block_moments", "fused_functionals"))
    assert torch.equal(fused_terminal(basket, 1000, 17, **kw),
                       fused_terminal_reference(basket, 1000, 17, **kw))
    pay = VanillaPayoff("call", 95.0)
    got = fused_block_moments(basket, pay, 4096, 17, **kw)
    want = fused_block_moments_reference(basket, pay, 4096, 17, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    fns = {"avg": ARITH_MEAN, "mx": RUNNING_MAX, "mn": RUNNING_MIN}
    got = fused_functionals(basket, 1000, 17, functionals=fns, **kw)
    want = fused_functionals_reference(basket, 1000, 17, functionals=fns,
                                       **kw)
    loop = simulate_functionals(
        basket, 1000, 17, prefer_fused=False, seed=4, path_offset=WRAP,
        sampler=AntitheticSampler() if antithetic else None, functionals=fns)
    for k in want:
        assert torch.isfinite(got[k]).all(), k
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(loop[k], want[k]), k
    for k, n in before.items():
        assert PATH_KERNELS[k].launches == n + 1, k


def _garch(n_returns, device, seed=21):
    """A bootstrap GARCH on a synthetic history of ``n_returns`` log
    returns, var0 from its last 20 (rvol_20 ** 2 / 252, ddof 1)."""
    close = generate_ohlcv(n_days=n_returns + 1, seed=seed)["Close"]
    r = np.diff(np.log(close))
    return GARCHBootstrap.create(r, s0=close[-1],
                                 var0=np.var(r[-20:], ddof=1),
                                 device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("n_returns", [503, 1259])
@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("n_steps", [1, 16, 17])
def test_cuda_garch_k2_k3_k4_bitwise_equal_plain(cuda, n_returns, antithetic,
                                                 n_steps):
    """GarchProc in K2, K3 and K4 against the plain versions and the torch
    loop, a ragged path count, ids wrapping past 2^32."""
    tp = _garch(n_returns, cuda)
    kw = dict(seed=6, path_offset=WRAP, antithetic=antithetic)
    sampler = AntitheticSampler() if antithetic else None
    before = dict((k, PATH_KERNELS[k].launches) for k in (
        "fused_terminal", "fused_block_moments", "fused_functionals"))
    got = fused_terminal(tp, 1000, n_steps, **kw)
    assert torch.isfinite(got).all()
    assert torch.equal(got, fused_terminal_reference(tp, 1000, n_steps, **kw))
    assert torch.equal(got, simulate(tp, 1000, n_steps, seed=6,
                                     path_offset=WRAP, sampler=sampler))
    pay = VanillaPayoff("put", float(tp.s0))
    got = fused_block_moments(tp, pay, 4096, n_steps, **kw)
    want = fused_block_moments_reference(tp, pay, 4096, n_steps, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    fns = {"avg": ARITH_MEAN, "mx": RUNNING_MAX, "mn": RUNNING_MIN}
    got = fused_functionals(tp, 1000, n_steps, functionals=fns, **kw)
    want = fused_functionals_reference(tp, 1000, n_steps, functionals=fns,
                                       **kw)
    loop = simulate_functionals(tp, 1000, n_steps, prefer_fused=False,
                                seed=6, path_offset=WRAP, sampler=sampler,
                                functionals=fns)
    for k in want:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(loop[k], want[k]), k
    for k, n in before.items():
        assert PATH_KERNELS[k].launches == n + 1, k


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gbm", "basket"])
def test_cuda_mirror_is_still_the_negation(cuda, kind):
    """K2's antithetic run against two plain K2 runs: path 2k is the plain
    run's path k and path 2k+1 the plain run of the process with every
    sigma negated, since a negated draw and a negated scale round alike
    (the drift takes sigma^2).  The per-process mirror left GBM's and the
    basket's draws as they were; Heston's is held to its plain version in
    test_cuda_k2_k3_heston_bitwise_equal_plain."""
    if kind == "gbm":
        proc = GBM.create(100.0, 0.03, 0.2, 1 / 17, device=cuda)
        flip = GBM.create(100.0, 0.03, -0.2, 1 / 17, device=cuda)
    else:
        proc = bench_basket(5, device=cuda)
        flip = type(proc)(**{**proc.__dict__, "sigma": -proc.sigma})
    n, steps = 2 * 1000, 17
    anti = fused_terminal(proc, n, steps, seed=2, antithetic=True)
    assert torch.equal(anti[0::2], fused_terminal(proc, n // 2, steps,
                                                  seed=2))
    assert torch.equal(anti[1::2], fused_terminal(flip, n // 2, steps,
                                                  seed=2))


@pytest.mark.cuda
def test_cuda_garch_mirror_is_one_minus_u(cuda):
    """GARCH's odd antithetic path reads the table at the mirrored
    uniform: with a one-step run its log-return is table[idx(1 - u)] *
    sqrt(var0), never an index below the table."""
    tp = _garch(503, cuda)
    n = 2 * 4096
    anti = fused_terminal(tp, n, 1, seed=3, antithetic=True)
    want = fused_terminal_reference(tp, n, 1, seed=3, antithetic=True)
    assert torch.equal(anti, want)
    assert torch.isfinite(anti).all()
    even, odd = anti[0::2].double(), anti[1::2].double()
    s0 = float(tp.s0)
    # Sorted table: the mirror pairs low shocks with high ones.
    corr = torch.corrcoef(torch.stack([even.log() - math.log(s0),
                                       odd.log() - math.log(s0)]))[0, 1]
    assert corr < -0.5


# --- randomized QMC: Sobol and bridge-Sobol draws in K2-K4 -------------------

def _sobol_process(kind, n_steps, device):
    if kind.startswith("basket"):  # basket<A>
        return bench_basket(int(kind[6:]), device=device)
    return _process(kind, n_steps, device)


@pytest.mark.cuda
def test_cuda_k0_sobol_normal_equals_plain(cuda):
    """The Sobol integer, the Owen key, the scrambled uniform, the Sobol
    normal and ndtri32 of the device build against the plain versions:
    bitwise (the same logf and sqrtf on both sides), ids near 2^30 and
    2^32 included."""
    from montecarlo_tpu_torch.ops.rng_check import (sobol_check,
                                                    sobol_check_reference)
    from montecarlo_tpu_torch.rng.sobol import SobolDeviceSampler

    r = np.random.default_rng(1)
    n = 1 << 16
    sv = SobolDeviceSampler.create(64, 2, device=cuda).sv
    ids = torch.from_numpy(np.concatenate([
        r.integers(0, 2**32, n - 2048), 2**30 - 1024 + np.arange(1024),
        2**32 - 1024 + np.arange(1024)])).to(cuda)
    dims = torch.from_numpy(r.integers(0, 128, n)).to(cuda)
    u = torch.from_numpy(np.concatenate([
        r.uniform(0, 1, n - 64), 2.0 ** -np.arange(1, 33),
        1 - 2.0 ** -np.arange(1, 25), [0.5] * 8]).astype(np.float32)).to(cuda)
    got = sobol_check(0x9E3779B9, 77, sv, ids, dims, u)
    want = sobol_check_reference(0x9E3779B9, 77, sv, ids, dims, u)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    assert torch.isfinite(got["normal"]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gbm", "heston", "basket5", "basket16"])
@pytest.mark.parametrize("n_steps", [8, 9, 17])
def test_cuda_sobol_k2_k3_k4_bitwise_equal_plain(cuda, kind, n_steps):
    """SobolDraws in K2, K3 and K4 on a table built for exactly n_steps
    (odd counts included: the dropped step is never drawn), against the
    plain versions and the torch loop, a ragged path count, ids wrapping
    past 2^32; each launch raises its Sobol counter."""
    from montecarlo_tpu_torch.rng.sobol import SobolDeviceSampler

    tp = _sobol_process(kind, n_steps, cuda)
    smp = SobolDeviceSampler.create(n_steps, tp.n_draws, scramble_seed=3,
                                    device=cuda)
    kw = dict(seed=6, path_offset=WRAP, sampler=smp)
    names = ("fused_terminal_sobol", "fused_block_moments_sobol",
             "fused_functionals_sobol")
    before = {k: PATH_KERNELS[k].launches for k in names}
    got = fused_terminal(tp, 1000, n_steps, **kw)
    assert torch.isfinite(got).all()
    assert torch.equal(got, fused_terminal_reference(tp, 1000, n_steps, **kw))
    assert torch.equal(got, simulate(tp, 1000, n_steps, seed=6,
                                     path_offset=WRAP, sampler=smp))
    pay = VanillaPayoff("call", 95.0)
    got = fused_block_moments(tp, pay, 4096, n_steps, **kw)
    want = fused_block_moments_reference(tp, pay, 4096, n_steps, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    fns = {"avg": ARITH_MEAN, "mx": RUNNING_MAX, "mn": RUNNING_MIN}
    got = fused_functionals(tp, 1000, n_steps, functionals=fns, **kw)
    want = fused_functionals_reference(tp, 1000, n_steps, functionals=fns,
                                       **kw)
    loop = simulate_functionals(tp, 1000, n_steps, prefer_fused=False,
                                seed=6, path_offset=WRAP, sampler=smp,
                                functionals=fns)
    for k in want:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(loop[k], want[k]), k
    for k, n in before.items():
        assert PATH_KERNELS[k].launches == n + 1, k


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gbm", "basket1"])
@pytest.mark.parametrize("n_steps,built_for", [(8, 8), (9, 9), (17, 17),
                                               (9, 12)])
def test_cuda_bridge_k2_k3_k4_bitwise_equal_plain(cuda, n_steps, built_for,
                                                 kind):
    """BridgeDraws in K2, K3 and K4 on a plan built for the run's steps or
    more, against
    the plain versions and the torch loop (the Device sampler's per-step
    sums); each launch raises its bridge counter."""
    from montecarlo_tpu_torch.rng.sobol import SobolBridgeKernelSampler

    tp = _sobol_process(kind, n_steps, cuda)
    smp = SobolBridgeKernelSampler.create(built_for, scramble_seed=2,
                                          device=cuda)
    kw = dict(seed=5, path_offset=2**30 - 300, sampler=smp)
    names = ("fused_terminal_bridge", "fused_block_moments_bridge",
             "fused_functionals_bridge")
    before = {k: PATH_KERNELS[k].launches for k in names}
    got = fused_terminal(tp, 1000, n_steps, **kw)
    assert torch.isfinite(got).all()
    assert torch.equal(got, fused_terminal_reference(tp, 1000, n_steps, **kw))
    assert torch.equal(got, simulate(tp, 1000, n_steps, seed=5,
                                     path_offset=2**30 - 300, sampler=smp))
    pay = VanillaPayoff("put", 100.0)
    got = fused_block_moments(tp, pay, 4096, n_steps, **kw)
    want = fused_block_moments_reference(tp, pay, 4096, n_steps, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    fns = {"avg": ARITH_MEAN, "mx": RUNNING_MAX}
    got = fused_functionals(tp, 1000, n_steps, functionals=fns, **kw)
    want = fused_functionals_reference(tp, 1000, n_steps, functionals=fns,
                                       **kw)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for k, n in before.items():
        assert PATH_KERNELS[k].launches == n + 1, k


@pytest.mark.cuda
def test_cuda_dispatch_gate_routes(cuda):
    """The gate on the card: a Sobol table that covers the run launches
    K2's Sobol variant; a short table, a host Sobol table and MultiGBM take
    the torch loop and launch nothing."""
    from montecarlo_tpu_torch.engine import terminal_prices
    from montecarlo_tpu_torch.processes import MultiGBM
    from montecarlo_tpu_torch.rng.sobol import SobolDeviceSampler
    from montecarlo_tpu_torch.samplers import SobolSampler

    tp = _process("gbm", 16, cuda)
    k2s = PATH_KERNELS["fused_terminal_sobol"].launches
    smp = SobolDeviceSampler.create(16, 1, device=cuda)
    assert torch.equal(terminal_prices(tp, 512, 16, seed=1, sampler=smp),
                       simulate(tp, 512, 16, seed=1, sampler=smp))
    assert PATH_KERNELS["fused_terminal_sobol"].launches == k2s + 1
    counts = {k: v.launches for k, v in PATH_KERNELS.items()}
    with pytest.raises(ValueError, match="Sobol table"):
        terminal_prices(tp, 512, 17, seed=1, sampler=smp)
    host = SobolSampler.for_process(tp, 512, 16, seed=3)
    assert torch.isfinite(terminal_prices(tp, 512, 16, seed=1,
                                          sampler=host)).all()
    multi = MultiGBM.create([100.0, 90.0], [0.03, 0.03], [0.2, 0.3],
                            np.array([[1.0, 0.3], [0.3, 1.0]]), 1 / 16,
                            device=cuda)
    assert terminal_prices(multi, 512, 16, seed=1).shape == (512, 2)
    assert {k: v.launches for k, v in PATH_KERNELS.items()} == counts


@pytest.mark.cuda
def test_cuda_bridge_workspace_launches_in_chunks(cuda):
    """The bridge has no workspace: the wrappers launch once for any path
    count (each launch counted), and the launch equals one plain run: K2
    and K4 on a ragged count, K3 on whole rows."""
    from montecarlo_tpu_torch.rng.sobol import SobolBridgeKernelSampler

    tp = _process("gbm", 17, cuda)
    smp = SobolBridgeKernelSampler.create(17, device=cuda)
    kw = dict(seed=3, path_offset=WRAP, sampler=smp)
    k2 = PATH_KERNELS["fused_terminal_bridge"].launches
    got = fused_terminal(tp, 3000, 17, **kw)
    assert PATH_KERNELS["fused_terminal_bridge"].launches == k2 + 1
    assert torch.equal(got, fused_terminal_reference(tp, 3000, 17, **kw))
    pay = VanillaPayoff("call", 100.0)
    got = fused_block_moments(tp, pay, 8192, 17, **kw)
    want = fused_block_moments_reference(tp, pay, 8192, 17, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    fns = {"avg": ARITH_MEAN, "mx": RUNNING_MAX}
    got = fused_functionals(tp, 3000, 17, functionals=fns, **kw)
    want = fused_functionals_reference(tp, 3000, 17, functionals=fns, **kw)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# --- the jump, Levy, QE and SABR processes on K2-K4 ---------------------------

NEW_KINDS = ["merton", "kou", "bates", "nig", "heston-qe", "bates-qe", "vg",
             "sabr"]


def _cli_proc(kind, n_steps, device):
    from montecarlo_tpu_torch.cli.pricing import cli_process

    return cli_process(["--process", kind, "--steps", str(n_steps)],
                       device)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("n_steps", [17, 252])
@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("kind", NEW_KINDS)
def test_cuda_new_process_k2_k3_k4_bitwise_equal_plain(cuda, kind,
                                                       antithetic, n_steps):
    """Each new functor (its draws_pair layout, second key streams and
    per-draw mirror) against its plain version and the torch loop on the
    card: K2 and K4 on a ragged count, K3 on whole rows, ids wrapping past
    2^32."""
    tp = _cli_proc(kind, n_steps, cuda)
    kw = dict(seed=3, path_offset=WRAP, antithetic=antithetic)
    n = 4096 * 3
    got = fused_terminal(tp, n - 37, n_steps, **kw)
    want = fused_terminal_reference(tp, n - 37, n_steps, **kw)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)
    loop = simulate(tp, n - 37, n_steps, seed=3, path_offset=WRAP,
                    sampler=AntitheticSampler() if antithetic else None)
    assert torch.equal(got, loop)
    pay = VanillaPayoff("call", 100.0)
    got = fused_block_moments(tp, pay, n, n_steps, **kw)
    want = fused_block_moments_reference(tp, pay, n, n_steps, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    fns = {"avg": ARITH_MEAN, "geo": GEO_MEAN, "mx": RUNNING_MAX,
           "mn": RUNNING_MIN}
    got = fused_functionals(tp, n - 37, n_steps, functionals=fns, **kw)
    want = fused_functionals_reference(tp, n - 37, n_steps, functionals=fns,
                                       **kw)
    for k in want:
        assert torch.equal(got[k], want[k]), k


#: QE parameter sets beside the CLI's (where 66% of warp-steps are all
#: quadratic, the rest mixed): Feller's condition holds (every step
#: quadratic), and a vol of vol of 3 (at 17 steps the exponential branch
#: below v ~ 1, so from v0 all exponential, later mixed).
QE_MIXES = {"feller": ["--kappa", "2", "--theta", "0.04", "--xi", "0.3"],
            "exponential": ["--xi", "3"]}


@pytest.mark.cuda
@pytest.mark.parametrize("mix", sorted(QE_MIXES))
@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("kind", ["heston-qe", "bates-qe"])
def test_cuda_qe_branch_mixes_bitwise_equal_plain(cuda, kind, antithetic,
                                                  mix):
    """The QE step's warp-uniform branches (HestonQE: only the taken
    branch where a warp's lanes agree) and its selected form (BatesQE) at
    parameters whose warps are all quadratic, all exponential or mixed:
    K2, K3 and K4 bitwise their plain versions."""
    from montecarlo_tpu_torch.cli.pricing import cli_process

    tp = cli_process(["--process", kind, "--steps", "17", *QE_MIXES[mix]],
                     cuda)[0]
    kw = dict(seed=5, path_offset=WRAP, antithetic=antithetic)
    n = 4096 * 3
    assert torch.equal(fused_terminal(tp, n - 37, 17, **kw),
                       fused_terminal_reference(tp, n - 37, 17, **kw))
    pay = VanillaPayoff("call", 100.0)
    got = fused_block_moments(tp, pay, n, 17, **kw)
    want = fused_block_moments_reference(tp, pay, n, 17, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    fns = {"avg": ARITH_MEAN, "mx": RUNNING_MAX}
    got = fused_functionals(tp, n - 37, 17, functionals=fns, **kw)
    want = fused_functionals_reference(tp, n - 37, 17, functionals=fns,
                                       **kw)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("n_steps", [9, 17])
def test_cuda_sabr_under_sobol_draws_bitwise_equal_plain(cuda, n_steps):
    from montecarlo_tpu_torch.rng.sobol import SobolDeviceSampler

    tp = _cli_proc("sabr", n_steps, cuda)
    smp = SobolDeviceSampler.create(n_steps, 2, scramble_seed=4, device=cuda)
    kw = dict(seed=3, path_offset=(1 << 30) - 1000, sampler=smp)
    got = fused_terminal(tp, 5000, n_steps, **kw)
    assert torch.equal(got, fused_terminal_reference(tp, 5000, n_steps, **kw))
    fns = {"avg": ARITH_MEAN, "geo": GEO_MEAN}
    got = fused_functionals(tp, 5000, n_steps, functionals=fns, **kw)
    want = fused_functionals_reference(tp, 5000, n_steps, functionals=fns,
                                       **kw)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("n_steps", [1, 2, 9])
@pytest.mark.parametrize("antithetic", [False, True])
def test_cuda_sabr_sincos_draws_bitwise_equal_plain(cuda, n_steps,
                                                    antithetic):
    """SabrProc's own draws_pair (NormalDraws<2>'s counters, each pair's
    sine and cosine from one sincosf) against the plain version and the
    torch loop: one step, one pair, an odd count; 1000 paths and a count
    not a multiple of 256."""
    tp = _cli_proc("sabr", n_steps, cuda)
    for n in (1000, 4096 * 3 - 37):
        kw = dict(seed=5, path_offset=WRAP, antithetic=antithetic)
        got = fused_terminal(tp, n, n_steps, **kw)
        assert torch.isfinite(got).all()
        assert torch.equal(got, fused_terminal_reference(tp, n, n_steps,
                                                         **kw))
        loop = simulate(tp, n, n_steps, seed=5, path_offset=WRAP,
                        sampler=AntitheticSampler() if antithetic else None)
        assert torch.equal(got, loop)
        fns = {"avg": ARITH_MEAN, "mx": RUNNING_MAX}
        got = fused_functionals(tp, n, n_steps, functionals=fns, **kw)
        want = fused_functionals_reference(tp, n, n_steps, functionals=fns,
                                           **kw)
        for k in want:
            assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
def test_cuda_mixed_processes_refuse_sobol_draws(cuda):
    """A process with uniform draws under device Sobol normals raises
    before anything launches."""
    from montecarlo_tpu_torch.rng.sobol import SobolDeviceSampler

    from montecarlo_tpu_torch.engine import terminal_prices

    counts = {k: v.launches for k, v in PATH_KERNELS.items()}
    for kind in NEW_KINDS[:-1]:
        tp = _cli_proc(kind, 16, cuda)
        smp = SobolDeviceSampler.create(16, tp.n_draws, device=cuda)
        with pytest.raises(ValueError, match="non-normal"):
            fused_terminal(tp, 256, 16, seed=0, sampler=smp)
        with pytest.raises(ValueError, match="non-normal"):
            terminal_prices(tp, 256, 16, seed=0, sampler=smp)
    assert {k: v.launches for k, v in PATH_KERNELS.items()} == counts


@pytest.mark.cuda
def test_cuda_k0_gamma_functions_equal_plain(cuda):
    """expneg_wide32 and the table-inverted gamma variate of the device
    build against their plain versions on the card: bitwise."""
    from montecarlo_tpu_torch.ops.rng_check import (gamma_check,
                                                    gamma_check_reference)

    vg = _cli_proc("vg", 252, cuda)
    rng = np.random.default_rng(5)
    n = 1 << 16
    u_w, u_b = (torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32))
                .to(cuda) for _ in range(2))
    x = torch.from_numpy(rng.uniform(-95, 2, n).astype(np.float32)).to(cuda)
    got = gamma_check(vg, u_w, u_b, x)
    want = gamma_check_reference(vg, u_w, u_b, x)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
def test_cuda_k0_ndtri32_unit_equals_ndtri32_on_its_range(cuda):
    """The functors' inverse normal (ndtri32_unit, called by the QE step
    and VG's gamma inversion) equals ndtri32 in every bit on every float32
    in [2^-24, 1 - 2^-24], and the plain ndtri32 on every
    uniform_from_bits value."""
    from montecarlo_tpu_torch.ops.rng_check import (
        ndtri_unit_check, ndtri_unit_check_reference)

    got = ndtri_unit_check(cuda)
    assert got["mismatches"] == 0, got["first_bits"]
    assert torch.equal(got["uniforms"], ndtri_unit_check_reference(cuda))


# --- local and stochastic-local volatility on K2-K4 --------------------------

def _surface_procs(n_steps, device):
    """The CLI's CEV surface, a time-dependent local-vol surface (16 time
    knots), the CLI's calibrated SLV (n_steps rows) and its SLVKnots."""
    from montecarlo_tpu_torch.processes import LocalVolGBM, slv_to_kernel

    cev = _cli_proc("cev", n_steps, device)
    tdep = LocalVolGBM.create(
        100.0, 0.03, 1.0 / 32, n_steps,
        lambda t, s: 0.2 + 0.1 * np.tanh(np.log(s / 100.0)) + 0.05 * t,
        device=device)
    from montecarlo_tpu_torch.cli.pricing import cli_process

    slv = cli_process(["--process", "slv", "--steps", str(n_steps),
                       "--paths", "16384"], device)[0]
    return {"cev": cev, "tdep": tdep, "slv": slv,
            "slv-knots": slv_to_kernel(slv)}


#: Each surface process under each draw source it takes: the bridge orders
#: one normal per step, so local vol only.
SURFACE_CASES = [(kind, source)
                 for kind in ("cev", "tdep", "slv", "slv-knots")
                 for source in ("plain", "antithetic", "sobol", "bridge")
                 if source != "bridge" or not kind.startswith("slv")]


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows", [1, 17, 259])
@pytest.mark.parametrize("n_tk", [2, 3, 16])
def test_cuda_row_builder_bitwise_equal_plain(cuda, n_tk, n_rows):
    """The row builder (blend_rows_kernel) against blend_rows on the card,
    past the horizon of 17 steps too (the clamp): bitwise, one launch."""
    from montecarlo_tpu_torch.ops import surface_rows
    from montecarlo_tpu_torch.processes import LocalVolGBM
    from montecarlo_tpu_torch.processes.local_vol import blend_rows

    lv = LocalVolGBM.create(
        100.0, 0.03, 1.0 / 32, 17,
        lambda t, s: 0.2 + 0.1 * np.tanh(np.log(s / 100.0)) + 0.05 * t,
        n_time_knots=n_tk, device=cuda)
    before = PATH_KERNELS["surface_rows"].launches
    got = surface_rows(lv.vol_flat, n_rows, lv.dt, lv.dt_knot)
    assert PATH_KERNELS["surface_rows"].launches == before + 1
    want = blend_rows(lv.vol_flat.reshape(-1, 128), list(range(n_rows)),
                      lv.dt, lv.dt_knot)
    assert got.shape == (n_rows, 128)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_surface_rows_built_once_per_process_and_steps(cuda):
    """K2 twice and a tolerance run's K3 chunks on one process and step
    count take one row build; another step count or a copy of the
    process builds again."""
    import dataclasses

    from montecarlo_tpu_torch.engine import price_to_tolerance

    cev = _cli_proc("cev", 17, cuda)
    rows = PATH_KERNELS["surface_rows"]
    k3 = PATH_KERNELS["fused_block_moments"]
    b0, k0 = rows.launches, k3.launches
    a = fused_terminal(cev, 5000, 17, seed=1)
    assert torch.equal(a, fused_terminal(cev, 5000, 17, seed=1))
    price_to_tolerance(cev, VanillaPayoff("call", 100.0),
                       target_std_err=1e-9, seed=1, chunk_paths=4096,
                       n_steps=17, max_chunks=3)
    assert (rows.launches - b0, k3.launches - k0) == (1, 3)
    fused_terminal(cev, 5000, 9, seed=1)
    assert torch.equal(fused_terminal(dataclasses.replace(cev), 5000, 17,
                                      seed=1), a)
    assert rows.launches - b0 == 3


@pytest.mark.cuda
@pytest.mark.parametrize("kind,source", SURFACE_CASES)
def test_cuda_surface_processes_k2_k3_k4_bitwise_equal_plain(cuda, kind,
                                                             source):
    """LocalVolProc, SlvProc (the KernelRows read) and SLVKnots (SlvProc on
    its blended rows) against their plain versions and the torch loop on
    the card under each draw source they take, at an odd and a short step
    count and on path counts that are no multiple of 256; SLV also at more
    steps than it has rows (the clamp)."""
    from montecarlo_tpu_torch.rng.sobol import (SobolBridgeKernelSampler,
                                                SobolDeviceSampler)

    procs = _surface_procs(17, cuda)
    tp = procs[kind]
    pay = VanillaPayoff("call", 100.0)
    fns = {"avg": ARITH_MEAN, "geo": GEO_MEAN, "mx": RUNNING_MAX,
           "mn": RUNNING_MIN}
    n = 4096 * 3
    for n_steps in ((17, 23) if kind == "slv" else (9, 17)):
        kw = dict(seed=3, path_offset=(1 << 30) - 1000)
        loop_smp = None
        if source == "antithetic":
            kw["antithetic"] = True
            loop_smp = AntitheticSampler()
        elif source == "sobol":
            kw["sampler"] = loop_smp = SobolDeviceSampler.create(
                n_steps, tp.n_draws, scramble_seed=4, device=cuda)
        elif source == "bridge":
            kw["sampler"] = loop_smp = SobolBridgeKernelSampler.create(
                n_steps, scramble_seed=4, device=cuda)
        got = fused_terminal(tp, n - 37, n_steps, **kw)
        assert torch.isfinite(got).all()
        assert torch.equal(got, fused_terminal_reference(tp, n - 37, n_steps,
                                                         **kw))
        loop = simulate(tp, n - 37, n_steps, seed=3,
                        path_offset=(1 << 30) - 1000, sampler=loop_smp)
        assert torch.equal(got, loop)
        assert torch.equal(fused_terminal(tp, 1000, n_steps, **kw),
                           fused_terminal_reference(tp, 1000, n_steps, **kw))
        got = fused_block_moments(tp, pay, n, n_steps, **kw)
        want = fused_block_moments_reference(tp, pay, n, n_steps, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        got = fused_functionals(tp, n - 37, n_steps, functionals=fns, **kw)
        want = fused_functionals_reference(tp, n - 37, n_steps,
                                           functionals=fns, **kw)
        for k in want:
            assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
def test_cuda_surface_processes_refuse_bad_tables(cuda):
    """The kernels refuse a surface of fewer than 2 time knots and an SLV
    of no rows, before any launch counts."""
    import dataclasses

    procs = _surface_procs(8, cuda)
    counts = {k: v.launches for k, v in PATH_KERNELS.items()}
    one_knot = dataclasses.replace(procs["cev"],
                                   vol_flat=procs["cev"].vol_flat[:128])
    no_rows = dataclasses.replace(procs["slv"],
                                  lev_rows=procs["slv"].lev_rows[:0])
    for proc in (one_knot, no_rows):
        with pytest.raises(RuntimeError, match="launch failed"):
            fused_terminal(proc, 256, 8, seed=0)
    assert {k: v.launches for k, v in PATH_KERNELS.items()} == counts


@pytest.mark.cuda
def test_cuda_calibration_is_reproducible(cuda):
    """Two calibrations at one seed give the same leverage rows, bit for
    bit (fixed-order deposits, no atomics)."""
    from montecarlo_tpu_torch.cli.pricing import cli_process

    flags = ["--process", "slv", "--steps", "32", "--paths", "65536"]
    a = cli_process(flags, cuda)[0]
    b = cli_process(flags, cuda)[0]
    assert torch.equal(a.lev_rows, b.lev_rows)
    assert torch.isfinite(a.lev_rows).all()


# --- the sharded and streaming path on one NCCL rank ------------------------

@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """A one-rank NCCL process group and its mesh on the current card."""
    import torch.distributed as dist

    from montecarlo_tpu_torch.parallel import make_mesh

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.cuda.set_device(0)
    init = tmp_path_factory.mktemp("nccl") / "init"
    dist.init_process_group("nccl", init_method=f"file://{init}", rank=0,
                            world_size=1)
    try:
        yield make_mesh()
    finally:
        dist.destroy_process_group()


def cuda_dev():
    return torch.device("cuda", torch.cuda.current_device())


def _unsharded(values, block):
    """The unsharded estimate: block_moments, then the fixed tree."""
    from montecarlo_tpu_torch.parallel import block_moments
    from montecarlo_tpu_torch.stats.welford import moments_reduce

    return moments_reduce(block_moments(values, block))


@pytest.mark.cuda
def test_cuda_nccl_mesh_estimates_bitwise_unsharded(nccl_mesh):
    """On a one-rank NCCL mesh (its collectives run on the card's
    tensors): the estimate, the sketch, the functional estimate and rough
    Bergomi are the unsharded computation's bits; a CPU mesh on an NCCL
    group raises."""
    from montecarlo_tpu_torch.parallel import (make_mesh,
                                               sharded_functional_estimate,
                                               sharded_mc_estimate,
                                               sharded_rbergomi_estimate,
                                               sharded_terminal_sketch)
    from montecarlo_tpu_torch.stats.quantiles import sketch_from_array

    mesh = nccl_mesh
    assert mesh.backend == "nccl" and mesh.device.type == "cuda"
    assert mesh.groups["paths"] is not None
    gbm = GBM.create(100.0, 0.03, 0.2, 1 / 252, device=cuda_dev())
    call = VanillaPayoff("call", 105.0)
    n, t = 1 << 18, 64
    est = sharded_mc_estimate(gbm, call, n, t, seed=3, mesh=mesh)
    want = _unsharded(call(fused_terminal(gbm, n, t, seed=3)), 4096)
    assert torch.equal(est["price"], want.mean)
    sk, mo = sharded_terminal_sketch(gbm, n, t, seed=3, mesh=mesh, lo=40.0,
                                     hi=250.0, bins=512)
    term = fused_terminal(gbm, n, t, seed=3)
    ref = sketch_from_array(term, 40.0, 250.0, 512)
    assert torch.equal(sk.counts, ref.counts.to(torch.int64))
    assert torch.equal(mo.mean, _unsharded(term, 4096).mean)
    asian = lambda o: torch.clamp(o["avg"] - 105.0, min=0.0)
    fn = sharded_functional_estimate(gbm, {"avg": ARITH_MEAN}, asian, n, t,
                                     seed=3, mesh=mesh)
    out = simulate_functionals(gbm, n, t, seed=3,
                               functionals={"avg": ARITH_MEAN})
    assert torch.equal(fn["price"], _unsharded(asian(out), 4096).mean)
    model = RoughBergomi.create(100.0, 0.04, 1.9, -0.9, 0.07, n_steps=32,
                                T=1.0, device=cuda_dev())
    pay = lambda s: torch.clamp(s - 100.0, min=0.0)
    rb = sharded_rbergomi_estimate(model, pay, 1 << 14, seed=5, mesh=mesh)
    blocks = torch.cat([pay(rbergomi_simulate(model, 4096, seed=5,
                                              path_offset=4096 * b))
                        for b in range(4)])
    assert torch.equal(rb["price"], _unsharded(blocks, 4096).mean)
    with pytest.raises(ValueError, match="cannot run collectives on cpu"):
        make_mesh(device="cpu")


def _emulated_rank(device, rank, n_ranks):
    """Rank ``rank`` of an ``n_ranks``-rank paths mesh, run in this
    process: its collectives hand back the rank's own tensor and keep it
    in ``sent``, for the test to gather in rank order."""
    from dataclasses import dataclass, field

    from montecarlo_tpu_torch.parallel import PATHS_AXIS, Mesh

    @dataclass(frozen=True, eq=False)
    class EmulatedRank(Mesh):
        sent: list = field(default_factory=list)

        def all_gather(self, x, axis):
            self._check(x)
            self.sent.append(x)
            return x

    return EmulatedRank(shape={PATHS_AXIS: n_ranks},
                        coords={PATHS_AXIS: rank}, device=device,
                        groups={PATHS_AXIS: None}, backend=None)


@pytest.mark.cuda
def test_cuda_emulated_ranks_merge_to_world_size_one(nccl_mesh):
    """Each rank's shard body of a 4-rank mesh, run by
    ``sharded_mc_estimate`` on that rank's mesh, its block states
    concatenated in rank order and merged: world size 1's bits."""
    from montecarlo_tpu_torch.parallel import sharded_mc_estimate
    from montecarlo_tpu_torch.stats.welford import (MomentState,
                                                    moments_reduce,
                                                    std_error)

    gbm = GBM.create(100.0, 0.03, 0.2, 1 / 252, device=cuda_dev())
    call = VanillaPayoff("call", 105.0)
    n, t = 1 << 18, 64
    one = sharded_mc_estimate(gbm, call, n, t, seed=9, mesh=nccl_mesh)
    ranks = [_emulated_rank(nccl_mesh.device, r, 4) for r in range(4)]
    for rank in ranks:
        sharded_mc_estimate(gbm, call, n, t, seed=9, mesh=rank)
    merged = moments_reduce(MomentState(*torch.cat(
        [rank.sent[0] for rank in ranks]).T))
    assert torch.equal(merged.mean, one["price"])
    assert torch.equal(std_error(merged), one["std_err"])


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [2**31 - 4096, 2**32 - 4096])
def test_cuda_k2_past_2_31_bitwise_equal_plain(cuda, offset):
    """K2 at path offsets past 2^31 (the second wraps the uint32 id
    space) against its plain version."""
    gbm = GBM.create(100.0, 0.03, 0.2, 1 / 252, device=cuda)
    kw = dict(seed=4, path_offset=offset)
    assert torch.equal(fused_terminal(gbm, 8192, 64, **kw),
                       fused_terminal_reference(gbm, 8192, 64, **kw))


@pytest.mark.cuda
def test_cuda_streaming_resume_bitwise_and_rows_built_once(nccl_mesh,
                                                           tmp_path):
    """A stream stopped by its progress callback after chunk 2 resumes
    from its .npz to the one-shot run's bits, over the NCCL mesh too; a
    local-vol surface's rows are built once for every chunk and the
    sharded estimate of one process and step count."""
    from montecarlo_tpu_torch.engine.streaming import (StreamingState,
                                                       streaming_estimate)
    from montecarlo_tpu_torch.parallel import sharded_mc_estimate

    gbm = GBM.create(100.0, 0.03, 0.2, 1 / 252, device=cuda_dev())
    kw = dict(seed=5, block_size=4096, lo=40.0, hi=260.0, bins=1024)
    total = 1 << 18
    oneshot = streaming_estimate(gbm, total, 64, chunk_paths=total, **kw)
    ckpt = str(tmp_path / "s.npz")

    def stop(done, total_, se):
        if done == 2 * (total // 4):
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        streaming_estimate(gbm, total, 64, chunk_paths=total // 4,
                           checkpoint_path=ckpt, progress_callback=stop,
                           **kw)
    resumed = streaming_estimate(gbm, total, 64, chunk_paths=total // 4,
                                 checkpoint_path=ckpt, mesh=nccl_mesh, **kw)
    for k in ("block_mean", "block_m2"):
        np.testing.assert_array_equal(getattr(resumed, k),
                                      getattr(oneshot, k))
    np.testing.assert_array_equal(resumed.sketch.counts,
                                  oneshot.sketch.counts)
    assert StreamingState.load(ckpt).paths_done == total
    cev = _cli_proc("cev", 17, cuda_dev())
    rows = PATH_KERNELS["surface_rows"]
    b0 = rows.launches
    streaming_estimate(cev, total, 17, chunk_paths=total // 4, **kw)
    sharded_mc_estimate(cev, VanillaPayoff("call", 100.0), total, 17,
                        seed=5, mesh=nccl_mesh)
    assert rows.launches - b0 == 1


# --- the rate and term-structure processes (csrc/fused_rates.cu) -------------

def _rate_procs(n_steps, device):
    """The bond CLI's four models over n_steps (curves of n_steps steps),
    Euler GBM and a term-structure GBM on seeded curves."""
    import argparse

    from montecarlo_tpu_torch.cli import bond
    from montecarlo_tpu_torch.processes import EulerGBM, TermStructureGBM

    parser = argparse.ArgumentParser()
    bond.add_parsers(parser.add_subparsers())
    procs = {}
    for model in ("vasicek", "cir", "hullwhite", "g2pp"):
        args = parser.parse_args(["bond", "--model", model, "--steps",
                                  str(n_steps)])
        procs[model] = bond.build_model(args, device)[0]
    rng = np.random.default_rng(n_steps)
    procs["euler-gbm"] = EulerGBM.create(100.0, 0.03, 0.2, 1 / 64,
                                         device=device)
    procs["term-gbm"] = TermStructureGBM.from_curves(
        100.0, rng.uniform(0.0, 0.05, n_steps), rng.uniform(0.1, 0.3,
                                                            n_steps),
        1 / 64, device=device)
    return procs


RATE_CASES = [(k, s) for k in ("euler-gbm", "term-gbm", "vasicek", "cir",
                               "hullwhite", "g2pp")
              for s in ("plain", "antithetic", "sobol", "bridge")
              if not (k == "g2pp" and s == "bridge")]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,source", RATE_CASES)
def test_cuda_rate_processes_k2_k3_k4_bitwise_equal_plain(cuda, kind,
                                                          source):
    """K2, K3 and K4 ({trap, avg}) on each rate and term-structure functor
    against their plain versions and the torch loop, under each draw source
    it takes, at 9 and 17 steps, on path counts that are no multiple of
    128, ids from 2^30 - 1000; each launch counted."""
    from montecarlo_tpu_torch.rng.sobol import (SobolBridgeKernelSampler,
                                                SobolDeviceSampler)

    pay = VanillaPayoff("digital", 0.04 if kind not in ("euler-gbm",
                                                        "term-gbm")
                        else 100.0)
    n = 4096 * 3
    for n_steps in (9, 17):
        tp = _rate_procs(n_steps, cuda)[kind]
        fns = {"trap": trapezoid_integral(float(tp.dt)), "avg": ARITH_MEAN}
        kw = dict(seed=3, path_offset=(1 << 30) - 1000)
        loop_smp = None
        if source == "antithetic":
            kw["antithetic"] = True
            loop_smp = AntitheticSampler()
        elif source == "sobol":
            kw["sampler"] = loop_smp = SobolDeviceSampler.create(
                n_steps, tp.n_draws, scramble_seed=4, device=cuda)
        elif source == "bridge":
            kw["sampler"] = loop_smp = SobolBridgeKernelSampler.create(
                n_steps, scramble_seed=4, device=cuda)
        counted = {k: PATH_KERNELS[k].launches for k in PATH_KERNELS}
        got = fused_terminal(tp, n - 37, n_steps, **kw)
        assert torch.isfinite(got).all()
        assert torch.equal(got, fused_terminal_reference(tp, n - 37, n_steps,
                                                         **kw))
        assert torch.equal(got, simulate(tp, n - 37, n_steps, seed=3,
                                         path_offset=(1 << 30) - 1000,
                                         sampler=loop_smp))
        got = fused_block_moments(tp, pay, n, n_steps, **kw)
        want = fused_block_moments_reference(tp, pay, n, n_steps, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        got = fused_functionals(tp, n - 37, n_steps, functionals=fns, **kw)
        want = fused_functionals_reference(tp, n - 37, n_steps,
                                           functionals=fns, **kw)
        loop = simulate_functionals(tp, n - 37, n_steps, seed=3,
                                    path_offset=(1 << 30) - 1000,
                                    functionals=fns, sampler=loop_smp,
                                    prefer_fused=False)
        for k in want:
            assert torch.equal(got[k], want[k]), k
            assert torch.equal(got[k], loop[k]), k
        sfx = {"sobol": "_sobol", "bridge": "_bridge"}.get(source, "")
        for name in ("fused_terminal", "fused_block_moments",
                     "fused_functionals"):
            assert (PATH_KERNELS[name + sfx].launches
                    == counted[name + sfx] + 1), name + sfx


@pytest.mark.cuda
def test_cuda_g2pp_under_the_bridge_takes_the_torch_loop(cuda):
    from montecarlo_tpu_torch.engine import kernel_route
    from montecarlo_tpu_torch.rng.sobol import SobolBridgeKernelSampler

    g2 = _rate_procs(17, cuda)["g2pp"]
    bridge = SobolBridgeKernelSampler.create(17, device=cuda)
    assert not kernel_route(g2, bridge, 17)
    with pytest.raises(ValueError, match="n_draws == 1"):
        fused_terminal(g2, 1024, 17, seed=0, sampler=bridge)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["term-gbm", "hullwhite"])
def test_cuda_curve_refused_before_any_launch(cuda, kind):
    tp = _rate_procs(8, cuda)[kind]
    before = {k: v.launches for k, v in PATH_KERNELS.items()}
    fns = {"avg": ARITH_MEAN}
    for run in (lambda n: fused_terminal(tp, 1024, n, seed=0),
                lambda n: fused_block_moments(tp, VanillaPayoff("call", 0.0),
                                              4096, n, seed=0),
                lambda n: fused_functionals(tp, 1024, n, seed=0,
                                            functionals=fns),
                lambda n: simulate(tp, 1024, n, seed=0)):
        with pytest.raises(ValueError, match="8 steps, 9"):
            run(9)
    assert {k: v.launches for k, v in PATH_KERNELS.items()} == before
    assert torch.equal(fused_terminal(tp, 1024, 8, seed=0),
                       fused_terminal_reference(tp, 1024, 8, seed=0))


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [
    ["--model", "vasicek"], ["--model", "cir"], ["--model", "hullwhite"],
    ["--model", "g2pp"], ["--option"], ["--cap"], ["--cap", "--floor"],
    ["--model", "g2pp", "--swaption"]])
def test_cuda_bond_json_matches_the_cpu_route(cuda, flags, capsys):
    """``bond`` on the card against ``--device cpu``: the same keys, the
    closed forms equal (host float64), the Monte Carlo values within rtol
    1e-5 (the CPU's libm and sqrt are not the card's) and atol 1e-7 (the
    bond option's intrinsic value P(T1, T2) - K is a difference of two
    numbers near 0.96, whose float32 ULP is 6e-8; the cap's values are
    rounded to 8 decimals)."""
    import json

    from montecarlo_tpu_torch.cli import main

    argv = ["bond", "--paths", "16384", "--steps", "32", *flags]
    out = {}
    for dev in ("cuda", "cpu"):
        assert main([*argv, "--device", dev]) == 0
        out[dev] = json.loads(capsys.readouterr().out.strip()
                              .splitlines()[-1])
    got, want = out["cuda"], out["cpu"]
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if k in ("closed_form", "jamshidian", "strike", "expiry",
                 "periods", "resets", "instrument", "g2pp_european_swaption"):
            assert got[k] == w, k
        else:
            np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-7,
                                       err_msg=k)


def _state_proc(kind, a_n, n_steps, device):
    """TermBasketGBM, CCC-GARCH or DCC-GARCH on a seeded A-asset book:
    half a sample correlation and half the identity, spots in [50, 150],
    daily variances in [1e-4, 4e-4], equal weights; the term basket on
    seeded curves of n_steps entries."""
    from montecarlo_tpu_torch.processes import (CCCGarch, DCCGarch,
                                                TermBasketGBM)

    rng = np.random.default_rng(a_n)
    c = np.atleast_2d(np.corrcoef(rng.normal(size=(a_n, 4 * a_n))))
    corr = 0.5 * c + 0.5 * np.eye(a_n)
    s0, var0 = rng.uniform(50, 150, a_n), rng.uniform(1e-4, 4e-4, a_n)
    w = np.full(a_n, 1.0 / a_n)
    if kind == "term-basket":
        return TermBasketGBM.create(
            s0, rng.uniform(0.0, 0.05, (a_n, n_steps)),
            rng.uniform(0.1, 0.3, (a_n, n_steps)), corr, w, 1 / 252,
            device=device)
    g = dict(omega=0.02 * var0, alpha=[0.08] * a_n, beta=[0.9] * a_n)
    if kind == "ccc-garch":
        return CCCGarch.create(s0, var0, corr=corr, weights=w,
                               device=device, **g)
    return DCCGarch.create(s0, var0, qbar=corr, weights=w, a_dcc=0.05,
                           b_dcc=0.9, device=device, **g)


STATE_CASES = [(k, a) for k in ("term-basket", "ccc-garch", "dcc-garch")
               for a in range(1, 9)]


@pytest.mark.cuda
@pytest.mark.parametrize("n_steps", [9, 10])
@pytest.mark.parametrize("kind,a_n", STATE_CASES)
def test_cuda_state_processes_k2_k3_k4_bitwise_equal_plain(cuda, kind,
                                                           a_n, n_steps):
    """K2, K3 (a put) and K4 ({avg, mn}) on TermBasketGBM, CCC-GARCH and
    DCC-GARCH at every asset count of their functors (StateProc<Step<A>,
    A>, A = 1..8; CCC and DCC on their by-value leaves, a step's draws
    just before it at an even A) against their plain versions and the
    torch loop, under Threefry plain and antithetic and Sobol draws, at 9
    steps (the pair's dropped final step) and 10, on path counts that are
    no multiple of 128, ids from 2^30 - 1000; each launch counted."""
    from montecarlo_tpu_torch.rng.sobol import SobolDeviceSampler

    n = 4096 * 3
    tp = _state_proc(kind, a_n, n_steps, cuda)
    pay = VanillaPayoff("put", float(torch.dot(tp.weights, tp.s0)))
    fns = {"avg": ARITH_MEAN, "mn": RUNNING_MIN}
    sobol = SobolDeviceSampler.create(n_steps, a_n, scramble_seed=4,
                                      device=cuda)
    for source, extra, loop_smp in (("", {}, None),
                                    ("", {"antithetic": True},
                                     AntitheticSampler()),
                                    ("_sobol", {"sampler": sobol}, sobol)):
        kw = dict(seed=3, path_offset=(1 << 30) - 1000, **extra)
        counted = {k: PATH_KERNELS[k].launches for k in PATH_KERNELS}
        got = fused_terminal(tp, n - 37, n_steps, **kw)
        assert torch.isfinite(got).all()
        assert torch.equal(got, fused_terminal_reference(tp, n - 37, n_steps,
                                                         **kw))
        assert torch.equal(got, simulate(tp, n - 37, n_steps, seed=3,
                                         path_offset=(1 << 30) - 1000,
                                         sampler=loop_smp))
        got = fused_block_moments(tp, pay, n, n_steps, **kw)
        want = fused_block_moments_reference(tp, pay, n, n_steps, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        got = fused_functionals(tp, n - 37, n_steps, functionals=fns, **kw)
        want = fused_functionals_reference(tp, n - 37, n_steps,
                                           functionals=fns, **kw)
        loop = simulate_functionals(tp, n - 37, n_steps, seed=3,
                                    path_offset=(1 << 30) - 1000,
                                    functionals=fns, sampler=loop_smp,
                                    prefer_fused=False)
        for k in want:
            assert torch.equal(got[k], want[k]), k
            assert torch.equal(got[k], loop[k]), k
        for name in ("fused_terminal", "fused_block_moments",
                     "fused_functionals"):
            assert (PATH_KERNELS[name + source].launches
                    == counted[name + source] + 1), name + source


@pytest.mark.cuda
@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("n_steps", [9, 10])
@pytest.mark.parametrize("a_n", [2, 4, 6, 8])
def test_cuda_state_draws_a_step_at_a_time_are_the_pairs(cuda, a_n,
                                                         n_steps,
                                                         antithetic):
    """At an even asset count CCC's and DCC's kernels draw each step's A
    normals just before it (csrc/fused_mgarch.cuh::step_normals): bitwise
    the normals of the plain versions' draws_pair per pair of steps, the
    odd final step's the pair's first half, ids across 2^32."""
    from montecarlo_tpu_torch.ops.rng_check import (
        state_draws_check, state_draws_check_reference)

    kw = dict(seed=11, path_offset=2**32 - 300, antithetic=antithetic)
    for kind in ("ccc-garch", "dcc-garch"):
        tp = _state_proc(kind, a_n, n_steps, cuda)
        got = state_draws_check(tp, 1000, n_steps, **kw)
        want = state_draws_check_reference(tp, 1000, n_steps, **kw)
        assert got.shape == (n_steps, a_n, 1000)
        assert torch.isfinite(got).all()
        assert torch.equal(got, want), kind


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ccc-garch", "dcc-garch"])
def test_cuda_state_launch_leaves_built_once_on_the_host(cuda, kind):
    """CCC's and DCC's launch leaves are the plain versions' constants
    (log32(s0) and DCC's c qbar from torch on the card) copied once per
    process to the host, whence every launch copies them into the
    kernel's parameters."""
    from montecarlo_tpu_torch.ops.fused_engine import (_ROW_LEAVES,
                                                       state_launch_leaves)

    tp = _state_proc(kind, 8, 10, cuda)
    fused_terminal(tp, 1024, 10, seed=0)
    hit = _ROW_LEAVES[id(tp)][2][1]
    assert hit.device.type == "cpu"
    assert torch.equal(hit, state_launch_leaves(tp).cpu())
    fused_block_moments(tp, VanillaPayoff("put", 100.0), 4096, 10, seed=0)
    assert _ROW_LEAVES[id(tp)][2][1] is hit


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["term-basket", "ccc-garch", "dcc-garch"])
def test_cuda_state_processes_refused_before_any_launch(cuda, kind):
    """Nine assets go to the torch loop, the bridge is refused at one and
    eight, and the term basket refuses a run past its curves, before any
    launch."""
    from montecarlo_tpu_torch.engine import kernel_route, terminal_prices
    from montecarlo_tpu_torch.rng.sobol import SobolBridgeKernelSampler

    before = {k: v.launches for k, v in PATH_KERNELS.items()}
    nine = _state_proc(kind, 9, 8, cuda)
    assert not kernel_route(nine, None, 8)
    assert torch.equal(terminal_prices(nine, 1024, 8, seed=0),
                       simulate(nine, 1024, 8, seed=0))
    with pytest.raises(ValueError, match="at most 8"):
        fused_terminal(nine, 1024, 8, seed=0)
    bridge = SobolBridgeKernelSampler.create(8, device=cuda)
    for a_n in (1, 8):
        tp = _state_proc(kind, a_n, 8, cuda)
        with pytest.raises(ValueError, match="bridge"):
            fused_terminal(tp, 1024, 8, seed=0, sampler=bridge)
        if kind == "term-basket":
            with pytest.raises(ValueError, match="8 steps, 9"):
                fused_functionals(tp, 1024, 9, seed=0,
                                  functionals={"avg": ARITH_MEAN})
    assert {k: v.launches for k, v in PATH_KERNELS.items()} == before


# --- K4's fixed folds on the bond models and the term basket -----------------

def _k4_counted(tp, n, n_steps, fns, **kw):
    """K4 on ``tp`` and its plain version, bitwise, and the launch's count
    deltas: (K4's, the fixed folds')."""
    from montecarlo_tpu_torch.rng.sobol import SobolDeviceSampler

    sfx = ("_sobol" if isinstance(kw.get("sampler"), SobolDeviceSampler)
           else "_bridge" if kw.get("sampler") is not None else "")
    k4 = PATH_KERNELS["fused_functionals" + sfx].launches
    fixed = PATH_KERNELS["fused_functionals_fixed" + sfx].launches
    got = fused_functionals(tp, n, n_steps, functionals=fns, **kw)
    counts = (PATH_KERNELS["fused_functionals" + sfx].launches - k4,
              PATH_KERNELS["fused_functionals_fixed" + sfx].launches - fixed)
    want = fused_functionals_reference(tp, n, n_steps, functionals=fns, **kw)
    for k in want:
        assert torch.isfinite(got[k]).all(), k
        assert torch.equal(got[k], want[k]), k
    return counts


@pytest.mark.cuda
@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("n_steps", [9, 17])
@pytest.mark.parametrize("kind", ["vasicek", "cir", "hullwhite", "g2pp"])
def test_cuda_k4_trap_on_the_bond_models_runs_its_fixed_fold(cuda, kind,
                                                            n_steps,
                                                            antithetic):
    """K4 {trap} (the bond command's discount integral) on Vasicek, CIR,
    Hull-White and G2++ under Threefry draws, plain and antithetic: the
    fixed fold (csrc/fused_rates.cu, FixedFold<kTrapezoid>), bitwise its
    plain version, each launch counted as K4's and as a fixed fold's."""
    tp = _rate_procs(n_steps, cuda)[kind]
    fns = {"trap": trapezoid_integral(float(tp.dt))}
    assert _k4_counted(tp, 4096 * 3 - 37, n_steps, fns, seed=5,
                       path_offset=(1 << 30) - 1000,
                       antithetic=antithetic) == (1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("n_steps", [9, 10])
@pytest.mark.parametrize("a_n", range(1, 9))
def test_cuda_k4_term_basket_avg_runs_its_fixed_fold(cuda, a_n, n_steps,
                                                     antithetic):
    """K4 {avg} (the term basket's Asian) at every asset count under
    Threefry draws, plain and antithetic: the fixed fold
    (csrc/fused_term_basket_k4.cu, FixedFold<kArithMean>), bitwise its
    plain version, each launch counted as K4's and as a fixed fold's."""
    tp = _state_proc("term-basket", a_n, n_steps, cuda)
    assert _k4_counted(tp, 4096 * 3 - 37, n_steps, {"avg": ARITH_MEAN},
                       seed=5, path_offset=(1 << 30) - 1000,
                       antithetic=antithetic) == (1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["vasicek", "g2pp", "euler-gbm",
                                  "term-gbm", "gbm", "term-basket"])
def test_cuda_k4_trap_and_avg_elsewhere_run_the_generic_fold(cuda, kind):
    """{trap} and the term basket's {avg} where no fixed fold is built for
    them: under Sobol draws, under the bridge (one draw), {trap} on Euler
    GBM, term-structure GBM and GBM: the generic fold, bitwise its plain
    version, counted as K4's only."""
    from montecarlo_tpu_torch.rng.sobol import (SobolBridgeKernelSampler,
                                                SobolDeviceSampler)

    n_steps, n = 17, 4096 * 3 - 37
    if kind == "gbm":
        tp = _process("gbm", n_steps, cuda)
    elif kind == "term-basket":
        tp = _state_proc(kind, 5, n_steps, cuda)
    else:
        tp = _rate_procs(n_steps, cuda)[kind]
    fns = ({"avg": ARITH_MEAN} if kind == "term-basket"
           else {"trap": trapezoid_integral(float(tp.dt))})
    runs = [{"sampler": SobolDeviceSampler.create(
        n_steps, tp.n_draws, scramble_seed=4, device=cuda)}]
    if tp.n_draws == 1:
        runs.append({"sampler": SobolBridgeKernelSampler.create(
            n_steps, scramble_seed=4, device=cuda)})
    if kind in ("euler-gbm", "term-gbm", "gbm"):
        runs += [{}, {"antithetic": True}]
    for extra in runs:
        assert _k4_counted(tp, n, n_steps, fns, seed=6, **extra) == (1, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("a_n", [3, 8])
@pytest.mark.parametrize("kind", ["ccc-garch", "dcc-garch"])
def test_cuda_k4_ccc_and_dcc_keep_the_generic_fold(cuda, kind, a_n):
    """CCC's and DCC's by-value K4 (state_functional_kernel) runs the
    generic fold for every set, the ones FixedFolds names too ({avg}) and
    the running minimum of the VaR path ({mn}): bitwise its plain version,
    counted as K4's only."""
    tp = _state_proc(kind, a_n, 10, cuda)
    for fns in ({"avg": ARITH_MEAN}, {"mn": RUNNING_MIN}):
        for anti in (False, True):
            assert _k4_counted(tp, 4096 * 3 - 37, 10, fns, seed=7,
                               antithetic=anti) == (1, 0)


def _snapshot_counts(sfx=""):
    """(the snapshot kernel's launches, K4's) under the counters' suffix."""
    return (PATH_KERNELS["fused_functionals_snapshot" + sfx].launches,
            PATH_KERNELS["fused_functionals" + sfx].launches)


@pytest.mark.cuda
@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("kind", ["gbm", "heston"])
def test_cuda_k4_snapshot_is_its_plain_version_and_the_shorter_run(
        cuda, kind, antithetic):
    """K4 {snapshot} at steps 0, 1, 9 and the last, at 17 steps: the
    snapshot kernel, one launch and none of K4's, bitwise its plain
    version and K4's, and each snapshot K2's terminal of a run stopped at
    its step."""
    from montecarlo_tpu_torch.engine.surface import price_snapshot

    tp, n, steps = _process(kind, 17, cuda), 4096 * 3 - 37, 17
    fns = {f"s{s}": price_snapshot(s) for s in (0, 1, 9, steps)}
    kw = dict(seed=4, path_offset=(1 << 30) - 1000, antithetic=antithetic)
    before = _snapshot_counts()
    got = fused_functionals(tp, n, steps, functionals=fns, **kw)
    after = _snapshot_counts()
    assert (after[0] - before[0], after[1] - before[1]) == (1, 0)
    want = fused_functionals_reference(tp, n, steps, functionals=fns, **kw)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for s in (0, 1, 9, steps):
        assert torch.equal(got[f"s{s}"], fused_terminal(tp, n, s, **kw)), s


@pytest.mark.cuda
def test_cuda_surface_grid_launches_are_one_long_run(cuda):
    """A six-maturity grid on the card: one launch of the snapshot kernel
    and none of K4's, bitwise one torch-loop run holding every
    snapshot."""
    from montecarlo_tpu_torch.engine.surface import (price_snapshot,
                                                     snapshot_terminals)

    steps, tp = [3, 8, 13, 21, 30, 47], _process("heston", 64, cuda)
    before = _snapshot_counts()
    rows = snapshot_terminals(tp, 4096, steps, seed=2)
    after = _snapshot_counts()
    assert (after[0] - before[0], after[1] - before[1]) == (1, 0)
    one = simulate_functionals(tp, 4096, steps[-1], seed=2,
                               prefer_fused=False, functionals={
        f"m{j}": price_snapshot(s) for j, s in enumerate(steps)})
    for j in range(len(steps)):
        assert torch.equal(rows[j], one[f"m{j}"]), j


#: The snapshot kernel's draw sources on GBM and Heston
#: (ops/fused_engine.py::SNAPSHOT_SOURCES).
SNAPSHOT_CASES = ([("gbm", s) for s in ("plain", "antithetic", "sobol",
                                        "bridge")]
                  + [("heston", s) for s in ("plain", "antithetic",
                                             "sobol")])


def _snapshot_draws(tp, source, n_steps, device):
    """The launch arguments of ``source`` and its counters' suffix."""
    from montecarlo_tpu_torch.rng.sobol import (SobolBridgeKernelSampler,
                                                SobolDeviceSampler)

    if source == "sobol":
        return {"sampler": SobolDeviceSampler.create(
            n_steps, tp.n_draws, scramble_seed=3, device=device)}, "_sobol"
    if source == "bridge":
        return {"sampler": SobolBridgeKernelSampler.create(
            n_steps, scramble_seed=4, device=device)}, "_bridge"
    return {"antithetic": source == "antithetic"}, ""


def _snapshot_steps(n_steps, m, seed):
    """m snapshot steps out of order: the middle (odd) step, 0, the last,
    one past it, 1 and the middle again, then random steps in [0, n_steps
    + 1]."""
    mid = n_steps // 2 | 1
    rest = np.random.default_rng(seed).integers(0, n_steps + 2, 64)
    return ([mid, 0, n_steps, n_steps + 1, 1, mid] + rest.tolist())[:m]


@pytest.mark.cuda
@pytest.mark.parametrize("n_steps", [17, 252])
@pytest.mark.parametrize("kind,source", SNAPSHOT_CASES)
def test_cuda_snapshot_kernel_is_its_plain_version(cuda, kind, source,
                                                   n_steps):
    """The snapshot kernel (csrc/fused_k4_snapshot.cu) on grids of 1, 4, 6,
    64 and 65 snapshots, the last split by the wrapper into 64 and 1:
    bitwise its plain version and K4's, on a ragged path count with ids
    from 2^30 - 1000, each launch counted once on the snapshot kernel's
    counter and none on K4's."""
    from montecarlo_tpu_torch.engine.surface import price_snapshot
    from montecarlo_tpu_torch.ops import (fused_snapshots,
                                          fused_snapshots_reference)

    tp = _process(kind, n_steps, cuda)
    draws, sfx = _snapshot_draws(tp, source, n_steps, cuda)
    kw = dict(seed=4, path_offset=(1 << 30) - 1000, **draws)
    n = 4096 * 3 - 37
    for m in (1, 4, 6, 64, 65):
        steps = _snapshot_steps(n_steps, m, m)
        fns = {f"s{k}": price_snapshot(s) for k, s in enumerate(steps)}
        before = _snapshot_counts(sfx)
        got = fused_functionals(tp, n, n_steps, functionals=fns, **kw)
        after = _snapshot_counts(sfx)
        assert (after[0] - before[0], after[1] - before[1]) == (
            1 if m <= 64 else 2, 0), m
        want = fused_functionals_reference(tp, n, n_steps, functionals=fns,
                                           **kw)
        for k in want:
            assert torch.isfinite(got[k]).all(), (m, k)
            assert torch.equal(got[k], want[k]), (m, k)
        if m <= 64:
            rows = fused_snapshots(tp, n, n_steps, steps, **kw)
            assert torch.equal(rows, fused_snapshots_reference(
                tp, n, n_steps, steps, **kw)), m


@pytest.mark.cuda
@pytest.mark.parametrize("antithetic", [False, True])
def test_cuda_snapshot_kernel_on_every_functor(cuda, antithetic):
    """The snapshot kernel on the other functors it is built for, under
    Threefry draws (GARCH, the jump, Levy, QE and SABR functors, local vol
    and SLV on rows and on knots) at 17 steps, six snapshots: bitwise its
    plain version, one launch each."""
    from montecarlo_tpu_torch.ops import (fused_snapshots,
                                          fused_snapshots_reference)

    procs = {kind: _cli_proc(kind, 17, cuda) for kind in NEW_KINDS}
    procs["garch"] = _garch(503, cuda)
    procs.update(_surface_procs(17, cuda))
    steps = _snapshot_steps(17, 6, 0)
    kw = dict(seed=6, path_offset=WRAP, antithetic=antithetic)
    for kind, tp in procs.items():
        before = _snapshot_counts()
        got = fused_snapshots(tp, 4096 - 37, 17, steps, **kw)
        assert _snapshot_counts()[0] == before[0] + 1, kind
        want = fused_snapshots_reference(tp, 4096 - 37, 17, steps, **kw)
        assert torch.isfinite(got).all(), kind
        assert torch.equal(got, want), kind


@pytest.mark.cuda
def test_cuda_greeks_command_and_pathwise_gradients(cuda, capsys):
    """``greeks`` on the card at a small size: pathwise gradients through
    the torch loop, non-zero and finite (the case the kernels' missing
    backward would have zeroed), within the CPU route's values; LR through
    K2 (one launch); second order finite."""
    import json

    from montecarlo_tpu_torch import cli

    def run(*argv):
        assert cli.main(["greeks", "--paths", "8192", "--steps", "16",
                         *argv]) == 0
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    for proc in ("gbm", "heston"):
        card = run("--process", proc)
        cpu = run("--process", proc, "--device", "cpu")
        assert card.keys() == cpu.keys()
        for k, v in card.items():
            assert math.isfinite(v) and (k == "price" or v != 0.0), k
            assert abs(v - cpu[k]) <= 1e-4 * abs(cpu[k]) + 1e-6, k
    k2 = PATH_KERNELS["fused_terminal"].launches
    lr = run("--method", "lr", "--payoff", "digital")
    assert PATH_KERNELS["fused_terminal"].launches - k2 == 1
    assert lr["delta"] > 0
    so = run("--method", "second-order")
    assert all(math.isfinite(v) for v in so.values()) and so["gamma"] > 0


@pytest.mark.cuda
def test_cuda_kernel_routes_refuse_a_leaf_that_requires_grad(cuda):
    """On the card as on the CPU: TypeError before any launch."""
    import dataclasses

    from montecarlo_tpu_torch.engine import terminal_prices

    tp = _process("gbm", 16, cuda)
    tp = dataclasses.replace(tp, s0=tp.s0.clone().requires_grad_(True))
    before = {k: v.launches for k, v in PATH_KERNELS.items()}
    for run in (lambda: terminal_prices(tp, 4096, 16, seed=1),
                lambda: fused_functionals(tp, 4096, 16, seed=1,
                                          functionals={"avg": ARITH_MEAN}),
                lambda: gbm_terminal(tp, 4096, 16, seed=1)):
        with pytest.raises(TypeError, match="price_and_greeks"):
            run()
    assert {k: v.launches for k, v in PATH_KERNELS.items()} == before


# --- calibration, multilevel Monte Carlo and the gamma sampler ----------------

CALIBRATE_MODELS = ("heston", "vg", "nig", "merton", "kou", "vasicek",
                    "sabr")


@pytest.fixture(scope="module")
def calibrate_demos():
    """Every ``calibrate --model M`` demo on the card (the default device),
    each in a process of its own, all at once: {model: JSON}."""
    import json
    import os
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = {m: subprocess.Popen(
        [sys.executable, "-m", "montecarlo_tpu_torch", "calibrate",
         "--model", m], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env) for m in CALIBRATE_MODELS}
    out = {}
    try:
        for m, p in procs.items():
            stdout, stderr = p.communicate(timeout=600)
            assert p.returncode == 0, (m, stderr[-2000:])
            out[m] = json.loads(stdout.strip().splitlines()[-1])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("model", CALIBRATE_MODELS)
def test_cuda_calibrate_recovers_every_demo(cuda, calibrate_demos, model):
    """``calibrate --model M`` on the card, each demo to the JAX tests'
    tolerances (tests/test_heston_analytic.py, test_levy_calibration.py,
    test_rates_calibration.py's CLI test, test_sabr_calibration.py)."""
    out = calibrate_demos[model]
    truth = out["demo_truth"]
    if model == "heston":
        from montecarlo_tpu_torch.cli.calibrate import demo_surface
        from montecarlo_tpu_torch.engine.heston_analytic import (
            HestonParams, heston_call_cf)
        from montecarlo_tpu_torch.engine.implied_vol import implied_vol_call

        class Args:
            s0, rate = 100.0, 0.03

        ks, ts, ivs, _ = demo_surface("heston", Args, cuda)
        f32 = dict(dtype=torch.float32, device=cuda)
        fit = HestonParams(**{k: torch.tensor(out[k], **f32)
                              for k in HestonParams._fields})
        kt, tt = torch.tensor(ks, **f32), torch.tensor(ts, **f32)
        fit_iv = implied_vol_call(heston_call_cf(100.0, kt, tt, 0.03, fit),
                                  100.0, kt, 0.03, tt)
        assert float(torch.max(torch.abs(fit_iv.double().cpu()
                                         - torch.tensor(ivs)))) < 0.004, out
        assert abs(out["v0"] - truth["v0"]) < 0.02, out
    elif model in ("vg", "nig"):
        assert out["rmse_vol"] < 5e-4, out
        if model == "vg":
            for k, v in truth.items():
                assert abs(out[k] - v) < 0.01 * max(abs(v), 0.1), (k, out)
        else:
            assert abs(out["delta"] - truth["delta"]) < 0.02, out
            assert abs(out["beta"] - truth["beta"]) < 0.2, out
            assert abs(out["alpha"] - truth["alpha"]) < 0.5, out
    elif model in ("merton", "kou"):
        assert out["rmse_vol"] < 1e-3, out
        slack = 0.015 if model == "merton" else 0.02
        assert abs(out["sigma"] - truth["sigma"]) < slack, out
    elif model == "vasicek":
        assert out["rmse_rel"] < 2e-3, out
        assert abs(out["kappa"] - truth["kappa"]) < 0.1, out
    else:
        assert out["rmse_vol"] < 5e-4, out
        assert abs(out["alpha"] - truth["alpha"]) / truth["alpha"] < 0.05
        assert abs(out["nu"] - truth["nu"]) < 0.05, out
        assert abs(out["rho"] - truth["rho"]) < 0.08, out


@pytest.mark.cuda
def test_cuda_calibration_graphs_hold_no_host_tensor(cuda):
    """Every tensor a card fit's loss saves for its backward pass lies on
    the card: nothing of the graph round-trips through the host."""
    from montecarlo_tpu_torch.engine import heston_analytic as ha
    from montecarlo_tpu_torch.engine import levy_calibration as lc
    from montecarlo_tpu_torch.engine import rates_calibration as rc
    from montecarlo_tpu_torch.processes import sabr

    f32 = dict(dtype=torch.float32, device=cuda)
    ks = torch.tensor([80.0, 90.0, 100.0, 110.0, 120.0] * 3, **f32)
    ts = torch.tensor([0.25] * 5 + [0.5] * 5 + [1.0] * 5, **f32)
    ivs = torch.full((15,), 0.2, **f32)
    s0, r = torch.tensor(100.0, **f32), torch.tensor(0.03, **f32)
    e = torch.tensor([1.0, 2.0, 3.0], **f32)
    prices = torch.tensor([0.01, 0.012, 0.013], **f32)
    losses = {
        "heston": (ha._iv_loss(ks, ts, ivs, s0, r, 96), ha.RAW0),
        "vasicek": (rc._swaption_loss(
            r, e, torch.full((3,), 0.5, **f32), torch.full((3,), 0.045,
                                                           **f32),
            torch.tensor([4, 8, 8], device=cuda), prices, 8), rc.RAW0),
        "sabr": (sabr._smile_loss(ks[:5], ivs[:5], 100.0, 1.0, 0.7),
                 sabr.SABR_RAW0),
        **{f: (lc._iv_loss(f, ks, ts, ivs, s0, r), lc.FAMILIES[f][2])
           for f in lc.FAMILIES}}
    for name, (loss_fn, raw0) in losses.items():
        seen = []

        def pack(t):
            seen.append(t.device)
            return t

        raw = torch.tensor(raw0, **f32).requires_grad_(True)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = loss_fn(raw)
        (g,) = torch.autograd.grad(loss, raw)
        assert seen and all(d.type == "cuda" for d in seen), (
            name, sorted({str(d) for d in seen}))
        assert g.device.type == "cuda" and torch.isfinite(g).all(), name


@pytest.mark.cuda
@pytest.mark.parametrize("kind,on,key", [
    ("euler", "terminal", "fused_terminal"),
    ("heston", "terminal", "fused_terminal"),
    ("gbm", "mean", "fused_functionals_fixed"),
    ("euler", "mean", "fused_functionals")])
def test_cuda_mlmc_level0_kernel_route_is_the_torch_loop(cuda, kind, on,
                                                         key):
    """MLMC's level 0 in float32 runs the engine's gate (K2 for terminals;
    K4's {avg}, on its fixed fold for GBM) and gives the bits of the
    coupled loop's level 0 on the card's torch loop."""
    from montecarlo_tpu_torch.engine import mlmc
    from montecarlo_tpu_torch.processes import EulerGBM

    n, steps = 3 * 4096 + 5, 16
    make = {"euler": lambda: EulerGBM.create(100.0, 0.05, 0.2, 1 / steps,
                                             device=cuda),
            "gbm": lambda: GBM.create(100.0, 0.05, 0.2, 1 / steps,
                                      device=cuda),
            "heston": lambda: Heston.create(100.0, 0.04, 0.05, 1.5, 0.04,
                                            0.4, -0.6, 1 / steps,
                                            device=cuda)}[kind]
    call = lambda s: torch.clamp(s - 100.0, min=0.0)
    before = PATH_KERNELS[key].launches
    got = mlmc._level0_values(make(), call, n, steps, 9, 2, 4096, on)
    assert PATH_KERNELS[key].launches == before + 1
    want, _ = mlmc._coupled_values(make(), None, call, n, steps, 1, 9, 2,
                                   torch.float32, 4096, on)
    assert got.device.type == "cuda" and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("process", ["gbm", "heston"])
def test_cuda_price_mlmc_matches_the_cpu_run(cuda, process, capsys):
    """``price --mlmc`` on the card samples the CPU run's chunks, so it
    takes the same ladder (every N_l) as ``--device cpu``, which the CPU
    tests hold to the JAX command's; the price and std-err within rtol
    1e-5, the bias and RMSE estimates within 1e-5 absolute (float32
    sums of the finest levels' mean Y, in another order)."""
    import json

    from montecarlo_tpu_torch import cli

    argv = ["price", "--mlmc", "--mlmc-rmse", "0.05", "--process", process]
    runs = []
    for device in ("cuda", "cpu"):
        assert cli.main(argv + ["--device", device]) == 0
        runs.append(json.loads(
            capsys.readouterr().out.strip().splitlines()[-1]))
    got, want = runs
    assert got["level_paths"] == want["level_paths"], (got, want)
    for k in ("price", "std_err", "vs_single_level_cost"):
        assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), (k, got, want)
    for k in ("bias_est", "rmse_est"):
        assert abs(got[k] - want[k]) < 1e-5, (k, got, want)


@pytest.mark.cuda
def test_cuda_price_mlmc_and_gamma_newton(cuda, capsys):
    """``price --mlmc`` on the card near Black-Scholes; the gamma Newton
    sampler on the card within 64 ULPs of the CPU's."""
    import json

    from montecarlo_tpu_torch import cli
    from montecarlo_tpu_torch.rng.gamma import gamma_icdf_boost32

    assert cli.main(["price", "--mlmc", "--mlmc-rmse", "0.05"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert abs(out["price"] - out["black_scholes"]) < 4 * 0.05, out
    g = torch.Generator().manual_seed(3)
    b = 1.0 + torch.rand(1 << 16, generator=g)
    u = torch.rand(1 << 16, generator=g).clamp(1e-6, 1 - 6e-8)
    card = gamma_icdf_boost32(b.to(cuda), u.to(cuda)).cpu()
    host = gamma_icdf_boost32(b, u)
    ulps = (card.view(torch.int32).long() - host.view(torch.int32).long())
    assert int(ulps.abs().max()) <= 64


# --- American and Bermudan exercise (9c) -------------------------------------

def _american_put(device, dtype=torch.float32, steps=16):
    vals = dict(s0=36.0, mu=0.06, sigma=0.2, dt=1.0 / steps)
    return GBM(**{k: torch.tensor(v, dtype=dtype, device=device)
                  for k, v in vals.items()})


def _put40(s):
    return torch.clamp(40.0 - s, min=0.0)


@pytest.mark.cuda
def test_cuda_price_american_brackets_the_binomial(cuda, capsys):
    """``price --american --american-bound`` on the card at 8192 x 50: the
    bracket holds the binomial put (4 std-err, 0.05 below), and no kernel
    launches (the torch loop)."""
    import json

    from montecarlo_tpu_torch import cli
    from montecarlo_tpu_torch.engine.american import binomial_american_put
    from montecarlo_tpu_torch.ops import launch_counts, reset_launch_counts

    reset_launch_counts()
    assert cli.main(["price", "--american", "--american-bound", "--payoff",
                     "put", "--s0", "36", "--strike", "40", "--rate",
                     "0.06", "--paths", "8192", "--steps", "50"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert not any(launch_counts().values())
    tree = binomial_american_put(36.0, 40.0, 0.06, 0.2, 1.0, 1000)
    assert (out["price"] - 4 * out["std_err"] - 0.05 <= tree
            <= out["upper_bound"] + 4 * out["upper_bound_std_err"]), out


@pytest.mark.cuda
def test_cuda_float64_american_and_bermudan_match_the_cpu(cuda):
    from montecarlo_tpu_torch.engine.american import (andersen_broadie_bound,
                                                      lsm_policy)
    from montecarlo_tpu_torch.engine.bermudan import bermudan_swaption_lsm
    from montecarlo_tpu_torch.processes import Vasicek

    f64 = torch.float64
    got = {}
    for dev in (cuda, torch.device("cpu")):
        gbm = _american_put(dev, f64)
        kw = dict(rate=0.06, dt=1.0 / 16, degree=3, dtype=f64)
        res, policy = lsm_policy(gbm, _put40, 4096, 16, seed=4, **kw)
        ab = andersen_broadie_bound(gbm, _put40, policy, 512, 64, 16, seed=5,
                                    **kw)
        vas = Vasicek(**{k: torch.tensor(v, dtype=f64, device=dev)
                         for k, v in dict(r0=0.03, kappa=0.8, theta=0.05,
                                          sigma=0.015, dt=0.25 / 16).items()})
        berm = bermudan_swaption_lsm(vas, 0.0413, n_paths=4096,
                                     steps_per_period=16, n_periods=8,
                                     n_exercise=4, seed=0)
        got[dev.type] = [float(res["price"]), float(ab["upper"]),
                         float(berm["price"])]
    np.testing.assert_allclose(got["cuda"], got["cpu"], rtol=1e-9)


@pytest.mark.cuda
def test_cuda_dual_maxima_bitwise_across_emulated_ranks(cuda):
    """``_ab_best`` over four quarters of the outer ids is the whole run's
    bits (the sharded dual's premise); the one-rank sharded LSM within 4
    std-err of ``lsm_price``."""
    from montecarlo_tpu_torch.engine.american import (_ab_best, lsm_policy,
                                                      lsm_price)
    from montecarlo_tpu_torch.engine.simulate import path_ids_for
    from montecarlo_tpu_torch.parallel import make_mesh, sharded_lsm_price

    gbm = _american_put(cuda)
    kw = dict(rate=0.06, dt=1.0 / 16, degree=3)
    _, policy = lsm_policy(gbm, _put40, 8192, 16, seed=1, **kw)
    ab = dict(seed=2, value_degree=None, dtype=torch.float32, **kw)
    full = _ab_best(gbm, _put40, policy, path_ids_for(1024, 0, cuda), 64,
                    16, **ab)
    parts = torch.cat([_ab_best(gbm, _put40, policy,
                                path_ids_for(256, 256 * k, cuda), 64, 16,
                                **ab) for k in range(4)])
    assert torch.equal(parts, full)
    sharded = sharded_lsm_price(gbm, _put40, 8192, 16, seed=1,
                                mesh=make_mesh(device=cuda), **kw)
    plain = lsm_price(gbm, _put40, 8192, 16, seed=1, **kw)
    assert abs(float(sharded["price"]) - float(plain["price"])) < \
        4 * float(plain["std_err"])


@pytest.mark.cuda
def test_cuda_american_greeks_and_swaption_commands(cuda, capsys):
    """``greeks --american`` on the card: the put's delta within 0.02 of
    the binomial central difference (tests/test_american_greeks.py's gate
    at 2^15 x 50); ``bond --swaption --n-exercise 1`` within rtol 1e-9 of
    the CPU run and 4 std-err of Jamshidian."""
    import json

    from montecarlo_tpu_torch import cli
    from montecarlo_tpu_torch.engine.american import binomial_american_put

    def run(*argv):
        assert cli.main(list(argv)) == 0
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    g = run("greeks", "--american", "--payoff", "put", "--s0", "36",
            "--strike", "40", "--rate", "0.06", "--paths", "32768",
            "--steps", "50")
    fd = (binomial_american_put(36.25, 40.0, 0.06, 0.2, 1.0, 1500)
          - binomial_american_put(35.75, 40.0, 0.06, 0.2, 1.0, 1500)) / 0.5
    assert abs(g["delta"] - fd) < 0.02, (g, fd)
    card = run("bond", "--swaption", "--n-exercise", "1")
    cpu = run("bond", "--swaption", "--n-exercise", "1", "--device", "cpu")
    assert abs(card["bermudan_swaption"] - cpu["bermudan_swaption"]) <= \
        1e-9 * cpu["bermudan_swaption"]
    assert abs(card["bermudan_swaption"] - card["jamshidian_european"]) < \
        4 * card["std_err"]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 16])
def test_cuda_lmm_draws_are_the_per_draw_stream(cuda, k):
    from montecarlo_tpu_torch.processes import LMM, NormalDrawsMixin
    from montecarlo_tpu_torch.rng.threefry import key_from_seed

    m = LMM.create(np.full(k, 0.03), np.full(k, 0.2), 0.25, device=cuda)
    k0, k1 = key_from_seed(5, 1)
    ids = torch.arange(2**32 - 4096, 2**32 + 4096, device=cuda) & 0xFFFFFFFF
    for t in (0, 1, 7):
        for a, b in zip(m.draws(k0, k1, ids, t),
                        NormalDrawsMixin.draws(m, k0, k1, ids, t)):
            assert torch.equal(a, b)


def _item10_models(dev, dtype):
    from montecarlo_tpu_torch.processes import (LMM, EquityVasicekHybrid,
                                                HestonExposure)

    k = 16
    return {
        "lmm": LMM.create(0.03 + 0.004 * np.arange(k) / k,
                          0.22 - 0.06 * np.arange(k) / k, 0.25, shift=0.01,
                          dtype=dtype, device=dev),
        "hybrid": EquityVasicekHybrid.create(100.0, 0.03, 0.6, 0.05, 0.015,
                                             0.22, -0.35, 0.125, dtype=dtype,
                                             device=dev),
        "heston_exposure": HestonExposure.create(
            100.0, 0.05, 0.02, 1.5, 0.04, 0.6, -0.7, 1 / 32, dtype=dtype,
            device=dev)}


#: Absolute slack of the float32 states that cross or touch 0, twice the
#: largest difference measured on an H100 (8192 paths x 17 steps): the
#: card's and the CPU's ``log``/``cos``/``sin`` in Box-Muller differ by
#: ~1 ULP a normal, which stays within 1.7e-6 relative in every other
#: state, but is large against a state near 0 and grows through
#: ``sqrt(v+)`` there.  The hybrid's short rate r (1.5e-8 measured), Heston
#: exposure's variance v (7.3e-7) and its accrual of v (7.3e-8).
ITEM10_ATOL32 = {("hybrid", 1): 3e-8, ("heston_exposure", 1): 1.5e-6,
                 ("heston_exposure", 2): 1.5e-7}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_lmm_hybrid_heston_exposure_match_the_cpu(cuda, dtype,
                                                       capsys):
    """Paths on the card against the CPU: float64 within rtol 1e-12 +
    1e-15 (2.3e-14 relative and 1.1e-15 absolute measured), float32
    within rtol 1e-5 and ``ITEM10_ATOL32`` (1.7e-6 relative measured
    away from 0)."""
    got = {}
    for dev in (cuda, torch.device("cpu")):
        for name, m in _item10_models(dev, dtype).items():
            got[(name, dev.type)] = simulate(
                m, 8192, 17, seed=3, mode="paths", dtype=dtype,
                observe=lambda p, s: p.exposure_obs(s)).cpu().numpy()
    for name in ("lmm", "hybrid", "heston_exposure"):
        card, cpu = got[(name, "cuda")], got[(name, "cpu")]
        assert np.isfinite(card).all()
        diff = np.abs(card - cpu)
        worst = {}
        for c in range(cpu.shape[-1]):
            rel = diff[..., c] / np.maximum(np.abs(cpu[..., c]), 1e-30)
            at = np.unravel_index(np.argmax(rel), rel.shape)
            worst[c] = (float(diff[..., c].max()), float(rel.max()),
                        float(cpu[..., c][at]))
        with capsys.disabled():
            print(f"\n{name} {dtype}: state -> (max abs diff, max rel "
                  f"diff, cpu value at the max rel): {worst}")
        for c in range(cpu.shape[-1]):
            rtol, atol = ((1e-12, 1e-15) if dtype == torch.float64 else
                          (1e-5, ITEM10_ATOL32.get((name, c), 0.0)))
            assert (diff[..., c] <= rtol * np.abs(cpu[..., c])
                    + atol).all(), (name, c, worst[c])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gbm", "heston"])
def test_cuda_stress_grid_kernel_route_is_its_torch_loop(cuda, kind):
    from montecarlo_tpu_torch.api import ladder, stress_grid
    from montecarlo_tpu_torch.ops import launch_counts, reset_launch_counts

    if kind == "gbm":
        proc, fields = GBM.create(100.0, 0.03, 0.2, 1 / 16,
                                  device=cuda), ("s0", "sigma")
    else:
        proc, fields = Heston.create(100.0, 0.04, 0.03, 2.0, 0.04, 0.5, -0.7,
                                     1 / 16, device=cuda), ("s0", "v0")
    kw = dict(bumps_a=ladder(-0.2, 0.2, 5), bumps_b=ladder(-0.5, 0.5, 5),
              seed=2, fields=fields, discount=0.97)
    call = lambda s: torch.clamp(s - 105.0, min=0.0)
    reset_launch_counts()
    fused = stress_grid(proc, call, 1 << 14, 16, **kw)
    assert launch_counts()["fused_terminal"] == 25
    reset_launch_counts()
    loop = stress_grid(proc, call, 1 << 14, 16, prefer_fused=False, **kw)
    assert launch_counts()["fused_terminal"] == 0
    np.testing.assert_array_equal(fused["prices"], loop["prices"])
    assert fused["pnl"][2, 2] == 0.0


@pytest.mark.cuda
def test_cuda_item10_commands_match_the_cpu(cuda, capsys):
    """``stress`` (34 K2 launches), ``bond --model lmm`` (``--caplet``,
    the Bermudan), ``calibrate --model lmm`` and ``price --process
    hybrid`` on the card against ``--device cpu``: the same keys, values
    within rtol 1e-5 plus the JSON's rounding (stress: 1e-6 on the grid
    plus a price's float32 ULP, 2e-6, 2.1e-6 measured on an H100 where
    rtol adds to it; the LMM's 1e-8), the host closed forms equal.  The
    Bermudan's float32 regressions sum in each device's order, so an
    exercise decision may flip on a path that straddles them: 2e-7, twice
    the 1.0e-7 measured.
    """
    import json

    from montecarlo_tpu_torch import cli
    from montecarlo_tpu_torch.ops import launch_counts, reset_launch_counts

    def run(*argv):
        assert cli.main(list(argv)) == 0
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    def flat(out, prefix=""):
        rows = {}
        for k, v in out.items():
            if isinstance(v, dict):
                rows.update(flat(v, f"{prefix}{k}."))
            elif isinstance(v, list):
                rows[prefix + k] = np.asarray(v, dtype=float)
            elif not isinstance(v, str):
                rows[prefix + k] = v
        return rows

    for argv, atol in [
            (("stress", "--paths", "16384", "--steps", "16"), 2e-6),
            (("stress", "--process", "heston", "--paths", "16384",
              "--steps", "16"), 2e-6),
            (("bond", "--model", "lmm", "--paths", "16384"), 1e-8),
            (("bond", "--model", "lmm", "--caplet", "--paths", "16384"),
             1e-8),
            (("bond", "--model", "lmm", "--swaption", "--maturity", "3.0",
              "--n-exercise", "4", "--paths", "16384"), 1e-8),
            (("calibrate", "--model", "lmm"), 0.0),
            (("price", "--process", "hybrid", "--paths", "16384", "--steps",
              "16"), 0.0)]:
        reset_launch_counts()
        card = run(*argv)
        k2 = launch_counts()["fused_terminal"]
        assert k2 == (34 if argv[0] == "stress" else 0), (argv, k2)
        cpu = run(*argv, "--device", "cpu")
        a, b = flat(card), flat(cpu)
        assert sorted(a) == sorted(b), argv
        with capsys.disabled():
            print("\n", argv, {k: float(np.max(np.abs(
                np.asarray(a[k], float) - np.asarray(b[k], float))))
                for k in b})
        for k in b:
            tol = 2e-7 if k == "bermudan_price" else atol
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=tol,
                                       err_msg=f"{argv} {k}")


@pytest.mark.cuda
def test_cuda_item10_modules_import_no_jax(cuda):
    import subprocess
    import sys

    code = ("import sys\n"
            "import montecarlo_tpu_torch.processes.lmm, "
            "montecarlo_tpu_torch.processes.hybrid, "
            "montecarlo_tpu_torch.processes.heston_exposure, "
            "montecarlo_tpu_torch.api.stress, "
            "montecarlo_tpu_torch.engine.rates_calibration, "
            "montecarlo_tpu_torch.engine.bermudan, "
            "montecarlo_tpu_torch.cli.risk\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'montecarlo_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"
