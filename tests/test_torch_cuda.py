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
2^30, the bridge's scratch in its global workspace.  The jump, Levy, QE
and SABR functors (Merton, Kou, Bates, NIG, HestonQE, BatesQE, VG, SABR:
their draws_pair layouts, second key streams, per-draw mirror, Poisson
select chains, ndtri32 and the gamma table) equal their plain versions and
the torch loop bitwise on K2-K4, SABR under Sobol draws too, and the
device build of the gamma-table inversion equals its plain version.  So
do the local-vol surfaces (LocalVolProc on the CEV and a time-dependent
surface, SlvProc's exact rows read through a pointer and an offset, its
clamp past the last row, SlvKnotsProc) under every draw source each
takes; two calibrations at one seed give the same leverage bits.
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
@pytest.mark.parametrize("n_paths", [1000, 4096 * 3])
@pytest.mark.parametrize("n_steps", [1, 16, 17])
def test_cuda_k6_bitwise_equal_plain(cuda, n_paths, n_steps):
    model = _rbergomi(n_steps, cuda)
    z = normal_matrix(5, 1, n_paths, 2 * n_steps, path_offset=WRAP,
                      device=cuda)
    args = (factor_product(model.chol, z), model.tpow(),
            model.kernel_params(), 5, 1)
    kw = dict(n_steps=n_steps, path_offset=WRAP)
    k6 = PATH_KERNELS["rbergomi_terminal"].launches
    got = rbergomi_terminal(*args, **kw)
    assert PATH_KERNELS["rbergomi_terminal"].launches == k6 + 1
    want = rbergomi_terminal_reference(*args, **kw)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


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
@pytest.mark.parametrize("a_n", [1, 5, 16, 20, 128])
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
@pytest.mark.parametrize("a_n", [3, 5, 16, 17])
@pytest.mark.parametrize("antithetic", [False, True])
def test_cuda_basket_k2_k3_k4_bitwise_equal_plain(cuda, a_n, antithetic):
    """BasketProc at 16 (registers) and 128 (local memory) capacity, odd
    and even asset counts, against the plain versions and the torch loop."""
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
    if kind == "basket":
        return bench_basket(5, device=device)
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
@pytest.mark.parametrize("kind", ["gbm", "heston", "basket"])
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
@pytest.mark.parametrize("n_steps,built_for", [(8, 8), (9, 9), (17, 17),
                                               (9, 12)])
def test_cuda_bridge_k2_k3_k4_bitwise_equal_plain(cuda, n_steps, built_for):
    """BridgeDraws in K2, K3 and K4 on a plan built for the run's steps or
    more, against
    the plain versions and the torch loop (the Device sampler's per-step
    sums); each launch raises its bridge counter."""
    from montecarlo_tpu_torch.rng.sobol import SobolBridgeKernelSampler

    tp = _process("gbm", n_steps, cuda)
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
def test_cuda_bridge_workspace_launches_in_chunks(cuda, monkeypatch):
    """On the bridge's workspace the wrappers launch at most
    BRIDGE_WORKSPACE_PATHS paths at a time (each launch counted), and the
    pieces equal one plain run: K2 and K4 on a ragged count, K3 on whole
    rows."""
    from montecarlo_tpu_torch.ops import fused_engine
    from montecarlo_tpu_torch.rng.sobol import SobolBridgeKernelSampler

    monkeypatch.setattr(fused_engine, "BRIDGE_WORKSPACE_PATHS", 1024)
    tp = _process("gbm", 17, cuda)
    smp = SobolBridgeKernelSampler.create(17, device=cuda)
    kw = dict(seed=3, path_offset=WRAP, sampler=smp)
    k2 = PATH_KERNELS["fused_terminal_bridge"].launches
    got = fused_terminal(tp, 3000, 17, **kw)
    assert PATH_KERNELS["fused_terminal_bridge"].launches == k2 + 3
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
@pytest.mark.parametrize("kind,source", SURFACE_CASES)
def test_cuda_surface_processes_k2_k3_k4_bitwise_equal_plain(cuda, kind,
                                                             source):
    """LocalVolProc, SlvProc (the KernelRows read) and SlvKnotsProc against
    their plain versions and the torch loop on the card under each draw
    source they take; SLV also at more steps than it has rows (the
    clamp)."""
    from montecarlo_tpu_torch.rng.sobol import (SobolBridgeKernelSampler,
                                                SobolDeviceSampler)

    procs = _surface_procs(17, cuda)
    tp = procs[kind]
    pay = VanillaPayoff("call", 100.0)
    fns = {"avg": ARITH_MEAN, "geo": GEO_MEAN, "mx": RUNNING_MAX,
           "mn": RUNNING_MIN}
    n = 4096 * 3
    for n_steps in ((17, 23) if kind == "slv" else (17,)):
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
