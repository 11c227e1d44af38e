"""The CUDA kernels K0-K3 against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA GPU and
skips without one.  The file imports no JAX (the card's machine has none);
run it there from the repo root with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Kernel and plain version run the same float32 operations in the same order
(nvcc -fmad=false, no fast math; K3 sums rows in tree_sum's order), so they
must agree bitwise; Box-Muller and log32 go through the card's libm on both
sides and are held to 1e-6 absolute in case the two builds differ.
"""

import numpy as np
import pytest
import torch

from montecarlo_tpu_torch.engine import VanillaPayoff
from montecarlo_tpu_torch.ops import (PATH_KERNELS, fused_block_moments,
                                      fused_block_moments_reference,
                                      fused_terminal, fused_terminal_reference,
                                      gbm_terminal, gbm_terminal_reference)
from montecarlo_tpu_torch.processes import GBM


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
