"""Correlated GBM basket with one state tensor per asset (the form the
fused kernels run):

    zc_a = L[a,0] z_0 + L[a,1] z_1 + ... + L[a,a] z_a     (left to right)
    log S_a += (mu_a - sigma_a^2/2) dt + sigma_a sqrt(dt) zc_a

The port of ``montecarlo_tpu/processes/basket.py``: a tuple of (n,) log
prices, the Cholesky factor unrolled left to right in float32 with the
grouped increment, and ``prices`` the basket value ``sum_a w_a
exp32(log S_a)`` summed over the assets in order.  The draws follow
``NormalDrawsMixin``'s ``t * A + d`` convention, so a basket and a
``MultiGBM`` of the same parameters see the same normals.  It has no
``log_prices``: log-space functionals observe ``log32(prices)``.

K2, K3 and K4 run it as ``BasketProc`` (``csrc/fused_engine.cu``) for
``A <= MAX_ASSETS``, as K7 (``ops/basket_kernel.py``) runs its packed form.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from montecarlo_tpu_torch.device import resolve_device
from montecarlo_tpu_torch.processes.base import NormalDrawsMixin
from montecarlo_tpu_torch.rng.normal import exp32, log32

#: The most assets a basket kernel takes (the TPU kernel's 128 lanes); the
#: CUDA sources hold the same number as ``kMaxAssets`` (K7) and
#: ``kBasketMax`` (BasketProc's larger capacity).
MAX_ASSETS = 128


def kernel_assets_refusal(n_assets: int) -> ValueError | None:
    """The ``ValueError`` for an asset count outside ``1 <= n_assets <=
    MAX_ASSETS``, the basket kernels' limit (which their plain versions
    keep too); None inside it."""
    if 1 <= n_assets <= MAX_ASSETS:
        return None
    return ValueError(f"the basket kernels take 1 to at most {MAX_ASSETS}"
                      f" assets, got {n_assets}")


def correlate(chol_flat: torch.Tensor, eps, a: int, a_n: int):
    """``zc_a = L[a,0] z_0 + ... + L[a,a] z_a`` from the row-major factor,
    left to right, the first term a product (the correlated draws of the
    basket, the term basket and the GARCH books)."""
    zc = chol_flat[a * a_n] * eps[0]
    for b in range(1, a + 1):
        zc = zc + chol_flat[a * a_n + b] * eps[b]
    return zc


def basket_value(weights: torch.Tensor, log_s):
    """``sum_a w_a exp32(log S_a)``, the assets in order."""
    out = weights[0] * exp32(log_s[0])
    for a in range(1, len(log_s)):
        out = out + weights[a] * exp32(log_s[a])
    return out


def check_kernel_assets(n_assets: int) -> None:
    """Raise :func:`kernel_assets_refusal`'s error, if there is one."""
    err = kernel_assets_refusal(n_assets)
    if err is not None:
        raise err


@dataclass(frozen=True)
class BasketGBM(NormalDrawsMixin):
    """Fields in the JAX NamedTuple's order, float32 on the process's
    device."""

    s0: torch.Tensor         # (A,)
    mu: torch.Tensor         # (A,)
    sigma: torch.Tensor      # (A,)
    chol_flat: torch.Tensor  # (A*A,) row-major lower-triangular
    weights: torch.Tensor    # (A,)
    dt: torch.Tensor

    @classmethod
    def create(cls, s0, mu, sigma, corr, weights, dt,
               device="cuda") -> "BasketGBM":
        dev = resolve_device(device)
        chol = np.linalg.cholesky(np.asarray(corr, np.float64))
        as_ = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=dev)
        return cls(s0=as_(s0), mu=as_(mu), sigma=as_(sigma),
                   chol_flat=as_(chol.reshape(-1)), weights=as_(weights),
                   dt=as_(dt))

    @property
    def n_assets(self) -> int:
        return self.s0.shape[0]

    @property
    def n_draws(self) -> int:
        return self.n_assets

    def drift_scale(self):
        """Per-asset (drift, scale) of one step, float32, (A,) each."""
        drift = (self.mu - 0.5 * torch.square(self.sigma)) * self.dt
        scale = self.sigma * torch.sqrt(self.dt)
        return drift, scale

    def init_state(self, path_ids):
        log_s0 = log32(self.s0)
        return tuple(log_s0[a].expand(path_ids.shape).clone()
                     for a in range(self.n_assets))

    def step(self, state, eps, t):
        a_n = self.n_assets
        drift, scale = self.drift_scale()
        return tuple(
            state[a] + (drift[a] + scale[a] * correlate(self.chol_flat, eps,
                                                        a, a_n))
            for a in range(a_n))

    def prices(self, state):
        """The basket value ``sum_a w_a exp32(log S_a)``, assets in order."""
        return basket_value(self.weights, state)
