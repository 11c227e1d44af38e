"""Correlated GBM basket with per-asset term structures:

    zc_a = L[a,0] z_0 + L[a,1] z_1 + ... + L[a,a] z_a     (left to right)
    log S_a += (mu_a(t) - sigma_a(t)^2/2) dt + sigma_a(t) sqrt(dt) zc_a

The port of ``montecarlo_tpu/processes/term_basket.py``: each asset
carries its own per-step drift and vol curve, one row of ``mu_t`` and
``sigma_t`` an asset, stored as given, one entry a step (the JAX package
pads them to a multiple of 128 for Mosaic's layout, which is not ported; a
JAX process's padded curves come across as they are).  A step past the
curves' end raises ``ValueError`` (``max_steps``).  The state is a tuple of
(n,) log prices, the increment grouped before the add, and ``prices`` the
basket value ``sum_a w_a exp32(log S_a)`` summed over the assets in order;
there is no ``log_prices``.

K2, K3 and K4 run it as ``StateProc<mc::TermBasketStep<A>, A>``
(``csrc/fused_term_basket{,_k4}.cu`` over ``csrc/mgarch_steps.cuh``) for ``A <=
ops.fused_engine.MAX_STATE_ASSETS``, the curves read at the step index.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from montecarlo_tpu_torch.device import resolve_device
from montecarlo_tpu_torch.processes.base import NormalDrawsMixin, curve_at
from montecarlo_tpu_torch.processes.basket import basket_value, correlate
from montecarlo_tpu_torch.rng.normal import log32


@dataclass(frozen=True)
class TermBasketGBM(NormalDrawsMixin):
    """Fields in the JAX NamedTuple's order, float32 on the process's
    device: ``mu_t`` and ``sigma_t`` are (A, n), one curve an asset."""

    s0: torch.Tensor         # (A,)
    mu_t: torch.Tensor       # (A, n) per-step drift curves
    sigma_t: torch.Tensor    # (A, n) per-step vol curves
    chol_flat: torch.Tensor  # (A*A,) row-major lower-triangular
    weights: torch.Tensor    # (A,)
    dt: torch.Tensor

    @classmethod
    def create(cls, s0, mu_curves, sigma_curves, corr, weights, dt,
               device="cuda") -> "TermBasketGBM":
        mu_curves = np.atleast_2d(np.asarray(mu_curves, np.float64))
        sigma_curves = np.atleast_2d(np.asarray(sigma_curves, np.float64))
        if mu_curves.shape != sigma_curves.shape:
            raise ValueError("mu and sigma curves must share a shape")
        a_n = mu_curves.shape[0]
        if len(np.asarray(s0).shape) != 1 or np.asarray(s0).size != a_n:
            raise ValueError("s0 must be (A,) matching the curve rows")
        if mu_curves.shape[1] < 1:
            raise ValueError("the curves need at least one step")
        dev = resolve_device(device)
        chol = np.linalg.cholesky(np.asarray(corr, np.float64))
        as_ = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=dev)
        return cls(s0=as_(s0), mu_t=as_(mu_curves), sigma_t=as_(sigma_curves),
                   chol_flat=as_(chol.reshape(-1)), weights=as_(weights),
                   dt=as_(dt))

    @property
    def n_assets(self) -> int:
        return self.s0.shape[0]

    @property
    def n_draws(self) -> int:
        return self.n_assets

    @property
    def max_steps(self) -> int:
        return self.mu_t.shape[-1]

    def init_state(self, path_ids):
        log_s0 = log32(self.s0)
        return tuple(log_s0[a].expand(path_ids.shape).clone()
                     for a in range(self.n_assets))

    def step(self, state, eps, t):
        a_n = self.n_assets
        mu = curve_at(self.mu_t, t)
        sigma = curve_at(self.sigma_t, t)
        drift = (mu - 0.5 * torch.square(sigma)) * self.dt
        scale = sigma * torch.sqrt(self.dt)
        # Increment grouped before the add (see GBM.step).
        return tuple(
            state[a] + (drift[a] + scale[a] * correlate(self.chol_flat, eps,
                                                        a, a_n))
            for a in range(a_n))

    def prices(self, state):
        """The basket value ``sum_a w_a exp32(log S_a)``, assets in order."""
        return basket_value(self.weights, state)
