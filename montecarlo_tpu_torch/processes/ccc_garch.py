"""CCC-GARCH portfolio process: per-asset GARCH(1,1) variances with a
constant conditional correlation (Bollerslev 1990):

    zc   = L z                       (the unrolled Cholesky, left to right)
    r_a  = sqrt(var_a) zc_a,         log S_a += r_a
    var_a' = (omega_a + alpha_a r_a^2) + beta_a var_a

The port of ``montecarlo_tpu/processes/ccc_garch.py``: the state is the
pair of tuples ``(log_s, var)`` of (n,) tensors, and ``prices`` the
weighted portfolio value ``sum_a w_a exp32(log S_a)``, so portfolio VaR
for a GARCH book runs through ``api.var`` as any process does.

K2, K3 and K4 run it as ``StateProc<mc::CccStep<A>, A>``
(``csrc/fused_ccc.cu`` over ``csrc/mgarch_steps.cuh``) for ``A <=
ops.fused_engine.MAX_STATE_ASSETS``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from montecarlo_tpu_torch.device import resolve_device
from montecarlo_tpu_torch.processes.base import NormalDrawsMixin
from montecarlo_tpu_torch.processes.basket import basket_value, correlate
from montecarlo_tpu_torch.rng.normal import log32


def garch_update(omega, alpha, beta, var, r):
    """``(omega + alpha r^2) + beta var``: one asset's GARCH(1,1) step."""
    return omega + alpha * torch.square(r) + beta * var


class StateMixin(NormalDrawsMixin):
    """The start and the portfolio value shared by CCC and DCC: log prices
    from ``log32(s0)``, variances from ``var0``."""

    @property
    def n_assets(self) -> int:
        return self.s0.shape[0]

    @property
    def n_draws(self) -> int:
        return self.n_assets

    def _start(self, path_ids):
        shape = path_ids.shape
        log_s0 = log32(self.s0)
        log_s = tuple(log_s0[a].expand(shape).clone()
                      for a in range(self.n_assets))
        var = tuple(self.var0[a].expand(shape).clone()
                    for a in range(self.n_assets))
        return log_s, var

    def prices(self, state):
        """The portfolio value ``sum_a w_a exp32(log S_a)``."""
        return basket_value(self.weights, state[0])


@dataclass(frozen=True)
class CCCGarch(StateMixin):
    """Fields in the JAX NamedTuple's order, float32 on the process's
    device."""

    s0: torch.Tensor         # (A,)
    var0: torch.Tensor       # (A,) initial daily variances
    omega: torch.Tensor      # (A,)
    alpha: torch.Tensor      # (A,)
    beta: torch.Tensor       # (A,)
    chol_flat: torch.Tensor  # (A*A,) lower-triangular correlation factor
    weights: torch.Tensor    # (A,) portfolio weights

    @classmethod
    def create(cls, s0, var0, omega, alpha, beta, corr, weights,
               device="cuda") -> "CCCGarch":
        dev = resolve_device(device)
        chol = np.linalg.cholesky(np.asarray(corr, np.float64))
        as_ = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=dev)
        return cls(s0=as_(s0), var0=as_(var0), omega=as_(omega),
                   alpha=as_(alpha), beta=as_(beta),
                   chol_flat=as_(chol.reshape(-1)), weights=as_(weights))

    def init_state(self, path_ids):
        return self._start(path_ids)

    def step(self, state, eps, t):
        log_s, var = state
        a_n = self.n_assets
        new_log_s, new_var = [], []
        for a in range(a_n):
            r = torch.sqrt(var[a]) * correlate(self.chol_flat, eps, a, a_n)
            new_log_s.append(log_s[a] + r)
            new_var.append(garch_update(self.omega[a], self.alpha[a],
                                        self.beta[a], var[a], r))
        return (tuple(new_log_s), tuple(new_var))
