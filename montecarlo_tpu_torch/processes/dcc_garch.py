"""DCC-GARCH portfolio process: per-asset GARCH(1,1) variances with
*dynamic* conditional correlations (Engle 2002):

    Q_{t+1} = ((1 - a) - b) Qbar + a eta_t eta_t' + b Q_t
    R_t     = diag(Q_t)^{-1/2} Q_t diag(Q_t)^{-1/2}

The port of ``montecarlo_tpu/processes/dcc_garch.py``.  Every path carries
its own Q (its lower triangle, row-major pairs i >= j), so each step
factorizes it by the unrolled Cholesky (``chol_unrolled``: ``sqrt(max(s,
1e-12))`` on the diagonal, an IEEE division off it) and scales row i by
``1 / sqrt(max(q_ii, 1e-12))``, the Cholesky factor of R; then CCC's
update on the correlated shocks eta, and the DCC recursion on the A(A+1)/2
words of Q.  The state is ``(log_s, var, q)``, tuples of (n,) tensors.

The JAX step scales by ``lax.rsqrt``, which has no IEEE-defined value; the
port divides 1 by the IEEE root, which the kernel computes the same way,
so the kernel is bitwise its plain version and the port is within a few
ULPs of JAX (tests/test_torch_mgarch.py).  ``max`` propagates NaN, as
``jnp.maximum`` does.

K2, K3 and K4 run it as ``StateProc<mc::DccStep<A>, A>``
(``csrc/fused_dcc.cu``, K4 in ``fused_dcc_k4.cu``, over
``csrc/mgarch_steps.cuh``) for ``A <= ops.fused_engine.MAX_STATE_ASSETS``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from montecarlo_tpu_torch.device import resolve_device
from montecarlo_tpu_torch.processes.ccc_garch import StateMixin, garch_update

#: The floor of Q's diagonal and of the Cholesky's pivots.
EPS = 1e-12


def _floor(x: torch.Tensor) -> torch.Tensor:
    """``max(x, EPS)``, NaN kept (``torch.maximum``, as ``jnp.maximum``)."""
    return torch.maximum(x, x.new_tensor(EPS))


def chol_unrolled(r, a_n: int):
    """Lower-triangular ``l[i][j]`` of symmetric matrices given as nested
    lists of tensors ``r[i][j]`` (i >= j), elementwise: the JAX package's
    ``_chol_unrolled``, each pivot's sum taken over k = 0 .. j-1 in order."""
    l = [[None] * (i + 1) for i in range(a_n)]
    for i in range(a_n):
        for j in range(i + 1):
            s = r[i][j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            l[i][j] = torch.sqrt(_floor(s)) if j == i else s / l[j][j]
    return l


@dataclass(frozen=True)
class DCCGarch(StateMixin):
    """Fields in the JAX NamedTuple's order, float32 on the process's
    device."""

    s0: torch.Tensor         # (A,)
    var0: torch.Tensor       # (A,) initial daily variances
    omega: torch.Tensor      # (A,)
    alpha: torch.Tensor      # (A,)
    beta: torch.Tensor       # (A,)
    qbar_flat: torch.Tensor  # (A*A,) unconditional correlation
    a_dcc: torch.Tensor      # shock loading
    b_dcc: torch.Tensor      # persistence
    weights: torch.Tensor    # (A,)

    @classmethod
    def create(cls, s0, var0, omega, alpha, beta, qbar, weights,
               a_dcc=0.03, b_dcc=0.95, device="cuda") -> "DCCGarch":
        qbar = np.array(qbar, np.float64)  # copy: the diagonal is snapped
        if (not np.allclose(qbar, qbar.T)
                or not np.allclose(np.diag(qbar), 1.0)):
            # Tolerance on the diagonal too: np.corrcoef output carries
            # 1 +/- 1ulp diagonals, which exact equality would reject.
            raise ValueError("qbar must be a correlation matrix")
        qbar[np.arange(len(qbar)), np.arange(len(qbar))] = 1.0
        if float(a_dcc) + float(b_dcc) >= 1.0:
            raise ValueError("need a_dcc + b_dcc < 1 for stationarity")
        dev = resolve_device(device)
        as_ = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=dev)
        return cls(s0=as_(s0), var0=as_(var0), omega=as_(omega),
                   alpha=as_(alpha), beta=as_(beta),
                   qbar_flat=as_(qbar.reshape(-1)), a_dcc=as_(a_dcc),
                   b_dcc=as_(b_dcc), weights=as_(weights))

    def init_state(self, path_ids):
        a_n = self.n_assets
        log_s, var = self._start(path_ids)
        q = tuple(self.qbar_flat[i * a_n + j].expand(path_ids.shape).clone()
                  for i in range(a_n) for j in range(i + 1))
        return (log_s, var, q)

    def _q_lists(self, q):
        """The flat lower-triangle tuple as nested [i][j] lists."""
        out, k = [], 0
        for i in range(self.n_assets):
            out.append(list(q[k:k + i + 1]))
            k += i + 1
        return out

    def step(self, state, eps, t):
        log_s, var, q = state
        a_n = self.n_assets
        ql = self._q_lists(q)
        # chol(R_t) without forming R_t: chol(Q) row-scaled by
        # 1 / sqrt(q_ii) (see the JAX step).
        dinv = [1.0 / torch.sqrt(_floor(ql[i][i])) for i in range(a_n)]
        cq = chol_unrolled(ql, a_n)
        chol = [[cq[i][j] * dinv[i] for j in range(i + 1)]
                for i in range(a_n)]
        eta, new_log_s, new_var = [], [], []
        for a in range(a_n):
            zc = chol[a][0] * eps[0]
            for b in range(1, a + 1):
                zc = zc + chol[a][b] * eps[b]
            eta.append(zc)
            ret = torch.sqrt(var[a]) * zc
            new_log_s.append(log_s[a] + ret)
            new_var.append(garch_update(self.omega[a], self.alpha[a],
                                        self.beta[a], var[a], ret))
        # The DCC recursion on the lower triangle.
        c_d = (1.0 - self.a_dcc) - self.b_dcc
        new_q = tuple(
            c_d * self.qbar_flat[i * a_n + j] + self.a_dcc * eta[i] * eta[j]
            + self.b_dcc * ql[i][j]
            for i in range(a_n) for j in range(i + 1))
        return (tuple(new_log_s), tuple(new_var), new_q)
