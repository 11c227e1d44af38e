"""GARCH(1,1) bootstrap process — the reference application's recurrence
(reference app.py:586-633):

    shock_t ~ resample(standardized historical returns)
    r_t      = shock_t * sqrt(var_t)
    S_{t+1}  = S_t * exp(r_t)
    var_{t+1}= omega + alpha * r_t^2 + beta * var_t

with omega = 1e-5, alpha = 0.10, beta = 0.85 and the initial daily variance
rvol_20[-1]^2 / 252.

The port of ``montecarlo_tpu/processes/garch.py``.  The draw is the raw
UNIFORM of each step (component ``t & 1`` of cipher call ``t >> 1``); the
step maps it to a table index with ``index_from_uniform`` and reads the
shock there, so the antithetic mirror ``u -> 1 - u`` acts before the
resampling and both halves of a pair stay exact bootstrap draws.  The
table holds exactly ``n_table`` sorted standardized returns: the JAX
package pads it to a multiple of 128 for the TPU's lane gather, which a
direct ``table[idx]`` does not need.  Prices evolve in log space, in the
JAX package's float32 order.

K2, K3 and K4 run it as ``GarchProc`` (``csrc/fused_engine.cu``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, NamedTuple

import numpy as np
import torch

from montecarlo_tpu_torch.device import resolve_device
from montecarlo_tpu_torch.rng.normal import (exp32, index_from_uniform,
                                             log32, uniform_draw,
                                             uniform_pair)
from montecarlo_tpu_torch.rng.threefry import MASK32

#: Reference GARCH parameters (app.py:601-603).
DEFAULT_OMEGA = 1e-5
DEFAULT_ALPHA = 0.10
DEFAULT_BETA = 0.85

#: Minimum history the reference requires before simulating (app.py:594).
MIN_HISTORY = 100


class GARCHState(NamedTuple):
    log_s: torch.Tensor  # (n_paths,)
    var: torch.Tensor    # (n_paths,) current daily variance


@dataclass(frozen=True)
class GARCHBootstrap:
    """Bootstrap GARCH(1,1) with a device-resident shock table.  Fields in
    the JAX NamedTuple's order: 0-d float32 parameters, ``table`` (n_table,)
    float32 sorted ascending and ``n_table`` a 0-d int32 equal to
    ``table.numel()``, all on one device."""

    s0: torch.Tensor
    var0: torch.Tensor
    omega: torch.Tensor
    alpha: torch.Tensor
    beta: torch.Tensor
    table: torch.Tensor
    n_table: torch.Tensor

    n_draws: ClassVar[int] = 1
    #: The draw is a uniform: ``SobolSampler.for_process`` keeps it raw.
    draw_kinds: ClassVar[tuple] = ("uniform",)

    def __post_init__(self):
        if self.table.dim() != 1 or int(self.n_table) != self.table.numel():
            raise ValueError(f"table {tuple(self.table.shape)} must hold "
                             f"exactly n_table={int(self.n_table)} entries")

    @classmethod
    def create(cls, returns, s0, var0, omega=DEFAULT_OMEGA,
               alpha=DEFAULT_ALPHA, beta=DEFAULT_BETA,
               device="cuda") -> "GARCHBootstrap":
        """Build from a history of log returns, standardized as the
        reference does (``returns / (std(returns) + 1e-10)``, app.py:609)
        in float64 and sorted ascending, so the uniform -> shock map is
        monotone and the mirror u -> 1 - u pairs low shocks with high
        ones."""
        dev = resolve_device(device)
        returns = np.asarray(returns, np.float64)
        n = int(returns.size)
        if n < MIN_HISTORY:
            raise ValueError(
                f"need >= {MIN_HISTORY} return observations, got {n}")
        table = np.sort(returns / (returns.std() + 1e-10))
        as_ = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
        return cls(s0=as_(s0), var0=as_(var0), omega=as_(omega),
                   alpha=as_(alpha), beta=as_(beta), table=as_(table),
                   n_table=torch.tensor(n, dtype=torch.int32, device=dev))

    @staticmethod
    def numpy_fields(fields: dict) -> dict:
        """JAX's leaves with the padded table cut to its ``n_table`` valid
        entries (``convert.process_from_numpy``)."""
        out = dict(fields)
        n = int(np.asarray(fields["n_table"]))
        out["table"] = np.asarray(fields["table"])[:n]
        out["n_table"] = np.asarray(n, np.int32)
        return out

    @property
    def device(self) -> torch.device:
        return self.s0.device

    def init_state(self, path_ids) -> GARCHState:
        shape = path_ids.shape
        return GARCHState(log_s=log32(self.s0).expand(shape).clone(),
                          var=self.var0.expand(shape).clone())

    def draws(self, seed, stream, path_ids, t, dtype=torch.float32):
        """The raw uniform of step ``t`` (draw index m = t), drawn in
        float32 and cast to ``dtype`` as the JAX package does."""
        return (uniform_draw(seed, stream, path_ids,
                             int(t) & MASK32).to(dtype),)

    def draws_pair(self, seed, stream, path_ids, j):
        """The uniforms of steps (2j, 2j+1): both halves of cipher call
        ``j``, bitwise equal to :meth:`draws` at t = 2j and 2j+1."""
        u0, u1 = uniform_pair(seed, stream, path_ids, int(j) & MASK32)
        return (u0,), (u1,)

    def antithetic(self, eps):
        """Mirror the uniform, u -> 1 - u (exact in float32 for the
        uniforms of ``uniform_from_bits``); never a negation, which would
        index below the table."""
        return tuple(1.0 - e for e in eps)

    def _shock(self, u: torch.Tensor) -> torch.Tensor:
        if not bool(((u > 0) & (u < 1)).all()):
            raise ValueError("GARCH bootstrap draws are uniforms in (0, 1); "
                             "a sampler passed values outside it")
        return self.table[index_from_uniform(u, self.table.numel())]

    def step(self, state: GARCHState, eps, t) -> GARCHState:
        r = self._shock(eps[0]) * torch.sqrt(state.var)
        new_var = (self.omega + self.alpha * (r * r)) + self.beta * state.var
        return GARCHState(log_s=state.log_s + r, var=new_var)

    def prices(self, state: GARCHState):
        return exp32(state.log_s)

    def log_prices(self, state: GARCHState):
        """Native log prices: log-space path functionals fold these."""
        return state.log_s
