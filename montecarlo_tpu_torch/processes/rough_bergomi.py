"""Rough Bergomi (Bayer-Friz-Gatheral 2016) by exact-covariance sampling.

    v_t = xi0 * exp(eta * W~_t - eta^2/2 * t^{2H})
    dS/S = sqrt(v_t) * (rho dW + sqrt(1-rho^2) dW_perp)

The port of ``montecarlo_tpu/processes/rough_bergomi.py``.  ``W~`` is the
Riemann-Liouville fractional process, which is not Markovian, so the model
is not a step process: the joint Gaussian of (W~ at the T grid times, the T
Brownian increments) is sampled exactly as ``chol @ Z`` with the host's
float64 Cholesky factor of its covariance, and the price integral runs over
the sampled rows.

On a CUDA model ``rbergomi_simulate`` runs K5 (the bulk normal matrix,
``ops/rng_kernel.py``), one true-float32 ``torch.matmul`` and, for terminal
prices, K6 (the fused price integral with in-kernel perpendicular normals,
``ops/rbergomi_kernel.py``); a CPU model runs the kernels' plain versions.
Both devices follow K6's float order, which differs from the JAX package's
XLA tail (its CPU path) in grouping and summation order only.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from montecarlo_tpu_torch.device import resolve_device
from montecarlo_tpu_torch.precision import factor_product
from montecarlo_tpu_torch.rng.normal import exp32, log32


def volterra_joint_chol(n_steps: int, T: float, H: float) -> np.ndarray:
    """(2T, 2T) Cholesky factor of the joint (W~ grid values, dW) Gaussian.

    Columns 0..T-1: W~ at t_1..t_T; columns T..2T-1: Brownian increments.
    Host-side, float64, one-time per (n_steps, T, H).
    """
    dt = T / n_steps
    t = (np.arange(1, n_steps + 1)) * dt
    r = H + 0.5
    c2h = 2.0 * H

    # Volterra-Volterra block: 2H int_0^{min} ((t-u)(s-u))^{H-1/2} du.
    # The (min-u)^{H-1/2} factor is singular at u=min; substituting
    # u = min - w^2 turns the integrand into 2 (max-min+w^2)^{H-1/2} w^{2H}
    # — bounded and smooth, so Gauss-Legendre in w converges fast.
    x_gl, w_gl = np.polynomial.legendre.leggauss(64)
    tt = t[:, None]
    ss = t[None, :]
    mn = np.minimum(tt, ss)
    gap = np.abs(tt - ss)
    half = 0.5 * np.sqrt(mn)
    w_nodes = half[..., None] * (x_gl + 1.0)      # (T, T, 64) in [0, sqrt(mn)]
    weights = half[..., None] * w_gl
    integrand = (2.0 * (gap[..., None] + w_nodes**2) ** (H - 0.5)
                 * w_nodes ** c2h)
    cov_vv = c2h * np.sum(weights * integrand, axis=-1)
    # diagonal is exact: Var[W~_t] = t^{2H}
    np.fill_diagonal(cov_vv, t ** c2h)

    # Volterra-Brownian: Cov[W~_ti, W_s] = sqrt(2H)/r (ti^r - (ti - min)^r)
    def cov_vw_point(ti, s):
        mn = np.minimum(s, ti)
        return np.sqrt(c2h) / r * (ti ** r - (ti - mn) ** r)

    s_grid = t
    cvw_full = cov_vw_point(tt, s_grid[None, :])          # vs W_{s_j}
    cvw_prev = cov_vw_point(tt, (s_grid - dt)[None, :])   # vs W_{s_{j-1}}
    cov_vw = cvw_full - cvw_prev                          # vs increments

    cov_ww = np.eye(n_steps) * dt

    top = np.concatenate([cov_vv, cov_vw], axis=1)
    bot = np.concatenate([cov_vw.T, cov_ww], axis=1)
    cov = np.concatenate([top, bot], axis=0)
    # jitter for numerical PSD (cov_vv quadrature error ~1e-12)
    return np.linalg.cholesky(cov + 1e-12 * np.eye(2 * n_steps))


@dataclass(frozen=True)
class RoughBergomi:
    """Rough Bergomi sampler (not a step process — see the module
    docstring).  Every field is a float32 tensor on the model's device, in
    the JAX NamedTuple's order."""

    s0: torch.Tensor
    xi0: torch.Tensor      # forward variance level
    eta: torch.Tensor      # vol-of-vol
    rho: torch.Tensor      # spot-vol correlation
    h: torch.Tensor        # Hurst exponent
    chol: torch.Tensor     # (2T, 2T) joint Cholesky factor
    t_grid: torch.Tensor   # (T,) grid times
    dt: torch.Tensor

    @classmethod
    def create(cls, s0, xi0, eta, rho, h, n_steps: int, T: float,
               device="cuda") -> "RoughBergomi":
        dev = resolve_device(device)
        chol = volterra_joint_chol(n_steps, T, float(h))
        dt = T / n_steps
        as_ = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
        return cls(s0=as_(s0), xi0=as_(xi0), eta=as_(eta), rho=as_(rho),
                   h=as_(h), chol=as_(chol),
                   t_grid=as_(np.arange(1, n_steps + 1) * dt), dt=as_(dt))

    @property
    def n_steps(self) -> int:
        return self.t_grid.shape[0]

    @property
    def device(self) -> torch.device:
        return self.s0.device

    def kernel_params(self) -> torch.Tensor:
        """K6's 7-vector (xi0, eta, rho, sqrt(1-rho^2)*sqrt(dt), dt/2,
        log32(s0), eta^2/2), float32, as the JAX sampler stacks it."""
        return torch.stack([
            self.xi0, self.eta, self.rho,
            torch.sqrt(1.0 - torch.square(self.rho)) * torch.sqrt(self.dt),
            0.5 * self.dt, log32(self.s0), 0.5 * torch.square(self.eta)])

    def tpow(self) -> torch.Tensor:
        """(T,) grid times to the power 2H."""
        return self.t_grid ** (2.0 * self.h)


def rbergomi_simulate(model: RoughBergomi, n_paths: int, *, seed: int,
                      stream: int = 0, path_offset=0,
                      mode: str = "terminal"):
    """Terminal prices (or (v paths, S terminals)) under rough Bergomi.

    Entry (m, i) of the draw matrix is draw index m of global path
    ``path_offset + i``; rows 0..2T-1 hit the Cholesky factor, rows
    2T..3T-1 are the perpendicular normals.  ``"terminal"`` generates 2T
    rows and K6 makes the perpendicular normals in-kernel from the same
    counters; ``"paths"`` generates 3T rows and runs the JAX package's
    tensor tail in torch, returning ``(v (N, T), S_T (N,))``.  Any
    ``n_paths >= 1`` and ``T >= 1``.
    """
    from montecarlo_tpu_torch.ops.rbergomi_kernel import rbergomi_terminal
    from montecarlo_tpu_torch.ops.rng_kernel import normal_matrix

    if mode not in ("terminal", "paths"):
        raise ValueError(f"mode must be 'terminal' or 'paths', got {mode!r}")
    T = model.n_steps
    n_cols = 2 * T if mode == "terminal" else 3 * T
    z = normal_matrix(seed, stream, n_paths, n_cols, path_offset=path_offset,
                      device=model.device)                  # (n_cols, N)
    joint = factor_product(model.chol, z[:2 * T])           # (2T, N)
    if mode == "terminal":
        return rbergomi_terminal(joint, model.tpow(), model.kernel_params(),
                                 seed, stream, n_steps=T,
                                 path_offset=path_offset)
    w_tilde = joint[:T]                                # W~ at grid times
    dw = joint[T:]                                     # Brownian increments
    z_perp = z[2 * T:]                                 # dW_perp normals
    t = model.t_grid
    v = model.xi0 * exp32(model.eta * w_tilde
                          - 0.5 * torch.square(model.eta)
                          * t[:, None] ** (2.0 * model.h))   # (T, N)
    # log S: left-point Riemann (v at the interval start; v_0 = xi0).
    v_left = torch.cat([model.xi0.expand(1, n_paths), v[:-1]], dim=0)
    sqrt_v = torch.sqrt(v_left)
    rho = model.rho
    dws = (rho * dw + torch.sqrt(1.0 - torch.square(rho)) * z_perp
           * torch.sqrt(model.dt))
    log_s = log32(model.s0) + torch.sum(
        sqrt_v * dws - 0.5 * v_left * model.dt, dim=0)
    return v.T, exp32(log_s)


__all__ = ["RoughBergomi", "rbergomi_simulate", "volterra_joint_chol"]
