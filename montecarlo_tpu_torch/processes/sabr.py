"""SABR stochastic-volatility model (Hagan et al. 2002), forward measure.

    F'     = max(F+ + sigma F+^beta sqrt(dt) z1, 0),   F+ = max(F, 0)
    sigma' = sigma exp32(nu sqrt(dt) w2 - nu^2 dt / 2)
    w2     = rho z1 + sqrt(1 - rho^2) z2

The port of the process in ``montecarlo_tpu/processes/sabr.py``: Euler on
the forward, absorbed at zero, and the exact lognormal step of the vol.
Two normal draws per step (``NormalDrawsMixin``), so the Sobol samplers
take it.  The prices are the forward itself; it has no ``log_prices``, so
log-space functionals observe ``log32(prices)``.

The power ``F+^beta`` is ``exp32(beta log32(F+))`` for F+ > 0, 0 at F+ = 0
(1 when beta = 0, as ``jnp.power`` gives), so the torch versions and the
kernel run the same IEEE operations; it agrees with ``jnp.power`` to a few
float32 ULP for F+ in log32's range [2.5e-9, 5e8].

K2, K3 and K4 run it as ``SabrProc`` (``csrc/fused_engine.cu``).

The Hagan implied-vol expansion (:func:`sabr_hagan_iv`) and the smile fit
on it (:func:`calibrate_sabr`) are the process's oracle and its
calibration, as in the JAX module.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, NamedTuple

import torch

from montecarlo_tpu_torch.processes.base import NormalDrawsMixin, f32_leaves
from montecarlo_tpu_torch.rng.normal import exp32, log32


class SABRState(NamedTuple):
    f: torch.Tensor      # forward
    sigma: torch.Tensor  # instantaneous vol


def cev_power(f_plus: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """``f_plus ** beta`` for f_plus >= 0 as ``exp32(beta log32(f))``,
    with ``jnp.power``'s value at 0: 0, or 1 when beta = 0."""
    at_zero = torch.where(beta == 0.0, 1.0, 0.0)
    return torch.where(f_plus > 0.0, exp32(beta * log32(f_plus)), at_zero)


@dataclass(frozen=True)
class SABR(NormalDrawsMixin):
    """SABR under the forward measure (driftless forward).  Every field is
    a 0-d float32 tensor."""

    f0: torch.Tensor
    alpha: torch.Tensor  # initial vol sigma_0
    beta: torch.Tensor   # CEV exponent in [0, 1]
    nu: torch.Tensor     # vol-of-vol
    rho: torch.Tensor    # corr(forward, vol)
    dt: torch.Tensor

    n_draws: ClassVar[int] = 2

    @classmethod
    def create(cls, f0, alpha, beta, nu, rho, dt, device="cuda") -> "SABR":
        return cls(**f32_leaves(device, f0=f0, alpha=alpha, beta=beta, nu=nu,
                                rho=rho, dt=dt))

    def init_state(self, path_ids) -> SABRState:
        shape = path_ids.shape
        return SABRState(f=self.f0.expand(shape).clone(),
                         sigma=self.alpha.expand(shape).clone())

    def step(self, state: SABRState, eps, t) -> SABRState:
        z1, z2 = eps
        w2 = self.rho * z1 + torch.sqrt(1.0 - torch.square(self.rho)) * z2
        sqdt = torch.sqrt(self.dt)
        f_plus = torch.clamp(state.f, min=0.0)
        df = state.sigma * cev_power(f_plus, self.beta) * sqdt * z1
        f_new = torch.clamp(f_plus + df, min=0.0)
        sig_new = state.sigma * exp32(
            self.nu * sqdt * w2 - 0.5 * torch.square(self.nu) * self.dt)
        return SABRState(f=f_new, sigma=sig_new)

    def prices(self, state: SABRState):
        return state.f


def sabr_hagan_iv(f0, strike, T, alpha, beta, nu, rho) -> torch.Tensor:
    """Hagan et al. (2002) lognormal (Black) implied-vol expansion: the
    quoting approximation the smile calibration fits.  The port of
    ``montecarlo_tpu/processes/sabr.py::sabr_hagan_iv``: in the dtype and
    on the device of its tensor inputs (``engine.payoffs.
    common_operands``; a python ``beta`` stays a python number, as in JAX),
    broadcasting, differentiable in (alpha, nu, rho).  The removable
    singularity at z = 0 (at the money) is guarded as JAX guards it: x is
    evaluated at a z kept away from 0 and the series limit selected there,
    so neither branch of the ``where`` gives a NaN gradient."""
    from montecarlo_tpu_torch.engine.payoffs import common_operands

    if torch.is_tensor(beta):
        f0, k, T, alpha, nu, rho, beta = common_operands(
            f0, strike, T, alpha, nu, rho, beta)
    else:
        f0, k, T, alpha, nu, rho = common_operands(f0, strike, T, alpha, nu,
                                                   rho)
    one_m_b = 1.0 - beta
    fk_mid = (f0 * k) ** (one_m_b / 2.0)
    log_fk = torch.log(f0 / k)
    z = (nu / alpha) * fk_mid * log_fk
    near0 = torch.abs(z) < 1e-6
    z_safe = torch.where(near0, torch.ones_like(z), z)
    x = torch.log((torch.sqrt(1.0 - 2.0 * rho * z_safe + z_safe * z_safe)
                   + z_safe - rho) / (1.0 - rho))
    z_over_x = torch.where(near0, 1.0 - rho * z / 2.0, z_safe / x)
    denom = fk_mid * (1.0 + one_m_b ** 2 / 24.0 * log_fk ** 2
                      + one_m_b ** 4 / 1920.0 * log_fk ** 4)
    correction = (1.0 + (one_m_b ** 2 / 24.0 * alpha ** 2 / fk_mid ** 2
                         + 0.25 * rho * beta * nu * alpha / fk_mid
                         + (2.0 - 3.0 * rho ** 2) / 24.0 * nu ** 2) * T)
    return alpha / denom * z_over_x * correction


def _constrain_sabr(raw: torch.Tensor):
    import torch.nn.functional as F

    return (F.softplus(raw[0]) * 0.5,   # alpha (CEV units)
            F.softplus(raw[1]) * 0.5,   # nu
            torch.tanh(raw[2]))         # rho


def _smile_loss(strikes, ivs, f0, T, beta):
    """raw -> the mean squared Hagan implied-vol error of
    ``_constrain_sabr(raw)``."""
    def loss_fn(raw):
        alpha, nu, rho = _constrain_sabr(raw)
        model = sabr_hagan_iv(f0, strikes, T, alpha, beta, nu, rho)
        return torch.mean(torch.square(model - ivs))

    return loss_fn


#: Raw optimizer start of the smile fit.
SABR_RAW0 = (1.0, 0.5, 0.0)


def calibrate_sabr(strikes, ivs, *, f0, T, beta: float = 0.7,
                   n_iters: int = 3000, lr: float = 0.05,
                   dtype=torch.float32, device="cuda") -> dict:
    """Fit (alpha, nu, rho) to a market smile of Black implied vols by Adam
    (``engine.adam``) on the exact gradient of the Hagan expansion, beta
    fixed by convention, in ``dtype`` on ``device``.  Returns ``{"alpha",
    "nu", "rho", "rmse_vol"}``, ``rmse_vol`` the square root of the last
    loss evaluated."""
    from montecarlo_tpu_torch.device import resolve_device
    from montecarlo_tpu_torch.engine.adam import adam_minimize, rmse_of_last

    dev = resolve_device(device)
    strikes, ivs, f0, T = (torch.as_tensor(x, dtype=dtype, device=dev)
                           for x in (strikes, ivs, f0, T))

    raw0 = torch.tensor(SABR_RAW0, dtype=dtype, device=dev)
    raw, losses = adam_minimize(_smile_loss(strikes, ivs, f0, T, beta),
                                raw0, n_iters, lr)
    alpha, nu, rho = (float(v) for v in _constrain_sabr(raw))
    return {"alpha": alpha, "nu": nu, "rho": rho,
            "rmse_vol": rmse_of_last(losses)}
