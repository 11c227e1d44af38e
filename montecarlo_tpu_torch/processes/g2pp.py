"""G2++ two-factor Gaussian short rate (Brigo–Mercurio ch. 4):

    r(t) = x(t) + y(t) + phi,     x(0) = y(0) = 0,
    dx = -a x dt + sigma dW1,  dy = -b y dt + eta dW2,  d<W1, W2> = rho dt,

with a constant shift ``phi``.  The port of
``montecarlo_tpu/processes/g2pp.py``: the exact 2-D OU transition per step,
the second unit normal correlated with the first by the exact step
correlation ``r12 = clip(cov / max(sx sy, 1e-38), -1, 1)``, every float32
operation in the JAX package's order.  ``prices`` is the short rate ``(x +
y) + phi``; it has no ``log_prices``.  Two normals a step, so the Sobol
sampler takes it and the bridge does not.  K2, K3 and K4 run it as
``RateProc<mc::G2ppStep, 2>`` (``csrc/rate_steps.cuh``,
``csrc/fused_rates.cu``).

Closed forms, in float64 on the host from the model's float32 leaves
(torch): ``g2pp_v`` (Brigo–Mercurio 4.10), ``g2pp_bond`` (P(t, t + tau) at
a factor state), ``g2pp_zcb`` (P(0, T)) and ``g2pp_swaption`` (the
European swaption of Brigo–Mercurio 4.31: Gauss–Hermite quadrature over x,
60 clipped Newton steps for the critical y at each node).  The JAX
package's ``g2pp_zcb`` computes in the model's dtype, float32 for the
CLI's model; the port's always in float64.  The swap closure
(``g2pp_swap_value_fn``) and the exposure protocol (``exposure_obs``,
``pathwise_rate``, ``im_norm``, ``wwr_state``) belong to the exposure
engines, which the port has not yet (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, NamedTuple

import numpy as np
import torch

from montecarlo_tpu_torch.device import resolve_device
from montecarlo_tpu_torch.processes.base import NormalDrawsMixin
from montecarlo_tpu_torch.processes.shortrate import ou_decay_scale
from montecarlo_tpu_torch.rng.normal import exp32

F64 = torch.float64


class G2State(NamedTuple):
    x: torch.Tensor  # (n_paths,)
    y: torch.Tensor  # (n_paths,)


@dataclass(frozen=True)
class G2PP(NormalDrawsMixin):
    """Two-factor additive-Gaussian short rate, exact per-step transition.
    Every field is a 0-d float32 tensor."""

    phi: torch.Tensor
    a: torch.Tensor
    sigma: torch.Tensor
    b: torch.Tensor
    eta: torch.Tensor
    rho: torch.Tensor
    dt: torch.Tensor

    n_draws: ClassVar[int] = 2

    @classmethod
    def create(cls, r0, a, sigma, b, eta, rho, dt, device="cuda") -> "G2PP":
        """``r0`` is the flat shift phi (r(0) = phi since x(0) = y(0) =
        0)."""
        if float(a) <= 0 or float(b) <= 0:
            raise ValueError("mean reversions a, b must be positive")
        if not -1.0 <= float(rho) <= 1.0:
            raise ValueError("need -1 <= rho <= 1")
        dev = resolve_device(device)
        as_ = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
        return cls(phi=as_(r0), a=as_(a), sigma=as_(sigma), b=as_(b),
                   eta=as_(eta), rho=as_(rho), dt=as_(dt))

    def init_state(self, path_ids) -> G2State:
        z = torch.zeros(path_ids.shape, dtype=torch.float32,
                        device=self.device)
        return G2State(x=z, y=z.clone())

    def step_constants(self):
        """(dec_x, dec_y, sx, sy, r12) of one step, float32, in the JAX
        package's order."""
        a, b, sg, et, dt = self.a, self.b, self.sigma, self.eta, self.dt
        dec_x, sx = ou_decay_scale(a, sg, dt)
        dec_y, sy = ou_decay_scale(b, et, dt)
        cov = self.rho * sg * et * (1.0 - exp32(-(a + b) * dt)) / (a + b)
        # The exact step correlation of the two OU increments; the clip
        # guards float32 round-off at |rho| = 1.
        r12 = torch.clamp(cov / torch.clamp(sx * sy, min=1e-38), -1.0, 1.0)
        return dec_x, dec_y, sx, sy, r12

    def step(self, state: G2State, eps, t) -> G2State:
        dec_x, dec_y, sx, sy, r12 = self.step_constants()
        z2 = (r12 * eps[0]
              + torch.sqrt(torch.clamp(1.0 - r12 * r12, min=0.0)) * eps[1])
        return G2State(x=state.x * dec_x + sx * eps[0],
                       y=state.y * dec_y + sy * z2)

    def prices(self, state: G2State):
        return state.x + state.y + self.phi


# --- closed forms ------------------------------------------------------------

def _bz(z, tau):
    """B(z, tau) = (1 - e^{-z tau}) / z."""
    return (1.0 - torch.exp(-z * tau)) / z


def g2pp_v(a, sigma, b, eta, rho, tau):
    """V(tau) = Var[int_t^{t+tau} (x + y) du | F_t], Brigo–Mercurio (4.10);
    tensors of one dtype."""
    t1 = (sigma * sigma / (a * a)) * (
        tau + (2.0 / a) * torch.exp(-a * tau)
        - (1.0 / (2.0 * a)) * torch.exp(-2.0 * a * tau) - 3.0 / (2.0 * a))
    t2 = (eta * eta / (b * b)) * (
        tau + (2.0 / b) * torch.exp(-b * tau)
        - (1.0 / (2.0 * b)) * torch.exp(-2.0 * b * tau) - 3.0 / (2.0 * b))
    t3 = (2.0 * rho * sigma * eta / (a * b)) * (
        tau + (torch.exp(-a * tau) - 1.0) / a
        + (torch.exp(-b * tau) - 1.0) / b
        - (torch.exp(-(a + b) * tau) - 1.0) / (a + b))
    return t1 + t2 + t3


def _leaves(model: G2PP, dtype, device):
    """(phi, a, sigma, b, eta, rho) as ``dtype`` tensors on ``device``."""
    return tuple(torch.as_tensor(getattr(model, k), dtype=dtype,
                                 device=device)
                 for k in ("phi", "a", "sigma", "b", "eta", "rho"))


def g2pp_bond(model: G2PP, x, y, tau):
    """P(t, t + tau) at the factor state (x, y), in x's dtype (float64 for
    python numbers): ``exp(-phi tau - B(a, tau) x - B(b, tau) y + V(tau) /
    2)``."""
    if not torch.is_tensor(x):
        x = torch.as_tensor(x, dtype=F64)
    dtype, dev = x.dtype, x.device
    y = torch.as_tensor(y, dtype=dtype, device=dev)
    tau = torch.as_tensor(tau, dtype=dtype, device=dev)
    phi, a, sg, b, et, rho = _leaves(model, dtype, dev)
    v = g2pp_v(a, sg, b, et, rho, tau)
    return torch.exp(-phi * tau - _bz(a, tau) * x - _bz(b, tau) * y
                     + 0.5 * v)


def g2pp_zcb(model: G2PP, maturity):
    """P(0, T), the bond at x = y = 0, in float64 on the host."""
    t = torch.as_tensor(maturity, dtype=F64)
    return g2pp_bond(model, torch.zeros_like(t), torch.zeros_like(t), t)


def g2pp_swaption(model: G2PP, strike: float, expiry: float,
                  payment_times, pay_dt: float, *, payer: bool = True,
                  n_quad: int = 64) -> float:
    """The European swaption under G2++, Brigo–Mercurio (4.31), in float64
    on the host: under the T0-forward measure (x(T0), y(T0)) is bivariate
    Gaussian; the conditional y-integral is closed, leaving one integral
    over x by Gauss–Hermite quadrature with a clipped-Newton critical
    ``ybar(x)`` at each node.  Receiver prices by parity against the
    forward swap value.  The JAX package's operations in its order."""
    times = [float(t) for t in payment_times]
    if min(times) <= float(expiry):
        raise ValueError("every payment must be after the expiry")
    cs_l = [strike * pay_dt] * len(times)
    cs_l[-1] += 1.0
    cs = torch.tensor(cs_l, dtype=F64)
    taui = torch.tensor([t - float(expiry) for t in times], dtype=F64)
    t0 = torch.tensor(float(expiry), dtype=F64)
    phi, a, sg, b, et, rho = _leaves(model, F64, "cpu")

    sx = sg * torch.sqrt((1.0 - torch.exp(-2.0 * a * t0)) / (2.0 * a))
    sy = et * torch.sqrt((1.0 - torch.exp(-2.0 * b * t0)) / (2.0 * b))
    rxy = rho * sg * et * (1.0 - torch.exp(-(a + b) * t0)) \
        / ((a + b) * sx * sy)
    # T0-forward-measure means (B-M 4.29 with s = 0, t = T = T0): mu = -M.
    mu_x = -((sg * sg / (a * a) + rho * sg * et / (a * b))
             * (1.0 - torch.exp(-a * t0))
             - sg * sg / (2.0 * a * a) * (1.0 - torch.exp(-2.0 * a * t0))
             - rho * sg * et / (b * (a + b))
             * (1.0 - torch.exp(-(a + b) * t0)))
    mu_y = -((et * et / (b * b) + rho * sg * et / (a * b))
             * (1.0 - torch.exp(-b * t0))
             - et * et / (2.0 * b * b) * (1.0 - torch.exp(-2.0 * b * t0))
             - rho * sg * et / (a * (a + b))
             * (1.0 - torch.exp(-(a + b) * t0)))

    ba = _bz(a, taui)                                    # (P,)
    bb = _bz(b, taui)
    av = torch.exp(-phi * taui + 0.5 * g2pp_v(a, sg, b, et, rho, taui))

    g_nodes, g_w = np.polynomial.hermite.hermgauss(n_quad)
    xs = mu_x + torch.sqrt(torch.tensor(2.0, dtype=F64)) * sx \
        * torch.from_numpy(g_nodes)                      # (Q,)
    wts = torch.from_numpy(g_w) / torch.sqrt(torch.tensor(np.pi, dtype=F64))

    lam = cs[None, :] * av[None, :] * torch.exp(-ba[None, :] * xs[:, None])
    ybar = torch.full(xs.shape, float(mu_y), dtype=F64)
    for _ in range(60):
        e = lam * torch.exp(-bb[None, :] * ybar[:, None])
        f = torch.sum(e, dim=1) - 1.0
        fp = -torch.sum(bb[None, :] * e, dim=1)
        ybar = torch.clamp(ybar - f / torch.clamp(fp, max=-1e-300), -5.0, 5.0)

    s1 = sy * torch.sqrt(torch.clamp(1.0 - rxy * rxy, min=1e-30))
    h1 = (ybar - mu_y) / s1 - rxy * (xs - mu_x) / (
        sx * torch.sqrt(torch.clamp(1.0 - rxy * rxy, min=1e-30)))
    h2 = h1[:, None] + bb[None, :] * s1                  # (Q, P)
    kap = -bb[None, :] * (mu_y - 0.5 * (1.0 - rxy * rxy) * sy * sy
                          * bb[None, :]
                          + rxy * sy * (xs[:, None] - mu_x) / sx)
    ndtr = torch.special.ndtr
    integrand = ndtr(-h1) - torch.sum(lam * torch.exp(kap) * ndtr(-h2),
                                      dim=1)
    p0_t0 = g2pp_zcb(model, t0)
    payer_px = p0_t0 * torch.sum(wts * integrand)
    if payer:
        return float(payer_px)
    # Parity: receiver = payer - forward payer swap value.
    fwd_swap = p0_t0 - torch.sum(cs * g2pp_zcb(model, torch.tensor(
        times, dtype=F64)))
    return float(payer_px - fwd_swap)


__all__ = ["G2PP", "G2State", "g2pp_bond", "g2pp_swaption", "g2pp_v",
           "g2pp_zcb"]
