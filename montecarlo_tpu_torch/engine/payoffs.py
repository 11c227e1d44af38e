"""Payoff functions and the Black-Scholes closed forms used as oracles.

The port of ``montecarlo_tpu/engine/payoffs.py`` (European call/put, the
basket and max calls, discount factor, Black-Scholes call/put, the quanto
drift and call), plus :class:`VanillaPayoff`: the call/put/digital payoff
as data, which the K3 kernel evaluates in its epilogue.  Any other payoff
callable runs in torch after K2.

The Black-Scholes closed forms come in two forms: python floats
(:func:`black_scholes_call`, ``_put``, ``_digital``), and float64 host
tensors that broadcast over their inputs (:func:`black_scholes_call_tensor`,
:func:`black_scholes_quanto_call`), which the greeks' oracles and the
implied-vol solver take, as JAX's return arrays.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch


def european_call(s_t: torch.Tensor, strike) -> torch.Tensor:
    return torch.clamp(s_t - strike, min=0.0)


def european_put(s_t: torch.Tensor, strike) -> torch.Tensor:
    return torch.clamp(strike - s_t, min=0.0)


def digital_call(s_t: torch.Tensor, strike) -> torch.Tensor:
    """Cash-or-nothing call: 1 where S_T > K."""
    return (s_t > strike).to(torch.float32)


def basket_call(prices: torch.Tensor, weights, strike) -> torch.Tensor:
    """Call on a weighted basket: prices (n_paths, n_assets)."""
    w = torch.as_tensor(weights, dtype=prices.dtype, device=prices.device)
    return torch.clamp(prices @ w - strike, min=0.0)


def max_call(prices: torch.Tensor, strike) -> torch.Tensor:
    """Call on the best of several assets: prices (..., n_assets) — the
    Bermudan max-call benchmark payoff (Andersen-Broadie 2004)."""
    return torch.clamp(torch.amax(prices, dim=-1) - strike, min=0.0)


@dataclass(frozen=True)
class VanillaPayoff:
    """``kind`` in {"call", "put", "digital"} at ``strike``; callable on
    terminal prices.  The strike enters the float32 arithmetic rounded to
    float32, in torch and in the kernel alike."""

    kind: str
    strike: float

    KINDS = ("call", "put", "digital")  # index = the kernel's payoff code

    def __post_init__(self):
        if self.kind not in self.KINDS:
            raise ValueError(f"payoff kind must be one of {self.KINDS}, "
                             f"got {self.kind!r}")

    @property
    def code(self) -> int:
        return self.KINDS.index(self.kind)

    def __call__(self, s_t: torch.Tensor) -> torch.Tensor:
        fn = {"call": european_call, "put": european_put,
              "digital": digital_call}[self.kind]
        return fn(s_t, self.strike)


def discount_factor(r, T) -> torch.Tensor:
    """exp(-r T) as a float32 0-d tensor."""
    return torch.exp(torch.tensor(-r * T, dtype=torch.float32))


def _norm_cdf(x: float) -> float:
    return 0.5 * math.erfc(-x / math.sqrt(2.0))


def black_scholes_call(s0, strike, r, sigma, T) -> float:
    """Black-Scholes call in float64 — the absolute oracle for GBM calls."""
    sqrt_t = math.sqrt(T)
    d1 = (math.log(s0 / strike) + (r + 0.5 * sigma ** 2) * T) / (sigma
                                                                 * sqrt_t)
    d2 = d1 - sigma * sqrt_t
    return s0 * _norm_cdf(d1) - strike * math.exp(-r * T) * _norm_cdf(d2)


def host64(x) -> torch.Tensor:
    """``x`` (a number, a list, an array or a tensor on any device) as a
    float64 tensor on the host.  A python float goes to float64 directly,
    never through torch's float32 default."""
    if torch.is_tensor(x):
        return x.detach().to("cpu", torch.float64)
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def common_operands(*xs):
    """``xs`` as tensors of one float dtype on one device: the promoted
    float type of the tensor and numpy inputs (float64 when none is a
    float), on the first CUDA device among them, else the host.  A tensor
    already of that dtype and device comes back as it is, graph
    included."""
    strong = [torch.from_numpy(np.asarray(x)) if isinstance(x, np.ndarray)
              else x for x in xs]
    tensors = [x for x in strong if torch.is_tensor(x)]
    floats = [t.dtype for t in tensors if t.is_floating_point()]
    dtype = (functools.reduce(torch.promote_types, floats) if floats
             else torch.float64)
    devices = [t.device for t in tensors]
    device = next((d for d in devices if d.type == "cuda"),
                  devices[0] if devices else torch.device("cpu"))
    return tuple(torch.as_tensor(x, dtype=dtype, device=device)
                 for x in strong)


def norm_pdf(x: torch.Tensor) -> torch.Tensor:
    """The standard normal density."""
    return torch.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)


def black_scholes_d1(s0, strike, r, sigma, T) -> torch.Tensor:
    """d1 of the Black-Scholes call, float64 on the host, broadcast."""
    s0, strike, r, sigma, T = map(host64, (s0, strike, r, sigma, T))
    return ((torch.log(s0 / strike) + (r + 0.5 * sigma ** 2) * T)
            / (sigma * torch.sqrt(T)))


def black_scholes_call_tensor(s0, strike, r, sigma, T) -> torch.Tensor:
    """The Black-Scholes call as a float64 host tensor broadcast over its
    inputs (JAX's ``black_scholes_call``, which returns arrays)."""
    s0, strike, r, sigma, T = map(host64, (s0, strike, r, sigma, T))
    d1 = black_scholes_d1(s0, strike, r, sigma, T)
    d2 = d1 - sigma * torch.sqrt(T)
    return (s0 * torch.special.ndtr(d1)
            - strike * torch.exp(-r * T) * torch.special.ndtr(d2))


def black_scholes_put(s0, strike, r, sigma, T) -> float:
    """Put by put-call parity."""
    return (black_scholes_call(s0, strike, r, sigma, T) - s0
            + strike * math.exp(-r * T))


def black_scholes_digital(s0, strike, r, sigma, T) -> float:
    """Cash-or-nothing call: e^{-rT} N(d2)."""
    d2 = ((math.log(s0 / strike) + (r - 0.5 * sigma ** 2) * T)
          / (sigma * math.sqrt(T)))
    return math.exp(-r * T) * _norm_cdf(d2)


def quanto_drift(r_foreign, sigma_asset, sigma_fx, rho):
    """Risk-neutral drift of a foreign asset under the domestic measure for
    a quanto payoff (paid in domestic currency at a fixed conversion
    rate): ``r_f - rho * sigma_S * sigma_FX``, the Girsanov correction of
    the asset/FX covariance.  A GBM with this ``mu``, discounted at the
    domestic rate, prices the quanto as its vanilla; its closed form is
    :func:`black_scholes_quanto_call`."""
    return r_foreign - rho * sigma_asset * sigma_fx


def black_scholes_quanto_call(s0, strike, r_dom, r_for, sigma, sigma_fx,
                              rho, T) -> torch.Tensor:
    """Closed-form quanto call (fixed FX conversion, unit notional),
    ``e^{-r_d T} E^d[(S_T - K)^+]`` with S drifting at
    :func:`quanto_drift`; a float64 host tensor."""
    mu = quanto_drift(host64(r_for), host64(sigma), host64(sigma_fx),
                      host64(rho))
    s0, strike, sigma, T = map(host64, (s0, strike, sigma, T))
    fwd = s0 * torch.exp(mu * T)
    d1 = ((torch.log(fwd / strike) + 0.5 * sigma ** 2 * T)
          / (sigma * torch.sqrt(T)))
    d2 = d1 - sigma * torch.sqrt(T)
    return torch.exp(-host64(r_dom) * T) * (fwd * torch.special.ndtr(d1)
                                            - strike * torch.special.ndtr(d2))
