"""Payoff functions and the Black-Scholes closed forms used as oracles.

The port of ``montecarlo_tpu/engine/payoffs.py`` (European call/put,
discount factor, Black-Scholes call/put), plus :class:`VanillaPayoff`: the
call/put/digital payoff as data, which the K3 kernel evaluates in its
epilogue.  Any other payoff callable runs in torch after K2.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


def european_call(s_t: torch.Tensor, strike) -> torch.Tensor:
    return torch.clamp(s_t - strike, min=0.0)


def european_put(s_t: torch.Tensor, strike) -> torch.Tensor:
    return torch.clamp(strike - s_t, min=0.0)


def digital_call(s_t: torch.Tensor, strike) -> torch.Tensor:
    """Cash-or-nothing call: 1 where S_T > K."""
    return (s_t > strike).to(torch.float32)


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


def black_scholes_put(s0, strike, r, sigma, T) -> float:
    """Put by put-call parity."""
    return (black_scholes_call(s0, strike, r, sigma, T) - s0
            + strike * math.exp(-r * T))


def black_scholes_digital(s0, strike, r, sigma, T) -> float:
    """Cash-or-nothing call: e^{-rT} N(d2)."""
    d2 = ((math.log(s0 / strike) + (r - 0.5 * sigma ** 2) * T)
          / (sigma * math.sqrt(T)))
    return math.exp(-r * T) * _norm_cdf(d2)
