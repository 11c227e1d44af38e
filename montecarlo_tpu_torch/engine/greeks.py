"""Pathwise, likelihood-ratio and second-order Greeks.

The port of ``montecarlo_tpu/engine/greeks.py``.  Pathwise Greeks
differentiate the discounted mean payoff with respect to the process
parameters themselves, in one reverse pass through the simulator, on the
same counter-based draws as the price (common random numbers by
construction).  The pathwise estimator needs an a.e.-differentiable payoff
(calls, puts, baskets); a digital needs the likelihood-ratio estimator or a
smoothed payoff.

Reverse mode runs through the torch time loop (``engine.simulate``), never
through the kernels: they are launched on raw pointers and define no
backward, as the Pallas kernels define no VJP, and their wrappers refuse a
process whose leaf requires grad (``ops._build.check_no_grad``).  The
draws' integer arithmetic is constant in the parameters, which is the
fixed-draws pathwise construction.  A bump makes a new process
(``dataclasses.replace``) and never edits a tensor in place: the kernels'
launch leaves are cached by process identity.
"""

from __future__ import annotations

import dataclasses

import torch

from montecarlo_tpu_torch.engine.dispatch import terminal_prices
from montecarlo_tpu_torch.engine.payoffs import (black_scholes_d1, host64,
                                                 norm_pdf)
from montecarlo_tpu_torch.engine.simulate import simulate

F32 = torch.float32


def float_leaves(process) -> dict:
    """The process's floating-point tensor fields, by name."""
    return {f.name: getattr(process, f.name)
            for f in dataclasses.fields(process)
            if torch.is_tensor(getattr(process, f.name))
            and getattr(process, f.name).is_floating_point()}


def grads_like(process, grads: dict):
    """A dataclass of ``process``'s type holding the gradient of every
    field: ``grads[name]`` for a float leaf (zeros where the price does
    not depend on it) and float32 zeros for an integer leaf (JAX's
    ``allow_int`` float0).  Built without the constructor's checks, which
    a zero integer leaf would fail (GARCHBootstrap's table length)."""
    out = object.__new__(type(process))
    for f in dataclasses.fields(process):
        v = getattr(process, f.name)
        g = grads.get(f.name)
        object.__setattr__(out, f.name, g if g is not None else torch.zeros(
            v.shape, dtype=F32, device=v.device))
    return out


def _discount(discount, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(discount, dtype=like.dtype, device=like.device)


def price_and_greeks(process, payoff_fn, n_paths: int, n_steps: int, *,
                     seed: int, discount=1.0, stream: int = 0,
                     remat: bool = False):
    """Discounted price and its gradient with respect to every process
    parameter.

    Returns ``(price, grads)``, ``grads`` a dataclass shaped like
    ``process``: for GBM ``grads.s0`` is delta, ``grads.sigma`` vega (per
    unit of annualized vol), ``grads.mu`` the drift sensitivity (rho for a
    risk-neutral drift).  Integer leaves (the GARCH bootstrap's
    ``n_table``) get zeros.  ``remat`` checkpoints every step of the time
    loop (``engine.simulate``): the same bits, less memory.
    """
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in float_leaves(process).items()}
    proc = dataclasses.replace(process, **leaves)
    with torch.enable_grad():
        terminal = simulate(proc, n_paths, n_steps, seed=seed, stream=stream,
                            remat=remat)
        price = _discount(discount, terminal) * torch.mean(
            payoff_fn(terminal))
        grads = {}
        if price.requires_grad:  # a step payoff has no graph: zeros
            got = torch.autograd.grad(price, list(leaves.values()),
                                      allow_unused=True)
            grads = dict(zip(leaves, got))
    return price.detach(), grads_like(process, grads)


def lr_greeks_gbm(process, payoff_fn, n_paths: int, n_steps: int, *,
                  seed: int, discount=1.0, stream: int = 0) -> dict:
    """Likelihood-ratio delta and vega for GBM, valid for any terminal
    payoff, discontinuous ones included (digitals), where the pathwise
    estimator fails.  Under GBM ``ln S_T ~ N(a, v)``, ``a = ln S0 + (mu -
    sigma^2/2) T``, ``v = sigma^2 T``; with ``z = (ln S_T - a) / (sigma
    sqrt(T))`` the scores are

        d ln p / d S0    = z / (S0 sigma sqrt(T))
        d ln p / d sigma = (z^2 - 1) / sigma - z sqrt(T)

    and greek = E[payoff * score].  It needs no gradient, so the terminal
    prices come from ``engine.dispatch.terminal_prices`` (K2 on the card).
    Returns ``price``, ``delta``, ``vega`` and their ``*_std_err``."""
    terminal = terminal_prices(process, n_paths, n_steps, seed=seed,
                               stream=stream)
    d = _discount(discount, terminal)
    sqrt_t = torch.sqrt(process.dt * n_steps)
    sigma = process.sigma
    a = (torch.log(process.s0)
         + (process.mu - 0.5 * torch.square(sigma)) * process.dt * n_steps)
    z = (torch.log(terminal) - a) / (sigma * sqrt_t)
    f = payoff_fn(terminal)
    score_s0 = z / (process.s0 * sigma * sqrt_t)
    score_sigma = (torch.square(z) - 1.0) / sigma - z * sqrt_t
    root_n = torch.sqrt(torch.tensor(float(n_paths), dtype=F32,
                                     device=terminal.device))
    fs0, fsig = f * score_s0, f * score_sigma
    return {
        "price": d * torch.mean(f),
        "delta": d * torch.mean(fs0),
        "vega": d * torch.mean(fsig),
        "delta_std_err": d * torch.std(fs0, correction=0) / root_n,
        "vega_std_err": d * torch.std(fsig, correction=0) / root_n,
    }


def smoothed_call(strike, width=2.0):
    """Twice-differentiable surrogate for the call payoff max(S - K, 0):
    ``w (x Phi(x) + phi(x))`` with ``x = (S - K) / w``, the hinge convolved
    with a N(0, w^2) kernel.  Its second derivative, the thing gamma needs,
    is the smooth density phi(x) / w instead of a delta.  Bias O(w^2 *
    payoff curvature); gamma's noise grows like 1 / w."""
    inv_sqrt2 = 0.7071067811865476
    inv_sqrt2pi = 0.3989422804014327

    def payoff(s):
        x = (s - strike) / width
        cdf = 0.5 * (1.0 + torch.erf(x * inv_sqrt2))
        pdf = inv_sqrt2pi * torch.exp(-0.5 * x * x)
        return width * (x * cdf + pdf)

    return payoff


def smoothed_digital(strike, width=0.5):
    """A differentiable surrogate for the digital payoff 1{S_T > K}:
    ``sigmoid((S - K) / width)``.  Makes :func:`price_and_greeks` usable
    for digital-style payoffs under any process; bias O(width * density
    curvature)."""
    def payoff(s):
        return torch.sigmoid((s - strike) / width)

    return payoff


def second_order_greeks(process, payoff_fn, n_paths: int, n_steps: int, *,
                        seed: int, fields=("s0", "sigma"), discount=1.0,
                        stream: int = 0):
    """Price, gradient and Hessian with respect to named scalar process
    fields, under common random numbers: with ``fields=("s0", "sigma")``
    the Hessian is ``[[gamma, vanna], [vanna, volga]]``.

    One forward pass of the torch time loop with a zero bump per field
    (the process is rebuilt by ``dataclasses.replace`` with ``field +
    bump``; the given process is left as it is), the gradient with
    ``create_graph``, then one reverse pass per field for its Hessian row.
    The payoff must be twice a.e.-differentiable (:func:`smoothed_call`),
    or the Hessian is a.e. zero.  Returns ``(price, grad, hessian)``,
    float32 tensors."""
    dev = process.device
    bumps = torch.zeros(len(fields), dtype=F32, device=dev,
                        requires_grad=True)
    with torch.enable_grad():
        proc = dataclasses.replace(process, **{
            f: getattr(process, f).detach()
            + bumps[i].to(getattr(process, f).dtype)
            for i, f in enumerate(fields)})
        terminal = simulate(proc, n_paths, n_steps, seed=seed, stream=stream)
        price = _discount(discount, terminal) * torch.mean(
            payoff_fn(terminal))
        (grad,) = torch.autograd.grad(price, bumps, create_graph=True)
        hess = torch.stack([
            torch.autograd.grad(grad[i], bumps,
                                retain_graph=i + 1 < len(fields))[0]
            for i in range(len(fields))])
    return price.detach(), grad.detach(), hess.detach()


def black_scholes_delta(s0, strike, r, sigma, T) -> torch.Tensor:
    """Closed-form call delta, a float64 host tensor: the oracle."""
    return torch.special.ndtr(black_scholes_d1(s0, strike, r, sigma, T))


def black_scholes_vega(s0, strike, r, sigma, T) -> torch.Tensor:
    """Closed-form call vega, a float64 host tensor: the oracle, and the
    Newton slope of ``engine.implied_vol``."""
    d1 = black_scholes_d1(s0, strike, r, sigma, T)
    return host64(s0) * norm_pdf(d1) * torch.sqrt(host64(T))
