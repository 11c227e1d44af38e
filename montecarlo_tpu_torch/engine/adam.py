"""Adam on exact gradients, as ``optax.adam`` computes it: the optimizer of
every calibrator (Heston, the Lévy families, Vasicek, SABR).

One step from the loss at ``raw`` and its gradient ``g`` (b1 0.9, b2 0.999,
eps 1e-8, eps_root 0, count from 1):

    mu  = (1 - b1) g + b1 mu
    nu  = (1 - b2) g^2 + b2 nu
    raw = raw + (-lr) * ((mu / (1 - b1^count))
                         / (sqrt(nu / (1 - b2^count)) + eps))

in optax's order of operations (``scale_by_adam``, ``scale(-lr)``,
``apply_updates``), which ``torch.optim.Adam`` does not keep.  The bias
corrections are python floats, rounded to the parameters' dtype where they
divide.  The loop runs eagerly on the parameters' device; the loss of each
step is kept there and read once at the end.
"""

from __future__ import annotations

import math

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def adam_minimize(loss_fn, raw0: torch.Tensor, n_iters: int, lr: float):
    """``n_iters`` Adam steps on ``loss_fn`` from ``raw0`` (a 1-d tensor:
    its dtype and device are the run's).  Returns ``(raw, losses)``:
    ``raw`` after the last update, ``losses[i]`` the loss evaluated at
    step i, before its update (so ``losses[-1]`` is the loss before the
    final update, as ``lax.scan`` stacks it in the JAX package)."""
    raw = raw0.detach().clone()
    mu = torch.zeros_like(raw)
    nu = torch.zeros_like(raw)
    losses = []
    for count in range(1, int(n_iters) + 1):
        leaf = raw.requires_grad_(True)
        with torch.enable_grad():
            loss = loss_fn(leaf)
            (g,) = torch.autograd.grad(loss, leaf)
        losses.append(loss.detach())
        with torch.no_grad():
            mu = (1 - B1) * g + B1 * mu
            nu = (1 - B2) * (g * g) + B2 * nu
            mu_hat = mu / (1 - B1 ** count)
            nu_hat = nu / (1 - B2 ** count)
            upd = mu_hat / (torch.sqrt(nu_hat + 0.0) + EPS)
            raw = leaf.detach() + (-lr) * upd
    stacked = (torch.stack(losses) if losses
               else torch.empty(0, dtype=raw.dtype, device=raw.device))
    return raw, stacked


def rmse_of_last(losses: torch.Tensor) -> float:
    """The square root of the last loss evaluated: every calibrator's
    ``rmse_vol``/``rmse_rel``."""
    return math.sqrt(float(losses[-1]))
