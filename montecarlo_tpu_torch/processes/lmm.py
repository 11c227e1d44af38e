"""The LIBOR market model (BGM): every forward rate of a tenor grid is a
state variable.

The port of ``montecarlo_tpu/processes/lmm.py``.  K forwards F_k span
[T_k, T_{k+1}], T_k = k delta, lognormal (or displaced by ``shift``) under
the spot-LIBOR measure:

    dF_k / F_k = sigma_k sum_{j=eta(t)}^{k} (delta rho_jk sigma_j F_j)
                 / (1 + delta F_j) dt + sigma_k dW_k,

with the discrete bank account B(T_{i+1}) = B(T_i)(1 + delta F_i(T_i)) as
numeraire.  F_k fixes at T_k and stays frozen in the state after.

- The simulation grid is the tenor grid (``dt == delta``, checked by
  ``create``), so pathwise discounting by 1/B is exact.
- The state is an (n_paths, K) matrix of log shifted forwards and the log
  bank account.  The correlated shocks ``stack(eps) @ chol.T`` and the
  drift's ``w @ corr_drift`` (twice a step: predictor-corrector) are
  products in true float32 (``precision.factor_product``: no TF32 on the
  card), as the JAX package runs them at ``Precision.HIGHEST``; outside
  any kernel in both packages.  Their sums run in the BLAS's order, not
  XLA's, so paths agree with the JAX package to a tolerance.
- The K normals of a step come from one ``rng.normal.normal_matrix`` call
  over the block, bitwise the per-draw stream of ``NormalDrawsMixin``
  (draw ``m = t K + d``; an odd K splits a Box-Muller pair across steps).
- The leaves keep ``create``'s dtype and are cast in ``step``.  The start
  ``log32(f0 + shift)`` is computed in the run's dtype, as the JAX
  package's ``init_state(path_ids, dtype)`` does.
- ``create`` builds the vol table with torch and skips the host checks
  when ``f0``, ``sigma``, ``vol_ttm`` or ``shift`` is a tensor that
  requires grad, as the JAX package does for a tracer.

The exposure protocol (``exposure_obs``, ``pathwise_discount``,
``wwr_state``, ``im_norm``) is pure array code over (..., T+1, K+1, N)
observations.  The closed forms and the Monte Carlo caplet and swaption
(``lmm_zcb0``, ``lmm_swap_value_fn``, ``lmm_par_strike``,
``lmm_caplet_mc``, ``lmm_swaption_rebonato``, ``lmm_swaption_mc``) are
the JAX package's; the host ones in float64 from the model's leaves.
No kernel runs the LMM: the JAX package has none for it either.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from montecarlo_tpu_torch.device import resolve_device
from montecarlo_tpu_torch.precision import factor_product
from montecarlo_tpu_torch.processes.base import (NormalDrawsMixin,
                                                 grad_safe_sqrt)
from montecarlo_tpu_torch.rng.normal import exp32, log32, normal_matrix


class LMMState(NamedTuple):
    logf: torch.Tensor  # (n_paths, K) log shifted forwards; dead ones frozen
    logb: torch.Tensor  # (n_paths,) log discrete bank account


def exp_decay_corr(n: int, beta: float, delta: float) -> np.ndarray:
    """The exponential-decay forward correlation ``rho_jk = exp(-beta |T_j
    - T_k|)`` (host, float64)."""
    t = np.arange(n) * float(delta)
    return np.exp(-float(beta) * np.abs(t[:, None] - t[None, :]))


def _requires_grad(v) -> bool:
    return torch.is_tensor(v) and v.requires_grad


def _host(v) -> np.ndarray:
    if torch.is_tensor(v):
        return v.detach().cpu().double().numpy()
    return np.asarray(v)


@dataclass(frozen=True)
class LMM(NormalDrawsMixin):
    """(Displaced-)lognormal LIBOR market model, spot-measure
    predictor-corrector.  ``sig_steps[t, k]`` is forward k's vol during
    step t; ``sigma`` its first row.  Every field is a tensor in
    ``create``'s dtype on the model's device."""

    f0: torch.Tensor          # (K,) initial forwards
    sigma: torch.Tensor       # (K,) the t = 0 vols
    sig_steps: torch.Tensor   # (K, K) vol of forward k during step t
    corr: torch.Tensor        # (K, K) instantaneous correlation
    corr_drift: torch.Tensor  # (K, K) upper triangle (j <= k) of corr
    chol: torch.Tensor        # (K, K) lower Cholesky factor of corr
    delta: torch.Tensor       # tenor = simulation step
    dt: torch.Tensor          # == delta
    shift: torch.Tensor       # displacement d >= 0

    #: ``simulate`` asks ``init_state`` for the run's dtype (the start is
    #: computed in it, not cast from float32).
    start_in_run_dtype = True
    exposure_discount_kind = "exact"

    @property
    def n_draws(self) -> int:
        return self.sigma.shape[0]

    @property
    def exposure_components(self):
        return tuple(f"f{k}" for k in range(self.n_draws)) + ("logb",)

    @classmethod
    def create(cls, f0, sigma=None, delta=None, *, corr=None,
               corr_beta=0.1, shift=0.0, vol_ttm=None, dt=None,
               dtype=torch.float32, device="cuda") -> "LMM":
        """The vol structure is one of ``sigma`` (a (K,) vector of constant
        vols or a (K, K) step table) or ``vol_ttm`` (the time-homogeneous
        table, ``sig_steps[t, k] = vol_ttm[k - t - 1]``); ``corr`` a (K, K)
        matrix or None for :func:`exp_decay_corr` at ``corr_beta``;
        ``dt``, when given, must equal ``delta``."""
        if delta is None:
            raise ValueError("delta (the tenor) is required")
        dev = resolve_device(device)
        traced = any(_requires_grad(v) for v in (f0, sigma, vol_ttm, shift))
        if traced:
            f0 = torch.as_tensor(f0, device=dev)
        else:
            f0 = np.asarray(_host(f0), np.float64)
        if f0.ndim != 1:
            raise ValueError("f0 must be 1-D")
        k = f0.shape[0]
        if (sigma is None) == (vol_ttm is None):
            raise ValueError("pass exactly one of sigma / vol_ttm")
        if vol_ttm is not None:
            if traced:
                ttm = torch.as_tensor(vol_ttm, device=dev)
            else:
                ttm = np.asarray(_host(vol_ttm))
            if tuple(ttm.shape) != (k,):
                raise ValueError(f"vol_ttm must be ({k},)")
            # sig_steps[t, k] = ttm[k - t - 1] for the live k > t.
            idx = np.arange(k)[None, :] - np.arange(k)[:, None] - 1
            gather = np.clip(idx, 0, k - 1)
            if traced:
                tab = torch.where(torch.as_tensor(idx >= 0, device=dev),
                                  ttm[torch.as_tensor(gather, device=dev)],
                                  torch.zeros_like(ttm)[0])
            else:
                tab = np.where(idx >= 0, ttm[gather], np.zeros_like(ttm)[0])
        else:
            sig = (torch.as_tensor(sigma, device=dev) if traced
                   else np.asarray(_host(sigma)))
            if tuple(sig.shape) == (k,):
                tab = (sig.expand(k, k) if traced
                       else np.broadcast_to(sig, (k, k)).copy())
            elif tuple(sig.shape) == (k, k):
                tab = sig
            else:
                raise ValueError(f"sigma must be ({k},) or ({k}, {k})")
        sig_vec = tab[0]
        if not traced:
            if float(shift) < 0.0:
                raise ValueError("shift must be nonnegative")
            if np.any(f0 + float(shift) <= 0.0):
                raise ValueError("shifted initial forwards f0 + shift must "
                                 "be positive (displaced-lognormal LMM)")
            if np.any(np.asarray(tab) < 0.0):
                raise ValueError("vols must be nonnegative")
        if dt is not None and abs(float(dt) - float(delta)) > 1e-12:
            raise ValueError(
                f"LMM simulates on the tenor grid: dt ({float(dt)}) must "
                f"equal delta ({float(delta)})")
        if corr is None:
            corr = exp_decay_corr(k, corr_beta, delta)
        corr = np.asarray(_host(corr), np.float64)
        if corr.shape != (k, k):
            raise ValueError(f"corr must be ({k}, {k})")
        chol = np.linalg.cholesky(corr + 1e-12 * np.eye(k))

        def as_(v):
            if torch.is_tensor(v):
                return v.to(device=dev, dtype=dtype)
            return torch.as_tensor(np.asarray(v), dtype=dtype, device=dev)

        return cls(f0=as_(f0), sigma=as_(sig_vec), sig_steps=as_(tab),
                   corr=as_(corr), corr_drift=as_(np.triu(corr)),
                   chol=as_(chol), delta=as_(float(delta)),
                   dt=as_(float(delta)), shift=as_(shift))

    def draws(self, seed, stream, path_ids, t, dtype=torch.float32):
        """The K normals of step ``t`` from one ``normal_matrix`` call,
        bitwise :meth:`NormalDrawsMixin.draws`."""
        z = normal_matrix(seed, stream, path_ids, t, self.n_draws, dtype)
        return torch.unbind(z, dim=-1)

    def init_state(self, path_ids, dtype=torch.float32) -> LMMState:
        n = path_ids.shape[0]
        logg0 = log32(self.f0.to(dtype) + self.shift.to(dtype)).to(dtype)
        return LMMState(
            logf=logg0[None, :].expand(n, self.n_draws).clone(),
            logb=torch.zeros(n, dtype=dtype, device=self.f0.device))

    def step(self, state: LMMState, eps, t) -> LMMState:
        dtype = state.logf.dtype
        k, t = self.n_draws, int(t)
        dlt, dt = self.delta.to(dtype), self.dt.to(dtype)
        d = self.shift.to(dtype)
        # Correlated shocks, true float32 (no TF32 on path state).
        z = factor_product(torch.stack(eps, dim=-1), self.chol.to(dtype).T)
        g = exp32(state.logf)                        # shifted forwards
        # The bank account compounds on the forward fixing now (index t);
        # steps past the last reset freeze everything.
        ti = min(t, k - 1)
        sig = self.sig_steps.to(dtype)[ti][None, :]  # (1, K)
        f_fix = g[:, ti] - d
        logb = state.logb + (torch.log1p(dlt * f_fix) if t < k
                             else torch.zeros_like(f_fix))
        alive = (torch.arange(k, device=g.device) > t)[None, :]
        cd = self.corr_drift.to(dtype)

        def drift(gv):
            # The bond-ratio vol of the shifted forwards:
            # delta sigma_j G_j / (1 + delta F_j).
            w = torch.where(alive, dlt * gv / (1.0 + dlt * (gv - d)) * sig,
                            0.0)
            return sig * factor_product(w, cd)

        mu0 = drift(g)
        half = 0.5 * sig * sig
        inc = sig * torch.sqrt(dt) * z
        pred = exp32(state.logf + (mu0 - half) * dt + inc)
        mu1 = drift(pred)
        logf = state.logf + torch.where(
            alive, (0.5 * (mu0 + mu1) - half) * dt + inc, 0.0)
        return LMMState(logf=logf, logb=logb)

    def prices(self, state: LMMState):
        """The generic engines' observation: the bank account B(t)."""
        return exp32(state.logb)

    # --- exposure protocol -----------------------------------------------
    def exposure_obs(self, state: LMMState):
        """(n_paths, K+1): the K forwards (dead ones frozen at their
        fixings; shift subtracted) and log B."""
        return torch.cat([exp32(state.logf) - self.shift.to(state.logf.dtype),
                          state.logb[:, None]], dim=-1)

    def pathwise_discount(self, obs):
        """Exact D(0, T_i) = 1/B(T_i) rows from (..., C, N) observations."""
        return exp32(-obs[..., -1, :])

    def wwr_state(self, obs):
        """The front forward F_{min(i, K-1)} at each date i (the
        just-fixed spot LIBOR) from (..., T+1, C, N) observations."""
        k = self.n_draws
        n_dates = obs.shape[-3]
        dates = torch.arange(n_dates, device=obs.device)
        return obs[..., dates, torch.clamp(dates, max=k - 1), :]

    def im_norm(self, dvs, obs, mpor):
        """Delta-normal IM std over the margin period from (T+1, K+1, N)
        sensitivities and observations: shocks ``(F_k + shift) sigma_k
        sqrt(mpor)`` of the forwards still live at each date, folded with
        the correlation; the log-B row carries none."""
        dtype = dvs.dtype
        k = self.n_draws
        n_dates = obs.shape[0]
        dates = torch.arange(n_dates, device=obs.device)
        alive = (torch.arange(k, device=obs.device)[None, :]
                 > dates[:, None]).to(dtype)                   # (T+1, K)
        sig_rows = self.sig_steps.to(dtype)[torch.clamp(dates, max=k - 1)]
        a = (dvs[..., :k, :] * (obs[..., :k, :] + self.shift.to(dtype))
             * sig_rows[:, :, None] * alive[:, :, None])
        q = torch.einsum("tjn,jk,tkn->tn", a, self.corr.to(dtype), a) \
            * torch.as_tensor(mpor, dtype=dtype, device=obs.device)
        # q is exactly 0 once every forward has fixed.
        return grad_safe_sqrt(q)


def lmm_zcb0(model: LMM, i: int) -> float:
    """P(0, T_i) off the initial curve: prod_{m<i} 1/(1 + delta f0_m)."""
    f0 = _host(model.f0).astype(np.float64)
    dlt = float(model.delta)
    return float(np.prod(1.0 / (1.0 + dlt * f0[:i])))


def lmm_swap_value_fn(model: LMM, strike: float, start_idx: int,
                      end_idx: int, dtype=None):
    """Payer-swap closure over the (K+1, N) state columns, unit notional,
    paying ``delta (F_j(T_j) - strike)`` at ``T_{j+1}`` for j in
    [start_idx, end_idx).  At grid date T_i the mark is the forward-curve
    closed form ``sum_{j >= max(i, start)} delta (F_j - K) P(T_i,
    T_{j+1})``, ``P(T_i, T_{j+1}) = prod_{m=i..j} 1/(1 + delta F_m)``; the
    j = i term reads the just-fixed forward.  The date ``t`` is read on
    the host, so a Python number costs no device sync."""
    if dtype is None:
        dtype = model.sigma.dtype
    k = int(model.sigma.shape[0])
    if not 0 <= start_idx < end_idx <= k:
        raise ValueError(f"need 0 <= start ({start_idx}) < end "
                         f"({end_idx}) <= K ({k})")
    dev = model.sigma.device
    kk = torch.as_tensor(strike, dtype=dtype, device=dev)
    dlt = model.delta.to(dtype)
    dlt_host = float(dlt)               # read once: no sync a date below
    j_idx = torch.arange(k, device=dev)[:, None]        # (K, 1)

    def value(cols, t):
        f = cols[:k].to(dtype)                          # (K, N)
        i = round(float(torch.as_tensor(t, dtype=dtype))
                  / dlt_host)                           # reset index
        dfac = torch.where(j_idx >= i, 1.0 / (1.0 + dlt * f), 1.0)
        p = torch.cumprod(dfac, dim=0)                  # P(T_i, T_{j+1})
        pay = (j_idx >= max(i, start_idx)) & (j_idx < end_idx)
        return torch.sum(torch.where(pay, dlt * (f - kk) * p, 0.0), dim=0)

    return value


def lmm_par_strike(model: LMM, start_idx: int, end_idx: int) -> float:
    """The t = 0 par swap rate for tenors [start_idx, end_idx)."""
    p = [lmm_zcb0(model, j + 1) for j in range(start_idx, end_idx)]
    p_s = lmm_zcb0(model, start_idx)
    return float((p_s - p[-1]) / (float(model.delta) * sum(p)))


def _observe_full(process, state):
    return process.exposure_obs(state)


def _black76(f, k, sd):
    """Undiscounted Black-76 call on a forward with total stddev ``sd``."""
    from scipy.stats import norm

    if sd <= 0.0:
        return max(f - k, 0.0)
    d1 = (np.log(f / k) + 0.5 * sd * sd) / sd
    return float(f * norm.cdf(d1) - k * norm.cdf(d1 - sd))


def _mean_se(pay, n_paths: int):
    return (float(torch.mean(pay)),
            float(torch.std(pay, correction=1) / np.sqrt(n_paths)))


def lmm_caplet_mc(model: LMM, k_idx: int, strike: float, n_paths: int, *,
                  seed: int, sampler=None, dtype=torch.float64) -> dict:
    """Monte Carlo caplet on F_{k_idx} (pays ``delta (F - K)+`` at
    T_{k_idx+1}), discounted exactly by the bank account, beside its Black
    closed form (exact under the lognormal LMM)."""
    from montecarlo_tpu_torch.engine.simulate import simulate

    k = int(model.sigma.shape[0])
    if not 0 <= k_idx < k:
        raise ValueError(f"k_idx must be in [0, {k})")
    obs = simulate(model, n_paths, k_idx + 1, seed=seed, sampler=sampler,
                   mode="terminal", dtype=dtype, observe=_observe_full)
    dlt = float(model.delta)
    pay = dlt * torch.clamp(obs[:, k_idx] - strike, min=0.0) \
        * torch.exp(-obs[:, -1])
    price, se = _mean_se(pay, n_paths)
    d = float(model.shift)
    # The exact piecewise-constant variance of log G_k at its reset.
    tab = _host(model.sig_steps).astype(np.float64)
    var_k = dlt * float(np.sum(np.square(tab[:k_idx, k_idx])))
    black = dlt * lmm_zcb0(model, k_idx + 1) * _black76(
        float(model.f0[k_idx]) + d, float(strike) + d, np.sqrt(var_k))
    return {"price": price, "std_err": se, "black": black,
            "n_paths": n_paths}


def lmm_swaption_rebonato(model: LMM, start_idx: int, end_idx: int,
                          strike: float) -> float:
    """The European payer swaption by Rebonato's frozen-weight swap-rate
    vol, Black on ``(S0 + shift, K + shift)`` with the exact piecewise
    covariance to expiry (host float64)."""
    dlt = float(model.delta)
    d = float(model.shift)
    f0 = _host(model.f0).astype(np.float64)
    tab = _host(model.sig_steps).astype(np.float64)
    corr = _host(model.corr).astype(np.float64)
    idx = np.arange(start_idx, end_idx)
    p = np.array([lmm_zcb0(model, j + 1) for j in idx])
    annuity = dlt * p.sum()
    s0 = (lmm_zcb0(model, start_idx) - p[-1]) / annuity
    w = dlt * p / annuity
    cov = dlt * tab[:start_idx, :].T @ tab[:start_idx, :]
    wf = w * (f0[idx] + d)
    var = float(wf @ (corr[np.ix_(idx, idx)]
                      * cov[np.ix_(idx, idx)]) @ wf) / ((s0 + d) ** 2)
    return annuity * _black76(s0 + d, float(strike) + d,
                              np.sqrt(max(var, 0.0)))


def lmm_swaption_mc(model: LMM, start_idx: int, end_idx: int,
                    strike: float, n_paths: int, *, seed: int,
                    sampler=None, dtype=torch.float64) -> dict:
    """Monte Carlo European payer swaption exercising at T_{start_idx}:
    the swap marked by the forward-curve closed form, discounted by the
    bank account; Rebonato's approximation beside it."""
    from montecarlo_tpu_torch.engine.simulate import simulate

    if start_idx < 1:
        raise ValueError("swaption expiry must be a future reset "
                         "(start_idx >= 1)")
    obs = simulate(model, n_paths, start_idx, seed=seed, sampler=sampler,
                   mode="terminal", dtype=dtype, observe=_observe_full)
    v_fn = lmm_swap_value_fn(model, strike, start_idx, end_idx, dtype=dtype)
    v = v_fn(obs.T, start_idx * float(model.delta))
    pay = torch.clamp(v, min=0.0) * torch.exp(-obs[:, -1])
    price, se = _mean_se(pay, n_paths)
    return {"price": price, "std_err": se,
            "rebonato": lmm_swaption_rebonato(model, start_idx, end_idx,
                                              strike),
            "n_paths": n_paths}


__all__ = ["LMM", "LMMState", "exp_decay_corr", "lmm_caplet_mc",
           "lmm_par_strike", "lmm_swap_value_fn", "lmm_swaption_mc",
           "lmm_swaption_rebonato", "lmm_zcb0"]
