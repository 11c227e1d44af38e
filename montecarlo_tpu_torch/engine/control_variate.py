"""Control variates, the port of ``montecarlo_tpu/engine/control_variate.py``.

For a payoff Y and a control X with known expectation E[X] (the terminal
price under the risk-neutral drift: E[S_T] = S0 e^{rT}) the controlled
estimator

    Y_cv = Y - beta (X - E[X]),   beta* = Cov(Y, X) / Var(X)

is unbiased, with its variance reduced by the squared correlation.  beta is
estimated from the same sample (an O(1/n) bias, negligible at Monte Carlo
scale).
"""

from __future__ import annotations

import torch

from montecarlo_tpu_torch.stats.welford import moments_from_array, std_error


def cv_estimate(payoffs, control, control_mean, discount=1.0) -> dict:
    """Control-variate estimator with the sample-optimal beta, in the
    payoffs' dtype and on their device.  Returns ``{"price", "std_err",
    "n_paths", "beta", "variance_ratio"}``, ``variance_ratio`` being
    Var(controlled) / Var(plain), below 1 when the control helps."""
    y = torch.as_tensor(payoffs)
    x = torch.as_tensor(control, dtype=y.dtype, device=y.device)
    d = torch.as_tensor(discount, dtype=y.dtype, device=y.device)
    mu = torch.as_tensor(control_mean, dtype=y.dtype, device=y.device)

    x_c = x - torch.mean(x)
    y_c = y - torch.mean(y)
    var_x = torch.mean(torch.square(x_c))
    beta = torch.sum(x_c * y_c) / torch.clamp(var_x * x.shape[0], min=1e-30)

    adjusted = y - beta * (x - mu)
    st = moments_from_array(adjusted, axis=0)
    plain = moments_from_array(y, axis=0)
    return {
        "price": d * st.mean,
        "std_err": d * std_error(st),
        "n_paths": st.count,
        "beta": beta,
        "variance_ratio": st.m2 / torch.clamp(plain.m2, min=1e-30),
    }
