"""Stochastic processes (GBM, Heston, the correlated GBM basket, MultiGBM,
the bootstrap GARCH, the jump processes Merton, Kou and Bates, the Levy
processes NIG and variance gamma, HestonQE, BatesQE, SABR, local
volatility and stochastic-local volatility with its particle calibration
and the Dupire surface, Euler GBM and term-structure GBM, the short rates
Vasicek, CIR and Hull-White and the two-factor G2++, the multi-asset
state processes TermBasketGBM, CCC-GARCH and DCC-GARCH, the LIBOR market
model, the equity-Vasicek hybrid and Heston with its accrued variance)
and the rough-Bergomi sampler."""

from montecarlo_tpu_torch.processes.base import (  # noqa: F401
    NormalDrawsMixin,
    curve_at,
    grad_safe_sqrt,
)
from montecarlo_tpu_torch.processes.basket import BasketGBM  # noqa: F401
from montecarlo_tpu_torch.processes.bates import (  # noqa: F401
    Bates,
    bates_log_cf,
)
from montecarlo_tpu_torch.processes.bates_qe import BatesQE  # noqa: F401
from montecarlo_tpu_torch.processes.ccc_garch import CCCGarch  # noqa: F401
from montecarlo_tpu_torch.processes.dcc_garch import DCCGarch  # noqa: F401
from montecarlo_tpu_torch.processes.euler_gbm import EulerGBM  # noqa: F401
from montecarlo_tpu_torch.processes.g2pp import (  # noqa: F401
    G2PP,
    G2State,
    g2pp_bond,
    g2pp_swaption,
    g2pp_v,
    g2pp_zcb,
)
from montecarlo_tpu_torch.processes.garch import (  # noqa: F401
    MIN_HISTORY,
    GARCHBootstrap,
    GARCHState,
)
from montecarlo_tpu_torch.processes.gbm import GBM, GBMState  # noqa: F401
from montecarlo_tpu_torch.processes.heston import (  # noqa: F401
    Heston,
    HestonState,
)
from montecarlo_tpu_torch.processes.heston_exposure import (  # noqa: F401
    HestonExposure,
    HestonExposureState,
    heston_forward_value_fn,
    heston_varswap_expected_total,
    heston_varswap_value_fn,
)
from montecarlo_tpu_torch.processes.heston_qe import HestonQE  # noqa: F401
from montecarlo_tpu_torch.processes.hybrid import (  # noqa: F401
    EquityVasicekHybrid,
    HybridState,
    hybrid_call_closed_form,
    hybrid_price_mc,
)
from montecarlo_tpu_torch.processes.kou import Kou  # noqa: F401
from montecarlo_tpu_torch.processes.lmm import (  # noqa: F401
    LMM,
    LMMState,
    exp_decay_corr,
    lmm_caplet_mc,
    lmm_par_strike,
    lmm_swap_value_fn,
    lmm_swaption_mc,
    lmm_swaption_rebonato,
    lmm_zcb0,
)
from montecarlo_tpu_torch.processes.local_vol import (  # noqa: F401
    LocalVolGBM,
    LocalVolState,
)
from montecarlo_tpu_torch.processes.merton import (  # noqa: F401
    Merton,
    merton_call_series,
)
from montecarlo_tpu_torch.processes.multi_gbm import (  # noqa: F401
    MultiGBM,
    MultiGBMState,
)
from montecarlo_tpu_torch.processes.nig import NIG  # noqa: F401
from montecarlo_tpu_torch.processes.rough_bergomi import (  # noqa: F401
    RoughBergomi,
    rbergomi_simulate,
    volterra_joint_chol,
)
from montecarlo_tpu_torch.processes.sabr import (  # noqa: F401
    SABR,
    calibrate_sabr,
    sabr_hagan_iv,
)
from montecarlo_tpu_torch.processes.shortrate import (  # noqa: F401
    CIR,
    HullWhite,
    RateState,
    Vasicek,
)
from montecarlo_tpu_torch.processes.slv import (  # noqa: F401
    SLV,
    SLVKnots,
    SLVState,
    calibrate_slv,
    slv_to_kernel,
)
from montecarlo_tpu_torch.processes.term_basket import (  # noqa: F401
    TermBasketGBM,
)
from montecarlo_tpu_torch.processes.term_gbm import (  # noqa: F401
    TermStructureGBM,
)
from montecarlo_tpu_torch.processes.vg import VarianceGamma  # noqa: F401
