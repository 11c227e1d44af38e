"""Meshes of ranks over ``torch.distributed`` and the sharded estimators."""

from montecarlo_tpu_torch.parallel.mesh import (  # noqa: F401
    ASSETS_AXIS,
    PATHS_AXIS,
    SLICES_AXIS,
    Mesh,
    make_mesh,
    subgroup,
)
from montecarlo_tpu_torch.parallel.sharded import (  # noqa: F401
    DEFAULT_BLOCK,
    block_moments,
    sharded_andersen_broadie_bound,
    sharded_basket_estimate,
    sharded_functional_estimate,
    sharded_lsm_price,
    sharded_mc_estimate,
    sharded_path_percentiles,
    sharded_price_and_greeks,
    sharded_rbergomi_estimate,
    sharded_terminal,
    sharded_terminal_sketch,
)
