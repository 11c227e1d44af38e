"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Every wrapper launches its kernel for a CUDA process and runs the plain
version for a CPU one; nothing falls back from one to the other.

- K1 ``gbm_terminal``         — csrc/gbm_kernel.cu
- K2 ``fused_terminal``       — csrc/fused_engine.cu
- K3 ``fused_block_moments``  — csrc/fused_engine.cu
- K4 ``fused_functionals``    — csrc/fused_k4.cu
  (each under Threefry, Sobol and bridge-Sobol draws, counted apart as
  ``<name>``, ``<name>_sobol`` and ``<name>_bridge``; K4's launches of a
  fold fixed at compile time also as ``fused_functionals_fixed[_sobol|
  _bridge]``; the basket's in csrc/fused_basket*.cu, the rate and
  term-structure processes' in csrc/fused_rates.cu, the term basket's,
  CCC-GARCH's and DCC-GARCH's in csrc/fused_term_basket{,_k4}.cu,
  fused_ccc.cu and fused_dcc{,_k4}.cu)
- K4 on price snapshots ``fused_snapshots`` — csrc/fused_k4_snapshot.cu
  (counted as ``fused_functionals_snapshot[_sobol|_bridge]``, not as K4's)
- ``surface_rows``            — csrc/fused_engine.cu: the row builder of
  the surfaces on time knots (local vol, SLV on knots), whose rows K2-K4
  read; once per (process, n_steps)
- K5 ``normal_matrix``        — csrc/rng_kernel.cu
- K6 ``rbergomi_terminal``    — csrc/rbergomi_kernel.cu
  (its ring form, and its plain-load form for n_paths % 4 != 0 counted
  apart as ``rbergomi_terminal_unaligned``)
- K7 ``packed_basket_terminal`` — csrc/basket_kernel.cu
- K0 (device math in every kernel) — csrc/rng.cuh, checked on the card
  through ``rng_check`` (csrc/rng_check.cu)
"""

from montecarlo_tpu_torch.ops.gbm_kernel import (  # noqa: F401
    K1,
    gbm_terminal,
    gbm_terminal_reference,
)
from montecarlo_tpu_torch.ops.fused_engine import (  # noqa: F401
    K2,
    K2_BRIDGE,
    K2_SOBOL,
    K3,
    K3_BRIDGE,
    K3_SOBOL,
    K4,
    K4_BRIDGE,
    K4_FIXED,
    K4_FIXED_BRIDGE,
    K4_FIXED_SOBOL,
    K4_SNAPSHOT,
    K4_SNAPSHOT_BRIDGE,
    K4_SNAPSHOT_SOBOL,
    K4_SOBOL,
    SURFACE_ROWS,
    fused_block_moments,
    fused_block_moments_reference,
    fused_functionals,
    fused_functionals_reference,
    fused_snapshots,
    fused_snapshots_reference,
    fused_terminal,
    fused_terminal_reference,
    surface_rows,
)
from montecarlo_tpu_torch.ops.rng_kernel import (  # noqa: F401
    K5,
    normal_matrix,
    normal_matrix_reference,
)
from montecarlo_tpu_torch.ops.rbergomi_kernel import (  # noqa: F401
    K6,
    K6_UNALIGNED,
    rbergomi_terminal,
    rbergomi_terminal_reference,
)
from montecarlo_tpu_torch.ops.basket_kernel import (  # noqa: F401
    K7,
    packed_basket_terminal,
    packed_basket_terminal_reference,
)

#: The kernels of the pricing paths, by name.
PATH_KERNELS = {"gbm_terminal": K1, "fused_terminal": K2,
                "fused_block_moments": K3, "fused_functionals": K4,
                "normal_matrix": K5, "rbergomi_terminal": K6,
                "rbergomi_terminal_unaligned": K6_UNALIGNED,
                "packed_basket_terminal": K7,
                "fused_terminal_sobol": K2_SOBOL,
                "fused_block_moments_sobol": K3_SOBOL,
                "fused_functionals_sobol": K4_SOBOL,
                "fused_terminal_bridge": K2_BRIDGE,
                "fused_block_moments_bridge": K3_BRIDGE,
                "fused_functionals_bridge": K4_BRIDGE,
                "fused_functionals_fixed": K4_FIXED,
                "fused_functionals_fixed_sobol": K4_FIXED_SOBOL,
                "fused_functionals_fixed_bridge": K4_FIXED_BRIDGE,
                "fused_functionals_snapshot": K4_SNAPSHOT,
                "fused_functionals_snapshot_sobol": K4_SNAPSHOT_SOBOL,
                "fused_functionals_snapshot_bridge": K4_SNAPSHOT_BRIDGE,
                "surface_rows": SURFACE_ROWS}


def reset_launch_counts() -> None:
    for k in PATH_KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    return {name: k.launches for name, k in PATH_KERNELS.items()}
