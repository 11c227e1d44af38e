"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Every wrapper launches its kernel for a CUDA process and runs the plain
version for a CPU one; nothing falls back from one to the other.

- K1 ``gbm_terminal``         — csrc/gbm_kernel.cu
- K2 ``fused_terminal``       — csrc/fused_engine.cu
- K3 ``fused_block_moments``  — csrc/fused_engine.cu
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
    K3,
    fused_block_moments,
    fused_block_moments_reference,
    fused_terminal,
    fused_terminal_reference,
)

#: The kernels of the pricing path, by name.
PATH_KERNELS = {"gbm_terminal": K1, "fused_terminal": K2,
                "fused_block_moments": K3}


def reset_launch_counts() -> None:
    for k in PATH_KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    return {name: k.launches for name, k in PATH_KERNELS.items()}
