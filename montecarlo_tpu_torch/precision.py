"""Float32 products that keep every mantissa bit, whatever the process-wide
matmul setting."""

from __future__ import annotations

import torch


def factor_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in true float32 whatever the process-wide setting: rough
    Bergomi's ``chol @ z`` (the (2T, N) joint matrix from (2T, N) normals)
    and MultiGBM's per-step correlation ``z @ chol.T``.  TF32 keeps 10
    mantissa bits and would distort the sampled covariance, as the TPU's
    bf16 passes do in the JAX package, which takes these products at
    ``Precision.HIGHEST``.  A plain product outside any kernel, as the JAX
    package leaves it to XLA.  Both the legacy and the newer precision
    settings are put back as they were."""
    try:
        legacy = torch.get_float32_matmul_precision()
    except RuntimeError:  # the two settings disagree; the newer one rules
        legacy = None
    matmul = torch.backends.cuda.matmul
    newer = getattr(matmul, "fp32_precision", None)
    torch.set_float32_matmul_precision("highest")
    try:
        return torch.matmul(a, b)
    finally:
        if legacy is not None:
            torch.set_float32_matmul_precision(legacy)
        if newer is not None:
            matmul.fp32_precision = newer
