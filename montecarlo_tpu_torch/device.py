"""Device selection: a CUDA request on a machine without a card is an error,
never a silent move to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` for ``device`` ("cuda", "cuda:N", "cpu" or a
    ``torch.device``).  Raises ``RuntimeError`` when CUDA is asked for and no
    card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available "
            "(pass device='cpu' to run the plain PyTorch versions)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
