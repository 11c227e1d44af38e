"""Carry a JAX process's parameters across to the port.

``process_from_numpy(kind, fields, device)`` builds the port's process from
numpy leaves, with ``fields = {k: np.asarray(v) for k, v in
jax_proc._asdict().items()}``, so a test can build both sides from one
numpy source.  Floating leaves become float32 tensors and integer leaves
keep their integer type.  The bootstrap GARCH carries its table and the
table's length: JAX pads the table to a multiple of 128, and the port keeps
its ``n_table`` valid entries (``GARCHBootstrap.numpy_fields``).  The
variance gamma carries its quantile table (two 512-entry leaves) and the
QE processes their create-time constants, as leaves like any other, and
the local-vol surfaces their tables (SLV's ``lev_rows`` keeps its
(n_steps, 128) shape).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from montecarlo_tpu_torch.device import resolve_device
from montecarlo_tpu_torch.processes import (NIG, SABR, SLV, BasketGBM,
                                            Bates, BatesQE, GARCHBootstrap,
                                            GBM, Heston, HestonQE, Kou,
                                            LocalVolGBM, Merton, MultiGBM,
                                            RoughBergomi, SLVKnots,
                                            VarianceGamma)

PROCESSES = {"gbm": GBM, "heston": Heston, "rbergomi": RoughBergomi,
             "basket": BasketGBM, "multigbm": MultiGBM,
             "garch": GARCHBootstrap, "merton": Merton, "kou": Kou,
             "bates": Bates, "nig": NIG, "heston-qe": HestonQE,
             "bates-qe": BatesQE, "vg": VarianceGamma, "sabr": SABR,
             "local-vol": LocalVolGBM, "slv": SLV, "slv-knots": SLVKnots}


def _tensor(name: str, value, device) -> torch.Tensor:
    arr = np.asarray(value)
    if np.issubdtype(arr.dtype, np.floating):
        arr = arr.astype(np.float32)
    elif not np.issubdtype(arr.dtype, np.integer):
        raise TypeError(f"field {name!r}: unsupported dtype {arr.dtype}")
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def process_from_numpy(kind: str, fields: dict, device="cuda"):
    """The port's ``kind`` process from a dict of numpy leaves."""
    cls = PROCESSES[kind]
    names = [f.name for f in dataclasses.fields(cls)]
    if sorted(fields) != sorted(names):
        raise ValueError(f"{kind} takes fields {names}, got {sorted(fields)}")
    dev = resolve_device(device)
    if hasattr(cls, "numpy_fields"):
        fields = cls.numpy_fields(fields)
    return cls(**{k: _tensor(k, fields[k], dev) for k in names})


def process_to_numpy(process) -> dict:
    """The inverse: a dict of numpy leaves, in field order."""
    return {f.name: getattr(process, f.name).cpu().numpy()
            for f in dataclasses.fields(process)}
