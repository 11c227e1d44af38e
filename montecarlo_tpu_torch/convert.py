"""Carry a JAX process's parameters across to the port.

``process_from_numpy(kind, fields, device)`` builds the port's process from
numpy leaves, with ``fields = {k: np.asarray(v) for k, v in
jax_proc._asdict().items()}``, so a test can build both sides from one
numpy source.  Floating leaves become float32 tensors and integer leaves
keep their integer type (a process with a lookup table and its length, such
as the bootstrap GARCH, registers its class here the same way).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from montecarlo_tpu_torch.device import resolve_device
from montecarlo_tpu_torch.processes.gbm import GBM

PROCESSES = {"gbm": GBM}


def _tensor(name: str, value, device) -> torch.Tensor:
    arr = np.asarray(value)
    if np.issubdtype(arr.dtype, np.floating):
        arr = arr.astype(np.float32)
    elif not np.issubdtype(arr.dtype, np.integer):
        raise TypeError(f"field {name!r}: unsupported dtype {arr.dtype}")
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def process_from_numpy(kind: str, fields: dict, device="cpu"):
    """The port's ``kind`` process from a dict of numpy leaves."""
    cls = PROCESSES[kind]
    names = [f.name for f in dataclasses.fields(cls)]
    if sorted(fields) != sorted(names):
        raise ValueError(f"{kind} takes fields {names}, got {sorted(fields)}")
    dev = resolve_device(device)
    return cls(**{k: _tensor(k, fields[k], dev) for k in names})


def process_to_numpy(process) -> dict:
    """The inverse: a dict of numpy leaves, in field order."""
    return {f.name: getattr(process, f.name).cpu().numpy()
            for f in dataclasses.fields(process)}
