"""Build the CUDA kernels of ``csrc/`` with nvcc and bind them with ctypes.

The library is compiled on first use into ``montecarlo_tpu_torch/_build/``,
keyed by a hash of the sources and the flags, so a checkout builds
everything it needs by itself and a changed source never loads a stale
library.  Each ``extern "C"`` entry takes raw device pointers, counts and
the CUDA stream, launches on that stream and returns ``cudaGetLastError()``.

Flags: ``sm_90a`` (Hopper), ``-fmad=false`` so every ``a*b+c`` rounds twice
as the torch plain versions do, and never ``--use_fast_math``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sum(_sources(), []):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libmc_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and Path(c).exists():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from montecarlo_tpu_torch/csrc on first use")


def build() -> float:
    """Compile the library if it is missing; returns the seconds spent."""
    so = library_path()
    if so.exists():
        return 0.0
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in _sources()[0])]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)  # atomic: concurrent builders never load half a file
    return time.perf_counter() - t0


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    build()
    lib = ctypes.CDLL(str(library_path()))
    lib.mc_error_string.argtypes = [ctypes.c_int]
    lib.mc_error_string.restype = ctypes.c_char_p
    return lib


class CudaKernel:
    """One ``extern "C"`` entry of the library and its launch count.

    ``launches`` goes up by one for each successful launch and nowhere
    else, so a run can show that its main path went through the kernel.
    """

    def __init__(self, symbol: str, argtypes):
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0

    def launch(self, *args) -> None:
        lib = load_library()
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: launch failed, CUDA error "
                               f"{err} ({lib.mc_error_string(err).decode()})")
        self.launches += 1


def cuda_stream(device) -> ctypes.c_void_p:
    """The current torch stream of ``device`` as a ctypes pointer."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_cuda_tensor(name: str, t, device, dtype) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device``."""
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor on "
                         f"{device}, got {t.dtype} on {t.device}")
