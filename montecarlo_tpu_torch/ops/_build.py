"""Build the CUDA kernels of ``csrc/`` with nvcc and bind them with ctypes.

The library is compiled on first use into ``montecarlo_tpu_torch/_build/``,
keyed by a hash of the sources and the flags, so a checkout builds
everything it needs by itself and a changed source never loads a stale
library.  Each ``extern "C"`` entry takes raw device pointers, counts and
the CUDA stream, launches on that stream and returns ``cudaGetLastError()``.

Flags: ``sm_90a`` (Hopper), ``-fmad=false`` so every ``a*b+c`` rounds twice
as the torch plain versions do, IEEE division and square root
(``-prec-div=true -prec-sqrt=true``, what the kernels' plain versions and
the JAX package compute), and never ``--use_fast_math``.  Each source is
compiled by its own nvcc process, all started together, then linked.
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
              "-O3", "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
              "-Xcompiler", "-fPIC")


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


def build(extra_flags=()) -> str:
    """Compile the library if it is missing; returns the compilers'
    messages ("" when it was there), then one line per source with the
    seconds its nvcc took.  ``extra_flags`` go to each compile without
    entering the library's hash: only flags that change no code, such as
    ``("-Xptxas", "-v")`` for the registers and spills."""
    so = library_path()
    if so.exists():
        return ""
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc, tag = _nvcc(), f"{so.stem}.{os.getpid()}"
    jobs = []
    t0 = time.perf_counter()
    for src in _sources()[0]:
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        log = obj.with_suffix(".log")
        cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-c", "-o", str(obj),
               str(src)]
        # Output to a file: a full pipe would stall a compile until its
        # turn to be read.
        with open(log, "w") as f:
            proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
        jobs.append((src, obj, log, cmd, proc))
    seconds = _wait_all([job[-1] for job in jobs], t0)
    logs, times = [], []
    for (src, obj, log, cmd, proc), sec in zip(jobs, seconds):
        out = log.read_text()
        log.unlink()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
        logs.append(out)
        times.append(f"nvcc {src.name}: {sec:.1f} s\n")
    objs = [job[1] for job in jobs]
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
            *(str(o) for o in objs)]
    _finish(link, subprocess.Popen(link, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True))
    for o in objs:
        o.unlink()
    os.replace(tmp, so)  # atomic: concurrent builders never load half a file
    return "".join(logs + times)


def _wait_all(procs, t0) -> list:
    """Wait for every process; the seconds from ``t0`` to each one's end."""
    done = [None] * len(procs)
    while None in done:
        for k, p in enumerate(procs):
            if done[k] is None and p.poll() is not None:
                done[k] = time.perf_counter() - t0
        time.sleep(0.05)
    return done


def _finish(cmd, proc) -> str:
    """Wait for one nvcc process; raise with its output if it failed."""
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{out}")
    return out


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


def check_no_grad(process) -> None:
    """Raise ``TypeError`` when grad mode is on and a leaf of ``process``
    (a process dataclass) requires grad.  The kernels are launched on
    ``data_ptr()`` and define no backward, so their output would carry no
    autograd graph, and their plain versions refuse too, so that the CPU
    shows what the card does.  Every wrapper asks before it runs either."""
    import dataclasses

    import torch

    if not torch.is_grad_enabled():
        return
    for f in dataclasses.fields(process):
        v = getattr(process, f.name)
        if torch.is_tensor(v) and v.requires_grad:
            raise TypeError(
                f"{type(process).__name__}.{f.name} requires grad, and the "
                "kernels define no backward: differentiate through the "
                "torch time loop, engine.simulate, as "
                "engine.greeks.price_and_greeks does (or run under "
                "torch.no_grad())")
