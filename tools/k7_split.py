"""Where K7's time goes on the card: its cipher against its correlation.

Builds ``csrc/basket_kernel.cu`` four ways into the ignored build directory:
as it is; with the draws written without the cipher (a cheap function of
the counters in place of Threefry and Box-Muller); with the correlation
and update left out; with both out.  Times each by CUDA events at
``bench --basket``'s 2^18 paths x 512 steps, A = 32 and 128, and samples
the SM clock and power by nvidia-smi while the full kernel runs.  The
three cut builds give no prices: they are timed, never compared.  The
cuts are made on a copy of the source's text, so the library's kernel has
no measurement switch.  Needs one CUDA card and nvcc; run from the root
of a checkout:

    python3 tools/k7_split.py
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# The text each cut replaces in basket_kernel.cu, and what replaces it.
CIPHER = """    mc::threefry2x32_lanes<U>(k0, k1, c0, c1, b0, b1);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      mc::boxmuller_pair(b0[u], b1[u], z0 + u * dz, z1 + u * dz);
    }
"""
NO_CIPHER = """    (void)b0;
    (void)b1;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      z0[u * dz] = (float)(c1[u] & 7u) * 0.125f;
      z1[u * dz] = (float)(c0[u] & 7u) * 0.125f;
    }
"""
CORRELATION = "    k7::step_pair<Tr>(s, o, 2 * j + 1 < n_steps, log_s);\n"
CUTS = {"full": (), "no cipher": ("cipher",),
        "no correlation": ("correlation",),
        "neither": ("cipher", "correlation")}


def cut_source(text: str, cuts) -> str:
    for cut in cuts:
        old, new = {"cipher": (CIPHER, NO_CIPHER),
                    "correlation": (CORRELATION, "")}[cut]
        if text.count(old) != 1:
            raise RuntimeError(f"basket_kernel.cu: the {cut} text to cut is "
                               f"not there once; bring this script up to "
                               f"date with the kernel")
        text = text.replace(old, new)
    return text


def build(name: str, cuts) -> ctypes.CDLL:
    """K7 alone (the cut basket_kernel.cu and common.cu), built with the
    library's nvcc flags; the loaded library."""
    from montecarlo_tpu_torch.ops import _build
    from montecarlo_tpu_torch.ops.basket_kernel import K7

    out = _build.BUILD_DIR / "k7_split" / name.replace(" ", "_")
    out.mkdir(parents=True, exist_ok=True)
    src = out / "basket_kernel.cu"
    src.write_text(cut_source((_build.CSRC / "basket_kernel.cu").read_text(),
                              cuts))
    nvcc = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC)]

    def run(cmd):
        _build._finish(cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))

    objs = [out / "basket_kernel.o", out / "common.o"]
    run([*nvcc, "-c", "-o", str(objs[0]), str(src)])
    run([*nvcc, "-c", "-o", str(objs[1]), str(_build.CSRC / "common.cu")])
    so = out / "libk7.so"
    run([*nvcc, "-shared", "-o", str(so), *map(str, objs)])
    lib = ctypes.CDLL(str(so))
    lib.mc_packed_basket_terminal.argtypes = K7.argtypes
    lib.mc_packed_basket_terminal.restype = ctypes.c_int
    return lib


def cuda_ms(torch, fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` by CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k7_split: no CUDA card", file=sys.stderr)
        return 1
    from montecarlo_tpu_torch.bench import (BASKET_PATHS, BASKET_STEPS,
                                            bench_basket)
    from montecarlo_tpu_torch.ops.basket_kernel import _constants
    from montecarlo_tpu_torch.rng.threefry import key_from_seed

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    with ThreadPoolExecutor(len(CUTS)) as ex:
        libs = dict(zip(CUTS, ex.map(build, CUTS, CUTS.values())))
    n, t = BASKET_PATHS, BASKET_STEPS
    stream = torch.cuda.current_stream().cuda_stream
    k0, k1 = key_from_seed(1000)
    for a_n in (32, 128):
        basket = bench_basket(a_n)
        params = _constants(basket).contiguous()
        out = torch.empty(n, dtype=torch.float32, device="cuda")

        def launch(lib):
            err = lib.mc_packed_basket_terminal(
                out.data_ptr(), params.data_ptr(),
                basket.chol_flat.data_ptr(), a_n, n, t, 0, k0, k1, stream)
            if err:
                raise RuntimeError(f"K7 split launch: CUDA error {err}")

        ms = {name: cuda_ms(torch, lambda: launch(lib), 3)
              for name, lib in libs.items()}
        clocks = ""
        if a_n == 128:
            smi = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader", "-lms", "250"],
                stdout=subprocess.PIPE, text=True)
            try:
                cuda_ms(torch, lambda: launch(libs["full"]), 20)
            finally:
                smi.terminate()
                samples = smi.communicate(timeout=30)[0]
            clocks = (f"; SM clock, power while it runs: "
                      f"{samples.strip().splitlines()[2:-1]}")
        print(f"K7 split A={a_n} {n}x{t}: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in ms.items()) +
            f"; cipher {ms['full'] - ms['no cipher']:.3f} ms, correlation "
            f"{ms['full'] - ms['no correlation']:.3f} ms of the full "
            f"kernel's{clocks}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
