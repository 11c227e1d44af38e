"""The port's CLI (`python -m montecarlo_tpu_torch price ... --device cpu`)
against the JAX CLI given the same flags: the same keys, values within
rtol 1e-5 (same paths; normals within 1e-6 and float32 sums in each
framework's own order), the same path count.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from montecarlo_tpu.cli import main as jax_main
from montecarlo_tpu_torch.cli import main as port_main

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _run(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("flags", [
    ["--paths", "2048", "--steps", "16"],
    ["--paths", "2048", "--steps", "17", "--payoff", "put",
     "--sampler", "antithetic"],
    ["--paths", "2000", "--steps", "16", "--payoff", "digital",
     "--strike", "98.5", "--seed", "3"],
    ["--target-se", "0.05", "--steps", "8", "--s0", "95", "--sigma", "0.3"],
])
def test_price_matches_jax_cli(flags, capsys):
    want = _run(jax_main, ["price", *flags], capsys)
    got = _run(port_main, ["price", *flags, "--device", "cpu"], capsys)
    assert sorted(got) == sorted(want)
    assert got["n_paths"] == want["n_paths"]
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k


def test_device_cuda_is_an_error_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        port_main(["price", "--paths", "128", "--steps", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(["bench"])
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("argv", [
    ["price", "--process", "heston"],
    ["price", "--sampler", "sobol"],
    ["price", "--payoff", "asian"],
    ["price", "--device", "cpu", "--target-se", "0.1", "--sampler",
     "antithetic"],
])
def test_unported_choices_are_clean_errors(argv, capsys):
    with pytest.raises(SystemExit) as e:
        port_main(argv)
    assert e.value.code != 0
    assert capsys.readouterr().out == ""


def test_python_dash_m_entry_point():
    out = subprocess.run(
        [sys.executable, "-m", "montecarlo_tpu_torch", "price", "--device",
         "cpu", "--paths", "512", "--steps", "4"],
        cwd=ROOT, capture_output=True, text=True, timeout=120, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(res) == {"price", "std_err", "n_paths", "black_scholes"}
    assert res["n_paths"] == 512
