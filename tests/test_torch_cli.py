"""The port's CLI (`python -m montecarlo_tpu_torch price|note ... --device
cpu`) against the JAX CLI given the same flags: the same keys, values
within rtol 1e-5 (same paths; normals within 1e-6 and float32 sums in each
framework's own order), the same path count.

Rough Bergomi (``--process rbergomi``) is held to rtol 1e-5: the port
follows K6's float order where the JAX CPU path runs its XLA tail (measured
within 3.8e-6 per path, tests/test_torch_rbergomi.py).

A payoff with a discontinuity (a discretely monitored barrier, the
autocall's trigger and capital barrier) can flip on a path that sits on it
within the normals' difference.  Those runs allow FLIPS such paths: the
rtol 1e-5 plus FLIPS times the largest jump of one path's payoff over the
path count.  American exercise (``--american``) is such a run too: an
exercise decision flips where the two packages' float32 regressions
(sums in two orders, ~1e-6 apart) straddle a path's payoff, and a flipped
path moves by at most its payoff's range (the strike for a put, the
largest payoff for a call), so the price and std-err allow FLIPS such
paths.  The Andersen-Broadie bound takes no decision, but its surrogate
is a float32 least-squares fit (up to 21 basis terms for Heston's degree
5), whose betas move with the sums' order: ``upper_bound`` and
``upper_bound_std_err`` within AB_SHARE = 5% of the bound's std-err (the
measured gap is below 1.5%).
"""

import ast
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


@pytest.mark.parametrize("flags", [
    [],
    ["--payoff", "put"],
    ["--hurst", "0.3", "--eta", "1.9", "--rho", "-0.9"],
])
def test_price_rbergomi_matches_jax_cli(flags, capsys):
    argv = ["price", "--process", "rbergomi", "--paths", "4096", "--steps",
            "16", *flags]
    want = _run(jax_main, argv, capsys)
    got = _run(port_main, [*argv, "--device", "cpu"], capsys)
    assert sorted(got) == sorted(want) == ["hurst", "n_paths", "price",
                                           "std_err"]
    assert got["n_paths"] == want["n_paths"] == 4096
    assert got["hurst"] == want["hurst"]
    for k in ("price", "std_err"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k


@pytest.mark.parametrize("flags", [
    ["--sampler", "antithetic"],
    ["--target-se", "0.1"],
    ["--payoff", "asian"],
])
def test_rbergomi_guards_exit_as_in_jax(flags, capsys):
    argv = ["price", "--process", "rbergomi", "--paths", "256", "--steps",
            "4", *flags]
    for main, extra in ((jax_main, []), (port_main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            main([*argv, *extra])
        assert e.value.code not in (0, None)
        assert capsys.readouterr().out == ""


FLIPS = 1
AB_SHARE = 0.05


@pytest.mark.parametrize("flags,jump", [
    (["--payoff", "asian", "--paths", "2048", "--steps", "16"], 0.0),
    (["--payoff", "asian", "--paths", "2048", "--steps", "17",
      "--sampler", "antithetic"], 0.0),
    (["--payoff", "lookback", "--paths", "2048", "--steps", "17"], 0.0),
    (["--payoff", "up-and-out", "--paths", "2048", "--steps", "16",
      "--barrier", "110"], 5.0),
    (["--payoff", "up-and-in", "--paths", "2048", "--steps", "17",
      "--barrier", "110"], 5.0),
    (["--payoff", "up-and-out", "--bridge", "--paths", "2048", "--steps",
      "16", "--barrier", "112"], 0.0),
    (["--payoff", "up-and-in", "--bridge", "--paths", "2048", "--steps",
      "17"], 0.0),
    (["--process", "heston", "--payoff", "asian", "--paths", "2048",
      "--steps", "17"], 0.0),
    (["--process", "heston", "--payoff", "up-and-out", "--paths", "2048",
      "--steps", "16", "--barrier", "110", "--sampler", "antithetic"], 5.0),
    (["--process", "heston", "--paths", "2048", "--steps", "16"], 0.0),
    (["--process", "heston", "--target-se", "0.1", "--steps", "8"], 0.0),
])
def test_price_path_dependent_and_heston_match_jax_cli(flags, jump, capsys):
    """``jump``: the most one flipped path moves its discounted payoff (a
    barrier at 110 on a 105 call: 5)."""
    want = _run(jax_main, ["price", *flags], capsys)
    got = _run(port_main, ["price", *flags, "--device", "cpu"], capsys)
    assert sorted(got) == sorted(want) == ["n_paths", "price", "std_err"]
    assert got["n_paths"] == want["n_paths"]
    for k in ("price", "std_err"):
        tol = 1e-5 * abs(want[k]) + FLIPS * jump / want["n_paths"]
        assert abs(got[k] - want[k]) <= tol, k


@pytest.mark.parametrize("flags,jump", [
    (["--type", "autocall", "--paths", "2048", "--steps", "16"], 1.1),
    (["--type", "autocall", "--paths", "2048", "--steps", "17",
      "--observations", "3", "--s0", "1", "--trigger", "1.01",
      "--pdi-barrier", "0.9"], 1.1),
    (["--type", "cliquet", "--paths", "2048", "--steps", "16"], 0.0),
])
def test_note_matches_jax_cli(flags, jump, capsys):
    """``jump``: a flipped autocall path moves by at most 1 + coupons."""
    want = _run(jax_main, ["note", *flags], capsys)
    got = _run(port_main, ["note", *flags, "--device", "cpu"], capsys)
    assert sorted(got) == sorted(want)
    for k in want:
        tol = 1e-5 * abs(want[k]) + FLIPS * jump / want["n_paths"]
        assert abs(got[k] - want[k]) <= tol, k


@pytest.mark.parametrize("flags", [
    ["--n-assets", "2"],
    ["--n-assets", "5", "--asset-corr", "0.5", "--div", "0.01",
     "--steps", "17", "--seed", "4"],
])
def test_price_max_call_matches_jax_cli(flags, capsys):
    """The best-of-A call through MultiGBM's torch loop against the JAX
    CLI's scan: the payoff is continuous in the prices, rtol 1e-5."""
    argv = ["price", "--payoff", "max-call", "--paths", "2048", "--steps",
            "16", *flags]
    want = _run(jax_main, argv, capsys)
    got = _run(port_main, [*argv, "--device", "cpu"], capsys)
    assert sorted(got) == sorted(want) == ["n_assets", "n_paths", "price",
                                           "std_err"]
    assert got["n_assets"] == want["n_assets"]
    assert got["n_paths"] == want["n_paths"] == 2048
    for k in ("price", "std_err"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k


@pytest.mark.parametrize("flags", [
    ["--n-assets", "3"],
    ["--n-assets", "4", "--asset-corr", "0.3", "--steps", "17",
     "--observations", "3"],
])
def test_note_worst_of_matches_jax_cli(flags, capsys):
    """The worst-of autocallable on MultiGBM (the torch loop) against the
    JAX CLI; a flipped trigger or barrier moves one path by <= 1.1."""
    argv = ["note", "--type", "autocall", "--paths", "2048", "--steps", "16",
            *flags]
    want = _run(jax_main, argv, capsys)
    got = _run(port_main, [*argv, "--device", "cpu"], capsys)
    assert sorted(got) == sorted(want)
    assert got["n_assets"] == want["n_assets"] > 1
    for k in want:
        tol = 1e-5 * abs(want[k]) + FLIPS * 1.1 / want["n_paths"]
        assert abs(got[k] - want[k]) <= tol, k


VAR_FLAGS = ["var", "--paths", "65536", "--chunk", "16384", "--bins",
             "2048", "--seed", "2"]


def test_var_streaming_route_matches_jax_cli(capsys):
    """``var`` without ``--on-device``: the streaming route (K2's plain
    version in chunks, the host sketch in float64) against the JAX CLI's,
    whose moments reduce in float64 here (the conftest's x64).  The same
    keys and pilot grid; a price moved within its rtol 2e-6 may change
    bins, so the percentiles agree within one bin width and the moments
    within rtol 1e-5.  Progress goes to stderr, one line a chunk."""
    assert jax_main(VAR_FLAGS) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert port_main([*VAR_FLAGS, "--device", "cpu"]) == 0
    out = capsys.readouterr()
    got = json.loads(out.out.strip().splitlines()[-1])
    assert sorted(got) == sorted(want) and got["n_paths"] == 65536
    assert [line.split()[0] for line in out.err.splitlines()] == [
        "16,384/65,536", "32,768/65,536", "49,152/65,536", "65,536/65,536"]
    width = want["var_95_grid_err"]  # one bin, in percent of s0 = 100
    assert got["var_95_grid_err"] == pytest.approx(want["var_95_grid_err"],
                                                   rel=1e-9)
    for k, v in want["percentiles"].items():
        assert abs(got["percentiles"][k] - v) <= width, k
    for k in ("expected_return", "expected_vol", "std_err", "var_95",
              "cvar_95", "prob_profit"):
        tol = 1e-5 * abs(want[k]) + (width if "var" in k else 0.0)
        assert abs(got[k] - want[k]) <= tol + 1e-9, k


def test_var_checkpoint_resumes_to_the_one_shot_json(tmp_path, capsys):
    """Half the paths with ``--checkpoint``, then all of them from the same
    checkpoint: only the second half runs, and the JSON is the one-shot
    run's, bit for bit."""
    ckpt = str(tmp_path / "var.npz")
    flags = [*VAR_FLAGS, "--device", "cpu", "--checkpoint", ckpt]
    half = [*flags]
    half[half.index("65536")] = "32768"
    assert port_main(half) == 0
    capsys.readouterr()
    assert port_main(flags) == 0
    out = capsys.readouterr()
    resumed = json.loads(out.out.strip().splitlines()[-1])
    assert [line.split()[0] for line in out.err.splitlines()] == [
        "49,152/65,536", "65,536/65,536"]
    oneshot = _run(port_main, [*VAR_FLAGS, "--device", "cpu"], capsys)
    assert resumed == oneshot


#: The GARCH, QMC, local-vol and multi-device slices' modules, which the
#: walk below must reach.
SLICE_MODULES = ("api.montecarlo", "api.var", "cli.risk", "data.synthetic",
                 "engine.path_sketch", "engine.streaming", "processes.garch",
                 "processes.garch_fit", "stats.quantiles", "stats.risk",
                 "rng.sobol", "samplers", "cli.pricing_models",
                 "processes.dupire", "processes.local_vol", "processes.slv",
                 "parallel", "parallel.mesh", "parallel.sharded",
                 "engine.american", "engine.bermudan", "processes.lmm",
                 "processes.hybrid", "processes.heston_exposure",
                 "api.stress", "engine.rates_calibration")


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, imported in a fresh interpreter, leaves
    ``jax`` and ``montecarlo_tpu`` out of ``sys.modules``; the walk covers
    the GARCH, QMC, local-vol and multi-device slices' modules;
    ``chip_smoke.py`` and the gloo ranks of tests/test_torch_sharded.py
    import neither, at any level of the script."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import montecarlo_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'montecarlo_tpu'))\n"
        "print(' '.join(names), '|', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    names, bad = out.stdout.strip().split(" | ", 1)
    names = set(names.split())
    assert len(names) > 20
    assert bad == "[]", bad
    missing = [m for m in SLICE_MODULES
               if f"montecarlo_tpu_torch.{m}" not in names]
    assert not missing, missing
    for script in ("chip_smoke.py", "tests/torch_sharded_ranks.py"):
        tree = ast.parse((ROOT / script).read_text())
        imported = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                imported.update(a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom):
                imported.add(node.module or "")
        assert any(m.startswith("montecarlo_tpu_torch") for m in imported)
        bad = sorted(m for m in imported
                     if m.split(".")[0] in ("jax", "jaxlib", "montecarlo_tpu"))
        assert not bad, (script, bad)


def test_bridge_knock_out_plus_knock_in_is_vanilla(capsys):
    """In-out parity from the one survival functional: KO + KI pays the
    vanilla call on every path, so the estimates add up to the call's."""
    flags = ["--paths", "4096", "--steps", "17", "--seed", "3",
             "--device", "cpu"]
    ko = _run(port_main, ["price", "--payoff", "up-and-out", "--bridge",
                          *flags], capsys)
    ki = _run(port_main, ["price", "--payoff", "up-and-in", "--bridge",
                          *flags], capsys)
    call = _run(port_main, ["price", "--payoff", "call", *flags], capsys)
    assert ko["price"] > 0 and ki["price"] > 0
    assert ko["price"] + ki["price"] == pytest.approx(call["price"],
                                                      rel=1e-5)


@pytest.mark.parametrize("argv,match", [
    (["price", "--payoff", "asian", "--target-se", "0.1"], "vanilla"),
    (["price", "--payoff", "up-and-out", "--bridge", "--process", "heston"],
     "--process gbm"),
    (["price", "--payoff", "max-call", "--process", "heston"],
     "--process gbm"),
    (["price", "--process", "rbergomi", "--sampler", "antithetic"],
     "its own exact-covariance sampler"),
    (["price", "--process", "rbergomi", "--target-se", "0.1"],
     "own-simulator"),
    (["price", "--process", "rbergomi", "--payoff", "asian"],
     "European call/put"),
])
def test_guards_exit_with_a_message(argv, match, capsys):
    with pytest.raises(SystemExit, match=match):
        port_main([*argv, "--device", "cpu"])
    assert capsys.readouterr().out == ""


def test_device_cuda_is_an_error_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        port_main(["price", "--paths", "128", "--steps", "2"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        port_main(["price", "--payoff", "asian", "--paths", "128"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        port_main(["note", "--paths", "128"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        port_main(["price", "--process", "rbergomi", "--paths", "128"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        port_main(["price", "--payoff", "max-call", "--paths", "128"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        port_main(["note", "--n-assets", "3", "--paths", "128"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(["bench"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(["bench", "--basket"])
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("argv", [
    ["price", "--process", "hybrid", "--payoff", "digital", "--device",
     "cpu"],
    ["price", "--sampler", "sobol", "--process", "hybrid", "--device", "cpu"],
    ["price", "--payoff", "max-call", "--sampler", "antithetic",
     "--device", "cpu"],
    ["price", "--device", "cpu", "--target-se", "0.1", "--sampler",
     "antithetic"],
])
def test_unported_choices_are_clean_errors(argv, capsys):
    with pytest.raises(SystemExit) as e:
        port_main(argv)
    assert e.value.code != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("flags", [
    [],
    ["--payoff", "put", "--seed", "4"],
    ["--sigma-r", "0.03", "--rho", "0.5", "--kappa", "0.3", "--maturity",
     "5", "--steps", "4", "--strike", "110"],
])
def test_price_hybrid_matches_jax_cli(flags, capsys):
    """``price --process hybrid``: JAX's keys, the price and std-err within
    rtol 1e-5 (tests/test_torch_hybrid.py's paths), the closed form
    exact."""
    argv = ["price", "--process", "hybrid", "--paths", "4096", "--steps",
            "16", *flags]
    want = _run(jax_main, argv, capsys)
    got = _run(port_main, [*argv, "--device", "cpu"], capsys)
    assert sorted(got) == sorted(want)
    assert ("closed_form" in got) == ("put" not in flags)
    assert got["n_paths"] == want["n_paths"] == 4096
    for k in ("price", "std_err"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    if "closed_form" in want:
        assert got["closed_form"] == pytest.approx(want["closed_form"],
                                                   rel=1e-14)


@pytest.mark.parametrize("flags", [
    ["--american"],
    ["--payoff", "asian"],
    ["--sampler", "antithetic"],
    ["--target-se", "0.1"],
])
def test_hybrid_refusals_exit_as_in_jax(flags, capsys):
    argv = ["price", "--process", "hybrid", "--paths", "256", *flags]
    for main, extra in ((jax_main, []), (port_main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            main([*argv, *extra])
        assert e.value.code not in (0, None)
        assert capsys.readouterr().out == ""


def test_python_dash_m_entry_point():
    out = subprocess.run(
        [sys.executable, "-m", "montecarlo_tpu_torch", "price", "--device",
         "cpu", "--paths", "512", "--steps", "4"],
        cwd=ROOT, capture_output=True, text=True, timeout=120, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(res) == {"price", "std_err", "n_paths", "black_scholes"}
    assert res["n_paths"] == 512


def test_python_dash_m_note_entry_point():
    out = subprocess.run(
        [sys.executable, "-m", "montecarlo_tpu_torch", "note", "--type",
         "autocall", "--device", "cpu", "--paths", "4096"],
        cwd=ROOT, capture_output=True, text=True, timeout=120, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(res) == {"autocall_note", "std_err", "n_paths", "n_assets",
                        "observations"}
    assert res["n_paths"] == 4096 and 0.5 < res["autocall_note"] < 1.2


@pytest.mark.parametrize("flags,jump", [
    (["--payoff", "put", "--s0", "36", "--strike", "40", "--rate", "0.06",
      "--american", "--american-bound", "--paths", "1024", "--steps", "8"],
     40.0),
    (["--american"], 60.0),
    (["--payoff", "put", "--american", "--steps", "17", "--seed", "3"],
     105.0),
    (["--process", "heston", "--payoff", "put", "--american",
      "--american-bound", "--paths", "1024", "--steps", "8"], 105.0),
    (["--payoff", "asian", "--american"], 60.0),
    (["--payoff", "max-call", "--n-assets", "2", "--s0", "100", "--strike",
      "100", "--rate", "0.05", "--div", "0.10", "--asset-corr", "0",
      "--maturity", "3", "--steps", "9", "--american", "--american-bound",
      "--paths", "1024"], 80.0),
    (["--payoff", "max-call", "--n-assets", "3", "--american", "--steps",
      "9"], 80.0),
])
def test_price_american_matches_jax_cli(flags, jump, capsys):
    """``price --american [--american-bound]`` on GBM, Heston (the joint
    (spot, variance) LSM), the Asian (the path-dependent LSM) and the
    max-call (the multi-asset LSM): JAX's keys, the prices within FLIPS
    paths of ``jump`` (the payoff's range), the bound within AB_SHARE of
    its std-err."""
    argv = ["price", "--paths", "2048", "--steps", "16", *flags]
    want = _run(jax_main, argv, capsys)
    got = _run(port_main, [*argv, "--device", "cpu"], capsys)
    assert sorted(got) == sorted(want)
    assert ("upper_bound" in got) == ("--american-bound" in flags)
    assert got["n_paths"] == want["n_paths"]
    for k in ("price", "std_err"):
        tol = 1e-5 * abs(want[k]) + FLIPS * jump / want["n_paths"]
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])
    for k in ("upper_bound", "upper_bound_std_err"):
        if k in want:
            assert abs(got[k] - want[k]) <= \
                AB_SHARE * want["upper_bound_std_err"], (k, got[k], want[k])
    for k in ("n_assets",):
        assert got.get(k) == want.get(k)


@pytest.mark.parametrize("flags", [
    ["--american", "--sampler", "antithetic"],
    ["--american", "--american-bound", "--payoff", "asian"],
    ["--american", "--payoff", "lookback"],
    ["--american", "--target-se", "0.1"],
    ["--american", "--process", "rbergomi"],
    ["--american", "--mlmc"],
])
def test_american_refusals_exit_as_in_jax(flags, capsys):
    argv = ["price", "--paths", "256", "--steps", "4", *flags]
    for main, extra in ((jax_main, []), (port_main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            main([*argv, *extra])
        assert e.value.code not in (0, None)
        assert capsys.readouterr().out == ""
