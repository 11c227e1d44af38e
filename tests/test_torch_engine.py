"""Port engine (simulate, processes, samplers, welford, convert) against the
JAX package, plus the port's own invariants.

Tolerances: the port's terminal prices and paths differ from the JAX
engine's only through the Box-Muller normals (each platform's own
log/sqrt/sin/cos, <= 1e-6 absolute): rtol 2e-6, about four float32 ULPs of
the price.  Inside the port, shard invariance and replay are bitwise.  The
welford merge/tree functions are elementwise float32 on both sides and
match bitwise; moments_from_array sums in each framework's own order:
rtol 1e-5.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.engine import simulate as jsimulate
from montecarlo_tpu.engine.simulate import replay_paths as jreplay
from montecarlo_tpu.processes import GBM as JGBM
from montecarlo_tpu.samplers import AntitheticSampler as JAntithetic
from montecarlo_tpu.stats import welford as jw
from montecarlo_tpu_torch.convert import process_from_numpy, process_to_numpy
from montecarlo_tpu_torch.engine import replay_paths, simulate
from montecarlo_tpu_torch.processes import GBM
from montecarlo_tpu_torch.samplers import AntitheticSampler
from montecarlo_tpu_torch.stats import welford as tw

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
N = 16 * 128
PRICE_RTOL = 2e-6


def _pair():
    """One JAX GBM and its port, both built from the same numpy leaves."""
    jp = JGBM.create(s0=100.0, mu=0.03, sigma=0.2, dt=1 / 252)
    fields = {k: np.asarray(v) for k, v in jp._asdict().items()}
    return jp, process_from_numpy("gbm", fields, device="cpu")


@pytest.mark.parametrize("n_steps", [1, 16, 17])
@pytest.mark.parametrize("sampler", ["plain", "antithetic"])
@pytest.mark.parametrize("mode", ["terminal", "paths"])
def test_simulate_matches_jax(n_steps, sampler, mode):
    jp, tp = _pair()
    js = JAntithetic() if sampler == "antithetic" else None
    ts = AntitheticSampler() if sampler == "antithetic" else None
    want = np.asarray(jsimulate(jp, N, n_steps, seed=5, sampler=js,
                                mode=mode, path_offset=77))
    got = simulate(tp, N, n_steps, seed=5, sampler=ts, mode=mode,
                   path_offset=77).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=PRICE_RTOL)


def test_simulate_shard_invariance_bitwise():
    _, tp = _pair()
    full = simulate(tp, N, 17, seed=3, sampler=AntitheticSampler())
    parts = [simulate(tp, N // 4, 17, seed=3, sampler=AntitheticSampler(),
                      path_offset=o) for o in range(0, N, N // 4)]
    assert torch.equal(full, torch.cat(parts))


def test_path_offset_wraps_like_jax():
    jp, tp = _pair()
    off = 2**32 - 64
    want = np.asarray(jsimulate(jp, 128, 4, seed=1, path_offset=off))
    got = simulate(tp, 128, 4, seed=1, path_offset=off).numpy()
    np.testing.assert_allclose(got, want, rtol=PRICE_RTOL)
    # Ids past 2^32 - 1 wrap to 0, 1, ...: the same paths as offset 0.
    wrapped = simulate(tp, 64, 4, seed=1, path_offset=0)
    np.testing.assert_array_equal(got[64:], wrapped.numpy())


@pytest.mark.parametrize("mode", ["terminal", "paths"])
def test_replay_paths_bitwise_equals_simulate(mode):
    jp, tp = _pair()
    ids = np.array([5, 900, 17, 2047, 0], dtype=np.uint32)
    full = simulate(tp, N, 9, seed=13, mode=mode)
    got = replay_paths(tp, ids, 9, seed=13, mode=mode)
    assert torch.equal(got, full[..., torch.from_numpy(ids.astype(np.int64))])
    want = np.asarray(jreplay(jp, jnp.asarray(ids), 9, seed=13, mode=mode))
    np.testing.assert_allclose(got.numpy(), want, rtol=PRICE_RTOL)


def test_draws_pair_bitwise_equals_draws():
    _, tp = _pair()
    ids = torch.arange(256, dtype=torch.int64)
    for j in (0, 3):
        e0, e1 = tp.draws_pair(7, 0, ids, j)
        d0, d1 = tp.draws(7, 0, ids, 2 * j), tp.draws(7, 0, ids, 2 * j + 1)
        for a, b in zip(e0 + e1, d0 + d1):
            assert torch.equal(a, b)


def test_antithetic_pairs_mirror():
    _, tp = _pair()
    ids = torch.arange(64, dtype=torch.int64)
    (eps,) = AntitheticSampler().draws(tp, 9, 0, ids, 5)
    assert torch.equal(eps[1::2], -eps[0::2])


def test_welford_matches_jax():
    r = np.random.default_rng(0)
    x = r.normal(3.0, 2.0, (8, 512)).astype(np.float32)
    js = jw.moments_from_array(jnp.asarray(x), axis=-1)
    ts = tw.moments_from_array(torch.from_numpy(x), axis=-1)
    for j, t in zip(js, ts):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5)
    # Elementwise merges and trees: bitwise, from identical inputs.
    st = [np.array(v, np.float32) for v in js]
    a = jw.MomentState(*(jnp.asarray(v[:5]) for v in st))
    b = jw.MomentState(*(jnp.asarray(v[3:]) for v in st))
    ta = tw.MomentState(*(torch.from_numpy(v[:5]) for v in st))
    tb = tw.MomentState(*(torch.from_numpy(v[3:]) for v in st))
    for j, t in zip(jw.moments_merge(a, b), tw.moments_merge(ta, tb)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for n in (8, 5, 1):
        jst = jw.MomentState(*(jnp.asarray(v[:n]) for v in st))
        tst = tw.MomentState(*(torch.from_numpy(v[:n]) for v in st))
        for j, t in zip(jw.moments_reduce(jst), tw.moments_reduce(tst)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for n in (128, 37, 2):
        np.testing.assert_array_equal(
            tw.tree_sum(torch.from_numpy(x[:, :n]), axis=1).numpy(),
            np.asarray(jw.tree_sum(jnp.asarray(x[:, :n]), axis=1)))
    full = jw.MomentState(*(jnp.asarray(v) for v in st))
    tfull = tw.MomentState(*(torch.from_numpy(v) for v in st))
    np.testing.assert_array_equal(tw.std_error(tfull).numpy(),
                                  np.asarray(jw.std_error(full)))


def test_convert_round_trip():
    jp, tp = _pair()
    back = process_to_numpy(tp)
    for k, v in jp._asdict().items():
        np.testing.assert_array_equal(back[k], np.asarray(v))
        assert back[k].dtype == np.float32
    direct = GBM.create(100.0, 0.03, 0.2, 1 / 252, device="cpu")
    assert torch.equal(simulate(tp, 256, 5, seed=2),
                       simulate(direct, 256, 5, seed=2))
    with pytest.raises(ValueError):
        process_from_numpy("gbm", {"s0": np.float32(1.0)}, device="cpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                yield node.module.split(".")[0]


def test_port_never_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "montecarlo_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        bad = {m for m in _imported_roots(f)
               if m in ("jax", "jaxlib", "montecarlo_tpu")}
        assert not bad, f"{f.relative_to(ROOT)} imports {bad}"


def test_cuda_request_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GBM.create(100.0, 0.03, 0.2, 1 / 252, device="cuda")
    jp, _ = _pair()
    fields = {k: np.asarray(v) for k, v in jp._asdict().items()}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        process_from_numpy("gbm", fields, device="cuda")
    # The library's constructors default to the card, as the CLI does.
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GBM.create(100.0, 0.03, 0.2, 1 / 252)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        process_from_numpy("gbm", fields)
