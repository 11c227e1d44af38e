"""Sharded simulation with reductions that do not depend on the mesh.

The port of the main path of ``montecarlo_tpu/parallel/sharded.py``
(``sharded_terminal``, ``block_moments``, ``sharded_mc_estimate``,
``sharded_basket_estimate``, ``sharded_functional_estimate``,
``sharded_terminal_sketch``, ``sharded_rbergomi_estimate``,
``sharded_price_and_greeks``) and of
``montecarlo_tpu/engine/path_sketch.py::sharded_path_percentiles``.  Every
rank of a :class:`~montecarlo_tpu_torch.parallel.mesh.Mesh` calls the same
function (SPMD), and each:

- simulates a contiguous run of **global** path ids, ``path_offset +
  shard * local_n`` (mod 2^32, the uint32 id space), through the same
  engine entry as one device (``engine.dispatch``: K2, K4, or the torch
  loop; K5 and K6 for rough Bergomi), so every path is the one an
  unsharded run draws;
- reduces its payoffs to per-block moment states over fixed
  ``block_size``-path blocks, by a fixed pairwise tree (``tree_sum``) whose
  order depends on the block size alone;
- gathers the block states in global block order and merges them with
  ``moments_reduce``'s fixed tree (on a sliced mesh: inside each slice,
  then one merged state per slice).

Neither the block reduction nor the merge depends on the mesh, so price
and std-err are bitwise the same at any world size and layout, a one-rank
mesh included.  Floats are never summed by a collective; only integers
(bin counts, out-of-range counts) are, and ``min``/``max``.
"""

from __future__ import annotations

import dataclasses

import torch

from montecarlo_tpu_torch.engine.dispatch import terminal_prices
from montecarlo_tpu_torch.parallel.mesh import (ASSETS_AXIS, PATHS_AXIS,
                                                SLICES_AXIS)
from montecarlo_tpu_torch.rng.normal import exp32, log32, normal_draw
from montecarlo_tpu_torch.rng.threefry import MASK32, key_from_seed
from montecarlo_tpu_torch.stats.quantiles import (HistogramSketch, bin_index,
                                                  sketch_from_array)
from montecarlo_tpu_torch.stats.welford import (MomentState, moments_reduce,
                                                std_error, tree_sum)

#: Paths per statistics block.  Fixed (mesh-independent) by design: scaled
#: with the rank count, it would break reproducibility across meshes.
DEFAULT_BLOCK = 4096


def _check_divisible(n_paths: int, n_shards: int, block_size: int):
    if n_paths % (n_shards * block_size) != 0:
        raise ValueError(
            f"n_paths={n_paths} must be divisible by n_shards*block_size="
            f"{n_shards}*{block_size}")


def _slice_layout(mesh, axis: str):
    """(n_slices, n_path_shards, total_shards) for a ([slices,] paths)
    mesh: shard s of slice k is global shard ``k * n_path_shards + s``."""
    n_slices = mesh.shape.get(SLICES_AXIS, 1)
    n_path_shards = mesh.shape[axis]
    return n_slices, n_path_shards, n_slices * n_path_shards


def _check_two_level_tree(blocks_per_slice: int):
    """The two-level merge (a tree per slice, then a tree over the slices'
    states) is bitwise the flat tree iff blocks-per-slice is a power of
    two: ``moments_reduce`` pairs neighbours level by level, and an odd
    level would pair blocks across a slice boundary."""
    if blocks_per_slice & (blocks_per_slice - 1):
        raise ValueError(
            f"multi-slice meshes need a power-of-two number of stat blocks "
            f"per slice for the bitwise-invariant two-level merge; got "
            f"{blocks_per_slice} (adjust n_paths or block_size)")


def _check_device(process_device, mesh) -> None:
    if torch.device(process_device) != mesh.device:
        raise ValueError(f"the process lies on {process_device} and the "
                         f"mesh's rank on {mesh.device}")


def _shard_offset(mesh, axis: str, local_n: int, path_offset=0) -> int:
    """The first global path id of this rank's shard, in the uint32 id
    space."""
    n_path_shards = mesh.shape[axis]
    shard = (mesh.coords.get(SLICES_AXIS, 0) * n_path_shards
             + mesh.coords[axis])
    return (int(path_offset) + shard * local_n) & MASK32


def _layout(mesh, n_paths: int, block_size: int, axis: str):
    """(local_n, has_slices) after JAX's divisibility and two-level-tree
    checks."""
    n_slices, _, n_shards = _slice_layout(mesh, axis)
    _check_divisible(n_paths, n_shards, block_size)
    if n_slices > 1:
        _check_two_level_tree(n_paths // block_size // n_slices)
    return n_paths // n_shards, n_slices > 1


def _gather_two_level(local: MomentState, mesh, axis: str,
                      has_slices: bool) -> MomentState:
    """Every block state of the mesh in global block order (one gather of
    the stacked (n_blocks, 3, ...) states over the paths axis); on a
    sliced mesh each slice merges its blocks and the slices gather one
    state each, bitwise the flat merge (``_check_two_level_tree``)."""
    stacked = torch.stack(tuple(local), dim=1)
    states = MomentState(*mesh.all_gather(stacked, axis).unbind(1))
    if not has_slices:
        return states
    slice_state = torch.stack(tuple(moments_reduce(states)))[None]
    return MomentState(*mesh.all_gather(slice_state, SLICES_AXIS).unbind(1))


def _estimate(total: MomentState, discount) -> dict:
    d = torch.as_tensor(discount, dtype=total.mean.dtype,
                        device=total.mean.device)
    return {"price": d * total.mean, "std_err": d * std_error(total),
            "n_paths": total.count}


def block_moments(values: torch.Tensor,
                  block_size: int = DEFAULT_BLOCK) -> MomentState:
    """Per-block moment states over consecutive blocks of ``block_size``
    paths: mean and M2 summed by ``tree_sum``'s fixed pairwise tree, so a
    block's state is the same bits whatever else is in the tensor, on any
    device.  (A library reduction picks its order from the tensor's
    shape, which differs with the number of blocks a rank holds.)"""
    blocks = values.reshape(-1, block_size)
    mean = tree_sum(blocks, axis=1) / block_size
    dev = blocks - mean[:, None]
    m2 = tree_sum(dev * dev, axis=1)
    return MomentState(count=torch.full_like(mean, float(block_size)),
                       mean=mean, m2=m2)


def sharded_terminal(process, n_paths: int, n_steps: int, *, seed: int,
                     mesh, stream: int = 0, sampler=None,
                     axis: str = PATHS_AXIS, path_offset=0) -> torch.Tensor:
    """Terminal prices of global paths ``path_offset + [0, n_paths)``, in
    global path order, on every rank; each rank simulates its shard."""
    _check_device(process.device, mesh)
    _, _, n_shards = _slice_layout(mesh, axis)
    if n_paths % n_shards != 0:
        raise ValueError(f"n_paths={n_paths} not divisible by {n_shards} "
                         "shards")
    local_n = n_paths // n_shards
    local = terminal_prices(process, local_n, n_steps, seed=seed,
                            stream=stream, sampler=sampler,
                            path_offset=_shard_offset(mesh, axis, local_n,
                                                      path_offset))
    out = mesh.all_gather(local, axis)
    if SLICES_AXIS in mesh.shape:
        out = mesh.all_gather(out, SLICES_AXIS)
    return out


def sharded_mc_estimate(process, payoff_fn, n_paths: int, n_steps: int, *,
                        seed: int, mesh, discount=1.0, stream: int = 0,
                        sampler=None, block_size: int = DEFAULT_BLOCK,
                        axis: str = PATHS_AXIS, path_offset=0) -> dict:
    """Sharded Monte Carlo mean and std-err of ``payoff_fn(terminal
    prices)``: ``{"price", "std_err", "n_paths"}``, bitwise the same on any
    mesh, on every rank.  ``path_offset`` starts the global path ids (the
    chunking hook)."""
    _check_device(process.device, mesh)
    local_n, has_slices = _layout(mesh, n_paths, block_size, axis)
    terminal = terminal_prices(process, local_n, n_steps, seed=seed,
                               stream=stream, sampler=sampler,
                               path_offset=_shard_offset(mesh, axis, local_n,
                                                         path_offset))
    local = block_moments(payoff_fn(terminal), block_size)
    total = moments_reduce(_gather_two_level(local, mesh, axis, has_slices))
    return _estimate(total, discount)


def sharded_basket_estimate(basket, payoff_fn, n_paths: int, n_steps: int,
                            *, seed: int, mesh, discount=1.0,
                            stream: int = 0,
                            block_size: int = DEFAULT_BLOCK) -> dict:
    """A correlated ``BasketGBM`` over a (paths, assets) mesh.

    Every rank regenerates the full shock vector from (seed, global path
    id, t), so the time loop needs no collective; it updates only its
    asset shard, correlating with its rows of the Cholesky factor (the
    unsharded step's left-to-right sum over the factor's columns, zeros
    included).  The rank's weighted sum of ``exp32`` of its assets is
    gathered over the assets axis and summed in asset-shard order, then
    the usual block states over the paths axis.  Bitwise the same across
    path shardings at a fixed asset sharding; with one asset shard bitwise
    the unsharded torch loop's basket values; across asset shardings
    within float round-off (the partial sums group differently)."""
    _check_device(basket.device, mesh)
    n_shards_p = mesh.shape[PATHS_AXIS]
    n_shards_a = mesh.shape.get(ASSETS_AXIS, 1)
    a_total = basket.n_assets
    if a_total % n_shards_a or n_paths % (n_shards_p * block_size):
        raise ValueError("shape not divisible by mesh/block")
    a_local = a_total // n_shards_a
    local_n = n_paths // n_shards_p
    a0 = mesh.coords.get(ASSETS_AXIS, 0) * a_local
    k0, k1 = key_from_seed(seed, stream)
    ids = (torch.arange(local_n, dtype=torch.int64, device=mesh.device)
           + mesh.coords[PATHS_AXIS] * local_n) & MASK32
    mine = slice(a0, a0 + a_local)
    chol = basket.chol_flat.reshape(a_total, a_total)[mine]
    drift, scale = (v[mine] for v in basket.drift_scale())
    state = log32(basket.s0[mine])[:, None].expand(a_local, local_n).clone()
    for t in range(n_steps):
        # The full shock vector, regenerated locally: no collective.
        z = [normal_draw(k0, k1, ids, (t * a_total + d) & MASK32)
             for d in range(a_total)]
        zc = chol[:, :1] * z[0]
        for b in range(1, a_total):
            zc = zc + chol[:, b:b + 1] * z[b]
        state = state + (drift[:, None] + scale[:, None] * zc)
    w = basket.weights[mine]
    part = w[0] * exp32(state[0])
    for a in range(1, a_local):
        part = part + w[a] * exp32(state[a])
    parts = mesh.all_gather(part[None], ASSETS_AXIS)
    value = parts[0]
    for p in parts[1:]:
        value = value + p
    local = block_moments(payoff_fn(value), block_size)
    total = moments_reduce(_gather_two_level(local, mesh, PATHS_AXIS, False))
    return _estimate(total, discount)


def sharded_functional_estimate(process, functionals, payoff_of,
                                n_paths: int, n_steps: int, *, seed: int,
                                mesh, discount=1.0, stream: int = 0,
                                sampler=None,
                                block_size: int = DEFAULT_BLOCK,
                                axis: str = PATHS_AXIS) -> dict:
    """Path-dependent pricing: ``simulate_functionals`` per shard (K4 where
    the gate takes the run, else the functionals' torch loop), then the
    block states as :func:`sharded_mc_estimate`.  ``payoff_of`` maps the
    shard's dict ("terminal" plus each named functional) to payoffs."""
    from montecarlo_tpu_torch.engine.functionals import simulate_functionals

    _check_device(process.device, mesh)
    local_n, has_slices = _layout(mesh, n_paths, block_size, axis)
    out = simulate_functionals(
        process, local_n, n_steps, seed=seed, functionals=functionals,
        stream=stream, sampler=sampler,
        path_offset=_shard_offset(mesh, axis, local_n))
    local = block_moments(payoff_of(out), block_size)
    total = moments_reduce(_gather_two_level(local, mesh, axis, has_slices))
    return _estimate(total, discount)


def sharded_terminal_sketch(process, n_paths: int, n_steps: int, *,
                            seed: int, mesh, lo: float, hi: float,
                            bins: int = 4096, stream: int = 0, sampler=None,
                            block_size: int = DEFAULT_BLOCK,
                            axis: str = PATHS_AXIS):
    """(sketch, moments) of the terminal prices: a histogram sketch of
    O(bins) memory per rank and the exact moments of the block states.

    Bin counts and the under- and overflow (recounted here as integers)
    are summed as int64 by the collective (exact and order-free); the
    total is the static ``n_paths``; ``vmin``/``vmax`` by min/max; the
    moments by the block gather and the fixed tree."""
    _check_device(process.device, mesh)
    local_n, has_slices = _layout(mesh, n_paths, block_size, axis)
    terminal = terminal_prices(process, local_n, n_steps, seed=seed,
                               stream=stream, sampler=sampler,
                               path_offset=_shard_offset(mesh, axis,
                                                         local_n))
    sk = sketch_from_array(terminal, lo, hi, bins)
    width = (sk.hi - sk.lo) / bins
    _, under, over = bin_index(terminal.reshape(-1), sk.lo, width, bins)
    ints = torch.cat([sk.counts.to(torch.int64),
                      torch.stack([under.sum(dtype=torch.int64),
                                   over.sum(dtype=torch.int64)])])
    axes = (axis, SLICES_AXIS) if has_slices else (axis,)
    ints = mesh.all_reduce(ints, "sum", axes)
    ext = mesh.all_reduce(torch.stack([sk.vmin, -sk.vmax]), "min", axes)
    f = sk.total.dtype
    merged = HistogramSketch(
        lo=sk.lo, hi=sk.hi, counts=ints[:bins],
        total=torch.tensor(float(n_paths), dtype=f, device=mesh.device),
        underflow=ints[bins].to(f), overflow=ints[bins + 1].to(f),
        vmin=ext[0], vmax=-ext[1])
    local = block_moments(terminal, block_size)
    moments = _gather_two_level(local, mesh, axis, has_slices)
    return merged, moments_reduce(moments)


def sharded_rbergomi_estimate(model, payoff_fn, n_paths: int, *, seed: int,
                              mesh, discount=1.0, stream: int = 0,
                              block_size: int = DEFAULT_BLOCK,
                              axis: str = PATHS_AXIS) -> dict:
    """Rough Bergomi over a mesh: each rank runs ``rbergomi_simulate`` (K5,
    the factor product, K6) on fixed ``block_size``-wide blocks of global
    path ids, one block at a time.  The fixed width is what makes a path's
    value the same bits on any mesh: the product's library kernel may pick
    another blocking, and another summation order, for another width."""
    from montecarlo_tpu_torch.processes.rough_bergomi import (
        rbergomi_simulate)

    _check_device(model.device, mesh)
    local_n, has_slices = _layout(mesh, n_paths, block_size, axis)
    off0 = _shard_offset(mesh, axis, local_n)
    parts = []
    for b in range(local_n // block_size):
        s_t = rbergomi_simulate(model, block_size, seed=seed, stream=stream,
                                path_offset=(off0 + b * block_size) & MASK32)
        parts.append(torch.stack(tuple(block_moments(payoff_fn(s_t),
                                                     block_size))))
    local = MomentState(*torch.cat(parts, dim=1))
    total = moments_reduce(_gather_two_level(local, mesh, axis, has_slices))
    return _estimate(total, discount)


def sharded_path_percentiles(process, n_paths: int, n_steps: int, *,
                             seed: int, mesh, lo: float, hi: float,
                             bins: int = 1024, stream: int = 0,
                             axis: str = PATHS_AXIS) -> dict:
    """Per-step percentile curves over a mesh: each rank's histograms of
    its shard of global paths, summed as int64 by the collective (exact
    and order-free, so the same counts on any mesh), then read by
    ``percentiles_from_histograms`` on every rank.  On a sliced mesh the
    shards are laid out slice-major and summed over both axes."""
    from montecarlo_tpu_torch.engine.path_sketch import (
        path_histograms, percentiles_from_histograms)

    _check_device(process.device, mesh)
    n_slices, _, n_shards = _slice_layout(mesh, axis)
    if n_paths % n_shards:
        raise ValueError(f"n_paths={n_paths} not divisible by {n_shards}")
    local_n = n_paths // n_shards
    h = path_histograms(process, local_n, n_steps, seed=seed, lo=lo, hi=hi,
                        bins=bins, stream=stream,
                        path_offset=_shard_offset(mesh, axis, local_n))
    axes = (axis, SLICES_AXIS) if n_slices > 1 else (axis,)
    h = mesh.all_reduce(h.to(torch.int64), "sum", axes)
    return percentiles_from_histograms(h.cpu().numpy(), lo, hi)


def _block_grads(values: torch.Tensor, block_size: int) -> torch.Tensor:
    """(n_blocks,) block means of per-path gradient contributions, summed
    by ``tree_sum``'s fixed tree, as ``block_moments`` sums the payoffs."""
    return tree_sum(values.reshape(-1, block_size), axis=1) / block_size


def _per_path_greeks(process, payoff_fn, local_n, n_steps, offset, seed,
                     stream, block_size, remat):
    """(payoffs, {field: (n_blocks,) block gradients}) of a process whose
    float leaves are all scalars: one forward and one backward pass over
    the shard, each leaf expanded to one copy per path.  The backward of
    the summed payoffs then gives each path's own contribution, with no
    sum across paths, and the blocks sum them in a fixed order."""
    from montecarlo_tpu_torch.engine.greeks import float_leaves
    from montecarlo_tpu_torch.engine.simulate import simulate

    leaves = {k: v.detach().expand(local_n).clone().requires_grad_(True)
              for k, v in float_leaves(process).items()}
    proc = dataclasses.replace(process, **leaves)
    with torch.enable_grad():
        pay = payoff_fn(simulate(proc, local_n, n_steps, seed=seed,
                                 stream=stream, path_offset=offset,
                                 remat=remat))
        grads = {}
        if pay.requires_grad:
            got = torch.autograd.grad(pay.sum(), list(leaves.values()),
                                      allow_unused=True)
            grads = {k: _block_grads(g, block_size)
                     for k, g in zip(leaves, got) if g is not None}
    return pay.detach(), grads


def _block_by_block_greeks(process, payoff_fn, local_n, n_steps, offset,
                           seed, stream, block_size, remat):
    """The same for a process with a non-scalar float leaf (a table, a
    basket's vectors): one forward and backward pass per block, each
    block's gradient of its ``tree_sum`` mean."""
    from montecarlo_tpu_torch.engine.greeks import float_leaves
    from montecarlo_tpu_torch.engine.simulate import simulate

    leaves = {k: v.detach().requires_grad_(True)
              for k, v in float_leaves(process).items()}
    proc = dataclasses.replace(process, **leaves)
    pays, blocks = [], []
    for b in range(local_n // block_size):
        with torch.enable_grad():
            pay = payoff_fn(simulate(
                proc, block_size, n_steps, seed=seed, stream=stream,
                path_offset=(offset + b * block_size) & MASK32, remat=remat))
            got = [None] * len(leaves)
            if pay.requires_grad:
                got = torch.autograd.grad(tree_sum(pay) / block_size,
                                          list(leaves.values()),
                                          allow_unused=True)
        pays.append(pay.detach())
        blocks.append(got)
    grads = {}
    for j, k in enumerate(leaves):
        if blocks[0][j] is not None:
            grads[k] = torch.stack([g[j] for g in blocks])
    return torch.cat(pays), grads


def sharded_price_and_greeks(process, payoff_fn, n_paths: int, n_steps: int,
                             *, seed: int, mesh, discount=1.0,
                             stream: int = 0,
                             block_size: int = DEFAULT_BLOCK,
                             axis: str = PATHS_AXIS,
                             remat: bool = True) -> dict:
    """Pathwise Greeks over a mesh: ``engine.greeks.price_and_greeks``
    under the fixed-block contract of :func:`sharded_mc_estimate`.

    Each rank differentiates its shard of global paths through the torch
    time loop (the kernels define no backward).  A leaf that is a scalar
    becomes one copy per path, so one backward pass gives every path's own
    gradient contribution with no sum across paths; each ``block_size``
    block of global paths sums its contributions by ``tree_sum``'s fixed
    tree.  (A process with a non-scalar float leaf runs one backward pass
    per block instead.)  The block gradients are gathered in global block
    order and merged as moment states of count 1 by ``moments_reduce``'s
    fixed tree, as the payoffs' block states are.  So price, grads and
    their error bars are bitwise the same on any mesh.

    ``remat`` (default True, as in JAX) checkpoints every step.  Returns
    ``{"price", "std_err", "n_paths", "grads", "grad_std_err"}`` on every
    rank, ``grads`` and ``grad_std_err`` dataclasses shaped like
    ``process`` (integer leaves: zeros), ``grad_std_err`` the blockwise
    CLT error of the block gradient means."""
    from montecarlo_tpu_torch.engine.greeks import float_leaves, grads_like

    _check_device(process.device, mesh)
    local_n, has_slices = _layout(mesh, n_paths, block_size, axis)
    offset = _shard_offset(mesh, axis, local_n)
    scalar = all(v.dim() == 0 for v in float_leaves(process).values())
    run = _per_path_greeks if scalar else _block_by_block_greeks
    pay, blocks = run(process, payoff_fn, local_n, n_steps, offset, seed,
                      stream, block_size, remat)
    total = moments_reduce(_gather_two_level(
        block_moments(pay, block_size), mesh, axis, has_slices))
    est = _estimate(total, discount)
    d = torch.as_tensor(discount, dtype=total.mean.dtype,
                        device=total.mean.device)
    means, errs = {}, {}
    for k, g in blocks.items():
        state = MomentState(count=torch.ones_like(g), mean=g,
                            m2=torch.zeros_like(g))
        g_total = moments_reduce(_gather_two_level(state, mesh, axis,
                                                   has_slices))
        means[k], errs[k] = d * g_total.mean, d * std_error(g_total)
    return {**est, "grads": grads_like(process, means),
            "grad_std_err": grads_like(process, errs)}


def _block_sums(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """(local_n, C) -> (local_blocks, C): each block of ``block_size``
    consecutive paths summed by ``tree_sum``'s fixed tree, the same bits
    whatever else the rank holds."""
    return tree_sum(x.reshape(-1, block_size, x.shape[-1]), axis=1)


def _global_sum(x: torch.Tensor, mesh, axis: str, block_size: int,
                has_slices: bool) -> torch.Tensor:
    """The mesh's sum of ``x`` (local_n, C) over paths: per-block sums,
    gathered in global block order (slice-major on a sliced mesh) and
    summed by the fixed tree, identical on every rank and every mesh."""
    blocks = mesh.all_gather(_block_sums(x, block_size), axis)
    if has_slices:
        blocks = mesh.all_gather(blocks, SLICES_AXIS)
    return tree_sum(blocks, axis=0)


def sharded_lsm_price(process, payoff_fn, n_paths: int, n_steps: int, *,
                      seed: int, rate, dt, mesh, degree: int = 3,
                      dtype=torch.float32, block_size: int = DEFAULT_BLOCK,
                      axis: str = PATHS_AXIS) -> dict:
    """Longstaff-Schwartz LSM sharded over the paths axis.

    Each rank simulates its own (T+1, local_n) paths (the torch loop at
    its global offset) and the backward induction runs in lockstep; at
    each exercise date the ranks exchange only the regression's
    sufficient statistics, in two gathers of per-block partial sums: the
    ITM sums (w, w s, w s^2), which the standardization needs before the
    basis exists, then the fused [Gram | rhs] of the weighted basis.  Each
    is summed in global block order by a fixed tree and the (degree+1)^2
    solve runs on every rank from the same inputs, so price and std-err
    are bitwise the same on any mesh, a one-rank mesh included.  No float
    goes through an all-reduce.

    Against ``engine.american.lsm_price`` (the same policy family, not its
    bits): the ITM std is the one-pass E[s^2] - m^2 (block sums compose)
    and the sums are block-ordered, as in the JAX package.  Returns
    ``{"price", "std_err", "n_paths"}``."""
    from montecarlo_tpu_torch.engine.american import (_basis,
                                                      _check_solves, _dot)
    from montecarlo_tpu_torch.engine.simulate import simulate

    _check_device(process.device, mesh)
    local_n, has_slices = _layout(mesh, n_paths, block_size, axis)
    k = degree + 1
    paths = simulate(process, local_n, n_steps, seed=seed, mode="paths",
                     dtype=dtype,
                     path_offset=_shard_offset(mesh, axis, local_n))
    dev = paths.device
    df = torch.exp(torch.as_tensor(-rate * dt, dtype=dtype, device=dev))
    ridge = 1e-6 * torch.eye(k, dtype=dtype, device=dev)

    def total(x):
        return _global_sum(x, mesh, axis, block_size, has_slices)

    cashflow = payoff_fn(paths[-1])
    infos = []
    for t in range(n_steps - 1, 0, -1):
        s_t = paths[t]
        disc = df * cashflow
        exercise = payoff_fn(s_t)
        itm = exercise > 0
        w = itm.to(dtype)
        sums = total(torch.stack([w, w * s_t, w * s_t * s_t], dim=-1))
        wsum = torch.clamp(sums[0], min=1.0)
        m = sums[1] / wsum
        sd = torch.sqrt(torch.clamp(sums[2] / wsum - m * m, min=0.0)
                        + 1e-12)
        x = _basis((s_t - m) / sd, degree)
        xw = x * w[:, None]
        gram = (xw[:, :, None] * x[:, None, :]).reshape(local_n, k * k)
        fused = total(torch.cat([gram, xw * disc[:, None]], dim=1)) / wsum
        beta, info = torch.linalg.solve_ex(
            fused[:k * k].reshape(k, k) + ridge, fused[k * k:])
        infos.append(info)
        take = itm & (exercise >= _dot(x, beta))
        cashflow = torch.where(take, exercise, disc)
    _check_solves(infos)
    local = block_moments(df * cashflow, block_size)
    return _estimate(
        moments_reduce(_gather_two_level(local, mesh, axis, has_slices)),
        1.0)


def sharded_andersen_broadie_bound(process, payoff_fn, policy, n_outer: int,
                                   n_inner: int, n_steps: int, *, seed: int,
                                   rate, dt, mesh, degree: int = 2,
                                   value_degree: int | None = None,
                                   dtype=torch.float32,
                                   block_size: int = DEFAULT_BLOCK,
                                   axis: str = PATHS_AXIS) -> dict:
    """The Andersen-Broadie dual sharded over the outer paths: each rank
    takes its run of global outer ids, whose inner sample ids derive from
    them (``engine.american._ab_best``), so its per-path maxima are the
    unsharded run's bits; the only collective is the final block-state
    gather and fixed-tree merge.  ``policy`` is ``lsm_policy``'s value
    surrogate on the mesh's device.  Returns ``{"upper", "std_err",
    "n_paths"}``, bitwise the same on any mesh."""
    from montecarlo_tpu_torch.engine.american import _ab_best
    from montecarlo_tpu_torch.engine.simulate import path_ids_for

    _check_device(process.device, mesh)
    local_n, has_slices = _layout(mesh, n_outer, block_size, axis)
    ids = path_ids_for(local_n, _shard_offset(mesh, axis, local_n),
                       mesh.device)
    best = _ab_best(process, payoff_fn, policy, ids, n_inner, n_steps,
                    seed=seed, rate=rate, dt=dt, degree=degree,
                    value_degree=value_degree, dtype=dtype)
    total = moments_reduce(_gather_two_level(block_moments(best, block_size),
                                             mesh, axis, has_slices))
    return {"upper": total.mean, "std_err": std_error(total),
            "n_paths": total.count}
