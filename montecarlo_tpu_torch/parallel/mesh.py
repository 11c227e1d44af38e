"""Meshes of ranks: ([slices,] paths[, assets]).

The port of ``montecarlo_tpu/parallel/mesh.py``.  JAX lays its devices out
in a ``jax.sharding.Mesh`` and runs one program over it with
``shard_map``.  PyTorch runs one process per rank over a
``torch.distributed`` process group (``torchrun`` on cards, ranks started
by ``subprocess`` over gloo in the CPU tests), and a :class:`Mesh` tells a
rank where it stands: the axis sizes, its coordinates, its device, and the
group each axis's collectives run on.

The layout is JAX's, over the group's ranks in order: slice-major for
(slices, paths), so shard ``s`` of slice ``k`` is global shard ``k *
n_path_shards + s`` and each slice's shards are contiguous in global path
order; row-major for (paths, assets).  Why a slices axis at all: each
slice's block statistics are gathered and merged inside the slice, and
only one merged state per slice crosses to the other slices.

Collectives (:meth:`Mesh.all_gather`, :meth:`Mesh.all_reduce`) take
tensors on the mesh's device only, and a sum only of integers: a float sum
depends on the backend's reduction order, so floats are gathered in
coordinate order and merged by a fixed tree (``parallel.sharded``).  NCCL
takes CUDA tensors and gloo CPU tensors; a mesh whose backend cannot run
its device's tensors raises rather than moving them.  With no process
group initialised, :func:`make_mesh` gives a one-rank mesh that runs no
collective.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from montecarlo_tpu_torch.device import resolve_device

#: Canonical mesh-axis names.
PATHS_AXIS = "paths"
ASSETS_AXIS = "assets"
SLICES_AXIS = "slices"

#: The backend each device type's collectives need.
_BACKEND_FOR = {"cuda": "nccl", "cpu": "gloo"}

#: Groups already made by :func:`subgroup`, by (default group, ranks): a
#: group made twice over the same ranks would collide in the rendezvous
#: store, because a group made by its own members alone is named by a hash
#: of its ranks.
_SUBGROUPS: dict = {}


@dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of a mesh.

    ``shape`` and ``coords`` map each axis, in layout order, to its size and
    to this rank's coordinate; ``groups`` maps it to the process group of
    the ranks that differ from this one only along it.  A mesh without a
    process group has None there and as its ``backend``, and runs no
    collective."""

    shape: dict
    coords: dict
    device: torch.device
    groups: dict
    backend: str | None

    def _check(self, x: torch.Tensor) -> None:
        if x.device != self.device:
            raise ValueError(f"a tensor on {x.device} given to a mesh on "
                             f"{self.device}; collectives never move tensors")

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``x`` of every rank along ``axis``, concatenated along dim 0 in
        coordinate order (every rank gets the same tensor)."""
        self._check(x)
        group = self.groups.get(axis)
        if group is None:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.shape[axis])]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts)

    def all_reduce(self, x: torch.Tensor, op: str, axes) -> torch.Tensor:
        """``x`` reduced over ``axes`` (one axis name or several, in
        order) with ``op`` in {"sum", "min", "max"}; a sum takes integers
        only.  Returns a new tensor."""
        self._check(x)
        if op == "sum" and x.is_floating_point():
            raise TypeError("a float sum depends on the backend's reduction "
                            "order; gather the floats and merge them by a "
                            "fixed tree")
        red = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
               "max": dist.ReduceOp.MAX}[op]
        out = x.clone()
        for axis in (axes,) if isinstance(axes, str) else axes:
            group = self.groups.get(axis)
            if group is not None:
                dist.all_reduce(out, op=red, group=group)
        return out


def _rank_device(device) -> torch.device:
    """The rank's device: the current CUDA device for a bare "cuda"."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _check_backend(backend: str, dev: torch.device) -> None:
    need = _BACKEND_FOR[dev.type]
    if need not in backend:
        raise ValueError(
            f"a {backend} process group cannot run collectives on {dev.type}"
            f" tensors (NCCL takes CUDA tensors, gloo CPU tensors); build "
            f"the mesh on the device its backend takes")


def _axis_group(mesh_ranks, shape: dict, coords: dict, axis: str, group,
                group_ranks):
    """The group of the ranks that differ from this one only along
    ``axis``, in coordinate order (one rank for a size-1 axis, whose
    collectives still run on the backend); None without a process
    group."""
    if group is None:
        return None
    axes = list(shape)
    strides, s = {}, 1
    for a in reversed(axes):
        strides[a] = s
        s *= shape[a]
    base = sum(coords[a] * strides[a] for a in axes if a != axis)
    peers = tuple(mesh_ranks[base + j * strides[axis]]
                  for j in range(shape[axis]))
    if peers == group_ranks:
        return group
    return subgroup(peers, backend=dist.get_backend(group))


def subgroup(ranks, backend=None):
    """The process group of ``ranks`` (increasing global ranks), made by
    those ranks alone, so that groups over other ranks may be made at the
    same time, side by side; the same group again for the same ranks.
    Each of the ranks calls it."""
    ranks = tuple(int(r) for r in ranks)
    if list(ranks) != sorted(set(ranks)):
        raise ValueError(f"ranks {ranks} must be distinct and increasing")
    world = dist.group.WORLD
    key = (id(world), ranks)
    hit = _SUBGROUPS.get(key)
    if hit is None or hit[0] is not world:
        hit = (world, dist.new_group(list(ranks), backend=backend,
                                     use_local_synchronization=True))
        _SUBGROUPS[key] = hit
    return hit[1]


def make_mesh(n_path_shards: int | None = None, n_asset_shards: int = 1, *,
              n_slices: int = 1, group=None, device="cuda") -> Mesh:
    """This rank's mesh ([slices,] paths[, assets]) over the ranks of
    ``group`` (the default group when None), as JAX's ``make_mesh`` lays
    out devices: ``n_path_shards`` defaults to every rank of the group on
    the paths axis; ``n_slices > 1`` adds an outer slices axis.  The mesh
    holds the group's first ``n_path_shards * n_asset_shards * n_slices``
    ranks, and each of them calls this function.

    ``device``: the rank's device, the current CUDA device by default; pass
    "cpu" for gloo ranks.  Without an initialised process group the mesh
    has one rank and runs no collective."""
    dev = _rank_device(device)
    if dist.is_available() and dist.is_initialized():
        pg = dist.group.WORLD if group is None else group
        group_ranks = tuple(dist.get_process_group_ranks(pg))
        backend, me = dist.get_backend(pg), dist.get_rank()
    elif group is not None:
        raise ValueError("group= needs an initialised process group")
    else:
        pg, group_ranks, backend, me = None, (0,), None, 0
    n_dev = len(group_ranks)
    if n_slices < 1 or n_slices > n_dev:
        raise ValueError(f"n_slices={n_slices} must be in [1, {n_dev}]")
    if n_slices > 1 and n_asset_shards > 1:
        raise ValueError(
            "slices x assets meshes are not supported: shard assets within "
            "a slice and paths across slices")
    if n_asset_shards < 1 or n_asset_shards > n_dev:
        raise ValueError(f"n_asset_shards={n_asset_shards} must be in "
                         f"[1, {n_dev}] (available ranks)")
    inner = n_asset_shards * n_slices
    if n_path_shards is None:
        if n_dev % inner:
            raise ValueError(
                f"{n_dev} ranks do not split evenly into n_asset_shards="
                f"{n_asset_shards} x n_slices={n_slices}; pass "
                "n_path_shards explicitly to use a subset")
        n_path_shards = n_dev // inner
    if n_path_shards < 1:
        raise ValueError(f"n_path_shards={n_path_shards} must be >= 1")
    n = n_path_shards * inner
    if n > n_dev:
        raise ValueError(f"mesh needs {n} ranks, only {n_dev} available")
    if list(group_ranks) != sorted(group_ranks):
        raise ValueError(f"the group's ranks {group_ranks} are not in "
                         "increasing order")
    mesh_ranks = group_ranks[:n]
    if me not in mesh_ranks:
        raise ValueError(f"rank {me} is not one of the mesh's ranks "
                         f"{list(mesh_ranks)}")
    if backend is not None:
        _check_backend(backend, dev)
    i = mesh_ranks.index(me)
    if n_slices > 1:
        shape = {SLICES_AXIS: n_slices, PATHS_AXIS: n_path_shards}
        coords = {SLICES_AXIS: i // n_path_shards,
                  PATHS_AXIS: i % n_path_shards}
    elif n_asset_shards > 1:
        shape = {PATHS_AXIS: n_path_shards, ASSETS_AXIS: n_asset_shards}
        coords = {PATHS_AXIS: i // n_asset_shards,
                  ASSETS_AXIS: i % n_asset_shards}
    else:
        shape, coords = {PATHS_AXIS: n_path_shards}, {PATHS_AXIS: i}
    groups = {a: _axis_group(mesh_ranks, shape, coords, a, pg, group_ranks)
              for a in shape}
    return Mesh(shape=shape, coords=coords, device=dev, groups=groups,
                backend=backend)
