"""Mesh and sharding utilities for scenario-parallel LMPC.

Port of ``racing_lmpc_tpu/parallel/mesh.py`` on ``torch.distributed``.  The
reference has no distributed backend (SURVEY.md section 2.7); its scale-out
is data parallelism over scenario batches: the batch's leading dimension is
split over a mesh of devices, each device solves its shard, and the fleet
metrics are reduced across the shards.

Where the reference's mesh holds devices (virtual ones on the CPU) inside
one program, here one process holds one rank and one device: a mesh of n
needs a process group of n processes (``parallel.distributed.initialize``,
NCCL on the card, gloo on the CPU).  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over ranks.  Every function
here is called by every rank of the mesh (building a mesh is collective
over the whole group); tensors are the calling rank's own.
"""

from __future__ import annotations

import functools
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def tree_map(fn, tree: Any) -> Any:
    """``fn`` on every leaf of nested tuples / NamedTuples / lists / dicts
    (None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The calling rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def make_mesh(ranks=None, axis: str = "batch") -> DeviceMesh:
    """1-D data-parallel mesh over all (or the given) ranks of the group."""
    if ranks is None:
        ranks = range(dist.get_world_size())
    return DeviceMesh(_device_type(), torch.as_tensor(list(ranks), dtype=torch.int64),
                      mesh_dim_names=(axis,))


def make_mesh_2d(ranks=None, axes=("host", "batch"),
                 host_size: int | None = None) -> DeviceMesh:
    """2-D ``(host, batch)`` mesh: the production multi-host topology.

    The outer axis maps to hosts, the inner one to the devices of each host;
    the scenario batch is split over both (``axis=("host", "batch")``).  The
    ranks are sorted, so each mesh row holds ``n / host_size`` consecutive
    ranks — one host's, as launchers number ranks host by host (the
    reference sorts its devices by (process, id), ``mesh.py:50-51``).
    ``host_size`` defaults to 2 on an even rank count, else 1.
    """
    ranks = sorted(range(dist.get_world_size()) if ranks is None else ranks)
    n = len(ranks)
    if host_size is None:
        host_size = 2 if n % 2 == 0 and n >= 2 else 1
    assert n % host_size == 0, (n, host_size)
    mesh = torch.as_tensor(ranks, dtype=torch.int64).reshape(host_size, n // host_size)
    return DeviceMesh(_device_type(), mesh, mesh_dim_names=tuple(axes))


def _axes(axis) -> tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def shard_index(mesh: DeviceMesh, axis="batch") -> tuple[int, int]:
    """(this rank's shard, shard count) of a batch split over ``axis`` (one
    mesh axis name or a tuple of them, flattened in that order)."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not on the mesh")
    idx, count = 0, 1
    for name in _axes(axis):
        d = mesh.mesh_dim_names.index(name)
        idx = idx * mesh.size(d) + coord[d]
        count *= mesh.size(d)
    return idx, count


def shard_batch(tree: Any, mesh: DeviceMesh, axis="batch") -> Any:
    """This rank's shard of every leaf: the leading (batch) dimension split
    over ``axis`` by the flattened position of the rank on those axes; 0-d
    leaves are replicated.  Every rank passes the same full-size leaves."""
    idx, count = shard_index(mesh, axis)
    device = mesh_device(mesh)

    def put(leaf):
        t = torch.as_tensor(leaf).to(device)
        if t.dim() == 0:
            return t
        if t.shape[0] % count:
            raise ValueError(f"batch {t.shape[0]} does not split into {count} shards")
        k = t.shape[0] // count
        return t[idx * k:(idx + 1) * k].contiguous()
    return tree_map(put, tree)


def replicate(tree: Any, mesh: DeviceMesh) -> Any:
    """Every leaf whole on this rank's device."""
    device = mesh_device(mesh)
    return tree_map(lambda leaf: torch.as_tensor(leaf).to(device), tree)


def sharded_batch_solver(mpc, mesh: DeviceMesh, axis="batch"):
    """The batched solve of ``mpc`` (a ``RacingMPC`` on this rank's device)
    on this rank's shard: ``solver(inp, z_warm, warm_valid)`` takes the
    shards ``shard_batch`` made and returns (output, warm-start vectors),
    both kept on this rank (the reference keeps its outputs sharded the same
    way).  The solve itself needs no collective."""
    shard_index(mesh, axis)
    if mpc.device != mesh_device(mesh):
        raise ValueError(f"the MPC is on {mpc.device}, the rank's device is "
                         f"{mesh_device(mesh)}")

    def solver(inp, z_warm, warm_valid):
        return mpc.solve_batch(inp, z_warm, warm_valid)
    return solver


@functools.lru_cache(maxsize=None)
def _metrics_fn(mesh: DeviceMesh):
    """Build (once per mesh) the cross-shard metrics reduction: one
    ``all_reduce`` SUM of (solved, total) and one MIN of the objective over
    the solved lanes, each over every axis of the mesh in turn (a reduction
    over each axis's group composes into one over the whole mesh)."""
    groups = [mesh.get_group(d) for d in range(mesh.ndim)]

    def fn(solved, cost):
        s = solved.to(torch.bool)
        counts = torch.stack([s.sum().to(torch.float32),
                              torch.tensor(float(s.numel()), device=s.device)])
        # mask BEFORE reducing: an unsolved lane's objective is the last
        # iterate's and must not undercut a solved one; none solved -> +inf
        inf = torch.full((1,), torch.inf, dtype=cost.dtype, device=cost.device)
        cmin = torch.cat([torch.where(s, cost, torch.inf).reshape(-1), inf]).amin()
        for g in groups:
            dist.all_reduce(counts, op=dist.ReduceOp.SUM, group=g)
            dist.all_reduce(cmin, op=dist.ReduceOp.MIN, group=g)
        return counts[0] / counts[1], cmin
    return fn


def sharded_metrics(solved, cost, mesh: DeviceMesh):
    """Cross-shard fleet metrics by explicit collectives (``mesh.py:
    99-133``): the solved fraction by a SUM, the best objective over SOLVED
    scenarios by a MIN.  Returns 0-d tensors equal on every rank
    (solved_fraction, min_cost); min_cost is +inf when nothing solved."""
    return _metrics_fn(mesh)(solved, cost)

