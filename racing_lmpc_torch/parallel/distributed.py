"""Multi-process runtime: the ``torch.distributed`` process group and the
global-mesh helpers.

Port of ``racing_lmpc_tpu/parallel/distributed.py``.  The reference joins
a ``jax.distributed`` process group and builds one mesh over every
process's devices; here every process holds one rank and one device, the
group is ``torch.distributed``'s (NCCL on CUDA, gloo on the CPU, both
rendezvousing over TCP at the coordinator), and the global mesh is a
``DeviceMesh`` over every rank.  Every process runs the same program: it
builds the same global scenario batch from the seed and keeps its shard.
``parallel.spawn`` starts such a group of processes on one machine.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from racing_lmpc_torch import resolve_device
from racing_lmpc_torch.parallel.mesh import make_mesh, shard_batch, tree_map


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, device=None) -> torch.device:
    """Join the process group as rank ``process_id`` of ``num_processes``,
    rendezvousing at ``coordinator_address`` (``host:port`` or
    ``tcp://host:port``).  On CUDA (the default) the backend is NCCL and the
    rank takes the device ``process_id`` modulo the visible devices unless
    ``device`` names one; ``device="cpu"`` takes gloo.  Returns the rank's
    device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    addr = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=addr, world_size=num_processes,
                            rank=process_id)
    return dev


def global_mesh(axis: str = "batch"):
    """1-D mesh over every rank of the group."""
    return make_mesh(None, axis)


def shard_batch_global(tree: Any, mesh, axis: str = "batch") -> Any:
    """Every process passes the same full-size (global) host values — the
    deterministic scenario builders make that cheap — and keeps only its
    own shard, on its device (``distributed.py:67-82``)."""
    return shard_batch(tree, mesh, axis)


def process_allgather(tree: Any) -> Any:
    """Gather sharded outputs to full host arrays on every process: every
    rank's equal-shaped shard joined along the leading dimension in rank
    order (0-d leaves as they are)."""
    def gather(leaf):
        if not isinstance(leaf, torch.Tensor):
            return np.asarray(leaf)
        if leaf.dim() == 0:
            return leaf.cpu().numpy()
        # gloo gathers no bool tensors
        work = leaf.to(torch.uint8) if leaf.dtype == torch.bool else leaf.contiguous()
        parts = [torch.empty_like(work) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, work)
        out = torch.cat(parts).cpu().numpy()
        return out.astype(bool) if leaf.dtype == torch.bool else out
    return tree_map(gather, tree)
