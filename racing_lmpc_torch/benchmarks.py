"""Benchmark scenarios: batched BARC LMPC problems.

Port of ``racing_lmpc_tpu/benchmarks.py`` (the builders and
``scaling_bench``).  A "scenario" is one full
LMPC solve: an initial state somewhere on the BARC track, a rolled reference
over the horizon, boundary/curvature/velocity data, and a fixed-K safe-set
batch from the recorded laps.  Scenarios are built on the host with numpy
from ``seed`` (the same draws as the reference) and returned as tensors on
the requested device (CUDA by default).
"""

from __future__ import annotations

import numpy as np
import torch

from racing_lmpc_torch import resolve_device
from racing_lmpc_torch.config import (
    SS_DIR, TRACK_DIR, barc_mpc_config, barc_vehicle)
from racing_lmpc_torch.models import SingleTrackPlanarModel
from racing_lmpc_torch.mpc.racing_mpc import MPCInput, RacingMPC
from racing_lmpc_torch.safeset import SafeSetManager, SafeSetRecorder
from racing_lmpc_torch.track import RacingTrajectory

BARC_LAPS = tuple(str(SS_DIR / "barc" / f"ss_lap_{i}") for i in (1, 2, 3))


def build_barc_lmpc(n_horizon: int = 20, num_ss: int = 48,
                    num_ss_per_lap: int = 16, learning: bool = True,
                    device=None, **overrides):
    """Flagship problem: BARC single-track LMPC with the recorded safe set.
    Extra kwargs override RacingMPCConfig fields."""
    device = resolve_device(device)
    base, st = barc_vehicle()
    model = SingleTrackPlanarModel(base, st)
    track = RacingTrajectory.from_file(TRACK_DIR / "barc" / "02_barc_center.txt",
                                       device=device)
    cfg = barc_mpc_config(
        "barc_lmpc", n=n_horizon, learning=learning,
        num_ss_pts=num_ss, num_ss_pts_per_lap=num_ss_per_lap, **overrides)
    mpc = RacingMPC(cfg, model, device=device)
    manager = None
    if learning:
        manager = SafeSetManager(3, nx=6)
        SafeSetRecorder(manager).load(BARC_LAPS, track.total_length)
    return model, track, cfg, mpc, manager


def make_scenario_batch(mpc: RacingMPC, track, manager, batch: int,
                        dt: float = 0.025, seed: int = 0,
                        device=None) -> MPCInput:
    """Batch of LMPC scenarios spread around the track (leading dim = batch)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    N, nx, nu, K = mpc.N, mpc.nx, mpc.nu, mpc.K
    L = track.total_length
    s0 = rng.uniform(0, L, batch)
    t0 = rng.uniform(-0.1, 0.1, batch)
    v0 = rng.uniform(1.5, 2.2, batch)

    s_hor = s0[:, None] + v0[:, None] * dt * np.arange(N)[None, :]
    X_ref = np.zeros((batch, N, nx), dtype=np.float32)
    X_ref[..., 0] = s_hor
    X_ref[..., 3] = v0[:, None]
    x_ic = X_ref[:, 0].copy()
    x_ic[:, 1] = t0

    curv = track.curvature_np(s_hor).astype(np.float32)
    bl = track.left_boundary_np(s_hor).astype(np.float32)
    br = track.right_boundary_np(s_hor).astype(np.float32)
    vel = np.clip(track.velocity_np(s_hor),
                  v0[:, None] - 1.0, v0[:, None] + 1.0).astype(np.float32)

    ss_x = np.zeros((batch, K, nx), dtype=np.float32)
    ss_j = np.zeros((batch, K), dtype=np.float32)
    if manager is not None and K > 0:
        for b in range(batch):
            sx, sjc, _ = manager.query_padded(
                X_ref[b, -1], K, mpc.config.num_ss_pts_per_lap)
            ss_x[b], ss_j[b] = sx, sjc

    def dev(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    return MPCInput(
        x_ic=dev(x_ic),
        u_ic=torch.zeros((batch, nu), dtype=torch.float32, device=device),
        X_ref=dev(X_ref),
        U_ref=torch.zeros((batch, N - 1, nu), dtype=torch.float32, device=device),
        T_ref=torch.full((batch, N - 1), dt, dtype=torch.float32, device=device),
        bound_left=dev(bl),
        bound_right=dev(br),
        total_length=torch.full((batch,), L, dtype=torch.float32, device=device),
        curvatures=dev(curv),
        vel_ref=dev(vel),
        ss_x=dev(ss_x),
        ss_j=dev(ss_j),
    )


def scaling_bench(device_counts=None, batch_per_device: int = 64,
                  n_horizon: int = 20, num_ss: int = 48, reps: int = 5):
    """Weak-scaling benchmark (``benchmarks.py:98-143``): the batch grows
    with the rank count, so perfect scaling keeps the per-batch latency
    constant (efficiency = t_1 / t_N).

    Called by every rank of an initialized process group
    (``parallel.distributed.initialize``); ``device_counts`` are mesh sizes
    up to the group's (by default 1, 2, 4, ... up to it).  For each size the
    first ranks form a 1-D mesh, each solves its shard of a
    ``batch_per_device * size`` batch once to warm up and then ``reps``
    times, synchronizing its device after every repetition; a size's
    latency is the slowest rank's mean.  Returns the same list of dicts on
    every rank.
    """
    import time
    import torch.distributed as dist
    from racing_lmpc_torch.parallel import (
        make_mesh, shard_batch, sharded_batch_solver, sharded_metrics)
    from racing_lmpc_torch.parallel.mesh import mesh_device

    world, rank = dist.get_world_size(), dist.get_rank()
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= world]
    results = []
    t1 = None
    problem = None
    for nd in device_counts:
        mesh = make_mesh(range(nd))        # collective: every rank builds it
        device = mesh_device(mesh)
        stats = torch.zeros(2, dtype=torch.float64, device=device)
        if rank < nd:
            if problem is None:
                problem = build_barc_lmpc(n_horizon=n_horizon, num_ss=num_ss,
                                          device=device)
            _, track, _, mpc, manager = problem
            batch = batch_per_device * nd
            inp = make_scenario_batch(mpc, track, manager, batch, device=device)
            z = torch.zeros((batch, mpc.layout.n), dtype=torch.float32)
            valid = torch.zeros((batch,), dtype=torch.bool)
            args = tuple(shard_batch(x, mesh) for x in (inp, z, valid))
            solver = sharded_batch_solver(mpc, mesh)

            def sync():
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            out, _ = solver(*args)
            sync()
            total = 0.0
            for _ in range(reps):
                t0 = time.perf_counter()
                out, _ = solver(*args)
                sync()
                total += time.perf_counter() - t0
            frac, _ = sharded_metrics(out.solved, out.obj, mesh)
            stats[0], stats[1] = total / reps, float(frac)
        dist.all_reduce(stats, op=dist.ReduceOp.MAX)
        t, frac = float(stats[0]), float(stats[1])
        if t1 is None:
            t1 = t
        results.append({
            "devices": nd,
            "batch": batch_per_device * nd,
            "batch_latency_ms": round(t * 1e3, 2),
            "solves_per_s": round(batch_per_device * nd / t, 1),
            "weak_scaling_efficiency": round(t1 / t, 4),
            "solved_fraction": round(frac, 4),
        })
    return results
