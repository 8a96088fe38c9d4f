"""The scale-out report: weak scaling, its decomposition, a 2-D mesh and a
live two-process run over gloo ranks on the CPU, and NCCL on the card.

    python -m racing_lmpc_torch.tools.multihost_report     # writes MULTIHOST_torch.json

The counterpart of ``scripts/multihost_report.py`` on the port's
``parallel/`` (one process a rank, ``parallel.spawn``) and
``benchmarks.scaling_bench``, at the flagship shape (BARC LMPC N=20, K=48):

1. weak scaling of the sharded batch solve over 1/2/4 gloo ranks on the CPU,
   32 scenarios a rank;
2. its decomposition (``scripts/multihost_report.py:73-158``) in the same
   group of W ranks: one rank at the per-rank batch, and at W times it
   with W intra-op threads (the same cores as the W ranks, no sharding: the
   host's contention ceiling), then W ranks at W times the batch without
   and with the cross-shard metrics' collectives, with the reference tool's
   derived ratios;
3. the same solve on a 2-D ``make_mesh_2d`` (host=2, batch=2) mesh of 4
   ranks with ``sharded_metrics`` (the SUM and MIN all-reduces), held to the
   gathered flags' mean and the masked minimum;
4. a live two-process run: two ranks each solving its half of the global
   batch, against one rank solving its half alone (the weak-scaling
   ratio), the gathered solve against the unsharded one;
5. on a CUDA device, NCCL at world size 1 on the card: ``scaling_bench`` at
   the flagship batch of 256 and the metrics' all-reduce.

Each CPU rank runs one intra-op thread, so that the ranks do not contend for
threads and the comparison across world sizes measures the program and the
host's cores, not the thread pool.  Where one process's W threads use W
cores worse than W processes do (a host-bound solve of many small
operations), ``partition_efficiency_equal_work`` exceeds 1 and the
reference's ``predicted_hw_weak_scaling_eff`` with it: the naive efficiency
is then the report's number for the program.  The record's ``caveat`` says what one
card and CPU ranks can and cannot show.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from racing_lmpc_torch.tools import ROOT, writable

OUT = ROOT / "MULTIHOST_torch.json"
CPU_RANKS = (1, 2, 4)
BATCH_PER_DEVICE, REPS = 32, 3
FLAGSHIP = (20, 48)              # N, K: BARC LMPC
NCCL_BATCH = 256
CAVEAT = (
    "One H100 and CPU ranks: the gloo rows are processes on one host's CPU cores, "
    "so their efficiencies validate the sharded program and its collective path "
    "(and measure the host's core contention), not NVLink or network scaling; the "
    "NCCL row is one rank on one card, so it shows the NCCL path and the cost of "
    "its all-reduces, not cross-card scaling.  The 4-card NCCL run waits for a "
    "benchmark cell that needs it.")


def _problem(n_horizon: int, num_ss: int, batch: int, device):
    import torch
    from racing_lmpc_torch.benchmarks import build_barc_lmpc, make_scenario_batch
    _, track, _, mpc, manager = build_barc_lmpc(n_horizon, num_ss, device=device)
    inp = make_scenario_batch(mpc, track, manager, batch, device=device)
    z = torch.zeros((batch, mpc.layout.n), dtype=torch.float32)
    valid = torch.zeros((batch,), dtype=torch.bool)
    return mpc, (inp, z, valid)


def _sharded(mpc, args, mesh, axis="batch"):
    """The sharded solver of ``mpc`` on ``mesh`` and this rank's shards."""
    from racing_lmpc_torch.parallel import shard_batch, sharded_batch_solver
    return (sharded_batch_solver(mpc, mesh, axis=axis),
            tuple(shard_batch(x, mesh, axis=axis) for x in args))


def _mean_time(fn, reps: int, device) -> float:
    """Mean seconds of ``fn()`` over ``reps`` runs after one untimed run,
    synchronizing a CUDA device after each."""
    from racing_lmpc_torch.bench import _timed
    fn()
    return float(np.mean([_timed(fn, device)[0] for _ in range(reps)]))


def _gloo_rank(cpu_ranks, batch_per_device: int, n_horizon: int, num_ss: int,
               reps: int) -> dict:
    """One rank of the W-rank gloo group (W the largest of ``cpu_ranks``):
    weak scaling, then on W >= 2 the decomposition, then on W = 4 the 2-D
    mesh."""
    import torch
    import torch.distributed as dist
    from racing_lmpc_torch.benchmarks import scaling_bench
    from racing_lmpc_torch.parallel import make_mesh, make_mesh_2d, sharded_metrics
    from racing_lmpc_torch.parallel.distributed import process_allgather

    W, rank = dist.get_world_size(), dist.get_rank()
    cpu = torch.device("cpu")
    out = {"weak_scaling": scaling_bench(device_counts=list(cpu_ranks),
                                         batch_per_device=batch_per_device,
                                         n_horizon=n_horizon, num_ss=num_ss, reps=reps)}
    B = batch_per_device
    if W >= 2:
        one = make_mesh([0])              # collective: every rank builds it
        everyone = make_mesh()
        times = torch.zeros(4, dtype=torch.float64)
        for i, batch in enumerate((B, W * B)):
            if rank == 0:
                mpc, args = _problem(n_horizon, num_ss, batch, cpu)
                solver, shards = _sharded(mpc, args, one)
                # the full batch on the cores the W ranks use: W threads
                torch.set_num_threads(W if i else 1)
                times[i] = _mean_time(lambda: solver(*shards), reps, cpu)
                torch.set_num_threads(1)
            dist.barrier()
        mpc, args = _problem(n_horizon, num_ss, W * B, cpu)
        solver, shards = _sharded(mpc, args, everyone)

        def with_metrics():
            o, _ = solver(*shards)
            return sharded_metrics(o.solved, o.obj, everyone)
        times[2] = _mean_time(lambda: solver(*shards), reps, cpu)
        times[3] = _mean_time(with_metrics, reps, cpu)
        dist.all_reduce(times, op=dist.ReduceOp.MAX)
        t_1small, t_1big, t_comp, t_coll = times.tolist()
        ceiling = (W * B / t_1big) / (W * (B / t_1small))
        part_eff = t_1big / t_comp
        coll_frac = max(0.0, (t_coll - t_comp) / t_coll)
        out["decomposition"] = {
            "ranks": W, "batch_per_device": B,
            "t_1rank_smallbatch_ms": t_1small * 1e3, "t_1rank_fullbatch_ms": t_1big * 1e3,
            f"t_{W}rank_compute_only_ms": t_comp * 1e3,
            f"t_{W}rank_with_collectives_ms": t_coll * 1e3,
            f"naive_weak_scaling_eff_{W}rank": t_1small / t_comp,
            f"core_contention_ceiling_{W}rank": ceiling,
            "partition_efficiency_equal_work": part_eff,
            "collective_fraction": coll_frac,
            "predicted_hw_weak_scaling_eff": part_eff * (1.0 - coll_frac),
        }
    if W == 4:
        mesh2 = make_mesh_2d(host_size=2)
        axes = ("host", "batch")
        mpc, args = _problem(n_horizon, num_ss, W * B, cpu)
        solver, shards = _sharded(mpc, args, mesh2, axes)
        t = _mean_time(lambda: solver(*shards), reps, cpu)
        o, _ = solver(*shards)
        frac, cmin = sharded_metrics(o.solved, o.obj, mesh2)
        solved, obj = process_allgather((o.solved, o.obj))
        out["mesh_2d"] = {
            "mesh": "(host=2, batch=2)", "batch": W * B, "batch_latency_ms": t * 1e3,
            "solved_fraction_psum": float(frac), "min_cost_pmin": float(cmin),
            "gathered_solved_fraction": float(np.mean(solved)),
            "gathered_min_cost": float(obj[solved].min()) if solved.any() else float("inf"),
        }
    return out


def _two_process_rank(batch_per_device: int, n_horizon: int, num_ss: int, reps: int) -> dict:
    """One rank of the live two-process run: its half of the global batch
    alone (``t_local``) and sharded over both (``t_global``, with the
    metrics' collectives), the gathered solve and the metrics against the
    unsharded solve of the whole batch on this rank."""
    import torch
    import torch.distributed as dist
    from racing_lmpc_torch.mpc.racing_mpc import map_input
    from racing_lmpc_torch.parallel import sharded_metrics
    from racing_lmpc_torch.parallel.distributed import global_mesh, process_allgather

    cpu = torch.device("cpu")
    n = dist.get_world_size()
    mpc, (inp, z, valid) = _problem(n_horizon, num_ss, n * batch_per_device, cpu)
    mesh = global_mesh()
    solver, shards = _sharded(mpc, (inp, z, valid), mesh)

    def global_step():
        o, _ = solver(*shards)
        return o, sharded_metrics(o.solved, o.obj, mesh)
    # this rank's half alone
    lo = dist.get_rank() * batch_per_device
    half = (map_input(lambda a: a[lo:lo + batch_per_device], inp),
            z[lo:lo + batch_per_device], valid[lo:lo + batch_per_device])
    t_local = _mean_time(lambda: mpc.solve_batch(*half), reps, cpu)
    t_global = _mean_time(global_step, reps, cpu)
    o, (frac, cmin) = global_step()
    U, solved = process_allgather((o.U_optm, o.solved))
    whole, _ = mpc.solve_batch(inp, z, valid)
    w_solved = whole.solved.numpy()
    return {
        "rank": dist.get_rank(), "solved_fraction": float(frac), "min_cost": float(cmin),
        "unsharded_solved_fraction": float(np.mean(w_solved)),
        "unsharded_min_cost": float(whole.obj[whole.solved].min()) if w_solved.any()
        else float("inf"),
        "solved_equal_unsharded": bool(np.array_equal(solved, w_solved)),
        "U_max_abs_diff_vs_unsharded": float(np.abs(U - whole.U_optm.numpy()).max()),
        "checksum": float(np.sum(U)),
        "t_local_ms": t_local * 1e3, "t_global_ms": t_global * 1e3,
    }


def _nccl_rank(batch: int, n_horizon: int, num_ss: int, reps: int) -> dict:
    """The NCCL rank on the card (world size 1): ``scaling_bench`` at the
    flagship batch, the metrics' all-reduce time, the rank's
    ``chol_tri_inv`` launches and its card."""
    import torch
    import torch.distributed as dist
    from racing_lmpc_torch.benchmarks import scaling_bench
    from racing_lmpc_torch.parallel import sharded_metrics
    from racing_lmpc_torch.parallel.distributed import global_mesh
    from racing_lmpc_torch.ops import linalg

    device = torch.device("cuda", torch.cuda.current_device())
    c0 = linalg.chol_tri_inv.launches
    bench = scaling_bench(device_counts=[1], batch_per_device=batch,
                          n_horizon=n_horizon, num_ss=num_ss, reps=reps)
    mesh = global_mesh()
    solved = torch.ones(batch, dtype=torch.bool, device=device)
    obj = torch.arange(batch, dtype=torch.float32, device=device)
    ms = _mean_time(lambda: sharded_metrics(solved, obj, mesh), 50, device) * 1e3
    return {"backend": dist.get_backend(), "world_size": dist.get_world_size(),
            "device": torch.cuda.get_device_name(device), "scaling_bench": bench,
            "metrics_allreduce_ms": ms,
            "chol_tri_inv_launches": linalg.chol_tri_inv.launches - c0}


def report(device, cpu_ranks=CPU_RANKS, batch_per_device: int = BATCH_PER_DEVICE,
           reps: int = REPS, shape=FLAGSHIP, nccl_batch: int = NCCL_BATCH,
           timeout: float = 3000.0) -> dict:
    """The report: the gloo parts over ``cpu_ranks`` (none when empty; the
    live two-process run when 2 is among them), NCCL at world size 1 when
    ``device`` is CUDA."""
    import torch
    from racing_lmpc_torch.parallel.spawn import spawn

    n_horizon, num_ss = shape
    doc = {
        "generated": time.strftime("%Y-%m-%d %H:%M:%S"),
        "target": ">=90% weak-scaling efficiency from 1 host to >=2 hosts "
                  "(BASELINE.md, a multi-host criterion)",
        "caveat": CAVEAT,
        "flagship_shape": f"BARC LMPC N={n_horizon}, K={num_ss}",
        "cpu_threads_per_rank": 1,
    }
    if cpu_ranks:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)        # each rank takes the caller's count
        try:
            W = max(cpu_ranks)
            g = spawn(W, "racing_lmpc_torch.tools.multihost_report:_gloo_rank", list(cpu_ranks),
                      batch_per_device, n_horizon, num_ss, reps, device="cpu",
                      timeout=timeout)[0]
            doc["weak_scaling_gloo_cpu"] = g["weak_scaling"]
            for key, name in (("decomposition", "scaling_decomposition"),
                              ("mesh_2d", "mesh_2d_host_batch")):
                if key in g:
                    doc[name] = g[key]
            if 2 in cpu_ranks:
                ranks = spawn(2, "racing_lmpc_torch.tools.multihost_report:_two_process_rank",
                              batch_per_device, n_horizon, num_ss, reps, device="cpu",
                              timeout=timeout)
                r0 = ranks[0]
                doc["two_process_gloo"] = {
                    "processes": 2, "batch": 2 * batch_per_device,
                    **{k: r0[k] for k in ("solved_fraction", "min_cost",
                                          "unsharded_solved_fraction", "unsharded_min_cost",
                                          "solved_equal_unsharded",
                                          "U_max_abs_diff_vs_unsharded")},
                    "ranks_agree": all(r["checksum"] == r0["checksum"] for r in ranks),
                    "weak_scaling_ratio_local_vs_global": r0["t_local_ms"] / r0["t_global_ms"],
                    "t_local_ms": r0["t_local_ms"], "t_global_ms": r0["t_global_ms"],
                }
        finally:
            torch.set_num_threads(threads)
    if torch.device(device).type == "cuda":
        from racing_lmpc_torch.tools.pareto import device_info
        doc["nccl_world_size_1"] = spawn(
            1, "racing_lmpc_torch.tools.multihost_report:_nccl_rank", nccl_batch, n_horizon,
            num_ss, reps, device="cuda", timeout=timeout)[0]
        doc["nccl_world_size_1"]["power_limit_w"] = device_info(device)[1]
    return doc


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", type=Path, default=OUT)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    from racing_lmpc_torch import resolve_device
    out = writable(args.out)
    doc = report(resolve_device(args.device))
    out.write_text(json.dumps(doc, indent=2) + "\n")
    print(json.dumps(doc, indent=2), flush=True)
    print(f"wrote {out}", flush=True)


if __name__ == "__main__":
    main()
