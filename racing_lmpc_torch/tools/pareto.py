"""The accuracy/throughput trade of the solver knobs, both measured on one device.

    python -m racing_lmpc_torch.tools.pareto            # the card; writes PARETO_torch.json

The counterpart of ``scripts/pareto_bench.py``.  For each override set of
``--grid`` (``PARETO.json``'s 8 points by default):

- accuracy: ``ground_accuracy``'s engine records on the pinned instances
  (one exact copy each), held to the per-instance gates of
  ``ACCURACY.json``: ``gate_failures`` are the instances whose applied
  steering error reaches their ``applied_steer_gate`` (the reference
  tool's rule, ``scripts/pareto_bench.py:83-85``), ``objective_gap_failures``
  those whose objective gap reaches their ``obj_gap_gate``;
  ``passes_all_pinned_gates`` holds when both lists are empty.  One f32
  rounding of the inputs moves a single solve's steering and gap far, so
  ``copies_gate_failures`` also reads each instance as ``chip_smoke.py``'s
  accuracy phase does: the medians over it and 8 copies moved by one
  rounding against the same gates, and every copy solved;
- throughput, on the same device: solves/s of ``build_barc_lmpc(20, 48,
  **overrides)``'s scenario batch (``make_scenario_batch``, zero warm start)
  with a synchronize after every repetition (``bench._timed``), the median
  repetition; and the batch-1 chain of dependent solves
  (``bench.chain_solves``), in ms a solve, the median of 5 repetitions;
  with the ``chol_tri_inv`` launches a solve of each.  The points are timed
  in turns, each repetition over every point, since the host sets the pace
  and drifts over a sweep.

It writes one JSON record (``--out``, ``PARETO_torch.json`` by default)
with the reference record's keys, the device's name and power limit
(``nvidia-smi``) and a rationale derived from the record alone.  It changes
no default of the solver.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from racing_lmpc_torch.tools import ROOT, writable
from racing_lmpc_torch.tools.accuracy import ACC_DIR, ACC_REPLICAS, ACCURACY_JSON

OUT = ROOT / "PARETO_torch.json"
# PARETO.json's grid: the zoom ladder's depth, then cheaper zoom and IPM
# iteration counts at the shipped depth
GRID = [{"qp_zoom_rounds": 1}, {"qp_zoom_rounds": 2}, {"qp_zoom_rounds": 3},
        {"qp_zoom_rounds": 4}, {"qp_zoom_iters": 10, "qp_zoom_rounds": 4},
        {"qp_zoom_iters": 8, "qp_zoom_rounds": 4}, {"qp_ip_iters": 12, "qp_zoom_rounds": 4},
        {"qp_ip_iters": 10, "qp_zoom_rounds": 4}]
BATCH, REPS, CHAIN, CHAIN_REPS = 256, 10, 10, 5


def throughput(grid, device, batch: int = BATCH, reps: int = REPS, chain: int = CHAIN,
               chain_reps: int = CHAIN_REPS) -> list[dict]:
    """For each override set of ``grid``: solves/s of the N=20, K=48
    scenario batch (median of ``reps`` synchronized repetitions after one
    untimed solve), the batch-1 chain of ``chain`` dependent solves in ms a
    solve (median of ``chain_reps`` after one untimed chain), the first
    solve's solved fraction, and the ``chol_tri_inv`` launches a solve of
    each (counted in the untimed runs).  The points are timed in turns:
    every repetition times each point once, so that the host's drift over
    the sweep falls on every point alike."""
    import torch
    from racing_lmpc_torch.bench import _timed, chain_solves
    from racing_lmpc_torch.benchmarks import build_barc_lmpc, make_scenario_batch
    from racing_lmpc_torch.mpc.racing_mpc import map_input
    from racing_lmpc_torch.ops import linalg

    device = torch.device(device)
    solves, chains, out = [], [], []
    for overrides in grid:
        _, track, _, mpc, manager = build_barc_lmpc(n_horizon=20, num_ss=48, device=device,
                                                    **overrides)
        inp = make_scenario_batch(mpc, track, manager, batch, device=device)
        z = torch.zeros((batch, mpc.layout.n), dtype=torch.float32, device=device)
        valid = torch.zeros((batch,), dtype=torch.bool, device=device)
        inp1 = map_input(lambda a: a[:1], inp)
        solves.append(lambda mpc=mpc, inp=inp, z=z, valid=valid: mpc.solve_batch(inp, z, valid))
        chains.append(lambda mpc=mpc, inp1=inp1, z=z, valid=valid:
                      chain_solves(mpc, inp1, z[:1], valid[:1], chain))
        c0 = linalg.chol_tri_inv.launches
        first, _ = solves[-1]()
        c1 = linalg.chol_tri_inv.launches
        chains[-1]()
        out.append({"solved_fraction": float(first.solved.float().mean()),
                    "chol_tri_inv_per_solve_batch": c1 - c0,
                    "chol_tri_inv_per_solve_chain": (linalg.chol_tri_inv.launches - c1) / chain})
    ts = [[_timed(fn, device)[0] for fn in solves] for _ in range(reps)]
    tc = [[_timed(fn, device)[0] / chain for fn in chains] for _ in range(chain_reps)]
    for i, o in enumerate(out):
        o["solves_per_s"] = batch / float(np.median([t[i] for t in ts]))
        o["batch1_chain_ms"] = float(np.median([t[i] for t in tc])) * 1e3
    return out


def point(overrides: dict, records: dict, gates: dict, through: dict, batch: int) -> dict:
    """One point of the record from its engine records ({tag: record}), the
    pinned gates ({tag: gates}) and its ``throughput`` numbers."""
    fails = [t for t, v in records.items()
             if v["applied_steer_err"] >= gates[t]["applied_steer_gate"]]
    gap_fails = [t for t, v in records.items() if v["objective_gap"] >= gates[t]["obj_gap_gate"]]
    copy_fails = [f"{t} ({what})" for t, v in records.items() for what, bad in (
        ("applied steer", v["applied_steer_median"] >= gates[t]["applied_steer_gate"]),
        ("objective gap", v["objective_gap_median"] >= gates[t]["obj_gap_gate"]),
        ("unsolved copies", v["copies_solved"] < ACC_REPLICAS)) if bad]
    return {
        "overrides": overrides,
        "worst_applied_steer_err": max(v["applied_steer_err"] for v in records.values()),
        "gate_failures": fails,
        "passes_all_pinned_gates": not fails and not gap_fails,
        "solves_per_s_batch256_N20": through["solves_per_s"],
        "batch1_chain_ms": through["batch1_chain_ms"],
        "solved_fraction": through["solved_fraction"],
        "worst_objective_gap": max(v["objective_gap"] for v in records.values()),
        "objective_gap_failures": gap_fails,
        "unsolved_instances": [t for t, v in records.items() if not v["solved"]],
        "copies_gate_failures": copy_fails,
        "worst_applied_steer_median": max(v["applied_steer_median"] for v in records.values()),
        "worst_objective_gap_median": max(v["objective_gap_median"] for v in records.values()),
        "batch": batch,
        "chol_tri_inv_per_solve_batch": through["chol_tri_inv_per_solve_batch"],
        "chol_tri_inv_per_solve_chain": through["chol_tri_inv_per_solve_chain"],
    }


def rationale(points: list[dict], shipped: dict) -> str:
    """What the record says about the shipped default, from its points only."""
    def name(p):
        return json.dumps(p["overrides"], sort_keys=True)

    def speed(p):
        return p["solves_per_s_batch256_N20"]
    base = next((p for p in points
                 if p["overrides"] == {"qp_zoom_rounds": shipped["qp_zoom_rounds"]}), None)
    parts = []
    for p in points:
        fails = p["gate_failures"] + [f"{t} (objective gap)" for t in p["objective_gap_failures"]]
        copies = p["copies_gate_failures"]
        rel = f", {speed(p) / speed(base):.3f}x the default's solves/s" if base else ""
        parts.append(f"{name(p)}: {speed(p):.1f} solves/s{rel}, batch-1 chain "
                     f"{p['batch1_chain_ms']:.1f} ms a solve, worst applied steer "
                     f"{p['worst_applied_steer_err']:.3g}, worst objective gap "
                     f"{p['worst_objective_gap']:.3g}; "
                     + ("passes every pinned gate" if not fails else "fails " + ", ".join(fails))
                     + "; over the moved copies " + ("passes every pinned gate" if not copies
                                                     else "fails " + ", ".join(copies)))
    heads = []
    for label, ok in (("the exact instances", lambda p: p["passes_all_pinned_gates"]),
                      ("the moved copies", lambda p: not p["copies_gate_failures"])):
        passing = [p for p in points if ok(p)]
        best = max(passing, key=speed) if passing else None
        heads.append(f"On {label} " + (
            "no point passes every pinned gate" if best is None else
            f"the fastest point passing every pinned gate is {name(best)} "
            f"({speed(best):.1f} solves/s)")
            + ("" if base is None else "; the shipped default "
               + json.dumps(shipped, sort_keys=True) + (" passes" if ok(base) else " fails"))
            + ".")
    head = " ".join(heads)
    return head + " Points: " + "; ".join(parts) + "."


def device_info(device) -> tuple[str, float | None]:
    """(the device's name, its power limit in W): ``nvidia-smi``'s for a
    CUDA device, ("cpu", None) otherwise."""
    import torch
    if torch.device(device).type != "cuda":
        return "cpu", None
    from racing_lmpc_torch.bench import device_line
    name, limit = device_line().rsplit(",", 1)
    return name.strip(), float(limit.strip().split()[0])


def run(device, grid=GRID, out: Path | None = OUT, engine_runs: dict | None = None,
        batch: int = BATCH, reps: int = REPS, chain: int = CHAIN,
        chain_reps: int = CHAIN_REPS) -> dict:
    """The record on ``device`` over ``grid``; the engine records are taken
    from ``engine_runs`` (``ground_accuracy.run_engine``'s result) where it
    holds a grid point, else run on every pinned instance.  Writes ``out``
    unless it is None; returns the record."""
    from racing_lmpc_torch.config import RacingMPCConfig
    from racing_lmpc_torch.tools.ground_accuracy import run_engine

    if out is not None:
        out = writable(out)
    gates = json.loads(ACCURACY_JSON.read_text())["per_instance"]
    engine_runs = dict(engine_runs or {})
    missing = [g for g in grid if json.dumps(g, sort_keys=True) not in engine_runs]
    if missing:
        engine_runs.update(run_engine(ACC_DIR, None, device, missing))
    print(f"measuring throughput of {len(grid)} points in turns ...", flush=True)
    points = []
    for overrides, through in zip(grid, throughput(grid, device, batch, reps, chain,
                                                   chain_reps)):
        p = point(overrides, engine_runs[json.dumps(overrides, sort_keys=True)], gates,
                  through, batch)
        points.append(p)
        print(f"  {json.dumps(overrides, sort_keys=True)}: "
              f"{p['solves_per_s_batch256_N20']:.1f} solves/s, b1 "
              f"{p['batch1_chain_ms']:.1f} ms, worst {p['worst_applied_steer_err']:.2e}, "
              f"gate_fail={p['gate_failures']}, gap_fail={p['objective_gap_failures']}, "
              f"copies_fail={p['copies_gate_failures']}, launches "
              f"{p['chol_tri_inv_per_solve_batch']} / {p['chol_tri_inv_per_solve_chain']}",
              flush=True)
    cfg = RacingMPCConfig()
    shipped = {"qp_ip_iters": cfg.qp_ip_iters,
               "qp_zoom_iters": cfg.qp_zoom_iters or cfg.qp_ip_iters,
               "qp_zoom_rounds": cfg.qp_zoom_rounds}
    name, limit = device_info(device)
    doc = {
        "description": (
            "Accuracy/throughput Pareto of the port's QP engine, both sides on one "
            "device: accuracy on the pinned acceptance instances (one exact copy "
            "each; gates = ACCURACY.json, grounded in the reference's own OSQP-class "
            "scatter; gate_failures = applied steer >= its gate, objective_gap_failures "
            "= objective gap >= its gate, passes_all_pinned_gates = neither), "
            f"throughput of the N=20, K=48 BARC LMPC batch of {batch} (median of {reps} "
            f"synchronized repetitions) and the batch-1 chain of {chain} dependent "
            "solves (ms a solve), with chol_tri_inv launches a solve.  Written by "
            "python -m racing_lmpc_torch.tools.pareto."),
        "shipped_default": shipped,
        "rationale": rationale(points, shipped),
        "device": name,
        "power_limit_w": limit,
        "points": points,
    }
    if out is not None:
        out.write_text(json.dumps(doc, indent=1) + "\n")
        print(f"wrote {out}", flush=True)
    return doc


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--grid", type=str, default="",
                    help="JSON list of override dicts (default: PARETO.json's 8 points)")
    ap.add_argument("--out", type=Path, default=OUT)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    from racing_lmpc_torch import resolve_device
    run(resolve_device(args.device), json.loads(args.grid) if args.grid else GRID, args.out)

if __name__ == "__main__":
    main()
