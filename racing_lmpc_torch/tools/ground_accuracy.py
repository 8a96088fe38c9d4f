"""Ground the acceptance gates in the reference's own solver (OSQP), on the port.

    python -m racing_lmpc_torch.tools.ground_accuracy --osqp --engine --finalize
    python -m racing_lmpc_torch.tools.ground_accuracy --engine --grid '[{"qp_zoom_rounds": 3}]'

The counterpart of ``scripts/ground_accuracy.py``, with its four steps and
flags; every step runs on the card unless ``--device cpu`` is given, and
writes under ``--out`` (``build/ground_accuracy/`` by default), never over
the reference's records (``ACCURACY.json``, ``tests/data/acc_instances/``):

1. ``--capture``: the three acceptance co-simulations (BARC tracking with
   laterally deviated copies, BARC LMPC with the recorded safe set, Putnam
   tracking) at the shipped MPC config through the port's ``CoSimulation``;
   at the capture steps, the cycle's ``MPCInput`` (``build_step_input``
   after ``_query_safe_set``, as the controller builds it), its f64
   reference QP (``mpc/reference_qp.py``) and that QP's optimum, certified
   by the dense f64 oracle.  Writes each instance as an ``.npz`` with the
   reference tool's keys and a ``manifest.json`` under
   ``<out>/acc_instances/``.
2. ``--osqp``: the port's f64 OSQP (``mpc/osqp_ref.py``) on every instance
   from 3 starts (cold, and the optimum moved by 0.01 and by 0.1 N(0, 1)
   from numpy seed 0, drawn instance by instance in the manifest's order)
   at 3 adaptive-rho intervals (0, 25, 100); for each run its status,
   iterations and the deviation of its controls and objective from the
   certified optimum.  Writes ``<out>/osqp_runs.json``.
3. ``--engine``: one exact copy of every instance solved by the port's
   engine through ``CoSimulation(_SCENARIOS[scenario], n_override,
   mpc_overrides=...)`` at each override set of ``--grid`` (the shipped
   config by default), read with ``tools.accuracy.acc_reading``: the
   reference tool's errors and ``solved``, and the objective gap and the
   other gates that the reading computes; then the instance with its 8
   copies moved by one f32 rounding, read as ``chip_smoke.py``'s accuracy
   phase reads it (the medians over the copies), since one rounding moves a
   single solve's steering and gap far (tests/_torch_twin.py::
   replay_instance).  Writes ``<out>/engine_runs.json``.
4. ``--finalize``: the gates from those records, by the reference tool's
   formulas: ``max(1e-3, min(median OSQP applied-steer deviation, 3e-3))``
   (strict 1e-3 where no OSQP run was accepted) and ``max(2e-5, min(median
   OSQP objective gap, 1e-3))``.  Writes ``<out>/ACCURACY.json``.

The steps read the pinned instances (``tests/data/acc_instances``); after
``--capture`` in the same command they read the ones it wrote.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time
from pathlib import Path

import numpy as np

from racing_lmpc_torch.tools import BUILD_DIR, writable
from racing_lmpc_torch.tools.accuracy import ACC_DIR, acc_reading, controls, load_instances

OUT_DIR = BUILD_DIR / "ground_accuracy"
# (scenario, horizon, capture steps, deviated copies too), the reference
# tool's capture points (scripts/ground_accuracy.py:65-70)
CAPTURE = (
    ("barc_tracking_mpc", 20, (6, 18, 30), True),
    ("barc_lmpc", 20, (6, 16, 28), False),
    ("putnam_short_tracking_mpc", 30, (8, 20), False),
)
DEV_LAT = 0.18                  # m of lateral offset of a deviated copy
OSQP_STARTS = ("cold", "near", "far")
RHO_INTERVALS = (0, 25, 100)


def _scenario_mpc(scenario: str, n_override: int, overrides: dict | None, device):
    from racing_lmpc_torch.launch.runner import _SCENARIOS, CoSimulation
    return CoSimulation(_SCENARIOS[scenario], n_override=n_override,
                        mpc_overrides=dict(overrides or {}), device=device)


def _write_json(path: Path, doc) -> Path:
    path = writable(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(doc, indent=1))
    print(f"wrote {path}", flush=True)
    return path


def capture(out_dir: Path, device, points=CAPTURE) -> Path:
    """Step 1 on ``device``: ``points`` (``CAPTURE``'s layout) captured into
    ``<out_dir>/acc_instances/``.  Returns that directory."""
    from racing_lmpc_torch.carry import mpc_input_from_arrays
    from racing_lmpc_torch.mpc.reference_qp import (
        build_reference_qp, kkt_residuals, solve_dense_qp_f64)

    inst_dir = writable(Path(out_dir) / "acc_instances")
    inst_dir.mkdir(parents=True, exist_ok=True)
    np_of = lambda t: t.detach().cpu().numpy()  # noqa: E731
    manifest = []
    idx = 0
    for name, n, at, deviate in points:
        cs = _scenario_mpc(name, n, None, device)
        ctrl = cs.controller
        mpc = ctrl.mpc
        items = []
        for i in range(max(at) + 1):
            if i in at and ctrl.state is not None:
                msg = cs.vehicle_state_msg()
                x = ctrl._f32([msg.p.s, msg.p.x_tran, msg.p.e_psi,
                               msg.v.v_long, msg.v.v_tran, msg.w.w_psi])
                ss_x, ss_j = ctrl._query_safe_set(ctrl.state.last_X[-1])
                inp, zw, _ = ctrl.build_step_input(
                    x, ctrl._f32(cs._u_prev), ctrl.state, ss_x, ss_j,
                    ctrl._f32(ctrl.speed_limit), ctrl._f32(ctrl.speed_scale))
                fields = {k: np_of(v) for k, v in inp._asdict().items() if v is not None}
                items.append((f"{name}[{i}]", fields, np_of(zw)))
            cs.step()
        if deviate:
            for tag, fields, zw in list(items):
                x2 = fields["x_ic"].copy()
                x2[1] += DEV_LAT
                items.append((tag.replace("[", "_dev["), {**fields, "x_ic": x2}, zw))

        for tag, fields, zw in items:
            t0 = time.perf_counter()
            qp = build_reference_qp(mpc.model, mpc.config,
                                    mpc_input_from_arrays(fields, device=device), device=device)
            z_star, y_star = solve_dense_qp_f64(qp)
            rp, rd, rc = kkt_residuals(qp, z_star, y_star)
            if not (rp < 1e-8 and rc < 1e-5):
                raise RuntimeError(f"{tag}: oracle not certified (rp {rp:.2e}, rc {rc:.2e})")
            fname = f"{idx:02d}_{tag.replace('[', '_').replace(']', '')}.npz"
            np.savez_compressed(
                inst_dir / fname,
                P=np_of(qp.P), q=np_of(qp.q), A=np_of(qp.A), l=np_of(qp.l), u=np_of(qp.u),
                z_star=np_of(z_star), y_star=np_of(y_star),
                scale_u=np.asarray(mpc.scale_u), scale_x=np.asarray(mpc.scale_x), zw=zw,
                **{f"inp_{k}": v for k, v in fields.items()})
            h = hashlib.sha256((inst_dir / fname).read_bytes()).hexdigest()[:16]
            manifest.append({
                "file": fname, "tag": tag, "scenario": name, "n_override": n,
                "nvar": int(qp.layout.n), "nrow": int(qp.A.shape[0]),
                "learning": bool(qp.layout.learning),
                "objective_star": qp.objective(z_star),
                "oracle_kkt": [float(rp), float(rd), float(rc)],
                "sha256_16": h,
            })
            print(f"captured {tag} -> {fname} ({time.perf_counter() - t0:.1f} s)", flush=True)
            idx += 1
    _write_json(inst_dir / "manifest.json", {
        "description": "acceptance QP instances: f64 reference QP "
                       "(racing_mpc.cpp transcription) + certified optimum, "
                       "captured by the port",
        "capture_config": "shipped defaults (mpc_overrides={})",
        "instances": manifest})
    return inst_dir


def _osqp_starts(insts, tags) -> list:
    """Each instance's (rec, arrays, starts) for the instances of ``tags``
    (all when None): the cold start and the optimum moved by 0.01 and 0.1
    N(0, 1), drawn from numpy seed 0 instance by instance in the manifest's
    order, so that an instance's starts do not depend on which are run."""
    rng = np.random.default_rng(0)
    out = []
    for rec, d in insts:
        z = d["z_star"]
        starts = [np.zeros_like(z), z + 0.01 * rng.standard_normal(len(z)),
                  z + 0.1 * rng.standard_normal(len(z))]
        if tags is None or rec["tag"] in tags:
            out.append((rec, d, starts))
    return out


def run_osqp(inst_dir: Path, out_dir: Path, device, tags=None) -> dict:
    """Step 2 on ``device``: the 9 OSQP runs of every instance (of ``tags``,
    or all).  Returns the records and writes ``<out_dir>/osqp_runs.json``."""
    import torch
    from racing_lmpc_torch.mpc import osqp_ref

    _, insts = load_instances(inst_dir)
    results = {}
    for rec, d, starts in _osqp_starts(insts, tags):
        P, q, A, l, u = (torch.as_tensor(d[k], device=device) for k in "PqAlu")
        z_star = d["z_star"]
        su = d["scale_u"]
        U_star = controls(d)
        obj_star = 0.5 * z_star @ (d["P"] @ z_star) + d["q"] @ z_star
        runs = []
        for start, x0 in zip(OSQP_STARTS, starts):
            for interval in RHO_INTERVALS:
                t0 = time.perf_counter()
                res = osqp_ref.solve(P, q, A, l, u, x0=torch.as_tensor(x0, device=device),
                                     adaptive_rho_interval=interval)
                x = res.x.cpu().numpy()
                wall = time.perf_counter() - t0
                rel = np.abs(controls(d, x) - U_star) / su
                obj = 0.5 * x @ (d["P"] @ x) + d["q"] @ x
                runs.append({
                    "start": start, "adaptive_rho_interval": interval,
                    "status": res.status, "iters": int(res.iters),
                    "polished": bool(res.polished),
                    "applied_steer_dev": float(rel[:2, 1].max()),
                    "steer_tail_dev": float(rel[:, 1].max()),
                    "lon_dev": float(rel[:, 0].max()),
                    "obj_gap_rel": float(abs(obj - obj_star) / max(abs(obj_star), 1.0)),
                    "wall_s": wall,
                })
                print(f"osqp {rec['tag']} {runs[-1]}", flush=True)
        acc = [r for r in runs if r["status"] == "solved"]
        devs = [r["applied_steer_dev"] for r in acc]
        gaps = [r["obj_gap_rel"] for r in acc]
        results[rec["tag"]] = {
            "runs": runs,
            "n_accepted": len(acc),
            "applied_steer_dev_median": float(np.median(devs)) if devs else None,
            "applied_steer_dev_max": float(np.max(devs)) if devs else None,
            "obj_gap_rel_median": float(np.median(gaps)) if gaps else None,
        }
    _write_json(Path(out_dir) / "osqp_runs.json", results)
    return results


def engine_record(exact: dict, copies: dict) -> dict:
    """An engine record from ``acc_reading`` of the exact instance solved
    alone (``exact``): the reference tool's fields (``applied_steer_err``,
    ``steer_tail_err``, ``lon_err``, ``solved``), then the objective gap and
    the other gates of the reading; and from ``acc_reading`` of the instance
    with its moved copies (``copies``, as ``chip_smoke.py``'s accuracy phase
    reads it): the medians over the copies and how many solved."""
    return {
        "applied_steer_err": exact["applied steer"],
        "steer_tail_err": exact["steer tail"],
        "lon_err": exact["lon max"],
        "solved": exact["solved"] == 1,
        "objective_gap": exact["gap exact"],
        "infeasibility_max": exact["infeasibility max"],
        "unexplained_beat": exact["unexplained beat"],
        "drift": exact["drift"],
        "same_inf": exact["same inf"],
        "applied_steer_median": copies["applied steer"],
        "steer_tail_median": copies["steer tail"],
        "objective_gap_median": copies["objective gap"],
        "copies_solved": copies["solved"],
    }


def run_engine(inst_dir: Path, out_dir: Path | None, device, grid=None,
               tags=None) -> dict:
    """Step 3 on ``device``: one exact copy of every instance (of ``tags``,
    or all) through the engine at each override set of ``grid`` (the shipped
    config when None), and the instance with its ``ACC_REPLICAS - 1`` moved
    copies (``engine_record``).  Returns {json key of the overrides: {tag: record}}
    and writes ``<out_dir>/engine_runs.json`` unless ``out_dir`` is None."""
    _, insts = load_instances(inst_dir)
    all_res = {}
    for overrides in grid or [{}]:
        key = json.dumps(overrides, sort_keys=True)
        mpcs, res = {}, {}
        for rec, d in insts:
            if tags is not None and rec["tag"] not in tags:
                continue
            scen = (rec["scenario"], rec["n_override"])
            if scen not in mpcs:
                mpcs[scen] = _scenario_mpc(*scen, overrides, device).controller.mpc
            res[rec["tag"]] = r = engine_record(
                acc_reading(mpcs[scen], rec, d, device, replicas=1)[0],
                acc_reading(mpcs[scen], rec, d, device)[0])
            print(f"engine {key} {rec['tag']}: applied={r['applied_steer_err']:.2e} "
                  f"tail={r['steer_tail_err']:.2e} gap={r['objective_gap']:.2e} "
                  f"solved={r['solved']}", flush=True)
        all_res[key] = res
        worst = max(v["applied_steer_err"] for v in res.values())
        print(f"== {key}: worst applied steer {worst:.3e}", flush=True)
    if out_dir is not None:
        _write_json(Path(out_dir) / "engine_runs.json", all_res)
    return all_res


def gates(osqp: dict) -> tuple[float, float]:
    """(applied-steer gate, objective-gap gate) of an instance from its OSQP
    records: the measured scatter of the reference's own solver, the steer
    gate within [1e-3, 3e-3] and the gap gate within [2e-5, 1e-3]; the
    strict lower limit where no OSQP run was accepted (no auto-grant)."""
    med, gmed = osqp["applied_steer_dev_median"], osqp["obj_gap_rel_median"]
    steer = 1e-3 if med is None else float(max(1e-3, min(med, 3e-3)))
    gap = 2e-5 if gmed is None else float(max(2e-5, min(gmed, 1e-3)))
    return steer, gap


def finalize(inst_dir: Path, out_dir: Path) -> dict:
    """Step 4: ``<out_dir>/ACCURACY.json`` from ``osqp_runs.json`` and
    ``engine_runs.json`` in ``out_dir`` (the shipped config's engine records,
    or the first set's), over the instances the OSQP records cover, in the
    manifest's order.  Returns the document."""
    out_dir = Path(out_dir)
    osqp_res = json.loads((out_dir / "osqp_runs.json").read_text())
    eng_all = json.loads((out_dir / "engine_runs.json").read_text())
    eng = eng_all.get("{}", next(iter(eng_all.values())))
    man, _ = load_instances(inst_dir)
    per_instance = {}
    for rec in man["instances"]:
        tag = rec["tag"]
        if tag not in osqp_res:
            continue
        o = osqp_res[tag]
        steer_gate, gap_gate = gates(o)
        per_instance[tag] = {
            "engine_applied_steer_err": eng[tag]["applied_steer_err"],
            "engine_steer_tail_err": eng[tag]["steer_tail_err"],
            "engine_lon_err": eng[tag]["lon_err"],
            "engine_objective_gap": eng[tag]["objective_gap"],
            "osqp_applied_steer_dev_median": o["applied_steer_dev_median"],
            "osqp_applied_steer_dev_max": o["applied_steer_dev_max"],
            "osqp_obj_gap_rel_median": o["obj_gap_rel_median"],
            "osqp_accepted_runs": o["n_accepted"],
            "applied_steer_gate": steer_gate,
            "obj_gap_gate": gap_gate,
            "instance_file": rec["file"],
            "instance_sha256_16": rec["sha256_16"],
        }
    doc = {
        "description": (
            "Per-instance acceptance accuracy of the port, grounded in the "
            "reference's actual solver: OSQP defaults + polish at f64 "
            "(racing_mpc.cpp:85-103), the port's mpc/osqp_ref.py on the "
            "instances from 3 warm starts x 3 adaptive-rho intervals.  "
            "applied_steer_gate = max(1e-3, min(median OSQP deviation, 3e-3)); "
            "obj_gap_gate = max(2e-5, min(median OSQP objective gap, 1e-3))."),
        "engine_config": "shipped defaults" if "{}" in eng_all else next(iter(eng_all)),
        "instances": str(inst_dir),
        "per_instance": per_instance,
    }
    _write_json(out_dir / "ACCURACY.json", doc)
    for tag, v in per_instance.items():
        print(f"  {tag:30s} engine={v['engine_applied_steer_err']:.2e} "
              f"osqp_med={v['osqp_applied_steer_dev_median']} "
              f"gate={v['applied_steer_gate']:.1e}", flush=True)
    return doc


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--capture", action="store_true")
    ap.add_argument("--osqp", action="store_true")
    ap.add_argument("--engine", action="store_true")
    ap.add_argument("--finalize", action="store_true")
    ap.add_argument("--grid", type=str, default="",
                    help="JSON list of override dicts for --engine")
    ap.add_argument("--out", type=Path, default=OUT_DIR,
                    help="directory of the outputs (default: build/ground_accuracy)")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    from racing_lmpc_torch import resolve_device
    device = resolve_device(args.device)
    out = writable(args.out)
    for name in ("acc_instances", "osqp_runs.json", "engine_runs.json", "ACCURACY.json"):
        writable(out / name)        # refuse before any step runs
    inst_dir = capture(out, device) if args.capture else ACC_DIR
    print(f"instances: {inst_dir}", flush=True)
    if args.osqp:
        run_osqp(inst_dir, out, device)
    if args.engine:
        run_engine(inst_dir, out, device, json.loads(args.grid) if args.grid else None)
    if args.finalize:
        finalize(inst_dir, out)


if __name__ == "__main__":
    main()
