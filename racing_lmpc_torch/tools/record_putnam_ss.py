"""Record the Putnam-short warm-start safe set (seed laps for the LMPC).

    python -m racing_lmpc_torch.tools.record_putnam_ss [--scale 0.55] [--laps 3]

The counterpart of ``scripts/record_putnam_ss.py``, with its spec: the
tracking controller of ``putnam_short_tracking_mpc`` started from the LMPC
scenario's launch state and rate (``x0`` at 10 m/s, dt = 0.1 s), so that the
first recorded lap holds the launch transient the LMPC must reproduce, and
a conservative velocity scale (0.55), so that the safe-set query's convex
hull stays dynamically feasible (the reference tool's docstring gives the
reasons).  A ``SafeSetRecorder`` is fed every cycle's state, previous
control, curvature and time and writes each completed lap as
``ss_lap_<i>_{x,u,k,t}.txt`` under ``--out`` (``build/ss/putnam_short/`` by
default), never into the shipped laps (``racing_lmpc_torch/data/ss``, the
port's copy of the reference's) nor the reference's own.
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

import numpy as np

from racing_lmpc_torch.tools import BUILD_DIR, writable

OUT_DIR = BUILD_DIR / "ss" / "putnam_short"


def record(out: Path, scale: float = 0.55, laps: int = 3, max_steps: int = 6000,
           device=None, log_every: int = 100) -> dict:
    """Drive the recording run on ``device`` until ``laps`` full laps (after
    the first abscissa wrap) are written under ``out`` or ``max_steps``
    cycles have run.  Returns the laps, steps, lap times and fallback share,
    and every recorded row (``x``, ``u``, ``k``, ``t``) in cycle order."""
    from racing_lmpc_torch.launch.runner import _SCENARIOS, CoSimulation
    from racing_lmpc_torch.safeset import SafeSetManager, SafeSetRecorder

    out = writable(out)
    out.mkdir(parents=True, exist_ok=True)
    lmpc = _SCENARIOS["putnam_short_lmpc"]
    spec = dataclasses.replace(
        _SCENARIOS["putnam_short_tracking_mpc"], name="putnam_short_ss_recording",
        x0_global=lmpc.x0_global, dt=lmpc.dt, velocity_profile_scale=scale)
    cs = CoSimulation(spec, device=device)
    # the tracking controller has learning=False: a recorder of its own
    rec = SafeSetRecorder(SafeSetManager(laps + 1, nx=6, nu=2), to_file=True,
                          file_prefix=str(out / "ss_"))
    rows = {"x": [], "u": [], "k": [], "t": []}
    steps = 0
    while rec.lap_count < laps + 1 and steps < max_steps:
        msg = cs.vehicle_state_msg()
        x = np.array([msg.p.s, msg.p.x_tran, msg.p.e_psi,
                      msg.v.v_long, msg.v.v_tran, msg.w.w_psi])
        k_now = float(cs.track.curvature_np(x[0]))
        u_prev = np.asarray(cs._u_prev, dtype=np.float64)
        rec.step(x, u_prev, k_now, cs._t, cs.track.total_length)
        for key, v in zip(rows, (x, u_prev, k_now, cs._t)):
            rows[key].append(v)
        cs.plant_cycle(cs.controller_cycle(msg))
        steps += 1
        if log_every and steps % log_every == 0:
            print(f"[{steps:5d}] lap={rec.lap_count} s={msg.p.s:8.2f} "
                  f"v={msg.v.v_long:6.2f} solved={cs.telemetry[-1].solved}", flush=True)
    fallback = float(np.mean([not t.solved for t in cs.telemetry]))
    print(f"done: {rec.lap_count} laps in {steps} steps, lap_times={rec.lap_times}, "
          f"fallback={fallback:.3f}", flush=True)
    return {"laps": rec.lap_count, "steps": steps, "lap_times": rec.lap_times,
            "fallback": fallback, "rows": {k: np.asarray(v) for k, v in rows.items()}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scale", type=float, default=0.55,
                    help="velocity_profile_scale for the recording run")
    ap.add_argument("--laps", type=int, default=3)
    ap.add_argument("--out", type=Path, default=OUT_DIR,
                    help="output directory (default: build/ss/putnam_short)")
    ap.add_argument("--max-steps", type=int, default=6000)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    res = record(args.out, args.scale, args.laps, args.max_steps, args.device)
    missing = [f"ss_lap_{i}_{s}.txt" for i in range(1, args.laps + 1) for s in "xukt"
               if not (Path(args.out) / f"ss_lap_{i}_{s}.txt").exists()]
    if missing:
        raise RuntimeError(f"the run ended before recording {missing}")
    if res["fallback"] > 0.05:
        print("WARNING: recording run itself had high fallback", flush=True)


if __name__ == "__main__":
    main()
