"""Readings of the correctness check over many seeds, from which each limit
in ``limits/<cell>.json`` is set: the port as the configuration states it
(float32 without TF32, the normal equations in float64) and the control,
the port's own lower-precision path (TF32 products and the normal
equations in float32), each seed at the cell's batch and traffic, in one
process.

    python3 -m lmpc_bench.calibrate --workload <cell> --seeds 1,2,... \\
        [--control-seeds 3,4,...] [--steps K]

Each seed runs ``K`` steps of the cell's traffic (by default one pass over
its pool) and prints one JSON line of the check's readings.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from lmpc_bench import check, run, system
from lmpc_bench.generator import Traffic


def readings_of(cell, mpc, seed: int, steps: int, device, batch=None) -> dict:
    traffic = Traffic(cell["mix"], cell["config"], seed, device, batch)
    pools, hosts = [], []
    for _ in range(steps):
        p, host = system.step(mpc, traffic)
        pools.append(p)
        hosts.append(host)
    picks = check.pick(seed, steps, traffic.batch, int(cell["mix"]["check_lanes"]))
    return check.readings(cell["config"], traffic, pools, hosts, picks, device)


def main(argv=None, device=None, batch=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m lmpc_bench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--steps", type=int, default=0)
    args = p.parse_args(argv)
    import torch
    cell = run.load_cell(args.workload)
    if device is None:
        if not torch.cuda.is_available():
            print("calibrate: no CUDA device", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    mix = cell["mix"]
    steps = args.steps or int(mix["pool"])
    mpc = system.build_mpc(cell["config"], device)
    runs = [("program", s, False) for s in args.seeds.split(",") if s]
    runs += [("control", s, True) for s in args.control_seeds.split(",") if s]
    for label, seed, low in runs:
        system.lower_precision(low)
        t = time.perf_counter()
        try:
            values = readings_of(cell, mpc, int(seed), steps, device, batch)
        finally:
            system.lower_precision(False)
        correct, _ = check.judge(values, cell["limits"])
        print(json.dumps({"label": label, "seed": int(seed), "steps": steps,
                          "seconds": time.perf_counter() - t, "correct": correct, **values}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
