"""Why the port accumulates the normal-equations product in float64.

On one GPU, from the repository root:

    python3 tests/torch_port_precision.py [case]

``case`` is a fixture of ``chip_smoke.py`` (default ``barc_n40_k96_b128``,
the shipped N=40/K=96 configuration).  The batch and the fixture's 8 moved
copies are solved on the card with the product A'DA of the IPM's Newton
matrix accumulated in f32 (cuBLAS) and in f64 (``ipm.NORMAL_EQ_DTYPE``), and
3 of them on the host in f32; each set of runs is read with
``chip_smoke.py``'s gates against the stored reference runs.  Then the wall
time of a batched solve on the card with each (f32, f64, f64, f32, median
of 5 each, synchronized after every repetition) and the device time of one
profiled solve with each.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_port_precision: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from racing_lmpc_torch.benchmarks import build_barc_lmpc, make_scenario_batch
    from racing_lmpc_torch.mpc import ipm

    case = sys.argv[1] if len(sys.argv) > 1 else "barc_n40_k96_b128"
    n_horizon, num_ss, per_lap, batch = cs.CASES[case]
    with np.load(cs.FIXTURE_DIR / f"{case}.npz") as z:
        fx = {k: z[k] for k in z.files}
    limits = cs.gate_limits(fx)
    built = {}
    for dev in ("cuda", "cpu"):
        _, track, _, mpc, manager = build_barc_lmpc(n_horizon, num_ss, per_lap, device=dev)
        built[dev] = mpc, make_scenario_batch(mpc, track, manager, batch=batch, device=dev)

    mpc, inp = built["cuda"]
    try:
        for dtype in (torch.float32, torch.float64):
            ipm.NORMAL_EQ_DTYPE = dtype
            cs.held_to_reference(cs.runs_like_reference(mpc, inp, fx), fx, limits,
                                 f"{case} on the card, A'DA in {dtype}")
        ipm.NORMAL_EQ_DTYPE = torch.float32
        cmpc, cinp = built["cpu"]
        runs = [cs.as_run(cmpc.solve_batch(cinp if s < 0 else cs.moved(cinp, s))[0])
                for s in (-1, 0, 1)]
        cs.held_to_reference(runs, fx, limits, f"{case} on the host, A'DA in {torch.float32}")

        for dtype in (torch.float32, torch.float64, torch.float64, torch.float32):
            ipm.NORMAL_EQ_DTYPE = dtype
            ms = cs.cuda_time_ms(lambda: mpc.solve_batch(inp), reps=5, warmup=1)
            print(f"{case} on the card, A'DA in {dtype}: {ms:.1f} ms per batch", flush=True)
        from torch.profiler import ProfilerActivity, profile
        for dtype in (torch.float32, torch.float64):
            ipm.NORMAL_EQ_DTYPE = dtype
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                mpc.solve_batch(inp)
                torch.cuda.synchronize()
            busy = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
            print(f"{case} on the card, A'DA in {dtype}: device busy {busy:.1f} ms",
                  flush=True)
    finally:
        ipm.NORMAL_EQ_DTYPE = torch.float64
    return 0


if __name__ == "__main__":
    sys.exit(main())
