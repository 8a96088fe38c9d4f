"""Where a double-track LMPC solve's device time goes, for a checkout of
this repository: its own ``chip_smoke.py`` problem and its own kernels.

    python3 tests/torch_port_dt_profile.py [ROOT]

ROOT (this repository by default) may be another checkout, an earlier
commit's unpacked with ``git archive``: its port builds its kernels into its
own ``build/``.  For each case of ``chip_smoke.DT_LMPC_FIXTURE_CASES``
(``iac_car_lmpc`` N=60, n = 275, batch 32 through ``solve_batch``;
``sample_mpc`` N=50, n = 244, batch 1 through ``_solve_impl``): one untimed
solve of the stored inputs, three timed (host clock, synchronized, median),
then one under the profiler (the device's activity only): kernel launches,
device busy ms, the idle share against the timed median, ``chol_tri_inv``'s
ms and share of busy, and a hash of the first solve's controls (the same
bits give the same hash).  Prints the card's name and power limit first and one
JSON line last.  Needs one GPU; imports no JAX.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_port_dt_profile: no CUDA device", file=sys.stderr)
        return 1
    # the checkout's own chip_smoke.py and port
    root = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parents[1]).resolve()
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from racing_lmpc_torch.mpc.racing_mpc import MPCInput
    from racing_lmpc_torch.ops import _kernels, linalg
    from torch.profiler import ProfilerActivity
    if not Path(linalg.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"the port imported from {linalg.__file__}, not from {root}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    _kernels.build()
    dev = torch.device("cuda", 0)
    result = {"root": str(root)}
    for case in cs.DT_LMPC_FIXTURE_CASES:
        fx = cs.load_fixture(case)
        model, _, mpc, fields = cs.dt_lmpc_problem(case, dev)
        inp = cs.fixture_input(fx, MPCInput(**{k: torch.as_tensor(v, device=dev)
                                               for k, v in fields.items()}), dev)
        solve = cs.dt_lmpc_solver(mpc, cs.DT_LMPC_CASES[case][-1])
        first = solve(inp)
        torch.cuda.synchronize()
        secs = []
        for _ in range(3):
            t = time.perf_counter()
            out = solve(inp)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
        wall = float(np.median(secs)) * 1e3
        with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
            solve(inp)
            torch.cuda.synchronize()
        rows = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(r[2] for r in rows)
        chol = [r for r in rows if "chol_tri_inv" in r[0]]
        chol_ms = sum(r[2] for r in chol)
        result[case] = {
            "wall_ms": wall, "device_busy_ms": busy, "idle_share": 1 - busy / wall,
            "launches": sum(r[1] for r in rows), "chol_tri_inv_ms": chol_ms,
            "chol_tri_inv_share_of_busy": chol_ms / busy,
            "chol_tri_inv_launches": sum(r[1] for r in chol),
            "same_as_first": bool(torch.equal(out.U_optm, first.U_optm)),
            "U_sha256": hashlib.sha256(first.U_optm.cpu().numpy().tobytes()).hexdigest()[:16]}
        print(f"{case}: {json.dumps(result[case])}", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
