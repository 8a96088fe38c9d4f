#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``racing_lmpc_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Set-up: needs CUDA; asserts the port's numerics policy (f32, no TF32);
   prints the card's name and power limit; builds every kernel from
   ``racing_lmpc_torch/csrc`` with nvcc.
2. Kernel phase: each kernel against its plain PyTorch version on the card,
   at the main path's shapes and at the other shipped sizes, plus a
   wide-spectrum case and a batch with one indefinite lane (NaN there
   only); times kernel, plain version and a library yardstick with CUDA
   events, synchronizing after every repetition.
3. Path phase: the flagship batched LMPC solve (N=20, K=48, batch 256),
   then the shipped configuration (N=40, K=96, batch 128), each through the
   port's entry points with every launch counter set to 0 just before and
   read just after.  Each is held against stored runs of the JAX reference
   (``tests/data/torch_port/<case>.npz``, written by
   ``tests/torch_port_fixture.py``): the batch itself and 8 copies with the
   inputs moved by one f32 rounding.  The port solves the same inputs; the
   median of its readings (spread from the reference's run on the same
   input, error from the certified f64 optimum) must stay within the
   reference's own worst reading.  A control solves them again with TF32
   products and must fail those gates.  Solves/s of each batch, and a
   profile of one flagship solve.

Prints one ``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``.  Any failed check raises, and the script
exits non-zero without that last line.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FIXTURE_DIR = ROOT / "tests" / "data" / "torch_port"
# fixture -> (n_horizon, num_ss, num_ss_per_lap, batch), as
# tests/torch_port_fixture.py wrote it
CASES = {"barc_n20_k48_b256": (20, 48, 16, 256),
         "barc_n40_k96_b128": (40, 96, 32, 128)}

# H100 SXM published peaks (NVIDIA data sheet) for the roofline bound
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12          # f32 outside the tensor cores


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median wall time of ``fn`` on the card in ms: CUDA events around
    each repetition, synchronized after every one."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def spd_batch(rng, G: int, n: int, cond_boost: float = 0.0) -> np.ndarray:
    """Seeded SPD batch A'A + n I, rows/cols optionally scaled by
    10^[0, cond_boost] to widen the spectrum (tests/test_linalg.py:17-24)."""
    A = rng.normal(size=(G, n, n)).astype(np.float32)
    H = np.einsum("bij,bik->bjk", A, A) + n * np.eye(n, dtype=np.float32)
    if cond_boost:
        s = 10.0 ** rng.uniform(0, cond_boost, size=(G, n)).astype(np.float32)
        H = H * s[:, :, None] * s[:, None, :]
    return H.astype(np.float32)


def kernel_phase(device) -> dict:
    """chol_tri_inv against its plain version on the card; returns the
    numbers of the main path's (256, 87, 87) case."""
    import torch
    from racing_lmpc_torch.ops import linalg

    def rel_err(a, b):
        a, b = a.double(), b.double()
        fin = torch.isfinite(b)
        return float((a[fin] - b[fin]).abs().max() / b[fin].abs().max().clamp(min=1e-30))

    def library(H):
        L = torch.linalg.cholesky(H)
        eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device).expand_as(H)
        return torch.linalg.solve_triangular(L, eye, upper=False)

    rng = np.random.default_rng(0)
    cases = [
        ("H, main path", spd_batch(rng, 256, 87), True),
        ("Schur block, main path", spd_batch(rng, 256, 1), True),
        ("H, N=40 K=96", spd_batch(rng, 128, 175), True),
        ("H, Putnam N=60 K=96", spd_batch(rng, 8, 216), True),
    ]
    # the IPM factors Jacobi-scaled matrices; a wide spectrum before scaling
    wide = spd_batch(rng, 64, 87, cond_boost=3.0)
    d = 1.0 / np.sqrt(np.einsum("bii->bi", wide))
    cases.append(("wide spectrum, Jacobi-scaled",
                  (wide * d[:, :, None] * d[:, None, :]).astype(np.float32), False))
    main = None
    for name, Hn, timed in cases:
        H = torch.as_tensor(Hn, device=device)
        K = linalg.chol_tri_inv(H)
        P = linalg.chol_tri_inv_plain(H)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(K).all()), f"{name}: kernel gave non-finite values")
        err = rel_err(K, P)
        check(err < 1e-4, f"{name} {tuple(H.shape)}: kernel vs plain {err:.2e} > 1e-4")
        check(bool((torch.triu(K, 1) == 0).all()), f"{name}: upper part not zero")
        line = f"kernel {name} {tuple(H.shape)}: max rel err vs plain {err:.3e}"
        if timed:
            G, n = H.shape[0], H.shape[-1]
            ms = cuda_time_ms(lambda: linalg.chol_tri_inv(H), reps=20)
            plain_ms = cuda_time_ms(lambda: linalg.chol_tri_inv_plain(H), reps=5)
            lib_ms = cuda_time_ms(lambda: library(H), reps=20)
            # the lower triangle of each symmetric input read once (all the
            # function needs), each dense output written once
            bytes_ms = G * (n * (n + 1) // 2 + n * n) * 4 / HBM_BYTES_PER_S * 1e3
            flops_ms = G * (2.0 / 3.0) * n ** 3 / F32_FLOP_PER_S * 1e3
            line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                     f"torch.linalg yardstick {lib_ms:.4f} ms, bound "
                     f"{max(bytes_ms, flops_ms):.5f} ms")
            if main is None:
                main = {"max_abs_err": float((K - P).abs().max()), "ms": ms,
                        "plain_ms": plain_ms, "library_ms": lib_ms,
                        "bound_ms": max(bytes_ms, flops_ms),
                        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}
        print(line, flush=True)

    # one indefinite lane: NaN there, every other lane untouched
    Hn = spd_batch(rng, 16, 87)
    Hn[5, 40, 40] = -1.0e4
    H = torch.as_tensor(Hn, device=device)
    K = linalg.chol_tri_inv(H)
    P = linalg.chol_tri_inv_plain(H)
    torch.cuda.synchronize()
    bad = ~torch.isfinite(K).flatten(1).all(dim=1)
    check(bad.tolist() == [i == 5 for i in range(16)],
          f"indefinite lane: non-finite lanes {bad.nonzero().flatten().tolist()}, want [5]")
    keep = torch.arange(16, device=device) != 5
    err = rel_err(K[keep], P[keep])
    check(err < 1e-4, f"indefinite batch: other lanes vs plain {err:.2e}")
    print(f"kernel indefinite lane: NaN in lane 5 only; others vs plain {err:.3e}",
          flush=True)
    return main


def profile_solve(mpc, inp, wall_ms: float) -> None:
    """Where one batched solve's time goes: device time summed over the
    CUDA kernels of one profiled solve, against the un-profiled wall time
    of a solve (their difference is the device's idle share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        mpc.solve_batch(inp)
        torch.cuda.synchronize()
    # kernel events only: a CPU op's self device time repeats its kernels'
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(r[2] for r in rows)
    launches = sum(r[1] for r in rows)
    print(f"profile N=20 K=48 batch 256: {launches} kernel launches, device busy "
          f"{busy:.1f} ms of {wall_ms:.1f} ms wall (idle share "
          f"{1 - busy / wall_ms:.3f})", flush=True)
    for key, count, t in sorted(rows, key=lambda r: -r[2])[:6]:
        print(f"  {t:8.2f} ms  {count:6d} x  {key[:90]}", flush=True)


def spread(a: dict, b: dict, su: np.ndarray) -> dict:
    """How far run ``a`` lies from run ``b`` (dicts of ``U``, ``obj``,
    ``solved`` over one batch): lanes whose ``solved`` differs, and the max
    over the lanes both solved of the longitudinal control's |dU| / scale_u
    (the well-conditioned part of the answer)."""
    both = a["solved"] & b["solved"]
    return {"solved differs": int((a["solved"] != b["solved"]).sum()),
            "lon max": float((np.abs(a["U"] - b["U"])[both][..., 0] / su[0]).max())}


def error(a: dict, fx) -> dict:
    """How far run ``a`` lies from the certified float64 optimum, over the
    lanes it solved whose optimum certifies: the max relative objective gap,
    and percentiles of the applied (stages 0-1) and tail steering's
    |U - U*| / scale_u (steering rides a cost-flat valley, so single lanes
    of two f32 runs can land far apart while both are near-optimal)."""
    ok = a["solved"] & np.isfinite(fx["obj_star"])
    star = fx["obj_star"][ok]
    gap = np.abs(a["obj"][ok] - star) / np.maximum(np.abs(star), 1.0)
    d = np.abs(a["U"] - fx["U_star"])[ok][..., 1] / fx["scale_u"][1]
    applied, tail = d[:, :2].max(-1), d[:, 2:].max(-1)
    return {"objective gap max": float(gap.max()),
            "applied steer p50": float(np.percentile(applied, 50)),
            "applied steer p90": float(np.percentile(applied, 90)),
            "steer tail p90": float(np.percentile(tail, 90))}


# the bound each gate keeps at the least: the port's specification (solved
# on >= 254 of 256 lanes as the reference, longitudinal 1e-3 of scale_u,
# applied steering 3e-3, steering tail 2e-2, objective 1e-3 relative)
GATE_FLOORS = {"solved differs": 2, "lon max": 1e-3, "objective gap max": 1e-3,
               "applied steer p50": 3e-3, "applied steer p90": 3e-3,
               "steer tail p90": 2e-2}


def reference_runs(fx) -> list[dict]:
    """The stored reference runs: the run on the batch itself, then its
    re-runs on the inputs moved by about one f32 rounding."""
    runs = [(fx["U_optm"], fx["obj"], fx["solved"])]
    runs += list(zip(fx["U_pert"], fx["obj_pert"], fx["solved_pert"]))
    return [{"U": U.astype(np.float64), "obj": o.astype(np.float64), "solved": s}
            for U, o, s in runs]


def gate_limits(fx) -> dict:
    """Each gate's limit: the reference's own worst reading over its stored
    runs (the largest spread between any two of them, the largest error of
    any one from the certified optimum), or the gate's floor where that is
    looser."""
    runs = reference_runs(fx)
    readings = [spread(a, b, fx["scale_u"]) for i, a in enumerate(runs)
                for b in runs[i + 1:]]
    readings += [error(a, fx) for a in runs]
    return {k: max(floor, *(r[k] for r in readings if k in r))
            for k, floor in GATE_FLOORS.items()}


def moved(inp, s: int):
    """The fixture's s-th moved input, reproduced: x_ic and X_ref scaled by
    1 + 2e-7 N(0, 1) from seed 1 + s, as tests/torch_port_fixture.py does."""
    import torch
    rng = np.random.default_rng(1 + s)

    def move(t):
        a = t.cpu().numpy()
        return torch.as_tensor((a * (1 + 2e-7 * rng.standard_normal(a.shape)))
                               .astype(np.float32), device=t.device)
    return inp._replace(x_ic=move(inp.x_ic), X_ref=move(inp.X_ref))


def as_run(out) -> dict:
    return {"U": out.U_optm.double().cpu().numpy(), "obj": out.obj.double().cpu().numpy(),
            "solved": out.solved.cpu().numpy()}


def runs_like_reference(mpc, inp, fx, first=None) -> list[dict]:
    """The port's runs on the reference's inputs: the batch itself (``first``
    if already solved), then each moved input the fixture holds."""
    first = first if first is not None else mpc.solve_batch(inp)[0]
    return [as_run(first)] + [as_run(mpc.solve_batch(moved(inp, s))[0])
                              for s in range(len(fx["U_pert"]))]


def held_to_reference(runs: list[dict], fx, limits: dict, label: str) -> list[str]:
    """Each gate reads every run against the reference's run on the same
    input (its spread) and against the certified optimum (its error); the
    median over the runs is held to the limit.  Prints the readings; returns
    the names of the gates whose median fails."""
    ref = reference_runs(fx)
    got = [{**spread(r, q, fx["scale_u"]), **error(r, fx)} for r, q in zip(runs, ref)]
    B = len(runs[0]["solved"])
    print(f"{label}, {len(runs)} runs on the reference's inputs: solved "
          f"{[int(r['solved'].sum()) for r in runs]} of {B} (reference "
          f"{[int(r['solved'].sum()) for r in ref]})", flush=True)
    failed = []
    for k, limit in limits.items():
        v = [g[k] for g in got]
        med = float(np.median(v))
        ok = med <= limit
        failed += [] if ok else [k]
        print(f"  {k}: median {med:.3e} (runs {min(v):.3e}..{max(v):.3e}), limit "
              f"{limit:.3e} {'ok' if ok else 'FAILS'}", flush=True)
    return failed


def drive_path(device, case: str, profile: bool = False) -> tuple:
    """One batched solve of fixture ``case`` through the port's entry points
    with every launch count set to 0 just before and read just after; its
    outputs, with the port's runs on the fixture's moved inputs, held
    against the stored reference runs; then its solves/s (and, if asked, a
    profiled solve).  Returns the kernel's launch count, the MPC, its input,
    the fixture and its gate limits."""
    import torch
    from racing_lmpc_torch.benchmarks import build_barc_lmpc, make_scenario_batch
    from racing_lmpc_torch.mpc.racing_mpc import MPCInput
    from racing_lmpc_torch.ops import linalg

    n_horizon, num_ss, per_lap, batch = CASES[case]
    with np.load(FIXTURE_DIR / f"{case}.npz") as z:
        fx = {k: z[k] for k in z.files}
    _, track, _, mpc, manager = build_barc_lmpc(n_horizon, num_ss, per_lap, device=device)
    inp = make_scenario_batch(mpc, track, manager, batch=batch, device=device)
    for name in MPCInput._fields:
        got, want = getattr(inp, name).cpu().numpy(), fx[f"inp_{name}"]
        check(got.shape == want.shape and np.allclose(got, want, rtol=1e-6, atol=1e-6),
              f"{case}: scenario input {name} differs from the fixture")

    linalg.chol_tri_inv.launches = 0
    out, _ = mpc.solve_batch(inp)
    torch.cuda.synchronize()
    launches = linalg.chol_tri_inv.launches
    print(f"path {case}: chol_tri_inv launched {launches} times", flush=True)
    check(0 < launches <= 150, f"{case}: chol_tri_inv launches {launches} not in (0, 150]")
    for name in ("X_optm", "U_optm", "dU_optm", "obj"):
        check(bool(torch.isfinite(getattr(out, name)).all()), f"{case}: {name} not finite")
    check(tuple(out.U_optm.shape) == fx["U_optm"].shape,
          f"{case}: U_optm shape {tuple(out.U_optm.shape)}")
    for b in np.flatnonzero(out.solved.cpu().numpy() != fx["solved"]):
        print(f"  lane {b}: port solved={bool(out.solved[b])} "
              f"rp_rel={float(out.rp_rel[b]):.3e} rd_rel={float(out.rd_rel[b]):.3e}; "
              f"reference solved={bool(fx['solved'][b])} r_prim={float(fx['r_prim'][b]):.3e} "
              f"r_dual={float(fx['r_dual'][b]):.3e}", flush=True)

    limits = gate_limits(fx)
    failed = held_to_reference(runs_like_reference(mpc, inp, fx, first=out), fx,
                               limits, f"{case} vs reference")
    check(not failed, f"{case}: outside the reference's own spread on {failed}")

    # throughput, synchronized after every repetition
    ms = cuda_time_ms(lambda: mpc.solve_batch(inp), reps=5, warmup=1)
    print(f"path {case}: {ms:.1f} ms per batch, {batch / (ms / 1e3):.1f} solves/s",
          flush=True)
    if profile:
        profile_solve(mpc, inp, ms)
    return launches, mpc, inp, fx, limits


def lower_precision_control(mpc, inp, fx, limits: dict) -> None:
    """The same runs with TF32 products (torch's reduced-precision f32
    matmul), the normal-equations product included, must fail at least one
    gate: gates that a lower-precision solve passes would not tell a faulty
    port from a sound one."""
    import torch
    from racing_lmpc_torch.mpc import ipm
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    ipm.NORMAL_EQ_DTYPE = torch.float32
    try:
        runs = runs_like_reference(mpc, inp, fx)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        ipm.NORMAL_EQ_DTYPE = torch.float64
    failed = held_to_reference(runs, fx, limits, "control: TF32 products vs reference")
    check(bool(failed), "a TF32 solve passes every gate: the gates cannot see precision")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import racing_lmpc_torch  # noqa: F401  (sets the numerics policy)
    from racing_lmpc_torch.ops import _kernels

    check(torch.get_default_dtype() == torch.float32, "default dtype is not f32")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is on")
    check(not torch.backends.cudnn.allow_tf32, "cuDNN TF32 is on")
    check(torch.get_float32_matmul_precision() == "highest",
          "f32 matmul precision is not 'highest'")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    device = torch.device("cuda", 0)

    t0 = time.perf_counter()
    log = _kernels.build("chol_tri_inv")
    print(f"built chol_tri_inv in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {line.strip()}", flush=True)

    k = kernel_phase(device)
    launches, mpc, inp, fx, limits = drive_path(device, "barc_n20_k48_b256",
                                                profile=True)
    lower_precision_control(mpc, inp, fx, limits)
    drive_path(device, "barc_n40_k96_b128")
    print(json.dumps({"kernels": [{
        "name": "chol_tri_inv", "route": "cuda",
        "source": "racing_lmpc_torch/csrc/chol_tri_inv.cu",
        "replaces": "racing_lmpc_tpu/ops/pallas_linalg.py:358",
        "launches": launches, **k}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
