#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``racing_lmpc_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Set-up: needs CUDA; asserts the port's numerics policy (f32, no TF32);
   prints the card's name and power limit; builds every kernel from
   ``racing_lmpc_torch/csrc`` with nvcc, one compiler per source, side by
   side.
2. Kernel phase: each kernel against its plain PyTorch version on the card,
   at the paths' shapes and at the other shipped sizes; ``chol_tri_inv``
   also bit for bit against its step mirror ``chol_tri_inv_sweep``, on a
   wide-spectrum case and a batch with one indefinite lane (NaN there
   only), and its raise above n=240; ``gj_inverse`` on a pivoting case,
   exact |pivot| ties, the edges of its size classes (b = 1 to 64) and a
   singular lane in each class: the same pivots, the same non-finite
   entries and the same bits on the finite ones as the plain version, and
   its raise above b=64.  Times kernel, plain version and a library
   yardstick with CUDA events, synchronizing after every repetition, and
   the kernel's and the yardstick's device time under the profiler;
   ``chol_tri_inv`` also beside the one-SM floor of a batch-1 chain,
   ``gj_inverse`` beside the operation floor of its bit-exact algorithm.
3. Batched paths: the flagship batched LMPC solve (N=20, K=48, batch 256),
   then the shipped configuration (N=40, K=96, batch 128), each held against
   stored runs of the JAX reference (``tests/data/torch_port/<case>.npz``,
   written by ``tests/torch_port_fixture.py``): the batch itself and 8
   copies with the inputs moved by one f32 rounding; the median of the
   port's readings must stay within the reference's own worst reading.  A
   control solves them again with TF32 products and must fail those gates.
   Solves/s of each batch, and a profile of one flagship solve.
4. Controller paths: the closed-loop co-simulation of the BARC LMPC
   (N=40, K=96, 20 cycles) and Putnam LMPC (N=60, K=96, SQP
   re-linearization, 8 cycles) launch scenarios through the port's
   ``CoSimulation``; per-cycle wall time and a profiled cycle; the car stays
   on the track, falls back no more and gets as far as the reference's runs
   (``tests/data/torch_port/ctrl_<scenario>.npz``) allow.  Then the port's
   controller is fed each stored run's per-cycle states and previous
   controls (teacher forcing), and the median of its readings against
   those runs must stay within the reference's worst reading between its
   own runs.  A shorter tracking run covers the controller without a safe
   set.

Every path is driven with every launch counter set to 0 just before and
read just after.  Prints one ``{"kernels": [...]}`` line, and as its last
line ``{"ok": true, "device": {...}}``.  Any failed check raises, and the
script exits non-zero without that last line.  It imports nothing of JAX.
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

# controller fixture -> (launch scenario, closed-loop cycles), as
# tests/torch_port_fixture.py wrote it (the first cycle bootstraps)
CTRL_CASES = {"ctrl_barc_lmpc": ("barc_lmpc", 20),
              "ctrl_putnam_short_lmpc": ("putnam_short_lmpc", 8)}
# stored reference runs the port is teacher-forced on: the run itself and
# its four moved re-runs, all five on both paths
CTRL_REPLAYS = {"ctrl_barc_lmpc": 5, "ctrl_putnam_short_lmpc": 5}

# H100 SXM published peaks (NVIDIA data sheet) for the roofline bound
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12          # f32 outside the tensor cores
# f32 instructions a second outside the tensor cores, one operation each
# (132 SMs x 128 lanes x 1.98 GHz): the rate of separately rounded
# multiplies and subtracts, which cannot pair into FMAs
F32_INSTR_PER_S = 132 * 128 * 1.98e9
SM_COUNT = 132                  # for the one-SM floor of a batch-1 chain


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


def device_ms(fn, reps: int) -> float:
    """Device time of one call of ``fn`` in ms: the CUDA kernels' time under
    the profiler, summed over ``reps`` calls and divided by ``reps`` (the
    host's launch overhead, which ``cuda_time_ms`` includes, left out)."""
    import torch
    from torch.profiler import ProfilerActivity
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / reps


def same_bits(a, b) -> bool:
    """NaN in the same places, every other entry bit for bit."""
    import torch
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))
                and torch.equal(torch.where(nan, 0.0, a).view(torch.int32),
                                torch.where(nan, 0.0, b).view(torch.int32)))


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
    """chol_tri_inv on the card against its plain version (within 1e-4) and
    against its step mirror ``chol_tri_inv_sweep`` (bit for bit: both round
    every operation alike); returns the numbers of the main path's
    (256, 87, 87) case."""
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
        ("H, BARC LMPC controller N=40 K=96", spd_batch(rng, 1, 175), True),
        ("H, Putnam LMPC controller N=60 K=96", spd_batch(rng, 1, 216), True),
    ]
    # the IPM factors Jacobi-scaled matrices; a wide spectrum before scaling
    wide = spd_batch(rng, 64, 87, cond_boost=3.0)
    d = 1.0 / np.sqrt(np.einsum("bii->bi", wide))
    cases.append(("wide spectrum, Jacobi-scaled",
                  (wide * d[:, :, None] * d[:, None, :]).astype(np.float32), False))
    cases.append(("Schur block, controller", spd_batch(rng, 1, 1), True))
    # the panel edges: whole panels, one pivot into a new panel, the last
    # variant (its last panel holds 2 of 4 row tiles) and the limit
    for n in (32, 64, 96, 97, 225, 240):
        cases.append((f"panel edge n={n}", spd_batch(rng, 4, n), False))
    main = None
    for name, Hn, timed in cases:
        H = torch.as_tensor(Hn, device=device)
        K = linalg.chol_tri_inv(H)
        P = linalg.chol_tri_inv_plain(H)
        S = linalg.chol_tri_inv_sweep(H)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(K).all()), f"{name}: kernel gave non-finite values")
        err = rel_err(K, P)
        check(err < 1e-4, f"{name} {tuple(H.shape)}: kernel vs plain {err:.2e} > 1e-4")
        check(same_bits(K, S), f"{name} {tuple(H.shape)}: kernel not bit-equal to the "
              f"sweep mirror (max diff {float((K - S).abs().max()):.3e})")
        check(bool((torch.triu(K, 1) == 0).all()), f"{name}: upper part not zero")
        line = (f"kernel {name} {tuple(H.shape)}: max rel err vs plain {err:.3e}, "
                f"bit-equal to the sweep mirror")
        if timed:
            G, n = H.shape[0], H.shape[-1]
            ms = cuda_time_ms(lambda: linalg.chol_tri_inv(H), reps=20)
            dev = device_ms(lambda: linalg.chol_tri_inv(H), reps=20)
            plain_ms = cuda_time_ms(lambda: linalg.chol_tri_inv_plain(H), reps=5)
            lib_ms = cuda_time_ms(lambda: library(H), reps=20)
            lib_dev = device_ms(lambda: library(H), reps=20)
            # the lower triangle of each symmetric input read once (all the
            # function needs), each dense output written once
            bytes_ms = G * (n * (n + 1) // 2 + n * n) * 4 / HBM_BYTES_PER_S * 1e3
            flops_ms = G * (2.0 / 3.0) * n ** 3 / F32_FLOP_PER_S * 1e3
            # one matrix's pivots are a dependent chain on one SM
            floor_ms = (2.0 / 3.0) * n ** 3 / (F32_FLOP_PER_S / SM_COUNT) * 1e3
            line += (f"; kernel {ms:.4f} ms a call ({dev:.4f} ms on the device), plain "
                     f"{plain_ms:.4f} ms, torch.linalg yardstick {lib_ms:.4f} ms a call "
                     f"({lib_dev:.4f} ms on the device), bound "
                     f"{max(bytes_ms, flops_ms):.5f} ms, one-SM floor {floor_ms:.5f} ms; "
                     f"kernel {'<=' if ms <= lib_ms else '>'} yardstick")
            if main is None:
                main = {"max_abs_err": float((K - P).abs().max()), "ms": ms,
                        "device_ms": dev, "plain_ms": plain_ms, "library_ms": lib_ms,
                        "bound_ms": max(bytes_ms, flops_ms),
                        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}
        print(line, flush=True)

    # one indefinite lane: NaN there (from the bad pivot's row on), every
    # other lane untouched
    Hn = spd_batch(rng, 16, 87)
    Hn[5, 40, 40] = -1.0e4
    H = torch.as_tensor(Hn, device=device)
    K = linalg.chol_tri_inv(H)
    P = linalg.chol_tri_inv_plain(H)
    S = linalg.chol_tri_inv_sweep(H)
    torch.cuda.synchronize()
    bad = ~torch.isfinite(K).flatten(1).all(dim=1)
    check(bad.tolist() == [i == 5 for i in range(16)],
          f"indefinite lane: non-finite lanes {bad.nonzero().flatten().tolist()}, want [5]")
    check(bool(torch.isfinite(K[5, :40]).all()), "indefinite lane: NaN above the bad pivot")
    check(same_bits(K, S), "indefinite batch: kernel not bit-equal to the sweep mirror")
    check(bool((torch.triu(K, 1) == 0).all()), "indefinite batch: upper part not zero")
    keep = torch.arange(16, device=device) != 5
    err = rel_err(K[keep], P[keep])
    check(err < 1e-4, f"indefinite batch: other lanes vs plain {err:.2e}")
    print(f"kernel indefinite lane: NaN in lane 5 only, rows >= 40; others vs plain "
          f"{err:.3e}; bit-equal to the sweep mirror", flush=True)
    big = linalg.chol_max_n() + 1
    try:
        linalg.chol_tri_inv(torch.zeros(1, big, big, device=device))
    except ValueError as e:
        print(f"kernel chol_tri_inv refuses n={big}: {e}", flush=True)
    else:
        raise AssertionError(f"chol_tri_inv took n={big}")
    return main


def hadamard_tie_batch(rng) -> np.ndarray:
    """(16, 16, 16) Sylvester-Hadamard matrices (orders 4, 8, 16, padded with
    an identity) with rows permuted, row signs flipped and columns scaled by
    powers of two: every |entry| of a column ties, so each step's pivot is
    a tie, and Gauss-Jordan on them is exact in f32."""
    out = []
    for n in (4, 8, 16, 16):
        H = np.ones((1, 1))
        while H.shape[0] < n:
            H = np.block([[H, H], [H, -H]])
        for _ in range(4):
            M = H[rng.permutation(n)] * rng.choice([-1.0, 1.0], size=(n, 1))
            M = M * 2.0 ** rng.integers(-3, 4, size=(1, n))
            full = np.eye(16)
            full[:n, :n] = M
            out.append(full)
    return np.asarray(out, np.float32)


def gj_kernel_phase(device) -> dict:
    """gj_inverse against its plain version on the card: the same pivots,
    the same non-finite pattern and, as both round every operation alike,
    the same bits on every finite entry, in every case (the size classes'
    edges and a singular lane in each class among them); returns the
    numbers of the (65536, 16, 16) case, with every timed shape's under
    ``shapes``."""
    import torch
    from racing_lmpc_torch.ops import linalg

    rng = np.random.default_rng(1)

    def invertible(G, b):
        A = rng.normal(size=(G, b, b)) + 2.0 * np.sqrt(b) * np.eye(b)
        return A.astype(np.float32)

    def with_singular_lane(G, b):
        A = invertible(G, b)
        A[3] = 0.0
        return A

    pivoting = np.array([[[0, 1, 0], [1, 0, 0], [0, 0, 1]]], np.float32)
    random16 = rng.normal(size=(33, 16, 16)).astype(np.float32) + 4 * np.eye(16, dtype=np.float32)
    cases = [("pivoting", pivoting, False), ("random (tests/test_linalg.py)", random16, False),
             ("exact ties", hadamard_tie_batch(rng), False),
             ("one singular lane", with_singular_lane(8, 16), False)]
    # the kernel's size classes (b <= 16, 32, 64) and their edges
    cases += [(f"class edge b={b}", invertible(37, b), False)
              for b in (1, 2, 15, 16, 17, 31, 32, 33, 48, 63, 64)]
    cases += [(f"one singular lane b={b}", with_singular_lane(8, b), False) for b in (32, 64)]
    cases += [("b=16", invertible(65536, 16), True), ("b=32", invertible(4096, 32), True),
              ("b=64", invertible(1024, 64), True)]
    shapes = []
    for name, An, timed in cases:
        A = torch.as_tensor(An, device=device)
        before = linalg.gj_inverse.launches
        K, pk = linalg.gj_inverse(A, return_pivots=True)
        P, pp = linalg.gj_inverse_plain(A, return_pivots=True)
        torch.cuda.synchronize()
        check(linalg.gj_inverse.launches == before + 1, f"gj {name}: not one launch")
        check(bool(torch.equal(pk, pp)), f"gj {name}: kernel pivots differ from plain")
        fin = torch.isfinite(P)
        check(bool(torch.equal(fin, torch.isfinite(K))), f"gj {name}: non-finite pattern differs")
        err = float((K[fin] - P[fin]).abs().max()) if bool(fin.any()) else 0.0
        check(bool(torch.equal(K[fin].view(torch.int32), P[fin].view(torch.int32))),
              f"gj {name} {tuple(A.shape)}: kernel not bit-equal to plain on the finite "
              f"entries (max |diff| {err:.3e})")
        line = (f"kernel gj_inverse {name} {tuple(A.shape)}: same pivots, same non-finite "
                f"entries, bit-equal on the finite ones")
        if name == "exact ties":
            check(bool(torch.equal(K @ A, torch.eye(16, device=device).expand_as(A))),
                  "gj ties: inverse not exact")
        if name.startswith("one singular lane"):
            bad = ~fin.flatten(1).all(dim=1)
            check(bad.tolist() == [i == 3 for i in range(8)],
                  f"gj {name}: non-finite lanes {bad.nonzero().flatten().tolist()}")
        if timed:
            G, b = A.shape[0], A.shape[-1]
            ms = cuda_time_ms(lambda: linalg.gj_inverse(A), reps=20)
            dev = device_ms(lambda: linalg.gj_inverse(A), reps=20)
            plain_ms = cuda_time_ms(lambda: linalg.gj_inverse_plain(A), reps=5)
            lib_ms = cuda_time_ms(lambda: torch.linalg.inv(A), reps=20)
            lib_dev = device_ms(lambda: torch.linalg.inv(A), reps=20)
            # each input read once, each inverse written once; 2 b^3 flops a
            # matrix (LAPACK's getrf + getri count of an inverse)
            bytes_ms = 8.0 * G * b * b / HBM_BYTES_PER_S * 1e3
            flops_ms = 2.0 * G * b ** 3 / F32_FLOP_PER_S * 1e3
            # the bit-exact algorithm's own floor (kernel note): 4 b^3
            # separately rounded multiplies and subtracts and 2 b^2 IEEE
            # divisions (8 instructions each) a matrix at the f32 issue rate
            op_floor_ms = G * (4.0 * b ** 3 + 8 * 2.0 * b * b) / F32_INSTR_PER_S * 1e3
            line += (f"; kernel {ms:.4f} ms a call ({dev:.4f} ms on the device), plain "
                     f"{plain_ms:.4f} ms, torch.linalg.inv yardstick {lib_ms:.4f} ms a call "
                     f"({lib_dev:.4f} ms on the device), bound "
                     f"{max(bytes_ms, flops_ms):.5f} ms, operation floor {op_floor_ms:.5f} ms; "
                     f"kernel {'<=' if ms <= lib_ms else '>'} yardstick")
            shapes.append({"shape": list(A.shape), "max_abs_err": err, "ms": ms,
                           "device_ms": dev, "plain_ms": plain_ms, "library_ms": lib_ms,
                           "library_device_ms": lib_dev, "bound_ms": max(bytes_ms, flops_ms),
                           "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"})
        print(line, flush=True)
    for bad_input, exc in ((torch.zeros(2, 65, 65, device=device), ValueError),
                           (torch.zeros(2, 8, 8, device=device, dtype=torch.float64), TypeError)):
        before = linalg.gj_inverse.launches
        try:
            linalg.gj_inverse(bad_input)
        except exc as e:
            print(f"kernel gj_inverse refuses {tuple(bad_input.shape)} {bad_input.dtype}: {e}",
                  flush=True)
        else:
            raise AssertionError(f"gj_inverse took {tuple(bad_input.shape)} {bad_input.dtype}")
        check(linalg.gj_inverse.launches == before, "gj_inverse launched on a refused input")
    main = {k: v for k, v in shapes[0].items() if k != "shape"}
    return {**main, "shapes": shapes}


def profile(fn, wall_ms: float, label: str) -> float:
    """Where one call's time goes: device time summed over the CUDA kernels
    of one profiled call of ``fn``, against the un-profiled wall time of a
    call (their difference is the device's idle share, returned)."""
    import torch
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # kernel events only: a CPU op's self device time repeats its kernels'
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(r[2] for r in rows)
    launches = sum(r[1] for r in rows)
    idle = 1 - busy / wall_ms
    print(f"profile {label}: {launches} kernel launches, device busy "
          f"{busy:.1f} ms of {wall_ms:.1f} ms wall (idle share {idle:.3f})", flush=True)
    for key, count, t in sorted(rows, key=lambda r: -r[2])[:6]:
        print(f"  {t:8.2f} ms  {count:6d} x  {key[:90]}", flush=True)
    return idle


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


def drive_path(device, case: str, profiled: bool = False) -> tuple:
    """One batched solve of fixture ``case`` through the port's entry points
    with every launch count set to 0 just before and read just after; its
    outputs, with the port's runs on the fixture's moved inputs, held
    against the stored reference runs; then its solves/s (and, if asked, a
    profiled solve).  Returns the kernels' launch counts, the MPC, its
    input, the fixture and its gate limits."""
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

    zero_launches()
    out, _ = mpc.solve_batch(inp)
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"path {case}: launches {launches}", flush=True)
    check(0 < launches["chol_tri_inv"] <= 150,
          f"{case}: chol_tri_inv launches {launches['chol_tri_inv']} not in (0, 150]")
    check(launches["gj_inverse"] == 0, f"{case}: gj_inverse launched on the path")
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
    if profiled:
        profile(lambda: mpc.solve_batch(inp), ms, f"{case} solve")
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


def zero_launches() -> None:
    from racing_lmpc_torch.ops import linalg
    linalg.chol_tri_inv.launches = 0
    linalg.gj_inverse.launches = 0


def read_launches() -> dict:
    from racing_lmpc_torch.ops import linalg
    return {"chol_tri_inv": linalg.chol_tri_inv.launches,
            "gj_inverse": linalg.gj_inverse.launches}


# the bound each controller gate keeps at the least, as for the batched
# gates: the port's specification (no fallback where the reference solved,
# applied longitudinal control 1e-3 of scale_u, applied steering 3e-3,
# objective 1e-3 relative)
CTRL_FLOORS = {"fallback where reference solved": 0, "lon max": 1e-3,
               "steer p50": 3e-3, "steer p90": 3e-3, "objective max": 1e-3}


def ctrl_reading(a: dict, b: dict, su: np.ndarray) -> dict:
    """How far controller run ``a`` lies from run ``b`` (dicts of per-cycle
    ``u_apply``, ``obj``, ``used_fallback``): the cycles where ``a`` fell
    back and ``b`` solved, and over the cycles both solved the max
    |du_apply| / scale_u of the longitudinal control, percentiles of the
    steering's (the steering rides the condensed QP's cost-flat valley, as
    the batched gates' steering readings do) and the max relative objective
    difference."""
    both = ~a["used_fallback"] & ~b["used_fallback"]
    du = np.abs(a["u_apply"] - b["u_apply"])[both] / su
    dobj = (np.abs(a["obj"] - b["obj"])[both]
            / np.maximum(np.abs(b["obj"][both]), 1.0))
    steer = du[:, -1] if len(du) else np.zeros(1)
    return {"fallback where reference solved":
                int((a["used_fallback"] & ~b["used_fallback"]).sum()),
            "lon max": float(du[:, 0].max(initial=0.0)),
            "steer p50": float(np.percentile(steer, 50)),
            "steer p90": float(np.percentile(steer, 90)),
            "objective max": float(dobj.max(initial=0.0))}


def ctrl_runs(fx) -> list[dict]:
    """The stored reference controller runs: the run itself, then its
    re-runs with every state moved by about one f32 rounding."""
    return [{"u_apply": fx["u_apply"][r].astype(np.float64),
             "obj": fx["obj"][r].astype(np.float64),
             "used_fallback": fx["used_fallback"][r]}
            for r in range(len(fx["u_apply"]))]


def ctrl_limits(fx) -> dict:
    """Each controller gate's limit: the reference's worst reading between
    any two of its stored runs, or the gate's floor where that is looser."""
    runs = ctrl_runs(fx)
    readings = [ctrl_reading(a, b, fx["scale_u"]) for i, a in enumerate(runs)
                for j, b in enumerate(runs) if i != j]
    return {k: max(floor, *(r[k] for r in readings))
            for k, floor in CTRL_FLOORS.items()}


def teacher_forced(scenario: str, fx, r: int, device, **cosim_kw) -> dict:
    """A fresh port controller of ``scenario`` fed the stored run ``r``'s
    per-cycle state and previous control (what the reference's controller
    was handed), so that the plant cannot amplify differences."""
    import torch
    from racing_lmpc_torch.launch.runner import _SCENARIOS, CoSimulation
    ctrl = CoSimulation(_SCENARIOS[scenario], device=device, **cosim_kw).controller
    rows = []
    for x, u in zip(fx["x_ctrl"][r], fx["u_ic"][r]):
        info = ctrl.step(x, u)
        rows.append(torch.cat([info.u_apply, info.output.obj[None],
                               info.used_fallback[None].float()]).cpu().numpy())
    rows = np.stack(rows).astype(np.float64)
    return {"u_apply": rows[:, :-2], "obj": rows[:, -2], "used_fallback": rows[:, -1] > 0.5}


def held_ctrl(port: list[dict], fx, limits: dict, label: str) -> list[str]:
    """Each controller gate reads every port run against the reference's
    run on the same inputs; the median over the runs is held to the limit.
    Prints the readings; returns the names of the gates whose median
    fails."""
    got = [ctrl_reading(p, q, fx["scale_u"]) for p, q in zip(port, ctrl_runs(fx))]
    print(f"{label}, {len(port)} teacher-forced runs: fallbacks "
          f"{[int(p['used_fallback'].sum()) for p in port]} (reference "
          f"{fx['used_fallback'].sum(axis=1)[:len(port)].tolist()})", flush=True)
    failed = []
    for k, limit in limits.items():
        v = [g[k] for g in got]
        med = float(np.median(v))
        ok = med <= limit
        failed += [] if ok else [k]
        print(f"  {k}: median {med:.3e} (runs {min(v):.3e}..{max(v):.3e}), limit "
              f"{limit:.3e} {'ok' if ok else 'FAILS'}", flush=True)
    return failed


def closed_loop(device, scenario: str, steps: int):
    """``steps`` lock-step cycles of the port's co-simulation of a launch
    scenario, the launch counts set to 0 just before and read just after.
    Returns the co-simulation, the launches, and per cycle the plant's
    abscissa, lateral offset and lap after the cycle."""
    import torch
    from racing_lmpc_torch.launch.runner import _SCENARIOS, CoSimulation
    cs = CoSimulation(_SCENARIOS[scenario], device=device)
    zero_launches()
    plant = []
    for _ in range(steps):
        msg = cs.plant_cycle(cs.controller_cycle(cs.vehicle_state_msg()))
        plant.append((msg.p.s, msg.p.x_tran, cs.lap_num))
    torch.cuda.synchronize()
    launches = read_launches()
    s, x_tran, lap = (np.asarray(v) for v in zip(*plant))
    check(launches["chol_tri_inv"] > 0, f"{scenario}: chol_tri_inv never launched")
    check(launches["gj_inverse"] == 0, f"{scenario}: gj_inverse launched on the path")
    for i, t in enumerate(cs.telemetry):
        check(np.isfinite(t.control).all() and np.isfinite(t.cost) and np.isfinite(t.state).all(),
              f"{scenario}: cycle {i} output not finite")
    inside = ((x_tran <= cs.track.left_boundary_np(s))
              & (x_tran >= cs.track.right_boundary_np(s)))
    check(bool(inside.all()), f"{scenario}: off the track at cycles {np.flatnonzero(~inside)}")
    ms = np.array([t.solve_time * 1e3 for t in cs.telemetry])
    fallbacks = sum(not t.solved for t in cs.telemetry)
    print(f"path {scenario}: {steps} cycles, launches {launches} "
          f"({launches['chol_tri_inv'] / steps:.1f} chol_tri_inv per cycle); "
          f"fallbacks {fallbacks}; on the track every cycle; cycle wall ms: first "
          f"(bootstrap) {ms[0]:.1f}, median after {np.median(ms[1:]):.1f} (min "
          f"{ms[1:].min():.1f}, max {ms[1:].max():.1f}); loop period "
          f"{cs.spec.dt * 1e3:.0f} ms, solver cap 85 ms", flush=True)
    return cs, launches, fallbacks, float(np.median(ms[1:])), s, lap


def drive_controller(device, case: str) -> tuple[dict, float, float]:
    """The controller path of fixture ``case``: the port's closed loop,
    checked against the stored reference runs (on the track every cycle, no
    more fallbacks than the reference's plus its spread, the final progress
    no farther from the nearest reference run than the reference's runs lie
    apart, or 0.1% of the distance covered), a profiled cycle, then the
    teacher-forced runs held to the reference's own spread.  Returns the launches, the median cycle ms and the idle
    share of the profiled cycle."""
    scenario, steps = CTRL_CASES[case]
    with np.load(FIXTURE_DIR / f"{case}.npz") as z:
        fx = {k: z[k] for k in z.files}
    check(fx["x_ctrl"].shape[1] == steps, f"{case}: fixture has another cycle count")
    cs, launches, fallbacks, cycle_ms, s, lap = closed_loop(device, scenario, steps)

    ref_fb = fx["used_fallback"].sum(axis=1)
    allowed = int(ref_fb[0] + ref_fb.max() - ref_fb.min())
    check(fallbacks <= allowed, f"{case}: {fallbacks} fallbacks, reference allows {allowed}")
    # final progress (laps and abscissa): as near some reference run as the
    # reference's runs come to each other (or 0.1% of the distance covered)
    L = float(fx["total_length"])
    ref_prog = fx["lap"][:, -1] * L + fx["s"][:, -1]
    covered = ref_prog[0] - float(fx["x_ctrl"][0, 0, 0])
    width = float(ref_prog.max() - ref_prog.min())
    limit = max(width, 1e-3 * abs(covered))
    prog = float(lap[-1] * L + s[-1])
    gap = float(np.abs(ref_prog - prog).min())
    print(f"{case} closed loop: fallbacks {fallbacks} (reference {ref_fb.tolist()}, "
          f"allowed {allowed}); final progress {prog - ref_prog[0]:+.3e} m from the "
          f"reference run's, {gap:.3e} m from the nearest of its runs (they lie "
          f"{np.round(ref_prog - ref_prog[0], 4).tolist()} m from it, {covered:.2f} m "
          f"covered; limit {limit:.3e} m)", flush=True)
    print(f"  port u_apply per cycle {[np.round(t.control, 4).tolist() for t in cs.telemetry]}",
          flush=True)
    check(gap <= limit, f"{case}: final progress {gap:.3e} m from every reference run")
    idle = profile(cs.step, cycle_ms, f"{case} one cycle")

    port = [teacher_forced(scenario, fx, r, device) for r in range(CTRL_REPLAYS[case])]
    failed = held_ctrl(port, fx, ctrl_limits(fx), f"{case} vs reference")
    check(not failed, f"{case}: outside the reference's own spread on {failed}")
    return launches, cycle_ms, idle


def drive_tracking(device, steps: int = 5) -> dict:
    """The tracking controller (no safe set: the K=0 layout) in closed
    loop: finite and on the track every cycle."""
    return closed_loop(device, "barc_tracking_mpc", steps)[1]


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
    logs = _kernels.build()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    chol = kernel_phase(device)
    gj = gj_kernel_phase(device)
    per_path = {}
    per_path["barc_n20_k48_b256"], mpc, inp, fx, limits = drive_path(
        device, "barc_n20_k48_b256", profiled=True)
    lower_precision_control(mpc, inp, fx, limits)
    per_path["barc_n40_k96_b128"] = drive_path(device, "barc_n40_k96_b128")[0]
    for case in CTRL_CASES:
        per_path[case] = drive_controller(device, case)[0]
    per_path["barc_tracking_mpc"] = drive_tracking(device)
    print(f"phases done in {time.perf_counter() - t0:.1f} s", flush=True)

    def entry(name, source, replaces, numbers):
        counts = {path: c[name] for path, c in per_path.items()}
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(counts.values()), "launches_per_path": counts, **numbers}
    print(json.dumps({"kernels": [
        entry("chol_tri_inv", "racing_lmpc_torch/csrc/chol_tri_inv.cu",
              "racing_lmpc_tpu/ops/pallas_linalg.py:358", chol),
        entry("gj_inverse", "racing_lmpc_torch/csrc/gj_inverse.cu",
              "racing_lmpc_tpu/ops/pallas_linalg.py:124", gj)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
