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
   wide-spectrum case, the wide and grid variants' sizes (n = 241 to 2,048,
   the edges of the triangle and of UT in shared memory among them, the
   large sizes at batch 1 and 4, and batch 33 past the grid variant's
   batches, n = 1,024 timed at batch 32 and 33), a batch with one
   indefinite lane at n = 87, 275 and 1,025 (NaN there only);
   ``gj_inverse`` on a pivoting case, exact |pivot| ties at b = 16, 128 and
   256, the edges of its size classes and variants (b = 1 to 1,547) and
   singular lanes: the same pivots, the same non-finite entries and the
   same bits on the finite ones as the plain version, and its refusal of
   float64.  Every line names the variant the call ran.  Times kernel,
   plain version and a library yardstick with CUDA
   events, synchronizing after every repetition, and the kernel's and the
   yardstick's device time under the profiler; ``chol_tri_inv`` also
   beside the one-SM floor of a batch-1 chain, ``gj_inverse`` beside the
   operation floor of its bit-exact algorithm.  The large sizes, which no
   solve path reaches (n > 1,024, b > 64), are driven as a path of their
   own: each first call there counts its launches (``LARGE_SIZES``).
3. Batched paths: the flagship batched LMPC solve (N=20, K=48, batch 256),
   then the shipped configuration (N=40, K=96, batch 128), each held against
   stored runs of the JAX reference (``tests/data/torch_port/<case>.npz``,
   written by ``tests/torch_port_fixture.py``): the batch itself and 8
   copies with the inputs moved by one f32 rounding; the median of the
   port's readings must stay within the reference's own worst reading.  A
   control solves them again with TF32 products and must fail those gates.
   Solves/s of each batch, and a profile of one flagship solve.
4. Controller paths: the closed-loop co-simulation of the BARC LMPC
   (N=40, K=96, the first 10 of the stored 20 cycles, ``CTRL_DEPTH``) and
   Putnam LMPC (N=60, K=96, SQP re-linearization, 8 cycles) launch
   scenarios through the port's
   ``CoSimulation``; per-cycle wall time and a profiled cycle; the car stays
   on the track, falls back no more and gets as far as the reference's runs
   (``tests/data/torch_port/ctrl_<scenario>.npz``) allow.  Then the port's
   controller is fed each stored run's per-cycle states and previous
   controls (teacher forcing), and the median of its readings against those
   runs must stay within the reference's worst reading between its own runs.  A shorter tracking run
   covers the controller without a safe set.
5. The rest of the control stack: the flagship batch through the ADMM
   backend (``qp_method="admm"``, its six ``chol_tri_inv`` launches a
   solve), held to stored ADMM runs of the reference (the batch, its moved
   copies, and each lane solved alone) with the batched paths' gates and
   the longitudinal control's error against the certified optimum;
   the BARC LMPC with the safe-set error-dynamics regression (8
   cycles), held as the controller paths are and its per-cycle dA/dB/dC to
   the reference's spread; a ``ContinuousCoSimulation`` of the BARC LMPC
   (10 ms plant under the 25 ms controller, an actuation outage, an EKF
   filtering noisy observations), with the port's EKF replayed on the
   stored run's observations; the LQR at batch 256 and three legacy
   full-dynamics solves against the stored ones.
6. The nonlinear-row models: the kinematic bicycle (power and drive/brake
   exclusivity rows) and the double-track (four friction ellipses, power,
   exclusivity, v >= 0), their rows linearized into every QP.  The
   kinematic power scenario (``solve_sqp``, N=14) and the double-track
   braking scenario (``solve_sqp``, N=10), each within its test's gates and
   breaking them without the rows, and solved again on the first 2 of the
   reference's 4 moved inputs (``NL_REPLAYED``); the double-track braking scenario as a
   batch of 256 drawn lanes (N=20) held to the reference's spread over its
   9 stored runs; the kinematic (N=10, the first 12 of the test's 60
   cycles) and double-track (N=25, the first 7 of the test's 150 cycles)
   closed loops of tests/test_closed_loop.py within the test's gates, each
   with 5 teacher-forced replays held to the reference's spread.  The
   double-track LMPC at the shipped learning horizons (``dt_lmpc``): the
   sample vehicle on Putnam-short with the recorded seed laps, iac_car_lmpc
   with the launch's elastic state boxes (N=60, K=96, n = 275, 32 lanes
   through ``solve_batch``) and the upstream sample_mpc (N=50, n = 244, one
   scenario through ``_solve_impl``), its QPs past the kernel's register
   variants, held as the double-track batch is
   (``tests/data/torch_port/dt_lmpc_*.npz``), and one solve of each
   profiled (device busy, idle share, ``chol_tri_inv``'s share of busy).

7. The entry point: ``racing_lmpc_torch.entry.entry()`` (the twin of
   ``__graft_entry__.entry``), its ``fn`` on its example arguments: finite
   controls, equal to the port's own ``solve_batch`` lane to the bit, held
   with the flagship gates to the reference's runs of the same solve
   (``tests/data/torch_port/entry_barc_n20_k48.npz``).
8. Accuracy: the 11 pinned instances (``tests/data/acc_instances``), each
   solved on the card as 9 copies (the instance and 8 moved by one f32
   rounding), held to every gate of
   tests/test_reference_match.py::test_engine_matches_certified with the
   per-instance limits of ``ACCURACY.json``, in the reference QP that the
   port's own f64 oracle (``mpc/reference_qp.py``) builds on the card; that
   build within 1e-9 of the exported QP; the oracle's dense f64 solve
   certified on the card on every instance; the port's f64 OSQP
   (``mpc/osqp_ref.py``) reproducing the reference-class wander.

9. The bench: ``racing_lmpc_torch.bench.run`` (what ``python -m
   racing_lmpc_torch.bench`` measures) at its smallest settings: every
   measurement once, one repetition, chains of 1, the sweep at 512 only,
   and the controller chains of all five launch scenarios; every number
   finite, the b256 and N=40 batches' solved lanes within the batched
   gates' allowance of the stored reference runs, ``chol_tri_inv``
   launched every cycle of every scenario, ``mfu_vs_f32_peak`` in (0, 1].
   Each scenario's controller chain also runs cycle by cycle from the
   reference's own start of each cycle
   (``bench_rt_<scenario>.npz``): no fallback where the reference's runs
   solved, the objective and the controls within the port's floors or the
   reference's spread over its moved runs.

10. The tools (``racing_lmpc_torch/tools``): ``ground_accuracy``'s engine
   step on the 11 pinned instances at 3 zoom rounds, each instance alone
   and with its 8 moved copies (the accuracy gates' reading of
   ``tools.accuracy``, which the accuracy phase shares); one ``pareto``
   point from those records at one repetition and a 2-solve chain;
   ``multihost_report``'s NCCL rank at world size 1; 10 cycles of
   ``record_putnam_ss`` into a temporary directory, its recorder rows held
   to the reference's spread over its stored runs
   (``tests/data/torch_port/tools_putnam_ss.npz``).

The teacher-forced replays of every controller path, the accuracy phase,
the tools phase (in two jobs), the phases that time nothing the records
keep (``POOL_PHASES``: the two nonlinear-row SQP scenarios, the LU branch,
the tracking closed loop and ``dryrun_multichip(1)``) and the bench's
chains from the reference's starts run after all the timed phases, side
by side in processes of their own on the same card (``settle_replays``,
which prints each job's seconds), and are held to their gates there or
then.

Every path is driven with every launch counter set to 0 just before and
read just after.  Each phase's seconds are printed on a line of its own
(``phase <name>: ...``).  Prints one ``{"kernels": [...]}`` line, and as its last
line ``{"ok": true, "device": {...}}``.  Any failed check raises, and the
script exits non-zero without that last line.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import re
import sys
import time
from pathlib import Path

import numpy as np

# the pinned accuracy instances (tests/data/acc_instances) with their gates
# (ACCURACY.json), each solved as ACC_REPLICAS copies: the instance and
# copies moved by one f32 rounding
from racing_lmpc_torch.tools.accuracy import (
    ACC_REPLICAS, acc_instances, acc_limits, acc_reading)

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
CTRL_CASES["ctrl_barc_lmpc_regression"] = ("barc_lmpc", 8)
# the cycles the card drives where that is fewer than the fixture's (the
# first ones; cut to keep the script inside its time): the closed loop,
# its gates and its teacher-forced replays read that prefix of the stored
# runs
CTRL_DEPTH = {"ctrl_barc_lmpc": 10}
# stored reference runs the port is teacher-forced on: the run itself and
# its moved re-runs
CTRL_REPLAYS = {"ctrl_barc_lmpc": 5, "ctrl_putnam_short_lmpc": 5,
                "ctrl_barc_lmpc_regression": 2}
# the error-dynamics regression of tests/test_lmpc.py:97-100, as
# tests/torch_port_fixture.py sets it on the reference's controller:
# dist_max, and groups (state inputs, control inputs, output state)
REGRESSION = (3.0, (((3, 4, 5), (0, 1), 4), ((3, 4, 5), (0, 1), 5)))
CTRL_REGRESSION = {"ctrl_barc_lmpc_regression": REGRESSION}
# the flagship batch through the ADMM backend: case -> (batched case whose
# inputs and certified optima it shares, RacingMPCConfig overrides)
ADMM_CASES = {"barc_n20_k48_b256_admm": ("barc_n20_k48_b256", {"qp_method": "admm"})}
ADMM_LAUNCHES = 6        # rho_updates + 1 = 5 KKT factorizations + the polish
# continuous co-simulation fixture -> (launch scenario, plant ticks,
# actuation outage [t0, t1) in s), as tests/torch_port_fixture.py wrote it
CONT_CASES = {"ctrl_barc_lmpc_continuous_ekf": ("barc_lmpc", 50, (0.2, 0.3))}
# the EKF between plant and controller: full-state observations with this
# noise from numpy seed EKF_SEED (tests/test_estimator_in_loop.py:26-63)
EKF_NOISE_STD = (0.01, 0.01, 0.01, 0.03, 0.01, 0.05)
EKF_SEED = 11
# the EKF replayed on the stored run's inputs: the state within 1e-5 and
# the covariance within 1e-4 of the largest stored entry (the same f32
# operations in another order; 2.8e-9 and 2.9e-6 on the CPU)
EKF_X_TOL, EKF_P_TOL = 1e-5, 1e-4
# the control-stack case: the LQR at this batch, and the legacy controller
STACK_BATCH = 256
LQR_TOL = 1e-4           # relative to max(1, |reference|)

# the twin of __graft_entry__.entry(): its stored reference runs, as
# tests/torch_port_fixture.py wrote them (compute_entry)
ENTRY_CASE = "entry_barc_n20_k48"
# the bench's smallest settings (racing_lmpc_torch/bench.py::run)
BENCH_SMOKE = {"reps": 1, "chain": 1, "sweep": (512,)}
# the launch scenarios whose controller chain (bench.rt_chain) is replayed
# cycle by cycle from the reference's stored runs, as
# tests/torch_port_fixture.py wrote them (bench_rt_<scenario>.npz)
BENCH_RT_SCENARIOS = ("barc_lmpc", "barc_tracking_mpc", "putnam_short_lmpc",
                      "putnam_short_tracking_mpc", "putnam_config_a_tracking_mpc")
# the floors of those replays' readings (rt_reading): a fallback where the
# reference solved, the objective (relative), the longitudinal and the
# steering control (over scale_u), the port's floors
RT_FLOORS = (0.0, 1e-3, 1e-3, 3e-3)

# H100 SXM published peaks (NVIDIA data sheet) for the roofline bound; the
# f32 peak outside the tensor cores is racing_lmpc_torch.bench's
# F32_PEAK_FLOP_PER_S
HBM_BYTES_PER_S = 3.35e12
# f32 instructions a second outside the tensor cores, one operation each
# (132 SMs x 128 lanes x 1.98 GHz): the rate of separately rounded
# multiplies and subtracts, which cannot pair into FMAs
F32_INSTR_PER_S = 132 * 128 * 1.98e9
SM_COUNT = 132                  # for the one-SM floor of a batch-1 chain


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def rel_diff(got, want) -> float:
    """max |got - want| relative to max(1, max |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


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


def device_rows(prof) -> list[tuple[str, int, float]]:
    """The device's work in a finished ``torch.profiler.profile`` of CUDA
    activity: (name, count, ms) for each kernel, copy and fill name, read
    from the profiler's raw events.  The same rows as ``key_averages()``'s
    with ``device_type`` CUDA (``profile`` holds the two equal once a run),
    without building an event object per launch, which took up to ~70 s on
    a path of 2.5e5 launches."""
    import torch
    rows: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_hidden_event", lambda: False)()):
            continue
        row = rows.setdefault(e.name(), [0, 0])
        row[0] += 1
        row[1] += e.duration_ns()
    return [(name, count, ns / 1e6) for name, (count, ns) in rows.items()]


# profiler sessions device_ms takes before it gives up on a reading
PROFILE_TRIES = 6


def device_ms(fn, reps: int) -> float | None:
    """Device time of one call of ``fn`` in ms: the CUDA kernels' time under
    the profiler, summed over ``reps`` calls and divided by ``reps`` (the
    host's launch overhead, which ``cuda_time_ms`` includes, left out).

    The profiler (torch 2.11 with CUDA 12.8 on an H100) drops the kernel
    records of whole short sessions, often every other one, and now and
    then of some calls of a session (an earlier reading of 11-78 ms between
    a call and its device time at (1,2048,2048) and (4,1024,1024) was 1 or 2
    of 5 calls' records missing, divided by 5).  So a reading counts only
    when every kernel came back a whole number of times a call, and is
    taken again otherwise, up to ``PROFILE_TRIES`` sessions; if none comes
    back whole the reading is None (not measured)."""
    import torch
    from torch.profiler import ProfilerActivity
    for _ in range(PROFILE_TRIES):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = device_rows(prof)
        if rows and all(count % reps == 0 for _, count, _ in rows):
            return sum(r[2] for r in rows) / reps
    return None


def fmt_ms(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


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


def spd_on_card(rng, G: int, n: int, device):
    """``big_spd_batch`` with the product A'A taken on the card (the host
    takes seconds a matrix past n = 1,000 and minutes for a batch)."""
    import torch
    A = torch.as_tensor(rng.normal(size=(G, n, n)).astype(np.float32), device=device)
    return A.mT @ A + n * torch.eye(n, device=device)


def big_spd_batch(rng, G: int, n: int) -> np.ndarray:
    """``spd_batch`` without the cond boost for large n: A'A + n I with
    the product taken by BLAS (``spd_batch``'s einsum takes seconds past
    n = 1,000)."""
    A = rng.normal(size=(G, n, n)).astype(np.float32)
    return (np.matmul(A.transpose(0, 2, 1), A) + n * np.eye(n, dtype=np.float32)).astype(np.float32)


# A path of its own: each kernel's entry point at the large sizes no solve
# path reaches (chol_tri_inv past n = 1,024, gj_inverse past b = 64), the
# launch counts set to 0 just before each such first call and read just
# after; the kernel phases add them up here (the comparisons' own launches
# are not counted)
LARGE_SIZES = {"chol_tri_inv": 0, "gj_inverse": 0}


def on_path(fn):
    """``fn()``, one entry-point call at a large size, its launches added to
    ``LARGE_SIZES``."""
    import torch
    zero_launches()
    out = fn()
    torch.cuda.synchronize()
    for k, v in read_launches().items():
        LARGE_SIZES[k] += v
    return out


# repetitions of the plain version's timing (its times are records, the
# kernels' yardstick is the library call)
PLAIN_REPS = 3


def kernel_phase(device) -> dict:
    """chol_tri_inv on the card against its plain version (within 1e-4) and
    against its step mirror ``chol_tri_inv_sweep`` (bit for bit: both round
    every operation alike); returns the numbers of the main path's
    (256, 87, 87) case."""
    import torch
    from racing_lmpc_torch.bench import F32_PEAK_FLOP_PER_S
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
    # the nonlinear-row paths' sizes, each inside one or two panels
    sizes = nl_qp_sizes()
    cases.append(("H, double-track batch N=20", spd_batch(rng, 256, sizes["nl_double_track_b256"]),
                  True))
    cases.append(("H, double-track controller N=25",
                  spd_batch(rng, 1, sizes["ctrl_double_track"]), True))
    # the panel edges: whole panels, one pivot either side of the first
    # panel's end, one pivot into a new panel, the last variant (its last
    # panel holds 2 of 4 row tiles) and the limit; and every size of the
    # nonlinear-row paths
    for n in sorted({31, 32, 33, 64, 96, 97, 225, 240, *sizes.values()}):
        cases.append((f"panel edge n={n}", spd_batch(rng, 4, n), False))
    # the entry point's solve, and the accuracy phase's batches of copies
    cases.append(("H, entry() N=20 K=48", spd_batch(rng, 1, 87), True))
    for scenario, n in acc_qp_sizes().items():
        cases.append((f"H, accuracy {scenario}", spd_batch(rng, ACC_REPLICAS, n), True))
    # the bench's widest batch, and the IAC tracking controller (N=80) that
    # its controller chains drive
    cases.append(("H, bench sweep N=20 K=48", spd_batch(rng, 1024, 87), True))
    cases.append(("H, IAC tracking controller N=80",
                  spd_batch(rng, 1, tracking_qp_size(device)), True))
    # the wide variant (n > 240): the double-track LMPC's batch (n = 275)
    # and single solve (n = 275, and the sample config's 244), one pivot
    # past the register variants, the shared-memory triangle's last size
    # (302); past it the grid variant (at most 32 matrices): the first size
    # (303), the triangle's earlier edge (336, 337), n = 1024 and a timed
    # size
    cases.append(("H, double-track LMPC batch N=60 K=96", spd_batch(rng, 32, 275), True))
    cases.append(("H, double-track LMPC single N=60 K=96", spd_batch(rng, 1, 275), True))
    cases.append(("H, double-track LMPC single N=50 K=96", spd_batch(rng, 1, 244), True))
    for n in (241, 244, 256, 274, 275, 302, 303, 320, 336, 337, 400, 512):
        cases.append((f"n={n}", spd_batch(rng, 4, n), False))
    cases.append(("n=1024", spd_batch(rng, 1, 1024), False))
    cases.append(("n=512 at batch 1", spd_batch(rng, 1, 512), True))
    # the large sizes (their own path): one pivot past 1024, the last size
    # whose UT the one-block variant keeps in shared memory (1736) and the
    # first it keeps in device memory (1737), at batch 1 and 4 (the grid
    # variant), and timed at 2048, batch 1 and 32
    for n in (1025, 1736, 1737):
        cases.append((f"n={n}", big_spd_batch(rng, 1, n), False))
    cases.append(("n=2048 at batch 1", big_spd_batch(rng, 1, 2048), True))
    # timed, held to the sweep mirror only
    cases.append(("n=2048 at batch 32", spd_on_card(rng, 32, 2048, device), "no plain"))
    # held to the sweep mirror only (the plain version takes seconds a
    # case here): batch 4 at the large sizes, and batch 33, one past the
    # grid variant's batches, where one block a matrix runs again; n = 1024
    # timed on both sides of that rule (batch 32 and 33)
    for n in (1025, 1736, 1737, 2048):
        cases.append((f"n={n} at batch 4", spd_on_card(rng, 4, n, device), None))
    cases.append(("n=1024 at batch 32", spd_on_card(rng, 32, 1024, device), "no plain"))
    for n in (303, 1024, 1737):
        cases.append((f"n={n} at batch 33, one block a matrix", spd_on_card(rng, 33, n, device),
                      "no plain" if n == 1024 else None))
    main = None
    for name, Hn, timed in cases:
        H = torch.as_tensor(Hn, device=device)
        G, n = H.shape[0], H.shape[-1]
        variant = linalg.kernel_variant("chol_tri_inv", G, n)
        if n > 1024:
            K = on_path(lambda: linalg.chol_tri_inv(H))
        else:
            K = linalg.chol_tri_inv(H)
        # past n = 1024 a plain call takes seconds: its one timed call is
        # the one compared
        plain_ms = None
        if timed is None or timed == "no plain":
            P = None
        elif timed and n > 1024:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            P = linalg.chol_tri_inv_plain(H)
            end.record()
            torch.cuda.synchronize()
            plain_ms = start.elapsed_time(end)
        else:
            P = linalg.chol_tri_inv_plain(H)
        S = linalg.chol_tri_inv_sweep(H)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(K).all()), f"{name}: kernel gave non-finite values")
        check(same_bits(K, S), f"{name} {tuple(H.shape)}: kernel not bit-equal to the "
              f"sweep mirror (max diff {float((K - S).abs().max()):.3e})")
        check(bool((torch.triu(K, 1) == 0).all()), f"{name}: upper part not zero")
        line = f"kernel {name} {tuple(H.shape)} [{variant}]: bit-equal to the sweep mirror"
        if P is not None:
            err = rel_err(K, P)
            check(err < 1e-4, f"{name} {tuple(H.shape)}: kernel vs plain {err:.2e} > 1e-4")
            line += f", max rel err vs plain {err:.3e}"
        if timed:
            small = n <= 1024
            ms = cuda_time_ms(lambda: linalg.chol_tri_inv(H), reps=20 if small else 5)
            dev = device_ms(lambda: linalg.chol_tri_inv(H), reps=20 if small else 5)
            if small and timed != "no plain":
                plain_ms = cuda_time_ms(lambda: linalg.chol_tri_inv_plain(H), reps=PLAIN_REPS)
            lib_ms = cuda_time_ms(lambda: library(H), reps=20)
            lib_dev = device_ms(lambda: library(H), reps=20)
            # the lower triangle of each symmetric input read once (all the
            # function needs), each dense output written once
            bytes_ms = G * (n * (n + 1) // 2 + n * n) * 4 / HBM_BYTES_PER_S * 1e3
            flops_ms = G * (2.0 / 3.0) * n ** 3 / F32_PEAK_FLOP_PER_S * 1e3
            # one matrix's pivots are a dependent chain on one SM
            floor_ms = (2.0 / 3.0) * n ** 3 / (F32_PEAK_FLOP_PER_S / SM_COUNT) * 1e3
            line += (f"; kernel {ms:.4f} ms a call ({fmt_ms(dev)} on the device), plain "
                     f"{'not timed' if plain_ms is None else f'{plain_ms:.4f} ms'}, torch.linalg "
                     f"yardstick {lib_ms:.4f} ms a call "
                     f"({fmt_ms(lib_dev)} on the device), bound "
                     f"{max(bytes_ms, flops_ms):.5f} ms, one-SM floor {floor_ms:.5f} ms; "
                     f"kernel {'<=' if ms <= lib_ms else '>'} yardstick")
            if main is None:
                main = {"max_abs_err": float((K - P).abs().max()), "ms": ms,
                        "device_ms": dev, "plain_ms": plain_ms, "library_ms": lib_ms,
                        "bound_ms": max(bytes_ms, flops_ms),
                        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}
        print(line, flush=True)

    # one indefinite lane: NaN there (from the bad pivot's row on), every
    # other lane untouched; in a register variant, in the wide one and at a
    # large size
    for G, n, lane, pivot in ((16, 87, 5, 40), (4, 275, 2, 100), (2, 1025, 1, 700)):
        Hn = spd_batch(rng, G, n) if n <= 1024 else big_spd_batch(rng, G, n)
        Hn[lane, pivot, pivot] = -1.0e4
        H = torch.as_tensor(Hn, device=device)
        K = on_path(lambda: linalg.chol_tri_inv(H)) if n > 1024 else linalg.chol_tri_inv(H)
        P = linalg.chol_tri_inv_plain(H)
        S = linalg.chol_tri_inv_sweep(H)
        torch.cuda.synchronize()
        what = f"indefinite lane {lane} of ({G}, {n}, {n})"
        bad = ~torch.isfinite(K).flatten(1).all(dim=1)
        check(bad.tolist() == [i == lane for i in range(G)],
              f"{what}: non-finite lanes {bad.nonzero().flatten().tolist()}")
        check(bool(torch.isfinite(K[lane, :pivot]).all()), f"{what}: NaN above the bad pivot")
        check(same_bits(K, S), f"{what}: kernel not bit-equal to the sweep mirror")
        check(bool((torch.triu(K, 1) == 0).all()), f"{what}: upper part not zero")
        keep = torch.arange(G, device=device) != lane
        err = rel_err(K[keep], P[keep])
        check(err < 1e-4, f"{what}: other lanes vs plain {err:.2e}")
        print(f"kernel {what}: NaN in that lane only, rows >= {pivot}; others vs plain "
              f"{err:.3e}; bit-equal to the sweep mirror", flush=True)
    return main


def tracking_qp_size(device) -> int:
    """The condensed QP size n of the two Putnam tracking scenarios (the
    IAC car's tracking MPC, N=80), read from the port's controller."""
    from racing_lmpc_torch.launch.runner import _SCENARIOS, CoSimulation
    return CoSimulation(_SCENARIOS["putnam_short_tracking_mpc"],
                        device=device).controller.mpc.layout.n


def acc_qp_sizes() -> dict:
    """The condensed QP size n of each pinned instance's scenario (the
    length of its stored warm start ``zw``)."""
    return {rec["scenario"]: len(d["zw"]) for rec, d, _ in acc_instances()}


def hadamard_tie_batch(rng, size: int = 16) -> np.ndarray:
    """(16, size, size) Sylvester-Hadamard matrices (orders size / 4,
    size / 2, size, size, padded with an identity; size a power of two)
    with rows permuted, row signs flipped and columns scaled by powers of
    two: every |entry| of a column ties, so each step's pivot is a tie,
    and Gauss-Jordan on them is exact in f32."""
    out = []
    for n in (size // 4, size // 2, size, size):
        H = np.ones((1, 1))
        while H.shape[0] < n:
            H = np.block([[H, H], [H, -H]])
        for _ in range(4):
            M = H[rng.permutation(n)] * rng.choice([-1.0, 1.0], size=(n, 1))
            M = M * 2.0 ** rng.integers(-3, 4, size=(1, n))
            full = np.eye(size)
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
    from racing_lmpc_torch.bench import F32_PEAK_FLOP_PER_S
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
    # the kernel's size classes (b <= 16, 32, 64) and their edges; past b =
    # 64 (the large sizes' path) the wide variant, the matrix in shared
    # memory, to b = 168, and the grid variant above: its panel in shared
    # memory to b = 1,546, in the workspace from 1,547
    cases += [(f"class edge b={b}", invertible(37, b), False)
              for b in (1, 2, 15, 16, 17, 31, 32, 33, 48, 63, 64, 65, 96, 168, 169, 256)]
    cases += [(f"one singular lane b={b}", with_singular_lane(8, b), False)
              for b in (32, 64, 65, 168, 169, 256, 512, 1024, 1546, 1547)]
    cases += [("b=512", invertible(2, 512), False)]
    cases += [(f"exact ties b={b}", hadamard_tie_batch(rng, b), False) for b in (128, 256)]
    cases += [("b=16", invertible(65536, 16), True), ("b=32", invertible(4096, 32), True),
              ("b=64", invertible(1024, 64), True), ("b=128", invertible(256, 128), True),
              ("b=1024", invertible(4, 1024), True)]
    shapes = []
    for name, An, timed in cases:
        A = torch.as_tensor(An, device=device)
        variant = linalg.kernel_variant("gj_inverse", A.shape[0], A.shape[-1])
        past = A.shape[-1] > 64     # on_path counts from 0
        before = 0 if past else linalg.gj_inverse.launches

        def call():
            return linalg.gj_inverse(A, return_pivots=True)
        K, pk = on_path(call) if past else call()
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
        line = (f"kernel gj_inverse {name} {tuple(A.shape)} [{variant}]: same pivots, same "
                f"non-finite entries, bit-equal on the finite ones")
        if name.startswith("exact ties"):
            eye = torch.eye(A.shape[-1], device=device).expand_as(A)
            check(bool(torch.equal(K @ A, eye)), f"gj {name}: inverse not exact")
        if name.startswith("one singular lane"):
            bad = ~fin.flatten(1).all(dim=1)
            check(bad.tolist() == [i == 3 for i in range(8)],
                  f"gj {name}: non-finite lanes {bad.nonzero().flatten().tolist()}")
        if timed:
            G, b = A.shape[0], A.shape[-1]
            reps = 20
            ms = cuda_time_ms(lambda: linalg.gj_inverse(A), reps=reps)
            dev = device_ms(lambda: linalg.gj_inverse(A), reps=reps)
            plain_ms = cuda_time_ms(lambda: linalg.gj_inverse_plain(A), reps=PLAIN_REPS)
            lib_ms = cuda_time_ms(lambda: torch.linalg.inv(A), reps=20)
            lib_dev = device_ms(lambda: torch.linalg.inv(A), reps=20)
            # each input read once, each inverse written once; 2 b^3 flops a
            # matrix (LAPACK's getrf + getri count of an inverse)
            bytes_ms = 8.0 * G * b * b / HBM_BYTES_PER_S * 1e3
            flops_ms = 2.0 * G * b ** 3 / F32_PEAK_FLOP_PER_S * 1e3
            # the bit-exact algorithm's own floor (kernel note): 4 b^3
            # separately rounded multiplies and subtracts and 2 b^2 IEEE
            # divisions (8 instructions each) a matrix at the f32 issue rate
            op_floor_ms = G * (4.0 * b ** 3 + 8 * 2.0 * b * b) / F32_INSTR_PER_S * 1e3
            line += (f"; kernel {ms:.4f} ms a call ({fmt_ms(dev)} on the device), plain "
                     f"{plain_ms:.4f} ms, torch.linalg.inv yardstick {lib_ms:.4f} ms a call "
                     f"({fmt_ms(lib_dev)} on the device), bound "
                     f"{max(bytes_ms, flops_ms):.5f} ms, operation floor {op_floor_ms:.5f} ms; "
                     f"kernel {'<=' if ms <= lib_ms else '>'} yardstick")
            shapes.append({"shape": list(A.shape), "max_abs_err": err, "ms": ms,
                           "device_ms": dev, "plain_ms": plain_ms, "library_ms": lib_ms,
                           "library_device_ms": lib_dev, "bound_ms": max(bytes_ms, flops_ms),
                           "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"})
        print(line, flush=True)
    bad_input = torch.zeros(2, 8, 8, device=device, dtype=torch.float64)
    before = linalg.gj_inverse.launches
    try:
        linalg.gj_inverse(bad_input)
    except TypeError as e:
        print(f"kernel gj_inverse refuses {tuple(bad_input.shape)} {bad_input.dtype}: {e}",
              flush=True)
    else:
        raise AssertionError(f"gj_inverse took {tuple(bad_input.shape)} {bad_input.dtype}")
    check(linalg.gj_inverse.launches == before, "gj_inverse launched on a refused input")
    main = {k: v for k, v in shapes[0].items() if k != "shape"}
    return {**main, "shapes": shapes}


def profile(fn, wall_ms: float, label: str, against_key_averages: bool = False) -> float:
    """Where one call's time goes: device time summed over the CUDA kernels
    of one profiled call of ``fn``, against the un-profiled wall time of a
    call (their difference is the device's idle share, returned).  With
    ``against_key_averages`` the rows (``device_rows``) must equal the
    profiler's own ``key_averages()`` rows of device type CUDA."""
    import torch
    from torch.profiler import ProfilerActivity
    from racing_lmpc_torch.ops import linalg
    t = time.perf_counter()
    launched = linalg.chol_tri_inv.launches
    # the device's activity only: the readings below are kernel events, and
    # recording every CPU op too made the profiler's own work take most of
    # the script's time on the paths of ~10^5 launches
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    launched = linalg.chol_tri_inv.launches - launched
    rows = device_rows(prof)

    def reading(rs):
        # what is read below: launches, busy ms, chol_tri_inv's launches and ms
        chol = [r for r in rs if "chol_tri_inv" in r[0]]
        return (sum(r[1] for r in rs), sum(r[2] for r in rs),
                sum(r[1] for r in chol), sum(r[2] for r in chol))
    launches, busy, chol_launches, chol = reading(rows)
    if against_key_averages:
        ref = reading([(e.key, e.count, e.self_device_time_total / 1e3)
                       for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA])
        check((launches, chol_launches) == (ref[0], ref[2])
              and abs(busy - ref[1]) <= 1e-6 * ref[1] and abs(chol - ref[3]) <= 1e-6 * ref[1],
              f"profile {label}: the raw events' reading {(launches, busy, chol_launches, chol)} "
              f"differs from key_averages()'s {ref}")
    idle = 1 - busy / wall_ms
    # the profiler can drop records (device_ms): the kernel's own launch
    # count says whether this reading is whole
    whole = (f"records whole ({chol_launches} of {launched} chol_tri_inv launches)"
             if chol_launches == launched else
             f"RECORDS DROPPED: {chol_launches} of {launched} chol_tri_inv launches recorded")
    print(f"profile {label}: {launches} kernel launches, device busy "
          f"{busy:.1f} ms of {wall_ms:.1f} ms wall (idle share {idle:.3f}; chol_tri_inv "
          f"{chol:.1f} ms, {chol / busy if busy else 0.0:.3f} of busy; {whole}; the profiled "
          f"call and its reading {time.perf_counter() - t:.1f} s)", flush=True)
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
    the max of the longitudinal control's |U - U*| / scale_u (gated on the
    ADMM path, ``ADMM_GATE_FLOORS``), and percentiles of the applied (stages
    0-1) and tail steering's |U - U*| / scale_u (steering rides a cost-flat
    valley, so single lanes of two f32 runs can land far apart while both
    are near-optimal)."""
    ok = a["solved"] & np.isfinite(fx["obj_star"])
    star = fx["obj_star"][ok]
    gap = np.abs(a["obj"][ok] - star) / np.maximum(np.abs(star), 1.0)
    dU = np.abs(a["U"] - fx["U_star"])[ok] / fx["scale_u"]
    d = dU[..., 1]
    applied, tail = d[:, :2].max(-1), d[:, 2:].max(-1)
    return {"objective gap max": float(gap.max()),
            "lon error max": float(dU[..., 0].max()),
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
    re-runs on the inputs moved by about one f32 rounding, then (an ADMM
    case) the batch solved lane by lane, through ``solve`` and as batches
    of one."""
    runs = [(fx["U_optm"], fx["obj"], fx["solved"])]
    runs += list(zip(fx["U_pert"], fx["obj_pert"], fx["solved_pert"]))
    if "U_alone" in fx:
        runs += list(zip(fx["U_alone"], fx["obj_alone"], fx["solved_alone"]))
    return [{"U": U.astype(np.float64), "obj": o.astype(np.float64), "solved": s}
            for U, o, s in runs]


def gate_limits(fx, floors: dict = GATE_FLOORS) -> dict:
    """Each gate's limit: the reference's own worst reading over its stored
    runs (the largest spread between any two of them, the largest error of
    any one from the certified optimum), or the gate's floor where that is
    looser."""
    runs = reference_runs(fx)
    readings = [spread(a, b, fx["scale_u"]) for i, a in enumerate(runs)
                for b in runs[i + 1:]]
    readings += [error(a, fx) for a in runs]
    return {k: max(floor, *(r[k] for r in readings if k in r))
            for k, floor in floors.items()}


# the ADMM path's gates: the batched gates, and the longitudinal control's
# error against the certified optimum, which 400 ADMM iterations do not
# reach (the reference's own runs leave it a whole box away on some lanes)
ADMM_GATE_FLOORS = {**GATE_FLOORS, "lon error max": 1e-3}


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


def held(got: list[dict], limits: dict) -> list[str]:
    """The median of each gate's readings over the port's runs held to its
    limit; prints them and returns the gates that fail."""
    failed = []
    for k, limit in limits.items():
        v = [g[k] for g in got]
        med = float(np.median(v))
        failed += [] if med <= limit else [k]
        print(f"  {k}: median {med:.3e} (runs {min(v):.3e}..{max(v):.3e}), limit "
              f"{limit:.3e} {'ok' if med <= limit else 'FAILS'}", flush=True)
    return failed


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
    return held(got, limits)


def load_batch_fixture(case: str) -> dict:
    """A batched fixture; an ADMM case's outputs joined with the inputs and
    certified optima of the batch it shares."""
    with np.load(FIXTURE_DIR / f"{case}.npz") as z:
        fx = {k: z[k] for k in z.files}
    if case in ADMM_CASES:
        with np.load(FIXTURE_DIR / f"{ADMM_CASES[case][0]}.npz") as z:
            fx.update({k: z[k] for k in z.files
                       if k.startswith("inp_") or k in ("U_star", "obj_star")})
    return fx


def drive_path(device, case: str, profiled: bool = False) -> tuple:
    """One batched solve of fixture ``case`` through the port's entry points
    with every launch count set to 0 just before and read just after; its
    outputs, with the port's runs on the fixture's moved inputs, held
    against the stored reference runs; then its solves/s (and, if asked, a
    profiled solve).  Returns the kernels' launch counts, the MPC, its
    input, the fixture and its gate limits."""
    import torch
    from racing_lmpc_torch.benchmarks import build_barc_lmpc, make_scenario_batch
    from racing_lmpc_torch.mpc.racing_mpc import REQUIRED_FIELDS

    fx = load_batch_fixture(case)
    base, overrides = ADMM_CASES.get(case, (case, {}))
    n_horizon, num_ss, per_lap, batch = CASES[base]
    _, track, _, mpc, manager = build_barc_lmpc(n_horizon, num_ss, per_lap, device=device,
                                                **overrides)
    inp = make_scenario_batch(mpc, track, manager, batch=batch, device=device)
    for name in REQUIRED_FIELDS:
        got, want = getattr(inp, name).cpu().numpy(), fx[f"inp_{name}"]
        check(got.shape == want.shape and np.allclose(got, want, rtol=1e-6, atol=1e-6),
              f"{case}: scenario input {name} differs from the fixture")

    zero_launches()
    out, _ = mpc.solve_batch(inp)
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"path {case}: launches {launches}", flush=True)
    if case in ADMM_CASES:
        check(launches["chol_tri_inv"] == ADMM_LAUNCHES,
              f"{case}: chol_tri_inv launches {launches['chol_tri_inv']}, want {ADMM_LAUNCHES}")
    else:
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

    limits = gate_limits(fx, ADMM_GATE_FLOORS if case in ADMM_CASES else GATE_FLOORS)
    failed = held_to_reference(runs_like_reference(mpc, inp, fx, first=out), fx,
                               limits, f"{case} vs reference")
    check(not failed, f"{case}: outside the reference's own spread on {failed}")

    # throughput, synchronized after every repetition
    ms = cuda_time_ms(lambda: mpc.solve_batch(inp), reps=5, warmup=1)
    print(f"path {case}: {ms:.1f} ms per batch, {batch / (ms / 1e3):.1f} solves/s",
          flush=True)
    if profiled:
        # the ADMM batch's profile (~1.2e4 launches) also holds the raw
        # events' reading to key_averages()'s
        profile(lambda: mpc.solve_batch(inp), ms, f"{case} solve",
                against_key_averages=case in ADMM_CASES)
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
            "lon max": float(du[:, :-1].max(initial=0.0)),
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


def replay(ctrl, fx, r: int) -> dict:
    """Controller ``ctrl`` fed stored run ``r``'s per-cycle states and
    previous controls: per cycle its applied control, objective and whether
    it fell back."""
    import torch
    rows = []
    for x, u in zip(fx["x_ctrl"][r], fx["u_ic"][r]):
        info = ctrl.step(x, u)
        rows.append(torch.cat([info.u_apply, info.output.obj[None],
                               info.used_fallback[None].float()]).cpu().numpy())
    rows = np.stack(rows).astype(np.float64)
    return {"u_apply": rows[:, :-2], "obj": rows[:, -2], "used_fallback": rows[:, -1] > 0.5}


def teacher_forced(scenario: str, fx, r: int, device, regression=None,
                   continuous: bool = False, **cosim_kw) -> dict:
    """A fresh port controller of ``scenario`` fed the stored run ``r``'s
    per-cycle state and previous control (what the reference's controller
    was handed), so that the plant cannot amplify differences.  With
    ``regression`` (dist_max, groups) the controller runs the error-dynamics
    regression and each cycle's dA/dB/dC come back too; ``continuous``
    builds it as ``ContinuousCoSimulation`` does (continuous step mode)."""
    import torch
    from racing_lmpc_torch.control import RegressionSpec
    from racing_lmpc_torch.launch.runner import (
        _SCENARIOS, ContinuousCoSimulation, CoSimulation)
    cls = ContinuousCoSimulation if continuous else CoSimulation
    sim = cls(_SCENARIOS[scenario], device=device, **cosim_kw)
    ctrl = (sim.cs if continuous else sim).controller
    regs = []
    if regression is not None:
        ctrl.regression = RegressionSpec(*regression)
        query = ctrl._query_regression

        def recording_query(x_np, u_np):
            out = query(x_np, u_np)
            regs.append(torch.cat([a.flatten() for a in out]))
            return out
        ctrl._query_regression = recording_query
    out = replay(ctrl, fx, r)
    if regs:
        flat = torch.stack(regs).cpu().numpy()
        nx, nu = fx["dB"].shape[-2:]
        out.update(dA=flat[:, :nx * nx].reshape(-1, nx, nx),
                   dB=flat[:, nx * nx:nx * (nx + nu)].reshape(-1, nx, nu),
                   dC=flat[:, nx * (nx + nu):])
    return out


# per-cycle arrays of the controller fixtures (run axis first, cycle axis
# second), cut to a prefix where the card drives fewer cycles
CYCLE_KEYS = ("x_ctrl", "u_ic", "u_apply", "obj", "used_fallback", "s", "x_tran",
              "lap", "dA", "dB", "dC", "x_plant")
# processes the teacher-forced replays run in, side by side (8 host cores)
REPLAY_WORKERS = 7


def ctrl_fixture(case: str) -> dict:
    """A controller fixture cut to the cycles the card drives
    (``CTRL_CASES``, ``CTRL_DEPTH``, ``MODEL_CTRL_DEPTH``): a prefix of the
    stored runs.  A
    closed loop of ``MODEL_CTRL_CASES`` has one controller step more than
    plant steps (its first step bootstraps before the plant moves)."""
    fx = load_fixture(case)
    rows = (MODEL_CTRL_DEPTH[case] + 1 if case in MODEL_CTRL_CASES
            else CTRL_DEPTH.get(case, CTRL_CASES[case][1]))
    out = dict(fx)
    for k in CYCLE_KEYS:
        if k in fx:
            out[k] = fx[k][:, :rows - 1 if k == "x_plant" else rows]
    return out


def replay_job(case: str, r: int) -> tuple[dict, float]:
    """Teacher-forced replay ``r`` of controller fixture ``case`` on the card,
    in a process of its own (``settle_replays``); or, for ``case``
    "accuracy", that phase, for "tools", part ``r`` of that phase, and for
    "phase", phase ``POOL_PHASES[r]``.  Returns the result and the job's
    seconds."""
    t = time.perf_counter()
    out = _replay_job(case, r)
    return out, time.perf_counter() - t


# phases that time nothing the records keep, driven in the replay pool beside
# the replays (their checks and launch counts as in the main sequence)
POOL_PHASES = ("nl_kinematic", "nl_double_track_sqp", "LU branch", "barc_tracking_mpc",
               "dryrun_multichip")


def _replay_job(case: str, r: int) -> dict:
    import torch
    import racing_lmpc_torch  # noqa: F401  (sets the numerics policy)
    device = torch.device("cuda", 0)
    if case == "accuracy":
        return accuracy_phase(device)
    if case == "phase":
        name = POOL_PHASES[r]
        if name == "LU branch":
            return drive_lu(device)
        if name == "barc_tracking_mpc":
            return drive_tracking(device)
        if name == "dryrun_multichip":
            return drive_dryrun()
        return drive_nl_sqp(device, name)
    if case == "tools":
        return tools_phase(device, TOOLS_PARTS[r])
    if case.startswith("bench_rt_"):
        return bench_rt_replay(case[len("bench_rt_"):], r, device)
    fx = ctrl_fixture(case)
    if case in MODEL_CTRL_CASES:
        return replay(model_controller(case, device, n=int(fx["n"]))[0], fx, r)
    return teacher_forced(CTRL_CASES[case][0], fx, r, device,
                          regression=CTRL_REGRESSION.get(case))


def settle_replays(pending: list[tuple]) -> None:
    """Every controller path's teacher-forced replays, and the accuracy
    and tools phases, after the timed phases: ``pending`` holds (case, jobs,
    check) per path.  The jobs run side by side in ``REPLAY_WORKERS``
    processes of their own on the same card (a batch-1 cycle leaves the
    card idle ~90% of the time, so they overlap on the host; the replays'
    launches are not counted, the accuracy and tools phases count their
    own), the longest paths first;
    then each path's ``check`` holds its results to the reference.  Every
    process has ended when this returns."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    jobs = [(case, r) for case, count, _ in pending for r in range(count)]
    t = time.perf_counter()
    with ProcessPoolExecutor(REPLAY_WORKERS,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        done = dict(zip(jobs, pool.map(replay_job, *zip(*jobs))))
    print(f"replays: {len(jobs)} jobs in {REPLAY_WORKERS} processes, "
          f"{time.perf_counter() - t:.1f} s; each job's seconds, in the order they were "
          f"handed out: {[(c, r, round(done[(c, r)][1], 1)) for c, r in jobs]}", flush=True)
    for case, count, check_runs in pending:
        check_runs([done[(case, r)][0] for r in range(count)])


def drive_entry(device) -> dict:
    """``racing_lmpc_torch.entry.entry()``: its ``fn`` on its example
    arguments with every launch count set to 0 just before and read just
    after; finite controls of shape (N-1, nu), equal to the port's own
    ``solve_batch`` lane on the same input to the bit (the same code on the
    same device), and that solve with its runs on the moved inputs held
    with the flagship batch's gates to the reference's runs of
    ``__graft_entry__.entry()`` (``ENTRY_CASE``).  Returns the launch counts."""
    import torch
    from racing_lmpc_torch.benchmarks import build_barc_lmpc, make_scenario_batch
    from racing_lmpc_torch.entry import entry
    from racing_lmpc_torch.mpc.racing_mpc import REQUIRED_FIELDS

    fn, args = entry()
    zero_launches()
    U = fn(*args)
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"path entry: launches {launches}", flush=True)
    check(0 < launches["chol_tri_inv"] <= 150,
          f"entry: chol_tri_inv launches {launches['chol_tri_inv']} not in (0, 150]")
    check(launches["gj_inverse"] == 0, "entry: gj_inverse launched on the path")
    check(U.device.type == "cuda" and bool(torch.isfinite(U).all()), "entry: U not finite")

    fx = load_batch_fixture(ENTRY_CASE)
    check(tuple(U.shape) == fx["U_optm"].shape[1:], f"entry: U shape {tuple(U.shape)}")
    _, track, _, mpc, manager = build_barc_lmpc(n_horizon=20, num_ss=48, device=device)
    inp = make_scenario_batch(mpc, track, manager, batch=1, device=device)
    for name in REQUIRED_FIELDS:
        got, want = getattr(inp, name).cpu().numpy(), fx[f"inp_{name}"]
        check(got.shape == want.shape and np.allclose(got, want, rtol=1e-6, atol=1e-6),
              f"entry: scenario input {name} differs from the fixture")
        check(torch.equal(getattr(args[0], name), getattr(inp, name)[0]),
              f"entry: example argument {name} is not the scenario's")
    first, _ = mpc.solve_batch(inp)
    check(torch.equal(U, first.U_optm[0]),
          f"entry: fn differs from the solve_batch lane by "
          f"{float((U - first.U_optm[0]).abs().max()):.3e}")
    print("entry: fn(*example_args) equals the solve_batch lane to the bit", flush=True)
    failed = held_to_reference(runs_like_reference(mpc, inp, fx, first=first), fx,
                               gate_limits(fx), "entry vs reference")
    check(not failed, f"entry: outside the reference's own spread on {failed}")
    ms = cuda_time_ms(lambda: fn(*args), reps=5, warmup=1)
    print(f"path entry: {ms:.1f} ms a solve", flush=True)
    return launches


def accuracy_phase(device, tags=None) -> dict:
    """The pinned instances (those of ``tags``, or all) through the port on
    ``device`` at their gates (``acc_reading``, ``acc_limits``; every copy
    converged, the exact instance not beating the certified optimum by more
    than 1e-6, no copy beating it by more than 1e-6 beyond what its
    infeasibility allows, the build's inf pattern the export's), with every
    launch count set to 0
    just before the solves and read just after; then the oracle's dense f64
    solve on each instance, certified with the thresholds of
    tests/test_reference_match.py::test_oracle_self_certifies and within
    1e-6 of the stored optimum's controls; then the port's f64 OSQP on the
    first deviated instance from the two warm starts of
    test_reference_class_wander: accepted both times, its tail steering
    scattering by more than 1e-2.  Returns the lines to print, the failed
    checks, the launch counts and the timings."""
    import torch
    from racing_lmpc_torch.launch.runner import _SCENARIOS, CoSimulation
    from racing_lmpc_torch.mpc import osqp_ref
    from racing_lmpc_torch.mpc.reference_qp import kkt_residuals, solve_dense_qp_f64

    insts = [i for i in acc_instances() if tags is None or i[0]["tag"] in tags]
    mpcs = {}
    for rec, _, _ in insts:
        key = (rec["scenario"], rec["n_override"])
        if key not in mpcs:
            mpcs[key] = CoSimulation(_SCENARIOS[key[0]], n_override=key[1],
                                     device=device).controller.mpc
    lines, failed, qps = [], [], {}
    t = time.perf_counter()
    zero_launches()
    for rec, d, gates in insts:
        tag = rec["tag"]
        reading, qps[tag] = acc_reading(mpcs[(rec["scenario"], rec["n_override"])], rec, d,
                                        device)
        limits = acc_limits(rec, gates)
        bad = [k for k, v in limits.items() if not reading[k] < v]
        bad += [] if reading["solved"] == ACC_REPLICAS else ["solved"]
        bad += [] if reading["gap exact"] > -1e-6 else ["gap exact"]
        bad += [] if reading["unexplained beat"] < 1e-6 else ["unexplained beat"]
        bad += [] if reading["same inf"] else ["inf pattern"]
        failed += [f"{tag}: {k}" for k in bad]
        lines.append(f"accuracy {tag}: {reading['solved']}/{ACC_REPLICAS} solved; "
                     + "; ".join(f"{k} {reading[k]:.3e} (gate {v:.3e})" for k, v in limits.items())
                     + f"; gap of the instance {reading['gap exact']:.3e} (> -1e-6); gap min "
                     f"{reading['gap min']:.3e}, below the optimum beyond the infeasibility's "
                     f"dual bound {reading['unexplained beat']:.3e} (< 1e-6)"
                     + f" {'ok' if not bad else 'FAILS ' + ', '.join(bad)}")
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = read_launches()
    solve_s = time.perf_counter() - t
    oracle_ms = {}
    for rec, d, _ in insts:
        tag, qp = rec["tag"], qps[rec["tag"]]
        t = time.perf_counter()
        try:
            z, y = solve_dense_qp_f64(qp)
        except RuntimeError as e:
            failed.append(f"{tag}: oracle {e}")
            continue
        rp, rd, rc = kkt_residuals(qp, z, y)
        oracle_ms[tag] = (time.perf_counter() - t) * 1e3
        rd_rel = rd / max(1.0, float(qp.q.abs().max()))
        dev = float(((qp.controls(z) - qp.controls(torch.as_tensor(d["z_star"], device=z.device)))
                     / qp.scale_u).abs().max())
        ok = rp < 1e-9 and rc < 1e-6 and rd_rel < 1e-9 and dev < 1e-6
        failed += [] if ok else [f"{tag}: oracle residuals or landing"]
        lines.append(f"oracle {tag} (n={qp.layout.n}, m={len(qp.l)}): {oracle_ms[tag]:.1f} ms; "
                     f"rp {rp:.2e} (< 1e-9), rd/|q| {rd_rel:.2e} (< 1e-9), rc {rc:.2e} "
                     f"(< 1e-6); controls {dev:.2e} from the stored optimum (< 1e-6) "
                     f"{'ok' if ok else 'FAILS'}")
    osqp = {}
    dev_insts = [(rec, d) for rec, d, _ in insts if "_dev" in rec["tag"]]
    if dev_insts:
        rec, d = dev_insts[0]
        su = d["scale_u"]
        N, nx, nu = d["inp_X_ref"].shape[0], 6, len(su)
        rng = np.random.default_rng(0)
        data = [torch.as_tensor(d[k], device=device) for k in "PqAlu"]
        sols = []
        for x0 in (np.zeros_like(d["z_star"]),
                   d["z_star"] + 0.1 * rng.standard_normal(len(d["z_star"]))):
            t = time.perf_counter()
            res = osqp_ref.solve(*data, x0=torch.as_tensor(x0, device=device))
            ms = (time.perf_counter() - t) * 1e3
            osqp.setdefault("iters", []).append(res.iters)
            osqp.setdefault("ms", []).append(ms)
            lines.append(f"osqp {rec['tag']}: {res.status} after {res.iters} iterations, "
                         f"polished {res.polished}, {ms:.1f} ms")
            failed += [] if res.status == "solved" else [f"{rec['tag']}: osqp {res.status}"]
            sols.append(res.x[N * nx:N * nx + (N - 1) * nu].reshape(N - 1, nu).cpu().numpy() * su)
        scatter = float((np.abs(sols[0] - sols[1]) / su)[:, 1].max())
        osqp["scatter"] = scatter
        lines.append(f"osqp {rec['tag']}: reference-class tail-steering wander {scatter:.3e} "
                     f"(> 1e-2) {'ok' if scatter > 1e-2 else 'FAILS'}")
        failed += [] if scatter > 1e-2 else ["osqp wander"]
    return {"lines": lines, "failed": failed, "launches": launches, "solve_s": solve_s,
            "oracle_ms": oracle_ms, "osqp": osqp}


# the tools phase (racing_lmpc_torch/tools): ground_accuracy's engine step
# on every pinned instance at this override set, one pareto point there at
# one repetition and a 2-solve chain, the multihost report's NCCL rank at
# world size 1, and the Putnam seed-lap recorder's first cycles, held to the
# reference's spread over its stored runs
# (tests/data/torch_port/tools_putnam_ss.npz)
TOOLS_GRID = [{"qp_zoom_rounds": 3}]
TOOLS_PARETO = {"reps": 1, "chain": 2, "chain_reps": 1}
TOOLS_SS_STEPS = 10
# the floors of the recorder rows' readings (ss_row_errors): state and
# previous control relative to max(1, |reference|), curvature and time
# absolute
SS_ROW_FLOORS = {"x": 1e-4, "u": 1e-4, "k": 1e-6, "t": 1e-9}


def ss_row_errors(rows: dict, ref: dict) -> dict:
    """The largest difference over the cycles of recorder rows ``rows`` from
    a run ``ref`` of the same length, by row part, as ``SS_ROW_FLOORS``
    reads them."""
    return {k: float(np.abs(np.asarray(rows[k], np.float64) - ref[k]).max()
                     / (max(1.0, float(np.abs(ref[k]).max())) if k in "xu" else 1.0))
            for k in SS_ROW_FLOORS}


def ss_runs(fx) -> list[dict]:
    """The stored reference runs of the recorder's loop (the run itself
    first, then its moved re-runs)."""
    return [{k: fx[k][r] for k in ("x", "u", "k", "t", "solved")} for r in range(len(fx["t"]))]


def ss_row_limits(fx) -> dict:
    """Each row part's limit: the reference's worst reading between two of
    its runs, or ``SS_ROW_FLOORS`` where that is wider; and the most
    fallbacks of a reference run."""
    runs = ss_runs(fx)
    worst = [ss_row_errors(a, b) for i, a in enumerate(runs) for j, b in enumerate(runs) if i != j]
    return {**{k: max(f, *(w[k] for w in worst)) for k, f in SS_ROW_FLOORS.items()},
            "fallbacks": max(int((~r["solved"]).sum()) for r in runs)}


def ss_held(rows: dict, fallbacks: int, fx) -> tuple[dict, dict, bool]:
    """The recorder's rows and fallbacks against the reference's first run,
    within ``ss_row_limits``: (reading, limits, held)."""
    ref = ss_runs(fx)[0]
    n = len(ref["t"])
    reading = {**ss_row_errors({k: v[:n] for k, v in rows.items()}, ref), "fallbacks": fallbacks}
    limits = ss_row_limits(fx)
    return reading, limits, all(reading[k] <= limits[k] for k in limits)


# the tools phase in two parts, each a job of the replay pool: the engine
# records and the pareto point from them; the recorder and the NCCL rank
TOOLS_PARTS = (("engine", "pareto"), ("record_putnam_ss", "multihost_report"))


def tools_phase(device, tools: tuple) -> dict:
    """The ``tools`` (of the four in ``TOOLS_PARTS``) on ``device`` with every launch
    count set to 0 just before and read just after (the NCCL rank's own
    count added): the engine records of ``TOOLS_GRID`` on the 11 pinned
    instances, each finite with the reference QP's build within 1e-9 of the
    export; a pareto point from those records with ``PARETO.json``'s keys,
    finite positive throughput, ``chol_tri_inv`` launched by both
    measurements and ``gate_failures`` by the reference tool's rule;
    ``TOOLS_SS_STEPS`` cycles of the Putnam recorder into a temporary
    directory, its rows and fallbacks within the reference's spread over its
    stored runs (``ss_held``); the NCCL rank's ``scaling_bench`` at the
    flagship batch.  Returns the lines, the failed checks, the launches and
    each tool's seconds."""
    import tempfile
    import torch
    from racing_lmpc_torch.tools import ground_accuracy, multihost_report, pareto
    from racing_lmpc_torch.tools import record_putnam_ss
    from racing_lmpc_torch.tools.accuracy import ACC_DIR

    check("pareto" not in tools or "engine" in tools, "pareto reads the engine's records")
    lines, failed, seconds = [], [], {}
    reference = json.loads((ROOT / "PARETO.json").read_text())["points"][0]
    gates = json.loads((ROOT / "ACCURACY.json").read_text())["per_instance"]
    zero_launches()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as tmp:
        tmp = Path(tmp)
        if "engine" in tools:
            t = time.perf_counter()
            runs = ground_accuracy.run_engine(ACC_DIR, tmp, device, TOOLS_GRID)
            seconds["engine"] = time.perf_counter() - t
            (key, recs), = runs.items()
            nums = [v for r in recs.values() for k, v in r.items()
                    if k not in ("solved", "same_inf")]
            ok = (len(recs) == 11 and bool(np.isfinite(nums).all())
                  and all(r["drift"] < 1e-9 and r["same_inf"] for r in recs.values()))
            failed += [] if ok else ["engine records"]
            lines.append(f"tools ground_accuracy --engine {key}: {len(recs)} instances in "
                         f"{seconds['engine']:.1f} s; worst applied steer "
                         f"{max(r['applied_steer_err'] for r in recs.values()):.3e}, worst "
                         f"objective gap {max(r['objective_gap'] for r in recs.values()):.3e}, "
                         f"unsolved {[t for t, r in recs.items() if not r['solved']]} "
                         f"{'ok' if ok else 'FAILS'}")
        if "pareto" in tools:
            t = time.perf_counter()
            doc = pareto.run(device, TOOLS_GRID, tmp / "PARETO_torch.json", runs,
                             **TOOLS_PARETO)
            seconds["pareto"] = time.perf_counter() - t
            p, = doc["points"]
            rule = [tag for tag, r in recs.items()
                    if r["applied_steer_err"] >= gates[tag]["applied_steer_gate"]]
            ok = (set(reference) <= set(p) and p["gate_failures"] == rule
                  and np.isfinite(p["solves_per_s_batch256_N20"])
                  and p["solves_per_s_batch256_N20"] > 0
                  and p["batch1_chain_ms"] > 0 and p["chol_tri_inv_per_solve_batch"] > 0
                  and p["chol_tri_inv_per_solve_chain"] > 0
                  and doc["device"] == torch.cuda.get_device_name(device))
            failed += [] if ok else ["pareto point"]
            lines.append(f"tools pareto {key} ({seconds['pareto']:.1f} s, {doc['device']} at "
                         f"{doc['power_limit_w']} W): {json.dumps(p)} {'ok' if ok else 'FAILS'}")
        if "record_putnam_ss" in tools:
            t = time.perf_counter()
            ss = record_putnam_ss.record(tmp / "ss", max_steps=TOOLS_SS_STEPS, device=device,
                                         log_every=0)
            seconds["record_putnam_ss"] = time.perf_counter() - t
            reading, limits, held = ss_held(ss["rows"], round(ss["fallback"] * ss["steps"]),
                                            load_fixture("tools_putnam_ss"))
            ok = ss["steps"] == TOOLS_SS_STEPS and held
            failed += [] if ok else ["record_putnam_ss rows"]
            lines.append(f"tools record_putnam_ss: {ss['steps']} cycles in "
                         f"{seconds['record_putnam_ss']:.1f} s; rows and fallbacks from the "
                         f"reference's run {reading} (limits, the reference's spread over its "
                         f"runs: {limits}) {'ok' if ok else 'FAILS'}")
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = read_launches()
    if "multihost_report" in tools:
        t = time.perf_counter()
        nccl = multihost_report.report(device, cpu_ranks=(), reps=1)["nccl_world_size_1"]
        seconds["multihost_report"] = time.perf_counter() - t
        launches["chol_tri_inv"] += nccl["chol_tri_inv_launches"]
        bench, = nccl["scaling_bench"]
        ok = (nccl["backend"] == "nccl" and nccl["world_size"] == 1
              and bench["solved_fraction"] > 0.9 and nccl["chol_tri_inv_launches"] > 0
              and np.isfinite(nccl["metrics_allreduce_ms"]))
        failed += [] if ok else ["multihost_report NCCL"]
        lines.append(f"tools multihost_report (NCCL world size 1, "
                     f"{seconds['multihost_report']:.1f} s): {json.dumps(nccl)} "
                     f"{'ok' if ok else 'FAILS'}")
    return {"lines": lines, "failed": failed, "launches": launches, "seconds": seconds}


REG_KEYS = ("dA", "dB", "dC")


def reg_reading(a: dict, fx, r: int) -> dict:
    """How far the regression corrections of run ``a`` lie from stored run
    ``r``'s: the max |difference| over cycles and entries, per matrix."""
    return {f"{k} max": float(np.abs(np.asarray(a[k], np.float64) - fx[k][r]).max())
            for k in REG_KEYS}


def reg_limits(fx) -> dict:
    """Each regression gate's limit: the reference's worst reading between
    any two of its stored runs."""
    runs = len(fx["dA"])
    return {f"{k} max": max(float(np.abs(fx[k][i].astype(np.float64) - fx[k][j]).max())
                            for i in range(runs) for j in range(runs) if i != j)
            for k in REG_KEYS}


def held_ctrl(port: list[dict], fx, limits: dict, label: str) -> list[str]:
    """Each controller gate reads every port run against the reference's
    run on the same inputs; the median over the runs is held to the limit.
    Prints the readings; returns the names of the gates whose median
    fails."""
    got = [ctrl_reading(p, q, fx["scale_u"]) for p, q in zip(port, ctrl_runs(fx))]
    print(f"{label}, {len(port)} teacher-forced runs: fallbacks "
          f"{[int(p['used_fallback'].sum()) for p in port]} (reference "
          f"{fx['used_fallback'].sum(axis=1)[:len(port)].tolist()})", flush=True)
    return held(got, limits)


def closed_loop(device, scenario: str, steps: int, regression=None):
    """``steps`` lock-step cycles of the port's co-simulation of a launch
    scenario (with the error-dynamics regression when ``regression`` is
    given), the launch counts set to 0 just before and read just after.
    Returns the co-simulation, the launches, the fallbacks, the median
    cycle ms after the bootstrap, per cycle the plant's abscissa and lap
    after the cycle, and per cycle the published (u_a, u_steer)."""
    import torch
    from racing_lmpc_torch.control import RegressionSpec
    from racing_lmpc_torch.launch.runner import _SCENARIOS, CoSimulation
    cs = CoSimulation(_SCENARIOS[scenario], device=device)
    if regression is not None:
        cs.controller.regression = RegressionSpec(*regression)
    zero_launches()
    plant, acts = [], []
    for _ in range(steps):
        act = cs.controller_cycle(cs.vehicle_state_msg())
        acts.append((act.u_a, act.u_steer))
        msg = cs.plant_cycle(act)
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
    return cs, launches, fallbacks, float(np.median(ms[1:])), s, lap, np.asarray(acts)


def progress_gates(case: str, fx, fallbacks: int, prog: float) -> None:
    """The closed-loop gates against the stored reference runs: no more
    fallbacks than the reference's first run plus its spread, and the final
    progress ``prog`` (laps x length + abscissa) as near some reference run
    as the reference's runs come to each other, or 0.1% of the distance
    covered."""
    ref_fb = fx["used_fallback"].sum(axis=1)
    allowed = int(ref_fb[0] + ref_fb.max() - ref_fb.min())
    check(fallbacks <= allowed, f"{case}: {fallbacks} fallbacks, reference allows {allowed}")
    L = float(fx["total_length"])
    ref_prog = fx["lap"][:, -1] * L + fx["s"][:, -1]
    covered = ref_prog[0] - float(fx["x_ctrl"][0, 0, 0])
    width = float(ref_prog.max() - ref_prog.min())
    limit = max(width, 1e-3 * abs(covered))
    gap = float(np.abs(ref_prog - prog).min())
    print(f"{case} closed loop: fallbacks {fallbacks} (reference {ref_fb.tolist()}, "
          f"allowed {allowed}); final progress {prog - ref_prog[0]:+.3e} m from the "
          f"reference run's, {gap:.3e} m from the nearest of its runs (they lie "
          f"{np.round(ref_prog - ref_prog[0], 4).tolist()} m from it, {covered:.2f} m "
          f"covered; limit {limit:.3e} m)", flush=True)
    check(gap <= limit, f"{case}: final progress {gap:.3e} m from every reference run")


def drive_controller(device, case: str) -> tuple[dict, float, float, np.ndarray, tuple]:
    """The controller path of fixture ``case``: the port's closed loop,
    checked against the stored reference runs (on the track every cycle,
    ``progress_gates``) and a profiled cycle.  Returns the launches, the
    median cycle ms, the idle share of the profiled cycle, the published
    (u_a, u_steer) per cycle and the path's teacher-forced replays for
    ``settle_replays``: held to the reference's
    own spread (and, with the regression, each cycle's dA/dB/dC to the
    spread between the reference's runs)."""
    scenario = CTRL_CASES[case][0]
    steps = CTRL_DEPTH.get(case, CTRL_CASES[case][1])
    regression = CTRL_REGRESSION.get(case)
    fx = ctrl_fixture(case)
    check(fx["x_ctrl"].shape[1] == steps, f"{case}: fixture has fewer cycles")
    cs, launches, fallbacks, cycle_ms, s, lap, acts = closed_loop(device, scenario, steps,
                                                                  regression)
    progress_gates(case, fx, fallbacks, float(lap[-1] * float(fx["total_length"]) + s[-1]))
    print(f"  port u_apply per cycle {[np.round(t.control, 4).tolist() for t in cs.telemetry]}",
          flush=True)
    idle = profile(cs.step, cycle_ms, f"{case} one cycle")

    def held_replays(port):
        failed = held_ctrl(port, fx, ctrl_limits(fx), f"{case} vs reference")
        if regression is not None:
            got = [reg_reading(p, fx, r) for r, p in enumerate(port)]
            failed += held(got, reg_limits(fx))

            def rows(a):
                return np.round(np.asarray(a, np.float64), 5).tolist()
            for c in range(steps):
                print(f"  cycle {c}: dA[4:, 3:] port {rows(port[0]['dA'][c, 4:, 3:])} reference "
                      f"{rows(fx['dA'][0, c, 4:, 3:])}; dC[4:] port {rows(port[0]['dC'][c, 4:])} "
                      f"reference {rows(fx['dC'][0, c, 4:])}", flush=True)
        check(not failed, f"{case}: outside the reference's own spread on {failed}")
    return launches, cycle_ms, idle, acts, (case, CTRL_REPLAYS[case], held_replays)


def drive_tracking(device, steps: int = 5) -> dict:
    """The tracking controller (no safe set: the K=0 layout) in closed
    loop: finite and on the track every cycle."""
    return closed_loop(device, "barc_tracking_mpc", steps)[1]


def make_ekf(fx, model, device):
    """The port's EKF configured as the fixture's, with its one full-state
    observation, initialized at t = 0."""
    from racing_lmpc_torch.config import EKFConfig
    from racing_lmpc_torch.estimation import EKFStateEstimator
    ekf = EKFStateEstimator(EKFConfig(**{k: tuple(fx[f"ekf_cfg_{k}"].tolist()) for k in
                                         ("x0", "p0", "q", "x_max", "x_min")}),
                            model, device=device)
    ekf.register_observation("full_state", model.nx, lambda x, z: x)
    ekf.initialize(0)
    return ekf


EKF_FIELDS = (("p", "s"), ("p", "x_tran"), ("p", "e_psi"),
              ("v", "v_long"), ("v", "v_tran"), ("w", "w_psi"))


def ekf_filter(cs, ekf):
    """The state filter of the continuous path (the fixture's): every
    controller cycle the published state plus seeded noise is one
    observation at the message's simulated time, after the previous applied
    control; the controller gets the estimate."""
    rng = np.random.default_rng(EKF_SEED)
    std = np.asarray(EKF_NOISE_STD)
    R = np.diag(std ** 2).astype(np.float32)

    def filt(msg):
        truth = np.array([getattr(getattr(msg, a), b) for a, b in EKF_FIELDS])
        z = truth + rng.standard_normal(6) * std
        ekf.update_control(cs._u_prev)
        res = ekf.update_observation("full_state", int(round(msg.t * 1e9)), z, R)
        for (a, b), v in zip(EKF_FIELDS, res["x"].cpu().numpy().astype(np.float64)):
            setattr(getattr(msg, a), b, v)
        return msg
    return filt


def ekf_replay(fx, model, device) -> dict:
    """The port's EKF fed the stored run's observations, controls and
    timestamps; its estimates against the stored ones (max |dx|, and max
    |dP| over the largest stored |P|)."""
    ekf = make_ekf(fx, model, device)
    R = np.diag(np.asarray(EKF_NOISE_STD) ** 2).astype(np.float32)
    xs, Ps = [], []
    for z, t, u in zip(fx["ekf_z"][0], fx["ekf_t_ns"][0], fx["ekf_u"][0]):
        ekf.update_control(u)
        res = ekf.update_observation("full_state", int(t), z, R)
        xs.append(res["x"])
        Ps.append(res["P"])
    import torch
    x = torch.stack(xs).cpu().numpy().astype(np.float64)
    P = torch.stack(Ps).cpu().numpy().astype(np.float64)
    return {"x max": float(np.abs(x - fx["ekf_x"][0]).max()),
            "P max rel": float(np.abs(P - fx["ekf_P"][0]).max() / np.abs(fx["ekf_P"][0]).max())}


def run_continuous(device, scenario: str, ticks: int, outage: tuple, fx, **cont_kw):
    """``ticks`` plant ticks of the port's ``ContinuousCoSimulation`` of
    ``scenario`` with the EKF in the loop and actuation dropped over
    ``outage``, the launch counts set to 0 just before and read just after.
    Returns the co-simulation, its summary and the launches."""
    import torch
    from racing_lmpc_torch.launch.runner import _SCENARIOS, ContinuousCoSimulation
    sim = ContinuousCoSimulation(_SCENARIOS[scenario], device=device, **cont_kw)
    sim.cs.state_filter = ekf_filter(sim.cs, make_ekf(fx, sim.cs.ctrl_model, device))
    t0, t1 = outage
    zero_launches()
    summary = sim.run(ticks, actuation_gate=lambda t: not (t0 <= t < t1))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return sim, summary, read_launches()


def continuous_gates(case: str, sim, summary: dict, ticks: int, outage: tuple, fx) -> int:
    """The continuous path's gates: a published state every plant tick, the
    controller cycles of the schedule, finite outputs, the car on the track
    every tick and moving through the outage (the keepalive), and
    ``progress_gates`` against the stored runs.  Returns the fallbacks."""
    cs = sim.cs
    check(summary["published_states"] == ticks == int(fx["published_states"]),
          f"{case}: {summary['published_states']} states published in {ticks} ticks")
    check(summary["controller_cycles"] == int(fx["controller_cycles"]),
          f"{case}: {summary['controller_cycles']} controller cycles, the schedule has "
          f"{int(fx['controller_cycles'])}")
    for i, t in enumerate(cs.telemetry):
        check(np.isfinite(t.control).all() and np.isfinite(t.cost) and np.isfinite(t.state).all(),
              f"{case}: cycle {i} output not finite")
    s = np.array([m.p.s for m in sim.published])
    x_tran = np.array([m.p.x_tran for m in sim.published])
    inside = ((x_tran <= cs.track.left_boundary_np(s)) & (x_tran >= cs.track.right_boundary_np(s)))
    check(bool(inside.all()), f"{case}: off the track at ticks {np.flatnonzero(~inside)}")
    # the keepalive: the plant keeps integrating on the last command
    L = cs.track.total_length
    ts = np.arange(ticks) * sim.sim_dt
    ds = np.diff(s[(ts >= outage[0]) & (ts < outage[1])])
    ds = np.where(ds < -0.5 * L, ds + L, ds)
    check(ds.size > 0 and ds.min() > 0.0, f"{case}: the car stopped during the actuation outage")
    fallbacks = sum(not t.solved for t in cs.telemetry)
    progress_gates(case, fx, fallbacks, float(sim.published[-1].lap_num * L + s[-1]))
    return fallbacks


def drive_continuous(device, case: str) -> tuple[dict, float, float]:
    """The continuous co-simulation path: ``run_continuous`` held by
    ``continuous_gates``, a profiled controller cycle, and the EKF replayed
    on the stored run's inputs.  Returns the launches, the median cycle ms
    and the idle share of the profiled cycle."""
    scenario, ticks, outage = CONT_CASES[case]
    with np.load(FIXTURE_DIR / f"{case}.npz") as z:
        fx = {k: z[k] for k in z.files}
    sim, summary, launches = run_continuous(device, scenario, ticks, outage, fx)
    check(launches["chol_tri_inv"] > 0, f"{case}: chol_tri_inv never launched")
    check(launches["gj_inverse"] == 0, f"{case}: gj_inverse launched on the path")
    fallbacks = continuous_gates(case, sim, summary, ticks, outage, fx)
    cs = sim.cs
    ms = np.array([t.solve_time * 1e3 for t in cs.telemetry])
    cycle_ms = float(np.median(ms[1:]))
    print(f"path {case}: {ticks} plant ticks of {sim.sim_dt * 1e3:.0f} ms, "
          f"{summary['controller_cycles']} controller cycles, actuation dropped over "
          f"[{outage[0]}, {outage[1]}) s, launches {launches}; fallbacks {fallbacks}; on the "
          f"track every tick; cycle wall ms: first (bootstrap) {ms[0]:.1f}, median after "
          f"{cycle_ms:.1f}", flush=True)
    idle = profile(lambda: cs.controller_cycle(cs.vehicle_state_msg()), cycle_ms,
                   f"{case} one controller cycle")
    got = ekf_replay(fx, cs.ctrl_model, device)
    print(f"{case} EKF replayed on the stored run's {len(fx['ekf_z'][0])} observations: "
          f"state max |dx| {got['x max']:.3e} (limit {EKF_X_TOL:.0e}), covariance max |dP| "
          f"{got['P max rel']:.3e} of its largest entry (limit {EKF_P_TOL:.0e})", flush=True)
    check(got["x max"] <= EKF_X_TOL and got["P max rel"] <= EKF_P_TOL,
          f"{case}: the EKF does not reproduce the stored estimates")
    return launches, cycle_ms, idle


def stack_problem():
    """The control-stack case, as tests/torch_port_fixture.py builds it for
    the reference: ``STACK_BATCH`` initial-state perturbations around the
    LQR reference (numpy seed 0), and the BARC legacy controller of
    tests/test_aux.py's legacy test on three initial states.  Returns numpy
    inputs and the legacy config's fields."""
    rng = np.random.default_rng(0)
    pert = rng.standard_normal((STACK_BATCH, 6)) * np.array([1.0, 0.3, 0.01, 0.5, 0.05, 0.02])
    legacy = dict(n=10, margin=0.1, average_track_width=1.0, q_contour=1.0,
                  q_heading=1.0, q_vel=0.2, q_boundary=100.0, r=(0.01, 0.0, 0.0, 0.01),
                  x_max=(np.inf, np.inf, np.inf, 6.0, 1.0, 3.0),
                  x_min=(-np.inf, -np.inf, -np.inf, 0.1, -1.0, -3.0),
                  u_max=(0.01, 0.33), u_min=(-0.01, -0.33), sqp_iters=4)
    dt, v_ref = 0.025, 1.5
    X_leg = np.zeros((legacy["n"], 6), np.float32)
    X_leg[:, 0] = v_ref * dt * np.arange(legacy["n"])
    X_leg[:, 3] = v_ref
    x_leg = np.array([[0.0, 0.05, 0.0, 1.2, 0.0, 0.0], [0.3, -0.1, 0.05, 1.5, 0.0, 0.1],
                      [0.1, 0.15, -0.05, 1.0, 0.05, -0.1]], np.float32)
    return {"lqr_pert": pert.astype(np.float32), "leg_X_ref": X_leg,
            "leg_x_ic": x_leg, "leg_dt": np.float64(dt)}, legacy


def lqr_sample_model():
    """The IAC-scale sample vehicle in the global frame with its three
    controls (tests/test_lqr_ekf.py:28-38), and ``sample_lqr``'s config."""
    import dataclasses
    from racing_lmpc_torch import config as tc
    from racing_lmpc_torch.models import SingleTrackPlanarModel
    p = tc.load_ros_params(tc.PARAM_DIR / "sample_vehicle_base.param.yaml",
                           tc.PARAM_DIR / "sample_vehicle_single_track.param.yaml")
    base = tc.vehicle_config_from_params(p)
    base = dataclasses.replace(base, modeling=dataclasses.replace(
        base.modeling, use_frenet=False, integrator_type="rk4", sample_throttle=60.0))
    model = SingleTrackPlanarModel(base, tc.single_track_config_from_params(
        p, simplify_lon_control=False))
    cfg = tc.lqr_config_from_params(tc.load_ros_params(tc.PARAM_DIR / "sample_lqr.param.yaml"))
    return model, cfg


# the bound each legacy gate keeps at the least: the controller gates' floors
LEGACY_FLOORS = {"lon max": 1e-3, "steer max": 3e-3, "X max": 1e-3}


def legacy_reading(U, X, U_ref, X_ref, su) -> dict:
    """How far legacy solves (U, X over the three cases) lie from others:
    the max |dU| / scale_u of each control and the max |dX|."""
    dU = np.abs(np.asarray(U, np.float64) - U_ref) / su
    return {"lon max": float(dU[..., 0].max()), "steer max": float(dU[..., 1].max()),
            "X max": float(np.abs(np.asarray(X, np.float64) - X_ref).max())}


def drive_stack(device) -> dict:
    """The LQR's ``solve_batch`` at ``STACK_BATCH`` and three legacy
    full-dynamics solves against the stored reference (``stack.npz``), each
    with the launch counts set to 0 just before and read just after.  The
    LQR is held within ``LQR_TOL``; the legacy solves within the
    reference's worst reading between its stored runs from moved initial
    states (or ``LEGACY_FLOORS``)."""
    import torch
    from racing_lmpc_torch import config as tc
    from racing_lmpc_torch.control import RacingLMPCLegacy, RacingLMPCLegacyConfig
    from racing_lmpc_torch.models import SingleTrackPlanarModel
    from racing_lmpc_torch.mpc.racing_lqr import RacingLQR
    from racing_lmpc_torch.track import RacingTrajectory
    with np.load(FIXTURE_DIR / "stack.npz") as z:
        fx = {k: z[k] for k in z.files}
    inputs, legacy = stack_problem()
    check(all(np.array_equal(inputs[k], fx[k]) for k in inputs), "stack: inputs differ")
    model, cfg = lqr_sample_model()
    lqr = RacingLQR(cfg, model, device=device)
    B = STACK_BATCH
    args = ((fx["lqr_X_ref"][0] + fx["lqr_pert"]).astype(np.float32),
            np.tile(fx["lqr_X_ref"], (B, 1, 1)), np.tile(fx["lqr_U_ref"], (B, 1, 1)))
    zero_launches()
    sol = lqr.solve_batch(*args)
    torch.cuda.synchronize()
    lqr_launches = read_launches()
    errs = {k: float((np.abs(getattr(sol, k).cpu().numpy().astype(np.float64) - fx[f"lqr_{k}"])
                      / np.maximum(np.abs(fx[f"lqr_{k}"]), 1.0)).max())
            for k in ("u", "U_optm", "X_optm")}
    ms = cuda_time_ms(lambda: lqr.solve_batch(*args), reps=5, warmup=1)
    print(f"stack: RacingLQR.solve_batch at batch {B}: launches {lqr_launches}; max rel err "
          f"vs reference {errs} (limit {LQR_TOL:.0e}); {ms:.2f} ms a batch", flush=True)
    check(max(errs.values()) <= LQR_TOL, f"stack: LQR differs from the reference {errs}")

    track = RacingTrajectory.from_file(tc.TRACK_DIR / "barc" / "02_barc_center.txt",
                                       device=device)
    ctrl = RacingLMPCLegacy(RacingLMPCLegacyConfig(**legacy),
                            SingleTrackPlanarModel(*tc.barc_vehicle()), track)
    zero_launches()
    t = time.perf_counter()
    outs = [ctrl.solve(x0, fx["leg_X_ref"], np.zeros((legacy["n"] - 1, 2), np.float32),
                       float(fx["leg_dt"])) for x0 in fx["leg_x_ic"]]
    torch.cuda.synchronize()
    leg_ms = (time.perf_counter() - t) * 1e3 / len(outs)
    leg_launches = read_launches()
    check(all(bool(o.solved) for o in outs) and bool(fx["leg_solved"].all()),
          "stack: a legacy solve did not converge")
    su = ctrl.mpc.scale_u
    runs = [(fx["leg_U_optm"], fx["leg_X_optm"])] + list(zip(fx["leg_U_optm_pert"],
                                                             fx["leg_X_optm_pert"]))
    spread = [legacy_reading(*a, *b, su) for i, a in enumerate(runs) for b in runs[i + 1:]]
    limits = {k: max(f, *(r[k] for r in spread)) for k, f in LEGACY_FLOORS.items()}
    got = legacy_reading(torch.stack([o.U_optm for o in outs]).cpu().numpy(),
                         torch.stack([o.X_optm for o in outs]).cpu().numpy(),
                         fx["leg_U_optm"], fx["leg_X_optm"], su)
    print(f"stack: three RacingLMPCLegacy.solve calls ({leg_ms:.1f} ms each): launches "
          f"{leg_launches}; vs reference {got}, limits {limits}", flush=True)
    check(all(got[k] <= limits[k] for k in limits), "stack: legacy solves outside the limits")
    check(leg_launches["chol_tri_inv"] > 0 and leg_launches["gj_inverse"] == 0,
          f"stack: legacy launches {leg_launches}")
    return {"lqr": lqr_launches, "legacy": leg_launches}


# ---------------------------------------------------------------------------
# the nonlinear-row paths: the kinematic-bicycle and double-track models with
# their linearized constraint rows (tests/test_nl_constraints.py,
# tests/test_closed_loop.py:145-219), as tests/torch_port_fixture.py builds
# them for the reference
# ---------------------------------------------------------------------------

# nl_kinematic: BARC kinematic bicycle, P_max lowered to 1.2 W so the power
# row binds; an aggressive speed ramp solved by solve_sqp
NL_KIN = {"n": 14, "sqp_iters": 6, "x_ic": (0.5, 0.0, 0.0, 1.6), "v0": 1.6,
          "v_target": 3.2, "dt": 0.025}
# the double-track braking hard into Putnam's tightest corner: batch-1 SQP at
# the JAX test's N=10, and a batch of lanes whose initial states are drawn
# around the test's (abscissa +-5 m, lateral +-0.5 m, speed 45-60 m/s)
NL_DT = {"n": 10, "sqp_iters": 8, "free_iters": 6, "v0": 55.0, "v_target": 15.0,
         "dt": 0.04, "before_corner": 10.0}
NL_DT_BATCH = {"n": 20, "batch": 256, "seed": 5, "ds": 5.0, "dpy": 0.5,
               "v": (45.0, 60.0)}
# the nl fixture's moved re-runs: x_ic and X_ref scaled by 1 + 2e-7 N(0, 1)
# from seed 1 + s, as ``moved`` reproduces them
NL_MOVED = 4
# of those, the moved inputs the card solves again (the first ones; cut to
# keep the script inside its time): the median of its 1 + NL_REPLAYED
# readings against the reference's runs paired with them
NL_REPLAYED = 2
# the nl batch's: eight, as the batched paths' (the median over 9 runs)
NL_BATCH_MOVED = 8
# the bound each nl gate keeps at the least, as the batched and controller
# gates' floors: 2 lanes, the longitudinal controls and the states 1e-3 of
# their scales, steering 3e-3, the objective 1e-3 relative, the
# friction-ellipse residual 1e-3
NL_SQP_FLOORS = {"U lon max": 1e-3, "U steer max": 3e-3, "X max": 1e-3}
NL_BATCH_FLOORS = {"solved differs": 2, "lon max": 1e-3, "steer p50": 3e-3,
                   "steer p90": 3e-3, "objective max": 1e-3, "ellipse max": 1e-3}
# the closed loops of tests/test_closed_loop.py:145-219: case -> (model,
# horizon, controller dt, the test's cycles after the first, initial state),
# as tests/torch_port_fixture.py stores them
MODEL_CTRL_CASES = {
    "ctrl_kinematic": ("kinematic", 10, 0.025, 60, (0.1, 0.05, 0.0, 1.0)),
    "ctrl_double_track": ("double_track", 25, 0.01, 150, (0.1, 0.05, 0.0, 0.0, 0.0, 1.0)),
}
# the cycles the card drives, prefixes of the stored runs cut to fit the
# script's time (the double-track's host time a cycle is ~3x the
# kinematic's; both cut further when the bench and the tools phases came in)
MODEL_CTRL_DEPTH = {"ctrl_kinematic": 12, "ctrl_double_track": 7}
MODEL_CTRL_REPLAYS = 5
# the JAX tests' closed-loop gates: fallbacks, max |lateral offset|, final speed
MODEL_CTRL_GATES = {"fallbacks": 5, "lat": 0.2, "speed": 1.0}


def nl_problem(kind: str, n: int, device, free: bool = False):
    """(model, track, mpc) of a nonlinear-row scenario: the BARC kinematic
    bicycle with P_max = 1.2 W on the BARC track, or the sample vehicle's
    double-track on Putnam, each with its test's tracking config.  ``free``
    drops the model's constraint rows (the load-bearing control)."""
    from racing_lmpc_torch import config as tc
    from racing_lmpc_torch.models import DoubleTrackPlanarModel, KinematicBicycleModel
    from racing_lmpc_torch.mpc.racing_mpc import RacingMPC
    from racing_lmpc_torch.track import RacingTrajectory
    no_box = dict(x_min=(), x_max=(), u_min=(), u_max=())
    if kind == "kinematic":
        p = tc.load_ros_params(tc.PARAM_DIR / "barc_base.param.yaml",
                               tc.PARAM_DIR / "barc_single_track.param.yaml")
        model = KinematicBicycleModel(tc.vehicle_config_from_params(p),
                                      tc.single_track_config_from_params(
                                          p, simplify_lon_control=False, p_max=1.2))
        track_file = tc.TRACK_DIR / "barc" / "02_barc_center.txt"
        eye3 = tuple(np.eye(3).ravel() * 0.01)
        cfg = tc.barc_mpc_config("barc_tracking_mpc", n=n, learning=False,
                                 r=eye3, r_d=eye3, q_vel=8.0, **no_box)
    else:
        p = tc.load_ros_params(tc.PARAM_DIR / "sample_vehicle_base.param.yaml",
                               tc.PARAM_DIR / "sample_vehicle_double_track.param.yaml")
        model = DoubleTrackPlanarModel(tc.vehicle_config_from_params(p),
                                       tc.double_track_config_from_params(p))
        track_file = tc.TRACK_DIR / "putnam" / "10_putnam_optm.txt"
        eye3 = tuple((np.eye(3) * np.array([1e-7, 1e-7, 0.05])).ravel())
        cfg = tc.barc_mpc_config("iac_car_tracking_mpc", n=n, learning=False,
                                 r=eye3, r_d=eye3, q_vel=20.0, q_boundary=1000.0,
                                 q_contour=50.0, q_heading=20.0, **no_box)
    if free:
        model.n_nl = 0
    track = RacingTrajectory.from_file(track_file, device=device)
    return model, track, RacingMPC(cfg, model, device=device)


def nl_reference(N: int, x_ic, v0: float, v_target: float, dt: float):
    """The horizon of tests/test_nl_constraints.py's ``_mk_input``: the
    abscissae of a speed ramp v0 -> v_target from x_ic, and the speeds."""
    vels = np.linspace(v0, v_target, N)
    s_hor = float(x_ic[0]) + np.cumsum(np.concatenate([[0.0], vels[:-1] * dt]))
    return s_hor, vels


def nl_input(mpc, track, x_ic, v0: float, v_target: float, dt: float):
    """``_mk_input`` of tests/test_nl_constraints.py in the port: the
    centerline reference ramping the speed, on the MPC's device."""
    import torch
    from racing_lmpc_torch.mpc.racing_mpc import REQUIRED_FIELDS, MPCInput
    N, nx, nu, K = mpc.N, mpc.nx, mpc.nu, mpc.K
    s_hor, vels = nl_reference(N, x_ic, v0, v_target, dt)
    X_ref = np.zeros((N, nx), dtype=np.float32)
    X_ref[:, 0] = s_hor
    X_ref[:, mpc.idx_vel] = vels
    dev = mpc.device

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    s_j = f32(s_hor)
    return MPCInput(
        x_ic=f32(x_ic), u_ic=f32(np.zeros(nu)), X_ref=f32(X_ref),
        U_ref=f32(np.zeros((N - 1, nu))), T_ref=f32(np.full(N - 1, dt)),
        bound_left=track.left_boundary(s_j), bound_right=track.right_boundary(s_j),
        total_length=f32(track.total_length), curvatures=track.curvature(s_j),
        vel_ref=f32(vels), ss_x=f32(np.zeros((K, nx))), ss_j=f32(np.zeros(K)))


def dt_corner(track) -> float:
    """The abscissa of Putnam's tightest corner, as the test finds it."""
    s = np.linspace(0, track.total_length, 2000)
    return float(s[np.argmax(np.abs(np.asarray(track.curvature_np(s))))])


def dt_batch_states(s_corner: float) -> np.ndarray:
    """The double-track batch's initial states: the test's state braking into
    the corner, each lane moved by a seeded draw."""
    c = NL_DT_BATCH
    rng = np.random.default_rng(c["seed"])
    B = c["batch"]
    x = np.zeros((B, 6))
    x[:, 0] = s_corner - NL_DT["before_corner"] + rng.uniform(-c["ds"], c["ds"], B)
    x[:, 1] = rng.uniform(-c["dpy"], c["dpy"], B)
    x[:, 5] = rng.uniform(*c["v"], B)
    return x


def model_controller(case: str, device, n: int | None = None):
    """The port's controller and plant of closed-loop case ``case``, as
    tests/test_closed_loop.py builds them for the reference: the model from
    the factory, the tracking config at the case's horizon."""
    from racing_lmpc_torch import config as tc
    from racing_lmpc_torch.control.loop import MPCController
    from racing_lmpc_torch.models import load_vehicle_model
    from racing_lmpc_torch.sim import RacingSimulator
    from racing_lmpc_torch.track import RacingTrajectory
    kind, n_case, dt, _, x0 = MODEL_CTRL_CASES[case]
    n = n or n_case
    name, yaml = {"kinematic": ("kinematic_bicycle_model", "barc_single_track"),
                  "double_track": ("double_track_planar_model", "barc_double_track")}[kind]
    model = load_vehicle_model(name, tc.load_ros_params(
        tc.PARAM_DIR / "barc_base.param.yaml", tc.PARAM_DIR / f"{yaml}.param.yaml"))
    track = RacingTrajectory.from_file(tc.TRACK_DIR / "barc" / "02_barc_center.txt",
                                       device=device)
    r3 = (1e-3, 0, 0, 0, 1e-3, 0, 0, 0, 1.0)
    rd3 = (1e-2, 0, 0, 0, 1e-2, 0, 0, 0, 1.0)
    cfg = tc.barc_mpc_config("barc_tracking_mpc", n=n, learning=False, step_mode="step",
                             r=r3, r_d=rd3, x_max=(), x_min=(), u_max=(), u_min=())
    ctrl = MPCController(cfg, model, track, dt, device=device)
    sim = RacingSimulator(tc.SimulatorConfig(dt=dt, x0=x0), model, track, device=device)
    return ctrl, sim


def nl_qp_sizes() -> dict:
    """The QP sizes n of the nonlinear-row paths, read from the port's
    layout (tracking configs with the soft boundary slack)."""
    from racing_lmpc_torch.mpc.racing_mpc import _Layout
    paths = {"nl_kinematic": (4, NL_KIN["n"], 2), "nl_double_track_sqp": (6, NL_DT["n"], 7),
             "nl_double_track_b256": (6, NL_DT_BATCH["n"], 7)}
    paths.update({case: (4 if kind == "kinematic" else 6, n, 2 if kind == "kinematic" else 7)
                  for case, (kind, n, *_) in MODEL_CTRL_CASES.items()})
    return {case: _Layout(nx=nx, nu=3, N=N, K=0, has_bslack=True, has_hull_slack=False,
                          learning=False, n_nl=n_nl).n
            for case, (nx, N, n_nl) in paths.items()}


# ---------------------------------------------------------------------------
# the double-track LMPC at the shipped learning horizons: the sample
# vehicle's double-track on Putnam-short with the recorded seed laps, its
# QP past the kernel's register variants (n > 240)
# ---------------------------------------------------------------------------

# case -> (param file, horizon N, K, batch, lane seed, config overrides,
# entry point): iac_car_lmpc with the Putnam launch's elastic state boxes
# (launch/runner.py's putnam_short_lmpc), n = 275, through solve_batch; the
# upstream sample_mpc, n = 244, one scenario through _solve_impl as entry()
# calls it; and a cut of the first (N=10, K=16, 4 lanes) that the CPU tests
# solve live in both packages
DT_LMPC_CASES = {
    "dt_lmpc_iac_n60_b32": ("iac_car_lmpc", 60, 96, 32, 21, {"q_state_slack": 2000.0},
                            "solve_batch"),
    "dt_lmpc_sample_n50_b1": ("sample_mpc", 50, 96, 1, 22, {}, "_solve_impl"),
    "dt_lmpc_iac_n10_b4": ("iac_car_lmpc", 10, 16, 4, 23, {"q_state_slack": 2000.0},
                           "solve_batch"),
}
DT_LMPC_DT = 0.1
DT_LMPC_TRACK = ("putnam_short", "08_putnam_short_optm.txt")
DT_LMPC_LAPS = ("putnam_short", 3)
# the double-track's control weights of nl_problem (steering 0.05, the
# forces 1e-7 in N^-2), no control box
DT_LMPC_R = tuple((np.eye(3) * np.array([1e-7, 1e-7, 0.05])).ravel())
# the param files' state vectors are in the single-track's order (s, ey,
# epsi, vx, vy, vyaw); the double-track's is (s, ey, epsi, vyaw, slip, v):
# each entry goes to the state of its name (vy's to the slip angle)
DT_FROM_SINGLE = (0, 1, 2, 5, 4, 3)
DT_LMPC_MOVED = 8
# of those, the moved inputs the card solves again (the first ones; cut to
# keep the script inside its time)
DT_LMPC_REPLAYED = 4
# the cases the card drives against stored reference runs (the N=10 cut is
# the CPU tests' live comparison)
DT_LMPC_FIXTURE_CASES = ("dt_lmpc_iac_n60_b32", "dt_lmpc_sample_n50_b1")
# the double-track batch's floors, but solved lane by lane: a lane may
# differ only as far as the reference's own runs differ
DT_LMPC_FLOORS = {**NL_BATCH_FLOORS, "solved differs": 0}


def dt_lmpc_overrides(cfg, case: str) -> dict:
    """The config overrides of ``case`` on the param file's config ``cfg``:
    the horizon, K, the double-track's weights, no control box, the state
    vectors in the double-track's order and the case's own."""
    _, N, K, _, _, extra, _ = DT_LMPC_CASES[case]

    def reorder(v):
        return tuple(v[i] for i in DT_FROM_SINGLE)
    return dict(n=N, num_ss_pts=K, r=DT_LMPC_R, r_d=DT_LMPC_R, u_min=(), u_max=(),
                x_min=reorder(cfg.x_min), x_max=reorder(cfg.x_max),
                convex_hull_slack=reorder(cfg.convex_hull_slack), **extra)


def dt_lmpc_fields(track, manager, case: str, per_lap: int) -> dict:
    """The lanes of ``case`` as numpy arrays (one per ``MPCInput`` field,
    leading dimension the batch), in the shape of
    ``benchmarks.make_scenario_batch`` at Putnam speeds: s0 uniform over
    the lap, ey0 uniform in +-0.5 m, v0 the raceline's speed at s0 times
    U(0.9, 1.0) and at least 3.5 m/s, the reference at constant speed, the
    track's speed clipped to v0 +- 1 as the speed reference, and the safe
    set queried at the reference's last state (``per_lap`` points a lap at
    most, the config's ``num_ss_pts_per_lap``), its single-track states
    turned into the double-track's (yaw rate, slip = atan2(vy, vx),
    v = hypot(vx, vy), in numpy so that both packages get the same
    numbers).  ``track`` and ``manager`` are either package's: only their
    numpy paths are used."""
    _, N, K, B, seed, _, _ = DT_LMPC_CASES[case]
    nx, nu, idx_vel = 6, 3, 5          # the double-track's state, controls, speed
    rng = np.random.default_rng(seed)
    L = float(track.total_length)
    s0 = rng.uniform(0, L, B)
    ey0 = rng.uniform(-0.5, 0.5, B)
    v0 = np.maximum(np.asarray(track.velocity_np(s0), np.float64)
                    * rng.uniform(0.9, 1.0, B), 3.5)
    s_hor = s0[:, None] + v0[:, None] * DT_LMPC_DT * np.arange(N)[None, :]
    X_ref = np.zeros((B, N, nx), np.float32)
    X_ref[..., 0] = s_hor
    X_ref[..., idx_vel] = v0[:, None]
    x_ic = X_ref[:, 0].copy()
    x_ic[:, 1] = ey0
    vel = np.clip(track.velocity_np(s_hor), v0[:, None] - 1.0, v0[:, None] + 1.0)
    ss_x = np.zeros((B, K, nx), np.float32)
    ss_j = np.zeros((B, K), np.float32)
    for b in range(B):
        sx, sj, _ = manager.query_padded(X_ref[b, -1], K, per_lap)
        sx = np.asarray(sx, np.float64)
        ss_x[b] = np.stack([sx[:, 0], sx[:, 1], sx[:, 2], sx[:, 5],
                            np.arctan2(sx[:, 4], sx[:, 3]), np.hypot(sx[:, 3], sx[:, 4])], -1)
        ss_j[b] = sj
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return {"x_ic": x_ic, "u_ic": np.zeros((B, nu), np.float32), "X_ref": X_ref,
            "U_ref": np.zeros((B, N - 1, nu), np.float32),
            "T_ref": np.full((B, N - 1), DT_LMPC_DT, np.float32),
            "bound_left": f32(track.left_boundary_np(s_hor)),
            "bound_right": f32(track.right_boundary_np(s_hor)),
            "total_length": np.full((B,), L, np.float32),
            "curvatures": f32(track.curvature_np(s_hor)), "vel_ref": f32(vel),
            "ss_x": ss_x, "ss_j": ss_j}


def dt_lmpc_problem(case: str, device):
    """(model, track, mpc, numpy lanes) of ``case`` in the port: the sample
    vehicle's double-track (``sample_vehicle_base`` +
    ``sample_vehicle_double_track``), Putnam-short's raceline, the case's
    param file with ``dt_lmpc_overrides``, and the lanes of
    ``dt_lmpc_fields`` from the three recorded Putnam-short laps.
    tests/torch_port_fixture.py builds the reference's the same way."""
    from racing_lmpc_torch import config as tc
    from racing_lmpc_torch.models import DoubleTrackPlanarModel
    from racing_lmpc_torch.mpc.racing_mpc import RacingMPC
    from racing_lmpc_torch.safeset import SafeSetManager, SafeSetRecorder
    from racing_lmpc_torch.track import RacingTrajectory
    p = tc.load_ros_params(tc.PARAM_DIR / "sample_vehicle_base.param.yaml",
                           tc.PARAM_DIR / "sample_vehicle_double_track.param.yaml")
    model = DoubleTrackPlanarModel(tc.vehicle_config_from_params(p),
                                   tc.double_track_config_from_params(p))
    track = RacingTrajectory.from_file(tc.TRACK_DIR.joinpath(*DT_LMPC_TRACK), device=device)
    name = DT_LMPC_CASES[case][0]
    cfg = tc.barc_mpc_config(name, **dt_lmpc_overrides(tc.barc_mpc_config(name), case))
    mpc = RacingMPC(cfg, model, device=device)
    lap_dir, laps = DT_LMPC_LAPS
    manager = SafeSetManager(laps, nx=6)
    SafeSetRecorder(manager).load([str(tc.SS_DIR / lap_dir / f"ss_lap_{i}")
                                   for i in range(1, laps + 1)], track.total_length)
    return model, track, mpc, dt_lmpc_fields(track, manager, case,
                                             cfg.num_ss_pts_per_lap)


def load_fixture(case: str) -> dict:
    with np.load(FIXTURE_DIR / f"{case}.npz") as z:
        return {k: z[k] for k in z.files}


def fixture_input(fx, like, device):
    """The fixture's stored input as an ``MPCInput`` on ``device``, after
    checking that the port's own construction ``like`` gives the same
    numbers (the track's splines evaluated in f32 by each package)."""
    import torch
    from racing_lmpc_torch.mpc.racing_mpc import REQUIRED_FIELDS, MPCInput
    fields = {}
    for name in REQUIRED_FIELDS:
        got, want = getattr(like, name).cpu().numpy(), fx[f"inp_{name}"]
        check(got.shape == want.shape and np.allclose(got, want, rtol=1e-5, atol=1e-5),
              f"input {name} differs from the fixture's")
        fields[name] = torch.as_tensor(want, device=device)
    return MPCInput(**fields)


def sqp_reading(a: dict, b: dict, su, sx) -> dict:
    """How far SQP plan ``a`` (``U``, ``X``) lies from plan ``b``: the max
    |dU| / scale_u of the longitudinal controls and of the steering, and the
    max |dX| / scale_x."""
    dU = np.abs(a["U"] - b["U"]) / su
    return {"U lon max": float(dU[..., :-1].max()), "U steer max": float(dU[..., -1].max()),
            "X max": float((np.abs(a["X"] - b["X"]) / sx).max())}


def pair_limits(runs: list[dict], reading, floors: dict) -> dict:
    """Each gate's limit: the reference's worst reading between any two of
    its stored runs, or the gate's floor where that is looser."""
    got = [reading(a, b) for i, a in enumerate(runs) for j, b in enumerate(runs) if i != j]
    return {k: max(floor, *(g[k] for g in got)) for k, floor in floors.items()}


def drive_nl_sqp(device, case: str) -> dict:
    """A batch-1 ``solve_sqp`` of a nonlinear-row scenario (``nl_kinematic``:
    tests/test_nl_constraints.py:63-110; ``nl_double_track_sqp``: :113-163),
    the launch counts set to 0 just before and read just after.  Held to
    the test's gates, its runs on the fixture's moved inputs held to the
    reference's spread, and the same scenario without the constraint rows
    must break the gate (the rows are load-bearing).  Returns the
    launches."""
    import torch
    fx = load_fixture(case)
    kind = "kinematic" if case == "nl_kinematic" else "double_track"
    c = NL_KIN if kind == "kinematic" else NL_DT
    model, track, mpc = nl_problem(kind, c["n"], device)
    check(mpc.layout.n_nl == model.n_nl == (2 if kind == "kinematic" else 7),
          f"{case}: {mpc.layout.n_nl} nonlinear rows a stage")
    if kind == "kinematic":
        x_ic = c["x_ic"]
    else:
        s_corner = dt_corner(track)
        check(abs(s_corner - float(fx["s_corner"])) < 1e-6, f"{case}: another corner")
        x_ic = (s_corner - c["before_corner"], 0.0, 0.0, 0.0, 0.0, c["v0"])
    inp = fixture_input(fx, nl_input(mpc, track, x_ic, c["v0"], c["v_target"], c["dt"]), device)

    def gate_value(m, out):
        X, U = out.X_optm, out.U_optm
        if kind == "kinematic":
            return float((X[:-1, 3] * U[:, 0]).max())
        return float(m.friction_ellipse(X[:-1], U).max())

    zero_launches()
    t = time.perf_counter()
    out, _ = mpc.solve_sqp(inp, iters=c["sqp_iters"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    launches = read_launches()
    check(launches["chol_tri_inv"] > 0 and launches["gj_inverse"] == 0,
          f"{case}: launches {launches}")
    for name in ("X_optm", "U_optm", "obj"):
        check(bool(torch.isfinite(getattr(out, name)).all()), f"{case}: {name} not finite")
    value = gate_value(model, out)
    if kind == "kinematic":
        p_max = model.config.p_max
        excl = float((out.U_optm[:, 0] * out.U_optm[:, 1]).abs().max())
        print(f"path {case}: solve_sqp({c['sqp_iters']}) {ms:.1f} ms, launches {launches}; "
              f"power max {value:.4f} W (gate {1.03 * p_max:.4f}), |fd fb| max {excl:.3e} "
              f"(gate 1.1)", flush=True)
        check(value <= p_max * 1.03 + 1e-6 and excl <= 1.1, f"{case}: the power rows do not hold")
    else:
        v_min = float(out.X_optm[:, 5].min())
        print(f"path {case}: solve_sqp({c['sqp_iters']}) {ms:.1f} ms, launches {launches}; "
              f"friction ellipse max {value:.4f} (gate 0.05), v min {v_min:.3f}", flush=True)
        check(value <= 0.05 and v_min >= -1e-3, f"{case}: the ellipse rows do not hold")

    # the port's runs on the reference's inputs against its runs on the same
    def as_plan(o):
        return {"U": o.U_optm.double().cpu().numpy(), "X": o.X_optm.double().cpu().numpy()}
    port = [as_plan(out)] + [as_plan(mpc.solve_sqp(moved(inp, s), iters=c["sqp_iters"])[0])
                             for s in range(NL_REPLAYED)]
    ref = [{"U": U.astype(np.float64), "X": X.astype(np.float64)}
           for U, X in zip(fx["U_runs"], fx["X_runs"])]
    su, sx = fx["scale_u"], fx["scale_x"]
    limits = pair_limits(ref, lambda a, b: sqp_reading(a, b, su, sx), NL_SQP_FLOORS)
    print(f"{case} vs reference, {len(port)} runs on the reference's inputs:", flush=True)
    failed = held([sqp_reading(p, q, su, sx) for p, q in zip(port, ref)], limits)
    check(not failed, f"{case}: outside the reference's own spread on {failed}")

    free_model, _, free_mpc = nl_problem(kind, c["n"], device, free=True)
    free, _ = free_mpc.solve_sqp(inp, iters=c.get("free_iters", c["sqp_iters"]))
    free_value = gate_value(free_model, free)
    bar = 1.1 * model.config.p_max if kind == "kinematic" else 0.05
    print(f"  {case} without the constraint rows: {free_value:.4f} > {bar:.4f} "
          f"(the reference's: {'power' if kind == 'kinematic' else 'ellipse'} "
          f"{float((fx['X_free'][:-1, 3] * fx['U_free'][:, 0]).max()) if kind == 'kinematic' else float(fx['ell_free']):.4f})",
          flush=True)
    check(free_value > bar, f"{case}: the scenario does not exercise its constraint rows")
    return launches


def nl_batch_reading(a: dict, b: dict, su) -> dict:
    """How far batch run ``a`` (``U``, ``obj``, ``solved``, ``ell``) lies from
    run ``b``: lanes whose ``solved`` differs, and over the lanes both
    solved the max |dU| / scale_u of the longitudinal controls,
    percentiles of the steering's, the max relative objective difference
    and the max friction-ellipse difference."""
    both = a["solved"] & b["solved"]
    dU = (np.abs(a["U"] - b["U"]) / su)[both]
    steer = dU[..., -1].max(-1) if len(dU) else np.zeros(1)
    return {"solved differs": int((a["solved"] != b["solved"]).sum()),
            "lon max": float(dU[..., :-1].max(initial=0.0)),
            "steer p50": float(np.percentile(steer, 50)),
            "steer p90": float(np.percentile(steer, 90)),
            "objective max": float((np.abs(a["obj"] - b["obj"])[both]
                                    / np.maximum(np.abs(b["obj"][both]), 1.0)).max(initial=0.0)),
            "ellipse max": float(np.abs(a["ell"] - b["ell"])[both].max(initial=0.0))}


def drive_nl_batch(device, case: str = "nl_double_track_b256") -> dict:
    """The double-track braking scenario as a batch of lanes through
    ``solve_batch`` (N=20), the launch counts set to 0 just before and read
    just after: ``solved`` lane by lane, the controls, objective and
    friction-ellipse residual held to the reference's spread over its 9
    stored runs (the median over the port's 9 runs on the same inputs).
    Returns the launches."""
    import torch
    from racing_lmpc_torch.mpc.racing_mpc import REQUIRED_FIELDS, MPCInput
    fx = load_fixture(case)
    c = NL_DT_BATCH
    model, track, mpc = nl_problem("double_track", c["n"], device)
    s_corner = dt_corner(track)
    check(abs(s_corner - float(fx["s_corner"])) < 1e-6, f"{case}: another corner")
    lanes = [nl_input(mpc, track, x, x[5], NL_DT["v_target"], NL_DT["dt"])
             for x in dt_batch_states(s_corner)]
    inp = fixture_input(fx, MPCInput(**{f: torch.stack([getattr(a, f) for a in lanes]) for f in REQUIRED_FIELDS}), device)
    B = c["batch"]

    def as_run(out):
        X, U = out.X_optm, out.U_optm
        ell = model.friction_ellipse(X[:, :-1], U).amax(dim=(-2, -1))
        return {"U": U.double().cpu().numpy(), "obj": out.obj.double().cpu().numpy(),
                "solved": out.solved.cpu().numpy(), "ell": ell.double().cpu().numpy()}

    zero_launches()
    out, _ = mpc.solve_batch(inp)
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"path {case}: launches {launches}", flush=True)
    check(0 < launches["chol_tri_inv"] <= 150 and launches["gj_inverse"] == 0,
          f"{case}: launches {launches}")
    for name in ("X_optm", "U_optm", "dU_optm", "obj"):
        check(bool(torch.isfinite(getattr(out, name)).all()), f"{case}: {name} not finite")
    port = [as_run(out)] + [as_run(mpc.solve_batch(moved(inp, s))[0])
                            for s in range(NL_BATCH_MOVED)]
    ref = dt_lmpc_reference_runs(fx)
    su = fx["scale_u"]
    for b in np.flatnonzero(port[0]["solved"] != ref[0]["solved"]):
        print(f"  lane {b}: port solved={bool(port[0]['solved'][b])} "
              f"rp_rel={float(out.rp_rel[b]):.3e} rd_rel={float(out.rd_rel[b]):.3e}; reference "
              f"r_prim={float(fx['r_prim'][b]):.3e} r_dual={float(fx['r_dual'][b]):.3e}", flush=True)
    print(f"{case} vs reference, {len(port)} runs on the reference's inputs: solved "
          f"{[int(r['solved'].sum()) for r in port]} of {B} (reference "
          f"{[int(r['solved'].sum()) for r in ref]}); friction ellipse max over solved lanes "
          f"{float(port[0]['ell'][port[0]['solved']].max()):.4f} (reference "
          f"{float(ref[0]['ell'][ref[0]['solved']].max()):.4f})", flush=True)
    limits = pair_limits(ref, lambda a, b: nl_batch_reading(a, b, su), NL_BATCH_FLOORS)
    failed = held([nl_batch_reading(p, q, su) for p, q in zip(port, ref)], limits)
    check(not failed, f"{case}: outside the reference's own spread on {failed}")
    ms = cuda_time_ms(lambda: mpc.solve_batch(inp), reps=3, warmup=1)
    print(f"path {case}: {ms:.1f} ms per batch, {B / (ms / 1e3):.1f} solves/s", flush=True)
    profile(lambda: mpc.solve_batch(inp), ms, f"{case} solve")
    return launches


def dt_lmpc_solver(mpc, entry: str):
    """The port's solve of a double-track LMPC batch through ``entry``:
    ``solve_batch``, or ``_solve_impl`` on each lane alone with a zero warm
    start and its flag set, as ``entry()`` calls it."""
    import torch
    from racing_lmpc_torch.mpc.racing_mpc import MPCOutput, map_input

    def solve(inp):
        if entry == "solve_batch":
            return mpc.solve_batch(inp)[0]
        z = torch.zeros((1, mpc.layout.n), dtype=torch.float32, device=mpc.device)
        valid = torch.ones((1,), dtype=torch.bool, device=mpc.device)
        outs = [mpc._solve_impl(map_input(lambda a: a[b:b + 1], inp), z, valid)[0]
                for b in range(inp.x_ic.shape[0])]
        return MPCOutput(*(torch.cat(a) for a in zip(*outs)))
    return solve


def dt_lmpc_run(model, out) -> dict:
    """A run's readings: the controls, objective and ``solved`` of each
    lane, and its largest friction-ellipse residual over the stages."""
    ell = model.friction_ellipse(out.X_optm[:, :-1], out.U_optm).amax(dim=(-2, -1))
    return {"U": out.U_optm.double().cpu().numpy(), "obj": out.obj.double().cpu().numpy(),
            "solved": out.solved.cpu().numpy(), "ell": ell.double().cpu().numpy()}


def dt_lmpc_reference_runs(fx, lanes=slice(None)) -> list[dict]:
    """The reference's stored runs of a double-track LMPC fixture (the
    lanes ``lanes``), as ``dt_lmpc_run`` reads the port's."""
    return [{"U": U[lanes].astype(np.float64), "obj": o[lanes].astype(np.float64),
             "solved": sv[lanes], "ell": e[lanes].astype(np.float64)}
            for U, o, sv, e in zip(fx["U_runs"], fx["obj_runs"], fx["solved_runs"],
                                   fx["ell_runs"])]


def drive_dt_lmpc(device, case: str) -> dict:
    """The double-track LMPC at a shipped learning horizon (``DT_LMPC_CASES``:
    n = 275 through ``solve_batch``, n = 244 through ``_solve_impl``), its
    QP past the kernel's register variants: the launch counts set to 0 just
    before one solve of the reference's lanes and read just after (1 to 150
    ``chol_tri_inv`` launches a solve, none of ``gj_inverse``), finite
    outputs, then ``solved`` lane by lane and the controls, objective and
    friction-ellipse residual held to the reference's spread over its 9
    stored runs (the median over the port's runs on the first
    1 + ``DT_LMPC_REPLAYED`` of the same inputs); one
    more solve profiled (device busy, idle share, ``chol_tri_inv``'s share of
    busy).  Returns the launches."""
    import torch
    from racing_lmpc_torch.mpc.racing_mpc import MPCInput
    fx = load_fixture(case)
    entry = DT_LMPC_CASES[case][-1]
    model, _, mpc, fields = dt_lmpc_problem(case, device)
    n, m = mpc.layout.n, mpc.layout.m
    check((n, m) == (int(fx["n"]), int(fx["m"])), f"{case}: QP {n}x{m}, the reference's "
          f"{int(fx['n'])}x{int(fx['m'])}")
    inp = fixture_input(fx, MPCInput(**{k: torch.as_tensor(v, device=device)
                                        for k, v in fields.items()}), device)
    B = inp.x_ic.shape[0]
    solves = B if entry == "_solve_impl" else 1
    solve = dt_lmpc_solver(mpc, entry)

    zero_launches()
    t = time.perf_counter()
    out = solve(inp)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    launches = read_launches()
    print(f"path {case} (n={n}, m={m}, batch {B}, {entry}): launches {launches}, "
          f"{launches['chol_tri_inv'] / solves:.1f} chol_tri_inv a solve", flush=True)
    check(0 < launches["chol_tri_inv"] <= 150 * solves and launches["gj_inverse"] == 0,
          f"{case}: launches {launches}")
    for name in ("X_optm", "U_optm", "dU_optm", "obj"):
        check(bool(torch.isfinite(getattr(out, name)).all()), f"{case}: {name} not finite")
    port, secs = [dt_lmpc_run(model, out)], [first_s]
    for s in range(DT_LMPC_REPLAYED):
        t = time.perf_counter()
        port.append(dt_lmpc_run(model, solve(moved(inp, s))))
        secs.append(time.perf_counter() - t)
    ref = dt_lmpc_reference_runs(fx)
    su = fx["scale_u"]
    for b in np.flatnonzero(port[0]["solved"] != ref[0]["solved"]):
        print(f"  lane {b}: port solved={bool(port[0]['solved'][b])} "
              f"rp_rel={float(out.rp_rel[b]):.3e} rd_rel={float(out.rd_rel[b]):.3e}; reference "
              f"r_prim={float(fx['r_prim'][b]):.3e} r_dual={float(fx['r_dual'][b]):.3e}", flush=True)
    print(f"{case} vs reference, {len(port)} runs on the reference's inputs: solved "
          f"{[int(r['solved'].sum()) for r in port]} of {B} (reference "
          f"{[int(r['solved'].sum()) for r in ref]}); {float(np.median(secs)):.2f} s a run "
          f"(median; the first {first_s:.2f} s)", flush=True)
    profile(lambda: solve(inp), float(np.median(secs[1:])) * 1e3, f"{case} solve")
    limits = pair_limits(ref, lambda a, b: nl_batch_reading(a, b, su), DT_LMPC_FLOORS)
    failed = held([nl_batch_reading(p, q, su) for p, q in zip(port, ref)], limits)
    check(not failed, f"{case}: outside the reference's own spread on {failed}")
    return launches


def drive_model_controller(device, case: str) -> tuple[dict, float, float, tuple]:
    """The closed loop of a nonlinear-row model (tests/test_closed_loop.py:
    145-219) for the cycles of ``MODEL_CTRL_CASES``: the port's controller
    and plant, the launch counts set to 0 just before and read just after,
    held to the test's gates (its final-speed gate scaled by the
    reference's own first run at this depth, where the card drives fewer
    cycles than the test); a profiled cycle.  Returns the launches, the
    median cycle ms, the idle share of the profiled cycle and the path's
    ``MODEL_CTRL_REPLAYS`` teacher-forced runs for ``settle_replays``, held
    to the reference's own spread."""
    import torch
    full = load_fixture(case)
    fx = ctrl_fixture(case)
    cycles = fx["x_ctrl"].shape[1] - 1
    check(cycles == MODEL_CTRL_DEPTH[case], f"{case}: fixture has fewer cycles")
    ctrl, sim = model_controller(case, device, n=int(fx["n"]))
    vel = ctrl.mpc.idx_vel
    zero_launches()
    t = time.perf_counter()
    info = ctrl.step(sim.x)
    boot_ms = (time.perf_counter() - t) * 1e3
    fallbacks, lat, ms = 0, [], []
    for _ in range(cycles):
        sim.step(info.u_base)
        t = time.perf_counter()
        info = ctrl.step(sim.x, u_ic=info.u_apply)
        fallbacks += int(bool(info.used_fallback))
        ms.append((time.perf_counter() - t) * 1e3)
        lat.append(abs(float(sim.x[1])))
    launches = read_launches()
    check(launches["chol_tri_inv"] > 0 and launches["gj_inverse"] == 0,
          f"{case}: launches {launches}")
    check(bool(torch.isfinite(sim.x).all()), f"{case}: plant state not finite")
    g = MODEL_CTRL_GATES
    speed = float(sim.x[vel])
    ref_speed = fx["x_plant"][:, -1, vel]
    speed_gate = g["speed"] * float(ref_speed[0] / full["x_plant"][0, -1, vel])
    cycle_ms = float(np.median(ms))
    print(f"path {case}: {cycles} cycles (N={int(fx['n'])}; the test drives "
          f"{full['x_ctrl'].shape[1] - 1}), launches {launches} "
          f"({launches['chol_tri_inv'] / (cycles + 1):.1f} chol_tri_inv per cycle); fallbacks "
          f"{fallbacks} (gate {g['fallbacks']}, reference {fx['used_fallback'].sum(-1).tolist()}); "
          f"max |lateral| {max(lat):.4f} (gate {g['lat']}, reference "
          f"{np.round(np.abs(fx['x_plant'][..., 1]).max(-1), 4).tolist()}); final speed "
          f"{speed:.4f} (gate > {speed_gate:.4f}, reference {np.round(ref_speed, 4).tolist()}); "
          f"cycle wall ms: first (bootstrap) {boot_ms:.1f}, median after {cycle_ms:.1f} "
          f"(min {min(ms):.1f}, max {max(ms):.1f})", flush=True)
    check(fallbacks <= g["fallbacks"] and max(lat) < g["lat"] and speed > speed_gate,
          f"{case}: outside the closed-loop gates")
    idle = profile(lambda: ctrl.step(sim.x, u_ic=info.u_apply), cycle_ms, f"{case} one cycle")

    def held_replays(port):
        failed = held_ctrl(port, fx, ctrl_limits(fx), f"{case} vs reference")
        check(not failed, f"{case}: outside the reference's own spread on {failed}")
    return launches, cycle_ms, idle, (case, MODEL_CTRL_REPLAYS, held_replays)


# the bus phase: cycles of BusCoSimulation of the barc_lmpc scenario at its
# shipped widths, compared with the first cycles of the CoSimulation path;
# then one cycle timed on the main thread and on the bus's thread in turns
BUS_CYCLES = 5
BUS_TURNS = 2
# the LU phase: seeded QPs through solve_qp_ip without eq_rows, on the card
# against the CPU, each gate's limit the CPU's own worst reading between its
# runs on the batch and LU_MOVED copies with q moved by one f32 rounding, or
# the gate's floor where that is looser
LU_QPS = (16, 12, 20, 4)          # batch, n, m, equality rows
LU_MOVED = 8
LU_FLOORS = {"x": 5e-4, "objective": 1e-5}


def build_native_async():
    """Start building the native host runtime from its source with g++, on
    a thread beside the kernels' nvcc builds; the returned function waits
    for it, raises if it failed, and returns its seconds (None when the
    library was already built)."""
    import threading
    from racing_lmpc_torch import native
    fresh = not native.library_path().exists()
    done = {}

    def run():
        t = time.perf_counter()
        native.available()
        done["s"] = time.perf_counter() - t

    th = threading.Thread(target=run)
    th.start()

    def wait():
        th.join()
        check(native.available(), f"native runtime: {native.build_error()}")
        return done["s"] if fresh else None
    return wait


def numbers_of(d) -> list[float]:
    """Every number of a nested dict of the bench's line (flags left out)."""
    out = []
    for v in d.values():
        if isinstance(v, dict):
            out += numbers_of(v)
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            out.append(float(v))
    return out


def drive_bench(device) -> dict:
    """The port's bench (``racing_lmpc_torch.bench.run``) at
    ``BENCH_SMOKE``, with every launch count set to 0 just before and read
    just after; its line printed as the bench prints it, and held: every
    number finite, ``mfu_vs_f32_peak`` in (0, 1], the b256 and N=40
    batches' solved lanes as near the stored reference runs as the batched
    gates allow, and in every launch scenario finite objectives and
    ``chol_tri_inv`` launched every cycle.  The
    chains start from the card's own bootstrap, which no reference run
    shares, so their fallbacks are printed, not held: one f32 rounding of
    a cycle's input can flip its ``solved`` flag, in the reference too
    (``tests/torch_port_rti_fallback.py``); they are held on the chains
    started from the reference's own states (``bench_rt_replays``)."""
    import torch
    from racing_lmpc_torch import bench
    t0 = time.perf_counter()
    zero_launches()
    result, detail = bench.run(device, **BENCH_SMOKE)
    torch.cuda.synchronize()
    launches = read_launches()
    print(json.dumps(result), flush=True)
    extra = result["extra"]
    check(all(np.isfinite(numbers_of(result))), "bench: a number is not finite")
    check(0.0 < extra["mfu_vs_f32_peak"] <= 1.0,
          f"bench: mfu_vs_f32_peak {extra['mfu_vs_f32_peak']} not in (0, 1]")
    for case, key in (("barc_n20_k48_b256", "solved_b256"), ("barc_n40_k96_b128", "solved_n40")):
        fx = load_batch_fixture(case)
        differs = int((detail[key] != fx["solved"]).sum())
        allowed = gate_limits(fx)["solved differs"]
        print(f"bench {case}: solved {int(detail[key].sum())} of {len(fx['solved'])}, "
              f"{differs} lanes differ from the reference run (allowed {allowed:g})", flush=True)
        check(differs <= allowed, f"bench {case}: {differs} solved lanes differ")
    for name, d in detail["shipped"].items():
        check(bool(np.isfinite(d["obj"]).all()), f"bench {name}: objective not finite")
        check(d["chol_tri_inv_per_cycle"] > 0, f"bench {name}: chol_tri_inv not launched")
    check(launches["chol_tri_inv"] > 0 and launches["gj_inverse"] == 0,
          f"bench: launches {launches}")
    print(f"path bench: launches {launches}, {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def bench_rt_start(fx, c: int, r: int) -> dict:
    """The start of cycle ``c`` of the reference's teacher-forced run ``r``
    of the bench's controller chain (``bench_rt_<scenario>.npz``): run 0
    as stored, run r > 0 with ``last_X`` and ``x0`` moved by 1 + 2e-7 N(0,
    1) from numpy seed r, each cycle's two moves drawn in turn, as
    tests/torch_port_fixture.py::compute_bench_rt drew them."""
    st = {k: fx[f"tf_state_{k}"][c] for k in ("last_X", "last_U", "last_dU", "lam")}
    x0 = fx["tf_x0"][c]
    if r:
        rng = np.random.default_rng(r)
        for _ in range(c + 1):          # the earlier cycles' draws, then c's
            n_X, n_x0 = rng.standard_normal(st["last_X"].shape), rng.standard_normal(x0.shape)
        st["last_X"] = (st["last_X"] * (1 + 2e-7 * n_X)).astype(np.float32)
        x0 = (x0 * (1 + 2e-7 * n_x0)).astype(np.float32)
    return {**st, "x0": x0, "u0": fx["tf_u0"][c]}


def bench_rt_replay(scenario: str, r: int, device) -> dict:
    """``bench.rt_chain`` of a fresh port controller of ``scenario``, each
    cycle one step from the start of that cycle in the reference's
    teacher-forced run ``r`` (``bench_rt_start``), with its safe set, speed
    limit and scale: each cycle's fallback, objective and controls."""
    import torch
    from racing_lmpc_torch import bench
    from racing_lmpc_torch.control.loop import ControllerState
    from racing_lmpc_torch.launch.runner import _SCENARIOS, CoSimulation
    fx = load_fixture(f"bench_rt_{scenario}")
    ctrl = CoSimulation(_SCENARIOS[scenario], device=device).controller
    ctrl.speed_limit, ctrl.speed_scale = float(fx["speed_limit"]), float(fx["speed_scale"])

    def dev(a):
        return torch.as_tensor(a, device=device)
    infos = []
    for c in range(len(fx["tf_obj"])):
        start = bench_rt_start(fx, c, r)
        state = ControllerState(*(dev(start[k]) for k in ControllerState._fields))
        infos += bench.rt_chain(ctrl, state, dev(start["x0"]), dev(start["u0"]),
                                dev(fx["ss_x"]), dev(fx["ss_j"]), 1)[1]
    return {"used_fallback": np.array([bool(i.used_fallback) for i in infos]),
            "obj": np.array([float(i.output.obj) for i in infos]),
            "U": np.stack([i.output.U_optm.cpu().numpy() for i in infos])}


def bench_rt_runs(fx) -> list[dict]:
    """The reference's teacher-forced runs of the bench's chain: the run
    itself, then its runs from starts moved by one f32 rounding."""
    return [{"used_fallback": fx["tf_used_fallback"], "obj": fx["tf_obj"],
             "U": fx["tf_U_optm"]}] + [
        {"used_fallback": f, "obj": o, "U": U} for f, o, U in
        zip(fx["tf_used_fallback_pert"], fx["tf_obj_pert"], fx["tf_U_optm_pert"])]


def rt_reading(a: dict, b: dict, su: np.ndarray) -> np.ndarray:
    """How far run ``a`` of the bench's chain lies from run ``b``, cycle by
    cycle: a fallback where ``b`` solved, the objective's gap (relative),
    and the largest gaps of the longitudinal and the steering control (over
    ``scale_u``), (cycles, 4)."""
    dU = np.abs(np.asarray(a["U"], np.float64) - b["U"]) / su
    return np.stack([(a["used_fallback"] & ~b["used_fallback"]).astype(np.float64),
                     np.abs(np.asarray(a["obj"], np.float64) - b["obj"])
                     / np.maximum(np.abs(b["obj"]), 1e-12),
                     dU[..., 0].max(-1), dU[..., -1].max(-1)], axis=-1)


def bench_rt_replays() -> list[tuple]:
    """The pending replays (``settle_replays``) of the bench's controller
    chain in every launch scenario: each of the reference's teacher-forced
    runs replayed, every cycle from that run's own start of it.  Held cycle
    by cycle as the controller gates hold theirs: every objective finite,
    and the median over the runs of each reading (``rt_reading`` of the
    port's run r against the reference's run r) within ``RT_FLOORS`` or the
    reference's worst reading between two of its own runs, where that is
    wider."""
    def holder(scenario):
        def held(results):
            fx = load_fixture(f"bench_rt_{scenario}")
            refs, su = bench_rt_runs(fx), fx["scale_u"]
            check(all(np.isfinite(r["obj"]).all() for r in results),
                  f"bench_rt {scenario}: objective not finite")
            got = np.median([rt_reading(p, q, su) for p, q in zip(results, refs)], axis=0)
            limit = np.max([np.maximum(rt_reading(p, q, su), RT_FLOORS)
                            for i, p in enumerate(refs) for j, q in enumerate(refs)
                            if i != j], axis=0)
            print(f"bench_rt {scenario} vs reference, {len(results)} runs each cycle from "
                  f"the reference's start: fallbacks {[r['used_fallback'].tolist() for r in results]}"
                  f" (reference {[r['used_fallback'].tolist() for r in refs]}); median "
                  f"fallback where reference solved, objective, lon, steer gaps by cycle "
                  f"{np.round(got, 7).tolist()}, limits {np.round(limit, 7).tolist()}",
                  flush=True)
            check(not got[:, 0].any(), f"bench_rt {scenario}: fallback where the reference solved")
            check(bool((got <= limit).all()), f"bench_rt {scenario}: a gap over its limit")
        return held
    return [(f"bench_rt_{scenario}", 1 + len(load_fixture(f"bench_rt_{scenario}")["tf_obj_pert"]),
             holder(scenario)) for scenario in BENCH_RT_SCENARIOS]


def drive_native(build_s: float | None) -> None:
    """The native host runtime, built at set-up (``build_native_async``):
    its table loader against ``np.loadtxt`` on the BARC track; its KD-tree's
    projection seeds against the brute-force ones on the track's waypoints
    and on seeded points between them."""
    from racing_lmpc_torch import native
    from racing_lmpc_torch.config import TRACK_DIR
    from racing_lmpc_torch.track import RacingTrajectory
    path = TRACK_DIR / "barc" / "02_barc_center.txt"
    table = native.load_table(path)
    check(np.array_equal(table, np.loadtxt(path)), "native table loader differs from np.loadtxt")
    track = RacingTrajectory(table, device="cpu")
    brute = RacingTrajectory(table, device="cpu", use_native=False)
    rng = np.random.default_rng(0)
    wp = track._wp_xy_np
    between = wp + rng.uniform(0.05, 0.95, (len(wp), 1)) * (np.roll(wp, -1, 0) - wp) \
        + rng.normal(size=wp.shape) * 0.05
    q = np.concatenate([wp, between])
    got, want = track.nearest_waypoint_abscissa_np(q), brute.nearest_waypoint_abscissa_np(q)
    check(np.array_equal(got, want),
          f"KD-tree seeds differ from brute force at {np.flatnonzero(got != want)}")
    built = (f"built with {native.CXX} in {build_s:.1f} s" if build_s is not None
             else "found built")
    print(f"native runtime: {built} ({native.library_path().name}); table {table.shape} "
          f"equals np.loadtxt; KD-tree seeds equal brute force on {len(wp)} waypoints and "
          f"{len(between)} points between", flush=True)


def drive_bus(device, cosim_acts: np.ndarray, cosim_ms: float) -> dict:
    """``BusCoSimulation`` of ``barc_lmpc`` at its shipped widths, the
    controller cycle running on the bus's dispatch thread: ``BUS_CYCLES``
    cycles with the launch counts set to 0 just before and read just after,
    held to the barc_lmpc path's closed-loop gates (on the track every
    cycle; no more fallbacks than the reference's runs allow over these
    cycles), its actuations beside the first cycles of the script's own
    ``CoSimulation`` run, its cycle time beside that run's; then
    ``bus_thread_turns``."""
    import struct
    import torch
    from racing_lmpc_torch.launch.runner import _SCENARIOS, BusCoSimulation
    sim = BusCoSimulation(_SCENARIOS["barc_lmpc"], device=device)
    cs = sim.cs
    plant, acts = [], []
    sim.bus.subscribe("vehicle_actuation", lambda t, p: acts.append(
        struct.unpack(BusCoSimulation.ACT_FMT, p)[1:]))
    plant_cycle = cs.plant_cycle

    def recording_plant(act):
        msg = plant_cycle(act)
        plant.append((msg.p.s, msg.p.x_tran))
        return msg
    cs.plant_cycle = recording_plant
    zero_launches()
    try:
        summary = sim.run(BUS_CYCLES, timeout_s=600.0)
        torch.cuda.synchronize()
        launches = read_launches()
        sim.bus.flush()
        turns = bus_thread_turns(sim)
    finally:
        sim.close()
    check(summary["steps"] == BUS_CYCLES, f"bus: {summary['steps']} cycles")
    check(launches["chol_tri_inv"] > 0, "bus: chol_tri_inv never launched")
    check(launches["gj_inverse"] == 0, "bus: gj_inverse launched on the path")
    for i, t in enumerate(cs.telemetry):
        check(np.isfinite(t.control).all() and np.isfinite(t.cost), f"bus: cycle {i} not finite")
    s, x_tran = (np.asarray(v) for v in zip(*plant))
    inside = (x_tran <= cs.track.left_boundary_np(s)) & (x_tran >= cs.track.right_boundary_np(s))
    check(bool(inside.all()), f"bus: off the track at cycles {np.flatnonzero(~inside)}")
    fx = ctrl_fixture("ctrl_barc_lmpc")
    ref_fb = fx["used_fallback"][:, :BUS_CYCLES].sum(axis=1)
    allowed = int(ref_fb[0] + ref_fb.max() - ref_fb.min())
    fallbacks = sum(not t.solved for t in cs.telemetry)
    check(fallbacks <= allowed, f"bus: {fallbacks} fallbacks, reference allows {allowed}")
    acts = np.asarray(acts)
    d = np.abs(acts - cosim_acts[:BUS_CYCLES]).max(axis=0)
    ms = np.array([t.solve_time * 1e3 for t in cs.telemetry])
    print(f"path bus_barc_lmpc: {BUS_CYCLES} cycles over the native bus "
          f"({summary['bus_messages']} messages), launches {launches} "
          f"({launches['chol_tri_inv'] / BUS_CYCLES:.1f} chol_tri_inv per cycle); fallbacks "
          f"{fallbacks} (allowed {allowed}); on the track every cycle; max |du_a| {d[0]:.3e}, "
          f"max |du_steer| {d[1]:.3e} from the CoSimulation run's first {BUS_CYCLES} cycles; "
          f"cycle wall ms: first (bootstrap) {ms[0]:.1f}, median after "
          f"{np.median(ms[1:]):.1f} (the CoSimulation path's: {cosim_ms:.1f})",
          flush=True)
    print(f"  one controller cycle in turns, {BUS_TURNS} times on each thread: median "
          f"{np.median(turns['main']):.1f} ms on the main thread, "
          f"{np.median(turns['bus']):.1f} ms on the bus's thread "
          f"({ {k: np.round(v, 1).tolist() for k, v in turns.items()} })", flush=True)
    return launches


def bus_thread_turns(sim) -> dict:
    """The same controller cycle (the bus run's last state, with the
    controller's state put back before each) timed on the main thread and
    on the bus's dispatch thread, ``BUS_TURNS`` times each in turns, after
    one warm-up on each: whether the thread the cycle runs on costs time.
    Returns the ms of each turn by thread."""
    import threading
    cs = sim.cs
    ctrl = cs.controller
    state, u0 = ctrl.state, cs._u_prev.copy()
    msg = cs.vehicle_state_msg()
    x = np.asarray([msg.p.s, msg.p.x_tran, msg.p.e_psi, msg.v.v_long, msg.v.v_tran,
                    msg.w.w_psi], dtype=np.float32)

    def cycle():
        ctrl.state = state
        t = time.perf_counter()
        ctrl.step(x, u_ic=u0).u_apply.cpu()
        return (time.perf_counter() - t) * 1e3

    done, out = threading.Event(), []

    def on_turn(topic, payload):
        try:
            out.append(cycle())
        except BaseException as e:     # re-raised on the driving thread
            out.append(e)
        done.set()
    sim.bus.subscribe("turn", on_turn)

    def on_bus():
        done.clear()
        sim.bus.publish("turn", b"")
        check(done.wait(300.0), "bus: a timed turn did not come back")
        got = out.pop()
        if isinstance(got, BaseException):
            raise got
        return got

    cycle()
    on_bus()
    turns = {"main": [], "bus": []}
    for r in range(BUS_TURNS):
        order = [("main", cycle), ("bus", on_bus)]
        for name, fn in (order if r % 2 == 0 else order[::-1]):
            turns[name].append(fn())
    return {k: np.asarray(v) for k, v in turns.items()}


def drive_scaleout(device) -> dict:
    """Scale-out at world size 1 on NCCL: the flagship batch
    (``barc_n20_k48_b256``) through ``sharded_batch_solver`` held with that
    path's batched gates, its flags equal to the unsharded solve's lane by
    lane and its controls within 1e-5 relative; ``sharded_metrics`` against
    the flags' mean and the masked minimum (and the all-reduce timed);
    ``scaling_bench``.  The process group is gone when this returns.
    Returns the sharded solve's launches."""
    import torch
    import torch.distributed as dist
    from racing_lmpc_torch.benchmarks import build_barc_lmpc, make_scenario_batch, scaling_bench
    from racing_lmpc_torch.parallel import sharded_batch_solver, sharded_metrics
    from racing_lmpc_torch.parallel.distributed import (
        global_mesh, initialize, process_allgather, shard_batch_global)
    from racing_lmpc_torch.parallel.spawn import free_port
    case = "barc_n20_k48_b256"
    fx = load_batch_fixture(case)
    n_horizon, num_ss, per_lap, batch = CASES[case]
    initialize(f"127.0.0.1:{free_port()}", 1, 0, device)
    try:
        check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}, not nccl")
        _, track, _, mpc, manager = build_barc_lmpc(n_horizon, num_ss, per_lap, device=device)
        inp = make_scenario_batch(mpc, track, manager, batch=batch, device=device)
        z = torch.zeros((batch, mpc.layout.n))
        valid = torch.zeros((batch,), dtype=torch.bool)
        mesh = global_mesh()
        args = tuple(shard_batch_global(x, mesh) for x in (inp, z, valid))
        solver = sharded_batch_solver(mpc, mesh)
        zero_launches()
        out, _ = solver(*args)
        torch.cuda.synchronize()
        launches = read_launches()
        check(0 < launches["chol_tri_inv"] <= 150,
              f"sharded: chol_tri_inv launches {launches['chol_tri_inv']} not in (0, 150]")
        check(launches["gj_inverse"] == 0, "sharded: gj_inverse launched on the path")
        U, solved, obj = process_allgather((out.U_optm, out.solved, out.obj))
        whole, _ = mpc.solve_batch(inp)
        check(np.array_equal(solved, whole.solved.cpu().numpy()),
              "sharded: solved flags differ from the unsharded solve")
        err = rel_diff(U, whole.U_optm.cpu().numpy())
        check(err <= 1e-5, f"sharded: U_optm {err:.3e} from the unsharded solve")
        limits = gate_limits(fx)
        failed = held_to_reference(runs_like_reference(mpc, inp, fx, first=out), fx, limits,
                                   f"sharded {case} vs reference")
        check(not failed, f"sharded {case}: outside the reference's own spread on {failed}")
        frac, cmin = sharded_metrics(out.solved, out.obj, mesh)
        check(float(frac) == float(np.mean(solved)) and float(cmin) == float(obj[solved].min()),
              f"sharded_metrics ({float(frac)}, {float(cmin)}) differ from the flags' mean "
              f"and the masked minimum")
        # sharded and unsharded in turns: unsharded, sharded, sharded, unsharded
        turns = [("unsharded", lambda: mpc.solve_batch(inp)), ("sharded", lambda: solver(*args))]
        times = {"unsharded": [], "sharded": []}
        for name, fn in turns + turns[::-1]:
            times[name].append(cuda_time_ms(fn, reps=1, warmup=1))
        ms, ms_whole = np.mean(times["sharded"]), np.mean(times["unsharded"])
        metrics_ms = cuda_time_ms(lambda: sharded_metrics(out.solved, out.obj, mesh), reps=50)
        print(f"path sharded_{case}: world size 1 on NCCL, launches {launches}; flags equal "
              f"the unsharded solve's, U_optm {err:.1e} from it; within the reference's "
              f"spread; {ms:.1f} ms per batch, {batch / (ms / 1e3):.1f} solves/s (in turns "
              f"with the unsharded solve: {ms_whole:.1f} ms, {batch / (ms_whole / 1e3):.1f} "
              f"solves/s; {times}); sharded_metrics {metrics_ms:.4f} ms a call (two "
              f"all-reduces); solved {float(frac):.4f}, min objective {float(cmin):.6f}",
              flush=True)
        t = time.perf_counter()
        bench = scaling_bench(device_counts=[1], batch_per_device=256)
        print(f"scaling_bench (world size 1, {time.perf_counter() - t:.1f} s): "
              f"{json.dumps(bench)}", flush=True)
        check(bench[0]["solved_fraction"] > 0.9, "scaling_bench: solved fraction")
    finally:
        dist.destroy_process_group()
    return launches


def drive_dryrun() -> None:
    """``dryrun_multichip(1)``: the reference's three phases in one NCCL
    rank of their own, which raises if any of their checks fails."""
    from racing_lmpc_torch.entry import dryrun_multichip
    t = time.perf_counter()
    dryrun_multichip(1)
    print(f"dryrun_multichip(1): three phases in one NCCL rank, {time.perf_counter() - t:.1f} s",
          flush=True)


def lu_moved(arrays: list, s: int) -> list:
    """QP data (P, q, A, l, u) with q scaled by 1 + 2e-7 N(0, 1) from numpy
    seed 1 + s: about one f32 rounding."""
    rng = np.random.default_rng(1 + s)
    q = arrays[1] * (1 + 2e-7 * rng.standard_normal(arrays[1].shape))
    return [arrays[0], q.astype(np.float32), *arrays[2:]]


def lu_reading(a: dict, b: dict) -> dict:
    """How far LU-branch solutions ``a`` lie from ``b`` (dicts of ``x``,
    ``obj``): each relative to max(1, max |b|)."""
    return {"x": rel_diff(a["x"], b["x"]), "objective": rel_diff(a["obj"], b["obj"])}


def lu_limits(runs: list[dict]) -> dict:
    """Each LU gate's limit: the worst reading between any two of ``runs``,
    or the gate's floor where that is looser."""
    readings = [lu_reading(a, b) for i, a in enumerate(runs)
                for j, b in enumerate(runs) if i != j]
    return {k: max(floor, *(r[k] for r in readings)) for k, floor in LU_FLOORS.items()}


def drive_lu(device) -> None:
    """The IPM's pivoted-LU branch (``solve_qp_ip`` without ``eq_rows``) on
    a seeded QP batch and its moved copies on the card, against the same
    solves on the CPU: every QP converges on both, and the median of the
    card's readings stays within the CPU's own spread (``lu_limits``).  It
    launches no kernel of the port (its LU is torch's, as the reference's
    is jax.scipy's)."""
    import torch
    from racing_lmpc_torch.mpc.ipm import solve_qp_ip
    from racing_lmpc_torch.mpc.qp import QPData
    B, n, m, me = LU_QPS
    rng = np.random.default_rng(12)
    M = rng.normal(size=(B, n, n))
    P = np.einsum("bij,bik->bjk", M, M) / n + 0.1 * np.eye(n)
    A = rng.normal(size=(B, m, n))
    f = np.einsum("bmn,bn->bm", A, rng.normal(size=(B, n)) * 0.3)
    l, u = f - rng.uniform(0.1, 1.0, (B, m)), f + rng.uniform(0.1, 1.0, (B, m))
    l[:, :me] = u[:, :me] = f[:, :me]
    l[:, me:me + 2] = -np.inf
    u[:, me + 2] = np.inf
    arrays = [a.astype(np.float32) for a in (P, rng.normal(size=(B, n)), A, l, u)]
    inputs = [arrays] + [lu_moved(arrays, s) for s in range(LU_MOVED)]
    runs = {}
    zero_launches()
    for dev in ("cpu", device):
        runs[str(dev)] = []
        for data in inputs:
            sol = solve_qp_ip(QPData(*(torch.as_tensor(a, device=dev) for a in data)), iters=25)
            check(bool((sol.rp_rel.cpu() < 1e-3).all() & (sol.rd_rel.cpu() < 1e-3).all()),
                  f"LU branch on {dev}: not every QP converged")
            runs[str(dev)].append({"x": sol.x.cpu().numpy(), "obj": sol.obj.cpu().numpy()})
    torch.cuda.synchronize()
    check(read_launches() == {"chol_tri_inv": 0, "gj_inverse": 0}, "LU branch launched a kernel")
    limits = lu_limits(runs["cpu"])
    got = [lu_reading(a, b) for a, b in zip(runs[str(device)], runs["cpu"])]
    print(f"LU branch: {B} QPs (n={n}, m={m}, {me} equality rows) and {LU_MOVED} moved "
          f"copies, every one converged on the card and on the CPU; card vs CPU:", flush=True)
    failed = []
    for k, lim in limits.items():
        vals = np.array([r[k] for r in got])
        ok = np.median(vals) <= lim
        print(f"  {k}: median {np.median(vals):.3e} (runs {vals.min():.3e}..{vals.max():.3e}), "
              f"limit {lim:.3e} (the CPU's own spread or floor {LU_FLOORS[k]:.0e}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failed.append(k)
    check(not failed, f"LU branch: the card outside the CPU's own spread on {failed}")


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
    from racing_lmpc_torch.bench import device_line
    print(device_line(), flush=True)
    device = torch.device("cuda", 0)

    t0 = time.perf_counter()
    native_build = build_native_async()
    logs = _kernels.build()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    native_s = native_build()
    for name, log in logs.items():
        # each entry function's registers and spills, under its (mangled) name
        entry = None
        for line in log.splitlines():
            if "Compiling entry function" in line or "Function properties for" in line:
                entry = line.split("'")[1] if "'" in line else line.split()[-1]
                # the anonymous namespace's prefix off: "chol_tri_inv_wide_kernelILb1EEEvPKfPfi"
                entry = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}\d+", "", entry)
            elif "registers" in line or "spill" in line:
                print(f"  {name} {entry}: {line.strip()}", flush=True)

    marks = [time.perf_counter()]

    def lap(name: str) -> None:
        # each phase's seconds on a line of its own
        marks.append(time.perf_counter())
        print(f"phase {name}: {marks[-1] - marks[-2]:.1f} s ({marks[-1] - t0:.1f} s in all)",
              flush=True)

    chol = kernel_phase(device)
    lap("kernel chol_tri_inv")
    gj = gj_kernel_phase(device)
    lap("kernel gj_inverse")
    per_path = {"kernels at large sizes": dict(LARGE_SIZES)}
    check(all(v > 0 for v in LARGE_SIZES.values()),
          f"a kernel was not launched at a large size: {LARGE_SIZES}")
    print(f"path kernels at large sizes (chol_tri_inv n > 1024, gj_inverse b > 64): "
          f"launches {LARGE_SIZES}", flush=True)
    per_path["barc_n20_k48_b256"], mpc, inp, fx, limits = drive_path(
        device, "barc_n20_k48_b256", profiled=True)
    lower_precision_control(mpc, inp, fx, limits)
    lap("barc_n20_k48_b256 and the TF32 control")
    per_path["entry"] = drive_entry(device)
    lap("entry")
    per_path["barc_n40_k96_b128"] = drive_path(device, "barc_n40_k96_b128")[0]
    lap("barc_n40_k96_b128")
    # each controller path's replays, the longest first (settle_replays)
    pending = []
    cosim = {}
    for case in ("ctrl_barc_lmpc", "ctrl_putnam_short_lmpc"):
        per_path[case], cycle_ms, _, acts, replays = drive_controller(device, case)
        cosim[case] = (acts, cycle_ms)
        pending.insert(0, replays)
        lap(case)
    for case in ADMM_CASES:
        per_path[case] = drive_path(device, case, profiled=True)[0]
        lap(case)
    per_path["ctrl_barc_lmpc_regression"], *_, replays = drive_controller(
        device, "ctrl_barc_lmpc_regression")
    pending.append(replays)
    lap("ctrl_barc_lmpc_regression")
    for case in CONT_CASES:
        per_path[case] = drive_continuous(device, case)[0]
        lap(case)
    stack = drive_stack(device)
    per_path["stack_lqr"], per_path["stack_legacy"] = stack["lqr"], stack["legacy"]
    lap("stack")
    per_path["nl_double_track_b256"] = drive_nl_batch(device)
    lap("nl_double_track_b256")
    for case in DT_LMPC_FIXTURE_CASES:
        per_path[case] = drive_dt_lmpc(device, case)
        lap(f"dt_lmpc {case}")
    for case in MODEL_CTRL_CASES:
        per_path[case], *_, replays = drive_model_controller(device, case)
        pending.insert(1, replays)
        lap(case)
    drive_native(native_s)
    per_path["bus_barc_lmpc"] = drive_bus(device, *cosim["ctrl_barc_lmpc"])
    lap("native and bus")
    # the process group is destroyed before the replays spawn their processes
    per_path["sharded_barc_n20_k48_b256"] = drive_scaleout(device)
    lap("scale-out")
    per_path["bench"] = drive_bench(device)
    lap("bench")

    def settle_accuracy(results: list[dict]) -> None:
        res = results[0]
        for line in res["lines"]:
            print(line, flush=True)
        print(f"accuracy: {len(res['oracle_ms'])} instances, the port's solves in "
              f"{res['solve_s']:.1f} s, launches {res['launches']}", flush=True)
        per_path["accuracy"] = res["launches"]
        check(not res["failed"], f"accuracy: {res['failed']}")
        check(res["launches"]["chol_tri_inv"] > 0 and res["launches"]["gj_inverse"] == 0,
              f"accuracy: launches {res['launches']}")
    def settle_tools(results: list[dict]) -> None:
        launches = {k: sum(r["launches"][k] for r in results) for k in results[0]["launches"]}
        seconds = {k: v for r in results for k, v in r["seconds"].items()}
        failed = [f for r in results for f in r["failed"]]
        for line in (line for r in results for line in r["lines"]):
            print(line, flush=True)
        print(f"tools: launches {launches}, seconds {seconds}", flush=True)
        per_path["tools"] = launches
        check(not failed, f"tools: {failed}")
        check(all(r["launches"]["chol_tri_inv"] > 0 for r in results)
              and launches["gj_inverse"] == 0, f"tools: launches {launches}")
    def settle_phases(results: list) -> None:
        for name, launches in zip(POOL_PHASES, results):
            if launches is not None:
                per_path[name] = launches
    # the longest jobs first: Putnam's replays (~70 s each on the pool's
    # shared host), the tools, the phases, the accuracy phase
    pending[1:1] = [("tools", len(TOOLS_PARTS), settle_tools),
                    ("phase", len(POOL_PHASES), settle_phases),
                    ("accuracy", 1, settle_accuracy)]
    pending += bench_rt_replays()
    settle_replays(pending)
    lap("replay pool")

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
