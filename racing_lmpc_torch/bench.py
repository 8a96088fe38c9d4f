"""The port's benchmark: batched BARC LMPC solves/s on one NVIDIA GPU (N=20, K=48).

    python -m racing_lmpc_torch.bench

The counterpart of ``bench.py`` (``:57-276``): the same measurements on the
same inputs, through the port's entry points, printed as one JSON line
(last) with ``bench.py``'s keys.  Earlier lines carry the card's name and
power limit, each section's ``chol_tri_inv`` launches, its sample counts
and the lanes that did not solve.

- Headline: ``solve_batch`` of ``make_scenario_batch(batch=256)`` with a
  zero warm start (``bench.py:114-146``).  Every repetition ends in
  ``torch.cuda.synchronize()``; ``bench.py`` synchronized only after its
  last one (``VERDICT.md:168-174`` compares the two methods).  One loop
  of repetitions gives both the throughput and the batch latencies (with
  a synchronize after each, the reference's two loops measure the same
  thing); ``*_p99`` is the slowest repetition, as in ``bench.py``.
- ``batch1_onchip_ms`` / ``batch8_onchip_ms_per_solve``: ``chain_solves``,
  dependent receding-horizon solves (``bench.py:152-175``).
- ``batch_sweep_solves_per_s`` (``:177-188``) and the shipped N=40/K=96
  configuration at batch 128 (``:190-203``).
- ``shipped_rt_latencies``: the batch-1 controller cycle of all five launch
  scenarios, ``MPCController._rti_step`` chained (``:57-112``).
- ``ss_query_ms``: the host safe-set query of a control cycle (``:220-226``).
- ``flops_per_solve``: one solve's floating-point operations, counted
  while the untimed first solve runs (``flops_per_solve``), in place of
  XLA's cost analysis (``:228-237``), which the card does not have.
  ``mfu_vs_f32_peak`` divides the achieved rate by the H100's f32 peak
  outside the tensor cores: the port runs with TF32 off, so that is the
  peak its f32 products can reach (``bench.py`` divided f32 work by the
  TPU's bf16 peak).  The count it divides holds the float64 products too
  (``flops_per_solve_f64``, about half of it), whose peak is half the
  f32 one, so the share mixes two precisions.

It runs on CUDA only: with no CUDA device it raises and measures nothing.
"""

from __future__ import annotations

import collections
import json
import subprocess
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# H100 SXM, NVIDIA data sheet: f32 outside the tensor cores, at 700 W
F32_PEAK_FLOP_PER_S = 67e12
# the north-star target (BASELINE.md): solves/s a card
BASELINE_SOLVES_PER_S = 1000.0
# each launch scenario's loop period (BARC 40 Hz, the Putnam launches 10
# Hz) and the reference's cap on one solve (max_cpu_time of every shipped
# *_mpc.param.yaml), as bench.py:67-71 sets them
LOOP_PERIOD_MS = {
    "barc_lmpc": 25.0, "barc_tracking_mpc": 25.0,
    "putnam_short_lmpc": 100.0, "putnam_short_tracking_mpc": 100.0,
    "putnam_config_a_tracking_mpc": 100.0,
}
SOLVE_CAP_MS = 85.0
RT_BUDGET_MS = 25.0
# bench.py's repetition counts: the b256 headline, the dependent chains
# (steps, repetitions), the sweep, the N=40 batch, the controller chains
# (cycles, repetitions) and the safe-set query
HEADLINE_REPS = 20
CHAIN, CHAIN_REPS = 10, 5
SWEEP, SWEEP_REPS = (512, 1024), 10
N40_REPS = 10
RT_CHAIN, RT_REPS = 8, 3
SS_REPS = 50


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device: torch.device) -> tuple[float, object]:
    """(host seconds of ``fn()`` from a synchronized device to the end of
    the work it queued (``torch.cuda.synchronize``), its result)."""
    _sync(device)
    t0 = time.perf_counter()
    res = fn()
    _sync(device)
    return time.perf_counter() - t0, res


def chain_solves(mpc, inp, z, valid, chain: int) -> torch.Tensor:
    """``chain`` dependent solves of the batch ``inp`` through
    ``RacingMPC._solve_impl`` (``bench.py:154-162``): step k+1 solves from
    step k's one-step prediction ``X_optm[:, 1]`` as ``x_ic``, the warm
    start ``z`` carries from step to step, ``valid`` stays fixed.  Returns
    each step's objective, (chain, b)."""
    objs = []
    for _ in range(chain):
        out, z = mpc._solve_impl(inp, z, valid)
        inp = inp._replace(x_ic=out.X_optm[:, 1])
        objs.append(out.obj)
    return torch.stack(objs)


def rt_chain(ctrl, state, x0, u0, ss_x, ss_j, chain: int):
    """``chain`` dependent controller cycles (``bench.py:86-93``):
    ``ctrl._rti_step`` from ``(state, x0, u0)``, each next cycle from the
    new state, its ``last_X[1]`` and the applied control, with the safe set
    ``(ss_x, ss_j)`` and the controller's speed limit and scale fixed.
    Returns the last state and each cycle's ``StepInfo``."""
    lim, sc = ctrl._f32(ctrl.speed_limit), ctrl._f32(ctrl.speed_scale)
    infos = []
    for _ in range(chain):
        state, info = ctrl._rti_step(x0, u0, state, ss_x, ss_j, lim, sc)
        x0, u0 = state.last_X[1], info.u_apply
        infos.append(info)
    return state, infos


class _ProductFlops(TorchDispatchMode):
    """Counts, while on, the floating-point operations of every product
    dispatched (``torch.utils.flop_counter``'s formulas: 2 m k n for a
    matrix product), by the dtype of its result; nothing while ``paused``."""

    def __init__(self):
        super().__init__()
        self.by_dtype = collections.Counter()
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None and not self.paused:
            self.by_dtype[out.dtype] += formula(*args, **kwargs, out_val=out)
        return out


def flops_per_solve(mpc, inp, z, valid) -> tuple[dict, object]:
    """Floating-point operations of one lane of ``mpc.solve_batch(inp, z,
    valid)``, counted while it runs: every matrix product as
    ``torch.utils.flop_counter`` counts it (``matmul``), and each
    ``chol_tri_inv`` matrix at 2/3 n^3 (``kernel``, the kernel table's
    convention; where the plain version runs, on a CPU tensor, its own
    products are left out).  So the count follows the passes the IPM ran:
    its zoom ladder stops early.  ``f64`` is the part of ``matmul``
    computed in float64 (the normal-equations product A'DA,
    ``ipm.NORMAL_EQ_DTYPE``); ``total`` is matmul + kernel; elementwise
    work is not counted.  Returns (the counts, with ``chol_tri_inv``'s
    launches as ``launches``; the solve's output)."""
    from racing_lmpc_torch.mpc import ipm
    from racing_lmpc_torch.ops import linalg

    mode, kernel = _ProductFlops(), [0.0]
    inner = ipm.chol_tri_inv

    def counted(H):
        n = H.shape[-1]
        kernel[0] += H.numel() // max(n * n, 1) * 2.0 / 3.0 * n ** 3
        mode.paused = True
        try:
            return inner(H)
        finally:
            mode.paused = False
    launches = linalg.chol_tri_inv.launches
    ipm.chol_tri_inv = counted
    try:
        with mode:
            out, _ = mpc.solve_batch(inp, z, valid)
    finally:
        ipm.chol_tri_inv = inner
    B = out.obj.shape[0]
    mm = sum(mode.by_dtype.values())
    if mm % B or mode.by_dtype[torch.float64] % B:
        raise ValueError(f"{mm} product FLOPs do not divide among {B} lanes")
    return {"matmul": mm // B, "kernel": kernel[0] / B,
            "f64": mode.by_dtype[torch.float64] // B, "total": mm // B + kernel[0] / B,
            "launches": linalg.chol_tri_inv.launches - launches}, out


def shipped_rt_latencies(device, chain: int = RT_CHAIN, reps: int = RT_REPS) -> tuple:
    """The batch-1 controller cycle of every launch scenario
    (``bench.py:57-112``): the port's ``CoSimulation`` after one ``step()``
    (bootstrap and first cycle), the safe set queried once, then ``reps``
    runs of ``rt_chain`` over ``chain`` cycles, each synchronized; the
    median run over ``chain``.  Returns (``bench.py``'s dict per scenario,
    and per scenario its QP width ``qp_n``, ``chol_tri_inv`` launches a
    cycle, fallbacks in the chains, whether the first cycle solved and
    the last run's objectives, and its seconds with the set-up)."""
    from racing_lmpc_torch.launch.runner import _SCENARIOS, CoSimulation
    from racing_lmpc_torch.ops import linalg

    out, detail = {}, {}
    for name, loop_ms in LOOP_PERIOD_MS.items():
        t0 = time.perf_counter()
        cs = CoSimulation(_SCENARIOS[name], device=device)
        cs.step()
        ctrl = cs.controller
        st = ctrl.state
        ss_x, ss_j = ctrl._query_safe_set(st.last_X[-1])
        x0 = st.last_X[0]
        u0 = torch.zeros((ctrl.mpc.nu,), dtype=torch.float32, device=device)
        launches = linalg.chol_tri_inv.launches
        ts, fallbacks = [], 0
        for _ in range(reps):
            t, (_, infos) = _timed(lambda: rt_chain(ctrl, st, x0, u0, ss_x, ss_j, chain),
                                   device)
            ts.append(t / chain)
            fallbacks += sum(bool(i.used_fallback) for i in infos)
        ms = float(np.median(ts) * 1e3)
        out[name] = {
            "batch1_cycle_onchip_ms": ms, "n": ctrl.mpc.N, "k": ctrl.mpc.K,
            "sqp_relin_steps": max(1, ctrl.config.sqp_relin_steps),
            "loop_period_ms": loop_ms, "solve_cap_ms": SOLVE_CAP_MS,
            "within_cap": ms <= SOLVE_CAP_MS, "within_loop_period": ms <= loop_ms,
        }
        detail[name] = {
            "qp_n": ctrl.mpc.layout.n,
            "chol_tri_inv_per_cycle": (linalg.chol_tri_inv.launches - launches) / (reps * chain),
            "fallbacks": fallbacks, "first_cycle_solved": cs.telemetry[0].solved,
            "obj": [float(i.output.obj) for i in infos],
            "seconds": time.perf_counter() - t0,
        }
    return out, detail


def device_line() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def bench_line(*, solves_per_s, batch, lat_ms, onchip, ss_query_ms, solved_fraction,
               flops, sweep, shipped_rt, n40_lat_ms, n40_batch, n40_solved_fraction,
               qp_zoom_rounds, device, power_limit_w) -> dict:
    """The JSON line: ``bench.py``'s keys (``:240-276``), with
    ``mfu_vs_f32_peak`` in place of ``mfu_vs_bf16_peak``, plus
    ``flops_per_solve_f64`` and ``power_limit_w``; ``lat_ms`` and
    ``n40_lat_ms`` are the batch latencies of the repetitions, ``onchip``
    the per-step chain times by batch, ``flops`` what ``flops_per_solve``
    returns.  ``mfu_vs_f32_peak`` is all of ``flops_per_solve`` (its f64
    part ``flops_per_solve_f64`` included) a second over
    ``F32_PEAK_FLOP_PER_S``."""
    p50 = float(np.median(lat_ms))
    n40_p50 = float(np.median(n40_lat_ms))
    return {
        "metric": "barc_lmpc_solves_per_s_per_chip_N20",
        "value": solves_per_s,
        "unit": "solves/s",
        "vs_baseline": solves_per_s / BASELINE_SOLVES_PER_S,
        "extra": {
            "batch": batch,
            "batch_latency_ms_p50": p50,
            "batch_latency_ms_p99": float(np.max(lat_ms)),
            "per_solve_ms_amortized": p50 / batch,
            "batch1_onchip_ms": onchip[1],
            "batch8_onchip_ms_per_solve": onchip[8] / 8,
            "batch1_latency_ms": onchip[1],
            "rt_budget_ms": RT_BUDGET_MS,
            "ss_query_ms": ss_query_ms,
            "solved_fraction": solved_fraction,
            "flops_per_solve": flops["total"],
            "flops_per_solve_f64": flops["f64"],
            "mfu_vs_f32_peak": flops["total"] * solves_per_s / F32_PEAK_FLOP_PER_S,
            "batch_sweep_solves_per_s": sweep,
            "shipped_rt_latencies": shipped_rt,
            "flagship_n40_k96_batch128_solves_per_s": n40_batch / (n40_p50 / 1e3),
            "flagship_n40_k96_batch128_latency_ms_p50": n40_p50,
            "flagship_n40_k96_solved_fraction": n40_solved_fraction,
            "qp_zoom_rounds": qp_zoom_rounds,
            "device": device,
            "power_limit_w": power_limit_w,
        },
    }


def run(device, seed: int = 0, reps: int | None = None, chain: int | None = None,
        sweep: tuple = SWEEP) -> tuple[dict, dict]:
    """Every measurement of the bench on ``device`` (CUDA), printing each
    section's launches and samples.  ``seed`` makes the scenario batches
    (``make_scenario_batch``); ``chip_smoke.py`` holds the solved lanes to
    stored reference runs of seed 0, so a seed other than 0 is for a
    benchmark harness that measures other batches, where that check does
    not apply.  ``reps`` replaces every repetition
    count and ``chain`` every chain length (``bench.py``'s when None);
    ``sweep`` lists the sweep's batches.  Returns (the JSON line's dict,
    details: the headline's and the N=40 batch's solved lanes
    ``solved_b256`` and ``solved_n40``, and ``shipped_rt_latencies``'
    details as ``shipped``)."""
    from racing_lmpc_torch.benchmarks import build_barc_lmpc, make_scenario_batch
    from racing_lmpc_torch.mpc.racing_mpc import map_input
    from racing_lmpc_torch.ops import linalg

    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"the bench measures a CUDA device, not {device}")
    smi = device_line()
    print(smi, flush=True)

    def count():
        return linalg.chol_tri_inv.launches

    since = [time.perf_counter()]

    def section(label, launches0, samples):
        now = time.perf_counter()
        print(f"bench {label}: {samples} timed samples, chol_tri_inv launches "
              f"{count() - launches0}; {now - since[0]:.1f} s with its set-up", flush=True)
        since[0] = now

    def unsolved(out):
        return np.flatnonzero(~out.solved.cpu().numpy()).tolist()

    detail = {}
    _, track, cfg, mpc, manager = build_barc_lmpc(n_horizon=20, num_ss=48, device=device)
    batch = 256
    inp = make_scenario_batch(mpc, track, manager, batch, seed=seed, device=device)
    z = torch.zeros((batch, mpc.layout.n), dtype=torch.float32, device=device)
    valid = torch.zeros((batch,), dtype=torch.bool, device=device)

    # the first (untimed) solve: its lanes, and its FLOPs counted as it runs
    flops, out = flops_per_solve(mpc, inp, z, valid)
    detail["solved_b256"] = out.solved.cpu().numpy()
    print(f"bench b256: untimed solve, chol_tri_inv launches {flops['launches']}, "
          f"FLOPs a solve {flops['total']:.0f} ({flops['f64']} in f64), unsolved lanes "
          f"{unsolved(out)}", flush=True)

    n = reps or HEADLINE_REPS
    c0 = count()
    lat = [_timed(lambda: mpc.solve_batch(inp, z, valid), device)[0] for _ in range(n)]
    section("b256", c0, n)
    solves_per_s = batch * n / sum(lat)

    onchip = {}
    for b in (1, 8):
        inp_b = map_input(lambda a: a[:b], inp)
        steps = chain or CHAIN

        def go():
            chain_solves(mpc, inp_b, z[:b], valid[:b], steps)
        go()
        c0 = count()
        n = reps or CHAIN_REPS
        onchip[b] = float(np.median([_timed(go, device)[0] for _ in range(n)])) / steps * 1e3
        section(f"chain b{b} x {steps} steps", c0, n)

    sweep_out = {}
    for b in sweep:
        inp_b = make_scenario_batch(mpc, track, manager, b, seed=seed, device=device)
        z_b = torch.zeros((b, mpc.layout.n), dtype=torch.float32, device=device)
        v_b = torch.zeros((b,), dtype=torch.bool, device=device)
        mpc.solve_batch(inp_b, z_b, v_b)
        c0 = count()
        n = reps or SWEEP_REPS
        t = [_timed(lambda: mpc.solve_batch(inp_b, z_b, v_b), device)[0] for _ in range(n)]
        sweep_out[str(b)] = b * n / sum(t)
        section(f"sweep b{b}", c0, n)

    _, track40, _, mpc40, manager40 = build_barc_lmpc(
        n_horizon=40, num_ss=96, num_ss_per_lap=32, device=device)
    b40 = 128
    inp40 = make_scenario_batch(mpc40, track40, manager40, b40, seed=seed, device=device)
    z40 = torch.zeros((b40, mpc40.layout.n), dtype=torch.float32, device=device)
    v40 = torch.zeros((b40,), dtype=torch.bool, device=device)
    out40, _ = mpc40.solve_batch(inp40, z40, v40)
    detail["solved_n40"] = out40.solved.cpu().numpy()
    c0 = count()
    n = reps or N40_REPS
    lat40 = [_timed(lambda: mpc40.solve_batch(inp40, z40, v40), device)[0]
             for _ in range(n)]
    section(f"N=40 K=96 b{b40}", c0, n)
    print(f"bench N=40 K=96 b{b40}: unsolved lanes {unsolved(out40)}", flush=True)

    shipped, detail["shipped"] = shipped_rt_latencies(
        device, chain=chain or RT_CHAIN, reps=reps or RT_REPS)
    for name, d in detail["shipped"].items():
        print(f"bench scenario {name}: QP n={d['qp_n']}, chol_tri_inv launches a cycle "
              f"{d['chol_tri_inv_per_cycle']}, fallbacks {d['fallbacks']}, first cycle "
              f"solved {d['first_cycle_solved']}; {d['seconds']:.1f} s with its set-up",
              flush=True)

    x_term = inp.X_ref[0, -1].cpu().numpy()
    manager.query_padded(x_term, mpc.K, cfg.num_ss_pts_per_lap)
    t0 = time.perf_counter()
    for _ in range(SS_REPS):
        manager.query_padded(x_term, mpc.K, cfg.num_ss_pts_per_lap)
    ss_query_ms = (time.perf_counter() - t0) / SS_REPS * 1e3

    result = bench_line(
        solves_per_s=solves_per_s, batch=batch, lat_ms=np.asarray(lat) * 1e3,
        onchip=onchip, ss_query_ms=ss_query_ms,
        solved_fraction=float(detail["solved_b256"].mean()), flops=flops, sweep=sweep_out,
        shipped_rt=shipped, n40_lat_ms=np.asarray(lat40) * 1e3, n40_batch=b40,
        n40_solved_fraction=float(detail["solved_n40"].mean()),
        qp_zoom_rounds=cfg.qp_zoom_rounds, device=torch.cuda.get_device_name(device),
        power_limit_w=float(smi.rsplit(",", 1)[1].strip().split()[0]))
    return result, detail


def main() -> None:
    from racing_lmpc_torch import resolve_device
    result, _ = run(resolve_device(None))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
