"""One run of one cell of the port's benchmark.

    python3 -m lmpc_bench --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration (its file under ``configs/``) and a traffic mix (its
file ``traffic/<traffic>.json``); its correctness limits are
``limits/<cell>.json`` and each per-layer metric is read by
``metrics/<metric>.py``, all found by name.

Set-up (counted in ``setup_s``, from the process's start): the port's
``RacingMPC`` from the configuration, the mix's pool of scenario batches
from the seed, uploaded to the card, and the mix's warm-up steps, which
build and load the port's kernels.  Then, with ``--trace 0``, the window:
steps back to back, each one ``RacingMPC.solve_batch`` on the pool's tensors
ended by its outputs copied to the host, until a step ends past
``--seconds``; the rate is taken over all those steps and all that time.
With ``--trace 1`` the mix's ``trace_steps`` whole steps run under the
profiler instead of the window, and the per-layer metrics are read from
them.  Then the port's state is freed and a sample of the run's answers is
judged against the plain reference (``check.py``).  The last line of
standard output is the result; the numbers compared, beside their limits,
are the last lines of standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
from contextlib import nullcontext  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that no run may load
BANNED = ("jax", "jaxlib", "flax", "racing_lmpc_tpu")


def load_cell(name: str, root: Path = ROOT) -> dict:
    """Everything a run of cell ``name`` reads, found by name."""
    man = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    wl = cells[name]
    entry = next(c for c in man["configs"] if c["name"] == wl["config"])
    here = root / "lmpc_bench"
    limits = here / "limits" / f"{name}.json"
    e2e = [m for m in man["end_to_end"] if name in m.get("workloads", [name])]
    moves = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"]
                 if name in m["workloads"] or ("workloads" not in m and m["moves"] in moves)]
    return {"workload": wl,
            "config": json.loads((root / entry["file"]).read_text()),
            "mix": json.loads((here / "traffic" / f"{wl['traffic']}.json").read_text()),
            "limits": json.loads(limits.read_text())["numbers"] if limits.exists() else {},
            "end_to_end": e2e, "per_layer": per_layer, "here": here}


def banned_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def reader(here: Path, name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(f"lmpc_bench_metric_{name}",
                                                  here / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_power_limit() -> str | None:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else None


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m lmpc_bench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device=None, batch: int | None = None, root: Path = ROOT) -> int:
    """One run; ``device`` and ``batch`` (the CPU tests' tiny runs) skip
    the look for a card and cut the mix's batch."""
    args = parse(argv)
    cell = load_cell(args.workload, root)
    import torch
    if device is None:
        chips = int(cell["workload"]["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"lmpc_bench: the cell needs {chips} CUDA device(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"
    torch.set_num_threads(2)
    from lmpc_bench import check, system, trace
    from lmpc_bench.generator import Traffic

    cfg, mix = cell["config"], cell["mix"]
    marks = [("start", time.perf_counter() - T_START)]
    mpc = system.build_mpc(cfg, device)
    traffic = Traffic(mix, cfg, args.seed, device, batch)
    B = traffic.batch
    marks.append(("inputs", time.perf_counter() - T_START))

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    for _ in range(int(mix["warmup_steps"])):
        system.step(mpc, traffic)
    traffic.k = 0                               # the window starts at pool batch 0
    sync()
    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - T_START
    marks.append(("warm-up", setup_s))
    print("lmpc_bench: set-up " + ", ".join(f"{k} to {v:.2f} s" for k, v in marks), file=sys.stderr)

    pools, hosts = [], []
    ctx = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile
        n_steps = int(mix["trace_steps"])
        tr = calls = None
        for _ in range(3):                     # a session whose records are whole
            c0 = system.chol_launches()
            t0 = time.perf_counter()
            session = profile(activities=[ProfilerActivity.CUDA]) if on_card else nullcontext()
            with session as prof:
                for _ in range(n_steps):
                    p, host = system.step(mpc, traffic)
                    pools.append(p)
                    hosts.append(host)
                sync()
                window_s = time.perf_counter() - t0
            if not on_card:
                break
            calls = system.chol_launches() - c0
            tr = trace.read(prof)
            if tr.count("chol_tri_inv") == calls:
                break
            print(f"lmpc_bench: profiler session dropped records ({tr.count('chol_tri_inv')} "
                  f"of {calls} chol_tri_inv kernels); again", file=sys.stderr)
            tr = None
        traced = hosts[-n_steps:]
        ctx = SimpleNamespace(
            trace=tr, steps=n_steps, window_s=window_s, batch=B,
            chol_calls=calls if on_card else None, layout=system.layout(mpc),
            solved=torch.as_tensor(sum((list(h["solved"]) for h in traced), [])).double(),
            card=None)
        if on_card:
            from lmpc_bench import roofline
            ctx.card = roofline.peaks(torch.cuda.get_device_name(device))
    else:
        calls, ends = [], []
        t0 = time.perf_counter()
        while True:
            c0 = system.chol_launches()
            p, host = system.step(mpc, traffic)
            calls.append(system.chol_launches() - c0)
            pools.append(p)
            hosts.append(host)
            window_s = time.perf_counter() - t0
            ends.append(window_s)
            if window_s >= args.seconds:
                break
        print(f"lmpc_bench: window {window_s:.3f} s, {len(hosts)} steps, chol_tri_inv calls "
              f"a step {min(calls)}-{max(calls)} (mean {sum(calls) / len(calls):.1f})",
              file=sys.stderr)
        print("lmpc_bench: steps (end s:solved) " + " ".join(
            f"{t:.4f}:{int(h['solved'].sum())}" for t, h in zip(ends, hosts)), file=sys.stderr)
    window_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    layout = system.layout(mpc)
    del mpc, traffic.device_pool
    if on_card:
        torch.cuda.empty_cache()

    solved = sum(int(h["solved"].sum()) for h in hosts)
    attempted = B * len(hosts)
    picks = check.pick(args.seed, len(hosts), B, int(mix["check_lanes"]))
    values = check.readings(cfg, traffic, pools, hosts, picks, device)
    correct, shown = check.judge(values, cell["limits"])

    banned = banned_modules()
    if banned:
        print(f"lmpc_bench: modules loaded that no run may load: {banned}", file=sys.stderr)
        return 3

    metrics = {}
    units = {m["name"]: m["unit"] for m in cell["end_to_end"] + cell["per_layer"]}
    if args.trace:
        for m in cell["per_layer"]:
            v = reader(cell["here"], m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e = {"solves_per_s": solved / window_s, "peak_mem_gib": window_peak / 2 ** 30,
               "setup_s": setup_s}
        metrics = {m["name"]: {"value": float(e2e[m["name"]]), "unit": units[m["name"]]}
                   for m in cell["end_to_end"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else device.type,
           "count": 1,
           "memory_peak_bytes": int(max(setup_peak, window_peak)) if on_card else None}
    result = {"correct": bool(correct), "attempted": attempted, "failed": attempted - solved,
              "metrics": metrics, "device": dev}
    if args.trace and ctx.trace is not None:
        dev["busy_s"] = ctx.trace.busy_s()
        dev["window_s"] = window_s
        result["breakdown"] = {"device_ops": ctx.trace.top_ops(), "idle_gaps": ctx.trace.idle_gaps()}
    result["check"] = shown
    print(f"lmpc_bench: {len(hosts)} steps of {B} lanes, QP {layout}", file=sys.stderr)
    if args.trace and on_card:
        print(f"lmpc_bench: card {card_power_limit()}", file=sys.stderr)
    for k, v in values.items():
        if k not in shown:
            print(f"reading {k}: {v!r}", file=sys.stderr)
    for k, v in shown.items():
        print(f"check {k}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0
