"""The grid variants of ``chol_tri_inv`` (n > 1,024) and ``gj_inverse``
(b > 168) on the card: bits, registers, times against earlier versions.

    python3 tests/torch_port_large_kernels.py [--quick] [--earlier DIR]

Builds the shipped ``racing_lmpc_torch/csrc/{chol_tri_inv,gj_inverse}.cu``
with the port's nvcc flags into ``build/large_kernels/``, and beside them two
copies of ``chol_tri_inv.cu`` for the dispatch rule's measurement, one that
never takes its grid variant (one block a matrix at every batch) and one that
takes it at every batch past n = 302, and, with ``--earlier DIR``, the
sources of an earlier checkout unpacked in DIR (one nvcc a library, all side
by side).
Prints each kernel entry's registers and spills (``ptxas -v``).  Holds every
shipped build bit for bit to its mirror: ``chol_tri_inv`` to
``chol_tri_inv_sweep`` at n = 1,025, 1,100 (G = 4, one indefinite lane),
1,736, 1,737 and 2,048, ``gj_inverse`` to ``gj_inverse_plain`` (pivots, NaN
places, bits) at b = 169 (a singular lane), 256 (a Hadamard tie batch), 512,
1,024 and 1,547 (singular lanes; the first b whose panel the grid variant
keeps in device memory).  Without ``--quick``, times each version in turns (earlier,
shipped, shipped, earlier; CUDA events around each call, synchronized,
median) and on the device (``chip_smoke.device_ms``), beside the
``torch.linalg`` yardstick: ``chol_tri_inv`` at (1,2048,2048),
(4,2048,2048), (32,2048,2048), (1,512,512) and (1,1024,1024), ``gj_inverse``
at (4,1024,1024), (1,1024,1024), (1,512,512) and (16,256,256); both sides
of the dispatch rule (one block a matrix, and the grid variant) at batches of
32-96 for n = 512, 1,024 and 2,048 and 128 for n = 2,048; and, for the gap
seen between a call's time and its device time, each call's event time
with the SM clock sampled by ``nvidia-smi`` beside the loop, and how many
calls' kernel records each of 8 profiler sessions of 5 calls brought back.  Prints the card's name and power limit
first and one JSON line last (also written to
``chiprun_out/large_kernels.json``).  Needs one GPU; imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from racing_lmpc_torch.ops import _kernels, linalg  # noqa: E402

OUT = _kernels.BUILD_DIR / "large_kernels"
GRID_MAX_G = "constexpr int kGridMaxG = 32;"


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


class Clocks:
    """The SM clock and power sampled every 50 ms while the block runs."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
             "-lms", "50"], stdout=subprocess.PIPE, text=True)
        self.lines = []
        self.reader = threading.Thread(target=lambda: self.lines.extend(self.proc.stdout))
        self.reader.start()
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        self.proc.wait()
        self.reader.join()
        vals = [tuple(float(v) for v in line.split(",")) for line in self.lines if "," in line]
        self.sm = [v[0] for v in vals]
        self.watts = [v[1] for v in vals]

    def summary(self) -> dict:
        if not self.sm:
            return {"samples": 0}
        return {"samples": len(self.sm), "sm_mhz_min": min(self.sm), "sm_mhz_max": max(self.sm),
                "watts_max": max(self.watts)}


def build(sources: dict[str, Path]) -> dict[str, ctypes.CDLL]:
    """One nvcc a library, side by side; prints each entry's registers."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        lib = OUT / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            _kernels.nvcc_command(src, lib),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        entry = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif entry and ("grid_kernel" in entry or "wide_kernel" in entry) and (
                    "registers" in line or "spill" in line):
                print(f"  {name} {entry[-60:]}: {line.strip()}", flush=True)
        libs[name] = ctypes.CDLL(str(lib))
    return libs


class Kernel:
    """A built library's entry point, called as the wrapper calls it."""

    def __init__(self, L: ctypes.CDLL, kernel: str):
        self.kernel = kernel
        self.fn = getattr(L, f"{kernel}_f32")
        ptrs = 3 if kernel == "gj_inverse" else 2
        self.fn.argtypes = ([ctypes.c_void_p] * ptrs + [ctypes.c_int, ctypes.c_int]
                            + [ctypes.c_void_p, ctypes.c_void_p])
        self.fn.restype = ctypes.c_int
        self.ws = getattr(L, f"{kernel}_workspace_floats")
        self.ws.restype = ctypes.c_longlong
        # sources with a variant query take (G, n) and give the launch's
        # floats; earlier ones take n and give a matrix's
        self.variant = getattr(L, f"{kernel}_variant", None)
        if self.variant is not None:
            self.variant.argtypes = [ctypes.c_int, ctypes.c_int]
            self.variant.restype = ctypes.c_char_p
            self.ws.argtypes = [ctypes.c_int, ctypes.c_int]
        else:
            self.ws.argtypes = [ctypes.c_int]
        if getattr(L, f"{kernel}_prepare")() != 0:
            raise RuntimeError(f"{kernel}_prepare failed")

    def name_of(self, G: int, n: int) -> str:
        return self.variant(G, n).decode() if self.variant is not None else "earlier"

    def __call__(self, X: torch.Tensor, pivots: bool = False):
        G, n = X.shape[0], X.shape[-1]
        out = torch.empty_like(X)
        floats = int(self.ws(G, n)) if self.variant is not None else G * int(self.ws(n))
        ws = torch.empty(floats, device=X.device) if floats else None
        wsp = ws.data_ptr() if ws is not None else None
        stream = torch.cuda.current_stream().cuda_stream
        if self.kernel == "gj_inverse":
            piv = torch.empty(X.shape[:-1], dtype=torch.int32, device=X.device) if pivots else None
            err = self.fn(X.data_ptr(), out.data_ptr(), piv.data_ptr() if pivots else None,
                          G, n, wsp, stream)
        else:
            piv = None
            err = self.fn(X.data_ptr(), out.data_ptr(), G, n, wsp, stream)
        if err:
            raise RuntimeError(f"{self.kernel} launch failed: CUDA error {err}")
        return (out, piv.long()) if pivots else out


def same_bits(a, b) -> bool:
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b)) and torch.equal(
        torch.where(nan, 0.0, a).view(torch.int32), torch.where(nan, 0.0, b).view(torch.int32)))


def spd_on(rng, G, n, dev):
    A = torch.as_tensor(rng.normal(size=(G, n, n)).astype(np.float32), device=dev)
    return A.mT @ A + n * torch.eye(n, device=dev)


def invertible(rng, G, b, dev):
    A = rng.normal(size=(G, b, b)) + 2.0 * np.sqrt(b) * np.eye(b)
    return torch.as_tensor(A.astype(np.float32), device=dev)


def hadamard(rng, G, b, dev):
    H = np.ones((1, 1))
    while H.shape[0] < b:
        H = np.block([[H, H], [H, -H]])
    out = [H[rng.permutation(b)] * rng.choice([-1.0, 1.0], size=(b, 1))
           * 2.0 ** rng.integers(-3, 4, size=(1, b)) for _ in range(G)]
    return torch.as_tensor(np.asarray(out, np.float32), device=dev)


def check(chol: Kernel, gj: Kernel, dev) -> list[str]:
    rng = np.random.default_rng(0)
    lines = []
    for G, n, bad in ((1, 1025, None), (4, 1100, (2, 700)), (1, 1736, None), (1, 1737, None),
                      (1, 2048, None)):
        H = spd_on(rng, G, n, dev)
        if bad:
            H[bad[0], bad[1], bad[1]] = -1.0e4
        K = chol(H)
        S = linalg.chol_tri_inv_sweep(H)
        torch.cuda.synchronize()
        ok = same_bits(K, S)
        lanes = (~torch.isfinite(K).flatten(1).all(dim=1)).tolist()
        ok = ok and lanes == [bad is not None and g == bad[0] for g in range(G)]
        lines.append(f"chol_tri_inv ({G},{n},{n}) [{chol.name_of(G, n)}]: "
                     f"{'bit-equal to the sweep' if ok else 'DIFFERS from the sweep'}"
                     f"{'' if bad is None else f', NaN in lane {bad[0]} only'}")
        if not ok:
            raise AssertionError(lines[-1])
        print(lines[-1], flush=True)
    for G, b, kind in ((5, 169, "singular"), (8, 256, "ties"), (2, 512, "random"),
                       (2, 1024, "singular"), (2, 1547, "singular")):
        A = hadamard(rng, G, b, dev) if kind == "ties" else invertible(rng, G, b, dev)
        if kind == "singular":
            A[1] = 0.0
        K, pk = gj(A, pivots=True)
        P, pp = linalg.gj_inverse_plain(A, return_pivots=True)
        torch.cuda.synchronize()
        ok = bool(torch.equal(pk, pp)) and same_bits(K, P)
        if kind == "ties":
            ok = ok and bool(torch.equal(K @ A, torch.eye(b, device=dev).expand_as(A)))
        lines.append(f"gj_inverse ({G},{b},{b}) {kind} [{gj.name_of(G, b)}]: "
                     f"{'same pivots, NaN places and bits' if ok else 'DIFFERS from plain'}")
        if not ok:
            raise AssertionError(lines[-1])
        print(lines[-1], flush=True)
    return lines


def ms_a_call(fn, reps: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def sessions(fn, calls: int, n: int) -> list[int]:
    """The kernel records of each of n profiler sessions of ``calls``
    calls of ``fn`` (each call launches one kernel)."""
    from torch.profiler import ProfilerActivity
    counts = []
    for _ in range(n):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        counts.append(sum(1 for e in prof.profiler.kineto_results.events()
                          if e.device_type() == torch.autograd.DeviceType.CUDA))
    return counts


def gap(fn, reps: int) -> dict:
    """A call's time, one call at a time (CUDA events; the SM clock sampled
    beside the loop), the device time as chip_smoke.device_ms reads it, and
    how many of 5 calls' kernel records each of 8 profiler sessions brought
    back (the records the profiler drops read as a gap between a call and
    its device time)."""
    import chip_smoke
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    ev = []
    with Clocks() as clocks:
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ev.append(a.elapsed_time(b))
    return {"event_ms": ev, "device_ms": chip_smoke.device_ms(fn, reps),
            "records_of_5_calls": sessions(fn, 5, 8), "clocks": clocks.summary()}


def library_chol(H):
    L = torch.linalg.cholesky(H)
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device).expand_as(H)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def timing(versions: dict, make, library, shapes, reps_of) -> dict:
    import chip_smoke
    rng = np.random.default_rng(1)
    result = {}
    for G, n in shapes:
        X = make(rng, G, n)
        reps = reps_of(G, n)
        row = {"ms": {}, "device_ms": {}, "variant": {}}
        order = list(versions) + list(reversed(versions))
        for name in order:
            ms = ms_a_call(lambda: versions[name](X), reps)
            row["ms"][name] = min(ms, row["ms"].get(name, ms))
        for name, k in versions.items():
            row["device_ms"][name] = chip_smoke.device_ms(lambda: k(X), reps)
            row["variant"][name] = k.name_of(G, n)
        row["yardstick_ms"] = ms_a_call(lambda: library(X), reps)
        row["yardstick_device_ms"] = chip_smoke.device_ms(lambda: library(X), reps)
        result[f"({G},{n},{n})"] = row
        print(f"({G},{n},{n}): {json.dumps(row)}", flush=True)
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_port_large_kernels: no CUDA device", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    quick = "--quick" in args
    earlier = Path(args[args.index("--earlier") + 1]) if "--earlier" in args else None
    print(smi("name,power.limit"), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    csrc = _kernels.CSRC_DIR
    sources = {"chol": csrc / "chol_tri_inv.cu", "gj": csrc / "gj_inverse.cu"}
    OUT.mkdir(parents=True, exist_ok=True)
    src = sources["chol"].read_text()
    if GRID_MAX_G not in src:
        raise RuntimeError(f"{sources['chol']} does not declare {GRID_MAX_G!r}")
    for name, max_g in (("chol_one_block", "0"), ("chol_grid", "1 << 30")):
        forced = OUT / f"{name}.cu"
        forced.write_text(src.replace(GRID_MAX_G, f"constexpr int kGridMaxG = {max_g};"))
        sources[name] = forced
    if earlier is not None:
        sources["chol_earlier"] = earlier / "racing_lmpc_torch/csrc/chol_tri_inv.cu"
        sources["gj_earlier"] = earlier / "racing_lmpc_torch/csrc/gj_inverse.cu"
    t = time.perf_counter()
    libs = build(sources)
    print(f"built {sorted(libs)} in {time.perf_counter() - t:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    chol = Kernel(libs["chol"], "chol_tri_inv")
    gj = Kernel(libs["gj"], "gj_inverse")
    result = {"card": smi("name,power.limit"), "checks": check(chol, gj, dev)}
    if not quick:
        one_block = Kernel(libs["chol_one_block"], "chol_tri_inv")
        cv = {"shipped": chol, "one_block": one_block}
        gv = {"shipped": gj}
        if earlier is not None:
            cv = {"earlier": Kernel(libs["chol_earlier"], "chol_tri_inv"), **cv}
            gv = {"earlier": Kernel(libs["gj_earlier"], "gj_inverse"), **gv}
        result["chol_tri_inv"] = timing(
            cv, lambda rng, G, n: spd_on(rng, G, n, dev), library_chol,
            ((1, 2048), (4, 2048), (32, 2048), (1, 512), (1, 1024), (4, 1024)),
            lambda G, n: 5 if n > 1024 else 20)
        result["chol_tri_inv dispatch"] = timing(
            {"one_block": one_block, "grid": Kernel(libs["chol_grid"], "chol_tri_inv")},
            lambda rng, G, n: spd_on(rng, G, n, dev), library_chol,
            [(G, n) for n in (512, 1024, 2048) for G in (32, 48, 64, 96)] + [(128, 2048)],
            lambda G, n: 5 if n > 1024 else 20)
        result["gj_inverse"] = timing(
            gv, lambda rng, G, n: invertible(rng, G, n, dev), torch.linalg.inv,
            ((4, 1024), (1, 1024), (1, 512), (16, 256)), lambda G, n: 5 if n >= 1024 else 20)
        rng = np.random.default_rng(2)
        H = spd_on(rng, 1, 2048, dev)
        A = invertible(rng, 4, 1024, dev)
        result["gap"] = {}
        for name, k in cv.items():
            result["gap"][f"chol_tri_inv {name} (1,2048,2048)"] = gap(lambda: k(H), 5)
        result["gap"]["chol_tri_inv wrapper (1,2048,2048)"] = gap(
            lambda: linalg.chol_tri_inv(H), 5)
        for name, k in gv.items():
            result["gap"][f"gj_inverse {name} (4,1024,1024)"] = gap(lambda: k(A), 5)
        result["gap"]["gj_inverse wrapper (4,1024,1024)"] = gap(lambda: linalg.gj_inverse(A), 5)
        for key, row in result["gap"].items():
            print(f"gap {key}: {json.dumps(row)}", flush=True)
    text = json.dumps(result)
    out = ROOT / "chiprun_out" / "large_kernels.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
