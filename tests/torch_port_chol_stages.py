"""Where the time of ``chol_tri_inv``'s wide variant (n > 240) goes, on the
card.

    python3 tests/torch_port_chol_stages.py [other.cu ...]

Builds ``racing_lmpc_torch/csrc/chol_tri_inv.cu``, and each other version of
it given (an earlier commit's, say), with the port's nvcc flags into
``build/chol_stages/``, each twice: as it is, and as a copy with a clock64()
stamp after every barrier of the wide kernel, added up by thread 0 of block
0 (the source itself is not changed).  Each build is held bit for bit to
``chol_tri_inv_sweep`` at the wide sizes, and must give NaN in an
indefinite lane only.  Then at (1,275,275), (1,244,244), (32,275,275) and
(1,512,512): each version's ms a call (CUDA events around each call,
synchronized, median of 30, the versions in turns) and on the device (the
profiler), the ``torch.linalg`` yardstick's, and the stamped copy's cycles
between barriers, summed over the panels and averaged over 10 calls.  In
the shipped kernel the barriers close: the load beside the first panel's
S1 and S2 ("b1"), each panel's S3 ("b2"), each panel's S4 beside the next
panel's S1 and S2 ("b3"); "end" is the last panel's rows written out.
Sources with the grid variant run it at (1,512,512) (batches of at most 32
past n = 302), which carries no stamps.
Prints the card's name and power limit first and one JSON line last.
Needs one GPU; imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from racing_lmpc_torch.ops import _kernels, linalg  # noqa: E402

OUT = _kernels.BUILD_DIR / "chol_stages"
# the wide kernel's parameters, as the shipped source and as sources before
# its UT workspace declare them
SIGNATURES = ("chol_tri_inv_wide_kernel(const float* __restrict__ H, float* out, float* ut_ws, "
              "int n)\n{",
              "chol_tri_inv_wide_kernel(const float* __restrict__ H, float* out, int n)\n{")
SIZES = (241, 244, 256, 274, 275, 288, 301, 302, 303, 320, 336, 337, 400, 512, 1024)
SHAPES = ((1, 275), (1, 244), (32, 275), (1, 512))


def stamped(src: str) -> str:
    """``src`` with a clock64() stamp after each barrier of the wide kernel
    and at its end, and C entry points to zero and read the sums."""
    s = src.replace("namespace {\n", "namespace {\n__device__ unsigned long long g_clk[8];\n", 1)
    k0 = next(s.index(sig) for sig in SIGNATURES if sig in s)
    body = s.index("{", k0) + 1
    end = s.index("// n = 1: one thread a matrix", k0)
    kernel = s[body:end]
    last = kernel.rindex("}")
    parts = kernel[:last].split("__syncthreads();")
    out = ("\n    long long t_prev = clock64();\n#define STAMP(S_) if (threadIdx.x == 0 && "
           "blockIdx.x == 0) { long long t_ = clock64(); g_clk[S_] += t_ - t_prev; "
           "t_prev = t_; }\n" + parts[0])
    for i, part in enumerate(parts[1:]):
        out += f"__syncthreads(); STAMP({i});" + part
    out += f"    STAMP({len(parts) - 1});\n" + kernel[last:]
    s = s[:body] + out + s[end:]
    return (s + '\nextern "C" int read_clk(unsigned long long* h) '
            '{ return (int)cudaMemcpyFromSymbol(h, g_clk, sizeof(g_clk)); }\n'
            'extern "C" int zero_clk() { unsigned long long z[8] = {0}; '
            'return (int)cudaMemcpyToSymbol(g_clk, z, sizeof(z)); }\n')


def build(sources: dict[str, Path]) -> dict[str, ctypes.CDLL]:
    """One nvcc a library, all side by side; each library prepared."""
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
        cur = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                cur = line.split("'")[1]
            elif cur and "wide_kernel" in cur and ("registers" in line or "spill" in line):
                print(f"  {name} wide<{'shared' if 'ILb1' in cur else 'device memory'}>: "
                      f"{line.strip()}", flush=True)
        L = ctypes.CDLL(str(lib))
        # sources with the UT workspace take its pointer before the stream;
        # those with a variant query size it by (G, n), a launch's floats,
        # earlier ones by n, a matrix's
        L.takes_ws = hasattr(L, "chol_tri_inv_workspace_floats")
        if L.takes_ws:
            L.by_batch = hasattr(L, "chol_tri_inv_variant")
            L.chol_tri_inv_workspace_floats.argtypes = [ctypes.c_int] * (2 if L.by_batch else 1)
            L.chol_tri_inv_workspace_floats.restype = ctypes.c_longlong
        L.chol_tri_inv_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int] + [ctypes.c_void_p] * (2 if L.takes_ws else 1)
        L.chol_tri_inv_f32.restype = ctypes.c_int
        if L.chol_tri_inv_prepare() != 0:
            raise RuntimeError(f"{name}: chol_tri_inv_prepare failed")
        libs[name] = L
    return libs


def call(L, H):
    out = torch.empty_like(H)
    G, n = H.shape[0], H.shape[-1]
    ws = ()
    if L.takes_ws:
        fn = L.chol_tri_inv_workspace_floats
        floats = fn(G, n) if L.by_batch else G * fn(n)
        buf = torch.empty(floats, device=H.device) if floats else None
        ws = (buf.data_ptr() if buf is not None else None,)
    err = L.chol_tri_inv_f32(H.data_ptr(), out.data_ptr(), G, n, *ws,
                             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return out


def spd(rng, G, n):
    A = rng.normal(size=(G, n, n)).astype(np.float32)
    return (np.einsum("bij,bik->bjk", A, A) + n * np.eye(n, dtype=np.float32)).astype(np.float32)


def same_bits(a, b) -> bool:
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b)) and torch.equal(
        torch.where(nan, 0.0, a).view(torch.int32), torch.where(nan, 0.0, b).view(torch.int32)))


def ms_a_call(fn, reps=30) -> float:
    for _ in range(3):
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


def device_ms(fn, reps=20) -> float:
    from torch.profiler import ProfilerActivity
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / reps


def library(H):
    L = torch.linalg.cholesky(H)
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device).expand_as(H)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_port_chol_stages: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    versions = {"shipped": _kernels.CSRC_DIR / "chol_tri_inv.cu"}
    versions.update({Path(a).stem: Path(a) for a in sys.argv[1:]})
    sources = dict(versions)
    OUT.mkdir(parents=True, exist_ok=True)
    for name, src in versions.items():
        sources[f"{name}_stamped"] = OUT / f"{name}_stamped.cu"
        sources[f"{name}_stamped"].write_text(stamped(src.read_text()))
    t = time.perf_counter()
    libs = build(sources)
    print(f"built {sorted(libs)} in {time.perf_counter() - t:.1f} s", flush=True)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    for n in SIZES:
        H = torch.as_tensor(spd(rng, 1 if n == 1024 else 4, n), device=dev)
        S = linalg.chol_tri_inv_sweep(H)
        for name, L in libs.items():
            if not same_bits(call(L, H), S):
                raise AssertionError(f"{name}: not bit-equal to the sweep mirror at n={n}")
    for G, n, lane, pivot in ((4, 275, 2, 100), (4, 302, 1, 250), (2, 512, 1, 40)):
        Hn = spd(rng, G, n)
        Hn[lane, pivot, pivot] = -1.0e4
        H = torch.as_tensor(Hn, device=dev)
        S = linalg.chol_tri_inv_sweep(H)
        for name, L in libs.items():
            K = call(L, H)
            bad = (~torch.isfinite(K).flatten(1).all(dim=1)).tolist()
            if not (same_bits(K, S) and bad == [i == lane for i in range(G)]):
                raise AssertionError(f"{name}: indefinite lane {lane} of ({G},{n})")
    print(f"every build bit-equal to the sweep mirror at n = {SIZES}, NaN in the "
          f"indefinite lane only", flush=True)

    result = {}
    for G, n in SHAPES:
        H = torch.as_tensor(spd(rng, G, n), device=dev)
        row = {"ms": {}, "device_ms": {}, "cycles": {}}
        order = list(versions) + list(reversed(versions))
        for name in order:
            ms = ms_a_call(lambda: call(libs[name], H))
            row["ms"][name] = min(ms, row["ms"].get(name, ms))
        for name in versions:
            row["device_ms"][name] = device_ms(lambda: call(libs[name], H))
            L = libs[f"{name}_stamped"]
            call(L, H)
            torch.cuda.synchronize()
            L.zero_clk()
            for _ in range(10):
                call(L, H)
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 8)()
            L.read_clk(buf)
            cyc = [v / 10 for v in buf]
            last = max(i for i, v in enumerate(cyc) if v) if any(cyc) else 0
            row["cycles"][name] = {**{f"b{i + 1}": cyc[i] for i in range(last)},
                                   "end": cyc[last], "total": sum(cyc)}
        row["yardstick_ms"] = ms_a_call(lambda: library(H))
        row["yardstick_device_ms"] = device_ms(lambda: library(H))
        result[f"({G},{n},{n})"] = row
        print(f"({G},{n},{n}): {json.dumps(row)}", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
