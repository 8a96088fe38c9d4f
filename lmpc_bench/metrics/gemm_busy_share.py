"""The share of the device's busy time spent in library products (cuBLAS
GEMM and GEMV kernels: the f64 normal equations A'DA and the f32 products of
the IPM and of the QP build), by kernel names matching a line of
``gemm_kernels.txt``."""

from pathlib import Path

PATTERNS = [p.strip().lower() for p in
            (Path(__file__).with_name("gemm_kernels.txt")).read_text().splitlines()
            if p.strip() and not p.startswith("#")]


def read(ctx):
    if ctx.trace is None:
        return None
    busy = sum(sec for _, sec in ctx.trace.rows.values())
    gemm = sum(sec for name, (_, sec) in ctx.trace.rows.items()
               if any(p in name.lower() for p in PATTERNS))
    return gemm / busy if busy else None
