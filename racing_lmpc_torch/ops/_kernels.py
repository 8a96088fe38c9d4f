"""Build and load the port's hand-written CUDA kernels.

Each kernel is ``csrc/<name>.cu`` with a plain C entry point, compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library under ``build/`` at
the repository root and bound with ``ctypes`` — no PyTorch headers, so a
build takes seconds.  The library's file name carries a hash of the source
and the flags, so an edited source is rebuilt on first use.  ``build``
starts one ``nvcc`` per source that needs it, all at once.  Nothing is built
or loaded when this module is imported: only a CUDA launch asks for a
library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
# no --use_fast_math: the kernels keep IEEE division and sqrt, so a zero or
# non-positive pivot gives inf/NaN exactly as the plain versions do
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def names() -> list[str]:
    """Every kernel source of the port."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _paths(name: str) -> tuple[Path, Path]:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}_{digest}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME) to build "
                           "the port's kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build(*kernels: str) -> dict[str, str]:
    """Compile the named kernels (all of them when none is named) whose
    library is missing or stale, one ``nvcc`` each, run side by side.
    Returns each built kernel's compiler output (the ``ptxas`` register and
    shared-memory report); raises with that output if an nvcc fails."""
    jobs = {}
    for name in kernels or names():
        src, lib = _paths(name)
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        jobs[name] = (tmp, lib, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, lib, proc) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{logs[name]}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    build(name)
    return ctypes.CDLL(str(_paths(name)[1]))
