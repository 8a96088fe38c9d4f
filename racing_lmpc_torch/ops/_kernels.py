"""Build and load the port's hand-written CUDA kernel.

The kernel is ``csrc/<name>.cu`` with a plain C entry point, compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library under ``build/`` at
the repository root and bound with ``ctypes`` — no PyTorch headers, so a
build takes seconds.  The library's file name carries a hash of the source
and the flags, so an edited source is rebuilt on first use.  Nothing is
built or loaded when this module is imported: only a CUDA launch asks for a
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
# no --use_fast_math: the kernel keeps IEEE division and sqrt, so a
# non-positive Cholesky pivot gives NaN exactly as the plain version does
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


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


def build(name: str) -> str:
    """Compile kernel ``name`` if its library is missing or stale.  Returns
    the compiler output (``ptxas`` register and shared-memory report; empty
    when nothing was built); raises with that output if nvcc fails."""
    src, lib = _paths(name)
    if lib.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed: {name}: nvcc exited "
                           f"{proc.returncode}\n{log}")
    os.replace(tmp, lib)
    return log


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    build(name)
    return ctypes.CDLL(str(_paths(name)[1]))
