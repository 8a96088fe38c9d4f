"""PyTorch + CUDA port of the racing LMPC engine, for an NVIDIA H100.

The JAX package ``racing_lmpc_tpu`` is the reference; this package mirrors
its module names and layout so that each port module sits at the path of
its counterpart.  Inside it is plain PyTorch: functions take tensors with an
explicit leading batch dimension where the reference used ``vmap``, and
Python loops where it used ``lax.scan``/``fori_loop``/``while_loop``.  The
TPU kernel of the solve paths (``ops/pallas_linalg.py::
chol_tri_inv_fused``, the IPM's and the ADMM's KKT factorization) is a
hand-written Hopper kernel, ``csrc/chol_tri_inv.cu``, behind
``ops.linalg.chol_tri_inv``.

Numerics policy (asserted by ``chip_smoke.py``): f32 everywhere, and every
f32 matmul at full precision (no TF32) — the reference runs every solve at
HIGHEST matmul precision (``racing_mpc.py:581-586``, ``ipm.py:531-536``),
and reduced-precision products leave 21-30% of its QPs unconverged.  One
product accumulates in float64 and is rounded to f32: the IPM's normal
equations A'DA (``mpc.ipm.NORMAL_EQ_DTYPE``), whose f32 rounding on the
card measurably loses accuracy.

This package imports neither JAX nor anything of ``racing_lmpc_tpu``; it
reads the reference's data files (params, tracks, safe-set laps) by path.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

torch.set_default_dtype(torch.float32)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    Raises when CUDA is asked for (explicitly or by default) and missing —
    there is no silent fall back to the CPU; tests pass ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "racing_lmpc_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain CPU path")
    return dev


__all__ = ["resolve_device"]
