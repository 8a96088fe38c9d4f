"""Compensated (double-word) f32 arithmetic for the zoomed QP refinement.

Port of ``racing_lmpc_tpu/ops/compensated.py``: the Veltkamp split, Dekker's
``two_prod``, Knuth's ``two_sum``, the pairwise ``sum_compensated`` tree
(same odd-length zero padding), the double-word products and ``add_dw``,
op for op and in the same order.

These are error-free transformations: their exactness depends on every
product and sum being rounded separately.  Eager PyTorch runs each
elementwise op as its own kernel, so nothing is fused into an FMA; keep this
module eager (no ``torch.compile``), and any CUDA kernel that takes it over
must be built with ``--fmad=false``.
"""

from __future__ import annotations

import torch
from torch import Tensor

_SPLIT = 4097.0  # 2^12 + 1, Veltkamp split constant for f32 (24-bit mantissa)


def _split(a: Tensor) -> tuple[Tensor, Tensor]:
    """Veltkamp split: a = hi + lo exactly, each with <= 12 mantissa bits."""
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a: Tensor, b: Tensor) -> tuple[Tensor, Tensor]:
    """Error-free product: a * b = p + e exactly (Dekker, split-based)."""
    p = a * b
    a1, a2 = _split(a)
    b1, b2 = _split(b)
    e = ((a1 * b1 - p) + a1 * b2 + a2 * b1) + a2 * b2
    return p, e


def two_sum(a: Tensor, b: Tensor) -> tuple[Tensor, Tensor]:
    """Error-free sum (Knuth): a + b = s + e exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def sum_compensated(p: Tensor, dim: int = -1) -> tuple[Tensor, Tensor]:
    """Reduce ``p`` along ``dim`` to a double-word (hi, lo) sum.

    Pairwise TwoSum tree: the value lane is reduced exactly-with-error-
    capture; the captured errors are summed ordinarily (their total is
    O(eps * |sum|), so its rounding is second-order).
    """
    p = torch.movedim(p, dim, -1)
    err = torch.zeros_like(p[..., 0])
    while p.shape[-1] > 1:
        if p.shape[-1] % 2 == 1:
            p = torch.cat([p, torch.zeros_like(p[..., :1])], dim=-1)
        s, e = two_sum(p[..., 0::2], p[..., 1::2])
        err = err + torch.sum(e, dim=-1)
        p = s
    return p[..., 0], err


def matvec_compensated(A: Tensor, x: Tensor) -> tuple[Tensor, Tensor]:
    """A @ x as a double-word (hi, lo) pair, accurate to ~eps^2.

    ``A`` is (..., m, n), ``x`` is (..., n).  Elementwise TwoProd +
    compensated tree reduction; never touches a matmul unit, so it is immune
    to reduced-precision matmul accumulation.
    """
    p, e = two_prod(A, x.unsqueeze(-2))
    hi, lo = sum_compensated(p, dim=-1)
    return hi, lo + torch.sum(e, dim=-1)


def dot_compensated(a: Tensor, b: Tensor) -> tuple[Tensor, Tensor]:
    """a . b over the last axis as a double-word (hi, lo) pair."""
    p, e = two_prod(a, b)
    hi, lo = sum_compensated(p, dim=-1)
    return hi, lo + torch.sum(e, dim=-1)


def add_dw(hi: Tensor, lo: Tensor, b: Tensor) -> tuple[Tensor, Tensor]:
    """(hi + lo) + b as a renormalized double-word pair."""
    s, e = two_sum(hi, b)
    return s, e + lo


def matvec_acc_compensated(A: Tensor, x: Tensor, b: Tensor) -> tuple[Tensor, Tensor]:
    """A @ x + b as a double-word (hi, lo) pair (b exact f32)."""
    hi, lo = matvec_compensated(A, x)
    return add_dw(hi, lo, b)
