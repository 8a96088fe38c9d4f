"""The yardstick of the kernels: the card's published peaks and the
operations and bytes of each hand-written kernel, from its shapes.

``chol_tri_inv`` (G matrices of n x n, f32): it must read each symmetric
input's lower triangle once and write each dense L^-1 once,
4 G (n (n + 1) / 2 + n^2) bytes, and do 2/3 n^3 flops a matrix (n^3 / 3 for
the factor, n^3 / 3 for the inverse).  Its least time on the card is the
larger of flops over the f32 peak (outside the tensor cores: the port keeps
TF32 off) and bytes over the memory bandwidth.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks(kind: str) -> dict | None:
    """The published peaks of the card named ``kind`` (its whole name, as
    ``torch.cuda.get_device_name()`` gives it), or None."""
    return json.loads(PEAKS.read_text())["cards"].get(kind)


def chol_tri_inv_flops(G: int, n: int) -> float:
    return G * 2.0 / 3.0 * n ** 3


def chol_tri_inv_bytes(G: int, n: int) -> float:
    return 4.0 * G * (n * (n + 1) / 2 + n * n)


def chol_tri_inv_bound_s(G: int, n: int, card: dict) -> float:
    """The least time one call can take on ``card``."""
    return max(chol_tri_inv_flops(G, n) / card["f32_flops_per_s"],
               chol_tri_inv_bytes(G, n) / card["hbm_bytes_per_s"])
