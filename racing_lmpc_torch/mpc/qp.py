"""QP data, solution record, scaled residuals and Ruiz equilibration.

Port of ``racing_lmpc_tpu/mpc/qp.py:46-126``, batched: every field carries a
leading batch dimension (P (B, n, n), q (B, n), A (B, m, n), l/u (B, m)) and
every reduction is per lane.  The ADMM backend (``qp.py:129-311``) is not
on the default ``qp_method="ipm"`` path and is not ported yet.

    minimize    1/2 x' P x + q' x
    subject to  l <= A x <= u
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

_RUIZ_ITERS = 10
_MIN_SCALING = 1e-4
_MAX_SCALING = 1e4


class QPData(NamedTuple):
    P: Tensor   # (B, n, n) symmetric PSD cost
    q: Tensor   # (B, n)
    A: Tensor   # (B, m, n) constraint matrix
    l: Tensor   # (B, m) lower bounds (-inf allowed)
    u: Tensor   # (B, m) upper bounds (+inf allowed)


class QPSolution(NamedTuple):
    x: Tensor          # (B, n) primal solution
    y: Tensor          # (B, m) dual solution
    z: Tensor          # (B, m) constraint values A x (projected)
    r_prim: Tensor     # (B,) final primal residual (inf-norm, unscaled data)
    r_dual: Tensor     # (B,) final dual residual (inf-norm, unscaled data)
    obj: Tensor        # (B,) objective value
    rp_rel: Tensor     # (B,) relative primal residual on the SCALED problem
    rd_rel: Tensor     # (B,) relative dual residual on the SCALED problem


def mv(M: Tensor, v: Tensor) -> Tensor:
    """Batched matrix-vector product (..., m, n) x (..., n) -> (..., m)."""
    return torch.matmul(M, v.unsqueeze(-1)).squeeze(-1)


def amax(v: Tensor) -> Tensor:
    """Per-lane max over the last axis."""
    return torch.amax(v, dim=-1)


def scaled_residuals(sdata: QPData, xs: Tensor, ys: Tensor) -> tuple[Tensor, Tensor]:
    """OSQP-style *scaled termination* residuals, per lane: residuals on the
    Ruiz-equilibrated problem with the OSQP relative denominators
    max(|Ax|,|z|) / max(|Px|,|A'y|,|q|) (see ``qp.py:65-86``)."""
    Axs = mv(sdata.A, xs)
    zs = torch.clamp(Axs, sdata.l, sdata.u)
    rp = amax(torch.abs(Axs - zs))
    rp_rel = rp / (torch.maximum(amax(torch.abs(Axs)), amax(torch.abs(zs))) + 1.0)
    Pxs = mv(sdata.P, xs)
    Atys = mv(sdata.A.transpose(-1, -2), ys)
    rd = amax(torch.abs(Pxs + sdata.q + Atys))
    rd_rel = rd / (torch.maximum(
        torch.maximum(amax(torch.abs(Pxs)), amax(torch.abs(Atys))),
        amax(torch.abs(sdata.q))) + 1.0)
    return rp_rel, rd_rel


def ruiz_equilibrate(data: QPData):
    """Modified Ruiz equilibration of the (P, q, A) data, OSQP-style, per lane.

    Returns scaled data plus (D, E, c): x = D x_bar, y = c^{-1} E y_bar.
    """
    P, q, A = data.P, data.q, data.A
    D = torch.ones_like(q)
    E = torch.ones_like(data.l)
    c = torch.ones_like(q[..., 0])
    for _ in range(_RUIZ_ITERS):
        # column norms of the KKT blocks
        d_x = torch.sqrt(torch.clamp(torch.maximum(
            torch.amax(torch.abs(P), dim=-2), torch.amax(torch.abs(A), dim=-2)),
            min=_MIN_SCALING))
        d_z = torch.sqrt(torch.clamp(torch.amax(torch.abs(A), dim=-1),
                                     min=_MIN_SCALING))
        d_x = torch.clamp(1.0 / d_x, 1.0 / _MAX_SCALING, _MAX_SCALING)
        d_z = torch.clamp(1.0 / d_z, 1.0 / _MAX_SCALING, _MAX_SCALING)
        P = P * d_x[..., :, None] * d_x[..., None, :]
        q = q * d_x
        A = A * d_z[..., :, None] * d_x[..., None, :]
        # cost normalization
        mean_pcol = torch.mean(torch.amax(torch.abs(P), dim=-2), dim=-1)
        inf_q = amax(torch.abs(q))
        gamma = 1.0 / torch.clamp(torch.maximum(mean_pcol, inf_q), min=_MIN_SCALING)
        gamma = torch.clamp(gamma, 1.0 / _MAX_SCALING, _MAX_SCALING)
        P = P * gamma[..., None, None]
        q = q * gamma[..., None]
        D, E, c = D * d_x, E * d_z, c * gamma
    l = torch.where(torch.isfinite(data.l), data.l * E, data.l)
    u = torch.where(torch.isfinite(data.u), data.u * E, data.u)
    return QPData(P, q, A, l, u), (D, E, c)
