"""QP data, scaled residuals, Ruiz equilibration and the OSQP-style ADMM.

Port of ``racing_lmpc_tpu/mpc/qp.py``, batched: every field carries a
leading batch dimension (P (B, n, n), q (B, n), A (B, m, n), l/u (B, m)) and
every reduction, step size and acceptance test is per lane, as under the
reference's ``vmap``:

    minimize    1/2 x' P x + q' x
    subject to  l <= A x <= u

The ADMM backend (``admm_solve``, ``polish``, ``solve_qp``; ``qp.py:129-311``)
runs a fixed number of iterations in ``rho_updates + 1`` chunks, each lane
with its own adaptive ``rho``; every KKT factorization (one a chunk, one for
the polish) is ``ops.linalg.chol_tri_inv``, the hand-written kernel on the
card, where the reference calls ``tri_inv_lower(chol_lower(H))``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from racing_lmpc_torch.ops.linalg import chol_tri_inv

_RUIZ_ITERS = 10
_EQ_RHO_SCALE = 1e3
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


def _tmv(M: Tensor, v: Tensor) -> Tensor:
    """Batched transposed product M' v, (..., m, n) x (..., m) -> (..., n)."""
    return mv(M.transpose(-1, -2), v)


def admm_solve(data: QPData, iters: int = 200, rho: float = 0.1,
               sigma: float = 1e-6, alpha: float = 1.6,
               x0: Tensor | None = None, y0: Tensor | None = None,
               rho_updates: int = 4) -> tuple[Tensor, Tensor, Tensor]:
    """Core ADMM loop on (already scaled) data (``qp.py:129-214``).  Returns
    (x, z, y).

    Runs ``rho_updates + 1`` chunks of ``iters // (rho_updates + 1)``
    iterations; after each chunk every lane rescales its own rho by
    sqrt(r_prim / r_dual) (OSQP's adaptive rule, clipped) and its KKT matrix
    H = P + sigma I + A' diag(rho) A is factored again.  No lane stops early.
    """
    P, q, A, l, u = data
    n = P.shape[-1]
    dtype, device = P.dtype, P.device
    # relative gap test, per lane (the bounds arrive Ruiz-scaled)
    eq_row = torch.isfinite(l) & torch.isfinite(u) & (
        torch.abs(u - l) < 1e-9 * torch.clamp(torch.abs(u) + torch.abs(l), min=1.0))
    I_n = torch.eye(n, dtype=dtype, device=device)
    AT = A.transpose(-1, -2)

    x = q.new_zeros(q.shape) if x0 is None else x0
    z = torch.clamp(mv(A, x), l, u)
    y = l.new_zeros(l.shape) if y0 is None else y0
    rho_s = torch.full(q.shape[:-1], rho, dtype=dtype, device=device)

    n_chunks = rho_updates + 1
    chunk_iters = max(1, iters // n_chunks)
    for _ in range(n_chunks):
        rho_vec = torch.where(eq_row, (rho_s * _EQ_RHO_SCALE)[..., None],
                              rho_s[..., None])
        H = P + sigma * I_n + (AT * rho_vec[..., None, :]) @ A
        Li = chol_tri_inv(H)
        LiT = Li.transpose(-1, -2)
        for _ in range(chunk_iters):
            rhs = sigma * x - q + _tmv(A, rho_vec * z - y)
            x_t = mv(LiT, mv(Li, rhs))
            z_t = mv(A, x_t)
            x_n = alpha * x_t + (1.0 - alpha) * x
            z_a = alpha * z_t + (1.0 - alpha) * z
            z_n = torch.clamp(z_a + y / rho_vec, l, u)
            y = y + rho_vec * (z_a - z_n)
            x, z = x_n, z_n

        # OSQP adaptive-rho rule on relative residuals, per lane
        Ax = mv(A, x)
        r_prim = amax(torch.abs(Ax - z))
        denom_p = torch.maximum(amax(torch.abs(Ax)), amax(torch.abs(z))) + 1e-8
        Px = mv(P, x)
        Aty = _tmv(A, y)
        r_dual = amax(torch.abs(Px + q + Aty))
        denom_d = torch.maximum(torch.maximum(amax(torch.abs(Px)), amax(torch.abs(Aty))),
                                amax(torch.abs(q))) + 1e-8
        ratio = torch.sqrt((r_prim / denom_p) / (r_dual / denom_d + 1e-12))
        rho_s = torch.clamp(rho_s * torch.clamp(ratio, 0.1, 10.0), 1e-6, 1e6)
    return x, z, y


def _kkt_residual(data: QPData, x: Tensor, y: Tensor) -> Tensor:
    """Primal + dual + complementarity residual of (x, y), per lane: the
    polish acceptance measure (``qp.py:258-270``)."""
    P, q, A, l, u = data
    Ax = mv(A, x)
    z = torch.clamp(Ax, l, u)
    rp = amax(torch.abs(Ax - z))
    rd = amax(torch.abs(mv(P, x) + q + _tmv(A, y)))
    up = torch.where(torch.isfinite(u), u, 0.0)
    lo = torch.where(torch.isfinite(l), l, 0.0)
    comp = amax(torch.clamp(y, min=0.0) * torch.where(torch.isfinite(u), torch.abs(up - z), 1.0)
                + torch.clamp(-y, min=0.0) * torch.where(torch.isfinite(l), torch.abs(z - lo), 1.0))
    return rp + rd + comp


def polish(data: QPData, x: Tensor, y: Tensor, delta: float = 1e-6,
           refine_steps: int = 3) -> tuple[Tensor, Tensor]:
    """OSQP-style solution polish (``qp.py:217-273``): the KKT system on the
    active set read from the dual signs, in its SPD penalty form
    (P + delta I + A_act' A_act / delta) x = -q + A_act' b / delta, Jacobi
    scaled, factored once and refined ``refine_steps`` times.  Each lane
    keeps the polished point only if it lowers its full KKT residual; a
    matrix that is not positive definite gives NaN, whose residual compares
    False, so that lane keeps its ADMM iterate."""
    P, q, A, l, u = data
    n = P.shape[-1]
    active = (y < -0.0) | (y > 0.0)
    b = torch.where(y < -0.0, l, torch.where(y > 0.0, u, 0.0))
    b = torch.where(torch.isfinite(b), b, 0.0)
    A_act = A * active.to(A.dtype)[..., None]
    A_actT = A_act.transpose(-1, -2)
    Dp = torch.where(active, 1.0 / delta, 0.0).to(A.dtype)
    I_n = torch.eye(n, dtype=P.dtype, device=P.device)
    H = P + delta * I_n + (A_actT * Dp[..., None, :]) @ A_act
    s = torch.rsqrt(torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-30))
    Li = chol_tri_inv(H * s[..., :, None] * s[..., None, :]) * s[..., None, :]
    LiT = Li.transpose(-1, -2)

    def hsolve(r):
        return mv(LiT, mv(Li, r))

    rhs = -q + mv(A_actT, Dp * b)
    x_pol = hsolve(rhs)
    for _ in range(refine_steps):
        x_pol = x_pol + hsolve(rhs - mv(H, x_pol))
    y_pol = torch.where(active, Dp * (mv(A, x_pol) - b), 0.0)
    better = (_kkt_residual(data, x_pol, y_pol) < _kkt_residual(data, x, y))[..., None]
    return torch.where(better, x_pol, x), torch.where(better, y_pol, y)


def solve_qp(data: QPData, iters: int = 200, rho: float = 0.1,
             sigma: float = 1e-6, alpha: float = 1.6, do_polish: bool = True,
             x0: Tensor | None = None, y0: Tensor | None = None) -> QPSolution:
    """Ruiz scaling -> ADMM -> polish -> unscale + residuals
    (``qp.py:276-311``), per lane, on the data's device.  The port's
    numerics policy (f32, no TF32) stands in for the reference's HIGHEST
    matmul precision."""
    sdata, (D, E, c) = ruiz_equilibrate(data)
    x0s = None if x0 is None else x0 / D
    # inverse of the unscale map y = ys * E / c below
    y0s = None if y0 is None else y0 * c[..., None] / E
    xs, _, ys = admm_solve(sdata, iters=iters, rho=rho, sigma=sigma,
                           alpha=alpha, x0=x0s, y0=y0s)
    if do_polish:
        xs, ys = polish(sdata, xs, ys)
    rp_rel, rd_rel = scaled_residuals(sdata, xs, ys)
    x = xs * D
    y = ys * E / c[..., None]
    Ax = mv(data.A, x)
    z = torch.clamp(Ax, data.l, data.u)
    r_prim = amax(torch.abs(Ax - z))
    Px = mv(data.P, x)
    r_dual = amax(torch.abs(Px + data.q + _tmv(data.A, y)))
    obj = 0.5 * (x * Px).sum(-1) + (data.q * x).sum(-1)
    return QPSolution(x=x, y=y, z=z, r_prim=r_prim, r_dual=r_dual, obj=obj,
                      rp_rel=rp_rel, rd_rel=rd_rel)
