"""Batched primal-dual interior-point QP solver (Mehrotra predictor-corrector).

Port of ``racing_lmpc_tpu/mpc/ipm.py:95-769`` with an explicit leading batch
dimension where the reference runs under ``vmap``:

    minimize    1/2 x' P x + q' x
    subject to  l <= A x <= u        (the rows ``eq_rows`` are equalities)

- each Newton step solves the condensed KKT by a Cholesky-inverse of the
  Jacobi-scaled ``H = P + reg I + A' D A`` and of the tiny Schur block
  ``Ae H^-1 Ae' + delta I`` — both through ``ops.linalg.chol_tri_inv``,
  the hand-written kernel on the card (``ipm.py:202-231``);
- fixed iteration count with the best-iterate safeguard, the NaN guard, the
  adaptive regularization and the penalty polish (``ipm.py:255-522``);
- then the zoom ladder of refinement rounds in double-word f32
  (``ipm.py:541-769``).  The reference's ``lax.while_loop`` runs under
  ``vmap`` while any lane is active and freezes finished lanes; here a
  per-lane ``active`` mask does the same with ``torch.where``, and the
  ``any()`` over it synchronizes with the host before each round.  The
  Newton loop itself never synchronizes with the host; the other sites that
  do (the row structure's index uploads, each equality mask's scalar copied
  from the host) are counted in ``racing_lmpc_torch.spans.host_syncs`` and
  sit in spans named ``*_sync``, as every phase sits in a span of its own.

Every constant and every safeguard is the reference's; see its comments for
the measurements behind them.  A caller without ``eq_rows`` (the MPC path
always passes them) gets the reference's other branch (``ipm.py:313-330``):
the equality rows found from the bounds lane by lane, and each Newton
system solved by a pivoted LU of the full (n + m) KKT with one refinement
round.  The reference factors it with ``jax.scipy.linalg.lu_factor``, a
library LU and not a TPU kernel, so the port calls torch's
(``torch.linalg.lu_factor_ex`` / ``lu_solve``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

from racing_lmpc_torch.mpc.qp import (
    QPData, QPSolution, amax, mv, ruiz_equilibrate, scaled_residuals)
from racing_lmpc_torch.ops.compensated import (
    dot_compensated, matvec_compensated, two_sum)
from racing_lmpc_torch.ops.linalg import chol_tri_inv
from racing_lmpc_torch.spans import count_sync, span

_EPS = 1e-10
_MU_FLOOR = 1e-7
_RIDGE_REL = 1e-6
_GAIN_SMALL = 1e-5
_ZOOM_STEP = 1e3
_ZOOM_MAX = 1e6
_EXIT_ATOL = 1e-6
_C_TR = 1e3
_D_CAP = 1e6
_REG_MIN = 1e-6
_REG_MAX = 1e-1
# The normal-equations product A' D A is the solve's precision-critical op
# (the reference keeps it at HIGHEST, racing_lmpc_tpu/mpc/ipm.py:187-191):
# the barrier weights D span many decades, and the product's rounding sets
# how well the cost-flat steering directions are resolved.  Rounded in f32
# by cuBLAS on an H100 it left the shipped N=40 configuration outside the
# reference's own spread of accuracy (PERF.md), so it accumulates in
# float64 and is rounded once to the working f32.
NORMAL_EQ_DTYPE = torch.float64


class _Rows(NamedTuple):
    """The QP's static row structure, on the host (shapes, contiguity
    checks) and on the device (every gather and scatter, so that no index
    array is copied to the device inside the iteration)."""
    eq: np.ndarray | None   # equality rows; None: found from the bounds
    struct: tuple | None    # (dense_rows, nc, diag_rows, diag_cols)
    eq_t: Tensor | None
    struct_t: tuple | None

    @classmethod
    def make(cls, eq_rows, struct, device):
        def idx(a):
            count_sync()    # a copy from pageable host memory: the host waits
            return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)
        if eq_rows is None:         # the row structure needs the eq rows
            return cls(None, None, None, None)
        eq = np.asarray(eq_rows, dtype=np.int64)
        struct_t = None if struct is None else (
            idx(struct[0]), int(struct[1]), idx(struct[2]), idx(struct[3]))
        return cls(eq, struct, idx(eq), struct_t)


def _sel(cond: Tensor, new: Tensor, old: Tensor) -> Tensor:
    """Per-lane select: ``cond`` (B,) picks whole lanes of ``new``/``old``."""
    return torch.where(cond.reshape(cond.shape + (1,) * (new.dim() - 1)),
                       new, old)


def _all_finite(v: Tensor) -> Tensor:
    return torch.all(torch.isfinite(v), dim=-1)


def _struct_matvecs(A: Tensor, rows: _Rows, n: int, m: int):
    """Structured (Amv, ATmv) closures for the MPC QP's row layout.

    The MPC QP's rows are three contiguous blocks (``RacingMPC.qp_struct``):
    dense rows touching only the leading nc columns, one-hot lambda rows,
    and the equality rows.  Numerically identical to the dense products (the
    dropped terms are exact zeros); falls back to dense A when the
    contiguity invariants do not hold.
    """
    At = A.transpose(-1, -2)

    def Amv(x):
        return mv(A, x)

    def ATmv(w):
        return mv(At, w)

    if rows.struct is not None:
        dr, nc, dgr, dgc = (np.asarray(rows.struct[0]), int(rows.struct[1]),
                            np.asarray(rows.struct[2]), np.asarray(rows.struct[3]))
        eq_rows = rows.eq
        md, Kd, me = len(dr), len(dgr), len(eq_rows)
        lam0 = int(dgc[0]) if Kd else 0
        contig = (
            np.array_equal(dr, np.arange(md))
            and np.array_equal(dgr, np.arange(md, md + Kd))
            and np.array_equal(eq_rows, np.arange(md + Kd, md + Kd + me))
            and md + Kd + me == m
            and (not Kd or np.array_equal(dgc, lam0 + np.arange(Kd))))
        if contig:
            Ad = A[:, :md, :nc]
            AdT = Ad.transpose(-1, -2)
            adiag = A[:, md:md + Kd, lam0:lam0 + Kd].diagonal(dim1=-2, dim2=-1)
            Ae = A[:, md + Kd:]
            AeT = Ae.transpose(-1, -2)

            def Amv(x):                                      # noqa: F811
                parts = [mv(Ad, x[:, :nc])]
                if Kd:
                    parts.append(adiag * x[:, lam0:lam0 + Kd])
                if me:
                    parts.append(mv(Ae, x))
                return torch.cat(parts, dim=-1)

            def ATmv(w):                                     # noqa: F811
                out = torch.zeros(w.shape[:-1] + (n,), dtype=w.dtype,
                                  device=w.device)
                out[:, :nc] = mv(AdT, w[:, :md])
                if Kd:
                    out[:, lam0:lam0 + Kd] = adiag * w[:, md:md + Kd]
                if me:
                    out = out + mv(AeT, w[:, md + Kd:])
                return out
    return Amv, ATmv


def _condensed_solver_factory(P: Tensor, A: Tensor, rows: _Rows, delta: float):
    """Pivot-free Newton-KKT solver factory for the condensed MPC QP.

    With the equality rows known statically the Newton KKT
    ``[[H, Ae'], [Ae, -delta I]]`` is solved through ``L^-1`` of the
    Jacobi-scaled H and of the Schur complement ``S = Ae H^-1 Ae' + delta I``.
    Returns ``make_solver(D, delta_p)``, D the (B, m) barrier/penalty row
    weights and delta_p the (B,) or scalar proximal lift; the returned
    ``solve(r1, r2, refine=True)`` solves the KKT with one f32
    iterative-refinement round against the clipped system.
    """
    n = P.shape[-1]
    m = A.shape[-2]
    dtype, device = P.dtype, P.device
    I_n = torch.eye(n, dtype=dtype, device=device)
    eq_rows = rows.eq_t
    Ae = A[:, eq_rows]                                   # (B, me, n)
    AeT = Ae.transpose(-1, -2)
    me = len(rows.eq)
    I_me = torch.eye(me, dtype=dtype, device=device)

    acc = NORMAL_EQ_DTYPE
    struct = rows.struct_t
    if struct is None:
        A_acc = A.to(acc)
    else:
        dense_rows, nc, diag_rows, diag_cols = struct
        Ad_acc = A[:, dense_rows][:, :, :nc].to(acc)     # (B, md, nc)
        a_diag2 = torch.square(A[:, diag_rows, diag_cols])

    def form_AtDA(Dc):
        if struct is None:
            return torch.matmul(A_acc.transpose(-1, -2) * Dc.to(acc)[:, None, :],
                                A_acc).to(dtype)
        Hd = torch.matmul(Ad_acc.transpose(-1, -2) * Dc[:, dense_rows].to(acc)[:, None, :],
                          Ad_acc).to(dtype)
        dvec = torch.zeros(Dc.shape[:-1] + (n,), dtype=dtype, device=device)
        if len(diag_cols):
            dvec[:, diag_cols] = Dc[:, diag_rows] * a_diag2
        H = torch.diag_embed(dvec)
        H[:, :nc, :nc] += Hd
        return H

    def make_solver(D, delta_p=_REG_MIN):
        Dc = torch.clamp(D, max=_D_CAP)
        dp = delta_p.reshape(-1, 1, 1) if torch.is_tensor(delta_p) else delta_p
        H = P + dp * I_n + form_AtDA(Dc)
        # Jacobi pre-scaling: H = S^-1 Hs S^-1 with S = rsqrt(diag H)
        s = torch.rsqrt(torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1),
                                    min=1e-30))
        Hs = H * s[:, :, None] * s[:, None, :]
        Li = chol_tri_inv(Hs) * s[:, None, :]            # L^-1 S
        LiT = Li.transpose(-1, -2)

        if me == 0:
            def solve(r1, r2, refine=True):
                x = mv(LiT, mv(Li, r1))
                if refine:
                    rx = r1 - mv(H, x)
                    x = x + mv(LiT, mv(Li, rx))
                return x, torch.zeros_like(r2)
            return solve

        T = torch.matmul(Li, AeT)                        # (S L)^-1 Ae'
        TT = T.transpose(-1, -2)
        S_sc = torch.matmul(TT, T) + delta * I_me
        Lsi = chol_tri_inv(S_sc)
        LsiT = Lsi.transpose(-1, -2)

        def kkt_solve(r1, r2c):
            z = mv(Li, r1)
            y = mv(LsiT, mv(Lsi, mv(TT, z) - r2c))
            x = mv(LiT, z - mv(T, y))
            return x, y

        def solve(r1, r2, refine=True):
            r2c = r2[:, eq_rows]
            x, y = kkt_solve(r1, r2c)
            if refine:
                rx = r1 - (mv(H, x) + mv(AeT, y))
                ry = r2c - (mv(Ae, x) - delta * y)
                x2, y2 = kkt_solve(rx, ry)
                x, y = x + x2, y + y2
            dy = torch.zeros_like(r2)
            dy[:, eq_rows] = y
            return x, dy
        return solve

    return make_solver


def _lu_solver_factory(P: Tensor, A: Tensor, is_eq: Tensor, delta: float):
    """Newton-KKT solver factory without known equality rows
    (``ipm.py:313-330``): ``make_solver(D, delta_p)`` factors the full KKT
    ``[[H, Aeq'], [Aeq, -diag(delta on eq rows, 1 elsewhere)]]`` with
    ``H = P + (delta + delta_p) I + A' D A`` by a pivoted LU; ``solve``
    runs one refinement round against it.  ``is_eq`` (B, m) marks each
    lane's equality rows (the others get trivial rows, keeping K full-rank).
    A singular K gives non-finite steps, which the NaN guard rejects."""
    n = P.shape[-1]
    dtype, device = P.dtype, P.device
    I_n = torch.eye(n, dtype=dtype, device=device)
    A_eq = A * is_eq.to(dtype)[..., None]
    A_eqT = A_eq.transpose(-1, -2)
    kkt_22 = torch.diag_embed(-torch.where(is_eq, delta, 1.0).to(dtype))
    acc = NORMAL_EQ_DTYPE
    A_acc = A.to(acc)

    def make_solver(D, delta_p=_REG_MIN):
        dp = delta_p.reshape(-1, 1, 1) if torch.is_tensor(delta_p) else delta_p
        AtDA = torch.matmul(A_acc.transpose(-1, -2) * D.to(acc)[:, None, :],
                            A_acc).to(dtype)
        H = P + (delta + dp) * I_n + AtDA
        K = torch.cat([torch.cat([H, A_eqT], dim=-1),
                       torch.cat([A_eq, kkt_22], dim=-1)], dim=-2)
        LU, piv, _ = torch.linalg.lu_factor_ex(K)

        def lu(rhs):
            return torch.linalg.lu_solve(LU, piv, rhs[..., None])[..., 0]

        def kmv(v):
            vx, vy = v[:, :n], v[:, n:]
            return torch.cat([mv(H, vx) + mv(A_eqT, vy),
                              mv(A_eq, vx) + mv(kkt_22, vy)], dim=-1)

        def solve(r1, r2, refine=True):
            rhs = torch.cat([r1, torch.where(is_eq, r2, 0.0)], dim=-1)
            s0 = lu(rhs)
            s0 = s0 + lu(rhs - kmv(s0))     # one refinement round for f32
            return s0[:, :n], s0[:, n:]
        return solve

    return make_solver


def _ipm_core(data: QPData, iters: int, delta: float, rows: _Rows,
              do_polish: bool = True):
    """IPM on (scaled) data.  Returns (x, y) with y the OSQP-convention dual
    (y = z_u - z_l, positive on active upper bounds), per lane."""
    P, q, A, l, u = data
    B, n = q.shape
    m = l.shape[-1]
    dtype = P.dtype

    finite_l = torch.isfinite(l)
    finite_u = torch.isfinite(u)
    if rows.eq is None:
        # relative gap test: the bounds arrive Ruiz-scaled
        is_eq = finite_l & finite_u & (
            torch.abs(u - l) < 1e-9 * torch.clamp(torch.abs(u) + torch.abs(l), min=1.0))
    else:
        is_eq = torch.zeros(m, dtype=torch.bool, device=P.device)
        with span("ipm.eq_mask_sync"):
            count_sync()    # the scalar True is copied from the host: the host waits
            is_eq[rows.eq_t] = True
        is_eq = is_eq.expand(B, m)
    has_l = finite_l & ~is_eq
    has_u = finite_u & ~is_eq
    n_barrier = torch.clamp(has_l.sum(-1) + has_u.sum(-1), min=1).to(dtype)

    l_safe = torch.where(has_l, l, 0.0)
    u_safe = torch.where(has_u, u, 0.0)
    b_eq = torch.where(is_eq, u, 0.0)

    Amv, ATmv = _struct_matvecs(A, rows, n, m)
    # Levenberg-style adaptive primal regularization floored at _REG_MIN: a
    # Cholesky breakdown escalates it so the next factorization goes through
    if rows.eq is None:
        make_solver = _lu_solver_factory(P, A, is_eq, delta)
    else:
        make_solver = _condensed_solver_factory(P, A, rows, delta)

    # -- starting point --------------------------------------------------
    x = torch.zeros_like(q)
    f = Amv(x)
    s_l = torch.where(has_l, torch.clamp(f - l_safe, min=1.0), 1.0)
    s_u = torch.where(has_u, torch.clamp(u_safe - f, min=1.0), 1.0)
    z_l = has_l.to(dtype)
    z_u = has_u.to(dtype)
    y_eq = torch.zeros_like(l)

    def merit_parts(f, r_x, r_eq, s_l, s_u, z_l, z_u):
        rp = amax(torch.abs(f - torch.clamp(f, l, u)))
        mu = (torch.sum(s_l * z_l * has_l, -1)
              + torch.sum(s_u * z_u * has_u, -1)) / n_barrier
        return (amax(torch.abs(r_x)) + amax(torch.abs(r_eq)) + rp + mu), mu

    def residuals(x, z_l, z_u, y_eq):
        f = Amv(x)
        # eq-dual and inequality-dual supports are disjoint -> one matvec
        r_x = mv(P, x) + q + ATmv(torch.where(is_eq, y_eq, 0.0) + z_u - z_l)
        r_eq = torch.where(is_eq, f - b_eq, 0.0)
        return f, r_x, r_eq

    def max_step(v, dv, mask):
        # largest alpha in (0,1] with v + alpha dv >= (1-tau) v
        ratio = torch.where(mask & (dv < 0),
                            -v / torch.clamp(dv, max=-_EPS), torch.inf)
        return torch.clamp(0.99 * torch.amin(ratio, dim=-1), max=1.0)

    reg = torch.full((B,), _REG_MIN, dtype=dtype, device=P.device)
    best = (x, s_l, s_u, z_l, z_u, y_eq)
    best_merit = torch.full((B,), torch.inf, dtype=dtype, device=P.device)
    nn = torch.nan_to_num
    for _ in range(iters):
        with span("ipm.iter"):
            f, r_x, r_eq = residuals(x, z_l, z_u, y_eq)
            # slack consistency residuals (s must track f - l / u - f)
            r_sl = torch.where(has_l, f - l_safe - s_l, 0.0)
            r_su = torch.where(has_u, u_safe - f - s_u, 0.0)

            # best-iterate safeguard
            merit, mu = merit_parts(f, r_x, r_eq, s_l, s_u, z_l, z_u)
            better = merit < best_merit
            best = tuple(_sel(better, new, old)
                         for new, old in zip((x, s_l, s_u, z_l, z_u, y_eq), best))
            best_merit = torch.minimum(merit, best_merit)

            d_l = torch.where(has_l, z_l / torch.clamp(s_l, min=_EPS), 0.0)
            d_u = torch.where(has_u, z_u / torch.clamp(s_u, min=_EPS), 0.0)
            solve = make_solver(d_l + d_u, reg)

            def newton(sig_mu, comp_extra_l, comp_extra_u):
                # complementarity targets: s.z = sig_mu (+ Mehrotra correction)
                comp_l = torch.where(has_l, s_l * z_l - sig_mu + comp_extra_l, 0.0)
                comp_u = torch.where(has_u, s_u * z_u - sig_mu + comp_extra_u, 0.0)
                w = (comp_l / torch.clamp(s_l, min=_EPS) * has_l
                     - comp_u / torch.clamp(s_u, min=_EPS) * has_u
                     + d_l * r_sl - d_u * r_su)
                dx, dy = solve(-(r_x + ATmv(w)), -r_eq)
                df = Amv(dx)
                ds_l = torch.where(has_l, df + r_sl, 0.0)
                ds_u = torch.where(has_u, -df + r_su, 0.0)
                dz_l = torch.where(
                    has_l, -(comp_l + z_l * ds_l) / torch.clamp(s_l, min=_EPS), 0.0)
                dz_u = torch.where(
                    has_u, -(comp_u + z_u * ds_u) / torch.clamp(s_u, min=_EPS), 0.0)
                return dx, dy, ds_l, ds_u, dz_l, dz_u

            # affine (predictor) step, refined like the corrector
            dx_a, dy_a, dsl_a, dsu_a, dzl_a, dzu_a = newton(0.0, 0.0, 0.0)
            a_p = torch.minimum(max_step(s_l, dsl_a, has_l), max_step(s_u, dsu_a, has_u))
            a_d = torch.minimum(max_step(z_l, dzl_a, has_l), max_step(z_u, dzu_a, has_u))
            a_aff = torch.minimum(a_p, a_d)[:, None]
            mu_aff = (torch.sum((s_l + a_aff * dsl_a) * (z_l + a_aff * dzl_a) * has_l, -1)
                      + torch.sum((s_u + a_aff * dsu_a) * (z_u + a_aff * dzu_a) * has_u, -1)
                      ) / n_barrier
            ratio = mu_aff / torch.clamp(mu, min=_EPS)
            sigma = torch.clamp(ratio * ratio * ratio, 0.0, 1.0)

            # corrector with Mehrotra second-order term
            dx_c, dy_c, dsl, dsu, dzl, dzu = newton(
                (sigma * mu)[:, None], dsl_a * dzl_a, dsu_a * dzu_a)
            a_p = torch.minimum(max_step(s_l, dsl, has_l), max_step(s_u, dsu, has_u))
            a_d = torch.minimum(max_step(z_l, dzl, has_l), max_step(z_u, dzu, has_u))
            alpha = torch.minimum(a_p, a_d)
            # freeze once the central path reaches the f32 floor
            alpha = torch.where(mu > _MU_FLOOR, alpha, 0.0)
            # NaN guard: a broken-down factorization gives a garbage step
            step_ok = (_all_finite(dx_c) & _all_finite(dy_c) & _all_finite(dsl)
                       & _all_finite(dsu) & _all_finite(dzl) & _all_finite(dzu))
            alpha = torch.where(step_ok, alpha, 0.0)
            reg = torch.where(step_ok, torch.clamp(reg * 0.5, min=_REG_MIN),
                              torch.clamp(reg * 64.0, max=_REG_MAX))
            a = alpha[:, None]
            x = x + a * nn(dx_c)
            y_eq = y_eq + a * nn(dy_c)
            s_l = torch.where(has_l, torch.clamp(s_l + a * nn(dsl), min=_EPS), s_l)
            s_u = torch.where(has_u, torch.clamp(s_u + a * nn(dsu), min=_EPS), s_u)
            z_l = torch.where(has_l, torch.clamp(z_l + a * nn(dzl), min=0.0), z_l)
            z_u = torch.where(has_u, torch.clamp(z_u + a * nn(dzu), min=0.0), z_u)

    # the post-loop iterate was never merit-checked; give it its shot too
    f, r_x, r_eq = residuals(x, z_l, z_u, y_eq)
    final_better = merit_parts(f, r_x, r_eq, s_l, s_u, z_l, z_u)[0] < best_merit
    x, s_l, s_u, z_l, z_u, y_eq = (
        _sel(final_better, new, old)
        for new, old in zip((x, s_l, s_u, z_l, z_u, y_eq), best))
    y = torch.where(is_eq, y_eq, z_u - z_l)

    with span("ipm.polish"):
        # ---- penalty polish (OSQP's "polish", racing_mpc.cpp:87) -------------
        # active set from the duals dominating their slacks; re-solve with the
        # active rows enforced by a stiff penalty through the same solver, and
        # keep whichever iterate has the smaller combined KKT residual
        act_l = has_l & (z_l > s_l) & (z_l > z_u)
        act_u = has_u & (z_u > s_u) & (z_u > z_l)
        active = act_l | act_u
        b_act = torch.where(act_l, l_safe, torch.where(act_u, u_safe, 0.0))
        D_pol = torch.where(active, 1e5, 0.0).to(dtype)
        solve_pol = make_solver(D_pol)
        x_pol, y_pol_eq = solve_pol(-q + ATmv(D_pol * b_act), b_eq)
        y_pol = torch.where(is_eq, y_pol_eq,
                            torch.where(active, D_pol * (Amv(x_pol) - b_act), 0.0))

        def kkt_metric(xc, yc):
            # primal + dual + complementarity/dual-sign violation
            Axc = Amv(xc)
            zc = torch.clamp(Axc, l, u)
            rp = amax(torch.abs(Axc - zc))
            rp_eq = amax(torch.abs(torch.where(is_eq, Axc - b_eq, 0.0)))
            rd = amax(torch.abs(mv(P, xc) + q + ATmv(yc)))
            yin = torch.where(is_eq, 0.0, yc)
            comp = amax(
                torch.clamp(yin, min=0.0)
                * torch.where(finite_u, torch.abs(u_safe - zc), 1.0)
                + torch.clamp(-yin, min=0.0)
                * torch.where(finite_l, torch.abs(zc - l_safe), 1.0))
            return rp + rp_eq + rd + comp

        pol_ok = ((kkt_metric(x_pol, y_pol) < kkt_metric(x, y))
                  & _all_finite(x_pol) & _all_finite(y_pol) & do_polish)
        return _sel(pol_ok, x_pol, x), _sel(pol_ok, y_pol, y)


def solve_qp_ip(data: QPData, eq_rows: np.ndarray | None = None, iters: int = 25,
                delta: float = 1e-7, struct=None, zoom_rounds: int = 1,
                zoom_iters: int | None = None) -> QPSolution:
    """Ruiz-scale, run the IPM and the zoom ladder, unscale, report residuals.

    ``data`` is a batch of QPs (leading dimension B); ``eq_rows`` the static
    index array of the equality rows (may be empty; the row structure
    ``struct`` is used only with it).  Without it each Newton system is a
    pivoted LU of the full KKT (``_lu_solver_factory``).
    """
    with span("ipm.solve"):
        return _solve_qp_ip(data, eq_rows, iters, delta, struct, zoom_rounds, zoom_iters)


def _solve_qp_ip(data, eq_rows, iters, delta, struct, zoom_rounds, zoom_iters):
    # symmetrize (f32 Gram sums are only symmetric in exact arithmetic);
    # ridge AFTER equilibration, where the diagonal is O(1)
    data = data._replace(P=0.5 * (data.P + data.P.transpose(-1, -2)))
    with span("ipm.ruiz"):
        sdata0, (D, E, c) = ruiz_equilibrate(data)
    P0, q0, A0, l0, u0 = sdata0
    B, n = q0.shape
    m = l0.shape[-1]
    dtype, device = P0.dtype, P0.device
    with span("ipm.rows_sync"):
        rows = _Rows.make(eq_rows, struct, device)
    trace_n = torch.diagonal(P0, dim1=-2, dim2=-1).sum(-1) / n
    I_n = torch.eye(n, dtype=dtype, device=device)
    sdata = sdata0._replace(P=P0 + (_RIDGE_REL * trace_n)[:, None, None] * I_n)
    with span("ipm.pass", round=0):
        xs, ys = _ipm_core(sdata, iters, delta, rows)

    # ---- zoomed refinement: re-solve the RESIDUAL problem around the
    # iterate, magnified by `zoom`, with the gradient and slacks in
    # compensated (double-word) f32 ------------------------------------------
    def comp_pieces(x):
        """Double-word A x, P x + q of the UNRIDGED scaled problem."""
        f_h, f_l = matvec_compensated(A0, x)
        rq_h, rq_l = matvec_compensated(P0, x)
        rq_h, e1 = two_sum(rq_h, q0)
        return f_h, f_l, rq_h, rq_l + e1

    # exact-penalty weight: must dominate the true multipliers (|y*|)
    PEN = 30.0 * (1.0 + amax(torch.abs(torch.nan_to_num(ys))))

    def phi_of(x, pieces):
        """l1-exact-penalty merit as a DOUBLE-WORD (hi, lo) pair."""
        f_h, f_l, rq_h, rq_l = pieces
        # obj = 1/2 x'(P x + q) + 1/2 q'x  — use the compensated P x + q
        oh1, ol1 = dot_compensated(x, rq_h)
        oh2, ol2 = dot_compensated(x, rq_l)
        oh3, ol3 = dot_compensated(q0, x)
        h, lo = oh1, ol1
        for term in (oh2, ol2, oh3, ol3):
            h, e = two_sum(h, term)
            lo = lo + e
        h, lo = 0.5 * h, 0.5 * lo
        f = f_h + f_l
        viol = torch.sum(torch.abs(f - torch.clamp(f, l0, u0)), -1)
        h, e = two_sum(h, PEN * viol)
        return h, lo + e

    def phi_lt(a, b):
        """Double-word comparison a < b."""
        return (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] < b[1]))

    is_eq_z = torch.zeros(m, dtype=torch.bool, device=device)
    if rows.eq is not None:
        with span("ipm.zoom_mask_sync"):
            count_sync()    # as in _ipm_core's equality mask
            is_eq_z[rows.eq_t] = True
    fin_l, fin_u = torch.isfinite(l0), torch.isfinite(u0)

    def zoom_round(r, xs, ys, phi1, pieces, zoom, active):
        f_h, f_l, rq_h, rq_l = pieces
        l_r = (l0 - f_h) - f_l
        u_r = (u0 - f_h) - f_l
        rq = rq_h + rq_l
        z = zoom[:, None]
        # trust region: magnified bounds clipped to +-C_TR, crossed bounds
        # pinned at the edge; equality rows stay exact
        lz = torch.where(fin_l, torch.clamp(z * l_r, -_C_TR, _C_TR), -torch.inf)
        uz = torch.where(fin_u, torch.clamp(z * u_r, -_C_TR, _C_TR), torch.inf)
        lz = torch.minimum(lz, uz)
        lz = torch.where(is_eq_z, z * u_r, lz)
        uz = torch.where(is_eq_z, z * u_r, uz)
        rdata = QPData(P=P0, q=z * rq, A=A0, l=lz, u=uz)
        ok1 = _all_finite(xs) & _all_finite(ys)
        with span("ipm.pass", round=r):
            xe, ye = _ipm_core(rdata, zoom_iters or iters, delta, rows)
        step_ok = ok1 & _all_finite(xe) & _all_finite(ye)
        xs2 = _sel(step_ok, xs + xe / z, xs)
        ys2 = _sel(step_ok, ye / z, ys)
        pieces2 = comp_pieces(xs2)
        phi2 = phi_of(xs2, pieces2)
        better = step_ok & phi_lt(phi2, phi1)
        # macroscopic gain -> stay at this zoom; else escalate
        dphi = (phi2[0] - phi1[0]) + (phi2[1] - phi1[1])
        macro = better & (dphi < -_GAIN_SMALL)
        xs = _sel(better, xs2, xs)
        ys = _sel(better, ys2, ys)
        phi1 = tuple(_sel(better, a, b) for a, b in zip(phi2, phi1))
        pieces = tuple(_sel(better, a, b) for a, b in zip(pieces2, pieces))
        at_max = zoom >= _ZOOM_MAX
        zoom = torch.where(macro, zoom,
                           torch.clamp(zoom * _ZOOM_STEP, max=_ZOOM_MAX))
        # early exit: rejected at the zoom cap, or accepted at the noise floor
        corr = amax(torch.abs(xe)) / zoom
        done = (~better & at_max) | (better & (corr < _EXIT_ATOL))
        return xs, ys, phi1, pieces, zoom, active & ~done

    pieces = comp_pieces(xs)
    carry = (xs, ys, phi_of(xs, pieces), pieces,
             torch.ones(B, dtype=dtype, device=device),
             torch.ones(B, dtype=torch.bool, device=device))
    for r in range(1, zoom_rounds + 1):
        run = carry[-1]
        with span("ipm.zoom_sync"):
            count_sync()
            go = bool(run.any())     # the round's decision, on the host
        if not go:
            break
        with span("ipm.zoom_round", round=r):
            new = zoom_round(r, *carry)
            # lanes that had already retired keep their carry, as under vmap
            carry = tuple(
                tuple(_sel(run, a, b) for a, b in zip(nw, old))
                if isinstance(nw, tuple) else _sel(run, nw, old)
                for nw, old in zip(new, carry))
    xs, ys = carry[0], carry[1]

    with span("ipm.unscale"):
        rp_rel, rd_rel = scaled_residuals(sdata, xs, ys)
        x = xs * D
        y = ys * E / c[:, None]
        Ax = mv(data.A, x)
        z = torch.clamp(Ax, data.l, data.u)
        r_prim = amax(torch.abs(Ax - z))
        Px = mv(data.P, x)
        r_dual = amax(torch.abs(Px + data.q + mv(data.A.transpose(-1, -2), y)))
        obj = torch.sum((0.5 * x) * Px, -1) + torch.sum(data.q * x, -1)
    return QPSolution(x=x, y=y, z=z, r_prim=r_prim, r_dual=r_dual, obj=obj,
                      rp_rel=rp_rel, rd_rel=rd_rel)
