"""Float64 transcription of the reference controller's exact QP (golden oracle).

Port of ``racing_lmpc_tpu/mpc/reference_qp.py``.  The reference assembles a
parametric CasADi ``Opti("conic")`` problem once and hands it to
OSQP-with-polish at float64 (racing_mpc.cpp:31-543).  This module rebuilds
that problem **verbatim over the sparse variables** — the scaled X (nx, N),
U (nu, N-1), dU (nu, N-1), the scalar boundary slack, the convex
combination lambda and the convex-hull slack vector — as float64 tensors on
one device, and solves it to KKT residuals ~1e-10 with an independent dense
Mehrotra predictor-corrector method.  It is the acceptance oracle of the
pinned instances (``tests/data/acc_instances``, gates in ``ACCURACY.json``):
nothing here is eliminated, pre-stabilized or re-ordered, so a condensing
bug in the engine cannot hide.

Transcribed constraint-for-constraint from the reference:

- variables + fixed diagonal scaling        racing_mpc.cpp:36-45
- soft track boundary, scalar slack         racing_mpc.cpp:524-543
- tracking cost                             racing_mpc.cpp:442-477
- LMPC cost: ss_costs . lambda, hull slack
  vector with diagonal quadratic penalty    racing_mpc.cpp:479-522
- model linear rows (single-track simplified
  lon bound, steering box, dui rate rows)   single_track_planar_model.cpp:113-158
- primal x/u boxes on stages 0..N-2 (the
  terminal state is NOT boxed)              racing_mpc.cpp:147-148
- linearized dynamics rows  x_{i+1} = A x_i + B u_i + g  with (A, B, g)
  evaluated at (X_ref_i, U_ref_i) in f64    racing_mpc.cpp:168-187
- control-rate coupling u_{i-1} + du_i t_i = u_i, u_{-1} = u_ic
                                            racing_mpc.cpp:189-197
- initial state equality                    racing_mpc.cpp:199-201
- X_ref abscissa wrap into the current
  period before everything else             racing_mpc.cpp:219-223

The rows are those of the JAX package's build in the same order; each group is
assembled at once over the stages instead of row by row.  The Jacobians
come from this package's own vehicle model called on float64 tensors,
batched over the stages, i.e. at the precision the reference's CasADi SX
graphs run at.  Every entry point runs on the device it is given (CUDA
unless ``device="cpu"``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import Tensor

from racing_lmpc_torch import resolve_device

__all__ = ["ReferenceQP", "RefLayout", "build_reference_qp", "solve_dense_qp_f64",
           "kkt_residuals"]

F64 = torch.float64


@dataclass
class RefLayout:
    nx: int
    nu: int
    N: int
    K: int
    has_bslack: bool
    has_hull_slack: bool
    learning: bool

    def __post_init__(self):
        nx, nu, N, K = self.nx, self.nu, self.N, self.K
        self.x_off = 0
        self.u_off = N * nx
        self.du_off = self.u_off + (N - 1) * nu
        off = self.du_off + (N - 1) * nu
        self.sb_off = off
        off += 1 if self.has_bslack else 0
        self.lam_off = off
        off += K if self.learning else 0
        self.hs_off = off
        off += nx if self.has_hull_slack else 0
        self.n = off

    def ix(self, i):
        return self.x_off + i * self.nx

    def iu(self, i):
        return self.u_off + i * self.nu

    def idu(self, i):
        return self.du_off + i * self.nu


@dataclass
class ReferenceQP:
    """Dense f64 QP in OSQP form: min 1/2 z'Pz + q'z  s.t.  l <= Az <= u,
    every array a float64 tensor on one device."""
    P: Tensor
    q: Tensor
    A: Tensor
    l: Tensor
    u: Tensor
    layout: RefLayout
    scale_x: Tensor
    scale_u: Tensor

    def controls(self, z: Tensor) -> Tensor:
        """Unscaled U (N-1, nu) from a solution vector."""
        L = self.layout
        return z[L.u_off:L.du_off].reshape(L.N - 1, L.nu) * self.scale_u[None, :]

    def states(self, z: Tensor) -> Tensor:
        L = self.layout
        return z[:L.u_off].reshape(L.N, L.nx) * self.scale_x[None, :]

    def objective(self, z: Tensor) -> float:
        return float(0.5 * z @ (self.P @ z) + self.q @ z)


def _f64(a, device) -> Tensor:
    """``a`` (a tensor, an array or a number) as a float64 tensor on ``device``."""
    return torch.as_tensor(a, dtype=F64, device=device)


def _f64_model_data(model, X_ref: Tensor, U_ref: Tensor, curvatures: Tensor,
                    T_ref: Tensor):
    """(A_i, B_i, g_i) stage Jacobians at float64 through the port's model,
    called batched over the stages (``torch.func.vmap`` of it does not
    trace: its forward-mode Jacobian is itself a vmap over tangents)."""
    return model.discrete_dynamics_jacobian(X_ref[:-1], U_ref, curvatures[:-1], T_ref)


def _align_abscissa(s1, s2, length):
    """Wrap s1 into [s2 - L/2, s2 + L/2) (lmpc_utils/utils.hpp:61-80)."""
    return s1 - length * torch.floor((s1 - s2) / length + 0.5)


class _Rows:
    """The constraint rows of a QP, appended a group at a time: each group
    is a dense block of rows of A with its bounds."""

    def __init__(self, n: int, device):
        self.n, self.device = n, device
        self.A, self.l, self.u = [], [], []

    def block(self, rows: int) -> Tensor:
        return torch.zeros((rows, self.n), dtype=F64, device=self.device)

    def add(self, A: Tensor, lo, hi) -> None:
        r = A.shape[0]
        self.A.append(A)
        self.l.append(torch.broadcast_to(_f64(lo, self.device), (r,)))
        self.u.append(torch.broadcast_to(_f64(hi, self.device), (r,)))

    def stack(self):
        return torch.cat(self.A), torch.cat(self.l), torch.cat(self.u)


def build_reference_qp(model, cfg, inp, margin: float | None = None,
                       dA=None, dB=None, dC=None, device=None) -> ReferenceQP:
    """Assemble the reference QP at float64 from an MPCInput-like object
    (fields unbatched: tensors, arrays or numbers).

    ``cfg`` is the engine's RacingMPCConfig (same parameter names as the
    reference YAML).  ``margin`` defaults to cfg.margin + b/2 exactly as
    racing_mpc.cpp:533.  ``dA/dB/dC`` optionally apply the same
    error-dynamics correction the engine receives (additive on every stage
    linearization).  The QP's tensors live on ``device`` (CUDA unless the
    caller names another).
    """
    device = resolve_device(device)
    g = lambda a: _f64(a, device)  # noqa: E731
    nx, nu, N = model.nx, model.nu, cfg.n
    K = cfg.num_ss_pts if cfg.learning else 0
    x_ic, u_ic = g(inp.x_ic), g(inp.u_ic)
    X_ref, U_ref = g(inp.X_ref).clone(), g(inp.U_ref)
    T_ref = g(inp.T_ref)
    curvatures = g(inp.curvatures)
    total_length = float(inp.total_length)
    # abscissa wrap into the vehicle's current period (racing_mpc.cpp:219-223)
    X_ref[:, 0] = _align_abscissa(X_ref[:, 0], x_ic[0], total_length)

    hull_w = np.asarray(cfg.convex_hull_slack, np.float64)
    has_hull_slack = bool(cfg.learning and hull_w.size and hull_w.sum() > 0)
    has_bslack = bool(cfg.q_boundary > 0.0)
    L = RefLayout(nx=nx, nu=nu, N=N, K=K, has_bslack=has_bslack,
                  has_hull_slack=has_hull_slack, learning=bool(cfg.learning))

    # fixed diagonal scaling (racing_mpc.cpp:36-37); the engine's per-model
    # override hook, so both see the same variable scaling
    so = model.state_scales()
    sx = g(so if so is not None else np.array([2000.0, 10.0, 0.1, 80.0, 2.0, 2.0])[:nx])
    su = g([10.0, 0.3] if nu == 2 else [10.0, 10.0, 0.3])

    As, Bs, gs = _f64_model_data(model, X_ref, U_ref, curvatures, T_ref)
    if dA is not None:
        As = As + g(dA)[None]
        Bs = Bs + g(dB)[None]
        gs = gs + g(dC)[None, :]

    P = torch.zeros((L.n, L.n), dtype=F64, device=device)
    q = torch.zeros(L.n, dtype=F64, device=device)
    M = N - 1
    stages = torch.arange(M, device=device)
    eye_m = torch.eye(M, dtype=F64, device=device)

    # ---- costs ----------------------------------------------------------
    # u' R u and du' R_d du on the scaled variables (P convention 1/2 z'Pz),
    # one block a stage
    R, R_d = g(cfg.R(nu)), g(cfg.R_d(nu))
    P[L.u_off:L.du_off, L.u_off:L.du_off] += torch.kron(
        eye_m, 2.0 * (su[:, None] * R * su[None, :]))
    P[L.du_off:L.du_off + M * nu, L.du_off:L.du_off + M * nu] += torch.kron(
        eye_m, 2.0 * (su[:, None] * R_d * su[None, :]))

    if cfg.learning:
        ss_x = g(inp.ss_x)            # (K, nx)
        ss_j = g(inp.ss_j)            # (K,) relative cost-to-go
        q[L.lam_off:L.lam_off + K] += ss_j
        if has_hull_slack:
            hs = L.hs_off
            P[hs:hs + nx, hs:hs + nx] += 2.0 * torch.diag(g(hull_w))
    else:
        vel_ref = g(inp.vel_ref)
        ci = model.cost_state_indices()
        w10 = torch.ones(N, dtype=F64, device=device)
        w10[-1] = 10.0
        ix = torch.arange(N, device=device) * nx
        cI, hI, vI = ci["contour"], ci["heading"], ci["vel"]
        P[ix + cI, ix + cI] += 2.0 * cfg.q_contour * w10 * sx[cI] ** 2
        P[ix + hI, ix + hI] += 2.0 * cfg.q_heading * w10 * sx[hI] ** 2
        P[ix + vI, ix + vI] += 2.0 * cfg.q_vel * w10 * sx[vI] ** 2
        q[ix + vI] += -2.0 * cfg.q_vel * w10 * vel_ref[:N] * sx[vI]
        # the running-only terms skip the terminal stage
        for key, weight in (("vy", cfg.q_vy), ("vyaw", cfg.q_vyaw)):
            if ci[key] is not None:
                j = ix[:-1] + ci[key]
                P[j, j] += 2.0 * weight * sx[ci[key]] ** 2

    if has_bslack:
        P[L.sb_off, L.sb_off] += 2.0 * cfg.q_boundary

    rows = _Rows(L.n, device)
    inf = float("inf")

    # ---- track boundary (racing_mpc.cpp:524-543) ------------------------
    m_eff = (cfg.margin + model.base_config.chassis.b / 2.0
             if margin is None else margin)
    bl, br = g(inp.bound_left)[:N], g(inp.bound_right)[:N]
    cc = model.cost_state_indices()["contour"]
    py_cols = torch.arange(N, device=device) * nx + cc
    if has_bslack:
        # per stage: py - sb <= bl - m, then py + sb >= br + m
        B = rows.block(2 * N)
        up, lo = torch.arange(0, 2 * N, 2, device=device), torch.arange(1, 2 * N, 2, device=device)
        B[up, py_cols] = sx[cc]
        B[up, L.sb_off] = -1.0
        B[lo, py_cols] = sx[cc]
        B[lo, L.sb_off] = 1.0
        rows.add(B, torch.stack([torch.full_like(bl, -inf), br + m_eff], 1).flatten(),
                 torch.stack([bl - m_eff, torch.full_like(br, inf)], 1).flatten())
        B = rows.block(1)
        B[0, L.sb_off] = 1.0
        rows.add(B, 0.0, inf)
    else:
        B = rows.block(N)
        B[torch.arange(N, device=device), py_cols] = sx[cc]
        rows.add(B, br + m_eff, bl - m_eff)

    # ---- model linear rows + primal boxes, stages 0..N-2 ----------------
    bounds = model.control_bounds()
    full = lambda lim, k, v: (np.asarray(lim, np.float64) if len(lim) == k  # noqa: E731
                              else np.full(k, v))
    x_min, x_max = full(cfg.x_min, nx, -np.inf), full(cfg.x_max, nx, np.inf)
    u_min, u_max = full(cfg.u_min, nu, -np.inf), full(cfg.u_max, nu, np.inf)
    # one stage's rows: (first column of the stage's block, its offset per
    # stage, index in it, scale, lower, upper)
    tmpl = [(L.u_off, nu, j, su[j], bounds.u_lb[j], bounds.u_ub[j]) for j in range(nu)]
    tmpl += [(L.du_off, nu, j, su[j], bounds.du_lb[j], bounds.du_ub[j]) for j in range(nu)]
    tmpl += [(L.x_off, nx, j, sx[j], x_min[j], x_max[j]) for j in range(nx)
             if np.isfinite(x_min[j]) or np.isfinite(x_max[j])]
    tmpl += [(L.u_off, nu, j, su[j], u_min[j], u_max[j]) for j in range(nu)
             if np.isfinite(u_min[j]) or np.isfinite(u_max[j])]
    r = len(tmpl)
    B = rows.block(M * r)
    for t, (off, width, j, scale, _, _) in enumerate(tmpl):
        B[stages * r + t, off + stages * width + j] = scale
    rows.add(B, np.tile([row[4] for row in tmpl], M), np.tile([row[5] for row in tmpl], M))

    # ---- dynamics + rate coupling equalities -----------------------------
    # per stage: nx dynamics rows, then nu coupling rows
    # u_{i-1} + du_i t_i = u_i  (u_{-1} = u_ic)
    D = torch.zeros((M, nx + nu, L.n), dtype=F64, device=device)
    i3 = stages[:, None, None]
    r3 = torch.arange(nx, device=device)[None, :, None]
    c3 = torch.arange(nx, device=device)[None, None, :]
    cu3 = torch.arange(nu, device=device)[None, None, :]
    D[i3[:, :, 0], r3[:, :, 0], L.x_off + (i3[:, :, 0] + 1) * nx + r3[:, :, 0]] = sx
    D[i3, r3, L.x_off + i3 * nx + c3] = -As * sx
    D[i3, r3, L.u_off + i3 * nu + cu3] = -Bs * su
    i2 = stages[:, None]
    j2 = torch.arange(nu, device=device)[None, :]
    D[i2, nx + j2, L.u_off + i2 * nu + j2] = -su
    D[i2, nx + j2, L.du_off + i2 * nu + j2] = T_ref[:, None] * su
    D[i2[1:], nx + j2, L.u_off + (i2[1:] - 1) * nu + j2] = su
    rhs = torch.cat([gs, torch.zeros((M, nu), dtype=F64, device=device)], 1)
    rhs[0, nx:] = -u_ic
    rows.add(D.reshape(M * (nx + nu), L.n), rhs.flatten(), rhs.flatten())

    # ---- initial state equality (racing_mpc.cpp:199-201) -----------------
    B = rows.block(nx)
    B[torch.arange(nx, device=device), L.ix(0) + torch.arange(nx, device=device)] = sx
    rows.add(B, x_ic, x_ic)

    # ---- LMPC simplex + hull (racing_mpc.cpp:479-522) ---------------------
    if cfg.learning:
        kk = torch.arange(K, device=device)
        B = rows.block(K)
        B[kk, L.lam_off + kk] = 1.0
        rows.add(B, 0.0, inf)
        B = rows.block(1)
        B[0, L.lam_off:L.lam_off + K] = 1.0
        rows.add(B, 1.0, 1.0)
        B = rows.block(nx)
        rr = torch.arange(nx, device=device)
        B[rr, L.ix(N - 1) + rr] = sx
        B[:, L.lam_off:L.lam_off + K] = -ss_x.T
        if has_hull_slack:
            B[rr, L.hs_off + rr] = -1.0
        rows.add(B, 0.0, 0.0)

    A, l, u = rows.stack()
    return ReferenceQP(P=P, q=q, A=A, l=l, u=u, layout=L, scale_x=sx, scale_u=su)


# ---------------------------------------------------------------------------
# Independent dense f64 solver (Mehrotra predictor-corrector) + KKT check.
# Written against the textbook recipe over the SPARSE formulation above; it
# shares no code or structure with the engine's condensed IPM (mpc/ipm.py),
# which is the point: agreement between the two certifies the engine's
# condensing + f32 pipeline end to end.
# ---------------------------------------------------------------------------

def kkt_residuals(qp: ReferenceQP, z: Tensor, y: Tensor):
    """(primal, dual, complementarity) max-norm residuals at (z, y), as
    floats.  ``y`` follows the OSQP convention: positive on active upper
    bounds."""
    Az = qp.A @ z
    rp = (Az - torch.clamp(Az, qp.l, qp.u)).abs().max()
    rd = (qp.P @ z + qp.q + qp.A.T @ y).abs().max()
    is_eq = torch.isfinite(qp.l) & torch.isfinite(qp.u) & (qp.u - qp.l < 1e-12)
    zero = torch.zeros((), dtype=F64, device=z.device)
    comp_u = torch.clamp(y, min=0.0) * torch.where(
        torch.isfinite(qp.u) & ~is_eq, (qp.u - Az).abs(), zero)
    comp_l = torch.clamp(-y, min=0.0) * torch.where(
        torch.isfinite(qp.l) & ~is_eq, (Az - qp.l).abs(), zero)
    rc = torch.where(is_eq, zero, comp_u + comp_l).max() if len(y) else zero
    return float(rp), float(rd), float(rc)


def _ruiz_f64(P, q, A, l, u, rounds: int = 20):
    """Modified Ruiz equilibration (f64).  Returns scaled data plus (d, e)
    diagonal scalings with z = d * z_scaled, y = e * y_scaled."""
    n, m = len(q), len(l)
    d = torch.ones(n, dtype=F64, device=q.device)
    e = torch.ones(m, dtype=F64, device=q.device)
    Ps, qs, As = P.clone(), q.clone(), A.clone()
    ls, us = l.clone(), u.clone()
    for _ in range(rounds):
        col = torch.sqrt(torch.maximum(Ps.abs().amax(0), As.abs().amax(0)) if m
                         else Ps.abs().amax(0).clamp(min=0.0))
        col = torch.where(col < 1e-10, 1.0, col)
        row = torch.sqrt(As.abs().amax(1)) if m else torch.ones_like(e)
        row = torch.where(row < 1e-10, 1.0, row)
        Ps /= col[:, None]
        Ps /= col[None, :]
        qs /= col
        As /= row[:, None]
        As /= col[None, :]
        ls = ls / row
        us = us / row
        d /= col
        e /= row
    return Ps, qs, As, ls, us, d, e


def _certify(qp: ReferenceQP, z: Tensor, y: Tensor) -> None:
    rp, rd, rc = kkt_residuals(qp, z, y)
    ref = max(1.0, float(qp.q.abs().max()))
    if max(rp, rd / ref, rc) > 1e-7:
        raise RuntimeError(
            f"oracle did not certify: rp={rp:.2e} rd={rd:.2e} rc={rc:.2e}")


def solve_dense_qp_f64(qp: ReferenceQP, iters: int = 80, tol: float = 1e-10,
                       verify: bool = True, scale: bool = True):
    """Dense f64 Mehrotra predictor-corrector on l <= Az <= u form, on the
    QP's device.

    Returns (z, y).  Raises if the verified KKT residuals (checked on the
    ORIGINAL, unscaled data) exceed 1e-7 — the oracle must be certifiably
    converged or it is useless.  One host synchronization an iteration (the
    stopping test); each iteration factors its KKT matrix once for the
    predictor, the corrector and their refinement rounds.
    """
    if scale:
        Ps, qs, As, ls, us, d_sc, e_sc = _ruiz_f64(qp.P, qp.q, qp.A, qp.l, qp.u)
        sqp = ReferenceQP(P=Ps, q=qs, A=As, l=ls, u=us, layout=qp.layout,
                          scale_x=qp.scale_x, scale_u=qp.scale_u)
        zs, ys = solve_dense_qp_f64(sqp, iters=iters, tol=tol, verify=False, scale=False)
        z, y = d_sc * zs, e_sc * ys
        if verify:
            _certify(qp, z, y)
        return z, y
    P, q, A, l, u = qp.P, qp.q, qp.A, qp.l, qp.u
    dev = q.device
    n = len(q)
    zero = torch.zeros((), dtype=F64, device=dev)
    is_eq = torch.isfinite(l) & torch.isfinite(u) & (u - l < 1e-12)
    has_l = torch.isfinite(l) & ~is_eq
    has_u = torch.isfinite(u) & ~is_eq
    E = A[is_eq]
    b_eq = u[is_eq]
    me = E.shape[0]
    nb = max(int(has_l.sum() + has_u.sum()), 1)
    tiny = torch.full((), 1e-300, dtype=F64, device=dev)
    reg = -1e-12 * torch.eye(me, dtype=F64, device=dev)

    z = torch.zeros(n, dtype=F64, device=dev)
    f = A @ z
    s_l = torch.where(has_l, torch.clamp(f - l, min=1.0), 1.0)
    s_u = torch.where(has_u, torch.clamp(u - f, min=1.0), 1.0)
    zl = has_l.to(F64)
    zu = has_u.to(F64)
    ye = torch.zeros(me, dtype=F64, device=dev)
    # best-iterate safeguard: past the f64 central-path floor a Newton step
    # can corrupt a fully-converged iterate (observed: rd 2e-13 at it 15,
    # 5e-1 at it 35 on the engine's condensed QPs); return the lowest-merit
    # iterate, not the last one.
    best = (z.clone(), zl.clone(), zu.clone(), ye.clone())
    best_merit = float("inf")

    def max_step(v, dv, mask):
        step = torch.where(mask & (dv < 0), -v / dv, float("inf")).amin()
        return torch.clamp(0.995 * step, max=1.0)

    for _ in range(iters):
        f = A @ z
        r_d = P @ z + q + A.T @ (torch.where(has_u, zu, zero) - torch.where(has_l, zl, zero))
        if me:
            r_d = r_d + E.T @ ye
        r_eq = E @ z - b_eq
        r_sl = torch.where(has_l, f - l - s_l, zero)
        r_su = torch.where(has_u, u - f - s_u, zero)
        mu = ((s_l * zl * has_l).sum() + (s_u * zu * has_u).sum()) / nb
        rp = (f - torch.clamp(f, l, u)).abs().max()
        merit = float(torch.maximum(torch.maximum(r_d.abs().max(), rp), mu))
        if merit < best_merit:
            best_merit = merit
            best = (z.clone(), zl.clone(), zu.clone(), ye.clone())
        if merit < tol:
            break

        d_l = torch.where(has_l, zl / torch.maximum(s_l, tiny), zero)
        d_u = torch.where(has_u, zu / torch.maximum(s_u, tiny), zero)
        D = d_l + d_u
        H = P + (A.T * D) @ A
        KKT = torch.cat([torch.cat([H, E.T], 1), torch.cat([E, reg], 1)], 0)
        LU, piv = torch.linalg.lu_factor(KKT)

        def solve_kkt(r1, r2):
            rhs = torch.cat([r1, r2])[:, None]
            sol = torch.linalg.lu_solve(LU, piv, rhs)
            # one round of f64 iterative refinement
            sol = sol + torch.linalg.lu_solve(LU, piv, rhs - KKT @ sol)
            return sol[:n, 0], sol[n:, 0]

        def newton(sig_mu, cx_l, cx_u):
            comp_l = torch.where(has_l, s_l * zl - sig_mu + cx_l, zero)
            comp_u = torch.where(has_u, s_u * zu - sig_mu + cx_u, zero)
            w = (torch.where(has_l, comp_l / torch.maximum(s_l, tiny), zero)
                 - torch.where(has_u, comp_u / torch.maximum(s_u, tiny), zero)
                 + d_l * r_sl - d_u * r_su)
            dz, dy = solve_kkt(-(r_d + A.T @ w), -r_eq)
            df = A @ dz
            dsl = torch.where(has_l, df + r_sl, zero)
            dsu = torch.where(has_u, -df + r_su, zero)
            dzl = torch.where(has_l, -(comp_l + zl * dsl) / torch.maximum(s_l, tiny), zero)
            dzu = torch.where(has_u, -(comp_u + zu * dsu) / torch.maximum(s_u, tiny), zero)
            return dz, dy, dsl, dsu, dzl, dzu

        def step_length(dsl, dsu, dzl, dzu):
            return torch.minimum(
                torch.minimum(max_step(s_l, dsl, has_l), max_step(s_u, dsu, has_u)),
                torch.minimum(max_step(zl, dzl, has_l), max_step(zu, dzu, has_u)))

        dz, dy, dsl, dsu, dzl, dzu = newton(zero, zero, zero)
        a = step_length(dsl, dsu, dzl, dzu)
        mu_aff = (((s_l + a * dsl) * (zl + a * dzl) * has_l).sum()
                  + ((s_u + a * dsu) * (zu + a * dzu) * has_u).sum()) / nb
        sigma = torch.clamp((mu_aff / torch.maximum(mu, tiny)) ** 3, 0.0, 1.0)
        dz, dy, dsl, dsu, dzl, dzu = newton(sigma * mu, dsl * dzl, dsu * dzu)
        a = step_length(dsl, dsu, dzl, dzu)
        z = z + a * dz
        ye = ye + a * dy
        s_l = torch.where(has_l, s_l + a * dsl, s_l)
        s_u = torch.where(has_u, s_u + a * dsu, s_u)
        zl = torch.where(has_l, zl + a * dzl, zl)
        zu = torch.where(has_u, zu + a * dzu, zu)

    z, zl, zu, ye = best
    y = torch.where(has_u, zu, zero) - torch.where(has_l, zl, zero)
    y[is_eq] = ye
    if verify:
        _certify(qp, z, y)
    return z, y
