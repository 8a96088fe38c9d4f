"""The plain reference: the LMPC QP of a batch of scenarios, built and solved
in float64 from the benchmark's inputs, and any plan priced in it.

Nothing here comes from the port.  The QP is the learning MPC of
Racing-LMPC-ROS2's ``racing_mpc.cpp`` in the form the port states it (its
``RacingMPC`` docstrings): the RK4 step of the configuration's model
linearized at the reference (the abscissa first wrapped into the vehicle's
current period), the cost  sum U'RU + sum dU'R_d dU + ss_j . lambda
+ sum_a hw_a (X_{N-1} - ss_x' lambda)_a^2 + q_boundary sb^2
+ q_state_slack sxb^2  (dU_i = (U_i - U_{i-1}) / t_i, U_{-1} = u_ic), and
the rows: the soft track boundary (margin + width / 2) on every stage, the
control box (the model's bounds met with u_min / u_max) and the rate box on
every stage, the state box on stages 1..N-2 (elastic with the one slack
sxb when q_state_slack > 0), lambda >= 0, sum lambda = 1, and the hull as
rows when it has no slack.  ``build`` eliminates the states through a
stabilizing feedback (see there); ``solve`` is a dense batched Mehrotra
predictor-corrector in float64 (the textbook recipe, as the port's f64
oracle ``mpc/reference_qp.py`` is written), each lane certified by its own
KKT residuals; ``plan_cost`` prices a plan (X, U, lambda) and measures how
far it breaks the QP's rows.  The optimal costs agree with the port's f64
oracle, which keeps every state as a variable, to 1e-8 (the CPU tests).
"""

from __future__ import annotations

import importlib.util
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

F64 = torch.float64
MODELS = Path(__file__).resolve().parent / "models"
RUIZ_ROUNDS = 15
# the solver's iteration cap, and the merit at which a lane stops
ITERS = 100
TOL = 1e-11


def load_model(cfg: dict):
    """The reference model that the configuration names:
    ``from_config(cfg)`` of ``reference/models/<model>.py``."""
    path = MODELS / f"{cfg['model']}.py"
    spec = importlib.util.spec_from_file_location(f"lmpc_bench_ref_{cfg['model']}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.from_config(cfg)


def _num(v) -> float:
    return float(v)            # "inf" / "-inf" strings included


@dataclass
class QP:
    """A batch of QPs  min 1/2 w'Pw + q'w + const  s.t.  l <= A w <= u,
    the rows ``eq`` equalities, over the decision w = [v, sb, sxb, lambda]
    with the controls U = su (MU v + mu0) and the states X = Phi v + c;
    and each lane's linearized dynamics (A_, B_, g_) and data, with which
    ``plan_cost`` prices any plan (X, U, lambda)."""
    P: torch.Tensor
    q: torch.Tensor
    const: torch.Tensor
    A: torch.Tensor
    l: torch.Tensor
    u: torch.Tensor
    eq: torch.Tensor          # (m,) bool
    Phi: torch.Tensor         # (S, N, nx, nuu)
    c: torch.Tensor           # (S, N, nx)
    MU: torch.Tensor          # (S, nuu, nuu)
    mu0: torch.Tensor         # (S, nuu)
    su: torch.Tensor
    dyn: tuple                # (A_, B_, g_) of every stage
    data: dict                # x_ic, u_ic, T, bounds, ss_x, ss_j, R, Rd, hw, ...
    layout: dict

    def objective(self, w):
        return (0.5 * (w[:, None, :] @ self.P @ w[:, :, None])[:, 0, 0]
                + (self.q * w).sum(-1) + self.const)

    def plan(self, w):
        """(X, U, lambda) of decision vectors w."""
        L = self.layout
        v = w[:, :L["nuu"]]
        U = ((self.MU @ v[..., None])[..., 0] + self.mu0).reshape(w.shape[0], -1, L["nu"]) * self.su
        X = (self.Phi @ v[:, None, :, None])[..., 0] + self.c
        return X, U, w[:, L["lam"]:L["lam"] + L["K"]]


def build(cfg: dict, model, inp: dict, device) -> QP:
    """The QPs of the lanes of ``inp`` (numpy fields of the port's MPCInput,
    batch leading) in float64 on ``device``.

    The states are eliminated through a stabilizing feedback, as the port
    does and for the same reason: at low speed the RK4 step of the stiff
    tyre dynamics is unstable (|eig| > 1), and a plain rollout over N
    stages grows by up to 1e13.  The controls are U_i = su (v_i - K_i (X_i -
    Xref_i)) with K_i the Riccati gains of Q = diag(1 / sx^2) and R = I on
    the scaled controls; any K gives the same QP in other coordinates."""
    mpc = {**cfg["racing_mpc"], **cfg["assumed"]["racing_mpc"]}
    g = lambda a: torch.as_tensor(np.asarray(a), dtype=F64, device=device)  # noqa: E731
    nx, nu, N = model.nx, model.nu, int(mpc["n"])
    M, K = N - 1, int(mpc["num_ss_pts"]) if mpc["learning"] else 0
    nuu = M * nu
    x_ic, u_ic = g(inp["x_ic"]), g(inp["u_ic"])
    X_ref, U_ref, T = g(inp["X_ref"]).clone(), g(inp["U_ref"]), g(inp["T_ref"])
    curv, L = g(inp["curvatures"]), g(inp["total_length"])
    S = x_ic.shape[0]
    X_ref[..., 0] -= L[:, None] * torch.floor((X_ref[..., 0] - x_ic[:, :1]) / L[:, None] + 0.5)
    su = g(model.scale_u)
    eye_nu = torch.eye(nu, dtype=F64, device=device)

    A_, B_, g_ = model.linearize(X_ref[:, :M], U_ref, curv[:, :M], T)
    Bs = B_ * su
    Q = torch.diag(1.0 / g(model.scale_x) ** 2)
    Pn = Q.expand(S, nx, nx)
    gains = [None] * M
    for i in reversed(range(M)):
        Ai, Bi = A_[:, i], Bs[:, i]
        BtP = Bi.transpose(1, 2) @ Pn
        Ki = torch.linalg.solve(eye_nu + BtP @ Bi, BtP @ Ai)
        Pn = Q + Ai.transpose(1, 2) @ Pn @ (Ai - Bi @ Ki)
        Pn = 0.5 * (Pn + Pn.transpose(1, 2))
        gains[i] = Ki
    Phi = torch.zeros((S, N, nx, nuu), dtype=F64, device=device)
    c = torch.zeros((S, N, nx), dtype=F64, device=device)
    MU = torch.zeros((S, nuu, nuu), dtype=F64, device=device)
    mu0 = torch.zeros((S, nuu), dtype=F64, device=device)
    c[:, 0] = x_ic
    for i in range(M):
        rows = slice(i * nu, (i + 1) * nu)
        MU[:, rows] = -gains[i] @ Phi[:, i]
        MU[:, rows, rows] += eye_nu
        mu0[:, rows] = -(gains[i] @ (c[:, i] - X_ref[:, i])[..., None])[..., 0]
        Phi[:, i + 1] = A_[:, i] @ Phi[:, i] + Bs[:, i] @ MU[:, rows]
        c[:, i + 1] = ((A_[:, i] @ c[:, i, :, None]) + (Bs[:, i] @ mu0[:, rows, None]))[..., 0] + g_[:, i]

    hw = np.asarray([_num(v) for v in mpc["convex_hull_slack"]], np.float64)
    has_hs = bool(mpc["learning"] and hw.size and hw.sum() > 0)
    q_b, q_s = _num(mpc["q_boundary"]), _num(mpc.get("q_state_slack", 0.0))
    has_sb, has_sx = q_b > 0, q_s > 0
    i_sb = nuu
    i_sx = i_sb + int(has_sb)
    i_lam = i_sx + int(has_sx)
    n = i_lam + K
    lam = slice(i_lam, i_lam + K)

    P = torch.zeros((S, n, n), dtype=F64, device=device)
    q = torch.zeros((S, n), dtype=F64, device=device)
    const = torch.zeros((S,), dtype=F64, device=device)
    R = np.asarray([_num(v) for v in mpc["r"]]).reshape(nu, nu)
    Rd = np.asarray([_num(v) for v in mpc["r_d"]]).reshape(nu, nu)
    eyeM = torch.eye(M, dtype=F64, device=device)

    def quad(G, h, W):
        """Add (G v + h)' W (G v + h) over the leading nuu variables."""
        GtW = G.transpose(1, 2) @ W
        P[:, :nuu, :nuu] += 2.0 * GtW @ G
        q[:, :nuu] += 2.0 * (GtW @ h[..., None])[..., 0]
        const.add_((h * (W @ h[..., None])[..., 0]).sum(-1))

    # controls: ubar = MU v + mu0, U = su ubar
    quad(MU, mu0, torch.kron(eyeM, su[:, None] * g(R) * su[None, :]))
    # rates: dU = Dm ubar + d0 = Gm v + gm, dU_i = (U_i - U_{i-1}) / t_i
    inv_t = torch.repeat_interleave(1.0 / T, nu, dim=-1)            # (S, nuu)
    su_t = su.repeat(M)
    Dm = torch.diag_embed(inv_t * su_t) - torch.diag_embed((inv_t * su_t)[:, nu:], offset=-nu)
    d0 = torch.zeros((S, nuu), dtype=F64, device=device)
    d0[:, :nu] = -u_ic * inv_t[:, :nu]
    Gm = Dm @ MU
    gm = (Dm @ mu0[..., None])[..., 0] + d0
    quad(Gm, gm, torch.kron(eyeM, g(Rd)))
    E = None
    if K:
        q[:, lam] += g(inp["ss_j"])
        E = torch.zeros((S, nx, n), dtype=F64, device=device)
        E[:, :, :nuu] = Phi[:, N - 1]
        E[:, :, lam] = -g(inp["ss_x"]).transpose(1, 2)
        e0 = c[:, N - 1]
        if has_hs:
            hwt = g(hw)
            P += 2.0 * E.transpose(1, 2) @ (hwt[:, None] * E)
            q += 2.0 * (E.transpose(1, 2) @ (hwt * e0)[..., None])[..., 0]
            const += (hwt * e0 * e0).sum(-1)
    if has_sb:
        P[:, i_sb, i_sb] += 2.0 * q_b
    if has_sx:
        P[:, i_sx, i_sx] += 2.0 * q_s

    rows, los, ups, eqs = [], [], [], []

    def add(Ab, lo, up, eq=False):
        rows.append(Ab)
        los.append(lo)
        ups.append(up)
        eqs.append(torch.full((Ab.shape[1],), eq, dtype=torch.bool, device=device))

    def vrows(G, extra=None):
        r = torch.zeros(G.shape[:2] + (n,), dtype=F64, device=device)
        r[:, :, :nuu] = G
        if extra is not None:
            r[:, :, extra[0]] = extra[1]
        return r

    inf = torch.tensor(float("inf"), dtype=F64, device=device)
    margin = _num(mpc["margin"]) + _num(cfg["vehicle"]["chassis"]["b"]) / 2.0
    bl, br = g(inp["bound_left"]), g(inp["bound_right"])
    cpy = c[:, :, 1]
    if has_sb:
        add(vrows(Phi[:, :, 1], (i_sb, -1.0)), -inf.expand(S, N), bl - margin - cpy)
        add(vrows(Phi[:, :, 1], (i_sb, 1.0)), br + margin - cpy, inf.expand(S, N))
    else:
        add(vrows(Phi[:, :, 1]), br + margin - cpy, bl - margin - cpy)

    def box(vals, k, default):
        vals = [_num(v) for v in vals]
        return np.asarray(vals if len(vals) == k else [default] * k)
    u_lo = np.maximum(model.u_lb, box(mpc["u_min"], nu, -np.inf))
    u_hi = np.minimum(model.u_ub, box(mpc["u_max"], nu, np.inf))
    add(vrows(su_t[:, None] * MU), g(np.tile(u_lo, M)) - su_t * mu0, g(np.tile(u_hi, M)) - su_t * mu0)
    add(vrows(Gm), g(np.tile(model.du_lb, M)) - gm, g(np.tile(model.du_ub, M)) - gm)
    x_lo, x_hi = box(mpc["x_min"], nx, -np.inf), box(mpc["x_max"], nx, np.inf)
    for j in range(nx):
        cj = c[:, 1:N - 1, j]
        Fj = Phi[:, 1:N - 1, j]
        if has_sx:
            if np.isfinite(x_hi[j]):
                add(vrows(Fj, (i_sx, -1.0)), -inf.expand(S, N - 2), x_hi[j] - cj)
            if np.isfinite(x_lo[j]):
                add(vrows(Fj, (i_sx, 1.0)), x_lo[j] - cj, inf.expand(S, N - 2))
        elif np.isfinite(x_lo[j]) or np.isfinite(x_hi[j]):
            add(vrows(Fj), x_lo[j] - cj, x_hi[j] - cj)
    for idx, on in ((i_sb, has_sb), (i_sx, has_sx)):
        if on:
            r = torch.zeros((S, 1, n), dtype=F64, device=device)
            r[:, 0, idx] = 1.0
            add(r, torch.zeros((S, 1), dtype=F64, device=device), inf.expand(S, 1))
    if K:
        r = torch.zeros((S, K, n), dtype=F64, device=device)
        r[:, :, lam] = torch.eye(K, dtype=F64, device=device)
        add(r, torch.zeros((S, K), dtype=F64, device=device), inf.expand(S, K))
        r = torch.zeros((S, 1, n), dtype=F64, device=device)
        r[:, 0, lam] = 1.0
        one = torch.ones((S, 1), dtype=F64, device=device)
        add(r, one, one, eq=True)
        if not has_hs:
            add(E, -c[:, N - 1], -c[:, N - 1], eq=True)
    layout = {"nuu": nuu, "nu": nu, "nx": nx, "N": N, "K": K, "n": n, "lam": i_lam}
    data = {"x_ic": x_ic, "u_ic": u_ic, "T": T, "bl": bl, "br": br, "margin": margin,
            "ss_x": g(inp["ss_x"]) if K else None, "ss_j": g(inp["ss_j"]) if K else None,
            "R": g(R), "Rd": g(Rd), "hw": g(hw) if has_hs else None, "q_b": q_b, "q_s": q_s,
            "u_lo": g(u_lo), "u_hi": g(u_hi), "du_lo": g(model.du_lb), "du_hi": g(model.du_ub),
            "x_lo": g(x_lo), "x_hi": g(x_hi)}
    return QP(P=0.5 * (P + P.transpose(1, 2)), q=q, const=const,
              A=torch.cat(rows, 1), l=torch.cat(los, 1), u=torch.cat(ups, 1),
              eq=torch.cat(eqs), Phi=Phi, c=c, MU=MU, mu0=mu0, su=su,
              dyn=(A_, B_, g_), data=data, layout=layout)


def _ruiz(P, q, A, l, u):
    """Ruiz equilibration, per lane: w = d * ws, the rows of A scaled by e;
    each round's factors held to [1e-4, 1e4] (as OSQP holds them), so that a
    row that barely depends on w keeps a finite scale."""
    S, m, n = A.shape
    d = torch.ones((S, n), dtype=F64, device=A.device)
    e = torch.ones((S, m), dtype=F64, device=A.device)
    for _ in range(RUIZ_ROUNDS):
        col = torch.sqrt(torch.maximum(P.abs().amax(1), A.abs().amax(1))).clamp(1e-4, 1e4)
        row = torch.sqrt(A.abs().amax(2)).clamp(1e-4, 1e4)
        P = P / col[:, :, None] / col[:, None, :]
        q = q / col
        A = A / row[:, :, None] / col[:, None, :]
        l, u = l / row, u / row
        d, e = d / col, e / row
    return P, q, A, l, u, d, e


def solve(qp: QP):
    """Optimal w of every lane by a dense Mehrotra predictor-corrector in
    float64, and each lane's certificate: its KKT residuals on the unscaled
    data under 1e-6 (primal), 1e-6 (1 + |q|) (dual) and 1e-6 (1 + |J|)
    (complementarity), four orders under the check's limits.  Returns
    (w (S, n), certified (S,) bool)."""
    P, q, A, l, u, d_sc, e_sc = _ruiz(qp.P, qp.q, qp.A, qp.l, qp.u)
    S, m, n = A.shape
    dev = q.device
    eq = qp.eq[None, :].expand(S, m)
    has_l = torch.isfinite(l) & ~eq
    has_u = torch.isfinite(u) & ~eq
    ie = torch.nonzero(qp.eq)[:, 0]
    Ae, be = A[:, ie], u[:, ie]
    me = len(ie)
    nb = (has_l.sum(-1) + has_u.sum(-1)).clamp(min=1).to(F64)
    zero = torch.zeros((), dtype=F64, device=dev)
    tiny = 1e-300
    l0, u0 = torch.where(has_l, l, zero), torch.where(has_u, u, zero)

    w = torch.zeros((S, n), dtype=F64, device=dev)
    f = (A @ w[..., None])[..., 0]
    s_l = torch.where(has_l, torch.clamp(f - l0, min=1.0), 1.0)
    s_u = torch.where(has_u, torch.clamp(u0 - f, min=1.0), 1.0)
    z_l, z_u = has_l.to(F64), has_u.to(F64)
    y = torch.zeros((S, me), dtype=F64, device=dev)
    best = [w, z_l, z_u, y]
    best_merit = torch.full((S,), float("inf"), dtype=F64, device=dev)
    At = A.transpose(1, 2)
    I_n = torch.eye(n, dtype=F64, device=dev)

    def max_step(v, dv, mask):
        r = torch.where(mask & (dv < 0), -v / torch.where(dv < 0, dv, -1.0), float("inf"))
        return torch.clamp(0.995 * r.amin(-1), max=1.0)

    for _ in range(ITERS):
        f = (A @ w[..., None])[..., 0]
        zz = torch.where(has_u, z_u, zero) - torch.where(has_l, z_l, zero)
        r_d = (P @ w[..., None])[..., 0] + q + (At @ zz[..., None])[..., 0]
        if me:
            r_d = r_d + (Ae.transpose(1, 2) @ y[..., None])[..., 0]
        r_eq = (Ae @ w[..., None])[..., 0] - be
        r_sl = torch.where(has_l, f - l0 - s_l, zero)
        r_su = torch.where(has_u, u0 - f - s_u, zero)
        mu = ((s_l * z_l * has_l).sum(-1) + (s_u * z_u * has_u).sum(-1)) / nb
        rp = (f - torch.clamp(f, l, u)).abs().amax(-1)
        merit = torch.maximum(torch.maximum(r_d.abs().amax(-1), rp), mu)
        if me:
            merit = torch.maximum(merit, r_eq.abs().amax(-1))
        better = merit < best_merit
        best = [torch.where(better[:, None], a, b) for a, b in zip([w, z_l, z_u, y], best)]
        best_merit = torch.minimum(best_merit, merit)
        if bool((best_merit < TOL).all()):
            break
        # a converged lane stops (its barrier weights would overflow): it
        # keeps its iterate and gets an identity system
        done = best_merit < TOL
        d_l = torch.where(has_l, z_l / torch.clamp(s_l, min=tiny), zero).clamp(max=1e30)
        d_u = torch.where(has_u, z_u / torch.clamp(s_u, min=tiny), zero).clamp(max=1e30)
        H = P + At @ ((d_l + d_u)[..., None] * A) + 1e-14 * I_n
        H = torch.where(done[:, None, None] | ~torch.isfinite(H).all(-1).all(-1)[:, None, None],
                        I_n, H)
        # the Newton system [[H, Ae'], [Ae, 0]] by a Cholesky factor of H and
        # the Schur complement of the equality rows
        Lh, _ = torch.linalg.cholesky_ex(H)
        HiAe = torch.cholesky_solve(Ae.transpose(1, 2), Lh) if me else None
        Sc = Ae @ HiAe if me else None

        def kkt_solve(r1, r2):
            x = torch.cholesky_solve(r1[..., None], Lh)
            if not me:
                return x[..., 0], r2
            y = torch.linalg.solve(Sc, (Ae @ x)[..., 0] - r2)
            x = x - HiAe @ y[..., None]
            return x[..., 0], y

        def newton(sig_mu, cl, cu):
            comp_l = torch.where(has_l, s_l * z_l - sig_mu + cl, zero)
            comp_u = torch.where(has_u, s_u * z_u - sig_mu + cu, zero)
            t = (torch.where(has_l, comp_l / torch.clamp(s_l, min=tiny), zero)
                 - torch.where(has_u, comp_u / torch.clamp(s_u, min=tiny), zero)
                 + d_l * r_sl - d_u * r_su)
            dw, dy = kkt_solve(-(r_d + (At @ t[..., None])[..., 0]), -r_eq)
            df = (A @ dw[..., None])[..., 0]
            dsl = torch.where(has_l, df + r_sl, zero)
            dsu = torch.where(has_u, -df + r_su, zero)
            dzl = torch.where(has_l, -(comp_l + z_l * dsl) / torch.clamp(s_l, min=tiny), zero)
            dzu = torch.where(has_u, -(comp_u + z_u * dsu) / torch.clamp(s_u, min=tiny), zero)
            return dw, dy, dsl, dsu, dzl, dzu

        def step_len(dsl, dsu, dzl, dzu):
            return torch.minimum(
                torch.minimum(max_step(s_l, dsl, has_l), max_step(s_u, dsu, has_u)),
                torch.minimum(max_step(z_l, dzl, has_l), max_step(z_u, dzu, has_u)))

        dw, dy, dsl, dsu, dzl, dzu = newton(zero, zero, zero)
        a = step_len(dsl, dsu, dzl, dzu)[:, None]
        mu_aff = (((s_l + a * dsl) * (z_l + a * dzl) * has_l).sum(-1)
                  + ((s_u + a * dsu) * (z_u + a * dzu) * has_u).sum(-1)) / nb
        sigma = torch.clamp((mu_aff / torch.clamp(mu, min=tiny)) ** 3, 0.0, 1.0)[:, None]
        dw, dy, dsl, dsu, dzl, dzu = newton(sigma * mu[:, None], dsl * dzl, dsu * dzu)
        bad = done | ~torch.isfinite(torch.cat([dw, dsl, dsu, dzl, dzu], -1)).all(-1)
        a = torch.where(bad, 0.0, step_len(dsl, dsu, dzl, dzu))[:, None]
        dw, dy, dsl, dsu, dzl, dzu = (torch.nan_to_num(t) for t in (dw, dy, dsl, dsu, dzl, dzu))
        w = w + a * dw
        y = y + a * dy
        s_l = torch.where(has_l, s_l + a * dsl, s_l)
        s_u = torch.where(has_u, s_u + a * dsu, s_u)
        z_l = torch.where(has_l, z_l + a * dzl, z_l)
        z_u = torch.where(has_u, z_u + a * dzu, z_u)

    w, z_l, z_u, y = best
    # unscale and certify on the original data
    ws = d_sc * w
    yrow = torch.where(has_u, z_u, zero) - torch.where(has_l, z_l, zero)
    yfull = yrow.clone()
    yfull[:, ie] = y
    yfull = e_sc * yfull
    Aw = (qp.A @ ws[..., None])[..., 0]
    rp = (Aw - torch.clamp(Aw, qp.l, qp.u)).abs().amax(-1)
    rd = ((qp.P @ ws[..., None])[..., 0] + qp.q
          + (qp.A.transpose(1, 2) @ yfull[..., None])[..., 0]).abs().amax(-1)
    fin_u = torch.isfinite(qp.u) & ~qp.eq
    fin_l = torch.isfinite(qp.l) & ~qp.eq
    comp = (torch.clamp(yfull, min=0) * torch.where(fin_u, (qp.u - Aw).abs(), zero)
            + torch.clamp(-yfull, min=0) * torch.where(fin_l, (Aw - qp.l).abs(), zero))
    comp = torch.where(qp.eq, zero, comp).amax(-1)
    J = qp.objective(ws)
    ok = ((rp < 1e-6) & (rd < 1e-6 * (1 + qp.q.abs().amax(-1)))
          & (comp < 1e-6 * (1 + J.abs())))
    return ws, ok


def plan_cost(qp: QP, X: torch.Tensor, U: torch.Tensor, lam: torch.Tensor | None):
    """What a plan (states X (S, N, nx), controls U (S, N-1, nu), safe-set
    weights lambda (S, K)) costs in each lane's QP, with each slack at the
    least value its plan needs, and how far it breaks the QP's hard rows:
    (cost (S,), defect (S,)).  The defect is the largest of the plan's
    dynamics residual |X_{i+1} - A_i X_i - B_i U_i - g_i| / (1 + |X_{i+1}|)
    (and |X_0 - x_ic| alike), its control, rate and hard state-box
    violations over each box's width, and its lambda's distance from the
    simplex."""
    d, L = qp.data, qp.layout
    A_, B_, g_ = qp.dyn
    N, K = L["N"], L["K"]
    zero = torch.zeros((), dtype=F64, device=X.device)
    nxt = (A_ @ X[:, :-1, :, None] + B_ @ U[..., None])[..., 0] + g_
    defect = torch.cat([((X[:, 1:] - nxt).abs() / (1 + X[:, 1:].abs())).flatten(1),
                        ((X[:, 0] - d["x_ic"]).abs() / (1 + d["x_ic"].abs()))], 1).amax(-1)
    prev = torch.cat([d["u_ic"][:, None], U[:, :-1]], 1)
    dU = (U - prev) / d["T"][..., None]

    def over(v, lo, hi):
        width = torch.where(torch.isfinite(hi - lo), hi - lo, 1.0)
        return (torch.clamp(v - hi, min=0) + torch.clamp(lo - v, min=0)) / width
    defect = torch.maximum(defect, over(U, d["u_lo"], d["u_hi"]).flatten(1).amax(-1))
    defect = torch.maximum(defect, over(dU, d["du_lo"], d["du_hi"]).flatten(1).amax(-1))
    cost = ((U @ d["R"]) * U).sum((1, 2)) + ((dU @ d["Rd"]) * dU).sum((1, 2))
    py = X[:, :, 1]
    m = d["margin"]
    if d["q_b"] > 0:
        sb = torch.clamp(torch.maximum(py - (d["bl"] - m), (d["br"] + m) - py).amax(-1), min=0)
        cost = cost + d["q_b"] * sb * sb
    else:
        defect = torch.maximum(defect, over(py, d["br"] + m, d["bl"] - m).amax(-1))
    Xi = X[:, 1:N - 1]
    box = torch.maximum(Xi - d["x_hi"], d["x_lo"] - Xi)
    box = torch.where(torch.isfinite(box), box, zero)
    if d["q_s"] > 0:
        sx = torch.clamp(box.flatten(1).amax(-1), min=0)
        cost = cost + d["q_s"] * sx * sx
    else:
        defect = torch.maximum(defect, over(Xi, d["x_lo"], d["x_hi"]).flatten(1).amax(-1))
    if K:
        cost = cost + (d["ss_j"] * lam).sum(-1)
        e = X[:, N - 1] - (d["ss_x"].transpose(1, 2) @ lam[..., None])[..., 0]
        if d["hw"] is not None:
            cost = cost + (d["hw"] * e * e).sum(-1)
        else:
            defect = torch.maximum(defect, (e.abs() / (1 + X[:, N - 1].abs())).amax(-1))
        defect = torch.maximum(defect, torch.maximum(torch.clamp(-lam, min=0).amax(-1),
                                                     (lam.sum(-1) - 1).abs()))
    return cost, defect
