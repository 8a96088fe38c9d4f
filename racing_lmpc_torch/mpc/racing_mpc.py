"""Racing MPC: batched condensed real-time-iteration MPC and safe-set LMPC.

Port of ``racing_lmpc_tpu/mpc/racing_mpc.py`` (``_Layout``, ``MPCInput``,
``MPCOutput``, ``RacingMPC.__init__``, ``_condense`` with the regression
corrections, ``_rate_map``, ``_build_qp``, both QP backends of
``_solve_impl`` and ``_extract``).  Every input carries a leading batch
dimension B, and ``solve_batch`` is the counterpart of the reference's
``jax.jit(jax.vmap(_solve_impl))``.  See the reference module for the
derivation of the condensing (states eliminated through the
LQR-pre-stabilized chain, controls and rates affine in the decision vector)
and of every row block.

``solve`` (one problem), ``solve_sqp`` (the bootstrap's SQP loop),
``warm_start_vector`` and ``create_warm_start`` are ported for the
controller cycle (``:669-773``).  Not ported yet: the nonlinear
model-constraint rows (no model of the port has any).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

from racing_lmpc_torch import resolve_device
from racing_lmpc_torch.config import RacingMPCConfig
from racing_lmpc_torch.models.base import VehicleModel
from racing_lmpc_torch.mpc.ipm import solve_qp_ip
from racing_lmpc_torch.mpc.qp import QPData, QPSolution, mv, solve_qp
from racing_lmpc_torch.ops.linalg import solve_small, tri_inv_lower
from racing_lmpc_torch.ops.math import align_abscissa

# fixed diagonal variable scaling (racing_mpc.cpp:36-37)
_SCALE_X6 = np.array([2000.0, 10.0, 0.1, 80.0, 2.0, 2.0])
_SCALE_U2 = np.array([10.0, 0.3])
_SCALE_U3 = np.array([10.0, 10.0, 0.3])


class MPCInput(NamedTuple):
    """Per-solve parameters, each with a leading batch dimension B."""
    x_ic: Tensor          # (B, nx)
    u_ic: Tensor          # (B, nu)
    X_ref: Tensor         # (B, N, nx)
    U_ref: Tensor         # (B, N-1, nu)
    T_ref: Tensor         # (B, N-1)
    bound_left: Tensor    # (B, N)
    bound_right: Tensor   # (B, N)
    total_length: Tensor  # (B,)
    curvatures: Tensor    # (B, N)
    vel_ref: Tensor       # (B, N)
    ss_x: Tensor          # (B, K, nx)  padded safe-set states (zeros if unused)
    ss_j: Tensor          # (B, K)     padded relative cost-to-go
    # optional error-dynamics corrections from the safe-set regression
    # (SafeSetManager.query_regression): additive on the stage
    # linearization, constant over the horizon
    dA: Tensor | None = None    # (B, nx, nx)
    dB: Tensor | None = None    # (B, nx, nu)
    dC: Tensor | None = None    # (B, nx)


# the fields every input carries; dA/dB/dC may be None
REQUIRED_FIELDS = MPCInput._fields[:12]


def map_input(fn, inp: MPCInput) -> MPCInput:
    """``fn`` applied to every field of ``inp`` that is not None."""
    return MPCInput(*(None if a is None else fn(a) for a in inp))


class MPCOutput(NamedTuple):
    X_optm: Tensor        # (B, N, nx)
    U_optm: Tensor        # (B, N-1, nu)
    dU_optm: Tensor       # (B, N-1, nu)
    convex_combi: Tensor  # (B, K)
    boundary_slack: Tensor
    r_prim: Tensor
    r_dual: Tensor
    obj: Tensor
    solved: Tensor        # bool: residuals under tolerance
    rp_rel: Tensor        # scaled relative residuals that decide ``solved``
    rd_rel: Tensor


@dataclass
class _Layout:
    """Static index layout of the condensed decision vector / rows.

    Variables:  w = [ubar ((N-1) nu, scaled), sb (1 if soft boundary),
    lambda (K if learning)].  States and control rates are affine in w.
    """
    nx: int
    nu: int
    N: int
    K: int
    has_bslack: bool
    has_hull_slack: bool      # hull slack eliminated into the cost
    learning: bool
    n_nl: int = 0             # nonlinear model-constraint rows per stage
    has_xslack: bool = False  # elastic state boxes (q_state_slack > 0)
    n: int = 0
    m: int = 0

    def __post_init__(self):
        nx, nu, N, K = self.nx, self.nu, self.N, self.K
        self.nuu = (N - 1) * nu          # stacked scaled controls
        self.u0_off = 0
        off = self.nuu
        self.sb_off = off
        off += 1 if self.has_bslack else 0
        self.sxb_off = off
        off += 1 if self.has_xslack else 0
        self.lam_off = off
        off += K if self.learning else 0
        self.n = off

        # constraint rows (see the reference's _Layout for why model bounds
        # and the u box are merged, and why stage 0 / the terminal state
        # carry no state box)
        r = 0
        self.r_bound_up = r; r += N
        self.r_bound_lo = r; r += N
        if self.has_bslack:
            self.r_sb = r; r += 1
        self.r_u_bnd = r; r += (N - 1) * nu      # model bounds ∩ u box
        self.r_du_bnd = r; r += (N - 1) * nu
        self.r_x_box = r; r += (N - 2) * nx
        if self.has_xslack:
            self.r_x_box_lo = r; r += (N - 2) * nx
        if self.has_xslack:
            self.r_sxb = r; r += 1               # slack >= 0
        self.r_nl = r; r += (N - 1) * self.n_nl
        if self.learning:
            self.r_lam_pos = r; r += K
            self.r_lam_sum = r; r += 1
            if not self.has_hull_slack:
                self.r_hull = r; r += nx
        self.m = r


class RacingMPC:
    """Build-once / solve-many batched MPC on one device (CUDA by default)."""

    def __init__(self, config: RacingMPCConfig, model: VehicleModel,
                 device=None):
        self.device = resolve_device(device)
        if model.n_nl:
            raise NotImplementedError(
                "nonlinear model-constraint rows are not ported yet")
        if config.qp_method not in ("ipm", "admm"):
            raise ValueError(f"qp_method={config.qp_method!r}: 'ipm' or 'admm'")
        self.config = config
        self.model = model
        nx, nu, N = model.nx, model.nu, config.n
        self.nx, self.nu, self.N = nx, nu, N
        self.K = config.num_ss_pts if config.learning else 0

        hull_w = np.asarray(config.convex_hull_slack, dtype=np.float64)
        self.has_hull_slack = bool(config.learning and hull_w.size and hull_w.sum() > 0)
        self.has_bslack = bool(config.q_boundary > 0.0)
        self.has_xslack = bool(config.q_state_slack > 0.0)
        self.layout = _Layout(
            nx=nx, nu=nu, N=N, K=self.K,
            has_bslack=self.has_bslack,
            has_hull_slack=self.has_hull_slack,
            learning=bool(config.learning),
            n_nl=int(model.n_nl),
            has_xslack=self.has_xslack)

        scale_override = model.state_scales()
        self.scale_x = (np.asarray(scale_override)
                        if scale_override is not None
                        else np.asarray(_SCALE_X6[:nx] if nx <= 6
                                        else np.ones(nx)))
        self.scale_u = np.asarray(_SCALE_U2 if nu == 2 else _SCALE_U3[:nu])
        self.hull_w = hull_w if self.has_hull_slack else np.zeros(nx)

        ci = model.cost_state_indices()
        self.idx_contour = ci["contour"]
        self.idx_heading = ci["heading"]
        self.idx_vel = ci["vel"]
        self.idx_vy = ci["vy"]
        self.idx_vyaw = ci["vyaw"]

        self.R = config.R(nu)
        self.R_d = config.R_d(nu)
        self.bounds = model.control_bounds()
        self.margin = config.margin + model.base_config.chassis.b / 2.0

        # remaining equality rows after condensing: the lambda simplex (and
        # the hull rows when the hull constraint is hard)
        L = self.layout
        eq = []
        if config.learning:
            eq.append(np.array([L.r_lam_sum]))
            if not self.has_hull_slack:
                eq.append(np.arange(L.r_hull, L.r_hull + nx))
        self.eq_rows = (np.concatenate(eq) if eq
                        else np.zeros((0,), dtype=np.int64))

        # static sparsity structure of A for the IPM's normal-equations
        # product: dense rows hit only the leading nc columns, lambda rows
        # are one-hot, the rest are equality rows
        nc_dense = (L.nuu + (1 if self.has_bslack else 0)
                    + (1 if self.has_xslack else 0))
        m_dense = L.r_lam_pos if config.learning else L.m
        if config.learning:
            diag_rows = np.arange(L.r_lam_pos, L.r_lam_pos + self.K)
            diag_cols = L.lam_off + np.arange(self.K)
        else:
            diag_rows = np.zeros((0,), dtype=np.int64)
            diag_cols = np.zeros((0,), dtype=np.int64)
        if m_dense + len(diag_rows) + len(self.eq_rows) != L.m:
            raise AssertionError("row blocks do not cover the QP")
        self.qp_struct = (np.arange(m_dense), nc_dense, diag_rows, diag_cols)

        # static tracking weight table (N, nx): 2*w entries; terminal x10
        Wv = np.zeros((N, nx))
        if not config.learning:
            for i in range(N):
                term = i == N - 1
                Wv[i, self.idx_contour] = config.q_contour * (10.0 if term else 1.0)
                Wv[i, self.idx_heading] = config.q_heading * (10.0 if term else 1.0)
                Wv[i, self.idx_vel] = config.q_vel * (10.0 if term else 1.0)
                if not term:
                    if self.idx_vy is not None:
                        Wv[i, self.idx_vy] = config.q_vy
                    if self.idx_vyaw is not None:
                        Wv[i, self.idx_vyaw] = config.q_vyaw
        self._Wv = Wv

        # device constants, cast to f32 from the f64 host values as the
        # reference casts them at trace time
        def dev(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                   device=self.device)
        su = self.scale_u
        Ru = dev(su[:, None] * self.R * su[None, :]) * 2.0
        Rdu = dev(su[:, None] * self.R_d * su[None, :]) * 2.0
        self._c = {
            "su": dev(su), "sx": dev(self.scale_x), "hw": dev(self.hull_w),
            "Wv": dev(Wv).reshape(N * nx),
            "Ru_blk": torch.block_diag(*([Ru] * (N - 1))),
            "Rdu_blk": torch.block_diag(*([Rdu] * (N - 1))),
        }
        u_min = np.asarray(config.u_min if len(config.u_min) == nu else [-np.inf] * nu)
        u_max = np.asarray(config.u_max if len(config.u_max) == nu else [np.inf] * nu)
        x_min = np.asarray(config.x_min if len(config.x_min) == nx else [-np.inf] * nx)
        x_max = np.asarray(config.x_max if len(config.x_max) == nx else [np.inf] * nx)
        self._c.update({
            "u_lb": dev(np.maximum(np.asarray(self.bounds.u_lb), u_min)).repeat(N - 1),
            "u_ub": dev(np.minimum(np.asarray(self.bounds.u_ub), u_max)).repeat(N - 1),
            "du_lb": dev(self.bounds.du_lb).repeat(N - 1),
            "du_ub": dev(self.bounds.du_ub).repeat(N - 1),
            "x_min": dev(x_min).repeat(N - 2),
            "x_max": dev(x_max).repeat(N - 2),
        })

    # ------------------------------------------------------------------
    def _condense(self, inp: MPCInput):
        """Feedback-pre-stabilized state/rate elimination (``:292-369``).

        Returns (F, f, MU, mu0):
        - unscaled states:         X_i    = F[:, i] @ v + f[:, i]  (B, N, nx, nvv)
        - stacked scaled controls: ubar   = MU @ v + mu0           (B, nvv, nvv)
        """
        L = self.layout
        nx, nu, N = self.nx, self.nu, self.N
        B = inp.x_ic.shape[0]
        dtype, device = inp.x_ic.dtype, inp.x_ic.device
        su = self._c["su"]

        As, Bs, gs = self.model.discrete_dynamics_jacobian(
            inp.X_ref[:, :-1], inp.U_ref, inp.curvatures[:, :-1], inp.T_ref)
        if inp.dA is not None:
            # data-driven error-dynamics correction: the corrected model
            # f(x, u) + dA x + dB u + dC linearizes at the reference to
            # (A + dA, B + dB, g + dC) (``racing_mpc.py:321-327``)
            As = As + inp.dA[:, None]
            Bs = Bs + inp.dB[:, None]
            gs = gs + inp.dC[:, None]
        Bs_s = Bs * su                           # absorb control scale

        # backward Riccati for the pre-stabilizing gains (scaled controls,
        # states weighted by the fixed diagonal scaling racing_mpc.cpp:36)
        sx = self._c["sx"]
        Q_lqr = torch.diag(1.0 / sx ** 2)
        I_nu = torch.eye(nu, dtype=dtype, device=device)
        Pn = Q_lqr.expand(B, nx, nx)
        Ks = [None] * (N - 1)
        for i in reversed(range(N - 1)):
            Ai, Bi = As[:, i], Bs_s[:, i]
            BtP = Bi.transpose(-1, -2) @ Pn
            Ki = solve_small(I_nu + BtP @ Bi, BtP @ Ai)
            Acl = Ai - Bi @ Ki
            Pi = Q_lqr + Ai.transpose(-1, -2) @ Pn @ Acl
            Pn = 0.5 * (Pi + Pi.transpose(-1, -2))
            Ks[i] = Ki

        Fs = [torch.zeros((B, nx, L.nuu), dtype=dtype, device=device)]
        fs = [inp.x_ic]
        MUs, mu0s = [], []
        for i in range(N - 1):
            cols = slice(i * nu, (i + 1) * nu)
            # ubar_i = v_i - K_i (x_i - xref_i)
            MUi = -Ks[i] @ Fs[i]
            MUi[:, :, cols] += I_nu
            mu0i = mv(-Ks[i], fs[i] - inp.X_ref[:, i])
            MUs.append(MUi)
            mu0s.append(mu0i)
            Acl = As[:, i] - Bs_s[:, i] @ Ks[i]
            Fi = Acl @ Fs[i]
            Fi[:, :, cols] += Bs_s[:, i]
            Fs.append(Fi)
            fs.append(mv(As[:, i], fs[i]) + mv(Bs_s[:, i], mu0i) + gs[:, i])
        F = torch.stack(Fs, dim=1)               # (B, N, nx, nvv)
        f = torch.stack(fs, dim=1)               # (B, N, nx)
        MU = torch.cat(MUs, dim=1)               # (B, nvv, nvv) block rows
        mu0 = torch.cat(mu0s, dim=1)             # (B, nvv)
        return F, f, MU, mu0

    def _rate_map(self, inp: MPCInput, MU: Tensor, mu0: Tensor):
        """Scaled rate map through the feedback map: dubar = Gm @ v + gm
        with dubar_i = (ubar_i - ubar_{i-1}) / t_i, ubar_{-1} = u_ic / su."""
        nu = self.nu
        su = self._c["su"]
        diag = torch.repeat_interleave(1.0 / inp.T_ref, nu, dim=-1)   # (B, nvv)
        Gd = torch.diag_embed(diag) - torch.diag_embed(diag[:, nu:], offset=-nu)
        gd0 = torch.zeros_like(diag)
        gd0[:, :nu] = -(inp.u_ic / su) * diag[:, :nu]
        return Gd @ MU, mv(Gd, mu0) + gd0

    # ------------------------------------------------------------------
    def _build_qp(self, inp: MPCInput):
        """Condensed QP assembly (``:384-576``).  Returns (QPData, aux) with
        aux the affine maps needed to recover X/dU from the solution."""
        L = self.layout
        nx, nu, N, K = self.nx, self.nu, self.N, self.K
        B = inp.x_ic.shape[0]
        dtype, device = inp.x_ic.dtype, inp.x_ic.device
        c = self._c
        su = c["su"]
        cfg = self.config

        # wrap reference abscissae into the vehicle's current period
        # (racing_mpc.cpp:219-223)
        X_ref = inp.X_ref.clone()
        X_ref[:, :, 0] = align_abscissa(
            X_ref[:, :, 0], inp.x_ic[:, :1].expand(B, N),
            inp.total_length[:, None].expand(B, N))
        inp = inp._replace(X_ref=X_ref)

        F, f, MU, mu0 = self._condense(inp)
        Gm, gm = self._rate_map(inp, MU, mu0)
        nuu = L.nuu
        MUT, GmT = MU.transpose(-1, -2), Gm.transpose(-1, -2)

        P = torch.zeros((B, L.n, L.n), dtype=dtype, device=device)
        q = torch.zeros((B, L.n), dtype=dtype, device=device)
        A = torch.zeros((B, L.m, L.n), dtype=dtype, device=device)
        lo = torch.full((B, L.m), -torch.inf, dtype=dtype, device=device)
        up = torch.full((B, L.m), torch.inf, dtype=dtype, device=device)

        # ---- cost ------------------------------------------------------
        # control effort through ubar = MU v + mu0 (P convention: 1/2 w'Pw)
        P[:, :nuu, :nuu] += MUT @ (c["Ru_blk"] @ MU)
        q[:, :nuu] += mv(MUT, mv(c["Ru_blk"], mu0))
        # rate effort through the rate map: dubar = Gm v + gm
        P[:, :nuu, :nuu] += GmT @ (c["Rdu_blk"] @ Gm)
        q[:, :nuu] += mv(GmT, mv(c["Rdu_blk"], gm))

        if cfg.learning:
            # LMPC cost: ss_costs . lambda (build_lmpc_cost, :504)
            q[:, L.lam_off:L.lam_off + K] += inp.ss_j
            # hull slack eliminated: cost sum_a hw_a (X_N,a - [SS lam]_a)^2
            if self.has_hull_slack:
                hw = c["hw"]
                E = torch.zeros((B, nx, L.n), dtype=dtype, device=device)
                E[:, :, :nuu] = F[:, N - 1]
                E[:, :, L.lam_off:L.lam_off + K] = -inp.ss_x.transpose(-1, -2)
                ET = E.transpose(-1, -2)
                P = P + (2.0 * (ET * hw)) @ E
                q = q + mv(2.0 * ET, hw * f[:, N - 1])
        else:
            # tracking stage cost over the eliminated states
            wv = c["Wv"]                                     # (N * nx,)
            Ref = torch.zeros((B, N, nx), dtype=dtype, device=device)
            Ref[:, :, self.idx_vel] = inp.vel_ref
            Fm = F.reshape(B, N * nx, nuu)
            FmT = Fm.transpose(-1, -2)
            fv = f.reshape(B, N * nx)
            P[:, :nuu, :nuu] += (2.0 * (FmT * wv)) @ Fm
            q[:, :nuu] += mv(2.0 * FmT, wv * (fv - Ref.reshape(B, -1)))

        if self.has_bslack:
            P[:, L.sb_off, L.sb_off] += 2.0 * cfg.q_boundary
        if self.has_xslack:
            P[:, L.sxb_off, L.sxb_off] += 2.0 * cfg.q_state_slack

        # ---- track boundary (build_boundary_constraint, :524-543) -------
        F_py = F[:, :, self.idx_contour, :]                 # (B, N, nuu)
        f_py = f[:, :, self.idx_contour]
        rows_up = slice(L.r_bound_up, L.r_bound_up + N)
        rows_lo = slice(L.r_bound_lo, L.r_bound_lo + N)
        A[:, rows_up, :nuu] = F_py
        A[:, rows_lo, :nuu] = F_py
        if self.has_bslack:
            A[:, rows_up, L.sb_off] = -1.0   # PY - sb <= left - margin
            A[:, rows_lo, L.sb_off] = 1.0    # PY + sb >= right + margin
            A[:, L.r_sb, L.sb_off] = 1.0
            lo[:, L.r_sb] = 0.0
        up[:, rows_up] = inp.bound_left - self.margin - f_py
        lo[:, rows_lo] = inp.bound_right + self.margin - f_py

        # ---- per-stage control & rate bounds ----------------------------
        # control rows: su * ubar = su * (MU v + mu0); rate rows likewise
        su_t = su.repeat(N - 1)
        ub_rows = slice(L.r_u_bnd, L.r_u_bnd + nuu)
        A[:, ub_rows, :nuu] = su_t[:, None] * MU
        lo[:, ub_rows] = c["u_lb"] - su_t * mu0
        up[:, ub_rows] = c["u_ub"] - su_t * mu0
        dub_rows = slice(L.r_du_bnd, L.r_du_bnd + nuu)
        A[:, dub_rows, :nuu] = su_t[:, None] * Gm
        lo[:, dub_rows] = c["du_lb"] - su_t * gm
        up[:, dub_rows] = c["du_ub"] - su_t * gm

        # ---- primal state boxes on stages 1..N-2 (racing_mpc.cpp:147),
        # elastic when q_state_slack > 0 ----------------------------------
        nxb = (N - 2) * nx
        xb_rows = slice(L.r_x_box, L.r_x_box + nxb)
        Fx_rows = F[:, 1:N - 1].reshape(B, nxb, nuu)
        A[:, xb_rows, :nuu] = Fx_rows
        fx = f[:, 1:N - 1].reshape(B, -1)
        xmin_t = c["x_min"] - fx
        xmax_t = c["x_max"] - fx
        if self.has_xslack:
            A[:, xb_rows, L.sxb_off] = -1.0
            up[:, xb_rows] = xmax_t
            xl_rows = slice(L.r_x_box_lo, L.r_x_box_lo + nxb)
            A[:, xl_rows, :nuu] = Fx_rows
            A[:, xl_rows, L.sxb_off] = 1.0
            lo[:, xl_rows] = xmin_t
            A[:, L.r_sxb, L.sxb_off] = 1.0
            lo[:, L.r_sxb] = 0.0
        else:
            lo[:, xb_rows] = xmin_t
            up[:, xb_rows] = xmax_t

        # ---- LMPC lambda simplex + (hard) hull (build_lmpc_cost) --------
        if cfg.learning:
            lam_cols = slice(L.lam_off, L.lam_off + K)
            lp_rows = slice(L.r_lam_pos, L.r_lam_pos + K)
            A[:, lp_rows, lam_cols] = torch.eye(K, dtype=dtype, device=device)
            lo[:, lp_rows] = 0.0
            A[:, L.r_lam_sum, lam_cols] = 1.0
            lo[:, L.r_lam_sum] = 1.0
            up[:, L.r_lam_sum] = 1.0
            if not self.has_hull_slack:
                hull_rows = slice(L.r_hull, L.r_hull + nx)
                A[:, hull_rows, :nuu] = F[:, N - 1]
                A[:, hull_rows, lam_cols] = -inp.ss_x.transpose(-1, -2)
                lo[:, hull_rows] = -f[:, N - 1]
                up[:, hull_rows] = -f[:, N - 1]

        return QPData(P=P, q=q, A=A, l=lo, u=up), (F, f, MU, mu0, Gm, gm)

    # ------------------------------------------------------------------
    def _solve_impl(self, inp: MPCInput, z_warm: Tensor, warm_valid: Tensor
                    ) -> tuple[MPCOutput, Tensor]:
        data, aux = self._build_qp(inp)
        cfg = self.config
        if cfg.qp_method == "ipm":
            # interior point restarts from the central path; the warm start
            # is not used
            sol = solve_qp_ip(data, eq_rows=self.eq_rows, iters=cfg.qp_ip_iters,
                              struct=self.qp_struct,
                              zoom_rounds=cfg.qp_zoom_rounds,
                              zoom_iters=cfg.qp_zoom_iters or None)
        else:
            # the warm start packs scaled controls ubar = MU v + mu0; map it
            # to the decision variable v through MU^-1 (block-unit-lower-
            # triangular), with the reference's plain blocked inverse
            # (``racing_mpc.py:598-616``); lanes without a valid warm start
            # start from zero
            _, _, MU, mu0, _, _ = aux
            nuu = self.layout.nuu
            v0 = mv(tri_inv_lower(MU), z_warm[:, :nuu] - mu0)
            x0 = torch.where(warm_valid[:, None],
                             torch.cat([v0, z_warm[:, nuu:]], dim=-1),
                             torch.zeros_like(z_warm))
            sol = solve_qp(data, iters=cfg.qp_iters, rho=cfg.qp_rho,
                           sigma=cfg.qp_sigma, alpha=cfg.qp_alpha,
                           do_polish=cfg.qp_polish, x0=x0)
        out = self._extract(sol, aux)
        # the returned warm-start vector carries SCALED CONTROLS (ubar =
        # U/su) in the leading block, as the reference's does
        z_ret = sol.x.clone()
        z_ret[:, :self.layout.nuu] = (out.U_optm / self._c["su"]).flatten(1)
        return out, z_ret

    def _extract(self, sol: QPSolution, aux) -> MPCOutput:
        L = self.layout
        nu, N, K = self.nu, self.N, self.K
        B = sol.x.shape[0]
        su = self._c["su"]
        F, f, MU, mu0, Gm, gm = aux
        v = sol.x[:, :L.nuu]
        X = f + torch.matmul(F, v[:, None, :, None])[..., 0]
        U = (mv(MU, v) + mu0).reshape(B, N - 1, nu) * su
        dU = (mv(Gm, v) + gm).reshape(B, N - 1, nu) * su
        lam = (sol.x[:, L.lam_off:L.lam_off + K] if self.config.learning
               else sol.x.new_zeros((B, 0)))
        sb = sol.x[:, L.sb_off] if self.has_bslack else sol.x.new_zeros((B,))
        # OSQP-style scaled relative termination test (see scaled_residuals)
        tol = self.config.tol
        solved = (sol.rp_rel < tol) & (sol.rd_rel < tol)
        return MPCOutput(
            X_optm=X, U_optm=U, dU_optm=dU, convex_combi=lam,
            boundary_slack=sb, r_prim=sol.r_prim, r_dual=sol.r_dual,
            obj=sol.obj, solved=solved, rp_rel=sol.rp_rel, rd_rel=sol.rd_rel)

    # ------------------------------------------------------------------
    def solve_batch(self, inp: MPCInput, z_warm: Tensor | None = None,
                    warm_valid: Tensor | None = None) -> tuple[MPCOutput, Tensor]:
        """Solve a batch of problems (leading dimension B on every input) on
        this MPC's device, each lane warm-started from ``z_warm`` (B, n)
        where ``warm_valid`` (B,) holds (the ADMM backend's start; none by
        default).  Returns (output, warm-start vectors (B, n))."""
        inp = map_input(lambda a: torch.as_tensor(a, dtype=torch.float32).to(self.device), inp)
        B = inp.x_ic.shape[0]
        if z_warm is None:
            z_warm = inp.x_ic.new_zeros((B, self.layout.n))
            warm_valid = torch.zeros((B,), dtype=torch.bool, device=self.device)
        z_warm = torch.as_tensor(z_warm, dtype=torch.float32).to(self.device)
        warm_valid = torch.as_tensor(warm_valid, dtype=torch.bool).to(self.device)
        return self._solve_impl(inp, z_warm, warm_valid)

    def solve(self, inp: MPCInput, z_warm: Tensor | None = None
              ) -> tuple[MPCOutput, Tensor]:
        """One RTI solve: ``inp`` without the batch dimension.  Returns the
        output and the warm-start vector for the next call (scaled controls
        in the leading block, as ``warm_start_vector`` packs them).  The
        ADMM backend starts from ``z_warm`` when it is given; the interior
        point method restarts from the central path and does not use it."""
        one = map_input(lambda a: torch.as_tensor(a)[None], inp)
        if z_warm is None:
            out, z = self.solve_batch(one)
        else:
            out, z = self.solve_batch(one, torch.as_tensor(z_warm)[None],
                                      torch.ones((1,), dtype=torch.bool))
        return MPCOutput(*(a[0] for a in out)), z[0]

    def _rollout(self, inp: MPCInput, U: Tensor) -> Tensor:
        """Nonlinear rollout of ``U`` from ``inp.x_ic`` through the model's
        discrete dynamics at the reference's curvatures and step lengths."""
        xs = [inp.x_ic]
        for i in range(self.N - 1):
            xs.append(self.model.discrete_dynamics(
                xs[-1], U[i], inp.curvatures[i], inp.T_ref[i]))
        return torch.stack(xs)

    def solve_sqp(self, inp: MPCInput, iters: int = 5) -> tuple[MPCOutput, Tensor]:
        """SQP loop in place of the reference node's IPOPT bootstrap
        (``racing_mpc.py:684-715``): re-linearize at the nonlinear rollout
        of the current controls and re-solve, damping each control update
        by alpha = 0.5; the output carries the damped controls and their
        rollout."""
        inp = map_input(lambda a: torch.as_tensor(a, dtype=torch.float32).to(self.device), inp)
        out, z = self.solve(inp)
        U = out.U_optm
        for _ in range(iters - 1):
            inp = inp._replace(X_ref=self._rollout(inp, U), U_ref=U)
            out, z = self.solve(inp, z)
            U = U + 0.5 * (out.U_optm - U)
        return out._replace(U_optm=U, X_optm=self._rollout(inp, U)), z

    def warm_start_vector(self, X: Tensor, U: Tensor, dU: Tensor,
                          lam: Tensor | None = None) -> Tensor:
        """Pack (unscaled) trajectories into the condensed decision vector
        (``racing_mpc.py:718-733``): scaled controls, and the convex
        combination (uniform when none of the safe set's size is given).
        X and dU are implied by U in the condensed form."""
        L = self.layout
        z = U.new_zeros((L.n,))
        z[:L.nuu] = (U / self._c["su"].to(U)).flatten()
        if self.config.learning:
            lam_blk = slice(L.lam_off, L.lam_off + self.K)
            if lam is not None and lam.shape[0] == self.K:
                z[lam_blk] = lam
            else:
                z[lam_blk] = 1.0 / self.K
        return z

    def create_warm_start(self, P0, Yaws, Radii, current_vel: float,
                          target_vel: float) -> tuple[Tensor, Tensor, Tensor]:
        """Physics-based initial reference (``racing_mpc.py:735-773``,
        racing_mpc.cpp:374-430): linspace speeds, F = m a forces,
        pure-pursuit steering.  Returns (X_ref, U_ref, T_ref) in the
        model's control layout, f32 on this MPC's device."""
        N, nx, nu = self.N, self.nx, self.nu
        if not current_vel > 0.0:
            raise ValueError(f"current_vel must be positive, got {current_vel}")
        if not target_vel > 0.0:
            raise ValueError(f"target_vel must be positive, got {target_vel}")
        P0, Radii = np.asarray(P0), np.asarray(Radii)
        m_total = self.model.base_config.chassis.total_mass
        wheel_base = self.model.base_config.chassis.wheel_base
        X_ref = np.zeros((N, nx))
        X_ref[:, 0:2] = P0
        X_ref[:, 2] = np.asarray(Yaws)
        vels = np.linspace(current_vel, target_vel, N)
        X_ref[:, self.idx_vel] = vels
        if self.idx_vyaw is not None:
            X_ref[:, self.idx_vyaw] = vels / Radii
        U_ref = np.zeros((N - 1, nu))
        T_ref = np.zeros(N - 1)
        for i in range(N - 1):
            d = float(np.hypot(*(P0[i] - P0[i + 1])))
            if not d > 0.0:
                raise ValueError(f"coincident warm-start waypoints at {i}")
            fo = m_total * (vels[i + 1] ** 2 - vels[i] ** 2) / (2 * d)
            steer = float(np.arctan(wheel_base / Radii[i]))
            U_ref[i] = ([fo / 1000.0, steer] if nu == 2
                        else [max(fo, 0.0), min(fo, 0.0), steer])
            T_ref[i] = d / vels[i]
        return tuple(torch.as_tensor(a, dtype=torch.float32, device=self.device)
                     for a in (X_ref, U_ref, T_ref))
