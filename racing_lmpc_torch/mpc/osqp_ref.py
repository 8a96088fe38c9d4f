"""Faithful float64 reimplementation of OSQP — the reference's actual solver.

Port of ``racing_lmpc_tpu/mpc/osqp_ref.py``.  The reference hands its QP to
OSQP through CasADi's conic interface with ``{"polish": true}`` and NO
other settings (racing_mpc.cpp:85-103), so the solver the reference
actually flies is **OSQP at its documented defaults**:

    eps_abs = eps_rel = 1e-3, max_iter = 4000, check_termination = 25,
    scaled_termination = false (UNSCALED residual test),
    rho = 0.1 (vectorized, x1e3 on equality rows), adaptive rho
    (tolerance 5), sigma = 1e-6, alpha = 1.6, scaling = 10 Ruiz iters,
    polish = true with delta = 1e-6 and polish_refine_iter = 3.

This module transcribes that algorithm (Stellato et al., "OSQP: an operator
splitting solver for quadratic programs", arXiv:1711.08013) in float64
tensors on one device, term for term:

- modified Ruiz equilibration with cost scaling ``c`` (paper §5.1);
- ADMM iteration via the quasi-definite KKT
      [[P + sigma I, A'], [A, -diag(1/rho)]]
  factored once per rho by a dense LU with partial pivoting (the JAX
  package's sparse LU and OSQP's QDLDL are exact direct solves of the same
  matrix);
- termination every ``check_termination`` iterations on UNSCALED residuals
      r_p <= eps_abs + eps_rel * max(|Ax|_inf, |z|_inf)
      r_d <= eps_abs + eps_rel * max(|Px|_inf, |A'y|_inf, |q|_inf);
- adaptive rho: rho *= sqrt(rel_prim/rel_dual) when the ratio leaves
  [1/5, 5] (ADAPTIVE_RHO_TOLERANCE), checked every ``adaptive_rho_interval``
  iterations (a parameter: OSQP's own interval is time-based);
- polish: active set from the sign of y at termination
  (lower-active y_i < 0, upper-active y_i > 0), reduced KKT with delta
  regularization and ``polish_refine_iter`` refinement rounds against the
  UNregularized KKT, accepted only if both unscaled residuals improve.

The iteration stays on the device; the host reads it only at the
termination and adaptive-rho checks and when a factorization's status is
read.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import Tensor

from racing_lmpc_torch import resolve_device

F64 = torch.float64

# OSQP defaults (include/constants.h of osqp 0.6.x)
RHO = 0.1
SIGMA = 1e-6
ALPHA = 1.6
EPS_ABS = 1e-3
EPS_REL = 1e-3
MAX_ITER = 4000
CHECK_TERMINATION = 25
ADAPTIVE_RHO_TOLERANCE = 5.0
RHO_MIN, RHO_MAX = 1e-6, 1e6
RHO_EQ_SCALE = 1e3
SCALING_ITERS = 10
MIN_SCALING, MAX_SCALING = 1e-4, 1e4
POLISH_DELTA = 1e-6
POLISH_REFINE_ITER = 3


@dataclass
class OSQPResult:
    x: Tensor
    y: Tensor
    z: Tensor
    status: str            # "solved" | "max_iter"
    iters: int
    pri_res: float         # unscaled inf-norm residuals at exit
    dua_res: float
    polished: bool


def _amax(a: Tensor, dim: int) -> Tensor:
    """Max over ``dim``, 0 where that dimension is empty."""
    if a.shape[dim] == 0:
        return a.new_zeros(a.shape[1 - dim])
    return a.amax(dim)


def _ruiz(P, q, A, l, u, iters=SCALING_ITERS):
    """Modified Ruiz equilibration with cost scaling (OSQP scaling.c)."""
    n, m = P.shape[0], A.shape[0]
    D = torch.ones(n, dtype=F64, device=q.device)
    E = torch.ones(m, dtype=F64, device=q.device)
    c = torch.ones((), dtype=F64, device=q.device)
    P, q, A = P.clone(), q.clone(), A.clone()
    for _ in range(iters):
        d_x = torch.sqrt(torch.clamp(torch.maximum(P.abs().amax(0), _amax(A.abs(), 0)),
                                     min=MIN_SCALING))
        d_z = torch.sqrt(torch.clamp(_amax(A.abs(), 1), min=MIN_SCALING))
        d_x = torch.clamp(1.0 / d_x, 1.0 / MAX_SCALING, MAX_SCALING)
        d_z = torch.clamp(1.0 / d_z, 1.0 / MAX_SCALING, MAX_SCALING)
        P *= d_x[:, None] * d_x[None, :]
        q *= d_x
        A *= d_z[:, None] * d_x[None, :]
        # cost scaling
        gamma = 1.0 / torch.clamp(torch.maximum(P.abs().amax(0).mean(), q.abs().max()),
                                  min=MIN_SCALING)
        gamma = torch.clamp(gamma, 1.0 / MAX_SCALING, MAX_SCALING)
        P *= gamma
        q *= gamma
        D *= d_x
        E *= d_z
        c *= gamma
    l = torch.where(torch.isfinite(l), l * E, l)
    u = torch.where(torch.isfinite(u), u * E, u)
    return P, q, A, l, u, D, E, c


def _lu(K: Tensor):
    """Dense LU of ``K`` with partial pivoting; None when a pivot is exactly
    zero (where the JAX package's sparse LU raises)."""
    LU, piv, info = torch.linalg.lu_factor_ex(K)
    if int(info) != 0:
        return None
    return LU, piv


def _lu_solve(lu, b: Tensor) -> Tensor:
    return torch.linalg.lu_solve(lu[0], lu[1], b[:, None])[:, 0]


def _factor_kkt(Ps, As, sigma, rho_vec):
    n = Ps.shape[0]
    eye = torch.eye(n, dtype=F64, device=Ps.device)
    K = torch.cat([torch.cat([Ps + sigma * eye, As.T], 1),
                   torch.cat([As, -torch.diag(1.0 / rho_vec)], 1)], 0)
    lu = _lu(K)
    if lu is None:
        raise RuntimeError("OSQP KKT matrix is exactly singular")
    return lu


def _f64(a, device) -> Tensor:
    return torch.as_tensor(a, dtype=F64, device=device)


def solve(P, q, A, l, u,
          x0: Tensor | None = None, y0: Tensor | None = None,
          eps_abs: float = EPS_ABS, eps_rel: float = EPS_REL,
          max_iter: int = MAX_ITER, rho0: float = RHO,
          adaptive_rho_interval: int = 0,
          check_termination: int = CHECK_TERMINATION,
          do_polish: bool = True, device=None) -> OSQPResult:
    """Run OSQP's algorithm at float64 on dense inputs: on the device of
    ``P`` where it is a tensor, else on ``device`` (CUDA unless the caller
    names another).

    ``adaptive_rho_interval``: 0 disables rho adaptation mid-solve (the
    deterministic floor of OSQP's time-based default); positive values
    check/update every that many iterations (OSQP's ADAPTIVE_RHO_FIXED
    class of behavior).  Warm starting (x0, y0) follows osqp.warm_start:
    z0 is initialized to the projection of A x0.
    """
    device = P.device if isinstance(P, Tensor) else resolve_device(device)
    P, q, A, l, u = (_f64(a, device) for a in (P, q, A, l, u))
    n, m = P.shape[0], A.shape[0]

    Ps, qs, As, ls, us, D, E, c = _ruiz(P, q, A, l, u)
    eq = torch.isfinite(ls) & torch.isfinite(us) & (us - ls < 1e-15)
    ineq = torch.nonzero(~eq).flatten().tolist()
    first_ineq = ineq[0] if ineq else None
    rho_vec = torch.full((m,), rho0, dtype=F64, device=device)
    rho_vec[eq] = rho0 * RHO_EQ_SCALE
    rho_vec = torch.clamp(rho_vec, RHO_MIN, RHO_MAX)

    # scaled warm start
    x = torch.zeros(n, dtype=F64, device=device) if x0 is None else _f64(x0, device) / D
    y = torch.zeros(m, dtype=F64, device=device) if y0 is None else _f64(y0, device) * (c / E)
    z = torch.clamp(As @ x, ls, us)

    lu = _factor_kkt(Ps, As, SIGMA, rho_vec)

    def unscaled_residuals(x, z, y):
        xu = D * x
        zu = z / E
        yu = y * E / c
        Ax = A @ xu
        pri = _amax((Ax - zu).abs(), 0)
        pri_den = torch.maximum(_amax(Ax.abs(), 0), _amax(zu.abs(), 0))
        Px = P @ xu
        Aty = A.T @ yu
        dua = (Px + q + Aty).abs().max()
        dua_den = torch.maximum(torch.maximum(Px.abs().max(), Aty.abs().max()),
                                q.abs().max())
        return pri, dua, pri_den, dua_den

    status, it = "max_iter", max_iter
    for k in range(1, max_iter + 1):
        sol = _lu_solve(lu, torch.cat([SIGMA * x - qs, z - y / rho_vec]))
        x_t, nu = sol[:n], sol[n:]
        z_t = z + (nu - y) / rho_vec
        x = ALPHA * x_t + (1.0 - ALPHA) * x
        z_a = ALPHA * z_t + (1.0 - ALPHA) * z
        z_new = torch.clamp(z_a + y / rho_vec, ls, us)
        y = y + rho_vec * (z_a - z_new)
        z = z_new

        if k % check_termination == 0:
            pri, dua, pri_den, dua_den = unscaled_residuals(x, z, y)
            if bool((pri <= eps_abs + eps_rel * pri_den)
                    & (dua <= eps_abs + eps_rel * dua_den)):
                status, it = "solved", k
                break

        if adaptive_rho_interval and k % adaptive_rho_interval == 0:
            # OSQP compute_rho_estimate (on scaled residuals)
            Axs = As @ x
            rp = _amax((Axs - z).abs(), 0)
            rp_den = torch.clamp(torch.maximum(_amax(Axs.abs(), 0), _amax(z.abs(), 0)),
                                 min=1e-10)
            Pxs = Ps @ x
            Atys = As.T @ y
            rd = (Pxs + qs + Atys).abs().max()
            rd_den = torch.clamp(torch.maximum(torch.maximum(Pxs.abs().max(), Atys.abs().max()),
                                               qs.abs().max()), min=1e-10)
            ratio = float(torch.sqrt((rp / rp_den) / torch.clamp(rd / rd_den, min=1e-10)))
            base = rho_vec[first_ineq] if first_ineq is not None else rho0
            if (ratio > ADAPTIVE_RHO_TOLERANCE
                    or ratio < 1.0 / ADAPTIVE_RHO_TOLERANCE):
                rho_new = torch.clamp(torch.as_tensor(base * ratio, dtype=F64, device=device),
                                      RHO_MIN, RHO_MAX)
                rho_vec = torch.clamp(torch.where(eq, rho_new * RHO_EQ_SCALE, rho_new),
                                      RHO_MIN, RHO_MAX)
                lu = _factor_kkt(Ps, As, SIGMA, rho_vec)

    # unscale
    xu = D * x
    zu = z / E
    yu = y * E / c
    pri, dua, _, _ = unscaled_residuals(x, z, y)
    pri, dua = float(pri), float(dua)

    polished = False
    if do_polish and status == "solved":
        xp, yp = _polish(P, q, A, l, u, xu, yu)
        if xp is not None:
            Axp = A @ xp
            zp = torch.clamp(Axp, l, u)
            prip = float(_amax((Axp - zp).abs(), 0))
            duap = float((P @ xp + q + A.T @ yp).abs().max())
            if prip <= pri and duap <= dua:   # OSQP accepts only improvement
                xu, yu, zu = xp, yp, zp
                pri, dua = prip, duap
                polished = True

    return OSQPResult(x=xu, y=yu, z=zu, status=status, iters=it,
                      pri_res=pri, dua_res=dua, polished=polished)


def _polish(P, q, A, l, u, x, y):
    """OSQP polish.c: active set from the dual signs, reduced regularized
    KKT + refinement against the unregularized KKT.  (None, None) where the
    active bounds are not all finite, the reduced KKT is singular or the
    polished point is not finite."""
    n, m = P.shape[0], A.shape[0]
    low = y < 0.0
    upp = y > 0.0
    act = low | upp
    A_red = A[act]
    b_red = torch.where(low, l, u)[act]
    n_act = A_red.shape[0]
    if not bool(torch.isfinite(b_red).all()):
        return None, None
    eye = torch.eye(n + n_act, dtype=F64, device=P.device)
    K = torch.cat([torch.cat([P, A_red.T], 1),
                   torch.cat([A_red, torch.zeros((n_act, n_act), dtype=F64,
                                                 device=P.device)], 1)], 0)
    K = K + POLISH_DELTA * torch.cat([eye[:n], -eye[n:]])
    lu = _lu(K)
    if lu is None:
        return None, None
    sol = _lu_solve(lu, torch.cat([-q, b_red]))
    # iterative refinement against the unregularized KKT (polish.c
    # iterative_refinement, polish_refine_iter rounds)
    for _ in range(POLISH_REFINE_ITER):
        rx = -q - (P @ sol[:n] + A_red.T @ sol[n:])
        ry = b_red - A_red @ sol[:n]
        sol = sol + _lu_solve(lu, torch.cat([rx, ry]))
    x_pol = sol[:n]
    y_pol = torch.zeros(m, dtype=F64, device=P.device)
    y_pol[act] = sol[n:]
    if not bool(torch.isfinite(x_pol).all() & torch.isfinite(y_pol).all()):
        return None, None
    return x_pol, y_pol
