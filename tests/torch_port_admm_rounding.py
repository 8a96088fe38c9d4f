"""How far rounding alone moves the flagship ADMM batch, and where the port
lies inside that spread.

On the CPU, from the repository root (JAX and the port side by side, about
five minutes):

    JAX_PLATFORMS=cpu python tests/torch_port_admm_rounding.py [reductions]

The batch of ``chip_smoke.py``'s ``barc_n20_k48_b256_admm`` (the reference's
QP data of each lane) is solved in f32 by

- the reference as stored (one batch of 256), in batches of 16 and of 1,
  and with the two triangular products of its KKT solve summed in reverse
  order: the same code and arithmetic, other orders of its f32 sums;
- the port (``racing_lmpc_torch.mpc.qp.solve_qp`` on the CPU), and the port
  with the reference's own ``L^-1`` in place of its factorization;

and each run is read with ``chip_smoke.py``'s ADMM gates against the stored
reference run, as one run of the gates reads it, beside the gates' limits
(the reference's worst reading over its stored runs).  Each run's distance
from the same algorithm in float64 says how far its f32 rounding carries
it.  Last, the reference and the port both in float64: where rounding no
longer steers the iterate, how far apart the two algorithms are.

With ``reductions`` (about ten minutes) it runs instead the port with the
reference's ``L^-1`` and, one at a time, each of the other f32 reductions
of an ADMM chunk computed by the reference's own XLA code on the port's
operands (``REDUCTIONS``), then all of them at once, then the triangular
products alone with the port's own ``L^-1``: how many of the ``solved``
flags each one moves back to the stored run's.
"""

from __future__ import annotations

import inspect
import sys
import textwrap
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT, ROOT / "tests"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

CASE = "barc_n20_k48_b256_admm"
# the f32 reductions of one ADMM chunk besides the factorization
# (racing_lmpc_tpu/mpc/qp.py:165-199): the KKT matrix, the right side, the
# two triangular products, the constraint product, and the residuals of the
# adaptive-rho rule
REDUCTIONS = ("kkt", "rhs", "x_t", "z_t", "residuals")


def main() -> int:
    import torch_port_fixture as F
    F._jax_on_cpu()
    import jax
    import jax.numpy as jnp
    import torch

    import chip_smoke as cs
    import racing_lmpc_tpu.mpc.qp as jqp
    import racing_lmpc_torch.mpc.qp as tqp
    from racing_lmpc_torch.ops import linalg as tl
    from racing_lmpc_tpu.benchmarks import build_barc_lmpc, make_scenario_batch
    from racing_lmpc_tpu.ops.pallas_linalg import chol_lower, tri_inv_lower

    ipm_case, overrides = F.ADMM_CASES[CASE]
    n_horizon, num_ss, per_lap, B = F.CASES[ipm_case]
    _, track, _, mpc, manager = build_barc_lmpc(
        n_horizon=n_horizon, num_ss=num_ss, num_ss_per_lap=per_lap, **overrides)
    inp = make_scenario_batch(mpc, track, manager, B, seed=F.SEED)
    cfg, L, tol = mpc.config, mpc.layout, mpc.config.tol
    fx = cs.load_batch_fixture(CASE)
    limits = cs.gate_limits(fx, cs.ADMM_GATE_FLOORS)
    stored = cs.reference_runs(fx)[0]
    with jax.default_matmul_precision("highest"):
        data, aux = jax.jit(jax.vmap(mpc._build_qp))(inp)
    arrays = [np.asarray(a) for a in data]
    _, _, MU, mu0, _, _ = (np.asarray(a, np.float64) for a in aux)
    su = np.asarray(mpc.scale_u, np.float64)
    qp_kw = dict(iters=cfg.qp_iters, rho=cfg.qp_rho, sigma=cfg.qp_sigma,
                 alpha=cfg.qp_alpha, do_polish=cfg.qp_polish)

    def from_qp(x, obj, rp_rel, rd_rel) -> dict:
        """A QP solution as chip_smoke reads an MPC output (its _extract)."""
        x = np.asarray(x, np.float64)
        U = (np.einsum("bij,bj->bi", MU, x[:, :L.nuu]) + mu0).reshape(B, mpc.N - 1, mpc.nu)
        return {"U": U * su, "obj": np.asarray(obj, np.float64),
                "solved": (np.asarray(rp_rel) < tol) & (np.asarray(rd_rel) < tol)}

    def reference(admm=None, dtype=jnp.float32) -> dict:
        orig = jqp.admm_solve
        jqp.admm_solve = admm or orig
        try:
            solve = jax.jit(jax.vmap(lambda d: jqp.solve_qp(d, x0=jnp.zeros_like(d.q), **qp_kw)))
            sol = solve(jqp.QPData(*(jnp.asarray(a, dtype) for a in arrays)))
            return from_qp(sol.x, sol.obj, sol.rp_rel, sol.rd_rel)
        finally:
            jqp.admm_solve = orig

    def reference_in_batches(size: int) -> dict:
        z0 = jnp.zeros((B, L.n), jnp.float32)
        no_warm = jnp.zeros((B,), bool)
        outs = [mpc.solve_batch(jax.tree_util.tree_map(lambda a: a[i:i + size], inp),
                                z0[i:i + size], no_warm[i:i + size])[0]
                for i in range(0, B, size)]
        return {"U": np.concatenate([np.asarray(o.U_optm) for o in outs]).astype(np.float64),
                "obj": np.concatenate([np.asarray(o.obj) for o in outs]).astype(np.float64),
                "solved": np.concatenate([np.asarray(o.solved) for o in outs])}

    def reversed_sums():
        """The reference's admm_solve with its KKT solve Li' (Li rhs) summed
        from the last term to the first (the same products)."""
        src = textwrap.dedent(inspect.getsource(jqp.admm_solve))
        line = "x_t = Li.T @ (Li @ rhs)"
        assert src.count(line) == 1
        src = src.replace(line, "x_t = Li.T[:, ::-1] @ (Li[:, ::-1] @ rhs[::-1])[::-1]")
        scope = dict(vars(jqp))
        exec(src, scope)
        return scope["admm_solve"]

    def port(dtype=torch.float32, factor=None) -> dict:
        orig = tqp.chol_tri_inv
        tqp.chol_tri_inv = factor or orig
        try:
            sol = tqp.solve_qp(tqp.QPData(*(torch.as_tensor(a, dtype=dtype) for a in arrays)),
                               x0=torch.zeros(B, L.n, dtype=dtype), **qp_kw)
            return from_qp(sol.x.numpy(), sol.obj.numpy(), sol.rp_rel.numpy(),
                           sol.rd_rel.numpy())
        finally:
            tqp.chol_tri_inv = orig

    ref_li = jax.jit(jax.vmap(lambda H: tri_inv_lower(chol_lower(H))))

    def reference_factor(H):
        return torch.as_tensor(np.asarray(ref_li(jnp.asarray(H.numpy()))))

    if "reductions" in sys.argv[1:]:
        return reductions(arrays, qp_kw, from_qp, reference_factor, limits, fx, stored)

    print(f"{CASE}: the ADMM gates' limits (the reference's worst reading over its "
          f"{len(cs.reference_runs(fx))} stored runs): "
          + ", ".join(f"{k} {v:.4e}" for k, v in limits.items()), flush=True)
    moved_only = cs.gate_limits({k: v for k, v in fx.items() if not k.endswith("_alone")},
                                cs.ADMM_GATE_FLOORS)
    print("  without the lane-alone runs: "
          + ", ".join(f"{k} {v:.4e}" for k, v in moved_only.items()), flush=True)
    print("  stored runs' solved flags differing from the stored batch run: moved "
          f"{[int((s != fx['solved']).sum()) for s in fx['solved_pert']]}, alone "
          f"{[int((s != fx['solved']).sum()) for s in fx['solved_alone']]}", flush=True)
    with jax.enable_x64(True):
        exact_ref = reference(dtype=jnp.float64)
    exact_port = port(torch.float64, tl.chol_tri_inv_plain)
    runs = {"reference, one batch of 256": reference(),
            "reference, batches of 16": reference_in_batches(16),
            "reference, batches of 1": reference_in_batches(1),
            "reference, KKT sums reversed": reference(reversed_sums()),
            "port": port(),
            "port with the reference's L^-1": port(factor=reference_factor)}
    for name, run in runs.items():
        got = {**cs.spread(run, stored, fx["scale_u"]), **cs.error(run, fx)}
        over = [k for k, v in limits.items() if got[k] > v]
        far = np.abs(run["U"] - exact_ref["U"]).max((-1, -2)) / su.max()
        print(f"{name}: solved {int(run['solved'].sum())}; "
              + ", ".join(f"{k} {got[k]:.4e}" for k in limits)
              + f"; over the limits: {over or 'none'}; |U - U(f64)| / max scale_u, "
              f"median over lanes {np.median(far):.3e}", flush=True)
    differ = int((exact_port["solved"] != exact_ref["solved"]).sum())
    d = np.abs(exact_port["U"] - exact_ref["U"]).max((-1, -2)) / su.max()
    print(f"float64, port against reference: solved {int(exact_port['solved'].sum())} and "
          f"{int(exact_ref['solved'].sum())}, {differ} lanes differ; |dU| / max scale_u "
          f"median over lanes {np.median(d):.3e}, 90th percentile "
          f"{np.percentile(d, 90):.3e}, max {d.max():.3e}", flush=True)
    return 0


def reductions(arrays, qp_kw, from_qp, reference_factor, limits, fx, stored) -> int:
    """The port's ADMM with the reference's ``L^-1`` and each reduction of
    ``REDUCTIONS`` (then all of them; then the triangular products alone
    with the port's own ``L^-1``) computed by the reference's XLA code:
    a ``jax.jit(jax.vmap(...))`` of the reference's own expression
    (racing_lmpc_tpu/mpc/qp.py:168-199) on the port's f32 operands, whose
    result replaces the port's.  Prints, for each, the flags that differ
    from the stored run and the gates over their limits."""
    import jax
    import jax.numpy as jnp
    import torch

    import chip_smoke as cs
    import racing_lmpc_torch.mpc.qp as tqp

    def jfn(f):
        g = jax.jit(jax.vmap(f))

        def call(*a):
            out = g(*(b if isinstance(b, jax.Array) else jnp.asarray(b.numpy()) for b in a))
            if isinstance(out, tuple):
                return tuple(torch.as_tensor(np.asarray(o)) for o in out)
            return torch.as_tensor(np.asarray(out))
        return call

    sigma, alpha = qp_kw["sigma"], qp_kw["alpha"]
    n = arrays[0].shape[-1]
    j_kkt = jfn(lambda P, A, rho: P + sigma * jnp.eye(n, dtype=P.dtype) + (A.T * rho) @ A)
    j_rhs = jfn(lambda A, q, x, z, y, rho: sigma * x - q + A.T @ (rho * z - y))
    j_xt = jfn(lambda Li, rhs: Li.T @ (Li @ rhs))
    j_zt = jfn(lambda A, x: A @ x)
    j_res = jfn(lambda P, A, x, y: (A @ x, P @ x, A.T @ y))

    def hooked(swap, factor):
        def admm_solve(data, iters=200, rho=0.1, sigma=1e-6, alpha=1.6, x0=None, y0=None,
                       rho_updates=4):
            P, q, A, l, u = data
            jP, jA, jq = (jnp.asarray(a.numpy()) for a in (P, A, q))
            mv, amax = tqp.mv, tqp.amax
            eq_row = torch.isfinite(l) & torch.isfinite(u) & (
                torch.abs(u - l) < 1e-9 * torch.clamp(torch.abs(u) + torch.abs(l), min=1.0))
            I_n = torch.eye(n, dtype=P.dtype)
            AT = A.transpose(-1, -2)
            x = q.new_zeros(q.shape) if x0 is None else x0
            z = torch.clamp(mv(A, x), l, u)
            y = l.new_zeros(l.shape) if y0 is None else y0
            rho_s = torch.full(q.shape[:-1], rho, dtype=P.dtype)
            n_chunks = rho_updates + 1
            for _ in range(n_chunks):
                rho_vec = torch.where(eq_row, (rho_s * tqp._EQ_RHO_SCALE)[..., None],
                                      rho_s[..., None])
                H = (j_kkt(jP, jA, rho_vec) if "kkt" in swap
                     else P + sigma * I_n + (AT * rho_vec[..., None, :]) @ A)
                Li = factor(H)
                jLi = jnp.asarray(Li.numpy())
                LiT = Li.transpose(-1, -2)
                for _ in range(max(1, iters // n_chunks)):
                    rhs = (j_rhs(jA, jq, x, z, y, rho_vec) if "rhs" in swap
                           else sigma * x - q + tqp._tmv(A, rho_vec * z - y))
                    x_t = j_xt(jLi, rhs) if "x_t" in swap else mv(LiT, mv(Li, rhs))
                    z_t = j_zt(jA, x_t) if "z_t" in swap else mv(A, x_t)
                    x_n = alpha * x_t + (1.0 - alpha) * x
                    z_a = alpha * z_t + (1.0 - alpha) * z
                    z_n = torch.clamp(z_a + y / rho_vec, l, u)
                    y = y + rho_vec * (z_a - z_n)
                    x, z = x_n, z_n
                Ax, Px, Aty = (j_res(jP, jA, x, y) if "residuals" in swap
                               else (mv(A, x), mv(P, x), tqp._tmv(A, y)))
                r_prim = amax(torch.abs(Ax - z))
                denom_p = torch.maximum(amax(torch.abs(Ax)), amax(torch.abs(z))) + 1e-8
                r_dual = amax(torch.abs(Px + q + Aty))
                denom_d = torch.maximum(torch.maximum(amax(torch.abs(Px)), amax(torch.abs(Aty))),
                                        amax(torch.abs(q))) + 1e-8
                ratio = torch.sqrt((r_prim / denom_p) / (r_dual / denom_d + 1e-12))
                rho_s = torch.clamp(rho_s * torch.clamp(ratio, 0.1, 10.0), 1e-6, 1e6)
            return x, z, y
        return admm_solve

    B = arrays[0].shape[0]
    orig_admm, orig_chol = tqp.admm_solve, tqp.chol_tri_inv
    runs = [(swap, reference_factor) for swap in
            [()] + [(r,) for r in REDUCTIONS] + [REDUCTIONS]]
    runs.append((("x_t",), orig_chol))
    try:
        for swap, factor in runs:
            # the polish's factorization too
            tqp.chol_tri_inv = factor
            tqp.admm_solve = hooked(frozenset(swap), factor)
            sol = tqp.solve_qp(tqp.QPData(*(torch.as_tensor(a) for a in arrays)),
                               x0=torch.zeros(B, n), **qp_kw)
            run = from_qp(sol.x.numpy(), sol.obj.numpy(), sol.rp_rel.numpy(), sol.rd_rel.numpy())
            got = {**cs.spread(run, stored, fx["scale_u"]), **cs.error(run, fx)}
            over = [k for k, v in limits.items() if got[k] > v]
            whose = "the reference's" if factor is reference_factor else "its own"
            print(f"port with {whose} L^-1 and the reference's "
                  f"{', '.join(swap) or 'nothing else'}: "
                  f"solved {int(run['solved'].sum())}, solved differs {got['solved differs']}; "
                  + ", ".join(f"{k} {got[k]:.4e}" for k in limits if k != "solved differs")
                  + f"; over the limits: {over or 'none'}", flush=True)
    finally:
        tqp.admm_solve, tqp.chol_tri_inv = orig_admm, orig_chol
    return 0


if __name__ == "__main__":
    sys.exit(main())
