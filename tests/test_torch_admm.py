"""The port's ADMM QP backend (racing_lmpc_torch/mpc/qp.py: admm_solve,
polish, solve_qp) against closed forms, SciPy and the JAX package's, as
tests/test_qp.py holds the JAX package's.

The port batches over a leading dimension; each case here is a batch of
one unless it says otherwise.  Tolerances are tests/test_qp.py's (the same
f32 ADMM); the twins with the JAX package hold x and y within 1e-4 of the
larger of 1 and the largest entry on well-conditioned QPs, where both
converge, and the MPC QPs' ``solved`` lane by lane with their objectives,
and in float64 their iterates too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import LinearConstraint, minimize

from racing_lmpc_tpu.mpc import qp as jq
from racing_lmpc_torch.mpc import qp as tq
from tests._torch_twin import barc_pair, np_of, rel_err, scenario_pair


def _qp(*arrays):
    """A batch-of-one port QP from unbatched numpy arrays."""
    return tq.QPData(*(torch.as_tensor(np.asarray(a, np.float32))[None] for a in arrays))


def scipy_solve(P, q, A, l, u):
    res = minimize(lambda x: 0.5 * x @ P @ x + q @ x, np.zeros(P.shape[0]),
                   jac=lambda x: P @ x + q, constraints=[LinearConstraint(A, l, u)],
                   method="SLSQP", options={"maxiter": 500, "ftol": 1e-12})
    assert res.success, res.message
    return res.x


def random_qp(rng, n, m):
    M = rng.normal(size=(n, n))
    return (M @ M.T + np.eye(n), rng.normal(size=n) * 2, rng.normal(size=(m, n)),
            -rng.uniform(0.1, 1.0, m), rng.uniform(0.1, 1.0, m))


def test_unconstrained():
    rng = np.random.default_rng(0)
    n = 8
    M = rng.normal(size=(n, n))
    P, q = M @ M.T + np.eye(n), rng.normal(size=n)
    sol = tq.solve_qp(_qp(P, q, np.zeros((1, n)), [-np.inf], [np.inf]))
    assert np.abs(np_of(sol.x)[0] - np.linalg.solve(P, -q)).max() < 1e-4


def test_box_projection():
    v = np.array([2.0, -3.0, 0.5, 0.0, -0.7])
    sol = tq.solve_qp(_qp(np.eye(5), -v, np.eye(5), -np.ones(5), np.ones(5)))
    assert np.abs(np_of(sol.x)[0] - np.clip(v, -1, 1)).max() < 1e-5


def test_equality_constrained_closed_form():
    rng = np.random.default_rng(1)
    n, m = 10, 4
    M = rng.normal(size=(n, n))
    P, q = M @ M.T + 0.5 * np.eye(n), rng.normal(size=n)
    A, b = rng.normal(size=(m, n)), rng.normal(size=m)
    K = np.block([[P, A.T], [A, np.zeros((m, m))]])
    want = np.linalg.solve(K, np.concatenate([-q, b]))
    sol = tq.solve_qp(_qp(P, q, A, b, b))
    assert np.abs(np_of(sol.x)[0] - want[:n]).max() < 1e-4
    # the duals too (P x + q + A' y = 0)
    assert np.abs(np_of(sol.y)[0] - want[n:]).max() < 1e-3


@pytest.mark.parametrize("seed", [2, 3, 4])
def test_random_inequality_qp_vs_scipy(seed):
    P, q, A, l, u = random_qp(np.random.default_rng(seed), 12, 18)
    sol = tq.solve_qp(_qp(P, q, A, l, u), iters=400)
    assert np.abs(np_of(sol.x)[0] - scipy_solve(P, q, A, l, u)).max() < 5e-4
    assert float(sol.r_prim[0]) < 1e-4


def test_mixed_equality_inequality_vs_scipy():
    rng = np.random.default_rng(5)
    n = 15
    M = rng.normal(size=(n, n))
    P, q = M @ M.T + np.eye(n), rng.normal(size=n)
    A = np.vstack([rng.normal(size=(3, n)), rng.normal(size=(10, n))])
    b_eq = rng.normal(size=3) * 0.1
    l = np.concatenate([b_eq, -np.full(10, np.inf)])
    u = np.concatenate([b_eq, rng.uniform(0.5, 1.5, 10)])
    sol = tq.solve_qp(_qp(P, q, A, l, u), iters=400)
    assert np.abs(np_of(sol.x)[0] - scipy_solve(P, q, A, l, u)).max() < 1e-3


def test_batched_matches_single_and_jax():
    """Lanes of a batch each keep their own rho, equality-row test and
    polish acceptance: each equals its own solve, and the batch equals the
    JAX package's ``vmap`` of ``solve_qp``."""
    rng = np.random.default_rng(6)
    lanes = [random_qp(rng, 8, 12) for _ in range(5)]
    # one lane with an equality row and one with unbounded rows
    lanes[1][3][0] = lanes[1][4][0] = 0.3
    lanes[3][3][:4] = -np.inf
    arrays = [np.stack([lane[i] for lane in lanes]).astype(np.float32) for i in range(5)]
    batch = tq.solve_qp(tq.QPData(*map(torch.as_tensor, arrays)), iters=300)
    for b, lane in enumerate(lanes):
        single = tq.solve_qp(_qp(*lane), iters=300)
        assert np.abs(np_of(batch.x)[b] - np_of(single.x)[0]).max() < 2e-4
    with jax.default_matmul_precision("highest"):
        js = jax.jit(jax.vmap(lambda d: jq.solve_qp(d, iters=300)))(
            jq.QPData(*map(jnp.asarray, arrays)))
    assert rel_err(np_of(batch.x), np_of(js.x)) < 1e-4
    assert rel_err(np_of(batch.y), np_of(js.y)) < 1e-4
    assert rel_err(np_of(batch.obj), np_of(js.obj)) < 1e-4


def test_warm_start_converges_faster():
    P, q, A, l, u = random_qp(np.random.default_rng(7), 10, 14)
    data = _qp(P, q, A, l, u)
    cold = tq.solve_qp(data, iters=400)
    warm = tq.solve_qp(data, iters=30, x0=cold.x, y0=cold.y)
    assert np.abs(np_of(warm.x) - np_of(cold.x)).max() < 1e-3


def test_polish_keeps_the_admm_iterate_where_its_matrix_is_not_pd():
    """The polish on a batch whose lane 2 has an indefinite cost and no
    active row, so that its polish matrix P + delta I is not positive
    definite: that lane's factor is NaN, its residual compares False and it
    keeps its ADMM iterate, while every other lane comes out of the polish
    as the JAX package's does."""
    rng = np.random.default_rng(8)
    lanes = [random_qp(rng, 6, 9) for _ in range(4)]
    arrays = [np.stack([lane[i] for lane in lanes]).astype(np.float32) for i in range(5)]
    data = tq.QPData(*map(torch.as_tensor, arrays))
    sdata, _ = tq.ruiz_equilibrate(data)
    x, _, y = tq.admm_solve(sdata, iters=100)
    P = sdata.P.clone()
    P[2] = P[2] - 10.0 * torch.eye(6)
    y = y.clone()
    y[2] = 0.0
    sdata = sdata._replace(P=P)
    xp, yp = tq.polish(sdata, x, y)
    jx, jy = jax.jit(jax.vmap(jq.polish))(jq.QPData(*(jnp.asarray(np_of(a)) for a in sdata)),
                                          jnp.asarray(np_of(x)), jnp.asarray(np_of(y)))
    assert torch.equal(xp[2], x[2]) and torch.equal(yp[2], y[2])
    assert np.array_equal(np_of(jx)[2], np_of(x)[2])
    assert rel_err(np_of(xp), np_of(jx)) < 1e-4
    assert rel_err(np_of(yp), np_of(jy)) < 1e-4


def test_mpc_qps_match_jax_lane_by_lane():
    """A small batch of the BARC LMPC's condensed QPs (N=10, K=16) through
    both packages' ``solve_qp``: the same ``solved`` on every lane, the
    scaled residuals within the tolerance of each other and the objective
    within 1e-3 relative on the lanes both solved.  The iterates themselves
    are not compared: 400 ADMM iterations stop near the 1e-3 tolerance,
    where x still moves along the condensed QP's cost-flat steering valley
    (measured: up to 6% of its largest entry between the two packages at
    objectives 5e-4 apart)."""
    j, t = barc_pair(10, 16)
    jinp, tinp = scenario_pair(10, 16, 6, 3)
    with jax.default_matmul_precision("highest"):
        jdata, _ = jax.jit(jax.vmap(j[3]._build_qp))(jinp)
        js = jax.jit(jax.vmap(lambda d: jq.solve_qp(d, iters=400, x0=jnp.zeros_like(d.q))))(jdata)
    tdata = tq.QPData(*(torch.as_tensor(np.array(a)) for a in jdata))
    ts = tq.solve_qp(tdata, iters=400)
    tol = t[2].tol
    j_ok = (np_of(js.rp_rel) < tol) & (np_of(js.rd_rel) < tol)
    t_ok = (np_of(ts.rp_rel) < tol) & (np_of(ts.rd_rel) < tol)
    assert np.array_equal(t_ok, j_ok) and t_ok.any()
    both = t_ok & j_ok
    o_t, o_j = np_of(ts.obj)[both].astype(np.float64), np_of(js.obj)[both].astype(np.float64)
    assert (np.abs(o_t - o_j) / np.maximum(np.abs(o_j), 1.0)).max() < 1e-3
    for name in ("rp_rel", "rd_rel"):
        assert np.abs(np_of(getattr(ts, name)) - np_of(getattr(js, name))).max() < tol, name


def test_mpc_qps_match_jax_in_float64(monkeypatch):
    """The same MPC QPs through both packages' ``solve_qp`` in float64,
    where rounding no longer steers the ADMM iterate: the port runs the
    reference's algorithm, so ``solved`` agrees lane by lane and x within
    1e-6 of its largest entry (in f32 the iterate of either package moves
    by ~1e-2 when only the order of its sums changes;
    tests/torch_port_admm_rounding.py).  The kernel's wrapper takes f32
    only, so the factorization is its plain version here."""
    from racing_lmpc_torch.ops import linalg as tl
    monkeypatch.setattr(tq, "chol_tri_inv", tl.chol_tri_inv_plain)
    j, t = barc_pair(10, 16)
    jinp, _ = scenario_pair(10, 16, 6, 3)
    with jax.default_matmul_precision("highest"):
        arrays = [np.asarray(a, np.float64) for a in jax.jit(jax.vmap(j[3]._build_qp))(jinp)[0]]
    with jax.enable_x64(True):
        js = jax.jit(jax.vmap(lambda d: jq.solve_qp(d, iters=400, x0=jnp.zeros_like(d.q))))(
            jq.QPData(*map(jnp.asarray, arrays)))
        jx, jrp, jrd = (np.asarray(a) for a in (js.x, js.rp_rel, js.rd_rel))
    ts = tq.solve_qp(tq.QPData(*map(torch.as_tensor, arrays)), iters=400)
    assert ts.x.dtype == torch.float64 and jx.dtype == np.float64
    tol = t[2].tol
    j_ok = (jrp < tol) & (jrd < tol)
    t_ok = (np_of(ts.rp_rel) < tol) & (np_of(ts.rd_rel) < tol)
    assert np.array_equal(t_ok, j_ok) and t_ok.any()
    assert rel_err(np_of(ts.x), jx) < 1e-6
