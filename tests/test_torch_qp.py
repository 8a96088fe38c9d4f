"""Port QP build and IPM (racing_lmpc_torch/mpc) against the JAX package
on the QPs of ``make_scenario_batch(..., batch=3, seed=7)`` at
``build_barc_lmpc(n_horizon=10, num_ss=16)`` — the shapes
tests/test_control_match.py compiles.

Tolerances: the scenario inputs are equal (safe-set points compared as sets
where distances tie); the QP data and the Ruiz scaling agree to 1e-5
relative (the same f32 arithmetic; the model's transcendentals round
differently in the last bits).  The IPM is held to the same QP data on both
sides: both must converge (``rp_rel``, ``rd_rel`` < tol), the longitudinal
controls agree to 1e-3 of ``scale_u`` and the objectives to 1e-3 relative.
Steering is held against the certified float64 optimum with the repo's own
gates for these shapes (tests/test_control_match.py:89-96): at N=10 the
steering rides a cost-flat valley that any two f32 solvers resolve
differently (the reference itself lands up to 3.5e-2 of ``scale_u`` from the
optimum on these lanes).
"""

import jax
import numpy as np
import pytest
import torch

from racing_lmpc_tpu.mpc.ipm import solve_qp_ip as j_solve_qp_ip
from racing_lmpc_tpu.mpc.qp import ruiz_equilibrate as j_ruiz
from racing_lmpc_torch.mpc.ipm import solve_qp_ip as t_solve_qp_ip
from racing_lmpc_torch.mpc.qp import QPData as TQPData, ruiz_equilibrate as t_ruiz
from tests._torch_twin import (
    assert_same_safe_set, barc_pair, certified_controls, np_of, rel_err,
    scenario_pair)

N, K, BATCH, SEED = 10, 16, 3, 7


def _jax_qp(mpc, inp):
    with jax.default_matmul_precision("highest"):
        return jax.jit(jax.vmap(mpc._build_qp))(inp)


@pytest.mark.parametrize("name", ["barc_lmpc", "barc_tracking_mpc"])
def test_scenarios_and_qp_build_match_jax(name):
    j, t = barc_pair(N, K, name)
    jinp, tinp = scenario_pair(N, K, BATCH, SEED, name)
    for f in tinp._fields:
        if f in ("ss_x", "ss_j"):
            continue
        assert np.array_equal(np_of(getattr(tinp, f)), np_of(getattr(jinp, f))), f
    assert_same_safe_set(np_of(tinp.ss_x), np_of(tinp.ss_j),
                         np_of(jinp.ss_x), np_of(jinp.ss_j))
    jdata, jaux = _jax_qp(j[3], jinp)
    tdata, taux = t[3]._build_qp(tinp)
    for f, want, got in zip(jdata._fields, jdata, tdata):
        assert rel_err(np_of(got), np_of(want)) < 1e-5, f
    for i, (want, got) in enumerate(zip(jaux, taux)):
        assert rel_err(np_of(got), np_of(want)) < 1e-5, f"aux {i}"
    assert np.array_equal(t[3].eq_rows, np.asarray(j[3].eq_rows))


def test_ruiz_matches_jax():
    j, _ = barc_pair(N, K)
    jinp, _ = scenario_pair(N, K, BATCH, SEED)
    jdata, _ = _jax_qp(j[3], jinp)
    js, (jD, jE, jc) = jax.vmap(j_ruiz)(jdata)
    ts, (tD, tE, tc) = t_ruiz(TQPData(*(torch.as_tensor(np_of(a)) for a in jdata)))
    for want, got in zip(tuple(js) + (jD, jE, jc), tuple(ts) + (tD, tE, tc)):
        assert rel_err(np_of(got), np_of(want)) < 1e-5


def test_solve_qp_ip_matches_jax():
    j, t = barc_pair(N, K)
    mpc = t[3]
    jinp, _ = scenario_pair(N, K, BATCH, SEED)
    jdata, jaux = _jax_qp(j[3], jinp)
    kw = dict(iters=mpc.config.qp_ip_iters, struct=mpc.qp_struct,
              zoom_rounds=mpc.config.qp_zoom_rounds)
    with jax.default_matmul_precision("highest"):
        js = jax.jit(jax.vmap(lambda d: j_solve_qp_ip(
            d, eq_rows=j[3].eq_rows, **kw)))(jdata)
    ts = t_solve_qp_ip(TQPData(*(torch.as_tensor(np_of(a)) for a in jdata)),
                       eq_rows=mpc.eq_rows, **kw)
    tol = mpc.config.tol
    for sol in (js, ts):
        assert (np_of(sol.rp_rel) < tol).all() and (np_of(sol.rd_rel) < tol).all()
        assert np.isfinite(np_of(sol.x)).all() and np.isfinite(np_of(sol.y)).all()
    MU, mu0 = np_of(jaux[2]).astype(np.float64), np_of(jaux[3]).astype(np.float64)
    su, nuu, nu = mpc.scale_u, mpc.layout.nuu, mpc.nu

    def controls(x):
        x = np_of(x).astype(np.float64)[:, :nuu]
        return (np.einsum("bij,bj->bi", MU, x) + mu0).reshape(BATCH, N - 1, nu) * su

    Uj, Ut = controls(js.x), controls(ts.x)
    assert (np.abs(Ut - Uj)[..., 0] / su[0]).max() < 1e-3
    oj, ot = np_of(js.obj).astype(np.float64), np_of(ts.obj).astype(np.float64)
    assert (np.abs(ot - oj) / np.maximum(np.abs(oj), 1.0)).max() < 1e-3
    U_star, obj_star = certified_controls(jdata, MU, mu0, su, N, nu)
    # the dense products (no row structure) solve the same QPs
    dense = t_solve_qp_ip(TQPData(*(torch.as_tensor(np_of(a)) for a in jdata)),
                          eq_rows=mpc.eq_rows, **{**kw, "struct": None})
    for sol in (ts, dense):
        U, o = controls(sol.x), np_of(sol.obj).astype(np.float64)
        err = np.abs(U - U_star) / su
        assert err[..., 0].max() < 1e-3
        assert err[..., 1].max() < 2e-1
        assert (np.abs(o - obj_star) / np.maximum(np.abs(obj_star), 1.0)).max() < 1e-3
    assert (np_of(dense.rp_rel) < tol).all() and (np_of(dense.rd_rel) < tol).all()
