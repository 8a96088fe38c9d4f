"""The port's safe-set error-dynamics regression against the JAX package's:
the raw lap arrays, ``query_regression`` on the recorded BARC laps, the
planted-error recovery of tests/test_safeset.py:177, the condensing with
the corrections dA/dB/dC, the controller's one multi-group query with its
output-row mask (tests/test_lmpc.py:97-114), and the carry of inputs that
hold corrections.

Tolerances: the prediction sweep runs in f32 in both packages (the port's
batched, the reference's under ``vmap``) and the fit in float64 numpy, so
the corrections agree to 1e-5 absolute (measured 2.4e-7; the reference's
own spread between runs moved by one f32 rounding is 4e-4 on dA,
tests/data/torch_port/ctrl_barc_lmpc_regression*.npz); the condensed maps
to 1e-5 relative, as tests/test_torch_qp.py holds the QP build.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import racing_lmpc_tpu.config as jc
from racing_lmpc_tpu.control.loop import MPCController as JController, RegressionSpec as JSpec
from racing_lmpc_tpu.safeset import RegQuery as JQuery, SafeSetManager as JManager
from racing_lmpc_tpu.safeset import SafeSetRecorder as JRecorder
import racing_lmpc_torch.config as tc
from racing_lmpc_torch.benchmarks import BARC_LAPS
from racing_lmpc_torch.carry import mpc_input_from_arrays, regression_spec_from_fields
from racing_lmpc_torch.control import MPCController, RegressionSpec
from racing_lmpc_torch.mpc.racing_mpc import map_input
from racing_lmpc_torch.safeset import RegQuery, SafeSetManager, SafeSetRecorder
from tests._torch_twin import barc_pair, np_of, rel_err, scenario_pair

GROUPS = (((3, 4, 5), (0, 1), 4), ((3, 4, 5), (0, 1), 5))


def loaded_pair():
    """(JAX, port) managers holding the three recorded BARC laps, and the
    track length."""
    _, t = barc_pair(10, 16)
    L = t[1].total_length
    j = JManager(3, nx=6, nu=2, use_native=False)
    JRecorder(j).load(BARC_LAPS, L)
    p = SafeSetManager(3, nx=6, nu=2)
    SafeSetRecorder(p).load(BARC_LAPS, L)
    return j, p


def test_raw_laps_match_jax():
    j, p = loaded_pair()
    assert p.num_laps == j.num_laps == 3 and p._order == j._order
    for name in ("x_raw", "u_raw", "k_raw", "dt_raw", "valid_raw"):
        assert np.array_equal(getattr(p, name), getattr(j, name)), name
    # forward differences: positive step lengths on every stored point
    assert (p.dt_raw[p.valid_raw] > 0).all()


def test_query_regression_matches_jax_on_the_barc_laps():
    j, p = loaded_pair()
    jm, tm = barc_pair(10, 16)[0][0], barc_pair(10, 16)[1][0]
    rng = np.random.default_rng(0)
    for _ in range(3):
        x = np.array([rng.uniform(0, 17), rng.uniform(-0.2, 0.2), 0.0,
                      rng.uniform(1.2, 2.4), rng.uniform(-0.1, 0.1), rng.uniform(-1, 1)])
        u = np.array([rng.uniform(-0.01, 0.01), rng.uniform(-0.3, 0.3)])
        args = dict(x=tuple(np.concatenate([x[list(a)], u[list(b)]]) for a, b, _ in GROUPS),
                    dist_max=3.0, reg_in_state_idxs=[g[0] for g in GROUPS],
                    reg_in_control_idxs=[g[1] for g in GROUPS],
                    reg_out_state_idxs=[(g[2],) for g in GROUPS],
                    A=np.eye(6), B=np.zeros((6, 2)), C=np.zeros(6))
        want = j.query_regression(JQuery(**args, f=jm.discrete_dynamics))
        got = p.query_regression(RegQuery(**args, f=tm.discrete_dynamics), device="cpu")
        for a, b in zip(got, want):
            assert np.abs(a - b).max() < 1e-5
        assert np.abs(got.A[4:] - np.eye(6)[4:]).sum() > 0.0
    # no lap stored: the nominal matrices come back unchanged
    empty = SafeSetManager(3).query_regression(RegQuery(**args, f=tm.discrete_dynamics),
                                               device="cpu")
    assert np.array_equal(empty.A, np.eye(6)) and not empty.C.any()


def test_regression_recovers_planted_error_dynamics():
    """tests/test_safeset.py:177 on the port: a lap from a known linear model
    plus a planted linear error on ONE output row, stored as the recorder
    stores it; the regression recovers the planted (dA, dB, dC) on that row
    and leaves the other rows nominal."""
    rng = np.random.default_rng(0)
    nx, nu, dt = 3, 1, 0.05
    Ap = np.array([[1.0, dt, 0.0], [0.0, 0.95, dt], [0.0, 0.0, 0.9]])
    Bp = np.array([[0.0], [0.0], [dt * 2.0]])
    At, Bt = torch.as_tensor(Ap, dtype=torch.float32), torch.as_tensor(Bp, dtype=torch.float32)

    def f(x, u, k, dtv):
        return x @ At.T + u @ Bt.T

    dA_true, dB_true, dC_true = np.array([0.03, -0.02]), np.array([0.05]), 0.01
    T = 220
    xs, us_applied = np.zeros((T, nx)), np.zeros((T - 1, nu))
    xs[0] = [0.0, 0.4, 0.1]
    for i in range(T - 1):
        us_applied[i] = 0.3 * np.sin(0.11 * i) + 0.05 * rng.standard_normal()
        xn = Ap @ xs[i] + Bp @ us_applied[i]
        xn[1] += dA_true @ xs[i, 1:3] + dB_true @ us_applied[i] + dC_true
        xs[i + 1] = xn
    u_store = np.zeros((T, nu))
    u_store[1:] = us_applied
    mgr = SafeSetManager(max_laps=1, nx=nx, nu=nu, pad_len=256)
    mgr.add_lap(xs, u_store, np.zeros(T), dt * np.arange(T), 100.0)
    out = mgr.query_regression(RegQuery(
        x=np.array([0.0, 0.0, 0.0]), dist_max=10.0, reg_in_state_idxs=[[1, 2]],
        reg_in_control_idxs=[[0]], reg_out_state_idxs=[[1]],
        A=Ap.copy(), B=Bp.copy(), C=np.zeros(nx), f=f), device="cpu")
    np.testing.assert_allclose(out.A[1, 1:3] - Ap[1, 1:3], dA_true, atol=5e-3)
    np.testing.assert_allclose(out.B[1, 0] - Bp[1, 0], dB_true[0], atol=5e-3)
    assert abs(out.C[1] - dC_true) < 5e-3
    np.testing.assert_allclose(out.A[0], Ap[0], atol=1e-12)
    np.testing.assert_allclose(out.A[2], Ap[2], atol=1e-12)


def test_condense_with_corrections_matches_jax():
    """``_condense`` and the QP build with per-lane dA/dB/dC: As + dA,
    Bs + dB and gs + dC over the horizon, as the reference condenses them."""
    j, t = barc_pair(10, 16)
    jinp, tinp = scenario_pair(10, 16, 3, 5)
    rng = np.random.default_rng(1)
    dA = (rng.normal(size=(3, 6, 6)) * 0.02).astype(np.float32)
    dB = (rng.normal(size=(3, 6, 2)) * 0.02).astype(np.float32)
    dC = (rng.normal(size=(3, 6)) * 0.02).astype(np.float32)
    jinp = jinp._replace(dA=jnp.asarray(dA), dB=jnp.asarray(dB), dC=jnp.asarray(dC))
    tinp = tinp._replace(dA=torch.as_tensor(dA), dB=torch.as_tensor(dB), dC=torch.as_tensor(dC))
    with jax.default_matmul_precision("highest"):
        jc_out = jax.jit(jax.vmap(j[3]._condense))(jinp)
        jdata, _ = jax.jit(jax.vmap(j[3]._build_qp))(jinp)
    tc_out = t[3]._condense(tinp)
    for i, (a, b) in enumerate(zip(tc_out, jc_out)):
        assert rel_err(np_of(a), np_of(b)) < 1e-5, i
    tdata, _ = t[3]._build_qp(tinp)
    for name, a, b in zip(tdata._fields, tdata, jdata):
        assert rel_err(np_of(a), np_of(b)) < 1e-5, name
    # the corrections move the condensed chain: without them it differs
    plain = t[3]._condense(tinp._replace(dA=None, dB=None, dC=None))
    assert rel_err(np_of(plain[1]), np_of(tc_out[1])) > 1e-4
    # one lane alone, through the batch-of-one entry point that carries the
    # corrections: solved, with the batch's longitudinal control (the
    # steering rides the cost-flat valley; tests/test_torch_solve.py)
    out, _ = t[3].solve(map_input(lambda a: a[1], tinp))
    both, _ = t[3].solve_batch(tinp)
    assert bool(out.solved) and bool(both.solved[1])
    su = t[3].scale_u
    assert (np.abs(np_of(out.U_optm) - np_of(both.U_optm[1]))[:, 0] / su[0]).max() < 1e-3


def test_controller_query_touches_only_the_output_rows():
    """tests/test_lmpc.py:97-114 on the port: the controller's one
    multi-group query around the current state gives corrections on the
    v_tran and yaw-rate rows only, equal to the JAX controller's."""
    jm, tm = barc_pair(10, 16)[0][0], barc_pair(10, 16)[1][0]
    jcfg = jc.barc_mpc_config("barc_lmpc", n=10, num_ss_pts=16)
    tcfg = tc.barc_mpc_config("barc_lmpc", n=10, num_ss_pts=16)
    jtrack, ttrack = barc_pair(10, 16)[0][1], barc_pair(10, 16)[1][1]
    jspec = JSpec(3.0, GROUPS)
    jctrl = JController(jcfg, jm, jtrack, 0.025, regression=jspec)
    spec = regression_spec_from_fields(*jspec)
    assert spec == RegressionSpec(3.0, GROUPS)
    tctrl = MPCController(tcfg, tm, ttrack, 0.025, regression=spec, device="cpu")
    x, u = np.array([0.1, 0.04, 0.0, 1.9, 0.0, 0.0]), np.zeros(2, np.float32)
    assert tctrl._query_regression(x, u) is None          # no lap stored yet
    jctrl.ss_recorder.load(BARC_LAPS, jtrack.total_length)
    tctrl.ss_recorder.load(BARC_LAPS, ttrack.total_length)
    want = jctrl._query_regression(x, u)
    got = tctrl._query_regression(x, u)
    dA = np_of(got[0])
    assert np.abs(dA[[0, 1, 2, 3]]).max() == 0.0 and np.abs(dA[[4, 5]]).sum() > 0.0
    for a, b in zip(got, want):
        assert np.abs(np_of(a) - np_of(b)).max() < 1e-5
    tctrl.regression = None
    assert tctrl._query_regression(x, u) is None


def test_carry_loads_inputs_with_corrections():
    _, tinp = scenario_pair(10, 16, 2, 5)
    arrays = {k: np_of(v) for k, v in tinp._asdict().items() if v is not None}
    plain = mpc_input_from_arrays(arrays, device="cpu")
    assert plain.dA is None
    arrays.update(dA=np.ones((2, 6, 6)), dB=np.ones((2, 6, 2)), dC=np.ones((2, 6)))
    inp = mpc_input_from_arrays(arrays, device="cpu")
    assert inp.dA.dtype == torch.float32 and inp.dC.shape == (2, 6)
    assert torch.equal(inp.x_ic, plain.x_ic)
