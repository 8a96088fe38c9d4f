"""The port's c2d, finite-horizon LQR and EKF against the JAX package's, with
the checks of tests/test_lqr_ekf.py on the port.

Tolerances: ``c2d`` 1e-5 relative (torch's ``matrix_exp`` and the
reference's Pade-13 ``expm`` are different approximants; measured ~1e-7);
the LQR's controls and rollout 1e-4 relative to max(1, |value|) (the same
f32 Riccati recursion and RK4, measured 4e-7); the EKF's state 1e-5 and
covariance 1e-4 of its largest entry after a seeded sequence of mixed
updates (measured 3e-9 and 3e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import racing_lmpc_tpu.config as jc
from racing_lmpc_tpu.estimation import EKFStateEstimator as JEKF
from racing_lmpc_tpu.models import SingleTrackPlanarModel as JModel
from racing_lmpc_tpu.mpc.racing_lqr import RacingLQR as JLQR
from racing_lmpc_tpu.ops.integrators import c2d as jc2d
import racing_lmpc_torch.config as tc
from racing_lmpc_torch.estimation import (
    EKFStateEstimator, EKFUninitializedException, NoObservationRegisteredException,
    ObservationNameAlreadyExistsException, ObservationNameNotFoundException)
from racing_lmpc_torch.models import SingleTrackPlanarModel
from racing_lmpc_torch.mpc.racing_lqr import RacingLQR
from racing_lmpc_torch.ops.integrators import c2d, rk4
from tests._torch_twin import np_of, rel_err


def sample_model(c, M, base="sample_vehicle", sample_throttle=60.0):
    """The sample vehicle in the global frame with its three controls
    (tests/test_lqr_ekf.py:28-38), from package ``c``'s config."""
    p = c.load_ros_params(c.PARAM_DIR / f"{base}_base.param.yaml",
                          c.PARAM_DIR / f"{base}_single_track.param.yaml")
    cfg = c.vehicle_config_from_params(p)
    st = sample_throttle if sample_throttle else cfg.modeling.sample_throttle
    cfg = dataclasses.replace(cfg, modeling=dataclasses.replace(
        cfg.modeling, use_frenet=False, integrator_type="rk4", sample_throttle=st))
    return M(cfg, c.single_track_config_from_params(p, simplify_lon_control=False))


@pytest.fixture(scope="module")
def models():
    return sample_model(jc, JModel), sample_model(tc, SingleTrackPlanarModel)


def reference(model, N, dt, v0=30.0, steer=0.01):
    """A dynamically consistent reference rolled through the port's model."""
    x = torch.tensor([0.0, 0.0, 0.0, v0, 0.0, 0.0])
    u = torch.tensor([500.0, 0.0, steer])
    X = [x]
    for _ in range(N - 1):
        x = rk4(model.dynamics, x, u, torch.zeros(()), torch.tensor(dt))
        X.append(x)
    return torch.stack(X).numpy(), np.tile(u.numpy(), (N - 1, 1))


def test_c2d_matches_jax():
    rng = np.random.default_rng(0)
    Ac = (rng.normal(size=(5, 6, 6)) * 3).astype(np.float32)
    Bc = rng.normal(size=(5, 6, 3)).astype(np.float32)
    for dt in (0.01, 0.1):
        Aj, Bj = jax.vmap(lambda a, b: jc2d(a, b, jnp.float32(dt)))(
            jnp.asarray(Ac), jnp.asarray(Bc))
        At, Bt = c2d(torch.as_tensor(Ac), torch.as_tensor(Bc), dt)
        assert rel_err(np_of(At), np_of(Aj)) < 1e-5
        assert rel_err(np_of(Bt), np_of(Bj)) < 1e-5
    # exact on a nilpotent double integrator: A_d = I + A dt, B_d = [dt^2/2, dt]
    A, B = c2d(torch.tensor([[0.0, 1.0], [0.0, 0.0]]), torch.tensor([[0.0], [1.0]]), 0.1)
    assert torch.allclose(A, torch.tensor([[1.0, 0.1], [0.0, 1.0]]), atol=1e-7)
    assert torch.allclose(B, torch.tensor([[0.005], [0.1]]), atol=1e-7)


def lqr_pair(models, name="sample_lqr"):
    jm, tm = models
    jcfg = jc.lqr_config_from_params(jc.load_ros_params(jc.PARAM_DIR / f"{name}.param.yaml"))
    tcfg = tc.lqr_config_from_params(tc.load_ros_params(tc.PARAM_DIR / f"{name}.param.yaml"))
    return JLQR(jcfg, jm), RacingLQR(tcfg, tm, device="cpu"), tcfg


def test_lqr_single_and_batched_match_jax(models):
    jl, tl_, cfg = lqr_pair(models)
    X_ref, U_ref = reference(models[1], cfg.n, cfg.dt)
    B = 4
    x_ics = (np.tile(X_ref[0], (B, 1)) + np.linspace(0, 1, B)[:, None]).astype(np.float32)
    args = (x_ics, np.tile(X_ref, (B, 1, 1)), np.tile(U_ref, (B, 1, 1)))
    jsol = jl.solve_batch(*map(jnp.asarray, args))
    tsol = tl_.solve_batch(*args)
    assert tsol.X_optm.shape == (B, cfg.n, 6) and tsol.K_gains.shape == (B, cfg.n - 1, 3, 6)
    for name in ("u", "U_optm", "X_optm", "K_gains"):
        assert rel_err(np_of(getattr(tsol, name)), np_of(getattr(jsol, name))) < 1e-4, name
    single = tl_.solve(x_ics[2], X_ref, U_ref)
    assert np.allclose(np_of(single.u), np_of(tsol.u[2]), atol=1e-4)


def test_lqr_regulates_to_reference(models):
    """tests/test_lqr_ekf.py:59-81 on the port."""
    _, tl_, cfg = lqr_pair(models)
    X_ref, U_ref = reference(models[1], cfg.n, cfg.dt)
    x_ic = X_ref[0] + np.array([1.0, 0.3, 0.01, 0.0, 0.0, 0.0], np.float32)
    sol = tl_.solve(x_ic, X_ref, U_ref)
    dev_yaw = np.abs(np_of(sol.X_optm[:, 2]) - X_ref[:, 2])
    assert dev_yaw[-1] < dev_yaw[0] / 3
    assert float(sol.U_optm[0, 2]) < -0.01
    x1 = rk4(models[1].dynamics, sol.X_optm[0], sol.U_optm[0], torch.zeros(()),
             torch.tensor(cfg.dt))
    assert torch.allclose(x1, sol.X_optm[1], atol=1e-5)
    assert float(sol.K_gains.abs().max()) > 0.01
    # from the reference's start the controls are the reference's
    on = tl_.solve(X_ref[0], X_ref, U_ref)
    assert np.abs(np_of(on.U_optm) - U_ref).max() < 2.0
    assert np.abs(np_of(on.X_optm) - X_ref).max() < 0.05


def test_lqr_mgkt_turn_golden_fixture():
    """The reference's only LQR fixture (tests/test_lqr_ekf.py:89-165): the
    go-kart tracking the mgkt turn-4 trajectory from a perturbed start; the
    port's lateral error contracts, never amplifies, and its rollout is an
    exact RK4 trajectory; both packages' closed-loop rollouts agree."""
    jm = sample_model(jc, JModel, "sample_vehicle_2", None)
    tm = sample_model(tc, SingleTrackPlanarModel, "sample_vehicle_2", None)
    jl, tl_, cfg = lqr_pair((jm, tm), "sample_lqr_2")
    assert cfg.n == 51 and abs(cfg.dt - 0.02) < 1e-12
    lqr_dir = tc.DATA_DIR / "lqr"
    X_optm = np.loadtxt(lqr_dir / "x_optm.txt")
    U_optm = np.loadtxt(lqr_dir / "u_optm.txt")[:, :3]
    T_optm = np.loadtxt(lqr_dir / "t_optm.txt")
    t_knots = np.concatenate([[0.0], np.cumsum(T_optm)])
    vyaw, slip, v = X_optm[:, 3], X_optm[:, 4], X_optm[:, 5]
    X_optm = np.stack([X_optm[:, 0], X_optm[:, 1], X_optm[:, 2],
                       v * np.cos(slip), v * np.sin(slip), vyaw], axis=1)
    t_intp = np.linspace(0.0, 1.0, cfg.n)
    X_ref = np.stack([np.interp(t_intp, t_knots, X_optm[:, j]) for j in range(6)], axis=1)
    U_ref = np.stack([np.interp(t_intp[:-1], t_knots[:-1], U_optm[:, j]) for j in range(3)],
                     axis=1)
    X_ref, U_ref = X_ref.astype(np.float32), U_ref.astype(np.float32)
    pert = np.asarray([1.0, 0.3, 0.01, 0.0, 0.0, 0.0], np.float32)
    X0 = np_of(tl_.solve(X_ref[0], X_ref, U_ref).X_optm).astype(np.float64)
    sol = tl_.solve(X_ref[0] + pert, X_ref, U_ref)
    X = np_of(sol.X_optm).astype(np.float64)
    assert np.isfinite(X).all() and np.isfinite(np_of(sol.U_optm)).all()
    diff = X - X0
    lat = -np.sin(X0[:, 2]) * diff[:, 0] + np.cos(X0[:, 2]) * diff[:, 1]
    assert abs(lat[-1]) < 0.5 * abs(lat[0])
    pos_dev = np.linalg.norm(diff[:, :2], axis=1)
    assert pos_dev.max() < 1.2 * pos_dev[0]
    x1 = rk4(tm.dynamics, sol.X_optm[0], sol.U_optm[0], torch.zeros(()), torch.tensor(cfg.dt))
    assert np.allclose(np_of(x1), X[1], atol=1e-4)
    assert 5.0 < X[:, 3].min() and X[:, 3].max() < 30.0
    jsol = jl.solve(X_ref[0] + pert, X_ref, U_ref)
    assert rel_err(X, np_of(jsol.X_optm)) < 1e-4
    assert rel_err(np_of(sol.U_optm), np_of(jsol.U_optm)) < 1e-4


# ---------------------------------------------------------------------------
# EKF
# ---------------------------------------------------------------------------

def ekf_pair(models, **kw):
    jcfg = jc.ekf_config_from_params(jc.load_ros_params(jc.PARAM_DIR / "sample_ekf.param.yaml"))
    tcfg = tc.ekf_config_from_params(tc.load_ros_params(tc.PARAM_DIR / "sample_ekf.param.yaml"))
    return JEKF(jcfg, models[0]), EKFStateEstimator(tcfg, models[1], device="cpu", **kw)


def h_pose(x, z):
    return x[:3]


def h_speed(x, z):
    return x[3:4]


def test_ekf_registry_and_exceptions(models):
    _, ekf = ekf_pair(models)
    with pytest.raises(NoObservationRegisteredException):
        ekf.initialize(0)
    ekf.register_observation("pose", 3, h_pose)
    with pytest.raises(ObservationNameAlreadyExistsException):
        ekf.register_observation("pose", 3, h_pose)
    with pytest.raises(EKFUninitializedException):
        ekf.update_observation("pose", 1, np.zeros(3), np.eye(3))
    ekf.initialize(0)
    with pytest.raises(ObservationNameNotFoundException):
        ekf.update_observation("imu", 1, np.zeros(3), np.eye(3))
    from racing_lmpc_torch.estimation import EKFAlreadyInitializedException
    with pytest.raises(EKFAlreadyInitializedException):
        ekf.register_observation("speed", 1, h_speed)


def test_ekf_matches_jax_over_a_seeded_sequence(models):
    """The same mixed sequence through both filters (pose every step, a
    sparse speed, a pure prediction, a NaN observation): x, P and the gain
    block after every update, and the convergence of
    tests/test_lqr_ekf.py:194-218."""
    je, te = ekf_pair(models)
    for e in (je, te):
        e.register_observation("pose", 3, h_pose)
        e.register_observation("speed", 1, h_speed)
        e.initialize(0)
    rng = np.random.default_rng(0)
    x_true = torch.tensor([0.0, 0.5, 0.1, 1.5, 0.0, 0.0])
    u = np.array([200.0, 0.0, 0.02], np.float32)
    je.update_control(u)
    te.update_control(u)
    dt, t_ns = 0.01, 0
    for i in range(100):
        x_true = rk4(models[1].dynamics, x_true, torch.as_tensor(u), torch.zeros(()),
                     torch.tensor(dt))
        t_ns += int(dt * 1e9)
        steps = [("pose", t_ns, np_of(x_true[:3]) + rng.normal(0, 0.01, 3), np.eye(3) * 1e-4)]
        if i % 5 == 0:
            t_ns += 1
            steps.append(("speed", t_ns, np_of(x_true[3:4]) + rng.normal(0, 0.05, 1),
                          np.eye(1) * 2.5e-3))
        if i == 40:
            t_ns += 1
            steps.append((None, t_ns, None, None))
        if i == 60:
            t_ns += 1
            steps.append(("pose", t_ns, np.array([np.nan, 0.0, 0.0]), np.eye(3)))
        for name, t, z, R in steps:
            a = je.update_observation(name, t, z, R)
            b = te.update_observation(name, t, z, R)
            assert a["sanitized"] == b["sanitized"]
            assert rel_err(np_of(b["x"]), np_of(a["x"])) < 1e-5
            P_scale = np.abs(np_of(a["P"])).max()
            assert np.abs(np_of(b["P"]) - np_of(a["P"])).max() < 1e-4 * P_scale
            assert rel_err(np_of(b["K"]), np_of(a["K"])) < 1e-4
    err = np.abs(np_of(te.x) - np_of(x_true))
    assert err[:3].max() < 0.05 and err[3] < 0.3
    assert float(torch.diagonal(te.P)[:3].max()) < 1.0


def test_ekf_rejects_nan_observation(models):
    _, ekf = ekf_pair(models)
    ekf.register_observation("pose", 3, h_pose)
    ekf.initialize(0)
    out = ekf.update_observation("pose", 10**7, np.array([np.nan, 0, 0]), np.eye(3))
    assert out["sanitized"]
    assert torch.isfinite(out["x"]).all() and torch.isfinite(out["P"]).all()
    assert not out["Kz"].any()


def test_ekf_timestamp_jump_resets_clock(models):
    _, ekf = ekf_pair(models)
    ekf.register_observation("pose", 3, h_pose)
    ekf.initialize(10**9)
    ekf.update_observation("pose", 2 * 10**9, np.zeros(3), np.eye(3) * 1e-4)
    out = ekf.update_observation("pose", 5 * 10**8, np.zeros(3), np.eye(3) * 1e-4)
    assert torch.isfinite(out["x"]).all()
    assert ekf.nanosec == 5 * 10**8


def test_ekf_state_clipping_and_warning(models):
    from racing_lmpc_torch.control import Logger, LogLevel
    logger, seen = Logger(), []
    logger.register_callback(lambda level, msg: seen.append((level, msg)))
    _, ekf = ekf_pair(models, logger=logger)
    ekf.register_observation("speed", 1, h_speed)
    ekf.initialize(0)
    # a huge speed observation is clipped to x_max (sample_ekf: vx max 2.0)
    out = ekf.update_observation("speed", 10**6, np.array([100.0]), np.eye(1) * 1e-8)
    assert float(out["x"][3]) <= 2.0 + 1e-6
    assert not seen
    ekf.update_observation("speed", 2 * 10**6, np.array([np.inf]), np.eye(1))
    assert seen and seen[-1][0] == LogLevel.WARN and "sanitation" in seen[-1][1]


def test_ekf_state_carries_over(models):
    """A JAX filter's config and state (x, P, clock, control) carried into
    the port's (``carry.estimator_from_state``) halfway through the seeded
    sequence of ``test_ekf_matches_jax_over_a_seeded_sequence``: both
    continue alike."""
    from racing_lmpc_torch.carry import estimator_from_state
    je, _ = ekf_pair(models)
    je.register_observation("pose", 3, h_pose)
    je.initialize(0)
    u = np.array([200.0, 0.0, 0.02], np.float32)
    je.update_control(u)
    rng = np.random.default_rng(2)
    x_true = torch.tensor([0.0, 0.5, 0.1, 1.5, 0.0, 0.0])
    te, t_ns = None, 0
    for i in range(20):
        if i == 10:
            te = estimator_from_state(dataclasses.asdict(je.config), models[1],
                                      [("pose", 3, h_pose)], np_of(je.x), np_of(je.P),
                                      je.nanosec, u=np_of(je.u), device="cpu")
        x_true = rk4(models[1].dynamics, x_true, torch.as_tensor(u), torch.zeros(()),
                     torch.tensor(0.01))
        t_ns += 10_000_000
        z = np_of(x_true[:3]) + rng.normal(0, 0.01, 3)
        a = je.update_observation("pose", t_ns, z, np.eye(3) * 1e-4)
        if te is not None:
            b = te.update_observation("pose", t_ns, z, np.eye(3) * 1e-4)
            assert rel_err(np_of(b["x"]), np_of(a["x"])) < 1e-5
            assert np.abs(np_of(b["P"]) - np_of(a["P"])).max() < 1e-4 * np.abs(np_of(a["P"])).max()
