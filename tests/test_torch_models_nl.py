"""The port's lookup tables, actuator maps, kinematic-bicycle and
double-track models and model factory (racing_lmpc_torch/ops/lookup.py,
models/) against the JAX package on inputs made from numpy seeds, and both
models in float64 against the independent transcription
tests/ref_models_f64.py.

Tolerances: the lookups and the actuator maps evaluate the same f32
expressions (1e-6 relative); the models' dynamics, RK4 steps, Jacobians and
constraint rows agree to 1e-5 relative, as tests/test_torch_models.py holds
the single-track model (the transcendentals round differently in the last
bits and the RK4 Jacobian chain carries that to ~1e-6; the affine remainder
g of the IAC-scale double-track to ~4e-6).  The float64 cross-check holds
tests/test_physics_crosscheck.py's 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import racing_lmpc_tpu.config as jc
import racing_lmpc_torch.config as tc
from racing_lmpc_tpu.models import factory as jf
from racing_lmpc_tpu.ops import lookup as jl
from racing_lmpc_torch.models import (
    DoubleTrackPlanarModel, KinematicBicycleModel, SingleTrackPlanarModel,
    load_vehicle_model)
from racing_lmpc_torch.ops import lookup as tl
from tests._torch_twin import rel_err, twin

import ref_models_f64 as ref

# model -> (factory name, base and model param files)
MODELS = {
    "kinematic": ("kinematic_bicycle_model",
                  ("barc_base.param.yaml", "barc_single_track.param.yaml")),
    "double_track_barc": ("double_track_planar_model",
                          ("barc_base.param.yaml", "barc_double_track.param.yaml")),
    "double_track_iac": ("double_track_planar_model",
                         ("sample_vehicle_base.param.yaml",
                          "sample_vehicle_double_track.param.yaml")),
}


def _pair(kind):
    name, files = MODELS[kind]
    return (jf.load_vehicle_model(name, jc.load_ros_params(*(jc.PARAM_DIR / f for f in files))),
            load_vehicle_model(name, tc.load_ros_params(*(tc.PARAM_DIR / f for f in files))))


def _samples(kind, rng, B):
    """Racing states and controls of each model's scale (the JAX tests'
    ranges): (x, u, k, dt) as f32."""
    if kind == "kinematic":
        x = np.stack([rng.uniform(0, 15, B), rng.uniform(-0.4, 0.4, B),
                      rng.uniform(-0.5, 0.5, B), rng.uniform(0.5, 3.5, B)], 1)
        u = np.stack([rng.uniform(0, 4, B), rng.uniform(-3, 0, B),
                      rng.uniform(-0.3, 0.3, B)], 1)
        k = rng.uniform(-1.5, 1.5, B)
    elif kind == "double_track_barc":
        x = np.stack([rng.uniform(0, 15, B), rng.uniform(-0.3, 0.3, B),
                      rng.uniform(-0.5, 0.5, B), rng.uniform(-1.5, 1.5, B),
                      rng.uniform(-0.15, 0.15, B), rng.uniform(1.0, 3.5, B)], 1)
        u = np.stack([rng.uniform(0, 4, B), rng.uniform(-3, 0, B),
                      rng.uniform(-0.3, 0.3, B)], 1)
        k = rng.uniform(-1.0, 1.0, B)
    else:
        x = np.stack([rng.uniform(0, 1000, B), rng.uniform(-3, 3, B),
                      rng.uniform(-0.3, 0.3, B), rng.uniform(-0.3, 0.3, B),
                      rng.uniform(-0.05, 0.05, B), rng.uniform(10, 60, B)], 1)
        u = np.stack([rng.uniform(0, 5000, B), rng.uniform(-5000, 0, B),
                      rng.uniform(-0.05, 0.05, B)], 1)
        k = rng.uniform(-0.02, 0.02, B)
    return [a.astype(np.float32) for a in (x, u, k, np.full(B, 0.025))]


# ---------------------------------------------------------------------------
# lookup tables
# ---------------------------------------------------------------------------

def test_lookup_cases_match_jax():
    """tests/test_ops.py:97-118's cases, on both packages."""
    x, y = np.array([0.0, 1.0, 2.0], np.float32), np.array([0.0, 10.0, 40.0], np.float32)
    for q, ext, want in ((0.5, False, 5.0), (1.5, False, 25.0), (-1.0, False, 0.0),
                         (5.0, False, 40.0), (3.0, True, 70.0)):
        j = float(jl.interp1d(jnp.asarray(x), jnp.asarray(y), jnp.asarray(q, jnp.float32), ext))
        t = float(tl.interp1d(torch.as_tensor(x), torch.as_tensor(y), q, ext))
        assert t == j and np.isclose(t, want)
    g = np.array([0.0, 1.0], np.float32)
    z = np.array([[0.0, 1.0], [2.0, 3.0]], np.float32)
    for qx, qy, want in ((0.5, 0.5, 1.5), (0.0, 1.0, 1.0), (1.0, 0.0, 2.0), (2.0, 2.0, 3.0)):
        j = float(jl.bilinear_interpolate(jnp.asarray(g), jnp.asarray(g), jnp.asarray(z), qx, qy))
        t = float(tl.bilinear_interpolate(torch.as_tensor(g), torch.as_tensor(g),
                                          torch.as_tensor(z), qx, qy))
        assert t == j and np.isclose(t, want)


@pytest.mark.parametrize("extrapolate", [False, True])
def test_lookup_random_grids_match_jax(extrapolate):
    """Random increasing grids and tables, queried inside, on and outside
    the grid (the saturated index and the edge clamp)."""
    rng = np.random.default_rng(3)
    for _ in range(4):
        xg = np.cumsum(rng.uniform(0.1, 2.0, 9)).astype(np.float32)
        yg = np.cumsum(rng.uniform(0.1, 2.0, 7)).astype(np.float32)
        z = rng.normal(size=(9, 7)).astype(np.float32)
        qx = np.concatenate([rng.uniform(xg[0] - 3, xg[-1] + 3, 40), xg]).astype(np.float32)
        qy = np.concatenate([rng.uniform(yg[0] - 3, yg[-1] + 3, 40), yg[:7], yg[:2]]
                            ).astype(np.float32)
        j, t = twin(lambda a, b, c: jl.interp1d(a, b, c, extrapolate),
                    lambda a, b, c: tl.interp1d(a, b, c, extrapolate), xg, z[:, 0], qx)
        assert rel_err(t, j) < 1e-6
        j, t = twin(lambda a, b, c, d, e: jl.bilinear_interpolate(a, b, c, d, e, extrapolate),
                    lambda a, b, c, d, e: tl.bilinear_interpolate(a, b, c, d, e, extrapolate),
                    xg, yg, z, qx, qy)
        assert t.dtype == np.float32 and rel_err(t, j) < 1e-6


# ---------------------------------------------------------------------------
# actuator maps
# ---------------------------------------------------------------------------

def test_actuator_maps_match_jax():
    """Every actuator map of the BARC car against the reference, and
    tests/test_models.py:253-278's closed-form check of the throttle
    inverse."""
    from racing_lmpc_tpu.models import SingleTrackPlanarModel as JModel
    jm, tm = JModel(*jc.barc_vehicle()), SingleTrackPlanarModel(*tc.barc_vehicle())
    rng = np.random.default_rng(4)
    for rpm, gear in ((3000.0, 2), (1234.5, 1), (7600.0, 3), (3000.0, 9)):
        for m in (jm, tm):
            m.vehicle_state.engine_rpm, m.vehicle_state.gear = rpm, gear
        for fd in (0.0, 5.0, *rng.uniform(0, 40, 4)):
            assert abs(tm.calc_throttle(fd) - jm.calc_throttle(fd)) <= 1e-6 * max(
                1.0, abs(jm.calc_throttle(fd)))
        for thr in (-5.0, 0.0, 30.0, 80.0, 120.0, *rng.uniform(0, 100, 4)):
            assert tm.calc_drive_force(thr) == pytest.approx(jm.calc_drive_force(thr), rel=1e-6)
        for fb in (1.0, 0.0, -5.0, *rng.uniform(-400, 0, 4)):
            assert tm.calc_brake(fb) == pytest.approx(jm.calc_brake(fb), rel=1e-12)
        for kpa in (0.0, 50.0, *rng.uniform(0, 5000, 4)):
            assert tm.calc_brake_force(kpa) == pytest.approx(jm.calc_brake_force(kpa), rel=1e-12)

    tm.vehicle_state.engine_rpm, tm.vehicle_state.gear = 3000.0, 2
    fd = 5.0
    thr = tm.calc_throttle(fd)
    assert 0.0 <= thr <= 100.0
    pt = tm.base_config.powertrain
    target = (fd * 0.05 * 1.0 / pt.mechanical_efficiency) / (pt.gear_ratio[1] * 3.0)
    tbl = pt.torque_table()
    rpm_i = list(pt.rpm).index(3000.0)
    t_min = tbl[rpm_i, 0]
    t_smp = tbl[rpm_i, 2] + (tbl[rpm_i, 3] - tbl[rpm_i, 2]) * (60.0 - 50.0) / 15.0
    assert np.isclose(thr, (target - t_min) / ((t_smp - t_min) / 60.0), rtol=1e-4)
    assert tm.calc_drive_force(80.0) > tm.calc_drive_force(30.0)
    assert tm.calc_brake(-5.0) >= 0.0 and tm.calc_brake(1.0) == 0.0


@pytest.mark.parametrize("kind", ["single_track", "kinematic", "double_track_barc"])
def test_lon_lat_control_match_jax(kind):
    """Each model's calc_lon_control / calc_lat_control on controls of
    either dominant channel."""
    if kind == "single_track":
        from racing_lmpc_tpu.models import SingleTrackPlanarModel as JModel
        jm, tm = JModel(*jc.barc_vehicle()), SingleTrackPlanarModel(*tc.barc_vehicle())
        us = [np.array([0.004, 0.1], np.float32), np.array([-0.003, -0.2], np.float32)]
    else:
        jm, tm = _pair(kind)
        us = [np.array([3.0, -1.0, 0.1], np.float32), np.array([0.5, -2.0, -0.2], np.float32)]
    for m in (jm, tm):
        m.vehicle_state.engine_rpm, m.vehicle_state.gear = 3000.0, 2
    for u in us:
        want, got = jm.calc_lon_control(jnp.asarray(u)), tm.calc_lon_control(torch.as_tensor(u))
        assert np.allclose(got, want, rtol=1e-6, atol=0.0)
        assert tm.calc_lat_control(torch.as_tensor(u)) == jm.calc_lat_control(jnp.asarray(u))


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["kinematic", "double_track_iac"])
def test_model_matches_jax(kind):
    """Dynamics, RK4 step, discrete (A, B, g), constraint rows and their
    Jacobians (all f32), base conversions and the QP-path data.  The
    double-track at the IAC scale only: the reference takes ~30 s on the
    CPU to evaluate its Jacobians through the Newton solve, and the BARC
    double-track is held by the float64 cross-check below."""
    jm, tm = _pair(kind)
    x, u, k, dt = _samples(kind, np.random.default_rng(5), 32)
    assert (tm.nx, tm.nu, tm.n_nl) == (jm.nx, jm.nu, jm.n_nl)
    fj, ft = twin(jax.vmap(jm.dynamics), tm.dynamics, x, u, k)
    assert rel_err(ft, fj) < 1e-5
    nj, nt = twin(jax.vmap(jm.discrete_dynamics), tm.discrete_dynamics, x, u, k, dt)
    assert rel_err(nt, nj) < 1e-5
    (Aj, Bj, gj), (At, Bt, gt) = twin(
        jax.vmap(jm.discrete_dynamics_jacobian), tm.discrete_dynamics_jacobian, x, u, k, dt)
    for got, want in ((At, Aj), (Bt, Bj), (gt, gj)):
        assert got.dtype == np.float32 and rel_err(got, want) < 1e-5

    def jax_nl(x, u, k):
        return (jm.nl_constraints(x, u, k),
                jax.jacfwd(lambda xx: jm.nl_constraints(xx, u, k))(x),
                jax.jacfwd(lambda uu: jm.nl_constraints(x, uu, k))(u))
    want = jax.vmap(jax_nl)(*(jnp.asarray(a) for a in (x, u, k)))
    got = tm._forward_jacobian(lambda xx, uu: tm.nl_constraints(xx, uu, torch.as_tensor(k)),
                               torch.as_tensor(x), torch.as_tensor(u))
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.float32 and g_.shape == w_.shape
        assert rel_err(g_.numpy(), np.asarray(w_)) < 1e-5

    bj, bt = twin(jax.vmap(jm.to_base_state), tm.to_base_state, x, u)
    assert rel_err(bt, bj) < 1e-6
    xb = bj.astype(np.float32)
    fj, ft = twin(jax.vmap(jm.from_base_state), tm.from_base_state, xb, u)
    assert rel_err(ft, fj) < 1e-6
    cj, ct = twin(jax.vmap(jm.to_base_control), tm.to_base_control, x, u)
    assert np.array_equal(ct, cj)
    for f in ("u_lb", "u_ub", "du_lb", "du_ub"):
        assert np.array_equal(getattr(tm.control_bounds(), f), getattr(jm.control_bounds(), f))
    assert tm.cost_state_indices() == jm.cost_state_indices()
    sj, st = jm.state_scales(), tm.state_scales()
    assert (sj is None and st is None) or np.array_equal(st, sj)


@pytest.mark.parametrize("kind", ["kinematic", "double_track_barc", "double_track_iac"])
def test_to_base_state_jacobian_matches_jax(kind):
    """``VehicleModel.to_base_state_jacobian`` (base.py:147-152): the
    Jacobians of the nonlinear base conversions, in f32, over any leading
    batch shape."""
    jm_, tm_ = _pair(kind)
    x, u, _, _ = _samples(kind, np.random.default_rng(4), 32)
    (Jxj, Juj), (Jxt, Jut) = twin(jax.vmap(jm_.to_base_state_jacobian),
                                  tm_.to_base_state_jacobian, x, u)
    for got, want in ((Jxt, Jxj), (Jut, Juj)):
        assert got.dtype == np.float32
        assert got.shape == want.shape
        assert rel_err(got, want) < 1e-5
    Jx2, _ = tm_.to_base_state_jacobian(torch.as_tensor(x).reshape(4, 8, -1),
                                        torch.as_tensor(u).reshape(4, 8, -1))
    assert np.array_equal(Jx2.reshape(Jxt.shape).numpy(), Jxt)


def test_kinematic_closed_form():
    """tests/test_models.py:186-218 on the port: the division-free yaw rate,
    the slip-angle velocities and the base-state round trip."""
    tm = _pair("kinematic")[1]
    x = torch.tensor([0.0, 0.0, 0.0, 2.0])
    u = torch.tensor([1.0, 0.0, 0.1])
    xd = tm.dynamics(x, u, torch.tensor(0.0)).numpy()
    base = tm.base_config
    l = base.chassis.wheel_base
    beta = np.arctan(base.chassis.cg_ratio * l * np.tan(0.1) / l)
    R = (l / np.tan(0.1)) / np.cos(beta)
    assert np.allclose(xd[:3], [2.0 * np.cos(beta), 2.0 * np.sin(beta), 2.0 / R], atol=1e-6)
    xb = tm.to_base_state(x, u)
    assert np.allclose(xb[3:5].numpy(), [2.0 * np.cos(beta), 2.0 * np.sin(beta)], atol=1e-6)
    assert np.allclose(tm.from_base_state(xb, torch.zeros(3)).numpy(), x.numpy(), atol=1e-6)
    # the straight-line linearization point is finite (no R-form pole)
    A, B, _ = tm.discrete_dynamics_jacobian(*(a[None] for a in (
        x, torch.tensor([1.0, 0.0, 0.0]), torch.tensor(0.0), torch.tensor(0.025))))
    assert bool(torch.isfinite(A).all() and torch.isfinite(B).all())


def test_solve_gamma_y_matches_jax():
    """The 8-step Newton for the load transfer and its residual against the
    reference, on tests/test_models.py:221-250's IAC cornering state and a
    seeded batch."""
    jm, tm = _pair("double_track_iac")
    x = np.array([0.0, 0.0, 0.0, 0.1, 0.01, 30.0], np.float32)
    u = np.array([2000.0, 0.0, 0.03], np.float32)
    gt = tm.solve_gamma_y(torch.as_tensor(x), torch.as_tensor(u))
    gj = float(jm.solve_gamma_y(jnp.asarray(x), jnp.asarray(u)))
    assert gt.dtype == torch.float32 and float(gt) != 0.0
    assert abs(float(gt) - gj) <= 1e-5 * max(1.0, abs(gj))
    assert abs(float(tm._gamma_residual(gt, torch.as_tensor(x), torch.as_tensor(u)))) < 1e-6 * max(
        1.0, abs(gj))
    xs, us, _, _ = _samples("double_track_iac", np.random.default_rng(6), 64)
    gj, gt = twin(jax.vmap(jm.solve_gamma_y), tm.solve_gamma_y, xs, us)
    assert rel_err(gt, gj) < 1e-5
    # the residual at the root is the f32 noise of a difference of two
    # loads of gamma's size: held relative to that size
    rj, rt = twin(jax.vmap(jm._gamma_residual), tm._gamma_residual, gj.astype(np.float32), xs, us)
    assert np.abs(rt - rj).max() <= 1e-5 * np.abs(gj).max()
    ej, et = twin(jax.vmap(jm.friction_ellipse), tm.friction_ellipse, xs, us)
    assert rel_err(et, ej) < 1e-5


def test_factory_matches_jax():
    p_j = jc.load_ros_params(jc.PARAM_DIR / "barc_base.param.yaml",
                             jc.PARAM_DIR / "barc_single_track.param.yaml")
    p_t = tc.load_ros_params(tc.PARAM_DIR / "barc_base.param.yaml",
                             tc.PARAM_DIR / "barc_single_track.param.yaml")
    for name, cls in (("single_track_planar_model", SingleTrackPlanarModel),
                      ("kinematic_bicycle_model", KinematicBicycleModel)):
        m, mj = load_vehicle_model(name, p_t), jf.load_vehicle_model(name, p_j)
        assert type(m) is cls and type(mj).__name__ == cls.__name__
        assert (m.nx, m.nu, m.n_nl) == (mj.nx, mj.nu, mj.n_nl)
    for kind in ("double_track_barc", "double_track_iac"):
        mj, m = _pair(kind)
        assert type(m) is DoubleTrackPlanarModel
        assert dataclasses.asdict(m.config) == dataclasses.asdict(mj.config)
    with pytest.raises(ValueError):
        load_vehicle_model("hovercraft", p_t)


# ---------------------------------------------------------------------------
# float64 cross-check against the independent transcription
# ---------------------------------------------------------------------------

def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(1.0, np.max(np.abs(b)))


@pytest.mark.parametrize("kind", ["kinematic", "double_track"])
def test_crosscheck_f64(kind):
    """tests/test_physics_crosscheck.py:121-154 on the port in float64: x_dot,
    the RK4 step and the discrete (A, B, g) against ref_models_f64 (complex
    step) to 1e-6, on the same seeded samples."""
    if kind == "kinematic":
        _, m = _pair("kinematic")
        rng = np.random.default_rng(13)
        n = 8
        X = np.stack([rng.uniform(0, 15, n), rng.uniform(-0.4, 0.4, n),
                      rng.uniform(-0.5, 0.5, n), rng.uniform(0.5, 3.5, n)], axis=1)
        delta = rng.uniform(0.03, 0.3, n) * rng.choice([-1.0, 1.0], n)
        U = np.stack([rng.uniform(0, 4, n), rng.uniform(-3, 0, n), delta], axis=1)
        ks = rng.uniform(-1.5, 1.5, n)
        xdot = ref.kinematic_xdot
    else:
        _, m = _pair("double_track_barc")
        rng = np.random.default_rng(17)
        n = 6
        X = np.stack([rng.uniform(0, 15, n), rng.uniform(-0.3, 0.3, n),
                      rng.uniform(-0.5, 0.5, n), rng.uniform(-1.5, 1.5, n),
                      rng.uniform(-0.15, 0.15, n), rng.uniform(1.0, 3.5, n)], axis=1)
        U = np.stack([rng.uniform(0, 4, n), rng.uniform(-3, 0, n),
                      rng.uniform(-0.3, 0.3, n)], axis=1)
        ks = rng.uniform(-1.0, 1.0, n)
        xdot = ref.double_track_xdot
    base, cfg, dt = m.base_config, m.config, 0.025
    f64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)  # noqa: E731
    x, u, k = f64(X), f64(U), f64(ks)
    xd = m.dynamics(x, u, k).numpy()
    xp = m.discrete_dynamics(x, u, k, f64(np.full(n, dt))).numpy()
    A, B, g = (a.numpy() for a in m.discrete_dynamics_jacobian(x, u, k, f64(np.full(n, dt))))
    assert A.dtype == np.float64
    for i in range(n):
        assert _rel(xd[i], xdot(X[i], U[i], ks[i], base, cfg)) < 1e-6
        assert _rel(xp[i], ref.discrete(xdot, X[i], U[i], ks[i], dt, base, cfg)) < 1e-6
        A_ref, B_ref, g_ref = ref.cstep_jacobians(xdot, X[i], U[i], ks[i], dt, base, cfg)
        assert _rel(A[i], A_ref) < 1e-6
        assert _rel(B[i], B_ref) < 1e-6
        assert _rel(g[i], g_ref) < 1e-6
