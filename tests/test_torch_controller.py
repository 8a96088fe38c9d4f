"""The port's MPCController (racing_lmpc_torch/control/loop.py) piece by
piece against the JAX package's, with no solve: the shifted cycle input
(``build_step_input``, both step modes), the raceline hot swap with its
Frenet re-projection and the trajectory command (tests/test_closed_loop.py
:93-131), the safe-set query layouts and what the port refuses.

Tolerances: the same f32 operations, eager on one side and fused by XLA on
the other, agree to 1e-5 relative (the Newton re-projection to 1e-4 m).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import racing_lmpc_tpu.config as jc
from racing_lmpc_tpu.control.loop import (
    ControllerState as JState, MPCController as JController, RegressionSpec)
from racing_lmpc_tpu.models import SingleTrackPlanarModel as JModel
from racing_lmpc_tpu.msgs import TrajectoryCommand as JCommand
from racing_lmpc_tpu.track import RacingTrajectoryMap as JMap
import racing_lmpc_torch.config as tc
from racing_lmpc_torch.control import ControllerState, MPCController
from racing_lmpc_torch.models import SingleTrackPlanarModel
from racing_lmpc_torch.msgs import TrajectoryCommand
from racing_lmpc_torch.track import RacingTrajectoryMap
from tests._torch_twin import np_of, rel_err

N, K = 10, 16


def pair(name="barc_lmpc", **overrides):
    """(JAX, port) controllers of one BARC configuration on raceline 2, and
    their raceline maps."""
    out = []
    for c, M, Map, C, dev in ((jc, JModel, JMap, JController, {}),
                              (tc, SingleTrackPlanarModel, RacingTrajectoryMap,
                               MPCController, {"device": "cpu"})):
        model = M(*c.barc_vehicle())
        cfg = c.barc_mpc_config(name, n=N, num_ss_pts=K, **overrides)
        tmap = Map(c.TRACK_DIR / "barc", **dev)
        out.append((C(cfg, model, tmap.get_trajectory(2), 0.025, **dev), tmap))
    return out


def state(rng, nu=2):
    """A plan along the track: abscissae stepping forward, small offsets."""
    X = np.zeros((N, 6), np.float32)
    X[:, 0] = 3.0 + 0.05 * np.arange(N)
    X[:, 1:3] = rng.uniform(-0.1, 0.1, (N, 2))
    X[:, 3] = rng.uniform(1.5, 2.0, N)
    X[:, 4:] = rng.uniform(-0.1, 0.1, (N, 2))
    U = rng.uniform(-0.01, 0.01, (N - 1, nu)).astype(np.float32)
    dU = rng.uniform(-0.1, 0.1, (N - 1, nu)).astype(np.float32)
    lam = rng.uniform(size=K).astype(np.float32)
    return X, U, dU, lam / lam.sum()


@pytest.mark.parametrize("step_mode", ["step", "continuous"])
def test_build_step_input_matches_jax(step_mode):
    (jctrl, _), (tctrl, _) = pair(step_mode=step_mode)
    rng = np.random.default_rng(0)
    arrays = state(rng)
    x_ic = np.array([3.01, 0.02, 0.01, 1.6, 0.0, 0.1], np.float32)
    u_ic = np.array([0.005, -0.02], np.float32)
    ss_x = rng.normal(size=(K, 6)).astype(np.float32)
    ss_j = rng.uniform(0, 50, K).astype(np.float32)
    for limit, scale in ((np.inf, 0.9), (1.7, 1.0)):
        jinp, jz, jdu = jctrl.build_step_input(
            jnp.asarray(x_ic), jnp.asarray(u_ic), JState(*map(jnp.asarray, arrays)),
            jnp.asarray(ss_x), jnp.asarray(ss_j), jnp.float32(limit), jnp.float32(scale))
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
        tinp, tz, tdu = tctrl.build_step_input(
            f32(x_ic), f32(u_ic), ControllerState(*map(f32, arrays)), f32(ss_x),
            f32(ss_j), f32(limit), f32(scale))
        for name in tinp._fields:
            assert rel_err(np_of(getattr(tinp, name)), np_of(getattr(jinp, name))) < 1e-5, name
        assert np.array_equal(np_of(tz), np_of(jz))
        assert np.array_equal(np_of(tdu), np_of(jdu))
    assert tctrl.delay_step == jctrl.delay_step == (1 if step_mode == "continuous" else 0)


def test_trajectory_command_reprojects_the_plan():
    (jctrl, jmap), (tctrl, tmap) = pair("barc_tracking_mpc", learning=False)
    X, U, dU, _ = state(np.random.default_rng(1))
    jctrl.state = JState(jnp.asarray(X), jnp.asarray(U), jnp.asarray(dU), jnp.zeros((0,)))
    tctrl.state = ControllerState(*(torch.as_tensor(a) for a in (X, U, dU)), torch.zeros(0))
    jctrl.on_trajectory_command(JCommand(trajectory_index=15, speed_limit=2.5,
                                         velocity_profile_scale=0.9), jmap)
    tctrl.on_trajectory_command(TrajectoryCommand(trajectory_index=15, speed_limit=2.5,
                                                  velocity_profile_scale=0.9), tmap)
    assert tctrl.track is tmap.get_trajectory(15)
    assert (tctrl.speed_limit, tctrl.speed_scale) == (jctrl.speed_limit, jctrl.speed_scale)
    got, want = np_of(tctrl.state.last_X), np_of(jctrl.state.last_X)
    assert np.abs(got - want).max() < 1e-4
    assert np.array_equal(got[:, 3:], X[:, 3:])
    # an unknown raceline and non-positive limits leave everything as it is
    tctrl.on_trajectory_command(TrajectoryCommand(trajectory_index=99, speed_limit=0.0,
                                                  velocity_profile_scale=-1.0), tmap)
    assert tctrl.track is tmap.get_trajectory(15)
    assert (tctrl.speed_limit, tctrl.speed_scale) == (2.5, 0.9)


def test_safe_set_query_layouts():
    (jctrl, _), (tctrl, _) = pair()
    x_t = np.array([5.0, 0.05, 0.0, 1.8, 0.0, 0.0], np.float32)
    # no lap stored yet: the terminal hull pinned at the terminal state
    ss_x, ss_j = tctrl._query_safe_set(torch.as_tensor(x_t))
    jx, jj = jctrl._query_safe_set(jnp.asarray(x_t))
    assert np.array_equal(np_of(ss_x), np_of(jx)) and np.array_equal(np_of(ss_j), np_of(jj))
    assert ss_x.shape == (K, 6)
    (_, _), (track_ctrl, _) = pair("barc_tracking_mpc", learning=False)
    ss_x, ss_j = track_ctrl._query_safe_set(torch.as_tensor(x_t))
    assert ss_x.shape == (0, 6) and ss_j.shape == (0,)


def test_controller_refuses_the_regression():
    """The regression is ported (tests/test_torch_regression.py): the
    controller takes a ``RegressionSpec``, the reference's own type
    included; what the port refuses, as the reference does
    (``safe_set.py:256-258``), is a regression group with more than one
    output state."""
    from racing_lmpc_torch.safeset import RegQuery
    model = SingleTrackPlanarModel(*tc.barc_vehicle())
    tmap = RacingTrajectoryMap(tc.TRACK_DIR / "barc", device="cpu")
    ctrl = MPCController(tc.barc_mpc_config(n=N), model, tmap.get_trajectory(2), 0.025,
                         regression=RegressionSpec(0.5, (((1,), (0,), 1),)), device="cpu")
    assert ctrl.regression.dist_max == 0.5
    x = np.zeros((40, 6))
    x[:, 0] = np.linspace(0.0, 2.0, 40)
    ctrl.ss_manager.add_lap(x, np.zeros((40, 2)), np.zeros(40), 0.025 * np.arange(40), 17.0)
    with pytest.raises(ValueError):
        ctrl.ss_manager.query_regression(RegQuery(
            x=np.zeros(2), dist_max=1.0, reg_in_state_idxs=[[1]], reg_in_control_idxs=[[0]],
            reg_out_state_idxs=[[1, 2]], A=np.zeros((6, 6)), B=np.zeros((6, 2)),
            C=np.zeros(6), f=model.discrete_dynamics), device="cpu")


def test_cycle_profiler_matches_jax():
    from racing_lmpc_tpu.control.telemetry import CycleProfiler as JProfiler
    from racing_lmpc_torch.control import CycleProfiler
    j, t = JProfiler(capacity=4), CycleProfiler(capacity=4)
    assert vars(t.profile()) == vars(j.profile())
    for v in (0.03, 0.01, 0.2, 0.05, 0.02, 0.04):
        j.add_cycle_stats(v)
        t.add_cycle_stats(v)
    assert len(t) == 4 and vars(t.profile()) == vars(j.profile())
    assert t.profile().to_diagnostic_status("solve", "s", 0.1) == \
        j.profile().to_diagnostic_status("solve", "s", 0.1)
