"""The port's PID, pure-pursuit baseline, logger and the runner's command
line against the JAX package's (tests/test_aux.py).

The PID is plain Python in both packages and agrees exactly; the vanilla
controller's two Frenet -> global conversions run in f32 on each side, so
its commands agree to 1e-4 relative (measured at f32 rounding).
"""

import json

import numpy as np
import pytest

import racing_lmpc_tpu.config as jc
from racing_lmpc_tpu.control.pid import PidCoefficients as JCoeffs, PidController as JPid
from racing_lmpc_tpu.control.vanilla import (
    VanillaController as JVanilla, VanillaControllerConfig as JVanillaConfig)
from racing_lmpc_tpu.models import SingleTrackPlanarModel as JModel
from racing_lmpc_tpu.track import RacingTrajectory as JTrack
import racing_lmpc_torch.config as tc
from racing_lmpc_torch.control import (
    Logger, LogLevel, PidCoefficients, PidController, VanillaController,
    VanillaControllerConfig)
from racing_lmpc_torch.models import SingleTrackPlanarModel
from racing_lmpc_torch.track import RacingTrajectory


def test_pid_integral_clamp_matches_jax():
    kw = dict(k_p=1.0, k_i=1.0, k_d=0.5, min_cmd=-10, max_cmd=10, min_i=-0.5, max_i=0.5)
    j, t = JPid("t", JCoeffs(**kw)), PidController("t", PidCoefficients(**kw))
    rng = np.random.default_rng(0)
    for e in rng.normal(size=40):
        assert t.update(float(e), 0.1) == j.update(float(e), 0.1)
    t.reset_integral_error()
    for _ in range(100):
        out = t.update(1.0, 0.1)
    assert t.integral_error == 0.5          # clamped
    assert out == 1.5                       # p = 1 + i = 0.5
    assert np.isnan(t.update(float("nan"), 0.1))


@pytest.fixture(scope="module")
def vanilla_pair():
    cfg = dict(lookahead_speed_ratio=0.5, min_lookahead_distance=0.5,
               max_lookahead_distance=2.0, dt=0.025)
    pid = dict(k_p=2.0, k_i=0.0, k_d=0.0, min_cmd=-10, max_cmd=10, min_i=-1, max_i=1)
    track_file = tc.TRACK_DIR / "barc" / "02_barc_center.txt"
    j = JVanilla(JVanillaConfig(lon_pid_coeffs=JCoeffs(**pid), **cfg),
                 JModel(*jc.barc_vehicle()), JTrack.from_file(track_file))
    t = VanillaController(VanillaControllerConfig(lon_pid_coeffs=PidCoefficients(**pid), **cfg),
                          SingleTrackPlanarModel(*tc.barc_vehicle()),
                          RacingTrajectory.from_file(track_file, device="cpu"))
    return j, t


def test_vanilla_controller_matches_jax(vanilla_pair):
    j, t = vanilla_pair
    rng = np.random.default_rng(1)
    for _ in range(12):
        x = np.array([rng.uniform(0, 17), rng.uniform(-0.3, 0.3), rng.uniform(-0.2, 0.2),
                      rng.uniform(0.5, 4.0), rng.uniform(-0.1, 0.1), 0.0])
        v = rng.uniform(1.0, 3.0)
        want, got = j.solve(x, vel_ref=v), t.solve(x, vel_ref=v)
        assert np.abs(got - want).max() <= 1e-4 * max(1.0, np.abs(want).max())


def test_vanilla_controller_steers_toward_raceline(vanilla_pair):
    """tests/test_aux.py:97-118 on the port."""
    _, ctrl = vanilla_pair
    u = ctrl.solve(np.array([1.0, 0.3, 0.0, 1.5, 0.0, 0.0]), vel_ref=2.0)
    assert u[2] < -0.01 and u[0] > 0.0 and u[1] == 0.0
    assert ctrl.solve(np.array([1.0, -0.3, 0.0, 1.5, 0.0, 0.0]), vel_ref=2.0)[2] > 0.01
    u3 = ctrl.solve(np.array([1.0, 0.0, 0.0, 4.0, 0.0, 0.0]), vel_ref=1.0)
    assert u3[1] < 0.0 and u3[0] == 0.0


def test_logger_callbacks():
    log, seen = Logger(), []
    log.register_callback(lambda lvl, msg: seen.append((lvl, msg)))
    log.send_log(LogLevel.WARN, "hello")
    assert seen == [(LogLevel.WARN, "hello")]


def test_runner_main_on_the_cpu(tmp_path, capsys):
    """``python -m racing_lmpc_torch.launch.runner`` at N=10 for a few
    cycles on the CPU: its summary and telemetry file."""
    from racing_lmpc_torch.launch.runner import main
    out = tmp_path / "telemetry.json"
    main(["barc_tracking_mpc", "--steps", "3", "--horizon", "10", "--device", "cpu",
          "--telemetry-out", str(out), "--log-every", "1"])
    printed = capsys.readouterr().out
    summary = json.loads(printed[printed.index("{"):])
    assert summary["laps"] == 0 and summary["fallback_rate"] <= 1.0
    assert summary["solve_time"]["max"] > 0.0
    tel = json.loads(out.read_text())
    assert len(tel) == 3 and all(np.isfinite(t["control"]).all() for t in tel)
    with pytest.raises(SystemExit):
        main(["no_such_scenario"])
