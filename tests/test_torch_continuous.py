"""The port's continuous co-simulation (``ContinuousCoSimulation``: a 10 ms
plant under the 25 ms controller, delay compensation, the keepalive) with
the EKF between plant and controller, at small size (N cut from 40 to 10,
K from 96 to 16, 8 plant ticks), against stored JAX runs
(tests/data/torch_port/ctrl_barc_lmpc_continuous_ekf_n10.npz,
tests/torch_port_fixture.py), and the checks of tests/test_continuous.py at
a small tick count.

Gates are chip_smoke.py's: the teacher-forced controller within the
reference's worst reading between its runs; in closed loop a state every
tick, the schedule's controller cycles, the car on the track and moving
through the actuation outage, fallbacks and final progress within the
stored runs' limits; the EKF replayed on the stored observations within
1e-5 (state) and 1e-4 of the largest covariance entry.
"""

import numpy as np
import pytest

import chip_smoke
from racing_lmpc_torch.launch.runner import _SCENARIOS, ContinuousCoSimulation
from tests import torch_port_fixture as tf
from tests._torch_twin import controller_case

CASE = "ctrl_barc_lmpc_continuous_ekf_n10"


@pytest.fixture(scope="module")
def fx():
    with np.load(tf.fixture_path(CASE)) as z:
        return {k: z[k] for k in z.files}


def test_controller_cycle_matches_jax():
    reading, limits = controller_case(CASE)
    for k, limit in limits.items():
        assert reading[k] <= limit, (k, reading[k], limit)


def test_closed_loop_with_ekf_and_outage(fx):
    scenario, ticks, _, outage, kw = tf.CONT_CASES[CASE]
    sim, summary, _ = chip_smoke.run_continuous("cpu", scenario, ticks, outage, fx, **kw)
    assert sim.cs.controller.delay_step == 1
    assert sim.cs.controller.config.step_mode == "continuous"
    chip_smoke.continuous_gates(CASE, sim, summary, ticks, outage, fx)
    got = chip_smoke.ekf_replay(fx, sim.cs.ctrl_model, "cpu")
    assert got["x max"] <= chip_smoke.EKF_X_TOL and got["P max rel"] <= chip_smoke.EKF_P_TOL


def test_delay_step_2_configurable():
    """tests/test_continuous.py:80-92 at 12 plant ticks: delay_step = 2
    picks u[2] of the plan and the continuous loop still drives.  The
    reference allows 5% fallbacks over 120 cycles; over these 5 the first
    cycles after the bootstrap are its marginal ones, where the reference's
    own 12-tick runs fall back 0 (delay_step 2) or 1 (delay_step 1) times
    (measured), so at most one."""
    sim = ContinuousCoSimulation(_SCENARIOS["barc_tracking_mpc"], sim_dt=0.01,
                                 n_override=10, mpc_overrides={"delay_step": 2},
                                 device="cpu")
    assert sim.cs.controller.delay_step == 2
    summary = sim.run(12)
    assert summary["published_states"] == 12
    assert summary["controller_cycles"] == 5          # at 0, 30, 50, 80, 100 ms
    assert summary["fallback_rate"] <= 1 / 5
    s = np.array([m.p.s for m in sim.published])
    assert (np.diff(s) > 0).all()
    assert max(abs(m.p.x_tran) for m in sim.published) < 0.45
