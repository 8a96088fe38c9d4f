"""The BARC LMPC controller cycle with the safe-set error-dynamics
regression at small size (N cut from 40 to 10, K from 96 to 16), the groups
of tests/test_lmpc.py:97-100 (the v_tran and yaw-rate errors from
(v_long, v_tran, yaw rate, u), dist_max 3.0).

The JAX package's ``CoSimulation`` ran bootstrap + 3 cycles and 8 re-runs
with every controller input moved by about one f32 rounding, each cycle's
dA/dB/dC stored (tests/data/torch_port/ctrl_barc_lmpc_regression_n10.npz,
tests/torch_port_fixture.py).  The port's controller is fed the first run's
per-cycle states and previous controls (teacher forcing): its applied
controls, fallbacks and objectives, and its regression corrections, must
lie within the reference's worst reading between its own runs, or the
port's specification where that is looser (chip_smoke.py's gates).
"""

from tests._torch_twin import controller_case


def test_controller_cycle_with_regression_matches_jax():
    reading, limits = controller_case("ctrl_barc_lmpc_regression_n10")
    assert {"dA max", "dB max", "dC max"} <= set(limits)
    for k, limit in limits.items():
        assert reading[k] <= limit, (k, reading[k], limit)
