"""The whole slice at small size: the port's controller cycle of the
BARC LMPC launch scenario (N cut from 40 to 10, K from 96 to 16): the RTI branch of the cycle, one solve a cycle after the SQP bootstrap.

The JAX package's ``CoSimulation`` ran bootstrap + 3 cycles and 8 re-runs
with every controller input moved by about one f32 rounding
(tests/data/torch_port/ctrl_barc_lmpc_n10.npz, tests/torch_port_fixture.py;
compiling its controller takes ~90 s on the CPU, so the runs are stored and
regenerated by a slow test in tests/test_torch_fixture.py).  The port's
controller is fed the first run's per-cycle states and previous controls
(teacher forcing), and its applied controls, fallbacks and objectives must
lie within the reference's worst reading between its own runs, or the
port's specification where that is looser (chip_smoke.py's controller
gates; readings in PERF.md).
"""

from tests._torch_twin import controller_case


def test_controller_cycle_matches_jax():
    reading, limits = controller_case("ctrl_barc_lmpc_n10")
    for k, limit in limits.items():
        assert reading[k] <= limit, (k, reading[k], limit)
