"""The port's ``BusCoSimulation`` (racing_lmpc_torch/launch/runner.py): the
controller and the simulator as two subscribers of the native bus.

On the CPU at tests/test_native.py's size (``barc_tracking_mpc``, N=10, 5
cycles): the smoke run's asserts (tests/test_native.py:123-133); every
actuation the bus carried bit-equal to the port's ``CoSimulation`` fed the
same struct-packed state messages on the main thread (the controller runs
on the bus's own thread, with its thread-local torch defaults); the run
held to the stored JAX ``BusCoSimulation`` runs
(``tests/data/torch_port/bus_barc_tracking_mpc_n10.npz``, written by
tests/torch_port_fixture.py) with the controller gates of ``chip_smoke.py``
(each limit the reference's worst reading between its own closed-loop runs,
moved by one f32 rounding, or the port's specification where looser); and
a node's error, and a ``close`` from a node, surfacing on the driving
thread instead of hanging it.
"""

import struct

import numpy as np
import pytest

import tests._torch_twin  # noqa: F401  (one torch thread per test worker)
from racing_lmpc_torch.launch.runner import _SCENARIOS, BusCoSimulation, CoSimulation

CASE = "bus_barc_tracking_mpc_n10"
SCENARIO, STEPS, N = "barc_tracking_mpc", 5, 10


@pytest.fixture(scope="module")
def bus_run():
    """One bus run with a recorder subscribed to both topics."""
    sim = BusCoSimulation(_SCENARIOS[SCENARIO], n_override=N, device="cpu")
    seen = {"vehicle_state": [], "vehicle_actuation": []}
    for topic in seen:
        sim.bus.subscribe(topic, lambda t, p: seen[t].append(p))
    try:
        summary = sim.run(STEPS, timeout_s=300.0)
        sim.bus.flush()
    finally:
        sim.close()
    return sim, summary, seen


def test_bus_cosimulation_smoke(bus_run):
    sim, summary, seen = bus_run
    assert summary["steps"] == STEPS
    assert summary["bus_messages"] >= 2 * STEPS  # 5 state + 5 actuation
    assert summary["fallback_rate"] <= 0.4
    assert set(summary) == {"laps", "lap_times", "steps", "fallback_rate",
                            "solve_time", "bus_messages"}
    # the kick-off state, one actuation and one state a cycle
    assert len(seen["vehicle_state"]) == STEPS + 1
    assert len(seen["vehicle_actuation"]) == STEPS
    # the count is read when the last state arrives: that message is
    # counted once its callbacks return, which may come after the read (in
    # the reference too)
    assert summary["bus_messages"] in (2 * STEPS, 2 * STEPS + 1)


def test_actuations_bit_equal_to_cosimulation(bus_run):
    _, _, seen = bus_run
    cs = CoSimulation(_SCENARIOS[SCENARIO], n_override=N, device="cpu")
    for state, act in zip(seen["vehicle_state"], seen["vehicle_actuation"]):
        a = cs.controller_cycle(BusCoSimulation.unpack_state(state))
        # the message's time stamp is the plant's clock, which this
        # controller-only run does not advance; the controls, to the bit
        assert struct.pack("<2d", a.u_a, a.u_steer) == act[8:]


def test_held_to_stored_jax_bus_runs(bus_run):
    import chip_smoke
    from tests import torch_port_fixture as tf
    sim, summary, seen = bus_run
    with np.load(tf.fixture_path(CASE)) as z:
        fx = {k: z[k] for k in z.files}
    assert tf.BUS_CASES[CASE][:2] == (SCENARIO, STEPS)
    tel = sim.cs.telemetry
    port = {"u_apply": np.asarray([t.control for t in tel], np.float64),
            "obj": np.asarray([t.cost for t in tel], np.float64),
            "used_fallback": np.asarray([not t.solved for t in tel])}
    reading = chip_smoke.ctrl_reading(port, chip_smoke.ctrl_runs(fx)[0], fx["scale_u"])
    limits = chip_smoke.ctrl_limits(fx)
    failed = {k: (v, limits[k]) for k, v in reading.items() if v > limits[k]}
    assert not failed, failed
    # the published actuations, within the same limits of scale_u
    acts = np.asarray([struct.unpack(BusCoSimulation.ACT_FMT, p)[1:]
                       for p in seen["vehicle_actuation"]])
    both = ~port["used_fallback"] & ~fx["used_fallback"][0]
    su = fx["scale_u"]
    assert (np.abs(acts[both, 0] - fx["u_a"][0][both]) / su[0]).max() <= limits["lon max"]
    steer = np.abs(acts[both, 1] - fx["u_steer"][0][both]) / su[1]
    assert np.percentile(steer, 90) <= limits["steer p90"]


def test_node_errors_surface_on_the_driving_thread():
    sim = BusCoSimulation(_SCENARIOS[SCENARIO], n_override=N, device="cpu")

    def broken(act):
        raise ValueError("plant failed")
    sim.cs.plant_cycle = broken
    closed = []

    def close_from_node(topic, payload):
        try:
            sim.bus.close()
        except RuntimeError as e:
            closed.append(str(e))
    sim.bus.subscribe("vehicle_actuation", close_from_node)
    try:
        with pytest.raises(ValueError, match="plant failed"):
            sim.run(2, timeout_s=300.0)
        sim.bus.flush()
        assert closed and "dispatch thread" in closed[0]
    finally:
        sim.close()
