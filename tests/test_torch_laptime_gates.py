"""Lap-time and learning-benefit gates of the port (the port twin of
tests/test_laptime_gates.py), marked ``slow``: they drive the shipped
configurations (BARC LMPC N=40, K=96, three recorded laps, 40 Hz; the 10 Hz
IAC LMPC) through the port's co-simulation for whole laps, on the GPU when
there is one (else the CPU).  This file imports no JAX, so it runs on a
machine without it:

    python -m pytest --noconftest -m slow tests/test_torch_laptime_gates.py -s

The tests mirror the reference's gates (8 BARC LMPC laps, the tracking
controller's 3, 200 Putnam cycles); the BARC LMPC run prints its lap times
and cycle times (``-s``).
"""

import subprocess

import numpy as np
import pytest
import torch

from racing_lmpc_torch.launch.runner import _SCENARIOS, CoSimulation

pytestmark = pytest.mark.slow

DEVICE = "cuda" if torch.cuda.is_available() else "cpu"


def drive(cs, laps: int, max_steps: int) -> int:
    steps = 0
    while len(cs.lap_times) < laps and steps < max_steps:
        cs.step()
        steps += 1
    return steps


def fallback_rate(cs) -> float:
    return float(np.mean([not t.solved for t in cs.telemetry]))


@pytest.fixture(scope="module")
def barc_lmpc_run():
    cs = CoSimulation(_SCENARIOS["barc_lmpc"], device=DEVICE)
    drive(cs, 8, 3200)
    return cs, fallback_rate(cs)


def test_barc_lmpc_laptime(barc_lmpc_run):
    cs, fallback = barc_lmpc_run
    lt = cs.lap_times
    ms = np.array([t.solve_time * 1e3 for t in cs.telemetry])
    if DEVICE == "cuda":
        print("\n" + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip())
    print(f"\nport BARC LMPC on {DEVICE}: lap times {lt} s over {len(cs.telemetry)} cycles; "
          f"fallback rate {fallback:.4f}; cycle wall ms median {np.median(ms[1:]):.1f}")
    assert len(lt) >= 8, f"only {len(lt)} laps completed"
    assert np.median(lt) <= 5.5, f"median lap {np.median(lt):.2f}s"
    assert max(lt) <= 6.0, f"worst lap {max(lt):.2f}s"
    assert fallback <= 0.01, f"fallback rate {fallback:.3f}"


def test_barc_lmpc_beats_tracking(barc_lmpc_run):
    cs, _ = barc_lmpc_run
    trk = CoSimulation(_SCENARIOS["barc_tracking_mpc"], device=DEVICE)
    drive(trk, 3, 1400)
    assert len(trk.lap_times) >= 3, "tracking controller failed to lap"
    lmpc_med, trk_med = float(np.median(cs.lap_times)), float(np.median(trk.lap_times))
    assert lmpc_med < trk_med, f"no learning benefit: LMPC {lmpc_med:.2f}s vs {trk_med:.2f}s"
    assert lmpc_med < 7.0


def test_putnam_short_lmpc_runs():
    cs = CoSimulation(_SCENARIOS["putnam_short_lmpc"], device=DEVICE)
    summary = cs.run(200)
    assert summary["fallback_rate"] <= 0.02, summary["fallback_rate"]
    v = [t.state[3] for t in cs.telemetry[-50:]]
    assert np.mean(v) > 8.0, f"IAC car not at speed: {np.mean(v):.1f} m/s"


def test_putnam_config_a_smoke():
    cs = CoSimulation(_SCENARIOS["putnam_config_a_tracking_mpc"], n_override=40, device=DEVICE)
    assert cs.run(60)["fallback_rate"] <= 0.1
