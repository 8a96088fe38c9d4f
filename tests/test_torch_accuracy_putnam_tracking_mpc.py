"""The port replays the pinned putnam_short_tracking_mpc instances (tests/data/acc_instances,
captured from the shipped launch scenario) on the CPU at their ACCURACY.json
gates; see tests/_torch_twin.py::replay_instance for the gates and why
the steering gates hold the median over rounding-perturbed copies."""

import json
from pathlib import Path

import pytest

from tests._torch_twin import acc_instances, replay_instance

ROOT = Path(__file__).resolve().parent.parent
GATES = json.loads((ROOT / "ACCURACY.json").read_text())["per_instance"]
INSTANCES = acc_instances("putnam_short_tracking_mpc")


@pytest.mark.parametrize("rec,d", INSTANCES, ids=[r["tag"] for r, _ in INSTANCES])
def test_port_meets_accuracy_gates(rec, d):
    replay_instance(rec, d, replicas=9, gates=GATES[rec["tag"]])
