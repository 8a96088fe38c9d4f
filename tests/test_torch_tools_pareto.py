"""racing_lmpc_torch/tools/pareto.py on the CPU: a 2-point grid at batch 4,
one repetition and a 2-solve chain, the engine side on one pinned instance
of each acceptance scenario; and the committed ``PARETO_torch.json``.

The record has the reference record's keys (``PARETO.json``), the shipped
default is the config's and ``PARETO.json``'s, ``gate_failures`` follows
scripts/pareto_bench.py:83-85's rule on the same engine records (an
instance fails when its applied steering error reaches its
``applied_steer_gate``), ``objective_gap_failures`` the same rule on the
objective gap and ``obj_gap_gate``, and ``copies_gate_failures`` both
rules on the medians over the instance and its 8 moved copies, with every
copy solved.  On the CPU no kernel launches, so
the launch counts are 0.  The tool refuses to write ``PARETO.json``.
"""

import json

import numpy as np
import pytest

import tests._torch_twin  # noqa: F401  (one torch thread per test worker)
from racing_lmpc_torch.config import RacingMPCConfig
from racing_lmpc_torch.tools import ROOT
from racing_lmpc_torch.tools import pareto
from tests import torch_port_fixture as tf

REFERENCE = json.loads((ROOT / "PARETO.json").read_text())
GATES = json.loads((ROOT / "ACCURACY.json").read_text())["per_instance"]
GRID = [{}, {"qp_zoom_rounds": 2}]


def reference_rule(records: dict) -> list:
    """scripts/pareto_bench.py:83-85."""
    return [t for t, v in records.items()
            if v["applied_steer_err"] >= GATES[t]["applied_steer_gate"]]


@pytest.fixture(scope="module")
def record(tmp_path_factory):
    from racing_lmpc_torch.tools.ground_accuracy import run_engine
    from racing_lmpc_torch.tools.accuracy import ACC_DIR
    runs = run_engine(ACC_DIR, None, "cpu", GRID, tags=tf.TOOLS_ENGINE_TAGS)
    out = tmp_path_factory.mktemp("pareto") / "PARETO_torch.json"
    doc = pareto.run("cpu", GRID, out, runs, batch=4, reps=1, chain=2, chain_reps=1)
    return doc, runs, json.loads(out.read_text())


def test_record_keys_and_default(record):
    doc, _, written = record
    assert written == json.loads(json.dumps(doc))
    assert set(REFERENCE) <= set(doc) and doc["device"] == "cpu"
    assert doc["power_limit_w"] is None
    cfg = RacingMPCConfig()
    assert doc["shipped_default"] == REFERENCE["shipped_default"] == {
        "qp_ip_iters": cfg.qp_ip_iters, "qp_zoom_iters": cfg.qp_ip_iters,
        "qp_zoom_rounds": cfg.qp_zoom_rounds}
    assert [p["overrides"] for p in doc["points"]] == GRID
    for p in doc["points"]:
        assert set(REFERENCE["points"][0]) <= set(p)
        assert p["batch"] == 4 and 0.0 <= p["solved_fraction"] <= 1.0
        assert np.isfinite(p["solves_per_s_batch256_N20"]) and p["batch1_chain_ms"] > 0
        assert p["chol_tri_inv_per_solve_batch"] == 0 == p["chol_tri_inv_per_solve_chain"]
    assert "{}" in doc["rationale"] and '{"qp_zoom_rounds": 2}' in doc["rationale"]


def test_gate_failures_follow_reference_rule(record):
    doc, runs, _ = record
    for p in doc["points"]:
        recs = runs[json.dumps(p["overrides"], sort_keys=True)]
        assert list(recs) == list(tf.TOOLS_ENGINE_TAGS)
        assert p["gate_failures"] == reference_rule(recs)
        assert p["objective_gap_failures"] == [
            t for t, v in recs.items() if v["objective_gap"] >= GATES[t]["obj_gap_gate"]]
        assert p["passes_all_pinned_gates"] == (not p["gate_failures"]
                                                and not p["objective_gap_failures"])
        assert p["copies_gate_failures"] == [
            f"{t} ({what})" for t, v in recs.items() for what, bad in (
                ("applied steer", v["applied_steer_median"] >= GATES[t]["applied_steer_gate"]),
                ("objective gap", v["objective_gap_median"] >= GATES[t]["obj_gap_gate"]),
                ("unsolved copies", v["copies_solved"] < 9)) if bad]
        assert p["worst_applied_steer_err"] == max(v["applied_steer_err"] for v in recs.values())


def test_refuses_reference_record():
    with pytest.raises(ValueError, match="reference"):
        pareto.run("cpu", GRID, ROOT / "PARETO.json")
    with pytest.raises(ValueError, match="reference"):
        pareto.main(["--out", str(ROOT / "PARETO.json"), "--device", "cpu"])


def test_committed_record():
    """PARETO_torch.json, written on the card by the tool: PARETO.json's 8
    grid points, the card and its power limit, the config's default."""
    doc = json.loads((ROOT / "PARETO_torch.json").read_text())
    assert [p["overrides"] for p in doc["points"]] == [p["overrides"] for p in REFERENCE["points"]]
    assert [p["overrides"] for p in doc["points"]] == pareto.GRID
    assert "H100" in doc["device"] and doc["power_limit_w"] > 0
    assert doc["shipped_default"] == REFERENCE["shipped_default"]
    for p in doc["points"]:
        assert p["batch"] == pareto.BATCH and p["chol_tri_inv_per_solve_batch"] > 0
        assert p["solves_per_s_batch256_N20"] > 0 and p["batch1_chain_ms"] > 0
