"""racing_lmpc_torch/tools/ground_accuracy.py on the CPU against the
reference tool (scripts/ground_accuracy.py) and its records.

- ``--osqp``: on the first two pinned instances, each of the 9 runs (3
  starts from numpy seed 0 x 3 adaptive-rho intervals) gives the status,
  iterations and polish of the JAX package's ``osqp_ref`` from the same
  start, its deviations (applied and tail steering, longitudinal control,
  objective gap) within 1e-9.  One run (barc_tracking_mpc[6], the "near"
  start, interval 100) is a tie of the reference's polish rule: the two
  unpolished iterates agree within 1e-9, but polish takes its active set
  from the signs of the duals (osqp_ref.py:236-243), and duals of ~1e-17
  there fall on either side of zero in the two packages' sums, so one
  active set's polish is accepted and the other's rejected.  Such a run is
  held to that explanation (unpolished iterates within 1e-9, every dual
  whose sign differs below 1e-12 in magnitude), and at most one is allowed.
- ``--finalize`` fed those records: ``ACCURACY.json``'s
  ``applied_steer_gate`` and ``obj_gap_gate`` within 1e-9 relative and its
  ``osqp_accepted_runs`` equal, for those instances; the whole pipeline
  (``--osqp --engine --finalize``, ~70 s here) the same on all 11.
- ``--engine``: on one instance of each scenario at the shipped config and
  at 2 zoom rounds, each field of the port's record (one exact copy) as far
  from the reference tool's record of the same instance as the reference's
  records of the instance and its 8 copies moved by one f32 rounding lie
  from each other (``tools_engine_runs.npz``), at least 1e-6; ``solved``
  equal.
- ``--capture``: at the first capture point of each scenario, the port's
  P, q, A, l and u (relative to max(1, max |entry|)) and the certified
  optimum's controls (over ``scale_u``) as far from the pinned instance as
  the reference's captures in runs moved by one f32 rounding lie from each
  other (``tools_capture_spread.npz``); ``nvar``, ``nrow``, ``learning`` and
  the arrays' keys equal.  Those captures' optima spread far above 1e-6 in
  the controls (the fixture's ``spread``), so the capture's optimum is held
  there; the oracle's own landing within 1e-6 of the stored optimum on the
  stored QPs is ``chip_smoke.accuracy_phase``'s check
  (tests/test_torch_accuracy_phase.py here, all 11 on the card).
- The tool refuses to write the reference's records.
"""

import json

import numpy as np
import pytest

import chip_smoke
import tests._torch_twin  # noqa: F401  (one torch thread per test worker)
from racing_lmpc_torch.tools import ROOT
from racing_lmpc_torch.tools import ground_accuracy as ga
from racing_lmpc_torch.tools.accuracy import ACC_DIR, controls, load_instances
from tests import torch_port_fixture as tf

ACCURACY = json.loads((ROOT / "ACCURACY.json").read_text())["per_instance"]
_, INSTANCES = load_instances()
FIRST_TWO = [rec["tag"] for rec, _ in INSTANCES[:2]]
DEV_FIELDS = ("applied_steer_dev", "steer_tail_dev", "lon_dev", "obj_gap_rel")


def polish_tie(d, x0, interval: int) -> bool:
    """Whether both packages' OSQP, unpolished, reach the same iterate
    (within 1e-9) with duals whose signs differ only where both are below
    1e-12 in magnitude: a tie of polish's active-set rule."""
    import torch
    from racing_lmpc_tpu.mpc import osqp_ref as ref
    from racing_lmpc_torch.mpc import osqp_ref as port
    a = ref.solve(*(d[k] for k in "PqAlu"), x0=x0, adaptive_rho_interval=interval,
                  do_polish=False)
    b = port.solve(*(torch.as_tensor(d[k]) for k in "PqAlu"), x0=torch.as_tensor(x0),
                   adaptive_rho_interval=interval, do_polish=False)
    yb = b.y.numpy()
    flipped = np.sign(a.y) != np.sign(yb)
    return (bool(flipped.any()) and np.abs(a.x - b.x.numpy()).max() <= 1e-9
            and max(np.abs(a.y[flipped]).max(), np.abs(yb[flipped]).max()) < 1e-12)


def reference_osqp_runs(tags) -> dict:
    """scripts/ground_accuracy.py:173-224's runs through the JAX package's
    ``osqp_ref``, for the instances of ``tags`` (the starts drawn for every
    instance in order), each with its start and interval."""
    from racing_lmpc_tpu.mpc import osqp_ref
    out = {}
    for rec, d, starts in ga._osqp_starts(INSTANCES, tags):
        z_star, su = d["z_star"], d["scale_u"]
        obj_star = 0.5 * z_star @ (d["P"] @ z_star) + d["q"] @ z_star
        runs = []
        for x0 in starts:
            for interval in ga.RHO_INTERVALS:
                res = osqp_ref.solve(d["P"], d["q"], d["A"], d["l"], d["u"], x0=x0,
                                     adaptive_rho_interval=interval)
                rel = np.abs(controls(d, res.x) - controls(d)) / su
                obj = 0.5 * res.x @ (d["P"] @ res.x) + d["q"] @ res.x
                runs.append({"x0": x0, "interval": interval,
                             "status": res.status, "iters": res.iters,
                             "polished": bool(res.polished),
                             "applied_steer_dev": rel[:2, 1].max(),
                             "steer_tail_dev": rel[:, 1].max(), "lon_dev": rel[:, 0].max(),
                             "obj_gap_rel": abs(obj - obj_star) / max(abs(obj_star), 1.0)})
        out[rec["tag"]] = runs
    return out


@pytest.fixture(scope="module")
def first_two(tmp_path_factory):
    out = tmp_path_factory.mktemp("ground")
    osqp = ga.run_osqp(ACC_DIR, out, "cpu", tags=FIRST_TWO)
    ga.run_engine(ACC_DIR, out, "cpu", tags=FIRST_TWO)
    return out, osqp


def test_osqp_runs_match_reference(first_two):
    _, osqp = first_two
    ref = reference_osqp_runs(FIRST_TWO)
    assert list(osqp) == FIRST_TWO
    ties = 0
    for tag in FIRST_TWO:
        d = next(d for rec, d in INSTANCES if rec["tag"] == tag)
        assert len(osqp[tag]["runs"]) == 9
        for k, (got, want) in enumerate(zip(osqp[tag]["runs"], ref[tag])):
            assert (got["start"], got["adaptive_rho_interval"]) == (
                ga.OSQP_STARTS[k // 3], want["interval"])
            assert (got["status"], got["iters"]) == (want["status"], want["iters"]), tag
            if got["polished"] != want["polished"]:
                assert polish_tie(d, want["x0"], want["interval"]), (tag, got, want)
                ties += 1
                continue
            for f in DEV_FIELDS:
                assert abs(got[f] - want[f]) <= 1e-9, (tag, f, got[f], want[f])
    assert ties <= 1


def gates_match(per_instance: dict, tags) -> None:
    assert list(per_instance) == list(tags)
    for tag in tags:
        got, want = per_instance[tag], ACCURACY[tag]
        for g in ("applied_steer_gate", "obj_gap_gate"):
            assert got[g] == pytest.approx(want[g], rel=1e-9), (tag, g)
        assert got["osqp_accepted_runs"] == want["osqp_accepted_runs"], tag
        assert got["instance_sha256_16"] == want["instance_sha256_16"]


def test_finalize_reproduces_gates(first_two):
    out, _ = first_two
    doc = ga.finalize(ACC_DIR, out)
    gates_match(doc["per_instance"], FIRST_TWO)
    assert json.loads((out / "ACCURACY.json").read_text()) == doc


def test_pipeline_reproduces_accuracy_json(tmp_path):
    ga.main(["--osqp", "--engine", "--finalize", "--device", "cpu", "--out", str(tmp_path)])
    doc = json.loads((tmp_path / "ACCURACY.json").read_text())
    gates_match(doc["per_instance"], list(ACCURACY))
    engine = json.loads((tmp_path / "engine_runs.json").read_text())["{}"]
    assert all(r["solved"] and np.isfinite(r["objective_gap"]) for r in engine.values())


@pytest.mark.parametrize("grid", range(len(tf.TOOLS_ENGINE_GRID)))
@pytest.mark.parametrize("tag", tf.TOOLS_ENGINE_TAGS)
def test_engine_within_reference_spread(tag, grid):
    fx = chip_smoke.load_fixture(tf.TOOLS_ENGINE_CASE)
    overrides = tf.TOOLS_ENGINE_GRID[grid]
    runs = ga.run_engine(ACC_DIR, None, "cpu", [overrides], tags=[tag])
    rec = runs[json.dumps(overrides, sort_keys=True)][tag]
    i = list(fx["tags"]).index(tag)
    assert fx["grid"][grid] == json.dumps(overrides, sort_keys=True)
    assert rec["solved"] == bool(fx["solved"][i, grid, 0])
    for f in ("applied_steer_err", "steer_tail_err", "lon_err", "objective_gap"):
        copies = fx[f][i, grid]
        limit = max(1e-6, float(copies.max() - copies.min()))
        assert abs(rec[f] - copies[0]) <= limit, (f, rec[f], copies.tolist())
    assert rec["drift"] < 1e-9 and rec["same_inf"]


def test_capture_within_reference_spread(tmp_path):
    fx = chip_smoke.load_fixture(tf.TOOLS_CAPTURE_CASE)
    points = [(name, n, (at,), dev) for name, n, at, dev in tf.TOOLS_CAPTURE_POINTS]
    man, captured = load_instances(ga.capture(tmp_path, "cpu", points))
    pinned = {rec["tag"]: (rec, d) for rec, d in INSTANCES}
    assert [rec["tag"] for rec in man["instances"]] == list(fx["tags"])
    for (rec, d), spread in zip(captured, fx["spread"]):
        prec, pd = pinned[rec["tag"]]
        assert {k: rec[k] for k in ("nvar", "nrow", "learning")} == {
            k: prec[k] for k in ("nvar", "nrow", "learning")}
        assert sorted(d) == sorted(pd)
        reading = []
        for k in "PqAlu":
            fin = np.isfinite(pd[k])
            assert np.array_equal(np.isfinite(d[k]), fin), (rec["tag"], k)
            reading.append(float(np.abs(d[k][fin] - pd[k][fin]).max()
                                 / max(1.0, np.abs(pd[k][fin]).max())))
        reading.append(float((np.abs(controls(d) - controls(pd))
                              / pd["scale_u"]).max()))
        assert all(r <= max(s, 1e-12) for r, s in zip(reading, spread)), (
            rec["tag"], reading, spread.tolist())


def test_refuses_reference_records(tmp_path):
    for out in (ROOT, ROOT / "scripts", ROOT / "tests" / "data" / "acc_instances",
                ROOT / "racing_lmpc_tpu"):
        with pytest.raises(ValueError, match="reference"):
            ga.main(["--finalize", "--device", "cpu", "--out", str(out)])
    with pytest.raises(ValueError, match="reference"):
        ga.capture(ROOT / "tests" / "data", "cpu")
    assert ga.OUT_DIR == ROOT / "build" / "ground_accuracy"
