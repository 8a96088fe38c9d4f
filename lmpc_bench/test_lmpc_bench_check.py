"""CPU tests of the correctness check: the plain reference against the
port and against the port's own float64 oracle, the check failing a run
whose timed path is broken underneath, and the control's readings.

    python -m pytest lmpc_bench -q          (the card's cases: -m cuda)
"""

from __future__ import annotations

import contextlib
import io
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lmpc_bench import calibrate, run, system
from lmpc_bench.reference import qp as rq
from lmpc_bench.scenarios import ScenarioMaker

ROOT = Path(__file__).resolve().parents[1]
BARC = json.loads((ROOT / "lmpc_bench" / "configs" / "barc_lmpc.json").read_text())
PER_LANE = ("x_ic", "u_ic", "T", "bl", "br", "ss_x", "ss_j")
CHECKED = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def lanes(cfg, B, seed=424242424242):
    return ScenarioMaker(cfg).batch(np.random.default_rng(seed), B)


def test_reference_optimum_is_the_port_oracles():
    """The reference's optimal cost is the one of the port's float64 oracle
    (``mpc/reference_qp.py``, the upstream QP over the sparse variables),
    lane by lane, and pricing a plan of the reference's optimum gives it
    again."""
    from racing_lmpc_torch.mpc import reference_qp as oracle
    inp = lanes(BARC, 3)
    qp = rq.build(BARC, rq.load_model(BARC), inp, "cpu")
    w, ok = rq.solve(qp)
    best = qp.objective(w)
    assert bool(ok.all())
    cost, defect = rq.plan_cost(qp, *qp.plan(w))
    assert torch.allclose(cost, best, rtol=1e-7, atol=1e-7)
    assert float(defect.max()) < 1e-10
    mpc = system.build_mpc(BARC, "cpu")
    for b in range(3):
        one = SimpleNamespace(**{k: torch.as_tensor(v[b]) for k, v in inp.items()})
        oq = oracle.build_reference_qp(mpc.model, mpc.config, one, device="cpu")
        z, _ = oracle.solve_dense_qp_f64(oq)
        K = oq.layout.K
        lam = z[oq.layout.lam_off:oq.layout.lam_off + K][None]
        sub = SimpleNamespace(dyn=tuple(a[b:b + 1] for a in qp.dyn), layout=qp.layout,
                              data={k: (v[b:b + 1] if k in PER_LANE else v)
                                    for k, v in qp.data.items()})
        c, d = rq.plan_cost(sub, oq.states(z)[None], oq.controls(z)[None], lam)
        assert float(c[0]) == pytest.approx(float(best[b]), rel=1e-6, abs=1e-6)
        assert float(d[0]) < 1e-9


def test_port_plans_agree_with_the_reference():
    """The port's CPU plans of BARC lanes lie within the sweep cell's limits
    of the reference's optimum and of the QP's rows."""
    limits = run.load_cell(CHECKED[0])["limits"]
    inp = lanes(BARC, 3)
    mpc = system.build_mpc(BARC, "cpu")
    out = system.host_outputs(system.solve(mpc, system.to_input(
        {k: torch.as_tensor(v) for k, v in inp.items()})))
    qp = rq.build(BARC, rq.load_model(BARC), inp, "cpu")
    w, ok = rq.solve(qp)
    f64 = lambda k: torch.as_tensor(out[k], dtype=torch.float64)  # noqa: E731
    cost, defect = rq.plan_cost(qp, f64("X_optm"), f64("U_optm"), f64("convex_combi"))
    best = qp.objective(w)
    gap = (cost - best).abs() / best.abs().clamp(min=1)
    assert bool(out["solved"].all()) and bool(ok.all())
    assert float(gap.max()) < limits["cost_gap_p90"]["limit"]
    assert float(defect.max()) < limits["defect_max"]["limit"]


def broken(kind: str):
    """``system.solve`` with its answers broken where they are produced."""
    solve = system.solve

    def wrapped(mpc, inp):
        out = solve(mpc, inp)
        if kind == "unchanged":
            # the step returns the state it was given: the plan stays at the
            # initial state with no control
            X = inp.x_ic[:, None].expand_as(out.X_optm).clone()
            return out._replace(X_optm=X, U_optm=torch.zeros_like(out.U_optm))
        if kind == "half":
            # half of the batch left out: its lanes keep the first lane's answer
            h = out.U_optm.shape[0] // 2
            rep = {k: getattr(out, k).clone() for k in ("U_optm", "X_optm", "convex_combi")}
            for t in rep.values():
                t[h:] = t[:1]
            return out._replace(**rep)
        if kind == "altered":
            # an answer altered where it is produced: lane b gets lane b+1's plan
            return out._replace(**{k: torch.roll(getattr(out, k), 1, 0)
                                   for k in ("U_optm", "X_optm", "convex_combi")})
        return out
    return wrapped


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CHECKED)
def test_a_broken_timed_path_is_not_correct(cell, kind, monkeypatch):
    monkeypatch.setattr(system, "solve", broken(kind))
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", "77", "--seconds", "0.01"],
                      device="cpu", batch=2)
    assert rc == 0, err.getvalue()
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"] is False, res["check"]


def test_calibration_reads_program_and_control():
    """The control's path runs (on the CPU only its float32 normal
    equations differ; TF32 exists only on the card) and both print their
    readings."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = calibrate.main(["--workload", CHECKED[0], "--seeds", "11", "--control-seeds", "12",
                             "--steps", "1"], device="cpu", batch=2)
    assert rc == 0
    rows = [json.loads(x) for x in out.getvalue().strip().splitlines()]
    assert [r["label"] for r in rows] == ["program", "control"]
    assert all(r["judged"] == 2 and r["uncertified"] == 0 for r in rows)
    from racing_lmpc_torch.mpc import ipm
    assert ipm.NORMAL_EQ_DTYPE == torch.float64


@pytest.mark.cuda
def test_control_fails_on_the_card():
    """On the card, at the cell's batch, the control (TF32 products, A'DA in
    float32) fails a limit that the port as configured meets."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = run.load_cell(CHECKED[0])
    limits = cell["limits"]
    mpc = system.build_mpc(cell["config"], torch.device("cuda", 0))
    steps = int(cell["mix"]["pool"])
    sound = calibrate.readings_of(cell, mpc, 31, steps, torch.device("cuda", 0))
    system.lower_precision(True)
    try:
        control = calibrate.readings_of(cell, mpc, 32, steps, torch.device("cuda", 0))
    finally:
        system.lower_precision(False)
    assert all(sound[k] <= v["limit"] for k, v in limits.items()), sound
    assert any(control[k] > v["limit"] for k, v in limits.items()), control
