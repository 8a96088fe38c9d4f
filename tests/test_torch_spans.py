"""The port's program spans and host-sync counter
(``racing_lmpc_torch.spans``), on the CPU.

- one ``RacingMPC.solve_batch`` of the shipped BARC LMPC (N = 40, 96
  safe-set points, 14 Newton iterations a pass, 4 zoom rounds) at 2 lanes
  records the span tree of its phases, one step id, and 14 host syncs
  (the zoom ladder's 4, the row structure's 4 index uploads, 6 equality
  masks), each site in a ``*_sync`` span;
- with spans off nothing is recorded, and the outputs are bit-identical
  with spans on and off;
- ``ProfilerTrace`` writes the spans into its Chrome trace on the clock of
  the profiler's records;
- the recorder: spans record under a profiler session with the switch
  off, nest with their parents, step ids and the syncs counted inside
  them, close on an exception, and are handed out once.

The benchmark's split of device idle time over the spans is tested in
``lmpc_bench/test_lmpc_bench_spans.py``.
"""

from __future__ import annotations

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from racing_lmpc_torch import spans as tm

torch.set_num_threads(1)

OUTPUTS = ("X_optm", "U_optm", "dU_optm", "convex_combi", "boundary_slack",
           "r_prim", "r_dual", "obj", "solved", "rp_rel", "rd_rel")


@pytest.fixture(scope="module")
def solves():
    """The same 2-lane batch solved with spans off, then on."""
    from racing_lmpc_torch.benchmarks import build_barc_lmpc, make_scenario_batch
    _, track, cfg, mpc, manager = build_barc_lmpc(40, 96, 32, device="cpu")
    inp = make_scenario_batch(mpc, track, manager, 2, seed=11, device="cpu")
    tm.set_spans(False)
    tm.take_spans()
    runs = {}
    for on in (False, True):
        s0 = tm.host_syncs
        was = tm.set_spans(on)
        try:
            out, z = mpc.solve_batch(inp)
        finally:
            tm.set_spans(was)
        runs[on] = SimpleNamespace(out=out, z=z, spans=tm.take_spans(),
                                   syncs=tm.host_syncs - s0)
    return cfg, runs


def test_solve_batch_span_tree(solves):
    cfg, runs = solves
    assert (cfg.n, cfg.num_ss_pts, cfg.qp_ip_iters, cfg.qp_zoom_rounds) == (40, 96, 14, 4)
    sp = runs[True].spans
    names = [s.name for s in sp]

    def kids(i, name=None):
        return [j for j, s in enumerate(sp) if s.parent == i and name in (None, s.name)]

    def one(name):
        idx = [i for i, s in enumerate(sp) if s.name == name]
        assert len(idx) == 1, (name, names)
        return idx[0]

    root = one("mpc.solve_batch")
    assert sp[root].parent == -1 and [s.parent for s in sp].count(-1) == 1
    assert len({s.step for s in sp}) == 1
    build, solve = one("mpc.build_qp"), one("ipm.solve")
    assert sp[build].parent == root and sp[solve].parent == root
    assert sp[one("mpc.condense")].parent == build
    assert sp[one("mpc.linearize")].parent == one("mpc.condense")   # the dynamics' Jacobians
    assert sp[one("ipm.ruiz")].parent == solve
    assert sp[one("ipm.unscale")].parent == solve
    assert sp[one("mpc.extract")].parent == root
    passes = [i for i, s in enumerate(sp) if s.name == "ipm.pass"]
    assert [sp[i].attrs["round"] for i in passes] == [0, 1, 2, 3, 4]
    assert sp[passes[0]].parent == solve
    rounds = kids(solve, "ipm.zoom_round")
    assert [sp[i].attrs["round"] for i in rounds] == [1, 2, 3, 4]
    for r, p in zip(rounds, passes[1:]):
        assert kids(r) == [p]
    for p in passes:
        assert len(kids(p, "ipm.iter")) == 14 and len(kids(p, "ipm.polish")) == 1
        assert len(kids(p, "ipm.eq_mask_sync")) == 1 and len(kids(p)) == 16
    assert names.count("ipm.iter") == 70
    assert len(kids(solve, "ipm.zoom_sync")) == names.count("ipm.zoom_sync") == 4
    assert sp[one("ipm.rows_sync")].parent == sp[one("ipm.zoom_mask_sync")].parent == solve
    for s in sp:                      # each span closed, inside its parent
        assert s.t0_ns <= s.t1_ns
        if s.parent >= 0:
            assert sp[s.parent].t0_ns <= s.t0_ns and s.t1_ns <= sp[s.parent].t1_ns
    assert runs[True].syncs == 4 + 4 + 5 + 1
    assert sp[root].syncs == runs[True].syncs and sp[solve].syncs == 14
    assert {s.name: s.syncs for s in sp if s.name.endswith("_sync")} == {
        "ipm.rows_sync": 4, "ipm.eq_mask_sync": 1, "ipm.zoom_mask_sync": 1, "ipm.zoom_sync": 1}


def test_spans_off_record_nothing_and_change_no_bit(solves):
    _, runs = solves
    off, on = runs[False], runs[True]
    assert off.spans == [] and tm.span("x") is tm.span("y")
    assert off.syncs == on.syncs == 14          # the counter is always on
    for k in OUTPUTS:
        a, b = getattr(off.out, k), getattr(on.out, k)
        assert a.dtype == b.dtype and np.array_equal(a.numpy(), b.numpy(), equal_nan=True), k
    assert torch.equal(off.z, on.z)


def test_profiler_trace_writes_the_spans(tmp_path):
    from racing_lmpc_torch.control.telemetry import ProfilerTrace
    assert not tm.set_spans(False)
    with ProfilerTrace(tmp_path / "trace") as tr:
        with tm.span("test.outer", round=2):
            with tm.span("test.inner"):
                torch.ones(64).cumsum(0).sum()
    assert not tm.set_spans(False) and tm.take_spans() == []
    events = json.loads(tr.path.read_text())["traceEvents"]
    program = {e["name"]: e for e in events if e.get("cat") == "program"}
    assert set(program) == {"test.outer", "test.inner"}
    outer, inner = program["test.outer"], program["test.inner"]
    assert outer["ph"] == "X" and outer["args"] == {"step": outer["args"]["step"], "round": 2}
    assert outer["tid"] == inner["tid"] and any(
        e.get("ph") == "M" and e.get("tid") == outer["tid"] and e["args"].get("name") == "program"
        for e in events)
    op = next(e for e in events if "cumsum" in e.get("name", "") and e.get("ph") == "X")
    # the spans and the profiler's records share one clock
    assert outer["ts"] <= inner["ts"] <= op["ts"]
    assert op["ts"] + op["dur"] <= inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_spans_record_under_a_profiler_session():
    from torch.profiler import ProfilerActivity, profile
    assert not tm.set_spans(False)
    tm.take_spans()
    assert tm.span("before") is tm.span("after")          # the no-op
    with profile(activities=[ProfilerActivity.CPU]):
        with tm.span("traced", k=1):
            torch.ones(8).sum()
    with tm.span("after"):
        pass
    (s,) = tm.take_spans()
    assert (s.name, s.parent, s.attrs) == ("traced", -1, {"k": 1}) and s.t0_ns < s.t1_ns


def test_spans_nest_with_parents_steps_and_syncs():
    tm.take_spans()
    was = tm.set_spans(True)
    try:
        for _ in range(2):
            with tm.span("root"):
                with tm.span("a", round=0):
                    tm.count_sync()
                    with tm.span("a.b"):
                        tm.count_sync()
                with tm.span("c"):
                    pass
    finally:
        tm.set_spans(was)
    sp = tm.take_spans()
    assert [(s.name, s.parent) for s in sp] == [
        ("root", -1), ("a", 0), ("a.b", 1), ("c", 0),
        ("root", -1), ("a", 4), ("a.b", 5), ("c", 4)]
    assert [s.syncs for s in sp] == [2, 2, 1, 0] * 2
    assert [s.step for s in sp] == [sp[0].step] * 4 + [sp[0].step + 1] * 4
    assert sp[1].attrs == {"round": 0} and sp[0].attrs == {}
    assert tm.take_spans() == []


def test_span_closes_on_an_exception():
    tm.take_spans()
    was = tm.set_spans(True)
    try:
        with pytest.raises(ValueError):
            with tm.span("outer"):
                with tm.span("inner"):
                    raise ValueError
        with tm.span("next"):
            pass
    finally:
        tm.set_spans(was)
    outer, inner, nxt = tm.take_spans()
    assert inner.parent == 0 and 0 < inner.t1_ns <= outer.t1_ns
    assert nxt.parent == -1 and nxt.step == outer.step + 1


def test_syncs_are_counted_with_spans_off():
    assert not tm.set_spans(False)
    s0 = tm.host_syncs
    with tm.span("off"):
        tm.count_sync()
    assert tm.host_syncs == s0 + 1 and tm.take_spans() == []
