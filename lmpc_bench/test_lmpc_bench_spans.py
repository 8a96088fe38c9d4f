"""CPU tests of the traced run's split of device idle time over the port's
spans (``spans.py``) and of the span metrics' readers, on synthetic spans
and busy intervals:

- the innermost span wins, time under no span goes to ``outside``, and the
  parts add up to ``1 - busy / wall``;
- the session is the last ``steps`` solves, its bounds end at the last
  device record and span ``window_s``, the time before the first solve is
  ``session.start`` and not ``outside``, and the parts add up to
  ``device_idle_share``;
- a port that records no span (or is not loaded) gives no reading.

    python -m pytest lmpc_bench/test_lmpc_bench_spans.py -q
"""

from __future__ import annotations

import sys
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import NamedTuple

import numpy as np
import pytest

from lmpc_bench import run, spans as idle_split
from lmpc_bench.trace import DeviceTrace

HERE = Path(__file__).resolve().parent
SPAN_METRICS = ("host_syncs_per_step", "ipm_iter_ms", "qp_build_idle_share",
                "zoom_ladder_idle_share", "outside_solve_idle_share")


class Rec(NamedTuple):
    """The port's span record (``racing_lmpc_torch.spans.SpanRecord``)."""
    name: str
    t0_ns: int
    t1_ns: int
    parent: int
    step: int = 1
    attrs: dict = {}
    syncs: int = 0


def test_idle_split_innermost_span_wins():
    # session [0, 100); busy [10, 20) and [50, 95); idle 0-10, 20-50, 95-100
    sp = [Rec("a", 5, 60, -1), Rec("b", 15, 40, 0), Rec("c", 30, 35, 1),
          Rec("d", 70, 98, -1)]
    busy = [[10, 20, "k"], [50, 95, "k"]]
    got = idle_split.idle_by_index(sp, busy, 0, 100)
    assert got == {-1: 5 + 2, 0: 5 + 10, 1: 10 + 5, 2: 5, 3: 3}
    s = idle_split.Split(sp, busy, 0, 100)
    assert s.under("b") == pytest.approx(0.20) and s.own("b") == pytest.approx(0.15)
    assert s.under("a") == pytest.approx(0.35) and s.outside() == pytest.approx(0.07)
    assert sum(got.values()) == 100 - 10 - 45
    assert [line.split()[0] for line in s.table(1)[1:]] == ["a", "b", "outside", "c", "d", "all"]


@pytest.mark.parametrize("seed", range(6))
def test_idle_split_adds_up_on_random_sessions(seed):
    """Random nested spans and busy intervals on a grid of 1 ns: each idle
    ns is owned by the innermost span around it, and the parts add up to
    1 - busy / wall."""
    rng = np.random.default_rng(seed)
    t0, t1 = int(rng.integers(0, 50)), 400
    sp = []

    def nest(a, b, parent, depth):
        at = a
        while depth < 4 and at < b - 2:
            s = int(rng.integers(at, b - 1))
            e = int(rng.integers(s + 1, min(b, s + 120) + 1))
            sp.append(Rec(f"s{depth}", s, e, parent))
            nest(s, e, len(sp) - 1, depth + 1)
            at = e + int(rng.integers(0, 30))
    nest(-20, 430, -1, 0)
    cuts = np.sort(rng.choice(np.arange(-10, 420), size=40, replace=False))
    busy = [[int(a), int(b), "k"] for a, b in zip(cuts[::2], cuts[1::2])]
    got = idle_split.idle_by_index(sp, busy, t0, t1)
    want: dict = {}
    for t in range(t0, t1):
        if any(a <= t < b for a, b, _ in busy):
            continue
        inner = [i for i, s in enumerate(sp) if s.t0_ns <= t < s.t1_ns]
        who = max(inner, key=lambda i: (sp[i].t0_ns, i)) if inner else -1
        want[who] = want.get(who, 0) + 1
    assert got == want
    busy_in = sum(max(0, min(b, t1) - max(a, t0)) for a, b, _ in busy)
    s = idle_split.Split(sp, busy, t0, t1)
    parts = s.outside() + sum(s.own(n) for n in {x.name for x in sp})
    assert parts == pytest.approx(1 - busy_in / (t1 - t0), abs=1e-12)


def _solve(at: int, step: int) -> list:
    """One solve's spans from ``at`` (ns), as the port records them."""
    return [Rec("mpc.solve_batch", at + 10, at + 100, -1, step, syncs=3),
            Rec("mpc.build_qp", at + 10, at + 40, 0, step),
            Rec("mpc.condense", at + 20, at + 30, 1, step),
            Rec("ipm.solve", at + 40, at + 95, 0, step, syncs=3),
            Rec("ipm.iter", at + 40, at + 50, 3, step),
            Rec("ipm.iter", at + 50, at + 70, 3, step),
            Rec("ipm.zoom_sync", at + 70, at + 72, 3, step, syncs=1),
            Rec("ipm.zoom_round", at + 72, at + 95, 3, step, {"round": 1}, 2),
            Rec("ipm.pass", at + 80, at + 95, 7, step, {"round": 1})]


@pytest.fixture
def traced(monkeypatch):
    """A traced run's ctx: a dropped session's solve, then the read
    session's 2 solves (from 1,000 and 1,200 ns, window 1,000 ns), with the
    device, as the read session recorded it, busy in each solve's
    iterations and its zoom pass and in each step's output copy."""
    recs = _solve(0, 1)
    for k, at in enumerate((1000, 1200)):
        base = len(recs)
        recs += [r._replace(parent=r.parent + base if r.parent >= 0 else -1)
                 for r in _solve(at, k + 2)]
    port = ModuleType(idle_split.PORT)
    port.take_spans = lambda: list(recs)
    monkeypatch.setitem(sys.modules, idle_split.PORT, port)
    tr = DeviceTrace()
    for at in (1000, 1200):
        tr.intervals += [(at + 42, at + 68, "k"), (at + 82, at + 95, "k"),
                         (at + 150, at + 160, "Memcpy DtoH")]
    return SimpleNamespace(trace=tr, steps=2, window_s=1000e-9)


def read(name: str, ctx):
    return run.reader(HERE, name)(ctx)


def test_session_is_the_last_steps_with_the_bounds_of_the_window(traced, capsys):
    s = idle_split.session(traced)
    assert [x.step for x in s.spans] == [2] * 9 + [3] * 9
    assert s.spans[9].parent == -1 and s.spans[10].parent == 9 and s.spans[17].parent == 16
    assert (s.t0, s.t1) == (1360 - 1000, 1360)      # the last copy ends the session
    sp = idle_split.split(traced)
    assert sp.spans[-1].name == idle_split.START and sp.spans[-1].t1_ns == 1010
    assert "device idle by host phase" in capsys.readouterr().err
    assert idle_split.split(traced) is sp            # made once
    # the parts, session.start among them, add up to device_idle_share
    parts = sp.outside() + sum(sp.own(n) for n in {x.name for x in sp.spans})
    assert parts == pytest.approx(read("device_idle_share", traced), abs=1e-12)
    # session.start: 360-1010; outside: 1100-1210 and 1300-1360 less the copies
    assert sp.own(idle_split.START) == pytest.approx(650 / 1000)
    assert read("outside_solve_idle_share", traced) == pytest.approx((110 - 10 + 60 - 10) / 1000)


def test_span_metrics_read_the_session(traced):
    assert read("host_syncs_per_step", traced) == 3
    assert read("ipm_iter_ms", traced) == pytest.approx(15e-6)
    # build_qp 10-40 of each solve idle throughout
    assert read("qp_build_idle_share", traced) == pytest.approx(2 * 30 / 1000)
    # zoom_sync 70-72, zoom_round's own 72-80, idle throughout
    assert read("zoom_ladder_idle_share", traced) == pytest.approx(2 * 10 / 1000)


def test_no_reading_without_the_ports_spans(traced, monkeypatch):
    monkeypatch.delitem(sys.modules, idle_split.PORT)
    assert [read(n, traced) for n in SPAN_METRICS] == [None] * 5
    ctx = SimpleNamespace(trace=None, steps=2, window_s=1.0, _spans=[Rec("a", 0, 1, -1)] * 2)
    assert [read(n, ctx) for n in SPAN_METRICS] == [None] * 5
    ctx = SimpleNamespace(trace=DeviceTrace(), steps=2, window_s=1.0, _spans=[Rec("a", 0, 1, -1)])
    assert idle_split.split(ctx) is None
