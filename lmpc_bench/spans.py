"""The traced run's device idle time put down to the program's spans.

The port records the phases of its solve path as spans
(``racing_lmpc_torch.spans``) while a profiler session is active, on the
clock of the profiler's device records.  This module takes them from the
port's loaded module (it imports nothing of the port) once a run, keeps the
spans of the last ``ctx.steps`` solves (the session that was read; a
dropped session's spans come before them) and rebuilds the session's
bounds: it ends at its last device record (the last step's output copy;
the host's final ``synchronize`` follows within microseconds) and lasts
``ctx.window_s``, the wall that ``device_idle_share`` divides by.

Over ``[t0, t1]`` the device is idle where no operation ran: the session
minus the union of its busy intervals (``trace.DeviceTrace.merged()``).
Each idle instant goes to the innermost span open on the host at that
instant.  The time from the session's start to the first solve (the
profiler's start, the first step's inputs) is a span of its own,
``session.start``; an instant under no span goes to ``outside`` (each
step's outputs copied to the host and the next step's inputs).  The parts
add up to ``device_idle_share``.  The table of the split goes to standard
error when it is first made.

A run of a port that records no span gives no split, and the readers of
the span metrics then report nothing.
"""

from __future__ import annotations

import sys
from types import SimpleNamespace

PORT = "racing_lmpc_torch.spans"
OUTSIDE = "outside"
START = "session.start"


def owners(spans, t0: int, t1: int) -> list:
    """``[(start, end, index)]`` covering ``[t0, t1]`` in order: ``index``
    the innermost span open there (spans nest), -1 under none."""
    events = []
    for i, s in enumerate(spans):
        a, b = max(s.t0_ns, t0), min(s.t1_ns, t1)
        if a < b:
            events += [(a, 1, i), (b, 0, i)]
    events.sort()            # at one instant ends first, starts outer first
    out, stack, at = [], [], t0
    for t, opens, i in events:
        if t > at:
            out.append((at, t, stack[-1] if stack else -1))
            at = t
        if opens:
            stack.append(i)
        else:
            stack.remove(i)
    if at < t1:
        out.append((at, t1, -1))
    return out


def idle_intervals(busy, t0: int, t1: int) -> list:
    """``[t0, t1]`` minus the merged, ordered busy intervals
    ``[(start, end, ...)]``."""
    out, at = [], t0
    for s, e, *_ in busy:
        if s > at:
            out.append((at, min(s, t1)))
        at = max(at, e)
        if at >= t1:
            break
    if at < t1:
        out.append((at, t1))
    return [(a, b) for a, b in out if a < b]


def idle_by_index(spans, busy, t0: int, t1: int) -> dict:
    """Idle ns a span index (-1: outside every span)."""
    segs, idle = owners(spans, t0, t1), idle_intervals(busy, t0, t1)
    got: dict = {}
    i = j = 0
    while i < len(segs) and j < len(idle):
        a, b, who = segs[i]
        c, d = idle[j]
        lo, hi = max(a, c), min(b, d)
        if lo < hi:
            got[who] = got.get(who, 0) + hi - lo
        if b <= d:
            i += 1
        else:
            j += 1
    return got


class Split:
    """A session's idle time by span: ``share(pred)`` is the idle time of
    the spans whose index passes ``pred`` over the session's wall."""

    def __init__(self, spans, busy, t0: int, t1: int):
        self.spans, self.wall = spans, t1 - t0
        self.idle = idle_by_index(spans, busy, t0, t1)

    def path(self, i: int) -> list:
        """The names from span ``i`` out to its root."""
        names = []
        while i >= 0:
            names.append(self.spans[i].name)
            i = self.spans[i].parent
        return names

    def share(self, pred) -> float:
        return sum(ns for i, ns in self.idle.items() if pred(i)) / self.wall

    def under(self, name: str) -> float:
        """Idle share under span ``name`` and its children."""
        return self.share(lambda i: i >= 0 and name in self.path(i))

    def own(self, name: str) -> float:
        """Idle share in span ``name``'s own time, outside its children."""
        return self.share(lambda i: i >= 0 and self.spans[i].name == name)

    def outside(self) -> float:
        return self.share(lambda i: i < 0)

    def table(self, steps: int) -> list[str]:
        """Lines of the idle time by host phase: each span name's count a
        step, host ms a step (whole spans), idle ms a step in its own time
        and that idle's share of the wall."""
        rows: dict = {}
        for i, s in enumerate(self.spans):
            r = rows.setdefault(s.name, [0, 0, 0])
            r[0] += 1
            r[1] += s.t1_ns - s.t0_ns
            r[2] += self.idle.get(i, 0)
        rows[OUTSIDE] = [0, 0, self.idle.get(-1, 0)]
        lines = [f"{'phase':<18}{'a step':>8}{'host ms':>12}{'idle ms':>12}{'idle share':>12}"]
        for name, (n, host, idle) in sorted(rows.items(), key=lambda r: -r[1][2]):
            lines.append(f"{name:<18}{n / steps:>8g}{host / 1e6 / steps:>12.3f}"
                         f"{idle / 1e6 / steps:>12.3f}{idle / self.wall:>12.5f}")
        total = sum(self.idle.values())
        lines.append(f"{'all':<18}{'':>8}{'':>12}{total / 1e6 / steps:>12.3f}"
                     f"{total / self.wall:>12.5f}")
        return lines


def session(ctx):
    """The traced session's spans (the last ``ctx.steps`` solves, parents
    re-indexed) with their bounds ``t0``, ``t1`` in ns, taken from the port
    once a run; None without a device trace or without spans."""
    if not hasattr(ctx, "_spans"):
        port = sys.modules.get(PORT)
        ctx._spans = port.take_spans() if port is not None else []
    got = ctx._spans
    roots = [i for i, s in enumerate(got) if s.parent < 0]
    if ctx.trace is None or len(roots) < ctx.steps:
        return None
    first = roots[-ctx.steps]
    spans = [s._replace(parent=s.parent - first if s.parent >= 0 else -1)
             for s in got[first:]]
    busy = ctx.trace.merged()
    t1 = max([spans[-1].t1_ns] + [e for _, e, *_ in busy[-1:]])
    return SimpleNamespace(spans=spans, t0=t1 - round(ctx.window_s * 1e9), t1=t1)


def split(ctx) -> Split | None:
    """The traced session's split (made once a run, its table printed), or
    None without a device trace or without spans."""
    if getattr(ctx, "_split", None) is None:
        s = session(ctx)
        if s is None:
            return None
        start = SimpleNamespace(name=START, t0_ns=s.t0, t1_ns=s.spans[0].t0_ns, parent=-1)
        ctx._split = Split(s.spans + [start], ctx.trace.merged(), s.t0, s.t1)
        print("lmpc_bench: device idle by host phase, a step (spans.py)", file=sys.stderr)
        for line in ctx._split.table(ctx.steps):
            print(f"  {line}", file=sys.stderr)
    return ctx._split
