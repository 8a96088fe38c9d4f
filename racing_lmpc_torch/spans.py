"""The program's spans and its count of host-device synchronizations.

``span(name, **attrs)`` marks one phase of the solve path
(``RacingMPC.solve_batch`` down to the IPM's Newton iterations) on the
clock of ``torch.profiler``'s records, so a device trace's idle time can be
put down to the host phase that held it.  Spans record while a
``torch.profiler`` session is active, or while ``set_spans(True)`` holds;
otherwise ``span`` returns one shared no-op object and costs a flag test
and the profiler's own enabled test.  ``take_spans`` hands out and clears
what was recorded; records are kept until then, as the profiler keeps its
own.  ``host_syncs`` counts the solve path's deliberate host-device
synchronizations at their sites, always, whatever the device; each site
also sits in a span named ``*_sync``.  One thread records at a time.

This module imports nothing of the package, so every layer can import it.
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from typing import NamedTuple

from torch._C._autograd import _profiler_enabled


class SpanRecord(NamedTuple):
    """One recorded span: start and end in integer ns on the profiler's
    clock, the index of the span that was open around it (-1: none),
    ``step``, the call number of the outermost span around it (on the solve
    path, the ``RacingMPC.solve_batch`` call it belongs to), and ``syncs``,
    the host syncs counted while it was open."""
    name: str
    t0_ns: int
    t1_ns: int
    parent: int
    step: int
    attrs: dict
    syncs: int


_OFF = nullcontext()
_spans_on = False
_records: list = []      # [name, t0_ns, t1_ns, parent, step, attrs, syncs]
_open: list = []         # indices of the spans open now, innermost last
_roots = 0
host_syncs = 0


class _Span:
    __slots__ = ("name", "attrs", "i")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        global _roots
        parent = _open[-1] if _open else -1
        if parent < 0:
            _roots += 1
        step = _records[parent][4] if parent >= 0 else _roots
        self.i = len(_records)
        # the clock of torch.profiler's kineto records (``start_ns()``):
        # Unix-epoch ns, for CPU records and, through CUPTI, device records
        _records.append([self.name, time.time_ns(), 0, parent, step, self.attrs, host_syncs])
        _open.append(self.i)
        return self

    def __exit__(self, *exc):
        r = _records[self.i]
        r[2], r[6] = time.time_ns(), host_syncs - r[6]
        _open.pop()
        return False


def span(name: str, **attrs):
    """A context manager marking one phase.  Off, it is one shared no-op
    object: nothing is stamped, recorded or synchronized."""
    if not (_spans_on or _profiler_enabled()):
        return _OFF
    return _Span(name, attrs)


def set_spans(on: bool) -> bool:
    """Record spans with no profiler session too (``on``), or only under
    one; returns the previous setting."""
    global _spans_on
    was, _spans_on = _spans_on, bool(on)
    return was


def take_spans() -> list[SpanRecord]:
    """The spans recorded since the last call, in the order they opened,
    and forget them.  Call it between solves, with no span open."""
    out = [SpanRecord(*r) for r in _records]
    _records.clear()
    _open.clear()
    return out


def count_sync():
    """Count one host-device synchronization of the solve path."""
    global host_syncs
    host_syncs += 1
