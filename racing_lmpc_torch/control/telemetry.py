"""Cycle profiling, diagnostics and logging.

Port of ``racing_lmpc_tpu/control/telemetry.py:21-101`` (plain Python,
copied): ``CycleProfiler`` is the thread-safe circular window of per-cycle
measurements of ``lmpc_utils/cycle_profiler.hpp:33-136`` with its
min/mean/max ``Profile`` and diagnostic status; ``Logger`` is the
callback-registry logger of ``lmpc_utils/logging.hpp:42-96``, the EKF's
warning sink.  ``ProfilerTrace`` is the counterpart of the reference's
``XprofTrace`` (``:104-128``) on ``torch.profiler``.
"""

from __future__ import annotations

import enum
import json
import os
import threading
import time
from collections import deque
from pathlib import Path
from dataclasses import dataclass
from typing import Callable

from racing_lmpc_torch.spans import take_spans


class LogLevel(enum.IntEnum):
    DEBUG = 10
    INFO = 20
    WARN = 30
    ERROR = 40
    FATAL = 50


class Logger:
    """Callback-registry logger (Logger, logging.hpp:42-96)."""

    def __init__(self):
        self._callbacks: list[Callable[[LogLevel, str], None]] = []

    def register_callback(self, cb: Callable[[LogLevel, str], None]):
        self._callbacks.append(cb)

    def send_log(self, level: LogLevel, message: str):
        for cb in self._callbacks:
            cb(level, message)

    @staticmethod
    def print_sink(min_level: LogLevel = LogLevel.INFO):
        def sink(level: LogLevel, message: str):
            if level >= min_level:
                print(f"[{level.name}] {message}")
        return sink


@dataclass
class Profile:
    """Windowed stats (Profile<T>, cycle_profiler.hpp:33-67)."""
    min: float = 0.0
    max: float = 0.0
    mean: float = 0.0

    def to_diagnostic_status(self, name: str, unit: str,
                             warn_threshold: float) -> dict:
        """Diagnostic dict mirroring Profile::to_diagnostic_status: WARN when
        the window max exceeds the threshold (e.g. solve time > dt)."""
        level = "WARN" if self.max > warn_threshold else "OK"
        return {
            "name": name,
            "level": level,
            "message": f"{name}: min {self.min:.4g}, mean {self.mean:.4g}, "
                       f"max {self.max:.4g} {unit} (warn > {warn_threshold:.4g})",
            "values": {"min": self.min, "mean": self.mean, "max": self.max,
                       "warn_threshold": warn_threshold},
        }


class CycleProfiler:
    """Thread-safe circular window of per-cycle measurements
    (CycleProfiler<T>, cycle_profiler.hpp:69-136)."""

    def __init__(self, capacity: int = 40):
        self._buf: deque[float] = deque(maxlen=capacity)
        self._lock = threading.Lock()

    @property
    def capacity(self) -> int:
        return self._buf.maxlen

    def set_capacity(self, capacity: int):
        with self._lock:
            self._buf = deque(self._buf, maxlen=capacity)

    def add_cycle_stats(self, value: float):
        with self._lock:
            self._buf.append(float(value))

    def profile(self) -> Profile:
        with self._lock:
            if not self._buf:
                return Profile()
            vals = list(self._buf)
        return Profile(min=min(vals), max=max(vals),
                       mean=sum(vals) / len(vals))

    def __len__(self):
        return len(self._buf)


class ProfilerTrace:
    """Context manager capturing a host and device trace with
    ``torch.profiler`` — the counterpart of the reference's ``XprofTrace``
    (``racing_lmpc_tpu/control/telemetry.py:104-128``), the tracing side of
    the reference's DiagnosticArray profiling: wall-clock windows come from
    CycleProfiler, per-op breakdowns from these traces.

        with ProfilerTrace("/tmp/trace") as tr:
            solve(...)   # traced
        tr.path          # the Chrome trace written on exit

    Records CUDA activity where a CUDA device is present (the CPU ops of a
    solve's ~40k launches would make the profiler take most of the run),
    else CPU activity; the program's spans (``racing_lmpc_torch.spans``),
    which record under the profiler, are written as complete events on
    their own "program" track, on the kernels' clock.  Writes
    ``<log_dir>/trace_<pid>_<ns>.json`` in the Chrome trace format
    (chrome://tracing, Perfetto).  ``profiler`` holds the finished
    ``torch.profiler.profile`` for ``key_averages()``.
    """

    def __init__(self, log_dir: str | os.PathLike):
        self.log_dir = Path(log_dir)
        self.path: Path | None = None
        self.profiler = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                else [ProfilerActivity.CPU])
        self.profiler = profile(activities=acts)
        take_spans()                    # none from before the session
        self.profiler.__enter__()
        return self

    def __exit__(self, *exc):
        self.profiler.__exit__(*exc)
        spans = take_spans()
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.log_dir / f"trace_{os.getpid()}_{time.time_ns()}.json"
        self.profiler.export_chrome_trace(str(self.path))
        trace = json.loads(self.path.read_text())
        base = trace.get("baseTimeNanoseconds", 0)   # "ts" counts us from it
        pid = os.getpid()
        events = trace.setdefault("traceEvents", [])
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
                       "args": {"name": "program"}})
        events.extend({"ph": "X", "cat": "program", "name": s.name, "pid": pid, "tid": 0,
                       "ts": (s.t0_ns - base) / 1e3, "dur": (s.t1_ns - s.t0_ns) / 1e3,
                       "args": {"step": s.step, **s.attrs}} for s in spans)
        self.path.write_text(json.dumps(trace))
        return False
