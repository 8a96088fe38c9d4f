"""Cycle profiling, diagnostics and logging.

Port of ``racing_lmpc_tpu/control/telemetry.py:21-101`` (plain Python,
copied): ``CycleProfiler`` is the thread-safe circular window of per-cycle
measurements of ``lmpc_utils/cycle_profiler.hpp:33-136`` with its
min/mean/max ``Profile`` and diagnostic status; ``Logger`` is the
callback-registry logger of ``lmpc_utils/logging.hpp:42-96``, the EKF's
warning sink.  The reference's ``XprofTrace`` wraps ``jax.profiler`` and has
no counterpart here.
"""

from __future__ import annotations

import enum
import threading
from collections import deque
from dataclasses import dataclass
from typing import Callable


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
