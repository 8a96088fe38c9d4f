"""Safe set for LMPC: stored laps, cost-to-go and k-nearest query.

Port of the numpy path of ``racing_lmpc_tpu/safeset/safe_set.py``
(``SafeSetManager.add_lap``/``query``/``query_padded``, ``:75-209``, and
``SafeSetRecorder``, ``:301-369``).  The reference's native C++ k-NN is
not bound here; the query is the reference's numpy fallback.  The
error-dynamics regression (``query_regression``) waits for a later slice.

Replicated semantics (safe_set.cpp): cost-to-go J = [T-1 .. 0],
abscissa-tripled states (x - L, x, x + L) with J offsets for periodic
matching across start/finish; per-lap k nearest in the (s, t) plane, newest
laps first, concatenated then truncated to the total budget; the recorder
closes a lap when the abscissa wraps (drops by more than half the track).
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple, Sequence

import numpy as np


class SSQuery(NamedTuple):
    """Mirrors ``SSQuery`` (safe_set.hpp:35-44)."""
    x: np.ndarray            # (nx,) query state (terminal reference)
    dist_max: float
    max_num_total: int
    max_num_per_lap: int


class SSResult(NamedTuple):
    x: np.ndarray            # (num, nx)
    J: np.ndarray            # (num,)


class SafeSetManager:
    """Ring buffer of stored laps in fixed-size padded host arrays."""

    def __init__(self, max_laps: int, nx: int = 6, pad_len: int = 2048):
        self.max_laps = max_laps
        self.nx = nx
        self.pad = pad_len
        # tripled arrays for the periodic query
        self.x_rep = np.zeros((max_laps, 3 * pad_len, nx), dtype=np.float32)
        self.J_rep = np.zeros((max_laps, 3 * pad_len), dtype=np.float32)
        self.valid_rep = np.zeros((max_laps, 3 * pad_len), dtype=bool)
        self._next_slot = 0
        self.num_laps = 0
        # slot order, newest first
        self._order: list[int] = []

    # ------------------------------------------------------------------
    def add_lap(self, x: np.ndarray, u: np.ndarray, k: np.ndarray,
                t: np.ndarray, total_length: float):
        """Store one lap (x: (T, nx) rows = steps; u, k, t its controls,
        curvatures and times).  Mirrors ``SSTrajectory::process_lap_data``
        (safe_set.cpp:116-137).  The query reads the states only; u, k and t
        feed the regression, which is not ported yet."""
        x = np.asarray(x, dtype=np.float32)
        T = x.shape[0]
        for name, a in (("u", u), ("k", k), ("t", t)):
            if len(a) != T:
                raise ValueError(f"lap {name} has {len(a)} rows for {T} states")
        if T > self.pad:
            raise ValueError(f"lap of {T} steps exceeds pad length {self.pad}")
        J = np.linspace(T - 1, 0, T, dtype=np.float32)
        offset = np.zeros_like(x)
        offset[:, 0] = total_length
        x_rep = np.concatenate([x - offset, x, x + offset], axis=0)
        J_rep = np.concatenate([J + T - 1, J, J - T + 1])

        slot = self._next_slot
        self._next_slot = (self._next_slot + 1) % self.max_laps
        self.num_laps = min(self.num_laps + 1, self.max_laps)
        if slot in self._order:
            self._order.remove(slot)
        self._order.insert(0, slot)

        for arr in (self.x_rep[slot], self.J_rep[slot]):
            arr.fill(0)
        self.valid_rep[slot].fill(False)
        for i in range(3):
            lo = i * self.pad
            self.x_rep[slot, lo:lo + T] = x_rep[i * T:(i + 1) * T]
            self.J_rep[slot, lo:lo + T] = J_rep[i * T:(i + 1) * T]
            self.valid_rep[slot, lo:lo + T] = True

    # ------------------------------------------------------------------
    def query(self, query: SSQuery) -> SSResult:
        """k-nearest safe-set points around the query state.

        Newest laps first with a per-lap cap, concatenated and truncated to
        ``max_num_total`` (SafeSetManager::query, safe_set.cpp:153-180).
        """
        if self.num_laps == 0:
            return SSResult(np.zeros((0, self.nx), dtype=np.float32),
                            np.zeros((0,), dtype=np.float32))
        p = np.asarray(query.x[:2], dtype=np.float32)
        xs, Js = [], []
        total = 0
        for slot in self._order:
            if total >= query.max_num_total:
                break
            d2 = np.sum((self.x_rep[slot][:, :2] - p) ** 2, axis=-1)
            d2 = np.where(self.valid_rep[slot], d2, np.inf)
            n_take = min(query.max_num_per_lap, int(self.valid_rep[slot].sum()))
            idx = np.argpartition(d2, n_take - 1)[:n_take]
            idx = idx[np.argsort(d2[idx])]
            xs.append(self.x_rep[slot][idx])
            Js.append(self.J_rep[slot][idx])
            total += n_take
        x_cat = np.concatenate(xs, axis=0)[:query.max_num_total]
        J_cat = np.concatenate(Js)[:query.max_num_total]
        return SSResult(x_cat, J_cat)

    def query_padded(self, x_query: np.ndarray, num_total: int,
                     num_per_lap: int) -> tuple[np.ndarray, np.ndarray, bool]:
        """Query + the fixed-K padding of racing_mpc.cpp:263-277: pad by
        repeating the last point, truncate to ``num_total``; J made relative
        to the first point (racing_mpc.cpp:280)."""
        res = self.query(SSQuery(x_query, 1.0, num_total, num_per_lap))
        if res.x.shape[0] == 0:
            return (np.zeros((num_total, self.nx), dtype=np.float32),
                    np.zeros((num_total,), dtype=np.float32), False)
        x, J = res.x, res.J
        if x.shape[0] < num_total:
            reps = num_total - x.shape[0]
            x = np.concatenate([x, np.repeat(x[-1:], reps, axis=0)], axis=0)
            J = np.concatenate([J, np.repeat(J[-1:], reps)])
        return x, J - J[0], True


class SafeSetRecorder:
    """Accumulates the driven trajectory, detects lap completion by abscissa
    wrap, commits laps to the manager and optionally checkpoints them in the
    reference's ``<prefix>lap_N_{x,u,k,t}.txt`` format.  Mirrors
    ``SafeSetRecorder`` (safe_set.cpp:247-322)."""

    def __init__(self, manager: SafeSetManager, to_file: bool = False,
                 file_prefix: str = ""):
        self.manager = manager
        self.to_file = to_file
        self.file_prefix = file_prefix
        self.initialized = False
        self.lap_count = 0
        self._xs: list[np.ndarray] = []
        self._us: list[np.ndarray] = []
        self._ks: list[float] = []
        self._ts: list[float] = []
        self.lap_times: list[float] = []

    def load(self, from_files: Sequence[str | Path], total_length: float):
        """Load recorded laps (``<prefix>_{x,u,k,t}.txt``),
        safe_set.cpp:260-276.  A lap whose files cannot be read is reported
        and skipped, as the reference does."""
        for prefix in from_files:
            try:
                x = np.loadtxt(f"{prefix}_x.txt")
                u = np.loadtxt(f"{prefix}_u.txt")
                k = np.loadtxt(f"{prefix}_k.txt")
                t = np.loadtxt(f"{prefix}_t.txt")
            except OSError as e:
                print(f"Failed to load lap from {prefix}: {e}")
                continue
            self.manager.add_lap(x, u, k, t, total_length)
            self.lap_count += 1

    def step(self, x, u, k, t, total_length: float):
        """Record one control step (safe_set.cpp:278-322); the first wrap
        only starts the first full lap."""
        x = np.asarray(x, dtype=np.float64).reshape(-1)
        u = np.asarray(u, dtype=np.float64).reshape(-1)
        if self._xs and float(self._xs[-1][0]) - float(x[0]) > 0.5 * total_length:
            if self.initialized:
                self.lap_times.append(float(t) - self._ts[0])
                xs, us = np.stack(self._xs), np.stack(self._us)
                ks, ts = np.asarray(self._ks), np.asarray(self._ts)
                self.manager.add_lap(xs, us, ks, ts, total_length)
                if self.to_file:
                    prefix = f"{self.file_prefix}lap_{self.lap_count}"
                    for name, a in (("x", xs), ("u", us), ("t", ts), ("k", ks)):
                        np.savetxt(f"{prefix}_{name}.txt", a)
            else:
                self.initialized = True
            self.lap_count += 1
            self._xs, self._us, self._ks, self._ts = [], [], [], []
        self._xs.append(x)
        self._us.append(u)
        self._ks.append(float(k))
        self._ts.append(float(t))
