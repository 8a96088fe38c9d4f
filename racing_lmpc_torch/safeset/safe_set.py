"""Safe set for LMPC: stored laps, cost-to-go, k-nearest query and the
local error-dynamics regression.

Port of the numpy path of ``racing_lmpc_tpu/safeset/safe_set.py``
(``SafeSetManager``, ``:75-298``, and ``SafeSetRecorder``, ``:301-369``).
The reference's native C++ k-NN is not bound here; the query is the
reference's numpy fallback.  ``query_regression`` runs its one-step
prediction sweep over every stored point batched through the model's
discrete dynamics on the port's device in f32 (as the reference does under
``jax.vmap``), and its Epanechnikov-weighted least squares in float64 numpy
on the host.

Replicated semantics (safe_set.cpp): cost-to-go J = [T-1 .. 0],
abscissa-tripled states (x - L, x, x + L) with J offsets for periodic
matching across start/finish; per-lap k nearest in the (s, t) plane, newest
laps first, concatenated then truncated to the total budget; the recorder
closes a lap when the abscissa wraps (drops by more than half the track).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from racing_lmpc_torch import resolve_device


class SSQuery(NamedTuple):
    """Mirrors ``SSQuery`` (safe_set.hpp:35-44)."""
    x: np.ndarray            # (nx,) query state (terminal reference)
    dist_max: float
    max_num_total: int
    max_num_per_lap: int


class SSResult(NamedTuple):
    x: np.ndarray            # (num, nx)
    J: np.ndarray            # (num,)


class RegQuery(NamedTuple):
    """Mirrors ``RegQuery`` (safe_set.hpp:57-76)."""
    x: np.ndarray                         # query point in (x_sel, u_sel) space
    dist_max: float
    reg_in_state_idxs: Sequence[Sequence[int]]
    reg_in_control_idxs: Sequence[Sequence[int]]
    reg_out_state_idxs: Sequence[Sequence[int]]
    A: np.ndarray                          # nominal A (nx, nx)
    B: np.ndarray                          # nominal B (nx, nu)
    C: np.ndarray                          # nominal affine offset (nx,)
    # discrete dynamics f(x, u, k, dt) -> x+ on tensors with a leading batch
    f: Callable


class RegResult(NamedTuple):
    A: np.ndarray
    B: np.ndarray
    C: np.ndarray


class SafeSetManager:
    """Ring buffer of stored laps in fixed-size padded host arrays."""

    def __init__(self, max_laps: int, nx: int = 6, nu: int = 2, pad_len: int = 2048):
        self.max_laps = max_laps
        self.nx, self.nu = nx, nu
        self.pad = pad_len
        # tripled arrays for the periodic query
        self.x_rep = np.zeros((max_laps, 3 * pad_len, nx), dtype=np.float32)
        self.J_rep = np.zeros((max_laps, 3 * pad_len), dtype=np.float32)
        self.valid_rep = np.zeros((max_laps, 3 * pad_len), dtype=bool)
        # raw per-lap data for the regression
        self.x_raw = np.zeros((max_laps, pad_len, nx), dtype=np.float32)
        self.u_raw = np.zeros((max_laps, pad_len, nu), dtype=np.float32)
        self.k_raw = np.zeros((max_laps, pad_len), dtype=np.float32)
        self.dt_raw = np.zeros((max_laps, pad_len), dtype=np.float32)
        self.valid_raw = np.zeros((max_laps, pad_len), dtype=bool)
        self._next_slot = 0
        self.num_laps = 0
        # slot order, newest first
        self._order: list[int] = []

    # ------------------------------------------------------------------
    def add_lap(self, x: np.ndarray, u: np.ndarray, k: np.ndarray,
                t: np.ndarray, total_length: float):
        """Store one lap (x: (T, nx) rows = steps; u, k, t its controls,
        curvatures and times).  Mirrors ``SSTrajectory::process_lap_data``
        (safe_set.cpp:116-137); the raw lap is kept for the regression with
        forward-difference step lengths (``safe_set.py:150-158``)."""
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

        self.valid_raw[slot].fill(False)
        self.x_raw[slot, :T] = x
        self.u_raw[slot, :T] = np.asarray(u, dtype=np.float32)
        self.k_raw[slot, :T] = np.asarray(k, dtype=np.float32).reshape(-1)
        # forward differences (positive dt, what the prediction f(x, u, k,
        # dt) needs), the last one repeated; the reference's C++ stores
        # negative backward differences (see the reference module)
        t = np.asarray(t, dtype=np.float32).reshape(-1)
        dt = np.diff(t)
        self.dt_raw[slot, :T] = np.concatenate([dt, dt[-1:]]) if dt.size else np.zeros(T)
        self.valid_raw[slot, :T] = True

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


    # ------------------------------------------------------------------
    def query_regression(self, query: RegQuery, device=None) -> RegResult:
        """Local error-dynamics regression (SafeSetManager::query(RegQuery),
        safe_set.cpp:182-245; ``safe_set.py:212-298``).

        Each group fits the one-step prediction error of its one OUTPUT state
        ``y = x+_data[out] - f(x, u)[out]`` from the selected (state, control)
        features with Epanechnikov weights around ``query.x`` (one point for
        every group, or one per group).  A recorded control produced its
        state, so the control flown over [t_i, t_i+1) is the successor's
        (``np.roll(u, -1)``), and a point counts only if its successor is
        stored too.  The correction is the POSITIVE fit, the reference's
        deliberate sign (its docstring gives why).  The prediction sweep runs
        on ``device`` (CUDA unless the caller names one) in f32; the fit in
        float64 on the host.
        """
        A = np.array(query.A, dtype=np.float64, copy=True)
        B = np.array(query.B, dtype=np.float64, copy=True)
        C = np.array(query.C, dtype=np.float64, copy=True)
        if self.num_laps == 0:
            return RegResult(A, B, C)
        device = resolve_device(device)

        slots = self._order
        valid = self.valid_raw[slots]              # (L, P)
        x_all = self.x_raw[slots].astype(np.float64)
        u_next = np.roll(self.u_raw[slots], -1, axis=1).astype(np.float64)
        k_all = self.k_raw[slots].astype(np.float64)
        dt_all = self.dt_raw[slots].astype(np.float64)
        xip1_all = np.roll(x_all, -1, axis=1)
        # a point is usable if it AND its successor are valid (xip1, u_next)
        has_next = np.zeros_like(valid)
        has_next[:, :-1] = valid[:, :-1] & valid[:, 1:]

        # the one-step prediction at every stored point, once per query
        def dev(a, *shape):
            return torch.as_tensor(a.reshape(*shape), dtype=torch.float32, device=device)
        with torch.no_grad():
            f_pred = query.f(dev(x_all, -1, self.nx), dev(u_next, -1, self.nu),
                             dev(k_all, -1), dev(dt_all, -1))
        f_pred = f_pred.cpu().numpy().astype(np.float64).reshape(x_all.shape)

        per_group_x = isinstance(query.x, (list, tuple))
        for gi, out_i in enumerate(query.reg_out_state_idxs):
            in_x = list(query.reg_in_state_idxs[gi])
            in_u = list(query.reg_in_control_idxs[gi])
            out_i = list(out_i)
            if len(out_i) != 1:
                raise ValueError(
                    "Only one state variable is supported in every regression")
            xs = x_all[:, :, in_x]
            us = u_next[:, :, in_u]
            z = np.concatenate([xs, us], axis=-1)          # (L, P, d)
            qx = query.x[gi] if per_group_x else query.x
            dists = np.sqrt(np.sum((z - np.asarray(qx, dtype=np.float64)) ** 2, axis=-1))
            mask = has_next & (dists < query.dist_max)
            if not mask.any():
                continue
            y = xip1_all[:, :, out_i[0]] - f_pred[:, :, out_i[0]]  # (L, P)
            K = np.where(mask, 0.75 / query.dist_max
                         * (1.0 - (dists / query.dist_max) ** 2) ** 2, 0.0)
            M = np.concatenate([xs, us, np.ones((*xs.shape[:2], 1))], axis=-1)
            Mf = M.reshape(-1, M.shape[-1])
            Kf = K.reshape(-1)
            Q = Mf.T @ (Kf[:, None] * Mf) + 1e-3 * np.eye(Mf.shape[1])
            R = np.linalg.solve(Q, Mf.T @ (Kf * y.reshape(-1)))
            nsx = len(in_x)
            A[np.ix_(out_i, in_x)] += R[:nsx]
            B[np.ix_(out_i, in_u)] += R[nsx:-1]
            C[out_i[0]] += R[-1]
        return RegResult(A, B, C)


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
