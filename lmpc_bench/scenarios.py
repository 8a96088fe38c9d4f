"""Scenario inputs of the LMPC cells, made on the host from the seed.

A scenario is one LMPC solve: an initial state somewhere on the lap, a
reference at constant speed over the horizon, the track's boundaries,
curvature and speed along it, and the K safe-set points nearest to the
reference's last state in the recorded laps.  The draws are those of the
port's ``benchmarks.make_scenario_batch`` (the initial speed a constant
times a factor, as for BARC) or of ``chip_smoke.dt_lmpc_fields`` (the
raceline's speed times a factor, as for Putnam), as the configuration's
``assumed.scenario_draws`` say, with their numpy track spline and safe-set
query copied here, so that the inputs do not move when the port changes.  The safe-set query is vectorized over the lanes: per lap,
newest first, the ``per_lap`` nearest points in the (s, t) plane of the lap
tripled over one lap length (ties to the lower index), concatenated and cut
to K, padded by repeating the last point, the cost-to-go made relative to
the first point.

Every array is float32 numpy with the batch leading, one key per field of
the port's ``MPCInput``.  The state and control sizes and the speed's place
in the state are the configuration's reference model's
(``reference/models/<model>.py``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from scipy.interpolate import CubicSpline

from lmpc_bench.reference.qp import load_model

HERE = Path(__file__).resolve().parent

# the 17-column waypoint table of the track files
_PX, _PY, _SPEED, _S, _S_FWD = 0, 1, 4, 6, 7
_LBX, _LBY, _RBX, _RBY = 9, 10, 11, 12

FIELDS = ("x_ic", "u_ic", "X_ref", "U_ref", "T_ref", "bound_left", "bound_right",
          "total_length", "curvatures", "vel_ref", "ss_x", "ss_j")


class Track:
    """Periodic cubic splines of a track file's centerline and of its
    (speed, left offset, right offset), as the port's ``RacingTrajectory``
    fits its host twins."""

    def __init__(self, path: Path):
        t = np.loadtxt(path)
        s = t[:, _S]
        self.total_length = float(t[0, _S_FWD])
        d_left = np.hypot(t[:, _PX] - t[:, _LBX], t[:, _PY] - t[:, _LBY])
        d_right = -np.hypot(t[:, _PX] - t[:, _RBX], t[:, _PY] - t[:, _RBY])
        knots = np.concatenate([s, [s[0] + self.total_length]])

        def fit(values):
            values = np.concatenate([values, values[:1]], axis=0)
            return CubicSpline(knots, values, bc_type="periodic", axis=0,
                               extrapolate="periodic")
        self._xy = fit(t[:, [_PX, _PY]])
        self._scalars = fit(np.stack([t[:, _SPEED], d_left, d_right], -1))

    def velocity(self, s):
        return self._scalars(np.asarray(s))[..., 0]

    def left(self, s):
        return self._scalars(np.asarray(s))[..., 1]

    def right(self, s):
        return self._scalars(np.asarray(s))[..., 2]

    def curvature(self, s):
        d = self._xy(np.asarray(s), 1)
        dd = self._xy(np.asarray(s), 2)
        return ((d[..., 0] * dd[..., 1] - d[..., 1] * dd[..., 0])
                / (d[..., 0] ** 2 + d[..., 1] ** 2) ** 1.5)


class SafeSet:
    """Recorded laps (oldest first in ``paths``), each tripled over one lap
    length with its cost-to-go offset (the reference's periodic query)."""

    def __init__(self, paths, total_length: float):
        self.laps = []
        for path in paths:
            x = np.loadtxt(path).astype(np.float32)
            T = x.shape[0]
            J = np.linspace(T - 1, 0, T, dtype=np.float32)
            off = np.zeros_like(x)
            off[:, 0] = total_length
            self.laps.append((np.concatenate([x - off, x, x + off]),
                              np.concatenate([J + T - 1, J, J - T + 1])))

    def query(self, points: np.ndarray, K: int, per_lap: int):
        """(ss_x (B, K, nx), ss_j (B, K)) for query states ``points`` (B, >= 2)."""
        p = points[:, None, :2].astype(np.float32)
        xs, js = [], []
        for x, J in reversed(self.laps):              # newest lap first
            d2 = np.sum((x[None, :, :2] - p) ** 2, axis=-1)
            idx = np.argsort(d2, axis=-1, kind="stable")[:, :per_lap]
            xs.append(x[idx])
            js.append(J[idx])
        ss_x = np.concatenate(xs, axis=1)[:, :K]
        ss_j = np.concatenate(js, axis=1)[:, :K]
        if ss_x.shape[1] < K:
            pad = K - ss_x.shape[1]
            ss_x = np.concatenate([ss_x, np.repeat(ss_x[:, -1:], pad, 1)], 1)
            ss_j = np.concatenate([ss_j, np.repeat(ss_j[:, -1:], pad, 1)], 1)
        return ss_x, ss_j - ss_j[:, :1]


class ScenarioMaker:
    """The scenario draws of one configuration (its ``assumed.scenario_draws``)."""

    def __init__(self, cfg: dict):
        mpc = cfg["racing_mpc"]
        self.N = int(mpc["n"])
        self.K = int(mpc["num_ss_pts"])
        self.per_lap = int(mpc["num_ss_pts_per_lap"])
        self.dt = float(cfg["control_period_s"])
        model = load_model(cfg)
        self.nx, self.nu, self.idx_vel = model.nx, model.nu, model.idx_vel
        self.draws = cfg["assumed"]["scenario_draws"]
        self.track = Track(HERE / cfg["track"])
        self.safe_set = SafeSet([HERE / p for p in cfg["safe_set_laps"]],
                                self.track.total_length)

    def batch(self, rng: np.random.Generator, B: int) -> dict:
        """B scenarios from ``rng``: s0, then ey0, then the speed factor,
        each drawn for the whole batch."""
        N, nx, d = self.N, self.nx, self.draws
        L = self.track.total_length
        s0 = rng.uniform(0.0, L, B)
        ey0 = rng.uniform(*d["ey0_m"], B)
        v = d["v0_mps"]
        base = self.track.velocity(s0) if v["base"].startswith("raceline") else 1.0
        v0 = np.maximum(base * rng.uniform(*v["factor"], B), v["at_least"])
        s_hor = s0[:, None] + v0[:, None] * self.dt * np.arange(N)[None, :]
        X_ref = np.zeros((B, N, nx), np.float32)
        X_ref[..., 0] = s_hor
        X_ref[..., self.idx_vel] = v0[:, None]
        x_ic = X_ref[:, 0].copy()
        x_ic[:, 1] = ey0
        clip = d["vel_ref_clip_mps"]
        vel = np.clip(self.track.velocity(s_hor), v0[:, None] - clip, v0[:, None] + clip)
        ss_x, ss_j = self.safe_set.query(X_ref[:, -1], self.K, self.per_lap)
        f32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)  # noqa: E731
        return {
            "x_ic": x_ic, "u_ic": np.zeros((B, self.nu), np.float32), "X_ref": X_ref,
            "U_ref": np.zeros((B, N - 1, self.nu), np.float32),
            "T_ref": np.full((B, N - 1), self.dt, np.float32),
            "bound_left": f32(self.track.left(s_hor)),
            "bound_right": f32(self.track.right(s_hor)),
            "total_length": np.full((B,), L, np.float32),
            "curvatures": f32(self.track.curvature(s_hor)), "vel_ref": f32(vel),
            "ss_x": f32(ss_x), "ss_j": f32(ss_j)}
