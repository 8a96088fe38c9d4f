"""Periodic Frenet-frame track model: the host part of
``racing_lmpc_tpu/track/trajectory.py`` (``:62-191``) that scenario
construction uses — the waypoint table, the total length, the SciPy spline
twins and the ``*_np`` evaluators.  The device-side spline evaluation and
the global->Frenet projection wait for the controller slice.
"""

from __future__ import annotations

import enum
from pathlib import Path

import numpy as np

from racing_lmpc_torch.ops.spline import fit_host_spline


class TrajectoryIndex(enum.IntEnum):
    """Column layout of the 17-column waypoint table
    (racing_trajectory.hpp:37-56)."""
    PX = 0
    PY = 1
    PZ = 2
    YAW = 3
    SPEED = 4
    CURVATURE = 5
    DIST_TO_SF_BWD = 6   # abscissa s
    DIST_TO_SF_FWD = 7
    REGION = 8
    LEFT_BOUND_X = 9
    LEFT_BOUND_Y = 10
    RIGHT_BOUND_X = 11
    RIGHT_BOUND_Y = 12
    BANK = 13
    LON_ACC = 14
    LAT_ACC = 15
    TIME = 16


class RacingTrajectory:
    """Track model evaluated on the host with SciPy splines."""

    def __init__(self, table: np.ndarray):
        """``table``: (M, 17) waypoint array (rows = waypoints)."""
        table = np.asarray(table, dtype=np.float64)
        if table.ndim != 2 or table.shape[1] < 13:
            raise ValueError(
                f"expected a (M, 17) waypoint table, got {table.shape}")
        T = TrajectoryIndex
        self.table = table
        s = table[:, T.DIST_TO_SF_BWD]
        # total length convention of the reference (racing_trajectory.cpp:28):
        # DIST_TO_SF_FWD of the first waypoint
        self.total_length = float(table[0, T.DIST_TO_SF_FWD])
        # signed lateral offsets of the boundaries (racing_trajectory.cpp:64-94)
        d_left = np.hypot(table[:, T.PX] - table[:, T.LEFT_BOUND_X],
                          table[:, T.PY] - table[:, T.LEFT_BOUND_Y])
        d_right = -np.hypot(table[:, T.PX] - table[:, T.RIGHT_BOUND_X],
                            table[:, T.PY] - table[:, T.RIGHT_BOUND_Y])
        self._xy_cs = fit_host_spline(
            s, table[:, [T.PX, T.PY]], self.total_length)
        self._scalar_cs = fit_host_spline(
            s, np.stack([table[:, T.SPEED], d_left, d_right], axis=-1),
            self.total_length)

    @classmethod
    def from_file(cls, file_name: str | Path) -> "RacingTrajectory":
        """Load the whitespace 17-column format of the reference's track
        files (rows = waypoints)."""
        return cls(np.loadtxt(file_name))

    def velocity_np(self, s: np.ndarray) -> np.ndarray:
        return self._scalar_cs(np.asarray(s))[..., 0]

    def left_boundary_np(self, s: np.ndarray) -> np.ndarray:
        return self._scalar_cs(np.asarray(s))[..., 1]

    def right_boundary_np(self, s: np.ndarray) -> np.ndarray:
        return self._scalar_cs(np.asarray(s))[..., 2]

    def yaw_np(self, s: np.ndarray) -> np.ndarray:
        d = self._xy_cs(np.asarray(s), 1)
        return np.arctan2(d[..., 1], d[..., 0])

    def curvature_np(self, s: np.ndarray) -> np.ndarray:
        """Signed curvature (x'y'' - y'x'') / (x'^2+y'^2)^{3/2}."""
        d = self._xy_cs(np.asarray(s), 1)
        dd = self._xy_cs(np.asarray(s), 2)
        num = d[..., 0] * dd[..., 1] - d[..., 1] * dd[..., 0]
        den = (d[..., 0] ** 2 + d[..., 1] ** 2) ** 1.5
        return num / den
