"""Periodic Frenet-frame track model.

Port of ``racing_lmpc_tpu/track/trajectory.py``: periodic cubic splines of
the centerline (x, y) and of (speed, left offset, right offset), fit on the
host at load and evaluated on the track's device (CUDA unless the caller
names one); yaw and curvature from the spline derivatives; global -> Frenet
by a fixed-iteration guarded Newton projection on the arc length, seeded at
the nearest waypoint (a brute-force argmin over the waypoint table, which
picks the first of equidistant waypoints as the reference's argmin does).

Every device accessor broadcasts over leading batch dimensions.  The
``*_np`` evaluators are the same math on SciPy twins of the splines, for
host bookkeeping that must not touch the device.
"""

from __future__ import annotations

import enum
from pathlib import Path

import numpy as np
import torch
from torch import Tensor

from racing_lmpc_torch import resolve_device
from racing_lmpc_torch.ops.math import align_abscissa, lateral_sign, wrap_to_pi
from racing_lmpc_torch.ops.spline import (
    PeriodicSpline, fit_host_spline, fit_periodic_spline)

NEWTON_ITERS = 12


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
    """Device-resident track model with Frenet <-> global conversions."""

    def __init__(self, table: np.ndarray, device=None):
        """``table``: (M, 17) waypoint array (rows = waypoints)."""
        self.device = resolve_device(device)
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
        xy = table[:, [T.PX, T.PY]]
        scalars = np.stack([table[:, T.SPEED], d_left, d_right], axis=-1)
        self.xy_spline: PeriodicSpline = fit_periodic_spline(
            s, xy, self.total_length, self.device)
        self.scalar_spline: PeriodicSpline = fit_periodic_spline(
            s, scalars, self.total_length, self.device)
        self._xy_cs = fit_host_spline(s, xy, self.total_length)
        self._scalar_cs = fit_host_spline(s, scalars, self.total_length)
        # waypoints for the nearest-point seed (the reference's KD-tree role)
        self.waypoints_xy = torch.as_tensor(xy, dtype=torch.float32, device=self.device)
        self.waypoints_s = torch.as_tensor(s, dtype=torch.float32, device=self.device)
        self._wp_xy_np = xy
        self._wp_s_np = s

    @classmethod
    def from_file(cls, file_name: str | Path, device=None) -> "RacingTrajectory":
        """Load the whitespace 17-column format of the reference's track
        files (rows = waypoints)."""
        return cls(np.loadtxt(file_name), device=device)

    # ------------------------------------------------------------------
    # device accessors (one per reference interpolant)
    # ------------------------------------------------------------------
    def position(self, s: Tensor) -> Tensor:
        """Centerline (x, y) at abscissa s -> (..., 2)."""
        return self.xy_spline.eval(s)

    def velocity(self, s: Tensor) -> Tensor:
        return self.scalar_spline.eval(s)[..., 0]

    def left_boundary(self, s: Tensor) -> Tensor:
        """Signed lateral offset of the left boundary (positive)."""
        return self.scalar_spline.eval(s)[..., 1]

    def right_boundary(self, s: Tensor) -> Tensor:
        """Signed lateral offset of the right boundary (negative)."""
        return self.scalar_spline.eval(s)[..., 2]

    def yaw(self, s: Tensor) -> Tensor:
        """Centerline heading from the spline tangent."""
        d = self.xy_spline.eval_d(s)
        return torch.atan2(d[..., 1], d[..., 0])

    def curvature(self, s: Tensor) -> Tensor:
        """Signed curvature (x'y'' - y'x'') / (x'^2 + y'^2)^{3/2}."""
        d = self.xy_spline.eval_d(s)
        dd = self.xy_spline.eval_d2(s)
        num = d[..., 0] * dd[..., 1] - d[..., 1] * dd[..., 0]
        den = (d[..., 0] ** 2 + d[..., 1] ** 2) ** 1.5
        return num / den

    # ------------------------------------------------------------------
    # host (numpy) twins, float64
    # ------------------------------------------------------------------
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
        d = self._xy_cs(np.asarray(s), 1)
        dd = self._xy_cs(np.asarray(s), 2)
        num = d[..., 0] * dd[..., 1] - d[..., 1] * dd[..., 0]
        den = (d[..., 0] ** 2 + d[..., 1] ** 2) ** 1.5
        return num / den

    def nearest_waypoint_abscissa_np(self, xy: np.ndarray) -> np.ndarray:
        """Abscissa of the closest waypoint (brute-force argmin)."""
        xy = np.asarray(xy, dtype=np.float64)
        d2 = np.sum((self._wp_xy_np - xy[..., None, :]) ** 2, axis=-1)
        return self._wp_s_np[np.argmin(d2, axis=-1)]

    def global_to_frenet_np(self, pose_global: np.ndarray,
                            s_prev: float | np.ndarray | None = None
                            ) -> np.ndarray:
        """Host twin of ``global_to_frenet`` (the same guarded Newton on the
        SciPy twins), for control-loop bookkeeping."""
        pose_global = np.asarray(pose_global, dtype=np.float64)
        xy = pose_global[..., :2]
        phi = pose_global[..., 2]
        L = float(self.total_length)
        s = (np.asarray(s_prev, dtype=np.float64) if s_prev is not None
             else self.nearest_waypoint_abscissa_np(xy))
        for _ in range(NEWTON_ITERS):
            gamma = self._xy_cs(s)
            d1 = self._xy_cs(s, 1)
            d2 = self._xy_cs(s, 2)
            r = gamma - xy
            g = 2.0 * np.sum(d1 * r, axis=-1)
            h = 2.0 * (np.sum(d1 * d1, axis=-1) + np.sum(d2 * r, axis=-1))
            h_safe = np.where(h > 1e-6, h, 2.0 * np.sum(d1 * d1, axis=-1))
            s = s - np.clip(g / h_safe, -0.25 * L, 0.25 * L)
        s = s - np.floor(s / L) * L
        gamma = self._xy_cs(s)
        d1 = self._xy_cs(s, 1)
        yaw0 = np.arctan2(d1[..., 1], d1[..., 0])
        t = np.hypot(xy[..., 0] - gamma[..., 0], xy[..., 1] - gamma[..., 1])
        sign = np.sign((xy[..., 0] - gamma[..., 0]) * -np.sin(yaw0)
                       + (xy[..., 1] - gamma[..., 1]) * np.cos(yaw0))
        xi = np.arctan2(np.sin(phi - yaw0), np.cos(phi - yaw0))
        return np.stack([s, t * sign, xi], axis=-1)

    # ------------------------------------------------------------------
    # frenet <-> global on the device
    # ------------------------------------------------------------------
    def frenet_to_global(self, pose_frenet: Tensor) -> Tensor:
        """(s, t, xi) -> (x, y, phi) (racing_trajectory.cpp:121-135)."""
        s, t, xi = pose_frenet[..., 0], pose_frenet[..., 1], pose_frenet[..., 2]
        xy = self.position(s)
        yaw0 = self.yaw(s)
        x = xy[..., 0] - torch.sin(yaw0) * t
        y = xy[..., 1] + torch.cos(yaw0) * t
        return torch.stack([x, y, wrap_to_pi(yaw0 + xi)], dim=-1)

    def nearest_waypoint_abscissa(self, xy: Tensor) -> Tensor:
        """Abscissa of the closest waypoint, ``xy`` (..., 2): a batched
        reduction in place of the reference's KD-tree."""
        d2 = torch.sum((self.waypoints_xy - xy[..., None, :]) ** 2, dim=-1)
        return self.waypoints_s[torch.argmin(d2, dim=-1)]

    def project(self, xy: Tensor, s0: Tensor) -> Tensor:
        """Arc length of the closest centerline point: NEWTON_ITERS guarded
        Newton steps on min_s ||gamma(s) - p||^2 from ``s0``, falling back to
        a normalized gradient step where the local Hessian is not positive."""
        s = s0
        for _ in range(NEWTON_ITERS):
            gamma = self.xy_spline.eval(s)
            d1 = self.xy_spline.eval_d(s)
            d2 = self.xy_spline.eval_d2(s)
            r = gamma - xy
            g = 2.0 * torch.sum(d1 * r, dim=-1)
            h = 2.0 * (torch.sum(d1 * d1, dim=-1) + torch.sum(d2 * r, dim=-1))
            h_safe = torch.where(h > 1e-6, h, 2.0 * torch.sum(d1 * d1, dim=-1))
            step = torch.clamp(g / h_safe, -0.25 * self.total_length,
                               0.25 * self.total_length)
            s = s - step
        return s

    def global_to_frenet(self, pose_global: Tensor,
                         s_prev: Tensor | None = None) -> Tensor:
        """(x, y, phi) -> (s, t, xi) (racing_trajectory.cpp:198-236), seeded
        at ``s_prev`` when given, else at the nearest waypoint."""
        xy = pose_global[..., :2]
        phi = pose_global[..., 2]
        if s_prev is None:
            s_prev = self.nearest_waypoint_abscissa(xy)
        s = self.project(xy, s_prev)
        L = torch.as_tensor(self.total_length, dtype=s.dtype, device=s.device)
        s = align_abscissa(s, L / 2.0, L)
        gamma = self.position(s)
        yaw0 = self.yaw(s)
        pose0 = torch.cat([gamma, yaw0[..., None]], dim=-1)
        t = torch.hypot(xy[..., 0] - gamma[..., 0], xy[..., 1] - gamma[..., 1])
        t = t * lateral_sign(xy, pose0)
        return torch.stack([s, t, wrap_to_pi(phi - yaw0)], dim=-1)
