"""Kinematic bicycle model (slip-angle-free).

Port of ``racing_lmpc_tpu/models/kinematic_bicycle.py`` (parity target
``kinematic_bicycle_model.cpp``).

State  x = (PX, PY, YAW, V)    — V is the velocity magnitude at the cg.
Control u = (FD, FB, STEER).
"""

from __future__ import annotations

import enum

import numpy as np
import torch
from torch import Tensor

from racing_lmpc_torch.config import BaseVehicleConfig, SingleTrackConfig
from racing_lmpc_torch.models.base import BaseUIndex, BaseXIndex, BoxBounds, VehicleModel


class KinXIndex(enum.IntEnum):
    PX = 0
    PY = 1
    YAW = 2
    V = 3


class KinematicBicycleModel(VehicleModel):
    def __init__(self, base_config: BaseVehicleConfig, config: SingleTrackConfig):
        super().__init__(base_config)
        self.config = config

    @property
    def nx(self) -> int:
        return 4

    @property
    def nu(self) -> int:
        return 3

    def _beta(self, delta: Tensor) -> Tensor:
        """Kinematic slip angle beta = atan(lr * tan(delta) / l)
        (kinematic_bicycle_model.cpp:191)."""
        cfg = self.base_config.chassis
        lr = cfg.cg_ratio * cfg.wheel_base
        return torch.arctan(lr * torch.tan(delta) / cfg.wheel_base)

    def dynamics(self, x: Tensor, u: Tensor, k: Tensor) -> Tensor:
        """Continuous dynamics (kinematic_bicycle_model.cpp:189-232)."""
        cfg = self.base_config
        py = x[..., KinXIndex.PY]
        phi = x[..., KinXIndex.YAW]
        v = x[..., KinXIndex.V]
        fd = u[..., BaseUIndex.FD]
        fb = u[..., BaseUIndex.FB]
        delta = u[..., BaseUIndex.STEER]
        v_sq = v * v

        beta = self._beta(delta)
        l = cfg.chassis.wheel_base
        # v / R with R = (l / tan d) / cos(beta), written division-free as
        # the reference does (``kinematic_bicycle.py:68-72``): the R-form
        # gives NaN Jacobians at delta == 0
        phi_dot = v * torch.cos(beta) * torch.tan(delta) / l
        px_dot = v * torch.cos(beta + phi)
        py_dot = v * torch.sin(beta + phi)
        v_dot = self._longitudinal_accel(fd, fb, v_sq)

        if cfg.modeling.use_frenet:
            px_dot, phi_dot = self.frenet_correction(px_dot, phi_dot, py, k)

        return torch.stack([px_dot, py_dot, phi_dot, v_dot], dim=-1)

    def forces(self, x: Tensor, u: Tensor):
        """(Fx_f, Fx_r), (Fz_f, Fz_r) per wheel (kinematic_bicycle_model.cpp:
        199-226).  As in the reference (``kinematic_bicycle.py:81-95``), the
        vertical loads are the shared front/rear split, not the C++'s
        ``lr``-for-both quirk; the values are diagnostics only."""
        fd = u[..., BaseUIndex.FD]
        fb = u[..., BaseUIndex.FB]
        v = x[..., KinXIndex.V]
        v_sq = v * v
        Fx_f, Fx_r = self._axle_longitudinal_forces(fd, fb)
        ax = self._longitudinal_accel(fd, fb, v_sq)
        Fz_f, Fz_r = self._vertical_loads(ax, v_sq)
        return (Fx_f, Fx_r), (Fz_f, Fz_r)

    # -- base conversions (kinematic_bicycle_model.cpp:286-306) --------------
    def to_base_state(self, x: Tensor, u: Tensor) -> Tensor:
        delta = u[..., BaseUIndex.STEER]
        beta = self._beta(delta)
        v = x[..., KinXIndex.V]
        cfg = self.base_config.chassis
        return torch.stack([
            x[..., KinXIndex.PX],
            x[..., KinXIndex.PY],
            x[..., KinXIndex.YAW],
            v * torch.cos(beta),
            v * torch.sin(beta),
            # v / R, division-free (see dynamics)
            v * torch.cos(beta) * torch.tan(delta) / cfg.wheel_base,
        ], dim=-1)

    def from_base_state(self, x_base: Tensor, u_base: Tensor) -> Tensor:
        return torch.stack([
            x_base[..., BaseXIndex.PX],
            x_base[..., BaseXIndex.PY],
            x_base[..., BaseXIndex.YAW],
            torch.hypot(x_base[..., BaseXIndex.VX], x_base[..., BaseXIndex.VY]),
        ], dim=-1)

    def control_bounds(self) -> BoxBounds:
        """Linear bounds of ``add_nlp_constraints``
        (kinematic_bicycle_model.cpp:95-115); the steer-rate limit uses
        Tdelta = max_steer / max_steer_rate as in :60-61."""
        cfg = self.config
        steer_max = self.base_config.steer.max_steer
        t_delta = steer_max / self.base_config.steer.max_steer_rate
        u_lb = np.array([0.0, cfg.fb_max, -steer_max])
        u_ub = np.array([cfg.fd_max, 0.0, steer_max])
        du_lb = np.array([-np.inf, cfg.fb_max / cfg.tb, -steer_max / t_delta])
        du_ub = np.array([cfg.fd_max / cfg.td, np.inf, steer_max / t_delta])
        return BoxBounds(u_lb, u_ub, du_lb, du_ub)

    def power_constraint(self, x: Tensor, u: Tensor) -> Tensor:
        """Nonlinear power constraint v*fd <= P_max (:103)."""
        return x[..., KinXIndex.V] * u[..., BaseUIndex.FD] - self.config.p_max

    n_nl: int = 2

    def nl_constraints(self, x: Tensor, u: Tensor, k: Tensor) -> Tensor:
        """Power + drive/brake exclusivity (kinematic_bicycle_model.cpp:99-104):
        v*fd - P_max <= 0  and  (fd*fb)^2 - 1 <= 0."""
        fd = u[..., BaseUIndex.FD]
        fb = u[..., BaseUIndex.FB]
        excl = (fd * fb) ** 2 - 1.0
        return torch.stack([self.power_constraint(x, u), excl], dim=-1)

    def calc_lon_control(self, u) -> tuple[float, float]:
        return self._throttle_or_brake(float(u[BaseUIndex.FD]), float(u[BaseUIndex.FB]))

    def calc_lat_control(self, u) -> float:
        return float(u[BaseUIndex.STEER])
