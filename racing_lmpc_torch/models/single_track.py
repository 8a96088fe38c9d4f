"""Single-track (dynamic bicycle) planar model with simplified Pacejka tyres.

Port of ``racing_lmpc_tpu/models/single_track.py:38-188``: the dynamics,
the base-control conversions, the QP-path constraint data and the actuator
maps ``calc_lon_control``/``calc_lat_control``.

State  x = (PX, PY, YAW, VX, VY, VYAW)          [Frenet: (s, t, xi, vx, vy, w)]
Control, full:        u = (FD, FB, STEER)        (nu = 3)
Control, simplified:  u = (LON, STEER)           (nu = 2), with the smooth
drive/brake split  fd = LON*(tanh(LON)*0.5+0.5)*1000,
                   fb = LON*(tanh(-LON)*0.5+0.5)*1000
"""

from __future__ import annotations

import enum

import numpy as np
import torch
from torch import Tensor

from racing_lmpc_torch.config import BaseVehicleConfig, SingleTrackConfig
from racing_lmpc_torch.models.base import (
    BaseUIndex, BaseXIndex, BoxBounds, VehicleModel)


class SimpleUIndex(enum.IntEnum):
    """Simplified-longitudinal control layout (UIndexSimple in the reference)."""
    LON = 0
    STEER = 1


class SingleTrackPlanarModel(VehicleModel):
    def __init__(self, base_config: BaseVehicleConfig, config: SingleTrackConfig):
        super().__init__(base_config)
        self.config = config

    @property
    def nx(self) -> int:
        return 6

    @property
    def nu(self) -> int:
        return 2 if self.config.simplify_lon_control else 3

    def split_lon_control(self, u: Tensor) -> tuple[Tensor, Tensor, Tensor]:
        """(fd, fb, delta) from the model control vector."""
        if self.config.simplify_lon_control:
            lon = u[..., SimpleUIndex.LON]
            fd = lon * (torch.tanh(lon) * 0.5 + 0.5) * 1000.0
            fb = lon * (torch.tanh(-lon) * 0.5 + 0.5) * 1000.0
            delta = u[..., SimpleUIndex.STEER]
        else:
            fd = u[..., BaseUIndex.FD]
            fb = u[..., BaseUIndex.FB]
            delta = u[..., BaseUIndex.STEER]
        return fd, fb, delta

    def tyre_forces(self, x: Tensor, u: Tensor):
        """Per-wheel (single-side) forces: (Fx_f, Fx_r), (Fy_f, Fy_r), (Fz_f, Fz_r).

        Mirrors single_track_planar_model.cpp:256-300 (axle-lumped, simplified
        Pacejka ``Fy = mu * Fz * sin(C * atan(B * alpha))``).
        """
        cfg = self.base_config
        vx = x[..., BaseXIndex.VX]
        vy = x[..., BaseXIndex.VY]
        omega = x[..., BaseXIndex.VYAW]
        v_sq = vx * vx
        fd, fb, delta = self.split_lon_control(u)

        Fx_f, Fx_r = self._axle_longitudinal_forces(fd, fb)
        ax = self._longitudinal_accel(fd, fb, v_sq)
        Fz_f, Fz_r = self._vertical_loads(ax, v_sq)

        l = cfg.chassis.wheel_base
        lr = cfg.chassis.cg_ratio * l
        lf = l - lr
        # sideslip angles (the 1e-3 regularizer matches :281-283)
        a_f = delta - torch.arctan((lf * omega + vy) / (vx + 1e-3))
        a_r = torch.arctan((lr * omega - vy) / (vx + 1e-3))

        mu = self.config.mu
        Bf, Cf = cfg.front_tyre.pacejka_b, cfg.front_tyre.pacejka_c
        Br, Cr = cfg.rear_tyre.pacejka_b, cfg.rear_tyre.pacejka_c
        Fy_f = mu * Fz_f * torch.sin(Cf * torch.arctan(Bf * a_f))
        Fy_r = mu * Fz_r * torch.sin(Cr * torch.arctan(Br * a_r))
        return (Fx_f, Fx_r), (Fy_f, Fy_r), (Fz_f, Fz_r)

    def dynamics(self, x: Tensor, u: Tensor, k: Tensor) -> Tensor:
        """Continuous dynamics (single_track_planar_model.cpp:302-332)."""
        cfg = self.base_config
        py = x[..., BaseXIndex.PY]
        phi = x[..., BaseXIndex.YAW]
        vx = x[..., BaseXIndex.VX]
        vy = x[..., BaseXIndex.VY]
        omega = x[..., BaseXIndex.VYAW]
        v_sq = vx * vx
        fd, fb, delta = self.split_lon_control(u)

        (Fx_f, Fx_r), (Fy_f, Fy_r), _ = self.tyre_forces(x, u)

        m = cfg.chassis.total_mass
        Jzz = cfg.chassis.moi
        l = cfg.chassis.wheel_base
        lr = cfg.chassis.cg_ratio * l
        lf = l - lr
        rho = cfg.aero.air_density
        cd = cfg.aero.drag_coeff
        A = cfg.aero.frontal_area

        cd_, sd_ = torch.cos(delta), torch.sin(delta)
        omega_dot = (1.0 / Jzz) * (
            -(2.0 * Fy_r) * lr + ((2.0 * Fy_f) * cd_ + (2.0 * Fx_f) * sd_) * lf)
        vx_dot = (1.0 / m) * (
            2.0 * Fx_r + 2.0 * Fx_f * cd_ - 2.0 * Fy_f * sd_
            - 0.5 * cd * rho * A * v_sq) + omega * vy
        vy_dot = (1.0 / m) * (2.0 * Fy_r + 2.0 * Fy_f * cd_ + 2.0 * Fx_f * sd_) - omega * vx

        px_dot = vx * torch.cos(phi) - vy * torch.sin(phi)
        py_dot = vx * torch.sin(phi) + vy * torch.cos(phi)
        phi_dot = omega
        if cfg.modeling.use_frenet:
            px_dot, phi_dot = self.frenet_correction(px_dot, phi_dot, py, k)

        return torch.stack([px_dot, py_dot, phi_dot, vx_dot, vy_dot, omega_dot], dim=-1)

    # base conversions (single_track_planar_model.cpp:390-417)
    def to_base_control(self, x: Tensor, u: Tensor) -> Tensor:
        if not self.config.simplify_lon_control:
            return u
        lon = u[..., SimpleUIndex.LON]
        return torch.stack([lon * _sigmoid(lon), lon * _sigmoid(-lon),
                            u[..., SimpleUIndex.STEER]], dim=-1)

    def from_base_control(self, x_base: Tensor, u_base: Tensor) -> Tensor:
        if not self.config.simplify_lon_control:
            return u_base
        fd = u_base[..., BaseUIndex.FD]
        fb = u_base[..., BaseUIndex.FB]
        lon = torch.where(torch.abs(fd) > torch.abs(fb), fd, fb)
        return torch.stack([lon, u_base[..., BaseUIndex.STEER]], dim=-1)

    def control_bounds(self) -> BoxBounds:
        """QP-path inequality data of ``add_nlp_constraints``
        (single_track_planar_model.cpp:113-158, `x`/`dui` branches)."""
        cfg = self.config
        steer_max = self.base_config.steer.max_steer
        steer_rate = self.base_config.steer.max_steer_rate
        if cfg.simplify_lon_control:
            u_lb = np.array([cfg.fb_max / 1000.0, -steer_max])
            u_ub = np.array([cfg.fd_max / 1000.0, steer_max])
            du_lb = np.array([cfg.fb_max / 1000.0 / cfg.tb, -steer_rate])
            du_ub = np.array([cfg.fd_max / 1000.0 / cfg.td, steer_rate])
        else:
            u_lb = np.array([0.0, cfg.fb_max, -steer_max])
            u_ub = np.array([cfg.fd_max, 0.0, steer_max])
            du_lb = np.array([-np.inf, cfg.fb_max / cfg.tb, -steer_rate])
            du_ub = np.array([cfg.fd_max / cfg.td, np.inf, steer_rate])
        return BoxBounds(u_lb, u_ub, du_lb, du_ub)

    def calc_lon_control(self, u) -> tuple[float, float]:
        """(throttle %, brake kPa) from a model control vector
        (``single_track.py:173-180``)."""
        fd, fb, _ = self.split_lon_control(torch.as_tensor(u, dtype=torch.float32))
        return self._throttle_or_brake(float(fd), float(fb))

    def calc_lat_control(self, u) -> float:
        idx = SimpleUIndex.STEER if self.config.simplify_lon_control else BaseUIndex.STEER
        return float(u[idx])


def _sigmoid(z: Tensor) -> Tensor:
    """1 / (1 + exp(-z)), the reference's expression (``jax_sigmoid``)."""
    return 1.0 / (1.0 + torch.exp(-z))
