"""Double-track planar model: four wheels, full Pacejka, lateral load transfer.

Port of ``racing_lmpc_tpu/models/double_track.py`` (parity target
``double_track_planar_model.cpp``).

State  x = (PX, PY, YAW, VYAW, SLIP, V)  — slip angle beta and speed
magnitude v, not the single-track's body velocities.
Control u = (FD, FB, STEER).

The lateral load transfer ``gamma_y`` is defined implicitly (the tyre forces
depend on it); as in the reference it is solved by ``NEWTON_ITERS`` fixed
Newton steps seeded at 0, each taking its slope by forward mode, so the
model's Jacobians differentiate through the solve.
"""

from __future__ import annotations

import enum

import numpy as np
import torch
from torch import Tensor

from racing_lmpc_torch.config import BaseVehicleConfig, DoubleTrackConfig
from racing_lmpc_torch.models.base import (
    GRAVITY, BaseUIndex, BaseXIndex, BoxBounds, VehicleModel)

NEWTON_ITERS = 8


class DtXIndex(enum.IntEnum):
    PX = 0
    PY = 1
    YAW = 2
    VYAW = 3
    SLIP = 4
    V = 5


class DoubleTrackPlanarModel(VehicleModel):
    def __init__(self, base_config: BaseVehicleConfig, config: DoubleTrackConfig):
        super().__init__(base_config)
        self.config = config
        self._constants = {}

    @property
    def nx(self) -> int:
        return 6

    @property
    def nu(self) -> int:
        return 3

    def cost_state_indices(self) -> dict:
        """Layout (PX, PY, YAW, VYAW, SLIP, V): V carries the velocity
        weight, VYAW the yaw-rate weight, and no coordinate the lateral
        velocity's (``double_track.py:61-74``)."""
        return {
            "contour": int(DtXIndex.PY),
            "heading": int(DtXIndex.YAW),
            "vel": int(DtXIndex.V),
            "vy": None,
            "vyaw": int(DtXIndex.VYAW),
        }

    def state_scales(self):
        """Per-quantity scales permuted into the (.., VYAW, SLIP, V) order
        (slip is an angle: the yaw-class scale)."""
        return np.array([2000.0, 10.0, 0.1, 2.0, 0.1, 80.0])

    def _wheel_constants(self, like: Tensor) -> dict:
        """Per-wheel (FL, FR, RL, RR) constants as tensors of the dtype and
        on the device of ``like``, made once (a copy to the card each call
        would stall the host): every wheel's arithmetic is the scalar
        expression of the reference with its axle's constant, evaluated for
        the four wheels at once."""
        key = (like.device, like.dtype)
        if key in self._constants:
            return self._constants[key]
        cfg = self.base_config
        ft, rt = cfg.front_tyre, cfg.rear_tyre
        kroll = self.config.kroll_f
        twf, twr = cfg.chassis.tw_f, cfg.chassis.tw_r

        def w(front, rear):
            return torch.tensor(front + rear, dtype=like.dtype, device=like.device)
        c = {"B": w([ft.pacejka_b] * 2, [rt.pacejka_b] * 2),
             "C": w([ft.pacejka_c] * 2, [rt.pacejka_c] * 2),
             "E": w([ft.pacejka_e] * 2, [rt.pacejka_e] * 2),
             "eps": w([ft.pacejka_eps] * 2, [rt.pacejka_eps] * 2),
             "Fz0": w([ft.pacejka_fz0] * 2, [rt.pacejka_fz0] * 2),
             # x_b -+ 0.5 tw omega, written x_b + (-+0.5 tw) omega (the same
             # numbers: negation is exact)
             "half_tw": w([-0.5 * twf, 0.5 * twf], [-0.5 * twr, 0.5 * twr]),
             # Fz_axle -+ k gamma with k = kroll front, 1 - kroll rear
             "roll": w([-kroll, kroll], [-(1.0 - kroll), 1.0 - kroll])}
        self._constants[key] = c
        return c

    def _load_free_terms(self, x: Tensor, u: Tensor, c: dict):
        """The parts of the wheel forces that do not depend on the load
        transfer: per-wheel Fx, per-wheel axle load Fz (before the
        transfer) and the Pacejka shape factor sin(C atan(Ba - E (Ba - atan
        Ba))) of each wheel, each (..., 4)."""
        cfg = self.base_config
        omega = x[..., DtXIndex.VYAW]
        beta = x[..., DtXIndex.SLIP]
        v = x[..., DtXIndex.V]
        fd = u[..., BaseUIndex.FD]
        fb = u[..., BaseUIndex.FB]
        delta = u[..., BaseUIndex.STEER]
        v_sq = v * v

        Fx_f, Fx_r = self._axle_longitudinal_forces(fd, fb)
        ax = self._longitudinal_accel(fd, fb, v_sq)

        l = cfg.chassis.wheel_base
        lr = cfg.chassis.cg_ratio * l
        lf = l - lr
        h = cfg.chassis.cg_height
        rho, A = cfg.aero.air_density, cfg.aero.frontal_area
        m = cfg.chassis.total_mass

        # the lr lever arm for BOTH axles, as the reference has it
        # (double_track_planar_model.cpp:230-236)
        Fz_f = (0.5 * m * GRAVITY * lr / (lf + lr) - 0.5 * h / (lf + lr) * m * ax
                + 0.25 * cfg.aero.cl_f * rho * A * v_sq)
        Fz_r = (0.5 * m * GRAVITY * lr / (lf + lr) + 0.5 * h / (lf + lr) * m * ax
                + 0.25 * cfg.aero.cl_r * rho * A * v_sq)

        vx_b = v * torch.cos(beta)
        vy_b = v * torch.sin(beta)
        num_f = lf * omega + vy_b
        num_r = lr * omega - vy_b
        t = torch.arctan(torch.stack([num_f, num_f, num_r, num_r], dim=-1)
                         / (vx_b[..., None] + c["half_tw"] * omega[..., None]))
        # slip angles: delta - atan(.) at the front, atan(.) at the rear
        alpha = torch.cat([delta[..., None] - t[..., :2], t[..., 2:]], dim=-1)
        Ba = c["B"] * alpha
        S = torch.sin(c["C"] * torch.arctan(Ba - c["E"] * (Ba - torch.arctan(Ba))))
        Fx = torch.stack([Fx_f, Fx_f, Fx_r, Fx_r], dim=-1)
        Fz_axle = torch.stack([Fz_f, Fz_f, Fz_r, Fz_r], dim=-1)
        return Fx, Fz_axle, S

    def forces_given_gamma(self, x: Tensor, u: Tensor, gamma_y: Tensor):
        """Per-wheel (FL, FR, RL, RR) forces (Fx, Fy, Fz), each (..., 4),
        given the load transfer: full Pacejka with E-term and load
        sensitivity (double_track_planar_model.cpp:216-256;
        ``double_track.py:81-146``)."""
        c = self._wheel_constants(x)
        Fx, Fz_axle, S = self._load_free_terms(x, u, c)
        Fz = Fz_axle + c["roll"] * gamma_y[..., None]
        Fy = self.config.mu * Fz * (1.0 + c["eps"] * Fz / c["Fz0"]) * S
        return Fx, Fy, Fz

    def _gamma_residual(self, gamma_y: Tensor, x: Tensor, u: Tensor) -> Tensor:
        """Residual of the implicit load-transfer equation (:316-327)."""
        cfg = self.base_config
        delta = u[..., BaseUIndex.STEER]
        twf, twr = cfg.chassis.tw_f, cfg.chassis.tw_r
        h = cfg.chassis.cg_height
        Fx, Fy, _ = self.forces_given_gamma(x, u, gamma_y)
        lat = (Fy[..., 2] + Fy[..., 3]
               + (Fx[..., 0] + Fx[..., 1]) * torch.sin(delta)
               + (Fy[..., 0] + Fy[..., 1]) * torch.cos(delta))
        return gamma_y - h / (0.5 * (twf + twr)) * lat

    def solve_gamma_y(self, x: Tensor, u: Tensor) -> Tensor:
        """``NEWTON_ITERS`` fixed Newton steps for gamma_y, seeded at 0 as the
        reference's rootfinder call (:329-331; ``double_track.py:160-168``).

        Each step's slope d(residual)/d(gamma_y) is the forward-mode tangent
        of the residual for the tangent 1 on gamma_y, pushed through the
        residual's gamma-dependent operations by hand in the order of the
        product and sum rules the reference's ``jax.jvp`` applies (the
        gamma-free terms carry a zero tangent; each wheel load's tangent is
        its roll factor).  ``torch.func.jvp`` nested in the model Jacobian's
        own forward mode gives the same numbers at several times the host
        time of every operation (tests/torch_port_forward_ad_cost.py), which
        made one double-track linearization take seconds.
        """
        cfg = self.base_config
        delta = u[..., BaseUIndex.STEER]
        h_tw = cfg.chassis.cg_height / (0.5 * (cfg.chassis.tw_f + cfg.chassis.tw_r))
        mu = self.config.mu
        c = self._wheel_constants(x)
        Fx, Fz_axle, S = self._load_free_terms(x, u, c)
        cos_d = torch.cos(delta)
        lon = (Fx[..., 0] + Fx[..., 1]) * torch.sin(delta)
        # the tangents of mu Fz and of eps Fz / Fz0 for the tangent roll on Fz
        d_muFz = mu * c["roll"]
        d_load = c["eps"] * c["roll"] / c["Fz0"]
        g = x.new_zeros(x.shape[:-1])
        for _ in range(NEWTON_ITERS):
            Fz = Fz_axle + c["roll"] * g[..., None]
            muFz = mu * Fz
            load = 1.0 + c["eps"] * Fz / c["Fz0"]
            Fy = muFz * load * S
            # d(muFz load) = d(muFz) load + muFz d(load), times the gamma-free S
            dFy = (d_muFz * load + muFz * d_load) * S
            r = g - h_tw * (Fy[..., 2] + Fy[..., 3] + lon + (Fy[..., 0] + Fy[..., 1]) * cos_d)
            dr = 1.0 - h_tw * ((dFy[..., 2] + dFy[..., 3]) + (dFy[..., 0] + dFy[..., 1]) * cos_d)
            g = g - r / dr
        return g

    def dynamics(self, x: Tensor, u: Tensor, k: Tensor) -> Tensor:
        """Continuous dynamics (double_track_planar_model.cpp:258-283) with the
        load transfer resolved by Newton iteration."""
        cfg = self.base_config
        py = x[..., DtXIndex.PY]
        phi = x[..., DtXIndex.YAW]
        omega = x[..., DtXIndex.VYAW]
        beta = x[..., DtXIndex.SLIP]
        v = x[..., DtXIndex.V]
        delta = u[..., BaseUIndex.STEER]
        v_sq = v * v

        gamma_y = self.solve_gamma_y(x, u)
        Fx, Fy, _ = self.forces_given_gamma(x, u, gamma_y)
        Fx_fl, Fx_fr, Fx_rl, Fx_rr = Fx.unbind(-1)
        Fy_fl, Fy_fr, Fy_rl, Fy_rr = Fy.unbind(-1)

        m = cfg.chassis.total_mass
        Jzz = cfg.chassis.moi
        l = cfg.chassis.wheel_base
        lr = cfg.chassis.cg_ratio * l
        lf = l - lr
        twf, twr = cfg.chassis.tw_f, cfg.chassis.tw_r
        rho, A, cd = cfg.aero.air_density, cfg.aero.frontal_area, cfg.aero.drag_coeff

        cb, sb = torch.cos(beta), torch.sin(beta)
        cdb, sdb = torch.cos(delta - beta), torch.sin(delta - beta)
        v_dot = (1.0 / m) * (
            (Fx_rl + Fx_rr) * cb + (Fx_fl + Fx_fr) * cdb + (Fy_rl + Fy_rr) * sb
            - (Fy_fl + Fy_fr) * sdb - 0.5 * cd * rho * A * v_sq * cb)
        beta_dot = -omega + (1.0 / (m * v)) * (
            -(Fx_rl + Fx_rr) * sb + (Fx_fl + Fx_fr) * sdb + (Fy_rl + Fy_rr) * cb
            + (Fy_fl + Fy_fr) * cdb + 0.5 * cd * rho * A * v_sq * sb)
        omega_dot = (1.0 / Jzz) * (
            (Fx_rr - Fx_rl) * twr / 2.0 - (Fy_rl + Fy_rr) * lr
            + ((Fx_fr - Fx_fl) * torch.cos(delta) + (Fy_fl - Fy_fr) * torch.sin(delta)) * twf / 2.0
            + ((Fy_fl + Fy_fr) * torch.cos(delta) + (Fx_fl + Fx_fr) * torch.sin(delta)) * lf)

        vx = v * torch.cos(phi + beta)
        vy = v * torch.sin(phi + beta)
        phi_dot = omega
        if cfg.modeling.use_frenet:
            vx, phi_dot = self.frenet_correction(vx, phi_dot, py, k)

        return torch.stack([vx, vy, phi_dot, omega_dot, beta_dot, v_dot], dim=-1)

    # -- base conversions ----------------------------------------------------
    def to_base_state(self, x: Tensor, u: Tensor) -> Tensor:
        beta = x[..., DtXIndex.SLIP]
        v = x[..., DtXIndex.V]
        return torch.stack([
            x[..., DtXIndex.PX],
            x[..., DtXIndex.PY],
            x[..., DtXIndex.YAW],
            v * torch.cos(beta),
            v * torch.sin(beta),
            x[..., DtXIndex.VYAW],
        ], dim=-1)

    def from_base_state(self, x_base: Tensor, u_base: Tensor) -> Tensor:
        vx = x_base[..., BaseXIndex.VX]
        vy = x_base[..., BaseXIndex.VY]
        return torch.stack([
            x_base[..., BaseXIndex.PX],
            x_base[..., BaseXIndex.PY],
            x_base[..., BaseXIndex.YAW],
            x_base[..., BaseXIndex.VYAW],
            torch.arctan2(vy, vx),
            torch.hypot(vx, vy),
        ], dim=-1)

    def control_bounds(self) -> BoxBounds:
        """Linear bounds from ``add_nlp_constraints`` (:121-137)."""
        cfg = self.config
        steer_max = self.base_config.steer.max_steer
        steer_rate = self.base_config.steer.max_steer_rate
        u_lb = np.array([0.0, cfg.fb_max, -steer_max])
        u_ub = np.array([cfg.fd_max, 0.0, steer_max])
        du_lb = np.array([-np.inf, cfg.fb_max / cfg.tb, -steer_rate])
        du_ub = np.array([cfg.fd_max / cfg.td, np.inf, steer_rate])
        return BoxBounds(u_lb, u_ub, du_lb, du_ub)

    def friction_ellipse(self, x: Tensor, u: Tensor) -> Tensor:
        """Per-wheel friction-ellipse residuals (<= 0 feasible), :106-110;
        ``gamma_y`` solved again, as the reference does."""
        gamma_y = self.solve_gamma_y(x, u)
        Fx, Fy, Fz = self.forces_given_gamma(x, u, gamma_y)
        mu = self.config.mu
        return (Fx / (mu * Fz)) ** 2 + (Fy / (mu * Fz)) ** 2 - 1.0

    # 4 friction-ellipse rows + power + exclusivity + v >= 0
    n_nl: int = 7

    def nl_constraints(self, x: Tensor, u: Tensor, k: Tensor) -> Tensor:
        """The double-track inequality set (double_track_planar_model.cpp:
        106-126): four friction ellipses, v*fd <= P_max, (fd*fb)^2 <= 1 and
        v >= 0.  The reference's algebraic ``gamma_y`` row is satisfied
        inside the force graph and adds no row (``double_track.py:255-265``)."""
        v = x[..., DtXIndex.V]
        fd = u[..., BaseUIndex.FD]
        fb = u[..., BaseUIndex.FB]
        return torch.cat([
            self.friction_ellipse(x, u),
            torch.stack([v * fd - self.config.p_max,
                         (fd * fb) ** 2 - 1.0,
                         -v], dim=-1),
        ], dim=-1)

    def calc_lon_control(self, u) -> tuple[float, float]:
        return self._throttle_or_brake(float(u[BaseUIndex.FD]), float(u[BaseUIndex.FB]))

    def calc_lat_control(self, u) -> float:
        return float(u[BaseUIndex.STEER])
