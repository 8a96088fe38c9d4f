"""Geometric baseline controller: pure pursuit + PID longitudinal.

Port of ``racing_lmpc_tpu/control/vanilla.py`` (parity target
``vanilla_controller/src/vanilla_controller.cpp:49-109``): a host control law
whose two Frenet -> global conversions run on the track's device in f32, as
the reference's run on its device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from racing_lmpc_torch.control.pid import PidCoefficients, PidController
from racing_lmpc_torch.models.base import GRAVITY, BaseXIndex, VehicleModel
from racing_lmpc_torch.ops.math import align_abscissa, wrap_to_pi
from racing_lmpc_torch.track.trajectory import RacingTrajectory


@dataclass
class VanillaControllerConfig:
    """Mirrors vanilla_controller_config.hpp:30-50."""
    lookahead_speed_ratio: float = 1.0
    min_lookahead_distance: float = 1.0
    max_lookahead_distance: float = 10.0
    lon_pid_coeffs: PidCoefficients = field(default_factory=PidCoefficients)
    dt: float = 0.1
    step_mode: str = "step"


class VanillaController:
    def __init__(self, config: VanillaControllerConfig, model: VehicleModel,
                 track: RacingTrajectory):
        self.config = config
        self.model = model
        self.track = track
        self.pid = PidController("lon_pid", config.lon_pid_coeffs)

    def _f32(self, v) -> torch.Tensor:
        return torch.as_tensor(np.asarray(v, dtype=np.float32), device=self.track.device)

    def solve(self, x_ic: np.ndarray, vel_ref: float) -> np.ndarray:
        """One step: returns the base control (fd, fb, steer).

        ``x_ic`` is the base state in Frenet coordinates (s, t, xi, vx, vy, w).
        """
        cfg = self.config
        chassis = self.model.base_config.chassis
        aero = self.model.base_config.aero
        steer_cfg = self.model.base_config.steer
        L = self.track.total_length

        # current global pose (vanilla_controller.cpp:61-66)
        pf = self._f32([x_ic[BaseXIndex.PX], x_ic[BaseXIndex.PY], x_ic[BaseXIndex.YAW]])
        pg = self.track.frenet_to_global(pf).cpu().numpy()

        # pure pursuit target on the centerline (cpp:68-80)
        v = float(np.hypot(x_ic[BaseXIndex.VX], x_ic[BaseXIndex.VY]))
        lookahead = float(np.clip(
            v * cfg.lookahead_speed_ratio,
            cfg.min_lookahead_distance, cfg.max_lookahead_distance))
        s_look = float(align_abscissa(
            self._f32(x_ic[BaseXIndex.PX] + lookahead), self._f32(L / 2.0), self._f32(L)))
        tg = self.track.frenet_to_global(self._f32([s_look, 0.0, 0.0])).cpu().numpy()

        # steering (cpp:82-89)
        direction = np.arctan2(tg[1] - pg[1], tg[0] - pg[0])
        alpha = float(wrap_to_pi(self._f32(direction - pg[2])))
        delta = np.arctan(2.0 * chassis.wheel_base * np.sin(alpha) / lookahead)
        delta = float(np.clip(delta, -steer_cfg.max_steer, steer_cfg.max_steer))

        # longitudinal force with aero/rolling feedforward (cpp:91-105)
        acc = self.pid.update(vel_ref - v, cfg.dt)
        aero_res = 0.5 * aero.air_density * aero.frontal_area * aero.drag_coeff * v * v
        down_force = aero_res * (aero.cl_f + aero.cl_r)
        rolling = chassis.fr * (chassis.total_mass * GRAVITY + down_force)
        force = chassis.total_mass * acc + rolling + aero_res
        fd = max(force, 0.0)
        fb = min(force, 0.0)
        return np.array([fd, fb, delta])
