"""Classic PID controller with integral clamping.

Port of ``racing_lmpc_tpu/control/pid.py`` (plain Python, copied; parity
target ``lmpc_utils/pid_controller.{hpp,cpp}``, the update law at
pid_controller.cpp:83-115): saturated integral, finite-difference
derivative, clamped command.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass
class PidCoefficients:
    k_p: float = 0.0
    k_i: float = 0.0
    k_d: float = 0.0
    min_cmd: float = -math.inf
    max_cmd: float = math.inf
    min_i: float = -math.inf
    max_i: float = math.inf


class PidController:
    def __init__(self, name: str = "pid",
                 coefficients: PidCoefficients | None = None):
        self.name = name
        self.coefficients = coefficients or PidCoefficients()
        self.integral_error = 0.0
        self._last_error = 0.0
        self._error = 0.0

    def reset_integral_error(self, value: float = 0.0):
        self.integral_error = value

    def update(self, new_error: float, actual_dt: float) -> float:
        if math.isnan(new_error):
            return math.nan
        c = self.coefficients
        self._last_error = self._error
        self._error = new_error
        self.integral_error = min(
            max(self.integral_error + new_error * actual_dt, c.min_i), c.max_i)
        dt_error = (self._error - self._last_error) / actual_dt
        cmd = (self._error * c.k_p + self.integral_error * c.k_i
               + dt_error * c.k_d)
        return min(max(cmd, c.min_cmd), c.max_cmd)
