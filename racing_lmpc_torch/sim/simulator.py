"""Vehicle plant simulator.

Port of ``racing_lmpc_tpu/sim/simulator.py`` (racing_simulator.cpp:46-69,
97-112): one composed plant step clamps |vx| >= 1e-6, converts the base
control to the model's, advances the discrete dynamics with the curvature
at the current abscissa (Frenet models) and wraps the abscissa (Frenet) or
the yaw (global).  The state lives on the simulator's device (CUDA unless
the caller names one); ``rollout`` is a Python loop over the steps.
"""

from __future__ import annotations

import torch
from torch import Tensor

from racing_lmpc_torch import resolve_device
from racing_lmpc_torch.config import SimulatorConfig
from racing_lmpc_torch.models.base import VehicleModel
from racing_lmpc_torch.ops.math import align_abscissa, align_yaw
from racing_lmpc_torch.track.trajectory import RacingTrajectory


class RacingSimulator:
    def __init__(self, config: SimulatorConfig, model: VehicleModel,
                 track: RacingTrajectory, device=None):
        self.config = config
        self.model = model
        self.track = track
        self.device = resolve_device(device)
        self._dt = torch.tensor(config.dt, dtype=torch.float32, device=self.device)
        self.x = torch.tensor(config.x0, dtype=torch.float32, device=self.device)
        self.u = torch.zeros(model.nu_base, dtype=torch.float32, device=self.device)

    def step_fn(self, x: Tensor, u_base: Tensor) -> Tensor:
        """One composed plant step over any leading batch shape."""
        model = self.model
        use_frenet = model.base_config.modeling.use_frenet
        vx_idx = 3 if model.nx >= 6 else model.nx - 1
        vx = x[..., vx_idx]
        x = x.clone()
        x[..., vx_idx] = torch.where(torch.abs(vx) < 1e-6,
                                     torch.copysign(torch.full_like(vx, 1e-6), vx), vx)
        u = model.from_base_control(x, u_base)
        k = (self.track.curvature(x[..., 0]) if use_frenet
             else torch.zeros_like(x[..., 0]))
        xp = model.discrete_dynamics(x, u, k, self._dt)
        if use_frenet:
            L = torch.as_tensor(self.track.total_length, dtype=x.dtype, device=x.device)
            xp[..., 0] = align_abscissa(xp[..., 0], L / 2.0, L)
        else:
            xp[..., 2] = align_yaw(xp[..., 2], torch.zeros_like(xp[..., 2]))
        return xp

    def step(self, u_base) -> Tensor:
        """Stateful single step (the ROS node's usage)."""
        self.u = torch.as_tensor(u_base, dtype=self.x.dtype).to(self.device)
        self.x = self.step_fn(self.x, self.u)
        return self.x

    def set_state(self, x):
        self.x = torch.as_tensor(x, dtype=torch.float32).to(self.device)

    def rollout(self, x0: Tensor, us_base: Tensor) -> Tensor:
        """Roll the composed step over a control sequence: ``x0`` (nx,) or
        (B, nx), ``us_base`` (T, nu_base) or (B, T, nu_base).  Returns the
        state trajectory (T, nx) or (B, T, nx)."""
        xs, x = [], x0
        for t in range(us_base.shape[-2]):
            x = self.step_fn(x, us_base[..., t, :])
            xs.append(x)
        return torch.stack(xs, dim=-2)
