"""Legacy full-dynamics tracking controller ("racing_lmpc").

Port of ``racing_lmpc_tpu/control/legacy_lmpc.py`` (parity target
``controllers/racing_lmpc/src/racing_lmpc.cpp``): despite the name a
*tracking* NLP controller (no safe set) with full nonlinear dynamics,
per-step boundary slack and a stage cost on contour, heading and velocity
(racing_lmpc.cpp:79-176).  The reference's IPOPT problem becomes an SQP
loop over the port's ``RacingMPC`` with ``learning=False``: each iteration
re-linearizes at the nonlinear rollout of the damped controls, with the
track data re-read at the rollout's abscissae, so at convergence the exact
dynamics hold.  The config mirrors ``RacingLMPCConfig``
(racing_lmpc_config.hpp:24-56).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from racing_lmpc_torch.config import RacingMPCConfig
from racing_lmpc_torch.models.base import VehicleModel
from racing_lmpc_torch.mpc.racing_mpc import MPCInput, MPCOutput, RacingMPC
from racing_lmpc_torch.track.trajectory import RacingTrajectory


@dataclass
class RacingLMPCLegacyConfig:
    """Mirrors ``RacingLMPCConfig`` field names."""
    max_cpu_time: float = 10.0
    max_iter: int = 1000
    tol: float = 1e-3
    n: int = 10
    margin: float = 0.0
    average_track_width: float = 1.0
    verbose: bool = False
    step_mode: str = "step"
    q_contour: float = 1.0
    q_heading: float = 1.0
    q_vel: float = 1.0
    q_boundary: float = 0.0
    r: tuple = ()
    x_max: tuple = ()
    x_min: tuple = ()
    u_max: tuple = ()
    u_min: tuple = ()
    sqp_iters: int = 8


class RacingLMPCLegacy:
    """Full-dynamics tracking controller over the shared SQP/QP solve, on the
    track's device."""

    def __init__(self, config: RacingLMPCLegacyConfig, model: VehicleModel,
                 track: RacingTrajectory):
        self.config = config
        self.model = model
        self.track = track
        self.device = track.device
        nu = model.nu
        r = config.r if config.r else tuple(np.eye(nu).ravel() * 0.01)
        self.mpc = RacingMPC(RacingMPCConfig(
            max_cpu_time=config.max_cpu_time, max_iter=config.max_iter,
            tol=config.tol, n=config.n, margin=config.margin,
            average_track_width=config.average_track_width,
            verbose=config.verbose, step_mode=config.step_mode,
            q_contour=config.q_contour, q_heading=config.q_heading,
            q_vel=config.q_vel, q_boundary=config.q_boundary,
            # the reference's legacy controller has no rate cost; the shared
            # QP needs curvature on the rates, so a small regularization
            # stands for "no rate cost", as in the reference (:68-73)
            r_d=tuple((np.eye(nu) * 1e-2).ravel()),
            r=r,
            x_max=config.x_max, x_min=config.x_min,
            u_max=config.u_max, u_min=config.u_min,
            learning=False), model, device=self.device)

    def _f32(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32).to(self.device)

    def _rollout(self, x_ic: torch.Tensor, U: torch.Tensor, dt: torch.Tensor) -> torch.Tensor:
        """Nonlinear rollout of ``U`` with the curvature at each state's own
        abscissa."""
        x, xs = x_ic, [x_ic]
        for u in U:
            x = self.model.discrete_dynamics(x, u, self.track.curvature(x[0]), dt)
            xs.append(x)
        return torch.stack(xs)

    def solve(self, x_ic, X_ref, U_ref, dt: float) -> MPCOutput:
        """One full-dynamics solve (racing_lmpc.cpp solve): SQP, damped by
        0.5, to a point where the nonlinear dynamics hold; returns the damped
        controls with their rollout."""
        N, nx, nu = self.config.n, self.model.nx, self.model.nu
        x_ic, X_ref, dt_t = self._f32(x_ic), self._f32(X_ref), self._f32(dt)

        def build(X_lin, U_lin):
            s = X_lin[:, 0]
            return MPCInput(
                x_ic=x_ic, u_ic=x_ic.new_zeros((nu,)), X_ref=X_lin, U_ref=U_lin,
                T_ref=dt_t.expand(N - 1).clone(),
                bound_left=self.track.left_boundary(s),
                bound_right=self.track.right_boundary(s),
                total_length=self._f32(self.track.total_length),
                curvatures=self.track.curvature(s),
                vel_ref=X_ref[:, self.mpc.idx_vel],
                ss_x=x_ic.new_zeros((0, nx)), ss_j=x_ic.new_zeros((0,)))

        out, z = self.mpc.solve(build(X_ref, self._f32(U_ref)))
        U = out.U_optm
        for _ in range(self.config.sqp_iters - 1):
            out, z = self.mpc.solve(build(self._rollout(x_ic, U, dt_t), U), z)
            U = U + 0.5 * (out.U_optm - U)
        return out._replace(X_optm=self._rollout(x_ic, U, dt_t), U_optm=U)
