"""Vehicle-model interface: the part of ``racing_lmpc_tpu/models/base.py``
(``:77-200``) that the MPC solve uses.

Dynamics are elementwise over leading batch dimensions.  The discrete
Jacobian that JAX takes with ``jax.jacfwd`` under ``vmap`` is forward mode
here too: ``torch.func.vmap`` of ``torch.func.jvp`` over the basis tangents,
each tangent pushed through the whole batch at once.
The base state/control conversions the simulator uses are here
(``base.py:99``, ``:135-145``); the throttle/brake lookup helpers
(``base.py:203-277``) are not on any ported path and are not ported yet.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch
from torch import Tensor

from racing_lmpc_torch.config import BaseVehicleConfig
from racing_lmpc_torch.ops.integrators import integrate

GRAVITY = 9.8


class BaseXIndex(enum.IntEnum):
    PX = 0
    PY = 1
    YAW = 2
    VX = 3
    VY = 4
    VYAW = 5


class BaseUIndex(enum.IntEnum):
    FD = 0
    FB = 1
    STEER = 2


@dataclass(frozen=True)
class BoxBounds:
    """Per-stage linear bounds contributed by a model to the MPC QP:
    (lower, upper) arrays over the control / control-rate vector."""
    u_lb: np.ndarray
    u_ub: np.ndarray
    du_lb: np.ndarray   # bounds on the rate variable du (per second)
    du_ub: np.ndarray


class VehicleModel:
    """Abstract vehicle model.

    Subclasses implement ``nx``/``nu``, ``dynamics`` (continuous, with local
    curvature ``k`` for Frenet mode) and ``control_bounds``.  Discretization
    and Jacobians are derived here.
    """

    def __init__(self, base_config: BaseVehicleConfig):
        self.base_config = base_config

    @property
    def nx(self) -> int:
        raise NotImplementedError

    @property
    def nu(self) -> int:
        raise NotImplementedError

    # number of rows of the model's nonlinear stage constraints (none on
    # the single-track model; the constraint rows wait for a later slice)
    n_nl: int = 0
    # base control layout (FD, FB, STEER) the simulator and actuation speak
    nu_base: int = 3

    def dynamics(self, x: Tensor, u: Tensor, k: Tensor) -> Tensor:
        """Continuous dynamics x_dot = f(x, u, k)."""
        raise NotImplementedError

    def discrete_dynamics(self, x: Tensor, u: Tensor, k: Tensor, dt: Tensor) -> Tensor:
        """One integration step (RK4 or Euler per modeling config)."""
        return integrate(self.dynamics, x, u, k, dt,
                         method=self.base_config.modeling.integrator_type)

    def _forward_jacobian(self, fn, x: Tensor, u: Tensor):
        """(fn(x, u), d fn/dx, d fn/du) by forward mode over any leading batch
        shape: jacfwd is vmap-over-jvp of the basis tangents, each pushed
        through the whole batch at once; vmapping the batch instead
        (per-sample jacfwd) would make 0-d intermediates, whose forward-mode
        tangents PyTorch 2.13 promotes to float64."""
        nx, nu = x.shape[-1], u.shape[-1]

        def column(t):
            return torch.func.jvp(fn, (x, u), (t[:nx].expand_as(x), t[nx:].expand_as(u)))

        eye = torch.eye(nx + nu, dtype=x.dtype, device=x.device)
        y, J = torch.func.vmap(column, out_dims=(None, 0))(eye)
        J = torch.movedim(J, 0, -1)                      # (..., ny, nx + nu)
        return y, J[..., :nx], J[..., nx:]

    def dynamics_jacobian(self, x: Tensor, u: Tensor, k: Tensor) -> tuple[Tensor, Tensor]:
        """Continuous-time (A, B) = (df/dx, df/du) by forward mode
        (``base.py:106-110``), over any leading batch shape."""
        _, A, B = self._forward_jacobian(lambda xx, uu: self.dynamics(xx, uu, k), x, u)
        return A, B

    def discrete_dynamics_jacobian(
        self, x: Tensor, u: Tensor, k: Tensor, dt: Tensor
    ) -> tuple[Tensor, Tensor, Tensor]:
        """Discrete (A, B, g) with affine remainder g = x+ - A x - B u, over
        any leading batch shape of ``x`` (..., nx), ``u`` (..., nu), ``k``
        and ``dt`` (...).

        Matches ``single_track_planar_model.cpp:377-387``: the remainder
        makes ``A x + B u + g`` the exact value of the integrator at the
        linearization point.
        """
        xn, A, B = self._forward_jacobian(
            lambda xx, uu: self.discrete_dynamics(xx, uu, k, dt), x, u)
        g = (xn - torch.matmul(A, x.unsqueeze(-1))[..., 0]
             - torch.matmul(B, u.unsqueeze(-1))[..., 0])
        return A, B, g

    # base conversions: identities unless a model overrides them
    def to_base_state(self, x: Tensor, u: Tensor) -> Tensor:
        return x

    def from_base_state(self, x_base: Tensor, u_base: Tensor) -> Tensor:
        return x_base

    def to_base_control(self, x: Tensor, u: Tensor) -> Tensor:
        return u

    def from_base_control(self, x_base: Tensor, u_base: Tensor) -> Tensor:
        return u_base

    def cost_state_indices(self) -> dict:
        """Where contour / heading / velocity / vy / vyaw live in THIS
        model's state layout, for the MPC stage cost (``base.py:155-170``)."""
        nx = self.nx
        return {
            "contour": int(BaseXIndex.PY),
            "heading": int(BaseXIndex.YAW),
            "vel": int(BaseXIndex.VX) if nx == 6 else nx - 1,
            "vy": int(BaseXIndex.VY) if nx == 6 else None,
            "vyaw": int(BaseXIndex.VYAW) if nx == 6 else None,
        }

    def state_scales(self):
        """Optional per-model override of the MPC's fixed diagonal state
        scaling; None uses the positional default (``base.py:172-178``)."""
        return None

    def control_bounds(self) -> BoxBounds:
        raise NotImplementedError

    # -- axle-level force helpers shared by the planar models ----------------
    def _axle_longitudinal_forces(self, fd: Tensor, fb: Tensor):
        """Per-axle longitudinal tyre forces incl. rolling resistance split.
        Returns (Fx_front_per_wheel, Fx_rear_per_wheel)."""
        cfg = self.base_config
        kd = cfg.powertrain.kd
        kb = cfg.front_brake.bias
        m = cfg.chassis.total_mass
        l = cfg.chassis.wheel_base
        lr = cfg.chassis.cg_ratio * l
        lf = l - lr
        fr = cfg.chassis.fr
        Fx_f = 0.5 * kd * fd + 0.5 * kb * fb - 0.5 * fr * m * GRAVITY * lr / l
        Fx_r = 0.5 * (1.0 - kd) * fd + 0.5 * (1.0 - kb) * fb - 0.5 * fr * m * GRAVITY * lf / l
        return Fx_f, Fx_r

    def _longitudinal_accel(self, fd: Tensor, fb: Tensor, v_sq: Tensor) -> Tensor:
        """ax with aero drag and rolling resistance."""
        cfg = self.base_config
        m = cfg.chassis.total_mass
        cd = cfg.aero.drag_coeff
        A = cfg.aero.frontal_area
        fr = cfg.chassis.fr
        return (fd + fb - 0.5 * cd * A * v_sq - fr * m * GRAVITY) / m

    def _vertical_loads(self, ax: Tensor, v_sq: Tensor):
        """Per-wheel vertical loads with longitudinal transfer + downforce.
        Returns (Fz_front_per_wheel, Fz_rear_per_wheel)."""
        cfg = self.base_config
        m = cfg.chassis.total_mass
        l = cfg.chassis.wheel_base
        lr = cfg.chassis.cg_ratio * l
        lf = l - lr
        h = cfg.chassis.cg_height
        rho = cfg.aero.air_density
        A = cfg.aero.frontal_area
        Fz_f = (0.5 * m * GRAVITY * lr / (lf + lr) - 0.5 * h / (lf + lr) * m * ax
                + 0.25 * cfg.aero.cl_f * rho * A * v_sq)
        Fz_r = (0.5 * m * GRAVITY * lf / (lf + lr) + 0.5 * h / (lf + lr) * m * ax
                + 0.25 * cfg.aero.cl_r * rho * A * v_sq)
        return Fz_f, Fz_r

    @staticmethod
    def frenet_correction(px_dot: Tensor, phi_dot: Tensor, py: Tensor, k: Tensor):
        """Global->Frenet rate conversion: s_dot = px_dot/(1 - t*kappa),
        xi_dot = phi_dot - kappa*s_dot."""
        s_dot = px_dot / (1.0 - py * k)
        return s_dot, phi_dot - k * s_dot
