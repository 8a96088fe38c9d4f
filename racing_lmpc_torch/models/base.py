"""Vehicle-model interface: the part of ``racing_lmpc_tpu/models/base.py``
(``:77-200``) that the MPC solve uses.

Dynamics are elementwise over leading batch dimensions.  The discrete
Jacobian that JAX takes with ``jax.jacfwd`` under ``vmap`` is forward mode
here too: ``torch.func.vmap`` of ``torch.func.jvp`` over the basis tangents,
each tangent pushed through the whole batch at once.
The base state/control conversions the simulator uses are here
(``base.py:99``, ``:135-145``), with the nonlinear stage-constraint default
(``:184-201``) and the actuator maps (``:203-277``), host scalar maps that
return Python floats as the reference's do.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np
import torch
from torch import Tensor

from racing_lmpc_torch.config import BaseVehicleConfig
from racing_lmpc_torch.ops.integrators import integrate
from racing_lmpc_torch.ops.lookup import _fast_linear, bilinear_interpolate

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


@dataclass
class VehicleState:
    """Low-rate hardware state used by the actuator maps
    (``BaseVehicleModelState``, ``base.py:51-59``)."""
    wheel_speeds: np.ndarray = field(default_factory=lambda: np.zeros(4))
    engine_rpm: float = 0.0
    gear: int = 1


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
        self.vehicle_state = VehicleState()

    @property
    def nx(self) -> int:
        raise NotImplementedError

    @property
    def nu(self) -> int:
        raise NotImplementedError

    # number of rows ``nl_constraints`` returns (static, per model)
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

    def to_base_state_jacobian(self, x: Tensor, u: Tensor) -> tuple[Tensor, Tensor]:
        """(d to_base_state/dx, d to_base_state/du) by forward mode
        (``base.py:147-152``), over any leading batch shape: the base-state
        stage costs of models whose base conversion is nonlinear."""
        _, Jx, Ju = self._forward_jacobian(self.to_base_state, x, u)
        return Jx, Ju

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

    def nl_constraints(self, x: Tensor, u: Tensor, k: Tensor) -> Tensor:
        """Stage-wise nonlinear inequality residuals g(x, u, k) <= 0, over
        any leading batch shape (``base.py:184-201``): the MPC linearizes
        them at its reference each solve.  Default: no rows."""
        return x.new_zeros(x.shape[:-1] + (0,))

    # -- actuator maps (base_vehicle_model.cpp:131-246) ----------------------
    def _torque_lookup(self, throttle) -> Tensor:
        """Engine torque at the state's rpm and ``throttle`` (f32 on the
        host, as the reference's lookup runs in f32)."""
        pt = self.base_config.powertrain
        f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)  # noqa: E731
        return bilinear_interpolate(f32(pt.rpm), f32(pt.throttle), f32(pt.torque_table()),
                                    self.vehicle_state.engine_rpm, throttle)

    def calc_throttle(self, fd: float) -> float:
        """Drive force (N) -> throttle % via the inverse engine-torque
        lookup (``base.py:204-230``)."""
        pt = self.base_config.powertrain
        state = self.vehicle_state
        if state.gear > len(pt.gear_ratio):
            return 0.0
        ft = self.base_config.front_tyre
        rt = self.base_config.rear_tyre
        target_front = fd * ft.radius * pt.kd
        target_rear = fd * rt.radius * (1.0 - pt.kd)
        target_wheel = (target_front + target_rear) / pt.mechanical_efficiency
        target_engine = target_wheel / (pt.gear_ratio[state.gear - 1] * pt.final_drive_ratio)
        sample = self.base_config.modeling.sample_throttle
        t_min = self._torque_lookup(0.0)
        t_smp = self._torque_lookup(sample)
        t_max = self._torque_lookup(100.0)
        lo = _fast_linear(t_min, t_smp, 0.0, sample, target_engine, False)
        hi = _fast_linear(t_smp, t_max, sample, 100.0, target_engine, False)
        return float(torch.where(target_engine < t_smp, lo, hi))

    def calc_brake(self, fb: float) -> float:
        """Brake force (N, negative) -> master-cylinder kPa, with the
        reference's front-only clamp of the return value (``base.py:232-245``)."""
        if fb > 0.0:
            return 0.0
        fbc = self.base_config.front_brake
        front_torque = fbc.bias * fb * self.base_config.front_tyre.radius * fbc.bias
        lever = (fbc.brake_pad_in_r + fbc.brake_pad_out_r) / 2.0
        kpa = -0.001 * front_torque / (lever * fbc.brake_pad_friction_coeff * fbc.piston_area)
        return float(np.clip(kpa, 0.0, fbc.max_brake))

    def calc_drive_force(self, throttle: float) -> float:
        """Throttle % -> drive force (N) via the forward torque lookup
        (``base.py:247-262``)."""
        pt = self.base_config.powertrain
        state = self.vehicle_state
        throttle = float(np.clip(throttle, 0.0, 100.0))
        if state.gear > len(pt.gear_ratio):
            return 0.0
        engine_torque = float(self._torque_lookup(throttle))
        wheel_torque = engine_torque * pt.gear_ratio[state.gear - 1] * pt.final_drive_ratio
        front = wheel_torque * pt.kd / self.base_config.front_tyre.radius
        rear = wheel_torque * (1.0 - pt.kd) / self.base_config.rear_tyre.radius
        return front + rear

    def calc_brake_force(self, brake_kpa: float) -> float:
        """Master-cylinder kPa -> total brake force (N) (``base.py:264-277``)."""
        fbc = self.base_config.front_brake
        rbc = self.base_config.rear_brake
        f_kpa = float(np.clip(fbc.bias * brake_kpa, 0.0, fbc.max_brake))
        r_kpa = float(np.clip(rbc.bias * brake_kpa, 0.0, rbc.max_brake))
        f_lever = (fbc.brake_pad_in_r + fbc.brake_pad_out_r) / 2.0
        r_lever = (rbc.brake_pad_in_r + rbc.brake_pad_out_r) / 2.0
        f_torque = f_kpa * 1000.0 * fbc.piston_area * fbc.brake_pad_friction_coeff * f_lever
        r_torque = r_kpa * 1000.0 * rbc.piston_area * rbc.brake_pad_friction_coeff * r_lever
        return (f_torque / self.base_config.front_tyre.radius
                + r_torque / self.base_config.rear_tyre.radius)

    def _throttle_or_brake(self, fd: float, fb: float) -> tuple[float, float]:
        """(throttle %, brake kPa): the dominant force channel drives its
        actuator map, the other is 0 (every model's ``calc_lon_control``)."""
        if abs(fd) > abs(fb):
            return self.calc_throttle(fd), 0.0
        return 0.0, self.calc_brake(fb)

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
