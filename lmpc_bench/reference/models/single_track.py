"""Single-track planar vehicle model in plain PyTorch, for the reference.

The dynamics of Racing-LMPC-ROS2's ``single_track_planar_model.cpp``
(:256-332): axle-lumped tyres with the simplified Pacejka law
``Fy = mu Fz sin(C atan(B alpha))``, longitudinal load transfer and
downforce, aero drag and rolling resistance, the Frenet correction of the
rates, one RK4 step (``utils.cpp:67-108``), and the QP's control and rate
bounds (:113-158).  Written from those equations over a parameter dict (the
configuration file's ``vehicle`` and ``single_track_planar`` sections), in
whatever dtype the caller gives (the reference runs it in float64).

State x = (s, t, xi, vx, vy, omega); controls u = (lon, steer) with the
smooth drive/brake split fd = 1000 lon (tanh(lon) / 2 + 1/2), fb = 1000 lon
(tanh(-lon) / 2 + 1/2) when ``simplify_lon_control``, else (fd, fb, steer).

A model file of the reference gives ``from_config(cfg)``, the model of a
configuration, whose instance has ``nx``, ``nu``, ``idx_vel`` (the speed's
place in the state), ``scale_x`` and ``scale_u`` (the QP's fixed variable
scaling), the boxes ``u_lb``, ``u_ub``, ``du_lb``, ``du_ub`` and
``linearize``.
"""

from __future__ import annotations

import numpy as np
import torch

GRAVITY = 9.8


def from_config(cfg: dict) -> "SingleTrack":
    return SingleTrack(cfg["vehicle"], cfg["single_track_planar"])


class SingleTrack:
    nx = 6
    idx_vel = 3
    # the port's fixed diagonal scaling (racing_mpc.cpp:36-37); any scaling
    # gives the same optimum, this one keeps the variables O(1)
    scale_x = (2000.0, 10.0, 0.1, 80.0, 2.0, 2.0)

    def __init__(self, vehicle: dict, single_track: dict):
        v, st = vehicle, single_track
        ch, aero = v["chassis"], v["aero"]
        self.simple = bool(st["simplify_lon_control"])
        self.nu = 2 if self.simple else 3
        self.scale_u = (10.0, 0.3) if self.simple else (10.0, 10.0, 0.3)
        self.m = float(ch["total_mass"])
        self.Jz = float(ch["moi"])
        self.l = float(ch["wheel_base"])
        self.lr = float(ch["cg_ratio"]) * self.l
        self.lf = self.l - self.lr
        self.h = float(ch["cg_height"])
        self.fr = float(ch["fr"])
        self.rho = float(aero["air_density"])
        self.cd = float(aero["drag_coeff"])
        self.area = float(aero["frontal_area"])
        self.cl_f = float(aero["cl_f"])
        self.cl_r = float(aero["cl_r"])
        self.kd = float(v["powertrain"]["kd"])
        self.kb = float(v["front_brake"]["bias"])
        self.Bf = float(v["front_tyre"]["pacejka_b"])
        self.Cf = float(v["front_tyre"]["pacejka_c"])
        self.Br = float(v["rear_tyre"]["pacejka_b"])
        self.Cr = float(v["rear_tyre"]["pacejka_c"])
        self.mu = float(st["mu"])
        self.frenet = bool(v["modeling"]["use_frenet"])
        if v["modeling"]["integrator_type"] != "rk4":
            raise ValueError("the reference integrates with RK4 only")
        steer_max = float(v["steer"]["max_steer"])
        steer_rate = float(v["steer"]["max_steer_rate"])
        fd, fb = float(st["fd_max"]), float(st["fb_max"])
        td, tb = float(st["td"]), float(st["tb"])
        if self.simple:
            self.u_lb = np.array([fb / 1000.0, -steer_max])
            self.u_ub = np.array([fd / 1000.0, steer_max])
            self.du_lb = np.array([fb / 1000.0 / tb, -steer_rate])
            self.du_ub = np.array([fd / 1000.0 / td, steer_rate])
        else:
            self.u_lb = np.array([0.0, fb, -steer_max])
            self.u_ub = np.array([fd, 0.0, steer_max])
            self.du_lb = np.array([-np.inf, fb / tb, -steer_rate])
            self.du_ub = np.array([fd / td, np.inf, steer_rate])

    def forces(self, u):
        if self.simple:
            lon = u[..., 0]
            fd = lon * (torch.tanh(lon) * 0.5 + 0.5) * 1000.0
            fb = lon * (torch.tanh(-lon) * 0.5 + 0.5) * 1000.0
            return fd, fb, u[..., 1]
        return u[..., 0], u[..., 1], u[..., 2]

    def dynamics(self, x, u, k):
        t, xi, vx, vy, om = x[..., 1], x[..., 2], x[..., 3], x[..., 4], x[..., 5]
        fd, fb, delta = self.forces(u)
        m, l, lr, lf = self.m, self.l, self.lr, self.lf
        v2 = vx * vx
        # per-wheel longitudinal forces with the rolling resistance split
        Fx_f = 0.5 * self.kd * fd + 0.5 * self.kb * fb - 0.5 * self.fr * m * GRAVITY * lr / l
        Fx_r = (0.5 * (1.0 - self.kd) * fd + 0.5 * (1.0 - self.kb) * fb
                - 0.5 * self.fr * m * GRAVITY * lf / l)
        ax = (fd + fb - 0.5 * self.cd * self.area * v2 - self.fr * m * GRAVITY) / m
        Fz_f = (0.5 * m * GRAVITY * lr / l - 0.5 * self.h / l * m * ax
                + 0.25 * self.cl_f * self.rho * self.area * v2)
        Fz_r = (0.5 * m * GRAVITY * lf / l + 0.5 * self.h / l * m * ax
                + 0.25 * self.cl_r * self.rho * self.area * v2)
        a_f = delta - torch.arctan((lf * om + vy) / (vx + 1e-3))
        a_r = torch.arctan((lr * om - vy) / (vx + 1e-3))
        Fy_f = self.mu * Fz_f * torch.sin(self.Cf * torch.arctan(self.Bf * a_f))
        Fy_r = self.mu * Fz_r * torch.sin(self.Cr * torch.arctan(self.Br * a_r))
        c, s = torch.cos(delta), torch.sin(delta)
        om_dot = (-(2.0 * Fy_r) * lr + ((2.0 * Fy_f) * c + (2.0 * Fx_f) * s) * lf) / self.Jz
        vx_dot = (2.0 * Fx_r + 2.0 * Fx_f * c - 2.0 * Fy_f * s
                  - 0.5 * self.cd * self.rho * self.area * v2) / m + om * vy
        vy_dot = (2.0 * Fy_r + 2.0 * Fy_f * c + 2.0 * Fx_f * s) / m - om * vx
        s_dot = vx * torch.cos(xi) - vy * torch.sin(xi)
        t_dot = vx * torch.sin(xi) + vy * torch.cos(xi)
        xi_dot = om
        if self.frenet:
            s_dot = s_dot / (1.0 - t * k)
            xi_dot = om - k * s_dot
        return torch.stack([s_dot, t_dot, xi_dot, vx_dot, vy_dot, om_dot], -1)

    def step(self, x, u, k, dt):
        """One RK4 step of length ``dt`` at curvature ``k``."""
        h = dt[..., None]
        k1 = self.dynamics(x, u, k)
        k2 = self.dynamics(x + h / 2.0 * k1, u, k)
        k3 = self.dynamics(x + h / 2.0 * k2, u, k)
        k4 = self.dynamics(x + h * k3, u, k)
        return x + h / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)

    def linearize(self, x, u, k, dt):
        """(A, B, g) of the RK4 step at (x, u) over leading batch dims, with
        A x + B u + g the step's exact value there."""
        nx, nu = x.shape[-1], u.shape[-1]
        cols = []
        for j in range(nx + nu):
            tx = torch.zeros_like(x)
            tu = torch.zeros_like(u)
            if j < nx:
                tx[..., j] = 1.0
            else:
                tu[..., j - nx] = 1.0
            xn, col = torch.func.jvp(lambda a, b: self.step(a, b, k, dt), (x, u), (tx, tu))
            cols.append(col)
        J = torch.stack(cols, -1)
        A, B = J[..., :nx], J[..., nx:]
        g = xn - (A @ x[..., None])[..., 0] - (B @ u[..., None])[..., 0]
        return A, B, g
