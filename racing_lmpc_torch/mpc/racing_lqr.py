"""Finite-horizon discrete Riccati LQR tracking controller.

Port of ``racing_lmpc_tpu/mpc/racing_lqr.py`` (parity target
``racing_lqr/src/racing_lqr.cpp:45-104``): per-stage linearization of the
continuous dynamics at the reference, exact c2d through the augmented
matrix exponential, the backward Riccati recursion, and a forward RK4
rollout applying u = u_ref - K (x - x_ref) at curvature 0 (as the
reference's solve does).  The reference's ``lax.scan`` over stages is a
loop over stages with an explicit batch dimension; ``solve`` is a batch of
one.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

from racing_lmpc_torch import resolve_device
from racing_lmpc_torch.config import RacingLQRConfig
from racing_lmpc_torch.models.base import VehicleModel
from racing_lmpc_torch.ops.integrators import c2d, rk4
from racing_lmpc_torch.ops.linalg import solve_small


class LQRSolution(NamedTuple):
    u: Tensor         # (..., nu) first control
    U_optm: Tensor    # (..., N-1, nu)
    X_optm: Tensor    # (..., N, nx)
    K_gains: Tensor   # (..., N-1, nu, nx)


class RacingLQR:
    def __init__(self, config: RacingLQRConfig, model: VehicleModel, device=None):
        self.device = resolve_device(device)
        self.config = config
        self.model = model
        nx, nu = model.nx, model.nu

        def dev(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=self.device)
        self.Q, self.R, self.Qf = dev(config.Q(nx)), dev(config.Rm(nu)), dev(config.Qf(nx))
        self._dt = dev(config.dt)

    def solve_batch(self, x_ic, X_ref, U_ref) -> LQRSolution:
        """Batched solve: ``x_ic`` (B, nx), ``X_ref`` (B, N, nx), ``U_ref``
        (B, N-1, nu)."""
        def dev(a):
            return torch.as_tensor(a, dtype=torch.float32).to(self.device)
        x_ic, X_ref, U_ref = dev(x_ic), dev(X_ref), dev(U_ref)
        model, dt = self.model, self._dt
        B, N = x_ic.shape[0], self.config.n
        zero_k = x_ic.new_zeros((B, N - 1))
        # stage linearizations + exact discretization (racing_lqr.cpp:59-69)
        Ac, Bc = model.dynamics_jacobian(X_ref[:, :-1], U_ref, zero_k)
        Ad, Bd = c2d(Ac, Bc, dt)

        # backward Riccati (racing_lqr.cpp:71-77)
        P = self.Qf.expand(B, -1, -1)
        Ks = [None] * (N - 1)
        for i in reversed(range(N - 1)):
            A, Bi = Ad[:, i], Bd[:, i]
            BtP = Bi.transpose(-1, -2) @ P
            K = solve_small(self.R + BtP @ Bi, BtP @ A)
            P = self.Q + A.transpose(-1, -2) @ P @ (A - Bi @ K)
            Ks[i] = K

        # forward rollout with RK4 (racing_lqr.cpp:80-90)
        x, xs, us = x_ic, [x_ic], []
        zero = x_ic.new_zeros((B,))
        for i in range(N - 1):
            u = U_ref[:, i] - torch.matmul(Ks[i], (x - X_ref[:, i])[..., None])[..., 0]
            x = rk4(model.dynamics, x, u, zero, dt)
            xs.append(x)
            us.append(u)
        U = torch.stack(us, dim=1)
        return LQRSolution(u=U[:, 0], U_optm=U, X_optm=torch.stack(xs, dim=1),
                           K_gains=torch.stack(Ks, dim=1))

    def solve(self, x_ic, X_ref, U_ref) -> LQRSolution:
        """One solve: ``X_ref`` (N, nx), ``U_ref`` (N-1, nu)."""
        sol = self.solve_batch(*(torch.as_tensor(a)[None] for a in (x_ic, X_ref, U_ref)))
        return LQRSolution(*(a[0] for a in sol))
