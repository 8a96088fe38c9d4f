"""Fixed-step integrators and exact discretization (port of
``racing_lmpc_tpu/ops/integrators.py``).

``dt`` is a tensor of the state's batch shape (one step length per state, or
a 0-d tensor inside ``torch.func.vmap``); it broadcasts over the state axis.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import Tensor

# dynamics(x, u, k) -> x_dot, where k is the local track curvature
Dynamics = Callable[[Tensor, Tensor, Tensor], Tensor]


def rk4(dynamics: Dynamics, x: Tensor, u: Tensor, k: Tensor, dt: Tensor) -> Tensor:
    """Classic RK4 step, mirroring ``lmpc::utils::rk4_function`` (utils.cpp:67-108)."""
    dt = dt.unsqueeze(-1)
    k1 = dynamics(x, u, k)
    k2 = dynamics(x + dt / 2.0 * k1, u, k)
    k3 = dynamics(x + dt / 2.0 * k2, u, k)
    k4 = dynamics(x + dt * k3, u, k)
    return x + dt / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def euler(dynamics: Dynamics, x: Tensor, u: Tensor, k: Tensor, dt: Tensor) -> Tensor:
    """Explicit Euler step, mirroring ``lmpc::utils::euler_function`` (utils.cpp:110-123)."""
    return x + dt.unsqueeze(-1) * dynamics(x, u, k)


def integrate(
    dynamics: Dynamics, x: Tensor, u: Tensor, k: Tensor, dt: Tensor,
    method: str = "rk4",
) -> Tensor:
    """Dispatch on integrator type (reference ``IntegratorType`` RK4/EULER)."""
    if method == "rk4":
        return rk4(dynamics, x, u, k, dt)
    if method == "euler":
        return euler(dynamics, x, u, k, dt)
    raise ValueError(f"unsupported integrator type: {method}")


def c2d(Ac: Tensor, Bc: Tensor, dt) -> tuple[Tensor, Tensor]:
    """Exact continuous -> discrete conversion of (A, B) over any leading
    batch shape, via the augmented matrix exponential
    ``expm([[A, B], [0, 0]] * dt)``; mirrors ``lmpc::utils::c2d_function``
    (utils.cpp:52-65).

    ``torch.linalg.matrix_exp`` is a different approximant from the
    reference's Pade-13 ``expm`` (both scale and square), so the two agree
    to about 1e-6 relative in f32, not bit for bit.
    """
    nx, nu = Ac.shape[-1], Bc.shape[-1]
    top = torch.cat([Ac, Bc], dim=-1)
    bottom = Ac.new_zeros(Ac.shape[:-2] + (nu, nx + nu))
    M = torch.cat([top, bottom], dim=-2)
    dt = torch.as_tensor(dt, dtype=Ac.dtype, device=Ac.device)
    eM = torch.linalg.matrix_exp(M * dt[..., None, None])
    return eM[..., :nx, :nx], eM[..., :nx, nx:]
