"""Fixed-step integrators (port of ``racing_lmpc_tpu/ops/integrators.py:23-47``).

``dt`` is a tensor of the state's batch shape (one step length per state, or
a 0-d tensor inside ``torch.func.vmap``); it broadcasts over the state axis.
"""

from __future__ import annotations

from typing import Callable

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
