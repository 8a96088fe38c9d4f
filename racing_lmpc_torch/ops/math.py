"""Angle / abscissa wrapping, the lateral-side test and the small planar
rotations (port of ``racing_lmpc_tpu/ops/math.py``).

Elementwise and shape-polymorphic: every function broadcasts over leading
batch dimensions, as the reference's does.
"""

from __future__ import annotations

import torch
from torch import Tensor


def wrap_to_pi(angle: Tensor) -> Tensor:
    """Wrap an angle to (-pi, pi] via the atan2 identity (branch-free)."""
    return torch.atan2(torch.sin(angle), torch.cos(angle))


def align_abscissa(s1: Tensor, s2: Tensor, s_total: Tensor) -> Tensor:
    """Shift track abscissa ``s1`` by a multiple of the track length toward ``s2``.

    Mirrors ``lmpc::utils::align_abscissa`` (utils.hpp:36-42): the result is
    within ``s_total/2`` of ``s2`` and congruent to ``s1`` mod ``s_total``.
    ``torch.remainder`` is the floored modulo of ``jnp.mod``.
    """
    d = torch.abs(s2 - s1) + s_total / 2.0
    l = d - torch.remainder(d, s_total)
    return s1 + l * torch.sign(s2 - s1)


def align_yaw(yaw_1: Tensor, yaw_2: Tensor) -> Tensor:
    """Shift ``yaw_1`` by a multiple of 2*pi to the representative nearest
    ``yaw_2`` (``lmpc::utils::align_yaw``, utils.hpp:25-31)."""
    return wrap_to_pi(yaw_1 - yaw_2) + yaw_2


def lateral_sign(position: Tensor, pose: Tensor) -> Tensor:
    """Sign (+1 left / -1 right) of ``position`` (..., 2) relative to a pose
    (x, y, yaw) (..., 3): the cross-product test of
    ``lmpc::utils::lateral_sign`` (utils.hpp:72-80)."""
    yaw = pose[..., 2]
    return torch.sign(
        torch.cos(yaw) * (position[..., 1] - pose[..., 1])
        - torch.sin(yaw) * (position[..., 0] - pose[..., 0]))


def norm_2(v: Tensor) -> Tensor:
    """2-norm over the trailing axis, broadcasting over leading batch dims
    (``lmpc::utils::norm_2_function``, utils.cpp:45-50)."""
    return torch.sqrt(torch.sum(torch.square(v), dim=-1))


def global_to_frenet_rotation(p: Tensor, p0: Tensor, yaw: Tensor) -> Tensor:
    """Rotate point(s) ``p`` into the frame of ``p0`` with heading ``yaw``:
    ``R(-yaw) @ (p - p0)`` (``lmpc::utils::global_to_frenet``,
    utils.hpp:45-60).  ``p``/``p0``: (..., 2)."""
    c = torch.cos(yaw)
    s = torch.sin(yaw)
    d = p - p0
    return torch.stack(
        [c * d[..., 0] + s * d[..., 1], -s * d[..., 0] + c * d[..., 1]], dim=-1)


def body_to_spatial_velocity(v_body: Tensor, yaw: Tensor) -> Tensor:
    """Rotate a body-frame (vx, vy) velocity into the spatial/global frame."""
    c = torch.cos(yaw)
    s = torch.sin(yaw)
    return torch.stack(
        [c * v_body[..., 0] - s * v_body[..., 1],
         s * v_body[..., 0] + c * v_body[..., 1]], dim=-1)


def spatial_to_body_velocity(v_spatial: Tensor, yaw: Tensor) -> Tensor:
    """Rotate a spatial-frame velocity into the body frame."""
    c = torch.cos(yaw)
    s = torch.sin(yaw)
    return torch.stack(
        [c * v_spatial[..., 0] + s * v_spatial[..., 1],
         -s * v_spatial[..., 0] + c * v_spatial[..., 1]], dim=-1)
