"""Planar transform helpers: yaw <-> quaternion, yaw differences.

Port of ``racing_lmpc_tpu/ops/transform.py`` (parity target
``lmpc_transform_helper/lmpc_transform_helper.hpp:41-70``): the
tf2-wrapper surface reduced to its math, on host floats and numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from racing_lmpc_torch.ops.math import wrap_to_pi


def quaternion_from_heading(yaw: float) -> tuple[float, float, float, float]:
    """(qr, qi, qj, qk) for a pure-yaw rotation."""
    return (float(np.cos(yaw / 2.0)), 0.0, 0.0, float(np.sin(yaw / 2.0)))


def heading_from_quaternion(qr: float, qi: float, qj: float, qk: float) -> float:
    """Yaw extracted from a (unit) quaternion."""
    return float(np.arctan2(2.0 * (qr * qk + qi * qj),
                            1.0 - 2.0 * (qj * qj + qk * qk)))


def calc_yaw_difference(yaw_1: float, yaw_2: float) -> float:
    """Signed smallest difference yaw_2 - yaw_1, wrapped to (-pi, pi] by
    ``wrap_to_pi`` in f32, as the reference's does."""
    return float(wrap_to_pi(torch.as_tensor(yaw_2 - yaw_1, dtype=torch.float32)))


def pose_matrix(x: float, y: float, yaw: float) -> np.ndarray:
    """3x3 homogeneous planar transform."""
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, x], [s, c, y], [0.0, 0.0, 1.0]])
