"""Table-lookup interpolation (engine torque map, etc.).

Port of ``racing_lmpc_tpu/ops/lookup.py`` (parity target
``lmpc_utils/lookup.cpp:23-76``): 1-D linear and 2-D bilinear interpolation
with an optional extrapolation clamp, the interval index found by
``torch.searchsorted`` so the same function serves scalars and batches.

The reference's edge behaviour is kept: the interval index saturates at
``len(x) - 2``, and with ``extrapolate=False`` values outside the table clamp
to the edge value.
"""

from __future__ import annotations

import torch
from torch import Tensor


def _find_index(grid: Tensor, val: Tensor) -> Tensor:
    """Interval index such that grid[i] <= val < grid[i+1], saturated to
    [0, len(grid)-2] (``lookup.py:19-24``)."""
    val = torch.as_tensor(val, dtype=grid.dtype, device=grid.device)
    idx = torch.searchsorted(grid, val.reshape(-1), right=False).reshape(val.shape) - 1
    return torch.clamp(idx, 0, grid.shape[0] - 2)


def _fast_linear(x_min, x_max, y_min, y_max, x_val, extrapolate: bool):
    """Mirrors ``fast_linear_interpolate`` (``lookup.py:27-34``)."""
    x_min, x_max, y_min, y_max, x_val = (
        torch.as_tensor(a, dtype=torch.float32) if not isinstance(a, Tensor) else a
        for a in (x_min, x_max, y_min, y_max, x_val))
    yL, yR = y_min, y_max
    if not extrapolate:
        yR = torch.where(x_val < x_min, yL, yR)
        yL = torch.where(x_val > x_max, yR, yL)
    dydx = (yR - yL) / (x_max - x_min)
    return yL + dydx * (x_val - x_min)


def interp1d(x_grid: Tensor, y_grid: Tensor, x: Tensor, extrapolate: bool = False) -> Tensor:
    """1-D linear interpolation (``lookup.py:37-40``)."""
    x = torch.as_tensor(x, dtype=x_grid.dtype, device=x_grid.device)
    i = _find_index(x_grid, x)
    return _fast_linear(x_grid[i], x_grid[i + 1], y_grid[i], y_grid[i + 1], x, extrapolate)


def bilinear_interpolate(x_grid: Tensor, y_grid: Tensor, z_table: Tensor, x, y,
                         extrapolate: bool = False) -> Tensor:
    """2-D bilinear interpolation (``lookup.py:43-58``); ``z_table`` has
    shape (len(x_grid), len(y_grid)), row-major over x."""
    x = torch.as_tensor(x, dtype=x_grid.dtype, device=x_grid.device)
    y = torch.as_tensor(y, dtype=y_grid.dtype, device=y_grid.device)
    xi = _find_index(x_grid, x)
    yi = _find_index(y_grid, y)
    v1 = _fast_linear(
        y_grid[yi], y_grid[yi + 1], z_table[xi, yi], z_table[xi, yi + 1], y, extrapolate)
    v2 = _fast_linear(
        y_grid[yi], y_grid[yi + 1], z_table[xi + 1, yi], z_table[xi + 1, yi + 1], y, extrapolate)
    return _fast_linear(x_grid[xi], x_grid[xi + 1], v1, v2, x, extrapolate)
