"""Periodic cubic splines: host-side fit, device-side evaluation.

Port of ``racing_lmpc_tpu/ops/spline.py``: ``PeriodicSpline`` (``:27-73``)
evaluates on the device with static shapes — wrap the abscissa into the
period, find the interval by ``torch.searchsorted``, Horner — over any batch
shape; ``fit_periodic_spline`` (``:97-122``) fits it on the host with SciPy
at load time; ``fit_host_spline`` (``:76-95``) is the SciPy twin that host
bookkeeping evaluates without touching the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from scipy.interpolate import CubicSpline
from torch import Tensor


class PeriodicSpline(NamedTuple):
    """Device-resident piecewise-cubic polynomial with period ``period``.

    ``breaks``: (M+1,) ascending knots spanning one period.  ``coeffs``:
    (4, M, d) coefficients per interval, highest power first (SciPy
    ``CubicSpline.c`` layout).  ``s0``/``period``: 0-d tensors.
    """

    breaks: Tensor
    coeffs: Tensor
    s0: Tensor
    period: Tensor

    def _locate(self, s: Tensor) -> tuple[Tensor, Tensor]:
        # torch.remainder is the floored modulo of jnp.mod; side="right" of
        # jnp.searchsorted is right=True here
        sm = self.s0 + torch.remainder(s - self.s0, self.period)
        idx = torch.clamp(torch.searchsorted(self.breaks, sm, right=True) - 1,
                          0, self.coeffs.shape[1] - 1)
        return idx, sm - self.breaks[idx]

    def eval(self, s: Tensor) -> Tensor:
        """Value at abscissa ``s`` (any batch shape) -> (..., d)."""
        idx, t = self._locate(s)
        c0, c1, c2, c3 = (self.coeffs[k, idx] for k in range(4))
        t = t[..., None]
        return ((c0 * t + c1) * t + c2) * t + c3

    def eval_d(self, s: Tensor) -> Tensor:
        """First derivative d/ds -> (..., d)."""
        idx, t = self._locate(s)
        c0, c1, c2 = (self.coeffs[k, idx] for k in range(3))
        t = t[..., None]
        return (3.0 * c0 * t + 2.0 * c1) * t + c2

    def eval_d2(self, s: Tensor) -> Tensor:
        """Second derivative d2/ds2 -> (..., d)."""
        idx, t = self._locate(s)
        c0, c1 = self.coeffs[0, idx], self.coeffs[1, idx]
        t = t[..., None]
        return 6.0 * c0 * t + 2.0 * c1


def _knots(s_knots, values, period):
    s_knots = np.asarray(s_knots, dtype=np.float64)
    values = np.asarray(values, dtype=np.float64)
    if values.ndim == 1:
        values = values[:, None]
    x = np.concatenate([s_knots, [s_knots[0] + period]])
    y = np.concatenate([values, values[:1]], axis=0)
    return x, y


def fit_host_spline(
    s_knots: np.ndarray, values: np.ndarray, period: float,
) -> CubicSpline:
    """Periodic SciPy ``CubicSpline`` through ``values`` at ``s_knots`` (the
    closing knot at ``s_knots[0] + period`` repeats the first value); with
    ``extrapolate='periodic'`` any abscissa evaluates without wrapping."""
    x, y = _knots(s_knots, values, period)
    return CubicSpline(x, y, bc_type="periodic", axis=0,
                       extrapolate="periodic")


def fit_periodic_spline(
    s_knots: np.ndarray, values: np.ndarray, period: float,
    device: torch.device, dtype=torch.float32,
) -> PeriodicSpline:
    """Fit a periodic cubic spline through ``values`` (M,) or (M, d) at the
    strictly increasing ``s_knots`` (M,) covering one period, on the host in
    float64; its tables are cast to ``dtype`` on ``device``."""
    if not np.all(np.diff(np.asarray(s_knots, dtype=np.float64)) > 0):
        raise ValueError("spline knots must be strictly increasing")
    x, y = _knots(s_knots, values, period)
    cs = CubicSpline(x, y, bc_type="periodic", axis=0)

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return PeriodicSpline(breaks=dev(x), coeffs=dev(cs.c),
                          s0=dev(x[0]), period=dev(period))
