"""Host-side periodic cubic spline fit (port of ``fit_host_spline``,
``racing_lmpc_tpu/ops/spline.py:76-95``).  The device spline waits for the
controller slice."""

from __future__ import annotations

import numpy as np
from scipy.interpolate import CubicSpline


def fit_host_spline(
    s_knots: np.ndarray, values: np.ndarray, period: float,
) -> CubicSpline:
    """Periodic SciPy ``CubicSpline`` through ``values`` at ``s_knots`` (the
    closing knot at ``s_knots[0] + period`` repeats the first value); with
    ``extrapolate='periodic'`` any abscissa evaluates without wrapping."""
    s_knots = np.asarray(s_knots, dtype=np.float64)
    values = np.asarray(values, dtype=np.float64)
    if values.ndim == 1:
        values = values[:, None]
    x = np.concatenate([s_knots, [s_knots[0] + period]])
    y = np.concatenate([values, values[:1]], axis=0)
    return CubicSpline(x, y, bc_type="periodic", axis=0,
                       extrapolate="periodic")
