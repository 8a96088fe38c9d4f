"""Carry state from the reference package into the port's objects.

The reference's data arrive here as plain Python: a ``dataclasses.asdict``
of a config, a dict of ``MPCInput`` arrays, recorded laps as arrays, a
filter's state, a regression spec's fields.  This module turns them into
the port's configs, ``MPCInput`` tensors, safe-set manager (its raw laps for
the regression included), EKF and ``RegressionSpec``, so that both packages
can start from the same numbers.  It imports nothing of the reference
package.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Mapping, Sequence

import numpy as np
import torch

from racing_lmpc_torch import config as _config
from racing_lmpc_torch import resolve_device
from racing_lmpc_torch.control.loop import RegressionSpec
from racing_lmpc_torch.estimation import EKFStateEstimator
from racing_lmpc_torch.mpc.racing_mpc import MPCInput
from racing_lmpc_torch.safeset import SafeSetManager


def config_from_dict(cls, d: Mapping):
    """A port config dataclass ``cls`` from ``dataclasses.asdict`` of its
    reference counterpart: nested configs recurse, lists become tuples, and
    a key the port does not know raises."""
    hints = typing.get_type_hints(cls, vars(_config))
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"{cls.__name__} has no fields {sorted(unknown)}")
    kwargs = {}
    for k, v in d.items():
        if dataclasses.is_dataclass(hints.get(k)) and isinstance(v, Mapping):
            v = config_from_dict(hints[k], v)
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[k] = v
    return cls(**kwargs)


def mpc_input_from_arrays(arrays: Mapping, device=None) -> MPCInput:
    """The port's ``MPCInput`` from a dict of the reference's ``MPCInput``
    fields (numpy arrays; a batch dimension, if any, is kept), on ``device``
    (CUDA unless the caller names one).  Optional fields the reference
    leaves as ``None`` (the regression corrections dA/dB/dC) stay ``None``;
    a field the port does not know raises ValueError."""
    device = resolve_device(device)
    fields = {k: v for k, v in arrays.items() if v is not None}
    unknown = set(fields) - set(MPCInput._fields)
    if unknown:
        raise ValueError(f"MPCInput has no fields {sorted(unknown)}")
    return MPCInput(**{k: torch.as_tensor(np.asarray(v), dtype=torch.float32,
                                          device=device)
                       for k, v in fields.items()})


def safe_set_from_laps(laps: Sequence[tuple], total_length: float,
                       max_laps: int, nx: int = 6, nu: int = 2) -> SafeSetManager:
    """A port ``SafeSetManager`` holding the recorded laps ``laps``, each
    (x, u, k, t) as ``SafeSetManager.add_lap`` takes them, added oldest
    first as the reference adds them (its raw laps for the regression with
    them)."""
    manager = SafeSetManager(max_laps, nx=nx, nu=nu)
    for x, u, k, t in laps:
        manager.add_lap(x, u, k, t, total_length)
    return manager


def estimator_from_state(config: Mapping, model, observations: Sequence[tuple],
                         x, P, nanosec: int, u=None, device=None) -> EKFStateEstimator:
    """The port's EKF from ``dataclasses.asdict`` of the reference's
    ``EKFConfig`` and its filter's state: ``observations`` (name, nz, h)
    registered in the reference's order, initialized at its clock
    ``nanosec``, with its state ``x``, covariance ``P`` and (if given) last
    control ``u``, on ``device`` (CUDA unless the caller names one)."""
    ekf = EKFStateEstimator(config_from_dict(_config.EKFConfig, config), model, device=device)
    for name, nz, h in observations:
        ekf.register_observation(name, nz, h)
    ekf.initialize(nanosec)
    ekf.x = torch.as_tensor(np.asarray(x), dtype=torch.float32, device=ekf.device)
    ekf.P = torch.as_tensor(np.asarray(P), dtype=torch.float32, device=ekf.device)
    if u is not None:
        ekf.update_control(np.asarray(u))
    return ekf


def regression_spec_from_fields(dist_max: float, groups) -> RegressionSpec:
    """The port's ``RegressionSpec`` from the reference's fields: each group
    (state inputs, control inputs, output state) as tuples."""
    return RegressionSpec(float(dist_max), tuple(
        (tuple(int(i) for i in xs), tuple(int(i) for i in us), int(out))
        for xs, us, out in groups))
