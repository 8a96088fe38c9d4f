"""Carry state from the reference package into the port's objects.

The reference's data arrive here as plain Python: a ``dataclasses.asdict``
of a config, a dict of ``MPCInput`` arrays, recorded laps as arrays.  This
module turns them into the port's configs, ``MPCInput`` tensors and safe-set
manager, so that both packages can solve the same problems.  It imports
nothing of the reference package.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Mapping, Sequence

import numpy as np
import torch

from racing_lmpc_torch import config as _config
from racing_lmpc_torch import resolve_device
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
    leaves as ``None`` are dropped; its regression corrections dA/dB/dC
    raise NotImplementedError, and any other field the port does not know
    raises ValueError."""
    device = resolve_device(device)
    fields = {k: v for k, v in arrays.items() if v is not None}
    regression = sorted({"dA", "dB", "dC"} & set(fields))
    if regression:
        raise NotImplementedError(
            f"MPCInput {regression}: the safe-set regression corrections are "
            "not ported yet")
    unknown = set(fields) - set(MPCInput._fields)
    if unknown:
        raise ValueError(f"MPCInput has no fields {sorted(unknown)}")
    return MPCInput(**{k: torch.as_tensor(np.asarray(fields[k]),
                                          dtype=torch.float32, device=device)
                       for k in MPCInput._fields})


def safe_set_from_laps(laps: Sequence[tuple], total_length: float,
                       max_laps: int, nx: int = 6) -> SafeSetManager:
    """A port ``SafeSetManager`` holding the recorded laps ``laps``, each
    (x, u, k, t) as ``SafeSetManager.add_lap`` takes them, added oldest
    first as the reference adds them."""
    manager = SafeSetManager(max_laps, nx=nx)
    for x, u, k, t in laps:
        manager.add_lap(x, u, k, t, total_length)
    return manager
