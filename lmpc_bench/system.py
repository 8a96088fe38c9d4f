"""The system under test: the port's ``RacingMPC`` built from a
configuration file, and its batched solve.

The configuration's sections go through the port's own parameter
ingestion (``racing_lmpc_torch.config``), as the port reads the upstream
param files; the MPC keys under ``assumed`` are passed as its overrides,
and the model is built by ``system_models/<model>.py``, found by the
configuration's ``model``.  This module and those files are the only
ones of the benchmark that import the port.
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import torch

MODELS = Path(__file__).resolve().parent / "system_models"

OUTPUTS = ("U_optm", "X_optm", "convex_combi", "obj", "solved")


def _decode(v):
    """The configuration file's "inf" / "-inf" strings as floats."""
    if isinstance(v, str) and v in ("inf", "-inf"):
        return math.inf if v == "inf" else -math.inf
    if isinstance(v, list):
        return [_decode(x) for x in v]
    if isinstance(v, dict):
        return {k: _decode(x) for k, x in v.items()}
    return v


def build_mpc(cfg: dict, device):
    """The port's RacingMPC of configuration ``cfg`` on ``device``."""
    from racing_lmpc_torch import config as pc
    from racing_lmpc_torch.mpc.racing_mpc import RacingMPC
    spec = importlib.util.spec_from_file_location(f"lmpc_bench_system_{cfg['model']}",
                                                  MODELS / f"{cfg['model']}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    params = {"racing_mpc": _decode(cfg["racing_mpc"])}
    overrides = _decode(cfg["assumed"]["racing_mpc"])
    return RacingMPC(pc.mpc_config_from_params(params, **overrides),
                     mod.build(cfg, _decode), device=device)


def to_input(fields: dict):
    """The port's MPCInput of a dict of tensors."""
    from racing_lmpc_torch.mpc.racing_mpc import MPCInput
    return MPCInput(**fields)


def chol_launches() -> int:
    """The port's count of ``chol_tri_inv`` calls that launched the kernel."""
    from racing_lmpc_torch.ops import linalg
    return int(linalg.chol_tri_inv.launches)


def solve(mpc, inp):
    """``solve_batch`` on tensors on the card; returns the output."""
    out, _ = mpc.solve_batch(inp)
    return out


def host_outputs(out) -> dict:
    """The outputs copied to the host."""
    return {k: getattr(out, k).cpu().numpy() for k in OUTPUTS}


def step(mpc, traffic) -> tuple[int, dict]:
    """One step: the traffic's next batch solved, its outputs copied to the
    host (the copy ends the step).  Returns (the pool batch, the outputs)."""
    fields, p = traffic.next()
    return p, host_outputs(solve(mpc, to_input(fields)))


def layout(mpc) -> dict:
    """The QP's sizes, for the per-layer readers."""
    L = mpc.layout
    return {"n": int(L.n), "m": int(L.m), "me": int(len(mpc.eq_rows))}


def lower_precision(on: bool) -> None:
    """The port's lower-precision path: TF32 products and the normal
    equations A'DA in float32 (the control of the correctness check), or
    back to the configuration's precision (float32 without TF32, A'DA in
    float64)."""
    from racing_lmpc_torch.mpc import ipm
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    torch.set_float32_matmul_precision("high" if on else "highest")
    ipm.NORMAL_EQ_DTYPE = torch.float32 if on else torch.float64
