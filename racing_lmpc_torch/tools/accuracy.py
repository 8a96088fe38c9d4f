"""The reading of the pinned accuracy instances at their ``ACCURACY.json``
gates, shared by ``chip_smoke.py``'s accuracy phase and the tools
(``ground_accuracy --engine``, ``pareto``).

An instance (``tests/data/acc_instances``, written by
``scripts/ground_accuracy.py --capture``) is one controller cycle's
``MPCInput`` with the f64 reference QP built from it and that QP's certified
optimum.  ``acc_reading`` solves it on the port as a batch of copies and reads
each gate of tests/test_reference_match.py::test_engine_matches_certified
in the reference QP that the port's own f64 oracle builds.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from racing_lmpc_torch.tools import ROOT

ACC_DIR = ROOT / "tests" / "data" / "acc_instances"
ACCURACY_JSON = ROOT / "ACCURACY.json"
# copies a pinned instance is solved as: the instance and copies moved by
# one f32 rounding (tests/_torch_twin.py::replay_instance)
ACC_REPLICAS = 9


def load_instances(inst_dir: Path = ACC_DIR) -> tuple[dict, list[tuple[dict, dict]]]:
    """(manifest, [(manifest record, arrays)]) of the instances in
    ``inst_dir``, in the manifest's order."""
    inst_dir = Path(inst_dir)
    man = json.loads((inst_dir / "manifest.json").read_text())
    out = []
    for rec in man["instances"]:
        with np.load(inst_dir / rec["file"], allow_pickle=False) as z:
            out.append((rec, {k: z[k] for k in z.files}))
    return man, out


def acc_instances() -> list[tuple[dict, dict, dict]]:
    """(manifest record, arrays, ACCURACY.json gates) of every pinned
    instance."""
    gates = json.loads(ACCURACY_JSON.read_text())["per_instance"]
    return [(rec, d, gates[rec["tag"]]) for rec, d in load_instances()[1]]


def acc_fields(d) -> dict:
    return {k[4:]: v for k, v in d.items() if k.startswith("inp_")}


def controls(d, z=None) -> np.ndarray:
    """The controls U (N-1, nu), unscaled, of instance ``d``'s reference-QP
    variable vector ``z`` (states first, then controls; the certified
    optimum ``z_star`` by default)."""
    su = d["scale_u"]
    N, nx, nu = d["inp_X_ref"].shape[0], 6, len(su)
    z = d["z_star"] if z is None else z
    return z[N * nx:N * nx + (N - 1) * nu].reshape(N - 1, nu) * su


def acc_copies(d, replicas: int = ACC_REPLICAS) -> dict:
    """The instance's inputs as a batch of ``replicas`` copies: the first
    exact, the others with x_ic and X_ref scaled by 1 + 2e-7 N(0, 1) from
    numpy seed 0 (tests/_torch_twin.py::replay_instance)."""
    rng = np.random.default_rng(0)
    batch = {k: np.repeat(np.asarray(v)[None], replicas, 0) for k, v in acc_fields(d).items()}
    for k in ("x_ic", "X_ref"):
        noise = 1 + 2e-7 * rng.standard_normal(batch[k].shape)
        noise[0] = 1.0
        batch[k] = (batch[k] * noise).astype(np.float32)
    return batch


def acc_primal(qp, out, ss_x):
    """Each copy's full primal packed into the reference QP's scaled
    variables (tests/test_reference_match.py::_sparse_vector): (copies, n)
    float64 on the QP's device."""
    import torch
    L = qp.layout
    f64 = lambda t: t.to(qp.P.device, torch.float64)  # noqa: E731
    X = f64(out.X_optm)
    R = X.shape[0]
    Z = torch.zeros((R, L.n), dtype=torch.float64, device=qp.P.device)
    Z[:, :L.u_off] = (X / qp.scale_x).reshape(R, -1)
    Z[:, L.u_off:L.du_off] = (f64(out.U_optm) / qp.scale_u).reshape(R, -1)
    Z[:, L.du_off:L.du_off + (L.N - 1) * L.nu] = (f64(out.dU_optm) / qp.scale_u).reshape(R, -1)
    if L.has_bslack:
        Z[:, L.sb_off] = f64(out.boundary_slack).clamp(min=0.0)
    if L.learning:
        lam = f64(out.convex_combi)
        Z[:, L.lam_off:L.lam_off + L.K] = lam
        if L.has_hull_slack:
            Z[:, L.hs_off:L.hs_off + L.nx] = X[:, -1] - lam @ f64(ss_x)
    return Z


def acc_reading(mpc, rec, d, device, replicas: int = ACC_REPLICAS) -> tuple[dict, object]:
    """One instance solved by the port as ``replicas`` copies
    (``acc_copies``) on ``device``, read as tests/test_reference_match.py::
    test_engine_matches_certified reads the engine, in the reference QP that
    the port's oracle builds at f64 on ``device``: the largest longitudinal
    error, the median over the copies of the applied (stages 0-1) and tail
    steering errors and of the objective gap, the largest infeasibility,
    the exact instance's gap (the copy the test reads), the smallest gap,
    the most any copy lies below the optimum beyond what its infeasibility
    allows (the dual bound sum_i |y*_i| v_i at the stored certified duals),
    and the build's drift from the exported QP.  Returns the reading and the
    QP."""
    import torch
    from racing_lmpc_torch.carry import mpc_input_from_arrays
    from racing_lmpc_torch.mpc.reference_qp import build_reference_qp

    out, _ = mpc.solve_batch(mpc_input_from_arrays(acc_copies(d, replicas), device=device))
    su = d["scale_u"]
    rel = np.abs(out.U_optm.double().cpu().numpy() - controls(d)) / su

    fields = acc_fields(d)
    inp = mpc_input_from_arrays(fields, device=device)
    qp = build_reference_qp(mpc.model, mpc.config, inp, device=device)
    drift, same_inf = 0.0, True
    for name in ("P", "q", "A", "l", "u"):
        got, want = getattr(qp, name).cpu().numpy(), d[name]
        fin = np.isfinite(want)
        same_inf &= bool(np.array_equal(np.isfinite(got), fin))
        if np.array_equal(np.isfinite(got), fin):
            scale = max(1.0, float(np.abs(want[fin]).max()))
            drift = max(drift, float(np.abs(got[fin] - want[fin]).max()) / scale)
    Z = acc_primal(qp, out, inp.ss_x)
    AZ = Z @ qp.A.T
    rows = torch.maximum((AZ - qp.u).clamp(min=0.0), (qp.l - AZ).clamp(min=0.0))
    z_star = torch.as_tensor(d["z_star"], device=device)
    obj = 0.5 * (Z * (Z @ qp.P.T)).sum(1) + Z @ qp.q
    obj_star = qp.objective(z_star)
    norm = max(abs(obj_star), 1.0)
    gaps = ((obj - obj_star) / norm).cpu().numpy()
    # a point infeasible by v_i on row i can lie below the optimum by at
    # most sum_i |y*_i| v_i (Lagrangian duality at the certified (z*, y*))
    bound = (rows * torch.as_tensor(np.abs(d["y_star"]), device=device)).sum(1) / norm
    reading = {"solved": int(out.solved.sum()), "lon max": float(rel[..., 0].max()),
               "applied steer": float(np.median(rel[:, :2, 1].max(-1))),
               "steer tail": float(np.median(rel[..., 1].max(-1))),
               "infeasibility max": float(rows.amax(1).max()), "gap exact": float(gaps[0]),
               "gap min": float(gaps.min()),
               "unexplained beat": float((-torch.as_tensor(gaps, device=device) - bound).max()),
               "objective gap": float(np.median(gaps)), "drift": drift, "same inf": same_inf}
    return reading, qp


def acc_limits(rec, gates: dict) -> dict:
    """Each reading's limit: ACCURACY.json's per-instance applied-steer and
    objective-gap gates, and tests/test_reference_match.py's fixed ones."""
    return {"lon max": 1e-3, "applied steer": gates["applied_steer_gate"],
            "steer tail": 2e-2 if rec["learning"] else 1e-2,
            "infeasibility max": 5e-4, "objective gap": gates["obj_gap_gate"],
            "drift": 1e-9}
