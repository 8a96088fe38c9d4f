"""Whether a run's answers are correct.

After the window a sample of (step, lane) pairs, drawn from the seed, is
judged against the plain reference (``reference/qp.py``), which builds and
solves each sampled lane's QP in float64 from the benchmark's own inputs.
The port's answer is its plan (``X_optm``, ``U_optm``, ``convex_combi``),
priced in the reference's QP.  Each lane's cost gap is |cost of its plan -
optimal cost| / max(|optimal cost|, 1).  The readings, of which
``limits/<cell>.json`` holds some to a limit each:

- ``unsolved_share``: the share of all lanes of the run that the port did
  not report ``solved`` (every sampled lane's QP has a certified optimum);
- ``cost_gap_p90``: the 90th percentile of the cost gap over the sampled
  lanes the port reported solved (``judged``);
- ``far_share``: the share of the judged lanes whose cost gap is above 1
  (the tail that the percentile does not see);
- ``defect_max``: over the judged lanes, the largest break of the QP's hard
  rows by the plan (its dynamics residual relative to 1 + |X|, its control,
  rate and hard state-box violations over each box's width, its weights'
  distance from the simplex).

A lane whose reference solve does not certify is left out and counted
(``uncertified``); ``cost_gap_max`` (a widest gap, which swings with the
sample) and ``defect_p90`` are printed beside the compared numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from lmpc_bench.reference import qp as rq

KEYS = ("U_optm", "X_optm", "convex_combi")
# lanes the reference builds and solves at once (about 1 GB of float64 rows)
BLOCK = 128


def pick(seed: int, steps: int, batch: int, lanes: int) -> list[tuple[int, int]]:
    """``lanes`` (step, lane) pairs drawn from the seed, without repeats."""
    rng = np.random.default_rng([seed, 7])
    flat = rng.choice(steps * batch, size=min(lanes, steps * batch), replace=False)
    return [(int(i) // batch, int(i) % batch) for i in np.sort(flat)]


def readings(cfg: dict, traffic, pools: list, hosts: list, picks, device) -> dict:
    """Every number of the check for the sampled ``picks`` of steps that
    came from pool batches ``pools`` and gave outputs ``hosts``."""
    inputs = traffic.lanes(pools, picks)
    port = {k: np.stack([hosts[s][k][b] for s, b in picks]) for k in KEYS}
    solved = np.array([bool(hosts[s]["solved"][b]) for s, b in picks])
    model = rq.load_model(cfg)
    gap, defect, cert = [], [], []
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)  # noqa: E731
    for i in range(0, len(picks), BLOCK):
        part = slice(i, i + BLOCK)
        qp = rq.build(cfg, model, {k: v[part] for k, v in inputs.items()}, device)
        w, ok = rq.solve(qp)
        best = qp.objective(w)
        cost, dfc = rq.plan_cost(qp, f64(port["X_optm"][part]), f64(port["U_optm"][part]),
                                 f64(port["convex_combi"][part]))
        gap.append(((cost - best).abs() / best.abs().clamp(min=1.0)).cpu().numpy())
        defect.append(dfc.cpu().numpy())
        cert.append(ok.cpu().numpy())
        del qp
    gap, defect, cert = (np.concatenate(a) for a in (gap, defect, cert))
    gap = np.where(np.isfinite(gap), gap, np.inf)
    defect = np.where(np.isfinite(defect), defect, np.inf)
    judged = solved & cert
    all_solved = np.concatenate([h["solved"] for h in hosts])

    def stat(a, q):
        return float(np.percentile(a[judged], q)) if judged.any() else float("inf")
    return {"unsolved_share": float(1.0 - all_solved.mean()),
            "cost_gap_max": stat(gap, 100), "cost_gap_p90": stat(gap, 90),
            "far_share": float((gap[judged] > 1.0).mean()) if judged.any() else 1.0,
            "defect_max": stat(defect, 100), "defect_p90": stat(defect, 90),
            "judged": int(judged.sum()), "uncertified": int((~cert).sum())}


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for the numbers that
    ``limits`` holds; a run with no limit or no lane to judge is not
    correct."""
    shown = {k: {"value": values[k], "limit": v["limit"]} for k, v in limits.items()}
    ok = (bool(limits) and values["judged"] > 0
          and all(values[k] <= v["limit"] for k, v in limits.items()))
    return ok, shown
