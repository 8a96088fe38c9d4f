"""The port's faithful float64 OSQP (racing_lmpc_torch/mpc/osqp_ref.py) against
the JAX package's (racing_lmpc_tpu/mpc/osqp_ref.py), on the CPU.

The same problem and warm start go through both: the same status, the same
iteration count and the same polish outcome, with x and y within 1e-8
(relative to max(1, max |JAX's|)).  Problems: the pinned instance
barc_tracking_mpc_dev[6] (polish fails there), and a seeded strictly convex
QP on which polish succeeds; each from a zero and a moved warm start, with
adaptive rho off and every 25 iterations.  Then the reference-class wander
of tests/test_reference_match.py::test_reference_class_wander through the
port, and the branches of polish that give up.
"""

import numpy as np
import pytest
import torch

from tests._torch_twin import acc_instances, np_of, rel_err

DEV6 = next(d for r, d in acc_instances("barc_tracking_mpc") if r["tag"] == "barc_tracking_mpc_dev[6]")


def seeded_qp(seed: int = 7, n: int = 20, m: int = 30):
    """A strictly convex QP with box rows on random combinations.  On seed 7
    polish succeeds from every start here, and every nonzero dual has
    |y| >= 0.67, so the active set polish takes from the duals' signs does
    not hang on rounding (on seed 3 one dual is 4e-18, whose sign the two
    packages' rounding sets apart)."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    return (M.T @ M + np.eye(n), 10.0 * rng.standard_normal(n), rng.standard_normal((m, n)),
            -np.ones(m), np.ones(m))


PROBLEMS = {"barc_tracking_mpc_dev[6]": (tuple(DEV6[k] for k in "PqAlu"), DEV6["z_star"]),
            "seeded_qp": (seeded_qp(), np.zeros(20))}


@pytest.mark.parametrize("interval", [0, 25])
@pytest.mark.parametrize("start", ["zero", "moved"])
@pytest.mark.parametrize("name", list(PROBLEMS))
def test_solve_matches_jax(name, start, interval):
    from racing_lmpc_tpu.mpc import osqp_ref as jo
    from racing_lmpc_torch.mpc import osqp_ref as to
    arrays, x_star = PROBLEMS[name]
    x0 = None
    if start == "moved":
        x0 = x_star + 0.1 * np.random.default_rng(0).standard_normal(len(x_star))
    want = jo.solve(*arrays, x0=x0, adaptive_rho_interval=interval)
    got = to.solve(*(torch.as_tensor(a) for a in arrays),
                   x0=None if x0 is None else torch.as_tensor(x0),
                   adaptive_rho_interval=interval)
    assert (got.status, got.iters, got.polished) == (want.status, want.iters, want.polished)
    assert want.status == "solved"
    assert want.polished == (name == "seeded_qp")
    for k in ("x", "y", "z"):
        err = rel_err(np_of(getattr(got, k)), getattr(want, k))
        assert err < 1e-8, f"{name}: {k} lies {err:.2e} from the JAX package's"
    assert abs(got.pri_res - want.pri_res) <= 1e-8 * max(1.0, want.pri_res)
    assert abs(got.dua_res - want.dua_res) <= 1e-8 * max(1.0, want.dua_res)


def test_reference_class_wander():
    """tests/test_reference_match.py::test_reference_class_wander through
    the port: two accepted runs from different warm starts scatter in the
    tail steering by more than the engine's tail gate."""
    from racing_lmpc_torch.mpc import osqp_ref
    d = DEV6
    su = d["scale_u"]
    nx, nu = 6, len(su)
    N = d["inp_X_ref"].shape[0]
    rng = np.random.default_rng(0)
    sols = []
    for x0 in (np.zeros_like(d["z_star"]),
               d["z_star"] + 0.1 * rng.standard_normal(len(d["z_star"]))):
        res = osqp_ref.solve(*(torch.as_tensor(d[k]) for k in "PqAlu"), x0=torch.as_tensor(x0))
        assert res.status == "solved"
        sols.append(np_of(res.x)[N * nx:N * nx + (N - 1) * nu].reshape(N - 1, nu) * su)
    scatter = (np.abs(sols[0] - sols[1]) / su)[:, 1].max()
    assert scatter > 1e-2, f"reference-class wander only {scatter:.2e}"


@pytest.mark.parametrize("case", ["singular", "infinite_bound"])
def test_polish_gives_up(case):
    """Polish returns (None, None) in both packages when the reduced KKT is
    exactly singular (P = -delta I and no active row: the JAX package's
    sparse LU raises, the port's dense LU reports a zero pivot) and when a
    row is active at an infinite bound."""
    from racing_lmpc_tpu.mpc import osqp_ref as jo
    from racing_lmpc_torch.mpc import osqp_ref as to
    n, m = 4, 3
    P = -jo.POLISH_DELTA * np.eye(n)
    A, l, u = np.ones((m, n)), -np.ones(m), np.ones(m)
    y = np.zeros(m)
    if case == "infinite_bound":
        P, l, y = np.eye(n), np.array([-np.inf, -1.0, -1.0]), np.array([-1.0, 0.0, 0.0])
    arrays = (P, np.zeros(n), A, l, u, np.zeros(n), y)
    assert jo._polish(*arrays) == (None, None)
    assert to._polish(*(torch.as_tensor(a) for a in arrays)) == (None, None)
