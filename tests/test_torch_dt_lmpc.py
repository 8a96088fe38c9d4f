"""The double-track LMPC batch through the port against the JAX package.

The problem is ``chip_smoke.DT_LMPC_CASES``: the sample vehicle's
double-track on Putnam-short with the three recorded seed laps, built the
same way in both packages (``chip_smoke.dt_lmpc_problem`` for the port,
``tests/torch_port_fixture.py::dt_lmpc_problem`` for the reference).  At
the shipped learning horizons its QP (n = 275 and 244) lies past the
kernel's register variants; the card solves those in ``chip_smoke.py``'s
``dt_lmpc`` phase.  Here, on the CPU:

- a cut of the first case (N=10, K=16, 4 lanes) solved live by both
  packages on the same numpy lanes, the port's batch through
  ``solve_batch`` and the reference's lanes through its jitted
  ``_solve_impl`` (the function ``solve_batch`` vmaps; it compiles in ~100
  s on the CPU against ~145 s for the vmapped batch, most of either the
  double-track's Jacobians): ``solved`` lane by lane, the controls,
  objective and friction-ellipse residual within the batched gates' floors
  or the reference's own spread over the lanes moved by one f32 rounding;
- both shipped cases (2 of case A's 32 lanes) held the same way to the
  reference's stored runs (``tests/data/torch_port/dt_lmpc_*.npz``; the
  JAX solve at n = 275 takes minutes to compile, so it runs offline).
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from racing_lmpc_torch.mpc.racing_mpc import REQUIRED_FIELDS, MPCInput
from tests._torch_twin import np_of


def port_run(case, fields, lanes=slice(None)):
    """The port's run of ``case`` on the lanes ``lanes`` of ``fields``, its
    MPC and the lanes it builds itself."""
    model, _, mpc, own = cs.dt_lmpc_problem(case, "cpu")
    inp = MPCInput(**{k: torch.as_tensor(fields[k][lanes]) for k in REQUIRED_FIELDS})
    return cs.dt_lmpc_run(model, cs.dt_lmpc_solver(mpc, cs.DT_LMPC_CASES[case][-1])(inp)), mpc, own


def held(run, ref_runs, su):
    """The port's reading against the reference's first run, within each
    gate's floor or the reference's own spread between its runs."""
    def reading(a, b):
        return cs.nl_batch_reading(a, b, su)
    limits = cs.pair_limits(ref_runs, reading, cs.DT_LMPC_FLOORS)
    got = reading(run, ref_runs[0])
    return {k: (got[k], limits[k]) for k in limits if got[k] > limits[k]}


def test_small_batch_matches_jax_live():
    from tests import torch_port_fixture as tf
    case = "dt_lmpc_iac_n10_b4"
    model, _, mpc, fields = tf.dt_lmpc_problem(case)
    solve = tf.dt_lmpc_solver(mpc, "_solve_impl")
    ref = []
    for f in [fields] + [tf._moved_fields(fields, s) for s in range(cs.DT_LMPC_MOVED)]:
        out = solve(f)
        ref.append({"U": np_of(out.U_optm).astype(np.float64),
                    "obj": np_of(out.obj).astype(np.float64), "solved": np_of(out.solved),
                    "ell": tf._ellipse_max(model, out.X_optm, out.U_optm).astype(np.float64)})
    run, port_mpc, port_fields = port_run(case, fields)
    assert (port_mpc.layout.n, port_mpc.layout.m) == (mpc.layout.n, mpc.layout.m)
    for k in REQUIRED_FIELDS:
        np.testing.assert_allclose(port_fields[k], fields[k], rtol=1e-5, atol=1e-5, err_msg=k)
    assert np.array_equal(run["solved"], ref[0]["solved"])
    assert run["solved"].any()
    assert held(run, ref, np.asarray(port_mpc.scale_u)) == {}


@pytest.mark.parametrize("case,lanes", [("dt_lmpc_iac_n60_b32", [0, 1]),
                                        ("dt_lmpc_sample_n50_b1", [0])])
def test_shipped_horizons_hold_the_stored_reference(case, lanes):
    fx = cs.load_fixture(case)
    run, mpc, fields = port_run(case, {k: fx[f"inp_{k}"] for k in REQUIRED_FIELDS}, lanes)
    assert (mpc.layout.n, mpc.layout.m) == (int(fx["n"]), int(fx["m"]))
    assert mpc.layout.n > 240
    for k in REQUIRED_FIELDS:
        np.testing.assert_allclose(fields[k], fx[f"inp_{k}"], rtol=1e-5, atol=1e-5, err_msg=k)
    ref = cs.dt_lmpc_reference_runs(fx, lanes)
    assert np.array_equal(run["solved"], ref[0]["solved"])
    assert held(run, ref, fx["scale_u"]) == {}
