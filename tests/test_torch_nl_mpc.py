"""The port's MPC with the nonlinear constraint rows (racing_lmpc_torch/mpc/
racing_mpc.py: ``_nl_linearize`` and the row block of ``_build_qp``) on the
kinematic bicycle and the double-track, on the CPU.

- The built QP against the reference's ``_build_qp`` at N=10
  (``tests/data/torch_port/nl_qp_n10.npz``, written by
  tests/torch_port_fixture.py), the deactivated rows included: 1e-5
  relative, as tests/test_torch_qp.py holds the single-track QP, and the
  same rows at +inf.
- tests/test_nl_constraints.py's two scenarios with its gates and its
  load-bearing checks, and each plan against the reference's stored runs
  of the same scenario (``nl_kinematic.npz``, ``nl_double_track_sqp.npz``)
  within the reference's own spread between them (``chip_smoke``'s limits).
- A teacher-forced replay of the kinematic and double-track closed loops of
  tests/test_closed_loop.py:145-219 at N=10 (``ctrl_kinematic_n10.npz``,
  ``ctrl_double_track_n10.npz``) with ``chip_smoke.py``'s controller gates.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from racing_lmpc_torch.mpc.racing_mpc import REQUIRED_FIELDS, MPCInput
from tests import torch_port_fixture as tf
from tests._torch_twin import rel_err


def _fixture(case):
    with np.load(tf.fixture_path(case)) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("kind", ["kinematic", "double_track"])
def test_qp_build_matches_jax(kind):
    fx = _fixture("nl_qp_n10")
    _, _, mpc = chip_smoke.nl_problem(kind, 10, "cpu")
    L = mpc.layout
    assert L.n_nl == (2 if kind == "kinematic" else 7)
    inp = MPCInput(**{k: torch.as_tensor(fx[f"{kind}_inp_{k}"]) for k in REQUIRED_FIELDS})
    data, _ = mpc._build_qp(inp)
    for name, got in zip(("P", "q", "A", "l", "u"), data):
        want = fx[f"{kind}_{name}"]
        assert got.shape == want.shape, name
        assert rel_err(got.numpy(), want) < 1e-5, name
    # the rows whose linearization vanishes are switched off (up = +inf)
    # where the reference switches them off, and only there
    rows = slice(L.r_nl, L.r_nl + (L.N - 1) * L.n_nl)
    off = np.isinf(data.u[:, rows].numpy())
    assert np.array_equal(off, np.isinf(fx[f"{kind}_u"][:, rows]))
    # the drive/brake exclusivity rows vanish at the lanes' zero control
    # reference and hold at the third lane's nonzero one
    excl = off.reshape(3, L.N - 1, L.n_nl)[:, :, 1 if kind == "kinematic" else 5]
    assert excl[:2].all() and not excl[2].any()


def _sqp_case(case):
    """The port's SQP plan of a nonlinear-row scenario on the fixture's
    input, the same scenario without the constraint rows, and the
    fixture."""
    fx = _fixture(case)
    kind = "kinematic" if case == "nl_kinematic" else "double_track"
    c = chip_smoke.NL_KIN if kind == "kinematic" else chip_smoke.NL_DT
    model, _, mpc = chip_smoke.nl_problem(kind, c["n"], "cpu")
    inp = MPCInput(**{k: torch.as_tensor(fx[f"inp_{k}"]) for k in REQUIRED_FIELDS})
    out, _ = mpc.solve_sqp(inp, iters=c["sqp_iters"])
    free_model, _, free_mpc = chip_smoke.nl_problem(kind, c["n"], "cpu", free=True)
    free, _ = free_mpc.solve_sqp(inp, iters=c.get("free_iters", c["sqp_iters"]))
    # the reading against the reference's first run, within the largest
    # spread between its stored runs
    plan = {"U": out.U_optm.double().numpy(), "X": out.X_optm.double().numpy()}
    ref = [{"U": U.astype(np.float64), "X": X.astype(np.float64)}
           for U, X in zip(fx["U_runs"], fx["X_runs"])]
    su, sx = fx["scale_u"], fx["scale_x"]
    limits = chip_smoke.pair_limits(
        ref, lambda a, b: chip_smoke.sqp_reading(a, b, su, sx), chip_smoke.NL_SQP_FLOORS)
    got = chip_smoke.sqp_reading(plan, ref[0], su, sx)
    for k, limit in limits.items():
        assert got[k] <= limit, f"{case} {k}: {got[k]:.3e} > {limit:.3e}"
    return model, out, free_model, free


def test_nl_kinematic_power_constraint():
    """tests/test_nl_constraints.py:63-110 on the port."""
    model, out, _, free = _sqp_case("nl_kinematic")
    p_max = model.config.p_max
    X, U = out.X_optm.numpy(), out.U_optm.numpy()
    assert (X[:-1, 3] * U[:, 0]).max() <= p_max * 1.03 + 1e-6
    assert np.abs(U[:, 0] * U[:, 1]).max() <= 1.1
    Xf, Uf = free.X_optm.numpy(), free.U_optm.numpy()
    assert (Xf[:-1, 3] * Uf[:, 0]).max() > p_max * 1.1


def test_nl_double_track_friction_ellipse():
    """tests/test_nl_constraints.py:113-163 on the port."""
    model, out, free_model, free = _sqp_case("nl_double_track_sqp")
    ell = model.friction_ellipse(out.X_optm[:-1], out.U_optm)
    assert float(ell.max()) <= 0.05
    assert float(out.X_optm[:, 5].min()) >= -1e-3
    assert float(free_model.friction_ellipse(free.X_optm[:-1], free.U_optm).max()) > 0.05


@pytest.mark.parametrize("case", ["ctrl_kinematic", "ctrl_double_track"])
def test_closed_loop_replay_matches_jax(case):
    """The port's controller fed the first stored reference run's per-cycle
    states and controls, read with chip_smoke.py's controller gates against
    the reference's spread between its runs."""
    fx = _fixture(f"{case}_n10")
    assert int(fx["n"]) == 10 and len(fx["x_ctrl"]) == 9
    ctrl, _ = chip_smoke.model_controller(case, "cpu", n=10)
    got = chip_smoke.ctrl_reading(chip_smoke.replay(ctrl, fx, 0),
                                  chip_smoke.ctrl_runs(fx)[0], fx["scale_u"])
    limits = chip_smoke.ctrl_limits(fx)
    for k, limit in limits.items():
        assert got[k] <= limit, f"{case} {k}: {got[k]:.3e} > {limit:.3e}"


@pytest.mark.parametrize("case", ["nl_kinematic", "nl_double_track_sqp",
                                  "nl_double_track_b256"])
def test_nl_fixture_reads_as_chip_smoke_reads_it(case):
    """Each stored nonlinear-row case has the runs and shapes chip_smoke.py
    reads, and the reference's runs pass the gates among themselves."""
    fx = _fixture(case)
    kind, solve = tf.NL_CASES[case]
    batch = solve == "batch"
    runs = 1 + (chip_smoke.NL_BATCH_MOVED if batch else chip_smoke.NL_MOVED)
    c = chip_smoke.NL_DT_BATCH if batch else (
        chip_smoke.NL_KIN if kind == "kinematic" else chip_smoke.NL_DT)
    lead = (runs, c["batch"]) if batch else (runs,)
    nx = 4 if kind == "kinematic" else 6
    assert fx["U_runs"].shape == lead + (c["n"] - 1, 3)
    assert fx["X_runs"].shape == lead + (c["n"], nx)
    assert fx["inp_X_ref"].shape == lead[1:] + (c["n"], nx)
    assert np.isfinite(fx["U_runs"]).all() and np.isfinite(fx["obj_runs"]).all()
    su = fx["scale_u"]
    if batch:
        ref = [{"U": U.astype(np.float64), "obj": o.astype(np.float64), "solved": s,
                "ell": e.astype(np.float64)} for U, o, s, e in
               zip(fx["U_runs"], fx["obj_runs"], fx["solved_runs"], fx["ell_runs"])]
        reading = lambda a, b: chip_smoke.nl_batch_reading(a, b, su)  # noqa: E731
        floors = chip_smoke.NL_BATCH_FLOORS
    else:
        ref = [{"U": U.astype(np.float64), "X": X.astype(np.float64)}
               for U, X in zip(fx["U_runs"], fx["X_runs"])]
        reading = lambda a, b: chip_smoke.sqp_reading(a, b, su, fx["scale_x"])  # noqa: E731
        floors = chip_smoke.NL_SQP_FLOORS
    limits = chip_smoke.pair_limits(ref, reading, floors)
    assert set(limits) == set(floors)
    for a in ref:
        assert all(v <= limits[k] for k, v in reading(a, ref[0]).items())
    if kind == "double_track":
        assert fx["s_corner"] > 0 and fx["ell_runs"].shape == lead


@pytest.mark.parametrize("case", sorted(tf.MODEL_CTRL_FIXTURES))
def test_model_ctrl_fixture_reads_as_chip_smoke_reads_it(case):
    """Each stored closed loop has the horizon, cycles and runs its case
    names (the card's cases at least the cycles chip_smoke.py drives), the
    controller's previous control is the one it applied a cycle before, and
    the reference's runs pass the controller gates among themselves."""
    base, n, cycles, moved = tf.MODEL_CTRL_FIXTURES[case]
    kind, n0, _, cycles0, _ = chip_smoke.MODEL_CTRL_CASES[base]
    fx = _fixture(case)
    n, cycles = n or n0, cycles or cycles0
    nx = 4 if kind == "kinematic" else 6
    assert int(fx["n"]) == n
    assert fx["x_ctrl"].shape == (moved + 1, cycles + 1, nx)
    assert fx["x_plant"].shape == (moved + 1, cycles, nx)
    assert fx["u_apply"].shape == fx["u_ic"].shape == (moved + 1, cycles + 1, 3)
    assert np.array_equal(fx["u_ic"][:, 1:], fx["u_apply"][:, :-1])
    if case == base:
        assert chip_smoke.MODEL_CTRL_DEPTH[case] <= cycles
    limits = chip_smoke.ctrl_limits(fx)
    ref = chip_smoke.ctrl_runs(fx)
    for a in ref:
        assert all(v <= limits[k] for k, v in
                   chip_smoke.ctrl_reading(a, ref[0], fx["scale_u"]).items())
