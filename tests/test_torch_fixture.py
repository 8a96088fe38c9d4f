"""The stored reference runs that ``chip_smoke.py`` holds the port against
(tests/data/torch_port/<case>.npz, written by tests/torch_port_fixture.py).

The port must build exactly each fixture's scenario batch, so that the
comparison on the card compares like with like (safe-set points as sets
where distances tie: the JAX package queries through its native k-NN).  A
slow test regenerates the fixtures with the JAX package and checks that
they are unchanged: inputs and certified optima exactly, the reference's
own outputs to the spread its re-runs on rounding-perturbed inputs show.
"""

import numpy as np
import pytest
import torch

from racing_lmpc_torch.benchmarks import build_barc_lmpc, make_scenario_batch
from racing_lmpc_torch.mpc.racing_mpc import REQUIRED_FIELDS, MPCInput
from tests import torch_port_fixture
from tests._torch_twin import assert_same_safe_set, np_of

CASES = sorted(torch_port_fixture.CASES)
# lanes whose float64 optimum certifies (255 of 256 and 122 of 128 stored)
CERTIFIED_AT_LEAST = {"barc_n20_k48_b256": 250, "barc_n40_k96_b128": 120}


def _stored(case):
    with np.load(torch_port_fixture.fixture_path(case)) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("case", CASES)
def test_port_builds_the_fixture_batch(case):
    stored = _stored(case)
    n_horizon, num_ss, per_lap, batch = torch_port_fixture.CASES[case]
    _, track, _, mpc, manager = build_barc_lmpc(n_horizon, num_ss, per_lap, device="cpu")
    inp = make_scenario_batch(mpc, track, manager, batch,
                              seed=torch_port_fixture.SEED, device="cpu")
    for f in REQUIRED_FIELDS:
        if f not in ("ss_x", "ss_j"):
            assert np.array_equal(np_of(getattr(inp, f)), stored[f"inp_{f}"]), f
    assert_same_safe_set(np_of(inp.ss_x), np_of(inp.ss_j),
                         stored["inp_ss_x"], stored["inp_ss_j"])
    assert np.array_equal(mpc.scale_u, stored["scale_u"])
    assert stored["U_pert"].shape == (torch_port_fixture.PERT_SEEDS,) + stored["U_optm"].shape
    assert np.isfinite(stored["obj_star"]).sum() >= CERTIFIED_AT_LEAST[case]


@pytest.mark.parametrize("case", CASES)
def test_chip_smoke_gates_read_the_fixture(case, capsys):
    """chip_smoke.py reads each fixture as written; its gates pass the
    reference's own runs, and its moved inputs are the fixture's."""
    import chip_smoke
    assert chip_smoke.CASES == torch_port_fixture.CASES
    stored = _stored(case)
    limits = chip_smoke.gate_limits(stored)
    assert set(limits) == set(chip_smoke.GATE_FLOORS)
    assert all(np.isfinite(v) and v >= chip_smoke.GATE_FLOORS[k] for k, v in limits.items())
    runs = chip_smoke.reference_runs(stored)
    assert len(runs) == 1 + torch_port_fixture.PERT_SEEDS
    assert chip_smoke.held_to_reference(runs, stored, limits, case) == []
    assert "FAILS" not in capsys.readouterr().out
    inp = MPCInput(*(torch.as_tensor(stored[f"inp_{f}"]) for f in REQUIRED_FIELDS))
    rng = np.random.default_rng(torch_port_fixture.SEED + 1)
    x_ic = stored["inp_x_ic"] * (1 + 2e-7 * rng.standard_normal(stored["inp_x_ic"].shape))
    assert np.array_equal(np_of(chip_smoke.moved(inp, 0).x_ic), x_ic.astype(np.float32))


@pytest.mark.slow
@pytest.mark.parametrize("case", CASES)
def test_fixture_regenerates_unchanged(case):
    stored = _stored(case)
    fresh = torch_port_fixture.compute(case)
    assert set(fresh) == set(stored)
    for k in fresh:
        if k.startswith("inp_") or k in ("U_star", "obj_star", "scale_u"):
            np.testing.assert_allclose(fresh[k], stored[k], rtol=1e-9, atol=0, err_msg=k)
    runs = [(stored["U_optm"], stored["solved"])] + list(
        zip(stored["U_pert"], stored["solved_pert"]))
    worst = max(int((a[1] != b[1]).sum()) for i, a in enumerate(runs) for b in runs[i + 1:])
    for U_new, s_new, U_old, s_old in [
            (fresh["U_optm"], fresh["solved"], stored["U_optm"], stored["solved"]),
            *zip(fresh["U_pert"], fresh["solved_pert"], stored["U_pert"],
                 stored["solved_pert"])]:
        assert (s_new != s_old).sum() <= worst
        both = s_new & s_old
        d = np.abs(U_new - U_old) / stored["scale_u"]
        assert d[both][..., 0].max() <= 1e-3


CTRL = sorted(torch_port_fixture.CTRL_CASES)


@pytest.mark.parametrize("case", CTRL)
def test_controller_fixture_reads_as_chip_smoke_reads_it(case):
    """Each stored controller run has the shapes its case names, the
    reference's runs pass the controller gates among themselves, and
    chip_smoke.py drives the shipped-width cases for as many cycles as
    stored."""
    import chip_smoke
    scenario, steps, moved, kw = torch_port_fixture.CTRL_CASES[case]
    stored = _stored(case)
    runs, nu = moved + 1, len(stored["scale_u"])
    assert stored["x_ctrl"].shape == (runs, steps, 6)
    assert stored["u_apply"].shape == stored["u_ic"].shape == (runs, steps, nu)
    assert np.isfinite(stored["u_apply"]).all() and np.isfinite(stored["obj"]).all()
    # the controller's previous control is the one it applied a cycle before
    assert np.array_equal(stored["u_ic"][:, 1:], stored["u_apply"][:, :-1])
    limits = chip_smoke.ctrl_limits(stored)
    assert set(limits) == set(chip_smoke.CTRL_FLOORS)
    ref = chip_smoke.ctrl_runs(stored)
    for a in ref:
        assert all(v <= limits[k] for k, v in chip_smoke.ctrl_reading(a, ref[0], stored["scale_u"]).items())
    if not kw:
        assert chip_smoke.CTRL_CASES[case] == (scenario, steps)


@pytest.mark.slow
@pytest.mark.parametrize("case", CTRL)
def test_controller_fixture_regenerates_within_its_spread(case):
    """The reference's runs regenerate: the first cycle's inputs exactly,
    the rest of each run within the spread its runs show among
    themselves."""
    import chip_smoke
    stored = _stored(case)
    fresh = torch_port_fixture.compute_ctrl(case)
    assert set(fresh) == set(stored)
    assert np.array_equal(fresh["x_ctrl"][:, 0], stored["x_ctrl"][:, 0])
    limits = chip_smoke.ctrl_limits(stored)
    for a, b in zip(chip_smoke.ctrl_runs(fresh), chip_smoke.ctrl_runs(stored)):
        assert all(v <= limits[k] for k, v in chip_smoke.ctrl_reading(a, b, stored["scale_u"]).items())


def test_chip_smoke_names_the_fixture_cases():
    """chip_smoke.py (which runs without the tests package) carries its own
    copy of the fixture script's cases and inputs; they must agree."""
    import chip_smoke
    assert chip_smoke.ADMM_CASES == torch_port_fixture.ADMM_CASES
    assert chip_smoke.REGRESSION == torch_port_fixture.REGRESSION
    for case, regression in chip_smoke.CTRL_REGRESSION.items():
        assert torch_port_fixture.CTRL_CASES[case][3]["regression"] == regression
    for case, (scenario, ticks, outage) in chip_smoke.CONT_CASES.items():
        assert torch_port_fixture.CONT_CASES[case] == (scenario, ticks, 4, outage, {})
    assert chip_smoke.EKF_NOISE_STD == torch_port_fixture.EKF_NOISE_STD
    assert chip_smoke.EKF_SEED == torch_port_fixture.EKF_SEED


@pytest.mark.parametrize("case", sorted(torch_port_fixture.ADMM_CASES))
def test_admm_fixture_reads_as_chip_smoke_reads_it(case, capsys):
    """The ADMM case's outputs join the batch it shares; its reference runs
    are the batch, its moved copies and each lane solved alone; the ADMM
    gates pass the reference's own runs, and the port builds that batch."""
    import chip_smoke
    fx = chip_smoke.load_batch_fixture(case)
    base = torch_port_fixture.ADMM_CASES[case][0]
    assert fx["U_optm"].shape == _stored(base)["U_optm"].shape
    assert fx["U_alone"].shape == (2, *fx["U_optm"].shape)
    assert fx["U_pert"].shape[0] == torch_port_fixture.PERT_SEEDS
    assert len(chip_smoke.reference_runs(fx)) == torch_port_fixture.PERT_SEEDS + 3
    limits = chip_smoke.gate_limits(fx, chip_smoke.ADMM_GATE_FLOORS)
    assert set(limits) == set(chip_smoke.GATE_FLOORS) | {"lon error max"}
    assert chip_smoke.held_to_reference(chip_smoke.reference_runs(fx), fx, limits, case) == []
    assert "FAILS" not in capsys.readouterr().out


CONT = sorted(torch_port_fixture.CONT_CASES)


@pytest.mark.parametrize("case", CONT)
def test_continuous_fixture_reads_as_chip_smoke_reads_it(case):
    """Each stored continuous run has a state every plant tick and the
    controller cycles of the 25 ms schedule over 10 ms ticks, its EKF log
    one entry a cycle, and the reference's runs pass the controller gates
    among themselves."""
    import chip_smoke
    scenario, ticks, moved, outage, kw = torch_port_fixture.CONT_CASES[case]
    fx = _stored(case)
    cycles = sum(1 for k in range(ticks) if k % 5 in (0, 3))   # 0, 30, 50, 80, ... ms
    assert int(fx["published_states"]) == ticks and int(fx["controller_cycles"]) == cycles
    assert fx["x_ctrl"].shape == (moved + 1, cycles, 6) and fx["s"].shape == (moved + 1, ticks)
    assert fx["ekf_x"].shape == (moved + 1, cycles, 6) and fx["ekf_P"].shape[-2:] == (6, 6)
    assert np.array_equal(fx["u_ic"][:, 1:], fx["u_apply"][:, :-1])
    assert np.array_equal(fx["ekf_u"], fx["u_ic"])
    limits = chip_smoke.ctrl_limits(fx)
    ref = chip_smoke.ctrl_runs(fx)
    for a in ref:
        assert all(v <= limits[k] for k, v in
                   chip_smoke.ctrl_reading(a, ref[0], fx["scale_u"]).items())


def test_stack_fixture_reads_as_chip_smoke_reads_it():
    """The control-stack case: chip_smoke's inputs are the stored ones, and
    the port's LQR at the stored batch meets chip_smoke's LQR gate on the
    CPU."""
    import chip_smoke
    from racing_lmpc_torch.mpc.racing_lqr import RacingLQR
    fx = _stored("stack")
    inputs, _ = chip_smoke.stack_problem()
    assert all(np.array_equal(v, fx[k]) for k, v in inputs.items())
    assert fx["leg_U_optm_pert"].shape[0] == torch_port_fixture.LEGACY_MOVED
    model, cfg = chip_smoke.lqr_sample_model()
    B = chip_smoke.STACK_BATCH
    sol = RacingLQR(cfg, model, device="cpu").solve_batch(
        (fx["lqr_X_ref"][0] + fx["lqr_pert"]).astype(np.float32),
        np.tile(fx["lqr_X_ref"], (B, 1, 1)), np.tile(fx["lqr_U_ref"], (B, 1, 1)))
    for k in ("u", "U_optm", "X_optm"):
        want = fx[f"lqr_{k}"].astype(np.float64)
        err = np.abs(np_of(getattr(sol, k)) - want) / np.maximum(np.abs(want), 1.0)
        assert err.max() <= chip_smoke.LQR_TOL, k


@pytest.mark.slow
@pytest.mark.parametrize("case", CONT)
def test_continuous_fixture_regenerates_within_its_spread(case):
    import chip_smoke
    stored = _stored(case)
    fresh = torch_port_fixture.compute_cont(case)
    assert set(fresh) == set(stored)
    assert np.array_equal(fresh["ekf_z"][:, 0], stored["ekf_z"][:, 0])
    limits = chip_smoke.ctrl_limits(stored)
    for a, b in zip(chip_smoke.ctrl_runs(fresh), chip_smoke.ctrl_runs(stored)):
        assert all(v <= limits[k] for k, v in chip_smoke.ctrl_reading(a, b, stored["scale_u"]).items())
