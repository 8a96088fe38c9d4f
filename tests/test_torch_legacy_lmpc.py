"""The port's legacy full-dynamics controller (``RacingLMPCLegacy``)
against stored JAX runs and with the checks of tests/test_aux.py's legacy
test.

The JAX controller takes about a minute to compile on the CPU, so its three
solves (and the same solves from initial states moved by one f32 rounding)
are stored in tests/data/torch_port/stack.npz (tests/torch_port_fixture.py)
and the port is held to them with ``chip_smoke.py``'s legacy gates: each
control within the reference's worst reading between its own runs, or 1e-3
(longitudinal) / 3e-3 (steering) of scale_u and 1e-3 on the rollout where
those are looser.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import racing_lmpc_torch.config as tc
from racing_lmpc_torch.control import RacingLMPCLegacy, RacingLMPCLegacyConfig
from racing_lmpc_torch.models import SingleTrackPlanarModel
from racing_lmpc_torch.track import RacingTrajectory
from tests import torch_port_fixture
from tests._torch_twin import np_of


@pytest.fixture(scope="module")
def legacy():
    with np.load(torch_port_fixture.fixture_path("stack")) as z:
        fx = {k: z[k] for k in z.files}
    inputs, cfg = chip_smoke.stack_problem()
    track = RacingTrajectory.from_file(tc.TRACK_DIR / "barc" / "02_barc_center.txt",
                                       device="cpu")
    model = SingleTrackPlanarModel(*tc.barc_vehicle())
    ctrl = RacingLMPCLegacy(RacingLMPCLegacyConfig(**cfg), model, track)
    outs = [ctrl.solve(x0, inputs["leg_X_ref"], np.zeros((cfg["n"] - 1, 2), np.float32),
                       float(inputs["leg_dt"])) for x0 in inputs["leg_x_ic"]]
    return fx, inputs, cfg, ctrl, outs


def test_legacy_matches_stored_jax_runs(legacy):
    fx, inputs, _, ctrl, outs = legacy
    for k, v in inputs.items():
        assert np.array_equal(v, fx[k]), k
    assert all(bool(o.solved) for o in outs) and fx["leg_solved"].all()
    su = ctrl.mpc.scale_u
    runs = [(fx["leg_U_optm"], fx["leg_X_optm"])] + list(
        zip(fx["leg_U_optm_pert"], fx["leg_X_optm_pert"]))
    spread = [chip_smoke.legacy_reading(*a, *b, su) for i, a in enumerate(runs)
              for b in runs[i + 1:]]
    got = chip_smoke.legacy_reading(np.stack([np_of(o.U_optm) for o in outs]),
                                    np.stack([np_of(o.X_optm) for o in outs]),
                                    fx["leg_U_optm"], fx["leg_X_optm"], su)
    for k, floor in chip_smoke.LEGACY_FLOORS.items():
        assert got[k] <= max(floor, *(r[k] for r in spread)), (k, got[k])


def test_legacy_tracks_centerline(legacy):
    """tests/test_aux.py:162-208 on the port: an in-bounds plan whose X is
    the nonlinear rollout of its U, near the reference speed."""
    _, inputs, cfg, ctrl, outs = legacy
    out, x_ic, dt = outs[0], inputs["leg_x_ic"][0], float(inputs["leg_dt"])
    X, U = np_of(out.X_optm), np_of(out.U_optm)
    assert np.isfinite(X).all() and np.isfinite(U).all()
    assert np.all(np.abs(U[:, 0]) <= 0.011) and np.all(np.abs(U[:, 1]) <= 0.34)
    x = torch.as_tensor(x_ic)
    for i in range(cfg["n"] - 1):
        x = ctrl.model.discrete_dynamics(x, torch.as_tensor(U[i]), ctrl.track.curvature(x[0]),
                                         torch.tensor(dt))
    np.testing.assert_allclose(np_of(x), X[-1], atol=1e-5)
    assert np.max(np.abs(X[:, 1])) < 0.5
    assert abs(X[-1, 3] - 1.5) < 1.0
