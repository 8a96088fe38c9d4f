"""The port's device spline and track model (racing_lmpc_torch/ops/spline.py,
track/trajectory.py, track/trajectory_map.py) against the JAX package's on
the same seeded abscissae and poses, and the reference's own track checks
(tests/test_track.py): the Frenet round trip, the projection seeded at the
previous abscissa and the wrap at start/finish.

Tolerances: both evaluate the same f32 spline tables with the same
operations, so values agree to a few f32 ulps of their scale (1e-5
relative); the Newton projection amplifies those ulps by its conditioning,
so abscissae agree to 1e-4 m on BARC (17 m) and 2e-3 m on Putnam (1.6 km,
where one f32 ulp of s is 1.2e-4 m).  The host twins are float64 on both
sides and agree to 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racing_lmpc_tpu.ops.spline import fit_periodic_spline as jfit
from racing_lmpc_tpu.track import RacingTrajectory as JTrack
from racing_lmpc_torch.config import TRACK_DIR
from racing_lmpc_torch.ops.spline import fit_periodic_spline
from racing_lmpc_torch.track import RacingTrajectory, RacingTrajectoryMap
from tests._torch_twin import rel_err

BARC = TRACK_DIR / "barc" / "02_barc_center.txt"
PUTNAM = TRACK_DIR / "putnam" / "3_putnam_center.txt"


@pytest.fixture(scope="module")
def barc():
    return JTrack.from_file(BARC), RacingTrajectory.from_file(BARC, device="cpu")


def f32(a):
    return np.asarray(a, np.float32)


def test_periodic_spline_matches_jax():
    rng = np.random.default_rng(0)
    knots = np.cumsum(rng.uniform(0.2, 1.0, 40)) + 3.0
    vals = rng.normal(size=(40, 3))
    period = float(knots[-1] - knots[0] + 0.5)
    j = jfit(knots, vals, period)
    t = fit_periodic_spline(knots, vals, period, torch.device("cpu"))
    assert np.array_equal(np.asarray(j.coeffs), t.coeffs.numpy())
    assert np.array_equal(np.asarray(j.breaks), t.breaks.numpy())
    # inside, on the knots, and wrapped from below and above the period
    s = f32(np.concatenate([rng.uniform(-2 * period, 3 * period, 500), knots]))
    for name in ("eval", "eval_d", "eval_d2"):
        got = getattr(t, name)(torch.as_tensor(s)).numpy()
        want = np.asarray(getattr(j, name)(jnp.asarray(s)))
        assert rel_err(got, want) < 1e-5, name


def test_track_accessors_match_jax(barc):
    j, t = barc
    s = f32(np.linspace(-3, 40, 301))
    for name in ("position", "velocity", "left_boundary", "right_boundary",
                 "yaw", "curvature"):
        got = getattr(t, name)(torch.as_tensor(s)).numpy()
        want = np.asarray(getattr(j, name)(jnp.asarray(s)))
        assert rel_err(got, want) < 1e-5, name
    assert t.total_length == j.total_length


def test_frenet_round_trip_matches_jax(barc):
    j, t = barc
    rng = np.random.default_rng(7)
    n = 64
    L = t.total_length
    pf = f32(np.stack([rng.uniform(0, L, n), rng.uniform(-0.3, 0.3, n),
                       rng.uniform(-0.5, 0.5, n)], axis=-1))
    pg = t.frenet_to_global(torch.as_tensor(pf))
    assert rel_err(pg.numpy(), np.asarray(j.frenet_to_global(jnp.asarray(pf)))) < 1e-5
    back = t.global_to_frenet(pg).numpy()
    back_j = np.asarray(j.global_to_frenet(jnp.asarray(pg.numpy())))
    assert np.abs(back[:, 0] - back_j[:, 0]).max() < 1e-4
    assert np.abs(back[:, 1:] - back_j[:, 1:]).max() < 1e-4
    # and the reference's own round-trip gate
    s_err = np.abs(np.mod(back[:, 0] - pf[:, 0] + L / 2, L) - L / 2)
    assert s_err.max() < 2e-3 and np.abs(back[:, 1] - pf[:, 1]).max() < 2e-3
    seed = t.nearest_waypoint_abscissa(pg[:, :2]).numpy()
    assert np.array_equal(seed, np.asarray(j.nearest_waypoint_abscissa(jnp.asarray(pg.numpy()[:, :2]))))


def test_previous_seed_and_start_finish_wrap(barc):
    j, t = barc
    L = t.total_length
    pg = t.frenet_to_global(torch.tensor([[5.0, 0.1, 0.0]]))
    out = t.global_to_frenet(pg, s_prev=torch.tensor([4.8])).numpy()
    assert np.isclose(out[0, 0], 5.0, atol=1e-3) and np.isclose(out[0, 1], 0.1, atol=1e-3)
    pg = t.frenet_to_global(torch.tensor([[L - 0.05, 0.0, 0.0]]))
    out = t.global_to_frenet(pg).numpy()
    want = np.asarray(j.global_to_frenet(jnp.asarray(pg.numpy())))
    assert np.abs(out - want).max() < 1e-4
    d = np.mod(out[0, 0] + 0.05, L)
    assert min(d, L - d) < 1e-2


def test_long_track_round_trip_matches_jax():
    j, t = JTrack.from_file(PUTNAM), RacingTrajectory.from_file(PUTNAM, device="cpu")
    rng = np.random.default_rng(8)
    n = 32
    pf = f32(np.stack([rng.uniform(0, t.total_length, n), rng.uniform(-2, 2, n),
                       np.zeros(n)], axis=-1))
    pg = t.frenet_to_global(torch.as_tensor(pf)).numpy()
    back = t.global_to_frenet(torch.as_tensor(pg)).numpy()
    back_j = np.asarray(j.global_to_frenet(jnp.asarray(pg)))
    assert np.abs(back[:, 0] - back_j[:, 0]).max() < 2e-3
    assert np.abs(back[:, 1] - back_j[:, 1]).max() < 2e-3


def test_host_twins_match_jax(barc):
    j, t = barc
    rng = np.random.default_rng(3)
    L = t.total_length
    pf = np.stack([rng.uniform(0, L, 40), rng.uniform(-0.3, 0.3, 40),
                   rng.uniform(-0.5, 0.5, 40)], axis=-1)
    pg = t.frenet_to_global(torch.as_tensor(f32(pf))).numpy().astype(np.float64)
    np.testing.assert_allclose(t.global_to_frenet_np(pg), j.global_to_frenet_np(pg),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(t.global_to_frenet_np(pg, s_prev=pf[:, 0]),
                               j.global_to_frenet_np(pg, s_prev=pf[:, 0]),
                               rtol=0, atol=1e-9)
    assert np.array_equal(t.nearest_waypoint_abscissa_np(pg[:, :2]),
                          j.nearest_waypoint_abscissa_np(pg[:, :2]))


def test_trajectory_map():
    m = RacingTrajectoryMap(TRACK_DIR / "barc", device="cpu")
    assert m.indices() == [2, 15]
    assert m.names[2] == "barc_center"
    assert m.get_trajectory(15).total_length > 10.0
