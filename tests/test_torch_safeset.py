"""Port safe set (racing_lmpc_torch/safeset) and the carry of recorded laps
against the JAX package's SafeSetManager: its numpy query path exactly, its
native k-NN path as sets (equidistant points may come back in another
order)."""

import numpy as np
import pytest

from racing_lmpc_tpu.benchmarks import BARC_LAPS
from racing_lmpc_tpu.safeset import SafeSetManager as JManager, SafeSetRecorder as JRec
from racing_lmpc_torch.carry import safe_set_from_laps
from racing_lmpc_torch.safeset import SafeSetManager, SafeSetRecorder
from racing_lmpc_torch.track import RacingTrajectory
from racing_lmpc_torch.config import TRACK_DIR
from tests._torch_twin import assert_same_safe_set

TRACK_FILE = TRACK_DIR / "barc" / "02_barc_center.txt"
TRACK = RacingTrajectory.from_file(TRACK_FILE)


@pytest.mark.parametrize("use_native", [False, True])
def test_query_padded_matches_jax(use_native):
    laps = [np.loadtxt(f"{p}_x.txt") for p in BARC_LAPS]
    port = safe_set_from_laps(laps, TRACK.total_length, max_laps=3)
    loaded = SafeSetManager(3)
    SafeSetRecorder(loaded).load(BARC_LAPS, TRACK.total_length)
    ref = JManager(3, nx=6, nu=2, use_native=use_native)
    JRec(ref).load(BARC_LAPS, TRACK.total_length)
    rng = np.random.default_rng(0)
    for s in rng.uniform(0, TRACK.total_length, 20):
        xq = np.array([s, rng.uniform(-0.2, 0.2), 0, 2.0, 0, 0], np.float32)
        for K, per_lap in ((48, 16), (96, 32), (16, 8)):
            x, J, ok = port.query_padded(xq, K, per_lap)
            x2, J2, _ = loaded.query_padded(xq, K, per_lap)
            xr, Jr, okr = ref.query_padded(xq, K, per_lap)
            assert ok and okr
            assert np.array_equal(x, x2) and np.array_equal(J, J2)
            if use_native:
                assert_same_safe_set(x[None], J[None], xr[None], Jr[None])
            else:
                assert np.array_equal(x, xr) and np.array_equal(J, Jr)


def test_track_host_evaluators_match_jax():
    from racing_lmpc_tpu.track import RacingTrajectory as JTrack
    jt = JTrack.from_file(TRACK_FILE)
    s = np.linspace(-3, 40, 301)
    for f in ("velocity_np", "left_boundary_np", "right_boundary_np", "yaw_np",
              "curvature_np"):
        np.testing.assert_allclose(getattr(TRACK, f)(s), getattr(jt, f)(s),
                                   rtol=1e-12, atol=1e-12, err_msg=f)
    assert TRACK.total_length == jt.total_length

