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
TRACK = RacingTrajectory.from_file(TRACK_FILE, device="cpu")


@pytest.mark.parametrize("use_native", [False, True])
def test_query_padded_matches_jax(use_native):
    laps = [tuple(np.loadtxt(f"{p}_{f}.txt") for f in "xukt") for p in BARC_LAPS]
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



def test_recorder_matches_jax(tmp_path):
    """2.5 laps driven through both recorders (tests/test_safeset.py:76-101):
    the same laps close at the same steps with the same times, the stored
    safe sets are equal, and the checkpoint files are the reference's and
    load back."""
    L = 10.0
    port = SafeSetManager(3, nx=6, pad_len=256)
    ref = JManager(3, nx=6, nu=2, pad_len=256, use_native=False)
    rec = SafeSetRecorder(port, to_file=True, file_prefix=str(tmp_path / "port_"))
    jrec = JRec(ref, to_file=True, file_prefix=str(tmp_path / "ref_"))
    s, t = 7.0, 0.0
    for i in range(260):
        x = np.array([s % L, 0.01, 0.0, 1.0, 0.0, 0.0])
        u = np.array([0.1 * np.sin(i), 0.01 * i])
        rec.step(x, u, 0.02, t, L)
        jrec.step(x, u, 0.02, t, L)
        assert (rec.lap_count, port.num_laps) == (jrec.lap_count, ref.num_laps), i
        s += 0.1
        t += 0.1
    assert rec.lap_count == 3 and port.num_laps == 2
    assert rec.lap_times == jrec.lap_times and abs(rec.lap_times[0] - 10.0) < 0.2
    for name in ("x_rep", "J_rep", "valid_rep"):
        assert np.array_equal(getattr(port, name), getattr(ref, name)), name
    for lap in (1, 2):
        for f in "xukt":
            assert (tmp_path / f"port_lap_{lap}_{f}.txt").read_text() == \
                (tmp_path / f"ref_lap_{lap}_{f}.txt").read_text()
    again = SafeSetManager(3, nx=6, pad_len=256)
    SafeSetRecorder(again).load([str(tmp_path / "port_lap_1"),
                                 str(tmp_path / "missing_lap")], L)
    assert again.num_laps == 1
