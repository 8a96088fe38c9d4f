"""The port's native host runtime (racing_lmpc_torch/native) against the JAX
package's binding of the same C++ source.

The nine cases of tests/test_native.py run against the port's binding; the
two C++ sources must be byte-equal; the two bindings must give identical
answers (the table, the k-NN indices and squared distances, the safe-set
rows with their cost-to-go, the profiler's stats) on seeded data with
duplicated and equidistant points, where the reference's native path and
its numpy fallback break ties differently; the port's ``SafeSetManager``
and ``nearest_waypoint_abscissa_np`` must equal the JAX package's defaults
(its native path) on those ties; and ``use_native=True`` must raise, never
fall back quietly, when the compiler fails.
"""

from pathlib import Path

import numpy as np
import pytest

from racing_lmpc_torch import native
from racing_lmpc_torch.config import TRACK_DIR

import tests._torch_twin  # noqa: F401  (one torch thread per test worker)

BARC = TRACK_DIR / "barc" / "02_barc_center.txt"


def _jax_native():
    from racing_lmpc_tpu import native as jnative
    assert jnative.available(), jnative.build_error()
    return jnative


# ---------------------------------------------------------------------------
# the nine cases of tests/test_native.py, against the port's binding
# ---------------------------------------------------------------------------

def test_table_loader_matches_numpy():
    a = native.load_table(BARC)
    b = np.loadtxt(BARC)
    assert a.shape == b.shape == (b.shape[0], 17)
    np.testing.assert_allclose(a, b, rtol=0, atol=0)


def test_table_loader_missing_file():
    with pytest.raises(OSError):
        native.load_table("/nonexistent/file.txt")


def test_kdtree_knn_matches_bruteforce():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(777, 2)).astype(np.float32)
    tree = native.KdTree2D(pts)
    q = rng.normal(size=(64, 2)).astype(np.float32) * 2.0
    k = 7
    idx, d2 = tree.knn(q, k)
    bf = np.sum((q[:, None, :] - pts[None]) ** 2, axis=-1)
    d2_bf = np.sort(bf, axis=1)[:, :k]
    np.testing.assert_allclose(np.sort(d2, axis=1), d2_bf, rtol=1e-6)
    np.testing.assert_allclose(
        np.take_along_axis(bf, idx.astype(np.int64), axis=1), d2, rtol=1e-6)


def test_kdtree_k_larger_than_n():
    tree = native.KdTree2D(np.zeros((3, 2), dtype=np.float32))
    idx, d2 = tree.knn(np.ones((1, 2), dtype=np.float32), 5)
    assert (idx[0, 3:] == -1).all() and np.isinf(d2[0, 3:]).all()


def _make_laps(rng, L=17.0, n_laps=3):
    laps = []
    for lap in range(n_laps):
        T = 150 + 11 * lap
        x = rng.normal(size=(T, 6)).astype(np.float32) * 0.3
        x[:, 0] = np.linspace(0, L, T, endpoint=False)
        u = rng.normal(size=(T, 2)).astype(np.float32)
        laps.append((x, u, np.zeros(T), np.arange(T) * 0.025))
    return laps


def test_native_safe_set_matches_python_query():
    from racing_lmpc_torch.safeset.safe_set import SafeSetManager, SSQuery
    rng = np.random.default_rng(11)
    L = 17.0
    mgr_py = SafeSetManager(max_laps=3, nx=6, use_native=False)
    mgr_nat = SafeSetManager(max_laps=3, nx=6, use_native=True)
    assert mgr_py._native is None and mgr_nat._native is not None
    for x, u, k, t in _make_laps(rng, L):
        mgr_py.add_lap(x, u, k, t, L)
        mgr_nat.add_lap(x, u, k, t, L)
    for qs in (0.3, 8.0, 16.9):
        q = SSQuery(np.array([qs, 0.05, 0, 1.5, 0, 0], dtype=np.float32), 1.0, 48, 16)
        a, b = mgr_py.query(q), mgr_nat.query(q)
        assert a.x.shape == b.x.shape
        np.testing.assert_allclose(np.sort(a.x[:, 0]), np.sort(b.x[:, 0]), atol=1e-6)
        np.testing.assert_allclose(np.sort(a.J), np.sort(b.J), atol=1e-6)


def test_native_safe_set_ring_buffer_eviction():
    ss = native.NativeSafeSet(max_laps=2, nx=6)
    for x, u, k, t in _make_laps(np.random.default_rng(5), n_laps=3):
        ss.add_lap(x, 17.0)
    assert ss.num_laps == 2


def test_cycle_profiler_window():
    prof = native.CycleProfiler(4)
    for v in [5.0, 1.0, 3.0, 2.0, 4.0]:  # first value evicted
        prof.add(v)
    st = prof.stats()
    assert st["count"] == 4
    assert st["min"] == 1.0 and st["max"] == 4.0
    assert abs(st["mean"] - 2.5) < 1e-12


def test_bus_pubsub_order_and_flush():
    bus = native.Bus()
    got, other = [], []
    bus.subscribe("a", lambda t, p: got.append(p))
    bus.subscribe("b", lambda t, p: other.append(p))
    for i in range(20):
        bus.publish("a", bytes([i]))
    bus.publish("b", b"x")
    bus.flush()
    assert got == [bytes([i]) for i in range(20)]  # serialized, in order
    assert other == [b"x"]
    assert bus.delivered == 21
    bus.close()


def test_bus_cosimulation_smoke():
    """5 lock-step cycles of simulator<->controller over the bus."""
    from racing_lmpc_torch.launch.runner import _SCENARIOS, BusCoSimulation
    cosim = BusCoSimulation(_SCENARIOS["barc_tracking_mpc"], n_override=10, device="cpu")
    try:
        summary = cosim.run(5, timeout_s=300.0)
        assert summary["steps"] == 5
        assert summary["bus_messages"] >= 10  # 5 state + 5 actuation
        assert summary["fallback_rate"] <= 0.4
    finally:
        cosim.close()


# ---------------------------------------------------------------------------
# the port's copy of the source and its answers against the JAX binding's
# ---------------------------------------------------------------------------

def test_sources_byte_equal():
    ref = (Path(__file__).resolve().parents[1] / "racing_lmpc_tpu" / "native" / "src"
           / "lmpc_runtime.cpp")
    assert native.SRC.read_bytes() == ref.read_bytes()
    assert native.library_path().parent.name == "build"


def _tie_points(rng) -> np.ndarray:
    """A unit grid (every cell centre is equidistant from its 4 corners)
    with some points duplicated, plus seeded scatter."""
    g = np.stack(np.meshgrid(np.arange(12.0), np.arange(9.0)), -1).reshape(-1, 2)
    dup = g[rng.choice(len(g), 20, replace=False)]
    scatter = rng.uniform(0, 11, (40, 2))
    pts = np.concatenate([g, dup, scatter]).astype(np.float32)
    return pts[rng.permutation(len(pts))]


def test_bindings_agree_on_ties(tmp_path):
    jn = _jax_native()
    rng = np.random.default_rng(17)
    pts = _tie_points(rng)
    # the table loader, on the track and on a seeded table
    table = tmp_path / "t.txt"
    np.savetxt(table, rng.normal(size=(31, 5)))
    for path in (BARC, table):
        assert np.array_equal(native.load_table(path), jn.load_table(path))
    # k-NN: cell centres (4-way ties), the points themselves (duplicates)
    # and seeded queries
    centres = np.stack(np.meshgrid(np.arange(11.0) + 0.5, np.arange(8.0) + 0.5),
                       -1).reshape(-1, 2)
    q = np.concatenate([centres, pts[:30], rng.uniform(-1, 12, (30, 2))]).astype(np.float32)
    for k in (1, 4, 9):
        i_t, d_t = native.KdTree2D(pts).knn(q, k)
        i_j, d_j = jn.KdTree2D(pts).knn(q, k)
        assert np.array_equal(i_t, i_j) and np.array_equal(d_t, d_j), k
    # the data holds ties that a tie-break decides
    _, d4 = native.KdTree2D(pts).knn(centres.astype(np.float32), 4)
    assert (d4[:, :-1] == d4[:, 1:]).any(axis=1).sum() >= len(centres) // 2
    # safe-set rows with J, on laps whose states repeat and sit on a grid
    ss_t, ss_j = native.NativeSafeSet(3, 6), jn.NativeSafeSet(3, 6)
    for lap in range(4):
        T = 40 + lap
        x = np.zeros((T, 6), np.float32)
        x[:, 0] = np.floor(np.linspace(0, 17.0, T, endpoint=False) * 2) / 2
        x[:, 1] = (np.arange(T) % 3 - 1) * 0.25
        x[:, 3] = rng.normal(size=T)
        ss_t.add_lap(x, 17.0)
        ss_j.add_lap(x, 17.0)
    for qs in (0.0, 0.25, 8.5, 16.75, 17.0):
        for total, per_lap in ((24, 8), (40, 16), (5, 5)):
            a, b = (s.query(np.array([qs, 0.125], np.float32), total, per_lap)
                    for s in (ss_t, ss_j))
            assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    # the profiler's stats
    p_t, p_j = native.CycleProfiler(16), jn.CycleProfiler(16)
    for v in rng.exponential(size=40):
        p_t.add(v)
        p_j.add(v)
    assert p_t.stats() == p_j.stats()


def test_safe_set_manager_matches_jax_default_on_ties():
    from racing_lmpc_tpu.safeset.safe_set import SafeSetManager as JManager
    from racing_lmpc_torch.safeset.safe_set import SafeSetManager, SSQuery
    rng = np.random.default_rng(23)
    port, ref = SafeSetManager(3, nx=6), JManager(3, nx=6)
    assert ref._native is not None       # the reference's default path
    for lap in range(3):
        T = 60 + 7 * lap
        x = rng.normal(size=(T, 6)).astype(np.float32) * 0.1
        # abscissa on a 0.25 grid, lateral offsets in {-0.1, 0, 0.1}: queries
        # half-way between grid points are equidistant from both
        x[:, 0] = np.round(np.linspace(0, 17.0, T, endpoint=False) * 4) / 4
        x[:, 1] = (np.arange(T) % 3 - 1) * 0.1
        u = rng.normal(size=(T, 2)).astype(np.float32)
        port.add_lap(x, u, np.zeros(T), np.arange(T) * 0.025, 17.0)
        ref.add_lap(x, u, np.zeros(T), np.arange(T) * 0.025, 17.0)
    for qs in (0.125, 4.375, 8.5, 16.875):
        q = SSQuery(np.array([qs, 0.0, 0, 1.5, 0, 0], np.float32), 1.0, 48, 16)
        a, b = port.query(q), ref.query(q)
        assert np.array_equal(a.x, b.x) and np.array_equal(a.J, b.J), qs
        pa, pb = (m.query_padded(q.x, 48, 16) for m in (port, ref))
        assert all(np.array_equal(u, v) for u, v in zip(pa, pb)), qs


def test_nearest_waypoint_matches_jax_default_on_ties():
    from racing_lmpc_tpu.track import RacingTrajectory as JTrack
    from racing_lmpc_torch.track import RacingTrajectory
    port = RacingTrajectory.from_file(BARC, device="cpu")
    ref = JTrack.from_file(BARC)
    assert ref._kdtree is not None and port._kdtree is not None
    assert np.array_equal(port._wp_xy_np, ref._wp_xy_np)
    wp = port._wp_xy_np
    mids = 0.5 * (wp + np.roll(wp, -1, axis=0))      # equidistant from two
    rng = np.random.default_rng(29)
    q = np.concatenate([wp, mids, wp + rng.normal(size=wp.shape) * 0.3])
    got = port.nearest_waypoint_abscissa_np(q)
    assert np.array_equal(got, ref.nearest_waypoint_abscissa_np(q))
    # and the host projection it seeds
    poses = np.concatenate([q, rng.uniform(-np.pi, np.pi, (len(q), 1))], axis=1)
    np.testing.assert_allclose(port.global_to_frenet_np(poses),
                               ref.global_to_frenet_np(poses), rtol=0, atol=1e-9)


def test_use_native_raises_when_the_compiler_fails(monkeypatch):
    from racing_lmpc_torch.safeset.safe_set import SafeSetManager
    from racing_lmpc_torch.track import RacingTrajectory
    monkeypatch.setattr(native, "CXX", "no-such-compiler-for-this-test")
    assert not native.available()
    assert "no-such-compiler-for-this-test" in native.build_error()
    with pytest.raises(RuntimeError, match="native runtime unavailable"):
        SafeSetManager(3)
    with pytest.raises(RuntimeError, match="native runtime unavailable"):
        RacingTrajectory.from_file(BARC, device="cpu")
    with pytest.raises(RuntimeError, match="native runtime unavailable"):
        RacingTrajectory(np.loadtxt(BARC), device="cpu")
    # the numpy paths, asked for, need no compiler
    assert SafeSetManager(3, use_native=False)._native is None
    track = RacingTrajectory.from_file(BARC, device="cpu", use_native=False)
    assert track._kdtree is None
    monkeypatch.undo()
    assert native.available()
