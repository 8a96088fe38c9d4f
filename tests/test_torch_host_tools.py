"""The port's host tools and the tail of the JAX package, against the JAX
modules on seeded inputs.

- ``ops/transform.py``: the quaternion helpers and the pose matrix are the
  same numpy arithmetic and must agree bit for bit; ``calc_yaw_difference``
  wraps in f32 as the reference does, whose f32 sin/cos/atan2 (XLA's) and
  torch's may round the last bit differently: within 2 f32 ulps of pi.
- ``ops/math.py``'s ``norm_2`` and the three planar rotations: the same f32
  operations, within 2 f32 ulps of the largest value (the sin/cos of the
  two libraries again); ``ops/compensated.py``'s ``add_dw`` bit for bit and
  ``matvec_acc_compensated`` as tests/test_torch_compensated.py holds the
  rest: the value lane bit for bit, the error lane (an ordinary sum, its
  order free) within 1e-6 of the sum.
- the five messages: the same fields, defaults and ``asdict``.
- the visualizer: polylines, prediction path and markers within 1e-5 (the
  port evaluates the track's float64 host twins, the reference its f32
  device splines); ``plot_run`` writes a PNG.
- the live feed: ``/scene``, ``/`` and ``/stream``, and attached to the
  port's ``CoSimulation`` (BARC LMPC, N=10, 3 cycles) a snapshot of the JAX
  feed's schema.
- ``ProfilerTrace`` writes a Chrome trace.
- the IPM's pivoted-LU branch (``solve_qp_ip`` without ``eq_rows``) against
  JAX's on seeded QPs with equality, one-sided and two-sided rows, and on
  8 copies with q moved by one f32 rounding (``chip_smoke.lu_moved``): every
  solve converges (``rp_rel``, ``rd_rel`` < 1e-3, the solved test); the
  median over the 9 inputs of the port's x and objective against the
  reference's stays within the reference's own worst reading between its
  runs, or the floors 5e-4 and 1e-5 of max(1, |value|) where looser
  (``chip_smoke.lu_limits``: the IPM's 1e-3 termination leaves x loosely
  determined on such QPs, so one f32 rounding of q moves the reference's
  own x well past the floor); and x no farther from the certified float64
  optimum than the reference's x plus 1e-4.
"""

import dataclasses
import json
import urllib.request

import numpy as np
import pytest
import torch

from tests._torch_twin import np_of, twin

import racing_lmpc_tpu.msgs as jmsgs
import racing_lmpc_torch.msgs as tmsgs
from racing_lmpc_torch.config import TRACK_DIR

BARC = TRACK_DIR / "barc" / "02_barc_center.txt"
F32_ULP_PI = 2 * np.spacing(np.float32(np.pi))


def test_transform_matches_jax():
    from racing_lmpc_tpu.ops import transform as jt
    from racing_lmpc_torch.ops import transform as tt
    rng = np.random.default_rng(2)
    for yaw in np.concatenate([[-3.0, -1.0, 0.0, 0.5, 2.9, np.pi], rng.uniform(-7, 7, 20)]):
        q = tt.quaternion_from_heading(yaw)
        assert q == jt.quaternion_from_heading(yaw)
        assert tt.heading_from_quaternion(*q) == jt.heading_from_quaternion(*q)
        assert np.isclose(tt.heading_from_quaternion(*q), np.arctan2(np.sin(yaw), np.cos(yaw)),
                          atol=1e-9)
        x, y = rng.normal(size=2)
        assert np.array_equal(tt.pose_matrix(x, y, yaw), jt.pose_matrix(x, y, yaw))
        y2 = rng.uniform(-7, 7)
        assert abs(tt.calc_yaw_difference(yaw, y2) - jt.calc_yaw_difference(yaw, y2)) \
            <= F32_ULP_PI
    assert np.isclose(tt.calc_yaw_difference(3.0, -3.0), 0.2831853, atol=1e-5)


@pytest.mark.parametrize("fn", ["norm_2", "global_to_frenet_rotation",
                                "body_to_spatial_velocity", "spatial_to_body_velocity"])
def test_math_functions_match_jax(fn):
    import racing_lmpc_tpu.ops.math as jm
    import racing_lmpc_torch.ops.math as tm
    rng = np.random.default_rng(len(fn))
    p = (rng.normal(size=(7, 5, 2)) * 10).astype(np.float32)
    p0 = (rng.normal(size=(7, 5, 2)) * 10).astype(np.float32)
    yaw = rng.uniform(-4, 4, (7, 5)).astype(np.float32)
    args = {"norm_2": (p,), "global_to_frenet_rotation": (p, p0, yaw)}.get(fn, (p, yaw))
    j, t = twin(getattr(jm, fn), getattr(tm, fn), *args)
    assert j.shape == t.shape and t.dtype == np.float32
    assert np.abs(j - t).max() <= 2 * np.spacing(np.abs(j).max())
    if fn == "norm_2":
        assert np.allclose(t, np.hypot(p[..., 0], p[..., 1]), rtol=1e-6)
    from racing_lmpc_torch.ops import __all__ as exported
    if fn in ("norm_2", "global_to_frenet_rotation"):
        assert fn in exported


def test_rotations_invert():
    import racing_lmpc_torch.ops.math as tm
    rng = np.random.default_rng(9)
    v = torch.as_tensor(rng.normal(size=(50, 2)), dtype=torch.float32)
    yaw = torch.as_tensor(rng.uniform(-4, 4, 50), dtype=torch.float32)
    back = tm.spatial_to_body_velocity(tm.body_to_spatial_velocity(v, yaw), yaw)
    assert torch.allclose(back, v, atol=1e-6)
    assert torch.allclose(tm.norm_2(tm.body_to_spatial_velocity(v, yaw)), tm.norm_2(v),
                          rtol=1e-6)


@pytest.mark.parametrize("n", [1, 7, 64, 201])
def test_add_dw_and_matvec_acc_match_jax(n):
    from racing_lmpc_tpu.ops import compensated as jc
    from racing_lmpc_torch.ops import compensated as tc
    rng = np.random.default_rng(n)
    A = (rng.standard_normal((9, n)) * 10.0 ** rng.uniform(-3, 3, (9, n))).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(9).astype(np.float32)
    hi = rng.standard_normal(9).astype(np.float32)
    lo = (hi * 1e-8 * rng.standard_normal(9)).astype(np.float32)
    j, t = twin(jc.add_dw, tc.add_dw, hi, lo, b)
    assert all(np.array_equal(u, v) for u, v in zip(j, t))
    (hj, lj), (ht, lt) = twin(jc.matvec_acc_compensated, tc.matvec_acc_compensated, A, x, b)
    assert np.array_equal(hj, ht)
    scale = max(1.0, np.abs(hj).max())
    assert np.abs(lj - lt).max() <= 1e-6 * scale
    ref = A.astype(np.float64) @ x + b
    assert np.abs(ht.astype(np.float64) + lt - ref).max() <= 1e-11 * scale


@pytest.mark.parametrize("name", ["PredictionMsg", "ControllerStatusMsg", "EncoderMsg",
                                  "TimingMsg", "TrackLookaheadMsg"])
def test_messages_match_jax(name):
    jcls, tcls = getattr(jmsgs, name), getattr(tmsgs, name)
    jf, tf = dataclasses.fields(jcls), dataclasses.fields(tcls)
    assert [(f.name, f.type) for f in jf] == [(f.name, f.type) for f in tf]
    assert dataclasses.asdict(jcls()) == dataclasses.asdict(tcls())
    rng = np.random.default_rng(len(name))
    kw = {}
    for f in tf:
        kw[f.name] = {"list": [float(v) for v in rng.normal(size=4)], "int": 3,
                      "str": "ok"}.get(f.type, float(rng.normal()))
    assert dataclasses.asdict(jcls(**kw)) == dataclasses.asdict(tcls(**kw))
    json.dumps(dataclasses.asdict(tcls(**kw)))


@pytest.fixture(scope="module")
def tracks():
    from racing_lmpc_tpu.track import RacingTrajectory as JTrack
    from racing_lmpc_torch.track import RacingTrajectory
    return JTrack.from_file(BARC), RacingTrajectory.from_file(BARC, device="cpu")


def test_visualizer_matches_jax(tracks, tmp_path):
    from racing_lmpc_tpu.track.visualizer import TrajectoryVisualizer as JViz
    from racing_lmpc_torch.track import visualizer as tv
    from racing_lmpc_torch.track.visualizer import TrajectoryVisualizer
    assert tv.ABSCISSA_SAMPLES == 1000
    jv, t = JViz(tracks[0], num_samples=200), TrajectoryVisualizer(tracks[1], num_samples=200)
    jl, tl = jv.polylines(), t.polylines()
    assert set(jl) == set(tl)
    for k in jl:
        assert tl[k].shape == np.asarray(jl[k]).shape
        assert np.abs(tl[k] - np.asarray(jl[k])).max() < 1e-5, k
    widths = np.linalg.norm(tl["left"] - tl["right"], axis=-1)
    assert np.all(widths > 0.5) and np.all(widths < 2.0)
    rng = np.random.default_rng(4)
    X = np.zeros((12, 6), dtype=np.float32)
    X[:, 0] = np.linspace(0, 18.5, 12)          # across the start line
    X[:, 1] = rng.uniform(-0.3, 0.3, 12)
    X[:, 2] = rng.uniform(-0.5, 0.5, 12)
    path = t.prediction_path(X)
    jpath = np.asarray(jv.prediction_path(X))
    assert path.shape == (12, 3)
    assert np.abs(path[:, :2] - jpath[:, :2]).max() < 1e-5
    dyaw = np.angle(np.exp(1j * (path[:, 2] - jpath[:, 2])))
    assert np.abs(dyaw).max() < 1e-5
    assert np.abs(t.safe_set_markers(X) - path).max() == 0.0
    pose = np.array([0.4, -0.2, np.pi / 3])
    assert np.array_equal(t.vehicle_polygon(pose, 0.3, 0.2), jv.vehicle_polygon(pose, 0.3, 0.2))
    t.export_json(tmp_path / "lines.json")
    data = json.loads((tmp_path / "lines.json").read_text())
    assert set(data) == set(jl) and len(data["center"]) == 200


def test_visualizer_plot_run(tracks, tmp_path):
    pytest.importorskip("matplotlib")
    from racing_lmpc_torch.track.visualizer import TrajectoryVisualizer
    viz = TrajectoryVisualizer(tracks[1], num_samples=200)
    xy = viz.polylines()["center"][:50]
    out = tmp_path / "lap.png"
    viz.plot_run(xy, out, speeds=np.linspace(1, 3, 50), title="test lap")
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert out.stat().st_size > 10_000


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.read()


def _first_event(port) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/stream", timeout=10) as r:
        assert r.headers["Content-Type"] == "text/event-stream"
        while True:
            line = r.readline()
            if line.startswith(b"data: "):
                return json.loads(line[6:])


def test_feed_serves_scene_viewer_and_stream(tracks):
    from racing_lmpc_torch.track.live_feed import LiveFeed
    from racing_lmpc_torch.track.visualizer import TrajectoryVisualizer
    feed = LiveFeed(TrajectoryVisualizer(tracks[1]))
    port = feed.start()
    try:
        scene = json.loads(_get(port, "/scene"))
        assert len(scene["track"]["center"]) >= 1000
        assert len(scene["track"]["left"]) >= 1000
        feed.update(prediction=np.zeros((5, 2)),
                    telemetry={"solved": True, "solve_time": 0.001})
        scene2 = json.loads(_get(port, "/scene"))
        assert scene2["seq"] > scene["seq"]
        assert scene2["prediction"] == [[0.0, 0.0]] * 5
        assert scene2["telemetry"]["solved"] is True
        assert "EventSource('/stream')" in _get(port, "/").decode()
        event = _first_event(port)
        assert event["seq"] == scene2["seq"] and event["prediction"] == scene2["prediction"]
    finally:
        feed.stop()


def _schema(v):
    """The structure of a snapshot: dict keys, and (rows, row length) of
    point lists."""
    if isinstance(v, dict):
        return {k: _schema(x) for k, x in v.items()}
    if isinstance(v, list) and v and isinstance(v[0], list):
        return ("points", len(v[0]))
    return type(v).__name__


def test_feed_attached_to_cosim_has_jax_schema(tracks):
    from racing_lmpc_tpu.track.live_feed import LiveFeed as JFeed
    from racing_lmpc_tpu.track.visualizer import TrajectoryVisualizer as JViz
    from racing_lmpc_torch.launch.runner import _SCENARIOS, CoSimulation
    from racing_lmpc_torch.track.live_feed import attach_live_feed
    cs = CoSimulation(_SCENARIOS["barc_lmpc"], n_override=10,
                      mpc_overrides={"num_ss_pts": 16}, device="cpu")
    feed, port = attach_live_feed(cs)
    try:
        for _ in range(3):
            x = cs.simulator.x.numpy().copy()   # the pose the cycle sees
            cs.step()
        scene = json.loads(_get(port, "/scene"))
    finally:
        feed.stop()
    assert scene["seq"] == 3
    assert len(scene["prediction"]) == 10 and len(scene["vehicle"]) == 4
    assert len(scene["safe_set"]) == 16
    assert scene["telemetry"]["solve_time"] >= 0.0
    # the vehicle polygon sits on the plant's pose of the last cycle
    assert np.abs(np.mean(scene["vehicle"], axis=0) - x[:2]).max() < 1e-5
    # the JAX feed fed the reference's own kinds of values
    jfeed = JFeed(JViz(tracks[0]))
    jfeed.update(prediction=np.zeros((10, 3)), safe_set=np.zeros((16, 3)),
                 vehicle=np.zeros((4, 2)), telemetry=jmsgs.MPCTelemetry(
                     state=[0.0] * 6, control=[0.0] * 2).to_dict())
    want = jfeed.snapshot()
    assert _schema(scene) == {**_schema(want), "seq": "int"}
    assert set(scene["telemetry"]) == set(want["telemetry"])


def test_profiler_trace_writes_a_file(tmp_path):
    from racing_lmpc_torch.control.telemetry import ProfilerTrace
    with ProfilerTrace(tmp_path / "trace") as tr:
        torch.ones(64).cumsum(0).sum()
    assert tr.path.parent == tmp_path / "trace" and tr.path.stat().st_size > 0
    events = json.loads(tr.path.read_text())["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)
    assert len(tr.profiler.key_averages()) > 0


def _seeded_qps(rng, B: int, n: int, m: int, me: int):
    """QPs with ``me`` equality rows, two rows open below, one open above
    and the rest two-sided, all feasible at a seeded point."""
    M = rng.normal(size=(B, n, n)).astype(np.float32)
    P = (np.einsum("bij,bik->bjk", M, M) / n + 0.1 * np.eye(n)).astype(np.float32)
    q = rng.normal(size=(B, n)).astype(np.float32)
    A = rng.normal(size=(B, m, n)).astype(np.float32)
    f = np.einsum("bmn,bn->bm", A, rng.normal(size=(B, n)) * 0.3)
    l = f - rng.uniform(0.1, 1.0, (B, m))
    u = f + rng.uniform(0.1, 1.0, (B, m))
    l[:, :me] = u[:, :me] = f[:, :me]
    l[:, me:me + 2] = -np.inf
    u[:, me + 2] = np.inf
    return P, q, A, l.astype(np.float32), u.astype(np.float32)


@pytest.mark.parametrize("seed,n,m,me", [(5, 10, 14, 3), (6, 6, 9, 0)])
def test_ipm_lu_branch_matches_jax(seed, n, m, me):
    import jax
    import jax.numpy as jnp
    import chip_smoke
    from racing_lmpc_tpu.mpc.ipm import solve_qp_ip as jsolve
    from racing_lmpc_tpu.mpc.qp import QPData as JQP
    from racing_lmpc_tpu.mpc.reference_qp import ReferenceQP, solve_dense_qp_f64
    from racing_lmpc_torch.mpc.ipm import solve_qp_ip
    from racing_lmpc_torch.mpc.qp import QPData
    d = _seeded_qps(np.random.default_rng(seed), 6, n, m, me)
    inputs = [d] + [chip_smoke.lu_moved(list(d), s) for s in range(chip_smoke.LU_MOVED)]
    jfn = jax.jit(jax.vmap(lambda *a: jsolve(JQP(*a), iters=25)))
    ref, port = [], []
    for data in inputs:
        with jax.default_matmul_precision("highest"):
            js = jfn(*map(jnp.asarray, data))
        ts = solve_qp_ip(QPData(*map(torch.as_tensor, data)), iters=25)
        for sol in (js, ts):
            assert (np_of(sol.rp_rel) < 1e-3).all() and (np_of(sol.rd_rel) < 1e-3).all()
        ref.append({"x": np_of(js.x), "obj": np_of(js.obj)})
        port.append({"x": np_of(ts.x), "obj": np_of(ts.obj)})
    limits = chip_smoke.lu_limits(ref)
    got = [chip_smoke.lu_reading(a, b) for a, b in zip(port, ref)]
    for k, lim in limits.items():
        assert np.median([r[k] for r in got]) <= lim, (k, got, lim)
    for b in range(len(d[0])):
        P, q, A, l, u = (np.asarray(a[b], np.float64) for a in d)
        x_star, _ = solve_dense_qp_f64(ReferenceQP(
            P=0.5 * (P + P.T), q=q, A=A, l=l, u=u, layout=None, scale_x=None,
            scale_u=None))
        err_j = np.abs(ref[0]["x"][b] - x_star).max()
        assert np.abs(port[0]["x"][b] - x_star).max() <= err_j + 1e-4, b
    # the equality rows hold
    if me:
        Ax = np.einsum("bmn,bn->bm", d[2], port[0]["x"])
        assert np.abs(Ax[:, :me] - d[3][:, :me]).max() < 1e-4
