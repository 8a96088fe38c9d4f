"""The port's bench (racing_lmpc_torch/bench.py) on the CPU.

- ``chain_solves`` against bench.py's dependent chain (``bench.py:154-162``)
  as the JAX package ran it (``tests/data/torch_port/bench_chain_n20_k48.npz``,
  written by ``tests/torch_port_fixture.py``): the objective of every step
  within 1e-3 relative and the controls within 1e-3 of ``scale_u``
  (longitudinal) and 3e-3 (steering), each limit widened to the
  reference's own spread over its re-runs on inputs moved by one f32
  rounding where that is wider.
- ``rt_chain``: its wiring against hand-made ``_rti_step`` calls (bit for
  bit), and the Putnam tracking controller (N=80) against bench.py's
  controller chain as the JAX package ran it from the same start
  (``bench_rt_putnam_short_tracking_mpc.npz``), with the same limits.
- ``flops_per_solve``: its matrix-product count equal, as an integer, to
  ``torch.utils.flop_counter.FlopCounterMode``'s count of the CPU solve
  with the kernel's plain version left out, and its kernel count 2/3 n^3 a
  ``chol_tri_inv`` matrix.
- The JSON line's keys are ``bench.py``'s (``BENCH_r05.json``), and the
  bench refuses to run without CUDA.
- ``chip_smoke.py``'s replays of the controller chains from the
  reference's stored runs, and the check that holds them.

No JAX here: the reference's runs are stored.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import chip_smoke
import racing_lmpc_torch.mpc.ipm as ipm
from racing_lmpc_torch import bench
from racing_lmpc_torch.benchmarks import build_barc_lmpc, make_scenario_batch
from racing_lmpc_torch.config import barc_mpc_config
from racing_lmpc_torch.control.loop import ControllerState
from racing_lmpc_torch.launch.runner import _SCENARIOS, CoSimulation
from racing_lmpc_torch.mpc.racing_mpc import REQUIRED_FIELDS, MPCInput, RacingMPC
from racing_lmpc_torch.ops import linalg
from tests import torch_port_fixture
from tests._torch_twin import np_of

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "data" / "torch_port"
# the port's floors: objective relative, applied controls over scale_u
OBJ_FLOOR, LON_FLOOR, STEER_FLOOR = 1e-3, 1e-3, 3e-3


def load(case: str) -> dict:
    with np.load(FIXTURES / f"{case}.npz") as z:
        return {k: z[k] for k in z.files}


def readings(U, obj, U_ref, obj_ref, su) -> dict:
    """Largest objective gap (relative) and control gaps (over scale_u)."""
    dU = np.abs(np.asarray(U, np.float64) - U_ref) / su
    return {"obj": float((np.abs(np.asarray(obj, np.float64) - obj_ref)
                          / np.maximum(np.abs(obj_ref), 1e-12)).max()),
            "lon": float(dU[..., 0].max()), "steer": float(dU[..., 1].max())}


def limits(U_pert, obj_pert, U_ref, obj_ref, su) -> dict:
    """Each floor, or the reference's widest reading over its moved re-runs."""
    spread = [readings(U, o, U_ref, obj_ref, su) for U, o in zip(U_pert, obj_pert)]
    floors = {"obj": OBJ_FLOOR, "lon": LON_FLOOR, "steer": STEER_FLOOR}
    return {k: max(f, *(s[k] for s in spread)) for k, f in floors.items()}


@pytest.mark.parametrize("b", [1, 2])
def test_chain_solves_matches_stored_jax_chain(b):
    fx = load("bench_chain_n20_k48")
    _, _, _, mpc, _ = build_barc_lmpc(n_horizon=20, num_ss=48, device="cpu")
    inp = MPCInput(**{k: torch.as_tensor(fx[f"inp_{k}"][:b]) for k in REQUIRED_FIELDS})
    steps = []
    solve = mpc._solve_impl

    def recording(inp_c, z_c, valid_c):
        out, z_n = solve(inp_c, z_c, valid_c)
        steps.append((inp_c.x_ic, z_c, out, z_n))
        return out, z_n
    mpc._solve_impl = recording
    z = torch.zeros((b, mpc.layout.n))
    objs = bench.chain_solves(mpc, inp, z, torch.zeros((b,), dtype=torch.bool), 3)

    assert objs.shape == (3, b)
    # each step from the previous one's one-step prediction and warm start
    assert torch.equal(steps[0][0], inp.x_ic) and torch.equal(steps[0][1], z)
    for (_, _, out, z_n), (x_next, z_next, _, _) in zip(steps, steps[1:]):
        assert torch.equal(x_next, out.X_optm[:, 1]) and torch.equal(z_next, z_n)
    assert torch.equal(objs, torch.stack([s[2].obj for s in steps]))

    U = np.stack([np_of(s[2].U_optm) for s in steps])
    su = fx["scale_u"]
    got = readings(U, np_of(objs), fx[f"U_b{b}"], fx[f"obj_b{b}"], su)
    lim = limits(fx[f"U_b{b}_pert"], fx[f"obj_b{b}_pert"], fx[f"U_b{b}"], fx[f"obj_b{b}"], su)
    assert all(got[k] <= lim[k] for k in lim), (got, lim)


def test_rt_chain_is_chained_rti_steps():
    cs = CoSimulation(_SCENARIOS["barc_tracking_mpc"], n_override=10, device="cpu")
    cs.step()
    ctrl = cs.controller
    st = ctrl.state
    ss_x, ss_j = ctrl._query_safe_set(st.last_X[-1])
    x0, u0 = st.last_X[0], torch.zeros((ctrl.mpc.nu,))
    final, infos = bench.rt_chain(ctrl, st, x0, u0, ss_x, ss_j, 2)

    lim, sc = torch.tensor(ctrl.speed_limit), torch.tensor(ctrl.speed_scale)
    s1, i1 = ctrl._rti_step(x0, u0, st, ss_x, ss_j, lim, sc)
    s2, i2 = ctrl._rti_step(s1.last_X[1], i1.u_apply, s1, ss_x, ss_j, lim, sc)
    for got, want in ((final, s2), (infos[0], i1), (infos[1], i2)):
        leaves = torch.utils._pytree.tree_leaves
        assert len(leaves(got)) == len(leaves(want))
        for a, w in zip(leaves(got), leaves(want)):
            assert torch.equal(a, w)


def test_rt_chain_matches_stored_jax_chain():
    fx = load("bench_rt_putnam_short_tracking_mpc")
    cs = CoSimulation(_SCENARIOS["putnam_short_tracking_mpc"], device="cpu")
    ctrl = cs.controller
    st = ControllerState(*(torch.as_tensor(fx[f"state_{k}"]) for k in ControllerState._fields))
    ctrl.speed_limit, ctrl.speed_scale = float(fx["speed_limit"]), float(fx["speed_scale"])
    _, infos = bench.rt_chain(ctrl, st, torch.as_tensor(fx["x0"]), torch.as_tensor(fx["u0"]),
                              torch.as_tensor(fx["ss_x"]), torch.as_tensor(fx["ss_j"]), 2)

    assert [bool(i.used_fallback) for i in infos] == fx["used_fallback"].tolist()
    U = np.stack([np_of(i.output.U_optm) for i in infos])
    obj = np.asarray([float(i.output.obj) for i in infos])
    assert np.isfinite(U).all() and np.isfinite(obj).all()
    su = fx["scale_u"]
    got = readings(U, obj, fx["U_optm"], fx["obj"], su)
    lim = limits(fx["U_optm_pert"], fx["obj_pert"], fx["U_optm"], fx["obj"], su)
    assert all(got[k] <= lim[k] for k in lim), (got, lim)


@pytest.mark.parametrize("name", ["barc_lmpc", "barc_tracking_mpc"])
def test_flops_per_solve_matches_flop_counter(name, monkeypatch):
    """N=6 at batch 2: the LMPC (K=8, hull slack, one equality row) and the
    tracking configuration (no safe set, no equality rows)."""
    learning = name == "barc_lmpc"
    model, track, _, _, manager = build_barc_lmpc(n_horizon=6, num_ss=8, device="cpu",
                                                  learning=learning)
    mpc = RacingMPC(barc_mpc_config(name, n=6, learning=learning, num_ss_pts=8), model,
                    device="cpu")
    B = 2
    inp = make_scenario_batch(mpc, track, manager, B, device="cpu")
    z, valid = torch.zeros((B, mpc.layout.n)), torch.zeros((B,), dtype=torch.bool)
    flops, out = bench.flops_per_solve(mpc, inp, z, valid)
    assert bool(torch.isfinite(out.obj).all())
    assert ipm.chol_tri_inv is linalg.chol_tri_inv

    calls = []

    def counted(H):
        calls.append(tuple(H.shape))
        return linalg.chol_tri_inv(H)
    monkeypatch.setattr(ipm, "chol_tri_inv", counted)
    with FlopCounterMode(display=False) as fc:
        ref, _ = mpc.solve_batch(inp, z, valid)
    assert torch.equal(ref.obj, out.obj)
    plain = {}
    for shape in set(calls):
        with FlopCounterMode(display=False) as fp:
            linalg.chol_tri_inv_plain(torch.eye(shape[-1]).expand(shape).contiguous())
        plain[shape] = fp.get_total_flops()
    counted_mm = fc.get_total_flops() - sum(plain[s] for s in calls)

    assert isinstance(flops["matmul"], int)
    assert flops["matmul"] * B == counted_mm
    assert flops["kernel"] * B == pytest.approx(
        sum(s[0] * 2.0 / 3.0 * s[-1] ** 3 for s in calls), rel=1e-12)
    assert flops["total"] == flops["matmul"] + flops["kernel"]
    # the f64 part: A'DA, once a Newton system (both configurations keep
    # dense rows)
    assert 0 < flops["f64"] < flops["matmul"]


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


def test_bench_line_has_bench_py_keys():
    with open(ROOT / "BENCH_r05.json") as f:
        parsed = json.load(f)["parsed"]
    want = _keys(parsed)
    rt = parsed["extra"]["shipped_rt_latencies"]
    line = bench.bench_line(
        solves_per_s=1.0, batch=256, lat_ms=np.ones(3), onchip={1: 1.0, 8: 8.0},
        ss_query_ms=0.1, solved_fraction=1.0,
        flops={"total": 2.0, "f64": 1, "matmul": 1, "kernel": 1.0, "launches": 1},
        sweep={"512": 1.0, "1024": 1.0}, shipped_rt=rt, n40_lat_ms=np.ones(3),
        n40_batch=128, n40_solved_fraction=1.0, qp_zoom_rounds=4, device="card",
        power_limit_w=700.0)
    got = _keys(json.loads(json.dumps(line)))
    assert got == ((want - {"extra.mfu_vs_bf16_peak"})
                   | {"extra.mfu_vs_f32_peak", "extra.flops_per_solve_f64",
                      "extra.power_limit_w"})
    assert 0.0 < line["extra"]["mfu_vs_f32_peak"] <= 1.0


def test_bench_refuses_to_run_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        bench.main()
    with pytest.raises(RuntimeError):
        bench.run("cpu")


def test_chip_smoke_holds_the_bench_chains_from_the_reference_start():
    """chip_smoke.py's replays of the bench's controller chains
    (``bench_rt_replay``: each of the reference's teacher-forced runs, every
    cycle from that run's start of it; held by ``bench_rt_replays``): the
    moved starts reproduced, one scenario's replays on the CPU held, and the
    check failing a fallback where the reference solved and an objective
    moved past its limit."""
    assert chip_smoke.BENCH_RT_SCENARIOS == tuple(bench.LOOP_PERIOD_MS)
    assert {f"bench_rt_{s}" for s in chip_smoke.BENCH_RT_SCENARIOS} == set(
        torch_port_fixture.BENCH_RT_CASES)
    pending = chip_smoke.bench_rt_replays()
    assert [p[0] for p in pending] == [f"bench_rt_{s}" for s in chip_smoke.BENCH_RT_SCENARIOS]
    i = chip_smoke.BENCH_RT_SCENARIOS.index("barc_tracking_mpc")
    case, count, held = pending[i]
    fx = load(case)
    refs = chip_smoke.bench_rt_runs(fx)
    assert count == len(refs) == 5
    # the reference's teacher-forced chain is its chain, and its moved
    # starts are the ones the replay makes
    assert np.array_equal(fx["tf_obj"], fx["obj"])
    rng = np.random.default_rng(3)
    last_X = fx["tf_state_last_X"][0] * (1 + 2e-7 * rng.standard_normal(
        fx["tf_state_last_X"][0].shape))
    start = chip_smoke.bench_rt_start(fx, 0, 3)
    assert np.array_equal(start["last_X"], last_X.astype(np.float32))
    assert not np.array_equal(chip_smoke.bench_rt_start(fx, 1, 3)["x0"], fx["tf_x0"][1])

    # the port's replays of runs 0 and 1, with the reference's others
    runs = [chip_smoke.bench_rt_replay("barc_tracking_mpc", r, torch.device("cpu"))
            for r in range(2)] + refs[2:]
    assert runs[1]["U"].shape == fx["tf_U_optm"].shape
    held(runs)
    held(refs)
    bad = [{**r, "used_fallback": np.ones_like(r["used_fallback"])} for r in runs]
    with pytest.raises(AssertionError, match="fallback where the reference solved"):
        held(bad)
    bad = [{**r, "obj": q["obj"] * (1 + 2e-2)} for r, q in zip(runs, refs)]
    with pytest.raises(AssertionError, match="a gap over its limit"):
        held(bad)
