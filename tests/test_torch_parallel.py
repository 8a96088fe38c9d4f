"""The port's scale-out (racing_lmpc_torch/parallel, ``benchmarks.scaling_bench``,
``entry.dryrun_multichip``) in process groups of gloo ranks on the CPU, one
process a rank (``parallel.spawn``), against the JAX package's sharded
solve on the conftest's virtual 8-device mesh.

The problem is tests/test_parallel.py's (``build_barc_lmpc(8, 16, 8)``, a
batch of 16 from seed 3).  Two ranks: each keeps rows [8r, 8r + 8) of the
global batch; the solve gathered from both equals the port's unsharded
solve (the same ``solved`` flags, every output within 1e-5 relative) and
the JAX ``sharded_batch_solver`` with tests/test_torch_solve.py's
tolerances (``solved`` lane by lane, the longitudinal controls within 1e-3
of ``scale_u``, the objectives within 1e-3 relative, the steering within
2e-1 of ``scale_u`` of the certified float64 optimum); both ranks agree on
the gathered solve and the metrics, as tests/multihost_worker.py checks;
and ``scaling_bench`` runs.  Four ranks as a (2, 2) mesh: the same solve,
and ``sharded_metrics`` reducing to the known values (the masked minimum,
+inf when nothing solved) with its reduction built once per mesh.  Then
``dryrun_multichip(2, device="cpu")``.
"""

import numpy as np
import pytest
import torch

import tests._torch_twin  # noqa: F401  (one torch thread per test worker)

N, K, PER_LAP, BATCH, SEED = 8, 16, 8, 16, 3
FIELDS = ("X_optm", "U_optm", "dU_optm", "convex_combi", "obj", "solved")


def _problem():
    """The problem and its global batch, on the CPU (every gloo rank and the
    unsharded solve build the same)."""
    from racing_lmpc_torch.benchmarks import build_barc_lmpc, make_scenario_batch
    _, track, _, mpc, manager = build_barc_lmpc(N, K, PER_LAP, device="cpu")
    inp = make_scenario_batch(mpc, track, manager, BATCH, seed=SEED, device="cpu")
    z = torch.zeros((BATCH, mpc.layout.n), dtype=torch.float32)
    valid = torch.zeros((BATCH,), dtype=torch.bool)
    return mpc, inp, z, valid


def _gathered(out) -> dict:
    from racing_lmpc_torch.parallel.distributed import process_allgather
    return {f: v for f, v in zip(out._fields, process_allgather(tuple(out)))
            if f in FIELDS}


def _two_rank_job() -> dict:
    """One rank of the two-rank group: the sharded solve on the global mesh
    (``initialize`` ran in ``parallel.spawn``), its layout and metrics, and
    ``scaling_bench``."""
    import torch.distributed as dist
    from racing_lmpc_torch.benchmarks import scaling_bench
    from racing_lmpc_torch.parallel import sharded_batch_solver, sharded_metrics
    from racing_lmpc_torch.parallel.distributed import global_mesh, shard_batch_global
    from racing_lmpc_torch.parallel.mesh import shard_index
    mpc, inp, z, valid = _problem()
    mesh = global_mesh()
    inp_s, z_s, valid_s = (shard_batch_global(x, mesh) for x in (inp, z, valid))
    out, _ = sharded_batch_solver(mpc, mesh)(inp_s, z_s, valid_s)
    frac, min_cost = sharded_metrics(out.solved, out.obj, mesh)
    return {"rank": dist.get_rank(), "shard": shard_index(mesh),
            "x_ic_shard": inp_s.x_ic.numpy(), "x_ic": inp.x_ic.numpy(),
            "total_length": inp_s.total_length.numpy(),
            "out": _gathered(out), "frac": float(frac), "min_cost": float(min_cost),
            "scaling": scaling_bench(device_counts=[1, 2], batch_per_device=4,
                                     n_horizon=6, num_ss=8, reps=1)}


def _four_rank_job() -> dict:
    """One rank of the four-rank group: the (2, 2) mesh's solve and its
    metrics on the known cases."""
    from racing_lmpc_torch.parallel import (
        make_mesh_2d, shard_batch, sharded_batch_solver, sharded_metrics)
    from racing_lmpc_torch.parallel.mesh import _metrics_fn, shard_index
    mpc, inp, z, valid = _problem()
    mesh = make_mesh_2d(host_size=2)
    axes = ("host", "batch")
    out, _ = sharded_batch_solver(mpc, mesh, axis=axes)(
        *(shard_batch(x, mesh, axis=axes) for x in (inp, z, valid)))
    full = _gathered(out)
    res = {"mesh": mesh.mesh.tolist(), "shard": shard_index(mesh, axes), "out": full,
           "all": [float(v) for v in sharded_metrics(out.solved, out.obj, mesh)]}
    # mark the global-min scenario unsolved: the minimum must skip it
    solved = full["solved"].copy()
    solved[np.argmin(full["obj"])] = False
    res["masked"] = [float(v) for v in sharded_metrics(
        shard_batch(solved, mesh, axis=axes), out.obj, mesh)]
    res["none"] = [float(v) for v in sharded_metrics(
        torch.zeros_like(out.solved), out.obj, mesh)]
    res["cached"] = _metrics_fn(mesh) is _metrics_fn(mesh)
    return res


@pytest.fixture(scope="module")
def two_ranks():
    from racing_lmpc_torch.parallel.spawn import spawn
    return spawn(2, "tests.test_torch_parallel:_two_rank_job", device="cpu", timeout=600)


@pytest.fixture(scope="module")
def four_ranks():
    from racing_lmpc_torch.parallel.spawn import spawn
    return spawn(4, "tests.test_torch_parallel:_four_rank_job", device="cpu", timeout=600)


@pytest.fixture(scope="module")
def unsharded():
    mpc, inp, z, valid = _problem()
    out, _ = mpc.solve_batch(inp, z, valid)
    return mpc, {f: getattr(out, f).numpy() for f in FIELDS}


def _equal_solves(got: dict, want: dict):
    assert np.array_equal(got["solved"], want["solved"])
    for f in FIELDS[:-1]:
        a, b = np.asarray(got[f], np.float64), np.asarray(want[f], np.float64)
        assert np.abs(a - b).max() <= 1e-5 * max(1.0, np.abs(b).max()), f


def test_shard_layout(two_ranks):
    for r, res in enumerate(two_ranks):
        assert res["rank"] == r and res["shard"] == (r, 2)
        assert np.array_equal(res["x_ic_shard"], res["x_ic"][8 * r:8 * r + 8])
        assert res["total_length"].shape == (8,)
    assert np.array_equal(two_ranks[0]["x_ic"], two_ranks[1]["x_ic"])


def test_sharded_solve_matches_unsharded(two_ranks, unsharded):
    _, want = unsharded
    assert want["solved"].all()
    for res in two_ranks:
        _equal_solves(res["out"], want)


def test_two_process_run_agrees(two_ranks):
    a, b = two_ranks
    for f in FIELDS:
        assert np.array_equal(a["out"][f], b["out"][f]), f
    assert a["frac"] == b["frac"] == float(np.mean(a["out"]["solved"]))
    assert a["min_cost"] == b["min_cost"] == float(a["out"]["obj"][a["out"]["solved"]].min())
    assert a["out"]["U_optm"].shape == (BATCH, N - 1, 2)
    assert np.isfinite(a["out"]["U_optm"]).all()


def test_sharded_solve_matches_jax(two_ranks, unsharded):
    import jax
    import jax.numpy as jnp
    from racing_lmpc_tpu.benchmarks import build_barc_lmpc, make_scenario_batch
    from racing_lmpc_tpu.parallel import make_mesh, shard_batch, sharded_batch_solver
    from tests._torch_twin import certified_controls
    assert len(jax.devices()) >= 8, "conftest should provide 8 CPU devices"
    _, track, _, jmpc, manager = build_barc_lmpc(n_horizon=N, num_ss=K, num_ss_per_lap=PER_LAP)
    inp = make_scenario_batch(jmpc, track, manager, BATCH, seed=SEED)
    z = jnp.zeros((BATCH, jmpc.layout.n), dtype=jnp.float32)
    valid = jnp.zeros((BATCH,), dtype=bool)
    mesh = make_mesh(jax.devices()[:8])
    jout, _ = sharded_batch_solver(jmpc._solve_impl, mesh)(
        *(shard_batch(x, mesh) for x in (inp, z, valid)))
    assert np.array_equal(two_ranks[0]["x_ic"], np.asarray(inp.x_ic))
    got = two_ranks[0]["out"]
    assert np.array_equal(got["solved"], np.asarray(jout.solved))
    mpc, _ = unsharded
    su = mpc.scale_u
    Ut, Uj = got["U_optm"].astype(np.float64), np.asarray(jout.U_optm, np.float64)
    assert (np.abs(Ut - Uj)[..., 0] / su[0]).max() < 1e-3
    ot, oj = got["obj"].astype(np.float64), np.asarray(jout.obj, np.float64)
    assert (np.abs(ot - oj) / np.maximum(np.abs(oj), 1.0)).max() < 1e-3
    with jax.default_matmul_precision("highest"):
        jdata, jaux = jax.jit(jax.vmap(jmpc._build_qp))(inp)
    U_star, _ = certified_controls(jdata, jaux[2], jaux[3], su, N, mpc.nu)
    err = np.abs(Ut - U_star) / su
    assert err[..., 0].max() < 1e-3 and err[..., 1].max() < 2e-1


def test_scaling_bench_runs(two_ranks):
    res = two_ranks[0]["scaling"]
    assert res == two_ranks[1]["scaling"]
    assert [r["devices"] for r in res] == [1, 2]
    assert [r["batch"] for r in res] == [4, 8]
    assert all(r["solved_fraction"] == 1.0 for r in res)
    assert res[0]["weak_scaling_efficiency"] == 1.0
    assert set(res[0]) == {"devices", "batch", "batch_latency_ms", "solves_per_s",
                           "weak_scaling_efficiency", "solved_fraction"}


def test_mesh2d_solve_and_metrics(four_ranks, unsharded):
    _, want = unsharded
    for r, res in enumerate(four_ranks):
        assert res["mesh"] == [[0, 1], [2, 3]]      # host-contiguous rows
        assert res["shard"] == (r, 4)
        _equal_solves(res["out"], want)
        assert res["cached"]
    obj, solved = want["obj"].astype(np.float64), want["solved"]
    for res in four_ranks:
        frac, cmin = res["all"]
        assert frac == pytest.approx(solved.mean())
        np.testing.assert_allclose(cmin, obj.min(), rtol=1e-6)
        masked = solved.copy()
        masked[np.argmin(res["out"]["obj"])] = False
        frac2, cmin2 = res["masked"]
        assert frac2 == pytest.approx(masked.mean())
        np.testing.assert_allclose(cmin2, obj[masked].min(), rtol=1e-6)
        assert res["none"] == [0.0, np.inf]


def test_dryrun_multichip_cpu():
    from racing_lmpc_torch.entry import dryrun_multichip
    dryrun_multichip(2, device="cpu")
