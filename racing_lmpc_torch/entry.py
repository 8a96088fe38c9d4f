"""Entry points of the port: one flagship solve and the multi-device dry run.

``entry`` is the twin of ``__graft_entry__.entry``
(``__graft_entry__.py:8-22``): one LMPC solve of the flagship problem
(BARC, N=20, K=48) through ``RacingMPC._solve_impl``.  ``dryrun_multichip``
is the twin of ``__graft_entry__.dryrun_multichip``
(``__graft_entry__.py:25-105``).  The reference shards over n devices of
one program; here n processes form a ``torch.distributed`` group (NCCL with
one GPU each, or gloo when ``device="cpu"``), each rank solving its shard.
"""

from __future__ import annotations

import numpy as np
import torch


def entry(device=None):
    """(fn, example_args): one flagship LMPC solve (BARC, N=20, K=48) on
    ``device`` (CUDA unless the caller names another).  ``fn(inp, z,
    valid)`` takes one unbatched scenario, its warm-start vector (n,) and
    its validity flag, and returns the solved controls ``U_optm`` (N-1, nu);
    the example arguments are the first scenario of
    ``make_scenario_batch(..., batch=1)``, a zero warm start and True."""
    from racing_lmpc_torch import resolve_device
    from racing_lmpc_torch.benchmarks import build_barc_lmpc, make_scenario_batch
    from racing_lmpc_torch.mpc.racing_mpc import map_input

    device = resolve_device(device)
    _, track, _, mpc, manager = build_barc_lmpc(n_horizon=20, num_ss=48, device=device)
    inp = make_scenario_batch(mpc, track, manager, batch=1, device=device)
    single = map_input(lambda a: a[0], inp)
    z = torch.zeros((mpc.layout.n,), dtype=torch.float32, device=device)
    valid = torch.ones((), dtype=torch.bool, device=device)

    def fn(inp, z, valid):
        # _solve_impl takes a batch: this scenario is a batch of one
        out, _ = mpc._solve_impl(map_input(lambda a: a[None], inp), z[None], valid[None])
        return out.U_optm[0]

    return fn, (single, z, valid)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Shard a tiny scenario batch of full LMPC solves over an
    ``n_devices`` 1-D mesh and run one step; then, on an even count, repeat
    over a 2-D ``(host, batch)`` mesh (the production multi-host topology)
    with the explicit cross-shard collective metrics (SUM solved fraction,
    MIN objective); then run the flagship shapes (N=20, K=48) on the 1-D
    mesh.  Spawns ``n_devices`` ranks; raises if any check fails on any
    rank."""
    from racing_lmpc_torch.parallel.spawn import spawn
    kind = "cpu" if device is not None and torch.device(device).type == "cpu" else "cuda"
    if kind == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"need {n_devices} CUDA devices, have "
                           f"{torch.cuda.device_count()}")
    spawn(n_devices, "racing_lmpc_torch.entry:_dryrun_rank", n_devices, device=kind)


def _solve_sharded(mpc, track, manager, batch: int, mesh, axis="batch"):
    from racing_lmpc_torch.benchmarks import make_scenario_batch
    from racing_lmpc_torch.parallel import shard_batch, sharded_batch_solver
    from racing_lmpc_torch.parallel.mesh import mesh_device
    inp = make_scenario_batch(mpc, track, manager, batch=batch, device=mesh_device(mesh))
    z = torch.zeros((batch, mpc.layout.n), dtype=torch.float32)
    valid = torch.zeros((batch,), dtype=torch.bool)
    solver = sharded_batch_solver(mpc, mesh, axis=axis)
    return solver(*(shard_batch(x, mesh, axis=axis) for x in (inp, z, valid)))


def _dryrun_rank(n_devices: int) -> None:
    """One rank of ``dryrun_multichip``: the reference's three phases and
    its checks, on this rank's shard."""
    import torch.distributed as dist
    from racing_lmpc_torch.benchmarks import build_barc_lmpc
    from racing_lmpc_torch.parallel import make_mesh, make_mesh_2d, sharded_metrics
    from racing_lmpc_torch.parallel.mesh import mesh_device

    assert dist.get_world_size() == n_devices, (
        f"need {n_devices} ranks, have {dist.get_world_size()}")
    mesh = make_mesh()
    device = mesh_device(mesh)

    # tiny shapes: N=5 horizon, K=8 safe-set points, batch = n_devices
    _, track, _, mpc, manager = build_barc_lmpc(
        n_horizon=5, num_ss=8, num_ss_per_lap=4, device=device)
    batch = max(n_devices, 2)
    out, _ = _solve_sharded(mpc, track, manager, batch, mesh)
    shard = batch // n_devices
    assert out.U_optm.shape == (shard, mpc.N - 1, mpc.nu)
    assert bool(torch.isfinite(out.U_optm).all())

    # ---- 2-D (host, batch) mesh --------------------------------------
    if n_devices >= 2 and n_devices % 2 == 0:
        mesh2 = make_mesh_2d(host_size=2)
        axes = ("host", "batch")
        batch2 = 2 * n_devices  # 2 scenarios per shard
        out2, _ = _solve_sharded(mpc, track, manager, batch2, mesh2, axis=axes)
        assert out2.U_optm.shape == (2, mpc.N - 1, mpc.nu)
        assert bool(torch.isfinite(out2.U_optm).all())
        # explicit cross-shard collectives in the metrics path
        frac, min_cost = sharded_metrics(out2.solved, out2.obj, mesh2)
        assert 0.0 <= float(frac) <= 1.0
        # min_cost reduces over SOLVED scenarios only (+inf when none)
        assert np.isfinite(float(min_cost)) or float(frac) == 0.0

    # ---- flagship shapes (N=20, K=48): the production program ---------
    _, track_f, _, mpc_f, manager_f = build_barc_lmpc(
        n_horizon=20, num_ss=48, device=device)
    batch_f = max(n_devices, 2)
    out_f, _ = _solve_sharded(mpc_f, track_f, manager_f, batch_f, mesh)
    assert out_f.U_optm.shape == (batch_f // n_devices, mpc_f.N - 1, mpc_f.nu)
    assert bool(torch.isfinite(out_f.U_optm).all())
