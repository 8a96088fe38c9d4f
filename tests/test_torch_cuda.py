"""Port tests that need an NVIDIA GPU: the hand-written kernels against
their plain versions, the batched solve on the card against the same
solve on the CPU, a few cycles of the bus co-simulation, the world-size-1
NCCL sharded solve, the IPM's LU branch on the card, and the program's
spans and host-sync counter (``racing_lmpc_torch.spans``) against the
profiler's device records and PyTorch's sync debug mode.  They skip where ``torch.cuda.is_available()`` is false.  This file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

It imports nothing from the other test modules either (a ``tests`` package
installed elsewhere can shadow this directory there).
"""

import warnings

import numpy as np
import pytest
import torch

from racing_lmpc_torch.ops import linalg as tl

pytestmark = pytest.mark.cuda


def np_of(t):
    return t.detach().cpu().numpy()


def rel_err(got, want):
    """max |got - want| relative to max(1, max |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def spd(rng, B, n):
    A = rng.normal(size=(B, n, n)).astype(np.float32)
    return np.einsum("bij,bik->bjk", A, A) + n * np.eye(n, dtype=np.float32)


def spd_on(rng, B, n, device):
    """A'A + n I as ``spd`` makes it, the product taken on ``device`` (the
    host's einsum takes seconds a matrix past n = 1,000)."""
    A = torch.as_tensor(rng.normal(size=(B, n, n)).astype(np.float32), device=device)
    return A.mT @ A + n * torch.eye(n, device=device)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n", [1, 28, 40, 58, 73, 87, 175, 216, 244, 275, 1025])
def test_chol_tri_inv_kernel_matches_plain(cuda, n):
    # n = 1025: the wide variant, its triangle in device memory
    rng = np.random.default_rng(n)
    H = (torch.as_tensor(spd(rng, 32, n), device=cuda) if n <= 1024
         else spd_on(rng, 2, n, cuda))
    before = tl.chol_tri_inv.launches
    K = tl.chol_tri_inv(H)
    P = tl.chol_tri_inv_plain(H)
    torch.cuda.synchronize()
    assert tl.chol_tri_inv.launches == before + 1
    assert rel_err(np_of(K), np_of(P)) < 1e-4


@pytest.mark.parametrize("G", [1, 4, 32, 33])
@pytest.mark.parametrize("n", [1, 2, 28, 31, 32, 33, 40, 58, 73, 87, 96, 97, 175, 216,
                               225, 240, 241, 244, 256, 274, 275, 302, 303, 320, 336, 337,
                               400, 512, 1024, 1025, 1736, 1737, 2048])
def test_chol_tri_inv_kernel_matches_sweep_bit_for_bit(cuda, n, G):
    # the kernel and its step mirror round every operation alike; the sizes
    # take in the panel edges (31-33, 96/97 where two matrices stop sharing
    # an SM), the QP sizes of the nonlinear-row paths (28, 40, 58, 73), the
    # last register variant (225-240: its last panel holds 2 of 4 row
    # tiles), and the wide variant: one past 240, the double-track LMPC's
    # 244 and 274-275, the last size of the triangle in shared memory (302)
    # and the first past it (303), the earlier edge (336, 337), 1024 and one
    # past it, the last size of UT in shared memory (1736) and the first in
    # device memory (1737), and 2048; past n = 302 batches of up to 32 take
    # the grid variant (G = 1, 4, 32) and larger ones one block a matrix
    # (G = 33)
    rng = np.random.default_rng(1000 + n)
    H = (torch.as_tensor(spd(rng, G, n), device=cuda) if n <= 1024
         else spd_on(rng, G, n, cuda))
    K = tl.chol_tri_inv(H)
    S = tl.chol_tri_inv_sweep(H)
    torch.cuda.synchronize()
    assert torch.equal(K.view(torch.int32), S.view(torch.int32))


def test_solve_batch_on_card_matches_cpu(cuda):
    from racing_lmpc_torch.benchmarks import build_barc_lmpc, make_scenario_batch
    out = {}
    for dev in ("cpu", cuda):
        _, track, _, mpc, manager = build_barc_lmpc(10, 16, device=dev)
        inp = make_scenario_batch(mpc, track, manager, 3, seed=7, device=dev)
        tl.chol_tri_inv.launches = 0
        out[str(dev)] = mpc.solve_batch(inp)[0]
        launches = tl.chol_tri_inv.launches
        assert (launches > 0) == (dev != "cpu")
    cpu, gpu = out["cpu"], out[str(cuda)]
    assert np.array_equal(np_of(cpu.solved), np_of(gpu.solved))
    su = mpc.scale_u
    assert (np.abs(np_of(gpu.U_optm) - np_of(cpu.U_optm))[..., 0] / su[0]).max() < 1e-3
    o_c, o_g = np_of(cpu.obj).astype(np.float64), np_of(gpu.obj).astype(np.float64)
    assert (np.abs(o_g - o_c) / np.maximum(np.abs(o_c), 1.0)).max() < 1e-3


@pytest.mark.parametrize("kind", ["kinematic", "double_track"])
def test_nl_solve_batch_on_card_matches_cpu(cuda, kind):
    """A batch of the nonlinear-row scenarios (N=10) on the card and on the
    CPU: the same flags, controls and objectives."""
    import chip_smoke
    from racing_lmpc_torch.mpc.racing_mpc import REQUIRED_FIELDS, MPCInput
    c = chip_smoke.NL_KIN if kind == "kinematic" else chip_smoke.NL_DT
    out = {}
    for dev in ("cpu", cuda):
        _, track, mpc = chip_smoke.nl_problem(kind, 10, dev)
        if kind == "kinematic":
            x_ics = np.asarray(c["x_ic"]) + np.array([[0, 0, 0, 0], [1.0, 0.05, 0.0, 0.4]])
        else:
            x_ics = chip_smoke.dt_batch_states(chip_smoke.dt_corner(track))[:3]
        lanes = [chip_smoke.nl_input(mpc, track, x, x[mpc.idx_vel], c["v_target"], c["dt"])
                 for x in x_ics]
        inp = MPCInput(**{f: torch.stack([getattr(a, f) for a in lanes]) for f in REQUIRED_FIELDS})
        tl.chol_tri_inv.launches = 0
        out[str(dev)] = mpc.solve_batch(inp)[0]
        assert (tl.chol_tri_inv.launches > 0) == (dev != "cpu")
    cpu, gpu = out["cpu"], out[str(cuda)]
    assert np.array_equal(np_of(cpu.solved), np_of(gpu.solved))
    su = mpc.scale_u
    assert (np.abs(np_of(gpu.U_optm) - np_of(cpu.U_optm))[..., :2] / su[:2]).max() < 1e-3
    o_c, o_g = np_of(cpu.obj).astype(np.float64), np_of(gpu.obj).astype(np.float64)
    assert (np.abs(o_g - o_c) / np.maximum(np.abs(o_c), 1.0)).max() < 1e-3


def tie_batch(rng, size=16):
    """Sylvester-Hadamard matrices of order ``size`` (rows permuted, signs
    flipped, columns scaled by powers of two): every pivot is a tie, and
    the elimination is exact in f32."""
    out = []
    H = np.array([[1.0]])
    while H.shape[0] < size:
        H = np.block([[H, H], [H, -H]])
    for _ in range(8):
        M = H[rng.permutation(size)] * rng.choice([-1.0, 1.0], size=(size, 1))
        out.append(M * 2.0 ** rng.integers(-3, 4, size=(1, size)))
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("singular", [False, True])
@pytest.mark.parametrize("b", [1, 2, 3, 15, 16, 17, 31, 32, 33, 48, 63, 64,
                               65, 168, 169, 256, 512, 1024, 1547])
def test_gj_inverse_kernel_matches_plain(cuda, b, singular):
    # b takes in the edges of the kernel's size classes (16, 32, 64) and of
    # its variants (the matrix in shared memory from 65 to 168, the grid
    # variant from 169: 169, 256, 512, (4, 1024) and (4, 1547), the first
    # size whose panel it keeps in device memory); a singular lane must give
    # the plain version's pivots and non-finite entries, and leave the other
    # lanes alone
    rng = np.random.default_rng(b)
    G, bad_lane = (40, 7) if b <= 512 else (4, 1)
    An = (rng.normal(size=(G, b, b)) + 2 * np.sqrt(b) * np.eye(b)).astype(np.float32)
    if singular:
        An[bad_lane] = 0.0
    A = torch.as_tensor(An, device=cuda)
    before = tl.gj_inverse.launches
    K, pk = tl.gj_inverse(A, return_pivots=True)
    P, pp = tl.gj_inverse_plain(A, return_pivots=True)
    torch.cuda.synchronize()
    assert tl.gj_inverse.launches == before + 1
    assert torch.equal(pk, pp)
    fin = torch.isfinite(P)
    assert torch.equal(fin, torch.isfinite(K))
    assert torch.equal(K[fin].view(torch.int32), P[fin].view(torch.int32))
    bad = ~fin.flatten(1).all(dim=1)
    assert bad.tolist() == [singular and g == bad_lane for g in range(G)]
    # without pivots asked for (a null pivot pointer), the same bits
    assert torch.equal(tl.gj_inverse(A).view(torch.int32), K.view(torch.int32))


def test_gj_inverse_kernel_ties_and_limits(cuda):
    for size in (16, 128):
        A = torch.as_tensor(tie_batch(np.random.default_rng(0), size), device=cuda)
        K, pk = tl.gj_inverse(A, return_pivots=True)
        P, pp = tl.gj_inverse_plain(A, return_pivots=True)
        assert torch.equal(pk, pp) and (pk[:, 0] == 0).all()
        assert torch.equal(K, P)
    # b = 65, one past the register classes: the plain version's bits
    A = torch.as_tensor(np.random.default_rng(65).normal(size=(2, 65, 65)).astype(np.float32)
                        + 16 * np.eye(65, dtype=np.float32), device=cuda)
    assert torch.equal(tl.gj_inverse(A).view(torch.int32),
                       tl.gj_inverse_plain(A).view(torch.int32))
    with pytest.raises(TypeError):
        tl.gj_inverse(torch.zeros(1, 8, 8, device=cuda, dtype=torch.float64))


def random_qps(rng, B, n, m):
    """A batch of strictly convex QPs with two-sided inequality rows."""
    M = rng.normal(size=(B, n, n))
    P = np.einsum("bij,bkj->bik", M, M) + n * np.eye(n)
    return [a.astype(np.float32) for a in (
        P, rng.normal(size=(B, n)), rng.normal(size=(B, m, n)),
        -rng.uniform(0.1, 1.0, (B, m)), rng.uniform(0.1, 1.0, (B, m)))]


def test_admm_solve_qp_on_card_matches_cpu(cuda):
    from racing_lmpc_torch.mpc.qp import QPData, solve_qp
    arrays = random_qps(np.random.default_rng(3), 16, 20, 30)
    sols = {}
    for dev in ("cpu", cuda):
        sols[str(dev)] = solve_qp(QPData(*(torch.as_tensor(a, device=dev) for a in arrays)),
                                  iters=400)
    cpu, gpu = sols["cpu"], sols[str(cuda)]
    # well-conditioned QPs: both paths converge to the optimum, to within
    # the ADMM's own f32 accuracy
    assert rel_err(np_of(gpu.x), np_of(cpu.x)) < 1e-4
    assert rel_err(np_of(gpu.obj), np_of(cpu.obj)) < 1e-4
    assert np.array_equal(np_of(gpu.rp_rel) < 1e-3, np_of(cpu.rp_rel) < 1e-3)


def test_admm_solve_launches_chol_tri_inv_six_times(cuda):
    # rho_updates + 1 = 5 chunks, each factoring its KKT matrix, + the polish
    from racing_lmpc_torch.mpc.qp import QPData, solve_qp
    arrays = random_qps(np.random.default_rng(4), 8, 12, 18)
    data = QPData(*(torch.as_tensor(a, device=cuda) for a in arrays))
    before = tl.chol_tri_inv.launches
    solve_qp(data, iters=400)
    torch.cuda.synchronize()
    assert tl.chol_tri_inv.launches == before + 6
    solve_qp(data, iters=400, do_polish=False)
    assert tl.chol_tri_inv.launches == before + 11


def test_regression_sweep_on_card_matches_host(cuda):
    from racing_lmpc_torch import config as tc
    from racing_lmpc_torch.benchmarks import BARC_LAPS
    from racing_lmpc_torch.models import SingleTrackPlanarModel
    from racing_lmpc_torch.safeset import RegQuery, SafeSetManager, SafeSetRecorder
    from racing_lmpc_torch.track import RacingTrajectory
    track = RacingTrajectory.from_file(tc.TRACK_DIR / "barc" / "02_barc_center.txt",
                                       device="cpu")
    manager = SafeSetManager(3, nx=6, nu=2)
    SafeSetRecorder(manager).load(BARC_LAPS, track.total_length)
    model = SingleTrackPlanarModel(*tc.barc_vehicle())
    groups = (((3, 4, 5), (0, 1), 4), ((3, 4, 5), (0, 1), 5))
    x, u = np.array([2.0, 0.1, 0.0, 1.8, 0.05, 0.3]), np.array([0.004, 0.05])
    query = RegQuery(
        x=tuple(np.concatenate([x[list(a)], u[list(b)]]) for a, b, _ in groups),
        dist_max=3.0, reg_in_state_idxs=[g[0] for g in groups],
        reg_in_control_idxs=[g[1] for g in groups], reg_out_state_idxs=[(g[2],) for g in groups],
        A=np.zeros((6, 6)), B=np.zeros((6, 2)), C=np.zeros(6), f=model.discrete_dynamics)
    host = manager.query_regression(query, device="cpu")
    card = manager.query_regression(query, device=cuda)
    # the one-step predictions in f32 on either device; the least squares in
    # float64 on the host (the reference's own spread between runs moved by
    # one f32 rounding is 4e-4 on dA)
    for a, b in zip(card, host):
        assert np.abs(a - b).max() < 1e-4
    assert np.abs(card.A[:4]).max() == 0.0 and np.abs(card.A[4:]).sum() > 0.0


def test_bus_cycles_on_card(cuda):
    """3 cycles of the two-node co-simulation over the native bus, the
    controller launching its kernels from the bus's dispatch thread."""
    from racing_lmpc_torch.launch.runner import _SCENARIOS, BusCoSimulation
    sim = BusCoSimulation(_SCENARIOS["barc_lmpc"], n_override=10,
                          mpc_overrides={"num_ss_pts": 16}, device=cuda)
    tl.chol_tri_inv.launches = 0
    try:
        summary = sim.run(3, timeout_s=300.0)
    finally:
        sim.close()
    assert summary["steps"] == 3 and tl.chol_tri_inv.launches > 0
    for t in sim.cs.telemetry:
        assert np.isfinite(t.control).all() and np.isfinite(t.cost)


def test_world_size_1_nccl_sharded_solve_matches_unsharded(cuda):
    import torch.distributed as dist
    from racing_lmpc_torch.benchmarks import build_barc_lmpc, make_scenario_batch
    from racing_lmpc_torch.parallel import sharded_batch_solver, sharded_metrics
    from racing_lmpc_torch.parallel.distributed import (
        global_mesh, initialize, process_allgather, shard_batch_global)
    from racing_lmpc_torch.parallel.spawn import free_port
    _, track, _, mpc, manager = build_barc_lmpc(10, 16, device=cuda)
    inp = make_scenario_batch(mpc, track, manager, 8, seed=3, device=cuda)
    z = torch.zeros((8, mpc.layout.n))
    valid = torch.zeros((8,), dtype=torch.bool)
    want, _ = mpc.solve_batch(inp)
    initialize(f"127.0.0.1:{free_port()}", 1, 0, cuda)
    try:
        assert dist.get_backend() == "nccl"
        mesh = global_mesh()
        tl.chol_tri_inv.launches = 0
        out, _ = sharded_batch_solver(mpc, mesh)(
            *(shard_batch_global(x, mesh) for x in (inp, z, valid)))
        assert tl.chol_tri_inv.launches > 0
        frac, cmin = sharded_metrics(out.solved, out.obj, mesh)
        U, solved = process_allgather((out.U_optm, out.solved))
    finally:
        dist.destroy_process_group()
    assert np.array_equal(solved, np_of(want.solved))
    assert rel_err(U, np_of(want.U_optm)) < 1e-5
    assert float(frac) == float(want.solved.float().mean())
    assert float(cmin) == float(want.obj[want.solved].min())


def test_ipm_lu_branch_on_card_matches_cpu(cuda):
    """``solve_qp_ip`` without ``eq_rows`` (the pivoted-LU KKT) on the card
    and on the CPU: both converge, x within 5e-4 and the objective within
    1e-5 (the CPU tests' bounds against the reference)."""
    from racing_lmpc_torch.mpc.ipm import solve_qp_ip
    from racing_lmpc_torch.mpc.qp import QPData
    P, q, A, l, u = random_qps(np.random.default_rng(8), 6, 10, 14)
    l[:, :3] = u[:, :3] = 0.0                       # three equality rows
    l[:, 3:5] = -np.inf
    sols = {}
    for dev in ("cpu", cuda):
        sols[str(dev)] = solve_qp_ip(QPData(*(torch.as_tensor(a, device=dev)
                                              for a in (P, q, A, l, u))), iters=25)
    cpu, gpu = sols["cpu"], sols[str(cuda)]
    for s in (cpu, gpu):
        assert (np_of(s.rp_rel) < 1e-3).all() and (np_of(s.rd_rel) < 1e-3).all()
    assert rel_err(np_of(gpu.x), np_of(cpu.x)) < 5e-4
    assert rel_err(np_of(gpu.obj), np_of(cpu.obj)) < 1e-5


def test_span_clock_holds_the_device_records(cuda):
    """A span around one kernel and a ``synchronize()``, under a profiler
    session of CUDA activity only, which turns the spans on by itself: the
    kernel's recorded interval lies inside the span, within 20 us, so spans
    and device records share one clock.  A session whose kernel record was
    dropped is run again."""
    from torch.profiler import ProfilerActivity, profile
    from racing_lmpc_torch import spans as tm
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    assert not tm.set_spans(False)
    tm.take_spans()
    for _ in range(6):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with tm.span("clock"):
                torch.cuda._sleep(2_000_000)
                torch.cuda.synchronize()
        (s,) = tm.take_spans()
        kernels = [e for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA
                   and not e.is_hidden_event()]
        if kernels:
            break
    assert len(kernels) == 1
    k0, k1 = kernels[0].start_ns(), kernels[0].start_ns() + kernels[0].duration_ns()
    assert s.t0_ns - 20_000 <= k0 < k1 <= s.t1_ns + 20_000, (s.t0_ns - k0, s.t1_ns - k1)


def test_solve_batch_syncs_are_counted(cuda):
    """One ``solve_batch`` of the shipped BARC LMPC under PyTorch's sync
    debug mode: every synchronizing call it reports is counted in
    ``host_syncs`` at its site, and nothing else is."""
    from racing_lmpc_torch.benchmarks import build_barc_lmpc, make_scenario_batch
    from racing_lmpc_torch import spans as tm
    _, track, _, mpc, manager = build_barc_lmpc(40, 96, 32, device=cuda)
    inp = make_scenario_batch(mpc, track, manager, 64, seed=5, device=cuda)
    mpc.solve_batch(inp)                          # builds and loads the kernel
    torch.cuda.synchronize()
    s0 = tm.host_syncs
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            mpc.solve_batch(inp)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in seen if "synchronizing CUDA operation" in str(w.message)]
    assert len(syncs) == tm.host_syncs - s0 > 0, [(w.filename, w.lineno) for w in syncs]
