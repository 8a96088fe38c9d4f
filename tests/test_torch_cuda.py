"""Port tests that need an NVIDIA GPU: the hand-written kernels against
their plain versions, and the batched solve on the card against the same
solve on the CPU.  They skip where ``torch.cuda.is_available()`` is false.  This file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

It imports nothing from the other test modules either (a ``tests`` package
installed elsewhere can shadow this directory there).
"""

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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n", [1, 87, 175, 216])
def test_chol_tri_inv_kernel_matches_plain(cuda, n):
    H = torch.as_tensor(spd(np.random.default_rng(n), 32, n), device=cuda)
    before = tl.chol_tri_inv.launches
    K = tl.chol_tri_inv(H)
    P = tl.chol_tri_inv_plain(H)
    torch.cuda.synchronize()
    assert tl.chol_tri_inv.launches == before + 1
    assert rel_err(np_of(K), np_of(P)) < 1e-4
    with pytest.raises(ValueError):
        tl.chol_tri_inv(torch.zeros(1, 241, 241, device=cuda))


@pytest.mark.parametrize("G", [1, 32])
@pytest.mark.parametrize("n", [1, 2, 32, 33, 87, 96, 97, 175, 216, 225, 240])
def test_chol_tri_inv_kernel_matches_sweep_bit_for_bit(cuda, n, G):
    # the kernel and its step mirror round every operation alike; the sizes
    # take in the panel edges (32, 96/97 where two matrices stop sharing an
    # SM) and the last variant (225-240: its last panel holds 2 of 4 row
    # tiles) up to the limit
    H = torch.as_tensor(spd(np.random.default_rng(1000 + n), G, n), device=cuda)
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


def tie_batch(rng):
    """Sylvester-Hadamard matrices (rows permuted, signs flipped, columns
    scaled by powers of two): every pivot is a tie, and the elimination is
    exact in f32."""
    out = []
    H = np.array([[1.0]])
    while H.shape[0] < 16:
        H = np.block([[H, H], [H, -H]])
    for _ in range(8):
        M = H[rng.permutation(16)] * rng.choice([-1.0, 1.0], size=(16, 1))
        out.append(M * 2.0 ** rng.integers(-3, 4, size=(1, 16)))
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("singular", [False, True])
@pytest.mark.parametrize("b", [1, 2, 3, 15, 16, 17, 31, 32, 33, 48, 63, 64])
def test_gj_inverse_kernel_matches_plain(cuda, b, singular):
    # b takes in the edges of the kernel's size classes (16, 32, 64); a
    # singular lane must give the plain version's pivots and non-finite
    # entries, and leave the other lanes alone
    rng = np.random.default_rng(b)
    An = (rng.normal(size=(40, b, b)) + 2 * np.sqrt(b) * np.eye(b)).astype(np.float32)
    if singular:
        An[7] = 0.0
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
    assert bad.tolist() == [singular and g == 7 for g in range(40)]
    # without pivots asked for (a null pivot pointer), the same bits
    assert torch.equal(tl.gj_inverse(A).view(torch.int32), K.view(torch.int32))


def test_gj_inverse_kernel_ties_and_limits(cuda):
    A = torch.as_tensor(tie_batch(np.random.default_rng(0)), device=cuda)
    K, pk = tl.gj_inverse(A, return_pivots=True)
    P, pp = tl.gj_inverse_plain(A, return_pivots=True)
    assert torch.equal(pk, pp) and (pk[:, 0] == 0).all()
    assert torch.equal(K, P)
    with pytest.raises(ValueError):
        tl.gj_inverse(torch.zeros(1, 65, 65, device=cuda))
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
