"""The grid variants of both kernels (``chol_tri_inv`` past n = 302 for
batches of at most 32, ``gj_inverse`` past b = 168: one matrix spread over
the whole card) apply each entry's operations in the order of the kernels'
mirrors.

``csrc/chol_tri_inv.cu``'s grid variant runs the wide variant's stages with
a grid-wide barrier between them: per panel of 32 pivots, S3 one line a
thread (a column left of the panel also writes the panel rows' X there);
then, side by side, the chain (the next panel's diagonal block takes this
panel's update, then its S2) and S4 in block tiles of 64 x 64.
``csrc/gj_inverse.cu``'s grid variant runs the steps in panels of 32: A the
panel's steps on its columns, B each other column down the panel's pivot
rows, C every other entry in block tiles of 128 x 128, the next panel's
columns and its A on the chain beside C.  ``chol_grid`` and ``gj_grid``
below repeat those schedules in plain PyTorch, panel by panel and tile by
tile, every product, difference and quotient rounded on its own as the
kernels round them, with the panel width and the tile as parameters so that
small sizes (n, b = 70-130) take many panels and tiles.  Each is held with
``torch.equal`` (NaN in the same places) to the kernel's mirror
(``chol_tri_inv_sweep``; ``gj_inverse_plain`` and its pivots), on an
indefinite lane, a singular lane and the Hadamard tie batch too, and to the
JAX functions at the tolerances of tests/test_torch_chol_sweep.py and
tests/test_torch_gj_inverse.py (1e-4 relative; ||A^-1 A - I|| < 2e-4).  The
kernels themselves are held to the mirrors on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import hadamard_tie_batch
from racing_lmpc_tpu.ops import pallas_linalg as jl
from racing_lmpc_torch.ops import linalg as tl
from tests._torch_twin import rel_err, spd, twin


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """NaN in the same places, every other entry bit for bit."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))
                and torch.equal(torch.where(nan, 0.0, a).view(torch.int32),
                                torch.where(nan, 0.0, b).view(torch.int32)))


# ---- chol_tri_inv ---------------------------------------------------------

def _recip_sqrt(d: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(d), each step correctly rounded to f32 (__fsqrt_rn,
    __fdiv_rn; through f64, as the sweep does it)."""
    return (1.0 / torch.sqrt(d.double()).float().double()).float()


def _chol_factor_block(M, j0, nb):
    """S1, S2 (the chain's warp 0): the panel's diagonal block swept alone.
    Returns the block of X, UP (UP[:, p] is pivot p's u on the panel) and
    rr."""
    D = M[:, j0:j0 + nb, j0:j0 + nb].clone()
    UP = torch.zeros(M.shape[0], nb, nb)
    rr = torch.zeros(M.shape[0], nb)
    for p in range(nb):
        r = _recip_sqrt(D[:, p, p])
        row = D[:, p, :p] * r[:, None]
        lc = D[:, p + 1:, p] * r[:, None]
        UP[:, p] = torch.cat([row, r[:, None], lc], dim=-1)
        rr[:, p] = r
        D[:, p, :p] = row
        D[:, p, p] = r
        D[:, p + 1:, p] = 0.0
        D[:, p + 1:, :] = D[:, p + 1:, :] - lc[:, :, None] * UP[:, p, None, :]
    return torch.tril(D), UP, rr


def _chol_apply(M, UT, rows, cols, takes):
    """The panel's pivots in ascending order on the entries ``takes`` of
    the block rows x cols (l_i and u_k from UT); the others untouched."""
    T = M[:, rows][:, :, cols]
    for p in range(UT.shape[1]):
        T = T - UT[:, p, rows, None] * UT[:, p, None, cols]
    M[:, rows[:, None], cols[None, :]] = torch.where(takes, T, M[:, rows][:, :, cols])


def chol_grid(H: torch.Tensor, width: int = 32, tile: int = 64) -> torch.Tensor:
    """``L^-1`` for ``L = chol(H)`` over (G, n, n) in the grid variant's
    schedule: the first panel's chain; then for each panel X (S3: each row
    below and each column left of the panel, one a thread, the latter also
    writing the panel rows' X) and Y (the next panel's chain — its diagonal
    block's update, S2 — and S4 tile by tile: the rows below by the columns
    left of the panel, then the trailing triangle from the next panel's
    rows down)."""
    G, n = H.shape[0], H.shape[-1]
    ar = torch.arange
    M = torch.tril(H).clone()
    D, UP, rr = _chol_factor_block(M, 0, min(width, n))
    M[:, :D.shape[-1], :D.shape[-1]] = D
    for j0 in range(0, n, width):
        nb = min(width, n - j0)
        j1 = j0 + nb
        # X: S3 into UT (row p: the l_i below the panel, row p of X left of it)
        UT = torch.zeros(G, nb, n)
        B = M[:, j1:, j0:j1].clone()
        for p in range(nb):
            li = B[:, :, p] * rr[:, p, None]
            UT[:, p, j1:] = li
            B[:, :, p] = 0.0
            B = B - li[:, :, None] * UP[:, p, None, :]
        M[:, j1:, j0:j1] = B
        C = M[:, j0:j1, :j0].clone()
        for p in range(nb):
            x = C[:, p] * rr[:, p, None]
            C[:, p] = x
            C[:, p + 1:] = C[:, p + 1:] - UP[:, p, p + 1:, None] * x[:, None, :]
        UT[:, :, :j0] = C
        M[:, j0:j1, :j0] = C
        if j1 == n:
            break
        j2 = min(j1 + width, n)
        # Y: the chain ...
        blk = ar(j1, j2)
        _chol_apply(M, UT, blk, blk, blk[None, None, :] <= blk[None, :, None])
        D, UP, rr = _chol_factor_block(M, j1, j2 - j1)
        M[:, j1:j2, j1:j2] = D
        # ... beside S4's tiles
        for r0 in range(j1, n, tile):
            rows = ar(r0, min(r0 + tile, n))
            for c0 in range(0, j0, tile):
                cols = ar(c0, min(c0 + tile, j0))
                _chol_apply(M, UT, rows, cols, torch.ones(1, len(rows), len(cols), dtype=bool))
            for c0 in range(j1, r0 + 1, tile):
                cols = ar(c0, min(c0 + tile, n))
                takes = (cols[None, :] <= rows[:, None]) & (rows[:, None] >= j2)
                _chol_apply(M, UT, rows, cols, takes[None])
    return torch.tril(M)


@pytest.mark.parametrize("n,width,tile", [(70, 8, 16), (97, 16, 32), (130, 32, 64),
                                          (130, 8, 24)])
def test_chol_grid_schedule_is_bit_equal_to_the_sweep(n, width, tile):
    H = spd(np.random.default_rng(700 + n + width), 2, n)
    X = chol_grid(torch.as_tensor(H), width, tile)
    S = tl.chol_tri_inv_sweep(torch.as_tensor(H))
    assert torch.equal(X.view(torch.int32), S.view(torch.int32))
    Xj, Xt = twin(lambda h: jl.tri_inv_lower(jl.chol_lower(h)),
                  lambda h: chol_grid(h, width, tile), H)
    assert rel_err(Xt, Xj) < 1e-4


def test_chol_grid_schedule_nan_in_indefinite_lane_only():
    # a non-positive pivot in the fourth panel of one lane: NaN in that
    # lane's rows from it on, bit for bit as the sweep gives every lane
    H = spd(np.random.default_rng(701), 3, 100)
    H[1, 57, 57] = -1.0e4
    X = chol_grid(torch.as_tensor(H), 16, 32)
    S = tl.chol_tri_inv_sweep(torch.as_tensor(H))
    bad = ~torch.isfinite(X).flatten(1).all(dim=1)
    assert bad.tolist() == [False, True, False]
    assert bool(torch.isfinite(X[1, :57]).all()) and bool(torch.isnan(X[1, 57:]).any(dim=1).all())
    assert same_bits(X, S)


# ---- gj_inverse -----------------------------------------------------------

def gj_grid(A: torch.Tensor, width: int = 32, tile: tuple = (128, 128)):
    """``A^-1`` of (G, b, b) and the pivots in the grid variant's schedule:
    the first panel's A; then for each panel B (each column outside the
    panel down its pivot rows into P) and C beside the chain (the next
    panel's columns take this panel's steps, then that panel's A), C tile
    by tile over every other entry."""
    G, b, _ = A.shape
    eye = torch.eye(b, dtype=A.dtype).expand(G, b, b)
    MI = torch.cat([A, eye], dim=-1)
    rows = torch.arange(b)
    used = torch.zeros(G, b)
    piv = torch.zeros(G, b, dtype=torch.long)
    P = torch.zeros(G, width, 2 * b)
    F = [torch.zeros(G, width, b), torch.zeros(G, width, b)]

    def steps(k0, nb, Fb):
        # A: the panel's steps on its columns of every row
        nonlocal used
        Ms = MI[:, :, k0:k0 + nb].clone()
        for kk in range(nb):
            col = Ms[:, :, kk]
            Fb[:, kk] = col
            p = torch.argmax(col.abs() - used * 1e30, dim=-1)
            d = col.gather(1, p[:, None])
            prow = Ms.gather(1, p[:, None, None].expand(G, 1, nb))[:, 0] / d
            oh = rows == p[:, None]
            Ms = torch.where(oh[..., None], prow[:, None, :], Ms - col[..., None] * prow[:, None, :])
            used = used + oh
            piv[:, k0 + kk] = p
        MI[:, :, k0:k0 + nb] = Ms

    def columns(k0, nb, Fb):
        # B: each column outside the panel down the panel's pivot rows
        cols = torch.cat([torch.arange(k0), torch.arange(k0 + nb, 2 * b)])
        pv = piv[:, k0:k0 + nb]
        for kk in range(nb):
            v = MI.gather(1, pv[:, kk, None, None].expand(G, 1, 2 * b))[:, 0][:, cols]
            for kp in range(kk):
                same = (pv[:, kk] == pv[:, kp])[:, None]
                f = Fb[:, kp].gather(1, pv[:, kk, None])
                v = torch.where(same, P[:, kp, cols], v - f * P[:, kp, cols])
            P[:, kk, cols] = v / Fb[:, kk].gather(1, pv[:, kk, None])

    def apply(k0, nb, Fb, r, c):
        # C on the entries r x c: the row that pivots at step k takes P[k]
        T = MI[:, r][:, :, c]
        pv = piv[:, k0:k0 + nb]
        for kk in range(nb):
            here = (r[None, :] == pv[:, kk, None])[..., None]
            T = torch.where(here, P[:, kk, None, c], T - Fb[:, kk, r, None] * P[:, kk, None, c])
        MI[:, r[:, None], c[None, :]] = T

    steps(0, min(width, b), F[0])
    for t, k0 in enumerate(range(0, b, width)):
        nb = min(width, b - k0)
        k1 = k0 + nb
        nb1 = min(width, b - k1) if k1 < b else 0
        Fb = F[t % 2]
        columns(k0, nb, Fb)
        if nb1:
            apply(k0, nb, Fb, rows, torch.arange(k1, k1 + nb1))
            steps(k1, nb1, F[(t + 1) % 2])
        for r0 in range(0, b, tile[0]):
            r = torch.arange(r0, min(r0 + tile[0], b))
            for c0 in range(0, 2 * b, tile[1]):
                c = torch.arange(c0, min(c0 + tile[1], 2 * b))
                c = c[((c < k0) | (c >= k1)) & ((c < k1) | (c >= k1 + nb1))]
                if len(c):
                    apply(k0, nb, Fb, r, c)
    inv = MI[:, :, b:].gather(1, piv[..., None].expand(-1, b, b))
    return inv, piv


def _gj_check(A: np.ndarray, width: int, tile: tuple):
    """The schedule against the plain version (bits, NaN places, pivots)."""
    inv, piv = gj_grid(torch.as_tensor(A), width, tile)
    P, pp = tl.gj_inverse_plain(torch.as_tensor(A), return_pivots=True)
    assert torch.equal(piv, pp)
    assert same_bits(inv, P)
    return inv.numpy()


@pytest.mark.parametrize("b,width,tile", [(70, 8, (16, 32)), (97, 16, (32, 64)),
                                          (130, 32, (128, 128)), (130, 16, (48, 40))])
def test_gj_grid_schedule_is_bit_equal_to_plain(b, width, tile):
    rng = np.random.default_rng(800 + b + width)
    A = (rng.normal(size=(3, b, b)) + 2 * np.sqrt(b) * np.eye(b)).astype(np.float32)
    t = _gj_check(A, width, tile)
    j = np.asarray(jl._gj_inverse_batch(jnp.asarray(A)))
    assert rel_err(t, j) < 1e-4
    err = np.abs(np.einsum("bij,bjk->bik", t, A) - np.eye(b, dtype=np.float32)).max()
    assert err < 2e-4


def test_gj_grid_schedule_singular_lane():
    # a zero matrix in lane 1 (every pivot a NaN tie: row 0 pivots again at
    # each step) and a rank-deficient lane 2: the plain version's pivots and
    # NaN, the other lanes untouched
    rng = np.random.default_rng(801)
    b = 75
    A = (rng.normal(size=(4, b, b)) + 2 * np.sqrt(b) * np.eye(b)).astype(np.float32)
    A[1] = 0.0
    A[2, :, 40] = A[2, :, 3]
    t = _gj_check(A, 16, (32, 64))
    bad = ~np.isfinite(t).reshape(4, -1).all(-1)
    assert bad[1] and not bad[0] and not bad[3]
    j = np.asarray(jl._gj_inverse_batch(jnp.asarray(A)))
    keep = [0, 3]
    assert rel_err(t[keep], j[keep]) < 1e-4


def test_gj_grid_schedule_exact_ties():
    # every pivot a tie (Hadamard blocks): the lowest row, and exact
    A = hadamard_tie_batch(np.random.default_rng(802), 128)
    t = _gj_check(A, 32, (64, 96))
    assert np.array_equal(t, np.asarray(jl._gj_inverse_batch(jnp.asarray(A))))
    np.testing.assert_array_equal(np.einsum("bij,bjk->bik", t, A),
                                  np.broadcast_to(np.eye(128), A.shape))
