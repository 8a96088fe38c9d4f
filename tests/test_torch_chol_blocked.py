"""The blocked order of ``chol_tri_inv``'s wide variant (n > 240) changes
no bit of the kernel's step mirror ``chol_tri_inv_sweep``.

``csrc/chol_tri_inv.cu`` runs the sweep in panels of 32 pivots: S1 the
panel's diagonal block, S2 one warp sweeps it alone, S3 every row below
the panel on the panel's columns and every column left of the panel down
the panel rows, S4 the deferred update of the rows below on every other
column, pivot by pivot from the panel's u kept in UT, the next panel's
diagonal block first, then that panel's S1 and S2 beside the rest.
``blocked`` below repeats that stage order in plain PyTorch, every product
and difference rounded on its own as the sweep rounds them, so a stage that
reorders an element's operations shows here as a changed bit before the
kernel reaches the card (where ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold the kernel itself to the sweep).  The sizes: one past the register variants,
the double-track LMPC's 244 and 275, the last size whose triangle the wide
variant keeps in shared memory (302) and the first it keeps in device
memory (303), and 337.  The JAX ``tri_inv_lower(chol_lower(.))`` is the
reference to 1e-4 relative, as in tests/test_torch_chol_sweep.py.
"""

import numpy as np
import pytest
import torch

from racing_lmpc_tpu.ops import pallas_linalg as jl
from racing_lmpc_torch.ops import linalg as tl
from tests._torch_twin import rel_err, spd, twin

PANEL = 32
SIZES = [241, 244, 275, 302, 303, 337]


def _recip_sqrt(d: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(d) with each step correctly rounded to f32 (as __fsqrt_rn
    and __fdiv_rn; through f64, as the sweep does it)."""
    s = torch.sqrt(d.double()).float()
    return (1.0 / s.double()).float()


def _factor_block(M: torch.Tensor, j0: int, nb: int):
    """S1, S2: the panel's diagonal block swept alone.  Returns the block
    of X, UP (UP[:, p] is pivot p's u on the panel: row p of X up to p,
    then the l below it) and rr (each pivot's r)."""
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


def _update(M: torch.Tensor, UT: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor):
    """S4 on rows x cols: pivot by pivot in ascending order, l_i u_k from
    the panel's UT."""
    T = M[:, rows][:, :, cols]
    for p in range(UT.shape[1]):
        T = T - UT[:, p, rows, None] * UT[:, p, None, cols]
    M[:, rows[:, None], cols[None, :]] = T


def blocked(H: torch.Tensor) -> torch.Tensor:
    """``L^-1`` for ``L = chol(H)`` over (G, n, n) in the wide variant's
    stage order: S1, S2 of the first panel; then for each panel S3 and S4,
    S4 as the kernel splits it: the next panel's diagonal block, that
    panel's S1 and S2, and the rest (the next panel's rows left of this
    panel, then the rows below it on every column outside this panel)."""
    n = H.shape[-1]
    M = torch.tril(H).clone()
    D, UP, rr = _factor_block(M, 0, min(PANEL, n))
    ar = torch.arange
    for j0 in range(0, n, PANEL):
        nb = min(PANEL, n - j0)
        j1 = j0 + nb
        # S3: the block of X back; the rows below on the panel's columns,
        # pivot by pivot (column p restarts from 0), keeping each pivot's
        # l_i; the panel rows left of the panel by forward substitution,
        # which gives their X
        M[:, j0:j1, j0:j1] = D
        UT = torch.zeros(H.shape[0], nb, n)
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
        M[:, j0:j1, :j0] = C
        UT[:, :, :j0] = C
        if j1 == n:
            break
        j2 = min(j1 + PANEL, n)
        # S4: the next panel's diagonal block, then its S1 and S2, then the
        # rest: its rows left of this panel, the rows below it
        _update(M, UT, ar(j1, j2), ar(j1, j2))
        D, UP, rr = _factor_block(M, j1, j2 - j1)
        _update(M, UT, ar(j1, j2), ar(j0))
        _update(M, UT, ar(j2, n), torch.cat([ar(j0), ar(j1, n)]))
    # the sweep writes the same values above the diagonal, never read
    return torch.tril(M)


@pytest.mark.parametrize("n", SIZES)
def test_blocked_order_is_bit_equal_to_the_sweep(n):
    H = spd(np.random.default_rng(600 + n), 2, n)
    X = blocked(torch.as_tensor(H))
    S = tl.chol_tri_inv_sweep(torch.as_tensor(H))
    assert torch.equal(X.view(torch.int32), S.view(torch.int32))
    iu = np.triu_indices(n, 1)
    assert np.all(X.numpy()[..., iu[0], iu[1]] == 0)
    Xj, Xt = twin(lambda h: jl.tri_inv_lower(jl.chol_lower(h)), blocked, H)
    assert rel_err(Xt, Xj) < 1e-4


def test_blocked_order_nan_in_indefinite_lane_only():
    # a non-positive pivot in the second panel of one lane: NaN in that
    # lane's rows from it on, the rows above it and every other lane as the
    # sweep gives them, bit for bit
    H = spd(np.random.default_rng(601), 3, 275)
    H[1, 40, 40] = -1.0e4
    X = blocked(torch.as_tensor(H))
    S = tl.chol_tri_inv_sweep(torch.as_tensor(H))
    bad = ~torch.isfinite(X).flatten(1).all(dim=1)
    assert bad.tolist() == [False, True, False]
    assert bool(torch.isfinite(X[1, :40]).all()) and bool(torch.isnan(X[1, 40:]).any(dim=1).all())
    nan = torch.isnan(X)
    assert torch.equal(nan, torch.isnan(S))
    assert torch.equal(torch.where(nan, 0.0, X).view(torch.int32),
                       torch.where(nan, 0.0, S).view(torch.int32))
