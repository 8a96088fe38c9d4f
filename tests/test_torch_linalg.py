"""Port linear algebra (racing_lmpc_torch/ops/linalg.py) against the JAX
package's ops/pallas_linalg.py on the same seeded inputs.

Mirrors tests/test_linalg.py:27-72 and :94-118.  Tolerances: 1e-5 relative
where both sides run the same f32 arithmetic op for op (Cholesky, closed
form inverses); 1e-4 relative on L^-1, the class of test_linalg.py:104-118
(the substitution sums round in another order).  The JAX side runs its
pure-JAX path, which is also the body of its Pallas kernel.
"""

import numpy as np
import pytest
import torch

from racing_lmpc_tpu.ops import pallas_linalg as jl
from racing_lmpc_torch.ops import linalg as tl
from tests._torch_twin import rel_err, spd, twin

SIZES = [1, 5, 32, 87, 135]


@pytest.mark.parametrize("n", SIZES)
def test_chol_lower_matches_jax(n):
    H = spd(np.random.default_rng(n), 7, n)
    Lj, Lt = twin(jl.chol_lower, tl.chol_lower, H)
    assert rel_err(Lt, Lj) < 1e-5
    L_ref = np.linalg.cholesky(H.astype(np.float64))
    assert np.abs(Lt - L_ref).max() / np.abs(L_ref).max() < 5e-6
    iu = np.triu_indices(n, 1)
    assert np.all(Lt[..., iu[0], iu[1]] == 0)


@pytest.mark.parametrize("n", SIZES)
def test_tri_inv_lower_matches_jax(n):
    H = spd(np.random.default_rng(100 + n), 4, n)
    L = np.linalg.cholesky(H.astype(np.float64)).astype(np.float32)
    Xj, Xt = twin(jl.tri_inv_lower, tl.tri_inv_lower, L)
    assert rel_err(Xt, Xj) < 1e-4
    assert np.abs(Xt @ L - np.eye(n, dtype=np.float32)).max() < 5e-5


def test_small_blocks_match_jax():
    rng = np.random.default_rng(3)
    H = spd(rng, 2, 16)
    Lj, Lt = twin(jl._chol_small, tl._chol_small, H)
    assert rel_err(Lt, Lj) < 1e-5
    L = np.linalg.cholesky(spd(rng, 4, 24).astype(np.float64)).astype(np.float32)
    Xj, Xt = twin(jl._tri_inv_small, tl._tri_inv_small, L)
    assert rel_err(Xt, Xj) < 1e-4


def test_chol_lower_wide_spectrum():
    H = spd(np.random.default_rng(0), 5, 64, cond_boost=3.0)   # cond ~ 1e6
    L = tl.chol_lower(torch.as_tensor(H)).numpy()
    rec = np.einsum("bij,bkj->bik", L, L)
    assert np.abs(rec - H).max() / np.abs(H).max() < 1e-5


@pytest.mark.parametrize("fn", ["chol_lower", "chol_tri_inv"])
def test_nan_on_indefinite_lane_only(fn):
    # the IPM's step_ok guard relies on NaN from a non-PD pivot
    H = np.eye(8, dtype=np.float32)[None].repeat(3, 0)
    H[1, 5, 5] = -1.0
    out = getattr(tl, fn)(torch.as_tensor(H)).numpy()
    assert not np.isnan(out[0]).any() and not np.isnan(out[2]).any()
    assert np.isnan(out[1]).any()


@pytest.mark.parametrize("n", SIZES)
def test_chol_tri_inv_cpu_takes_plain_path(n):
    H = spd(np.random.default_rng(200 + n), 6, n)
    before = tl.chol_tri_inv.launches
    Xj, Xt = twin(lambda h: jl.tri_inv_lower(jl.chol_lower(h)), tl.chol_tri_inv, H)
    assert tl.chol_tri_inv.launches == before == 0
    assert rel_err(Xt, Xj) < 1e-4
    Li_ref = np.linalg.inv(np.linalg.cholesky(H.astype(np.float64)))
    assert np.abs(Xt - Li_ref).max() / np.abs(Li_ref).max() < 5e-5
    assert np.array_equal(Xt, tl.chol_tri_inv_plain(torch.as_tensor(H)).numpy())


def test_chol_tri_inv_matches_fused_pallas_interpret():
    # the TPU kernel itself, in interpret mode (test_linalg.py:94-105)
    H = spd(np.random.default_rng(3), 4, 87)
    Xj, Xt = twin(lambda h: jl.chol_tri_inv_fused(h, rows_per_program=4,
                                                   interpret=True),
                  tl.chol_tri_inv, H)
    assert rel_err(Xt, Xj) < 1e-4


def test_chol_tri_inv_checks_its_input():
    H = torch.eye(4)[None].repeat(2, 1, 1)
    with pytest.raises(TypeError):
        tl.chol_tri_inv(H.double())
    with pytest.raises(ValueError):
        tl.chol_tri_inv(torch.zeros(2, 3, 4))
    with pytest.raises(ValueError):
        tl.chol_tri_inv(torch.eye(8)[None, ::2, ::2])


@pytest.mark.parametrize("k", [1, 2, 3])
def test_inv_small_and_solve_small_match_jax(k):
    rng = np.random.default_rng(k)
    M = (rng.normal(size=(9, k, k)) + 3 * np.eye(k)).astype(np.float32)
    X = rng.normal(size=(9, k, 4)).astype(np.float32)
    Ij, It = twin(jl.inv_small, tl.inv_small, M)
    assert rel_err(It, Ij) < 1e-5
    Sj, St = twin(jl.solve_small, tl.solve_small, M, X)
    assert rel_err(St, Sj) < 1e-5
    with pytest.raises(ValueError):
        tl.inv_small(torch.eye(4)[None])

