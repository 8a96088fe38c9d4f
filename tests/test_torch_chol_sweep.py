"""The Cholesky-inverse kernel's step mirror, ``chol_tri_inv_sweep``
(racing_lmpc_torch/ops/linalg.py), against the JAX package on the same
seeded inputs.

The mirror repeats ``csrc/chol_tri_inv.cu`` step for step — one in-place
right-looking sweep that forms L^-1 — and the card tests
(``tests/test_torch_cuda.py``, ``chip_smoke.py``) hold the kernel to it bit
for bit.  Here it is held to the JAX ``tri_inv_lower(chol_lower(.))`` and
to the TPU kernel itself in interpret mode, to 1e-4 relative (the class of
tests/test_linalg.py:104-118: the sums round in another order), and to the
f64 ``inv(cholesky(H))`` to 5e-5, as tests/test_torch_linalg.py does.
"""

import numpy as np
import pytest
import torch

from racing_lmpc_tpu.ops import pallas_linalg as jl
from racing_lmpc_torch.ops import linalg as tl
from tests._torch_twin import rel_err, spd, twin

SIZES = [1, 2, 31, 32, 33, 87]


def sweep_np(H: np.ndarray) -> np.ndarray:
    return tl.chol_tri_inv_sweep(torch.as_tensor(H)).numpy()


# and for the plain comparison, the edges of the JAX version's blocks of 32
# further out, and the double-track LMPC's QP sizes past the kernel's
# register variants (the sample_mpc and iac_car_lmpc horizons)
@pytest.mark.parametrize("n", SIZES + [64, 96, 97, 244, 275])
def test_sweep_matches_jax(n):
    H = spd(np.random.default_rng(300 + n), 5, n)
    Xj, Xt = twin(lambda h: jl.tri_inv_lower(jl.chol_lower(h)), tl.chol_tri_inv_sweep, H)
    assert rel_err(Xt, Xj) < 1e-4
    Li_ref = np.linalg.inv(np.linalg.cholesky(H.astype(np.float64)))
    assert np.abs(Xt - Li_ref).max() / np.abs(Li_ref).max() < 5e-5
    iu = np.triu_indices(n, 1)
    assert np.all(Xt[..., iu[0], iu[1]] == 0)


@pytest.mark.parametrize("n", SIZES)
def test_sweep_matches_fused_pallas_interpret(n):
    # the TPU kernel itself, in interpret mode (test_linalg.py:94-105)
    H = spd(np.random.default_rng(400 + n), 4, n)
    Xj, Xt = twin(lambda h: jl.chol_tri_inv_fused(h, rows_per_program=4, interpret=True),
                  tl.chol_tri_inv_sweep, H)
    assert rel_err(Xt, Xj) < 1e-4


def test_sweep_wide_spectrum_jacobi_scaled():
    # the IPM factors Jacobi-scaled matrices whose spectrum was wide
    H = spd(np.random.default_rng(7), 6, 87, cond_boost=3.0).astype(np.float64)
    d = 1.0 / np.sqrt(np.einsum("bii->bi", H))
    Hs = (H * d[:, :, None] * d[:, None, :]).astype(np.float32)
    Xj, Xt = twin(lambda h: jl.tri_inv_lower(jl.chol_lower(h)), tl.chol_tri_inv_sweep, Hs)
    assert rel_err(Xt, Xj) < 1e-4
    Li_ref = np.linalg.inv(np.linalg.cholesky(Hs.astype(np.float64)))
    assert np.abs(Xt - Li_ref).max() / np.abs(Li_ref).max() < 5e-5


def test_sweep_nan_in_indefinite_lane_only():
    # the IPM's step_ok guard relies on NaN from a non-PD pivot; the sweep
    # confines it to the bad lane's rows from that pivot on
    H = spd(np.random.default_rng(8), 6, 33)
    H[2, 20, 20] = -1.0e4
    X = sweep_np(H)
    bad = ~np.isfinite(X).reshape(6, -1).all(axis=1)
    assert bad.tolist() == [i == 2 for i in range(6)]
    assert np.isfinite(X[2, :20]).all() and np.isnan(X[2, 20:]).all(axis=1).any()
    keep = [0, 1, 3, 4, 5]
    assert np.array_equal(X[keep], sweep_np(H[keep]))


def test_sweep_lanes_are_independent():
    # a lane's result does not depend on the batch around it, bit for bit
    H = spd(np.random.default_rng(9), 7, 33)
    X = sweep_np(H)
    for b in (0, 3, 6):
        assert np.array_equal(X[b:b + 1], sweep_np(H[b:b + 1]))


def test_sweep_rounds_like_the_kernel():
    # square roots and quotients are correctly rounded f32 (as __fsqrt_rn
    # and __fdiv_rn): on one pivot the sweep is sqrt and 1/sqrt exactly
    h = np.random.default_rng(10).uniform(1e-3, 1e3, size=(4096, 1, 1)).astype(np.float32)
    want = np.float32(1.0) / np.sqrt(h.astype(np.float64)).astype(np.float32)
    assert np.array_equal(sweep_np(h), want.astype(np.float32))


def test_wrapper_cpu_path_is_plain_at_any_n():
    # the CPU path is the plain version (the JAX package's rounding), here at
    # n = 241, one past the kernel's register variants
    H = spd(np.random.default_rng(11), 1, 241)
    X = tl.chol_tri_inv(torch.as_tensor(H)).numpy()
    assert np.array_equal(X, tl.chol_tri_inv_plain(torch.as_tensor(H)).numpy())


@pytest.mark.parametrize("n", [241, 244, 275, 337])
def test_sweep_matches_plain_past_the_register_variants(n):
    # the wide variant's sizes (one pivot past 240, the two LMPC horizons,
    # one past the shared-memory triangle): the mirror the card holds the
    # kernel to bit for bit, against the plain version the CPU path runs
    H = torch.as_tensor(spd(np.random.default_rng(500 + n), 2, n))
    assert rel_err(tl.chol_tri_inv_sweep(H).numpy(), tl.chol_tri_inv_plain(H).numpy()) < 1e-4


def test_wrapper_cpu_path_matches_sweep_past_1024():
    # one pivot past n = 1024, a size of the kernel's wide variant: the CPU
    # path (the plain version) against the mirror the card holds the kernel
    # to bit for bit
    H = torch.as_tensor(spd(np.random.default_rng(1025), 1, 1025))
    assert rel_err(tl.chol_tri_inv(H).numpy(), tl.chol_tri_inv_sweep(H).numpy()) < 1e-4
