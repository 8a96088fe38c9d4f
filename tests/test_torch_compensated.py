"""Port double-word arithmetic (racing_lmpc_torch/ops/compensated.py)
against numpy float64 (the bounds of tests/test_linalg.py:125-160) and
against the JAX package's ops/compensated.py.  The error-free
transformations must agree with JAX bit for bit: both run each product and
sum as its own rounded f32 op."""

import numpy as np
import pytest
import torch

from racing_lmpc_tpu.ops import compensated as jc
from racing_lmpc_torch.ops import compensated as tc
from tests._torch_twin import twin


def test_compensated_matvec_beats_f32_floor():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((137, 201)).astype(np.float32)
    x = rng.standard_normal(201).astype(np.float32)
    ref = A.astype(np.float64) @ x.astype(np.float64)
    hi, lo = tc.matvec_compensated(torch.as_tensor(A), torch.as_tensor(x))
    err_comp = np.abs(hi.double().numpy() + lo.double().numpy() - ref).max()
    err_plain = np.abs((A @ x).astype(np.float64) - ref).max()
    assert err_comp < 1e-11, err_comp
    assert err_comp < err_plain / 100.0


def test_compensated_cancellation():
    rng = np.random.default_rng(7)
    A = torch.as_tensor(rng.standard_normal((64, 64)), dtype=torch.float32)
    x = torch.as_tensor(rng.standard_normal(64), dtype=torch.float32)
    b = A @ x
    hi, lo = tc.matvec_compensated(A, x)
    rh, e = tc.two_sum(b, -hi)
    r = rh.double().numpy() + (e - lo).double().numpy()
    ref = b.double().numpy() - A.double().numpy() @ x.double().numpy()
    assert np.abs(r - ref).max() < 1e-12


@pytest.mark.parametrize("n", [1, 2, 7, 64, 201])
def test_error_free_ops_match_jax_bitwise(n):
    rng = np.random.default_rng(n)
    a = (rng.standard_normal((5, n)) * 10.0 ** rng.uniform(-3, 3, (5, n))).astype(np.float32)
    b = rng.standard_normal((5, n)).astype(np.float32)
    for fn in ("two_prod", "two_sum", "_split"):
        args = (a,) if fn == "_split" else (a, b)
        j, t = twin(getattr(jc, fn), getattr(tc, fn), *args)
        for x, y in zip(j, t):
            assert np.array_equal(x, y), fn
    # the pairwise tree (odd lengths zero-padded): the value lane is exact
    # and identical; the error lane is an ordinary sum, order-dependent
    (hj, lj), (ht, lt) = twin(jc.sum_compensated, tc.sum_compensated, a)
    assert np.array_equal(hj, ht)
    assert np.abs(lj - lt).max() <= 1e-6 * max(1.0, np.abs(hj).max())
    (hj, lj), (ht, lt) = twin(jc.dot_compensated, tc.dot_compensated, a, b)
    ref = (a.astype(np.float64) * b).sum(-1)
    assert np.abs(ht.astype(np.float64) + lt - ref).max() <= 1e-12 * max(1.0, np.abs(ref).max())
    assert np.abs(hj.astype(np.float64) + lj - (ht.astype(np.float64) + lt)).max() \
        <= 1e-12 * max(1.0, np.abs(ref).max())
