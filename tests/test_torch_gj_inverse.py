"""The port's Gauss-Jordan inverse (racing_lmpc_torch/ops/linalg.py::
gj_inverse_plain, the CPU path of the ``gj_inverse`` kernel wrapper)
against the JAX package's ``_gj_inverse_batch`` and its Pallas kernel in
interpret mode, on the cases of tests/test_linalg.py:74-90, a batch with
exact |pivot| ties, a singular lane, and sizes past the kernel's register
classes (b = 65, 96 with a singular lane, 130).

Tolerances: the two eliminations do the same f32 operations in the same
order, but XLA:CPU contracts the reference's multiply-subtract into fused
multiply-adds and the port rounds each operation (as its CUDA kernel does),
so they agree to 1e-4 relative to the inverse's scale (4.4e-5 measured on
the random batch); the inverse itself is held to ||A^-1 A - I|| < 2e-4 as the JAX
package's own test holds it.  On the tie batch every operation is exact in
f32 (dyadic entries), so both must pick the same pivots and give the same
bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import hadamard_tie_batch
from racing_lmpc_tpu.ops.pallas_linalg import _gj_body, _gj_inverse_batch, gj_inverse
from racing_lmpc_torch.ops import linalg as tl
from tests._torch_twin import rel_err


def jax_pivots(A: np.ndarray) -> np.ndarray:
    """The reference's pivot rows: column k of the eliminated left half is
    one-hot at the row that pivoted at step k."""
    b = A.shape[-1]
    eye = np.broadcast_to(np.eye(b, dtype=A.dtype), A.shape)
    MI = np.asarray(_gj_body(jnp.asarray(np.concatenate([A, eye], -1)), b))
    return np.argmax(MI[..., :b], axis=1)


def both(A: np.ndarray):
    """(reference pure-JAX, reference Pallas interpret, port plain)."""
    j = np.asarray(_gj_inverse_batch(jnp.asarray(A)))
    ji = np.asarray(gj_inverse(jnp.asarray(A), interpret=True))
    t = tl.gj_inverse_plain(torch.as_tensor(A)).numpy()
    return j, ji, t


def test_needs_pivoting():
    A = np.array([[[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]], np.float32)
    j, ji, t = both(A)
    np.testing.assert_allclose(t[0] @ A[0], np.eye(3), atol=1e-6)
    assert np.array_equal(t, j) and np.array_equal(t, ji)
    _, piv = tl.gj_inverse(torch.as_tensor(A), return_pivots=True)
    assert piv.tolist() == jax_pivots(A).tolist() == [[1, 0, 2]]


def test_random_batch():
    rng = np.random.default_rng(4)
    A = rng.normal(size=(33, 16, 16)).astype(np.float32)
    A += 4 * np.eye(16, dtype=np.float32)
    j, ji, t = both(A)
    err = np.abs(np.einsum("bij,bjk->bik", t, A) - np.eye(16, dtype=np.float32)).max()
    assert err < 2e-4
    assert rel_err(t, j) < 1e-4 and rel_err(t, ji) < 1e-4
    _, piv = tl.gj_inverse(torch.as_tensor(A), return_pivots=True)
    assert np.array_equal(piv.numpy(), jax_pivots(A))


def test_exact_ties_pick_the_same_pivots():
    A = hadamard_tie_batch(np.random.default_rng(11))
    j, ji, t = both(A)
    inv, piv = tl.gj_inverse(torch.as_tensor(A), return_pivots=True)
    assert np.array_equal(piv.numpy(), jax_pivots(A))
    # the first step of a Hadamard block ties on every row: the lowest wins
    assert (piv[:, 0] == 0).all()
    assert np.array_equal(t, j) and np.array_equal(t, ji) and np.array_equal(inv.numpy(), t)
    np.testing.assert_array_equal(np.einsum("bij,bjk->bik", t, A),
                                  np.broadcast_to(np.eye(16), A.shape))


def test_singular_lane_stays_in_its_lane():
    rng = np.random.default_rng(5)
    A = rng.normal(size=(6, 8, 8)).astype(np.float32) + 3 * np.eye(8, dtype=np.float32)
    A[2] = 0.0                      # a zero pivot at the first step
    A[4, :, 3] = A[4, :, 1]         # rank-deficient
    j, _, t = both(A)
    bad = ~np.isfinite(t).reshape(6, -1).all(-1)
    assert bad.tolist() == (~np.isfinite(j).reshape(6, -1).all(-1)).tolist()
    assert bad[2]
    keep = [0, 1, 3, 5]
    assert rel_err(t[keep], j[keep]) < 1e-4


@pytest.mark.parametrize("b", [65, 96, 130])
def test_past_the_register_classes(b):
    # b > 64, where the kernel's wide variants run the plain version's
    # steps on the whole augmented matrix (in shared memory to b = 168, in
    # device memory above), so no other mirror is needed; at b = 96 one
    # lane is singular
    rng = np.random.default_rng(600 + b)
    A = (rng.normal(size=(3, b, b)) + 2 * np.sqrt(b) * np.eye(b)).astype(np.float32)
    if b == 96:
        A[1] = 0.0
    j, ji, t = both(A)
    bad = ~np.isfinite(t).reshape(3, -1).all(-1)
    assert bad.tolist() == [b == 96 and g == 1 for g in range(3)]
    assert bad.tolist() == (~np.isfinite(j).reshape(3, -1).all(-1)).tolist()
    assert bad.tolist() == (~np.isfinite(ji).reshape(3, -1).all(-1)).tolist()
    keep = ~bad
    assert rel_err(t[keep], j[keep]) < 1e-4 and rel_err(t[keep], ji[keep]) < 1e-4
    err = np.abs(np.einsum("bij,bjk->bik", t[keep], A[keep]) - np.eye(b, dtype=np.float32)).max()
    assert err < 2e-4
    _, piv = tl.gj_inverse(torch.as_tensor(A), return_pivots=True)
    assert np.array_equal(piv.numpy()[keep], jax_pivots(A)[keep])


def test_cpu_path_launches_no_kernel_and_checks_its_input():
    tl.gj_inverse.launches = 0
    A = torch.eye(5).expand(4, 5, 5).contiguous()
    assert torch.equal(tl.gj_inverse(A), A)
    assert tl.gj_inverse.launches == 0
    with pytest.raises(TypeError):
        tl.gj_inverse(A.double())
    with pytest.raises(ValueError):
        tl.gj_inverse(torch.zeros(2, 3, 4))
