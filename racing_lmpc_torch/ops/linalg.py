"""Small dense linear algebra of the QP solver, and the Cholesky-inverse kernel.

Port of ``racing_lmpc_tpu/ops/pallas_linalg.py``:

- the plain versions — ``_chol_small``, ``_tri_inv_small``, the blocked
  ``chol_lower`` / ``tri_inv_lower`` (block 32, identity padding,
  ``:149-302``) and the closed-form ``inv_small`` / ``solve_small``
  (``:394-425``) — op for op in PyTorch;
- ``chol_tri_inv``, the wrapper of the hand-written Hopper kernel
  ``csrc/chol_tri_inv.cu`` that replaces the TPU kernel
  ``chol_tri_inv_fused`` (``:312-368``).  On a CPU tensor it runs the plain
  version ``tri_inv_lower(chol_lower(H))``; on a CUDA tensor it launches the
  kernel or raises.  See the kernel source for what bounds it;
- ``gj_inverse``, the wrapper of ``csrc/gj_inverse.cu``, which replaces the
  TPU kernel ``gj_inverse`` (``:98-136``): a batched Gauss-Jordan inverse
  with swap-free partial pivoting, and its plain version
  ``gj_inverse_plain``.  Like the reference, nothing on a solve path calls
  it.

No library factorization (``torch.linalg``) is called here.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch import Tensor

from racing_lmpc_torch.ops import _kernels

# dynamic shared memory one block can hold on Hopper (227 KB)
_SMEM_MAX = 232448


def _chol_small(S: Tensor) -> Tensor:
    """Unrolled column Cholesky of a small SPD batch (..., b, b), b <= ~32.

    Indefinite inputs produce NaN via sqrt(negative), which the IPM's
    step_ok guard relies on.
    """
    b = S.shape[-1]
    iota = torch.arange(b, device=S.device)
    cols = []
    M = S
    for j in range(b):
        d = torch.sqrt(M[..., j, j])                     # NaN if not PD
        lj = M[..., :, j] / d[..., None]
        lj = torch.where(iota >= j, lj, 0.0)             # (..., b)
        cols.append(lj)
        M = M - lj[..., :, None] * lj[..., None, :]
    return torch.stack(cols, dim=-1)


def _tri_inv_small(L: Tensor) -> Tensor:
    """Unrolled forward-substitution inverse of small lower-triangular
    (..., b, b) batches (the blocked inverse's base case)."""
    b = L.shape[-1]
    zero = torch.zeros_like(L[..., 0, :])
    iota = torch.arange(b, device=L.device)
    rows: list = []
    for i in range(b):
        # rows >= i of the restacked X are zero, so the product only sees k < i
        if i:
            X = torch.stack(rows + [zero] * (b - i), dim=-2)
            acc = torch.matmul(L[..., i:i + 1, :], X)[..., 0, :]
        else:
            acc = zero
        e_i = (iota == i).to(L.dtype)
        rows.append((e_i - acc) / L[..., i, i][..., None])
    return torch.stack(rows, dim=-2)


def _pad_identity(M: Tensor, block: int) -> Tensor:
    """Embed (..., n, n) in the leading block of (..., npad, npad), npad a
    multiple of ``block``, with an identity tail (keeps SPD / triangular)."""
    n = M.shape[-1]
    pad = (-n) % block
    if not pad:
        return M
    out = torch.zeros(M.shape[:-2] + (n + pad, n + pad), dtype=M.dtype,
                      device=M.device)
    out[..., :n, :n] = M
    out[..., n:, n:] = torch.eye(pad, dtype=M.dtype, device=M.device)
    return out


def _assemble(blocks, nb: int, n: int, like: Tensor, block: int) -> Tensor:
    zero = torch.zeros(like.shape[:-2] + (block, block), dtype=like.dtype,
                       device=like.device)
    rows = [torch.cat([blocks[i][j] if j <= i else zero for j in range(nb)],
                      dim=-1) for i in range(nb)]
    return torch.cat(rows, dim=-2)[..., :n, :n]


def chol_lower(H: Tensor, block: int = 32) -> Tensor:
    """Blocked right-looking Cholesky of SPD batches (..., n, n) -> lower L.

    Diagonal blocks factorize with the unrolled ``_chol_small``; panels and
    Schur updates are batched f32 matmuls (full precision, see the package's
    numerics policy).
    """
    n = H.shape[-1]
    Hp = _pad_identity(H, block)
    nb = Hp.shape[-1] // block

    def blk(i, j):
        return Hp[..., i * block:(i + 1) * block, j * block:(j + 1) * block]

    Lb = [[None] * nb for _ in range(nb)]
    Dinv_T = [None] * nb
    for k in range(nb):
        S = blk(k, k)
        for j in range(k):
            S = S - torch.matmul(Lb[k][j], Lb[k][j].transpose(-1, -2))
        Lkk = _chol_small(S)
        Lb[k][k] = Lkk
        if k + 1 < nb:
            Dinv_T[k] = _tri_inv_small(Lkk).transpose(-1, -2)
        for i in range(k + 1, nb):
            P = blk(i, k)
            for j in range(k):
                P = P - torch.matmul(Lb[i][j], Lb[k][j].transpose(-1, -2))
            Lb[i][k] = torch.matmul(P, Dinv_T[k])
    return _assemble(Lb, nb, n, H, block)


def tri_inv_lower(L: Tensor, block: int = 32) -> Tensor:
    """Explicit inverse of a lower-triangular matrix by blocked substitution.

    Works on (..., n, n); zero-fills the strictly-upper part of the result.
    """
    n = L.shape[-1]
    Lp = _pad_identity(L, block)
    nb = Lp.shape[-1] // block

    def blk(i, j):
        return Lp[..., i * block:(i + 1) * block, j * block:(j + 1) * block]

    Dinv = [_tri_inv_small(blk(i, i)) for i in range(nb)]
    # block-column forward substitution: X_ij = -Dinv_i sum_k L_ik X_kj
    X = [[None] * nb for _ in range(nb)]
    for j in range(nb):
        X[j][j] = Dinv[j]
        for i in range(j + 1, nb):
            acc = torch.matmul(blk(i, j), X[j][j])
            for k in range(j + 1, i):
                acc = acc + torch.matmul(blk(i, k), X[k][j])
            X[i][j] = -torch.matmul(Dinv[i], acc)
    return _assemble(X, nb, n, L, block)


def chol_tri_inv_plain(H: Tensor) -> Tensor:
    """The plain PyTorch version of the kernel: ``L^-1`` for ``L = chol(H)``."""
    return tri_inv_lower(chol_lower(H))


@functools.cache
def _kernel_fn():
    fn = _kernels.load("chol_tri_inv").chol_tri_inv_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def chol_tri_inv(H: Tensor) -> Tensor:
    """``L^-1`` for ``L = chol(H)`` over a batch of SPD matrices (..., n, n).

    The strictly upper part of the result is zero.  A matrix that is not
    positive definite gives NaN (in that matrix only).  A CPU tensor takes
    the plain version; a CUDA tensor launches the hand-written kernel
    (``csrc/chol_tri_inv.cu``) or raises — there is no fall back.
    ``chol_tri_inv.launches`` counts the kernel launches.

    The kernel replaces the TPU kernel ``chol_tri_inv_fused``
    (``racing_lmpc_tpu/ops/pallas_linalg.py:312-368``).  On an H100 at the
    main path's (256, 87, 87) it must move 11.7 MB (the lower triangle of
    each symmetric input read once, each dense output written once: 3.5 us
    at 3.35 TB/s) against 112 MFLOP of f32
    (n^3/3 for the factor and n^3/3 for the inverse: 1.7 us at 67 TFLOP/s),
    so bytes bound it; in this first design the n sequential column steps,
    not the bytes, set its time.
    """
    if H.dtype != torch.float32:
        raise TypeError(f"chol_tri_inv takes float32, got {H.dtype}")
    if H.dim() < 2 or H.shape[-1] != H.shape[-2]:
        raise ValueError(f"chol_tri_inv takes (..., n, n), got {tuple(H.shape)}")
    if not H.is_contiguous():
        raise ValueError("chol_tri_inv takes a contiguous tensor")
    if H.device.type == "cpu":
        return chol_tri_inv_plain(H)
    if H.device.type != "cuda":
        raise ValueError(f"chol_tri_inv runs on cpu or cuda, not {H.device}")
    n = H.shape[-1]
    smem = (n * n + n) * 4
    if smem > _SMEM_MAX:
        raise ValueError(f"chol_tri_inv: n={n} needs {smem} B of shared "
                         f"memory, more than the {_SMEM_MAX} B one block has")
    G = H.numel() // (n * n) if n else 0
    out = torch.empty_like(H)
    if G == 0 or n == 0:
        return out
    with torch.cuda.device(H.device):
        err = _kernel_fn()(H.data_ptr(), out.data_ptr(), G, n,
                           torch.cuda.current_stream(H.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"chol_tri_inv kernel launch failed: CUDA error {err}")
    chol_tri_inv.launches += 1
    return out


chol_tri_inv.launches = 0


def _gj_eliminate(A: Tensor) -> tuple[Tensor, Tensor]:
    """Swap-free pivoted Gauss-Jordan on a batch (G, b, b), step for step as
    the reference's ``_gj_body`` (``pallas_linalg.py:41-75``).  Returns the
    eliminated augmented matrix (G, b, 2b), whose left half is a permutation
    matrix, and the row that pivoted at each step (G, b)."""
    G, b, _ = A.shape
    eye = torch.eye(b, dtype=A.dtype, device=A.device).expand(G, b, b)
    MI = torch.cat([A, eye], dim=-1)
    rows = torch.arange(b, device=A.device)
    used = torch.zeros((G, b), dtype=A.dtype, device=A.device)
    pivots = []
    for k in range(b):
        col = MI[:, :, k]
        score = col.abs() - used * 1e30
        # the first maximal index (NaN counts as the largest), as
        # jnp.argmax picks it: ties go to the lowest row
        p = torch.argmax(score, dim=-1)
        d = col.gather(1, p[:, None])
        prow = MI.gather(1, p[:, None, None].expand(G, 1, 2 * b))[:, 0] / d
        oh = rows == p[:, None]
        f = torch.where(oh, 0.0, col)
        MI = torch.where(oh[..., None], prow[:, None, :],
                         MI - f[..., None] * prow[:, None, :])
        used = used + oh
        pivots.append(p)
    return MI, torch.stack(pivots, dim=-1)


def gj_inverse_plain(A: Tensor, return_pivots: bool = False):
    """The plain PyTorch version of the kernel: ``A^-1`` of (..., b, b) by
    the reference's swap-free pivoted Gauss-Jordan (and, if asked, the row
    that pivoted at each step, (..., b) int64)."""
    b = A.shape[-1]
    MI, piv = _gj_eliminate(A.reshape(-1, b, b))
    # A^-1 = P^T (right half): row k is the right half of the row that
    # pivoted at step k (the reference's product with the one-hot P, exact)
    inv = MI[:, :, b:].gather(1, piv[..., None].expand(-1, b, b)).reshape(A.shape)
    return (inv, piv.reshape(A.shape[:-1])) if return_pivots else inv


@functools.cache
def _gj_kernel_fn():
    fn = _kernels.load("gj_inverse").gj_inverse_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


GJ_MAX_B = 64


def gj_inverse(A: Tensor, return_pivots: bool = False):
    """Batched inverse (..., b, b) -> (..., b, b) by Gauss-Jordan with
    partial pivoting and no row swaps, as the reference's ``gj_inverse``
    (``racing_lmpc_tpu/ops/pallas_linalg.py:98-136``).  With
    ``return_pivots`` it also returns the row that pivoted at each step
    (..., b), int64.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    hand-written kernel (``csrc/gj_inverse.cu``, b <= 64) or raises — there
    is no fall back.  A zero pivot gives inf or NaN in that matrix only.
    ``gj_inverse.launches`` counts the kernel launches.  On an H100 the
    function must move 8 b^2 bytes and do 2 b^3 flops per matrix, so bytes
    bound it; see the kernel source for what sets its time.
    """
    if A.dtype != torch.float32:
        raise TypeError(f"gj_inverse takes float32, got {A.dtype}")
    if A.dim() < 2 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"gj_inverse takes (..., b, b), got {tuple(A.shape)}")
    if not A.is_contiguous():
        raise ValueError("gj_inverse takes a contiguous tensor")
    if A.device.type == "cpu":
        return gj_inverse_plain(A, return_pivots)
    if A.device.type != "cuda":
        raise ValueError(f"gj_inverse runs on cpu or cuda, not {A.device}")
    b = A.shape[-1]
    if b > GJ_MAX_B:
        raise ValueError(f"gj_inverse: the kernel takes b <= {GJ_MAX_B}, got {b}")
    G = A.numel() // (b * b) if b else 0
    inv = torch.empty_like(A)
    piv = torch.empty(A.shape[:-1], dtype=torch.int32, device=A.device)
    if G:
        with torch.cuda.device(A.device):
            err = _gj_kernel_fn()(
                A.data_ptr(), inv.data_ptr(),
                piv.data_ptr() if return_pivots else None, G, b,
                torch.cuda.current_stream(A.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"gj_inverse kernel launch failed: CUDA error {err}")
        gj_inverse.launches += 1
    return (inv, piv.long()) if return_pivots else inv


gj_inverse.launches = 0


def inv_small(M: Tensor) -> Tensor:
    """Closed-form inverse for tiny trailing dims (1/2/3): adjugate over
    determinant.  Larger sizes are not on any path of the port and raise."""
    k = M.shape[-1]
    if k == 1:
        return 1.0 / M
    if k == 2:
        a, b = M[..., 0, 0], M[..., 0, 1]
        c, d = M[..., 1, 0], M[..., 1, 1]
        det = a * d - b * c
        adj = torch.stack([torch.stack([d, -b], -1),
                           torch.stack([-c, a], -1)], -2)
        return adj / det[..., None, None]
    if k == 3:
        m = [[M[..., i, j] for j in range(3)] for i in range(3)]
        cof = [[m[(i+1) % 3][(j+1) % 3] * m[(i+2) % 3][(j+2) % 3]
                - m[(i+1) % 3][(j+2) % 3] * m[(i+2) % 3][(j+1) % 3]
                for j in range(3)] for i in range(3)]
        det = sum(m[0][j] * cof[0][j] for j in range(3))
        adj = torch.stack([torch.stack([cof[j][i] for j in range(3)], -1)
                           for i in range(3)], -2)
        return adj / det[..., None, None]
    raise ValueError(f"inv_small takes trailing size 1, 2 or 3, got {k}")


def solve_small(M: Tensor, X: Tensor) -> Tensor:
    """``M^-1 X`` through ``inv_small``."""
    return torch.matmul(inv_small(M), X)
