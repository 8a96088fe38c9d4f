// L^-1 for L = chol(H), over a batch of symmetric positive-definite f32
// matrices: the Hopper port of the TPU kernel
// racing_lmpc_tpu/ops/pallas_linalg.py::chol_tri_inv_fused (kernel body
// _chol_tri_inv_kernel, :305-309, which is tri_inv_lower(chol_lower(.))).
// The IPM factors its Newton-KKT matrix H and the Schur block with it at
// every iteration (racing_lmpc_tpu/mpc/ipm.py:214-218 and :231).
//
// Design (first, simple version):
// - one thread block per matrix; the matrix is loaded once, at its true n,
//   into dynamic shared memory (no identity padding on the card), factored
//   and inverted in place, and written back once;
// - Cholesky: right-looking, one column per step, one __syncthreads()
//   between steps.  Step j reads column j unscaled and applies the rank-1
//   update A[i][k] -= (A[i][j]/d)(A[k][j]/d), k > j, to the trailing lower
//   triangle; the scaling of column j itself (and its diagonal d) is written
//   in step j+1, when nothing reads column j any more, from the d each
//   thread kept in a register;
// - triangular inverse: column c of X = L^-1 is an independent forward
//   substitution L x = e_c, so thread c solves it alone with no barrier,
//   keeping x_i (i > c) in the unused strictly-upper row c of the shared
//   matrix and x_c in a separate diagonal vector;
// - the output is written with its strictly upper part zero.
// A non-positive pivot gives NaN through sqrtf, which spreads through that
// matrix's remaining columns and into its inverse — as in the plain version,
// whose NaN the IPM's step_ok guard relies on (ipm.py:434-444).  Nothing
// traps or exits early, and no other matrix is touched.
//
// Bound on an H100 SXM at the main path's shape (256, 87, 87): the lower
// triangle of each symmetric input is read once and the dense output written
// once, 256 * (87*88/2 + 87^2) * 4 B = 11.7 MB, 3.5 us at 3.35 TB/s; the
// arithmetic is n^3/3 flops for the factor and n^3/3 for the
// inverse (LAPACK's potrf + trtri counts), 256 * 2/3 * 87^3 = 112 MFLOP,
// 1.7 us at 67 TFLOP/s of f32 outside the tensor cores.  So the bound is
// bytes.  In this first design neither sets the time: the n sequential
// column steps of the factor and the n-long serial chain of thread 0's
// substitution do, with one block per matrix and most threads idle late in
// each step.  Making it fast is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
chol_tri_inv_kernel(const float* __restrict__ H, float* __restrict__ out, int n)
{
    extern __shared__ float sm[];
    float* A = sm;           // n * n, row-major; lower triangle holds L
    float* xd = sm + n * n;  // diagonal of L^-1
    const int nn = n * n;
    const size_t base = (size_t)blockIdx.x * (size_t)nn;
    const int tid = threadIdx.x;

    // only the lower triangle is read: the factor touches A[i][k] for k <= i
    // alone, and the inverse writes the strictly upper part before reading it
    for (int e = tid; e < nn; e += kThreads) {
        const int i = e / n;
        if (e - i * n <= i) A[e] = H[base + e];
    }
    __syncthreads();

    // ---- Cholesky, right-looking, one barrier per column ----------------
    float dprev = 0.0f;
    for (int j = 0; j <= n; ++j) {
        if (j > 0) {
            // finish column j - 1: nothing reads it in this step
            const int c = j - 1;
            for (int i = c + 1 + tid; i < n; i += kThreads)
                A[i * n + c] = A[i * n + c] / dprev;
            if (tid == 0) A[c * n + c] = dprev;
        }
        if (j < n) {
            const float d = sqrtf(A[j * n + j]);   // NaN if not PD
            const int m = n - j - 1;
            for (int e = tid; e < m * m; e += kThreads) {
                const int i = j + 1 + e / m;
                const int k = j + 1 + e % m;
                if (k <= i) {
                    const float li = A[i * n + j] / d;
                    const float lk = A[k * n + j] / d;
                    A[i * n + k] = A[i * n + k] - li * lk;
                }
            }
            dprev = d;
        }
        __syncthreads();
    }

    // ---- L^-1: one independent forward substitution per column ----------
    for (int c = tid; c < n; c += kThreads) {
        const float xc = 1.0f / A[c * n + c];
        xd[c] = xc;
        float* xrow = A + c * n;   // x_i for i > c, strictly upper row c
        for (int i = c + 1; i < n; ++i) {
            const float* li = A + i * n;
            float acc = li[c] * xc;
            for (int k = c + 1; k < i; ++k) acc += li[k] * xrow[k];
            xrow[i] = -acc / li[i];
        }
    }
    __syncthreads();

    float* O = out + base;
    for (int e = tid; e < nn; e += kThreads) {
        const int i = e / n;
        const int c = e - i * n;
        O[e] = c < i ? A[c * n + i] : (c == i ? xd[i] : 0.0f);
    }
}

}  // namespace

// H, out: (G, n, n) contiguous f32 on the device; stream: a cudaStream_t.
// Returns cudaGetLastError() after the launch (0 on success), so that a
// launch refused for its shared memory is reported, not silent.
extern "C" int chol_tri_inv_f32(const float* H, float* out, int G, int n,
                                void* stream)
{
    if (G <= 0 || n <= 0) return 0;
    const size_t smem = ((size_t)n * n + n) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        chol_tri_inv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    chol_tri_inv_kernel<<<G, kThreads, smem, (cudaStream_t)stream>>>(H, out, n);
    return (int)cudaGetLastError();
}
