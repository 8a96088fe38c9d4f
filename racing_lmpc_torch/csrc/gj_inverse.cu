// Batched inverse of (G, b, b) f32 matrices by Gauss-Jordan elimination with
// partial pivoting and no row swaps: the Hopper port of the TPU kernel
// racing_lmpc_tpu/ops/pallas_linalg.py::gj_inverse (pallas_call :124, body
// _gj_kernel :94, which runs _gj_inverse_batch / _gj_body, :41-91).
//
// At step k the pivot is the unused row p that maximises |M[p][k]| (score
// |M[i][k]| - used_i * 1e30, first index on a tie, NaN the largest, as
// jnp.argmax and torch.argmax order them); row p is divided by d = M[p][k];
// every other row i subtracts M[i][k] times the scaled pivot row.  The left
// half of the augmented (b, 2b) matrix ends as a permutation P, and
// A^-1 = P^T (right half): row k of the inverse is the right half of the
// row that pivoted at step k, so the product is an exact gather here.
//
// Design (first, simple version):
// - one warp per matrix, b <= 64; lane l owns rows l and l + 32 of the
//   augmented matrix, which lives in shared memory with an odd row stride
//   2b + 1, so that the 32 lanes touching their own rows hit 32 banks;
// - the pivot search is a butterfly warp-shuffle argmax on (score, row);
// - the scaled pivot row goes through shared memory (each lane scales a
//   slice, one __syncwarp), then each lane eliminates its own rows;
// - no block-level barrier: several warps share a block, each on its own
//   matrix, up to 48 KB of shared memory per block.
// Every product and difference is rounded on its own (__fmul_rn,
// __fsub_rn, __fdiv_rn: no FMA contraction, no fast math), so the kernel
// repeats the plain PyTorch version (ops/linalg.py::gj_inverse_plain)
// operation for operation; a zero pivot gives inf/NaN in that matrix only,
// as the IEEE division of the reference does.
//
// Bound on an H100 SXM: the function reads each input once and writes each
// inverse once, 8 G b^2 bytes, and needs 2 b^3 flops per matrix (LAPACK's
// getrf + getri count of an inverse): at (1024, 64, 64) 33.6 MB (10 us at
// 3.35 TB/s) against 537 MFLOP (8 us at 67 TFLOP/s f32), so bytes bound it.
// In this design the b sequential steps of one warp, each a shuffle
// reduction and 2b dependent shared-memory updates per row, set the time.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxB = 64;
constexpr int kMaxWarps = 8;
constexpr size_t kSmemPerBlock = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;

// the argmax order: NaN above everything, then value, ties to the lower row
__device__ __forceinline__ bool better(float a, int ia, float b, int ib)
{
    const bool na = isnan(a), nb = isnan(b);
    if (na != nb) return na;
    if (!na && a != b) return a > b;
    return ia < ib;
}

__host__ __device__ inline size_t warp_bytes(int b)
{
    // augmented matrix (b rows of stride 2b + 1), scaled pivot row, pivots
    return ((size_t)b * (2 * b + 1) + 2 * b) * sizeof(float) + b * sizeof(int);
}

template <int RPL>   // rows per lane: 1 for b <= 32, 2 for b <= 64
__global__ void gj_inverse_kernel(const float* __restrict__ A, float* __restrict__ out,
                                  int* __restrict__ piv_out, int G, int b)
{
    extern __shared__ unsigned char smem[];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = blockIdx.x * (blockDim.x >> 5) + warp;
    if (g >= G) return;   // the whole warp leaves; no block barrier follows

    const int w = 2 * b + 1;
    float* M = reinterpret_cast<float*>(smem + (size_t)warp * warp_bytes(b));
    float* prow = M + b * w;
    int* piv = reinterpret_cast<int*>(prow + 2 * b);
    const size_t base = (size_t)g * b * b;

    for (int e = lane; e < b * b; e += 32) {
        const int i = e / b, j = e - i * b;
        M[i * w + j] = A[base + e];
        M[i * w + b + j] = i == j ? 1.0f : 0.0f;
    }
    __syncwarp();

    bool used[RPL];
#pragma unroll
    for (int r = 0; r < RPL; ++r) used[r] = false;

    for (int k = 0; k < b; ++k) {
        float c[RPL];
        float best = -INFINITY;
        int best_row = 0x7fffffff;
#pragma unroll
        for (int r = 0; r < RPL; ++r) {
            const int i = lane + 32 * r;
            c[r] = 0.0f;
            if (i < b) {
                c[r] = M[i * w + k];
                const float s = __fsub_rn(fabsf(c[r]), used[r] ? 1e30f : 0.0f);
                if (better(s, i, best, best_row)) { best = s; best_row = i; }
            }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float os = __shfl_xor_sync(kFull, best, off);
            const int orow = __shfl_xor_sync(kFull, best_row, off);
            if (better(os, orow, best, best_row)) { best = os; best_row = orow; }
        }
        const int p = best_row;
        const float d = M[p * w + k];
        for (int j = lane; j < 2 * b; j += 32) prow[j] = __fdiv_rn(M[p * w + j], d);
        __syncwarp();
#pragma unroll
        for (int r = 0; r < RPL; ++r) {
            const int i = lane + 32 * r;
            if (i >= b) continue;
            float* row = M + i * w;
            if (i == p) {
                for (int j = 0; j < 2 * b; ++j) row[j] = prow[j];
                used[r] = true;
            } else {
                const float f = c[r];
                for (int j = 0; j < 2 * b; ++j)
                    row[j] = __fsub_rn(row[j], __fmul_rn(f, prow[j]));
            }
        }
        if (lane == 0) piv[k] = p;
        __syncwarp();
    }

    for (int e = lane; e < b * b; e += 32) {
        const int k = e / b, j = e - k * b;
        out[base + e] = M[piv[k] * w + b + j];
    }
    if (piv_out != nullptr)
        for (int k = lane; k < b; k += 32) piv_out[(size_t)g * b + k] = piv[k];
}

}  // namespace

// A, out: (G, b, b) contiguous f32 on the device; piv: (G, b) int32 pivot
// rows (the row that pivoted at step k), or null; stream: a cudaStream_t.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int gj_inverse_f32(const float* A, float* out, int* piv, int G, int b,
                              void* stream)
{
    if (G <= 0 || b <= 0) return 0;
    if (b > kMaxB) return (int)cudaErrorInvalidValue;
    const size_t per_warp = warp_bytes(b);
    int warps = (int)(kSmemPerBlock / per_warp);
    warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
    const int blocks = (G + warps - 1) / warps;
    const size_t smem = per_warp * warps;
    if (b <= 32)
        gj_inverse_kernel<1><<<blocks, 32 * warps, smem, (cudaStream_t)stream>>>(
            A, out, piv, G, b);
    else
        gj_inverse_kernel<2><<<blocks, 32 * warps, smem, (cudaStream_t)stream>>>(
            A, out, piv, G, b);
    return (int)cudaGetLastError();
}
