// Batched inverse of (G, b, b) f32 matrices by Gauss-Jordan elimination with
// partial pivoting and no row swaps: the Hopper port of the TPU kernel
// racing_lmpc_tpu/ops/pallas_linalg.py::gj_inverse (pallas_call :124, body
// _gj_kernel :94, which runs _gj_inverse_batch / _gj_body, :41-91).
//
// What it computes.  At step k the pivot is the row p with the largest
// score |M[i][k]| - used_i * 1e30 (NaN above every number, the lower row on
// a tie, as jnp.argmax and torch.argmax order them); row p is divided by
// d = M[p][k], once per element; every other row i subtracts f * prow with
// f = M[i][k] read before the step; row p becomes prow.  The left half of
// the augmented (b, 2b) matrix ends as a permutation P and
// A^-1 = P^T (right half): row k of the inverse is the right half of the
// row that pivoted at step k, an exact gather.  Every product, difference
// and quotient is rounded on its own (__fmul_rn, __fsub_rn, __fdiv_rn: no
// FMA contraction, no fast math), so the kernel repeats the plain PyTorch
// version (ops/linalg.py::gj_inverse_plain) bit for bit; a zero pivot gives
// inf/NaN in that matrix only, as the IEEE division of the reference does.
//
// What bounds it on an H100 SXM.  The function reads each input once and
// writes each inverse once, 8 G b^2 bytes: 0.0401 ms at (65536, 16, 16),
// 0.0100 ms at (4096, 32, 32) and at (1024, 64, 64), at 3.35 TB/s.  The
// bit-exact algorithm itself needs 4 b^3 separately rounded multiplies and
// subtracts (b steps, b rows, 2b columns; they cannot pair into FMAs) and
// 2 b^2 IEEE divisions (about 8 instructions each) a matrix: 0.040, 0.018
// and 0.034 ms at those shapes at 33.5 T f32 instructions/s (132 SMs x 128
// lanes x 1.98 GHz), so at b = 32 and 64 the instructions, not the bytes,
// set its floor.
//
// Design, against what held the first (one warp a matrix, shared-memory)
// version back:
// 1. Idle lanes (one lane a row, half the warp idle at b = 16): size
//    classes B = 16, 32, 64 (b <= B), templated, each filling its warps.  A
//    row group of T threads owns each row of the augmented matrix, each
//    thread a chunk of C = 2B/T columns: b <= 16 two threads a row, one warp
//    a matrix; b <= 32 one thread a row, one warp a matrix; b <= 64 two
//    threads a row, four warps (one block) a matrix.  Classes 16 and 32
//    put four matrices, one a warp, in a block and need no block barrier.
//    Rows above b are masked out of the argmax (key 0, below every real
//    score), never padded with an identity: a padded row would turn NaN at
//    a zero pivot and win the argmax.  Exactly b steps run.
// 2. Shared-memory read-modify-write of every element: the matrix lives in
//    registers, and the step loop is fully unrolled so that every register
//    index is static; an element update is one __fmul_rn and one __fsub_rn
//    on registers, with the scaled pivot row read from shared memory by
//    16-byte broadcast loads.
// 3. One warp a block at b = 64: a block is 128 threads holding one
//    64 x 128 matrix in registers (128 a thread; the launch bound asks for
//    four blocks an SM), so four matrices share an SM and (1024, 64, 64)
//    runs in two waves.  The register file (64 K words) holds at most about
//    seven such matrices, so one wave would need part of each in shared
//    memory; not done.
// 4. The chain of each step: the owner of column k hands f = M[i][k] to its
//    row group with one shuffle (none at T = 1); the argmax is one
//    __reduce_max_sync on a 32-bit key that orders the scores as floats
//    with NaN on top, and a ballot picks the lowest row holding the maximum;
//    across the warps of a b <= 64 matrix, one 64-bit (key, ~row) slot a
//    warp in shared memory and one barrier.  The pivot row's warp publishes
//    the pivot row: its T threads store their chunks to shared memory
//    (16-byte stores) and every lane of that warp divides 2B/32 of its
//    elements by d, once each, in place (div_rn keeps the many zero
//    dividends off the division's slow path); then a second barrier, or a
//    __syncwarp in the one-warp classes, and every row updates.  The chunks
//    lie C + 4 floats apart so that the row groups' loads fall on
//    different banks.
// 5. Scalar global I/O with an integer division by b per element: each row
//    chunk is read with 16-byte loads straight into its owner's registers
//    (when b % 4 == 0 and the tensors are 16-byte aligned; element by
//    element otherwise), the identity half is made in registers, and each
//    row group remembers the steps at which it pivoted and writes its right
//    half to out[g][step] with 16-byte stores, and piv_out[g][step] = row.
//    No integer division by b, no gather through shared memory.
// Shared memory is under 2 KB a block, static; no attribute is set at a
// launch.
//
// Wide variants, b > 64 (the JAX function takes any b; none of the
// repo's paths calls it).  The matrix no longer fits in registers, so one
// block a matrix keeps the whole augmented matrix (b rows of 2b columns,
// rows 16-byte aligned at wide_ld(b) floats) in memory and runs the same
// steps with three barriers a step:
//   A  each thread takes its rows (i = tid, tid + T, ...) in ascending
//      order: it reads f_i = M[i][k] into f (so f is read before the step
//      writes any entry), forms the score as above and keeps its best key,
//      the lower row on a tie; then in each warp __reduce_max_sync of the
//      keys and __reduce_min_sync of the rows holding the maximum, one
//      64-bit (key, ~row) slot a warp; a barrier; every thread takes the
//      largest slot, so NaN wins, then the larger score, then the lower row;
//   B  every thread divides its columns of the pivot row by d = f_p into
//      prow (div_rn) and records p; a barrier;
//   C  each warp takes its rows, 16-byte loads and stores along the row:
//      row p becomes prow, every other row M[i][c] - f_i prow[c], the
//      product and the difference rounded on their own; a barrier.
// Every entry of the augmented matrix is kept and updated, so an inf or
// NaN f leaves the plain version's NaN in the identity half too.  At the
// end row k of the inverse is the right half of the row that pivoted at
// step k, gathered with coalesced stores.
//   Shared memory, 64 < b <= kSmemMaxB (168): the augmented matrix, prow,
//     f, the pivots and the used flags in dynamic shared memory, 8 b^2
//     bytes and a little more (229,408 B at b = 168 under the 232,448 B a
//     block may take; gj_inverse_prepare() grants it once a device), 512
//     threads.  A step moves the matrix through shared memory once (a
//     load and a store an entry), so shared-memory bandwidth, at one block
//     an SM above b = 119, bounds it.
//   Device memory, b > kSmemMaxB: all of it in a workspace of
//     gj_inverse_workspace_floats(b) floats a matrix that the wrapper
//     allocates from PyTorch's allocator on the launch's stream, 64-bit
//     offsets throughout, 1024 threads.  A step reads and writes the
//     matrix once (8 b^2 bytes): at small G one SM's share of the L2 and
//     memory bandwidth bounds it, far above the card's.  A cluster of
//     blocks a matrix would spread a step over several SMs; not done.
// Both are one kernel template; the size classes above are untouched.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRegMaxB = 64;         // the register classes' largest b
constexpr int kSmemMaxB = 168;       // the wide variant's matrix in shared memory
constexpr int kSmemOptin = 232448;   // the shared memory a block may take

// threads a row (T), warps a matrix (WPM), matrices a block (MPB)
template <int B> struct Class;
template <> struct Class<16> { static constexpr int T = 2, WPM = 1, MPB = 4; };
template <> struct Class<32> { static constexpr int T = 1, WPM = 1, MPB = 4; };
template <> struct Class<64> { static constexpr int T = 2, WPM = 4, MPB = 1; };

// a 32-bit key that orders scores as the argmax does: NaN above all, then
// by value (-0 ties +0)
__device__ __forceinline__ unsigned order_key(float s)
{
    if (isnan(s)) return 0xffffffffu;
    unsigned u = __float_as_uint(s);
    if (u == 0x80000000u) u = 0u;
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// x / d as IEEE division rounds it (__fdiv_rn), with a zero dividend kept
// off the division's slow path, where its range check sends it; the
// augmented pivot row is about half zeros.  0 / d is a zero with the sign
// of x times the sign of d, and NaN for d = 0 or NaN.
__device__ __forceinline__ float div_rn(float x, float d)
{
    if (x != 0.0f) return __fdiv_rn(x, d);
    if (!(fabsf(d) > 0.0f)) return __int_as_float(0x7fffffff);
    return __int_as_float((__float_as_int(x) ^ __float_as_int(d)) & 0x80000000);
}

template <int B>
__global__ void __launch_bounds__(32 * Class<B>::WPM * Class<B>::MPB, 4)
gj_inverse_kernel(const float* __restrict__ A, float* __restrict__ out,
                  int* __restrict__ piv_out, int G, int b, bool vec)
{
    constexpr int T = Class<B>::T, WPM = Class<B>::WPM, MPB = Class<B>::MPB;
    constexpr int C = 2 * B / T;      // columns a thread holds
    constexpr int RPW = 32 / T;       // rows a warp holds
    constexpr int CS = C + 4;         // chunk stride of the scaled row in shared memory
    constexpr int EPL = 2 * B / 32;   // pivot-row elements each lane of its warp divides
    static_assert(RPW * WPM == B && C % 4 == 0 && C % EPL == 0, "class layout");
    static_assert(WPM == 1 || MPB == 1, "a block barrier needs one matrix a block");

    __shared__ __align__(16) float prow_s[MPB][T * CS];
    __shared__ unsigned long long slot_s[MPB][WPM];

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int m = warp / WPM;         // matrix within the block
    const int wm = warp % WPM;        // warp within the matrix
    const int g = blockIdx.x * MPB + m;
    if (g >= G) return;   // only where a warp is a whole matrix
    const int i = wm * RPW + lane / T;   // row
    const int q = lane % T;              // chunk: storage columns [q C, q C + C)
    const bool real = i < b;
    float* prow = prow_s[m];

    // storage column s < B is column s of A, s >= B column s - B of I
    float v[C];
    const float* a = A + (size_t)g * b * b + (size_t)i * b;   // row i of matrix g
#pragma unroll
    for (int r = 0; r < C; r += 4) {
        const int s = q * C + r;
        if (s < B) {
            if (vec) {
                float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                if (real && s < b)
                    x = *reinterpret_cast<const float4*>(a + s);
                v[r] = x.x; v[r + 1] = x.y; v[r + 2] = x.z; v[r + 3] = x.w;
            } else {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    v[r + e] = (real && s + e < b) ? a[s + e] : 0.0f;
            }
        } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) v[r + e] = (s + e - B == i) ? 1.0f : 0.0f;
        }
    }

    bool used = false;
    unsigned long long steps = 0;     // the steps at which this row pivoted
#pragma unroll
    for (int k = 0; k < B; ++k) {
        if (k >= b) break;
        // f of this row (column k, owned by chunk k / C of the row group)
        const float c = T == 1 ? v[k] : __shfl_sync(kFull, v[k % C], k / C, T);
        const float score = __fsub_rn(fabsf(c), used ? 1e30f : 0.0f);
        const unsigned key = real ? order_key(score) : 0u;
        const unsigned kmax = __reduce_max_sync(kFull, key);
        int p = wm * RPW + (__ffs(__ballot_sync(kFull, key == kmax)) - 1) / T;
        if (WPM > 1) {
            if (lane == 0)
                slot_s[m][wm] = ((unsigned long long)kmax << 32) | (0xffffffffu - (unsigned)p);
            __syncthreads();
            unsigned long long best = slot_s[m][0];
#pragma unroll
            for (int w = 1; w < WPM; ++w) best = best > slot_s[m][w] ? best : slot_s[m][w];
            p = (int)(0xffffffffu - (unsigned)best);
        } else {
            __syncwarp();   // the last step's reads of prow are done
        }
        if (p / RPW == wm) {   // the pivot row's warp scales the pivot row
            if (i == p) {
#pragma unroll
                for (int r = 0; r < C; r += 4)
                    *reinterpret_cast<float4*>(prow + q * CS + r) =
                        make_float4(v[r], v[r + 1], v[r + 2], v[r + 3]);
            }
            const float d = __shfl_sync(kFull, c, (p % RPW) * T);
            __syncwarp();
            const int s0 = lane * EPL;
            float* e = prow + (s0 / C) * CS + s0 % C;
#pragma unroll
            for (int t = 0; t < EPL; ++t) e[t] = div_rn(e[t], d);
        }
        if (WPM > 1) __syncthreads(); else __syncwarp();
        const float* pr = prow + q * CS;
        if (i == p) {
#pragma unroll
            for (int r = 0; r < C; r += 4) {
                const float4 x = *reinterpret_cast<const float4*>(pr + r);
                v[r] = x.x; v[r + 1] = x.y; v[r + 2] = x.z; v[r + 3] = x.w;
            }
            used = true;
            steps |= 1ull << k;
        } else {
#pragma unroll
            for (int r = 0; r < C; r += 4) {
                const float4 x = *reinterpret_cast<const float4*>(pr + r);
                v[r] = __fsub_rn(v[r], __fmul_rn(c, x.x));
                v[r + 1] = __fsub_rn(v[r + 1], __fmul_rn(c, x.y));
                v[r + 2] = __fsub_rn(v[r + 2], __fmul_rn(c, x.z));
                v[r + 3] = __fsub_rn(v[r + 3], __fmul_rn(c, x.w));
            }
        }
    }

    // row k of the inverse is the right half of the row that pivoted at step
    // k (a row can pivot again only once its column turned inf or NaN)
    if (!real) return;
    while (steps) {
        const int k = __ffsll((long long)steps) - 1;
        steps &= steps - 1;
        float* o = out + ((size_t)g * b + k) * b;
#pragma unroll
        for (int r = 0; r < C; r += 4) {
            const int col = q * C + r - B;
            if (col < 0) continue;
            if (vec) {
                if (col < b)
                    *reinterpret_cast<float4*>(o + col) =
                        make_float4(v[r], v[r + 1], v[r + 2], v[r + 3]);
            } else {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (col + e < b) o[col + e] = v[r + e];
            }
        }
        if (piv_out != nullptr && q == 0) piv_out[(size_t)g * b + k] = i;
    }
}

// The wide variants' row stride: 2b columns rounded up to 16 bytes
__host__ __device__ constexpr int wide_ld(int b) { return (2 * b + 3) & ~3; }

// Floats a matrix takes beside the augmented matrix: prow (wide_ld), f, the
// pivots and the used flags (b each), rounded up to 16 bytes
__host__ __device__ constexpr size_t wide_extra(int b)
{
    return (size_t)wide_ld(b) + (((size_t)3 * b + 3) & ~(size_t)3);
}

// The 64-bit (key, ~row) slots of the argmax, one a warp, at most 32 warps
constexpr int kSlotBytes = 32 * 8;

__host__ __device__ constexpr size_t wide_smem_bytes(int b)
{
    return kSlotBytes + sizeof(float) * ((size_t)b * wide_ld(b) + wide_extra(b));
}

static_assert(wide_smem_bytes(kSmemMaxB) <= kSmemOptin &&
              wide_smem_bytes(kSmemMaxB + 1) > kSmemOptin,
              "kSmemMaxB is the last b whose augmented matrix fits in shared memory");

// b > 64, one block of T threads a matrix: the augmented matrix and its
// vectors in dynamic shared memory (kShared) or in the workspace ws,
// (b wide_ld(b) + wide_extra(b)) floats a matrix.
template <bool kShared>
__global__ void __launch_bounds__(kShared ? 512 : 1024, 1)
gj_inverse_wide_kernel(const float* __restrict__ A, float* __restrict__ out,
                       int* __restrict__ piv_out, float* ws, int b)
{
    constexpr int T = kShared ? 512 : 1024, NW = T / 32;
    extern __shared__ __align__(16) unsigned char wide_smem[];
    __shared__ unsigned long long slot_g[kShared ? 1 : NW];
    unsigned long long* const slot =
        kShared ? reinterpret_cast<unsigned long long*>(wide_smem) : slot_g;
    const int ld = wide_ld(b);
    const size_t g = blockIdx.x;
    float* const M = kShared
        ? reinterpret_cast<float*>(wide_smem + kSlotBytes)
        : ws + g * ((size_t)b * ld + wide_extra(b));
    float* const prow = M + (size_t)b * ld;
    float* const f = prow + ld;
    int* const piv = reinterpret_cast<int*>(f + b);
    int* const used = piv + b;
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    const int nv = ld / 4;

    // [A | I], and zero in the padding columns of every row and of prow
    const float* const a = A + g * b * b;
    for (int i = w; i < b; i += NW) {
        float* const row = M + (size_t)i * ld;
        for (int c = lane; c < ld; c += 32)
            row[c] = c < b ? a[(size_t)i * b + c] : (c - b == i ? 1.0f : 0.0f);
    }
    for (int c = 2 * b + tid; c < ld; c += T) prow[c] = 0.0f;
    for (int i = tid; i < b; i += T) used[i] = 0;
    __syncthreads();

    for (int k = 0; k < b; ++k) {
        // ---- A: f = column k; the argmax of the scores ------------------
        unsigned bk = 0u, br = 0xffffffffu;
        for (int i = tid; i < b; i += T) {
            const float c = M[(size_t)i * ld + k];
            f[i] = c;
            const unsigned key = order_key(__fsub_rn(fabsf(c), used[i] ? 1e30f : 0.0f));
            if (key > bk) { bk = key; br = (unsigned)i; }
        }
        const unsigned kmax = __reduce_max_sync(kFull, bk);
        const unsigned rmin = __reduce_min_sync(kFull, bk == kmax ? br : 0xffffffffu);
        if (lane == 0) slot[w] = ((unsigned long long)kmax << 32) | (0xffffffffu - rmin);
        __syncthreads();
        unsigned long long best = slot[0];
        for (int v = 1; v < NW; ++v) best = best > slot[v] ? best : slot[v];
        const int p = (int)(0xffffffffu - (unsigned)best);

        // ---- B: the scaled pivot row -------------------------------------
        const float d = f[p];
        const float* const pr = M + (size_t)p * ld;
        for (int c = tid; c < 2 * b; c += T) prow[c] = div_rn(pr[c], d);
        if (tid == 0) { used[p] = 1; piv[k] = p; }
        __syncthreads();

        // ---- C: every row takes the step ---------------------------------
        for (int i = w; i < b; i += NW) {
            float* const row = M + (size_t)i * ld;
            if (i == p) {
                for (int v = lane; v < nv; v += 32)
                    *reinterpret_cast<float4*>(row + 4 * v) =
                        *reinterpret_cast<const float4*>(prow + 4 * v);
            } else {
                const float fi = f[i];
                for (int v = lane; v < nv; v += 32) {
                    float4 x = *reinterpret_cast<const float4*>(row + 4 * v);
                    const float4 u = *reinterpret_cast<const float4*>(prow + 4 * v);
                    x.x = __fsub_rn(x.x, __fmul_rn(fi, u.x));
                    x.y = __fsub_rn(x.y, __fmul_rn(fi, u.y));
                    x.z = __fsub_rn(x.z, __fmul_rn(fi, u.z));
                    x.w = __fsub_rn(x.w, __fmul_rn(fi, u.w));
                    *reinterpret_cast<float4*>(row + 4 * v) = x;
                }
            }
        }
        __syncthreads();
    }

    // row k of the inverse is the right half of the row that pivoted at step k
    float* const o = out + g * b * b;
    for (int k = w; k < b; k += NW) {
        const int r = piv[k];
        const float* const src = M + (size_t)r * ld + b;
        for (int c = lane; c < b; c += 32) o[(size_t)k * b + c] = src[c];
        if (piv_out != nullptr && lane == 0) piv_out[g * b + k] = r;
    }
}

template <int B>
int launch(const float* A, float* out, int* piv, int G, int b, cudaStream_t stream)
{
    using K = Class<B>;
    const bool vec = b % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0
                     && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    const int blocks = (G + K::MPB - 1) / K::MPB;
    gj_inverse_kernel<B><<<blocks, 32 * K::WPM * K::MPB, 0, stream>>>(A, out, piv, G, b, vec);
    return (int)cudaGetLastError();
}

}  // namespace

// Floats of device workspace a matrix of size b needs (the wrapper
// allocates G times this; 0 where the matrix stays in registers or in
// shared memory).
extern "C" long long gj_inverse_workspace_floats(int b)
{
    return b > kSmemMaxB ? (long long)b * wide_ld(b) + (long long)wide_extra(b) : 0;
}

// Lets the shared-memory wide variant take its shared memory (above the
// 48 KB default) on the current device; call once per device before the
// first launch there.  Returns the CUDA error (0 on success).
extern "C" int gj_inverse_prepare()
{
    return (int)cudaFuncSetAttribute(gj_inverse_wide_kernel<true>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)wide_smem_bytes(kSmemMaxB));
}

// A, out: (G, b, b) contiguous f32 on the device; piv: (G, b) int32 pivot
// rows (the row that pivoted at step k), or null; ws: the workspace of
// G gj_inverse_workspace_floats(b) floats (null where that is 0); stream:
// a cudaStream_t.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int gj_inverse_f32(const float* A, float* out, int* piv, int G, int b,
                              float* ws, void* stream)
{
    if (G <= 0 || b <= 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    if (b <= 16) return launch<16>(A, out, piv, G, b, s);
    if (b <= 32) return launch<32>(A, out, piv, G, b, s);
    if (b <= kRegMaxB) return launch<64>(A, out, piv, G, b, s);
    if (b <= kSmemMaxB) {
        gj_inverse_wide_kernel<true><<<G, 512, wide_smem_bytes(b), s>>>(A, out, piv, nullptr, b);
    } else {
        if (ws == nullptr) return (int)cudaErrorInvalidValue;
        gj_inverse_wide_kernel<false><<<G, 1024, 0, s>>>(A, out, piv, ws, b);
    }
    return (int)cudaGetLastError();
}
