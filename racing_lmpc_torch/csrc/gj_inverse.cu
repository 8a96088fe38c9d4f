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

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxB = 64;
constexpr unsigned kFull = 0xffffffffu;

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

// The largest b the kernel takes; the wrapper reads it from here.
extern "C" int gj_inverse_max_b() { return kMaxB; }

// A, out: (G, b, b) contiguous f32 on the device; piv: (G, b) int32 pivot
// rows (the row that pivoted at step k), or null; stream: a cudaStream_t.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int gj_inverse_f32(const float* A, float* out, int* piv, int G, int b,
                              void* stream)
{
    if (G <= 0 || b <= 0) return 0;
    if (b > kMaxB) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    if (b <= 16) return launch<16>(A, out, piv, G, b, s);
    if (b <= 32) return launch<32>(A, out, piv, G, b, s);
    return launch<64>(A, out, piv, G, b, s);
}
