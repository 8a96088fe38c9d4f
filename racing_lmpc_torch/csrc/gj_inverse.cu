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
// Wide variant, 64 < b <= kSmemMaxB (the JAX function takes any b; none of
// the repo's paths calls it).  The matrix no longer fits in registers, so
// one block of 512 threads a matrix keeps the whole augmented matrix (b
// rows of 2b columns, rows 16-byte aligned at wide_ld(b) floats), prow, f,
// the pivots and the used flags in dynamic shared memory, 8 b^2 bytes and
// a little more (229,408 B at b = 168 under the 232,448 B a block may take;
// gj_inverse_prepare() grants it once a device), and runs the same steps
// with three barriers a step:
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
// step k, gathered with coalesced stores.  A step moves the matrix
// through shared memory once (a load and a store an entry), so
// shared-memory bandwidth, at one block an SM above b = 119, bounds it.
//
// Grid variant, b > kSmemMaxB: one matrix over the whole card.  One block a
// matrix, as the shared-memory variant runs, kept every step's 8 b^2 bytes
// of the augmented matrix on one SM (193.5 ms at (4, 1024, 1024) on an
// H100, 12x the torch.linalg.inv yardstick).  Here the steps go in panels of 32, and each
// entry still takes every step's operation, with the same factors, in step
// order; only who applies it changes.  The augmented matrix M (b x
// wide_ld(b), 64-bit offsets) lives in the workspace the wrapper allocates
// (gj_inverse_workspace_floats(G, b) floats a launch), beside P
// (32 x wide_ld(b): each step's scaled pivot row on the columns
// outside its panel), F (two buffers of 32 x b: each row's factor f at
// each step of a panel), the pivots and the used flags.  One persistent
// cooperative launch (cudaLaunchCooperativeKernel, kGridThreads a block,
// as many blocks as are co-resident) runs, with a grid-wide barrier
// between stages, for each panel k0 .. k0 + nb - 1:
//   A  one block a matrix runs the panel's nb steps on the panel's columns
//      of every row, kept in shared memory (b x kMs floats; in the
//      workspace past b = kPanelSmemMaxB): the argmax above (f read first,
//      NaN on top, the lower row on a tie, used rows masked), the pivot
//      row's panel columns divided by d, every other row's multiply-
//      subtract, two block barriers a step; it records each row's f in F
//      and the pivots;
//   B  every column outside the panel, one thread a column: the panel's
//      pivot rows' entries run the steps' recurrence down those rows (at
//      step k the row that pivots there has taken the earlier steps of the
//      panel, or is replaced where it pivoted before: a row pivots again
//      only once its column turned inf or NaN) and are divided by d_k into
//      P[k];
//   C  every entry outside the panel takes the panel's steps in ascending
//      order in block tiles of kGR x kGC (kTR x kTC a thread): the row that
//      pivots at step k is replaced by P[k], every other row subtracts
//      F[k][i] P[k][c].
// A of the next panel runs beside C, on its own block (the "chain"): it
// first applies C to the next panel's columns itself, then runs their
// steps, while the other blocks take the rest of C (F is double-buffered
// for this); the first panel's chain applies no steps first.  Two grid
// barriers a panel.  Every entry of the augmented matrix is still updated,
// so a singular lane's NaN is where the plain version has it;
// tests/test_torch_large_kernels.py repeats this schedule in PyTorch, panel
// by panel and tile by tile, bit for bit against the plain version.  The critical path is the b steps of A (a block-wide
// argmax, a division and a sweep of b x 32 entries each); the 4 b^3
// operations of C are spread over every SM.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "grid_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRegMaxB = 64;         // the register classes' largest b
constexpr int kSmemMaxB = 168;       // the wide variant's matrix in shared memory
constexpr int kSmemOptin = 232448;   // the shared memory a block may take
constexpr int kGridThreads = 512;    // the grid variant's block

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

// 64 < b <= kSmemMaxB, one block of T threads a matrix: the augmented
// matrix and its vectors in dynamic shared memory.
__global__ void __launch_bounds__(512, 1)
gj_inverse_wide_kernel(const float* __restrict__ A, float* __restrict__ out,
                       int* __restrict__ piv_out, int b)
{
    constexpr int T = 512, NW = T / 32;
    extern __shared__ __align__(16) unsigned char wide_smem[];
    unsigned long long* const slot = reinterpret_cast<unsigned long long*>(wide_smem);
    const int ld = wide_ld(b);
    const size_t g = blockIdx.x;
    float* const M = reinterpret_cast<float*>(wide_smem + kSlotBytes);
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

// ---- The grid variant, b > kSmemMaxB ------------------------------------

constexpr int kMs = 36;             // row stride of a panel's columns (16-byte rows)
constexpr int kTR = 8, kTC = 4;     // a thread's entries of a C tile, rows x columns
constexpr int kGR = 128, kGC = 128; // a C tile, rows x columns
static_assert((kGR / kTR) * (kGC / kTC) == kGridThreads, "one kTR x kTC tile a thread");
static_assert(kGC / kTC == 32, "a warp's threads share their rows");

// The largest b whose panel (b x kMs floats) the grid variant keeps in
// shared memory beside its fixed part (the argmax slots, the scaled pivot
// row, the panel's pivots, a tile's pivot masks, B's factors and the next
// panel's P); past it the panel lives in the workspace.
constexpr int kGridFixedBytes = 128 + 128 + 128 + 4 * kGR + 4 * 32 * 33 + 4 * 32 * kMs;
constexpr int kPanelSmemMaxB = (kSmemOptin - kGridFixedBytes) / (4 * kMs);
static_assert(kGridFixedBytes % 16 == 0, "the work area starts 16-byte aligned");

__host__ __device__ constexpr size_t grid_smem_bytes(int b, bool panel_shared)
{
    const size_t panel = panel_shared ? (size_t)4 * kMs * b : 0;
    const size_t tiles = (size_t)4 * 32 * (kGR + kGC);
    return kGridFixedBytes + (panel > tiles ? panel : tiles);
}

static_assert(grid_smem_bytes(kPanelSmemMaxB, true) <= kSmemOptin &&
              grid_smem_bytes(kPanelSmemMaxB + 1, true) > kSmemOptin,
              "kPanelSmemMaxB is the last b whose panel fits in shared memory");

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// Floats of the grid variant's workspace a matrix: M (b x wide_ld(b)), P
// (32 x wide_ld(b)), F (2 x 32 x b), the pivots and the used flags (b each,
// rounded to 4) and, past kPanelSmemMaxB, the panel (b x kMs)
__host__ __device__ constexpr size_t grid_ws_floats(int b)
{
    return (size_t)(b + 32) * wide_ld(b) + (size_t)64 * b + 2 * (size_t)round4(b)
           + (b > kPanelSmemMaxB ? (size_t)kMs * b : 0);
}

// One matrix's part of the workspace
struct GridMat {
    float* M;       // the augmented matrix, wide_ld(b) floats a row
    float* P;       // P[k][c], step k of the panel, 32 rows of wide_ld(b)
    float* F;       // two buffers of F[k][i], 32 x b each
    int* piv;       // the row that pivoted at each step
    int* used;      // 1 once a row has pivoted
    float* Ms;      // the panel's columns, kMs floats a row
};

__device__ __forceinline__ GridMat grid_mat(float* ws, int g, int b, float* smem_panel)
{
    const int ld = wide_ld(b);
    GridMat m;
    m.M = ws + (size_t)g * grid_ws_floats(b);
    m.P = m.M + (size_t)b * ld;
    m.F = m.P + (size_t)32 * ld;
    m.piv = reinterpret_cast<int*>(m.F + (size_t)64 * b);
    m.used = m.piv + round4(b);
    m.Ms = smem_panel != nullptr ? smem_panel : reinterpret_cast<float*>(m.used + round4(b));
    return m;
}

// G matrices, b > kSmemMaxB, over the whole card (see the note at the
// top): the panel's columns in shared memory (kPanelShared) or in the
// workspace ws (grid_ws_floats(b) floats a matrix).  Launched
// cooperatively with no more blocks than are co-resident.
template <bool kPanelShared>
__global__ void __launch_bounds__(kGridThreads, 1)
gj_inverse_grid_kernel(const float* __restrict__ A, float* __restrict__ out,
                       int* __restrict__ piv_out, float* ws, int G, int b)
{
    cg::grid_group grid = cg::this_grid();
    extern __shared__ __align__(16) unsigned char grid_smem[];
    unsigned long long* const slot = reinterpret_cast<unsigned long long*>(grid_smem);
    float* const prs = reinterpret_cast<float*>(grid_smem + 128);      // the scaled pivot row
    int* const pv = reinterpret_cast<int*>(grid_smem + 256);           // the panel's pivots
    // a tile's rows' steps (C), or the earlier steps of each step's row (B)
    unsigned* const masks = reinterpret_cast<unsigned*>(grid_smem + 384);
    float (*const Fp)[33] = reinterpret_cast<float (*)[33]>(grid_smem + 384 + 4 * kGR);
    float (*const Pn)[kMs] =
        reinterpret_cast<float (*)[kMs]>(grid_smem + 384 + 4 * kGR + 4 * 32 * 33);
    float* const work = reinterpret_cast<float*>(grid_smem + kGridFixedBytes);
    float (*const Fs)[kGR] = reinterpret_cast<float (*)[kGR]>(work);
    float (*const Ps)[kGC] = reinterpret_cast<float (*)[kGC]>(work + 32 * kGR);

    constexpr int NW = kGridThreads / 32;
    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
    const int nblk = gridDim.x, bid = blockIdx.x;
    const int ld = wide_ld(b), panels = (b + 31) / 32;
    auto mat = [=](int g) { return grid_mat(ws, g, b, kPanelShared ? work : nullptr); };

    // ---- [A | I], zero in the padding columns; no row used ----------------
    for (long long r = (long long)bid * NW + w; r < (long long)G * b; r += (long long)nblk * NW) {
        const int g = (int)(r / b), i = (int)(r % b);
        const GridMat m = mat(g);
        const float* const a = A + (size_t)g * b * b + (size_t)i * b;
        float* const row = m.M + (size_t)i * ld;
        for (int c = lane; c < ld; c += 32) row[c] = c < b ? a[c] : (c - b == i ? 1.0f : 0.0f);
        if (lane == 0) m.used[i] = 0;
    }
    grid.sync();

    // A: the steps k0 .. k0 + nb - 1 on the panel's columns of every row (in
    // m.Ms), by one block, each row's f into Fb; then the columns back into M
    auto steps = [&](const GridMat& m, int k0, int nb, float* Fb) {
        float* const Ms = m.Ms;
        // the used flags of this thread's rows i = tid + kGridThreads q, bit
        // q (q < 64), read from m.used once; past 64 rows a thread, from m.used
        unsigned long long mine = 0ull;
        for (int i = tid, q = 0; i < b && q < 64; i += kGridThreads, ++q)
            mine |= (unsigned long long)(m.used[i] != 0) << q;
        for (int kk = 0; kk < nb; ++kk) {
            unsigned bk = 0u, br = 0xffffffffu;
            for (int i = tid, q = 0; i < b; i += kGridThreads, ++q) {
                const float c = Ms[(size_t)i * kMs + kk];
                Fb[(size_t)kk * b + i] = c;
                const bool used = q < 64 ? (mine >> q) & 1ull : m.used[i] != 0;
                const unsigned key = order_key(__fsub_rn(fabsf(c), used ? 1e30f : 0.0f));
                if (key > bk) { bk = key; br = (unsigned)i; }
            }
            const unsigned kmax = __reduce_max_sync(kFull, bk);
            const unsigned rmin = __reduce_min_sync(kFull, bk == kmax ? br : 0xffffffffu);
            if (lane == 0) slot[w] = ((unsigned long long)kmax << 32) | (0xffffffffu - rmin);
            __syncthreads();
            unsigned long long best = slot[0];
            for (int v = 1; v < NW; ++v) best = best > slot[v] ? best : slot[v];
            const int p = (int)(0xffffffffu - (unsigned)best);
            const float* const prow = Ms + (size_t)p * kMs;
            if (tid < 32) prs[tid] = div_rn(prow[tid], prow[kk]);
            if (tid == 0) {
                m.used[p] = 1;
                m.piv[k0 + kk] = p;
            }
            if (p % kGridThreads == tid && p / kGridThreads < 64)
                mine |= 1ull << (p / kGridThreads);
            __syncthreads();
            // every thread its own rows; the next step's first barrier comes
            // after each thread's update and before prs is written again
            for (int i = tid; i < b; i += kGridThreads) {
                float* const row = Ms + (size_t)i * kMs;
                if (i == p) {
                    sfor<8>([&](auto q_) {
                        constexpr int q = decltype(q_)::value;
                        const float4 u = ld4(prs + 4 * q);
                        st4(row + 4 * q, u.x, u.y, u.z, u.w);
                    });
                } else {
                    const float f = row[kk];
                    sfor<8>([&](auto q_) {
                        constexpr int q = decltype(q_)::value;
                        const float4 x = ld4(row + 4 * q), u = ld4(prs + 4 * q);
                        st4(row + 4 * q, __fsub_rn(x.x, __fmul_rn(f, u.x)),
                            __fsub_rn(x.y, __fmul_rn(f, u.y)), __fsub_rn(x.z, __fmul_rn(f, u.z)),
                            __fsub_rn(x.w, __fmul_rn(f, u.w)));
                    });
                }
            }
        }
        __syncthreads();
        for (int i = w; i < b; i += NW)
            if (lane < nb) m.M[(size_t)i * ld + k0 + lane] = Ms[(size_t)i * kMs + lane];
    };

    // The chain beside C: the next panel's columns k1 .. k1 + nb1 - 1 of
    // every row take this panel's nb steps (C on them), then the next
    // panel's A (the first panel's chain takes nb = 0 steps first)
    auto chain = [&](int g, int k0, int nb, int k1, int nb1, const float* Fb, float* Fb1) {
        const GridMat m = mat(g);
        __syncthreads();
        if (tid < 32) pv[tid] = tid < nb ? m.piv[k0 + tid] : -1;
        for (int e = tid; e < 32 * 32; e += kGridThreads) {
            const int kk = e >> 5, c = e & 31;
            Pn[kk][c] = kk < nb ? m.P[(size_t)kk * ld + k1 + c] : 0.0f;
        }
        __syncthreads();
        // each row's next-panel columns in two halves of 16 (each entry
        // takes the steps in order whatever the grouping)
        for (int e = tid; e < 2 * b; e += kGridThreads) {
            const int i = e >> 1, h = 16 * (e & 1);
            // only the next panel's columns: past them, the tiles are at work
            const float* const src = m.M + (size_t)i * ld + k1 + h;
            float v[16];
            sfor<16>([&](auto c_) {
                constexpr int c = decltype(c_)::value;
                v[c] = h + c < nb1 ? src[c] : 0.0f;
            });
            unsigned mask = 0u;
            for (int kk = 0; kk < nb; ++kk) mask |= (pv[kk] == i ? 1u : 0u) << kk;
            // the row's f of 8 steps at a time: a wait on memory every 8
            // steps, not every step
#pragma unroll 1
            for (int k8 = 0; k8 < nb; k8 += 8) {
                float f[8];
                sfor<8>([&](auto j_) {
                    constexpr int j = decltype(j_)::value;
                    f[j] = k8 + j < nb ? Fb[(size_t)(k8 + j) * b + i] : 0.0f;
                });
                sfor<8>([&](auto j_) {
                    constexpr int j = decltype(j_)::value;
                    const int kk = k8 + j;
                    if (kk < nb) {
                        const bool pivots = (mask >> kk) & 1u;
                        sfor<4>([&](auto q_) {
                            constexpr int q = decltype(q_)::value;
                            const float4 u = ld4(&Pn[kk][h + 4 * q]);
                            const float uu[4] = {u.x, u.y, u.z, u.w};
                            sfor<4>([&](auto e_) {
                                constexpr int c = 4 * q + decltype(e_)::value;
                                v[c] = pivots ? uu[c - 4 * q]
                                              : __fsub_rn(v[c], __fmul_rn(f[j], uu[c - 4 * q]));
                            });
                        });
                    }
                });
            }
            float* const row = m.Ms + (size_t)i * kMs + h;
            sfor<4>([&](auto q_) {
                constexpr int q = decltype(q_)::value;
                st4(row + 4 * q, v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
            });
        }
        __syncthreads();
        steps(m, k1, nb1, Fb1);
    };

    // B: other column o (of 2b - nb) of matrix g down the panel's pivot
    // rows; masks[k] holds the earlier steps at which step k's row pivoted
    auto column = [&](int g, int chunk, int k0, int nb, const float* Fb) {
        const GridMat m = mat(g);
        __syncthreads();
        if (tid < 32) pv[tid] = tid < nb ? m.piv[k0 + tid] : 0;
        __syncthreads();
        for (int e = tid; e < 32 * 32; e += kGridThreads) {
            const int kk = e >> 5, kp = e & 31;
            Fp[kk][kp] = kk < nb && kp <= kk ? Fb[(size_t)kp * b + pv[kk]] : 0.0f;
        }
        if (tid < 32) {
            unsigned mk = 0u;
            for (int kp = 0; kp < tid; ++kp) mk |= (pv[kp] == pv[tid] ? 1u : 0u) << kp;
            masks[tid] = mk;
        }
        __syncthreads();
        const int o = chunk * kGridThreads + tid;
        if (o >= 2 * b - nb) return;
        const int c = o < k0 ? o : o + nb;
        // Pv[k]: the pivot row's entry before the panel, then P[k]
        float Pv[32];
        sfor<32>([&](auto kk_) {
            constexpr int kk = decltype(kk_)::value;
            Pv[kk] = kk < nb ? m.M[(size_t)pv[kk] * ld + c] : 0.0f;
        });
        sfor<32>([&](auto kk_) {
            constexpr int kk = decltype(kk_)::value;
            if (kk < nb) {
                float v = Pv[kk];
                const unsigned same = masks[kk];
                sfor<kk>([&](auto kp_) {
                    constexpr int kp = decltype(kp_)::value;
                    v = (same >> kp) & 1u ? Pv[kp]
                                          : __fsub_rn(v, __fmul_rn(Fp[kk][kp], Pv[kp]));
                });
                Pv[kk] = div_rn(v, Fp[kk][kk]);
                m.P[(size_t)kk * ld + c] = Pv[kk];
            }
        });
    };

    // C: a tile of kGR rows by kGC columns of matrix g; the columns of this
    // panel (k0, nb) and of the chain's (k1, nb1) left out
    auto tile = [&](int g, int r0, int c0, int k0, int nb, int k1, int nb1, const float* Fb) {
        const GridMat m = mat(g);
        auto outside = [&](int c) {
            return c < 2 * b && (c < k0 || c >= k0 + nb) && (c < k1 || c >= k1 + nb1);
        };
        __syncthreads();
        if (tid < 32) pv[tid] = tid < nb ? m.piv[k0 + tid] : -1;
        __syncthreads();
        if (tid < kGR) {
            unsigned mk = 0u;
            for (int kk = 0; kk < nb; ++kk) mk |= (pv[kk] == r0 + tid ? 1u : 0u) << kk;
            masks[tid] = mk;
        }
        for (int e = tid; e < 32 * kGR; e += kGridThreads) {
            const int kk = e / kGR, x = e % kGR;
            Fs[kk][x] = kk < nb && r0 + x < b ? Fb[(size_t)kk * b + r0 + x] : 0.0f;
        }
        for (int e = tid; e < 32 * kGC; e += kGridThreads) {
            const int kk = e / kGC, x = e % kGC;
            Ps[kk][x] = kk < nb && outside(c0 + x) ? m.P[(size_t)kk * ld + c0 + x] : 0.0f;
        }
        __syncthreads();
        const int tr = tid / (kGC / kTC), tc = tid % (kGC / kTC);
        const int i0 = r0 + kTR * tr, j0 = c0 + kTC * tc;
        float acc[kTR][kTC];
        unsigned any = 0u;
        sfor<kTR>([&](auto r_) {
            constexpr int r = decltype(r_)::value;
            any |= masks[kTR * tr + r];
            sfor<kTC>([&](auto c_) {
                constexpr int c = decltype(c_)::value;
                acc[r][c] = i0 + r < b && outside(j0 + c) ? m.M[(size_t)(i0 + r) * ld + j0 + c]
                                                          : 0.0f;
            });
        });
        // a warp's threads share their rows (kGC / kTC = 32), so the branch
        // is the warp's: rows that pivot in this panel (at most nb of the
        // b) take the steps one row at a time, each step of the pivoting
        // row replacing it
        if (any == 0u) {
#pragma unroll 1
            for (int kk = 0; kk < nb; ++kk) {
                const float4 l0 = ld4(&Fs[kk][kTR * tr]), l1 = ld4(&Fs[kk][kTR * tr + 4]);
                const float4 u = ld4(&Ps[kk][kTC * tc]);
                const float li[kTR] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
                const float uk[kTC] = {u.x, u.y, u.z, u.w};
                sfor<kTR>([&](auto r_) {
                    constexpr int r = decltype(r_)::value;
                    sfor<kTC>([&](auto c_) {
                        constexpr int c = decltype(c_)::value;
                        acc[r][c] = __fsub_rn(acc[r][c], __fmul_rn(li[r], uk[c]));
                    });
                });
            }
        } else {
            sfor<kTR>([&](auto r_) {
                constexpr int r = decltype(r_)::value;
                const unsigned mk = masks[kTR * tr + r];
#pragma unroll 1
                for (int kk = 0; kk < nb; ++kk) {
                    const float f = Fs[kk][kTR * tr + r];
                    const float4 u = ld4(&Ps[kk][kTC * tc]);
                    const float uk[kTC] = {u.x, u.y, u.z, u.w};
                    const bool pivots = (mk >> kk) & 1u;
                    sfor<kTC>([&](auto c_) {
                        constexpr int c = decltype(c_)::value;
                        acc[r][c] = pivots ? uk[c] : __fsub_rn(acc[r][c], __fmul_rn(f, uk[c]));
                    });
                }
            });
        }
        sfor<kTR>([&](auto r_) {
            constexpr int r = decltype(r_)::value;
            sfor<kTC>([&](auto c_) {
                constexpr int c = decltype(c_)::value;
                if (i0 + r < b && outside(j0 + c)) m.M[(size_t)(i0 + r) * ld + j0 + c] = acc[r][c];
            });
        });
    };

    split_tasks(G, 0, [&](int g) { chain(g, 0, 0, 0, b < 32 ? b : 32, nullptr, mat(g).F); },
                [](long long) {});
    grid.sync();
    const int RT = (b + kGR - 1) / kGR, CT = (2 * b + kGC - 1) / kGC;
    const long long per = (long long)RT * CT;
    for (int t = 0; t < panels; ++t) {
        const int k0 = 32 * t, nb = b - k0 < 32 ? b - k0 : 32, k1 = k0 + nb;
        const int nb1 = k1 < b ? (b - k1 < 32 ? b - k1 : 32) : 0;
        const size_t fb = (size_t)(t & 1) * 32 * b, fb1 = (size_t)((t + 1) & 1) * 32 * b;

        // ---- B ---------------------------------------------------------------
        const int chunks = (2 * b - nb + kGridThreads - 1) / kGridThreads;
        for (long long q = bid; q < (long long)G * chunks; q += nblk) {
            const int g = (int)(q / chunks);
            column(g, (int)(q % chunks), k0, nb, mat(g).F + fb);
        }
        grid.sync();

        // ---- C beside the next panel's chain -----------------------------------
        split_tasks(
            nb1 > 0 ? G : 0, G * per,
            [&](int g) { chain(g, k0, nb, k1, nb1, mat(g).F + fb, mat(g).F + fb1); },
            [&](long long s) {
                const int g = (int)(s / per), q = (int)(s % per);
                tile(g, kGR * (q / CT), kGC * (q % CT), k0, nb, k1, nb1, mat(g).F + fb);
            });
        grid.sync();
    }

    // ---- row k of the inverse: the right half of the row that pivoted at k ---
    for (long long r = (long long)bid * NW + w; r < (long long)G * b; r += (long long)nblk * NW) {
        const int g = (int)(r / b), k = (int)(r % b);
        const GridMat m = mat(g);
        const int src = m.piv[k];
        const float* const from = m.M + (size_t)src * ld + b;
        float* const o = out + ((size_t)g * b + k) * b;
        for (int c = lane; c < b; c += 32) o[c] = from[c];
        if (piv_out != nullptr && lane == 0) piv_out[(size_t)g * b + k] = src;
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

// Floats of device workspace a launch of G matrices of size b needs (0
// where the matrix stays in registers or in shared memory).
extern "C" long long gj_inverse_workspace_floats(int G, int b)
{
    return G > 0 && b > kSmemMaxB ? (long long)G * (long long)grid_ws_floats(b) : 0;
}

// The variant gj_inverse_f32 runs for G matrices of size b.
extern "C" const char* gj_inverse_variant(int G, int b)
{
    if (G <= 0 || b <= 0) return "none";
    if (b <= kRegMaxB) return "registers";
    if (b <= kSmemMaxB) return "wide, matrix in shared memory";
    return b <= kPanelSmemMaxB ? "grid, panel in shared memory" : "grid, panel in device memory";
}

// Lets the shared-memory wide variant and the grid variant take their
// shared memory (above the 48 KB default) on the current device; call once
// per device before the first launch there.  Returns the CUDA error (0 on
// success).
extern "C" int gj_inverse_prepare()
{
    cudaError_t e = cudaFuncSetAttribute(gj_inverse_wide_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)wide_smem_bytes(kSmemMaxB));
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(gj_inverse_grid_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)grid_smem_bytes(kPanelSmemMaxB, true));
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(gj_inverse_grid_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)grid_smem_bytes(kPanelSmemMaxB + 1, false));
    return (int)e;
}

// The grid variant's cooperative launch: as many blocks as are co-resident
// on the current device, and no more than stage C has tasks.  Returns the
// CUDA error.
template <bool kPanelShared>
static cudaError_t launch_grid(const float* A, float* out, int* piv, float* ws, int G, int b,
                               cudaStream_t s)
{
    const auto kernel = gj_inverse_grid_kernel<kPanelShared>;
    const size_t smem = grid_smem_bytes(b, kPanelShared);
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kGridThreads, smem);
    if (e != cudaSuccess) return e;
    if (per_sm <= 0) return cudaErrorLaunchOutOfResources;
    const long long tiles = (long long)((b + kGR - 1) / kGR) * ((2 * b + kGC - 1) / kGC);
    const long long want = (long long)G * (1 + tiles);
    const int blocks = (int)(want < (long long)per_sm * sms ? want : (long long)per_sm * sms);
    void* args[] = {(void*)&A, (void*)&out, (void*)&piv, (void*)&ws, (void*)&G, (void*)&b};
    return cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(kGridThreads),
                                       args, smem, s);
}

// A, out: (G, b, b) contiguous f32 on the device; piv: (G, b) int32 pivot
// rows (the row that pivoted at step k), or null; ws: the workspace of
// gj_inverse_workspace_floats(G, b) floats (null where that is 0); stream:
// a cudaStream_t.  Returns the launch's error, else cudaGetLastError()
// after it (0 on success), or cudaErrorInvalidValue, without launching,
// when a workspace is needed and ws is null.
extern "C" int gj_inverse_f32(const float* A, float* out, int* piv, int G, int b,
                              float* ws, void* stream)
{
    if (G <= 0 || b <= 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    if (b <= 16) return launch<16>(A, out, piv, G, b, s);
    if (b <= 32) return launch<32>(A, out, piv, G, b, s);
    if (b <= kRegMaxB) return launch<64>(A, out, piv, G, b, s);
    if (b <= kSmemMaxB) {
        gj_inverse_wide_kernel<<<G, 512, wide_smem_bytes(b), s>>>(A, out, piv, b);
    } else {
        if (ws == nullptr) return (int)cudaErrorInvalidValue;
        const cudaError_t e = b <= kPanelSmemMaxB ? launch_grid<true>(A, out, piv, ws, G, b, s)
                                                  : launch_grid<false>(A, out, piv, ws, G, b, s);
        if (e != cudaSuccess) {
            cudaGetLastError();
            return (int)e;
        }
    }
    return (int)cudaGetLastError();
}
