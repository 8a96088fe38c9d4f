// L^-1 for L = chol(H), over a batch of symmetric positive-definite f32
// matrices: the Hopper port of the TPU kernel
// racing_lmpc_tpu/ops/pallas_linalg.py::chol_tri_inv_fused (kernel body
// _chol_tri_inv_kernel, :305-309, which is tri_inv_lower(chol_lower(.))).
// The IPM factors its Newton-KKT matrix H and the Schur block with it at
// every iteration (racing_lmpc_tpu/mpc/ipm.py:214-218 and :231).
//
// Algorithm: one right-looking sweep that forms X = L^-1 in place, with no
// separate substitution.  One n x n lower-triangular store M: slot (i, k),
// k <= i, holds the trailing matrix A while k > j and the working rows W
// of the inverse (started from I) once k <= j.  At pivot j:
//   r = 1 / sqrt(M[j][j])                     (NaN if H is not PD)
//   row j of X is final: X[j][k] = M[j][k] r (k < j), X[j][j] = r
//   l_i = M[i][j] r                            (i > j)
//   u = (X[j][0..j], l_{j+1..n-1}); M[i][j] = 0, then for every row i > j
//   M[i][k] = M[i][k] - l_i u_k               (k <= i, one uniform update)
// n^3/3 multiply-subtracts in all, as potrf + trtri.  The plain PyTorch
// step mirror is ops/linalg.py::chol_tri_inv_sweep.
//
// Numerics, choice (a): no FMA contraction.  Every product, difference,
// quotient and square root is rounded on its own (__fmul_rn, __fsub_rn,
// __fdiv_rn, __fsqrt_rn; no fast math), so the kernel repeats the mirror
// operation for operation and is bit-equal to it on the card.  Scaling by
// the rounded reciprocal r rounds twice where a quotient rounds once: half
// an ulp more per entry, against the 1e-4 the kernel is held to.
//
// Design: the sweep in blocked order, one block of 8 warps (256 threads)
// per matrix, the matrix in registers.  Thread (warp w, lane l) owns rows
// i = w + 8 a (a < RA) and columns k = l + 32 b (b < RB): rows dealt
// cyclically to warps, columns to lanes, no index ever divided; only the
// tiles (a, b) that reach the lower triangle are kept.  Every loop over a
// tile is unrolled by templates (sfor), so each register index is a
// constant and nothing goes to local memory.  The pivots go in panels of
// 32, the columns of one tile t; for each panel, with one __syncthreads()
// between steps:
//   S1  the panel rows go to shared memory: the diagonal block D and,
//       transposed, their part left of the panel (UT);
//   S2  one warp sweeps D alone (lane c holds row c; each pivot's u on the
//       panel goes through shared memory with a __syncwarp): r_p, the
//       panel's block of X, and u^(p) on the panel (UP);
//   S3  every warp sweeps its rows below the panel on the panel's columns
//       (lane p's value, times r_p, is l_i of pivot p; a shuffle hands it
//       to the warp) and keeps each l_i in UT; the panel rows' part left
//       of the panel is a forward substitution down the panel, one column
//       a thread, into X;
//   S4  the panel rows take their X; the rows below take the deferred
//       updates of the panel's 32 pivots on every other tile, in pivot
//       order, four pivots to a 16-byte shared load.
// The blocking changes no bit, because no element's operations change or
// move past one another: an element takes pivot j's multiply-subtract, with
// the same two factors l_i and u_k, whichever stage applies it; the panels
// go in order, and every stage applies a panel's pivots to an element in
// ascending order (S2 and S3 pivot by pivot, the substitution down the
// panel rows, S4 column c of UT after column c - 1), after every pivot of
// the panels before and before any of the panels after.  A pivot costs a
// barrier only once a panel: S2 is the one dependent chain, a warp-level
// sweep of 32 pivots (an unblocked form with one barrier a pivot, tried
// first, was held back by that chain at every shape; PERF.md).  Up to
// n = 96 two matrices share an SM; the register variants take n <= 240
// (kRegMaxN).  Their shared memory is at most 45 KB, static.
// n = 1 (the IPM's Schur block) takes a one-thread-per-matrix kernel,
// 1 / sqrt(h).
//
// Wide variant, n > 240 (the double-track LMPC's QPs at the shipped
// learning horizons, n = 244 and 275; past n = 302 only for batches of more
// than kGridMaxG matrices, which the grid variant below takes otherwise):
// the same blocked sweep in panels of 32 pivots, one block of 16 warps
// (kWideThreads) a matrix.  The lower triangle lives packed in
// dynamic shared memory up to n = 302 (kSmemMaxN: n (n + 1) / 2 floats
// beside D, UP, rr and UT, 231,268 B at n = 302, under the 232,448 B a
// block may take; chol_tri_inv_prepare() grants the instances their shared
// memory once a device) and above that in place in the output buffer in
// device memory (4 MB at n = 1024, 16 MB at n = 2048, resident in the
// 50 MB L2), where each entry is read and written once a panel.  UT
// (32 x wide_ld(n)) holds each pivot's u over every column: the l_k of the
// rows below the panel and the panel rows' X left of it.  It lives in
// shared memory up to n = 1736 (kUTSmemMaxN: 231,552 B) and above that in
// a workspace of 32 wide_ld(n) floats a matrix (256 KB at n = 2048) that
// the wrapper allocates from PyTorch's allocator on the launch's stream;
// its entries are read from L1 and L2 there.  Only where UT lives changes:
// the stages, their order and every operation are the same in the three
// instances (triangle and UT in shared memory; triangle in out, UT in
// shared memory; both in device memory), so the argument below holds for
// all of them.  Every offset into a matrix, its triangle or the batch is
// formed in 64 bits (G n^2 = 2.1e9 at (512, 2048, 2048)); no size limit
// but the memory the buffers take.  For each panel:
//   S1, S2  warp 0 loads the diagonal block and sweeps it alone
//           (wide_factor_panel, a loop over the pivots);
//   S3      each row below takes the panel's pivots on the panel's columns
//           in registers, one thread a row, and keeps its l_i in UT; each
//           column left of the panel goes down the panel rows by forward
//           substitution, one thread a column, into UT;
//   S4      every row below takes the deferred update on every column
//           outside the panel, register-tiled: a thread loads a tile of 8
//           rows by 4 columns (kTR x kTC) once, applies the 32 pivots in
//           ascending order from two 16-byte loads of l and one of u a
//           pivot, a __fmul_rn and a __fsub_rn an entry a pivot, and
//           stores it once.
// S4 runs beside the next panel: warp 0 first updates the next panel's
// diagonal block itself, then runs that panel's S1 and S2, while the 12
// warps outside its scheduler update the rest and warps 4, 8 and 12 (which
// share it) write the finished panel rows out; the first panel's S1 and S2
// run beside the load.  A panel costs two barriers.  The blocking changes
// no bit, by the argument above: each entry takes each pivot's
// multiply-subtract once, with the same two factors, in pivot order (S2
// and S3 pivot by pivot, the substitution down the panel rows, S4's tiles
// pivot by pivot), after the panels before and before those after;
// tests/test_torch_chol_blocked.py repeats the stage order in PyTorch.
// At batch 1 one SM holds the matrix, and every product and difference is
// an instruction of its own (no FMA: the kernel is held bit for bit to a
// mirror that rounds each), so its floor is the 2/3 n^3 operations at one
// SM's f32 issue rate, twice the one-SM arithmetic floor below.  The
// tensor cores are not used: the port's numerics are f32 without TF32, and
// TF32 or 3xTF32 products change bits.  Above that floor it is held by S4
// on its 12 warps, S3's thread-per-row pivot chains and the one-warp S2
// chain beside S4 (the stage split, from clock64 stamps, is in PERF.md).
// A non-positive pivot gives NaN through sqrt, which spreads through that
// matrix's rows from the bad pivot on — the IPM's step_ok guard relies on
// it (ipm.py:434-444).  Nothing traps or exits early, and no other matrix
// is touched.
//
// Grid variant, n >= kGridMinN (303) and at most kGridMaxG (32) matrices a
// launch: each matrix over the whole card.  One block a matrix leaves 131
// of the 132 SMs idle at batch 1, and its one-SM floor alone (11.3 ms at
// n = 2048) is six times the torch.linalg yardstick, so no tuning of that
// design can reach it.  Here one persistent cooperative launch
// (cudaLaunchCooperativeKernel, kGridThreads a block, as many blocks as are
// co-resident and the widest stage has tasks) runs the same stages, in the
// same order, the batch's matrices side by side, with a grid-wide barrier
// between stages: the triangle in place in out (16 MB at n = 2048,
// resident in L2), UT, UP and rr of each matrix in a workspace of
// grid_ws_floats(n) floats a matrix.  For each panel:
//   X  S3, one warp a line (a row below the panel, grid_row_below, or a
//      column left of it, grid_panel_left, which also writes that column of
//      the panel rows' X into the triangle): the operations of
//      wide_row_below and wide_panel_left, lane c holding the line's entry
//      c and the pivot's entry shuffled to the warp (one thread a line, as
//      the wide variant has it, was several times slower here: each thread
//      ran ~2,000 unrolled instructions once a panel, with few warps to
//      share them), kS3Lines lines of one matrix a task, each block reading
//      that matrix's UP and rr into shared memory first; barrier;
//   Y  one task a matrix, the "chain" (with more blocks than matrices, on
//      a block that runs nothing else): the next panel's diagonal block
//      takes this panel's update into D, by the whole block (S1 in the same
//      pass), then warp 0 runs the next panel's S2 and publishes its UP, rr
//      and block of X; beside it, on the other
//      blocks, S4 of every other entry in block tiles of kGT x kGT (the
//      rows below the panel by the columns left of it, and the trailing
//      triangle from the next panel's rows down, its diagonal block left
//      out), each block staging the tile's 32 rows of l and of u from UT in
//      shared memory and each thread applying the 32 pivots in ascending
//      order to its kTR x kTC entries; barrier.
// The argument above holds unchanged: each entry takes each pivot's
// multiply-subtract once, with the same factors, in pivot order,
// and every stage reads only what was written before the last barrier or
// by its own thread (tests/test_torch_large_kernels.py repeats this
// schedule in PyTorch, panel by panel and tile by tile).  The G chains of
// a panel run side by side, so G matrices cost about what one does until
// the tiles fill the card; past kGridMaxG matrices one block a matrix is
// faster (grid_takes).
//
// Bound on an H100 SXM (700 W): the lower triangle of each symmetric input
// read once and each dense output written once, 4 G (n(n+1)/2 + n^2)
// bytes over 3.35 TB/s, against 2/3 n^3 flops a matrix over 67 TFLOP/s of
// f32 outside the tensor cores: bytes at the main path's (256, 87, 87),
// 3.5 us.  At batch 1 one SM holds the matrix, whose arithmetic floor is
// 2/3 n^3 / (67 TFLOP/s / 132): 7 us at n = 175, 13 us at n = 216.  At
// batch 1 the one-warp panel sweeps (S2) and the shuffled row sweeps (S3)
// are the dependent chains of the register variants; registers and spills
// of each variant: ptxas -v, printed by chip_smoke.py; times in PERF.md.
// The grid variant's critical path is a panel's chain (the diagonal block's
// update, S1 and S2) plus S3 and two grid barriers, n / 32 times; its
// arithmetic, 2/3 n^3 separately rounded operations, is spread over every
// SM.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "grid_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRegMaxN = 240;    // the register variants' largest n
constexpr int kSmemMaxN = 302;   // the wide variant's triangle in shared memory
constexpr int kUTSmemMaxN = 1736;   // the wide variant's UT in shared memory
constexpr int kGridMinN = 303;   // the grid variant's first n ...
constexpr int kGridMaxG = 32;    // ... up to this many matrices a launch
constexpr int kSmemOptin = 232448;   // the shared memory a block may take
constexpr int kWideThreads = 512;
constexpr int kTR = 8, kTC = 4;      // the wide variant's S4 tile, rows x columns
constexpr int kLd = 36;   // row stride of the shared panel arrays: 16-byte rows
constexpr int W = 8;      // warps a matrix: 256 threads

// the last 32-column tile that row tile a reaches
__host__ __device__ constexpr int bmax(int RB, int a)
{
    return (W * (a + 1) - 1) / 32 < RB - 1 ? (W * (a + 1) - 1) / 32 : RB - 1;
}

// The panel's diagonal block D (nb x nb, nb <= 32), by one warp: lane c
// holds row c.  Pivot p: r = 1 / sqrt(D[p][p]); row p of X is D[p][k] r
// (k < p) and r; l_c = D[c][p] r (c > p), D[c][p] = 0, then
// D[c][k] -= l_c u_k with u = (row p of X, l).  Each pivot's u goes to UP[p]
// and its r to rr[p]; D ends as the panel's block of X.
__device__ __noinline__ void factor_panel(float (*D)[kLd], float (*UP)[kLd],
                                          float* rr, int nb)
{
    const int l = threadIdx.x & 31;
    float Dr[32];
    sfor<8>([&](auto m_) {
        constexpr int m = decltype(m_)::value;
        const float4 v = ld4(&D[l][4 * m]);
        Dr[4 * m] = v.x; Dr[4 * m + 1] = v.y; Dr[4 * m + 2] = v.z; Dr[4 * m + 3] = v.w;
    });
    sfor<32>([&](auto p_) {
        constexpr int p = decltype(p_)::value;
        if (p < nb) {
            const float r = __fdiv_rn(1.0f, __fsqrt_rn(__shfl_sync(kFull, Dr[p], p)));
            float lc = 0.0f;
            if (l == p) {
                sfor<p>([&](auto k_) {
                    constexpr int k = decltype(k_)::value;
                    Dr[k] = __fmul_rn(Dr[k], r);
                });
                Dr[p] = r;
                sfor<p + 1>([&](auto k_) {
                    constexpr int k = decltype(k_)::value;
                    UP[p][k] = Dr[k];
                });
                rr[p] = r;
            } else if (l > p) {
                lc = __fmul_rn(Dr[p], r);
                Dr[p] = 0.0f;
                UP[p][l] = lc;
            }
            __syncwarp();
            if (l > p) {
                sfor<8>([&](auto m_) {
                    constexpr int m = decltype(m_)::value;
                    const float4 v = ld4(&UP[p][4 * m]);
                    Dr[4 * m] = __fsub_rn(Dr[4 * m], __fmul_rn(lc, v.x));
                    Dr[4 * m + 1] = __fsub_rn(Dr[4 * m + 1], __fmul_rn(lc, v.y));
                    Dr[4 * m + 2] = __fsub_rn(Dr[4 * m + 2], __fmul_rn(lc, v.z));
                    Dr[4 * m + 3] = __fsub_rn(Dr[4 * m + 3], __fmul_rn(lc, v.w));
                });
            }
        }
    });
    sfor<8>([&](auto m_) {
        constexpr int m = decltype(m_)::value;
        st4(&D[l][4 * m], Dr[4 * m], Dr[4 * m + 1], Dr[4 * m + 2], Dr[4 * m + 3]);
    });
}

// The panel rows' part left of the panel, one column k < j0 a thread, in
// UT[k][0..nb): a forward substitution down the panel rows.  Row p of X is
// the row times r_p; it then leaves l_c^(p) X[p][k] from each row c > p.
__device__ __noinline__ void panel_rows_left(float (*UT)[kLd], const float (*UP)[kLd],
                                             const float* rr, int j0, int nb)
{
    for (int k = threadIdx.x; k < j0; k += blockDim.x) {
        float col[32];
        sfor<8>([&](auto m_) {
            constexpr int m = decltype(m_)::value;
            const float4 v = ld4(&UT[k][4 * m]);
            col[4 * m] = v.x; col[4 * m + 1] = v.y; col[4 * m + 2] = v.z; col[4 * m + 3] = v.w;
        });
        sfor<32>([&](auto p_) {
            constexpr int p = decltype(p_)::value;
            if (p < nb) {
                const float x = __fmul_rn(col[p], rr[p]);
                col[p] = x;
                sfor<32>([&](auto c_) {
                    constexpr int c = decltype(c_)::value;
                    if constexpr (c > p) col[c] = __fsub_rn(col[c], __fmul_rn(UP[p][c], x));
                });
            }
        });
        sfor<8>([&](auto m_) {
            constexpr int m = decltype(m_)::value;
            st4(&UT[k][4 * m], col[4 * m], col[4 * m + 1], col[4 * m + 2], col[4 * m + 3]);
        });
    }
}

// RA row tiles (n <= W RA); up to n = 96 two matrices share an SM
template <int RA>
__global__ void __launch_bounds__(32 * W, RA * W <= 96 ? 2 : 1)
chol_tri_inv_panel_kernel(const float* __restrict__ H, float* __restrict__ out, int n)
{
    constexpr int RB = (W * RA + 31) / 32;   // 32-column tiles = panels
    constexpr int TPP = 32 / W;              // row tiles a panel
    __shared__ __align__(16) float D[32][kLd];        // the diagonal block
    __shared__ __align__(16) float UP[32][kLd];       // u^(p) on the panel
    __shared__ float rr[32];                          // r of each pivot
    __shared__ __align__(16) float UT[32 * RB][kLd];  // u^(p)_k, k-major

    const int w = threadIdx.x >> 5;
    const int l = threadIdx.x & 31;
    const size_t base = (size_t)blockIdx.x * (size_t)n * (size_t)n;
    const float* A = H + base;

    // only the lower triangle is read; slots above it start at 0 and are
    // never read back
    float M[RA][RB];
    sfor<RA>([&](auto a_) {
        constexpr int a = decltype(a_)::value;
        const int i = w + W * a;
        sfor<bmax(RB, a) + 1>([&](auto b_) {
            constexpr int b = decltype(b_)::value;
            const int k = l + 32 * b;
            M[a][b] = (i < n && k <= i) ? A[(size_t)i * n + k] : 0.0f;
        });
    });

    sfor<RB>([&](auto t_) {
        constexpr int t = decltype(t_)::value;
        constexpr int a_lo = TPP * t, a_hi = TPP * (t + 1);   // the panel's rows
        const int j0 = 32 * t;
        if (j0 >= n) return;
        const int nb = n - j0 < 32 ? n - j0 : 32;

        // ---- S1: the panel rows into D (tile t) and UT (left of it) ------
        sfor<RA>([&](auto a_) {
            constexpr int a = decltype(a_)::value;
            if constexpr (a >= a_lo && a < a_hi) {
                const int i = w + W * a;
                if (i < n) {
                    D[i - j0][l] = M[a][t];
                    sfor<t>([&](auto b_) {
                        constexpr int b = decltype(b_)::value;
                        UT[l + 32 * b][i - j0] = M[a][b];
                    });
                }
            }
        });
        __syncthreads();

        // ---- S2: one warp factors the diagonal block ---------------------
        if (w == 0) factor_panel(D, UP, rr, nb);
        __syncthreads();

        // ---- S3: the rows below on the panel's columns (each warp its own
        // rows: lane p's value, scaled, is l_i of pivot p), and the panel
        // rows left of the panel (one column a thread) --------------------
        float keep[RA];
        sfor<RA>([&](auto a_) { keep[decltype(a_)::value] = 0.0f; });
        for (int p = 0; p < nb; ++p) {
            const float r = rr[p];
            const float up = UP[p][l];
            sfor<RA>([&](auto a_) {
                constexpr int a = decltype(a_)::value;
                if constexpr (a >= a_hi) {
                    const float li = __fmul_rn(__shfl_sync(kFull, M[a][t], p), r);
                    keep[a] = l == p ? li : keep[a];
                    const float m0 = l == p ? 0.0f : M[a][t];
                    M[a][t] = __fsub_rn(m0, __fmul_rn(li, up));
                }
            });
        }
        sfor<RA>([&](auto a_) {
            constexpr int a = decltype(a_)::value;
            if constexpr (a >= a_hi) UT[w + W * a][l] = keep[a];
        });
        panel_rows_left(UT, UP, rr, j0, nb);
        __syncthreads();

        // ---- S4: the panel rows take their X; the rows below take the
        // deferred updates of the panel's pivots, in pivot order ------------
        sfor<RA>([&](auto a_) {
            constexpr int a = decltype(a_)::value;
            if constexpr (a >= a_lo && a < a_hi) {
                const int i = w + W * a;
                if (i < n) {
                    M[a][t] = D[i - j0][l];
                    sfor<t>([&](auto b_) {
                        constexpr int b = decltype(b_)::value;
                        M[a][b] = UT[l + 32 * b][i - j0];
                    });
                }
            }
        });
        if constexpr (a_hi < RA) {
            int c = 0;
            for (; c + 4 <= nb; c += 4) {
                float4 uk[RB];
                sfor<RB>([&](auto b_) {
                    constexpr int b = decltype(b_)::value;
                    if constexpr (b != t) uk[b] = ld4(&UT[l + 32 * b][c]);
                });
                sfor<RA>([&](auto a_) {
                    constexpr int a = decltype(a_)::value;
                    if constexpr (a >= a_hi) {
                        const float4 li = ld4(&UT[w + W * a][c]);
                        sfor<bmax(RB, a) + 1>([&](auto b_) {
                            constexpr int b = decltype(b_)::value;
                            if constexpr (b != t) {
                                float m = M[a][b];
                                m = __fsub_rn(m, __fmul_rn(li.x, uk[b].x));
                                m = __fsub_rn(m, __fmul_rn(li.y, uk[b].y));
                                m = __fsub_rn(m, __fmul_rn(li.z, uk[b].z));
                                m = __fsub_rn(m, __fmul_rn(li.w, uk[b].w));
                                M[a][b] = m;
                            }
                        });
                    }
                });
            }
            for (; c < nb; ++c) {
                float uk[RB];
                sfor<RB>([&](auto b_) {
                    constexpr int b = decltype(b_)::value;
                    if constexpr (b != t) uk[b] = UT[l + 32 * b][c];
                });
                sfor<RA>([&](auto a_) {
                    constexpr int a = decltype(a_)::value;
                    if constexpr (a >= a_hi) {
                        const float li = UT[w + W * a][c];
                        sfor<bmax(RB, a) + 1>([&](auto b_) {
                            constexpr int b = decltype(b_)::value;
                            if constexpr (b != t)
                                M[a][b] = __fsub_rn(M[a][b], __fmul_rn(li, uk[b]));
                        });
                    }
                });
            }
        }
        __syncthreads();
    });

    // ---- X, with its strictly upper part zero ---------------------------
    float* O = out + base;
    sfor<RA>([&](auto a_) {
        constexpr int a = decltype(a_)::value;
        const int i = w + W * a;
        if (i < n) {
            sfor<RB>([&](auto b_) {
                constexpr int b = decltype(b_)::value;
                const int k = l + 32 * b;
                if (k < n) {
                    float x = 0.0f;
                    if constexpr (b <= bmax(RB, a)) {
                        if (k <= i) x = M[a][b];
                    }
                    O[(size_t)i * n + k] = x;
                }
            });
        }
    });
}

// The wide variant's shared memory, in floats from the start of the dynamic
// buffer: D and UP (the panel's diagonal block and its u on the panel, as
// the register variants'), UT (32 x wide_ld(n), row p: u^(p) over every
// column k, the l_k below the panel and row p of X left of it) when it is
// kept there, rr, and the packed lower triangle when it is kept there.  UT's
// rows run to n rounded up to 8, so the last row tile reads inside them.
__host__ __device__ constexpr int wide_ld(int n) { return (n + 7) & ~7; }

__host__ __device__ constexpr size_t wide_smem_bytes(int n, bool tri_shared, bool ut_shared)
{
    return sizeof(float) * (2 * 32 * kLd + 32 + (ut_shared ? 32 * (size_t)wide_ld(n) : 0)
                            + (tri_shared ? (size_t)n * (n + 1) / 2 : 0));
}

static_assert(wide_smem_bytes(kSmemMaxN, true, true) <= kSmemOptin &&
              wide_smem_bytes(kSmemMaxN + 1, true, true) > kSmemOptin,
              "kSmemMaxN is the last n whose triangle fits in shared memory");
static_assert(wide_smem_bytes(kUTSmemMaxN, false, true) <= kSmemOptin &&
              wide_smem_bytes(kUTSmemMaxN + 1, false, true) > kSmemOptin,
              "kUTSmemMaxN is the last n whose UT fits in shared memory");
static_assert(kTR == 2 * kTC, "the trailing tiles' count below assumes kTR = 2 kTC");

// S2 of the wide variant: one warp sweeps the diagonal block D (nb x nb)
// alone, with factor_panel's operations, but in a loop over the pivots with
// each lane's row of D in shared memory (factor_panel's unrolled sweep, a
// different body for each pivot, was slower here and made S3 half again
// slower beside it; PERF.md).  Pivot p: every lane forms r = 1 / sqrt(D[p][p])
// itself and its own entry of u^(p) (X[p][l] = D[p][l] r left of p, r, l_l =
// D[l][p] r below), which goes to UP[p][l]; each row below p then takes
// D[l][k] -= l_l u_k, its column p restarted from 0, all of its loads issued
// before its stores.
__device__ __forceinline__ void wide_factor_panel(float (*D)[kLd], float (*UP)[kLd],
                                                  float* rr, int nb)
{
    const int l = threadIdx.x & 31;
    for (int p = 0; p < nb; ++p) {
        const float dpp = D[p][p], left = D[p][l], below = D[l][p];
        const float r = __fdiv_rn(1.0f, __fsqrt_rn(dpp));
        const float u = l < p ? __fmul_rn(left, r) : l == p ? r : __fmul_rn(below, r);
        UP[p][l] = u;
        if (l == 0) rr[p] = r;
        __syncwarp();
        if (l <= p) {
            D[p][l] = u;
        } else {
            float4 d[8], v[8];
#pragma unroll
            for (int q = 0; q < 8; ++q) {
                d[q] = ld4(&D[l][4 * q]);
                v[q] = ld4(&UP[p][4 * q]);
            }
#pragma unroll
            for (int q = 0; q < 8; ++q) {
                const int c = 4 * q;
                st4(&D[l][c], __fsub_rn(c == p ? 0.0f : d[q].x, __fmul_rn(u, v[q].x)),
                    __fsub_rn(c + 1 == p ? 0.0f : d[q].y, __fmul_rn(u, v[q].y)),
                    __fsub_rn(c + 2 == p ? 0.0f : d[q].z, __fmul_rn(u, v[q].z)),
                    __fsub_rn(c + 3 == p ? 0.0f : d[q].w, __fmul_rn(u, v[q].w)));
            }
        }
        __syncwarp();
    }
}

// S3, one row i below the panel (nb = 32) on the panel's columns, in
// registers: pivot p's l_i is the row's entry in column p times r_p, kept
// in UT; then every column c takes l_i u^(p)_c (the entry in column p
// restarted from 0 first, as the sweep restarts M[i][j]).
template <class RowOf>
__device__ __forceinline__ void wide_row_below(const RowOf& row_of, int i, int j0,
                                               const float (*UP)[kLd], const float* rr,
                                               float* UT, int ld)
{
    float* row = row_of(i) + j0;
    float m[32];
    sfor<32>([&](auto c_) { m[decltype(c_)::value] = row[decltype(c_)::value]; });
    sfor<32>([&](auto p_) {
        constexpr int p = decltype(p_)::value;
        const float li = __fmul_rn(m[p], rr[p]);
        UT[p * ld + i] = li;
        m[p] = 0.0f;
        sfor<8>([&](auto q_) {
            constexpr int q = decltype(q_)::value;
            const float4 v = ld4(&UP[p][4 * q]);
            m[4 * q] = __fsub_rn(m[4 * q], __fmul_rn(li, v.x));
            m[4 * q + 1] = __fsub_rn(m[4 * q + 1], __fmul_rn(li, v.y));
            m[4 * q + 2] = __fsub_rn(m[4 * q + 2], __fmul_rn(li, v.z));
            m[4 * q + 3] = __fsub_rn(m[4 * q + 3], __fmul_rn(li, v.w));
        });
    });
    sfor<32>([&](auto c_) { row[decltype(c_)::value] = m[decltype(c_)::value]; });
}

// S3, one column k < j0 of the panel rows: the forward substitution down
// the panel (panel_rows_left's, on the triangle): row p of X is the
// entry times r_p, which then leaves l_c^(p) X[p][k] from each row c > p.
// X goes into UT, from which wide_rows_out writes the panel rows out.
template <class RowOf>
__device__ __forceinline__ void wide_panel_left(const RowOf& row_of, int k, int j0, int nb,
                                                const float (*UP)[kLd], const float* rr,
                                                float* UT, int ld)
{
    float col[32];
    sfor<32>([&](auto c_) {
        constexpr int c = decltype(c_)::value;
        col[c] = c < nb ? row_of(j0 + c)[k] : 0.0f;
    });
    sfor<32>([&](auto p_) {
        constexpr int p = decltype(p_)::value;
        if (p < nb) {
            const float x = __fmul_rn(col[p], rr[p]);
            col[p] = x;
            sfor<8>([&](auto q_) {
                constexpr int q = decltype(q_)::value;
                if constexpr (4 * q + 3 > p) {
                    const float4 v = ld4(&UP[p][4 * q]);
                    const float u[4] = {v.x, v.y, v.z, v.w};
                    sfor<4>([&](auto e_) {
                        constexpr int c = 4 * q + decltype(e_)::value;
                        if constexpr (c > p) col[c] = __fsub_rn(col[c], __fmul_rn(u[c - 4 * q], x));
                    });
                }
            });
        }
    });
    sfor<32>([&](auto c_) {
        constexpr int c = decltype(c_)::value;
        if (c < nb) UT[c * ld + k] = col[c];
    });
}

// S4, one tile: rows i0 .. i0 + kTR - 1 (below the panel) by columns
// c0 .. c0 + kTC - 1 (left of the panel or right of it), loaded once,
// updated by the panel's 32 pivots in ascending order (l_i from UT row p
// at i, u_k at k: two 16-byte loads of l and one of u a pivot), stored
// once.  Entries past row n or above the diagonal are neither loaded nor
// stored.
template <class RowOf>
__device__ __forceinline__ void wide_tile(const RowOf& row_of, int i0, int c0, int n,
                                          const float* UT, int ld)
{
    float acc[kTR][kTC];
    sfor<kTR>([&](auto r_) {
        constexpr int r = decltype(r_)::value;
        const int i = i0 + r;
        sfor<kTC>([&](auto c_) {
            constexpr int c = decltype(c_)::value;
            acc[r][c] = (i < n && c0 + c <= i) ? row_of(i)[c0 + c] : 0.0f;
        });
    });
#pragma unroll 4
    for (int p = 0; p < 32; ++p) {
        const float* up = UT + p * ld;
        float li[kTR], uk[kTC];
        sfor<kTR / 4>([&](auto h_) {
            constexpr int h = decltype(h_)::value;
            const float4 v = ld4(up + i0 + 4 * h);
            li[4 * h] = v.x; li[4 * h + 1] = v.y; li[4 * h + 2] = v.z; li[4 * h + 3] = v.w;
        });
        sfor<kTC / 4>([&](auto h_) {
            constexpr int h = decltype(h_)::value;
            const float4 v = ld4(up + c0 + 4 * h);
            uk[4 * h] = v.x; uk[4 * h + 1] = v.y; uk[4 * h + 2] = v.z; uk[4 * h + 3] = v.w;
        });
        sfor<kTR>([&](auto r_) {
            constexpr int r = decltype(r_)::value;
            sfor<kTC>([&](auto c_) {
                constexpr int c = decltype(c_)::value;
                acc[r][c] = __fsub_rn(acc[r][c], __fmul_rn(li[r], uk[c]));
            });
        });
    }
    sfor<kTR>([&](auto r_) {
        constexpr int r = decltype(r_)::value;
        const int i = i0 + r;
        sfor<kTC>([&](auto c_) {
            constexpr int c = decltype(c_)::value;
            if (i < n && c0 + c <= i) row_of(i)[c0 + c] = acc[r][c];
        });
    });
}

// S4 over a set of tiles of rows r0 .. r1 - 1 (r0 a multiple of 32, r1 one
// too or n), dealt in turn to nt threads from the t-th: each row tile takes
// the L column tiles left of the panel and, when c0 >= 0, those from column
// c0 (<= r0) to its diagonal, D0 + 2 (a + 1) for row tile a with D0 = (r0 -
// c0) / kTC; so C(a) = a (L + D0 + a + 1) tiles come before row tile a.
template <class RowOf>
__device__ __forceinline__ void wide_update(const RowOf& row_of, int r0, int r1, int L, int c0,
                                            int n, const float* UT, int ld, int t, int nt)
{
    const int R = (r1 - r0 + kTR - 1) / kTR;
    if (c0 < 0) {
        for (int q = t; q < R * L; q += nt)
            wide_tile(row_of, r0 + kTR * (q / L), kTC * (q % L), n, UT, ld);
        return;
    }
    const int Lp = L + (r0 - c0) / kTC;
    for (int q = t; q < R * (Lp + R + 1); q += nt) {
        int a = (int)((sqrtf((float)((Lp + 1) * (Lp + 1) + 4 * q)) - (float)(Lp + 1)) * 0.5f);
        while (a > 0 && a * (Lp + a + 1) > q) --a;
        while ((a + 1) * (Lp + a + 2) <= q) ++a;
        const int b = q - a * (Lp + a + 1);
        wide_tile(row_of, r0 + kTR * a, b < L ? kTC * b : c0 + kTC * (b - L), n, UT, ld);
    }
}

// S1, by one warp: the diagonal block of the panel at j0 (nb pivots) into D,
// zero above its diagonal and past nb, from the rows row_of gives
template <class RowOf>
__device__ __forceinline__ void wide_load_block(const RowOf& row_of, float (*D)[kLd],
                                                int j0, int nb)
{
    const int c = threadIdx.x & 31;
    for (int r = 0; r < 32; ++r)
        D[r][c] = (r < nb && c <= r) ? row_of(j0 + r)[j0 + c] : 0.0f;
    __syncwarp();
}

// The panel rows j0 .. j0 + nb - 1 are final: their X left of the panel,
// from UT, and (kShared) the rest of each row with its strictly upper part
// zero, into out, by nt threads from the t-th (nt a multiple of 32)
template <bool kShared, class RowOf>
__device__ __forceinline__ void wide_rows_out(const RowOf& row_of, float* O, const float* UT,
                                              int ld, int j0, int nb, int n, int t, int nt)
{
    for (int r = t >> 5; r < nb; r += nt >> 5) {
        const int i = j0 + r;
        for (int k = t & 31; k < (kShared ? n : j0); k += 32)
            O[(size_t)i * n + k] = k < j0 ? UT[r * ld + k] : k <= i ? row_of(i)[k] : 0.0f;
    }
}

// n > kRegMaxN: the blocked sweep, one block of kWideThreads per matrix,
// the triangle in shared memory (kShared) or in place in out, UT in shared
// memory or (kUTGlobal) in the workspace ut_ws, 32 wide_ld(n) floats a
// matrix.  Warp 0 runs each panel's S1 and S2 beside the rest of the
// block: the first panel's beside the load, the next panel's beside this
// panel's S4.
template <bool kShared, bool kUTGlobal>
__global__ void __launch_bounds__(kWideThreads, 1)
chol_tri_inv_wide_kernel(const float* __restrict__ H, float* out, float* ut_ws, int n)
{
    static_assert(!(kShared && kUTGlobal), "the triangle in shared memory keeps UT there");
    extern __shared__ __align__(16) float smem[];
    float (*const D)[kLd] = reinterpret_cast<float (*)[kLd]>(smem);
    float (*const UP)[kLd] = reinterpret_cast<float (*)[kLd]>(smem + 32 * kLd);
    const int ld = wide_ld(n);
    float* const UT = kUTGlobal ? ut_ws + (size_t)blockIdx.x * 32 * ld : smem + 64 * kLd;
    float* const rr = kUTGlobal ? smem + 64 * kLd : UT + 32 * ld;
    float* const P = rr + 32;      // the packed triangle, row i at i (i + 1) / 2
    const int tid = threadIdx.x, w = tid >> 5;
    const size_t base = (size_t)blockIdx.x * (size_t)n * (size_t)n;
    const float* A = H + base;
    float* O = out + base;
    auto row_of = [=](int i) -> float* {
        return kShared ? P + (size_t)i * (i + 1) / 2 : O + (size_t)i * n;
    };

    if (w == 0) {
        // ---- S1, S2 of the first panel, from the input ------------------
        wide_load_block([=](int i) { return A + (size_t)i * n; }, D, 0, 32);
        wide_factor_panel(D, UP, rr, 32);
    } else {
        // the lower triangle in; in place, the strictly upper part of out
        // is zeroed here and never touched again.  UT starts at 0 (its
        // padding is read by the last row tile, and never reaches a stored
        // entry).
        for (int i = w - 1; i < n; i += kWideThreads / 32 - 1) {
            float* row = row_of(i);
            for (int k = tid & 31; k < n; k += 32) {
                if (k <= i) row[k] = A[(size_t)i * n + k];
                else if (!kShared) row[k] = 0.0f;
            }
        }
        for (int e = tid - 32; e < 32 * ld; e += kWideThreads - 32) UT[e] = 0.0f;
    }
    __syncthreads();

    int j0 = 0;
    for (;; j0 += 32) {
        const int nb = n - j0 < 32 ? n - j0 : 32;
        const int j1 = j0 + nb;
        const int L = j0 / kTC;     // column tiles left of the panel

        // ---- S3: the panel's block of X back; each row below on the
        // panel's columns, each column left of the panel down the panel
        // rows, one a thread -----------------------------------------------
        for (int e = tid; e < 32 * 32; e += kWideThreads) {
            const int r = e >> 5, c = e & 31;
            if (r < nb && c <= r) row_of(j0 + r)[j0 + c] = D[r][c];
        }
        for (int u = tid; u < n - nb; u += kWideThreads) {
            if (u < j0) wide_panel_left(row_of, u, j0, nb, UP, rr, UT, ld);
            else wide_row_below(row_of, j1 + u - j0, j0, UP, rr, UT, ld);
        }
        __syncthreads();
        if (j1 == n) break;

        // ---- S4, the deferred update of the rows below, beside the next
        // panel (j1 .. j2): warp 0 updates its diagonal block, then runs
        // its S1 and S2; the warps outside warp 0's scheduler update the
        // rest; warps 4, 8, ... (which share it) write this panel's rows
        // out ---------------------------------------------------------------
        const int j2 = n - j1 < 32 ? n : j1 + 32;
        if (w == 0) {
            wide_update(row_of, j1, j2, 0, j1, n, UT, ld, tid, 32);
            __syncwarp();
            wide_load_block(row_of, D, j1, j2 - j1);
            wide_factor_panel(D, UP, rr, j2 - j1);
        } else if (w % 4 != 0) {
            const int t = (w - w / 4 - 1) * 32 + (tid & 31), nt = kWideThreads / 4 * 3;
            wide_update(row_of, j1, j2, L, -1, n, UT, ld, t, nt);
            if (j2 < n) wide_update(row_of, j2, n, L, j1, n, UT, ld, t, nt);
        } else {
            wide_rows_out<kShared>(row_of, O, UT, ld, j0, nb, n, (w / 4 - 1) * 32 + (tid & 31),
                                   kWideThreads / 4 - 32);
        }
        __syncthreads();
    }
    wide_rows_out<kShared>(row_of, O, UT, ld, j0, n - j0, n, tid, kWideThreads);
}

// n = 1: one thread a matrix
__global__ void chol_tri_inv_1x1_kernel(const float* __restrict__ H,
                                        float* __restrict__ out, int G)
{
    const int g = blockIdx.x * blockDim.x + threadIdx.x;
    if (g < G) out[g] = __fdiv_rn(1.0f, __fsqrt_rn(H[g]));
}

// ---- The grid variant, n >= kGridMinN ----------------------------------

constexpr int kGridThreads = 128;
constexpr int kGT = 64;   // the grid variant's S4 block tile: kGT x kGT entries
static_assert((kGT / kTR) * (kGT / kTC) == kGridThreads, "one kTR x kTC tile a thread");

// Floats of the grid variant's workspace a matrix: UT (32 x wide_ld(n)),
// then UP (32 x kLd) and rr (32), each 16-byte aligned
__host__ __device__ constexpr size_t grid_ws_floats(int n)
{
    return 32 * (size_t)wide_ld(n) + 32 * kLd + 32;
}

// row i of a matrix kept in place in out
struct OutRows {
    float* O;
    int n;
    __device__ float* operator()(int i) const { return O + (size_t)i * n; }
};

constexpr int kS3Lines = 8;   // the grid variant's S3 lines a task, two a warp

// S3 of the grid variant, one row i below the panel (nb = 32) by one warp:
// lane c holds the row's entry in the panel's column c.  Pivot p's l_i is
// lane p's entry times r_p (shuffled to the warp), kept in UT; then every
// lane takes l_i u^(p)_c, lane p's entry restarted from 0 first: the
// operations of wide_row_below, entry for entry, in registers of 32 lanes
// instead of one thread's 32.
__device__ __forceinline__ void grid_row_below(float* row, int i, const float (*UP)[kLd],
                                               const float* rr, float* UT, int ld)
{
    const int lane = threadIdx.x & 31;
    float m = row[lane], keep = 0.0f;
#pragma unroll 8
    for (int p = 0; p < 32; ++p) {
        const float li = __fmul_rn(__shfl_sync(kFull, m, p), rr[p]);
        keep = lane == p ? li : keep;
        m = __fsub_rn(lane == p ? 0.0f : m, __fmul_rn(li, UP[p][lane]));
    }
    row[lane] = m;
    UT[lane * ld + i] = keep;
}

// S3 of the grid variant, one column k left of the panel by one warp: lane
// c holds panel row c's entry; pivot p's X[p][k] is lane p's entry times
// r_p, which then leaves UP[p][c] X[p][k] from each lane c > p (the forward
// substitution of wide_panel_left).  The column of X goes into UT for S4
// and into the triangle.
template <class RowOf>
__device__ __forceinline__ void grid_panel_left(const RowOf& row_of, int k, int j0, int nb,
                                                const float (*UP)[kLd], const float* rr,
                                                float* UT, int ld)
{
    const int lane = threadIdx.x & 31;
    float col = lane < nb ? row_of(j0 + lane)[k] : 0.0f;
#pragma unroll 8
    for (int p = 0; p < 32; ++p) {
        if (p < nb) {
            const float x = __fmul_rn(__shfl_sync(kFull, col, p), rr[p]);
            col = lane == p ? x : lane > p ? __fsub_rn(col, __fmul_rn(UP[p][lane], x)) : col;
        }
    }
    if (lane < nb) {
        UT[lane * ld + k] = col;
        row_of(j0 + lane)[k] = col;
    }
}

// G matrices, n >= kGridMinN: the wide variant's stages over the whole card
// (see the note at the top), each matrix's triangle in place in out, its
// UT, UP and rr in ws (grid_ws_floats(n) floats a matrix).  Launched
// cooperatively with no more blocks than are co-resident.
__global__ void __launch_bounds__(kGridThreads, 2)
chol_tri_inv_grid_kernel(const float* __restrict__ H, float* out, float* ws, int G, int n)
{
    cg::grid_group grid = cg::this_grid();
    __shared__ __align__(16) float D[32][kLd];     // a chain's diagonal block
    __shared__ __align__(16) float UP[32][kLd];    // u^(p) on the panel
    __shared__ __align__(16) float rr[32];         // r of each pivot
    __shared__ __align__(16) float Ls[32][kGT];    // a tile's l_i, pivot-major
    __shared__ __align__(16) float Us[32][kGT];    // a tile's u_k, pivot-major

    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
    const int nblk = gridDim.x, bid = blockIdx.x;
    const int ld = wide_ld(n);
    const size_t nn = (size_t)n * n, wsm = grid_ws_floats(n);
    constexpr int kWarps = kGridThreads / 32;
    auto rows = [=](int g) { return OutRows{out + (size_t)g * nn, n}; };
    auto ut = [=](int g) { return ws + (size_t)g * wsm; };

    // ---- the lower triangle in; the strictly upper part of out is zeroed
    // here and never touched again ------------------------------------------
    for (size_t r = (size_t)bid * kWarps + w; r < (size_t)G * n; r += (size_t)nblk * kWarps) {
        const size_t g = r / n;
        const int i = (int)(r - g * n);
        const float* a = H + g * nn + (size_t)i * n;
        float* o = out + g * nn + (size_t)i * n;
        for (int k = lane; k < n; k += 32) o[k] = k <= i ? a[k] : 0.0f;
    }
    grid.sync();

    // A chain: the panel jA .. jB - 1 of matrix g.  When jP >= 0, its
    // diagonal block first takes the update of the panel at jP (whose l
    // and u are in UT) into D, by the whole block; then warp 0 runs its S2
    // (and, for the first panel, its S1), publishes UP and rr and writes its
    // block of X into the triangle.
    auto chain = [&](int g, int jA, int jB, int jP) {
        const OutRows row = rows(g);
        float* const UT = ut(g);
        const int nbA = jB - jA;
        __syncthreads();
        if (jP >= 0) {
            // the block's 32 x 32 l of the panel at jP staged in Ls; each
            // thread's entries D[w + 4 k][lane] (k < 8) take its pivots in
            // ascending order straight into D, zero above the diagonal and
            // past nbA (S1 in the same pass)
            for (int e = tid; e < 32 * 32; e += kGridThreads) {
                const int p = e >> 5, x = e & 31;
                Ls[p][x] = x < nbA ? UT[p * ld + jA + x] : 0.0f;
            }
            __syncthreads();
            float acc[8];
            sfor<8>([&](auto k_) {
                constexpr int k = decltype(k_)::value;
                const int r = w + 4 * k;
                acc[k] = r < nbA && lane <= r ? row(jA + r)[jA + lane] : 0.0f;
            });
            for (int p = 0; p < 32; ++p) {
                const float u = Ls[p][lane];
                sfor<8>([&](auto k_) {
                    constexpr int k = decltype(k_)::value;
                    acc[k] = __fsub_rn(acc[k], __fmul_rn(Ls[p][w + 4 * k], u));
                });
            }
            sfor<8>([&](auto k_) {
                constexpr int k = decltype(k_)::value;
                const int r = w + 4 * k;
                D[r][lane] = r < nbA && lane <= r ? acc[k] : 0.0f;
            });
            __syncthreads();
        }
        if (w == 0) {
            if (jP < 0) wide_load_block(row, D, jA, nbA);
            wide_factor_panel(D, UP, rr, nbA);
            float* const UPg = UT + 32 * ld;
            for (int e = lane; e < 32 * kLd; e += 32) UPg[e] = (&UP[0][0])[e];
            UPg[32 * kLd + lane] = rr[lane];
            for (int r = 0; r < nbA; ++r)
                if (lane <= r) row(jA + r)[jA + lane] = D[r][lane];
        }
    };

    // An S4 tile: q-th of the panel j0 .. j1 - 1's tiles of matrix g: first
    // R x Lc tiles of the rows below by the columns left of the panel, then
    // the trailing triangle's R (R + 1) / 2 tiles from column j1, of which
    // the rows above j2 (the next panel's diagonal block, the chain's) are
    // left out.
    auto tile = [&](int g, long long q, int j0, int j1, int j2, int R, int Lc) {
        float* const UT = ut(g);
        const OutRows row = rows(g);
        const bool left = q < (long long)R * Lc;
        int a, b;
        if (left) {
            a = (int)(q / Lc);
            b = (int)(q - (long long)a * Lc);
        } else {
            const int t = (int)(q - (long long)R * Lc);
            a = (int)((sqrtf(8.0f * (float)t + 1.0f) - 1.0f) * 0.5f);
            while (a > 0 && a * (a + 1) / 2 > t) --a;
            while ((a + 1) * (a + 2) / 2 <= t) ++a;
            b = t - a * (a + 1) / 2;
        }
        const int r0 = j1 + kGT * a, c0 = (left ? 0 : j1) + kGT * b;
        const int cend = left ? j0 : n;   // the tile's columns end before cend
        __syncthreads();
        for (int e = tid; e < 32 * kGT; e += kGridThreads) {
            const int p = e / kGT, x = e % kGT;
            Ls[p][x] = r0 + x < n ? UT[p * ld + r0 + x] : 0.0f;
            Us[p][x] = c0 + x < cend ? UT[p * ld + c0 + x] : 0.0f;
        }
        __syncthreads();
        const int tr = tid / (kGT / kTC), tc = tid % (kGT / kTC);
        const int i0 = r0 + kTR * tr, k0 = c0 + kTC * tc;
        auto takes = [&](int i, int k) {
            return i < n && k < cend && (left || (k <= i && i >= j2));
        };
        float acc[kTR][kTC];
        sfor<kTR>([&](auto r_) {
            constexpr int r = decltype(r_)::value;
            sfor<kTC>([&](auto c_) {
                constexpr int c = decltype(c_)::value;
                acc[r][c] = takes(i0 + r, k0 + c) ? row(i0 + r)[k0 + c] : 0.0f;
            });
        });
#pragma unroll 4
        for (int p = 0; p < 32; ++p) {
            const float4 l0 = ld4(&Ls[p][kTR * tr]), l1 = ld4(&Ls[p][kTR * tr + 4]);
            const float4 u = ld4(&Us[p][kTC * tc]);
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
        sfor<kTR>([&](auto r_) {
            constexpr int r = decltype(r_)::value;
            sfor<kTC>([&](auto c_) {
                constexpr int c = decltype(c_)::value;
                if (takes(i0 + r, k0 + c)) row(i0 + r)[k0 + c] = acc[r][c];
            });
        });
    };

    // ---- S1, S2 of the first panel -------------------------------------
    split_tasks(G, 0, [&](int g) { chain(g, 0, n < 32 ? n : 32, -1); }, [](long long) {});
    grid.sync();

    int j0 = 0;
    for (;; j0 += 32) {
        const int nb = n - j0 < 32 ? n - j0 : 32;
        const int j1 = j0 + nb;

        // ---- X: S3, one warp a line, kS3Lines lines of one matrix a task;
        // a block reads a matrix's UP and rr once for its run of tasks -----
        const int lines = n - nb, chunks = (lines + kS3Lines - 1) / kS3Lines;
        int staged = -1;
        for (long long q = bid; q < (long long)G * chunks; q += nblk) {
            const int g = (int)(q / chunks);
            float* const UT = ut(g);
            if (g != staged) {
                const float* const UPg = UT + 32 * ld;
                __syncthreads();
                for (int e = tid; e < 32 * kLd; e += kGridThreads) (&UP[0][0])[e] = UPg[e];
                if (tid < 32) rr[tid] = UPg[32 * kLd + tid];
                __syncthreads();
                staged = g;
            }
            for (int u = (int)(q % chunks) * kS3Lines + w; u < lines &&
                 u < (int)(q % chunks + 1) * kS3Lines; u += kWarps) {
                if (u < j0) grid_panel_left(rows(g), u, j0, nb, UP, rr, UT, ld);
                else grid_row_below(rows(g)(j1 + u - j0) + j0, j1 + u - j0, UP, rr, UT, ld);
            }
        }
        grid.sync();
        if (j1 == n) break;

        // ---- Y: the next panel's chain beside S4 --------------------------
        const int j2 = n - j1 < 32 ? n : j1 + 32;
        const int R = (n - j1 + kGT - 1) / kGT, Lc = (j0 + kGT - 1) / kGT;
        const long long per = (long long)R * Lc + (long long)R * (R + 1) / 2;
        split_tasks(G, G * per, [&](int g) { chain(g, j1, j2, j0); },
                    [&](long long s) { tile((int)(s / per), s % per, j0, j1, j2, R, Lc); });
        grid.sync();
    }
}

using Launch = void (*)(const float*, float*, int, int, cudaStream_t);

template <int RA>
void launch(const float* H, float* out, int G, int n, cudaStream_t s)
{
    chol_tri_inv_panel_kernel<RA><<<G, 32 * W, 0, s>>>(H, out, n);
}

// the variant of p panels: whole panels of row tiles, up to n = kRegMaxN
template <int... P>
Launch variant(int panels, std::integer_sequence<int, P...>)
{
    constexpr int tpp = 32 / W, max_ra = (kRegMaxN + W - 1) / W;
    static const Launch fns[] = {
        launch<(tpp * (P + 1) < max_ra ? tpp * (P + 1) : max_ra)>...};
    return fns[panels - 1];
}

}  // namespace

// The grid variant's rule, measured on an H100 (PERF.md;
// tests/torch_port_large_kernels.py times both sides): its time grows with
// G while one block a matrix keeps about the same time up to one matrix an
// SM, and the grid variant is the faster up to 32 matrices at n = 512 (not
// at 48), 48 at n = 1,024 (not at 64) and 64 at n = 2,048 (not at 96).
// So it takes batches of at most 32 at every n past 302; n <= 302 stays
// with the earlier variants, under the yardstick there.
static bool grid_takes(int G, int n)
{
    return n >= kGridMinN && G <= kGridMaxG;
}

// Floats of device workspace a launch of G matrices of size n needs (0
// where no variant that runs keeps anything there).
extern "C" long long chol_tri_inv_workspace_floats(int G, int n)
{
    if (G <= 0 || n <= 0) return 0;
    if (grid_takes(G, n)) return (long long)G * (long long)grid_ws_floats(n);
    return n > kUTSmemMaxN ? (long long)G * 32LL * wide_ld(n) : 0;
}

// The variant chol_tri_inv_f32 runs for G matrices of size n.
extern "C" const char* chol_tri_inv_variant(int G, int n)
{
    if (G <= 0 || n <= 0) return "none";
    if (n == 1) return "1x1";
    if (n <= kRegMaxN) return "registers";
    if (n <= kSmemMaxN) return "wide, triangle in shared memory";
    if (grid_takes(G, n)) return "grid";
    return n <= kUTSmemMaxN ? "wide, triangle in device memory"
                            : "wide, triangle and UT in device memory";
}
// Lets the wide variant's instances take their shared memory (above the
// 48 KB default) on the current device; call once per device before the
// first launch there.  Returns the CUDA error (0 on success).
extern "C" int chol_tri_inv_prepare()
{
    const cudaError_t e = cudaFuncSetAttribute(chol_tri_inv_wide_kernel<true, false>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)wide_smem_bytes(kSmemMaxN, true, true));
    if (e != cudaSuccess) return (int)e;
    return (int)cudaFuncSetAttribute(chol_tri_inv_wide_kernel<false, false>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)wide_smem_bytes(kUTSmemMaxN, false, true));
}

// The grid variant's cooperative launch: as many blocks as are co-resident
// on the current device, and no more than the widest stage (the first
// panel's S4 tiles and chains) has tasks.  Returns the CUDA error.
static cudaError_t launch_grid(const float* H, float* out, float* ws, int G, int n,
                               cudaStream_t s)
{
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chol_tri_inv_grid_kernel,
                                                          kGridThreads, 0);
    if (e != cudaSuccess) return e;
    if (per_sm <= 0) return cudaErrorLaunchOutOfResources;
    const long long R = (n - 32 + kGT - 1) / kGT;
    const long long want = (long long)G * (1 + R * (R + 1) / 2);
    const long long blocks = want < (long long)per_sm * sms ? want : (long long)per_sm * sms;
    void* args[] = {(void*)&H, (void*)&out, (void*)&ws, (void*)&G, (void*)&n};
    return cudaLaunchCooperativeKernel((const void*)chol_tri_inv_grid_kernel, dim3((int)blocks),
                                       dim3(kGridThreads), args, 0, s);
}

// H, out: (G, n, n) contiguous f32 on the device; ws: the workspace of
// chol_tri_inv_workspace_floats(G, n) floats (null where that is 0);
// stream: a cudaStream_t.  Returns the launch's error, else
// cudaGetLastError() after it (0 on success), or cudaErrorInvalidValue,
// without launching, when a workspace is needed and ws is null.
extern "C" int chol_tri_inv_f32(const float* H, float* out, int G, int n, float* ws,
                                void* stream)
{
    if (G <= 0 || n <= 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    if (n == 1) {
        chol_tri_inv_1x1_kernel<<<(G + 255) / 256, 256, 0, s>>>(H, out, G);
    } else if (n <= kRegMaxN) {
        constexpr int kPanels = (kRegMaxN + 31) / 32;
        variant((n + 31) / 32, std::make_integer_sequence<int, kPanels>())(H, out, G, n, s);
    } else if (n <= kSmemMaxN) {
        chol_tri_inv_wide_kernel<true, false>
            <<<G, kWideThreads, wide_smem_bytes(n, true, true), s>>>(H, out, nullptr, n);
    } else if (grid_takes(G, n)) {
        if (ws == nullptr) return (int)cudaErrorInvalidValue;
        const cudaError_t e = launch_grid(H, out, ws, G, n, s);
        if (e != cudaSuccess) {
            cudaGetLastError();
            return (int)e;
        }
    } else if (n <= kUTSmemMaxN) {
        chol_tri_inv_wide_kernel<false, false>
            <<<G, kWideThreads, wide_smem_bytes(n, false, true), s>>>(H, out, nullptr, n);
    } else {
        if (ws == nullptr) return (int)cudaErrorInvalidValue;
        chol_tri_inv_wide_kernel<false, true>
            <<<G, kWideThreads, wide_smem_bytes(n, false, false), s>>>(H, out, ws, n);
    }
    return (int)cudaGetLastError();
}
