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
// Wide variant, 240 < n <= 1024 (kMaxN; the double-track LMPC's QPs at the
// shipped learning horizons, n = 244 and 275): the same sweep unblocked,
// one block of 32 warps per matrix and one __syncthreads() a pivot.  The
// lower triangle lives packed in dynamic shared memory (n (n + 1) / 2
// floats, up to n = 336: 229,152 B with the pivot buffers, under the
// 232,448 B a block may take; the attribute is set once per device, by
// chol_tri_inv_prepare(), not per launch) or, above that, in place in the
// output buffer in device memory (one matrix at n = 1024 is 4 MB, resident
// in the 50 MB L2).  At pivot j warp w takes rows j + w, j + w + 32, ...;
// its lanes take the columns.  A double-buffered vector v holds pivot j's
// operands unscaled: row j (k <= j) and column j (i > j) of M.  Every
// thread forms r = 1 / sqrt(v[j]) itself, and each operand u_k = v[k] r
// (u_j = r) where it is used: the same two rounded operations, so the
// same bits, as the mirror's u.  The threads that update row j + 1 and
// column j + 1 also write those values into the other buffer, which is
// pivot j + 1's v; the barrier at the end of the pivot is the only one.
// Every element takes each pivot's multiply-subtract once, in pivot order,
// so the variant is bit-equal to the mirror as the register variants are.
// Its time is the n dependent pivots, each a pass over the trailing
// triangle: about a dozen instructions an element a pivot (two shared
// loads, the recomputed operand, the product, the difference, the store)
// where the register variants spend two, so it runs ~40x its one-SM floor
// at n = 275 (PERF.md; loading four columns at a time or keeping the
// operands in registers changed nothing measurable).  A register-tiled
// form is the way to speed it up.
// A non-positive pivot gives NaN through sqrt, which spreads through that
// matrix's rows from the bad pivot on — the IPM's step_ok guard relies on
// it (ipm.py:434-444).  Nothing traps or exits early, and no other matrix
// is touched.
//
// Bound on an H100 SXM (700 W): the lower triangle of each symmetric input
// read once and each dense output written once, 4 G (n(n+1)/2 + n^2)
// bytes over 3.35 TB/s, against 2/3 n^3 flops a matrix over 67 TFLOP/s of
// f32 outside the tensor cores: bytes at the main path's (256, 87, 87),
// 3.5 us.  At batch 1 one SM holds the matrix, whose arithmetic floor is
// 2/3 n^3 / (67 TFLOP/s / 132): 7 us at n = 175, 13 us at n = 216.  At
// batch 1 the one-warp panel sweeps (S2) and the shuffled row sweeps (S3)
// are the dependent chains; registers and spills of each variant: ptxas
// -v, printed by chip_smoke.py; times in PERF.md.

#include <cuda_runtime.h>

#include <type_traits>
#include <utility>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxN = 1024;      // the largest n the kernel takes
constexpr int kRegMaxN = 240;    // the register variants' largest n
constexpr int kSmemMaxN = 336;   // the wide variant's triangle in shared memory
constexpr int kWideThreads = 1024;
constexpr int kLd = 36;   // row stride of the shared panel arrays: 16-byte rows
constexpr int W = 8;      // warps a matrix: 256 threads

// f(integral_constant<int, 0>), ..., f(integral_constant<int, N - 1>):
// a loop whose index is a constant in each copy of the body
template <class F, int... I>
__device__ __forceinline__ void sfor_impl(F&& f, std::integer_sequence<int, I...>)
{
    (f(std::integral_constant<int, I>{}), ...);
}

template <int N, class F>
__device__ __forceinline__ void sfor(F&& f)
{
    sfor_impl(f, std::make_integer_sequence<int, N>{});
}

// the last 32-column tile that row tile a reaches
__host__ __device__ constexpr int bmax(int RB, int a)
{
    return (W * (a + 1) - 1) / 32 < RB - 1 ? (W * (a + 1) - 1) / 32 : RB - 1;
}

__device__ __forceinline__ float4 ld4(const float* p)
{
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d)
{
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
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

// the wide variant's dynamic shared memory: the two pivot buffers, and the
// packed lower triangle when it is kept there
__host__ __device__ constexpr size_t wide_smem_bytes(int n, bool in_shared)
{
    return sizeof(float) * (2 * (size_t)n + (in_shared ? (size_t)n * (n + 1) / 2 : 0));
}

// 240 < n <= kMaxN: the sweep with one barrier a pivot, M in shared memory
// (kShared) or in place in out
template <bool kShared>
__global__ void __launch_bounds__(kWideThreads, 1)
chol_tri_inv_wide_kernel(const float* __restrict__ H, float* out, int n)
{
    extern __shared__ __align__(16) float smem[];
    float* const P = smem + 2 * n;   // the packed triangle, row i at i (i + 1) / 2
    const int w = threadIdx.x >> 5, l = threadIdx.x & 31, nw = blockDim.x >> 5;
    const size_t base = (size_t)blockIdx.x * (size_t)n * (size_t)n;
    const float* A = H + base;
    float* O = out + base;
    auto row_of = [&](int i) -> float* {
        return kShared ? P + (size_t)i * (i + 1) / 2 : O + (size_t)i * n;
    };

    // the lower triangle in; in place, the strictly upper part of out is
    // zeroed here and never touched again.  Pivot 0's v is column 0.
    for (int i = w; i < n; i += nw) {
        float* row = row_of(i);
        for (int k = l; k < n; k += 32) {
            const float x = k <= i ? A[(size_t)i * n + k] : 0.0f;
            if (k <= i || !kShared) row[k] = x;
            if (k == 0) smem[i] = x;
        }
    }
    __syncthreads();

    for (int j = 0; j < n; ++j) {
        const float* vc = smem + (j & 1) * n;        // pivot j's operands
        float* vn = smem + ((j + 1) & 1) * n;        // pivot j + 1's
        const float r = __fdiv_rn(1.0f, __fsqrt_rn(vc[j]));   // NaN if not PD
        for (int i = j + w; i < n; i += nw) {
            float* row = row_of(i);
            if (i == j) {
                // row j of X is final: u_k (k < j) and r
                for (int k = l; k <= j; k += 32)
                    row[k] = k < j ? __fmul_rn(vc[k], r) : r;
                continue;
            }
            const float li = __fmul_rn(vc[i], r);
            for (int k = l; k <= i; k += 32) {
                const float uk = k == j ? r : __fmul_rn(vc[k], r);
                const float x = __fsub_rn(k == j ? 0.0f : row[k], __fmul_rn(li, uk));
                row[k] = x;
                if (i == j + 1) vn[k] = x;            // row j + 1
                else if (k == j + 1) vn[i] = x;       // column j + 1
            }
        }
        __syncthreads();
    }

    if (kShared) {
        for (int i = w; i < n; i += nw) {
            const float* row = row_of(i);
            for (int k = l; k < n; k += 32)
                O[(size_t)i * n + k] = k <= i ? row[k] : 0.0f;
        }
    }
}

// n = 1: one thread a matrix
__global__ void chol_tri_inv_1x1_kernel(const float* __restrict__ H,
                                        float* __restrict__ out, int G)
{
    const int g = blockIdx.x * blockDim.x + threadIdx.x;
    if (g < G) out[g] = __fdiv_rn(1.0f, __fsqrt_rn(H[g]));
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

// The largest n the kernel takes; the wrapper reads it from here.
extern "C" int chol_tri_inv_max_n() { return kMaxN; }

// Lets the wide variant take its shared memory (above the 48 KB default) on
// the current device; call once per device before the first launch there.
// Returns the CUDA error (0 on success).
extern "C" int chol_tri_inv_prepare()
{
    return (int)cudaFuncSetAttribute(chol_tri_inv_wide_kernel<true>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)wide_smem_bytes(kSmemMaxN, true));
}

// H, out: (G, n, n) contiguous f32 on the device; stream: a cudaStream_t.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue, without launching, for n > kMaxN (there is no
// variant to launch).
extern "C" int chol_tri_inv_f32(const float* H, float* out, int G, int n,
                                void* stream)
{
    if (G <= 0 || n <= 0) return 0;
    if (n > kMaxN) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    if (n == 1) {
        chol_tri_inv_1x1_kernel<<<(G + 255) / 256, 256, 0, s>>>(H, out, G);
    } else if (n <= kRegMaxN) {
        constexpr int kPanels = (kRegMaxN + 31) / 32;
        variant((n + 31) / 32, std::make_integer_sequence<int, kPanels>())(H, out, G, n, s);
    } else if (n <= kSmemMaxN) {
        chol_tri_inv_wide_kernel<true><<<G, kWideThreads, wide_smem_bytes(n, true), s>>>(
            H, out, n);
    } else {
        chol_tri_inv_wide_kernel<false><<<G, kWideThreads, wide_smem_bytes(n, false), s>>>(
            H, out, n);
    }
    return (int)cudaGetLastError();
}
