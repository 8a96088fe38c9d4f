// Device helpers shared by the port's kernels (chol_tri_inv.cu,
// gj_inverse.cu): the unrolled loop, 16-byte loads and stores, and the task
// split of the grid variants' stages.  Each kernel source is one
// translation unit, so everything here has internal linkage.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>
#include <utility>

namespace {

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

__device__ __forceinline__ float4 ld4(const float* p)
{
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d)
{
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// The tasks of a grid stage that has one chain task a matrix (G of them, or
// 0) and nother other tasks: with more blocks than matrices, block g < G
// runs matrix g's chain alone and the other blocks share the rest; else
// every block takes tasks in turn, the chains first.
template <class Chain, class Other>
__device__ __forceinline__ void split_tasks(int G, long long nother, const Chain& chain,
                                            const Other& other)
{
    const int nblk = gridDim.x, bid = blockIdx.x;
    // one loop, each task's body at one place in the code
    const bool alone = nblk > G && bid < G;   // a chain's block, which runs nothing else
    const long long stride = nblk > G ? nblk - G : nblk;
    for (long long q = bid; q < G + nother; q += stride) {
        if (q < G) chain((int)q);
        else other(q - G);
        if (alone) break;
    }
}

}  // namespace
