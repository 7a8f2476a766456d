// grid_barrier.cuh — the grid-wide barrier of the cooperative launches
// (spanner_fold_k2.cu's chain, unionfind_fixpoint.cu's fixpoints).
//
// Every block of a cooperative launch meets at the barrier: what each
// thread wrote before it is visible to every thread after it. One thread
// a block does a release add on a counter in device memory and spins on
// an acquire load until the counter reaches the grid's blocks times the
// barriers met; the block barriers before and after order the other
// threads with it. The counter starts at 0 (the caller clears it before
// the launch), so it ends at the grid's blocks times the barriers met.
// Data written before a barrier by another SM is read after it past L1
// (__ldcg) or by an atomic: L1 is not coherent between SMs.

#pragma once

#include <stdint.h>

__device__ __forceinline__ unsigned load_acquire(const unsigned* x) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                 : "=r"(v) : "l"(x) : "memory");
    return v;
}

// `target` is the block's own count of the arrivals it waits for; every
// thread of the block keeps the same value.
__device__ __forceinline__ void grid_barrier(unsigned* bar,
                                             unsigned& target) {
    __syncthreads();
    target += gridDim.x;
    if (threadIdx.x == 0) {
        asm volatile("red.release.gpu.global.add.u32 [%0], %1;"
                     :: "l"(bar), "r"(1u) : "memory");
        while (static_cast<int>(load_acquire(bar) - target) < 0) {
        }
    }
    __syncthreads();
}
