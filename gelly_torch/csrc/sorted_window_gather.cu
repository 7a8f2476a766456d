// sorted_window_gather — table[sidx] for SORTED sidx, windowed.
//
// Replaces the Pallas kernel gelly_tpu/ops/pallas_kernels.py:
// _sorted_gather_kernel (launched by sorted_window_gather). It returns
// exactly what that kernel returns, -1 lanes included:
//
//   * lanes are cut into tiles of `tile` consecutive entries of sidx;
//   * a tile's window start is clip(sidx[g*tile] / span, 0, nwb - 2),
//     span = 128 * wr table slots (wr = window rows, nwb = table rows / wr);
//     a negative first index clips to window 0;
//   * a lane whose index lies in [start*span, start*span + 2*span) (the
//     tile's two consecutive windows) gets table[idx], any other lane -1,
//     a negative index included.
//
// The TPU kernel keeps the window pair in VMEM and picks each element with
// a one-hot row-select matmul (Mosaic has no vector gather); the f32
// matmul is also where its 2^24 value bound comes from. Hopper gathers
// directly, so this kernel reads the i32 table values through the
// read-only cache and has no value bound of its own.
//
// Bound on an H100: memory. Per call it must read the L indices and write
// the L outputs (8 bytes a lane) plus the 32-byte table sectors the hit
// lanes touch; it does no arithmetic worth counting. At the path's shapes
// (L = 2^20, about one wave of threads) the time is latency: the count of
// dependent memory round trips each thread waits for. Design:
//
//   * each thread owns 4 consecutive lanes: one 16-byte load of their
//     indices and, in the same step, the load of their tile's first index
//     (every lane of a tile reads the same word, a broadcast);
//   * then 4 independent table loads and one 16-byte store: two dependent
//     trips per lane;
//   * a lane quad that straddles a tile or the end of sidx, or an index
//     or output view that is not 16-byte aligned, takes a scalar path with
//     the same two trips per lane.
//
// The window pair is not staged in shared memory: two windows are 128 KiB
// per tile, but a tile's hit lanes touch about 16 KiB of table sectors
// (sorted indices share sectors), so staging would move more bytes, not
// fewer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 4;  // consecutive lanes per thread

// Window pair [lo, lo + 2 span) of a tile whose first index is `first`.
__device__ __forceinline__ long long window_lo(int first, int span,
                                               int max_start) {
    // floor(first / span) clipped to [0, max_start]; a negative first
    // index clips to window 0 (floor and truncation agree after the clip).
    const int start = first < 0 ? 0 : min(first / span, max_start);
    return static_cast<long long>(start) * span;
}

__device__ __forceinline__ int pick(const int32_t* __restrict__ table,
                                    int idx, long long lo, long long hi) {
    return (idx >= lo && idx < hi) ? __ldg(table + idx) : -1;
}

__global__ void __launch_bounds__(kThreads)
sorted_window_gather_kernel(const int32_t* __restrict__ table,
                            const int32_t* __restrict__ sidx,
                            int32_t* __restrict__ out, long long n_lanes,
                            int tile, int span, int max_start) {
    const long long g0 =
        (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) *
        kLanes;
    if (g0 >= n_lanes) return;
    const bool aligned =
        ((reinterpret_cast<uintptr_t>(sidx) |
          reinterpret_cast<uintptr_t>(out)) & 15) == 0;
    if (aligned && tile % kLanes == 0 && g0 + kLanes <= n_lanes) {
        // g0 and tile are multiples of 4: the quad lies in one tile.
        const int first = __ldg(sidx + g0 / tile * tile);
        const int4 idx = __ldg(reinterpret_cast<const int4*>(sidx + g0));
        const long long lo = window_lo(first, span, max_start);
        const long long hi = lo + 2LL * span;
        int4 v;
        v.x = pick(table, idx.x, lo, hi);
        v.y = pick(table, idx.y, lo, hi);
        v.z = pick(table, idx.z, lo, hi);
        v.w = pick(table, idx.w, lo, hi);
        *reinterpret_cast<int4*>(out + g0) = v;
        return;
    }
#pragma unroll
    for (int e = 0; e < kLanes; ++e) {
        const long long g = g0 + e;
        if (g < n_lanes) {
            const int first = __ldg(sidx + g / tile * tile);
            const int idx = __ldg(sidx + g);
            const long long lo = window_lo(first, span, max_start);
            out[g] = pick(table, idx, lo, lo + 2LL * span);
        }
    }
}

}  // namespace

extern "C" int sorted_window_gather_launch(const void* table, const void* sidx,
                                           void* out, long long n_lanes,
                                           int tile, int span, int max_start,
                                           void* stream) {
    if (n_lanes <= 0) return 0;
    if (tile <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const long long per_block = static_cast<long long>(kThreads) * kLanes;
    const long long grid = (n_lanes + per_block - 1) / per_block;
    if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    sorted_window_gather_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(table), static_cast<const int32_t*>(sidx),
        static_cast<int32_t*>(out), n_lanes, tile, span, max_start);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sorted_window_gather_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
