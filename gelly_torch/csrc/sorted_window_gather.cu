// sorted_window_gather — table[sidx] for SORTED sidx, windowed.
//
// Replaces the Pallas kernel gelly_tpu/ops/pallas_kernels.py:
// _sorted_gather_kernel (launched by sorted_window_gather). It returns
// exactly what that kernel returns, -1 lanes included:
//
//   * lanes are cut into tiles of `tile` consecutive entries of sidx;
//   * a tile's window start is clip(sidx[g*tile] / span, 0, nwb - 2),
//     span = 128 * wr table slots (wr = window rows, nwb = table rows / wr);
//   * a lane whose index lies in [start*span, start*span + 2*span) (the
//     tile's two consecutive windows) gets table[idx], any other lane -1.
//
// The TPU kernel keeps the window pair in VMEM and picks each element with
// a one-hot row-select matmul (Mosaic has no vector gather); the f32
// matmul is also where its 2^24 value bound comes from. Hopper gathers
// directly, so this kernel reads the i32 table values through the
// read-only cache and has no value bound of its own.
//
// Bound on an H100: memory. Per call it must read the L indices and write
// the L outputs (8 bytes a lane) plus the 32-byte table sectors the hit
// lanes touch; it does no arithmetic worth counting. Design: one block per
// tile computes its own window start from the tile's first index (no
// scalar-prefetch pass); each thread handles tile/blockDim lanes at a
// stride of blockDim, so a warp's index loads and output stores are
// coalesced, and because the indices are sorted neighbouring lanes read
// neighbouring table sectors. Staging the window pair in shared memory
// (2 x 64 KB) or via TMA is left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sorted_window_gather_kernel(const int32_t* __restrict__ table,
                            const int32_t* __restrict__ sidx,
                            int32_t* __restrict__ out, long long n_lanes,
                            int tile, int span, int max_start) {
    const long long g0 = static_cast<long long>(blockIdx.x) * tile;
    const int first = __ldg(sidx + g0);
    // floor(first / span) clipped to [0, max_start]; a negative first
    // index clips to window 0 (floor and truncation agree after the clip).
    const int start = first < 0 ? 0 : min(first / span, max_start);
    const long long lo = static_cast<long long>(start) * span;
    const long long hi = lo + 2LL * span;
    const long long end = min(g0 + tile, n_lanes);
    for (long long i = g0 + threadIdx.x; i < end; i += kThreads) {
        const int idx = __ldg(sidx + i);
        out[i] = (idx >= lo && idx < hi) ? __ldg(table + idx) : -1;
    }
}

}  // namespace

extern "C" int sorted_window_gather_launch(const void* table, const void* sidx,
                                           void* out, long long n_lanes,
                                           int tile, int span, int max_start,
                                           void* stream) {
    if (n_lanes <= 0) return 0;
    const long long grid = (n_lanes + tile - 1) / tile;
    sorted_window_gather_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(table), static_cast<const int32_t*>(sidx),
        static_cast<int32_t*>(out), n_lanes, tile, span, max_start);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sorted_window_gather_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
