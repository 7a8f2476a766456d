// wedge_count_matrix — W = M^T M for a 0/1 byte mask M[u, x].
//
// Replaces the Pallas kernel gelly_tpu/ops/pallas_kernels.py:
// _wedge_kernel (launched by wedge_count_matrix). W[a, b] is the number of
// rows u with M[u, a] and M[u, b] set: with M the window's wedge mask
// (M[u, x] = edge (u, x) with x > u) it is the number of common smaller
// neighbours of a and b. The full matrix is written, lower triangle
// included, exactly as the TPU kernel writes it.
//
// The TPU kernel is a grid of 128 x 128 output tiles, each contracting the
// whole u axis in one f32 MXU dot over [N, 128] column blocks held in VMEM.
// Here the same tiles are thread blocks that run in parallel, and a loop
// over u in steps of 32 rows takes the place of the full-K block.
//
// Bound on an H100: operations. 2 N^3 integer operations against N^2 bytes
// in and 4 N^2 bytes out; at N = 2^15 that is 7e13 operations for 5 GB,
// far above the card's ratio of operations to bytes. This first design
// runs on the CUDA cores, not the tensor cores:
//
//   * one block of 256 threads per 128 x 128 output tile, 8 x 8 int32
//     accumulators per thread (counts stay below N < 2^24, so they convert
//     to f32 exactly at the store);
//   * per step, each warp reads 4 rows of 128 bytes of the a- and b-column
//     strips (coalesced: both operands are read along rows of M), and each
//     lane transposes its 4 x 4 bytes so one 32-bit word holds 4 u values of
//     one column; the words go to shared memory;
//   * the inner product takes 4 u rows per __dp4a;
//   * the next step's rows are loaded into registers while the current
//     step is computed.
//
// Tensor cores (mma.sync s8 or wgmma) and TMA staging are for a later
// redesign.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;             // output tile edge (a and b)
constexpr int kStepRows = 32;          // rows of u per step
constexpr int kQuads = kStepRows / 4;  // packed 4-row words per column
constexpr int kThreads = 256;          // 16 x 16 threads, 8 x 8 outputs each

__device__ __forceinline__ void load_rows(const uint8_t* p, long long n,
                                          uint32_t r[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        r[i] = __ldg(reinterpret_cast<const unsigned int*>(p + i * n));
    }
}

// r[i] holds row i's bytes of 4 columns; afterwards word j holds column j's
// bytes of the 4 rows (byte i = row i).
__device__ __forceinline__ uint4 transpose4x4(const uint32_t r[4]) {
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
    const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
    return make_uint4(__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                      __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632));
}

__global__ void __launch_bounds__(kThreads, 2)
wedge_count_kernel(const uint8_t* __restrict__ m, float* __restrict__ w,
                   int n) {
    __shared__ __align__(16) uint32_t sa[kQuads][kTile];
    __shared__ __align__(16) uint32_t sb[kQuads][kTile];

    const int tid = threadIdx.x;
    const int a0 = blockIdx.y * kTile;
    const int b0 = blockIdx.x * kTile;
    const long long nn = n;

    // Loader role: warp q packs rows 4q..4q+3 of the step, lane l columns
    // 4l..4l+3 of each strip.
    const int q = tid >> 5;
    const int l = tid & 31;
    const uint8_t* pa = m + 4LL * q * nn + a0 + 4 * l;
    const uint8_t* pb = m + 4LL * q * nn + b0 + 4 * l;

    // Compute role: rows ty*4+i and 64+ty*4+i, columns tx*4+j and
    // 64+tx*4+j of the tile (split halves keep shared reads conflict-free).
    const int tx = tid & 15;
    const int ty = tid >> 4;

    int acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0;
    }

    uint32_t ra[4], rb[4];
    load_rows(pa, nn, ra);
    load_rows(pb, nn, rb);
    for (int u0 = 0; u0 < n; u0 += kStepRows) {
        *reinterpret_cast<uint4*>(&sa[q][4 * l]) = transpose4x4(ra);
        *reinterpret_cast<uint4*>(&sb[q][4 * l]) = transpose4x4(rb);
        __syncthreads();
        if (u0 + kStepRows < n) {
            pa += kStepRows * nn;
            pb += kStepRows * nn;
            load_rows(pa, nn, ra);
            load_rows(pb, nn, rb);
        }
#pragma unroll
        for (int k = 0; k < kQuads; ++k) {
            const uint4 alo = *reinterpret_cast<const uint4*>(&sa[k][ty * 4]);
            const uint4 ahi = *reinterpret_cast<const uint4*>(&sa[k][64 + ty * 4]);
            const uint4 blo = *reinterpret_cast<const uint4*>(&sb[k][tx * 4]);
            const uint4 bhi = *reinterpret_cast<const uint4*>(&sb[k][64 + tx * 4]);
            const int av[8] = {(int)alo.x, (int)alo.y, (int)alo.z, (int)alo.w,
                               (int)ahi.x, (int)ahi.y, (int)ahi.z, (int)ahi.w};
            const int bv[8] = {(int)blo.x, (int)blo.y, (int)blo.z, (int)blo.w,
                               (int)bhi.x, (int)bhi.y, (int)bhi.z, (int)bhi.w};
#pragma unroll
            for (int i = 0; i < 8; ++i) {
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
                }
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int a = a0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
        float* row = w + a * nn + b0;
        *reinterpret_cast<float4*>(row + tx * 4) = make_float4(
            (float)acc[i][0], (float)acc[i][1], (float)acc[i][2],
            (float)acc[i][3]);
        *reinterpret_cast<float4*>(row + 64 + tx * 4) = make_float4(
            (float)acc[i][4], (float)acc[i][5], (float)acc[i][6],
            (float)acc[i][7]);
    }
}

}  // namespace

// m: n x n bytes (0/1), row-major, 16-byte aligned; w: n x n f32 out.
// n must be a positive multiple of 128. Returns a cudaError_t code.
extern "C" int wedge_count_matrix_launch(const void* m, void* w, int n,
                                         void* stream) {
    if (n <= 0) return 0;
    if (n % kTile) return static_cast<int>(cudaErrorInvalidValue);
    const int tiles = n / kTile;
    if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(tiles, tiles);
    wedge_count_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(m), static_cast<float*>(w), n);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wedge_count_matrix_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
