// wedge_count_matrix — W = M^T M for a 0/1 byte mask M[u, x].
//
// Replaces the Pallas kernel gelly_tpu/ops/pallas_kernels.py:
// _wedge_kernel (launched by wedge_count_matrix). W[a, b] is the number of
// rows u with M[u, a] and M[u, b] set: with M the window's wedge mask
// (M[u, x] = edge (u, x) with x > u) it is the number of common smaller
// neighbours of a and b. The full matrix is written, lower triangle
// included, exactly as the TPU kernel writes it, for any mask.
//
// The TPU kernel is a grid of 128 x 128 output tiles, each one f32 MXU dot
// over the whole u axis. Bound on an H100: operations (int8 tensor cores).
// The dense product is 2 N^3 operations against 5 N^2 bytes; the work a
// mask really needs is smaller, and this design computes only that:
//
//   * W is symmetric for any M, so only the upper tiles (i <= j) are
//     computed; each writes itself and, for i < j, its transpose;
//   * tile (i, j) sums over k-blocks of 128 rows of M, and a k-block adds
//     nothing unless both M[k-block, i-block] and M[k-block, j-block] hold
//     a one. A pre-pass records, per 128 x 128 block, whether it holds any
//     one (flags[k][i]), and the tile kernel skips every dead k. For the
//     triangle path's triu mask every block below the block diagonal is
//     dead, so about 1/6 of the dense work remains.
//
// Both skips use only facts of the input, so the result is the full W of
// any mask.
//
// Layout. The s8 tensor-core operands must be K-major (wgmma transposes
// 16-bit types only), and M is stored [u][x] with the contraction axis u
// strided. The pre-pass therefore also writes Mt = M^T (a 4 x 4 byte
// transpose per lane through shared memory), and then
// W[a-block, b-block] = sum_u Mt[a, u] Mt[b, u] reads both operands as
// rows of Mt with u contiguous. Blocks of Mt whose flag is dead are never
// written and never read.
//
// Tile kernel: one CTA of 288 threads per upper tile, heaviest rows first
// (the order of gelly_torch.ops.kernels.wedge_tile_schedule). One producer
// thread walks the live k-blocks and issues TMA loads of the two
// [128 rows, 128 bytes] Mt tiles (128-byte swizzle) into a ring of 3
// stages, completing on mbarriers; a diagonal tile loads one tile for both
// operands. Two consumer warpgroups each own 64 rows of the tile and issue
// four wgmma m64n128k32 s8 products per stage into 64 s32 accumulators a
// thread. Two CTAs share an SM (99 KB of shared memory each), so one CTA's
// epilogue overlaps the other's main loop. Epilogue: s32 -> f32 (exact:
// counts <= N < 2^24) into a padded shared tile, then coalesced rows of
// W(i, j) and, read down the columns, of W(j, i). Offsets into W are 64-bit
// (W is 4 GiB at N = 2^15).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlk = 128;                   // tile edge and k-block depth
constexpr int kTileBytes = kBlk * kBlk;     // one [128, 128] byte tile
constexpr int kStages = 3;
constexpr int kConsumers = 2;               // warpgroups of 64 tile rows
constexpr int kThreads = 128 * kConsumers + 32;  // + the producer warp
constexpr int kMaxTiles = 1024;             // N <= 131072
constexpr int kMaxWords = kMaxTiles / 32;
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kSmemBytes = kStages * kStageBytes + 1024;  // + 1 KB alignment
constexpr int kCStride = kBlk + 1;          // f32 staging row, odd stride
static_assert(kBlk * kCStride * 4 <= kStages * kStageBytes,
              "the epilogue tile must fit in the stage buffers");

constexpr int kPrepThreads = 256;
constexpr int kRowWords = kBlk / 4 + 1;     // padded shared row of the pre-pass

// r[i] holds row i's bytes of 4 columns; afterwards word j holds column j's
// bytes of the 4 rows (byte i = row i).
__device__ __forceinline__ uint4 transpose4x4(uint32_t r0, uint32_t r1,
                                              uint32_t r2, uint32_t r3) {
    const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
    const uint32_t t1 = __byte_perm(r0, r1, 0x7362);
    const uint32_t t2 = __byte_perm(r2, r3, 0x5140);
    const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
    return make_uint4(__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                      __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632));
}

// One CTA per 128 x 128 block (k = blockIdx.y rows of M, i = blockIdx.x
// columns): flags[k][i] = any byte set, and for a live block its transpose
// into Mt[i-block rows, k-block columns].
__global__ void __launch_bounds__(kPrepThreads)
wedge_prepass_kernel(const uint8_t* __restrict__ m, uint8_t* __restrict__ mt,
                     uint8_t* __restrict__ flags, int n) {
    __shared__ uint32_t s[kBlk * kRowWords];
    const int i = blockIdx.x;
    const int k = blockIdx.y;
    const long long nn = n;
    const int tid = threadIdx.x;
    const uint8_t* src = m + k * kBlk * nn + i * kBlk;
    uint32_t any = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int idx = q * kPrepThreads + tid;  // 8 lanes of 16 bytes a row
        const int row = idx >> 3;
        const int chunk = idx & 7;
        const uint4 v =
            __ldg(reinterpret_cast<const uint4*>(src + row * nn + chunk * 16));
        uint32_t* d = s + row * kRowWords + chunk * 4;
        d[0] = v.x;
        d[1] = v.y;
        d[2] = v.z;
        d[3] = v.w;
        any |= v.x | v.y | v.z | v.w;
    }
    const int live = __syncthreads_or(any != 0);
    if (tid == 0) flags[static_cast<long long>(k) * (n / kBlk) + i] = live;
    if (!live) return;
    // Each warp transposes 8 x 4 groups of 4 x 4 bytes per pass; lane g
    // picks the rows, lane h the columns (conflict-free with the padding).
    const int warp = tid >> 5;
    const int g = tid & 7;
    const int h = (tid >> 3) & 3;
    uint8_t* dst = mt + i * kBlk * nn + k * kBlk;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int p = q * 8 + warp;
        const int ug = (p & 3) * 8 + g;   // rows 4ug..4ug+3 of the block
        const int xg = (p >> 2) * 4 + h;  // columns 4xg..4xg+3
        const uint32_t* r = s + 4 * ug * kRowWords + xg;
        const uint4 c = transpose4x4(r[0], r[kRowWords], r[2 * kRowWords],
                                     r[3 * kRowWords]);
        uint8_t* o = dst + 4 * xg * nn + 4 * ug;
        *reinterpret_cast<uint32_t*>(o) = c.x;
        *reinterpret_cast<uint32_t*>(o + nn) = c.y;
        *reinterpret_cast<uint32_t*>(o + 2 * nn) = c.z;
        *reinterpret_cast<uint32_t*>(o + 3 * nn) = c.w;
    }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(bar) : "memory");
}

// Returns once the barrier phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t}"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } while (!done);
}

// TMA: the [128 rows, 128 bytes] tile of Mt at (column x, row y).
__device__ __forceinline__ void tma_load_tile(uint32_t dst,
                                              const CUtensorMap* map, int x,
                                              int y, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3}], [%4];"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
           "r"(bar)
        : "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int count) {
    asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(count) : "memory");
}

// wgmma shared-memory descriptor of a K-major tile written by TMA with the
// 128-byte swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>(1) << 16) |           // LBO (unused here)
           (static_cast<uint64_t>(1024 >> 4) << 32) |   // SBO
           (static_cast<uint64_t>(1) << 62);            // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(kPending)
                 : "memory");
}

// Keeps the compiler from moving accumulator registers across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
    for (int r = 0; r < 64; ++r) asm volatile("" : "+r"(d[r]) :: "memory");
}

// d[64 x 128] = A[64 x 32] * B[128 x 32]^T (+ d if `accumulate`), s8
// inputs, s32 accumulators. Accumulator d[4c + 2h + e] is row
// 16 * warp + lane / 4 + 8h, column 8c + 2 * (lane % 4) + e of the
// warpgroup's 64 x 128 block.
__device__ __forceinline__ void wgmma_s8_m64n128k32(int (&d)[64], uint64_t da,
                                                    uint64_t db,
                                                    int accumulate) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "setp.ne.b32 p, %66, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n\t}"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(accumulate));
}

__global__ void __launch_bounds__(kThreads, 2)
wedge_tile_kernel(const __grid_constant__ CUtensorMap mt_map,
                  const uint8_t* __restrict__ flags, float* __restrict__ w,
                  int n) {
    extern __shared__ uint8_t smem_raw[];
    __shared__ __align__(8) uint64_t full_bar[kStages];
    __shared__ __align__(8) uint64_t empty_bar[kStages];
    __shared__ uint32_t live_words[kMaxWords];

    const int t = n / kBlk;
    // Upper tile (i, j) of this CTA, rows of descending i: the q-th row
    // from the bottom starts at block q(q+1)/2 (wedge_tile_schedule).
    const int b = blockIdx.x;
    int q = static_cast<int>((sqrtf(8.0f * b + 1.0f) - 1.0f) * 0.5f);
    while ((q + 1) * (q + 2) / 2 <= b) ++q;
    while (q * (q + 1) / 2 > b) --q;
    const int i = t - 1 - q;
    const int j = i + (b - q * (q + 1) / 2);
    const bool diag = i == j;

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    // Bit k of the live words: k-block k holds a one in both column blocks.
    const int nwords = (t + 31) >> 5;
    for (int c = warp; c < nwords; c += kThreads / 32) {
        const int k = c * 32 + lane;
        bool live = false;
        if (k < t) {
            const long long row = static_cast<long long>(k) * t;
            live = (__ldg(flags + row + i) & __ldg(flags + row + j)) != 0;
        }
        const uint32_t bits = __ballot_sync(0xffffffffu, live);
        if (lane == 0) live_words[c] = bits;
    }
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle's alignment
    if (tid == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(smem_u32(&full_bar[s]), 1);
            mbar_init(smem_u32(&empty_bar[s]), kConsumers);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (warp == 4 * kConsumers) {
        // Producer: one thread keeps the ring full.
        if (lane == 0) {
            int stage = 0;
            uint32_t phase = 0;
            for (int c = 0; c < nwords; ++c) {
                uint32_t bits = live_words[c];
                while (bits) {
                    const int k = c * 32 + __ffs(bits) - 1;
                    bits &= bits - 1;
                    mbar_wait(smem_u32(&empty_bar[stage]), phase ^ 1);
                    const uint32_t sa = base + stage * kStageBytes;
                    const uint32_t fb = smem_u32(&full_bar[stage]);
                    mbar_expect_tx(fb, diag ? kTileBytes : kStageBytes);
                    tma_load_tile(sa, &mt_map, k * kBlk, i * kBlk, fb);
                    if (!diag) {
                        tma_load_tile(sa + kTileBytes, &mt_map, k * kBlk,
                                      j * kBlk, fb);
                    }
                    if (++stage == kStages) {
                        stage = 0;
                        phase ^= 1;
                    }
                }
            }
        }
        return;
    }

    // Consumers: warpgroup wg owns rows 64wg..64wg+63 of the tile.
    int nk = 0;
    for (int c = 0; c < nwords; ++c) nk += __popc(live_words[c]);
    const int wg = warp >> 2;
    // No zero fill: the first product overwrites (a register write between
    // the asynchronous products would serialize them), and a tile with no
    // live k-block stores zeros without reading acc.
    int acc[64];
    int stage = 0;
    uint32_t phase = 0;
    int prev = -1;
    for (int it = 0; it < nk; ++it) {
        mbar_wait(smem_u32(&full_bar[stage]), phase);
        const uint32_t sa = base + stage * kStageBytes;
        const uint64_t da = sw128_desc(sa + wg * 64 * kBlk);
        const uint64_t db = sw128_desc(diag ? sa : sa + kTileBytes);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlk / 32; ++kk) {
            // 32 bytes further along u: +2 in the descriptor's 16-byte units
            wgmma_s8_m64n128k32(acc, da + 2 * kk, db + 2 * kk,
                                it > 0 || kk > 0);
        }
        wgmma_commit();
        fence_acc(acc);
        wgmma_wait<1>();  // the previous stage's products are done
        if (prev >= 0 && (tid & 127) == 0) {
            mbar_arrive(smem_u32(&empty_bar[prev]));
        }
        prev = stage;
        if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
        }
    }
    wgmma_wait<0>();
    fence_acc(acc);

    // Epilogue through the (now idle) stage buffers.
    named_bar_sync(1, 128 * kConsumers);
    float* sc = reinterpret_cast<float*>(smem_raw + (base - raw));
    const int wl = warp & 3;
    const bool summed = nk > 0;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = wg * 64 + wl * 16 + (lane >> 2) + 8 * h;
            const int col = c * 8 + 2 * (lane & 3);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                sc[row * kCStride + col + e] =
                    summed ? static_cast<float>(acc[4 * c + 2 * h + e]) : 0.0f;
            }
        }
    }
    named_bar_sync(1, 128 * kConsumers);
    const long long nn = n;
    const int col = tid & 127;
    float* wij = w + static_cast<long long>(i) * kBlk * nn + j * kBlk;
    for (int r = tid >> 7; r < kBlk; r += 2) {
        wij[r * nn + col] = sc[r * kCStride + col];
    }
    if (!diag) {
        float* wji = w + static_cast<long long>(j) * kBlk * nn + i * kBlk;
        for (int r = tid >> 7; r < kBlk; r += 2) {
            wji[r * nn + col] = sc[col * kCStride + r];
        }
    }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library needs no -lcuda.
int get_encoder(EncodeTiledFn* fn) {
    static EncodeTiledFn cached = nullptr;
    if (cached == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t e = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t e = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        if (e != cudaSuccess) return static_cast<int>(e);
        if (found != cudaDriverEntryPointSuccess || p == nullptr) {
            return static_cast<int>(cudaErrorSymbolNotFound);
        }
        cached = reinterpret_cast<EncodeTiledFn>(p);
    }
    *fn = cached;
    return 0;
}

int check_size(int n) {
    if (n % kBlk || n / kBlk > kMaxTiles) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return 0;
}

int launch_prepass(const void* m, void* mt, void* flags, int n,
                   cudaStream_t stream) {
    const int t = n / kBlk;
    wedge_prepass_kernel<<<dim3(t, t), kPrepThreads, 0, stream>>>(
        static_cast<const uint8_t*>(m), static_cast<uint8_t*>(mt),
        static_cast<uint8_t*>(flags), n);
    return static_cast<int>(cudaGetLastError());
}

// Returned when cuTensorMapEncodeTiled refuses the tensor map.
constexpr int kEncodeFailed = -1;

}  // namespace

// m: n x n bytes (0/1; bool, uint8 or int8), row-major, 16-byte aligned;
// mt: n x n bytes of scratch; flags: (n/128)^2 bytes of scratch; w: n x n
// f32 out. n must be a multiple of 128 and at most 131072. Launches the
// pre-pass and the tile kernel on `stream`. Returns a cudaError_t code, or
// kEncodeFailed when the tensor map could not be encoded.
extern "C" int wedge_count_matrix_launch(const void* m, void* mt, void* flags,
                                         void* w, int n, void* stream) {
    if (n <= 0) return 0;
    int rc = check_size(n);
    if (rc) return rc;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    rc = launch_prepass(m, mt, flags, n, s);
    if (rc) return rc;
    EncodeTiledFn encode;
    rc = get_encoder(&encode);
    if (rc) return rc;
    CUtensorMap map;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n),
                                static_cast<cuuint64_t>(n)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(n)};
    const cuuint32_t box[2] = {kBlk, kBlk};
    const cuuint32_t unit[2] = {1, 1};
    if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, mt, dims, strides, box,
               unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
        return kEncodeFailed;
    }
    const cudaError_t e = cudaFuncSetAttribute(
        wedge_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int t = n / kBlk;
    wedge_tile_kernel<<<t * (t + 1) / 2, kThreads, kSmemBytes, s>>>(
        map, static_cast<const uint8_t*>(flags), static_cast<float*>(w), n);
    return static_cast<int>(cudaGetLastError());
}

// The pre-pass alone (Mt and flags), for timing its share of a launch.
extern "C" int wedge_count_matrix_prepass(const void* m, void* mt, void* flags,
                                          int n, void* stream) {
    if (n <= 0) return 0;
    const int rc = check_size(n);
    if (rc) return rc;
    return launch_prepass(m, mt, flags, n, static_cast<cudaStream_t>(stream));
}

extern "C" const char* wedge_count_matrix_error_string(int code) {
    if (code == kEncodeFailed) {
        return "cuTensorMapEncodeTiled refused the Mt tensor map";
    }
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
