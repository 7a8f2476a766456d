// sampler_step — the sampled triangle estimator's reservoir step.
//
// Replaces the lax.scan of gelly_tpu/library/triangles.py:_sampler_step
// (there is no Pallas kernel on it): S reservoir instances (Buriol et
// al.), each walking every lane of one chunk in stream order, with its
// own Threefry-2x32 key stream, bit for bit JAX's jax.random under x64
// and jax_threefry_partitionable:
//
//   * every lane (padding and self-loops included) splits the key in
//     three: key' = H(key; 0, 0), k1 = H(key; 0, 1), k2 = H(key; 0, 2)
//     (H the hash, (hi, lo) its counter pair);
//   * a live lane (valid, u != v) flips the coin
//     uniform(k1) * f32(i) < 1 in f64, i the 1-based live edge index,
//     uniform(k1) = the top 52 bits of H(k1; 0, 0) as a mantissa;
//   * where it lands, the instance samples (u, v) and a third vertex
//     randint(k2, 0, max(V-2, 1)) shifted past min(u, v) then max(u, v)
//     (randint: k2 split in two, 32 higher and 32 lower bits, reduced
//     into the span with JAX's uint32 wrap-around), clears its found
//     flags and records V;
//   * the lane then marks the wedge edges (src, third) and (trg, third)
//     it closes.
//
// The instances are independent, so one thread owns one instance and
// keeps its state in registers. The draw is taken only where the coin
// lands: the key stream does not depend on it. The block stages the
// chunk's lanes in shared memory, a tile at a time, for all its threads.
// edge_count is read once (every instance sees the same live lanes);
// the caller adds the chunk's live lanes to it after the launch.
//
// Bound on an H100: integer throughput, three hashes (20 rounds each) an
// instance a lane, about two thousand instructions of dependent work a
// lane for each thread; the lanes themselves are a chain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 2048;  // lanes staged in shared memory at a time

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
    return (x << d) | (x >> (32 - d));
}

// Threefry-2x32, 20 rounds, JAX's rotations and key schedule.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t x0, uint32_t x1,
                                         uint32_t& o0, uint32_t& o1) {
    const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
    uint32_t a = x0 + ks[0];
    uint32_t b = x1 + ks[1];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
        const int r0 = (i & 1) ? 17 : 13;
        const int r1 = (i & 1) ? 29 : 15;
        const int r2 = (i & 1) ? 16 : 26;
        const int r3 = (i & 1) ? 24 : 6;
        a += b; b = rotl(b, r0) ^ a;
        a += b; b = rotl(b, r1) ^ a;
        a += b; b = rotl(b, r2) ^ a;
        a += b; b = rotl(b, r3) ^ a;
        a += ks[(i + 1) % 3];
        b += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
    }
    o0 = a;
    o1 = b;
}

// jax.random.bits(key, uint32): the hash of counters (0, 0), halves XORed.
__device__ __forceinline__ uint32_t bits32(uint32_t k0, uint32_t k1) {
    uint32_t a, b;
    threefry(k0, k1, 0u, 0u, a, b);
    return a ^ b;
}

__global__ void __launch_bounds__(kThreads)
sampler_step_kernel(int32_t* s_src, int32_t* s_trg, int32_t* s_third,
                    uint8_t* s_src_found, uint8_t* s_trg_found,
                    int32_t* s_v_at, const int32_t* edge_count,
                    long long* s_keys, const int32_t* esrc,
                    const int32_t* edst, const uint8_t* valid,
                    long long n_lanes, int n_inst, int num_vertices) {
    __shared__ int32_t t_src[kTile];
    __shared__ int32_t t_dst[kTile];
    __shared__ uint8_t t_ok[kTile];

    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    const bool mine = j < n_inst;
    int32_t src = -1, trg = -1, third = -1, v_at = 0;
    bool src_found = false, trg_found = false;
    uint32_t k0 = 0, k1 = 0;
    if (mine) {
        src = s_src[j];
        trg = s_trg[j];
        third = s_third[j];
        src_found = s_src_found[j] != 0;
        trg_found = s_trg_found[j] != 0;
        v_at = s_v_at[j];
        k0 = static_cast<uint32_t>(s_keys[2 * j]);
        k1 = static_cast<uint32_t>(s_keys[2 * j + 1]);
    }
    int32_t ec = *edge_count;
    const int32_t vm2 = num_vertices - 2;
    const uint32_t span = static_cast<uint32_t>(vm2 > 1 ? vm2 : 1);
    // 2^32 mod span, as JAX takes it: (2^16 mod span)^2 mod span, the
    // square wrapping in uint32.
    uint32_t mult = 65536u % span;
    mult = (mult * mult) % span;

    for (long long base = 0; base < n_lanes; base += kTile) {
        const int len = static_cast<int>(
            n_lanes - base < kTile ? n_lanes - base : kTile);
        __syncthreads();
        for (int l = threadIdx.x; l < len; l += blockDim.x) {
            const int32_t u = esrc[base + l];
            const int32_t v = edst[base + l];
            t_src[l] = u;
            t_dst[l] = v;
            t_ok[l] = valid[base + l] != 0 && u != v;
        }
        __syncthreads();
        if (!mine) continue;
        for (int l = 0; l < len; ++l) {
            uint32_t n0, n1;
            threefry(k0, k1, 0u, 0u, n0, n1);
            if (t_ok[l]) {
                const int32_t u = t_src[l];
                const int32_t v = t_dst[l];
                ++ec;
                uint32_t c0, c1, h, lo;
                threefry(k0, k1, 0u, 1u, c0, c1);
                threefry(c0, c1, 0u, 0u, h, lo);
                const unsigned long long mant =
                    (static_cast<unsigned long long>(h) << 20) | (lo >> 12);
                const double uni = static_cast<double>(mant) * 0x1p-52;
                const double fi =
                    static_cast<double>(static_cast<float>(ec));
                if (__dmul_rn(uni, fi) < 1.0) {
                    uint32_t d0, d1, a0, a1, b0, b1;
                    threefry(k0, k1, 0u, 2u, d0, d1);
                    threefry(d0, d1, 0u, 0u, a0, a1);
                    threefry(d0, d1, 0u, 1u, b0, b1);
                    const uint32_t higher = bits32(a0, a1);
                    const uint32_t lower = bits32(b0, b1);
                    uint32_t off = (higher % span) * mult + lower % span;
                    off %= span;
                    int32_t cand = static_cast<int32_t>(off);
                    const int32_t a = u < v ? u : v;
                    const int32_t b = u < v ? v : u;
                    cand += cand >= a;
                    cand += cand >= b;
                    src = u;
                    trg = v;
                    third = cand;
                    src_found = false;
                    trg_found = false;
                    v_at = num_vertices;
                }
                src_found |= (u == src && v == third) ||
                             (u == third && v == src);
                trg_found |= (u == trg && v == third) ||
                             (u == third && v == trg);
            }
            k0 = n0;
            k1 = n1;
        }
    }
    if (mine) {
        s_src[j] = src;
        s_trg[j] = trg;
        s_third[j] = third;
        s_src_found[j] = src_found;
        s_trg_found[j] = trg_found;
        s_v_at[j] = v_at;
        s_keys[2 * j] = k0;
        s_keys[2 * j + 1] = k1;
    }
}

}  // namespace

// State (in place): src, trg, third i32[S]; src_found, trg_found u8[S];
// v_at i32[S]; edge_count i32[1] (read only); keys i64[S, 2] holding u32
// values. Chunk: esrc, edst i32[n_lanes], valid u8[n_lanes]. Returns a
// cudaError_t code.
extern "C" int sampler_step_launch(void* src, void* trg, void* third,
                                   void* src_found, void* trg_found,
                                   void* v_at, const void* edge_count,
                                   void* keys, const void* esrc,
                                   const void* edst, const void* valid,
                                   long long n_lanes, int n_inst,
                                   int num_vertices, void* stream) {
    if (n_lanes <= 0 || n_inst <= 0) return 0;
    const int blocks = (n_inst + kThreads - 1) / kThreads;
    sampler_step_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(src), static_cast<int32_t*>(trg),
        static_cast<int32_t*>(third), static_cast<uint8_t*>(src_found),
        static_cast<uint8_t*>(trg_found), static_cast<int32_t*>(v_at),
        static_cast<const int32_t*>(edge_count),
        static_cast<long long*>(keys), static_cast<const int32_t*>(esrc),
        static_cast<const int32_t*>(edst),
        static_cast<const uint8_t*>(valid), n_lanes, n_inst, num_vertices);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sampler_step_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
