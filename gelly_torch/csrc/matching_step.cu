// matching_step — the device fold of the greedy weighted matching.
//
// Replaces the lax.scan of gelly_tpu/library/matching.py:_matching_step
// (the device=True path; there is no Pallas kernel on it): one chunk's
// edges folded in stream order into the matching state, in f32 as JAX
// computes it:
//
//   * wu, wv: the weights of u's and v's current matches (0 when
//     unmatched); the colliding weight is wu, when u and v are matched to
//     each other, else wu + wv;
//   * a live edge (valid, u != v) is taken when w > 2 * colliding;
//   * a taken edge clears u's and v's matches at both of their ends, then
//     matches u and v at weight w.
//
// The test is rounded as JAX rounds it: one f32 add, one f32 multiply by
// two (exact), one compare. __fadd_rn and __fmul_rn are never contracted
// into a fused multiply-add, so the result does not depend on nvcc's
// -fmad setting.
//
// Bound on an H100: the chain of dependent edges. Each edge reads the
// state the previous one wrote, so one thread walks the chunk; what it
// costs is the latency of those reads. When the state fits (n * 8 bytes
// of shared memory), the block stages it there first, so each read is a
// shared-memory round trip instead of an L2 one, and writes it back at
// the end. Ids of live lanes must lie in [0, n); a lane outside it is
// skipped.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // stage the state; one thread folds
constexpr int kSmemLimit = 227 * 1024;

__global__ void __launch_bounds__(kThreads)
matching_step_kernel(int32_t* partner, float* weight, const int32_t* src,
                     const int32_t* dst, const float* w,
                     const uint8_t* valid, long long n_lanes, int n,
                     int staged) {
    extern __shared__ unsigned char smem[];
    int32_t* p = partner;
    float* wt = weight;
    if (staged) {
        p = reinterpret_cast<int32_t*>(smem);
        wt = reinterpret_cast<float*>(smem + sizeof(int32_t) * n);
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            p[i] = partner[i];
            wt[i] = weight[i];
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        for (long long e = 0; e < n_lanes; ++e) {
            if (!valid[e]) continue;
            const int u = src[e];
            const int v = dst[e];
            if (u == v || u < 0 || u >= n || v < 0 || v >= n) continue;
            const int pu = p[u];
            const int pv = p[v];
            const float wu = pu >= 0 ? wt[u] : 0.0f;
            const float wv = pv >= 0 ? wt[v] : 0.0f;
            const bool same = pu == v && pv == u && pu >= 0;
            const float coll = same ? wu : __fadd_rn(wu, wv);
            const float we = w[e];
            if (!(we > __fmul_rn(2.0f, coll))) continue;
            if (pu >= 0) {
                p[pu] = -1;
                wt[pu] = 0.0f;
                p[u] = -1;
                wt[u] = 0.0f;
            }
            if (pv >= 0) {
                p[pv] = -1;
                wt[pv] = 0.0f;
                p[v] = -1;
                wt[v] = 0.0f;
            }
            p[u] = v;
            p[v] = u;
            wt[u] = we;
            wt[v] = we;
        }
    }
    if (staged) {
        __syncthreads();
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            partner[i] = p[i];
            weight[i] = wt[i];
        }
    }
}

}  // namespace

extern "C" int matching_step_launch(void* partner, void* weight,
                                    const void* src, const void* dst,
                                    const void* w, const void* valid,
                                    long long n_lanes, int n, void* stream) {
    if (n_lanes <= 0 || n <= 0) return 0;
    const long long state = 8LL * n;
    const int staged = state <= kSmemLimit;
    const int bytes = staged ? static_cast<int>(state) : 0;
    if (staged) {
        cudaError_t err = cudaFuncSetAttribute(
            matching_step_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    matching_step_kernel<<<1, kThreads, bytes,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(partner), static_cast<float*>(weight),
        static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst),
        static_cast<const float*>(w), static_cast<const uint8_t*>(valid),
        n_lanes, n, staged);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* matching_step_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
