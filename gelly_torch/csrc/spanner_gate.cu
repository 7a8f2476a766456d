// spanner_gate — the sparse k-spanner's sequential gates, on one block.
//
// Replaces two XLA device loops of gelly_tpu/library/spanner.py (there is
// no Pallas kernel on this path; in eager PyTorch each loop would be one
// Python step and tens of launches per edge or per 64-edge batch):
//
//   * entry 1, spanner_sparse_insert_edges: _sparse_insert_edges, the
//     lax.scan that gates and inserts a chunk's edges one at a time;
//   * entry 2, spanner_sparse_insert_edges_batched:
//     _sparse_insert_edges_batched, the combine's lax.while_loop over
//     64-candidate batches of a donor spanner's edge list, with the
//     donor's count read on the device (no host sync per batch).
//
// Both return exactly what the JAX functions return, on the summary's
// own tensors, updated in place:
//
//   * the gate is _within_k_sparse: k rounds, each gathering the rows of
//     the frontier's live ids, then keeping the F smallest distinct ids of
//     frontier + rows (jnp.unique(..., size=F, fill_value=n)); an edge is
//     taken when its other endpoint is not in the final frontier. The
//     truncation to F ids decides which edges are taken, so it is kept.
//     Values the JAX code maps to the sentinel n (empty row slots) or
//     that sort after it never change which ids are live, and are dropped;
//   * entry 1 inserts a taken edge with row_insert(dedupe=False) both
//     ways, appends it to the edge list and sets the sticky flags;
//   * entry 2 gates all candidates of a batch against the adjacency as it
//     stood at the batch's start, then does _row_append_batch's two
//     passes (u -> v for every candidate, then v -> u): a candidate's slot
//     is deg[row] plus the number of earlier taken candidates of the same
//     row, which is the stable-argsort rank JAX computes; then the
//     edge-list append in candidate order and the overflow counts.
//
// Ids of live lanes must lie in [0, n), as they do in every summary a
// stream builds (JAX's scatters would drop such a lane's row writes); a
// lane outside it is skipped here.
//
// Bound on an H100: neither bytes nor operations. Each step depends on
// the one before (the next edge's gate reads the rows the last edge
// wrote; the next batch's gates read the last batch's appends), so the
// time is that chain of dependent steps: per edge or batch, k rounds of a
// row gather (a global-memory round trip) and a shared-memory sort. The
// design keeps the whole chain in one launch, so nothing waits on the
// host: entry 1 runs one block whose 256 threads sort each round's
// candidates (bitonic, in shared memory); entry 2 runs one block whose
// warps each gate one candidate at a time, in their own shared-memory
// slice, and then append the batch in parallel (ranks by comparison,
// atomic fill counts). Rows are read with plain loads, never through the
// read-only cache: the same launch writes them.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kEdgeThreads = 256;  // entry 1: one block walks the edges
constexpr int kWarp = 32;
constexpr int kMaxWarps = 32;

struct BlockSync {
    __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

struct WarpSync {
    __device__ __forceinline__ void operator()() const { __syncwarp(); }
};

__host__ __device__ inline int next_pow2(int x) {
    int p = 1;
    while (p < x) p <<= 1;
    return p;
}

// Sort length the largest round needs: the frontier before the last round
// holds at most min(F, (D + 1)^(k - 1)) live ids, each with D row slots.
int sort_span(int D, int F, int k) {
    if (k <= 0) return 1;
    long long live = 1;
    for (int r = 1; r < k && live < F; ++r) live *= D + 1;
    if (live > F) live = F;
    return next_pow2(static_cast<int>(live * (D + 1)));
}

// Ascending bitonic sort of a[0, P), P a power of two, by the nt threads
// of a group (lane in [0, nt)).
template <class Sync>
__device__ void bitonic_sort(int* a, int P, int lane, int nt, Sync sync) {
    for (int size = 2; size <= P; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            for (int t = lane; t < (P >> 1); t += nt) {
                const int i = 2 * t - (t & (stride - 1));
                const int j = i + stride;
                const int x = a[i];
                const int y = a[j];
                if ((x > y) == ((i & size) == 0)) {
                    a[i] = y;
                    a[j] = x;
                }
            }
            sync();
        }
    }
}

__device__ __forceinline__ bool first_of_run(const int* a, int i) {
    return a[i] != INT_MAX && (i == 0 || a[i] != a[i - 1]);
}

// dist(u, v) <= k over the capped-degree rows with an F-id frontier, by
// one group of nt threads (_within_k_sparse). Scratch: buf[P], front[F],
// scan[nt], misc[2]; P >= sort_span(D, F, k). Every lane returns the same
// answer.
template <class Sync>
__device__ bool within_k(const int32_t* nbr, int n, int D, int F, int k,
                         int u, int v, int* buf, int* front, int* scan,
                         int* misc, int lane, int nt, Sync sync) {
    if (lane == 0) {
        front[0] = u;
        misc[0] = 1;  // live frontier ids (a sorted prefix of front)
        misc[1] = 0;  // v found
    }
    sync();
    for (int r = 0; r < k; ++r) {
        const int L = misc[0];
        const int M = L * (D + 1);
        const int P = next_pow2(M);
        for (int i = lane; i < P; i += nt) {
            int x = INT_MAX;
            if (i < L) {
                x = front[i];
            } else if (i < M) {
                const int j = i - L;
                const int y = nbr[static_cast<long long>(front[j / D]) * D +
                                  j % D];
                if (y >= 0 && y < n) x = y;
            }
            buf[i] = x;
        }
        sync();
        bitonic_sort(buf, P, lane, nt, sync);
        // The F smallest distinct ids, in order: each lane counts the runs
        // starting in its segment, a scan gives its first output slot.
        const int seg = (P + nt - 1) / nt;
        const int lo = min(P, lane * seg);
        const int hi = min(P, lo + seg);
        int c = 0;
        for (int i = lo; i < hi; ++i) c += first_of_run(buf, i);
        scan[lane] = c;
        sync();
        for (int off = 1; off < nt; off <<= 1) {
            const int t = lane >= off ? scan[lane - off] : 0;
            sync();
            scan[lane] += t;
            sync();
        }
        int pos = scan[lane] - c;
        for (int i = lo; i < hi && pos < F; ++i) {
            if (first_of_run(buf, i)) front[pos++] = buf[i];
        }
        sync();
        if (lane == 0) misc[0] = min(F, scan[nt - 1]);
        sync();
    }
    const int L = misc[0];
    for (int i = lane; i < L; i += nt) {
        if (front[i] == v) misc[1] = 1;
    }
    sync();
    return misc[1] != 0;
}

__device__ __forceinline__ bool live_lane(int u, int v, int n) {
    return u != v && u >= 0 && u < n && v >= 0 && v < n;
}

// row_insert(dedupe=False): b into row a's next free slot, or one more
// dropped insert when the row is full.
__device__ __forceinline__ void row_append(int32_t* nbr, int32_t* deg,
                                           int32_t* dover, int a, int b,
                                           int D) {
    const int d = deg[a];
    if (d < D) {
        nbr[static_cast<long long>(a) * D + d] = b;
        deg[a] = d + 1;
    } else {
        *dover += 1;
    }
}

__global__ void __launch_bounds__(kEdgeThreads)
sparse_insert_edges_kernel(int32_t* nbr, int32_t* deg, int32_t* dover,
                           int32_t* esrc, int32_t* edst, int32_t* n_acc,
                           uint8_t* overflow, const int32_t* src,
                           const int32_t* dst, const uint8_t* valid,
                           long long n_lanes, int n, long long cap, int k,
                           int D, int F, int P) {
    extern __shared__ int smem[];
    int* buf = smem;
    int* front = buf + P;
    int* scan = front + F;
    int* misc = scan + blockDim.x;
    const int lane = threadIdx.x;
    const int nt = blockDim.x;
    for (long long e = 0; e < n_lanes; ++e) {
        const int u = src[e];
        const int v = dst[e];
        if (!valid[e] || !live_lane(u, v, n)) continue;
        const bool reach = within_k(nbr, n, D, F, k, u, v, buf, front, scan,
                                    misc, lane, nt, BlockSync());
        if (!reach && lane == 0) {
            row_append(nbr, deg, dover, u, v, D);
            row_append(nbr, deg, dover, v, u, D);
            const int m = *n_acc;
            if (m < cap) {
                esrc[m] = u;
                edst[m] = v;
            } else {
                *overflow = 1;
            }
            *n_acc = m + 1;
        }
        __syncthreads();  // the next gate reads what this edge wrote
    }
}

__global__ void __launch_bounds__(kWarp * kMaxWarps)
sparse_insert_edges_batched_kernel(
        int32_t* nbr, int32_t* deg, int32_t* dover, int32_t* esrc,
        int32_t* edst, int32_t* n_acc, uint8_t* overflow,
        const int32_t* csrc, const int32_t* cdst, const int32_t* n_valid,
        long long ccap, int n, long long cap, int k, int D, int F, int P,
        int B) {
    extern __shared__ int smem[];
    const int nt = blockDim.x;
    const int tid = threadIdx.x;
    const int warps = nt / kWarp;
    const int warp = tid / kWarp;
    const int lane = tid % kWarp;
    int* cu = smem;
    int* cv = cu + B;
    int* take = cv + B;
    int* slot = take + B;
    int* state = slot + B;  // [0] accepted count, [1] list overflow
    int* gate = state + 2 + warp * (P + F + kWarp + 2);
    int* buf = gate;
    int* front = buf + P;
    int* scan = front + F;
    int* misc = scan + kWarp;
    // n_valid counts accepted edges, stored or not: clamp to the list.
    const long long nv = min(static_cast<long long>(*n_valid), ccap);
    if (tid == 0) {
        state[0] = *n_acc;
        state[1] = *overflow;
    }
    __syncthreads();
    for (long long start = 0; start < nv; start += B) {
        for (int c = tid; c < B; c += nt) {
            const bool ok = start + c < nv;
            cu[c] = ok ? csrc[start + c] : 0;
            cv[c] = ok ? cdst[start + c] : 0;
            take[c] = ok;
        }
        __syncthreads();
        // Gate: each warp takes candidates c = warp, warp + warps, ...,
        // all against the adjacency as it stood at the batch's start.
        for (int c = warp; c < B; c += warps) {
            const int u = cu[c];
            const int v = cv[c];
            const bool live = take[c] && live_lane(u, v, n);
            __syncwarp();
            bool reach = true;
            if (live) {
                reach = within_k(nbr, n, D, F, k, u, v, buf, front, scan,
                                 misc, lane, kWarp, WarpSync());
            }
            if (lane == 0) take[c] = live && !reach;
            __syncwarp();
        }
        __syncthreads();
        // _row_append_batch, u -> v then v -> u.
        for (int pass = 0; pass < 2; ++pass) {
            const int* key = pass == 0 ? cu : cv;
            const int* val = pass == 0 ? cv : cu;
            for (int c = tid; c < B; c += nt) {
                if (take[c]) {
                    const int a = key[c];
                    int rank = 0;
                    for (int d = 0; d < c; ++d) rank += take[d] && key[d] == a;
                    slot[c] = deg[a] + rank;
                }
            }
            __syncthreads();
            for (int c = tid; c < B; c += nt) {
                if (take[c]) {
                    const int a = key[c];
                    if (slot[c] < D) {
                        nbr[static_cast<long long>(a) * D + slot[c]] = val[c];
                        atomicAdd(deg + a, 1);
                    } else {
                        atomicAdd(dover, 1);
                    }
                }
            }
            __syncthreads();
        }
        // Edge-list append in candidate order.
        for (int c = tid; c < B; c += nt) {
            if (take[c]) {
                int before = 0;
                for (int d = 0; d < c; ++d) before += take[d];
                const long long pos = static_cast<long long>(state[0]) + before;
                if (pos < cap) {
                    esrc[pos] = cu[c];
                    edst[pos] = cv[c];
                } else {
                    state[1] = 1;
                }
            }
        }
        __syncthreads();
        if (tid == 0) {
            int t = 0;
            for (int c = 0; c < B; ++c) t += take[c];
            state[0] += t;
        }
        __syncthreads();
    }
    if (tid == 0) {
        *n_acc = state[0];
        *overflow = static_cast<uint8_t>(state[1] != 0);
    }
}

constexpr int kSmemLimit = 227 * 1024;

int edge_smem_bytes(int D, int F, int k) {
    return static_cast<int>(sizeof(int)) *
           (sort_span(D, F, k) + F + kEdgeThreads + 2);
}

int warp_smem_bytes(int D, int F, int k) {
    return static_cast<int>(sizeof(int)) *
           (sort_span(D, F, k) + F + kWarp + 2);
}

int batch_smem_bytes(int B) {
    return static_cast<int>(sizeof(int)) * (4 * B + 2);
}

}  // namespace

// Shared memory one launch of entry 1 needs, or of entry 2 with `warps`
// warps, in bytes (the wrapper refuses shapes that exceed the card's).
extern "C" int spanner_gate_smem_bytes(int D, int F, int k, int B,
                                       int warps) {
    if (B <= 0) return edge_smem_bytes(D, F, k);
    return batch_smem_bytes(B) + warps * warp_smem_bytes(D, F, k);
}

extern "C" int spanner_gate_smem_limit() { return kSmemLimit; }

extern "C" int spanner_sparse_insert_edges(
        void* nbr, void* deg, void* dover, void* esrc, void* edst,
        void* n_acc, void* overflow, const void* src, const void* dst,
        const void* valid, long long n_lanes, int n, long long cap, int k,
        int D, int F, void* stream) {
    if (n_lanes <= 0) return 0;
    if (n <= 0 || D <= 0 || F <= 0 || k < 0 || cap <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int bytes = edge_smem_bytes(D, F, k);
    if (bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(
        sparse_insert_edges_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    sparse_insert_edges_kernel<<<1, kEdgeThreads, bytes,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(nbr), static_cast<int32_t*>(deg),
        static_cast<int32_t*>(dover), static_cast<int32_t*>(esrc),
        static_cast<int32_t*>(edst), static_cast<int32_t*>(n_acc),
        static_cast<uint8_t*>(overflow), static_cast<const int32_t*>(src),
        static_cast<const int32_t*>(dst), static_cast<const uint8_t*>(valid),
        n_lanes, n, cap, k, D, F, sort_span(D, F, k));
    return static_cast<int>(cudaGetLastError());
}

extern "C" int spanner_sparse_insert_edges_batched(
        void* nbr, void* deg, void* dover, void* esrc, void* edst,
        void* n_acc, void* overflow, const void* csrc, const void* cdst,
        const void* n_valid, long long ccap, int n, long long cap, int k,
        int D, int F, int B, int warps, void* stream) {
    if (ccap <= 0) return 0;
    if (n <= 0 || D <= 0 || F <= 0 || k < 0 || cap <= 0 || B <= 0 ||
        warps < 1 || warps > kMaxWarps)
        return static_cast<int>(cudaErrorInvalidValue);
    const int bytes = spanner_gate_smem_bytes(D, F, k, B, warps);
    if (bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(
        sparse_insert_edges_batched_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    sparse_insert_edges_batched_kernel<<<1, warps * kWarp, bytes,
                                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(nbr), static_cast<int32_t*>(deg),
        static_cast<int32_t*>(dover), static_cast<int32_t*>(esrc),
        static_cast<int32_t*>(edst), static_cast<int32_t*>(n_acc),
        static_cast<uint8_t*>(overflow), static_cast<const int32_t*>(csrc),
        static_cast<const int32_t*>(cdst),
        static_cast<const int32_t*>(n_valid), ccap, n, cap, k, D, F,
        sort_span(D, F, k), B);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spanner_gate_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
