// spanner_fold_k2 — the sparse k-spanner's k = 2 chunk fold (gate_batch).
//
// Replaces gelly_tpu/library/spanner.py:213, _sparse_fold_chunk_k2: a
// lax.scan over a chunk's sub-batches of `sub` lanes (an XLA device loop;
// there is no Pallas kernel on this path; its plain PyTorch version is
// about 130 launches a sub-batch). It returns exactly what the JAX
// function returns, on the summary's own tensors, updated in place. For each
// sub-batch in order, against the rows as they stand at its start:
//
//   * the gate: a lane (u, v) is live when valid and u != v, and taken
//     unless v is in row u (direct) or rows u and v share an entry >= 0
//     (common): dist(u, v) <= 2 in closed form;
//   * deduplication: of the taken lanes with one unordered pair, only the
//     lowest lane is kept (JAX's stable sort of min * N + max);
//   * two row appends, u -> v for every kept lane, then v -> u: appends to
//     one row take slots deg[row], deg[row] + 1, ... in lane order, one
//     at slot >= D is dropped and counted in deg_overflow, and deg grows
//     by the appends that fit (_row_append_batch);
//   * the edge list: kept lanes at n, n + 1, ... in lane order, stored
//     while the list has room, the sticky overflow flag set for the rest,
//     n counting every kept lane.
//
// Ids of live lanes must lie in [0, n) (a lane outside is skipped, as in
// spanner_gate.cu), and each row must hold -1 past its fill count, as
// every summary does (the appends only ever write slot deg[row]).
//
// Bound on an H100: per lane it reads src, dst, valid (9 B) and two rows
// (8 D B), and writes a few words for a kept lane, so a 2^22-lane chunk
// is about 0.6 GB, 0.2 ms at 3.35 TB/s. The real floor is the chain of
// dependent sub-batches: each one's gate reads the rows the one before
// appended to (256 sub-batches of 2^14 lanes a chunk on the card's path).
//
// Design: one cooperative launch walks every sub-batch; its blocks split
// the sub-batch's lanes and meet at a grid barrier between four phases,
// so nothing waits on the host and each phase runs across the card:
//
//   1. the gate of every lane, and for a taken lane an insert of its pair
//      into a scratch hash table whose slots hold lane numbers: a slot
//      keeps the lowest lane of its pair (compare-and-swap,
//      lowest_lane.cuh), so after the barrier a taken lane is kept iff
//      its slot holds it;
//   2. pass 1's row appends, ranked in lane order without a sort: a kept
//      lane writes the mark INT_MIN + lane into the row's first free slot
//      with atomicMin and carries whichever mark lost onwards, slot by
//      slot, to slot D - 1 (a carried mark past it is an overflow). The
//      free slots then hold the lowest lanes' marks in lane order,
//      whatever the order the threads ran in; each block counts its kept
//      lanes;
//   3. each kept lane finds its pass-1 mark and writes v over it (and
//      counts it in deg), appends itself to the edge list (the blocks'
//      counts and an in-block scan give lane order), and starts pass 2
//      the same way with marks INT_MIN + 2^30 + lane, from the first slot
//      past pass 1's (pass-1 marks, resolved or not, are skipped);
//   4. each kept lane writes u over its pass-2 mark and clears its hash
//      slot; block 0 advances n.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lowest_lane.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;
constexpr int kHead = 32;  // the barrier counter's word, padded
constexpr int kMark1 = INT_MIN;
constexpr int kMark2 = INT_MIN + (1 << 30);

struct Params {
    int32_t* nbr;
    int32_t* deg;
    int32_t* dover;
    int32_t* esrc;
    int32_t* edst;
    int32_t* n_acc;
    uint8_t* overflow;
    const int32_t* src;
    const int32_t* dst;
    const uint8_t* valid;
    unsigned* bar;
    int32_t* bcnt;  // kept lanes of each block in the current sub-batch
    int32_t* lst;   // a lane's hash slot (-1 not taken, -2 a duplicate)
    int32_t* hash;  // lane numbers, -1 free
    long long B;
    long long cap;  // edge-list lanes
    int n;
    int D;
    int span;   // lanes a sub-batch
    int per;    // lanes a block, a multiple of kThreads
    int tiles;  // per / kThreads
    int hmask;
};

__device__ __forceinline__ unsigned pair_hash(int a, int b, int n,
                                              int mask) {
    const unsigned long long key =
        static_cast<unsigned long long>(a) * static_cast<unsigned>(n) + b;
    return static_cast<unsigned>((key * 0x9E3779B97F4A7C15ULL) >> 32) &
           static_cast<unsigned>(mask);
}

// Every block meets here; the writes before it are visible after it.
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& target) {
    target += gridDim.x;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
        atomicAdd(bar, 1u);
        while (*static_cast<volatile unsigned*>(bar) < target) {
        }
        __threadfence();
    }
    __syncthreads();
}

// Sum of x over the block (every thread gets it); sh holds kThreads ints.
__device__ int block_sum(int x, int* sh) {
    sh[threadIdx.x] = x;
    __syncthreads();
    for (int half = kThreads / 2; half > 0; half >>= 1) {
        if (threadIdx.x < half) sh[threadIdx.x] += sh[threadIdx.x + half];
        __syncthreads();
    }
    const int total = sh[0];
    __syncthreads();
    return total;
}

// Exclusive prefix sum of x in thread order; *total gets the block's sum.
__device__ int block_exclusive_scan(int x, int* sh, int* total) {
    const int t = threadIdx.x;
    sh[t] = x;
    __syncthreads();
    for (int off = 1; off < kThreads; off <<= 1) {
        const int y = t >= off ? sh[t - off] : 0;
        __syncthreads();
        sh[t] += y;
        __syncthreads();
    }
    const int incl = sh[t];
    *total = sh[kThreads - 1];
    __syncthreads();
    return incl - x;
}

// Row slots k0 .. k0 + 15 into x (`pad` past D): one round trip.
__device__ __forceinline__ void load16(const int32_t* row, int k0, int D,
                                       int pad, int* x) {
#pragma unroll
    for (int t = 0; t < 16; ++t)
        x[t] = k0 + t < D ? __ldcg(row + k0 + t) : pad;
}

// dist(u, v) <= 2 over rows u and v: v in row u, or a shared entry >= 0.
// Both rows' slots are loaded before any compare (one round trip a
// 16-slot block of each).
__device__ bool within_2(const int32_t* nbr, int D, int u, int v) {
    const int32_t* ru = nbr + static_cast<long long>(u) * D;
    const int32_t* rv = nbr + static_cast<long long>(v) * D;
    for (int a0 = 0; a0 < D; a0 += 16) {
        int x[16];
        load16(ru, a0, D, -1, x);
        for (int b0 = 0; b0 < D; b0 += 16) {
            int w[16];
            load16(rv, b0, D, -1, w);
            bool hit = false;
#pragma unroll
            for (int s = 0; s < 16; ++s) {
                hit |= b0 == 0 && x[s] == v;
                if (x[s] < 0) continue;
#pragma unroll
                for (int t = 0; t < 16; ++t) hit |= x[s] == w[t];
            }
            if (hit) return true;
        }
    }
    return false;
}

// Place `mark` in row[k..D) in mark order (atomicMin, the loser carried
// on); returns false when a mark was carried past slot D - 1.
__device__ bool place_mark(int32_t* row, int k, int D, int mark) {
    for (; k < D; ++k) {
        const int old = atomicMin(row + k, mark);
        if (old == -1) return true;
        mark = old > mark ? old : mark;
    }
    return false;
}

// Write `val` over this lane's `mark` in the row and count it in deg.
__device__ void resolve_mark(int32_t* row, int32_t* deg_row, int D,
                             int mark, int val) {
    for (int k0 = 0; k0 < D; k0 += 16) {
        int x[16];
        load16(row, k0, D, 0, x);
#pragma unroll
        for (int t = 0; t < 16; ++t) {
            if (x[t] == mark) {
                row[k0 + t] = val;
                atomicAdd(deg_row, 1);
                return;
            }
        }
    }
}

__device__ __forceinline__ bool pass2_free(int x) {
    return x == -1 || (x < 0 && x >= kMark2);
}

// Pass 2's first slot: the first -1 or pass-2 mark at or past the fill
// count (read while pass 1's marks resolve: it lies in [deg0, deg1], and
// the slots before deg1 hold pass-1 marks or values).
__device__ int pass2_start(const int32_t* row, const int32_t* deg_row,
                           int D) {
    const int start = __ldcg(deg_row);
    for (int k0 = 0; k0 < D; k0 += 16) {
        int x[16];
        load16(row, k0, D, 0, x);
#pragma unroll
        for (int t = 0; t < 16; ++t)
            if (k0 + t >= start && k0 + t < D && pass2_free(x[t]))
                return k0 + t;
    }
    return D;
}

__global__ void __launch_bounds__(kThreads)
fold_k2_kernel(Params p) {
    __shared__ int sh[kThreads];
    __shared__ int s_kept;
    const int t = threadIdx.x;
    const int first = blockIdx.x * p.per;
    unsigned target = 0;
    int dropped = 0;  // appends past a full row, this thread's
    const long long n_sub = (p.B + p.span - 1) / p.span;
    for (long long j = 0; j < n_sub; ++j) {
        const long long lo = j * p.span;
        const long long rest = p.B - lo;
        const int lanes = rest < p.span ? static_cast<int>(rest) : p.span;

        // 1. The gate; a taken lane's pair into the hash table.
        for (int m = 0; m < p.tiles; ++m) {
            const int l = first + m * kThreads + t;
            if (l >= lanes) break;
            const long long g = lo + l;
            const int u = __ldg(p.src + g);
            const int v = __ldg(p.dst + g);
            int slot = -1;
            if (__ldg(p.valid + g) && u != v && u >= 0 && u < p.n &&
                v >= 0 && v < p.n && !within_2(p.nbr, p.D, u, v)) {
                const int a = u < v ? u : v;
                const int b = u < v ? v : u;
                slot = lowest_lane_insert(
                    p.hash, static_cast<unsigned>(p.hmask),
                    pair_hash(a, b, p.n, p.hmask), l, [&](int o) {
                        const int ou = __ldg(p.src + lo + o);
                        const int ov = __ldg(p.dst + lo + o);
                        return (ou < ov ? ou : ov) == a &&
                               (ou < ov ? ov : ou) == b;
                    });
            }
            p.lst[l] = slot;
        }
        grid_sync(p.bar, target);

        // 2. Kept lanes (the lowest of their pair); pass 1's marks.
        if (t == 0) s_kept = 0;
        __syncthreads();
        for (int m = 0; m < p.tiles; ++m) {
            const int l = first + m * kThreads + t;
            if (l >= lanes) break;
            const int slot = p.lst[l];
            if (slot < 0) continue;
            if (__ldcg(p.hash + slot) != l) {
                p.lst[l] = -2;
                continue;
            }
            atomicAdd(&s_kept, 1);
            const long long g = lo + l;
            const int u = __ldg(p.src + g);
            int32_t* row = p.nbr + static_cast<long long>(u) * p.D;
            if (!place_mark(row, __ldcg(p.deg + u), p.D, kMark1 + l))
                ++dropped;
        }
        __syncthreads();
        if (t == 0) p.bcnt[blockIdx.x] = s_kept;
        grid_sync(p.bar, target);

        // 3. Pass 1's values; the edge list; pass 2's marks.
        int before = 0;
        int all = 0;
        for (int b = t; b < static_cast<int>(gridDim.x); b += kThreads) {
            const int c = __ldcg(p.bcnt + b);
            all += c;
            if (b < static_cast<int>(blockIdx.x)) before += c;
        }
        before = block_sum(before, sh);
        all = block_sum(all, sh);
        const long long n0 = __ldcg(p.n_acc);
        long long next = n0 + before;
        for (int m = 0; m < p.tiles; ++m) {
            const int l = first + m * kThreads + t;
            const bool kept = l < lanes && p.lst[l] >= 0;
            int tile_total;
            const int ex = block_exclusive_scan(kept ? 1 : 0, sh,
                                                &tile_total);
            if (kept) {
                const long long g = lo + l;
                const int u = __ldg(p.src + g);
                const int v = __ldg(p.dst + g);
                resolve_mark(p.nbr + static_cast<long long>(u) * p.D,
                             p.deg + u, p.D, kMark1 + l, v);
                const long long pos = next + ex;
                if (pos < p.cap) {
                    p.esrc[pos] = u;
                    p.edst[pos] = v;
                } else {
                    *p.overflow = 1;
                }
                int32_t* row = p.nbr + static_cast<long long>(v) * p.D;
                if (!place_mark(row, pass2_start(row, p.deg + v, p.D), p.D,
                                kMark2 + l))
                    ++dropped;
            }
            next += tile_total;
        }
        grid_sync(p.bar, target);

        // 4. Pass 2's values; the hash table cleared; n advanced.
        for (int m = 0; m < p.tiles; ++m) {
            const int l = first + m * kThreads + t;
            if (l >= lanes) break;
            const int slot = p.lst[l];
            if (slot < 0) continue;
            const long long g = lo + l;
            const int u = __ldg(p.src + g);
            const int v = __ldg(p.dst + g);
            resolve_mark(p.nbr + static_cast<long long>(v) * p.D,
                         p.deg + v, p.D, kMark2 + l, u);
            p.hash[slot] = -1;
        }
        if (blockIdx.x == 0 && t == 0)
            *p.n_acc = static_cast<int32_t>(n0 + all);
        grid_sync(p.bar, target);
    }
    dropped = block_sum(dropped, sh);
    if (t == 0 && dropped) atomicAdd(p.dover, dropped);
}

}  // namespace

extern "C" long long spanner_fold_k2_scratch_ints(long long span) {
    return kHead + kMaxBlocks + span + lowest_lane_slots(span);
}

extern "C" int spanner_fold_k2_launch(
        void* nbr, void* deg, void* dover, void* esrc, void* edst,
        void* n_acc, void* overflow, const void* src, const void* dst,
        const void* valid, void* scratch, long long n_lanes, int n,
        long long cap, int D, int span, void* stream) {
    if (n_lanes <= 0) return 0;
    // A pending append is marked with its lane in one of two ranges of
    // 2^30 values below -1 (one a pass): a sub-batch holds at most
    // 2^30 - 2 lanes.
    if (n <= 0 || D <= 0 || cap <= 0 || span <= 0 || span > n_lanes ||
        span > (1 << 30) - 2)
        return static_cast<int>(cudaErrorInvalidValue);
    int dev = 0;
    int sms = 0;
    int per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, fold_k2_kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    long long blocks = (span + kThreads - 1) / kThreads;
    const long long room = static_cast<long long>(sms) * per_sm;
    if (blocks > room) blocks = room;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    Params p;
    p.nbr = static_cast<int32_t*>(nbr);
    p.deg = static_cast<int32_t*>(deg);
    p.dover = static_cast<int32_t*>(dover);
    p.esrc = static_cast<int32_t*>(esrc);
    p.edst = static_cast<int32_t*>(edst);
    p.n_acc = static_cast<int32_t*>(n_acc);
    p.overflow = static_cast<uint8_t*>(overflow);
    p.src = static_cast<const int32_t*>(src);
    p.dst = static_cast<const int32_t*>(dst);
    p.valid = static_cast<const uint8_t*>(valid);
    int32_t* base = static_cast<int32_t*>(scratch);
    p.bar = reinterpret_cast<unsigned*>(base);
    p.bcnt = base + kHead;
    p.lst = p.bcnt + kMaxBlocks;
    p.hash = p.lst + span;
    p.B = n_lanes;
    p.cap = cap;
    p.n = n;
    p.D = D;
    p.span = span;
    const long long lanes_a_block = (span + blocks - 1) / blocks;
    p.tiles = static_cast<int>((lanes_a_block + kThreads - 1) / kThreads);
    p.per = p.tiles * kThreads;
    const long long slots = lowest_lane_slots(span);
    p.hmask = static_cast<int>(slots - 1);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    err = cudaMemsetAsync(p.bar, 0, sizeof(unsigned), s);
    if (err == cudaSuccess)
        err = cudaMemsetAsync(p.hash, 0xff, slots * sizeof(int32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    void* args[] = {&p};
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(fold_k2_kernel),
        dim3(static_cast<unsigned>(blocks)), dim3(kThreads), args, 0, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spanner_fold_k2_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
