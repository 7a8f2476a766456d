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
// spanner_gate.cu), and each row must hold values >= 0 up to its fill
// count and -1 past it, as every summary does.
//
// Bound on an H100: per lane it reads src, dst, valid (9 B) and two rows
// (8 D B), and writes a few words for a kept lane, so a 2^22-lane chunk
// is about 0.6 GB, 0.2 ms at 3.35 TB/s. The real floor is the chain of
// dependent sub-batches: each one's gate reads the rows the one before
// appended to (256 sub-batches of 2^14 lanes a chunk on the card's path).
//
// Design: one grid barrier a sub-batch. Three facts of the semantics make
// the chain short:
//
//   1. The dedup does not depend on the rows. Lanes of one sub-batch with
//      one ordered pair (a, b) gate alike, so the lowest taken lane of
//      {a, b} is the first live lane of (a, b) or of (b, a). A prepass
//      over the whole chunk, off the chain, finds for each lane whether it
//      is the first live lane of its ordered pair in its sub-batch and, if
//      so, the first lane of the reversed pair (`rev`): a lowest-lane hash
//      table keyed by (sub-batch, u, v) (as lowest_lane.cuh), then one
//      probe for the reversed key. A lane then decides alone: kept iff its
//      own gate passes and the reversed lane is absent, higher, or fails
//      its gate (u in row v), which the lane computes from the same two
//      rows.
//   2. Pass 1 and pass 2 rank as one: a row ends with its old entries,
//      the kept lanes with u == row in lane order, those with v == row,
//      cut at D. So each kept lane places two marks at once, keyed by
//      (pass, lane): atomicMin into the row's first free slot, the loser
//      carried on slot by slot (a mark carried past D - 1 is an overflow).
//      The free slots then hold the lowest marks in (pass, lane) order,
//      whatever order the threads ran in. A mark is INT_MIN + (pass << 30)
//      + g, g the lane's index in the chunk (so a chunk holds at most
//      2^30 - 1 lanes; the launch refuses a wider one).
//   3. A gate reads pending marks. Sub-batch j (lanes from lo) decodes a
//      mark with g < lo to dst[g] (pass 1) or src[g] (pass 2), and reads
//      one with g >= lo, its own, as a free slot. So a row's fill count at
//      the sub-batch's start is the number of slots that hold a value or
//      an earlier mark, and every slot reads the same for the whole phase,
//      however the other threads' appends interleave with the read. No
//      phase waits for values to be written over marks, and none reads
//      deg.
//
// The prepass is two launches over the chunk, a lane a thread: every live
// lane into one table, then the probes. Then one cooperative launch walks
// the chain, one phase a sub-batch; a thread keeps the same lane of every
// sub-batch. In a phase each candidate lane loads both its rows (one
// round trip, int4 loads through L1: the barrier's acquire makes the
// phase's reads current, and a hub row read by thousands of lanes is
// fetched from L2 once an SM), decodes them, gates both orientations,
// sets its kept flag and places its two marks; the lanes of the next
// sub-batch are loaded meanwhile. Then the grid barrier. The blocks
// spread a sub-batch over every SM (2^14 lanes: 132 blocks of 128
// threads, a lane a thread). After the last barrier the chain's tail
// lists the kept lanes in lane order (a scan of the flags over the grid:
// one more barrier), and a last plain launch (fold_k2_finish) writes them
// to the edge list and their values over their marks, one more in deg
// each. The chain also writes the grid barriers it met, read off the
// barrier counter, to the caller's `met`.

#include <algorithm>
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_barrier.cuh"
#include "lowest_lane.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 2048;
constexpr int kHead = 32;  // the barrier counter and two words, padded
constexpr int kPrepassThreads = 256;
constexpr int kFinishThreads = 256;
constexpr int kLaneMask = (1 << 30) - 1;
constexpr int kMaxLanes = kLaneMask;  // the last lane's marks stay below -1
constexpr int kNone = INT_MAX;        // no reversed pair in the sub-batch
constexpr unsigned kFull = 0xffffffffu;

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
    const int32_t* rev;  // the prepass's answer for each lane (klist's
                         // room after the chain: plain loads, never nc)
    unsigned* bar;
    int32_t* bcnt;  // kept lanes of each block's stretch of the chunk
    uint8_t* kf;    // kept flag of each lane of the chunk
    int32_t* klist;  // the kept lanes in lane order (written over rev)
    int32_t* kept;   // the chunk's kept lanes and n before it
    int32_t* met;    // the grid barriers the chain met (one int)
    long long cap;  // edge-list lanes
    int B;
    int n;
    int D;
    int span;   // lanes a sub-batch
    int per;    // lanes a block
    int tiles;  // lanes a thread, at most: ceil(per / kThreads)
    bool vec;   // rows load as int4
};

__device__ __forceinline__ long long lmin(long long a, long long b) {
    return a < b ? a : b;
}

__device__ __forceinline__ int make_mark(int pas, int g) {
    return static_cast<int>(0x80000000u + (static_cast<unsigned>(pas) << 30) +
                            static_cast<unsigned>(g));
}

__device__ __forceinline__ unsigned pair_slot(int j, int a, int b, int n,
                                              unsigned mask) {
    unsigned long long key =
        static_cast<unsigned long long>(a) * static_cast<unsigned>(n) +
        static_cast<unsigned>(b);
    key ^= static_cast<unsigned long long>(j) * 0xD6E8FEB86659FD93ULL;
    return static_cast<unsigned>((key * 0x9E3779B97F4A7C15ULL) >> 32) & mask;
}

__device__ __forceinline__ bool live_lane(const int32_t* src,
                                          const int32_t* dst,
                                          const uint8_t* valid, int g, int n,
                                          int& u, int& v) {
    u = __ldg(src + g);
    v = __ldg(dst + g);
    return __ldg(valid + g) && u != v && u >= 0 && u < n && v >= 0 && v < n;
}

// Prepass 1: every live lane into the table, keyed by (sub-batch, u, v),
// each key's slot keeping its lowest lane; rev[g] = the key's slot, or
// -1 for a lane that is not live.
__global__ void prepass_insert(const int32_t* src, const int32_t* dst,
                               const uint8_t* valid, int* table,
                               unsigned mask, int32_t* rev, int B, int span,
                               int n) {
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long i = blockIdx.x * blockDim.x + threadIdx.x; i < B;
         i += stride) {
        const int g = static_cast<int>(i);
        int u, v;
        int slot = -1;
        if (live_lane(src, dst, valid, g, n, u, v)) {
            const int j = g / span;
            slot = lowest_lane_insert(
                table, mask, pair_slot(j, u, v, n, mask), g, [&](int o) {
                    return o / span == j && __ldg(src + o) == u &&
                           __ldg(dst + o) == v;
                });
        }
        rev[g] = slot;
    }
}

// Prepass 2: rev[g] = -1 unless g is its key's lowest lane; then the
// lowest lane of the reversed key in the sub-batch (as a lane of the
// sub-batch), or kNone.
__global__ void prepass_lookup(const int32_t* src, const int32_t* dst,
                               const int* table, unsigned mask, int32_t* rev,
                               int B, int span, int n) {
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long i = blockIdx.x * blockDim.x + threadIdx.x; i < B;
         i += stride) {
        const int g = static_cast<int>(i);
        const int s = rev[g];
        if (s < 0) continue;
        if (__ldg(table + s) != g) {
            rev[g] = -1;
            continue;
        }
        const int j = g / span;
        const int u = __ldg(src + g);
        const int v = __ldg(dst + g);
        unsigned h = pair_slot(j, v, u, n, mask);
        int r = kNone;
        for (;;) {
            const int o = __ldg(table + h);
            if (o == -1) break;
            if (o / span == j && __ldg(src + o) == v && __ldg(dst + o) == u) {
                r = o - j * span;
                break;
            }
            h = (h + 1) & mask;
        }
        rev[g] = r;
    }
}

// Row slots k0 .. k0 + 15 into x, -1 past D: one round trip (int4 loads
// when `vec`: D % 4 == 0 and the table 16-byte aligned). Plain loads,
// cached in L1: within a phase every slot reads the same whenever it is
// read, and the barrier's acquire orders the phase's reads after the
// phase before's writes.
__device__ __forceinline__ void load_chunk(const int32_t* row, int k0, int D,
                                           bool vec, int (&x)[16]) {
    if (vec) {
        const int4* r4 = reinterpret_cast<const int4*>(row + k0);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            int4 w = make_int4(-1, -1, -1, -1);
            if (k0 + 4 * q < D) w = r4[q];
            x[4 * q] = w.x;
            x[4 * q + 1] = w.y;
            x[4 * q + 2] = w.z;
            x[4 * q + 3] = w.w;
        }
    } else {
#pragma unroll
        for (int s = 0; s < 16; ++s) x[s] = k0 + s < D ? row[k0 + s] : -1;
    }
}

// Slots as the gate of the sub-batch whose lanes start at `lo` reads
// them: its own marks free (-1), earlier marks their values. The lookups
// go out together.
__device__ __forceinline__ void decode_chunk(int (&x)[16], long long lo,
                                             const int32_t* src,
                                             const int32_t* dst) {
    int y[16];
#pragma unroll
    for (int s = 0; s < 16; ++s) {
        y[s] = x[s];
        if (x[s] < -1) {
            const unsigned m = static_cast<unsigned>(x[s]);
            const int g = static_cast<int>(m & kLaneMask);
            y[s] = -1;
            if (g < lo) y[s] = __ldg(((m >> 30) & 1u ? src : dst) + g);
        }
    }
#pragma unroll
    for (int s = 0; s < 16; ++s) x[s] = y[s];
}

struct Gate {
    bool direct_ab = false;  // v in row u
    bool direct_ba = false;  // u in row v
    bool common = false;     // an entry >= 0 in both rows
    int fill_u = 0;          // row u's fill count at the sub-batch's start
    int fill_v = 0;
};

// Adds a decoded pair of 16-slot chunks to the gate (`first_u`: this is
// row u's first chunk, so row v's chunk is counted once; `first_v` the
// same for row u's).
__device__ __forceinline__ void gate_chunks(const int (&xu)[16],
                                            const int (&xv)[16], int u, int v,
                                            bool first_u, bool first_v,
                                            Gate& g) {
    int hits[8] = {0, 0, 0, 0, 0, 0, 0, 0};  // eight sums, not one chain
#pragma unroll
    for (int s = 0; s < 16; ++s) {
        if (first_v) {
            g.fill_u += xu[s] >= 0;
            g.direct_ab |= xu[s] == v;
        }
        if (first_u) {
            g.fill_v += xv[s] >= 0;
            g.direct_ba |= xv[s] == u;
        }
        const int a = xu[s] >= 0 ? xu[s] : -3;  // -3 matches no slot
#pragma unroll
        for (int t = 0; t < 16; ++t) hits[t & 7] += a == xv[t];
    }
    g.common |= (hits[0] | hits[1] | hits[2] | hits[3] | hits[4] | hits[5] |
                 hits[6] | hits[7]) != 0;
}

// The gate of lane (u, v): the first 16 slots of both rows in one round
// trip, then, for D > 16, every other pair of 16-slot chunks (each slot
// reads the same whenever it is loaded in the phase, so a chunk may be
// loaded again).
__device__ Gate gate_rows(const Params& p, int u, int v, long long lo) {
    const int32_t* ru = p.nbr + static_cast<long long>(u) * p.D;
    const int32_t* rv = p.nbr + static_cast<long long>(v) * p.D;
    Gate g;
    int xu[16];
    int xv[16];
    load_chunk(ru, 0, p.D, p.vec, xu);
    load_chunk(rv, 0, p.D, p.vec, xv);
    decode_chunk(xu, lo, p.src, p.dst);
    decode_chunk(xv, lo, p.src, p.dst);
    gate_chunks(xu, xv, u, v, true, true, g);
    for (int a0 = 0; a0 < p.D; a0 += 16) {
        if (a0 > 0) {
            load_chunk(ru, a0, p.D, p.vec, xu);
            decode_chunk(xu, lo, p.src, p.dst);
        }
        for (int b0 = a0 == 0 ? 16 : 0; b0 < p.D; b0 += 16) {
            load_chunk(rv, b0, p.D, p.vec, xv);
            decode_chunk(xv, lo, p.src, p.dst);
            gate_chunks(xu, xv, u, v, a0 == 0, b0 == 0, g);
        }
    }
    return g;
}

// Lane `l` (ordered pair (u, v), reversed lane `r`) is kept: its own gate
// passes, and the reversed pair's first lane is absent, higher, or fails.
__device__ __forceinline__ bool kept_lane(const Gate& g, int l, int r) {
    return !(g.direct_ab || g.common) && (r > l || g.direct_ba);
}

// Places the marks of both passes of lane g, each from its row's fill
// count, with atomicMin and carry. Returns the marks carried past D - 1.
__device__ int place_marks(const Params& p, int u, int v, const Gate& gate,
                           int g) {
    int32_t* ru = p.nbr + static_cast<long long>(u) * p.D;
    int32_t* rv = p.nbr + static_cast<long long>(v) * p.D;
    int ku = gate.fill_u;
    int kv = gate.fill_v;
    int mu = make_mark(0, g);
    int mv = make_mark(1, g);
    bool au = ku < p.D;
    bool av = kv < p.D;
    int dropped = !au + !av;
    while (au || av) {
        int ou = -1;
        int ov = -1;
        if (au) ou = atomicMin(ru + ku, mu);
        if (av) ov = atomicMin(rv + kv, mv);
        if (au) {
            if (ou == -1) {
                au = false;
            } else {
                mu = ou > mu ? ou : mu;
                if (++ku == p.D) {
                    au = false;
                    ++dropped;
                }
            }
        }
        if (av) {
            if (ov == -1) {
                av = false;
            } else {
                mv = ov > mv ? ov : mv;
                if (++kv == p.D) {
                    av = false;
                    ++dropped;
                }
            }
        }
    }
    return dropped;
}

// Writes `val` over `mark` in row `row_id` and counts it in deg (a mark
// carried past D - 1 is in no slot: nothing to write).
__device__ void resolve_mark(const Params& p, int row_id, int mark, int val) {
    int32_t* row = p.nbr + static_cast<long long>(row_id) * p.D;
    for (int k0 = 0; k0 < p.D; k0 += 16) {
        int x[16];
        load_chunk(row, k0, p.D, p.vec, x);
#pragma unroll
        for (int s = 0; s < 16; ++s) {
            if (x[s] == mark) {
                row[k0 + s] = val;
                atomicAdd(p.deg + row_id, 1);
                return;
            }
        }
    }
}

// Kept flags among the first n bytes of w (each byte 0 or 1).
__device__ __forceinline__ int kept_in(uint4 w, int n) {
    const unsigned x[4] = {w.x, w.y, w.z, w.w};
    int c = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int m = n - 4 * k;
        const unsigned mask = m >= 4 ? 0x01010101u
                              : m <= 0 ? 0u
                                       : 0x01010101u & ((1u << (8 * m)) - 1u);
        c += __popc(x[k] & mask);
    }
    return c;
}

// Exclusive sum of x over the block in thread order; *total the block's.
__device__ __forceinline__ int block_scan(int x, int* total, int* sh) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    int incl = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
    }
    if (lane == 31) sh[warp] = incl;
    __syncthreads();
    int before = 0;
    int all = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
        all += sh[w];
        before += w < warp ? sh[w] : 0;
    }
    __syncthreads();
    *total = all;
    return before + incl - x;
}

// Sums of a and b over the block (every thread gets them).
__device__ __forceinline__ void block_sum2(int& a, int& b, int* sh) {
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        a += __shfl_xor_sync(kFull, a, o);
        b += __shfl_xor_sync(kFull, b, o);
    }
    if ((threadIdx.x & 31) == 0) {
        sh[warp] = a;
        sh[kWarps + warp] = b;
    }
    __syncthreads();
    a = 0;
    b = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
        a += sh[w];
        b += sh[kWarps + w];
    }
    __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
fold_k2_chain(Params p) {
    __shared__ int sh[2 * kWarps];
    const int t = threadIdx.x;
    const int b = blockIdx.x;
    const int first = b * p.per;
    const int nsub = (p.B - 1) / p.span + 1;
    const long long n0 = p.n_acc[0];
    unsigned target = 0;
    int dropped = 0;
    // Tile 0's lane of the coming sub-batch, loaded ahead.
    const int l0 = first + t;
    int cu = 0;
    int cv = 0;
    int cr = -1;
    if (t < p.per && l0 < p.span) {
        cu = __ldg(p.src + l0);
        cv = __ldg(p.dst + l0);
        cr = p.rev[l0];
    }
    for (int j = 0; j < nsub; ++j) {
        const long long lo = static_cast<long long>(j) * p.span;
        const int lanes = static_cast<int>(lmin(p.span, p.B - lo));
        // The next sub-batch's tile-0 lane, loaded while this one gates.
        const long long nlo = lo + p.span;
        int nu = 0;
        int nv = 0;
        int nr = -1;
        if (t < p.per && l0 < p.span && nlo + l0 < p.B) {
            nu = __ldg(p.src + nlo + l0);
            nv = __ldg(p.dst + nlo + l0);
            nr = p.rev[nlo + l0];
        }
        for (int m = 0; m < p.tiles; ++m) {
            const int l = first + m * kThreads + t;
            if (m * kThreads + t >= p.per || l >= lanes) break;
            const int g = static_cast<int>(lo) + l;
            int u = cu;
            int v = cv;
            int r = cr;
            if (m > 0) {
                u = __ldg(p.src + g);
                v = __ldg(p.dst + g);
                r = p.rev[g];
            }
            bool kept = false;
            if (r >= 0) {
                const Gate gate = gate_rows(p, u, v, lo);
                kept = kept_lane(gate, l, r);
                p.kf[g] = kept;
                if (kept) dropped += place_marks(p, u, v, gate, g);
            } else {
                p.kf[g] = 0;
            }
        }
        cu = nu;
        cv = nv;
        cr = nr;
        grid_barrier(p.bar, target);
    }

    // The tail. Thread t of block b takes q lanes of the chunk from
    // (b * kThreads + t) * q, q a multiple of 16 (its flags load as
    // uint4): it counts its kept lanes, the counts are scanned over the
    // grid (one more barrier), and it lists its kept lanes at their places
    // in the edge list (fold_k2_finish then writes them).
    const long long threads = static_cast<long long>(gridDim.x) * kThreads;
    const long long q = ((p.B + threads - 1) / threads + 15) / 16 * 16;
    const long long a = (static_cast<long long>(b) * kThreads + t) * q;
    const long long e = lmin(a + q, p.B);  // none where a >= B
    const uint4* f4 = reinterpret_cast<const uint4*>(p.kf);
    int c = 0;
#pragma unroll 4
    for (long long w = a / 16; w * 16 < e; ++w)
        c += kept_in(f4[w], static_cast<int>(lmin(16, e - w * 16)));
    int block_total;
    const int ex = block_scan(c, &block_total, sh);
    if (t == 0) p.bcnt[b] = block_total;
    grid_barrier(p.bar, target);
    int before = 0;
    int total = 0;
    for (int k = t; k < static_cast<int>(gridDim.x); k += kThreads) {
        const int x = p.bcnt[k];
        total += x;
        before += k < b ? x : 0;
    }
    int unused = 0;
    block_sum2(before, total, sh);
    int at = before + ex;
    for (long long w = a / 16; w * 16 < e; ++w) {
        const uint4 word = f4[w];
        const unsigned x[4] = {word.x, word.y, word.z, word.w};
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            if ((x[i >> 2] >> (8 * (i & 3))) & 1u && w * 16 + i < e)
                p.klist[at++] = static_cast<int>(w * 16 + i);
        }
    }
    block_sum2(dropped, unused, sh);
    if (t == 0 && dropped) atomicAdd(p.dover, dropped);
    if (b == 0 && t == 0) {
        p.kept[0] = total;
        p.kept[1] = static_cast<int>(n0);
        p.n_acc[0] = static_cast<int32_t>(n0 + total);
        // Every block's add of the last barrier came before block 0 left
        // it, and none comes after: the counter is final. -1 if it is not
        // a whole number of barriers.
        const unsigned seen = load_acquire(p.bar);
        p.met[0] = seen % gridDim.x ? -1 : static_cast<int>(seen / gridDim.x);
    }
}

// After the chain: each listed kept lane (the i-th of the chunk, lane g)
// goes to the edge list at n0 + i, and its values over its marks, one more
// in deg each.
__global__ void __launch_bounds__(kFinishThreads)
fold_k2_finish(Params p) {
    const int total = p.kept[0];
    const long long n0 = p.kept[1];
    const int stride = gridDim.x * blockDim.x;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
         i += stride) {
        const int g = p.klist[i];
        const int u = __ldg(p.src + g);
        const int v = __ldg(p.dst + g);
        const long long at = n0 + i;
        if (at < p.cap) {
            p.esrc[at] = u;
            p.edst[at] = v;
        } else {
            *p.overflow = 1;
        }
        resolve_mark(p, u, make_mark(0, g), v);
        resolve_mark(p, v, make_mark(1, g), u);
    }
}

// The chain's floor: the same launch shape running only its barriers and
// one dependent row read a sub-batch (row src[lane], its address held on
// the row read before, so the reads form a chain).
__global__ void __launch_bounds__(kThreads)
fold_k2_floor(Params p) {
    const int t = threadIdx.x;
    const int first = blockIdx.x * p.per;
    const int nsub = (p.B - 1) / p.span + 1;
    unsigned target = 0;
    int dep = 0;
    int odd = 0;
    for (int j = 0; j < nsub; ++j) {
        const long long lo = static_cast<long long>(j) * p.span;
        const int lanes = static_cast<int>(lmin(p.span, p.B - lo));
        for (int m = 0; m < p.tiles; ++m) {
            const int off = m * kThreads + t;
            const int l = first + off;
            if (off >= p.per || l >= lanes) break;
            const int u = __ldg(p.src + lo + l) + dep;
            int x[16];
            load_chunk(p.nbr + static_cast<long long>(u) * p.D, 0, p.D, p.vec,
                       x);
            dep = x[0] == INT_MAX;  // never: rows hold ids < n and -1
            odd += x[15] == INT_MAX;
        }
        grid_barrier(p.bar, target);
    }
    if (odd) atomicAdd(p.dover, odd);
}

long long pad_ints(long long bytes) { return (bytes + 3) / 4; }

// The scratch's parts, in ints: the head (the barrier counter at 0, the
// chunk's kept count and n before it at kHead / 2), the block counts, the
// prepass's answers (then the kept lanes' list), its table, the kept
// flags.
struct Layout {
    long long rev, table, slots, kf, total;
};

Layout layout(long long n_lanes, long long span) {
    Layout s;
    s.rev = kHead + kMaxBlocks;
    s.table = s.rev + n_lanes;
    s.slots = lowest_lane_slots(n_lanes);
    s.kf = (s.table + s.slots + 3) / 4 * 4;  // 16-byte aligned
    s.total = s.kf + pad_ints(n_lanes + 16);
    return s;
}

// Checks the shape and fills Params (and the grid) for a launch of
// either kernel; returns a cudaError_t.
template <class Kernel>
int setup(Kernel kernel, Params& p, long long& blocks, int& sms, void* nbr,
          const void* src, void* scratch, long long n_lanes, int n, int D,
          int span) {
    if (n <= 0 || D <= 0 || span <= 0 || span > n_lanes ||
        n_lanes > kMaxLanes)
        return static_cast<int>(cudaErrorInvalidValue);
    int dev = 0;
    int per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                            kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    // A lane a thread where the card holds them; a sub-batch smaller than
    // the card's threads spreads over every SM, down to a warp a block.
    long long want = (span + kThreads - 1) / kThreads;
    if (want < sms) want = std::min<long long>(sms, (span + 31) / 32);
    const long long room = static_cast<long long>(sms) * per_sm;
    blocks = std::min<long long>(std::min<long long>(want, room), kMaxBlocks);
    if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const long long per = (span + blocks - 1) / blocks;
    blocks = (span + per - 1) / per;
    p.per = static_cast<int>(per);
    p.tiles = static_cast<int>((per + kThreads - 1) / kThreads);
    p.nbr = static_cast<int32_t*>(nbr);
    p.src = static_cast<const int32_t*>(src);
    p.B = static_cast<int>(n_lanes);
    p.n = n;
    p.D = D;
    p.span = span;
    p.vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(nbr) % 16 == 0;
    const Layout s = layout(n_lanes, span);
    int32_t* base = static_cast<int32_t*>(scratch);
    p.bar = reinterpret_cast<unsigned*>(base);
    p.bcnt = base + kHead;
    p.rev = base + s.rev;
    p.klist = base + s.rev;
    p.kept = base + kHead / 2;
    p.kf = reinterpret_cast<uint8_t*>(base + s.kf);
    return 0;
}

// The finish kernel's grid: enough threads for every lane of a small
// chunk, a few waves of the card for a large one.
int finish_grid(long long n_lanes, int sms) {
    return static_cast<int>(std::min<long long>(
        (n_lanes + kFinishThreads - 1) / kFinishThreads, 8LL * sms));
}

int grid_of(long long work) {
    return static_cast<int>(std::min<long long>(
        (work + kPrepassThreads - 1) / kPrepassThreads, 1 << 16));
}

}  // namespace

extern "C" long long spanner_fold_k2_scratch_ints(long long n_lanes,
                                                 long long span) {
    return layout(n_lanes, span).total;
}

extern "C" int spanner_fold_k2_launch(
        void* nbr, void* deg, void* dover, void* esrc, void* edst,
        void* n_acc, void* overflow, const void* src, const void* dst,
        const void* valid, void* scratch, void* met, long long n_lanes,
        int n, long long cap, int D, int span, void* stream) {
    if (n_lanes <= 0) return 0;
    if (cap <= 0) return static_cast<int>(cudaErrorInvalidValue);
    Params p;
    long long blocks = 0;
    int sms = 0;
    int rc = setup(fold_k2_chain, p, blocks, sms, nbr, src, scratch, n_lanes,
                   n, D, span);
    if (rc) return rc;
    p.deg = static_cast<int32_t*>(deg);
    p.dover = static_cast<int32_t*>(dover);
    p.esrc = static_cast<int32_t*>(esrc);
    p.edst = static_cast<int32_t*>(edst);
    p.n_acc = static_cast<int32_t*>(n_acc);
    p.overflow = static_cast<uint8_t*>(overflow);
    p.dst = static_cast<const int32_t*>(dst);
    p.cap = cap;
    p.met = static_cast<int32_t*>(met);
    const Layout s = layout(n_lanes, span);
    int32_t* rev = const_cast<int32_t*>(p.rev);
    int* table = static_cast<int32_t*>(scratch) + s.table;
    const unsigned mask = static_cast<unsigned>(s.slots - 1);
    const uint8_t* ok = static_cast<const uint8_t*>(valid);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(p.bar, 0, sizeof(unsigned), st);
    if (err == cudaSuccess)
        err = cudaMemsetAsync(table, 0xff, s.slots * sizeof(int32_t), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int grid = grid_of(n_lanes);
    prepass_insert<<<grid, kPrepassThreads, 0, st>>>(
        p.src, p.dst, ok, table, mask, rev, p.B, span, n);
    prepass_lookup<<<grid, kPrepassThreads, 0, st>>>(
        p.src, p.dst, table, mask, rev, p.B, span, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    void* args[] = {&p};
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(fold_k2_chain),
        dim3(static_cast<unsigned>(blocks)), dim3(kThreads), args, 0, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int grid_f = finish_grid(n_lanes, sms);
    fold_k2_finish<<<grid_f, kFinishThreads, 0, st>>>(p);
    return static_cast<int>(cudaGetLastError());
}

// The chain floor of a launch of the same shape: `n_lanes` lanes in
// sub-batches of `span`, each a barrier and one dependent row read a
// lane. `sink` takes one int (written only if a row held INT_MAX).
extern "C" int spanner_fold_k2_floor(void* nbr, const void* src,
                                     void* scratch, void* sink,
                                     long long n_lanes, int n, int D,
                                     int span, void* stream) {
    if (n_lanes <= 0) return 0;
    Params p;
    long long blocks = 0;
    int sms = 0;
    int rc = setup(fold_k2_floor, p, blocks, sms, nbr, src, scratch, n_lanes,
                   n, D, span);
    if (rc) return rc;
    p.dover = static_cast<int32_t*>(sink);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(p.bar, 0, sizeof(unsigned), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    void* args[] = {&p};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fold_k2_floor),
                                      dim3(static_cast<unsigned>(blocks)),
                                      dim3(kThreads), args, 0, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spanner_fold_k2_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
