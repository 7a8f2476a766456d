// spanner_gate — the sparse k-spanner's sequential gates, for Hopper.
//
// Replaces two XLA device loops of gelly_tpu/library/spanner.py (there is
// no Pallas kernel on this path; in eager PyTorch each loop would be one
// Python step and tens of launches per edge or per 64-edge batch):
//
//   * entry 1, spanner_sparse_insert_edges: _sparse_insert_edges, the
//     lax.scan that gates and inserts a chunk's edges one at a time;
//   * entry 2, spanner_sparse_insert_edges_batched:
//     _sparse_insert_edges_batched, the combine's lax.while_loop over
//     B-candidate batches of a donor spanner's edge list, with the donor's
//     count read on the device (no host sync per batch).
//
// Both return exactly what the JAX functions return, on the summary's own
// tensors, updated in place.
//
// The gate is _within_k_sparse: k rounds, each keeping the F smallest
// distinct ids of the frontier and the rows of its ids
// (jnp.unique(..., size=F, fill_value=n)); an edge (u, v) is taken when v
// is not in the last frontier. Row slots outside [0, n) never change which
// ids are live and are dropped. What the rounds decide depends only on
// sets, so no round sorts:
//
//   * Set argument. Let S_0 = {u}, T_r = S_{r-1} with the rows of its ids,
//     and S_r the F smallest distinct ids of T_r. A round only unions rows,
//     so T_r, as a set, is the same whatever order S_{r-1} is held in, and
//     with whatever repeats; the frontier is held unordered, as a multiset
//     while it is small.
//   * Rank test. v is in S_k iff v is in T_k and fewer than F distinct ids
//     of T_k lie below v. When fewer than F raw ids (repeats counted) lie
//     below v, fewer than F distinct ones do: no dedup.
//
// Each round reads its raw ids into shared memory (each frontier id's row,
// then the frontier) and takes one of these paths:
//
//   keep        a round before the last with at most F raw ids: they are
//               the next frontier, repeats and all. Every round with
//               L (D + 1) <= F does this: k = 2 with D + 1 <= F (F3's
//               shape, D = 16, F = 64) never dedups before the last round;
//   dedup       a round before the last with more than F raw ids: each
//               id goes into a shared-memory hash set, the first copy of
//               each stays. At most F distinct ids: they are the frontier
//               (k >= 3 rounds over hub rows, or D + 1 > F);
//   select      more than F distinct ids: the F-th smallest, t, by a
//               bitwise select from the top bit down (ids lie below
//               n <= 2^31: at each bit, a group sum counts the ids that
//               match the prefix above it and have a 0 there), and the
//               frontier is the distinct ids <= t;
//   last-miss   the last round does not hold v: taken;
//   last-raw    it holds v with fewer than F raw ids below v: dropped;
//   last-dedup  F or more raw ids below v (hub rows, many repeats): the ids
//               below v go into the hash set in one pass; dropped when
//               fewer than F of them are distinct. At F3's shape some
//               candidate of nearly every batch takes it, so the
//               two-hop path tries each id at its home slot all at once
//               and only ids that meet another probe on.
//
// tests/_spanner_gate_cases.py builds a state for each path;
// tests/test_torch_spanner.py holds a numpy model of this decomposition
// to gelly_tpu on them.
//
// The whole chain runs in one launch, so the instructions its SMs run and
// how many random rows they hold in flight set the pace: a round reads a
// row's slots four at a time (D a multiple of 4), steps through (row,
// slot) pairs without dividing, keeps the next frontier with warp
// ballots, and fills the hash set (twice the raw ids in slots) in one
// pass.
//
// Entry 2 gates every candidate of a batch at once, a warp a candidate
// (candidates that shared a warp would diverge on their own paths and
// serialize), all against the adjacency as it stood at the batch's start,
// on a cluster of kClusterBlocks blocks (four SMs: 16 warps each at F3's
// batch of 64; one SM alone was bound by its instruction rate). The
// block that gates a candidate writes its ids, take and fill counts into
// every block's shared memory (distributed shared memory); a cluster barrier
// publishes them, each block appends its own candidates, and a second
// cluster barrier publishes the appends to the next batch. For k = 2 with
// D + 1 <= F and D a multiple of 4 up to 16 (F3's shape) a second kernel
// instance runs two_hops: round 1's ids stay in lane registers and round
// 2 reads their rows a quad a lane, with no shared memory but the hash
// set. Then each warp does _row_append_batch's two passes for its
// candidates with counts over the batch, summed across the warp with no
// sort and no serial loop: r1 and r2, the earlier takes of the same row
// in pass 1 (u -> v) and pass 2 (v -> u), which are jnp.argsort's stable
// ranks; p, the takes of the batch whose first endpoint is this
// candidate's v, so pass 2 starts at deg0[v] + clamp(p, 0, D - deg0[v]);
// and the earlier takes for the edge-list slot. Fill counts are read
// during the gate (the state at the batch's start), and the next batch's
// candidate ids while this one gates, so a batch waits on two dependent
// row reads (k = 2) and two cluster barriers.
//
// Entry 1 runs one block, the edges one after another (the reference's
// order); the whole block is the group. Lane tiles are read a tile ahead;
// fill counts during the gate.
//
// Ids of live lanes must lie in [0, n), as they do in every summary a
// stream builds (JAX's scatters would drop such a lane's row writes); a
// lane outside it is skipped here.
//
// Bound on an H100: neither bytes nor operations. Each step depends on
// the one before (the next edge's gate reads the rows the last edge wrote;
// the next batch's gates read the last batch's appends), so the time is
// that chain: per edge or batch, k dependent row reads and the group
// sums. Rows and fill counts are read with ld.global.cg (L2), never
// through L1 or the read-only cache: the same launch writes them.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kEdgeThreads = 256;  // entry 1: one block, one group
constexpr int kWarp = 32;          // entry 2: a warp a group
constexpr int kMaxGroups = 16;     // entry 2: the warps of one block
constexpr int kClusterBlocks = 4;  // entry 2: the blocks of its cluster
constexpr int kLoadBatch = 4;      // row reads a lane keeps in flight
constexpr int kSmemLimit = 227 * 1024;

// Raw ids round r (from 1) can hold: its frontier, at most F ids and at
// most (D + 1)^(r - 1), each with D row slots.
long long round_raw(int D, int F, int r) {
    long long live = 1;
    for (int i = 1; i < r && live < F; ++i) live *= D + 1;
    if (live > F) live = F;
    return live * (D + 1);
}

// Raw ids of the largest round: the last.
long long raw_span(int D, int F, int k) {
    return k <= 0 ? 1 : round_raw(D, F, k);
}

// Hash-set slots: twice a round's raw ids at least, so one pass inserts
// them all and most land at their home slot.
long long set_slots(int D, int F, int k) {
    const long long need = raw_span(D, F, k);
    long long slots = 64;
    while (slots < 2 * need) slots <<= 1;
    return slots;
}

long long round4(long long x) { return (x + 3) & ~3LL; }

// One group's shared ints, each part 16-byte aligned: raw ids, frontier,
// hash set, frontier count.
long long group_ints(int D, int F, int k) {
    return round4(raw_span(D, F, k)) + round4(F) + set_slots(D, F, k) + 4;
}

long long edge_ints(int D, int F, int k) {
    return 2 * kEdgeThreads + 64 + group_ints(D, F, k);
}

long long batch_ints(int B) { return round4(5LL * B); }

int clamp_bytes(long long ints) {
    const long long bytes = ints * static_cast<long long>(sizeof(int));
    return bytes > INT_MAX ? INT_MAX : static_cast<int>(bytes);
}

// The groups. A sum also orders the group's shared-memory writes before
// it ahead of every read after it.
//
// A warp gates one candidate (entry 2): one warp, not a slice of one, so
// no two candidates' paths diverge inside a warp.
struct WarpGroup {
    int lane;
    int size;
    __device__ __forceinline__ void sync() const { __syncwarp(); }
    __device__ __forceinline__ int sum(int x) const {
        __syncwarp();
        return __reduce_add_sync(0xffffffffu, x);
    }
};

// The whole block as one group (entry 1). A sum costs one barrier: each
// warp's total goes to one of two slot rows, used in turn, so a row is
// written again only after every lane passed the barrier that followed
// its last read.
struct BlockGroup {
    int* red;  // 2 x 32 ints
    int lane;
    int size;
    int flip;
    __device__ __forceinline__ void sync() const { __syncthreads(); }
    __device__ __forceinline__ int sum(int x) {
        x = __reduce_add_sync(0xffffffffu, x);
        int* row = red + 32 * flip;
        flip ^= 1;
        if ((lane & 31) == 0) row[lane >> 5] = x;
        __syncthreads();
        int t = 0;
        for (int w = 0; w < (size >> 5); ++w) t += row[w];
        return t;
    }
};

struct GateScratch {
    int* buf;    // a round's raw ids, -1 where none (16-byte aligned)
    int* front;  // the frontier, at most F ids
    int* table;  // hash set of ids, -1 free
    int* count;  // the next frontier's fill count
    int slots;
};

// The scratch at `base` (16-byte aligned), parts as group_ints lays out.
__device__ __forceinline__ GateScratch scratch_at(int* base, int P, int F,
                                                  int slots) {
    const int p4 = (P + 3) & ~3;
    const int f4 = (F + 3) & ~3;
    return GateScratch{base, base + p4, base + p4 + f4,
                       base + p4 + f4 + slots, slots};
}

// Appends x to dst (the group's lanes in step: every lane of a warp calls
// it together, `keep` its own), at a slot from *count; the order is the
// warps' and the lanes', which no caller depends on.
__device__ __forceinline__ void append_any(int* dst, int* count, bool keep,
                                           int x) {
    const unsigned bal = __ballot_sync(0xffffffffu, keep);
    if (bal == 0) return;
    const int wl = threadIdx.x & 31;
    const int leader = __ffs(bal) - 1;
    int base = 0;
    if (wl == leader) base = atomicAdd(count, __popc(bal));
    base = __shfl_sync(0xffffffffu, base, leader);
    if (keep) dst[base + __popc(bal & ((1u << wl) - 1))] = x;
}

__device__ __forceinline__ unsigned set_home(int x, int slots) {
    const unsigned h = static_cast<unsigned>(x) * 0x9E3779B1u;
    return (h ^ (h >> 16)) & static_cast<unsigned>(slots - 1);
}

// Adds x >= 0 to the set, probing from slot s: 1 when it was not there.
__device__ __forceinline__ int set_insert_at(int* table, int slots, int x,
                                             unsigned s) {
    for (;;) {
        s &= static_cast<unsigned>(slots - 1);
        const int o = atomicCAS(table + s, -1, x);
        if (o == -1) return 1;
        if (o == x) return 0;
        ++s;
    }
}

__device__ __forceinline__ int set_insert(int* table, int slots, int x) {
    return set_insert_at(table, slots, x, set_home(x, slots));
}

// Empties the set (slots a multiple of 4, the table 16-byte aligned).
template <class Grp>
__device__ __forceinline__ void set_clear(int* table, int slots,
                                          const Grp& g) {
    int4* t = reinterpret_cast<int4*>(table);
    for (int i = g.lane; i < slots / 4; i += g.size)
        t[i] = make_int4(-1, -1, -1, -1);
}

struct RoundCounts {
    int valid;  // raw ids in [0, n)
    int below;  // of them, below v
    int found;  // v among them
};

__device__ __forceinline__ int raw_id(int y, int n, int v, RoundCounts& c) {
    y = (y >= 0 && y < n) ? y : -1;
    c.valid += y >= 0;
    c.below += y >= 0 && y < v;
    c.found |= y == v;
    return y;
}

// Round's raw ids into buf[0, L (D + 1)): the frontier ids' rows first
// (slots outside [0, n) as -1), then the frontier. With D a multiple of 4
// a lane reads a row's slots four at a time; lanes step through (row,
// slot) pairs without dividing, kLoadBatch reads in flight. The counts
// are the lane's own.
template <class Grp>
__device__ RoundCounts fill_round(const int32_t* nbr, int n, int D,
                                  const int* front, int L, int v, int* buf,
                                  const Grp& g) {
    RoundCounts c{0, 0, 0};
    const int w = (D & 3) == 0 ? 4 : 1;  // slots a read
    const int per_row = D / w;
    const int reads = L * per_row;
    int r = g.lane / per_row;
    int col = g.lane % per_row;
    const int dr = g.size / per_row;
    const int dc = g.size % per_row;
    for (int j0 = g.lane; j0 < reads; j0 += g.size * kLoadBatch) {
        int4 x[kLoadBatch];
#pragma unroll
        for (int q = 0; q < kLoadBatch; ++q) {
            x[q] = make_int4(-1, -1, -1, -1);
            if (j0 + q * g.size < reads) {
                const int32_t* row =
                    nbr + static_cast<long long>(front[r]) * D;
                if (w == 4) {
                    x[q] = __ldcg(reinterpret_cast<const int4*>(row) + col);
                } else {
                    x[q].x = __ldcg(row + col);
                }
            }
            col += dc;
            r += dr;
            if (col >= per_row) {
                col -= per_row;
                ++r;
            }
        }
#pragma unroll
        for (int q = 0; q < kLoadBatch; ++q) {
            const int j = j0 + q * g.size;
            if (j >= reads) continue;
            if (w == 4) {
                int4 y;
                y.x = raw_id(x[q].x, n, v, c);
                y.y = raw_id(x[q].y, n, v, c);
                y.z = raw_id(x[q].z, n, v, c);
                y.w = raw_id(x[q].w, n, v, c);
                reinterpret_cast<int4*>(buf)[j] = y;
            } else {
                buf[j] = raw_id(x[q].x, n, v, c);
            }
        }
    }
    const int slots = L * D;
    for (int i = g.lane; i < L; i += g.size)
        buf[slots + i] = raw_id(front[i], n, v, c);
    return c;
}

// The F-th smallest of the distinct ids in buf[0, M) (more than F of
// them, all below 2^nbits), a bit at a time from the top.
template <class Grp>
__device__ int select_threshold(const int* buf, int M, int F, int nbits,
                                Grp& g) {
    int prefix = 0;
    int remaining = F;
    for (int b = nbits - 1; b >= 0; --b) {
        int zeros = 0;
        for (int i = g.lane; i < M; i += g.size) {
            const int x = buf[i];
            zeros += x >= 0 && (x >> (b + 1)) == (prefix >> (b + 1)) &&
                     ((x >> b) & 1) == 0;
        }
        zeros = g.sum(zeros);
        if (zeros < remaining) {
            remaining -= zeros;
            prefix |= 1 << b;
        }
    }
    return prefix;
}

// Distinct ids below v in buf[0, M), in one pass.
template <class Grp>
__device__ int distinct_below(const GateScratch& s, int M, int v, Grp& g) {
    set_clear(s.table, s.slots, g);
    g.sync();
    int fresh = 0;
    for (int i = g.lane; i < M; i += g.size) {
        const int x = s.buf[i];
        if (x >= 0 && x < v) fresh += set_insert(s.table, s.slots, x);
    }
    return g.sum(fresh);
}

// dist(u, v) <= k over the capped-degree rows with an F-id frontier
// (_within_k_sparse), u != v both in [0, n), by one group; every lane
// returns the same answer. The group's lanes must have finished with s.
template <class Grp>
__device__ bool within_k(const int32_t* nbr, int n, int nbits, int D, int F,
                         int k, int u, int v, const GateScratch& s, Grp& g) {
    if (k <= 0) return false;
    if (g.lane == 0) s.front[0] = u;
    g.sync();
    int L = 1;
    for (int r = 1;; ++r) {
        const int M = L * (D + 1);
        const bool last = r == k;
        if (!last && M > F) set_clear(s.table, s.slots, g);
        if (g.lane == 0) *s.count = 0;
        const RoundCounts c = fill_round(nbr, n, D, s.front, L, v, s.buf, g);
        if (last) {
            const int t = g.sum(c.below + (c.found << 16));
            if ((t >> 16) == 0) return false;  // last-miss
            if ((t & 0xffff) < F) return true;  // last-raw
            return distinct_below(s, M, v, g) < F;  // last-dedup
        }
        const int valid = g.sum(c.valid);  // orders buf and the clears
        int keep = INT_MAX;
        if (valid > F) {  // dedup
            int reps = 0;
            for (int i = g.lane; i < M; i += g.size) {
                const int x = s.buf[i];
                if (x < 0) continue;
                if (set_insert(s.table, s.slots, x)) {
                    ++reps;
                } else {
                    s.buf[i] = -1;
                }
            }
            const int distinct = g.sum(reps);
            if (distinct > F) keep = select_threshold(s.buf, M, F, nbits, g);
            L = min(distinct, F);
        } else {  // keep
            L = valid;
        }
        for (int i0 = 0; i0 < M; i0 += g.size) {
            const int i = i0 + g.lane;
            const int x = i < M ? s.buf[i] : -1;
            append_any(s.front, s.count, x >= 0 && x <= keep, x);
        }
        g.sync();
    }
}

// Widest rows the two-hop path reads.
constexpr int kTwoHopMaxD = 16;
// Reads a lane makes there: (D + 1) rows of D / 4 quads over 32 lanes.
constexpr int kTwoHopReads =
    ((kTwoHopMaxD + 1) * (kTwoHopMaxD / 4) + kWarp - 1) / kWarp;

__device__ __forceinline__ void count_id(int y, int n, int v, int& below,
                                         int& found) {
    if (y >= 0 && y < n) {
        below += y < v;
        found |= y == v;
    }
}

// within_k for k = 2, D + 1 <= F, D a multiple of 4 up to kTwoHopMaxD, a
// warp a candidate, in registers (the hash set of the last-dedup path is
// the only shared memory). Round 1 holds at most D + 1 <= F raw ids, so
// it keeps them all: lane l < D holds row u's slot l, lane D holds u.
// Round 2, the last, reads those ids' rows a quad a lane (four lanes a
// row, so a warp's read covers 8 whole rows) and counts.
__device__ bool two_hops(const int32_t* nbr, int n, int D, int F, int u,
                         int v, const GateScratch& s, const WarpGroup& g) {
    const int l = g.lane;
    int id = -1;
    if (l < D) {
        const int y = __ldcg(nbr + static_cast<long long>(u) * D + l);
        id = (y >= 0 && y < n) ? y : -1;
    } else if (l == D) {
        id = u;
    }
    const int quads = D >> 2;
    const int reads = (D + 1) * quads;
    int4 x[kTwoHopReads];
#pragma unroll
    for (int t = 0; t < kTwoHopReads; ++t) {
        const int j = l + kWarp * t;
        const int r = j / quads;
        const int rid = __shfl_sync(0xffffffffu, id, r & (kWarp - 1));
        x[t] = make_int4(-1, -1, -1, -1);
        if (j < reads && rid >= 0)
            x[t] = __ldcg(reinterpret_cast<const int4*>(
                              nbr + static_cast<long long>(rid) * D) +
                          (j - r * quads));
    }
    int below = 0, found = 0;
    count_id(id, n, v, below, found);
#pragma unroll
    for (int t = 0; t < kTwoHopReads; ++t) {
        count_id(x[t].x, n, v, below, found);
        count_id(x[t].y, n, v, below, found);
        count_id(x[t].z, n, v, below, found);
        count_id(x[t].w, n, v, below, found);
    }
    const int sum = g.sum(below + (found << 16));
    if ((sum >> 16) == 0) return false;  // last-miss
    if ((sum & 0xffff) < F) return true;  // last-raw
    // last-dedup: the ids below v into the set, every one first tried at
    // its home slot at once; only those that meet another id probe on.
    set_clear(s.table, s.slots, g);
    g.sync();
    constexpr int kIds = 1 + 4 * kTwoHopReads;
    int ids[kIds];
    ids[0] = id;
#pragma unroll
    for (int t = 0; t < kTwoHopReads; ++t) {
        ids[1 + 4 * t] = x[t].x;
        ids[2 + 4 * t] = x[t].y;
        ids[3 + 4 * t] = x[t].z;
        ids[4 + 4 * t] = x[t].w;
    }
    int got[kIds];
#pragma unroll
    for (int q = 0; q < kIds; ++q) {
        const int y = ids[q];
        got[q] = (y >= 0 && y < v)
                     ? atomicCAS(s.table + set_home(y, s.slots), -1, y)
                     : y;
    }
    int fresh = 0;
#pragma unroll
    for (int q = 0; q < kIds; ++q) {
        const int y = ids[q];
        if (y < 0 || y >= v) continue;
        if (got[q] == -1) {
            ++fresh;
        } else if (got[q] != y) {
            fresh += set_insert_at(s.table, s.slots, y,
                                   set_home(y, s.slots) + 1);
        }
    }
    return g.sum(fresh) < F;
}

__device__ __forceinline__ bool live_lane(int u, int v, int n) {
    return u != v && u >= 0 && u < n && v >= 0 && v < n;
}

__device__ __forceinline__ int id_bits(int n) {
    return n > 1 ? 32 - __clz(n - 1) : 0;
}

__global__ void __launch_bounds__(kEdgeThreads)
sparse_insert_edges_kernel(int32_t* nbr, int32_t* deg, int32_t* dover,
                           int32_t* esrc, int32_t* edst, int32_t* n_acc,
                           uint8_t* overflow, const int32_t* src,
                           const int32_t* dst, const uint8_t* valid,
                           long long n_lanes, int n, long long cap, int k,
                           int D, int F, int P, int slots) {
    extern __shared__ int4 smem4[];
    int* smem = reinterpret_cast<int*>(smem4);
    const int tid = threadIdx.x;
    int* lu = smem;  // a tile of lanes, -1 where dead
    int* lv = lu + kEdgeThreads;
    int* red = lv + kEdgeThreads;
    const GateScratch s = scratch_at(red + 64, P, F, slots);
    BlockGroup g{red, tid, kEdgeThreads, 0};
    const int nbits = id_bits(n);
    int acc = *n_acc;
    int dropped = 0;    // tid 0's row inserts past D
    bool over = false;  // tid 0's list overflow
    // This thread's lane of the next tile, read a tile ahead.
    int pa = 0, pb = 0, pok = 0;
    if (tid < n_lanes) {
        pa = src[tid];
        pb = dst[tid];
        pok = valid[tid];
    }
    for (long long base = 0; base < n_lanes; base += kEdgeThreads) {
        __syncthreads();  // the last tile's lanes are read
        const bool live = pok && live_lane(pa, pb, n);
        lu[tid] = live ? pa : -1;
        lv[tid] = pb;
        const long long nx = base + kEdgeThreads + tid;
        if (nx < n_lanes) {
            pa = src[nx];
            pb = dst[nx];
            pok = valid[nx];
        }
        __syncthreads();
        const int tile = static_cast<int>(
            min(static_cast<long long>(kEdgeThreads), n_lanes - base));
        for (int e = 0; e < tile; ++e) {
            const int u = lu[e];
            const int v = lv[e];
            if (u < 0) continue;
            int du = 0, dv = 0;
            if (tid == 0) {
                du = __ldcg(deg + u);
                dv = __ldcg(deg + v);
            }
            if (!within_k(nbr, n, nbits, D, F, k, u, v, s, g)) {
                if (tid == 0) {
                    // row_insert(dedupe=False) both ways.
                    if (du < D) {
                        nbr[static_cast<long long>(u) * D + du] = v;
                        deg[u] = du + 1;
                    } else {
                        ++dropped;
                    }
                    if (dv < D) {
                        nbr[static_cast<long long>(v) * D + dv] = u;
                        deg[v] = dv + 1;
                    } else {
                        ++dropped;
                    }
                    if (acc < cap) {
                        esrc[acc] = u;
                        edst[acc] = v;
                    } else {
                        over = true;
                    }
                }
                ++acc;
            }
            __syncthreads();  // the next gate reads what this edge wrote
        }
    }
    if (tid == 0) {
        *n_acc = acc;
        *dover += dropped;
        if (over) *overflow = 1;
    }
}

template <bool kTwoHop>
__global__ void __cluster_dims__(kClusterBlocks, 1, 1)
__launch_bounds__(kWarp * kMaxGroups)
sparse_insert_edges_batched_kernel(
        int32_t* nbr, int32_t* deg, int32_t* dover, int32_t* esrc,
        int32_t* edst, int32_t* n_acc, uint8_t* overflow,
        const int32_t* csrc, const int32_t* cdst, const int32_t* n_valid,
        long long ccap, int n, long long cap, int k, int D, int F, int P,
        int slots, int B, int gints) {
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    extern __shared__ int4 smem4[];
    int* smem = reinterpret_cast<int*>(smem4);
    const int tid = threadIdx.x;
    const int groups = blockDim.x / kWarp;
    const int gi = tid / kWarp;
    // The whole batch, in every block: ids, take, fill counts at the
    // batch's start, each written by the block that gates the candidate.
    int* cu = smem;
    int* cv = cu + B;
    int* take = cv + B;
    int* du = take + B;
    int* dv = du + B;
    const GateScratch s =
        scratch_at(smem + ((5 * B + 3) & ~3) + gi * gints, P, F, slots);
    WarpGroup g{tid & (kWarp - 1), kWarp};
    const unsigned mask = 0xffffffffu;
    const int nbits = id_bits(n);
    // n_valid counts accepted edges, stored or not: clamp to the list.
    const long long nv = min(static_cast<long long>(*n_valid), ccap);
    int acc = *n_acc;
    int dropped = 0;    // lane 0's row inserts past D
    bool over = false;  // lane 0's list overflow
    // Block `rank` gates candidates c = rank + kClusterBlocks m; warp gi
    // takes m = gi, gi + groups, ..., and its lane i holds the ids of its
    // i-th, read a batch ahead.
    const int owned = (B - rank + kClusterBlocks - 1) / kClusterBlocks;
    const int per = (owned + groups - 1) / groups;
    const int held = rank + kClusterBlocks * (gi + g.lane * groups);
    const bool holds = g.lane < per && gi + g.lane * groups < owned;
    int nu = 0, nw = 0;
    if (holds && held < nv) {
        nu = csrc[held];
        nw = cdst[held];
    }
    cluster.sync();
    for (long long start = 0; start < nv; start += B) {
        const int hu = nu, hv = nw;
        const long long nx = start + B + held;
        if (holds && nx < nv) {
            nu = csrc[nx];
            nw = cdst[nx];
        }
        // Gate, against the adjacency as it stood at the batch's start.
        for (int i = 0; i < per; ++i) {
            const int m = gi + i * groups;
            if (m >= owned) break;
            const int c = rank + kClusterBlocks * m;
            const bool ok = start + c < nv;
            int u, v;
            if (i < kWarp) {
                u = __shfl_sync(mask, hu, i);
                v = __shfl_sync(mask, hv, i);
            } else {
                u = ok ? csrc[start + c] : 0;
                v = ok ? cdst[start + c] : 0;
            }
            const bool live = ok && live_lane(u, v, n);
            int d_u = 0, d_v = 0;
            if (live && g.lane == 0) {
                d_u = __ldcg(deg + u);
                d_v = __ldcg(deg + v);
            }
            bool reach = true;
            if (live) {
                reach = kTwoHop
                            ? two_hops(nbr, n, D, F, u, v, s, g)
                            : within_k(nbr, n, nbits, D, F, k, u, v, s, g);
            }
            d_u = __shfl_sync(mask, d_u, 0);
            d_v = __shfl_sync(mask, d_v, 0);
            if (g.lane < kClusterBlocks) {  // lane q writes block q's copy
                int* to = cluster.map_shared_rank(smem, g.lane);
                to[c] = u;
                to[B + c] = v;
                to[2 * B + c] = !reach;
                to[3 * B + c] = d_u;
                to[4 * B + c] = d_v;
            }
        }
        cluster.sync();
        // _row_append_batch, u -> v then v -> u, and the edge list.
        int all = 0;
        for (int d = g.lane; d < B; d += kWarp) all += take[d];
        const int total = g.sum(all);
        for (int i = 0; i < per; ++i) {
            const int m = gi + i * groups;
            if (m >= owned) break;
            const int c = rank + kClusterBlocks * m;
            const int a = cu[c];
            const int b = cv[c];
            int ranks = 0;  // r1 | r2 << 16
            int ends = 0;   // p | earlier takes << 16
            for (int d = g.lane; d < B; d += kWarp) {
                const int t = take[d];
                const int e = t & (d < c);
                const int x = cu[d];
                const int y = cv[d];
                ends += (t & (x == b)) + (e << 16);
                ranks += (e & (x == a)) + ((e & (y == b)) << 16);
            }
            ranks = g.sum(ranks);
            ends = g.sum(ends);
            if (take[c] && g.lane == 0) {
                const int slot1 = du[c] + (ranks & 0xffff);
                if (slot1 < D) {
                    nbr[static_cast<long long>(a) * D + slot1] = b;
                    atomicAdd(deg + a, 1);
                } else {
                    ++dropped;
                }
                const int p = ends & 0xffff;
                const int d1 = dv[c] + max(0, min(p, D - dv[c]));
                const int slot2 = d1 + (ranks >> 16);
                if (slot2 < D) {
                    nbr[static_cast<long long>(b) * D + slot2] = a;
                    atomicAdd(deg + b, 1);
                } else {
                    ++dropped;
                }
                const long long pos =
                    static_cast<long long>(acc) + (ends >> 16);
                if (pos < cap) {
                    esrc[pos] = a;
                    edst[pos] = b;
                } else {
                    over = true;
                }
            }
        }
        acc += total;
        // The next batch's gates read these appends, and its writes to the
        // batch arrays wait until every block has read them.
        cluster.sync();
    }
    if (dropped) atomicAdd(dover, dropped);
    if (over) *overflow = 1;
    if (rank == 0 && tid == 0) *n_acc = acc;
}

}  // namespace

// Shared memory one launch of entry 1 needs (B <= 0), or of entry 2 with
// `groups` warps, in bytes (the wrapper refuses shapes that exceed the
// card's).
extern "C" int spanner_gate_smem_bytes(int D, int F, int k, int B,
                                       int groups) {
    if (B <= 0) return clamp_bytes(edge_ints(D, F, k));
    return clamp_bytes(batch_ints(B) + groups * group_ints(D, F, k));
}

// Warps of each block of one entry-2 launch: one a candidate, as many as
// a block and the card's shared memory hold (0 when not one fits).
extern "C" int spanner_gate_groups(int D, int F, int k, int B) {
    if (D <= 0 || F <= 0 || B <= 0) return 0;
    const int owned = (B + kClusterBlocks - 1) / kClusterBlocks;
    int groups = owned < kMaxGroups ? owned : kMaxGroups;
    while (groups > 0 && spanner_gate_smem_bytes(D, F, k, B, groups) >
                             kSmemLimit)
        --groups;
    return groups;
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
    const int bytes = spanner_gate_smem_bytes(D, F, k, 0, 0);
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
        n_lanes, n, cap, k, D, F, static_cast<int>(raw_span(D, F, k)),
        static_cast<int>(set_slots(D, F, k)));
    return static_cast<int>(cudaGetLastError());
}

extern "C" int spanner_sparse_insert_edges_batched(
        void* nbr, void* deg, void* dover, void* esrc, void* edst,
        void* n_acc, void* overflow, const void* csrc, const void* cdst,
        const void* n_valid, long long ccap, int n, long long cap, int k,
        int D, int F, int B, int groups, void* stream) {
    if (ccap <= 0) return 0;
    if (n <= 0 || D <= 0 || F <= 0 || k < 0 || cap <= 0 || B <= 0 ||
        groups < 1 || groups > kMaxGroups)
        return static_cast<int>(cudaErrorInvalidValue);
    const int bytes = spanner_gate_smem_bytes(D, F, k, B, groups);
    if (bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
    const bool two_hop = k == 2 && D + 1 <= F && (D & 3) == 0 &&
                         D <= kTwoHopMaxD;
    auto kernel = two_hop ? sparse_insert_edges_batched_kernel<true>
                          : sparse_insert_edges_batched_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<kClusterBlocks, groups * kWarp, bytes,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(nbr), static_cast<int32_t*>(deg),
        static_cast<int32_t*>(dover), static_cast<int32_t*>(esrc),
        static_cast<int32_t*>(edst), static_cast<int32_t*>(n_acc),
        static_cast<uint8_t*>(overflow), static_cast<const int32_t*>(csrc),
        static_cast<const int32_t*>(cdst),
        static_cast<const int32_t*>(n_valid), ccap, n, cap, k, D, F,
        static_cast<int>(raw_span(D, F, k)),
        static_cast<int>(set_slots(D, F, k)), B,
        static_cast<int>(group_ints(D, F, k)));
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spanner_gate_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
