// unionfind_fixpoint — the union-find fixpoints of the CC folds, every
// round on the card.
//
// Replaces the device loops of gelly_tpu/ops/unionfind.py (no Pallas
// kernel: each is a lax.while_loop the TPU runs without the host):
//
//   1. rooted_fixpoint: _chase_roots (:143) inside _rooted_fixpoint
//      (:158), in its two forms: the pair form of union_pairs_rooted
//      (:190, rv = the chase of the second endpoint) and the star form
//      of union_pairs_star (:227, rv = ru[ri]);
//   2. pointer_jump (:40);
//   3. union_edges (:52-89), the Shiloach-Vishkin loop;
//
// and those of gelly_tpu/ops/parity_unionfind.py, the bipartiteness
// summary's parity union-find:
//
//   4. union_edges_parity (:57-105), the same loop on the packed word
//      parent * 2 + rel;
//   5. pointer_jump_parity (:43-54).
//
// Each keeps the reference's round schedule, so its forest equals
// gelly_tpu's bit for bit:
//
//   * rooted_fixpoint, one cooperative launch. A round: phase A walks
//     every active lane's endpoints (star form: every lane's, into
//     scratch, then a grid barrier and ru[ri]) to their true roots while
//     nothing writes the forest, and leaves each lane's hook (hi, lo) or
//     none in scratch and a live flag; a grid barrier; if no lane was
//     live the loop ends (the reference's last round hooks nothing);
//     phase B applies the hooks with atomicMin(&p[hi], lo); a grid
//     barrier. Reads come before writes in every round and a min does
//     not depend on order, so the forest is the reference's. The gate
//     (live0) and the count of valid lanes are device values the kernel
//     reads, so no caller reads them on the host; a closed gate runs no
//     round.
//   * pointer_jump, one plain launch: the loop's fixpoint is each slot's
//     root, however many doubling rounds it takes, so a thread a slot
//     walks to its root and writes it to a new tensor.
//   * union_edges, one cooperative launch, exactly the reference's rounds:
//     each edge reads p[src] and p[dst] from the forest as it stood at
//     the round's start and scatter-mins hi -> lo into a second buffer
//     (equal to the forest at the round's start); a grid barrier; one
//     doubling step p2[p2] from that buffer into the forest and into a
//     third buffer (the next round's scatter target), with a flag where
//     an entry moved, i.e. any(p2 != p); a grid barrier. The wrapper
//     then runs pointer_jump, as the reference does.
//   * union_edges_parity, one cooperative launch, exactly the reference's
//     rounds on the packed word w = parent * 2 + rel, with union_edges'
//     kernel (sv_kernel, over a word policy: ParentWord or ParityWord
//     gives the hook and the doubling step) and its three buffers: each valid lane reads w[u] and w[v] from the forest
//     at the round's start, sets the sticky odd-cycle word where the two
//     parents are one and the edge-implied parity rel[u] ^ rel[v] ^ q is
//     1, and otherwise scatter-mins lo * 2 + parity into slot hi of the
//     second buffer (on one (hi, lo) pair the lower parity wins now, the
//     other surfaces as a same-parent conflict a round later, whatever
//     the atomics' order); a grid barrier; one parity-carrying doubling
//     step w3 = (s[p2] >> 1) * 2 + ((s[i] ^ s[p2]) & 1), p2 = s[i] >> 1,
//     into the forest and the third buffer, with a flag where a word
//     moved (the reference's any((p3 != p) | (r3 != r))); a grid
//     barrier. The last round, which moves nothing, still checks every
//     edge. The wrapper then runs pointer_jump_parity, as the reference
//     does.
//   * pointer_jump_parity, two plain launches, the first pointer_jump's
//     kernel carrying rel along the walk. The reference doubles
//     p, r <- p[p], r ^ r[p] while some slot is at depth 2 or more. Its
//     result: with no slot that deep, the input as it was; otherwise each
//     slot's root, and as rel the XOR of rel along the slot's path
//     without the root's, XORed with the root's rel where the depth is
//     odd (a root gets 0). The first launch walks a thread a slot to its
//     root and writes that, and the longest walk; the second reads the
//     longest walk on the card and, where it is under 2 hops, puts the
//     input rel back (the parents are then the input's already).
//
// Every launch writes the rounds it met (pointer_jump and
// pointer_jump_parity: the longest walk in hops) to a 1-int device
// tensor; reading it syncs, so the wrappers never do.
//
// Coherence: L1 is not coherent between SMs, so every read of the forest
// or of a scratch array another block wrote goes past L1 (__ldcg); the
// grid barrier (grid_barrier.cuh: a release add, an acquire spin) makes
// a round's writes visible to the next phase. Two live flags alternate
// from round to round, so a flag is cleared (by block 0, after the
// round's first barrier) while no thread reads it, with no barrier of its
// own. The grid is the card's co-resident blocks (occupancy a SM times
// the SMs), fewer for a small input, with grid-stride loops over lanes
// and slots. A walk longer than the slot count (a cycle, which the
// reference's invariants p[i] <= i rule out) stops, and the fixpoints
// then end with -1 rounds met instead of hanging the card.
//
// Bound on an H100: memory, and under it the latency of dependent loads.
// A round must read each lane's pair once, each hop of each chase once
// and write each hook once; the chases are chains of dependent L2/HBM
// round trips, and each round adds one or two grid barriers. The two
// Shiloach-Vishkin loops also read and write every slot's word a round.
// Zipf hubs put many atomicMins on one slot (a warp-aggregated min is
// later work).

#include <algorithm>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_barrier.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHead = 32;  // ints: barrier counter, two live flags, error
constexpr int kJumpWaves = 16;  // pointer_jump: blocks a SM, at most

__device__ __forceinline__ int chase(const int32_t* p, int x, int n,
                                     int& bad) {
    int g = __ldcg(p + x);
    int hops = 0;
    while (g != x) {
        x = g;
        g = __ldcg(p + x);
        if (++hops > n) {
            bad = 1;
            break;
        }
    }
    return x;
}

struct Rooted {
    int32_t* p;             // the forest, updated in place
    const int32_t* x;       // first endpoint of each lane
    const int32_t* y;       // pair form: second endpoint; star form: ri
    const uint8_t* valid;   // or null: every lane valid
    const int32_t* n_valid; // or null: lanes at or past it are not valid
    const uint8_t* gate;    // or null: 0 runs no round
    long long* hook;        // each lane's (hi << 32 | lo), or -1
    int32_t* ru;            // star form: each lane's root
    unsigned* bar;
    int* flags;             // [0], [1] live flags; [2] a walk too long
    int32_t* met;
    long long lanes;
    int n;
    int star;
};

__global__ void __launch_bounds__(kThreads)
rooted_fixpoint_kernel(Rooted q) {
    if (q.gate != nullptr && __ldg(q.gate) == 0) {
        if (blockIdx.x == 0 && threadIdx.x == 0) q.met[0] = 0;
        return;
    }
    long long active = q.lanes;
    if (q.n_valid != nullptr) {
        const long long cap = __ldg(q.n_valid);
        if (cap < active) active = cap < 0 ? 0 : cap;
    }
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    const long long first =
        static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    unsigned target = 0;
    int rounds = 0;
    for (;;) {
        int bad = 0;
        int live = 0;
        // Phase A: walks only; nothing writes the forest.
        if (q.star) {
            for (long long i = first; i < q.lanes; i += stride)
                q.ru[i] = chase(q.p, __ldg(q.x + i), q.n, bad);
            grid_barrier(q.bar, target);
        }
        for (long long i = first; i < q.lanes; i += stride) {
            long long w = -1;
            if (i < active && (q.valid == nullptr || __ldg(q.valid + i))) {
                int ru;
                int rv;
                if (q.star) {
                    ru = __ldcg(q.ru + i);
                    rv = __ldcg(q.ru + __ldg(q.y + i));
                } else {
                    ru = chase(q.p, __ldg(q.x + i), q.n, bad);
                    rv = chase(q.p, __ldg(q.y + i), q.n, bad);
                }
                if (ru != rv) {
                    w = (static_cast<long long>(max(ru, rv)) << 32) |
                        static_cast<unsigned>(min(ru, rv));
                    live = 1;
                }
            }
            q.hook[i] = w;
        }
        live = __syncthreads_or(live);
        bad = __syncthreads_or(bad);
        if (threadIdx.x == 0) {
            if (live) q.flags[rounds & 1] = 1;
            if (bad) q.flags[2] = 1;
        }
        grid_barrier(q.bar, target);
        ++rounds;
        if (__ldcg(q.flags + 2)) {
            rounds = -1;
            break;
        }
        if (!__ldcg(q.flags + ((rounds - 1) & 1))) break;
        // Every thread has read last round's flag: clear it for the next.
        if (blockIdx.x == 0 && threadIdx.x == 0) q.flags[rounds & 1] = 0;
        // Phase B: the hooks, each at a true root of the round's start.
        for (long long i = first; i < q.lanes; i += stride) {
            const long long w = q.hook[i];
            if (w >= 0)
                atomicMin(q.p + static_cast<int>(w >> 32),
                          static_cast<int>(w & 0xffffffffLL));
        }
        grid_barrier(q.bar, target);
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) q.met[0] = rounds;
}

// The word of a Shiloach-Vishkin loop: ParentWord, the parent itself
// (union_edges); ParityWord, parent * 2 + rel (union_edges_parity), whose
// hook also finds an odd cycle. hook() is a valid lane's phase A on the
// words wu and wv read at the round's start, a scatter-min into b;
// step() one doubling step of the word sw that b holds for a slot.
struct ParentWord {
    static constexpr bool kParity = false;
    __device__ static void hook(int32_t* b, int wu, int wv, int, int&) {
        if (wu != wv) atomicMin(b + max(wu, wv), min(wu, wv));
    }
    __device__ static int step(const int32_t* b, int sw) {
        return __ldcg(b + sw);
    }
};

struct ParityWord {
    static constexpr bool kParity = true;
    __device__ static void hook(int32_t* b, int wu, int wv, int q,
                                int& odd) {
        const int lu = wu >> 1;
        const int lv = wv >> 1;
        const int link = (wu & 1) ^ (wv & 1) ^ q;
        if (lu == lv) {
            if (link == 1) odd = 1;
        } else {
            atomicMin(b + max(lu, lv), min(lu, lv) * 2 + link);
        }
    }
    __device__ static int step(const int32_t* b, int sw) {
        const int sp = __ldcg(b + (sw >> 1));
        return (sp >> 1) * 2 + ((sw ^ sp) & 1);
    }
};

struct Sv {
    int32_t* w;  // the words at each round's start, and the result
    int32_t* s;  // scatter targets, in turn; s starts equal to w
    int32_t* t;
    const int32_t* u;
    const int32_t* v;
    const int32_t* q;      // ParityWord: each lane's required parity
    const uint8_t* valid;  // or null: every lane valid
    unsigned* bar;
    int* flags;            // [0], [1] moved flags
    int32_t* odd;          // ParityWord: an odd cycle was seen (sticky)
    int32_t* met;
    long long lanes;
    int n;
};

template <class Word>
__global__ void __launch_bounds__(kThreads)
sv_kernel(Sv k) {
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    const long long first =
        static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    unsigned target = 0;
    int rounds = 0;
    int odd = 0;
    for (;;) {
        int32_t* b = (rounds & 1) ? k.t : k.s;
        int32_t* c = (rounds & 1) ? k.s : k.t;
        // The hooks: reads of w, a scatter-min into b (== w here).
        for (long long e = first; e < k.lanes; e += stride) {
            if (k.valid != nullptr && !__ldg(k.valid + e)) continue;
            Word::hook(b, __ldcg(k.w + __ldg(k.u + e)),
                       __ldcg(k.w + __ldg(k.v + e)),
                       Word::kParity ? __ldg(k.q + e) : 0, odd);
        }
        grid_barrier(k.bar, target);
        if (blockIdx.x == 0 && threadIdx.x == 0)
            k.flags[(rounds + 1) & 1] = 0;
        // One doubling step from b into w and c.
        int moved = 0;
        for (long long i = first; i < k.n; i += stride) {
            const int nw = Word::step(b, __ldcg(b + i));
            if (nw != __ldcg(k.w + i)) moved = 1;
            k.w[i] = nw;
            c[i] = nw;
        }
        moved = __syncthreads_or(moved);
        if (threadIdx.x == 0 && moved) k.flags[rounds & 1] = 1;
        grid_barrier(k.bar, target);
        ++rounds;
        if (!__ldcg(k.flags + ((rounds - 1) & 1))) break;
    }
    if constexpr (Word::kParity) {
        odd = __syncthreads_or(odd);
        if (threadIdx.x == 0 && odd) k.odd[0] = 1;
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) k.met[0] = rounds;
}

// A thread a slot walks to its root and writes it to out_p. kRel
// (pointer_jump_parity): out_r takes the XOR of rel along the path
// without the root's, that XORed with the root's rel at an odd depth.
// head[0] takes the longest walk in hops; kRel: head[1] a walk past the
// slot count.
template <bool kRel>
__global__ void __launch_bounds__(kThreads)
pointer_jump_kernel(const int32_t* __restrict__ p,
                    const int32_t* __restrict__ r,
                    int32_t* __restrict__ out_p,
                    int32_t* __restrict__ out_r, int n, int* head) {
    __shared__ int sh[kWarps];
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    int most = 0;
    int bad = 0;
    for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
         i < n; i += stride) {
        int x = static_cast<int>(i);
        int g = __ldg(p + x);
        int acc = 0;
        int hops = 0;
        while (g != x) {
            if constexpr (kRel) acc ^= __ldg(r + x);
            x = g;
            g = __ldg(p + x);
            if (++hops > n) {
                bad = 1;
                break;
            }
        }
        out_p[i] = x;
        if constexpr (kRel)
            out_r[i] = acc ^ ((hops & 1) ? __ldg(r + x) : 0);
        most = max(most, hops);
    }
    most = __reduce_max_sync(0xffffffffu, most);
    if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = most;
    bad = __syncthreads_or(bad);
    if (threadIdx.x == 0) {
        for (int w = 1; w < kWarps; ++w) most = max(most, sh[w]);
        if (most > 0) atomicMax(head, most);
        if (kRel && bad) head[1] = 1;
    }
}

// With no walk of 2 hops or more the reference runs no round: the input
// rel back. Writes the longest walk, or -1 for a walk past the slot
// count, to met.
__global__ void __launch_bounds__(kThreads)
pointer_jump_parity_finish_kernel(const int32_t* __restrict__ r,
                                  int32_t* __restrict__ out_r, int n,
                                  const int* head, int32_t* met) {
    const int longest = head[0];
    if (blockIdx.x == 0 && threadIdx.x == 0)
        met[0] = head[1] ? -1 : longest;
    if (longest > 1) return;
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
         i < n; i += stride)
        out_r[i] = __ldg(r + i);
}

// Blocks of a cooperative launch over `work` items: the card's
// co-resident blocks, fewer when the work is smaller. A cudaError_t.
template <class Kernel>
int cooperative_grid(Kernel kernel, long long work, int& blocks) {
    int dev = 0;
    int sms = 0;
    int per_sm = 0;
    int coop = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                            kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!coop) return static_cast<int>(cudaErrorNotSupported);
    const long long room = static_cast<long long>(sms) * per_sm;
    if (room < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const long long want = (work + kThreads - 1) / kThreads;
    blocks = static_cast<int>(std::max(1LL, std::min(room, want)));
    return 0;
}

// One cooperative launch of sv_kernel<Word>; `scratch` is the head
// (unionfind_scratch_ints(0, -1)), `q` and `odd` null for ParentWord.
template <class Word>
int sv_launch(void* w, void* s, void* t, const void* u, const void* v,
              const void* q, const void* valid, void* scratch, void* odd,
              void* met, long long lanes, int n, void* stream) {
    if (n <= 0 || lanes < 0) return static_cast<int>(cudaErrorInvalidValue);
    void (*kernel)(Sv) = sv_kernel<Word>;
    int blocks = 0;
    int rc = cooperative_grid(kernel, std::max(lanes, 1LL * n), blocks);
    if (rc) return rc;
    int32_t* base = static_cast<int32_t*>(scratch);
    Sv k;
    k.w = static_cast<int32_t*>(w);
    k.s = static_cast<int32_t*>(s);
    k.t = static_cast<int32_t*>(t);
    k.u = static_cast<const int32_t*>(u);
    k.v = static_cast<const int32_t*>(v);
    k.q = static_cast<const int32_t*>(q);
    k.valid = static_cast<const uint8_t*>(valid);
    k.bar = reinterpret_cast<unsigned*>(base);
    k.flags = base + 1;
    k.odd = static_cast<int32_t*>(odd);
    k.met = static_cast<int32_t*>(met);
    k.lanes = lanes;
    k.n = n;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(base, 0, kHead * sizeof(int32_t), st);
    if (err == cudaSuccess && odd != nullptr)
        err = cudaMemsetAsync(odd, 0, sizeof(int32_t), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    void* args[] = {&k};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                      dim3(blocks), dim3(kThreads), args, 0,
                                      st);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

// Blocks of a pointer_jump launch over n slots: at most kJumpWaves a SM.
// A cudaError_t.
int jump_grid(int n, int& blocks) {
    int dev = 0;
    int sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long want = (static_cast<long long>(n) + kThreads - 1) /
                           kThreads;
    blocks = static_cast<int>(
        std::min(want, static_cast<long long>(kJumpWaves) * sms));
    return 0;
}

}  // namespace

// Scratch ints of a rooted_fixpoint launch over `lanes` lanes (star form:
// `star` != 0); union_edges and the parity entries take the head alone
// (star = -1).
extern "C" long long unionfind_scratch_ints(long long lanes, int star) {
    if (star < 0) return kHead;
    return kHead + 2 * lanes + (star ? lanes : 0);
}

extern "C" int unionfind_rooted_fixpoint_launch(
        void* p, const void* x, const void* y, const void* valid,
        const void* n_valid, const void* gate, void* scratch, void* met,
        long long lanes, int n, int star, void* stream) {
    if (n <= 0 || lanes < 0) return static_cast<int>(cudaErrorInvalidValue);
    Rooted q;
    int blocks = 0;
    int rc = cooperative_grid(rooted_fixpoint_kernel, lanes, blocks);
    if (rc) return rc;
    int32_t* base = static_cast<int32_t*>(scratch);
    q.p = static_cast<int32_t*>(p);
    q.x = static_cast<const int32_t*>(x);
    q.y = static_cast<const int32_t*>(y);
    q.valid = static_cast<const uint8_t*>(valid);
    q.n_valid = static_cast<const int32_t*>(n_valid);
    q.gate = static_cast<const uint8_t*>(gate);
    q.bar = reinterpret_cast<unsigned*>(base);
    q.flags = base + 1;
    q.hook = reinterpret_cast<long long*>(base + kHead);
    q.ru = base + kHead + 2 * lanes;
    q.met = static_cast<int32_t*>(met);
    q.lanes = lanes;
    q.n = n;
    q.star = star;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(base, 0, kHead * sizeof(int32_t), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    void* args[] = {&q};
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(rooted_fixpoint_kernel), dim3(blocks),
        dim3(kThreads), args, 0, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int unionfind_union_edges_launch(
        void* r, void* s, void* t, const void* src, const void* dst,
        const void* valid, void* scratch, void* met, long long lanes, int n,
        void* stream) {
    return sv_launch<ParentWord>(r, s, t, src, dst, nullptr, valid, scratch,
                                 nullptr, met, lanes, n, stream);
}

// `longest` (one int, cleared here) takes the longest walk in hops.
extern "C" int unionfind_pointer_jump_launch(const void* p, void* out,
                                             void* longest, int n,
                                             void* stream) {
    if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
    int blocks = 0;
    const int rc = jump_grid(n, blocks);
    if (rc) return rc;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(longest, 0, sizeof(int32_t), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    pointer_jump_kernel<false><<<blocks, kThreads, 0, st>>>(
        static_cast<const int32_t*>(p), nullptr, static_cast<int32_t*>(out),
        nullptr, n, static_cast<int*>(longest));
    return static_cast<int>(cudaGetLastError());
}

// `odd` (one int, cleared here) is set where an odd cycle was seen.
extern "C" int unionfind_union_edges_parity_launch(
        void* w, void* s, void* t, const void* u, const void* v,
        const void* q, const void* valid, void* scratch, void* odd,
        void* met, long long lanes, int n, void* stream) {
    return sv_launch<ParityWord>(w, s, t, u, v, q, valid, scratch, odd, met,
                                 lanes, n, stream);
}

// `scratch` is the head (unionfind_scratch_ints(0, -1)); `met` takes the
// longest walk in hops, or -1.
extern "C" int unionfind_pointer_jump_parity_launch(
        const void* p, const void* r, void* out_p, void* out_r,
        void* scratch, void* met, int n, void* stream) {
    if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
    int blocks = 0;
    const int rc = jump_grid(n, blocks);
    if (rc) return rc;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    int* head = static_cast<int*>(scratch);
    cudaError_t err = cudaMemsetAsync(head, 0, kHead * sizeof(int32_t), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int32_t* rr = static_cast<const int32_t*>(r);
    int32_t* orr = static_cast<int32_t*>(out_r);
    pointer_jump_kernel<true><<<blocks, kThreads, 0, st>>>(
        static_cast<const int32_t*>(p), rr, static_cast<int32_t*>(out_p),
        orr, n, head);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    pointer_jump_parity_finish_kernel<<<blocks, kThreads, 0, st>>>(
        rr, orr, n, head, static_cast<int32_t*>(met));
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* unionfind_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
