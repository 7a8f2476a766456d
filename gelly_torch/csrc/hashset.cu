// hashset — the device hash set of EdgeStream.distinct(device=True).
//
// Replaces gelly_tpu/ops/hashset.py's insert_chunk (a lax.scan of linear
// probe while_loops) and contains_chunk (a vmap of probe loops) over an
// open-addressing table of int64 keys, EMPTY = int64 min marking a free
// slot, capacity a power of two:
//
//   hash(key) = ((int64)((uint64)key * 0x9E3779B97F4A7C15) >> 32) & mask
//
// (the reference multiplies int64 by -7046029254386353131, which wraps;
// signed overflow is undefined in C++, so the product is taken in uint64
// and shifted as a signed value, which is the same bits).
//
// Entry 1, hashset_insert: the live keys inserted as the reference's scan
// inserts them in chunk order (is_new[i] set iff keys[i] was absent
// before position i; the slot layout and count bit for bit the scan's),
// but in parallel, by the deterministic linear probing of Shun and
// Blelloch ("Phase-Concurrent Hash Tables for Determinism", SPAA 2014).
// A key's priority is its place in the scan: keys already in the table
// first, then the chunk's keys by lane. With linear probing the layout in
// which every key's probe path, from its home slot to its slot, holds only
// keys of higher priority is unique, and it is the layout the scan builds
// (insert in priority order: each key stops at the first slot no earlier
// key holds). Each key walks from its home; at a free slot, or at a slot
// held by a chunk key of lower priority, it takes the slot, and the key
// it displaced walks on from the next slot. A key never passes its final
// slot (the key there would have to be of lower priority on a path of a
// higher one), so whatever the order the threads run in, the walks end in
// the scan's layout, and a walk that goes round the whole table means
// there is no such layout: the reference would find the table full.
//
// The walkers must be the chunk's distinct keys, each with the priority
// of its first lane: if two lanes with one key walked, the later one
// could settle beyond the point where the earlier one displaces a third
// key, and the displaced key could then push the later copy on past it,
// leaving the key twice in the table. So the insert is four launches:
//
//   1. dedup: each live lane inserts its lane number into a scratch table
//      of 2^k >= 2 n_keys slots keyed by keys[lane]; a slot keeps the
//      lowest lane of its key (compare-and-swap, lowest_lane.cuh). The sentinel key
//      (int64 min) is never stored: its live lanes are new and counted, as
//      in the reference, and the last of them is noted. Dead lanes are
//      not new;
//   2. walk: each first lane walks as above. The table stays as it was in
//      this launch; the walk's state is a side array owner[cap] of lane
//      numbers (-1 none), changed only by 32-bit compare-and-swap, so a
//      slot's key and priority change together: a slot is free when the
//      table holds no key there and no lane owns it. A walker that meets
//      its own key in the table stops, not new (the key was there before
//      the chunk; a displaced walker never meets it, since a key already
//      in the table sits before every free slot of its path). A walk past
//      `cap` probes sets *status and every walker stops;
//   3. finalize: each owned slot gets its lane's key; with a live sentinel
//      lane, whether any slot is still free is noted;
//   4. the sentinel: the reference stops at a full table before a
//      sentinel lane too. The table is full before the last live sentinel
//      lane iff it is full at the end and no new key comes after that
//      lane; then *status is set.
//
// Bound on an H100: bytes, once for the keys and mask read and the mask
// written, once more for each new key's slot; every probe is a dependent
// random read (table, owner, a displaced key), so the time is the
// latency of the longest walks plus the passes over owner[] (set, read)
// and the scratch table (set): about cap * 8 + 2 n_keys * 4 bytes beyond
// the bound.
//
// Entry 2, hashset_contains: one thread a key, the same probe, stopping
// at the key (true) or a free slot (false), at most capacity probes.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lowest_lane.cuh"

namespace {

constexpr long long kEmpty = (long long)0x8000000000000000ULL;

__device__ __forceinline__ int hash_slot(long long key, int mask) {
    const unsigned long long prod =
        static_cast<unsigned long long>(key) * 0x9E3779B97F4A7C15ULL;
    const long long h = static_cast<long long>(prod) >> 32;
    return static_cast<int>(h & static_cast<long long>(mask));
}

constexpr int kBlock = 256;
// The insert's work area (int32): kWork words, then owner[cap], then the
// lanes' scratch slots [n_keys], then the scratch table.
constexpr int kWork = 8;
constexpr int kStatus = 0;     // 1: the table is full
constexpr int kSentinel = 1;   // the last live sentinel lane, or -1
constexpr int kLastNew = 2;    // the last new lane, or -1 (with a sentinel)
constexpr int kFree = 3;       // 1: a slot is free at the end (ditto)

struct Insert {
    long long* table;
    int* count;
    const long long* keys;
    const uint8_t* valid;
    uint8_t* is_new;
    int* work;
    int* owner;
    int* lane_slot;  // a lane's scratch slot; -1 dead, -2 the sentinel
    int* dedup;      // lowest lane of each key, -1 free
    int n_keys;
    int cap;
    int dmask;
};

__global__ void __launch_bounds__(kBlock) hashset_dedup_kernel(Insert a) {
    const int i = blockIdx.x * kBlock + threadIdx.x;
    if (i >= a.n_keys) return;
    a.is_new[i] = 0;
    if (!a.valid[i]) {
        a.lane_slot[i] = -1;
        return;
    }
    const long long key = a.keys[i];
    if (key == kEmpty) {
        a.lane_slot[i] = -2;
        a.is_new[i] = 1;
        atomicAdd(a.count, 1);
        atomicMax(a.work + kSentinel, i);
        return;
    }
    a.lane_slot[i] = lowest_lane_insert(
        a.dedup, static_cast<unsigned>(a.dmask),
        static_cast<unsigned>(hash_slot(key, a.dmask)), i,
        [&](int o) { return a.keys[o] == key; });
}

// Lane i's walk (a first lane of its key): true when its key is new.
__device__ bool walk(const Insert& a, int i) {
    const int mask = a.cap - 1;
    int me = i;
    long long key = a.keys[i];
    int s = hash_slot(key, mask);
    int dist = 0;
    bool fresh = false;  // set once lane i's own key holds a slot
    for (;;) {
        if (dist >= a.cap) {
            atomicExch(a.work + kStatus, 1);  // round the whole table
            return fresh;
        }
        if ((dist & 63) == 63 && __ldcg(a.work + kStatus)) return fresh;
        const long long held = a.table[s];
        if (held != kEmpty) {  // a key from before the chunk
            if (held == key) return fresh;
            s = (s + 1) & mask;
            ++dist;
            continue;
        }
        int o = __ldcg(a.owner + s);
        if (o == -1) {
            o = atomicCAS(a.owner + s, -1, me);
            if (o == -1) return true;  // a free slot: the walk ends
        }
        if (o < me) {  // a key of higher priority
            s = (s + 1) & mask;
            ++dist;
            continue;
        }
        if (atomicCAS(a.owner + s, o, me) != o) continue;  // read again
        fresh = true;  // the key walking until now holds a slot
        me = o;  // the displaced key walks on
        key = a.keys[o];
        dist = (s - hash_slot(key, mask)) & mask;
        s = (s + 1) & mask;
        ++dist;
    }
}

__global__ void __launch_bounds__(kBlock) hashset_walk_kernel(Insert a) {
    const int i = blockIdx.x * kBlock + threadIdx.x;
    bool fresh = false;
    if (i < a.n_keys) {
        const int slot = a.lane_slot[i];
        if (slot >= 0 && __ldcg(a.dedup + slot) == i) fresh = walk(a, i);
    }
    if (fresh) {
        a.is_new[i] = 1;
        if (__ldcg(a.work + kSentinel) >= 0) atomicMax(a.work + kLastNew, i);
    }
    const int fresh_here = __syncthreads_count(fresh);
    if (threadIdx.x == 0 && fresh_here) atomicAdd(a.count, fresh_here);
}

__global__ void hashset_finalize_kernel(Insert a) {
    const bool sentinel = __ldcg(a.work + kSentinel) >= 0;
    for (long long s = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
         s < a.cap; s += static_cast<long long>(gridDim.x) * blockDim.x) {
        const int o = a.owner[s];
        if (o >= 0) {
            a.table[s] = a.keys[o];
        } else if (sentinel && a.table[s] == kEmpty) {
            a.work[kFree] = 1;
        }
    }
}

__global__ void hashset_sentinel_kernel(int* work) {
    if (work[kSentinel] >= 0 && work[kStatus] == 0 && work[kFree] == 0 &&
        work[kSentinel] > work[kLastNew])
        work[kStatus] = 1;
}

__global__ void hashset_contains_kernel(const long long* table,
                                        const long long* keys,
                                        uint8_t* found, long long n_keys,
                                        int cap) {
    const long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                        + threadIdx.x;
    if (i >= n_keys) return;
    const int mask = cap - 1;
    const long long key = keys[i];
    int h = hash_slot(key, mask);
    uint8_t hit = 0;
    for (int p = 0; p < cap; ++p) {
        const long long k = table[h];
        if (k == key) {
            hit = 1;
            break;
        }
        if (k == kEmpty) break;
        h = (h + 1) & mask;
    }
    found[i] = hit;
}

}  // namespace

extern "C" long long hashset_insert_work_ints(long long n_keys, int cap) {
    return kWork + cap + n_keys + lowest_lane_slots(n_keys);
}

extern "C" int hashset_insert_launch(void* table, void* count,
                                     const void* keys, const void* valid,
                                     void* is_new, long long n_keys, int cap,
                                     void* status, void* stream) {
    if (n_keys <= 0) return 0;
    if (cap <= 0 || (cap & (cap - 1)) || n_keys >= INT_MAX / 2)
        return static_cast<int>(cudaErrorInvalidValue);
    // status is the work area of hashset_insert_work_ints(n_keys, cap)
    // int32 words; *status, its first word, is 1 when the table is full.
    Insert a;
    a.table = static_cast<long long*>(table);
    a.count = static_cast<int*>(count);
    a.keys = static_cast<const long long*>(keys);
    a.valid = static_cast<const uint8_t*>(valid);
    a.is_new = static_cast<uint8_t*>(is_new);
    a.work = static_cast<int*>(status);
    a.owner = a.work + kWork;
    a.lane_slot = a.owner + cap;
    a.dedup = a.lane_slot + n_keys;
    a.n_keys = static_cast<int>(n_keys);
    a.cap = cap;
    const long long slots = lowest_lane_slots(n_keys);
    a.dmask = static_cast<int>(slots - 1);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(a.work, 0xff, kWork * sizeof(int), s);
    if (err == cudaSuccess)
        err = cudaMemsetAsync(a.work + kStatus, 0, sizeof(int), s);
    if (err == cudaSuccess)
        err = cudaMemsetAsync(a.work + kFree, 0, sizeof(int), s);
    if (err == cudaSuccess)
        err = cudaMemsetAsync(a.owner, 0xff, cap * sizeof(int), s);
    if (err == cudaSuccess)
        err = cudaMemsetAsync(a.dedup, 0xff, slots * sizeof(int), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned lane_blocks =
        static_cast<unsigned>((n_keys + kBlock - 1) / kBlock);
    hashset_dedup_kernel<<<lane_blocks, kBlock, 0, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    hashset_walk_kernel<<<lane_blocks, kBlock, 0, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long slot_blocks = (cap + kBlock - 1) / kBlock;
    const unsigned finalize_blocks =
        static_cast<unsigned>(slot_blocks < 4096 ? slot_blocks : 4096);
    hashset_finalize_kernel<<<finalize_blocks, kBlock, 0, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    hashset_sentinel_kernel<<<1, 1, 0, s>>>(a.work);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int hashset_contains_launch(const void* table, const void* keys,
                                       void* found, long long n_keys,
                                       int cap, void* stream) {
    if (n_keys <= 0) return 0;
    const int threads = 256;
    const long long blocks = (n_keys + threads - 1) / threads;
    hashset_contains_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(table),
        static_cast<const long long*>(keys), static_cast<uint8_t*>(found),
        n_keys, cap);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hashset_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
