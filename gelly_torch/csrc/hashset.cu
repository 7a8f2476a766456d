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
// Entry 1, hashset_insert: the keys in chunk order, each probing from its
// hash to its own key or the first free slot; a live key that lands on a
// free slot is written there, counted, and marked new. One thread walks
// the chunk, so the slot layout, is_new and count are bit for bit the
// scan's: is_new[i] is set iff keys[i] was absent before position i. The
// warp takes 32 keys at a time: each lane prefetches its key's first
// probe into L2 (prefetch.global.L2) or clears is_new of a dead lane, and
// lane 0 walks the live ones (a ballot) in order, so its dependent loads
// mostly hit L2; it reads through L2 (ld.cg), the only place it writes.
// A probe that walks the whole table (a full table: the reference would
// loop forever) sets *status and stops.
//
// Entry 2, hashset_contains: one thread a key, the same probe, stopping
// at the key (true) or a free slot (false), at most capacity probes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr long long kEmpty = (long long)0x8000000000000000ULL;

__device__ __forceinline__ int hash_slot(long long key, int mask) {
    const unsigned long long prod =
        static_cast<unsigned long long>(key) * 0x9E3779B97F4A7C15ULL;
    const long long h = static_cast<long long>(prod) >> 32;
    return static_cast<int>(h & static_cast<long long>(mask));
}

__global__ void __launch_bounds__(32)
hashset_insert_kernel(long long* table, int* count, const long long* keys,
                      const uint8_t* valid, uint8_t* is_new,
                      long long n_keys, int cap, int* status) {
    const int lane = threadIdx.x;
    const int mask = cap - 1;
    int cnt = lane == 0 ? *count : 0;
    for (long long base = 0; base < n_keys; base += 32) {
        const long long mine = base + lane;
        const bool live = mine < n_keys && valid[mine];
        if (live) {
            const int h0 = hash_slot(keys[mine], mask);
            asm volatile("prefetch.global.L2 [%0];" :: "l"(table + h0));
        } else if (mine < n_keys) {
            is_new[mine] = 0;
        }
        // The walk visits the live lanes only, in order.
        unsigned todo = __ballot_sync(0xffffffffu, live);
        int full = 0;
        if (lane == 0) {
            while (todo) {
                const long long i = base + __ffs(todo) - 1;
                todo &= todo - 1;
                const long long key = keys[i];
                int h = hash_slot(key, mask);
                long long k = __ldcg(table + h);
                int probes = 1;
                while (k != kEmpty && k != key && probes < cap) {
                    h = (h + 1) & mask;
                    k = __ldcg(table + h);
                    ++probes;
                }
                if (k != kEmpty && k != key) {
                    full = 1;  // every slot holds another key
                    *status = 1;
                    break;
                }
                const bool fresh = k == kEmpty;
                if (fresh) {
                    table[h] = key;
                    ++cnt;
                }
                is_new[i] = fresh;
            }
        }
        if (__shfl_sync(0xffffffffu, full, 0)) break;
    }
    if (lane == 0) *count = cnt;
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

extern "C" int hashset_insert_launch(void* table, void* count,
                                     const void* keys, const void* valid,
                                     void* is_new, long long n_keys, int cap,
                                     void* status, void* stream) {
    if (n_keys <= 0) return 0;
    hashset_insert_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<long long*>(table), static_cast<int*>(count),
        static_cast<const long long*>(keys),
        static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(is_new),
        n_keys, cap, static_cast<int*>(status));
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
