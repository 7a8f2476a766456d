// lowest_lane.cuh — a scratch hash table that keeps, for each key, the
// lowest lane holding it: the in-launch deduplication of
// spanner_fold_k2.cu (a sub-batch's pairs) and hashset.cu (a chunk's
// keys).
//
// The table holds lane numbers, -1 free, in lowest_lane_slots(lanes)
// slots (a power of two, at least twice the lanes, so probe runs stay
// short). A lane inserts itself from its key's home slot: at a free slot
// it claims it with compare-and-swap; at a slot held by a lane of its own
// key it stays if that lane is lower, and otherwise swaps itself in (read
// again when the slot changed under it); at a slot of another key it
// probes on. A slot's lane only ever decreases, so once every lane has
// returned, whatever the order the threads ran in, each key's slot holds
// its lowest lane.

#pragma once

inline long long lowest_lane_slots(long long lanes) {
    long long s = 64;
    while (s < 2 * lanes) s <<= 1;
    return s;
}

// Inserts `lane` from slot `s` of a table of `mask + 1` slots; `same(o)`
// tells whether lane o holds this lane's key. Returns the key's slot.
template <class SameKey>
__device__ __forceinline__ int lowest_lane_insert(int* table, unsigned mask,
                                                  unsigned s, int lane,
                                                  SameKey same) {
    for (;;) {
        int o = __ldcg(table + s);
        if (o == -1) {
            o = atomicCAS(table + s, -1, lane);
            if (o == -1) return static_cast<int>(s);  // claimed
        }
        if (same(o)) {
            if (o < lane) return static_cast<int>(s);  // a lower lane
            if (atomicCAS(table + s, o, lane) == o)
                return static_cast<int>(s);
            continue;  // the slot changed: read it again
        }
        s = (s + 1) & mask;
    }
}
