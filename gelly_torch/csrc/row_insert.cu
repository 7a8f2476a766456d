// row_insert — the capped-degree neighbour-row insert of a whole chunk.
//
// Replaces gelly_tpu/core/neighborhood.py's _row_step, a lax.scan of
// gelly_tpu/ops/rowtable.py's row_insert over a chunk's inserts: row a
// gets neighbour b unless b is already in the row (set semantics: the
// whole row of D slots is compared, as the reference compares it); a
// fresh b fills slot deg[a] while deg[a] < D, and past the cap it counts
// in *over and writes nothing.
//
// Rows are independent, and within a row the inserts apply in stream
// order. The caller groups the chunk's live inserts by row with a stable
// sort (stream order kept inside a row) and passes the runs: run r is
// rows[starts[r] .. starts[r+1]) with its values vals[...]. One thread
// walks one run in order, so nbr, deg and over are bit for bit the
// scan's, and the runs go fully in parallel. Rows outside [0, n) are
// skipped (the stream's range check comes first).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void row_insert_kernel(int32_t* nbr, int32_t* deg, int32_t* over,
                                  const int32_t* rows, const int32_t* vals,
                                  const int32_t* starts, int n_runs, int n,
                                  int max_degree) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= n_runs) return;
    const int lo = starts[r];
    const int hi = starts[r + 1];
    const int a = rows[lo];
    if (a < 0 || a >= n) return;
    int32_t* row = nbr + static_cast<long long>(a) * max_degree;
    int d = deg[a];
    int dropped = 0;
    for (int i = lo; i < hi; ++i) {
        const int32_t b = vals[i];
        bool present = false;
        for (int j = 0; j < max_degree; ++j) present |= row[j] == b;
        if (present) continue;
        if (d < max_degree) {
            row[d] = b;
            ++d;
        } else {
            ++dropped;
        }
    }
    deg[a] = d;
    if (dropped) atomicAdd(over, dropped);
}

}  // namespace

extern "C" int row_insert_launch(void* nbr, void* deg, void* over,
                                 const void* rows, const void* vals,
                                 const void* starts, int n_runs, int n,
                                 int max_degree, void* stream) {
    if (n_runs <= 0) return 0;
    const int threads = 256;
    const int blocks = (n_runs + threads - 1) / threads;
    row_insert_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(nbr), static_cast<int32_t*>(deg),
        static_cast<int32_t*>(over), static_cast<const int32_t*>(rows),
        static_cast<const int32_t*>(vals),
        static_cast<const int32_t*>(starts), n_runs, n, max_degree);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* row_insert_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
