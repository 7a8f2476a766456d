#!/usr/bin/env python3
"""Drive gelly_torch's streaming connected-components, window-triangle,
degree, bipartiteness, k-spanner and weighted-matching paths, the
per-window Merger plan, fused multi-query, windows (event-time,
lateness, pane rings, TTL), the stream API, the rest of the triangle
library (bucketed, capped-degree and unpacked dense windows, exact and
sampled counts), the mesh (four logical shards), the main path traced
through the obs core, the multi-tenant engine with its QoS plane,
ingest (the sharded readers, the native text parser and the wire) and
the example CLIs, on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits nonzero and prints no result line):

1. the card: ``nvidia-smi`` name and power limit, ``torch`` device name;
2. build: every kernel in ``gelly_torch/csrc/`` compiled with ``nvcc``
   (all sources at once), with the ``-Xptxas -v`` register and shared
   memory lines;
3. kernel: ``sorted_window_gather`` at the path's shapes (a real forest
   of ``2^24`` slots as the table, the sorted lo endpoints of a real dedup
   round as indices) must equal ``sorted_window_gather_plain`` exactly;
   prints its time (CUDA events, L2 flushed before every launch, mean of
   20), the plain version's, one ``table[sidx]`` call's as a yardstick,
   and the least time the card could take for the same bytes;
4. path: ``2^26`` Zipf edges (a copy of ``bench.py:synth_edges``, seed 17)
   over ``2^24`` slots in ``2^22``-edge chunks through
   ``edge_stream_from_source(...).aggregate(connected_components(...,
   fold_backend="kernel"), merge_every=4)``. Every emission must equal the
   same run with ``fold_backend="plain"``, the final labels must equal a
   ``scipy.sparse.csgraph`` oracle, and the kernel's launch count in that
   run must be exactly 3 per chunk that takes the dedup fold (capacity at
   least ``RAW_DEDUP_MIN_CHUNK``, counted independently; a chunk whose
   distinct pairs overflow ``unique_cap`` gathers too, its rounds masked
   on the card). Both runs keep every union-find round on the card: 0
   host syncs, 3 ``rooted_fixpoint`` launches a chunk (the dedup fold's
   tail, its gated re-run and gated fallback), a ``pointer_jump`` a
   close;
U. the union-find fixpoints (``csrc/unionfind_fixpoint.cu``) on inputs
   captured from the paths: phase 4's first dedup chunk's tail
   (``rooted_fixpoint``, pair form) and first close (``pointer_jump``),
   taken in a rerun of its first window, and a ``merge_forest_stack``
   (``union_edges``) of the raw plan with ``merge="gather"`` on four
   logical shards over ``2^25`` edges (its emissions equal phase 4's).
   Each must equal its plain version on the card, rounds met included
   (``pointer_jump``: its longest walk ``d`` hops against the plain
   loop's ``ceil(log2 d)`` doubling rounds); prints its time (CUDA
   events, L2 flushed, mean of 20, 5 for the merge), the plain
   version's and the least time for the bytes it must move (each lane's
   pair once, each hop of each chase once a round, each hook once, the
   forest read and the new one written once). Phase 7 does the same
   for its first star call (``rooted_fixpoint``, star form), as
   captured and with its gate open;
5. wedge kernel: ``wedge_count_matrix`` on the wedge mask of the triangle
   path's first window at ``N = 2^15``, and on a dense random mask at
   ``N = 4096`` (every block live, every tile mirrored), must equal
   ``wedge_count_matrix_plain`` exactly; prints its time (CUDA events, mean
   of 5 after one warm-up), its pre-pass's share, the plain version's, the
   faster of two exact single PyTorch calls for ``MᵀM`` (``torch._int_mm``
   on int8 copies, an f32 matmul with TF32), the least time the card could
   take for the work this mask needs (its live block triples, from
   ``wedge_needed_ops``) and, beside it, the dense product's;
6. triangle path: ``2^24`` Zipf edges (seed 17) over ``2^15`` slots, EVENT
   time ``ts = arange``, 4 tumbling windows of ``2^22`` ms, ``2^20``-edge
   chunks, through ``window_triangle_counts_batched(..., batch=4,
   method="auto")``. Every window's ``int64`` count must equal an oracle on
   the card (``((A @ A) * A).sum() / 6`` of the window's simple undirected
   adjacency), and the kernel's launch count must equal the number of
   windows whose group picked the kernel (counted independently);
7. compact CC path (``bench.py:bench_cc_large``'s call, cut in depth to
   a quarter): phase 4's ``2^26`` Zipf edges
   (seed 17) over ``2^24`` slots in ``2^20``-edge chunks through
   ``connected_components(2^24, merge="gather", codec="compact",
   compact_capacity=2^23)`` with ``merge_every=16`` and ``fold_batch=16``
   (the native unit codec built from ``native/chunk_combiner.cc`` with
   ``g++``; default codec workers, ``prefetch_depth`` and ``h2d_depth``): a
   warm-up on the first 16 chunks, then two timed runs, each with its
   wall, edges/s, stage busy seconds, host syncs per unit, peak device
   memory, wire bytes per edge and ``session.assigned``; the host codec
   alone (unit builder, id session and stacker, no device) with the
   pipeline's worker count. Checks: the segments wire and
   its fold were taken; 4 emissions of ``int32[2^24]``, each equal to the
   raw plan's (``2^22``-edge chunks, ``merge_every=4``) at the same
   boundary; the final labels equal phase 4's scipy oracle;
   ``session.assigned`` equals the seen slots; on the first ``2^24``
   edges, the pairs wire and the sparse plan (``connected_components(2^24)``,
   which folds with ``union_pairs_compact``) equal the first emission.
   The path launches neither hand-written kernel (counted);
8. a ``{"kernels": [...]}`` line (the two Pallas counterparts, the
   three gate and matching kernels, the two hash-set entries, the row
   insert, the sampler step and the k = 2 fold (its launches in F2, F3,
   L1 and L4 as ``phase_launches``; its µs and grid barriers a
   sub-batch on F3's second chunk, its chain floor there, F2's chunk
   times) and the three union-find fixpoints (their launches in phase 4,
   and for ``union_edges`` in phase U's merge run; other phases' as
   ``phase_launches``; rounds met) and the two parity kernels (their
   launches in E2's first sparse codec run, every other E run's and L1's
   and L2's as ``phase_launches``), each with the JAX function it
   replaces,
   the gather's and the sampler's launches on the mesh as
   ``mesh_launches``, the gather's and entry 2's in phase L1 as
   ``multiquery_launches``, the gather's in a traced run of phase M1 as
   ``obs_launches``, the gather's in phase N3's kernel tier as
   ``tenant_launches``, the gather's in phases P1, P2 and P4 as
   ``ingest_launches``, the gather's and the wedge kernel's in phase Q's
   CLI runs as ``cli_launches``, the gather's and the sampler's a
   process across processes as ``multihost_launches``: O1's a host and
   O3's (a) / (e) a process), then ``{"ok": true, "device": ...}``
   last.

The durable phases (checkpoints, exactly-once resume, the resilient
runner), each checking that the native codec was never disabled:

A. (in phase 7) the compact path with ``checkpoint_path`` and
   ``checkpoint_every=1``, twice, timed: 4 checkpoints, every emission
   equal to the plain runs'; its ``checkpoint`` busy seconds, bytes a
   checkpoint and the checkpoint directory's filesystem. Then a run that
   stops after the 3rd emission (the window-2 checkpoint at position 32
   stays on disk) and a fresh plan resuming from it: 2 emissions equal to
   windows 3 and 4, the load, ``on_resume`` and skip seconds and the time
   to recover (call to first emission);
B. (after phase 4) kill -9: phase 4's stream through the compact plan
   (``2^20``-edge chunks, ``merge_every=16``, ``fold_batch=16``, 4
   windows), written once as ``.npy``; a child ``python3 chip_smoke.py
   --durable-child <dir>`` (internal to this phase) checkpoints every
   window with a sleep before each unit and gets SIGKILL once the window-2
   checkpoint is on disk; a second child resumes (position >= 32) and its
   final labels must equal the in-process uninterrupted run's and scipy's.
   Prints the time to recover and its parts;
C. (after phase 4) ``ResilientRunner`` over phase 4's raw stream with
   ``fold_backend="kernel"``, a ``CheckpointManager`` checkpoint every 4
   chunks and a ``FaultPlan`` raising once at ``step`` and once at
   ``checkpoint_write``: 2 retries, a forest bit-identical to the
   uninterrupted chunk loop's (whose labels equal phase 4's), and the
   gather's launches counted.

The mesh across processes (phase O, after phase B; children
``python3 chip_smoke.py --coord-child <dir> <process>`` joined over
loopback gloo on ``cuda:0``; a failed check in any child exits it 1 and
fails the phase):

O. O1: two hosts each fold their half of phase 4's chunks through a
   coordinated ``ResilientRunner`` (a barrier every 2 chunks), then a
   cross-process butterfly: every host's merged labels equal phase 4's
   and scipy's, the gather launched 3 times a dedup chunk a host. O2: the
   leader is killed after the first manifest; the survivor exits nonzero
   within its lease bound; both resume and reach O1's forests. O3: 4
   processes x 2 logical shards (an 8-shard mesh) fold phase 4's first
   ``2^24`` edges; the butterfly and the hierarchical merge (degree 4)
   equal scipy's components; the keyed exchange conserves every shard's
   multiset. Then, in the same processes, each check printing a
   process's wall, edges a second, bytes through gloo, host syncs, peak
   device memory and its shards, every replicated value held equal
   across the 4 processes by its digest: (a) ``run_aggregation(mesh=)``
   of the raw plan on those edges in ``2^22``-edge chunks (a shard's
   slice ``2^19`` lanes, the dedup threshold set to it), 2 windows, with
   ``fold_backend="kernel"`` and ``"plain"`` each under the replicated
   and the delta merge: equal emissions, the last scipy's, the gather
   launched 3 times a dedup shard-chunk of the process's own shards
   (counted apart) and equal to its plain version at a shard's shapes;
   (b) the compact plan (``2^20``-edge chunks, ``merge_every=8``): (a)'s
   emissions; (c) ``ShardedCC`` over two folds of ``2^17`` pairs:
   scipy's labels; (d) ``ShardedDegrees`` (``auto``) over ``2^22`` edges
   and the deletion of their first ``2^20``: the signed ``bincount``; (e)
   on J4's stream made in the child: the sharded sampler (every local
   instance's state the unsharded run's, the estimate the single
   controller's, the kernel launched once a local shard a chunk and
   equal to its plain version at a shard's shape),
   ``sharded_window_triangles`` (one window: scipy's count) and
   ``ShardedExactTriangles`` on J4's first ``2^14`` edges (scipy's
   ``diag(A³) / 2``).

The degree and bipartiteness paths (after phase B, on the native degree and
parity codecs, never disabled; neither launches a hand kernel of
``HAND_KERNELS``, counted; each timed run prints its wall, edges or events
a second, stage busy seconds, H2D bytes, host syncs a unit and peak device
memory):

D. degrees. D1 (``bench.py:bench_degrees``' call): ``data/facebook_like.txt``
   read with ``read_edge_list``, cast to i32 and tiled to 64M edges over
   ``IdentityVertexTable(4096)`` in ``2^21``-edge chunks through
   ``degree_aggregate(4096)`` (the dense codec), ``merge_every`` =
   ``fold_batch`` = 16: a warm-up and two runs, every emission equal to a
   ``np.bincount`` oracle of the stream's prefix. D2: phase 4's stream plus
   its first ``2^24`` edges again as deletions (``2^26 + 2^24`` events in
   ``2^22``-edge chunks) through ``degree_aggregate(2^24)`` (the sparse
   codec), ``merge_every`` = ``fold_batch`` = 4: two runs, 5 emissions of
   ``int64[2^24]`` equal to the signed ``bincount`` oracle at their
   boundaries and to the dense codec's and the raw fold's; then a
   checkpointed run stopped after the 3rd emission and a fresh plan
   resuming from it. D3, the stream API on D2's stream, each timed:
   ``get_degrees`` (the last value of every touched slot equals the
   oracle), ``get_vertices`` (every seen slot once), ``number_of_edges``
   (ends at ``2^26 - 2^24``), ``number_of_vertices`` (ends at the seen
   slots), ``degree_distribution`` at the oracle's peak (the final
   histogram equals the oracle's) and one below it (``gelly_tpu``'s
   ``ValueError``), ``final_degrees`` on a ``2^20``-edge prefix;
E. bipartiteness. E1 (``bench.py:bench_bipartiteness``' call): 16M Zipf
   edges over ``2^17`` slots (seed 7) in ``2^23``-edge chunks through
   ``bipartiteness_check(2^17)`` (the dense codec), ``merge_every`` =
   ``fold_batch`` = 4: a warm-up and two runs, ``ok`` equal to the
   double-cover oracle (scipy components of the graph with ``(u, v)`` as
   ``(u, v + n)`` and ``(u + n, v)``). E2: phase 4's stream made bipartite
   (``src & ~1``, ``dst | 1``) through ``bipartiteness_check(2^24)`` (the
   sparse codec): two runs, every emission ``ok``, every edge two-colored,
   every root colored 0, the final labels equal to scipy's and to the
   dense codec's and the raw fold's; then the stop and resume of D2. E3:
   phase 4's stream without its self-loops, ``ok`` at every boundary equal
   to the double-cover oracle and never back once ``False``. Every run
   (warm-ups, the stopped and the resumed one included) prints its
   parity kernel launches (``union_edges_parity``,
   ``pointer_jump_parity``) and the rounds each union met and each
   close's longest walk (``MetLog``), and must launch both, one jump a
   union and one a close, and read no round on the host (0 host syncs).
   Then the parity kernels on inputs captured from E2 (``FirstCall``):
   the raw fold's first union, the sparse codec fold's first union and
   the first close's ``pointer_jump_parity`` (``2^24`` slots), each equal
   to its plain version on the card (rounds met included), timed (CUDA
   events, L2 flushed, mean of 20) beside the plain version and the
   least time for the bytes it must move
   (``parity_fixpoint_bytes``).

The per-window Merger plan and the spanner (phase F) and the matching
(phase G), after phase E (F1 right after phase 4); every timed run prints
its wall, edges a second, stage busy seconds, kernel launches and peak
device memory, and each gate call its kernel (or plain) milliseconds:

F. F1: a user-written transient aggregation with no ``fold_accumulates``
   (each window's signed degree vector: ``index_add_`` fold, in-place
   ``+`` combine) over phase 4's stream, ``merge_every=4``: every emission
   equals the window's ``bincount``, and the same plan with
   ``transient=False`` the prefix's; then phase 4's raw CC plan with
   ``host_precombine=cc_host_precombine`` on its first 8 chunks (a depth
   cut), whose labels equal phase 4's first two emissions. F2
   (``bench.py:bench_spanner``, no cut): ``2^21`` Zipf-1.6 edges over
   ``2^20`` slots (seed 31) in ``2^19``-edge chunks through
   ``sparse_spanner(2^20, 2, 16, max_edges=2^21, gate_batch=2^14)``,
   ``merge_every=1``: the combine's kernel (entry 2 of
   ``csrc/spanner_gate.cu``) at every close and the k = 2 fold's
   (``csrc/spanner_fold_k2.cu``) on every chunk, every emission equal to
   the same run with the combine's plain version, in which every chunk's
   fold is held to the plain fold on every field, every accepted edge an
   input edge, the bench's 500-edge stretch sample, and a stop after the
   3rd emission with a fresh plan resuming from the window-2 checkpoint.
   F3: phase 4's stream through ``sparse_spanner(2^24, 2, 16,
   gate_batch=2^14)`` in ``2^22``-edge chunks, ``merge_every=4``: the
   fold kernel on every chunk, the first two chunks' summaries equal to
   the plain fold's on every field and the second timed (kernel, plain,
   and the chain floor: the kernel's launch shape running only its grid
   barriers and one dependent row read a lane, on the same lanes);
   the plain combine equal on the first two windows (a depth cut), every
   accepted edge an input edge, and 10^4 sampled input edges within 2
   hops or, past that, within ``k`` a gate level (the window's fold and
   each close that re-gated the summary holding its edges; the
   reference's merges degrade the same way). F4: (i) the exact sequential
   gate, entry 1, ``sparse_spanner(2^12, 3, 16)`` over two random
   Hamiltonian cycles (degree at most 4, so no frontier truncation and no
   row overflow), equal to its plain version, to the native host spanner
   edge for edge, and to the dense plan's plain per-edge fold; (ii) the
   ingest codec, ``spanner(2^20, 3, max_degree=16, ingest_combine=True,
   payload_cap=2^15)`` over F2's stream with 2 codec workers, each
   chunk-local spanner re-gated through entry 1: the first ``2^18``
   edges' run (a depth cut of the first ``2^19``-edge chunk) equal to
   the plain re-gate, every accepted edge an input edge, 2000 sampled
   input edges within ``k^2 = 9`` hops;
G. ``bench.py:bench_matching`` (BASELINE #5, no cut): the ratings fixture
   tiled with a fresh permutation of its 4096 ids a repetition (4M edges)
   in one ``2^23``-edge chunk: the host native path's matching equals the
   bench's Python oracle, ``events()`` replays to it, ``device=True`` (the
   ``csrc/matching_step.cu`` kernel) equals it (integer weights: no f32
   threshold window), and the kernel equals its plain version on a
   ``2^12``-edge prefix.

Fused multi-query (phase L, right after F3, on phase 4's stream and
``2^22``-edge chunks, ``merge_every=4``; each timed run prints its wall,
edges a second, stage busy seconds, H2D bytes, kernel launches and peak
device memory, its launch counts set to 0 just before it):

L. L1: ``run_aggregation(None, stream, queries=[cc_query(2^24,
   fold_backend="kernel"), degrees_query(2^24), bipartiteness_query(2^24),
   spanner_query(2^24, 2, every=4, max_degree=16, gate_batch=2^14)])``:
   4 emissions, each query's equal to its standalone run at the same
   boundary (phase 4's kernel labels, a degree and a bipartiteness run,
   F3's emissions: the same plan), each freed once compared; the gather
   launched 3 times a dedup chunk and entry 2 of ``csrc/spanner_gate.cu``
   at each of the spanner's merge windows and each emission's
   merge-on-read, the k = 2 fold kernel once a chunk, both parity
   kernels in the fused run and the standalone bipartiteness run
   (counted); the fused wall and H2D bytes beside the sum of
   the four standalone runs'. L2: the trio ``cc_query``,
   ``degrees_query``, ``bipartiteness_query`` with ``compressed=True,
   codec="sparse"``, ``fold_batch=4``: the shared compress stage took
   every chunk (counted), the wire bytes an edge, both parity kernels
   launched, every emission equal to the three standalone sparse-codec
   runs' (and the CC labels to phase 4's). L3: L2's trio on ``make_mesh(4, devices=[cuda:0] * 4)``: every
   emission equal to L2's (CC labels and degrees; bipartiteness's ``ok``).
   L4: L1's quartet checkpointed every second window (a 3.7 GB write
   each) and stopped once the window-2 checkpoint is on disk (after the
   3rd emission), then a fresh plan resuming from it: windows 3 and 4
   equal L1's, both runs folding through the k = 2 fold kernel.

The traced main path (phase M, right after phase L; the obs core of
``gelly_torch/obs`` and ``utils.metrics.trace``):

M. M1: phase 4's run (``2^24`` slots, ``2^26`` Zipf edges, seed 17,
   ``2^22``-edge chunks, ``merge_every=4``, ``fold_backend="kernel"``)
   under ``obs.scope()`` with ``SpanTracer(heartbeat_every_s=0.05)``
   installed, then untraced, alternating, best of 2 each: every emission
   equal to phase 4's; 16 ``compress``, 16 ``h2d`` and 16 ``fold`` spans,
   4 ``merge_emit`` spans and 4 ``window_close`` instants;
   ``engine.chunks_folded`` 16, ``engine.windows_closed`` 4,
   ``engine.edges_folded`` the stream's edges; 16
   ``engine.fold_dispatch_ms`` samples; a backlog age of 0 at the end; at
   least one heartbeat; the ``write_chrome_trace`` file valid; 3 gather
   launches a dedup chunk (48); host syncs a unit equal traced and
   untraced. Prints both walls and the overhead (gated loosely, < 50%).
   M2: the first 4 chunks inside ``trace(log_dir, tracer=tr)``
   (``torch.profiler``): one Chrome JSON in ``log_dir`` whose CUDA kernel
   events hold the gather as many times as it launched, the
   ``torch_profiler_start`` / ``torch_profiler_stop`` instants carrying
   ``tr.trace_id``; prints the device idle share (one minus the union of
   kernel and copy intervals over the traced window). M3: L2's call
   traced: every ``fold`` span's ``queries`` is
   ``"cc,degrees,bipartiteness"``, one ``multiquery/<name>`` span a query
   a window, ``multiquery.compressed_chunks`` on the bus the chunk count,
   every emission equal to L2's. M4: phase C's ``ResilientRunner`` traced
   with ``dump_on("faults.injected")``: two ``faults.injected`` instants,
   two valid flight dumps, ``resilience.retries`` on the bus equal to
   ``runner.stats["retries"]`` (2), the forest equal to phase C's.

The multi-tenant engine (phase N, right after phase M;
``engine/tenants.py``, ``engine/qos.py``; each tier's fold form read off
``TenantPlan.forms``):

N. N1 (``bench.py:bench_tenants``' sweep at its size):
   ``cc_tenant_tier(2^12, chunk_capacity=2^10)``, 8192 uniform edges a
   tenant (seed ``1000 + t``, 8 chunks), ``merge_every=2``, N = 1, 8, 64
   and 256 tenants: the batched engine's drain against N single-stream
   ``run_aggregation`` passes over the same plan (walls, edges/s and
   their ratio printed, not gated); 8 dispatches at every N, the
   lane-batched fold called once a round (its wrapper counted), every
   tenant's labels equal to its single-stream run's. N2 (full width):
   4096 tenants x ``2^12`` slots = ``2^24`` slots of tier state, each
   tenant 8 chunks of ``2^10`` Zipf edges (``synth_edges``, seed ``17 +
   t``): 8 dispatches and 8 lane-batched folds, every tenant equal to
   scipy (one call over the lane-offset graph, canonical-min labels),
   the first 64 equal to their single-stream runs; prints the wall,
   edges/s, ``tenants.round_ms`` p50 and p99 and the peak device memory.
   N3 (the kernel tier): ``cc_tenant_tier(2^22, chunk_capacity=2^22,
   fold_backend="kernel")``, 4 tenants of 4 Zipf chunks (seed ``100 +
   t``): the dedup fold lane by lane, the gather launched 3 times a
   lane-chunk whose distinct pairs fit its cap (counted apart), each
   tenant equal to its single-stream kernel and plain runs. N4: N2's
   tenants through ``cc_tenant_tier(2^12, chunk_capacity=2^10,
   compressed=True, codec="sparse")`` with ``submit_payload`` (payloads
   compressed before the timed window): every window's snapshot equal
   to N2's, ``tenants.compressed_dispatches == tenants.dispatches``, the
   wire bytes an edge. N5 at 64 tenants of N1's tier: (a) serving mode,
   4 submitter threads and a querying thread, every answer a snapshot a
   tenant prefix gives, windows never going back, the labels after
   ``stop()`` equal to N1's; (b) per-tenant checkpoints, a stop after
   window 2 and a resume in a new engine equal to N1's; (c) a
   ``QosController`` parks tenant 0 (lane freed, the parked row
   answering) and unparks it, every tenant equal to N1's.

Ingest (phase P, right after phase N; ``gelly_torch/ingest``, at phase
4's full width: ``2^24`` slots, its ``2^26`` Zipf edges, seed 17; every
run's launch counts set to 0 just before it, every dedup-branch count
made apart from the fold):

P. P1: phase 4's stream written with ``write_binary_edges`` (1 GiB of
   ``<i8`` pairs in the temporary directory) and read by
   ``edge_stream_from_sharded_file(path, 2^24, shards=4,
   chunk_size=2^22)`` into the kernel plan (``connected_components(2^24,
   merge="gather", ingest_combine=False, fold_backend="kernel")``,
   ``merge_every=4``, ``source_provider=True``), traced: the final labels
   equal phase 4's and scipy's, the gather launched 3 times a dedup chunk
   in the provider's order, one ``compress/gelly-reader_<s>`` track a
   lane and no ``produce`` span; then phase 4's first ``2^20`` edges as
   a text edge list: ``utils.native.parse_edge_list_file`` (``g++`` build
   of ``native/edgelist_parser.cc``) equal to ``parse_edge_list_text``,
   both timed, and ``read_edge_list`` taking the native parser. P2: an
   ``IngestClient`` thread sends phase 4's stream to an ``IngestServer``
   on loopback as raw DATA frames of ``2^21`` edges (a ``2^22``-edge
   frame would pass ``MAX_PAYLOAD``); ``run_aggregation(kernel plan,
   srv.chunks(2^22, 2^24), merge_every=8)`` (a bare iterator: the card):
   every emission equals phase 4's at the same edge count, the gather
   launched 3 times a dedup frame, and a ``fetch_stats`` on a dedicated
   connection after the first emission holds non-zero ``ingest.*``
   counters; prints the wall, edges/s, wire bytes an edge, frames, PAUSE
   engagements, peak device memory and the host's share (the wall
   outside the fold and the window close). P3 (``bench.py:bench_ingest``'s
   compressed wire at full width): the client compresses phase 4's
   ``2^22``-edge chunks with ``connected_components(2^24,
   codec="sparse").host_compress`` and sends them as STACKED frames of
   K = 4; ``run_aggregation(..., srv.compressed_payloads(),
   precompressed=True, merge_every=4)``, traced: every emission equals
   phase 4's, no ``compress`` span and one ``stack`` span a unit; prints
   the wire bytes an edge. P4: a child ``python3 chip_smoke.py
   --ingest-child <dir>`` serves phase 4's first ``2^24`` edges (8 raw
   frames of ``2^21``) into the kernel plan with ``auto_ack=False``, a
   checkpoint and an ack every 2 frames, pausing after each emission; it
   is SIGKILLed after its first ack and restarted on its checkpoint, and
   the client resends from the WELCOME position: the labels equal phase
   4's first emission, the restarted server enqueues exactly the frames
   past its position, each child's gather launches are 3 a dedup frame it
   folded; prints the time to recover and its parts (the first child
   starts with the phase, so its CUDA start overlaps P1-P3). P5: N2's
   4096 tenants (``cc_tenant_tier(2^12, chunk_capacity=2^10)``, 8 Zipf
   chunks of ``2^10`` a tenant) from a client process (``python3
   chip_smoke.py --ingest-client <dir>``) over one ``tenant_streams``
   connection in single-tenant STACKED frames of 8 through a
   ``TenantRouter``; the engine drains once the wire has queued every
   chunk, so its 8 rounds are full, as N2's: every tenant's labels equal
   N2's; prints the aggregate edges/s, the wire's and
   ``tenants.round_ms`` beside N2's. Then the checkpoint-gated acks
   (``auto_ack=False``, ``TenantRouter(checkpoint_acks=True)``, one
   per-tenant checkpoint at the last window) on the first 64 tenants, a
   cut: a per-tenant checkpoint took ~20 ms on the card's temporary
   filesystem, 80 s at 4096: every tenant's acks reach the client and its
   labels equal N2's. P6: P2's first ``2^23`` edges
   traced: the ``client_send``, ``wire_recv``, ``staging`` and ``fold``
   spans share one trace id, and the first fold's parent is the first
   staging span.

The example CLIs (phase Q, right after phase P; ``gelly_torch/examples/``
called in process through ``main(args)``, stdout captured, at each
CLI's own width; launch counts set to 0 just before each run):

Q. Q1: every CLI's ``main([--device=cuda])`` on its built-in data, its
   stdout equal line for line to the same call with ``--device=cpu``
   (``# `` and ``Runtime:`` lines left out); ``tests/test_clis.py``'s
   goldens (the CC odd/even components, ``(2,399) (3,799) (2,1199)``,
   ``(1,2)``, ``total weight:``, ``--queries=cc,degrees,bipartiteness``)
   and the ``--stats`` / ``--queries`` refusals. Q2: ``2^21`` Zipf edges
   over ``2^16`` ids (seed 17) written as a text edge file, then
   ``connected_components <file> 16`` (the CLI's ``2^16`` slots, its
   4096-edge file chunks), again with ``--shards=4`` and with
   ``--queries=cc,degrees,bipartiteness``: components equal to scipy,
   the top degrees to ``bincount``; prints each wall and edges/s and the
   gather's launches (``fold_backend="auto"`` resolves to the plain
   fold). Q3: ``2^21`` Zipf edges over 4096 ids with ``ts = arange`` as
   a text file, ``window_triangles <file> 16384`` (128 windows of
   ``2^14`` edges, the most the CLI's default window buffer holds; each
   dense enough that ``method="auto"`` picks the wedge kernel): every
   window's count equal to scipy's, at least one wedge launch a window.
   Q4: ``connected_components --serve=PORT`` on a thread of this process
   on the card and ``--connect`` on Q2's file in a child process
   (``python3 chip_smoke.py --cli-client``, started before Q1 so that
   its start overlaps Q1-Q3; it takes each run's arguments on its
   stdin and answers with the CLI's stdout and whether it created a
   CUDA context), raw, then ``--compressed --stack=4``: the components
   equal Q2's and the client created no CUDA context. Q5: ``--checkpoint-dir`` with a checkpoint
   every 128 chunks, a non-retried fault injected at the 258th fold (two
   checkpoints on disk), then the same command again: it resumes
   (``# resumed from``), folds fewer chunks, and its components equal
   Q2's.

The sync audit (phase R, right after phase 4, on phase 4's stream):

R. R1: ``python -m gelly_torch.analysis --all gelly_torch`` in a child
   process on the card host (no JAX there), started at phase R and
   joined before the result lines (it runs on a host core beside the
   phases between): exit 0, JAX absent from its modules; prints its
   wall. R2: under
   ``torch.cuda.set_sync_debug_mode("warn")``, phase 4's first 4 chunks
   of ``2^22`` edges (``2^24`` slots) through the raw CC plan (plain and
   kernel backends), the compact plan, the degree plan and the
   bipartiteness plan (``merge_every`` = 4), and one round of a
   64-tenant CC tier (``cc_tenant_tier(2^12, chunk_capacity=2^10)``, one
   chunk a tenant): every synchronizing operation the card reports is
   recorded at its innermost ``gelly_torch/`` frame (``warnings``'
   hook walks ``traceback.extract_stack()``). Prints, for each plan, the
   syncs seen beside the ``host_sync.count`` delta, and each line with
   its count and class (``counted``: inside ``host_sync``; ``scope``:
   inside a device scope of ``gelly_torch.analysis.jitlint``, with the
   rule its justified suppression names; ``host``: outside every scope). Fails on a sync
   inside a device scope whose line carries neither, and when a plan's
   emission differs from its reference: phase 4's first emission (the
   CC plans), ``np.bincount`` (degrees), the same run with the debug
   mode off (bipartiteness, the tenant round), and when the bipartiteness
   plan counts a host sync (its rounds run on the card).

Windows (phase H) and the stream API (phase I), after phase G (I5 after
phase 6); each timed run prints its wall, edges a second, stage busy
seconds, kernel launches and peak device memory:

H. H1: phase 4's stream in ``2^18``-edge chunks through
   ``connected_components(2^24, merge="gather", codec="dense",
   windowed=W)``, ``merge_every=2``, W = 64 over the first ``3 x 2^24``
   edges (96 panes; a depth cut of 128
   panes) and W = 4 over its first ``2^25`` edges (64 panes): three
   emissions each (the W-th, one mid-stream, the last) equal the labels
   of exactly their window's edges (scipy, or phase 4's emission for a
   prefix), the snapshot handle tracks every close; prints the pane
   close ms, combines a close, a full replay of W panes and
   bench_windows' two ratios (not gated). H2: a drifting stream (chunk
   i from the ``2^20``-slot block at ``(i * 2^16) mod 2^24``, seed 19,
   128 chunks, more distinct slots than the capacity) through the
   compact plan with ``compact_capacity=2^23``, ``windowed=8``,
   ``ttl_panes=8``, quiesced: ``session.assigned`` plateaus (bench's
   test, 1% of room), three emissions equal scipy, and a resume from the
   pane-56 ring checkpoint is bit-identical. H3: ``window_ms=2^24``
   through the sparse codec, the raw fold and the raw kernel fold: every
   window equals phase 4's emission at that boundary, the gather
   launched 3 times a dedup chunk. H4: timestamps permuted in ``2^20``
   blocks with ``allowed_lateness=2^20``: H3's windows, no late edge,
   the buffer's peaks, and a stop after emission 2 with a resume through
   the sidecar. H5: ``degree_aggregate(2^24, windowed=8)``,
   ``merge_every=4``: three emissions equal ``np.bincount``.
I. I1: ``distinct(device=True)`` on the first ``2^23`` edges: masks
   equal the host path and a numpy first-occurrence oracle,
   ``hashset_contains`` true on every key and false on ``2^20`` absent
   ones (equal to its plain version at that shape); the first chunk's
   insert (entry 1 of ``csrc/hashset.cu``: parallel walks that settle in
   the scan's layout) equal to its plain version; the insert kernel
   against its plain version on a random prefilled table and on an
   adversarial one (``2^16`` keys homed in 4096 slots of a ``2^20``-slot
   table filled to 0.6, lanes ``i`` and ``i + 2^15`` one key). I2: the
   transforms on a ``2^22``-edge prefix equal numpy. I3:
   ``IterativeCCStream`` over phase 4's stream: every label in its slot's
   scipy component (the reference leaves some roots stale; counted). I4:
   four random Hamiltonian cycles over ``2^24`` slots through
   ``build_neighborhood(max_degree=16)`` (the row kernel) equal an
   oracle, the kernel equals the plain row step on the first ``2^12``
   edges, a degree-17 vertex raises the reference's message, and the
   dense path at ``N = 2^14``. I5: phase 6's windows through
   ``slice(2^22, "all")``: ``reduce_on_edges`` (int32 add) and
   ``apply_on_neighbors`` (max neighbour) equal numpy; ``fold_neighbors``
   on I4's first ``2^22`` edges in 4 windows.

The rest of the triangle library (phase J, after I5; each driven run
prints its wall, edges a second, kernel launches and peak device memory;
the oracle is the triangle count of each window's simple undirected graph
with scipy, every edge oriented toward the endpoint of higher ``(degree,
id)``, and ``diag(A³) / 2`` of the final graph for the exact paths):

J. J1 (``bench.py``'s degree-bucketed cell, no cut): 10,000,000 edges,
   ``src`` then ``dst`` = ``default_rng(31).zipf(1.6) % 2^20``, ``ts =
   arange``, 10 windows of 1,000,000, ``window_capacity=4,000,000``,
   ``batch=10``, through ``window_triangles_bucketed``: every window
   equals the oracle; the host prep alone and the device count alone.
   J2: phase 6's stream over ``2^16`` slots (``n*n >= 2^31``: the
   unpacked dense path), 4 windows of ``2^22``, ``method="auto"``: every
   window equals the oracle, the wedge kernel launched once a window, and
   on window 0 ``2^16`` sampled ``W`` entries equal their column
   products; the kernel's time and bound at ``N = 2^16``. J3: the square
   of a random Hamiltonian cycle over ``2^24`` slots (seed 23, ``2^25``
   edges), 4 windows, ``max_degree=8``, ``batch=4``: every window equals
   the oracle (the square of a cycle has its counts in closed form: a
   window of W edges ``W/2 - 1``, the stream ``n``, 3 at every vertex;
   the formula held to scipy on a ``2^16``-slot cycle, a cut of PR 9's
   scipy oracle at ``2^24`` slots) and ``window_triangles_bucketed``;
   with a degree-9 vertex
   added to window 2, the default run raises naming ``max_degree`` and
   ``yield_overflow=True`` flags exactly window 2. J4: exact dense counts,
   ``synth_edges(2^19, 2^12)`` in ``2^17``-edge chunks (a depth cut of
   ``bench_triangles``' 2M edges), equal to the oracle's total and
   per-vertex counts, again with an ``arrival_budget`` forcing rebases.
   J5: exact capped-degree counts on J3's stream in ``2^22``-edge chunks,
   ``max_degree=8``: the oracle's total and per-vertex counts; the hub
   variant raises. J6: ``sampled_triangle_count`` (``S = 2^16``, seed
   ``0xDEADBEEF``) on J4's stream: the ``csrc/sampler_step.cu`` kernel
   equals ``sampler_step_plain`` in every field on the first ``2^9``
   lanes from a fresh state (a cut of ``2^12``: the plain version's host
   loop took 29-37 s), launches once a chunk, and its estimate is
   printed beside J4's exact total.

The mesh (phase K): ``make_mesh(4, devices=[cuda:0] * 4)``, four logical
shards on the card, each holding its state at full width (K1-K4 after
phase I, on phase 4's stream; K5-K6 after phase J, on J4's stream); each
run prints its wall, edges a second, host syncs, kernel launches and peak
device memory, and its launch counts are set to 0 just before it:

K. K1: phase 4's stream in ``2^24``-edge chunks (a shard folds ``2^22``
   lanes: the dedup fold) through the raw plan, ``merge_every=2``, with
   ``fold_backend="kernel"`` under the replicated and the delta merge
   and ``"plain"`` under the replicated: every emission equals phase 4's
   (S = 1) at its boundary and the last scipy's, ``merge_modes`` counts
   each close, the gather launched 3 times a dedup shard-chunk, and
   ``sorted_window_gather`` equals its plain version at a shard's shapes.
   K2: the compact cell's call on the same ``2^26`` edges in
   ``2^20``-edge chunks with the cid-space delta merge, once with
   ``merge_every=16`` and ``fold_batch=16`` and once in event-time
   windows of ``2^24`` (each chunk split on the host with
   ``split_chunk_host``): every emission equals phase 4's. K3:
   ``ShardedCC`` over the same edges as 4 folds of ``2^24`` pairs, hook
   rounds and lookup levels printed a fold, ``labels()`` after folds 2
   and 4 equal to K1's emissions, ``dropped == 0``. K4: ``ShardedDegrees``
   (``mode="auto"``) on D2's deletion stream: the degrees equal the
   signed ``bincount``, ``fallback_chunks`` and ``dropped`` printed. K5:
   ``sampled_triangle_count(mesh=)``, ``S = 2^16`` instances on J4's
   stream: every instance's state equals the unsharded run's (J6's), the
   estimates J6's within ``rtol=1e-6``, the kernel launched once a shard
   a chunk and equal to its plain version at a shard's 2^14 instances.
   K6: J4's stream as one ``2^20``-ms window through
   ``sharded_window_triangles`` (equal to ``window_triangles`` and J4's
   exact total) and through ``ShardedExactTriangles`` (equal to
   ``exact_triangle_count`` vertex by vertex).

Cuts to fit the time limit, each named where it applies: every path's
profiled rerun under ``torch.profiler`` (the device's busy time and idle
share a path; the earlier runs' are in PERF.md, and phase M2 still
profiles the main path's first chunks) was taken out to make room for
phase P; H1's W = 4 ring run was cut to half of phase 4's stream to
make room for phase Q; earlier cuts are in the phases' own lines.

Needs one CUDA card, ``nvcc``, ``g++`` and scipy; imports nothing of JAX.
The checkpoint and stream files go to the temporary directory and are
removed at the end of each phase.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

N_VERTICES = 1 << 24
N_EDGES = 1 << 26
CHUNK = 1 << 22
MERGE_EVERY = 4
SEED = 17
REPS = 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT8_OPS_PER_S = 1.979e15  # H100 SXM data sheet, dense int8 tensor cores

# The triangle path: the largest power-of-two slot space the packed dense
# path takes (n * n < 2^31), 4 tumbling windows of 2^22 edges.
TRI_N = 1 << 15
TRI_EDGES = 1 << 24
TRI_WINDOW_MS = 1 << 22
TRI_WINDOW_CAPACITY = 1 << 23  # the doubled ALL-direction calibration
TRI_CHUNK = 1 << 20
TRI_BATCH = 4
WEDGE_REPS = 5
DENSE_N = 4096  # the dense random wedge check

# The compact CC path: bench.py:bench_cc_large (streaming_cc_large) cut in
# depth to a quarter, phase 4's 2^26 edges and oracle (a 2^27-edge stream
# of its own took 59-63 s to make and its oracle 18 s), 2^20-edge chunks,
# 4 windows of 2^24 edges.
CC_EDGES = N_EDGES
CC_CHUNK = 1 << 20
CC_MERGE_EVERY = 16
CC_FOLD_BATCH = 16
CC_COMPACT = 1 << 23
CC_RAW_MERGE_EVERY = 4  # 2^22-edge raw chunks: the same 2^24 boundaries
CC_PREFIX = 1 << 24  # one window: the pairs wire and the sparse plan

# Phase B (kill -9): phase 4's 2^26-edge stream through the compact plan in
# 2^20-edge chunks, 4 windows of one 16-chunk unit each (a depth cut of
# phase 7's 2^28, so that two child processes fit the time limit). The
# killed child sleeps before each unit's fold, so the kill lands between
# the window-2 checkpoint and the end of the stream.
KILL_MERGE_EVERY = 16
KILL_FOLD_BATCH = 16
KILL_UNIT_SLEEP_S = 2.0
KILL_AT_WINDOWS = 2
CHILD_TIMEOUT_S = 300

# Phase C (resilient raw fold): a checkpoint every 4 of phase 4's chunks.
RESILIENT_EVERY = 4

# Phase D (degrees). D1: bench.py:bench_degrees' call, the ego-Facebook-
# shaped fixture tiled to 64M edges over its 4096-slot id space in
# 2^21-edge chunks, merge_every = fold_batch = 16. D2: phase 4's stream
# plus its first 2^24 edges again as deletions; D3 runs final_degrees (a
# Python dict) on a 2^20-edge prefix.
D1_EDGES = 64_000_000
D1_N = 4096
D1_CHUNK = 1 << 21
D1_MERGE_EVERY = 16
D2_DELETES = 1 << 24
D3_PREFIX = 1 << 20

# Phase E (bipartiteness). E1: bench.py:bench_bipartiteness' call, 16M Zipf
# edges over 2^17 slots (seed 7) in 2^23-edge chunks, merge_every =
# fold_batch = 4. E2 and E3 use phase 4's stream and chunks.
E1_EDGES = 16_000_000
E1_N = 1 << 17
E1_SEED = 7
E1_CHUNK = 1 << 23

# Phase F (the per-window Merger plan and the k-spanner). F1: a user
# transient aggregation over phase 4's stream, then phase 4's raw CC plan
# with cc_host_precombine on its first 8 chunks (a depth cut: the numpy
# pre-combiner takes about 1.7 s a 2^22-edge chunk). F2:
# bench.py:bench_spanner's stream and plan (no cut) through the engine.
# F3: the spanner on phase 4's stream; its plain combine on the first two
# windows only (a depth cut). F4: the sequential gate, exact on a stream
# of bounded degree (i), and through the ingest codec on F2's stream (ii).
F1_PRECOMBINE_CHUNKS = 8
F1_PRECOMBINE_WORKERS = 8
SPANNER_D = 16
SPANNER_SUB = 1 << 14
F2_N = 1 << 20
F2_EDGES = 1 << 21
F2_CHUNK = 1 << 19
F2_SEED = 31
F2_ZIPF = 1.6
F2_SAMPLE = 500
F3_SAMPLE = 10_000
F3_PLAIN_DONOR = 1 << 16
F4_N = 1 << 10
F4_SEED = 5
F4_CODEC_CAP = 1 << 15
F4_CODEC_WORKERS = 2  # each holds 2^20 x 128 i32 of chunk-local rows
F4_SAMPLE = 2000
# F4(ii)'s plain re-gate on CPU tensors takes ~10 s for the first
# 2^19-edge chunk: a depth cut to 2^18 edges, for phase O3's checks.
F4_REGATE_EDGES = 1 << 18

# Phase G (matching, bench.py:bench_matching's call, no cut): the ratings
# fixture tiled with a fresh permutation of its 4096 ids a repetition, to
# 4M edges, in one 2^23-edge chunk; the kernel against its plain version
# on a 2^12-edge prefix.
G_EDGES = 4_000_000
G_N = 4096
G_CHUNK = 1 << 23
G_SEED = 11
G_PREFIX = 1 << 12  # a depth cut of 2^16: the plain check on the CPU
G_TIMED = 1 << 12


# The hand kernels' wrappers, each counting its launches in ``.launches``.
# Under the 1200 s a run of this script may take, with time left to dump
# the stacks. 1150 s until PR 16: a run on a card host ~22% slower than
# the others reached it in phase K5-K6.
# Phase R (sync audit): phase 4's first chunks, and one tenant round.
R_CHUNKS = 4
R_TENANTS = 64

WATCHDOG_S = 1180
HAND_KERNELS = ("sorted_window_gather", "wedge_count_matrix",
                "sparse_insert_edges", "sparse_insert_edges_batched",
                "matching_step", "hashset_insert", "hashset_contains",
                "row_insert_chunk", "sampler_step", "sparse_fold_chunk_k2")
# The sparse spanner summary's fields, in the kernel wrappers' order.
SPANNER_FIELDS = ("nbr", "deg", "deg_overflow", "esrc", "edst", "n",
                  "overflow")
NO_LAUNCHES = (0,) * len(HAND_KERNELS)
# The union-find fixpoints and the parity union-find
# (csrc/unionfind_fixpoint.cu): every CC and bipartiteness path runs
# them, so they are counted apart from HAND_KERNELS, whose counts the
# phases check kernel by kernel.
FIXPOINT_KERNELS = ("rooted_fixpoint", "pointer_jump", "union_edges",
                    "union_edges_parity", "pointer_jump_parity")


def reset_launches(kernels) -> None:
    """Every hand kernel's launch count to 0 (just before a driven run)."""
    for name in HAND_KERNELS + FIXPOINT_KERNELS:
        getattr(kernels, name).launches = 0


def fixpoint_counts(kernels) -> dict:
    """The union-find fixpoint kernels' launch counts."""
    return {name: getattr(kernels, name).launches
            for name in FIXPOINT_KERNELS}


def launch_counts(kernels) -> tuple:
    """The hand kernels' launch counts, in :data:`HAND_KERNELS` order."""
    return tuple(getattr(kernels, name).launches for name in HAND_KERNELS)


def mark(phase: str, t_start: float) -> None:
    """A line at the start of each phase group: seconds since the start."""
    print(f"[{time.perf_counter() - t_start:.1f} s] phase {phase}",
          flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def synth_edges(num_edges: int, num_vertices: int, seed: int):
    """Zipf endpoints over a permuted id space (bench.py:synth_edges)."""
    rng = np.random.default_rng(seed)
    a = 1.3
    src = rng.zipf(a, size=num_edges) % num_vertices
    dst = rng.zipf(a, size=num_edges) % num_vertices
    perm = rng.permutation(num_vertices)
    return perm[src].astype(np.int32), perm[dst].astype(np.int32)


def time_ms(torch, fn, device, reps: int = REPS, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, each measured with
    CUDA events after a 256 MB write that evicts the 50 MB L2."""
    flush = torch.empty(64 << 20, dtype=torch.int32, device=device)
    for _ in range(warmup):
        fn()
    total = 0.0
    for i in range(reps):
        flush.fill_(i)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


class KernelView:
    """While installed, ``module.kernels`` (``ops/unionfind.py``'s or
    ``ops/parity_unionfind.py``'s reference to the kernels module) is a
    view of it in which each kernel named in ``hooks`` runs
    ``hooks[name](fn, args, kwargs)``, ``fn`` the kernel the view stands
    over; the kernels and their counts stay as they are. Views nest."""

    def __init__(self, module, hooks: dict):
        self.mod, self.hooks = module, hooks

    def __enter__(self):
        real = self.real = self.mod.kernels
        hooks = self.hooks

        def shim(name):
            return lambda *args, **kwargs: hooks[name](
                getattr(real, name), args, kwargs)

        shims = {name: shim(name) for name in hooks}

        class View:
            def __getattr__(self, attr):
                return shims[attr] if attr in shims else getattr(real, attr)

        self.mod.kernels = View()
        return self

    def __exit__(self, *exc):
        self.mod.kernels = self.real
        return False


class FirstCall(KernelView):
    """While installed, captures (as clones) the arguments of the first
    call that ``module`` makes to the fixpoint kernel ``name`` and that
    ``want(args, kwargs)`` accepts; every call goes through to the
    kernel."""

    def __init__(self, torch, module, name: str,
                 want=lambda args, kwargs: True):
        self.torch, self.want = torch, want
        self.args = self.kwargs = None
        super().__init__(module, {name: self._call})

    def _clone(self, x):
        return x.clone() if isinstance(x, self.torch.Tensor) else x

    def _call(self, fn, args, kwargs):
        if self.args is None and self.want(args, kwargs):
            self.args = tuple(self._clone(a) for a in args)
            self.kwargs = {k: self._clone(v) for k, v in kwargs.items()}
        return fn(*args, **kwargs)


class MetLog(KernelView):
    """While installed, keeps the ``met`` tensor of every call that
    ``ops/parity_unionfind.py`` makes to the parity kernels on the card
    (a union's rounds, a close's longest walk), read once the run is
    over; the union's own jump is not a call of the module's."""

    NAMES = ("union_edges_parity", "pointer_jump_parity")

    def __init__(self, torch, module):
        self.torch = torch
        self.mets = {name: [] for name in self.NAMES}
        super().__init__(module, {
            name: functools.partial(self._call, name) for name in self.NAMES})

    def _call(self, name, fn, args, kwargs):
        from gelly_torch.ops import kernels

        out = fn(*args, **kwargs)
        if self.launched(args):
            # The kernel's own attribute: ``fn`` may be an outer view's.
            self.mets[name].append(getattr(kernels, name).met)
        return out

    @staticmethod
    def launched(args) -> bool:
        """Did the call launch a kernel (and set its ``met``)?"""
        return args[0].device.type == "cuda"

    def summary(self) -> dict:
        """Per kernel: its calls, and the sum, least and most of what
        they met."""
        out = {}
        for name, mets in self.mets.items():
            vals = self.torch.cat(mets).tolist() if mets else []
            out[name] = {"calls": len(vals), "sum": sum(vals),
                         "min": min(vals, default=0),
                         "max": max(vals, default=0)}
        return out


def walk(torch, p, x):
    """``(roots, reads)``: each lane of ``x`` walked to its root in the
    forest ``p``, and the forest reads the walk takes (its depth plus the
    read that finds the root)."""
    reads = torch.ones(x.shape[0], dtype=torch.int64, device=x.device)
    cur, g = x, p[x]
    while True:
        moving = g != cur
        if not bool(moving.any()):
            return cur, reads
        reads += moving
        cur, g = g, p[g]


def fixpoint_bytes(torch, name: str, args, kwargs) -> int:
    """The bytes the fixpoint ``name`` must move on these inputs, replayed
    round by round with plain tensor ops: each lane's pair once, each hop
    of each chase once a round, each hook written once, the forest read
    and the new forest written once (union_edges: each round's two
    reads a lane and its doubling step over every slot, then the jump)."""
    from gelly_torch.ops.segments import masked_scatter_min

    p = args[0]
    n = p.shape[0]
    if name == "pointer_jump":
        ident = torch.arange(n, dtype=torch.int32, device=p.device)
        return int(4 * walk(torch, p, ident)[1].sum()) + 4 * n
    x, y = args[1], args[2]
    valid = args[3] if len(args) > 3 else kwargs.get("valid")
    act = (torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
           if valid is None else valid)
    lanes = x.shape[0]
    total = 8 * n + 9 * lanes
    if name == "union_edges":
        r = p
        while True:
            lu, lv = r[x], r[y]
            lo, hi = torch.minimum(lu, lv), torch.maximum(lu, lv)
            live = act & (lo != hi)
            b = masked_scatter_min(r, hi, lo, live)
            b = b[b]
            total += int(8 * act.sum() + 4 * live.sum()) + 12 * n
            if torch.equal(b, r):
                return total + 8 * n  # the jump over a flat forest
            r = b
    star = kwargs.get("star", False)
    gate, n_valid = kwargs.get("gate"), kwargs.get("n_valid")
    if gate is not None and not bool(gate):
        return total
    if n_valid is not None:
        act = act & (torch.arange(lanes, device=x.device) < n_valid)
    while True:
        ru, reads = walk(torch, p, x)
        if star:
            rv = ru[y]
            total += int(4 * reads.sum())
        else:
            rv, reads_y = walk(torch, p, y)
            total += int(4 * (reads + reads_y)[act].sum())
        lo, hi = torch.minimum(ru, rv), torch.maximum(ru, rv)
        live = act & (lo != hi)
        total += int(4 * live.sum())
        if not bool(live.any()):
            return total
        p = masked_scatter_min(p, hi, lo, live)


def parity_fixpoint_bytes(torch, name: str, args, kwargs) -> int:
    """The bytes the parity kernel ``name`` must move on these inputs,
    replayed round by round with plain tensor ops. pointer_jump_parity:
    each read of each slot's walk, the slot's own word included (parent
    and rel, 8 B), and the new forest written once (8 B a slot).
    union_edges_parity: the forest (parent and rel) read once and the new
    one written once, each lane's u, v, q and valid once, each round's
    two word reads a valid lane, a hook a live lane and its doubling step
    over every slot (the scatter target's word, the word it points at,
    the new word written), then the jump's walks over the packed words
    (4 B a read)."""
    from gelly_torch.ops.segments import masked_scatter_min

    p, r = args[0], args[1]
    n = p.shape[0]
    ident = torch.arange(n, dtype=torch.int32, device=p.device)
    if name == "pointer_jump_parity":
        return int(8 * walk(torch, p, ident)[1].sum()) + 8 * n
    u, v, q = args[3], args[4], args[5]
    valid = args[6] if len(args) > 6 else kwargs.get("valid")
    act = (torch.ones(u.shape[0], dtype=torch.bool, device=u.device)
           if valid is None else valid)
    total = 16 * n + 13 * u.shape[0]
    w = p * 2 + r
    while True:
        wu, wv = w[u], w[v]
        lu, lv = wu >> 1, wv >> 1
        live = act & (lu != lv)
        link = (wu & 1) ^ (wv & 1) ^ q
        b = masked_scatter_min(w, torch.maximum(lu, lv),
                               torch.minimum(lu, lv) * 2 + link, live)
        sp = b[b >> 1]
        nw = (sp >> 1) * 2 + ((b ^ sp) & 1)
        total += int(8 * act.sum() + 4 * live.sum()) + 12 * n
        if torch.equal(nw, w):
            break
        w = nw
    return total + int(4 * walk(torch, w >> 1, ident)[1].sum())


def fixpoint_phase(torch, device, name: str, call: FirstCall, where: str,
                   reps: int = REPS, open_gate: bool = False) -> dict:
    """One fixpoint kernel on inputs captured from a path: equal to its
    plain version (rounds met included), timed (CUDA events, L2 flushed,
    mean of ``reps``) beside its plain version and the least time the
    card could take for the bytes it must move. ``open_gate``: the same
    inputs with the gate taken away (a fixpoint whose gate was closed)."""
    from gelly_torch.ops import kernels

    check(call.args is not None, f"{where}: no {name} call was captured")
    fn, plain = getattr(kernels, name), getattr(kernels, name + "_plain")
    args, kwargs = call.args, dict(call.kwargs)
    if open_gate:
        kwargs.pop("gate", None)
        where += ", gate open"
    got = fn(*args, **kwargs)
    met = int(fn.met)
    want = plain(*args, **kwargs)
    rounds = plain.rounds
    torch.cuda.synchronize()
    # The parity kernels return (parent, rel[, failed]).
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max((int((a.long() - b.long()).abs().max()) if a.numel() else 0)
              for a, b in zip(got, want))
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"{name} on {where} != its plain version (max abs err {err})")
    if name in ("pointer_jump", "pointer_jump_parity"):
        check(rounds == (0 if met <= 1 else (met - 1).bit_length()),
              f"{name} on {where}: longest walk {met} hops, but the plain "
              f"loop took {rounds} doubling rounds")
    else:
        check(met == rounds, f"{name} on {where}: {met} rounds met, the "
                             f"plain loop {rounds}")
    ms = time_ms(torch, lambda: fn(*args, **kwargs), device, reps=reps)
    plain_ms = time_ms(torch, lambda: plain(*args, **kwargs), device,
                       reps=max(3, reps // 4), warmup=1)
    parity = name.endswith("_parity")
    nbytes = (parity_fixpoint_bytes if parity else fixpoint_bytes)(
        torch, name, args, kwargs)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    first_lane = 3 if parity else 1
    lanes = args[first_lane].shape[0] if len(args) > first_lane else 0
    print(f"kernel {name} on {where}: slots={args[0].shape[0]} "
          f"lanes={lanes} exact=True rounds_met={met} "
          f"(plain {rounds}) kernel_ms={ms:.6f} plain_ms={plain_ms:.6f} "
          f"bound_ms={bound_ms:.6f} ({nbytes} B / {HBM_BYTES_PER_S:.4g})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_bytes": nbytes, "rounds_met": met, "plain_rounds": rounds,
            "max_abs_err": err, "timed_on": where}


def scipy_oracle(src: np.ndarray, dst: np.ndarray, n: int) -> np.ndarray:
    """Canonical labels: minimum slot per component, -1 for unseen slots."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    g = coo_matrix((np.ones(src.shape[0], np.float32), (src, dst)),
                   shape=(n, n)).tocsr()
    _, comp = connected_components(g, directed=False)
    _, first = np.unique(comp, return_index=True)  # first slot = min slot
    seen = np.zeros(n, bool)
    seen[src] = True
    seen[dst] = True
    return np.where(seen, first[comp], -1).astype(np.int32)


def window_edges(torch, src, dst, w: int, device):
    """The window's simple undirected edges ``(a, b)``, ``a < b``, on the
    card (ts = arange, so window ``w`` is one contiguous range)."""
    lo, hi = w * TRI_WINDOW_MS, (w + 1) * TRI_WINDOW_MS
    s = torch.from_numpy(src[lo:hi]).to(device).long()
    d = torch.from_numpy(dst[lo:hi]).to(device).long()
    a, b = torch.minimum(s, d), torch.maximum(s, d)
    key = torch.unique((a * TRI_N + b)[a != b])
    return key // TRI_N, key % TRI_N


def triangle_oracle(torch, a, b, device) -> int:
    """Triangles of a simple undirected graph: ``trace(A³) / 6`` taken as
    ``((A @ A) * A).sum() / 6`` over the f32 adjacency (exact: the path
    counts are integers below 2^24, the sum is taken in f64)."""
    adj = torch.zeros((TRI_N, TRI_N), dtype=torch.float32, device=device)
    adj[a, b] = 1.0
    adj[b, a] = 1.0
    paths = adj @ adj
    paths.mul_(adj)
    six = float(paths.sum(dtype=torch.float64))
    del adj, paths
    check(six % 6 == 0, f"oracle sum {six} is not a multiple of 6")
    return int(six) // 6


def union_length(spans) -> float:
    """Length of the union of sorted ``(start, end)`` intervals."""
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    return busy + hi - lo


def library_yardstick(torch, m, want, device):
    """(name, ms, lines) of the fastest exact single PyTorch call for
    ``MᵀM`` among ``torch._int_mm`` on int8 copies (exact int32) and an f32
    matmul with TF32 allowed (exact for 0/1). Each candidate is checked
    against ``want``, then timed like the kernel; ``lines`` reports every
    candidate."""
    mi8 = m.to(torch.int8)
    mi8t = mi8.t().contiguous()
    mf = m.to(torch.float32)
    mft = mf.t().contiguous()

    def tf32_mm():
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return torch.matmul(mft, mf)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    candidates = [
        ("torch._int_mm(int8 M.t(), int8 M)",
         lambda: torch._int_mm(mi8t, mi8)),
        ("torch.matmul(f32 M.t(), f32 M) with TF32", tf32_mm),
    ]
    lines = []
    best = None
    for name, fn in candidates:
        try:
            exact = torch.equal(fn().to(torch.float32), want)
            torch.cuda.synchronize()
        except RuntimeError as e:
            lines.append(f"{name}: refused ({str(e).splitlines()[0]})")
            continue
        if not exact:
            lines.append(f"{name}: result differs, not timed")
            continue
        ms = time_ms(torch, fn, device, reps=WEDGE_REPS, warmup=1)
        lines.append(f"{name}: exact, {ms:.6f} ms")
        if best is None or ms < best[1]:
            best = (name, ms)
    check(best is not None, f"no exact library call for MᵀM: {lines}")
    return best[0], best[1], lines


def filesystem_of(path: str) -> str:
    """The ``/proc/mounts`` line of the filesystem holding ``path``, with
    its block size and free bytes (``os.statvfs``)."""
    real = os.path.realpath(path)
    best = ""
    try:
        with open("/proc/mounts") as f:
            for line in f:
                mnt = line.split()[1]
                if (real == mnt or real.startswith(mnt.rstrip("/") + "/")) \
                        and len(mnt) > len(best.split()[1] if best else ""):
                    best = line.strip()
    except OSError:
        best = "/proc/mounts unreadable"
    st = os.statvfs(path)
    return (f"{best} (bsize={st.f_bsize}, free={st.f_bavail * st.f_frsize}"
            f" B)")


def count_folds(agg):
    """Wrap ``agg.fold_compressed`` with a call counter; returns the
    wrapped fold's name and the one-element count."""
    fold = agg.fold_compressed
    calls = [0]

    def counted(summary, payload):
        calls[0] += 1
        return fold(summary, payload)

    agg.fold_compressed = counted
    return fold.__name__, calls


def check_durable_wire(agg, folds, units: int, what: str) -> None:
    """A durable compact phase ran what it claims: the segments wire, one
    ``fold_segments`` a unit, and the native codec never disabled."""
    from gelly_torch.utils import native

    name, calls = folds
    check(agg.wire == "segments" and name == "fold_segments",
          f"{what}: took the {agg.wire} wire ({name}), not segments")
    check(calls[0] == units and units > 0,
          f"{what}: {calls[0]} fold_segments calls for {units} units")
    check(native.disabled_reason("chunk_combiner") is None,
          f"{what}: the native codec was disabled "
          f"({native.disabled_reason('chunk_combiner')})")


def durable_compact_phase(torch, compact_plan, run, report, plain_labels,
                          plain_walls) -> None:
    """Phase A: phase 7's compact path with a checkpoint every window, then
    a stop after the 3rd emission and an in-process resume."""
    from gelly_torch.engine.checkpoint import read_checkpoint_header

    tmp = tempfile.mkdtemp(prefix="gelly-durable-")
    try:
        path = os.path.join(tmp, "ck.npz")
        print(f"phase A checkpoint dir {tmp}: {filesystem_of(tmp)}")
        knobs = {"checkpoint_path": path, "checkpoint_every": 1}
        n_windows = len(plain_labels)
        for i in range(2):
            agg = compact_plan()
            folds = count_folds(agg)
            got, st = run(agg, CC_EDGES, **knobs)
            report(f"phase A durable compact run {i + 1}", st, CC_EDGES, agg)
            check_durable_wire(agg, folds, st["units"], "phase A")
            check(st["launches"] == NO_LAUNCHES,
                  "phase A: the compact path launched a kernel")
            n_ck = st["stats"]["checkpoints"]
            ck_bytes = st["stats"]["checkpoint_bytes"]
            check(n_ck == n_windows, f"phase A: {n_ck} checkpoints, not "
                  f"{n_windows}")
            check(len(got) == n_windows and all(
                np.array_equal(a, b) for a, b in zip(got, plain_labels)),
                "phase A: a durable emission differs from the plain run's")
            print(f"phase A run {i + 1}: wall={st['wall_s']:.4f} s "
                  f"({st['edges_per_s']:.1f} edges/s) against the plain "
                  f"walls {', '.join(f'{w:.4f}' for w in plain_walls)} s; "
                  f"checkpoint busy={st['busy']['checkpoint']:.4f} s "
                  f"({st['busy']['checkpoint'] / n_ck:.4f} s a window), "
                  f"{n_ck} checkpoints of {ck_bytes // n_ck} bytes")
        header = read_checkpoint_header(path)
        n_chunks = CC_EDGES // CC_CHUNK
        check(header["position"] == n_chunks
              and header["meta"]["windows"] == n_windows,
              f"phase A: last checkpoint header {header['position']} "
              f"{header['meta']}")
        checkpoint_parts(torch, compact_plan(), path, tmp)

        # A consumer that stops after the 3rd emission leaves the window-2
        # checkpoint; a fresh plan (a new id session) resumes from it.
        got, st = run(compact_plan(), CC_EDGES, stop_after=3, **knobs)
        check(len(got) == 3, f"phase A: the stopped run gave {len(got)}")
        header = read_checkpoint_header(path)
        want_pos = 2 * CC_MERGE_EVERY
        check(header["position"] == want_pos
              and header["meta"]["windows"] == 2,
              f"phase A: after the stop the checkpoint is at "
              f"{header['position']} {header['meta']}, not {want_pos}")
        agg = compact_plan()
        folds = count_folds(agg)
        got, st = run(agg, CC_EDGES, resume=True, **knobs)
        report("phase A resumed run", st, CC_EDGES, agg)
        check_durable_wire(agg, folds, st["units"], "phase A resume")
        check(st["stats"]["resumed_at"] == want_pos,
              f"phase A: resumed at {st['stats']['resumed_at']}")
        check(len(got) == n_windows - 2 and all(
            np.array_equal(a, b) for a, b in zip(got, plain_labels[2:])),
            "phase A: the resumed windows differ from the plain run's")
        busy = st["busy"]
        print(f"phase A resume at position {want_pos}: "
              f"load={busy['resume_load']:.4f} s "
              f"on_resume={busy['on_resume']:.4f} s "
              f"skip={busy['resume_skip']:.4f} s; time to recover (call "
              f"to first emission) {st['first_emission_s']:.4f} s; "
              f"{len(got)} emissions equal windows 3-{n_windows}; "
              f"wall={st['wall_s']:.4f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def checkpoint_parts(torch, agg, path: str, tmp: str) -> None:
    """Where a compact checkpoint's seconds go: the last checkpoint loaded
    onto the card, then its pull to the host, the CRC of its leaves, a
    write without ``fsync`` and one with it (each timed once)."""
    import zlib

    from gelly_torch.engine import checkpoint as ck

    summary, _, _ = ck.load_checkpoint(
        path, like=agg.init(torch.device("cuda", 0)))
    torch.cuda.synchronize()
    t = time.perf_counter()
    host = ck.tree_map(ck.to_host, summary)
    pull = time.perf_counter() - t
    t = time.perf_counter()
    for leaf in ck.tree_flatten(host)[0]:
        zlib.crc32(np.ascontiguousarray(leaf).tobytes())
    crc = time.perf_counter() - t
    nbytes = sum(leaf.nbytes for leaf in ck.tree_flatten(host)[0])
    times = []
    for fsync in (False, True):
        t = time.perf_counter()
        ck.save_checkpoint(os.path.join(tmp, f"parts-{fsync}.npz"), summary,
                           fsync=fsync)
        times.append(time.perf_counter() - t)
    print(f"phase A checkpoint parts ({nbytes} B): pull={pull:.4f} s "
          f"crc32={crc:.4f} s save without fsync={times[0]:.4f} s "
          f"save with fsync={times[1]:.4f} s")


def kill_stream_run(torch, device, src, dst, path=None, resume=False,
                    sleep_s=0.0):
    """Phase B's compact run over phase 4's stream: ``(emissions on the
    host, the SummaryStream, the plan, its fold count, (seconds from the
    call to the first emission, its ``time.time()``))``."""
    from gelly_torch.core.io import EdgeChunkSource
    from gelly_torch.core.stream import edge_stream_from_source
    from gelly_torch.core.vertices import IdentityVertexTable
    from gelly_torch.library import connected_components as cc

    agg = cc.connected_components(N_VERTICES, merge="gather",
                                  codec="compact", compact_capacity=CC_COMPACT)
    folds = count_folds(agg)
    if sleep_s:
        fold = agg.fold_compressed

        def slow(summary, payload):
            time.sleep(sleep_s)
            return fold(summary, payload)

        agg.fold_compressed = slow
    stream = edge_stream_from_source(
        EdgeChunkSource(src, dst, chunk_size=CC_CHUNK,
                        table=IdentityVertexTable(N_VERTICES)),
        N_VERTICES, device=device)
    knobs = ({"checkpoint_path": path, "checkpoint_every": 1,
              "resume": resume} if path else {})
    t = time.perf_counter()
    res = stream.aggregate(agg, merge_every=KILL_MERGE_EVERY,
                           fold_batch=KILL_FOLD_BATCH, **knobs)
    out, first = [], None
    for x in res:
        if first is None:
            first = (time.perf_counter() - t, time.time())
        out.append(x.cpu().numpy())
    return out, res, agg, folds, first


def durable_child(directory: str) -> int:
    """Phase B's child: the compact run over the stream in ``directory``,
    checkpointing every window to ``directory/ck.npz`` (resuming when it
    exists); writes its final labels with ``save_checkpoint`` and prints
    its parts as one JSON line."""
    import torch

    with open(os.path.join(directory, "run.json")) as f:
        cfg = json.load(f)
    torch.cuda.init()
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)
    torch.cuda.synchronize()
    t_cuda = time.time()
    from gelly_torch.engine.checkpoint import save_checkpoint

    src = np.load(os.path.join(directory, "src.npy"))
    dst = np.load(os.path.join(directory, "dst.npy"))
    t_data = time.time()
    path = os.path.join(directory, "ck.npz")
    resume = os.path.exists(path)
    out, res, agg, folds, (first_s, first_at) = kill_stream_run(
        torch, device, src, dst, path=path, resume=resume,
        sleep_s=cfg["sleep_s"])
    check_durable_wire(agg, folds, res.stats["units"], "phase B child")
    busy = res.timer.busy()
    parts = {
        "resumed_at": res.stats["resumed_at"],
        "emissions": len(out),
        "spawn_to_cuda_s": t_cuda - cfg["spawned_at"],
        "data_load_s": t_data - t_cuda,
        "resume_load_s": busy.get("resume_load"),
        "on_resume_s": busy.get("on_resume"),
        "resume_skip_s": busy.get("resume_skip"),
        "call_to_first_emission_s": first_s,
        "spawn_to_first_emission_s": first_at - cfg["spawned_at"],
        "checkpoint_busy_s": busy.get("checkpoint"),
    }
    save_checkpoint(os.path.join(directory, "final.npz"),
                    {"labels": out[-1]}, position=res.stats["chunks"],
                    meta=parts)
    print(json.dumps({"durable_child": parts}))
    return 0


def kill9_phase(torch, device, src, dst, oracle) -> None:
    """Phase B: a child checkpointing the compact run is killed with
    SIGKILL once the window-2 checkpoint is on disk; a second child
    resumes, and its final labels must equal the uninterrupted run's and
    scipy's."""
    from gelly_torch.engine.checkpoint import (
        CheckpointCorruptError,
        load_checkpoint,
        read_checkpoint_header,
    )

    tmp = tempfile.mkdtemp(prefix="gelly-kill9-")
    here = os.path.abspath(__file__)
    procs = []

    def spawn(sleep_s, name):
        with open(os.path.join(tmp, "run.json"), "w") as f:
            json.dump({"sleep_s": sleep_s, "spawned_at": time.time()}, f)
        log = open(os.path.join(tmp, f"{name}.log"), "w")
        p = subprocess.Popen([sys.executable, here, "--durable-child", tmp],
                             stdout=log, stderr=subprocess.STDOUT)
        log.close()
        procs.append(p)
        return p

    def tail(name):
        with open(os.path.join(tmp, f"{name}.log")) as f:
            return f.read()[-3000:]

    try:
        t0 = time.perf_counter()
        np.save(os.path.join(tmp, "src.npy"), src)
        np.save(os.path.join(tmp, "dst.npy"), dst)
        print(f"phase B stream written in {time.perf_counter() - t0:.2f} s "
              f"to {tmp}: {filesystem_of(tmp)}")
        ref, res, agg, folds, _ = kill_stream_run(torch, device, src, dst)
        check_durable_wire(agg, folds, res.stats["units"], "phase B")
        n_windows = N_EDGES // (KILL_MERGE_EVERY * CC_CHUNK)
        check(len(ref) == n_windows and np.array_equal(ref[-1], oracle),
              "phase B: the uninterrupted run != scipy")

        p = spawn(KILL_UNIT_SLEEP_S, "killed")
        deadline = time.monotonic() + CHILD_TIMEOUT_S
        header = None
        while time.monotonic() < deadline:
            check(p.poll() is None, f"phase B: the child exited "
                  f"(rc={p.returncode}) before the kill: {tail('killed')}")
            try:
                header = read_checkpoint_header(os.path.join(tmp, "ck.npz"))
            except (FileNotFoundError, CheckpointCorruptError):
                header = None
            if header is not None and \
                    header["meta"]["windows"] >= KILL_AT_WINDOWS:
                break
            time.sleep(0.02)
        check(header is not None
              and header["meta"]["windows"] >= KILL_AT_WINDOWS,
              "phase B: no window-2 checkpoint before the deadline")
        os.kill(p.pid, signal.SIGKILL)
        check(p.wait(timeout=60) == -signal.SIGKILL,
              f"phase B: the child ended with {p.returncode}")
        check(not os.path.exists(os.path.join(tmp, "final.npz")),
              "phase B: the killed child finished its stream")
        killed_at = read_checkpoint_header(
            os.path.join(tmp, "ck.npz"))["position"]

        p = spawn(0.0, "resumed")
        rc = p.wait(timeout=CHILD_TIMEOUT_S)
        check(rc == 0, f"phase B: the resumed child failed (rc={rc}): "
              f"{tail('resumed')}")
        final, pos, parts = load_checkpoint(os.path.join(tmp, "final.npz"))
        min_pos = KILL_AT_WINDOWS * KILL_MERGE_EVERY
        check(parts["resumed_at"] is not None
              and parts["resumed_at"] >= min_pos
              and parts["resumed_at"] == killed_at,
              f"phase B: resumed at {parts['resumed_at']} (checkpoint at "
              f"the kill: {killed_at}, want >= {min_pos})")
        check(pos == N_EDGES // CC_CHUNK, f"phase B: final position {pos}")
        check(np.array_equal(final[0], ref[-1])
              and np.array_equal(final[0], oracle),
              "phase B: the resumed child's labels != the uninterrupted "
              "run's / scipy's")
        print(f"phase B kill -9 at checkpoint position {killed_at} "
              f"(windows {header['meta']['windows']}); resumed child: "
              f"{parts['emissions']} emissions, final labels equal the "
              f"uninterrupted run's and scipy's")
        print(f"phase B time to recover (spawn to first emission) "
              f"{parts['spawn_to_first_emission_s']:.4f} s: spawn to CUDA "
              f"ready {parts['spawn_to_cuda_s']:.4f} s, stream load "
              f"{parts['data_load_s']:.4f} s, checkpoint load "
              f"{parts['resume_load_s']:.4f} s, on_resume "
              f"{parts['on_resume_s']:.4f} s, skip "
              f"{parts['resume_skip_s']:.4f} s, call to first emission "
              f"{parts['call_to_first_emission_s']:.4f} s; checkpoint busy "
              f"{parts['checkpoint_busy_s']:.4f} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def resilient_plan(torch, device, src, dst):
    """Phase C's raw kernel plan: ``(agg, stream(), stage)``."""
    from gelly_torch.core.io import EdgeChunkSource
    from gelly_torch.core.stream import edge_stream_from_source
    from gelly_torch.core.vertices import IdentityVertexTable
    from gelly_torch.library import connected_components as cc

    agg = cc.connected_components(N_VERTICES, merge="gather",
                                  ingest_combine=False, fold_backend="kernel")

    def stream():
        return edge_stream_from_source(
            EdgeChunkSource(src, dst, chunk_size=CHUNK,
                            table=IdentityVertexTable(N_VERTICES)),
            N_VERTICES, device=device)

    def stage(c):  # the fields the raw fold reads, as the engine copies
        return c._replace(**{
            f: getattr(c, f).pin_memory().to(device, non_blocking=True)
            for f in agg.device_fields})

    return agg, stream, stage


def resilient_run(torch, device, src, dst, tmp: str):
    """One ``ResilientRunner`` run of phase C's plan into checkpoint
    directory ``tmp``, under a ``FaultPlan`` raising once at ``step`` and
    once at ``checkpoint_write``, its launch counts set to 0 just before
    it: ``(runner, final state, plan, wall_s, gather launches)``."""
    from gelly_torch.engine import faults
    from gelly_torch.engine.resilience import (
        ResilienceConfig,
        ResilientRunner,
        RetryPolicy,
    )
    from gelly_torch.ops import kernels

    agg, stream, stage = resilient_plan(torch, device, src, dst)
    plan = faults.FaultPlan([faults.Fault("step", at=5),
                             faults.Fault("checkpoint_write", at=1)])
    torch.cuda.synchronize()
    reset_launches(kernels)
    t = time.perf_counter()
    with faults.install(plan):
        runner = ResilientRunner(
            lambda s, c: (agg.fold(s, c), None), stream(),
            lambda: agg.init(device), checkpoint_dir=tmp, stage=stage,
            config=ResilienceConfig(
                checkpoint_every_chunks=RESILIENT_EVERY,
                retry=RetryPolicy(base_delay=0.01)))
        final = runner.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return runner, final, plan, wall, kernels.sorted_window_gather.launches


def resilient_raw_phase(torch, device, src, dst, plain_last,
                        path_wall) -> dict:
    """Phase C: ``ResilientRunner`` over phase 4's raw stream with the
    kernel backend, a checkpoint every 4 chunks and two injected faults;
    returns the gather's launches in the run and the final forest on the
    host (``parent``, ``seen``)."""
    from gelly_torch.ops import unionfind
    from gelly_torch.utils import native

    agg, stream, stage = resilient_plan(torch, device, src, dst)
    ref = agg.init(device)
    for c in stream():
        ref = agg.fold(ref, stage(c))
    check(np.array_equal(unionfind.component_labels(
        ref.parent, ref.seen).cpu().numpy(), plain_last),
        "phase C: the plain chunk loop != phase 4's last emission")
    tmp = tempfile.mkdtemp(prefix="gelly-resilient-")
    try:
        runner, final, plan, wall, launches = resilient_run(
            torch, device, src, dst, tmp)
        st = runner.stats
        n_chunks = N_EDGES // CHUNK
        check(torch.equal(final.parent, ref.parent)
              and torch.equal(final.seen, ref.seen),
              "phase C: the resilient forest != the uninterrupted fold's")
        check(st["retries"] == 2 and len(plan.fired) == 2,
              f"phase C: {st['retries']} retries, fired {plan.fired}")
        check(launches > 0, "phase C: the gather never launched")
        check(st["checkpoints"] == n_chunks // RESILIENT_EVERY
              and st["checkpoint_writes"] == st["checkpoints"],
              f"phase C: {st['checkpoints']} checkpoints, "
              f"{st['checkpoint_writes']} written")
        check(final.parent.device == ref.parent.device,
              "phase C: the fold left the card")
        check(native.disabled_reason("chunk_combiner") is None,
              "phase C: the native codec was disabled")
        print(f"phase C resilient raw fold (fold_backend=kernel): "
              f"wall={wall:.4f} s ({N_EDGES / wall:.1f} edges/s) against "
              f"phase 4's {path_wall:.4f} s; retries={st['retries']} "
              f"(fired {plan.fired}), {st['checkpoints']} checkpoints of "
              f"{st['checkpoint_bytes'] // max(st['checkpoint_writes'], 1)}"
              f" bytes, last write {st['checkpoint_write_s']:.4f} s, "
              f"gather launches={launches}; forest bit-identical")
        return {"launches": launches, "parent": final.parent.cpu(),
                "seen": final.seen.cpu()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def compact_cc_phase(torch, device, src, dst, oracle) -> None:
    """Phase 7: the compact CC plan (bench_cc_large's call) over phase 4's
    stream, held to phase 4's scipy labels ``oracle``."""
    from gelly_torch.core.io import EdgeChunkSource
    from gelly_torch.core.stream import edge_stream_from_source
    from gelly_torch.core.vertices import IdentityVertexTable
    from gelly_torch.engine.aggregation import available_cores
    from gelly_torch.library import connected_components as cc
    from gelly_torch.ops import kernels, unionfind
    from gelly_torch.utils import native
    from gelly_torch.utils.prefetch import prefetch_map

    t0 = time.perf_counter()
    check(native.unit_segments_available(),
          "the native unit codec did not build or load")
    print(f"native chunk_combiner: g++ build and load "
          f"{time.perf_counter() - t0:.2f} s -> "
          f"{os.path.relpath(native.library_path('chunk_combiner'))}")

    def source(n_edges, chunk):
        return EdgeChunkSource(src[:n_edges], dst[:n_edges],
                               chunk_size=chunk,
                               table=IdentityVertexTable(N_VERTICES))

    def compact_plan():
        return cc.connected_components(
            N_VERTICES, merge="gather", codec="compact",
            compact_capacity=CC_COMPACT)

    def run(agg, n_edges, chunk=CC_CHUNK, merge_every=CC_MERGE_EVERY,
            fold_batch=CC_FOLD_BATCH, pull=True, stop_after=None, **knobs):
        stream = edge_stream_from_source(source(n_edges, chunk), N_VERTICES,
                                         device=device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        reset_launches(kernels)
        unionfind.host_sync.count = 0
        t = time.perf_counter()
        res = stream.aggregate(agg, merge_every=merge_every,
                               fold_batch=fold_batch, **knobs)
        out = []
        first_s = None
        for x in res:
            if first_s is None:
                first_s = time.perf_counter() - t
            out.append(x)
            if len(out) == stop_after:
                break
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        stats = {
            "wall_s": wall, "edges_per_s": n_edges / wall,
            "first_emission_s": first_s, "stats": dict(res.stats),
            "busy": res.timer.busy(), "units": res.stats["units"],
            "host_syncs": unionfind.host_sync.count,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(device),
            "wire_bytes": res.stats["h2d_bytes"],
            "launches": launch_counts(kernels),
            "fixpoints": fixpoint_counts(kernels),
        }
        return [x.cpu().numpy() for x in out] if pull else out, stats

    def report(name, st, n_edges, agg=None):
        busy = " ".join(f"{k}={v:.4f}" for k, v in sorted(st["busy"].items()))
        extra = (f" session.assigned={agg.session.assigned}"
                 if agg is not None and hasattr(agg, "session") else "")
        print(f"{name}: {st['edges_per_s']:.1f} edges/s "
              f"wall={st['wall_s']:.4f} s units={st['units']} "
              f"host_syncs/unit={st['host_syncs'] / max(st['units'], 1):.3f} "
              f"peak_mem={st['peak_mem_bytes']} B "
              f"wire_bytes/edge={st['wire_bytes'] / n_edges:.4f} "
              f"kernel launches={st['launches']} "
              f"fixpoint launches={st['fixpoints']}{extra}")
        print(f"  stage busy s: {busy}")

    agg = compact_plan()
    check(agg.wire == "segments"
          and agg.fold_compressed.__name__ == "fold_segments"
          and agg.stack_payloads.__name__ == "stack_segments",
          f"the compact plan took the {agg.wire} wire, not segments")
    workers = min(available_cores(), 8)
    print(f"compact plan: wire={agg.wire} fold={agg.fold_compressed.__name__}"
          f" codec_workers={workers} available_cores={available_cores()} "
          f"torch_threads={torch.get_num_threads()}")

    star = FirstCall(torch, unionfind, "rooted_fixpoint",
                     lambda args, kwargs: kwargs.get("star", False))
    with star:
        warm, st = run(compact_plan(), CC_FOLD_BATCH * CC_CHUNK)
    report("compact warm-up (16 chunks)", st, CC_FOLD_BATCH * CC_CHUNK)
    check(st["fixpoints"]["rooted_fixpoint"] > 0,
          "the compact warm-up launched no rooted_fixpoint")
    del warm
    star_check = fixpoint_phase(torch, device, "rooted_fixpoint", star,
                                "phase 7's first star call")
    star_check["launches"] = st["fixpoints"]["rooted_fixpoint"]
    star_check["open_gate"] = fixpoint_phase(
        torch, device, "rooted_fixpoint", star, "phase 7's first star call",
        open_gate=True)
    del star
    runs = []
    for i in range(2):
        labels, st = run(agg, CC_EDGES)
        report(f"compact path run {i + 1}", st, CC_EDGES, agg)
        check(st["launches"] == NO_LAUNCHES,
              "the compact path launched a kernel")
        runs.append((labels, st, agg.session.assigned))
    labels, st, assigned = runs[0]

    # Checks: the emissions, the raw plan at the same boundaries, scipy.
    n_windows = CC_EDGES // (CC_MERGE_EVERY * CC_CHUNK)
    check(len(labels) == n_windows, f"{len(labels)} compact emissions")
    for i, lab in enumerate(labels):
        check(lab.dtype == np.int32 and lab.shape == (N_VERTICES,),
              f"compact emission {i}: {lab.dtype} {lab.shape}")
        check(np.array_equal(lab, runs[1][0][i]),
              f"compact emission {i} differs between the two runs")
    raw, raw_st = run(
        cc.connected_components(N_VERTICES, merge="gather",
                                ingest_combine=False, fold_backend="plain"),
        CC_EDGES, chunk=CHUNK, merge_every=CC_RAW_MERGE_EVERY, fold_batch=1)
    report("raw plan at the same boundaries", raw_st, CC_EDGES)
    check(len(raw) == n_windows, f"{len(raw)} raw emissions")
    for i, (a, b) in enumerate(zip(labels, raw)):
        check(np.array_equal(a, b), f"compact emission {i} != raw plan's")
    del raw
    check(np.array_equal(labels[-1], oracle),
          "compact final labels != phase 4's scipy oracle")
    seen = int((labels[-1] >= 0).sum())
    check(assigned == seen,
          f"session.assigned {assigned} != {seen} seen slots")
    print(f"oracle: phase 4's scipy labels equal ({seen} seen slots = "
          f"session.assigned)")
    durable_compact_phase(torch, compact_plan, run, report, labels,
                          [r[1]["wall_s"] for r in runs])

    # The first window through the pairs wire and the sparse plan.
    pairs = cc.connected_components_compact(
        N_VERTICES, merge="gather", compact_capacity=CC_COMPACT,
        wire="pairs")
    check(pairs.fold_compressed.__name__ == "fold_compressed",
          "the pairs plan did not take the pairs fold")
    got, pst = run(pairs, CC_PREFIX)
    report("pairs wire, first window", pst, CC_PREFIX, pairs)
    check(len(got) == 1 and np.array_equal(got[0], labels[0]),
          "pairs wire != segments wire on the first window")
    sparse = cc.connected_components(N_VERTICES)
    check(sparse.codec_pad_values == {"v": -1, "r": 0},
          "connected_components(2^24) did not build the sparse plan")
    got, sst = run(sparse, CC_PREFIX)
    report("sparse plan (union_pairs_compact), first window", sst,
           CC_PREFIX)
    check(len(got) == 1 and np.array_equal(got[0], labels[0]),
          "sparse plan != compact plan on the first window")
    del got, labels, runs

    # The host codec alone: unit builder, id session and stacker, no device
    # (the timed runs' plan, so its id table is as warm as theirs).
    def codec_alone(n_workers):
        plan = agg
        plan.on_run_start()
        unit = CC_FOLD_BATCH

        def units():
            chunks = iter(source(CC_EDGES, CC_CHUNK))
            for seq in range(CC_EDGES // (unit * CC_CHUNK)):
                yield seq, [next(chunks) for _ in range(unit)]

        def stage(item):
            seq, group = item
            payloads = [plan.host_compress(c) for c in group]
            stacked = plan.stack_payloads(payloads, 1, seq=seq)
            return sum(a.nbytes for a in stacked.values())

        t = time.perf_counter()
        wire = sum(prefetch_map(stage, units(), depth=max(2, n_workers),
                                workers=n_workers))
        return time.perf_counter() - t, wire

    # The pipeline's worker count only (the 1-worker run, ~16 s, was cut
    # to fit phases H and I in the time limit; PERF.md keeps its values).
    for n_workers in (workers,):
        dt, wire = codec_alone(n_workers)
        print(f"host codec alone, {n_workers} worker(s): "
              f"{CC_EDGES / dt:.1f} edges/s wall={dt:.4f} s "
              f"wire_bytes/edge={wire / CC_EDGES:.4f} "
              f"(share of run 1's wall: {dt / st['wall_s']:.4f})")
    return star_check



def drive(torch, device, agg, source, n, n_events, merge_every, fold_batch,
          pull, stop_after=None, **knobs):
    """One run of ``agg`` over ``source`` on the card, with the hand
    kernels' launch counts and the host-sync count set to 0 just before
    it: ``(emissions, stats)``, the emissions pulled to the host with
    ``pull`` after the timed run (left on the card when ``pull`` is None).
    The wall ends when the last emission is ready on the card."""
    from gelly_torch.core.stream import edge_stream_from_source
    from gelly_torch.ops import kernels, unionfind

    stream = edge_stream_from_source(source, n, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches(kernels)
    unionfind.host_sync.count = 0
    t = time.perf_counter()
    res = stream.aggregate(agg, merge_every=merge_every,
                           fold_batch=fold_batch, **knobs)
    out, first_s = [], None
    for x in res:
        if first_s is None:
            first_s = time.perf_counter() - t
        out.append(x)
        if len(out) == stop_after:
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    stats = {
        "wall_s": wall, "events_per_s": n_events / wall,
        "first_emission_s": first_s, "stats": dict(res.stats),
        "busy": res.timer.busy(), "units": res.stats["units"],
        "host_syncs": unionfind.host_sync.count,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(device),
        "h2d_bytes": res.stats["h2d_bytes"],
        "launches": launch_counts(kernels),
        "fixpoints": fixpoint_counts(kernels),
    }
    return ([pull(x) for x in out] if pull else out), stats


def report_run(name: str, st: dict, rate: str = "edges",
               expect: dict | None = None) -> None:
    """A timed run's line, and the launch check: each kernel named in
    ``expect`` launched exactly that many times, every other hand kernel
    never."""
    busy = " ".join(f"{k}={v:.4f}" for k, v in sorted(st["busy"].items()))
    counts = dict(zip(HAND_KERNELS, st["launches"]))
    print(f"{name}: {st['events_per_s']:.1f} {rate}/s "
          f"wall={st['wall_s']:.4f} s units={st['units']} "
          f"host_syncs/unit={st['host_syncs'] / max(st['units'], 1):.3f} "
          f"peak_mem={st['peak_mem_bytes']} B h2d_bytes={st['h2d_bytes']} "
          f"kernel launches={ {k: v for k, v in counts.items() if v} }")
    print(f"  stage busy s: {busy}")
    expect = expect or {}
    for k, v in counts.items():
        check(v == expect.get(k, 0), f"{name}: {k} launched {v} times, "
                                     f"expected {expect.get(k, 0)}")


def check_native_codecs(what: str) -> None:
    from gelly_torch.utils import native

    check(native.disabled_reason("chunk_combiner") is None,
          f"{what}: the native codec was disabled "
          f"({native.disabled_reason('chunk_combiner')})")


def stop_and_resume(make_run, full, n_windows, merge_every, what):
    """A checkpointed run that stops after the 3rd emission (the window-2
    checkpoint stays on disk), then a fresh plan resuming from it: its
    emissions must equal ``full[2:]``. ``make_run(**knobs)`` runs the path
    and returns ``(emissions, stats)``."""
    from gelly_torch.engine.checkpoint import read_checkpoint_header

    tmp = tempfile.mkdtemp(prefix="gelly-de-")
    try:
        path = os.path.join(tmp, "ck.npz")
        knobs = {"checkpoint_path": path, "checkpoint_every": 1}
        got, st = make_run(stop_after=3, **knobs)
        check(len(got) == 3, f"{what}: the stopped run gave {len(got)}")
        header = read_checkpoint_header(path)
        check(header["position"] == 2 * merge_every
              and header["meta"]["windows"] == 2,
              f"{what}: after the stop the checkpoint is at "
              f"{header['position']} {header['meta']}")
        got, st = make_run(resume=True, **knobs)
        check(st["stats"]["resumed_at"] == 2 * merge_every,
              f"{what}: resumed at {st['stats']['resumed_at']}")
        check(len(got) == n_windows - 2
              and all(same(a, b) for a, b in zip(got, full[2:])),
              f"{what}: the resumed emissions differ from the "
              "uninterrupted run's")
        busy = st["busy"]
        print(f"{what} resume at position {2 * merge_every}: "
              f"load={busy['resume_load']:.4f} s "
              f"skip={busy['resume_skip']:.4f} s, checkpoint "
              f"{os.path.getsize(path)} B, call to first emission "
              f"{st['first_emission_s']:.4f} s; {len(got)} emissions equal "
              f"windows 3-{n_windows}; wall={st['wall_s']:.4f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def same(a, b) -> bool:
    """Equal emissions: arrays, or tuples of arrays, dtype included."""
    if isinstance(a, tuple):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def signed_degrees(src, dst, sign: int, n: int) -> np.ndarray:
    """``sign`` times the ``int64`` endpoint counts of one chunk."""
    return sign * (np.bincount(src, minlength=n)
                   + np.bincount(dst, minlength=n)).astype(np.int64)


def degrees_phase(torch, device, src, dst) -> None:
    """Phase D: the degree aggregate at BASELINE #1's size (D1), fully
    dynamic at Twitter scale (D2) and the stream API on D2's stream
    (D3)."""
    from gelly_torch.core.io import EdgeChunkSource, read_edge_list
    from gelly_torch.core.stream import edge_stream_from_source
    from gelly_torch.core.vertices import IdentityVertexTable
    from gelly_torch.library import degrees as deg
    from gelly_torch.ops import unionfind
    from gelly_torch.utils import native

    check(native.degree_deltas_available()
          and native.degree_sparse_available(),
          "the native degree codecs did not build or load")
    here = os.path.dirname(os.path.abspath(__file__))
    pull = lambda x: x.cpu().numpy()  # noqa: E731

    # D1: bench.py:bench_degrees' call on the ego-Facebook-shaped fixture.
    t0 = time.perf_counter()
    fsrc, fdst, _ = read_edge_list(os.path.join(here, "data",
                                                "facebook_like.txt"))
    reps = D1_EDGES // fsrc.shape[0]
    s1 = np.concatenate([fsrc.astype(np.int32)] * reps)
    d1 = np.concatenate([fdst.astype(np.int32)] * reps)
    e1 = s1.shape[0]
    print(f"phase D1 stream: {fsrc.shape[0]} fixture edges x {reps} = {e1} "
          f"edges over {D1_N} slots in {time.perf_counter() - t0:.2f} s")

    def d1_run(pull=pull):
        agg = deg.degree_aggregate(D1_N)
        check(agg.stack_payloads is None, "D1 did not take the dense codec")
        return drive(torch, device, agg,
                     EdgeChunkSource(s1, d1, chunk_size=D1_CHUNK,
                                     table=IdentityVertexTable(D1_N)),
                     D1_N, e1, D1_MERGE_EVERY, D1_MERGE_EVERY, pull)

    _, st = d1_run()
    report_run("phase D1 warm-up", st)
    runs = [d1_run() for _ in range(2)]
    for i, (_, st) in enumerate(runs):
        report_run(f"phase D1 degrees run {i + 1}", st)
    out = runs[0][0]
    window = D1_MERGE_EVERY * D1_CHUNK
    check(len(out) == -(-e1 // window), f"D1: {len(out)} emissions")
    for i, got in enumerate(out):
        hi = min((i + 1) * window, e1)
        want = signed_degrees(s1[:hi], d1[:hi], 1, D1_N)
        check(same(got, want) and same(got, runs[1][0][i]),
              f"D1 emission {i} != bincount oracle")
    print(f"phase D1: {len(out)} emissions of int64[{D1_N}] equal the "
          f"bincount oracle at their boundaries")
    del s1, d1, out, runs

    # D2: phase 4's stream, then its first 2^24 edges again as deletions.
    n = N_VERTICES
    s2 = np.concatenate([src, src[:D2_DELETES]])
    d2 = np.concatenate([dst, dst[:D2_DELETES]])
    ev = np.concatenate([np.zeros(N_EDGES, np.int8),
                         np.ones(D2_DELETES, np.int8)])
    e2 = s2.shape[0]
    n_chunks = e2 // CHUNK
    t0 = time.perf_counter()
    want, running, peak = [], np.zeros(n, np.int64), 0
    touched = np.zeros(n, bool)
    for c in range(n_chunks):
        lo, hi = c * CHUNK, (c + 1) * CHUNK
        running += signed_degrees(s2[lo:hi], d2[lo:hi],
                                  -1 if ev[lo] else 1, n)
        touched[s2[lo:hi]] = True
        touched[d2[lo:hi]] = True
        peak = max(peak, int(running.max()))
        if (c + 1) % MERGE_EVERY == 0:
            want.append(running.copy())
    final = running
    print(f"phase D2 oracle: {e2} events ({D2_DELETES} deletions), "
          f"{len(want)} boundaries, peak degree {peak}, "
          f"{int(touched.sum())} touched slots, in "
          f"{time.perf_counter() - t0:.2f} s")

    def d2_source(events=ev, edges=e2):
        return EdgeChunkSource(s2[:edges], d2[:edges], events=events[:edges],
                               chunk_size=CHUNK,
                               table=IdentityVertexTable(n))

    def d2_run(plan=None, pull=pull, **knobs):
        agg = plan or deg.degree_aggregate(n)
        return drive(torch, device, agg, d2_source(), n, e2, MERGE_EVERY,
                     MERGE_EVERY, pull, **knobs)

    check(deg.degree_aggregate(n).stack_payloads is not None,
          "D2 did not take the sparse codec")
    runs = [d2_run() for _ in range(2)]
    for i, (_, st) in enumerate(runs):
        report_run(f"phase D2 sparse codec run {i + 1}", st, "events")
    sparse = runs[0][0]
    check(len(sparse) == len(want) == n_chunks // MERGE_EVERY,
          f"D2: {len(sparse)} emissions")
    for i, (got, w) in enumerate(zip(sparse, want)):
        check(same(got, w) and same(got, runs[1][0][i]),
              f"D2 emission {i} != signed bincount oracle")
    for name, plan in (
            ("dense codec", deg.degree_aggregate(n, codec="dense")),
            ("raw fold", deg.degree_aggregate(n, ingest_combine=False))):
        got, st = d2_run(plan)
        report_run(f"phase D2 {name}", st, "events")
        check(len(got) == len(sparse) and all(
            same(a, b) for a, b in zip(got, sparse)),
            f"D2: the {name} differs from the sparse codec")
        del got
    print(f"phase D2: {len(sparse)} emissions of int64[{n}] equal the "
          f"signed bincount oracle; the dense codec and the raw fold agree")
    stop_and_resume(d2_run, sparse, len(sparse),
                    MERGE_EVERY, "phase D2")
    del sparse, runs, want

    # D3: the stream API on D2's stream, host-synced per chunk by design.
    def api_stream(edges=e2):
        return edge_stream_from_source(d2_source(edges=edges), n,
                                       device=device)

    def timed(name, fn, n_events=e2):
        torch.cuda.synchronize()
        unionfind.host_sync.count = 0
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        print(f"phase D3 {name}: wall={wall:.4f} s "
              f"({n_events / wall:.1f} events/s) host_syncs="
              f"{unionfind.host_sync.count}")
        return out

    def last_degrees():
        last = np.zeros(n, np.int64)
        hit = np.zeros(n, bool)
        for upd in api_stream().get_degrees():
            m = upd.valid.cpu().numpy()
            slots = upd.slots.cpu().numpy()[m]
            last[slots] = upd.values.cpu().numpy()[m]
            hit[slots] = True
        return last, hit

    last, hit = timed("get_degrees (pulled per chunk)", last_degrees)
    check(np.array_equal(hit, touched), "D3: get_degrees touched slots")
    check(np.array_equal(last[hit], final[hit]),
          "D3: a last get_degrees value != the oracle")

    def vertex_counts():
        count = np.zeros(n, np.int64)
        for upd in api_stream().get_vertices():
            m = upd.valid.cpu().numpy()
            slots = upd.slots.cpu().numpy()[m]
            check(np.array_equal(upd.values.cpu().numpy()[m], slots),
                  "D3: get_vertices raw id != slot (identity table)")
            count += np.bincount(slots, minlength=n)
        return count

    count = timed("get_vertices (pulled per chunk)", vertex_counts)
    check(np.array_equal(count, touched.astype(np.int64)),
          "D3: get_vertices did not emit every seen slot exactly once")
    edges = timed("number_of_edges",
                  lambda: list(api_stream().number_of_edges()))
    check(edges[-1] == N_EDGES - D2_DELETES and len(edges) == n_chunks,
          f"D3: number_of_edges ends at {edges[-1]}")
    verts = timed("number_of_vertices",
                  lambda: list(api_stream().number_of_vertices()))
    check(verts[-1] == int(touched.sum()),
          f"D3: number_of_vertices ends at {verts[-1]}")
    hist = timed(f"degree_distribution(max_degree={peak})", lambda: list(
        deg.degree_distribution(api_stream(), max_degree=peak))[-1])
    check(np.array_equal(hist.cpu().numpy(),
                         np.bincount(final[final > 0], minlength=peak + 1)),
          "D3: the final degree histogram != the oracle's")
    del hist
    msg = f"degree {peak} exceeds max_degree {peak - 1}; raise max_degree"
    try:
        timed(f"degree_distribution(max_degree={peak - 1})",
              lambda: list(deg.degree_distribution(api_stream(),
                                                   max_degree=peak - 1)))
        check(False, "D3: max_degree = peak - 1 did not raise")
    except ValueError as e:
        check(str(e) == msg, f"D3: raised {e!r}, not {msg!r}")
    print(f"phase D3: max_degree={peak - 1} raised ValueError({msg!r})")
    prefix = D3_PREFIX
    got = timed(f"final_degrees on a {prefix}-edge prefix",
                lambda: api_stream(prefix).get_degrees().final_degrees(),
                prefix)
    pre = signed_degrees(s2[:prefix], d2[:prefix], 1, n)
    want_d = {int(v): int(pre[v]) for v in np.nonzero(pre)[0]}
    check(got == want_d, "D3: final_degrees on the prefix != the oracle")
    print(f"phase D3: get_degrees last values, get_vertices (each of "
          f"{int(touched.sum())} seen slots once), number_of_edges "
          f"{edges[-1]}, number_of_vertices {verts[-1]}, the degree "
          f"histogram and final_degrees ({len(got)} vertices) equal the "
          f"oracles")
    check_native_codecs("phase D")


def bipartite_oracle(src, dst, n: int) -> bool:
    """A graph is bipartite iff, in its double cover (``(u, v)`` becomes
    ``(u, v + n)`` and ``(u + n, v)``), no touched vertex ``u`` shares a
    component with ``u + n``."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    s = np.concatenate([src, src + n]).astype(np.int64)
    d = np.concatenate([dst + n, dst]).astype(np.int64)
    g = coo_matrix((np.ones(s.shape[0], np.int8), (s, d)),
                   shape=(2 * n, 2 * n)).tocsr()
    _, comp = connected_components(g, directed=False)
    t = np.unique(np.concatenate([src, dst]))
    return not bool((comp[t] == comp[t + n]).any())


def bipartite_oracle_at(src, dst, n: int, bounds) -> list[bool]:
    """The double-cover oracle at each prefix end in ``bounds``; once a
    prefix is not bipartite, no longer one is (it holds the odd cycle)."""
    out: list[bool] = []
    for hi in bounds:
        if out and not out[-1]:
            out.append(False)
        else:
            out.append(bipartite_oracle(src[:hi], dst[:hi], n))
    return out


def parity_drive(torch, device, label: str, launches: dict, agg, *args,
                 **knobs):
    """A phase E :func:`drive` under a :class:`MetLog`: prints the run's
    parity kernel launches and what their calls met, keeps the launches
    in ``launches[label]``, and checks that the run went through both
    parity kernels, every call met a whole number of rounds, and no
    round was read on the host."""
    from gelly_torch.ops import parity_unionfind as puf

    with MetLog(torch, puf) as log:
        out, st = drive(torch, device, agg, *args, **knobs)
    met = log.summary()
    fx = {k: st["fixpoints"][k] for k in MetLog.NAMES}
    union, jump = met["union_edges_parity"], met["pointer_jump_parity"]
    print(f"{label}: parity launches {fx}; union rounds met: "
          f"{union['calls']} calls, {union['sum']} in all, "
          f"{union['min']}-{union['max']} a call; closes' longest walk "
          f"{jump['min']}-{jump['max']} hops over {jump['calls']} closes; "
          f"host_syncs={st['host_syncs']}")
    check(fx["union_edges_parity"] > 0 and fx["pointer_jump_parity"] > 0,
          f"{label}: the run did not launch both parity kernels: {fx}")
    # Every union goes through the module; each launches the jump once,
    # and each close one more.
    check(fx["union_edges_parity"] == union["calls"]
          and fx["pointer_jump_parity"] == union["calls"] + jump["calls"],
          f"{label}: launches {fx} for {union['calls']} unions and "
          f"{jump['calls']} closes")
    check(union["min"] >= 1 and jump["min"] >= 0,
          f"{label}: a parity call met {union['min']} rounds / a walk "
          f"{jump['min']} hops")
    check(st["host_syncs"] == 0,
          f"{label}: {st['host_syncs']} host syncs (want 0)")
    launches[label] = fx
    return out, st


def bipartiteness_phase(torch, device, src, dst) -> dict:
    """Phase E: the bipartiteness check at BASELINE #4's size (E1), a
    bipartite stream at Twitter scale (E2) and an odd-cycle stream at
    Twitter scale (E3), every run through the parity kernels; then the
    parity kernels on inputs captured from E2 (its raw fold's first
    union, its sparse codec fold's first union, its first close's jump).
    Returns the parity launches of each run and the timed checks."""
    from gelly_torch.core.io import EdgeChunkSource
    from gelly_torch.core.vertices import IdentityVertexTable
    from gelly_torch.library import bipartiteness as bp
    from gelly_torch.ops import parity_unionfind as puf
    from gelly_torch.utils import native

    check(native.parity_combine_available()
          and native.parity_sparse_available(),
          "the native parity codecs did not build or load")
    pull = lambda r: tuple(x.cpu().numpy() for x in r)  # noqa: E731

    # E1: bench.py:bench_bipartiteness' call.
    t0 = time.perf_counter()
    s1, d1 = synth_edges(E1_EDGES, E1_N, E1_SEED)
    print(f"phase E1 stream: {E1_EDGES} Zipf edges over {E1_N} slots "
          f"(seed {E1_SEED}) in {time.perf_counter() - t0:.2f} s")

    launches: dict = {}

    def e1_run(label, pull=pull):
        agg = bp.bipartiteness_check(E1_N)
        check(agg.stack_payloads is None, "E1 did not take the dense codec")
        return parity_drive(torch, device, label, launches, agg,
                            EdgeChunkSource(s1, d1, chunk_size=E1_CHUNK,
                                            table=IdentityVertexTable(E1_N)),
                            E1_N, E1_EDGES, MERGE_EVERY, MERGE_EVERY, pull)

    _, st = e1_run("E1 warm-up")
    report_run("phase E1 warm-up", st)
    runs = [e1_run(f"E1 run {i + 1}") for i in range(2)]
    for i, (_, st) in enumerate(runs):
        report_run(f"phase E1 bipartiteness run {i + 1}", st)
    out = runs[0][0]
    window = MERGE_EVERY * E1_CHUNK
    bounds = [min((i + 1) * window, E1_EDGES) for i in range(len(out))]
    check(len(out) == -(-E1_EDGES // window)
          and all(same(a, b) for a, b in zip(out, runs[1][0])),
          f"E1: {len(out)} emissions, or the two runs differ")
    t0 = time.perf_counter()
    want = bipartite_oracle_at(s1, d1, E1_N, bounds)
    got = [bool(r[0]) for r in out]
    check(got == want, f"E1: ok {got} != the double-cover oracle {want}")
    print(f"phase E1: ok {got} equals the double-cover oracle "
          f"({time.perf_counter() - t0:.2f} s)")
    del s1, d1, runs, out

    # E2: phase 4's stream made bipartite (every edge joins even to odd).
    n = N_VERTICES
    s2, d2 = src & ~1, dst | 1
    e2 = s2.shape[0]

    def e2_run(plan=None, pull=pull, what="sparse codec", **knobs):
        agg = plan or bp.bipartiteness_check(n)
        if knobs.get("resume"):
            what += ", resumed"
        elif knobs.get("stop_after"):
            what += ", stopped"
        return parity_drive(torch, device, f"E2 {what}", launches, agg,
                            EdgeChunkSource(s2, d2, chunk_size=CHUNK,
                                            table=IdentityVertexTable(n)),
                            n, e2, MERGE_EVERY, MERGE_EVERY, pull, **knobs)

    check(bp.bipartiteness_check(n).stack_payloads is not None,
          "E2 did not take the sparse codec")
    # Run 1's first fold union and first close are kept for the timed
    # checks below.
    sparse_call = FirstCall(torch, puf, "union_edges_parity")
    close_call = FirstCall(torch, puf, "pointer_jump_parity")
    with sparse_call, close_call:
        runs = [e2_run(what="sparse codec run 1")]
    runs.append(e2_run(what="sparse codec run 2"))
    for i, (_, st) in enumerate(runs):
        report_run(f"phase E2 sparse codec run {i + 1}", st)
    out = runs[0][0]
    window = MERGE_EVERY * CHUNK
    check(len(out) == e2 // window, f"E2: {len(out)} emissions")
    t0 = time.perf_counter()
    for i, (ok, labels, colors) in enumerate(out):
        hi = (i + 1) * window
        seen = np.zeros(n, bool)
        seen[s2[:hi]] = True
        seen[d2[:hi]] = True
        check(bool(ok), f"E2 emission {i}: ok is False")
        check(same(out[i], runs[1][0][i]), f"E2 emission {i}: runs differ")
        check(labels.dtype == colors.dtype == np.int32
              and np.array_equal(labels >= 0, seen)
              and np.array_equal(colors >= 0, seen),
              f"E2 emission {i}: labels/colors dtype or seen slots")
        check(bool((colors[s2[:hi]] != colors[d2[:hi]]).all()),
              f"E2 emission {i}: an edge joins two slots of one color")
        check(bool((colors[labels[seen]] == 0).all()),
              f"E2 emission {i}: a component root is not colored 0")
    check(np.array_equal(out[-1][1], scipy_oracle(s2, d2, n)),
          "E2: the final labels != scipy's")
    print(f"phase E2: {len(out)} emissions ok=True, every edge two-colored "
          f"and every root colored 0; the final labels equal scipy's "
          f"({time.perf_counter() - t0:.2f} s)")
    raw_call = FirstCall(torch, puf, "union_edges_parity")
    for name, plan in (
            ("dense codec", bp.bipartiteness_check(n, codec="dense")),
            ("raw fold", bp.bipartiteness_check(n, ingest_combine=False))):
        if name == "raw fold":
            with raw_call:
                got, st = e2_run(plan, what=name)
        else:
            got, st = e2_run(plan, what=name)
        report_run(f"phase E2 {name}", st)
        check(len(got) == len(out) and same(got[-1], out[-1]),
              f"E2: the {name}'s final emission differs from the sparse "
              "codec's")
        del got
    stop_and_resume(e2_run, out, len(out),
                    MERGE_EVERY, "phase E2")
    del out, runs, s2, d2

    # E3: phase 4's stream without its self-loops: odd cycles of length 3+.
    keep = src != dst
    s3, d3 = src[keep], dst[keep]
    e3 = s3.shape[0]

    def e3_run(pull=pull):
        return parity_drive(torch, device, "E3 sparse codec", launches,
                            bp.bipartiteness_check(n),
                            EdgeChunkSource(s3, d3, chunk_size=CHUNK,
                                            table=IdentityVertexTable(n)),
                            n, e3, MERGE_EVERY, MERGE_EVERY, pull)

    out, st = e3_run()
    report_run("phase E3 sparse codec", st)
    window = MERGE_EVERY * CHUNK
    bounds = [min((i + 1) * window, e3) for i in range(len(out))]
    check(len(out) == -(-e3 // window), f"E3: {len(out)} emissions")
    t0 = time.perf_counter()
    want = bipartite_oracle_at(s3, d3, n, bounds)
    got = [bool(r[0]) for r in out]
    check(got == want, f"E3: ok {got} != the double-cover oracle {want}")
    first_false = got.index(False) if False in got else len(got)
    check(not any(got[first_false:]), "E3: ok came back after it was False")
    print(f"phase E3: {e3} edges ({N_EDGES - e3} self-loops dropped), ok at "
          f"the {len(got)} boundaries {got} equals the double-cover oracle "
          f"({time.perf_counter() - t0:.2f} s)")
    check_native_codecs("phase E")
    del s3, d3, keep
    torch.cuda.empty_cache()

    # The parity kernels on inputs captured from E2, each against its
    # plain version, its time and its bound.
    timed = {"union_edges_parity": [
        fixpoint_phase(torch, device, "union_edges_parity", raw_call,
                       "E2's raw fold's first union"),
        fixpoint_phase(torch, device, "union_edges_parity", sparse_call,
                       "E2's sparse codec fold's first union")],
        "pointer_jump_parity": [
        fixpoint_phase(torch, device, "pointer_jump_parity", close_call,
                       "E2's first close")]}
    del raw_call, sparse_call, close_call
    torch.cuda.empty_cache()
    return {"launches": launches, **timed}


# ---------------------------------------------------------------------- #
# Phases F and G: the per-window Merger plan, the k-spanner, the matching


class GateTimer:
    """Stand-in for one kernel wrapper of ``gelly_torch.ops.kernels``
    while it is installed there: calls ``impl`` (the kernel's wrapper or
    its plain version), times each call with CUDA events, and keeps the
    ``launches`` count of what it wraps (its own count, reset like the
    others). A spanner gate's call also records the work its data needed
    (lanes, live lanes or the donor's count, accepted edges), read with a
    sync around the call; any other kernel's records its tensor arguments'
    shapes."""

    def __init__(self, torch, kernels, name: str, impl, capture=None):
        self.torch, self.kernels, self.name, self.impl = \
            torch, kernels, name, impl
        self.launches = 0
        self.calls = []
        self.capture = capture  # the index of a call whose inputs to keep
        self.captured = None
        self.captured_out = None  # and what that call returned

    def __call__(self, *args, **kw):
        torch = self.torch
        if len(self.calls) == self.capture:
            self.captured = [x.clone() if isinstance(x, torch.Tensor) else x
                             for x in args]
        before = getattr(self.impl, "launches", 0)
        gate = self.name.startswith("sparse_insert_edges")
        info = {}
        if gate:
            info["n_before"] = int(args[5])  # the summary's count
        if self.name == "sparse_insert_edges_batched":
            info["n_valid"] = min(int(args[9]), args[7].shape[0])
        elif gate:
            info["lanes"] = args[7].shape[0]
            info["live"] = int((args[9] & (args[7] != args[8])).sum())
        else:
            info["shapes"] = [tuple(x.shape) for x in args
                              if isinstance(x, torch.Tensor)]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.impl(*args, **kw)
        end.record()
        if len(self.calls) == self.capture:
            self.captured_out = out
        if gate:
            info["accepted"] = int(args[5]) - info["n_before"]
        self.calls.append((start, end, info))
        self.launches += getattr(self.impl, "launches", 0) - before
        return out

    def __enter__(self):
        self.saved = getattr(self.kernels, self.name)
        setattr(self.kernels, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.kernels, self.name, self.saved)
        return False

    def timings(self) -> list:
        """``(ms, info)`` of each call."""
        self.torch.cuda.synchronize()
        return [(start.elapsed_time(end), info)
                for start, end, info in self.calls]


def gate_bound_ms(info: dict, max_degree: int) -> tuple[float, int]:
    """(ms, bytes): the least time the card could take for one gate call,
    from the bytes its data needs: each lane read once (8 B of ids, plus
    the valid byte for the per-edge entry), each live lane's own row
    (``4 D`` B, read in the BFS's first round), and each accepted edge's
    writes (two row slots, two fill counts, two list entries: 24 B)."""
    if "n_valid" in info:
        lanes = live = info["n_valid"]
        lane_bytes = 8
    else:
        lanes, live = info["lanes"], info["live"]
        lane_bytes = 9
    nbytes = lane_bytes * lanes + 4 * max_degree * live + 24 * info["accepted"]
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def gate_us(ms: float, info: dict, batch: int) -> float:
    """Microseconds a unit of a gate call's chain: a batch of the donor
    (entry 2, ``batch`` candidates) or a live lane (entry 1)."""
    if "n_valid" in info:
        units = -(-info["n_valid"] // batch)
    else:
        units = info["live"]
    return ms * 1e3 / units if units else 0.0


def fold_work(torch, state, lanes, after, sub: int) -> dict:
    """The work one k = 2 fold call's data needed: its lanes, live lanes,
    accepted edges, and ``rows``, the distinct endpoints of live lanes
    summed over the sub-batches (each sub-batch's gate reads each of its
    rows once, as the rows stand at its start)."""
    u, v, ok = lanes
    live = ok & (u != v)
    j = torch.arange(u.shape[0], device=u.device) // sub
    base = j[live] * state[0].shape[0]
    ends = torch.cat([base + u[live].long(), base + v[live].long()])
    return {"lanes": u.shape[0], "live": int(live.sum()),
            "rows": int(torch.unique(ends).numel()),
            "accepted": int(after[5]) - int(state[5])}


def fold_bound_ms(info: dict, max_degree: int) -> tuple[float, int]:
    """(ms, bytes): the least time the card could take for one k = 2 fold
    call, from the bytes its data needs: each lane read once (9 B), each
    distinct live endpoint's row once a sub-batch (``4 D`` B), and each
    accepted edge's writes (two row slots, two fill counts, two list
    entries: 24 B)."""
    nbytes = (9 * info["lanes"] + 4 * max_degree * info["rows"]
              + 24 * info["accepted"])
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


class FoldCheck:
    """Stand-in for ``kernels.sparse_fold_chunk_k2`` while it is installed
    there: runs the wrapper (counted in its own ``launches``, reset like
    the others) and times each call with CUDA events. The first ``check``
    calls (every call when None) also keep copies of the summary before
    and after the call and of its lanes, and the grid barriers the call's
    kernel met. The wrapper leaves its counts (``launches``, ``barriers``)
    on the name ``kernels.sparse_fold_chunk_k2``, which is this stand-in
    while it is installed. :meth:`verify`, after the run, runs the plain
    fold on the copies from before (host clock) and holds every field of
    the summary to the kernel's, bit for bit."""

    def __init__(self, torch, kernels, what: str, check=None):
        self.torch, self.kernels, self.what = torch, kernels, what
        self.impl = kernels.sparse_fold_chunk_k2
        self.check = check
        self.launches = 0
        self.calls = []  # (start, end) events of each call
        self.host_ms = []  # the host's time in each call (perf_counter)
        self.kept = []  # (before, lanes, max_degree and sub, after,
        # the barriers met)
        self.max_abs_err = 0

    def __call__(self, *args):
        torch = self.torch
        keep = self.check is None or len(self.calls) < self.check
        if keep:
            before = [x.clone() for x in args[:10]]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        launches = self.impl.launches
        self.barriers = None
        start.record()
        t = time.perf_counter()
        self.impl(*args)
        self.host_ms.append((time.perf_counter() - t) * 1e3)
        end.record()
        self.launches += self.impl.launches - launches
        self.calls.append((start, end))
        if keep:
            self.kept.append((before[:7], before[7:], args[10:],
                              [x.clone() for x in args[:7]],
                              self.barriers))

    def verify(self) -> list:
        """``(ms, plain_ms, work, grid barriers met)`` of each checked
        call, in call order."""
        torch = self.torch
        torch.cuda.synchronize()
        out = []
        for i, (state, lanes, rest, after, met) in enumerate(self.kept):
            work = fold_work(torch, state, lanes, after, rest[1])
            torch.cuda.synchronize()
            t = time.perf_counter()
            self.kernels.sparse_fold_chunk_k2_plain(*state, *lanes, *rest)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t) * 1e3
            for name, a, b in zip(SPANNER_FIELDS, after, state):
                err = int((a.long() - b.long()).abs().max()) \
                    if a.numel() else 0
                self.max_abs_err = max(self.max_abs_err, err)
                check(torch.equal(a, b), f"{self.what}: sparse_fold_chunk_k2"
                                         f"'s {name} != its plain version "
                                         f"on chunk {i}")
            start, end = self.calls[i]
            out.append((start.elapsed_time(end), plain_ms, work,
                        None if met is None else int(met)))
        self.kept = []
        return out

    def timings(self) -> list:
        """Kernel ms of each call."""
        self.torch.cuda.synchronize()
        return [start.elapsed_time(end) for start, end in self.calls]

    def __enter__(self):
        setattr(self.kernels, "sparse_fold_chunk_k2", self)
        return self

    def __exit__(self, *exc):
        setattr(self.kernels, "sparse_fold_chunk_k2", self.impl)
        return False


def spanner_pull(summary):
    return tuple(x.cpu().numpy() for x in summary)


def input_keys(torch, src, dst, n: int, device):
    """Sorted ``int64`` keys ``min * n + max`` of an edge stream, on the
    card (the subset check's index)."""
    s = torch.from_numpy(src).to(device).long()
    d = torch.from_numpy(dst).to(device).long()
    keys = torch.minimum(s, d) * n + torch.maximum(s, d)
    del s, d
    return torch.sort(keys)[0]


def check_subset(torch, keys, esrc, edst, n: int, what: str) -> None:
    """Every accepted edge ``(esrc[i], edst[i])`` is an input edge."""
    a = torch.as_tensor(esrc).to(keys.device).long()
    b = torch.as_tensor(edst).to(keys.device).long()
    q = torch.minimum(a, b) * n + torch.maximum(a, b)
    pos = torch.searchsorted(keys, q).clamp(max=keys.numel() - 1)
    check(bool((keys[pos] == q).all()),
          f"{what}: an accepted edge is not an input edge")


def hops_within_2(esrc, edst, n: int, pairs):
    """Hop distances of ``pairs`` in the graph of the accepted edges, 0, 1,
    2, or 3 for farther: a sorted adjacency, then per pair a membership and
    a sorted-list intersection (the smaller list searched in the larger)."""
    a = np.concatenate([esrc, edst]).astype(np.int64)
    b = np.concatenate([edst, esrc]).astype(np.int64)
    order = np.lexsort((b, a))
    a, b = a[order], b[order]
    starts = np.searchsorted(a, np.arange(n + 1))
    hops = np.full(pairs.shape[0], 3, np.int64)
    for i, (u, v) in enumerate(pairs.tolist()):
        if u == v:
            hops[i] = 0
            continue
        nu = b[starts[u]:starts[u + 1]]
        nv = b[starts[v]:starts[v + 1]]
        small, large = (nu, nv) if nu.shape[0] <= nv.shape[0] else (nv, nu)
        if large.shape[0] == 0:
            continue
        if nu.shape[0] and nu[min(np.searchsorted(nu, v),
                                  nu.shape[0] - 1)] == v:
            hops[i] = 1
            continue
        pos = np.searchsorted(large, small).clip(max=large.shape[0] - 1)
        if bool((large[pos] == small).any()):
            hops[i] = 2
    return hops


def hops_on_card(torch, esrc, edst, n: int, pairs, limit: int, device):
    """Exact hop distances (``limit + 1`` for farther) of a few ``pairs``
    in the graph of the accepted edges, one BFS a pair on the card over a
    sorted adjacency (frontiers through hubs stay cheap there)."""
    a = torch.from_numpy(np.concatenate([esrc, edst])).to(device).long()
    b = torch.from_numpy(np.concatenate([edst, esrc])).to(device).long()
    a, order = torch.sort(a, stable=True)
    b = b[order]
    starts = torch.searchsorted(a, torch.arange(n + 1, device=device))
    out = []
    for u, v in pairs.tolist():
        seen = torch.zeros(n, dtype=torch.bool, device=device)
        seen[u] = True
        front = torch.tensor([u], device=device)
        hops = limit + 1
        for d in range(1, limit + 1):
            lo, cnt = starts[front], starts[front + 1] - starts[front]
            total = int(cnt.sum())
            if total == 0:
                break
            base = torch.repeat_interleave(lo - (torch.cumsum(cnt, 0) - cnt),
                                           cnt)
            nb = b[base + torch.arange(total, device=device)]
            nb = torch.unique(nb[~seen[nb]])
            if bool((nb == v).any()):
                hops = d
                break
            seen[nb] = True
            front = nb
        out.append(hops)
    return np.array(out, np.int64)


def merge_levels(closes, emitted_n, n_windows: int) -> list[int]:
    """Gate levels each window's input edges went through, from the
    combine's calls at each close (``n_before``: the kept summary's count,
    ``n_valid``: the donor's) and the emitted counts: one for the window's
    own fold, one more at every close where the summary holding them was
    the donor (re-gated). The close of window ``c`` merges its locals with
    the global (``emitted_n[c - 1]``, 0 first); ``combine`` keeps the
    locals when they hold at least as many edges, so the global was the
    donor iff the donor's count is the global's."""
    glob_donor = []
    for c, (_, info) in enumerate(closes):
        before = emitted_n[c - 1] if c else 0
        glob_donor.append(info["n_valid"] == before)
    levels = []
    for t in range(n_windows):
        lv = 1 + (not glob_donor[t])
        lv += sum(glob_donor[c] for c in range(t + 1, n_windows))
        levels.append(lv)
    return levels


def sampled_hops(torch, esrc, edst, n: int, pairs, limit: int, device):
    """Hop distances of ``pairs`` in the graph of the accepted edges
    (``limit + 1`` past ``limit``): within 2 on the host, past that by a
    BFS on the card for each of the (few) farther pairs."""
    hops = hops_within_2(esrc, edst, n, pairs)
    far = np.nonzero(hops > 2)[0]
    if far.shape[0]:
        hops[far] = hops_on_card(torch, esrc, edst, n, pairs[far], limit,
                                 device)
    return hops


def merger_phase(torch, device, src, dst, cc_labels) -> None:
    """Phase F1: a user-written transient aggregation (the signed degree
    vector of each window: an ``index_add_`` fold, an in-place ``+``
    combine) and its non-transient twin over phase 4's stream, then
    phase 4's raw CC plan with ``cc_host_precombine``."""
    from gelly_torch.core.io import EdgeChunkSource
    from gelly_torch.core.vertices import IdentityVertexTable
    from gelly_torch.engine.aggregation import SummaryAggregation
    from gelly_torch.library import connected_components as cc

    n = N_VERTICES
    pull = lambda x: x.cpu().numpy()  # noqa: E731

    def plan(transient):
        def fold(s, c):
            sign = torch.where(c.event == 1, -1, 1).to(torch.int64)
            sign = torch.where(c.valid, sign, 0)
            s.index_add_(0, c.src.long(), sign)
            s.index_add_(0, c.dst.long(), sign)
            return s

        return SummaryAggregation(
            init=lambda d: torch.zeros(n, dtype=torch.int64, device=d),
            fold=fold, combine=lambda a, b: a.add_(b), transient=transient,
            device_fields=("src", "dst", "event", "valid"),
            name=f"signed-degrees-transient={transient}")

    def source(edges=N_EDGES):
        return EdgeChunkSource(src[:edges], dst[:edges], chunk_size=CHUNK,
                               table=IdentityVertexTable(n))

    window = MERGE_EVERY * CHUNK
    for transient in (True, False):
        out, st = drive(torch, device, plan(transient), source(), n,
                        N_EDGES, MERGE_EVERY, 1, pull)
        report_run(f"phase F1 Merger plan transient={transient}", st)
        check(len(out) == N_EDGES // window, f"F1: {len(out)} emissions")
        for i, got in enumerate(out):
            lo = i * window if transient else 0
            hi = (i + 1) * window
            check(same(got, signed_degrees(src[lo:hi], dst[lo:hi], 1, n)),
                  f"F1 transient={transient}: emission {i} != the "
                  f"{'window' if transient else 'prefix'} bincount")
        print(f"phase F1 transient={transient}: {len(out)} emissions of "
              f"int64[{n}] equal each {'window' if transient else 'prefix'}"
              f"'s bincount")
        del out
    edges = F1_PRECOMBINE_CHUNKS * CHUNK
    got, st = drive(torch, device, cc.connected_components(
        n, merge="gather", ingest_combine=False, fold_backend="plain"),
        source(edges), n, edges, MERGE_EVERY, 1, pull,
        host_precombine=cc.cc_host_precombine,
        codec_workers=F1_PRECOMBINE_WORKERS)
    report_run("phase F1 raw CC plan with cc_host_precombine "
                f"({F1_PRECOMBINE_CHUNKS} chunks, "
                f"{F1_PRECOMBINE_WORKERS} staging workers)", st)
    check(len(got) == len(cc_labels)
          and all(same(a, b) for a, b in zip(got, cc_labels)),
          "F1: the pre-combined CC labels != phase 4's")
    print(f"phase F1: cc_host_precombine labels equal phase 4's first "
          f"{len(got)} emissions")


def spanner_bench_phase(torch, device, stream_out: dict) -> dict:
    """Phase F2: ``bench.py:bench_spanner``'s stream and plan through the
    engine, 4 windows of one 2^19-edge chunk; leaves the stream in
    ``stream_out`` for F4 and returns the combine's kernel and plain times
    at the second close (the same inputs in both runs)."""
    from gelly_torch.core.io import EdgeChunkSource
    from gelly_torch.core.vertices import IdentityVertexTable
    from gelly_torch.ops import kernels

    sp = __import__("gelly_torch.library.spanner", fromlist=["spanner"])
    n, e = F2_N, F2_EDGES
    rng = np.random.default_rng(F2_SEED)
    src = (rng.zipf(F2_ZIPF, e) % n).astype(np.int32)
    dst = (rng.zipf(F2_ZIPF, e) % n).astype(np.int32)
    sample = rng.choice(e, F2_SAMPLE, replace=False)  # the bench's draw
    stream_out.update(src=src, dst=dst)

    def run(pull=spanner_pull, **knobs):
        agg = sp.sparse_spanner(n, 2, SPANNER_D, max_edges=e,
                                gate_batch=SPANNER_SUB)
        return drive(torch, device, agg, EdgeChunkSource(
            src, dst, chunk_size=F2_CHUNK, table=IdentityVertexTable(n)),
            n, e, 1, 1, pull, **knobs)

    n_windows = e // F2_CHUNK  # one chunk a window
    folds = {"sparse_fold_chunk_k2": n_windows}
    with GateTimer(torch, kernels, "sparse_insert_edges_batched",
                   kernels.sparse_insert_edges_batched) as gate:
        out, st = run()
    report_run("phase F2 spanner (bench_spanner)", st,
               expect={"sparse_insert_edges_batched": n_windows, **folds})
    # The plain combine, and every chunk's fold held to its plain version.
    with GateTimer(torch, kernels, "sparse_insert_edges_batched",
                   kernels.sparse_insert_edges_batched_plain) as plain, \
            FoldCheck(torch, kernels, "F2") as fold:
        plain_out, pst = run()
    report_run("phase F2 spanner, plain combine, every fold checked", pst,
               expect=folds)
    checked = fold.verify()
    check(len(checked) == n_windows, f"F2: {len(checked)} folds checked")
    print(f"  F2 folds: {len(checked)} chunks of {F2_CHUNK} lanes through "
          f"csrc/spanner_fold_k2.cu, every summary field equal to the "
          f"plain fold's (max_abs_err {fold.max_abs_err}); kernel ms "
          f"{[round(m, 4) for m, *_ in checked]}, plain ms (host clock) "
          f"{[round(p, 2) for _, p, *_ in checked]}, grid barriers met "
          f"{[b for *_, b in checked]} for "
          f"{-(-F2_CHUNK // SPANNER_SUB)} sub-batches a chunk")
    check(len(out) == len(plain_out) == n_windows,
          f"F2: {len(out)} / {len(plain_out)} emissions")
    for i, (a, b) in enumerate(zip(out, plain_out)):
        check(same(a, b), f"F2 emission {i}: kernel combine != plain")
    timings = list(zip(gate.timings(), plain.timings()))
    for (ms, info), (pms, _) in timings:
        print(f"  F2 combine: donor {info['n_valid']} edges, "
              f"{info['accepted']} accepted, kernel {ms:.4f} ms "
              f"({gate_us(ms, info, kernels.GATE_BATCH):.3f} us a batch), "
              f"plain {pms:.4f} ms")
    last = out[-1]
    m = int(last[4])
    es, ed = last[2][:m], last[3][:m]
    check(not bool(last[5]), "F2: the edge list overflowed")
    keys = input_keys(torch, src, dst, n, device)
    check_subset(torch, keys, es, ed, n, "F2")
    del keys
    adj: dict = {}
    for a, b in zip(es.tolist(), ed.tolist()):
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set()).add(a)
    bad = 0
    for i in sample.tolist():
        a, b = int(src[i]), int(dst[i])
        if a == b or b in adj.get(a, ()):
            continue
        if adj.get(a, set()) & adj.get(b, set()):
            continue
        bad += 1
    check(bad == 0, f"F2: stretch sample FAIL ({bad}/{F2_SAMPLE})")
    print(f"phase F2: {n_windows} emissions equal the plain combine's; "
          f"accepted {[int(x[4]) for x in out]} per window close, "
          f"deg_overflow {int(last[6])}; every accepted edge an input "
          f"edge; the bench's {F2_SAMPLE}-edge stretch sample passes")
    stop_and_resume(run, out, n_windows, 1, "phase F2")
    (ms, info), (pms, _) = timings[1]
    bound, nbytes = gate_bound_ms(info, SPANNER_D)
    us = gate_us(ms, info, kernels.GATE_BATCH)
    print(f"  F2 close 2: entry 2 {ms:.4f} ms ({us:.3f} us a batch), plain "
          f"{pms:.4f} ms, bound {bound:.6f} ms ({nbytes} B)")
    return {"ms": ms, "plain_ms": pms, "bound_ms": bound, "us_batch": us,
            "bound_bytes": nbytes, "fold_launches": st["launches"][
                HAND_KERNELS.index("sparse_fold_chunk_k2")],
            "fold_checked": len(checked), "fold_err": fold.max_abs_err,
            "fold_chunk_ms": [m for m, *_ in checked],
            "fold_barriers": [b for *_, b in checked],
            "fold_chain": -(-F2_CHUNK // SPANNER_SUB)}


def spanner_twitter_phase(torch, device, src, dst) -> dict:
    """Phase F3: the spanner on phase 4's stream (``2^26`` edges, ``2^24``
    slots) in ``2^22``-edge chunks, 4 windows. The plain combine is held
    to the kernel at the second close (the first with a donor), on that
    close's own summaries cut to the donor's first
    :data:`F3_PLAIN_DONOR` edges: the whole donor (~1.4M edges, 22k
    batches of ~60 launches) would take the plain version a minute.
    Returns the kernel's launch count in the run."""
    from gelly_torch.core.io import EdgeChunkSource
    from gelly_torch.core.vertices import IdentityVertexTable
    from gelly_torch.ops import kernels

    sp = __import__("gelly_torch.library.spanner", fromlist=["spanner"])
    n = N_VERTICES

    def run(pull=None, **knobs):
        agg = sp.sparse_spanner(n, 2, SPANNER_D, gate_batch=SPANNER_SUB)
        return drive(torch, device, agg, EdgeChunkSource(
            src, dst, chunk_size=CHUNK, table=IdentityVertexTable(n)),
            n, N_EDGES, MERGE_EVERY, 1, pull, **knobs)

    n_windows = N_EDGES // (MERGE_EVERY * CHUNK)
    n_chunks = N_EDGES // CHUNK
    with GateTimer(torch, kernels, "sparse_insert_edges_batched",
                   kernels.sparse_insert_edges_batched, capture=1) as gate, \
            FoldCheck(torch, kernels, "F3", check=2) as folds:
        out, st = run()
    report_run("phase F3 spanner at Twitter scale", st,
               expect={"sparse_insert_edges_batched": n_windows,
                       "sparse_fold_chunk_k2": n_chunks})
    fold = fold_report_f3(torch, folds)
    timings = gate.timings()
    check(len(out) == n_windows, f"F3: {len(out)} emissions")
    for i, (ms, info) in enumerate(timings):
        bound, nbytes = gate_bound_ms(info, SPANNER_D)
        print(f"  F3 close {i + 1}: combine donor {info['n_valid']} edges, "
              f"{info['accepted']} accepted, kernel {ms:.4f} ms "
              f"({gate_us(ms, info, kernels.GATE_BATCH):.3f} us a batch), "
              f"bound {bound:.6f} ms ({nbytes} B)")
    # The plain combine on close 2's summaries, the donor cut short.
    args = gate.captured
    gate.captured = gate.captured_out = None
    cut = torch.tensor(min(F3_PLAIN_DONOR, timings[1][1]["n_valid"]),
                       dtype=torch.int32, device=device)
    results = []
    for impl in (kernels.sparse_insert_edges_batched,
                 kernels.sparse_insert_edges_batched_plain):
        state = [x.clone() for x in args[:7]]
        torch.cuda.synchronize()
        t = time.perf_counter()
        impl(*state, args[7], args[8], cut, *args[10:])
        torch.cuda.synchronize()
        results.append((state, (time.perf_counter() - t) * 1e3))
    (got, ms), (want, pms) = results
    check(all(torch.equal(x, y) for x, y in zip(got, want)),
          "F3: close 2's combine, donor cut, kernel != plain")
    print(f"  F3 close 2, donor cut to {int(cut)} edges: kernel "
          f"{ms:.4f} ms, plain {pms:.4f} ms (host clock), summaries equal")
    closes = [(ms_, gate_us(ms_, info, kernels.GATE_BATCH))
              for ms_, info in timings[1:]]
    del args, results, got, want
    last = out[-1]
    m = int(last.n)
    check(not bool(last.overflow), "F3: the edge list overflowed")
    keys = input_keys(torch, src, dst, n, device)
    check_subset(torch, keys, last.esrc[:m], last.edst[:m], n, "F3")
    del keys
    es = last.esrc[:m].cpu().numpy()
    ed = last.edst[:m].cpu().numpy()
    rng = np.random.default_rng(SEED)
    pick = rng.choice(N_EDGES, F3_SAMPLE, replace=False)
    t0 = time.perf_counter()
    pairs = np.stack([src[pick], dst[pick]], 1)
    # Past 2 hops the bound is k per gate level: the window's fold, and
    # each close that re-gated the summary holding the window's edges.
    emitted = [int(x.n) for x in out]
    levels = merge_levels(timings, emitted, n_windows)
    bound = np.array([2 ** levels[i // (MERGE_EVERY * CHUNK)]
                      for i in pick.tolist()])
    hops = sampled_hops(torch, es, ed, n, pairs, int(bound.max()), device)
    hist = np.bincount(np.minimum(hops, 9), minlength=10)
    check(bool((hops <= bound).all()),
          f"F3: {int((hops > bound).sum())} of {F3_SAMPLE} sampled edges "
          f"beyond k^levels")
    print(f"phase F3: accepted {emitted} per window close, deg_overflow "
          f"{int(last.deg_overflow)}; close 2's combine equal to the plain "
          f"one on its first {int(cut)} donor edges; every accepted "
          f"edge an input edge; "
          f"{F3_SAMPLE} sampled input edges at hops 0,1,2,... = "
          f"{hist.tolist()} ({int((hops <= 2).sum())} within 2; gate levels "
          f"a window {levels}, every edge within k^levels), "
          f"{time.perf_counter() - t0:.2f} s")
    del last
    # The emissions stay on the card: phase L holds its fused spanner to
    # them.
    return {"launches": st["launches"][HAND_KERNELS.index(
        "sparse_insert_edges_batched")], "out": out,
        "wall_s": st["wall_s"], "h2d_bytes": st["h2d_bytes"],
        "close_ms": [m for m, _ in closes],
        "close_us_batch": [u for _, u in closes],
        "fold_dispatch_s": st["busy"].get("fold_dispatch", 0.0),
        "fold_launches": st["launches"][HAND_KERNELS.index(
            "sparse_fold_chunk_k2")], **fold}


def fold_chain_floor(torch, kernels, nbr, src, max_degree: int,
                     sub: int) -> float:
    """ms of the k = 2 fold's chain floor on these lanes,
    ``kernels.sparse_fold_chunk_k2_floor`` (the fold's launch shape, only
    its barriers and one dependent row read a lane a sub-batch), the
    mean of :data:`FOLD_REPS` launches after one warm-up (CUDA
    events)."""
    kernels.sparse_fold_chunk_k2_floor(nbr, src, max_degree, sub)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(FOLD_REPS):
        kernels.sparse_fold_chunk_k2_floor(nbr, src, max_degree, sub)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / FOLD_REPS


def fold_warm_ms(torch, kernels, state, lanes, rest) -> float:
    """ms of one k = 2 fold call on a copy of ``state`` (CUDA events),
    the mean of :data:`FOLD_REPS` calls after a warm-up, each started on
    an idle card with its scratch cached."""
    ms = []
    for _ in range(FOLD_REPS + 1):
        copy = [x.clone() for x in state]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        kernels.sparse_fold_chunk_k2(*copy, *lanes, *rest)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        del copy
    return sum(ms[1:]) / FOLD_REPS


FOLD_REPS = 5


def fold_report_f3(torch, folds) -> dict:
    """F3's fold: chunks 1 and 2 held to the plain fold on every field;
    chunk 2's kernel time (CUDA events: its one call in the run, and again
    on its inputs, warm), its µs a sub-batch and the grid barriers its
    call in the run met, the chain floor on chunk 2's lanes and summary,
    the plain fold's time on the same inputs (host clock), its bound and
    its chain of sub-batches."""
    from gelly_torch.ops import kernels

    state, lanes, rest, _, _ = folds.kept[1]
    floor_ms = fold_chain_floor(torch, kernels, state[0], lanes[0], *rest)
    warm_ms = fold_warm_ms(torch, kernels, state, lanes, rest)
    _, (ms, plain_ms, info, barriers) = folds.verify()
    times = folds.timings()
    bound, nbytes = fold_bound_ms(info, SPANNER_D)
    chain = -(-info["lanes"] // SPANNER_SUB)
    print(f"  F3 folds: chunks 1 and 2 equal to the plain fold on every "
          f"field (max_abs_err {folds.max_abs_err}); chunk 2: kernel "
          f"{ms:.4f} ms in the run (CUDA events, one call; "
          f"{ms * 1e3 / chain:.3f} us a sub-batch; {barriers} grid "
          f"barriers met for {chain} sub-batches), {warm_ms:.4f} ms warm "
          f"(again on its inputs, mean of {FOLD_REPS}; "
          f"{warm_ms * 1e3 / chain:.3f} us a sub-batch), chain floor "
          f"{floor_ms:.4f} ms ({floor_ms * 1e3 / chain:.3f} us a sub-batch: "
          f"barriers and one dependent row read), plain {plain_ms:.2f} ms "
          f"(host clock), "
          f"{info['lanes']} lanes, {info['live']} live, {info['rows']} "
          f"distinct live endpoints over its sub-batches, "
          f"{info['accepted']} accepted, bound {bound:.6f} ms ({nbytes} B), "
          f"a chain of {chain} dependent sub-batches; kernel ms a chunk "
          f"{[round(m, 4) for m in times]}, the host's ms in each call "
          f"{[round(m, 4) for m in folds.host_ms]}")
    return {"fold_ms": ms, "fold_warm_ms": warm_ms,
            "fold_plain_ms": plain_ms, "fold_bound_ms": bound,
            "fold_bound_bytes": nbytes, "fold_rows": info["rows"],
            "fold_chain": chain, "fold_err": folds.max_abs_err,
            "fold_chunk_ms": times, "fold_host_ms": folds.host_ms,
            "fold_floor_ms": floor_ms,
            "fold_barriers": barriers}

# Phase L (fused multi-query, after F3, on phase 4's stream and chunks): the
# library quartet through run_aggregation(queries=...) at full width. L1:
# the raw fused fold (CC on the gather kernel, the spanner on F3's plan with
# its own merge window of MERGE_EVERY chunks); L2: the shared sparse codec;
# L3: L2's trio on four logical shards of the card; L4: L1's quartet
# stopped and resumed from its window-2 checkpoint.
L_FOLD_BATCH = 4  # L2 and L3's codec units (a multiple of the shards)
L3_SHARDS = 4
L3_EDGES = N_EDGES


def l_source(src, dst, n_edges: int = N_EDGES):
    from gelly_torch.core.io import EdgeChunkSource
    from gelly_torch.core.vertices import IdentityVertexTable

    return EdgeChunkSource(src[:n_edges], dst[:n_edges], chunk_size=CHUNK,
                           table=IdentityVertexTable(N_VERTICES))


def quartet_queries():
    from gelly_torch import library as lib

    n = N_VERTICES
    return [lib.cc_query(n, fold_backend="kernel"), lib.degrees_query(n),
            lib.bipartiteness_query(n),
            lib.spanner_query(n, 2, every=MERGE_EVERY, max_degree=SPANNER_D,
                              gate_batch=SPANNER_SUB)]


def codec_trio():
    from gelly_torch import library as lib

    return [q(N_VERTICES, compressed=True, codec="sparse")
            for q in (lib.cc_query, lib.degrees_query,
                      lib.bipartiteness_query)]


def same_tree(torch, a, b) -> bool:
    """Every leaf of two summaries or emissions equal, dtype and shape
    included (tensors on the card, or host arrays)."""
    from gelly_torch.engine.checkpoint import tree_flatten

    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        x, y = (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.asarray(v)) for v in (x, y))
        if x.dtype != y.dtype or x.shape != y.shape \
                or not torch.equal(x, y.to(x.device)):
            return False
    return True


def parity_launches(st: dict, what: str) -> dict:
    """A fused run's parity kernel launches, checked: its bipartiteness
    query folded and closed through both kernels."""
    fx = {k: st["fixpoints"][k] for k in MetLog.NAMES}
    print(f"phase {what}: parity launches {fx} "
          f"host_syncs={st['host_syncs']}")
    check(fx["union_edges_parity"] > 0 and fx["pointer_jump_parity"] > 0,
          f"phase {what}: parity launches {fx}")
    return fx


def multiquery_phase(torch, device, src, dst, labels, cc_run, dedup_chunks,
                     f3) -> dict:
    """Phase L. ``labels`` and ``cc_run`` are phase 4's kernel run (host
    labels a window, its stats), ``f3`` F3's run: its emissions on the
    card (``"out"``, taken and freed here as they are compared), wall and
    H2D bytes. Returns the gather's and entry 2's launches in L1, the k = 2
    fold's in L1 and L4, the parity kernels' in L1 and L2, and L2's
    emissions (on the card) and wall."""
    from gelly_torch.engine.checkpoint import read_checkpoint_header
    from gelly_torch.parallel.mesh import make_mesh

    n_chunks = -(-N_EDGES // CHUNK)
    n_windows = -(-n_chunks // MERGE_EVERY)

    def fused(queries, n_edges=N_EDGES, fold_batch=1, **knobs):
        return drive(torch, device, None, l_source(src, dst, n_edges),
                     N_VERTICES, n_edges, MERGE_EVERY, fold_batch, None,
                     queries=queries, **knobs)

    def alone(agg, fold_batch=1):
        return drive(torch, device, agg, l_source(src, dst), N_VERTICES,
                     N_EDGES, MERGE_EVERY, fold_batch, None)

    def cc_equal(got, i):
        return same(got.cpu().numpy(), labels[i])

    # L1. The raw fused fold: every query's emissions held to its
    # standalone run at the same boundaries.
    out, st = fused(quartet_queries())
    # Entry 2 runs at each of the spanner's merge windows and in each
    # emission's merge-on-read.
    merges = n_chunks // MERGE_EVERY + n_windows
    report_run("phase L1 fused quartet", st,
               expect={"sorted_window_gather": 3 * dedup_chunks,
                       "sparse_insert_edges_batched": merges,
                       "sparse_fold_chunk_k2": n_chunks})
    parity = {"L1": parity_launches(st, "L1")}
    check(len(out) == n_windows and all(
        sorted(e) == ["bipartiteness", "cc", "degrees", "spanner"]
        for e in out), f"L1: {len(out)} emissions")
    check(st["stats"]["multiquery.emissions"] == 4 * n_windows
          and st["stats"]["multiquery.runs"] == 1,
          f"L1: counters {st['stats']}")
    for i, e in enumerate(out):
        check(cc_equal(e.pop("cc"), i), f"L1 window {i}: cc != phase 4's")

    # L4. The quartet checkpointed every second window (one 3.7 GB write
    # before the stop), stopped once the window-2 checkpoint is written
    # (after the 3rd emission), and a fresh plan resuming from it:
    # windows 3 and 4 equal L1's.
    tmp = tempfile.mkdtemp(prefix="gelly-mq-")
    try:
        path = os.path.join(tmp, "ck.npz")
        knobs = {"checkpoint_path": path, "checkpoint_every": 2}
        got, st_stop = fused(quartet_queries(), stop_after=3, **knobs)
        del got
        header = read_checkpoint_header(path)
        check(header["position"] == 2 * MERGE_EVERY
              and header["meta"]["windows"] == 2
              and st_stop["stats"]["checkpoints"] == 1,
              f"L4: after the stop the checkpoint is at "
              f"{header['position']} {header['meta']}")
        ck_bytes = os.path.getsize(path)
        # The resumed run writes no checkpoint: its cadence is past the
        # stream's last window.
        got, st_res = fused(quartet_queries(), resume=True,
                            checkpoint_path=path,
                            checkpoint_every=n_windows)
        check(st_res["stats"]["resumed_at"] == 2 * MERGE_EVERY,
              f"L4: resumed at {st_res['stats']['resumed_at']}")
        check(len(got) == n_windows - 2, f"L4: {len(got)} emissions")
        fold_at = HAND_KERNELS.index("sparse_fold_chunk_k2")
        l4_folds = {"stop": st_stop["launches"][fold_at],
                    "resume": st_res["launches"][fold_at]}
        check(l4_folds["stop"] > 0 and l4_folds["resume"] > 0,
              f"L4: the spanner folded without the kernel: {l4_folds}")
        for i, (g, w) in enumerate(zip(got, out[2:])):
            check(cc_equal(g["cc"], i + 2), f"L4 window {i + 3}: cc")
            for name in ("degrees", "bipartiteness", "spanner"):
                check(same_tree(torch, g[name], w[name]),
                      f"L4 window {i + 3}: {name} != L1's")
        del got
        busy = st_res["busy"]
        print(f"phase L4 stop after 3 emissions: wall="
              f"{st_stop['wall_s']:.4f} s, checkpoint busy "
              f"{st_stop['busy'].get('checkpoint', 0):.4f} s for "
              f"{st_stop['stats']['checkpoints']} writes of {ck_bytes} B; "
              f"resume at position "
              f"{2 * MERGE_EVERY}: load={busy['resume_load']:.4f} s "
              f"skip={busy['resume_skip']:.4f} s, call to first emission "
              f"{st_res['first_emission_s']:.4f} s, wall="
              f"{st_res['wall_s']:.4f} s; windows 3-{n_windows} equal L1's; "
              f"k = 2 fold launches {l4_folds}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # L1's standalone runs: degrees and bipartiteness here, the spanner
    # is F3's run (the same plan, stream and boundaries).
    deg, st_deg = alone(quartet_queries()[1].agg)
    report_run("phase L1 standalone degrees", st_deg)
    for i, (a, e) in enumerate(zip(deg, out)):
        check(same_tree(torch, a, e.pop("degrees")),
              f"L1 window {i}: degrees != the standalone run's")
    del deg
    bip, st_bip = alone(quartet_queries()[2].agg)
    report_run("phase L1 standalone bipartiteness", st_bip)
    parity["L1 standalone"] = parity_launches(st_bip, "L1 standalone")
    for i, (a, e) in enumerate(zip(bip, out)):
        check(same_tree(torch, a, e.pop("bipartiteness")),
              f"L1 window {i}: bipartiteness != the standalone run's")
    del bip
    f3_out = f3.pop("out")
    check(len(f3_out) == n_windows, f"L1: F3 gave {len(f3_out)}")
    for i, e in enumerate(out):
        check(same_tree(torch, f3_out[i], e.pop("spanner")),
              f"L1 window {i}: spanner != F3's")
        f3_out[i] = None
    del out, f3_out
    torch.cuda.empty_cache()
    runs = {"cc": cc_run, "degrees": st_deg, "bipartiteness": st_bip,
            "spanner": f3}
    wall_sum = sum(r["wall_s"] for r in runs.values())
    h2d_sum = sum(r["h2d_bytes"] for r in runs.values())
    print(f"phase L1: fused wall={st['wall_s']:.4f} s h2d={st['h2d_bytes']} B "
          f"against the four standalone runs' sum wall={wall_sum:.4f} s "
          f"h2d={h2d_sum} B ("
          + ", ".join(f"{k} {r['wall_s']:.4f} s {r['h2d_bytes']} B"
                      for k, r in runs.items())
          + f"); fused/sum wall {st['wall_s'] / wall_sum:.4f}, h2d "
          f"{st['h2d_bytes'] / h2d_sum:.4f}; every window of every query "
          f"equal to its standalone run")
    result = {"gather_launches": st["launches"][HAND_KERNELS.index(
        "sorted_window_gather")], "merge_launches": st["launches"][
        HAND_KERNELS.index("sparse_insert_edges_batched")],
        "fold_launches": {"L1": st["launches"][HAND_KERNELS.index(
            "sparse_fold_chunk_k2")], "L4": l4_folds},
        "parity_launches": parity}

    # L2. The shared sparse codec: one multi-query payload a chunk.
    out2, st2 = fused(codec_trio(), fold_batch=L_FOLD_BATCH)
    report_run("phase L2 fused codec trio", st2)
    parity["L2"] = parity_launches(st2, "L2")
    check_native_codecs("phase L2")
    check(st2["stats"]["multiquery.compressed_chunks"] == n_chunks,
          f"L2: {st2['stats']['multiquery.compressed_chunks']} compressed "
          f"chunks != {n_chunks}")
    check(len(out2) == n_windows, f"L2: {len(out2)} emissions")
    wall2 = h2d2 = 0.0
    for q in codec_trio():
        a, st_q = alone(q.agg, fold_batch=L_FOLD_BATCH)
        report_run(f"phase L2 standalone {q.name} sparse codec", st_q)
        wall2 += st_q["wall_s"]
        h2d2 += st_q["h2d_bytes"]
        check(len(a) == n_windows and all(
            same_tree(torch, x, e[q.name]) for x, e in zip(a, out2)),
            f"L2: {q.name} != its standalone codec run")
        del a
    for i, e in enumerate(out2):
        check(cc_equal(e["cc"], i), f"L2 window {i}: cc != phase 4's")
    print(f"phase L2: the shared compress stage took "
          f"{st2['stats']['multiquery.compressed_chunks']} chunks, wire "
          f"{st2['h2d_bytes'] / N_EDGES:.4f} B/edge; fused wall="
          f"{st2['wall_s']:.4f} s h2d={st2['h2d_bytes']} B against the "
          f"three standalone codec runs' sum wall={wall2:.4f} s "
          f"h2d={int(h2d2)} B; every window equal")

    # L3. L2's trio on four logical shards of the card.
    mesh = make_mesh(L3_SHARDS, devices=[device] * L3_SHARDS)
    out3, st3 = fused(codec_trio(), n_edges=L3_EDGES,
                      fold_batch=L_FOLD_BATCH, mesh=mesh)
    report_run(f"phase L3 fused codec trio on {L3_SHARDS} shards", st3)
    n3 = -(-L3_EDGES // CHUNK)
    check(st3["stats"]["multiquery.compressed_chunks"] == n3,
          f"L3: {st3['stats']['multiquery.compressed_chunks']} compressed "
          f"chunks != {n3}")
    check(len(out3) == -(-n3 // MERGE_EVERY), f"L3: {len(out3)} emissions")
    for i, (g, w) in enumerate(zip(out3, out2)):
        check(same_tree(torch, g["cc"], w["cc"])
              and same_tree(torch, g["degrees"], w["degrees"])
              and bool(g["bipartiteness"].ok) == bool(w["bipartiteness"].ok),
              f"L3 window {i}: != the S = 1 run's")
    print(f"phase L3: {len(out3)} windows equal L2's (S = 1): cc labels, "
          f"degrees, bipartiteness ok "
          f"({bool(out3[-1]['bipartiteness'].ok)})")
    del out3
    # L2's emissions stay on the card for phase M3's traced rerun.
    result.update(l2_out=out2, l2_wall=st2["wall_s"])
    return result


# Phase M (the traced main path, after phase L): phase 4's kernel run under
# a SpanTracer with a 0.05 s heartbeat, best of 2 traced and 2 untraced,
# alternating; its first 4 chunks inside utils.metrics.trace
# (torch.profiler); L2's codec trio traced; phase C's resilient run with
# flight dumps on its injected faults.
M_HEARTBEAT_S = 0.05
M_REPS = 2
M2_CHUNKS = 4
M_OVERHEAD_GATE = 0.5  # loose, as tests/test_obs.py's smoke gate
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def m_raw_run(torch, device, src, dst, n_edges: int = N_EDGES):
    """Phase 4's kernel run over the first ``n_edges``, its launch and
    host-sync counts set to 0 just before it: ``(emissions on the card,
    wall_s, gather launches, host syncs, units)``."""
    from gelly_torch.core.stream import edge_stream_from_source
    from gelly_torch.library import connected_components as cc
    from gelly_torch.ops import kernels, unionfind

    stream = edge_stream_from_source(l_source(src, dst, n_edges),
                                     N_VERTICES, device=device)
    agg = cc.connected_components(N_VERTICES, merge="gather",
                                  ingest_combine=False, fold_backend="kernel")
    torch.cuda.synchronize()
    reset_launches(kernels)
    unionfind.host_sync.count = 0
    t = time.perf_counter()
    res = stream.aggregate(agg, merge_every=MERGE_EVERY)
    out = list(res)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return (out, wall, kernels.sorted_window_gather.launches,
            unionfind.host_sync.count, res.stats["units"])


def device_idle_share(events) -> tuple[float, float, int]:
    """``(idle share, window_s, device spans)`` of a Chrome-trace event
    list: one minus the union of the kernel and copy intervals over the
    traced window (the first to the last event of the file)."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
    lo = min(e["ts"] for e in timed)
    hi = max(e["ts"] + e["dur"] for e in timed)
    busy = union_length(spans) if spans else 0.0
    return 1 - busy / (hi - lo), (hi - lo) * 1e-6, len(spans)


def obs_phase(torch, device, src, dst, labels, dedup_chunks, mq,
              c_run) -> dict:
    """Phase M. ``labels`` are phase 4's host labels a window, ``mq``
    phase L's result (L2's emissions, taken here, and wall), ``c_run``
    phase C's final forest on the host. Returns the gather's launches in
    M1's traced runs."""
    import glob
    from collections import Counter

    from gelly_torch import obs
    from gelly_torch.ops import kernels
    from gelly_torch.utils.metrics import trace

    n_chunks = N_EDGES // CHUNK
    n_windows = n_chunks // MERGE_EVERY
    tmp = tempfile.mkdtemp(prefix="gelly-obs-")
    try:
        # M1. Traced and untraced, alternating, best of M_REPS each.
        walls = {"traced": [], "untraced": []}
        syncs = {"traced": set(), "untraced": set()}
        for rep in range(M_REPS):
            tr = obs.SpanTracer(heartbeat_every_s=M_HEARTBEAT_S)
            with obs.scope() as bus, obs.install(tr):
                out, wall, launches, host_syncs, units = m_raw_run(
                    torch, device, src, dst)
            walls["traced"].append(wall)
            syncs["traced"].add(host_syncs / units)
            what = f"M1 traced run {rep}"
            check(len(out) == n_windows and all(
                same(x.cpu().numpy(), labels[i]) for i, x in enumerate(out)),
                f"{what}: an emission != phase 4's")
            del out
            spans = Counter(r["name"] for r in tr.records()
                            if r["ph"] == "X")
            closes = len(tr.instants("window_close"))
            check(spans["compress"] == spans["h2d"] == spans["fold"]
                  == n_chunks and spans["merge_emit"] == n_windows
                  and closes == n_windows,
                  f"{what}: spans {dict(spans)}, {closes} window closes")
            counters = bus.snapshot()["counters"]
            check(counters.get("engine.chunks_folded") == n_chunks
                  and counters.get("engine.windows_closed") == n_windows
                  and counters.get("engine.edges_folded") == len(src),
                  f"{what}: counters {counters}")
            hist = bus.histogram("engine.fold_dispatch_ms")
            check(hist is not None and hist.snapshot()["count"] == n_chunks,
                  f"{what}: fold_dispatch_ms samples "
                  f"{hist.snapshot()['count'] if hist else None}")
            check(bus.watermarks.max_backlog_age() == 0,
                  f"{what}: backlog age {bus.watermarks.max_backlog_age()}")
            beats = len(tr.instants("heartbeat"))
            check(beats >= 1, f"{what}: no heartbeat line")
            check(launches == 3 * dedup_chunks,
                  f"{what}: {launches} gather launches != 3 x "
                  f"{dedup_chunks} dedup chunks")
            path = os.path.join(tmp, f"m1-{rep}.json")
            obs.write_chrome_trace(path, tr, bus=bus)
            with open(path) as f:
                obs.validate_chrome_trace(json.load(f))
            trace_bytes = os.path.getsize(path)
            gather_launches = launches

            out, wall, launches, host_syncs, units = m_raw_run(
                torch, device, src, dst)
            walls["untraced"].append(wall)
            syncs["untraced"].add(host_syncs / units)
            check(launches == gather_launches,
                  f"M1 untraced run {rep}: {launches} gather launches")
            check(len(out) == n_windows and all(
                same(x.cpu().numpy(), labels[i]) for i, x in enumerate(out)),
                f"M1 untraced run {rep}: an emission != phase 4's")
            del out
        check(len(syncs["traced"]) == 1 and syncs["traced"]
              == syncs["untraced"],
              f"M1: host syncs a unit traced {syncs['traced']} untraced "
              f"{syncs['untraced']}")
        on, off = min(walls["traced"]), min(walls["untraced"])
        overhead = on / off - 1
        print(f"phase M1 traced raw path (fold_backend=kernel): "
              f"traced walls {[round(w, 4) for w in walls['traced']]} s, "
              f"untraced {[round(w, 4) for w in walls['untraced']]} s; best "
              f"{on:.4f} s against {off:.4f} s: overhead {overhead:.4f} "
              f"(gate < {M_OVERHEAD_GATE}); {dict(spans)} spans, "
              f"{closes} window closes, {beats} heartbeats, "
              f"{trace_bytes} B of Chrome trace (valid); gather launches "
              f"{gather_launches}; host syncs/unit "
              f"{next(iter(syncs['traced'])):.3f} traced and untraced")
        check(overhead < M_OVERHEAD_GATE,
              f"M1: tracer overhead {overhead:.4f}")

        # M2. The first M2_CHUNKS chunks inside trace() on torch.profiler.
        log_dir = os.path.join(tmp, "profile")
        tr = obs.SpanTracer(heartbeat_every_s=None)
        with obs.scope(), obs.install(tr):
            t = time.perf_counter()
            with trace(log_dir, tracer=tr):
                out, wall, launches, _, _ = m_raw_run(
                    torch, device, src, dst, M2_CHUNKS * CHUNK)
            traced_s = time.perf_counter() - t
        check(len(out) == 1 and same(out[0].cpu().numpy(), labels[0]),
              "M2: the profiled window != phase 4's first")
        del out
        files = glob.glob(os.path.join(log_dir, "torch_profiler.*.json"))
        check(len(files) == 1, f"M2: profile files {files}")
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
        device_kernels = [e for e in events if e.get("cat") == "kernel"]
        gathers = sum("sorted_window_gather_kernel" in e.get("name", "")
                      for e in device_kernels)
        check(device_kernels and gathers == launches > 0,
              f"M2: {len(device_kernels)} kernel events, {gathers} of the "
              f"gather against {launches} launches")
        marks = [i for i in tr.instants()
                 if i["name"].startswith("torch_profiler_")]
        check([i["name"] for i in marks] == ["torch_profiler_start",
                                             "torch_profiler_stop"]
              and all(i["args"]["trace_id"] == tr.trace_id for i in marks),
              f"M2: alignment instants {marks}")
        idle, window_s, n_dev = device_idle_share(events)
        print(f"phase M2 trace() on torch.profiler, first {M2_CHUNKS} "
              f"chunks: wall {wall:.4f} s ({traced_s:.4f} s with the "
              f"profile's export), {len(events)} events in "
              f"{os.path.getsize(files[0])} B, {len(device_kernels)} kernel "
              f"events, {gathers} of them the gather = its {launches} "
              f"launches; device idle share {idle:.4f} over a "
              f"{window_s:.4f} s traced window ({n_dev} kernel and copy "
              f"spans); alignment instants carry trace_id {tr.trace_id}")

        # M3. L2's fused codec trio under a tracer.
        l2_out = mq.pop("l2_out")
        tr = obs.SpanTracer(heartbeat_every_s=None)
        with obs.scope() as bus, obs.install(tr):
            out3, st3 = drive(torch, device, None, l_source(src, dst),
                              N_VERTICES, N_EDGES, MERGE_EVERY, L_FOLD_BATCH,
                              None, queries=codec_trio())
            counters = bus.snapshot()["counters"]
        report_run("phase M3 traced fused codec trio", st3)
        names = [q.name for q in codec_trio()]
        folds = tr.spans("fold")
        check(folds and all(sp["args"]["queries"] == ",".join(names)
                            for sp in folds),
              f"M3: fold spans' queries {[sp['args'] for sp in folds]}")
        per_query = {}
        for sp in tr.spans("multiquery"):
            per_query.setdefault(sp["track"], []).append(
                sp["args"]["window"])
        check(per_query == {f"multiquery/{n}": list(
            range(1, n_windows + 1)) for n in names},
            f"M3: multiquery spans {per_query}")
        check(counters.get("multiquery.compressed_chunks") == n_chunks,
              f"M3: compressed chunks {counters}")
        check(len(out3) == len(l2_out) == n_windows and all(
            same_tree(torch, g[n], w[n])
            for g, w in zip(out3, l2_out) for n in names),
            "M3: an emission != L2's")
        del out3, l2_out
        print(f"phase M3: traced wall {st3['wall_s']:.4f} s against L2's "
              f"untraced {mq['l2_wall']:.4f} s; {len(folds)} fold spans "
              f"carry queries={','.join(names)}, "
              f"{sum(map(len, per_query.values()))} multiquery spans, "
              f"{int(counters['multiquery.compressed_chunks'])} compressed "
              f"chunks on the bus; every emission equal to L2's")

        # M4. Phase C's resilient run with flight dumps on its faults.
        flight = os.path.join(tmp, "flight")
        os.makedirs(flight)
        ckdir = os.path.join(tmp, "ck")
        tr = obs.SpanTracer(heartbeat_every_s=None)
        with obs.scope() as bus, obs.install(tr):
            unsubscribe = tr.dump_on("faults.injected", out_dir=flight,
                                     bus=bus)
            runner, final, plan, wall, launches = resilient_run(
                torch, device, src, dst, ckdir)
            unsubscribe()
            counters = bus.snapshot()["counters"]
        injected = tr.instants("faults.injected")
        check(len(injected) == 2 and len(plan.fired) == 2,
              f"M4: {len(injected)} fault instants, fired {plan.fired}")
        check(len(tr.dumps) == 2, f"M4: flight dumps {tr.dumps}")
        for path in tr.dumps:
            with open(path) as f:
                dump = json.load(f)
            obs.validate_chrome_trace(dump)
            check(dump["otherData"]["incident"] == "faults.injected"
                  and any(e["name"] == "faults.injected"
                          for e in dump["traceEvents"]),
                  f"M4: {path} lacks its incident")
        check(counters.get("resilience.retries")
              == runner.stats["retries"] == 2,
              f"M4: bus retries {counters.get('resilience.retries')}, "
              f"stats {runner.stats['retries']}")
        check(torch.equal(final.parent.cpu(), c_run["parent"])
              and torch.equal(final.seen.cpu(), c_run["seen"]),
              "M4: the forest != phase C's")
        print(f"phase M4 traced resilient raw fold: wall={wall:.4f} s, "
              f"gather launches={launches}; {len(injected)} faults.injected "
              f"instants ({[i['args']['boundary'] for i in injected]}), "
              f"{len(tr.dumps)} valid flight dumps, resilience.retries="
              f"{int(counters['resilience.retries'])} = stats, "
              f"resilience.checkpoints="
              f"{int(counters.get('resilience.checkpoints', 0))}; forest "
              f"equal to phase C's")
        return {"gather_launches": gather_launches}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------- #
# phase N: the tenant engine

N_SLOTS = 1 << 12  # a tenant tier's capacity class (bench_tenants')
N_CHUNK = 1 << 10
N_EDGES_PER = 1 << 13  # 8 chunks a tenant
N_MERGE_EVERY = 2
N1_TENANTS = (1, 8, 64, 256)
N2_TENANTS = 4096  # x 2^12 slots = 2^24 slots of tier state
N2_SINGLE = 64  # tenants also held to their single-stream runs
N3_SLOTS = 1 << 22
N3_TENANTS = 4
N3_CHUNKS = 4
N5_TENANTS = 64
N5_SUBMITTERS = 4


# Child processes started in the background, stopped on any exit.
_CHILDREN: list = []


def analysis_gate_start():
    """Phase R1: the analysis gate over the port, in a child process on
    this host (which has no JAX), started here and joined by
    :func:`analysis_gate_finish`; it runs on a host core beside the card
    phases that follow."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys, time\n"
            "t = time.perf_counter()\n"
            "from gelly_torch.analysis.__main__ import main\n"
            "rc = main(['--all', 'gelly_torch'])\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert 'gelly_tpu' not in sys.modules, 'gelly_tpu imported'\n"
            "print(f'gate wall {time.perf_counter() - t:.2f} s')\n"
            "sys.exit(rc)\n")
    out = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=here,
                            stdout=out, stderr=subprocess.STDOUT, text=True)
    _CHILDREN.append(proc)
    return proc, out


def analysis_gate_finish(gate) -> None:
    proc, out = gate
    try:
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out.seek(0)
    text = out.read()
    out.close()
    lines = text.strip().splitlines()
    wall = next((ln for ln in lines if ln.startswith("gate wall")),
                "gate wall not printed")
    print(f"phase R1: python -m gelly_torch.analysis --all gelly_torch "
          f"rc={rc} {wall} (in a child process beside phases R2-Q; "
          f"{next((ln for ln in lines if ln.startswith('analysis')), '')})")
    check(rc == 0, "phase R1: the analysis gate failed on the card host:\n"
          + text[-4000:])


class SyncRecorder:
    """Records every synchronizing operation the card reports under
    ``torch.cuda.set_sync_debug_mode("warn")`` at its innermost
    ``gelly_torch/`` frame, and whether ``host_sync`` was on the stack."""

    def __init__(self, torch, pkg_dir: str):
        self.torch = torch
        self.pkg = pkg_dir + os.sep
        self.sites: dict = {}  # (path, line, function) -> count
        self.counted = 0
        self.total = 0

    def _show(self, message, category, filename, lineno, file=None,
              line=None):
        import traceback

        if "synchroniz" not in str(message):
            return self._prev(message, category, filename, lineno, file,
                              line)
        frames = [f for f in traceback.extract_stack()
                  if f.filename.startswith(self.pkg)]
        self.total += 1
        if any(f.name == "host_sync"
               and f.filename.endswith(os.path.join("ops", "unionfind.py"))
               for f in frames):
            self.counted += 1
            key = ("counted", 0, "host_sync")
        elif frames:
            f = frames[-1]
            key = (f.filename, f.lineno, f.name)
        else:
            key = ("outside gelly_torch", 0, "")
        self.sites[key] = self.sites.get(key, 0) + 1

    def __enter__(self):
        import warnings

        self._cw = warnings.catch_warnings()
        self._cw.__enter__()
        warnings.simplefilter("always")
        self._prev = warnings.showwarning
        warnings.showwarning = self._show
        self.torch.cuda.synchronize()
        self.torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        self.torch.cuda.set_sync_debug_mode("default")
        self._cw.__exit__(*exc)
        return False


def _justified_gl(line: str) -> str | None:
    """The GL001-GL003 rule a justified ``# graphlint: disable=`` on
    ``line`` names, or None."""
    import re

    m = re.search(r"#\s*graphlint:\s*disable=([A-Za-z0-9,\s]+?)\s*--\s*\S",
                  line)
    if not m:
        return None
    ids = [x.strip().upper() for x in m.group(1).split(",")]
    hit = [i for i in ids if i in ("GL001", "GL002", "GL003", "ALL")]
    return hit[0] if hit else None


def sync_audit_phase(torch, device, src, dst, labels0) -> dict:
    """Phase R2: each plan over phase 4's first ``R_CHUNKS`` chunks (and
    one 64-tenant round) under the sync debug mode; every reported sync
    inside a device scope must be counted or carry a justified
    suppression. The CC plans' emission must equal phase 4's first
    (``labels0``), the degrees a ``bincount``, the others the same run
    with the mode off. Returns ``{plan: (syncs, host_sync delta)}``."""
    from gelly_torch.analysis import jitlint
    from gelly_torch.core.io import EdgeChunkSource
    from gelly_torch.core.vertices import IdentityVertexTable
    from gelly_torch.engine.tenants import MultiTenantEngine
    from gelly_torch.library import bipartiteness as bp
    from gelly_torch.library import connected_components as cc
    from gelly_torch.library import degrees as deg
    from gelly_torch.ops import kernels, unionfind

    here = os.path.dirname(os.path.abspath(__file__))
    pkg = os.path.join(here, "gelly_torch")
    n_edges = R_CHUNKS * CHUNK
    s4, d4 = src[:n_edges], dst[:n_edges]
    check(R_CHUNKS == MERGE_EVERY, "R2 reads phase 4's first emission")
    degrees = [(np.bincount(s4, minlength=N_VERTICES)
                + np.bincount(d4, minlength=N_VERTICES)).astype(np.int64)]

    def stream_run(make_agg):
        def run():
            stream = edge_stream_from_source(
                EdgeChunkSource(s4, d4, chunk_size=CHUNK,
                                table=IdentityVertexTable(N_VERTICES)),
                N_VERTICES, device=device)
            out = list(stream.aggregate(make_agg(), merge_every=MERGE_EVERY))
            return [to_host(torch, x) for x in out]
        return run

    def tenant_run():
        eng = MultiTenantEngine(merge_every=N_MERGE_EVERY, device=device)
        agg, cap = cc.cc_tenant_tier(N_SLOTS, chunk_capacity=N_CHUNK)
        eng.add_tier("audit", agg, cap)
        for t in range(R_TENANTS):
            s, d = bench_tenant_edges(t)
            eng.admit(t, "audit", chunks=tenant_chunks(
                s[:N_CHUNK], d[:N_CHUNK], N_SLOTS, N_CHUNK))
        out = eng.drain()
        return {k: to_host(torch, v) for k, v in sorted(out.items())}

    from gelly_torch.core.stream import edge_stream_from_source

    # (name, run, what its emissions must equal: None for the same run
    # with the debug mode off)
    plans = (
        ("raw CC plain", stream_run(lambda: cc.connected_components(
            N_VERTICES, merge="gather", ingest_combine=False,
            fold_backend="plain")), [labels0]),
        ("raw CC kernel", stream_run(lambda: cc.connected_components(
            N_VERTICES, merge="gather", ingest_combine=False,
            fold_backend="kernel")), [labels0]),
        ("compact", stream_run(lambda: cc.connected_components(
            N_VERTICES, merge="gather", codec="compact",
            compact_capacity=CC_COMPACT)), [labels0]),
        ("degrees", stream_run(lambda: deg.degree_aggregate(N_VERTICES)),
         degrees),
        ("bipartiteness", stream_run(
            lambda: bp.bipartiteness_check(N_VERTICES)), None),
        (f"tenants x{R_TENANTS}", tenant_run, None),
    )
    t = time.perf_counter()
    spans = jitlint.device_scopes(here, [pkg])
    scope_s = time.perf_counter() - t
    unreported = []
    result = {}
    for name, run, want in plans:
        if want is None:
            want = run()  # the same run, the debug mode off
        torch.cuda.synchronize()
        unionfind.host_sync.count = 0
        reset_launches(kernels)
        with SyncRecorder(torch, pkg) as rec:
            got = run()
        torch.cuda.synchronize()
        check(same_host(got, want),
              f"phase R2 {name}: emissions differ from the reference")
        delta = unionfind.host_sync.count
        result[name] = (rec.total, delta)
        print(f"phase R2 {name}: syncs={rec.total} counted={rec.counted} "
              f"host_sync.count={delta} uncounted={rec.total - rec.counted}")
        # The parity rounds run on the card.
        check(name != "bipartiteness" or delta == 0,
              f"phase R2 {name}: {delta} counted host syncs (want 0)")
        for (path, line, fn), n in sorted(rec.sites.items(),
                                          key=lambda kv: -kv[1]):
            if path in ("counted", "outside gelly_torch"):
                print(f"  {path}: {n}")
                continue
            rel = os.path.relpath(path, here)
            inside = [sp for sp in spans.get(path, ())
                      if sp[0] <= line <= sp[1]]
            if not inside:
                print(f"  {rel}:{line} ({fn}) host x{n}")
                continue
            with open(path) as f:
                text = f.read().splitlines()[line - 1]
            rule = _justified_gl(text)
            scope = inside[-1][2]
            print(f"  {rel}:{line} ({fn}) scope {scope!r} "
                  f"{rule or 'UNREPORTED'} x{n}")
            if rule is None:
                unreported.append(f"{rel}:{line} ({name}, scope {scope!r})")
    print(f"phase R2: device scopes of {len(spans)} modules in "
          f"{scope_s:.2f} s; {len(unreported)} unreported sync lines")
    check(not unreported, "phase R2: syncs inside device scopes that the "
          "analysis reports nothing at: " + ", ".join(unreported))
    return result


def same_host(a, b) -> bool:
    """Equal host emissions: arrays (dtype included), scalars, and lists,
    tuples and dicts of them."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same_host(a[k], b[k]) for k in a))
    if isinstance(a, (tuple, list)):
        return (isinstance(b, (tuple, list)) and len(a) == len(b)
                and all(same_host(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    return a == b


def to_host(torch, x):
    """An emission on the host (tensors to numpy, trees walked)."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if isinstance(x, dict):
        return {k: to_host(torch, v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_host(torch, v) for v in x) \
            if not hasattr(x, "_fields") else type(x)(
                *(to_host(torch, v) for v in x))
    return x


def tenant_chunks(src, dst, n: int, chunk: int) -> list:
    """Identity-slot host chunks of one tenant's stream."""
    from gelly_torch.core.chunk import make_chunk

    return [make_chunk(src[i:i + chunk], dst[i:i + chunk],
                       raw_src=src[i:i + chunk].astype(np.int64),
                       raw_dst=dst[i:i + chunk].astype(np.int64),
                       capacity=chunk, device=None)
            for i in range(0, src.shape[0], chunk)]


def bench_tenant_edges(t: int):
    """``bench.py:_tenant_chunks``' stream of tenant ``t`` (seed 1000 + t)."""
    rng = np.random.default_rng(1000 + t)
    src = rng.integers(0, N_SLOTS, N_EDGES_PER).astype(np.int32)
    dst = rng.integers(0, N_SLOTS, N_EDGES_PER).astype(np.int32)
    return src, dst


def single_stream(torch, device, agg, src, dst, n: int, chunk: int,
                  merge_every: int = N_MERGE_EVERY):
    """A tenant's single-stream ``run_aggregation`` pass: its emissions
    on the host."""
    from gelly_torch.core.io import EdgeChunkSource
    from gelly_torch.core.stream import edge_stream_from_source
    from gelly_torch.core.vertices import IdentityVertexTable

    stream = edge_stream_from_source(
        EdgeChunkSource(src, dst, chunk_size=chunk,
                        table=IdentityVertexTable(n)), n, device=device)
    return [x.cpu().numpy()
            for x in stream.aggregate(agg, merge_every=merge_every)]


def count_lane_folds(agg):
    """Wrap the plan's lane-batched fold with a call counter and a host
    clock (before any tier plan is built from it; the fold ends in its
    fixpoint's host sync); returns ``[calls, seconds]``."""
    form = agg.lane_form
    calls = [0, 0.0]

    def counted(state, chunk):
        calls[0] += 1
        t = time.perf_counter()
        out = form.fold(state, chunk)
        calls[1] += time.perf_counter() - t
        return out

    agg.lane_form = form._replace(fold=counted)
    return calls


def time_calls(obj, name: str) -> list:
    """Wrap the method ``name`` of ``obj`` with a host clock; returns
    ``[seconds]`` spent in it."""
    fn = getattr(obj, name)
    spent = [0.0]

    def timed(*args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        spent[0] += time.perf_counter() - t
        return out

    setattr(obj, name, timed)
    return spent


def drain_timed(torch, device, eng):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = eng.drain()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def tenant_phase(torch, device) -> dict:
    """Phase N. Returns the gather's launches in N3 and N2's numbers,
    streams and final labels (phase P5 sends N2's streams over the wire)."""
    from gelly_torch import obs
    from gelly_torch.engine.qos import QOS_PARKED, QosController, QosPolicy
    from gelly_torch.engine.tenants import MultiTenantEngine
    from gelly_torch.library.connected_components import cc_tenant_tier
    from gelly_torch.ops import kernels

    def engine(**kw):
        return MultiTenantEngine(merge_every=N_MERGE_EVERY, device=device,
                                 **kw)

    # N1. bench_tenants' sweep: the batched engine against N single-stream
    # passes over the same plan.
    agg, cap = cc_tenant_tier(N_SLOTS, chunk_capacity=N_CHUNK)
    folds = count_lane_folds(agg)
    rounds = N_EDGES_PER // N_CHUNK
    n1_labels = {}
    for n_t in N1_TENANTS:
        edges = [bench_tenant_edges(t) for t in range(n_t)]
        eng = engine()
        eng.add_tier("bench", agg, cap)
        for t, (s, d) in enumerate(edges):
            eng.admit(t, "bench",
                      chunks=tenant_chunks(s, d, N_SLOTS, N_CHUNK))
        folds[0] = 0
        with obs.scope() as bus:
            out, batched_s = drain_timed(torch, device, eng)
        plan = eng._tiers["bench"].batch.plan
        torch.cuda.synchronize()
        t = time.perf_counter()
        seq = [single_stream(torch, device, agg, s, d, N_SLOTS,
                             N_CHUNK)[-1] for s, d in edges]
        seq_s = time.perf_counter() - t
        total = n_t * N_EDGES_PER
        print(f"phase N1 N={n_t}: batched {total / batched_s:.1f} edges/s "
              f"wall={batched_s:.4f} s, sequential {total / seq_s:.1f} "
              f"edges/s wall={seq_s:.4f} s, ratio {seq_s / batched_s:.3f} "
              f"dispatches={eng.stats['dispatches']} "
              f"lane_batched_folds={folds[0]} lanes={plan.lanes} "
              f"form={plan.forms['fold']}")
        check(eng.stats["dispatches"] == rounds
              and bus.counters["tenants.dispatches"] == rounds,
              f"N1 N={n_t}: {eng.stats['dispatches']} dispatches")
        check(plan.forms["fold"] == "lane-batched" and folds[0] == rounds,
              f"N1 N={n_t}: {folds[0]} batched folds ({plan.forms})")
        for t in range(n_t):
            check(same(out[t], seq[t]),
                  f"N1 N={n_t}: tenant {t} != its single-stream run")
        if n_t == N5_TENANTS:
            n1_labels = {t: out[t] for t in range(n_t)}
        del eng, out, seq

    # N2. Full width: 4096 tenants x 2^12 slots, 8 Zipf chunks each.
    t0 = time.perf_counter()
    edges = [synth_edges(N_EDGES_PER, N_SLOTS, 17 + t)
             for t in range(N2_TENANTS)]
    chunks = [tenant_chunks(s, d, N_SLOTS, N_CHUNK) for s, d in edges]
    print(f"phase N2 streams: {N2_TENANTS} tenants x {N_EDGES_PER} Zipf "
          f"edges in {time.perf_counter() - t0:.2f} s")
    agg2, _ = cc_tenant_tier(N_SLOTS, chunk_capacity=N_CHUNK)
    folds2 = count_lane_folds(agg2)
    def n2_engine(a):
        eng = engine()
        eng.add_tier("full", a, N_CHUNK)
        for t in range(N2_TENANTS):
            eng.admit(t, "full", chunks=chunks[t])
        return eng

    eng = n2_engine(agg2)
    # The wall's parts: pulls (each tenant's next chunk normalized on the
    # host), staging (host stack, pinned buffer, one H2D copy), the
    # lane-batched folds, the rest (window closes, queries, bookkeeping).
    pulls2 = time_calls(eng, "_pull_sources")
    staging2 = time_calls(eng._tiers["full"].batch, "stage")
    snaps2 = []
    close = eng._close_window

    def record(tier, bus, tracer):
        close(tier, bus, tracer)
        snaps2.append(tier.snapshot)

    eng._close_window = record
    torch.cuda.reset_peak_memory_stats(device)
    with obs.scope() as bus, obs.record_metrics():
        out2, wall2 = drain_timed(torch, device, eng)
        p50 = bus.quantile("tenants.round_ms", 0.5)
        p99 = bus.quantile("tenants.round_ms", 0.99)
    peak2 = torch.cuda.max_memory_allocated(device)
    plan2 = eng._tiers["full"].batch.plan
    total2 = N2_TENANTS * N_EDGES_PER
    print(f"phase N2: {N2_TENANTS} tenants x {N_SLOTS} slots = "
          f"{N2_TENANTS * N_SLOTS} slots, {total2} edges: "
          f"{total2 / wall2:.1f} edges/s wall={wall2:.4f} s "
          f"round_ms p50={p50:.3f} p99={p99:.3f} peak_mem={peak2} B "
          f"dispatches={eng.stats['dispatches']} "
          f"lane_batched_folds={folds2[0]} form={plan2.forms['fold']} "
          f"staged H2D copies={eng._tiers['full'].batch._stager.copies} "
          f"bytes={eng._tiers['full'].batch._stager.bytes}; of the wall: "
          f"pulls {pulls2[0]:.4f} s, staging {staging2[0]:.4f} s, "
          f"lane-batched folds {folds2[1]:.4f} s")
    check(eng.stats["dispatches"] == rounds, "N2: dispatches")
    check(plan2.forms["fold"] == "lane-batched" and folds2[0] == rounds,
          f"N2: {folds2[0]} batched folds ({plan2.forms})")
    check(len(snaps2) == rounds // N_MERGE_EVERY, f"N2: {len(snaps2)} "
          "window snapshots")
    got2 = np.stack([out2[t] for t in range(N2_TENANTS)])
    check(got2.dtype == np.int32 and got2.shape == (N2_TENANTS, N_SLOTS),
          f"N2: {got2.dtype} {got2.shape}")
    t0 = time.perf_counter()
    off = (np.arange(N2_TENANTS, dtype=np.int64) * N_SLOTS)
    flat_src = np.concatenate([s + off[t] for t, (s, _) in enumerate(edges)])
    flat_dst = np.concatenate([d + off[t] for t, (_, d) in enumerate(edges)])
    oracle = scipy_oracle(flat_src.astype(np.int64),
                          flat_dst.astype(np.int64), N2_TENANTS * N_SLOTS)
    oracle = oracle.reshape(N2_TENANTS, N_SLOTS)
    oracle = np.where(oracle >= 0, oracle - off[:, None].astype(np.int32),
                      -1).astype(np.int32)
    check(np.array_equal(got2, oracle), "N2: labels != scipy's")
    print(f"phase N2 oracle: every tenant equal to scipy (one call over "
          f"the lane-offset graph) in {time.perf_counter() - t0:.2f} s")
    del flat_src, flat_dst, oracle
    for t in range(N2_SINGLE):
        s, d = edges[t]
        want = single_stream(torch, device, agg2, s, d, N_SLOTS, N_CHUNK)
        check(same(out2[t], want[-1]),
              f"N2: tenant {t} != its single-stream run")
    del eng, out2

    # N4. N2's tenants through the sparse codec tier, compressed on the
    # submitter's side before the timed window.
    agg4, cap4 = cc_tenant_tier(N_SLOTS, chunk_capacity=N_CHUNK,
                                compressed=True, codec="sparse")
    t0 = time.perf_counter()
    payloads = [[agg4.host_compress(c) for c in cs] for cs in chunks]
    compress_s = time.perf_counter() - t0
    wire = sum(p["v"].nbytes + p["r"].nbytes
               for ps in payloads for p in ps)
    eng = engine()
    eng.add_tier("codec", agg4, cap4, compressed=True)
    snaps4 = []
    close4 = eng._close_window

    def record4(tier, bus, tracer):
        close4(tier, bus, tracer)
        snaps4.append(tier.snapshot)

    eng._close_window = record4
    t0 = time.perf_counter()
    for t in range(N2_TENANTS):
        eng.admit(t, "codec")
        for p in payloads[t]:
            eng.submit_payload(t, p)
        eng.finish(t)
    submit_s = time.perf_counter() - t0
    with obs.scope() as bus:
        out4, wall4 = drain_timed(torch, device, eng)
        counters = dict(bus.counters)
    plan4 = eng._tiers["codec"].batch.plan
    print(f"phase N4: {total2} edges {total2 / wall4:.1f} edges/s "
          f"wall={wall4:.4f} s (host compress {compress_s:.2f} s and "
          f"submit {submit_s:.2f} s before it) wire "
          f"{wire / total2:.4f} B/edge "
          f"compressed_dispatches={counters.get('tenants.compressed_dispatches')}"
          f" form={plan4.forms['fold_codec']}")
    check(counters.get("tenants.compressed_dispatches")
          == counters.get("tenants.dispatches") == rounds,
          f"N4: counters {counters}")
    check(plan4.forms["fold_codec"] == "lane-batched", f"N4: {plan4.forms}")
    check(len(snaps4) == len(snaps2) and all(
        torch.equal(a, b) for a, b in zip(snaps2, snaps4)),
        "N4: a window snapshot != N2's")
    del eng, out4, payloads, snaps2, snaps4, chunks
    torch.cuda.empty_cache()

    # N3. The kernel tier: 4 tenants over 2^22 slots in 2^22-edge chunks,
    # the dedup fold lane by lane, its gather counted.
    agg3, cap3 = cc_tenant_tier(N3_SLOTS, chunk_capacity=N3_SLOTS,
                                fold_backend="kernel")
    plain3, _ = cc_tenant_tier(N3_SLOTS, chunk_capacity=N3_SLOTS)
    edges3 = [synth_edges(N3_CHUNKS * N3_SLOTS, N3_SLOTS, 100 + t)
              for t in range(N3_TENANTS)]
    unique_cap = max(1 << 20, 3 * (N3_SLOTS >> 4))
    dedup3 = 0
    for s, d in edges3:
        for lo in range(0, s.shape[0], N3_SLOTS):
            a = torch.from_numpy(s[lo:lo + N3_SLOTS]).to(device).long()
            b = torch.from_numpy(d[lo:lo + N3_SLOTS]).to(device).long()
            key = (torch.minimum(a, b) << 32) | torch.maximum(a, b)
            dedup3 += int(torch.unique(key).numel()) <= unique_cap
    eng = engine()
    eng.add_tier("kernel", agg3, cap3)
    for t, (s, d) in enumerate(edges3):
        eng.admit(t, "kernel", chunks=tenant_chunks(s, d, N3_SLOTS,
                                                    N3_SLOTS))
    reset_launches(kernels)
    out3, wall3 = drain_timed(torch, device, eng)
    launches3 = kernels.sorted_window_gather.launches
    plan3 = eng._tiers["kernel"].batch.plan
    total3 = N3_TENANTS * N3_CHUNKS * N3_SLOTS
    print(f"phase N3: {N3_TENANTS} tenants x {N3_SLOTS} slots, {total3} "
          f"edges in {N3_SLOTS}-edge chunks: {total3 / wall3:.1f} edges/s "
          f"wall={wall3:.4f} s gather_launches={launches3} (3 x "
          f"{dedup3} dedup lane-chunks, counted apart) "
          f"form={plan3.forms['fold']}")
    check(plan3.forms["fold"] == "lane-by-lane", f"N3: {plan3.forms}")
    check(launches3 > 0 and launches3 == 3 * dedup3,
          f"N3: {launches3} launches != 3 x {dedup3} dedup lane-chunks")
    for t, (s, d) in enumerate(edges3):
        want_k = single_stream(torch, device, agg3, s, d, N3_SLOTS, N3_SLOTS)
        want_p = single_stream(torch, device, plain3, s, d, N3_SLOTS,
                               N3_SLOTS)
        check(same(out3[t], want_k[-1]) and same(out3[t], want_p[-1]),
              f"N3: tenant {t} != its single-stream kernel / plain run")
    del eng, out3, edges3
    torch.cuda.empty_cache()

    # N5. Serving, durability and QoS at 64 tenants of N1's tier.
    edges5 = {t: bench_tenant_edges(t) for t in range(N5_TENANTS)}
    chunks5 = {t: tenant_chunks(s, d, N_SLOTS, N_CHUNK)
               for t, (s, d) in edges5.items()}
    # Every label row a tenant's snapshot may hold: its prefix after j
    # chunks, j = 0..8 (emissions a chunk of its single-stream run).
    empty = np.full(N_SLOTS, -1, np.int32).tobytes()
    prefixes = {t: {empty} | {x.tobytes() for x in single_stream(
        torch, device, agg, s, d, N_SLOTS, N_CHUNK, merge_every=1)}
        for t, (s, d) in edges5.items()}
    # (a) serving mode: 4 submitter threads, 1 querying thread.
    import threading

    eng = engine()
    eng.add_tier("serve", agg, cap)
    for t in range(N5_TENANTS):
        eng.admit(t, "serve")
    # The querying thread's tally: answers, non-empty ones, answers no
    # snapshot made, and per tenant the last window it saw (never back).
    tally = {"answers": 0, "rows": 0, "stale": 0, "backwards": 0}
    errors = []
    done = threading.Event()

    def submitter(k):
        try:
            for t in range(k, N5_TENANTS, N5_SUBMITTERS):
                for c in chunks5[t]:
                    eng.submit(t, c)
                eng.finish(t)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    def querier():
        rng = np.random.default_rng(5)
        last = {}
        try:
            while not done.is_set():
                t = int(rng.integers(0, N5_TENANTS))
                w = eng.snapshot_window(t)
                row = eng.labels(t)
                time.sleep(0.0002)  # a query stream, not a spin on the GIL
                tally["answers"] += 1
                tally["backwards"] += w < last.get(t, 0)
                last[t] = w
                if row is not None:
                    tally["rows"] += 1
                    tally["stale"] += row.tobytes() not in prefixes[t]
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=submitter, args=(k,))
               for k in range(N5_SUBMITTERS)]
    threads.append(threading.Thread(target=querier))
    t0 = time.perf_counter()
    eng.start()
    try:
        for th in threads:
            th.start()
        for th in threads[:-1]:
            th.join(120)
        deadline = time.time() + 120
        while time.time() < deadline and not (
                all(r["done"] for r in eng.telemetry().values())
                and eng._tiers["serve"].chunks_in_window == 0):
            time.sleep(0.01)
    finally:
        done.set()
        threads[-1].join(30)
        eng.stop()
    serve_s = time.perf_counter() - t0
    check(not errors, f"N5a: {errors[:3]}")
    check(tally["rows"] > 0 and tally["stale"] == 0
          and tally["backwards"] == 0, f"N5a: querying thread {tally}")
    for t in range(N5_TENANTS):
        check(same(eng.labels(t), n1_labels[t]),
              f"N5a: tenant {t} != N1's after stop()")
    print(f"phase N5a: serving {N5_TENANTS} tenants from "
          f"{N5_SUBMITTERS} submitter threads in {serve_s:.3f} s, "
          f"{tally['answers']} answers from the querying thread "
          f"({tally['rows']} non-empty), each one a snapshot made; labels "
          f"equal N1's")
    del eng
    # (b) stop after window 2 with per-tenant checkpoints, resume.
    tmp = tempfile.mkdtemp(prefix="gelly-tenants-")
    try:
        eng = engine(checkpoint_dir=tmp, checkpoint_every=1)
        eng.add_tier("durable", agg, cap)
        for t in range(N5_TENANTS):
            eng.admit(t, "durable", chunks=chunks5[t][:2 * N_MERGE_EVERY])
        eng.drain()
        check(eng.stats["windows_closed"] == 2, "N5b: windows before stop")
        del eng
        t0 = time.perf_counter()
        eng = engine(checkpoint_dir=tmp, checkpoint_every=1, resume=True)
        eng.add_tier("durable", agg, cap)
        for t in range(N5_TENANTS):
            eng.admit(t, "durable", chunks=chunks5[t])
        out5 = eng.drain()
        resume_s = time.perf_counter() - t0
        check(eng.stats["chunks"] == N5_TENANTS * (rounds
                                                   - 2 * N_MERGE_EVERY),
              f"N5b: the resumed engine folded {eng.stats['chunks']}")
        for t in range(N5_TENANTS):
            check(same(out5[t], n1_labels[t]),
                  f"N5b: tenant {t} resumed != uninterrupted")
        print(f"phase N5b: stopped after window 2, {N5_TENANTS} "
              f"per-tenant rotations resumed in a new engine in "
              f"{resume_s:.3f} s; labels equal the uninterrupted run's")
        del eng
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # (c) a QosController parks one tenant and unparks it.
    victim = 0
    pol = QosPolicy(backlog_budget_s=0.5, limit_after=1, park_after=1,
                    unpark_below_s=0.25, unpark_grace_s=0.0)
    qos = QosController(default=QosPolicy(), eval_every_s=0.01,
                        per_tenant={victim: pol})

    def wait(pred, timeout=60.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and not pred():
            time.sleep(0.005)
        return pred()

    with obs.scope() as bus:
        ages = {}
        bus.watermarks.backlog_age = lambda tid: ages.get(tid, 0.0)
        eng = engine(qos=qos, poll_s=0.005)
        eng.add_tier("qos", agg, cap)
        for t in range(N5_TENANTS):
            eng.admit(t, "qos")
        eng.start()
        try:
            for t in range(N5_TENANTS):
                for c in chunks5[t][:2]:
                    eng.submit(t, c)
            check(wait(lambda: all(eng.position(t) == 2
                                   for t in range(N5_TENANTS))),
                  "N5c: the first two rounds")
            ages.update({victim: 10.0, 1: 10.0})
            check(wait(lambda: eng.qos_state(victim) == QOS_PARKED
                       and eng._tenants[victim].lane == -1),
                  "N5c: the victim was not parked")
            parked_row = eng.labels(victim)
            check(parked_row is not None
                  and parked_row.tobytes() in prefixes[victim],
                  "N5c: the parked row is not a snapshot of the victim")
            eng.submit(victim, chunks5[victim][2])
            ages.update({victim: 0.0, 1: 0.0})
            check(wait(lambda: eng.qos_state(victim) != QOS_PARKED
                       and eng._tenants[victim].lane >= 0),
                  "N5c: the victim was not unparked")
            for t in range(N5_TENANTS):
                for c in chunks5[t][3 if t == victim else 2:]:
                    eng.submit(t, c)
                eng.finish(t)
            check(wait(lambda: all(
                eng.labels(t) is not None
                and same(eng.labels(t), n1_labels[t])
                for t in range(N5_TENANTS))),
                "N5c: labels after park and unpark != N1's")
        finally:
            eng.stop()
        print(f"phase N5c: tenant {victim} parked (lane freed) and "
              f"unparked; qos.parked={bus.counters.get('qos.parked')} "
              f"qos.unparked={bus.counters.get('qos.unparked')}; all "
              f"{N5_TENANTS} tenants' labels equal N1's")
    torch.cuda.empty_cache()
    return {"gather_launches": launches3, "dedup_lane_chunks": dedup3,
            "n2_wall_s": wall2, "n2_round_ms": (p50, p99),
            "n2_edges": edges, "n2_labels": got2}


# Phase P: ingest (the sharded readers, the native text parser, the wire
# into the kernel CC fold, the compressed wire, a SIGKILLed server, the
# tenant wire, one traced wire run).
P_FRAME = 1 << 21  # raw wire frame: 2^21 edges, 32 MiB of <i8 pairs
P_WIRE_CHUNK = CHUNK  # srv.chunks capacity: the dedup fold's class
P_MERGE_EVERY = 8  # 2^21-edge chunks: phase 4's 2^24-edge windows
P1_SHARDS = 4
P1_TEXT_EDGES = 1 << 20
P3_STACK = 4
P4_FRAMES = 8  # phase 4's first 2^24 edges
P4_EVERY = 2  # a checkpoint and an ack every 2 frames
P4_UNIT_SLEEP_S = 1.0  # the first child's pause after each emission
P5_ACK_TENANTS = 64  # checkpoint-gated acks: N5's scale
P6_EDGES = 1 << 23


def dedup_frames(n_edges: int, frame: int, capacity: int) -> list:
    """Independently of the fold: whether each ``frame``-edge chunk of
    ``capacity`` lanes takes the raw plan's dedup fold (capacity >=
    ``RAW_DEDUP_MIN_CHUNK``; its gathers run whether or not the distinct
    pairs fit the unique cap)."""
    from gelly_torch.library import connected_components as cc

    return [capacity >= cc.RAW_DEDUP_MIN_CHUNK
            for _ in range(0, n_edges, frame)]


def wire_cc_plan():
    from gelly_torch.library import connected_components as cc

    return cc.connected_components(N_VERTICES, merge="gather",
                                   ingest_combine=False, fold_backend="kernel")


def raw_wire_run(torch, device, src, dst, n_edges: int, tracer=None,
                 probe_stats: bool = False) -> dict:
    """Phase 4's first ``n_edges`` edges as raw ``2^21``-edge DATA frames
    from an ``IngestClient`` thread to an ``IngestServer`` on loopback,
    folded by ``run_aggregation(kernel plan, srv.chunks(2^22, 2^24),
    merge_every=8)``; the launch counts set to 0 just before it."""
    import threading

    from gelly_torch import obs
    from gelly_torch.engine.aggregation import run_aggregation
    from gelly_torch.ingest import IngestClient, IngestServer, edge_payload
    from gelly_torch.obs.status import fetch_stats
    from gelly_torch.ops import kernels

    agg = wire_cc_plan()
    errors: list = []
    with contextlib.ExitStack() as scope:
        bus = scope.enter_context(obs.scope())
        if tracer is not None:
            scope.enter_context(obs.install(tracer))
        srv = IngestServer(queue_depth=8, stop_on_bye=True).start()

        def feed():
            try:
                with IngestClient("127.0.0.1", srv.port,
                                  send_pause_timeout=300) as cli:
                    for lo in range(0, n_edges, P_FRAME):
                        cli.send(edge_payload(src[lo:lo + P_FRAME],
                                              dst[lo:lo + P_FRAME]))
                    cli.flush(timeout=300)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors.append(e)
                srv.stop()  # ends the consumer's iterator: no hang

        th = threading.Thread(target=feed, name="p-client", daemon=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        reset_launches(kernels)
        t = time.perf_counter()
        th.start()
        res = run_aggregation(agg, srv.chunks(P_WIRE_CHUNK, N_VERTICES),
                              merge_every=P_MERGE_EVERY)
        outs, stats = [], None
        for out in res:
            outs.append(out.cpu().numpy())
            if probe_stats and stats is None:
                # Mid-stream, on a dedicated connection.
                stats = fetch_stats("127.0.0.1", srv.port, timeout=60)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = kernels.sorted_window_gather.launches
        th.join(120)
        srv.stop()
        counters = dict(bus.counters)
    check(not errors, f"wire client: {errors[:1]}")
    busy = res.timer.busy()
    return {"outs": outs, "wall_s": wall, "launches": launches,
            "stats": stats, "counters": counters, "busy": busy,
            "peak": torch.cuda.max_memory_allocated(device)}


def ingest_child(directory: str) -> int:
    """Phase P4's child: an ``IngestServer(auto_ack=False)`` resuming at
    its checkpoint feeding the kernel CC plan (``merge_every=2``, a
    checkpoint a window); a thread acks the checkpoint's position. Writes
    its emissions' (time, chunks, launches) as it goes and, at the end,
    its final labels and parts."""
    import itertools
    import threading

    import torch

    with open(os.path.join(directory, "run.json")) as f:
        cfg = json.load(f)
    device = torch.device(cfg["device"])
    torch.cuda.set_device(device)
    torch.zeros(1, device=device)
    torch.cuda.synchronize()
    t_cuda = time.time()
    from gelly_torch import obs
    from gelly_torch.engine.aggregation import run_aggregation
    from gelly_torch.engine.checkpoint import (
        CheckpointCorruptError,
        read_checkpoint_header,
        save_checkpoint,
    )
    from gelly_torch.ingest import IngestServer
    from gelly_torch.ops import kernels

    ckpt = os.path.join(directory, "ck.npz")
    resume = os.path.exists(ckpt)
    pos = int(read_checkpoint_header(ckpt)["position"]) if resume else 0
    # The bus is scoped before the server listens: the client may send,
    # and the server enqueue, before the engine starts.
    scope = contextlib.ExitStack()
    bus = scope.enter_context(obs.scope())
    srv = IngestServer(auto_ack=False, resume_seq=pos, queue_depth=4,
                       stop_on_bye=True).start()
    tmp = os.path.join(directory, "port.tmp")
    with open(tmp, "w") as f:
        f.write(str(srv.port))
    os.replace(tmp, os.path.join(directory, "port"))
    t_listen = time.time()
    stop = threading.Event()

    def acker():
        while not stop.is_set():
            if os.path.exists(ckpt):
                try:
                    srv.ack(int(read_checkpoint_header(ckpt)["position"]))
                except (CheckpointCorruptError, OSError):
                    pass  # mid-replace: the next tick reads the new file
            time.sleep(0.01)

    th = threading.Thread(target=acker, daemon=True)
    th.start()
    # The wire resumed the sequence (resume_seq): placeholders stand for
    # the folded prefix the engine's resume drops unread.
    stream = itertools.chain([object()] * pos,
                             srv.chunks(P_WIRE_CHUNK, N_VERTICES))
    reset_launches(kernels)
    records: list = []
    log = os.path.join(directory, f"child-{os.getpid()}.json")
    with scope:
        res = run_aggregation(wire_cc_plan(), stream, merge_every=P4_EVERY,
                              checkpoint_path=ckpt, checkpoint_every=1,
                              resume=resume)
        last = None
        try:
            for out in res:
                last = out.cpu().numpy()
                records.append({"t": time.time(),
                                "chunks": res.stats["chunks"],
                                "launches":
                                    kernels.sorted_window_gather.launches})
                with open(log + ".tmp", "w") as f:
                    json.dump(records, f)
                os.replace(log + ".tmp", log)
                if cfg["sleep_s"]:
                    time.sleep(cfg["sleep_s"])
        finally:
            stop.set()
            srv.stop()
        th.join(5)
        counters = dict(bus.counters)
    hdr = read_checkpoint_header(ckpt)
    srv.ack(int(hdr["position"]))
    busy = res.timer.busy()
    parts = {
        "resumed_at": res.stats["resumed_at"],
        "chunks": res.stats["chunks"],
        "units": res.stats["units"],
        "enqueued": counters.get("ingest.chunks_enqueued", 0),
        "duplicates": counters.get("ingest.frames_duplicate", 0),
        "launches": kernels.sorted_window_gather.launches,
        "spawned_at": cfg["spawned_at"],
        "cuda_at": t_cuda,
        "listen_at": t_listen,
        "first_emission_at": records[0]["t"] if records else None,
        "resume_load_s": busy.get("resume_load"),
        "checkpoint_s": busy.get("checkpoint"),
    }
    save_checkpoint(os.path.join(directory, "final.npz"),
                    {"labels": last}, position=int(hdr["position"]),
                    meta=parts)
    print(json.dumps({"ingest_child": parts}))
    return 0


def ingest_client(directory: str) -> int:
    """Phase P5's client process (``--ingest-client <dir>``): streams the
    tenants of ``<dir>/edges.npz`` to the port in ``<dir>/run.json`` over
    one ``tenant_streams`` connection, each tenant's 8 chunks in one
    STACKED frame, then flushes and prints its acks as one JSON line."""
    from gelly_torch.ingest import IngestClient, edge_payload

    with open(os.path.join(directory, "run.json")) as f:
        cfg = json.load(f)
    data = np.load(os.path.join(directory, "edges.npz"))
    src, dst = data["src"], data["dst"]
    rounds = src.shape[1] // N_CHUNK
    t = time.perf_counter()
    with IngestClient("127.0.0.1", cfg["port"], tenant_streams=True,
                      stack=rounds, send_pause_timeout=300) as cli:
        for tid in range(cfg["tenants"]):
            for k in range(rounds):
                lo, hi = k * N_CHUNK, (k + 1) * N_CHUNK
                cli.send(edge_payload(src[tid, lo:hi], dst[tid, lo:hi]),
                         tenant=tid)
        cli.flush(timeout=600)
        acked = sum(cli.acked_for(tid) for tid in range(cfg["tenants"]))
    print(json.dumps({"ingest_client": {
        "acked": acked, "send_s": time.perf_counter() - t}}))
    return 0


def ingest_phase(torch, device, src, dst, labels, oracle, dedup_flags,
                 n2: dict) -> dict:
    """Phase P. Returns the gather's launches in P1, P2 and P4."""
    import threading

    from gelly_torch import obs
    from gelly_torch.core import io as tio
    from gelly_torch.engine.aggregation import run_aggregation
    from gelly_torch.engine.checkpoint import load_checkpoint
    from gelly_torch.engine.tenants import MultiTenantEngine
    from gelly_torch.ingest import (
        IngestClient,
        IngestServer,
        TenantRouter,
        edge_payload,
        edge_stream_from_sharded_file,
        write_binary_edges,
    )
    from gelly_torch.ingest.readers import rr_order
    from gelly_torch.library import connected_components as cc
    from gelly_torch.ops import kernels
    from gelly_torch.utils import native

    launches: dict = {}
    tmp = tempfile.mkdtemp(prefix="gelly-ingest-")
    p1 = None
    try:
        # P4's first server process, started now: its CUDA start overlaps
        # P1-P3 (only the restarted one's is in the time to recover).
        d4 = os.path.join(tmp, "p4")
        os.makedirs(d4)
        here = os.path.abspath(__file__)

        def spawn(sleep_s):
            with open(os.path.join(d4, "run.json"), "w") as f:
                json.dump({"sleep_s": sleep_s, "spawned_at": time.time(),
                           "device": str(device)}, f)
            return subprocess.Popen(
                [sys.executable, here, "--ingest-child", d4],
                stdout=subprocess.PIPE, text=True)

        def wait_port(p):
            deadline = time.monotonic() + CHILD_TIMEOUT_S
            pf = os.path.join(d4, "port")
            while time.monotonic() < deadline:
                if p.poll() is not None:
                    raise RuntimeError(f"P4 child exited rc={p.returncode}")
                if os.path.exists(pf):
                    return int(open(pf).read())
                time.sleep(0.02)
            raise RuntimeError("P4 child never published its port")

        p1 = spawn(P4_UNIT_SLEEP_S)

        # P1. Sharded readers over phase 4's stream as a binary file.
        path = os.path.join(tmp, "edges.bin")
        t0 = time.perf_counter()
        write_binary_edges(path, src, dst)
        write_s = time.perf_counter() - t0
        stream = edge_stream_from_sharded_file(
            path, N_VERTICES, shards=P1_SHARDS, chunk_size=CHUNK)
        counts = stream.source.shard_counts()
        firsts = [sum(counts[:s]) for s in range(P1_SHARDS)]
        nth = [0] * P1_SHARDS
        order = []
        for s in rr_order(counts):  # the provider's unit order (batch 1)
            order.append(firsts[s] + nth[s])
            nth[s] += 1
        check(sorted(order) == list(range(len(dedup_flags))),
              f"P1: reader chunks {order} are not phase 4's")
        expect1 = 3 * sum(dedup_flags[g] for g in order)
        tracer = obs.SpanTracer(capacity=1 << 16, heartbeat_every_s=None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        reset_launches(kernels)
        t = time.perf_counter()
        with obs.scope(), obs.install(tracer):
            res = stream.aggregate(wire_cc_plan(), merge_every=MERGE_EVERY,
                                   source_provider=True)
            outs1 = [x.cpu().numpy() for x in res]
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t
        launches["P1"] = kernels.sorted_window_gather.launches
        peak1 = torch.cuda.max_memory_allocated(device)
        tracks: dict = {}
        for sp in tracer.spans("compress"):
            n, busy = tracks.get(sp["thread"], (0, 0.0))
            tracks[sp["thread"]] = (n + 1, busy + sp["dur"])
        check(np.array_equal(outs1[-1], labels[-1])
              and np.array_equal(outs1[-1], oracle),
              "P1: final labels != phase 4's")
        check(launches["P1"] == expect1 and launches["P1"] > 0,
              f"P1: {launches['P1']} gather launches != {expect1} (3 a "
              f"dedup chunk, in the provider's order)")
        check(sorted(tracks) == [f"gelly-reader_{s}"
                                 for s in range(P1_SHARDS)],
              f"P1: compress tracks {sorted(tracks)}")
        check(tracer.spans("produce") == [], "P1: a produce span")
        print(f"phase P1: {N_EDGES} edges from {P1_SHARDS} reader lanes "
              f"(file {os.path.getsize(path)} B written in {write_s:.2f} s; "
              f"{filesystem_of(path)}): {N_EDGES / wall1:.1f} edges/s "
              f"wall={wall1:.4f} s peak_mem={peak1} B "
              f"gather_launches={launches['P1']} (3 x "
              f"{expect1 // 3} dedup chunks in the provider's order "
              f"{order}); final labels equal phase 4's; tracks " + ", ".join(
                  f"compress/{k}: {n} units {b:.4f} s busy"
                  for k, (n, b) in sorted(tracks.items())))
        del outs1, res, stream
        os.unlink(path)
        # P1. The native text parser on phase 4's first 2^20 edges.
        tpath = os.path.join(tmp, "edges.txt")
        n_text = P1_TEXT_EDGES
        with open(tpath, "w") as f:
            f.write("% phase P1\n")
            f.write("\n".join(f"{a} {b}" for a, b in zip(
                src[:n_text].tolist(), dst[:n_text].tolist())))
            f.write("\n")
        ran_native = native.available("edgelist_parser")
        t0 = time.perf_counter()
        ns, nd = native.parse_edge_list_file(tpath)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with open(tpath) as f:
            ps, pd, _ = tio.parse_edge_list_text(f.read())
        python_s = time.perf_counter() - t0
        calls = []
        real = native.parse_edge_list_file

        def spy(p, want_vals=False):
            calls.append(p)
            return real(p, want_vals=want_vals)

        native.parse_edge_list_file = spy
        try:
            rs, rd, _ = tio.read_edge_list(tpath)
        finally:
            native.parse_edge_list_file = real
        check(ran_native and calls == [tpath],
              "P1: read_edge_list did not take the native parser")
        check(np.array_equal(ns, ps) and np.array_equal(nd, pd)
              and np.array_equal(rs, ns) and np.array_equal(ns, src[:n_text])
              and np.array_equal(nd, dst[:n_text]),
              "P1: the native parse != parse_edge_list_text")
        print(f"phase P1 parser: {n_text} edges, native "
              f"parse_edge_list_file {native_s:.4f} s, "
              f"parse_edge_list_text {python_s:.4f} s "
              f"(x{python_s / native_s:.1f}); read_edge_list took the native "
              f"parser: {ran_native and calls == [tpath]}")
        os.unlink(tpath)

        # P2. The raw wire into the kernel fold, a STATS probe mid-stream.
        flags2 = dedup_frames(N_EDGES, P_FRAME, P_WIRE_CHUNK)
        r2 = raw_wire_run(torch, device, src, dst, N_EDGES,
                          probe_stats=True)
        launches["P2"] = r2["launches"]
        check(len(r2["outs"]) == len(labels), f"P2: {len(r2['outs'])} "
              "emissions")
        for i, (a, b) in enumerate(zip(r2["outs"], labels)):
            check(a.dtype == b.dtype and np.array_equal(a, b),
                  f"P2: emission {i} != phase 4's")
        check(r2["launches"] == 3 * sum(flags2) and r2["launches"] > 0,
              f"P2: {r2['launches']} gather launches != 3 x {sum(flags2)} "
              "dedup frames")
        st = r2["stats"]
        ing = {k: v for k, v in st["counters"].items()
               if k.startswith("ingest.")}
        check(ing.get("ingest.frames_received", 0) > 0
              and ing.get("ingest.chunks_enqueued", 0) > 0,
              f"P2: the mid-stream STATS snapshot {ing}")
        c2, busy2 = r2["counters"], r2["busy"]
        frames2 = int(c2.get("ingest.data_frames_raw", 0))
        check(frames2 == N_EDGES // P_FRAME, f"P2: {frames2} frames")
        device_s = busy2.get("fold_dispatch", 0.0) + busy2.get(
            "merge_emit", 0.0)
        print(f"phase P2: {N_EDGES} edges in {frames2} raw frames of "
              f"{P_FRAME}: {N_EDGES / r2['wall_s']:.1f} edges/s "
              f"wall={r2['wall_s']:.4f} s wire "
              f"{c2.get('ingest.bytes_received', 0) / N_EDGES:.4f} B/edge "
              f"pauses={int(c2.get('ingest.backpressure_engaged', 0))} "
              f"peak_mem={r2['peak']} B host_share="
              f"{1 - device_s / r2['wall_s']:.4f} (fold and close "
              f"{device_s:.4f} s, h2d {busy2.get('h2d', 0.0):.4f} s) "
              f"gather_launches={r2['launches']} (3 x {sum(flags2)} dedup "
              f"frames); {len(r2['outs'])} emissions equal phase 4's; "
              f"mid-stream STATS: " + ", ".join(
                  f"{k}={int(v)}" for k, v in sorted(ing.items())))
        del r2

        # P3. The compressed wire: client-side sparse codec, STACKED K=4.
        agg3 = cc.connected_components(N_VERTICES, codec="sparse")
        tracer3 = obs.SpanTracer(capacity=1 << 16, heartbeat_every_s=None)
        errors: list = []
        compress3 = [0.0]
        from gelly_torch.core.io import EdgeChunkSource
        from gelly_torch.core.vertices import IdentityVertexTable

        with obs.scope() as bus3, obs.install(tracer3):
            srv = IngestServer(queue_depth=16, stop_on_bye=True).start()

            def feed3():
                try:
                    with IngestClient("127.0.0.1", srv.port,
                                      send_pause_timeout=300,
                                      stack=P3_STACK) as cli:
                        for c in EdgeChunkSource(
                                src, dst, chunk_size=CHUNK,
                                table=IdentityVertexTable(N_VERTICES)):
                            t_c = time.perf_counter()
                            p = agg3.host_compress(c)
                            compress3[0] += time.perf_counter() - t_c
                            cli.send_compressed(p)
                        cli.flush(timeout=300)
                except BaseException as e:  # noqa: BLE001
                    errors.append(e)
                    srv.stop()  # ends the consumer's iterator: no hang

            th = threading.Thread(target=feed3, name="p-client", daemon=True)
            torch.cuda.synchronize()
            reset_launches(kernels)
            t = time.perf_counter()
            th.start()
            res3 = run_aggregation(agg3, srv.compressed_payloads(),
                                   precompressed=True,
                                   merge_every=MERGE_EVERY)
            outs3 = [x.cpu().numpy() for x in res3]
            torch.cuda.synchronize()
            wall3 = time.perf_counter() - t
            th.join(120)
            srv.stop()
            c3 = dict(bus3.counters)
        check(not errors, f"P3 client: {errors[:1]}")
        check(len(outs3) == len(labels) and all(
            np.array_equal(a, b) for a, b in zip(outs3, labels)),
            "P3: an emission != phase 4's")
        n_units = res3.stats["units"]
        check(tracer3.spans("compress") == []
              and len(tracer3.spans("stack")) == n_units == N_EDGES // CHUNK,
              f"P3: {len(tracer3.spans('compress'))} compress spans, "
              f"{len(tracer3.spans('stack'))} stack spans, {n_units} units")
        print(f"phase P3: {N_EDGES} edges as {N_EDGES // CHUNK} sparse "
              f"payloads in {int(c3.get('ingest.frames_stacked', 0))} STACKED "
              f"frames (K={P3_STACK}): {N_EDGES / wall3:.1f} edges/s "
              f"wall={wall3:.4f} s (client compress {compress3[0]:.4f} s "
              f"of it) wire {c3.get('ingest.bytes_received', 0) / N_EDGES:.4f}"
              f" B/edge against the raw 16; 0 compress spans, "
              f"{len(tracer3.spans('stack'))} stack spans; emissions equal "
              f"phase 4's; gather_launches="
              f"{kernels.sorted_window_gather.launches}")
        del outs3, res3

        # P4. Kill -9 of the server mid-stream, restart, resend.
        flags4 = dedup_frames(P4_FRAMES * P_FRAME, P_FRAME, P_WIRE_CHUNK)
        frames = [edge_payload(src[lo:lo + P_FRAME], dst[lo:lo + P_FRAME])
                  for lo in range(0, P4_FRAMES * P_FRAME, P_FRAME)]
        try:
            cli = IngestClient("127.0.0.1", wait_port(p1),
                               send_pause_timeout=300)
            cli.connect()
            sent = [0]

            def sender():
                from gelly_torch.ingest.client import IngestError

                while sent[0] < P4_FRAMES:
                    try:
                        cli.send(frames[sent[0]])
                        sent[0] += 1
                    except IngestError:
                        sent[0] += 1  # buffered: reconnect() delivers it
                        return

            ts = threading.Thread(target=sender, daemon=True)
            ts.start()
            deadline = time.monotonic() + CHILD_TIMEOUT_S
            while time.monotonic() < deadline and cli.acked < P4_EVERY:
                time.sleep(0.005)
            check(cli.acked >= P4_EVERY, "P4: no ack before the deadline")
            t_kill = time.time()
            os.kill(p1.pid, signal.SIGKILL)
            check(p1.wait(60) == -signal.SIGKILL, "P4: the kill")
            acked_before = cli.acked
            ts.join(60)
        finally:
            if p1.poll() is None:
                p1.kill()
        logs1 = [f for f in os.listdir(d4) if f.startswith("child-")
                 and f.endswith(".json")]
        rec1 = json.load(open(os.path.join(d4, logs1[0])))[-1] if logs1 \
            else {"chunks": 0, "launches": 0}
        check(rec1["launches"] == 3 * sum(flags4[:rec1["chunks"]]),
              f"P4: the killed child launched {rec1['launches']} for "
              f"{rec1['chunks']} chunks")
        os.unlink(os.path.join(d4, "port"))
        p2 = spawn(0.0)
        try:
            cli.port = wait_port(p2)
            t_port = time.time()
            deadline = time.monotonic() + 60
            while True:
                try:
                    cli.reconnect()
                    break
                except OSError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.05)
            t_reconnected = time.time()
            check(cli.acked >= acked_before, "P4: acked work rewound")
            while sent[0] < P4_FRAMES:
                cli.send(frames[sent[0]])
                sent[0] += 1
            cli.flush(timeout=300)
            cli.close()
            out, _ = p2.communicate(timeout=CHILD_TIMEOUT_S)
            check(p2.returncode == 0, f"P4: the resumed child rc "
                  f"{p2.returncode}")
        finally:
            if p2.poll() is None:
                p2.kill()
        final, pos4, parts = load_checkpoint(
            os.path.join(d4, "final.npz"),
            like={"labels": np.zeros(N_VERTICES, np.int32)})
        got4 = np.asarray(final["labels"])
        resumed = int(parts["resumed_at"])
        launches["P4"] = rec1["launches"] + int(parts["launches"])
        check(pos4 == P4_FRAMES and np.array_equal(got4, labels[0]),
              f"P4: resumed labels (position {pos4}) != phase 4's first "
              "emission")
        check(resumed >= P4_EVERY and resumed % P4_EVERY == 0
              and parts["enqueued"] == P4_FRAMES - resumed
              and parts["chunks"] == P4_FRAMES,
              f"P4: the wire ledger folded a chunk twice or lost one: "
              f"resumed at {resumed}, enqueued {parts['enqueued']}, "
              f"{parts['chunks']} chunks")
        check(int(parts["launches"]) == 3 * sum(flags4[resumed:]),
              f"P4: the resumed child launched {parts['launches']}")
        recover = parts["first_emission_at"] - t_kill
        print(f"phase P4: killed after {acked_before} acked frames (the "
              f"child had folded {rec1['chunks']}), resumed at {resumed} "
              f"of {P4_FRAMES}, enqueued {int(parts['enqueued'])} frames, "
              f"{int(parts['duplicates'])} duplicates dropped; labels equal "
              f"phase 4's first emission; time to recover {recover:.2f} s: "
              f"spawn to CUDA {parts['cuda_at'] - parts['spawned_at']:.2f} "
              f"s, CUDA to listening "
              f"{parts['listen_at'] - parts['cuda_at']:.2f} s, port to "
              f"reconnect {t_reconnected - t_port:.2f} s, reconnect to "
              f"first emission "
              f"{parts['first_emission_at'] - t_reconnected:.2f} s "
              f"(resume load {parts['resume_load_s']:.4f} s); "
              f"gather_launches={launches['P4']} ({rec1['launches']} + "
              f"{parts['launches']})")
        del frames

        # P5. The tenant wire: N2's 4096 tenants through a TenantRouter,
        # from a client process (a user's own: it shares no GIL with the
        # server), then the checkpoint-gated acks on the first 64.
        from gelly_torch.library.connected_components import cc_tenant_tier

        edges5, want5 = n2["n2_edges"], n2["n2_labels"]
        rounds = N_EDGES_PER // N_CHUNK
        agg5, cap5 = cc_tenant_tier(N_SLOTS, chunk_capacity=N_CHUNK)
        d5 = os.path.join(tmp, "p5")
        os.makedirs(d5)
        np.savez(os.path.join(d5, "edges.npz"),
                 src=np.stack([s for s, _ in edges5]),
                 dst=np.stack([d for _, d in edges5]))
        eng = MultiTenantEngine(merge_every=N_MERGE_EVERY, device=device)
        eng.add_tier("wire", agg5, cap5)
        for tid in range(N2_TENANTS):
            eng.admit(tid, "wire")
        router = TenantRouter(eng, "wire", vertex_capacity=N_SLOTS)
        with obs.scope() as bus5:
            srv = IngestServer(tenant_streams=True,
                               queue_depth=1 << 16).start()
            router.attach(srv)
            with open(os.path.join(d5, "run.json"), "w") as f:
                json.dump({"port": srv.port, "tenants": N2_TENANTS}, f)
            total5 = N2_TENANTS * N_EDGES_PER
            t = time.perf_counter()
            client = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--ingest-client", d5], stdout=subprocess.PIPE, text=True)
            try:
                # The scheduler starts once the wire has queued every
                # chunk: 8 full rounds, as N2's drain. (The client may
                # exit first: the server acks a frame when it stages it,
                # before the router has submitted its chunks.)
                # A slow poll: queue_depth() walks every tenant under the
                # engine's lock, which the router's submits take too.
                deadline = time.monotonic() + CHILD_TIMEOUT_S
                while (time.monotonic() < deadline
                       and client.poll() in (None, 0)
                       and eng.queue_depth() < N2_TENANTS * rounds):
                    time.sleep(0.25)
                wire_s = time.perf_counter() - t
                check(eng.queue_depth() == N2_TENANTS * rounds,
                      f"P5: {eng.queue_depth()} chunks queued "
                      f"(client rc {client.poll()})")
                out5, _ = client.communicate(timeout=CHILD_TIMEOUT_S)
                check(client.returncode == 0,
                      f"P5: the client process rc {client.returncode}")
            finally:
                if client.poll() is None:
                    client.kill()
            with obs.record_metrics():
                t_eng = time.perf_counter()
                for tid in range(N2_TENANTS):
                    eng.finish(tid)
                got5_map, engine_s = drain_timed(torch, device, eng)
                wall5 = time.perf_counter() - t
                p50 = bus5.quantile("tenants.round_ms", 0.5)
                p99 = bus5.quantile("tenants.round_ms", 0.99)
            srv.stop()
            router.stop()
            c5 = dict(bus5.counters)
        got5 = np.stack([got5_map[tid] for tid in range(N2_TENANTS)])
        check(got5.dtype == want5.dtype and np.array_equal(got5, want5),
              "P5: a tenant's labels != N2's")
        sent5 = json.loads(out5.strip().splitlines()[-1])["ingest_client"]
        check(sent5["acked"] == N2_TENANTS * rounds,
              f"P5: the client's acks {sent5['acked']}")
        n2_p50, n2_p99 = n2["n2_round_ms"]
        print(f"phase P5: {N2_TENANTS} tenants x {N_EDGES_PER} edges from a "
              f"client process over one tenant_streams connection in "
              f"{int(c5.get('ingest.frames_stacked', 0))} single-tenant "
              f"STACKED frames of {rounds}: {total5 / wall5:.1f} edges/s "
              f"wall={wall5:.4f} s (the wire queued every chunk in "
              f"{wire_s:.4f} s: {total5 / wire_s:.1f} edges/s, the client "
              f"process sending for {sent5['send_s']:.4f} s of it, "
              f"{c5.get('ingest.bytes_received', 0) / total5:.4f} B/edge; "
              f"the engine drained in {engine_s:.4f} s) round_ms "
              f"p50={p50:.3f} p99={p99:.3f} dispatches="
              f"{eng.stats['dispatches']}; N2 in-process "
              f"{total5 / n2['n2_wall_s']:.1f} edges/s wall="
              f"{n2['n2_wall_s']:.4f} s round_ms p50={n2_p50:.3f} "
              f"p99={n2_p99:.3f}; every tenant equal to N2's")
        check(eng.stats["dispatches"] == rounds, "P5: dispatches")
        del eng, got5, got5_map
        # Checkpoint-gated per-tenant acks on the first P5_ACK_TENANTS
        # tenants (a cut: a per-tenant checkpoint costs ~20 ms on the
        # card's temporary filesystem, 80 s at 4096 tenants).
        n_ack = P5_ACK_TENANTS
        d5b = os.path.join(tmp, "p5b")
        os.makedirs(d5b)
        eng = MultiTenantEngine(merge_every=N_MERGE_EVERY, device=device,
                                checkpoint_dir=d5b,
                                checkpoint_every=rounds // N_MERGE_EVERY)
        eng.add_tier("acks", agg5, cap5)
        for tid in range(n_ack):
            eng.admit(tid, "acks")
        router = TenantRouter(eng, "acks", vertex_capacity=N_SLOTS,
                              checkpoint_acks=True)
        with obs.scope():
            srv = IngestServer(tenant_streams=True, auto_ack=False,
                               queue_depth=1 << 12).start()
            router.attach(srv)
            acks: dict = {}
            errors = []

            def feed5():
                try:
                    with IngestClient("127.0.0.1", srv.port,
                                      tenant_streams=True, stack=rounds,
                                      send_pause_timeout=300) as cli5:
                        for tid in range(n_ack):
                            s, d = edges5[tid]
                            for k in range(rounds):
                                lo, hi = k * N_CHUNK, (k + 1) * N_CHUNK
                                cli5.send(edge_payload(s[lo:hi], d[lo:hi]),
                                          tenant=tid)
                        cli5.flush(timeout=300)
                        acks.update({tid: cli5.acked_for(tid)
                                     for tid in range(n_ack)})
                except BaseException as e:  # noqa: BLE001
                    errors.append(e)

            th = threading.Thread(target=feed5, name="p-client", daemon=True)
            t = time.perf_counter()
            th.start()
            deadline = time.monotonic() + CHILD_TIMEOUT_S
            while (time.monotonic() < deadline and not errors
                   and eng.queue_depth() < n_ack * rounds):
                time.sleep(0.05)
            eng.start()
            try:
                for tid in range(n_ack):
                    eng.finish(tid)
                th.join(CHILD_TIMEOUT_S)
            finally:
                eng.stop()
                srv.stop()
                router.stop()
            acks_s = time.perf_counter() - t
        check(not errors, f"P5 acks client: {errors[:1]}")
        check(all(acks.get(tid) == rounds for tid in range(n_ack)),
              "P5: a tenant's checkpoint-gated acks did not reach the client")
        got5b = np.stack([np.asarray(eng.labels(tid)) for tid in range(n_ack)])
        check(np.array_equal(got5b, want5[:n_ack]),
              "P5: a checkpoint-acked tenant's labels != N2's")
        print(f"phase P5 acks: {n_ack} tenants with auto_ack=False behind "
              f"TenantRouter(checkpoint_acks=True): every tenant acked at "
              f"{rounds} after its checkpoint ({len(os.listdir(d5b))} "
              f"files) in {acks_s:.4f} s; labels equal N2's")
        del eng

        # P6. One traced wire run: P2's first 2^23 edges.
        tr = obs.SpanTracer(capacity=1 << 16, heartbeat_every_s=None)
        r6 = raw_wire_run(torch, device, src, dst, P6_EDGES, tracer=tr)
        sends, recvs = tr.spans("client_send"), tr.spans("wire_recv")
        stages, folds = tr.spans("staging"), tr.spans("fold")
        n6 = P6_EDGES // P_FRAME
        ids = {s["args"].get("trace")
               for s in sends + recvs + stages + folds}
        stage0 = [s for s in stages if s["args"].get("seq") == 0]
        linked = [f for f in folds if stage0 and f["args"].get("parent")
                  == stage0[0]["args"]["span"]]
        check(len(sends) == len(recvs) == len(stages) == len(folds) == n6,
              f"P6: spans {len(sends)} / {len(recvs)} / {len(stages)} / "
              f"{len(folds)}")
        check(ids == {tr.trace_id} and len(linked) == 1,
              f"P6: trace ids {ids}, {len(linked)} fold linked to seq 0")
        print(f"phase P6: {P6_EDGES} edges traced: {n6} client_send, "
              f"wire_recv, staging and fold spans, one trace id "
              f"{tr.trace_id}, the first fold's parent the first staging "
              f"span; wall={r6['wall_s']:.4f} s")
    finally:
        if p1 is not None and p1.poll() is None:
            p1.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def bounded_degree_stream(n: int, seed: int):
    """Two random Hamiltonian cycles over ``n`` slots, edges shuffled: every
    vertex has degree at most 4, so any ball of radius 3 holds at most
    ``1 + 4 + 12 + 36 = 53`` vertices."""
    rng = np.random.default_rng(seed)
    edges = []
    for _ in range(2):
        p = rng.permutation(n)
        edges.append(np.stack([p, np.roll(p, -1)], 1))
    e = np.concatenate(edges)[rng.permutation(2 * n)]
    return e[:, 0].astype(np.int32), e[:, 1].astype(np.int32)


def spanner_gate_phase(torch, device, f2_stream: dict) -> dict:
    """Phase F4: (i) the exact sequential gate, entry 1, on a stream of
    bounded degree (no frontier truncation, no row overflow possible), held
    to its plain version on the card, to the native host spanner edge for
    edge, and the dense plan's per-edge fold to the same list; (ii) the
    ingest codec on F2's stream, each chunk-local spanner re-gated through
    entry 1. Returns entry 1's numbers for the kernel line."""
    from gelly_torch.core.io import EdgeChunkSource
    from gelly_torch.core.stream import edge_stream_from_source
    from gelly_torch.core.vertices import IdentityVertexTable
    from gelly_torch.ops import kernels
    from gelly_torch.utils import native

    sp = __import__("gelly_torch.library.spanner", fromlist=["spanner"])
    check(native.available("spanner"), "the native spanner did not build")
    n = F4_N
    src, dst = bounded_degree_stream(n, F4_SEED)
    e = src.shape[0]
    deg = np.bincount(src, minlength=n) + np.bincount(dst, minlength=n)
    check(int(deg.max()) <= 4, f"F4: input degree {int(deg.max())} > 4")
    F = max(32, 4 * SPANNER_D)
    check(1 + 4 + 12 + 36 <= F, "F4: a radius-3 ball may exceed the frontier")

    def source():
        return EdgeChunkSource(src, dst, chunk_size=e,
                               table=IdentityVertexTable(n))

    def run(plan, pull=spanner_pull, **knobs):
        return drive(torch, device, plan, source(), n, e, 1, 1, pull,
                     **knobs)

    with GateTimer(torch, kernels, "sparse_insert_edges",
                   kernels.sparse_insert_edges) as gate:
        (got,), st = run(sp.sparse_spanner(n, 3, SPANNER_D))
    report_run("phase F4(i) sequential gate, k=3", st,
               expect={"sparse_insert_edges": 1,
                       "sparse_insert_edges_batched": 1})
    with GateTimer(torch, kernels, "sparse_insert_edges",
                   kernels.sparse_insert_edges_plain) as plain:
        (want,), pst = run(sp.sparse_spanner(n, 3, SPANNER_D))
    report_run("phase F4(i) plain gate", pst,
               expect={"sparse_insert_edges_batched": 1})
    (ms, info), = gate.timings()
    (pms, _), = plain.timings()
    check(same(got, want), "F4(i): entry 1 != its plain version")
    check(int(got[6]) == 0, f"F4(i): deg_overflow {int(got[6])}")
    ctx_stream = edge_stream_from_source(source(), n, device=device)
    host = sp.host_spanner(ctx_stream, 3, max_degree=SPANNER_D)
    m = int(got[4])
    dev_edges = list(zip(got[2][:m].tolist(), got[3][:m].tolist()))
    check(host.final_edges() == dev_edges and host.deg_overflow == 0,
          "F4(i): the gate != the native host spanner")
    (dense,), dst_ = run(sp.spanner(n, 3))
    report_run("phase F4(i) dense plan (plain per-edge fold)", dst_)
    check(int(dense[3]) == m and np.array_equal(dense[1][:m], got[2][:m])
          and np.array_equal(dense[2][:m], got[3][:m]),
          "F4(i): the dense plan != the sparse gate")
    bound, nbytes = gate_bound_ms(info, SPANNER_D)
    us = gate_us(ms, info, 0)
    print(f"phase F4(i): {e} edges of max degree {int(deg.max())} over {n} "
          f"slots, k=3: {m} accepted, equal to the plain gate, the native "
          f"host spanner and the dense plan, edge for edge; entry 1 "
          f"{ms:.4f} ms ({us:.3f} us a live edge; plain {pms:.4f} ms, "
          f"bound {bound:.6f} ms for {nbytes} B)")
    result = {"ms": ms, "plain_ms": pms, "bound_ms": bound,
              "bound_bytes": nbytes, "us_edge": us}

    # (ii) the codec on F2's stream.
    s2, d2 = f2_stream["src"], f2_stream["dst"]
    n2, e2 = F2_N, F2_EDGES

    def codec_plan():
        agg = sp.spanner(n2, 3, max_degree=SPANNER_D, ingest_combine=True,
                         payload_cap=F4_CODEC_CAP)
        check(agg.host_compress is not None, "F4(ii): no codec")
        return agg

    def codec_source(edges):
        return EdgeChunkSource(s2[:edges], d2[:edges], chunk_size=F2_CHUNK,
                               table=IdentityVertexTable(n2))

    def codec_run(edges, merge_every, pull=spanner_pull):
        return drive(torch, device, codec_plan(), codec_source(edges), n2,
                     edges, merge_every, 1, pull,
                     codec_workers=F4_CODEC_WORKERS)

    chunks = e2 // F2_CHUNK
    with GateTimer(torch, kernels, "sparse_insert_edges",
                   kernels.sparse_insert_edges) as gate:
        (full,), st = codec_run(e2, chunks)
    report_run("phase F4(ii) spanner codec, k=3", st,
               expect={"sparse_insert_edges": chunks,
                       "sparse_insert_edges_batched": 1})
    result["launches"] = st["launches"][HAND_KERNELS.index(
        "sparse_insert_edges")]
    result["payload_us_edge"] = []
    for i, (ms, info) in enumerate(gate.timings()):
        us = gate_us(ms, info, 0)
        result["payload_us_edge"].append(us)
        print(f"  F4(ii) payload {i + 1}: {info['lanes']} lanes, "
              f"{info['live']} live, {info['accepted']} accepted, entry 1 "
              f"{ms:.4f} ms ({us:.3f} us a live edge)")
    (first,), _ = codec_run(F4_REGATE_EDGES, 1)
    # The plain re-gate of the first edges runs on CPU tensors (the same
    # host codec and payload): on the card its per-edge launches cost about
    # 2 ms an edge, almost all of it host-side dispatch.
    t = time.perf_counter()
    res = edge_stream_from_source(codec_source(F4_REGATE_EDGES), n2,
                                  device="cpu").aggregate(
        codec_plan(), merge_every=1, codec_workers=F4_CODEC_WORKERS)
    first_plain, = [spanner_pull(x) for x in res]
    print(f"phase F4(ii) plain re-gate of the first {F4_REGATE_EDGES} "
          f"edges on CPU tensors: {time.perf_counter() - t:.4f} s")
    check(same(first, first_plain),
          f"F4(ii): entry 1 != plain, first {F4_REGATE_EDGES} edges")
    m = int(full[4])
    check(not bool(full[5]), "F4(ii): the edge list overflowed")
    keys = input_keys(torch, s2, d2, n2, device)
    check_subset(torch, keys, full[2][:m], full[3][:m], n2, "F4(ii)")
    del keys
    rng = np.random.default_rng(F4_SEED)
    pick = rng.choice(e2, F4_SAMPLE, replace=False)
    hops = sampled_hops(torch, full[2][:m], full[3][:m], n2,
                        np.stack([s2[pick], d2[pick]], 1), 9, device)
    check(int(hops.max()) <= 9,
          f"F4(ii): stretch > k^2 = 9 on {int((hops > 9).sum())} sampled "
          "edges")
    print(f"phase F4(ii): {m} accepted over {chunks} payloads "
          f"(deg_overflow {int(full[6])}); the first {F4_REGATE_EDGES} "
          f"edges equal to the plain re-gate; every accepted edge an input edge; {F4_SAMPLE} sampled "
          f"input edges within k^2 = 9 hops (max {int(hops.max())})")
    return result


def matching_phase(torch, device) -> dict:
    """Phase G: BASELINE #5, ``bench.py:bench_matching``'s call. Returns
    the matching kernel's numbers for the kernel line."""
    from gelly_torch.core.io import EdgeChunkSource, read_edge_list
    from gelly_torch.core.stream import edge_stream_from_source
    from gelly_torch.core.vertices import IdentityVertexTable
    from gelly_torch.library import matching as wm
    from gelly_torch.ops import kernels
    from gelly_torch.utils import native

    check(native.available("matching"), "the native matching did not build")
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    fsrc, fdst, fval = read_edge_list(
        os.path.join(here, "data", "ratings_like.txt"), num_value_cols=1)
    reps = max(1, G_EDGES // fsrc.shape[0])
    rng = np.random.default_rng(G_SEED)
    perms = [rng.permutation(G_N).astype(np.int32) for _ in range(reps)]
    src = np.concatenate([p[fsrc] for p in perms])
    dst = np.concatenate([p[fdst] for p in perms])
    w = np.concatenate([fval] * reps)
    e = src.shape[0]
    check(bool(np.all(w == np.round(w))) and float(w.max()) < 2 ** 23,
          "G: the weights are not small integers")
    print(f"phase G stream: {fsrc.shape[0]} fixture edges x {reps} = {e} "
          f"edges over {G_N} slots in {time.perf_counter() - t0:.2f} s")

    def stream():
        return edge_stream_from_source(EdgeChunkSource(
            src, dst, val=w, chunk_size=G_CHUNK,
            table=IdentityVertexTable(G_N)), G_N, device=device)

    def timed(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        reset_launches(kernels)
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = dict(zip(HAND_KERNELS, launch_counts(kernels)))
        print(f"phase G {name}: wall={wall:.4f} s ({e / wall:.1f} edges/s) "
              f"peak_mem={torch.cuda.max_memory_allocated(device)} B "
              f"launches={ {k: v for k, v in counts.items() if v} }")
        return out, counts

    wm.weighted_matching(stream()).final()  # warm-up
    for i in range(2):
        host, counts = timed(f"host native run {i + 1}",
                             lambda: wm.weighted_matching(
                                 stream()).final_matching())
        check(counts == dict(zip(HAND_KERNELS, NO_LAUNCHES)),
              "G: the host path launched a kernel")
    t0 = time.perf_counter()
    matching: dict = {}
    for u, v, wt in zip(src.tolist(), dst.tolist(), w.tolist()):
        if u == v:
            continue
        coll = {id(x): x for y in (u, v) if y in matching
                for x in [matching[y]]}
        if wt > 2 * sum(x[2] for x in coll.values()):
            for x in coll.values():
                matching.pop(x[0], None)
                matching.pop(x[1], None)
            matching[u] = matching[v] = (u, v, wt)
    base = {(min(a, b), max(a, b)): wt for a, b, wt in set(matching.values())}
    ours = {(a, b): wt for a, b, wt in host}
    check(ours == base, f"G: host matching ({len(ours)} edges) != the "
                        f"bench's oracle ({len(base)})")
    print(f"phase G: the host path's {len(ours)} matched edges (weight "
          f"{sum(ours.values())}) equal the bench's oracle "
          f"({time.perf_counter() - t0:.2f} s)")
    replay: dict = {}
    t0 = time.perf_counter()
    for ev in wm.weighted_matching(stream()).events():
        key = (min(ev.src, ev.dst), max(ev.src, ev.dst))
        if ev.type == "ADD":
            replay[key] = ev.weight
        else:
            check(replay.pop(key, None) == ev.weight,
                  f"G: REMOVE of an unmatched {key}")
    check(replay == ours, "G: events() replay != final_matching()")
    print(f"phase G: events() replays to the same matching "
          f"({time.perf_counter() - t0:.2f} s)")
    with GateTimer(torch, kernels, "matching_step",
                   kernels.matching_step) as gate:
        t = time.perf_counter()
        dev, counts = timed("device=True (kernel)", lambda:
                            wm.weighted_matching(stream(), device=True
                                                 ).final_matching())
        wall = time.perf_counter() - t
    spans = gate.timings()
    busy = sum(ms for ms, _ in spans) * 1e-3
    print(f"phase G device=True: the kernel's {len(spans)} launch(es) take "
          f"{busy:.4f} s of the {wall:.4f} s run (CUDA events; idle share "
          f"{1 - busy / wall:.4f} outside them)")
    n_chunks = -(-e // G_CHUNK)
    check(counts["matching_step"] == n_chunks,
          f"G: {counts['matching_step']} kernel launches, not {n_chunks}")
    launches = counts["matching_step"]
    diff = set(dev) ^ set(host)
    check(not diff, f"G: device != host on {len(diff)} pairs (integer "
                    f"weights: f32 and f64 decide alike)")
    print(f"phase G: device=True equals the host path ({len(diff)} pairs "
          f"differ; integer weights below 2^23 leave no f32/f64 threshold "
          f"window)")

    # The kernel against its plain version: exact on a 2^12-edge prefix
    # (the plain version on CPU tensors of the same inputs: on the card its
    # ~25 launches an edge cost about 1 ms an edge of host-side dispatch;
    # a depth cut of 2^16 edges), and both timed on the card on the same
    # prefix.
    def prefix(L, dev):
        return [torch.full((G_N,), -1, dtype=torch.int32, device=dev),
                torch.zeros(G_N, dtype=torch.float32, device=dev)] + [
            torch.from_numpy(x).to(dev) for x in (
                src[:L], dst[:L], w[:L].astype(np.float32),
                np.ones(L, bool))]

    got = kernels.matching_step(*prefix(G_PREFIX, device))
    t = time.perf_counter()
    want = kernels.matching_step(*prefix(G_PREFIX, "cpu"))
    cpu_s = time.perf_counter() - t
    err = float((got[1].cpu() - want[1]).abs().max())
    check(torch.equal(got[0].cpu(), want[0])
          and torch.equal(got[1].cpu(), want[1]),
          f"G: kernel != plain on the {G_PREFIX}-edge prefix (max abs err "
          f"{err})")
    args = prefix(G_TIMED, device)
    got = kernels.matching_step(*args)
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = kernels.matching_step_plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"G: kernel != plain on the card, {G_TIMED}-edge prefix")
    ms = time_ms(torch, lambda: kernels.matching_step(*args), device,
                 reps=5, warmup=1)
    nbytes = 13 * G_TIMED + 2 * 8 * G_N
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"kernel matching_step: equal to its plain version on a "
          f"{G_PREFIX}-edge prefix (plain on CPU tensors, {cpu_s:.2f} s); "
          f"{G_TIMED}-edge prefix on the card: kernel_ms={ms:.6f} "
          f"plain_ms={plain_ms:.6f} (host clock) bound_ms={bound:.6f} "
          f"({nbytes} B)")
    return {"launches": launches, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "max_abs_err": err}


# ---------------------------------------------------------------------- #
# H. windows and I. the stream API (PR 8)

H_CHUNK = 1 << 18  # pane chunks: phase 4's stream re-chunked
H1_MERGE_EVERY = 2  # 128 panes
H1_WINDOWS = (4, 64)
# Edges a ring run folds: W = 4 over the first half of phase 4's stream
# (64 panes, 60 of them evicting; a depth cut of 128 panes, ~10 s, for
# phase Q), W = 64 over its first three quarters (96 panes, 32 of them
# evicting; a depth cut of 128 panes, ~5 s, for phase O3's checks).
H1_EDGES = {4: 1 << 25, 64: 3 << 24}
H2_BLOCK = 1 << 20
H2_DRIFT = 1 << 16
H2_CHUNKS = 128  # a depth cut of 256: still 9.2M slots > the capacity
H2_SEED = 19
H2_COMPACT = 1 << 23
H2_W = 8
H2_TTL = 8
H2_CKPT_EVERY = 56  # one ring checkpoint, at pane 56
H3_WINDOW_MS = 1 << 24
H4_BLOCK = 1 << 20
H4_SEED = 23
H5_W = 8
H5_MERGE_EVERY = 4  # 64 panes
I1_EDGES = 1 << 23  # a depth cut of 2^26
I1_ABSENT = 1 << 20
I2_PREFIX = 1 << 22
I2_CHUNK = 1 << 20
I4_SEED = 41
I4_CYCLES = 4
I4_MAX_DEGREE = 16
I4_PLAIN_EDGES = 1 << 12
I4_DENSE_N = 1 << 14
I5_FOLD_WINDOW = 1 << 20  # a depth cut: fold depth = longest neighbourhood
I5_FOLD_WINDOWS = 4
HASH_PLAIN_KEYS = 1 << 16
HASH_PLAIN_CAP = 1 << 17
HASH_PLAIN_FILL = 1 << 15
# The insert's adversarial case: keys homed in a few slots of a table
# filled to 0.6, each key at lanes i and i + HASH_ADV_KEYS / 2.
HASH_ADV_CAP = 1 << 20
HASH_ADV_LOAD = 0.6
HASH_ADV_KEYS = 1 << 16
HASH_ADV_HOMES = 4096


def ring_run(torch, device, agg, source, n, n_events, merge_every, picks,
             keep_from=None, **knobs):
    """One windowed run on the card with the launch and sync counts set to
    0 just before it; the emissions at ``picks`` (and from ``keep_from``
    on) are kept on the card, the others dropped. Checks that the
    snapshot handle tracks every close. Returns ``(kept, stats)``."""
    from gelly_torch.core.stream import edge_stream_from_source
    from gelly_torch.ops import kernels, unionfind

    stream = edge_stream_from_source(source, n, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches(kernels)
    unionfind.host_sync.count = 0
    t = time.perf_counter()
    res = stream.aggregate(agg, merge_every=merge_every, **knobs)
    kept, assigned, i = {}, [], -1
    for i, x in enumerate(res):
        snap = res.snapshot()
        check(snap["window"] == i + 1, f"snapshot window {snap['window']} "
                                       f"after close {i + 1}")
        if i in picks or (keep_from is not None and i >= keep_from):
            kept[i] = x.clone()
        if hasattr(agg, "session"):
            assigned.append(int(agg.session.assigned))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    stats = {
        "wall_s": wall, "events_per_s": n_events / wall,
        "stats": dict(res.stats), "busy": res.timer.busy(),
        "units": res.stats["units"], "host_syncs": unionfind.host_sync.count,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(device),
        "h2d_bytes": res.stats["h2d_bytes"],
        "launches": launch_counts(kernels), "closes": i + 1,
        "assigned": assigned,
    }
    return kept, stats


def window_of(i: int, w: int, pane_edges: int, n_edges: int):
    """Edge range of the emission at pane ``i`` of a ``w``-pane ring."""
    return max(0, (i + 1 - w) * pane_edges), min((i + 1) * pane_edges,
                                                 n_edges)


def pane_ring_phase(torch, device, src, dst, labels4) -> None:
    """H1: the pane ring at bench_windows' W values, at full width (W = 4
    over half the stream, ``H1_EDGES``). A window
    that is one of phase 4's prefixes is held to phase 4's emission
    (equal to the plain backend's, the last to scipy), the others to
    scipy."""
    import importlib

    from gelly_torch.core.io import EdgeChunkSource
    from gelly_torch.core.vertices import IdentityVertexTable

    cc = importlib.import_module("gelly_torch.library.connected_components")
    n = N_VERTICES
    pane_edges = H_CHUNK * H1_MERGE_EVERY

    def source(lo=0, hi=N_EDGES):
        return EdgeChunkSource(src[lo:hi], dst[lo:hi], chunk_size=H_CHUNK,
                               table=IdentityVertexTable(n))

    rows = {}
    for w in H1_WINDOWS:
        n_edges = H1_EDGES[w]
        panes = n_edges // pane_edges
        picks = {w - 1, (w - 1 + panes - 1) // 2, panes - 1}
        kept, st = ring_run(
            torch, device,
            cc.connected_components(n, merge="gather", codec="dense",
                                    windowed=w),
            source(0, n_edges), n, n_edges, H1_MERGE_EVERY, picks)
        report_run(f"phase H1 ring W={w}", st)
        check_native_codecs(f"phase H1 W={w}")
        check(st["closes"] == panes == st["stats"]["windows.panes_closed"],
              f"H1 W={w}: {st['closes']} closes, want {panes}")
        close_ms = st["busy"]["merge_emit"] / panes * 1e3
        wall_ms = st["wall_s"] / panes * 1e3
        combines = st["stats"]["windows.combine_dispatches"] / panes
        t0 = time.perf_counter()
        for i in sorted(picks):
            lo, hi = window_of(i, w, pane_edges, n_edges)
            got = kept[i].cpu().numpy()
            check(got.dtype == np.int32 and got.shape == (n,),
                  f"H1 W={w} emission {i}: {got.dtype} {got.shape}")
            prefix = lo == 0 and hi % (CHUNK * MERGE_EVERY) == 0
            want = (labels4[hi // (CHUNK * MERGE_EVERY) - 1] if prefix
                    else scipy_oracle(src[lo:hi], dst[lo:hi], n))
            check(np.array_equal(got, want),
                  f"H1 W={w}: emission {i} != the labels of edges "
                  f"[{lo}, {hi})")
        oracle_s = time.perf_counter() - t0
        del kept
        # bench_windows' yardstick: one close by a full replay of the
        # window's W panes (the plan without the ring, one emission).
        hi = min(w * pane_edges, n_edges)
        _, rst = drive(torch, device,
                       cc.connected_components(n, merge="gather",
                                               codec="dense"),
                       source(0, hi), n, hi, hi // H_CHUNK, 1, None)
        rows[w] = (wall_ms, close_ms, rst["wall_s"] * 1e3, combines)
        print(f"phase H1 W={w}: pane_close_ms={close_ms:.4f} (merge_emit "
              f"busy a close) wall_per_close_ms={wall_ms:.4f} "
              f"combines_per_close={combines:.4f} "
              f"replay_close_ms={rst['wall_s'] * 1e3:.4f} "
              f"(the {w} panes refolded, one emission) "
              f"ring_vs_replay={rst['wall_s'] * 1e3 / wall_ms:.2f}x; "
              f"emissions {sorted(picks)} equal scipy ({oracle_s:.2f} s)")
        torch.cuda.empty_cache()
    w_lo, w_hi = H1_WINDOWS
    print(f"phase H1 claims (printed, not gated): W={w_hi} wall a close "
          f"{rows[w_hi][0]:.4f} ms vs W={w_lo} {rows[w_lo][0]:.4f} ms "
          f"(within 2x: {rows[w_hi][0] <= 2 * rows[w_lo][0]}); replay / "
          f"ring at W={w_hi} {rows[w_hi][2] / rows[w_hi][0]:.2f}x "
          f"(>= 8x: {rows[w_hi][2] >= 8 * rows[w_hi][0]})")


def drift_stream(n: int):
    """H2's drifting stream: chunk i draws both endpoints from the
    ``H2_BLOCK``-slot block starting at ``(i * H2_DRIFT) mod n``."""
    rng = np.random.default_rng(H2_SEED)
    lo = (np.arange(H2_CHUNKS, dtype=np.int64) * H2_DRIFT) % n
    out = []
    for _ in range(2):
        x = rng.integers(0, H2_BLOCK, (H2_CHUNKS, H_CHUNK)) + lo[:, None]
        out.append((x % n).astype(np.int32).reshape(-1))
    return out


def ttl_phase(torch, device) -> None:
    """H2: compact CC with TTL on a stream that touches more slots than
    the compact capacity holds."""
    import importlib

    from gelly_torch.core.io import EdgeChunkSource
    from gelly_torch.core.vertices import IdentityVertexTable

    cc = importlib.import_module("gelly_torch.library.connected_components")
    n = N_VERTICES
    t0 = time.perf_counter()
    src, dst = drift_stream(n)
    n_edges = src.shape[0]
    seen = np.zeros(n, bool)
    seen[src] = True
    seen[dst] = True
    cumulative = int(seen.sum())
    print(f"phase H2 stream: {H2_CHUNKS} chunks of {H_CHUNK} edges, block "
          f"{H2_BLOCK} drifting {H2_DRIFT} a chunk, {cumulative} distinct "
          f"slots (capacity {H2_COMPACT}), in {time.perf_counter() - t0:.2f} s")
    check(cumulative > H2_COMPACT, "H2: the stream fits the capacity")
    pane_edges = 2 * H_CHUNK
    panes = n_edges // pane_edges

    def plan():
        return cc.connected_components(n, codec="compact",
                                       compact_capacity=H2_COMPACT,
                                       windowed=H2_W, ttl_panes=H2_TTL)

    def source():
        return EdgeChunkSource(src, dst, chunk_size=H_CHUNK,
                               table=IdentityVertexTable(n))

    tmp = tempfile.mkdtemp(prefix="gelly-h2-")
    try:
        path = os.path.join(tmp, "ring.npz")
        picks = {H2_W - 1, panes // 2, panes - 1}
        kept, st = ring_run(
            torch, device, plan(), source(), n, n_edges, 2, picks,
            keep_from=H2_CKPT_EVERY, prefetch_depth=0, h2d_depth=0,
            checkpoint_path=path, checkpoint_every=H2_CKPT_EVERY)
        report_run("phase H2 compact TTL", st)
        check_native_codecs("phase H2")
        assigned = st["assigned"]
        # bench_windows' capacity_bounded (bench.py:3695-3698), with 1%
        # of room: at this size the steady state is a random count (the
        # slots last touched near the block's trailing edge) that moves
        # by a few hundred slots from pane to pane. On an H100 the
        # 256-chunk stream gave a plateau of 1,830,662 over a head
        # maximum of 1,830,333 (+0.018%), which fails the strict test;
        # these 128 chunks give 1,830,301 under 1,830,527.
        fill = H2_TTL + H2_W
        plateau = max(assigned[fill:])
        bounded = (plateau <= 1.01 * max(assigned[:fill])
                   and plateau * 3 <= cumulative)
        print(f"phase H2: closes={st['closes']} evicted_slots="
              f"{st['stats']['windows.evicted_slots']} assigned head "
              f"{assigned[:fill]} tail {assigned[-4:]} plateau={plateau} "
              f"max_head={max(assigned[:fill])} cumulative={cumulative} "
              f"checkpoint {os.path.getsize(path)} B "
              f"(busy {st['busy'].get('checkpoint', 0.0):.4f} s)")
        check(bounded, "H2: session.assigned does not plateau "
                       "(bench_windows' capacity_bounded)")
        for i in sorted(picks):
            lo, hi = window_of(i, H2_W, pane_edges, n_edges)
            check(np.array_equal(kept[i].cpu().numpy(),
                                 scipy_oracle(src[lo:hi], dst[lo:hi], n)),
                  f"H2: emission {i} != scipy labels of [{lo}, {hi})")
        _, rst = resume_run(torch, device, plan, source, n, path)
        tail = [kept[i] for i in range(H2_CKPT_EVERY, panes)]
        got = rst.pop("emissions")
        check(len(got) == len(tail)
              and all(torch.equal(a, b) for a, b in zip(got, tail)),
              "H2: the resumed ring's emissions differ")
        busy = " ".join(f"{k}={v:.4f}" for k, v in
                        sorted(rst["busy"].items()))
        print(f"phase H2 resume at pane {H2_CKPT_EVERY} (position "
              f"{2 * H2_CKPT_EVERY}): {len(got)} emissions bit-identical; "
              f"wall={rst['wall_s']:.4f} s first emission "
              f"{rst['first_s']:.4f} s; stage busy s: {busy}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()


def resume_run(torch, device, plan, source, n, path):
    from gelly_torch.core.stream import edge_stream_from_source

    stream = edge_stream_from_source(source(), n, device=device)
    t = time.perf_counter()
    res = stream.aggregate(plan(), merge_every=2, prefetch_depth=0,
                           h2d_depth=0, checkpoint_path=path, resume=True,
                           checkpoint_every=H2_CKPT_EVERY)
    out, first = [], None
    for x in res:
        first = first or time.perf_counter() - t
        out.append(x)
    torch.cuda.synchronize()
    return None, {"wall_s": time.perf_counter() - t, "emissions": out,
                  "busy": res.timer.busy(), "first_s": first}


def event_time_phase(torch, device, src, dst, labels4,
                     dedup_chunks: int) -> None:
    """H3 (bench_cc's event-time pair) and H4 (allowed lateness)."""
    import importlib

    from gelly_torch.core.io import EdgeChunkSource, TimeCharacteristic
    from gelly_torch.core.stream import edge_stream_from_source
    from gelly_torch.core.vertices import IdentityVertexTable
    from gelly_torch.ops import kernels

    cc = importlib.import_module("gelly_torch.library.connected_components")
    n = N_VERTICES
    ts = np.arange(N_EDGES, dtype=np.int64)

    def source(stamps):
        return EdgeChunkSource(src, dst, timestamps=stamps, chunk_size=CHUNK,
                               table=IdentityVertexTable(n),
                               time=TimeCharacteristic.EVENT)

    pull = lambda x: x.cpu().numpy()  # noqa: E731
    for name, kw, expect in (
            ("codec (sparse)", {}, {}),
            ("raw plain", dict(ingest_combine=False), {}),
            ("raw kernel", dict(ingest_combine=False, fold_backend="kernel"),
             {"sorted_window_gather": 3 * dedup_chunks})):
        out, st = drive(torch, device, cc.connected_components(n, **kw),
                        source(ts), n, N_EDGES, None, 1, pull,
                        window_ms=H3_WINDOW_MS)
        report_run(f"phase H3 window_ms {name}", st, expect=expect)
        check(len(out) == len(labels4),
              f"H3 {name}: {len(out)} windows != {len(labels4)}")
        for i, (a, b) in enumerate(zip(out, labels4)):
            check(same(a, b), f"H3 {name}: window {i} != phase 4's "
                              "emission at the same boundary")
        check(st["stats"]["late_edges"] == 0, f"H3 {name}: late edges")
    # H4: timestamps permuted inside each block, within the lateness.
    rng = np.random.default_rng(H4_SEED)
    ts4 = rng.permuted(ts.reshape(-1, H4_BLOCK), axis=1).reshape(-1)
    peak = {"buffered_edges": 0, "open_windows": 0}

    class Sampled:
        """The source, sampling the reorder buffer's stats a chunk."""

        def __init__(self, inner):
            self.inner, self.table, self.stats = inner, inner.table, None

        def __iter__(self):
            for c in self.inner:
                if self.stats is not None:
                    for k in peak:
                        peak[k] = max(peak[k], self.stats.get(k, 0))
                yield c

    sampled = Sampled(source(ts4))
    stream = edge_stream_from_source(sampled, n, device=device)
    plan = lambda: cc.connected_components(n, ingest_combine=False)  # noqa
    torch.cuda.synchronize()
    reset_launches(kernels)
    t = time.perf_counter()
    res = stream.aggregate(plan(), window_ms=H3_WINDOW_MS,
                           allowed_lateness=H4_BLOCK)
    sampled.stats = res.stats
    out = [pull(x) for x in res]
    wall = time.perf_counter() - t
    check(len(out) == len(labels4)
          and all(same(a, b) for a, b in zip(out, labels4)),
          "H4: the reordered stream's windows differ from H3's")
    check(res.stats["late_edges"] == 0, f"H4: {res.stats['late_edges']} "
                                        "late edges")
    check(launch_counts(kernels) == NO_LAUNCHES, "H4 launched a kernel")
    print(f"phase H4 allowed_lateness={H4_BLOCK}: wall={wall:.4f} s "
          f"{N_EDGES / wall:.1f} edges/s late_edges=0 peak buffered_edges="
          f"{peak['buffered_edges']} peak open_windows="
          f"{peak['open_windows']}; 4 windows equal H3's")
    tmp = tempfile.mkdtemp(prefix="gelly-h4-")
    try:
        path = os.path.join(tmp, "lat.npz")
        kw = dict(window_ms=H3_WINDOW_MS, allowed_lateness=H4_BLOCK,
                  checkpoint_path=path, checkpoint_every=1)
        it = iter(edge_stream_from_source(source(ts4), n, device=device)
                  .aggregate(plan(), **kw))
        next(it), next(it)
        it.close()
        sides = [f for f in os.listdir(tmp) if ".lateness." in f]
        res = edge_stream_from_source(source(ts4), n, device=device) \
            .aggregate(plan(), resume=True, **kw)
        t = time.perf_counter()
        got = [pull(x) for x in res]
        check(len(sides) == 1 and 0 < len(got) < len(out)
              and all(same(a, b) for a, b in zip(got, out[-len(got):])),
              f"H4: the resumed run ({len(got)} emissions, sidecars "
              f"{sides}) differs from the uninterrupted one")
        print(f"phase H4 stop after emission 2 and resume at position "
              f"{res.stats['resumed_at']}: {len(got)} emissions equal, "
              f"sidecar {sides[0]}, wall={time.perf_counter() - t:.4f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()


def windowed_degrees_phase(torch, device, src, dst) -> None:
    """H5: degree_aggregate(windowed=8), 64 panes."""
    from gelly_torch.core.io import EdgeChunkSource
    from gelly_torch.core.vertices import IdentityVertexTable
    from gelly_torch.library import degrees

    n = N_VERTICES
    pane_edges = H_CHUNK * H5_MERGE_EVERY
    panes = N_EDGES // pane_edges
    picks = {H5_W - 1, panes // 2, panes - 1}
    kept, st = ring_run(
        torch, device, degrees.degree_aggregate(n, windowed=H5_W),
        EdgeChunkSource(src, dst, chunk_size=H_CHUNK,
                        table=IdentityVertexTable(n)),
        n, N_EDGES, H5_MERGE_EVERY, picks)
    report_run("phase H5 windowed degrees", st)
    for i in sorted(picks):
        lo, hi = window_of(i, H5_W, pane_edges, N_EDGES)
        want = (np.bincount(src[lo:hi], minlength=n)
                + np.bincount(dst[lo:hi], minlength=n))
        got = kept[i].cpu().numpy()
        check(got.dtype == np.int64 and np.array_equal(got, want),
              f"H5: emission {i} != bincount of [{lo}, {hi})")
    print(f"phase H5: {st['closes']} closes, combines "
          f"{st['stats']['windows.combine_dispatches']}, emissions "
          f"{sorted(picks)} equal np.bincount")
    torch.cuda.empty_cache()


def hash_bound(n_keys: int, n_new: int) -> tuple[float, int]:
    """Least bytes of an insert: keys and mask read once, the mask out
    written once, each new key's slot written once."""
    b = n_keys * (8 + 1 + 1) + 8 * n_new
    return b / HBM_BYTES_PER_S * 1e3, b


def distinct_phase(torch, device, src, dst) -> dict:
    """I1: distinct(device=True) through the hash-set kernel."""
    from gelly_torch.core.io import EdgeChunkSource
    from gelly_torch.core.stream import edge_stream_from_source
    from gelly_torch.core.vertices import IdentityVertexTable
    from gelly_torch.ops import hashset, kernels

    n = N_VERTICES
    s, d = src[:I1_EDGES], dst[:I1_EDGES]

    def stream():
        return edge_stream_from_source(EdgeChunkSource(
            s, d, chunk_size=CHUNK, table=IdentityVertexTable(n)), n,
            device=device)

    keys = s.astype(np.int64) * n + d
    _, first = np.unique(keys, return_index=True)
    oracle = np.zeros(I1_EDGES, bool)
    oracle[first] = True
    torch.cuda.synchronize()
    reset_launches(kernels)
    # The first call inserts the first chunk into the empty table.
    with GateTimer(torch, kernels, "hashset_insert",
                   kernels.hashset_insert, capture=0) as gt:
        t = time.perf_counter()
        dev = stream().distinct(device=True)
        masks = [c.valid for c in dev]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        hset = dev.hashset
        absent = torch.arange(I1_ABSENT, dtype=torch.int64,
                              device=device) + n * n  # above every key
        present = torch.from_numpy(keys).to(device)
        found = hashset.contains_chunk(hset.state, present)
        missing = hashset.contains_chunk(hset.state, absent)
        launches = launch_counts(kernels)
    ms, sizes = zip(*((m, info["shapes"][2][0])
                      for m, info in gt.timings()))
    t = time.perf_counter()
    host = [c.valid.numpy() for c in stream().distinct()]
    host_wall = time.perf_counter() - t
    got = np.concatenate([m.cpu().numpy() for m in masks])
    check(np.array_equal(got, oracle), "I1: device masks != numpy "
                                       "first-occurrence oracle")
    check(np.array_equal(np.concatenate(host), oracle),
          "I1: host masks != oracle")
    check(bool(found.all()) and not bool(missing.any()),
          "I1: hashset_contains wrong on the inserted or absent keys")
    check(int(hset.state.count) == int(oracle.sum()), "I1: count")
    counts = dict(zip(HAND_KERNELS, launches))
    n_chunks = I1_EDGES // CHUNK
    check(counts["hashset_insert"] == n_chunks + hset.rehashes
          and counts["hashset_contains"] == 2
          and sum(launches) == n_chunks + hset.rehashes + 2,
          f"I1 launches {counts}")
    print(f"phase I1 distinct(device=True): {I1_EDGES} edges, "
          f"{int(oracle.sum())} distinct, wall={wall:.4f} s "
          f"{I1_EDGES / wall:.1f} edges/s; host path wall={host_wall:.4f} s "
          f"{I1_EDGES / host_wall:.1f} edges/s; insert launches (keys, ms): "
          f"{list(zip(sizes, [round(x, 4) for x in ms]))}; rehashes="
          f"{hset.rehashes} ({hset.rehash_s:.4f} s) table "
          f"{hset.state.keys.shape[0]} slots; contains all true on "
          f"{I1_EDGES}, all false on {I1_ABSENT} absent keys")
    chunk_ms = [m for m, k in zip(ms, sizes) if k == CHUNK]
    # The insert kernel at the path's shape, against its plain version:
    # the first chunk's table (slot layout), count and is_new.
    args, got = gt.captured, gt.captured_out
    gt.captured = gt.captured_out = None
    check(args[2].shape[0] == CHUNK, "I1: the first insert is not a chunk")
    t = time.perf_counter()
    want = kernels.hashset_insert_plain(*args)
    i_plain_ms = (time.perf_counter() - t) * 1e3
    for a, b, what in zip(got, want, ("table", "count", "is_new")):
        check(torch.equal(a, b), f"I1: hashset_insert's {what} != its "
                                 "plain version on the first chunk")
    n_new = int(want[2].sum())
    i_bound_ms, i_bound_b = hash_bound(CHUNK, n_new)
    # The same insert again after one call that warms it (the caching
    # allocator then holds its work area), mean of 5, beside the path's
    # own first and second calls.
    i_ms = time_ms(torch, lambda: kernels.hashset_insert(*args), device,
                   reps=5, warmup=1)
    print(f"phase I1 first chunk: {CHUNK} keys into {args[0].shape[0]} "
          f"slots, {n_new} new; table, count and is_new equal the plain "
          f"version; kernel_ms={i_ms:.6f} (warm; the path's calls "
          f"{ms[0]:.6f} and {ms[1]:.6f}) "
          f"plain_ms={i_plain_ms:.6f} (host clock) bound_ms="
          f"{i_bound_ms:.6f} ({i_bound_b} B)")
    del args, got, want
    # The contains kernel at the path's shape, against its plain version.
    q = torch.cat([present, absent])
    c_ms = time_ms(torch, lambda: kernels.hashset_contains(
        hset.state.keys, q), device, reps=5, warmup=1)
    t = time.perf_counter()
    c_plain = kernels.hashset_contains_plain(hset.state.keys, q)
    c_plain_ms = (time.perf_counter() - t) * 1e3
    check(torch.equal(c_plain.to(device),
                      kernels.hashset_contains(hset.state.keys, q)),
          "hashset_contains != its plain version at I1's shape")
    cb = q.shape[0] * (8 + 1 + 8)
    return {"insert_launches": counts["hashset_insert"],
            "contains_launches": counts["hashset_contains"],
            "chunk_ms": chunk_ms, "path_first_ms": ms[0],
            "path_second_ms": ms[1], "insert_ms": i_ms,
            "insert_plain_ms": i_plain_ms, "insert_bound_ms": i_bound_ms,
            "contains_ms": c_ms,
            "contains_plain_ms": c_plain_ms,
            "contains_bound_ms": cb / HBM_BYTES_PER_S * 1e3,
            "contains_keys": int(q.shape[0])}


def hash_kernel_phase(torch, device) -> dict:
    """The insert kernel against its plain version on a random state:
    a prefilled table (long probe runs, wrap-around), duplicate keys."""
    from gelly_torch.ops import kernels

    g = np.random.default_rng(SEED)
    table = torch.full((HASH_PLAIN_CAP,), kernels.HASH_EMPTY,
                       dtype=torch.int64)
    count = torch.zeros((), dtype=torch.int32)
    pre = torch.from_numpy(g.choice(1 << 40, HASH_PLAIN_FILL,
                                    replace=False).astype(np.int64))
    table, count, _ = kernels.hashset_insert_plain(
        table, count, pre, torch.ones(HASH_PLAIN_FILL, dtype=torch.bool))
    keys = g.integers(0, 1 << 40, HASH_PLAIN_KEYS).astype(np.int64)
    keys[g.random(HASH_PLAIN_KEYS) < 0.3] = keys[0]
    keys = torch.from_numpy(keys)
    valid = torch.from_numpy(g.random(HASH_PLAIN_KEYS) < 0.95)
    t = time.perf_counter()
    want = kernels.hashset_insert_plain(table, count, keys, valid)
    plain_ms = (time.perf_counter() - t) * 1e3
    args = [x.to(device) for x in (table, count, keys, valid)]
    got = kernels.hashset_insert(*args)
    torch.cuda.synchronize()
    err = 0
    for a, b in zip(got, want):
        check(torch.equal(a.cpu(), b), "hashset_insert != its plain version")
    ms = time_ms(torch, lambda: kernels.hashset_insert(*args), device,
                 reps=5, warmup=1)
    n_new = int(want[2].sum())
    bound_ms, bound_b = hash_bound(HASH_PLAIN_KEYS, n_new)
    print(f"kernel hashset_insert: {HASH_PLAIN_KEYS} keys into "
          f"{HASH_PLAIN_CAP} slots ({HASH_PLAIN_FILL} prefilled), "
          f"{n_new} new, exact=True kernel_ms={ms:.6f} plain_ms="
          f"{plain_ms:.6f} (host clock) bound_ms={bound_ms:.6f} ({bound_b} "
          f"B) chain floor: {int(valid.sum())} dependent probes")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "max_abs_err": err,
            "adversarial": hash_adversarial_case(torch, device)}


def hash_adversarial_case(torch, device) -> dict:
    """The insert kernel against its plain version where parallel walks
    meet most: HASH_ADV_KEYS keys whose homes are HASH_ADV_HOMES slots of
    a HASH_ADV_CAP-slot table filled to HASH_ADV_LOAD (runs of new keys
    through the filled clusters), lane i + HASH_ADV_KEYS / 2 repeating
    lane i, a few dead lanes."""
    from gelly_torch.ops import kernels

    g = np.random.default_rng(SEED + 1)
    cap, half = HASH_ADV_CAP, HASH_ADV_KEYS // 2
    is_home = np.zeros(cap, bool)
    is_home[g.choice(cap, HASH_ADV_HOMES, replace=False)] = True
    found = np.zeros(0, np.int64)
    while found.size < half:  # keys below 2^40 that hash to the homes
        cand = g.integers(0, 1 << 40, 1 << 24, dtype=np.int64)
        found = np.unique(np.concatenate([
            found, cand[is_home[kernels._hash_np(cand, cap - 1)]]]))
    keys = g.permutation(found)[:half]
    keys = torch.from_numpy(np.concatenate([keys, keys]))
    valid = torch.from_numpy(g.random(HASH_ADV_KEYS) < 0.99)
    # The filled table (keys from 2^40 up, none of the chunk's), built on
    # the card; both versions start from it.
    fill = int(HASH_ADV_LOAD * cap)
    pre = torch.from_numpy(g.choice(1 << 40, fill, replace=False)
                           + (1 << 40)).to(device)
    table, count, _ = kernels.hashset_insert(
        torch.full((cap,), kernels.HASH_EMPTY, dtype=torch.int64,
                   device=device),
        torch.zeros((), dtype=torch.int32, device=device), pre,
        torch.ones(fill, dtype=torch.bool, device=device))
    args = [table, count, keys.to(device), valid.to(device)]
    got = kernels.hashset_insert(*args)
    torch.cuda.synchronize()
    host = [x.cpu() for x in args]
    t = time.perf_counter()
    want = kernels.hashset_insert_plain(*host)
    plain_ms = (time.perf_counter() - t) * 1e3
    for a, b, what in zip(got, want, ("table", "count", "is_new")):
        check(torch.equal(a.cpu(), b), f"hashset_insert's {what} != its "
                                       "plain version on the adversarial "
                                       "case")
    ms = time_ms(torch, lambda: kernels.hashset_insert(*args), device,
                 reps=5, warmup=1)
    # How far the chunk's keys settled from their homes.
    t_np = want[0].numpy()
    mine = np.flatnonzero((t_np >= 0) & (t_np < (1 << 40)))
    dist = (mine - kernels._hash_np(t_np[mine], cap - 1)) & (cap - 1)
    n_new = int(want[2].sum())
    bound_ms, bound_b = hash_bound(HASH_ADV_KEYS, n_new)
    print(f"kernel hashset_insert adversarial: {HASH_ADV_KEYS} keys homed "
          f"in {HASH_ADV_HOMES} slots of {cap} filled to {HASH_ADV_LOAD}, "
          f"lanes i and i + {half} one key: {n_new} new, table, count and "
          f"is_new equal the plain version's; probe distance of the new "
          f"keys mean {float(dist.mean()):.2f} max {int(dist.max())}; "
          f"kernel_ms={ms:.6f} plain_ms={plain_ms:.2f} (host clock) "
          f"bound_ms={bound_ms:.6f} ({bound_b} B)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "new": n_new, "max_probe": int(dist.max())}


def transforms_phase(torch, device, src, dst) -> None:
    """I2: the EdgeStream transforms on a prefix, against numpy."""
    from gelly_torch.core.io import EdgeChunkSource
    from gelly_torch.core.stream import EdgeStream, edge_stream_from_source
    from gelly_torch.core.vertices import IdentityVertexTable

    n = N_VERTICES
    s = src[:I2_PREFIX].astype(np.int64)
    d = dst[:I2_PREFIX].astype(np.int64)
    ones = np.ones(I2_PREFIX, np.float32)
    table = IdentityVertexTable(n)
    base = edge_stream_from_source(EdgeChunkSource(
        s, d, chunk_size=I2_CHUNK, table=table), n, device=device)

    def tuples(a, b, v):
        return list(zip(a.tolist(), b.tolist(), v.tolist()))

    keep_e = (s + d) % 3 == 0
    keep_v = (s % 2 == 0) & (d % 2 == 0)
    cases = [
        ("map_edges", base.map_edges(lambda a, b, v: v * 2 + (a % 3).to(
            v.dtype)), tuples(s, d, 2 * ones + (s % 3))),
        ("filter_edges", base.filter_edges(lambda a, b, v: (a + b) % 3 == 0),
         tuples(s[keep_e], d[keep_e], ones[keep_e])),
        ("filter_vertices", base.filter_vertices(lambda v: v % 2 == 0),
         tuples(s[keep_v], d[keep_v], ones[keep_v])),
        ("reverse", base.reverse(), tuples(d, s, ones)),
    ]
    und = []
    for lo in range(0, I2_PREFIX, I2_CHUNK):
        sl = slice(lo, lo + I2_CHUNK)
        und += tuples(s[sl], d[sl], ones[sl]) + tuples(d[sl], s[sl], ones[sl])
    cases.append(("undirected", base.undirected(), und))
    s2 = src[I2_PREFIX:2 * I2_PREFIX].astype(np.int64)
    d2 = dst[I2_PREFIX:2 * I2_PREFIX].astype(np.int64)
    other_src = EdgeChunkSource(s2, d2, chunk_size=I2_CHUNK, table=table)
    other = EdgeStream(lambda: iter(other_src), base.ctx)
    uni = []
    for lo in range(0, I2_PREFIX, I2_CHUNK):
        sl = slice(lo, lo + I2_CHUNK)
        uni += tuples(s[sl], d[sl], ones[sl]) + tuples(s2[sl], d2[sl],
                                                       ones[sl])
    cases.append(("union", base.union(other), uni))
    for name, stream, want in cases:
        t = time.perf_counter()
        got = stream.collect_edges()
        wall = time.perf_counter() - t
        check(got == want, f"I2 {name}: collect_edges != numpy")
        print(f"phase I2 {name}: {len(got)} edges equal numpy, collect "
              f"{wall:.4f} s")


def iterative_cc_phase(torch, device, src, dst, oracle) -> None:
    """I3: IterativeCCStream over phase 4's stream."""
    from gelly_torch.core.io import EdgeChunkSource
    from gelly_torch.core.stream import edge_stream_from_source
    from gelly_torch.core.vertices import IdentityVertexTable
    from gelly_torch.library import IterativeCCStream
    from gelly_torch.ops import kernels, unionfind

    n = N_VERTICES
    stream = edge_stream_from_source(EdgeChunkSource(
        src, dst, chunk_size=CHUNK, table=IdentityVertexTable(n)), n,
        device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches(kernels)
    unionfind.host_sync.count = 0
    t = time.perf_counter()
    lab = IterativeCCStream(stream).final_labels()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    rounds = unionfind.host_sync.count / (N_EDGES // CHUNK)
    check(launch_counts(kernels) == NO_LAUNCHES, "I3 launched a kernel")
    lab = lab.cpu().numpy()
    seen = lab >= 0
    check(np.array_equal(seen, oracle >= 0), "I3: seen slots != scipy's")
    check(np.array_equal(oracle[lab[seen]], oracle[seen])
          and bool((lab[seen] >= oracle[seen]).all()),
          "I3: a label outside its slot's scipy component")
    stale = int((lab != oracle).sum())
    roots = int(np.unique(lab[seen & (lab != oracle)]).size)
    print(f"phase I3 IterativeCCStream.final_labels: wall={wall:.4f} s "
          f"{N_EDGES / wall:.1f} edges/s rounds (host syncs) a chunk="
          f"{rounds:.2f} peak_mem={torch.cuda.max_memory_allocated(device)} B;"
          f" every label in its scipy component; {stale} slots keep a "
          f"stale root label ({roots} roots; gelly_tpu's semantics) and "
          f"{int(seen.sum()) - stale} equal scipy's minimum")


def hamiltonian_cycles(n: int, cycles: int, seed: int):
    rng = np.random.default_rng(seed)
    s, d = [], []
    for _ in range(cycles):
        p = rng.permutation(n).astype(np.int32)
        s.append(p)
        d.append(np.roll(p, -1))
    return np.concatenate(s), np.concatenate(d)


def rows_oracle(torch, s, d, n: int, max_degree: int, device):
    """The undirected row table a stream must give, with torch sorts on
    the card: each row's distinct neighbours in first-seen order."""
    s = torch.from_numpy(s).to(device).to(torch.int64)
    d = torch.from_numpy(d).to(device).to(torch.int64)
    a = torch.stack([s, d], 1).reshape(-1)
    b = torch.stack([d, s], 1).reshape(-1)
    pos = torch.arange(a.shape[0], device=a.device)
    key = a * n + b
    uk, inv = torch.unique(key, return_inverse=True)
    first = torch.full((uk.shape[0],), a.shape[0], dtype=torch.int64,
                       device=a.device)
    first = first.scatter_reduce(0, inv, pos, "amin")
    keep = first[inv] == pos
    a, b, pos = a[keep], b[keep], pos[keep]
    order = torch.sort(a * a.shape[0] + pos).indices  # row, then stream
    a, b = a[order], b[order]
    deg = torch.bincount(a, minlength=n).to(torch.int32)
    start = torch.cumsum(deg.long(), 0) - deg.long()
    rank = torch.arange(a.shape[0], device=a.device) - start[a]
    fits = rank < max_degree
    nbr = torch.full((n, max_degree), -1, dtype=torch.int32, device=a.device)
    nbr[a[fits], rank[fits]] = b[fits].to(torch.int32)
    over = int((~fits).sum())
    return nbr, deg.clamp(max=max_degree), over


def neighborhood_phase(torch, device) -> dict:
    """I4: build_neighborhood(max_degree=16) through the row kernel."""
    from gelly_torch.core.io import EdgeChunkSource, TimeCharacteristic
    from gelly_torch.core.stream import edge_stream_from_source
    from gelly_torch.core.vertices import IdentityVertexTable
    from gelly_torch.ops import kernels

    n = N_VERTICES
    t0 = time.perf_counter()
    s, d = hamiltonian_cycles(n, I4_CYCLES, I4_SEED)
    n_e = s.shape[0]
    print(f"phase I4 stream: {I4_CYCLES} random Hamiltonian cycles over {n} "
          f"slots ({n_e} edges) in {time.perf_counter() - t0:.2f} s")

    def stream(a, b, nn):
        return edge_stream_from_source(EdgeChunkSource(
            a, b, timestamps=np.arange(a.shape[0], dtype=np.int64),
            chunk_size=CHUNK, table=IdentityVertexTable(nn),
            time=TimeCharacteristic.EVENT), nn, device=device)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches(kernels)
    with GateTimer(torch, kernels, "row_insert_chunk",
                   kernels.row_insert_chunk) as gt:
        t = time.perf_counter()
        ns = stream(s, d, n).build_neighborhood(max_degree=I4_MAX_DEGREE)
        nbr, deg = ns.final_adjacency()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = launch_counts(kernels)
    ms = [m for m, _ in gt.timings()]
    counts = dict(zip(HAND_KERNELS, launches))
    n_chunks = n_e // CHUNK
    check(counts["row_insert_chunk"] == n_chunks
          and sum(launches) == n_chunks, f"I4 launches {counts}")
    peak = torch.cuda.max_memory_allocated(device)
    want_nbr, want_deg, want_over = rows_oracle(torch, s, d, n,
                                                I4_MAX_DEGREE, device)
    check(want_over == 0, "I4: the oracle overflows")
    check(torch.equal(nbr.cpu(), want_nbr.cpu())
          and torch.equal(deg.cpu(), want_deg.cpu()),
          "I4: the row table != the oracle")
    print(f"phase I4 build_neighborhood(max_degree={I4_MAX_DEGREE}): "
          f"wall={wall:.4f} s {n_e / wall:.1f} edges/s peak_mem={peak} B "
          f"row_insert_chunk launches={counts['row_insert_chunk']} ms a "
          f"chunk {[round(x, 4) for x in ms]}; nbr, deg, over=0 equal the "
          f"oracle; max degree {int(deg.max())}")
    # The kernel against the plain row step on the first edges.
    st0 = (torch.full((n, I4_MAX_DEGREE), -1, dtype=torch.int32,
                      device=device),
           torch.zeros(n, dtype=torch.int32, device=device),
           torch.zeros((), dtype=torch.int32, device=device))
    ps = torch.from_numpy(s[:I4_PLAIN_EDGES]).to(device)
    pd = torch.from_numpy(d[:I4_PLAIN_EDGES]).to(device)
    pv = torch.ones(I4_PLAIN_EDGES, dtype=torch.bool, device=device)
    got = kernels.row_insert_chunk(*st0, ps, pd, pv, False, I4_MAX_DEGREE)
    t = time.perf_counter()
    want = kernels.row_insert_chunk_plain(*st0, ps, pd, pv, False,
                                          I4_MAX_DEGREE)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "row_insert_chunk != the plain row step")
    k_ms = time_ms(torch, lambda: kernels.row_insert_chunk(
        *st0, ps, pd, pv, False, I4_MAX_DEGREE), device, reps=5, warmup=1)
    rows = int(torch.unique(torch.cat([ps, pd])).numel())
    bound_b = I4_PLAIN_EDGES * 9 + rows * (I4_MAX_DEGREE * 4 + 8) \
        + 2 * I4_PLAIN_EDGES * 4
    bound_ms = bound_b / HBM_BYTES_PER_S * 1e3
    print(f"kernel row_insert_chunk: first {I4_PLAIN_EDGES} edges, exact="
          f"True kernel_ms={k_ms:.6f} plain_ms={plain_ms:.6f} (host clock) "
          f"bound_ms={bound_ms:.6f} ({bound_b} B) chain floor: the longest "
          f"row run")
    # A degree-17 vertex raises gelly_tpu's overflow message.
    star = np.zeros(I4_MAX_DEGREE + 1, np.int32)
    leaves = np.arange(1, I4_MAX_DEGREE + 2, dtype=np.int32)
    try:
        stream(star, leaves, 64).build_neighborhood(
            max_degree=I4_MAX_DEGREE).final_adjacency()
        raise RuntimeError("chip_smoke: I4 degree 17 did not raise")
    except ValueError as e:
        check(str(e) == f"1 neighbor inserts exceeded max_degree "
                        f"{I4_MAX_DEGREE}; raise max_degree or use the "
                        "dense path", f"I4 overflow message: {e}")
    # The dense path at N = 2^14 against the row table of the same edges.
    sd, dd = hamiltonian_cycles(I4_DENSE_N, I4_CYCLES, I4_SEED + 1)
    adj = stream(sd, dd, I4_DENSE_N).build_neighborhood().final_adjacency()
    want = torch.zeros_like(adj)
    a = torch.from_numpy(sd).to(device).long()
    b = torch.from_numpy(dd).to(device).long()
    want[a, b] = True
    want[b, a] = True
    rn, rd = stream(sd, dd, I4_DENSE_N).build_neighborhood(
        max_degree=I4_MAX_DEGREE).final_adjacency()
    from_rows = torch.zeros_like(adj)
    r = torch.arange(I4_DENSE_N, device=device)[:, None].expand_as(rn)
    ok = rn >= 0
    from_rows[r[ok], rn[ok].long()] = True
    check(torch.equal(adj, want) and torch.equal(adj, from_rows),
          "I4 dense path != the oracle / the row table")
    print(f"phase I4 dense path N={I4_DENSE_N}: adjacency equals the "
          f"oracle and the row table; degree 17 raises the reference's "
          f"message")
    return {"launches": counts["row_insert_chunk"], "ms": k_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "chunk_ms": ms, "s": s, "d": d}


def snapshot_phase(torch, device, tsrc, tdst, i4) -> None:
    """I5: SnapshotStream over phase 6's windows (and fold_neighbors on
    I4's stream)."""
    from gelly_torch.core.io import EdgeChunkSource, TimeCharacteristic
    from gelly_torch.core.stream import edge_stream_from_source
    from gelly_torch.core.vertices import IdentityVertexTable
    from gelly_torch.ops import segments

    n = TRI_N

    def tri():
        return edge_stream_from_source(EdgeChunkSource(
            tsrc, tdst, timestamps=np.arange(TRI_EDGES, dtype=np.int64),
            chunk_size=TRI_CHUNK, table=IdentityVertexTable(n),
            time=TimeCharacteristic.EVENT), n, device=device).map_edges(
            lambda a, b, v: ((a + b) % 7).to(torch.int32))

    def window_np(w, lo_edges, src_, dst_):
        lo, hi = w * lo_edges, (w + 1) * lo_edges
        a = np.concatenate([src_[lo:hi], dst_[lo:hi]]).astype(np.int64)
        b = np.concatenate([dst_[lo:hi], src_[lo:hi]]).astype(np.int64)
        return a, b

    t = time.perf_counter()
    reds = list(tri().slice(TRI_WINDOW_MS, "all",
                            window_capacity=TRI_WINDOW_CAPACITY)
                .reduce_on_edges(torch.add))
    torch.cuda.synchronize()
    red_wall = time.perf_counter() - t
    t = time.perf_counter()
    maxes = list(tri().slice(TRI_WINDOW_MS, "all",
                             window_capacity=TRI_WINDOW_CAPACITY)
                 .apply_on_neighbors(lambda v: segments.masked_scatter_max(
                     torch.full((n,), -1, dtype=torch.int32, device=device),
                     v.key, v.nbr, v.valid)))
    torch.cuda.synchronize()
    app_wall = time.perf_counter() - t
    check(len(reds) == len(maxes) == TRI_EDGES // TRI_WINDOW_MS,
          "I5: window count")
    for w, (upd, (w2, mx)) in enumerate(zip(reds, maxes)):
        a, b = window_np(w, TRI_WINDOW_MS, tsrc, tdst)
        v = (a + b) % 7
        sums = np.bincount(a, weights=v, minlength=n).astype(np.int64)
        m = upd.valid.cpu().numpy()
        slots = upd.slots.cpu().numpy()[m]
        vals = upd.values.cpu().numpy()[m]
        check(upd.window == w2 == w and np.array_equal(
            np.sort(slots), np.unique(a))
            and np.array_equal(vals.astype(np.int64), sums[slots]),
            f"I5: reduce_on_edges window {w} != numpy")
        want = np.full(n, -1, np.int64)
        np.maximum.at(want, a, b)
        check(np.array_equal(mx.cpu().numpy().astype(np.int64), want),
              f"I5: apply_on_neighbors window {w} != numpy")
    print(f"phase I5 reduce_on_edges (int32 add, 'all'): 4 windows equal "
          f"numpy, wall={red_wall:.4f} s; apply_on_neighbors (max "
          f"neighbour): equal, wall={app_wall:.4f} s")
    s, d = i4["s"], i4["d"]
    n4 = N_VERTICES
    hi = I5_FOLD_WINDOW * I5_FOLD_WINDOWS
    st = edge_stream_from_source(EdgeChunkSource(
        s[:hi], d[:hi], timestamps=np.arange(hi, dtype=np.int64),
        chunk_size=I5_FOLD_WINDOW, table=IdentityVertexTable(n4),
        time=TimeCharacteristic.EVENT), n4, device=device)
    init = (torch.zeros((), dtype=torch.int64),
            torch.zeros((), dtype=torch.int64))
    t = time.perf_counter()
    folds = list(st.slice(I5_FOLD_WINDOW, "all",
                          window_capacity=2 * I5_FOLD_WINDOW).fold_neighbors(
        init, lambda acc, v, nb, val: (acc[0] + 1, acc[1] + nb)))
    torch.cuda.synchronize()
    fold_wall = time.perf_counter() - t
    check(len(folds) == I5_FOLD_WINDOWS, "I5: fold windows")
    for w, upd in enumerate(folds):
        a, b = window_np(w, I5_FOLD_WINDOW, s, d)
        m = upd.valid.cpu().numpy()
        slots = upd.slots.cpu().numpy()[m]
        cnt = upd.values[0].cpu().numpy()[m]
        tot = upd.values[1].cpu().numpy()[m]
        check(np.array_equal(cnt, np.bincount(a, minlength=n4)[slots])
              and np.array_equal(tot, np.bincount(
                  a, weights=b, minlength=n4).astype(np.int64)[slots]),
              f"I5: fold_neighbors window {w} != numpy")
    print(f"phase I5 fold_neighbors (count, neighbour sum) on I4's first "
          f"{hi} edges in {I5_FOLD_WINDOWS} windows: equal numpy, "
          f"wall={fold_wall:.4f} s")


# ---------------------------------------------------------------------- #
# J. the rest of the triangle library

J1_N = 1 << 20
J1_EDGES = 10_000_000
J1_SEED = 31
J1_ZIPF = 1.6
J1_WINDOW = J1_EDGES // 10
J1_CAPACITY = 4 * J1_WINDOW
J1_BATCH = 10
J1_CHUNK = 1 << 20
J2_N = 1 << 16
J2_EDGES = 1 << 24
J2_WINDOW = 1 << 22
J2_CAPACITY = 1 << 23
J2_CHUNK = 1 << 20
J2_SAMPLE = 1 << 16
J3_N = 1 << 24
J3_SEED = 23
J3_WINDOW = 1 << 23
J3_CAPACITY = (1 << 24) + 64  # room for the degree-9 vertex's 9 edges
J3_MAX_DEGREE = 8
J3_BATCH = 4
J3_CHUNK = 1 << 22
J3_HUB_WINDOW = 2
J4_N = 1 << 12
J4_EDGES = 1 << 19
J4_CHUNK = 1 << 17
J5_CHUNK = 1 << 22
J6_SAMPLES = 1 << 16
J6_SEED = 0xDEADBEEF
J6_PLAIN_LANES = 1 << 9  # a cut of 2^12: the plain version's host loop
J3_SMALL_N = 1 << 16  # the J3/J5 oracle formula held to scipy here
# INT32 peak of an H100 SXM: 64 INT32 lanes a SM (half the 128 FP32
# lanes behind the data sheet's 67 TFLOP/s f32 FMA figure), 132 SMs,
# 1.98 GHz.
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# Integer operations of one Threefry-2x32 hash: 20 rounds of add, rotate
# and xor, 5 key injections of 3 adds, the key schedule's 2 xors.
HASH_OPS = 20 * 3 + 5 * 3 + 2


def simple_edges(src, dst, n: int):
    """``(a, b)``, ``a < b``: the simple undirected graph of an edge list
    (self-loops and repeats dropped), ``int64``."""
    a = np.minimum(src, dst).astype(np.int64)
    b = np.maximum(src, dst).astype(np.int64)
    keep = a != b
    key = np.sort(a[keep] * n + b[keep])  # np.unique hashes: slower
    key = key[np.append(True, key[1:] != key[:-1])]
    return key // n, key % n


def oriented(a, b, n: int):
    """The simple graph ``(a, b)`` as a scipy CSR matrix ``D`` with each
    edge oriented toward the endpoint of higher ``(degree, id)``, so that
    no hub row is squared in a product of ``D``: acyclic, with each
    triangle ``u -> v -> w, u -> w`` once."""
    from scipy.sparse import csr_matrix

    deg = np.bincount(a, minlength=n) + np.bincount(b, minlength=n)
    fwd = (deg[a] < deg[b]) | ((deg[a] == deg[b]) & (a < b))
    u = np.where(fwd, a, b)
    v = np.where(fwd, b, a)
    return csr_matrix((np.ones(u.shape[0], np.int64), (u, v)), shape=(n, n))


def triangles_scipy(a, b, n: int) -> int:
    """Triangles of the simple graph ``(a, b)``: ``sum((D @ D) ∘ D)``."""
    d = oriented(a, b, n)
    return int((d @ d).multiply(d).sum())


def vertex_triangles_scipy(a, b, n: int, part: str):
    """One part of ``diag(A³) / 2``, each triangle counted at its three
    vertices: ``"ends"`` its source (row sums of ``(D @ D) ∘ D``) and sink
    (column sums), with the total; ``"middle"`` its middle vertex (row
    sums of ``(Dᵀ D) ∘ D``)."""
    d = oriented(a, b, n)
    if part == "ends":
        t = (d @ d).multiply(d).tocsr()
        return (np.asarray(t.sum(axis=1)).ravel()
                + np.asarray(t.sum(axis=0)).ravel()), int(t.sum())
    return np.asarray((d.T @ d).multiply(d).sum(axis=1)).ravel()


def per_vertex_triangles(ends, middle):
    """``(total, per-vertex int64)`` from the two parts."""
    (per, total) = ends
    per = (per + middle).astype(np.int64)
    check(int(per.sum()) == 3 * total, "oracle: per-vertex sum != 3 x total")
    return total, per


def _oracle_job(job):
    """One oracle in a worker process: a window's count, or a part of the
    whole stream's per-vertex counts."""
    part, src, dst, n = job
    ab = simple_edges(src, dst, n)
    if part == "window":
        return triangles_scipy(*ab, n)
    return vertex_triangles_scipy(*ab, n, part)


def window_oracles(src, dst, n: int, window: int, n_windows: int,
                   whole: bool = False):
    """Each window's oracle count (ts = arange: window ``w`` is one
    contiguous range) and, with ``whole``, the whole stream's ``(total,
    per-vertex)`` last, in up to 8 spawned worker processes (scipy holds
    the interpreter lock); ``(results, seconds)``."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    t0 = time.perf_counter()
    jobs = [(p, src, dst, n) for p in ("ends", "middle")] if whole else []
    jobs += [("window", src[w * window:(w + 1) * window],
              dst[w * window:(w + 1) * window], n) for w in range(n_windows)]
    with ProcessPoolExecutor(
            max_workers=min(8, len(jobs), os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        out = list(pool.map(_oracle_job, jobs))  # the longest jobs first
    if whole:
        out = out[2:] + [per_vertex_triangles(*out[:2])]
    return out, time.perf_counter() - t0


def event_stream(src, dst, n: int, chunk: int, device, ts=None):
    from gelly_torch.core.io import EdgeChunkSource, TimeCharacteristic
    from gelly_torch.core.stream import edge_stream_from_source
    from gelly_torch.core.vertices import IdentityVertexTable

    ts = np.arange(src.shape[0], dtype=np.int64) if ts is None else ts
    return edge_stream_from_source(EdgeChunkSource(
        src, dst, timestamps=ts, chunk_size=chunk,
        table=IdentityVertexTable(n), time=TimeCharacteristic.EVENT),
        n, device=device)


def timed_run(torch, device, fn):
    """``(result, wall_s, peak_bytes, launches)`` of one driven run, every
    hand kernel's count set to 0 just before it."""
    from gelly_torch.ops import kernels

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches(kernels)
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return (out, wall, torch.cuda.max_memory_allocated(device),
            launch_counts(kernels))


def report_j(name, n_events, wall, peak, launches, extra=""):
    print(f"phase {name}: {n_events / wall:.1f} edges/s wall={wall:.4f} s "
          f"peak_mem={peak} B kernel launches={launches}{extra}")


def bucketed_phase(torch, device) -> None:
    """J1: bench.py's degree-bucketed cell (bench_triangles' secondary
    figure), no cut."""
    from gelly_torch.library import triangles as tri

    t0 = time.perf_counter()
    rng = np.random.default_rng(J1_SEED)
    src = (rng.zipf(J1_ZIPF, J1_EDGES) % J1_N).astype(np.int32)
    dst = (rng.zipf(J1_ZIPF, J1_EDGES) % J1_N).astype(np.int32)
    print(f"phase J1 stream: {J1_EDGES} Zipf-{J1_ZIPF} edges over {J1_N} "
          f"slots (seed {J1_SEED}), {J1_EDGES // J1_WINDOW} windows of "
          f"{J1_WINDOW}, in {time.perf_counter() - t0:.2f} s")

    def run():
        out = list(tri.window_triangles_bucketed(
            event_stream(src, dst, J1_N, J1_CHUNK, device), J1_WINDOW,
            window_capacity=J1_CAPACITY, batch=J1_BATCH))
        return [w for w, _ in out], torch.stack([c for _, c in out]).cpu()

    (wins, counts), wall, peak, launches = timed_run(torch, device, run)
    report_j("J1 window_triangles_bucketed", J1_EDGES, wall, peak, launches)
    check(launches == NO_LAUNCHES, "J1 launched a hand kernel")
    n_windows = J1_EDGES // J1_WINDOW
    check(wins == list(range(n_windows)), f"J1 windows {wins}")
    check(counts.dtype == torch.int64, f"J1 count dtype {counts.dtype}")
    # Host prep alone (the worker's share) and the device count alone.
    t0 = time.perf_counter()
    payloads = [tri._bucketize_window(
        src[lo:lo + J1_WINDOW], dst[lo:lo + J1_WINDOW],
        np.ones(J1_WINDOW, bool), J1_N, None)
        for lo in range(0, J1_EDGES, J1_WINDOW)]
    payload, *shape = tri._stack_bucketed(payloads)
    host_s = time.perf_counter() - t0
    dev = tri._tree_map(lambda x: torch.from_numpy(x).to(device), payload)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = tri._window_triangle_count_bucketed_group(dev, *shape).cpu()
    count_s = time.perf_counter() - t0
    check(torch.equal(again, counts), "J1 group count != the path's")
    t_cap, d, h_cap, ladder = shape
    hot = [p["n_hot"] for p in payloads]
    classes = {k: sum(p[k][0].shape[0] for p in payloads)
               for k in ("hh", "hs")}
    ss = sum(b[0].shape[0] for p in payloads for b in p["buckets"])
    print(f"  host prep alone {host_s:.4f} s; device count alone "
          f"{count_s:.4f} s (plain slab loops); t_cap={t_cap} d={d} "
          f"h_cap={h_cap} ladder={ladder} hot rows {min(hot)}-{max(hot)} "
          f"a window; edges: sparse-sparse {ss} hot-sparse {classes['hs']} "
          f"hot-hot {classes['hh']}")
    del dev, payloads, payload
    want, oracle_s = window_oracles(src, dst, J1_N, J1_WINDOW, n_windows)
    for w in range(n_windows):
        check(int(counts[w]) == want[w],
              f"J1 window {w}: {int(counts[w])} != oracle {want[w]}")
    print(f"  oracle: scipy oriented (D @ D) o D equal on {n_windows} "
          f"windows ({sum(want)} triangles) in {oracle_s:.2f} s")
    return {"wall_s": wall, "host_s": host_s, "count_s": count_s}


def unpacked_dense_phase(torch, device) -> dict:
    """J2: phase 6's triangle stream over 2^16 slots: n*n >= 2^31, so the
    unpacked dense path and the wedge kernel at N = 2^16."""
    from gelly_torch.library import triangles as tri
    from gelly_torch.ops import kernels

    t0 = time.perf_counter()
    src, dst = synth_edges(J2_EDGES, J2_N, SEED)
    n_windows = J2_EDGES // J2_WINDOW
    print(f"phase J2 stream: {J2_EDGES} Zipf edges over {J2_N} slots (seed "
          f"{SEED}), {n_windows} windows of {J2_WINDOW}, in "
          f"{time.perf_counter() - t0:.2f} s")

    def stream():
        return event_stream(src, dst, J2_N, J2_CHUNK, device)

    def run():
        out = list(tri.window_triangle_counts_batched(
            stream(), J2_WINDOW, window_capacity=J2_CAPACITY,
            method="auto", batch=4))
        return [w for w, _ in out], torch.stack([c for _, c in out]).cpu()

    (wins, counts), wall, peak, launches = timed_run(torch, device, run)
    wedge_launches = launches[HAND_KERNELS.index("wedge_count_matrix")]
    report_j("J2 unpacked dense (n*n >= 2^31)", J2_EDGES, wall, peak,
             launches)
    check(wins == list(range(n_windows)), f"J2 windows {wins}")
    check(wedge_launches == n_windows,
          f"J2: {wedge_launches} wedge launches != {n_windows} windows")
    want, oracle_s = window_oracles(src, dst, J2_N, J2_WINDOW, n_windows)
    for w in range(n_windows):
        check(int(counts[w]) == want[w],
              f"J2 window {w}: {int(counts[w])} != oracle {want[w]}")
        print(f"  window {w}: {want[w]} triangles (oracle equal)")
    print(f"  oracle: scipy in {oracle_s:.2f} s")

    # Window 0's mask: W against sampled column products, the kernel's
    # time and its bound at N = 2^16.
    _, view = next(iter(stream().slice(
        J2_WINDOW, "all", window_capacity=J2_CAPACITY).views()))
    n = J2_N
    adj = torch.zeros((n, n), dtype=torch.bool, device=device)
    ok = view.valid
    adj.view(-1)[(view.key.long() * n + view.nbr.long())[ok]] = True
    m = adj.triu_(diagonal=1)
    del view, adj
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    w_mat = kernels.wedge_count_matrix(m)
    torch.cuda.synchronize()
    kernel_peak = torch.cuda.max_memory_allocated(device)
    g = torch.Generator(device=device).manual_seed(SEED)
    a = torch.randint(0, n, (J2_SAMPLE,), generator=g, device=device)
    b = torch.randint(0, n, (J2_SAMPLE,), generator=g, device=device)
    got = w_mat[a, b]
    want_w = torch.cat([(m[:, a[i:i + 4096]] & m[:, b[i:i + 4096]]).sum(
        dim=0) for i in range(0, J2_SAMPLE, 4096)]).float()
    err = float((got - want_w).abs().max())
    check(torch.equal(got, want_w),
          f"J2: W != sampled column products (max abs err {err})")
    del w_mat
    flags = kernels.wedge_block_flags_plain(m)
    ops = kernels.wedge_needed_ops(flags)
    live = int(flags.sum())
    del flags
    torch.cuda.empty_cache()
    ms = time_ms(torch, lambda: kernels.wedge_count_matrix(m), device,
                 reps=3, warmup=1)
    ops_ms = ops / INT8_OPS_PER_S * 1e3
    bytes_ms = 5 * n * n / HBM_BYTES_PER_S * 1e3
    bound = max(ops_ms, bytes_ms)
    by = "operations" if ops_ms >= bytes_ms else "bytes"
    print(f"kernel wedge_count_matrix at N={n}: {J2_SAMPLE} sampled W "
          f"entries equal, kernel_ms={ms:.6f} bound_ms={bound:.6f} ({by}: "
          f"{ops // (2 * kernels.TILE ** 3)} live block triples of {live} "
          f"live blocks) peak_mem={kernel_peak} B (mask + Mt + W)")
    del m
    torch.cuda.empty_cache()
    return {"wall_s": wall, "launches": wedge_launches, "ms": ms,
            "bound_ms": bound, "bound_by": by, "max_abs_err": err,
            "peak": peak}


def square_cycle(n: int, seed: int):
    """The square of a random Hamiltonian cycle: edges ``(p[i], p[i+1])``
    and ``(p[i], p[i+2])`` (mod n) in ``i`` order, ``2n`` edges."""
    p = np.random.default_rng(seed).permutation(n).astype(np.int32)
    src = np.repeat(p, 2)
    dst = np.stack([np.roll(p, -1), np.roll(p, -2)], axis=1).reshape(-1)
    return src, dst


def with_hub(src, dst, at: int, hub: int, nbrs):
    """The stream with the edges ``(hub, nbrs[i])`` inserted at position
    ``at``, timestamped ``at`` (ts = arange elsewhere)."""
    k = len(nbrs)
    s = np.concatenate([src[:at], np.full(k, hub, np.int32), src[at:]])
    d = np.concatenate([dst[:at], np.asarray(nbrs, np.int32), dst[at:]])
    ts = np.concatenate([np.arange(at), np.full(k, at),
                         np.arange(at, src.shape[0])]).astype(np.int64)
    return s, d, ts


def capped_degree_phase(torch, device, src, dst) -> dict:
    """J3: the capped-degree sparse windows on the square of a random
    Hamiltonian cycle over 2^24 slots, then a degree-9 vertex."""
    from gelly_torch.library import triangles as tri

    n_windows = src.shape[0] // J3_WINDOW

    def capped(stream, **kw):
        return tri.window_triangle_counts_batched(
            stream, J3_WINDOW, window_capacity=J3_CAPACITY,
            batch=J3_BATCH, max_degree=J3_MAX_DEGREE, **kw)

    def run(stream):
        return list(capped(stream))

    def pulled(out):
        return [w for w, *_ in out], torch.stack([x[1] for x in out]).cpu()

    (wins, counts), wall, peak, launches = timed_run(
        torch, device, lambda: pulled(run(event_stream(
            src, dst, J3_N, J3_CHUNK, device))))
    report_j("J3 capped-degree windows", src.shape[0], wall, peak, launches)
    check(launches == NO_LAUNCHES, "J3 launched a hand kernel")
    check(wins == list(range(n_windows)), f"J3 windows {wins}")
    _, cols = next(tri._out_windows(event_stream(
        src, dst, J3_N, J3_CHUNK, device), J3_WINDOW, J3_CAPACITY, J3_N))
    cols = [torch.from_numpy(x).to(device) for x in cols]
    body_ms = time_ms(torch, lambda: tri._window_triangle_count_sparse(
        *cols, J3_N, J3_MAX_DEGREE), device, reps=3, warmup=1)
    print(f"  the sparse window count alone (plain slab loop, "
          f"{2 * cols[0].shape[0]} lanes): {body_ms:.6f} ms a window")
    del cols
    (bw, bcounts), bwall, bpeak, _ = timed_run(
        torch, device, lambda: pulled(list(tri.window_triangles_bucketed(
            event_stream(src, dst, J3_N, J3_CHUNK, device), J3_WINDOW,
            window_capacity=J3_CAPACITY, batch=J3_BATCH))))
    report_j("J3 window_triangles_bucketed, same stream", src.shape[0],
             bwall, bpeak, launches)
    # The square of a Hamiltonian cycle has its triangle counts in closed
    # form: a window of W edges holds W/2 cycle steps and the triangles
    # (p_i, p_i+1, p_i+2) of all but its last step (that one's third edge
    # is the next step's); the whole stream holds n triangles, 3 at every
    # vertex (n >= 7). The formula is held to scipy on a 2^16-slot cycle
    # (the oracle of PR 9 ran scipy at 2^24 slots: 51 s).
    want = [J3_WINDOW // 2 - 1] * n_windows
    whole = (J3_N, np.full(J3_N, 3, np.int64))
    ssrc, sdst = square_cycle(J3_SMALL_N, J3_SEED)
    small_window = ssrc.shape[0] // n_windows
    small, oracle_s = window_oracles(ssrc, sdst, J3_SMALL_N, small_window,
                                     n_windows, whole=True)
    small_total, small_per = small.pop()
    check(small == [small_window // 2 - 1] * n_windows
          and small_total == J3_SMALL_N and (small_per == 3).all(),
          f"the square-cycle formula != scipy at {J3_SMALL_N} slots "
          f"({small}, total {small_total})")
    for w in range(n_windows):
        check(int(counts[w]) == want[w] == int(bcounts[w]),
              f"J3 window {w}: {int(counts[w])} / bucketed "
              f"{int(bcounts[w])} != oracle {want[w]}")
        print(f"  window {w}: {want[w]} triangles (capped and bucketed "
              f"equal the oracle)")
    print(f"  oracle: the square-cycle formula ({want[0]} a window, "
          f"{J3_N} in all, 3 a vertex), equal to scipy at {J3_SMALL_N} "
          f"slots in {oracle_s:.2f} s")

    # A vertex of degree 9 in window 2.
    at = J3_HUB_WINDOW * J3_WINDOW
    hub = int(src[at + 1])
    hs, hd, hts = with_hub(src, dst, at, hub, src[:2 * 9:2])

    def hub_stream():
        return event_stream(hs, hd, J3_N, J3_CHUNK, device, hts)

    try:
        run(hub_stream())
        raised = None
    except ValueError as e:
        raised = str(e)
    check(raised is not None and f"max_degree={J3_MAX_DEGREE}" in raised,
          f"J3: the degree-9 vertex did not raise naming max_degree "
          f"({raised})")
    flagged, tail = [], None
    try:
        for w, _c, over in capped(hub_stream(), yield_overflow=True):
            if int(over):
                flagged.append(w)
    except ValueError as e:
        tail = str(e)
    check(flagged == [J3_HUB_WINDOW],
          f"J3: yield_overflow flagged windows {flagged}")
    print(f"  degree-9 vertex {hub} in window {J3_HUB_WINDOW}: default run "
          f"raised ({raised}); yield_overflow flagged windows {flagged}, "
          f"then raised after the group ({tail is not None})")
    return {"wall_s": wall, "bucketed_wall_s": bwall, "hub": (hs, hd, hts),
            "whole": whole, "body_ms": body_ms}


def exact_dense_phase(torch, device) -> dict:
    """J4: exact dense counts, bench_triangles' slot count, a depth cut
    of its edges; a run with rebases."""
    from gelly_torch.library import triangles as tri

    src, dst = synth_edges(J4_EDGES, J4_N, SEED)

    def stream():
        return event_stream(src, dst, J4_N, J4_CHUNK, device)

    def run(**kw):
        s = tri.exact_triangle_count(stream(), **kw)
        return s, s.final()

    (s, st), wall, peak, launches = timed_run(torch, device, run)
    report_j("J4 exact dense", J4_EDGES, wall, peak, launches)
    check(launches == NO_LAUNCHES, "J4 launched a hand kernel")
    ab = simple_edges(src, dst, J4_N)
    total, per = per_vertex_triangles(
        vertex_triangles_scipy(*ab, J4_N, "ends"),
        vertex_triangles_scipy(*ab, J4_N, "middle"))
    check(int(st.total) == total, f"J4 total {int(st.total)} != {total}")
    check(np.array_equal(st.counts.cpu().numpy(), per),
          "J4 per-vertex counts != diag(A^3) / 2")
    fc = s.final_counts()
    check(fc[-1] == total and len(fc) == 1 + int((per > 0).sum()),
          "J4 final_counts")
    budget = 3 * J4_CHUNK
    (rs, rst), rwall, _, _ = timed_run(
        torch, device, lambda: run(arrival_budget=budget))
    check(rs.stats["rebases"] >= 2, f"J4 rebases {rs.stats}")
    check(int(rst.total) == total
          and np.array_equal(rst.counts.cpu().numpy(), per),
          "J4 rebased run != oracle")
    print(f"  {total} triangles, per-vertex counts equal diag(A^3)/2; "
          f"arrival_budget={budget}: {rs.stats['rebases']} rebases, equal "
          f"(wall {rwall:.4f} s)")
    chunk = next(iter(stream())).to_fields(device, ("src", "dst", "valid"))
    fresh = tri.fresh_triangle_counts(J4_N, device)
    body_ms = time_ms(torch, lambda: tri._exact_step(fresh, chunk), device,
                      reps=3, warmup=1)
    print(f"  _exact_step alone (plain slab loop): {body_ms:.6f} ms a "
          f"{J4_CHUNK}-edge chunk")
    return {"wall_s": wall, "total": total, "src": src, "dst": dst,
            "body_ms": body_ms}


def exact_sparse_phase(torch, device, src, dst, hub, oracle) -> dict:
    """J5: exact capped-degree counts on J3's stream (``oracle``: its
    total and per-vertex counts), and its hub variant."""
    from gelly_torch.library import triangles as tri

    def stream(s=src, d=dst, ts=None):
        return event_stream(s, d, J3_N, J5_CHUNK, device, ts)

    def run():
        s = tri.exact_triangle_count(stream(), max_degree=J3_MAX_DEGREE)
        return s.final()

    st, wall, peak, launches = timed_run(torch, device, run)
    report_j("J5 exact sparse", src.shape[0], wall, peak, launches)
    check(launches == NO_LAUNCHES, "J5 launched a hand kernel")
    total, per = oracle
    check(int(st.total) == total, f"J5 total {int(st.total)} != {total}")
    check(np.array_equal(st.counts.cpu().numpy(), per),
          "J5 per-vertex counts != diag(A^3) / 2")
    check(int(st.overflow) == 0, "J5 overflowed")
    del st
    chunk = next(iter(stream())).to_fields(device, ("src", "dst", "valid"))
    fresh = tri.fresh_sparse_triangle_counts(J3_N, J3_MAX_DEGREE, device)
    slab = max(8, (1 << 22) // J3_MAX_DEGREE ** 2)
    body_ms = time_ms(torch, lambda: tri._sparse_exact_step(
        fresh, chunk, J3_MAX_DEGREE, slab), device, reps=3, warmup=1)
    print(f"  _sparse_exact_step alone (plain slab loop): {body_ms:.6f} ms "
          f"a {J5_CHUNK}-edge chunk")
    del chunk, fresh
    hs, hd, hts = hub
    cut = 2 * J3_WINDOW + 9  # the hub's window and what precedes it
    try:
        tri.exact_triangle_count(stream(hs[:cut], hd[:cut], hts[:cut]),
                                 max_degree=J3_MAX_DEGREE).final()
        raised = None
    except ValueError as e:
        raised = str(e)
    check(raised is not None
          and f"exceeded max_degree {J3_MAX_DEGREE}" in raised,
          f"J5: the hub variant did not raise ({raised})")
    print(f"  {total} triangles, per-vertex counts equal diag(A^3)/2; the "
          f"hub variant raised ({raised})")
    return {"wall_s": wall, "body_ms": body_ms}


def sampler_phase(torch, device, src, dst, exact_total) -> dict:
    """J6: the sampled estimator on J4's stream; its kernel against the
    plain version from a fresh state."""
    from gelly_torch.library import triangles as tri
    from gelly_torch.ops import kernels

    lanes = [torch.from_numpy(x[:J6_PLAIN_LANES]).to(device) for x in (
        src, dst, np.ones(J6_PLAIN_LANES, bool))]
    n_v = int(max(src[:J4_CHUNK].max(), dst[:J4_CHUNK].max())) + 1
    fresh = tuple(tri._fresh_sampler(J6_SAMPLES, J6_SEED, device))
    got = kernels.sampler_step(fresh, *lanes, n_v)
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = kernels.sampler_step_plain(fresh, *lanes, n_v)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    for name, a, b in zip(tri.SamplerState._fields, got, want):
        check(torch.equal(a, b), f"J6: kernel != plain, field {name}")
    ms = time_ms(torch, lambda: kernels.sampler_step(fresh, *lanes, n_v),
                 device, reps=5, warmup=1)
    live = J6_PLAIN_LANES - int((src[:J6_PLAIN_LANES]
                                 == dst[:J6_PLAIN_LANES]).sum())
    coins = int((want[0] != fresh[0]).sum())  # instances that drew
    # Every instance: a key split a lane, the coin's key and uniform a
    # live lane, and 4 hashes a draw.
    ops = HASH_OPS * (J6_SAMPLES * (J6_PLAIN_LANES + 2 * live) + 4 * coins)
    nbytes = 2 * 34 * J6_SAMPLES + 9 * J6_PLAIN_LANES
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound = max(ops_ms, bytes_ms)
    by = "operations" if ops_ms >= bytes_ms else "bytes"
    print(f"kernel sampler_step: S={J6_SAMPLES}, first {J6_PLAIN_LANES} "
          f"lanes from a fresh state: every field equal to the plain "
          f"version; kernel_ms={ms:.6f} plain_ms={plain_ms:.6f} (host "
          f"clock) bound_ms={bound:.6f} ({by}: {ops} int32 ops / "
          f"{INT32_OPS_PER_S:.4g}, {nbytes} B)")

    def run():
        return list(tri.sampled_triangle_count(
            event_stream(src, dst, J4_N, J4_CHUNK, device), J6_SAMPLES,
            seed=J6_SEED))

    est, wall, peak, launches = timed_run(torch, device, run)
    n_launch = launches[HAND_KERNELS.index("sampler_step")]
    n_chunks = -(-src.shape[0] // J4_CHUNK)
    report_j("J6 sampled_triangle_count", src.shape[0], wall, peak,
             launches, f" estimates={['%.1f' % e for e in est]}")
    check(n_launch == n_chunks,
          f"J6: {n_launch} sampler launches != {n_chunks} chunks")
    check(len(est) == n_chunks and all(np.isfinite(est)) and est[-1] > 0,
          f"J6 estimates {est}")
    print(f"  estimate {est[-1]:.1f} beside the exact {exact_total} "
          f"(ratio {est[-1] / exact_total:.4f})")
    return {"launches": n_launch, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "wall_s": wall, "est": est}


def triangle_library_phases(torch, device) -> dict:
    """J1-J6 in order, each freeing what it held."""
    out = {"j1": bucketed_phase(torch, device)}
    torch.cuda.empty_cache()
    out["j2"] = unpacked_dense_phase(torch, device)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    src, dst = square_cycle(J3_N, J3_SEED)
    print(f"phase J3 stream: the square of a random Hamiltonian cycle over "
          f"{J3_N} slots (seed {J3_SEED}), {src.shape[0]} edges, in "
          f"{time.perf_counter() - t0:.2f} s")
    j3 = capped_degree_phase(torch, device, src, dst)
    torch.cuda.empty_cache()
    j4 = exact_dense_phase(torch, device)
    torch.cuda.empty_cache()
    out["j5"] = exact_sparse_phase(torch, device, src, dst, j3.pop("hub"),
                                   j3.pop("whole"))
    del src, dst
    torch.cuda.empty_cache()
    out["j6"] = sampler_phase(torch, device, j4["src"], j4["dst"],
                              j4["total"])
    torch.cuda.empty_cache()
    out["j3"], out["j4"] = j3, j4
    return out


# Phase K: the mesh, four logical shards on the one card.
K_SHARDS = 4
K1_CHUNK = 1 << 24  # a shard folds 2^22 lanes: the dedup fold and kernel
K1_MERGE_EVERY = 2
K2_CHUNK = 1 << 20
K2_MERGE_EVERY = 16  # a multiple of the shards: 2^24-edge windows
K2_FOLD_BATCH = 16
K3_FOLD = 1 << 24  # pairs a ShardedCC fold
K5_PLAIN_LANES = 1 << 8
K6_WINDOW = 1 << 20  # J4's 2^19 edges: one window


def k_mesh(device):
    from gelly_torch.parallel.mesh import make_mesh

    return make_mesh(K_SHARDS, devices=[device] * K_SHARDS)


def k_run(torch, device, fn):
    """``(result, stats)`` of one mesh run, every hand kernel's launch
    count and the host-sync count set to 0 just before it."""
    from gelly_torch.ops import kernels, unionfind

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches(kernels)
    unionfind.host_sync.count = 0
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return out, {"wall_s": wall, "host_syncs": unionfind.host_sync.count,
                 "peak_mem_bytes": torch.cuda.max_memory_allocated(device),
                 "launches": dict(zip(HAND_KERNELS, launch_counts(kernels))),
                 "fixpoints": fixpoint_counts(kernels)}


def k_report(name: str, n_events: int, st: dict, extra: str = "") -> None:
    launched = {k: v for k, v in st["launches"].items() if v}
    fixpoints = {k: v for k, v in st["fixpoints"].items() if v}
    print(f"phase {name}: {n_events / st['wall_s']:.1f} edges/s "
          f"wall={st['wall_s']:.4f} s host_syncs={st['host_syncs']} "
          f"peak_mem={st['peak_mem_bytes']} B kernel launches={launched} "
          f"fixpoint launches={fixpoints}{extra}")


def k_expect_launches(name: str, st: dict, expect: dict) -> None:
    for k, v in st["launches"].items():
        check(v == expect.get(k, 0), f"{name}: {k} launched {v} times, "
                                     f"expected {expect.get(k, 0)}")


def mesh_cc_phase(torch, device, src, dst, labels, oracle,
                  dedup_chunks: int) -> dict:
    """K1-K4 on phase 4's stream over four logical shards of the card:
    the raw CC plan (kernel and plain folds, replicated and delta
    merges), the compact plan (merge_every and event-time staging, the
    cid-space delta merge), ShardedCC and ShardedDegrees."""
    from gelly_torch.core.io import EdgeChunkSource, TimeCharacteristic
    from gelly_torch.core.stream import edge_stream_from_source
    from gelly_torch.core.vertices import IdentityVertexTable
    from gelly_torch.library import connected_components as cc
    from gelly_torch.library import degrees as deg
    from gelly_torch.ops import kernels, unionfind
    from gelly_torch.parallel.partition import split_chunk
    from gelly_torch.parallel.sharded_cc import ShardedCC

    n = N_VERTICES
    mesh = k_mesh(device)
    print(f"phase K mesh: {mesh}")

    # K1: the raw plan. An emission every 2^25 edges: phase 4's emissions
    # 1 and 3 (the S = 1 run at the same boundaries), the last scipy's.
    n_chunks = N_EDGES // K1_CHUNK
    want = [labels[(k + 1) * K1_MERGE_EVERY * K1_CHUNK // (MERGE_EVERY * CHUNK)
                   - 1] for k in range(n_chunks // K1_MERGE_EVERY)]
    check(np.array_equal(want[-1], oracle), "K1: phase 4's last emission")

    def raw(backend: str, mode: str):
        stream = edge_stream_from_source(EdgeChunkSource(
            src, dst, chunk_size=K1_CHUNK, table=IdentityVertexTable(n)),
            n, device=device)
        agg = cc.connected_components(n, ingest_combine=False,
                                      fold_backend=backend, merge_mode=mode)
        res = stream.aggregate(agg, mesh=mesh, merge_every=K1_MERGE_EVERY)
        return list(res), res.stats

    k1 = {}
    for backend, mode in (("kernel", "replicated"), ("kernel", "delta"),
                          ("plain", "replicated")):
        (out, stats), st = k_run(torch, device, lambda: raw(backend, mode))
        got = [x.cpu().numpy() for x in out]
        name = f"K1 raw CC fold_backend={backend} merge_mode={mode}"
        k_report(name, N_EDGES, st, f" host_syncs/shard-fold="
                 f"{st['host_syncs'] / (n_chunks * K_SHARDS):.2f} "
                 f"merge_modes={stats['merge_modes']}")
        check(len(got) == len(want), f"{name}: {len(got)} emissions")
        for i, (a, b) in enumerate(zip(got, want)):
            check(a.dtype == np.int32 and a.shape == (n,),
                  f"{name} emission {i}: {a.dtype} {a.shape}")
            check(np.array_equal(a, b),
                  f"{name} emission {i} != the S = 1 run's")
        check(stats["merge_modes"][mode] == len(want),
              f"{name}: merge_modes {stats['merge_modes']}")
        gathers = 3 * dedup_chunks if backend == "kernel" else 0
        k_expect_launches(name, st, {"sorted_window_gather": gathers})
        k1[(backend, mode)] = st
    check(k1[("kernel", "replicated")]["launches"]["sorted_window_gather"]
          > 0, "K1 launched no sorted_window_gather")
    print(f"  every emission equals phase 4's at its boundary, the last "
          f"scipy's; the gather launched 3 times a dedup shard-chunk "
          f"({dedup_chunks} of {n_chunks * K_SHARDS})")

    # The gather at one shard's shapes: shard 0's slice of the first chunk
    # folded as the table, shard 1's dedup lanes as the indices.
    c0 = next(iter(EdgeChunkSource(src, dst, chunk_size=K1_CHUNK,
                                   table=IdentityVertexTable(n))))
    s0, s1 = (s.to(device) for s in split_chunk(c0, K_SHARDS)[:2])
    cap = max(1 << 20, 3 * (s0.capacity >> 4))
    table = unionfind.union_edges_dedup(
        unionfind.fresh_forest(n, device), s0.src, s0.dst, s0.valid,
        unique_cap=cap, backend="plain")
    uu, _, live0, _ = unionfind._dedup_pairs(s1.src, s1.dst, s1.valid,
                                             min(cap, s1.capacity))
    sidx = torch.where(live0, uu, n - 1).contiguous()
    g_kernel = kernels.sorted_window_gather(table, sidx)
    g_plain = kernels.sorted_window_gather_plain(table, sidx)
    gather_err = int((g_kernel.long() - g_plain.long()).abs().max())
    check(torch.equal(g_kernel, g_plain),
          f"K1: sorted_window_gather != plain at the shard's shape "
          f"(max abs err {gather_err})")
    print(f"  sorted_window_gather at a shard's shape (L={sidx.shape[0]}, "
          f"table n={n}): equal to its plain version")
    del c0, s0, s1, table, uu, live0, sidx, g_kernel, g_plain
    torch.cuda.empty_cache()

    # K2: the compact cell's call, cut to 2^26 edges (2^24-edge windows):
    # merge_every staging and event-time staging (split_chunk_host), the
    # cid-space delta merge. Labels are canonical, so each emission equals
    # phase 4's (S = 1) at the same boundary.
    ts = np.arange(N_EDGES, dtype=np.int64)

    def compact(event_time: bool):
        agg = cc.connected_components(n, merge="gather", codec="compact",
                                      compact_capacity=CC_COMPACT,
                                      merge_mode="delta")
        kw = dict(timestamps=ts, time=TimeCharacteristic.EVENT) \
            if event_time else {}
        stream = edge_stream_from_source(EdgeChunkSource(
            src, dst, chunk_size=K2_CHUNK, table=IdentityVertexTable(n),
            **kw), n, device=device)
        run_kw = (dict(window_ms=MERGE_EVERY * CHUNK) if event_time
                  else dict(merge_every=K2_MERGE_EVERY,
                            fold_batch=K2_FOLD_BATCH))
        res = stream.aggregate(agg, mesh=mesh, **run_kw)
        out = list(res)
        return out, res, agg

    for event_time in (False, True):
        (out, res, agg), st = k_run(torch, device,
                                    lambda: compact(event_time))
        name = ("K2 compact, event-time windows" if event_time
                else "K2 compact, merge_every")
        busy = " ".join(f"{k}={v:.4f}"
                        for k, v in sorted(res.timer.busy().items()))
        k_report(name, N_EDGES, st, f" units={res.stats['units']} "
                 f"merge_modes={res.stats['merge_modes']} "
                 f"assigned={agg.session.assigned} wire={agg.wire}")
        print(f"  stage busy s: {busy}")
        check_native_codecs(name)
        check(agg.wire == "segments", f"{name}: wire {agg.wire}")
        check(len(out) == len(labels), f"{name}: {len(out)} emissions")
        for i, (a, b) in enumerate(zip(out, labels)):
            check(np.array_equal(a.cpu().numpy(), b),
                  f"{name} emission {i} != the S = 1 run's")
        check(res.stats["merge_modes"]["delta"] == len(labels),
              f"{name}: merge_modes {res.stats['merge_modes']}")
        check(agg.session.assigned == int((oracle >= 0).sum()),
              f"{name}: assigned {agg.session.assigned}")
        k_expect_launches(name, st, {})
        del out, res, agg
    del ts
    torch.cuda.empty_cache()

    # K3: ShardedCC over the same edges as pairs, a label pull every 2^25.
    k3 = ShardedCC(n, mesh=mesh)
    folds = []
    for i in range(N_EDGES // K3_FOLD):
        lo = i * K3_FOLD
        before = dict(k3.stats)
        _, st = k_run(torch, device, lambda: k3.fold(
            src[lo:lo + K3_FOLD], dst[lo:lo + K3_FOLD]))
        rounds = k3.stats["rounds"] - before["rounds"]
        levels = k3.stats["chase_levels"] - before["chase_levels"]
        folds.append((st["wall_s"], rounds, levels, st["host_syncs"]))
        k_report(f"K3 ShardedCC fold {i}", K3_FOLD, st,
                 f" hook_rounds={rounds} chase_levels={levels}")
        if (i + 1) % 2 == 0:
            t = time.perf_counter()
            lab = k3.labels()
            check(np.array_equal(lab, want[i // 2]),
                  f"K3: labels after fold {i} != K1's emission {i // 2}")
            print(f"  labels() after fold {i}: equal to K1's emission "
                  f"{i // 2} in {time.perf_counter() - t:.4f} s")
        k_expect_launches("K3", st, {})
    check(k3.stats["dropped"] == 0, f"K3 dropped {k3.stats['dropped']}")
    print(f"  ShardedCC stats {k3.stats}; state {k3.per_device_state_bytes()}"
          f" B a shard")
    del k3
    torch.cuda.empty_cache()

    # K4: ShardedDegrees (auto) on phase D2's deletion stream.
    s2 = np.concatenate([src, src[:D2_DELETES]])
    d2 = np.concatenate([dst, dst[:D2_DELETES]])
    ev = np.concatenate([np.zeros(N_EDGES, np.int8),
                         np.ones(D2_DELETES, np.int8)])
    sd = deg.sharded_degrees(edge_stream_from_source(EdgeChunkSource(
        s2, d2, events=ev, chunk_size=CHUNK, table=IdentityVertexTable(n)),
        n, device=device), mesh=mesh, mode="auto")
    got, st = k_run(torch, device, sd.final_degrees)
    k_report("K4 ShardedDegrees mode=auto", s2.shape[0], st,
             f" fallback_chunks={sd.stats['fallback_chunks']} "
             f"dropped={sd.stats['dropped']}")
    final = (signed_degrees(src, dst, 1, n)
             - signed_degrees(src[:D2_DELETES], dst[:D2_DELETES], 1, n))
    touched = np.zeros(n, bool)
    touched[s2] = True
    touched[d2] = True
    keys = np.fromiter(got.keys(), np.int64, len(got))
    vals = np.fromiter(got.values(), np.int64, len(got))
    order = np.argsort(keys)
    check(np.array_equal(keys[order], np.nonzero(touched)[0]),
          "K4: degree keys != the touched slots")
    check(np.array_equal(vals[order], final[touched]),
          "K4: degrees != the signed bincount")
    check(sd.stats["dropped"] == 0, f"K4 dropped {sd.stats['dropped']}")
    k_expect_launches("K4", st, {})
    print(f"  {len(got)} degrees equal the signed bincount")
    del s2, d2, ev, got, keys, vals
    return {"gather_launches":
            k1[("kernel", "replicated")]["launches"]["sorted_window_gather"],
            "fixpoint_launches": k1[("kernel", "replicated")]["fixpoints"],
            "gather_err": gather_err,
            "rounds": [f[1] for f in folds]}


def mesh_triangle_phase(torch, device, src, dst, exact_total: int,
                        j6_est: list) -> dict:
    """K5-K6 on J4's stream over four logical shards: the sharded sampler
    (its kernel a shard a chunk), sharded_window_triangles and
    ShardedExactTriangles."""
    from gelly_torch.library import triangles as tri
    from gelly_torch.library.sharded_triangles import ShardedExactTriangles
    from gelly_torch.ops import kernels

    mesh = k_mesh(device)

    def stream(chunk=J4_CHUNK):
        return event_stream(src, dst, J4_N, chunk, device)

    # K5: every instance's state equals the unsharded sampler's.
    def sharded():
        out = list(tri.sharded_sampler_run(stream(), J6_SAMPLES, mesh,
                                           seed=J6_SEED))
        return out[-1][0], [e for _, e in out]

    (states, est), st = k_run(torch, device, sharded)
    n_chunks = -(-src.shape[0] // J4_CHUNK)
    k_report("K5 sampled_triangle_count(mesh=)", src.shape[0], st,
             f" estimates={['%.1f' % e for e in est]}")
    k_expect_launches("K5", st, {"sampler_step": K_SHARDS * n_chunks})
    sampler_launches = st["launches"]["sampler_step"]
    whole = tri.SamplerState(*(torch.cat([getattr(s, f) for s in states])
                               if getattr(states[0], f).dim()
                               else getattr(states[0], f)
                               for f in tri.SamplerState._fields))
    check(len(est) == len(j6_est) and np.allclose(est, j6_est, rtol=1e-6),
          f"K5 estimates {est} != J6's {j6_est} (rtol 1e-6)")
    # The unsharded run (J6's), field by field.
    s1 = stream()
    ref = tri._fresh_sampler(J6_SAMPLES, J6_SEED, device)
    for c in s1:
        ref = tri._sampler_step(ref, c.to_fields(
            device, ("src", "dst", "valid")), s1.ctx.table.num_vertices)
    for f, a, b in zip(tri.SamplerState._fields, whole, ref):
        check(torch.equal(a, b), f"K5: field {f} != the unsharded run's")
    print(f"  every instance's state equals the unsharded run's; estimates "
          f"equal J6's within rtol 1e-6 (last {est[-1]:.1f})")
    # The kernel at a shard's shape (2^14 instances) on a lane prefix.
    shard0 = tuple(tri._shard_sampler(
        tri._fresh_sampler(J6_SAMPLES, J6_SEED, device), mesh)[0])
    lanes = [torch.from_numpy(x[:K5_PLAIN_LANES]).to(device) for x in (
        src, dst, np.ones(K5_PLAIN_LANES, bool))]
    n_v = int(max(src[:J4_CHUNK].max(), dst[:J4_CHUNK].max())) + 1
    got = kernels.sampler_step(shard0, *lanes, n_v)
    want = kernels.sampler_step_plain(shard0, *lanes, n_v)
    for f, a, b in zip(tri.SamplerState._fields, got, want):
        check(torch.equal(a, b), f"K5: kernel != plain at the shard's "
                                 f"shape, field {f}")
    print(f"  sampler_step at a shard's shape ({shard0[0].shape[0]} "
          f"instances, {K5_PLAIN_LANES} lanes): equal to its plain version")
    del states, whole, ref, shard0, got, want

    # K6: one 2^20-ms window (the whole of J4's stream).
    counts, st = k_run(torch, device, lambda: [
        (w, int(c)) for w, c in tri.sharded_window_triangles(
            stream(), K6_WINDOW, window_capacity=2 * K6_WINDOW,
            mesh=mesh)])
    k_report("K6 sharded_window_triangles", src.shape[0], st,
             f" counts={counts}")
    k_expect_launches("K6 windows", st, {})
    single = [(w, int(c)) for w, c in tri.window_triangles(
        stream(), K6_WINDOW, window_capacity=2 * K6_WINDOW)]
    check(counts == single == [(0, exact_total)],
          f"K6: {counts} != window_triangles {single} / exact "
          f"{exact_total}")
    a, b = simple_edges(src, dst, J4_N)
    d_max = int((np.bincount(a, minlength=J4_N)
                 + np.bincount(b, minlength=J4_N)).max())
    t_exact = ShardedExactTriangles(stream(), max_degree=d_max, mesh=mesh)
    got, st = k_run(torch, device, lambda: t_exact.run().final_counts())
    k_report(f"K6 ShardedExactTriangles max_degree={d_max}", src.shape[0],
             st)
    k_expect_launches("K6 exact", st, {})
    want = tri.exact_triangle_count(stream()).final_counts()
    check(got == want and got[-1] == exact_total,
          f"K6: ShardedExactTriangles != exact_triangle_count "
          f"({got.get(-1)} / {want.get(-1)})")
    print(f"  {exact_total} triangles: the sharded window count equals "
          f"window_triangles, the sharded exact counts equal "
          f"exact_triangle_count vertex by vertex")
    return {"sampler_launches": sampler_launches}


# --------------------------------------------------------------------- #
# Phase O: the mesh across processes (gloo) and coordinated recovery

O_HOSTS = 2
O_EVERY = 2  # a barrier every 2 chunks: 4 committed epochs a host
O_LEASE_TTL_S = 4.0
O_BARRIER_TIMEOUT_S = 60.0
O2_UNIT_SLEEP_S = 0.5
# The survivor's bound: it reaches its next barrier within O_EVERY units,
# the dead leader's lease lapses O_LEASE_TTL_S after its last beat (at
# most a third of the ttl before the kill), and the survivor looks once a
# third of the ttl; 2 s more for its exit.
O2_SURVIVOR_BOUND_S = (O_EVERY * (O2_UNIT_SLEEP_S + 1.0)
                       + O_LEASE_TTL_S * 5 / 3 + 2.0)
O3_PROCS = 4
O3_SHARDS = 2  # logical shards a process: 8 on the card
O3_EDGES = 1 << 24
O3_EXCHANGE = 1 << 20  # keyed-exchange entries a shard
O3_DEGREE = 4  # = O3_PROCS: the hierarchical leader hop crosses processes
# O3's engine checks (a)-(e), in the same 4 processes after the merges.
# (a) and (b) fold O3_EDGES in 2^22-edge chunks (2^19 lanes a shard),
# 2^23-edge windows: 2 emissions.
O3_CHUNK = CHUNK
O3_MERGE_EVERY = 2
O3_COMPACT_CHUNK = 1 << 20
O3_COMPACT_MERGE = 8  # and fold_batch 8: a multiple of the 8 shards
# Depth cuts (PERF.md section 4): loopback gloo moves 0.2-0.4 GB/s, and
# every ShardedCC lookup level sends each shard's whole bucket through it.
O3_CC_PAIRS = 1 << 17  # (c): two folds, labels() after each
O3_DEG_EDGES = 1 << 22  # (d): one chunk, then deletions of its first 2^20
O3_DEG_DELETES = 1 << 20
# (e): ShardedExactTriangles on J4's first 2^14 edges in 4 chunks: its
# row fetch moves [edges, max degree] rows, about 1 GB at J4's 2^17-edge
# chunk (max degree 3566) and 65 MB at 2^14 edges (1239).
O3_EXACT_EDGES = 1 << 14
O3_EXACT_CHUNK = 1 << 12
O3_PLAIN_LANES = 1 << 6  # (e): the sampler's plain check at a shard's shape
# (e): J4's Zipf hub holds about a quarter of a chunk's endpoints, more
# than the default 2x fair share of 8 shards' buckets (K6's 4 fit).
O3_WINDOW_SLACK = 4.0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def merge_forest_pair(a, b):
    """The combine of a ``(parent, seen)`` forest pair."""
    from gelly_torch.ops import unionfind

    return (unionfind.merge_forests(a[0], b[0]), a[1] | b[1])


def host_partition(src, dst, pid: int, nprocs: int):
    """Host ``pid``'s chunks of phase 4's stream: ``pid::nprocs``."""
    n = len(src) // CHUNK
    return (np.ascontiguousarray(src.reshape(n, CHUNK)[pid::nprocs]).ravel(),
            np.ascontiguousarray(dst.reshape(n, CHUNK)[pid::nprocs]).ravel())


def fold_child(torch, device, directory: str, pid: int, cfg: dict) -> dict:
    """O1 and O2's host: its partition through a coordinated
    ``ResilientRunner`` (a barrier every ``O_EVERY`` chunks), then the
    cross-process butterfly of the forests; writes its local forest and
    its merged labels."""
    from gelly_torch.engine.coordination import (
        CoordinationConfig,
        Coordinator,
        HostIdentity,
    )
    from gelly_torch.engine.resilience import (
        ResilienceConfig,
        ResilientRunner,
    )
    from gelly_torch.ops import kernels, unionfind
    from gelly_torch.parallel import collectives
    from gelly_torch.parallel import mesh as mesh_lib

    nprocs = cfg["nprocs"]
    src = np.load(os.path.join(cfg["data"], "src.npy"), mmap_mode="r")
    dst = np.load(os.path.join(cfg["data"], "dst.npy"), mmap_mode="r")
    hsrc, hdst = host_partition(src, dst, pid, nprocs)
    agg, stream, stage = resilient_plan(torch, device, hsrc, hdst)
    first_fold = []

    def step(s, c):
        if not first_fold:
            first_fold.append(time.time())
        if cfg["sleep_s"]:
            time.sleep(cfg["sleep_s"])
        return agg.fold(s, c), None

    co = Coordinator(
        cfg["store"], HostIdentity(pid, nprocs,
                                   coordinator_address=cfg["address"]),
        CoordinationConfig(lease_ttl=O_LEASE_TTL_S, poll_s=0.01,
                           barrier_timeout=O_BARRIER_TIMEOUT_S))
    agree_s = time_calls(co, "agree_position")
    publish_s = time_calls(co, "publish")
    recover_s = time_calls(co, "recover")
    load_s = time_calls(co.store, "load_shard")
    runner = ResilientRunner(
        step, stream(), lambda: agg.init(device), coordinator=co,
        stage=stage,
        config=ResilienceConfig(checkpoint_every_chunks=O_EVERY,
                                watchdog_timeout=120.0),
        flatten_state=agg.flatten, adopt_state=agg.combine)
    torch.cuda.synchronize()
    reset_launches(kernels)
    t = time.perf_counter()
    final = runner.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = kernels.sorted_window_gather.launches
    folded = runner.stats["chunks"]

    mesh = mesh_lib.make_mesh(devices=[device])
    local = [None] * nprocs
    local[pid] = (final.parent, final.seen)
    torch.distributed.barrier()  # both hosts enter the merge together
    torch.cuda.synchronize()
    t = time.perf_counter()
    merged = collectives.butterfly_merge(merge_forest_pair, local, nprocs,
                                         mesh=mesh)[pid]
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t
    np.save(os.path.join(directory, f"parent-{pid}.npy"),
            final.parent.cpu().numpy())
    np.save(os.path.join(directory, f"seen-{pid}.npy"),
            final.seen.cpu().numpy())
    np.save(os.path.join(directory, f"labels-{pid}.npy"),
            unionfind.component_labels(*merged).cpu().numpy())

    # The gather at this host's shapes (uncounted: after the run): its
    # final forest as the table, its first chunk's sorted dedup lo
    # endpoints as the indices.
    c = stage(next(iter(stream())))
    unique_cap = max(1 << 20, 3 * (CHUNK >> 4))
    uu, _, live, _ = unionfind._dedup_pairs(c.src, c.dst, c.valid,
                                            min(unique_cap, CHUNK))
    sidx = torch.where(live, uu, N_VERTICES - 1).contiguous()
    got = kernels.sorted_window_gather(final.parent, sidx)
    want = kernels.sorted_window_gather_plain(final.parent, sidx)
    return {
        "wall_s": wall, "edges": folded * CHUNK,
        "edges_per_s": folded * CHUNK / wall,
        "position": runner.position, "chunks": folded,
        "resumed_at": runner.position - folded,
        "agree_s": agree_s[0], "publish_s": publish_s[0],
        "recover_s": recover_s[0], "shard_load_s": load_s[0],
        "shard_bytes": os.path.getsize(co.store.shard_path(
            co.committed_epoch, pid, co.committed_position)),
        "epochs": co.committed_epoch, "launches": launches,
        "merge_s": merge_s, "merge_sent_bytes": mesh.sent_bytes,
        "merge_received_bytes": mesh.received_bytes,
        "gather_equal": bool(torch.equal(got, want)),
        "gather_err": int((got.long() - want.long()).abs().max()),
        "first_fold_at": first_fold[0] if first_fold else None,
    }


def merge_child(torch, device, directory: str, pid: int, cfg: dict) -> dict:
    """O3's process: two logical shards on the card, each folding its
    strided eighth of phase 4's first ``O3_EDGES`` edges; the butterfly
    and the hierarchical merge of the 8 forests, then the keyed exchange
    of ``O3_EXCHANGE`` entries a shard, checked here (conservation,
    ownership, no drop)."""
    from gelly_torch.core.chunk import make_chunk
    from gelly_torch.library import connected_components as cc
    from gelly_torch.ops import unionfind
    from gelly_torch.parallel import collectives, partition
    from gelly_torch.parallel import mesh as mesh_lib

    src = np.load(os.path.join(cfg["data"], "src.npy"),
                  mmap_mode="r")[:O3_EDGES]
    dst = np.load(os.path.join(cfg["data"], "dst.npy"),
                  mmap_mode="r")[:O3_EDGES]
    mesh = mesh_lib.make_mesh(devices=[device] * O3_SHARDS)
    S = mesh.num_shards
    agg = cc.connected_components(N_VERTICES, merge="gather",
                                  ingest_combine=False, fold_backend="kernel")
    states = [None] * S
    torch.cuda.synchronize()
    t = time.perf_counter()
    for d in mesh.local_shards:
        st = agg.fold(agg.init(device), make_chunk(
            np.ascontiguousarray(src[d::S]), np.ascontiguousarray(dst[d::S]),
            device=device))
        states[d] = (st.parent, st.seen)
    torch.cuda.synchronize()
    out = {"fold_s": time.perf_counter() - t}
    rounds = {"butterfly": 3, "hierarchical": 4}  # log2 8; 1 + 2 + 1
    for name, merge in (
            ("butterfly", lambda: collectives.butterfly_merge(
                merge_forest_pair, states, S, mesh=mesh)),
            ("hierarchical", lambda: collectives.hierarchical_merge(
                merge_forest_pair, states, S, O3_DEGREE, mesh=mesh))):
        sent, received = mesh.sent_bytes, mesh.received_bytes
        torch.distributed.barrier()
        torch.cuda.synchronize()
        t = time.perf_counter()
        merged = merge()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        labels = [unionfind.component_labels(*merged[d])
                  for d in mesh.local_shards]
        check(all(torch.equal(x, labels[0]) for x in labels),
              f"phase O3: {name}: this process's shards disagree")
        np.save(os.path.join(directory, f"{name}-labels-{pid}.npy"),
                labels[0].cpu().numpy())
        out[name] = {"wall_s": wall, "rounds": rounds[name],
                     "sent_bytes": mesh.sent_bytes - sent,
                     "received_bytes": mesh.received_bytes - received}
        del merged, labels
    del states

    L = O3_EXCHANGE
    keys_np = [np.ascontiguousarray(src[j::S][:L]) for j in range(S)]
    pays_np = [np.ascontiguousarray(dst[j::S][:L]) for j in range(S)]
    keys = [torch.from_numpy(keys_np[j]).to(device)
            if mesh.devices[j] is not None else None for j in range(S)]
    pays = [{"dst": torch.from_numpy(pays_np[j]).to(device)}
            if mesh.devices[j] is not None else None for j in range(S)]
    valids = [torch.ones(L, dtype=torch.bool, device=device)
              if mesh.devices[j] is not None else None for j in range(S)]
    sent, received = mesh.sent_bytes, mesh.received_bytes
    torch.distributed.barrier()
    torch.cuda.synchronize()
    t = time.perf_counter()
    k2, p2, v2, dropped = partition.repartition_by_key(
        mesh, keys, pays, valids, S, L)  # bucket L: the worst case fits
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    all_k = np.concatenate(keys_np)
    all_p = np.concatenate(pays_np)
    for d in mesh.local_shards:
        ok = v2[d].cpu().numpy()
        gk, gp = k2[d].cpu().numpy()[ok], p2[d]["dst"].cpu().numpy()[ok]
        check(bool((gk % S == d).all()),
              f"phase O3: shard {d} received keys it does not own")
        mine = all_k % S == d
        wk, wp = all_k[mine], all_p[mine]
        go, wo = np.lexsort((gp, gk)), np.lexsort((wp, wk))
        check(np.array_equal(gk[go], wk[wo]) and np.array_equal(gp[go],
                                                                 wp[wo]),
              f"phase O3: shard {d}'s received multiset != its share")
        check(int(dropped[d]) == 0, f"phase O3: {int(dropped[d])} dropped")
    out["exchange"] = {"wall_s": wall, "entries": L * S,
                       "sent_bytes": mesh.sent_bytes - sent,
                       "received_bytes": mesh.received_bytes - received}
    del k2, p2, v2, keys, pays, valids
    torch.cuda.empty_cache()
    out["engine"] = engine_checks(torch, device, mesh,
                                  np.ascontiguousarray(src),
                                  np.ascontiguousarray(dst))
    return out


def digest(a) -> str:
    """A short hash of an array's dtype, shape and bytes: the parent holds
    a replicated value equal across the processes by it."""
    import hashlib

    a = np.ascontiguousarray(a)
    h = hashlib.blake2b(digest_size=16)
    h.update(f"{a.dtype}{a.shape}".encode())
    h.update(a.tobytes())
    return h.hexdigest()


def engine_checks(torch, device, mesh, src, dst) -> dict:
    """O3's checks (a)-(e) of the engine and the sharded library on the
    8-shard mesh of 4 processes, in every process: the same global stream
    and arguments, each process folding its own shards. Every replicated
    value is reported by its digest; the parent holds them equal across
    the processes and to its oracles."""
    from gelly_torch.core.io import EdgeChunkSource
    from gelly_torch.core.stream import edge_stream_from_source
    from gelly_torch.core.vertices import IdentityVertexTable
    from gelly_torch.library import connected_components as cc
    from gelly_torch.library import degrees as deg
    from gelly_torch.library import triangles as tri
    from gelly_torch.library.sharded_triangles import ShardedExactTriangles
    from gelly_torch.ops import kernels, unionfind
    from gelly_torch.parallel import mesh as mesh_lib
    from gelly_torch.parallel.partition import split_chunk
    from gelly_torch.parallel.sharded_cc import ShardedCC

    n, S = N_VERTICES, mesh.num_shards
    local = mesh.local_shards
    out: dict = {"local_shards": list(local)}

    def timed(name, n_events, fn):
        sent, received = mesh.sent_bytes, mesh.received_bytes
        mesh_lib.barrier(mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        reset_launches(kernels)
        unionfind.host_sync.count = 0
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        out[name] = {
            "wall_s": wall, "edges": n_events,
            "edges_per_s": n_events / wall,
            "sent_bytes": mesh.sent_bytes - sent,
            "received_bytes": mesh.received_bytes - received,
            "host_syncs": unionfind.host_sync.count,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(device),
            "launches": dict(zip(HAND_KERNELS, launch_counts(kernels)))}
        return res

    def raw_stream(chunk=O3_CHUNK):
        return edge_stream_from_source(EdgeChunkSource(
            src, dst, chunk_size=chunk, table=IdentityVertexTable(n)), n,
            device=device)

    # (a) The raw plan. A shard's slice of a 2^22-edge chunk is 2^19
    # lanes: the fold's dedup threshold (read at fold time) is set to it,
    # so every slice takes the dedup fold and, with the kernel backend,
    # the gather. Each process counts its own dedup shard-chunks.
    cc.RAW_DEDUP_MIN_CHUNK = O3_CHUNK // S
    dedup = 0
    for c in EdgeChunkSource(src, dst, chunk_size=O3_CHUNK,
                             table=IdentityVertexTable(n)):
        parts = split_chunk(c, S)
        dedup += sum(parts[d].capacity >= cc.RAW_DEDUP_MIN_CHUNK
                     for d in local)
    n_windows = -(-src.shape[0] // (O3_CHUNK * O3_MERGE_EVERY))
    check(dedup == len(local) * -(-src.shape[0] // O3_CHUNK),
          f"(a): {dedup} of this process's shard-chunks take the dedup "
          "fold, not all")
    emissions = {}
    for backend in ("kernel", "plain"):
        for mode in ("replicated", "delta"):
            name = f"a_{backend}_{mode}"

            def raw(backend=backend, mode=mode):
                agg = cc.connected_components(
                    n, ingest_combine=False, fold_backend=backend,
                    merge_mode=mode)
                res = raw_stream().aggregate(agg, mesh=mesh,
                                             merge_every=O3_MERGE_EVERY)
                return [e.cpu().numpy() for e in res], res.stats

            got, stats = timed(name, src.shape[0], raw)
            check(len(got) == n_windows, f"({name}): {len(got)} emissions")
            check(stats["merge_modes"][mode] == n_windows,
                  f"({name}): merge_modes {stats['merge_modes']}")
            gathers = 3 * dedup if backend == "kernel" else 0
            check(out[name]["launches"]["sorted_window_gather"] == gathers,
                  f"({name}): {out[name]['launches']} launches, expected "
                  f"{gathers} gathers (3 x {dedup} dedup shard-chunks)")
            out[name].update(merge_modes=stats["merge_modes"],
                             h2d_bytes=stats["h2d_bytes"],
                             digests=[digest(e) for e in got])
            emissions[name] = got
    want = emissions["a_plain_replicated"]
    for name, got in emissions.items():
        check(all(np.array_equal(x, y) for x, y in zip(got, want)),
              f"({name}): emissions != the plain replicated run's")
    out["a_dedup_shard_chunks"] = dedup
    # The gather at a shard's shapes: the final forest as the table, this
    # process's first shard's slice of the first chunk as the indices.
    c0 = next(iter(EdgeChunkSource(src, dst, chunk_size=O3_CHUNK,
                                   table=IdentityVertexTable(n))))
    p0 = split_chunk(c0, S)[local[0]].to(device)
    table = torch.from_numpy(np.where(want[-1] >= 0, want[-1],
                                      np.arange(n, dtype=np.int32))
                             ).to(device)
    uu, _, live, _ = unionfind._dedup_pairs(p0.src, p0.dst, p0.valid,
                                            p0.capacity)
    sidx = torch.where(live, uu, n - 1).contiguous()
    g_kernel = kernels.sorted_window_gather(table, sidx)
    g_plain = kernels.sorted_window_gather_plain(table, sidx)
    out["gather_err"] = int((g_kernel.long() - g_plain.long()).abs().max())
    check(torch.equal(g_kernel, g_plain), "(a): sorted_window_gather != "
          f"its plain version at a shard's shape (L={sidx.shape[0]})")
    del c0, p0, table, uu, live, sidx, g_kernel, g_plain
    cc.RAW_DEDUP_MIN_CHUNK = 1 << 22

    # (b) The compact plan at the same window boundaries.
    def compact():
        agg = cc.connected_components(n, merge="gather", codec="compact",
                                      compact_capacity=CC_COMPACT,
                                      merge_mode="delta")
        res = raw_stream(O3_COMPACT_CHUNK).aggregate(
            agg, mesh=mesh, merge_every=O3_COMPACT_MERGE,
            fold_batch=O3_COMPACT_MERGE, codec_workers=2)
        return [e.cpu().numpy() for e in res], res.stats

    got, stats = timed("b_compact", src.shape[0], compact)
    check(len(got) == len(want) and all(
        np.array_equal(x, y) for x, y in zip(got, want)),
          "(b): the compact plan's emissions != (a)'s")
    out["b_compact"].update(merge_modes=stats["merge_modes"],
                            h2d_bytes=stats["h2d_bytes"],
                            digests=[digest(e) for e in got])
    del got, want, emissions
    torch.cuda.empty_cache()

    # (c) ShardedCC: two folds of O3_CC_PAIRS pairs, labels() after each.
    def sharded_cc():
        k3 = ShardedCC(n, mesh=mesh)
        labs = []
        for i in range(2):
            lo = i * O3_CC_PAIRS
            k3.fold(src[lo:lo + O3_CC_PAIRS], dst[lo:lo + O3_CC_PAIRS])
            labs.append(k3.labels())
        return labs, dict(k3.stats)

    labs, st = timed("c_sharded_cc", 2 * O3_CC_PAIRS, sharded_cc)
    check(st["dropped"] == 0, f"(c): dropped {st['dropped']}")
    out["c_sharded_cc"].update(stats=st, digests=[digest(x) for x in labs])
    del labs

    # (d) ShardedDegrees with deletions: the signed bincount.
    s2 = np.concatenate([src[:O3_DEG_EDGES], src[:O3_DEG_DELETES]])
    d2 = np.concatenate([dst[:O3_DEG_EDGES], dst[:O3_DEG_DELETES]])
    ev = np.concatenate([np.zeros(O3_DEG_EDGES, np.int8),
                         np.ones(O3_DEG_DELETES, np.int8)])

    def degrees():
        sd = deg.sharded_degrees(edge_stream_from_source(EdgeChunkSource(
            s2, d2, events=ev, chunk_size=CHUNK,
            table=IdentityVertexTable(n)), n, device=device), mesh=mesh,
            mode="auto")
        return sd.final_degrees(), dict(sd.stats)

    got, st = timed("d_degrees", s2.shape[0], degrees)
    final = (signed_degrees(s2[:O3_DEG_EDGES], d2[:O3_DEG_EDGES], 1, n)
             - signed_degrees(s2[O3_DEG_EDGES:], d2[O3_DEG_EDGES:], 1, n))
    touched = np.zeros(n, bool)
    touched[s2] = True
    touched[d2] = True
    keys = np.fromiter(got.keys(), np.int64, len(got))
    vals = np.fromiter(got.values(), np.int64, len(got))
    order = np.argsort(keys)
    check(np.array_equal(keys[order], np.nonzero(touched)[0])
          and np.array_equal(vals[order], final[touched]),
          "(d): degrees != the signed bincount")
    check(st["dropped"] == 0, f"(d): dropped {st['dropped']}")
    out["d_degrees"].update(stats=st, digests=[digest(keys[order]),
                                               digest(vals[order])])
    del s2, d2, ev, got, keys, vals, final, touched

    # (e) The sampler, the window count and the exact counts on J4's
    # stream, made here from its seed.
    jsrc, jdst = synth_edges(J4_EDGES, J4_N, SEED)

    def j4_stream(a=jsrc, b=jdst, chunk=J4_CHUNK):
        return event_stream(a, b, J4_N, chunk, device)

    def sampler():
        runs = list(tri.sharded_sampler_run(j4_stream(), J6_SAMPLES, mesh,
                                            seed=J6_SEED))
        return runs[-1][0], [e for _, e in runs]

    states, est = timed("e_sampler", J4_EDGES, sampler)
    n_chunks = -(-J4_EDGES // J4_CHUNK)
    check(out["e_sampler"]["launches"]["sampler_step"]
          == len(local) * n_chunks,
          f"(e): {out['e_sampler']['launches']} sampler launches != "
          f"{len(local)} local shards x {n_chunks} chunks")
    ref_stream = j4_stream()
    ref = tri._fresh_sampler(J6_SAMPLES, J6_SEED, device)
    for c in ref_stream:
        ref = tri._sampler_step(ref, c.to_fields(
            device, ("src", "dst", "valid")), ref_stream.ctx.table.num_vertices)
    per = J6_SAMPLES // S
    for d in local:
        for f, a, b in zip(tri.SamplerState._fields, states[d], ref):
            b = b[d * per:(d + 1) * per] if b.dim() else b
            check(torch.equal(a, b), f"(e): shard {d}'s {f} != the "
                  "unsharded sampler's")
    single = tri.sharded_sampler_estimate(tri._shard_sampler(
        ref, mesh_lib.Mesh([device] * S)))
    check(est[-1] == single, f"(e): estimate {est[-1]} != the single "
          f"controller's {single}")
    out["e_sampler"].update(estimates=est)
    shard0 = tuple(tri._shard_sampler(tri._fresh_sampler(
        J6_SAMPLES, J6_SEED, device), mesh)[local[0]])
    lanes = [torch.from_numpy(x[:O3_PLAIN_LANES]).to(device) for x in (
        jsrc, jdst, np.ones(O3_PLAIN_LANES, bool))]
    n_v = int(max(jsrc[:J4_CHUNK].max(), jdst[:J4_CHUNK].max())) + 1
    got = kernels.sampler_step(shard0, *lanes, n_v)
    want = kernels.sampler_step_plain(shard0, *lanes, n_v)
    for f, a, b in zip(tri.SamplerState._fields, got, want):
        check(torch.equal(a, b), f"(e): sampler_step != plain at a shard's "
              f"shape, field {f}")
    del states, ref, shard0, got, want
    ab = simple_edges(jsrc, jdst, J4_N)
    whole = triangles_scipy(*ab, J4_N)
    counts = timed("e_window_triangles", J4_EDGES, lambda: [
        (w, int(c)) for w, c in tri.sharded_window_triangles(
            j4_stream(), K6_WINDOW, window_capacity=2 * K6_WINDOW,
            mesh=mesh, bucket_slack=O3_WINDOW_SLACK)])
    check(counts == [(0, whole)], f"(e): sharded_window_triangles {counts} "
          f"!= the exact {whole}")
    out["e_window_triangles"].update(counts=counts)
    es, ed = jsrc[:O3_EXACT_EDGES], jdst[:O3_EXACT_EDGES]
    ab = simple_edges(es, ed, J4_N)
    total, per_v = per_vertex_triangles(
        vertex_triangles_scipy(*ab, J4_N, "ends"),
        vertex_triangles_scipy(*ab, J4_N, "middle"))
    d_max = int((np.bincount(ab[0], minlength=J4_N)
                 + np.bincount(ab[1], minlength=J4_N)).max())
    got = timed("e_exact", O3_EXACT_EDGES, lambda: ShardedExactTriangles(
        j4_stream(es, ed, O3_EXACT_CHUNK), max_degree=d_max,
        mesh=mesh).run()
        .final_counts())
    nz = np.nonzero(per_v)[0]
    check(got.get(-1) == total and len(got) == 1 + nz.size
          and all(got[int(v)] == int(per_v[v]) for v in nz),
          f"(e): ShardedExactTriangles != the exact oracle ({got.get(-1)} / "
          f"{total})")
    out["e_exact"].update(total=total, max_degree=d_max)
    return out


O3_CHECKS = ("a_kernel_replicated", "a_kernel_delta", "a_plain_replicated",
             "a_plain_delta", "b_compact", "c_sharded_cc", "d_degrees",
             "e_sampler", "e_window_triangles", "e_exact")


def o3_engine_report(src, dst, oracle3, engines: list) -> dict:
    """Phase O3's checks (a)-(e) in the parent: every replicated value
    (by digest) equal across the processes, (a)'s last emission scipy's,
    (c)'s labels scipy's of its pairs; one line a check and process."""
    for name in O3_CHECKS:
        for pid, e in enumerate(engines):
            r = e[name]
            print(f"phase O3 ({name}) process {pid} shards "
                  f"{e['local_shards']}: wall={r['wall_s']:.4f} s "
                  f"({r['edges_per_s']:.1f} edges/s); gloo "
                  f"{r['sent_bytes']} B sent / {r['received_bytes']} B "
                  f"received; host_syncs={r['host_syncs']}; peak_mem="
                  f"{r['peak_mem_bytes']} B; launches="
                  f"{ {k: v for k, v in r['launches'].items() if v} }"
                  + (f"; merge_modes={r['merge_modes']} h2d_bytes="
                     f"{r['h2d_bytes']}" if "merge_modes" in r else ""))
        first = {k: v for k, v in engines[0][name].items()
                 if k in ("digests", "estimates", "counts", "total",
                          "merge_modes", "stats")}
        for pid, e in enumerate(engines[1:], 1):
            mine = {k: e[name][k] for k in first}
            check(mine == first, f"phase O3 ({name}): process {pid}'s "
                  f"replicated values != process 0's")
    a_last = engines[0]["a_plain_replicated"]["digests"][-1]
    check(a_last == digest(oracle3),
          "phase O3 (a): the last emission != scipy's components")
    pairs = 2 * O3_CC_PAIRS
    check(engines[0]["c_sharded_cc"]["digests"][-1]
          == digest(scipy_oracle(src[:pairs], dst[:pairs], N_VERTICES)),
          "phase O3 (c): ShardedCC's labels != scipy's of its pairs")
    print(f"phase O3 (a)-(e): every emission, label array, degree, count "
          f"and estimate equal in all {len(engines)} processes; (a) kernel "
          f"= plain, replicated = delta, the last scipy's; (b) = (a) at "
          f"every boundary; (c) scipy's on {pairs} pairs; the gather "
          f"launched 3 x "
          f"{[e['a_dedup_shard_chunks'] for e in engines]} dedup "
          f"shard-chunks a kernel run; estimates "
          f"{engines[0]['e_sampler']['estimates']}")
    return {"o3_gather_launches": [
                e["a_kernel_replicated"]["launches"]["sorted_window_gather"]
                + e["a_kernel_delta"]["launches"]["sorted_window_gather"]
                for e in engines],
            "o3_sampler_launches": [
                e["e_sampler"]["launches"]["sampler_step"]
                for e in engines],
            "o3_gather_err": max(e["gather_err"] for e in engines)}


def coord_child(directory: str, pid: int) -> int:
    """A process of phase O (``--coord-child <dir> <process>``): joins
    the gloo group of ``<dir>/run.json``, runs its mode and writes
    ``<dir>/result-<process>.json``. A failure exits at once with 1: a
    dead peer's process group would hold the teardown."""
    import traceback

    import torch

    with open(os.path.join(directory, "run.json")) as f:
        cfg = json.load(f)
    device = torch.device(cfg["device"])
    torch.cuda.set_device(device)
    torch.zeros(1, device=device)
    torch.cuda.synchronize()
    t_cuda = time.time()
    from gelly_torch.parallel import mesh as mesh_lib

    try:
        t = time.perf_counter()
        mesh_lib.initialize_multihost(cfg["address"], cfg["nprocs"], pid)
        pg_s = time.perf_counter() - t
        body = merge_child if cfg["mode"] == "merge" else fold_child
        out = body(torch, device, directory, pid, cfg)
        out.update(spawned_at=cfg["spawned_at"],
                   spawn_to_cuda_s=t_cuda - cfg["spawned_at"],
                   init_process_group_s=pg_s,
                   peak_mem_bytes=torch.cuda.max_memory_allocated(device))
        with open(os.path.join(directory, f"result-{pid}.json"), "w") as f:
            json.dump(out, f)
        print(json.dumps({"coord_child": out}), flush=True)
        torch.distributed.destroy_process_group()
    except BaseException as e:  # noqa: BLE001 — reported, then exit 1
        print(f"coord_child {pid} failed: {type(e).__name__}: {e}",
              flush=True)
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    return 0


def coord_phase(torch, device, src, dst, final_labels, oracle,
                dedup_flags) -> dict:
    """Phase O. Returns O1's gather launches a host."""
    from gelly_torch.engine.coordination import CheckpointStore

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="gelly-coord-")
    here = os.path.abspath(__file__)
    procs = []

    def spawn(name, mode, nprocs, sleep_s=0.0, store=None):
        run_dir = os.path.join(tmp, name)
        os.makedirs(run_dir)
        cfg = {"mode": mode, "nprocs": nprocs, "sleep_s": sleep_s,
               "address": f"127.0.0.1:{free_port()}", "data": tmp,
               "device": str(device),
               "store": store or os.path.join(run_dir, "store"),
               "spawned_at": time.time()}
        with open(os.path.join(run_dir, "run.json"), "w") as f:
            json.dump(cfg, f)
        ps = []
        for pid in range(nprocs):
            log = open(os.path.join(run_dir, f"{pid}.log"), "w")
            ps.append(subprocess.Popen(
                [sys.executable, here, "--coord-child", run_dir, str(pid)],
                stdout=log, stderr=subprocess.STDOUT))
            log.close()
        procs.extend(ps)
        return run_dir, ps

    def tail(run_dir, pid):
        with open(os.path.join(run_dir, f"{pid}.log")) as f:
            return f.read()[-3000:]

    def finish(run_dir, ps, what):
        for pid, p in enumerate(ps):
            rc = p.wait(timeout=CHILD_TIMEOUT_S)
            check(rc == 0, f"phase {what}: process {pid} failed (rc={rc}): "
                  f"{tail(run_dir, pid)}")
        out = []
        for pid in range(len(ps)):
            with open(os.path.join(run_dir, f"result-{pid}.json")) as f:
                out.append(json.load(f))
        return out

    def report(what, pid, r):
        print(f"phase {what} host {pid}: wall={r['wall_s']:.4f} s "
              f"({r['edges_per_s']:.1f} edges/s, {r['chunks']} chunks from "
              f"position {r['resumed_at']}); agree_position "
              f"{r['agree_s']:.4f} s, publish {r['publish_s']:.4f} s; "
              f"shard checkpoint {r['shard_bytes']} B, epochs committed "
              f"{r['epochs']}; merge {r['merge_s']:.4f} s, "
              f"{r['merge_sent_bytes']} B sent / "
              f"{r['merge_received_bytes']} B received through gloo; "
              f"gather launches {r['launches']}; peak_mem "
              f"{r['peak_mem_bytes']} B; spawn to CUDA "
              f"{r['spawn_to_cuda_s']:.4f} s, init_process_group "
              f"{r['init_process_group_s']:.4f} s")

    try:
        t0 = time.perf_counter()
        np.save(os.path.join(tmp, "src.npy"), src)
        np.save(os.path.join(tmp, "dst.npy"), dst)
        print(f"phase O stream written in {time.perf_counter() - t0:.2f} s "
              f"to {tmp}")
        n_host = N_EDGES // CHUNK // O_HOSTS

        # O1: the coordinated 2-host fold and the cross-process merge.
        t0 = time.perf_counter()
        o1_dir, ps = spawn("o1", "fold", O_HOSTS)
        o1 = finish(o1_dir, ps, "O1")
        o1_s = time.perf_counter() - t0
        for pid, r in enumerate(o1):
            report("O1", pid, r)
            want = 3 * sum(dedup_flags[pid::O_HOSTS])
            check(r["chunks"] == n_host and r["resumed_at"] == 0,
                  f"phase O1: host {pid} folded {r['chunks']} chunks")
            check(r["epochs"] == n_host // O_EVERY,
                  f"phase O1: host {pid} committed {r['epochs']} epochs")
            check(r["launches"] == want,
                  f"phase O1: host {pid}: {r['launches']} gather launches "
                  f"!= 3 x {want // 3} dedup chunks")
            check(r["gather_equal"], f"phase O1: host {pid}: the gather "
                  f"!= its plain version (max abs err {r['gather_err']})")
        for pid in range(O_HOSTS):
            merged = np.load(os.path.join(o1_dir, f"labels-{pid}.npy"))
            check(np.array_equal(merged, final_labels)
                  and np.array_equal(merged, oracle),
                  f"phase O1: host {pid}'s merged labels != phase 4's / "
                  f"scipy's")
        print(f"phase O1 {O_HOSTS} hosts x {n_host} chunks in {o1_s:.2f} s: "
              f"every host's merged labels equal phase 4's and scipy's; "
              f"gather exact at a host's shapes")

        # O2: kill -9 of the leader once the first manifest committed.
        t0 = time.perf_counter()
        o2_dir, ps = spawn("o2-killed", "fold", O_HOSTS,
                           sleep_s=O2_UNIT_SLEEP_S)
        store = os.path.join(o2_dir, "store")
        deadline = time.monotonic() + CHILD_TIMEOUT_S
        man = None
        while man is None and time.monotonic() < deadline:
            for pid, p in enumerate(ps):
                check(p.poll() is None, f"phase O2: process {pid} exited "
                      f"(rc={p.returncode}) before the kill: "
                      f"{tail(o2_dir, pid)}")
            if os.path.exists(os.path.join(store, "MANIFEST.json")):
                man = CheckpointStore(store).read_manifest()
            time.sleep(0.01)
        check(man is not None, "phase O2: no manifest before the deadline")
        os.kill(ps[0].pid, signal.SIGKILL)
        t_kill = time.monotonic()
        while ps[1].poll() is None and \
                time.monotonic() - t_kill < 3 * O2_SURVIVOR_BOUND_S:
            time.sleep(0.01)
        exit_s = time.monotonic() - t_kill
        check(ps[0].wait(timeout=60) == -signal.SIGKILL,
              f"phase O2: the leader ended with {ps[0].returncode}")
        rc1 = ps[1].poll()
        check(rc1 is not None and rc1 != 0,
              f"phase O2: the survivor did not fail (rc={rc1})")
        check("CoordinationError" in tail(o2_dir, 1),
              f"phase O2: the survivor failed otherwise: {tail(o2_dir, 1)}")
        check(exit_s <= O2_SURVIVOR_BOUND_S,
              f"phase O2: the survivor took {exit_s:.2f} s to exit "
              f"(bound {O2_SURVIVOR_BOUND_S:.2f} s)")
        man = CheckpointStore(store).read_manifest()
        resume_pos = man["position"]
        check(0 < resume_pos < n_host,
              f"phase O2: the manifest is at position {resume_pos}")
        print(f"phase O2 SIGKILL of the leader at manifest epoch "
              f"{man['epoch']} (position {resume_pos}); the survivor exited "
              f"nonzero after {exit_s:.4f} s (bound "
              f"{O2_SURVIVOR_BOUND_S:.2f} s: lease ttl {O_LEASE_TTL_S} s)")
        o2r_dir, ps = spawn("o2-resumed", "fold", O_HOSTS, store=store)
        o2 = finish(o2r_dir, ps, "O2")
        for pid, r in enumerate(o2):
            report("O2", pid, r)
            check(r["resumed_at"] == resume_pos
                  and r["chunks"] == n_host - resume_pos,
                  f"phase O2: host {pid} resumed at {r['resumed_at']} and "
                  f"folded {r['chunks']} chunks (manifest {resume_pos})")
            for leaf in ("parent", "seen"):
                a = np.load(os.path.join(o1_dir, f"{leaf}-{pid}.npy"))
                b = np.load(os.path.join(o2r_dir, f"{leaf}-{pid}.npy"))
                check(a.dtype == b.dtype and a.tobytes() == b.tobytes(),
                      f"phase O2: host {pid}'s {leaf} != O1's")
            manifest_s = r["recover_s"] - r["shard_load_s"]
            print(f"phase O2 host {pid} time to recover (spawn to first "
                  f"fold) {r['first_fold_at'] - r['spawned_at']:.4f} s: "
                  f"process start to CUDA ready {r['spawn_to_cuda_s']:.4f} "
                  f"s, init_process_group {r['init_process_group_s']:.4f} "
                  f"s, manifest read {manifest_s:.4f} s, shard load "
                  f"{r['shard_load_s']:.4f} s")
        for pid in range(O_HOSTS):
            check(np.array_equal(
                np.load(os.path.join(o2r_dir, f"labels-{pid}.npy")),
                final_labels),
                f"phase O2: host {pid}'s resumed merged labels != O1's")
        print(f"phase O2 in {time.perf_counter() - t0:.2f} s: both hosts "
              f"resumed at position {resume_pos}; local forests "
              f"byte-identical to O1's, merged labels equal")

        # O3: 4 processes x 2 logical shards, merges and the exchange.
        t0 = time.perf_counter()
        o3_dir, ps = spawn("o3", "merge", O3_PROCS)
        t = time.perf_counter()
        oracle3 = scipy_oracle(src[:O3_EDGES], dst[:O3_EDGES], N_VERTICES)
        oracle_s = time.perf_counter() - t
        o3 = finish(o3_dir, ps, "O3")
        for name in ("butterfly", "hierarchical"):
            for pid in range(O3_PROCS):
                got = np.load(os.path.join(o3_dir,
                                           f"{name}-labels-{pid}.npy"))
                check(np.array_equal(got, oracle3),
                      f"phase O3: process {pid}'s {name} merge != scipy's "
                      f"components")
        for pid, r in enumerate(o3):
            print(f"phase O3 process {pid}: fold {r['fold_s']:.4f} s; "
                  + "; ".join(
                      f"{n} {r[n]['wall_s']:.4f} s, {r[n]['rounds']} "
                      f"rounds, {r[n]['sent_bytes']} B sent / "
                      f"{r[n]['received_bytes']} B received"
                      for n in ("butterfly", "hierarchical"))
                  + f"; exchange of {r['exchange']['entries']} entries "
                  f"{r['exchange']['wall_s']:.4f} s, "
                  f"{r['exchange']['sent_bytes']} B sent; peak_mem "
                  f"{r['peak_mem_bytes']} B; init_process_group "
                  f"{r['init_process_group_s']:.4f} s")
        print(f"phase O3 {O3_PROCS} processes x {O3_SHARDS} shards in "
              f"{time.perf_counter() - t0:.2f} s (scipy oracle "
              f"{oracle_s:.2f} s): every process's butterfly and "
              f"hierarchical (degree {O3_DEGREE}) labels equal scipy's "
              f"components; the exchange "
              f"conserved every shard's multiset, striped, 0 dropped")
        engine = o3_engine_report(src, dst, oracle3, [r["engine"] for r in o3])
        print(f"phase O total {time.perf_counter() - t_phase:.2f} s "
              f"(loopback gloo through host memory on one card)")
        return {"gather_launches": [r["launches"] for r in o1], **engine}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------- #
# phase Q: the example CLIs on the card

# The CLIs' own widths (gelly_torch/examples/): connected_components folds
# 2^16 slots, window_triangles 2^12; files are read in 4096-edge chunks.
# Depth cuts: Q2's 2^24 edges took 15.9 s a run (1.06 M edges/s: the
# CLI's 4096-edge chunks), which over Q2-Q5's seven passes would have
# taken the phase past 150 s, and 2^22 edges 62-86 s, with `total` then
# at 948 s and past the watchdog (1150 s then); the window CLI's default
# buffer holds 2^14 edges a window, so Q3 runs 2^21 edges as 128 windows.
Q_N = 1 << 16
Q_EDGES = 1 << 21
Q_MERGE = 16
Q_TRI_N = 1 << 12
Q_TRI_EDGES = 1 << 21
Q_TRI_WINDOW = 1 << 14  # ms, with ts = arange: 2^14 edges a window
Q_CKPT_MERGE = 128  # Q5: a checkpoint every 128 file chunks (2^19 edges)
Q_CKPT_CRASH = 2 * Q_CKPT_MERGE + 1  # the fold that fails, after 2 of them
Q_CLIENT_TIMEOUT_S = 300
Q_CLIS = ("bipartiteness_check", "broadcast_triangle_count",
          "centralized_weighted_matching", "connected_components",
          "degree_aggregate", "degree_distribution", "exact_triangle_count",
          "incidence_sampling_triangle_count",
          "iterative_connected_components", "spanner_example",
          "window_triangles")


def write_text_edges(path: str, cols) -> None:
    """Non-negative integer columns as one text line an edge (right-aligned
    fields), gathered from a byte table of every value's text: no Python
    loop over the edges or the values."""
    parts = []
    for c in cols:
        top = int(c.max())
        w = len(str(top))
        v = np.arange(top + 1)
        table = np.full((top + 1, w + 1), ord(" "), np.uint8)
        for k in range(w - 1, -1, -1):
            table[:, k] = np.where((v > 0) | (k == w - 1),
                                   v % 10 + ord("0"), ord(" "))
            v = v // 10
        parts.append(table[c])
    buf = np.concatenate(parts, axis=1)
    buf[:, -1] = ord("\n")
    buf.tofile(path)


def run_cli(name: str, args) -> tuple[str, float]:
    """``gelly_torch.examples.<name>.main(args)`` in process: (stdout,
    wall seconds)."""
    import importlib
    import io

    mod = importlib.import_module(f"gelly_torch.examples.{name}")
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        mod.main(list(args))
    return buf.getvalue(), time.perf_counter() - t


def held_lines(out: str) -> list:
    """The lines a card run and a CPU run must agree on."""
    return [ln for ln in out.splitlines()
            if not ln.startswith(("# ", "Runtime:"))]


def cli_labels(out: str, n: int, prefix: str = "") -> np.ndarray:
    """Labels from the CC CLI's ``root: [members]`` lines (identity ids:
    each member's label is its component's smallest id; -1 unseen)."""
    labels = np.full(n, -1, np.int32)
    for ln in out.splitlines():
        if ln.startswith("#") or not ln.startswith(prefix):
            continue
        root, members = ln[len(prefix):].split(": ", 1)
        ids = np.asarray(json.loads(members), np.int64)
        labels[ids] = int(root)
    return labels


class PortWatch:
    """A stdout that keeps what is written and sets ``ready`` once the CC
    CLI's ``--serve`` line names its port (printed after the server
    listens)."""

    def __init__(self):
        import io
        import threading

        self.buf = io.StringIO()
        self.ready = threading.Event()

    def write(self, text: str) -> int:
        n = self.buf.write(text)
        if "server on port " in self.buf.getvalue():
            self.ready.set()
        return n

    def flush(self) -> None:
        pass

    def port(self) -> int:
        text = self.buf.getvalue()
        return int(text.split("server on port ", 1)[1].split(";", 1)[0])


def cli_client() -> int:
    """Phase Q4's client process (``--cli-client``): reads one JSON list
    of CC CLI arguments a line from its standard input, runs the CLI's
    ``--connect`` path on each and answers each with one JSON line (the
    CLI's stdout, or the error, and whether a CUDA context exists). It
    ends at the end of its input. Phase Q starts it before Q1, so that
    its start (Python and torch, ~7 s) overlaps Q1-Q3."""
    import io
    import traceback

    import torch

    from gelly_torch.examples.connected_components import main as cc_main

    for line in sys.stdin:
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                cc_main(json.loads(line))
            reply = {"out": buf.getvalue()}
        except BaseException:  # noqa: BLE001 - sent back to the phase
            reply = {"err": traceback.format_exc()}
        reply["cuda"] = torch.cuda.is_initialized()
        sys.stdout.write(json.dumps(reply) + "\n")
        sys.stdout.flush()
    return 0


def start_cli_client(here: str, err):
    """The ``--cli-client`` child, its stderr to the file ``err``."""
    return subprocess.Popen(
        [sys.executable, os.path.join(here, "chip_smoke.py"), "--cli-client"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err,
        text=True)


def client_stderr(err) -> str:
    err.flush()
    err.seek(0)
    return err.read().decode(errors="replace")[-2000:]


def wire_run(client, err, dev: str, path: str, extra_serve, extra_client):
    """Phase Q4: ``--serve=0`` on a thread of this process on the card,
    ``--connect`` sent to the running client process. Returns (server
    stdout, the client's reply, wall seconds)."""
    import select
    import threading

    from gelly_torch.examples.connected_components import main as cc_main

    watch = PortWatch()
    box: dict = {}

    def serve():
        try:
            with contextlib.redirect_stdout(watch):
                cc_main(["--serve=0", dev, path, str(Q_MERGE)] + extra_serve)
        except BaseException as e:  # re-raised below
            box["err"] = e
            watch.ready.set()

    t = time.perf_counter()
    th = threading.Thread(target=serve, daemon=True)
    th.start()
    check(watch.ready.wait(120), "Q4: the --serve CLI never listened")
    if "err" in box:
        raise box["err"]
    client.stdin.write(json.dumps([f"--connect=127.0.0.1:{watch.port()}",
                                   path] + extra_client) + "\n")
    client.stdin.flush()
    answered, _, _ = select.select([client.stdout], [], [],
                                   Q_CLIENT_TIMEOUT_S)
    line = client.stdout.readline() if answered else ""
    check(line, f"Q4: no answer from the client process (rc "
                f"{client.poll()}): {client_stderr(err)}")
    reply = json.loads(line)
    th.join(Q_CLIENT_TIMEOUT_S)
    wall = time.perf_counter() - t
    check("err" not in reply, f"Q4 client: {reply.get('err')}")
    check(not th.is_alive(), "Q4: the server did not end at the BYE")
    if "err" in box:
        raise box["err"]
    return watch.buf.getvalue(), reply, wall


def cli_phase(torch, device) -> dict:
    """Phase Q. Returns the gather's and the wedge kernel's launches in
    the CLI runs."""
    err = tempfile.TemporaryFile()
    client = start_cli_client(os.path.dirname(os.path.abspath(__file__)),
                              err)
    try:
        return cli_runs(device, client, err)
    finally:
        if client.poll() is None:
            client.stdin.close()
            try:
                client.wait(60)
            except subprocess.TimeoutExpired:
                client.kill()
                client.wait()
        err.close()


def cli_runs(device, client, err) -> dict:
    """Phase Q's runs, with Q4's client process already started."""
    from gelly_torch.ops import kernels

    dev = f"--device={device.type}"
    launches = {"gather": {}, "wedge": {}}

    # Q1: every CLI on its built-in data, on the card and on the CPU.
    t1 = time.perf_counter()
    for name in Q_CLIS:
        out, wall = run_cli(name, [dev])
        cpu, _ = run_cli(name, ["--device=cpu"])
        check(held_lines(out) and held_lines(out) == held_lines(cpu),
              f"Q1 {name}: card stdout != CPU stdout:\n{out}\n{cpu}")
        print(f"phase Q1 {name}: {len(held_lines(out))} lines equal to the "
              f"CPU run's, {wall:.3f} s on the card")
    goldens = (
        ("window_triangles", [], ("(2,399)", "(3,799)", "(2,1199)")),
        ("degree_distribution", [], ("(1,2)",)),
        ("centralized_weighted_matching", [], ("total weight:",)),
        ("connected_components", ["--queries=cc,degrees,bipartiteness"],
         ("cc 1: [1, 3, 5", "cc 2: [2, 4, 6", "degrees top:",
          "bipartiteness: ok")),
    )
    for name, args, want in goldens:
        out, _ = run_cli(name, args + [dev])
        check(all(w in out for w in want), f"Q1 {name} golden: {out}")
    out, _ = run_cli("connected_components", [dev])
    check(out.startswith("1: [1, 3, 5") and "\n2: [2, 4, 6" in out
          and out.count("\n") == 2, f"Q1 CC golden: {out}")
    for args, match in ((["--stats"], "pair it with --serve"),
                        (["--queries=cc", "--checkpoint-dir=/tmp/x"],
                         "single-query"),
                        (["--queries=nope"], "unknown --queries")):
        try:
            run_cli("connected_components", args + [dev])
        except SystemExit as e:
            check(match in str(e), f"Q1 refusal {args}: {e}")
        else:
            check(False, f"Q1: {args} did not refuse")
    from gelly_torch import obs

    check(not obs.recording(), "Q1: the --stats refusal turned recording on")
    print(f"phase Q1: goldens and refusals held in "
          f"{time.perf_counter() - t1:.2f} s")

    tmp = tempfile.mkdtemp(prefix="gelly_q_")
    try:
        # Q2: CC at the CLI's full width.
        t0 = time.perf_counter()
        src, dst = synth_edges(Q_EDGES, Q_N, SEED)
        path = os.path.join(tmp, "edges.txt")
        write_text_edges(path, (src, dst))
        print(f"phase Q2 file: {Q_EDGES} Zipf edges over {Q_N} ids, "
              f"{os.path.getsize(path)} B of text in "
              f"{time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        oracle = scipy_oracle(src, dst, Q_N)
        deg = np.bincount(src, minlength=Q_N) + np.bincount(dst,
                                                           minlength=Q_N)
        print(f"phase Q2 oracle: scipy and bincount in "
              f"{time.perf_counter() - t0:.2f} s")
        runs = (("plain", []), ("shards=4", ["--shards=4"]),
                ("queries", ["--queries=cc,degrees,bipartiteness"]))
        for what, extra in runs:
            reset_launches(kernels)
            out, wall = run_cli("connected_components",
                                [path, str(Q_MERGE), dev] + extra)
            launches["gather"][f"Q2 {what}"] = \
                kernels.sorted_window_gather.launches
            prefix = "cc " if what == "queries" else ""
            check(np.array_equal(cli_labels(out, Q_N, prefix), oracle),
                  f"Q2 {what}: components != scipy")
            if what == "queries":
                top = json.loads(out.split("degrees top: ", 1)[1]
                                 .split("\n", 1)[0].replace("(", "[")
                                 .replace(")", "]"))
                check(len(top) == 5
                      and all(deg[v] == d for v, d in top)
                      and [d for _, d in top]
                      == sorted(deg.tolist(), reverse=True)[:5],
                      f"Q2 degrees top {top} != bincount")
                check("bipartiteness: " in out, "Q2: no bipartiteness line")
            print(f"phase Q2 {what}: wall {wall:.4f} s, "
                  f"{Q_EDGES / wall:.1f} edges/s, components equal to "
                  f"scipy{', top degrees to bincount' if prefix else ''}, "
                  f"gather launches {kernels.sorted_window_gather.launches}")
        del src, dst, deg

        # Q3: window_triangles at its full width.
        t0 = time.perf_counter()
        tsrc, tdst = synth_edges(Q_TRI_EDGES, Q_TRI_N, SEED)
        n_win = Q_TRI_EDGES // Q_TRI_WINDOW
        tpath = os.path.join(tmp, "timed.txt")
        write_text_edges(tpath, (tsrc, tdst, np.arange(Q_TRI_EDGES)))
        want, _ = window_oracles(tsrc, tdst, Q_TRI_N, Q_TRI_WINDOW, n_win)
        print(f"phase Q3 file and oracle: {Q_TRI_EDGES} Zipf edges over "
              f"{Q_TRI_N} ids, {n_win} windows of {Q_TRI_WINDOW} ms, "
              f"in {time.perf_counter() - t0:.2f} s")
        reset_launches(kernels)
        out, wall = run_cli("window_triangles",
                            [tpath, str(Q_TRI_WINDOW), dev])
        wl = kernels.wedge_count_matrix.launches
        launches["wedge"]["Q3"] = wl
        got = [tuple(int(x) for x in ln.strip("()").split(","))
               for ln in held_lines(out)]
        check(got == [(c, (w + 1) * Q_TRI_WINDOW - 1)
                      for w, c in enumerate(want)],
              f"Q3: window counts {got[:8]}... != scipy {want[:8]}...")
        if device.type == "cuda":
            check(wl >= n_win, f"Q3: {wl} wedge launches for {n_win} "
                  "windows")
        print(f"phase Q3: {n_win} windows equal to scipy "
              f"({sum(want)} triangles), wall {wall:.4f} s, "
              f"{Q_TRI_EDGES / wall:.1f} edges/s, wedge launches {wl}")
        del tsrc, tdst

        # Q4: the wire, raw, then compressed and stacked.
        for what, serve_x, client_x in (
                ("raw", [], []),
                ("compressed stack=4", ["--compressed"],
                 ["--compressed", "--stack=4"])):
            reset_launches(kernels)
            server, reply, wall = wire_run(client, err, dev, path, serve_x,
                                           client_x)
            launches["gather"][f"Q4 {what}"] = \
                kernels.sorted_window_gather.launches
            check(np.array_equal(cli_labels(server, Q_N), oracle),
                  f"Q4 {what}: components != Q2's")
            check(reply["cuda"] is False,
                  f"Q4 {what}: the client created a CUDA context")
            acked = [ln for ln in reply["out"].splitlines() if "acked" in ln]
            print(f"phase Q4 {what}: wall {wall:.4f} s (server start to the "
                  f"client's answer; the client process started before "
                  f"Q1), {Q_EDGES / wall:.1f} edges/s, components equal "
                  f"to Q2's, no CUDA context in the client; "
                  f"{acked[0][2:] if acked else ''}")
        client.stdin.close()
        check(client.wait(60) == 0,
              f"Q4: the client process exited {client.returncode}: "
              f"{client_stderr(err)}")

        # Q5: --checkpoint-dir, a crash after the first checkpoints, a
        # resume.
        from gelly_torch.engine import faults

        ckpt = os.path.join(tmp, "ckpt")
        args = [path, str(Q_CKPT_MERGE), f"--checkpoint-dir={ckpt}", dev]
        plan = faults.FaultPlan([faults.Fault("step", at=Q_CKPT_CRASH,
                                              retryable=False)])
        t0 = time.perf_counter()
        try:
            with faults.install(plan):
                run_cli("connected_components", args)
        except faults.FaultInjected:
            pass
        else:
            check(False, "Q5: the injected crash did not end the run")
        crash_s = time.perf_counter() - t0
        kept = sorted(os.listdir(ckpt))
        check(kept, "Q5: no checkpoint before the crash")
        counter = faults.FaultPlan([])
        reset_launches(kernels)
        with faults.install(counter):
            out, wall = run_cli("connected_components", args)
        launches["gather"]["Q5 resume"] = \
            kernels.sorted_window_gather.launches
        steps = counter.calls("step")
        check("# resumed from " in out, f"Q5: the rerun did not resume:\n"
              f"{out[:500]}")
        check(steps < Q_EDGES // 4096, f"Q5: the rerun folded {steps} chunks")
        check(np.array_equal(cli_labels(out, Q_N), oracle),
              "Q5: resumed components != Q2's")
        print(f"phase Q5: crashed at fold {Q_CKPT_CRASH} after "
              f"{crash_s:.2f} s with {len(kept)} checkpoint(s) kept; the "
              f"rerun resumed, folded {steps} of {Q_EDGES // 4096} chunks "
              f"in {wall:.4f} s, components equal to Q2's")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase Q launches: gather {launches['gather']}, wedge "
          f"{launches['wedge']}")
    return launches


def main() -> int:
    import faulthandler

    import torch

    # A hang anywhere prints every thread's stack and exits nonzero before
    # the card's time limit.
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)

    if sys.argv[1:2] == ["--cli-client"]:
        # Phase Q4's host-only client: it must not touch the card.
        return cli_client()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a card only",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import gelly_torch
    except ImportError as e:
        print(f"chip_smoke: gelly_torch not found beside this script ({e})",
              file=sys.stderr)
        return 2
    if not os.path.abspath(gelly_torch.__file__).startswith(here + os.sep):
        print("chip_smoke: gelly_torch was imported from outside the "
              "checkout", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--durable-child"]:
        return durable_child(sys.argv[2])
    if sys.argv[1:2] == ["--coord-child"]:
        return coord_child(sys.argv[2], int(sys.argv[3]))
    if sys.argv[1:2] == ["--ingest-child"]:
        return ingest_child(sys.argv[2])
    if sys.argv[1:2] == ["--ingest-client"]:
        return ingest_client(sys.argv[2])
    from gelly_torch.core.io import EdgeChunkSource, TimeCharacteristic
    from gelly_torch.core.stream import edge_stream_from_source
    from gelly_torch.core.vertices import IdentityVertexTable
    from gelly_torch.library import connected_components as cc
    from gelly_torch.library import triangles as tri
    from gelly_torch.ops import _build, kernels, unionfind

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0].strip()
    kind = torch.cuda.get_device_name(0)
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    # 2. build every kernel from the checkout's sources
    for res in _build.build_all(force=True):
        print(f"build {res.name}: nvcc {res.seconds:.2f} s -> "
              f"{os.path.relpath(res.path, here)}")
        for line in res.log.splitlines():
            if any(key in line for key in ("entry function", "registers",
                                           "smem", "spill", "Performance")):
                print(f"  ptxas {line.strip()}")

    # The stream (set-up, not timed).
    t0 = time.perf_counter()
    src, dst = synth_edges(N_EDGES, N_VERTICES, SEED)
    print(f"stream: {N_EDGES} Zipf edges over {N_VERTICES} slots "
          f"(seed {SEED}) in {time.perf_counter() - t0:.2f} s")
    unique_cap = max(1 << 20, 3 * (CHUNK >> 4))

    # 3. kernel phase at the path's shapes
    mark("3", t_start)
    chunks = iter(EdgeChunkSource(src, dst, chunk_size=CHUNK,
                                  table=IdentityVertexTable(N_VERTICES)))
    c1 = next(chunks).to(device)
    c2 = next(chunks).to(device)
    table = unionfind.union_edges_dedup(
        unionfind.fresh_forest(N_VERTICES, device), c1.src, c1.dst,
        c1.valid, unique_cap=unique_cap, backend="plain")
    uu, _, live0, ucount = unionfind._dedup_pairs(
        c2.src, c2.dst, c2.valid, min(unique_cap, CHUNK))
    sidx = torch.where(live0, uu, N_VERTICES - 1).contiguous()
    got = kernels.sorted_window_gather(table, sidx)
    torch.cuda.synchronize()
    want = kernels.sorted_window_gather_plain(table, sidx)
    max_abs_err = int((got.long() - want.long()).abs().max())
    check(torch.equal(got, want),
          f"kernel != plain version (max abs err {max_abs_err})")
    hit = got >= 0
    hit_share = float(hit[live0].float().mean())
    L = sidx.shape[0]
    sectors = int(torch.unique_consecutive(sidx[hit].long() // 8).numel())
    bound_bytes = 8 * L + 32 * sectors
    bound_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
    kernel_ms = time_ms(torch, lambda: kernels.sorted_window_gather(
        table, sidx), device)
    plain_ms = time_ms(torch, lambda: kernels.sorted_window_gather_plain(
        table, sidx), device)
    library_ms = time_ms(torch, lambda: table[sidx], device)
    # Floors of this timing harness: an event pair around no work, and a
    # streaming copy of the index lanes (the gather's bytes without the
    # table sectors).
    floor_ms = time_ms(torch, lambda: None, device)
    copy_ms = time_ms(torch, lambda: got.copy_(sidx), device)
    print(f"kernel sorted_window_gather: n={N_VERTICES} L={L} "
          f"live={int(ucount)} hit_share={hit_share:.6f} exact=True "
          f"kernel_ms={kernel_ms:.6f} plain_ms={plain_ms:.6f} "
          f"library_ms={library_ms:.6f} bound_ms={bound_ms:.6f} "
          f"(bytes: {8 * L} idx+out + {32 * sectors} table sectors) "
          f"event_floor_ms={floor_ms:.6f} index_copy_ms={copy_ms:.6f}")
    del c1, c2, table, uu, live0, sidx, got, want, hit

    # 4. path phase at full size
    mark("4", t_start)
    def run_path(backend: str):
        stream = edge_stream_from_source(
            EdgeChunkSource(src, dst, chunk_size=CHUNK,
                            table=IdentityVertexTable(N_VERTICES)),
            N_VERTICES)
        agg = cc.connected_components(
            N_VERTICES, merge="gather", ingest_combine=False,
            fold_backend=backend)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        reset_launches(kernels)
        unionfind.host_sync.count = 0
        t = time.perf_counter()
        res = stream.aggregate(agg, merge_every=MERGE_EVERY)
        out = list(res)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        stats = {
            "wall_s": wall,
            "edges_per_s": N_EDGES / wall,
            "h2d_bytes": res.stats["h2d_bytes"],
            "launches": kernels.sorted_window_gather.launches,
            "fixpoints": fixpoint_counts(kernels),
            "host_syncs": unionfind.host_sync.count,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(device),
        }
        return [x.cpu().numpy() for x in out], stats

    labels, st = run_path("kernel")
    labels_plain, st_plain = run_path("plain")
    n_chunks = -(-N_EDGES // CHUNK)
    for name, s in (("kernel", st), ("plain", st_plain)):
        print(f"path fold_backend={name}: {s['edges_per_s']:.1f} edges/s "
              f"wall={s['wall_s']:.4f} s "
              f"peak_mem={s['peak_mem_bytes']} B "
              f"host_syncs/chunk={s['host_syncs'] / n_chunks:.2f} "
              f"gather_launches={s['launches']} "
              f"fixpoint_launches={s['fixpoints']}")

    # Independent count of the chunks that take the dedup fold (chunk >=
    # RAW_DEDUP_MIN_CHUNK): the kernel backend gathers 3 times in each,
    # whether its distinct pairs fit unique_cap or overflow it (the
    # overflow is a device value that masks the rounds).
    dedup_flags = []
    overflows = 0
    for lo in range(0, N_EDGES, CHUNK):
        s = torch.from_numpy(src[lo:lo + CHUNK]).to(device).long()
        d = torch.from_numpy(dst[lo:lo + CHUNK]).to(device).long()
        key = (torch.minimum(s, d) << 32) | torch.maximum(s, d)
        overflows += int(torch.unique(key).numel()) > unique_cap
        dedup_flags.append(CHUNK >= cc.RAW_DEDUP_MIN_CHUNK)
    dedup_chunks = sum(dedup_flags)
    print(f"dedup-fold chunks: {dedup_chunks} of {n_chunks} "
          f"({overflows} over unique_cap)")
    check(len(labels) == len(labels_plain) == -(-n_chunks // MERGE_EVERY),
          f"emission count {len(labels)} / {len(labels_plain)}")
    for i, (a, b) in enumerate(zip(labels, labels_plain)):
        check(a.dtype == np.int32 and a.shape == (N_VERTICES,),
              f"emission {i}: {a.dtype} {a.shape}")
        check(np.array_equal(a, b), f"emission {i}: kernel != plain backend")
    t0 = time.perf_counter()
    oracle = scipy_oracle(src, dst, N_VERTICES)
    check(np.array_equal(labels[-1], oracle), "final labels != scipy oracle")
    print(f"oracle: scipy csgraph labels equal "
          f"({int((oracle >= 0).sum())} seen slots, "
          f"{int(np.unique(oracle[oracle >= 0]).size)} components) "
          f"in {time.perf_counter() - t0:.2f} s")
    check(st["launches"] > 0, "the path launched no sorted_window_gather")
    check(st["launches"] == 3 * dedup_chunks,
          f"{st['launches']} launches != 3 x {dedup_chunks} dedup chunks")
    check(st_plain["launches"] == 0, "the plain backend launched the kernel")
    for name, s in (("kernel", st), ("plain", st_plain)):
        # Every fold and close on the card, no round read on the host: the
        # dedup fold's three gated fixpoints a chunk, a jump a close.
        check(s["host_syncs"] == 0, f"fold_backend={name}: "
              f"{s['host_syncs']} host syncs (want 0 a chunk)")
        check(s["fixpoints"]["rooted_fixpoint"] == 3 * dedup_chunks,
              f"fold_backend={name}: {s['fixpoints']['rooted_fixpoint']} "
              f"rooted_fixpoint launches != 3 x {dedup_chunks}")
        check(s["fixpoints"]["pointer_jump"] >= len(labels),
              f"fold_backend={name}: {s['fixpoints']['pointer_jump']} "
              f"pointer_jump launches for {len(labels)} closes")

    # U. the union-find fixpoints on inputs captured from the paths: phase
    # 4's first dedup chunk's tail and first close (its first emission
    # again), and a 4-shard gather merge's merge_forest_stack (the raw
    # plan with merge="gather" over 2 K1 chunks, its emission phase 4's
    # at that boundary).
    mark("U", t_start)
    tail = FirstCall(torch, unionfind, "rooted_fixpoint")
    close = FirstCall(torch, unionfind, "pointer_jump")
    with tail, close:
        first = next(iter(edge_stream_from_source(
            EdgeChunkSource(src, dst, chunk_size=CHUNK,
                            table=IdentityVertexTable(N_VERTICES)),
            N_VERTICES).aggregate(cc.connected_components(
                N_VERTICES, merge="gather", ingest_combine=False,
                fold_backend="kernel"), merge_every=MERGE_EVERY)))
    check(np.array_equal(first.cpu().numpy(), labels[0]),
          "phase U: the captured run's first emission != phase 4's")
    u_edges = 2 * K1_CHUNK
    merge = FirstCall(torch, unionfind, "union_edges")
    reset_launches(kernels)
    with merge:
        merged = list(edge_stream_from_source(
            EdgeChunkSource(src[:u_edges], dst[:u_edges], chunk_size=K1_CHUNK,
                            table=IdentityVertexTable(N_VERTICES)),
            N_VERTICES, device=device).aggregate(cc.connected_components(
                N_VERTICES, merge="gather", ingest_combine=False,
                fold_backend="kernel", merge_mode="replicated"),
                mesh=k_mesh(device), merge_every=1))
    u_merge_launches = fixpoint_counts(kernels)
    check(len(merged) == u_edges // K1_CHUNK and all(
        np.array_equal(x.cpu().numpy(), labels[i])
        for i, x in enumerate(merged)),
        "phase U: the 4-shard gather merge's emissions != phase 4's")
    check(u_merge_launches["union_edges"] >= len(merged),
          f"phase U: {u_merge_launches['union_edges']} union_edges "
          f"launches for {len(merged)} merge_forest_stack merges")
    del first, merged
    u = {"rooted_fixpoint": fixpoint_phase(
             torch, device, "rooted_fixpoint", tail,
             "phase 4's first dedup chunk's tail"),
         "pointer_jump": fixpoint_phase(
             torch, device, "pointer_jump", close, "phase 4's first close"),
         "union_edges": fixpoint_phase(
             torch, device, "union_edges", merge,
             "a 4-shard merge_forest_stack", reps=5)}
    print(f"phase U merge run launches: {u_merge_launches}")
    del tail, close, merge
    torch.cuda.empty_cache()

    # R. the sync audit on this stream's first chunks; R1 joins at the end
    mark("R", t_start)
    gate = analysis_gate_start()
    sync_audit_phase(torch, device, src, dst, labels[0])

    # F1. the per-window Merger plan, and host_precombine, on this stream
    mark("F1", t_start)
    merger_phase(torch, device, src, dst,
                 labels[:F1_PRECOMBINE_CHUNKS // MERGE_EVERY])

    # C. the resilient raw fold with the kernel, under two faults
    mark("C, B", t_start)
    c_run = resilient_raw_phase(torch, device, src, dst, labels[-1],
                                st["wall_s"])
    # B. kill -9 of a child checkpointing the compact plan, then resume
    kill9_phase(torch, device, src, dst, oracle)
    del labels_plain
    torch.cuda.empty_cache()

    # O. the mesh across processes and coordinated recovery
    mark("O", t_start)
    coord = coord_phase(torch, device, src, dst, labels[-1], oracle,
                        dedup_flags)

    # D. degrees; E. bipartiteness (both on phase 4's stream at Twitter
    mark("D, E", t_start)
    # scale, after their bench-size cells)
    degrees_phase(torch, device, src, dst)
    torch.cuda.empty_cache()
    e = bipartiteness_phase(torch, device, src, dst)
    torch.cuda.empty_cache()

    # F2-F4. the k-spanner; G. weighted matching
    mark("F2-F4, G", t_start)
    f2_stream: dict = {}
    f2 = spanner_bench_phase(torch, device, f2_stream)
    torch.cuda.empty_cache()
    f3 = spanner_twitter_phase(torch, device, src, dst)
    torch.cuda.empty_cache()

    # L. fused multi-query on phase 4's stream (L1 against F3's emissions)
    mark("L", t_start)
    mq = multiquery_phase(torch, device, src, dst, labels, st, dedup_chunks,
                          f3)
    torch.cuda.empty_cache()

    # M. the traced main path (M3 against L2's emissions)
    mark("M", t_start)
    traced = obs_phase(torch, device, src, dst, labels, dedup_chunks, mq,
                       c_run)
    del c_run
    torch.cuda.empty_cache()

    # N. the tenant engine
    mark("N", t_start)
    tenants = tenant_phase(torch, device)

    # P. ingest: the readers, the parser and the wire into the kernel fold
    mark("P", t_start)
    ingest = ingest_phase(torch, device, src, dst, labels, oracle,
                          dedup_flags, tenants)
    for key in ("n2_edges", "n2_labels"):
        tenants.pop(key)
    torch.cuda.empty_cache()

    # Q. the example CLIs (gelly_torch/examples/) on the card
    mark("Q", t_start)
    clis = cli_phase(torch, device)
    torch.cuda.empty_cache()

    mark("F4, G", t_start)
    f4 = spanner_gate_phase(torch, device, f2_stream)
    del f2_stream
    torch.cuda.empty_cache()
    g = matching_phase(torch, device)
    torch.cuda.empty_cache()

    # H. windows; I. the stream API (H1-I4 on phase 4's stream)
    mark("H, I1-I4", t_start)
    pane_ring_phase(torch, device, src, dst, labels)
    ttl_phase(torch, device)
    event_time_phase(torch, device, src, dst, labels, dedup_chunks)
    windowed_degrees_phase(torch, device, src, dst)
    i1 = distinct_phase(torch, device, src, dst)
    hk = hash_kernel_phase(torch, device)
    transforms_phase(torch, device, src, dst)
    iterative_cc_phase(torch, device, src, dst, oracle)

    # K1-K4. the mesh: four logical shards on the card, phase 4's stream
    mark("K1-K4", t_start)
    k14 = mesh_cc_phase(torch, device, src, dst, labels, oracle,
                        dedup_chunks)
    torch.cuda.empty_cache()
    del labels
    i4 = neighborhood_phase(torch, device)
    torch.cuda.empty_cache()

    # The triangle stream (set-up, not timed).
    t0 = time.perf_counter()
    tsrc, tdst = synth_edges(TRI_EDGES, TRI_N, SEED)
    tts = np.arange(TRI_EDGES, dtype=np.int64)
    print(f"triangle stream: {TRI_EDGES} Zipf edges over {TRI_N} slots "
          f"(seed {SEED}), {TRI_EDGES // TRI_WINDOW_MS} windows of "
          f"{TRI_WINDOW_MS} edges, in {time.perf_counter() - t0:.2f} s")

    def tri_stream():
        return edge_stream_from_source(
            EdgeChunkSource(tsrc, tdst, timestamps=tts, chunk_size=TRI_CHUNK,
                            table=IdentityVertexTable(TRI_N),
                            time=TimeCharacteristic.EVENT),
            TRI_N)

    # 5. wedge kernel phase: the first window's wedge mask
    mark("5", t_start)
    torch.backends.cuda.matmul.allow_tf32 = False
    _, col0 = next(tri._packed_out_windows(
        tri_stream(), TRI_WINDOW_MS, TRI_WINDOW_CAPACITY, TRI_N))
    m, _, _ = tri._wedge_mask(torch.from_numpy(col0).to(device), TRI_N, TRI_N)
    w_kernel = kernels.wedge_count_matrix(m)
    torch.cuda.synchronize()
    w_plain = kernels.wedge_count_matrix_plain(m)
    w_err = float((w_kernel - w_plain).abs().max())
    check(torch.equal(w_kernel, w_plain),
          f"wedge kernel != plain version (max abs err {w_err})")
    nnz = int(m.sum())
    del w_kernel
    # The work this mask needs: upper tiles, live k-blocks only.
    flags = kernels.wedge_block_flags_plain(m)
    wedge_ops = kernels.wedge_needed_ops(flags)
    triples = wedge_ops // (2 * kernels.TILE ** 3)
    live_blocks = int(flags.sum())
    del flags
    lib_name, wedge_lib_ms, lib_lines = library_yardstick(
        torch, m, w_plain, device)
    del w_plain
    torch.cuda.empty_cache()
    wedge_ms = time_ms(torch, lambda: kernels.wedge_count_matrix(m), device,
                       reps=WEDGE_REPS, warmup=1)
    prepass_ms = time_ms(torch, lambda: kernels.wedge_block_prepass(m),
                         device, reps=WEDGE_REPS, warmup=1)
    wedge_plain_ms = time_ms(
        torch, lambda: kernels.wedge_count_matrix_plain(m), device,
        reps=WEDGE_REPS, warmup=1)
    ops_ms = wedge_ops / INT8_OPS_PER_S * 1e3
    dense_ops_ms = 2 * TRI_N ** 3 / INT8_OPS_PER_S * 1e3
    bytes_ms = 5 * TRI_N ** 2 / HBM_BYTES_PER_S * 1e3
    wedge_bound_ms = max(ops_ms, bytes_ms)
    wedge_bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    dense_bound_ms = max(dense_ops_ms, bytes_ms)
    for line in lib_lines:
        print(f"  library candidate {line}")
    # Shared-memory fill of the tile kernel: two Mt tiles a live triple,
    # one on the diagonal tiles.
    fill_tbps = (triples * 2 * kernels.TILE ** 2 / ((wedge_ms - prepass_ms)
                                                    * 1e-3) / 1e12)
    print(f"kernel wedge_count_matrix: N={TRI_N} mask nnz={nnz} exact=True "
          f"kernel_ms={wedge_ms:.6f} prepass_ms={prepass_ms:.6f} "
          f"(share {prepass_ms / wedge_ms:.4f}) "
          f"plain_ms={wedge_plain_ms:.6f} "
          f"library_ms={wedge_lib_ms:.6f} ({lib_name}) "
          f"bound_ms={wedge_bound_ms:.6f} ({wedge_bound_by}: {triples} live "
          f"block triples of {live_blocks} live blocks = {wedge_ops} ops / "
          f"{INT8_OPS_PER_S:.4g} vs 5N^2 bytes / {HBM_BYTES_PER_S:.4g}) "
          f"dense_bound_ms={dense_bound_ms:.6f} (2N^3 ops) "
          f"tile_fill_TBps<={fill_tbps:.3f}")
    del m
    torch.cuda.empty_cache()

    # A dense random mask: every block live, so every k-block is summed and
    # every off-diagonal tile mirrored.
    gen = torch.Generator(device=device).manual_seed(SEED)
    m_dense = torch.rand((DENSE_N, DENSE_N), generator=gen,
                         device=device) < 0.3
    check(bool(kernels.wedge_block_flags_plain(m_dense).all()),
          "the dense check mask has a dead block")
    w_dense = kernels.wedge_count_matrix(m_dense)
    torch.cuda.synchronize()
    w_dense_plain = kernels.wedge_count_matrix_plain(m_dense)
    dense_err = float((w_dense - w_dense_plain).abs().max())
    check(torch.equal(w_dense, w_dense_plain),
          f"wedge kernel != plain version on the dense N={DENSE_N} mask "
          f"(max abs err {dense_err})")
    print(f"kernel wedge_count_matrix: dense random N={DENSE_N} mask "
          f"exact=True")
    del m_dense, w_dense, w_dense_plain
    torch.cuda.empty_cache()

    # Host side alone (window assembly, dedup, packing): how much of the
    # path's wall the device cannot overlap with batch = #windows.
    t0 = time.perf_counter()
    n_cols = sum(1 for _ in tri._packed_out_windows(
        tri_stream(), TRI_WINDOW_MS, TRI_WINDOW_CAPACITY, TRI_N))
    host_s = time.perf_counter() - t0
    print(f"triangle host windows alone: {n_cols} packed columns in "
          f"{host_s:.4f} s")

    # 6. triangle path at full width
    mark("6", t_start)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches(kernels)
    unionfind.host_sync.count = 0
    t = time.perf_counter()
    wins, counts = zip(*tri.window_triangle_counts_batched(
        tri_stream(), TRI_WINDOW_MS, window_capacity=TRI_WINDOW_CAPACITY,
        method="auto", batch=TRI_BATCH))
    counts = torch.stack(counts).cpu()  # the one pull of the run
    tri_wall = time.perf_counter() - t
    tri_launches = kernels.wedge_count_matrix.launches
    tri_peak = torch.cuda.max_memory_allocated(device)
    print(f"path window_triangle_counts_batched: "
          f"{TRI_EDGES / tri_wall:.1f} edges/s wall={tri_wall:.4f} s "
          f"peak_mem={tri_peak} B windows={len(wins)} "
          f"wedge_launches={tri_launches} "
          f"gather_launches={kernels.sorted_window_gather.launches}")

    # Checks: dtype, per-window oracle, independent launch count.
    n_windows = TRI_EDGES // TRI_WINDOW_MS
    check(list(wins) == list(range(n_windows)), f"windows {wins}")
    check(counts.dtype == torch.int64, f"count dtype {counts.dtype}")
    t0 = time.perf_counter()
    uniques = []
    for w in range(n_windows):
        a, b = window_edges(torch, tsrc, tdst, w, device)
        uniques.append(int(a.numel()))
        want = triangle_oracle(torch, a, b, device)
        check(int(counts[w]) == want,
              f"window {w}: {int(counts[w])} triangles != oracle {want}")
        print(f"  window {w}: {want} triangles over {uniques[-1]} unique "
              f"edges (oracle equal)")
    print(f"oracle: A^3 on the card in {time.perf_counter() - t0:.2f} s")
    expect = 0
    for lo in range(0, n_windows, TRI_BATCH):
        group = uniques[lo:lo + TRI_BATCH]
        bucket = max(1024, 1 << max(0, max(group) - 1).bit_length())
        if 2 * bucket >= TRI_N:
            expect += len(group)
    check(tri_launches > 0, "the triangle path launched no wedge kernel")
    check(tri_launches == expect,
          f"{tri_launches} wedge launches != {expect} kernel windows")

    # I5. SnapshotStream over this stream's windows
    mark("I5", t_start)
    snapshot_phase(torch, device, tsrc, tdst, i4)
    del tsrc, tdst, tts, counts
    i4.pop("s"), i4.pop("d")
    torch.cuda.empty_cache()

    # J. the rest of the triangle library
    mark("J", t_start)
    j = triangle_library_phases(torch, device)

    # K5-K6. the mesh on J4's stream
    mark("K5-K6", t_start)
    k56 = mesh_triangle_phase(torch, device, j["j4"]["src"], j["j4"]["dst"],
                              j["j4"]["total"], j["j6"]["est"])
    torch.cuda.empty_cache()

    # 7. the compact CC path
    mark("7", t_start)
    star = compact_cc_phase(torch, device, src, dst, oracle)
    del src, dst, oracle

    # 8. result lines
    mark("8", t_start)
    # R1's gate, started at phase R, joined before the result lines.
    analysis_gate_finish(gate)
    print(json.dumps({"kernels": [{
        "name": "sorted_window_gather",
        "route": "cuda",
        "source": "gelly_torch/csrc/sorted_window_gather.cu",
        "replaces": "gelly_tpu/ops/pallas_kernels.py:174",
        "launches": st["launches"],
        "mesh_launches": k14["gather_launches"],
        "multiquery_launches": mq["gather_launches"],
        "obs_launches": traced["gather_launches"],
        "tenant_launches": tenants["gather_launches"],
        "multihost_launches": {
            "o1_hosts": coord["gather_launches"],
            "o3_processes": coord["o3_gather_launches"]},
        "ingest_launches": ingest,
        "cli_launches": clis["gather"],
        "max_abs_err": max(max_abs_err, k14["gather_err"],
                           coord["o3_gather_err"]),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": library_ms,
    }, {
        "name": "wedge_count_matrix",
        "route": "cuda",
        "source": "gelly_torch/csrc/wedge_count_matrix.cu",
        "replaces": "gelly_tpu/ops/pallas_kernels.py:69",
        "launches": tri_launches,
        "cli_launches": clis["wedge"],
        "max_abs_err": max(w_err, dense_err),
        "ms": wedge_ms,
        "plain_ms": wedge_plain_ms,
        "bound_ms": wedge_bound_ms,
        "bound_by": wedge_bound_by,
        "library_ms": wedge_lib_ms,
        "dense_bound_ms": dense_bound_ms,
        "live_block_triples": triples,
        "prepass_ms": prepass_ms,
        "prepass_share": prepass_ms / wedge_ms,
        "unpacked_path": {"launches": j["j2"]["launches"],
                          "n": J2_N, "ms": j["j2"]["ms"],
                          "bound_ms": j["j2"]["bound_ms"],
                          "bound_by": j["j2"]["bound_by"],
                          "sampled_max_abs_err": j["j2"]["max_abs_err"]},
    }, {
        "name": "sparse_insert_edges",
        "route": "cuda",
        "source": "gelly_torch/csrc/spanner_gate.cu",
        "replaces": "gelly_tpu/library/spanner.py:178",
        "launches": f4["launches"],
        "max_abs_err": 0,
        "ms": f4["ms"],
        "plain_ms": f4["plain_ms"],
        "bound_ms": f4["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "bound_bytes": f4["bound_bytes"],
        "us_per_live_edge": {"F4(i)": f4["us_edge"],
                             "F4(ii) payloads": f4["payload_us_edge"]},
        "timed_on": "F4(i), one launch",
    }, {
        "name": "sparse_insert_edges_batched",
        "route": "cuda",
        "source": "gelly_torch/csrc/spanner_gate.cu",
        "replaces": "gelly_tpu/library/spanner.py:309",
        "launches": f3["launches"],
        "multiquery_launches": mq["merge_launches"],
        "max_abs_err": 0,
        "ms": f2["ms"],
        "plain_ms": f2["plain_ms"],
        "bound_ms": f2["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "bound_bytes": f2["bound_bytes"],
        "us_per_batch": {"F2 close 2": f2["us_batch"],
                         "F3 closes 2-4": f3["close_us_batch"]},
        "f3_close_ms": f3["close_ms"],
        "timed_on": "F2 window close 2",
    }, {
        "name": "matching_step",
        "route": "cuda",
        "source": "gelly_torch/csrc/matching_step.cu",
        "replaces": "gelly_tpu/library/matching.py:48",
        "launches": g["launches"],
        "max_abs_err": g["max_abs_err"],
        "ms": g["ms"],
        "plain_ms": g["plain_ms"],
        "bound_ms": g["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "timed_on": f"G {G_TIMED}-edge prefix",
    }, {
        "name": "hashset_insert",
        "route": "cuda",
        "source": "gelly_torch/csrc/hashset.cu",
        "replaces": "gelly_tpu/ops/hashset.py:52",
        "launches": i1["insert_launches"],
        "max_abs_err": hk["max_abs_err"],
        "ms": i1["insert_ms"],
        "plain_ms": i1["insert_plain_ms"],
        "bound_ms": i1["insert_bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "path_chunk_ms": i1["chunk_ms"],
        "path_first_ms": i1["path_first_ms"],
        "path_second_ms": i1["path_second_ms"],
        "timed_on": f"I1's first {CHUNK}-key chunk, again after one warm-up "
                    f"call, mean of 5",
        "random_state": {"ms": hk["ms"], "plain_ms": hk["plain_ms"],
                         "bound_ms": hk["bound_ms"],
                         "on": f"{HASH_PLAIN_KEYS} keys into a "
                               f"{HASH_PLAIN_CAP}-slot table"},
        "adversarial": {**hk["adversarial"],
                        "on": f"{HASH_ADV_KEYS} keys homed in "
                              f"{HASH_ADV_HOMES} slots of a {HASH_ADV_CAP}"
                              f"-slot table at load {HASH_ADV_LOAD}"},
    }, {
        "name": "hashset_contains",
        "route": "cuda",
        "source": "gelly_torch/csrc/hashset.cu",
        "replaces": "gelly_tpu/ops/hashset.py:88",
        "launches": i1["contains_launches"],
        "max_abs_err": 0,
        "ms": i1["contains_ms"],
        "plain_ms": i1["contains_plain_ms"],
        "bound_ms": i1["contains_bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "timed_on": f"I1's table, {i1['contains_keys']} keys",
    }, {
        "name": "row_insert_chunk",
        "route": "cuda",
        "source": "gelly_torch/csrc/row_insert.cu",
        "replaces": "gelly_tpu/core/neighborhood.py:41",
        "launches": i4["launches"],
        "max_abs_err": 0,
        "ms": i4["ms"],
        "plain_ms": i4["plain_ms"],
        "bound_ms": i4["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "path_chunk_ms": i4["chunk_ms"],
        "timed_on": f"I4's first {I4_PLAIN_EDGES} edges",
    }, {
        "name": "sampler_step",
        "route": "cuda",
        "source": "gelly_torch/csrc/sampler_step.cu",
        "replaces": "gelly_tpu/library/triangles.py:1421",
        "launches": j["j6"]["launches"],
        "mesh_launches": k56["sampler_launches"],
        "multihost_launches": {
            "o3_processes": coord["o3_sampler_launches"]},
        "max_abs_err": 0,
        "ms": j["j6"]["ms"],
        "plain_ms": j["j6"]["plain_ms"],
        "bound_ms": j["j6"]["bound_ms"],
        "bound_by": j["j6"]["bound_by"],
        "library_ms": None,
        "timed_on": f"J6's first {J6_PLAIN_LANES} lanes, S={J6_SAMPLES}",
    }, {
        "name": "sparse_fold_chunk_k2",
        "route": "cuda",
        "source": "gelly_torch/csrc/spanner_fold_k2.cu",
        "replaces": "gelly_tpu/library/spanner.py:213",
        "launches": f3["fold_launches"],
        "phase_launches": {"F2": f2["fold_launches"],
                           "F3": f3["fold_launches"],
                           **mq["fold_launches"]},
        "max_abs_err": max(f2["fold_err"], f3["fold_err"]),
        "ms": f3["fold_ms"],
        "plain_ms": f3["fold_plain_ms"],
        "bound_ms": f3["fold_bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "bound_bytes": f3["fold_bound_bytes"],
        "bound_rows": f3["fold_rows"],
        "chain": f3["fold_chain"],
        "us_per_sub_batch": f3["fold_ms"] * 1e3 / f3["fold_chain"],
        "grid_barriers": f3["fold_barriers"],
        "grid_barriers_per_sub_batch": f3["fold_barriers"] / f3["fold_chain"],
        "warm_ms": f3["fold_warm_ms"],
        "warm_us_per_sub_batch": f3["fold_warm_ms"] * 1e3 / f3["fold_chain"],
        "chain_floor_ms": f3["fold_floor_ms"],
        "path_chunk_ms": f3["fold_chunk_ms"],
        "path_chunk_host_ms": f3["fold_host_ms"],
        "f3_fold_dispatch_s": f3["fold_dispatch_s"],
        "f2_chunk_ms": f2["fold_chunk_ms"],
        "f2_us_per_sub_batch": [m * 1e3 / f2["fold_chain"]
                                for m in f2["fold_chunk_ms"]],
        "f2_grid_barriers": f2["fold_barriers"],
        "timed_on": f"F3's second {CHUNK}-lane chunk, its one call in the "
                    f"run (grid barriers met in that call; warm_ms: again "
                    f"on its inputs after one warm-up call, mean of "
                    f"{FOLD_REPS})",
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "gelly_torch/csrc/unionfind_fixpoint.cu",
        "replaces": replaces,
        "launches": launches,
        "phase_launches": phases,
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "ms": checks[0]["ms"],
        "plain_ms": checks[0]["plain_ms"],
        "bound_ms": checks[0]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "bound_bytes": checks[0]["bound_bytes"],
        "rounds_met": checks[0]["rounds_met"],
        "plain_rounds": checks[0]["plain_rounds"],
        "timed_on": checks[0]["timed_on"],
        "other_inputs": [{k: c[k] for k in (
            "timed_on", "ms", "plain_ms", "bound_ms", "rounds_met",
            "plain_rounds")} for c in checks[1:]],
    } for name, replaces, launches, phases, checks in (
        ("rooted_fixpoint", "gelly_tpu/ops/unionfind.py:158",
         st["fixpoints"]["rooted_fixpoint"],
         {"4 kernel": st["fixpoints"]["rooted_fixpoint"],
          "4 plain": st_plain["fixpoints"]["rooted_fixpoint"],
          "7 warm-up": star["launches"],
          "K1": k14["fixpoint_launches"]["rooted_fixpoint"]},
         [u["rooted_fixpoint"], star, star["open_gate"]]),
        ("pointer_jump", "gelly_tpu/ops/unionfind.py:40",
         st["fixpoints"]["pointer_jump"],
         {"4 kernel": st["fixpoints"]["pointer_jump"],
          "4 plain": st_plain["fixpoints"]["pointer_jump"],
          "K1": k14["fixpoint_launches"]["pointer_jump"]},
         [u["pointer_jump"]]),
        ("union_edges", "gelly_tpu/ops/unionfind.py:52",
         u_merge_launches["union_edges"],
         {"U 4-shard gather merge": u_merge_launches["union_edges"],
          "4 kernel": st["fixpoints"]["union_edges"],
          "K1": k14["fixpoint_launches"]["union_edges"]},
         [u["union_edges"]]),
    ) + tuple(
        (name, f"gelly_tpu/ops/parity_unionfind.py:{line}",
         e["launches"]["E2 sparse codec run 1"][name],
         {**{k: v[name] for k, v in e["launches"].items()},
          **{k: v[name] for k, v in mq["parity_launches"].items()}},
         e[name])
        for name, line in (("union_edges_parity", 57),
                           ("pointer_jump_parity", 43)))]}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        for child in _CHILDREN:
            if child.poll() is None:
                child.kill()
                child.wait()
