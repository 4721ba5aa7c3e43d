#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``dgraph_tpu_torch``) on one
NVIDIA GPU.  Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each fatal (exit code 1, no result line).  Every printed p99 is
null where a figure rests on fewer than ``P99_MIN`` (20) requests: over
fewer it is no more than the largest one.

1. build — compile every kernel source under ``dgraph_tpu_torch/csrc``
   with nvcc for sm_90a, one process per source, all started together;
   print the card's name and power limit.
1b. kernel_contracts — the hand kernels' contract registry
   (``dgraph_tpu_torch/analysis/programs.py``) on the card: each wrapper
   (gather_fused, slotmap_tiles, intersect_tiles) at the registry's small
   instances, called on a side stream under
   ``torch.cuda.set_sync_debug_mode("error")`` with the default stream
   kept busy; one line per kernel with its launches a call (must be 1),
   host syncs seen (0), the stream its launches were given (the
   caller's) and its greatest difference from the plain version after
   the side stream's event (0).  Beside it, as two subprocesses, the
   analysis CLI's passes over the tree (``python -m
   dgraph_tpu_torch.analysis`` and ``--races``): their finding counts
   are printed and must be 0, the lock graph cycle-free.  A few seconds,
   no graph; right after the build, so that a contract fault stops the
   run early.
2. graph — generate the bench graph (bench.py's generator: 2,000,000
   nodes, 21,000,000 pareto-skewed edges, seed 7), load it through
   ``PostingStore.bulk_set_uid_edges`` on the uid predicate ``e``, and
   boot ``DgraphServer`` on cuda on an ephemeral port.
3. kernels — hold the gather kernel against its plain PyTorch version on
   the card, exactly (integer outputs: tolerance 0), one launch per call,
   over a grid: the main path's frontiers, random frontiers (B up to
   4096), truncation at cap, and the fused kernel's edges
   (``tests/torch_cases.py``): B 1, B ragged, B 2^20, total == cap, cap
   inside a row, tiles starting inside a long row, a 10^6-edge row, runs
   of rows that own no slot longer than a staging window, an all-skip
   frontier.
4. main path — every kernel's launch count is set to 0, then, over HTTP
   on the per-level route (the server's fused chain and fused @recurse
   pinned off, as in phases 7 and 9: these phases measure what earlier
   runs measured; the host-route engine pins them off too):
   a. a materialised 2-hop from 64 seeds, byte-identical to an engine
      over the same store pinned to the host route;
   b. a var-block 2-hop from 8192 seeds with a root ``count()``,
      repeated: it must launch the gather kernel, and its stats must
      hold a planner ``expand`` decision that took the resident route;
      edges/s and p50/p99 latency printed;
   c. a mutation adding edges from seed nodes, merged into the resident
      CSR on the device (epoch flips, no reseed), then a materialised
      2-hop over a fresh 8192-seed frontier holding those seeds,
      byte-identical to the host route with the new edges present.
   The counts are read right after.
5. names — the schema ``name: string @index(term) .`` and a name of 3
   words per node for uids 1..1,000,000, drawn uniformly from a fixed
   16-word vocabulary (seed 23), written into the served store; the
   server's term index is built.  Each word's posting set holds about
   176,000 uids, so a 3-word ``allofterms`` sums to about 528,000, above
   the default k-way gate (262,144).
6. intersect kernels — the intersect kernel against its plain version on
   the card, exactly: the served matrices of the join path (K 3, L 2^21
   for the ``@filter`` AND), bench_ops.py's draws (K 2/4/8 at L 8192;
   B 1/64/1024 × K 2/4/8 at L 1024), K 1 and K 16, an empty row, an
   all-SENT row 0, identical rows, L not a multiple of 256, and the
   tiling's edges (``tests/torch_cases.py``): every lane surviving (each
   tile's prefix exactly at its end), survivors only in the last tile, a
   dense row whose range under one tile is more than the kernel stages in
   shared memory, survivors spread thin over a 2^21-lane row, B 1024
   and B 70,000 batch rows (above a grid's y axis); then
   the served (a) matrix intersected 200 times, every result compared.
7. join path — every kernel's launch count is set to 0, then, over HTTP
   on the server of phase 2, repeated: (a) an ``@filter(has(e) AND
   uid(g))`` over the 2-hop set of 8192 seeds (one k-way call of K 3,
   L 2^21); (b) an ``allofterms`` over 3 words filtered by ``has(e) AND
   uid(f)`` (two k-way calls).  Each body must equal an engine over the
   same store pinned to the host route, each request of (a) must launch
   the intersect kernel at least once and of (b) twice; p50/p99 and the
   ``kway_ms`` of one ``?debug=true`` request are printed.  The counts
   are read right after.
7a. flight recorder — every kernel's launch count is set to 0, then, on
   the same server (both query caches detached, the per-level route),
   from 8192 seeds of ``default_rng(83)`` and phase 7's seed sets: the
   var-block 2-hop count and join (a) once each at trace ratio 0 (the
   bodies every later request must equal byte for byte); (o1) at ratio
   1, each 3 times with a ``Traceparent`` of the phase's own: the trace's
   tree must be query → parsing, processing → sched.queue, sched.flush,
   engine → hop (and join (a)'s device ``kway`` step); every hop on
   predicate ``e``, the device hops on the resident route with
   ``device_sync_ms`` > 0 and within the hop's duration; the gather's
   launches equal to the device hops the spans name and the intersect's
   to the ``kway`` spans; ``?format=chrome`` one event a span; (o2) at
   ratio 0, 10 counts (every other one with a sampled ``Traceparent``)
   allocate no span and record no trace; (o3) with a slow threshold of
   0.001 ms each request lands in ``/debug/slow_queries`` with a
   tail-sampled trace that resolves; (o4) a sampled count held by
   ``engine.hop=delay(ms=500)`` with its own ``Traceparent`` and tenant
   ``flight``: ``POST /admin/cancel?trace_id=`` answers 200, the count
   499, ``dgraph_query_cancelled_total{reason="admin"}`` rises by one,
   a second cancel answers 404; (o5) ``/debug/device`` says ``cuda`` and
   the card's name as nvidia-smi gives it, its resident bytes equal the
   ``ArenaManager``'s running total and are at most
   ``torch.cuda.memory_allocated()``, its kernel builds equal
   ``ops/_build``'s builds in this process; ``/debug/bundle`` has the
   reference's keys; the OpenMetrics ``/metrics`` carries latency
   exemplars whose trace ids resolve; (o6) the count 4 times at ratio 0
   and 4 at ratio 1, alternating: p50 of each and the mean
   ``device_sync_ms`` of a device hop (no limit is set on the cost).
   The counts are read right after.
7b. device guard — every kernel's launch count is set to 0, then, on the
   same server (caches detached, the per-level route), the var-block
   2-hop count from 8192 seeds of ``default_rng(91)`` and join (a), every
   200 body byte-identical to the host-route engine: (o) the count with
   ``DGRAPH_TPU_DEVGUARD`` 1 and 0 in turn, 4 each: both p50s, equal
   gather launches; (i) with two throwaway 2M-edge arenas at the LRU's
   cold end, ``device.hop=xla_oom(n=1)``: 200, ``evict_retry`` +1, an
   eviction, the guard healthy → suspect → healthy; (r) a ballast from
   ``torch.cuda.mem_get_info()`` leaves half the count's second-hop
   gather buffer free: a real ``OutOfMemoryError``, eviction and one
   retry answer 200 (or the line says what the allocator did instead);
   (h) ``DGRAPH_TPU_DEVICE_HANG_MS=500``, a 1 s cooldown,
   ``device.hop=hang(ms=3000,n=1)`` and the first 8 probes failing: the
   count answers 503 with ``Retry-After`` within 1.5 s; once the wedged
   hop has woken and made its launch, counts while sick answer 503 with
   no gather launch, ``/debug/device`` and ``/health?detail=1``
   say sick, 16 concurrent clients all 503, the scheduler's workers live,
   and after re-admission (within 10 s) both bodies are identical.  The
   counts are read right after.
7c. transports — every kernel's launch count is set to 0, then: (a) on
   the main path's server (caches detached, per level), the 2-hop count
   from 8192 seeds (``default_rng(103)``) and join (a), once each (20
   times under ``--transports-only``) over HTTP JSON, over HTTP with
   ``Accept: application/protobuf`` and over gRPC ``/protos.Dgraph/Run``,
   the transports in turn request by request: every body's tree
   (protobuf decoded with ``serve/proto.iter_fields``) equals the JSON
   surface's, which equals the host route's, every protobuf body's
   fields equal the encoder's of that tree (the latency field aside),
   and every request launches the gather (join (a) the intersect too),
   exactly as many of each as the JSON surface's first request; (b) a
   second server over the same store and arenas with a throwaway
   ``openssl`` certificate serves the same requests over HTTPS (a client
   context that pins the CA) and gRPC on TLS, with the same bodies and
   launches; a plaintext channel into the TLS
   listener fails, ``CheckVersion`` answers, ``AssignUids`` leases; the
   handshake's cost is the median of 20 fresh connections each, plain
   and TLS; (c) a count over ``e`` from 1024 seeds streamed over gRPC
   ``Subscribe`` (gates at 1): its snapshot equals ``/query``; after a
   write of 64 edges to uids outside the seeds' 2-hop set the pushed
   Response equals a fresh ``/query``; cancelling the stream drops the
   subscription, and the host-route engine takes the written edges (phase
   7d reuses it); (d) three servers on the card with TLS listeners,
   ``https://`` peers pinned by ``peer_ca``, raft over the gRPC Worker
   plane, phase 18's group rules and ``e`` on all three, ``name`` on the
   third alone, loaded with every 64th generated edge (328,125) and the
   names of uids 1..125,000: the load replicates, a group-1 follower
   answers the count over gRPC as the host route does, a write of 64
   edges through the third converges, and a read traced over gRPC on the
   first, which pulls ``name`` from the third, holds both servers'
   spans.  ``dgraph_grpc_raft_frames_total`` is printed.  Where grpcio
   does not import, one line says so and only the HTTP legs run.  The
   counts are read right after.
7d. subscriptions — every kernel's launch count is set to 0, then, with
   the hop and k-way gates at 1 (a 1024-seed 2-hop is below the priced
   break-even), 8 subscriptions (``default_rng(97)``): 4 var-block 2-hop
   counts over ``e`` from 1024 seeds (one streamed as SSE over HTTP) and
   4 two-word ``allofterms`` counts over ``name``, each snapshot equal to
   a fresh ``/query`` body; 3 writes of 64 ``e`` edges from the first-hop
   targets of one subscription's seeds to uids outside its 2-hop set:
   each ``e`` subscription whose count changed gets one push equal to the
   host-route engine at that version (its arena advanced by exactly the
   written edges), the others nothing; re-set edges re-evaluate as skips;
   a name write pushes the name subscriptions alone; an unrelated
   predicate wakes none.  Push latency from the write's ack (p50, max),
   evaluations, pushes and skips, and the launches during
   re-evaluations are printed; one subscription is cancelled over
   ``/subscribe/cancel``, the registry's stop (the server's stop path)
   cancels the rest.  The counts are read right after.
8. ranks — the schema ``rank: int .`` and an int per node for uids
   1..1,000,000, drawn from [0, 2^16) (seed 43: about 15 uids a value),
   written into the served store; the server's value arena is built.
9. query surface — every kernel's launch count is set to 0, then, over
   HTTP on the server of phase 2, each query repeated and its body held
   byte for byte against an engine over the same store pinned to the
   host route: (a) the order-by: a root ``orderasc: rank`` over the
   10^6 ranked uids, a child ``orderdesc: rank, first: 2`` on the 2-hop
   of 8192 seeds (about 346,000 second-level edges) and an order with
   ``offset`` and ``after``; the first two must sort on the card (the
   engine's ``device_order`` count); (b) ``@recurse(depth: 2)`` from the
   8192 seeds, whose second level crosses the default device gate: it
   must launch the gather kernel and stay under the reference's 10^6
   recursion edges; (c) ``shortest`` from a seed to a node two hops away
   with ``numpaths`` 1 and 3, served as the server stands and again with
   the gate at 1, when every expansion must launch the gather; (d)
   ``@groupby`` by ``rank`` and by the uid edge ``e`` with ``count(uid)``,
   at the root (8192 seeds) and under a child (64 seeds).  One line per
   query: p50/p99, the gather's launches, ``device_order_ms`` and the
   engine's routes.  The counts are read right after.
9a. routes — every kernel's launch count is set to 0, then, on the same
   server (caches detached, the chain pinned off, the gate at 1 so that
   every hop goes to the card), from seeds of ``default_rng(109)``: the
   var-block 2-hop count from 8192 seeds, the materialised 2-hop from 64
   and the child ``orderdesc: rank, first: 2`` 2-hop, each forced in turn
   through the engine's classed, inline (``DGRAPH_TPU_RESIDENT=0``) and
   resident routes (the served engine's resident gate and fused hop),
   and, for csr, each with its root ordered by rank under the inline
   route's knobs (a deployment sends csr only the frontier an ordered
   root permutes), the routes alternating request by request, 2
   requests a route: one with ``?ledger=true``, one with
   ``?debug=true``.  Every body must equal the host route's (the debug
   one with both trees' ``_uid_`` keys left out), every hop of both must
   name the forced route (on the csr row: the ordered root's hop csr,
   the ascending levels below it inline), every inline hop must launch
   the slot-map kernel once and every resident hop the gather once.  The
   p50 of each route and query is printed on one line with the card's
   name and power limit.  The
   counts are read right after; then the slot map at the inline route's
   Q = 1 shape (the count's second hop) is held against its plain version
   and timed (its launches count on no path).
9b. cli surface — a graph of its own (2000 uids with a 3-word name each,
   6000 ``f`` edges, seed 113), in the git-ignored ``_smoke/cli``
   (removed at the end): ``python -m dgraph_tpu_torch.cli.server`` booted
   with ``--config`` (a YAML setting its port, directories and no gRPC
   listener), ``--dumpsg``, ``--cpu`` and ``--mem``, loaded by ``python -m
   dgraph_tpu_torch.cli.loader``: ``GET /`` must be the console page, a
   share must round-trip, a query must write one dump, both profiles must
   exist after ``/admin/shutdown``, and ``python -m
   dgraph_tpu_torch.cli.posting_iterator`` must print exactly the lines of
   ``/admin/export``.
10. multi-hop kernels — ``ops.multi_hop`` (one gather launch a hop) on
   the card against the same call on the CPU, exactly: from the 8192
   seeds of phase 11's (a) over the served resident CSR and its uid->row
   table, with and without the visited set, and from a drained frontier
   (uids that own no row).
11. chain — every kernel's launch count is set to 0, then, over HTTP at
   the default chain threshold (the planner prices the chain; a fused
   query's stats must hold its ``chain`` decision), each query served a
   few times and held byte for byte against the host-route engine (the
   cheap ones, (a), (e) and (f), twice a route, the bulky ones once),
   from seeds of their own
   (seed 53): (a) the main path's var-block 2-hop count from 8192 seeds,
   which must take the multi-hop pass (2 levels fused, 2 gather
   launches a request); (b) the materialised 2-hop (a staged full-mode
   chain); (c) the child ``orderdesc: rank, first: 2`` 2-hop (a fused
   order); (d) a 2-hop whose second level carries ``@filter(has(rank)
   AND has(name))`` (a fused keep-set whose AND launches the intersect
   kernel); (e) a var-block ``@recurse(depth: 2)`` count (the fused BFS,
   one gather launch a level; from the largest of 8192, 4096, 2048 and
   1024 seeds whose edge bound the fused BFS admits); (f) a var-block
   3-hop count from 1024 seeds.  (a), (b) and (e) are served again with
   the chain and the fused BFS pinned off.  One line per query: p50/p99
   of each route, ``chain_ms``, ``chain_fused_levels`` and
   ``chain_reject`` of one ``?debug=true`` request, each kernel's
   launches a request.  The counts are read right after.
12. serving plane — phases 4-11 run with both query caches detached
   (the scheduler's result cache and the arenas' hop cache), so that
   their repeats execute; here they are attached again, every kernel's
   launch count is set to 0, and 12 client threads each send 5 requests
   (60 in all) over HTTP to the server at its default knobs (the cohort
   scheduler on): per client a var-block ``@recurse(depth: 2)`` count
   from 8192 seeds (level by level: the fused BFS's bound rejects 8192
   seeds, and level 2 is above the merge gate), join query (a), and
   ``shortest`` k 1 from one source to two nodes two hops away (the
   second hits the hop cache), then a repeat of its own first; seeds
   from ``default_rng(59)``.  Every body must equal a
   host-route engine's, computed before the load.  One round on the
   scheduled server, then one on the serial path (the scheduler
   detached: ``DGRAPH_TPU_SCHED=0``), both caches emptied before each
   round: requests/s, p50/p99, the gather and intersect launches,
   merged hops, coalesced requests, cache hits, the mean cohort
   occupancy and the card's busy share (the union of ``torch.profiler``'s
   device intervals over the round's wall time) a round.  Merged hops
   and both caches' hits must be above 0 and the scheduled rounds must
   launch fewer gathers than the serial ones.  Then the guarantees: a
   1 ms ``X-Dgraph-Timeout`` answers 504; a scheduler built at
   ``DGRAPH_TPU_SCHED_QUEUE_CAP=1``, flooded while a writer holds the
   engine, sheds at least one 429 with ``Retry-After``; and a mutation
   adding edges lands while 8 clients keep asking for shortest paths, after
   which a read cached whole (result cache) and a twin read served from
   the hop cache both show the new edges, byte-identical to the host
   route.  The counts are read right after.
13. mxu join — the tile join tier on a graph of its own, served by a
   second ``DgraphServer`` on cuda (both query caches detached, the k-way
   gate at 1): ``friend: uid @reverse .`` on uids 1..65,535, each uid 64
   targets drawn uniformly (seed 61) from the uids of its own 128-block
   and the two beside it, duplicates and self-loops dropped (about 3.86
   million edges in some 1,534 stored 128×128 blocks: tiles about
   128 MiB, a mask 65,536 lanes).  Every kernel's launch count is set to
   0, then four queries from seeds of ``default_rng(67)``, each served
   twice a route over HTTP with ``?debug=true``, the routes
   alternating request by request — ``DGRAPH_TPU_MXU_JOIN`` 1 (the tile
   route) and 0 (the gather tier: the fused chain for m1 and m2; level by
   level for the triangles, whose ``uid(w)`` filter the chain cannot
   fuse): (m1) a var-block 2-hop count from
   1,024 seeds, (m2) a var-block 3-hop count from 256 seeds, (m3) the
   triangle from 1,024 seeds (``w as ~friend``, then ``friend { t as
   friend @filter(uid(w)) }``) and (m4) the same triangle closed by
   ``uid(w) AND has(friend)`` (its AND launches the intersect kernel).
   Every body must equal a host-route engine's; each route-1 request
   must record exactly one ``mxu`` decision (``chain`` for m1 and m2,
   ``triangle`` for m3 and m4) and ``mxu_join_ms > 0``.  Then a mutation
   adds 64 ``friend`` edges inside stored blocks and deletes 64, under
   ``DGRAPH_TPU_IVM_REPAIR=force`` (the repair gate pinned, so that the
   repair path runs whatever the planner's rates price); (m1)
   again must equal the host route, with the tiles repaired in place
   (``IVM_REPAIRS{tile,repaired}`` up by one, no tile build).  A route-1
   request's gather launches must equal its per-level resident hops
   (the triangle's ``w as ~friend`` goes to the card where the planner
   prices it so; the tile chain launches none).  The
   counts are read right after.  Then, launching none of the kernels:
   ``expand_mask_batch`` and ``triangle_mask_batch`` on the card against
   the same calls on the CPU at bench_ops.py's shape (512 nodes, 32,768
   edges, 48 roots, B 64), and ``run_mask_chain`` at (m1)'s shape timed
   (``mask_chain_timing``: CUDA events per call, 30 back-to-back calls,
   device ms of every op by name) beside its bytes bound (the stored
   tiles read once a level and the masks, at 3.35 TB/s).
14. dense — the same generated edges as a dense CSR arena on cuda in the
   skey-grouped inline-head layout; 600 query frontiers of 4096 drawn
   seeds (bench.py's draw, seed 3) and the pipeline's capacity plan.
15. slotmap kernels — the slot-map kernel against its plain version on
   the card, exactly: the pipeline's real (cs, cd) at both hops of one
   200-query chunk, random grouped batches, totals at block boundaries,
   zero-cd rows between productive ones, truncation at capc, an
   all-zero batch, and the tiling's edges (``tests/torch_cases.py``):
   pcap of three shared-memory tiles plus one row, one row owning more
   slots than capc, Q 1, Q 20,000 at pcap 64, totals and capc at tile
   boundaries.
16. batched 2-hop — every kernel's launch count is set to 0, then the
   device-dedup batched 2-hop (``bench2hop.run_device_dedup``) runs the
   600 queries in chunks of 200 (a warm pass, then best of 4); every
   query's edge count and checksum and the last query's set must equal
   numpy's (``np_two_hop``), and the slot-map kernel must have launched
   twice per chunk in every pass plus twice for the last set.  Then the
   host-dedup arm (``bench2hop.run_host_dedup``, bench.py's
   ``_run_host_dedup``): each hop one batched plan of the arena's
   ``ClassedExpander`` over sub-batches of 50, ``np.unique`` between the
   hops, capacities planned once with ``bucket_fine``, one timed
   pass; every query's edge count and checksum and the last set must
   equal numpy's, and it launches no slot map.  The counts are read right
   after.  Edges/s of both arms, the numpy baseline and the caps are
   printed.
17. durability — every kernel's launch count is set to 0, then, all
   in a git-ignored ``_smoke/`` removed at the end: (a) every eighth
   generated edge (a stride sample, as the cluster trio's) journaled as
   one bulk record by a ``DgraphServer`` on cuda over
   a ``DurableStore(sync_writes=True)`` (its snapshotter held off below
   1 GB of log: a snapshot is one record per edge, so this directory is
   only journaled and recovered); over HTTP its var-block 2-hop
   count from 8192 seeds (``default_rng(73)``) must launch the gather and
   equal numpy's 2-hop; one acknowledged mutation adds 256 edges from 64
   seeds; the count again (numpy's with the new edges) and the
   materialised 2-hop from the 64 seeds (every node's children equal to
   numpy's, the new edges present) are recorded; the server is abandoned
   without closing its store.  (b) ``python -m
   dgraph_tpu_torch.cli.server --p d1 --arena_budget_mb 8192
   --snapshot_wal_mb 1024`` (query caches off, so that repeats execute)
   must replay its 4 WAL records and answer both bodies byte for byte,
   the count on the card (``?debug=true``); printed: the recovery
   line, ``dgraph_recovery_records`` / ``_seconds``, the time to recover
   (from the spawn to the first correct count body) and the count's
   p50 / p99 over 3 requests.  (c) a second CLI server on d2 with
   ``--sync --snapshot_wal_records 100`` is loaded by ``python -m
   dgraph_tpu_torch.cli.loader`` (batch 1000, ``-c 4``) from a gzipped
   file of 200,000 N-Quads (``default_rng(71)``: 150,000 ``f`` edges
   drawn from the generated edges of sources 1..50,000 and 50,000 3-word
   ``name`` literals, shuffled) under ``name: string @index(term) .`` /
   ``f: uid .``: the native bulk path must take every quad
   (``dgraph_bulk_set_quads_total``), the snapshotter must fire under
   the load; a snapshot is then taken on demand and timed (records/s),
   16 edges are written after it, and a materialised 2-hop over ``f``
   from 64 seeds and an ``allofterms`` count (each against numpy) and
   ``/admin/export``'s line count are recorded before a SIGKILL.
   (d) d2 booted again must give the same bodies and export count from
   its snapshot and WAL tail; booted once more with
   ``DGRAPH_TPU_FAILPOINTS=wal.append=error(n=1)``, a mutation must
   answer 503 with ``Retry-After`` while a read answers 200 as before,
   and once the probe re-arms, a mutation answers 200 and shows up in
   the next read.  The counts are read right after.
18. cluster — every kernel's launch count is set to 0, then, every
   server in this process on the card, each with its own engine and
   arenas, raft logs in the git-ignored ``_smoke/cluster`` (removed at
   the end), under the group rules ``1: e`` / ``2: name`` / ``default:
   fp % 2 + 1``: (t) three servers each serving groups 0, 1 and 2 (3
   replicas of every predicate), their device and k-way gates at 1: the
   schema, then every 64th generated edge (a stride sample: both the
   uniform and the pareto-skewed halves of the targets) in
   source-ascending ``BULKEDGES`` records of 262,144 edges and phase 5's
   names on uids 1..125,000 in ``BULKVALS`` records of 131,072, one
   proposal each,
   submitted through a follower of its group (forwarded to the leader);
   seconds from the first proposal to the last applied on every
   replica, per group.  With both query caches detached, the three
   servers are asked the var-block 2-hop count from phase 4's 8192
   seeds together (each one's seconds to it: the read snapshot, the
   arena seed, the first gather), then each in turn that count 2
   times, the materialised 2-hop from those seeds once and join (a) 2
   times, every body equal to a host-route engine over a single-node
   store of the same data, each server's requests launching the gather
   and (a)'s the intersect.  Then 64 added and 64 deleted ``e`` edges
   written through the third server: the group-1 leader must answer the
   new count at once, the followers within a bounded wait.  Then the
   group-1 leader's server is stopped: a new leader must be elected, a
   64-edge write acknowledged, both survivors answer the new count.
   (p) two servers, server 1 placing groups 0 and 1 (``e``: the first
   1/64 of the generated edges), server 2 groups 0 and 2 (``name`` on
   uids 1..125,000): a materialised 2-hop with a ``name`` child from
   the 8192 seeds, sent to server 2 with its gate at 1, pulls ``e`` from
   server 1 through ``/pred-snapshot``, must equal the host route and
   launch the gather on server 2; its first fetch's seconds and bytes;
   then the same read once more with a sampled ``Traceparent`` (the
   remote snapshot's TTL passed, so it is re-validated with server 1):
   spans on both servers under one trace id, server 1's
   ``peer.pred-snapshot`` among them.
   Each line carries the card's name and power limit; launches by node.
   The counts are read right after.
18a. planner — a second server over the main path's store, booted with
   ``DGRAPH_TPU_CALIBRATE=1``: the planner measures its rates on the card
   (``utils/calibrate.py``: a dispatch round trip, the gather kernel,
   ``expand_csr``, numpy, ``np.intersect1d``, the intersect kernel, the
   tile product) and prints them beside the card's name and power
   limit; it serves through the main server's arenas (built once).  The
   launch counts are zeroed after the boot.  Served, with
   both caches detached: phase 4's 2-hop count (per level, the planner
   on and off request by request), join (a) and (b) and chain (a), 2
   timed requests each, every body equal to the host route; its
   ``/debug/planner`` must have recorded ``expand`` decisions that took
   the resident gather and ``kway`` decisions that took the intersect
   kernel (each query's own stats too, and chain (a)'s ``chain``
   decision), and the mispredict rate is printed.  Then 16 client
   threads send 4 counts of 1024 fresh seeds each at once: the cohort
   controller must move ``max_batch`` or the flush deadline inside its
   bounds.  The counts are read right after.  Every earlier phase runs
   with the planner at its default (on, priors: no calibration file in
   a fresh checkout); a check that once asserted the static gate
   asserts the recorded decision now.
19. report — one pass of the 600 queries under ``torch.profiler``
   (the stage split of a chunk is the program's own spans, read by the
   benchmark's ``*_device_ms`` metrics): the card's busy time (the union of its
   kernel and copy intervals) over the pass's host wall time, and device
   ms by kernel name; one pass with CUDA events around each chunk; each
   kernel's wrapper at its path's shapes (the gather at the large
   2-hop's second hop, at a 10^6-edge row among light rows and at a
   frontier of B 2^20; the slot-map at both hops (and, after phase 9a's
   counts, at the inline route's Q = 1 shape); the intersect at the
   served matrices and bench_ops.py's K 2/4/8 at L 8192) timed three
   ways: CUDA events around each call, events around 30 back-to-back
   calls, and the device time of every device op in the profiler window
   of a call (split by name; the gather's window must hold all 30 of its
   launches, else it is recorded again with host activity too, and after
   that its device time is null); beside them the plain version, the bytes
   bound and, for the intersect, the port's ``intersect_many`` tree; the
   order-by at the query surface's two sorted shapes (the two torch ops
   on the card, the engine's device branch and its numpy branch); a
   summary line (the paths' numbers and the run's seconds, in all and by
   phase); then per kernel its launches (from its own paths' runs, split
   by path), error, time, plain-version time and bound (one ``kernels``
   JSON line), the nvidia-smi line, and last the
   ``{"ok": true, "device": ...}`` line.
20. mesh — the mesh serving plane on virtual chips of the card (runs
   after every phase that reads the main server's arenas: its write
   reaches only the server that refreshes first).  First the crossover
   model's constants (``parallel/crossover.py``'s ``measure``: the
   per-index gather at three table sizes around the 50 MB L2 and in HBM,
   the on-card copy rate, a one-uid dispatch at 4 virtual chips), the
   ``mesh_calibration`` line.  Then a second server over the main store
   with ``mesh=make_mesh(devices=[cuda:0] * 4)``, caches detached, on the
   per-level route; the seconds to build ``e``'s arena and to shard it.
   (a) the count from 8192 seeds (``default_rng(127)``), the
   materialised 2-hop from 64 seeds, join (a) and chain (a) (per level),
   each body equal to the host route, every ``e`` hop on ``route: mesh``
   with ``mesh_chips`` 4 in its ledger, no gather launch, and join (a)'s
   intersect launched.  (b) one mesh multi-hop segment of chain (a)'s
   shape under ``torch.cuda.set_sync_debug_mode("error")``: nothing
   synchronizes, its count is chain (a)'s.  (e) the count's p50 at 4
   virtual chips, at ``DGRAPH_TPU_MESH=force`` (a 1-wide mesh) and
   unsharded (the main server), printed, not compared.  (c) under
   ``device.mesh=error(p=1,n=1,chip=3)`` the next count is identical at
   width 3, the epoch one past the plan's version and ``degraded.mesh``
   set; after the chip guard's cooldown the staged rejoin brings width 4
   back; a segmented chain (a) (one hop a segment) whose epoch another
   query's chip loss flips between its segments resumes, equal to the
   unflipped run.  (d) a 64-edge write, then the count equals the host
   route with the new edges.  The intersect's counts are read right
   after.

Exits non-zero without a CUDA GPU, or when the package is not beside it.

``python3 chip_smoke.py --contracts-only`` runs phases 1 and 1b alone.
``python3 chip_smoke.py --durability-only`` runs phase 1, the graph's
generation (no server) and phase 17 (about three minutes).
``python3 chip_smoke.py --planner-only`` runs phases 1 and 2, the names
of phase 5 and phase 18a.
``python3 chip_smoke.py --cluster-only`` runs phase 1, the graph's
generation and phase 18.
``python3 chip_smoke.py --trace-only`` runs phases 1 and 2, the names of
phase 5 (join (a) needs them) and phase 7a.
``python3 chip_smoke.py --guard-only`` runs phases 1 and 2 and phase 7b;
``python3 chip_smoke.py --subs-only`` phases 1 and 2, the names of phase 5
and phase 7d; ``--transports-only`` phases 1 and 2, the names of phase 5
and phase 7c, with 20 requests of each query on each transport.
``python3 chip_smoke.py --routes-only`` runs phases 1 and 2, the ranks
of phase 8, phases 9a and 9b, the dense arena of phase 14 and phase 16
(about five minutes).
``python3 chip_smoke.py --mesh-only`` runs phases 1 and 2, the names of
phase 5 and phase 20.
``python3 chip_smoke.py --serving-only`` runs phases 1-3, the names of
phase 5 and phase 12 alone (the serving plane on the caches' first
use).  ``python3 chip_smoke.py --mxu-only`` runs phase 1 and phase 13
alone (the tile join tier on its own graph, about a minute).  ``python3 chip_smoke.py --gather-only`` runs phases 1-3 and the
gather's timing line alone.  It goes through wrapper calls only, so an older tree
with this script and ``tests/torch_cases.py`` copied in runs it too: that
is how two trees' gathers are compared in one call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_NODES, N_EDGES, GRAPH_SEED = 2_000_000, 21_000_000, 7
# 8192 seeds: on this graph a 2-hop from 4096 seeds reaches about 210,000
# second-level edges, below the static device gate (262144, the gate with
# the planner off); 8192 seeds about 410,000, so the served query crosses
# it (the config line prints both counts)
# (2 repeats: 20 before the cluster phase, 10 before the flight
# recorder's, 6 before the planner's, 4 before the kernel contracts'; the
# run must still fit its time limit)
SMALL_SEEDS, LARGE_SEEDS, REPEATS = 64, 8192, 2
# the batched 2-hop: bench.py's seeds a query (BENCH_SEEDS), 600 of its
# 1000 queries (BENCH_ITERS; 600 since a whole run on a slow host took
# 1210 s of its 1200, the numpy baseline's one pass 70 s of it), and its
# chunk of queries per batched program
BATCH_SEEDS, BATCH_QUERIES, CHUNK_Q = 4096, 600, 200
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
# the join path: names on uids 1..N_NAMED, NAME_WORDS words each drawn
# from VOCAB; the allofterms query asks for the first NAME_WORDS words
N_NAMED, NAME_WORDS, NAME_SEED, JOIN_SEED = 1_000_000, 3, 23, 29
VOCAB = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf",
         "hotel", "india", "juliett", "kilo", "lima", "mike", "november",
         "oscar", "papa"]

# the query surface: ranks on uids 1..N_RANKED drawn from [0, RANK_RANGE)
# (ties); each served query repeated SURFACE_REPEATS times (the @recurse,
# whose body holds some 470,000 nodes, RECURSE_REPEATS times)
N_RANKED, RANK_RANGE, RANK_SEED, SURFACE_SEED = 1_000_000, 1 << 16, 43, 47
SURFACE_REPEATS, RECURSE_REPEATS = 1, 1  # (5, 3 before the cluster phase; 3, 2 before the flight recorder; 2, 1 before the kernel contracts)
RECURSE_MAX_EDGES = 1_000_000  # the reference's recursion cap (query/recurse.py)

# the chain phase: its own seeds; requests a route of each cheap query
# ((a), (e), (f)) and of each query with a body of megabytes ((b)-(d));
# the fewest requests any phase reports a p99 over (below it the p99
# is null); the threshold that pins the chain off
CHAIN_SEED, PINNED_OFF = 53, 1 << 62
# (2 cheap requests a route and 1 bulky one: 24 and 3 before the
# cluster phase, 6 and 3 before the flight recorder's, 4 and 2 before
# the planner's, 3 and 1 before the transports', 2 and 1 before the
# kernel contracts'; the run must still fit its time limit; p99 needs
# P99_MIN requests)
CHAIN_REPEATS, CHAIN_REPEATS_BULKY, P99_MIN = 1, 1, 20

# the serving plane: client threads (12, not 16: with the transports'
# phase the run took 1099.6 s of its 1200; at 8 the scheduled round
# launched 45 gathers against the serial round's 46, too thin a margin
# for the check that it launches fewer), requests each (the last
# repeats the client's first; 5, not 8: with the cluster phase the run
# must still fit its time limit), shortest paths each, rounds of each
# path (scheduled, serial), and the seed of the mix's draws
SERVE_CLIENTS, SERVE_PER_CLIENT, SERVE_SHORTEST = 12, 5, 2
SERVE_ROUNDS, SERVE_SEED = 1, 59

# the tile join tier: its graph (uids, targets a uid, seed), the seeds'
# seed, requests a route, and the draws of its ops check (bench_ops.py's
# triangle shape: nodes, edges, roots a set, sets)
MXU_UIDS, MXU_FANOUT, MXU_GRAPH_SEED, MXU_SEED = 65_535, 64, 61, 67
MXU_REPEATS, MXU_DELTA = 2, 64  # (12 a route before the cluster phase, 6 before the flight recorder, 4 before the kernel contracts)
TRI_NODES, TRI_EDGES, TRI_ROOTS, TRI_B = 512, 32_768, 48, 64

# the durability phase: its seeds' seed; the write of (a), DUR_EDGES
# edges from DUR_SEEDS seeds; the recovered CLI server's arena budget;
# the loaded server's file (edges drawn from the generated edges of
# sources 1..LOAD_SOURCES, names on uids 1..LOAD_NAMES, seed LOAD_SEED),
# its snapshot threshold in WAL records (the native path journals about
# two records a batch of 1000 quads) and the sources of its tail write
DUR_SEED, DUR_SEEDS, DUR_EDGES, DUR_ARENA_MB = 73, 64, 256, 8192
# the recovered d1's timed counts (3, not 10 or 5: the run's time limit)
DUR_REPEATS = 3
# d1's cut: every D1_EDGE_SHARE-th generated edge, a stride sample that
# keeps the targets' skew (2, not the whole graph, since a whole run on a
# slow host took 1282 s of its 1200 with the kernel-contract phase: d1's
# journal, recovery and first counts were 155 of durability's 247 s;
# 8 since a second run on a slow host still took 1210 s)
D1_EDGE_SHARE = 8
# d1's snapshot threshold, above its 336 MB log: a snapshot is written
# one record per edge, and the default 64 MB would fold the 21M edges
# into 16.2M records (a minute and a half to replay on the card's host)
D1_SNAPSHOT_WAL_MB = 1024
LOAD_SEED, LOAD_EDGES, LOAD_NAMES, LOAD_SOURCES = 71, 150_000, 50_000, 50_000
LOAD_SNAPSHOT_RECORDS, LOAD_TAIL = 100, 16

# the cluster phase: the group rules of both deployments (the upstream
# documented ``N: pred`` / ``default: fp % N + k`` form); the pair's cut
# (1/PAIR_EDGE_SHARE of the generated edges, names on uids
# 1..PAIR_NAMED: one interpreter holds both servers, and the run has a
# time limit); the write's seed and size; the requests of each timed
# query; every bounded wait (and the proposal patience), seconds
CLUSTER_CONF = "1: e\n2: name\ndefault: fp % 2 + 1"
# (1/64, not 1/8: a read of another group's predicate pulls it through
# /pred-snapshot within the read plane's 10 s budget, three attempts of
# 3.3 s, and the owner encodes one Python record an edge, so at 1/8 no
# attempt finished and the read answered 503)
PAIR_EDGE_SHARE, PAIR_NAMED = 64, 125_000
# the trio's cut: every TRIO_EDGE_SHARE-th generated edge, a stride
# sample that keeps both halves of the targets' distribution (uniform and
# pareto-skewed; gen_edges puts them in the first and the second half),
# and names on uids 1..TRIO_NAMED (whole before the flight recorder's phase:
# each replica apply makes the next read copy the predicate and rebuild
# its arena, three at once in one interpreter, and at full size the
# phase took 346-445 s of a run that came within 4 s of its 1200 s
# limit; every fourth edge until the transports' phase, which took the
# whole run past 1050 s); at this size the count's second hop is below
# the default device gate, so the trio's servers run both gates at 1, as
# the pair's reader does; every 16th edge and names on 125,000 uids, not
# every 8th and 250,000, since a whole run on a slow host took 1208.7 s
# of its 1200 with the mesh phase; every 64th since two took 1282 and
# 1210 s with the kernel-contract phase
TRIO_EDGE_SHARE, TRIO_NAMED = 64, 125_000
# the trio's load in per-range records (uids ascending, as the loader's
# batches are) of at most this many edges / names, one proposal each:
# a raft frame crosses the transport's 2 s send window, and the leader
# re-sends every unacknowledged entry each heartbeat, so one 336 MB
# entry neither crosses it nor stays bounded in memory
CLUSTER_RECORD_EDGES, CLUSTER_RECORD_NAMES = 1 << 18, 1 << 17
# the raft tick, ms (an election timeout of 10-20 ticks): the library's
# 15 ms default makes a 150-300 ms election timeout, which every
# record's apply on the leader's loop outlasts, so the group changed
# leaders through the whole load; 100 ms (a 1-2 s timeout, etcd's
# default scale) outlasts an apply
CLUSTER_TICK_MS = 100
# (2 timed requests a query and server: 10 before the flight recorder,
# 6 before the planner, 4 before the routes' and CLI surface's phases)
CLUSTER_SEED, CLUSTER_DELTA, CLUSTER_REPEATS, CLUSTER_WAIT_S = 79, 64, 2, 600

# the flight recorder: its seed (seeds, trace ids), traced requests of
# each query, unsampled requests, the hop delay that holds the cancelled
# query, and the timed requests at each ratio (4: 10 before the
# planner's phase, 6 before the kernel contracts')
FLIGHT_SEED, FLIGHT_TRACED, FLIGHT_UNSAMPLED = 83, 3, 10
FLIGHT_HOLD_MS, FLIGHT_COST_REQUESTS = 500, 4

# the planner phase: timed requests of each query (the count's with the
# planner on and off in turn), and the burst that moves the cohort
# controller: client threads, requests each, seeds a request, seed
PLANNER_REPEATS = 2  # (3 before the kernel contracts' phase)
PLANNER_CLIENTS, PLANNER_BURST, PLANNER_BURST_SEEDS, PLANNER_SEED = 16, 4, 1024, 89

# the device fault domain: its seeds' seed, requests of the count with the
# guard on and off each, the two throwaway arenas the OOM checks evict
# (keys no predicate has) and their edges, the watchdog and cooldown of
# the hang check, the wedge's length, the re-admission probes made to
# fail first (8: the domain stays sick about 9 s, past the wedge's own
# wake-up and launch, so the sick requests' launches are counted alone),
# the concurrent clients while sick, the re-admission wait (the
# overhead's requests 2, not 4: the run's time limit)
GUARD_SEED, GUARD_OVERHEAD_REPEATS = 91, 2
GUARD_PADS, GUARD_PAD_EDGES = ("_guard_pad_1", "_guard_pad_2"), 2_000_000
GUARD_HANG_MS, GUARD_WEDGE_MS, GUARD_COOLDOWN_S = 500, 3000, 1.0
GUARD_PROBE_FAILS, GUARD_CLIENTS, GUARD_READMIT_S = 8, 16, 10.0
# filler blocks at most (each the count's gather buffer, about 4.7 MB)
GUARD_FILLERS = 4096

# live queries: the seeds' seed, subscriptions over ``e`` and over
# ``name``, seeds each ``e`` subscription counts from, the ``e`` writes
# and their edges, the quiet wait that holds the others silent
SUBS_SEED, SUBS_E, SUBS_NAME, SUBS_SEEDS = 97, 4, 4, 1024
SUBS_WRITES, SUBS_DELTA, SUBS_QUIET_S = 3, 64, 1.0  # (writes: 5 before the kernel contracts)

# the transports: the count's seeds' seed, requests of each query on
# each transport in a whole run (the bodies and launches; 3, then 2, took
# the whole run past 1050 s) and under --transports-only (the p50 and
# p99 of each transport), fresh connections the handshake is timed over, the
# uids AssignUids leases, the Subscribe count's seeds, the edges of each
# write; the TLS cluster's cut (every TLS_TRIO_SHARE-th generated edge,
# the pair's share of phase cluster) and its group placement: ``e``
# (group 1) on all three servers, ``name`` (group 2) on server 3 alone,
# so that a read of names on server 1 crosses to server 3
TRANSPORT_SEED, TRANSPORT_REPEATS, TRANSPORT_TIMED, TRANSPORT_CONNECTS = 103, 1, 20, 20
TRANSPORT_LEASE, TRANSPORT_SUB_SEEDS, TRANSPORT_DELTA = 1000, 1024, 64
TLS_TRIO_SHARE, TLS_TRIO_GROUPS = 64, "1=0,1;2=0,1;3=0,1,2"

# the engine's routes: the seeds' seed, and the routes, each as the
# served engine's knobs that steer it (the resident gate, the fused
# hop); the classed route needs DGRAPH_TPU_FUSED_HOP=force on a CUDA
# device, the inline route is the card's default with
# DGRAPH_TPU_RESIDENT=0, and csr takes, under the inline route's knobs,
# the frontier an ordered root permutes (the csr row's queries order
# their root by rank)
ROUTES_SEED = 109
ROUTE_PINS = {
    "classed": ("0", "force"),
    "inline": ("0", "1"),
    "csr": ("0", "0"),
    "resident": ("1", "1"),
}
# the batched 2-hop's host-dedup arm: timed passes (no warm pass; 1, not
# 2: a whole run on a slow host took 1208.7 s of its 1200 with the mesh
# phase)
HOST_DEDUP_PASSES = 1
# the CLI surface: its graph (uids with a name each, edges, seed), loaded
# from an RDF file of its own by the loader into a CLI server of its own
# (5000 uids and 20,000 edges took the phase to 35 s on the card's host)
CLI_UIDS, CLI_EDGES, CLI_SEED = 2000, 6000, 113

# kernels: (name, wrapper module, TPU kernel it replaces, paths that run it)
KERNELS = [
    ("gather_packed", "dgraph_tpu_torch.ops.gather",
     "dgraph_tpu/ops/pallas_gather.py:48",
     ("main_path", "flight_recorder", "device_guard", "subscriptions",
      "transports", "query_surface", "routes", "chain", "serving_plane",
      "mxu_join", "durability", "cluster", "planner")),
    ("slotmap", "dgraph_tpu_torch.ops.slotmap",
     "dgraph_tpu/ops/pallas_slotmap.py:46", ("routes", "batched_2hop")),
    ("intersect", "dgraph_tpu_torch.ops.kway",
     "dgraph_tpu/ops/pallas_intersect.py:35",
     ("join_path", "flight_recorder", "device_guard", "subscriptions",
      "transports", "chain", "serving_plane", "mxu_join", "cluster", "planner",
      "mesh")),
]

# the mesh phase: virtual chips of the card, the seeds' seed, timed
# requests of the count at each width (2, not 5 or 3: the run's time
# limit), the write's edges, the chip guards' cooldown (the staged
# rejoin's wait), the rejoin's bound
MESH_WIDTH, MESH_SEED, MESH_REPEATS, MESH_DELTA = 4, 127, 2, 64
MESH_COOLDOWN_S, MESH_REJOIN_S = 1.0, 120.0


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


def post(addr: str, text: str, params: str = ""):
    """POST /query; returns (status, body bytes, seconds)."""
    status, raw, _headers, secs = post_any(addr, text, params=params)
    return status, raw, secs


def post_any(addr: str, text: str, headers=None, params: str = "", context=None):
    """POST /query (an error status does not raise); returns (status,
    body bytes, response headers, seconds).  ``context`` is the TLS
    client context of an ``https://`` address."""
    import urllib.error

    req = urllib.request.Request(addr + "/query" + params, data=text.encode(),
                                 method="POST", headers=headers or {})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=900, context=context) as r:
            return r.status, r.read(), dict(r.headers), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers), time.perf_counter() - t0


def strip_latency(raw: bytes) -> str:
    d = json.loads(raw)
    d.pop("server_latency", None)
    d.pop("extensions", None)
    return json.dumps(d)


def uid_list(uids) -> str:
    return ", ".join("0x%x" % int(u) for u in uids)


def two_hop(seeds) -> str:
    return "{ q(func: uid(%s)) { uid e { uid e { uid } } } }" % uid_list(seeds)


def two_hop_count(seeds) -> str:
    # the engine's root count is the bare count()
    return ("{ var(func: uid(%s)) { e { f as e } } q(func: uid(f)) { count() } }"
            % uid_list(seeds))


_HOST_REF: dict = {}


def host_engine(store):
    """An engine over the same store pinned to the host route, the fused
    chain, the fused @recurse and the hop cache off: the reference the
    served bodies must equal byte for byte.  One per store version: a
    store that took no write since the last call gets the same engine
    back (its host arenas, whose first build takes seconds, are what a
    fresh engine would build)."""
    from dgraph_tpu_torch.query import QueryEngine

    version = getattr(store, "version", None)
    got = _HOST_REF.get(id(store))
    if version is not None and got is not None and got[0] == version \
            and got[1].store is store:
        return got[1]
    eng = QueryEngine(store, device="cpu")
    eng.expand_device_min = 1 << 62
    eng.arenas.kway_device_min = 1 << 62
    eng.arenas.hop_cache = None
    eng.chain_threshold = PINNED_OFF
    eng.expander.fused_hop = "0"
    _HOST_REF[id(store)] = (version, eng)
    return eng


def host_engine_advanced(store, eng, adds) -> None:
    """``eng`` (``host_engine(store)`` before the write of the edges
    ``adds`` on ``e``, whose delta the served arenas took first) takes
    exactly those edges and stays the reference of the store's new
    version: the next ``host_engine(store)`` builds no host arenas."""
    eng.arenas.data("e").apply_delta(np.array(adds, np.int64).reshape(-1, 2),
                                     np.zeros((0, 2), np.int64))
    _HOST_REF[id(store)] = (store.version, eng)


@contextlib.contextmanager
def per_level(engine):
    """The served engine with its fused chain and fused @recurse pinned
    off: every level on the per-level route."""
    thr, hop = engine.chain_threshold, engine.expander.fused_hop
    engine.chain_threshold, engine.expander.fused_hop = PINNED_OFF, "0"
    try:
        yield
    finally:
        engine.chain_threshold, engine.expander.fused_hop = thr, hop


def check_priced(srv, chain: bool = False) -> None:
    """The served engine runs the priced planner: on, with the hop and
    k-way knobs at their defaults (a pinned knob keeps the static
    compare), and with ``chain`` the chain threshold too (``per_level``
    pins it off)."""
    from dgraph_tpu_torch.query import planner
    from dgraph_tpu_torch.utils import planconfig

    eng = srv.engine
    check(planner.enabled()
          and eng.expand_device_min == planconfig.EXPAND_DEVICE_MIN_DEFAULT
          and eng.arenas.kway_device_min == planconfig.KWAY_DEVICE_MIN_DEFAULT
          and (not chain
               or eng.chain_threshold == planconfig.CHAIN_THRESHOLD_DEFAULT),
          "the server must run the priced planner at its default knobs")


def check_decided(eng_stats: dict, kind: str, route: str, what: str) -> None:
    """A request's engine stats hold a priced decision of ``kind`` that
    took ``route`` (query/planner.py records them under "planner")."""
    decs = eng_stats.get("planner", [])
    check(any(d["kind"] == kind and d["route"] == route for d in decs),
          f"{what}: no {kind} decision took {route}: {decs}")


def cuda_ms(fn, iters: int = 30, warm: int = 3) -> float:
    """Median device time of ``fn`` in ms, by CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in evs]))


def kernel_times(fn, iters: int = 30, kernel: str = "") -> dict:
    """A wrapper call's time three ways, ms: ``ms``, the median of CUDA
    events around each call (for a call of a few µs mostly the host's
    enqueue while the card waits); ``b2b_ms``, events around ``iters``
    back-to-back calls, over ``iters``; ``device_ms``, the device time per
    call of every device op (kernel, memset, copy) in the profiler window
    of the calls (None if it records none), with its split by name, so
    that a design that does its work in several ops and one that does it
    in one are timed alike.

    ``kernel`` names the timed kernel's function: then the window must
    hold ``iters`` launches of it (``device_window_launches``, one count
    a window).  A CUDA-only window can lose device events (the profiler
    keeps only part of a run of calls at times), so a short window is
    retried with host activity recorded too, and after that
    ``device_ms`` is None: a partial window is never averaged."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {"ms": cuda_ms(fn, iters)}
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    out["b2b_ms"] = a.elapsed_time(b) / iters
    by_name: dict = {}
    windows = []
    tries = ([[ProfilerActivity.CUDA]] * 2 if not kernel else
             [[ProfilerActivity.CUDA]] + [[ProfilerActivity.CPU, ProfilerActivity.CUDA]] * 2)
    for acts in tries:  # the profiler has returned no device events at times
        by_name = {}
        with profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        n = 0
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                by_name[ev.name] = by_name.get(ev.name, 0.0) + (
                    ev.time_range.end - ev.time_range.start) / 1e3 / iters
                n += kernel != "" and kernel in ev.name
        if kernel:
            windows.append({"activities": [str(x).rsplit(".", 1)[-1] for x in acts],
                            "launches": n})
            if n >= iters:
                break
            by_name = {}
        elif by_name:
            break
    if kernel:
        out["device_window_launches"] = windows
    out["device_ms"] = sum(by_name.values()) if by_name else None
    out["device_ms_by_kernel"] = by_name
    return out


# -- phase 1 ----------------------------------------------------------------


def phase_build() -> dict:
    import torch

    from dgraph_tpu_torch.ops import _build

    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    _build.build(sources)
    secs = time.perf_counter() - t0
    ptxas = {
        n: [ln.strip() for ln in log_.splitlines()
            if "registers" in ln or "spill" in ln]
        for n, log_ in _build.build_logs.items()
    }
    smi = nvidia_smi()
    log({"phase": "build", "sources": sources, "seconds": round(secs, 3),
         "ptxas": ptxas, "device": torch.cuda.get_device_name(0),
         "nvidia_smi": smi})
    return {"nvidia_smi": smi}


# -- phase 1b ---------------------------------------------------------------


def _cli_counts(out: str) -> dict:
    """The analysis CLI's verdict lines as counts (None where a line is
    missing: the pass did not run to its end)."""
    import re

    def count(name: str):
        if f"{name}: clean" in out:
            return 0
        m = re.search(rf"{name}: (\d+) finding", out)
        return int(m.group(1)) if m else None

    m = re.search(r"lock-order: cycle-free \((\d+) lock classes, (\d+) edges\)", out)
    return {
        "graftlint": count("graftlint"),
        "thread_escape": count("thread-escape"),
        "lock_problems": len([ln for ln in out.splitlines()
                              if ln.startswith(("lock-order cycle", "self-nesting"))]),
        "lock_classes": int(m.group(1)) if m else None,
        "lock_edges": int(m.group(2)) if m else None,
    }


def phase_kernel_contracts(card: str) -> dict:
    """The contract registry on the card, and the analysis CLI's two
    passes over the tree as subprocesses beside it."""
    from dgraph_tpu_torch.analysis import programs

    t0 = time.perf_counter()
    procs = {
        name: subprocess.Popen(
            [sys.executable, "-m", "dgraph_tpu_torch.analysis", *args],
            cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for name, args in (("lint", []), ("races", ["--races"]))
    }
    try:
        rows = programs.check_all("cuda")
        contracts_s = time.perf_counter() - t0
    finally:
        outs = {n: p.communicate(timeout=300) for n, p in procs.items()}
    summary = programs.summarize(rows)
    for name, c in summary.items():
        log({"phase": "kernel_contracts", "kernel": name, **c,
             "default_stream_busy": all(r["default_busy"] is not False
                                        for r in rows if r["kernel"] == name),
             "card": card})
        check(c["launches_per_call"] == 1, f"{name}: {c['launches_per_call']} "
              "launches a call")
        check(c["syncs"] == 0, f"{name}: {c['syncs']} host syncs")
        check(c["stream"] == "caller", f"{name}: launched on {c['stream']}")
        check(c["max_abs_err"] == 0, f"{name}: differs from its plain version")
    check(set(summary) == {"gather_fused", "slotmap_tiles", "intersect_tiles"},
          f"contracts checked: {sorted(summary)}")
    cli = _cli_counts(outs["lint"][0] + outs["races"][0])
    cli["exit_codes"] = {n: p.returncode for n, p in procs.items()}
    secs = time.perf_counter() - t0
    log({"phase": "kernel_contracts", "analysis_cli": cli,
         "instances": len(rows), "seconds": round(secs, 3),
         "contracts_seconds": round(contracts_s, 3)})
    check(cli["graftlint"] == 0 and cli["thread_escape"] == 0
          and cli["lock_problems"] == 0 and cli["lock_classes"],
          f"analysis CLI over the tree: {cli}\n{outs['lint'][0]}{outs['races'][0]}")
    check(cli["exit_codes"] == {"lint": 0, "races": 0}, f"analysis CLI: {cli}")
    return {"summary": summary, "analysis_cli": cli, "seconds": secs}


# -- phase 2 ----------------------------------------------------------------


def phase_graph(device, n_nodes: int, n_edges: int):
    from dgraph_tpu_torch.bench2hop import gen_edges
    from dgraph_tpu_torch.models import PostingStore
    from dgraph_tpu_torch.serve.server import DgraphServer

    t0 = time.perf_counter()
    src, dst = gen_edges(n_nodes, n_edges)
    store = PostingStore()
    store.apply_schema("e: uid .")
    store.bulk_set_uid_edges("e", src, dst)
    t1 = time.perf_counter()
    srv = DgraphServer(store, device=device)
    srv.start()
    arena = srv.engine.arenas.data("e")
    arena.resident()
    t2 = time.perf_counter()
    # second-level fan-out of a 2-hop against the default device gate
    fanout = {
        k: second_hop_rows(arena, np.unique(np.random.default_rng(
            GRAPH_SEED).integers(1, n_nodes + 1, size=k)))[2]
        for k in (4096, LARGE_SEEDS)
    }
    log({"phase": "config", "nodes": n_nodes, "edges_generated": n_edges,
         "second_hop_edges_by_seeds": fanout,
         "edges_stored": arena.n_edges, "source_rows": arena.n_rows,
         "graph_seed": GRAPH_SEED, "predicate": "e",
         "load_s": round(t1 - t0, 3), "arena_build_s": round(t2 - t1, 3),
         "server": srv.addr, "device": str(srv.engine.device),
         "expand_device_min": srv.engine.expand_device_min})
    return store, srv, (src, dst)


# -- phase 3 ----------------------------------------------------------------


def second_hop_rows(arena, seeds):
    """The main path's second-hop gather input for a 2-hop from
    ``seeds``: (rows int32[B], cap, live edges), as the engine forms it."""
    from dgraph_tpu_torch import ops

    out, _ = arena.expand_host(arena.rows_for_uids_host(seeds))
    f1 = np.unique(out)
    rows = arena.rows_for_uids_host(f1)
    total = int(arena.degree_of_rows(rows).sum())
    return ops.pad_rows(rows, ops.bucket(len(f1))), ops.bucket(total), total


def phase_kernels(arena, rng) -> dict:
    """Gather kernel == plain version on the card, exactly, one launch a
    call, over the grid.  Returns the max |kernel - plain|."""
    import torch

    from dgraph_tpu_torch import ops
    from dgraph_tpu_torch.ops import gather

    torch_cases = load_torch_cases()
    dev = arena.device
    ra = arena.resident()
    off, dst = ra.off, ra.dst
    n_rows = arena.n_rows
    cases = []
    seeds = np.unique(rng.integers(1, N_NODES + 1, size=LARGE_SEEDS))
    rows1 = arena.rows_for_uids_host(seeds)
    cases.append(("hop1_large_seeds", ops.pad_rows(rows1, ops.bucket(len(rows1))),
                  ops.bucket(int(arena.degree_of_rows(rows1).sum()))))
    rows2, cap2, _ = second_hop_rows(arena, seeds)
    cases.append(("hop2_large_seeds", rows2, cap2))
    for b in (8, 64, 512, 4096):
        r = rng.integers(-1, n_rows, size=b).astype(np.int32)  # unsorted, dups, skips
        tot = int(arena.degree_of_rows(r).sum())
        cases.append((f"random_B{b}", r, ops.bucket(max(1, tot))))
        cases.append((f"random_B{b}_truncated", r, max(8, ops.bucket(max(1, tot)) // 4)))
    cases = [(n, off, dst, torch.from_numpy(np.ascontiguousarray(r, dtype=np.int32)).to(dev), c)
             for n, r, c in cases]
    for name in torch_cases.GATHER_CASES:
        coff, cdst, rows, cap = torch_cases.gather_case(name)
        cases.append((name, *(torch.from_numpy(x).to(dev) for x in (coff, cdst, rows)), cap))
    results = []
    max_err = 0
    for name, coff, cdst, rt, cap in cases:
        want = gather.gather_packed_plain(coff, cdst, rt, cap)
        torch.cuda.synchronize()
        n0 = gather.KERNEL.launches
        got = gather.gather_packed(coff, cdst, rt, cap)
        torch.cuda.synchronize()
        check(gather.KERNEL.launches == n0 + 1, f"gather on {name}: not one launch")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        max_err = max(max_err, err)
        results.append((name, int(rt.shape[0]), int(cap), err))
        check(torch.equal(got, want), f"gather kernel != plain version on {name}")
    log({"phase": "kernels", "kernel": "gather_packed", "tolerance": 0,
         "cases": [{"case": n, "B": b, "cap": c, "max_abs_err": e}
                   for n, b, c, e in results]})
    return {"gather_packed": max_err}


# -- phase 4 ----------------------------------------------------------------


def phase_main_path(store, srv, rng, card: str) -> dict:
    """The served main path; returns what the report needs.  ``card`` is
    the nvidia-smi name and power limit, logged beside the timings."""
    from dgraph_tpu_torch.ops import gather

    out = {}
    ref = host_engine(store)

    # a. materialised 2-hop, 64 seeds
    seeds = np.unique(rng.integers(1, N_NODES + 1, size=SMALL_SEEDS))
    q = two_hop(seeds)
    status, raw, secs = post(srv.addr, q)
    check(status == 200, f"materialised 2-hop: HTTP {status}")
    want = json.dumps(ref.run(q))
    check(strip_latency(raw) == want,
          "materialised 2-hop body differs from the host route")
    n_nodes = want.count("_uid_")
    log({"phase": "materialised_2hop", "route": "per_level", "seeds": len(seeds),
         "uids_in_body": n_nodes,
         "body_bytes": len(raw), "ms": round(secs * 1e3, 3),
         "byte_identical_to_host_route": True})

    # b. large var-block 2-hop under the priced planner, repeated
    check_priced(srv)
    seeds = np.unique(rng.integers(1, N_NODES + 1, size=LARGE_SEEDS))
    q = two_hop_count(seeds)
    n0 = gather.KERNEL.launches
    lat, edges, hops = [], None, None
    for _ in range(REPEATS):
        status, raw, secs = post(srv.addr, q, "?ledger=true")
        check(status == 200, f"large 2-hop: HTTP {status}")
        lat.append(secs)
        led = json.loads(raw)["extensions"]["ledger"]
        edges, hops = led["edges"], led["hops"]
    per_query = (gather.KERNEL.launches - n0) / REPEATS
    check(per_query >= 1, "the large 2-hop did not launch the gather kernel")
    want = json.dumps(ref.run(q))
    check(strip_latency(raw) == want, "large 2-hop count differs from the host route")
    # one more request for its stage breakdown (latency map + engine stats)
    _status, raw, _secs = post(srv.addr, q, "?debug=true")
    lat_map = json.loads(raw)["server_latency"]
    check_decided(lat_map["engine"], "expand", "resident", "large 2-hop")
    log({"phase": "large_2hop_breakdown", "server_latency": lat_map})
    p50 = float(np.percentile(lat, 50))
    out["large"] = {
        "seeds": len(seeds), "repeats": REPEATS, "edges_per_query": edges,
        "hops": hops, "p50_ms": p50 * 1e3,
        "p99_ms": p99([x * 1e3 for x in lat]),
        "edges_per_s_at_p50": edges / p50,
        "launches_per_query": per_query,
        "count": json.loads(want)["q"][0]["count"],
        "card": card,
    }
    log(dict(phase="large_2hop", route="per_level", **out["large"]))
    del ref  # its arenas predate the mutation below

    # c. mutation merged on the device, then a fresh materialised 2-hop
    arena = srv.engine.arenas.data("e")
    ra0, epoch0 = arena.resident(), arena.epoch
    fresh = np.unique(rng.integers(1, N_NODES + 1, size=LARGE_SEEDS))
    have = arena.rows_for_uids_host(fresh) >= 0
    movers = fresh[have][:8]
    edges_e = store.peek("e").edges
    new_edges = []
    for s in movers.tolist():
        t = int(rng.integers(1, N_NODES + 1))
        while t in edges_e[s]:
            t = int(rng.integers(1, N_NODES + 1))
        new_edges.append((s, t))
    mu = "mutation { set { %s } }" % " ".join(
        "<0x%x> <e> <0x%x> ." % e for e in new_edges)
    status, raw, _ = post(srv.addr, mu)
    check(status == 200 and json.loads(raw).get("code") == "Success",
          f"mutation failed: {raw[:200]!r}")
    q = two_hop(fresh)
    n0 = gather.KERNEL.launches
    status, raw, secs = post(srv.addr, q, "?ledger=true")
    check(status == 200, f"post-mutation 2-hop: HTTP {status}")
    check(gather.KERNEL.launches > n0, "post-mutation 2-hop did not launch the kernel")
    arena = srv.engine.arenas._data["e"]
    check(arena.epoch == epoch0 + 1, "the mutation did not flip the arena epoch")
    check(arena._resident is ra0 and ra0._prev is not None,
          "the mutation reseeded the resident CSR instead of merging it")
    ref = host_engine(store)
    want = json.dumps(ref.run(q))
    got = strip_latency(raw)
    check(got == want, "post-mutation 2-hop body differs from the host route")
    by_uid = {n["_uid_"]: n for n in json.loads(got)["q"]}
    for s, t in new_edges:
        kids = {k["_uid_"] for k in by_uid["0x%x" % s].get("e", [])}
        check("0x%x" % t in kids, f"new edge 0x{s:x} -> 0x{t:x} missing")
    led = json.loads(raw)["extensions"]["ledger"]
    log({"phase": "mutation", "route": "per_level", "new_edges": len(new_edges),
         "epoch": arena.epoch,
         "reseeded": False, "merged_on_device": True, "seeds": len(fresh),
         "edges": led["edges"], "hops": led["hops"], "body_bytes": len(raw),
         "ms": round(secs * 1e3, 3), "byte_identical_to_host_route": True,
         "new_edges_present": True})
    return out


# -- phases 5-7: the join path ------------------------------------------------


def join_filter_query(s1, s2) -> str:
    """(a): an @filter AND over the 2-hop set of ``s1`` — one k-way call
    of K 3 (the candidates, has(e), uid(g))."""
    return ("{ var(func: uid(%s)) { e { f as e } } "
            "var(func: uid(%s)) { e { g as e } } "
            "q(func: uid(f)) @filter(has(e) AND uid(g)) { uid } }"
            % (uid_list(s1), uid_list(s2)))


def allofterms_query(s1) -> str:
    """(b): a 3-word allofterms (one k-way call over the words' posting
    sets) filtered by has(e) AND uid(f) (a second k-way call)."""
    return ("{ var(func: uid(%s)) { e { f as e } } "
            'q(func: allofterms(name, "%s")) @filter(has(e) AND uid(f)) '
            "{ uid name } }" % (uid_list(s1), " ".join(VOCAB[:NAME_WORDS])))


def phase_names(store, srv, n_named: int):
    """Names of NAME_WORDS words from VOCAB on uids 1..n_named, written
    into the served store, and the server's term index built; returns
    the index."""
    from dgraph_tpu_torch.models.store import Edge
    from dgraph_tpu_torch.models.types import TypeID, TypedValue

    t0 = time.perf_counter()
    rng = np.random.default_rng(NAME_SEED)
    words = np.asarray(VOCAB)[rng.integers(0, len(VOCAB), size=(n_named, NAME_WORDS))]
    store.apply_schema("name: string @index(term) .")
    store.apply_many(
        Edge("name", u, value=TypedValue(TypeID.STRING, " ".join(w)))
        for u, w in enumerate(words.tolist(), 1))
    t1 = time.perf_counter()
    idx = srv.engine.arenas.index("name", "term")
    t2 = time.perf_counter()
    postings = {w: int(idx.csr.degree_of_rows(np.array([idx.row_of(w)]))[0])
                for w in VOCAB[:NAME_WORDS]}
    log({"phase": "names", "named_nodes": n_named, "words_per_name": NAME_WORDS,
         "vocabulary": len(VOCAB), "seed": NAME_SEED, "tokens": len(idx.tokens),
         "query_word_postings": postings, "load_s": round(t1 - t0, 3),
         "index_build_s": round(t2 - t1, 3),
         "kway_device_min": srv.engine.arenas.kway_device_min})
    return idx


def two_hop_set(arena, seeds) -> np.ndarray:
    """The uids a 2-hop from ``seeds`` reaches: what ``e { f as e }``
    binds to ``f``."""
    out, _ = arena.expand_host(arena.rows_for_uids_host(seeds))
    out, _ = arena.expand_host(arena.rows_for_uids_host(np.unique(out)))
    return np.unique(out)


def join_matrices(arena, idx, s1, s2) -> dict:
    """The k-way inputs the join path's queries send, stacked as the
    engine stacks them (the sets in argument order, SENT-padded to
    ``bucket`` of the longest): (a)'s filter, (b)'s root allofterms and
    (b)'s filter."""
    from dgraph_tpu_torch import ops

    n = len(arena.h_src)
    has_e = arena.h_src[(arena.h_offsets[1: n + 1] - arena.h_offsets[:n]) > 0]
    f, g = two_hop_set(arena, s1), two_hop_set(arena, s2)
    words = [np.unique(idx.csr.expand_host(np.array([idx.row_of(w)]))[0])
             for w in VOCAB[:NAME_WORDS]]
    cands = words[0]
    for w in words[1:]:
        cands = np.intersect1d(cands, w)
    out = {}
    for name, sets in (("a_filter", [f, has_e, g]), ("b_root", words),
                       ("b_filter", [cands, has_e, f])):
        L = ops.bucket(max(len(x) for x in sets))
        out[name] = np.stack([ops.pad_to(x, L) for x in sets])
    return out


def load_torch_cases():
    """``tests/torch_cases.py``, the kernels' edge-case inputs, loaded by
    path: an installed package may own the name ``tests``."""
    spec = importlib.util.spec_from_file_location(
        "torch_cases", ROOT / "tests" / "torch_cases.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bench_ops_sets(rng, k: int, L: int, size: int, lo: int, hi: int) -> np.ndarray:
    """k sorted-unique sets of ``size`` draws from [lo, hi), SENT-padded
    to L: bench_ops.py's k-way draws."""
    from dgraph_tpu_torch import ops

    return np.stack([ops.pad_to(np.unique(rng.integers(lo, hi, size=size)), L)
                     for _ in range(k)])


def phase_intersect_kernels(device, served: dict, rng) -> int:
    """Intersect kernel == plain version on the card, exactly, over the
    grid; returns the max |kernel - plain|."""
    import torch

    from dgraph_tpu_torch import ops
    from dgraph_tpu_torch.ops import kway

    torch_cases = load_torch_cases()
    sent = ops.SENT
    cases = [(f"served_{n}", m[None]) for n, m in served.items()]
    for k in (2, 4, 8):  # bench_ops.py:498-507
        cases.append((f"bench_ops_K{k}_L8192",
                      bench_ops_sets(rng, k, 8192, 8192 * 3 // 4, 0, 8192 * 4)[None]))
    for b in (1, 64, 1024):  # bench_ops.py:189-216
        for k in (2, 4, 8):
            cases.append((f"bench_ops_B{b}_K{k}_L1024", np.stack(
                [bench_ops_sets(rng, k, 1024, 768, 1, 1200) for _ in range(b)])))
    cases.append(("K1", bench_ops_sets(rng, 1, 4096, 3000, 0, 8192)[None]))
    cases.append(("K16", bench_ops_sets(rng, 16, 4096, 4000, 0, 4400)[None]))
    m = bench_ops_sets(rng, 4, 8192, 6144, 0, 16384)
    m[2] = sent
    cases.append(("empty_row", m[None]))
    m = bench_ops_sets(rng, 4, 8192, 6144, 0, 16384)
    m[0] = sent
    cases.append(("all_sent_row0", m[None]))
    m = bench_ops_sets(rng, 1, 8192, 6144, 0, 16384)
    cases.append(("identical_rows", np.repeat(m[None], 8, axis=1)))
    for L in (1000, 4097, 65535):
        cases.append((f"L{L}", np.stack(
            [bench_ops_sets(rng, 3, L, L, 0, L + L // 2) for _ in range(3)])))
    cases += [(n, torch_cases.intersect_case(n)) for n in torch_cases.INTERSECT_CASES]
    results, max_err = [], 0
    for name, mat in cases:
        t = torch.from_numpy(np.ascontiguousarray(mat, dtype=np.int32)).to(device)
        got = kway.intersect_batch(t)
        want = kway.intersect_plain(t)
        _sync(t.device)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        max_err = max(max_err, err)
        results.append((name, list(mat.shape), int((want != sent).sum()), err))
        check(torch.equal(got, want), f"intersect kernel != plain version on {name}")
    # the ordering case: SENT stores of one tile against survivor stores
    # of a later one, the served (a) matrix over and over
    t = torch.from_numpy(served["a_filter"][None]).to(device)
    want = kway.intersect_plain(t)
    differ = 0
    for _ in range(torch_cases.REPEATS):
        differ += not torch.equal(kway.intersect_batch(t), want)
    _sync(t.device)
    check(differ == 0, f"intersect kernel differed on {differ} of "
                       f"{torch_cases.REPEATS} repeats of the served (a) matrix")
    results.append((f"served_a_filter_x{torch_cases.REPEATS}", list(t.shape),
                    int((want != sent).sum()), 0))
    for name, m in served.items():  # the served inputs against numpy too
        fold = m[0][m[0] != sent]
        for row in m[1:]:
            fold = np.intersect1d(fold, row[row != sent])
        got = kway.intersect_kernel(torch.from_numpy(m).to(device)).cpu().numpy()
        check(np.array_equal(got[got != sent], fold), f"served {name} != numpy fold")
    log({"phase": "intersect_kernels", "kernel": "intersect", "tolerance": 0,
         "cases": [{"case": n, "B_K_L": s_, "survivors": v, "max_abs_err": e}
                   for n, s_, v, e in results]})
    return max_err


def phase_join_path(store, srv, s1, s2, card: str) -> dict:
    """The served join path; the caller zeroes the launch counts just
    before.  ``card`` is the nvidia-smi name and power limit."""
    from dgraph_tpu_torch.ops import kway
    from dgraph_tpu_torch.query import joinplan

    check_priced(srv)
    ref = host_engine(store)
    out = {}
    for name, q, need in (("filter_and", join_filter_query(s1, s2), 1),
                          ("allofterms", allofterms_query(s1), 2)):
        n0 = kway.KERNEL.launches
        lat = []
        for _ in range(REPEATS):
            status, raw, secs = post(srv.addr, q)
            check(status == 200, f"{name}: HTTP {status}")
            lat.append(secs)
        per_query = (kway.KERNEL.launches - n0) / REPEATS
        check(per_query >= need,
              f"{name}: {per_query} intersect launches a request, want >= {need}")
        want = json.dumps(ref.run(q))
        check(strip_latency(raw) == want, f"{name} body differs from the host route")
        check(ref.stats["kway_device"] == 0 and ref.stats["kway_host"] >= need,
              f"{name}: the host route engine did not fold on the host")
        found = json.loads(want).get("q", [])
        check(len(found) > 0, f"{name} matched nothing")
        _status, raw, _secs = post(srv.addr, q, "?debug=true")
        lat_map = json.loads(raw)["server_latency"]
        eng = lat_map.pop("engine")
        check(eng["kway_device"] >= need and eng["kway_host"] == 0,
              f"{name}: k-way routes {eng['kway_device']} device, {eng['kway_host']} host")
        check_decided(eng, "kway", "device", name)
        out[name] = {
            "seeds": len(s1), "repeats": REPEATS,
            "p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p99_ms": p99([x * 1e3 for x in lat]),
            "request_ms": [x * 1e3 for x in lat],
            "launches_per_query": per_query, "uids_in_body": len(found),
            "body_bytes": len(want), "kway_ms": eng["kway_ms"],
            "kway_device": eng["kway_device"], "join_routes": eng["join_routes"],
            "engine": {k: eng[k] for k in ("host_expand_ms", "device_expand_ms",
                                           "resolver_expand_ms", "encode_ms",
                                           "routes", "edges")},
            "server_latency": lat_map, "byte_identical_to_host_route": True,
            "card": card,
        }
        log(dict(phase="join_path", route="per_level", query=name, **out[name]))
    log(dict(phase="join_routes", **joinplan.debug_summary()))
    return out


# -- phase 7a: the flight recorder ---------------------------------------------


def span_tree_ok(spans) -> tuple:
    """(parent name by span name for the request's own spans, missing
    names): the request tree query → parsing, processing → sched.queue,
    sched.flush, engine → hop / kway."""
    by_id = {s["span_id"]: s for s in spans}
    parent = {}
    for s in spans:
        p = by_id.get(s["parent_id"])
        parent.setdefault(s["name"], set()).add(p["name"] if p else None)
    want = {"query": {None}, "parsing": {"query"}, "processing": {"query"},
            "sched.queue": {"processing"}, "sched.flush": {"processing"},
            "engine": {"processing"}, "hop": {"engine"}}
    missing = [n for n, ps in want.items() if parent.get(n) != ps]
    return parent, missing


def settled_trace(rec, tid: str, names=("sched.flush",), timeout: float = 10.0):
    """The recorder's trace ``tid`` once every span in ``names`` landed
    (the cohort's flush span is finished by the flush worker after it
    deals the results, so it may land after the response)."""
    out = {}

    def ready():
        t = rec.trace(tid)
        if t is None or not all(any(s["name"] == n for s in t["spans"]) for n in names):
            return False
        out["t"] = t
        return all(s["dur_us"] is not None for s in t["spans"])

    wait_until(ready, timeout, f"flight recorder: trace {tid} never settled")
    return out["t"]


def phase_flight_recorder(store, srv, s1, s2, card: str) -> dict:
    """Phase 7a on the main path's server (the graph, phase 5's names,
    both query caches detached, the per-level route); the caller zeroes
    the launch counts just before and reads them just after."""
    import threading

    import torch

    from dgraph_tpu_torch import obs
    from dgraph_tpu_torch.ops import _build, gather, kway
    from dgraph_tpu_torch.utils.failpoints import fail
    from dgraph_tpu_torch.utils.metrics import QUERY_CANCELLED, SPANS_RECORDED

    t_phase = time.perf_counter()
    rng = np.random.default_rng(FLIGHT_SEED)
    seeds = np.unique(rng.integers(1, N_NODES + 1, size=LARGE_SEEDS))
    queries = {"count": two_hop_count(seeds), "join_a": join_filter_query(s1, s2)}
    ids = iter(int(x) for x in rng.integers(1, 1 << 62, size=64))

    def traceparent():
        n = next(ids)
        return f"{n:032x}", f"00-{n:032x}-{n:016x}-01"

    out = {"card": card}
    # ONE recorder for the phase, its sampler and slow threshold set per
    # step: a new recorder would drop the ring the exemplars point into
    rec = obs.configure(ratio=0.0, seed=FLIGHT_SEED)

    def arm(ratio: float, slow_ms: float = 0.0):
        rec.sampler.ratio, rec.slow_ms = ratio, slow_ms

    try:
        # the bodies at ratio 0: what every traced request must answer
        want = {}
        for name, q in queries.items():
            status, raw, _secs = post(srv.addr, q)
            check(status == 200, f"flight recorder: {name} at ratio 0: HTTP {status}")
            want[name] = strip_latency(raw)

        # (o1) sampled traces: the tree, the hop spans, the launches
        arm(1.0)
        rows = {}
        for name, q in queries.items():
            rows[name] = []
            for _ in range(FLIGHT_TRACED):
                tid, tp = traceparent()
                g0, k0 = gather.KERNEL.launches, kway.KERNEL.launches
                status, raw, _h, secs = post_any(srv.addr, q, {"Traceparent": tp})
                check(status == 200, f"flight recorder: traced {name}: HTTP {status}")
                check(strip_latency(raw) == want[name],
                      f"flight recorder: traced {name}'s body differs from ratio 0")
                g1, k1 = gather.KERNEL.launches - g0, kway.KERNEL.launches - k0
                t = settled_trace(rec, tid)
                spans = t["spans"]
                _parent, missing = span_tree_ok(spans)
                check(not missing, f"flight recorder: {name}'s tree lacks {missing}")
                hops = [s for s in spans if s["name"] == "hop"]
                dev = [s for s in hops if s["attrs"]["route"] in ("resident", "csr")]
                check(all(s["attrs"]["pred"] == "e" for s in hops),
                      f"flight recorder: {name}: a hop off predicate e")
                check(dev and all(s["attrs"]["route"] == "resident" for s in dev),
                      f"flight recorder: {name}: no resident hop in {hops}")
                for s in dev:
                    check(0.0 < s["attrs"]["device_sync_ms"] <= s["dur_us"] / 1e3,
                          f"flight recorder: {name}: device_sync_ms out of its hop: {s}")
                check(g1 == len(dev), f"flight recorder: {name}: {g1} gather launches "
                      f"for {len(dev)} device hops")
                kw = [s for s in spans if s["name"] == "kway"]
                check(k1 == len(kw), f"flight recorder: {name}: {k1} intersect "
                      f"launches for {len(kw)} kway spans")
                if name == "join_a":
                    check(kw and all(s["attrs"]["device_sync_ms"] > 0 for s in kw),
                          "flight recorder: join (a)'s trace holds no device k-way step")
                chrome = get_json(srv.addr, f"/debug/traces/{tid}?format=chrome")
                xs = [e for e in chrome["traceEvents"] if e["ph"] == "X"]
                check(len(xs) == len(spans),
                      f"flight recorder: chrome export {len(xs)} events, {len(spans)} spans")
                rows[name].append({
                    "ms": secs * 1e3, "spans": len(spans), "hops": len(hops),
                    "device_hops": len(dev), "gather_launches": g1,
                    "kway_spans": len(kw), "intersect_launches": k1,
                    "device_sync_ms": [s["attrs"]["device_sync_ms"] for s in dev + kw],
                    "hop_ms": [s["dur_us"] / 1e3 for s in dev]})
            log(dict(phase="flight_traces", query=name, card=card,
                     names=sorted({s["name"] for s in spans}), requests=rows[name]))
        out["traced"] = rows

        # (o2) ratio 0 allocates no span, a sampled header forces none
        arm(0.0)
        s0 = SPANS_RECORDED.value()
        forced = []
        for i in range(FLIGHT_UNSAMPLED):
            tid, tp = traceparent()
            status, raw, _h, _s = post_any(srv.addr, queries["count"],
                                           {"Traceparent": tp} if i % 2 else None)
            check(status == 200 and strip_latency(raw) == want["count"],
                  "flight recorder: an unsampled count differs")
            forced.append(tid)
        check(SPANS_RECORDED.value() == s0,
              f"flight recorder: ratio 0 allocated {SPANS_RECORDED.value() - s0} spans")
        check(all(rec.trace(t) is None for t in forced),
              "flight recorder: a sampled header forced a trace at ratio 0")
        out["unsampled"] = {"requests": FLIGHT_UNSAMPLED, "spans_allocated": 0}

        # (o3) tail sampling: a threshold every request crosses
        arm(0.0, slow_ms=0.001)
        for name, q in queries.items():
            status, _raw, _s = post(srv.addr, q)
            check(status == 200, f"flight recorder: slow {name}: HTTP {status}")
        slow = get_json(srv.addr, "/debug/slow_queries")
        check(len(slow) == len(queries), f"flight recorder: {len(slow)} slow queries")
        for e in slow:
            t = get_json(srv.addr, f"/debug/traces/{e['trace_id']}")
            check(t["spans"][0]["attrs"].get("tail_sampled") is True,
                  "flight recorder: a slow query's trace is not tail-sampled")
        out["slow_queries"] = [e["duration_ms"] for e in slow]

        # (o4) cancel a live query held at its hops (armed: the header
        # decides)
        arm(1e-9)
        tid, tp = traceparent()
        c0 = QUERY_CANCELLED.total(reason="admin", tenant="flight")
        res = {}

        def held():
            res["got"] = post_any(srv.addr, queries["count"],
                                  {"Traceparent": tp, "X-Dgraph-Tenant": "flight"})

        h0 = fail.hits("engine.hop")
        fail.arm("engine.hop", f"delay(ms={FLIGHT_HOLD_MS})")
        try:
            th = threading.Thread(target=held)
            t0 = time.perf_counter()
            th.start()
            # cancel while the query is held inside its first hop: live
            # and executing, not merely admitted
            wait_until(lambda: fail.hits("engine.hop") > h0, 30,
                       "flight recorder: the held query never reached a hop",
                       step=0.005)

            def cancelled():
                req = urllib.request.Request(
                    srv.addr + "/admin/cancel?trace_id=" + tid, data=b"", method="POST")
                try:
                    with urllib.request.urlopen(req, timeout=30) as r:
                        return r.status == 200
                except urllib.error.HTTPError as e:
                    check(e.code == 404, f"flight recorder: /admin/cancel HTTP {e.code}")
                    return False

            cancel_s = wait_until(cancelled, 30, "flight recorder: the held query "
                                  "never became cancellable", step=0.01)
            th.join(timeout=60)
            answer_s = time.perf_counter() - t0
        finally:
            fail.disarm("engine.hop")
        status, raw, _h, _s = res["got"]
        check(status == 499, f"flight recorder: the cancelled query answered {status}")
        hops_run = fail.hits("engine.hop") - h0
        check(hops_run == 1, f"flight recorder: the cancelled count ran {hops_run} hops")
        check(QUERY_CANCELLED.total(reason="admin", tenant="flight") == c0 + 1,
              "flight recorder: the admin cancellation was not counted")
        req = urllib.request.Request(srv.addr + "/admin/cancel?trace_id=" + tid,
                                     data=b"", method="POST")
        try:
            urllib.request.urlopen(req, timeout=30)
            check(False, "flight recorder: a second cancel answered 200")
        except urllib.error.HTTPError as e:
            check(e.code == 404, f"flight recorder: a second cancel answered {e.code}")
        out["cancel"] = {"hold_ms": FLIGHT_HOLD_MS, "cancel_s": cancel_s,
                         "answered_499_s": answer_s, "hops_run": hops_run}
        log(dict(phase="flight_checks", card=card, unsampled=out["unsampled"],
                 slow_queries_ms=out["slow_queries"], cancel=out["cancel"]))

        # (o5) the device report
        dev = get_json(srv.addr, "/debug/device")
        arenas = srv.engine.arenas
        check(dev["backend"] == "cuda", f"flight recorder: backend {dev['backend']}")
        check(dev["device_name"] == card.split(",")[0].strip(),
              f"flight recorder: device {dev['device_name']!r} against {card!r}")
        res_b = dev["arenas"]["resident_bytes"]
        check(res_b == arenas._lru_total and 0 < res_b <= torch.cuda.memory_allocated(),
              f"flight recorder: resident bytes {res_b}, running total "
              f"{arenas._lru_total}, allocated {torch.cuda.memory_allocated()}")
        builds = {n: _build.built.count(n) for n in _build.built}
        check(dev["compiles"]["builds"] == builds
              and dev["compiles"]["total"] == len(_build.built),
              f"flight recorder: builds {dev['compiles']} against {_build.built}")
        bundle = get_json(srv.addr, "/debug/bundle")
        check(set(bundle) == {"generated_unix", "traces", "slow_queries", "planner",
                              "qos", "ivm", "qcache", "device", "ledger"},
              f"flight recorder: bundle keys {sorted(bundle)}")
        req = urllib.request.Request(srv.addr + "/metrics",
                                     headers={"Accept": "application/openmetrics-text"})
        with urllib.request.urlopen(req, timeout=60) as r:
            om = r.read().decode()
        check(om.rstrip().endswith("# EOF"), "flight recorder: OpenMetrics without # EOF")
        ex = sorted({ln.split('trace_id="')[1].split('"')[0] for ln in om.splitlines()
                     if ln.startswith("dgraph_query_latency_seconds_bucket")
                     and 'trace_id="' in ln})
        check(ex, "flight recorder: no exemplars on dgraph_query_latency_seconds")
        for t in ex:
            check(get_json(srv.addr, f"/debug/traces/{t}")["trace_id"] == t,
                  f"flight recorder: exemplar {t} does not resolve")
        out["device"] = {k: dev[k] for k in ("backend", "device_name", "torch", "cuda")}
        out["device"].update(resident_bytes=res_b, compiles=dev["compiles"],
                             memory_allocated=torch.cuda.memory_allocated(),
                             exemplars=len(ex))
        log(dict(phase="flight_device", card=card, **out["device"]))

        # (o6) the cost of tracing: the count at ratio 0 and 1, alternating
        lat = {0: [], 1: []}
        syncs = []
        for i in range(2 * FLIGHT_COST_REQUESTS):
            ratio = i % 2
            arm(float(ratio))
            status, raw, secs = post(srv.addr, queries["count"])
            check(status == 200 and strip_latency(raw) == want["count"],
                  "flight recorder: a timed count differs")
            lat[ratio].append(secs * 1e3)
            if ratio:
                tid = rec.traces()[-1]["trace_id"]
                syncs += [s["attrs"]["device_sync_ms"]
                          for s in settled_trace(rec, tid)["spans"]
                          if s["name"] == "hop" and "device_sync_ms" in s["attrs"]]
        out["cost"] = {"requests_each": FLIGHT_COST_REQUESTS,
                       "p50_ms_ratio0": float(np.percentile(lat[0], 50)),
                       "p50_ms_ratio1": float(np.percentile(lat[1], 50)),
                       "mean_device_sync_ms": float(np.mean(syncs)),
                       "device_hops": len(syncs)}
        log(dict(phase="flight_cost", card=card, **out["cost"]))
        out["seconds"] = time.perf_counter() - t_phase
        return out
    finally:
        obs.configure()


# -- phase 7b: the device fault domain ------------------------------------------


def _guard_state_log(g):
    """Record every state the guard passes through (its ``_set_state``
    wrapped); returns the list it appends to and an undo."""
    seen = [g.state]
    orig = g._set_state

    def rec(state):
        orig(state)
        if seen[-1] != g.state:
            seen.append(g.state)

    g._set_state = rec
    return seen, lambda: setattr(g, "_set_state", orig)


def _pad_arenas(srv, rng) -> dict:
    """Two throwaway arenas of GUARD_PAD_EDGES random edges each, built
    on the card into the served ArenaManager's cache under keys no
    predicate has, and moved to the LRU's cold end: the victims of the
    OOM checks' evictions, so every served arena stays warm and the store
    takes no write.  Returns their device bytes by key."""
    from dgraph_tpu_torch.models.arena import csr_from_edges

    arenas = srv.engine.arenas
    for p in GUARD_PADS:
        src = rng.integers(1, N_NODES + 1, size=GUARD_PAD_EDGES)
        dst = rng.integers(1, N_NODES + 1, size=GUARD_PAD_EDGES)
        arenas._get_or_build(arenas._data, p,
                             lambda: csr_from_edges(src, dst, arenas.device))
    keys = [(id(arenas._data), p) for p in GUARD_PADS]
    with arenas._cache_lock:
        for k in reversed(keys):
            arenas._lru.move_to_end(k, last=False)
        return {k[1]: arenas._lru[k] for k in keys}


def _drop_pads(srv) -> None:
    arenas = srv.engine.arenas
    with arenas._cache_lock:
        for p in GUARD_PADS:
            if arenas._data.pop(p, None) is not None:
                arenas._lru_drop(arenas._data, p)


def _stage_stats(raw: bytes) -> dict:
    """A ``?debug=true`` body's stage times and routes."""
    lat = json.loads(raw)["server_latency"]
    eng = lat.pop("engine")
    return {"server_latency": {k: v for k, v in lat.items()},
            **{k: eng[k] for k in ("device_expand_ms", "host_expand_ms", "routes",
                                   "edges")}}


def _count_launches():
    from dgraph_tpu_torch.ops import gather, kway

    return gather.KERNEL.launches, kway.KERNEL.launches


def phase_device_guard(store, srv, s1, s2, card: str) -> dict:
    """The device fault domain on the card (utils/devguard.py); the caller
    zeroes the launch counts just before, with both caches detached and
    the per-level route.  Every 200 body is held byte for byte against
    the host-route engine at the same store version."""
    import torch

    from dgraph_tpu_torch.utils import devguard
    from dgraph_tpu_torch.utils.failpoints import fail
    from dgraph_tpu_torch.utils.metrics import DEVICE_FAILOVER

    t_phase = time.perf_counter()
    rng = np.random.default_rng(GUARD_SEED)
    seeds = np.unique(rng.integers(1, N_NODES + 1, size=LARGE_SEEDS))
    count_q = two_hop_count(seeds)
    join_q = join_filter_query(s1, s2)
    ref = host_engine(store)
    want = {"count": json.dumps(ref.run(count_q)), "join_a": json.dumps(ref.run(join_q))}
    out = {"card": card, "seeds": len(seeds)}

    def served(name, q, params=""):
        status, raw, hdrs, secs = post_any(srv.addr, q, params=params)
        if status == 200:
            check(strip_latency(raw) == want[name],
                  f"device_guard: {name} body differs from the host route")
        return status, raw, hdrs, secs

    # guard_overhead: the count with the guard on and off, request by request
    lat = {"1": [], "0": []}
    launches = {"1": [], "0": []}
    for i in range(2 * GUARD_OVERHEAD_REPEATS):
        mode = "1" if i % 2 == 0 else "0"
        with env_set("DGRAPH_TPU_DEVGUARD", mode):
            g0 = _count_launches()[0]
            status, _raw, _h, secs = served("count", count_q)
            check(status == 200, f"guard_overhead: HTTP {status}")
            lat[mode].append(secs)
            launches[mode].append(_count_launches()[0] - g0)
    check(launches["1"] == launches["0"] and min(launches["1"]) >= 1,
          f"guard_overhead: gather launches differ on/off: {launches}")
    out["guard_overhead"] = {
        "requests_each": GUARD_OVERHEAD_REPEATS,
        "p50_ms_on": float(np.percentile(lat["1"], 50)) * 1e3,
        "p50_ms_off": float(np.percentile(lat["0"], 50)) * 1e3,
        "request_ms_on": [x * 1e3 for x in lat["1"]],
        "request_ms_off": [x * 1e3 for x in lat["0"]],
        "gather_launches_per_request": launches["1"][0], "card": card}
    log(dict(phase="guard_overhead", **out["guard_overhead"]))

    g = devguard.get()
    arenas = srv.engine.arenas
    pad_rng = np.random.default_rng(GUARD_SEED + 1)

    # guard_oom_injected: one injected OOM at the per-level dispatch
    pad_bytes = _pad_arenas(srv, pad_rng)
    check(len(arenas._lru) >= 3, "guard_oom_injected: fewer than two other arenas cached")
    states, undo = _guard_state_log(g)
    ev0, r0 = arenas.evictions, DEVICE_FAILOVER.snapshot().get("evict_retry", 0)
    f0 = dict(g.faults)
    fail.arm("device.hop", "xla_oom(n=1)")
    try:
        status, raw, _h, secs = served("count", count_q, "?debug=true")
    finally:
        fail.disarm("device.hop")
        undo()
    check(status == 200, f"guard_oom_injected: HTTP {status}")
    check(DEVICE_FAILOVER.snapshot().get("evict_retry", 0) == r0 + 1,
          "guard_oom_injected: evict_retry did not rise by one")
    check(arenas.evictions - ev0 >= 1, "guard_oom_injected: nothing was evicted")
    check(states == ["healthy", "suspect", "healthy"],
          f"guard_oom_injected: states {states}")
    out["guard_oom_injected"] = {
        "status": status, "ms": secs * 1e3, "evictions": arenas.evictions - ev0,
        "evict_retry": 1, "states": states,
        "oom_faults": g.faults.get("oom", 0) - f0.get("oom", 0),
        "engine": _stage_stats(raw),
        "pad_arena_bytes": pad_bytes, "card": card}
    log(dict(phase="guard_oom_injected", **out["guard_oom_injected"]))

    # guard_oom_real: a ballast leaves less free memory than the count's
    # gather buffer, the evictable arenas more than the shortfall; then
    # filler blocks take every cached block of the allocator that could
    # still serve it (a segment's free tail survives empty_cache while
    # another block of it lives)
    pad_bytes = _pad_arenas(srv, pad_rng)
    a = arenas.data("e")
    rows, cap, _total = second_hop_rows(a, seeds)
    from dgraph_tpu_torch.ops.gather import MAX_GRID

    need = 4 * (2 * cap + 2 * len(rows) + MAX_GRID)
    with arenas._cache_lock:
        evictable = sum(b for k, b in list(arenas._lru.items())[:2])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free0, total_mem = torch.cuda.mem_get_info()
    # three quarters of the buffer left free: a new 2 MiB segment for the
    # rows' upload still fits (below it the upload's own small-pool
    # segment can fail, which evicting large blocks cannot cure), the
    # buffer does not
    leave = need * 3 // 4
    ballast = [torch.empty(max(0, free0 - leave), dtype=torch.uint8, device="cuda")]
    free1, _ = torch.cuda.mem_get_info()
    cached1 = torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
    while len(ballast) < GUARD_FILLERS:
        try:
            ballast.append(torch.empty(need, dtype=torch.uint8, device="cuda"))
        except torch.cuda.OutOfMemoryError:
            break
    fillers = len(ballast) - 1
    free2, _ = torch.cuda.mem_get_info()
    cached2 = torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
    ev0, r0 = arenas.evictions, DEVICE_FAILOVER.snapshot().get("evict_retry", 0)
    oom0 = g.faults.get("oom", 0)
    try:
        status, raw, hdrs, secs = served("count", count_q, "?debug=true")
    finally:
        del ballast
        torch.cuda.empty_cache()
    real = {
        "status": status, "ms": secs * 1e3, "gather_buffer_bytes": need,
        "free_bytes_before_ballast": free0, "free_bytes_with_ballast": free1,
        "cached_free_bytes_with_ballast": cached1, "fillers": fillers,
        "free_bytes_with_fillers": free2, "cached_free_bytes_with_fillers": cached2,
        "evictable_lru_bytes": evictable, "pad_arena_bytes": pad_bytes,
        "evictions": arenas.evictions - ev0,
        "evict_retry": DEVICE_FAILOVER.snapshot().get("evict_retry", 0) - r0,
        "oom_faults": g.faults.get("oom", 0) - oom0,
        "last_fault": g.status()["last_fault"],
        "engine": _stage_stats(raw) if status == 200 else None, "card": card}
    check(free1 < need and free1 + evictable > need or real["oom_faults"] > 0,
          f"guard_oom_real: the ballast did not set up the shortfall: {real}")
    if real["oom_faults"] and status == 200:
        real["outcome"] = "real OOM, LRU evicted, one retry served"
        check(real["evictions"] >= 1 and real["evict_retry"] == 1
              and "OutOfMemoryError" in (real["last_fault"] or ""),
              f"guard_oom_real: {real}")
    elif real["oom_faults"]:
        # the retry ran out of memory too: the allocator could not use
        # the evicted arenas' blocks for the buffer
        real["outcome"] = f"real OOM, eviction freed too little: HTTP {status}"
        check(status == 503 and hdrs.get("Retry-After"),
              f"guard_oom_real: a failed retry must answer 503: {real}")
    else:
        real["outcome"] = "no OOM: the allocator served the buffer from cached blocks"
        check(status == 200, f"guard_oom_real: {real}")
    out["guard_oom_real"] = real
    log(dict(phase="guard_oom_real", **real))
    _drop_pads(srv)

    # guard_hang: a wedged dispatch answers 503 within hang_ms + 1 s, the
    # domain sick, then re-admission by the probe
    with env_set("DGRAPH_TPU_DEVICE_HANG_MS", str(GUARD_HANG_MS)), \
            env_set("DGRAPH_TPU_DEVICE_COOLDOWN_S", str(GUARD_COOLDOWN_S)):
        devguard.reset_for_tests()  # a guard with these knobs
        g = devguard.get()
        try:
            workers = [t.is_alive() for t in srv.scheduler._workers]
            fail.arm("device.hop", f"hang(ms={GUARD_WEDGE_MS},n=1)")
            # the first probes fail: the domain stays sick long enough for
            # the checks below
            fail.arm("devguard.probe", f"error(n={GUARD_PROBE_FAILS})")
            g_pre = _count_launches()[0]
            status, raw, hdrs, secs = served("count", count_q)
            t_sick = time.perf_counter()
            check(status == 503 and hdrs.get("Retry-After") == str(
                int(np.ceil(GUARD_COOLDOWN_S))),
                  f"guard_hang: first count HTTP {status} {hdrs.get('Retry-After')}")
            check(secs < GUARD_HANG_MS / 1e3 + 1.0,
                  f"guard_hang: 503 after {secs:.3f} s")
            # the abandoned worker wakes after the wedge and finishes its
            # hop (one gather launch, its result dropped): wait for it, so
            # that the launches counted below are the sick requests' own
            wedge_s = wait_until(lambda: _count_launches()[0] > g_pre,
                                 GUARD_WEDGE_MS / 1e3 + 10, "guard_hang: the wedge never woke")
            time.sleep(0.5)
            check(g.state == "sick", f"guard_hang: {g.state} after the wedge woke")
            g0 = _count_launches()[0]
            sick_ms = []
            for _ in range(3):
                st, _r, h, s = served("count", count_q)
                check(st == 503 and h.get("Retry-After"), f"guard_hang: sick count HTTP {st}")
                sick_ms.append(s * 1e3)
            dbg = get_json(srv.addr, "/debug/device")["guard"]["domains"]["device"]
            hl = get_json(srv.addr, "/health?detail=1")["device"]["domains"]["device"]
            check(dbg["state"] == "sick" and hl["state"] == "sick",
                  f"guard_hang: /debug/device {dbg['state']}, /health {hl['state']}")
            codes = []
            import threading as _th

            def client():
                st, *_rest = served("count", count_q)
                codes.append(st)

            ts = [_th.Thread(target=client) for _ in range(GUARD_CLIENTS)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            sick_launches = _count_launches()[0] - g0
            check(codes == [503] * GUARD_CLIENTS, f"guard_hang: concurrent codes {codes}")
            check(sick_launches == 0,
                  f"guard_hang: {sick_launches} gather launches while sick")
            check(all(t.is_alive() for t in srv.scheduler._workers) and all(workers),
                  "guard_hang: a scheduler worker died")
            wait_until(lambda: g.state == "healthy", GUARD_READMIT_S,
                       "guard_hang: no re-admission")
            readmit_s = time.perf_counter() - t_sick
            after = {}
            for name, q in (("count", count_q), ("join_a", join_q)):
                st, _r, _h, s = served(name, q)
                check(st == 200, f"guard_hang: {name} after re-admission HTTP {st}")
                after[name] = s * 1e3
            stat = g.status()
            out["guard_hang"] = {
                "hang_ms": GUARD_HANG_MS, "wedge_ms": GUARD_WEDGE_MS,
                "cooldown_s": GUARD_COOLDOWN_S, "time_to_503_ms": secs * 1e3,
                "sick_503_ms": sick_ms, "concurrent_clients": GUARD_CLIENTS,
                "time_to_readmission_s": readmit_s,
                "probes_failed": stat["probes_failed"], "probes_ok": stat["probes_ok"],
                "wedged_workers": stat["wedged_workers"], "faults": stat["faults"],
                "wedge_woke_after_s": wedge_s, "after_readmission_ms": after,
                "card": card}
            log(dict(phase="guard_hang", **out["guard_hang"]))
        finally:
            fail.disarm("device.hop")
            fail.disarm("devguard.probe")
    # the wedged worker finishes its hop (its result dropped); a guard at
    # the default knobs for the phases after this one
    time.sleep(max(0.0, GUARD_WEDGE_MS / 1e3 - (time.perf_counter() - t_sick)) + 0.5)
    devguard.reset_for_tests()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def guard_summary(g: dict) -> dict:
    """The device_guard phase's figures for the summary line."""
    o, r, h = g["guard_overhead"], g["guard_oom_real"], g["guard_hang"]
    return {"seconds": g["seconds"],
            "count_p50_ms_guard_on": o["p50_ms_on"],
            "count_p50_ms_guard_off": o["p50_ms_off"],
            "oom_injected_evictions": g["guard_oom_injected"]["evictions"],
            "oom_real_outcome": r["outcome"], "oom_real_status": r["status"],
            "hang_time_to_503_ms": h["time_to_503_ms"],
            "hang_time_to_readmission_s": h["time_to_readmission_s"],
            "probes_failed": h["probes_failed"], "probes_ok": h["probes_ok"]}


# -- phase 7d: live-query subscriptions --------------------------------------


def subs_summary(s: dict) -> dict:
    """The subscriptions phase's figures for the summary line."""
    return {k: s[k] for k in (
        "seconds", "pushes", "push_latency_p50_ms", "push_latency_max_ms", "evals",
        "events", "launches_during_reevaluation")}


def transports_summary(t: dict) -> dict:
    """Phase transports' figures for the summary line."""
    out = {"grpc": t["grpc"], "seconds": t["seconds"]}
    for part in ("plain", "tls"):
        out[part] = {f"{q}_{tn}": {k: r[k] for k in ("p50_ms", "p99_ms",
                                                     "gather_launches",
                                                     "intersect_launches")}
                     for q, rows in t[part].items() for tn, r in rows.items()}
    out["tls_checks"] = t["tls_checks"]
    if "subscribe" in t:
        out["subscribe_push_ms"] = t["subscribe"]["push_ms"]
    if "cluster" in t:
        c = t["cluster"]
        # the cut's name beside its figures: a stride sample, gates at 1
        out[f"tls_trio_stride{TLS_TRIO_SHARE}_named{PAIR_NAMED}_gates1"] = {
            k: c[k] for k in ("replicate_s", "count_first_answer_s", "count_p50_ms",
                              "write_ack_s", "write_converged_s", "traced_read_ms",
                              "dgraph_grpc_raft_frames_total")}
    return out


def _sub_consumer(sub, got: list):
    """Pop ``sub``'s events into ``got`` as (arrival time, event) until
    its terminal ``cancelled`` event."""
    while True:
        ev = sub.next_event(timeout=5.0)
        if ev is None:
            continue
        got.append((time.perf_counter(), ev))
        if ev["kind"] == "cancelled":
            return


def _sse_consumer(addr, text, got: list, ready):
    """POST /subscribe as an SSE client: each frame into ``got`` as
    (arrival time, event) until the ``cancelled`` frame."""
    req = urllib.request.Request(addr + "/subscribe", data=text.encode(),
                                 headers={"Accept": "text/event-stream"})
    with urllib.request.urlopen(req, timeout=900) as resp:
        ready.append(resp.headers["Content-Type"])
        buf = b""
        for line in resp:
            if line.strip() == b"" and buf:
                for ln in buf.split(b"\n"):
                    if ln.startswith(b"data: "):
                        got.append((time.perf_counter(), json.loads(ln[6:])))
                buf = b""
                if got and got[-1][1]["kind"] == "cancelled":
                    return
            elif not line.startswith(b":"):
                buf += line.strip() + b"\n"


def _events_since(got: list, i: int, kinds=("update",)):
    return [(t, e) for t, e in got[i:] if e["kind"] in kinds]


def phase_subscriptions(store, srv, card: str) -> dict:
    """Live queries on the card (ivm/subs.py); the caller zeroes the
    launch counts just before.  The hop and k-way gates are pinned at 1
    for the phase (a 1024-seed 2-hop is below the priced device
    break-even), so that every re-evaluation runs the kernels."""
    import threading as _th

    from dgraph_tpu_torch.utils.metrics import SUBS_EVALS, SUBS_EVENTS

    t_phase = time.perf_counter()
    check(srv.subs is not None, "subscriptions: the server has no registry")
    rng = np.random.default_rng(SUBS_SEED)
    arenas = srv.engine.arenas
    knobs = (arenas.expand_device_min, arenas.kway_device_min)
    arenas.expand_device_min, arenas.kway_device_min = 1, 1
    e_seeds = [np.unique(rng.integers(1, N_NODES + 1, size=SUBS_SEEDS))
               for _ in range(SUBS_E)]
    e_qs = [two_hop_count(s) for s in e_seeds]
    pairs = [(VOCAB[2 * i], VOCAB[2 * i + 1]) for i in range(SUBS_NAME)]
    n_qs = ['{ q(func: allofterms(name, "%s %s")) { count() } }' % p for p in pairs]
    texts = e_qs + n_qs
    ref = host_engine(store)
    want = [json.dumps(ref.run(q)) for q in texts]
    gots = [[] for _ in texts]
    threads = []
    subs = []
    try:
        # one e subscription over HTTP as SSE, the rest registered over
        # HTTP and consumed in process
        ready = []
        t = _th.Thread(target=_sse_consumer, args=(srv.addr, texts[0], gots[0], ready),
                       daemon=True)
        t.start()
        threads.append(t)
        wait_until(lambda: gots[0], 60, "subscriptions: no SSE snapshot")
        subs.append(srv.subs.get(gots[0][0][1]["sub_id"]))
        for i, q in enumerate(texts[1:], 1):
            req = urllib.request.Request(srv.addr + "/subscribe", data=q.encode())
            with urllib.request.urlopen(req, timeout=900) as r:
                reg = json.loads(r.read())
            sub = srv.subs.get(reg["sub_id"])
            subs.append(sub)
            t = _th.Thread(target=_sub_consumer, args=(sub, gots[i]), daemon=True)
            t.start()
            threads.append(t)
        for i, q in enumerate(texts):
            wait_until(lambda: gots[i], 60, f"subscriptions: sub {i} no snapshot")
            snap = gots[i][0][1]
            check(snap["kind"] == "snapshot", f"subscriptions: sub {i} first event {snap['kind']}")
            status, raw, _s = post(srv.addr, q)
            check(status == 200 and strip_latency(raw) == json.dumps(snap["data"])
                  == want[i], f"subscriptions: sub {i} snapshot differs from /query")
        check(ready == ["text/event-stream"], f"subscriptions: SSE content type {ready}")
        footprints = [sorted(s.footprint) for s in subs]
        check(footprints == [["e"]] * SUBS_E + [["name"]] * SUBS_NAME,
              f"subscriptions: footprints {footprints}")

        from dgraph_tpu_torch.ops import gather, kway

        g_l0, k_l0 = gather.KERNEL.launches, kway.KERNEL.launches
        evals0 = SUBS_EVALS.value()
        ev0 = SUBS_EVENTS.snapshot()
        latencies = []
        writes = []
        ref_arena = ref.arenas.data("e")
        edges_e = store.peek("e").edges

        def settle(expect_push, ack_t, marks, what):
            """Wait for the pushes ``expect_push`` (sub index -> body),
            record each one's latency from ``ack_t``, then hold every
            subscription to exactly the pushes expected after a quiet
            SUBS_QUIET_S."""
            for i, body in expect_push.items():
                wait_until(lambda: _events_since(gots[i], marks[i]), 30,
                           f"{what}: sub {i} got no push")
                (t_ev, ev), = _events_since(gots[i], marks[i])[:1]
                check(json.dumps(ev["data"]) == body,
                      f"{what}: sub {i} push differs from the host route")
                latencies.append(t_ev - ack_t)
            time.sleep(SUBS_QUIET_S)
            for i in range(len(texts)):
                n = len(_events_since(gots[i], marks[i]))
                check(n == (1 if i in expect_push else 0),
                      f"{what}: sub {i} got {n} pushes")

        # e writes: 64 edges each from the first-hop targets of sub 0's
        # seeds to uids outside its 2-hop set, so that its count moves
        f1 = np.unique(ref_arena.expand_host(ref_arena.rows_for_uids_host(e_seeds[0]))[0])
        reach = set(two_hop_set(ref_arena, e_seeds[0]).tolist())
        last = [json.loads(w) for w in want]
        for w in range(SUBS_WRITES):
            srcs = rng.choice(f1, size=SUBS_DELTA, replace=False)
            adds = []
            for s in srcs.tolist():
                t = int(rng.integers(1, N_NODES + 1))
                while t in reach or t in edges_e.get(s, ()):
                    t = int(rng.integers(1, N_NODES + 1))
                adds.append((s, t))
            marks = [len(x) for x in gots]
            t0 = time.perf_counter()
            status, raw, _s = post(srv.addr, "mutation { set { %s } }" % " ".join(
                "<0x%x> <e> <0x%x> ." % e for e in adds))
            ack = time.perf_counter()
            check(status == 200, f"subscriptions: e write {w} HTTP {status}")
            # sub 0's push first: its evaluation refreshed the served
            # arenas, which consume the store's delta journal (a second
            # ArenaManager refreshing first would take it from them)
            wait_until(lambda: _events_since(gots[0], marks[0]), 30,
                       f"e write {w}: sub 0 got no push")
            # the host-route reference at this version: its arena takes
            # exactly the written edges
            ref_arena.apply_delta(np.array(adds, np.int64).reshape(-1, 2),
                                  np.zeros((0, 2), np.int64))
            bodies = [ref.run(q) for q in e_qs]
            expect = {i: json.dumps(b) for i, b in enumerate(bodies) if b != last[i]}
            check(0 in expect, f"subscriptions: e write {w} did not move sub 0")
            settle(expect, ack, marks, f"e write {w}")
            for i, b in enumerate(bodies):
                last[i] = b
            writes.append({"write": w, "edges": len(adds), "ack_ms": (ack - t0) * 1e3,
                           "pushed": sorted(expect)})
            reach = set(two_hop_set(ref_arena, e_seeds[0]).tolist())

        # re-setting existing edges: every e subscription re-evaluates,
        # the result is unchanged: a skip each, no push
        skip0 = SUBS_EVENTS.snapshot().get("skip", 0)
        marks = [len(x) for x in gots]
        status, raw, _s = post(srv.addr, "mutation { set { %s } }" % " ".join(
            "<0x%x> <e> <0x%x> ." % e for e in adds[:4]))
        check(status == 200, f"subscriptions: re-set HTTP {status}")
        wait_until(lambda: SUBS_EVENTS.snapshot().get("skip", 0) - skip0 >= SUBS_E, 30,
                   "subscriptions: the re-set edges were not skips")
        settle({}, time.perf_counter(), marks, "re-set")

        # a name write: one new uid named with every word wakes the name
        # subscriptions alone, each count one higher
        marks = [len(x) for x in gots]
        fresh = N_NAMED + 1 + int(rng.integers(0, 1000))
        status, raw, _s = post(srv.addr, 'mutation { set { <0x%x> <name> "%s" . } }'
                               % (fresh, " ".join(VOCAB)))
        ack = time.perf_counter()
        check(status == 200, f"subscriptions: name write HTTP {status}")
        expect = {}
        for i in range(SUBS_E, len(texts)):
            b = json.loads(json.dumps(last[i]))
            b["q"][0]["count"] += 1
            expect[i] = json.dumps(b)
        settle(expect, ack, marks, "name write")
        for i in expect:
            last[i] = json.loads(expect[i])

        # an unrelated predicate: nothing wakes
        marks = [len(x) for x in gots]
        e0 = SUBS_EVALS.value()
        status, raw, _s = post(srv.addr, 'mutation { set { <0x1> <hobby> "chess" . } }')
        check(status == 200, f"subscriptions: unrelated write HTTP {status}")
        settle({}, time.perf_counter(), marks, "unrelated write")
        check(SUBS_EVALS.value() == e0, "subscriptions: an unrelated write evaluated")

        ev1 = SUBS_EVENTS.snapshot()
        launches = {"gather": gather.KERNEL.launches - g_l0,
                    "intersect": kway.KERNEL.launches - k_l0}
        # the name subscriptions' final bodies against a host-route
        # reference whose term index is rebuilt at this version (the
        # served arenas consumed the write's dirty mark)
        with ref.arenas._cache_lock:
            if ref.arenas._index.pop(("name", "term"), None) is not None:
                ref.arenas._lru_drop(ref.arenas._index, ("name", "term"))
        for i in range(SUBS_E, len(texts)):
            check(ref.run(texts[i]) == last[i],
                  f"subscriptions: name sub {i} final body differs from the host route")

        # cancel one over HTTP; the server's stop path cancels the rest
        victim = subs[1]
        req = urllib.request.Request(srv.addr + "/subscribe/cancel?id=" + victim.id, data=b"")
        with urllib.request.urlopen(req, timeout=60) as r:
            check(json.loads(r.read())["code"] == "Success", "subscriptions: cancel")
        wait_until(lambda: gots[1] and gots[1][-1][1]["kind"] == "cancelled", 30,
                   "subscriptions: no cancelled event")
        srv.subs.stop()
        for i, t in enumerate(threads):
            t.join(timeout=30)
            check(not t.is_alive(), f"subscriptions: consumer {i} still running")
            check(gots[i][-1][1]["kind"] == "cancelled",
                  f"subscriptions: sub {i} ended with {gots[i][-1][1]['kind']}")
        check(not srv.subs._thread.is_alive(), "subscriptions: the notifier outlived stop")
        lat_ms = [x * 1e3 for x in latencies]
        out = {
            "subscriptions": len(texts), "seeds_each": SUBS_SEEDS,
            "e_writes": writes, "pushes": len(latencies),
            "push_latency_p50_ms": float(np.percentile(lat_ms, 50)),
            "push_latency_max_ms": max(lat_ms), "push_latency_ms": lat_ms,
            "evals": SUBS_EVALS.value() - evals0,
            "events": {k: ev1.get(k, 0) - ev0.get(k, 0) for k in ev1},
            "launches_during_reevaluation": launches,
            "sse": True, "card": card,
            "seconds": time.perf_counter() - t_phase}
        log(dict(phase="subscriptions", **out))
        return out
    finally:
        arenas.expand_device_min, arenas.kway_device_min = knobs


# -- phase 7c: the transports ------------------------------------------------


def grpc_importable() -> bool:
    try:
        import grpc  # noqa: F401
    except ImportError:
        return False
    return True


def tls_cert(work: Path) -> tuple:
    """A throwaway self-signed certificate for localhost / 127.0.0.1 from
    the ``openssl`` CLI: (cert path, key path)."""
    cert, key = work / "cert.pem", work / "key.pem"
    r = subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(key), "-out", str(cert), "-days", "1",
         "-subj", "/CN=localhost",
         "-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1"],
        capture_output=True, text=True, timeout=120)
    check(r.returncode == 0, f"transports: openssl failed: {r.stderr[-500:]}")
    return str(cert), str(key)


def pb_fields(raw: bytes) -> list:
    """A protobuf Response's top-level fields, its Latency (field 2, the
    only one that differs between two runs) left out."""
    from dgraph_tpu_torch.serve import proto

    return [f for f in proto.iter_fields(raw) if f[0] != 2]


def pb_tree(raw: bytes) -> str:
    """A protobuf Response decoded (through ``serve/proto.iter_fields``)
    into the JSON surface's tree, latency left out, as JSON text."""
    from dgraph_tpu_torch.serve import proto

    d = proto.decode_response(raw)
    d.pop("server_latency", None)
    return json.dumps(d)


class GrpcRun:
    """``/protos.Dgraph/Run`` on one channel: raw Response bytes, a
    deadline on every call."""

    def __init__(self, target: str, cafile: str = ""):
        from dgraph_tpu_torch.serve.grpc_server import make_channel

        self.ch = make_channel(target, cafile)
        self._run = self.ch.unary_unary("/protos.Dgraph/Run")

    def __call__(self, text: str, metadata=None):
        from dgraph_tpu_torch.serve.grpc_server import encode_request

        t0 = time.perf_counter()
        raw = self._run(encode_request(text), timeout=CLUSTER_WAIT_S, metadata=metadata)
        return raw, time.perf_counter() - t0

    def stop(self):
        self.ch.close()


def served_transports(srv, queries, runs, want, card: str, what: str, repeats: int,
                      expect=None) -> dict:
    """Each query of ``queries`` over each transport of ``runs`` (name ->
    callable returning (body bytes, seconds, protobuf?)), ``repeats``
    times, the transports taking turns request by request (so that none
    of them takes all of a warm-up or a slow spell of the host): every
    body's tree equals ``want`` (the JSON surface's, held to the host
    route), every protobuf body's fields equal the encoder's of that
    tree, and every request launches exactly the gathers and intersects
    of ``expect[query]`` (or, without ``expect``, of the first
    transport's first request: the JSON surface's), so that a hop sent
    to the host on one transport fails the run.  Returns per query and
    transport the p50 / p99 and the kernels' launches a request."""
    from dgraph_tpu_torch.ops import gather, kway
    from dgraph_tpu_torch.serve import proto

    rows = {}
    for name, q in queries.items():
        enc = pb_fields(proto.encode_response(json.loads(want[name])))
        lat, g, k = ({t: [] for t in runs} for _ in range(3))
        for _ in range(repeats):
            for tname, run in runs.items():
                g0, k0 = gather.KERNEL.launches, kway.KERNEL.launches
                raw, secs, binary = run(q)
                g[tname].append(gather.KERNEL.launches - g0)
                k[tname].append(kway.KERNEL.launches - k0)
                lat[tname].append(secs * 1e3)
                if binary:
                    check(pb_fields(raw) == enc,
                          f"{what} {name} over {tname}: the protobuf body differs")
                    got = pb_tree(raw)
                else:
                    got = strip_latency(raw)
                check(got == want[name],
                      f"{what} {name} over {tname}: the body differs from the JSON surface's")
        first = next(iter(runs))
        base = expect[name] if expect else (g[first][0], k[first][0])
        for tname in runs:
            lat_t, g_t, k_t = lat[tname], g[tname], k[tname]
            check(min(g_t) >= 1, f"{what} {name} over {tname}: a request launched no gather")
            if name == "join_a":
                check(min(k_t) >= 1,
                      f"{what} join (a) over {tname}: a request launched no intersect")
            check(all((a, b) == base for a, b in zip(g_t, k_t)),
                  f"{what} {name} over {tname}: launched gathers {g_t} and intersects "
                  f"{k_t}, the JSON surface's request {base}")
            rows.setdefault(name, {})[tname] = {
                "requests": len(lat_t), "p50_ms": float(np.percentile(lat_t, 50)),
                "p99_ms": p99(lat_t), "request_ms": lat_t,
                "gather_launches": g_t, "intersect_launches": k_t}
            log(dict(phase="transports_served", part=what, query=name, transport=tname,
                     card=card, **rows[name][tname]))
    return rows


def handshake_ms(fn, n: int = TRANSPORT_CONNECTS) -> float:
    """The median of ``n`` calls of ``fn`` (a fresh connection each), ms."""
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(ts, 50))


def free_port_pairs(n: int, offset: int) -> list:
    """``n`` free ports whose ``port + offset`` is free too (the gRPC
    listeners' convention)."""
    import socket

    out = []
    while len(out) < n:
        (p,) = free_ports(1)
        if p + offset > 65535:
            continue
        s = socket.socket()
        try:
            s.bind(("127.0.0.1", p + offset))
        except OSError:
            continue
        finally:
            s.close()
        if p not in out:
            out.append(p)
    return out


def phase_transports(store, srv, src, dst, card: str, device: str = "cuda",
                     repeats: int = TRANSPORT_REPEATS) -> dict:
    """Phase transports: the main path's server over HTTP JSON, binary
    HTTP and gRPC; a second server over the same store and arenas on
    TLS (HTTPS and gRPC), ``repeats`` requests of each query on each
    transport; a live count streamed over gRPC Subscribe; a
    TLS cluster of three with raft over gRPC, loaded from the generated
    edges ``src``/``dst``.  The caller zeroes the
    launch counts just before and reads them just after, with both query
    caches detached and the served engine per level."""
    import shutil
    import ssl

    from dgraph_tpu_torch.serve.server import DgraphServer

    t_phase = time.perf_counter()
    has_grpc = grpc_importable()
    if not has_grpc:
        log({"phase": "transports", "grpc": None,
             "why": "grpcio not importable on this machine"})
    grpc = importlib.import_module("grpc") if has_grpc else None
    work = ROOT / "_smoke" / "transports"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cert, key = tls_cert(work)
    rng = np.random.default_rng(TRANSPORT_SEED)
    seeds = np.unique(rng.integers(1, N_NODES + 1, size=LARGE_SEEDS))
    jrng = np.random.default_rng(JOIN_SEED)
    s1, s2 = (np.unique(jrng.integers(1, N_NODES + 1, size=LARGE_SEEDS))
              for _ in range(2))
    queries = {"count": two_hop_count(seeds), "join_a": join_filter_query(s1, s2)}
    check_priced(srv)
    t0 = time.perf_counter()
    ref = host_engine(store)
    want = {n: json.dumps(ref.run(q)) for n, q in queries.items()}
    check(json.loads(want["join_a"]).get("q"), "transports: join (a) matched nothing")
    out = {"card": card, "grpc": has_grpc, "seeds": len(seeds),
           "host_reference_s": time.perf_counter() - t0}
    opened = []  # servers and channels to stop, whatever fails
    try:
        # -- (a) three transports on the main path's server ---------------
        from dgraph_tpu_torch.serve.grpc_server import GrpcServer, make_channel

        def http_json(q):
            status, raw, _h, secs = post_any(srv.addr, q)
            check(status == 200, f"transports: HTTP {status}")
            return raw, secs, False

        def http_binary(q):
            status, raw, h, secs = post_any(srv.addr, q, {"Accept": "application/protobuf"})
            check(status == 200 and h.get("Content-Type") == "application/protobuf",
                  f"transports: binary HTTP {status} {h.get('Content-Type')}")
            return raw, secs, True

        runs = {"http_json": http_json, "http_protobuf": http_binary}
        if has_grpc:
            gsrv = GrpcServer(srv, port=0)
            gsrv.start()
            opened.append(gsrv)
            grun = GrpcRun(f"127.0.0.1:{gsrv.port}")
            opened.append(grun)
            runs["grpc"] = lambda q: (*grun(q), True)
        out["plain"] = served_transports(srv, queries, runs, want, card, "plain", repeats)

        # -- (b) TLS: a second server over the same store and arenas ------
        tsrv = DgraphServer(store, device=device, tls_cert=cert, tls_key=key)
        tsrv.engine.arenas = srv.engine.arenas
        tsrv.start()
        opened.append(tsrv)
        check(tsrv.addr.startswith("https://"), f"transports: TLS addr {tsrv.addr}")
        ctx = ssl.create_default_context(cafile=cert)  # the CA pinned

        def https_json(q):
            status, raw, _h, secs = post_any(tsrv.addr, q, context=ctx)
            check(status == 200, f"transports: HTTPS {status}")
            return raw, secs, False

        truns = {"https_json": https_json}
        tls = {}
        if has_grpc:
            from dgraph_tpu_torch.client import GrpcTransport

            tg = GrpcServer(tsrv, port=0)
            tg.start()
            opened.append(tg)
            trun = GrpcRun(f"localhost:{tg.port}", cafile=cert)
            opened.append(trun)
            truns["grpc_tls"] = lambda q: (*trun(q), True)
            plain = make_channel(f"127.0.0.1:{tg.port}")
            try:
                plain.unary_unary("/protos.Dgraph/CheckVersion")(b"", timeout=10)
                check(False, "transports: a plaintext channel into the TLS listener answered")
            except grpc.RpcError as e:
                tls["plaintext_into_tls"] = str(e.code())
            finally:
                plain.close()
            gt = GrpcTransport(f"localhost:{tg.port}", cafile=cert, timeout=60)
            try:
                tls["check_version"] = gt.check_version()
                check(tls["check_version"].startswith("0.7"),
                      f"transports: CheckVersion {tls['check_version']!r}")
                # (the bulk load bypasses the uid allocator, in the
                # reference too: the lease starts where the allocator
                # stands, not past the loaded uids)
                a, b = gt.assign_uids(TRANSPORT_LEASE)
                check(b - a == TRANSPORT_LEASE - 1 and a > 0,
                      f"transports: AssignUids leased {a}..{b}")
                tls["assign_uids"] = [a, b]
            finally:
                gt.close()
        # the same launches a request as the plain server's JSON surface
        json_launches = {n: (r["http_json"]["gather_launches"][0],
                             r["http_json"]["intersect_launches"][0])
                         for n, r in out["plain"].items()}
        with no_caches(tsrv), per_level(tsrv.engine):
            out["tls"] = served_transports(tsrv, queries, truns, want, card, "tls",
                                           repeats, expect=json_launches)

        # the handshake's cost: a fresh connection each, /health (plain
        # and TLS) and a fresh gRPC channel's first CheckVersion
        def health(addr, context=None):
            with urllib.request.urlopen(addr + "/health", timeout=60, context=context) as r:
                r.read()

        tls["http_connect_ms"] = handshake_ms(lambda: health(srv.addr))
        tls["https_connect_ms"] = handshake_ms(lambda: health(tsrv.addr, ctx))
        if has_grpc:
            def channel(target, cafile=""):
                ch = make_channel(target, cafile)
                try:
                    ch.unary_unary("/protos.Dgraph/CheckVersion")(b"", timeout=60)
                finally:
                    ch.close()

            tls["grpc_connect_ms"] = handshake_ms(
                lambda: channel(f"127.0.0.1:{gsrv.port}"))
            tls["grpc_tls_connect_ms"] = handshake_ms(
                lambda: channel(f"localhost:{tg.port}", cert))
        out["tls_checks"] = tls
        log(dict(phase="transports_tls", card=card, connects=TRANSPORT_CONNECTS, **tls))

        # -- (c) the live count over gRPC Subscribe -----------------------
        if has_grpc:
            out["subscribe"] = transports_subscribe(store, srv, grpc, gsrv, ref, rng, card)

        # -- (d) a TLS cluster of three, raft over gRPC -------------------
        if has_grpc:
            out["cluster"] = transports_cluster(device, grpc, src, dst, cert, key,
                                                work, card)
        out["seconds"] = time.perf_counter() - t_phase
        log(dict(phase="transports", **{k: v for k, v in out.items()
                                         if k not in ("plain", "tls")}))
        return out
    finally:
        for o in reversed(opened):
            o.stop()
        shutil.rmtree(work, ignore_errors=True)


def transports_subscribe(store, srv, grpc, gsrv, ref, rng, card: str) -> dict:
    """(c): a count over ``e`` from TRANSPORT_SUB_SEEDS seeds streamed
    over ``/protos.Dgraph/Subscribe`` (both gates at 1, as in phase
    subscriptions); after one write of TRANSPORT_DELTA edges, the pushed
    Response equals a fresh ``/query``; cancelling the stream drops the
    subscription."""
    import threading as _th

    from dgraph_tpu_torch.ops import gather
    from dgraph_tpu_torch.serve import proto
    from dgraph_tpu_torch.serve.grpc_server import encode_request, make_channel

    check(srv.subs is not None, "subscribe: the server has no registry")
    arenas = srv.engine.arenas
    knobs = (arenas.expand_device_min, arenas.kway_device_min)
    arenas.expand_device_min, arenas.kway_device_min = 1, 1
    seeds = np.unique(rng.integers(1, N_NODES + 1, size=TRANSPORT_SUB_SEEDS))
    q = two_hop_count(seeds)
    ch = make_channel(f"127.0.0.1:{gsrv.port}")
    call = ch.unary_stream("/protos.Dgraph/Subscribe")(encode_request(q),
                                                        timeout=CLUSTER_WAIT_S)
    got = []

    def consume():
        try:
            for m in call:
                got.append((time.perf_counter(), proto.decode_response(m)))
        except grpc.RpcError:
            pass  # the phase cancels the call when done

    t = _th.Thread(target=consume, daemon=True)
    t.start()
    try:
        wait_until(lambda: got, 60, "subscribe: no snapshot frame")
        snap = dict(got[0][1])
        meta = snap.pop("_subscription_")[0]
        check(meta["kind"] == "snapshot", f"subscribe: first frame {meta}")
        status, raw, _s = post(srv.addr, q)
        check(status == 200 and json.dumps(snap) == strip_latency(raw),
              "subscribe: the snapshot differs from /query")
        # TRANSPORT_DELTA edges from first-hop targets of the seeds to
        # uids outside their 2-hop set: the count moves
        ref_arena = ref.arenas.data("e")
        f1 = np.unique(ref_arena.expand_host(ref_arena.rows_for_uids_host(seeds))[0])
        reach = set(two_hop_set(ref_arena, seeds).tolist())
        edges_e = store.peek("e").edges
        adds = []
        for s in rng.choice(f1, size=TRANSPORT_DELTA, replace=False).tolist():
            tgt = int(rng.integers(1, N_NODES + 1))
            while tgt in reach or tgt in edges_e.get(s, ()):
                tgt = int(rng.integers(1, N_NODES + 1))
            adds.append((s, tgt))
        g0 = gather.KERNEL.launches
        status, raw, _s = post(srv.addr, edge_mutation(adds, []))
        ack = time.perf_counter()
        check(status == 200, f"subscribe: the write answered {status}")
        wait_until(lambda: len(got) >= 2, 60, "subscribe: no push after the write")
        t_push, pushed = got[1]
        pushed = dict(pushed)
        pmeta = pushed.pop("_subscription_")[0]
        check(pmeta["kind"] == "update" and pmeta["preds"] == "e",
              f"subscribe: pushed {pmeta}")
        status, raw, _s = post(srv.addr, q)
        check(status == 200 and json.dumps(pushed) == strip_latency(raw),
              "subscribe: the pushed Response differs from a fresh /query")
        check(pushed != snap, "subscribe: the write left the count unchanged")
        host_engine_advanced(store, ref, adds)
        launches = gather.KERNEL.launches - g0
        check(launches >= 1, "subscribe: the re-evaluation launched no gather")
        sid = meta["sub_id"]
        call.cancel()
        t.join(timeout=30)
        dropped = wait_until(lambda: srv.subs.get(sid) is None, 30,
                             "subscribe: the subscription outlived its stream")
        out = {"seeds": len(seeds), "edges_written": len(adds),
               "push_ms": (t_push - ack) * 1e3, "count_before": snap["q"][0]["count"],
               "count_after": pushed["q"][0]["count"],
               "gather_launches_write_to_check": launches,
               "dropped_after_cancel_s": dropped, "card": card}
        log(dict(phase="transports_subscribe", **out))
        return out
    finally:
        call.cancel()
        ch.close()
        arenas.expand_device_min, arenas.kway_device_min = knobs


def transports_cluster(device, grpc, src, dst, cert, key, work: Path, card: str) -> dict:
    """(d): three servers on ``device`` with TLS listeners, ``https://``
    peers pinned by ``peer_ca``, raft over the gRPC Worker plane (TLS)
    and phase cluster's ``GroupConfig``; groups placed ``TLS_TRIO_GROUPS``: the
    count's ``e`` (group 1) on all three, ``name`` (group 2) on node 3
    alone.  Loads every TLS_TRIO_SHARE-th generated edge and the names of
    uids 1..PAIR_NAMED; the count over gRPC from a group-1 follower; a
    write of TRANSPORT_DELTA edges; one traced read over gRPC on node 1
    that pulls ``name`` from node 3, its trace holding both nodes'
    spans."""
    import ssl

    from dgraph_tpu_torch import obs
    from dgraph_tpu_torch.client import GrpcTransport
    from dgraph_tpu_torch.cluster.groups import GroupConfig
    from dgraph_tpu_torch.cluster.service import ClusterService, parse_peer_groups
    from dgraph_tpu_torch.models import PostingStore
    from dgraph_tpu_torch.ops import gather
    from dgraph_tpu_torch.serve.grpc_server import GrpcServer
    from dgraph_tpu_torch.serve.server import DgraphServer
    from dgraph_tpu_torch.utils.metrics import NUM_GRPC_RAFT

    t_boot = time.perf_counter()
    csrc, cdst = src[::TLS_TRIO_SHARE], dst[::TLS_TRIO_SHARE]
    items = name_items(PAIR_NAMED)
    schema = "e: uid .\nname: string @index(term) ."
    ref_store = PostingStore()
    ref_store.apply_schema(schema)
    ref_store.bulk_set_uid_edges("e", csrc, cdst)
    ref_store.bulk_set_values("name", items)
    ref = host_engine(ref_store)
    rng = np.random.default_rng(TRANSPORT_SEED + 1)
    seeds = np.unique(rng.integers(1, N_NODES + 1, size=LARGE_SEEDS))
    q_count = two_hop_count(seeds)
    small = np.unique(rng.integers(1, PAIR_NAMED + 1, size=SMALL_SEEDS))
    q_names = "{ q(func: uid(%s)) { uid e { uid name } } }" % uid_list(small)
    want = json.dumps(ref.run(q_count))
    ctx = ssl.create_default_context(cafile=cert)  # the CA pinned
    patience = os.environ.get("DGRAPH_TPU_PROPOSE_TIMEOUT")
    os.environ["DGRAPH_TPU_PROPOSE_TIMEOUT"] = str(CLUSTER_WAIT_S)
    frames0 = NUM_GRPC_RAFT.value()
    ports = free_port_pairs(3, 1000)
    peers = {str(i + 1): f"https://127.0.0.1:{p}" for i, p in enumerate(ports)}
    servers, gsrvs = [], []
    try:
        for i, p in enumerate(ports):
            nid = str(i + 1)
            svc = ClusterService(
                node_id=nid, my_addr=peers[nid], peers=peers,
                group_ids=[int(g) for g in
                           parse_peer_groups(TLS_TRIO_GROUPS)[nid]],
                directory=str(work / "cluster" / f"n{nid}"),
                group_config=GroupConfig.parse(CLUSTER_CONF),
                peer_groups=parse_peer_groups(TLS_TRIO_GROUPS), tick_ms=CLUSTER_TICK_MS,
                peer_ca=cert, raft_transport="grpc", grpc_port_offset=1000,
                secret="transports")
            svc.start()
            s = DgraphServer(svc.store, port=p, device=device, cluster=svc,
                             tls_cert=cert, tls_key=key)
            s.start()
            servers.append(s)
            g = GrpcServer(s, port=p + 1000)
            g.start()
            gsrvs.append(g)
        wait_until(lambda: all(s.cluster.has_leader() for s in servers), 60,
                   "tls cluster: no raft leader elected")
        boot_s = time.perf_counter() - t_boot
        for s in servers:
            s.engine.expand_device_min = 1
            s.engine.arenas.kway_device_min = 1
            s.engine.arenas.hop_cache = None
        f1 = group_follower(servers, 1)
        post_retry(f1.addr, "mutation { schema { %s } }" % schema.replace("\n", " "),
                   context=ctx)
        order = np.argsort(csrc, kind="stable")
        bsrc, bdst = csrc[order], cdst[order]
        retries = []
        replicate_s = replicate(servers, 1, "e", lambda: [propose_retry(
            lambda i=i: f1.store.bulk_set_uid_edges(
                "e", bsrc[i:i + CLUSTER_RECORD_EDGES], bdst[i:i + CLUSTER_RECORD_EDGES]),
            retries) for i in range(0, len(bsrc), CLUSTER_RECORD_EDGES)])
        owner = servers[2]
        propose_retry(lambda: owner.store.bulk_set_values("name", items), retries)
        # the count over gRPC (TLS, the CA pinned) from a group-1 follower
        fg = gsrvs[servers.index(f1)]
        t = GrpcTransport(f"localhost:{fg.port}", cafile=cert, timeout=CLUSTER_WAIT_S)
        try:
            def count_is(body):
                got = t.run(q_count)
                got.pop("server_latency", None)
                return json.dumps(got) == body

            g0 = gather.KERNEL.launches
            first_s = wait_until(lambda: count_is(want), CLUSTER_WAIT_S,
                                 "tls cluster: the follower never answered the count",
                                 step=0.5)
            lat = []
            for _ in range(TRANSPORT_REPEATS):
                t0 = time.perf_counter()
                check(count_is(want), "tls cluster: the count differs from the host route")
                lat.append((time.perf_counter() - t0) * 1e3)
            check(gather.KERNEL.launches > g0, "tls cluster: the count launched no gather")
            # the write, over HTTPS through node 3; every node converges
            adds, dels = delta_edges(ref_store, seeds, TRANSPORT_DELTA,
                                     np.random.default_rng(TRANSPORT_SEED + 2))
            _raw, write_s = post_retry(owner.addr, edge_mutation(adds, dels),
                                       context=ctx)
            apply_edges(ref_store, adds, dels)
            new = json.dumps(ref.run(q_count))
            check(new != want, "tls cluster: the write left the count unchanged")
            converge_s = wait_until(lambda: count_is(new), CLUSTER_WAIT_S,
                                    "tls cluster: the follower never saw the write",
                                    step=0.2)
        finally:
            t.close()
        # one traced read over gRPC on node 1: name lives on node 3 alone
        want_names = json.dumps(ref.run(q_names))
        rec = obs.configure(ratio=1e-9)  # armed: the metadata decides
        try:
            tid = "%032x" % (TRANSPORT_SEED << 40 | 0x7D)
            run = GrpcRun(f"localhost:{gsrvs[0].port}", cafile=cert)
            try:
                raw, read_s = run(q_names, metadata=(
                    ("traceparent", f"00-{tid}-{tid[16:]}-01"),))
            finally:
                run.stop()
            check(pb_tree(raw) == want_names,
                  "tls cluster: the traced read differs from the host route")
            spans = {}

            def legs():
                tr = rec.trace(tid)
                if tr is None:
                    return False
                spans["all"] = tr["spans"]
                nodes = {s["attrs"].get("node") for s in tr["spans"]}
                return {"1", "3"} <= nodes and any(
                    s["name"] == "peer.pred-snapshot" and s["attrs"].get("node") == "3"
                    for s in tr["spans"])

            wait_until(legs, 30, "tls cluster: the trace holds no span of node 3")
            sp = spans["all"]
            check(all(s["trace_id"] == tid for s in sp), "tls cluster: a span off the trace")
        finally:
            obs.configure()
        frames = NUM_GRPC_RAFT.value() - frames0
        check(frames > 0, "tls cluster: no raft frame crossed the gRPC Worker plane")
        out = {"servers": 3, "groups": TLS_TRIO_GROUPS, "conf": CLUSTER_CONF,
               "edges": int(len(csrc)), "edge_sample": f"every {TLS_TRIO_SHARE}th",
               "named": PAIR_NAMED, "raft_transport": "grpc", "tls": True,
               "boot_s": boot_s, "replicate_s": replicate_s, "retried": len(retries),
               "count_first_answer_s": first_s, "count_p50_ms": float(np.percentile(lat, 50)),
               "count_request_ms": lat, "write_ack_s": write_s,
               "write_converged_s": converge_s, "traced_read_ms": read_s * 1e3,
               "trace_spans": len(sp), "trace_names": sorted({s["name"] for s in sp}),
               "trace_nodes": sorted({s["attrs"]["node"] for s in sp if "node" in s["attrs"]}),
               "dgraph_grpc_raft_frames_total": frames, "card": card}
        log(dict(phase="transports_cluster", **out))
        return out
    finally:
        for g in gsrvs:
            g.stop()
        for s in servers:
            s.stop()
        if patience is None:
            os.environ.pop("DGRAPH_TPU_PROPOSE_TIMEOUT", None)
        else:
            os.environ["DGRAPH_TPU_PROPOSE_TIMEOUT"] = patience



# -- phases 8-9: the query surface --------------------------------------------


def phase_ranks(store, srv, n_ranked: int) -> None:
    """An int ``rank`` on uids 1..n_ranked, written into the served store,
    and the server's value arena built."""
    from dgraph_tpu_torch.models.store import Edge
    from dgraph_tpu_torch.models.types import TypeID, TypedValue

    t0 = time.perf_counter()
    vals = np.random.default_rng(RANK_SEED).integers(0, RANK_RANGE, size=n_ranked)
    store.apply_schema("rank: int .")
    store.apply_many(Edge("rank", u, value=TypedValue(TypeID.INT, v))
                     for u, v in enumerate(vals.tolist(), 1))
    t1 = time.perf_counter()
    va = srv.engine.arenas.values("rank")
    t2 = time.perf_counter()
    log({"phase": "ranks", "ranked_nodes": n_ranked, "range": RANK_RANGE,
         "distinct_values": int(len(np.unique(vals))), "seed": RANK_SEED,
         "value_arena_slots": int(va.src.shape[0]), "device": str(va.src.device),
         "load_s": round(t1 - t0, 3), "value_arena_s": round(t2 - t1, 3)})


def two_hop_ring(arena, s: int):
    """The nodes exactly two hops from ``s`` (not one, not ``s``), each
    with the number of its paths from ``s``."""
    n1, _ = arena.expand_host(arena.rows_for_uids_host(np.array([s])))
    n2, _ = arena.expand_host(arena.rows_for_uids_host(np.unique(n1)))
    return np.unique(n2[~np.isin(n2, n1) & (n2 != s)], return_counts=True)


def shortest_ends(arena, seeds):
    """(from, to, paths): the first seed with a node two hops away (not
    one) reached through at least three distinct middles, and that node
    (the most reached, then the smallest): numpaths 3 finds its paths
    without leaving the seed's 2-hop ring."""
    for s in seeds.tolist():
        uniq, cnt = two_hop_ring(arena, s)
        if len(cnt) and cnt.max() >= 3:
            return s, int(uniq[np.argmax(cnt)]), int(cnt.max())
    raise SmokeFailure("no seed has a node two hops away by three paths")


def serve_surface(srv, ref, name: str, q: str, repeats: int, card: str) -> dict:
    """Serve ``q`` ``repeats`` times, hold the last body against the host
    route, then read the engine's stats from one ``?debug=true`` request;
    logs and returns the query's line."""
    from dgraph_tpu_torch.ops import gather

    n0 = gather.KERNEL.launches
    lat = []
    for _ in range(repeats):
        status, raw, secs = post(srv.addr, q)
        check(status == 200, f"{name}: HTTP {status}: {raw[:300]!r}")
        lat.append(secs)
    launches = gather.KERNEL.launches - n0
    want = json.dumps(ref.run(q))
    check(strip_latency(raw) == want, f"{name} body differs from the host route")
    _status, raw, _secs = post(srv.addr, q, "?debug=true")
    eng = json.loads(raw)["server_latency"]["engine"]
    row = {"query": name, "repeats": repeats,
           "p50_ms": float(np.percentile(lat, 50)) * 1e3,
           "p99_ms": p99([x * 1e3 for x in lat]),
           "request_ms": [x * 1e3 for x in lat], "body_bytes": len(want),
           "objects": {k: len(v) for k, v in json.loads(want).items()},
           "gather_launches": launches, "gather_launches_per_query": launches / repeats,
           "device_order": eng["device_order"], "device_order_ms": eng["device_order_ms"],
           "routes": eng["routes"], "edges": eng["edges"],
           "device_expand_ms": eng["device_expand_ms"],
           "host_expand_ms": eng["host_expand_ms"], "encode_ms": eng["encode_ms"],
           "expand_device_min": srv.engine.expand_device_min,
           "planner": eng.get("planner", []),
           "byte_identical_to_host_route": True, "card": card}
    log(dict(phase="query_surface", route="per_level", **row))
    return row


def phase_query_surface(store, srv, n_ranked: int, card: str) -> dict:
    """The served @recurse, shortest, @groupby and order-by; the caller
    zeroes the launch counts just before.  ``card`` is the nvidia-smi
    name and power limit."""
    gate = srv.engine.expand_device_min
    check_priced(srv)
    ref = host_engine(store)
    arena = srv.engine.arenas.data("e")
    rng = np.random.default_rng(SURFACE_SEED)
    large = np.unique(rng.integers(1, N_NODES + 1, size=LARGE_SEEDS))
    small = np.unique(rng.integers(1, N_NODES + 1, size=SMALL_SEEDS))
    rows = {}

    def serve(name, q, repeats=SURFACE_REPEATS):
        rows[name] = serve_surface(srv, ref, name, q, repeats, card)
        return rows[name]

    # (a) order-by over the value arena
    for name, q, on_card in (
        ("order_root", "{ q(func: has(rank), orderasc: rank, first: 100) "
                       "{ uid rank } }", True),
        ("order_child_2hop", "{ q(func: uid(%s)) { e { e (orderdesc: rank, "
                             "first: 2) { uid } } } }" % uid_list(large), True),
        ("order_offset_after", "{ q(func: has(rank), orderdesc: rank, offset: "
                               "1000, first: 50, after: 0x%x) { uid rank } }"
                               % (n_ranked // 2), False),
    ):
        row = serve(name, q)
        check(row["objects"]["q"] > 0, f"{name} answered nothing")
        if on_card:
            check(row["device_order"] >= 1, f"{name} did not sort on the card")
    # (b) @recurse: its second level crosses the device gate
    row = serve("recurse_depth2",
                "{ q(func: uid(%s)) @recurse(depth: 2) { uid rank e } }"
                % uid_list(large), RECURSE_REPEATS)
    check(row["gather_launches"] >= RECURSE_REPEATS,
          "the @recurse did not launch the gather kernel")
    check(any(d["kind"] == "expand" and d["route"] == "resident"
              for d in row["planner"]), "the @recurse recorded no resident expand")
    check(row["edges"] < RECURSE_MAX_EDGES,
          f"the @recurse walked {row['edges']} edges, the cap is {RECURSE_MAX_EDGES}")
    # (c) shortest, as the server stands and with every expansion on the card
    src, dst, n_paths = shortest_ends(arena, large)
    for k in (1, 3):
        q = ("{ shortest(from: 0x%x, to: 0x%x, numpaths: %d) { e } }" % (src, dst, k))
        serve(f"shortest_k{k}", q)
        srv.engine.expand_device_min = 1
        try:
            row = serve(f"shortest_k{k}_gate1", q)
        finally:
            srv.engine.expand_device_min = gate
        check(row["gather_launches"] > 0,
              f"shortest k {k} at gate 1 did not launch the gather kernel")
        check(row["objects"]["_path_"] == k, f"shortest k {k}: not {k} paths")
    # (d) @groupby at the root and under a child, by value and by uid edge
    for attr in ("rank", "e"):
        serve(f"groupby_root_{attr}", "{ q(func: uid(%s)) @groupby(%s) "
              "{ count(uid) } }" % (uid_list(large), attr))
        serve(f"groupby_child_{attr}", "{ q(func: uid(%s)) { e @groupby(%s) "
              "{ count(uid) } } }" % (uid_list(small), attr))
    return {"rows": rows, "shortest": {"from": src, "to": dst, "two_hop_paths": n_paths},
            "large_seeds": large}


# -- phase 9a: the engine's routes -------------------------------------------


@contextlib.contextmanager
def pinned_route(engine, route: str):
    """The served engine (and so every scheduled shell) steered onto
    ``route``: its resident gate and fused hop."""
    ex = engine.expander
    before = (ex.resident_mode, ex.fused_hop)
    ex.resident_mode, ex.fused_hop = ROUTE_PINS[route]
    try:
        yield
    finally:
        ex.resident_mode, ex.fused_hop = before


def ordered_root(q: str) -> str:
    """``q`` with its first root, a ``uid(...)`` list, ordered by rank:
    the permuted frontier that a deployment sends to the csr route."""
    return q.replace("))", "), orderasc: rank)", 1)


def inline_q1_inputs(arena, seeds):
    """The slot map's (cs, cd, capc) at the inline route's largest hop of
    the count from ``seeds`` (its second level): Q = 1, pcap the padded
    frontier."""
    import torch

    from dgraph_tpu_torch import ops
    from dgraph_tpu_torch.ops.sets import ov_slotmap_inputs

    out1, _ = arena.expand_host(arena.rows_for_uids_host(seeds))
    rows = arena.rows_for_uids_host(np.unique(out1))
    B = ops.bucket(len(rows))
    capc = ops.bucket(max(1, int(arena.ov_chunk_degree_of_rows(rows).sum())))
    metap, _ov = arena.inline_layout()
    rt = torch.from_numpy(ops.pad_rows(rows, B)).to(metap.device)
    cs, cd = ov_slotmap_inputs(metap, rt, B)
    return cs[None].contiguous(), cd[None].contiguous(), capc


def strip_debug_uids(obj):
    """A body's tree without its ``_uid_`` keys: the ones ``?debug=true``
    attaches to every node, and the ones a ``uid`` in the query asks
    for (both render under that key)."""
    if isinstance(obj, dict):
        return {k: strip_debug_uids(v) for k, v in obj.items() if k != "_uid_"}
    if isinstance(obj, list):
        return [strip_debug_uids(v) for v in obj]
    return obj


def phase_routes(store, srv, card: str) -> dict:
    """The count from 8192 seeds, the materialised 2-hop from 64 and the
    child order-by 2-hop, each forced in turn through the classed,
    inline and resident routes, and with its root ordered by rank
    through csr (``ordered_root``), every hop on the card (the gate at
    1, the chain pinned off, the caches detached by the caller), the
    routes alternating request by request, 2 requests a route: one with
    ``?ledger=true`` (its hops by route) and one with ``?debug=true``
    (the engine's routes).  Every body must equal the host route's (the
    debug one with both trees' ``_uid_`` keys left out), every hop must
    name the forced route (or ``empty``; on the csr row, ``inline`` for
    the ascending levels below the ordered root), every inline hop must
    launch the slot map once and every resident hop the gather once."""
    from dgraph_tpu_torch.ops import gather, slotmap

    t0 = time.perf_counter()
    ref = host_engine(store)
    rng = np.random.default_rng(ROUTES_SEED)
    large = np.unique(rng.integers(1, N_NODES + 1, size=LARGE_SEEDS))
    small = np.unique(rng.integers(1, N_NODES + 1, size=SMALL_SEEDS))
    queries = {
        "count_8192": two_hop_count(large),
        "materialised_2hop_64": two_hop(small),
        "child_order_2hop": "{ q(func: uid(%s)) { e { e (orderdesc: rank, "
                            "first: 2) { uid } } } }" % uid_list(large),
    }
    asked = {r: {n: ordered_root(q) if r == "csr" else q
                 for n, q in queries.items()} for r in ROUTE_PINS}
    want = {r: {n: json.dumps(ref.run(q)) for n, q in by.items()}
            for r, by in asked.items() if r in ("csr", "resident")}
    want.update({r: want["resident"] for r in ("classed", "inline")})
    ref_s = time.perf_counter() - t0
    eng = srv.engine
    gate, thr = eng.expand_device_min, eng.chain_threshold
    eng.expand_device_min, eng.chain_threshold = 1, PINNED_OFF
    lat = {r: {n: [] for n in queries} for r in ROUTE_PINS}
    hops = {r: {n: {} for n in queries} for r in ROUTE_PINS}
    launches = {r: {"slotmap": 0, "gather": 0} for r in ROUTE_PINS}
    try:
        for name in queries:
            for params in ("?ledger=true", "?debug=true"):
                for route in ROUTE_PINS:
                    what = f"routes {name} ({route}, {params})"
                    n0 = (slotmap.KERNEL.launches, gather.KERNEL.launches)
                    with pinned_route(eng, route):
                        status, raw, secs = post(srv.addr, asked[route][name], params)
                    n1 = (slotmap.KERNEL.launches, gather.KERNEL.launches)
                    check(status == 200, f"{what}: HTTP {status}: {raw[:300]!r}")
                    body = json.loads(raw)
                    if params == "?ledger=true":
                        h = body["extensions"]["ledger"]["hops"]
                        check(strip_latency(raw) == want[route][name],
                              f"{what}: body differs from the host route")
                    else:
                        h = body["server_latency"]["engine"]["routes"]
                        body.pop("server_latency")
                        check(strip_debug_uids(body)
                              == strip_debug_uids(json.loads(want[route][name])),
                              f"{what}: body differs from the host route")
                    allowed = {route, "empty"} | ({"inline"} if route == "csr" else set())
                    check(set(h) <= allowed and h.get(route, 0) > 0,
                          f"{what}: hops {h}")
                    sm, ga = n1[0] - n0[0], n1[1] - n0[1]
                    check(sm == h.get("inline", 0), f"{what}: {sm} slot-map "
                          f"launches for {h.get('inline', 0)} inline hops")
                    check(ga == h.get("resident", 0), f"{what}: {ga} gather "
                          f"launches for {h.get('resident', 0)} resident hops")
                    launches[route]["slotmap"] += sm
                    launches[route]["gather"] += ga
                    lat[route][name].append(secs)
                    for k, v in h.items():
                        hops[route][name][k] = hops[route][name].get(k, 0) + v
    finally:
        eng.expand_device_min, eng.chain_threshold = gate, thr
    p50 = {r: {n: float(np.percentile(v, 50)) * 1e3 for n, v in by.items()}
           for r, by in lat.items()}
    out = {"p50_ms": p50, "hops": hops, "launches": launches,
           "host_reference_s": ref_s, "seconds": time.perf_counter() - t0,
           "card": card}
    log({"phase": "routes", "p50_ms": p50, "card": card})
    log(dict(phase="routes_detail", **{k: v for k, v in out.items() if k != "p50_ms"}))
    out["large_seeds"] = large
    return out


def inline_slotmap_timing(arena, seeds, card: str) -> dict:
    """The slot map at the inline route's Q = 1 shape (the count's second
    hop from ``seeds``), held against its plain version and timed: the
    wrapper's times (``kernel_times``), the plain version's and the
    bytes bound.  Its launches are the comparison's, after the route's
    counts were read."""
    import torch

    from dgraph_tpu_torch.ops import slotmap

    cs, cd, capc = inline_q1_inputs(arena, seeds)
    check(torch.equal(slotmap.slotmap(cs, cd, capc), slotmap.slotmap_plain(cs, cd, capc)),
          "slot map != plain version at the inline route's Q = 1 shape")
    # the function reads cs and cd once and writes the map once
    nbytes = 4 * (2 * cs.shape[1] + capc)
    out = {"Q": 1, "pcap": int(cs.shape[1]), "capc": int(capc),
           "total": int(cd.sum()), "bytes": nbytes,
           **kernel_times(lambda: slotmap.slotmap(cs, cd, capc), kernel="slotmap_tiles"),
           "plain_ms": cuda_ms(lambda: slotmap.slotmap_plain(cs, cd, capc)),
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "card": card}
    log(dict(phase="inline_slotmap_timing", **out))
    return out


# -- phase 9b: the rest of the server and the CLI ------------------------------


def phase_cli_surface(device, card: str) -> dict:
    """A small graph of its own, in the git-ignored ``_smoke/cli``
    (removed at the end): ``python -m dgraph_tpu_torch.cli.server`` booted
    with ``--config`` (a YAML that sets its port, its directories and no
    gRPC listener), ``--dumpsg``, ``--cpu`` and ``--mem``, loaded by
    ``python -m dgraph_tpu_torch.cli.loader``; ``GET /`` must be the
    console page, a share must round-trip, a query must write one dump,
    both profiles must exist after ``/admin/shutdown``, and ``python -m
    dgraph_tpu_torch.cli.posting_iterator`` must print exactly the lines
    of ``/admin/export``."""
    import gzip
    import shutil

    from dgraph_tpu_torch.serve.dashboard import DASHBOARD_HTML

    t0 = time.perf_counter()
    work = ROOT / "_smoke" / "cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    rng = np.random.default_rng(CLI_SEED)
    src = rng.integers(1, CLI_UIDS + 1, size=CLI_EDGES)
    dst = rng.integers(1, CLI_UIDS + 1, size=CLI_EDGES)
    words = rng.integers(0, len(VOCAB), size=(CLI_UIDS, NAME_WORDS))
    rdf = work / "cli.rdf.gz"
    with gzip.open(rdf, "wt") as f:
        for a, b in zip(src.tolist(), dst.tolist()):
            f.write("<0x%x> <f> <0x%x> .\n" % (a, b))
        for u, row in enumerate(words, 1):
            f.write('<0x%x> <name> "%s" .\n' % (u, " ".join(VOCAB[w] for w in row)))
    schema = work / "schema.txt"
    schema.write_text("name: string @index(term) .\nf: uid .\n")
    port = free_ports(1)[0]
    conf = work / "conf.yaml"
    conf.write_text(f"port: {port}\ngrpc_port: -1\npostings_dir: {work / 'p'}\n"
                    f"export_path: {work / 'export'}\n")
    paths = {"sg": work / "sg", "cpu": work / "cpu.pstats", "mem": work / "mem.txt"}
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    log_path = work / "server.log"
    out = {"card": card}
    with open(log_path, "ab") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "dgraph_tpu_torch.cli.server", "--config", str(conf),
             "--device", str(device), "--dumpsg", str(paths["sg"]),
             "--cpu", str(paths["cpu"]), "--mem", str(paths["mem"])],
            cwd=str(ROOT), stdout=subprocess.PIPE, stderr=err, text=True, env=env)
    try:
        addr = None
        lines = []
        while addr is None:
            line = proc.stdout.readline()
            check(line != "", f"the CLI server exited before serving: {lines} "
                              f"{log_path.read_text()[-2000:]}")
            lines.append(line.strip())
            if line.startswith("serving on "):
                addr = line.split()[2]
        check(addr == f"http://127.0.0.1:{port}", f"--config did not set the port: {addr}")
        out["boot_s"] = time.perf_counter() - t0
        r = subprocess.run(
            [sys.executable, "-m", "dgraph_tpu_torch.cli.loader", "-r", str(rdf),
             "-s", str(schema), "-d", addr],
            cwd=str(ROOT), capture_output=True, text=True, timeout=300, env=env)
        check(r.returncode == 0, f"loader failed: {r.stderr[-2000:]}")
        with urllib.request.urlopen(addr + "/", timeout=60) as resp:
            page = resp.read().decode()
        check(page == DASHBOARD_HTML, "GET / is not the console page")
        text = "{ q(func: has(name)) { count() } }"
        req = urllib.request.Request(addr + "/share", data=text.encode(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            sid = json.loads(resp.read())["uids"]["share"]
        check(get_json(addr, f"/share/{sid}") == {"share": text}, "the share did not round-trip")
        n_dumps = len(os.listdir(paths["sg"])) if paths["sg"].exists() else 0
        seeds = np.unique(src)[:16]
        q = ("{ q(func: uid(%s)) { uid name f { uid name f { uid } } } }"
             % uid_list(seeds))
        status, raw, _secs = post(addr, q)
        check(status == 200 and json.loads(raw)["q"], f"query: HTTP {status}: {raw[:200]!r}")
        dumps = sorted(os.listdir(paths["sg"]))
        check(len(dumps) == n_dumps + 1, f"{len(dumps) - n_dumps} dumps for one query")
        dump = json.loads((paths["sg"] / dumps[-1]).read_text())
        check(dump[0]["n_dest"] == len(seeds), f"the dump's root: {dump[0]}")
        exp = get_json(addr, "/admin/export")
        with gzip.open(exp["rdf"], "rt") as f:
            export_lines = f.read().splitlines()
        get_json(addr, "/admin/shutdown")
        proc.wait(timeout=120)
        check(proc.returncode == 0, f"the CLI server exited {proc.returncode}")
        rest = proc.stdout.read()
        for k in ("cpu", "mem"):
            check(paths[k].exists() and paths[k].stat().st_size > 0,
                  f"no {k} profile after shutdown: {rest}")
        t1 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "dgraph_tpu_torch.cli.posting_iterator",
             "--p", str(work / "p")],
            cwd=str(ROOT), capture_output=True, text=True, timeout=300, env=env)
        check(r.returncode == 0, f"posting iterator failed: {r.stderr[-2000:]}")
        check(r.stdout.splitlines() == export_lines,
              "the posting iterator's lines differ from /admin/export's")
        out.update(iterator_s=time.perf_counter() - t1, lines=len(export_lines),
                   dump_root=dump[0], cpu_profile_bytes=paths["cpu"].stat().st_size,
                   mem_profile_bytes=paths["mem"].stat().st_size,
                   seconds=time.perf_counter() - t0)
    finally:
        import signal

        end_proc(proc, signal.SIGTERM)
        shutil.rmtree(work, ignore_errors=True)
    log(dict(phase="cli_surface", **out))
    return out


# -- phases 10-11: the fused chain --------------------------------------------


def chain_seeds():
    """The chain phase's seeds, drawn with a seed of their own: 8192 for
    (a)-(d), 1024 for (f), and for (e) the largest of 8192, 4096, 2048 and
    1024 draws whose 2-level edge bound the fused BFS admits (its bound
    sums the top-m degrees of each level, so 8192 seeds can exceed the
    10^6 recursion cap while their real walk does not)."""
    rng = np.random.default_rng(CHAIN_SEED)
    large = np.unique(rng.integers(1, N_NODES + 1, size=LARGE_SEEDS))
    small = np.unique(rng.integers(1, N_NODES + 1, size=1024))
    by_size = {k: np.unique(rng.integers(1, N_NODES + 1, size=k))
               for k in (8192, 4096, 2048, 1024)}
    return large, small, by_size


def recurse_seeds(arena, by_size):
    """(seeds, cap) for (e): see ``chain_seeds``."""
    from dgraph_tpu_torch.query.recurse import fused_cap

    for k, seeds in by_size.items():
        cap = fused_cap(arena, len(seeds), 2)
        if cap is not None:
            return seeds, cap
    raise SmokeFailure("the fused BFS admits none of the (e) seed draws")


def phase_multi_hop_kernels(arena, large, rseeds, rcap) -> int:
    """ops.multi_hop on the card == the same call on the CPU (the
    gather's plain version), exactly, one gather launch a hop: from
    (a)'s seeds at the capacity the chain plans for them, from (e)'s with
    the visited set at the fused BFS's capacity, and from a drained
    frontier (uids above every row) both ways.  Returns the max
    |card - CPU|."""
    import torch

    from dgraph_tpu_torch import ops
    from dgraph_tpu_torch.ops import gather
    from dgraph_tpu_torch.query import chain
    from dgraph_tpu_torch.query.recurse import fused_cap

    ra = arena.resident()
    lut = arena.lut()
    est = int(arena.degree_of_rows(arena.rows_for_uids_host(large)).sum())
    drained = np.arange(N_NODES + 1, N_NODES + 1001, dtype=np.int64)
    cases = [("a_frontier", large, chain.scan_cap(arena, len(large), est, 2), False),
             ("e_frontier_bfs", rseeds, rcap, True),
             ("drained", drained, chain.scan_cap(arena, len(drained), 0, 2), False),
             ("drained_bfs", drained, fused_cap(arena, len(drained), 2), True)]
    cpu = [t.cpu() for t in (ra.off, ra.dst, lut)]
    results, max_err = [], 0
    for name, f0, cap, tv in cases:
        f = torch.from_numpy(ops.pad_to(f0, cap))
        vis = f if tv else torch.full((cap,), ops.SENT, dtype=torch.int32)
        want = ops.multi_hop(cpu[0], cpu[1], f, vis, 2, cap, tv, cpu[2])
        torch.cuda.synchronize()
        n0 = gather.KERNEL.launches
        got = ops.multi_hop(ra.off, ra.dst, f.cuda(), vis.cuda(), 2, cap, tv, lut)
        torch.cuda.synchronize()
        check(gather.KERNEL.launches == n0 + 2, f"multi_hop on {name}: not 2 gather launches")
        err = max(int((g.cpu().to(torch.int64) - w.to(torch.int64)).abs().max())
                  for g, w in zip(got, want))
        max_err = max(max_err, err)
        check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
              f"multi_hop on the card != its CPU run on {name}")
        results.append({"case": name, "frontier": len(f0), "cap": cap,
                        "track_visited": tv, "edges_by_hop": want[1].tolist(),
                        "max_abs_err": err})
    check(results[2]["edges_by_hop"] == [0, 0], "the drained frontier walked edges")
    log({"phase": "multi_hop_kernels", "kernel": "gather_packed (ops.multi_hop)",
         "tolerance": 0, "cases": results})
    return max_err


def p99(ms):
    """The p99 of request times ``ms``, or None below P99_MIN requests,
    where it would be no more than the largest one."""
    return float(np.percentile(ms, 99)) if len(ms) >= P99_MIN else None


def latency_summary(lat) -> dict:
    """ms figures of a list of request seconds: every request, min, p50,
    max, and p99 only where there are enough requests
    (P99_MIN) for it to be more than the largest one."""
    ms = [x * 1e3 for x in lat]
    out = {"requests": len(ms), "min_ms": min(ms),
           "p50_ms": float(np.percentile(ms, 50)), "max_ms": max(ms)}
    if len(ms) >= P99_MIN:
        out["p99_ms"] = p99(ms)
    return {**out, "request_ms": ms}


def serve_routes(srv, name: str, q: str, want: str, hops: list,
                 repeats: int, both: bool) -> dict:
    """Serve ``q`` ``repeats`` times on the fused route and, with
    ``both``, as many times with the chain pinned off, alternating route
    by route request by request so that a drift of the host's speed
    weighs on both alike; each body is held against ``want``.  Then one
    ``?debug=true`` request a route for the engine's stats.  ``hops[0]``
    counts ``ops.multi_hop`` calls.  Returns {route: figures}."""
    from dgraph_tpu_torch.ops import gather, kway

    routes = ["fused", "per_level"] if both else ["fused"]
    lat = {r: [] for r in routes}
    launches = {r: [0, 0, 0] for r in routes}

    def on(route):
        return per_level(srv.engine) if route == "per_level" else contextlib.nullcontext()

    for _ in range(repeats):
        for r in routes:
            n0 = (gather.KERNEL.launches, kway.KERNEL.launches, hops[0])
            with on(r):
                status, raw, secs = post(srv.addr, q)
            n1 = (gather.KERNEL.launches, kway.KERNEL.launches, hops[0])
            check(status == 200, f"{name} ({r}): HTTP {status}: {raw[:300]!r}")
            check(strip_latency(raw) == want, f"{name} ({r}) body differs from the host route")
            lat[r].append(secs)
            launches[r] = [c + y - x for c, x, y in zip(launches[r], n0, n1)]
    out = {}
    for r in routes:
        with on(r):
            _status, raw, _secs = post(srv.addr, q, "?debug=true")
        eng = json.loads(raw)["server_latency"]["engine"]
        per = [c / repeats for c in launches[r]]
        out[r] = {**latency_summary(lat[r]),
                  "gather_launches_per_query": per[0],
                  "intersect_launches_per_query": per[1],
                  "multi_hop_calls_per_query": per[2],
                  **{k: eng[k] for k in (
                      "chain_ms", "chain_fused_levels", "chain_reject",
                      "fused_gathers", "routes", "edges", "kway_device",
                      "device_expand_ms", "host_expand_ms", "encode_ms")},
                  "planner": eng.get("planner", [])}
    return out


def phase_chain(store, srv, large, small, rseeds, card: str) -> dict:
    """The served fused chain; the caller zeroes the launch counts just
    before.  ``card`` is the nvidia-smi name and power limit."""
    from dgraph_tpu_torch import ops

    eng = srv.engine
    check_priced(srv, chain=True)
    check(eng.expander.fused_hop != "0", "the server must run with fused hops on")
    ref = host_engine(store)
    # (name, query, fused levels, gathers a request, multi-hop calls a
    # request, served per level as well, requests a route)
    many, few = CHAIN_REPEATS, CHAIN_REPEATS_BULKY
    queries = [
        ("a_varblock_2hop_count", two_hop_count(large), 2, 2, 1, True, many),
        ("b_materialised_2hop", two_hop(large), 2, 2, 0, True, few),
        ("c_child_order_2hop", "{ q(func: uid(%s)) { e { e (orderdesc: rank, "
         "first: 2) { uid } } } }" % uid_list(large), 2, 2, 0, False, few),
        ("d_filtered_2hop", "{ q(func: uid(%s)) { uid e { uid e @filter(has(rank) "
         "AND has(name)) { uid } } } }" % uid_list(large), 2, 2, 0, False, few),
        ("e_recurse_varblock_count", "{ var(func: uid(%s)) @recurse(depth: 2) "
         "{ r as e } q(func: uid(r)) { count() } }" % uid_list(rseeds), 0, 2, 1,
         True, many),
        ("f_varblock_3hop_count", "{ var(func: uid(%s)) { e { e { f as e } } } "
         "q(func: uid(f)) { count() } }" % uid_list(small), 3, 3, 1, False, many),
    ]
    hops = [0]
    multi_hop = ops.multi_hop

    def counting(*a, **k):
        hops[0] += 1
        return multi_hop(*a, **k)

    rows = {}
    ops.multi_hop = counting
    try:
        for name, q, levels, gathers, scans, both, repeats in queries:
            want = json.dumps(ref.run(q))
            body = json.loads(want)
            row = {"query": name, "seeds": q.count("0x"), "body_bytes": len(want),
                   "objects": {k: len(v) for k, v in body.items()}, "card": card}
            row.update(serve_routes(srv, name, q, want, hops, repeats, both))
            f = row["fused"]
            check(f["chain_fused_levels"] == levels,
                  f"{name}: {f['chain_fused_levels']} fused levels, want {levels} "
                  f"(rejects: {f['chain_reject']})")
            if levels:
                check_decided(f, "chain", "chain", name)
            check(f["gather_launches_per_query"] == gathers,
                  f"{name}: {f['gather_launches_per_query']} gather launches a "
                  f"request, want {gathers}")
            check(f["fused_gathers"] == gathers and "resident" not in f["routes"],
                  f"{name}: not every gather ran fused ({f['routes']})")
            check(f["multi_hop_calls_per_query"] == scans,
                  f"{name}: {f['multi_hop_calls_per_query']} multi-hop calls a "
                  f"request, want {scans}")
            if name.startswith("d_"):
                check(f["intersect_launches_per_query"] >= 1 and f["kway_device"] >= 1,
                      f"{name}: the fused keep-set did not launch the intersect kernel")
            if both:
                p = row["per_level"]
                check(p["chain_fused_levels"] == 0 and p["fused_gathers"] == 0
                      and p["multi_hop_calls_per_query"] == 0,
                      f"{name}: the pinned-off route still fused")
            first = (body.get("q") or [{}])[0]
            if "count" in first:
                row["count"] = first["count"]
            rows[name] = row
            log(dict(phase="chain", **row))
    finally:
        ops.multi_hop = multi_hop
    return rows


# -- phase 20: the mesh serving plane -----------------------------------------


def mesh_served(msrv, ref, name: str, q: str, width: int, intersect: bool) -> dict:
    """One request of ``q`` on the mesh server: its body equal to the
    host route ``ref``'s, every hop on ``route: mesh`` at ``width`` chips,
    no gather launch, and with ``intersect`` the intersect kernel
    launched.  Returns its row."""
    from dgraph_tpu_torch.ops import gather, kway

    want = json.dumps(ref.run(q))
    g0, k0 = gather.KERNEL.launches, kway.KERNEL.launches
    status, raw, secs = post(msrv.addr, q, "?ledger=true&debug=true")
    check(status == 200, f"mesh {name}: HTTP {status}")
    check(strip_latency(raw) == want, f"mesh {name}: body differs from the host route")
    body = json.loads(raw)
    led = body["extensions"]["ledger"]
    eng = body["server_latency"]["engine"]
    routes = {k: v for k, v in eng["routes"].items() if k != "empty"}
    check(set(routes) == {"mesh"} and set(led["hops"]) <= {"mesh", "empty"},
          f"mesh {name}: hops off the mesh: {eng['routes']} / {led['hops']}")
    check(led.get("mesh_chips") == width,
          f"mesh {name}: mesh_chips {led.get('mesh_chips')}, want {width}")
    gathers = gather.KERNEL.launches - g0
    intersects = kway.KERNEL.launches - k0
    check(gathers == 0, f"mesh {name}: {gathers} gather launches on mesh hops")
    if intersect:
        check(intersects >= 1, f"mesh {name}: the intersect kernel was not launched")
    return {"query": name, "ms": secs * 1e3, "routes": eng["routes"],
            "mesh_chips": led["mesh_chips"], "exchange_bytes": led["exchange_bytes"],
            "mesh_ms": led["mesh_ms"], "edges": led["edges"],
            "gather_launches": gathers, "intersect_launches": intersects,
            "body_bytes": len(want), "byte_identical_to_host_route": True}


def mesh_summary(m: dict) -> dict:
    """The summary line's ``mesh`` key."""
    return {
        "seconds": m["seconds"], "setup": m["setup"],
        "served_ms": {n: r["ms"] for n, r in m["served"].items()},
        "exchange_bytes": {n: r["exchange_bytes"] for n, r in m["served"].items()},
        "count_p50_ms": {k: v["p50_ms"] for k, v in m["timing"].items()},
        "rejoin_s": m["chip_loss"]["rejoin_s"], "write": m["write"],
        "calibration": m["calibration"],
    }


def mesh_count_p50(addr: str, q: str) -> dict:
    lat = []
    for _ in range(MESH_REPEATS):
        status, _raw, secs = post(addr, q)
        check(status == 200, f"mesh timing: HTTP {status}")
        lat.append(secs * 1e3)
    return {"p50_ms": float(np.percentile(lat, 50)), "request_ms": lat}


def phase_mesh(store, srv, s1, s2, chain_large, card: str) -> dict:
    """Phase 20 (see the module docstring); the caller zeroes the launch
    counts just before and reads them right after."""
    import torch

    from dgraph_tpu_torch import ops
    from dgraph_tpu_torch.mesh.programs import mesh_multi_hop_step
    from dgraph_tpu_torch.parallel import crossover, make_mesh
    from dgraph_tpu_torch.query import chain
    from dgraph_tpu_torch.sched import segments
    from dgraph_tpu_torch.serve.server import DgraphServer
    from dgraph_tpu_torch.utils import devguard
    from dgraph_tpu_torch.utils.failpoints import FailpointError, fail

    t_phase = time.perf_counter()
    cal = crossover.measure("cuda")
    log(dict(phase="mesh_calibration", card=card, **cal,
             nvlink_bytes_per_s_estimate=crossover.NVLINK_BYTES_PER_S,
             l2_bytes=crossover.L2_BYTES, hbm_bytes=crossover.HBM_TOTAL))
    out = {"calibration": cal, "card": card}
    rng = np.random.default_rng(MESH_SEED)
    count_seeds = np.unique(rng.integers(1, N_NODES + 1, size=LARGE_SEEDS))
    count_q = two_hop_count(count_seeds)
    small = np.unique(rng.integers(1, N_NODES + 1, size=SMALL_SEEDS))
    chain_q = two_hop_count(chain_large)
    ref = host_engine(store)
    msrv = wsrv = None
    with env_set("DGRAPH_TPU_DEVICE_COOLDOWN_S", str(MESH_COOLDOWN_S)):
        devguard.reset_for_tests()
        try:
            msrv = DgraphServer(store, device="cuda",
                                mesh=make_mesh(devices=["cuda:0"] * MESH_WIDTH))
            msrv.start()
            arenas = msrv.engine.arenas
            t0 = time.perf_counter()
            a = arenas.data("e")
            t1 = time.perf_counter()
            sa = arenas.sharded_csr("e")
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            out["setup"] = {"arena_build_s": t1 - t0, "shard_s": t2 - t1,
                            "width": MESH_WIDTH, "shard_bytes": sa.device_bytes(),
                            "rows": a.n_rows, "edges": a.n_edges}
            log(dict(phase="mesh_setup", card=card, **out["setup"]))
            with no_caches(msrv), per_level(msrv.engine):
                # (a) the served requests
                rows = [
                    mesh_served(msrv, ref, "count", count_q, MESH_WIDTH, False),
                    mesh_served(msrv, ref, "materialised_2hop", two_hop(small),
                                MESH_WIDTH, False),
                    mesh_served(msrv, ref, "join_a", join_filter_query(s1, s2),
                                MESH_WIDTH, True),
                    mesh_served(msrv, ref, "chain_a", chain_q, MESH_WIDTH, False),
                ]
                for r in rows:
                    log(dict(phase="mesh", card=card, **r))
                out["served"] = {r["query"]: r for r in rows}
                # (b) one multi-hop segment, nothing synchronizing
                first = int(a.degree_of_rows(a.rows_for_uids_host(chain_large)).sum())
                cap = chain.scan_cap(a, len(chain_large), first, 2)
                check(cap is not None, "mesh (b): chain (a) exceeds the light cap")
                f = torch.from_numpy(ops.pad_to(chain_large, cap)).to("cuda")
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    fs, tot, _final = mesh_multi_hop_step(
                        arenas.mesh, arenas.sharded_csr("e"), f, cap, 2)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                n2 = int((fs[1] != ops.SENT).sum())
                want_n = json.loads(json.dumps(ref.run(chain_q)))["q"][0]["count"]
                check(n2 == want_n, f"mesh (b): {n2} uids at hop 2, want {want_n}")
                out["no_sync"] = {"cap": cap, "hop_edges": tot.tolist(),
                                  "count": n2, "raised": False}
                log(dict(phase="mesh_no_sync", **out["no_sync"]))
                # (e) the count's p50 at 4 virtual chips, 1 chip, unsharded
                timing = {"virtual_chips_4": mesh_count_p50(msrv.addr, count_q)}
                with env_set("DGRAPH_TPU_MESH", "force"):
                    wsrv = DgraphServer(store, device="cuda")
                wsrv.start()
                check(wsrv.engine.arenas.mesh.shape["model"] == 1,
                      "DGRAPH_TPU_MESH=force on one card must make a 1-wide mesh")
                with no_caches(wsrv), per_level(wsrv.engine):
                    post(wsrv.addr, count_q)
                    timing["force_width_1"] = mesh_count_p50(wsrv.addr, count_q)
                wsrv.stop()
                wsrv = None
                with no_caches(srv), per_level(srv.engine):
                    timing["unsharded"] = mesh_count_p50(srv.addr, count_q)
                out["timing"] = timing
                log(dict(phase="mesh_timing", card=card,
                         **{k: v["p50_ms"] for k, v in timing.items()}))
                # (c) chip loss, staged rejoin, a resumed segmented chain
                dom = arenas.mesh_fault
                want = json.dumps(ref.run(count_q))
                version0 = arenas.mesh_plan.version
                fail.seed(0)
                fail.arm("device.mesh", "error(p=1,n=1,chip=3)")
                t_loss = time.perf_counter()
                status, raw, _secs = post(msrv.addr, count_q, "?ledger=true")
                loss_s = time.perf_counter() - t_loss
                fail.disarm("device.mesh")
                body = json.loads(raw)
                deg = body.pop("degraded", {})
                body.pop("server_latency", None)
                led = body.pop("extensions")["ledger"]
                check(status == 200 and json.dumps(body) == want,
                      "mesh (c): the count after the loss differs")
                check(deg.get("mesh", {}).get("chips_healthy") == MESH_WIDTH - 1
                      and "device" not in deg,
                      f"mesh (c): disclosure {deg}")
                check(led["mesh_chips"] == MESH_WIDTH - 1,
                      f"mesh (c): mesh_chips {led['mesh_chips']}")
                check(dom.epoch == version0 + 1,
                      f"mesh (c): epoch {dom.epoch}, plan version was {version0}")
                epoch_loss = dom.epoch
                rejoin_s = wait_until(lambda: dom.width == MESH_WIDTH, MESH_REJOIN_S,
                                      "mesh (c): the staged rejoin never came back")
                check(dom.mesh is dom.boot_mesh, "mesh (c): rejoin off the boot mesh")
                status, raw, _secs = post(msrv.addr, count_q, "?ledger=true")
                check(status == 200 and strip_latency(raw) == want
                      and "degraded" not in json.loads(raw),
                      "mesh (c): the count after the rejoin differs")
                ex = arenas.mesh_executor()
                with env_set("DGRAPH_TPU_SEGMENT", "force"), \
                        env_set("DGRAPH_TPU_SEGMENT_K", "1"):
                    fs0, tot0 = ex.multi_hop("e", False, chain_large, 2, cap, {})
                    flipped = []

                    def flip():
                        # another query's chip loss, between two segments
                        if not flipped:
                            flipped.append(1)
                            dom._sink("transient", "mesh.multi_hop",
                                      FailpointError("lost (chip=1)"))

                    stats = {}
                    prev = segments.activate(segments.SegmentContext(
                        preempt=flip, stats=stats))
                    try:
                        fs1, tot1 = ex.multi_hop("e", False, chain_large, 2, cap, stats)
                    finally:
                        segments.deactivate(prev)
                check(flipped and stats.get("resumed", {}).get("epoch") == 1,
                      f"mesh (c): the segmented chain did not resume: {stats}")
                check(np.array_equal(fs0, fs1) and np.array_equal(tot0, tot1),
                      "mesh (c): the resumed chain differs")
                rejoin2_s = wait_until(lambda: dom.width == MESH_WIDTH, MESH_REJOIN_S,
                                       "mesh (c): the second rejoin never came back")
                out["chip_loss"] = {
                    "count_after_loss_ms": loss_s * 1e3, "epoch": epoch_loss,
                    "plan_version_before": version0, "disclosure": deg,
                    "rejoin_s": rejoin_s, "resumed": stats["resumed"],
                    "second_rejoin_s": rejoin2_s, "status": dom.status()}
                log(dict(phase="mesh_chip_loss", card=card, **out["chip_loss"]))
                # (d) a 64-edge write
                adds, _dels = delta_edges(store, count_seeds, MESH_DELTA, rng)
                status, raw, _secs = post(msrv.addr, edge_mutation(adds, []))
                check(status == 200, f"mesh (d): write HTTP {status}")
                status, raw, _secs = post(msrv.addr, count_q, "?ledger=true")
                check(status == 200, f"mesh (d): count HTTP {status}")
                host_engine_advanced(store, ref, adds)
                want_d = json.dumps(ref.run(count_q))
                check(strip_latency(raw) == want_d,
                      "mesh (d): the count after the write differs from the host route")
                out["write"] = {"edges": len(adds),
                                "count": json.loads(want_d)["q"][0]["count"],
                                "count_before": json.loads(want)["q"][0]["count"]}
                log(dict(phase="mesh_write", **out["write"]))
        finally:
            fail.reset()
            for x in (wsrv, msrv):
                if x is not None:
                    x.stop()
            devguard.reset_for_tests()
    out["seconds"] = time.perf_counter() - t_phase
    return out


# -- phase 12: the serving plane ----------------------------------------------


@contextlib.contextmanager
def no_caches(srv):
    """The served store with both query caches detached (the scheduler's
    result cache and the arenas' hop cache): every repeat of a request
    executes, as the earlier phases' launch checks need."""
    arenas, sched = srv.engine.arenas, srv.scheduler
    hop, res = arenas.hop_cache, sched.result_cache
    arenas.hop_cache, sched.result_cache = None, None
    try:
        yield
    finally:
        arenas.hop_cache, sched.result_cache = hop, res


def recurse_count(seeds) -> str:
    """A var-block @recurse(depth: 2) count: from 8192 seeds the fused
    BFS's bound rejects it, so it walks level by level, and its second
    level (some 400,000 edges) is above the merge gate."""
    return ("{ var(func: uid(%s)) @recurse(depth: 2) { r as e } "
            "q(func: uid(r)) { count() } }" % uid_list(seeds))


def shortest_fan(arena, seeds, n: int):
    """(from, [to, ...]): the first seed with ``n`` nodes two hops away
    (not one), the most reached first."""
    for s in seeds.tolist():
        uniq, cnt = two_hop_ring(arena, s)
        if len(uniq) >= n:
            return s, uniq[np.argsort(-cnt, kind="stable")[:n]].tolist()
    raise SmokeFailure(f"no seed has {n} nodes two hops away")


def serving_mix(arena, rng):
    """Each client's request texts: four fresh ones — a per-level
    @recurse count from 8192 seeds, join query (a), and ``shortest`` k 1
    from one source to two nodes two hops away (the second re-expands
    the first's rings: hop-cache hits) — then a repeat of its own
    first.  Every text reads only ``e``, so all share one cache
    version."""
    def seeds():
        return np.unique(rng.integers(1, N_NODES + 1, size=LARGE_SEEDS))

    g = seeds()  # (a)'s uid(g) set, shared by every client
    clients = []
    for _c in range(SERVE_CLIENTS):
        src, dsts = shortest_fan(arena, np.unique(
            rng.integers(1, N_NODES + 1, size=SMALL_SEEDS)), SERVE_SHORTEST)
        fresh = [recurse_count(seeds()), join_filter_query(seeds(), g)]
        fresh += ["{ shortest(from: 0x%x, to: 0x%x, numpaths: 1) { e } }" % (src, d)
                  for d in dsts]
        clients.append(fresh + fresh[:SERVE_PER_CLIENT - len(fresh)])
    return clients


def _hist_sum_count(h):
    _cum, s, c = h.snapshot()
    return s, c


def serve_round(srv, clients, want, mode: str) -> dict:
    """One round: every client thread sends its texts in order, each body
    held against the host route's.  ``mode`` "scheduled" serves through
    the server's scheduler, "serial" with it detached (the
    DGRAPH_TPU_SCHED=0 path).  Both query caches are emptied first, so
    every round does the same work.  The card's busy share is the union
    of the device intervals ``torch.profiler`` records over the round's
    wall time."""
    import threading

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dgraph_tpu_torch.ops import gather, kway
    from dgraph_tpu_torch.utils import metrics as m

    sched = srv.scheduler
    if sched.result_cache is not None:
        sched.result_cache.clear()
    srv.engine.arenas.hop_cache.clear()
    lat, bad = [], []

    def client(texts):
        for q in texts:
            status, raw, _h, secs = post_any(srv.addr, q)
            if status != 200 or strip_latency(raw) != want[q]:
                bad.append((status, q[:80], raw[:200]))
                return
            lat.append(secs)

    snap = lambda: (gather.KERNEL.launches, kway.KERNEL.launches,  # noqa: E731
                    m.SCHED_MERGED_HOPS.value(), m.SCHED_COALESCED.value(),
                    m.QCACHE_RESULT_EVENTS.snapshot().get("hit", 0),
                    m.QCACHE_HOP_EVENTS.snapshot().get("hit", 0),
                    *_hist_sum_count(m.SCHED_COHORT_OCCUPANCY))
    dev = srv.engine.device
    acts = [ProfilerActivity.CUDA] if dev.type == "cuda" else [ProfilerActivity.CPU]
    if mode == "serial":
        srv.scheduler = None
    _sync(dev)
    n0 = snap()
    threads = [threading.Thread(target=client, args=(t,)) for t in clients]
    try:
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            _sync(dev)
            wall = time.perf_counter() - t0
    finally:
        srv.scheduler = sched
    check(not any(t.is_alive() for t in threads), f"{mode} round: a client hung")
    check(not bad, f"{mode} round: {len(bad)} bad responses, first {bad[:1]}")
    n1 = snap()
    d = [b - a for a, b in zip(n0, n1)]
    spans = [(ev.time_range.start, ev.time_range.end) for ev in prof.events()
             if ev.device_type == DeviceType.CUDA]
    busy_ms = _union_us(spans) / 1e3 if spans else None
    n_req = sum(len(t) for t in clients)
    check(len(lat) == n_req, f"{mode} round: {len(lat)} of {n_req} answered")
    ms = sorted(x * 1e3 for x in lat)
    return {"mode": mode, "requests": n_req, "wall_s": wall,
            "requests_per_s": n_req / wall,
            "p50_ms": float(np.percentile(ms, 50)), "p99_ms": p99(ms),
            "min_ms": ms[0], "max_ms": ms[-1],
            "gather_launches": d[0], "intersect_launches": d[1],
            "merged_hops": d[2], "coalesced": d[3],
            "result_cache_hits": d[4], "hop_cache_hits": d[5],
            "cohorts": d[7], "mean_cohort_occupancy": (d[6] / d[7]) if d[7] else None,
            "device_events": len(spans), "device_busy_ms": busy_ms,
            "busy_share": (busy_ms / (wall * 1e3)) if busy_ms is not None else None}


def phase_serving_plane(store, srv, card: str) -> dict:
    """Concurrent /query load through the cohort scheduler at its default
    knobs, rounds taken in turn with the serial path; then the shed and
    freshness guarantees.  The caller zeroes the launch counts just
    before.  ``card`` is the nvidia-smi name and power limit."""
    import threading

    from dgraph_tpu_torch.sched.scheduler import CohortScheduler
    from dgraph_tpu_torch.utils.metrics import QCACHE_HOP_EVENTS, QCACHE_RESULT_EVENTS

    sched = srv.scheduler
    eng = srv.engine
    check(sched is not None and sched.result_cache is not None
          and eng.arenas.hop_cache is not None,
          "the server must serve through the scheduler with both caches")
    ctl = sched._adaptive
    check(ctl is not None and (ctl.base_batch, ctl.base_flush_s, sched.queue_cap,
                               sched.merge_window_s) == (32, 0.002, 256, 0.001)
          and 32 <= sched.max_batch <= ctl.hi_batch
          and ctl.lo_flush_s <= sched.flush_s <= 0.002,
          "the scheduler must run its default knobs under the cohort controller")
    check_priced(srv, chain=True)
    t0 = time.perf_counter()
    arena = eng.arenas.data("e")
    rng = np.random.default_rng(SERVE_SEED)
    clients = serving_mix(arena, rng)
    ref = host_engine(store)
    want = {}
    for texts in clients:
        for q in texts:
            if q not in want:
                want[q] = json.dumps(ref.run(q))
    t_ref = time.perf_counter() - t0
    rounds = []
    for _r in range(SERVE_ROUNDS):
        for mode in ("scheduled", "serial"):
            row = serve_round(srv, clients, want, mode)
            rounds.append(row)
            log(dict(phase="serving_round", card=card, **row))
    sch = [r for r in rounds if r["mode"] == "scheduled"]
    ser = [r for r in rounds if r["mode"] == "serial"]
    merged = sum(r["merged_hops"] for r in sch)
    check(merged > 0, "no hop merged across requests under concurrent load")
    check(sum(r["result_cache_hits"] for r in sch) > 0, "no result-cache hit")
    check(sum(r["hop_cache_hits"] for r in sch) > 0, "no hop-cache hit")
    g_sch = sum(r["gather_launches"] for r in sch)
    g_ser = sum(r["gather_launches"] for r in ser)
    check(g_sch < g_ser, f"scheduled rounds launched {g_sch} gathers, serial {g_ser}")
    t_load = time.perf_counter() - t0 - t_ref

    # a budget of 1 ms: the request is cancelled before it runs
    q504 = two_hop_count(np.unique(rng.integers(1, N_NODES + 1, size=LARGE_SEEDS)))
    status, raw, _h, _s = post_any(srv.addr, q504, {"X-Dgraph-Timeout": "0.001"})
    check(status == 504 and json.loads(raw)["code"] == "ErrorDeadlineExceeded",
          f"a 1 ms budget answered {status}: {raw[:200]!r}")

    # a scheduler built at DGRAPH_TPU_SCHED_QUEUE_CAP=1, flooded while a
    # writer holds the engine: one request is admitted, the rest shed
    prev = os.environ.get("DGRAPH_TPU_SCHED_QUEUE_CAP")
    os.environ["DGRAPH_TPU_SCHED_QUEUE_CAP"] = "1"
    try:
        tight = CohortScheduler(srv)
    finally:
        if prev is None:
            del os.environ["DGRAPH_TPU_SCHED_QUEUE_CAP"]
        else:
            os.environ["DGRAPH_TPU_SCHED_QUEUE_CAP"] = prev
    check(tight.queue_cap == 1, "the tight scheduler did not read its queue cap")
    flood = [q for texts in clients for q in texts if "shortest" in q]
    shed, codes = [], []
    srv.scheduler = tight
    srv._engine_lock.acquire_write()
    try:
        def flooder(q):
            st, _raw, hdr, _s = post_any(srv.addr, q)
            codes.append(st)
            if st == 429:
                shed.append(hdr.get("Retry-After"))
        threads = [threading.Thread(target=flooder, args=(q,)) for q in flood]
        for t in threads:
            t.start()
        t_end = time.perf_counter() + 60
        while not shed and time.perf_counter() < t_end:
            time.sleep(0.01)
    finally:
        srv._engine_lock.release_write()
    for t in threads:
        t.join(timeout=120)
    srv.scheduler = sched
    tight.stop()
    check(shed and all(ra is not None and int(ra) >= 1 for ra in shed),
          f"the flooded QUEUE_CAP=1 server gave no 429 with Retry-After ({codes})")
    check(set(codes) <= {200, 429}, f"flood statuses {sorted(set(codes))}")

    # read-after-write under load, through both caches: a 1-hop read is
    # cached whole (result cache) and a twin text under another alias
    # hits its hop (hop cache); a mutation lands mid-load; after its ack
    # both texts must show the new edges
    movers = np.unique(rng.integers(1, N_NODES + 1, size=SMALL_SEEDS))
    movers = movers[arena.rows_for_uids_host(movers) >= 0][:8]
    q_res = "{ q(func: uid(%s)) { uid e { uid } } }" % uid_list(movers)
    q_hop = "{ h(func: uid(%s)) { uid e { uid } } }" % uid_list(movers)
    r0 = QCACHE_RESULT_EVENTS.snapshot().get("hit", 0)
    h0 = QCACHE_HOP_EVENTS.snapshot().get("hit", 0)
    for q in (q_res, q_res, q_hop):
        status, _raw, _h, _s = post_any(srv.addr, q)
        check(status == 200, f"warm-up read: HTTP {status}")
    check(QCACHE_RESULT_EVENTS.snapshot().get("hit", 0) > r0, "the warm read missed tier 2")
    check(QCACHE_HOP_EVENTS.snapshot().get("hit", 0) > h0, "the twin read missed tier 1")
    edges_e = store.peek("e").edges
    new_edges = []
    for s in movers.tolist():
        t = int(rng.integers(1, N_NODES + 1))
        while t in edges_e[s]:
            t = int(rng.integers(1, N_NODES + 1))
        new_edges.append((s, t))
    stop = threading.Event()
    bg_codes = []

    def background(texts):
        for q in texts:
            if stop.is_set():
                return
            bg_codes.append(post_any(srv.addr, q)[0])

    # the background clients ask for two paths where the round asked for
    # one: fresh texts, executed under the read side, cheap
    bg = [threading.Thread(target=background, args=(
        [q.replace("numpaths: 1", "numpaths: 2") for q in t if "shortest" in q],))
        for t in clients[:8]]
    for t in bg:
        t.start()
    mu = "mutation { set { %s } }" % " ".join("<0x%x> <e> <0x%x> ." % e for e in new_edges)
    status, raw, _h, _s = post_any(srv.addr, mu)
    check(status == 200 and json.loads(raw).get("code") == "Success",
          f"mid-load mutation failed: {raw[:200]!r}")
    after = {q: post_any(srv.addr, q) for q in (q_res, q_hop)}
    stop.set()
    for t in bg:
        t.join(timeout=600)
    check(all(c == 200 for c in bg_codes), f"background load statuses {sorted(set(bg_codes))}")
    ref = host_engine(store)
    for q, (status, raw, _h, _s) in after.items():
        check(status == 200, f"read after write: HTTP {status}")
        got = strip_latency(raw)
        check(got == json.dumps(ref.run(q)), "a read after the write differs from the host route")
        by_uid = {n["_uid_"]: n for n in next(iter(json.loads(got).values()))}
        for s, t in new_edges:
            kids = {k["_uid_"] for k in by_uid["0x%x" % s].get("e", [])}
            check("0x%x" % t in kids, f"read after write misses 0x{s:x} -> 0x{t:x}")

    def agg(rows, k):
        return [r[k] for r in rows]

    out = {
        "clients": SERVE_CLIENTS, "requests_per_client": SERVE_PER_CLIENT,
        "rounds_each": SERVE_ROUNDS, "distinct_texts": len(want),
        "seeds_per_heavy_request": LARGE_SEEDS, "card": card,
        "reference_s": t_ref, "load_s": t_load,
        "guarantees_s": time.perf_counter() - t0 - t_ref - t_load,
        "merged_hops": merged,
        "gather_launches": {"scheduled": g_sch, "serial": g_ser},
        "intersect_launches": {"scheduled": sum(agg(sch, "intersect_launches")),
                               "serial": sum(agg(ser, "intersect_launches"))},
        "result_cache_hits": sum(agg(sch, "result_cache_hits")),
        "hop_cache_hits": {"scheduled": sum(agg(sch, "hop_cache_hits")),
                           "serial": sum(agg(ser, "hop_cache_hits"))},
        "coalesced": sum(agg(sch, "coalesced")),
        "mean_cohort_occupancy": agg(sch, "mean_cohort_occupancy"),
        **{f"{k}_{mode}": agg(rows, k) for mode, rows in (("scheduled", sch), ("serial", ser))
           for k in ("requests_per_s", "p50_ms", "p99_ms", "busy_share")},
        "deadline_504": True, "shed_429": len(shed),
        "read_after_write": {"new_edges": len(new_edges), "background_requests": len(bg_codes)},
    }
    log(dict(phase="serving_plane", **out))
    return out


# -- phase 13: the tile join tier ----------------------------------------------


def mxu_graph():
    """Phase 13's community graph: each uid of 1..MXU_UIDS takes
    MXU_FANOUT targets drawn uniformly from the uids of its own 128-block
    and the two beside it (clipped to the range); duplicates and
    self-loops dropped.  Returns (src, dst), sorted unique."""
    rng = np.random.default_rng(MXU_GRAPH_SEED)
    u = np.repeat(np.arange(1, MXU_UIDS + 1, dtype=np.int64), MXU_FANOUT)
    b = u // 128
    lo = np.maximum((b - 1) * 128, 1)
    hi = np.minimum((b + 2) * 128, MXU_UIDS + 1)
    v = lo + (rng.random(len(u)) * (hi - lo)).astype(np.int64)
    keys = np.unique((u << 20) | v)
    src, dst = keys >> 20, keys & ((1 << 20) - 1)
    keep = src != dst
    return src[keep], dst[keep]


def mxu_queries(rng) -> list:
    """(name, query text, decision shape) of phase 13."""
    s1, s2, s3 = (np.unique(rng.integers(1, MXU_UIDS + 1, size=k))
                  for k in (1024, 256, 1024))
    tri = ("{ var(func: uid(%s)) { w as ~friend } "
           "var(func: uid(%s)) { friend { t as friend @filter(%s) } } "
           "q(func: uid(t)) { count() } }")
    return [
        ("m1_varblock_2hop_count",
         "{ var(func: uid(%s)) { friend { f as friend } } "
         "q(func: uid(f)) { count() } }" % uid_list(s1), "chain"),
        ("m2_varblock_3hop_count",
         "{ var(func: uid(%s)) { friend { friend { f as friend } } } "
         "q(func: uid(f)) { count() } }" % uid_list(s2), "chain"),
        ("m3_triangle", tri % (uid_list(s3), uid_list(s3), "uid(w)"), "triangle"),
        ("m4_triangle_and", tri % (uid_list(s3), uid_list(s3),
                                   "uid(w) AND has(friend)"), "triangle"),
    ]


@contextlib.contextmanager
def env_set(name: str, value: str):
    """``name`` set to ``value`` in this process's environment inside."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def mxu_mode(mode: str):
    """DGRAPH_TPU_MXU_JOIN for the requests sent inside (read per call)."""
    return env_set("DGRAPH_TPU_MXU_JOIN", mode)


def serve_mxu(srv, name: str, q: str, want: str, shape: str) -> dict:
    """Serve ``q`` MXU_REPEATS times a route, routes 1 and 0 alternating
    request by request, every request with ``?debug=true``: each body is
    held against ``want``, each route-1 request's stats must hold one
    ``mxu`` decision of ``shape`` and ``mxu_join_ms > 0``."""
    from dgraph_tpu_torch.ops import gather, kway

    lat = {"1": [], "0": []}
    launches = {"1": [0, 0], "0": [0, 0]}
    stats = {"1": [], "0": []}
    for _ in range(MXU_REPEATS):
        for mode in ("1", "0"):
            n0 = (gather.KERNEL.launches, kway.KERNEL.launches)
            with mxu_mode(mode):
                status, raw, secs = post(srv.addr, q, "?debug=true")
            n1 = (gather.KERNEL.launches, kway.KERNEL.launches)
            check(status == 200, f"{name} (mxu {mode}): HTTP {status}: {raw[:300]!r}")
            check(strip_latency(raw) == want,
                  f"{name} (mxu {mode}): body differs from the host route")
            eng = json.loads(raw)["server_latency"]["engine"]
            routes = eng.get("join_routes", [])
            if mode == "1":
                check(len(routes) == 1 and routes[0]["route"] == "mxu"
                      and routes[0]["shape"] == shape and eng["mxu_join_ms"] > 0,
                      f"{name}: route 1 took {routes} (mxu_join_ms "
                      f"{eng['mxu_join_ms']}, rejects {eng['chain_reject']})")
            else:
                check(not routes and eng["mxu_join_ms"] == 0,
                      f"{name}: route 0 still reached the tile tier: {routes}")
            lat[mode].append(secs * 1e3)
            launches[mode] = [c + y - x for c, x, y in zip(launches[mode], n0, n1)]
            stats[mode].append(eng)
    out = {}
    for mode, key in (("1", "mxu"), ("0", "gather")):
        ms, st = lat[mode], stats[mode]
        out[key] = {
            "requests": len(ms), "min_ms": min(ms),
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": p99(ms), "max_ms": max(ms),
            "gather_launches_per_query": launches[mode][0] / MXU_REPEATS,
            "intersect_launches_per_query": launches[mode][1] / MXU_REPEATS,
            # per-level hops outside a fused pass that took the gather
            # (the planner's resident expands)
            "resident_hops_per_query": float(np.mean(
                [e["routes"].get("resident", 0) for e in st])),
            "mxu_join_ms_p50": float(np.median([e["mxu_join_ms"] for e in st])),
            "tile_build_ms_first": st[0]["tile_build_ms"],
            "tile_build_ms_p50": float(np.median([e["tile_build_ms"] for e in st])),
            "chain_ms_p50": float(np.median([e["chain_ms"] for e in st])),
            "chain_fused_levels": st[0]["chain_fused_levels"],
            "fused_gathers": st[0]["fused_gathers"],
            "kway_device": st[0]["kway_device"],
            "decision": (st[0].get("join_routes") or [None])[0],
        }
    return out


def mxu_mutation(arena, rng) -> tuple:
    """MXU_DELTA new ``friend`` edges inside stored blocks (a target in the
    source's own 128-block that it lacks) and MXU_DELTA existing ones to
    delete, as one mutation's text."""
    h_dst = arena.host_dst()
    adds, dels = [], []
    rows = rng.choice(arena.n_rows, size=4 * MXU_DELTA, replace=False)
    for r in rows.tolist():
        u = int(arena.h_src[r])
        out = h_dst[arena.h_offsets[r]:arena.h_offsets[r + 1]]
        have = set(out.tolist())
        base = (u // 128) * 128
        for v in range(max(base, 1), min(base + 128, MXU_UIDS + 1)):
            if v != u and v not in have:
                if len(adds) < MXU_DELTA:
                    adds.append((u, v))
                break
        if len(dels) < MXU_DELTA and len(out):
            dels.append((u, int(out[0])))
    check(len(adds) == MXU_DELTA and len(dels) == MXU_DELTA,
          "phase mxu_join: could not draw the mutation")
    fmt = lambda es: " ".join("<0x%x> <friend> <0x%x> ." % e for e in es)  # noqa: E731
    return "mutation { set { %s } delete { %s } }" % (fmt(adds), fmt(dels)), adds, dels


def phase_mxu_join(card: str, served_done) -> dict:
    """Phase 13 on a server of its own, stopped at the end.  The caller
    zeroes the launch counts just before; ``served_done()`` reads them
    right after the served queries and the mutation, before the ops
    check and the timing (which launch none of the kernels)."""
    from dgraph_tpu_torch.models import PostingStore
    from dgraph_tpu_torch.serve.server import DgraphServer

    t0 = time.perf_counter()
    src, dst = mxu_graph()
    store = PostingStore()
    store.apply_schema("friend: uid @reverse .")
    store.bulk_set_uid_edges("friend", src, dst)
    srv = DgraphServer(store, device="cuda")
    srv.start()
    try:
        rows, queries = _serve_mxu_phase(srv, store, card, t0)
        served_done()
        ops_check = mxu_ops_check()
        log(dict(phase="spgemm_ops", **ops_check))
        timing = mask_chain_timing(srv, queries)
        log(dict(phase="mask_chain_timing", card=card, **timing))
    finally:
        srv.stop()
    return {"rows": rows, "spgemm_ops": ops_check, "mask_chain_timing": timing}


def _serve_mxu_phase(srv, store, card: str, t0: float):
    """Phase 13's config line, its four queries by route and the write;
    returns (the rows, the queries)."""
    from dgraph_tpu_torch.ops import spgemm
    from dgraph_tpu_torch.utils.metrics import IVM_REPAIRS, JOIN_TILE_BUILDS

    eng = srv.engine
    # every repeat executes: no result or hop cache in front
    eng.arenas.hop_cache = None
    srv.scheduler.result_cache = None
    # (m4)'s AND goes to the intersect kernel whatever its size
    eng.arenas.kway_device_min = 1
    arena = eng.arenas.data("friend")
    eng.arenas.reverse("friend")
    k, uni = arena.tile_blocks()
    t = spgemm.tile_size()
    config = {"uids": MXU_UIDS, "edges": arena.n_edges, "source_rows": arena.n_rows,
              "tile": t, "stored_blocks": k, "universe": uni,
              "tile_bytes": spgemm.est_tile_bytes(k, t),
              "tile_budget": spgemm.tile_budget(),
              "mask_lanes": spgemm.mask_lanes(uni, t),
              "one_hot_bytes_reference": spgemm.bucket(max(1, k))
              * (spgemm.mask_lanes(uni, t) // t) * 4,
              "load_s": time.perf_counter() - t0}
    check(k >= 1 and config["tile_bytes"] <= config["tile_budget"],
          f"phase mxu_join: the tiles do not fit the budget: {config}")
    log(dict(phase="mxu_join_config", **config))
    ref = host_engine(store)
    rows = {}
    queries = mxu_queries(np.random.default_rng(MXU_SEED))
    for name, q, shape in queries:
        want = json.dumps(ref.run(q))
        row = {"query": name, "seeds": q.split(")")[0].count("0x"), "card": card,
               "count": json.loads(want)["q"][0]["count"]}
        row.update(serve_mxu(srv, name, q, want, shape))
        # the tile chain launches no gather; a per-level hop beside it
        # (the triangle's ``w as ~friend``) may, where the planner sends
        # it to the card
        check(row["mxu"]["gather_launches_per_query"]
              == row["mxu"]["resident_hops_per_query"],
              f"{name}: the tile route launched the gather")
        check(row["gather"]["gather_launches_per_query"] >= 1,
              f"{name}: the gather tier launched no gather")
        if name.startswith("m4"):
            check(row["mxu"]["intersect_launches_per_query"] >= 1,
                  f"{name}: the keep-set AND did not launch the intersect kernel")
        rows[name] = row
        log(dict(phase="mxu_join", **row))
    # the mutation: the tiles must be repaired in place, not rebuilt.
    # DGRAPH_TPU_IVM_REPAIR=force pins the repair gate (within its delta
    # cap): the planner prices a repair of the whole arena's tiles
    # against two refills, and with the card's rates it may choose the
    # rebuild, which would leave the repair path untried
    text, adds, dels = mxu_mutation(arena, np.random.default_rng(MXU_SEED + 1))
    rep0 = IVM_REPAIRS.snapshot().get(("tile", "repaired"), 0)
    builds0 = JOIN_TILE_BUILDS.value()
    served = {}
    with env_set("DGRAPH_TPU_IVM_REPAIR", "force"):
        status, raw, _secs = post(srv.addr, text)
        check(status == 200, f"phase mxu_join mutation: HTTP {status}: {raw[:300]!r}")
        # served first: the served arenas take the store's journal of
        # the write; a host-route engine built after it reads the store
        # afresh
        for name, q, _shape in queries[:2]:
            with mxu_mode("1"):
                status, raw, secs = post(srv.addr, q, "?debug=true")
            check(status == 200, f"{name} after the mutation: HTTP {status}")
            served[name] = (raw, secs)
    rep1 = IVM_REPAIRS.snapshot().get(("tile", "repaired"), 0)
    builds1 = JOIN_TILE_BUILDS.value()
    ref = host_engine(store)
    after = {"adds": len(adds), "dels": len(dels), "tile_repairs": rep1 - rep0,
             "tile_builds": builds1 - builds0}
    for name, q, _shape in queries[:2]:
        raw, secs = served[name]
        want = json.dumps(ref.run(q))
        check(strip_latency(raw) == want,
              f"{name} after the mutation: body differs from the host route")
        eng_st = json.loads(raw)["server_latency"]["engine"]
        check([d["route"] for d in eng_st.get("join_routes", [])] == ["mxu"],
              f"{name} after the mutation did not take the tile route")
        after[name] = {"ms": secs * 1e3, "mxu_join_ms": eng_st["mxu_join_ms"],
                       "tile_build_ms": eng_st["tile_build_ms"],
                       "count": json.loads(want)["q"][0]["count"]}
    check(rep1 == rep0 + 1 and builds1 == builds0,
          f"the mutation's tiles: {rep1 - rep0} repairs, "
          f"{builds1 - builds0} builds (want 1, 0)")
    # the repaired tiles equal a fresh build over the post-delta CSR
    arena = eng.arenas.data("friend")
    pt = arena.tiles()
    fresh = spgemm.build_tiles(arena.h_src, arena.h_offsets, arena.host_dst(),
                               device=pt.tiles.device)
    check(all(bool((getattr(pt, f) == getattr(fresh, f)).all())
              for f in ("bi", "bj", "tiles", "degs")),
          "the repaired tiles differ from a fresh build")
    rows["after_mutation"] = after
    log(dict(phase="mxu_join_mutation", **rows["after_mutation"]))
    return rows, queries


def tri_graph(seed: int):
    """bench.py's generator at bench_ops.py's triangle shape (its seed)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(1, TRI_NODES + 1, size=TRI_EDGES)
    pop = rng.pareto(1.2, size=TRI_EDGES).astype(np.float64) + 1.0
    dst = (np.clip(pop / pop.max(), 1e-9, 1.0) * (TRI_NODES - 1)).astype(np.int64) + 1
    half = TRI_EDGES // 2
    dst[:half] = rng.integers(1, TRI_NODES + 1, size=half)
    return src, dst


def mxu_ops_check() -> dict:
    """expand_mask_batch and triangle_mask_batch on the card against the
    same calls on the CPU (masks equal) at bench_ops.py's shape."""
    import torch

    from dgraph_tpu_torch.models.arena import csr_from_edges
    from dgraph_tpu_torch.ops import spgemm

    built = {}
    for dev in ("cpu", "cuda"):
        pts = []
        for seed in (5, 6):
            a = csr_from_edges(*tri_graph(seed), "cpu")
            pts.append(spgemm.build_tiles(a.h_src, a.h_offsets, a.host_dst(),
                                          device=dev))
        built[dev] = pts
    pt, pr = built["cpu"]
    m = spgemm.mask_lanes(max(pt.universe, pr.universe))
    rng = np.random.default_rng(17)
    xm = np.zeros((TRI_B, m), np.float32)
    for i in range(TRI_B):
        xm[i, np.unique(rng.integers(1, TRI_NODES, size=TRI_ROOTS))] = 1.0
    out = {}
    for dev in ("cpu", "cuda"):
        a, r = built[dev]
        x = torch.from_numpy(xm).to(dev)
        exp = spgemm.expand_mask_batch(a.bi, a.bj, a.tiles, x)
        tri = spgemm.triangle_mask_batch(a.bi, a.bj, a.tiles, a.bi, a.bj, a.tiles,
                                         r.bi, r.bj, r.tiles, x)
        out[dev] = (exp.cpu(), tri.cpu())
    for g, w, what in zip(out["cuda"], out["cpu"], ("expand_mask_batch",
                                                     "triangle_mask_batch")):
        check(torch.equal(g, w), f"spgemm_ops: {what} on the card differs from the CPU")
    res = {"nodes": TRI_NODES, "edges": TRI_EDGES, "roots": TRI_ROOTS, "B": TRI_B,
           "mask_lanes": m, "tiles": [pt.n_tiles, pr.n_tiles],
           "expand_ones": int(out["cpu"][0].sum()),
           "triangle_ones": int(out["cpu"][1].sum()), "equal": True}
    check(res["expand_ones"] > 0 and res["triangle_ones"] > 0,
          "spgemm_ops: the check's masks are empty")
    return res


def mask_chain_timing(srv, queries) -> dict:
    """run_mask_chain at (m1)'s shape (the served tiles, (m1)'s seeds, two
    levels, no keep) three ways, beside its bound: the bytes the chain
    must move (the K stored tiles read once a level, each level's input
    and output mask) and its float32 operations (2·T·T a stored tile a
    level) at the card's peaks."""
    import torch

    from dgraph_tpu_torch.ops import spgemm

    arena = srv.engine.arenas.data("friend")
    pt = arena.tiles()
    _name, q, _shape = queries[0]
    seeds = np.array([int(x, 16) for x in q.split("uid(")[1].split(")")[0].split(", ")])
    m = spgemm.mask_lanes(pt.universe, pt.t)
    x0 = spgemm.uids_to_mask(torch.from_numpy(seeds.astype(np.int32)).cuda(), m)
    levels = 2
    ops_ = ((pt.bi, pt.bj, pt.tiles),) * levels

    def call():
        return spgemm.run_mask_chain(ops_, (None,) * levels, (pt.degs,) * levels, x0)

    t = kernel_times(call)
    bytes_ = levels * (pt.n_tiles * pt.t * pt.t * 4 + 2 * m * 4)
    flops = levels * pt.n_tiles * pt.t * pt.t * 2
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / 67e12 * 1e3  # float32 outside the tensor cores
    return {**t, "levels": levels, "stored_tiles": pt.n_tiles,
            "padded_tiles": int(pt.tiles.shape[0]), "mask_lanes": m,
            "seeds": len(seeds), "bytes": bytes_, "flops": flops,
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}




# -- phase 17: durability ----------------------------------------------------


def np_csr(src, dst):
    """The generated edges as a host CSR (sorted sources, their targets)
    for numpy's hops."""
    order = np.argsort(src, kind="stable")
    return src[order], dst[order]


def np_hop(csr, frontier, extra=None) -> np.ndarray:
    """Sorted distinct targets of ``frontier`` in the host CSR, and in
    ``extra`` (src, dst arrays of edges written since) when given."""
    s, d = csr
    lo = np.searchsorted(s, frontier, "left")
    n = np.searchsorted(s, frontier, "right") - lo
    idx = np.repeat(lo - np.cumsum(n) + n, n) + np.arange(int(n.sum()))
    out = d[idx]
    if extra is not None:
        out = np.concatenate([out, extra[1][np.isin(extra[0], frontier)]])
    return np.unique(out)


def check_materialised(body: bytes, seeds, csr, extra) -> None:
    """A ``two_hop(seeds)`` body against numpy: every seed in order, its
    ``e`` children and theirs, each list the sorted distinct targets."""
    nodes = json.loads(body)["q"]
    check([n["_uid_"] for n in nodes] == ["0x%x" % u for u in seeds],
          "materialised 2-hop: the root nodes differ from the seeds")
    for n in nodes:
        kids = n.get("e", [])
        want = np_hop(csr, np.array([int(n["_uid_"], 16)]), extra)
        check([k["_uid_"] for k in kids] == ["0x%x" % u for u in want.tolist()],
              f"materialised 2-hop: the children of {n['_uid_']} differ from numpy's")
        for k in kids:
            want = np_hop(csr, np.array([int(k["_uid_"], 16)]), extra)
            check([g["_uid_"] for g in k.get("e", [])] == ["0x%x" % u for u in want.tolist()],
                  f"materialised 2-hop: the children of {k['_uid_']} differ from numpy's")


def metric(addr: str, name: str) -> float:
    """One unlabeled series of GET /metrics."""
    with urllib.request.urlopen(addr + "/metrics", timeout=60) as r:
        for line in r.read().decode().splitlines():
            if line.startswith(name + " "):
                return float(line.split()[1])
    raise SmokeFailure(f"/metrics has no {name}")


def get_json(addr: str, path: str) -> dict:
    with urllib.request.urlopen(addr + path, timeout=900) as r:
        return json.loads(r.read())


def boot_cli(device, p_dir, log_path, *flags, env=None):
    """Start ``python -m dgraph_tpu_torch.cli.server`` on ``device`` as a
    subprocess; returns (process, address, its recovery line, seconds
    from the spawn to ``serving on``).  Its stderr goes to ``log_path``."""
    cmd = [sys.executable, "-m", "dgraph_tpu_torch.cli.server", "--p", str(p_dir),
           "--port", "0", "--device", str(device), *flags]
    penv = dict(os.environ if env is None else env)
    penv["PYTHONPATH"] = str(ROOT) + os.pathsep + penv.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    with open(log_path, "ab") as err:
        proc = subprocess.Popen(cmd, cwd=str(ROOT), stdout=subprocess.PIPE,
                                stderr=err, text=True, env=penv)
    lines = []
    while True:
        line = proc.stdout.readline()
        if not line:
            proc.wait(timeout=60)
            tail = Path(log_path).read_text()[-3000:]
            raise SmokeFailure(f"server on {p_dir} exited ({proc.returncode}) "
                               f"before serving: {lines} {tail}")
        lines.append(line.strip())
        if line.startswith("serving on "):
            rec = [ln for ln in lines if ln.startswith("recovered ")]
            check(len(rec) == 1, f"no recovery line before serving: {lines}")
            return proc, line.split()[2], rec[0], time.perf_counter() - t0


def end_proc(proc, sig) -> None:
    """Send ``sig`` and reap the process (a kill after 60 s)."""
    if proc.poll() is None:
        proc.send_signal(sig)
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=60)


def served_on_device(stats: dict) -> bool:
    """A request's engine stats show a gather on the card: a fused pass's
    or a per-level resident hop's."""
    return (stats.get("fused_gathers", 0) > 0
            or stats.get("routes", {}).get("resident", 0) > 0)


def durability_load_file(work: Path, src, dst):
    """The loaded server's RDF file and schema (``default_rng(71)``):
    LOAD_EDGES edges ``<0x…> <f> <0x…> .`` drawn from the generated edges
    of sources 1..LOAD_SOURCES, LOAD_NAMES 3-word ``name`` literals on
    uids 1..LOAD_NAMES, shuffled together.  Returns the paths and the
    edges and names written."""
    import gzip

    rng = np.random.default_rng(LOAD_SEED)
    pool = np.flatnonzero(src <= LOAD_SOURCES)
    pick = pool[rng.choice(len(pool), size=LOAD_EDGES, replace=False)]
    fs, fd = src[pick], dst[pick]
    words = rng.integers(0, len(VOCAB), size=(LOAD_NAMES, NAME_WORDS))
    names = [" ".join(VOCAB[w] for w in row) for row in words]
    lines = ["<0x%x> <f> <0x%x> ." % (a, b) for a, b in zip(fs.tolist(), fd.tolist())]
    lines += ['<0x%x> <name> "%s" .' % (u + 1, n) for u, n in enumerate(names)]
    rdf = work / "load.rdf.gz"
    with gzip.open(rdf, "wt") as f:
        for k in rng.permutation(len(lines)).tolist():
            f.write(lines[k] + "\n")
    schema = work / "schema.txt"
    schema.write_text("name: string @index(term) .\nf: uid .\n")
    return rdf, schema, (fs, fd), words


def phase_durability(device, src, dst, card: str) -> dict:
    """The storage plane on ``device``: (a) the generated edges journaled
    by an in-process server on a ``--sync`` DurableStore, served, written
    to, abandoned; (b) recovered by the CLI server; (c) a second CLI
    server loaded by the loader and snapshotted, then SIGKILLed; (d) it
    recovered, then booted with a disk fault.  The caller zeroes the
    launch counts just before and reads them just after."""
    import gc
    import shutil
    import signal

    import torch

    from dgraph_tpu_torch.models.wal import DurableStore
    from dgraph_tpu_torch.ops import gather
    from dgraph_tpu_torch.serve.server import DgraphServer

    work = ROOT / "_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir()
    d1, d2, log_path = work / "d1", work / "d2", work / "servers.log"
    procs = []
    out = {"card": card}
    full_src, full_dst = src, dst  # d2's file draws from every edge
    src, dst = src[::D1_EDGE_SHARE], dst[::D1_EDGE_SHARE]
    try:
        # a. journal d1's edges in-process, serve, write, abandon
        t0 = time.perf_counter()
        store = DurableStore(str(d1), sync_writes=True)
        store.apply_schema("e: uid .")
        store.bulk_set_uid_edges("e", src, dst)
        out["journal_s"] = time.perf_counter() - t0
        out["d1_wal_bytes"] = os.path.getsize(d1 / "wal.log")
        srv = DgraphServer(store, device=device)
        srv.snapshotter.wal_bytes = D1_SNAPSHOT_WAL_MB << 20
        srv.start()
        csr = np_csr(src, dst)
        rng = np.random.default_rng(DUR_SEED)
        seeds = np.unique(rng.integers(1, int(src.max()) + 1, size=LARGE_SEEDS))
        count_q = two_hop_count(seeds)
        n0 = gather.KERNEL.launches
        t0 = time.perf_counter()
        status, raw, _ = post(srv.addr, count_q, "?debug=true")
        out["a_first_count_s"] = time.perf_counter() - t0
        check(status == 200, f"durability (a) count: HTTP {status}")
        out["a_first_count_latency"] = json.loads(raw)["server_latency"]
        check(gather.KERNEL.launches > n0, "durability (a): the 2-hop count launched no gather")
        want = len(np_hop(csr, np_hop(csr, seeds)))
        check(json.loads(raw)["q"] == [{"count": want}],
              f"durability (a) count {raw[:120]!r} != numpy's {want}")
        movers = np.unique(rng.integers(1, int(src.max()) + 1, size=DUR_SEEDS))
        new_dst = rng.integers(1, int(src.max()) + 1,
                               size=(len(movers), DUR_EDGES // DUR_SEEDS))
        new = [(int(a), int(b)) for a, row in zip(movers, new_dst) for b in row]
        mu = "mutation { set {\n%s\n} }" % "\n".join("<0x%x> <e> <0x%x> ." % e for e in new)
        status, raw, secs = post(srv.addr, mu)
        check(status == 200 and json.loads(raw).get("code") == "Success",
              f"durability (a) mutation: HTTP {status} {raw[:200]!r}")
        out["a_mutation_ms"] = secs * 1e3
        extra = (np.array([a for a, _ in new]), np.array([b for _, b in new]))
        status, count_body, _ = post(srv.addr, count_q)
        want = len(np_hop(csr, np_hop(csr, seeds, extra), extra))
        check(status == 200 and json.loads(count_body)["q"] == [{"count": want}],
              "durability (a) count after the write differs from numpy's")
        mat_q = two_hop(movers)
        status, mat_body, _ = post(srv.addr, mat_q)
        check(status == 200, f"durability (a) materialised 2-hop: HTTP {status}")
        check_materialised(mat_body, movers, csr, extra)
        by_uid = {n["_uid_"]: n for n in json.loads(mat_body)["q"]}
        for a, b in new:
            kids = {k["_uid_"] for k in by_uid["0x%x" % a].get("e", [])}
            check("0x%x" % b in kids, f"durability (a): new edge 0x{a:x} -> 0x{b:x} missing")
        bodies = {"count": strip_latency(count_body), "materialised": strip_latency(mat_body)}
        store.close = lambda: None  # abandoned: the WAL is never closed
        srv.stop()
        del srv, store, csr
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        out["d1_wal_bytes_after_write"] = os.path.getsize(d1 / "wal.log")
        log({"phase": "durability_journal", **{k: out[k] for k in (
            "journal_s", "d1_wal_bytes", "a_first_count_s", "a_first_count_latency",
            "a_mutation_ms", "d1_wal_bytes_after_write")}, "seeds": len(seeds),
            "edge_sample": f"every {D1_EDGE_SHARE}th generated edge", "edges": len(src),
            "new_edges": len(new), "count": want})

        # b. recover d1 on the real entry point
        env = dict(os.environ, DGRAPH_TPU_CACHE="0")  # every repeat executes
        t_spawn = time.perf_counter()
        proc, addr, rec_line, boot_s = boot_cli(
            device, d1, log_path, "--arena_budget_mb", str(DUR_ARENA_MB),
            "--snapshot_wal_mb", str(D1_SNAPSHOT_WAL_MB), env=env)
        procs.append(proc)
        status, raw, first_s = post(addr, count_q, "?debug=true")
        recover_s = time.perf_counter() - t_spawn
        check(status == 200 and strip_latency(raw) == bodies["count"],
              f"recovered d1: the 2-hop count differs ({status} {raw[:200]!r})")
        first_latency = json.loads(raw)["server_latency"]
        status, raw, _ = post(addr, mat_q)
        check(status == 200 and strip_latency(raw) == bodies["materialised"],
              "recovered d1: the materialised 2-hop differs from before the crash")
        status, raw, _ = post(addr, count_q, "?debug=true")
        stats = json.loads(raw)["server_latency"]["engine"]
        check(served_on_device(stats), f"recovered d1: the count was not served on the card: {stats}")
        lat = []
        for _ in range(DUR_REPEATS):
            status, raw, secs = post(addr, count_q)
            check(status == 200 and strip_latency(raw) == bodies["count"],
                  "recovered d1: a repeat of the count differs")
            lat.append(secs)
        out["d1"] = {
            "recovery_line": rec_line, "boot_to_serving_s": boot_s,
            "first_count_s": first_s, "first_count_latency": first_latency,
            "time_to_recover_s": recover_s,
            "dgraph_recovery_records": metric(addr, "dgraph_recovery_records"),
            "dgraph_recovery_seconds": metric(addr, "dgraph_recovery_seconds"),
            "count_p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "count_p99_ms": p99([x * 1e3 for x in lat]),
            "debug_engine": {k: stats.get(k) for k in ("routes", "fused_gathers",
                                                        "chain_fused_levels", "edges")},
        }
        check(rec_line.startswith(f"recovered {d1}: records=4 (snapshot 0, segments 0, wal 4)"),
              f"d1 must recover from its WAL alone: {rec_line}")
        log(dict(phase="durability_recover_d1", card=card, **out["d1"]))
        end_proc(proc, signal.SIGTERM)

        # c. load and snapshot a second server
        rdf, schema, (fs, fd), words = durability_load_file(work, full_src, full_dst)
        proc, addr, rec_line, _ = boot_cli(
            device, d2, log_path, "--sync", "--snapshot_wal_records", str(LOAD_SNAPSHOT_RECORDS),
            "--arena_budget_mb", "1024", "--export", str(work / "export"))
        procs.append(proc)
        check("records=0 " in rec_line, f"d2 is not empty: {rec_line}")
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "dgraph_tpu_torch.cli.loader", "-r", str(rdf),
             "-s", str(schema), "-d", addr, "--batch", "1000", "-c", "4"],
            cwd=str(ROOT), capture_output=True, text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=str(ROOT)))
        load_s = time.perf_counter() - t0
        check(r.returncode == 0, f"loader failed: {r.stderr[-2000:]}")
        n_quads = LOAD_EDGES + LOAD_NAMES
        check(f"loaded {n_quads} quads" in r.stdout, f"loader: {r.stdout!r}")
        with urllib.request.urlopen(addr + "/metrics", timeout=60) as resp:
            routes = [ln for ln in resp.read().decode().splitlines()
                      if ln.startswith("dgraph_bulk_set_quads_total{")]
        check(routes == ['dgraph_bulk_set_quads_total{route="native"} %d' % n_quads],
              f"the native bulk path did not take the whole load: {routes}")
        deadline = time.monotonic() + 30
        while metric(addr, "dgraph_snapshots_total") < 1 and time.monotonic() < deadline:
            time.sleep(0.2)
        snaps_under_load = metric(addr, "dgraph_snapshots_total")
        check(snaps_under_load >= 1, "the snapshotter never fired under the load")
        t0 = time.perf_counter()
        check(get_json(addr, "/admin/snapshot?wait=1")["code"] == "Success",
              "/admin/snapshot failed")
        snap_s = time.perf_counter() - t0
        st = get_json(addr, "/debug/store")["predicates"]
        stored = st["f"]["edges"] + st["name"]["values"]
        # a tail after the snapshot: it must come back from the WAL
        tail_src = np.unique(fs[:LOAD_TAIL])
        tail = [(int(a), int(a) % LOAD_SOURCES + 1) for a in tail_src]
        mu = "mutation { set {\n%s\n} }" % "\n".join("<0x%x> <f> <0x%x> ." % e for e in tail)
        status, raw, _ = post(addr, mu)
        check(status == 200, f"d2 tail mutation: HTTP {status}")
        csr2 = np_csr(np.concatenate([fs, [a for a, _ in tail]]),
                      np.concatenate([fd, [b for _, b in tail]]))
        seeds2 = np.unique(np.random.default_rng(LOAD_SEED + 1).integers(
            1, LOAD_SOURCES + 1, size=DUR_SEEDS))
        hop_q = "{ q(func: uid(%s)) { uid f { uid f { uid } } } }" % uid_list(seeds2)
        status, hop_body, _ = post(addr, hop_q)
        got = {k["_uid_"] for n in json.loads(hop_body)["q"] for c in n.get("f", [])
               for k in c.get("f", [])}
        want2 = {"0x%x" % u for u in np_hop(csr2, np_hop(csr2, seeds2)).tolist()}
        check(status == 200 and got == want2, "d2: the 2-hop over f differs from numpy's")
        w0, w1 = VOCAB[0], VOCAB[1]
        terms_q = '{ q(func: allofterms(name, "%s %s")) { count() } }' % (w0, w1)
        status, terms_body, _ = post(addr, terms_q)
        want_terms = int(((words == 0).any(1) & (words == 1).any(1)).sum())
        check(status == 200 and json.loads(terms_body)["q"] == [{"count": want_terms}],
              f"d2: allofterms count {terms_body[:120]!r} != numpy's {want_terms}")
        exported = get_json(addr, "/admin/export")["nquads"]
        n_edges = len(np.unique((csr2[0] << 32) | csr2[1]))
        check(exported == n_edges + LOAD_NAMES,
              f"d2: export wrote {exported} lines, not {n_edges + LOAD_NAMES}")
        d2_bodies = {"hop": strip_latency(hop_body), "terms": strip_latency(terms_body)}
        out["d2_load"] = {
            "quads": n_quads, "load_s": load_s, "quads_per_s": n_quads / load_s,
            "loader_line": r.stdout.strip().splitlines()[-1],
            "snapshots_under_load": snaps_under_load,
            "snapshot_s": snap_s, "snapshot_records": stored,
            "snapshot_edges_per_s": stored / snap_s,
            "wal_bytes_before_kill": os.path.getsize(d2 / "wal.log"),
            "export_lines": exported,
        }
        log(dict(phase="durability_load_d2", card=card, **out["d2_load"]))
        end_proc(proc, signal.SIGKILL)

        # d. recover the snapshot, then the read-only mode
        t_spawn = time.perf_counter()
        proc, addr, rec_line, _ = boot_cli(device, d2, log_path, "--arena_budget_mb", "1024",
                                           "--export", str(work / "export"))
        procs.append(proc)
        status, raw, _ = post(addr, hop_q)
        recover_s = time.perf_counter() - t_spawn
        check(status == 200 and strip_latency(raw) == d2_bodies["hop"],
              "recovered d2: the 2-hop over f differs")
        status, raw, _ = post(addr, terms_q)
        check(status == 200 and strip_latency(raw) == d2_bodies["terms"],
              "recovered d2: the allofterms count differs")
        check(get_json(addr, "/admin/export")["nquads"] == exported,
              "recovered d2: the export's line count differs")
        last = get_json(addr, "/health?detail=1")["storage"]["last_recovery"]
        check(last["snapshot_records"] > 0 and last["wal_records"] > 0,
              f"recovered d2 read no snapshot or no WAL tail: {last}")
        out["d2_recover"] = {"recovery_line": rec_line, "time_to_recover_s": recover_s,
                             "last_recovery": last}
        log(dict(phase="durability_recover_d2", card=card, **out["d2_recover"]))
        end_proc(proc, signal.SIGTERM)
        env = dict(os.environ, DGRAPH_TPU_FAILPOINTS="wal.append=error(n=1)")
        proc, addr, _, _ = boot_cli(device, d2, log_path, "--arena_budget_mb", "1024", env=env)
        procs.append(proc)
        ro_mu = "mutation { set {\n<0x1> <f> <0x%x> .\n} }" % (LOAD_SOURCES + 7)
        status, raw, headers, _ = post_any(addr, ro_mu)
        check(status == 503 and int(headers.get("Retry-After", "0")) >= 1,
              f"read-only: the mutation answered {status} {headers}")
        status, raw, _ = post(addr, hop_q)
        check(status == 200 and strip_latency(raw) == d2_bodies["hop"],
              "read-only: the read did not answer as before")
        t0 = time.perf_counter()
        while get_json(addr, "/health?detail=1")["storage"]["readonly"]:
            check(time.perf_counter() - t0 < 60, "read-only: the probe never re-armed")
            time.sleep(0.1)
        rearm_s = time.perf_counter() - t0
        status, raw, _ = post(addr, ro_mu)
        check(status == 200, f"re-armed: the mutation answered {status}")
        status, raw, _ = post(addr, "{ q(func: uid(0x1)) { f { uid } } }")
        check("0x%x" % (LOAD_SOURCES + 7) in raw.decode(),
              "re-armed: the write is missing from the next read")
        out["readonly"] = {"shed_status": 503, "read_status": 200, "rearm_s": rearm_s}
        log(dict(phase="durability_readonly", **out["readonly"]))
        end_proc(proc, signal.SIGTERM)
        return out
    finally:
        for p in procs:
            end_proc(p, signal.SIGKILL)
        shutil.rmtree(work, ignore_errors=True)


# -- phase 18: the cluster ----------------------------------------------------


def host_used_g() -> int:
    """The host's used memory, GiB (``free -g``'s Mem line)."""
    out = subprocess.run(["free", "-g"], capture_output=True, text=True).stdout
    return int(next(ln for ln in out.splitlines() if ln.startswith("Mem:")).split()[2])


def free_ports(n: int) -> list:
    import socket

    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def wait_until(cond, timeout: float, msg: str, step: float = 0.05) -> float:
    """Poll ``cond`` until true; returns the seconds it took, fails the
    phase after ``timeout``."""
    t0 = time.perf_counter()
    while not cond():
        check(time.perf_counter() - t0 < timeout, msg)
        time.sleep(step)
    return time.perf_counter() - t0


def post_retry(addr: str, text: str, timeout: float = CLUSTER_WAIT_S, context=None):
    """POST a write to a cluster server, retrying the answers a leader
    change produces (no leader yet, a proposal timed out, a peer down:
    400 with a retry message, 409, 5xx) under one bounded deadline; a
    deterministic error fails at once.  ``context``: see ``post_any``."""
    t0 = time.perf_counter()
    while True:
        status, raw, _h, secs = post_any(addr, text, context=context)
        if status == 200:
            return raw, secs
        msg = raw.decode("utf-8", "replace").lower()
        transient = status == 409 or status >= 500 or (status == 400 and any(
            w in msg for w in ("leader", "retry", "timed out", "unavailable",
                               "no known server")))
        check(transient and time.perf_counter() - t0 < timeout,
              f"cluster write to {addr}: HTTP {status} {raw[:300]!r}")
        time.sleep(0.5)


def boot_cluster(device, base: Path, groups_by_node, peer_groups: str = ""):
    """Servers on ``device``, one ``ClusterService`` each under ``base``
    (node ids 1..n, every one in this process: each server's engine owns
    its arenas on the card), the groups ``CLUSTER_CONF`` places;
    returns them once every group of every server knows a leader."""
    from dgraph_tpu_torch.cluster.groups import GroupConfig
    from dgraph_tpu_torch.cluster.service import ClusterService, parse_peer_groups
    from dgraph_tpu_torch.serve.server import DgraphServer

    ports = free_ports(len(groups_by_node))
    peers = {str(i + 1): f"http://127.0.0.1:{p}" for i, p in enumerate(ports)}
    servers = []
    for i, gids in enumerate(groups_by_node):
        nid = str(i + 1)
        svc = ClusterService(
            node_id=nid, my_addr=peers[nid], peers=peers, group_ids=gids,
            directory=str(base / f"n{nid}"),
            group_config=GroupConfig.parse(CLUSTER_CONF),
            peer_groups=parse_peer_groups(peer_groups), tick_ms=CLUSTER_TICK_MS)
        svc.start()
        srv = DgraphServer(svc.store, port=ports[i], device=device, cluster=svc)
        srv.start()
        servers.append(srv)
    wait_until(lambda: all(s.cluster.has_leader() for s in servers), 60,
               "cluster: no raft leader elected")
    return servers


def group_leader(servers, gid: int):
    return next((s for s in servers if s.cluster.groups[gid].node.is_leader), None)


def group_follower(servers, gid: int):
    wait_until(lambda: group_leader(servers, gid) is not None, 60,
               f"cluster: group {gid} has no leader")
    return next(s for s in servers if not s.cluster.groups[gid].node.is_leader)


def name_items(n_named: int):
    """phase 5's names (the same words on the same uids) as BULKVALS items."""
    from dgraph_tpu_torch.models.types import TypeID, TypedValue

    rng = np.random.default_rng(NAME_SEED)
    words = np.asarray(VOCAB)[rng.integers(0, len(VOCAB), size=(n_named, NAME_WORDS))]
    return [(u, "", TypedValue(TypeID.STRING, " ".join(w)))
            for u, w in enumerate(words.tolist(), 1)]


def propose_retry(fn, retries: list, timeout: float = CLUSTER_WAIT_S) -> None:
    """Run one proposal ``fn`` as a client does: retry what a leader
    change answers (no leader known, leadership lost, a proposal or a
    peer timed out) under one bounded deadline, each retry's error
    appended to ``retries``; anything else fails."""
    from dgraph_tpu_torch.cluster.raft import NotLeaderError

    t0 = time.perf_counter()
    while True:
        try:
            return fn()
        except (NotLeaderError, TimeoutError, OSError) as e:
            check(time.perf_counter() - t0 < timeout, f"cluster proposal: {e!r}")
            retries.append(type(e).__name__)
        except RuntimeError as e:
            if "leadership lost" not in str(e):
                raise
            check(time.perf_counter() - t0 < timeout, f"cluster proposal: {e!r}")
            retries.append("leadership lost")
        time.sleep(0.2)


def replicate(servers, gid: int, pred: str, propose) -> float:
    """Run ``propose`` (writes submitted through a follower of ``gid``,
    which forwards each to the leader); returns the seconds until every
    replica of ``gid`` applied them (the same raft index last touched
    ``pred`` everywhere)."""
    t0 = time.perf_counter()
    propose()

    def everywhere():
        vs = {s.cluster.groups[gid].pred_version(pred) for s in servers}
        return len(vs) == 1 and vs.pop() > 0

    wait_until(everywhere, CLUSTER_WAIT_S, f"cluster: {pred} never applied everywhere")
    return time.perf_counter() - t0


def serve_node(srv, q: str, want: str, repeats: int, name: str) -> dict:
    """``q`` on one server ``repeats`` times, every body equal to
    ``want``; returns p50/p99 and each kernel's launches a request."""
    from dgraph_tpu_torch.ops import gather, kway

    g0, k0 = gather.KERNEL.launches, kway.KERNEL.launches
    lat = []
    for _ in range(repeats):
        status, raw, secs = post(srv.addr, q)
        check(status == 200, f"cluster {name} on node {srv.cluster.node_id}: HTTP {status}")
        check(strip_latency(raw) == want,
              f"cluster {name} on node {srv.cluster.node_id} differs from the host route")
        lat.append(secs)
    return {"requests": repeats,
            "p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p99_ms": p99([x * 1e3 for x in lat]),
            "gather_launches": gather.KERNEL.launches - g0,
            "intersect_launches": kway.KERNEL.launches - k0}


def delta_edges(store, seeds, n: int, rng):
    """``n`` edges to add and ``n`` to delete, from first-level nodes of
    ``seeds``, so that the 2-hop count from ``seeds`` moves."""
    edges = store.peek("e").edges
    f1 = sorted({t for s in seeds.tolist() for t in edges.get(s, ())})
    adds, dels = [], []
    for s in rng.permutation(f1).tolist():
        if len(adds) == n:
            break
        if not edges.get(s):
            continue
        dels.append((s, min(edges[s])))
        t = int(rng.integers(1, N_NODES + 1))
        while t in edges[s]:
            t = int(rng.integers(1, N_NODES + 1))
        adds.append((s, t))
    check(len(adds) == n, "cluster: too few first-level nodes for the write")
    return adds, dels


def edge_mutation(adds, dels) -> str:
    body = "mutation { set { %s } " % " ".join("<0x%x> <e> <0x%x> ." % e for e in adds)
    if dels:
        body += "delete { %s } " % " ".join("<0x%x> <e> <0x%x> ." % e for e in dels)
    return body + "}"


def apply_edges(store, adds, dels) -> None:
    from dgraph_tpu_torch.models.store import Edge

    store.apply_many([Edge("e", s, dst=t) for s, t in adds]
                     + [Edge("e", s, dst=t, op="del") for s, t in dels])


def answers_exactly(srv, q: str, want: str) -> bool:
    status, raw, _ = post(srv.addr, q)
    return status == 200 and strip_latency(raw) == want


def exact_everywhere(servers, q: str, want: str, at_once=(), what: str = "") -> dict:
    """``q`` asked of every server at once (one client thread each, as
    clients of a deployment ask): a server in ``at_once`` must answer
    ``want`` on its first request, the others within CLUSTER_WAIT_S;
    returns each node's seconds to its first exact answer.  A server's
    first read after a replica apply rebuilds its arena, so the three
    rebuilds overlap."""
    import threading

    out, errs = {}, []

    def ask(srv):
        t0 = time.perf_counter()
        try:
            if srv in at_once:
                check(answers_exactly(srv, q, want),
                      f"cluster {what}: node {srv.cluster.node_id}'s first answer is wrong")
            else:
                wait_until(lambda: answers_exactly(srv, q, want), CLUSTER_WAIT_S,
                           f"cluster {what}: node {srv.cluster.node_id} never "
                           "answered exactly", step=0.5)
            out[srv.cluster.node_id] = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 — re-raised below, in order
            errs.append(e)

    threads = [threading.Thread(target=ask, args=(s,)) for s in servers]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return out


def pair_trace(owner, reader, q: str, want: str) -> dict:
    """One sampled cross-group read on the pair: the reader's request
    (the remote snapshot re-validated with the owner, its TTL passed)
    records spans on both servers under one trace id, the owner's
    ``peer.pred-snapshot`` among them."""
    from dgraph_tpu_torch import obs

    rec = obs.configure(ratio=1e-9)  # armed: the header decides
    try:
        tid = "%032x" % (FLIGHT_SEED << 40 | 0x7A)
        time.sleep(2 * reader.store.remote_ttl)
        with no_caches(reader):
            status, raw, _h, secs = post_any(
                reader.addr, q, {"Traceparent": f"00-{tid}-{tid[16:]}-01"})
        check(status == 200 and strip_latency(raw) == want,
              "pair: the traced cross-server 2-hop differs from the host route")
        got = {}

        def legs():
            t = rec.trace(tid)
            if t is None:
                return False
            got["spans"] = t["spans"]
            nodes = {s["attrs"].get("node") for s in t["spans"]}
            return {"1", "2"} <= nodes and any(
                s["name"] == "peer.pred-snapshot" and s["attrs"]["node"] == "1"
                for s in t["spans"])

        wait_until(legs, 30, "pair: the traced read recorded no span on the owner")
        spans = got["spans"]
        check(all(s["trace_id"] == tid for s in spans), "pair: a span off the trace")
        snap = [s for s in spans if s["name"] == "peer.pred-snapshot"]
        return {"trace_id": tid, "spans": len(spans), "ms": secs * 1e3,
                "names": sorted({s["name"] for s in spans}),
                "nodes": sorted({s["attrs"]["node"] for s in spans
                                 if "node" in s["attrs"]}),
                "pred_snapshot": [{k: s["attrs"].get(k) for k in ("node", "pred", "bytes")}
                                  for s in snap]}
    finally:
        obs.configure()


def phase_cluster(device, src, dst, card: str) -> dict:
    """(t) a replicated trio and (p) a sharded pair on ``device``, every
    server in this process; the caller zeroes the launch counts just
    before and reads them just after."""
    import gc
    import shutil
    from collections import Counter

    from dgraph_tpu_torch.models import PostingStore
    from dgraph_tpu_torch.ops import gather

    work = ROOT / "_smoke" / "cluster"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    patience = os.environ.get("DGRAPH_TPU_PROPOSE_TIMEOUT")
    # a forwarded proposal of the whole graph commits and applies in
    # tens of seconds: the proposer must outwait it, or the forwarder
    # re-posts a duplicate behind the running original
    os.environ["DGRAPH_TPU_PROPOSE_TIMEOUT"] = str(CLUSTER_WAIT_S)
    free = subprocess.run(["free", "-g"], capture_output=True, text=True).stdout
    log({"phase": "cluster_host", "free_g": free.strip().splitlines()})
    servers = []
    out = {"card": card}
    try:
        rng = np.random.default_rng(GRAPH_SEED)
        rng.integers(1, N_NODES + 1, size=SMALL_SEEDS)
        seeds = np.unique(rng.integers(1, N_NODES + 1, size=LARGE_SEEDS))
        jrng = np.random.default_rng(JOIN_SEED)
        s1, s2 = (np.unique(jrng.integers(1, N_NODES + 1, size=LARGE_SEEDS))
                  for _ in range(2))
        items = name_items(N_NAMED)
        schema = "e: uid .\nname: string @index(term) ."

        # -- (t): the replicated trio (every TRIO_EDGE_SHARE-th edge) -----
        tsrc, tdst = src[::TRIO_EDGE_SHARE], dst[::TRIO_EDGE_SHARE]
        n_t, titems = len(tsrc), items[:TRIO_NAMED]
        t0 = time.perf_counter()
        ref_store = PostingStore()
        ref_store.apply_schema(schema)
        ref_store.bulk_set_uid_edges("e", tsrc, tdst)
        ref_store.bulk_set_values("name", titems)
        ref = host_engine(ref_store)
        queries = {"count": two_hop_count(seeds), "materialised": two_hop(seeds),
                   "join_a": join_filter_query(s1, s2)}
        want = {n: json.dumps(ref.run(q)) for n, q in queries.items()}
        check(json.loads(want["join_a"]).get("q"), "cluster: join (a) matched nothing")
        ref_s = time.perf_counter() - t0
        servers = boot_cluster(device, work / "t", [[0, 1, 2]] * 3)
        for srv in servers:
            srv.engine.expand_device_min = 1
            srv.engine.arenas.kway_device_min = 1
        post_retry(group_follower(servers, 0).addr,
                   "mutation { schema { %s } }" % schema.replace("\n", " "))
        order = np.argsort(tsrc, kind="stable")
        bsrc, bdst = tsrc[order], tdst[order]
        edge_cuts = range(0, len(bsrc), CLUSTER_RECORD_EDGES)
        name_cuts = range(0, len(titems), CLUSTER_RECORD_NAMES)
        f1 = group_follower(servers, 1)
        retries = {"1": [], "2": []}
        apply_s = {"1": replicate(servers, 1, "e", lambda: [propose_retry(
            lambda i=i: f1.store.bulk_set_uid_edges(
                "e", bsrc[i:i + CLUSTER_RECORD_EDGES], bdst[i:i + CLUSTER_RECORD_EDGES]),
            retries["1"]) for i in edge_cuts])}
        f2 = group_follower(servers, 2)
        apply_s["2"] = replicate(servers, 2, "name", lambda: [propose_retry(
            lambda i=i: f2.store.bulk_set_values("name", titems[i:i + CLUSTER_RECORD_NAMES]),
            retries["2"]) for i in name_cuts])
        del bsrc, bdst, order
        out["replicate_s"] = apply_s
        log({"phase": "cluster_replicate", "servers": 3, "groups": [0, 1, 2],
             "conf": CLUSTER_CONF, "edges_generated": n_t,
             "edge_sample": f"every {TRIO_EDGE_SHARE}th generated edge",
             "edges_stored": sum(len(v) for v in ref_store.peek("e").edges.values()),
             "named": len(titems), "gates": 1, "via_follower": {"1": f1.cluster.node_id,
                                                   "2": f2.cluster.node_id},
             "records": {"1": len(edge_cuts), "2": len(name_cuts)},
             "retried": {g: dict(Counter(v)) for g, v in retries.items()},
             "tick_ms": CLUSTER_TICK_MS,
             "proposal_to_applied_s": apply_s, "host_reference_s": ref_s,
             "card": card})
        caches = contextlib.ExitStack()
        for srv in servers:
            caches.enter_context(no_caches(srv))
        g0 = gather.KERNEL.launches
        first = exact_everywhere(servers, queries["count"], want["count"],
                                 at_once=servers, what="first count")
        check(gather.KERNEL.launches > g0, "cluster: the first counts launched no gather")
        nodes = {}
        for srv in servers:  # one server at a time: each line its own latency
            nid = srv.cluster.node_id
            row = {"first_answer_s": first[nid]}
            row["count"] = serve_node(srv, queries["count"], want["count"],
                                      CLUSTER_REPEATS, "count")
            row["materialised"] = serve_node(srv, queries["materialised"],
                                             want["materialised"], 1, "materialised")
            row["join_a"] = serve_node(srv, queries["join_a"], want["join_a"],
                                       CLUSTER_REPEATS, "join (a)")
            check(row["count"]["gather_launches"] > 0
                  and row["materialised"]["gather_launches"] > 0,
                  f"cluster: node {nid}'s requests launched no gather")
            check(row["join_a"]["intersect_launches"] >= CLUSTER_REPEATS,
                  f"cluster: node {nid}'s join (a) did not launch the intersect")
            nodes[nid] = row
            log(dict(phase="cluster_node", node=nid, card=card, **row))
        out["nodes"] = nodes

        # the write through the third server: the group-1 leader answers
        # the new count at once, the followers within a bounded wait
        adds, dels = delta_edges(ref_store, seeds, CLUSTER_DELTA,
                                 np.random.default_rng(CLUSTER_SEED))
        writer = servers[2]
        _raw, write_s = post_retry(writer.addr, edge_mutation(adds, dels))
        apply_edges(ref_store, adds, dels)
        new_count = json.dumps(ref.run(queries["count"]))
        check(new_count != want["count"], "cluster: the write left the count unchanged")
        leader = group_leader(servers, 1)
        check(leader is not None, "cluster: group 1 lost its leader at the write")
        converge = exact_everywhere(servers, queries["count"], new_count,
                                    at_once=(leader,), what="count after the write")
        # every replica now holds its store, a snapshot copy and arenas
        out["write"] = {"added": len(adds), "deleted": len(dels), "via": writer.cluster.node_id,
                        "ack_s": write_s, "leader": leader.cluster.node_id,
                        "exact_after_s": converge, "host_used_g": host_used_g()}
        log(dict(phase="cluster_write", card=card, **out["write"]))

        # failover: stop the group-1 leader's server
        survivors = [s for s in servers if s is not leader]
        t0 = time.perf_counter()
        leader.stop()  # a graceful stop: it hands its leaderships over
        stop_s = time.perf_counter() - t0
        servers.remove(leader)
        wait_until(lambda: group_leader(survivors, 1) is not None,
                   CLUSTER_WAIT_S, "failover: no new group-1 leader")
        elect_s = time.perf_counter() - t0
        adds2, _ = delta_edges(ref_store, seeds, CLUSTER_DELTA,
                               np.random.default_rng(CLUSTER_SEED + 1))
        post_retry(survivors[0].addr, edge_mutation(adds2, []))
        ack_s = time.perf_counter() - t0
        apply_edges(ref_store, adds2, [])
        fail_count = json.dumps(ref.run(queries["count"]))
        exact = exact_everywhere(survivors, queries["count"], fail_count,
                                 what="count after the failover")
        out["failover"] = {"stopped": leader.cluster.node_id, "stop_s": stop_s,
                           "elected_s": elect_s,
                           "new_leader": group_leader(survivors, 1).cluster.node_id,
                           "acknowledged_write_s": ack_s, "exact_after_s": exact}
        log(dict(phase="cluster_failover", card=card, **out["failover"]))
        caches.close()
        for srv in survivors:
            srv.stop()
        servers = []
        del ref, ref_store, survivors, leader, writer, f1, f2
        gc.collect()

        # -- (p): the sharded pair (1/PAIR_EDGE_SHARE of the edges) -------
        n_e = len(src) // PAIR_EDGE_SHARE
        ps, pd_ = src[:n_e], dst[:n_e]
        pitems = items[:PAIR_NAMED]
        ref_store = PostingStore()
        ref_store.apply_schema(schema)
        ref_store.bulk_set_uid_edges("e", ps, pd_)
        ref_store.bulk_set_values("name", pitems)
        ref = host_engine(ref_store)
        q = "{ q(func: uid(%s)) { uid e { uid e { uid name } } } }" % uid_list(seeds)
        want_p = json.dumps(ref.run(q))
        servers = boot_cluster(device, work / "p", [[0, 1], [0, 2]], "1=0,1;2=0,2")
        owner, reader = servers
        post_retry(owner.addr, "mutation { schema { %s } }" % schema.replace("\n", " "))
        propose_retry(lambda: owner.store.bulk_set_uid_edges("e", ps, pd_), [])
        propose_retry(lambda: reader.store.bulk_set_values("name", pitems), [])
        fetches = []
        fetch = reader.cluster.fetch_pred_snapshot

        def recorded(pred, gid, since, timeout=10.0):
            t0 = time.perf_counter()
            ver, payload = fetch(pred, gid, since, timeout)
            fetches.append((pred, time.perf_counter() - t0,
                            0 if payload is None else len(payload)))
            return ver, payload

        reader.cluster.fetch_pred_snapshot = recorded
        reader.engine.expand_device_min = 1  # the 1/64 graph's 2-hop is below the gate
        with no_caches(reader):
            g0 = gather.KERNEL.launches
            t0 = time.perf_counter()
            status, raw, _ = post(reader.addr, q)
            first_s = time.perf_counter() - t0
            check(status == 200 and strip_latency(raw) == want_p,
                  "pair: the cross-server 2-hop differs from the host route")
            row = serve_node(reader, q, want_p, 3, "pair 2-hop")
        launches = gather.KERNEL.launches - g0
        check(launches > 0, "pair: the cross-server 2-hop launched no gather on node 2")
        trace = pair_trace(owner, reader, q, want_p)
        e_fetch = [f for f in fetches if f[0] == "e" and f[2] > 0]
        check(e_fetch, "pair: node 2 never fetched e from node 1")
        owned = {n: sorted(p for g in s.cluster.groups.values() for p in g.store._preds)
                 for n, s in (("1", owner), ("2", reader))}
        check("e" in owned["1"] and "e" not in owned["2"], f"pair: placement {owned}")
        out["pair"] = {"edges": n_e, "named": len(pitems), "seeds": len(seeds),
                       "first_request_s": first_s, "first_fetch_s": e_fetch[0][1],
                       "first_fetch_bytes": e_fetch[0][2], "gather_launches": launches,
                       "p50_ms": row["p50_ms"], "p99_ms": row["p99_ms"],
                       "placement": owned, "body_bytes": len(want_p),
                       "trace": trace}
        log(dict(phase="cluster_pair", card=card, **out["pair"]))
        out["launches_by_node"] = {
            **{f"t{n}": {"gather": r["count"]["gather_launches"]
                         + r["materialised"]["gather_launches"]
                         + r["join_a"]["gather_launches"],
                         "intersect": r["join_a"]["intersect_launches"]}
               for n, r in nodes.items()},
            "p2": {"gather": launches}}
        log({"phase": "cluster_launches_by_node", "card": card, **out["launches_by_node"]})
        return out
    finally:
        for srv in servers:
            srv.stop()
        if patience is None:
            os.environ.pop("DGRAPH_TPU_PROPOSE_TIMEOUT", None)
        else:
            os.environ["DGRAPH_TPU_PROPOSE_TIMEOUT"] = patience
        shutil.rmtree(work, ignore_errors=True)


# -- phases 14-16: the batched 2-hop -----------------------------------------


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def phase_dense(device, src, dst, n_nodes: int, n_queries: int = BATCH_QUERIES):
    """The graph phase's edges as a dense arena in the grouped inline
    layout on ``device``, the query frontiers and the pipeline's plan."""
    from dgraph_tpu_torch import bench2hop, ops
    from dgraph_tpu_torch.models.arena import csr_dense_from_edges

    t0 = time.perf_counter()
    a = csr_dense_from_edges(src, dst, n_nodes, device)
    t1 = time.perf_counter()
    metap, ov = a.inline_layout_grouped()
    _sync(a.device)
    t2 = time.perf_counter()
    frontiers = bench2hop.draw_frontiers(n_nodes, BATCH_SEEDS, n_queries)
    fcap = ops.bucket(max(len(f) for f in frontiers))
    plan = bench2hop.plan_caps(a, frontiers, fcap, grouped=True)
    t3 = time.perf_counter()
    sizes = [len(f) for f in frontiers]
    log({"phase": "dense", "rows": a.n_rows, "edges_stored": a.n_edges,
         "metap": list(metap.shape), "ov_chunks": list(ov.shape),
         "device_bytes": a.device_bytes(), "queries": n_queries,
         "seeds_drawn": BATCH_SEEDS, "frontier_min": min(sizes),
         "frontier_max": max(sizes), "plan": dataclasses.asdict(plan),
         "arena_s": round(t1 - t0, 3), "layout_s": round(t2 - t1, 3),
         "plan_s": round(t3 - t2, 3)})
    return a, frontiers, fcap, plan


def chunk_tensor(a, frontiers, plan):
    """The pipeline's first chunk of group-ordered seed frontiers,
    int32[CHUNK_Q, fcap] on the arena's device."""
    import torch

    from dgraph_tpu_torch import bench2hop, ops

    g = bench2hop.group_order(a, frontiers[:CHUNK_Q])
    return torch.from_numpy(np.stack([ops.pad_to(f, plan.fcap) for f in g])).to(a.device)


def slotmap_real_inputs(a, frontiers, plan):
    """(name, cs, cd, capc) at both hops of the pipeline's first chunk;
    hop 1's output is formed by the torch chain, not the kernel."""
    from dgraph_tpu_torch import bench2hop, ops
    from dgraph_tpu_torch.ops.sets import ov_slotmap_inputs

    metap, ov = a.inline_layout_grouped()
    rows0 = ops.frontier_rows(chunk_tensor(a, frontiers, plan))
    cs1, cd1 = ov_slotmap_inputs(metap, rows0, plan.pcap1)
    inl1, ov1, _t = ops.expand_inline_grouped(metap, ov, rows0, plan.capo1, plan.pcap1)
    rows1 = bench2hop.next_rows(inl1, ov1, plan)
    cs2, cd2 = ov_slotmap_inputs(metap, rows1, plan.pcap2)
    return [("hop1_chunk", cs1.contiguous(), cd1.contiguous(), plan.capo1),
            ("hop2_chunk", cs2.contiguous(), cd2.contiguous(), plan.capo2)]


def total_case(rng, total: int, pcap: int = 1024):
    """One query whose chunk counts sum to exactly ``total``."""
    d = rng.integers(1, 5, size=total)
    c = np.cumsum(d)
    k = int(np.searchsorted(c, total))
    d = d[: k + 1]
    d[-1] -= int(c[k]) - total
    cs = np.zeros((1, pcap), np.int32)
    cd = np.zeros((1, pcap), np.int32)
    cs[0, : len(d)] = np.cumsum(rng.integers(0, 2, size=len(d))) + np.cumsum(d) - d
    cd[0, : len(d)] = d
    return cs, cd


def phase_slotmap_kernels(a, frontiers, plan, rng) -> int:
    """Slot-map kernel == plain version on the card, exactly, over the
    grid; returns the max |kernel - plain|."""
    import torch

    from dgraph_tpu_torch.ops import slotmap

    torch_cases = load_torch_cases()
    dev = a.device
    cases = slotmap_real_inputs(a, frontiers, plan)
    _n, cs2, cd2, capc2 = cases[1]
    cases.append(("hop2_chunk_truncated", cs2, cd2, max(8, capc2 // 4)))
    host = []
    for q, pcap, capc in ((CHUNK_Q, 16384, 16384), (CHUNK_Q, 3072, 3328), (7, 1000, 2900)):
        host.append((f"random_grouped_Q{q}_P{pcap}_C{capc}",
                     *torch_cases.grouped(rng, q, pcap), capc))
    for t in (127, 128, 129, 255, 256, 257, 383, 1023, 1024, 1025):
        host.append((f"total_{t}", *total_case(rng, t), 2048))
    cs, cd = torch_cases.grouped(rng, 64, 4096)
    cd[rng.random(cd.shape) < 0.2] = 0  # zero-cd rows between productive ones
    host.append(("zero_cd_between", cs, cd, 8192))
    cs, cd = torch_cases.grouped(rng, 16, 4096, fill=1.0)
    host.append(("random_truncated", cs, cd, 512))
    host.append(("all_zero", np.zeros((CHUNK_Q, 16384), np.int32),
                 np.zeros((CHUNK_Q, 16384), np.int32), 16384))
    host.append(("single_row_prefix", np.array([[5]], np.int32),
                 np.array([[3]], np.int32), 8))
    host += [(n, *torch_cases.slotmap_case(n)) for n in torch_cases.SLOTMAP_CASES]
    for name, cs, cd, capc in host:
        cases.append((name, torch.from_numpy(cs).to(dev),
                      torch.from_numpy(cd).to(dev), capc))
    results, max_err = [], 0
    for name, cs, cd, capc in cases:
        got = slotmap.slotmap(cs, cd, capc)
        want = slotmap.slotmap_plain(cs, cd, capc)
        _sync(dev)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        max_err = max(max_err, err)
        total = int(cd.to(torch.int64).sum(1).max())
        results.append((name, tuple(cs.shape), int(capc), total, err))
        check(torch.equal(got, want), f"slotmap kernel != plain version on {name}")
    log({"phase": "slotmap_kernels", "kernel": "slotmap", "tolerance": 0,
         "cases": [{"case": n, "Q_pcap": list(s_), "capc": c, "max_total": t,
                    "max_abs_err": e} for n, s_, c, t, e in results]})
    return max_err


def phase_batched_2hop(a, frontiers, fcap, plan, card: str) -> dict:
    """The batched 2-hop over every query, held against numpy query by
    query; the caller zeroes the launch counts just before."""
    from dgraph_tpu_torch import bench2hop
    from dgraph_tpu_torch.ops import slotmap

    stats: dict = {}
    t0 = time.perf_counter()
    dev_s, edges, chks, last_set = bench2hop.run_device_dedup(
        a, frontiers, fcap, CHUNK_Q, stats, plan=plan)
    run_s = time.perf_counter() - t0
    launches = slotmap.KERNEL.launches
    t1 = time.perf_counter()
    cpu_s, cpu_edges, cpu_chks = bench2hop.numpy_baseline(a, frontiers, reps=1)
    numpy_s = time.perf_counter() - t1
    _n, want_last, _c = bench2hop.np_two_hop(a, a.host_dst(), frontiers[-1])
    bad = np.nonzero(stats["counts"] != cpu_edges)[0]
    check(not len(bad), f"edge counts differ from numpy at queries {bad[:10].tolist()}")
    bad = np.nonzero(chks != cpu_chks)[0]
    check(not len(bad), f"checksums differ from numpy at queries {bad[:10].tolist()}")
    check(np.array_equal(last_set, want_last), "last query's set differs from numpy")
    check(edges == int(cpu_edges.sum()), "total edges differ from numpy")
    n_chunks = -(-len(frontiers) // CHUNK_Q)
    per_pass = stats["slotmap_launches_per_pass"]
    check(per_pass == [2 * n_chunks] * len(per_pass),
          f"slot-map launches per pass {per_pass}, want {2 * n_chunks} each")
    check(launches == sum(per_pass) + 2,
          f"slot-map launches {launches}, want {sum(per_pass) + 2}")
    # the host-dedup arm (bench.py's _run_host_dedup): classed plans, no
    # slot map
    hstats: dict = {}
    t2 = time.perf_counter()
    host_s, host_edges, host_chks, host_last = bench2hop.run_host_dedup(
        a, frontiers, timed=HOST_DEDUP_PASSES, warm=False, stats=hstats)
    host_run_s = time.perf_counter() - t2
    check(slotmap.KERNEL.launches == launches, "the host-dedup arm launched the slot map")
    bad = np.nonzero(hstats["counts"] != cpu_edges)[0]
    check(not len(bad), f"host-dedup edge counts differ from numpy at {bad[:10].tolist()}")
    bad = np.nonzero(host_chks != cpu_chks)[0]
    check(not len(bad), f"host-dedup checksums differ from numpy at {bad[:10].tolist()}")
    check(np.array_equal(host_last, want_last), "host-dedup last set differs from numpy")
    check(host_edges == edges, "host-dedup total edges differ")
    host = {"best_pass_s": host_s, "pass_seconds": hstats["pass_seconds"],
            "edges_per_s": host_edges / host_s, "vs_baseline": cpu_s / host_s,
            "caps1": hstats["caps1"], "caps2": hstats["caps2"],
            "sub_batch": hstats["sub_batch"], "run_s": host_run_s,
            "checksums_equal_numpy": True}
    out = {
        "queries": len(frontiers), "seeds_drawn": BATCH_SEEDS,
        "chunk_q": CHUNK_Q, "caps": stats["plan"], "edges": edges,
        "edges_per_query_mean": edges / len(frontiers),
        "best_pass_s": dev_s, "pass_seconds": stats["pass_seconds"],
        "edges_per_s": edges / dev_s, "numpy_best_s": cpu_s,
        "numpy_edges_per_s": edges / cpu_s, "vs_baseline": cpu_s / dev_s,
        "slotmap_launches_per_pass": per_pass, "slotmap_launches": launches,
        "checksums_equal_numpy": True, "last_set_equal_numpy": True,
        "run_s": run_s, "numpy_run_s": numpy_s, "host_dedup": host, "card": card,
    }
    log(dict(phase="batched_2hop", **out))
    return out


def slotmap_timing(a, frontiers, plan) -> dict:
    """The slot-map at both hops' shapes of a chunk (hop 2's is the main
    path's largest): the wrapper's times (``kernel_times``), the plain
    version's, and the bytes bound, keyed by hop."""
    from dgraph_tpu_torch.ops import slotmap

    out = {}
    for name, cs, cd, capc in slotmap_real_inputs(a, frontiers, plan):
        q, pcap = cs.shape
        # the function reads cs and cd once and writes the map once
        nbytes = 4 * q * (2 * pcap + capc)
        times = kernel_times(
            lambda cs=cs, cd=cd, capc=capc: slotmap.slotmap(cs, cd, capc),
            kernel="slotmap_tiles")
        plain_ms = cuda_ms(
            lambda cs=cs, cd=cd, capc=capc: slotmap.slotmap_plain(cs, cd, capc))
        out[name] = {"Q": q, "pcap": pcap, "capc": capc,
                     "max_total": int(cd.sum(1).max()), "bytes": nbytes,
                     **times, "plain_ms": plain_ms,
                     "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    return out


def _union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def pass_profile(a, frontiers, fcap, plan) -> dict:
    """The card's busy share of one pass of the batched 2-hop: a pass
    under ``torch.profiler`` (device intervals of every kernel, copy and
    fill; their union over the pass's host wall time, and device ms by
    kernel name), then a pass with CUDA events around each chunk (the sum
    of the chunks' device spans over that pass's host wall time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dgraph_tpu_torch import bench2hop

    metap, ov, plan, fmat = bench2hop.prepare(a, frontiers, fcap, plan)
    bench2hop.run_pass(metap, ov, fmat, plan, CHUNK_Q)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bench2hop.run_pass(metap, ov, fmat, plan, CHUNK_Q)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        s, e = ev.time_range.start, ev.time_range.end
        spans.append((s, e))
        by_name[ev.name] = by_name.get(ev.name, 0.0) + (e - s) / 1e3
    out = {"profiled_pass_s": wall_s, "device_events": len(spans)}
    if spans:
        busy_ms = _union_us(spans) / 1e3
        slot_ms = sum(v for k, v in by_name.items() if "slotmap" in k)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        out.update(device_busy_ms=busy_ms,
                   busy_share_of_pass=busy_ms / (wall_s * 1e3),
                   device_window_ms=(max(e for _s, e in spans)
                                     - min(s for s, _e in spans)) / 1e3,
                   slotmap_kernels_ms=slot_ms,
                   slotmap_share_of_busy=slot_ms / busy_ms,
                   top_kernels_ms=[[k, v] for k, v in top])
    else:  # the profiler saw no device activity: leave the share unmeasured
        out.update(device_busy_ms=None, busy_share_of_pass=None)

    n = fmat.shape[0]
    evs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in range(0, n, CHUNK_Q):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        bench2hop.two_hop_batch(metap, ov, fmat[b: b + CHUNK_Q], plan)
        e1.record()
        evs.append((e0, e1))
    torch.cuda.synchronize()
    ev_wall_s = time.perf_counter() - t0
    chunk_ms = [e0.elapsed_time(e1) for e0, e1 in evs]
    out.update(event_pass_s=ev_wall_s, chunk_event_ms=chunk_ms,
               chunk_share_of_pass=sum(chunk_ms) / (ev_wall_s * 1e3))
    return out


# -- phase 11 ---------------------------------------------------------------


def intersect_timing(device, served, rng) -> dict:
    """The intersect kernel at the served shapes (the matrices of the join
    path: (a)'s filter, the kernels line's shape; (b)'s root and filter)
    and at bench_ops.py's (K 2/4/8, L 8192): the wrapper's times
    (``kernel_times``: the memset of the tile status words and the
    kernel), the plain version's and the port's
    ``intersect_many`` tree's, and the bytes bound."""
    import torch

    from dgraph_tpu_torch import ops
    from dgraph_tpu_torch.ops import kway

    shapes = [(f"served_{n}", m) for n, m in served.items()]
    for k in (2, 4, 8):
        shapes.append((f"bench_ops_K{k}_L8192",
                       bench_ops_sets(rng, k, 8192, 8192 * 3 // 4, 0, 8192 * 4)))
    out = {}
    for name, m in shapes:
        k, L = m.shape
        t2 = torch.from_numpy(m).to(device)
        t3 = t2[None]
        # the function reads each row's valid entries once (the SENT tail
        # need not be read) and writes the L output lanes once
        row_sizes = [int(v) for v in (m != ops.SENT).sum(1)]
        nbytes = 4 * (sum(row_sizes) + L)
        out[name] = {
            "K": k, "L": L, "row_sizes": row_sizes, "bytes": nbytes,
            **kernel_times(lambda t3=t3: kway.intersect_batch(t3),
                           kernel="intersect_tiles"),
            "plain_ms": cuda_ms(lambda t3=t3: kway.intersect_plain(t3)),
            "intersect_many_ms": cuda_ms(lambda t2=t2: ops.intersect_many(t2)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        }
    return out


def order_timing(engine, seeds) -> dict:
    """The order-by at the served shapes — the root's 10^6 ranked uids in
    one segment (ascending), and the 2-hop of ``seeds`` by level-1 node
    (descending) — three ways: ``ops_ms``, CUDA events around the two
    torch ops on tensors already on the card (median of 30);
    ``device_branch_ms``, the engine's device branch on the host clock
    (padding, uploads, the two ops, the fetch of the permutation);
    ``host_branch_ms``, its numpy branch over the rank mirror (the route
    below the gate).  Medians of 5 for the last two."""
    import torch

    from dgraph_tpu_torch import ops

    va = engine.arenas.values("rank")
    arena = engine.arenas.data("e")
    n1, _ = arena.expand_host(arena.rows_for_uids_host(seeds))
    f1 = np.unique(n1)
    out2, seg_ptr = arena.expand_host(arena.rows_for_uids_host(f1))
    shapes = [("root_asc", va.h_src, np.zeros(va.n, np.int64), False),
              ("child_2hop_desc", out2, np.repeat(np.arange(len(f1)), np.diff(seg_ptr)), True)]
    gate = engine.expand_device_min
    out = {}
    for name, uids, owner, desc in shapes:
        n = len(uids)
        cap = ops.bucket(n)
        seg = np.full(cap, -1, np.int32)
        seg[:n] = owner
        u_d = torch.from_numpy(ops.pad_to(uids, cap)).to(va.src.device)
        s_d = torch.from_numpy(seg).to(va.src.device)
        ops_ms = cuda_ms(lambda u_d=u_d, s_d=s_d, desc=desc: ops.segmented_sort_perm(
            s_d, ops.gather_ranks(va.src, va.ranks, u_d), desc))
        branch = {}
        for route, g in (("device_branch_ms", 1), ("host_branch_ms", n + 1)):
            engine.expand_device_min = g
            try:
                secs = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    engine._device_order_perm(uids, owner, "rank", desc)
                    secs.append(time.perf_counter() - t0)
            finally:
                engine.expand_device_min = gate
            branch[route] = float(np.median(secs)) * 1e3
        out[name] = {"n": n, "segments": int(owner[-1]) + 1 if n else 0,
                     "cap": cap, "ops_ms": ops_ms, **branch}
    return out


def planner_counts(addr: str) -> dict:
    """/debug/planner's decision counts and mispredicts (process-wide:
    the caller takes differences)."""
    d = get_json(addr, "/debug/planner")
    return {"counts": d["counts"], "mispredicts": d["mispredicts"],
            "mispredict_total": d["mispredict_total"]}


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0)}


def planner_burst(srv, ref, card: str) -> dict:
    """PLANNER_CLIENTS client threads, each sending PLANNER_BURST
    2-hop counts of PLANNER_BURST_SEEDS fresh seeds at once, with both
    caches detached: the cohort controller must move max_batch or the
    flush deadline, within its bounds (its state sampled every 2 ms)."""
    import threading

    ctl = srv.scheduler._adaptive
    check(ctl is not None, "planner: the scheduler has no cohort controller")
    rng = np.random.default_rng(PLANNER_SEED)
    texts = [two_hop_count(np.unique(rng.integers(1, N_NODES + 1,
                                                  size=PLANNER_BURST_SEEDS)))
             for _ in range(PLANNER_CLIENTS)]
    want = {q: json.dumps(ref.run(q)) for q in texts}
    samples, errors = [], []
    stop = threading.Event()

    def poll():
        while not stop.is_set():
            samples.append((srv.scheduler.max_batch, srv.scheduler.flush_s))
            time.sleep(0.002)

    def client(i):
        try:
            for j in range(PLANNER_BURST):
                q = texts[(i + j) % len(texts)]
                status, raw, _secs = post(srv.addr, q)
                if status != 200 or strip_latency(raw) != want[q]:
                    errors.append((i, j, status))
        except Exception as e:  # noqa: BLE001 — reported by the check below
            errors.append((i, repr(e)))

    s0 = ctl.state()
    poller = threading.Thread(target=poll, daemon=True)
    threads = [threading.Thread(target=client, args=(i,)) for i in range(PLANNER_CLIENTS)]
    t0 = time.perf_counter()
    with no_caches(srv):
        poller.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stop.set()
        poller.join()
    secs = time.perf_counter() - t0
    s1 = ctl.state()
    check(not errors, f"planner burst: failed or differing requests {errors[:5]}")
    batches = {mb for mb, _f in samples}
    flushes = {round(f * 1e3, 6) for _mb, f in samples}
    check(all(ctl.base_batch <= mb <= ctl.hi_batch for mb in batches)
          and all(ctl.lo_flush_s * 1e3 - 1e-9 <= f <= ctl.base_flush_s * 1e3 + 1e-9
                  for f in flushes),
          f"planner burst: the controller left its bounds ({batches}, {flushes})")
    moved = batches != {ctl.base_batch} or flushes != {round(ctl.base_flush_s * 1e3, 6)}
    check(moved and s1["updates"] > s0["updates"],
          f"planner burst: the cohort controller did not move ({s0} -> {s1})")
    return {"clients": PLANNER_CLIENTS, "requests": PLANNER_CLIENTS * PLANNER_BURST,
            "seeds": PLANNER_BURST_SEEDS, "seconds": secs,
            "max_batch_seen": sorted(batches), "flush_ms_seen": sorted(flushes),
            "state_before": s0, "state_after": s1, "card": card}


def phase_planner(store, arenas, card: str, zero_counts, served_done,
                  device: str = "cuda") -> dict:
    """Phase planner: a second server over the main path's store, booted
    with DGRAPH_TPU_CALIBRATE=1 so that the planner measures its rates on
    the card, serving through the main server's ``arenas`` (a second
    build of the 16.2M-edge arena and the term index took 40 s of the
    phase); the main path's 2-hop count (per level, with the planner on
    and off in turn), join (a) and (b) and chain (a), each body held
    against the host route; the decisions /debug/planner recorded; then
    the burst that moves the cohort controller.  ``zero_counts()`` runs
    after the boot (the calibration's own launches are not the path's),
    ``served_done()`` after the burst.  The server is stopped at the end.
    ``device`` "cpu" rehearses the phase at a small size off the card."""
    from dgraph_tpu_torch.query import planner
    from dgraph_tpu_torch.serve.server import DgraphServer

    t0 = time.perf_counter()
    with env_set("DGRAPH_TPU_CALIBRATE", "1"):
        srv = DgraphServer(store, device=device)
    boot_s = time.perf_counter() - t0
    srv.engine.arenas = arenas
    cal = planner.calibration_info()
    check(cal["source"] == "measured" and cal["backend"] == srv.engine.device.type,
          f"planner: the boot did not measure on the card: {cal}")
    log({"phase": "planner_calibration", "card": card, "boot_s": boot_s,
         "rates": cal["rates"], "priors_replaced": True})
    srv.start()
    try:
        zero_counts()
        ref = host_engine(store)
        rng = np.random.default_rng(GRAPH_SEED)
        rng.integers(1, N_NODES + 1, size=SMALL_SEEDS)  # the main path's (a)
        count_seeds = np.unique(rng.integers(1, N_NODES + 1, size=LARGE_SEEDS))
        jrng = np.random.default_rng(JOIN_SEED)
        s1, s2 = (np.unique(jrng.integers(1, N_NODES + 1, size=LARGE_SEEDS))
                  for _ in range(2))
        large_c, _small, _by = chain_seeds()
        queries = [
            ("count_2hop", two_hop_count(count_seeds), True),
            ("join_a", join_filter_query(s1, s2), False),
            ("join_b", allofterms_query(s1), False),
            ("chain_a", two_hop_count(large_c), False),
        ]
        # a first request of each shape outside the timed ones
        t1 = time.perf_counter()
        for _name, q, _pl in queries:
            check(post(srv.addr, q)[0] == 200, "planner: a warm-up request failed")
        warm_s = time.perf_counter() - t1
        before = planner_counts(srv.addr)
        rows = {}
        with no_caches(srv):
            for name, q, pinned_chain in queries:
                want = json.dumps(ref.run(q))
                modes = ("on", "off") if name == "count_2hop" else ("on",)
                lat = {m: [] for m in modes}
                for _ in range(PLANNER_REPEATS):
                    for m in modes:
                        with contextlib.ExitStack() as st:
                            if pinned_chain:
                                st.enter_context(per_level(srv.engine))
                            if m == "off":
                                st.enter_context(env_set("DGRAPH_TPU_PLANNER", "0"))
                            status, raw, secs = post(srv.addr, q)
                        check(status == 200, f"planner {name} ({m}): HTTP {status}")
                        check(strip_latency(raw) == want,
                              f"planner {name} ({m}): body differs from the host route")
                        lat[m].append(secs * 1e3)
                with contextlib.ExitStack() as st:
                    if pinned_chain:
                        st.enter_context(per_level(srv.engine))
                    _status, raw, _secs = post(srv.addr, q, "?debug=true")
                eng = json.loads(raw)["server_latency"]["engine"]
                rows[name] = {
                    **{f"p50_ms_planner_{m}": float(np.percentile(v, 50))
                       for m, v in lat.items()},
                    "request_ms": lat, "routes": eng["routes"],
                    "kway_device": eng["kway_device"], "kway_host": eng["kway_host"],
                    "chain_fused_levels": eng["chain_fused_levels"],
                    "planner": eng.get("planner", []),
                    "byte_identical_to_host_route": True, "card": card}
                log(dict(phase="planner_query", query=name, **rows[name]))
        after = planner_counts(srv.addr)
        counts = _delta(after["counts"], before["counts"])
        check(counts.get("expand:resident", 0) > 0,
              f"planner: no expand decision took the resident route: {counts}")
        check(counts.get("kway:device", 0) > 0,
              f"planner: no k-way decision took the intersect kernel: {counts}")
        check_decided(rows["count_2hop"], "expand", "resident", "planner count")
        check_decided(rows["join_a"], "kway", "device", "planner join (a)")
        check_decided(rows["chain_a"], "chain", "chain", "planner chain (a)")
        mis = after["mispredict_total"] - before["mispredict_total"]
        n_dec = sum(counts.values())
        burst = planner_burst(srv, ref, card)
        served_done()
        out = {"boot_s": boot_s, "warm_s": warm_s, "rates": cal["rates"],
               "decisions": counts, "mispredicts": mis,
               "mispredict_rate": mis / n_dec if n_dec else 0.0,
               "mispredicts_by_kind": _delta(after["mispredicts"], before["mispredicts"]),
               "process_mispredict_stats": planner.mispredict_stats(),
               "rows": {n: {k: r[k] for k in r if k.startswith("p50_ms")}
                        for n, r in rows.items()},
               "burst": burst, "seconds": time.perf_counter() - t0, "card": card}
        log(dict(phase="planner", **{k: v for k, v in out.items() if k != "rates"}))
        return out
    finally:
        srv.stop()


def gather_timing(arena, rng) -> dict:
    """The gather through wrapper calls only (so that it times an older
    tree's wrapper too), keyed by shape: the main path's largest (the
    large 2-hop's second hop), a 10^6-edge row among light rows, and a
    frontier of B 2^20 arena rows (sorted, distinct).  Per shape the
    wrapper's times (``kernel_times``: device time of every device op of
    a call), the plain version's, and the bytes bound."""
    import torch

    from dgraph_tpu_torch import ops
    from dgraph_tpu_torch.ops import gather

    dev = arena.device
    ra = arena.resident()
    seeds = np.unique(rng.integers(1, N_NODES + 1, size=LARGE_SEEDS))
    rows, cap, _ = second_hop_rows(arena, seeds)
    shapes = [("hop2_large_seeds", ra.off, ra.dst, rows, cap)]
    hoff, hdst, hrows, hcap = load_torch_cases().gather_case("heavy_row")
    shapes.append(("heavy_row", torch.from_numpy(hoff).to(dev),
                   torch.from_numpy(hdst).to(dev), hrows, hcap))
    rows = np.sort(rng.choice(arena.n_rows, size=1 << 20, replace=False)).astype(np.int32)
    shapes.append(("b_2_20", ra.off, ra.dst, rows,
                   ops.bucket(int(arena.degree_of_rows(rows).sum()))))
    out = {}
    for name, off, dst, rows, cap in shapes:
        rt = torch.from_numpy(rows).to(dev)
        live = rows[rows >= 0]
        deg = (off[torch.from_numpy(live + 1).to(dev).long()]
               - off[torch.from_numpy(live).to(dev).long()])
        total = int(deg.sum())
        # bytes the function must move: the frontier, two offsets per live
        # row, each placed target once, and the packed output once
        nbytes = 4 * len(rows) + 8 * len(live) + 4 * min(total, cap) + 8 * cap
        out[name] = {
            "B": len(rows), "live_rows": len(live), "total": total, "cap": cap,
            "bytes": nbytes,
            **kernel_times(lambda off=off, dst=dst, rt=rt, cap=cap:
                           gather.gather_packed(off, dst, rt, cap),
                           kernel="gather_fused"),
            "plain_ms": cuda_ms(lambda off=off, dst=dst, rt=rt, cap=cap:
                                gather.gather_packed_plain(off, dst, rt, cap)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        }
    return out


def main(argv) -> int:
    gather_only = "--gather-only" in argv
    durability_only = "--durability-only" in argv
    serving_only = "--serving-only" in argv
    mxu_only = "--mxu-only" in argv
    cluster_only = "--cluster-only" in argv
    trace_only = "--trace-only" in argv
    planner_only = "--planner-only" in argv
    guard_only = "--guard-only" in argv
    subs_only = "--subs-only" in argv
    transports_only = "--transports-only" in argv
    routes_only = "--routes-only" in argv
    mesh_only = "--mesh-only" in argv
    contracts_only = "--contracts-only" in argv
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible; this smoke test needs one",
              file=sys.stderr)
        return 2
    if not (ROOT / "dgraph_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout: dgraph_tpu_torch/ is not "
              "beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    # the servers of every other phase stay unsharded on a host of any
    # number of cards: only phase mesh has a mesh, which it passes in
    # (``DgraphServer(mesh=)``) or asks for by DGRAPH_TPU_MESH=force
    os.environ["DGRAPH_TPU_MESH"] = "0"

    srv = None
    phase = "build"
    phase_s: dict = {}  # seconds each phase took, up to the report's end
    t_phase = [time.perf_counter()]

    def mark(name: str) -> str:
        phase_s[phase] = time.perf_counter() - t_phase[0]
        t_phase[0] = time.perf_counter()
        return name

    wrappers = {}
    launches = {}

    def zero_counts():
        for w in wrappers.values():
            w.KERNEL.launches = 0

    def read_counts(path):
        counts = {n: w.KERNEL.launches for n, w in wrappers.items()}
        for n, _m, _r, paths in KERNELS:
            if path in paths:
                check(counts[n] > 0, f"kernel {n} was not launched on {path}")
                launches.setdefault(n, {})[path] = counts[n]

    try:
        t_start = time.perf_counter()
        info = phase_build()
        wrappers.update(
            (n, importlib.import_module(m)) for n, m, _r, _p in KERNELS)
        phase = mark("kernel_contracts")
        contracts = phase_kernel_contracts(info["nvidia_smi"])
        if contracts_only:
            mark("done")
            log({"phase_seconds": phase_s,
                 "kernel_contracts": contracts["summary"],
                 "analysis_cli": contracts["analysis_cli"]})
            return 0
        if mxu_only:
            phase = mark("mxu_join")
            zero_counts()
            phase_mxu_join(info["nvidia_smi"], lambda: read_counts("mxu_join"))
            mark("done")
            log({"phase_seconds": phase_s, "launches": launches})
            return 0
        if cluster_only:
            from dgraph_tpu_torch.bench2hop import gen_edges

            phase = mark("graph")
            src, dst = gen_edges(N_NODES, N_EDGES)
            phase = mark("cluster")
            zero_counts()
            phase_cluster("cuda", src, dst, info["nvidia_smi"])
            read_counts("cluster")
            mark("done")
            log({"phase_seconds": phase_s, "launches": launches})
            return 0
        if durability_only:
            from dgraph_tpu_torch.bench2hop import gen_edges

            phase = mark("graph")
            src, dst = gen_edges(N_NODES, N_EDGES)
            phase = mark("durability")
            zero_counts()
            phase_durability("cuda", src, dst, info["nvidia_smi"])
            read_counts("durability")
            mark("done")
            log({"phase_seconds": phase_s, "launches": launches})
            return 0
        phase = mark("graph")
        store, srv, (src, dst) = phase_graph("cuda", N_NODES, N_EDGES)
        arena = srv.engine.arenas.data("e")
        phase = mark("kernels")
        errs = phase_kernels(arena, np.random.default_rng(11))
        if gather_only:
            phase = mark("gather_timing")
            log(dict(phase="gather_timing", card=info["nvidia_smi"],
                     **gather_timing(arena, np.random.default_rng(13))))
            return 0
        if trace_only:
            phase = mark("names")
            tidx = phase_names(store, srv, N_NAMED)
            del tidx
            jrng = np.random.default_rng(JOIN_SEED)
            s1, s2 = (np.unique(jrng.integers(1, N_NODES + 1, size=LARGE_SEEDS))
                      for _ in range(2))
            phase = mark("flight_recorder")
            zero_counts()
            with no_caches(srv), per_level(srv.engine):
                flight = phase_flight_recorder(store, srv, s1, s2, info["nvidia_smi"])
            read_counts("flight_recorder")
            mark("done")
            log({"phase_seconds": phase_s, "launches": launches,
                 "flight_recorder": flight["cost"]})
            return 0
        if guard_only:
            jrng = np.random.default_rng(JOIN_SEED)
            s1, s2 = (np.unique(jrng.integers(1, N_NODES + 1, size=LARGE_SEEDS))
                      for _ in range(2))
            phase = mark("device_guard")
            zero_counts()
            with no_caches(srv), per_level(srv.engine):
                guard = phase_device_guard(store, srv, s1, s2, info["nvidia_smi"])
            read_counts("device_guard")
            mark("done")
            log({"phase_seconds": phase_s, "launches": launches,
                 "device_guard": guard_summary(guard)})
            return 0
        if subs_only:
            phase = mark("names")
            phase_names(store, srv, N_NAMED)
            phase = mark("subscriptions")
            zero_counts()
            with no_caches(srv), per_level(srv.engine):
                subs = phase_subscriptions(store, srv, info["nvidia_smi"])
            read_counts("subscriptions")
            mark("done")
            log({"phase_seconds": phase_s, "launches": launches,
                 "subscriptions": subs_summary(subs)})
            return 0
        if transports_only:
            phase = mark("names")
            phase_names(store, srv, N_NAMED)
            phase = mark("transports")
            zero_counts()
            with no_caches(srv), per_level(srv.engine):
                tr = phase_transports(store, srv, src, dst, info["nvidia_smi"],
                                      repeats=TRANSPORT_TIMED)
            read_counts("transports")
            mark("done")
            log({"phase_seconds": phase_s, "launches": launches,
                 "transports": transports_summary(tr)})
            return 0
        if planner_only:
            phase = mark("names")
            phase_names(store, srv, N_NAMED)
            phase = mark("planner")
            pl = phase_planner(store, srv.engine.arenas, info["nvidia_smi"],
                               zero_counts, lambda: read_counts("planner"))
            mark("done")
            log({"phase_seconds": phase_s, "launches": launches,
                 "planner": {k: pl[k] for k in ("decisions", "mispredict_rate",
                                                "rows", "seconds")}})
            return 0
        if routes_only:
            phase = mark("ranks")
            phase_ranks(store, srv, N_RANKED)
            phase = mark("routes")
            zero_counts()
            with no_caches(srv):
                rt = phase_routes(store, srv, info["nvidia_smi"])
            read_counts("routes")
            phase = mark("inline_slotmap_timing")
            inline_slotmap_timing(srv.engine.arenas.data("e"), rt["large_seeds"],
                                  info["nvidia_smi"])
            phase = mark("cli_surface")
            cli = phase_cli_surface("cuda", info["nvidia_smi"])
            phase = mark("dense")
            dense, frontiers, fcap, plan = phase_dense("cuda", src, dst, N_NODES)
            phase = mark("batched_2hop")
            zero_counts()
            batched = phase_batched_2hop(dense, frontiers, fcap, plan, info["nvidia_smi"])
            read_counts("batched_2hop")
            mark("done")
            log({"phase_seconds": phase_s, "launches": launches,
                 "routes": rt["p50_ms"], "cli_surface_s": cli["seconds"],
                 "host_dedup": batched["host_dedup"]})
            return 0
        if mesh_only:
            phase = mark("names")
            phase_names(store, srv, N_NAMED)
            jrng = np.random.default_rng(JOIN_SEED)
            s1, s2 = (np.unique(jrng.integers(1, N_NODES + 1, size=LARGE_SEEDS))
                      for _ in range(2))
            phase = mark("mesh")
            zero_counts()
            mesh = phase_mesh(store, srv, s1, s2, chain_seeds()[0], info["nvidia_smi"])
            read_counts("mesh")
            mark("done")
            log({"phase_seconds": phase_s, "launches": launches,
                 "mesh": mesh_summary(mesh)})
            return 0
        if serving_only:
            phase = mark("names")
            phase_names(store, srv, N_NAMED)
            phase = mark("serving_plane")
            phase_serving_plane(store, srv, info["nvidia_smi"])
            mark("done")
            log({"phase_seconds": phase_s})
            return 0
        # phases 4-11 run with both query caches detached: their repeats
        # must execute for their launch checks
        caches = contextlib.ExitStack()
        caches.enter_context(no_caches(srv))
        phase = mark("main_path")
        zero_counts()
        with per_level(srv.engine):
            main = phase_main_path(store, srv, np.random.default_rng(GRAPH_SEED),
                                   info["nvidia_smi"])
        read_counts("main_path")
        phase = mark("names")
        idx = phase_names(store, srv, N_NAMED)
        jrng = np.random.default_rng(JOIN_SEED)
        s1, s2 = (np.unique(jrng.integers(1, N_NODES + 1, size=LARGE_SEEDS))
                  for _ in range(2))
        phase = mark("intersect_kernels")
        served = join_matrices(srv.engine.arenas.data("e"), idx, s1, s2)
        errs["intersect"] = phase_intersect_kernels(
            srv.engine.device, served, np.random.default_rng(31))
        phase = mark("join_path")
        zero_counts()
        with per_level(srv.engine):
            join = phase_join_path(store, srv, s1, s2, info["nvidia_smi"])
        read_counts("join_path")
        phase = mark("flight_recorder")
        zero_counts()
        with per_level(srv.engine):
            flight = phase_flight_recorder(store, srv, s1, s2, info["nvidia_smi"])
        read_counts("flight_recorder")
        phase = mark("device_guard")
        zero_counts()
        with per_level(srv.engine):
            guard = phase_device_guard(store, srv, s1, s2, info["nvidia_smi"])
        read_counts("device_guard")
        # transports before subscriptions: no write since the device
        # guard's host-route reference, and its Subscribe leg's one write
        # advances that reference, which phase subscriptions reuses
        phase = mark("transports")
        zero_counts()
        with per_level(srv.engine):
            tr = phase_transports(store, srv, src, dst, info["nvidia_smi"])
        read_counts("transports")
        phase = mark("subscriptions")
        zero_counts()
        with per_level(srv.engine):
            subs = phase_subscriptions(store, srv, info["nvidia_smi"])
        read_counts("subscriptions")
        phase = mark("ranks")
        phase_ranks(store, srv, N_RANKED)
        phase = mark("query_surface")
        zero_counts()
        with per_level(srv.engine):
            surface = phase_query_surface(store, srv, N_RANKED, info["nvidia_smi"])
        read_counts("query_surface")
        phase = mark("routes")
        zero_counts()
        rt = phase_routes(store, srv, info["nvidia_smi"])
        read_counts("routes")
        phase = mark("cli_surface")
        cli = phase_cli_surface("cuda", info["nvidia_smi"])
        phase = mark("multi_hop_kernels")
        arena = srv.engine.arenas.data("e")
        large_c, small_c, by_size = chain_seeds()
        rseeds, rcap = recurse_seeds(arena, by_size)
        errs["gather_packed"] = max(errs["gather_packed"], phase_multi_hop_kernels(
            arena, large_c, rseeds, rcap))
        phase = mark("chain")
        zero_counts()
        chain_rows = phase_chain(store, srv, large_c, small_c, rseeds, info["nvidia_smi"])
        read_counts("chain")
        caches.close()
        phase = mark("serving_plane")
        zero_counts()
        serving = phase_serving_plane(store, srv, info["nvidia_smi"])
        read_counts("serving_plane")
        phase = mark("mxu_join")
        zero_counts()
        mxu = phase_mxu_join(info["nvidia_smi"], lambda: read_counts("mxu_join"))
        phase = mark("dense")
        dense, frontiers, fcap, plan = phase_dense("cuda", src, dst, N_NODES)
        phase = mark("slotmap_kernels")
        errs["slotmap"] = phase_slotmap_kernels(dense, frontiers, plan,
                                                np.random.default_rng(17))
        phase = mark("batched_2hop")
        zero_counts()
        batched = phase_batched_2hop(dense, frontiers, fcap, plan, info["nvidia_smi"])
        read_counts("batched_2hop")
        phase = mark("durability")
        zero_counts()
        dur = phase_durability("cuda", src, dst, info["nvidia_smi"])
        read_counts("durability")
        phase = mark("cluster")
        zero_counts()
        clu = phase_cluster("cuda", src, dst, info["nvidia_smi"])
        read_counts("cluster")
        del src, dst
        phase = mark("planner")
        pl = phase_planner(store, srv.engine.arenas, info["nvidia_smi"],
                           zero_counts, lambda: read_counts("planner"))
        phase = mark("gather_timing")
        t = gather_timing(srv.engine.arenas.data("e"), np.random.default_rng(13))
        log(dict(phase="gather_timing", **t))
        phase = mark("slotmap_timing")
        st = slotmap_timing(dense, frontiers, plan)
        log(dict(phase="slotmap_timing", **st))
        phase = mark("pass_profile")
        log(dict(phase="pass_profile", chunk_q=CHUNK_Q,
                 **pass_profile(dense, frontiers, fcap, plan)))
        phase = mark("inline_slotmap_timing")
        q1 = inline_slotmap_timing(srv.engine.arenas.data("e"), rt["large_seeds"],
                                   info["nvidia_smi"])
        phase = mark("intersect_timing")
        it = intersect_timing(srv.engine.device, served, np.random.default_rng(37))
        log(dict(phase="intersect_timing", **it))
        phase = mark("order_timing")
        log(dict(phase="order_timing", card=info["nvidia_smi"],
                 **order_timing(srv.engine, surface["large_seeds"])))
        # the mesh last: its write reaches the mesh server's arenas, not
        # the main server's
        phase = mark("mesh")
        zero_counts()
        mesh = phase_mesh(store, srv, s1, s2, large_c, info["nvidia_smi"])
        read_counts("mesh")
        # the gather on the mesh server's e hops: none (checked a request)
        launches["gather_packed"]["mesh"] = sum(
            r["gather_launches"] for r in mesh["served"].values())
        # the wrapper's device time for the k-way calls of one request
        kms = {"filter_and": it["served_a_filter"]["ms"],
               "allofterms": it["served_b_root"]["ms"] + it["served_b_filter"]["ms"]}
        log({"phase": "intersect_share", **{
            n: {"kernel_ms": kms[n], "kway_ms": j["kway_ms"], "p50_ms": j["p50_ms"],
                "kernel_share_of_p50": kms[n] / j["p50_ms"],
                "kway_share_of_p50": j["kway_ms"] / j["p50_ms"]}
            for n, j in join.items()}})
        timing = {"gather_packed": t["hop2_large_seeds"], "slotmap": st["hop2_chunk"],
                  "intersect": it["served_a_filter"]}
        from dgraph_tpu_torch.analysis.programs import CONTRACTS

        contract_of = {c.module: c.kernel for c in CONTRACTS}
        kernels = [{
            "name": n,
            "ok": True,
            "route": "cuda",
            "source": f"dgraph_tpu_torch/csrc/{wrappers[n].KERNEL.source}.cu",
            "replaces": r,
            "paths": list(paths),
            "launches": sum(launches[n].values()),
            "launches_by_path": launches[n],
            "max_abs_err": errs[n],
            "ms": timing[n]["ms"],
            "b2b_ms": timing[n]["b2b_ms"],
            "device_ms": timing[n]["device_ms"],
            "plain_ms": timing[n]["plain_ms"],
            "bound_ms": timing[n]["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "contract": contracts["summary"][contract_of[m]],
        } for n, m, r, paths in KERNELS]
        mark("done")
        log({"seconds": round(time.perf_counter() - t_start, 3), "phase_seconds": phase_s,
             "kernel_contracts": {"seconds": round(contracts["seconds"], 3),
                                  "analysis_cli": contracts["analysis_cli"]},
             "large_2hop": main["large"],
             "join_path": {n: {k: j[k] for k in ("p50_ms", "p99_ms", "kway_ms",
                                                 "launches_per_query")}
                           for n, j in join.items()},
             "flight_recorder": {"seconds": flight["seconds"], **flight["cost"],
                                 "cancel": flight["cancel"]},
             "device_guard": guard_summary(guard),
             "subscriptions": subs_summary(subs),
             "transports": transports_summary(tr),
             "query_surface": {n: {k: r[k] for k in (
                 "p50_ms", "p99_ms", "gather_launches_per_query", "device_order",
                 "device_order_ms")} for n, r in surface["rows"].items()},
             "chain": {n: {route: {k: r[route][k] for k in (
                 "requests", "min_ms", "p50_ms", "p99_ms", "max_ms",
                 "gather_launches_per_query", "intersect_launches_per_query",
                 "chain_fused_levels", "chain_ms") if k in r[route]}
                 for route in ("fused", "per_level") if route in r}
                 for n, r in chain_rows.items()},
             "serving_plane": {k: serving[k] for k in (
                 "merged_hops", "gather_launches", "intersect_launches",
                 "result_cache_hits", "hop_cache_hits", "mean_cohort_occupancy",
                 "requests_per_s_scheduled", "requests_per_s_serial",
                 "p50_ms_scheduled", "p50_ms_serial", "p99_ms_scheduled",
                 "p99_ms_serial", "busy_share_scheduled", "busy_share_serial")},
             "mxu_join": {
                 **{n: {route: {k: r[route][k] for k in (
                     "p50_ms", "p99_ms", "mxu_join_ms_p50", "tile_build_ms_first",
                     "gather_launches_per_query", "intersect_launches_per_query")}
                     for route in ("mxu", "gather")}
                    for n, r in mxu["rows"].items() if n != "after_mutation"},
                 "after_mutation": mxu["rows"]["after_mutation"],
                 "mask_chain": {k: mxu["mask_chain_timing"][k] for k in (
                     "ms", "b2b_ms", "device_ms", "bound_ms", "bound_by")}},
             "routes": {"p50_ms": rt["p50_ms"], "seconds": rt["seconds"],
                        "inline_q1_slotmap": {k: q1[k] for k in (
                            "pcap", "capc", "ms", "b2b_ms", "device_ms", "plain_ms",
                            "bound_ms")}},
             "cli_surface": {k: cli[k] for k in ("seconds", "boot_s", "lines")},
             "batched_2hop": {**{k: batched[k] for k in (
                 "queries", "edges", "edges_per_s", "numpy_edges_per_s",
                 "vs_baseline", "chunk_q", "caps")},
                 "host_dedup": {k: batched["host_dedup"][k] for k in (
                     "edges_per_s", "vs_baseline", "best_pass_s", "caps1", "caps2")}},
             "durability": {
                 # d1's figures under its cut's name: a stride sample of
                 # the edges (not comparable with a whole-graph d1's)
                 f"d1_stride{D1_EDGE_SHARE}": {
                     "time_to_recover_s": dur["d1"]["time_to_recover_s"],
                     "recovery_seconds": dur["d1"]["dgraph_recovery_seconds"],
                     "count_p50_ms": dur["d1"]["count_p50_ms"],
                     "count_p99_ms": dur["d1"]["count_p99_ms"],
                     "wal_bytes": dur["d1_wal_bytes"]},
                 "d2_time_to_recover_s": dur["d2_recover"]["time_to_recover_s"],
                 "loader_quads_per_s": dur["d2_load"]["quads_per_s"],
                 "snapshot_edges_per_s": dur["d2_load"]["snapshot_edges_per_s"],
                 "rearm_s": dur["readonly"]["rearm_s"]},
             "cluster": {
                 # the trio's figures under its cut's name: a stride sample
                 # of the edges, names on uids 1..TRIO_NAMED, gates at 1
                 # (not comparable with a full-size trio's)
                 f"trio_stride{TRIO_EDGE_SHARE}_named{TRIO_NAMED}_gates1": {
                     "proposal_to_applied_s": clu["replicate_s"],
                     "first_answer_s": {n: r["first_answer_s"]
                                        for n, r in clu["nodes"].items()},
                     "count_p50_ms": {n: r["count"]["p50_ms"]
                                      for n, r in clu["nodes"].items()},
                     "join_a_p50_ms": {n: r["join_a"]["p50_ms"]
                                       for n, r in clu["nodes"].items()},
                     "failover_s": clu["failover"]["acknowledged_write_s"]},
                 "pair_first_fetch_s": clu["pair"]["first_fetch_s"],
                 "pair_first_fetch_bytes": clu["pair"]["first_fetch_bytes"],
                 "pair_trace": clu["pair"]["trace"]},
             "planner": {k: pl[k] for k in (
                 "seconds", "decisions", "mispredicts", "mispredict_rate", "rows")},
             "mesh": mesh_summary(mesh),
             "launches_by_path": launches})
        log({"kernels": kernels})
        log(info["nvidia_smi"])
        log({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}})
        return 0
    except Exception:  # noqa: BLE001 — any phase's failure fails the run
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED in phase {phase}", file=sys.stderr)
        return 1
    finally:
        if srv is not None:
            srv.stop()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
