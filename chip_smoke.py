#!/usr/bin/env python3
"""Drive multiverso_tpu_torch's main paths on one CUDA card and check them.

    python3 chip_smoke.py             # the whole check, a few minutes
    python3 chip_smoke.py --profile   # also torch.profiler windows on one
                                      # word2vec call (on one shard and on
                                      # the (1, 4) mesh), one LightLDA
                                      # sweep (and one of each phase 16
                                      # run) and four sparse-LR steps

Phases (any failure ends the run with a non-zero exit code; each prints
its seconds):

1. Device: the card's name and power limit; build the CUDA kernels from
   the sources in this checkout (``multiverso_tpu_torch/ops/csrc``), and
   the native data library with g++
   (``multiverso_tpu_torch/data/csrc/mvtpu_data.cpp``): its seconds and
   path.
2. Kernels vs plain: each kernel against its plain PyTorch version on the
   card, with its time, the plain version's, one PyTorch library call's
   and the least time the card could take (bound). The row kernels at the
   word2vec path's shapes (table 10,001 x 100; 4,096 and 24,576 Zipf-1.2
   ids, and 24,576 lanes of one id; each case's longest run beside its
   time; the row scatter's plan kernel, its stable sort by row and table
   of runs, element for element its plain version, and the call's parts
   apart: the plan beside ``torch.sort``, a yardstick the port never
   calls, and the scatter along the plan); the COO kernels
   at a LightLDA call's 512,000 lanes into a [50,001, 1024] int32 table in
   request order (the kernel alone beside the call; ``index_put_`` and
   ``index_add_``; the bound in bytes and in 32-byte sectors), into a
   float32 table (the call's plan by element and its walk; the masked
   form on the lanes row-sorted under a bool mask; the plan alone, element
   for element its plain version, beside ``torch.sort`` of the element
   keys and of the rows; every lane on one element, one chain), and at
   the sweep-end rebuild's 10M token lanes (each exact against the plain
   version on the CPU); the Gibbs sampler
   kernels at the LightLDA step (B 512,000, K 1024, blocks of 512 tokens
   and 16 docs) in the production dtypes
   (int16 doc counts, bf16 word rows) and the exact-tiled ones (int32),
   under the tie rule (at least 99.9% of real lanes agree with the plain
   version, every other lane is a float32 CDF tie; nkd and the doc counts
   exact given the kernel's draws; build mode equals read mode); and the
   doc-blocked kernel reading its word rows from the bf16 mirror
   (``words=``) on the Zipf-1.1 words of ``zipf_lda_corpus``: bit for bit
   the gathered form, timed beside ``row_gather`` + the gathered-rows
   kernel on the same tokens. Then a
   small word2vec and a small LightLDA run on the card against the same
   runs on the CPU (plain versions), from the same weights, negatives
   and uniforms.
3. Table Get/Add: MatrixTable add_rows / get_rows with duplicate ids under
   the default, sgd and adagrad updaters, against numpy.
4. word2vec at the bench's width (synthetic Zipf corpus of 1M tokens and
   vocab 10k, dim 100, window 5, 5 negatives, subsample 1e-3, batch 4096,
   512 steps per call): one warm-up call and two timed calls of skip-gram
   negative sampling, on pairs generated before the calls. The loss must
   fall and stay finite, and both kernels' launch counts must rise by the
   expected count per step. Before it, host pair generation over one
   epoch of the corpus through ``Corpus.skipgram_batches``, in words/s:
   the native backend on 1 and on 4 threads, and the Python backend.
4c. word2vec of phase 4 through its own pair stream
   (``WordEmbedding.train(total_steps=...)`` with no ``batches=``, the
   path the CLI takes), once on the native data backend and once on the
   Python one: one warm-up and two timed calls each, words/s beside
   phase 4's pre-generated rate; the loss must fall and each row kernel
   launch exactly twice a step.
5. SparseMatrixTable on the card against numpy: add_sparse (int32
   ``default``, float32 ``sgd``), get_rows, get_rows_sparse, flat and
   tiled.
6. LightLDA at the width of the LDA metric of record
   (``benchmarks/measure_lda.py``: V 50,000, D 100,000, T 10M, K 1024,
   batch 512,000, one step per call, doc-blocked, seed 1, its Zipf-1.1
   corpus recipe): one warm-up and three timed sweeps, each fenced by a
   host sync; loglik before and after (it must rise), the count
   invariants exactly, doc-tokens/s and its spread, and launch counts per
   step (the sampler, reading the mirror's rows itself: no W gather) and
   per sweep (COO rebuild).
6b. LightLDA ``sampler="mh"`` (two Metropolis-Hastings rounds a token)
   at the same width and corpus: one warm-up and two timed sweeps;
   loglik before and after (it must rise), the count invariants exactly,
   doc-tokens/s and its spread beside phase 6's doc-blocked rate, and
   the launches of a sweep (two COO adds a step, no row gather).
7. LightLDA ``sampler="tiled"`` at the same width, exact and stale, one
   warm-up and one timed sweep each.
8. At reduced depth (T 1M, D 10k): the streamed (out-of-core) doc-blocked
   mode against the in-memory one, bit-identical after 2 sweeps.
9. KVTable on the card against a numpy model: gets of missing keys, adds
   under default, sgd, adagrad and ftrl at value_dim 0 and 2, re-adds,
   the raises (duplicate keys, the empty key, a deferred bucket overflow
   that leaves the table untouched), store -> load, len().
10. Sparse logistic regression at a Criteo-like width (39 hashed features
   per sample plus the bias, 2^24 dims, 65,536 samples, minibatch 4,096,
   ftrl, a 2^25-slot KVTable): 2 epochs of 16 steps; samples/s and mean
   loss per epoch, train accuracy, live keys, peak device memory, launches
   per step, and one step's host prep against its device time. Its adds
   (each step's keys and delta) are kept for phase 17.
11. Tables split over a mesh of four model shards (``SHARDS``; on a
   one-card machine all four on cuda:0) against the same tables
   unsharded: MatrixTable 10,000 x 100 under default, sgd and adagrad
   (24,576 Zipf ids), SparseMatrixTable 50,000 x 1024 int32 flat and
   tiled (512,000-lane COO adds), KVTable of 2^25 slots (ftrl, value_dim
   2, 159,000-key adds) with a batch that overflows one bucket of shard
   0: bit-identical in the logical region, the same overflow verdict;
   each MatrixTable get_rows and stateless add_rows and each
   SparseMatrixTable add_sparse one launch per card.
12. Sparse logistic regression of phase 10 on the (1, 4) mesh through
   ``SparseLogisticRegression(cfg, mesh=...)``, from phase 10's data: its
   final keys, values and state must equal phase 10's bit for bit, and
   its train accuracy (the predict path through the sharded lookup at the
   whole dataset's lanes) phase 10's; the
   same numbers as phase 10, per-device peak memory, and the launches per
   step (one lookup, one probe and one commit per card, 1 of each sharded
   form); with ``--profile`` four steps under the profiler.
13. word2vec of phase 4 on the (1, 4) mesh through
   ``WordEmbedding(corpus, cfg, mesh=...)``: the superstep hands the body
   both tables as ShardedParams, and every gather and scatter-add runs the
   functional form over them (one launch per card over its shards, a
   scatter-add along one plan of its ids). From
   phase 4's corpus, initial weights, pairs and negatives: w_in and w_out
   must equal phase 4's bit for bit, the loss must fall, the launches must
   be exactly 1 per gather and 1 plan and 1 per scatter-add (one card);
   words/s
   beside phase 4's. Then a superstep COO add over a (1, 4)
   SparseMatrixTable at the LightLDA call's width, bit-identical to the
   (1, 1) table, one launch per card a call.
13b. word2vec of phase 4 on a (4, 1) mesh, then on a (2, 2) mesh, both
   tables replicated over the data axis (replica d on cuda:{d % cards}):
   the superstep runs the body once per replica, each on its B/D lanes
   of every step, and every scatter-add applies all the replicas' lanes on
   every replica. From phase 4's corpus, initial weights, pairs and
   negatives: after the calls the replicas are bit-identical, w_in and
   w_out equal phase 4's bit for bit, the loss falls, and each replica
   launches exactly one gather and one scatter-add a table and step on its
   card (the flat kernels on (4, 1), the mesh forms on (2, 2)); words/s
   beside phase 4's, the host's ms to queue a step, the device's busy
   share over a 64-step call (torch.profiler, after every timed phase of
   this mesh), the bytes the lane exchange moves a step, and where each
   replica lives.
15. Dense logistic regression at MNIST's shape (``BASELINE.json``'s
   first workload; 60,000 x 784 Gaussian blobs, 10 classes, since MNIST
   cannot be downloaded): minibatch 256, 8 steps a call, sgd, lr 0.1.
   The same 2 steps on the card, on the CPU and on a (4, 1) mesh (every
   replica on cuda:0) from the same weights: within the CPU tests'
   tolerance (rtol 1e-5, atol 1e-6), the replicas bit-identical. Then
   one warm-up and two timed epochs on one replica and on the (4, 1)
   mesh: samples/s, each epoch's loss (it must fall), the train
   accuracy, the replicas bit-identical. It runs before phase 14.
16. LightLDA tiled exact, doc-blocked (in memory and streamed) and mh at
   the LDA metric's widths (V, K, batch 512,000) and phase 8's depth (T
   1M, D 10k) on (4, 1), (1, 4) and (2, 2) meshes (replica d on cuda:{d %
   cards}), each against the (1, 1) run of the same corpus and draws:
   after a warm-up and three timed sweeps (the streamed mode two) z, the
   word and doc counts, the summary and the loglik bit for bit, the
   replicas identical after each sweep, and a sweep's launches as
   designed (each replica samples its lanes and moves every lane's word
   counts on its own table: the flat kernels on S = 1, the mesh gather
   and COO add on S = 4; the doc-blocked kernels read the mirror's rows
   themselves on S = 1 and take gathered rows on S > 1; the streamed
   mode stages each replica its lanes of a call and adds every replica's
   lanes to each replica's word accumulator). Doc-tokens/s as a ratio of
   the (1, 1) run's and the host's ms to queue a step. It runs before
   phase 14.
17. KVTable on a data axis: phase 10's adds replayed on 2^25-slot tables
   on (4, 1) and (2, 2) meshes of cuda:0, with and without
   ``shard_update``, under ftrl and adagrad, beside a (1, 1) table fed
   the same: every Get of an add's keys (and of keys never added) equal
   to the (1, 1) table's bit for bit, the replicas bit-identical after
   each add, one probe and one commit a card per add, and each state
   block holding exactly its buckets. Then phase 10's sparse LR on the
   (4, 1) mesh: its final table equal to phase 10's bit for bit, the
   replicas identical, the host's and the device's ms a step beside phase
   10's, and the card's peak memory. It runs before phase 14.
21. Tiered KV storage (``multiverso_tpu_torch/storage``), after phase 17:
   (a) the first half of the keys of phase 10's first 4 adds (ftrl,
   value_dim 2, about 79,500 keys each) through a TieredKVTable on cuda:0
   at half phase 10's logical capacity, 2^24 slots in buckets of 8
   (2,097,152 logical buckets, a sixteenth on the card, a thirty-second in
   the pinned host arena, the rest in a spill file of 272-byte records)
   beside a plain 2^24-slot KVTable fed the same: every Get of an add's
   keys and of keys never
   added, and one chunked Get of the first two adds' keys, bit for bit
   the plain table's; a RunCheckpointManager generation after the third
   add; at the end buckets on every tier, demotions and disk fills above
   0, the export's keys, values, bucket_fill and state the plain table's
   bit for bit; a fresh tiered table resumed from the generation (every
   tier populated) finishes the replay with the same export; one probe and
   one commit an add chunk, one lookup a Get chunk; each add's host ms of
   plan, demote and fill and its probe + commit's device ms, the miss
   ratio, demotions and fills by tier, the spill file's bytes, the card's
   peak memory. (b) At a sixteenth of the geometry and of the first 3
   adds' keys, the tiered table on (1, 4) and (2, 2) meshes of cuda:0 (with and
   without shard_update) beside a (1, 1) one: replicas identical, one
   probe and one commit a card per add chunk, every Get and export bit for
   bit the (1, 1) table's. (c) The quantizers at word2vec's w_in shape:
   the 1-bit one against the same call on the CPU (signs and packing bit
   for bit, scales and residual within rtol 1e-6 + atol 1e-6), the int8
   rounding one with a generator on the card (in range, within a step,
   the mean of 300 draws within 0.01). It runs before phase 14.
22. The wire server (``multiverso_tpu_torch/server``), after phase 21:
   (a) a TableServer on cuda:0 (fuse 1, a unix socket) with a kv table at
   phase 10's geometry (2^25 slots, value_dim 2, ftrl); one WireClient
   replays phase 10's 32 adds (about 159,000 keys each) as kv_add frames,
   each followed by a kv_get of its keys, and a local KVTable on cuda:0
   takes the same adds: every Get reply and the table's export at the end
   equal the local table's bit for bit; one probe + commit a kv_add and
   one lookup a kv_get (the counts' differences around each frame); the
   wall p50 / p99 of both frames, requests a second, the server's stages
   (queue, execute) from its exemplar ring, the probe + commit's device ms
   a kv_add (CUDA events around it on the dispatch thread). (d) After each
   add a second client reads 4,096 of the first add's keys and 4,096 keys
   never added with a staleness bound of 8: the first read arms the
   replica; at least one is answered off it on a reader thread, each such
   answer within its bound and equal to the local table at its
   generation, each other equal to the table now. (c) On two fresh ftrl
   tables of that server, 6 of the adds pipelined quietly and under a
   chaos storm (``wire.send`` drop and torn, ``wire.recv`` drop): the
   tables bit for bit equal. (b) Four worker processes that load the
   port's transport by file path and import no torch (over unix, TCP, shm
   and shm) pipeline 16 overlapping-key adds of 65,536 keys each (integer
   deltas, default updater, 2^25 slots) into a fresh server with fuse 16,
   then into one with fuse 1: the two tables bit for bit equal and equal
   to the exact sums, fused groups above 0, probe + commit launches equal
   to the groups plus the frames that ran alone; each worker's bytes a
   second on the wire. (c) On the fusing server a shm worker SIGKILLed
   mid-stream: a survivor's and a fresh worker's adds land and the server
   answers. No handler error reply anywhere; the card's peak memory. It
   runs before phase 14.
23. The server fleet (``multiverso_tpu_torch/server``,
   ``client/router.py``), after phase 22: ``python -m
   multiverso_tpu_torch.server --fleet 2 --replicas 2 --device cuda:0``
   starts two primaries and a follower each, four processes on cuda:0,
   and the port's router dials them through the fleet file. (a) Phase
   10's 32 adds (ftrl, 2^26 slots over the two ranks: a member fills
   only the half of its buckets in its share of the map, so each holds
   phase 10's usable slots) through the router, each followed by a Get of its keys, equal bit for bit to a
   local KVTable on cuda:0 fed the same adds, and by a bounded read
   (staleness 8) of 4,096 keys through the router and of each rank's
   follower directly: follower reads and fallbacks counted, every lag
   within the bound; at the end the whole table equals the local one and
   each follower its primary. (b) Rank 0's primary SIGKILLed with 4 adds
   in flight and 4 more after: its follower is promoted (map v2, the
   fleet file rewritten), the time from the kill to the first acked add
   after it, and the table bit for bit the local one. (c) A fresh
   2-member fleet grown to 3 by ``--grow`` while a worker thread streams
   adds of 159,006 keys (small integer deltas, default updater, 2^26
   slots) and of a 4M-element ArrayTable through the router: every value
   the exact sum after the commit, then ``--shrink`` back to 2 bit for
   bit; the moved bytes below the live bytes. The members count their
   own launches and log them when they stop: #6 and #7 per member, and
   the card's memory peak over every process (nvidia-smi). It runs
   before phase 14.
24. Fleet observability and control (``telemetry/statusz.py``,
   ``aggregate.py``, ``report.py``, ``control.FleetController``), on
   phase 23's fleet between 23a and 23b: every member serves statusz
   (the launcher's ``MVTPU_STATUSZ_PORT=0``) and traces spans
   (``MVTPU_TRACE_DIR``). (a) Each member's ``/statusz`` (its pid, the
   served KV table, one wire server, its ``server.fuse`` binding, live
   #7 launches), ``/healthz`` 200, and every other endpoint timed. (b)
   ``/metrics?json=1`` of the four merged by ``merge_snapshots``: 4
   hosts, the primaries' ``kv_add`` requests and the followers'
   replication frames exactly what 23a sent. (c) ``/statusz?fleet=1`` on
   rank 1's follower: both ranks with the map's bucket ranges. (d) A
   ``FleetController`` whose objective extra connections to one member
   violate: one ``check_once`` steps ``server.fuse`` on all four members
   (``origin: fleet`` in each ring), a second after they close moves
   nothing, a ``set`` restores it. (e) ``python -m
   multiverso_tpu_torch.telemetry.report --fleet`` with the script's own
   trace: a 4-host snapshot and a Chrome trace with a track per member
   and each member's ``control.decision`` under (d)'s
   ``control.retune``. (f) After 23b, ``/statusz?fleet=1`` names rank
   0's promoted follower.
25. The multi-process runtime, after phase 23: two worker processes
   (``chip_smoke.py --mp-worker``, started by the script) on cuda:0, one
   gloo group over a ``FileStore``, ``-data_parallel=2
   -model_parallel=1``: each process holds one replica (data row). (a)
   word2vec ``local_data`` at phase 4's width (vocab 10k, dim 100, window
   5, 5 negatives, global batch 4,096, 2,048 a process, lr 0.01), a
   warm-up call and ``MP_W2V_CALLS`` timed calls of ``MP_W2V_STEPS``
   steps, each process streaming its own shard of one dictionary: the two
   processes' tables equal (CRC32 over ``allgather_bytes``), and equal to
   a one-process (2, 1) run on cuda:0 fed the same global batches (run
   by the script after the workers); each process's words/s, and the
   gloo gathers' share of its timed calls. (b) LightLDA streamed,
   doc-blocked, ``local_corpus``, K 1,024, on phase 8's corpus (T 1M, D
   10k), each process the docs of its parity, two sweeps: the word
   counts sum to the global token count and equal the processes' recounts
   of their own (word, z) summed, each process's doc counts are those of
   its own z, the loglik is finite, and a per-rank store and load gives z
   and the tables back bit for bit. (c) A KVTable of 2^20 slots: 8
   collective adds of 20,000 keys and their gets against a numpy model,
   equal on both processes. Each process counts its launches from 0
   after its init and must launch #1, #2, #4, #6, #7 and #11 or #12.
27. A model axis across processes, after phase 25: two worker
   processes (``--mp-worker`` in the mode ``model_axis``) on cuda:0, one
   gloo group over a ``FileStore``. (a) Plain word2vec at phase 4's width
   (vocab 10k, dim 100, window 5, 5 negatives, batch 4,096, lr 0.01, every
   process feeding the same global batch) on a ``(1, 2)`` mesh, each
   process one shard of both tables: a warm-up call and
   ``MA_W2V_CALLS - 1`` timed calls of ``MA_W2V_STEPS`` steps, each
   gather's partial OR-merged over the group. (b) Sparse LR at phase 10's
   width (39 hashed features and the bias over 2^24 dims, ftrl, minibatch
   4,096) on a 2^25-slot KVTable split over the two processes:
   ``MA_SLR_STEPS`` steps (one warm-up) of a Get and an Add each, the
   overflow gate summed over the group. (c) The first ``MA_KV_ADDS`` of
   (b)'s adds on a ``(2, 1)`` KVTable under ``shard_update``: each
   process commits the lanes of its state block and the cells it wrote
   cross to the other (fewer bytes an add than a block). (d) LightLDA on
   the ``(1, 2)`` mesh at phase 6's width (V 50,000, K 1,024, batch
   512,000, blocks of 512 tokens and 16 docs) and phase 25's corpus (T
   1M, D 10k), each process one shard of the word table and the
   summary: doc-blocked (a warm-up and two timed sweeps), doc-blocked
   streamed (one and one) and tiled exact (one), ``MA_LDA_SWEEPS``. The
   doc-blocked modes all-gather the whole bf16 mirror once a sweep and
   read it with ``words=`` (#11 / #12, no row gather); tiled exact
   gathers a step's distinct rows (#9b) and each lane's row from them
   (#1). Each worker's launches equal ``ma_lda_launches``; z, the
   summary and its shard equal, by CRC32, the one-process ``(1, 2)``
   run's on cuda:0; it prints the system's doc-tokens/s, each worker's
   bytes in a timed sweep and the all-gathers' share of it. Every
   part's tables equal, by CRC32, a one-process run of the same mesh
   shape on cuda:0 (run by the script after the workers); each worker
   holds its own cell only, launches #9b's two mesh forms, #9's lookup
   and #8's probe and commit, and reports each part's seconds, the
   all-gathers' share of them and the bytes they brought a step.
26. The binding-compat API, the three examples, pipeline and ring
   attention (``multiverso_tpu_torch/{bindings,examples,parallel}``), after
   phase 25, each part timed: (a) ``bindings.init``, the topology queries
   and ``barrier`` on one card, an ``ArrayTableHandler`` round trip of 1M
   floats, and a ``MatrixTableHandler`` at word2vec's ``w_out`` width
   (10,001 x 100 float32) on (1, 1) and (1, 4) meshes of cuda:0:
   ``BIND_ROUNDS`` rounds of a row add of phase 2's 24,576 Zipf-1.2 ids
   and a get of the same ids, against a float64 numpy accumulation within
   rtol 1e-5 (the deltas are multiples of 1/16, so it is exact); the row
   gather and row scatter-add launch once a call (``paths["bindings"]``).
   (b) ``mlp_cifar.main`` at its defaults (20,000 samples, hidden (256,
   128), batch 128, lr 0.05, 3 epochs, a ``ParamManager`` sync a step):
   accuracy above 0.8; one epoch with ``compress="1bit"``: above 0.45;
   samples/s and the syncs' share of the wall. (c) ResNet-50 at full width
   (23,513,162 float32 parameters in 153 leaves) at image size 32 and
   batch 256 (lr ``RESNET_LR``, a tenth of main's, at which both packages
   diverge): one ``ResNetTrainer`` step on (1, 1) and on a (4, 1) mesh of
   cuda:0 from the same weights, the parameters within rtol 1e-4, atol
   1e-5; ``RESNET_STEPS`` steps of each with finite losses;
   ``BindingResNetTrainer`` with a sync a step for ``RESNET_BIND_STEPS``
   steps (the handler's generation counts the syncs); the tiny arch on an
   (8, 1) mesh at 70 steps: accuracy above 0.5; images/s and a sync's
   share. (d) ``pipeline_mlp.main`` on a (1, 8) mesh of cuda:0 (8
   stages): the last 5 losses' mean below 0.6x the first 5's, and
   ``pipeline_apply`` within 2e-5 of ``sequential_oracle`` forward and
   5e-4 in the gradients. (e) ring and Ulysses attention on an (8, 1)
   mesh of cuda:0 (B 1, H 8, D 128, float32): at S 4,096, causal and not,
   within 2e-4 of a float64 dense attention on the card; their causal
   gradients against dense autograd in float64, cosine above 0.9999 and
   the norm ratio within 1%; at S 32,768 causal, the ms of each beside
   ``F.scaled_dot_product_attention`` on the same tensors (a yardstick
   that the port does not call).
14. Phase 2's row scatter calls (one ``mv_row_scatter_add`` each: the
   plan's digit count, sort passes and run scan, then the scatter along
   the plan), and phase 2's KV probe + commit calls (the flat form at the
   sparse-LR step's shapes, the sharded form on four shards), taken apart
   by torch.profiler: each kernel's device time (the count's fill, the
   probe, the commit, the rest), the device idle between them, the host's
   time to queue a call.
   Last, so that no profiler session comes before a timed phase.
18. Telemetry, in parts beside the phases whose apps it reuses (its
   seconds are their sum): (a) right after phase 4, phase 4's app and
   pairs, one call each with the span trace and metric-event sinks off,
   on, on, off: words/s off and on, each call's ``dispatch_s`` (the host's
   time to queue it) beside its wall time; one ``w2v.superstep`` span,
   ``step`` record and ``app.step.seconds`` observation a call,
   ``profile.calls`` of the superstep once a call (not a step), no
   ``table.*`` counter moved, phase 4's launches; (b) one sweep of phase
   6's LightLDA and four steps of phase 10's sparse LR with the sinks on:
   their spans, step records and counters, the KV ``table.add.bytes`` as
   the reference counts it (2 bytes a value on a bfloat16 KVTable too);
   (c) ``maybe_watchdog`` with a 1 s deadline over a queued gather and up
   to 3 s without a beat: a dump under ``MVTPU_DUMP_DIR`` with every
   thread's stack and the metrics snapshot; (d) ``record_device_memory``
   within 1% of the allocator's own reads, and phase 1's builds recorded
   as compiles (one each, its seconds, when it compiled); (e) after
   phase 14, a ``profile_window`` over one 16-step word2vec call: its
   Chrome trace names ``mv_row_gather``, ``mv_row_scatter_add``, their
   kernels and the ``w2v.superstep`` range.
19. Health and checkpoints, in parts (its seconds are their sum): (a)
   after phase 17, the stat reduction (``ops/stat_kernels.py``) against
   ``numpy_reference`` at word2vec's 10,001 x 100 float32 table and
   LightLDA's 50,001 x 1,024 word table's shape (float32 with NaN, Inf and
   zeros planted, and int32 counts) and on a ShardedParam of 4: counts and
   abs_max exact, l2 within 1e-4; one ``summarize`` of each table's type
   timed on the device (beside its bound) and on the host; (b) after
   phase 18a, phase 4's app, one call each with ``MVTPU_HEALTH`` unset,
   set, set, unset, twice: words/s both ways, each audited call's two table
   samples ingested, and what a call records alone; (c) after (a), the
   dense logreg at MNIST's shape for 4 epochs with a run directory at
   ``-ckpt_every=1``, ``MVTPU_HEALTH_ACTION=rollback`` and a chaos NaN in
   epoch 3's ``table.add``: one rollback, and the final weights equal a
   clean run's bit for bit; (d) a generation of phase 4's tables with a
   call queued right after the save (the generation holds the pre-call
   values), and of phase 6's word table and summary: the dispatch half,
   the write half and the resume's time each; the dense logreg killed
   after generation 2 and resumed, bit for bit the uninterrupted run.
   Last, no health error, no dropped sample, no failed checkpoint.
20. The client pipeline and the control plane, in parts (its seconds
   are their sum): (a) after phase 10, its sparse LR with
   ``MVTPU_COALESCE=4`` in pairs with the uncoalesced run (off, on, on,
   off; the packs memoised from phase 10): 8 flushes, 8 probes + 8
   commits against 32 + 32, the pre-sum's row scatter launched once a
   flush; the coalesced table bit for bit the same run's with the
   pre-sum forced to its plain version on the CPU, the uncoalesced ones
   phase 10's; the pre-sum's device ms at a flush's shapes and its share
   of a flush's wall; (b) after phase 19b/d, phase 4's word2vec with
   ``MVTPU_STALENESS=1`` (six calls under one view, then words/s with the
   view on and off in pairs), and inside phase 6 its LightLDA with
   ``MVTPU_STALENESS=2`` over the 205 MB word table: the staleness served,
   hits and misses, the refresh's ms on the dispatch thread and the
   worker's wait, every served array bit for bit the table at its
   generation and unchanged afterwards, one pinned buffer a view; (c)
   phase 10's 32 adds through ``stage_kv_adds(depth=2)`` and directly,
   bit for bit, both wall times; (d) the sparse LR with
   ``MVTPU_COALESCE=2`` under ``AUTOTUNE_SPEC``, ``check_once()`` after
   every fourth minibatch: K from 2 in +2 steps, the decision ring and
   the ``control.decision`` spans of a trace file, the table bit for bit
   a replay of its flush schedule, ``MVTPU_AUTOTUNE=0`` vetoing every
   apply, ``core.init`` arming one controller thread and
   ``core.shutdown`` leaving none.

Phase 2 also holds the KV kernels against their plain versions on the CPU
bit for bit at the sparse-LR step's shapes (a 2^25-slot table, 262,144
padded lanes of about 159,000 keys, half present; the probe + commit
launched on the real lanes, beside its bound in bytes and in 32-byte
sectors), the probe + commit under all six updaters, and a small sparse
LR on the card against the CPU; and
the KV probe + commit, flat and sharded (S = 4), at bfloat16 and float16
values under ftrl and adagrad on the same keys and lanes (then under ftrl
the lookup, flat and sharded, of every key on the table the add left),
bit for bit against the plain version on the same inputs: under ftrl on
the CPU, under adagrad on the card; each beside the float32 form's
time and its bounds in bytes and in 32-byte sectors (one formula for
every value type); and
the five sharded forms at S = 4 against their plain versions on the CPU,
bit for bit: the KV lookup and probe + commit (ftrl) at those shapes on
four shards of 524,288 buckets (with a batch that overflows one bucket of
shard 0; the lookup once per card on every lane of ``inv``, the probe +
commit once per card with its sector bound, each beside the host's time
to queue a call), the row gather and scatter-add
at the word2vec shapes (each beside the flat kernel on the table
concatenated and the host's time to queue a call), the COO add at the
LightLDA call's, int32 (taken apart: the segment form, the mesh form over
the same lanes as one segment, each segment's lanes shuffled, no mask
read) and float32. And the three
functional forms over a
ShardedParam of four shards (a superstep body's gather, row scatter-add
and COO add over a split table) against their plain versions on the CPU,
bit for bit, with their times beside ``index_select`` / ``index_add_`` /
``index_put_`` on the table concatenated: the gather and scatter at the
word2vec shapes (4 x 2,501 rows), the COO add at the LightLDA call's (4 x
12,501 x 1024, int32 and float32); the sharded scatter also against the
flat kernel on the whole table. Then a small CBOW HS run on the (1, 4)
card mesh against the same run on a (1, 4) CPU mesh.

Launch counts are set to 0 before each main path (phases 3-4 word2vec,
4c on each backend, 5, 6, 6b, 7, 8, 10, 11, 12, 13's word2vec and its
COO superstep, 13b's two meshes, 15, each sweep of 16, 17's sparse LR,
21a, 22, each worker of 25 and of 27) and read after it; phases 20, 21 and 22 read each run's
launches as the difference of the counts around it; phase 23's member
processes count from 0 at their start and log their counts when they
stop (phase 24 reads them live off each member's statusz too). Before the last line the script prints
one ``{"kernels": [...]}`` JSON line and the card's name and power limit;
the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
import gc
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# the H100 SXM's published peaks (NVIDIA data sheet): HBM3 bytes/s and
# float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# about 30 ms of spinning at the H100's clock: longer than the host takes
# to queue one timed loop
SPIN_CYCLES = 50_000_000

ROWS, DIM = 10_001, 100          # w2v table: vocab 10k + the scratch row
VOCAB, TOKENS = 10_000, 1_000_000
WINDOW, NEGATIVE, SUBSAMPLE = 5, 5, 1e-3
BATCH, STEPS = 4096, 512
# bench.py's learning rate: at batch 4096 the summed duplicate-row
# gradients of the frequent words diverge at word2vec's usual 0.025, in
# the JAX package as in this one
LR = 0.01
TIMED_CALLS = 2

# LightLDA at the LDA metric of record (benchmarks/measure_lda.py:56-61,
# 133-143): corpus seed 0 as there, app seed 1
LDA_V, LDA_D, LDA_T, LDA_K = 50_000, 100_000, 10_000_000, 1024
LDA_B, LDA_TB, LDA_MAXD = 512_000, 512, 16
LDA_ALPHA, LDA_BETA = 50.0 / LDA_K, 0.01
LDA_TIMED_SWEEPS = 3
LDA_SMALL_T, LDA_SMALL_D = 1_000_000, 10_000

# sparse logistic regression at a Criteo-like width: the Kaggle Display
# Advertising Challenge's 13 integer + 26 categorical fields, 39 hashed
# features per sample (plus the bias), over 2^24 hashed dims; the depth
# (samples) is cut to 16 minibatches an epoch so that phases 10 and 12,
# host-bound on the pack, keep the script near three minutes
SLR_N, SLR_DIM, SLR_NNZ = 65_536, 1 << 24, 39
SLR_CAPACITY, SLR_SLOTS, SLR_BATCH, SLR_EPOCHS = 1 << 25, 16, 4096, 2
# the KV kernels' shapes at that step: about 159,000 unique keys a
# minibatch, padded to 262,144 lanes
KV_REAL = 159_000
KV_UPDATERS = ("default", "sgd", "adagrad", "momentum", "adam", "ftrl")
# the sharded phases' model shards (spread over the machine's cards)
SHARDS = 4
# dense logistic regression at MNIST's shape (BASELINE.json's first
# workload, "Apps/LogisticRegression on MNIST"): 60,000 samples of 784
# features, 10 classes; MNIST cannot be downloaded, so Gaussian blobs of
# that shape (synthetic_blobs, seed 0) stand in for it
DENSE_N, DENSE_DIM, DENSE_CLASSES = 60_000, 784, 10
DENSE_BATCH, DENSE_SPC, DENSE_LR = 256, 8, 0.1
DENSE_TIMED_EPOCHS = 2
# the CPU tests' float32 tolerance for dense logistic regression
# (tests/test_torch_logreg.py)
DENSE_RTOL, DENSE_ATOL = 1e-5, 1e-6
# float32 operations per value element of each updater's apply
KV_UPDATER_OPS = {"default": 1, "sgd": 2, "adagrad": 6, "momentum": 4,
                  "adam": 13, "ftrl": 17}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls,
    after one warm-up call (CUDA events). A spin kernel ahead of the
    first event holds the device while the host queues the calls, so the
    events time the device and not the Python wrapper's enqueue rate."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int) -> float:
    """Mean host time to queue one call of ``fn`` (its Python wrappers and
    launches), over ``iters`` calls queued while a spin kernel holds the
    device, so the device never waits on the host inside the window."""
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * dt / iters


def longest_runs(ids, rps: int) -> list:
    """The longest run of equal ids in each shard's row window."""
    ids = np.asarray(ids)
    return [int(np.bincount(ids[(ids // rps) == s]).max(initial=0))
            for s in range(SHARDS)]


def bound_ms(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def zipf_ids(rng, n: int, rows: int):
    return np.clip(rng.zipf(1.2, size=n) - 1, 0, rows - 2).astype(np.int32)


def scatter_tolerance(torch, param, ids, deltas, valid=None):
    """Elementwise bound on the difference of two float32 sums of the same
    terms in different orders: 2 * m * 2^-24 * (|row| + sum |delta|) for
    a row that receives m deltas."""
    ids = ids.long()
    if valid is not None:
        keep = valid != 0
        ids, deltas = ids[keep], deltas[keep]
    mag = param.abs().clone().index_add_(0, ids, deltas.abs())
    m = torch.bincount(ids, minlength=param.shape[0]).to(param.dtype)
    return 2.0 * m[:, None] * 2.0 ** -24 * mag


def plan_parts(torch, tk, param, ids, deltas, rows: int, iters: int) -> dict:
    """The row scatter's plan kernel (``mv_row_scatter_plan``: the stable
    sort by row, then the table of runs) held against its plain version
    (``row_scatter_plan_plain``) element for element, and a call's parts
    timed apart on ``ids`` (over ``rows`` global rows): the plan into a
    workspace of its own, ``torch.sort(stable=True)`` beside it (the
    yardstick it replaced; the port never calls it), the plain plan on the
    card, and the scatter along that plan alone (``mv_row_scatter_add_mesh``
    over ``param``, a ShardedParam; a flat table as one shard). Launches
    made here count apart from ``tk.LAUNCHES``."""
    n = ids.shape[0]
    got = tk.row_scatter_plan(ids, rows)
    want = tk.row_scatter_plan_plain(ids.cpu(), rows)
    for name, g_, w_ in zip(want._fields, got, want):
        if not torch.equal(g_.cpu(), w_):
            raise SystemExit(f"row_scatter_plan n={n}: {name} != the plain "
                             "version's")
    dev = ids.device
    ids32 = ids.to(torch.int32).contiguous()
    ws = torch.zeros(tk.scatter_workspace_size(n), dtype=torch.int64,
                     device=dev)
    lay = tk.plan_layout(n)
    counts = collections.defaultdict(int)

    def plan():
        tk._launch("plan", "mv_row_scatter_plan", ids32.data_ptr(), n, rows,
                   ws.data_ptr(), ws.numel(), device=dev, counts=counts)
    plan()
    plan_w = ws.view(torch.int32)[lay["plan"]:lay["keys"]]
    # each card's copy of the plan and the deltas (the form's own copies)
    tables = [(table, plan_w.to(table[0]), deltas.to(table[0]))
              for table in param.launch_tables()]
    rps = param.shards[0].shape[0]
    cols = param.shards[0].numel() // rps

    def scatter():
        for (card, bases, firsts, count), plan_d, d_d in tables:
            tk._launch("scatter", "mv_row_scatter_add_mesh", bases, firsts,
                       count, rps, cols, int(param.dtype == torch.int32),
                       plan_d.data_ptr(), d_d.data_ptr(), n, device=card,
                       counts=counts)
    runs, longs = len(got.rows), len(got.long)
    # the plan's bytes: the ids read, the permutation, the run table (first,
    # end, row) and the long-run list written
    b, by = bound_ms(4 * n + 4 * n + 12 * runs + 4 * longs, 0)
    return dict(plan_ms=cuda_ms(plan, iters),
                plan_plain_ms=cuda_ms(
                    lambda: tk.row_scatter_plan_plain(ids, rows), iters),
                sort_ms=cuda_ms(lambda: torch.sort(ids, stable=True), iters),
                scatter_ms=cuda_ms(scatter, iters), plan_bound_ms=b,
                plan_bound_by=by, runs=runs, long_runs=longs)


def phase_kernels(torch, tk, rng) -> list:
    """Phase 2: each kernel vs its plain version; returns the JSON rows.
    The row kernels at 4,096 and 24,576 Zipf ids and at 24,576 lanes of
    one id (``n`` "24576:one"), each case with its longest run, and the
    row scatter's sort apart from its kernel. ``results["scatter_calls"]``
    keeps each case's kernel call on sorted lanes for phase 14."""
    dev = "cuda"
    g = torch.Generator(device="cpu").manual_seed(0)
    param0 = (torch.randn(ROWS, DIM, generator=g) * 0.05).to(dev)
    results, scatter_calls = {}, []
    main_n = BATCH * (1 + NEGATIVE)
    cases = [(4096, zipf_ids(rng, 4096, ROWS)),
             (main_n, zipf_ids(rng, main_n, ROWS)),
             (f"{main_n}:one", np.full(main_n, 0, np.int32))]
    for key, ids_h in cases:
        n = len(ids_h)
        ids = torch.as_tensor(ids_h, device=dev)
        uniq = int(torch.unique(ids).numel())
        longest = int(np.bincount(ids_h).max())
        # gather: exact
        got = tk.gather_rows(param0, ids)
        want = tk.gather_rows_plain(param0, ids)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise SystemExit(f"row_gather n={key}: kernel != plain "
                             f"(max abs err {err})")
        ms = cuda_ms(lambda: tk.gather_rows(param0, ids), 200)
        plain = cuda_ms(lambda: tk.gather_rows_plain(param0, ids), 200)
        lib = cuda_ms(lambda: param0.index_select(0, ids), 200)
        b, by = bound_ms(n * 4 + uniq * DIM * 4 + n * DIM * 4, 0)
        results[("row_gather", key)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
            bound_ms=b, bound_by=by, n=n, unique_rows=uniq,
            longest_run=longest)

        # scatter-add (ids in any order): against the plain version on the
        # card (index_add_ with atomics: float32 sum order) within the sum
        # bound, and against the plain version on the CPU, which adds in
        # the kernel's order: exact
        deltas = torch.randn(len(ids_h), DIM, generator=g).to(dev)
        p_k, p_p = param0.clone(), param0.clone()
        tk.row_scatter_add(p_k, ids, deltas)
        tk.row_scatter_add_plain(p_p, ids, deltas)
        torch.cuda.synchronize()
        err = float((p_k - p_p).abs().max())
        tol = scatter_tolerance(torch, param0, ids, deltas)
        if not bool(((p_k - p_p).abs() <= tol).all()):
            raise SystemExit(f"row_scatter_add n={key}: kernel vs plain "
                             f"beyond the float32 sum bound (max {err})")
        p_c = tk.row_scatter_add_plain(param0.cpu(), ids.cpu(),
                                       deltas.cpu())
        if not torch.equal(p_k.cpu(), p_c):
            raise SystemExit(f"row_scatter_add n={key}: kernel != plain "
                             "version on the CPU (same sum order)")
        p_t = param0.clone()
        call = functools.partial(tk.row_scatter_add, p_t, ids, deltas)
        ms = cuda_ms(call, 200)
        plain = cuda_ms(lambda: tk.row_scatter_add_plain(p_t, ids, deltas),
                        200)
        lib = cuda_ms(lambda: p_t.index_add_(0, ids, deltas), 200)
        # the call's parts: the plan (beside torch.sort), and the scatter
        # along it; phase 14 takes the whole call apart by kernel
        parts = plan_parts(torch, tk, tk.ShardedParam([p_t]), ids, deltas,
                           ROWS, 200)
        scatter_calls.append((key, longest, call))
        b, by = bound_ms(n * 4 + n * DIM * 4 + 2 * uniq * DIM * 4, n * DIM)
        results[("row_scatter_add", key)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
            bound_ms=b, bound_by=by, n=n, unique_rows=uniq,
            longest_run=longest, **parts)
        results[("row_scatter_plan", key)] = dict(
            max_abs_err=0.0, ms=parts["plan_ms"],
            plain_ms=parts["plan_plain_ms"], library_ms=parts["sort_ms"],
            bound_ms=parts["plan_bound_ms"], bound_by=parts["plan_bound_by"],
            n=n, unique_rows=uniq, longest_run=longest)

        # masked scatter-add over sorted ids (the table's add_rows form)
        sids = torch.sort(ids).values
        valid = torch.as_tensor(rng.random(len(ids_h)) < 0.9, device=dev)
        nv = int(valid.sum())
        uniq_v = int(torch.unique(sids[valid]).numel())
        p_k, p_p = param0.clone(), param0.clone()
        tk.row_scatter_add_masked(p_k, sids, deltas, valid)
        tk.row_scatter_add_masked_plain(p_p, sids, deltas, valid)
        torch.cuda.synchronize()
        err = float((p_k - p_p).abs().max())
        tol = scatter_tolerance(torch, param0, sids, deltas, valid)
        if not bool(((p_k - p_p).abs() <= tol).all()):
            raise SystemExit(f"row_scatter_add_masked n={key}: kernel vs "
                             f"plain beyond the float32 sum bound ({err})")
        p_c = tk.row_scatter_add_masked_plain(
            param0.cpu(), sids.cpu(), deltas.cpu(), valid.cpu())
        if not torch.equal(p_k.cpu(), p_c):
            raise SystemExit(f"row_scatter_add_masked n={key}: kernel != "
                             "plain version on the CPU (same sum order)")
        p_t = param0.clone()
        ms = cuda_ms(lambda: tk.row_scatter_add_masked(p_t, sids, deltas,
                                                       valid), 200)
        plain = cuda_ms(lambda: tk.row_scatter_add_masked_plain(
            p_t, sids, deltas, valid), 200)
        b, by = bound_ms(n * 8 + nv * DIM * 4 + 2 * uniq_v * DIM * 4,
                         nv * DIM)
        results[("row_scatter_add_masked", key)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, library_ms=None,
            bound_ms=b, bound_by=by, n=n, unique_rows=uniq_v,
            longest_run=longest)
    for (name, key), r in results.items():
        lib = r["library_ms"]
        log(f"  {name:24s} n={str(key):>9s} rows={r['unique_rows']:5d} "
            f"longest run {r['longest_run']:6d}  kernel {r['ms']:.4f} ms  "
            f"plain {r['plain_ms']:.4f} ms  library "
            f"{'none' if lib is None else f'{lib:.4f}'} ms  "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})  "
            f"max|err| {r['max_abs_err']:.3g}"
            + (f"; of it the plan {r['plan_ms']:.4f} ms (torch.sort "
               f"{r['sort_ms']:.4f} ms; {r['runs']} runs, {r['long_runs']} "
               f"long), the scatter on the plan {r['scatter_ms']:.4f} ms"
               if "plan_ms" in r else "")
            + ("; the plan kernel equals its plain version element for "
               "element (library: torch.sort stable, the permutation "
               "alone)" if name == "row_scatter_plan" else ""))
    results["scatter_calls"] = scatter_calls
    return results


def phase_scatter_parts(torch, tk, KVTable, mesh, scatter_calls) -> dict:
    """Phase 14: phase 2's row scatter calls (the plan's digit count, sort
    passes and run scan, and the scatter along the plan, queued by one
    ``mv_row_scatter_add``), and phase 2's KV probe + commit calls rebuilt
    (:func:`kv_ftrl_call`: the flat form at the sparse-LR step's shapes,
    the sharded form on ``mesh``), taken apart by the profiler, with the
    host's time to queue a call. It runs last, so that no profiler session
    comes before a timed phase."""
    out = {}
    what = (" ms a call (device time by kernel, the period of the queued "
            "calls, the device idle in it, the host's time to queue one)")
    for key, longest, call in scatter_calls:
        out[key] = parts = kernel_parts(torch, call, 50)
        log(f"  row_scatter_add n={str(key):>9s} longest run {longest:6d}: "
            + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()) + what)
    for key, on in (("kv_probe_update_ftrl_2", None),
                    ("kv_probe_update_sharded", mesh)):
        out[key] = parts = kernel_parts(
            torch, kv_ftrl_call(tk, KVTable, on), 50)
        log(f"  {key}: " + ", ".join(f"{k} {v:.4f}"
                                     for k, v in parts.items()) + what)
        free_tables(torch)
    return out


def kernel_parts(torch, fn, iters: int) -> dict:
    """Device ms a call of each kernel that ``fn`` launches (its mean over
    the launches the trace holds, times its launches a call; a fill is
    named "fill"), over ``iters`` calls queued behind a spin kernel as in
    :func:`cuda_ms`, from torch.profiler's device events;
    "period" is the median time from one call's first kernel to the
    next's, "gaps" the period less the kernels (the device idle between
    them), "host" the host's time to queue a call (:func:`host_ms`,
    without the profiler). The profiler can drop a few events; the means
    and the median stand, and the log names the loss."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # a session now and then comes back with none of the calls' device
    # events (seen once on an H100 in this phase): capture again, at
    # most twice more
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(SPIN_CYCLES)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total, starts = {}, {}
        for e in sorted(device_events(prof, "kernel_parts_trace.json"),
                        key=lambda e: e["ts"]):
            if "spin_kernel" in e["name"]:
                continue
            m = re.search(r"(\w+_kernel)", e["name"])
            name = ("fill" if "FillFunctor" in e["name"]
                    else m.group(1) if m else e["name"][:40])
            total[name] = total.get(name, 0.0) + e["dur"] / 1e3
            starts.setdefault(name, []).append(e["ts"])
        if starts:
            break
        log(f"    (profiler session {attempt + 1} held none of the calls' "
            "device events; capturing again)")
    else:
        raise SystemExit("kernel_parts: three profiler sessions held none "
                         "of the calls' device events")
    per_call = {k: max(1, round(len(v) / iters)) for k, v in starts.items()}
    parts = {k: v / len(starts[k]) * per_call[k] for k, v in total.items()}
    first = starts[next(iter(starts))][::per_call[next(iter(starts))]]
    period = float(np.median(np.diff(first))) / 1e3
    lost = {k: iters * per_call[k] - len(v) for k, v in starts.items()
            if len(v) != iters * per_call[k]}
    if lost:
        log(f"    (the trace lost launches: {lost} of {iters} calls' "
            "each)")
    parts.update(period=period, gaps=period - sum(parts.values()),
                 host=host_ms(fn, iters))
    return parts


def w2v_small_parity(torch, Corpus, synthetic_text, W2VConfig,
                     WordEmbedding, tmp) -> None:
    """word2vec on the card vs on the CPU (plain versions): same corpus,
    weights, pairs and negatives; skip-gram NS and CBOW HS."""
    path = os.path.join(tmp, "small.txt")
    synthetic_text(path, num_tokens=40_000, vocab_size=500, seed=3)
    for model, objective in (("skipgram", "ns"), ("cbow", "hs")):
        corpus = Corpus.from_file(path, min_count=1, subsample=1e-3)
        cfg = W2VConfig(embedding_dim=DIM, window=WINDOW, negative=NEGATIVE,
                        model=model, objective=objective, batch_size=256,
                        steps_per_call=4, learning_rate=0.025, seed=3)
        apps = [WordEmbedding(corpus, cfg, device=d) for d in ("cuda", "cpu")]
        it = (corpus.skipgram_batches(256, window=WINDOW, seed=3)
              if model == "skipgram" else
              corpus.cbow_batches(256, window=WINDOW, seed=3,
                                  pad_id=apps[0]._scratch))
        batches = [next(it) for _ in range(8)]
        for call in range(2):
            src = np.stack([b[0] for b in batches[4 * call:4 * call + 4]])
            tgt = np.stack([b[1] for b in batches[4 * call:4 * call + 4]])
            negs = apps[0].negatives(call, 4).cpu() \
                if objective == "ns" else None
            losses = [float(a._dispatch(src, tgt, call, 2, negatives=negs))
                      for a in apps]
        torch.cuda.synchronize()
        for key in ("w_in", "w_out"):
            a, b = (getattr(x, key).get() for x in apps)
            if not np.allclose(a, b, rtol=1e-5, atol=1e-6):
                raise SystemExit(f"w2v {model}/{objective}: {key} on the "
                                 f"card differs from the CPU run "
                                 f"(max {np.abs(a - b).max()})")
        if not np.isclose(losses[0], losses[1], rtol=1e-5):
            raise SystemExit(f"w2v {model}/{objective}: loss {losses}")
        log(f"  w2v {model}/{objective} card vs CPU: w_in, w_out within "
            f"rtol 1e-5 atol 1e-6; loss {losses[0]:.6f} vs {losses[1]:.6f}")


def phase_tables(torch, MatrixTable, AddOption, rng) -> None:
    """Phase 3: Get/Add round trips against numpy."""
    for updater in ("default", "sgd", "adagrad"):
        init = (rng.standard_normal((ROWS - 1, DIM)) * 0.05).astype(
            np.float32)
        opt = AddOption(learning_rate=0.05, lam=1e-6)
        t = MatrixTable(ROWS - 1, DIM, init_value=init, updater=updater,
                        device="cuda", default_option=opt,
                        name=f"smoke_{updater}")
        ref = init.copy()               # float32, like the table
        h = np.zeros_like(ref)
        for _ in range(2):
            ids = zipf_ids(rng, 4000, ROWS)
            if updater == "adagrad":
                ids = np.unique(ids)       # stateful: unique ids per add
            d = rng.standard_normal((len(ids), DIM)).astype(np.float32)
            t.add_rows(ids, d)
            if updater == "default":
                np.add.at(ref, ids, d)
            elif updater == "sgd":
                np.add.at(ref, ids, np.float32(-0.05) * d)
            else:
                h[ids] += d * d
                ref[ids] -= np.float32(0.05) * d / (np.sqrt(h[ids])
                                                    + np.float32(1e-6))
        q = zipf_ids(rng, 3000, ROWS)
        got_rows, got = t.get_rows(q), t.get()
        if not (np.allclose(got, ref, rtol=1e-5, atol=1e-5)
                and np.allclose(got_rows, ref[q], rtol=1e-5, atol=1e-5)):
            raise SystemExit(f"MatrixTable {updater}: get/get_rows differ "
                             f"from numpy (max {np.abs(got - ref).max()})")
        log(f"  MatrixTable {updater:8s} add_rows x2 + get_rows: matches "
            f"numpy (max |err| {np.abs(got - ref).max():.3g}), generation "
            f"{t.generation}")


def phase_w2v(torch, tk, Corpus, synthetic_text, W2VConfig, WordEmbedding,
              tmp, profile: bool) -> dict:
    """Phase 4: full-width skip-gram NS; returns the measured numbers."""
    path = os.path.join(tmp, "corpus.txt")
    synthetic_text(path, num_tokens=TOKENS, vocab_size=VOCAB, seed=1)
    corpus = Corpus.from_file(path, min_count=1, subsample=SUBSAMPLE)
    cfg = W2VConfig(embedding_dim=DIM, window=WINDOW, negative=NEGATIVE,
                    batch_size=BATCH, steps_per_call=STEPS,
                    learning_rate=LR, subsample=SUBSAMPLE, seed=1)
    app = WordEmbedding(corpus, cfg, device="cuda", name="smoke_w2v")
    gen = gen_rates(corpus)
    # pairs per token (words/s = pairs/s / pairs per token, as bench.py),
    # of the default stream: the native backend on one thread
    pairs_per_token = gen["native_1"]["pairs"] / corpus.num_tokens
    need = (1 + TIMED_CALLS + int(profile)) * STEPS
    batches = []
    for b in corpus.skipgram_batches(BATCH, window=WINDOW, seed=1,
                                     epochs=8):
        batches.append(b)
        if len(batches) == need:
            break
    if len(batches) < need:
        raise SystemExit(f"corpus gave {len(batches)} batches, need {need}")
    log(f"  corpus: vocab {corpus.vocab_size}, {corpus.num_tokens} tokens, "
        f"{pairs_per_token:.3f} pairs/token; host pair generation (one "
        f"epoch through Corpus.skipgram_batches): native 1 thread "
        f"{gen['native_1']['words_per_sec']:.0f} words/s, native 4 threads "
        f"{gen['native_4']['words_per_sec']:.0f}, Python backend "
        f"{gen['python']['words_per_sec']:.0f}")

    start_loss = (1 + NEGATIVE) * float(np.log(2.0))  # w_out = 0 at start
    before = dict(tk.LAUNCHES)
    warm, warm_s, dt = w2v_calls(torch, app, batches)
    losses = app.loss_history
    steps = (1 + TIMED_CALLS) * STEPS
    grown = {k: tk.LAUNCHES[k] - before[k] for k in tk.LAUNCHES}
    log(f"  warm-up call {warm_s:.3f} s, loss {warm:.5f}; timed calls "
        f"{dt:.3f} s, losses {losses}")
    if not all(np.isfinite(losses)) or not np.isfinite(warm):
        raise SystemExit(f"w2v loss is not finite: {warm}, {losses}")
    if not (losses[-1] < warm < start_loss):
        raise SystemExit(f"w2v loss did not fall: start {start_loss:.5f}, "
                         f"warm-up {warm:.5f}, last {losses[-1]:.5f}")
    # skip-gram NS: 2 gathers (w_in, w_out) + 2 scatter-adds per step, each
    # scatter through its plan
    for name in ("row_gather", "row_scatter_add", "row_scatter_plan"):
        if grown[name] != 2 * steps:
            raise SystemExit(f"{name}: {grown[name]} launches over {steps} "
                             f"steps, expected {2 * steps}")
    pairs = TIMED_CALLS * STEPS * BATCH
    words_per_sec = pairs / dt / pairs_per_token
    out = dict(words_per_sec=words_per_sec, seconds=dt,
               pairs_per_token=pairs_per_token, steps=steps,
               pair_generation=gen,
               loss_start=start_loss, loss_warm=warm, losses=losses,
               launches_per_step={k: grown[k] / steps for k in grown})
    # what phase 13 repeats on the mesh and must equal bit for bit
    run = dict(corpus=corpus, cfg=cfg, batches=batches,
               pairs_per_token=pairs_per_token, w_in=app.w_in.get(),
               w_out=app.w_out.get(), app=app)
    if profile:
        rest = batches[(1 + TIMED_CALLS) * STEPS:]
        out["longest_runs"] = step_runs(torch, app, rest[0])
        out["profile"] = profile_call(
            torch, "w2v_call_trace.json",
            lambda: app.train(total_steps=STEPS, batches=rest),
            dt / TIMED_CALLS * 1e3)
    return out, run


@contextlib.contextmanager
def python_backend():
    """The port's Python data backend in place of the native one: the
    ``Corpus`` iterators ask ``data.corpus.backend()`` for theirs."""
    from multiverso_tpu_torch.data import PyData
    from multiverso_tpu_torch.data import corpus as data_corpus
    native = data_corpus.backend
    data_corpus.backend = PyData
    try:
        yield
    finally:
        data_corpus.backend = native


def gen_rates(corpus) -> dict:
    """Host skip-gram pair generation over one epoch of ``corpus`` through
    ``Corpus.skipgram_batches`` (its prefetch thread, batches of BATCH):
    the native backend on 1 and 4 threads, and the Python backend."""
    out = {}
    for key, threads, backend in (("native_1", 1, contextlib.nullcontext),
                                  ("native_4", 4, contextlib.nullcontext),
                                  ("python", 1, python_backend)):
        with backend():
            t0 = time.perf_counter()
            pairs = sum(len(s) for s, _ in corpus.skipgram_batches(
                BATCH, window=WINDOW, seed=7, epochs=1, gen_threads=threads))
            dt = time.perf_counter() - t0
        out[key] = dict(words_per_sec=corpus.num_tokens / dt, pairs=pairs,
                        seconds=dt)
    return out


def phase_w2v_own_iterator(torch, counts, reset, WordEmbedding, w2v,
                           w2v_run) -> tuple:
    """Phase 4c: phase 4's word2vec through the app's own pair stream
    (``WordEmbedding.train(total_steps=...)`` with no ``batches=``, the
    path the CLI takes), once on the native backend and once on the
    Python one: one warm-up call and TIMED_CALLS timed calls each. The
    loss must fall and each row kernel launch twice a step. Returns
    ({backend: numbers}, {path: launch counts})."""
    corpus, ppt = w2v_run["corpus"], w2v_run["pairs_per_token"]
    # an epoch gives about 668 batches: two cover the timed calls
    cfg = dataclasses.replace(w2v_run["cfg"], epochs=2)
    steps = (1 + TIMED_CALLS) * STEPS
    out, paths = {}, {}
    for key, backend in (("native", contextlib.nullcontext),
                         ("python", python_backend)):
        app = WordEmbedding(corpus, cfg, device="cuda",
                            name=f"smoke_w2v_{key}")
        reset()
        with backend():
            t0 = time.perf_counter()
            warm = app.train(total_steps=STEPS)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            app.train(total_steps=TIMED_CALLS * STEPS)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        grown = counts()
        paths[f"word2vec_own_iterator_{key}"] = grown
        losses = app.loss_history
        if not (np.isfinite(losses).all() and np.isfinite(warm)
                and losses[-1] < warm < w2v["loss_start"]):
            raise SystemExit(f"w2v through its own iterator ({key}): loss "
                             f"did not fall: warm-up {warm}, then {losses}")
        for name in ("row_gather", "row_scatter_add"):
            if grown[name] != 2 * steps:
                raise SystemExit(f"w2v through its own iterator ({key}): "
                                 f"{name} {grown[name]} launches over "
                                 f"{steps} steps, expected {2 * steps}")
        words_per_sec = TIMED_CALLS * STEPS * BATCH / dt / ppt
        out[key] = dict(words_per_sec=words_per_sec, seconds=dt,
                        warm_seconds=warm_s, loss_warm=warm, losses=losses,
                        words_per_sec_pregenerated=w2v["words_per_sec"])
        log(f"  {key} backend: warm-up call {warm_s:.3f} s, loss "
            f"{warm:.5f}; timed calls {dt:.3f} s, losses {losses}; "
            f"{words_per_sec:.0f} words/s against phase 4's pre-generated "
            f"{w2v['words_per_sec']:.0f} "
            f"({words_per_sec / w2v['words_per_sec']:.3f}x); 2 row_gather + "
            f"2 row_scatter_add a step")
        del app
        free_tables(torch)
    return out, paths


def step_runs(torch, app, batch) -> dict:
    """The longest run of equal ids in the first step of the profiled call:
    w_out's scatter (targets and their negatives, B * (1 + K) lanes) and
    w_in's (the sources, B lanes)."""
    src, tgt = batch
    negs = app.negatives(0, STEPS)[0].cpu().numpy()   # call 0, step 0
    out_ids = np.concatenate([np.asarray(tgt)[:, None], negs], 1).ravel()
    runs = dict(w_out=int(np.bincount(out_ids).max()), w_out_lanes=len(
        out_ids), w_in=int(np.bincount(np.asarray(src)).max()),
        w_in_lanes=len(src))
    log(f"  longest run of a step's scatter ids: w_out {runs['w_out']} of "
        f"{runs['w_out_lanes']} lanes, w_in {runs['w_in']} of "
        f"{runs['w_in_lanes']}")
    return runs


def w2v_calls(torch, app, batches) -> tuple:
    """Phase 4's sequence on ``app``: one warm-up call, then TIMED_CALLS
    timed calls; returns (warm-up loss, warm-up s, timed s)."""
    t0 = time.perf_counter()
    warm = app.train(total_steps=STEPS, batches=batches[:STEPS])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    app.train(total_steps=TIMED_CALLS * STEPS,
              batches=batches[STEPS:(1 + TIMED_CALLS) * STEPS])
    for dev in {d for devs in app.w_in.replica_devices for d in devs}:
        torch.cuda.synchronize(dev)
    return warm, warm_s, time.perf_counter() - t0


def _sync(torch):
    torch.cuda.synchronize()


def zipf_words(rng, vocab: int, n: int):
    """``n`` Zipf-1.1 word ids over ``vocab`` words, by
    benchmarks/measure_lda.py's recipe."""
    p = 1.0 / np.arange(1, vocab + 1) ** 1.1
    p /= p.sum()
    return rng.choice(vocab, n, p=p).astype(np.int32)


def zipf_lda_corpus(vocab: int, docs: int, tokens: int, seed: int):
    """(token words, token docs): Zipf-1.1 words, doc ids uniform and
    sorted."""
    rng = np.random.default_rng(seed)
    tw = zipf_words(rng, vocab, tokens)
    td = np.sort(rng.integers(0, docs, tokens)).astype(np.int32)
    return tw, td


def rebuild_lanes(rng, vocab: int, topics: int, n: int, skewed: bool):
    """(words, topics, mask) of LightLDA's sweep-end rebuild of ``n``
    tokens in token order: Zipf-1.1 words; topics uniform (the rebuild of
    an initial z), or skewed (word w's topic is its home topic plus 37
    times a geometric(0.3) step, so about 30% of a word's tokens sit on
    one element and the top word's tokens pile on it); a 0/1 mask with 3%
    zeros (padding), the lanes' value."""
    w = zipf_words(rng, vocab, n)
    if skewed:
        home = (w.astype(np.int64) * 2654435761) % topics
        z = (home + 37 * (rng.geometric(0.3, n) - 1)) % topics
    else:
        z = rng.integers(0, topics, n)
    return w, z.astype(np.int32), (rng.random(n) < 0.97).astype(np.int32)


def lda_step_inputs(torch, a_dtype, w_dtype, seed: int):
    """Sampler operands at the LightLDA step shape, drawn on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, C = LDA_B, LDA_K // 128

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device="cuda",
                             dtype=torch.int32)

    A = ints(0, 6, (B, C, 128)).to(a_dtype)
    W = ints(0, 600, (B, C, 128)).to(w_dtype)
    sinv = 1.0 / (ints(5000, 15000, (C, 128)).float() + LDA_V * LDA_BETA)
    zi = ints(0, LDA_K, (B,))
    msk = (torch.rand(B, generator=g, device="cuda") < 0.97).to(torch.int32)
    u1 = torch.rand(B, generator=g, device="cuda")
    u2 = torch.rand(B, generator=g, device="cuda")
    return A, W, sinv, zi, msk, u1, u2


def tie_rule(torch, ls, name, A3, W3, sinv, zi, msk, u1, u2, got, want):
    """Fail unless >= 99.9% of real lanes agree and every other real lane
    is a float32 CDF tie; returns the number of differing lanes."""
    real = msk > 0
    diff = torch.nonzero(real & (got != want)).view(-1)
    agree = 1.0 - diff.numel() / max(int(real.sum()), 1)
    if agree < 0.999:
        raise SystemExit(f"{name}: kernel agrees with plain on {agree:.5f} "
                         "of real lanes (< 0.999)")
    if diff.numel():
        cpu = [x[diff].float().cpu().numpy() if x.dtype == torch.bfloat16
               else x[diff].cpu().numpy()
               for x in (A3, W3, zi, msk, u1, u2, got, want)]
        A, W, z, m, a, b, zg, zw = cpu
        if not ls.explained_by_ties(A, W, sinv.cpu().numpy(), z, m, a, b,
                                    zg, zw, alpha=LDA_ALPHA,
                                    beta=LDA_BETA).all():
            raise SystemExit(f"{name}: a lane differs from the plain "
                             "version beyond a float32 tie")
    if not torch.equal(got[~real], zi[~real]):
        raise SystemExit(f"{name}: padded lanes changed topic")
    return int(diff.numel())


def sector_bound_ms(lane_bytes: float, idx) -> float:
    """The COO add's bound when each touched 32-byte sector of a table
    that L2 does not hold moves in and out once: lane bytes plus 64 bytes
    a touched sector, over the card's memory rate (``idx``: the lanes'
    flat element indices into a table of 4-byte elements)."""
    sectors = int((idx // 8).unique().numel())
    return (lane_bytes + 64 * sectors) / PEAK_BYTES_PER_S * 1e3


def kv_sector_bound_ms(real: int, touched: int, cols: int,
                       n_state: int, value_bytes: int = 4) -> float:
    """The KV probe + commit's bound when each 32-byte sector it touches
    moves once: per touched bucket its key row (SLR_SLOTS slots of 8
    bytes) read; per real lane a sector read and written in the values
    (of ``value_bytes`` an element) and in each float32 state leaf, the
    key's sector written, and the lane operands (bucket, query, float32
    delta, valid) read with its slot written and read again; over the
    card's memory rate."""
    row = -(-SLR_SLOTS * 8 // 32) * 32
    cell = -(-cols * 4 // 32) * 32
    vcell = -(-cols * value_bytes // 32) * 32
    lane = 4 + 8 + 4 * cols + 1 + 8
    per_lane = 2 * (vcell + cell * n_state) + 32 + lane
    return (touched * row + real * per_lane) / PEAK_BYTES_PER_S * 1e3


def int32_library(row: dict) -> dict:
    """An int32 COO row's library time: ``index_put_(accumulate=True)``
    and ``index_add_`` on the flat indices both compute the add exactly
    (integer adds in any order), so ``library_ms`` is the faster of the
    two; both stay in the row as ``index_put_ms`` and ``index_add_ms``."""
    row["library_ms"] = min(row["index_put_ms"], row["index_add_ms"])
    return row


def coo_rows(torch, tk, table0, rows, cols, vals, masked, key: str,
             iters: int = 20) -> dict:
    """Phase 2's COO rows of one lane batch into a copy of ``table0``:
    ``coo_scatter_add`` (the call; for int32 the kernel alone on the same
    lanes too) and, with ``masked`` (row-sorted rows, cols, vals, valid),
    ``coo_scatter_add_masked``; each exact against its plain version on
    the CPU, beside ``index_put_`` and ``index_add_`` on the flat indices
    (``library_ms``: ``index_put_`` for float32, whose sums depend on
    their order; the faster of the two for int32) and the bound counted
    two ways (bytes: lanes x 12 + touched elements x 8; sectors: each
    touched 32-byte sector read and written)."""
    out, K = {}, table0[0].numel()
    want = tk.coo_scatter_add_plain(table0.cpu(), rows.cpu(), cols.cpu(),
                                    vals.cpu())
    got = tk.coo_scatter_add(table0.clone(), rows, cols, vals)
    _sync(torch)
    err = float((got.cpu() - want).abs().max())
    if not torch.equal(got.cpu().view(torch.int32),
                       want.view(torch.int32)):
        raise SystemExit(f"coo_scatter_add{key}: kernel != plain on the CPU"
                         f" (max abs err {err})")
    del got, want
    n = rows.shape[0]
    idx = rows.long() * K + cols.long()
    touched = int(idx.unique().numel())
    t = table0.clone()
    lib_vals = vals.to(t.dtype)
    b, by = bound_ms(n * 12 + touched * 8, n)
    row = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: tk.coo_scatter_add(t, rows, cols, vals), iters),
        plain_ms=cuda_ms(
            lambda: tk.coo_scatter_add_plain(t, rows, cols, vals), iters),
        index_put_ms=cuda_ms(lambda: t.view(-1).index_put_(
            (idx,), lib_vals, accumulate=True), iters),
        index_add_ms=cuda_ms(lambda: t.view(-1).index_add_(0, idx, lib_vals),
                             iters),
        bound_ms=b, bound_by=by, sector_bound_ms=sector_bound_ms(n * 12, idx),
        n=n, touched=touched, dtype=str(t.dtype).replace("torch.", ""))
    row["library_ms"] = row["index_put_ms"]
    if t.dtype == torch.int32:
        int32_library(row)
        # the kernel alone: the call minus its casts (none for int32 lanes)
        lanes = [x.to(torch.int32).contiguous() for x in (rows, cols, vals)]
        row["kernel_ms"] = cuda_ms(functools.partial(
            tk._launch_coo, "coo_scatter_add", t, *lanes, None), iters)
    out["coo_scatter_add" + key] = row
    if masked is None:
        return out
    srows, scols, svals, valid = masked
    want_m = tk.coo_scatter_add_masked_plain(
        table0.cpu(), srows.cpu(), scols.cpu(), svals.cpu(), valid.cpu())
    got_m = tk.coo_scatter_add_masked(table0.clone(), srows, scols, svals,
                                      valid)
    _sync(torch)
    err_m = float((got_m.cpu() - want_m).abs().max())
    if not torch.equal(got_m.cpu().view(torch.int32),
                       want_m.view(torch.int32)):
        raise SystemExit(f"coo_scatter_add_masked{key}: kernel != plain on "
                         f"the CPU (max abs err {err_m})")
    del got_m, want_m
    keep = valid != 0
    valid_i = valid.to(torch.int32)
    idx_m = (srows.long() * K + scols.long())[keep]
    v_m = svals[keep].to(t.dtype)
    nv = int(keep.sum())
    touched_m = int(idx_m.unique().numel())
    b, by = bound_ms(n * 13 + touched_m * 8, nv)
    out["coo_scatter_add_masked" + key] = dict(
        max_abs_err=err_m, ms=cuda_ms(lambda: tk.coo_scatter_add_masked(
            t, srows, scols, svals, valid), iters),
        plain_ms=cuda_ms(lambda: tk.coo_scatter_add_masked_plain(
            t, srows, scols, svals, valid), iters),
        library_ms=None,
        # index_put_ and index_add_ of the valid lanes, selected beforehand
        index_put_ms=cuda_ms(lambda: t.view(-1).index_put_(
            (idx_m,), v_m, accumulate=True), iters),
        index_add_ms=cuda_ms(lambda: t.view(-1).index_add_(0, idx_m, v_m),
                             iters),
        # the call with an int32 mask, which the wrapper casts to bytes
        int32_mask_ms=cuda_ms(lambda: tk.coo_scatter_add_masked(
            t, srows, scols, svals, valid_i), iters),
        bound_ms=b, bound_by=by,
        sector_bound_ms=sector_bound_ms(n * 13, idx_m), n=n,
        touched=touched_m, dtype=str(t.dtype).replace("torch.", ""))
    return out


def coo_plan_row(torch, tk, rows, cols, R: int, C: int,
                 iters: int = 20) -> dict:
    """Phase 2's row of the float32 COO add's plan alone
    (``mv_coo_scatter_plan`` on the stream's COO workspace, as the mesh
    form queues it): its permutation and runs equal the plain plan's,
    element for element; beside it ``torch.sort(stable=True)`` of the
    same int64 element keys (the permutation alone) and, as the parent's
    float32 path sorted, of the int32 rows. The bound: the lanes' rows and
    columns read, the permutation and a run table entry (16 bytes) a
    touched element written."""
    got = tk.coo_scatter_plan(rows, cols, R, C)
    want = tk.coo_scatter_plan_plain(rows.cpu(), cols.cpu(), R, C)
    for name, a, b in zip(want._fields, got, want):
        if not torch.equal(a.cpu(), b):
            raise SystemExit(f"coo_scatter_plan: kernel != plain ({name})")
    n, runs = rows.shape[0], int(want.rows.numel())
    r32, c32 = rows.to(torch.int32), cols.to(torch.int32)
    key = rows.long() * C + cols.long()

    def plan():
        tk._launch("coo_scatter_plan", "mv_coo_scatter_plan",
                   r32.data_ptr(), c32.data_ptr(), None, n, R, C,
                   device=rows.device, scatter_lanes=n, plan="coo")
    b, by = bound_ms(n * 12 + runs * 16, 0)
    return {"coo_scatter_plan": dict(
        max_abs_err=0.0, ms=cuda_ms(plan, iters),
        plain_ms=cuda_ms(lambda: tk.coo_scatter_plan_plain(rows, cols, R, C),
                         iters),
        library_ms=cuda_ms(lambda: torch.sort(key, stable=True), iters),
        torch_sort_rows_ms=cuda_ms(lambda: torch.sort(r32, stable=True),
                                   iters),
        bound_ms=b, bound_by=by, n=n, runs=runs,
        longest_run=int(want.counts.max()))}


def phase_lda_kernels(torch, tk, ls) -> dict:
    """Phase 2, LightLDA kernels vs plain at the LDA step shapes; returns
    {name: row} for the kernels JSON (and a few extra shapes)."""
    out = {}
    C, B, K = LDA_K // 128, LDA_B, LDA_K

    # COO: a call's 512k (word, topic, 1) lanes into the word table, in
    # request order (an int32 table takes them unsorted)
    rng = np.random.default_rng(5)
    tw, _ = zipf_lda_corpus(LDA_V, 1, B, seed=5)
    rows = torch.as_tensor(tw, device="cuda")
    cols = torch.as_tensor(rng.integers(0, K, B).astype(np.int32),
                           device="cuda")
    vals = torch.as_tensor((rng.random(B) < 0.97).astype(np.int32),
                           device="cuda")
    table0 = torch.zeros((LDA_V + 1, C, 128), dtype=torch.int32,
                         device="cuda")
    srows, order = torch.sort(rows, stable=True)
    scols, svals = cols[order], vals[order]
    # a bool mask, as SparseMatrixTable's host prep makes it (the COO
    # kernels read a byte a lane)
    valid = torch.as_tensor(rng.random(B) < 0.9, device="cuda")
    out.update(coo_rows(torch, tk, table0, rows, cols, vals,
                        (srows, scols, svals, valid), key=""))
    # the same lanes into a float32 table (the sgd updater's sparse Add):
    # the call plans them by element, each element sums in lane order; the
    # masked form on the row-sorted lanes with the same gate; the plan
    # alone beside torch.sort; every lane on one element (one chain)
    g = torch.Generator(device="cuda").manual_seed(5)
    f_vals = torch.randn(B, generator=g, device="cuda")
    out.update(coo_rows(torch, tk, table0.float(), rows, cols, f_vals,
                        (srows, scols, f_vals[order], valid), key="_f32"))
    out.update(coo_plan_row(torch, tk, rows, cols, LDA_V + 1, K))
    one_r = torch.full_like(rows, LDA_V // 2)
    one_c = torch.full_like(cols, K - 1)
    out.update(coo_rows(torch, tk, table0.float(), one_r, one_c, f_vals,
                        None, key="_f32_one_element", iters=3))
    del table0
    # the sweep-end rebuild's 10M token lanes (Zipf-1.1 words in token
    # order, the 0/1 mask as the value) into a zero table, with the uniform
    # topics of an initial z (phase 6 times the rebuild of a sampled z)
    w10, z10, m10 = (torch.as_tensor(x, device="cuda") for x in
                     rebuild_lanes(np.random.default_rng(10), LDA_V, K,
                                   LDA_T, False))
    out.update(coo_rows(torch, tk, torch.zeros((LDA_V + 1, C, 128),
                                               dtype=torch.int32,
                                               device="cuda"),
                        w10, z10, m10, None, key="@10M", iters=10))
    del w10, z10, m10
    torch.cuda.empty_cache()

    # the step's W-row gather from the bf16 mirror (row_gather at the LDA
    # shape; the kernels JSON keeps the word2vec shape's row)
    mirror = torch.randint(0, 600, (LDA_V + 1, C, 128), device="cuda",
                           dtype=torch.int32).to(torch.bfloat16)
    g = tk.gather_rows(mirror, rows)
    if not torch.equal(g, tk.gather_rows_plain(mirror, rows)):
        raise SystemExit("row_gather (bf16 LDA rows): kernel != plain")
    uniq = int(torch.unique(rows).numel())
    b, by = bound_ms(B * 4 + uniq * K * 2 + B * K * 2, 0)
    out["row_gather_lda_bf16"] = dict(
        max_abs_err=0.0, ms=cuda_ms(lambda: tk.gather_rows(mirror, rows), 20),
        plain_ms=cuda_ms(lambda: tk.gather_rows_plain(mirror, rows), 20),
        library_ms=cuda_ms(lambda: mirror.view(LDA_V + 1, -1)
                           .index_select(0, rows), 20),
        bound_ms=b, bound_by=by, n=B, unique_rows=uniq)
    del mirror, g

    # gibbs_sample_tiled, production (int16/bf16) and exact (int32) dtypes
    for a_dt, w_dt, tag in ((torch.int16, torch.bfloat16, ""),
                            (torch.int32, torch.int32, "_int32")):
        args = lda_step_inputs(torch, a_dt, w_dt, seed=21)
        kw = dict(alpha=LDA_ALPHA, beta=LDA_BETA)
        znew, nkd = ls.gibbs_sample_tiled(*args, **kw)
        want, want_nkd = ls.gibbs_sample_tiled_plain(*args, **kw)
        _sync(torch)
        diff = tie_rule(torch, ls, "gibbs_sample_tiled" + tag, *args, znew,
                        want)
        if not torch.equal(nkd, ls._nk_delta(args[3], znew, args[4], C)):
            raise SystemExit("gibbs_sample_tiled: nkd != the moves of its "
                             "own draws")
        err = float((nkd - want_nkd).abs().max())
        nbytes = sum(x.numel() * x.element_size() for x in args) \
            + B * 4 + K * 4
        b, by = bound_ms(nbytes, 8 * B * K)
        out["gibbs_sample_tiled" + tag] = dict(
            max_abs_err=err, mismatches=diff,
            ms=cuda_ms(lambda: ls.gibbs_sample_tiled(*args, **kw), 10),
            plain_ms=cuda_ms(lambda: ls.gibbs_sample_tiled_plain(*args, **kw),
                             2),
            library_ms=None, bound_ms=b, bound_by=by, n=B)
        del args, znew, want
        torch.cuda.empty_cache()

    # gibbs_sample_docblock (read mode) and its build mode
    nb = B // LDA_TB
    for n_dt, w_dt, tag in ((torch.int16, torch.bfloat16, ""),
                            (torch.int32, torch.int32, "_int32")):
        _, W3, sinv, zi, msk, u1, u2 = lda_step_inputs(
            torch, torch.int32, w_dt, seed=31)
        g = torch.Generator(device="cuda").manual_seed(32)
        drel = torch.randint(0, LDA_MAXD, (B,), generator=g, device="cuda",
                             dtype=torch.int32)
        rws = ls._block_rows(drel, LDA_TB, LDA_MAXD)
        real = msk > 0
        ndk = torch.zeros(nb * LDA_MAXD, K, dtype=torch.int32, device="cuda")
        ndk.view(-1).index_add_(0, rws * K + zi.long(), msk)
        ndk0 = ndk.to(n_dt).view(nb, LDA_MAXD, C, 128)
        vec = (W3, sinv, zi, drel, msk, u1, u2)
        kw = dict(alpha=LDA_ALPHA, beta=LDA_BETA)
        ndk_k = ndk0.clone()
        _, znew, nkd = ls.gibbs_sample_docblock(ndk_k, *vec, tb=LDA_TB, **kw)
        zb, nkdb = ls.gibbs_sample_docblock_build(*vec, tb=LDA_TB,
                                                  maxd=LDA_MAXD, **kw)
        ndk_p = ndk0.clone()
        _, want, want_nkd = ls.gibbs_sample_docblock_plain(
            ndk_p, *vec, tb=LDA_TB, **kw)
        _sync(torch)
        A3 = ndk0.view(nb * LDA_MAXD, K)[rws].view(B, C, 128)
        diff = tie_rule(torch, ls, "gibbs_sample_docblock" + tag, A3, W3,
                        sinv, zi, msk, u1, u2, znew, want)
        if not (torch.equal(zb[real], znew[real]) and torch.equal(nkdb, nkd)):
            raise SystemExit("gibbs_sample_docblock_build != read mode")
        moved = ndk.clone()
        one = torch.ones(int(real.sum()), dtype=torch.int32, device="cuda")
        moved.index_put_((rws[real], zi[real].long()), -one,
                         accumulate=True)
        moved.index_put_((rws[real], znew[real].long()), one,
                         accumulate=True)
        ndk_err = float((ndk_k.view(nb * LDA_MAXD, K).int() - moved)
                        .abs().max())
        if ndk_err or not torch.equal(nkd, ls._nk_delta(zi, znew, msk, C)):
            raise SystemExit("gibbs_sample_docblock: ndk_out or nkd != the "
                             "moves of its own draws")
        # against the plain version's outputs: 0 unless a tie flipped a draw
        err = max(float((nkd - want_nkd).abs().max()),
                  float((ndk_k.int() - ndk_p.int()).abs().max()))
        err_b = float((nkdb - want_nkd).abs().max())
        del A3, moved, ndk, want, ndk_p
        vec_bytes = sum(x.numel() * x.element_size() for x in vec) \
            + B * 4 + K * 4
        ndk_bytes = ndk0.numel() * ndk0.element_size()
        t_ndk = ndk0.clone()
        b, by = bound_ms(vec_bytes + 2 * ndk_bytes, 8 * B * K)
        out["gibbs_sample_docblock" + tag] = dict(
            max_abs_err=err, mismatches=diff,
            ms=cuda_ms(lambda: ls.gibbs_sample_docblock(
                t_ndk, *vec, tb=LDA_TB, **kw), 10),
            plain_ms=cuda_ms(lambda: ls.gibbs_sample_docblock_plain(
                t_ndk, *vec, tb=LDA_TB, **kw), 2),
            library_ms=None, bound_ms=b, bound_by=by, n=B)
        b, by = bound_ms(vec_bytes, 8 * B * K)
        out["gibbs_sample_docblock_build" + tag] = dict(
            max_abs_err=err_b, mismatches=diff,
            ms=cuda_ms(lambda: ls.gibbs_sample_docblock_build(
                *vec, tb=LDA_TB, maxd=LDA_MAXD, **kw), 10),
            plain_ms=cuda_ms(lambda: ls.gibbs_sample_docblock_build_plain(
                *vec, tb=LDA_TB, maxd=LDA_MAXD, **kw), 2),
            library_ms=None, bound_ms=b, bound_by=by, n=B)
        del vec, t_ndk, ndk0, ndk_k
        torch.cuda.empty_cache()
    out["gibbs_sample_docblock_rows"] = docblock_rows(torch, tk, ls)
    for name, r in out.items():
        lib = r["library_ms"]
        log(f"  {name:30s} n={r['n']:7d} kernel {r['ms']:.4f} ms  plain "
            f"{r['plain_ms']:.4f} ms  library "
            f"{'none' if lib is None else f'{lib:.4f} ms'}  bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})  "
            f"{r['ms'] / r['bound_ms']:.1f}x bound; max|err| "
            f"{r['max_abs_err']:.3g}"
            + (f"; {r['mismatches']} draws differ" if "mismatches" in r
               else ""))
        if "sector_bound_ms" in r:
            log(f"    {r['dtype']}, {r['touched']} elements touched; "
                + (f"the kernel alone {r['kernel_ms']:.4f} ms; "
                   if "kernel_ms" in r else "")
                + (f"index_put_ {r['index_put_ms']:.4f} ms; "
                   if "index_put_ms" in r else "")
                + f"index_add_ {r['index_add_ms']:.4f} ms; sector bound "
                f"{r['sector_bound_ms']:.4f} ms")
    return out


def docblock_rows(torch, tk, ls) -> dict:
    """The doc-blocked kernel reading its word rows from the bf16 mirror
    [V + 1, K] (``words=``) at the LightLDA step, on the Zipf-1.1 words of
    ``zipf_lda_corpus`` (random ids would misstate the caches' reuse):
    under the tie rule against its plain version, bit for bit against the
    gathered form on the rows ``row_gather`` gives, and timed beside
    ``row_gather`` + the gathered-rows kernel on the same tokens."""
    B, C, K, nb = LDA_B, LDA_K // 128, LDA_K, LDA_B // LDA_TB
    tw, _ = zipf_lda_corpus(LDA_V, 1, B, seed=41)
    words = torch.as_tensor(tw, device="cuda")
    _, _, sinv, zi, msk, u1, u2 = lda_step_inputs(
        torch, torch.int16, torch.bfloat16, seed=42)
    words = torch.where(msk > 0, words, LDA_V)      # pads: the scratch row
    g = torch.Generator(device="cuda").manual_seed(43)
    mirror = torch.randint(0, 600, (LDA_V + 1, C, 128), generator=g,
                           device="cuda", dtype=torch.int32).to(
                               torch.bfloat16)
    drel = torch.randint(0, LDA_MAXD, (B,), generator=g, device="cuda",
                         dtype=torch.int32)
    rws = ls._block_rows(drel, LDA_TB, LDA_MAXD)
    real = msk > 0
    ndk = torch.zeros(nb * LDA_MAXD, K, dtype=torch.int32, device="cuda")
    ndk.view(-1).index_add_(0, rws * K + zi.long(), msk)
    ndk0 = ndk.to(torch.int16).view(nb, LDA_MAXD, C, 128)
    vec = (sinv, zi, drel, msk, u1, u2)
    kw = dict(alpha=LDA_ALPHA, beta=LDA_BETA, tb=LDA_TB)
    ndk_w, ndk_g, ndk_p = ndk0.clone(), ndk0.clone(), ndk0.clone()
    _, zw, nw = ls.gibbs_sample_docblock(ndk_w, mirror, *vec, words=words,
                                         **kw)
    W3 = tk.gather_rows(mirror, words).view(B, C, 128)
    _, zg, ng = ls.gibbs_sample_docblock(ndk_g, W3, *vec, **kw)
    _, want, want_nkd = ls.gibbs_sample_docblock_plain(
        ndk_p, mirror, *vec, words=words, **kw)
    bw, bnw = ls.gibbs_sample_docblock_build(mirror, *vec, words=words,
                                             maxd=LDA_MAXD, **kw)
    _sync(torch)
    if not (torch.equal(zw, zg) and torch.equal(nw, ng)
            and torch.equal(ndk_w, ndk_g)):
        raise SystemExit("gibbs_sample_docblock_rows != the gathered form")
    if not (torch.equal(bw[real], zw[real]) and torch.equal(bnw, nw)):
        raise SystemExit("gibbs_sample_docblock_rows: build mode != read "
                         "mode")
    A3 = ndk0.view(nb * LDA_MAXD, K)[rws].view(B, C, 128)
    diff = tie_rule(torch, ls, "gibbs_sample_docblock_rows", A3, W3, sinv,
                    zi, msk, u1, u2, zw, want)
    if not torch.equal(nw, ls._nk_delta(zi, zw, msk, C)):
        raise SystemExit("gibbs_sample_docblock_rows: nkd != the moves of "
                         "its own draws")
    err = max(float((nw - want_nkd).abs().max()),
              float((ndk_w.int() - ndk_p.int()).abs().max()))
    del A3, ndk, ndk_w, ndk_g, ndk_p, zg, want, bw
    uniq = int(torch.unique(words[real]).numel())
    ndk_bytes = ndk0.numel() * ndk0.element_size()
    vec_bytes = sum(x.numel() * x.element_size() for x in vec) \
        + words.numel() * 4 + B * 4 + K * 4
    b, by = bound_ms(uniq * K * 2 + vec_bytes + 2 * ndk_bytes, 8 * B * K)
    t_ndk = ndk0.clone()
    row = dict(
        max_abs_err=err, mismatches=diff,
        ms=cuda_ms(lambda: ls.gibbs_sample_docblock(
            t_ndk, mirror, *vec, words=words, **kw), 20),
        plain_ms=cuda_ms(lambda: ls.gibbs_sample_docblock_plain(
            t_ndk, mirror, *vec, words=words, **kw), 2),
        library_ms=None, bound_ms=b, bound_by=by, n=B, unique_rows=uniq,
        gather_ms=cuda_ms(lambda: tk.gather_rows(mirror, words), 20),
        gathered_ms=cuda_ms(lambda: ls.gibbs_sample_docblock(
            t_ndk, W3, *vec, **kw), 20),
        build_ms=cuda_ms(lambda: ls.gibbs_sample_docblock_build(
            mirror, *vec, words=words, maxd=LDA_MAXD, **kw), 20))
    b, by = bound_ms(uniq * K * 2 + vec_bytes, 8 * B * K)
    row.update(build_bound_ms=b, build_bound_by=by)
    log(f"  gibbs_sample_docblock_rows on {uniq} unique Zipf-1.1 rows: "
        f"{row['ms']:.4f} ms (build mode {row['build_ms']:.4f}) against "
        f"row_gather {row['gather_ms']:.4f} + the gathered-rows kernel "
        f"{row['gathered_ms']:.4f} on the same tokens; equal to the "
        f"gathered form bit for bit")
    del t_ndk, W3, mirror
    torch.cuda.empty_cache()
    return row


def lda_small_parity(LDAConfig, LightLDA, load_docs, synthetic_docs,
                     tmp) -> None:
    """LightLDA on the card vs on the CPU (plain versions): same corpus,
    config and uniforms, doc-blocked and tiled stale modes. z must agree
    on 99% of tokens (the tie rule) and the invariants hold exactly."""
    path = os.path.join(tmp, "lda_small.txt")
    synthetic_docs(path, num_docs=300, vocab_size=500, avg_doc_len=60,
                   num_topics=10, seed=1)
    tw, td, vocab = load_docs(path)
    for extra in (dict(doc_blocked=True, block_tokens=256, block_docs=8),
                  dict(stale_words=True)):
        cfg = LDAConfig(num_topics=256, batch_tokens=4096, steps_per_call=2,
                        seed=2, sampler="tiled", **extra)
        apps = [LightLDA(tw, td, vocab, cfg, device=d)
                for d in ("cuda", "cpu")]
        for _ in range(2):
            for a in apps:
                a.sweep(uniforms=apps[1].uniforms)
        z = [a._z_numpy() for a in apps]
        agree = float(np.mean(z[0] == z[1]))
        if agree < 0.99:
            raise SystemExit(f"LDA {extra}: card vs CPU z agree {agree}")
        for a in apps:
            check_lda_invariants(a, td)
        lls = [a.loglik() for a in apps]
        log(f"  LightLDA {sorted(extra)[0]} card vs CPU: z agrees on "
            f"{agree:.5f} of tokens after 2 sweeps; loglik {lls[0]:.6f} vs "
            f"{lls[1]:.6f}; invariants exact")


def check_lda_invariants(app, td) -> None:
    nwk = app.word_topics()
    nk = app.summary.get()
    ndk = app.doc_topics()
    ok = (nwk.sum() == app.num_tokens
          and np.array_equal(nk[:app.K], nwk.sum(0))
          and np.array_equal(ndk.sum(1),
                             np.bincount(td, minlength=app.num_docs))
          and (nwk >= 0).all() and (ndk >= 0).all() and (nk >= 0).all())
    if not ok:
        raise SystemExit("LightLDA count invariants do not hold")


def phase_sparse_tables(SparseMatrixTable, rng) -> None:
    """Phase 5: SparseMatrixTable add_sparse / get_rows / get_rows_sparse
    on the card against numpy, flat and tiled."""
    for tiled, updater, dtype in ((False, "default", "int32"),
                                  (True, "default", "int32"),
                                  (False, "sgd", "float32"),
                                  (True, "sgd", "float32")):
        rows, cols = 5_000, 1024
        t = SparseMatrixTable(rows, cols, dtype, updater=updater,
                              device="cuda", tiled=tiled,
                              name=f"smoke_sparse_{tiled}_{updater}")
        ref = np.zeros((rows, cols), dtype)
        for _ in range(3):
            n = 100_000
            r = np.clip(rng.zipf(1.1, n) - 1, 0, rows - 1)
            c = rng.integers(0, cols, n)
            v = rng.integers(-3, 4, n).astype(dtype)
            t.add_sparse(r, c, v)
            np.add.at(ref, (r, c), v if updater == "default"
                      else np.float32(-0.1) * v)
        q = zipf_ids(rng, 2000, rows + 1)
        got, got_rows = t.get(), t.get_rows(q)
        indptr, sc, sv = t.get_rows_sparse(q)
        dense = np.zeros((len(q), cols), dtype)
        for i in range(len(q)):
            dense[i, sc[indptr[i]:indptr[i + 1]]] = sv[indptr[i]:indptr[i + 1]]
        err = float(np.abs(got - ref).max())
        if not (np.allclose(got, ref, rtol=1e-5, atol=1e-5)
                and np.allclose(got_rows, ref[q], rtol=1e-5, atol=1e-5)
                and np.array_equal(dense, got_rows)):
            raise SystemExit(f"SparseMatrixTable {updater} tiled={tiled}: "
                             f"differs from numpy (max {err})")
        if dtype == "int32" and not np.array_equal(got, ref):
            raise SystemExit("SparseMatrixTable int32 counts not exact")
        log(f"  SparseMatrixTable {updater:7s} {dtype} tiled={tiled!s:5s} "
            f"add_sparse x3 + get_rows + get_rows_sparse: matches numpy "
            f"(max |err| {err:.3g}; {int(indptr[-1])} nonzeros fetched)")


def lda_app(LightLDA, LDAConfig, tw, td, **extra):
    """LightLDA at the metric of record's width on the card."""
    cfg = dict(num_topics=LDA_K, batch_tokens=LDA_B, steps_per_call=1,
               seed=1, sampler="tiled")
    cfg.update(extra)
    return LightLDA(tw, td, LDA_V, LDAConfig(**cfg), device="cuda",
                    name="smoke_lda")


def phase_lda(torch, tk, ls, LightLDA, LDAConfig, tw, td,
              profile: bool, then=None) -> dict:
    """Phase 6: LightLDA doc-blocked at the LDA metric of record;
    ``then(app)`` runs on the app once the phase is done with it."""
    t0 = time.perf_counter()
    app = lda_app(LightLDA, LDAConfig, tw, td, stale_words=True,
                  doc_blocked=True)
    _sync(torch)
    setup_s = time.perf_counter() - t0
    ll0 = app.loglik()
    t0 = time.perf_counter()
    app.sweep()
    _sync(torch)
    warm_s = time.perf_counter() - t0
    runs, counts = [], None
    for i in range(LDA_TIMED_SWEEPS):
        before = {**tk.LAUNCHES, **ls.LAUNCHES}
        t0 = time.perf_counter()
        app.sweep()
        _sync(torch)
        runs.append(time.perf_counter() - t0)
        if i == 0:
            after = {**tk.LAUNCHES, **ls.LAUNCHES}
            counts = {k: after[k] - before[k] for k in after}
    ll1 = app.loglik()
    steps = app.calls_per_sweep * app.config.steps_per_call
    want = {"gibbs_sample_docblock": steps,
            "gibbs_sample_docblock_rows": steps, "row_gather": 0,
            "coo_scatter_add": 1}
    for name, n in want.items():
        if counts[name] != n:
            raise SystemExit(f"LightLDA sweep: {name} launched "
                             f"{counts[name]} times, expected {n}")
    if not (np.isfinite(ll0) and np.isfinite(ll1) and ll1 > ll0):
        raise SystemExit(f"LightLDA loglik did not rise: {ll0} -> {ll1}")
    t0 = time.perf_counter()
    check_lda_invariants(app, td)
    inv_s = time.perf_counter() - t0
    # the sweep-end rebuild alone (sort + COO add of every token), and
    # the bf16 mirror cast
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    app._word_counts_from_z()
    end.record()
    end.synchronize()
    rebuild_ms = start.elapsed_time(end)
    rates = [LDA_T / r for r in runs]
    out = dict(
        doc_tokens_per_sec=LDA_T * len(runs) / sum(runs),
        runs_tok_per_sec=rates,
        spread_pct=100 * (max(rates) - min(rates)) / max(rates),
        secs_per_sweep=runs, warm_sweep_s=warm_s, setup_s=setup_s,
        invariants_s=inv_s, loglik_before=ll0, loglik_after=ll1,
        calls_per_sweep=app.calls_per_sweep, blocks=app._nb_pad,
        packing_fill=app.packing_fill, launches_per_sweep=counts,
        rebuild_ms=rebuild_ms,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"  setup {setup_s:.2f} s ({app._nb_pad} blocks, "
        f"{100 * app.packing_fill:.1f}% full, {app.calls_per_sweep} calls "
        f"per sweep); warm-up sweep {warm_s:.3f} s; timed sweeps "
        f"{[round(r, 4) for r in runs]} s")
    log(f"  loglik {ll0:.5f} -> {ll1:.5f}; invariants exact; launches per "
        f"sweep {counts}; rebuild {rebuild_ms:.2f} ms")
    if profile:
        out["profile"] = profile_call(torch, "lda_sweep_trace.json",
                                      app.sweep, 1e3 * min(runs))
    if then is not None:
        then(app)
    del app
    torch.cuda.empty_cache()
    return out


def phase_lda_mh(torch, tk, ls, LightLDA, LDAConfig, tw, td,
                 docblock: dict, profile: bool) -> dict:
    """Phase 6b: sampler="mh" at the LDA metric's width: one warm-up and
    two timed sweeps, each fenced by a host sync; loglik before and after
    (it must rise), the count invariants exactly, doc-tokens/s with its
    spread beside phase 6's doc-blocked rate, and the launches of a sweep
    (two COO adds a step, no row gather)."""
    t0 = time.perf_counter()
    app = lda_app(LightLDA, LDAConfig, tw, td, sampler="mh")
    _sync(torch)
    setup_s = time.perf_counter() - t0
    ll0 = app.loglik()
    t0 = time.perf_counter()
    app.sweep()
    _sync(torch)
    warm_s = time.perf_counter() - t0
    runs, counts = [], None
    for i in range(2):
        before = {**tk.LAUNCHES, **ls.LAUNCHES}
        t0 = time.perf_counter()
        app.sweep()
        _sync(torch)
        runs.append(time.perf_counter() - t0)
        if i == 0:
            after = {**tk.LAUNCHES, **ls.LAUNCHES}
            counts = {k: after[k] - before[k] for k in after}
    ll1 = app.loglik()
    steps = app.calls_per_sweep * app.config.steps_per_call
    want = {"coo_scatter_add": 2 * steps, "row_gather": 0,
            "gather_rows_mesh": 0, "coo_scatter_add_mesh": 0}
    for name, n in want.items():
        if counts[name] != n:
            raise SystemExit(f"LightLDA mh sweep: {name} launched "
                             f"{counts[name]} times, expected {n}")
    if not (np.isfinite(ll0) and np.isfinite(ll1) and ll1 > ll0):
        raise SystemExit(f"LightLDA mh loglik did not rise: {ll0} -> {ll1}")
    check_lda_invariants(app, td)
    rates = [LDA_T / r for r in runs]
    rate = LDA_T * len(runs) / sum(runs)
    out = dict(doc_tokens_per_sec=rate, runs_tok_per_sec=rates,
               spread_pct=100 * (max(rates) - min(rates)) / max(rates),
               secs_per_sweep=runs, warm_sweep_s=warm_s, setup_s=setup_s,
               loglik_before=ll0, loglik_after=ll1,
               calls_per_sweep=app.calls_per_sweep,
               mh_steps=app.config.mh_steps, launches_per_sweep=counts,
               vs_doc_blocked=rate / docblock["doc_tokens_per_sec"])
    log(f"  setup {setup_s:.2f} s; warm-up sweep {warm_s:.3f} s; timed "
        f"sweeps {[round(r, 4) for r in runs]} s; loglik {ll0:.5f} -> "
        f"{ll1:.5f}; invariants exact; launches per sweep "
        f"{ {k: v for k, v in counts.items() if v} }")
    log(f"  mh ({app.config.mh_steps} rounds): {rate:.0f} doc-tokens/s "
        f"(runs {[round(r) for r in rates]}, spread "
        f"{out['spread_pct']:.1f}%) against phase 6's doc-blocked "
        f"{docblock['doc_tokens_per_sec']:.0f} "
        f"({out['vs_doc_blocked']:.3f}x)")
    if profile:
        out["profile"] = profile_call(torch, "lda_mh_sweep_trace.json",
                                      app.sweep, 1e3 * min(runs))
        os.remove(os.path.join(HERE, "chiprun_out",
                               "lda_mh_sweep_trace.json"))
    del app
    torch.cuda.empty_cache()
    return out


def phase_lda_tiled(torch, tk, ls, LightLDA, LDAConfig, tw, td) -> dict:
    """Phase 7: sampler="tiled" at the same width, exact and stale."""
    out = {}
    for stale in (False, True):
        app = lda_app(LightLDA, LDAConfig, tw, td, stale_words=stale)
        ll0 = app.loglik()
        app.sweep()
        _sync(torch)
        before = {**tk.LAUNCHES, **ls.LAUNCHES}
        t0 = time.perf_counter()
        app.sweep()
        _sync(torch)
        dt = time.perf_counter() - t0
        after = {**tk.LAUNCHES, **ls.LAUNCHES}
        counts = {k: after[k] - before[k] for k in after}
        steps = app.calls_per_sweep * app.config.steps_per_call
        want = {"gibbs_sample_tiled": steps, "row_gather": 2 * steps,
                "coo_scatter_add": 1 if stale else steps}
        for name, n in want.items():
            if counts[name] != n:
                raise SystemExit(f"LightLDA tiled: {name} launched "
                                 f"{counts[name]} times, expected {n}")
        ll1 = app.loglik()
        if not (np.isfinite(ll1) and ll1 > ll0):
            raise SystemExit(f"LightLDA tiled: loglik {ll0} -> {ll1}")
        check_lda_invariants(app, td)
        key = "stale" if stale else "exact"
        out[key] = dict(doc_tokens_per_sec=LDA_T / dt, sweep_s=dt,
                        loglik_before=ll0, loglik_after=ll1,
                        launches_per_sweep=counts)
        log(f"  tiled {key}: {LDA_T / dt:.0f} doc-tokens/s (one timed "
            f"sweep, {dt:.3f} s); loglik {ll0:.5f} -> {ll1:.5f}; "
            f"invariants exact")
        del app
        torch.cuda.empty_cache()
    return out


def phase_lda_streamed(torch, LightLDA, LDAConfig) -> dict:
    """Phase 8: streamed vs in-memory doc-blocked, bit-identical."""
    tw, td = zipf_lda_corpus(LDA_V, LDA_SMALL_D, LDA_SMALL_T, seed=0)
    runs = {}
    for streamed in (False, True):
        app = lda_app(LightLDA, LDAConfig, tw, td, doc_blocked=True,
                      stream_blocks=streamed)
        t0 = time.perf_counter()
        app.train(num_iterations=2)
        _sync(torch)
        runs[streamed] = (app, time.perf_counter() - t0)
    (mem, mem_s), (st, st_s) = runs[False], runs[True]
    same = (np.array_equal(st._z_host, mem._z.cpu().numpy())
            and np.array_equal(st.word_topics(), mem.word_topics())
            and np.array_equal(st.doc_topics(), mem.doc_topics())
            and np.array_equal(st.summary.get(), mem.summary.get())
            and st.ll_history == mem.ll_history)
    if not same:
        raise SystemExit("LightLDA streamed != in-memory after 2 sweeps")
    check_lda_invariants(st, td)
    log(f"  T {LDA_SMALL_T}, D {LDA_SMALL_D}: streamed == in-memory bit for "
        f"bit after 2 sweeps (z, tables, doc counts, loglik "
        f"{mem.ll_history}); {mem_s:.2f} s in memory, {st_s:.2f} s streamed")
    return dict(inmemory_s=mem_s, streamed_s=st_s, ll=mem.ll_history)


def bits(torch, t):
    """A float tensor's bit patterns on the host."""
    kind = torch.int16 if t.element_size() == 2 else torch.int32
    return t.detach().contiguous().cpu().view(kind)


def same_bits(torch, a, b) -> bool:
    return torch.equal(bits(torch, a), bits(torch, b))


def kv_keys(rng, n):
    """n distinct random 64-bit keys (never the empty key)."""
    keys = np.unique(rng.integers(1, 2 ** 63, size=n + n // 50 + 16,
                                  dtype=np.uint64))
    rng.shuffle(keys)
    return keys[:n]


def kv_table(KVTable, updater, value_dim, capacity=SLR_CAPACITY,
             slots=SLR_SLOTS, **kw):
    return KVTable(capacity, value_dim=value_dim, slots_per_bucket=slots,
                   updater=updater, device="cuda",
                   name=f"smoke_kv_{updater}_{value_dim}", **kw)


def kv_ftrl_call(tk, KVTable, mesh=None):
    """Phase 2's ftrl probe + commit at value_dim 2 (the sparse-LR step's)
    made anew from its recipe: a 2^25-slot table filled with half of
    KV_REAL keys (seed 11, phase 2's flat keys), and a call that adds all
    of them; on ``mesh``, the table's shards and the sharded form."""
    rng = np.random.default_rng(11)
    keys = kv_keys(rng, KV_REAL)
    if mesh is None:
        t = kv_table(KVTable, "ftrl", 2)
    else:
        t = KVTable(SLR_CAPACITY, value_dim=2, slots_per_bucket=SLR_SLOTS,
                    updater="ftrl", mesh=mesh, name="smoke_kv_sharded")
    t.add(keys[:KV_REAL // 2], rng.standard_normal(
        (KV_REAL // 2, 2)).astype(np.float32))
    t.wait()
    prep = t.prepare_add(keys, rng.standard_normal((KV_REAL, 2)).astype(
        np.float32))
    ops = (prep.buckets, prep.query, prep.deltas, prep.valid)
    if mesh is None:
        return functools.partial(
            tk.kv_probe_update, t.keys, t.values, t.state,
            *(x[0][:KV_REAL] for x in ops), prep.option, "ftrl")
    return functools.partial(
        tk.kv_probe_update_sharded, t.key_shards, t.value_shards,
        t.state_shards, *ops, prep.option, "ftrl", counts=prep.counts)


def kv_triple(table, device=None):
    """Copies of a KVTable's (keys, values, state)."""
    to = (lambda t: t.to(device)) if device else (lambda t: t.clone())
    return (to(table.keys), to(table.values),
            {k: to(v) for k, v in table.state.items()})


def same_triple(torch, a, b) -> bool:
    return (torch.equal(a[0].cpu(), b[0].cpu())
            and same_bits(torch, a[1], b[1])
            and sorted(a[2]) == sorted(b[2])
            and all(same_bits(torch, a[2][k], b[2][k]) for k in a[2]))


def free_tables(torch) -> None:
    """Drop every table from the process-wide registry (which holds them
    alive) and give their device memory back."""
    from multiverso_tpu_torch.tables import reset_tables
    reset_tables()
    gc.collect()            # apps whose wrappers hold them in a cycle
    torch.cuda.empty_cache()


def kv_shards(t, device=None) -> tuple:
    """Copies of a KVTable's (key, value, state) shard lists, on
    ``device`` (default: where they lie)."""
    to = (lambda x: x.to(device)) if device else (lambda x: x.clone())
    return ([to(k) for k in t.key_shards], [to(v) for v in t.value_shards],
            [{k: to(v) for k, v in st.items()} for st in t.state_shards])


def same_cells(torch, a, b) -> bool:
    """Bit for bit, on ``a``'s device (``b`` moved there)."""
    kind = torch.int16 if a.element_size() == 2 else torch.int32
    return a.dtype == b.dtype and torch.equal(
        a.view(kind), b.to(a.device).view(kind))


def same_shards(torch, a, b) -> bool:
    """Two (key, value, state) shard lists bit for bit."""
    cells = lambda r: ([*r[0], *r[1]] + [st[k] for st in r[2]
                                         for k in sorted(st)])
    return sorted(a[2][0]) == sorted(b[2][0]) and all(
        same_cells(torch, x, y) for x, y in zip(cells(a), cells(b)))


def kv_probe_bytes(n: int, touched: int, cols: int, n_state: int,
                   value_bytes: int = 4, shards: int = 1) -> int:
    """The bytes the KV probe + commit must move: per real lane its
    bucket, query and valid read, its float32 delta read, its key
    written, its value cell (of ``value_bytes`` an element) and each
    float32 state leaf's read and written; per touched bucket its key row
    read; each shard's overflow count written."""
    return (n * (4 + 8 + 1) + n * cols * 4 + touched * SLR_SLOTS * 8
            + n * (8 + 2 * cols * (value_bytes + 4 * n_state)) + 4 * shards)


def kv_lookup_bytes(n: int, distinct: int, touched: int, cols: int,
                    value_bytes: int = 4, inv: bool = False) -> int:
    """The bytes the KV lookup must move: per caller lane its result and
    found written (and its ``inv`` entry read); per distinct lane its
    query and bucket read; per bucket named its key row and value cells
    read."""
    return (n * ((4 if inv else 0) + cols * value_bytes + 1) + distinct * 12
            + touched * SLR_SLOTS * (8 + cols * value_bytes))


def kv_flat_lanes(torch, t, keys) -> tuple:
    """The flat lookup's lanes of ``keys`` on ``t``: queries and buckets
    on the card, padded to a power of two (empty query, bucket 0)."""
    from multiverso_tpu_torch.tables.hashing import _bucket, _split_keys
    n, b = len(keys), _bucket(len(keys))
    query = np.full((b, 2), 0xFFFFFFFF, np.uint32)
    query[:n] = _split_keys(keys)
    buckets = np.zeros(b, np.int32)
    buckets[:n] = t._buckets_of(keys)
    return (torch.as_tensor(query.view(np.int32), device="cuda"),
            torch.as_tensor(buckets, device="cuda"))


def kv_add_case(torch, tk, KVTable, keys, present, rng, name: str,
                vdim: int, dtype: str = "float32", mesh=None,
                plain_on: str = "cpu") -> tuple:
    """One of phase 2's KV probe + commit cases at the sparse-LR step's
    shapes: a 2^25-slot table of ``dtype`` values (``vdim`` columns; on
    ``mesh`` its shards and the sharded form) pre-filled with ``present``
    by one add, then a call that adds every key of ``keys``, launched on
    the real lanes. The kernel against the plain version on the same
    inputs, bit for bit, on the CPU or on the card (``plain_on="cuda"``).
    Returns ``(row, table, plain)``: the table after the add and the
    plain version's shard lists, equal to it."""
    t = KVTable(SLR_CAPACITY, value_dim=vdim, dtype=dtype,
                slots_per_bucket=SLR_SLOTS, updater=name, mesh=mesh,
                device=None if mesh else "cuda",
                name=f"smoke_kv_{name}_{vdim}_{dtype}")
    shape = lambda m: (m, vdim) if vdim else (m,)
    t.add(present, rng.standard_normal(shape(len(present))).astype(
        np.float32))
    t.wait()
    n = len(keys)
    prep = t.prepare_add(keys, rng.standard_normal(shape(n)).astype(
        np.float32))
    ops = (prep.buckets, prep.query, prep.deltas, prep.valid)
    if mesh is None:
        # the one shard's real lanes: the flat kernel's layout
        ops = tuple(x[0][:n] for x in ops)
        kernel = lambda tr: tk.kv_probe_update(
            tr[0][0], tr[1][0], tr[2][0], *ops, prep.option, name)
        plain = lambda tr, o=ops: tk.kv_probe_update_plain(
            tr[0][0], tr[1][0], tr[2][0], *o, prep.option, name)
    else:
        kernel = lambda tr: tk.kv_probe_update_sharded(
            *tr, *ops, prep.option, name, counts=prep.counts)
        plain = lambda tr, o=ops: tk.kv_probe_update_sharded_plain(
            *tr, *o, prep.option, name)
    on_cpu = plain_on == "cpu"
    want_t = kv_shards(t, "cpu" if on_cpu else None)
    want = plain(want_t, [to_host(torch, x) for x in ops] if on_cpu
                 else ops)
    timed = kv_shards(t)
    plain_t = kv_shards(t) if on_cpu else want_t
    got = kernel((t.key_shards, t.value_shards, t.state_shards))
    _sync(torch)
    label = (f"kv_probe_update{'_sharded' * (mesh is not None)} {name} "
             f"D={vdim} {dtype}")
    if int(got[3]) != 0 or int(want[3]) != 0:
        raise SystemExit(f"{label}: overflowed ({int(got[3])}, plain "
                         f"{int(want[3])})")
    if not same_shards(torch, want_t, (t.key_shards, t.value_shards,
                                       t.state_shards)):
        raise SystemExit(f"{label}: kernel != plain version on the "
                         f"{'CPU' if on_cpu else 'card'}")
    cols, ns = max(vdim, 1), len(t.state_shards[0])
    vb = t.value_shards[0].element_size()
    touched = len(np.unique(t._buckets_of(keys)))
    b_ms, by = bound_ms(kv_probe_bytes(n, touched, cols, ns, vb,
                                       len(t.key_shards)),
                        n * cols * KV_UPDATER_OPS[name])
    row = dict(
        max_abs_err=0.0, ms=cuda_ms(lambda: kernel(timed), 20),
        plain_ms=cuda_ms(lambda: plain(plain_t), 5), library_ms=None,
        bound_ms=b_ms, bound_by=by,
        n=int(to_host(torch, prep.buckets).numel()), real=n, claimed=n - len(present), plain_on=plain_on,
        sector_bound_ms=kv_sector_bound_ms(n, touched, cols, ns, vb))
    return row, t, want_t


def kv_log(out: dict) -> None:
    for name, r in out.items():
        f32 = f" (float32 {r['f32_ms']:.4f} ms)" if r.get("f32_ms") else ""
        plain = f"  plain {r['plain_ms']:.4f} ms" if r["plain_ms"] else ""
        where = "card" if r.get("plain_on") == "cuda" else "CPU"
        log(f"  {name:40s} n={r['n']:7d} ({r['real']} real) kernel "
            f"{r['ms']:.4f} ms{f32}{plain}  library none  bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})  "
            f"{r['ms'] / r['bound_ms']:.1f}x bound; bit-identical to the "
            f"plain version on the {where}" + (
                f"; sector bound {r['sector_bound_ms']:.4f} ms"
                if "sector_bound_ms" in r else ""))


def phase_kv_kernels(torch, tk, KVTable) -> dict:
    """Phase 2, the float32 KV kernels vs their plain versions on the CPU
    at the sparse-LR step's shapes; returns {name: row}."""
    rng = np.random.default_rng(11)
    keys = kv_keys(rng, KV_REAL)
    present = keys[:KV_REAL // 2]
    out = {}

    # lookup: a table pre-filled with the present half by one add
    t = kv_table(KVTable, "default", 2)
    t.add(present, rng.standard_normal((len(present), 2)).astype(
        np.float32))
    t.wait()
    n = len(keys)
    qd, bd = kv_flat_lanes(torch, t, keys)
    b = qd.shape[0]
    got_v, got_f = tk.kv_lookup(t.keys, t.values, qd, bd, 0.0)
    want_v, want_f = tk.kv_lookup_plain(t.keys.cpu(), t.values.cpu(),
                                        qd.cpu(), bd.cpu(), 0.0)
    _sync(torch)
    if not (torch.equal(got_f.cpu(), want_f)
            and same_bits(torch, got_v, want_v)):
        raise SystemExit("kv_lookup: kernel != plain version on the CPU")
    if int(want_f[:n].sum()) != len(present):
        raise SystemExit("kv_lookup: found != the keys added")
    err = float((got_v.cpu() - want_v).abs().max())
    touched = int(torch.unique(bd).numel())
    nb_, by = bound_ms(kv_lookup_bytes(b, b, touched, 2), 0)
    out["kv_lookup"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: tk.kv_lookup(t.keys, t.values, qd, bd), 50),
        plain_ms=cuda_ms(lambda: tk.kv_lookup_plain(t.keys, t.values, qd,
                                                    bd), 10),
        library_ms=None, bound_ms=nb_, bound_by=by, n=b, real=n,
        found=len(present))
    del t, got_v, got_f
    free_tables(torch)

    # probe + commit: every updater at value_dim 2, default at 0, on a
    # table pre-filled by one add (the batch matches half and claims half)
    for name, vdim in [(u, 2) for u in KV_UPDATERS] + [("default", 0)]:
        row, t, _ = kv_add_case(torch, tk, KVTable, keys, present, rng,
                                name, vdim)
        out[f"kv_probe_update_{name}_{vdim}"] = row
        if name == "ftrl" and vdim == 2:
            over_lanes = kv_overflow_check(torch, tk, t, rng)
        del t, _
        free_tables(torch)
    kv_log(out)
    log(f"  kv_probe_update overflow batch: {over_lanes} of 32 lanes into "
        "one bucket; n_over equal to the plain version's, the triple "
        "bit-identical after it")
    return out


#: phase 2's 2-byte KV value types, each under these updaters: ftrl held
#: against the plain version on the CPU, adagrad against the plain version
#: on the card (whose torch divides by a CPU scalar as a product with its
#: reciprocal, so ftrl's and adam's plain versions round otherwise there)
KV_TWO_BYTE = ("bfloat16", "float16")
KV_TWO_BYTE_UPDATERS = ("ftrl", "adagrad")


def phase_kv_dtypes(torch, tk, KVTable, devices, kv_results,
                    sharded_results) -> dict:
    """Phase 2, the KV kernels at bfloat16 and float16 values at the
    sparse-LR step's shapes, through :func:`kv_add_case` on the float32
    cases' keys and lanes: the probe + commit flat and sharded (S = 4 on
    ``devices``) under ftrl and adagrad, then under ftrl the lookup of
    every key on the table the add left, flat and sharded. Each kernel is
    held bit for bit against its plain version on the same inputs: under
    ftrl on the CPU, under adagrad on the card, which costs no copy of a
    table to the host. Each time beside the float32 form's. Returns
    {name: row}."""
    from multiverso_tpu_torch import core
    keys = kv_keys(np.random.default_rng(11), KV_REAL)
    present = keys[:KV_REAL // 2]
    mesh = core.Mesh([devices])
    out = {}
    for dtype in KV_TWO_BYTE:
        for name in KV_TWO_BYTE_UPDATERS:
            for sharded in (False, True):
                on_cpu = name == "ftrl"
                row, t, host = kv_add_case(
                    torch, tk, KVTable, keys, present,
                    np.random.default_rng(12), name, 2, dtype,
                    mesh if sharded else None, "cpu" if on_cpu else "cuda")
                if not sharded:
                    f32 = kv_results[f"kv_probe_update_{name}_2"]
                elif name == "ftrl":
                    f32 = sharded_results["kv_probe_update_sharded"]
                else:
                    f32 = None
                row["f32_ms"] = f32 and f32["ms"]
                tag = "_sharded" * sharded
                out[f"kv_probe_update{tag}_{name}_{dtype}"] = row
                if name == "ftrl":
                    out[f"kv_lookup{tag}_{dtype}"] = kv_lookup_case(
                        torch, tk, t, keys, host if on_cpu else None,
                        sharded_results["kv_lookup_sharded"] if sharded
                        else kv_results["kv_lookup"])
                del t, host
                free_tables(torch)
    kv_log(out)
    return out


def kv_lookup_case(torch, tk, t, keys, host, f32) -> dict:
    """The lookup of every key of ``keys`` on table ``t`` (flat, or the
    sharded form on every lane of ``inv``) against the plain version: on
    ``host``, the table's (key, value) shard lists on the CPU, or when
    that is None on the card. The values' type out, bit for bit. Returns
    its row (the plain version timed on the card), beside ``f32``'s
    time."""
    n = len(keys)
    if len(t.key_shards) == 1:
        qd, bd = kv_flat_lanes(torch, t, keys)
        look = lambda: tk.kv_lookup(t.keys, t.values, qd, bd, 0.0)
        plain = lambda: tk.kv_lookup_plain(t.keys, t.values, qd, bd, 0.0)
        want = plain() if host is None else tk.kv_lookup_plain(
            host[0][0], host[1][0], qd.cpu(), bd.cpu(), 0.0)
        lanes, distinct, inv = qd.shape[0], qd.shape[0], False
    else:
        q, lb, iv = t._get_lanes(keys, t._buckets_of(keys))
        look = lambda: tk.kv_lookup_sharded(t.key_shards, t.value_shards,
                                            q, lb, iv, 0.0)
        plain = lambda: tk.kv_lookup_sharded_plain(
            t.key_shards, t.value_shards, q, lb, iv, 0.0)
        want = plain() if host is None else tk.kv_lookup_sharded_plain(
            host[0], host[1], to_host(torch, q), to_host(torch, lb),
            iv.cpu(), 0.0)
        lanes, distinct, inv = iv.shape[0], len(np.unique(
            iv.cpu().numpy())), True
    got_v, got_f = look()
    _sync(torch)
    label = f"kv_lookup{'_sharded' * inv} {t.dtype}"
    if got_v.dtype != t.dtype or not (
            torch.equal(got_f.cpu(), want[1].cpu())
            and same_cells(torch, want[0], got_v)):
        raise SystemExit(f"{label}: kernel != plain version on the "
                         f"{'card' if host is None else 'CPU'}")
    if int(want[1][:n].sum()) != n:
        raise SystemExit(f"{label}: found != the keys added")
    touched = len(np.unique(t._buckets_of(keys)))
    b_ms, by = bound_ms(kv_lookup_bytes(lanes, distinct, touched, 2,
                                        t.value_shards[0].element_size(),
                                        inv), 0)
    return dict(max_abs_err=0.0, ms=cuda_ms(look, 50),
                plain_ms=cuda_ms(plain, 10), library_ms=None,
                bound_ms=b_ms, bound_by=by, f32_ms=f32["ms"], n=lanes,
                real=n, plain_on="cuda" if host is None else "cpu")


def kv_overflow_check(torch, tk, t, rng) -> int:
    """One small batch that overflows a bucket: the kernel's n_over must
    equal the plain version's and leave the triple bit-identical."""
    row = t.keys[123_457].cpu()
    empties = int((row == -1).all(-1).sum())
    m = empties + 3                     # new keys: 3 past the empties
    from multiverso_tpu_torch.tables.hashing import _split_keys
    query = np.full((32, 2), -1, np.int32)
    query[:m] = _split_keys(kv_keys(rng, m) | np.uint64(1 << 62)).view(
        np.int32)
    buckets = np.full(32, t.num_buckets - 1, np.int32)
    buckets[:m] = 123_457
    valid = np.arange(32) < m
    deltas = rng.standard_normal((32, 2)).astype(np.float32)
    lanes = [torch.as_tensor(x, device="cuda")
             for x in (buckets, query, deltas, valid)]
    before = kv_triple(t)
    cpu = kv_triple(t, "cpu")
    want = tk.kv_probe_update_plain(*cpu, *(x.cpu() for x in lanes),
                                    t.default_option, t.updater)
    got = tk.kv_probe_update(t.keys, t.values, t.state, *lanes,
                             t.default_option, t.updater)
    _sync(torch)
    if int(got[3]) != int(want[3]) or int(got[3]) != 3:
        raise SystemExit(f"kv overflow batch: n_over {int(got[3])}, plain "
                         f"{int(want[3])}, expected 3")
    if not (same_triple(torch, got[:3], before)
            and same_triple(torch, want[:3], before)):
        raise SystemExit("kv overflow batch: the table changed")
    return m


def slr_small_parity(torch, SparseLogisticRegression, SparseLRConfig,
                     synthetic_sparse) -> None:
    """Two minibatches of a small sparse LR on the card and on the CPU
    (plain versions) from the same rows: keys bit for bit, losses and
    values within rtol 1e-5 (the step's einsum sums a sample's features in
    another order on the card)."""
    rows, y = synthetic_sparse(n=1024, dim=100_000, num_classes=2,
                               nnz=SLR_NNZ, seed=5)
    cfg = SparseLRConfig(max_features=64, capacity=1 << 18,
                         minibatch_size=512, updater="ftrl")
    apps = [SparseLogisticRegression(cfg, device=d, name=f"smoke_slr_{d}")
            for d in ("cuda", "cpu")]
    losses = []
    for s in (0, 512):
        losses.append([a.train_batch(rows[s:s + 512], y[s:s + 512])
                       for a in apps])
    gpu, host = (a.table for a in apps)
    gpu.wait()
    if not torch.equal(gpu.keys.cpu(), host.keys):
        raise SystemExit("sparse LR card vs CPU: keys differ")
    a, b = gpu.values.cpu().numpy(), host.values.numpy()
    if not (np.allclose(a, b, rtol=1e-5, atol=1e-6)
            and all(np.isclose(x, y_, rtol=1e-5) for x, y_ in losses)):
        raise SystemExit(f"sparse LR card vs CPU: values max "
                         f"{np.abs(a - b).max()}, losses {losses}")
    log(f"  sparse LR card vs CPU: keys bit-identical ({len(host)} keys), "
        f"values within rtol 1e-5 (max |diff| {np.abs(a - b).max():.3g}), "
        f"losses {[round(x, 6) for x, _ in losses]} vs "
        f"{[round(y_, 6) for _, y_ in losses]}")


def np_update(name, opt, v, a, b, d):
    """The numpy float32 model of one updater step on a key's row."""
    f = np.float32
    if name == "default":
        return v + d, a, b
    if name == "sgd":
        return v - f(opt.learning_rate) * d, a, b
    if name == "adagrad":
        a = a + d * d
        return v - f(opt.learning_rate) * d / (np.sqrt(a) + f(opt.lam)), a, b
    alpha, beta, l1, l2 = (f(opt.learning_rate), f(opt.momentum),
                           f(opt.lam), f(opt.rho))
    n_new = b + d * d                       # ftrl: a = z, b = n
    sigma = (np.sqrt(n_new) - np.sqrt(b)) / alpha
    z = a + d - sigma * v
    shrunk = np.sign(z) * np.maximum(np.abs(z) - l1, f(0))
    with np.errstate(divide="ignore", invalid="ignore"):
        w = np.where(np.abs(z) <= l1, f(0),
                     -shrunk / ((beta + np.sqrt(n_new)) / alpha + l2))
    return w.astype(np.float32), z, n_new


def phase_kv_table(torch, KVTable, AddOption, rng, tmp) -> None:
    """Phase 9: KVTable on the card against a numpy model."""
    options = {"default": AddOption(), "sgd": AddOption(learning_rate=0.05),
               "adagrad": AddOption(learning_rate=0.1, lam=1e-6),
               "ftrl": AddOption.for_ftrl(0.1, 0.01, 0.001, 1.0)}
    for name in ("default", "sgd", "adagrad", "ftrl"):
        for vdim in (0, 2):
            default = 0.25 if name == "default" else 0.0
            t = kv_table(KVTable, name, vdim, capacity=1 << 17, slots=8,
                         default_value=default,
                         default_option=options[name])
            opt = options[name]
            pool = kv_keys(rng, 20_000)
            v0, f0 = t.get(pool[:1000])
            if f0.any() or not (v0 == default).all():
                raise SystemExit(f"KVTable {name}: get of missing keys")
            cols = max(vdim, 1)
            model = {}
            for _ in range(3):
                keys = rng.choice(pool, size=6000, replace=False)
                d = rng.standard_normal((len(keys), cols)).astype(
                    np.float32)
                t.add(keys, d if vdim else d[:, 0])
                for k, dk in zip(keys.tolist(), d):
                    v, a, b = model.get(k, (np.full(cols, default,
                                                    np.float32),
                                            np.zeros(cols, np.float32),
                                            np.zeros(cols, np.float32)))
                    model[k] = np_update(name, opt, v, a, b, dk)
            t.wait()
            mk = np.asarray(list(model), np.uint64)
            want = np.stack([model[k][0] for k in model.keys()])
            got, found = t.get(mk)
            got = got.reshape(len(mk), cols)
            err = float(np.abs(got - want).max())
            if not (found.all() and np.allclose(got, want, rtol=1e-6,
                                                atol=1e-7)):
                raise SystemExit(f"KVTable {name} D={vdim}: differs from "
                                 f"numpy (max {err})")
            missing = np.setdiff1d(pool, mk)[:500]
            vm, fm = t.get(missing)
            if fm.any() or not (vm == default).all() or len(t) != len(mk):
                raise SystemExit(f"KVTable {name}: missing keys or len()")
            uri = os.path.join(tmp, f"kv_{name}_{vdim}.npz")
            t.store(uri)
            t2 = kv_table(KVTable, name, vdim, capacity=1 << 17, slots=8,
                          default_value=default)
            t2.load(uri)
            if not same_triple(torch, kv_triple(t2), kv_triple(t)):
                raise SystemExit(f"KVTable {name}: store -> load differs")
            log(f"  KVTable {name:7s} D={vdim}: 3 adds of 6,000 keys "
                f"(re-adds included) match numpy (max |err| {err:.3g}); "
                f"{len(t)} live keys; missing keys at {default}; store -> "
                f"load bit-identical")
    # the raises: duplicates, the empty key, a deferred overflow
    t = kv_table(KVTable, "sgd", 0, capacity=1 << 17, slots=8)
    for bad in ([5, 5], [2 ** 64 - 1]):
        try:
            t.add(np.asarray(bad, np.uint64), np.ones(len(bad), np.float32))
        except ValueError:
            continue
        raise SystemExit(f"KVTable: add of {bad} did not raise")
    cand = np.arange(1, 400_000, dtype=np.uint64)
    hb = t._buckets_of(cand)
    same = cand[hb == hb[0]][:t.slots + 1]
    t.add(same[:1], np.ones(1, np.float32), sync=True)
    before = kv_triple(t)
    t.add(same, np.ones(len(same), np.float32))   # 1 match + slots new
    try:
        t.wait()
        raise SystemExit("KVTable: the overflowing add did not raise")
    except RuntimeError as e:
        if "overflowed" not in str(e):
            raise
    if not same_triple(torch, kv_triple(t), before) or len(t) != 1:
        raise SystemExit("KVTable: the overflowing add changed the table")
    log("  KVTable raises: duplicate keys and the empty key (ValueError); "
        f"an add of {len(same)} keys into one {t.slots}-slot bucket raises "
        "'overflowed' at the next wait() and leaves the table bit-identical")
    del t
    free_tables(torch)


def phase_sparse_lr(torch, tk, counts, SparseLogisticRegression,
                    SparseLRConfig, synthetic_sparse, lr_step,
                    profile: bool, then=None):
    """Phase 10: sparse LR at the Criteo-like width. Returns the measured
    numbers, the launch counts read right after training and the accuracy
    pass, and the data with the final table on the host (for phase 12);
    ``then(app, rows, y)`` runs once the phase is done with the app. The
    run fills the data's ``pack_memo`` (phase 20's runs read it)."""
    t0 = time.perf_counter()
    rows, y = synthetic_sparse(n=SLR_N, dim=SLR_DIM, num_classes=2,
                               nnz=SLR_NNZ, seed=0)
    gen_s = time.perf_counter() - t0
    cfg = SparseLRConfig(capacity=SLR_CAPACITY, slots_per_bucket=SLR_SLOTS,
                         max_features=64, minibatch_size=SLR_BATCH,
                         updater="ftrl", learning_rate=0.1,
                         epochs=SLR_EPOCHS)
    free_tables(torch)                  # the earlier phases' tables
    torch.cuda.reset_peak_memory_stats()
    app = SparseLogisticRegression(cfg, device="cuda", name="smoke_slr")
    memo = PackMemo()
    memo.wrap(app)
    # the run's adds, kept for phase 17 to replay: each step's unique keys
    # and its delta (a tensor the step made and nothing writes again), so
    # keeping them costs the step nothing
    adds, add = [], app.table.add

    def recording_add(keys, deltas, *args, **kw):
        adds.append((keys, deltas))
        return add(keys, deltas, *args, **kw)

    app.table.add = recording_add
    start = counts()
    app.train(rows, y)
    app.table.add = add
    grown = {k: v - start[k] for k, v in counts().items()}
    keys_, vals_, state_ = app.table.global_arrays()
    data = dict(rows=rows, y=y, losses=[e["loss"] for e in app.epoch_stats],
                adds=adds, pack_memo=memo,
                triple=(keys_.cpu(), vals_.cpu(),
                        {k: v.cpu() for k, v in state_.items()}))
    del keys_, vals_, state_
    steps = sum(e["steps"] for e in app.epoch_stats)
    for name in ("kv_lookup", "kv_probe_update", "kv_commit"):
        if grown[name] != steps:
            raise SystemExit(f"sparse LR: {name} launched {grown[name]} "
                             f"times in {steps} steps, expected {steps}")
    losses = [e["loss"] for e in app.epoch_stats]
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise SystemExit(f"sparse LR: epoch losses {losses}")
    t0 = time.perf_counter()
    acc = app.accuracy(rows, y)
    acc_s = time.perf_counter() - t0
    data["accuracy"] = acc
    path_counts = counts()
    live = len(app.table)
    peak = torch.cuda.max_memory_allocated() / 1e9
    rates = [e["samples"] / e["seconds"] for e in app.epoch_stats]
    step_ms = [1e3 * e["seconds"] / e["steps"] for e in app.epoch_stats]

    split = slr_step_split(torch, tk, app, rows, y, lr_step,
                           ["cuda:0"], step_ms[-1])
    out = dict(samples=SLR_N, epochs=SLR_EPOCHS, steps=steps,
               samples_per_sec=rates, step_ms=step_ms, epoch_loss=losses,
               train_accuracy=acc, accuracy_s=acc_s, live_keys=live,
               peak_mem_gb=peak, data_gen_s=gen_s,
               launches_per_step={k: grown[k] / steps for k in
                                  ("kv_lookup", "kv_probe_update",
                                   "kv_commit")}, **split)
    log(f"  data: {SLR_N} samples x {SLR_NNZ} features over {SLR_DIM} dims, "
        f"made in {gen_s:.1f} s; {split['unique_keys_step']} unique keys in "
        "the first minibatch")
    log(f"  epochs: samples/s {[round(r) for r in rates]}, ms/step "
        f"{[round(m, 1) for m in step_ms]}, mean loss "
        f"{[round(x, 5) for x in losses]}; train accuracy {acc:.4f} "
        f"({acc_s:.1f} s); {live} live keys; peak device memory "
        f"{peak:.2f} GB")
    log(f"  launches per step {out['launches_per_step']}")
    if profile:
        mbs = [(rows[s:s + SLR_BATCH], y[s:s + SLR_BATCH])
               for s in range(0, 4 * SLR_BATCH, SLR_BATCH)]
        out["profile"] = profile_call(
            torch, "slr_steps_trace.json",
            lambda: [app.train_batch(r, yy) for r, yy in mbs],
            4 * step_ms[-1])
    if then is not None:
        then(app, rows, y)
    del app
    torch.cuda.empty_cache()
    return out, path_counts, data


def slr_step_split(torch, tk, app, rows, y, lr_step, devices,
                   step_ms: float) -> dict:
    """One sparse-LR step split, on one shard or many: the host prep (the
    pack, and the lookup's and the add's hashing, sort, lane slicing and
    staging) timed alone, and the step's device work replayed back to
    back on CUDA events; the rest of a ``step_ms`` step (it ends in a host
    sync) is host work."""
    from multiverso_tpu_torch.apps.sparse_logreg import BIAS_KEY
    from multiverso_tpu_torch.tables.hashing import _bucket
    tbl, dev0 = app.table, app.device
    brows, by = rows[:SLR_BATCH], y[:SLR_BATCH]
    t0 = time.perf_counter()
    keys, vals, uniq = app._pack(brows)
    t_pack = time.perf_counter() - t0
    upad = _bucket(len(uniq))
    uniq_pad = np.full(upad, BIAS_KEY ^ np.uint64(1), np.uint64)
    uniq_pad[:len(uniq)] = uniq
    t0 = time.perf_counter()
    q, lb, iv = tbl._get_lanes(uniq_pad, tbl._buckets_of(uniq_pad))
    prep = tbl.prepare_add(uniq, np.zeros((len(uniq), 2), np.float32))
    sync_all(torch, devices)
    t_lanes = time.perf_counter() - t0
    pos = app._positions(keys, vals, uniq, upad)
    posd = torch.as_tensor(pos, device=dev0).long()
    lanesd = torch.as_tensor(np.flatnonzero(pos.ravel() != upad),
                             device=dev0)
    valsd = torch.as_tensor(vals, device=dev0)
    yd = torch.as_tensor(by, device=dev0).long()
    order = torch.as_tensor(np.argsort(tbl._buckets_of(uniq), kind="stable"),
                            device=dev0)
    starts = np.concatenate([[0], np.cumsum(prep.counts)[:-1]])
    lanes = int(to_host(torch, prep.buckets).shape[1])
    zero = torch.zeros((1, 2), device=dev0)
    u = len(uniq)

    def device_step():
        w, _ = tk.kv_lookup_sharded(tbl.key_shards, tbl.value_shards, q, lb,
                                    iv, 0.0)
        _, dw = lr_step(torch.cat([w, zero]), posd, valsd, yd, 0.0, lanesd)
        sd = dw[:u][order]
        pd = torch.zeros((len(prep.counts), lanes, 2), device=dev0)
        for s, (st, c) in enumerate(zip(starts, prep.counts)):
            pd[s, :c] = sd[st:st + c]
        tk.kv_probe_update_sharded(
            tbl.key_shards, tbl.value_shards, tbl.state_shards,
            prep.buckets, prep.query, pd, prep.valid, prep.option,
            tbl.updater, counts=prep.counts,
            replicas=list(zip(tbl.replica_keys[1:], tbl.replica_values[1:],
                              tbl.replica_states[1:])),
            state_blocks=tbl.shard_update)
        join(torch, devices)
    device_ms = cuda_ms(device_step, 10)
    host_ms = step_ms - device_ms
    log(f"  one step of {step_ms:.1f} ms: device {device_ms:.3f} ms (CUDA "
        f"events, its device work back to back), host {host_ms:.1f} ms "
        f"(_pack alone {1e3 * t_pack:.1f} ms; the lookup's and the add's "
        f"hashing, sort, lane slicing and staging {1e3 * t_lanes:.1f} ms): "
        f"the device is busy {100 * device_ms / step_ms:.1f}% of a step")
    return dict(unique_keys_step=u, lanes_per_shard=lanes,
                real_lanes_per_shard=[int(c) for c in prep.counts],
                host_prep_ms=host_ms, pack_ms=1e3 * t_pack,
                lane_prep_ms=1e3 * t_lanes, device_ms=device_ms)


def shard_devices(torch) -> list:
    """The sharded phases' model shards, spread over the machine's cards
    (all on cuda:0 on a one-card machine)."""
    n = torch.cuda.device_count()
    return [f"cuda:{s % n}" for s in range(SHARDS)]


def join(torch, devices) -> None:
    """Make cuda:0's stream wait for the other cards' queued work, so that
    events on cuda:0 time a call spread over several cards."""
    for dev in sorted(set(devices) - {"cuda:0"}):
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
        torch.cuda.current_stream(0).wait_event(event)


def sync_all(torch, devices) -> None:
    for dev in sorted(set(devices)):
        torch.cuda.synchronize(dev)


def lane_slices(gids, per_shard, arrays, pads):
    """Shard-sorted global ids -> the (SHARDS, L) lane slices of local ids
    (``hashing.shard_lane_slices``), valid, the real-lane counts, the
    shard ids and positions."""
    from multiverso_tpu_torch.tables.hashing import shard_lane_slices
    shard_ids = gids // per_shard
    local = (gids - shard_ids * per_shard).astype(np.int32)
    sliced, valid, pos = shard_lane_slices(
        shard_ids, SHARDS, [local, *arrays], [np.int32(per_shard - 1), *pads])
    return sliced, valid, valid.sum(1), shard_ids, pos


def on_shards(torch, x, devices):
    """A copy of a host array cut into SHARDS row blocks, block s on
    devices[s]."""
    t = torch.tensor(np.ascontiguousarray(x))
    return [b.contiguous().to(d) for b, d in zip(t.chunk(SHARDS), devices)]


def to_host(torch, lanes):
    """A lane operand (a tensor, or per-shard rows) as one CPU tensor."""
    if isinstance(lanes, torch.Tensor):
        return lanes.cpu()
    return torch.stack([row.cpu() for row in lanes])


def launch_delta(tk, fn) -> dict:
    before = dict(tk.LAUNCHES)
    fn()
    return {k: v - before[k] for k, v in tk.LAUNCHES.items()
            if v != before[k]}


def coo_sharded_split(torch, tk, devices, rps, gids, cols, vals, lr, sc, sv,
                      valid, counts, table0, want, seg_fn) -> dict:
    """#9's int32 segment form taken apart on the same real lanes (the
    LightLDA call's, sorted by word, on four shards): (a) the segment form
    as it is (``seg_fn``), (b) the mesh form over the same lanes as one
    segment of global ids (no segment lookup), (c) the segment form with
    each segment's lanes shuffled (no sorted head row), (d) the segment
    form with ``valid`` null (no mask read: every real lane is valid
    here). Each equals the plain version (``want``, CPU shards) bit for
    bit; times in turns a, b, c, d, a, and the table concatenated's
    ``index_add_`` beside them."""
    from multiverso_tpu_torch.ops import _build
    dev0 = devices[0]
    order = np.random.default_rng(12)
    shuffled = [x.copy() for x in (lr, sc, sv)]
    for s_ in range(SHARDS):
        perm = order.permutation(int(counts[s_]))
        for x in shuffled:
            x[s_, :len(perm)] = x[s_, perm]
    ops_c = [torch.as_tensor(x, device=dev0)
             for x in (*shuffled, valid)]
    ops_d = [torch.as_tensor(x, device=dev0) for x in (lr, sc, sv)]
    shards_c = on_shards(torch, table0, devices)
    shards_d = on_shards(torch, table0, devices)
    param_b = tk.ShardedParam(on_shards(torch, table0, devices))
    g_r, g_c, g_v = (torch.as_tensor(x, device=dev0)
                     for x in (gids, cols, vals))
    lib = _build.load()
    none = (ctypes.c_void_p * SHARDS)(*([None] * SHARDS))
    scratch = {"coo_scatter_add_sharded": 0}
    launches = tk.shard_lane_launches(shards_d, ops_d, counts)

    def mesh_b():
        tk.coo_scatter_add(param_b, g_r, g_c, g_v)

    def seg_c():
        tk.coo_scatter_add_sharded(shards_c, *ops_c, counts=counts)

    def seg_d():
        for dev, part, lanes, real in launches:
            tk._launch("coo_scatter_add_sharded", "mv_coo_scatter_add_shards",
                       *tk._shard_table(shards_d, part, rps), rps, LDA_K,
                       1, *(tk._c_ptrs(x) for x in lanes), none,
                       tk._c_array(ctypes.c_int64, real), None, 0,
                       device=dev, counts=scratch)
    for fn, got in ((mesh_b, param_b.shards), (seg_c, shards_c),
                    (seg_d, shards_d)):
        fn()
        sync_all(torch, devices)
        if not all(torch.equal(a.cpu(), b) for a, b in zip(got, want)):
            raise SystemExit("coo_scatter_add_sharded split: a variant != "
                             "the plain version on the CPU")
    whole = torch.as_tensor(table0, device=dev0).view(-1)
    idx = g_r.long() * LDA_K + g_c.long()
    out = {}
    for key, fn in (("a", seg_fn), ("b_mesh_one_segment", mesh_b),
                    ("c_shuffled", seg_c), ("d_no_mask_read", seg_d),
                    ("a_again", seg_fn)):
        out[key + "_ms"] = cuda_ms(fn, 50)
    out["index_add_ms"] = cuda_ms(lambda: whole.index_add_(0, idx, g_v), 50)
    return out


def phase_sharded_kernels(torch, tk, core, KVTable, devices, rng) -> dict:
    """Phase 2, the sharded forms at S = 4 against their plain versions on
    the CPU, bit for bit; returns {name: row}."""
    from multiverso_tpu_torch.tables.hashing import _bucket
    out = {}
    cpus = ["cpu"] * SHARDS
    g = torch.Generator(device="cpu").manual_seed(4)

    def timed(fn):
        def run():
            fn()
            join(torch, devices)
        return run

    def record(name, got, want, fn, plain, iters, nbytes, flops,
               library=None, **extra):
        sync_all(torch, devices)
        same = [torch.equal(bits(torch, a) if a.is_floating_point()
                            else a.cpu(), bits(torch, b)
                            if b.is_floating_point() else b.cpu())
                for a, b in zip(got, want)]
        if not all(same):
            raise SystemExit(f"{name}: kernel != plain version on the CPU")
        err = max(float((a.cpu().double() - b.cpu().double()).abs().max())
                  for a, b in zip(got, want))
        per_call = launch_delta(tk, fn)
        sync_all(torch, devices)
        # the wall time of a call, the host's per-shard work included
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync_all(torch, devices)
        call_ms = 1e3 * (time.perf_counter() - t0) / iters
        b_ms, by = bound_ms(nbytes, flops)
        out[name] = dict(max_abs_err=err, ms=cuda_ms(timed(fn), iters),
                         plain_ms=cuda_ms(timed(plain), max(iters // 10, 3)),
                         library_ms=None if library is None
                         else cuda_ms(library, iters),
                         bound_ms=b_ms, bound_by=by,
                         call_ms=call_ms, launches_per_call=per_call,
                         **extra)

    # rows: the word2vec table of a 10k vocab on four shards, its lead
    # padded as MatrixTable pads it (10,001 -> 10,004 rows)
    lead = -(-ROWS // SHARDS) * SHARDS
    rps = lead // SHARDS
    param = (torch.randn(lead, DIM, generator=g) * 0.05).numpy()
    n = BATCH * (1 + NEGATIVE)
    ids = zipf_ids(rng, n, ROWS)
    uniq = len(np.unique(ids))
    order = np.argsort(ids // rps, kind="stable")
    (local,), _, counts, sh, pos = lane_slices(ids[order], rps, [], [])
    inv = np.zeros(n, np.int32)
    inv[order] = sh * local.shape[1] + pos
    shards = on_shards(torch, param, devices)
    lo = torch.as_tensor(local, device=devices[0])
    iv = torch.as_tensor(inv, device=devices[0])
    # the library calls and the flat kernels take the table concatenated
    # and the global ids
    whole = torch.as_tensor(param, device=devices[0])
    gids = torch.as_tensor(ids, device=devices[0])
    fn = lambda: tk.gather_rows_sharded(shards, lo, iv, counts=counts)
    flat_fn = lambda: tk.gather_rows(whole, gids)
    record("row_gather_sharded", [fn()], [tk.gather_rows_sharded_plain(
        on_shards(torch, param, cpus), torch.as_tensor(local),
        torch.as_tensor(inv))], fn,
        lambda: tk.gather_rows_sharded_plain(shards, lo, iv), 50,
        n * 8 + uniq * DIM * 4 + n * DIM * 4, 0,
        library=lambda: whole.index_select(0, gids), n=n,
        lanes=local.shape[1])
    # timed after the check: a timing loop calls the form again
    out["row_gather_sharded"].update(
        flat_ms=cuda_ms(flat_fn, 200), host_ms=host_ms(fn, 200),
        flat_host_ms=host_ms(flat_fn, 200))

    sids = np.sort(ids)
    deltas = torch.randn(n, DIM, generator=g).numpy()
    (local, sd), valid, counts, _, _ = lane_slices(sids, rps, [deltas], [0])
    host = on_shards(torch, param, cpus)
    tk.row_scatter_add_sharded_plain(host, *(torch.as_tensor(x)
                                             for x in (local, sd, valid)))
    shards = on_shards(torch, param, devices)
    ops = [torch.as_tensor(x, device=devices[0]) for x in (local, sd, valid)]
    tk.row_scatter_add_sharded(shards, *ops, counts=counts)
    fn = lambda: tk.row_scatter_add_sharded(shards, *ops, counts=counts)
    sd_all = torch.as_tensor(deltas, device=devices[0])
    sids_all = torch.as_tensor(sids, device=devices[0])
    ok_all = torch.ones(n, dtype=torch.bool, device=devices[0])
    flat_t = whole.clone()
    # the same real lanes through the flat masked kernel, global ids
    flat_fn = lambda: tk.row_scatter_add_masked(flat_t, sids_all, sd_all,
                                                ok_all)
    record("row_scatter_add_sharded", shards, host, fn,
           lambda: tk.row_scatter_add_sharded_plain(shards, *ops), 50,
           n * 9 + n * DIM * 4 + 2 * uniq * DIM * 4, n * DIM,
           library=lambda: whole.index_add_(0, sids_all, sd_all), n=n,
           lanes=local.shape[1],
           longest_run_per_shard=longest_runs(sids, rps))
    out["row_scatter_add_sharded"].update(
        flat_ms=cuda_ms(flat_fn, 50), host_ms=host_ms(fn, 50),
        flat_host_ms=host_ms(flat_fn, 50))
    del flat_t
    del whole

    # COO: a LightLDA call's 512,000 (word, topic, 1) lanes into the
    # [50,000 + pad, 1024] int32 word table on four shards (50,004 rows)
    lead = -(-(LDA_V + 1) // SHARDS) * SHARDS
    rps = lead // SHARDS
    tw, _ = zipf_lda_corpus(LDA_V, 1, LDA_B, seed=5)
    cols = rng.integers(0, LDA_K, LDA_B).astype(np.int32)
    vals = (rng.random(LDA_B) < 0.97).astype(np.int32)
    order = np.argsort(tw, kind="stable")
    (lr, sc, sv), valid, counts, _, _ = lane_slices(
        tw[order], rps, [cols[order], vals[order]], [np.int32(0), 0])
    table0 = np.zeros((lead, LDA_K // 128, 128), np.int32)
    host = on_shards(torch, table0, cpus)
    tk.coo_scatter_add_sharded_plain(host, *(torch.as_tensor(x)
                                             for x in (lr, sc, sv, valid)))
    shards = on_shards(torch, table0, devices)
    ops = [torch.as_tensor(x, device=devices[0]) for x in (lr, sc, sv, valid)]
    tk.coo_scatter_add_sharded(shards, *ops, counts=counts)
    touched = len(np.unique(tw.astype(np.int64) * LDA_K + cols))
    whole = torch.as_tensor(table0, device=devices[0]).view(-1)
    idx = torch.as_tensor(tw.astype(np.int64) * LDA_K + cols,
                          device=devices[0])
    v_all = torch.as_tensor(vals, device=devices[0])
    fn = lambda: tk.coo_scatter_add_sharded(shards, *ops, counts=counts)
    record("coo_scatter_add_sharded", shards, host, fn,
           lambda: tk.coo_scatter_add_sharded_plain(shards, *ops), 20,
           LDA_B * 13 + touched * 8, LDA_B,
           library=lambda: whole.index_put_((idx,), v_all, accumulate=True),
           n=LDA_B, lanes=lr.shape[1], touched=touched)
    out["coo_scatter_add_sharded"].update(
        index_put_ms=out["coo_scatter_add_sharded"]["library_ms"],
        index_add_ms=cuda_ms(lambda: whole.index_add_(0, idx, v_all), 20),
        sector_bound_ms=sector_bound_ms(LDA_B * 13, idx))
    int32_library(out["coo_scatter_add_sharded"])
    out["coo_scatter_add_sharded"]["split"] = coo_sharded_split(
        torch, tk, devices, rps, tw[order], cols[order], vals[order], lr,
        sc, sv, valid, counts, table0, host, fn)
    del shards, host, ops, whole

    # the same lanes into float32 shards (SparseMatrixTable's default
    # dtype: add_sparse's path), each element's lanes folded in lane order
    g32 = torch.Generator(device="cpu").manual_seed(11)
    f_all = torch.randn(LDA_B, generator=g32).numpy()
    (lr, sc, sf), valid, counts, _, _ = lane_slices(
        tw[order], rps, [cols[order], f_all[order]],
        [np.int32(0), np.float32(0)])
    table_f = np.zeros((lead, LDA_K // 128, 128), np.float32)
    host = on_shards(torch, table_f, cpus)
    tk.coo_scatter_add_sharded_plain(host, *(torch.as_tensor(x)
                                             for x in (lr, sc, sf, valid)))
    shards = on_shards(torch, table_f, devices)
    ops = [torch.as_tensor(x, device=devices[0]) for x in (lr, sc, sf, valid)]
    tk.coo_scatter_add_sharded(shards, *ops, counts=counts)
    whole = torch.as_tensor(table_f, device=devices[0]).view(-1)
    gidx = torch.as_tensor(tw[order].astype(np.int64) * LDA_K + cols[order],
                           device=devices[0])
    f_sorted = torch.as_tensor(f_all[order], device=devices[0])
    fn = lambda: tk.coo_scatter_add_sharded(shards, *ops, counts=counts)
    record("coo_scatter_add_sharded_f32", shards, host, fn,
           lambda: tk.coo_scatter_add_sharded_plain(shards, *ops), 20,
           LDA_B * 13 + touched * 8, LDA_B,
           library=lambda: whole.index_put_((gidx,), f_sorted,
                                            accumulate=True),
           n=LDA_B, lanes=lr.shape[1], touched=touched)
    row = out.pop("coo_scatter_add_sharded_f32")
    row.update(index_put_ms=row["library_ms"],
               index_add_ms=cuda_ms(lambda: whole.index_add_(
                   0, gidx, f_sorted), 20),
               sector_bound_ms=sector_bound_ms(LDA_B * 13, gidx))
    out["coo_scatter_add_sharded"]["f32"] = row
    del shards, host, ops, table0, table_f, whole

    # KV at the sparse-LR step's shapes: a 2^25-slot ftrl table at
    # value_dim 2 on four shards of 524,288 buckets, filled with half of
    # 159,000 keys; the batch matches that half and claims the other
    mesh = core.Mesh([devices])
    t = KVTable(SLR_CAPACITY, value_dim=2, slots_per_bucket=SLR_SLOTS,
                updater="ftrl", mesh=mesh, name="smoke_kv_sharded")
    keys = kv_keys(rng, KV_REAL)
    present = keys[:KV_REAL // 2]
    t.add(present, rng.standard_normal((len(present), 2)).astype(np.float32))
    t.wait()
    nk = len(keys)
    gb = t._buckets_of(keys)
    bps = t._buckets_per_shard
    q, lb, iv = t._get_lanes(keys, gb)
    lanes = int(to_host(torch, lb).shape[1])
    hk = [k.cpu() for k in t.key_shards]
    hv = [v.cpu() for v in t.value_shards]
    fn = lambda: tk.kv_lookup_sharded(t.key_shards, t.value_shards, q, lb,
                                      iv, 0.0)
    got = fn()
    want = tk.kv_lookup_sharded_plain(hk, hv, to_host(torch, q),
                                      to_host(torch, lb), iv.cpu(), 0.0)
    if int(want[1][:nk].sum()) != len(present):
        raise SystemExit("kv_lookup_sharded: found != the keys added")
    # every lane of inv (its pow2 padding too) is the function's work: per
    # caller lane inv, picked (D = 2) and found; per lane slice it names
    # (the padding names lane 0) its query and bucket; per bucket it names,
    # the 16 slots' keys and values
    inv_h = iv.cpu().numpy()
    named = inv_h // lanes * bps + to_host(torch, lb).numpy().reshape(-1)[
        inv_h]
    touched = len(np.unique(named))
    n_inv, distinct = len(inv_h), len(np.unique(inv_h))
    record("kv_lookup_sharded", list(got), list(want), fn,
           lambda: tk.kv_lookup_sharded_plain(t.key_shards, t.value_shards,
                                              q, lb, iv, 0.0), 50,
           kv_lookup_bytes(n_inv, distinct, touched, 2, inv=True), 0,
           n=n_inv, lanes=lanes, keys=nk, distinct=distinct, real_per_shard=np.bincount(
               gb // bps, minlength=SHARDS).tolist(), found=len(present),
           touched=touched)
    out["kv_lookup_sharded"].update(host_ms=host_ms(fn, 50))

    prep = t.prepare_add(keys, rng.standard_normal((nk, 2)).astype(
        np.float32))
    ops = (prep.buckets, prep.query, prep.deltas, prep.valid)
    host_ops = [to_host(torch, x) for x in ops]
    hs = [{k: v.cpu() for k, v in st.items()} for st in t.state_shards]
    want = tk.kv_probe_update_sharded_plain(hk, hv, hs, *host_ops,
                                            prep.option, "ftrl")
    clone = lambda: ([k.clone() for k in t.key_shards],
                     [v.clone() for v in t.value_shards],
                     [{k: v.clone() for k, v in st.items()}
                      for st in t.state_shards])
    timed_t, plain_t = clone(), clone()
    got = tk.kv_probe_update_sharded(t.key_shards, t.value_shards,
                                     t.state_shards, *ops, prep.option,
                                     "ftrl", counts=prep.counts)
    if int(got[3]) != 0 or int(want[3]) != 0:
        raise SystemExit(f"kv_probe_update_sharded: overflowed "
                         f"({int(got[3])}, plain {int(want[3])})")
    flat = lambda r: ([*r[0], *r[1]] + [st[k] for st in r[2]
                                        for k in sorted(st)])
    fn = lambda: tk.kv_probe_update_sharded(*timed_t, *ops, prep.option,
                                            "ftrl", counts=prep.counts)
    cols, ns = 2, 2
    record("kv_probe_update_sharded", flat(got[:3]), flat(want[:3]), fn,
           lambda: tk.kv_probe_update_sharded_plain(*plain_t, *ops,
                                                    prep.option, "ftrl"), 20,
           kv_probe_bytes(nk, touched, cols, ns, shards=SHARDS),
           nk * cols * KV_UPDATER_OPS["ftrl"], n=nk, lanes=lanes,
           claimed=nk - len(present),
           real_per_shard=[int(c) for c in prep.counts],
           sector_bound_ms=kv_sector_bound_ms(nk, touched, cols, ns))
    out["kv_probe_update_sharded"].update(host_ms=host_ms(fn, 20))
    over = kv_sharded_overflow_check(torch, tk, t, rng)
    del t, timed_t, plain_t, got, want, hk, hv, hs
    free_tables(torch)
    for name, r in out.items():
        lib = r["library_ms"]
        log(f"  {name:26s} n={r['n']:7d} (L {r['lanes']} x {SHARDS} "
            f"shards) kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms"
            f"  library {'none' if lib is None else f'{lib:.4f} ms'}  "
            f"bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})  {r['ms'] / r['bound_ms']:.1f}x bound; "
            f"a call's wall time {r['call_ms']:.4f} ms; "
            f"bit-identical to the CPU plain version; launches per call "
            f"{r['launches_per_call']}")
        if "index_put_ms" in r:
            log(f"    on the table concatenated: index_put_ "
                f"{r['index_put_ms']:.4f} ms, index_add_ "
                f"{r['index_add_ms']:.4f} ms; sector bound "
                f"{r['sector_bound_ms']:.4f} ms")
        if name == "kv_lookup_sharded":
            log(f"    every lane of inv ({r['keys']} keys, {r['distinct']} "
                f"lanes named, real lanes per shard {r['real_per_shard']}, "
                f"{r['touched']} buckets named); host time to queue a call "
                f"{r['host_ms']:.4f} ms")
        if "sector_bound_ms" in r and "index_put_ms" not in r:
            log(f"    sector bound {r['sector_bound_ms']:.4f} ms; real lanes "
                f"per shard {r['real_per_shard']}; host time to queue a "
                f"call {r['host_ms']:.4f} ms")
        if "flat_ms" in r:
            log(f"    the flat kernel on the table concatenated "
                f"{r['flat_ms']:.4f} ms; host time to queue a call "
                f"{r['host_ms']:.4f} ms (flat {r['flat_host_ms']:.4f} ms)"
                + (f"; longest run per shard {r['longest_run_per_shard']}"
                   if "longest_run_per_shard" in r else ""))
    log(f"  kv_probe_update_sharded overflow batch: {over} lanes, one "
        "bucket of shard 0 overflowing; n_over global and equal to the "
        "plain version's, all four shards bit-identical after it")
    return out


def same_bucket_keys(table, bucket: int, count: int, start: int = 1):
    """``count`` keys that hash to ``bucket`` (scanned in chunks)."""
    found = []
    while len(found) < count:
        cand = np.arange(start, start + (1 << 22), dtype=np.uint64)
        found.extend(cand[table._buckets_of(cand) == bucket].tolist())
        start += 1 << 22
    return np.asarray(found[:count], np.uint64)


def kv_sharded_overflow_check(torch, tk, t, rng) -> int:
    """One batch with a bucket of shard 0 overflowing and fitting keys on
    every other shard: the kernels' global n_over equals the plain
    version's and no shard changes."""
    bucket = t._buckets_per_shard // 4          # in shard 0
    row = t.key_shards[0][bucket].cpu()
    m = int((row == -1).all(-1).sum()) + 3
    keys = np.concatenate([same_bucket_keys(t, bucket, m, 1 << 40),
                           kv_keys(rng, 64)])
    keys = np.unique(keys)
    prep = t.prepare_add(keys, rng.standard_normal((len(keys), 2)).astype(
        np.float32))
    if not all(prep.counts):
        raise SystemExit("kv overflow batch: a shard has no lanes")
    ops = (prep.buckets, prep.query, prep.deltas, prep.valid)
    before = t.global_arrays()
    hs = [{k: v.cpu() for k, v in st.items()} for st in t.state_shards]
    want = tk.kv_probe_update_sharded_plain(
        [k.cpu() for k in t.key_shards], [v.cpu() for v in t.value_shards],
        hs, *(to_host(torch, x) for x in ops), prep.option, t.updater)
    got = tk.kv_probe_update_sharded(t.key_shards, t.value_shards,
                                     t.state_shards, *ops, prep.option,
                                     t.updater, counts=prep.counts)
    if int(got[3]) != int(want[3]) or int(got[3]) != 3:
        raise SystemExit(f"kv sharded overflow batch: n_over "
                         f"{int(got[3])}, plain {int(want[3])}, expected 3")
    if not same_triple(torch, t.global_arrays(), before):
        raise SystemExit("kv sharded overflow batch: a shard changed")
    return len(keys)


def phase_sharded_tables(torch, tk, mesh, MatrixTable, SparseMatrixTable,
                         KVTable, AddOption, rng) -> None:
    """Phase 11: tables split over the mesh against the same tables
    unsharded on the mesh's first device, bit for bit in the logical
    region."""
    one = dict(device=mesh.devices[0, 0])
    cards = len(set(mesh.shard_devices))
    # a row Get or a stateless Add on the split table: one launch per card
    # (a COO Add's first launch also counts under the masked name)
    per_call = {"get": {"row_gather_sharded": cards},
                "add": {"row_scatter_add_sharded": cards,
                        "row_scatter_add_masked": cards},
                "add_sparse": {"coo_scatter_add_sharded": cards,
                               "coo_scatter_add_masked": 1}}
    for updater in ("default", "sgd", "adagrad"):
        opt = AddOption(learning_rate=0.05, lam=1e-6)
        init = (rng.standard_normal((ROWS - 1, DIM)) * 0.05).astype(
            np.float32)
        a, b = (MatrixTable(ROWS - 1, DIM, init_value=init, updater=updater,
                            default_option=opt, name=f"sh_m_{updater}", **kw)
                for kw in (dict(mesh=mesh), one))
        for _ in range(2):
            ids = zipf_ids(rng, BATCH * (1 + NEGATIVE), ROWS)
            if updater == "adagrad":
                ids = np.unique(ids)
            d = rng.standard_normal((len(ids), DIM)).astype(np.float32)
            grown = launch_delta(tk, lambda: a.add_rows(ids, d))
            if updater != "adagrad" and grown != per_call["add"]:
                raise SystemExit(f"sharded add_rows launched {grown}, "
                                 f"expected {per_call['add']}")
            b.add_rows(ids, d)
        q = zipf_ids(rng, 4096, ROWS)
        got = {}
        grown = launch_delta(tk, lambda: got.update(rows=a.get_rows(q)))
        if grown != per_call["get"]:
            raise SystemExit(f"sharded get_rows launched {grown}, expected "
                             f"{per_call['get']}")
        if not (np.array_equal(a.get().view(np.int32),
                               b.get().view(np.int32))
                and np.array_equal(got["rows"].view(np.int32),
                                   b.get_rows(q).view(np.int32))):
            raise SystemExit(f"sharded MatrixTable {updater} != unsharded")
        log(f"  MatrixTable {ROWS - 1} x {DIM} {updater:8s} on "
            f"{len(a.shards)} shards ({a._rows_per_shard} rows each): "
            "2 add_rows of 24,576 Zipf ids + get_rows bit-identical to "
            f"the unsharded table; one launch per card a call ({cards})")
    for tiled in (False, True):
        a, b = (SparseMatrixTable(LDA_V, LDA_K, "int32", tiled=tiled,
                                  name=f"sh_s_{tiled}", **kw)
                for kw in (dict(mesh=mesh), one))
        for seed in (6, 7):
            tw, _ = zipf_lda_corpus(LDA_V, 1, LDA_B, seed=seed)
            c = rng.integers(0, LDA_K, LDA_B)
            v = rng.integers(-1, 2, LDA_B)
            grown = launch_delta(tk, lambda: a.add_sparse(tw, c, v))
            if grown != per_call["add_sparse"]:
                raise SystemExit(f"sharded add_sparse launched {grown}, "
                                 f"expected {per_call['add_sparse']}")
            b.add_sparse(tw, c, v)
        q = zipf_ids(rng, 2000, LDA_V + 1)
        if not (np.array_equal(a.get(), b.get())
                and all(np.array_equal(x, y) for x, y in
                        zip(a.get_rows_sparse(q), b.get_rows_sparse(q)))):
            raise SystemExit(f"sharded SparseMatrixTable tiled={tiled} != "
                             "unsharded")
        log(f"  SparseMatrixTable {LDA_V} x {LDA_K} int32 tiled={tiled!s:5s}"
            f" on {len(a.shards)} shards: 2 add_sparse of {LDA_B} lanes + "
            "get_rows_sparse bit-identical to the unsharded table; one "
            f"launch per card an add ({cards})")
        del a, b
    free_tables(torch)
    a, b = (KVTable(SLR_CAPACITY, value_dim=2, slots_per_bucket=SLR_SLOTS,
                    updater="ftrl", name="sh_kv", **kw)
            for kw in (dict(mesh=mesh), one))
    keys = kv_keys(rng, 2 * KV_REAL)
    for batch in (keys[:KV_REAL], keys[KV_REAL // 2:3 * KV_REAL // 2]):
        d = rng.standard_normal((len(batch), 2)).astype(np.float32)
        a.add(batch, d)
        b.add(batch, d)
    a.wait()
    b.wait()
    # a batch that overflows one bucket of shard 0, with fitting keys on
    # every shard: the raise comes at wait(), and no shard changed
    bucket = 7
    fill = int((b.keys[bucket] != -1).any(-1).sum())
    over = np.unique(np.concatenate([
        same_bucket_keys(b, bucket, SLR_SLOTS - fill + 1, 1 << 41),
        kv_keys(rng, 1000)]))
    before = a.global_arrays()
    errs = []
    for t in (a, b):
        t.add(over, np.ones((len(over), 2), np.float32))
        try:
            t.wait()
            errs.append(None)
        except RuntimeError as e:
            errs.append(str(e).replace(t.name, "kv"))
    if errs[0] is None or errs[0] != errs[1] or str(bucket) not in errs[0]:
        raise SystemExit(f"sharded KVTable overflow verdicts: {errs}")
    if not (same_triple(torch, a.global_arrays(), before)
            and same_triple(torch, a.global_arrays(), b.global_arrays())):
        raise SystemExit("sharded KVTable != unsharded (or the overflow "
                         "changed a shard)")
    qk = keys[::7]
    if not all(np.array_equal(x, y) for x, y in zip(a.get(qk), b.get(qk))) \
            or len(a) != len(b):
        raise SystemExit("sharded KVTable get/len != unsharded")
    log(f"  KVTable 2^25 slots ftrl D=2 on {len(a.key_shards)} shards of "
        f"{a._buckets_per_shard} buckets: 2 adds of {KV_REAL} keys "
        f"(re-adds included), a batch overflowing one bucket of shard 0 "
        f"(raises at wait(), no shard changed), gets and len() ({len(a)} "
        "keys) bit-identical to the unsharded table")
    del a, b, before
    free_tables(torch)


def phase_sharded_sparse_lr(torch, tk, counts, mesh, devices,
                            SparseLogisticRegression, SparseLRConfig,
                            lr_step, data, profile: bool) -> tuple:
    """Phase 12: sparse LR at the Criteo-like width on the (1, 4) mesh,
    from phase 10's data; its final table must equal phase 10's bit for
    bit. Returns the measured numbers and the path's launch counts."""
    rows, y = data["rows"], data["y"]
    cfg = SparseLRConfig(capacity=SLR_CAPACITY, slots_per_bucket=SLR_SLOTS,
                         max_features=64, minibatch_size=SLR_BATCH,
                         updater="ftrl", learning_rate=0.1,
                         epochs=SLR_EPOCHS)
    free_tables(torch)
    for dev in set(devices):
        torch.cuda.reset_peak_memory_stats(dev)
    app = SparseLogisticRegression(cfg, mesh=mesh, name="smoke_slr_mesh")
    start = counts()
    app.train(rows, y)
    grown = {k: v - start[k] for k, v in counts().items()}
    steps = sum(e["steps"] for e in app.epoch_stats)
    # the lookup, the probe and the commit once per card
    cards = len(set(devices))
    want = {"kv_lookup": cards * steps, "kv_probe_update": cards * steps,
            "kv_commit": cards * steps, "kv_lookup_sharded": steps,
            "kv_probe_update_sharded": steps}
    for name, n in want.items():
        if grown[name] != n:
            raise SystemExit(f"sharded sparse LR: {name} launched "
                             f"{grown[name]} times in {steps} steps, "
                             f"expected {n}")
    losses = [e["loss"] for e in app.epoch_stats]
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise SystemExit(f"sharded sparse LR: epoch losses {losses}")
    tbl = app.table
    got = tbl.global_arrays()
    if not same_triple(torch, got, data["triple"]):
        raise SystemExit("sharded sparse LR: the final keys, values and "
                         "state differ from phase 10's unsharded run")
    del got
    if losses != data["losses"]:
        raise SystemExit(f"sharded sparse LR: losses {losses} != phase "
                         f"10's {data['losses']}")
    t0 = time.perf_counter()
    acc = app.accuracy(rows, y)
    acc_s = time.perf_counter() - t0
    if acc != data["accuracy"]:
        raise SystemExit(f"sharded sparse LR: train accuracy {acc} != "
                         f"phase 10's {data['accuracy']}")
    path_counts = counts()
    live = len(tbl)
    peak = {dev: torch.cuda.max_memory_allocated(dev) / 1e9
            for dev in sorted(set(devices))}
    rates = [e["samples"] / e["seconds"] for e in app.epoch_stats]
    step_ms = [1e3 * e["seconds"] / e["steps"] for e in app.epoch_stats]

    split = slr_step_split(torch, tk, app, rows, y, lr_step, devices,
                           step_ms[-1])
    out = dict(mesh=[str(d) for d in devices], samples=SLR_N,
               epochs=SLR_EPOCHS, steps=steps, samples_per_sec=rates,
               step_ms=step_ms, epoch_loss=losses, train_accuracy=acc,
               accuracy_s=acc_s, live_keys=live, peak_mem_gb=peak,
               launches_per_step={k: grown[k] / steps for k in want},
               **split)
    log(f"  mesh {[str(d) for d in devices]}: {tbl._buckets_per_shard} "
        f"buckets a shard; a step's {split['unique_keys_step']} unique keys "
        f"split {split['real_lanes_per_shard']} real lanes of L "
        f"{split['lanes_per_shard']}")
    log(f"  epochs: samples/s {[round(r) for r in rates]}, ms/step "
        f"{[round(m, 1) for m in step_ms]}, mean loss "
        f"{[round(x, 5) for x in losses]}; train accuracy {acc:.4f}; "
        f"{live} live keys; peak device memory "
        f"{ {k: round(v, 2) for k, v in peak.items()} } GB")
    log(f"  final keys, values and state bit-identical to phase 10's "
        f"unsharded table; launches per step {out['launches_per_step']}")
    if profile:
        mbs = [(rows[s:s + SLR_BATCH], y[s:s + SLR_BATCH])
               for s in range(0, 4 * SLR_BATCH, SLR_BATCH)]
        out["profile"] = profile_call(
            torch, "slr_mesh_steps_trace.json",
            lambda: [app.train_batch(r, yy) for r, yy in mbs],
            4 * step_ms[-1])
    del app
    free_tables(torch)
    return out, path_counts


#: phase 17's data-axis meshes (every replica on cuda:0: a replica on
#: another card is a path this script does not claim)
KV_DATA_MESHES = ((4, 1), (2, 2))
KV_DATA_UPDATERS = ("ftrl", "adagrad")


def kv_replicas_identical(torch, t) -> bool:
    """Every replica's keys and values (and, off shard_update, its state)
    hold replica 0's bits."""
    for r in range(1, t.n_replicas):
        for s in range(len(t.devices)):
            pairs = [(t.replica_keys[r][s], t.key_shards[s]),
                     (t.replica_values[r][s], t.value_shards[s])]
            if not t.shard_update:
                pairs += [(t.replica_states[r][s][k], v)
                          for k, v in t.state_shards[s].items()]
            if not all(torch.equal(a, b) for a, b in pairs):
                return False
    return True


def kv_blocks_hold_their_buckets(torch, t, one) -> bool:
    """Each replica's state (its block under shard_update, else the whole
    shard) equals the one-device table's rows of the same buckets, bit
    for bit (the same bucket count: 2^21 divides by S * D here)."""
    bps = t.num_buckets // len(t.devices)
    q = bps // t.n_replicas if t.shard_update else bps
    for r in range(t.n_replicas):
        lo0 = r * q if t.shard_update else 0
        for s in range(len(t.devices)):
            lo = s * bps + lo0
            for k, leaf in t.replica_states[r][s].items():
                if leaf.shape[0] != q or not torch.equal(
                        leaf, one.state[k][lo:lo + q]):
                    return False
    return True


def kv_replay(torch, tk, core, KVTable, AddOption, adds) -> dict:
    """Phase 17's replay of phase 10's ``adds`` (see
    :func:`phase_kv_data_axis`); returns its host prep numbers. Its
    tables die with its frame, before the sparse-LR run's peak memory is
    taken."""
    options = {"ftrl": AddOption.for_ftrl(0.1), "adagrad": AddOption(
        learning_rate=0.1)}
    make = lambda upd, name, **kw: KVTable(
        SLR_CAPACITY, value_dim=2, slots_per_bucket=SLR_SLOTS, updater=upd,
        default_option=dataclasses.replace(options[upd]), name=name, **kw)
    ones = {u: make(u, f"kv_one_{u}", device="cuda:0")
            for u in KV_DATA_UPDATERS}
    tabs = {}
    for (dp, mp) in KV_DATA_MESHES:
        mesh = core._build_mesh(["cuda:0"] * (dp * mp), dp, mp)
        for flag in (False, True):
            for u in KV_DATA_UPDATERS:
                tabs[(dp, mp, flag, u)] = make(
                    u, f"kv_{dp}x{mp}_{flag}_{u}", mesh=mesh,
                    shard_update=flag)
    for t in tabs.values():
        if t.num_buckets != ones["ftrl"].num_buckets:
            raise SystemExit(f"{t.name}: {t.num_buckets} buckets, the "
                             "(1, 1) table has "
                             f"{ones['ftrl'].num_buckets}")
    by_shards = {}                 # the tables that share a lane layout
    for key, t in tabs.items():
        by_shards.setdefault(len(t.devices), t)
    by_shards[1] = ones["ftrl"]
    missing = kv_keys(np.random.default_rng(17), 1000) | np.uint64(1 << 62)
    add_s = get_s = 0.0
    for i, (keys, deltas) in enumerate(adds):
        t0 = time.perf_counter()
        preps = {S: t.prepare_add(keys, deltas)
                 for S, t in by_shards.items()}
        add_s += time.perf_counter() - t0
        for u in KV_DATA_UPDATERS:
            opt = dataclasses.replace(options[u], step=i)
            ones[u].add_prepared(dataclasses.replace(preps[1], option=opt))
        for key, t in tabs.items():
            opt = dataclasses.replace(options[key[3]], step=i)
            before = dict(tk.LAUNCHES)
            t.add_prepared(dataclasses.replace(preps[len(t.devices)],
                                               option=opt))
            grown = {k: tk.LAUNCHES[k] - before[k]
                     for k in ("kv_probe_update", "kv_commit")}
            if grown != {"kv_probe_update": 1, "kv_commit": 1}:
                raise SystemExit(f"{t.name}: add {i} launched {grown}, "
                                 "expected one probe and one commit")
        q = np.concatenate([keys, missing])
        t0 = time.perf_counter()
        lanes = {S: t._get_lanes(q, t._buckets_of(q))
                 for S, t in by_shards.items()}
        get_s += time.perf_counter() - t0
        # the caller's lanes only: inv's pow2 padding names a lane of the
        # layout, which differs with the shard count
        n = len(q)
        want = {u: [x[:n] for x in tk.kv_lookup_sharded(
            t.key_shards, t.value_shards, *lanes[1], 0.0)]
                for u, t in ones.items()}
        for key, t in tabs.items():
            t.wait()
            got = [x[:n] for x in tk.kv_lookup_sharded(
                t.key_shards, t.value_shards, *lanes[len(t.devices)], 0.0)]
            w = want[key[3]]
            if not (torch.equal(got[0], w[0]) and torch.equal(got[1], w[1])):
                raise SystemExit(f"{t.name}: the Get after add {i} != the "
                                 "(1, 1) table's")
            if not kv_replicas_identical(torch, t):
                raise SystemExit(f"{t.name}: the replicas differ after add "
                                 f"{i}")
    for key, t in tabs.items():
        one = ones[key[3]]
        if not (all(torch.equal(a, b) for a, b in zip(
                t.global_arrays()[:2], one.global_arrays()[:2]))
                and kv_blocks_hold_their_buckets(torch, t, one)):
            raise SystemExit(f"{t.name}: its cells or state blocks differ "
                             "from the (1, 1) table's")
    found = int(ones["ftrl"].get_tensor(adds[-1][0])[1].sum())
    log(f"  {len(adds)} adds of phase 10 replayed on (1, 1) and on "
        f"{', '.join(f'{t.name}' for t in tabs.values())}: every Get of "
        f"an add's keys and of {len(missing)} keys never added equal to the "
        f"(1, 1) table's bit for bit, replicas identical after each add, "
        f"each add one probe and one commit, state blocks holding exactly "
        f"their buckets ({found} keys found of the last add); host prep "
        f"{1e3 * add_s / len(adds):.1f} ms an add for both lane layouts, "
        f"Get lanes {1e3 * get_s / len(adds):.1f} ms")
    return dict(replay_adds=len(adds), replay_prep_ms=1e3 * add_s / len(adds),
                replay_get_lanes_ms=1e3 * get_s / len(adds))


def phase_kv_data_axis(torch, tk, counts, reset, core, KVTable, AddOption,
                       SparseLogisticRegression, SparseLRConfig, lr_step,
                       data, slr) -> dict:
    """Phase 17: KVTable on a data axis at the sparse-LR width. First
    phase 10's adds (the app's own batches, at most its 32) replayed on
    2^25-slot tables (value_dim 2) on (4, 1) and (2, 2) meshes of cuda:0,
    with and without shard_update, under ftrl and adagrad, beside a (1, 1)
    table fed the same: after every add each table's Get of the add's
    keys (and of keys never added) equals the (1, 1) table's bit for bit,
    values and found, the replicas stay bit-identical, and the add is one
    probe and one commit on the card; at the end each state block holds
    exactly its buckets. Then phase 10's SparseLogisticRegression on the
    (4, 1) mesh from phase 10's data: its final table equals phase 10's
    bit for bit, its replicas identical; the host's and the device's ms a
    step beside phase 10's, and the card's peak memory. Returns the
    numbers."""
    replay = kv_replay(torch, tk, core, KVTable, AddOption, data["adds"])
    free_tables(torch)

    rows, y = data["rows"], data["y"]
    cfg = SparseLRConfig(capacity=SLR_CAPACITY, slots_per_bucket=SLR_SLOTS,
                         max_features=64, minibatch_size=SLR_BATCH,
                         updater="ftrl", learning_rate=0.1,
                         epochs=SLR_EPOCHS)
    torch.cuda.reset_peak_memory_stats()
    mesh = core._build_mesh(["cuda:0"] * 4, 4, 1)
    app = SparseLogisticRegression(cfg, mesh=mesh, name="smoke_slr_data")
    reset()
    app.train(rows, y)
    grown = counts()
    steps = sum(e["steps"] for e in app.epoch_stats)
    for name in ("kv_lookup", "kv_probe_update", "kv_commit"):
        if grown[name] != steps:
            raise SystemExit(f"sparse LR (4, 1): {name} launched "
                             f"{grown[name]} times in {steps} steps")
    tbl = app.table
    if not same_triple(torch, tbl.global_arrays(), data["triple"]):
        raise SystemExit("sparse LR (4, 1): the final table differs from "
                         "phase 10's")
    if not kv_replicas_identical(torch, tbl):
        raise SystemExit("sparse LR (4, 1): the replicas differ")
    losses = [e["loss"] for e in app.epoch_stats]
    if losses != data["losses"]:
        raise SystemExit(f"sparse LR (4, 1): losses {losses} != phase 10's "
                         f"{data['losses']}")
    peak = torch.cuda.max_memory_allocated(0) / 1e9
    step_ms = [1e3 * e["seconds"] / e["steps"] for e in app.epoch_stats]
    split = slr_step_split(torch, tk, app, rows, y, lr_step, ["cuda:0"],
                           step_ms[-1])
    out = dict(replay, slr_step_ms=step_ms, slr_epoch_loss=losses,
               slr_peak_mem_gb=peak, slr_launches=grown,
               table_bytes_per_replica=sum(
                   x.numel() * x.element_size() for x in
                   tbl.replica_keys[0] + tbl.replica_values[0]
                   + [v for st in tbl.replica_states[0]
                      for v in st.values()]),
               **{f"slr_{k}": v for k, v in split.items()})
    log(f"  sparse LR on (4, 1): final keys, values and state bit-identical "
        f"to phase 10's, replicas identical; ms a step {step_ms} (phase "
        f"10: {[round(m, 1) for m in slr['step_ms']]}); host "
        f"{split['host_prep_ms']:.1f} ms and device "
        f"{split['device_ms']:.3f} ms a step (phase 10: host "
        f"{slr['host_prep_ms']:.1f} ms, device {slr['device_ms']:.3f} ms); "
        f"cuda:0 peak {peak:.2f} GB for 4 replicas of "
        f"{out['table_bytes_per_replica'] / 1e9:.2f} GB")
    del app, tbl
    free_tables(torch)
    return out


def phase_mesh_kernels(torch, tk, devices, rng) -> dict:
    """Phase 2, the functional forms over a ShardedParam (a superstep body
    over (1, 4) tables) against their plain versions: the row gather and
    scatter-add at word2vec's shapes (w_out's 10,004 x 100 rows as 4 x
    2,501; 4,096 and 24,576 Zipf-1.2 ids in request order), the COO add at
    a LightLDA call's (512,000 lanes into 4 x 12,501 x 1024, tiled, int32
    and float32).
    Exact against the plain versions on the CPU, and the scatters equal
    to the flat kernel on the whole table; the row scatter-add's plan
    held against its plain version and the call's parts timed apart
    (:func:`plan_parts`); returns {name@n: row}."""
    out = {}
    cpus = ["cpu"] * SHARDS
    g = torch.Generator(device="cpu").manual_seed(13)

    def sharded(x, devs):
        return tk.ShardedParam(b.to(d, copy=True)
                               for b, d in zip(x.chunk(SHARDS), devs))

    def host(param):
        return torch.cat([t.cpu() for t in param.shards])

    def timed(fn):
        def run():
            fn()
            join(torch, devices)
        return run

    def record(key, got, want, fn, plain, library, iters, nbytes, flops,
               **extra):
        sync_all(torch, devices)
        if not torch.equal(bits(torch, got), bits(torch, want)):
            raise SystemExit(f"{key}: kernel != plain version on the CPU")
        per_call = launch_delta(tk, fn)
        b_ms, by = bound_ms(nbytes, flops)
        out[key] = dict(
            max_abs_err=float((got.double() - want.double()).abs().max()),
            ms=cuda_ms(timed(fn), iters), plain_ms=cuda_ms(plain, iters),
            library_ms=cuda_ms(library, iters), bound_ms=b_ms, bound_by=by,
            launches_per_call=per_call, **extra)

    lead = -(-ROWS // SHARDS) * SHARDS              # 10,004
    x = torch.randn(lead, DIM, generator=g) * 0.05
    whole = x.to(devices[0])
    for n in (4096, BATCH * (1 + NEGATIVE)):
        ids_h = torch.as_tensor(zipf_ids(rng, n, ROWS))
        ids = ids_h.to(devices[0])
        uniq = int(torch.unique(ids_h).numel())
        param = sharded(x, devices)
        fn = lambda: tk.gather_rows(param, ids)
        flat_fn = lambda: tk.gather_rows(whole, ids)
        # 100 calls: the host queues a call in well under 0.3 ms (H100
        # 80GB HBM3), so they stay inside cuda_ms's spin
        record(f"gather_rows_mesh@{n}", fn().cpu(), x[ids_h.long()], fn,
               lambda: tk.gather_rows_mesh_plain(param, ids),
               lambda: whole.index_select(0, ids), 100,
               n * 4 + uniq * DIM * 4 + n * DIM * 4, 0, n=n,
               unique_rows=uniq, flat_ms=cuda_ms(flat_fn, 200),
               host_ms=host_ms(fn, 200), flat_host_ms=host_ms(flat_fn, 200))

        d_h = torch.randn(n, DIM, generator=g)
        d = d_h.to(devices[0])
        param = sharded(x, devices)
        tk.row_scatter_add(param, ids, d)
        want = host(tk.row_scatter_add(sharded(x, cpus), ids_h, d_h))
        flat = tk.row_scatter_add(whole.clone(), ids, d)
        sync_all(torch, devices)
        if not torch.equal(bits(torch, flat), bits(torch, host(param))):
            raise SystemExit(f"row_scatter_add_mesh n={n}: the sharded "
                             "table != the flat kernel's whole table")
        timed_p, lib_t = sharded(x, devices), whole.clone()
        fn = lambda: tk.row_scatter_add(timed_p, ids, d)
        flat_fn = lambda: tk.row_scatter_add(lib_t, ids, d)
        record(f"row_scatter_add_mesh@{n}", host(param), want, fn,
               lambda: tk.row_scatter_add_mesh_plain(timed_p, ids, d),
               lambda: lib_t.index_add_(0, ids, d), 50,
               n * 4 + n * DIM * 4 + 2 * uniq * DIM * 4, n * DIM, n=n,
               unique_rows=uniq, flat_ms=cuda_ms(flat_fn, 50),
               host_ms=host_ms(fn, 50), flat_host_ms=host_ms(flat_fn, 50),
               longest_run_per_shard=longest_runs(ids_h.numpy(),
                                                  lead // SHARDS))
        # the call's parts: one plan over the global rows, every card's
        # scatter along it
        out[f"row_scatter_add_mesh@{n}"].update(
            plan_parts(torch, tk, timed_p, ids, d, lead, 50))
    del whole, lib_t, timed_p, param, flat

    lead = -(-(LDA_V + 1) // SHARDS) * SHARDS      # 50,004
    tw, _ = zipf_lda_corpus(LDA_V, 1, LDA_B, seed=5)
    r_h = torch.as_tensor(tw.astype(np.int32))
    c_h = torch.as_tensor(rng.integers(0, LDA_K, LDA_B).astype(np.int32))
    v_h = torch.as_tensor((rng.random(LDA_B) < 0.97).astype(np.int32))
    r, c, v = (t.to(devices[0]) for t in (r_h, c_h, v_h))
    table0 = torch.zeros((lead, LDA_K // 128, 128), dtype=torch.int32)
    param = sharded(table0, devices)
    tk.coo_scatter_add(param, r, c, v)
    want = host(tk.coo_scatter_add(sharded(table0, cpus), r_h, c_h, v_h))
    lib_t = table0.to(devices[0]).view(lead, LDA_K)
    idx = r.long() * LDA_K + c.long()
    touched = int(torch.unique(idx).numel())
    timed_p = sharded(table0, devices)
    record(f"coo_scatter_add_mesh@{LDA_B}", host(param), want,
           lambda: tk.coo_scatter_add(timed_p, r, c, v),
           lambda: tk.coo_scatter_add_mesh_plain(timed_p, r, c, v),
           lambda: lib_t.view(-1).index_put_((idx,), v, accumulate=True),
           20, LDA_B * 12 + touched * 8, LDA_B, n=LDA_B, touched=touched,
           index_add_ms=cuda_ms(
               lambda: lib_t.view(-1).index_add_(0, idx, v), 20),
           sector_bound_ms=sector_bound_ms(LDA_B * 12, idx))
    coo_mesh = out[f"coo_scatter_add_mesh@{LDA_B}"]
    coo_mesh["index_put_ms"] = coo_mesh["library_ms"]
    int32_library(coo_mesh)
    # the same lanes into float32 shards: one plan on the lanes' card over
    # the global rows, then a walk a card
    f_h = torch.randn(LDA_B, generator=g)
    f = f_h.to(devices[0])
    table_f = torch.zeros((lead, LDA_K // 128, 128))
    param = sharded(table_f, devices)
    tk.coo_scatter_add(param, r, c, f)
    want = host(tk.coo_scatter_add(sharded(table_f, cpus), r_h, c_h, f_h))
    lib_t = table_f.to(devices[0]).view(lead, LDA_K)
    timed_p = sharded(table_f, devices)
    key = f"coo_scatter_add_mesh_f32@{LDA_B}"
    record(key, host(param), want,
           lambda: tk.coo_scatter_add(timed_p, r, c, f),
           lambda: tk.coo_scatter_add_mesh_plain(timed_p, r, c, f),
           lambda: lib_t.view(-1).index_put_((idx,), f, accumulate=True),
           20, LDA_B * 12 + touched * 8, LDA_B, n=LDA_B, touched=touched,
           index_add_ms=cuda_ms(
               lambda: lib_t.view(-1).index_add_(0, idx, f), 20),
           sector_bound_ms=sector_bound_ms(LDA_B * 12, idx))
    out[key]["index_put_ms"] = out[key]["library_ms"]
    del param, timed_p, lib_t, table0, table_f
    for key, row in out.items():
        log(f"  {key:30s} ({SHARDS} shards) kernel {row['ms']:.4f} ms  "
            f"plain {row['plain_ms']:.4f} ms  library "
            f"{row['library_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']})  {row['ms'] / row['bound_ms']:.1f}x "
            f"bound; bit-identical to the CPU plain version; launches per "
            f"call {row['launches_per_call']}")
        if "sector_bound_ms" in row:
            log(f"    index_put_ {row['index_put_ms']:.4f} ms, index_add_ "
                f"{row['index_add_ms']:.4f} ms; sector bound "
                f"{row['sector_bound_ms']:.4f} ms")
        if "flat_ms" in row:
            log(f"    the flat kernel on the whole table {row['flat_ms']:.4f}"
                f" ms; host time to queue a call {row['host_ms']:.4f} ms "
                f"(flat {row['flat_host_ms']:.4f} ms)"
                + (f"; longest run per shard "
                   f"{row['longest_run_per_shard']}"
                   if "longest_run_per_shard" in row else ""))
        if "plan_ms" in row:
            log(f"    of it the plan {row['plan_ms']:.4f} ms (plain "
                f"{row['plan_plain_ms']:.4f}, torch.sort "
                f"{row['sort_ms']:.4f}, bound {row['plan_bound_ms']:.5f}; "
                f"{row['runs']} runs, {row['long_runs']} long; equal to the "
                f"plain plan), the scatter on the plan "
                f"{row['scatter_ms']:.4f} ms")
    log("  row_scatter_add_mesh: the sharded tables equal the flat "
        "kernel's whole table bit for bit")
    return out


def w2v_mesh_small_parity(torch, core, Corpus, synthetic_text, W2VConfig,
                          WordEmbedding, devices, tmp) -> None:
    """CBOW HS at a small width on the (1, SHARDS) card mesh against the
    same run on a (1, SHARDS) CPU mesh (plain versions): same corpus,
    weights and pairs."""
    path = os.path.join(tmp, "small_mesh.txt")
    synthetic_text(path, num_tokens=40_000, vocab_size=500, seed=3)
    corpus = Corpus.from_file(path, min_count=1, subsample=1e-3)
    cfg = W2VConfig(embedding_dim=DIM, window=WINDOW, model="cbow",
                    objective="hs", batch_size=256, steps_per_call=4,
                    learning_rate=0.025, seed=3)
    apps = [WordEmbedding(corpus, cfg, mesh=core.Mesh([d]))
            for d in (devices, ["cpu"] * SHARDS)]
    it = corpus.cbow_batches(256, window=WINDOW, seed=3,
                             pad_id=apps[0]._scratch)
    batches = [next(it) for _ in range(8)]
    for call in range(2):
        src = np.stack([b[0] for b in batches[4 * call:4 * call + 4]])
        tgt = np.stack([b[1] for b in batches[4 * call:4 * call + 4]])
        losses = [float(a._dispatch(src, tgt, call, 2)) for a in apps]
    sync_all(torch, devices)
    for key in ("w_in", "w_out"):
        a, b = (getattr(x, key).get() for x in apps)
        if not np.allclose(a, b, rtol=1e-5, atol=1e-6):
            raise SystemExit(f"w2v cbow/hs on the (1, {SHARDS}) card mesh: "
                             f"{key} differs from the CPU mesh "
                             f"(max {np.abs(a - b).max()})")
    if not np.isclose(losses[0], losses[1], rtol=1e-5):
        raise SystemExit(f"w2v cbow/hs on the meshes: loss {losses}")
    log(f"  w2v cbow/hs on the (1, {SHARDS}) card mesh vs the CPU mesh: "
        f"w_in, w_out within rtol 1e-5 atol 1e-6; loss {losses[0]:.6f} vs "
        f"{losses[1]:.6f}")


def phase_w2v_mesh(torch, tk, counts, reset, core, W2VConfig, WordEmbedding,
                   SparseMatrixTable, make_superstep, devices, w2v,
                   w2v_run, profile: bool) -> tuple:
    """Phase 13: phase 4's skip-gram NS on the (1, SHARDS) mesh, from
    phase 4's corpus, initial weights (the same seed), pairs and
    negatives (drawn on the first shard's card): its w_in and w_out must
    equal phase 4's bit for bit, the loss must fall, and every gather and
    every scatter-add must launch once per card. Then a
    superstep COO add over a
    (1, SHARDS) SparseMatrixTable at the LightLDA call's width against
    the (1, 1) table. Returns (numbers, {path: launch counts})."""
    mesh = core.Mesh([devices])
    paths = {}
    app = WordEmbedding(w2v_run["corpus"], w2v_run["cfg"], mesh=mesh,
                        name="smoke_w2v_mesh")
    batches = w2v_run["batches"]
    reset()
    warm, warm_s, dt = w2v_calls(torch, app, batches)
    paths["word2vec_mesh"] = counts()
    losses = app.loss_history
    steps = (1 + TIMED_CALLS) * STEPS
    words_per_sec = TIMED_CALLS * STEPS * BATCH / dt \
        / w2v_run["pairs_per_token"]
    log(f"  {len(app.w_in.shards)} shards of {app.w_in._rows_per_shard} "
        f"rows on {devices}; warm-up call {warm_s:.3f} s, loss "
        f"{warm:.5f}; timed calls {dt:.3f} s, losses {losses}")
    if not (np.isfinite(losses).all() and losses[-1] < warm
            < w2v["loss_start"]):
        raise SystemExit(f"w2v on the mesh: loss did not fall: warm-up "
                         f"{warm}, then {losses}")
    for key in ("w_in", "w_out"):
        if getattr(app, key).get().tobytes() != w2v_run[key].tobytes():
            raise SystemExit(f"w2v on the (1, {SHARDS}) mesh: {key} != "
                             "phase 4's (1, 1) run")
    grown = paths["word2vec_mesh"]
    # skip-gram NS: 2 gathers + 2 scatter-adds a step, each launched once
    # per card
    cards = len(set(devices))
    for name, per_call in (("gather_rows_mesh", cards),
                           ("row_scatter_add_mesh", cards),
                           ("row_scatter_plan", 1)):
        if grown[name] != per_call * 2 * steps:
            raise SystemExit(f"{name}: {grown[name]} launches over {steps} "
                             f"steps, expected {per_call * 2 * steps}")
    if grown["row_gather"] or grown["row_scatter_add"]:
        raise SystemExit(f"w2v on the mesh launched the flat kernels: "
                         f"{grown}")
    ratio = words_per_sec / w2v["words_per_sec"]
    log(f"  w_in, w_out bit-identical to phase 4's (1, 1) run; "
        f"{words_per_sec:.0f} words/s against phase 4's "
        f"{w2v['words_per_sec']:.0f} ({ratio:.3f}x); launches per step "
        f"{grown['gather_rows_mesh'] / steps:.0f} "
        f"gather + {grown['row_scatter_add_mesh'] / steps:.0f} scatter "
        f"({cards} per gather and per scatter-add)")
    out = dict(words_per_sec=words_per_sec, seconds=dt, loss_warm=warm,
               losses=losses, words_per_sec_one_shard=w2v["words_per_sec"],
               launches_per_step={k: v / steps for k, v in grown.items()
                                  if v})
    if profile:
        rest = batches[(1 + TIMED_CALLS) * STEPS:]
        out["profile"] = profile_call(
            torch, "w2v_mesh_call_trace.json",
            lambda: app.train(total_steps=STEPS, batches=rest),
            dt / TIMED_CALLS * 1e3)
    del app

    # the COO form through a superstep body over a split SparseMatrixTable
    tables = [SparseMatrixTable(LDA_V, LDA_K, "int32", tiled=True,
                                name=f"ss_coo_{i}", **kw)
              for i, kw in enumerate((dict(mesh=mesh),
                                      dict(device=devices[0])))]

    def body(params, states, locals_, options, rows, cols, vals):
        (p,) = params
        return (tk.coo_scatter_add(p, rows, cols, vals),), states, \
            locals_, None

    steps_ss = [make_superstep([t], body, name=t.name) for t in tables]
    lanes = []
    for seed in (6, 7):
        tw, _ = zipf_lda_corpus(LDA_V, 1, LDA_B, seed=seed)
        lanes.append([torch.as_tensor(a, device=devices[0]) for a in (
            tw.astype(np.int32), np.random.default_rng(seed).integers(
                0, LDA_K, LDA_B).astype(np.int32),
            np.ones(LDA_B, np.int32))])
    reset()
    for args in lanes:
        steps_ss[0]((), *args)
    paths["superstep_coo_mesh"] = counts()
    for args in lanes:
        steps_ss[1]((), *args)
    if not np.array_equal(tables[0].get(), tables[1].get()):
        raise SystemExit("superstep COO on the mesh != the (1, 1) table")
    n_coo = paths["superstep_coo_mesh"]["coo_scatter_add_mesh"]
    if n_coo != cards * len(lanes):
        raise SystemExit(f"coo_scatter_add_mesh: {n_coo} launches in "
                         f"{len(lanes)} calls, expected "
                         f"{cards * len(lanes)} (one per card a call)")
    log(f"  superstep COO add of {LDA_B} lanes x 2 calls into a "
        f"{LDA_V} x {LDA_K} int32 tiled SparseMatrixTable on {SHARDS} "
        f"shards: bit-identical to the (1, 1) table, {n_coo} launches")
    del tables, steps_ss
    free_tables(torch)
    return out, paths


def replicas_identical(torch, table) -> bool:
    """Every replica of ``table`` holds replica 0's bits."""
    return all(same_bits(torch, a, b) for shards in table.replicas[1:]
               for a, b in zip(shards, table.replicas[0]))


def phase_w2v_data_axis(torch, core, counts, reset, W2VConfig,
                        WordEmbedding, w2v, w2v_run) -> tuple:
    """Phase 13b: phase 4's skip-gram NS on a (4, 1) mesh, then a (2, 2)
    mesh, replica d on cuda:{d % cards}, from phase 4's corpus, initial
    weights, pairs and negatives (drawn once on replica 0's card and split
    over the replicas): the replicas must end bit-identical, the tables
    equal phase 4's bit for bit, the loss fall, and each replica launch
    one gather and one scatter-add a table and step on its card. Prints
    words/s beside phase 4's, the host's ms to queue a step, the device's
    busy share over a 64-step call (torch.profiler), the bytes the lane
    exchange moves a step, and where each replica lives. Returns
    ({mesh: numbers}, {path: launch counts})."""
    cards = torch.cuda.device_count()
    batches = w2v_run["batches"]
    steps = (1 + TIMED_CALLS) * STEPS
    out, paths = {}, {}
    for dp, mp in ((4, 1), (2, 2)):
        key = f"({dp}, {mp})"
        rows = [[f"cuda:{d % cards}"] * mp for d in range(dp)]
        devs = sorted({d for row in rows for d in row})
        app = WordEmbedding(w2v_run["corpus"], w2v_run["cfg"],
                            mesh=core.Mesh(rows), name=f"smoke_w2v_dp{dp}")
        reset()
        warm, warm_s, dt = w2v_calls(torch, app, batches)
        sync_all(torch, devs)
        grown = counts()
        paths[f"word2vec_data_{dp}x{mp}"] = grown
        losses = app.loss_history
        log(f"  {key}: replicas on {rows} ({cards} card(s)); warm-up call "
            f"{warm_s:.3f} s, loss {warm:.5f}; timed calls {dt:.3f} s, "
            f"losses {losses}")
        if not (np.isfinite(losses).all() and losses[-1] < warm
                < w2v["loss_start"]):
            raise SystemExit(f"w2v on the {key} mesh: loss did not fall: "
                             f"warm-up {warm}, then {losses}")
        for name in ("w_in", "w_out"):
            table = getattr(app, name)
            if not replicas_identical(torch, table):
                raise SystemExit(f"w2v on the {key} mesh: the replicas of "
                                 f"{name} differ")
            got = table.get()
            if got.tobytes() != w2v_run[name].tobytes():
                raise SystemExit(
                    f"w2v on the {key} mesh: {name} != phase 4's (1, 1) "
                    f"run (max {np.abs(got - w2v_run[name]).max()})")
        gather, scatter = ("row_gather", "row_scatter_add") if mp == 1 \
            else ("gather_rows_mesh", "row_scatter_add_mesh")
        # skip-gram NS: 2 gathers + 2 scatter-adds a step on each replica,
        # one launch each on the replica's one card
        want = {k: 0 for k in ("row_gather", "row_scatter_add",
                               "gather_rows_mesh", "row_scatter_add_mesh")}
        want.update({gather: 2 * dp * steps, scatter: 2 * dp * steps})
        if {k: grown[k] for k in want} != want:
            raise SystemExit(f"w2v on the {key} mesh: launches "
                             f"{ {k: grown[k] for k in want} } over {steps} "
                             f"steps, expected {want}")
        exchange = app._fused.exchange_bytes / STEPS
        words_per_sec = TIMED_CALLS * STEPS * BATCH / dt \
            / w2v_run["pairs_per_token"]

        def call(n_steps):
            part = batches[:n_steps]
            app._dispatch(np.stack([b[0] for b in part]),
                          np.stack([b[1] for b in part]), 0, 10)

        t0 = time.perf_counter()
        call(STEPS)
        queue_s = time.perf_counter() - t0
        sync_all(torch, devs)
        call_s = time.perf_counter() - t0
        short = 64

        def run():
            call(short)
            sync_all(torch, devs)

        run()
        t0 = time.perf_counter()
        run()
        short_ms = (time.perf_counter() - t0) * 1e3
        trace = f"w2v_dp{dp}x{mp}_trace.json"
        prof = profile_call(torch, trace, run, short_ms)
        os.remove(os.path.join(HERE, "chiprun_out", trace))
        busy = prof["device_busy_ms"] / short_ms
        out[key] = dict(
            replicas=rows, cards=cards, words_per_sec=words_per_sec,
            words_per_sec_one_replica=w2v["words_per_sec"], seconds=dt,
            loss_warm=warm, losses=losses,
            host_ms_per_step=1e3 * queue_s / STEPS,
            wall_ms_per_step=1e3 * call_s / STEPS,
            device_busy_share=busy, exchange_bytes_per_step=exchange,
            launches_per_step={k: v / steps for k, v in grown.items() if v},
            profile=prof)
        log(f"  {key}: w_in, w_out bit-identical to phase 4's (1, 1) run, "
            f"replicas bit-identical; {words_per_sec:.0f} words/s against "
            f"phase 4's {w2v['words_per_sec']:.0f} "
            f"({words_per_sec / w2v['words_per_sec']:.3f}x); host queues a "
            f"step in {1e3 * queue_s / STEPS:.3f} ms (wall "
            f"{1e3 * call_s / STEPS:.3f} ms); device busy "
            f"{100 * busy:.1f}% of a {short}-step call; lane exchange "
            f"{exchange:.0f} bytes a step; launches per step "
            f"{grown[gather] / steps:.0f} {gather} + "
            f"{grown[scatter] / steps:.0f} {scatter}")
        del app
        free_tables(torch)
    return out, paths


#: phase 16's meshes and LightLDA modes (every replica on cuda:{d % cards})
LDA_MESHES = ((4, 1), (1, 4), (2, 2))
LDA_MESH_MODES = {"tiled exact": dict(),
                  "doc-blocked": dict(stale_words=True, doc_blocked=True),
                  "doc-blocked streamed": dict(stale_words=True,
                                               doc_blocked=True,
                                               stream_blocks=True),
                  "mh": dict(sampler="mh")}
#: phase 16's timed sweeps a run, after one warm-up (the streamed mode's
#: two keep the script's time)
LDA_MESH_TIMED = 3
LDA_MESH_TIMED_OF = {"doc-blocked streamed": 2}
LDA_MESH_KERNELS = ("row_gather", "gather_rows_mesh", "coo_scatter_add",
                    "coo_scatter_add_mesh", "gibbs_sample_tiled",
                    "gibbs_sample_docblock", "gibbs_sample_docblock_rows",
                    "gibbs_sample_docblock_build")


def lda_mesh_launches(mode: str, dp: int, mp: int, steps: int) -> dict:
    """The launches a sweep of ``mode`` makes on a (dp, mp) mesh of one
    card: each replica samples its lanes of every step and moves every
    lane's word counts on its own copy of the table (one launch a card
    for the mesh forms over a split table)."""
    want = dict.fromkeys(LDA_MESH_KERNELS, 0)
    gather = "row_gather" if mp == 1 else "gather_rows_mesh"
    coo = "coo_scatter_add" if mp == 1 else "coo_scatter_add_mesh"
    if mode == "tiled exact":
        want["gibbs_sample_tiled"] = dp * steps
        want["row_gather"] += dp * steps              # the doc rows
        want[gather] += dp * steps                    # the word rows
        want[coo] = dp * steps
    elif mode == "doc-blocked":
        want["gibbs_sample_docblock"] = dp * steps
        # the mirror's rows read by the kernel, or gathered from its shards
        want["gibbs_sample_docblock_rows" if mp == 1
             else "gather_rows_mesh"] = dp * steps
        want[coo] = dp                                # the rebuild
    elif mode == "doc-blocked streamed":
        want["gibbs_sample_docblock_build"] = dp * steps
        want["gibbs_sample_docblock_rows" if mp == 1
             else "gather_rows_mesh"] = dp * steps
        # each replica adds every replica's lanes of a call (one step a
        # call) to its own word accumulator
        want[coo] = dp * steps
    else:
        want[coo] = 2 * dp * steps                    # remove, add
    return want


def lda_mesh_run(torch, core, counts, reset, LightLDA, LDAConfig, tw, td,
                 mode: str, rows, profile: bool = False) -> tuple:
    """One mode on the mesh of ``rows``: a warm-up sweep and
    ``LDA_MESH_TIMED`` timed ones, the replicas checked identical after
    each; returns (the state to compare, numbers)."""
    cfg = dict(num_topics=LDA_K, batch_tokens=LDA_B, steps_per_call=1,
               seed=1, sampler="tiled")
    cfg.update(LDA_MESH_MODES[mode])
    devs = sorted({d for row in rows for d in row})
    t0 = time.perf_counter()
    app = LightLDA(tw, td, LDA_V, LDAConfig(**cfg), mesh=core.Mesh(rows),
                   name="smoke_lda_mesh")
    sync_all(torch, devs)
    setup_s = time.perf_counter() - t0
    secs, host_s = [], []
    for sweep in range(1 + LDA_MESH_TIMED_OF.get(mode, LDA_MESH_TIMED)):
        reset()
        t0 = time.perf_counter()
        app.sweep()
        host_s.append(time.perf_counter() - t0)
        sync_all(torch, devs)
        secs.append(time.perf_counter() - t0)
        for table in (app.word_topic, app.summary):
            if not replicas_identical(torch, table):
                raise SystemExit(f"LightLDA {mode} on {rows}: the replicas "
                                 f"of {table.name} differ after sweep "
                                 f"{sweep}")
        if not app._docblock and not all(
                same_bits(torch, p, app._z_l.parts[0])
                for p in app._z_l.parts[1:]):
            raise SystemExit(f"LightLDA {mode} on {rows}: the replicas of "
                             f"z differ after sweep {sweep}")
    grown = {k: counts()[k] for k in LDA_MESH_KERNELS}
    steps = app.calls_per_sweep * app.config.steps_per_call
    dp, mp = len(rows), len(rows[0])
    want = lda_mesh_launches(mode, dp, mp, steps)
    if grown != want:
        raise SystemExit(f"LightLDA {mode} on the ({dp}, {mp}) mesh: "
                         f"launches a sweep {grown}, expected {want}")
    state = dict(z=app._z_numpy().copy(), ll=app.loglik(),
                 word_topics=app.word_topics(), doc_topics=app.doc_topics(),
                 summary=app.summary.get())
    profiled = None
    if profile:
        # one more sweep under the profiler, after the state is taken
        trace = f"lda_mesh_{dp}x{mp}_trace.json"
        profiled = profile_call(torch, trace, lambda: (
            app.sweep(), sync_all(torch, devs)), 1e3 * min(secs[1:]))
        os.remove(os.path.join(HERE, "chiprun_out", trace))
        profiled["device_busy_share"] = profiled["device_busy_ms"] \
            / profiled["call_ms"]
    timed = secs[1:]
    rates = [LDA_SMALL_T / t for t in timed]
    numbers = dict(setup_s=setup_s, sweep_s=secs,
                   doc_tokens_per_sec=LDA_SMALL_T * len(timed) / sum(timed),
                   spread_pct=100 * (max(rates) - min(rates)) / max(rates),
                   host_ms_per_step=1e3 * sum(host_s[1:]) / (len(timed)
                                                            * steps),
                   steps=steps, profile=profiled,
                   launches_per_sweep={k: v for k, v in grown.items() if v})
    if app._docblock and mp > 1 and not app.config.stream_blocks:
        # a replica's word rows of a step, gathered from its split bf16
        # mirror (mv_row_gather_mesh), where one shard's kernel reads
        # them itself (words=)
        from multiverso_tpu_torch.ops import table_kernels as tk
        mirror = app._sweep_inputs()[0].parts[0]
        words = app._consts[0]["tw"][:app._nbs // dp].reshape(-1)
        numbers.update(
            gather_rows=words.numel(),
            gather_gb=words.numel() * LDA_K * 2 / 1e9,
            gather_ms=cuda_ms(lambda: tk.gather_rows(mirror, words), 20))
    del app
    free_tables(torch)
    return state, numbers


def phase_lda_mesh(torch, core, counts, reset, LightLDA, LDAConfig,
                   profile: bool) -> tuple:
    """Phase 16: LightLDA tiled exact, doc-blocked (in memory and
    streamed) and mh at the LDA metric's widths (V, K, batch) and phase
    8's depth (T 1M, D 10k) on the (4, 1), (1, 4) and (2, 2) meshes
    (replica d on cuda:{d % cards}), each against the (1, 1) run of the
    same corpus and draws: z, the word and doc counts, the summary and the
    loglik bit for bit after a warm-up and ``LDA_MESH_TIMED`` timed sweeps
    (the streamed mode's ``LDA_MESH_TIMED_OF``), the replicas
    identical after each sweep, and the launches of the last sweep as
    designed. Prints each mesh's
    doc-tokens/s as a ratio of the (1, 1) run's and the host's ms to
    queue a step; with ``profile``, the device's busy share over one more
    sweep of each run (torch.profiler). Returns ({mode: {mesh: numbers}},
    {path: launches})."""
    cards = torch.cuda.device_count()
    tw, td = zipf_lda_corpus(LDA_V, LDA_SMALL_D, LDA_SMALL_T, seed=0)
    out, paths = {}, {}
    for mode in LDA_MESH_MODES:
        ref, one = lda_mesh_run(torch, core, counts, reset, LightLDA,
                                LDAConfig, tw, td, mode, [["cuda:0"]],
                                profile)
        out[mode] = {"(1, 1)": one}
        log(f"  {mode} (1, 1): {one['doc_tokens_per_sec']:.0f} doc-tokens/s "
            f"(timed sweeps {[round(t, 4) for t in one['sweep_s'][1:]]} s, "
            f"spread {one['spread_pct']:.1f}%), host "
            f"{one['host_ms_per_step']:.3f} ms a step; loglik "
            f"{ref['ll']:.6f}")
        for dp, mp in LDA_MESHES:
            key = f"({dp}, {mp})"
            rows = [[f"cuda:{d % cards}"] * mp for d in range(dp)]
            got, r = lda_mesh_run(torch, core, counts, reset, LightLDA,
                                  LDAConfig, tw, td, mode, rows, profile)
            for name, want in ref.items():
                same = got[name] == want if name == "ll" \
                    else np.array_equal(got[name], want)
                if not same:
                    raise SystemExit(f"LightLDA {mode} on the {key} mesh: "
                                     f"{name} != the (1, 1) run's")
            r["vs_one_device"] = r["doc_tokens_per_sec"] \
                / one["doc_tokens_per_sec"]
            r["replicas"] = rows
            out[mode][key] = r
            tag = mode.replace(" ", "_").replace("-", "_")
            paths[f"lightlda_{tag}_{dp}x{mp}"] = r["launches_per_sweep"]
            log(f"  {mode} {key}: z, tables, doc counts, summary, loglik "
                f"bit-identical to (1, 1), replicas identical; "
                f"{r['doc_tokens_per_sec']:.0f} doc-tokens/s "
                f"({r['vs_one_device']:.3f}x, spread "
                f"{r['spread_pct']:.1f}%), host "
                f"{r['host_ms_per_step']:.3f} ms a step; launches a sweep "
                f"{r['launches_per_sweep']}")
            if "gather_ms" in r:
                log(f"    a replica's step gathers {r['gather_rows']} bf16 "
                    f"rows of {LDA_K} ({r['gather_gb']:.3f} GB) from its "
                    f"split mirror in {r['gather_ms']:.4f} ms before the "
                    f"gathered-rows kernel")
    return out, paths


def dense_weights(app) -> np.ndarray:
    return np.concatenate([a.ravel() for a in app.weights()])


def phase_dense_logreg(torch, core, LogisticRegression, LogRegConfig,
                       synthetic_blobs, replica_rows) -> dict:
    """Phase 15: dense logistic regression at MNIST's shape (60,000 x 784,
    10 classes; Gaussian blobs), minibatch 256, 8 steps a call, sgd, lr
    0.1. First the same 2 steps (one 2-step call from the same initial
    weights) on the card, on the CPU and on a (4, 1) mesh: the card
    within the CPU tests' tolerance of the CPU, the (4, 1) replicas
    bit-identical and within it of the one-replica run. Then one warm-up
    and DENSE_TIMED_EPOCHS timed epochs on one replica and on the (4, 1)
    mesh: samples/s, each epoch's loss (it must fall), the train
    accuracy; the (4, 1) replicas bit-identical."""
    t0 = time.perf_counter()
    X, y = synthetic_blobs(DENSE_N, DENSE_DIM, DENSE_CLASSES)
    log(f"  data: {DENSE_N} x {DENSE_DIM} Gaussian blobs, {DENSE_CLASSES} "
        f"classes, made in {time.perf_counter() - t0:.2f} s")
    cfg = LogRegConfig(DENSE_DIM, DENSE_CLASSES, minibatch_size=DENSE_BATCH,
                       steps_per_call=DENSE_SPC, updater="sgd",
                       learning_rate=DENSE_LR)
    meshes = {"(1, 1)": core.Mesh([["cuda:0"]]),
              "(4, 1)": core.Mesh(replica_rows)}

    def close(a, b) -> float:
        if not np.allclose(a, b, rtol=DENSE_RTOL, atol=DENSE_ATOL):
            raise SystemExit(f"dense logreg: weights differ by "
                             f"{np.abs(a - b).max()} (rtol {DENSE_RTOL}, "
                             f"atol {DENSE_ATOL})")
        return float(np.abs(a - b).max())

    def identical(app) -> bool:
        ref = [t.cpu().numpy().tobytes() for t in app.table.replicas[0]]
        return all([t.cpu().numpy().tobytes() for t in r] == ref
                   for r in app.table.replicas[1:])

    two = dataclasses.replace(cfg, steps_per_call=2)
    small = {key: LogisticRegression(two, mesh=mesh, name=f"two_{key}")
             for key, mesh in meshes.items()}
    small["cpu"] = LogisticRegression(two, device="cpu", name="two_cpu")
    for app in small.values():
        app.train_epoch(X[:2 * DENSE_BATCH], y[:2 * DENSE_BATCH],
                        shuffle_seed=0)
    w = {key: dense_weights(app) for key, app in small.items()}
    err_cpu = close(w["(1, 1)"], w["cpu"])
    err_dp = close(w["(4, 1)"], w["(1, 1)"])
    if not identical(small["(4, 1)"]):
        raise SystemExit("dense logreg: the (4, 1) replicas differ after 2 "
                         "steps")
    log(f"  2 steps: the card vs the CPU max |err| {err_cpu:.3g}, (4, 1) vs "
        f"(1, 1) {err_dp:.3g} (rtol {DENSE_RTOL}, atol {DENSE_ATOL}); "
        f"(4, 1) replicas bit-identical")
    del small
    free_tables(torch)
    out = dict(two_steps_max_abs_err_cpu=err_cpu,
               two_steps_max_abs_err_data_axis=err_dp)
    final = {}
    for key, mesh in meshes.items():
        app = LogisticRegression(cfg, mesh=mesh, name=f"dense_{key}")
        losses, seconds = [], []
        for e in range(1 + DENSE_TIMED_EPOCHS):
            t0 = time.perf_counter()
            losses.append(app.train_epoch(X, y, shuffle_seed=cfg.seed + e))
            app.table.wait()
            seconds.append(time.perf_counter() - t0)
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise SystemExit(f"dense logreg {key}: loss did not fall: "
                             f"{losses}")
        if key == "(4, 1)" and not identical(app):
            raise SystemExit("dense logreg (4, 1): the replicas differ")
        acc = app.accuracy(X, y)
        rates = [DENSE_N / s for s in seconds[1:]]
        final[key] = dense_weights(app)
        out[key] = dict(samples_per_sec=rates, losses=losses,
                        seconds=seconds, train_accuracy=acc,
                        steps_per_epoch=-(-DENSE_N // DENSE_BATCH),
                        table_steps=app.table.default_option.step)
        log(f"  {key}: warm-up epoch {seconds[0]:.3f} s; timed epochs "
            f"{[round(r) for r in rates]} samples/s; loss per epoch "
            f"{losses}; train accuracy {acc:.4f}")
        # one 8-step call under the profiler, after the timed epochs
        group = slice(0, DENSE_SPC * DENSE_BATCH)
        xs = X[group].reshape(DENSE_SPC, DENSE_BATCH, DENSE_DIM)
        ys = y[group].reshape(DENSE_SPC, DENSE_BATCH)

        def run():
            app._fused((), *app._place(xs, ys))
            app.table.wait()

        run()
        t0 = time.perf_counter()
        run()
        call_ms = (time.perf_counter() - t0) * 1e3
        trace = f"dense_dp{app.n_replicas}_trace.json"
        prof = profile_call(torch, trace, run, call_ms)
        os.remove(os.path.join(HERE, "chiprun_out", trace))
        out[key]["profile"] = prof
        out[key]["device_busy_share"] = prof["device_busy_ms"] / call_ms
        del app
        free_tables(torch)
    out["full_run_max_abs_diff_data_axis"] = float(
        np.abs(final["(4, 1)"] - final["(1, 1)"]).max())
    log(f"  (4, 1) replicas bit-identical; its weights after "
        f"{1 + DENSE_TIMED_EPOCHS} epochs differ from the (1, 1) run's by "
        f"{out['full_run_max_abs_diff_data_axis']:.3g} at most")
    return out


# -- phase 18: telemetry ---------------------------------------------------


def tel_state(telemetry) -> dict:
    """Every counter's value and every histogram's count (``#count``)."""
    snap = telemetry.snapshot()
    out = dict(snap["counters"])
    out.update({f"{k}#count": h["count"]
                for k, h in snap["histograms"].items()})
    return out


def tel_moved(before: dict, after: dict) -> dict:
    """What moved between two :func:`tel_state` readings."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


@contextlib.contextmanager
def tel_sinks(telemetry, trace, path: str):
    """The span trace at ``path`` and the metric events beside it
    (``.events``), as ``MVTPU_TRACE_JSONL`` / ``MVTPU_METRICS_JSONL``
    would open them at import."""
    trace.set_trace_file(path)
    telemetry.registry().set_jsonl(path + ".events")
    try:
        yield
    finally:
        trace.set_trace_file(None)
        telemetry.registry().set_jsonl(None)


@contextlib.contextmanager
def env_set(**values: str):
    """The environment variables ``values`` set for the block, then put
    back as they were."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def tel_expect(what: str, moved: dict, want: dict) -> None:
    """Each key of ``want`` moved by exactly its value, and no
    ``table.*`` counter moved unless ``want`` names it."""
    for key, n in want.items():
        if moved.get(key, 0) != n:
            raise SystemExit(f"telemetry, {what}: {key} moved by "
                             f"{moved.get(key, 0)}, expected {n}")
    stray = [k for k in moved if k.startswith("table.") and k not in want]
    if stray:
        raise SystemExit(f"telemetry, {what}: table counters moved: "
                         f"{ {k: moved[k] for k in stray} }")


def tel_record_us(telemetry, trace, tmp: str, n: int = 2000) -> dict:
    """Microseconds a word2vec call spends recording itself (what
    ``WordEmbedding._dispatch`` records around its superstep: a span, a
    step record, a histogram observation and a beat), with the sinks off
    and on: the median of 5 loops of ``n``, on the host alone."""
    def loop() -> float:
        t0 = time.perf_counter()
        for i in range(n):
            t_step = time.perf_counter()
            with telemetry.span("w2v.superstep"):
                pass
            telemetry.step_timeline("w2v.cost", i, pairs=STEPS * BATCH,
                                    dispatch_s=time.perf_counter() - t_step)
            telemetry.histogram(
                "app.step.seconds", telemetry.LATENCY_BUCKETS,
                app="w2v.cost").observe(time.perf_counter() - t_step)
            telemetry.beat()
        return (time.perf_counter() - t0) / n * 1e6

    out = {"off": float(np.median([loop() for _ in range(5)]))}
    with tel_sinks(telemetry, trace, os.path.join(tmp, "telemetry_us.jsonl")):
        out["on"] = float(np.median([loop() for _ in range(5)]))
    return out


def phase_telemetry_w2v(torch, tk, telemetry, trace, app, batches,
                        pairs_per_token: float, tmp: str) -> dict:
    """Phase 18a: phase 4's app and pairs, one call each with the sinks
    off, on, on, off. Each call records one ``w2v.superstep`` span, one
    ``step`` record and one ``app.step.seconds`` observation (the sinks
    on), moves ``profile.calls`` of the superstep by one (a call, not its
    512 steps) and no ``table.*`` counter, and launches phase 4's two
    gathers and two scatter-adds a step."""
    path = os.path.join(tmp, "telemetry_w2v.jsonl")
    fn = f"profile.calls{{fn=superstep.{app._fused.name}}}"
    rates, walls = {"off": [], "on": []}, []
    for mode in ("off", "on", "on", "off"):
        sinks = tel_sinks(telemetry, trace, path) if mode == "on" \
            else contextlib.nullcontext()
        before, launches = tel_state(telemetry), dict(tk.LAUNCHES)
        with sinks:
            t0 = time.perf_counter()
            app.train(total_steps=STEPS, batches=batches[:STEPS])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        tel_expect(f"w2v call, sinks {mode}",
                   tel_moved(before, tel_state(telemetry)),
                   {fn: 1, "app.step.seconds{app=w2v}#count": 1,
                    "w2v.pairs": STEPS * BATCH})
        for name in ("row_gather", "row_scatter_add"):
            if tk.LAUNCHES[name] - launches[name] != 2 * STEPS:
                raise SystemExit(f"telemetry, w2v call: {name} launched "
                                 f"{tk.LAUNCHES[name] - launches[name]} "
                                 f"times, expected {2 * STEPS}")
        rates[mode].append(STEPS * BATCH / dt / pairs_per_token)
        if mode == "on":
            walls.append(dt)
    records = trace.read_trace(path)
    spans = [r["name"] for r in records if r["kind"] == "span"]
    steps = [r for r in records if r["kind"] == "step"]
    events = [r["metric"] for r in trace.read_trace(path + ".events")]
    if spans != ["w2v.superstep"] * 2 or len(steps) != 2 \
            or any(r["pairs"] != STEPS * BATCH for r in steps) \
            or events != ["w2v.words_per_sec"] * 2:
        raise SystemExit(f"telemetry, w2v: spans {spans}, step records "
                         f"{steps}, metric events {events}")
    dispatch = [r["dispatch_s"] for r in steps]
    out = dict(words_per_sec_off=rates["off"], words_per_sec_on=rates["on"],
               on_vs_off=sum(rates["on"]) / sum(rates["off"]),
               dispatch_s=dispatch, call_wall_s=walls,
               dispatch_s_median=float(np.median(dispatch)),
               call_wall_s_median=float(np.median(walls)),
               record_us=tel_record_us(telemetry, trace, tmp))
    log(f"  18a what a call records, alone: "
        f"{out['record_us']['off']:.1f} us with the sinks off, "
        f"{out['record_us']['on']:.1f} us on (median of 5 x 2,000), "
        f"{1e-4 * out['record_us']['on'] / out['call_wall_s_median']:.5f}% "
        f"of a call")
    log(f"  18a w2v, calls off/on/on/off: words/s off "
        f"{[round(r) for r in rates['off']]}, on "
        f"{[round(r) for r in rates['on']]} ({out['on_vs_off']:.3f}x); "
        f"dispatch_s a call {[round(d, 4) for d in dispatch]} (median "
        f"{out['dispatch_s_median']:.4f} s) against the call's wall "
        f"{[round(w, 4) for w in walls]} s; one span, step record and "
        f"app.step.seconds a call, profile.calls 1 a call of {STEPS} "
        f"steps, no table counter moved")
    return out


def phase_telemetry_watchdog(torch, tk, telemetry, tmp: str) -> dict:
    """Phase 18c: ``maybe_watchdog`` armed by ``MVTPU_WATCHDOG=1`` over a
    region that queues a gather and then goes 3 s without a beat: a dump
    must appear under ``MVTPU_DUMP_DIR`` with every thread's stack and
    the port's metrics snapshot."""
    dump_dir = os.path.join(tmp, "dumps")
    p = torch.randn(VOCAB + 1, DIM, device="cuda")
    ids = torch.randint(0, VOCAB, (BATCH,), dtype=torch.int32,
                        device="cuda")
    with env_set(MVTPU_WATCHDOG="1", MVTPU_DUMP_DIR=dump_dir), \
            telemetry.maybe_watchdog("smoke") as w:
        if w is None:
            raise SystemExit("telemetry: MVTPU_WATCHDOG=1 armed no "
                             "watchdog")
        tk.gather_rows(p, ids)
        t0 = time.perf_counter()
        while w.last_dump_path is None and time.perf_counter() - t0 < 3.0:
            time.sleep(0.05)
        waited = time.perf_counter() - t0
    dump = w.last_dump_path
    if not dump or os.path.dirname(dump) != dump_dir:
        raise SystemExit(f"telemetry: no watchdog dump under {dump_dir} "
                         f"({dump})")
    with open(os.path.join(dump, "stacks.txt")) as f:
        stacks = f.read()
    with open(os.path.join(dump, "metrics.json")) as f:
        snap = json.load(f)
    if "File " not in stacks or snap.get("kind") != "mvtpu.metrics.v1" \
            or not snap["counters"].get("w2v.pairs"):
        raise SystemExit(f"telemetry: the dump {dump} lacks the thread "
                         "stacks or the port's metrics snapshot")
    log(f"  18c watchdog: 1 s deadline, dump after {waited:.2f} s without "
        f"a beat: {sorted(os.listdir(dump))}, {stacks.count('Thread ')} "
        f"threads, {len(snap['counters'])} counters")
    return dict(dump_after_s=waited, files=sorted(os.listdir(dump)))


def phase_telemetry_memory(torch, telemetry) -> dict:
    """Phase 18d: ``record_device_memory`` against the allocator's own
    reads of cuda:0 (within 1%)."""
    torch.cuda.synchronize()
    out = telemetry.record_device_memory()
    alloc = torch.cuda.memory_allocated(0)
    peak = torch.cuda.max_memory_allocated(0)
    gauges = telemetry.snapshot()["gauges"]
    for key, want in (("bytes_in_use", alloc), ("peak_bytes_in_use", peak)):
        got = out.get(f"cuda:0.{key}")
        if got is None or abs(got - want) > 0.01 * want \
                or gauges.get(f"device.{key}{{device=cuda:0}}") != got:
            raise SystemExit(f"telemetry: device.{key} {got} against the "
                             f"allocator's {want}")
    log(f"  18d device memory: in use {out['cuda:0.bytes_in_use'] / 1e9:.3f}"
        f" GB (memory_allocated {alloc / 1e9:.3f}), peak "
        f"{out['cuda:0.peak_bytes_in_use'] / 1e9:.3f} GB "
        f"(max_memory_allocated {peak / 1e9:.3f}), limit "
        f"{out['cuda:0.bytes_limit'] / 1e9:.1f} GB, "
        f"{out['live_buffers']} live blocks")
    return out


def phase_telemetry_compiles(telemetry, builds: dict) -> dict:
    """Phase 18d: phase 1's builds on the record. A build that compiled
    (not a cached library) counts one ``profile.compiles{fn=<name>}``,
    its seconds the build's own; a cached one counts none."""
    snap = telemetry.snapshot()
    out = {}
    for name, mod in builds.items():
        n = snap["counters"].get(f"profile.compiles{{fn={name}}}", 0)
        last = snap["gauges"].get(f"profile.compile.last_s{{fn={name}}}")
        want = 1 if mod.build_seconds > 0 else 0
        if n != want or (want and last != mod.build_seconds):
            raise SystemExit(f"telemetry: {name} built in "
                             f"{mod.build_seconds:.2f} s, recorded {n} "
                             f"compile(s) of {last} s")
        out[name] = dict(compiles=n, seconds=last)
    log(f"  18d builds on the record: {out}")
    return out


def phase_telemetry_lda(torch, telemetry, trace, app, tmp: str) -> dict:
    """Phase 18b, LightLDA: one sweep of phase 6's app through
    ``train(num_iterations=1)`` with the sinks on: one ``lda.sweep`` span
    and ``step`` record, the sweep's tokens counted, ``profile.calls`` of
    the superstep once a call, no ``table.*`` counter moved."""
    path = os.path.join(tmp, "telemetry_lda.jsonl")
    fn = f"profile.calls{{fn=superstep.{app._fused.name}}}"
    before = tel_state(telemetry)
    with tel_sinks(telemetry, trace, path):
        app.train(num_iterations=1)
        torch.cuda.synchronize()
    tel_expect("LightLDA sweep", tel_moved(before, tel_state(telemetry)),
               {fn: app.calls_per_sweep, "lda.tokens": app.num_tokens,
                "app.step.seconds{app=lda}#count": 1})
    records = trace.read_trace(path)
    spans = [r["name"] for r in records if r["kind"] == "span"]
    steps = [r for r in records if r["kind"] == "step"]
    if spans != ["lda.sweep"] or len(steps) != 1 \
            or steps[0]["tokens"] != app.num_tokens:
        raise SystemExit(f"telemetry, LightLDA: spans {spans}, step "
                         f"records {steps}")
    log(f"  18b LightLDA: one sweep, {app.calls_per_sweep} superstep calls, "
        f"dispatch_s {steps[0]['dispatch_s']:.4f} s")
    return dict(dispatch_s=steps[0]["dispatch_s"])


def phase_telemetry_slr(torch, tk, telemetry, trace, KVTable, app, rows, y,
                        tmp: str) -> dict:
    """Phase 18b, sparse LR: four steps of phase 10's app through
    ``train`` with the sinks on. Each step's span holds its KV table's Get
    and Add spans; the table's ``table.add.bytes`` is the deltas' size
    times the value type's itemsize (the reference's formula), also for a
    bfloat16 KVTable (2 bytes a value)."""
    path = os.path.join(tmp, "telemetry_slr.jsonl")
    n = 4 * SLR_BATCH
    app.config = dataclasses.replace(app.config, epochs=1)
    t = app.table
    lbl = f"{{table={t.table_id}:{t.name}}}"
    elems, add = [], t.add

    def counting_add(keys, deltas, *args, **kw):
        elems.append(deltas.numel())
        return add(keys, deltas, *args, **kw)

    t.add = counting_add
    before, launches = tel_state(telemetry), dict(tk.LAUNCHES)
    try:
        with tel_sinks(telemetry, trace, path):
            app.train(rows[:n], y[:n])
    finally:
        t.add = add
    moved = tel_moved(before, tel_state(telemetry))
    tel_expect("sparse LR steps", moved, {
        "app.step.seconds{app=sparse_logreg}#count": 4,
        "sparse_logreg.samples": n,
        f"profile.calls{{fn=kv.lookup.{t.name}}}": 4,
        f"profile.calls{{fn=kv.apply.{t.name}}}": 4,
        f"table.get.ops{lbl}": 4, f"table.add.ops{lbl}": 4,
        f"table.get.elems{lbl}": moved.get(f"table.get.elems{lbl}", -1),
        f"table.get.bytes{lbl}": 4 * moved.get(f"table.get.elems{lbl}", -1),
        f"table.get.seconds{lbl}#count": 4,
        f"table.add.seconds{lbl}#count": 4,
        f"table.add.elems{lbl}": sum(elems),
        f"table.add.bytes{lbl}": 4 * sum(elems)})
    for name in ("kv_lookup", "kv_probe_update", "kv_commit"):
        if tk.LAUNCHES[name] - launches[name] != 4:
            raise SystemExit(f"telemetry, sparse LR: {name} launched "
                             f"{tk.LAUNCHES[name] - launches[name]} times "
                             "in 4 steps")
    records = trace.read_trace(path)
    spans = [r for r in records if r["kind"] == "span"]
    steps = [r for r in records if r["kind"] == "step"]
    if [r["name"] for r in spans] != ["table.get", "table.add",
                                      "sparse_logreg.step"] * 4 \
            or any(spans[i]["parent"] != spans[i + 2 - i % 3]["id"]
                   for i in range(12) if i % 3 < 2) \
            or [r["samples"] for r in steps] != [SLR_BATCH] * 4:
        named = [(r["name"], r["id"], r["parent"]) for r in spans]
        raise SystemExit(f"telemetry, sparse LR: spans {named}, step "
                         f"records {steps}")
    # a bfloat16 KVTable: 2 bytes a value whatever the delta's own type
    kv = KVTable(1 << 16, 2, "bfloat16", updater="sgd", device="cuda",
                 name="smoke_kv_bf16")
    keys = np.arange(1, SLR_BATCH + 1, dtype=np.uint64)
    before = tel_state(telemetry)
    kv.add(keys, np.ones((SLR_BATCH, 2), np.float32), sync=True)
    lbl = f"{{table={kv.table_id}:{kv.name}}}"
    tel_expect("bfloat16 KV add", tel_moved(before, tel_state(telemetry)), {
        f"table.add.ops{lbl}": 1, f"table.add.elems{lbl}": 2 * SLR_BATCH,
        f"table.add.bytes{lbl}": 2 * 2 * SLR_BATCH,
        f"table.add.seconds{lbl}#count": 1})
    dispatch = [r["dispatch_s"] for r in steps]
    log(f"  18b sparse LR: 4 steps, each span holding its table.get and "
        f"table.add; table.add.bytes {4 * sum(elems)} = 4 x "
        f"{sum(elems)} elements; bfloat16 KV add {2 * 2 * SLR_BATCH} bytes "
        f"for {2 * SLR_BATCH} values; dispatch_s a step "
        f"{[round(d, 4) for d in dispatch]}")
    return dict(dispatch_s=dispatch, add_elems=sum(elems))


def phase_telemetry_profile(torch, telemetry, app, batches, tmp: str,
                            steps: int = 16) -> dict:
    """Phase 18e, after every timed phase: a ``profile_window`` (under
    ``MVTPU_PROFILE_DIR``) over one word2vec call of ``steps`` steps
    through the app's dispatch; its Chrome trace must name the C entry
    points ``mv_row_gather`` and ``mv_row_scatter_add`` (the wrappers'
    profiler ranges), their kernels and the ``w2v.superstep`` range. (A
    trace of a whole 512-step call runs to tens of MiB.)"""
    src = np.stack([b[0] for b in batches[:steps]])
    tgt = np.stack([b[1] for b in batches[:steps]])
    app._dispatch(src, tgt, 0, 1)                 # the call's shapes, warm
    torch.cuda.synchronize()
    with env_set(MVTPU_PROFILE_DIR=os.path.join(tmp, "profile")), \
            telemetry.profile_window("w2v") as out:
        if out is None:
            raise SystemExit("telemetry: profile_window did not start")
        app._dispatch(src, tgt, 0, 1)
        torch.cuda.synchronize()
    (name,) = os.listdir(out)
    size = os.path.getsize(os.path.join(out, name))
    with open(os.path.join(out, name)) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    kernels = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    want = ("mv_row_gather", "mv_row_scatter_add", "w2v.superstep",
            "profile.window")
    missing = [w for w in want if w not in names]
    if missing or not any("row_gather" in k for k in kernels) \
            or not any("scatter" in k for k in kernels):
        raise SystemExit(f"telemetry: the profile window's trace lacks "
                         f"{missing} (kernels {sorted(kernels)[:8]})")
    log(f"  18e profile window: {name}, {size / 1e6:.1f} MB, "
        f"{len(events)} events; names {list(want)} and the kernels "
        f"{sorted(k[:40] for k in kernels)[:4]}")
    return dict(trace_mb=size / 1e6, events=len(events))


def device_events(prof, trace_name: str) -> list:
    """The device events (kernels, copies, memsets) of a finished
    torch.profiler session, through its chrome trace, which is kept under
    chiprun_out/."""
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    path = os.path.join(HERE, "chiprun_out", trace_name)
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in events
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def profile_call(torch, trace_name: str, run, call_ms: float) -> dict:
    """``run()`` (one superstep call or sweep) under torch.profiler:
    device time by kernel and the device's busy time, read from the
    trace's device events (kernels, copies, memsets; the union of their
    intervals). The profiler slows the host, so the busy share is also
    given against ``call_ms``, the same run's wall time without the
    profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = device_events(prof, trace_name)
    by_name = {}
    for e in device:
        ms, count = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + e["dur"] / 1e3, count + 1)
    busy_ms, end = 0.0, float("-inf")
    for start, stop in sorted((e["ts"], e["ts"] + e["dur"]) for e in device):
        busy_ms += max(0.0, stop - max(start, end)) / 1e3
        end = max(end, stop)
    rows = sorted(((k, ms, c) for k, (ms, c) in by_name.items()),
                  key=lambda r: -r[1])
    log(f"  profile: call wall {wall_ms:.1f} ms under the profiler, "
        f"{call_ms:.1f} ms without; device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / call_ms:.1f}% of the call without the "
        f"profiler)")
    for key, ms, count in rows[:12]:
        log(f"    {ms:9.2f} ms  x{count:6d}  {key[:90]}")
    return dict(wall_ms=wall_ms, call_ms=call_ms, device_busy_ms=busy_ms,
                top=[dict(name=k, ms=m, count=c) for k, m, c in rows[:12]])


# phase 19: the stat reduction's l2 against numpy's float64 sum (the card
# sums float32 in its own order); the dense logreg's epochs under a
# health rollback and a kill, and the positions planted in a float table
STAT_L2_RTOL = 1e-4
HEALTH_EPOCHS = 4
STAT_PLANTS = ((1, float("nan")), (3, float("inf")), (5, float("-inf")),
               (7, 0.0), (11, 0.0), (-1, float("nan")), (-2, 0.0))


def stats_want(sk, x: np.ndarray) -> dict:
    """``numpy_reference`` with the counts rounded once to float32, as the
    packed lanes hold them (exact below 2^24 elements)."""
    want = sk.numpy_reference(x)
    n = float(np.float32(x.size))
    zeros = float(np.float32(np.count_nonzero(x == 0)))
    want.update(count=n, zero_frac=zeros / n if n else 0.0)
    return want


def stats_check(what: str, got: dict, want: dict) -> None:
    for k in ("absmax", "nan_count", "inf_count", "zero_frac", "count"):
        if got[k] != want[k]:
            raise SystemExit(f"stats, {what}: {k} {got[k]} != {want[k]}")
    if abs(got["l2"] - want["l2"]) > STAT_L2_RTOL * abs(want["l2"]):
        raise SystemExit(f"stats, {what}: l2 {got['l2']} vs {want['l2']} "
                         f"(rtol {STAT_L2_RTOL})")


def phase_stats(torch, sk, ShardedParam) -> dict:
    """Phase 19a: the stat reduction on the card against
    ``numpy_reference`` (counts and abs_max exact, the counts rounded once
    to float32 as the packed lanes hold them; l2 within STAT_L2_RTOL): at
    word2vec's 10,001 x 100 float32 table and LightLDA's 50,001 x 1,024
    word table's shape in float32 with NaN, Inf and zeros planted, the
    word table's int32 counts, and the word2vec table's first 10,000 rows
    as a ShardedParam of 4 on cuda:0. Then one ``summarize`` at the two
    tables' own types: its device time (CUDA events), its bound (the
    operand read once at PEAK_BYTES_PER_S) and the host's time to queue
    it."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    w2v = torch.randn((ROWS, DIM), generator=gen, device="cuda")
    wide = torch.randn((LDA_V + 1, LDA_K), generator=gen, device="cuda")
    counts = torch.randint(0, 8, (LDA_V + 1, LDA_K), generator=gen,
                           device="cuda", dtype=torch.int32)
    for x in (w2v, wide):
        flat = x.view(-1)
        for i, v in STAT_PLANTS:
            flat[i] = v
    cases = {"w2v 10,001 x 100 float32": w2v,
             "lda 50,001 x 1,024 float32": wide,
             "lda 50,001 x 1,024 int32": counts,
             "w2v 10,000 x 100 as 4 shards": ShardedParam(
                 list(w2v[:ROWS - 1].chunk(SHARDS)))}
    for what, x in cases.items():
        got = sk.unpack(sk.summarize(x))
        host = torch.cat(x.shards) if isinstance(x, ShardedParam) else x
        stats_check(what, got, stats_want(sk, host.cpu().numpy()))
    del wide
    out = {}
    for what, x in (("w2v_table", w2v), ("lda_word_table", counts)):
        nbytes = x.numel() * x.element_size()
        out[what] = dict(
            shape=list(x.shape), dtype=str(x.dtype),
            ms=cuda_ms(lambda: sk.summarize(x), 10),
            host_ms=host_ms(lambda: sk.summarize(x), 10),
            bound_ms=1e3 * nbytes / PEAK_BYTES_PER_S, bytes=nbytes)
        r = out[what]
        log(f"  19a summarize {what} {r['shape']} {r['dtype']}: "
            f"{r['ms']:.4f} ms on the device (bound {r['bound_ms']:.4f} "
            f"ms, {r['bound_ms'] / r['ms']:.3f} of it), {r['host_ms']:.4f} "
            f"ms to queue")
    log(f"  19a {len(cases)} operands against numpy_reference: counts "
        f"and abs_max exact, l2 within {STAT_L2_RTOL}")
    return out


def phase_health_w2v(torch, thealth, telemetry, app, batches,
                     pairs_per_token: float) -> dict:
    """Phase 19b: phase 4's app and pairs, one 512-step call each with
    ``MVTPU_HEALTH`` unset, set, set, unset, twice (the monitor armed as
    ``core.init`` arms it): words/s both ways; a call with health on
    audits both tables once (the superstep's ``observe_param``, gated to
    every 16th call of a table: a fresh monitor's first call is due) and
    the monitor ingests them with no error and no drop. Then what a call
    records alone: the superstep's two ``observe_param`` calls, every 16th
    of them queueing a reduction (median of 5 loops of 1,600 calls)."""
    rates = {"off": [], "on": []}
    spec = "*.nan_count > 0, *.update_norm spike>10x"
    for mode in ("off", "on", "on", "off") * 2:
        if mode == "on":
            with env_set(MVTPU_HEALTH=spec):
                mon = thealth.maybe_health_monitor()
        t0 = time.perf_counter()
        app.train(total_steps=STEPS, batches=batches[:STEPS])
        torch.cuda.synchronize()
        rates[mode].append(STEPS * BATCH / (time.perf_counter() - t0)
                           / pairs_per_token)
        if mode == "on":
            if not mon.drain(timeout=60):
                raise SystemExit("health, w2v: the monitor did not drain")
            st = mon.status()
            audited = sorted(st["tables"])
            if audited != sorted(f"{t.name}/param"
                                 for t in (app.w_in, app.w_out)) \
                    or st["violations"] or st["dropped"]:
                raise SystemExit(f"health, w2v call: {st}")
            thealth.uninstall()

    mon = thealth.HealthMonitor(thealth.parse_health(spec)).start()
    thealth.install(mon)
    tables = (app.w_in, app.w_out)

    def loop(n: int = 1600) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            for t in tables:
                thealth.observe_param(t)
        return (time.perf_counter() - t0) / n * 1e6

    record_us = float(np.median([loop() for _ in range(5)]))
    if not mon.drain(timeout=60) or mon.status()["dropped"]:
        raise SystemExit(f"health, w2v record loop: {mon.status()}")
    thealth.uninstall()
    out = dict(words_per_sec_off=rates["off"], words_per_sec_on=rates["on"],
               on_vs_off=sum(rates["on"]) / sum(rates["off"]),
               record_us=record_us)
    log(f"  19b w2v calls (off, on, on, off) x 2: words/s off "
        f"{[round(r) for r in rates['off']]}, on "
        f"{[round(r) for r in rates['on']]} ({out['on_vs_off']:.3f}x); "
        f"each on call audited both tables once, no violation, no drop")
    log(f"  19b what a call records alone: {record_us:.2f} us (two "
        f"observe_param, every 16th queueing a reduction; median of 5 x "
        f"1,600)")
    return out


def ckpt_generation(torch, tckpt, tables, run_dir: str, telemetry,
                    then=None) -> dict:
    """One generation of ``tables`` through a background manager: the
    dispatch half (``save`` returning), ``then()`` queued right after it,
    the write half (the writer's ``ckpt.store.seconds``) and the time to
    resume it into the same tables (their devices synchronized)."""
    mgr = tckpt.RunCheckpointManager(run_dir, tables=list(tables))
    torch.cuda.synchronize()
    before = telemetry.snapshot()["histograms"].get(
        "ckpt.store.seconds", {"sum": 0.0})["sum"]
    t0 = time.perf_counter()
    mgr.save(1)
    dispatch = time.perf_counter() - t0
    if then is not None:
        then()
    mgr.close()                 # a write failure raises here
    write = telemetry.snapshot()["histograms"]["ckpt.store.seconds"][
        "sum"] - before
    nbytes = sum(os.path.getsize(os.path.join(run_dir, "gen-0000000001", f))
                 for f in os.listdir(os.path.join(run_dir,
                                                  "gen-0000000001")))
    t0 = time.perf_counter()
    restored = tckpt.RunCheckpointManager(
        run_dir, tables=list(tables), background=False).resume()
    torch.cuda.synchronize()
    resume = time.perf_counter() - t0
    if restored is None or restored.step != 1:
        raise SystemExit(f"checkpoint: resume of {run_dir} gave {restored}")
    return dict(dispatch_s=dispatch, write_s=write, resume_s=resume,
                bytes=nbytes)


def phase_ckpt_w2v(torch, tckpt, tbase, telemetry, app, batches,
                   tmp: str) -> dict:
    """Phase 19d (word2vec): a generation of phase 4's two tables (2 x 4
    MB) saved, and at once a 512-step call that writes both tables in
    place: the generation holds the pre-call values bit for bit, and the
    resume puts them back; the dispatch and write halves and the resume's
    time."""
    tables = (app.w_in, app.w_out)
    pre = [t.get() for t in tables]
    run_dir = os.path.join(tmp, "ckpt_w2v")
    r = ckpt_generation(
        torch, tckpt, tables, run_dir, telemetry,
        then=lambda: app.train(total_steps=STEPS, batches=batches[:STEPS]))
    for t, want in zip(tables, pre):
        _, data = tbase.loadz_stream(os.path.join(
            run_dir, "gen-0000000001", f"table-{t.name}.npz"),
            tbase.CHECKPOINT_MAGIC)
        if data["param"][:len(want)].tobytes() != want.tobytes():
            raise SystemExit(f"checkpoint, w2v: the generation of "
                             f"{t.name} is not its pre-add value")
        if t.get().tobytes() != want.tobytes():
            raise SystemExit(f"checkpoint, w2v: the resume of {t.name} "
                             "did not restore it")
    log(f"  19d w2v generation (2 x {ROWS} x {DIM} float32, "
        f"{r['bytes'] / 1e6:.1f} MB): dispatch half {1e3 * r['dispatch_s']:.2f} "
        f"ms, write half {1e3 * r['write_s']:.1f} ms, resume "
        f"{1e3 * r['resume_s']:.1f} ms; a call queued right after the "
        f"save left the generation at its pre-call values")
    return r


def phase_ckpt_lda(torch, tckpt, telemetry, app, tmp: str) -> dict:
    """Phase 19d (LightLDA): a generation of phase 6's word table (int32
    [50,001, 1,024], 205 MB) and summary: the dispatch and write halves
    and the resume's time; the resumed tables equal the saved ones."""
    wt = app.word_topic.superstep_view(0)[0].clone()
    r = ckpt_generation(torch, tckpt, (app.word_topic, app.summary),
                        os.path.join(tmp, "ckpt_lda"), telemetry)
    if not torch.equal(app.word_topic.superstep_view(0)[0], wt):
        raise SystemExit("checkpoint, lightlda: the resumed word table "
                         "differs from the saved one")
    del wt
    shutil.rmtree(os.path.join(tmp, "ckpt_lda"))
    log(f"  19d LightLDA generation ({r['bytes'] / 1e6:.1f} MB): dispatch "
        f"half {1e3 * r['dispatch_s']:.2f} ms, write half "
        f"{1e3 * r['write_s']:.1f} ms, resume {1e3 * r['resume_s']:.1f} ms")
    return r


class Killed(BaseException):
    """A simulated eviction of a training run (nothing recovers it)."""


def phase_health_logreg(torch, core, thealth, tchaos, tckpt, configure,
                        telemetry, LogisticRegression, LogRegConfig,
                        synthetic_blobs, tmp: str) -> dict:
    """Phase 19c and 19d's kill: phase 15's dense logreg at MNIST's shape
    for HEALTH_EPOCHS epochs, each epoch opening with a zero
    ``table.add`` (a no-op on the sgd weights). (c) With
    ``MVTPU_HEALTH="*.nan_count > 0"``, ``MVTPU_HEALTH_ACTION=rollback``
    and ``MVTPU_CHAOS=table.add:nan:after=2,times=1`` (armed by
    ``core.init``) and a run directory at ``-ckpt_every=1`` (``wire_app``):
    the chaos poisons epoch 3's add, the monitor arms a rollback, the loop
    restores generation 2 and replays; one rollback, and the final weights
    equal the clean run's bit for bit. (d) A run killed after generation 2
    and resumed in a fresh app (``-resume=true``) equals it too. Each
    epoch ends by draining the monitor, so the rollback lands at the next
    epoch's start."""
    from multiverso_tpu_torch.ft.checkpoint import define_run_flags, wire_app
    X, y = synthetic_blobs(DENSE_N, DENSE_DIM, DENSE_CLASSES)
    cfg = LogRegConfig(DENSE_DIM, DENSE_CLASSES, minibatch_size=DENSE_BATCH,
                       steps_per_call=DENSE_SPC, updater="sgd",
                       learning_rate=DENSE_LR, epochs=HEALTH_EPOCHS)

    def make(kill_after=None):
        app = LogisticRegression(cfg, device="cuda:0", name="health_lr")
        epoch = app.train_epoch

        def each(X, y, shuffle_seed=None):
            if app._epoch_done == kill_after:
                raise Killed()
            app.table.add(np.zeros(app.n_weights, np.float32))
            loss = epoch(X, y, shuffle_seed=shuffle_seed)
            app.table.wait()
            thealth.drain()
            return loss
        app.train_epoch = each
        return app

    def run_flags(run_dir: str, resume: bool) -> None:
        define_run_flags()
        configure.parse_flags([f"-run_dir={run_dir}", "-ckpt_every=1",
                               f"-resume={'true' if resume else 'false'}"])

    t0 = time.perf_counter()
    clean = make()
    clean.train(X, y)
    want = clean.table.get().tobytes()
    clean_s = time.perf_counter() - t0

    with env_set(MVTPU_HEALTH="*.nan_count > 0",
                 MVTPU_HEALTH_ACTION="rollback",
                 MVTPU_CHAOS="table.add:nan:after=2,times=1"):
        core.init(device="cuda:0")
    if thealth.monitor() is None or tchaos.installed_chaos() is None:
        raise SystemExit("health: core.init armed no monitor or chaos")
    before = tel_state(telemetry)
    run_flags(os.path.join(tmp, "health_run"), False)
    t0 = time.perf_counter()
    app = make()
    mgr = wire_app(app, [app.table], every_default=1)
    app.train(X, y)
    mgr.close()
    rolled_s = time.perf_counter() - t0
    moved = tel_moved(before, tel_state(telemetry))
    status = thealth.status()
    thealth.uninstall()
    tchaos.uninstall_chaos()
    rolled_to = telemetry.snapshot()["gauges"].get("ckpt.resumed_step")
    fired = moved.get("chaos.fired{kind=nan,point=table.add}", 0)
    violations = sum(v for k, v in moved.items()
                     if k.startswith("health.violations"))
    if fired != 1 or moved.get("health.rollbacks", 0) != 1 \
            or violations < 1 or status["divergence"] is not None:
        raise SystemExit(f"health rollback: chaos fired {fired}, moved "
                         f"{ {k: v for k, v in moved.items() if 'health' in k or 'chaos' in k} }, "
                         f"status {status}")
    if app.table.get().tobytes() != want:
        raise SystemExit("health rollback: the final weights differ from "
                         "the clean run's")
    gens = [g.step for g in mgr.scan()]

    kill_dir = os.path.join(tmp, "kill_run")
    run_flags(kill_dir, False)
    killed = make(kill_after=2)
    kmgr = wire_app(killed, [killed.table], every_default=1)
    try:
        killed.train(X, y)
        raise SystemExit("kill: the run was not killed")
    except Killed:
        pass
    kmgr.close()
    run_flags(kill_dir, True)
    res = make()
    rmgr = wire_app(res, [res.table], every_default=1)
    if res._epoch_done != 2:
        raise SystemExit(f"kill: resumed at epoch {res._epoch_done}, not 2")
    res.train(X, y)
    rmgr.close()
    configure.parse_flags(["-run_dir=", "-ckpt_every=0", "-resume=false"])
    if res.table.get().tobytes() != want:
        raise SystemExit("kill: the resumed run's weights differ from the "
                         "uninterrupted run's")
    out = dict(clean_s=clean_s, rolled_back_s=rolled_s,
               rolled_back_to=rolled_to,
               rollbacks=moved.get("health.rollbacks", 0),
               violations=violations, generations_kept=gens,
               ckpt_store_ops=moved.get("ckpt.store.ops", 0))
    log(f"  19c dense logreg {HEALTH_EPOCHS} epochs: clean {clean_s:.2f} "
        f"s; with the chaos NaN in epoch 3: {violations} violation(s), 1 "
        f"rollback to generation {rolled_to}, {out['ckpt_store_ops']} "
        f"generations "
        f"written, {rolled_s:.2f} s, final weights bit-identical to the "
        f"clean run")
    log("  19d dense logreg killed after generation 2 and resumed "
        "(-resume=true): bit-identical to the uninterrupted run")
    return out


def health_clean(telemetry) -> None:
    """Phase 19's last check: no health error, no dropped sample, no
    failed checkpoint GC (a failed write raised at its manager's close)."""
    c = telemetry.snapshot()["counters"]
    bad = {k: c.get(k, 0) for k in ("health.errors", "health.dropped",
                                    "ckpt.gc.failures")}
    if any(bad.values()):
        raise SystemExit(f"health / checkpoints: {bad}")
    log(f"  19: {bad}")


# -- phase 20: the client pipeline and the control plane ---------------------

# phase 20a's coalescing depth: 32 adds in 8 flushes
SLR_COALESCE = 4
# phase 20d's objective: violated on any card (no add takes under 1 us)
AUTOTUNE_SPEC = "table.add.seconds.p99 < 1us -> client.coalesce_k+"


class PackMemo:
    """``SparseLogisticRegression._pack`` memoised by minibatch. Every
    sparse-LR run at phase 10's shape packs the same minibatches (an
    epoch's order derives from its index); phase 10 fills the memo and
    prints the pack's time, so phase 20's runs time what the client
    pipeline changes, not the pack again."""

    def __init__(self) -> None:
        self.cache = {}

    def wrap(self, app) -> None:
        pack = app._pack

        def memo(rows):
            key = (len(rows), id(rows[0]), id(rows[-1]))
            if key not in self.cache:
                self.cache[key] = pack(rows)
            return self.cache[key]
        app._pack = memo


def slr_app(SparseLogisticRegression, SparseLRConfig, name: str,
            coalesce: int = 0):
    """Phase 10's sparse LR app on the card, built with
    ``MVTPU_COALESCE=coalesce`` (0: no coalescer)."""
    cfg = SparseLRConfig(capacity=SLR_CAPACITY, slots_per_bucket=SLR_SLOTS,
                         max_features=64, minibatch_size=SLR_BATCH,
                         updater="ftrl", learning_rate=0.1,
                         epochs=SLR_EPOCHS)
    with env_set(MVTPU_COALESCE=str(coalesce)):
        return SparseLogisticRegression(cfg, device="cuda", name=name)


def slr_run(torch, counts, app, data, hook=None) -> dict:
    """Train ``app`` on phase 10's data (packs memoised; ``hook`` wraps
    ``train_batch``): its seconds, samples/s, launches and final table on
    the host."""
    data["pack_memo"].wrap(app)
    if hook is not None:
        app.train_batch = hook(app.train_batch)
    start = counts()
    t0 = time.perf_counter()
    app.train(data["rows"], data["y"])
    app.table.wait()
    dt = time.perf_counter() - t0
    grown = {k: v - start[k] for k, v in counts().items()}
    keys, vals, state = app.table.global_arrays()
    losses = [e["loss"] for e in app.epoch_stats]
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise SystemExit(f"sparse LR {app.table.name}: epoch losses {losses}")
    return dict(seconds=dt, samples_per_sec=SLR_N * SLR_EPOCHS / dt,
                launches=grown, losses=losses,
                triple=(keys.cpu(), vals.cpu(),
                        {k: v.cpu() for k, v in state.items()}))


def phase_coalesced_slr(torch, tk, counts, coalesce, telemetry, client,
                        KVTable, AddOption, SparseLogisticRegression,
                        SparseLRConfig, data, card: str) -> dict:
    """Phase 20a: phase 10's sparse LR with ``MVTPU_COALESCE=4`` (8 flushes
    of 4 minibatches, each pre-summed by key on the card through the row
    scatter-add), in pairs with the uncoalesced run (off, on, on, off).
    Each coalesced run launches 8 probes + 8 commits and 32 + 8 row
    scatters (the gradient's and the pre-sum's); both coalesced runs, and
    a third with the pre-sum forced to its plain version on the CPU,
    leave the same table bit for bit; the uncoalesced runs leave phase
    10's. The pre-sum's device time at a flush's shapes, beside its bound
    and ``index_add_``, and a flush's host parts beside the adds it
    replaces (:func:`flush_parts`)."""
    steps = SLR_EPOCHS * SLR_N // SLR_BATCH
    flushes = steps // SLR_COALESCE
    runs, triples = {"off": [], "on": []}, {"off": [], "on": []}
    for i, mode in enumerate(("off", "on", "on", "off")):
        free_tables(torch)
        app = slr_app(SparseLogisticRegression, SparseLRConfig,
                      f"smoke_slr_co{i}",
                      SLR_COALESCE if mode == "on" else 0)
        r = slr_run(torch, counts, app, data)
        want = {"kv_probe_update": steps, "kv_commit": steps,
                "kv_lookup": steps, "row_scatter_add": steps}
        if mode == "on":
            want.update(kv_probe_update=flushes, kv_commit=flushes,
                        row_scatter_add=steps + flushes)
            if app._coalescer.flush_generation != flushes:
                raise SystemExit(f"20a: {app._coalescer.flush_generation} "
                                 f"flushes, expected {flushes}")
            lbl = app._coalescer._lbl
            h = telemetry.snapshot()["histograms"][
                f"client.flush.seconds{{table={lbl}}}"]
            r["flush_wall_ms"] = 1e3 * h["sum"] / h["count"]
        for name, n in want.items():
            if r["launches"][name] != n:
                raise SystemExit(f"20a {mode}: {name} launched "
                                 f"{r['launches'][name]} times, expected {n}")
        runs[mode].append(r)
        triples[mode].append(r.pop("triple"))
        del app
    if not same_triple(torch, triples["off"][0], data["triple"]) \
            or not same_triple(torch, triples["off"][1], data["triple"]):
        raise SystemExit("20a: an uncoalesced run differs from phase 10's")
    if not same_triple(torch, triples["on"][0], triples["on"][1]):
        raise SystemExit("20a: the two coalesced runs differ")
    # the same coalesced run with the pre-sum's plain version on the CPU;
    # the first flush's operands are kept to time the kernel on them
    kept, presum = [], coalesce.presum

    def plain(zeros, inv, deltas):
        if not kept:
            kept.append((zeros.shape, inv.clone(), deltas.clone()))
        zeros.copy_(tk.row_scatter_add_plain(zeros.cpu(), inv.cpu(),
                                             deltas.cpu()))
        return zeros

    free_tables(torch)
    app = slr_app(SparseLogisticRegression, SparseLRConfig, "smoke_slr_pl",
                  SLR_COALESCE)
    coalesce.presum = plain
    try:
        r = slr_run(torch, counts, app, data)
    finally:
        coalesce.presum = presum
    del app
    if r["launches"]["row_scatter_add"] != steps:
        raise SystemExit("20a: the plain pre-sum launched a row scatter")
    if not same_triple(torch, r["triple"], triples["on"][0]):
        raise SystemExit("20a: the coalesced table differs from the same "
                         "run with the plain pre-sum (bit for bit)")
    del triples, r
    free_tables(torch)
    shape, inv, deltas = kept[0]
    zeros = torch.zeros(shape, device="cuda")
    before = tk.LAUNCHES["row_scatter_add"]
    got = coalesce.presum(zeros, inv, deltas)
    if tk.LAUNCHES["row_scatter_add"] != before + 1 or not torch.equal(
            got.cpu(), tk.row_scatter_add_plain(
                torch.zeros(shape), inv.cpu(), deltas.cpu())):
        raise SystemExit("20a: the pre-sum kernel != its plain version")
    n, (u, c) = inv.shape[0], shape
    ms = cuda_ms(lambda: coalesce.presum(zeros, inv, deltas), 50)
    lib = cuda_ms(lambda: zeros.index_add_(0, inv, deltas), 50)
    b, by = bound_ms(n * 4 + n * c * 4 + 2 * u * c * 4, n * c)
    on, off = runs["on"], runs["off"]
    flush_ms = float(np.mean([r["flush_wall_ms"] for r in on]))
    out = dict(
        samples_per_sec_off=[r["samples_per_sec"] for r in off],
        samples_per_sec_on=[r["samples_per_sec"] for r in on],
        on_vs_off=sum(r["samples_per_sec"] for r in on)
        / sum(r["samples_per_sec"] for r in off),
        flushes=flushes, launches_on=on[0]["launches"],
        launches_off=off[0]["launches"], presum_lanes=n, presum_unique=u,
        presum_ms=ms, presum_index_add_ms=lib, presum_bound_ms=b,
        presum_bound_by=by, flush_wall_ms=flush_ms,
        presum_share_of_flush=ms / flush_ms,
        losses_on=on[0]["losses"], losses_off=off[0]["losses"],
        flush_parts=flush_parts(torch, KVTable, AddOption, client,
                                data["adds"]))
    fp = out["flush_parts"]
    log(f"  20a {flushes} flushes of {SLR_COALESCE} minibatches; launches "
        f"coalesced: probe {on[0]['launches']['kv_probe_update']} + commit "
        f"{on[0]['launches']['kv_commit']}, row scatter "
        f"{on[0]['launches']['row_scatter_add']} (the gradient's {steps} + "
        f"the pre-sum's {flushes}); uncoalesced: probe "
        f"{off[0]['launches']['kv_probe_update']} + commit "
        f"{off[0]['launches']['kv_commit']}")
    log(f"  20a pre-sum at a flush's shapes ({n} lanes, {u} keys, C {c}): "
        f"{ms:.4f} ms on the device (index_add_ {lib:.4f}, bound {b:.4f} "
        f"{by}), {100 * out['presum_share_of_flush']:.2f}% of a flush's "
        f"{flush_ms:.2f} ms wall; tables: coalesced runs identical, equal "
        f"to the plain pre-sum's bit for bit; uncoalesced equal phase 10's")
    log(f"  20a a flush of {SLR_COALESCE} adds apart (host ms, each fenced):"
        f" the pre-sum {fp['presum_ms']:.1f}, prepare_add of {fp['keys']} "
        f"keys {fp['prepare_ms']:.1f}, add_prepared {fp['apply_ms']:.1f}; "
        f"the {SLR_COALESCE} direct adds: prepare_add "
        f"{fp['direct_prepare_ms']:.1f}, add_prepared "
        f"{fp['direct_apply_ms']:.1f}")
    log(f"  20a samples/s (packs memoised) off "
        f"{[round(x) for x in out['samples_per_sec_off']]}, on "
        f"{[round(x) for x in out['samples_per_sec_on']]} "
        f"({out['on_vs_off']:.3f}x); epoch losses on "
        f"{[round(x, 5) for x in out['losses_on']]}, off "
        f"{[round(x, 5) for x in out['losses_off']]}; on {card}")
    return out


def flush_parts(torch, KVTable, AddOption, client, adds) -> dict:
    """One 20a flush taken apart on the host's clock, each part fenced by
    a device sync: the coalescer's pre-sum (the keys' ``np.unique`` and
    #2), the table's host prep (``prepare_add``) and its device half
    (``add_prepared``), beside the same parts of the SLR_COALESCE direct
    adds the flush replaces; fresh 2^25-slot tables."""
    def table(name):
        return KVTable(SLR_CAPACITY, value_dim=2, slots_per_bucket=SLR_SLOTS,
                       updater="ftrl", default_option=AddOption.for_ftrl(0.1),
                       device="cuda", name=name)

    def timed(fn):
        _sync(torch)
        t0 = time.perf_counter()
        r = fn()
        _sync(torch)
        return r, 1e3 * (time.perf_counter() - t0)

    group = adds[:SLR_COALESCE]
    out = {"direct_prepare_ms": 0.0, "direct_apply_ms": 0.0}
    free_tables(torch)
    t = table("smoke_kv_parts_direct")
    for keys, deltas in group:
        prep, ms = timed(lambda: t.prepare_add(keys, deltas))
        out["direct_prepare_ms"] += ms
        out["direct_apply_ms"] += timed(lambda: t.add_prepared(prep))[1]
    del t
    free_tables(torch)
    t = table("smoke_kv_parts_flush")
    buf = client.CoalescingBuffer(t, max_deltas=1 << 30)
    for keys, deltas in group:
        buf.add_kv(keys, deltas)
    (uniq, summed), out["presum_ms"] = timed(buf._summed_unique)
    prep, out["prepare_ms"] = timed(lambda: t.prepare_add(uniq, summed))
    out["apply_ms"] = timed(lambda: t.add_prepared(prep))[1]
    out["keys"] = int(len(uniq))
    del t, buf, prep, summed
    free_tables(torch)
    return out


def phase_staged_adds(torch, KVTable, AddOption, client, adds,
                      card: str) -> dict:
    """Phase 20c: phase 10's 32 adds (each step's keys and card delta)
    replayed on fresh 2^25-slot ftrl tables, directly and through
    ``stage_kv_adds(depth=2)``: keys, values and state bit for bit, and
    both wall times."""
    out = {}
    triples = {}
    for mode in ("direct", "staged", "staged", "direct"):
        free_tables(torch)
        t = KVTable(SLR_CAPACITY, value_dim=2, slots_per_bucket=SLR_SLOTS,
                    updater="ftrl", default_option=AddOption.for_ftrl(0.1),
                    device="cuda", name=f"smoke_kv_{mode}")
        _sync(torch)
        t0 = time.perf_counter()
        if mode == "direct":
            for keys, deltas in adds:
                t.add(keys, deltas)
        else:
            client.stage_kv_adds(t, adds, depth=2)
        t.wait()
        out.setdefault(f"{mode}_s", []).append(time.perf_counter() - t0)
        keys, vals, state = t.global_arrays()
        triple = (keys.cpu(), vals.cpu(), {k: v.cpu()
                                           for k, v in state.items()})
        if mode in triples and not same_triple(torch, triple,
                                               triples[mode]):
            raise SystemExit(f"20c: two {mode} replays differ")
        triples[mode] = triple
        del t, keys, vals, state
    if not same_triple(torch, triples["direct"], triples["staged"]):
        raise SystemExit("20c: staged adds != direct adds (bit for bit)")
    free_tables(torch)
    log(f"  20c {len(adds)} adds: direct "
        f"{[round(x, 3) for x in out['direct_s']]} s, staged (depth 2) "
        f"{[round(x, 3) for x in out['staged_s']]} s; keys, values and "
        f"state bit for bit; on {card}")
    return out


def record_generations(torch, table, keep: int):
    """Copies on the card of ``table``'s logical value at each generation
    from now on (the newest ``keep``), taken as each bump notifies the
    views. Returns (the dict, a function that stops the recording)."""
    history = {table.generation: table.logical_tensor()}
    notify = table._notify_views

    def recording():
        history[table.generation] = table.logical_tensor()
        for g in sorted(history)[:-keep]:
            del history[g]
        notify()

    table._notify_views = recording
    return history, lambda: table.__dict__.pop("_notify_views")


def check_served(torch, view, history, served, bound: int, what: str):
    """The array ``view`` served last: within ``bound``, equal bit for bit
    to the table at the served generation; keeps it with a copy so that a
    later check finds it unchanged."""
    got, gen = served[-1][0], view.generation
    if view._table.generation - gen > bound:
        raise SystemExit(f"20b {what}: served generation {gen}, table at "
                         f"{view._table.generation}, bound {bound}")
    if gen not in history or not np.array_equal(
            got, history[gen].cpu().numpy()):
        raise SystemExit(f"20b {what}: the served array != the table at "
                         f"generation {gen}")
    return view._table.generation - gen


def view_counts(telemetry, view) -> tuple:
    c = telemetry.snapshot()["counters"]
    return (c.get(f"client.cache.hits{{table={view._lbl}}}", 0),
            c.get(f"client.cache.misses{{table={view._lbl}}}", 0))


def phase_view_w2v(torch, client, telemetry, app, batches,
                   pairs_per_token: float, card: str) -> dict:
    """Phase 20b (word2vec): phase 4's app with ``MVTPU_STALENESS=1``,
    ``embeddings()`` read after each 512-step call. Six calls under one
    view: the staleness served (never above 1), hits and misses, the
    refresh's ms on the dispatch thread and the worker's wait, every
    served array equal to ``w_in`` at its generation and unchanged after
    the later refreshes, one pinned buffer. Then words/s with the view on
    and off, four calls a side in pairs (a call and its read, fenced)."""
    table = app.w_in
    with env_set(MVTPU_STALENESS="1"):
        view = client.maybe_cached_view(table)
    app._emb_view = view
    history, stop = record_generations(torch, table, keep=4)
    served, stale, refresh_ms, wait_ms = [], [], [], []
    try:
        for _ in range(6):
            n = view.refreshes
            app.train(total_steps=STEPS, batches=batches[:STEPS])
            if view.refreshes > n:
                refresh_ms.append(1e3 * view.last_refresh_s)
            got = app.embeddings()
            served.append((got, got.copy()))
            stale.append(check_served(torch, view, history, served, 1,
                                      "w2v"))
            wait_ms.append(1e3 * view.last_wait_s)
    finally:
        stop()
    if any(not np.array_equal(g, c) for g, c in served):
        raise SystemExit("20b w2v: a served array changed afterwards")
    hits, misses = view_counts(telemetry, view)
    allocs, refreshes = view.staging_allocs, view.refreshes
    view.close()
    del history, served
    rates = {"off": [], "on": []}
    for mode in ("on", "off", "off", "on") * 2:
        app._emb_view = None
        if mode == "on":
            with env_set(MVTPU_STALENESS="1"):
                app._emb_view = client.maybe_cached_view(table)
        t0 = time.perf_counter()
        app.train(total_steps=STEPS, batches=batches[:STEPS])
        app.embeddings()
        torch.cuda.synchronize()
        rates[mode].append(STEPS * BATCH / (time.perf_counter() - t0)
                           / pairs_per_token)
        if app._emb_view is not None:
            app._emb_view.close()
    app._emb_view = None
    out = dict(staleness=stale, hits=hits, misses=misses,
               refreshes=refreshes, refresh_ms=refresh_ms, wait_ms=wait_ms,
               staging_allocs=allocs,
               words_per_sec_on=rates["on"], words_per_sec_off=rates["off"],
               on_vs_off=sum(rates["on"]) / sum(rates["off"]))
    log(f"  20b w2v, 6 calls, bound 1: staleness served {stale}, hits "
        f"{hits:.0f}, misses {misses:.0f}, {refreshes} background "
        f"refreshes, each on the dispatch thread "
        f"{[round(x, 3) for x in refresh_ms]} ms, the worker's wait "
        f"{[round(x, 3) for x in wait_ms]} ms, {allocs} pinned buffer; "
        f"every served array = w_in at its generation, none changed")
    log(f"  20b w2v words/s (a call + embeddings()), view on "
        f"{[round(r) for r in rates['on']]}, off "
        f"{[round(r) for r in rates['off']]} ({out['on_vs_off']:.3f}x); "
        f"on {card}")
    return out


def phase_view_lda(torch, client, telemetry, app, card: str) -> dict:
    """Phase 20b (LightLDA): phase 6's doc-blocked app with
    ``MVTPU_STALENESS=2`` over its 205 MB word table, ``word_topics()``
    read after each of 3 sweeps (22 generations a sweep): the refresh's
    ms on the dispatch thread, the worker's wait and copy-out, the
    staleness served, every served array equal to the table at its
    generation and unchanged afterwards, and one pinned buffer for every
    refresh."""
    table = app.word_topic
    with env_set(MVTPU_STALENESS="2"):
        view = client.maybe_cached_view(table)
    app._wt_view = view
    history, stop = record_generations(torch, table, keep=3)
    served, stale, refresh_ms, wait_ms, copy_ms = [], [], [], [], []
    try:
        for _ in range(3):
            n = view.refreshes
            app.sweep()
            got = app.word_topics()
            served.append((got, got.copy()))
            stale.append(check_served(torch, view, history, served, 2,
                                      "lightlda"))
            if view.refreshes > n:
                refresh_ms.append(1e3 * view.last_refresh_s)
            wait_ms.append(1e3 * view.last_wait_s)
            copy_ms.append(1e3 * view.last_copy_s)
        got = view.get(max_staleness=0)      # a refresh after the sweeps
        served.append((got, got.copy()))
        check_served(torch, view, history, served, 0, "lightlda")
    finally:
        stop()
    if any(not np.array_equal(g, c) for g, c in served):
        raise SystemExit("20b lightlda: a served array changed afterwards")
    if view.staging_allocs != 1:
        raise SystemExit(f"20b lightlda: {view.staging_allocs} pinned "
                         "buffers for one table")
    hits, misses = view_counts(telemetry, view)
    mb, refreshes = served[0][0].nbytes / 1e6, view.refreshes
    view.close()
    app._wt_view = None
    del history, served
    out = dict(staleness=stale, hits=hits, misses=misses,
               refreshes=refreshes, refresh_ms=refresh_ms, wait_ms=wait_ms,
               copy_ms=copy_ms, table_mb=mb, staging_allocs=1)
    log(f"  20b LightLDA ({mb:.1f} MB word table), 3 sweeps, bound 2: "
        f"staleness served {stale}, hits {hits:.0f}, misses {misses:.0f}, "
        f"{refreshes} background refreshes; "
        f"refresh on the dispatch thread {[round(x, 3) for x in refresh_ms]}"
        f" ms, the worker's wait {[round(x, 3) for x in wait_ms]} ms and "
        f"copy-out {[round(x, 2) for x in copy_ms]} ms; one pinned buffer; "
        f"every served array = the table at its generation; on {card}")
    return out


def controller_threads() -> int:
    import threading
    return sum(1 for t in threading.enumerate()
               if t.name == "mvtpu-control" and t.is_alive())


def phase_autotune_slr(torch, tk, counts, mvt, core, ctl, trace,
                       SparseLogisticRegression, SparseLRConfig, data,
                       tmp: str, card: str) -> dict:
    """Phase 20d: 20a's sparse LR with ``MVTPU_COALESCE=2`` under the
    objective ``AUTOTUNE_SPEC``, ``check_once()`` driven after every
    fourth minibatch (confirm 1, hold 0): K from 2 in clamped +2 steps,
    one a check, each move in the decision ring and a
    ``control.decision`` span of the trace file; the table bit for bit a
    replay of the same flush schedule without the controller;
    ``MVTPU_AUTOTUNE=0`` vetoing every apply; ``core.init`` with
    ``MVTPU_AUTOTUNE`` arming one controller thread and ``core.shutdown``
    leaving none."""
    free_tables(torch)
    app = slr_app(SparseLogisticRegression, SparseLRConfig, "smoke_slr_tune",
                  2)
    buf = app._coalescer
    (obj,) = ctl.parse_objectives(AUTOTUNE_SPEC)
    c = ctl.Controller([obj], confirm=1, hold=0)
    ks, flushed_after, seen = [buf.max_deltas], [], [0, 0]
    ring0 = len(ctl.recent_decisions())

    def hook(train_batch):
        def run(rows, y):
            loss = train_batch(rows, y)
            seen[0] += 1
            if buf.flush_generation != seen[1]:
                flushed_after.append(seen[0])
                seen[1] = buf.flush_generation
            if seen[0] % 4 == 0:
                c.check_once()
                ks.append(buf.max_deltas)
            return loss
        return run

    path = os.path.join(tmp, "autotune_trace.jsonl")
    trace.set_trace_file(path)
    try:
        tuned = slr_run(torch, counts, app, data, hook)
    finally:
        trace.set_trace_file(None)
    checks = len(ks) - 1
    want = [2 + 2 * i for i in range(checks + 1)]
    if ks != want:
        raise SystemExit(f"20d: K went {ks}, expected {want}")
    ring = [e for e in ctl.recent_decisions()[ring0:]
            if e.get("knob") == "client.coalesce_k"
            and e["label"] == buf._lbl]
    spans = [r["attrs"] for r in trace.read_trace(path)
             if r.get("kind") == "span" and r["name"] == "control.decision"
             and r["attrs"]["label"] == buf._lbl]
    moves = [(k, k + 2) for k in want[:-1]]
    if [(e["from"], e["to"]) for e in ring] != moves \
            or [(a["from"], a["to"]) for a in spans] != moves \
            or any(a["rule"] != AUTOTUNE_SPEC for a in spans):
        raise SystemExit(f"20d: ring {ring}, spans {spans}")
    with env_set(MVTPU_AUTOTUNE="0"):
        k = buf.max_deltas
        if c.check_once() or ctl.apply_step("client.coalesce_k", 1) \
                or ctl.apply_set("client.coalesce_k", 64) \
                or buf.max_deltas != k:
            raise SystemExit("20d: MVTPU_AUTOTUNE=0 did not veto an apply")
    del app, buf

    # the same flush schedule, replayed without the controller
    free_tables(torch)
    app = slr_app(SparseLogisticRegression, SparseLRConfig,
                  "smoke_slr_replay", 2)
    app._coalescer.max_deltas = 1 << 30
    n = [0]

    def replay(train_batch):
        def run(rows, y):
            loss = train_batch(rows, y)
            n[0] += 1
            if n[0] in flushed_after:
                app._coalescer.flush()
            return loss
        return run

    replayed = slr_run(torch, counts, app, data, replay)
    del app
    free_tables(torch)
    if not same_triple(torch, tuned["triple"], replayed["triple"]):
        raise SystemExit("20d: the tuned table != the replay of its flush "
                         "schedule (bit for bit)")

    # arming from core.init, and none left after core.shutdown
    before = controller_threads()
    with env_set(MVTPU_AUTOTUNE=AUTOTUNE_SPEC, MVTPU_AUTOTUNE_EVERY="3600"):
        core.init(device="cuda:0")
        core.init(device="cuda:0")
        armed = controller_threads() - before
    core.shutdown()
    left = controller_threads()
    mvt.init()
    if armed != 1 or left != 0:
        raise SystemExit(f"20d: core.init armed {armed} controller "
                         f"thread(s); {left} left after core.shutdown")
    out = dict(k_sequence=ks, flushed_after=flushed_after,
               ring=[(e["from"], e["to"]) for e in ring],
               spans=len(spans), samples_per_sec=tuned["samples_per_sec"],
               armed_threads=armed, threads_after_shutdown=left)
    log(f"  20d K after each of {checks} checks: {ks}; flushes after "
        f"minibatches {flushed_after}; the ring and {len(spans)} "
        f"control.decision spans: {out['ring']}; the table = the replay of "
        f"its flush schedule bit for bit; MVTPU_AUTOTUNE=0 vetoed every "
        f"apply; core.init armed {armed} controller thread, "
        f"{left} after core.shutdown; {tuned['samples_per_sec']:.0f} "
        f"samples/s; on {card}")
    return out


# phase 21: tiered KV storage. 21a replays phase 10's adds (ftrl,
# value_dim 2) through a TieredKVTable in buckets of 8 (a record is 256
# bytes of keys, values and ftrl state plus a 16-byte header on disk): a
# sixteenth of the buckets on the card, a thirty-second in the pinned host
# arena, the rest spilled to disk. Each steady-state add moves about as
# many buckets as it has keys, one at a time on the host, so the replay
# is cut to the fewest adds that reach every check (the host arena fills
# during the third, the save follows it, and the fourth fills buckets
# back from disk and finishes the resumed run), and its scale to
# 1/TIERED_SCALE: the table's capacity (2^24 slots, 2,097,152 logical
# buckets) and each add's keys (its first half), the ratios kept
TIERED_SLOTS, TIERED_SCALE = 8, 2
TIERED_CAPACITY = SLR_CAPACITY // TIERED_SCALE
TIERED_BUCKETS = TIERED_CAPACITY // TIERED_SLOTS
TIERED_DEVICE, TIERED_HOST = TIERED_BUCKETS // 16, TIERED_BUCKETS // 32
TIERED_ADDS, TIERED_SAVE_AT = 4, 3
# 21b: the same ratios and the first sixteenth of the first 3 adds' keys
# (the arena fills and spills during the third) at a sixteenth of the
# logical geometry, on meshes of cuda:0
TIERED_SMALL, TIERED_MESH_ADDS = 16, 3
TIERED_MESHES = ((1, 4, False), (2, 2, False), (2, 2, True))
# 21c: word2vec's w_in as the delta; the CPU tests' tolerance for the 1-bit
# scales and residual (tests/test_torch_quantization.py) and the bound of
# tests/test_quantization.py::test_rounding_unbiased (mean of 300 draws)
QUANT_RTOL = QUANT_ATOL = 1e-6
QUANT_DRAWS, QUANT_MEAN_ATOL = 300, 0.01
KV_LAUNCH_NAMES = ("kv_lookup", "kv_probe_update", "kv_commit")


def tier_moves(telemetry, name: str) -> dict:
    """The tier counters of table ``name``: device hits, misses, fills and
    demotions by tier, spills."""
    c = lambda n, **lb: telemetry.counter(n, table=name, **lb).value
    return dict(
        hits=c("storage.hits", tier="device"),
        misses={t: c("storage.misses", tier=t)
                for t in ("host", "disk", "virgin")},
        fills={t: c("storage.fills", tier=t)
               for t in ("host", "disk", "virgin")},
        demotions={t: c("storage.demotions", tier=t)
                   for t in ("host", "disk")},
        spills=c("storage.spills"))


def moves_since(before: dict, after: dict) -> dict:
    return {k: ({t: after[k][t] - v for t, v in before[k].items()}
                if isinstance(before[k], dict) else after[k] - before[k])
            for k in before}


def timed_probes(torch, table) -> list:
    """Bracket each probe + commit call of ``table`` by CUDA events; the
    (start, end) pairs land in the returned list."""
    spans, inner = [], table._probe_update

    def timed(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(*args, **kw)
        end.record()
        spans.append((start, end))
        return out
    table._probe_update = timed
    return spans


def chunks_of(t, keys) -> int:
    """How many chunks a tiered op on ``keys`` takes."""
    return len(t._chunk_spans(np.sort(t._buckets_of(keys))))


def launches_into(tk, total: dict, before: dict) -> dict:
    grown = {k: tk.LAUNCHES[k] - before[k] for k in KV_LAUNCH_NAMES}
    for k, v in grown.items():
        total[k] += v
    return grown


def tiered_add(torch, tk, t, keys, deltas, spans, launches) -> dict:
    """One add through the tiers, synced: its chunks, the host ms of the
    fault-in by part, the probe + commit's device ms (CUDA events around
    the launches) and its wall ms; one probe and one commit a chunk."""
    chunks = chunks_of(t, keys)
    f0, n0, before = dict(t.fault_in_s), len(spans), dict(tk.LAUNCHES)
    t0 = time.perf_counter()
    t.add(keys, deltas)
    t.wait()
    wall = time.perf_counter() - t0
    grown = launches_into(tk, launches, before)
    if grown != {"kv_lookup": 0, "kv_probe_update": chunks,
                 "kv_commit": chunks}:
        raise SystemExit(f"{t.name}: an add of {chunks} chunk(s) launched "
                         f"{grown}")
    return dict(keys=len(keys), chunks=chunks, wall_ms=1e3 * wall,
                device_ms=sum(s.elapsed_time(e) for s, e in spans[n0:]),
                **{f"{k}_ms": 1e3 * (t.fault_in_s[k] - f0[k])
                   for k in f0})


def tiered_get(torch, tk, t, q, launches) -> tuple:
    """A tiered Get of ``q``: one lookup a chunk."""
    chunks = chunks_of(t, q)
    before = dict(tk.LAUNCHES)
    vals, found = t.get_tensor(q)
    grown = launches_into(tk, launches, before)
    if grown["kv_lookup"] != chunks or grown["kv_probe_update"]:
        raise SystemExit(f"{t.name}: a Get of {chunks} chunk(s) launched "
                         f"{grown}")
    return vals, found, chunks


def same_get(torch, a, b) -> bool:
    return torch.equal(a[1], b[1]) and same_bits(torch, a[0], b[0])


def same_export(a: dict, b: dict, keys) -> bool:
    """Two checkpoint payloads' ``keys`` arrays byte for byte."""
    return all(a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
               and np.array_equal(a[k].view(np.uint8), b[k].view(np.uint8))
               for k in keys)


def content_keys(payload: dict) -> list:
    return ["keys", "values", "bucket_fill"] + sorted(
        k for k in payload if k.startswith("state_"))


def phase_tiered_kv(torch, tk, KVTable, TieredKVTable, AddOption, tckpt,
                    telemetry, adds, tmp: str, card: str) -> dict:
    """Phase 21a (see TIERED_*): phase 10's first adds replayed through a
    TieredKVTable on cuda:0 and a plain 2^24-slot KVTable of the same
    geometry. After each add a Get of its keys and of 1,000 keys never
    added equals the plain table's bit for bit; after the second, one Get
    of the first two adds' keys (shuffled) takes more than one chunk and
    equals the plain table's, in the caller's order; a RunCheckpointManager
    generation after the third; at the end every tier holds buckets, some
    came back from disk, and the export's keys, values, bucket_fill and
    state equal the plain table's bit for bit. Then a fresh tiered table
    resumed from the generation (every tier populated again) finishes the
    replay, and its export equals the uninterrupted run's. One probe and
    one commit an add chunk, one lookup a Get chunk. Returns the numbers."""
    free_tables(torch)
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()

    def tiered(sub: str):
        return TieredKVTable(
            TIERED_CAPACITY, value_dim=2, slots_per_bucket=TIERED_SLOTS,
            updater="ftrl", device="cuda:0", name="smoke_tiered",
            default_option=AddOption.for_ftrl(0.1),
            device_buckets=TIERED_DEVICE, host_buckets=TIERED_HOST,
            spill_dir=os.path.join(tmp, sub))
    t = tiered("a")
    plain = KVTable(TIERED_CAPACITY, value_dim=2,
                    slots_per_bucket=TIERED_SLOTS,
                    updater="ftrl", device="cuda:0",
                    name="smoke_tiered_plain",
                    default_option=AddOption.for_ftrl(0.1))
    geometry = (t.total_buckets, plain.num_buckets, t.tiers.device_buckets,
                t.tiers.host.capacity, t.spec.payload_nbytes,
                t.tiers.disk.record_nbytes)
    if geometry != (TIERED_BUCKETS, TIERED_BUCKETS, TIERED_DEVICE,
                    TIERED_HOST, 256, 272) or not t.tiers.host.pinned:
        raise SystemExit(f"tiered table geometry {geometry}, pinned "
                         f"{t.tiers.host.pinned}")
    spans = timed_probes(torch, t)
    launches = dict.fromkeys(KV_LAUNCH_NAMES, 0)
    missing = kv_keys(np.random.default_rng(21), 1000) | np.uint64(1 << 62)
    run_dir = os.path.join(tmp, "run")
    mgr = tckpt.RunCheckpointManager(run_dir, keep=1, tables=[t],
                                     background=False)
    moves0 = tier_moves(telemetry, t.name)
    replay = [(k[:len(k) // TIERED_SCALE], d[:len(k) // TIERED_SCALE])
              for k, d in adds[:TIERED_ADDS]]
    per_add, out = [], {}
    for i, (keys, deltas) in enumerate(replay):
        r = tiered_add(torch, tk, t, keys, deltas, spans, launches)
        plain.add(keys, deltas)
        plain.wait()
        q = np.concatenate([keys, missing])
        got = tiered_get(torch, tk, t, q, launches)
        if not same_get(torch, got, plain.get_tensor(q)):
            raise SystemExit(f"tiered: the Get after add {i} differs from "
                             "the plain table's")
        r["counts"] = t.tiers.counts()
        per_add.append(r)
        log(f"  21a add {i}: {r['keys']} keys, {r['chunks']} chunk(s); "
            f"host plan {r['plan_ms']:.1f} ms, demote {r['demote_ms']:.1f} "
            f"ms, fill {r['fill_ms']:.1f} ms; probe + commit "
            f"{r['device_ms']:.3f} ms on the card; wall {r['wall_ms']:.1f} "
            f"ms; buckets by tier {r['counts']}")
        if i == 1:
            u = np.unique(np.concatenate([replay[0][0], replay[1][0]]))
            u = u[np.random.default_rng(22).permutation(len(u))]
            t0 = time.perf_counter()
            got = tiered_get(torch, tk, t, u, launches)
            union_ms = 1e3 * (time.perf_counter() - t0)
            if got[2] < 2 or not same_get(torch, got,
                                          plain.get_tensor(u)):
                raise SystemExit(f"tiered: the Get of {len(u)} keys took "
                                 f"{got[2]} chunk(s) or differs from the "
                                 "plain table's")
            out["union_get"] = dict(keys=len(u), chunks=got[2],
                                    wall_ms=union_ms)
            log(f"  21a one Get of the first two adds' {len(u)} keys "
                f"(shuffled): {got[2]} chunks, {union_ms:.1f} ms, equal to "
                "the plain table's in the caller's order")
        if i + 1 == TIERED_SAVE_AT:
            t0 = time.perf_counter()
            mgr.save(i + 1, {"round": i + 1})
            out["save_s"] = time.perf_counter() - t0
            out["counts_at_save"] = t.tiers.counts()
    mgr.close()
    moves = moves_since(moves0, tier_moves(telemetry, t.name))
    counts = t.tiers.counts()
    if min(counts["device"], counts["host"], counts["disk"],
           *out["counts_at_save"].values()) <= 0 \
            or moves["demotions"]["host"] <= 0 \
            or moves["fills"]["disk"] <= 0:
        raise SystemExit(f"tiered: tiers {counts} (at the save "
                         f"{out['counts_at_save']}), moves {moves}")
    t0 = time.perf_counter()
    ea = t.export_checkpoint_async()()[1]
    export_s = time.perf_counter() - t0
    ep = plain.export_checkpoint_async()()[1]
    if not same_export(ea, ep, content_keys(ep)):
        raise SystemExit("tiered: the export differs from the plain "
                         "table's")
    del ep
    spill_bytes = os.path.getsize(t.tiers.disk.path)
    total = sum(moves["misses"].values()) + moves["hits"]
    miss_ratio = sum(moves["misses"].values()) / total

    b = tiered("b")
    t0 = time.perf_counter()
    st = tckpt.RunCheckpointManager(run_dir, keep=1, tables=[b],
                                    background=False).resume()
    resume_s = time.perf_counter() - t0
    resumed_counts = b.tiers.counts()
    if st is None or st.state["round"] != TIERED_SAVE_AT \
            or min(resumed_counts[k] for k in ("device", "host",
                                               "disk")) <= 0:
        raise SystemExit(f"tiered: resumed {st and st.state} with tiers "
                         f"{resumed_counts}")
    b_spans = timed_probes(torch, b)
    b_adds = [tiered_add(torch, tk, b, keys, deltas, b_spans,
                         dict.fromkeys(KV_LAUNCH_NAMES, 0))
              for keys, deltas in replay[TIERED_SAVE_AT:]]
    eb = b.export_checkpoint_async()()[1]
    if not same_export(eb, ea, content_keys(ea)):
        raise SystemExit("tiered: the resumed run's export differs from "
                         "the uninterrupted run's")
    placement_same = bool(np.array_equal(eb["tier_of"], ea["tier_of"]))
    peak = torch.cuda.max_memory_allocated(0) / 1e9
    out.update(adds=per_add, resumed_adds=b_adds, launches=launches,
               moves=moves, miss_ratio=miss_ratio, counts=counts,
               resumed_counts=resumed_counts, resume_s=resume_s,
               export_s=export_s, spill_file_bytes=spill_bytes,
               disk_records=len(t.tiers.disk),
               resumed_placement_same=placement_same, peak_mem_gb=peak,
               seconds=time.perf_counter() - t_phase)
    log(f"  21a {TIERED_ADDS} adds of phase 10 through the tiers "
        f"({TIERED_BUCKETS} logical buckets of {TIERED_SLOTS}; "
        f"{TIERED_DEVICE} on the card, {TIERED_HOST} in the pinned arena): "
        f"every Get and the export equal to the plain 2^24-slot table's "
        f"bit for bit; miss ratio {miss_ratio:.4f}; demotions "
        f"{moves['demotions']}, fills {moves['fills']}, spills "
        f"{moves['spills']}; buckets by tier {counts}; spill file "
        f"{spill_bytes} bytes ({len(t.tiers.disk)} records); launches "
        f"{launches}; generation after add {TIERED_SAVE_AT} in "
        f"{out['save_s']:.1f} s (tiers {out['counts_at_save']}), resumed "
        f"in {resume_s:.1f} s (tiers {resumed_counts}), the resumed run's "
        f"export equal to the uninterrupted run's (placement "
        f"{'the same' if placement_same else 'different'}); export "
        f"{export_s:.1f} s; cuda:0 peak {peak:.2f} GB; "
        f"{out['seconds']:.1f} s; on {card}")
    del t, b, plain, ea, eb
    free_tables(torch)
    return out


def phase_tiered_meshes(torch, tk, core, TieredKVTable, AddOption, adds,
                        tmp: str, card: str) -> dict:
    """Phase 21b: the tiered table on (1, 4) and (2, 2) meshes of cuda:0
    (with and without shard_update) beside a (1, 1) one, at a sixteenth of
    21a's geometry and keys (the same budgets' ratios): after each add the
    replicas identical, one probe and one commit a card per add chunk, and
    a Get of its keys and of keys never added (one lookup a card per Get
    chunk) bit for bit the (1, 1) table's; at the end every export array,
    tier_of included."""
    t_phase = time.perf_counter()
    cap = SLR_CAPACITY // TIERED_SMALL

    def make(name, **where):
        return TieredKVTable(
            cap, value_dim=2, slots_per_bucket=TIERED_SLOTS, updater="ftrl",
            name=name, default_option=AddOption.for_ftrl(0.1),
            device_buckets=cap // TIERED_SLOTS // 16,
            host_buckets=cap // TIERED_SLOTS // 32,
            spill_dir=os.path.join(tmp, name), **where)
    one = make("tiered_1x1", device="cuda:0")
    tabs = {key: make(f"tiered_{key[0]}x{key[1]}_{key[2]}",
                      mesh=core._build_mesh(["cuda:0"] * (key[0] * key[1]),
                                            key[0], key[1]),
                      shard_update=key[2])
            for key in TIERED_MESHES}
    n = len(adds[0][0]) // TIERED_SMALL
    missing = kv_keys(np.random.default_rng(23), 500) | np.uint64(1 << 62)
    chunks = get_chunks = 0
    for i, (keys, deltas) in enumerate(adds[:TIERED_MESH_ADDS]):
        keys, deltas = keys[:n], deltas[:n]
        c = chunks_of(one, keys)
        chunks += c
        one.add(keys, deltas)
        one.wait()
        q = np.concatenate([keys, missing])
        want = one.get_tensor(q)
        for key, t in tabs.items():
            before = dict(tk.LAUNCHES)
            t.add(keys, deltas)
            t.wait()
            grown = {k: tk.LAUNCHES[k] - before[k] for k in
                     ("kv_probe_update", "kv_commit",
                      "kv_probe_update_sharded")}
            if grown != dict.fromkeys(grown, c):
                raise SystemExit(f"{t.name}: add {i} of {c} chunk(s) "
                                 f"launched {grown}")
            if not kv_replicas_identical(torch, t):
                raise SystemExit(f"{t.name}: the replicas differ after add "
                                 f"{i}")
            cg = chunks_of(t, q)
            before = dict(tk.LAUNCHES)
            got = t.get_tensor(q)
            grown = {k: tk.LAUNCHES[k] - before[k] for k in
                     ("kv_lookup", "kv_lookup_sharded")}
            if grown != dict.fromkeys(grown, cg) \
                    or not same_get(torch, got, want):
                raise SystemExit(f"{t.name}: the Get after add {i} ({cg} "
                                 f"chunk(s), launched {grown}) differs from "
                                 "the (1, 1) table's")
            get_chunks += cg
    po = one.export_checkpoint_async()()[1]
    for key, t in tabs.items():
        if not same_export(t.export_checkpoint_async()()[1], po, list(po)):
            raise SystemExit(f"{t.name}: its export differs from the (1, 1) "
                             "table's")
    counts = one.tiers.counts()
    if min(counts["device"], counts["host"], counts["disk"]) <= 0:
        raise SystemExit(f"tiered (1, 1) small: tiers {counts}")
    get_chunks //= len(tabs)
    out = dict(keys_per_add=n, chunks=chunks, get_chunks=get_chunks,
               counts=counts, seconds=time.perf_counter() - t_phase)
    log(f"  21b {TIERED_MESH_ADDS} adds of {n} keys on "
        f"{', '.join(t.name for t in tabs.values())} beside tiered_1x1 "
        f"({cap // TIERED_SLOTS} logical buckets): replicas identical, one "
        f"probe and one commit a card per add chunk ({chunks} a table), one "
        f"lookup a card per Get chunk ({get_chunks} a table), every Get "
        f"and export bit for bit the (1, 1) table's; tiers "
        f"{counts}; {out['seconds']:.1f} s; on {card}")
    del one, tabs
    free_tables(torch)
    return out


def phase_quantizers(torch, quant, card: str) -> dict:
    """Phase 21c: the quantizers on cuda:0 at word2vec's w_in (10,001 x
    100 float32). OneBitQuantizer against the same call on the CPU: signs
    and packed signs bit for bit, scales and residual within the CPU
    tests' tolerance, pack / unpack exact. RoundingQuantizer (int8) with a
    generator on the card: every q within [-127, 127], every element
    within one grid step, and the mean of 300 draws within 0.01 of the
    delta. Times (CUDA events)."""
    rng = np.random.default_rng(24)
    x = rng.standard_normal((ROWS, DIM)).astype(np.float32)
    r = (0.1 * rng.standard_normal((ROWS, DIM))).astype(np.float32)
    xh, rh = torch.from_numpy(x), torch.from_numpy(r)
    xc, rc = xh.cuda(), rh.cuda()
    q = quant.OneBitQuantizer()
    got = q.quantize(xc, rc)
    want = q.quantize(xh, rh)
    packed = q.pack_signs(got[0])
    ok = (torch.equal(got[0].cpu(), want[0])
          and torch.equal(packed.cpu(), q.pack_signs(want[0]))
          and torch.equal(q.unpack_signs(packed), got[0])
          and packed.shape == (got[0].shape[0], got[0].shape[1] // 8))
    errs = [float(((a.cpu() - b).abs() - QUANT_RTOL * b.abs()).max())
            for a, b in zip(got[1:], want[1:])]
    if not ok or max(errs) > QUANT_ATOL:
        raise SystemExit(f"1-bit quantizer on the card: signs/packing "
                         f"{ok}, scale/residual excess {errs}")
    rq = quant.RoundingQuantizer(bits=8)
    gen = torch.Generator(device="cuda").manual_seed(0)
    qq, scale = rq.quantize(xc, gen)
    deq = rq.dequantize(qq, scale, x.shape).cpu().numpy()
    step = np.repeat(scale.cpu().numpy(), rq.block)[:x.size].reshape(
        x.shape)
    acc = torch.zeros_like(xc)
    for _ in range(QUANT_DRAWS):
        acc += rq.dequantize(*rq.quantize(xc, gen), x.shape)
    mean_err = float((acc / QUANT_DRAWS - xc).abs().max())
    if qq.dtype != torch.int8 or int(qq.abs().max()) > 127 \
            or not np.all(np.abs(deq - x) <= step + 1e-6) \
            or mean_err > QUANT_MEAN_ATOL:
        raise SystemExit(f"rounding quantizer on the card: {qq.dtype}, "
                         f"|q| max {int(qq.abs().max())}, mean error "
                         f"{mean_err}")
    out = dict(one_bit_ms=cuda_ms(lambda: q.quantize(xc, rc), 10),
               pack_ms=cuda_ms(lambda: q.pack_signs(got[0]), 10),
               rounding_ms=cuda_ms(lambda: rq.quantize(xc, gen), 10),
               scale_residual_excess=errs, rounding_mean_error=mean_err)
    log(f"  21c quantizers on {x.shape}: 1-bit signs and packing bit for "
        f"bit the CPU's, scales/residual within rtol {QUANT_RTOL} + atol "
        f"{QUANT_ATOL}; int8 rounding in range, within a step, mean of "
        f"{QUANT_DRAWS} draws off by {mean_err:.5f}; 1-bit "
        f"{out['one_bit_ms']:.3f} ms, pack {out['pack_ms']:.3f} ms, "
        f"rounding {out['rounding_ms']:.3f} ms; on {card}")
    return out


# phase 22: the wire server on the card. 22a replays every one of phase
# 10's adds over the wire; 22d reads WIRE_PROBE_KEYS of them (and as many
# keys never added) with a staleness bound of WIRE_STALENESS generations
# after each; 22b's four workers each pipeline WIRE_WORKER_ADDS adds of
# WIRE_WORKER_KEYS keys; 22c's storm replays WIRE_STORM_ADDS of phase 10's
# adds, and its SIGKILL victim would send WIRE_KILL_ADDS
WIRE_STALENESS, WIRE_PROBE_KEYS = 8, 4096
WIRE_WORKER_ADDS, WIRE_WORKER_KEYS = 16, 65_536
WIRE_STORM_ADDS, WIRE_KILL_ADDS = 6, 400
WIRE_STORM = ("seed=5;wire.send:drop:times=3;wire.send:torn:after=4,"
              "times=2;wire.recv:drop:times=2")
WIRE_FUSE = 16
# every 22a request lands in the server's exemplar ring
WIRE_EXEMPLARS = 512

# one worker's adds, shared by the worker processes and the check: add j
# of worker ``rank`` overlaps its neighbours' (each worker starts half a
# batch after the last, each add a quarter batch after the last, cycling
# over four), with small integer deltas, whose float32 sums are exact
WIRE_ADD_SRC = '''
def worker_add(rank, j, n):
    start = (rank * n) // 2 + (j % 4) * (n // 4)
    keys = (np.arange(start, start + n, dtype=np.uint64)
            * np.uint64(0x9E3779B1) + np.uint64(1))
    base = (keys % np.uint64(5)).astype(np.float32) + 1 + rank
    return keys, np.stack([base, 2 * base - (j % 3)], axis=1)
'''
_wire_ns = {"np": np}
exec(WIRE_ADD_SRC, _wire_ns)
worker_add = _wire_ns["worker_add"]

# a worker process: the port's transport loaded by file path, no torch
WIRE_WORKER_SRC = '''
import importlib.util, json, os, sys, time
import numpy as np
pkg, addr, rank, adds, n, name, cap = sys.argv[1:8]
spec = importlib.util.spec_from_file_location(
    "multiverso_tpu_torch.client.transport",
    os.path.join(pkg, "client", "transport.py"))
transport = importlib.util.module_from_spec(spec)
sys.modules[spec.name] = transport
spec.loader.exec_module(transport)
assert "torch" not in sys.modules and "jax" not in sys.modules
''' + WIRE_ADD_SRC + '''
rank, adds, n = int(rank), int(adds), int(n)
c = transport.connect(addr, client=f"w{rank}", quant=None)
t = c.create_kv(name, int(cap), value_dim=2)
t0 = time.perf_counter()
for j in range(adds):
    t.add(*worker_add(rank, j, n))
    print(json.dumps({"rank": rank, "step": j}), flush=True)
c.drain()
dt = time.perf_counter() - t0
print(json.dumps({"rank": rank, "done": True, "seconds": dt,
                  "tx_bytes": c.tx_bytes, "rx_bytes": c.rx_bytes,
                  "transport": c.transport, "torch": "torch" in sys.modules}),
      flush=True)
c.close()
'''


def pct(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q))


def grown_since(tk, before: dict) -> dict:
    return {k: tk.LAUNCHES[k] - before[k] for k in KV_LAUNCH_NAMES}


def server_errors(telemetry) -> float:
    """Handler errors the wire servers of this process replied so far."""
    snap = telemetry.snapshot()
    return sum(v for k, v in snap.get("counters", {}).items()
               if k.startswith("wire.server.errors"))


def same_reply(arrays, want) -> bool:
    return len(arrays) == 2 and all(
        a.dtype == w.dtype and a.shape == w.shape
        and a.tobytes() == w.tobytes() for a, w in zip(arrays, want))


def wire_replay(torch, tk, KVTable, TableServer, transport, tchaos,
                telemetry, adds, tmp: str, card: str) -> dict:
    """22a + 22d + 22c's storm: phase 10's adds as kv_add frames into a
    TableServer on cuda:0 (fuse 1), each followed by a kv_get of its keys
    and a staleness read of the probe keys from a second client; a local
    KVTable on cuda:0 fed the same adds. Every Get, every replica answer
    (at its generation) and the export equal the local table's bit for
    bit. Then the storm over two fresh tables of the same server."""
    name = "smoke_wire_a"
    os.environ["MVTPU_SERVER_EXEMPLARS"] = str(WIRE_EXEMPLARS)
    try:
        s = TableServer(f"unix:{tmp}/a.sock", name=name, device="cuda:0",
                        fuse=1)
    finally:
        del os.environ["MVTPU_SERVER_EXEMPLARS"]
    addr = s.start()
    local = KVTable(SLR_CAPACITY, value_dim=2, updater="ftrl",
                    device="cuda:0", name="smoke_wire_local")
    hits = telemetry.counter("server.replica.hits", server=name)
    launches = dict.fromkeys(KV_LAUNCH_NAMES, 0)
    add_ms, get_ms, stale = [], [], []
    try:
        with transport.connect(addr, client="slr", quant=None) as c, \
                transport.connect(addr, client="reader",
                                  quant=None) as rd:
            t = c.create_kv("wire_slr", SLR_CAPACITY, value_dim=2,
                            updater="ftrl")
            table = s._tables[t.table_id]
            if table.device.type != "cuda" or table.num_buckets \
                    != local.num_buckets or t.dtype != np.float32:
                raise SystemExit(f"wire: the served table lies on "
                                 f"{table.device}, {table.num_buckets} "
                                 f"buckets, {t.dtype}")
            spans = timed_probes(torch, table)
            missing = kv_keys(np.random.default_rng(23),
                              WIRE_PROBE_KEYS) | np.uint64(1 << 62)
            probe = np.concatenate([adds[0][0][:WIRE_PROBE_KEYS],
                                    missing])
            at_gen = {0: local.get(probe)}

            def stale_read(gen_now: int) -> None:
                before = dict(tk.LAUNCHES)
                t0 = time.perf_counter()
                hdr, arrays = rd.call("kv_get", {
                    "table": t.table_id, "staleness": WIRE_STALENESS},
                    [probe])
                wall = 1e3 * (time.perf_counter() - t0)
                grown = grown_since(tk, before)
                if hdr.get("replica"):
                    gen, lag = int(hdr["gen"]), int(hdr["staleness"])
                    ok = (lag <= WIRE_STALENESS and lag == gen_now - gen
                          and not hdr.get("relaxed")
                          and not hdr.get("degraded")
                          and same_reply(arrays, at_gen[gen])
                          and not any(grown.values()))
                else:
                    gen, lag = gen_now, 0
                    ok = (same_reply(arrays, at_gen[gen_now])
                          and grown["kv_lookup"] == 1)
                    launches["kv_lookup"] += grown["kv_lookup"]
                if not ok:
                    raise SystemExit(f"wire 22d: a staleness read at "
                                     f"generation {gen_now} ({hdr}) "
                                     "differs from the local table at "
                                     f"its generation, or launched "
                                     f"{grown}")
                stale.append(dict(replica=bool(hdr.get("replica")),
                                  gen=gen, lag=lag, wall_ms=wall))

            for i, (keys, deltas) in enumerate(adds):
                before = dict(tk.LAUNCHES)
                t0 = time.perf_counter()
                t.add(keys, deltas, sync=True)
                add_ms.append(1e3 * (time.perf_counter() - t0))
                grown = grown_since(tk, before)
                before = dict(tk.LAUNCHES)
                t0 = time.perf_counter()
                got = t.get(keys)
                get_ms.append(1e3 * (time.perf_counter() - t0))
                g2 = grown_since(tk, before)
                if grown != {"kv_lookup": 0, "kv_probe_update": 1,
                             "kv_commit": 1} or g2 != {
                        "kv_lookup": 1, "kv_probe_update": 0,
                        "kv_commit": 0}:
                    raise SystemExit(f"wire 22a: add {i} launched "
                                     f"{grown}, its Get {g2}")
                for k in KV_LAUNCH_NAMES:
                    launches[k] += grown[k] + g2[k]
                local.add(keys, deltas)
                if not same_reply(list(got), local.get(keys)):
                    raise SystemExit(f"wire 22a: the Get after add {i} "
                                     "differs from the local table's")
                at_gen[i + 1] = local.get(probe)
                stale_read(i + 1)
            # the replica catches up with the last add: poll until a
            # read is answered on a reader thread
            deadline = time.monotonic() + 60
            while not any(r["replica"] for r in stale) \
                    and time.monotonic() < deadline:
                stale_read(len(adds))
                time.sleep(0.05)
            if not any(r["replica"] for r in stale) or hits.value <= 0:
                raise SystemExit("wire 22d: no staleness read was "
                                 "answered off the replica")
            exemplars = s.slow_exemplars()
            torch.cuda.synchronize()
            device_ms = [a.elapsed_time(b) for a, b in spans]
            ea = table.export_checkpoint_async()()[1]
            el = local.export_checkpoint_async()()[1]
            if not same_export(ea, el, content_keys(el)):
                raise SystemExit("wire 22a: the served table's export "
                                 "differs from the local table's")
            del ea, el
            status = s.status()
        # the server keeps its tables alive; the local one goes
        del local, table
        free_tables(torch)
        storm = wire_storm(torch, s, transport, tchaos, addr,
                           adds[:WIRE_STORM_ADDS])
    finally:
        s.stop()
    n_req = 2 * len(adds)
    by_op = {op: [r for r in exemplars
                  if r["op"] == op and r["client"] == "slr"]
             for op in ("kv_add", "kv_get")}
    stages = {op: dict(queue_ms=pct([r["stages"]["queue_ms"] for r in rows],
                                    50),
                       execute_ms=pct([r["stages"]["execute_ms"]
                                       for r in rows], 50),
                       execute_ms_p99=pct([r["stages"]["execute_ms"]
                                           for r in rows], 99),
                       n=len(rows))
              for op, rows in by_op.items() if rows}
    out = dict(adds=len(adds), keys_per_add=float(np.mean(
                   [len(k) for k, _ in adds])),
               requests_per_sec=n_req / (1e-3 * (sum(add_ms)
                                                 + sum(get_ms))),
               kv_add_ms=dict(p50=pct(add_ms, 50), p99=pct(add_ms, 99)),
               kv_get_ms=dict(p50=pct(get_ms, 50), p99=pct(get_ms, 99)),
               device_ms_per_add=dict(p50=pct(device_ms, 50),
                                      mean=float(np.mean(device_ms))),
               stages=stages, slowest=exemplars[:4], launches=launches,
               stale_reads=len(stale),
               replica_hits=sum(r["replica"] for r in stale),
               replica_lags=sorted({r["lag"] for r in stale
                                    if r["replica"]}),
               replica_wall_ms=pct([r["wall_ms"] for r in stale
                                    if r["replica"]], 50),
               fused=status["fused"], storm=storm)
    log(f"  22a {len(adds)} kv_add frames of {out['keys_per_add']:.0f} "
        f"keys (ftrl, 2^25 slots) and their kv_gets: every Get and the "
        f"export bit for bit the local table's; {out['requests_per_sec']:.1f}"
        f" requests/s; kv_add wall p50 {out['kv_add_ms']['p50']:.2f} / p99 "
        f"{out['kv_add_ms']['p99']:.2f} ms, kv_get p50 "
        f"{out['kv_get_ms']['p50']:.2f} / p99 {out['kv_get_ms']['p99']:.2f}"
        f" ms; server stages (median queue / execute ms) "
        + "; ".join(f"{op} {r['queue_ms']:.3f} / {r['execute_ms']:.2f}"
                    for op, r in stages.items())
        + f"; probe + commit {out['device_ms_per_add']['p50']:.3f} ms a "
        f"kv_add on the card; launches {launches}; on {card}")
    log(f"  22d {len(stale)} staleness reads (bound {WIRE_STALENESS}): "
        f"{out['replica_hits']} answered off the replica on a reader "
        f"thread (lags {out['replica_lags']}, median wall "
        f"{out['replica_wall_ms']:.2f} ms), each equal to the local table "
        f"at its generation")
    log(f"  22a slowest requests: "
        + "; ".join(f"{r['op']} {r['total_ms']:.1f} ms (queue "
                    f"{r['stages']['queue_ms']:.1f}, execute "
                    f"{r['stages']['execute_ms']:.1f})"
                    for r in out["slowest"]))
    return out


def wire_storm(torch, s, transport, tchaos, addr, adds) -> dict:
    """22c's storm: the same adds pipelined into two fresh ftrl tables of
    the server, quiet and under WIRE_STORM (wire.send drop and torn,
    wire.recv drop, process-wide: the server's sends and reads too). The
    tables end bit for bit equal: dedup keeps every replay exactly-once."""
    with transport.connect(addr, client="storm", quant=None) as c:
        quiet = c.create_kv("wire_quiet", SLR_CAPACITY, value_dim=2,
                            updater="ftrl")
        for keys, deltas in adds:
            quiet.add(keys, deltas)
        c.drain()
        stormy = c.create_kv("wire_stormy", SLR_CAPACITY, value_dim=2,
                             updater="ftrl")
        t0 = time.perf_counter()
        tchaos.install_chaos(WIRE_STORM)
        try:
            for keys, deltas in adds:
                stormy.add(keys, deltas)
            c.drain()
        finally:
            tchaos.uninstall_chaos()
        storm_s = time.perf_counter() - t0
        reconnects = c.reconnects
    a, b = s._tables[quiet.table_id], s._tables[stormy.table_id]
    same = same_shards(torch, (a.key_shards, a.value_shards,
                               a.state_shards),
                       (b.key_shards, b.value_shards, b.state_shards))
    if not same or reconnects < 1 or a.generation != b.generation:
        raise SystemExit(f"wire 22c: the storm's table equal to the quiet "
                         f"one: {same}, reconnects {reconnects}, "
                         f"generations {a.generation} / {b.generation}")
    log(f"  22c storm ({WIRE_STORM}) over {len(adds)} pipelined kv_adds: "
        f"{reconnects} reconnects, {storm_s:.2f} s, the table bit for bit "
        "the quiet run's")
    return dict(adds=len(adds), reconnects=reconnects, seconds=storm_s)


def spawn_worker(script: str, addr: str, rank: int, adds: int, n: int,
                 name: str, cap: int):
    return subprocess.Popen(
        [sys.executable, script, os.path.join(HERE, "multiverso_tpu_torch"),
         addr, str(rank), str(adds), str(n), name, str(cap)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def worker_result(proc, timeout: float = 300) -> dict:
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise SystemExit("wire: a worker process timed out")
    lines = [json.loads(x) for x in out.splitlines() if x.strip()]
    if proc.returncode != 0 or not lines or not lines[-1].get("done") \
            or lines[-1].get("torch"):
        raise SystemExit(f"wire: worker exited {proc.returncode}: "
                         f"{err[-2000:]}")
    return lines[-1]


def wire_fusion_run(torch, tk, TableServer, transport, telemetry,
                    script: str, tmp: str, fuse: int, tag: str,
                    union: np.ndarray, kill: bool) -> dict:
    """22b: four torch-free worker processes (unix, TCP, shm, shm)
    pipeline their adds into a fresh server on cuda:0 (``fuse``); the
    union of their keys is read back. With ``kill`` (22c) a victim worker
    is SIGKILLed mid-stream while a survivor and then a fresh worker
    finish on the same server."""
    name = f"smoke_wire_{tag}"
    s = TableServer(f"unix:{tmp}/{tag}.sock,tcp:127.0.0.1:0,"
                    f"shm://{tmp}/{tag}-shm.sock", name=name,
                    device="cuda:0", fuse=fuse)
    addrs = s.start().split(",")
    groups = telemetry.counter("server.fuse.groups", server=name)
    frames = telemetry.counter("server.fuse.frames", server=name)
    out = {}
    try:
        before = dict(tk.LAUNCHES)
        t0 = time.perf_counter()
        procs = [spawn_worker(script, a, r, WIRE_WORKER_ADDS,
                              WIRE_WORKER_KEYS, "wire_fused", SLR_CAPACITY)
                 for r, a in enumerate([addrs[0], addrs[1], addrs[2],
                                        addrs[2]])]
        workers = [worker_result(p) for p in procs]
        wall = time.perf_counter() - t0
        launches = grown_since(tk, before)
        n_frames = 4 * WIRE_WORKER_ADDS
        n_groups, n_fused = int(groups.value), int(frames.value)
        singles = n_frames - n_fused
        if launches != {"kv_lookup": 0, "kv_probe_update": n_groups + singles,
                        "kv_commit": n_groups + singles}:
            raise SystemExit(f"wire 22b ({tag}): {launches} for "
                             f"{n_groups} fused groups and {singles} "
                             "frames alone")
        with transport.connect(addrs[0], client="check",
                               quant=None) as c:
            t = c.create_kv("wire_fused", SLR_CAPACITY, value_dim=2)
            out["values"], out["found"] = t.get(union)
            if kill:
                out["kill"] = wire_kill(script, addrs, c)
        out.update(groups=n_groups, fused_frames=n_fused, frames=n_frames, launches=launches, seconds=wall,
                   workers=[dict(w, address=a.split(":")[0]) for w, a in
                            zip(workers, [addrs[0], addrs[1], addrs[2],
                                          addrs[2]])])
    finally:
        s.stop()
    return out


def wire_kill(script: str, addrs, c) -> dict:
    """22c: SIGKILL one shm worker mid-stream; a unix survivor and then a
    fresh TCP worker finish every add on the same server."""
    cap = 1 << 22
    victim = spawn_worker(script, addrs[2], 10, WIRE_KILL_ADDS, 4096,
                          "wire_kill", cap)
    survivor = spawn_worker(script, addrs[0], 11, 8, 4096, "wire_kill",
                            cap)
    first = victim.stdout.readline()
    if not first:
        raise SystemExit("wire 22c: the victim made no progress: "
                         f"{victim.stderr.read()[-2000:]}")
    victim.send_signal(signal.SIGKILL)
    victim.wait(timeout=30)
    victim.stdout.close()
    victim.stderr.close()
    done = worker_result(survivor)
    fresh = worker_result(spawn_worker(script, addrs[1], 12, 4, 4096,
                                       "wire_kill", cap))
    if victim.returncode != -signal.SIGKILL or not c.ping():
        raise SystemExit(f"wire 22c: victim {victim.returncode}, server "
                         "not answering after the kill")
    log(f"  22c a worker SIGKILLed mid-stream (over shm): the survivor's "
        f"8 adds and a fresh worker's 4 landed, the server answers")
    return dict(victim_rc=victim.returncode,
                survivor_s=done["seconds"], fresh_s=fresh["seconds"])


def phase_wire_server(torch, tk, KVTable, TableServer, transport, tchaos,
                      telemetry, adds, card: str) -> dict:
    """Phase 22: the wire server on cuda:0 (see wire_replay and
    wire_fusion_run). Returns the numbers."""
    free_tables(torch)
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    errors0 = server_errors(telemetry)
    # set-up: the adds' deltas on the host, as a worker would send them
    host = [(np.asarray(k, np.uint64),
             d.cpu().numpy() if hasattr(d, "cpu") else np.asarray(d))
            for k, d in adds]
    with tempfile.TemporaryDirectory() as tmp:
        out = {"a": wire_replay(torch, tk, KVTable, TableServer, transport,
                                tchaos, telemetry, host, tmp, card)}
        free_tables(torch)
        script = os.path.join(tmp, "wire_worker.py")
        with open(script, "w") as f:
            f.write(WIRE_WORKER_SRC)
        keys, sums = [], []
        for r in range(4):
            for j in range(WIRE_WORKER_ADDS):
                k, d = worker_add(r, j, WIRE_WORKER_KEYS)
                keys.append(k)
                sums.append(d.astype(np.float64))
        union, inv = np.unique(np.concatenate(keys), return_inverse=True)
        want = np.zeros((len(union), 2))
        np.add.at(want, inv.reshape(-1), np.concatenate(sums))
        want = want.astype(np.float32)
        fused = wire_fusion_run(torch, tk, TableServer, transport,
                                telemetry, script, tmp, WIRE_FUSE, "b16",
                                union, kill=True)
        free_tables(torch)
        single = wire_fusion_run(torch, tk, TableServer, transport,
                                 telemetry, script, tmp, 1, "b1", union,
                                 kill=False)
        free_tables(torch)
    if fused["groups"] <= 0 or single["groups"] != 0 \
            or not (fused["found"].all() and single["found"].all()) \
            or fused["values"].tobytes() != single["values"].tobytes() \
            or fused["values"].tobytes() != want.tobytes():
        raise SystemExit(f"wire 22b: fused groups {fused['groups']}, the "
                         "fused run's table differs from the unfused run's "
                         "or from the exact sums")
    errors = server_errors(telemetry) - errors0
    if errors:
        raise SystemExit(f"wire: {errors} handler error replies")
    for run in (fused, single):
        del run["values"], run["found"]
    out.update(b=fused, b_unfused=single,
               peak_mem_gb=torch.cuda.max_memory_allocated(0) / 1e9,
               seconds=time.perf_counter() - t_phase)
    rate = {}
    for run in (fused, single):
        for w in run["workers"]:
            rate.setdefault(w["address"], []).append(
                w["tx_bytes"] / w["seconds"] / 1e6)
    out["tx_mb_per_s"] = rate
    log(f"  22b 4 torch-free workers (unix, tcp, shm, shm) x "
        f"{WIRE_WORKER_ADDS} pipelined adds of {WIRE_WORKER_KEYS} keys: "
        f"fuse {WIRE_FUSE} formed {fused['groups']} groups of "
        f"{fused['fused_frames']} frames ({fused['frames']} frames), "
        f"probe + commit {fused['launches']['kv_probe_update']} + "
        f"{fused['launches']['kv_commit']} = groups + frames alone; "
        f"{len(union)} keys bit for bit the fuse-1 run's and the exact "
        f"sums; {fused['seconds']:.2f} s fused, {single['seconds']:.2f} s "
        f"unfused; wire MB/s sent per worker "
        + "; ".join(f"{k} {[round(x, 1) for x in v]}"
                    for k, v in rate.items())
        + f"; cuda:0 peak {out['peak_mem_gb']:.2f} GB; "
        f"{out['seconds']:.1f} s; on {card}")
    return out


# phase 23: the server fleet on the card. A launcher (``python -m
# multiverso_tpu_torch.server --fleet 2 --replicas 2 --device cuda:0``)
# starts two primaries and a follower each, all processes on cuda:0; the
# port's router dials them through the fleet file. 23a replays phase 10's
# adds through the router (each rank's follower applies every forwarded
# frame itself) with a bounded read (staleness FLEET_STALENESS) after
# each; 23b SIGKILLs rank 0's primary with FLEET_KILL_ADDS more adds in
# flight; 23c grows a fresh 2-member fleet to 3 while a worker thread
# streams adds (FLEET_GROW_KEYS keys of phase 10's adds, small integer
# deltas) into a default-updater KV table and a FLEET_GROW_DENSE-element
# ArrayTable, then shrinks it back to 2
FLEET_STALENESS = 8
FLEET_KILL_ADDS = 8
# the fleet's KV tables: a member of a 2-rank fleet hashes its keys into
# its local buckets with the fleet map's own splitmix64, so it can fill
# only the half of them whose index falls in its share of the map's
# buckets (the reference's geometry; ROADMAP queue C). Twice phase 10's
# capacity gives each member as many usable slots as phase 10's table
FLEET_CAPACITY = 2 * SLR_CAPACITY
FLEET_GROW_DENSE = 1 << 22
FLEET_GROW_KEYS = 159_006
FLEET_GROW_AFTER = 4            # worker adds after the grow returned
FLEET_START_S = 180
# the router's redial budget: a dead primary costs a few redials, then
# the failover (the client default is 10 attempts within 60 s)
FLEET_RETRY = {"MVTPU_RETRY_ATTEMPTS": "4", "MVTPU_RETRY_DEADLINE_S": "10",
               "MVTPU_SHRINK_LINGER_S": "0.5",
               "MVTPU_RESHARD_TIMEOUT_S": "240"}
# the launches are a flat JSON object: match it alone, so a record that
# another member's record follows on the same line still parses
_LAUNCH_LINE = re.compile(
    r"table server '([^']+)': kernel launches (\{[^{}]*\})")


def fleet_cmd(*args: str) -> list:
    return [sys.executable, "-m", "multiverso_tpu_torch.server",
            "--device", "cuda:0", *args]


def fleet_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    return env


def card_memory_mib() -> int:
    """Device memory in use on the card, all processes (nvidia-smi)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True, check=True).stdout.split()
    return int(out[0])


def fleet_launch(tmp: str, tag: str, n: int, replicas: int,
                 env: dict = None):
    """A launcher process of ``n`` members (and their followers) on
    cuda:0, ``env`` added to the script's environment; returns
    (process, fleet file, base address, log path) once the fleet file is
    written. A member that fails to start fails the phase."""
    ffile = os.path.join(tmp, f"{tag}.fleet.json")
    base = f"unix:{tmp}/{tag}.sock"
    log_path = os.path.join(tmp, f"{tag}.log")
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(
            fleet_cmd("--fleet", str(n), "--replicas", str(replicas),
                      "--fleet-file", ffile, "--address", base,
                      "--name", tag),
            cwd=HERE, env={**fleet_env(), **(env or {})}, stdout=logf,
            stderr=subprocess.STDOUT)
    deadline = time.monotonic() + FLEET_START_S
    while not os.path.exists(ffile):
        if proc.poll() is not None or time.monotonic() > deadline:
            fleet_stop(proc, None, log_path)
            with open(log_path) as f:
                tail = f.read()[-3000:]
            raise SystemExit(f"fleet {tag}: the launcher exited "
                             f"{proc.returncode} before its members were "
                             f"up: {tail}")
        time.sleep(0.05)
    return proc, ffile, base, log_path


def fleet_pids(ffile) -> list:
    from multiverso_tpu_torch.server import partition
    doc = partition.read_fleet_file(ffile) if ffile else None
    pids = []
    for m in (doc or {}).get("members", []):
        pids.append(int(m["pid"]))
        pids += [int(r["pid"]) for r in m.get("replicas", [])]
    return pids


def fleet_stop(proc, ffile, *logs) -> dict:
    """Stop a launcher (SIGTERM reaches every member it started) and any
    member it did not start (a grown one); returns each member's kernel
    launches from the logs."""
    pids = fleet_pids(ffile)
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    for pid in pids:
        with contextlib.suppress(OSError):
            os.kill(pid, signal.SIGTERM)
    deadline = time.monotonic() + 30
    for pid in pids:
        while time.monotonic() < deadline:
            try:
                os.kill(pid, 0)
            except OSError:
                break
            time.sleep(0.05)
        with contextlib.suppress(OSError):
            os.kill(pid, signal.SIGKILL)
    launches = {}
    for path in logs:
        if path and os.path.exists(path):
            with open(path) as f:
                for m in _LAUNCH_LINE.finditer(f.read()):
                    launches[m.group(1)] = json.loads(m.group(2))
    return launches


def process_gone(pid: int, timeout: float = 30) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            os.kill(pid, 0)
        except OSError:
            return True
        time.sleep(0.02)
    return False


def replica_counts(telemetry) -> tuple:
    """The router's follower reads and fallbacks so far (all ranks)."""
    snap = telemetry.snapshot().get("counters", {})
    reads = sum(v for k, v in snap.items()
                if k.startswith("fleet.replica.reads"))
    falls = sum(v for k, v in snap.items()
                if k.startswith("fleet.replica.fallbacks"))
    return reads, falls


def followers_match(router, transport, fc, t, keys) -> None:
    """Each rank's follower answers bit for bit what its primary answers
    (staleness 0: every acked add is on the follower)."""
    owner = fc.pmap.kv_owner(keys)
    reps = router.replica_addresses(fc._fleet_file)
    for r in range(fc.pmap.n):
        mine = keys[owner == r]
        if not reps[r] or not len(mine):
            continue
        want = t.get_shard(r).get(mine)
        c = transport.WireClient(reps[r][0], client=f"check{r}",
                                 quant=None, partition=fc.pmap.to_wire())
        try:
            _, got = c.call("kv_get", {"table": t.table_id,
                                       "staleness": 0}, [mine])
        finally:
            c.close()
        if not same_reply(got, [np.asarray(w) for w in want]):
            raise SystemExit(f"fleet 23a: rank {r}'s follower differs "
                             "from its primary")


def fleet_replicate(torch, KVTable, router, transport, telemetry, adds,
                    union, ffile, card: str) -> tuple:
    """23a: phase 10's adds through the router into the fleet, a local
    KVTable on cuda:0 fed the same adds; every Get equals the local
    table's; a direct bounded read of each rank's follower records its
    lag, and a bounded read through the router counts follower hits and
    fallbacks."""
    local = KVTable(SLR_CAPACITY, value_dim=2, updater="ftrl",
                    device="cuda:0", name="smoke_fleet_local")
    fc = router.connect_fleet_file(ffile, client="slr", quant=None,
                                   read_replica=1)
    t = fc.create_kv("fleet_slr", FLEET_CAPACITY, value_dim=2,
                     updater="ftrl")
    probe = adds[0][0][:WIRE_PROBE_KEYS]
    owner = fc.pmap.kv_owner(probe)
    reps = router.replica_addresses(ffile)
    lag_clients = [transport.WireClient(reps[r][0], client=f"lag{r}",
                                        quant=None,
                                        partition=fc.pmap.to_wire())
                   for r in range(fc.pmap.n)]
    add_ms, get_ms, bounded_ms, lags = [], [], [], []
    reads0, falls0 = replica_counts(telemetry)
    try:
        for i, (keys, deltas) in enumerate(adds):
            t0 = time.perf_counter()
            t.add(keys, deltas, sync=True)
            add_ms.append(1e3 * (time.perf_counter() - t0))
            local.add(keys, deltas)
            t0 = time.perf_counter()
            got = t.get(keys)
            get_ms.append(1e3 * (time.perf_counter() - t0))
            if not same_reply(list(got), local.get(keys)):
                raise SystemExit(f"fleet 23a: the Get after add {i} "
                                 "differs from the local table's")
            for r, c in enumerate(lag_clients):
                hdr, _ = c.call("kv_get", {
                    "table": t.table_id, "staleness": FLEET_STALENESS},
                    [probe[owner == r]])
                if not hdr.get("follower"):
                    raise SystemExit(f"fleet 23a: rank {r}'s follower "
                                     f"did not answer as one: {hdr}")
                lags.append(dict(rank=r, lag=int(hdr["lag"]),
                                 reader=bool(hdr.get("replica"))))
            t0 = time.perf_counter()
            t.get(probe, staleness=FLEET_STALENESS)
            bounded_ms.append(1e3 * (time.perf_counter() - t0))
        reads, falls = replica_counts(telemetry)
        reads, falls = reads - reads0, falls - falls0
        if reads <= 0 or max(x["lag"] for x in lags) > FLEET_STALENESS:
            raise SystemExit(f"fleet 23a: {reads} follower reads, lags "
                             f"{sorted({x['lag'] for x in lags})}")
        got = t.get(union)
        if not same_reply(list(got), local.get(union)):
            raise SystemExit("fleet 23a: the fleet's table differs from "
                             "the local table")
        followers_match(router, transport, fc, t, union)
    finally:
        for c in lag_clients:
            c.close()
    out = dict(adds=len(adds),
               add_ms=dict(p50=pct(add_ms, 50), p99=pct(add_ms, 99)),
               get_ms=dict(p50=pct(get_ms, 50), p99=pct(get_ms, 99)),
               bounded_get_ms=dict(p50=pct(bounded_ms, 50),
                                   p99=pct(bounded_ms, 99)),
               follower_reads=reads, follower_fallbacks=falls,
               lags=sorted({x["lag"] for x in lags}),
               lag_reader_answers=sum(x["reader"] for x in lags),
               lag_reads=len(lags), card_mib=card_memory_mib())
    log(f"  23a {len(adds)} adds of {np.mean([len(k) for k, _ in adds]):.0f}"
        f" keys (ftrl, 2^26 slots over 2 ranks x primary + follower) "
        f"through the router: every Get and the whole table bit for bit "
        f"the local table's, each follower its primary's; add wall p50 "
        f"{out['add_ms']['p50']:.2f} / p99 {out['add_ms']['p99']:.2f} ms, "
        f"get p50 {out['get_ms']['p50']:.2f} / p99 "
        f"{out['get_ms']['p99']:.2f} ms, bounded get p50 "
        f"{out['bounded_get_ms']['p50']:.2f} ms; follower reads {reads}, "
        f"fallbacks {falls}; follower lags {out['lags']} (bound "
        f"{FLEET_STALENESS}; {out['lag_reader_answers']} of "
        f"{len(lags)} answered on a reader thread); on {card}")
    return fc, t, local, out


def fleet_failover(router, fc, t, local, adds, union, ffile,
                   card: str) -> dict:
    """23b: SIGKILL rank 0's primary with adds in flight; the router
    promotes its follower. Every acked add lands exactly once: the final
    table equals the local table bit for bit."""
    from multiverso_tpu_torch.server import partition
    doc = partition.read_fleet_file(ffile)
    row0 = doc["members"][0]
    victim, heir = int(row0["pid"]), row0["replicas"][0]["addresses"][0]
    half = FLEET_KILL_ADDS // 2
    handles = []
    for keys, deltas in adds[:half]:
        handles.append(t.add(keys, deltas))
        local.add(keys, deltas)
    os.kill(victim, signal.SIGKILL)
    t_kill = time.perf_counter()
    if not process_gone(victim):
        raise SystemExit("fleet 23b: the killed primary never went away")
    keys, deltas = adds[half]
    h = t.add(keys, deltas)
    local.add(keys, deltas)
    h.wait()
    ttr = time.perf_counter() - t_kill
    for keys, deltas in adds[half + 1:FLEET_KILL_ADDS]:
        handles.append(t.add(keys, deltas))
        local.add(keys, deltas)
    for h in handles:
        h.wait()
    fc.drain()
    doc = partition.read_fleet_file(ffile)
    if fc.pmap.version != 2 or doc["members"][0]["addresses"][0] != heir:
        raise SystemExit(f"fleet 23b: map v{fc.pmap.version}, rank 0 at "
                         f"{doc['members'][0]['addresses']} (the follower "
                         f"was {heir})")
    got = t.get(union)
    if not same_reply(list(got), local.get(union)):
        raise SystemExit("fleet 23b: after the failover the fleet's table "
                         "differs from the local table")
    out = dict(adds=FLEET_KILL_ADDS, recover_s=ttr,
               map_version=fc.pmap.version)
    log(f"  23b rank 0's primary SIGKILLed with {half} adds in flight: "
        f"its follower promoted (map v{fc.pmap.version}), the first add "
        f"after the kill acked in {ttr:.2f} s; after {FLEET_KILL_ADDS} "
        f"adds the table is bit for bit the local table's (every acked "
        f"add exactly once); on {card}")
    return out


# phase 24: fleet observability and control on phase 23's fleet (see
# fleet_observe). The members trace spans into FLEET_TRACE_DIR of the
# fleet's temporary directory; the script's own spans of phase 24 go to
# a file beside them, which the report merges as the client trace
FLEET_TRACE_DIR = "traces"
FLEET_ENDPOINTS = ("/statusz", "/healthz", "/metrics", "/metrics?json=1",
                   "/trace", "/vars?window=30", "/topk")
# the FleetController's objective holds while no member has more than
# FLEET_CTL_EXTRA wire connections above the fleet's busiest; phase 24d
# opens one more than that to one member
FLEET_CTL_EXTRA = 2


def http_get(port: int, path: str, timeout: float = 10.0) -> tuple:
    """(status, body, ms) of one GET on a member's statusz port; an HTTP
    error status comes back, not raised."""
    import urllib.error
    import urllib.request
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as r:
            code, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, body = e.code, e.read()
    return code, body, 1e3 * (time.perf_counter() - t0)


def http_post(port: int, doc: dict, timeout: float = 10.0) -> tuple:
    """(status, reply) of one ``POST /control``."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/control", data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def statusz_doc(port: int, path: str = "/statusz") -> dict:
    code, body, _ = http_get(port, path)
    if code != 200:
        raise SystemExit(f"fleet 24: {path} on port {port} answered {code}")
    return json.loads(body)


def fuse_values(members) -> dict:
    """Each member's live ``server.fuse`` binding off its /statusz."""
    return {m["name"]: statusz_doc(m["statusz_port"])["control"]["knobs"]
            .get("server.fuse", {}).get(m["name"]) for m in members}


def merged_fleet(aggregate, members) -> tuple:
    """Every member's /metrics?json=1 and their merge."""
    snaps = [json.loads(http_get(m["statusz_port"], "/metrics?json=1")[1])
             for m in members]
    return snaps, aggregate.merge_snapshots(snaps)


def counter_sum(snap: dict, name: str, **labels) -> float:
    """The sum of a counter's series whose labels include ``labels``."""
    want = [f"{k}={v}" for k, v in labels.items()]
    total = 0.0
    for key, v in snap.get("counters", {}).items():
        base, _, rest = key.partition("{")
        if base == name and all(w in rest.rstrip("}").split(",")
                                for w in want):
            total += v
    return total


def max_gauge(snap: dict, name: str) -> float:
    return max((v for k, v in snap.get("gauges", {}).items()
                if k.partition("{")[0] == name), default=0.0)


def wait_gauge(aggregate, members, name: str, done, what: str) -> float:
    """Poll the fleet's merged gauge until ``done(value)`` (10 s)."""
    deadline = time.monotonic() + 10
    while True:
        value = max_gauge(merged_fleet(aggregate, members)[1], name)
        if done(value):
            return value
        if time.monotonic() > deadline:
            raise SystemExit(f"fleet 24d: {name} stayed {value} ({what})")
        time.sleep(0.05)


def fleet_observe(transport, fc, t, adds, ffile, tmp: str,
                  card: str) -> dict:
    """Phase 24 (a)-(e) on phase 23's fleet after 23a. Returns the
    numbers."""
    from multiverso_tpu_torch.control import controller as ctl
    from multiverso_tpu_torch.server import partition
    from multiverso_tpu_torch.telemetry import aggregate, metrics, trace
    t_phase = time.perf_counter()
    host = metrics.host_index()
    doc = partition.read_fleet_file(ffile)
    members = partition.fleet_members(doc)
    names = [m["name"] for m in members]
    if len(members) != 4 or not all(
            isinstance(m.get("statusz_port"), int) and m["statusz_port"] > 0
            for m in members):
        raise SystemExit(f"fleet 24a: statusz ports "
                         f"{[m.get('statusz_port') for m in members]}")
    # (a) each member's own endpoints
    walls = {path: [] for path in FLEET_ENDPOINTS}
    for m in members:
        port = m["statusz_port"]
        for path in FLEET_ENDPOINTS:
            code, body, ms = http_get(port, path)
            walls[path].append(ms)
            if code != 200 or not body:
                raise SystemExit(f"fleet 24a: {m['name']} {path} answered "
                                 f"{code} ({len(body)} bytes)")
        sz = statusz_doc(port)
        ctl_knobs = (sz.get("control") or {}).get("knobs", {})
        servers = (sz.get("transport") or {}).get("servers") or []
        launches = sz["kernels"].get("launches", {})
        if sz.get("kind") != "mvtpu.statusz.v1" or sz.get("pid") != m["pid"] \
                or t.name not in [x.get("name") for x in sz["tables"]] \
                or len(servers) != 1 or servers[0].get("name") != m["name"] \
                or m["name"] not in ctl_knobs.get("server.fuse", {}) \
                or not launches.get("kv_probe_update") \
                or not launches.get("kv_commit"):
            raise SystemExit(
                f"fleet 24a: {m['name']}'s /statusz: kind {sz.get('kind')}, "
                f"pid {sz.get('pid')} (fleet file {m['pid']}), tables "
                f"{[x.get('name') for x in sz['tables']]}, servers "
                f"{[x.get('name') for x in servers]}, server.fuse "
                f"{ctl_knobs.get('server.fuse')}, launches {launches}")
    # (b) the merged metrics, predicted from what 23a sent: one kv_add a
    # rank an add, one replication frame a forwarded add and a create
    snaps, fleet = merged_fleet(aggregate, members)
    sent = sum(len(np.unique(fc.pmap.kv_owner(k))) for k, _ in adds)
    got_adds = counter_sum(fleet, "wire.requests", op="kv_add")
    got_repl = counter_sum(fleet, "wire.requests", op="repl")
    primaries = sum(counter_sum(s, "wire.requests", op="kv_add")
                    for s, m in zip(snaps, members) if "idx" not in m)
    if fleet.get("hosts") != 4 or got_adds != sent or primaries != sent \
            or got_repl != sent + fc.pmap.n:
        raise SystemExit(f"fleet 24b: {fleet.get('hosts')} hosts, kv_add "
                         f"{got_adds} (primaries {primaries}), repl "
                         f"{got_repl}; 23a sent {sent} rank adds to "
                         f"{fc.pmap.n} ranks")
    # (c) the fleet view off rank 1's follower
    fol1 = next(m for m in members if m.get("rank") == 1 and "idx" in m)
    code, body, ms = http_get(fol1["statusz_port"], "/statusz?fleet=1")
    walls["/statusz?fleet=1"] = [ms]
    view = json.loads(body)
    ranges = {}
    for entry in view.get("partitions", []):
        rows = [tb for p in entry.get("partitions") or []
                for tb in p.get("tables") or [] if tb.get("name") == t.name]
        ranges[entry.get("rank")] = rows[0].get("buckets") if rows else None
    want = {r: list(fc.pmap.bucket_range(r)) for r in range(fc.pmap.n)}
    if code != 200 or ranges != want:
        raise SystemExit(f"fleet 24c: /statusz?fleet=1 on {fol1['name']} "
                         f"answered {code}, ranges {ranges} (map {want})")
    # (d) FleetController: extra connections to one member violate
    # wire.connections < bound; a check_once steps server.fuse on every
    # member; once they close, a second check moves nothing
    before = fuse_values(members)
    base = max_gauge(fleet, "wire.connections")
    bound = int(base) + FLEET_CTL_EXTRA
    spec = f"wire.connections < {bound} -> server.fuse+"
    own_trace = os.path.join(tmp, "smoke-trace.jsonl")
    prev_sink = trace.trace_path()
    trace.set_trace_file(own_trace)
    extra = []
    try:
        extra = [transport.WireClient(fol1["addresses"][0],
                                      client=f"ctl{i}", quant=None,
                                      partition=fc.pmap.to_wire())
                 for i in range(bound + 1)]
        for c in extra:
            c.call("ping", {}, [])
        wait_gauge(aggregate, members, "wire.connections",
                   lambda v: v > bound, f"bound {bound}")
        fctl = ctl.FleetController(ffile, ctl.parse_objectives(spec),
                                   confirm=1, hold=0)
        t0 = time.perf_counter()
        moved = fctl.check_once()
        check_ms = 1e3 * (time.perf_counter() - t0)
        after = fuse_values(members)
        ports = sorted(m["statusz_port"] for m in members)
        rings = [statusz_doc(m["statusz_port"])["control"]["decisions"]
                 for m in members]
        if sorted(ch["port"] for ch in moved) != ports \
                or any(after[n] == before[n] or after[n] is None
                       for n in names) \
                or not all(any(d.get("origin") == "fleet"
                               and d.get("knob") == "server.fuse"
                               and d.get("to") == after[n] for d in ring)
                           for n, ring in zip(names, rings)):
            raise SystemExit(f"fleet 24d: check_once moved {moved}; "
                             f"server.fuse {before} -> {after}")
        for c in extra:
            c.close()
        extra = []
        wait_gauge(aggregate, members, "wire.connections",
                   lambda v: v <= bound, f"bound {bound}, closed")
        t0 = time.perf_counter()
        again = fctl.check_once()
        check2_ms = 1e3 * (time.perf_counter() - t0)
        if again or fuse_values(members) != after:
            raise SystemExit(f"fleet 24d: a healthy check moved {again}")
    finally:
        for c in extra:
            c.close()
        trace.set_trace_file(prev_sink)
    for m in members:
        code, reply = http_post(m["statusz_port"], {
            "op": "set", "knob": "server.fuse", "value": before[m["name"]],
            "label": m["name"], "origin": "smoke"})
        if code != 200 or not reply.get("ok"):
            raise SystemExit(f"fleet 24d: restoring {m['name']}: {code} "
                             f"{reply}")
    if fuse_values(members) != before:
        raise SystemExit("fleet 24d: server.fuse not restored")
    # (e) the report CLI over the fleet, the script's trace merged in
    snap_out = os.path.join(tmp, "fleet-snapshot.json")
    chrome_out = os.path.join(tmp, "fleet-chrome.json")
    t0 = time.perf_counter()
    rep = subprocess.run(
        [sys.executable, "-m", "multiverso_tpu_torch.telemetry.report",
         "--fleet", ffile, "--client-trace", own_trace, "--snapshot-out",
         snap_out, "--chrome-trace", chrome_out], cwd=HERE, env=fleet_env(),
        capture_output=True, text=True, timeout=300)
    report_ms = 1e3 * (time.perf_counter() - t0)
    if rep.returncode != 0:
        raise SystemExit(f"fleet 24e: report rc {rep.returncode}: "
                         f"{rep.stderr[-2000:]}")
    with open(snap_out) as f:
        rsnap = json.load(f)
    with open(chrome_out) as f:
        events = json.load(f)["traceEvents"]
    tracks = {e["args"]["name"].split(" ")[0]: e["pid"] for e in events
              if e.get("ph") == "M" and e.get("name") == "process_name"}
    roots = [e for e in events if e.get("ph") == "X"
             and e.get("name") == "control.retune"]
    linked = set()
    for root in roots:
        rp = f"h{host}:p{os.getpid()}:s{root['args']['span_id']}"
        for e in events:
            if e.get("ph") == "X" and e.get("name") == "control.decision" \
                    and e["args"].get("req") == root["args"].get("req") \
                    and e["args"].get("rparent") == rp:
                linked.add(e["pid"])
    member_tracks = {tracks.get(f"host{host}/pid{m['pid']}")
                     for m in members}
    if rsnap.get("kind") != "mvtpu.metrics.v1" or rsnap.get("hosts") != 4 \
            or None in member_tracks or len(roots) != 1 \
            or linked != member_tracks:
        raise SystemExit(f"fleet 24e: snapshot {rsnap.get('kind')} over "
                         f"{rsnap.get('hosts')} hosts; tracks {tracks}; "
                         f"{len(roots)} control.retune roots; decisions "
                         f"under it on tracks {sorted(linked)} (members "
                         f"{sorted(member_tracks, key=str)})")
    p50 = {path: pct(ms, 50) for path, ms in walls.items()}
    out = dict(scrape_ms_p50=p50, check_once_ms=check_ms,
               healthy_check_ms=check2_ms, report_ms=report_ms,
               kv_adds=sent, fuse=dict(before=before, after=after),
               bound=bound, chrome_events=len(events),
               seconds=time.perf_counter() - t_phase)
    log("  24a-e statusz on all 4 members; scrape wall p50 over them: "
        + ", ".join(f"{k} {v:.2f}" for k, v in p50.items()) + " ms; the "
        f"merge: 4 hosts, {sent} kv_adds, {got_repl:.0f} repl frames; "
        f"FleetController check_once {check_ms:.1f} ms (server.fuse "
        f"{sorted(set(before.values()))} -> {sorted(set(after.values()))} "
        f"on 4 members), a healthy check {check2_ms:.1f} ms; report "
        f"--fleet {report_ms:.0f} ms ({len(events)} chrome events, 4 "
        f"member tracks under one control.retune); {out['seconds']:.1f} s; "
        f"on {card}")
    return out


def fleet_promoted_view(ffile, heir: dict) -> dict:
    """Phase 24f after 23b: /statusz?fleet=1 on rank 1's primary names
    rank 0's promoted follower as its primary."""
    from multiverso_tpu_torch.server import partition
    t0 = time.perf_counter()
    doc = partition.read_fleet_file(ffile)
    port = doc["members"][1]["statusz_port"]
    code, body, ms = http_get(port, "/statusz?fleet=1")
    view = json.loads(body) if code == 200 else {}
    rank0 = next((e for e in view.get("partitions", [])
                  if e.get("rank") == 0), {})
    served = [p.get("server") for p in rank0.get("partitions") or []]
    if rank0.get("name") != heir["name"] or rank0.get("pid") != heir["pid"] \
            or served != [heir["name"]] or "error" in rank0:
        raise SystemExit(f"fleet 24f: after the promotion rank 0 reads "
                         f"{rank0} (the follower was {heir['name']}, pid "
                         f"{heir['pid']})")
    out = dict(view_ms=ms, seconds=time.perf_counter() - t0)
    log(f"  24f after 23b /statusz?fleet=1 names {heir['name']} (pid "
        f"{heir['pid']}) rank 0's primary, in {ms:.2f} ms")
    return out


def grow_add(j: int, keys):
    """Worker add j of 23c: small integer deltas, exact in any order."""
    base = (keys % np.uint64(5)).astype(np.float32) + 1 + (j % 3)
    return np.stack([base, 2 * base - (j % 3)], axis=1)


def grow_dense(j: int) -> np.ndarray:
    return ((np.arange(FLEET_GROW_DENSE) + j) % 7 + 1).astype(np.float32)


def fleet_grow(router, adds, tmp: str, card: str) -> dict:
    """23c: a fresh 2-member fleet grows to 3 while a worker thread
    streams adds into a default-updater KV table and a dense ArrayTable,
    then shrinks back to 2 with no traffic; both reads are exact."""
    proc, ffile, base, log_path = fleet_launch(tmp, "sg", 2, 1)
    key_sets = [k[:FLEET_GROW_KEYS] for k, _ in adds]
    union = np.unique(np.concatenate(key_sets))
    out = {}
    try:
        fc = router.connect_fleet_file(ffile, client="grow", quant=None)
        kv = fc.create_kv("grow_kv", FLEET_CAPACITY, value_dim=2,
                          updater="default")
        dense = fc.create_array("grow_dense", FLEET_GROW_DENSE)
        done, stamps, errors = [], [], []
        stop = threading.Event()

        def stream():
            try:
                j = 0
                while not stop.is_set() or j < 2:
                    keys = key_sets[j % len(key_sets)]
                    kv.add(keys, grow_add(j, keys), sync=True)
                    dense.add(grow_dense(j), sync=True)
                    done.append(j)
                    stamps.append(time.perf_counter())
                    j += 1
                for k in range(FLEET_GROW_AFTER):
                    keys = key_sets[j % len(key_sets)]
                    kv.add(keys, grow_add(j, keys), sync=True)
                    dense.add(grow_dense(j), sync=True)
                    done.append(j)
                    j += 1
            except BaseException as exc:    # noqa: BLE001 — the check
                errors.append(exc)          # below fails the phase
        worker = threading.Thread(target=stream, name="grow-worker")
        worker.start()
        time.sleep(0.5)
        mem0 = card_memory_mib()
        t0 = time.perf_counter()
        grow = subprocess.run(fleet_cmd("--grow", "--fleet-file", ffile,
                                        "--address", base, "--name", "sg"),
                              cwd=HERE, env=fleet_env(),
                              capture_output=True, text=True, timeout=600)
        t1 = time.perf_counter()
        mem1 = card_memory_mib()
        stop.set()
        worker.join(timeout=600)
        if errors or worker.is_alive() or grow.returncode != 0:
            raise SystemExit(f"fleet 23c: grow rc {grow.returncode} "
                             f"({grow.stderr[-2000:]}), worker {errors}")
        summary = json.loads(grow.stdout.strip().splitlines()[-1])
        during = sum(t0 <= s <= t1 for s in stamps)
        # the exact sums, in float64 (small integers: exact in float32)
        inv = [np.searchsorted(union, k) for k in key_sets]
        want = np.zeros((len(union), 2))
        want_dense = np.zeros(FLEET_GROW_DENSE)
        for j in done:
            a = j % len(key_sets)
            want[inv[a]] += grow_add(j, key_sets[a])
            want_dense += grow_dense(j)
        want = want.astype(np.float32)
        want_dense = want_dense.astype(np.float32)

        def check(what: str) -> None:
            vals, found = kv.get(union)
            if not found.all() or vals.tobytes() != want.tobytes() \
                    or dense.get().tobytes() != want_dense.tobytes():
                raise SystemExit(f"fleet 23c: after the {what} the "
                                 "tables differ from the exact sums")
        check("grow")
        if fc.pmap.n != 3 or not summary.get("ok") \
                or summary.get("n_to") != 3 or during < 1:
            raise SystemExit(f"fleet 23c: grow {summary}, router n "
                             f"{fc.pmap.n}, {during} adds during it")
        live = len(union) * (8 + 2 * 4) + FLEET_GROW_DENSE * 4
        t2 = time.perf_counter()
        shrink = subprocess.run(fleet_cmd("--shrink", "--fleet-file",
                                          ffile, "--address", base,
                                          "--name", "sg"),
                                cwd=HERE, env=fleet_env(),
                                capture_output=True, text=True,
                                timeout=600)
        t3 = time.perf_counter()
        if shrink.returncode != 0:
            raise SystemExit(f"fleet 23c: shrink rc {shrink.returncode}: "
                             f"{shrink.stderr[-2000:]}")
        back = json.loads(shrink.stdout.strip().splitlines()[-1])
        check("shrink")
        for s in (summary, back):
            if not 0 < s["moved_bytes"] < live:
                raise SystemExit(f"fleet 23c: moved {s['moved_bytes']} "
                                 f"bytes of {live} live")
        if fc.pmap.n != 2 or back.get("n_to") != 2:
            raise SystemExit(f"fleet 23c: shrink {back}, router n "
                             f"{fc.pmap.n}")
        fc.close()
        out = dict(adds=len(done), adds_during_grow=during,
                   grow=dict(seconds=t1 - t0, **{
                       k: summary[k] for k in ("moved_bytes", "chunks",
                                               "forwards", "elapsed_s")}),
                   shrink=dict(seconds=t3 - t2, **{
                       k: back[k] for k in ("moved_bytes", "chunks",
                                            "forwards", "elapsed_s")}),
                   live_bytes=live, keys=len(union),
                   card_mib=max(mem0, mem1))
    finally:
        out["launches"] = fleet_stop(proc, ffile, log_path,
                                     f"{ffile}.r2.log")
    log(f"  23c grow 2 -> 3 under a worker's {out['adds']} adds "
        f"({out['adds_during_grow']} while the grow ran; "
        f"{FLEET_GROW_KEYS} keys, default updater, 2^26 slots, and a "
        f"{FLEET_GROW_DENSE}-element ArrayTable): {out['grow']['seconds']:.2f}"
        f" s, moved {out['grow']['moved_bytes']} of {live} live bytes "
        f"({out['grow']['chunks']} chunks, {out['grow']['forwards']} "
        f"forwards); every value the exact sum. Shrink 3 -> 2: "
        f"{out['shrink']['seconds']:.2f} s, moved "
        f"{out['shrink']['moved_bytes']} bytes, bit for bit; on {card}")
    return out


def phase_fleet(torch, KVTable, router, transport, telemetry, adds,
                card: str) -> dict:
    """Phase 23: the server fleet on cuda:0 (see fleet_replicate,
    fleet_failover, fleet_grow), and phase 24 on it between 23a and 23b
    (fleet_observe, fleet_promoted_view). Returns the numbers."""
    from multiverso_tpu_torch.server import partition
    free_tables(torch)
    t_phase = time.perf_counter()
    host = [(np.asarray(k, np.uint64),
             d.cpu().numpy() if hasattr(d, "cpu") else np.asarray(d))
            for k, d in adds]
    union = np.unique(np.concatenate([k for k, _ in host]))
    saved = {k: os.environ.get(k) for k in FLEET_RETRY}
    os.environ.update(FLEET_RETRY)
    out = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            proc, ffile, _base, log_path = fleet_launch(
                tmp, "sf", 2, 2,
                {"MVTPU_TRACE_DIR": os.path.join(tmp, FLEET_TRACE_DIR)})
            try:
                fc, t, local, out["a"] = fleet_replicate(
                    torch, KVTable, router, transport, telemetry, host,
                    union, ffile, card)
                heir = partition.read_fleet_file(
                    ffile)["members"][0]["replicas"][0]
                out["obs"] = fleet_observe(transport, fc, t, host, ffile,
                                           tmp, card)
                out["b"] = fleet_failover(router, fc, t, local, host,
                                          union, ffile, card)
                out["obs"]["f"] = fleet_promoted_view(ffile, heir)
                out["card_mib"] = card_memory_mib()
                fc.close()
                del local
                free_tables(torch)
            finally:
                launches = fleet_stop(proc, ffile, log_path)
            out["launches"] = launches
            out["c"] = fleet_grow(router, host, tmp, card)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    members = {**out["launches"], **out["c"]["launches"]}
    for name in ("sf-1", "sf-0f1", "sf-1f1"):
        got = members.get(name, {})
        if not got.get("kv_probe_update") or not got.get("kv_commit"):
            raise SystemExit(f"fleet: member {name} launched {got}: the "
                             "KV probe + commit never ran there")
    if not members.get("sf-1", {}).get("kv_lookup"):
        raise SystemExit("fleet: rank 1's primary never launched the KV "
                         "lookup")
    out.update(members=members,
               peak_card_mib=max(out["a"]["card_mib"], out["card_mib"],
                                 out["c"]["card_mib"]),
               seconds=time.perf_counter() - t_phase)
    log("  23 kernel launches per member (#6 kv_lookup, #7 kv_probe_update "
        "+ kv_commit): " + "; ".join(
            f"{name} {v.get('kv_lookup', 0)} / {v.get('kv_probe_update', 0)}"
            f" + {v.get('kv_commit', 0)}" for name, v in sorted(
                members.items())) + f" (sf-0 SIGKILLed, not counted); card "
        f"memory peak {out['peak_card_mib']} MiB (nvidia-smi, every "
        f"process); {out['seconds']:.1f} s; on {card}")
    return out



# -- phase 25: the multi-process runtime ----------------------------------------
# two worker processes on cuda:0 over one gloo group (NCCL refuses two
# ranks on one card); phase 4's word2vec width, phase 8's LightLDA depth
MP_PROCS = 2
MP_W2V_STEPS, MP_W2V_CALLS = 64, 3
MP_W2V_TOKENS = 300_000          # each process's shard
MP_KV_SLOTS, MP_KV_ADDS, MP_KV_KEYS = 1 << 20, 8, 20_000
MP_TIMEOUT_S = 600
#: what every worker must launch: #1, #2, #4, #6, #7, and #11 or #12
MP_KERNELS = ("row_gather", "row_scatter_add", "coo_scatter_add",
              "kv_lookup", "kv_probe_update")
MP_SAMPLERS = ("gibbs_sample_docblock", "gibbs_sample_docblock_build")


def mp_sizes() -> dict:
    """The sizes a worker runs (a CPU rehearsal passes smaller ones)."""
    return dict(device="cuda:0", vocab=VOCAB, dim=DIM, window=WINDOW,
                negative=NEGATIVE, batch=BATCH, steps=MP_W2V_STEPS,
                calls=MP_W2V_CALLS, tokens=MP_W2V_TOKENS, lr=LR,
                lda_v=LDA_V, lda_d=LDA_SMALL_D, lda_t=LDA_SMALL_T,
                lda_k=LDA_K, lda_b=LDA_B, lda_tb=LDA_TB,
                lda_maxd=LDA_MAXD, kv_slots=MP_KV_SLOTS,
                kv_adds=MP_KV_ADDS, kv_keys=MP_KV_KEYS)


def mp_shard(Corpus, CorpusData, z: dict, rank: int):
    """Rank ``rank``'s word2vec shard: one dictionary (the counts of a
    shared Zipf sample), its own Zipf token stream."""
    counts = np.maximum(np.bincount(
        zipf_words(np.random.default_rng(7), z["vocab"], 1_000_000),
        minlength=z["vocab"]), 1).astype(np.int64)
    ids = zipf_words(np.random.default_rng(100 + rank), z["vocab"],
                     z["tokens"])
    return Corpus(CorpusData(words=[f"w{i}" for i in range(z["vocab"])],
                             counts=counts, ids=ids,
                             total_raw_tokens=len(ids)),
                  subsample=SUBSAMPLE)


def mp_w2v_config(W2VConfig, z: dict, local: bool):
    return W2VConfig(embedding_dim=z["dim"], window=z["window"],
                     negative=z["negative"], batch_size=z["batch"],
                     steps_per_call=z["steps"], learning_rate=z["lr"],
                     subsample=SUBSAMPLE, seed=1, local_data=local)


def table_crc(app) -> list:
    import zlib
    return [zlib.crc32(np.ascontiguousarray(t.get()).tobytes())
            for t in (app.w_in, app.w_out)]


def mp_worker(argv) -> int:
    """One worker of phase 25 (``chip_smoke.py --mp-worker <rank> <store
    file> <out dir> <sizes json>``): joins the group, drives word2vec
    ``local_data``, LightLDA ``local_corpus`` and a KVTable through the
    port on its replica, checks them, and writes its numbers to
    ``<out dir>/rank<rank>.json``."""
    import zlib
    rank, store, out, z = int(argv[0]), argv[1], argv[2], json.loads(argv[3])
    if z.get("mode") == "model_axis":
        return ma_worker(rank, store, out, z)
    import torch
    sys.path.insert(0, HERE)
    from multiverso_tpu_torch import core
    from multiverso_tpu_torch.apps.lightlda import LDAConfig, LightLDA
    from multiverso_tpu_torch.apps.word_embedding import (W2VConfig,
                                                          WordEmbedding)
    from multiverso_tpu_torch.data.corpus import Corpus
    from multiverso_tpu_torch.data.native import CorpusData
    from multiverso_tpu_torch.ops import lda_sampler as ls
    from multiverso_tpu_torch.ops import table_kernels as tk
    from multiverso_tpu_torch.parallel import multihost
    from multiverso_tpu_torch.tables import KVTable, reset_tables
    dev = torch.device(z["device"])
    mesh = core.init(["-num_processes=2", f"-process_id={rank}",
                      "-data_parallel=2", "-model_parallel=1"],
                     devices=[dev], store=torch.distributed.FileStore(
                         store, MP_PROCS))
    if mesh.local_rows != [rank] or core.size() != MP_PROCS:
        raise SystemExit(f"rank {rank}: mesh {mesh}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    res = {"rank": rank}
    tk.reset_launches()
    ls.reset_launches()
    # (a) word2vec local_data: a warm-up call, then the timed calls
    app = WordEmbedding(mp_shard(Corpus, CorpusData, z, rank),
                        mp_w2v_config(W2VConfig, z, True), name="mp_w2v")
    if app._local_batch != z["batch"] // MP_PROCS:
        raise SystemExit(f"rank {rank}: local batch {app._local_batch}")
    fused, gathers = app._fused, []

    def timed_fused(*args, **kwargs):
        r = fused(*args, **kwargs)
        gathers.append(fused.exchange_seconds)
        return r

    app._fused = timed_fused
    app.train(total_steps=z["steps"])
    sync()
    gathers.clear()
    t0 = time.perf_counter()
    app.train(total_steps=z["steps"] * z["calls"])
    sync()
    dt = time.perf_counter() - t0
    if not all(np.isfinite(app.loss_history)):
        raise SystemExit(f"rank {rank}: w2v loss {app.loss_history}")
    # this worker's own share of the pairs (its local batch)
    pairs = z["steps"] * z["calls"] * app._local_batch
    res["w2v"] = dict(seconds=dt, pairs_per_sec=pairs / dt,
                      words_per_sec=pairs / dt / (z["window"] + 1),
                      gather_share=sum(gathers) / dt,
                      losses=app.loss_history, crc=table_crc(app))
    if len(set(multihost.allgather_bytes(
            json.dumps(res["w2v"]["crc"]).encode("ascii")))) != 1:
        raise SystemExit("w2v local_data: the processes' tables differ")
    del app, fused
    reset_tables()

    # (b) LightLDA streamed, doc-blocked, local_corpus
    tw, td = zipf_lda_corpus(z["lda_v"], z["lda_d"], z["lda_t"], seed=0)
    mine = (td % MP_PROCS) == rank
    lda = LightLDA(tw[mine], td[mine], z["lda_v"], LDAConfig(
        num_topics=z["lda_k"], batch_tokens=z["lda_b"], steps_per_call=1,
        seed=1, sampler="tiled", doc_blocked=True, block_tokens=z["lda_tb"],
        block_docs=z["lda_maxd"], stream_blocks=True, local_corpus=True),
        name="mp_lda")
    if lda.num_tokens != z["lda_t"]:
        raise SystemExit(f"rank {rank}: {lda.num_tokens} global tokens")
    sweeps = []
    for _ in range(2):
        t0 = time.perf_counter()
        lda.sweep()
        sync()
        sweeps.append(time.perf_counter() - t0)
    nwk = lda.word_topics()
    if int(nwk.sum()) != z["lda_t"]:
        raise SystemExit(f"rank {rank}: word counts sum to {nwk.sum()}")
    valid = lda._tw_host != lda._scratch_word
    own = np.zeros(nwk.shape, np.int64)
    np.add.at(own, (lda._tw_host[valid], lda._z_host[valid]), 1)
    total = multihost.allgather_i64(own.reshape(-1)).sum(0)
    if not np.array_equal(total.reshape(nwk.shape), nwk):
        raise SystemExit("LightLDA local_corpus: the word counts are not "
                         "the processes' own recounts summed")
    doc = lda.doc_topics()
    want = np.zeros_like(doc)
    blocks = np.nonzero(valid)[0]
    np.add.at(want, (lda._doc_of_row[blocks, lda._drel_host[valid]],
                     lda._z_host[valid]), 1)
    if not np.array_equal(doc, want) or int(doc.sum()) != int(mine.sum()):
        raise SystemExit(f"rank {rank}: doc counts are not its own z's")
    ll = lda.loglik()
    if not np.isfinite(ll):
        raise SystemExit(f"rank {rank}: loglik {ll}")
    prefix = os.path.join(out, "lda")
    z_before, nk_before = lda._z_host.copy(), lda.summary.get()
    lda.store(prefix)
    if not os.path.exists(f"{prefix}.state.rank{rank}.npz"):
        raise SystemExit(f"rank {rank}: no per-rank state file")
    lda.load(prefix)
    if not (np.array_equal(lda._z_host, z_before)
            and np.array_equal(lda.word_topics(), nwk)
            and np.array_equal(lda.summary.get(), nk_before)):
        raise SystemExit(f"rank {rank}: the per-rank store and load did "
                         "not round-trip")
    res["lda"] = dict(sweep_s=sweeps, loglik=ll,
                      local_tokens=int(mine.sum()),
                      tokens_per_sec=z["lda_t"] / min(sweeps))
    del lda
    reset_tables()

    # (c) a KVTable: collective adds and gets against a numpy model
    kv = KVTable(z["kv_slots"], value_dim=2, slots_per_bucket=16,
                 name="mp_kv")
    rng = np.random.default_rng(11)
    model: dict = {}
    for _ in range(z["kv_adds"]):
        keys = np.unique(rng.integers(1, 1 << 40, z["kv_keys"]).astype(
            np.uint64))
        deltas = rng.standard_normal((len(keys), 2)).astype(np.float32)
        kv.add(keys, deltas)
        for k, d in zip(keys.tolist(), deltas):
            model[k] = model.get(k, np.zeros(2, np.float32)) + d
    keys = np.array(sorted(model), np.uint64)
    vals, found = kv.get(keys)
    if not found.all() or not np.array_equal(
            vals, np.stack([model[k] for k in keys.tolist()])):
        raise SystemExit(f"rank {rank}: KVTable gets differ from the model")
    _, missing = kv.get(np.array([3, 5], np.uint64))
    if missing.any() or len(kv) != len(keys):
        raise SystemExit(f"rank {rank}: KVTable found missing keys")
    if len(set(multihost.allgather_bytes(
            str(zlib.crc32(vals.tobytes())).encode()))) != 1:
        raise SystemExit("KVTable: the processes' values differ")
    res["kv"] = dict(keys=len(keys))
    res["launches"] = {**tk.LAUNCHES, **ls.LAUNCHES}
    core.barrier()
    core.shutdown()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    print(f"MP_WORKER_OK rank={rank}", flush=True)
    return 0


def mp_one_process(torch, z: dict) -> list:
    """The one-process (2, 1) run of phase 25a on one device, fed the
    same global batches: each rank's stream, its lanes chunk r of every
    batch. Returns its tables' CRC32s."""
    from multiverso_tpu_torch import core
    from multiverso_tpu_torch.apps.word_embedding import (W2VConfig,
                                                          WordEmbedding,
                                                          local_batches)
    from multiverso_tpu_torch.data.corpus import Corpus
    from multiverso_tpu_torch.data.native import CorpusData
    shards = [mp_shard(Corpus, CorpusData, z, r) for r in range(MP_PROCS)]
    cfg = mp_w2v_config(W2VConfig, z, False)
    app = WordEmbedding(shards[0], cfg, name="mp_w2v_one",
                        mesh=core.Mesh([[z["device"]]] * MP_PROCS))

    def batches():
        streams = [local_batches(c, cfg, r, z["batch"] // MP_PROCS,
                                 app._scratch)
                   for r, c in enumerate(shards)]
        for items in zip(*streams):
            yield tuple(np.concatenate(x) for x in zip(*items))

    app.train(total_steps=z["steps"], batches=batches())
    app.train(total_steps=z["steps"] * z["calls"], batches=batches())
    crc = table_crc(app)
    del app
    free_tables(torch)
    return crc


def mp_spawn(z: dict, tmp: str, what: str) -> list:
    """Start the ``MP_PROCS`` workers (``--mp-worker``) on sizes ``z``
    over one FileStore in ``tmp``, wait for them, end every one at the
    first failure or the timeout, and return each one's JSON."""
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mp-worker",
         str(r), os.path.join(tmp, "store"), tmp, json.dumps(z)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(MP_PROCS)]
    deadline = time.monotonic() + MP_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        logs = [p.communicate()[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, logs)):
        if p.returncode != 0 or f"MP_WORKER_OK rank={r}" not in out:
            raise SystemExit(f"{what}: worker {r} failed (rc "
                             f"{p.returncode}):\n{out[-4000:]}")
    workers = []
    for r in range(MP_PROCS):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            workers.append(json.load(f))
    return workers


def phase_multiprocess(torch, card: str, z=None) -> dict:
    """Phase 25 (see ``MP_*`` and the module doc): the two workers, then
    the one-process run they must equal. A worker that fails ends the
    other at once (a rank left in a collective would wait out the
    group's timeout), and the phase fails."""
    z = mp_sizes() if z is None else z
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        workers = mp_spawn(z, tmp, "phase 25")
    workers_s = time.perf_counter() - t_phase
    for w in workers:
        short = [k for k in MP_KERNELS if w["launches"].get(k, 0) <= 0]
        if not any(w["launches"].get(k, 0) > 0 for k in MP_SAMPLERS):
            short.append(" or ".join(MP_SAMPLERS))
        if short:
            raise SystemExit(f"phase 25: worker {w['rank']} launched no "
                             f"{short}: {w['launches']}")
    t0 = time.perf_counter()
    one = mp_one_process(torch, z)
    one_s = time.perf_counter() - t0
    if one != workers[0]["w2v"]["crc"]:
        raise SystemExit(f"phase 25a: the workers' tables "
                         f"{workers[0]['w2v']['crc']} != the one-process "
                         f"(2, 1) run's {one}")
    # the system's rate: every worker's pairs over the slowest worker's
    # time
    system_wps = z["steps"] * z["calls"] * z["batch"] / (
        z["window"] + 1) / max(w["w2v"]["seconds"] for w in workers)
    for w in workers:
        a, b = w["w2v"], w["lda"]
        log(f"  worker {w['rank']}: word2vec local_data "
            f"{a['words_per_sec']:.0f} words/s (its own pairs / "
            f"(window + 1) over its {a['seconds']:.3f} s), gloo gathers "
            f"{100 * a['gather_share']:.1f}% of its timed calls; LightLDA "
            f"local_corpus sweeps {[round(x, 3) for x in b['sweep_s']]} s "
            f"({b['local_tokens']} of its tokens), loglik "
            f"{b['loglik']:.6f}; KV {w['kv']['keys']} keys; launches "
            f"{ {k: v for k, v in w['launches'].items() if v} }")
    log(f"  word2vec local_data: {system_wps:.0f} words/s for the system "
        f"(global pairs / (window + 1) over the slowest worker's timed "
        f"calls); both workers' tables equal the one-process (2, 1) run's "
        f"bit for bit (CRC32 {one}); workers {workers_s:.1f} s, the "
        f"one-process run {one_s:.1f} s; on {card}")
    return dict(workers=workers, system_words_per_sec=system_wps,
                one_process_crc=one, workers_s=workers_s,
                one_process_s=one_s)


# -- phase 27: a model axis across processes ----------------------------------

#: 27a: word2vec calls (a warm-up, then timed) of MA_W2V_STEPS steps
MA_W2V_STEPS, MA_W2V_CALLS = 64, 3
#: 27b: sparse-LR minibatches (a warm-up, then timed); 27c: phase 10's
#: first adds replayed on the shard_update table
MA_SLR_STEPS, MA_KV_ADDS = 6, 4
#: what every worker must launch: #9b's two mesh forms, #9's lookup, #8's
#: probe and commit
MA_KERNELS = ("gather_rows_mesh", "row_scatter_add_mesh",
              "kv_lookup_sharded", "kv_probe_update", "kv_commit")
#: 27d: LightLDA on the (1, 2) mesh across the two processes at phase 6's
#: width and phase 25's depth: each mode's (warm-up, timed) sweeps
MA_LDA_SWEEPS = {"doc-blocked": (1, 2), "doc-blocked streamed": (1, 1),
                 "tiled exact": (0, 1)}
MA_LDA_MODES = {"doc-blocked": dict(doc_blocked=True),
                "doc-blocked streamed": dict(doc_blocked=True,
                                             stream_blocks=True),
                "tiled exact": dict()}
#: the kernels of 27d's path (#1, #9b's gather and COO add, #10-#12)
MA_LDA_KERNELS = ("row_gather", "gather_rows_mesh", "coo_scatter_add_mesh",
                  "gibbs_sample_tiled", "gibbs_sample_docblock",
                  "gibbs_sample_docblock_build",
                  "gibbs_sample_docblock_rows")


def ma_sizes() -> dict:
    """The sizes a phase-27 worker runs (a CPU rehearsal passes smaller
    ones)."""
    return dict(mode="model_axis", device="cuda:0", vocab=VOCAB, dim=DIM,
                window=WINDOW, negative=NEGATIVE, batch=BATCH,
                steps=MA_W2V_STEPS, calls=MA_W2V_CALLS,
                tokens=MP_W2V_TOKENS, lr=LR, slr_batch=SLR_BATCH,
                slr_steps=MA_SLR_STEPS, slr_dim=SLR_DIM, slr_nnz=SLR_NNZ,
                slr_capacity=SLR_CAPACITY, slr_slots=SLR_SLOTS,
                kv_adds=MA_KV_ADDS, lda_v=LDA_V, lda_d=LDA_SMALL_D,
                lda_t=LDA_SMALL_T, lda_k=LDA_K, lda_b=LDA_B,
                lda_tb=LDA_TB, lda_maxd=LDA_MAXD)


def ma_crc(torch, tensors) -> list:
    """CRC32 of each tensor's bytes (on the host)."""
    import zlib
    return [zlib.crc32(bits(torch, t.detach().cpu().contiguous())
                       .numpy().tobytes()) for t in tensors]


def ma_run(torch, z: dict, mesh12, mesh21, sync, traffic=None) -> dict:
    """Phase 27's three parts on the (1, 2) mesh ``mesh12`` and the (2, 1)
    mesh ``mesh21``, over two processes or in one: (a) word2vec, (b)
    sparse LR, (c) the sparse LR's first adds replayed on a shard_update
    KVTable. ``traffic``: the worker's ``multihost`` module, whose
    all-gathers each timed part reads. Returns each part's CRC32s and
    numbers."""
    from multiverso_tpu_torch.apps.sparse_logreg import (
        SparseLogisticRegression, SparseLRConfig, synthetic_sparse)
    from multiverso_tpu_torch.apps.word_embedding import (W2VConfig,
                                                          WordEmbedding)
    from multiverso_tpu_torch.data.corpus import Corpus
    from multiverso_tpu_torch.data.native import CorpusData
    from multiverso_tpu_torch.ops import table_kernels as tk
    from multiverso_tpu_torch.tables import KVTable, reset_tables
    from multiverso_tpu_torch.updaters import AddOption

    def timed(fn):
        sync()
        if traffic is not None:
            traffic.reset_traffic()
        before = dict(tk.LAUNCHES)
        t0 = time.perf_counter()
        fn()
        sync()
        dt = time.perf_counter() - t0
        moved = dict(traffic.TRAFFIC) if traffic is not None else \
            dict(calls=0, seconds=0.0, bytes=0)
        return dt, moved, {k: v - before[k] for k, v in tk.LAUNCHES.items()
                           if v > before[k]}

    res = {}
    # (a) plain word2vec: every process feeds the same global batch
    app = WordEmbedding(mp_shard(Corpus, CorpusData, z, 0),
                        mp_w2v_config(W2VConfig, z, False), name="ma_w2v",
                        mesh=mesh12)
    app.train(total_steps=z["steps"])
    steps = z["steps"] * (z["calls"] - 1)
    dt, moved, grown = timed(lambda: app.train(total_steps=steps))
    if not all(np.isfinite(app.loss_history)):
        raise SystemExit(f"27a: w2v losses {app.loss_history}")
    res["w2v"] = dict(seconds=dt, steps=steps, losses=app.loss_history,
                      merge_seconds=moved["seconds"],
                      merge_calls=moved["calls"],
                      bytes_per_step=moved["bytes"] / steps,
                      launches=grown, held=held_shards(app.w_in),
                      crc=ma_crc(torch, [app.w_in.get_tensor(),
                                         app.w_out.get_tensor()]))
    del app
    reset_tables()
    # (b) sparse LR at phase 10's width on a 2^25-slot table split in two
    b, n_steps = z["slr_batch"], z["slr_steps"]
    rows, y = synthetic_sparse(n=b * n_steps, dim=z["slr_dim"],
                               num_classes=2, nnz=z["slr_nnz"], seed=0)
    cfg = SparseLRConfig(capacity=z["slr_capacity"],
                         slots_per_bucket=z["slr_slots"], max_features=64,
                         minibatch_size=b, updater="ftrl", learning_rate=0.1,
                         epochs=1)
    slr = SparseLogisticRegression(cfg, mesh=mesh12, name="ma_slr")
    adds, add = [], slr.table.add

    def recording_add(keys, deltas, *args, **kw):
        adds.append((keys, deltas))
        return add(keys, deltas, *args, **kw)

    slr.table.add = recording_add
    losses = [slr.train_batch(rows[:b], y[:b])]

    def steps_b():
        for s in range(1, n_steps):
            losses.append(slr.train_batch(rows[s * b:(s + 1) * b],
                                          y[s * b:(s + 1) * b]))

    dt, moved, grown = timed(steps_b)
    if not np.all(np.isfinite(losses)):
        raise SystemExit(f"27b: sparse-LR losses {losses}")
    res["slr"] = dict(seconds=dt, steps=n_steps - 1, losses=losses,
                      samples_per_sec=(n_steps - 1) * b / dt,
                      merge_seconds=moved["seconds"],
                      merge_calls=moved["calls"],
                      bytes_per_step=moved["bytes"] / (n_steps - 1),
                      launches=grown, live_keys=len(slr.table),
                      held=held_shards(slr.table),
                      crc=ma_crc(torch, ma_kv(slr.table)))
    del slr
    reset_tables()
    # (c) the first adds on a (2, 1) KVTable whose ftrl state is split
    # over the two processes' rows: each commits its block's lanes, and
    # the cells it wrote go to the other
    kvs = KVTable(z["slr_capacity"], value_dim=2,
                  slots_per_bucket=z["slr_slots"], updater="ftrl",
                  mesh=mesh21, shard_update=True, name="ma_kvs",
                  default_option=AddOption.for_ftrl(
                      0.1, cfg.ftrl_l1, cfg.ftrl_l2, cfg.ftrl_beta))

    def adds_c():
        for keys, deltas in adds[:z["kv_adds"]]:
            kvs.add(keys, deltas)

    dt, moved, grown = timed(adds_c)
    kvs.wait()
    block = kvs._buckets_per_shard // 2 * kvs.slots * (8 + 4 * 2)
    res["kv_shard_update"] = dict(
        seconds=dt, adds=z["kv_adds"], merge_seconds=moved["seconds"],
        merge_calls=moved["calls"],
        bytes_per_add=moved["bytes"] / z["kv_adds"], block_bytes=block,
        launches=grown, held=held_shards(kvs),
        crc=ma_crc(torch, ma_kv(kvs)))
    del kvs, adds
    reset_tables()
    return res


def ma_lda_launches(mode: str, steps: int, calls: int,
                    sweeps: int) -> dict:
    """What 27d's ``mode`` launches on a worker over its construction
    and ``sweeps`` sweeps of ``steps`` steps in ``calls`` calls, one
    shard of the word table held (the one-process run, which holds both,
    gathers the doc-blocked rows from its split mirror instead): the
    doc-blocked kernels read the whole mirror with ``words=`` and no row
    gather; tiled exact gathers a step's distinct rows (#9b), each lane's
    row from them and its doc row (#1), and adds the step's moves (#9b's
    COO add)."""
    want = dict.fromkeys(MA_LDA_KERNELS, 0)
    if mode == "doc-blocked":
        want["gibbs_sample_docblock"] = sweeps * steps
        want["gibbs_sample_docblock_rows"] = sweeps * steps
        want["coo_scatter_add_mesh"] = 1 + sweeps      # init, rebuilds
    elif mode == "doc-blocked streamed":
        want["gibbs_sample_docblock_build"] = sweeps * steps
        want["gibbs_sample_docblock_rows"] = sweeps * steps
        want["coo_scatter_add_mesh"] = calls * (1 + sweeps)
    else:
        want["gibbs_sample_tiled"] = sweeps * steps
        want["gather_rows_mesh"] = sweeps * steps
        want["row_gather"] = 2 * sweeps * steps
        want["coo_scatter_add_mesh"] = 1 + sweeps * steps
    return want


def ma_lda(torch, z: dict, mesh12, sync, traffic=None) -> dict:
    """27d: LightLDA on the (1, 2) mesh ``mesh12`` at phase 6's width
    and phase 25's depth, over two processes or in one: each mode of
    ``MA_LDA_MODES`` built, then its warm-up and timed sweeps
    (``MA_LDA_SWEEPS``). Returns each mode's CRC32s (z, the summary, each
    held shard of the word table), launches (a worker's are held
    against :func:`ma_lda_launches`), sweep seconds and, with
    ``traffic``, each timed sweep's all-gathered bytes and seconds."""
    from multiverso_tpu_torch.apps.lightlda import LDAConfig, LightLDA
    from multiverso_tpu_torch.ops import lda_sampler as ls
    from multiverso_tpu_torch.ops import table_kernels as tk
    tw, td = zipf_lda_corpus(z["lda_v"], z["lda_d"], z["lda_t"], seed=0)
    out = {}
    for mode, extra in MA_LDA_MODES.items():
        warm, timed = MA_LDA_SWEEPS[mode]
        tk.reset_launches()
        ls.reset_launches()
        t0 = time.perf_counter()
        app = LightLDA(tw, td, z["lda_v"], LDAConfig(
            num_topics=z["lda_k"], batch_tokens=z["lda_b"],
            steps_per_call=1, seed=1, sampler="tiled",
            block_tokens=z["lda_tb"], block_docs=z["lda_maxd"], **extra),
            mesh=mesh12, name="ma_lda")
        sync()
        setup_s = time.perf_counter() - t0
        secs, moved = [], []
        for sweep in range(warm + timed):
            if traffic is not None:
                traffic.reset_traffic()
            t0 = time.perf_counter()
            app.sweep()
            sync()
            secs.append(time.perf_counter() - t0)
            if traffic is not None:
                moved.append(dict(traffic.TRAFFIC))
        grown = {k: {**tk.LAUNCHES, **ls.LAUNCHES}[k]
                 for k in MA_LDA_KERNELS}
        steps = app.calls_per_sweep * app.config.steps_per_call
        wt = app.word_topic
        shards = [t for t in wt.shards if t is not None]
        out[mode] = dict(
            setup_s=setup_s, sweep_s=secs, steps=steps,
            doc_tokens_per_sec=z["lda_t"] * timed / sum(secs[warm:]),
            bytes_per_sweep=[m["bytes"] for m in moved[warm:]],
            gather_s=[m["seconds"] for m in moved[warm:]],
            gather_calls=[m["calls"] for m in moved[warm:]],
            launches=grown, calls=app.calls_per_sweep,
            held=held_shards(wt),
            crc=ma_crc(torch, [torch.from_numpy(app._z_numpy()),
                               app.summary.get_tensor()]),
            shard_crc=ma_crc(torch, shards))
        del app
        free_tables(torch)
    return out


def ma_kv(table) -> list:
    """A KVTable's global keys, values and state leaves (a collective
    when parts lie in other processes)."""
    keys, vals, state = table.global_arrays()
    return [keys, vals] + [state[k] for k in sorted(state)]


def held_shards(table) -> list:
    """``[data row, shard]`` of every shard tensor the table allocated
    (keys for a KVTable)."""
    lists = table.replica_keys if hasattr(table, "replica_keys") \
        else table.replicas
    return [[table.replica_ids[r], s] for r, shards in enumerate(lists)
            for s, x in enumerate(shards) if x is not None]


def ma_worker(rank: int, store: str, out: str, z: dict) -> int:
    """One worker of phase 27 (``chip_smoke.py --mp-worker <rank> <store
    file> <out dir> <sizes json>`` with ``mode`` "model_axis"): joins the
    group on a (1, 2) mesh, runs :func:`ma_run`, checks that it holds its
    own cells only, and writes ``<out dir>/rank<rank>.json``."""
    import torch
    sys.path.insert(0, HERE)
    from multiverso_tpu_torch import core
    from multiverso_tpu_torch.ops import table_kernels as tk
    from multiverso_tpu_torch.parallel import multihost
    dev = torch.device(z["device"])
    mesh12 = core.init(["-num_processes=2", f"-process_id={rank}",
                        "-data_parallel=1", "-model_parallel=2"],
                       devices=[dev], store=torch.distributed.FileStore(
                           store, MP_PROCS))
    if mesh12.cells != [(0, rank)] or not mesh12.model_split:
        raise SystemExit(f"rank {rank}: mesh {mesh12}")
    mesh21 = core.Mesh([[dev], [dev]], processes=MP_PROCS, rank=rank)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    tk.reset_launches()
    res = ma_run(torch, z, mesh12, mesh21, sync, multihost)
    res["rank"] = rank
    res["launches"] = dict(tk.LAUNCHES)
    res["lda"] = ma_lda(torch, z, mesh12, sync, multihost)
    for part, want in (("w2v", [[0, rank]]), ("slr", [[0, rank]]),
                       ("kv_shard_update", [[rank, 0]])) + tuple(
            (("lda", mode), [[0, rank]]) for mode in MA_LDA_MODES):
        got = res[part[0]][part[1]] if isinstance(part, tuple) \
            else res[part]
        if got["held"] != want:
            raise SystemExit(f"rank {rank}: 27 {part} holds "
                             f"{got['held']}, not its cell {want}")
    core.barrier()
    core.shutdown()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    print(f"MP_WORKER_OK rank={rank}", flush=True)
    return 0


def phase_model_axis(torch, card: str, z=None) -> dict:
    """Phase 27 (see ``MA_*`` and the module doc): the two workers, then
    the one-process (1, 2) and (2, 1) runs they must equal. A worker that
    fails ends the other at once, and the phase fails."""
    from multiverso_tpu_torch import core
    z = ma_sizes() if z is None else z
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        workers = mp_spawn(z, tmp, "phase 27")
    workers_s = time.perf_counter() - t_phase
    for w in workers:
        short = [k for k in MA_KERNELS if w["launches"].get(k, 0) <= 0]
        if short:
            raise SystemExit(f"phase 27: worker {w['rank']} launched no "
                             f"{short}: {w['launches']}")
        for mode, r in w["lda"].items():
            want = ma_lda_launches(mode, r["steps"], r["calls"],
                                   sum(MA_LDA_SWEEPS[mode]))
            if r["launches"] != want:
                raise SystemExit(f"phase 27d: worker {w['rank']}'s "
                                 f"LightLDA {mode} launched "
                                 f"{r['launches']}, expected {want}")
    t0 = time.perf_counter()
    dev = torch.device(z["device"])

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    one = ma_run(torch, z, core.Mesh([[dev, dev]]),
                 core.Mesh([[dev], [dev]]), sync)
    one_s = time.perf_counter() - t0
    free_tables(torch)
    t0 = time.perf_counter()
    one_lda = ma_lda(torch, z, core.Mesh([[dev, dev]]), sync)
    one_lda_s = time.perf_counter() - t0
    free_tables(torch)
    for mode, want in one_lda.items():
        for w in workers:
            got = w["lda"][mode]
            if got["crc"] != want["crc"] \
                    or got["shard_crc"] != [want["shard_crc"][w["rank"]]]:
                raise SystemExit(
                    f"phase 27d {mode}: worker {w['rank']}'s z, summary "
                    f"and shard {got['crc']} {got['shard_crc']} != the "
                    f"one-process (1, 2) run's {want['crc']} "
                    f"{want['shard_crc']}")
    for part in ("w2v", "slr", "kv_shard_update"):
        for w in workers:
            if w[part]["crc"] != one[part]["crc"]:
                raise SystemExit(
                    f"phase 27 {part}: worker {w['rank']}'s tables "
                    f"{w[part]['crc']} != the one-process run's "
                    f"{one[part]['crc']}")
    for w in workers:
        c = w["kv_shard_update"]
        if c["bytes_per_add"] >= c["block_bytes"]:
            raise SystemExit(f"phase 27c: {c['bytes_per_add']} bytes an "
                             f"add moved, a state block is "
                             f"{c['block_bytes']}")
    slowest = {part: max(w[part]["seconds"] for w in workers)
               for part in ("w2v", "slr", "kv_shard_update")}
    a = workers[0]["w2v"]
    system_wps = a["steps"] * z["batch"] / (z["window"] + 1) \
        / slowest["w2v"]
    system_sps = workers[0]["slr"]["samples_per_sec"] * \
        workers[0]["slr"]["seconds"] / slowest["slr"]
    for w in workers:
        parts = []
        for part in ("w2v", "slr", "kv_shard_update"):
            r = w[part]
            per = r.get("bytes_per_step", r.get("bytes_per_add"))
            parts.append(f"{part} {r['seconds']:.3f} s, merges and gate "
                         f"{100 * r['merge_seconds'] / r['seconds']:.1f}% "
                         f"({r['merge_calls']} all-gathers), "
                         f"{per:.0f} bytes in a "
                         f"{'step' if part != 'kv_shard_update' else 'add'}")
        log(f"  worker {w['rank']}: " + "; ".join(parts) + "; launches "
            f"{ {k: v for k, v in w['launches'].items() if v} }")
    lda = {}
    for mode in MA_LDA_MODES:
        slowest_sweep = max(min(w["lda"][mode]["sweep_s"][
            MA_LDA_SWEEPS[mode][0]:]) for w in workers)
        lda[mode] = dict(system_doc_tokens_per_sec=z["lda_t"]
                         / slowest_sweep,
                         one_process=one_lda[mode]["doc_tokens_per_sec"])
        for w in workers:
            r = w["lda"][mode]
            timed = r["sweep_s"][MA_LDA_SWEEPS[mode][0]:]
            share = [round(100 * g / t, 1)
                     for g, t in zip(r["gather_s"], timed)]
            log(f"  27d worker {w['rank']} LightLDA {mode}: sweeps "
                f"{[round(x, 4) for x in r['sweep_s']]} s (setup "
                f"{r['setup_s']:.2f} s), timed {[round(x, 4) for x in timed]}"
                f"; bytes in a timed sweep {r['bytes_per_sweep']} in "
                f"{r['gather_calls']} all-gathers, {share}% of the sweep; "
                f"launches {r['launches']}")
        log(f"  27d LightLDA {mode} on (1, 2) over two processes: "
            f"{lda[mode]['system_doc_tokens_per_sec']:.0f} doc-tokens/s "
            f"for the system (T {z['lda_t']} over the slowest worker's "
            f"best timed sweep); the one-process (1, 2) run "
            f"{lda[mode]['one_process']:.0f}; z, summary and each "
            f"worker's shard equal the one-process run's (CRC32)")
    log(f"  27a word2vec on (1, 2) over two processes: {system_wps:.0f} "
        f"words/s for the system (global pairs / (window + 1) over the "
        f"slowest worker's timed calls); 27b sparse LR: "
        f"{system_sps:.0f} samples/s; 27c shard_update KV on (2, 1): "
        f"{1e3 * slowest['kv_shard_update'] / z['kv_adds']:.1f} ms an "
        f"add; every part's tables equal the one-process (1, 2) / (2, 1) "
        f"run's bit for bit; workers {workers_s:.1f} s, the one-process "
        f"runs {one_s:.1f} s; on {card}")
    log(f"  27d the one-process (1, 2) LightLDA runs {one_lda_s:.1f} s")
    return dict(workers=workers, one_process=one, one_process_lda=one_lda,
                lda=lda, system_words_per_sec=system_wps,
                system_samples_per_sec=system_sps, workers_s=workers_s,
                one_process_s=one_s, one_process_lda_s=one_lda_s)


# -- phase 26: the binding-compat API, the examples, pipeline and ring ------

#: 26a: rounds of a Zipf-1.2 row add + get on the word2vec w_out-wide handler
BIND_ROUNDS = 32
#: 26c: ResNet-50 at the example main's image size and batch. Its
#: learning rate is a tenth of main's 0.1: at 0.1 the first momentum step
#: blows the loss up, in the reference's trainer as in the port's, and the
#: port's reached NaN at step 16 on the card
RESNET_N, RESNET_SIZE, RESNET_BATCH, RESNET_STEPS = 8192, 32, 256, 20
RESNET_LR = 0.01
RESNET_BIND_STEPS, RESNET_TINY_STEPS = 10, 70
#: ResNet-50's parameters and leaves (the reference's 94.05 MB)
RESNET50_SIZE = (23_513_162, 153)
#: 26e: ring / Ulysses attention shapes
ATTN_B, ATTN_H, ATTN_D, ATTN_S, ATTN_LONG_S = 1, 8, 128, 4096, 32768


@contextlib.contextmanager
def timed_method(cls, name: str):
    """Accumulate the wall seconds (and the calls) of ``cls.name`` while
    the block runs, into the yielded dict."""
    fn = getattr(cls, name)
    acc = {"seconds": 0.0, "calls": 0}

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            acc["seconds"] += time.perf_counter() - t0
            acc["calls"] += 1

    setattr(cls, name, timed)
    try:
        yield acc
    finally:
        setattr(cls, name, fn)


def bind_rows(torch, core, mvb, devices, rng) -> dict:
    """26a on one mesh: BIND_ROUNDS rounds of a row add of phase 2's
    ``main_n`` Zipf-1.2 ids (deltas in multiples of 1/16, so a float64
    accumulation is exact) and a get of the same ids, on a fresh
    10,001 x 100 handler; the table against the accumulation."""
    core.set_mesh(core.Mesh([devices]))
    n = BATCH * (1 + NEGATIVE)
    h = mvb.MatrixTableHandler(ROWS, DIM, name=f"bind_rows_{len(devices)}")
    acc = torch.zeros((ROWS, DIM), dtype=torch.float64)
    err, t_round = 0.0, []
    for _ in range(BIND_ROUNDS):
        ids = zipf_ids(rng, n, ROWS)
        d = rng.integers(-16, 17, (n, DIM)).astype(np.float32) / 16
        acc.index_add_(0, torch.from_numpy(ids).long(),
                       torch.from_numpy(d).double())
        t0 = time.perf_counter()
        h.add(d, row_ids=ids)
        got = h.get(row_ids=ids)
        t_round.append(1e3 * (time.perf_counter() - t0))
        want = acc.numpy()[ids]
        err = max(err, float(np.abs(got - want).max()))
        np.testing.assert_allclose(got, want, rtol=1e-5)
    whole, acc = h.get(), acc.numpy()
    np.testing.assert_allclose(whole, acc, rtol=1e-5)
    err = max(err, float(np.abs(whole - acc).max()))
    del h
    free_tables(torch)
    return dict(round_ms=t_round, max_abs_err=err)


def phase_bindings(torch, core, counts, reset, card, dev) -> tuple:
    """26a: the binding surface on the script's mesh; returns the row
    path's launches (``paths["bindings"]``) beside the results."""
    from multiverso_tpu_torch import bindings as mvb
    core.set_mesh(core.Mesh([[dev]]))
    mvb.init(sync=True)
    topo = dict(workers=mvb.workers_num(), worker=mvb.worker_id(),
                server=mvb.server_id(), master=mvb.is_master_worker())
    if topo != dict(workers=1, worker=0, server=0, master=True):
        raise SystemExit(f"phase 26a: topology {topo} on one card")
    mvb.barrier()
    rng = np.random.default_rng(26)
    arr = mvb.ArrayTableHandler(1_000_000, init_value=0.5, name="bind_arr")
    a = rng.integers(-64, 65, 1_000_000).astype(np.float32) / 16
    arr.add(a)
    arr.add(a, sync=True)
    if not np.array_equal(arr.get(), 0.5 + 2 * a):
        raise SystemExit("phase 26a: ArrayTableHandler round trip differs")
    del arr
    free_tables(torch)
    reset()
    rows = {f"(1, {s})": bind_rows(torch, core, mvb, [dev] * s, rng)
            for s in (1, 4)}
    launches = counts()
    want = len(rows) * BIND_ROUNDS
    for name in ("row_gather_sharded", "row_scatter_add_sharded"):
        if launches[name] != want:
            raise SystemExit(f"phase 26a: {name} launched "
                             f"{launches[name]} times, not {want} (one a "
                             "call on one card)")
    for key, r in rows.items():
        log(f"  26a MatrixTableHandler {ROWS} x {DIM} on {key} of {dev}: "
            f"{BIND_ROUNDS} rounds of add + get of {BATCH * (1 + NEGATIVE)} "
            f"Zipf-1.2 ids, {np.median(r['round_ms']):.3f} ms a round "
            f"(median), max abs err vs float64 {r['max_abs_err']}; on {card}")
    log(f"  26a launches {({k: v for k, v in launches.items() if v})}")
    return dict(topology=topo, rows=rows), launches


def phase_mlp_cifar(torch, card, dev) -> dict:
    """26b: ``mlp_cifar.main`` at its defaults on ``dev``, syncing through
    ``ParamManager`` every step; then one epoch with 1-bit syncs."""
    from multiverso_tpu_torch.bindings.torch_ext import ParamManager
    from multiverso_tpu_torch.examples import mlp_cifar
    t0 = time.perf_counter()
    with timed_method(ParamManager, "sync_all_param") as sync:
        acc = mlp_cifar.main([f"-device={dev}"])
    wall = time.perf_counter() - t0
    if not acc > 0.8:
        raise SystemExit(f"phase 26b: mlp_cifar accuracy {acc} <= 0.8")
    n, batch, epochs = 20_000, 128, 3
    samples = epochs * (n // batch) * batch
    X, y = mlp_cifar.synthetic_cifar(n)
    t1 = time.perf_counter()
    pm = ParamManager(mlp_cifar.init_mlp(), name="mlp_1bit",
                      compress="1bit")
    with timed_method(ParamManager, "sync_all_param") as sync1:
        params, loss = mlp_cifar.train(X, y, epochs=1, manager=pm)
    acc1 = mlp_cifar.accuracy(params, X, y)
    wall1 = time.perf_counter() - t1
    if not (np.isfinite(loss) and acc1 > 0.45):
        raise SystemExit(f"phase 26b: 1-bit epoch accuracy {acc1}, loss "
                         f"{loss}")
    free_tables(torch)
    out = dict(accuracy=acc, seconds=wall, samples_per_sec=samples / wall,
               syncs=sync["calls"], sync_share=sync["seconds"] / wall,
               one_bit=dict(accuracy=acc1, seconds=wall1,
                            samples_per_sec=(n // batch) * batch / wall1,
                            sync_share=sync1["seconds"] / wall1))
    log(f"  26b mlp_cifar main (20,000 samples, hidden (256, 128), batch "
        f"128, 3 epochs, a sync a step): accuracy {acc:.4f}, "
        f"{out['samples_per_sec']:.0f} samples/s over main's wall "
        f"{wall:.2f} s (data made inside it), {sync['calls']} syncs "
        f"{100 * out['sync_share']:.1f}% of it; one 1-bit epoch: accuracy "
        f"{acc1:.4f}, {out['one_bit']['samples_per_sec']:.0f} samples/s, "
        f"syncs {100 * out['one_bit']['sync_share']:.1f}%; on {card}")
    return out


def resnet_fit(torch, trainer, X, y, steps: int) -> dict:
    _sync(torch)
    t0 = time.perf_counter()
    losses = trainer.fit(X, y, steps=steps, batch_size=RESNET_BATCH,
                         seed=1)
    wall = time.perf_counter() - t0
    if not np.all(np.isfinite(losses)):
        raise SystemExit(f"phase 26c: non-finite losses {losses}")
    return dict(losses=losses, seconds=wall,
                images_per_sec=steps * RESNET_BATCH / wall)


def phase_resnet(torch, core, card, dev) -> dict:
    """26c: ResNet-50 at full width; one step on (1, 1) and (4, 1) meshes
    of ``dev`` from the same weights, then steps of each, then through the
    binding, then the tiny arch's learning bar."""
    from multiverso_tpu_torch.bindings.torch_ext import ParamManager
    from multiverso_tpu_torch.examples import resnet_imagenet as rn
    X, y = rn.synthetic_imagenet(RESNET_N, size=RESNET_SIZE)
    meshes = {"(1, 1)": core.Mesh([[dev]]), "(4, 1)": core.Mesh([[dev]] * 4)}
    trainers = {k: rn.ResNetTrainer("resnet50", learning_rate=RESNET_LR,
                                    mesh=m) for k, m in meshes.items()}
    n_params = sum(v.numel() for v in trainers["(1, 1)"].params.values())
    leaves = len(trainers["(1, 1)"].params)
    if (n_params, leaves) != RESNET50_SIZE:
        raise SystemExit(f"phase 26c: ResNet-50 has {n_params} parameters "
                         f"in {leaves} leaves")
    idx = np.random.default_rng(0).integers(0, RESNET_N, RESNET_BATCH)
    one = {k: float(t.train_step(X[idx], y[idx]))
           for k, t in trainers.items()}
    a, b = (t.params for t in trainers.values())
    worst = 0.0
    for k in a:
        diff = (a[k] - b[k]).abs()
        worst = max(worst, float(diff.max()))
        if not torch.all(diff <= 1e-5 + 1e-4 * b[k].abs()):
            raise SystemExit(f"phase 26c: {k} after one step differs "
                             f"between (1, 1) and (4, 1) by "
                             f"{float(diff.max())}")
    runs = {k: resnet_fit(torch, t, X, y, RESNET_STEPS)
            for k, t in trainers.items()}
    del trainers, a, b
    free_tables(torch)
    core.set_mesh(meshes["(1, 1)"])
    bind = rn.BindingResNetTrainer("resnet50", learning_rate=RESNET_LR,
                                   sync_every=1, mesh=meshes["(1, 1)"])
    with timed_method(ParamManager, "sync_all_param") as sync:
        b_run = resnet_fit(torch, bind, X, y, RESNET_BIND_STEPS)
    gen = bind.pm._table._table.generation
    if gen != 1 + RESNET_BIND_STEPS:
        raise SystemExit(f"phase 26c: the handler's generation {gen} != "
                         f"1 + {RESNET_BIND_STEPS} syncs")
    b_run.update(sync_s=sync["seconds"] / sync["calls"],
                 sync_share=sync["seconds"] / b_run["seconds"],
                 generation=gen, sync_bytes=4 * n_params)
    del bind
    free_tables(torch)
    Xt, yt = rn.synthetic_imagenet(2048, size=16, seed=2)
    tiny = rn.ResNetTrainer("tiny", learning_rate=0.05,
                            mesh=core.Mesh([[dev]] * 8), seed=2)
    t0 = time.perf_counter()
    t_losses = tiny.fit(Xt, yt, steps=RESNET_TINY_STEPS, batch_size=256,
                        seed=2)
    t_acc = tiny.accuracy(Xt, yt)
    t_s = time.perf_counter() - t0
    if not (np.all(np.isfinite(t_losses)) and t_acc > 0.5
            and np.mean(t_losses[-5:]) < np.mean(t_losses[:5])):
        raise SystemExit(f"phase 26c: tiny accuracy {t_acc}, losses "
                         f"{t_losses[:5]} ... {t_losses[-5:]}")
    for k, r in runs.items():
        log(f"  26c ResNet-50 ({n_params} params, {leaves} leaves) on "
            f"{k} of {dev}, batch {RESNET_BATCH} of {RESNET_SIZE}x"
            f"{RESNET_SIZE}, lr {RESNET_LR}: {r['images_per_sec']:.1f} "
            f"images/s over "
            f"{RESNET_STEPS} steps, loss {r['losses'][0]:.4f} -> "
            f"{r['losses'][-1]:.4f}; on {card}")
    log(f"  26c one step (1, 1) vs (4, 1): losses {one}, params max abs "
        f"diff {worst:.3g}; BindingResNetTrainer sync_every=1: "
        f"{b_run['images_per_sec']:.1f} images/s, a sync "
        f"{1e3 * b_run['sync_s']:.1f} ms ({b_run['sync_bytes']} bytes each "
        f"way, {100 * b_run['sync_share']:.1f}% of the steps' wall), "
        f"generation {gen}; tiny (8, 1) {RESNET_TINY_STEPS} steps: accuracy "
        f"{t_acc:.4f} in {t_s:.1f} s; on {card}")
    return dict(params=n_params, leaves=leaves, one_step_losses=one,
                one_step_max_abs_diff=worst, runs=runs, binding=b_run,
                tiny=dict(accuracy=t_acc, seconds=t_s,
                          losses=[float(x) for x in t_losses]))


def phase_pipeline(torch, core, card, dev) -> dict:
    """26d: ``pipeline_mlp.main`` on a (1, 8) mesh of ``dev``, then
    ``pipeline_apply`` against ``sequential_oracle`` there."""
    from multiverso_tpu_torch.examples import pipeline_mlp
    from multiverso_tpu_torch.parallel.pipeline import (pipeline_apply,
                                                        sequential_oracle)
    t0 = time.perf_counter()
    losses = pipeline_mlp.main([f"-device={dev}", "-data_parallel=1",
                                "-model_parallel=8"])
    main_s = time.perf_counter() - t0
    if core.mesh().shape["model"] != 8:
        raise SystemExit(f"phase 26d: main's mesh {core.mesh()}")
    first, last = float(losses[:5].mean()), float(losses[-5:].mean())
    if not (np.all(np.isfinite(losses)) and last < 0.6 * first):
        raise SystemExit(f"phase 26d: losses {first} -> {last}")
    rng = np.random.default_rng(6)
    p = {"w": torch.tensor(rng.normal(0, 0.5, (8, 16, 16)).astype(
            np.float32), device=dev, requires_grad=True),
         "b": torch.tensor(rng.normal(0, 0.1, (8, 16)).astype(np.float32),
                           device=dev, requires_grad=True)}
    x = torch.tensor(rng.normal(size=(32, 16)).astype(np.float32),
                     device=dev)

    def fn(q, h):
        return torch.tanh(h @ q["w"] + q["b"])

    outs = []
    for run in (lambda: pipeline_apply(p, x, fn),
                lambda: sequential_oracle(p, x, fn)):
        y = run()
        outs.append((y.detach(), torch.autograd.grad((y ** 2).sum(),
                                                     [p["w"], p["b"]])))
    fwd = float((outs[0][0] - outs[1][0]).abs().max())
    grad = max(float((g - h).abs().max())
               for g, h in zip(outs[0][1], outs[1][1]))
    if not (torch.allclose(outs[0][0], outs[1][0], rtol=2e-5, atol=2e-5)
            and all(torch.allclose(g, h, rtol=5e-4, atol=5e-4)
                    for g, h in zip(outs[0][1], outs[1][1]))):
        raise SystemExit(f"phase 26d: pipeline_apply vs the oracle: "
                         f"forward {fwd}, grads {grad}")
    log(f"  26d pipeline_mlp main (8 stages on the model axis of {dev}, "
        f"60 steps of 256): loss {first:.4f} -> {last:.4f} "
        f"({last / first:.3f}x) in {main_s:.2f} s; pipeline_apply vs "
        f"sequential_oracle max abs diff forward {fwd:.3g}, grads "
        f"{grad:.3g}; on {card}")
    return dict(first5=first, last5=last, main_s=main_s,
                forward_max_abs=fwd, grad_max_abs=grad)


def dense_attention(torch, q, k, v, causal: bool):
    """Dense attention in q's dtype (float64 for the checks)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[-1] ** 0.5
    if causal:
        n = s.shape[-1]
        mask = torch.ones(n, n, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v)


def phase_attention(torch, core, card, dev) -> dict:
    """26e: ring and Ulysses attention on an (8, 1) mesh of ``dev`` against
    float64 dense attention, their gradients against dense autograd, and
    their time at S 32,768 beside SDPA's."""
    from multiverso_tpu_torch.parallel import ring_attention, \
        ulysses_attention
    mesh = core.Mesh([[dev]] * 8)
    gen = torch.Generator(device=dev).manual_seed(26)
    shape = (ATTN_B, ATTN_S, ATTN_H, ATTN_D)
    q, k, v = (torch.randn(shape, device=dev, generator=gen)
               for _ in range(3))
    q64, k64, v64 = (t.double() for t in (q, k, v))
    out, fns = {}, {"ring": ring_attention, "ulysses": ulysses_attention}
    for causal in (False, True):
        want = dense_attention(torch, q64, k64, v64, causal)
        for name, fn in fns.items():
            with torch.no_grad():
                got = fn(q, k, v, mesh=mesh, causal=causal)
            err = float((got.double() - want).abs().max())
            if got.dtype != q.dtype or not torch.allclose(
                    got.double(), want, rtol=2e-4, atol=2e-4):
                raise SystemExit(f"phase 26e: {name} causal={causal} max "
                                 f"abs err {err} vs float64 dense")
            out[f"{name}_causal={causal}_max_abs_err"] = err
    leaves = [t.clone().requires_grad_(True) for t in (q64, k64, v64)]
    want = torch.autograd.grad(
        (dense_attention(torch, *leaves, True) ** 2).sum(), leaves)
    for name, fn in fns.items():
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        got = torch.autograd.grad(
            (fn(*leaves, mesh=mesh, causal=True) ** 2).sum(), leaves)
        for which, g, w in zip("qkv", got, want):
            g, w = g.double().flatten(), w.flatten()
            cos = float(g @ w / (g.norm() * w.norm()))
            ratio = float(g.norm() / w.norm())
            if not (cos > 0.9999 and 0.99 < ratio < 1.01):
                raise SystemExit(f"phase 26e: {name} d{which}: cosine "
                                 f"{cos}, norm ratio {ratio}")
            out[f"{name}_d{which}"] = dict(cosine=cos, norm_ratio=ratio)
    del q64, k64, v64, leaves, want
    torch.cuda.empty_cache()
    shape = (ATTN_B, ATTN_LONG_S, ATTN_H, ATTN_D)
    q, k, v = (torch.randn(shape, device=dev, generator=gen)
               for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    F = torch.nn.functional
    with torch.no_grad():
        times = {name: cuda_ms(lambda fn=fn: fn(q, k, v, mesh=mesh,
                                                causal=True), 2)
                 for name, fn in fns.items()}
        times["sdpa"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 2)
    out["long_ms"] = times
    log(f"  26e ring / Ulysses on (8, 1) of {dev} (B {ATTN_B}, H {ATTN_H}, "
        f"D {ATTN_D}, float32): S {ATTN_S} within 2e-4 of float64 dense "
        f"(max abs err "
        + ", ".join(f"{k.replace('_max_abs_err', '')} {v:.2e}"
                    for k, v in out.items() if k.endswith("err"))
        + "); gradients (causal) cosine >= "
        f"{min(v['cosine'] for k, v in out.items() if '_d' in k):.7f}, "
        f"norm ratio within "
        f"{max(abs(v['norm_ratio'] - 1) for k, v in out.items() if '_d' in k):.2e}"
        f"; S {ATTN_LONG_S} causal: ring {times['ring']:.1f} ms, Ulysses "
        f"{times['ulysses']:.1f} ms, SDPA (yardstick) {times['sdpa']:.1f} "
        f"ms; on {card}")
    return out


def phase_binding_examples(torch, core, counts, reset, card,
                           dev: str = "cuda:0") -> tuple:
    """Phase 26 (module doc) on ``dev``: its five parts, each timed;
    returns the results and the binding row path's launches. The runtime
    mesh is restored after it."""
    before = core.mesh()
    parts, seconds = {}, {}
    try:
        for key, fn in (
                ("a", lambda: phase_bindings(torch, core, counts, reset,
                                             card, dev)),
                ("b", lambda: phase_mlp_cifar(torch, card, dev)),
                ("c", lambda: phase_resnet(torch, core, card, dev)),
                ("d", lambda: phase_pipeline(torch, core, card, dev)),
                ("e", lambda: phase_attention(torch, core, card, dev))):
            t0 = time.perf_counter()
            parts[key] = fn()
            seconds[key] = time.perf_counter() - t0
            log(f"  [26{key}: {seconds[key]:.1f} s]")
            free_tables(torch)
    finally:
        core.set_mesh(before)
    parts["a"], launches = parts["a"]
    parts["seconds"] = seconds
    return parts, launches


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import multiverso_tpu_torch as mvt
    except ImportError as e:
        print(f"chip_smoke: multiverso_tpu_torch is not beside this "
              f"script ({e}); run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    from multiverso_tpu_torch.apps.lightlda import (LDAConfig, LightLDA,
                                                    load_docs)
    from multiverso_tpu_torch.apps.logreg import (LogisticRegression,
                                                  LogRegConfig,
                                                  synthetic_blobs)
    from multiverso_tpu_torch.apps.word_embedding import (W2VConfig,
                                                          WordEmbedding)
    from multiverso_tpu_torch.data import (Corpus, synthetic_docs,
                                           synthetic_text)
    from multiverso_tpu_torch import core
    from multiverso_tpu_torch.data import _native_build, load_native
    from multiverso_tpu_torch.ops import _build
    from multiverso_tpu_torch.ops import lda_sampler as ls
    from multiverso_tpu_torch.ops import table_kernels as tk
    from multiverso_tpu_torch.apps.sparse_logreg import (
        SparseLogisticRegression, SparseLRConfig, lr_step, synthetic_sparse)
    from multiverso_tpu_torch.tables import (KVTable, MatrixTable,
                                             SparseMatrixTable,
                                             make_superstep)
    from multiverso_tpu_torch.updaters import AddOption
    from multiverso_tpu_torch import telemetry
    from multiverso_tpu_torch.telemetry import trace
    from multiverso_tpu_torch.ft import chaos as tchaos
    from multiverso_tpu_torch.ft import checkpoint as tckpt
    from multiverso_tpu_torch.ops import stat_kernels
    from multiverso_tpu_torch.ops.table_kernels import ShardedParam
    from multiverso_tpu_torch.tables import base as tbase
    from multiverso_tpu_torch.telemetry import health as thealth
    from multiverso_tpu_torch.utils import configure
    from multiverso_tpu_torch import client as tclient
    from multiverso_tpu_torch.client import coalesce
    from multiverso_tpu_torch.control import controller as tctl
    from multiverso_tpu_torch.storage import TieredKVTable
    from multiverso_tpu_torch.utils import quantization as quant
    from multiverso_tpu_torch.server.table_server import TableServer
    from multiverso_tpu_torch.client import transport as wire_transport
    from multiverso_tpu_torch.client import router as fleet_router
    profile = "--profile" in argv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_s = {}

    def phase(name: str, title: str):
        phase_s[name] = time.perf_counter()
        log(title)

    def phase_end(name: str) -> None:
        phase_s[name] = time.perf_counter() - phase_s[name]
        log(f"  [{name}: {phase_s[name]:.1f} s]")

    def counts() -> dict:
        return {**tk.LAUNCHES, **ls.LAUNCHES}

    def reset() -> None:
        tk.reset_launches()
        ls.reset_launches()

    # phase 18 runs in parts beside the phases whose apps it reuses; its
    # seconds are their sum
    tel, tel_dir = {}, tempfile.TemporaryDirectory()
    phase_s["telemetry"] = 0.0

    def tel_part(key: str, fn, *args) -> None:
        t0 = time.perf_counter()
        tel[key] = fn(*args)
        phase_s["telemetry"] += time.perf_counter() - t0

    # so does phase 19 (health and checkpoints)
    h19 = {}
    phase_s["health"] = 0.0

    def h19_part(key: str, fn, *args) -> None:
        t0 = time.perf_counter()
        h19[key] = fn(*args)
        phase_s["health"] += time.perf_counter() - t0

    # and phase 20 (the client pipeline and the control plane)
    c20 = {}
    phase_s["client"] = 0.0

    def c20_part(key: str, fn, *args) -> None:
        t0 = time.perf_counter()
        c20[key] = fn(*args)
        phase_s["client"] += time.perf_counter() - t0

    phase("device", "phase 1: device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"  card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    mvt.init()                              # cuda:0
    t0 = time.perf_counter()
    _build.load()
    log(f"  kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds:.2f} s, one process per source)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"    {line.strip()}")
    t0 = time.perf_counter()
    native = load_native()
    log(f"  native data library built and loaded in "
        f"{time.perf_counter() - t0:.2f} s (g++ "
        f"{_native_build.build_seconds:.2f} s): {native.path}")
    phase_end("device")

    rng = np.random.default_rng(0)
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        phase("kernels", "phase 2: kernels vs plain (tolerance: gather "
              "exact; scatter-adds exact against the CPU plain version, "
              "row scatter within the float32 sum-order bound against the "
              "card's; Gibbs samplers under the tie rule, counts exact; KV "
              "lookup and probe + commit bit-identical to the CPU plain "
              "version, 2-byte adagrad to the card's)")
        results = phase_kernels(torch, tk, rng)
        scatter_calls = results.pop("scatter_calls")
        lda_results = phase_lda_kernels(torch, tk, ls)
        kv_results = phase_kv_kernels(torch, tk, KVTable)
        devices = shard_devices(torch)
        log(f"  sharded forms on the mesh {devices} (S = {SHARDS})")
        sharded_results = phase_sharded_kernels(torch, tk, core, KVTable,
                                                devices, rng)
        mesh_results = phase_mesh_kernels(torch, tk, devices, rng)
        kv_dtype_results = phase_kv_dtypes(torch, tk, KVTable, devices,
                                           kv_results, sharded_results)
        w2v_small_parity(torch, Corpus, synthetic_text, W2VConfig,
                         WordEmbedding, tmp)
        w2v_mesh_small_parity(torch, core, Corpus, synthetic_text,
                              W2VConfig, WordEmbedding, devices, tmp)
        lda_small_parity(LDAConfig, LightLDA, load_docs, synthetic_docs,
                         tmp)
        slr_small_parity(torch, SparseLogisticRegression, SparseLRConfig,
                         synthetic_sparse)
        phase_end("kernels")

        reset()
        phase("w2v", "phase 3: MatrixTable Get/Add on the card")
        phase_tables(torch, MatrixTable, AddOption, rng)
        log("phase 4: word2vec skip-gram NS at full width")
        w2v, w2v_run = phase_w2v(torch, tk, Corpus, synthetic_text,
                                 W2VConfig, WordEmbedding, tmp, profile)
        paths["word2vec"] = counts()
        phase_end("w2v")

        log("phase 18: telemetry (a: phase 4's word2vec, sinks off, on, "
            "on, off; c: the watchdog; d: device memory)")
        tel_app = w2v_run.pop("app")
        tel_batches = w2v_run["batches"][:16]
        tel_part("w2v", phase_telemetry_w2v, torch, tk, telemetry, trace,
                 tel_app, w2v_run["batches"], w2v_run["pairs_per_token"],
                 tel_dir.name)
        log("phase 19b/d: phase 4's word2vec with MVTPU_HEALTH unset, "
            "set, set, unset; a generation of its tables and a call "
            "queued right after the save")
        h19_part("w2v", phase_health_w2v, torch, thealth, telemetry,
                 tel_app, w2v_run["batches"], w2v_run["pairs_per_token"])
        h19_part("ckpt_w2v", phase_ckpt_w2v, torch, tckpt, tbase,
                 telemetry, tel_app, w2v_run["batches"], tel_dir.name)
        log("phase 20b: phase 4's word2vec with MVTPU_STALENESS=1, "
            "embeddings() through the cached view")
        c20_part("view_w2v", phase_view_w2v, torch, tclient, telemetry,
                 tel_app, w2v_run["batches"], w2v_run["pairs_per_token"],
                 card)
        tel_part("watchdog", phase_telemetry_watchdog, torch, tk, telemetry,
                 tel_dir.name)
        tel_part("device_memory", phase_telemetry_memory, torch, telemetry)
        tel_part("compiles", phase_telemetry_compiles, telemetry,
                 {"torch_kernels": _build, "mvtpu_data": _native_build})

        phase("w2v_own", "phase 4c: word2vec through its own pair stream "
              "(WordEmbedding.train without batches=), native and Python "
              "backends")
        w2v_own, own_paths = phase_w2v_own_iterator(
            torch, counts, reset, WordEmbedding, w2v, w2v_run)
        paths.update(own_paths)
        phase_end("w2v_own")

    reset()
    phase("sparse", "phase 5: SparseMatrixTable on the card vs numpy")
    phase_sparse_tables(SparseMatrixTable, rng)
    paths["sparse_tables"] = counts()
    phase_end("sparse")

    phase("lda", "phase 6: LightLDA doc-blocked at the LDA metric of "
          "record's width")
    t0 = time.perf_counter()
    tw, td = zipf_lda_corpus(LDA_V, LDA_D, LDA_T, seed=0)
    log(f"  corpus: V {LDA_V}, D {LDA_D}, T {LDA_T} (Zipf-1.1), made in "
        f"{time.perf_counter() - t0:.2f} s; top word holds "
        f"{100 * np.bincount(tw).max() / LDA_T:.1f}% of the tokens")
    reset()
    torch.cuda.reset_peak_memory_stats()
    lda = phase_lda(torch, tk, ls, LightLDA, LDAConfig, tw, td, profile,
                    then=lambda app: (
                        tel_part("lightlda", phase_telemetry_lda, torch,
                                 telemetry, trace, app, tel_dir.name),
                        h19_part("ckpt_lda", phase_ckpt_lda, torch, tckpt,
                                 telemetry, app, tel_dir.name),
                        log("phase 20b: phase 6's LightLDA with "
                            "MVTPU_STALENESS=2, word_topics() through the "
                            "cached view"),
                        c20_part("view_lda", phase_view_lda, torch, tclient,
                                 telemetry, app, card)))
    paths["lightlda_doc_blocked"] = counts()
    phase_end("lda")

    reset()
    phase("lda_mh", "phase 6b: LightLDA sampler=mh at the same width")
    lda_mh = phase_lda_mh(torch, tk, ls, LightLDA, LDAConfig, tw, td, lda,
                          profile)
    paths["lightlda_mh"] = counts()
    phase_end("lda_mh")

    reset()
    phase("lda_tiled", "phase 7: LightLDA sampler=tiled at the same width")
    lda_tiled = phase_lda_tiled(torch, tk, ls, LightLDA, LDAConfig, tw, td)
    paths["lightlda_tiled"] = counts()
    phase_end("lda_tiled")
    del tw, td

    reset()
    phase("lda_streamed", "phase 8: LightLDA streamed vs in-memory at "
          "reduced depth")
    lda_streamed = phase_lda_streamed(torch, LightLDA, LDAConfig)
    paths["lightlda_streamed"] = counts()
    phase_end("lda_streamed")

    with tempfile.TemporaryDirectory() as tmp:
        phase("kv_table", "phase 9: KVTable on the card vs numpy")
        phase_kv_table(torch, KVTable, AddOption, rng, tmp)
        phase_end("kv_table")

    reset()
    phase("sparse_lr", "phase 10: sparse logistic regression at a "
          "Criteo-like width")
    slr, paths["sparse_logreg"], slr_data = phase_sparse_lr(
        torch, tk, counts, SparseLogisticRegression, SparseLRConfig,
        synthetic_sparse, lr_step, profile,
        then=lambda app, rows, y: tel_part(
            "sparse_lr", phase_telemetry_slr, torch, tk, telemetry, trace,
            KVTable, app, rows, y, tel_dir.name))
    phase_end("sparse_lr")

    log("phase 20a/c/d: phase 10's sparse LR coalesced (MVTPU_COALESCE=4), "
        "its adds staged, and K tuned live by the controller")
    c20_part("coalesced_slr", phase_coalesced_slr, torch, tk, counts,
             coalesce, telemetry, tclient, KVTable, AddOption,
             SparseLogisticRegression, SparseLRConfig, slr_data, card)
    c20_part("staged_adds", phase_staged_adds, torch, KVTable, AddOption,
             tclient, slr_data["adds"], card)
    with tempfile.TemporaryDirectory() as tmp:
        c20_part("autotune", phase_autotune_slr, torch, tk, counts, mvt,
                 core, tctl, trace, SparseLogisticRegression,
                 SparseLRConfig, slr_data, tmp, card)
    log(f"  [client and control (phase 20, all parts so far): "
        f"{phase_s['client']:.1f} s]")

    mesh = core.Mesh([devices])
    reset()
    phase("sharded_tables", f"phase 11: tables on the {SHARDS}-shard mesh "
          f"{devices} vs unsharded")
    phase_sharded_tables(torch, tk, mesh, MatrixTable, SparseMatrixTable,
                         KVTable, AddOption, rng)
    paths["sharded_tables"] = counts()
    phase_end("sharded_tables")

    reset()
    phase("sharded_sparse_lr", f"phase 12: sparse LR at the Criteo-like "
          f"width on the (1, {SHARDS}) mesh {devices}")
    slr_mesh, paths["sparse_logreg_mesh"] = phase_sharded_sparse_lr(
        torch, tk, counts, mesh, devices, SparseLogisticRegression,
        SparseLRConfig, lr_step, slr_data, profile)
    phase_end("sharded_sparse_lr")

    phase("w2v_mesh", f"phase 13: word2vec skip-gram NS at full width on "
          f"the (1, {SHARDS}) mesh {devices} vs phase 4's (1, 1) run")
    w2v_mesh, mesh_paths = phase_w2v_mesh(
        torch, tk, counts, reset, core, W2VConfig, WordEmbedding,
        SparseMatrixTable, make_superstep, devices, w2v, w2v_run, profile)
    paths.update(mesh_paths)
    phase_end("w2v_mesh")

    phase("w2v_data", "phase 13b: word2vec skip-gram NS at full width on "
          "(4, 1) and (2, 2) meshes (tables replicated over the data axis) "
          "vs phase 4's (1, 1) run")
    w2v_data, data_paths = phase_w2v_data_axis(
        torch, core, counts, reset, W2VConfig, WordEmbedding, w2v, w2v_run)
    paths.update(data_paths)
    del w2v_run
    phase_end("w2v_data")

    reset()
    phase("dense_lr", "phase 15: dense logistic regression at MNIST's shape "
          "on one replica and on a (4, 1) mesh")
    dense = phase_dense_logreg(torch, core, LogisticRegression, LogRegConfig,
                               synthetic_blobs, [["cuda:0"]] * 4)
    paths["logreg_dense"] = counts()
    phase_end("dense_lr")

    phase("lda_mesh", "phase 16: LightLDA tiled exact, doc-blocked and mh "
          "on (4, 1), (1, 4) and (2, 2) meshes vs the (1, 1) run")
    lda_mesh, mesh_lda_paths = phase_lda_mesh(torch, core, counts, reset,
                                              LightLDA, LDAConfig, profile)
    paths.update(mesh_lda_paths)
    phase_end("lda_mesh")

    phase("kv_data_axis", "phase 17: KVTable on (4, 1) and (2, 2) meshes, "
          "with and without shard_update, and sparse LR on (4, 1)")
    reset()
    kv_data = phase_kv_data_axis(torch, tk, counts, reset, core, KVTable,
                                 AddOption, SparseLogisticRegression,
                                 SparseLRConfig, lr_step, slr_data, slr)
    paths["sparse_logreg_data_axis"] = kv_data["slr_launches"]
    phase_end("kv_data_axis")

    phase("tiered_kv", f"phase 21: tiered KV storage (a: the first half of "
          f"the keys of phase 10's first {TIERED_ADDS} adds through a "
          "2^24-slot TieredKVTable on cuda:0 beside a plain table, saved "
          "and resumed; b: on (1, 4) and (2, 2) meshes; c: the quantizers)")
    reset()
    with tempfile.TemporaryDirectory() as tmp:
        tiered = phase_tiered_kv(torch, tk, KVTable, TieredKVTable,
                                 AddOption, tckpt, telemetry,
                                 slr_data["adds"], tmp, card)
        paths["tiered_kv"] = tiered["launches"]
        tiered["meshes"] = phase_tiered_meshes(
            torch, tk, core, TieredKVTable, AddOption, slr_data["adds"],
            tmp, card)
    tiered["quantizers"] = phase_quantizers(torch, quant, card)
    phase_end("tiered_kv")

    phase("wire_server", "phase 22: the wire server on cuda:0 (a: phase "
          "10's adds served as kv_add / kv_get frames; b: four torch-free "
          "worker processes over unix, TCP and shm into a fusing server; "
          "c: a SIGKILLed worker and a chaos storm; d: staleness reads off "
          "the replica)")
    reset()
    wire22 = phase_wire_server(torch, tk, KVTable, TableServer,
                               wire_transport, tchaos, telemetry,
                               slr_data["adds"], card)
    paths["wire_server"] = wire22["a"]["launches"]
    phase_end("wire_server")

    phase("fleet", "phase 23: the server fleet on cuda:0 (2 ranks x "
          "primary + follower, launched by the CLI, through the router; "
          "a: phase 10's adds replicated, bounded reads off the "
          "followers; b: rank 0's primary SIGKILLed, its follower "
          "promoted; c: a live grow 2 -> 3 under a worker's adds, then a "
          "shrink back); phase 24 between a and b: statusz on every "
          "member, the merged metrics, a FleetController, the report CLI; "
          "f after b")
    fleet23 = phase_fleet(torch, KVTable, fleet_router, wire_transport,
                          telemetry, slr_data["adds"], card)
    del slr_data
    phase_end("fleet")

    phase("multiprocess", "phase 25: the multi-process runtime (two worker "
          "processes on cuda:0 over gloo, a (2, 1) mesh: a: word2vec "
          "local_data vs the one-process (2, 1) run; b: LightLDA streamed "
          "local_corpus; c: a KVTable)")
    free_tables(torch)
    mp25 = phase_multiprocess(torch, card)
    phase_end("multiprocess")

    phase("model_axis", "phase 27: a model axis across processes (two "
          "worker processes on cuda:0 over gloo: a: word2vec and b: "
          "sparse LR on a (1, 2) mesh, each process one shard; c: a "
          "shard_update KVTable on (2, 1); d: LightLDA on (1, 2); each vs "
          "the one-process run)")
    free_tables(torch)
    ma27 = phase_model_axis(torch, card)
    for w in ma27["workers"]:
        paths[f"model_axis_rank{w['rank']}"] = w["launches"]
        paths[f"model_axis_lda_rank{w['rank']}"] = {
            k: sum(r["launches"][k] for r in w["lda"].values())
            for k in MA_LDA_KERNELS}
    phase_end("model_axis")

    phase("bindings", "phase 26: the binding-compat API (a), mlp_cifar "
          "(b), ResNet-50 (c), pipeline_mlp (d), ring and Ulysses "
          "attention (e) on cuda:0")
    free_tables(torch)
    p26, paths["bindings"] = phase_binding_examples(torch, core, counts,
                                                    reset, card)
    phase_end("bindings")

    log("phase 19a/c/d: the stat reduction vs numpy; the dense logreg "
        "under a chaos NaN with MVTPU_HEALTH_ACTION=rollback, and killed "
        "after generation 2 and resumed")
    with tempfile.TemporaryDirectory() as tmp:
        h19_part("stats", phase_stats, torch, stat_kernels, ShardedParam)
        h19_part("logreg", phase_health_logreg, torch, core, thealth,
                 tchaos, tckpt, configure, telemetry, LogisticRegression,
                 LogRegConfig, synthetic_blobs, tmp)
    health_clean(telemetry)
    log(f"  [health (phase 19, all parts): {phase_s['health']:.1f} s]")

    phase("scatter_parts", "phase 14: the row scatter's and the KV probe "
          "+ commit's kernels apart (torch.profiler, after every timed "
          "phase)")
    scatter_parts = phase_scatter_parts(torch, tk, KVTable, mesh,
                                        scatter_calls)
    del scatter_calls
    phase_end("scatter_parts")

    log("phase 18e: a profile window over one word2vec call (after every "
        "timed phase)")
    tel_part("profile_window", phase_telemetry_profile, torch, telemetry,
             tel_app, tel_batches, tel_dir.name)
    del tel_app, tel_batches
    tel_dir.cleanup()
    log(f"  [telemetry (phase 18, all parts): {phase_s['telemetry']:.1f} "
        f"s]")

    # each kernel's launches on the main path that carries it
    main_path = {
        "row_gather": "word2vec", "row_scatter_add": "word2vec",
        "row_scatter_plan": "word2vec",
        "row_scatter_add_masked": "word2vec",
        "coo_scatter_add": "lightlda_doc_blocked",
        "coo_scatter_add_masked": "sparse_tables",
        "coo_scatter_plan": "sparse_tables",
        "gibbs_sample_tiled": "lightlda_tiled",
        "gibbs_sample_docblock": "lightlda_doc_blocked",
        "gibbs_sample_docblock_rows": "lightlda_doc_blocked",
        "gibbs_sample_docblock_build": "lightlda_streamed",
        "kv_lookup": "sparse_logreg", "kv_probe_update": "sparse_logreg",
        "kv_lookup_sharded": "sparse_logreg_mesh",
        "kv_probe_update_sharded": "sparse_logreg_mesh",
        "row_gather_sharded": "sharded_tables",
        "row_scatter_add_sharded": "sharded_tables",
        "coo_scatter_add_sharded": "sharded_tables",
        "gather_rows_mesh": "word2vec_mesh",
        "row_scatter_add_mesh": "word2vec_mesh",
        "coo_scatter_add_mesh": "superstep_coo_mesh",
    }
    for name, path in main_path.items():
        if paths[path][name] <= 0:
            raise SystemExit(f"{name}: no launch on the {path} path")
    for name in ("row_gather_sharded", "row_scatter_add_sharded"):
        if paths["bindings"][name] <= 0:
            raise SystemExit(f"{name}: no launch on the bindings path")
    log(f"  word2vec: {w2v['words_per_sec']:.0f} words/s "
        f"({w2v['seconds']:.3f} s for {TIMED_CALLS} calls of "
        f"{STEPS}x{BATCH} pairs) on {card}")
    log(f"  word2vec launches per step: {w2v['launches_per_step']}")
    gen = w2v["pair_generation"]
    log(f"  host pair generation: native 1 thread "
        f"{gen['native_1']['words_per_sec']:.0f} words/s, 4 threads "
        f"{gen['native_4']['words_per_sec']:.0f}, Python backend "
        f"{gen['python']['words_per_sec']:.0f}, on {card}")
    for key, r in w2v_own.items():
        log(f"  word2vec through its own iterator, {key} backend: "
            f"{r['words_per_sec']:.0f} words/s "
            f"({r['words_per_sec'] / w2v['words_per_sec']:.3f}x phase 4's "
            f"pre-generated), on {card}")
    for key in ("(1, 1)", "(4, 1)"):
        r = dense[key]
        log(f"  dense logreg {key}: "
            f"{[round(x) for x in r['samples_per_sec']]} samples/s per "
            f"epoch, train accuracy {r['train_accuracy']:.4f}, on {card}")
    log(f"  word2vec on the (1, {SHARDS}) mesh: "
        f"{w2v_mesh['words_per_sec']:.0f} words/s, "
        f"{w2v_mesh['words_per_sec'] / w2v['words_per_sec']:.3f}x the "
        f"(1, 1) run's, on {card}")
    for key, r in w2v_data.items():
        log(f"  word2vec on the {key} mesh: {r['words_per_sec']:.0f} "
            f"words/s ({r['words_per_sec'] / w2v['words_per_sec']:.3f}x "
            f"the (1, 1) run's), host {r['host_ms_per_step']:.3f} ms a "
            f"step, device busy {100 * r['device_busy_share']:.1f}%, "
            f"exchange {r['exchange_bytes_per_step']:.0f} bytes a step, "
            f"{r['cards']} card(s), on {card}")
    log(f"  LightLDA doc-blocked: {lda['doc_tokens_per_sec']:.0f} "
        f"doc-tokens/s (runs {[round(r) for r in lda['runs_tok_per_sec']]}, "
        f"spread {lda['spread_pct']:.1f}%) on {card}")
    log(f"  LightLDA mh: {lda_mh['doc_tokens_per_sec']:.0f} doc-tokens/s "
        f"(runs {[round(r) for r in lda_mh['runs_tok_per_sec']]}, spread "
        f"{lda_mh['spread_pct']:.1f}%; {lda_mh['vs_doc_blocked']:.3f}x "
        f"doc-blocked) on {card}")
    for mode, meshes in lda_mesh.items():
        log(f"  LightLDA {mode} on meshes (T {LDA_SMALL_T}): " + "; ".join(
            f"{key} {r['doc_tokens_per_sec']:.0f} doc-tokens/s"
            + (f" ({r['vs_one_device']:.3f}x, host "
               f"{r['host_ms_per_step']:.2f} ms a step)"
               if "vs_one_device" in r else "")
            for key, r in meshes.items()) + f", on {card}")
    log(f"  sparse LR: {[round(r) for r in slr['samples_per_sec']]} "
        f"samples/s per epoch on {card}")
    log(f"  sparse LR on the (1, {SHARDS}) mesh: "
        f"{[round(r) for r in slr_mesh['samples_per_sec']]} samples/s per "
        f"epoch on {card}")
    log(f"  launches per path: {paths}")
    t18 = tel["w2v"]
    log(f"  telemetry: word2vec words/s with the sinks off "
        f"{[round(r) for r in t18['words_per_sec_off']]}, on "
        f"{[round(r) for r in t18['words_per_sec_on']]} "
        f"({t18['on_vs_off']:.3f}x); dispatch_s a call "
        f"{t18['dispatch_s_median']:.4f} s (median) against the call's "
        f"wall {t18['call_wall_s_median']:.4f} s; phase 18 "
        f"{phase_s['telemetry']:.1f} s; on {card}")
    h = h19
    log(f"  health: word2vec words/s with MVTPU_HEALTH unset "
        f"{[round(r) for r in h['w2v']['words_per_sec_off']]}, set "
        f"{[round(r) for r in h['w2v']['words_per_sec_on']]} "
        f"({h['w2v']['on_vs_off']:.3f}x), {h['w2v']['record_us']:.2f} us a "
        f"call recorded; summarize "
        + "; ".join(f"{k} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, "
                    f"queue {r['host_ms']:.4f})"
                    for k, r in h["stats"].items())
        + "; generations (dispatch / write / resume ms): "
        + "; ".join(f"{k} {1e3 * r['dispatch_s']:.2f} / "
                    f"{1e3 * r['write_s']:.1f} / {1e3 * r['resume_s']:.1f}"
                    for k, r in (("w2v", h["ckpt_w2v"]),
                                 ("lightlda", h["ckpt_lda"])))
        + f"; phase 19 {phase_s['health']:.1f} s; on {card}")
    a, w, l, d = (c20["coalesced_slr"], c20["view_w2v"], c20["view_lda"],
                  c20["autotune"])
    log(f"  client: sparse LR coalesced x{SLR_COALESCE}: {a['flushes']} "
        f"flushes, probe + commit {a['launches_on']['kv_probe_update']} + "
        f"{a['launches_on']['kv_commit']} (uncoalesced "
        f"{a['launches_off']['kv_probe_update']} + "
        f"{a['launches_off']['kv_commit']}), pre-sum {a['presum_ms']:.4f} "
        f"ms ({100 * a['presum_share_of_flush']:.2f}% of a flush), samples/s "
        f"on/off {a['on_vs_off']:.3f}x; views: w2v staleness {w['staleness']}"
        f", words/s on/off {w['on_vs_off']:.3f}x; LightLDA refresh "
        f"{[round(x, 3) for x in l['refresh_ms']]} ms on the dispatch "
        f"thread, wait {[round(x, 2) for x in l['wait_ms']]} ms; staged "
        f"adds {c20['staged_adds']['staged_s']} s vs direct "
        f"{c20['staged_adds']['direct_s']} s; autotune K {d['k_sequence']}; "
        f"phase 20 {phase_s['client']:.1f} s; on {card}")

    ta = tiered
    log(f"  tiered KV: {TIERED_ADDS} adds of phase 10, host ms a part "
        f"(plan / demote / fill) "
        + "; ".join(f"{r['plan_ms']:.0f} / {r['demote_ms']:.0f} / "
                    f"{r['fill_ms']:.0f}" for r in ta["adds"])
        + f", probe + commit "
        f"{[round(r['device_ms'], 3) for r in ta['adds']]} ms on the card; "
        f"miss ratio {ta['miss_ratio']:.4f}; spill file "
        f"{ta['spill_file_bytes']} bytes; launches {ta['launches']}; "
        f"phase 21 {phase_s['tiered_kv']:.1f} s; on {card}")
    wa = wire22["a"]
    log(f"  wire server: {wa['adds']} kv_adds of {wa['keys_per_add']:.0f} "
        f"keys + their kv_gets at {wa['requests_per_sec']:.1f} requests/s; "
        f"kv_add p50/p99 {wa['kv_add_ms']['p50']:.2f} / "
        f"{wa['kv_add_ms']['p99']:.2f} ms, kv_get "
        f"{wa['kv_get_ms']['p50']:.2f} / {wa['kv_get_ms']['p99']:.2f} ms; "
        f"probe + commit {wa['device_ms_per_add']['p50']:.3f} ms a kv_add; "
        f"replica hits {wa['replica_hits']} of {wa['stale_reads']}; fused "
        f"groups {wire22['b']['groups']}; phase 22 "
        f"{phase_s['wire_server']:.1f} s; on {card}")
    fa, fc23, fo24 = fleet23["a"], fleet23["c"], fleet23["obs"]
    log(f"  fleet: add p50/p99 {fa['add_ms']['p50']:.2f} / "
        f"{fa['add_ms']['p99']:.2f} ms, get {fa['get_ms']['p50']:.2f} / "
        f"{fa['get_ms']['p99']:.2f} ms; follower reads "
        f"{fa['follower_reads']:.0f}, fallbacks "
        f"{fa['follower_fallbacks']:.0f}; recover "
        f"{fleet23['b']['recover_s']:.2f} s; grow "
        f"{fc23['grow']['seconds']:.1f} s / shrink "
        f"{fc23['shrink']['seconds']:.1f} s, "
        f"{fc23['grow']['moved_bytes']} of {fc23['live_bytes']} bytes "
        f"moved; card peak {fleet23['peak_card_mib']} MiB; phase 23 "
        f"{phase_s['fleet'] - fo24['seconds'] - fo24['f']['seconds']:.1f} "
        f"s; on {card}")
    log("  fleet observability: scrape wall p50 over the members "
        + ", ".join(f"{k} {v:.2f}" for k, v in fo24["scrape_ms_p50"].items())
        + f" ms; FleetController check_once {fo24['check_once_ms']:.1f} ms; "
        f"report --fleet {fo24['report_ms']:.0f} ms; phase 24 "
        f"{fo24['seconds'] + fo24['f']['seconds']:.1f} s; on {card}")

    row_src = "multiverso_tpu_torch/ops/csrc/row_kernels.cu"
    plan_src = "multiverso_tpu_torch/ops/csrc/row_plan.cu"
    coo_src = "multiverso_tpu_torch/ops/csrc/coo_kernels.cu"
    lda_src = "multiverso_tpu_torch/ops/csrc/lda_kernels.cu"
    kv_src = "multiverso_tpu_torch/ops/csrc/kv_kernels.cu"
    source_of = {"row_gather": row_src, "row_scatter_add": row_src,
                 "row_scatter_plan": plan_src,
                 "row_scatter_add_masked": row_src,
                 "coo_scatter_add": coo_src,
                 "coo_scatter_add_masked": coo_src,
                 "coo_scatter_plan": coo_src,
                 "gibbs_sample_tiled": lda_src,
                 "gibbs_sample_docblock": lda_src,
                 "gibbs_sample_docblock_rows": lda_src,
                 "gibbs_sample_docblock_build": lda_src,
                 "kv_lookup": kv_src, "kv_probe_update": kv_src,
                 "kv_lookup_sharded": kv_src,
                 "kv_probe_update_sharded": kv_src,
                 "row_gather_sharded": row_src,
                 "row_scatter_add_sharded": row_src,
                 "coo_scatter_add_sharded": coo_src,
                 "gather_rows_mesh": row_src,
                 "row_scatter_add_mesh": row_src,
                 "coo_scatter_add_mesh": coo_src}
    replaces = {
        "row_gather": "multiverso_tpu/ops/table_kernels.py:580",
        "row_scatter_add": "multiverso_tpu/ops/table_kernels.py:610",
        # no Pallas kernel: the XLA argsort that feeds _row_scatter_kernel
        "row_scatter_plan": "multiverso_tpu/ops/table_kernels.py:1340",
        "row_scatter_add_masked": "multiverso_tpu/ops/table_kernels.py:990",
        "coo_scatter_add": "multiverso_tpu/ops/table_kernels.py:652",
        "coo_scatter_add_masked": "multiverso_tpu/ops/table_kernels.py:1068",
        # no Pallas kernel: the XLA argsort that feeds _coo_kernel
        "coo_scatter_plan": "multiverso_tpu/ops/table_kernels.py:1360",
        "gibbs_sample_tiled": "multiverso_tpu/ops/lda_sampler.py:80",
        "gibbs_sample_docblock": "multiverso_tpu/ops/lda_sampler.py:187",
        "gibbs_sample_docblock_rows": "multiverso_tpu/ops/lda_sampler.py:187",
        "gibbs_sample_docblock_build":
            "multiverso_tpu/ops/lda_sampler.py:228",
        "kv_lookup": "multiverso_tpu/ops/table_kernels.py:285",
        "kv_probe_update": "multiverso_tpu/ops/table_kernels.py:426",
        "kv_probe_update_sharded": "multiverso_tpu/ops/table_kernels.py:777",
        "kv_lookup_sharded": "multiverso_tpu/ops/table_kernels.py:920",
        "row_gather_sharded": "multiverso_tpu/ops/table_kernels.py:962",
        "row_scatter_add_sharded":
            "multiverso_tpu/ops/table_kernels.py:1039",
        "coo_scatter_add_sharded":
            "multiverso_tpu/ops/table_kernels.py:1122",
        "gather_rows_mesh": "multiverso_tpu/ops/table_kernels.py:1220",
        "row_scatter_add_mesh": "multiverso_tpu/ops/table_kernels.py:1248",
        "coo_scatter_add_mesh": "multiverso_tpu/ops/table_kernels.py:1282",
    }
    main_n = BATCH * (1 + NEGATIVE)       # the w_out gather/scatter width
    measured = {name: results[(name, main_n)]
                for name in ("row_gather", "row_scatter_add",
                             "row_scatter_plan", "row_scatter_add_masked")}
    measured.update({name: lda_results[name] for name in source_of
                     if name in lda_results})
    # the doc-blocked sweep's one COO add is its 10M-lane rebuild
    measured["coo_scatter_add"] = lda_results["coo_scatter_add@10M"]
    # the sparse-LR path's shapes: the ftrl table at value_dim 2
    measured["kv_lookup"] = kv_results["kv_lookup"]
    measured["kv_probe_update"] = kv_results["kv_probe_update_ftrl_2"]
    measured.update(sharded_results)
    # the w2v mesh path's shapes: w_out's 24,576-lane gather and scatter
    measured["gather_rows_mesh"] = mesh_results[f"gather_rows_mesh@{main_n}"]
    measured["row_scatter_add_mesh"] = \
        mesh_results[f"row_scatter_add_mesh@{main_n}"]
    measured["coo_scatter_add_mesh"] = \
        mesh_results[f"coo_scatter_add_mesh@{LDA_B}"]
    kernels = []
    for name, r in measured.items():
        kernels.append(dict(
            name=name, route="cuda", source=source_of[name],
            replaces=replaces[name], launches=paths[main_path[name]][name],
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
        if name in MA_KERNELS:
            # phase 27's path: each worker's launches
            kernels[-1]["model_axis_launches"] = [
                w["launches"][name] for w in ma27["workers"]]
        if name in MA_LDA_KERNELS:
            # phase 27d's path: each worker's LightLDA launches
            kernels[-1]["model_axis_lda_launches"] = [
                paths[f"model_axis_lda_rank{w['rank']}"][name]
                for w in ma27["workers"]]
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump(dict(card=card, kernels=kernels, w2v=w2v, lightlda=lda,
                       lightlda_tiled=lda_tiled,
                       lightlda_streamed=lda_streamed, lightlda_mh=lda_mh,
                       lightlda_mesh=lda_mesh,
                       launches_per_path=paths, phase_seconds=phase_s,
                       kernel_shapes={f"{k[0]}@{k[1]}": v
                                      for k, v in results.items()},
                       lda_kernel_shapes=lda_results,
                       kv_kernel_shapes=kv_results,
                       kv_two_byte_shapes=kv_dtype_results, sparse_lr=slr,
                       sharded_kernel_shapes=sharded_results,
                       sparse_lr_mesh=slr_mesh,
                       mesh_kernel_shapes=mesh_results, w2v_mesh=w2v_mesh,
                       w2v_data_axis=w2v_data,
                       w2v_own_iterator=w2v_own, dense_logreg=dense,
                       kv_data_axis=kv_data,
                       row_scatter_parts=scatter_parts, telemetry=tel,
                       health=h19, client=c20, tiered_kv=tiered,
                       wire_server=wire22, fleet=fleet23,
                       multiprocess=mp25, model_axis=ma27,
                       bindings_examples=p26,
                       seconds=time.perf_counter() - t_start), f, indent=1)
    log(f"phase seconds: { {k: round(v, 1) for k, v in phase_s.items()} }")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mp-worker"]:
        sys.exit(mp_worker(sys.argv[2:]))
    sys.exit(main(sys.argv[1:]))
