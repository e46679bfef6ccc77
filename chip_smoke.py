#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py                 # N = 2**21, on the card
    python3 chip_smoke.py --n 65536       # a smaller graph
    python3 chip_smoke.py --device cpu --n 16384 --fm-vocab 1000 \
        --gin-nodes 5000 --gnn-nodes 3000 --lm-reduced
                                          # rehearsal: plain versions, no result

Phases, each printed on its own lines (any failure exits non-zero):

1. Device: name, count, and the card's name and power limit from nvidia-smi.
2. Build: compiles every CUDA source of the port (one nvcc per file, in
   parallel) and loads the libraries.
3. Kernels: K1 frontier_round_bsr, K2 bsr_spmm and K3 edge_sum on the card
   against their plain torch versions, at the main path's shapes (the
   N-node host_block_graph tile pool at bs=128, C in {1, 8}, occupancy
   threshold in {0, 0.5}, and the same pool with every other block row
   emptied).  ``sent`` must agree exactly, sums within
   |delta|_1 <= 1e-5 |plain|_1 (fluid values are around 1/N, so the bound is
   relative), and two launches must give bit-identical results; K1's and
   K2's bulk routes (the ones their rules pick at bs=128) must give the
   bits of their simt bodies, launched apart.  K1 also at its input (b):
   the operands of round 3,001 of the ``frontier:pallas`` cold solve (a
   ``SolverSession`` with ``max_rounds=3000``), its armed share printed.
4. Main path: ``repro_torch.solve(Problem.pagerank(host_block_graph(N)),
   method="frontier:pallas")`` on the card must converge with K1 launched
   once per round, and land within |x - x'|_1 <= 1e-5 of the same problem
   solved by ``frontier:segment_sum`` (K3).
5. Requests: one ``SolverSession(problem, "frontier:pallas")`` solves cold,
   its state is held to the invariant |B - (I-P)H - F|_1 <= 1e-4 (|B|_1 +
   |H|_1) in float64 on the host and, through the public ``bsr_spmm`` op
   (K2), in float32 on the card; then it serves 4 drifted right-hand sides
   through ``warm_start`` + ``solve``.  Each must converge, the first with
   fewer edge pushes than the cold solve.  Every K1 launch of phases 4-5
   must run on the bulk route (the wrapper's ``FRONTIER_ROUTES``, printed
   as ``{bulk: n, simt: 0}``).
6. Engine kernels: the K-PID engine's layout at N, k=4 (the sizing rule
   of ``engine:bsr``: 512-slot buckets), built through ``SolverSession``
   (its wall time printed); K2 over the engine's visit table (the port of
   bsr_gather_spmm_pallas) and K3 over the engine's edge table against
   their plain versions on random fluid: relative L1 <= 1e-5, bit-identical
   relaunch, and K2's bulk route the bits of its simt body.
7. Engine main path, N, k=4, policy slope_ema: cold ``engine:bsr`` and
   ``engine:chunk`` solves must converge within |x - x_segment_sum|_1 <=
   1e-5 (2·target_error below N = 2e5: two converged schedules may differ
   by that much) and the invariant of phase 5, with K2 launched once per
   ``engine:bsr`` round and K3 once per ``engine:chunk`` round; one
   ``engine:bsr`` solve with a forced MovePlan(0 -> 3, 2 buckets) after its
   first chunk, under the same gates; one warm request (the drift of phase
   5) on the cold ``engine:bsr`` session, which must converge with fewer
   edge pushes than the cold solve.  Every K2 launch of phases 4-7 must
   run on the bulk route (the wrapper's ``ROUTES``), and at the default N
   and seed each ``engine:bsr`` solve and the ``frontier:pallas`` solve of
   phase 4 must keep their recorded rounds and edge pushes (``RECORDED``).
8. Replay: power_law_graph(1600, seed=7) ordered by out-degree, k=8,
   40 buckets per PID (8 headroom), dynamic with eta=0.9, target 1e-8, on
   both engine backends: converged, max |x - x_dense| < 1e-5 against a
   dense numpy solve, a non-empty move log, the same log on both; its K2
   launches all on the route K2's rule gives its 7-slot tiles (simt).
9. FM serving: the ``fm`` config at full width (39 fields x 10^6 rows, a
   39,000,000 x 10 float32 table drawn from a seeded generator on the
   card) through ``launch.steps``: 8 ``serve_p99`` requests (B=512), one
   ``serve_bulk`` batch (B=262,144) and one ``retrieval_cand`` query
   against 10^6 candidates, each timed with its host batch made before.
   Gates: finite logits; K4 (fm_interaction) launched once per forward
   (and once per retrieval, for the user's own pair term); K4 against its
   plain version on the serve_bulk gather, relative L1 <= 1e-5 and a
   bit-identical relaunch; ``retrieval_score`` equal to ``forward_logits``
   on the same 1,000 candidates within 1e-4.  Prints the wall per request
   and the gather / K4 split.
9 (b). FM training on the same table: the ``train_batch`` cell (B=65,536,
   ``criteo_like_batch(10 + step, ...)``), 4 AdamW steps through
   ``launch.steps``' train kind (dense float32 master, m and v: 4.7 GB),
   the counters zeroed just before.  Gates: per step K4 and its backward
   (``fm_interaction_bwd``) launched once each, the tables' gradient
   (``embedding_gather_bwd``, ``csrc/embedding_bwd.cu``) twice (the table
   and the linear table), no K5 launch and no carry; finite losses; at
   step 0's batch every gradient leaf within relative L1 1e-4 of the plain
   versions' (``loss_fn(kernels=False)``: K4's plain version and the
   plain backwards), the table's and the linear table's gradients
   bit-equal on a rerun; K4's backward against its plain version on the
   step's gather, relative L1 <= 1e-5 and a bit-identical relaunch; the
   tables' gradient (2,555,904 rows into 39,000,000 x 10, and by bags of
   39 into 39,000,000) the same.  Prints the losses, the step walls and
   samples/s, the device memory peak, and a torch.profiler split of one
   more step (gather, K4, K4's backward, the tables' gradient, K5, the
   sort, AdamW read from a trace of AdamW alone over one step's
   gradients, the rest).  Rows for the kernels line:
   ``fm_interaction_bwd`` (no library call) and ``embedding_gather_bwd``
   (``zeros().index_add_`` of the same rows as the library call; beside
   it the linear table's launch and its library call, K5's gather form
   over the same rows at both widths, timed in turns with the kernel, and
   a ``torch.zeros`` of the output alone).
10. GIN forward: ``gin-tu`` at the ``ogb_products`` cell on a synthetic
   ``power_law_graph`` (2,449,029 nodes, alpha chosen to stay under the
   cell's 61,859,328 edges, padded to it with edge_mask-0 edges and to
   2,449,056 nodes): two forwards over the destination-sorted batch, each
   layer's aggregation K5 in its gather form (rows = the sources, data =
   the node states).  Gates: K5 (segment_sum) launched 5 times per
   forward, every launch in the gather form and followed by one launch
   of its carry kernel; the forward's device memory peak above what
   earlier phases hold under E·d·4 bytes (no [E, d] message buffer);
   the [N, 47] output finite and within relative L1 <= 1e-5 of the same
   forward with K5 replaced by its plain version; K5 against its plain
   version on layer 0's messages (contiguous form) and on layer 0's node
   states (gather form), relative L1 <= 1e-5 and a bit-identical
   relaunch each, and,
   exactly, on a small integer-valued case with sentinel ids and mask-0
   rows in both forms.  Prints N, E, the real E, the host build times,
   K5's chunk count and longest segment, the forward's wall and its
   device memory peak.
10 (b). GIN training on phase 10's graph and prepared batch (whose
   ``prepare_batch`` also sorted the edges by source, the transposed
   view): 3 AdamW steps of the ``ogb_products`` cell through
   ``launch.steps``, the counters zeroed just before.  Gates: per step K5
   launched 5 times forward (``segment_sum``) and 5 times backward
   (``gnn_agg_bwd``, K5's gather form over the transposed graph), all in
   the gather form, each with its carry; finite losses; every leaf's
   gradient within relative L1 1e-4 of the plain run's
   (``loss_fn(kernels=False)``), each of the 5 K5 backwards of a
   gradient relaunched on its operands bit for bit; K5 as one layer's
   aggregation backward against its plain version, relative L1 <= 1e-5
   and a bit-identical relaunch.  Prints the losses, the step walls and
   the device memory peak above phase 10's.  Row for the kernels line:
   ``segment_sum_gather_bwd`` (``torch.sparse.mm`` of the transposed
   ``sparse_csr`` as the library call).
10 (c). MeshGraphNet (15 layers, d 128), EGNN (4 layers, d 64) and
   DimeNet (6 blocks, d 128, 8 bilinear, 7 spherical and 6 radial
   channels) at full width, after 10 (b) releases GIN's batch.  (a) 3
   AdamW steps each of the ``molecule`` cell (``molecule_batch``: 128
   graphs, N 3,840, E 8,192, its 16,850 triplets padded to the cell's
   65,536 with ``trip_mask`` 0) through ``launch.steps``, counters zeroed
   just before.  Gates: finite losses; per step exactly the launches the
   code implies (``gnn_launches``: K5 and its carry once an aggregation and
   once for the pooling, ``embedding_gather_bwd`` once a gather that wants
   a gradient; no other kernel), DimeNet's triplet aggregations in K5's
   contiguous form; every gradient leaf within relative L1 1e-4 of
   ``loss_fn(kernels=False)``'s, and bit-equal on a rerun.  (b) The
   forward of each at ``minibatch_lg``: a ``power_law_graph`` of the
   cell's 169,984 nodes at ``GNN_ALPHA`` (166,876 edges, under the cell's
   168,960), ``make_gnn_batch(with_pos, with_triplets)`` (d_feat 602)
   padded to the cell's N, E and T = 1,351,680, built on the host thread
   after phase 10's graph; one sort of it serves the three.  Gates: the
   launches a forward implies; the ``[N, d_out]`` output finite and within
   relative L1 1e-5 of the plain version's.  Prints each forward's wall and
   device memory peak.  (c) Rows for the kernels line, on (b)'s operands
   against their plain versions (relative L1 <= 1e-5, a bit-identical
   relaunch) with ``index_add_`` as the library call:
   ``segment_sum_mgn_agg`` (MeshGraphNet's aggregation, [E, 128], the
   gather form over the destination sort), ``segment_sum_egnn_pos``
   (EGNN's position update, [E, 3]), ``segment_sum_dimenet_trip``
   (DimeNet's triplet aggregation, [T, 128], contiguous, ``trip_mask`` the
   weight) and ``embedding_gather_bwd_d128`` (the gathers' gradient at d
   128: ``m[trip_f]``'s, T rows into E); their launches those of (a) and
   (b) by role (the gated counts).  Prints the phase's wall.
11. Numbers: rounds, ops, wall times, launch counts of the main path
   (phases 4 and 5, and phase 7, counters zeroed just before each solve
   and read just after; K2 runs in phase 5 only in the invariant check,
   off the solve loop, so its count there is 0 and its check launch is
   reported apart), and each kernel's CUDA-event time at the main path's
   shapes beside its bound (the larger of bytes over 3.35 TB/s and flops
   over 67 TFLOP/s f32, or 989 TFLOP/s for K6's bf16, counted for this
   run's inputs), its plain version's time and a one-call library
   yardstick (torch.sparse.mm on a sparse_bsr tensor for K2, index_add_
   for K3, none for K1).  The K1 and K2 rows also carry the body that ran
   them (``kernel``) and their TB/s (K2's also the library call's); K1's
   row carries its armed tile share, its ratio to K2's time over the same
   pool (``k2_ratio``) and, under ``late_*`` keys, its numbers at input
   (b).  K1 at inputs (a) and (b) and K2 are timed by one rule (``timing``:
   the least of two 20-call means, in turns, the second round reversed);
   every other row is one mean.  The engine's
   K2 and K3 get rows of their own (``bsr_gather_spmm``: the engine:bsr
   rounds of phase 7;
   ``engine_edge_sum``: the engine:chunk rounds); the ``edge_sum`` row
   counts K3 over the node-space edge list (phases 4-5 and the engine's
   warm seed).  K4 and K5 get rows at the FM serve_bulk and GIN layer
   shapes, their launches those of phases 9 and 10 by form (the
   forward runs the gather form only): ``segment_sum``, the contiguous
   form on layer 0's messages, unweighted beside its library yardstick
   ``torch.segment_reduce`` (and weighted, as GIN weights them, with
   ``index_add_`` beside it; both bounds printed in phase 10);
   ``segment_sum_gather``, one GIN layer's aggregation, beside
   ``torch.sparse.mm`` of a ``sparse_csr`` (ptr, src, mask) matrix, its
   bound counting each input byte once (phase 10 prints beside it the
   time of its rows read with no reuse); none for K4.
12. LM serving: qwen1.5-0.5b at full width and depth (24 layers,
   619,570,176 parameters, 1.24 GB bf16 drawn from a seeded generator on
   the card) through ``launch.steps``' prefill / decode kinds, counters
   zeroed just before: request A, 8 prompts x 2,048 tokens
   (``lm_token_batch(0, ...)``) and 32 greedy decode steps over a
   2,080-slot cache; request B, 1 prompt x 32,768 tokens and 16 steps over
   a 32,784-slot cache (prefill_32k / decode_32k at batch 1).  Gates: K6
   (flash_attention) launched 24 times in each prefill and 24 x steps in
   each decode loop, counted apart; each prefill's 24 launches run by
   ``flash_prefill_wgmma_kernel`` (the wrapper's ``ROUTES["wgmma"]``, the
   route ``prefill_route`` gives bf16 at Dh 64), none by another prefill
   kernel; every decode step run with the split
   count ``split_count`` gives at its kv_len (``SPLITS``, added to by the
   wrapper at each launch; the decode kernel combines its splits in the
   same launch); finite logits;
   K6 against its plain version in bf16 on layer 0's q / k / v at each
   prefill (B's on its last 1,024 queries) and at each request's last
   decode step (``kv_len``), max abs err <= 3e-2 and a bit-identical
   relaunch (mean |plain| and relative L1 printed beside it); each
   decode's inputs cast to float32, K6 within rtol 1e-5 / atol 1e-6 of the
   plain version, B's on the split path; a float32 copy of the weights
   through A's prefill and 8
   decode steps teacher-forced on A's tokens, with K6 and with the plain
   attention, logits within relative L1 1e-4.  Prints the prefill walls
   (cold, and warm once more), the wall per decode step and tok/s, the
   device memory peak and a torch.profiler trace of one decode step of
   each request; K6's rows (A's prefill layer and decode step, B's decode
   step and prefill layer, ``scaled_dot_product_attention`` as the
   library yardstick) join phase 11's in the kernels line, each with the
   launches counted at its shape in this phase and the ``kernel`` that ran
   it (``wgmma`` for the prefill rows, ``decode``), the prefill rows' TFLOP/s
   (K6's and the library's, the pairs under the causal mask counted)
   printed on a line of their own; the decode rows also with
   the ``splits`` the last decode step ran with, and with K6 and the
   library call timed by CUDA graph replay as well (``graph_ms``,
   ``library_graph_ms``: without the host's cost per call, which is of the
   kernels' order); ``ms`` and ``library_ms`` are eager in every row.
16. MoE serving, after phase 13 and the release of the engine's and the
   frontier's pools (its weights need the room): (a) qwen2-moe-a2.7b
   at full width and depth (24 layers, 60 routed experts padded to 64,
   top-4, 4 shared; 15,146,207,232 parameters with the padded experts,
   30.29 GB bf16, drawn on the card; the count gated at ``n_params`` plus
   the dead experts) through ``launch.steps``, counters zeroed just
   before: phase 12's requests A and B, each prefilled once and decoded
   once on the bf16 cache (greedy) and once on the int8 cache quantised
   from the same prefill (``quantize_cache``; fed the bf16 decode's
   tokens), then one step of each with the expert-load tap on (a host
   read a layer: the capacity drops by layer and the routed counts, which
   must sum to ``2 x 24 x B x top_k``).  Gates: finite logits; K5's bf16
   form (``segment_sum_bf16``) launched 24 times a prefill and 24 a
   decode step; K6 24 times a prefill and a bf16 decode step; K6's int8
   form (``flash_attention_int8``) 24 times an int8 step and never
   elsewhere.  Prints the prefill walls (cold, and warm once more), the
   wall a decode step and tok/s on each cache, the int8 decode's largest
   relative distance to the bf16 one (printed beside the reference test's
   0.05, not gated), the device memory peak and a torch.profiler trace of
   one decode step on each cache.  (b) K5's bf16 form on layer 0's
   combine at A's prefill and decode against its plain version, relative
   L1 <= 1e-5 and a bit-identical relaunch; K6's int8 form on layer 0's
   int8 decode at A and B: max abs err <= 3e-2 in bf16, a bit-identical
   relaunch, the bits of K6 over a dequantised copy printed, and with q
   cast to float32 within rtol 1e-5 / atol 1e-6.  (c) granite-moe-1b-a400m
   at full width in float32: A's prefill (8 x 2,048) and 8 teacher-forced
   decode steps on the float cache and on the int8 cache, with the kernels
   and with the plain versions (``attention=``, ``combine=``; the plain
   run under torch's deterministic algorithms, so that its index_add_
   sums in slot order and not by atomics): logits
   within relative L1 1e-4 on each; the routing decisions of the two runs
   compared dispatch by dispatch, those that differ printed with their
   top-k margin.  (d) Rows for the kernels line: ``segment_sum_bf16`` (A's
   prefill combine) and ``segment_sum_bf16_decode`` (A's decode combine),
   ``torch.sparse.mm`` of a sparse_csr of the gate weights as the library
   call; ``flash_attention_int8`` (A's decode) and
   ``flash_attention_int8_32k`` (B's), also timed by CUDA graph replay,
   ``scaled_dot_product_attention`` over a dequantised copy as the library
   call; each with the launches counted in this phase.  Only layer 0 of
   each request's caches is kept past its serving, for the checks.
17. LM training, after phase 16 frees its weights: (a) qwen1.5-0.5b at
   full width and depth in bf16 (619,570,176 parameters drawn on the
   card, the count gated), ``launch.steps``' ``train_4k`` cell cut in
   batch (``reduced: batch 256->8``: 8 sequences of 4,096 in 2
   microbatches, ``ce_chunk`` 1024, remat on), 6 AdamW steps on one fixed
   batch through ``runtime.TrainLoop`` with a checkpoint at step 3, the
   counters zeroed just before and read just after.  Gates: finite
   losses, the loss after the 6th step below step 0's, the checkpoints
   written; K6's forward launched 24 x 2 a microbatch (forward and
   recomputation, both the training forward that writes L) and its
   backward (``flash_attention_bwd``) 24, all 24 on the wgmma route
   (``BWD_ROUTES``).  Prints the losses, the wall a step and tok/s, the
   device memory peak, and a torch.profiler trace of one more step with
   its device-busy share and K6's backward kernels' device time.  (b)
   K6's backward on layer 0's operands of a microbatch (captured from a
   training forward; dO drawn from a seeded generator), fed L by the
   training forward (whose o must equal serving's to the bit and whose L
   the plain version's within 1e-5, absolute plus relative), against its
   plain version: relative L1 <= 1e-2 on dq, dk and dv in bf16, both
   calls on the wgmma route, with the inputs cast to float32 within rtol
   1e-5 / atol 1e-6, a bit-identical relaunch; then a float32 copy of the
   weights through one gradient at 2 x 1,024 with the kernels and with
   the plain versions (deterministic, as in phase 16 (c)): every leaf
   within relative L1 1e-4.  (c) granite-moe-1b-a400m at full width in
   bf16 (1,384,963,072 parameters), 4 steps at (a)'s shape through
   ``TrainLoop`` with ``moe_experts=32``: the expert-load monitor's
   observations (2 a layer and microbatch: the tap fires again in the
   recomputation, as the reference's does) and plans printed.  Gates: K5's
   bf16-row form 24 x 2 a microbatch, K6's backward 24 on the wgmma
   route, the combine's backward (``segment_sum_bf16_bwd``) 24, all on
   its stream body (``COMBINE_BWD_ROUTES``), the dispatch's backward, its
   own kernel (``csrc/dispatch_bwd.cu``, ``moe_dispatch_bwd``), 24, and
   K5's carry pass 2 x 24 (the combine's forward and recomputation only);
   the combine's backward on layer 0's operands against its plain version
   (grad_eo bit-equal, grad_w within relative L1 1e-5), a bit-identical
   relaunch and the bits of the warp_row body it replaced, the
   dispatch's within relative L1 1e-5 of its plain version, bit-equal to
   the K5 route it replaced (K5's bf16-row form over the kept and dropped
   slots, then the cast) and on a relaunch; a
   float32 copy's gradient with the kernels against the plain versions
   within relative L1 1e-4, routing flips printed with their top-k
   margin.  (d) Rows for the kernels line: ``flash_attention_bwd`` at
   (b)'s operands (4 x 16 heads x 4,096, Dh 64, bf16; the library call
   the backward of ``scaled_dot_product_attention``; beside it the
   mma.sync pair that the wgmma route replaced, through the library's
   private entry, and the training forward beside serving's; gated at
   1.6 ms a call), ``segment_sum_bf16_bwd`` at (c)'s (``index_add_`` and
   a batched dot; the stream body timed in turns with the warp_row body,
   through the library's private entry) and ``moe_dispatch_bwd`` at (c)'s
   layer 0 (``index_add_`` of the kept rows; timed 3 x 20 calls in turns
   with K5's route plus the cast, which it must beat; its bound the kept
   rows, dest and keep read once and the bf16 output written once), each
   with the launches of its run.  Run it
   alone with ``lm_training(args, torch, dev, Timer(torch, dev), sync)``,
   ``args`` holding ``lm_reduced`` and ``seed``.
13. Simulator: the paper's K-PID simulator (``repro_torch.core.
   DistributedSimulator``) on the card, its push on K7 (sim_messages, the
   messages; sim_push, their sum), at N, K=8, the batch schedule, target
   1/N, the K7 counters zeroed just before each run and read just after.
   Uniform partition, static and dynamic: each must converge, hold the
   §2.2 invariant with F counting the fluid and every outbox, land within
   |h - x_segment_sum|_1 <= 1e-5 of phase 4's solution (2·target_error
   below N = 2e5) and launch each K7 kernel once per push.  A replay of
   the dynamic run through ``repro_torch.solve(problem, "simulator",
   ...)``: equal steps, edge ops, exchanges and move log, and h bit for
   bit.  Both runs again with every whole push timed by CUDA events (its
   stream time), held equal to the clean runs; the static one keeps its
   largest push, the dynamic one the push nearest the static run's median
   by messages, and the dynamic one replays both pushes whole to count
   their device kernels and copies (torch.profiler) and time them back to
   back.  Table 2's protocol at scale: the same graph ordered by
   out-degree, static and dynamic (converged, the invariant; the costs and
   moves printed).  The paper-exact sequential schedule at the paper's N =
   1000 (out-degree order, K=16, dynamic): converged, the invariant.  Every
   run's (steps, edge ops, exchanges, pushes, moves) must equal
   ``SIM_RECORDED`` (the N = 2**21 runs at the default N and seed).  K7
   against its plain versions on CPU copies, ``torch.equal`` and a
   bit-identical relaunch, at the largest and the median push (each one's
   longest bucket printed) and on synthetic pushes: the messages for 600
   nodes of the N = 1000 graph (some with no out-edge) and none (no
   launch); the sum with repeated keys, all remote and empty (no launch).
   Their rows join the kernels line, at the largest push, their launches
   those of the static and dynamic runs, with the median push's numbers
   beside (``median_ms``, ...): ``sim_messages`` (no library call computes
   it) and ``sim_push`` (the whole wrapper as ``ms``, ``index_add_``,
   which is also its plain version, as the library call, the longest
   bucket, a whole push's device kernels and copies and stream time);
   each bound counts each input read once and each output written once,
   flops over 34 TFLOP/s float64.
14. Rank serving, on phase 4's problem and its GraphStore (mutated here,
   after every other phase).  (a) K3's lane form ``edge_sum_lanes`` on
   random fluid at C in {1, 3, 16} (a zero lane in each C > 1) against its
   plain version: relative L1 <= 1e-5, a bit-identical relaunch, each lane
   the bits of K3 launched on its row, a zero lane a zero row and a zero
   input a zero output.  (b) ``SolverSession.solve_batch`` on 3 and 16
   personalized columns (B drifted by 0.02, seeded): converged, the lane
   form launched once per batched round, pad and no pad bit-equal x and
   equal ``ops_per_column`` at C=3, and every column within |dx|_1 <=
   1e-5 of a cold single-lane ``frontier:segment_sum`` solve of it, with
   equal edge pushes.  (c) the continuous-batching ``Scheduler``
   (max_lanes 16, 32 rounds a tick) serves 32 requests over 8 clusters
   (each cluster twice cold, once warm from the pool, then a
   ``rotation_churn`` delta of 0.1 % of the links through
   ``submit_update``, applied at the drain barrier, then 4 clusters twice):
   all served, none dropped, all converged, one update applied, pool hits,
   the 4 requests after the update missing the stale pool, the lane form
   launched once per scheduler round, and two requests before the update
   and two after within 2·target_error of ``solo_reference``.  QPS on the
   host wall, the virtual p50 / p99, occupancy, pool hit rate and rounds
   printed.  (d) ``update_graph`` on a cold-solved ``frontier:pallas``
   session (K1 over the patched tile pool), then on an ``engine:bsr``
   session (k=4, K2 over the patched layout) seeded with the first
   session's converged (F, H), each with its own 0.1 % rotation delta: the
   warm re-solve converges within |dx|_1 <= 1e-5 (2·target_error below N =
   2e5) of a cold ``frontier:segment_sum`` solve on a store rebuilt from
   the spliced edges, with fewer pushes than that solve (and than the
   cold one), its kernel launched once per round.  The lane form's row joins the kernels line at C=16
   (``torch.sparse.mm`` over the destination CSR as the library call), with
   its launches of (b) and (c), the launches a served request, and a
   batched round's ms at C=16 split into the lane form and the rest.
15. Resilience, run before phase 14 (which mutates phase 4's store), on
   fresh GraphStores built from phase 3's graph, after the earlier phases'
   sessions and pools are freed.  (a) A ``frontier:pallas`` session
   (K1) solved to round 2,000 is checkpointed, a second checkpoint is
   torn (``tear_checkpoint``: its H leaf zeroed), and
   ``SolverSession.restore`` must reject the torn step by its invariant
   and restore the intact one; the restored solve's rounds and pushes
   plus the checkpoint's must be ``RECORDED["frontier:pallas"]`` and its x
   bit-equal to phase 4's.  The checkpoint's bytes, its write time and the
   restore's (load and the float64 host invariant check timed apart)
   printed.  (b) ``ChaosRunner.measure`` on ``frontier:pallas`` (grains of
   an eighth of phase 4's rounds, a checkpoint every 2, a torn checkpoint
   at grain 2, a kill at grain 6): converged, one kill, x_err_l1 <= 1e-6; overhead and wasted
   pushes printed.  (c) The supervised stream
   (``launch.stream_bench.run_stream``) on ``engine:chunk`` at k=4 (K3's
   engine edge table): 16 requests drifted 0.3 % each, a graph update of
   1,000 link rotations and a stale-version one, one poison request, kills
   at requests 2 and 9 (PID k-1 at grain 2), planned rescales 4 -> 3 at
   request 5 and 3 -> 4 at 12, a straggler window on PID 1 (requests
   3-5), a checkpoint at every request boundary; then
   ``replay_reference``'s undisturbed twin on the card.  Gates: 0 dropped,
   every served request within |dx|_1 <= 1e-6 of the twin, log counts
   fault >= 2, restore >= 2, rescale >= 2, update_applied >= 1, the
   quarantine exactly one non-finite and one stale-store-version, the
   4 -> 3 drain 6 buckets, K1 and K3 launched.  Pushes (total, undisturbed,
   wasted), each rescale's host wall and its drain, the host walls and
   K3's launches printed.  No kernel joins the kernels line here.
18. Tuner and examples, run after phase 13 (the order of the run: 1-13,
   18, 16, 17, 15, 14).  (a) Depths: at phase 3's pool (bs=128), K1 at
   input (a) and at input (b), K2 over the pool and over phase 6's engine
   visit table, each at every depth the sweep times (``SWEEP_DEPTHS``:
   buffer_depth 1, 2 and 4: rings of 3, 2 and 4 stages), launched apart
   (counted nowhere): within |delta|_1 <= 1e-5 |plain|_1 of the plain
   versions, and bit-equal to depth 1 and to the simt body; the model's
   CTAs an SM (``tune.model.ctas_per_sm``) must be what the source gives
   each launch (``bulk_ctas_per_sm``); K1 (a) and K2 over the pool timed
   at each depth in turns (the least of two 20-call means).  Then phase
   3's and 6's pools are freed.  (b) The sweep: ``tune.run_sweep`` for K1
   and K2 at ``--sweep-n`` nodes (default ``SWEEP_N`` = 2**19, at most N;
   one ``host_block_graph(host_size=bs)`` a bs, built, swept and freed in
   turn), bs in ``SWEEP_BS`` = 32, 64, 128, 256, depths 1,
   2, 4, density 0.25, ``SWEEP_ITERS`` launches a config, into a
   temporary ``REPRO_TORCH_TUNE_DIR``: every row printed (µs, GB/s, the
   roofline fraction against the ``cuda`` spec, shared memory, CTAs an
   SM, feasible or not) with the card's name and power limit; every
   feasible row timed and no other.  (c) The records in use, in that
   directory: ``resolved_config`` gives the winners; a ``frontier:pallas``
   ``SolverSession`` (no explicit bs or depth) takes the K1 record's bs and
   depth and solves phase 4's problem within |x - x_segment_sum|_1 <= 1e-5,
   K1 launched once a round at that depth, its wall printed beside phase
   4's at bs=128; an ``engine:bsr`` session on ``host_block_graph(2**16)``
   (N at most)
   (k=4, slope_ema) reports the K2 record's depth as its
   ``pallas_buffer_depth`` and converges with K2 launched once a round at
   that depth; ``_auto_select``'s choice for phase 4's problem with and
   without the records; then the directory is removed; then, with no
   record, phase 4's ``frontier:pallas`` solve and that ``engine:bsr``
   solve with each of depths 2 and 4 named in the options: the rounds,
   pushes and x bits of depth 1, each kernel launched once a round at the
   depth.  (d) The examples:
   ``repro_torch.examples`` quickstart, solve_web, gnn_partition,
   serve_lm and train_lm at their defaults on the card (train_lm's
   checkpoints in a temporary directory): every solve converged, finite
   losses falling, tokens in the vocabulary; each wall printed.  Rows
   ``frontier_round_bsr_depth2`` / ``_depth4`` and ``bsr_spmm_depth2`` /
   ``_depth4`` join the kernels line (their launches: (c)'s solves at
   that depth named in the options; bound and library call: the depth-1
   rows').

The line before the last is the card's name and power limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
F64_FLOPS_PER_S = 34e12  # H100 SXM float64 outside the tensor cores
BS = 128
REL_L1 = 1e-5
# the kernels the frontier solve loop and warm starts launch; K2 (bsr_spmm)
# is the module's public op, off that loop, and is checked and timed on its
# own
ON_PATH = ("frontier_round_bsr", "edge_sum")
# the kernels of the engine path: K2 (engine:bsr rounds) and K3
# (engine:chunk rounds, warm starts)
ENGINE_PATH = ("bsr_spmm", "edge_sum")
ENGINE_OPTS = {"k": 4, "policy": "slope_ema"}
# (rounds, edge pushes) of the default run's solves (N = 2**21, seed 0), as
# every run of this script on the card gives them: K1 and K2 keep their
# sums' order, so they may not move.  Recorded once more when the threshold
# decay became an IEEE division on the card, as the reference's is (before,
# a product with the host's reciprocal, a bit off in a quarter of the
# values): (3974, 267820931), (3392, 267629992), (3520, 270165051) and
# (1888, 107390909) before
RECORDED = {"frontier:pallas": (3974, 267824486),
            "engine:bsr cold": (3392, 267629883),
            "engine:bsr forced move": (3552, 271170590),
            "engine:bsr warm": (1888, 107390294)}
# the simulator's push: its messages, then their sum
K7 = ("sim_messages", "sim_push")
# (steps, edge ops, exchanges, pushes, moves) of phase 13's runs as every
# earlier run of this script on the card gave them (the N = 2**21 ones at
# the default N and seed): K7 keeps np.add.at's order, so they may not move
SIM_RECORDED = {
    "batch K=8 uniform static": (129, 270550648, 17, 6102, 0),
    "batch K=8 uniform dynamic": (129, 270550648, 17, 6102, 0),
    "out-degree order K=8 static": (373, 344636619, 1380, 26675, 0),
    "out-degree order K=8 dynamic": (216, 291079727, 684, 24411, 49),
    "sequential N=1000 out-degree K=16 uniform dynamic": (79, 39324, 444,
                                                          5976, 48),
}
# K1's input (b) is the round after this many of the frontier:pallas solve
LATE_ROUNDS = 3000
GIN_SHAPE = "ogb_products"
# power_law_graph exponent of the GIN graph: its seed-0 graph at 2,449,029
# nodes has 61,209,125 edges, under the cell's 61,859,328 (alpha 1.65
# expects 64.1M edge stubs, over it)
GIN_ALPHA = 1.655
# phase 10 (c): the other GNN archs, trained at the molecule cell and run
# forward at minibatch_lg on a power_law_graph of the cell's 169,984 nodes
# whose seed-0 graph has 166,876 edges, under the cell's 168,960 (alpha
# 2.46: 170,734, over it)
GNN_ARCHS = ("meshgraphnet", "egnn", "dimenet")
GNN_TRAIN_SHAPE = "molecule"
GNN_FWD_SHAPE = "minibatch_lg"
GNN_ALPHA = 2.47
LM_ARCH = "qwen1.5-0.5b"
# phase 16: the MoE model served in bf16, and the one whose float32 whole
# path is held to the plain versions
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_CHECK_ARCH = "granite-moe-1b-a400m"
# phase 14: the lane widths K3's lane form is checked at, the personalized
# columns' drift, the scheduler's clusters and the churn of each delta (a
# share of the links)
RANK_LANES = (1, 3, 16)
RANK_DRIFT = 0.02
RANK_CLUSTERS = 8
RANK_CHURN = 0.001
# phase 15: the supervised stream's length (16 requests: one applied
# update, one stale one, one poison, two kills, a 4 -> 3 -> 4 rescale)
STREAM_REQUESTS = 16
# phase 18: the tuner's graph (2**19 nodes: at 2**21 the sweep's host
# builds of its four graphs and tile pools take ~60 s of its ~75, which the
# smoke's time limit cannot spare; --sweep-n 2097152 runs it there), its
# grid (the reference's density) and launches a config
SWEEP_N = 2**19
SWEEP_BS = (32, 64, 128, 256)
SWEEP_DEPTHS = (1, 2, 4)
SWEEP_DENSITY = 0.25
SWEEP_ITERS = 10


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def rel_l1(a, b) -> float:
    a = a.double()
    b = b.double()
    return float((a - b).abs().sum() / max(float(b.abs().sum()), 1e-300))


def invariant(b, f_nodes, h_nodes, src, dst, wgt):
    """|B - (I-P)H - F|_1 in float64 on the host, and its bound."""
    ph = np.bincount(dst, weights=h_nodes[src] * wgt, minlength=b.size)
    viol = float(np.abs(b - h_nodes + ph - f_nodes).sum())
    return viol, 1e-4 * float(np.abs(b).sum() + np.abs(h_nodes).sum())


def random_fluid(torch, rng, n, n_pad, c, dev):
    """[n_pad, C] fluid around 1/N like the solver's, with a per-block-row
    scale so that some block columns fall under the occupancy threshold;
    the padding rows 0."""
    f = rng.standard_normal((n_pad, c)) / n
    f *= 10.0 ** rng.uniform(-1, 1, size=(n_pad // BS, 1, 1)).repeat(
        BS, axis=1).reshape(n_pad, 1)
    f[n:] = 0.0
    return torch.as_tensor(f, dtype=torch.float32, device=dev)


def median_threshold(torch, f, w):
    """The median of the nonzero |f|·w (the first 2**24 of them)."""
    fw = (f.abs() * w[:, None]).flatten()
    return torch.quantile(fw[fw > 0].float().cpu()[:2**24], 0.5).to(f.device)


def k1_operands(torch, mat, f, w, t, tau):
    """What ops.frontier_round_bsr hands K1 for the fluid f [n_pad, C]."""
    c = f.shape[1]
    wt = (w / t).to(torch.float32)
    sel = f.abs() * wt[:, None] > 1.0
    blk = sel.reshape(-1, BS * c)
    if tau > 0:
        col_active = (blk.float().mean(dim=1) > tau).to(torch.int32)
    else:
        col_active = blk.any(dim=1).to(torch.int32)
    return (mat.blocks, mat.block_col, mat.row_ptr, col_active,
            f.reshape(-1, BS, c).contiguous(),
            wt.reshape(-1, BS).contiguous())


def late_round(torch, repro_torch, problem, device):
    """K1's input (b): the operands of round ``LATE_ROUNDS + 1`` of the
    frontier:pallas cold solve, from a session stopped after
    ``LATE_ROUNDS`` rounds, built from its driver's state as
    ops.frontier_round_bsr builds them.  Returns ``(operands, rounds
    run)``."""
    session = repro_torch.SolverSession(problem, "frontier:pallas",
                                        device=device, max_rounds=LATE_ROUNDS)
    session.solve()
    drv = session._driver
    f, t = drv.round_inputs()
    return (k1_operands(torch, drv.m, f[:, None], drv.w, t,
                        drv.occupancy_threshold), drv.rounds())


def armed_tiles(col_active, block_col) -> int:
    """The tiles K1 reads: those of armed block columns."""
    return int(col_active.bool()[block_col.long()].sum())


def k1_bytes(ins) -> int:
    """The bytes K1 must move for its operands ``ins``: the armed tiles, its
    index arrays, f read and written, wt and row_l1."""
    blocks, block_col, row_ptr, col_active, f3, wt = ins
    return (armed_tiles(col_active, block_col) * BS * BS * 4
            + block_col.numel() * 4 + row_ptr.numel() * 8
            + col_active.numel() * 4 + f3.numel() * 4 * 2 + wt.numel() * 4
            + f3.shape[0] * 4)


@contextlib.contextmanager
def deterministic(torch):
    """torch's deterministic algorithms (warn only) around a plain version's
    run on the card: its ``index_add_`` then sums in slot order, as on the
    CPU, not by atomics whose order changes from run to run.  Over a
    whole MoE path the atomics' order alone flipped a top-k tie of 2 ulps
    in layer 3 in some runs (relative L1 2.44e-4 against the kernels, 1e-6
    in the others)."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Mean milliseconds per call: CUDA events on the card, the host clock
    in a CPU rehearsal."""

    def __init__(self, torch, device):
        self.torch = torch
        self.cuda = device.type == "cuda"

    def __call__(self, fn, iters: int, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        if not self.cuda:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return (time.perf_counter() - t0) * 1e3 / iters
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters

    def graphed(self, fn, iters: int) -> float:
        """Mean device milliseconds per call with the host's launch cost out
        of the way: ``iters`` calls captured in one CUDA graph (after two
        warm-up calls on a side stream), the graph replayed 3 times.  The
        host clock in a CPU rehearsal."""
        if not self.cuda:
            return self(fn, iters)
        torch = self.torch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        return self(graph.replay, 3, warmup=1) / iters


def least(timer, fns, iters):
    """{name: (least, greatest)} of two ``iters``-call means for each of
    ``fns``, timed in turns: the second round in reverse order, so that
    every function is timed once early and once late."""
    got = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            got[k].append(timer(fns[k], iters))
    return {k: (min(v), max(v)) for k, v in got.items()}


def bound_ms(n_bytes: float, n_flops: float,
             flops_per_s: float = F32_FLOPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_flops = n_flops / flops_per_s * 1e3
    return (max(t_bytes, t_flops),
            "bytes" if t_bytes >= t_flops else "operations")


def device_share(torch, what, fn, untraced_ms=None):
    """One call of ``fn`` under torch.profiler: its wall, the device time of
    its kernels and their share of that wall (the profiler's own host cost
    included, so the share reads low), the share of ``untraced_ms`` (the
    same work's wall without the profiler) where given, and the kernels
    that took most.  Returns the kernels' ``(ms, count, name)`` rows, or
    None when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType

    # the kernels' own rows (the ops that launched them carry their time too)
    stats = sorted(((getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0)) / 1e3,
                     e.count, e.key) for e in prof.key_averages()
                    if getattr(e, "device_type", None) == DeviceType.CUDA),
                   reverse=True)
    stats = [st for st in stats if st[0] > 0]
    busy = sum(st[0] for st in stats)
    if busy == 0:
        print(f"{what} under torch.profiler: wall {wall:.3f} ms, device time "
              "not measured (the trace holds none)")
        return None
    top = ", ".join(f"{key[:48]} x{n} {ms:.3f} ms" for ms, n, key in stats[:6])
    plain = ("" if untraced_ms is None else
             f", {100 * busy / untraced_ms:.1f} % of the {untraced_ms:.3f} ms "
             "untraced wall")
    print(f"{what} under torch.profiler: wall {wall:.3f} ms, device kernels "
          f"{busy:.3f} ms ({100 * busy / wall:.1f} % of the traced wall"
          f"{plain}); top: {top}")
    return stats


class _Captured(Exception):
    """Stops a forward at its first attention call (``first_attention``)."""


def first_attention(run):
    """The inputs of the first attention call of ``run(attention)``: layer
    0's q, k, v (views, as the model hands them to K6), masks and, over the
    int8 cache, scales.  The forward stops there."""
    got = {}

    def capture(q, k, v, *, causal, kv_len=None, **scales):
        got.update(q=q, k=k, v=v, causal=causal, kv_len=kv_len, **scales)
        raise _Captured

    try:
        run(capture)
    except _Captured:
        return got
    fail("the forward never called its attention")


def lm_serving(args, torch, dev, timer, sync):
    """Phase 12: qwen1.5-0.5b served through ``launch.steps`` (requests A
    and B), K6 held to its plain version, the float32 whole-path check and
    K6's rows for the kernels line.  Returns ``(rows, summary)``."""
    import copy

    import torch.nn.functional as fn

    from repro_torch.configs import get_arch
    from repro_torch.configs.smoke import lm_shrink
    from repro_torch.data import lm_token_batch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.attention import attention_plain, flash_attention
    from repro_torch.kernels.attention.kernel import (
        ROUTES, SPLITS, decode_geometry, prefill_route, split_count)
    from repro_torch.launch.steps import build_cell_step
    from repro_torch.models import transformer

    on_card = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 stays float32
    torch.backends.cudnn.allow_tf32 = False
    spec = get_arch(LM_ARCH)
    cfg = lm_shrink(spec.model_cfg) if args.lm_reduced else spec.model_cfg
    # (lm_token_batch step, batch, prompt tokens, decode steps): A batched
    # chat, B the 32k prompt of prefill_32k / decode_32k at batch 1
    requests = {"A": (0, 8, 64 if args.lm_reduced else 2048, 32),
                "B": (1, 1, 512 if args.lm_reduced else 32768, 16)}
    t0 = time.perf_counter()
    model = transformer.init_params(cfg, seed=args.seed, device=dev)
    sync()
    n_par = sum(p.numel() for p in model.parameters())
    width = model.embed.element_size()
    print(f"{cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff="
          f"{cfg.d_ff}, vocab {cfg.vocab}, {model.embed.dtype}: {n_par} "
          f"parameters ({n_par * width / 1e9:.3f} GB), drawn on the device "
          f"in {time.perf_counter() - t0:.3f} s")
    if n_par != cfg.n_params:
        fail(f"{n_par} parameters where the config counts {cfg.n_params}")
    prefill = build_cell_step(spec, spec.cells["prefill_32k"], model)
    decode = build_cell_step(spec, spec.cells["decode_32k"], model)

    n_sm = (torch.cuda.get_device_properties(dev).multi_processor_count
            if on_card else 0)
    # the kernel a prefill of this config runs on (reads csrc/attention.cu)
    route = prefill_route(cfg.dtype, cfg.head_dim) if on_card else None
    if on_card and not args.lm_reduced and route != "wgmma":
        fail(f"{cfg.name}'s prefill routes to {route}, not the wgmma kernel")

    def counted():
        # K6 launches, the split counts they ran with, summed, and the
        # prefill launches by route
        return (LAUNCHES["flash_attention"], SPLITS["flash_attention"],
                *ROUTES.values())

    def serve(name, step, b, s, n_steps):
        tokens = lm_token_batch(step, b, s, cfg.vocab, seed=args.seed)["tokens"]
        before = counted()
        held = torch.cuda.memory_allocated() if on_card else 0
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cache, logits = prefill({"tokens": tokens, "max_seq": s + n_steps})
        sync()
        t_pre = time.perf_counter() - t0
        after_prefill = counted()
        finite = logits.isfinite().all()
        toks = logits.argmax(-1)
        gen, walls, step_splits = [toks], [], []
        for _ in range(n_steps):
            last = (toks, cache["pos"])
            splits_before = SPLITS["flash_attention"]
            t0 = time.perf_counter()
            logits, cache = decode({"tokens": toks, "cache_k": cache["k"],
                                    "cache_v": cache["v"],
                                    "pos": cache["pos"]})
            toks = logits.argmax(-1)
            sync()
            walls.append(time.perf_counter() - t0)
            step_splits.append(SPLITS["flash_attention"] - splits_before)
            finite &= logits.isfinite().all()
            gen.append(toks)
        after_decode = counted()
        # (launches, splits) of the prefill and of the decode loop
        pre = [a - c for a, c in zip(after_prefill, before)]
        dec = [a - c for a, c in zip(after_decode, after_prefill)]
        k6 = pre[0] + dec[0]
        peak = ((torch.cuda.max_memory_allocated() - held) / 1e9 if on_card
                else 0.0)
        kv_gb = cache["k"].numel() * 2 * cache["k"].element_size() / 1e9
        step_ms = 1e3 * sum(walls) / len(walls)
        print(f"request {name}: {b} x {s} tokens, prefill wall "
              f"{t_pre * 1e3:.3f} ms; {n_steps} decode steps over a "
              f"{s + n_steps}-slot cache ({kv_gb:.3f} GB): wall per step "
              f"{step_ms:.3f} ms (first {walls[0] * 1e3:.3f}, min "
              f"{min(walls) * 1e3:.3f}, max {max(walls) * 1e3:.3f}), "
              f"{b * 1e3 / step_ms:.1f} tok/s; K6 launches {k6} (prefill "
              f"{pre[0]}, decode {dec[0]}); device memory peak {peak:.3f} "
              f"GB above the {held / 1e9:.3f} GB held")
        if not bool(finite):
            fail(f"request {name}: logits not finite")
        if on_card:
            # decode step i attends over kv_len = s + i + 1 keys in each
            # layer, split as split_count says; prefill launches add none
            geometry = decode_geometry(cfg.dtype, cfg.head_dim)
            policy = [cfg.n_layers * split_count(
                b, cfg.n_heads, cfg.n_kv_heads, 1, s + i + 1, n_sm, geometry)
                for i in range(n_steps)]
            ran = [n // cfg.n_layers for n in step_splits]
            routes = dict(zip(ROUTES, pre[2:]))
            print(f"request {name}: decode splits per (batch row, kv head) "
                  f"as launched {min(ran)}-{max(ran)}, at most "
                  f"{b * cfg.n_kv_heads * max(ran)} CTAs per launch; "
                  f"prefill splits {pre[1]}; prefill launches by kernel "
                  f"{routes}")
            want = [cfg.n_layers, cfg.n_layers * n_steps, 0, policy,
                    {r: cfg.n_layers if r == route else 0 for r in ROUTES},
                    [0] * len(ROUTES)]
            got = [pre[0], dec[0], pre[1], step_splits, routes, dec[2:]]
            if got != want:
                fail(f"request {name}: K6 (prefill launches, decode "
                     f"launches, prefill splits, splits per decode step, "
                     f"prefill launches by kernel, decode launches counted "
                     f"as prefill) {got}, not {want}")
        return {"tokens": tokens, "cache": cache, "last": last,
                "splits": step_splits[-1] // cfg.n_layers,
                "gen": torch.stack(gen, 1), "prefill_s": t_pre,
                "step_ms": step_ms, "tok_s": b * 1e3 / step_ms,
                "launches": k6, "prefill_launches": pre, "decode_launches":
                dec, "peak_gb": peak, "b": b, "s": s}

    reset_launches()
    with torch.inference_mode():
        served = {name: serve(name, *shape)
                  for name, shape in requests.items()}
    path_launches = counted()
    print(f"LM path K6 launches: {path_launches[0]}, with {path_launches[1]} "
          f"decode splits in all")
    if on_card and path_launches[0] == 0:
        fail("K6 was never launched on the LM path")
    # each request's first prefill carries one-time costs (allocator
    # growth, library set-up for new shapes): time each once more, warm,
    # then trace one decode step after it
    with torch.inference_mode():
        for name, r in served.items():
            t0 = time.perf_counter()
            cache, logits = prefill({"tokens": r["tokens"],
                                     "max_seq": r["s"] + 1})
            sync()
            r["warm_prefill_s"] = time.perf_counter() - t0
            print(f"request {name}: prefill again, warm: "
                  f"{r['warm_prefill_s'] * 1e3:.3f} ms")
            if on_card:
                device_share(torch, f"request {name} decode step", lambda: (
                    decode({"tokens": logits.argmax(-1),
                            "cache_k": cache["k"], "cache_v": cache["v"],
                            "pos": cache["pos"]})), r["step_ms"])
            del cache, logits

    # ---- checks, off the path: K6 against its plain version --------------
    def check(tag, ins, q_start=None):
        """K6 on layer 0's inputs against the plain version; with
        ``q_start`` only the queries from there on are compared."""
        q, k, v = ins["q"], ins["k"], ins["v"]
        kw = {"causal": ins["causal"], "kv_len": ins["kv_len"]}
        out, again = flash_attention(q, k, v, **kw), flash_attention(q, k, v,
                                                                     **kw)
        if q_start is None:
            plain = attention_plain(q, k, v, **kw)
        else:
            plain = attention_plain(q[:, :, q_start:], k, v, q_start=q_start,
                                    **kw)
            out = out[:, :, q_start:]
            again = again[:, :, q_start:]
        err = float((out.float() - plain.float()).abs().max())
        # the scale the bf16 error is read against: one bf16 ulp of the
        # largest output is 2**-7 of its power of two
        scale = float(plain.float().abs().max())
        same = torch.equal(out, again)
        print(f"K6 {tag}: q {tuple(q.shape)} k {tuple(k.shape)} "
              f"{str(q.dtype)[6:]} causal {kw['causal']} kv_len "
              f"{kw['kv_len']}"
              f"{'' if q_start is None else f', from query {q_start} on'}"
              f": max abs err {err:.3e} (bound 3e-2) at max |plain| "
              f"{scale:.3e}, mean |plain| "
              f"{float(plain.float().abs().mean()):.3e}, relative L1 "
              f"{rel_l1(out, plain):.3e}, bit-identical relaunch {same}")
        if not (err <= 3e-2 and same):
            fail(f"K6 against its plain version at {tag}")
        return err

    caps, errs = {}, {}
    with torch.inference_mode():
        for name, r in served.items():
            caps[name + " prefill"] = first_attention(
                lambda att: transformer.prefill_step(
                    model, r["tokens"], attention=att))
            toks, pos = r["last"]
            caps[name + " decode"] = first_attention(
                lambda att: transformer.decode_step(
                    model, {"k": r["cache"]["k"], "v": r["cache"]["v"],
                            "pos": pos}, toks, attention=att))
        errs["A prefill"] = check("A prefill", caps["A prefill"])
        s_b = requests["B"][2]
        errs["B prefill"] = check("B prefill", caps["B prefill"],
                                  q_start=max(0, s_b - 1024))
        errs["A decode"] = check("A decode", caps["A decode"])
        errs["B decode"] = check("B decode", caps["B decode"])

        # ---- each decode's inputs in float32: K6 held tight --------------
        for name in ("A", "B"):
            ins = caps[name + " decode"]
            q, k, v = (ins[n].float() for n in "qkv")
            kw = {"causal": ins["causal"], "kv_len": ins["kv_len"]}
            splits_before = SPLITS["flash_attention"]
            out = flash_attention(q, k, v, **kw)
            ran = SPLITS["flash_attention"] - splits_before
            plain = attention_plain(q, k, v, **kw)
            diff = (out - plain).abs()
            over = int((diff > 1e-6 + 1e-5 * plain.abs()).sum())
            print(f"K6 {name} decode in float32: q {tuple(q.shape)} kv_len "
                  f"{kw['kv_len']}, {ran} split(s): max abs err "
                  f"{float(diff.max()):.3e} at mean |plain| "
                  f"{float(plain.abs().mean()):.3e} (max "
                  f"{float(plain.abs().max()):.3e}), relative L1 "
                  f"{rel_l1(out, plain):.3e}; {over} of {plain.numel()} "
                  f"outside rtol 1e-5 / atol 1e-6")
            if over or (on_card and name == "B" and ran < 2):
                fail(f"K6 {name} decode in float32 against its plain "
                     f"version (or B's not on the split path)")
            del q, k, v, out, plain, diff

        # ---- the whole path in float32: K6 against the plain attention ---
        a = served["A"]
        del served["B"]["cache"]
        m32 = copy.deepcopy(model).float()
        m32.cfg = dataclasses.replace(cfg, dtype=torch.float32)

        def teacher_forced(attention, n=8):
            cache, lg = transformer.prefill_step(
                m32, a["tokens"], max_seq=a["s"] + n, attention=attention)
            out = [lg]
            for i in range(n):
                lg, cache = transformer.decode_step(
                    m32, cache, a["gen"][:, i], attention=attention)
                out.append(lg)
            return torch.stack(out)

        t0 = time.perf_counter()
        l_k6 = teacher_forced(flash_attention)
        l_plain = teacher_forced(attention_plain)
        sync()
        e32 = rel_l1(l_k6, l_plain)
        print(f"float32 copy of the weights, request A prefill + 8 "
              f"teacher-forced decode steps, K6 against the plain "
              f"attention: logits {tuple(l_k6.shape)} finite "
              f"{bool(l_k6.isfinite().all())}, relative L1 {e32:.3e} "
              f"(bound 1e-4); {time.perf_counter() - t0:.1f} s")
        if not (bool(l_k6.isfinite().all()) and e32 <= 1e-4):
            fail("float32 logits with K6 disagree with the plain attention")
        del m32, l_k6, l_plain

        # ---- K6's rows: time, bound, plain version, library yardstick ----
        rows = []

        def row(name, tag, kernel, launches, iters, plain_iters, plain_fn=None,
                splits=None):
            # launches: this run's (launches, splits) at the shape.  With
            # splits (decode): K6 and the library call are also timed by
            # CUDA graph replay, where a call's host cost (tens of
            # microseconds, the kernel's order) does not starve the card
            ins = caps[tag]
            q, k, v = ins["q"], ins["k"], ins["v"]
            causal, kv_len = ins["causal"], ins["kv_len"]
            b, hq, sq, dh = q.shape
            sk = kv_len or k.shape[2]
            if causal:  # the (query, key) pairs under the mask
                pairs = sq * (sq + 1) // 2 if sq == sk else sq * sk
            else:
                pairs = sq * sk
            n_flops = 4.0 * b * hq * dh * pairs
            n_bytes = (2 * q.numel() + 2 * b * k.shape[1] * sk * dh) * (
                q.element_size())
            b_ms, b_by = bound_ms(n_bytes, n_flops, BF16_FLOPS_PER_S
                                  if q.dtype == torch.bfloat16
                                  else F32_FLOPS_PER_S)
            kw = {"causal": causal, "kv_len": kv_len}
            ks, vs = k[:, :, :sk], v[:, :, :sk]

            def lib_fn():
                return fn.scaled_dot_product_attention(q, ks, vs,
                                                       is_causal=causal)

            def k6_fn():
                return flash_attention(q, k, v, **kw)

            plain_fn = plain_fn or (lambda: attention_plain(q, k, v, **kw))
            out = {
                "name": name, "route": "cuda",
                "source": "src/repro_torch/csrc/attention.cu",
                "replaces": "src/repro/kernels/attention/kernel.py:75",
                "kernel": kernel,
                "launches": launches[0], "max_abs_err": errs[tag],
                "ms": timer(k6_fn, iters),
                "plain_ms": timer(plain_fn, plain_iters, warmup=1),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": timer(lib_fn, iters),
                "shape": [b, hq, sq, sk, dh], "dtype": str(q.dtype)[6:],
                "causal": causal,
            }
            if splits is None and on_card:  # prefill: the rate reached
                print(f"K6 {tag} ({kernel}): {n_flops / out['ms'] / 1e9:.1f} "
                      f"TFLOP/s in {out['ms']:.4f} ms; library "
                      f"{n_flops / out['library_ms'] / 1e9:.1f} TFLOP/s in "
                      f"{out['library_ms']:.4f} ms; bound {b_ms:.4f} ms "
                      f"({n_flops / b_ms / 1e9:.1f} TFLOP/s)")
            if splits is not None:
                out.update(splits=splits,
                           graph_ms=timer.graphed(k6_fn, iters),
                           library_graph_ms=timer.graphed(lib_fn, iters))
            return out

        ra, rb = served["A"], served["B"]
        rows.append(row("flash_attention", "A prefill", route,
                        ra["prefill_launches"], 20, 5))
        rows.append(row("flash_attention_decode", "A decode", "decode",
                        ra["decode_launches"], 50, 10, splits=ra["splits"]))
        rows.append(row("flash_attention_decode_32k", "B decode", "decode",
                        rb["decode_launches"], 20, 5, splits=rb["splits"]))
        cb = caps["B prefill"]

        def plain_chunked(chunk=1024):
            # the whole layer's plain version, 1,024 queries at a time (one
            # [1, 16, 32768, 32768] float32 score matrix would be 69 GB)
            q = cb["q"]
            for lo in range(0, q.shape[2], chunk):
                attention_plain(q[:, :, lo:lo + chunk], cb["k"], cb["v"],
                                causal=True, q_start=lo)

        rows.append(row("flash_attention_prefill_32k", "B prefill", route,
                        rb["prefill_launches"], 3, 1,
                        plain_fn=plain_chunked))
    summary = "; ".join(
        f"request {n}: {r['b']} x {r['s']} prefill {r['prefill_s']:.3f} s "
        f"(warm {r['warm_prefill_s']:.3f} s), "
        f"{r['step_ms']:.3f} ms per decode step ({r['tok_s']:.1f} tok/s), "
        f"peak {r['peak_gb']:.3f} GB" for n, r in served.items())
    del caps, served, model
    if on_card:
        torch.cuda.empty_cache()
    return rows, f"LM ({cfg.name}): {summary}"


class _Combined(Exception):
    """Stops a forward at its first MoE combine (``first_combine``)."""


def first_combine(run):
    """The operands of the first MoE combine of ``run(combine)``: layer 0's
    expert outputs, token ids, token count, gate weights and rows, as the
    model hands them to K5.  The forward stops there."""
    got = {}

    def capture(data, seg, n, *, weights=None, rows=None):
        got.update(data=data, seg=seg, n=n, weights=weights, rows=rows)
        raise _Combined

    try:
        run(capture)
    except _Combined:
        return got
    fail("the forward never called its MoE combine")


def moe_serving(args, torch, dev, timer, sync):
    """Phase 16: qwen2-moe-a2.7b served in bf16 through ``launch.steps``
    (requests A and B, each decoded on the bf16 cache and on the int8 cache
    quantised from the same prefill), K5's bf16-row form and K6's int8
    decode form held to their plain versions on layer 0's operands,
    granite-moe-1b-a400m's float32 whole path with the kernels against the
    plain versions, and the two forms' rows for the kernels line.  Returns
    ``(rows, summary)``."""
    import torch.nn.functional as fn

    from repro_torch.configs import get_arch
    from repro_torch.configs.smoke import lm_shrink
    from repro_torch.data import lm_token_batch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.attention import (
        attention_plain, dequantize, flash_attention)
    from repro_torch.kernels.attention.kernel import (
        decode_geometry, split_count)
    from repro_torch.kernels.segment import segment_sum_ref, segment_sum_sorted
    from repro_torch.launch.steps import build_cell_step
    from repro_torch.models import transformer

    on_card = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 stays float32
    torch.backends.cudnn.allow_tf32 = False
    spec = get_arch(MOE_ARCH)
    cfg = lm_shrink(spec.model_cfg) if args.lm_reduced else spec.model_cfg
    m = cfg.moe
    # phase 12's requests: (lm_token_batch step, batch, prompt, decode steps)
    requests = {"A": (0, 8, 64 if args.lm_reduced else 2048, 32),
                "B": (1, 1, 512 if args.lm_reduced else 32768, 16)}
    t0 = time.perf_counter()
    model = transformer.init_params(cfg, seed=args.seed, device=dev)
    sync()
    n_par = sum(p.numel() for p in model.parameters())
    dead = cfg.n_layers * (m.e_pad - m.n_experts) * 3 * cfg.d_model * \
        m.d_ff_expert
    print(f"{cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, "
          f"{m.n_experts} experts (padded to {m.e_pad}) top-{m.top_k} of "
          f"d_ff {m.d_ff_expert} + {m.n_shared} shared, vocab {cfg.vocab}, "
          f"{model.embed.dtype}: {n_par} parameters ({cfg.n_params} counted "
          f"+ {dead} in the padded experts; {cfg.n_active_params} active a "
          f"token; {n_par * model.embed.element_size() / 1e9:.3f} GB), "
          f"drawn on the device in {time.perf_counter() - t0:.3f} s")
    if n_par != cfg.n_params + dead:
        fail(f"{n_par} parameters where the config counts {cfg.n_params} "
             f"+ {dead} padded")
    prefill = build_cell_step(spec, spec.cells["prefill_32k"], model)
    decode = build_cell_step(spec, spec.cells["decode_32k"], model)
    names = ("segment_sum_bf16", "segment_sum_carry", "flash_attention",
             "flash_attention_int8")

    def counted():
        return {k: LAUNCHES[k] for k in names}

    def since(before):
        return {k: LAUNCHES[k] - v for k, v in before.items()}

    def step_batch(tokens, cache):
        batch = {"tokens": tokens, "cache_k": cache["k"],
                 "cache_v": cache["v"], "pos": cache["pos"]}
        if "k_scale" in cache:
            batch.update(cache_k_scale=cache["k_scale"],
                         cache_v_scale=cache["v_scale"])
        return batch

    def serve(name, step, b, s, n_steps):
        tokens = lm_token_batch(step, b, s, cfg.vocab, seed=args.seed)["tokens"]
        held = torch.cuda.memory_allocated() if on_card else 0
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        before = counted()
        t0 = time.perf_counter()
        cache, logits = prefill({"tokens": tokens,
                                 "max_seq": s + n_steps + 1})
        sync()
        t_pre = time.perf_counter() - t0
        pre = since(before)
        q8 = transformer.quantize_cache(cache)
        finite = bool(logits.isfinite().all())
        first = logits.argmax(-1)
        out = {}
        for kind, c in (("bf16", cache), ("int8", q8)):
            toks, walls, lgs, gen = first, [], [], [first]
            before = counted()
            for i in range(n_steps):
                last = (toks, c["pos"])
                t0 = time.perf_counter()
                lg, c = decode(step_batch(toks, c))
                sync()
                walls.append(time.perf_counter() - t0)
                lgs.append(lg)
                # the bf16 decode is greedy; the int8 one is fed its tokens
                toks = lg.argmax(-1) if kind == "bf16" else out["bf16"][
                    "gen"][:, i + 1]
                gen.append(toks)
            finite &= bool(torch.stack(lgs).isfinite().all())
            step_ms = 1e3 * sum(walls) / len(walls)
            out[kind] = {"cache": c, "last": last, "logits": lgs,
                         "gen": torch.stack(gen, 1), "step_ms": step_ms,
                         "walls": walls, "launches": since(before)}
        dist = max(float((a - w).abs().max() / w.abs().max())
                   for a, w in zip(out["int8"]["logits"],
                                   out["bf16"]["logits"]))
        for o in out.values():
            del o["logits"]
        # one more step of each with the expert-load tap on (a host read a
        # layer): the capacity drops of a decode step and the routed counts
        taps = []
        transformer.set_expert_load_sink(taps.append)
        try:
            for kind in ("bf16", "int8"):
                o = out[kind]
                decode(step_batch(o["gen"][:, -1], o["cache"]))
        finally:
            transformer.set_expert_load_sink(None)
        cap = transformer._capacity(b, m)
        drops = [int(np.maximum(c - cap, 0).sum()) for c in taps]
        routed = np.sum(taps, axis=0)
        peak = ((torch.cuda.max_memory_allocated() - held) / 1e9 if on_card
                else 0.0)
        kv_gb = cache["k"].numel() * 2 * cache["k"].element_size() / 1e9
        kv8_gb = (q8["k"].numel() * 2 + q8["k_scale"].numel() * 8) / 1e9
        print(f"request {name}: {b} x {s} tokens, prefill wall "
              f"{t_pre * 1e3:.3f} ms (launches {pre}); {n_steps} decode "
              f"steps over a {s + n_steps + 1}-slot cache: bf16 cache "
              f"({kv_gb:.3f} GB) {out['bf16']['step_ms']:.3f} ms a step "
              f"(first {out['bf16']['walls'][0] * 1e3:.3f}, min "
              f"{min(out['bf16']['walls']) * 1e3:.3f}), "
              f"{b * 1e3 / out['bf16']['step_ms']:.1f} tok/s, launches "
              f"{out['bf16']['launches']}; int8 cache ({kv8_gb:.3f} GB with "
              f"its scales) {out['int8']['step_ms']:.3f} ms a step (min "
              f"{min(out['int8']['walls']) * 1e3:.3f}), "
              f"{b * 1e3 / out['int8']['step_ms']:.1f} tok/s, launches "
              f"{out['int8']['launches']}; logits finite {finite}, int8 "
              f"against bf16 decode (teacher-forced on the bf16 tokens): max "
              f"relative distance {dist:.4e} (the reference's test bounds "
              f"its tiny model at 0.05); device memory peak {peak:.3f} GB "
              f"above the {held / 1e9:.3f} GB held")
        print(f"request {name}: a decode step at capacity {cap} a routed "
              f"expert: {drops[:cfg.n_layers]} slots dropped by layer (bf16 "
              f"cache), {sum(drops[cfg.n_layers:])} in all on the int8 "
              f"cache; the tap's counts summed over both steps' "
              f"{len(taps)} dispatches: {routed.tolist()} "
              f"({int(routed.sum())} routed slots, "
              f"{2 * cfg.n_layers * b * m.top_k} expected)")
        if not finite:
            fail(f"request {name}: logits not finite")
        if int(routed.sum()) != 2 * cfg.n_layers * b * m.top_k:
            fail(f"request {name}: the tap saw {int(routed.sum())} routed "
                 "slots")
        if on_card:
            want_pre = {"segment_sum_bf16": cfg.n_layers,
                        "flash_attention": cfg.n_layers,
                        "flash_attention_int8": 0}
            got_pre = {k: pre[k] for k in want_pre}
            want = {"bf16": {"segment_sum_bf16": cfg.n_layers * n_steps,
                             "flash_attention": cfg.n_layers * n_steps,
                             "flash_attention_int8": 0},
                    "int8": {"segment_sum_bf16": cfg.n_layers * n_steps,
                             "flash_attention": 0,
                             "flash_attention_int8": cfg.n_layers * n_steps}}
            got = {k: {n: out[k]["launches"][n] for n in want[k]}
                   for k in want}
            if got_pre != want_pre or got != want:
                fail(f"request {name}: launches (prefill, decode) "
                     f"{got_pre}, {got}, not {want_pre}, {want}")
        # the checks below read layer 0 only: keep a copy of it, free the
        # rest
        for o in out.values():
            o["cache"] = {k: (t[:1].clone() if torch.is_tensor(t) else t)
                          for k, t in o["cache"].items()}
        del cache, q8, c
        return {"tokens": tokens, "out": out, "prefill_s": t_pre, "b": b,
                "s": s, "pre": pre, "peak_gb": peak, "dist": dist,
                "drops": drops}

    reset_launches()
    with torch.inference_mode():
        served = {name: serve(name, *shape)
                  for name, shape in requests.items()}
    path = counted()
    print(f"MoE path launches (phase 16, both requests): {path}")
    if on_card and not (path["segment_sum_bf16"] and path["flash_attention"]
                        and path["flash_attention_int8"]):
        fail("the MoE path did not launch K5's bf16 form and both K6 forms")
    with torch.inference_mode():
        for name, r in served.items():
            t0 = time.perf_counter()
            cache, logits = prefill({"tokens": r["tokens"],
                                     "max_seq": r["s"] + 1})
            sync()
            r["warm_prefill_s"] = time.perf_counter() - t0
            print(f"request {name}: prefill again, warm: "
                  f"{r['warm_prefill_s'] * 1e3:.3f} ms")
            if on_card:
                device_share(torch, f"request {name} prefill (warm)",
                             lambda: prefill({"tokens": r["tokens"],
                                              "max_seq": r["s"] + 1}),
                             r["warm_prefill_s"] * 1e3)
                q8 = transformer.quantize_cache(cache)
                for kind, c in (("bf16", cache), ("int8", q8)):
                    device_share(torch, f"request {name} decode step, {kind} "
                                 "cache", lambda: decode(step_batch(
                                     logits.argmax(-1), dict(c))),
                                 r["out"][kind]["step_ms"])
                del q8
            del cache, logits

        # ---- (b) the two forms against their plain versions ------------
        caps, errs = {}, {}
        ra, rb = served["A"], served["B"]
        caps["A prefill"] = first_combine(lambda comb: transformer.prefill_step(
            model, ra["tokens"], combine=comb))
        toks, pos = ra["out"]["bf16"]["last"]
        c16 = ra["out"]["bf16"]["cache"]
        caps["A decode"] = first_combine(lambda comb: transformer.decode_step(
            model, {"k": c16["k"], "v": c16["v"], "pos": pos}, toks,
            combine=comb))
        for tag in ("A prefill", "A decode"):
            ins = caps[tag]
            kw = {"weights": ins["weights"], "rows": ins["rows"]}
            got = segment_sum_sorted(ins["data"], ins["seg"], ins["n"], **kw)
            again = segment_sum_sorted(ins["data"], ins["seg"], ins["n"], **kw)
            plain = segment_sum_ref(ins["data"], ins["seg"], ins["n"], **kw)
            e, same = rel_l1(got, plain), torch.equal(got, again)
            errs[tag] = float((got - plain).abs().max())
            print(f"K5 bf16 rows ({tag}, layer 0's combine): eo "
                  f"{tuple(ins['data'].shape)} {str(ins['data'].dtype)[6:]}, "
                  f"{ins['seg'].numel()} slots into {ins['n']} tokens "
                  f"({int((ins['weights'] == 0).sum())} of weight 0): "
                  f"relative L1 {e:.3e} (bound 1e-5), max abs err "
                  f"{errs[tag]:.3e}, bit-identical relaunch {same}")
            if not (e <= REL_L1 and same):
                fail(f"K5's bf16-row form against its plain version at {tag}")
        for name, r in served.items():
            toks, pos = r["out"]["int8"]["last"]
            c8 = r["out"]["int8"]["cache"]
            caps[name + " int8"] = first_attention(
                lambda att: transformer.decode_step(
                    model, {**c8, "pos": pos}, toks, attention=att))
            ins = caps[name + " int8"]
            q, k, v = ins["q"], ins["k"], ins["v"]
            kw = {"causal": ins["causal"], "kv_len": ins["kv_len"],
                  "k_scale": ins["k_scale"], "v_scale": ins["v_scale"]}
            got, again = flash_attention(q, k, v, **kw), flash_attention(
                q, k, v, **kw)
            plain = attention_plain(q, k, v, **kw)
            err = float((got.float() - plain.float()).abs().max())
            same = torch.equal(got, again)
            dq = {"causal": ins["causal"], "kv_len": ins["kv_len"]}
            kd = dequantize(k, ins["k_scale"], q.dtype)
            vd = dequantize(v, ins["v_scale"], q.dtype)
            t_form = torch.equal(got, flash_attention(q, kd, vd, **dq))
            del kd, vd
            got32 = flash_attention(q.float(), k, v, **kw)
            plain32 = attention_plain(q.float(), k, v, **kw)
            over = int(((got32 - plain32).abs()
                        > 1e-6 + 1e-5 * plain32.abs()).sum())
            errs[name + " int8"] = err
            print(f"K6 int8 {name} decode (layer 0): q {tuple(q.shape)} "
                  f"{str(q.dtype)[6:]}, int8 k {tuple(k.shape)} kv_len "
                  f"{kw['kv_len']}: max abs err {err:.3e} (bound 3e-2) at "
                  f"max |plain| {float(plain.float().abs().max()):.3e}, "
                  f"bit-identical relaunch {same}, the bits of K6 over a "
                  f"dequantised copy {t_form}; with float32 q: max abs err "
                  f"{float((got32 - plain32).abs().max()):.3e}, {over} of "
                  f"{plain32.numel()} outside rtol 1e-5 / atol 1e-6")
            if not (err <= 3e-2 and same and over == 0):
                fail(f"K6's int8 form against its plain version at {name}")
            del got, again, plain, got32, plain32

        # ---- (d) the rows --------------------------------------------------
        rows = []
        n_sm = (torch.cuda.get_device_properties(dev).multi_processor_count
                if on_card else 0)
        for tag, name, launches in (
                ("A prefill", "segment_sum_bf16", ra["pre"]["segment_sum_bf16"]),
                ("A decode", "segment_sum_bf16_decode",
                 ra["out"]["bf16"]["launches"]["segment_sum_bf16"]
                 + ra["out"]["int8"]["launches"]["segment_sum_bf16"])):
            ins = caps[tag]
            data, seg, n = ins["data"], ins["seg"], ins["n"]
            kw = {"weights": ins["weights"], "rows": ins["rows"]}
            e, d = seg.numel(), data.shape[1]
            # each row the kept slots name read once (a dropped slot names
            # row -1 and reads none), each slot's weight, row index and id;
            # each token's sum written once
            kept = ins["rows"] >= 0
            n_read = int(torch.unique(ins["rows"][kept]).numel())
            n_bytes = n_read * d * 2 + e * (4 + 8 + 4) + n * d * 4
            b_ms, b_by = bound_ms(n_bytes, 2.0 * e * d)
            lib_ms = None
            if on_card:
                # the kept slots only: the library indexes no row -1
                ptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
                ptr[1:] = torch.bincount(seg[kept].long(), minlength=n).cumsum(0)
                cols, vals = ins["rows"][kept], ins["weights"][kept]
                dense = data
                try:  # bf16 values over the bf16 rows, where cuSPARSE has it
                    csr = torch.sparse_csr_tensor(
                        ptr, cols, vals.to(data.dtype),
                        size=(n, data.shape[0]))
                    torch.sparse.mm(csr, dense)
                    how = "bf16"
                except RuntimeError:  # else over a float32 copy of the rows
                    dense = data.float()
                    csr = torch.sparse_csr_tensor(ptr, cols, vals,
                                                  size=(n, data.shape[0]))
                    how = "float32 (a copy of the rows, made before timing)"
                lib_ms = timer(lambda: torch.sparse.mm(csr, dense), 10)
                lib_err = float((torch.sparse.mm(csr, dense).float()
                                 - segment_sum_sorted(data, seg, n, **kw))
                                .abs().max())
                print(f"torch.sparse.mm (sparse_csr of the gate weights over "
                      f"the expert outputs, in {how}) vs K5 at {tag}: max "
                      f"abs diff {lib_err:.3e}")
                del csr, dense, cols, vals
            rows.append({
                "name": name, "route": "cuda",
                "source": "src/repro_torch/csrc/segment_sum.cu",
                "replaces": "src/repro/kernels/segment/kernel.py:50",
                "computes": "src/repro/models/transformer.py:541",
                "form": "gather, bf16 rows", "launches": launches,
                "max_abs_err": errs[tag],
                "ms": timer(lambda: segment_sum_sorted(data, seg, n, **kw),
                            20),
                # the launches (K5 and, past one chunk, its carry pass)
                # without the host's cost a call
                "graph_ms": timer.graphed(
                    lambda: segment_sum_sorted(data, seg, n, **kw), 20),
                "plain_ms": timer(lambda: segment_sum_ref(data, seg, n, **kw),
                                  5),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                "shape": [e, d, n], "rows_read": n_read})
        for tag, name, r in (("A int8", "flash_attention_int8", ra),
                             ("B int8", "flash_attention_int8_32k", rb)):
            ins = caps[tag]
            q, k, v = ins["q"], ins["k"], ins["v"]
            kw = {"causal": ins["causal"], "kv_len": ins["kv_len"],
                  "k_scale": ins["k_scale"], "v_scale": ins["v_scale"]}
            b, hq, sq, dh = q.shape
            hkv, sk = k.shape[1], ins["kv_len"]
            n_bytes = (2 * b * hkv * sk * dh + 2 * b * hkv * sk * 4
                       + 2 * q.numel() * q.element_size())
            b_ms, b_by = bound_ms(n_bytes, 4.0 * b * hq * dh * sk,
                                  BF16_FLOPS_PER_S)
            kd = dequantize(k[:, :, :sk], ins["k_scale"][:, :, :sk], q.dtype)
            vd = dequantize(v[:, :, :sk], ins["v_scale"][:, :, :sk], q.dtype)

            def k6_fn():
                return flash_attention(q, k, v, **kw)

            def lib_fn():
                return fn.scaled_dot_product_attention(q, kd, vd)

            splits = split_count(b, hq, hkv, sq, sk, n_sm,
                                 decode_geometry(q.dtype, dh, True)
                                 ) if on_card else 1
            rows.append({
                "name": name, "route": "cuda",
                "source": "src/repro_torch/csrc/attention.cu",
                "replaces": "src/repro/kernels/attention/kernel.py:75",
                "computes": "src/repro/models/transformer.py:601",
                "kernel": "decode, int8 K/V",
                "launches": r["out"]["int8"]["launches"][
                    "flash_attention_int8"],
                "max_abs_err": errs[tag],
                "ms": timer(k6_fn, 50), "plain_ms": timer(
                    lambda: attention_plain(q, k, v, **kw), 10, warmup=1),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": timer(lib_fn, 50), "splits": splits,
                "graph_ms": timer.graphed(k6_fn, 50),
                "library_graph_ms": timer.graphed(lib_fn, 50),
                "shape": [b, hq, sq, sk, dh], "dtype": str(q.dtype)[6:]})
            del kd, vd
    summary = "; ".join(
        f"request {n}: {r['b']} x {r['s']} prefill {r['prefill_s']:.3f} s "
        f"(warm {r['warm_prefill_s']:.3f} s), "
        f"{r['out']['bf16']['step_ms']:.3f} ms a decode step on the bf16 "
        f"cache ({r['b'] * 1e3 / r['out']['bf16']['step_ms']:.1f} tok/s), "
        f"{r['out']['int8']['step_ms']:.3f} ms on the int8 cache, int8 vs "
        f"bf16 {r['dist']:.3e}, peak {r['peak_gb']:.3f} GB"
        for n, r in served.items())
    del caps, served, model, prefill, decode
    if on_card:
        torch.cuda.empty_cache()

    # ---- (c) granite-moe-1b-a400m, float32, kernels against plain -------
    gspec = get_arch(MOE_CHECK_ARCH)
    gcfg = lm_shrink(gspec.model_cfg) if args.lm_reduced else gspec.model_cfg
    gcfg = dataclasses.replace(gcfg, dtype=torch.float32)
    t0 = time.perf_counter()
    g = transformer.init_params(gcfg, seed=args.seed, device=dev)
    b, s, n = 8, requests["A"][2], 8
    tokens = lm_token_batch(0, b, s + n, gcfg.vocab, seed=args.seed)["tokens"]
    routes = []
    route = transformer._route

    def recording(router, xf, moe):
        probs, gate_w, gate_i = route(router, xf, moe)
        routes[-1].append((probs, gate_i))
        return probs, gate_w, gate_i

    def teacher_forced(attention, combine):
        out = {}
        cache, lg = transformer.prefill_step(
            g, tokens[:, :s], max_seq=s + n, attention=attention,
            combine=combine)
        for kind, c in (("float", cache),
                        ("int8", transformer.quantize_cache(cache))):
            c = {k: (v.clone() if torch.is_tensor(v) else v)
                 for k, v in c.items()}
            lgs = [lg]
            for i in range(n):
                lgi, c = transformer.decode_step(
                    g, c, tokens[:, s + i], attention=attention,
                    combine=combine)
                lgs.append(lgi)
            out[kind] = torch.stack(lgs)
        return out

    transformer._route = recording
    try:
        with torch.inference_mode():
            routes.append([])
            got = teacher_forced(flash_attention, segment_sum_sorted)
            routes.append([])
            with deterministic(torch):
                plain = teacher_forced(attention_plain, segment_sum_ref)
    finally:
        transformer._route = route
    sync()
    differ, shown = 0, []
    for call, ((pk, ik), (pp, ip)) in enumerate(zip(*routes)):
        bad = (ik.sort(-1).values != ip.sort(-1).values).any(-1)
        if bool(bad.any()):
            top = pp.topk(gcfg.moe.top_k + 1, dim=-1).values
            margin = (top[:, -2] - top[:, -1])[bad]
            differ += int(bad.sum())
            shown += [(call, int(t), float(mg)) for t, mg in zip(
                bad.nonzero()[:, 0][:3].tolist(), margin[:3].tolist())]
    e_float = rel_l1(got["float"], plain["float"])
    e_int8 = rel_l1(got["int8"], plain["int8"])
    finite = bool(got["float"].isfinite().all() and
                  got["int8"].isfinite().all())
    print(f"{gcfg.name} in float32 ({sum(p.numel() for p in g.parameters())} "
          f"parameters): request A's prefill ({b} x {s}) and {n} "
          f"teacher-forced decode steps, kernels against plain versions: "
          f"logits {tuple(got['float'].shape)} finite {finite}, relative L1 "
          f"{e_float:.3e} on the float cache, {e_int8:.3e} on the int8 cache "
          f"(bound 1e-4); routing compared over {len(routes[0])} dispatches: "
          f"{differ} (token, dispatch) pairs routed otherwise"
          + (f", e.g. (dispatch, token, top-k margin) {shown[:6]}"
             if shown else "") + f"; {time.perf_counter() - t0:.1f} s")
    if not (finite and e_float <= 1e-4 and e_int8 <= 1e-4):
        fail(f"{gcfg.name}'s float32 logits with the kernels disagree with "
             "the plain versions")
    del g, got, plain, routes
    if on_card:
        torch.cuda.empty_cache()
    return rows, f"MoE ({cfg.name}): {summary}"


class _Captured17(Exception):
    """Stops a training forward at its first attention or MoE combine."""


def _capture_first(torch, module, name, run):
    """The arguments of the first call of ``module.<name>`` while ``run()``
    runs (a training forward, which stops there)."""
    got = {}
    orig = getattr(module, name)

    def capture(*a, **kw):
        got.update(args=a, kw=kw)
        raise _Captured17

    setattr(module, name, capture)
    try:
        run()
    except _Captured17:
        return got
    finally:
        setattr(module, name, orig)
    fail(f"the training forward never called {name}")


def combine_bwd_bound(torch, data, seg, rows, n):
    """The MoE combine backward's bound on its operands (``data [R, D]``
    expert outputs, ``seg`` / ``rows`` each slot's token and row, ``n``
    tokens): the rows the kept slots name (a dropped slot names row -1 and
    reads none), g, each slot's weight, row and token and the slot map
    read once, grad_w and grad_eo written once.  Returns ``(ms, "bytes" or
    "operations", rows named)``."""
    e, (r_rows, d) = seg.numel(), data.shape
    n_read = int(torch.unique(rows[rows >= 0]).numel())
    size = data.element_size()
    n_bytes = (n_read * d * size + n * d * 4 + e * (4 + 8 + 4) + r_rows * 8
               + e * 4 + r_rows * d * size)
    return (*bound_ms(n_bytes, 2.0 * e * d + 1.0 * r_rows * d), n_read)


def combine_bwd_library_ms(torch, timer, g, data, seg, w, rows, iters):
    """The combine backward's library yardstick on the card: an
    ``index_add_`` of the weighted rows of g plus a ``bmm`` of the row
    dots, each timed apart over ``iters`` calls (their operands made
    outside the timing), over the kept slots only (a dropped slot names
    row -1, which no library call may index)."""
    kept = rows >= 0
    seg, w, rows = seg[kept], w[kept], rows[kept]
    ge = g.index_select(0, seg.long())
    gw = ge * w[:, None]
    eo3 = data.index_select(0, rows).float()[:, None, :]
    ge3 = ge[:, :, None]
    zeros = torch.zeros(data.shape, dtype=torch.float32, device=data.device)
    return (timer(lambda: zeros.index_add_(0, rows, gw), iters)
            + timer(lambda: torch.bmm(eo3, ge3), iters))


def lm_training(args, torch, dev, timer, sync):
    """Phase 17: LM training through ``launch.steps``' train kind and
    ``runtime.TrainLoop``: qwen1.5-0.5b (a) and granite-moe-1b-a400m (c) at
    full width in bf16, K6's backward and the MoE combine's backward held
    to their plain versions on layer 0's operands (b, c), float32 steps
    with the kernels against the plain versions, and the two backward
    kernels' rows for the kernels line (d).  Returns ``(rows, summary)``."""
    import shutil

    import torch.nn.functional as fn

    from repro_torch.configs import get_arch
    from repro_torch.configs.smoke import lm_shrink
    from repro_torch.data import lm_token_batch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.attention import (
        attention_bwd_plain, attention_plain, flash_attention,
        flash_attention_bwd)
    from repro_torch.kernels.attention.backward import (
        BWD_ROUTES, _flash_attention_bwd_mma_sync)
    from repro_torch.kernels.attention.kernel import flash_attention_lse
    from repro_torch.kernels.segment import (dispatch_bwd_kernel,
                                             dispatch_bwd_ref,
                                             segment_sum_bwd_ref,
                                             segment_sum_kernel)
    from repro_torch.kernels.segment.backward import (
        COMBINE_BWD_ROUTES, _moe_combine_bwd_warp_row, moe_combine_bwd)
    from repro_torch.launch.steps import build_cell_step
    from repro_torch.models import transformer
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime import TrainLoop, TrainLoopConfig

    on_card = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 stays float32
    torch.backends.cudnn.allow_tf32 = False
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "chip_smoke_train")
    shutil.rmtree(work, ignore_errors=True)
    # the train_4k cell cut in batch: 8 sequences (reduced: 64 tokens) in 2
    # microbatches
    b, s, nm = 8, 64 if args.lm_reduced else 4096, 2
    b32, s32 = 2, 64 if args.lm_reduced else 1024
    ocfg = AdamWConfig(lr=3e-5, warmup_steps=1, total_steps=6)
    rows, summary = [], []

    def model_for(arch, dtype=None):
        spec = get_arch(arch)
        cfg = lm_shrink(spec.model_cfg) if args.lm_reduced else spec.model_cfg
        if dtype is not None:
            cfg = dataclasses.replace(cfg, dtype=dtype)
        return spec, cfg, transformer.init_params(cfg, seed=args.seed,
                                                  device=dev)

    def cell_for(spec):
        cell = spec.cells["train_4k"]
        return dataclasses.replace(
            cell, inputs={k: ((b, s), dt) for k, (_, dt)
                          in cell.inputs.items()},
            overrides={"n_microbatches": nm},
            meta={**cell.meta, "tokens": b * s, "batch": b, "seq": s,
                  "reduced": f"batch {cell.meta['batch']}->{b}"
                  + ("" if s == 4096 else f", seq 4096->{s}")})

    def train(name, arch, steps, ckpt_every, expert_monitor=False):
        """``steps`` AdamW steps on one fixed batch through TrainLoop, the
        counters zeroed just before and read just after."""
        spec, cfg, model = model_for(arch)
        n_par = sum(p.numel() for p in model.parameters())
        m = cfg.moe
        dead = 0 if m is None else (cfg.n_layers * (m.e_pad - m.n_experts)
                                    * 3 * cfg.d_model * m.d_ff_expert)
        if n_par != cfg.n_params + dead:
            fail(f"{cfg.name}: {n_par} parameters where the config counts "
                 f"{cfg.n_params} + {dead} padded")
        cell = cell_for(spec)
        step = build_cell_step(spec, cell, model, ocfg)
        batch = lm_token_batch(0, b, s, cfg.vocab, seed=args.seed)
        ckpt = os.path.join(work, name)

        def init_state():
            tree = model.param_tree()
            return tree, adamw_init(tree)

        loop = TrainLoop(step, lambda i: batch, init_state, TrainLoopConfig(
            total_steps=steps, ckpt_dir=ckpt, ckpt_every=ckpt_every,
            keep=2, log_every=1,
            moe_experts=m.n_experts if expert_monitor else 0))
        held = torch.cuda.memory_allocated() if on_card else 0
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        reset_launches()
        BWD_ROUTES.update(dict.fromkeys(BWD_ROUTES, 0))
        COMBINE_BWD_ROUTES.update(dict.fromkeys(COMBINE_BWD_ROUTES, 0))
        t0 = time.perf_counter()
        out = loop.run()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in LAUNCHES.items() if v}
        # K6's backward launches by route
        launches.update({f"flash_attention_bwd:{r}": n
                         for r, n in BWD_ROUTES.items() if n})
        # and the combine's backward launches by body
        launches.update({f"segment_sum_bf16_bwd:{r}": n
                         for r, n in COMBINE_BWD_ROUTES.items() if n})
        peak = ((torch.cuda.max_memory_allocated() - held) / 1e9 if on_card
                else 0.0)
        with torch.no_grad():
            after = float(transformer.train_loss(
                model, batch, dataclasses.replace(cfg, n_microbatches=nm)))
        losses = [r["loss"] for r in out["metrics"]] + [after]
        secs = [r["sec"] for r in out["metrics"]]
        saved = sorted(os.listdir(ckpt))
        ck_bytes = sum(os.path.getsize(os.path.join(ckpt, d, f))
                       for d in saved for f in os.listdir(os.path.join(
                           ckpt, d)))
        print(f"{name}: {cfg.name}, {cfg.n_layers} layers, d={cfg.d_model}, "
              f"{model.embed.dtype}, {n_par} parameters; {cell.name} cut to "
              f"{cell.meta['reduced']} ({b} x {s} tokens, {nm} microbatches, "
              f"ce_chunk {cfg.ce_chunk}, remat {cfg.remat}); {steps} AdamW "
              f"steps on one batch through TrainLoop in {wall:.1f} s: losses "
              f"{[round(x, 4) for x in losses]} (the last after the last "
              f"step), walls a step (s) {[round(x, 3) for x in secs]}, "
              f"{b * s / min(secs):.0f} tok/s at the fastest step; lr "
              f"{[float('%.3g' % r['lr']) for r in out['metrics']]}, "
              f"grad norm {[round(r['grad_norm'], 3) for r in out['metrics']]}"
              f"; device memory peak {peak:.3f} GB above the "
              f"{held / 1e9:.3f} GB held; checkpoints {saved} "
              f"({ck_bytes / 1e9:.3f} GB); launches {launches}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            fail(f"{name}: losses {losses} not finite or not falling")
        # every ckpt_every steps and at the end, the newest two kept
        if saved != [f"step_{i:09d}" for i in sorted(
                {*range(ckpt_every, steps + 1, ckpt_every), steps})[-2:]]:
            fail(f"{name}: checkpoints {saved}")
        return spec, cfg, model, step, batch, out, loop, launches, secs, peak

    def per_microbatch(launches, steps, want):
        got = {k: launches.get(k, 0) for k in want}
        full = {k: v * steps * nm for k, v in want.items()}
        if on_card and got != full:
            fail(f"launches {got}, not {full} ({want} a microbatch)")
        return got

    # ---- (a) qwen1.5-0.5b --------------------------------------------------
    spec, cfg, model, step, batch, out, _, launches, secs, peak = train(
        "qwen1.5-0.5b training", LM_ARCH, 6, 3)
    L = cfg.n_layers
    path_a = per_microbatch(launches, 6, {"flash_attention": 2 * L,
                                          "flash_attention_bwd": L,
                                          "flash_attention_bwd:wgmma": L})
    state = out["opt_state"]
    if on_card:
        stats = device_share(torch, "qwen1.5-0.5b train step (one more)",
                             lambda: step(model.param_tree(), state, batch),
                             1e3 * float(np.median(secs)))
        if stats:
            parts = {part: sum(ms for ms, _, key in stats if part in key)
                     for part in ("bwd_dq_", "bwd_dkdv_")}
            print(f"qwen1.5-0.5b traced step: K6's backward kernels "
                  f"{sum(parts.values()):.3f} ms of the "
                  f"{sum(st[0] for st in stats):.3f} ms of device kernels "
                  f"(dQ {parts['bwd_dq_']:.3f}, dK / dV "
                  f"{parts['bwd_dkdv_']:.3f})")
    summary.append(f"qwen1.5-0.5b: {b} x {s} a step in {nm} microbatches, "
                   f"{float(np.median(secs)):.3f} s a step (median), "
                   f"{b * s / float(np.median(secs)):.0f} tok/s, peak "
                   f"{peak:.3f} GB")
    del out, state
    shutil.rmtree(os.path.join(work, "qwen1.5-0.5b training"),
                  ignore_errors=True)

    # ---- (b) K6's backward on layer 0's operands ---------------------------
    mb = {k: v[:b // nm] for k, v in batch.items()}
    ins = _capture_first(torch, transformer, "flash_attention_train",
                         lambda: transformer.train_loss(model, mb))
    q, k, v = (t.detach() for t in ins["args"][:3])
    causal = ins["kw"]["causal"]
    # the training forward, whose logsumexp the wgmma backward reads (on the
    # CPU the plain version's, which the plain backward does not read)
    o, lse = flash_attention_lse(q, k, v, causal=causal)
    served = flash_attention(q, k, v, causal=causal)
    _, lse_want = attention_plain(*(t.float() for t in (q, k, v)),
                                  causal=causal, lse=True)
    lse_err = float(((lse[..., :q.shape[2]] - lse_want).abs()
                     / (1 + lse_want.abs())).max())
    print(f"K6 training forward (layer 0 of a microbatch): o bit-equal to "
          f"serving's {torch.equal(o, served)}, its logsumexp max |dL| / (1 + "
          f"|L|) {lse_err:.3e} against the plain version's (bound 1e-5)")
    if not (torch.equal(o, served) and lse_err <= 1e-5):
        fail("K6's training forward against serving's and the plain L")
    del served, lse_want
    if not on_card:
        lse = None
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    do = (torch.randn(o.shape, generator=gen, device=dev) * 0.01).to(o.dtype)

    def plain_bwd(q, k, v, o, do):
        # a batch row at a time: the plain version holds [H, S, S] float32
        parts = [attention_bwd_plain(*(t[i:i + 1].float()
                                       for t in (q, k, v, o, do)),
                                     causal=causal)
                 for i in range(q.shape[0])]
        return [torch.cat(p) for p in zip(*parts)]

    routes = dict(BWD_ROUTES)
    got = flash_attention_bwd(q, k, v, o, do, causal=causal, lse=lse)
    again = flash_attention_bwd(q, k, v, o, do, causal=causal, lse=lse)
    routes = {r: n - routes[r] for r, n in BWD_ROUTES.items() if n - routes[r]}
    if on_card and routes != {"wgmma": 2}:
        fail(f"K6's backward at layer 0 ran on routes {routes}, not wgmma")
    want = plain_bwd(q, k, v, o, do)
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    errs = {n: rel_l1(x.float(), w) for n, x, w in zip("qkv", got, want)}
    err_bwd = max(float((x.float() - w).abs().max())
                  for x, w in zip(got, want))
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    o32 = flash_attention(q32, k32, v32, causal=causal)
    got32 = flash_attention_bwd(q32, k32, v32, o32, do32, causal=causal)
    want32 = plain_bwd(q32, k32, v32, o32, do32)
    over = sum(int(((x - w).abs() > 1e-6 + 1e-5 * w.abs()).sum())
               for x, w in zip(got32, want32))
    print(f"K6 backward (layer 0 of a microbatch): q {tuple(q.shape)} "
          f"{str(q.dtype)[6:]}, causal {causal}: relative L1 dq "
          f"{errs['q']:.3e}, dk {errs['k']:.3e}, dv {errs['v']:.3e} "
          f"(bound 1e-2), max abs err {err_bwd:.3e}, bit-identical relaunch "
          f"{same}, routes {routes}; in float32: {over} of {3 * q.numel()} "
          f"outside rtol 1e-5 / atol 1e-6")
    if not (max(errs.values()) <= 1e-2 and same and over == 0):
        fail("K6's backward against its plain version")
    del got, again, want, got32, want32, q32, k32, v32, do32, o32

    def float_step(name, cfg, model, routed=None):
        """One float32 gradient at b32 x s32 with the kernels and with the
        plain versions; every leaf within relative L1 1e-4."""
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                    n_microbatches=1)
        m32 = transformer.init_params(cfg32, seed=args.seed + 1, device=dev)
        with torch.no_grad():
            for dst, src in zip(m32.parameters(), model.parameters()):
                dst.copy_(src)
        m32.requires_grad_(True)
        bt = lm_token_batch(1, b32, s32, cfg.vocab, seed=args.seed)
        leaves = [p for _, p in sorted(m32.named_parameters())]
        res = []
        for kernels in (True, False):
            if routed is not None:
                routed.append([])
            with (contextlib.nullcontext() if kernels
                  else deterministic(torch)):
                loss = transformer.train_loss(m32, bt, cfg32,
                                              kernels=kernels)
                res.append((float(loss.detach()),
                            torch.autograd.grad(loss, leaves)))
        sync()
        worst = max(rel_l1(g, w) for g, w in zip(res[0][1], res[1][1]))
        print(f"{name} in float32 ({sum(p.numel() for p in leaves)} "
              f"parameters), one gradient at {b32} x {s32}, kernels against "
              f"plain versions: losses {res[0][0]:.6f} / {res[1][0]:.6f}, "
              f"the largest relative L1 over the {len(leaves)} leaves "
              f"{worst:.3e} (bound 1e-4)")
        if not worst <= 1e-4:
            fail(f"{name}'s float32 gradients with the kernels disagree with "
                 "the plain versions")

    float_step(cfg.name, cfg, model)
    # (d) K6 backward's row, at a microbatch's layer 0
    bq, hq, sq, dh = q.shape
    pairs = bq * hq * sq * (sq + 1) // 2
    # q, o, do, k and v read once, dq, dk and dv written once; five products
    # of 2.Dh flops over the (query, key) pairs under the causal mask
    n_bytes = (4 * q.numel() + 4 * k.numel()) * q.element_size()
    flops = 5 * 2.0 * dh * pairs
    b_ms, b_by = bound_ms(n_bytes, flops, BF16_FLOPS_PER_S)
    lib_ms = old_ms = fwd_ms = serve_ms = None
    if on_card:
        ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, k, v))
        lo = fn.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
        lib_ms = timer(lambda: torch.autograd.grad(
            lo, (ql, kl, vl), do, retain_graph=True), 10)
        del ql, kl, vl, lo
        # the mma.sync pair that the wgmma route replaced, on the same
        # operands (the library's private entry, counted nowhere), and the
        # training forward beside serving's
        old_ms = timer(lambda: _flash_attention_bwd_mma_sync(
            q, k, v, o, do, causal=causal), 10)
        fwd_ms = timer(lambda: flash_attention_lse(q, k, v, causal=causal),
                       10)
        serve_ms = timer(lambda: flash_attention(q, k, v, causal=causal), 10)
    rows.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/attention_bwd.cu",
        "replaces": "src/repro/kernels/attention/kernel.py:75",
        "computes": "src/repro/models/transformer.py:217 (its gradient)",
        "kernel": "wgmma" if q.dtype == torch.bfloat16 else "fma",
        "launches": path_a["flash_attention_bwd"], "max_abs_err": err_bwd,
        "ms": timer(lambda: flash_attention_bwd(q, k, v, o, do,
                                                causal=causal, lse=lse), 10),
        "plain_ms": timer(lambda: plain_bwd(q, k, v, o, do), 2, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        "mma_sync_ms": old_ms, "train_forward_ms": fwd_ms,
        "serving_forward_ms": serve_ms,
        "shape": [bq, hq, sq, dh], "dtype": str(q.dtype)[6:],
        "gflop": flops / 1e9})

    def rate(ms):
        return "not measured" if ms is None else (
            f"{ms:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s")

    print(f"flash_attention_bwd: {flops / 1e9:.1f} GFLOP counted (five "
          f"products over the causal pairs): the wgmma pair "
          f"{rate(rows[-1]['ms'])}, the mma.sync pair {rate(old_ms)}, the "
          f"library's backward {rate(lib_ms)}; the training forward "
          + ("not measured" if fwd_ms is None else
             f"{fwd_ms:.4f} ms beside serving's {serve_ms:.4f} ms"))
    if on_card and not rows[-1]["ms"] <= 1.6:
        fail(f"K6's backward takes {rows[-1]['ms']:.4f} ms a call, past "
             "1.6 ms")
    del q, k, v, o, do, model, step, batch
    if on_card:
        torch.cuda.empty_cache()

    # ---- (c) granite-moe-1b-a400m ------------------------------------------
    spec, cfg, model, step, batch, out, loop, launches, secs, peak = train(
        "granite-moe-1b-a400m training", MOE_CHECK_ARCH, 4, 4,
        expert_monitor=True)
    moe = cfg.moe
    path_c = per_microbatch(launches, 4, {
        "flash_attention": 2 * L, "flash_attention_bwd": L,
        "flash_attention_bwd:wgmma": L,
        "segment_sum_bf16": 2 * L, "segment_sum_bf16_bwd": L,
        "segment_sum_bf16_bwd:stream": L, "moe_dispatch_bwd": L,
        # the combine's forward and recomputation; none from the dispatch's
        # backward
        "segment_sum_carry": 2 * L})
    mon = loop.expert_monitor
    print(f"granite-moe-1b-a400m expert-load monitor: {mon._step} "
          f"dispatches observed ({4 * nm} microbatches x {cfg.n_layers} "
          f"layers x 2, forward and recomputation), {len(mon.executor.log)} "
          f"plans: {[dataclasses.astuple(p) for p in mon.executor.log[:12]]}"
          f"; shards {mon.shards.tolist()}")
    if mon._step != 4 * nm * cfg.n_layers * 2:
        fail(f"the expert-load tap fired {mon._step} times")
    summary.append(f"granite-moe-1b-a400m: {float(np.median(secs)):.3f} s a "
                   f"step (median), {b * s / float(np.median(secs)):.0f} "
                   f"tok/s, peak {peak:.3f} GB, {len(mon.executor.log)} "
                   "expert-shard plans")
    del out, loop
    shutil.rmtree(work, ignore_errors=True)
    mb = {k: v[:b // nm] for k, v in batch.items()}
    disp = _capture_first(torch, transformer, "moe_dispatch",
                          lambda: transformer.train_loss(model, mb))
    ins = _capture_first(torch, transformer, "moe_combine",
                         lambda: transformer.train_loss(model, mb))
    data = ins["args"][0].detach()
    seg, n = ins["args"][1], ins["args"][2]
    w, rows_, slot = (ins["kw"][x].detach() for x in ("weights", "rows",
                                                      "slot"))
    g = torch.randn((n, data.shape[1]), generator=gen, device=dev)
    got = moe_combine_bwd(g, data, seg, w, rows_, slot)
    again = moe_combine_bwd(g, data, seg, w, rows_, slot)
    want = segment_sum_bwd_ref(g, data, seg, w, rows_)
    e_w = rel_l1(got[0], want[0])
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    exact = torch.equal(got[1], want[1])
    # the warp_row body it replaced gives the same bits (on the card)
    old_bits = "not checked (no card)" if not on_card else all(
        torch.equal(x, y) for x, y in zip(got, _moe_combine_bwd_warp_row(
            g, data, seg, w, rows_, slot)))
    err_k5 = max(float((got[0] - want[0]).abs().max()),
                 float((got[1].float() - want[1].float()).abs().max()))
    print(f"combine backward (layer 0 of a microbatch): eo "
          f"{tuple(data.shape)} {str(data.dtype)[6:]}, {seg.numel()} slots "
          f"into {n} tokens ({int((w == 0).sum())} of weight 0): relative L1 "
          f"grad_w {e_w:.3e} (bound 1e-5), grad_eo bit-equal {exact}, max "
          f"abs err {err_k5:.3e}, bit-identical relaunch {same}, the "
          f"warp_row body's bits {old_bits}")
    if not (e_w <= REL_L1 and exact and same and old_bits):
        fail("the combine's backward against its plain version")
    routes, route = [], transformer._route

    def recording(router, xf, moe):
        res = route(router, xf, moe)
        routes[-1].append((res[0].detach(), res[2]))
        return res

    transformer._route = recording
    try:
        float_step(cfg.name, cfg, model, routes)
    finally:
        transformer._route = route
    differ, shown = 0, []
    for call, ((pk, ik), (pp, ip)) in enumerate(zip(*routes)):
        bad = (ik.sort(-1).values != ip.sort(-1).values).any(-1)
        if bool(bad.any()):
            top = pp.topk(moe.top_k + 1, dim=-1).values
            margin = (top[:, -2] - top[:, -1])[bad]
            differ += int(bad.sum())
            shown += [(call, int(t), float(mg)) for t, mg in zip(
                bad.nonzero()[:, 0][:3].tolist(), margin[:3].tolist())]
    print(f"routing of the float32 gradients compared over {len(routes[0])} "
          f"dispatches (forward and recomputation): {differ} (token, "
          f"dispatch) pairs routed otherwise"
          + (f", e.g. (dispatch, token, top-k margin) {shown[:6]}"
             if shown else ""))
    # (d) the combine backward's row, at a microbatch's layer 0: the
    # stream body timed in turns with the warp_row body it replaced
    e, (r_rows, d) = seg.numel(), data.shape
    b_ms, b_by, n_read = combine_bwd_bound(torch, data, seg, rows_, n)
    lib_ms = old_ms = None
    if on_card:
        lib_ms = combine_bwd_library_ms(torch, timer, g, data, seg, w, rows_,
                                        10)
        turns = least(timer, {
            "stream": lambda: moe_combine_bwd(g, data, seg, w, rows_, slot),
            "warp_row": lambda: _moe_combine_bwd_warp_row(g, data, seg, w,
                                                          rows_, slot)}, 20)
        new_ms, old_ms = turns["stream"][0], turns["warp_row"][0]
    else:
        new_ms = timer(lambda: moe_combine_bwd(g, data, seg, w, rows_, slot),
                       20)
    print(f"combine backward (d): the stream body {new_ms:.4f} ms, the "
          "warp_row body " + ("not measured" if old_ms is None else
                              f"{old_ms:.4f} ms")
          + f", bound {b_ms:.4f} ms ({b_by}; {100 * b_ms / new_ms:.1f} % "
          "of it reached), the library " + ("not measured" if lib_ms is None
                                            else f"{lib_ms:.4f} ms"))
    rows.append({
        "name": "segment_sum_bf16_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/segment_bwd.cu",
        "replaces": "src/repro/kernels/segment/kernel.py:50",
        "computes": "src/repro/models/transformer.py:541 (its gradient)",
        "form": "the MoE combine's backward, bf16 rows",
        "kernel": "stream",
        "launches": path_c["segment_sum_bf16_bwd"], "max_abs_err": err_k5,
        "ms": new_ms,
        "plain_ms": timer(lambda: segment_sum_bwd_ref(g, data, seg, w, rows_),
                          5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        "warp_row_ms": old_ms,
        "shape": [e, d, n, r_rows], "rows_read": n_read})
    # (d) the dispatch backward's row, at a microbatch's layer 0: the
    # buffer's gradient summed back into the tokens by its own kernel, in
    # the model's dtype, timed in turns with the route it replaced (K5's
    # bf16-row form over rows where(keep, dest, 0), weight 1 a kept slot
    # and 0 a dropped one, then the cast)
    x_d, src_d = disp["args"][0], disp["args"][1]
    dest_d, keep_d = disp["kw"]["dest"], disp["kw"]["keep"]
    n_tok, e_d, d_d = x_d.shape[0], dest_d.numel(), x_d.shape[1]
    seg_d = torch.arange(n_tok, dtype=torch.int32, device=dev
                         ).repeat_interleave(e_d // n_tok)
    rows_d, w_d = torch.where(keep_d, dest_d, 0), keep_d.float()
    g_d = torch.randn((src_d.numel(), d_d), generator=gen,
                      device=dev).to(x_d.dtype)

    def dispatch_op():
        return dispatch_bwd_kernel(g_d, dest_d, keep_d, n_tok)

    def k5_route():
        return segment_sum_kernel(g_d, seg_d, n_tok, w_d, rows_d).to(
            g_d.dtype)

    got_d, again_d, old_d = dispatch_op(), dispatch_op(), k5_route()
    want_d = dispatch_bwd_ref(g_d, dest_d, keep_d, n_tok)
    err_d = float((got_d.float() - want_d.float()).abs().max())
    e_rel = rel_l1(got_d, want_d)
    k5_bits, same_d = torch.equal(got_d, old_d), torch.equal(got_d, again_d)
    n_kept = int(keep_d.sum())
    # each kept slot's buffer row read once (the new op reads no other),
    # each slot's dest and keep, the tokens' sums written once in g's dtype
    n_read_d = int(torch.unique(dest_d[keep_d]).numel())
    size = g_d.element_size()
    n_bytes = n_read_d * d_d * size + e_d * 9 + n_tok * d_d * size
    b_ms, b_by = bound_ms(n_bytes, 1.0 * n_kept * d_d)
    print(f"dispatch backward (layer 0 of a microbatch): {e_d} slots "
          f"({e_d - n_kept} dropped) of {src_d.numel()} "
          f"{str(g_d.dtype)[6:]} buffer rows of {d_d} into {n_tok} tokens, "
          f"out in {str(got_d.dtype)[6:]}: relative L1 {e_rel:.3e} against "
          f"the plain version (bound 1e-5), max abs err {err_d:.3e}, the "
          f"bits of K5's route plus the cast {k5_bits}, bit-identical "
          f"relaunch {same_d}; rows read: {n_read_d} (the new op), {e_d} "
          f"row copies of {int(torch.unique(rows_d).numel())} rows (K5's "
          f"route, a dropped slot's row 0 too)")
    if not (e_rel <= REL_L1 and k5_bits and same_d):
        fail("the dispatch's backward against its plain version and K5's "
             "route")
    del old_d, again_d
    lib_ms = None
    new_ms, old_ms = [], []
    for turn in range(3):
        pair = [(new_ms, dispatch_op), (old_ms, k5_route)]
        for out, fn in pair[::-1] if turn % 2 else pair:
            out.append(timer(fn, 20))
    if on_card:
        gw = g_d.index_select(0, dest_d[keep_d]).float()
        zeros = torch.zeros((n_tok, d_d), dtype=torch.float32, device=dev)
        tok = seg_d.long()[keep_d]
        lib_ms = timer(lambda: zeros.index_add_(0, tok, gw), 10)
        del gw, zeros, tok
    print(f"dispatch backward (d), 3 x 20 calls each in turns: the new op "
          f"{' / '.join(f'{t:.4f}' for t in new_ms)} ms, K5's route plus "
          f"the cast {' / '.join(f'{t:.4f}' for t in old_ms)} ms; bound "
          f"{b_ms:.4f} ms ({b_by}: {n_bytes / 1e6:.1f} MB; "
          f"{100 * b_ms / min(new_ms):.1f} % of it reached), the library "
          "(index_add_ of the kept rows) " + ("not measured" if lib_ms is None
                                             else f"{lib_ms:.4f} ms"))
    if on_card and not min(new_ms) < min(old_ms):
        fail(f"the dispatch's backward ({min(new_ms):.4f} ms) is not faster "
             f"than K5's route ({min(old_ms):.4f} ms)")
    rows.append({
        "name": "moe_dispatch_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/dispatch_bwd.cu",
        "replaces": "src/repro/kernels/segment/kernel.py:50",
        "computes": "src/repro/models/transformer.py:524 (its gradient)",
        "form": "the MoE dispatch's backward, bf16 rows",
        "launches": path_c["moe_dispatch_bwd"], "max_abs_err": err_d,
        "ms": min(new_ms), "k5_route_ms": min(old_ms),
        "plain_ms": timer(lambda: dispatch_bwd_ref(g_d, dest_d, keep_d,
                                                   n_tok), 5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        "shape": [e_d, d_d, n_tok, src_d.numel()], "rows_read": n_read_d})
    del data, g, got, again, want, model, step, batch, routes, disp, g_d
    del got_d, want_d, dest_d, keep_d, rows_d, w_d, seg_d
    if on_card:
        torch.cuda.empty_cache()
    return rows, "LM training: " + "; ".join(summary)


def simulator_phase(args, torch, dev, timer, g, problem, x_ref):
    """Phase 13: the K-PID simulator on the card (K7), its gates and K7's
    rows for the kernels line.  Returns ``(rows, summary)``."""
    import repro_torch
    from repro_torch.core import DistributedSimulator, SimulatorConfig
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.sim_push import (
        sim_messages, sim_messages_plain, sim_push, sim_push_plain)
    from repro_torch.launch.paper_tables import ordered_system

    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    class TimedSimulator(DistributedSimulator):
        """The simulator with each whole push (K7's messages, K7's sum and
        the remote |.| sums: ``_push``) timed on the card by a pair of CUDA
        events and its messages counted (``sizes``); the inputs of its
        largest push (``capture="largest"``), or of the first push nearest
        ``capture`` messages (an int), are copied, before the first event,
        for K7's checks."""

        def __init__(self, *a, capture=None, **kw):
            super().__init__(*a, **kw)
            self.capture, self.kept, self.events = capture, None, []
            self.sizes = []

        def _push(self, sel, pid, sent, n_e, counts, remote):
            self.sizes.append(n_e)
            if self.capture == "largest":
                better = self.kept is None or n_e > self.kept["n_e"]
            else:
                better = self.kept is None or (abs(n_e - self.capture)
                                               < abs(self.kept["n_e"]
                                                     - self.capture))
            if better:
                self.kept = dict(n_e=n_e, state=self._state.clone(),
                                 messages=(
                    sel.clone(), pid.clone(), sent.clone(), self.deg,
                    self.indptr, self.indices, self.edge_w,
                    self.owner.clone(), n_e),
                    push=(sel.clone(), pid.clone(), sent.clone(), n_e,
                          list(counts), list(remote)))
            if not on_card:
                return super()._push(sel, pid, sent, n_e, counts, remote)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            super()._push(sel, pid, sent, n_e, counts, remote)
            stop.record()
            self.events.append((start, stop))

        def push_ms(self):
            return (sum(a.elapsed_time(z) for a, z in self.events)
                    if on_card else None)

    def held(what, sim, res, p, b):
        """Convergence and the §2.2 invariant, F counting f and every
        outbox."""
        s_, d_, w_ = p.edge_list()
        f_all = (sim.f + sim.outbox.sum(0)).cpu().numpy()
        viol, bound = invariant(np.asarray(b), f_all, sim.h.cpu().numpy(),
                                s_, d_, w_)
        print(f"{what}: invariant |B-(I-P)H-F|_1 = {viol:.3e} (bound "
              f"{bound:.3e})")
        if not res.converged or viol > bound:
            fail(f"simulator {what}: converged {res.converged}, invariant "
                 f"{viol:.3e} > {bound:.3e}")

    def go(what, p, b, cls=DistributedSimulator, sim_kw=None, **kw):
        """One simulator run, the K7 counters zeroed just before and read
        just after, gated on each K7 kernel launched once per push and on
        the recorded counters (``SIM_RECORDED``)."""
        t0 = time.perf_counter()
        sim = cls(p, b, SimulatorConfig(**kw), **(sim_kw or {}))
        sync()
        setup = time.perf_counter() - t0
        reset_launches()
        t0 = time.perf_counter()
        res = sim.run()
        sync()
        wall = time.perf_counter() - t0
        launches = {k: LAUNCHES[k] for k in K7}
        print(f"{what}: converged {res.converged} wall {wall:.3f} s (set-up "
              f"{setup:.3f} s) steps {res.n_steps} n_edge_ops "
              f"{res.n_edge_ops} exchanges {res.n_exchanges} moves "
              f"{res.n_moves} cost_iterations {res.cost_iterations:.4f} "
              f"pushes {res.n_pushes}, K7 launches {json.dumps(launches)}")
        if on_card and not all(v == res.n_pushes > 0
                               for v in launches.values()):
            fail(f"simulator {what}: K7 launched {launches} times for "
                 f"{res.n_pushes} pushes")
        want = SIM_RECORDED.get(what)
        if want is not None and (what.startswith("sequential") or (
                problem.n == 2**21 and args.seed == 0)):
            got = (res.n_steps, res.n_edge_ops, res.n_exchanges,
                   res.n_pushes, res.n_moves)
            print(f"{what}: (steps, edge ops, exchanges, pushes, moves) "
                  f"{got}, recorded {want}")
            if got != want:
                fail(f"simulator {what} moved from its recorded counters")
        return sim, res, wall, launches

    def run(what, p, b, x=None, **kw):
        """:func:`go`, then convergence, the invariant and, where ``x`` is
        given, the distance to it."""
        sim, res, wall, launches = go(what, p, b, **kw)
        held(what, sim, res, p, b)
        if x is not None:
            # 2·target_error below N = 2e5: two converged schedules may
            # differ by that much
            tol = max(1e-5, 2 * problem.target_error)
            dx = float(np.abs(res.h.cpu().numpy() - x).sum())
            print(f"{what}: |h - x_segment_sum|_1 {dx:.3e} (bound {tol:.1e})")
            if dx > tol:
                fail(f"simulator {what}: |h - x_segment_sum|_1 {dx:.3e}")
        return sim, res, wall, launches

    def same_run(res, steps, ops, exchanges, move_log, h):
        return (steps == res.n_steps and ops == res.n_edge_ops
                and exchanges == res.n_exchanges and move_log == res.move_log
                and torch.equal(h, res.h.cpu()))

    t_phase = time.perf_counter()
    opts = dict(k=8, target_error=problem.target_error, eps=problem.eps,
                partition="uniform", mode="batch", record_every=100,
                device=args.device)
    p, b = problem.p, problem.b
    # the main path's runs carry no instrumentation: their walls are clean
    _, res_s, wall_s, n_s = run("batch K=8 uniform static", p, b, x_ref,
                                dynamic=False, **opts)
    _, res_d, wall_d, n_d = run("batch K=8 uniform dynamic", p, b, x_ref,
                                dynamic=True, **opts)
    # replay through the front door
    reset_launches()
    t0 = time.perf_counter()
    rep = repro_torch.solve(problem, "simulator", k=8, dynamic=True,
                            mode="batch", record_every=100,
                            device=args.device)
    sync()
    wall_r = time.perf_counter() - t0
    n_r = {k: LAUNCHES[k] for k in K7}
    same = same_run(res_d, rep.n_rounds, rep.n_ops,
                    rep.extras["n_exchanges"], rep.move_log,
                    torch.from_numpy(rep.x))
    print(f"replay (repro_torch.solve, dynamic): wall {wall_r:.3f} s steps "
          f"{rep.n_rounds} n_edge_ops {rep.n_ops} exchanges "
          f"{rep.extras['n_exchanges']} moves {len(rep.move_log)}; equal to "
          f"the dynamic run (steps, ops, exchanges, move log, h bits) {same}")
    if not same or (on_card and set(n_r.values()) != {res_d.n_pushes}):
        fail("simulator replay differs from the dynamic run")
    def whole_push(sim, push, reps=10):
        """A whole push (``_push``: K7's messages, K7's sum, the remote |.|
        sums) replayed ``reps`` times on ``sim``: its device kernels and
        copies a push (torch.profiler) and its stream time a push, back to
        back (CUDA events); ``(None, None)`` off the card."""
        if not on_card:
            return None, None
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        def one():
            DistributedSimulator._push(sim, *push)

        one()
        sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                one()
            sync()
        n = sum(e.count for e in prof.key_averages()
                if getattr(e, "device_type", None) == DeviceType.CUDA)
        return n / reps, timer(one, reps)

    # K7's device time: both runs again with each push timed by CUDA events
    # (the static one keeping its largest push, the dynamic one the push
    # nearest the static run's median by messages), held to the clean runs
    push_ms, push_share, kept, whole = {}, {}, {}, {}
    median_n_e = None
    for what, res, wall, dyn in (("static", res_s, wall_s, False),
                                 ("dynamic", res_d, wall_d, True)):
        sim_t, res_t, wall_t, _ = go(
            f"batch K=8 uniform {what}, each push timed", p, b,
            cls=TimedSimulator,
            sim_kw=dict(capture=median_n_e if dyn else "largest"),
            dynamic=dyn, **opts)
        if not same_run(res, res_t.n_steps, res_t.n_edge_ops,
                        res_t.n_exchanges, res_t.move_log, res_t.h.cpu()):
            fail(f"simulator {what}: the timed run differs from the clean one")
        push_ms[what] = sim_t.push_ms()
        if push_ms[what] is not None:
            push_share[what] = push_ms[what] / 1e3 / wall
            print(f"{what}: the pushes' stream time (K7's messages, sum, "
                  f"remote |.| sums; the host's gaps inside a push included) "
                  f"{push_ms[what]:.3f} ms over {len(sim_t.events)} pushes, "
                  f"{push_ms[what] / len(sim_t.events):.4f} ms a push, "
                  f"{push_share[what]:.4f} of the clean run's {wall:.3f} s "
                  f"wall ({push_ms[what] / 1e3 / wall_t:.4f} of the timed "
                  f"run's {wall_t:.3f} s); equal to the clean run")
        if not dyn:
            kept["largest"] = sim_t.kept
            median_n_e = sorted(sim_t.sizes)[len(sim_t.sizes) // 2]
            print(f"static: pushes by messages: median {median_n_e}, largest "
                  f"{max(sim_t.sizes)}, smallest {min(sim_t.sizes)}")
        else:
            kept["median"] = sim_t.kept
            for at in ("largest", "median"):
                whole[at] = whole_push(sim_t, kept[at]["push"])
                print(f"a whole push at the {at} push ({kept[at]['n_e']} "
                      f"messages): {whole[at][0]} device kernels and copies, "
                      f"{whole[at][1]} ms of stream time back to back")
        del sim_t
    # Table 2's protocol at scale: the same graph ordered by out-degree
    t0 = time.perf_counter()
    g_out = g.reorder(np.argsort(-g.out_degree(), kind="stable"))
    prob_out = repro_torch.Problem.pagerank(g_out)
    print(f"out-degree order: host build {time.perf_counter() - t0:.1f} s")
    costs = {}
    for dyn in (False, True):
        _, r, wall, _ = run(
            f"out-degree order K=8 {'dynamic' if dyn else 'static'}",
            prob_out.p, prob_out.b, dynamic=dyn, **opts)
        costs[dyn] = (r.cost_iterations, r.n_moves, wall)
    # the paper-exact sequential schedule at the paper's N = 1000
    p1, b1 = ordered_system("out_degree")
    _, res_q, wall_q, n_q = run(
        "sequential N=1000 out-degree K=16 uniform dynamic", p1, b1,
        k=16, target_error=1e-3, eps=0.15, partition="uniform",
        dynamic=True, mode="sequential", record_every=100,
        device=args.device)

    # ---- K7 against its plain version (launches here are not the path's) --
    def k7_at(at):
        """K7 at the static run's largest or the dynamic run's median push,
        as the runs made them: each kernel held to its plain version on CPU
        copies, ``torch.equal``, and relaunched bit-identically; the push's
        nodes, messages, distinct targets and longest bucket."""
        c = kept[at]
        m_args = c["messages"]
        m_cpu = [a.cpu() if torch.is_tensor(a) else a for a in m_args]
        got_m = [sim_messages(*m_args) for _ in range(2)]
        want_m = sim_messages_plain(*m_cpu)
        ok_m = all(torch.equal(a.cpu(), w) and torch.equal(a, a2)
                   for a, a2, w in zip(got_m[0], got_m[1], want_m))
        key, msg = got_m[0][0], got_m[0][1]
        outs = []
        for _ in range(2):
            got = c["state"].clone()
            sim_push(got, key, msg)
            outs.append(got)
        want = c["state"].cpu()
        sim_push_plain(want, key.cpu(), msg.cpu())
        ok = torch.equal(outs[0].cpu(), want) and torch.equal(outs[0], outs[1])
        targets, counts = torch.unique(key, return_counts=True)
        out = dict(m_args=m_args, key=key, msg=msg, state=c["state"],
                   err_m=float((got_m[0][1].cpu() - want_m[1]).abs().max()),
                   err=float((outs[0].cpu() - want).abs().max()),
                   nodes=m_args[0].numel(), messages=m_args[-1],
                   targets=int(targets.numel()), longest=int(counts.max()))
        print(f"K7 at the {at} push ({out['nodes']} nodes, {out['messages']} "
              f"messages, {int((key < problem.n).sum())} of them local, "
              f"{out['targets']} distinct targets, the longest bucket "
              f"{out['longest']}): messages (key, msg, |remote msg|) equal to "
              f"the plain version on the CPU and relaunch bit-identical "
              f"{ok_m}; the sum likewise {ok}")
        if not (ok_m and ok):
            fail(f"K7 differs from its plain version at the {at} push")
        return out

    at = {w: k7_at(w) for w in ("largest", "median")}
    # the paper's N = 1000 graph: nodes with no out-edge among the selected,
    # every PID's, and an empty selection (no launch)
    gen = np.random.default_rng(args.seed + 7)
    csr = [torch.as_tensor(a, device=dev) for a in (
        np.diff(p1.indptr), p1.indptr, p1.indices.astype(np.int64),
        p1.weights)]
    owner_syn = torch.as_tensor(gen.integers(0, 4, p1.n).astype(np.int32),
                                device=dev)
    for what, n_sel in (("mixed", 600), ("empty", 0)):
        sel_syn = torch.as_tensor(gen.choice(p1.n, n_sel, replace=False),
                                  device=dev)
        pid_syn = torch.as_tensor(gen.integers(0, 4, n_sel), device=dev)
        sent_syn = torch.as_tensor(gen.standard_normal(n_sel), device=dev)
        n_e_syn = int(csr[0][sel_syn].sum())
        before = LAUNCHES["sim_messages"]
        args_syn = (sel_syn, pid_syn, sent_syn, *csr, owner_syn, n_e_syn)
        got_syn = sim_messages(*args_syn)
        want_syn = sim_messages_plain(*[a.cpu() if torch.is_tensor(a) else a
                                        for a in args_syn])
        ok = all(torch.equal(a.cpu(), w) for a, w in zip(got_syn, want_syn))
        if n_sel == 0:
            ok = ok and LAUNCHES["sim_messages"] == before
        dangling = int((csr[0][sel_syn] == 0).sum())
        print(f"K7 messages, synthetic, {what} ({n_sel} nodes, {dangling} "
              f"without an out-edge, {n_e_syn} messages): equal to the plain "
              f"version {ok}")
        if not ok:
            fail(f"K7's messages, synthetic ({what})")
    n_syn = 4096
    for what, e, lo in (("repeated keys", 200_000, 0),
                        ("all remote", 20_000, n_syn), ("empty", 0, 0)):
        k_syn = torch.as_tensor(gen.choice(np.arange(lo, 4 * n_syn), 300)[
            gen.integers(0, 300, e)].astype(np.int32), device=dev)
        m_syn = torch.as_tensor(gen.standard_normal(e) * 10.0 ** gen.uniform(
            -9, 2, e), device=dev)
        s_syn = torch.as_tensor(gen.standard_normal(4 * n_syn), device=dev)
        got = s_syn.clone()
        before = LAUNCHES["sim_push"]
        sim_push(got, k_syn, m_syn)
        want_syn = s_syn.cpu()
        sim_push_plain(want_syn, k_syn.cpu(), m_syn.cpu())
        ok = torch.equal(got.cpu(), want_syn)
        if e == 0:
            ok = ok and LAUNCHES["sim_push"] == before
        print(f"K7 synthetic push, {what} ({e} messages): equal to its plain "
              f"version {ok}")
        if not ok:
            fail(f"K7 synthetic push ({what})")

    # ---- K7's numbers at the captured pushes -------------------------------
    def numbers(c):
        """Both kernels at one push: ms (the whole wrapper, 50-call means),
        the plain versions' ms and the bounds; ``index_add_``, which is also
        sim_push's plain version, as its library call."""
        n_sel, n_e = c["nodes"], c["messages"]
        # each node (id, PID, fluid, out-degree, row start) read once, each
        # message's edge (destination, weight, its owner) read once, each
        # message (key, value, |remote value|) written once; a multiply each
        m_bound = bound_ms(n_sel * 40 + n_e * 20 + n_e * 20, n_e,
                           flops_per_s=F64_FLOPS_PER_S)
        state, key, msg = c["state"].clone(), c["key"], c["msg"]
        # each message (int32 key, float64 value) read once, each distinct
        # target read and written once; one float64 add a message
        p_bound = bound_ms(
            key.numel() * (key.element_size() + msg.element_size())
            + c["targets"] * 2 * state.element_size(), key.numel(),
            flops_per_s=F64_FLOPS_PER_S)
        return (dict(ms=timer(lambda: sim_messages(*c["m_args"]), 50),
                     plain_ms=timer(lambda: sim_messages_plain(*c["m_args"]),
                                    20),
                     bound=m_bound),
                dict(ms=timer(lambda: sim_push(state, key, msg), 50),
                     plain_ms=timer(lambda: sim_push_plain(state, key, msg),
                                    50),
                     library_ms=timer(lambda: state.index_add_(0, key, msg),
                                      50),
                     bound=p_bound))

    (m_l, p_l), (m_m, p_m) = numbers(at["largest"]), numbers(at["median"])
    big, mid = at["largest"], at["median"]
    print(f"K7 at the median push ({mid['messages']} messages): sim_messages "
          f"{m_m['ms']:.4f} ms (bound {m_m['bound'][0]:.4f}, plain "
          f"{m_m['plain_ms']:.4f}), sim_push {p_m['ms']:.4f} ms (bound "
          f"{p_m['bound'][0]:.4f}, index_add_ {p_m['library_ms']:.4f}); a "
          f"whole push: {whole['largest'][0]} / {whole['median'][0]} device "
          f"kernels and copies, {whole['largest'][1]} / {whole['median'][1]} "
          "ms of stream time back to back (largest / median)")
    rows = [{
        "name": "sim_messages", "route": "cuda",
        "source": "src/repro_torch/csrc/sim_push.cu",
        "replaces": "src/repro/core/simulator.py:300",
        "launches": n_s["sim_messages"] + n_d["sim_messages"],
        "max_abs_err": big["err_m"],
        "ms": m_l["ms"], "plain_ms": m_l["plain_ms"],
        "bound_ms": m_l["bound"][0], "bound_by": m_l["bound"][1],
        "library_ms": None,
        "nodes": big["nodes"], "messages": big["messages"],
        # the same at the median push (by messages)
        "median_ms": m_m["ms"], "median_plain_ms": m_m["plain_ms"],
        "median_bound_ms": m_m["bound"][0], "median_nodes": mid["nodes"],
        "median_messages": mid["messages"],
    }, {
        "name": "sim_push", "route": "cuda",
        "source": "src/repro_torch/csrc/sim_push.cu",
        "replaces": "src/repro/core/simulator.py:304",
        "launches": n_s["sim_push"] + n_d["sim_push"],
        "max_abs_err": big["err"],
        # the whole kernel path: the wrapper and its one launch
        "ms": p_l["ms"], "plain_ms": p_l["plain_ms"],
        "bound_ms": p_l["bound"][0], "bound_by": p_l["bound"][1],
        "library_ms": p_l["library_ms"],
        "messages": big["messages"], "targets": big["targets"],
        "longest_bucket": big["longest"],
        "median_ms": p_m["ms"], "median_plain_ms": p_m["plain_ms"],
        "median_bound_ms": p_m["bound"][0],
        "median_library_ms": p_m["library_ms"],
        "median_messages": mid["messages"], "median_targets": mid["targets"],
        "median_longest_bucket": mid["longest"],
        # the whole push (messages, sum, remote |.| sums): summed over a run
        # and its share of the clean run's wall; its device kernels and
        # copies and its stream time, replayed at the two pushes
        "push_device_ms": push_ms, "push_wall_share": push_share,
        "push_launches": {k: v[0] for k, v in whole.items()},
        "push_stream_ms": {k: v[1] for k, v in whole.items()},
    }]
    summary = (
        f"simulator (N={problem.n}, K=8, batch): static {wall_s:.3f} s "
        f"{res_s.n_steps} steps cost {res_s.cost_iterations:.4f}, dynamic "
        f"{wall_d:.3f} s {res_d.n_steps} steps cost "
        f"{res_d.cost_iterations:.4f} {res_d.n_moves} moves, replay "
        f"{wall_r:.3f} s; out-degree order static cost {costs[False][0]:.4f}"
        f" ({costs[False][2]:.3f} s), dynamic {costs[True][0]:.4f} "
        f"({costs[True][1]} moves, {costs[True][2]:.3f} s); sequential "
        f"N=1000 K=16 {wall_q:.3f} s cost {res_q.cost_iterations:.4f} "
        f"({res_q.n_pushes} pushes); the pushes' device share of the wall "
        f"{json.dumps(push_share)}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return rows, summary


def resilience_phase(args, torch, dev, root, g, x_pallas, pallas_rounds):
    """Phase 15: checkpoint, chaos and the supervised serving loop on the
    card, on fresh GraphStores built from phase 3's graph ``g`` (phase 4's
    store is left alone).  ``x_pallas`` / ``pallas_rounds`` are phase 4's
    uninterrupted ``frontier:pallas`` solve.  Returns the summary line."""
    import shutil

    import repro_torch
    from repro_torch.api.session import _invariant_violation
    from repro_torch.chaos import ChaosPlan, ChaosRunner, tear_checkpoint
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.core.distributed import DistributedEngine
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.stream_bench import (
        StreamSpec, replay_reference, run_stream, stream_row)

    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    work = os.path.join(root, "build", "chip_smoke_phase15")
    shutil.rmtree(work, ignore_errors=True)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # (a) checkpoint, tear, verified restore on K1 ---------------------------
    problem = repro_torch.Problem.pagerank(g)
    target_error = problem.target_error
    opts = repro_torch.SolverOptions(device=args.device)
    cut = 2000 if pallas_rounds > 2000 else pallas_rounds // 2
    ckpt = os.path.join(work, "frontier")
    reset_launches()
    session = repro_torch.SolverSession(problem, "frontier:pallas",
                                        options=opts)
    session.solve(max_rounds=cut)
    t0 = time.perf_counter()
    path = session.checkpoint(ckpt)
    write_s = time.perf_counter() - t0
    n_bytes = sum(os.path.getsize(os.path.join(path, f))
                  for f in os.listdir(path))
    tear_checkpoint(session.checkpoint(ckpt))
    del session
    t0 = time.perf_counter()
    restored = repro_torch.SolverSession.restore(ckpt, problem, options=opts)
    sync()
    restore_s = time.perf_counter() - t0
    info = restored.restored_from
    # the restore's two host parts, timed apart on the same step
    like = {"b": np.zeros(g.n), "f": np.zeros(g.n), "h": np.zeros(g.n),
            "t": np.zeros(())}
    t0 = time.perf_counter()
    tree, _, _ = load_checkpoint(ckpt, like, 1)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    viol = _invariant_violation(problem, tree["b"], tree["h"], tree["f"])
    check_s = time.perf_counter() - t0
    rep = restored.solve()
    k1 = LAUNCHES["frontier_round_bsr"]
    rounds = info["rounds"] + rep.n_rounds
    pushes = info["ops"] + rep.n_ops
    same_x = bool(np.array_equal(rep.x, x_pallas))
    rejected = info["rejected"]
    print(f"checkpoint of frontier:pallas at round {info['rounds']}: "
          f"{n_bytes} bytes written in {write_s:.3f} s; the torn step "
          f"rejected: {rejected}; restored step {info['step']} in "
          f"{restore_s:.3f} s (load {load_s:.3f} s, host float64 invariant "
          f"check {check_s:.3f} s, |B-(I-P)H-F|_1 {viol:.3e})")
    print(f"restored frontier:pallas: converged {rep.converged} rounds "
          f"{info['rounds']} + {rep.n_rounds} = {rounds} pushes "
          f"{info['ops']} + {rep.n_ops} = {pushes}; x bit-equal to phase "
          f"4's uninterrupted solve {same_x}; K1 launches {k1}")
    if not (info["step"] == 1 and len(rejected) == 1 and rejected[0][0] == 2
            and rejected[0][1].startswith("invariant violated")):
        fail(f"the torn checkpoint was not rejected by its invariant: "
             f"{info}")
    if not rep.converged or not same_x:
        fail("the restored frontier:pallas solve left the uninterrupted one")
    if (args.n == 2**21 and args.seed == 0
            and (rounds, pushes) != RECORDED["frontier:pallas"]):
        fail(f"restored frontier:pallas at {(rounds, pushes)}, recorded "
             f"{RECORDED['frontier:pallas']}")
    if on_card and k1 != rounds:
        fail(f"K1 launched {k1} times in {rounds} rounds")
    del restored

    # (b) ChaosRunner.measure on K1: a torn checkpoint, then a kill; grains
    # of an eighth of the solve ---------------------------------------------
    grain = -(-pallas_rounds // 8)
    reset_launches()
    t0 = time.perf_counter()
    runner = ChaosRunner(
        problem, "frontier:pallas",
        ChaosPlan(seed=args.seed).checkpoint_crash(round=2).kill(0, round=6),
        ckpt_dir=os.path.join(work, "runner"),
        options=repro_torch.SolverOptions(device=args.device,
                                          trace_every=grain),
        checkpoint_every=2)
    m = runner.measure()
    runner_s = time.perf_counter() - t0
    print(f"ChaosRunner frontier:pallas (checkpoint_crash at grain 2, kill "
          f"at grain 6, grains of {grain} rounds, checkpoint every 2): "
          f"converged {m['converged']} kills {m['kills']} x_err_l1 "
          f"{m['x_err_l1']:.3e} undisturbed_ops {m['undisturbed_ops']} "
          f"disturbed_ops {m['disturbed_ops']} overhead_ops "
          f"{m['overhead_ops']} ({m['overhead_frac']:.4f}) wasted_ops "
          f"{m['wasted_ops']} chaos_log {m['chaos_log']}; K1 launches "
          f"{LAUNCHES['frontier_round_bsr']}; {runner_s:.1f} s")
    if not (m["converged"] and m["kills"] == 1 and m["x_err_l1"] <= 1e-6):
        fail(f"ChaosRunner on frontier:pallas: {m}")
    if on_card and LAUNCHES["frontier_round_bsr"] == 0:
        fail("ChaosRunner ran no K1 launch")
    del runner, problem

    # (c) the supervised stream on engine:chunk, k=4 (K3's edge table).  No
    # deadline: the first request from the seeded state is a cold solve,
    # which the reference soak's 50 ms at 2e6 pushes a second would cut
    # (and a cut request is served unconverged, off its twin) ------------
    spec = StreamSpec(
        n=g.n, k=4, method="engine:chunk", requests=STREAM_REQUESTS,
        drift=0.003, churn_every=8, churn_rot=1000, stale_update_at=15,
        poison_every=11, kill_at=(2, 9), rescale_at={5: 3, 12: 4},
        straggler=(3, 6, 6.0), deadline_s=None, sample_every=1,
        seed=args.seed)
    # the twin runs at k=3 where the supervisor restored at k=4 (request 9
    # to the 3 -> 4 rescale): two converged solves, each within
    # target_error of x
    dx_bound = max(1e-6, 2.0 * target_error)
    drain_s = []
    real_drain = DistributedEngine.drain_for_shrink

    def timed_drain(self, ex, k_new):
        t0 = time.perf_counter()
        out = real_drain(self, ex, k_new)
        sync()
        drain_s.append(time.perf_counter() - t0)
        return out

    reset_launches()
    t0 = time.perf_counter()
    DistributedEngine.drain_for_shrink = timed_drain
    try:
        run = run_stream(spec, os.path.join(work, "stream"),
                         device=args.device, graph=lambda: g)
    finally:
        DistributedEngine.drain_for_shrink = real_drain
    stream_s = time.perf_counter() - t0
    k3 = LAUNCHES["edge_sum"]
    t0 = time.perf_counter()
    ref = replay_reference(spec, run, device=args.device, graph=lambda: g)
    twin_s = time.perf_counter() - t0
    row = stream_row("soak", spec, run, ref)
    sup = run["sup"]
    counts = sup.log.counts()
    q = sup.quarantine.by_reason
    drains = [e.detail["drains"] for e in sup.log.of_kind("rescale")]
    dxs = {i: float(np.abs(run["samples"][i] - ref["samples"][i]).sum())
           for i in run["samples"]}
    print(f"stream engine:chunk k=4, N={g.n}: {row['served']} served, "
          f"{row['dropped']} dropped, {row['rejected']} rejected, "
          f"{row['applied_updates']} updates applied; pushes total "
          f"{row['total_ops']} undisturbed {row['undisturbed_ops']} wasted "
          f"{row['wasted_ops']}; log counts {json.dumps(counts)}; "
          f"quarantine {json.dumps(q)}; effective schedule "
          f"{run['effective']}")
    print(f"stream: |dx|_1 against the undisturbed twin at every served "
          f"request {json.dumps({i: f'{v:.3e}' for i, v in dxs.items()})}, "
          f"max {row['max_dx_l1']:.3e} (bound {dx_bound:.1e})")
    print(f"stream: rescales (request, k_new, host wall s) "
          f"{run['rescale_s']}, drained buckets {drains}, the shrink's "
          f"drain {[round(v, 4) for v in drain_s]} s of it; host wall "
          f"{stream_s:.1f} s (the twin {twin_s:.1f} s); K3 launches "
          f"{k3}; restores {sup.restores}")
    if row["dropped"] != 0 or not row["converged"]:
        fail(f"stream dropped or did not converge: {row}")
    if not row["max_dx_l1"] <= dx_bound:
        fail(f"stream left its undisturbed twin by {row['max_dx_l1']:.3e} "
             f"(bound {dx_bound:.1e})")
    if not (counts.get("fault", 0) >= 2 and counts.get("restore", 0) >= 2
            and counts.get("rescale", 0) >= 2
            and counts.get("update_applied", 0) >= 1):
        fail(f"stream log counts {counts}")
    if q != {"non-finite": 1, "stale-store-version": 1}:
        fail(f"stream quarantine {q}")
    if not drains or drains[0] != 6:
        fail(f"the 4 -> 3 shrink drained {drains} buckets, not 6")
    if on_card and k3 == 0:
        fail("the stream ran no K3 launch")
    del run, ref, sup
    shutil.rmtree(work, ignore_errors=True)
    return (f"resilience: restore at the recorded {rounds} rounds / "
            f"{pushes} pushes, ChaosRunner overhead {m['overhead_ops']} "
            f"pushes, stream {row['served']} served 0 dropped max |dx|_1 "
            f"{row['max_dx_l1']:.3e}; phase wall "
            f"{time.perf_counter() - t_phase:.1f} s")


def rank_serving_phase(args, torch, dev, timer, problem):
    """Phase 14: rank serving on the card — K3's lane form, batched
    multi-RHS solves, the continuous-batching scheduler with a graph
    update at its drain barrier, and update_graph on frontier:pallas and
    engine:bsr.  ``problem`` is phase 4's; its GraphStore is mutated here.
    Returns ``(rows, summary)``."""
    import repro_torch
    from repro_torch.graph import GraphStore, rotation_churn
    from repro_torch.interop import seed_session
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.edge_sum import (
        csc_edges, edge_sum, edge_sum_lanes, edge_sum_lanes_plain)
    from repro_torch.serving import Scheduler, solo_reference

    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    rng = np.random.default_rng(args.seed + 14)
    n = problem.n
    store = problem.graph
    src, dst, wgt = problem.p.edge_list()
    edges = csc_edges(src, dst, wgt, n, dev)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # (a) the lane form against its plain version and against K3
    lane_in = {}
    for c in RANK_LANES:
        x = torch.as_tensor(rng.standard_normal((c, n)) / n,
                            dtype=torch.float32, device=dev)
        if c > 1:
            x[c // 2] = 0.0  # a zero lane
        a, a2 = edge_sum_lanes(x, edges), edge_sum_lanes(x, edges)
        p = edge_sum_lanes_plain(x, edges.indptr, edges.src, edges.wgt)
        e = rel_l1(a, p)
        same = torch.equal(a, a2)
        k3 = all(torch.equal(a[lane], edge_sum(x[lane].contiguous(), edges))
                 for lane in range(c))
        zero_lane = c == 1 or bool((a[c // 2] == 0).all())
        zero_in = bool((edge_sum_lanes(torch.zeros_like(x), edges) == 0)
                       .all())
        print(f"K3 lanes C={c}: rel L1 {e:.3e}, bit-identical relaunch "
              f"{same}, each lane K3's bits {k3}, zero lane a zero row "
              f"{zero_lane}, zero input a zero output {zero_in}")
        if not (e <= REL_L1 and same and k3 and zero_lane and zero_in):
            fail(f"K3 lane form C={c}")
        lane_in[c] = (x, float((a - p).abs().max()))

    # (b) batched solves of personalized columns
    cols = np.abs(problem.b[:, None] * (
        1.0 + RANK_DRIFT * rng.standard_normal((n, RANK_LANES[-1]))))
    session = repro_torch.SolverSession(problem, "frontier:segment_sum",
                                        device=args.device)
    reset_launches()
    rep3 = session.solve_batch(cols[:, :3])
    lanes_3 = LAUNCHES["edge_sum_lanes"]
    raw3 = session.solve_batch(cols[:, :3], pad=False)
    lanes_raw = LAUNCHES["edge_sum_lanes"] - lanes_3
    if on_card and (lanes_3, lanes_raw) != (rep3.n_rounds, raw3.n_rounds):
        fail(f"K3's lane form launched {lanes_3} and {lanes_raw} times in "
             f"{rep3.n_rounds} and {raw3.n_rounds} batched rounds")
    pad_same = (np.array_equal(rep3.x, raw3.x) and rep3.extras[
        "ops_per_column"] == raw3.extras["ops_per_column"])
    print(f"solve_batch C=3: converged {rep3.converged} rounds "
          f"{rep3.n_rounds} ops {rep3.extras['ops_per_column']} bucket "
          f"{rep3.extras['bucket']} wall {rep3.wall_time_s:.3f} s (no pad "
          f"{raw3.wall_time_s:.3f} s); pad and no pad bit-equal x and equal "
          f"ops {pad_same}")
    if not (rep3.converged and pad_same):
        fail("solve_batch C=3 / padding")
    rep16 = session.solve_batch(cols)
    lanes_16 = LAUNCHES["edge_sum_lanes"] - lanes_3 - lanes_raw
    lanes_b = LAUNCHES["edge_sum_lanes"]
    round_ms = rep16.wall_time_s * 1e3 / max(rep16.n_rounds, 1)
    print(f"solve_batch C=16: converged {rep16.converged} rounds "
          f"{rep16.n_rounds} ops {rep16.n_ops} wall {rep16.wall_time_s:.3f} "
          f"s ({round_ms:.4f} ms a batched round); lane-form launches "
          f"{lanes_16}")
    if not rep16.converged or (on_card and lanes_16 != rep16.n_rounds):
        fail("solve_batch C=16")
    # each column against a cold single-lane frontier:segment_sum solve
    worst = 0.0
    for c in range(cols.shape[1]):
        session._driver.seed(cols[:, c])
        one = session.solve()
        for rep, width in ((rep16, 16), (rep3, 3)):
            if c >= width:
                continue
            dx = float(np.abs(rep.x[:, c] - one.x).sum())
            worst = max(worst, dx)
            if dx > 1e-5 or rep.extras["ops_per_column"][c] != one.n_ops:
                fail(f"column {c} of the C={width} batch: |dx|_1 {dx:.3e}, "
                     f"pushes {rep.extras['ops_per_column'][c]} against the "
                     f"single-lane solve's {one.n_ops}")
    print(f"every column within |dx|_1 {worst:.3e} of its single-lane "
          f"frontier:segment_sum solve, with equal edge pushes")
    del session

    # (c) the continuous-batching scheduler, one graph update midway
    bases = cols[:, :RANK_CLUSTERS]

    def request(cluster):
        return np.abs(bases[:, cluster] * (
            1.0 + RANK_DRIFT * rng.standard_normal(n)))

    sch = Scheduler(problem, max_lanes=16, rounds_per_tick=32,
                    device=args.device)
    sent = {}  # request id -> (its RHS, the Problem snapshot it ran on)
    wall = 0.0  # host wall of the scheduler's own calls

    def serve(wave):
        nonlocal wall
        t1 = time.perf_counter()
        for cluster in wave:
            rid = len(sent)
            sent[rid] = (request(cluster), sch.problem)
            sch.submit(sent[rid][0], cluster=cluster, request_id=rid)
        sch.run_until_idle()
        sync()
        wall += time.perf_counter() - t1

    def held_to_solo(ids):
        """|dx|_1 of the served requests ``ids`` from the sequential path
        (one warm-started session over the same snapshot)."""
        by_id = {r.request_id: r for r in sch.results}
        xs, _, _ = solo_reference(sent[ids[0]][1], np.stack(
            [sent[i][0] for i in ids], axis=1), device=args.device)
        return [float(np.abs(by_id[rid].x - xs[:, j]).sum())
                for j, rid in enumerate(ids)]

    reset_launches()
    serve(list(range(RANK_CLUSTERS)) * 2)  # cold: every cluster twice
    serve(range(RANK_CLUSTERS))  # warm from the pool
    lanes_c = LAUNCHES["edge_sum_lanes"]
    before = (2 * RANK_CLUSTERS, 2 * RANK_CLUSTERS + 1)
    dx_solo = held_to_solo(before)
    # the update, applied at the drain barrier
    n_rot = max(1, int(RANK_CHURN * sch.problem.n_edges) // 2)
    delta = rotation_churn(sch.problem.graph, n_rot, seed=args.seed)
    reset_launches()
    t1 = time.perf_counter()
    sch.submit_update(delta, store_version=sch.problem.store_version)
    sch.run_until_idle()
    t_update = time.perf_counter() - t1
    wall += t_update
    print(f"update: {delta.n_changes} changed edges "
          f"({delta.n_changes / problem.n_edges:.4%} of the links) applied "
          f"at the drain barrier in {t_update:.3f} s, store at version "
          f"{sch.problem.store_version}")
    stale = list(range(len(sent), len(sent) + 4))
    serve(range(4))  # the same clusters: their pooled H is stale
    after = (len(sent), len(sent) + 1)
    serve(range(4))  # warm from the post-update pool
    lanes_c += LAUNCHES["edge_sum_lanes"]
    dx_solo += held_to_solo(after)
    served = sch.results
    lat = sch.latency_percentiles()
    by_id = {r.request_id: r for r in served}
    stale_miss = all(not by_id[i].pool_hit for i in stale)
    print(f"scheduler: served {len(served)} dropped {sch.dropped} "
          f"converged {sum(r.converged for r in served)} applied updates "
          f"{sch.applied_updates} pool hits {sch.pool.hits} misses "
          f"{sch.pool.misses} (hit rate {sch.pool.hit_rate:.4f}, "
          f"invalidated {sch.pool.invalidations}), stale-version misses "
          f"after the update {stale_miss}; rounds "
          f"{sch.batcher.rounds_total} occupancy "
          f"{sch.batcher.mean_occupancy:.4f} width {sch.batcher.width}; "
          f"host wall {wall:.3f} s (QPS {len(served) / wall:.3f}); virtual "
          f"latency p50 {lat['p50']:.3f} s p99 {lat['p99']:.3f} s; "
          f"lane-form launches {lanes_c} ({lanes_c / len(served):.1f} a "
          f"request)")
    if not (len(served) == len(sent) == 32 and sch.dropped == 0
            and all(r.converged for r in served)
            and sch.applied_updates == 1 and sch.pool.hits > 0
            and stale_miss):
        fail("scheduler gates")
    if on_card and lanes_c != sch.batcher.rounds_total:
        fail("K3's lane form not launched once per scheduler round")
    print(f"requests {before + after} within |dx|_1 "
          f"{[f'{d:.3e}' for d in dx_solo]} of solo_reference (bound "
          f"2·target_error {2 * problem.target_error:.3e})")
    if max(dx_solo) > 2.0 * problem.target_error:
        fail("scheduler results against solo_reference")

    # (d) update_graph on frontier:pallas (K1) and engine:bsr (K2)
    def delta_resolve(prob, method, kernel, opts, seed, seeded=None):
        """A session of ``method`` on ``prob`` — solved cold, or seeded
        with ``seeded``, another session's (method, F, H, T) — a rotation
        delta through update_graph, the warm re-solve; gated against a
        cold frontier:segment_sum solve on a store rebuilt from the
        spliced edges.  Returns the session."""
        t1 = time.perf_counter()
        s = repro_torch.SolverSession(prob, method, device=args.device,
                                      **opts)
        if seeded is None:
            cold = s.solve()
            start = f"cold rounds {cold.n_rounds} pushes {cold.n_ops}"
        else:
            cold = None
            seed_session(s, *seeded[1:])
            start = (f"seeded with {seeded[0]}'s converged state "
                     f"(|F|_1 {s.residual:.3e})")
        n_rot = max(1, int(RANK_CHURN * s.problem.n_edges) // 2)
        delta = rotation_churn(s.problem.graph, n_rot, seed=seed)
        t2 = time.perf_counter()
        resid0 = s.update_graph(delta)
        t_upd = time.perf_counter() - t2
        pool = getattr(getattr(s._driver, "engine", None), "pool", None)
        if pool is None:
            pool = s._driver.m.blocks
        reset_launches()
        warm = s.solve()
        launched = LAUNCHES[kernel]
        rebuilt = s.problem.with_graph(
            GraphStore.from_csr(s.problem.graph.csr()))
        ref = repro_torch.solve(rebuilt, method="frontier:segment_sum",
                                device=args.device)
        dx = float(np.abs(warm.x - ref.x).sum())
        print(f"update_graph {method}: {start}; {delta.n_changes} changed "
              f"edges, |F'|_1 {resid0:.3e}, update {t_upd:.3f} s (store "
              f"version {s.problem.store_version}, its tile pool "
              f"{pool.shape[0]} tiles, {pool.numel() * 4 / 1e9:.3f} GB); "
              f"warm rounds "
              f"{warm.n_rounds} pushes {warm.n_ops} wall "
              f"{warm.wall_time_s:.3f} s, {kernel} launches {launched}; "
              f"|x - x_rebuilt segment_sum|_1 {dx:.3e} (its pushes "
              f"{ref.n_ops}); {time.perf_counter() - t1:.1f} s")
        # two converged schedules may differ by 2·target_error, which is
        # below 1e-5 from N = 2e5 on
        if not (warm.converged and dx <= max(1e-5, 2.0 * prob.target_error)
                and warm.n_ops < ref.n_ops
                and (cold is None or warm.n_ops < cold.n_ops)):
            fail(f"update_graph on {method}")
        if on_card and launched != warm.n_rounds:
            fail(f"{kernel} launched {launched} times in {warm.n_rounds} "
                 f"rounds of the {method} delta re-solve")
        return s

    s_pallas = delta_resolve(sch.problem, "frontier:pallas",
                             "frontier_round_bsr", {}, args.seed + 1)
    # its converged state on the host, its device tables freed before the
    # engine's tile pool (tens of GB after the deltas) is built
    seeded = (s_pallas.method, *s_pallas._driver.fluid(),
              s_pallas._driver.threshold())
    prob = s_pallas.problem
    del s_pallas
    if on_card:
        torch.cuda.empty_cache()
    delta_resolve(prob, "engine:bsr", "bsr_spmm", ENGINE_OPTS,
                  args.seed + 2, seeded=seeded)

    # the lane form's row for the kernels line, at C=16
    x16, err16 = lane_in[RANK_LANES[-1]]
    c16, n_e = x16.shape[0], edges.n_edges
    lane_bytes = edges.indptr.numel() * 8 + n_e * 8 + 2 * c16 * n * 4
    b_ms, b_by = bound_ms(lane_bytes, 2.0 * n_e * c16)
    lane_ms = timer(lambda: edge_sum_lanes(x16, edges), 20)
    lib_ms = None
    if on_card:
        a_csr = torch.sparse_csr_tensor(edges.indptr, edges.src.long(),
                                        edges.wgt, size=(n, n))
        x16t = x16.T.contiguous()
        lib_ms = timer(lambda: torch.sparse.mm(a_csr, x16t), 20)
        lib_err = float((torch.sparse.mm(a_csr, x16t).T
                         - edge_sum_lanes(x16, edges)).abs().max())
        print(f"torch.sparse.mm (sparse_csr over the destination CSR) vs "
              f"K3's lane form at C={c16}: max abs diff {lib_err:.3e}")
    print(f"a batched round at C=16: {round_ms:.4f} ms, of which the lane "
          f"form {lane_ms:.4f} ms and the rest {round_ms - lane_ms:.4f} ms")
    row = {
        "name": "edge_sum_lanes", "route": "cuda",
        "source": "src/repro_torch/csrc/edge_sum.cu",
        "replaces": "src/repro/api/session.py:114",
        "launches": lanes_b + lanes_c,
        "max_abs_err": err16,
        "ms": lane_ms,
        "plain_ms": timer(lambda: edge_sum_lanes_plain(
            x16, edges.indptr, edges.src, edges.wgt), 3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        "lanes": c16,
        "launches_per_request": lanes_c / len(served),
        "round_ms": round_ms,
        "round_rest_ms": round_ms - lane_ms,
    }
    summary = (f"rank serving: QPS {len(served) / wall:.3f} (host wall), "
               f"virtual p50 {lat['p50']:.3f} s p99 {lat['p99']:.3f} s, "
               f"occupancy {sch.batcher.mean_occupancy:.4f}, pool hit rate "
               f"{sch.pool.hit_rate:.4f}, rounds {sch.batcher.rounds_total};"
               f" phase wall {time.perf_counter() - t_phase:.1f} s")
    return [row], summary


def gin_host_batch(args):
    """Phase 10's batch on the host: the GIN graph (``power_law_graph`` of
    ``args.gin_nodes`` nodes, or the ``ogb_products`` cell's real count, at
    ``GIN_ALPHA``), its features and labels, padded to the cell's N and E
    (or by the cells' rule, nodes % 32 and edges % 512, at another size).
    Returns ``(batch, n, e, real e, graph s, batch s)``."""
    from repro_torch.configs import gin_tu
    from repro_torch.configs.gnn_common import SHAPE_DIMS
    from repro_torch.core import power_law_graph
    from repro_torch.data import make_gnn_batch, pad_gnn_batch

    dims = SHAPE_DIMS[GIN_SHAPE]
    cfg = gin_tu.cfg_for(GIN_SHAPE)
    n_nodes = args.gin_nodes or dims["n_real"]
    t0 = time.perf_counter()
    g = power_law_graph(n_nodes, alpha=GIN_ALPHA, seed=args.seed)
    graph_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gb = make_gnn_batch(g, cfg.d_feat, n_classes=cfg.n_classes,
                        seed=args.seed)
    batch_s = time.perf_counter() - t0
    if n_nodes == dims["n_real"]:
        n, e = dims["n"], dims["e"]
    else:
        n, e = -(-g.n // 32) * 32, -(-g.n_edges // 512) * 512
    if g.n_edges > e:
        fail(f"the GIN graph has {g.n_edges} edges, over the cell's {e}")
    return pad_gnn_batch(gb, n, e), n, e, g.n_edges, graph_s, batch_s


def _split_by_kernel(stats, buckets):
    """Device ms of ``stats`` (``device_share``'s rows) by the first of
    ``buckets`` ((label, name fragments)) whose fragment a kernel's name
    holds; the rest under ``other``.  Returns the split and the three
    largest kernels of ``other`` ((ms, name) pairs)."""
    split = {label: 0.0 for label, _ in buckets}
    split["other"] = 0.0
    rest = []
    for ms, _, key in stats or ():
        low = key.lower()
        label = next((lb for lb, frags in buckets
                      if any(fr in low for fr in frags)), "other")
        split[label] += ms
        if label == "other":
            rest.append((round(ms, 4), key[:60]))
    return {k: round(v, 4) for k, v in split.items()}, sorted(rest)[::-1][:3]


def fm_training(args, torch, dev, timer, sync, fm_model, spec):
    """Phase 9 (b): FM training at the ``train_batch`` cell on phase 9's
    table, through ``launch.steps``' train kind.  Returns ``(rows,
    summary)``."""
    from repro_torch.data import criteo_like_batch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.fm import (fm_interaction_bwd_kernel,
                                        fm_interaction_bwd_ref)
    from repro_torch.kernels.segment import (
        FORMS, embedding_bwd_kernel, embedding_bwd_ref, segment_sum_kernel)
    from repro_torch.launch.steps import build_cell_step
    from repro_torch.models import recsys
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.optim.adamw import tree_leaves, tree_map

    on_card = dev.type == "cuda"
    cfg = fm_model.cfg
    nf, dim, n_rows = cfg.n_fields, cfg.embed_dim, cfg.n_rows
    cell = spec.cells["train_batch"]
    b = cell.meta["batch"]
    n_steps = 4
    t0 = time.perf_counter()
    batches = [criteo_like_batch(10 + i, b, nf, args.fm_vocab,
                                 seed=args.seed) for i in range(n_steps)]
    hot = np.bincount(batches[0]["ids"][:, 0]).max()
    print(f"fm train_batch: {n_steps} host batches of {b} x {nf} made in "
          f"{time.perf_counter() - t0:.1f} s; field 0's hottest id in "
          f"{hot} rows")
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=n_steps)
    step = build_cell_step(spec, cell, fm_model, ocfg)
    tree = fm_model.param_tree()
    state = adamw_init(tree)
    sync()
    held = torch.cuda.memory_allocated() / 1e9 if on_card else 0.0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    forms0 = dict(FORMS)
    walls, losses = [], []
    for i, batch in enumerate(batches):
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        tree, state, metrics = step(tree, state, batch)
        sync()
        walls.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        delta = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        want = {"fm_interaction": 1, "fm_interaction_bwd": 1,
                "embedding_gather_bwd": 2, "segment_sum_carry": 0}
        if on_card and any(delta[k] != v for k, v in want.items()):
            fail(f"FM train step {i}: launches {delta}, want {want}")
    launches = dict(LAUNCHES)
    forms = {k: v - forms0[k] for k, v in FORMS.items()}
    peak = (torch.cuda.max_memory_allocated() / 1e9 - held if on_card
            else 0.0)
    if not all(np.isfinite(losses)):
        fail(f"FM training losses not finite: {losses}")
    if on_card and forms != {"contiguous": 0, "gather": 0}:
        fail(f"FM training's K5 launches by form {forms}")
    med = float(np.median(walls))
    print(f"FM train steps (B={b}): losses {[round(x, 6) for x in losses]}; "
          f"walls {[round(w * 1e3, 3) for w in walls]} ms (median "
          f"{med * 1e3:.3f} ms, {b / med:.0f} samples/s); launches "
          f"fm_interaction {launches['fm_interaction']}, fm_interaction_bwd "
          f"{launches['fm_interaction_bwd']}, embedding_gather_bwd "
          f"{launches['embedding_gather_bwd']} (K5's carry "
          f"{launches['segment_sum_carry']}, K5 by form {forms}); device "
          f"memory peak {peak:.3f} GB above the {held:.3f} GB held")

    # checks, off the counted steps: the gradients with the kernels against
    # the plain versions', and bit-equal on a rerun
    batch = batches[0]
    leaves = tree_leaves(fm_model.param_tree())
    names = sorted(fm_model.param_tree())

    def grads(kernels):
        loss = recsys.loss_fn(fm_model, batch, kernels=kernels)
        return [g.detach() for g in torch.autograd.grad(loss, leaves)]

    got, again = grads(True), grads(True)
    plain = grads(False)
    errs = {n: rel_l1(a, c) for n, a, c in zip(names, got, plain)}
    same = {n: bool(torch.equal(a, c)) for n, a, c in zip(names, got, again)}
    print(f"FM gradients with the kernels vs the plain versions: rel L1 "
          f"{ {k: f'{v:.3e}' for k, v in errs.items()} }; bit-equal on a "
          f"rerun {same}")
    if max(errs.values()) > 1e-4:
        fail("FM gradients disagree with the plain versions'")
    if not (same["table"] and same["lin_table"]):
        fail("FM table gradients differ on a rerun")
    del got, again, plain

    # K4's backward on the step's operands
    ids = torch.as_tensor(batch["ids"], device=dev)
    offs = torch.arange(nf, dtype=torch.int32, device=dev) * cfg.vocab_per_field
    rows = (ids + offs).reshape(-1)
    with torch.no_grad():
        v = fm_model.table.index_select(0, rows).reshape(b, nf, dim)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    dy = torch.randn(b, generator=gen, device=dev) / b
    gv, gv2, gv_plain = (fm_interaction_bwd_kernel(v, dy),
                         fm_interaction_bwd_kernel(v, dy),
                         fm_interaction_bwd_ref(v, dy))
    e4, same4 = rel_l1(gv, gv_plain), torch.equal(gv, gv2)
    print(f"K4's backward on the step's gather {tuple(v.shape)}: rel L1 "
          f"{e4:.3e}, bit-identical relaunch {same4}")
    if not (e4 <= REL_L1 and same4):
        fail("K4's backward against its plain version")
    b_ms, b_by = bound_ms(v.numel() * 4 * 2 + b * 4,
                          2.0 * v.numel() + 1.0 * v.numel())
    bwd_row = {
        "name": "fm_interaction_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/fm.cu",
        "replaces": "src/repro/kernels/fm/kernel.py:32",
        "launches": launches["fm_interaction_bwd"],
        "max_abs_err": float((gv - gv_plain).abs().max()),
        "ms": timer(lambda: fm_interaction_bwd_kernel(v, dy), 20),
        "plain_ms": timer(lambda: fm_interaction_bwd_ref(v, dy), 10),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": list(v.shape),
    }
    del gv2, gv_plain

    # the tables' gradient on its kernel: grad_v's rows (and dy by bags of
    # nf, the linear table's) summed by row id
    g = gv.reshape(-1, dim)
    g_lin = dy[:, None]
    seg, order = torch.sort(rows, stable=True)
    errs = {}
    for what, data, bag in (("table", g, 1), ("linear table", g_lin, nf)):
        got, again, want = (embedding_bwd_kernel(data, seg, order, n_rows, bag),
                            embedding_bwd_kernel(data, seg, order, n_rows, bag),
                            embedding_bwd_ref(data, seg, order, n_rows, bag))
        err, same = rel_l1(got, want), torch.equal(got, again)
        errs[what] = float((got - want).abs().max())
        print(f"the {what}'s gradient ({seg.numel()} rows, bag {bag}, into "
              f"{n_rows} x {data.shape[1]}): rel L1 {err:.3e}, bit-identical "
              f"relaunch {same}")
        if not (err <= REL_L1 and same):
            fail(f"the {what}'s gradient against its plain version")
        del got, again, want
    rows_l = rows.long()
    src_l = torch.div(order, nf, rounding_mode="floor")
    dy_rep = dy.repeat_interleave(nf)
    # grad_v's rows, the sorted ids (int32) and the order (int64) read,
    # the dense gradient written once
    eb_ms, eb_by = bound_ms(g.numel() * 4 + seg.numel() * 12
                            + n_rows * dim * 4, float(g.numel()))
    lb_ms, _ = bound_ms(b * 4 + seg.numel() * 12 + n_rows * 4,
                        float(seg.numel()))
    # the kernel and K5's gather form that it replaced, in turns
    turns = least(timer, {
        "ms": lambda: embedding_bwd_kernel(g, seg, order, n_rows, 1),
        "k5_ms": lambda: segment_sum_kernel(g, seg, n_rows, None, order),
        "lin_ms": lambda: embedding_bwd_kernel(g_lin, seg, order, n_rows, nf),
        "k5_lin_ms": lambda: segment_sum_kernel(g_lin, seg, n_rows, None,
                                                src_l)}, 10)
    emb_row = {
        "name": "embedding_gather_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/embedding_bwd.cu",
        "replaces": "src/repro/models/recsys.py:77",
        "launches": launches["embedding_gather_bwd"],
        "max_abs_err": errs["table"],
        "ms": turns["ms"][0],
        "plain_ms": timer(lambda: embedding_bwd_ref(g, seg, order, n_rows),
                          3),
        "bound_ms": eb_ms, "bound_by": eb_by,
        "library_ms": (timer(lambda: torch.zeros(
            (n_rows, dim), device=dev).index_add_(0, rows_l, g), 10)
            if on_card else None),
        # the linear table's launch: dy's rows by bag, D = 1
        "lin_ms": turns["lin_ms"][0], "lin_bound_ms": lb_ms,
        "lin_max_abs_err": errs["linear table"],
        "lin_library_ms": (timer(lambda: torch.zeros(
            n_rows, device=dev).index_add_(0, rows_l, dy_rep), 10)
            if on_card else None),
        "k5_ms": turns["k5_ms"][0], "k5_lin_ms": turns["k5_lin_ms"][0],
        "zeros_ms": timer(lambda: torch.zeros((n_rows, dim), device=dev), 10),
        "turns_ms": {k: [round(x, 4) for x in v] for k, v in turns.items()},
        "shape": [int(g.shape[0]), dim, n_rows],
    }
    print(f"the tables' gradient: {emb_row['ms']:.4f} ms (bound "
          f"{eb_ms:.4f}; K5's gather form {emb_row['k5_ms']:.4f}; "
          f"zeros().index_add_ {emb_row['library_ms']}; a torch.zeros of "
          f"the output alone {emb_row['zeros_ms']:.4f}); the linear "
          f"table's {emb_row['lin_ms']:.4f} ms (bound {lb_ms:.4f}; K5 "
          f"{emb_row['k5_lin_ms']:.4f}; library "
          f"{emb_row['lin_library_ms']}); least / greatest of two turns "
          f"{emb_row['turns_ms']}")
    del g, g_lin, gv, v, seg, order, src_l, rows_l, dy_rep

    split = None
    if on_card:
        stats = device_share(torch, "FM train step", lambda: step(
            tree, state, batches[1]), untraced_ms=med * 1e3)
        split, rest = _split_by_kernel(stats, (
            ("k4_bwd", ("fm_interaction_bwd",)),
            ("k4", ("fm_interaction",)),
            ("emb_bwd", ("embedding_bwd",)),
            ("k5", ("segment_sum",)),
            ("gather", ("indexselect", "index_select", "gather")),
            ("sort", ("sort",))))
        # AdamW's kernels are elementwise ones like the loss's: its share is
        # read from a trace of AdamW alone over one step's gradients
        loss = recsys.loss_fn(fm_model, batches[1])
        it = iter(torch.autograd.grad(loss, leaves))
        gtree = tree_map(lambda _: next(it), fm_model.param_tree())
        adam = device_share(torch, "AdamW alone", lambda: adamw_update(
            gtree, state, ocfg, param_dtype=cfg.dtype))
        split["adamw"] = round(sum(ms for ms, _, _ in adam or ()), 4)
        split["other"] = round(split["other"] - split["adamw"], 4)
        del gtree, it, loss
        print(f"FM train step device ms by kernel (adamw from its own trace, "
              f"other the rest): {split}; the largest kernels outside the "
              f"named ones (AdamW's among them): {rest}")
    del state, tree
    summary = (f"FM training (fm train_batch, B={b}): step walls "
               f"{[round(w * 1e3, 3) for w in walls]} ms, {b / med:.0f} "
               f"samples/s, peak {peak:.3f} GB above {held:.3f} GB; "
               f"device split {split}")
    return [bwd_row, emb_row], summary


def gin_training(args, torch, dev, timer, sync, gin, prepared):
    """Phase 10 (b): GIN training at ``ogb_products`` on phase 10's graph
    and prepared batch, through ``launch.steps``' train kind.  Returns
    ``(rows, summary)``."""
    import repro_torch.kernels.segment.ops as seg_ops
    from repro_torch.configs import gin_tu
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.segment import (
        FORMS, segment_sum_kernel, segment_sum_ref)
    from repro_torch.launch.steps import build_cell_step
    from repro_torch.models import gnn
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import tree_leaves

    on_card = dev.type == "cuda"
    spec = gin_tu.spec()
    n_layers = gin.cfg.n_layers
    n_steps = 3
    step = build_cell_step(spec, spec.cells[GIN_SHAPE], gin,
                           AdamWConfig(lr=1e-3, warmup_steps=1,
                                       total_steps=n_steps))
    tree = gin.param_tree()
    state = adamw_init(tree)
    sync()
    held = torch.cuda.memory_allocated() / 1e9 if on_card else 0.0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    forms0 = dict(FORMS)
    walls, losses = [], []
    for i in range(n_steps):
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        tree, state, metrics = step(tree, state, prepared)
        sync()
        walls.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        delta = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        want = {"segment_sum": n_layers, "gnn_agg_bwd": n_layers,
                "segment_sum_carry": 2 * n_layers}
        if on_card and any(delta[k] != v for k, v in want.items()):
            fail(f"GIN train step {i}: launches {delta}, want {want}")
    launches = dict(LAUNCHES)
    forms = {k: v - forms0[k] for k, v in FORMS.items()}
    peak = (torch.cuda.max_memory_allocated() / 1e9 - held if on_card
            else 0.0)
    if not all(np.isfinite(losses)):
        fail(f"GIN training losses not finite: {losses}")
    if on_card and forms != {"contiguous": 0,
                             "gather": 2 * n_layers * n_steps}:
        fail(f"GIN training's K5 launches by form {forms}")
    print(f"GIN train steps: losses {[round(x, 6) for x in losses]}; walls "
          f"{[round(w, 4) for w in walls]} s; launches segment_sum "
          f"{launches['segment_sum']}, gnn_agg_bwd {launches['gnn_agg_bwd']}"
          f" (carry {launches['segment_sum_carry']}, by form {forms}); "
          f"device memory peak {peak:.3f} GB above the {held:.3f} GB held")

    # checks, off the counted steps: every leaf's gradient with the
    # kernels against the plain run's; each K5 backward relaunched on its
    # operands, bit for bit
    leaves = tree_leaves(gin.param_tree())
    real = seg_ops.segment_sum_kernel
    relaunched = []

    def twice(data, seg, n, weights=None, rows=None, count=None):
        out = real(data, seg, n, weights, rows, count=count)
        if count == "gnn_agg_bwd":
            relaunched.append(bool(torch.equal(
                out, real(data, seg, n, weights, rows, count=count))))
        return out

    seg_ops.segment_sum_kernel = twice
    try:
        got = torch.autograd.grad(gnn.loss_fn(gin, prepared), leaves)
    finally:
        seg_ops.segment_sum_kernel = real
    plain = torch.autograd.grad(gnn.loss_fn(gin, prepared, kernels=False),
                                leaves)
    errs = [rel_l1(a, c) for a, c in zip(got, plain)]
    print(f"GIN gradients with the kernels vs the plain run: largest rel L1 "
          f"of {len(errs)} leaves {max(errs):.3e}; the {len(relaunched)} K5 "
          f"backwards bit-equal on a relaunch: {all(relaunched)}")
    if max(errs) > 1e-4:
        fail("GIN gradients disagree with the plain run's")
    if on_card and (len(relaunched) != n_layers or not all(relaunched)):
        fail(f"GIN's K5 backwards on a relaunch: {relaunched}")
    del got, plain

    # one layer's aggregation backward on its operands
    n = prepared["x"].shape[0]
    t_seg, t_rows, t_w = (prepared["aggT_seg"], prepared["aggT_rows"],
                          prepared["aggT_w"])
    n_e = t_seg.shape[0]
    dh = gin.cfg.d_hidden
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    g = torch.randn((n, dh), generator=gen, device=dev)

    def k5(data):
        return segment_sum_kernel(data, t_seg, n, t_w, t_rows,
                                  count="gnn_agg_bwd")

    a, a2, p = k5(g), k5(g), segment_sum_ref(g, t_seg, n, t_w, t_rows)
    eg, sameg = rel_l1(a, p), torch.equal(a, a2)
    print(f"K5 as one layer's aggregation backward (g {tuple(g.shape)}, "
          f"rows = the destinations by source): rel L1 {eg:.3e}, "
          f"bit-identical relaunch {sameg}")
    if not (eg <= REL_L1 and sameg):
        fail("K5 as the aggregation backward against its plain version")
    err = float((a - p).abs().max())
    del a2, p
    # as the forward's gather form: g read and grad_h written once; the
    # ids, the rows and the weights
    gb_ms, gb_by = bound_ms(g.numel() * 4 * 2 + n_e * 4 * 3, 2.0 * n_e * dh)
    lib = None
    if on_card:
        ptr = torch.searchsorted(t_seg, torch.arange(
            n + 1, dtype=t_seg.dtype, device=dev))
        csr = torch.sparse_csr_tensor(ptr, t_rows.long(), t_w, size=(n, n))
        lib = timer(lambda: torch.sparse.mm(csr, g), 5)
        print(f"torch.sparse.mm (the transposed sparse_csr) vs K5: max abs "
              f"diff {float((torch.sparse.mm(csr, g) - a).abs().max()):.3e}")
        del csr, ptr
    row = {
        "name": "segment_sum_gather_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/segment_sum.cu",
        "replaces": "src/repro/kernels/segment/kernel.py:50",
        "launches": launches["gnn_agg_bwd"], "form": "gather",
        "max_abs_err": err,
        "ms": timer(lambda: k5(g), 10),
        "plain_ms": timer(lambda: segment_sum_ref(g, t_seg, n, t_w, t_rows),
                          3),
        "bound_ms": gb_ms, "bound_by": gb_by, "library_ms": lib,
        "shape": [n_e, dh, n],
    }
    del a, g, state, tree
    summary = (f"GIN training (gin-tu {GIN_SHAPE}): step walls "
               f"{[round(w, 4) for w in walls]} s, peak {peak:.3f} GB above "
               f"{held:.3f} GB")
    return [row], summary


def gnn_archs_host_batch(args):
    """Phase 10 (c)'s forward batch on the host: a ``power_law_graph`` of
    ``args.gnn_nodes`` nodes (default the ``minibatch_lg`` cell's 169,984)
    at ``GNN_ALPHA``, ``make_gnn_batch`` with coordinates, atom types and
    triplets, padded to the cell's N, E and T = 8·E (or by the cells'
    rule at another size).  Returns ``(batch, n, e, t, real e, real t,
    host s)``."""
    from repro_torch.configs.gnn_common import SHAPE_DIMS, TRIP_PER_EDGE
    from repro_torch.core import power_law_graph
    from repro_torch.data import make_gnn_batch, pad_gnn_batch

    dims = SHAPE_DIMS[GNN_FWD_SHAPE]
    n_nodes = args.gnn_nodes or dims["n_real"]
    t0 = time.perf_counter()
    g = power_law_graph(n_nodes, alpha=GNN_ALPHA, seed=args.seed)
    gb = make_gnn_batch(g, dims["d_feat"], n_classes=dims["classes"],
                        with_pos=True, with_triplets=True, seed=args.seed)
    if n_nodes == dims["n_real"]:
        n, e = dims["n"], dims["e"]
    else:
        n, e = -(-g.n // 32) * 32, -(-g.n_edges // 512) * 512
    if g.n_edges > e:
        fail(f"the {GNN_FWD_SHAPE} graph has {g.n_edges} edges, over the "
             f"cell's {e}")
    t_real = gb["trip_e"].shape[0]
    t = e * TRIP_PER_EDGE
    return (pad_gnn_batch(gb, n, e, t), n, e, t, g.n_edges, t_real,
            time.perf_counter() - t0)


def gnn_launches(arch: str, n_layers: int, graph: bool, train: bool):
    """The launches one forward (and, with ``train``, its backward) of a
    MeshGraphNet / EGNN / DimeNet implies: K5 (``segment_sum``) once an
    aggregation (MeshGraphNet's per layer; EGNN's position update and
    aggregation per layer; DimeNet's triplet aggregation and node output
    per block), once more for a graph task's pooling, each with its carry
    at these shapes (more than one 1,024-row chunk); the gathers'
    gradients (``embedding_gather_bwd``) once a gather of a tensor that
    wants one: ``h[src]``, ``h[dst]`` per layer (and EGNN's ``pos[src]``,
    ``pos[dst]`` after layer 0), DimeNet's ``atom_embed[z]``,
    ``hz[src]``, ``hz[dst]`` and ``m[trip_f]`` per block.  Also the K5
    launches in the contiguous form (DimeNet's triplet aggregations)."""
    k5 = (1 if arch == "meshgraphnet" else 2) * n_layers + int(graph)
    emb = {"meshgraphnet": 2 * n_layers, "egnn": 4 * n_layers - 2,
           "dimenet": n_layers + 3}[arch]
    want = {"segment_sum": k5, "segment_sum_carry": k5,
            "embedding_gather_bwd": emb if train else 0}
    return want, (n_layers if arch == "dimenet" else 0)


def gnn_archs_phase(args, torch, dev, timer, sync, host):
    """Phase 10 (c): MeshGraphNet, EGNN and DimeNet at full width.  (a) 3
    AdamW steps each of the ``molecule`` cell through ``launch.steps``
    (``host`` supplies (b)'s batch).  Returns ``(rows, summary)``."""
    import repro_torch.configs as configs
    from repro_torch.configs.gnn_common import SHAPE_DIMS, TRIP_PER_EDGE
    from repro_torch.data import molecule_batch, pad_gnn_batch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.segment import (
        FORMS, embedding_bwd_kernel, embedding_bwd_ref, segment_sum_kernel,
        segment_sum_ref)
    from repro_torch.launch.steps import build_cell_step
    from repro_torch.models import gnn
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import tree_leaves

    on_card = dev.type == "cuda"
    cfg_for = {a: importlib.import_module(f"repro_torch.configs.{a}").cfg_for
               for a in GNN_ARCHS}
    n_steps = 3
    dims = SHAPE_DIMS[GNN_TRAIN_SHAPE]
    mol = molecule_batch(dims["graphs"], dims["n"] // dims["graphs"],
                         dims["e"] // dims["graphs"], dims["d_feat"],
                         with_triplets=True, seed=args.seed)
    mol_t = mol["trip_e"].shape[0]
    mol = pad_gnn_batch(mol, dims["n"], dims["e"], dims["e"] * TRIP_PER_EDGE)
    print(f"(a) {GNN_TRAIN_SHAPE}: {dims['graphs']} graphs, N={dims['n']} "
          f"E={dims['e']} T={mol['trip_e'].shape[0]} ({mol_t} real)")
    counted = {}  # arch -> (forwards, training steps) in the counted runs
    summary = []

    def grads(model, batch, leaves, **kw):
        loss = gnn.loss_fn(model, batch, **kw)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g
                for p, g in zip(leaves, got)]

    for arch in GNN_ARCHS:
        spec = configs.get_arch(arch)
        cfg = cfg_for[arch](GNN_TRAIN_SHAPE)
        model = gnn.init_params(cfg, seed=args.seed, device=dev)
        prepared = gnn.prepare_batch(mol, dev, arch)
        step = build_cell_step(spec, spec.cells[GNN_TRAIN_SHAPE], model,
                               AdamWConfig(lr=1e-3, warmup_steps=1,
                                           total_steps=n_steps))
        tree = model.param_tree()
        state = adamw_init(tree)
        want, contiguous = gnn_launches(arch, cfg.n_layers, True, True)
        sync()
        held = torch.cuda.memory_allocated() / 1e9 if on_card else 0.0
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        reset_launches()
        forms0 = dict(FORMS)
        walls, losses = [], []
        for i in range(n_steps):
            before = dict(LAUNCHES)
            t0 = time.perf_counter()
            tree, state, metrics = step(tree, state, prepared)
            sync()
            walls.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
            delta = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
            if on_card and delta != {k: want.get(k, 0) for k in LAUNCHES}:
                fail(f"{arch} train step {i}: launches "
                     f"{ {k: v for k, v in delta.items() if v} }, want "
                     f"{want}")
        forms = {k: v - forms0[k] for k, v in FORMS.items()}
        counted[arch] = (0, n_steps)
        peak = (torch.cuda.max_memory_allocated() / 1e9 - held if on_card
                else 0.0)
        if not all(np.isfinite(losses)):
            fail(f"{arch} training losses not finite: {losses}")
        if on_card and forms["contiguous"] != contiguous * n_steps:
            fail(f"{arch} training's K5 launches by form {forms}")
        n_params = sum(p.numel() for p in model.parameters())
        print(f"{arch} {GNN_TRAIN_SHAPE} ({cfg.n_layers} layers, d "
              f"{cfg.d_hidden}, {n_params} parameters): losses "
              f"{[round(x, 6) for x in losses]}; walls "
              f"{[round(w, 4) for w in walls]} s; launches a step "
              f"{json.dumps(want)} (K5 by form over the run {forms}); "
              f"device memory peak {peak:.3f} GB above {held:.3f} GB")
        # off the counted steps: the gradients with the kernels against
        # the plain versions', and a rerun's bit for bit
        leaves = tree_leaves(model.param_tree())
        got = grads(model, prepared, leaves)
        again = grads(model, prepared, leaves)
        plain = grads(model, prepared, leaves, kernels=False)
        errs = [rel_l1(a, c) for a, c in zip(got, plain)]
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        print(f"{arch} gradients with the kernels vs the plain run: largest "
              f"rel L1 of {len(errs)} leaves {max(errs):.3e}; a rerun "
              f"bit-equal: {same}")
        if max(errs) > 1e-4:
            fail(f"{arch} gradients disagree with the plain run's")
        if not same:
            fail(f"{arch} gradients differ on a rerun")
        summary.append(f"{arch} step walls {[round(w, 4) for w in walls]} s")
        del model, prepared, step, tree, state, got, again, plain
    del mol

    # (b) the forward at minibatch_lg, full width
    t0 = time.perf_counter()
    gb, n, e, t, e_real, t_real, host_s = host.result()
    wait_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fwd = gnn.prepare_batch(gb, dev, "dimenet")  # every arch's keys
    sync()
    prep_s = time.perf_counter() - t0
    del gb
    print(f"(b) {GNN_FWD_SHAPE}: N={n} E={e} ({e_real} real, alpha "
          f"{GNN_ALPHA}) T={t} ({t_real} real) d_feat="
          f"{fwd['x'].shape[1]}; host build {host_s:.1f} s (on a host "
          f"thread; waited {wait_s:.1f} s here); upload + sorts "
          f"{prep_s:.1f} s")
    for arch in GNN_ARCHS:
        cfg = cfg_for[arch](GNN_FWD_SHAPE)
        model = gnn.init_params(cfg, seed=args.seed, device=dev)
        want, contiguous = gnn_launches(arch, cfg.n_layers, False, False)
        sync()
        held = torch.cuda.memory_allocated() / 1e9 if on_card else 0.0
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        reset_launches()
        forms0 = dict(FORMS)
        t0 = time.perf_counter()
        with torch.no_grad():
            out = gnn.forward(model, fwd)
        sync()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in LAUNCHES.items() if v}
        forms = {k: v - forms0[k] for k, v in FORMS.items()}
        counted[arch] = (1, counted[arch][1])
        peak = (torch.cuda.max_memory_allocated() / 1e9 - held if on_card
                else 0.0)
        if on_card and (launches != {k: v for k, v in want.items() if v}
                        or forms["contiguous"] != contiguous):
            fail(f"{arch} forward: launches {launches} ({forms} by form), "
                 f"want {want}")
        if out.shape != (n, cfg.d_out) or not bool(out.isfinite().all()):
            fail(f"{arch} forward output not finite or of shape "
                 f"{tuple(out.shape)}")
        with torch.no_grad():
            out_plain = gnn.forward(model, fwd, segment_sum=segment_sum_ref)
        err = rel_l1(out, out_plain)
        print(f"{arch} {GNN_FWD_SHAPE} ({cfg.n_layers} layers, d "
              f"{cfg.d_hidden}): forward wall {wall:.4f} s, launches "
              f"{json.dumps(launches)}; device memory peak {peak:.3f} GB "
              f"above {held:.3f} GB; |out|_1 / N "
              f"{float(out.abs().sum()) / n:.4e}; vs the plain version: "
              f"rel L1 {err:.3e}")
        if err > REL_L1:
            fail(f"{arch} forward with the kernels disagrees with the plain "
                 "version")
        summary.append(f"{arch} {GNN_FWD_SHAPE} forward {wall:.4f} s, peak "
                       f"{peak:.3f} GB")
        del model, out, out_plain

    # (c) the kernels at the forward's operands, against their plain
    # versions and a library call
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    n_t = fwd["trip_e"].shape[0]
    d = cfg_for["meshgraphnet"](GNN_FWD_SHAPE).d_hidden
    mgn_layers = cfg_for["meshgraphnet"](GNN_FWD_SHAPE).n_layers
    egnn_layers = cfg_for["egnn"](GNN_FWD_SHAPE).n_layers
    dn_layers = cfg_for["dimenet"](GNN_FWD_SHAPE).n_layers

    def runs(arch, per_forward, per_step):
        f, s_ = counted[arch]
        return per_forward * f + per_step * s_

    def k5_row(name, role, data, ids, seg, n_seg, weights, rows, launches):
        w_sorted = None if weights is None else (
            weights if rows is None else weights.index_select(0, rows))
        a, a2 = (segment_sum_kernel(data, seg, n_seg, w_sorted, rows)
                 for _ in range(2))
        p = segment_sum_ref(data, seg, n_seg, w_sorted, rows)
        err, same = rel_l1(a, p), torch.equal(a, a2)
        print(f"K5 as {role} ({tuple(data.shape)} into {n_seg}, "
              f"{'gather' if rows is not None else 'contiguous'} form): rel "
              f"L1 {err:.3e}, bit-identical relaunch {same}")
        if not (err <= REL_L1 and same):
            fail(f"K5 as {role} against its plain version")
        n_e, dd = data.shape
        # each row read once, the ids (int32), the rows (int64) and the
        # weights, the output written once
        n_bytes = (data.numel() * 4 + n_e * 4 + n_seg * dd * 4
                   + (0 if rows is None else n_e * 8)
                   + (0 if weights is None else n_e * 4))
        b_ms, b_by = bound_ms(n_bytes, (2.0 if weights is not None else 1.0)
                              * n_e * dd)
        lib = None
        if on_card:
            idx = ids.long()
            wd = data if weights is None else data * weights[:, None]
            lib = timer(lambda: torch.zeros((n_seg, dd), device=dev)
                        .index_add_(0, idx, wd), 5)
            del idx, wd
        row = {"name": name, "route": "cuda",
               "source": "src/repro_torch/csrc/segment_sum.cu",
               "replaces": "src/repro/kernels/segment/kernel.py:50",
               "role": role, "launches": launches,
               "form": "gather" if rows is not None else "contiguous",
               "max_abs_err": float((a - p).abs().max()),
               "ms": timer(lambda: segment_sum_kernel(
                   data, seg, n_seg, w_sorted, rows), 10),
               "plain_ms": timer(lambda: segment_sum_ref(
                   data, seg, n_seg, w_sorted, rows), 3),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
               "shape": [n_e, dd, n_seg]}
        del a, a2, p
        return row

    rows = []
    he = torch.randn((e, d), generator=gen, device=dev)
    rows.append(k5_row(
        "segment_sum_mgn_agg", "MeshGraphNet's aggregation "
        "(src/repro/models/gnn.py:100)", he, fwd["dst"], fwd["agg_dst"], n,
        fwd["edge_mask"], fwd["dst_order"],
        runs("meshgraphnet", mgn_layers, mgn_layers)))
    del he
    upd = torch.randn((e, 3), generator=gen, device=dev)
    rows.append(k5_row(
        "segment_sum_egnn_pos", "EGNN's position update "
        "(src/repro/models/gnn.py:301)", upd, fwd["dst"], fwd["agg_dst"], n,
        None, fwd["dst_order"], runs("egnn", egnn_layers, egnn_layers)))
    del upd
    inter = torch.randn((n_t, d), generator=gen, device=dev)
    rows.append(k5_row(
        "segment_sum_dimenet_trip", "DimeNet's triplet aggregation "
        "(src/repro/models/gnn.py:377)", inter, fwd["trip_e"],
        fwd["trip_e"], e, fwd["trip_mask"], None,
        runs("dimenet", dn_layers, dn_layers)))
    del inter

    # the gathers' gradient at d 128: DimeNet's m[trip_f], T rows into E
    g = torch.randn((n_t, d), generator=gen, device=dev)
    order = fwd["trip_f_order"]
    seg = fwd["trip_f"].index_select(0, order)
    a, a2 = (embedding_bwd_kernel(g, seg, order, e) for _ in range(2))
    p = embedding_bwd_ref(g, seg, order, e)
    err, same = rel_l1(a, p), torch.equal(a, a2)
    print(f"embedding_bwd as m[trip_f]'s gradient ({tuple(g.shape)} into "
          f"{e}): rel L1 {err:.3e}, bit-identical relaunch {same}")
    if not (err <= REL_L1 and same):
        fail("the gathers' gradient against its plain version")
    b_ms, b_by = bound_ms(g.numel() * 4 + n_t * 4 + n_t * 8 + e * d * 4,
                          float(g.numel()))
    lib = None
    if on_card:
        idx = fwd["trip_f"].long()
        lib = timer(lambda: torch.zeros((e, d), device=dev)
                    .index_add_(0, idx, g), 5)
        del idx
    mol_l = {a_: cfg_for[a_](GNN_TRAIN_SHAPE).n_layers for a_ in GNN_ARCHS}
    # the counted runs' launches at d 128 (MeshGraphNet's and DimeNet's;
    # EGNN's are at d 64 and 3)
    d128 = (gnn_launches("meshgraphnet", mol_l["meshgraphnet"], True,
                         True)[0]["embedding_gather_bwd"]
            * counted["meshgraphnet"][1]
            + gnn_launches("dimenet", mol_l["dimenet"], True,
                           True)[0]["embedding_gather_bwd"]
            * counted["dimenet"][1])
    every = sum(gnn_launches(a_, mol_l[a_], True, True)[0][
        "embedding_gather_bwd"] * counted[a_][1] for a_ in GNN_ARCHS)
    rows.append({
        "name": "embedding_gather_bwd_d128", "route": "cuda",
        "source": "src/repro_torch/csrc/embedding_bwd.cu",
        "replaces": "src/repro/models/gnn.py:372",
        "role": "the gathers' gradient (XLA's gradient of m[trip_f])",
        "launches": d128, "all_launches": every,
        "max_abs_err": float((a - p).abs().max()),
        "ms": timer(lambda: embedding_bwd_kernel(g, seg, order, e), 10),
        "plain_ms": timer(lambda: embedding_bwd_ref(g, seg, order, e), 3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
        "shape": [n_t, d, e]})
    del g, a, a2, p, fwd
    return rows, "; ".join(summary)


def depth_phase(torch, timer, cases, on_card):
    """Phase 18 (a): every case at each of ``SWEEP_DEPTHS`` against its
    plain version, depth 1's bits and the simt body's.  ``cases``: {label:
    (kernel, operands, plain outputs)} with ``kernel`` ``"k1"`` or
    ``"k2"``.  Returns {(label, depth): max abs error of the first
    output}; fails on a mismatch."""
    from repro_torch.kernels.diffusion import (
        bulk_ctas_per_sm, frontier_round_bsr_kernel, bsr_spmm_kernel,
        launch_bsr_spmm, launch_frontier_round_bsr)
    from repro_torch.kernels.tune import model

    def launch(kernel, ins, depth, route=None):
        if kernel == "k1":
            if not on_card:
                return frontier_round_bsr_kernel(*ins, buffer_depth=depth)
            return launch_frontier_round_bsr(*ins, route=route,
                                             buffer_depth=depth)[:2]
        if not on_card:
            return (bsr_spmm_kernel(*ins, buffer_depth=depth),)
        return (launch_bsr_spmm(*ins, route=route, buffer_depth=depth)[0],)

    errs_at = {}
    for label, (kernel, ins, plain) in cases.items():
        name = "frontier_round_bsr" if kernel == "k1" else "bsr_gather_spmm"
        bs, c = ins[4].shape[1], ins[4].shape[2]  # f or x: [rows, bs, C]
        base = launch(kernel, ins, 1)
        simt = launch(kernel, ins, 1, "simt") if on_card else base
        for depth in SWEEP_DEPTHS:
            got = launch(kernel, ins, depth)
            errs = [rel_l1(a, b) for a, b in zip(got, plain)]
            same = all(torch.equal(a, b) for a, b in zip(got, base))
            same_simt = all(torch.equal(a, b) for a, b in zip(got, simt))
            ctas = bulk_ctas_per_sm(name, bs, c, depth) if on_card else None
            want = model.ctas_per_sm(name, bs, c, depth)
            print(f"{label} depth {depth} ({model.ring_stages(depth)} "
                  f"stages, {model.smem_bytes(name, bs, c, depth)} bytes "
                  f"of shared memory, {ctas} CTA(s)/SM, model {want}): rel "
                  "L1 " + ", ".join(f"{e:.3e}" for e in errs) + ", depth 1's"
                  f" bits {same}, the simt body's bits {same_simt}")
            if not (max(errs) <= REL_L1 and same and same_simt):
                fail(f"{label} at buffer_depth {depth}")
            if on_card and ctas != want:
                fail(f"{label} at buffer_depth {depth}: {ctas} CTAs an SM, "
                     f"the model counts {want}")
            errs_at[label, depth] = float((got[0] - plain[0]).abs().max())
            del got
    return errs_at


def tuner_phase(args, torch, dev, problem, x_ss, phase4, smi):
    """Phase 18 (b) and (c): the sweep into a temporary tune directory,
    the records in use, and K1's and K2's solves at each depth named
    explicitly.  ``phase4``: phase 4's ``frontier:pallas`` solve (x,
    rounds, pushes, wall).  Returns ``({(kernel, depth): launches of the
    explicit-depth solves}, the sweeps' records, a summary line)``."""
    x_pallas, pallas_rounds, pallas_ops, pallas_wall = phase4
    import shutil
    import tempfile

    import repro_torch
    from repro_torch.api.options import SolverOptions
    from repro_torch.api.registry import _auto_select
    from repro_torch.core import host_block_graph
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels import tune
    from repro_torch.kernels.diffusion import DEPTHS, FRONTIER_DEPTHS
    from repro_torch.kernels.tune import model

    on_card = dev.type == "cuda"
    platform = dev.type
    tune_dir = tempfile.mkdtemp(prefix="tuned_torch_")
    old_env = os.environ.get(tune.records.ENV_VAR)
    os.environ[tune.records.ENV_VAR] = tune_dir
    tune.clear_cache()
    launches = {}
    try:
        print(f"(b) sweep at N={args.sweep_n}, bs {SWEEP_BS}, depths "
              f"{SWEEP_DEPTHS}, density {SWEEP_DENSITY}, {SWEEP_ITERS} "
              f"launches a config, into {tune_dir}; {smi}")
        recs = {}
        t0 = time.perf_counter()
        for kernel in tune.KERNELS:
            t1 = time.perf_counter()
            rec = tune.run_sweep(kernel, n=args.sweep_n, bs_list=SWEEP_BS,
                                 depths=SWEEP_DEPTHS, density=SWEEP_DENSITY,
                                 iters=SWEEP_ITERS, seed=args.seed,
                                 device=args.device)
            recs[kernel] = rec
            for r in rec["sweep"]:
                if (r["measured_us"] is None) == r["feasible"]:
                    fail(f"sweep {kernel} bs={r['bs']} depth "
                         f"{r['buffer_depth']}: feasible {r['feasible']} "
                         f"but measured {r['measured_us']}")
                if r["feasible"] and r["route"] == "bulk" and on_card and (
                        r["ctas_per_sm"] != model.ctas_per_sm(
                            kernel, r["bs"], 1, r["buffer_depth"])):
                    fail(f"sweep {kernel}: CTAs an SM off the model")
            print(f"sweep {kernel}: {len(rec['sweep'])} rows, "
                  f"{sum(r['feasible'] for r in rec['sweep'])} feasible, "
                  f"winner {rec['best']} ({time.perf_counter() - t1:.1f} s)"
                  f" on {smi}")
        sweep_s = time.perf_counter() - t0

        print("(c) the records in use")
        k1, k2 = (tune.best_config(k, platform) for k in tune.KERNELS)
        res1 = tune.resolved_config("frontier_round_bsr", platform=platform)
        res2 = tune.resolved_config("bsr_gather_spmm", platform=platform)
        print(f"resolved_config: frontier_round_bsr {res1}, bsr_gather_spmm "
              f"{res2}")
        if (res1[:2] != (k1.bs, k1.buffer_depth)
                or res2[1] != k2.buffer_depth):
            fail("resolved_config does not give the records' winners")
        depths0 = dict(FRONTIER_DEPTHS)
        reset_launches()
        session = repro_torch.SolverSession(problem, "frontier:pallas",
                                            device=args.device)
        drv = session._driver
        rep = session.solve()
        k1_depth = {d: FRONTIER_DEPTHS.get(d, 0) - depths0.get(d, 0)
                    for d in FRONTIER_DEPTHS}
        dx = float(np.abs(rep.x - x_ss).sum())
        print(f"frontier:pallas on the K1 record: bs {drv.m.bs} depth "
              f"{drv.buffer_depth}: converged {rep.converged} rounds "
              f"{rep.n_rounds} ops {rep.n_ops} wall {rep.wall_time_s:.3f} s "
              f"(bs 128 depth 1, phase 4: {pallas_wall:.3f} s); K1 "
              f"launches {LAUNCHES['frontier_round_bsr']} by depth "
              f"{k1_depth}; |x - x_segment_sum|_1 {dx:.3e}")
        if (drv.m.bs, drv.buffer_depth) != (k1.bs, k1.buffer_depth):
            fail("frontier:pallas did not take the K1 record's config")
        if not rep.converged or dx > 1e-5:
            fail("frontier:pallas on the K1 record")
        if on_card and k1_depth.get(k1.buffer_depth) != rep.n_rounds:
            fail("K1 not launched once a round at the record's depth")
        del session, drv
        g_e = host_block_graph(min(2**16, args.n), seed=args.seed)
        p_e = repro_torch.Problem.pagerank(g_e)
        depths0 = dict(DEPTHS)
        reset_launches()
        s_e = repro_torch.SolverSession(p_e, "engine:bsr",
                                        device=args.device, **ENGINE_OPTS)
        e_depth = s_e._driver.cfg.pallas_buffer_depth
        rep_e = s_e.solve()
        k2_depth = {d: DEPTHS.get(d, 0) - depths0.get(d, 0) for d in DEPTHS}
        print(f"engine:bsr on the K2 record (N={g_e.n}, k=4): "
              f"pallas_buffer_depth {e_depth} (record {k2.buffer_depth}); "
              f"converged {rep_e.converged} rounds {rep_e.n_rounds} wall "
              f"{rep_e.wall_time_s:.3f} s; K2 launches "
              f"{LAUNCHES['bsr_spmm']} by depth {k2_depth}")
        if e_depth != k2.buffer_depth or not rep_e.converged:
            fail("engine:bsr on the K2 record")
        if on_card and k2_depth.get(e_depth) != rep_e.n_rounds:
            fail("K2 not launched once a round at the record's depth")
        x_e = rep_e.x
        del s_e
        picked = _auto_select(problem, SolverOptions(device=args.device))
    finally:
        if old_env is None:
            os.environ.pop(tune.records.ENV_VAR, None)
        else:
            os.environ[tune.records.ENV_VAR] = old_env
        tune.clear_cache()
        shutil.rmtree(tune_dir, ignore_errors=True)
    unpicked = _auto_select(problem, SolverOptions(device=args.device))
    print(f"_auto_select for phase 4's problem: {picked} with the records, "
          f"{unpicked} without; {tune_dir} removed "
          f"({not os.path.exists(tune_dir)})")
    if os.path.exists(tune_dir):
        fail("the temporary tune directory is still there")
    # each depth named in the options, no record: phase 4's solve (bs 128)
    # and the engine's above, launch by launch the same bits
    for d in SWEEP_DEPTHS[1:]:
        depths0, e_depths0 = dict(FRONTIER_DEPTHS), dict(DEPTHS)
        rep_d = repro_torch.solve(problem, method="frontier:pallas",
                                  device=args.device, buffer_depth=d)
        launches["frontier_round_bsr", d] = (FRONTIER_DEPTHS.get(d, 0)
                                             - depths0.get(d, 0))
        same = bool(np.array_equal(rep_d.x, x_pallas))
        print(f"frontier:pallas at buffer_depth={d}: rounds {rep_d.n_rounds}"
              f" pushes {rep_d.n_ops} (phase 4, depth 1: {pallas_rounds} / "
              f"{pallas_ops}), x bit-equal to phase 4's {same}, wall "
              f"{rep_d.wall_time_s:.3f} s ({pallas_wall:.3f}); K1 launches "
              f"at depth {d}: {launches['frontier_round_bsr', d]}")
        if (not same or (rep_d.n_rounds, rep_d.n_ops)
                != (pallas_rounds, pallas_ops)):
            fail(f"frontier:pallas at buffer_depth={d} moved")
        if on_card and launches["frontier_round_bsr", d] != rep_d.n_rounds:
            fail(f"K1 not launched once a round at depth {d}")
        s_d = repro_torch.SolverSession(p_e, "engine:bsr",
                                        device=args.device, buffer_depth=d,
                                        **ENGINE_OPTS)
        rep_d = s_d.solve()
        launches["bsr_spmm", d] = DEPTHS.get(d, 0) - e_depths0.get(d, 0)
        same = bool(np.array_equal(rep_d.x, x_e))
        print(f"engine:bsr at buffer_depth={d} (pallas_buffer_depth "
              f"{s_d._driver.cfg.pallas_buffer_depth}): rounds "
              f"{rep_d.n_rounds} (depth 1: {rep_e.n_rounds}), x bit-equal "
              f"to depth 1's {same}; K2 launches at depth {d}: "
              f"{launches['bsr_spmm', d]}")
        if not same or rep_d.n_rounds != rep_e.n_rounds:
            fail(f"engine:bsr at buffer_depth={d} moved")
        if on_card and launches["bsr_spmm", d] != rep_d.n_rounds:
            fail(f"K2 not launched once a round at depth {d}")
        del s_d
    summary = (f"tuner: sweep {sweep_s:.1f} s; K1 record bs {k1.bs} depth "
               f"{k1.buffer_depth} ({k1.measured_us} us), K2 record bs "
               f"{k2.bs} depth {k2.buffer_depth} ({k2.measured_us} us); "
               f"frontier:pallas on it {rep.wall_time_s:.3f} s against "
               f"{pallas_wall:.3f} s at bs 128 depth 1; auto {picked} / "
               f"{unpicked}")
    return launches, recs, summary


def examples_phase(args, torch, dev):
    """Phase 18 (d): the five examples at their defaults (on the CPU, in a
    rehearsal, at small sizes).  Returns a summary line."""
    import shutil
    import tempfile

    from repro_torch.examples import (
        gnn_partition, quickstart, serve_lm, solve_web, train_lm)

    on_card = dev.type == "cuda"
    d = ["--device", args.device]
    small = {"quickstart": ["--n", "500"], "solve_web": ["--n", "2000"],
             "serve_lm": ["--batch", "2", "--gen", "4"],
             "train_lm": ["--steps", "4", "--width", "64", "--layers", "1"]}
    ckpt = tempfile.mkdtemp(prefix="train_lm_")
    walls = {}
    try:
        for name, mod in (("quickstart", quickstart),
                          ("solve_web", solve_web),
                          ("gnn_partition", gnn_partition),
                          ("serve_lm", serve_lm), ("train_lm", train_lm)):
            argv = d + ([] if on_card else small.get(name, []))
            if name == "train_lm":
                argv += ["--ckpt", ckpt]
            print(f"-- python -m repro_torch.examples.{name} "
                  + " ".join(argv))
            t0 = time.perf_counter()
            out = mod.main(argv)
            if on_card:
                torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            if name == "quickstart":
                ok = (out["sequential"]["converged"]
                      and out["simulator"]["converged"]
                      and out["engine"]["converged"]
                      and out["simulator"]["max_abs_dx"] < 1e-3
                      and out["engine"]["max_abs_dx"] < 1e-3)
            elif name == "solve_web":
                ok = all(out[k]["converged"]
                         for k in ("base", "static", "dynamic"))
            elif name == "gnn_partition":
                ok = (np.isfinite(out["losses"]).all()
                      and out["losses"][-1] < out["losses"][0]
                      and out["final_imbalance"] < out["imbalance"][0])
            elif name == "serve_lm":
                tok = out["tokens"]
                ok = (tok.shape[1] >= 2 and tok.min() >= 0
                      and tok.max() < out["vocab"])
            else:
                ok = (len(out["losses"]) > 0
                      and np.isfinite(out["losses"]).all()
                      and out["losses"][-1] < out["losses"][0])
            print(f"example {name}: checks {ok}, wall {walls[name]:.1f} s")
            if not ok:
                fail(f"example {name}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return "examples: " + ", ".join(f"{k} {v:.1f} s"
                                    for k, v in walls.items())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2**21,
                    help="nodes of the host_block_graph (default 2**21)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fm-vocab", type=int, default=1_000_000,
                    help="FM rows per field (default 10**6, the fm config)")
    ap.add_argument("--gin-nodes", type=int, default=None,
                    help="nodes of the GIN graph (default: the ogb_products "
                    "cell's 2,449,029, padded to the cell's N and E)")
    ap.add_argument("--gnn-nodes", type=int, default=None,
                    help="nodes of phase 10 (c)'s forward graph (default: "
                    "the minibatch_lg cell's 169,984, padded to its N, E "
                    "and T)")
    ap.add_argument("--sweep-n", type=int, default=None,
                    help="nodes of phase 18's sweep graph (default "
                    "2**19, at most --n)")
    ap.add_argument("--lm-reduced", action="store_true",
                    help="phase 12 on the reduced LM config (2 layers, "
                    "float32) with 64- and 512-token prompts")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for a rehearsal of the "
                    "control flow on the plain versions, which prints no "
                    "result")
    args = ap.parse_args()
    args.sweep_n = min(args.sweep_n or SWEEP_N, args.n)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    import repro_torch
    from repro_torch.core import host_block_graph
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels import _build
    from repro_torch.kernels.diffusion import (
        FRONTIER_ROUTES, ROUTES as K2_ROUTES, BsrMatrix, bsr_spmm,
        bsr_spmm_kernel, bsr_spmm_plain, bsr_spmm_route, frontier_round_bsr,
        frontier_round_bsr_kernel, frontier_round_bsr_plain,
        launch_bsr_spmm, launch_frontier_round_bsr)
    from repro_torch.kernels.edge_sum import (
        csc_edges, edge_sum, edge_sum_plain)
    from repro_torch.balance import MovePlan
    from repro_torch.core import pagerank_system, power_law_graph
    from repro_torch.kernels.diffusion import engine_tile_push
    from repro_torch.configs import fm as fm_config
    from repro_torch.configs import gin_tu
    from repro_torch.configs.gnn_common import SHAPE_DIMS
    from repro_torch.data import criteo_like_batch
    from repro_torch.kernels.fm import fm_interaction_kernel, fm_interaction_ref
    from repro_torch.kernels.segment import (
        CHUNK_ROWS, FORMS, segment_sum_ref, segment_sum_sorted)
    from repro_torch.launch.steps import build_cell_step
    from repro_torch.models import gnn, recsys

    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    timer = Timer(torch, dev)
    rng = np.random.default_rng(args.seed)
    t_start = time.perf_counter()

    # ---- 1. device ---------------------------------------------------------
    print("== phase 1: device")
    if on_card:
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        smi = nvidia_smi()
    else:
        kind, count, smi = "cpu (rehearsal)", 0, "cpu (rehearsal), n/a"
    print(f"device: {kind} x{count}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(f"nvidia-smi: {smi}")

    # ---- 2. build ----------------------------------------------------------
    print("== phase 2: build")
    if on_card:
        t0 = time.perf_counter()
        libs = _build.build_all()
        for name in libs:
            _build.library(name)
        print(f"built and loaded {sorted(libs)} in "
              f"{time.perf_counter() - t0:.3f} s")
    else:
        print("rehearsal: no build")

    # the GIN graph of phase 10 is built on a host thread meanwhile (numpy
    # leaves the interpreter lock in its sorts and draws)
    gin_host_pool = concurrent.futures.ThreadPoolExecutor(1)
    gin_host = gin_host_pool.submit(gin_host_batch, args)
    gnn_host = gin_host_pool.submit(gnn_archs_host_batch, args)

    # ---- 3. kernels against their plain versions ---------------------------
    print("== phase 3: kernels")
    t0 = time.perf_counter()
    g = host_block_graph(args.n, seed=args.seed)
    problem = repro_torch.Problem.pagerank(g)
    tiles = problem.graph.bsr(BS)
    print(f"graph: N={g.n} links={g.n_edges} tiles={tiles.n_blocks} "
          f"({tiles.n_blocks * BS * BS * 4 / 1e9:.3f} GB) block rows="
          f"{tiles.n_row_blocks}; host build {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    m = tiles.to_device(dev)
    if on_card:
        torch.cuda.synchronize()
    print(f"tile pool uploaded in {time.perf_counter() - t0:.1f} s")
    n_pad = m.n_row_blocks * BS
    w_nodes = problem.node_weights()
    w = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    w[: g.n] = torch.as_tensor(w_nodes, dtype=torch.float32, device=dev)

    def fluid(c: int) -> torch.Tensor:
        return random_fluid(torch, rng, g.n, n_pad, c, dev)

    def simt_bits(ins, out, l1):
        """K1's bulk output against its simt body's, launched apart (counted
        nowhere): the same bits.  True in a rehearsal."""
        if not on_card:
            return True
        out_s, l1_s, _ = launch_frontier_round_bsr(*ins, route="simt")
        return torch.equal(out, out_s) and torch.equal(l1, l1_s)

    # the same tiles on the CPU, for the cross-device predicate check
    m_cpu = BsrMatrix(tiles.blocks, tiles.block_row, tiles.block_col,
                      tiles.n_row_blocks, BS, device="cpu")
    timing_inputs = {}
    for c in (1, 8):
        for tau in (0.0, 0.5):
            f = fluid(c)
            t = median_threshold(torch, f, w)
            f_new, sent, res = frontier_round_bsr(
                m, f, w, t, backend="kernel", occupancy_threshold=tau)
            # the same round through the CPU's plain path: the predicate
            # (and with it sent) must agree exactly across devices
            if on_card and c == 1:
                _, sent_cpu, _ = frontier_round_bsr(
                    m_cpu, f.cpu(), w.cpu(), t.cpu(), backend="kernel",
                    occupancy_threshold=tau)
                if not torch.equal(sent.cpu(), sent_cpu):
                    fail(f"K1 sent differs card vs cpu (C={c}, tau={tau})")
            ins = k1_operands(torch, m, f, w, t, tau)
            out_k, l1_k = frontier_round_bsr_kernel(*ins)
            out_k2, l1_k2 = frontier_round_bsr_kernel(*ins)
            out_p, l1_p = frontier_round_bsr_plain(*ins)
            armed = int(ins[3].sum())
            e_f, e_l1 = rel_l1(out_k, out_p), rel_l1(l1_k, l1_p)
            same = torch.equal(out_k, out_k2) and torch.equal(l1_k, l1_k2)
            simt = simt_bits(ins, out_k, l1_k)
            print(f"K1 C={c} tau={tau}: armed columns {armed}/"
                  f"{m.n_row_blocks}, sent nodes {int((sent != 0).sum())}, "
                  f"rel L1 f_new {e_f:.3e} row_l1 {e_l1:.3e}, "
                  f"bit-identical relaunch {same}, route "
                  f"{launch_frontier_round_bsr(*ins)[2] if on_card else None}"
                  f", the simt body's bits {simt}")
            if not (e_f <= REL_L1 and e_l1 <= REL_L1 and same and simt):
                fail(f"K1 C={c} tau={tau}")
            if not torch.equal(f_new.reshape(out_k.shape), out_k):
                fail("K1 through ops.frontier_round_bsr differs from the "
                     "direct launch")
            if c == 1 and tau == 0.0:
                timing_inputs["k1"] = (ins, float((out_k - out_p).abs()
                                                  .max()))
    del m_cpu
    # the same pool with every other block row emptied
    keep = tiles.block_row % 2 == 0
    m_odd = BsrMatrix(tiles.blocks[keep], tiles.block_row[keep],
                      tiles.block_col[keep], tiles.n_row_blocks, BS,
                      device=dev)
    f = fluid(1)
    t = median_threshold(torch, f, w)
    ins = k1_operands(torch, m_odd, f, w, t, 0.0)
    out_k, l1_k = frontier_round_bsr_kernel(*ins)
    out_p, l1_p = frontier_round_bsr_plain(*ins)
    empty = ~m_odd.row_occupied
    kept = torch.where(f.abs() * (w / t)[:, None] > 1.0,
                       torch.zeros_like(f), f).reshape(out_k.shape)
    ok_empty = torch.equal(out_k[empty], kept[empty])
    e_f = rel_l1(out_k, out_p)
    simt = simt_bits(ins, out_k, l1_k)
    print(f"K1 interleaved empty rows: {int(empty.sum())} empty, kept "
          f"fluid exact {ok_empty}, rel L1 {e_f:.3e}, the simt body's bits "
          f"{simt}")
    if not (ok_empty and e_f <= REL_L1 and simt):
        fail("K1 interleaved empty rows")
    # input (b): a late round of the cold solve
    t0 = time.perf_counter()
    ins, late_rounds = late_round(torch, repro_torch, problem, args.device)
    out_k, l1_k = frontier_round_bsr_kernel(*ins)
    out_p, l1_p = frontier_round_bsr_plain(*ins)
    e_f, e_l1 = rel_l1(out_k, out_p), rel_l1(l1_k, l1_p)
    simt = simt_bits(ins, out_k, l1_k)
    n_tiles = ins[1].numel()
    print(f"K1 late round (input b: after {late_rounds} rounds of "
          f"frontier:pallas, {time.perf_counter() - t0:.1f} s): armed "
          f"columns {int(ins[3].sum())}/{m.n_row_blocks}, armed tiles "
          f"{armed_tiles(ins[3], ins[1])}/{n_tiles}, rel L1 f_new {e_f:.3e} "
          f"row_l1 {e_l1:.3e}, the simt body's bits {simt}")
    if not (e_f <= REL_L1 and e_l1 <= REL_L1 and simt):
        fail("K1 late round")
    timing_inputs["k1_late"] = (ins, float((out_k - out_p).abs().max()))
    for c in (1, 8):
        x = fluid(c).reshape(-1, BS, c)
        for name, mat in (("full", m), ("empty rows", m_odd)):
            a = bsr_spmm_kernel(mat.blocks, mat.visit_block, mat.block_col,
                                mat.row_ptr, x)
            a2 = bsr_spmm_kernel(mat.blocks, mat.visit_block, mat.block_col,
                                 mat.row_ptr, x)
            p = bsr_spmm_plain(mat.blocks, mat.visit_block, mat.block_col,
                               mat.row_ptr, x)
            e = rel_l1(a, p)
            zero = bool((a[~mat.row_occupied] == 0).all())
            same = torch.equal(a, a2)
            # the simt body, launched apart (counted nowhere): the same bits
            simt = (torch.equal(a, launch_bsr_spmm(
                mat.blocks, mat.visit_block, mat.block_col, mat.row_ptr, x,
                route="simt")[0]) if on_card else True)
            print(f"K2 C={c} {name}: rel L1 {e:.3e}, empty rows exactly 0 "
                  f"{zero}, bit-identical relaunch {same}, route "
                  f"{bsr_spmm_route(BS, c)}, the simt body's bits {simt}")
            if not (e <= REL_L1 and zero and same and simt):
                fail(f"K2 C={c} {name}")
            if c == 1 and name == "full":
                timing_inputs["k2"] = (
                    (mat.blocks, mat.visit_block, mat.block_col, mat.row_ptr,
                     x), float((a - p).abs().max()))
    del m_odd
    src, dst, wgt = problem.p.edge_list()
    edges = csc_edges(src, dst, wgt, g.n, dev)
    x = fluid(1)[: g.n, 0].contiguous()
    a, a2 = edge_sum(x, edges), edge_sum(x, edges)
    p = edge_sum_plain(x, edges.indptr, edges.src, edges.wgt)
    e = rel_l1(a, p)
    same = torch.equal(a, a2)
    print(f"K3: {edges.n_edges} edges, rel L1 {e:.3e}, bit-identical "
          f"relaunch {same}")
    if not (e <= REL_L1 and same):
        fail("K3")
    timing_inputs["k3"] = ((x, edges), float((a - p).abs().max()))
    print("kernels agree with their plain versions: frontier_round_bsr, "
          "bsr_spmm, edge_sum")

    def recorded(name, rep):
        """Prints a solve's rounds and pushes beside the recorded ones; at
        the default N and seed they must agree."""
        want = RECORDED[name]
        print(f"{name}: rounds {rep.n_rounds} pushes {rep.n_ops} (recorded "
              f"at N=2**21, seed 0: rounds {want[0]} pushes {want[1]})")
        if (args.n == 2**21 and args.seed == 0
                and (rep.n_rounds, rep.n_ops) != want):
            fail(f"{name} moved from its recorded rounds and pushes")

    # ---- 4. main path ------------------------------------------------------
    print("== phase 4: main path")
    k2_routes0 = dict(K2_ROUTES)  # K2's launches by body, phases 4-7
    k1_routes0 = dict(FRONTIER_ROUTES)  # K1's, phases 4-5
    reset_launches()
    rep = repro_torch.solve(problem, method="frontier:pallas",
                            device=args.device)
    k1_solve = LAUNCHES["frontier_round_bsr"]
    main_launches = dict(LAUNCHES)
    print(f"frontier:pallas: converged {rep.converged} residual "
          f"{rep.residual:.6e} rounds {rep.n_rounds} ops {rep.n_ops} "
          f"cost {rep.cost_iterations:.4f} wall {rep.wall_time_s:.3f} s; "
          f"K1 launches {k1_solve}")
    if not rep.converged:
        fail("frontier:pallas did not converge")
    if on_card and k1_solve != rep.n_rounds:
        fail(f"K1 launched {k1_solve} times in {rep.n_rounds} rounds")
    recorded("frontier:pallas", rep)
    x_pallas, pallas_rounds = rep.x, rep.n_rounds
    pallas_ops, pallas_wall = rep.n_ops, rep.wall_time_s
    reset_launches()
    rep_ss = repro_torch.solve(problem, method="frontier:segment_sum",
                               device=args.device)
    for k, v in LAUNCHES.items():
        main_launches[k] += v
    dx = float(np.abs(rep.x - rep_ss.x).sum())
    print(f"frontier:segment_sum: converged {rep_ss.converged} residual "
          f"{rep_ss.residual:.6e} rounds {rep_ss.n_rounds} ops "
          f"{rep_ss.n_ops} wall {rep_ss.wall_time_s:.3f} s; K3 launches "
          f"{LAUNCHES['edge_sum']}; |x_pallas - x_segment_sum|_1 {dx:.3e}")
    if not rep_ss.converged or dx > 1e-5:
        fail("frontier:segment_sum cross-path check")
    if on_card and LAUNCHES["edge_sum"] != rep_ss.n_rounds:
        fail("K3 not launched once per segment_sum round")

    # ---- 5. a few requests -------------------------------------------------
    print("== phase 5: requests")
    reset_launches()
    session = repro_torch.SolverSession(problem, "frontier:pallas",
                                        device=args.device)
    cold = session.solve()
    for k, v in LAUNCHES.items():
        main_launches[k] += v
    # the invariant check is not part of the main path: its K2 launch is
    # counted apart, and the counts are zeroed again before the requests
    reset_launches()
    f_nodes, h_nodes = session._driver.fluid()
    b = problem.b
    viol, bound = invariant(b, f_nodes, h_nodes, src, dst, wgt)
    h_dev = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    h_dev[: g.n] = torch.as_tensor(h_nodes, dtype=torch.float32, device=dev)
    ph_dev = bsr_spmm(m, h_dev)[: g.n]
    viol_dev = float((torch.as_tensor(b, dtype=torch.float32, device=dev)
                      - h_dev[: g.n] + ph_dev
                      - torch.as_tensor(f_nodes, dtype=torch.float32,
                                        device=dev)).abs().sum())
    print(f"cold: converged {cold.converged} rounds {cold.n_rounds} ops "
          f"{cold.n_ops} wall {cold.wall_time_s:.3f} s; invariant "
          f"|B-(I-P)H-F|_1 = {viol:.3e} (float64 host), {viol_dev:.3e} "
          f"(float32 card via bsr_spmm), bound {bound:.3e}")
    if not cold.converged or viol > bound or viol_dev > bound:
        fail("cold session solve / invariant")
    check_launches = LAUNCHES["bsr_spmm"]
    if on_card and check_launches != 1:
        fail(f"the invariant check launched K2 {check_launches} times")
    reset_launches()
    warm_ops = []
    for i in range(4):
        b_new = np.abs(b * (1.0 + 0.05 * rng.standard_normal(g.n)))
        resid0 = session.warm_start(b_new)
        warm = session.solve()
        warm_ops.append(warm.n_ops)
        print(f"request {i}: |F'|_1 {resid0:.6e} converged {warm.converged} "
              f"rounds {warm.n_rounds} ops {warm.n_ops} wall "
              f"{warm.wall_time_s:.3f} s")
        if not warm.converged:
            fail(f"request {i} did not converge")
    if not warm_ops[0] < cold.n_ops:
        fail(f"first warm solve used {warm_ops[0]} ops, cold {cold.n_ops}")
    for k, v in LAUNCHES.items():
        main_launches[k] += v
    k1_routes = {k: v - k1_routes0[k] for k, v in FRONTIER_ROUTES.items()}
    print(f"main path launches (phases 4-5): {json.dumps(main_launches)}; "
          f"K2 launches of the invariant check {check_launches}; K1's by "
          f"body {json.dumps(k1_routes)}")
    if on_card and k1_routes != {
            "bulk": main_launches["frontier_round_bsr"], "simt": 0}:
        fail(f"K1 launches of phases 4-5 not all on the bulk body: "
             f"{k1_routes}")
    if on_card:
        missing = [k for k in ON_PATH if main_launches[k] == 0]
        if missing:
            fail(f"kernels never launched on the main path: {missing}")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # ---- 6. engine kernels at the engine's shapes --------------------------
    print("== phase 6: engine kernels")
    t0 = time.perf_counter()
    s_bsr = repro_torch.SolverSession(problem, "engine:bsr",
                                      device=args.device, **ENGINE_OPTS)
    sync()
    build_bsr_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    s_chk = repro_torch.SolverSession(problem, "engine:chunk",
                                      device=args.device, **ENGINE_OPTS)
    sync()
    build_chk_s = time.perf_counter() - t0
    eng, visits = s_bsr._driver.engine, s_bsr._driver.ex.table
    ecfg, ea = eng.cfg, eng.a
    k_e, r_e, s_e = ecfg.k, ea.n_rows, ea.bucket_size
    pool_tiles = eng.pool.shape[0]
    print(f"engine:bsr layout: k={k_e} R={r_e} rows (B_loc="
          f"{ecfg.buckets_per_dev}, headroom {ecfg.headroom}) S={s_e} "
          f"T={ea.tile_dst.shape[1]}; tile pool {pool_tiles} real tiles "
          f"({pool_tiles * s_e * s_e * 4 / 1e9:.3f} GB), visits "
          f"{visits.n_visits} = sum t_counts {int(ea.t_counts.sum())}; "
          f"build wall {build_bsr_s:.3f} s")
    edges_e = s_chk._driver.ex.table
    ca = s_chk._driver.engine.a
    print(f"engine:chunk layout: R={ca.n_rows} S={ca.bucket_size} "
          f"E={ca.edge_cap}: {ca.n_rows * ca.edge_cap} edge slots, "
          f"{edges_e.n_edges} real edges (links {g.n_edges}); build wall "
          f"{build_chk_s:.3f} s")
    if not (visits.n_visits == pool_tiles == int(ea.t_counts.sum())
            and edges_e.n_edges == g.n_edges):
        fail("the engine tables do not hold exactly the real tiles/edges")
    sent_e = torch.as_tensor(
        rng.standard_normal((r_e, s_e)) / g.n * (ea.w != 0),
        dtype=torch.float32, device=dev)
    x3_e = sent_e[:, :, None].contiguous()

    def k2_engine_plain(chunk: int = 1024):
        """K2's plain twin over visit chunks (the whole table would gather
        a copy of every visited tile at once)."""
        out = torch.zeros((k_e * r_e, s_e, 1), dtype=torch.float32,
                          device=dev)
        v = visits.n_visits
        for lo in range(0, v, chunk):
            hi = min(lo + chunk, v)
            ptr = visits.row_ptr.clamp(lo, hi) - lo
            out += bsr_spmm_plain(eng.pool, visits.visit_block[lo:hi],
                                  visits.visit_col[lo:hi], ptr, x3_e)
        return out[..., 0]

    a2 = engine_tile_push(eng.pool, visits, sent_e)
    a2b = engine_tile_push(eng.pool, visits, sent_e)
    p2 = k2_engine_plain()
    e2, same2 = rel_l1(a2, p2), torch.equal(a2, a2b)
    # the simt body over the same visits (launched apart, counted nowhere)
    simt2 = (torch.equal(a2, launch_bsr_spmm(
        eng.pool, visits.visit_block, visits.visit_col, visits.row_ptr,
        x3_e, route="simt")[0][..., 0]) if on_card else True)
    print(f"K2 engine visit table: {visits.n_visits} visits into "
          f"{k_e * r_e} output rows, rel L1 {e2:.3e}, bit-identical "
          f"relaunch {same2}, route {bsr_spmm_route(s_e, 1)}, the simt "
          f"body's bits {simt2}")
    if not (e2 <= REL_L1 and same2 and simt2):
        fail("K2 over the engine visit table")
    # the engine:chunk layout has its own sizing (buckets_per_dev)
    xe = torch.as_tensor(
        (rng.standard_normal((ca.n_rows, ca.bucket_size)) / g.n
         * (ca.w != 0)).reshape(-1), dtype=torch.float32, device=dev)
    a3, a3b = edge_sum(xe, edges_e), edge_sum(xe, edges_e)
    p3 = edge_sum_plain(xe, edges_e.indptr, edges_e.src, edges_e.wgt)
    e3, same3 = rel_l1(a3, p3), torch.equal(a3, a3b)
    print(f"K3 engine edge table: {edges_e.n_edges} edges into "
          f"{edges_e.n} outputs, rel L1 {e3:.3e}, bit-identical relaunch "
          f"{same3}")
    if not (e3 <= REL_L1 and same3):
        fail("K3 over the engine edge table")
    timing_inputs["k2e"] = float((a2 - p2).abs().max())
    timing_inputs["k3e"] = float((a3 - p3).abs().max())
    del a2, a2b, p2, a3, a3b, p3

    # ---- 7. engine main path -----------------------------------------------
    print("== phase 7: engine main path")
    engine_launches = {k: 0 for k in LAUNCHES}

    def bank():
        for k, v in LAUNCHES.items():
            engine_launches[k] += v

    def engine_gates(name, session, rep, kernel, b_vec):
        f_e, h_e = session._driver.fluid()
        viol, bound = invariant(b_vec, f_e, h_e, src, dst, wgt)
        print(f"{name}: converged {rep.converged} residual "
              f"{rep.residual:.6e} rounds {rep.n_rounds} chunks "
              f"{rep.extras['chunks']} ops {rep.n_ops} moves "
              f"{len(rep.move_log)} wall {rep.wall_time_s:.3f} s; "
              f"{kernel} launches {LAUNCHES[kernel]}; invariant "
              f"{viol:.3e} (bound {bound:.3e})")
        if not rep.converged or viol > bound:
            fail(f"{name}: not converged or invariant broken")
        if on_card and LAUNCHES[kernel] != rep.n_rounds:
            fail(f"{name}: {kernel} launched {LAUNCHES[kernel]} times in "
                 f"{rep.n_rounds} rounds")

    reset_launches()
    rep_bsr = s_bsr.solve()
    engine_gates("engine:bsr cold", s_bsr, rep_bsr, "bsr_spmm", problem.b)
    recorded("engine:bsr cold", rep_bsr)
    bank()
    reset_launches()
    rep_chk = s_chk.solve()
    engine_gates("engine:chunk cold", s_chk, rep_chk, "edge_sum", problem.b)
    # K3 over the engine's edge table: the engine:chunk rounds only (the
    # warm request's K3 launch runs over the node-space edge list)
    k3_engine_launches = LAUNCHES["edge_sum"]
    bank()
    # two converged schedules each sit within target_error of the answer
    # in L1 (|x - x*|_1 <= |F|_1/eps), so they may differ by twice that:
    # below 1e-5 from N = 2e5 on (9.5e-7 at N = 2**21)
    dx_bound = max(1e-5, 2.0 * problem.target_error)
    for name, rep_e in (("engine:bsr", rep_bsr), ("engine:chunk", rep_chk)):
        dx = float(np.abs(rep_e.x - rep_ss.x).sum())
        print(f"{name}: |x - x_segment_sum|_1 {dx:.3e} (bound "
              f"{dx_bound:.1e}); move log {rep_e.move_log[:6]}")
        if dx > dx_bound:
            fail(f"{name} cross-path check")
    del s_chk
    reset_launches()
    s_fm = repro_torch.SolverSession(problem, "engine:bsr",
                                     device=args.device, **ENGINE_OPTS)
    list(s_fm.run(max_rounds=1))  # the first chunk
    first_rounds = s_fm.n_rounds
    moved = s_fm._driver.ex.apply(MovePlan(src=0, dst=3, units=2,
                                           kind="bucket"))
    sizes = s_fm._driver.ex.sizes().tolist()
    print(f"forced move after the first chunk ({first_rounds} rounds): "
          f"{moved} buckets 0 -> 3, real buckets per PID now {sizes}")
    if moved != 2:
        fail(f"the forced move moved {moved} buckets")
    rep_fm = s_fm.solve()
    engine_gates("engine:bsr forced move", s_fm, rep_fm, "bsr_spmm",
                 problem.b)
    recorded("engine:bsr forced move", rep_fm)
    dx = float(np.abs(rep_fm.x - rep_ss.x).sum())
    print(f"engine:bsr forced move: |x - x_segment_sum|_1 {dx:.3e}")
    if dx > dx_bound:
        fail("engine:bsr forced move cross-path check")
    bank()
    del s_fm
    if on_card:
        torch.cuda.empty_cache()
    reset_launches()
    b_new = np.abs(problem.b * (1.0 + 0.05 * rng.standard_normal(g.n)))
    resid0 = s_bsr.warm_start(b_new)
    warm_e = s_bsr.solve()
    k3_warm_launches = LAUNCHES["edge_sum"]
    print(f"engine:bsr warm request: |F'|_1 {resid0:.6e}; K3 launches "
          f"(P.H) {k3_warm_launches}")
    if on_card and k3_warm_launches != 1:
        fail(f"the engine warm seed launched K3 {k3_warm_launches} times")
    engine_gates("engine:bsr warm", s_bsr, warm_e, "bsr_spmm", b_new)
    recorded("engine:bsr warm", warm_e)
    if not warm_e.n_ops < rep_bsr.n_ops:
        fail(f"engine warm request used {warm_e.n_ops} ops, cold "
             f"{rep_bsr.n_ops}")
    bank()
    print(f"engine path launches (phase 7): {json.dumps(engine_launches)}")
    k2_routes = {k: v - k2_routes0[k] for k, v in K2_ROUTES.items()}
    print(f"K2 launches by body, phases 4-7: {k2_routes}")
    if on_card:
        missing = [k for k in ENGINE_PATH if engine_launches[k] == 0]
        if missing:
            fail(f"kernels never launched on the engine path: {missing}")
        if k2_routes["simt"] or k2_routes["bulk"] < (
                check_launches + engine_launches["bsr_spmm"]):
            fail(f"K2 launches of phases 4-7 not all on the bulk route: "
                 f"{k2_routes}")

    # ---- 8. replay: moves fire ---------------------------------------------
    print("== phase 8: replay")
    g_r = power_law_graph(1600, seed=7)
    g_r = g_r.reorder(np.argsort(-g_r.out_degree(), kind="stable"))
    p_r, b_r = pagerank_system(g_r)
    x_dense = np.linalg.solve(np.eye(g_r.n) - p_r.to_dense(), b_r)
    prob_r = repro_torch.Problem.pagerank(g_r, target_error=1e-8)
    logs = {}
    k2_routes0 = dict(K2_ROUTES)
    reset_launches()
    for method in ("engine:chunk", "engine:bsr"):
        rep_r = repro_torch.solve(prob_r, method=method, device=args.device,
                                  k=8, dynamic=True, buckets_per_dev=40,
                                  headroom=8, eta=0.9)
        err = float(np.abs(rep_r.x - x_dense).max())
        logs[method] = rep_r.move_log
        print(f"replay {method}: converged {rep_r.converged} rounds "
              f"{rep_r.n_rounds} ops {rep_r.n_ops} max |x - x_dense| "
              f"{err:.3e} moves {rep_r.move_log}")
        if not (rep_r.converged and err < 1e-5 and rep_r.move_log):
            fail(f"replay {method}")
    if logs["engine:chunk"] != logs["engine:bsr"]:
        fail("the two engine backends made different moves")
    # the replay's tiles are as wide as its buckets: K2's rule picks the
    # body (7 slots: simt, the bulk copies need bs % 4 == 0)
    k2_routes = {k: v - k2_routes0[k] for k, v in K2_ROUTES.items()}
    slots = repro_torch.SolverSession(
        prob_r, "engine:bsr", device=args.device, k=8, buckets_per_dev=40,
        headroom=8)._driver.engine.a.bucket_size
    replay_route = bsr_spmm_route(slots, 1)
    print(f"replay K2 launches by body: {k2_routes} (the rule's route for "
          f"its {slots}-slot tiles: {replay_route})")
    if on_card and k2_routes != {
            k: LAUNCHES["bsr_spmm"] if k == replay_route else 0
            for k in K2_ROUTES}:
        fail(f"replay K2 launches {LAUNCHES['bsr_spmm']} not all on "
             f"{replay_route}: {k2_routes}")

    # ---- 9. FM serving -----------------------------------------------------
    print("== phase 9: FM serving")
    spec = fm_config.spec()
    fm_cfg = dataclasses.replace(spec.model_cfg,
                                 vocab_per_field=args.fm_vocab)
    nf, dim = fm_cfg.n_fields, fm_cfg.embed_dim
    t0 = time.perf_counter()
    fm_model = recsys.FM(fm_cfg, seed=args.seed, device=dev)
    sync()
    print(f"fm: table {fm_cfg.n_rows} x {dim} "
          f"({fm_cfg.n_rows * dim * 4 / 1e9:.3f} GB f32) + lin_table, drawn "
          f"on the device in {time.perf_counter() - t0:.3f} s")
    steps = {name: build_cell_step(spec, spec.cells[name], fm_model)
             for name in ("serve_p99", "serve_bulk", "retrieval_cand")}
    t0 = time.perf_counter()
    p99 = [criteo_like_batch(i, spec.cells["serve_p99"].meta["batch"], nf,
                             args.fm_vocab, seed=args.seed) for i in range(8)]
    bulk = criteo_like_batch(8, spec.cells["serve_bulk"].meta["batch"], nf,
                             args.fm_vocab, seed=args.seed)
    n_cand = spec.cells["retrieval_cand"].meta["n_candidates"]
    query = {"user_ids": criteo_like_batch(9, 1, nf, args.fm_vocab,
                                           seed=args.seed)["ids"][0, :nf - 1],
             "cand_ids": (np.arange(n_cand) % args.fm_vocab).astype(np.int32)}
    print(f"host batches (8 x {p99[0]['ids'].shape}, "
          f"{bulk['ids'].shape}, {n_cand} candidates) made in "
          f"{time.perf_counter() - t0:.1f} s")

    def request(name, batch, n_out):
        before = LAUNCHES["fm_interaction"]
        t0 = time.perf_counter()
        out = steps[name](batch)
        sync()
        wall = time.perf_counter() - t0
        k4 = LAUNCHES["fm_interaction"] - before
        if out.shape != (n_out,) or not bool(out.isfinite().all()):
            fail(f"{name}: logits not finite or of shape {tuple(out.shape)}")
        if on_card and k4 != 1:
            fail(f"{name}: K4 launched {k4} times in one forward")
        return out, wall

    reset_launches()
    p99_walls = [request("serve_p99", b, b["ids"].shape[0])[1] for b in p99]
    bulk_logits, bulk_wall = request("serve_bulk", bulk, bulk["ids"].shape[0])
    scores, retr_wall = request("retrieval_cand", query, n_cand)
    fm_launches = LAUNCHES["fm_interaction"]
    print(f"serve_p99 walls (ms): "
          f"{[round(w * 1e3, 3) for w in p99_walls]}; serve_bulk wall "
          f"{bulk_wall * 1e3:.3f} ms; retrieval_cand wall "
          f"{retr_wall * 1e3:.3f} ms; K4 launches {fm_launches}")
    # checks, off the path: K4 against its plain version on the bulk gather
    offs = torch.arange(nf, dtype=torch.int32, device=dev) * args.fm_vocab
    bulk_ids = torch.as_tensor(bulk["ids"], device=dev)
    bulk_rows = (bulk_ids + offs).reshape(-1)
    v = fm_model.table.index_select(0, bulk_rows).reshape(-1, nf, dim)
    y, y2, y_plain = (fm_interaction_kernel(v), fm_interaction_kernel(v),
                      fm_interaction_ref(v))
    e4, same4 = rel_l1(y, y_plain), torch.equal(y, y2)
    print(f"K4 on the serve_bulk gather {tuple(v.shape)}: rel L1 {e4:.3e}, "
          f"bit-identical relaunch {same4}")
    if not (e4 <= REL_L1 and same4):
        fail("K4 against its plain version")
    n_check = 1000
    full = np.concatenate(
        [np.broadcast_to(query["user_ids"], (n_check, nf - 1)),
         query["cand_ids"][:n_check, None]], axis=1)
    d_id = float((steps["serve_p99"]({"ids": full})
                  - scores[:n_check]).abs().max())
    print(f"retrieval_score vs forward_logits on {n_check} candidates: "
          f"max abs diff {d_id:.3e}")
    if d_id > 1e-4:
        fail("retrieval_score disagrees with forward_logits")
    p99_rows = (torch.as_tensor(p99[0]["ids"], device=dev) + offs).reshape(-1)
    v_p99 = fm_model.table.index_select(0, p99_rows).reshape(-1, nf, dim)
    split = {
        "gather_p99_ms": timer(lambda: fm_model.table.index_select(
            0, p99_rows), 50),
        "k4_p99_ms": timer(lambda: fm_interaction_kernel(v_p99), 50),
        "gather_bulk_ms": timer(lambda: fm_model.table.index_select(
            0, bulk_rows), 20),
    }
    # v read once, y written once; three flops per element and per column
    b_ms, b_by = bound_ms(v.numel() * 4 + v.shape[0] * 4,
                          3.0 * v.numel() + 3.0 * v.shape[0] * v.shape[2])
    k4_row = {
        "name": "fm_interaction", "route": "cuda",
        "source": "src/repro_torch/csrc/fm.cu",
        "replaces": "src/repro/kernels/fm/kernel.py:32",
        "launches": fm_launches,
        "max_abs_err": float((y - y_plain).abs().max()),
        "ms": timer(lambda: fm_interaction_kernel(v), 50),
        "plain_ms": timer(lambda: fm_interaction_ref(v), 20),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": list(v.shape), **split,
    }
    print(f"gather / K4 split (ms): serve_p99 {split['gather_p99_ms']:.4f} / "
          f"{split['k4_p99_ms']:.4f}; serve_bulk "
          f"{split['gather_bulk_ms']:.4f} / {k4_row['ms']:.4f}")
    del steps, v, v_p99, y, y2, y_plain, bulk_logits, scores
    if on_card:
        torch.cuda.empty_cache()

    # ---- 9 (b). FM training ------------------------------------------------
    print("== phase 9 (b): FM training")
    t0 = time.perf_counter()
    fm_train_rows, fm_train_summary = fm_training(args, torch, dev, timer,
                                                  sync, fm_model, spec)
    print(f"phase 9 (b) wall {time.perf_counter() - t0:.1f} s")
    del fm_model
    if on_card:
        torch.cuda.empty_cache()

    # ---- 10. GIN forward ---------------------------------------------------
    print("== phase 10: GIN forward")
    dims = SHAPE_DIMS[GIN_SHAPE]
    gin_cfg = gin_tu.cfg_for(GIN_SHAPE)
    n_nodes = args.gin_nodes or dims["n_real"]
    t0 = time.perf_counter()
    gb, gin_n, gin_e, e_real, graph_s, batch_s = gin_host.result()
    wait_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prepared = gnn.prepare_batch(gb, dev)
    sync()
    prep_s = time.perf_counter() - t0
    del gb
    gin = gnn.init_params(gin_cfg, seed=args.seed, device=dev)
    print(f"gin-tu {GIN_SHAPE}: N={gin_n} ({n_nodes} real) E={gin_e} "
          f"({e_real} real, alpha {GIN_ALPHA}) d_feat={gin_cfg.d_feat} "
          f"d_hidden={gin_cfg.d_hidden} layers={gin_cfg.n_layers} classes="
          f"{gin_cfg.n_classes}; host build graph {graph_s:.1f} s, batch "
          f"{batch_s:.1f} s (on a host thread since phase 3; waited "
          f"{wait_s:.1f} s for it here); upload + destination and source "
          f"sorts {prep_s:.1f} s")
    src_s, seg_s, w_s = (prepared["agg_src"], prepared["agg_dst"],
                         prepared["agg_w"])
    # the row ranges of the sorted ids, for the library calls (K5 plans its
    # own work from the ids)
    ptr_s = torch.searchsorted(seg_s, torch.arange(
        gin_n + 1, dtype=seg_s.dtype, device=dev))
    print(f"K5: {-(-gin_e // CHUNK_ROWS)} chunks of {CHUNK_ROWS} rows; "
          f"longest segment {int(torch.diff(ptr_s).max())} rows")
    held = torch.cuda.memory_allocated() / 1e9 if on_card else 0.0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    forms_before = dict(FORMS)
    gin_walls = []
    for i in range(2):
        t0 = time.perf_counter()
        out = gnn.forward(gin, prepared)
        sync()
        gin_walls.append(time.perf_counter() - t0)
        if on_card and LAUNCHES["segment_sum"] != gin_cfg.n_layers * (i + 1):
            fail(f"K5 launched {LAUNCHES['segment_sum']} times in {i + 1} "
                 "forwards")
    gin_launches = LAUNCHES["segment_sum"]
    carry_launches = LAUNCHES["segment_sum_carry"]
    gin_forms = {k: v - forms_before[k] for k, v in FORMS.items()}
    peak = (torch.cuda.max_memory_allocated() / 1e9 - held if on_card
            else 0.0)
    msg_gb = gin_e * gin_cfg.d_hidden * 4 / 1e9
    if out.shape != (gin_n, gin_cfg.n_classes) or not bool(
            out.isfinite().all()):
        fail(f"GIN output not finite or of shape {tuple(out.shape)}")
    print(f"forward walls {[round(w, 4) for w in gin_walls]} s; K5 launches "
          f"{gin_launches} (carry kernel {carry_launches}, by form "
          f"{gin_forms}); device memory "
          f"peak {peak:.3f} GB above the {held:.3f} GB held by earlier "
          f"phases (an [E, d] message buffer would be {msg_gb:.3f} GB); "
          f"|out|_1 / N {float(out.abs().sum()) / gin_n:.4e}")
    if on_card and (carry_launches != gin_launches
                    or gin_forms["gather"] != gin_launches):
        fail(f"K5 launched {gin_launches} times, {gin_forms} by form, its "
             f"carry kernel {carry_launches} times: the forward must run "
             "the gather form, each launch followed by one carry")
    if peak * 1e9 >= gin_e * gin_cfg.d_hidden * 4:
        fail(f"the GIN forward's memory peak {peak:.3f} GB holds an [E, d] "
             "message buffer")

    def plain_agg(data, seg, n, weights=None, rows=None):
        return segment_sum_ref(data, seg, n, weights, rows)

    out_plain = gnn.forward(gin, prepared, segment_sum=plain_agg)
    e_fwd = rel_l1(out, out_plain)
    print(f"forward with K5 vs with its plain version: rel L1 {e_fwd:.3e}")
    if e_fwd > REL_L1:
        fail("GIN forward with K5 disagrees with the plain version")
    del out, out_plain
    h0 = gin.embed(prepared["x"], final_act=True)
    n_e, dh = gin_e, h0.shape[1]
    # the contiguous form on layer 0's messages, weighted as GIN weights
    # them and unweighted as torch.segment_reduce sums them
    msgs = h0.index_select(0, src_s)
    a5, a5b = (segment_sum_sorted(msgs, seg_s, gin_n, weights=w_s)
               for _ in range(2))
    p5 = segment_sum_ref(msgs, seg_s, gin_n, w_s)
    e5, same5 = rel_l1(a5, p5), torch.equal(a5, a5b)
    print(f"K5 on layer 0's messages {tuple(msgs.shape)}: rel L1 {e5:.3e}, "
          f"bit-identical relaunch {same5}")
    if not (e5 <= REL_L1 and same5):
        fail("K5 against its plain version")
    err5 = float((a5 - p5).abs().max())
    del a5b, p5
    # integer-valued rows and weights sum exactly in any order, in both forms
    seg_i = np.sort(rng.integers(0, 300, 10_000)).astype(np.int32)
    seg_i[-100:] = 2**30
    small = [torch.as_tensor(a, device=dev) for a in (
        rng.integers(-8, 8, (10_000, 64)).astype(np.float32), seg_i,
        rng.integers(0, 3, 10_000).astype(np.float32),
        rng.integers(0, 2_000, 10_000).astype(np.int32))]
    exact = torch.equal(segment_sum_sorted(small[0], small[1], 300,
                                           weights=small[2]),
                        segment_sum_ref(small[0], small[1], 300, small[2]))
    table = small[0][:2_000]
    exact_g = torch.equal(
        segment_sum_sorted(table, small[1], 300, weights=small[2],
                           rows=small[3]),
        segment_sum_ref(table, small[1], 300, small[2], small[3]))
    print(f"K5 with 2**30 sentinel ids and mask-0 rows (integer-valued): "
          f"equal to the plain version {exact}, gather form {exact_g}")
    if not (exact and exact_g):
        fail("K5 on sentinel / mask-0 rows")
    # the rows, the int32 ids (and weights), the output
    b_ms, b_by = bound_ms(msgs.numel() * 4 + n_e * 4 + gin_n * dh * 4,
                          msgs.numel())
    bw_ms, _ = bound_ms(msgs.numel() * 4 + n_e * 4 * 2 + gin_n * dh * 4,
                        2.0 * msgs.numel())
    print(f"contiguous form bound: {b_ms:.4f} ms unweighted, {bw_ms:.4f} ms "
          "weighted")
    lib_ms = idx_ms = None
    if on_card:
        lengths = torch.diff(ptr_s)
        lo, hi = int(ptr_s[0]), int(ptr_s[-1])
        lib_ms = timer(lambda: torch.segment_reduce(
            msgs[lo:hi], "sum", lengths=lengths), 5)
        lib_err = float((torch.segment_reduce(msgs[lo:hi], "sum",
                                              lengths=lengths)
                         - segment_sum_sorted(msgs, seg_s, gin_n))
                        .abs().max())
        print(f"torch.segment_reduce vs K5 (unweighted): max abs diff "
              f"{lib_err:.3e}")
        seg_l = seg_s.long()
        idx_ms = timer(lambda: torch.zeros_like(a5).index_add_(
            0, seg_l, msgs * w_s[:, None]), 5)
        del seg_l
    k5_row = {
        "name": "segment_sum", "route": "cuda",
        "source": "src/repro_torch/csrc/segment_sum.cu",
        "replaces": "src/repro/kernels/segment/kernel.py:50",
        # the forward runs the gather form only (segment_sum_gather's row)
        "launches": gin_forms["contiguous"], "form": "contiguous",
        "max_abs_err": err5,
        # unweighted, like the library call
        "ms": timer(lambda: segment_sum_sorted(msgs, seg_s, gin_n), 10),
        "plain_ms": timer(lambda: segment_sum_ref(msgs, seg_s, gin_n), 3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        # weighted by the edge mask, as the forward weights its messages
        "weighted_ms": timer(lambda: segment_sum_sorted(
            msgs, seg_s, gin_n, weights=w_s), 10),
        "index_add_ms": idx_ms,
        "gather_ms": timer(lambda: h0.index_select(0, src_s), 5),
        "shape": [n_e, dh, gin_n],
    }
    del msgs, a5
    if on_card:
        torch.cuda.empty_cache()
    # the gather form: one GIN layer's aggregation, as the forward runs it
    g5, g5b = (segment_sum_sorted(h0, seg_s, gin_n, weights=w_s, rows=src_s)
               for _ in range(2))
    pg = segment_sum_ref(h0, seg_s, gin_n, w_s, src_s)
    eg, sameg = rel_l1(g5, pg), torch.equal(g5, g5b)
    print(f"K5 gather form on layer 0 (h {tuple(h0.shape)}, rows = src): "
          f"rel L1 {eg:.3e}, bit-identical relaunch {sameg}")
    if not (eg <= REL_L1 and sameg):
        fail("K5's gather form against its plain version")
    errg = float((g5 - pg).abs().max())
    del g5b, pg
    # the node states read and the output written once; the ids, the
    # sources and the weights
    gb_ms, gb_by = bound_ms(h0.numel() * 4 * 2 + n_e * 4 * 3,
                            2.0 * n_e * dh)
    rows_ms = n_e * dh * 4 / HBM_BYTES_PER_S * 1e3
    print(f"gather form bound: {gb_ms:.4f} ms counting each input byte once; "
          f"its {n_e * dh * 4 / 1e9:.3f} GB of rows at 3.35 TB/s, none "
          f"reused in L2: {rows_ms:.4f} ms")
    lib_g = None
    if on_card:
        lo, hi = int(ptr_s[0]), int(ptr_s[-1])
        a_csr = torch.sparse_csr_tensor(
            ptr_s - lo, src_s[lo:hi].long(), w_s[lo:hi],
            size=(gin_n, h0.shape[0]))
        lib_g = timer(lambda: torch.sparse.mm(a_csr, h0), 5)
        print(f"torch.sparse.mm (sparse_csr) vs K5 gather form: max abs "
              f"diff {float((torch.sparse.mm(a_csr, h0) - g5).abs().max()):.3e}")
        del a_csr
    k5g_row = {
        "name": "segment_sum_gather", "route": "cuda",
        "source": "src/repro_torch/csrc/segment_sum.cu",
        "replaces": "src/repro/kernels/segment/kernel.py:50",
        "launches": gin_forms["gather"], "carry_launches": carry_launches,
        "form": "gather",
        "max_abs_err": errg,
        "ms": timer(lambda: segment_sum_sorted(
            h0, seg_s, gin_n, weights=w_s, rows=src_s), 10),
        "plain_ms": timer(lambda: segment_sum_ref(h0, seg_s, gin_n, w_s,
                                                  src_s), 3),
        "bound_ms": gb_ms, "bound_by": gb_by, "library_ms": lib_g,
        "shape": [n_e, dh, gin_n],
    }
    gin_summary = (f"GIN (gin-tu {GIN_SHAPE}): N={gin_n} E={gin_e} "
                   f"({e_real} real) forward walls "
                   f"{[round(w, 4) for w in gin_walls]} s, peak {peak:.3f} GB "
                   f"above the earlier phases' {held:.3f} GB")
    del h0, g5, small, table, ptr_s
    if on_card:
        torch.cuda.empty_cache()

    # ---- 10 (b). GIN training ----------------------------------------------
    print("== phase 10 (b): GIN training")
    t0 = time.perf_counter()
    gin_train_rows, gin_train_summary = gin_training(args, torch, dev, timer,
                                                     sync, gin, prepared)
    print(f"phase 10 (b) wall {time.perf_counter() - t0:.1f} s")
    del prepared, gin
    if on_card:
        torch.cuda.empty_cache()

    # ---- 10 (c). MeshGraphNet, EGNN and DimeNet -------------------------
    print("== phase 10 (c): MeshGraphNet, EGNN and DimeNet")
    t0 = time.perf_counter()
    gnn_rows, gnn_summary = gnn_archs_phase(args, torch, dev, timer, sync,
                                            gnn_host)
    gin_host_pool.shutdown()
    print(gnn_summary)
    print(f"phase 10 (c) wall {time.perf_counter() - t0:.1f} s")
    if on_card:
        torch.cuda.empty_cache()

    # ---- 11. numbers -------------------------------------------------------
    print("== phase 11: numbers")
    print(f"main path: N={g.n} links={g.n_edges} pallas rounds "
          f"{rep.n_rounds} ops {rep.n_ops} solve wall {rep.wall_time_s:.3f} s"
          f"; segment_sum rounds {rep_ss.n_rounds} ops {rep_ss.n_ops} wall "
          f"{rep_ss.wall_time_s:.3f} s; cold session {cold.wall_time_s:.3f} "
          f"s; warm requests ops {warm_ops}")
    print(f"engine path (k={k_e}): layout builds {build_bsr_s:.3f} s (bsr) "
          f"{build_chk_s:.3f} s (chunk); engine:bsr cold rounds "
          f"{rep_bsr.n_rounds} chunks {rep_bsr.extras['chunks']} ops "
          f"{rep_bsr.n_ops} wall {rep_bsr.wall_time_s:.3f} s; engine:chunk "
          f"cold rounds {rep_chk.n_rounds} chunks {rep_chk.extras['chunks']} "
          f"ops {rep_chk.n_ops} wall {rep_chk.wall_time_s:.3f} s; forced "
          f"move rounds {rep_fm.n_rounds} wall {rep_fm.wall_time_s:.3f} s; "
          f"warm rounds {warm_e.n_rounds} ops {warm_e.n_ops} wall "
          f"{warm_e.wall_time_s:.3f} s")
    rows = []

    def k1_numbers(what, ins):
        """K1's bytes, bound and armed tile share at the operands ``ins``."""
        _, block_col, _, col_active, f3, _ = ins
        tiles_read = armed_tiles(col_active, block_col)
        n_bytes = k1_bytes(ins)
        b_ms, b_by = bound_ms(n_bytes,
                              2.0 * tiles_read * BS * BS * f3.shape[2])
        print(f"K1 {what}: {int(col_active.sum())}/{f3.shape[0]} block "
              f"columns armed, {tiles_read}/{block_col.numel()} tiles read "
              f"({tiles_read / block_col.numel():.4f} of the pool)")
        return n_bytes, b_ms, b_by, tiles_read / block_col.numel()

    ins_a, err_a = timing_inputs["k1"]
    ins_b, err_b = timing_inputs["k1_late"]
    ins, err = timing_inputs["k2"]
    # K1 at inputs (a) and (b) and K2 over the same pool, timed by one rule
    # so that their ratio is like for like: each the least of two 20-call
    # means, in turns, the second round reversed
    pool_rule = ("least of two 20-call means, in turns with the other "
                 "frontier_round_bsr input and bsr_spmm")
    times = least(timer, {
        "k1": lambda: frontier_round_bsr_kernel(*ins_a),
        "k1_late": lambda: frontier_round_bsr_kernel(*ins_b),
        "k2": lambda: bsr_spmm_kernel(*ins)}, 20)
    print("K1 (a), K1 (b), K2 over the pool, ms (least, greatest of two): "
          + ", ".join(f"{times[k][0]:.4f} [{times[k][1]:.4f}]"
                      for k in ("k1", "k1_late", "k2")))
    bytes_a, b_ms, b_by, share_a = k1_numbers("timing input (a)", ins_a)
    bytes_b, b_ms_b, _, share_b = k1_numbers(
        f"late round (input b, after {late_rounds} rounds)", ins_b)
    k1_ms, late_ms, k2_ms = (times[k][0] for k in ("k1", "k1_late", "k2"))
    rows.append({
        "name": "frontier_round_bsr", "route": "cuda",
        "source": "src/repro_torch/csrc/diffusion.cu",
        "replaces": "src/repro/kernels/diffusion/kernel.py:376",
        "launches": main_launches["frontier_round_bsr"],
        "max_abs_err": err_a,
        "ms": k1_ms,
        "plain_ms": timer(lambda: frontier_round_bsr_plain(*ins_a), 5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "timing": pool_rule,
        "kernel": (launch_frontier_round_bsr(*ins_a)[2] if on_card
                   else None),
        "tb_per_s": bytes_a / k1_ms / 1e9,
        "armed_tile_fraction": share_a,
        # against K2's bulk body over the same pool, timed alike
        "k2_ratio": k1_ms / k2_ms,
        # input (b), a late round: the same kernel and launches
        "late_ms": late_ms,
        "late_plain_ms": timer(lambda: frontier_round_bsr_plain(*ins_b), 5),
        "late_bound_ms": b_ms_b, "late_max_abs_err": err_b,
        "late_kernel": (launch_frontier_round_bsr(*ins_b)[2] if on_card
                        else None),
        "late_tb_per_s": bytes_b / late_ms / 1e9,
        "late_armed_tile_fraction": share_b,
    })
    print(f"K1 at input (a) / K2 over the same pool: {k1_ms:.4f} / "
          f"{k2_ms:.4f} ms = {rows[0]['k2_ratio']:.4f}")
    blocks, visit_block, visit_col, row_ptr, x3 = ins
    k2_bytes = (blocks.numel() * 4 + visit_block.numel() * 8
                + row_ptr.numel() * 8 + x3.numel() * 4 * 2)
    b_ms, b_by = bound_ms(k2_bytes, 2.0 * blocks.numel() * x3.shape[2])
    lib_ms = None
    if on_card:
        a_bsr = torch.sparse_bsr_tensor(row_ptr, visit_col.long(), blocks,
                                        size=(n_pad, n_pad))
        x2 = x3.reshape(n_pad, 1)
        lib_ms = timer(lambda: torch.sparse.mm(a_bsr, x2), 20)
        lib_err = float((torch.sparse.mm(a_bsr, x2).reshape(x3.shape)
                         - bsr_spmm_kernel(*ins)).abs().max())
        print(f"torch.sparse.mm (sparse_bsr) vs K2: max abs diff "
              f"{lib_err:.3e}")
    rows.append({
        "name": "bsr_spmm", "route": "cuda",
        "source": "src/repro_torch/csrc/diffusion.cu",
        "replaces": "src/repro/kernels/diffusion/kernel.py:70",
        "launches": main_launches["bsr_spmm"],
        "check_launches": check_launches,
        "max_abs_err": err,
        "ms": k2_ms,
        "plain_ms": timer(lambda: bsr_spmm_plain(*ins), 5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        "timing": pool_rule,
        "kernel": launch_bsr_spmm(*ins)[1] if on_card else None,
        "tb_per_s": k2_bytes / k2_ms / 1e9,
        "library_tb_per_s": lib_ms and k2_bytes / lib_ms / 1e9,
    })
    (x, edges), err = timing_inputs["k3"]
    n_e = edges.n_edges
    k3_bytes = edges.indptr.numel() * 8 + n_e * 8 + x.numel() * 4 * 2
    b_ms, b_by = bound_ms(k3_bytes, 2.0 * n_e)
    dst_t = torch.repeat_interleave(
        torch.arange(g.n, device=dev), torch.diff(edges.indptr))
    src_t = edges.src.long()
    rows.append({
        "name": "edge_sum", "route": "cuda",
        "source": "src/repro_torch/csrc/edge_sum.cu",
        "replaces": "src/repro/core/diteration.py:221",
        "launches": main_launches["edge_sum"] + k3_warm_launches,
        "max_abs_err": err,
        "ms": timer(lambda: edge_sum(x, edges), 50),
        "plain_ms": timer(lambda: edge_sum_plain(
            x, edges.indptr, edges.src, edges.wgt), 20),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timer(lambda: torch.zeros_like(x).index_add_(
            0, dst_t, x[src_t] * edges.wgt), 20),
    })
    # K2 at the engine's shapes: one launch pushes every PID's sent fluid
    # through the real tiles (bsr_gather_spmm's port)
    v = visits.n_visits
    k2e_bytes = (v * s_e * s_e * 4 + v * 8 + visits.row_ptr.numel() * 8
                 + x3_e.numel() * 4 + k_e * r_e * s_e * 4)
    b_ms, b_by = bound_ms(k2e_bytes, 2.0 * v * s_e * s_e)
    lib_ms = None
    if on_card:
        a_bsr = torch.sparse_bsr_tensor(
            visits.row_ptr, visits.visit_col.long(),
            eng.pool[visits.visit_block.long()],
            size=(k_e * r_e * s_e, r_e * s_e))
        x2 = x3_e.reshape(r_e * s_e, 1)
        lib_ms = timer(lambda: torch.sparse.mm(a_bsr, x2), 10)
        lib_err = float((torch.sparse.mm(a_bsr, x2).reshape(k_e * r_e, s_e)
                         - engine_tile_push(eng.pool, visits, sent_e))
                        .abs().max())
        print(f"torch.sparse.mm (sparse_bsr) vs K2 at the engine's shapes: "
              f"max abs diff {lib_err:.3e}")
        del a_bsr
    k2_ms = timer(lambda: engine_tile_push(eng.pool, visits, sent_e), 20)
    rows.append({
        "name": "bsr_gather_spmm", "route": "cuda",
        "source": "src/repro_torch/csrc/diffusion.cu",
        "replaces": "src/repro/kernels/diffusion/kernel.py:182",
        "launches": engine_launches["bsr_spmm"],
        "max_abs_err": timing_inputs["k2e"],
        "ms": k2_ms,
        "plain_ms": timer(k2_engine_plain, 3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        "kernel": launch_bsr_spmm(
            eng.pool, visits.visit_block, visits.visit_col, visits.row_ptr,
            x3_e)[1] if on_card else None,
        "tb_per_s": k2e_bytes / k2_ms / 1e9,
        "library_tb_per_s": lib_ms and k2e_bytes / lib_ms / 1e9,
        "visits": v,
    })
    # K3 at the engine's shapes: the engine:chunk per-edge push
    n_e, n_out = edges_e.n_edges, edges_e.n
    k3e_bytes = (edges_e.indptr.numel() * 8 + n_e * 8 + xe.numel() * 4
                 + n_out * 4)
    b_ms, b_by = bound_ms(k3e_bytes, 2.0 * n_e)
    dst_e = torch.repeat_interleave(
        torch.arange(n_out, device=dev), torch.diff(edges_e.indptr))
    src_e = edges_e.src.long()
    rows.append({
        "name": "engine_edge_sum", "route": "cuda",
        "source": "src/repro_torch/csrc/edge_sum.cu",
        "replaces": "src/repro/core/distributed.py:514",
        "launches": k3_engine_launches,
        "max_abs_err": timing_inputs["k3e"],
        "ms": timer(lambda: edge_sum(xe, edges_e), 50),
        "plain_ms": timer(lambda: edge_sum_plain(
            xe, edges_e.indptr, edges_e.src, edges_e.wgt), 20),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timer(lambda: torch.zeros(
            n_out, dtype=torch.float32, device=dev).index_add_(
                0, dst_e, xe[src_e] * edges_e.wgt), 20),
    })
    rows += [k4_row, k5_row, k5g_row, *fm_train_rows, *gin_train_rows,
             *gnn_rows]
    print(f"FM (fm, vocab {args.fm_vocab}/field): serve_p99 walls (ms) "
          f"{[round(w * 1e3, 3) for w in p99_walls]}, serve_bulk "
          f"{bulk_wall * 1e3:.3f} ms, retrieval_cand {retr_wall * 1e3:.3f} ms")
    print(fm_train_summary)
    print(gin_summary)
    print(gin_train_summary)

    def show(rows):
        for r in rows:
            print(f"{r['name']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} "
                  f"ms by {r['bound_by']}, plain {r['plain_ms']:.4f} ms, "
                  f"library {r['library_ms']}) launches {r['launches']}"
                  + (f"; by CUDA graph replay {r['graph_ms']:.4f} ms"
                     + (f", library {r['library_graph_ms']:.4f} ms"
                        if r.get("library_graph_ms") is not None else "")
                     + (f", {r['splits']} split(s)" if "splits" in r else "")
                     if "graph_ms" in r else "")
                  + (f"; {r['kernel']} body, {r['tb_per_s']:.3f} TB/s"
                     if "tb_per_s" in r else "")
                  + (f"; input (b) {r['late_ms']:.4f} ms (bound "
                     f"{r['late_bound_ms']:.4f} ms), "
                     f"{r['late_armed_tile_fraction']:.4f} of the tiles "
                     f"armed, {r['late_tb_per_s']:.3f} TB/s"
                     if "late_ms" in r else "") + f" on {smi}")

    show(rows)
    print(f"phases 1-11 wall {time.perf_counter() - t_start:.1f} s")

    # ---- 12. LM serving ----------------------------------------------------
    print("== phase 12: LM serving")
    t0 = time.perf_counter()
    lm_rows, lm_summary = lm_serving(args, torch, dev, timer, sync)
    print(lm_summary)
    show(lm_rows)
    rows += lm_rows
    print(f"phase 12 wall {time.perf_counter() - t0:.1f} s")

    # ---- 13. simulator -----------------------------------------------------
    print("== phase 13: simulator")
    sim_rows, sim_summary = simulator_phase(args, torch, dev, timer, g,
                                            problem, rep_ss.x)
    print(sim_summary)
    show(sim_rows)
    rows += sim_rows

    # ---- 18. tuner and examples: (a) the ring depths at phase 3's and 6's
    # pools, before they are freed ----------------------------------------
    print("== phase 18: tuner and examples")
    t18 = time.perf_counter()
    ins_a, ins_b = timing_inputs["k1"][0], timing_inputs["k1_late"][0]
    ins_k2 = timing_inputs["k2"][0]
    print("(a) depths " + ", ".join(str(d) for d in SWEEP_DEPTHS))
    depth_errs = depth_phase(torch, timer, {
        "K1 (a)": ("k1", ins_a, frontier_round_bsr_plain(*ins_a)),
        "K1 (b)": ("k1", ins_b, frontier_round_bsr_plain(*ins_b)),
        "K2 pool": ("k2", ins_k2, (bsr_spmm_plain(*ins_k2),)),
        "K2 engine visits": ("k2", (eng.pool, visits.visit_block,
                                    visits.visit_col, visits.row_ptr, x3_e),
                             (k2_engine_plain()[..., None],)),
    }, on_card)

    def at_depth(kernel, ins, d):
        if kernel == "k1":
            if on_card:
                return lambda: launch_frontier_round_bsr(*ins, buffer_depth=d)
            return lambda: frontier_round_bsr_plain(*ins)
        if on_card:
            return lambda: launch_bsr_spmm(*ins, buffer_depth=d)
        return lambda: bsr_spmm_plain(*ins)

    depth_times = least(timer, {
        **{f"k1_d{d}": at_depth("k1", ins_a, d) for d in SWEEP_DEPTHS},
        **{f"k2_d{d}": at_depth("k2", ins_k2, d) for d in SWEEP_DEPTHS}}, 20)
    print("K1 (a) and K2 over the pool by depth, ms (least, greatest of "
          "two 20-call means, in turns): " + ", ".join(
              f"{k} {v[0]:.4f} [{v[1]:.4f}]" for k, v in depth_times.items())
          + f" on {smi}")

    # the earlier phases' sessions and pools are done with
    del s_bsr, eng, visits, session, m
    if on_card:
        torch.cuda.empty_cache()

    # ---- 18 (b)-(d): the sweep, the records in use, the examples ----------
    depth_launches, _sweeps, tuner_summary = tuner_phase(
        args, torch, dev, problem, rep_ss.x,
        (x_pallas, pallas_rounds, pallas_ops, pallas_wall), smi)
    print(tuner_summary)
    if on_card:
        torch.cuda.empty_cache()
    print("(d) examples")
    print(examples_phase(args, torch, dev))
    k1_row = next(r for r in rows if r["name"] == "frontier_round_bsr")
    k2_row = next(r for r in rows if r["name"] == "bsr_spmm")
    depth_rows = []
    for d in SWEEP_DEPTHS[1:]:
        for name, row, label, key in (
                ("frontier_round_bsr", k1_row, "K1 (a)", "k1"),
                ("bsr_spmm", k2_row, "K2 pool", "k2")):
            depth_rows.append({
                "name": f"{name}_depth{d}", "route": "cuda",
                "source": row["source"], "replaces": row["replaces"],
                "launches": depth_launches[name, d],
                "max_abs_err": depth_errs[label, d],
                "ms": depth_times[f"{key}_d{d}"][0],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"],
                "buffer_depth": d, "depth1_ms": depth_times[f"{key}_d1"][0],
                "timing": "least of two 20-call means, in turns with the "
                          "other depths (phase 18 (a))"})
    show(depth_rows)
    rows += depth_rows
    print(f"phase 18 wall {time.perf_counter() - t18:.1f} s")

    # ---- 16. MoE serving (after 12, whose model is freed, and after the
    # engine's and the frontier's pools are: its 30 GB of weights need the
    # room) --------------------------------------------------------------
    print("== phase 16: MoE serving")
    t0 = time.perf_counter()
    moe_rows, moe_summary = moe_serving(args, torch, dev, timer, sync)
    print(moe_summary)
    show(moe_rows)
    rows += moe_rows
    print(f"phase 16 wall {time.perf_counter() - t0:.1f} s")

    # ---- 17. LM training (after 16, whose MoE weights are freed) ---------
    print("== phase 17: LM training")
    t0 = time.perf_counter()
    train_rows, train_summary = lm_training(args, torch, dev, timer, sync)
    print(train_summary)
    show(train_rows)
    rows += train_rows
    print(f"phase 17 wall {time.perf_counter() - t0:.1f} s")
    if on_card:
        torch.cuda.empty_cache()

    # ---- 15. resilience (before 14, which mutates phase 4's store) --------
    print("== phase 15: resilience")
    print(resilience_phase(args, torch, dev, root, g, x_pallas,
                           pallas_rounds))
    if on_card:
        torch.cuda.empty_cache()

    # ---- 14. rank serving --------------------------------------------------
    print("== phase 14: rank serving")
    rank_rows, rank_summary = rank_serving_phase(args, torch, dev, timer,
                                                 problem)
    print(rank_summary)
    show(rank_rows)
    rows += rank_rows
    print(f"total wall {time.perf_counter() - t_start:.1f} s")
    if not on_card:
        print("rehearsal on the CPU done: no device numbers, no result")
        return 3
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
