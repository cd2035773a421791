"""Smoke run of lp_gnn_tpu_torch on one NVIDIA GPU: build, check, serve,
train.

    python3 chip_smoke.py [--seed 0]

Phases, each fatal on failure (non-zero exit, no result line):

1. card and build: needs ``torch.cuda.is_available()``; prints the card's
   name and power limit (nvidia-smi); builds every CUDA kernel of the
   package from ``lp_gnn_tpu_torch/ops/csrc`` (one nvcc each, all at once).
2. kernels: on a graph of the repo's bench shape (bench.py:58-60,91-111:
   E=1,000,000 edges, M=65,536 constraints, N=131,072 variables, 10% of
   edges on hot rows, from ``--seed`` with numpy) runs the CSR SpMM in both
   directions at D=8 and D=1024, fp32 and bf16, then at D=1024 bf16 a dense
   row of 65,536 edges and a graph whose x fits L2 whole, and the row gather
   at the probes' shapes and the SpMM's, each against its plain PyTorch
   version on the card, the SpMM also bit-identical over two calls; times
   kernel (CUDA events, ``ms``; its own device time from ``torch.profiler``,
   ``device_ms``), plain version and a library call the package never
   makes; computes each kernel's bound. The SpMM's backward (through
   ``SpmmCSR``: the kernel over the transpose ordering) at D=1024 bf16 in
   both directions, against the gradient through the plain version, one
   launch a backward, bit-identical over two calls. The SpMM also at the
   pipeline's shapes: a mirp_bench LP's structure, D=8 and D=1024 bf16;
   and at widths the kernel runs through padded copies or column slabs
   (v2c, D=3 and 1028 fp32, 100, 2056 and 4104 bf16; a launch a slab).
3. reference: GCN_FC(8,8,hids=1024,depth=3) logits on the card against the
   same weights on the CPU, on a small graph, in fp32 and bf16; and a bf16
   GCN_FC(8,8,hids=100,depth=3) on one bench LP (``hids100_bf16``).
4. serve: writes 6 processed LPs of the bench shape (reference blob
   format, with ``.meta``), saves a seeded
   GCN_FC(8,8,hids=1024,depth=3,dtype='bfloat16') as ``mdl.pth`` and runs
   the entry point ``python -m lp_gnn_tpu_torch.pred_basis`` (in this
   process, through runpy, so the launch counts are readable): every
   ``.bas`` must be a valid basis and the SpMM kernel must have been
   launched 4 times per forward.
5. breakdown: one bench-shape LP's inference time split into graph
   tensors, forward, copy to the host and decode.
6. dist_serve: the edge-partitioned path. Writes 3 bench-shape LPs and runs
   the entry point with ``--mesh_shape edge=4 --edge_num_thresh 0`` (all 4
   shards on the one card): every ``.bas`` must be a valid basis, and each
   forward must launch the halo all-to-all, the row gather and the SpMM
   exactly as often as the design says. Prints the partition (K, ms, ns,
   Bh, edges per shard), ``part_time`` and ``inf_time`` per LP, and one
   LP's breakdown: host stages, the dist and single-card forwards' spans
   on the card, and the dist forward's device time by kernel.
7. dist_reference: one bench-shape LP's edge-partitioned logits against the
   single-card logits on the card, same weights, fp32 and bf16.
8. train: writes 4 bench-shape LPs (2 train, 2 val) and runs the entry
   point ``python -m lp_gnn_tpu_torch.train`` (through runpy) with
   GCN_FC(8,8,hids=1024,depth=3), bf16, balanced CE, 5 epochs and a val
   pass: finite losses, the SpMM launched exactly 2 x 2 + 4 x 10 + 4 x 2 =
   52 times, checkpoints written, and the trained ``mdl.pth`` serving
   valid bases through ``pred_basis``; prints each epoch's wall time and
   every step's loss.
9. train_breakdown: one bench-shape training step: wall time, span on the
   card, device time by kernel, the card's idle share, peak memory.
10. train_reference: 3 steps on the card against the CPU in fp32 and in
   fp64 (small graph), parameter by parameter; one step's gradients
   through the kernel against the plain version (bench shape, fp32); remat
   against no remat (bench shape, bf16).
11. pipeline: the flagship recipe end to end through the entry points (in
   this process, through runpy). ``python -m lp_gnn_tpu_torch.run_prep_data``
   generates the recipe's family (``mirp_like --size bench``, 30 of the
   recipe's 40 instances for the script's time, from ``--seed``), cold-solves it with HiGHS (and the crash baseline), one
   worker process a CPU, and writes the blobs; ``python -m
   lp_gnn_tpu_torch.run_train_test`` trains GCN_FC(8,8,hids=1024,depth=3)
   in bf16 with balanced CE for 20 epochs, predicts the 9 val LPs,
   calibrates the warm gate on train LPs, warm-starts, validates and
   reports. Fails on a broken pipeline, not on a weak model: every prep
   artifact and every cold solve Optimal, finite losses, the gate's k in
   [5, 12], 9 valid bases, 9 warm logs with no basis rejected, the
   results columns of every val LP, the run-dir logs, and ``spmm_csr``
   launched exactly as the design counts (the formula is printed). Prints
   the machine's solver stack (scipy, its HiGHS, pandas, pytables, g++),
   the gate's decision and interval, the val means (cold and warm
   iterations, ``impr_niter``, ``acc``), each stage's wall seconds and the
   peak device memory.

12. gen_reference: GENDeeper(8,8,hids=256,depth=5) logits on the card
   against the same weights on the CPU (small graph, fp32 and bf16), and 3
   fp32 training steps on the card against the CPU in fp64 and in fp32.
13. gen_serve: the slice's configuration, the JAX package's GENDeeper bench
   arch (bench.py:61-73,193-195:
   GENDeeper(8,8,hids=256,depth=5,dtype='bfloat16',remat=True)), serving 3
   bench-shape LPs through ``python -m lp_gnn_tpu_torch.pred_basis``:
   valid bases, ``gen_agg_fwd`` launched exactly 10 times a forward (5
   convs x 2 directions) and the SpMM not at all; ``inf_time`` and one
   LP's breakdown with the forward's device time by kernel.
14. gen_train: the same arch through ``python -m lp_gnn_tpu_torch.train``
   on 4 bench-shape LPs (2 train, 2 val), 2 epochs: finite losses, the
   launches of the printed formula (a step: 10 forward + 10 recomputed by
   remat ``gen_agg_fwd``, 10 ``gen_agg_bwd``, 10 SpMMs for the gathers'
   backwards, none for an input cache; 10 ``gen_agg_fwd`` a val forward),
   the trained ``mdl.pth`` serving valid bases; then one step's wall time,
   span on the card, device time by kernel, idle share and peak memory.
15. zoo_serve: GCN(8,8,hids=256), GCNDeeper(8,8,hids=256,depth=5) and
   GCNRand() through ``pred_basis`` on 2 bench-shape LPs each: valid bases
   and the SpMM launched exactly 6, 10 and 0 times a forward.
16. sampled_serve: ``pred_basis`` with ``--edge_num_thresh 500000
   --batch_size 32768`` on 1 bench-shape LP (1M edges: the sampled route,
   6 exact shards an LP): valid bases, the SpMM launched exactly 4 times a
   shard forward, each LP's sampled bf16 logits held to its full-graph
   forward (the bf16 spread rule of phase 3); one LP's breakdown (host
   sampling, graph tensors, the shards' forwards on the card, decode); the
   SpMM against its plain version on graphs of falling, then rising size;
   GENDeeper through the same route on 1 LP (10 ``gen_agg_fwd`` a shard
   forward).
17. sampled_train: ``train`` with the same flags on 4 bench-shape LPs (2
   train, 2 val), 1 epoch: 6 fanout-6 subgraphs a graph, one step each,
   finite losses, the SpMM launched exactly 2 a subgraph (its input cache)
   + 2 a step forward + 2 a step backward; the host seconds of sampling and
   of the subgraphs' tensors, each step's span on the card, peak memory.
18. graph_batch: ``train --graph_batch 2`` on 3 train LPs (2 of one
   constraint pattern, stacked; 1 single): the stacks, singles and sampled
   graphs it made, 4 SpMM launches the union step (not 8); then one union
   step against a step on the serial mean loss of the same 2 graphs
   (GCN_FC fp32, SGD at lr 1, from the same weights: updates within 1e-4
   of the largest).
19. dp: two processes of ``train --mesh_shape dp=2`` joined over gloo by
   the LP_GNN_DIST_* contract on the one card take one step; rank 0's
   weights are held to the single-process ``--graph_batch 2`` step's
   (the same rule), rank 1 writes no file; then one process joins an NCCL
   group (NPROCS=1) and all-reduces a gradient-sized buffer on the card.

20. dist_train: the flagship GCN_FC(8,8,hids=1024,depth=3) bf16 through
   ``train --mesh_shape edge=4 --edge_num_thresh 0`` on 3 bench-shape LPs
   (2 train, 1 val), 2 epochs: every graph partitioned and stepped over
   its 4 shards on the card, finite losses, the checkpoints, the launches
   exactly by step (40 SpMM, 2 K1, 2 gathers: the hidden conv forward and
   backward; conv1 reads the dist input cache) and in all (240, 12, 12:
   caches and the val forward included); each epoch's wall time, the
   steps' spans on the card, the partitions' host seconds, peak memory;
   then one dist step held against the single-card step from the same
   weights on one LP (fp32, dropout 0, SGD at lr 1: updates within 1e-4
   of the largest), the dist step's launches exact.
21. dist_zoo_serve: GCN(8,8,hids=256), GCNDeeper(8,8,hids=256,depth=5),
   GENDeeper(8,8,hids=256,depth=5) and GCNRand() through ``pred_basis
   --mesh_shape edge=4 --edge_num_thresh 0`` on one bench-shape LP each:
   valid bases, the launches a forward exactly (a GraphConv conv a gather,
   a K1 and 20 SpMMs; a GEN conv a gather, 8 ``gen_agg_fwd``, a K1 and a
   ``gen_lse_merge``), ``inf_time``; each arch's dist logits against the
   single card's (fp32 max |err| <= 1e-3; bf16 mean |err| at most 3x the
   single card's own bf16 error).
22. dist_gen_train: one dist GENDeeper(8,8,hids=256,depth=5) step at K=4
   held against the single-card GEN step (phase 20's rule), its launches
   exact (40 ``gen_agg_fwd``, 40 ``gen_agg_bwd``, 60 SpMMs, 10 K1, 10
   gathers, 5 merges).
23. dp_edge: dp x edge training, two ranks on the one card (gloo, the
   LP_GNN_DIST_* contract), each holding one of two bench-shape twins as 4
   shards. ``train --mesh_shape dp=2,edge=4 --edge_num_thresh 0`` in fp32,
   SGD at lr 1, no dropout, 1 epoch: rank 0's weights held to the single
   process's ``--graph_batch 2`` step on the twins (each tensor's update
   within the larger of 1e-4 and twice that step's own spread against its
   fp64 witness), both groups gloo, no rank-1 file. Then the recipe (bf16,
   Adam, the arch's dropout, 2 epochs) in the same rank processes (one
   launch of ``chip_smoke.py --grid_rank`` runs both entry points, each
   under the step trace): each rank's launches exactly (an input cache 20
   SpMM / 1 K1 / 1 gather, a step 40 / 2 / 2), equal finite losses on both
   ranks, each rank's step spans on the card, all-reduce ms (and its wait
   for the other rank), peak memory, partition seconds and wall.
24. edge_ranks: edge shards on their own ranks, four processes of this
   script (``--edge_rank``) time-sharing the card under the LP_GNN_DIST_*
   contract (gloo), shard k on rank k, K1 as its rank form (each rank
   writes its blocks into the ranks' receive windows through CUDA IPC).
   K1's rank form at the bench graph's Bh, D=1024 and D=8 bf16, bit for
   bit against its plain version on every rank (the exchange's two
   launches timed one rank at a time, device ms, the exchange with its
   synchronisation on the card, the gloo plain version); 64 exchanges
   back to back with the host's collectives and synchronises made to
   raise, two shapes, rank 0 held back, bit for bit; one rank's launch
   refused, every rank raising and naming it; one fp32 step (SGD at lr 1, no dropout) held to the
   one-process stacked dist step on the same partition (each tensor's
   update within the larger of 1e-4 and twice the single card's
   fp32-vs-fp64 spread), and one fp32 GENDeeper(8,8,hids=256,depth=5)
   step held to the stacked dist GEN step (each update within 1e-4);
   ``pred_basis --mesh_shape edge=4`` on 2 bench
   LPs, every .bas valid and equal to the stacked path's on the same data
   and checkpoint, rank 0's logits within (rtol, atol) 2^-6 of the stacked
   path's; the recipe through ``train`` (bf16, 2 train LPs and 1 val, 2
   epochs), equal finite losses on every rank, rank 0 alone writing. Each
   rank's launches exact: a conv 1 gather, 2 rank-form K1 exchanges of 2
   launches each (the write and the copy-out), 5 SpMMs (a GEN conv 1 / 4
   and 2 ``gen_agg_fwd``, 1 merge; its backward 1 / 4, 2 ``gen_agg_bwd``,
   3 SpMMs), the stacked K1 none; each rank's receive-window bytes beside
   its peak memory.

25. steps_per_call: several training steps in one call
   (``train/scan.py make_scan_train_step``; one CUDA graph a stack after
   its first, eager visit). On 4 bench-shape LPs sharing one sparsity
   pattern (one stack key; values, features and labels their own),
   GCN_FC(8,8,hids=1024,depth=3) bf16, dropout on, Adam built capturable:
   K=4 calls with ``stacked=False`` (one LP) and ``stacked=True`` (the 4),
   3 visits each (eager + capture, replay, replay), equal bit for bit to
   the same steps taken one ``train_step`` at a time (losses, accuracies
   where asked and -1 elsewhere, parameters, Adam's state, the dropout
   generator's state), launches exact; the same for
   GENDeeper(8,8,hids=256,depth=5,remat=True) bf16 at K=2, 2 visits
   (``gen_agg``'s workspaces and remat under capture). Eager and captured
   steps timed in turns (host wall and device span a step, peak memory,
   the graphs' pool, the card's idle share, a replay's SpMM kernels by
   name against the calls its capture recorded, the decode accuracy's
   cost). Then the train stage on the pipeline's mirp_bench family (28
   train LPs), 20 epochs at ``--steps_per_call 4`` and 1 in turns (4, 1, 1,
   4): stacks and singles, epoch walls, last loss, peak memory and the
   SpMM launches on the card against the printed formula (a wrapper's
   count, less the calls a capture recorded, plus those its replays ran);
   and ``--trace 1`` over 2 epochs at K=4: the trace under
   ``{log_dir}/trace`` names the SpMM kernel, and its idle share.

26. all_gather: the all-gather branch of the edge-partitioned path
   (``partition_graph(..., halo=False)``) on a bench-shape LP, K=4, every
   shard on the card. First the checks against the other routes, whose
   launches are reported apart: GCN_FC(8,8,hids=1024,depth=3)'s fp32
   logits within 1e-3 of the halo route's and the single card's, bf16 by
   the dist_zoo_serve rule; the halo route's spans; the stacked
   reduce-scatter (the partials' sum) beside K1; one fp32 step held per
   tensor to the single card's (DIST_UPDATE_SPREAD with its fp64
   witness); GENDeeper(8,8,hids=256,depth=5)'s logits against the halo
   route and the single card, one fp32 step within 1e-4 a tensor of the
   single card's. Then the path itself, its launches counted from 0 and
   read just after: GCN_FC's and GENDeeper's bf16 forwards and steps over
   the all-gather layout, their spans on the card, peak memory and
   launches exactly (a GraphConv conv 2 SpMMs a shard; a GEN conv 8
   ``gen_agg_fwd`` and 1 merge, its backward 8 ``gen_agg_bwd`` and 8
   SpMMs; no K1, no gather). Then four gloo ranks of ``chip_smoke.py
   --ag_rank`` sharing the card, shard k on rank k: rank 0's gathered
   bf16 logits against the stacked route's (bit for bit, else within
   RANK_LOGIT_TOL; the line says which), one fp32 step's weights against
   the stacked step's (bit for bit, else UPDATE_RTOL a tensor), each
   rank's launches exactly, spans, peak memory, and each gloo
   collective's ms after a barrier with its wait.
27. bench: the benchmark twins through their entry points, in this
   process: ``python -m lp_gnn_tpu_torch.bench`` at its defaults and with
   ``BENCH_MEASURE_BASELINE=1`` (the flagship's 6 traversals a step and
   edge against its SpMM launches, 2 + 4 x 25 on the card; ``value`` = E x
   6 / the fastest step; finite losses; the baseline measured live), and
   ``python -m lp_gnn_tpu_torch.bench_scaling --devices 4`` with and
   without ``--halo`` (the launches at 1, 2 and 4 shards exactly, mode
   ``one-card``, finite losses). Their JSON lines are printed.

28. native: the native C++ simplex engine (``--engine native``) on the
   flagship pipeline, through the entry points in this process. Builds
   the engine from the port's sources with g++ (timed), then
   ``run_prep_data --engine native`` on 15 of the pipeline phase's
   mirp_bench LPs (its first MPS files), ``run_train_test --engine
   native`` (the recipe, 40 epochs, ``--warm_gate auto``), and the
   analysis twins: ``engine_table`` (both engines, cold and warm, on the
   5 val LPs),
   ``decode_sweep`` over the run's ``mdl.pth`` (two of the three default
   managers: top-m and the sparsity blend), ``degeneracy_probe`` (4 LPs)
   and ``bench_partition`` (1M edges at 2 and 8 shards with ``--naive``
   and the cache). Every cold solve Optimal with a valid basis; every log
   native with its repair and factorize lines; the results table's
   repair and factorize columns on every val LP; k in [5, 12]; native and
   HiGHS objectives within 1e-6 on every val LP, no failed solve; each
   manager's bases valid; degeneracy fractions in [0, 1]; the per-pair
   halo width the fast one; ``spmm_csr`` launches exactly as printed
   (the pipeline's formula and 4 a forward of each manager's predict,
   calibration and timing passes), no other kernel. Prints the engines'
   iterations and seconds an LP, the repair and factorize means, each
   stage's seconds, the degeneracy summary, the partition cells, the
   card's nvidia-smi line and the host CPU (``lscpu``).
29. big: ``lp_gnn_tpu_torch.bench_big`` at its defaults, the twin of
   ``scripts/bench_big.py``: GCN_FC(8,8,hids=256,depth=3) bf16 trained
   full-graph on the bench graph's draws at 10^8 edges (M=262,144,
   N=524,288), 3 warm-up and 2 timed steps. Holds the SpMM's launches over
   the run exactly (2 for the input cache + 4 a step, no other kernel),
   finite losses and ``traversals_per_s`` = E x 6 / ``step_time_s``; then
   on the graph the run built, one v2c and one c2v SpMM at D=256 bf16
   against the plain version summed in fp64 (``exact_rows``: the fp32
   atomics' order moves a 1000-edge row's bf16 result by up to 2 ulps) on
   4,096 or more sampled rows (the longest
   row, rows of the tenth with the most edges), each timed beside its
   bound (its inputs read once) and, as a reference cost, one gathered
   row an edge (a miss on every edge). Prints the twin's line: step time,
   host build and upload seconds, the peak device memory the run added
   and the host's peak.
30. probe_spmm: ``lp_gnn_tpu_torch.probe_spmm`` at its defaults (the
   twin of ``scripts/probe_spmm.py``, E=1M, D=256): row and window
   gathers (``index_select`` beside the gather kernel), the transpose,
   the one-hot contractions, the blocked traversal beside ``spmm_csr`` on
   the same edges, the dense bmm; every probe's time > 0 and at most 1.05
   of its bound (above that a timing fault), the kernels' launches as the
   twin counts them.
31. probe_gen_floor: ``lp_gnn_tpu_torch.probe_gen_floor`` at its
   defaults (the twin of ``scripts/probe_gen_floor.py``): the stream,
   gather, segment max and sum floors and the gather's forward and
   backward beside one GEN direction (forward, forward + backward) and
   ``gen_agg_fwd`` / ``gen_agg_bwd`` alone; the same holds.
32. dp_edge_grid: one edge shard a rank with dp across: four processes of
   this script (``--grid_rank``) run ``train --mesh_shape dp=2,edge=2
   --edge_num_thresh 0`` on the card (gloo), rank (d, e) shard e of twin
   d. One fp32 SGD step held to the dp_edge phase's layout (2 ranks, each
   both shards of its twin) by that phase's rule; the recipe (hids=1024
   bf16, Adam, 2 epochs) with each rank's launches exact (K1's rank form
   and the gather as a dist step makes them), equal finite losses, the
   step spans, the gradient all-reduce's ms, peak memory; at the same
   time (a second launch) the 2-rank layout and ``--mesh_shape edge=2
   --graph_batch 2`` over 2 ranks, launches as counted. In every run each
   rank's final weights equal rank 0's, byte for byte.
32b. edge_hosts (its ranks started with dp_edge_grid's, its checks run
   right after that phase's): edge shards and the (dp, edge) grid over
   ranks on two hosts. Four processes of this script
   (``--host_rank``), ranks 0-1 reporting host A and 2-3 host B (each
   replaces ``mesh.host_key`` before it joins; the machine is one host,
   so the cross-host route runs over its NVLink or host copies, not a
   network). On one card the ranks share it (gloo); with 4 cards rank k
   is on card k (each host sees its own two), over NCCL; the bench shape
   either way.
   The route table (edge=4 over both hosts COLLECTIVE, a row a host the
   signalled form with 4 cards or the flags form on one, no window for
   the COLLECTIVE group); the COLLECTIVE exchange (NCCL's or gloo's
   all_to_all_single) at the bench halo, D=1024 and D=8 bf16, bit for bit
   against the stacked form's plain version, timed (with 4 cards beside
   the signalled form over the same cards as one host); the recipe's
   forward and fp32 step over edge=4 against the stacked path, launches
   exact (a conv the gather and 5 SpMMs, no K1 launch, 2 COLLECTIVE
   exchanges); one fp32 dp=2,edge=2 step, a row a host, against the
   stacked layout's step (dp_edge_grid's bound), bit for bit when
   repeated, launches exact; ``pred_basis --mesh_shape edge=4`` over both
   hosts on 2 LPs, its .bas equal to the stacked serve's byte for byte,
   its logits within 2^-6. ``python3 chip_smoke.py --edge_hosts`` runs
   only this phase.
33. dryrun_multihost (its ranks started with dp_edge_grid's): ``python -m
   lp_gnn_tpu_torch.dryrun_multihost`` at its defaults over 8 ranks on
   the card (dp=2, edge=4, one shard a rank) and ``--layout rows`` over
   2: rank 0's line each, the two losses within 1e-5 relative, each
   rank's launches exact.
34. scaling_artifact: ``python -m lp_gnn_tpu_torch.make_scaling_artifact``
   into a temp dir at bench_scaling's defaults (1, 2, 4, 8 shards on the
   card), the artifact read back: every step time > 0, the wire volume
   the CPU test pins; the all-gather mode through the twin's own
   bench_scaling subprocess, its line checked, the halo mode in this
   process with its launches bench_phase's formula.

35. edge_devices (run right after edge_ranks, on its LPs): edge shards on
   several devices of one process, K=4 shards with shard k on
   cuda:(k mod the cards), one thread and stream a shard (the layout
   the entry points take with 4 cards visible, named for the phase; on one
   card the 4 streams share it; every other phase names the stacked
   layout). Prints the distinct devices and the peer access it turned on
   (or none). K1's device form (one launch a source over its block
   pairs, the remote destinations staggered) at the bench graph's Bh,
   D=1024 and D=8 bf16: bit for bit against the stacked form and its plain
   version, 4 launches an exchange, timed (``ms``; ``device_ms`` the four
   launches' CUDA-event times summed, ``device_span_ms`` first start to
   last end on one card; the profiler's sum beside them where it saw all
   20 launches; on one card also on one stream) beside its plain version,
   the same exchange as 16 ``Tensor.copy_`` of the blocks
   (``library_ms``) and its bound (the stacked form's bytes; across cards
   the NVLink bytes). With 4 cards (``--edge_devices`` on 4 chips) also
   ``links``, the NVLink probe (each pair alone, a source's three remote
   pairs, all twelve, each source's exchange launch), and
   ``card_ranks``: K1's rank form with a rank a card (4 processes of
   ``--k1_rank``, NCCL), bit for bit, the stress and abort checks, NCCL's
   ``all_to_all_single`` of the same blocks as its library time; on one
   card both say skipped. ``pred_basis
   --mesh_shape edge=4`` on edge_ranks' 2 LPs and checkpoint (the stacked
   serve they share), its launches counted from 0 exactly
   (a conv 4 send-row gathers, 2 exchanges of 4 device-form launches, 20
   SpMMs; no stacked K1), every .bas valid and equal to the stacked
   path's, the logits within 2^-6 of it, ``inf_time`` beside the stacked
   path's; one fp32 GCN_FC(8,8,hids=1024,depth=3) step (each tensor's
   update within 1e-5 of its largest) and one fp32
   GENDeeper(8,8,hids=256,depth=5) step (1e-4) against the stacked dist
   step, launches exact; GCNRand's forward over the all-gather partition
   equal to the stacked path's; the recipe's steady bf16 steps (Adam) and
   forwards, 5 each after one, host and wall ms, beside the stacked
   layout's, and each card's busy ms and idle share in one profiled step.
   ``python3 chip_smoke.py --edge_devices`` runs only this phase (on a
   machine with 4 cards, shard k on cuda:k), its stacked serve its own.
36. grid_devices (run right after edge_devices, on dp_edge's twins): dp
   and the (dp, edge) grid over the devices of one process, JAX's layout
   of ``--mesh_shape dp=2,edge=2`` with 4 cards visible (cell (d, e) on
   cuda:(2d + e mod the cards), a thread and stream a cell; on one card
   every cell on cuda:0; named for the phase as edge_devices names its
   layout). One fp32 dp=2 step on devices against ``--graph_batch 2``'s
   union step (each tensor's update within 1e-5 of its largest) and one
   fp32 grid step against the stacked layout's dp x edge step (dp_edge's
   bound), each twice from one state, bit for bit, launches exact; the
   recipe through ``train --mesh_shape dp=2,edge=2 --edge_num_thresh 0``
   (2 epochs, Adam, bf16), its launches from 0 exact (the input cache one
   row conv a graph, a step 40 SpMMs, 8 gathers, 16 device-form K1
   launches; no stacked K1, no rank form), finite losses, each card's peak
   memory; the steady bf16 grid step (5 after one) beside the stacked
   layout's, host and wall ms, each card's busy ms and idle share in one
   profiled step; ``pred_basis --mesh_shape dp=2,edge=2`` on the twins
   (served over the first 2 cells' cards), its launches exact, its .bas
   equal to the stacked serve's byte for byte, its logits within 2^-6.
   ``python3 chip_smoke.py --grid_devices`` runs only this phase; with 4
   cards also dp=4 alone (one step's parity against ``--graph_batch 4``,
   its launches and times).

37. family_table (run right after pipeline): the twin of
   ``scripts/run_family_table.sh`` in this process
   (``lp_gnn_tpu_torch.run_family_table.family_table``) on the card at a
   cut: transport and svm (the top-m and the sparsity-mult decode; svm's
   gate-off pass), 12 LPs of the demo tier, 30 epochs of the script's
   GCN_FC(8,8,hids=256,depth=3) in fp32. Per family what phase 11 checks
   (prep artifacts, cold solves Optimal, finite losses, the gate's k in
   [5, 12], a valid basis and a warm log a val LP, none rejected, the
   results columns, the run-dir logs), svm's gate-off folders and columns
   (``pred-basis-1``, ``gnn-bas-1``), and the twin's rows equal to the val
   means of each run's ``time.json``; ``spmm_csr`` launched exactly as the
   printed formula counts (summed over the families), no other kernel.
   Prints the twin's rows (one JSON line a family) and each family's
   stage seconds.

``python3 chip_smoke.py --flagship`` builds the SpMM and runs only phase
11, with the recipe's 40 LPs and 800 epochs (RESULTS.md:576-583).
``python3 chip_smoke.py --family_table`` builds the SpMM and runs only
phase 37, with the script's six families, 40 LPs and 300 epochs.

``python3 chip_smoke.py --gen_ab`` measures only the GEN aggregation of
the checkout that holds the script, for comparing two checkouts on one
card in one chip call: copy the script into the other checkout (this
mode calls ``gen_agg_fwd`` and ``gen_agg_bwd`` with no ``need_lse`` and
no ``kernel_attrs``, so it runs in a checkout without them too) and run
the two in turns (A, B, B, A). It builds the SpMM and the GEN kernels,
then prints one JSON line: ``gen_agg_fwd`` and ``gen_agg_bwd`` on the
bench graph, both directions, at D=256 and D=3 bf16, each held to its
plain version (GEN_FWD_TOL, GEN_DPRE_TOL), with its event ms
(back-to-back calls: at D=3 the host's cost a call) and device ms; a GEN
forward's span and device time by kernel (phase 5's breakdown for the
GEN arch); and a GEN training step (phase 9's). It exits 1 without a
card or on a failed check.

``python3 chip_smoke.py --host_sort`` measures only the host's part of
``GraphTensors.from_graph``: its edge orderings on the card's host, two
ways on the same edges (numpy's ``np.lexsort`` / stable ``np.argsort``,
and ``data/graph.py lex_order``, one stable torch sort of a combined
key), at bench_big's 10^8 edges and on a mirp_bench LP (``host_sort``).
It builds no kernel and prints one JSON line.

``python3 chip_smoke.py --layout_gemms`` measures only why a rank's
shard and the same shard among the stacked shards can round apart
(``layout_gemms``): the recipe's bf16 forward, stacked on the card, on a
mirp_bench LP and a bench LP, each GEMM once over the stacked rows and
once a shard, with cuBLAS's bf16 split-K partials summed in bf16
(PyTorch's default) and in fp32 (the port's), and the logits of every
Linear over all rows against the port's. It prints one JSON line.

The kernels phase also holds the halo all-to-all (K1) exactly against its
plain version at the bench graph's halo (K=4, Bh=30,056, stacked and list
forms; K=8 at its own Bh), holds the composed halo gather exactly against
its plain version and against the route it replaced (K send-row gathers
and K1), and times the SpMM and the gather at the dist path's shapes. It
holds the GEN aggregation's two kernels (``gen_agg_fwd``, ``gen_agg_bwd``)
against their plain versions on the bench graph, both directions, at D=256
bf16 and fp32 and D=3 bf16, on one dense 65,536-edge segment and on a
mirp_bench LP's structure (D=256 bf16, both directions), each
bit-identical over two calls, with the transpose SpMM of the gathers'
backward over the kernel's ``dpre``; each forward also without its lse
(``need_lse=False``: the same aggr, timed), each row with the kernel's
registers and resident CTAs an SM. At the dist GEN layer's shapes (the
bench graph at K=4, shard 0's compact CSRs) it holds both GEN kernels
again, and ``gen_lse_merge`` over the owners' rows with the slot parts K1
delivers, D=256 and D=3 fp32, against its plain version, bit-identical
over two calls. At the all-gather branch's shapes (shard 0 at K=4) it
holds the SpMM over the full v2c and full c2v CSRs (D=8 and D=1024 bf16),
both GEN kernels over all n_pad variable rows (l2r) and over n_pad
sources (r2l) at D=256 bf16, and ``gen_lse_merge`` of the 4 shards'
full-width parts of every variable row at D=256 and D=3 fp32.

Prints one JSON line per phase (each with ``ended_s``, the seconds since
the script started), then the ``{"kernels": [...]}`` line, the nvidia-smi
line, and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import filecmp
import hashlib
import importlib
import io
import json
import logging
import os
import os.path as osp
import runpy
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import scipy
import torch

from lp_gnn_tpu_torch import pipeline as port_pipeline
from lp_gnn_tpu_torch import prep as port_prep
from lp_gnn_tpu_torch import run_family_table as port_family_table
from lp_gnn_tpu_torch.config import Config
from lp_gnn_tpu_torch.data.dataset import BipartiteGraph, LPDataset
from lp_gnn_tpu_torch.data.generator import SIZES, generate_instance
from lp_gnn_tpu_torch.data.graph import GraphTensors
from lp_gnn_tpu_torch.data.sampling import sample_subgraphs
from lp_gnn_tpu_torch.data.stacking import stack_key
from lp_gnn_tpu_torch.infer.decode import (inference_gnn,
                                           parse_inference_manager)
from lp_gnn_tpu_torch.infer.predict import model_inference
from lp_gnn_tpu_torch.io.bas import read_bas_highs
from lp_gnn_tpu_torch.models.gcn import build_model
from lp_gnn_tpu_torch.ops import _build
from lp_gnn_tpu_torch.ops._build import launch_on
from lp_gnn_tpu_torch.ops import gen_agg as gen_agg_mod
from lp_gnn_tpu_torch.ops import spmm as spmm_mod
from lp_gnn_tpu_torch.ops.gather import gather_rows, gather_rows_plain
from lp_gnn_tpu_torch.ops.gen_agg import (gen_agg_bwd, gen_agg_bwd_plain,
                                          gen_agg_fwd, gen_agg_fwd_plain,
                                          gen_lse_merge, gen_lse_merge_plain)
from lp_gnn_tpu_torch.ops.spmm import (attach_input_agg, spmm_cons_to_vars,
                                       spmm_csr, spmm_csr_plain,
                                       spmm_vars_to_cons)
from lp_gnn_tpu_torch.parallel import edge_partition
from lp_gnn_tpu_torch.parallel import halo as halo_mod
from lp_gnn_tpu_torch.parallel.halo import (halo_all_to_all,
                                            halo_all_to_all_devices,
                                            halo_all_to_all_plain,
                                            halo_all_to_all_ranks,
                                            halo_all_to_all_ranks_plain,
                                            halo_rank_signalled)
from lp_gnn_tpu_torch.parallel import mesh as mesh_mod
from lp_gnn_tpu_torch.parallel.mesh import (make_device_grid, make_mesh,
                                            shard_devices)
from lp_gnn_tpu_torch.reporting.extract import extract_time
from lp_gnn_tpu_torch.solver import highs_bridge
from lp_gnn_tpu_torch.train import scan as scan_mod
from lp_gnn_tpu_torch.train import trainer
from lp_gnn_tpu_torch.train.losses import LOSS_REGISTRY
from lp_gnn_tpu_torch.utils.log import run_dir_logs
from lp_gnn_tpu_torch.utils.serialize import json_load, msgpack_dump

T_START = time.perf_counter()
# bench shape (bench.py:58-60)
E, M, N = 1_000_000, 65_536, 131_072
HBM_BYTES_S = 3.35e12       # H100 SXM device memory rate
FP32_FLOP_S = 67e12         # H100 SXM fp32 rate outside the tensor cores
ARCH = "GCN_FC(8,8,hids=1024,depth=3)"
SPMM_PER_FORWARD = 4        # (conv1 + 1 hidden conv) x 2 directions
N_LPS = 6                   # LPs served
FORWARDS_PER_LP = 5         # predict pass 1 + timing warm-up 1 + timed 3
K_EDGE = 4                  # shards of the edge-partitioned path
N_DIST_LPS = 3              # LPs served edge-partitioned
# launches a dist forward makes, per conv (2 a forward): one gather over
# the composed halo index (the gather direction, its all-to-all folded into
# the index); one stacked all-to-all (the reduce direction); K x 5 SpMMs
# (local v2c, local c2v, halo v2c, halo c2v, owner-side reduce)
DIST_PER_FORWARD = {"halo_all_to_all": 2, "gather_rows": 2,
                    "spmm_csr": 2 * K_EDGE * 5}
KERNELS = (spmm_csr, gather_rows, halo_all_to_all, gen_agg_fwd, gen_agg_bwd,
           gen_lse_merge, halo_all_to_all_ranks, halo_all_to_all_devices,
           halo_rank_signalled)
N_TRAIN_LPS = 4             # LPs written for training: 2 train, 2 val
TRAIN_EPOCHS = 5            # one val pass, after the last epoch
# spmm_csr launches of the train phase: 2 a train graph once (the input
# aggregation cache), 4 a step (the hidden conv's 2 forward, 2 backward;
# conv1 reads the cache and its inputs take no gradient), 4 a val forward
SPMM_PER_STEP = 4
# the pipeline phase: the recipe's family (RESULTS.md:576-579, mirp_like at
# --size bench, 40 instances: 28 train, 12 val), cut to 30 (21 train, 9
# val) and 20 epochs for the script's time; --flagship runs the recipe's
# 40 for its 800
N_PIPE_LPS = 30
FLAGSHIP_LPS = 40
PIPE_EPOCHS = 20
FLAGSHIP_EPOCHS = 800
# the GEN phases: the JAX package's GENDeeper bench arch (bench.py:61-73,
# 193-195); 5 convs x 2 directions a forward
GEN_ARCH = "GENDeeper(8,8,hids=256,depth=5,dtype='bfloat16',remat=True)"
GEN_PER_FORWARD = 10
N_GEN_LPS = 3
GEN_EPOCHS = 2
# launches a GEN step: the forward, remat's recompute of every conv, one
# backward a direction and one SpMM a direction (the gather's backward);
# no input cache
GEN_PER_STEP = {"gen_agg_fwd": 2 * GEN_PER_FORWARD,
                "gen_agg_bwd": GEN_PER_FORWARD, "spmm_csr": GEN_PER_FORWARD}
# the rest of the zoo at the GEN phases' width: SpMM launches a forward
ZOO_SERVE = {"GCN(8,8,hids=256)": 6, "GCNDeeper(8,8,hids=256,depth=5)": 10,
             "GCNRand()": 0}
N_ZOO_LPS = 2


class SmokeFailure(Exception):
    pass


def emit(obj) -> None:
    """One JSON line; a phase's line also says when the phase ended
    (``ended_s``, seconds since the script started): the differences are
    each phase's wall time, what a trim of the script reads."""
    if "phase" in obj:
        obj = {**obj, "ended_s": time.perf_counter() - T_START}
    sys.stdout.write(json.dumps(obj) + "\n")   # one write: threads emit too
    sys.stdout.flush()


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if res.returncode != 0 or not res.stdout.strip():
        raise SmokeFailure(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip()


def bench_graph(seed: int, m: int = 0, n: int = 0, e: int = 0) -> BipartiteGraph:
    """The bench.py:91-111 graph (bench shape unless m, n, e are given):
    near-uniform rows with 10% of the edges on the first m/16 rows."""
    m, n, e = m or M, n or N, e or E
    rng = np.random.RandomState(seed)
    row = rng.randint(0, m, e).astype(np.int32)
    hot = rng.rand(e) < 0.1
    row[hot] = rng.randint(0, max(m // 16, 1), hot.sum()).astype(np.int32)
    col = rng.randint(0, n, e).astype(np.int32)
    val = rng.rand(e).astype(np.float32) - 0.5
    c_feas = rng.rand(m, 8).astype(np.float32) - 0.5
    v_feas = rng.rand(n, 8).astype(np.float32) - 0.5
    for fe in (c_feas, v_feas):
        fe[:, -3] = rng.randint(-1, 2, fe.shape[0])
        fe[:, -1] = rng.randint(-1, 2, fe.shape[0])
    order = np.lexsort((col, row))
    return BipartiteGraph(row=row[order], col=col[order], val=val[order],
                          c_feas=c_feas, v_feas=v_feas,
                          y_s=rng.randint(0, 3, m).astype(np.int32),
                          y_t=rng.randint(0, 3, n).astype(np.int32))


def time_ms(fn, iters: int, warm: int = 2) -> float:
    """Device time of one call: CUDA events around ``iters`` back-to-back
    calls after ``warm`` untimed ones."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def kernel_iters(d: int) -> int:
    """Calls a kernel case is timed over: at D=8 back-to-back calls are
    bound by the host and vary from call to call, so 200; else 20."""
    return 200 if d == 8 else 20


def profile_kernels(fn, calls: int, want: dict[str, int],
                    tries: int = 3) -> tuple[dict, bool]:
    """Device time (ms) and launch count of each CUDA kernel over ``calls``
    calls of ``fn``, from ``torch.profiler``, by name. The profiler can drop
    the kernels launched as it starts, so it records a second round of
    ``calls`` after an unrecorded warm-up round, and runs again (up to
    ``tries`` times) until every kernel named in ``want`` (a part of its
    name -> launches) was seen that often; also returns whether it was."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        rounds = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        with torch.profiler.profile(activities=acts, schedule=rounds) as prof:
            for _ in range(2):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        seen: dict[str, list] = {}
        for e in prof.key_averages():
            # the round's own span on the card is no kernel, nor is that
            # of a region the K-step call annotates (train/scan.py)
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.key.startswith(("ProfilerStep", "scan_"))):
                tn = seen.setdefault(e.key, [0.0, 0])
                tn[0] += (getattr(e, "self_device_time_total", 0) or 0) / 1e3
                tn[1] += e.count
        complete = all(sum(n for k, (_, n) in seen.items() if name in k) == want_n
                       for name, want_n in want.items())
        if complete:
            break
    return seen, complete


def kernel_device_ms(fn, kernel: str, iters: int = 5,
                     per_call: int = 1) -> float | None:
    """The kernel's own CUDA time a call of ``fn`` (``per_call`` launches
    each) over ``iters`` calls (None where the profiler did not see every
    launch). Beside the event-timed ``ms`` it shows what the kernel itself
    takes where back-to-back calls are bound by the host."""
    fn()
    torch.cuda.synchronize()
    seen, complete = profile_kernels(fn, iters, {kernel: iters * per_call})
    if not complete:
        return None
    return sum(t for k, (t, _) in seen.items() if kernel in k) / iters


def bound(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = n_flops / FP32_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def within(out: torch.Tensor, ref: torch.Tensor, rtol: float, atol: float):
    """max |out - ref| and whether |out - ref| <= atol + rtol |ref| holds."""
    diff = (out.float() - ref.float()).abs()
    ok = bool((diff <= atol + rtol * ref.float().abs()).all())
    return float(diff.max()) if diff.numel() else 0.0, ok


# ------------------------------------------------------------------ kernels
SPMM_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2 ** -7, 1e-5)}


def spmm_case(case: str, ptr, idx, val, x, on_path) -> dict:
    """One SpMM case against its plain version, timed beside it and beside
    the library yardstick (cuSPARSE through ``torch.sparse.mm``), which the
    package never calls."""
    n_dst, n_e, d = ptr.shape[0] - 1, idx.shape[0], x.shape[1]
    out = spmm_csr(ptr, idx, val, x)
    again = spmm_csr(ptr, idx, val, x)
    ref = spmm_csr_plain(ptr, idx, val, x)
    torch.cuda.synchronize()
    rtol, atol = SPMM_TOL[x.dtype]
    err, ok = within(out, ref, rtol, atol)
    if not ok:
        raise SmokeFailure(f"spmm_csr {case}: max |err| {err} "
                           f"beyond rtol={rtol}, atol={atol}")
    bits = torch.int32 if x.dtype == torch.float32 else torch.int16
    if not torch.equal(out.view(bits), again.view(bits)):
        raise SmokeFailure(f"spmm_csr {case}: two calls differ (the kernel "
                           "must be deterministic)")
    del out, again, ref
    b = x.element_size()
    plan = spmm_mod.width_plan(d, b)
    s_used = int(torch.unique(idx).numel())
    n_bytes = (n_dst + 1) * 4 + n_e * 8 + s_used * d * b + n_dst * d * b
    bound_ms, bound_by = bound(n_bytes, 2.0 * n_e * d)
    noreuse = (n_dst + 1) * 4 + n_e * 8 + n_e * d * b + n_dst * d * b
    a = torch.sparse_csr_tensor(ptr, idx, val.to(x.dtype),
                                size=(n_dst, x.shape[0]), check_invariants=False)
    return {
        "name": "spmm_csr", "route": "cuda",
        "source": "lp_gnn_tpu_torch/ops/csrc/spmm.cu",
        "replaces": "lp_gnn_tpu/ops/spmm.py:77",
        "launches": None, "max_abs_err": err,
        "ms": time_ms(lambda: spmm_csr(ptr, idx, val, x), kernel_iters(d)),
        "device_ms": kernel_device_ms(lambda: spmm_csr(ptr, idx, val, x),
                                      "spmm_csr_kernel",
                                      per_call=len(plan.slabs)),
        "plain_ms": time_ms(lambda: spmm_csr_plain(ptr, idx, val, x), 5),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": time_ms(lambda: torch.sparse.mm(a, x), kernel_iters(d) // 2),
        "case": case, "on_path": on_path,
        "num_dst": n_dst, "num_src": x.shape[0], "nnz": n_e, "D": d,
        "tol": {"rtol": rtol, "atol": atol},
        "bound_noreuse_ms": noreuse / HBM_BYTES_S * 1e3,
        "library": "torch.sparse.mm on a sparse CSR tensor",
        "launches_per_call": len(plan.slabs), "padded_width": plan.padded,
    }


def check_spmm(gt: GraphTensors, gen: torch.Generator) -> list[dict]:
    """SpMM vs its plain version on the card, both directions, D=8 and
    D=1024, fp32 and bf16. fp32: rtol 1e-4, atol 1e-5 (summation order).
    bf16: one bf16 ulp (rtol 2^-7) of the plain result, which sums in fp32
    and casts, plus atol 1e-5 for fp32 order differences on sums near 0."""
    dirs = {"v2c": (gt.rowptr, gt.col, gt.val_r, gt.nvars),
            "c2v": (gt.colptr, gt.row, gt.val_c, gt.ncons)}
    rows = []
    for dname, (ptr, idx, val, n_src) in dirs.items():
        for d in (8, 1024):
            x32 = torch.randn(n_src, d, generator=gen, device=gt.device)
            for dt in (torch.float32, torch.bfloat16):
                rows.append(spmm_case(
                    f"{dname} D={d} {str(dt).split('.')[-1]}", ptr, idx, val,
                    x32.to(dt), "serve" if dt == torch.bfloat16 else False))
    return rows


# widths JAX's blocked_spmm takes that the kernel once refused: ragged
# (through padded copies) and above 256 16-byte pieces (column slabs)
SPMM_WIDTHS = ((3, torch.float32), (1028, torch.float32),
               (100, torch.bfloat16), (2056, torch.bfloat16),
               (4104, torch.bfloat16))


def check_spmm_widths(gt: GraphTensors, gen: torch.Generator) -> list[dict]:
    """The SpMM at SPMM_WIDTHS on the bench graph's v2c, each against its
    plain version (SPMM_TOL), bit-identical over two calls, a launch a
    256-piece column slab."""
    rows = []
    for d, dt in SPMM_WIDTHS:
        x = torch.randn(gt.nvars, d, generator=gen, device=gt.device).to(dt)
        rows.append(spmm_case(f"width v2c D={d} {str(dt).split('.')[-1]}",
                              gt.rowptr, gt.col, gt.val_r, x, False))
        del x
    return rows


def mirp_bench_graph(seed: int) -> BipartiteGraph:
    """The structure of the pipeline's LPs: instance 0 of the recipe's
    family (``mirp_like --size bench`` from ``seed``: 1,860 rows, 21,780
    columns, 55,902 nonzeros), its values scaled into [-1, 1], random
    features."""
    lp = generate_instance("mirp_like", seed, 0, **SIZES["mirp_like"]["bench"])
    a = lp.A.tocoo()
    order = np.lexsort((a.col, a.row))
    m, n = lp.A.shape
    rng = np.random.RandomState(seed)
    val = a.data[order] / np.abs(a.data).max()
    return BipartiteGraph(
        row=a.row[order].astype(np.int32), col=a.col[order].astype(np.int32),
        val=val.astype(np.float32),
        c_feas=rng.rand(m, 8).astype(np.float32) - 0.5,
        v_feas=rng.rand(n, 8).astype(np.float32) - 0.5,
        y_s=np.zeros(m, np.int32), y_t=np.zeros(n, np.int32))


def check_spmm_pipeline(seed: int, gen: torch.Generator) -> list[dict]:
    """The SpMM at the pipeline's shapes (a mirp_bench LP, bf16): D=8 as
    the input aggregation cache runs it, D=1024 as the hidden conv does,
    both directions (the c2v case is also the v2c backward's shape)."""
    gt = GraphTensors.from_graph(mirp_bench_graph(seed), "cuda")
    dirs = {"v2c": (gt.rowptr, gt.col, gt.val_r, gt.nvars),
            "c2v": (gt.colptr, gt.row, gt.val_c, gt.ncons)}
    rows = []
    for dname, (ptr, idx, val, n_src) in dirs.items():
        for d in (8, 1024):
            x = torch.randn(n_src, d, generator=gen, device="cuda")
            rows.append(spmm_case(f"mirp_bench {dname} D={d} bfloat16", ptr,
                                  idx, val, x.to(torch.bfloat16), "pipeline"))
    return rows


def csr_of(counts: np.ndarray, n_src: int, rng: np.random.RandomState,
           positive: bool):
    """ptr, idx, val on the card for rows of ``counts`` edges from uniform
    sources; val in [0.5, 1) if ``positive``, else in [-0.5, 0.5)."""
    ptr = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=ptr[1:])
    idx = rng.randint(0, n_src, int(ptr[-1])).astype(np.int32)
    val = rng.rand(int(ptr[-1])).astype(np.float32)
    val = val * 0.5 + 0.5 if positive else val - 0.5
    return (torch.from_numpy(a).cuda() for a in (ptr.astype(np.int32), idx, val))


def check_spmm_shapes(gen: torch.Generator,
                      rng: np.random.RandomState) -> list[dict]:
    """The SpMM at D=1024 bf16 off the bench graph, under SPMM_TOL: one
    dense row of 65,536 edges among 1,023 rows of 0-8 edges, from the v2c
    source count (x 268 MB, read in slabs), with positive terms (val in
    [0.5, 1), x in [0, 1)) so that its fp32 sums in two orders differ by far
    less than a bf16 ulp, as they would not where 65,536 terms cancel to
    near 0; and a graph of the bench degree whose x fits L2 whole (S=8192,
    16.8 MB; M=65,536 rows, E=1M)."""
    counts = rng.randint(0, 9, 1024)
    counts[512] = 65_536
    ptr, idx, val = csr_of(counts, N, rng, True)
    x = torch.rand(N, 1024, generator=gen, device="cuda").to(torch.bfloat16)
    rows = [spmm_case("dense row 65536 edges S=131072 D=1024 bfloat16",
                      ptr, idx, val, x, False)]
    del x
    counts = np.bincount(rng.randint(0, M, E), minlength=M)
    ptr, idx, val = csr_of(counts, 8192, rng, False)
    x = torch.randn(8192, 1024, generator=gen, device="cuda").to(torch.bfloat16)
    rows.append(spmm_case("x in L2 S=8192 M=65536 E=1M D=1024 bfloat16",
                          ptr, idx, val, x, False))
    return rows


def spmm_backward_case(gt: GraphTensors, direction: str,
                       gen: torch.Generator) -> dict:
    """The SpMM's backward at D=1024 bf16 on the bench graph:
    ``torch.autograd.grad`` through ``SpmmCSR`` (the kernel over the
    transpose ordering, one launch a backward), bit-identical over two
    calls, under SPMM_TOL against the same through ``spmm_csr_plain`` on
    fp32 copies of x and the gradient, rounded to bf16 once, and against
    the wrapper's plain version of the launch (``spmm_csr_plain`` over the
    transpose, which the backward runs on a CPU tensor; ``plain_ms``).
    Autograd through the plain version in bf16 scatters bf16 messages with
    a bf16 ``index_add_``, summing in bf16: its error against the fp32
    reference is reported beside the kernel's, not held. The library
    yardstick is ``torch.sparse.mm`` on the transpose CSR."""
    if direction == "v2c":
        fwd, n_src, n_dst = spmm_vars_to_cons, gt.nvars, gt.ncons
        own = (gt.rowptr, gt.col, gt.val_r)
        tr = (gt.colptr, gt.row, gt.val_c)
    else:
        fwd, n_src, n_dst = spmm_cons_to_vars, gt.ncons, gt.nvars
        own = (gt.colptr, gt.row, gt.val_c)
        tr = (gt.rowptr, gt.col, gt.val_r)
    d, dt = 1024, torch.bfloat16
    x = torch.randn(n_src, d, generator=gen, device="cuda").to(dt)
    w = torch.randn(n_dst, d, generator=gen, device="cuda").to(dt)
    x.requires_grad_()
    out = fwd(gt, x)

    def grad():
        return torch.autograd.grad(out, x, w, retain_graph=True)[0]

    def grad_plain(xp, wp):
        return torch.autograd.grad(spmm_csr_plain(*own, xp), xp, wp)[0]

    before = spmm_csr.launches
    got = grad()
    launches = spmm_csr.launches - before
    again = grad()
    ref = grad_plain(x.detach().float().requires_grad_(), w.float()).to(dt)
    plain = spmm_csr_plain(*tr, w)
    autograd16 = grad_plain(x.detach().clone().requires_grad_(), w)
    torch.cuda.synchronize()
    if launches != 1:
        raise SmokeFailure(f"spmm backward {direction}: {launches} launches "
                           "a backward, expected 1")
    rtol, atol = SPMM_TOL[dt]
    err, ok = within(got, ref, rtol, atol)
    err_plain, ok_plain = within(got, plain, rtol, atol)
    if not (ok and ok_plain):
        raise SmokeFailure(f"spmm backward {direction}: max |err| {err} "
                           f"against the fp32 gradient, {err_plain} against "
                           f"the plain launch, beyond rtol={rtol}, atol={atol}")
    if not torch.equal(got.view(torch.int16), again.view(torch.int16)):
        raise SmokeFailure(f"spmm backward {direction}: two calls differ")
    err16 = float((autograd16.float() - ref.float()).abs().max())
    del got, again, ref, plain, autograd16
    t_ptr, t_idx, t_val = tr
    n_e = t_idx.shape[0]
    s_used = int(torch.unique(t_idx).numel())
    n_bytes = (n_src + 1) * 4 + n_e * 8 + s_used * d * 2 + n_src * d * 2
    bound_ms, bound_by = bound(n_bytes, 2.0 * n_e * d)
    a_t = torch.sparse_csr_tensor(t_ptr, t_idx, t_val.to(dt),
                                  size=(n_src, n_dst), check_invariants=False)
    row = {
        "name": "spmm_csr", "route": "cuda",
        "source": "lp_gnn_tpu_torch/ops/csrc/spmm.cu",
        "replaces": "lp_gnn_tpu/ops/spmm.py:172",
        "launches": None, "max_abs_err": err,
        "ms": time_ms(grad, kernel_iters(d)),
        "device_ms": kernel_device_ms(grad, "spmm_csr_kernel"),
        "plain_ms": time_ms(lambda: spmm_csr_plain(*tr, w), 5),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": time_ms(lambda: torch.sparse.mm(a_t, w),
                              kernel_iters(d) // 2),
        "case": f"backward of {direction} D=1024 bfloat16", "on_path": "train",
        "launches_per_backward": launches, "max_abs_err_vs_plain": err_plain,
        "plain_autograd_bf16_max_abs_err": err16,
        "reference": "autograd through spmm_csr_plain in fp32, rounded to "
                     "bf16 once",
        "num_dst": n_src, "num_src": n_dst, "nnz": n_e, "D": d,
        "tol": {"rtol": rtol, "atol": atol},
        "also_replaces": ["lp_gnn_tpu/ops/spmm.py:61"],
        "library": "torch.sparse.mm on the transpose as a sparse CSR tensor",
    }
    del out, x, w, a_t
    torch.cuda.empty_cache()
    return row


def check_spmm_backward(gt: GraphTensors, gen: torch.Generator) -> list[dict]:
    return [spmm_backward_case(gt, dname, gen) for dname in ("v2c", "c2v")]


def gather_case(case: str, table, idx, on_path, schedule=None) -> dict:
    """One gather case against its plain version (exact: a copy);
    ``schedule`` as ``gather_rows`` takes it."""
    out = gather_rows(table, idx, schedule=schedule)
    ref = gather_rows_plain(table, idx)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    if not torch.equal(out, ref):
        raise SmokeFailure(f"gather_rows {case}: differs from the plain "
                           f"version (max |err| {err})")
    del out, ref
    k, d, b = idx.shape[0], table.shape[1], table.element_size()
    s_used = int(torch.unique(idx).numel())
    bound_ms, bound_by = bound(k * 4 + s_used * d * b + k * d * b, 0.0)
    return {
        "name": "gather_rows", "route": "cuda",
        "source": "lp_gnn_tpu_torch/ops/csrc/gather.cu",
        "replaces": "scripts/probe_vmem_gather.py:51",
        "launches": None, "max_abs_err": err,
        "ms": time_ms(lambda: gather_rows(table, idx, schedule=schedule),
                      kernel_iters(d)),
        "device_ms": kernel_device_ms(
            lambda: gather_rows(table, idx, schedule=schedule),
            "gather_rows_kernel"),
        "plain_ms": time_ms(lambda: gather_rows_plain(table, idx), 20),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": time_ms(lambda: torch.index_select(table, 0, idx),
                              kernel_iters(d)),
        "case": case, "on_path": on_path,
        "also_replaces": ["scripts/probe_vmem_gather.py:72",
                          "scripts/probe_vmem_gather2.py:54",
                          "scripts/probe_vmem_gather2.py:60"],
        "num_src": table.shape[0], "K": k, "D": d,
        "schedule_ranges": 0 if schedule is None else schedule.shape[0],
        "tol": "exact",
        "bound_noreuse_ms": (k * 4 + 2 * k * d * b) / HBM_BYTES_S * 1e3,
        "library": "torch.index_select",
    }


def check_gather(gt: GraphTensors, gen: torch.Generator,
                 rng: np.random.RandomState) -> list[dict]:
    """Gather vs its plain version at the probes' shapes
    (scripts/probe_vmem_gather*.py: S=8192 and S=131,072, E=2^20, D=256
    bf16) and at the SpMM's (the v2c index stream, E=1M, D=1024 bf16)."""
    dev = gt.device
    cases = []
    for s in (8192, 131_072):
        idx = torch.from_numpy(rng.randint(0, s, 1 << 20).astype(np.int32)).to(dev)
        cases.append((f"probe S={s} K=2^20 D=256 bf16", s, 256, idx))
    cases.append(("spmm v2c S=131072 K=1M D=1024 bf16", gt.nvars, 1024, gt.col))
    return [gather_case(case, torch.randn(s, d, generator=gen, device=dev)
                        .to(torch.bfloat16), idx, False)
            for case, s, d, idx in cases]


def halo_case(case: str, k: int, bh: int, d: int, dtype, gen,
              stacked: bool) -> dict:
    """K1 against its plain version on the card, exactly (a copy), on K
    buffers held stacked in one (K, K*Bh, D) tensor, passed as that tensor
    (the stacked form, which the path runs) or as its K views (the list
    form); the two forms must agree. The library yardstick swaps the
    stacked blocks' two shard axes with one ``contiguous()``."""
    stacked_in = torch.randn(k, k * bh, d, generator=gen, device="cuda").to(dtype)
    arg = stacked_in if stacked else list(stacked_in.unbind(0))
    out = halo_all_to_all(arg)
    other = halo_all_to_all(list(stacked_in.unbind(0)) if stacked else stacked_in)
    ref = halo_all_to_all_plain(stacked_in)
    torch.cuda.synchronize()
    out = out if stacked else torch.stack(out)
    other = torch.stack(other) if stacked else other
    if not (torch.equal(out, ref) and torch.equal(other, ref)):
        raise SmokeFailure(f"halo_all_to_all {case}: differs from the plain "
                           "version or between its two forms")
    lib = stacked_in.view(k, k, bh, d).transpose(0, 1).contiguous()
    if not torch.equal(out.view(k, k, bh, d), lib):
        raise SmokeFailure(f"halo_all_to_all {case}: differs from the "
                           "stacked transpose")
    del out, other, ref, lib
    n_bytes = 2.0 * k * k * bh * d * stacked_in.element_size()
    bound_ms, bound_by = bound(n_bytes, 0.0)
    row = {
        "name": "halo_all_to_all", "route": "cuda",
        "source": "lp_gnn_tpu_torch/ops/csrc/halo_a2a.cu",
        "replaces": "lp_gnn_tpu/parallel/pallas_halo.py:39",
        "launches": None, "max_abs_err": 0.0,
        "ms": time_ms(lambda: halo_all_to_all(arg), kernel_iters(d)),
        "device_ms": kernel_device_ms(lambda: halo_all_to_all(arg),
                                      "halo_a2a_kernel"),
        "plain_ms": time_ms(lambda: halo_all_to_all_plain(arg), 10),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": time_ms(lambda: stacked_in.view(k, k, bh, d)
                              .transpose(0, 1).contiguous(), kernel_iters(d)),
        "case": case, "form": "stacked" if stacked else "list",
        "on_path": "dist_serve" if (stacked and k == K_EDGE
                                    and dtype == torch.bfloat16) else False,
        "K": k, "Bh": bh, "D": d, "tol": "exact", "bytes": n_bytes,
        "also_replaces": ["lp_gnn_tpu/parallel/pallas_halo.py:69"],
        "library": "stacked.view(K,K,Bh,D).transpose(0,1).contiguous()",
    }
    del stacked_in, arg
    torch.cuda.empty_cache()
    return row


def composed_gather_case(dg, dt_, d: int, gen) -> dict:
    """The gather direction of the dist path as the path runs it: one
    gather over the composed halo index into the K stacked halo buffers
    (S = K*ns table rows, K*K*Bh output rows), in the order the path picks
    (the halo schedule where the table is larger than L2, else rows in
    order), exact against its plain version. Beside it, on the same inputs:
    the launch in each of the two orders; the route it replaced, K send-row
    gathers and one all-to-all (K1), which must give the same buffers; and
    ``torch.index_select`` on the composed index (the row's library
    yardstick)."""
    k = dg.n_shards
    right = torch.randn(k * dg.ns, d, generator=gen,
                        device="cuda").to(torch.bfloat16)
    idx = dt_.halo_src.view(-1)
    sched = edge_partition.pick_halo_schedule(right, dt_.halo_sched)
    row = gather_case(f"dist composed halo gather S={k * dg.ns} "
                      f"K={idx.shape[0]} D={d} bfloat16", right, idx,
                      "dist_serve", sched)
    sends = [torch.from_numpy(s.reshape(-1)).cuda() for s in dg.halo_send]
    shards = right.split(dg.ns)

    def gather_then_k1():
        return halo_all_to_all([gather_rows(x, s) for x, s in zip(shards, sends)])

    got = edge_partition.halo_gather(right, dt_.halo_src, dt_.halo_sched)
    if not torch.equal(got, torch.stack(gather_then_k1())):
        raise SmokeFailure("composed halo gather differs from the send-row "
                           "gathers followed by the all-to-all")
    del got
    for order, sc in (("row_order", None), ("scheduled", dt_.halo_sched)):
        row[f"{order}_ms"] = time_ms(lambda: gather_rows(right, idx, schedule=sc),
                                     kernel_iters(d))
        row[f"{order}_device_ms"] = kernel_device_ms(
            lambda: gather_rows(right, idx, schedule=sc), "gather_rows_kernel")
    row["gather_then_k1_ms"] = time_ms(gather_then_k1, kernel_iters(d))
    row["replaced_route"] = (f"{k} gather_rows of the send rows + one "
                             "halo_all_to_all (list form)")
    return row


def check_dist_kernels(g: BipartiteGraph, gen: torch.Generator) -> list[dict]:
    """The three kernels at the edge-partitioned path's shapes on the bench
    graph: K1 at K=4 (the path's Bh) in its stacked form (bf16, as the path
    runs it) and its list form, and at K=8 (its own Bh), D=8 and D=1024;
    the composed halo gather; shard 0's five SpMMs (the largest shard: the
    hot rows land there) and its send-row gather, at D=8 and D=1024
    bf16."""
    rows = []
    bh8 = edge_partition.compute_halo_width(g, 8)
    dg = edge_partition.partition_graph(g, K_EDGE, halo=True)
    for d in (8, 1024):
        rows.append(halo_case(f"stacked K={K_EDGE} Bh={dg.bh} D={d} bfloat16",
                              K_EDGE, dg.bh, d, torch.bfloat16, gen, True))
        for dt in (torch.float32, torch.bfloat16):
            rows.append(halo_case(f"K={K_EDGE} Bh={dg.bh} D={d} "
                                  f"{str(dt).split('.')[-1]}",
                                  K_EDGE, dg.bh, d, dt, gen, False))
        rows.append(halo_case(f"K=8 Bh={bh8} D={d} bfloat16", 8, bh8, d,
                              torch.bfloat16, gen, False))
    dt_ = edge_partition.DistGraphTensors.from_partition(
        dg, make_mesh(K_EDGE, "cuda"))
    csrs = {"local v2c": (dt_.local_v2c[0], dg.ns),
            "local c2v": (dt_.local_c2v[0], dg.ms),
            "halo v2c": (dt_.halo_v2c[0], dg.nh),
            "halo c2v": (dt_.halo_c2v[0], dg.ms),
            "owner reduce": (dt_.halo_red[0], dg.nh)}
    send0 = torch.from_numpy(dg.halo_send[0].reshape(-1)).cuda()
    for d in (8, 1024):
        for name, (m, n_src) in csrs.items():
            x = torch.randn(n_src, d, generator=gen, device="cuda")
            rows.append(spmm_case(f"dist shard 0 {name} D={d} bfloat16", *m,
                                  x.to(torch.bfloat16), "dist_serve"))
        rows.append(composed_gather_case(dg, dt_, d, gen))
        table = torch.randn(dg.ns, d, generator=gen, device="cuda")
        rows.append(gather_case(
            f"dist shard 0 halo_send S={dg.ns} K={dg.nh} D={d} bfloat16",
            table.to(torch.bfloat16), send0, False))
    return rows


def gather_floor(kernels: list[dict]) -> dict:
    """The SpMM beside the cost of its own row gather (the v2c index stream,
    D=1024 bf16): the floor is the faster of the gather kernel and
    ``torch.index_select`` on the same rows."""
    spmm = next(k for k in kernels if k["name"] == "spmm_csr"
                and k["case"] == "v2c D=1024 bfloat16")
    gat = next(k for k in kernels if k["name"] == "gather_rows"
               and k["case"].startswith("spmm v2c"))
    by = ("gather_rows" if gat["ms"] <= gat["library_ms"]
          else "torch.index_select")
    return {"spmm_ms": spmm["ms"], "gather_rows_ms": gat["ms"],
            "index_select_ms": gat["library_ms"],
            "floor_ms": min(gat["ms"], gat["library_ms"]), "floor_by": by}


# -------------------------------------------------------------- GEN kernels
# gen_agg on the card against its plain version (the reasons beside the
# same limits in tests/test_torch_kernels.py): the forward in fp32 and, in
# bf16, against the plain version's bf16 roundings (JAX's) and against the
# plain version in fp32 on the same bf16-valued inputs (the kernel's own
# arithmetic, held at the fp32 limits), every fp32 rtol at least 2^-24 L
# for a longest segment of L edges (its sums of L positive terms, in two
# orders); the backward's dpre, and its sums
# dw, db within GEN_SUM_RTOL (or 2^-24 L) of the sum of their terms'
# magnitudes, dt of |dt| + 1
GEN_FWD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2 ** -6, 2 ** -5)}
GEN_DPRE_TOL = {torch.float32: (1e-4, 1e-6), torch.bfloat16: (2 ** -7, 1e-6)}
GEN_SUM_RTOL = 1e-5
# fp32 operations an (edge, channel): forward (encoder fma, add, relu,
# eps, t, the online update's exp, fma and compare) and backward (the
# same message, exp, the dm product, the mask, three sums)
GEN_FWD_OPS, GEN_BWD_OPS = 10, 20


def gen_operands(n_src: int, d: int, dt, gen) -> tuple:
    """x (n_src, d) and the encoder w, b and t (its init, 1) of one GEN
    direction, in dt."""
    x = torch.randn(n_src, d, generator=gen, device="cuda").to(dt)
    w = torch.randn(d, generator=gen, device="cuda").to(dt)
    b = (torch.randn(d, generator=gen, device="cuda") * 0.3).to(dt)
    return x, w, b, torch.ones((), device="cuda").to(dt)


def gen_fwd_case(case: str, args: tuple, on_path) -> tuple[dict, torch.Tensor,
                                                            torch.Tensor]:
    """gen_agg_fwd against its plain version (GEN_FWD_TOL), bit-identical
    over two calls; returns the row, aggr and lse."""
    ptr, src, a, x = args[:4]
    dt, d = x.dtype, x.shape[1]
    aggr, lse = gen_agg_fwd(*args)
    aggr2, lse2 = gen_agg_fwd(*args)
    want, want_lse = gen_agg_fwd_plain(*args)
    exact = gen_agg_fwd_plain(ptr, src, a.to(dt).float(),
                              *(v.float() for v in args[3:]))
    torch.cuda.synchronize()
    if not (torch.equal(aggr, aggr2) and torch.equal(lse, lse2)):
        raise SmokeFailure(f"gen_agg_fwd {case}: two calls differ")
    full = ptr[1:] > ptr[:-1]
    longest = int((ptr[1:] - ptr[:-1]).max())
    x_rtol = max(1e-4, 2 ** -24 * longest)
    rtol, atol = GEN_FWD_TOL[dt]
    rtol = max(rtol, x_rtol)
    err, ok = within(aggr, want, rtol, atol)
    err_l, ok_l = within(lse[full], want_lse[full], rtol, atol)
    err_x, ok_x = within(aggr, exact[0], x_rtol, 1e-5)
    err_xl, ok_xl = within(lse[full], exact[1][full], x_rtol, 1e-5)
    if not (ok and ok_l and ok_x and ok_xl) or aggr[~full].any():
        raise SmokeFailure(
            f"gen_agg_fwd {case}: max |err| aggr {err}, lse {err_l} (rtol="
            f"{rtol}, atol={atol}); against the fp32 plain on the same "
            f"inputs {err_x}, {err_xl} ({x_rtol}, 1e-5); or an empty "
            "segment not 0")
    served, no_lse = gen_agg_fwd(*args, need_lse=False)
    torch.cuda.synchronize()
    if no_lse is not None or not torch.equal(served, aggr):
        raise SmokeFailure(f"gen_agg_fwd {case}: need_lse=False gave an lse "
                           "or another aggr")
    del want, want_lse, exact, aggr2, lse2, served
    n_dst, n_e, b = ptr.shape[0] - 1, src.shape[0], x.element_size()
    s_used = int(torch.unique(src).numel())
    n_bytes = ((n_dst + 1) * 4 + n_e * 8 + s_used * d * b + (2 * d + 1) * b
               + 2 * n_dst * d * 4)
    bound_ms, bound_by = bound(n_bytes, GEN_FWD_OPS * n_e * d)

    def serve():
        return gen_agg_fwd(*args, need_lse=False)

    row = {
        "name": "gen_agg_fwd", "route": "cuda",
        "source": "lp_gnn_tpu_torch/ops/csrc/gen_agg.cu",
        "replaces": "lp_gnn_tpu/models/gen.py:39",
        "launches": None, "max_abs_err": max(err, err_l),
        "ms": time_ms(lambda: gen_agg_fwd(*args), 20),
        "device_ms": kernel_device_ms(lambda: gen_agg_fwd(*args),
                                      "gen_agg_fwd_kernel"),
        "plain_ms": time_ms(lambda: gen_agg_fwd_plain(*args), 3, warm=1),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "case": case, "on_path": on_path,
        "ms_no_lse": time_ms(serve, 20),
        "device_ms_no_lse": kernel_device_ms(serve, "gen_agg_fwd_kernel"),
        "bound_no_lse_ms": bound(n_bytes - n_dst * d * 4, 0)[0],
        **gen_agg_mod.kernel_attrs(dt, d, backward=False),
        "num_dst": n_dst, "num_src": x.shape[0], "nnz": n_e, "D": d,
        "longest_segment": longest,
        "tol": {"rtol": rtol, "atol": atol, "fp32_plain_rtol": x_rtol},
        "max_abs_err_vs_fp32_plain": max(err_x, err_xl),
        "also_replaces": ["lp_gnn_tpu/models/gen.py:136",
                          "lp_gnn_tpu/ops/spmm.py:252"],
        "library": "none: no one PyTorch call computes the segment-softmax "
                   "aggregation",
    }
    return row, aggr, lse


def gen_bwd_case(case: str, args: tuple, aggr, lse, gen,
                 on_path) -> tuple[dict, torch.Tensor]:
    """gen_agg_bwd against its plain version from the same aggr, lse and a
    random dL/daggr, bit-identical over two calls; returns the row and the
    kernel's dpre."""
    ptr, src, a, x = args[:4]
    dt, d = x.dtype, x.shape[1]
    g = torch.randn(aggr.shape, generator=gen, device=aggr.device)
    got = gen_agg_bwd(*args, g, aggr, lse)
    again = gen_agg_bwd(*args, g, aggr, lse)
    want = gen_agg_bwd_plain(*args, g, aggr, lse)
    torch.cuda.synchronize()
    bits = torch.int32 if dt == torch.float32 else torch.int16
    if not (torch.equal(got[0].view(bits), again[0].view(bits))
            and all(torch.equal(u, v) for u, v in zip(got[1:], again[1:]))):
        raise SmokeFailure(f"gen_agg_bwd {case}: two calls differ")
    rtol, atol = GEN_DPRE_TOL[dt]
    err, ok = within(got[0], want[0], rtol, atol)
    dp = want[0][:, :d].float().abs()
    mass = ((a.to(dt).float().abs()[:, None] * dp).sum(0), dp.sum(0),
            want[3].abs() + 1)
    sums_err = [float((u - v.float()).abs().max()) for u, v in
                zip(got[1:], want[1:])]
    sums_rtol = max(GEN_SUM_RTOL, 2 ** -24 * int((ptr[1:] - ptr[:-1]).max()))
    sums_ok = all(bool(((u - v.float()).abs() <= sums_rtol * m).all())
                  for u, v, m in zip(got[1:], want[1:], mass))
    if not (ok and sums_ok):
        raise SmokeFailure(f"gen_agg_bwd {case}: dpre max |err| {err} "
                           f"(rtol={rtol}, atol={atol}); dw, db, dt max "
                           f"|err| {sums_err} (rtol {sums_rtol} of their "
                           "terms' magnitudes)")
    dpre = got[0]
    del got, again, want, dp, mass
    n_dst, n_e, b = ptr.shape[0] - 1, src.shape[0], x.element_size()
    s_used = int(torch.unique(src).numel())
    n_bytes = ((n_dst + 1) * 4 + n_e * 8 + s_used * d * b + (2 * d + 1) * b
               + 3 * n_dst * d * 4 + n_e * dpre.shape[1] * b + (2 * d + 1) * 4)
    bound_ms, bound_by = bound(n_bytes, GEN_BWD_OPS * n_e * d)

    def call():
        return gen_agg_bwd(*args, g, aggr, lse)

    row = {
        "name": "gen_agg_bwd", "route": "cuda",
        "source": "lp_gnn_tpu_torch/ops/csrc/gen_agg.cu",
        "replaces": "lp_gnn_tpu/models/gen.py:39",
        "launches": None, "max_abs_err": err,
        "ms": time_ms(call, 20),
        "device_ms": kernel_device_ms(call, "gen_agg_bwd_kernel"),
        "reduce_device_ms": kernel_device_ms(call, "gen_agg_reduce_kernel"),
        "plain_ms": time_ms(lambda: gen_agg_bwd_plain(*args, g, aggr, lse),
                            3, warm=1),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "case": f"backward of {case}", "on_path": on_path,
        **gen_agg_mod.kernel_attrs(dt, d, backward=True),
        "num_dst": n_dst, "num_src": x.shape[0], "nnz": n_e, "D": d,
        "dpre_row": dpre.shape[1],
        "tol": {"rtol": rtol, "atol": atol, "sums_rtol": sums_rtol},
        "sums_max_abs_err": sums_err,
        "also_replaces": ["lp_gnn_tpu/models/gen.py:136"],
        "part": "the VJP JAX derives for the message and the aggregation "
                "(the gather's is the transpose SpMM)",
        "library": "none",
    }
    return row, dpre


def check_gen_kernels(g: BipartiteGraph, gen: torch.Generator,
                      rng: np.random.RandomState, seed: int) -> list[dict]:
    """The GEN aggregation's kernels on the bench graph, both directions (v2c:
    constraints from variables over the CSR; c2v: the reverse over the
    CSC), at D=256 bf16 (the slice's hidden convs), D=256 fp32 and D=3 bf16
    (its conv_out), then the gathers' backward, the SpMM over the transpose
    ordering with the edge permutation as its index, over the kernel's dpre
    (bf16; D=3 in rows of 8); one dense segment of 65,536 edges among 1,023
    rows of 0-8 (S=4096, D=256 bf16); and the pipeline's LP structure
    (``mirp_bench_graph``: 60 segments of 273 edges at v2c) at D=256 bf16,
    both directions."""
    gt = GraphTensors.from_graph(g, "cuda", perms=True)
    dirs = {"v2c": (gt.rowptr, gt.col, gt.val_r, gt.nvars, gt.colptr,
                    gt.eperm_c),
            "c2v": (gt.colptr, gt.row, gt.val_c, gt.ncons, gt.rowptr,
                    gt.eperm_r)}
    ones = torch.ones(gt.nnz, device="cuda")
    rows = []
    for dname, (ptr, src, a, n_src, t_ptr, eperm) in dirs.items():
        for d, dt in ((256, torch.bfloat16), (256, torch.float32),
                      (3, torch.bfloat16)):
            args = (ptr, src, a, *gen_operands(n_src, d, dt, gen))
            case = f"{dname} D={d} {str(dt).split('.')[-1]}"
            on = dt == torch.bfloat16
            row, aggr, lse = gen_fwd_case(
                case, args, "gen_serve, gen_train" if on else False)
            rows.append(row)
            brow, dpre = gen_bwd_case(case, args, aggr, lse, gen,
                                      "gen_train" if on else False)
            rows.append(brow)
            if on:
                srow = spmm_case(
                    f"gen gather backward of {dname}: dpre (E={gt.nnz}, "
                    f"{dpre.shape[1]}) over the transpose, D={d} bfloat16",
                    t_ptr, eperm, ones, dpre, "gen_train")
                srow["replaces"] = "lp_gnn_tpu/ops/spmm.py:279"
                rows.append(srow)
            del args, aggr, lse, dpre
            torch.cuda.empty_cache()
    counts = rng.randint(0, 9, 1024)
    counts[512] = 65_536
    ptr, src, a = csr_of(counts, 4096, rng, False)
    args = (ptr, src, a, *gen_operands(4096, 256, torch.bfloat16, gen))
    case = "dense segment 65536 edges S=4096 D=256 bfloat16"
    row, aggr, lse = gen_fwd_case(case, args, False)
    rows.append(row)
    rows.append(gen_bwd_case(case, args, aggr, lse, gen, False)[0])
    mt = GraphTensors.from_graph(mirp_bench_graph(seed), "cuda")
    for dname, (ptr, src, a, n_src) in {
            "v2c": (mt.rowptr, mt.col, mt.val_r, mt.nvars),
            "c2v": (mt.colptr, mt.row, mt.val_c, mt.ncons)}.items():
        args = (ptr, src, a, *gen_operands(n_src, 256, torch.bfloat16, gen))
        case = f"mirp_bench {dname} D=256 bfloat16"
        row, aggr, lse = gen_fwd_case(case, args, False)
        rows.append(row)
        rows.append(gen_bwd_case(case, args, aggr, lse, gen, False)[0])
    return rows


# ---------------------------------------------------------------- reference
def check_reference(seed: int) -> dict:
    """GCN_FC at full width on the card against the same weights on the CPU
    (plain SpMM), on a small graph. fp32: max |err| <= 1e-3 on the
    +-10-scaled logits (1024-wide sums taken in another order). bf16 keeps 8
    bits, and a node whose logits nearly cancel before their scaling to norm
    10 turns that into a swing of up to ~1 on any device, so the card's bf16
    is held to the CPU's own: its mean |err| against the CPU's fp32 logits is
    at most twice the CPU bf16 logits' mean |err| against them."""
    g = bench_graph(seed + 1000, m=300, n=500, e=4000)
    logits = {}
    for dtype in ("float32", "bfloat16"):
        model = build_model(f"{ARCH[:-1]},dtype='{dtype}')",
                            generator=torch.Generator().manual_seed(seed)).eval()
        for dev in ("cpu", "cuda"):
            got = np.concatenate(model_inference(model.to(dev), g))
            if not (np.isfinite(got).all() and got.shape == (800, 3)):
                raise SmokeFailure(f"reference {dtype} on {dev}: bad logits")
            logits[dtype, dev] = got
    ref = logits["float32", "cpu"]
    err32 = float(np.abs(logits["float32", "cuda"] - ref).max())
    if err32 > 1e-3:
        raise SmokeFailure(f"reference fp32: card vs CPU logits differ by "
                           f"{err32} > 1e-3")
    card16 = np.abs(logits["bfloat16", "cuda"] - ref)
    cpu16 = np.abs(logits["bfloat16", "cpu"] - ref)
    if card16.mean() > 2 * cpu16.mean():
        raise SmokeFailure(f"reference bf16: card mean |err| {card16.mean()} "
                           f"> 2 x the CPU's {cpu16.mean()}")
    return {"float32": {"max_abs_err": err32, "atol": 1e-3},
            "bfloat16": {"card_mean_abs_err": float(card16.mean()),
                         "cpu_mean_abs_err": float(cpu16.mean()),
                         "card_max_abs_err": float(card16.max()),
                         "cpu_max_abs_err": float(cpu16.max())},
            "hids100_bf16": ragged_width_reference(seed)}


RAGGED_ARCH = "GCN_FC(8,8,hids=100,depth=3)"   # no whole number of bf16 pieces


def ragged_width_reference(seed: int) -> dict:
    """A bf16 GCN_FC at hids=100 (a width the SpMM kernel runs through
    padded copies) served on the card on one bench LP, held to the CPU by
    check_reference's bf16 rule: the card's mean |err| against the CPU's
    fp32 logits at most twice the CPU bf16 logits' own; its SpMM
    launches, one a call (4 a forward)."""
    g = bench_graph(seed + 1200)
    sd = build_model(RAGGED_ARCH, generator=torch.Generator().manual_seed(
        seed)).state_dict()
    logits = {}
    for dtype, dev in (("float32", "cpu"), ("bfloat16", "cpu"),
                       ("bfloat16", "cuda")):
        model = build_model(f"{RAGGED_ARCH[:-1]},dtype='{dtype}')")
        model.load_state_dict(sd)
        before = spmm_csr.launches
        t0 = time.perf_counter()
        got = np.concatenate(model_inference(model.eval().to(dev), g))
        logits[dtype, dev] = got, spmm_csr.launches - before, \
            time.perf_counter() - t0
        if not (np.isfinite(got).all() and got.shape == (M + N, 3)):
            raise SmokeFailure(f"{RAGGED_ARCH} {dtype} on {dev}: bad logits")
    ref = logits["float32", "cpu"][0]
    card16 = np.abs(logits["bfloat16", "cuda"][0] - ref)
    cpu16 = np.abs(logits["bfloat16", "cpu"][0] - ref)
    launches = logits["bfloat16", "cuda"][1]
    if card16.mean() > 2 * cpu16.mean() or launches != SPMM_PER_FORWARD:
        raise SmokeFailure(f"{RAGGED_ARCH} bf16 on the card: mean |err| "
                           f"{card16.mean()} vs 2 x the CPU's "
                           f"{cpu16.mean()}, {launches} SpMM launches "
                           f"(expected {SPMM_PER_FORWARD})")
    return {"arch": RAGGED_ARCH, "dtype": "bfloat16", "graph": "bench LP",
            "card_mean_abs_err": float(card16.mean()),
            "cpu_mean_abs_err": float(cpu16.mean()),
            "card_max_abs_err": float(card16.max()),
            "spmm_launches": launches,
            "card_s": logits["bfloat16", "cuda"][2]}


# -------------------------------------------------------------------- serve
def write_dataset(root: str, seed: int, n_lps: int,
                  graphs: list | None = None) -> None:
    """n_lps processed LPs of the bench shape (or the given ``graphs``) in
    the reference blob format ([row, col, data, c_feas, v_feas, y_s, y_t,
    nnodes] + .meta)."""
    proc = osp.join(root, "processed")
    for i, g in enumerate(graphs or (bench_graph(seed + i)
                                     for i in range(n_lps))):
        m, n = g.ncons, g.nvars
        path = osp.join(proc, f"lp_{i}.pk")
        msgpack_dump([g.row, g.col, g.val.astype(np.float64), g.c_feas,
                      g.v_feas, g.y_s.astype(np.int64), g.y_t.astype(np.int64),
                      m + n], path)
        msgpack_dump(dict(num_cons=m, num_vars=n, raw_path="",
                          processed_path=path,
                          con_nms=[f"c{k}" for k in range(m)],
                          var_nms=[f"x{k}" for k in range(n)]), path + ".meta")


@contextlib.contextmanager
def entry_point_io(module: str, argv: list[str]):
    """``sys.argv`` as ``python -m module argv`` sets it; the run-dir logs
    the entry point attaches (stdout and stderr teed, a root file handler)
    are taken off again after it."""
    saved = sys.argv
    sys.argv = [module, *argv]
    try:
        with run_dir_logs():
            yield
    finally:
        sys.argv = saved


def run_module(module: str, argv: list[str]) -> float:
    """Run ``python -m module argv`` in this process (runpy), so the
    kernels' launch counts are readable after it; returns its wall time."""
    t0 = time.perf_counter()
    with entry_point_io(module, argv):
        runpy.run_module(module, run_name="__main__", alter_sys=True)
    return time.perf_counter() - t0


def call_main(module: str, argv: list[str]):
    """``module.main(argv)``, what ``python -m module argv`` runs, in this
    process as ``run_module`` runs it, its stdout kept: returns its result,
    the JSON lines it printed and its wall seconds."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), entry_point_io(module, argv):
        result = importlib.import_module(module).main(argv)
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()
             if ln.startswith("{")]
    return result, lines, time.perf_counter() - t0


def check_bases(out_dir: str, n_lps: int, shapes=((M, N),)) -> int:
    """Every ``.bas`` in ``out_dir`` (and its ``.sort``) is a valid basis of
    an LP of one of ``shapes`` ((rows, columns); the bench shape by
    default): as many basic as rows, #basic structurals = #nonbasic
    rows."""
    bas = sorted(f for f in os.listdir(out_dir) if f.endswith(".bas"))
    sort = sorted(f for f in os.listdir(out_dir) if f.endswith(".bas.sort"))
    if len(bas) != n_lps or len(sort) != n_lps:
        raise SmokeFailure(f"expected {n_lps} .bas and .sort files, got "
                           f"{len(bas)} and {len(sort)}")
    for f in bas:
        con, var = read_bas_highs(osp.join(out_dir, f))
        n_basic = int((con == 1).sum() + (var == 1).sum())
        if (len(con), len(var)) not in shapes or n_basic != len(con):
            raise SmokeFailure(f"{f}: {n_basic} basic of {len(con)} rows, "
                               f"{len(var)} columns (shapes {shapes})")
        if int((var == 1).sum()) != int(((con == 0) | (con == 2)).sum()):
            raise SmokeFailure(f"{f}: #basic structurals != #nonbasic rows")
    return len(bas)


def serve_and_check(data_prefix: str, log_prefix: str, ckpt: str,
                    seed: int, n_lps: int, split: str, per_forward: dict,
                    extra: list[str], arch: str = ARCH,
                    shapes=((M, N),)) -> dict:
    """Run the entry point ``python -m lp_gnn_tpu_torch.pred_basis`` on
    the dataset ``smoke`` under ``data_prefix`` with ``arch`` in bf16 and
    the weights ``ckpt``, the kernels' launch counts set to 0 just before
    and read just after, and check its output: ``n_lps`` valid bases (of
    LPs of ``shapes``, ``check_bases``),
    ``per_forward`` launches of each kernel in every forward (0 of the
    others), finite per-LP times."""
    argv = ["--dataset", "smoke", "--data_prefix", data_prefix,
            "--log_prefix", log_prefix, "--exp_nm", "smoke",
            "--arch", arch, "--fp16", "1", "--load_from", ckpt,
            "--split", split, "--warm_gate", "off", "--seed", str(seed),
            *extra]
    for kern in KERNELS:
        kern.launches = 0
    t_serve = run_module("lp_gnn_tpu_torch.pred_basis", argv)
    launches = {kern.__name__: kern.launches for kern in KERNELS}
    log_dir = osp.join(log_prefix, "smoke")
    n_bas = check_bases(osp.join(log_dir, "pred-basis"), n_lps, shapes)
    forwards = FORWARDS_PER_LP * n_lps
    for name, n in launches.items():
        want = per_forward.get(name, 0) * forwards
        if n != want:
            raise SmokeFailure(f"{name} launched {n} times in {forwards} "
                               f"forwards, expected {want}")
    inf = json_load(osp.join(log_dir, "inf_time.json"))
    times = inf["inf_time"]
    if len(times) != n_lps or not all(
            np.isfinite(t) and t > 0 for t in times.values()):
        raise SmokeFailure(f"inf_time.json: bad per-LP times {times}")
    return {"lps": n_lps, "bas_valid": n_bas, "forwards": forwards,
            "launches": launches, "inf_time_s": times,
            "part_time_s": inf.get("part_time", {}),
            "inf_time_device": inf["device"], "pred_basis_s": t_serve}


def bf16_arch(arch: str) -> str:
    """``arch`` with dtype='bfloat16' unless it names a dtype (what --fp16 1
    gives, config.py arch_with_dtype)."""
    if "dtype" in arch:
        return arch
    base = arch.strip()[:-1]
    return base + ("" if base.endswith("(") else ",") + "dtype='bfloat16')"


def save_seeded(arch: str, seed: int, path: str) -> str:
    """A seeded bf16 ``arch``'s state_dict at ``path``."""
    model = build_model(bf16_arch(arch),
                        generator=torch.Generator().manual_seed(seed))
    torch.save(model.state_dict(), path)
    return path


def run_pred_basis(tmp: str, seed: int, n_lps: int, per_forward: dict,
                   extra: list[str], arch: str = ARCH) -> dict:
    """Write ``n_lps`` bench-shape LPs and a seeded bf16 ``arch`` and serve
    every LP through the entry point (``serve_and_check``)."""
    data_prefix = osp.join(tmp, "data")
    t0 = time.perf_counter()
    write_dataset(osp.join(data_prefix, "smoke", "highs-inp_tgt"), seed, n_lps)
    t_write = time.perf_counter() - t0
    ckpt = save_seeded(arch, seed, osp.join(tmp, "mdl.pth"))
    res = serve_and_check(data_prefix, osp.join(tmp, "runs"), ckpt, seed,
                          n_lps, "trainval", per_forward, extra, arch)
    return {**res, "write_dataset_s": t_write, "data_prefix": data_prefix}


def serve(seed: int) -> dict:
    with tempfile.TemporaryDirectory(prefix="lp_gnn_smoke_") as tmp:
        res = run_pred_basis(tmp, seed, N_LPS, {"spmm_csr": SPMM_PER_FORWARD}, [])
    del res["data_prefix"], res["part_time_s"]
    return res


def device_ms_by_kernel(fn) -> tuple[dict, bool]:
    """Device time of the 12 costliest kernels one call of ``fn`` launches,
    summed by name (ms), from ``torch.profiler``, and whether the profile
    saw every launch of the port's kernels that a dist forward makes."""
    seen, complete = profile_kernels(fn, 1, {
        "spmm_csr_kernel": DIST_PER_FORWARD["spmm_csr"],
        "gather_rows_kernel": DIST_PER_FORWARD["gather_rows"],
        "halo_a2a_kernel": DIST_PER_FORWARD["halo_all_to_all"]})
    out = {}
    for k, (t, _) in seen.items():
        if t > 0:
            out[k[:90]] = out.get(k[:90], 0.0) + t
    return dict(sorted(out.items(), key=lambda kv: -kv[1])[:12]), complete


def dist_breakdown(model, g: BipartiteGraph) -> dict:
    """Where one LP's edge-partitioned ``inf_time`` goes (K=4, bf16): the
    host partition (a per-graph constant, outside ``inf_time``), its tensors
    built and copied to the card, the forward (ends in a synchronize),
    logits back to the host and the top-m decode, on the host clock; the
    dist and the single-card forwards' spans on the card by CUDA events;
    and the dist forward's device time by kernel (``torch.profiler``).
    Medians of 3 after one warm-up."""
    mesh = make_mesh(K_EDGE, "cuda")
    stages = {"partition_s": [], "partition_to_device_s": [], "forward_s": [],
              "to_host_s": [], "decode_s": [], "dist_forward_device_ms": [],
              "single_forward_device_ms": []}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    gt = GraphTensors.from_graph(g, "cuda")
    for rep in range(4):
        t0 = time.perf_counter()
        dg = edge_partition.partition_graph(g, K_EDGE, halo=True)
        t1 = time.perf_counter()
        dt = edge_partition.DistGraphTensors.from_partition(dg, mesh)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with torch.inference_mode():
            ev[0].record()
            lc, lv = edge_partition.dist_forward(model, dt)
            ev[1].record()
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            logits = np.concatenate([lc[:g.ncons].cpu().numpy(),
                                     lv[:g.nvars].cpu().numpy()])
            t4 = time.perf_counter()
            inference_gnn(logits, g.ncons)
            t5 = time.perf_counter()
            ev[2].record()
            model(gt)
            ev[3].record()
        torch.cuda.synchronize()
        if rep:
            for k, v in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4,
                                     ev[0].elapsed_time(ev[1]),
                                     ev[2].elapsed_time(ev[3]))):
                stages[k].append(v)
    with torch.inference_mode():
        by_kernel, complete = device_ms_by_kernel(
            lambda: edge_partition.dist_forward(model, dt))
    return {**{k: sorted(v)[1] for k, v in stages.items()},
            "dist_forward_by_kernel_ms": by_kernel,
            "dist_forward_profile_complete": complete}


def dist_serve(seed: int) -> dict:
    """The edge-partitioned path through the entry point (K=4 on the one
    card), then its partitions read back from the CLI's cache and the
    breakdown of one LP's dist ``inf_time``."""
    with tempfile.TemporaryDirectory(prefix="lp_gnn_smoke_dist_") as tmp:
        res = run_pred_basis(
            tmp, seed, N_DIST_LPS, DIST_PER_FORWARD,
            DIST_ARGS)
        proc = osp.join(res.pop("data_prefix"), "smoke", "highs-inp_tgt")
        if len(res["part_time_s"]) != N_DIST_LPS:
            raise SmokeFailure(f"inf_time.json: part_time {res['part_time_s']}")
        cache = osp.join(proc, "partitions")
        ds = LPDataset(proc)
        parts = {}
        for i in range(len(ds)):
            g = ds[i]
            dg = edge_partition.cached_partition_graph(
                g, K_EDGE, cache, g.fn, halo=True)
            parts[g.fn] = {"K": dg.n_shards, "ms": dg.ms, "ns": dg.ns,
                           "Bh": dg.bh, "nh": dg.nh,
                           "edges_per_shard": dg.nnz_s.tolist()}
        n_cached = len(os.listdir(cache))
        if n_cached != N_DIST_LPS:
            raise SmokeFailure(f"{n_cached} cached partitions, expected "
                               f"{N_DIST_LPS}")
        model = build_model(f"{ARCH[:-1]},dtype='bfloat16')",
                            generator=torch.Generator().manual_seed(seed))
        model = model.to("cuda").eval()
        res["breakdown"] = {"lp": g.fn, **dist_breakdown(model, g)}
    return {**res, "partitions": parts}


def dist_reference(seed: int) -> dict:
    """One bench-shape LP's edge-partitioned logits (K=4 on the card)
    against its single-card logits on the card, same weights. fp32: max
    |err| <= 1e-3, as the reference phase holds the card to the CPU. bf16:
    the dist path adds its local and halo parts in bf16 (one rounding more
    than the single-card sum), so it is held to the single card's own bf16
    spread: its mean |err| against the single-card fp32 logits is at most
    twice the single-card bf16's."""
    g = bench_graph(seed + 2000)
    mesh = make_mesh(K_EDGE, "cuda")
    logits = {}
    for dtype in ("float32", "bfloat16"):
        model = build_model(f"{ARCH[:-1]},dtype='{dtype}')",
                            generator=torch.Generator().manual_seed(seed))
        model = model.to("cuda").eval()
        for path, kw in (("single", {}),
                         ("dist", {"edge_num_thresh": 0, "mesh": mesh})):
            got = np.concatenate(model_inference(model, g, **kw))
            if not (np.isfinite(got).all() and got.shape == (M + N, 3)):
                raise SmokeFailure(f"dist_reference {dtype} {path}: bad logits")
            logits[dtype, path] = got
    ref = logits["float32", "single"]
    err32 = np.abs(logits["float32", "dist"] - ref)
    if err32.max() > 1e-3:
        raise SmokeFailure(f"dist_reference fp32: dist vs single-card logits "
                           f"differ by {err32.max()} > 1e-3")
    dist16 = np.abs(logits["bfloat16", "dist"] - ref)
    single16 = np.abs(logits["bfloat16", "single"] - ref)
    if dist16.mean() > 2 * single16.mean():
        raise SmokeFailure(f"dist_reference bf16: dist mean |err| "
                           f"{dist16.mean()} > 2 x the single card's "
                           f"{single16.mean()}")
    return {"K": K_EDGE, "nodes": M + N,
            "float32": {"max_abs_err": float(err32.max()),
                        "mean_abs_err": float(err32.mean()), "atol": 1e-3},
            "bfloat16": {"dist_mean_abs_err": float(dist16.mean()),
                         "single_mean_abs_err": float(single16.mean()),
                         "dist_max_abs_err": float(dist16.max()),
                         "single_max_abs_err": float(single16.max())}}


def breakdown(seed: int, arch: str = ARCH, profile: dict | None = None) -> dict:
    """Where one LP's ``inf_time`` goes, at the bench shape in bf16: graph
    tensors built and copied to the card, the forward (ends in a
    synchronize), logits back to the host, the top-m decode, on the host
    clock; and the forward's span on the card by CUDA events. Medians of 3
    after one warm-up. With ``profile`` (a part of a kernel's name ->
    launches a forward), also one forward's device time by kernel
    (``torch.profiler``)."""
    g = bench_graph(seed)
    model = build_model(bf16_arch(arch),
                        generator=torch.Generator().manual_seed(seed))
    model = model.to("cuda").eval()
    stages = {"graph_tensors_s": [], "forward_s": [], "to_host_s": [],
              "decode_s": []}
    device_ms = []   # the forward's span on the card, by CUDA events
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    for rep in range(4):
        t0 = time.perf_counter()
        gt = GraphTensors.from_graph(g, "cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ev0.record()
        with torch.inference_mode():
            lc, lv = model(gt)
        ev1.record()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        logits = np.concatenate([lc.cpu().numpy(), lv.cpu().numpy()])
        t3 = time.perf_counter()
        inference_gnn(logits, g.ncons)
        t4 = time.perf_counter()
        if rep:
            for k, v in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                stages[k].append(v)
            device_ms.append(ev0.elapsed_time(ev1))
    out = {**{k: sorted(v)[1] for k, v in stages.items()},
           "forward_device_ms": sorted(device_ms)[1]}
    if profile:
        with torch.inference_mode():
            seen, complete = profile_kernels(lambda: model(gt), 1, profile)
        out["forward_by_kernel_ms"] = {
            k[:90]: t for k, (t, _) in sorted(seen.items(),
                                             key=lambda kv: -kv[1][0])[:12]}
        out["forward_kernels_busy_ms"] = sum(t for t, _ in seen.values())
        out["forward_profile_complete"] = complete
    return out


# -------------------------------------------------------------------- train
def no_launches() -> dict:
    return {kern.__name__: 0 for kern in KERNELS}


def gcn_fc_train_launches(n_train: int, n_val: int, steps: int):
    """GCN_FC: spmm_csr 2 a train graph once (the input aggregation cache),
    SPMM_PER_STEP a step, SPMM_PER_FORWARD a val forward; no other kernel."""
    want = {**no_launches(), "spmm_csr": 2 * n_train + SPMM_PER_STEP * steps
            + SPMM_PER_FORWARD * n_val}
    return want, (f"spmm_csr 2 x {n_train} + {SPMM_PER_STEP} x {steps} + "
                  f"{SPMM_PER_FORWARD} x {n_val}, no other kernel")


def gen_train_launches(n_train: int, n_val: int, steps: int):
    """GENDeeper with remat: GEN_PER_STEP a step, GEN_PER_FORWARD
    gen_agg_fwd a val forward, no input cache."""
    want = {**no_launches(),
            **{k: n * steps for k, n in GEN_PER_STEP.items()}}
    want["gen_agg_fwd"] += GEN_PER_FORWARD * n_val
    return want, (f"gen_agg_fwd {GEN_PER_STEP['gen_agg_fwd']} x {steps} + "
                  f"{GEN_PER_FORWARD} x {n_val}; gen_agg_bwd "
                  f"{GEN_PER_STEP['gen_agg_bwd']} x {steps}; spmm_csr "
                  f"{GEN_PER_STEP['spmm_csr']} x {steps} + 0 (no input "
                  "cache); no other kernel")


def train(seed: int, arch: str = ARCH, epochs: int = TRAIN_EPOCHS,
          data_seed: int = 100, expect=gcn_fc_train_launches,
          serve_per_forward: dict | None = None) -> dict:
    """The training entry point ``python -m lp_gnn_tpu_torch.train`` (in
    this process, through runpy) at full width and depth in bf16 on
    N_TRAIN_LPS bench-shape LPs (the 70/30 split: 2 train, 2 val),
    ``epochs`` epochs and a val pass after the last, the launch counts set
    to 0 just before and read just after. Checks: every step's loss and
    every logged ``train/loss`` finite; each kernel launched exactly as
    ``expect`` counts (for GCN_FC: ``spmm_csr`` 2 a train graph +
    SPMM_PER_STEP a step + 4 a val forward, the other kernels not at all);
    ``mdl.pth``, ``train_state.pth``, ``args.json`` written; the trained
    ``mdl.pth`` serves valid bases for the val LPs through ``python -m
    lp_gnn_tpu_torch.pred_basis`` (``serve_per_forward`` launches a
    forward). Reports each epoch's wall time (to the start of its
    checkpoint write; epoch 0 from the entry point's start) and every
    step's loss, read through wrappers of ``trainer.train_step`` and
    ``trainer.save_checkpoint`` that add no work on the card."""
    from lp_gnn_tpu_torch.utils.misc import split_idxs_train_val
    n_train, n_val = map(len, split_idxs_train_val(N_TRAIN_LPS))
    steps = n_train * epochs
    want, formula = expect(n_train, n_val, steps)
    with tempfile.TemporaryDirectory(prefix="lp_gnn_smoke_train_") as tmp:
        data_prefix = osp.join(tmp, "data")
        t0 = time.perf_counter()
        write_dataset(osp.join(data_prefix, "smoke", "highs-inp_tgt"),
                      seed + data_seed, N_TRAIN_LPS)
        t_write = time.perf_counter() - t0
        argv = ["--dataset", "smoke", "--data_prefix", data_prefix,
                "--log_prefix", osp.join(tmp, "runs"), "--exp_nm", "train",
                "--arch", arch, "--fp16", "1", "--loss", "balanced",
                "--epochs", str(epochs), "--eval_every",
                str(epochs), "--seed", str(seed)]
        step_losses, epoch_ends = [], []
        real_step, real_save = trainer.train_step, trainer.save_checkpoint

        def step_seen(*a, **kw):
            loss, acc = real_step(*a, **kw)
            step_losses.append(loss)
            return loss, acc

        def save_seen(*a, **kw):
            epoch_ends.append(time.perf_counter())
            return real_save(*a, **kw)

        trainer.train_step, trainer.save_checkpoint = step_seen, save_seen
        for kern in KERNELS:
            kern.launches = 0
        t_start = time.perf_counter()
        try:
            t_train = run_module("lp_gnn_tpu_torch.train", argv)
        finally:
            trainer.train_step, trainer.save_checkpoint = real_step, real_save
        launches = {kern.__name__: kern.launches for kern in KERNELS}
        if launches != want:
            raise SmokeFailure(f"train launches {launches}, expected {want} "
                               f"({formula})")
        losses = [float(v) for v in step_losses]
        if len(losses) != steps or not np.isfinite(losses).all():
            raise SmokeFailure(f"train step losses {losses}")
        log_dir = osp.join(tmp, "runs", "train")
        for f in ("mdl.pth", "train_state.pth", "args.json", "metrics.jsonl"):
            if not osp.exists(osp.join(log_dir, f)):
                raise SmokeFailure(f"train wrote no {f}")
        logged = {}
        with open(osp.join(log_dir, "metrics.jsonl")) as f:
            for line in f:
                r = json.loads(line)
                logged.setdefault(r["tag"], []).append([r["step"], r["value"]])
        if not logged.get("train/loss") or not np.isfinite(
                [v for _, v in logged["train/loss"]]).all():
            raise SmokeFailure(f"metrics.jsonl train/loss {logged}")
        served = serve_and_check(
            data_prefix, osp.join(tmp, "serve"), osp.join(log_dir, "mdl.pth"),
            seed, n_val, "val",
            serve_per_forward or {"spmm_csr": SPMM_PER_FORWARD}, [], arch)
    ends = [t_start] + epoch_ends
    return {"arch": bf16_arch(arch), "lps": N_TRAIN_LPS, "train_lps": n_train,
            "val_lps": n_val, "epochs": epochs, "steps": steps,
            "launches": launches, "spmm_expected": want["spmm_csr"],
            "launches_expected": want, "launch_formula": formula,
            "step_losses": losses,
            "epoch_wall_s": [b - a for a, b in zip(ends, ends[1:])],
            "train_s": t_train, "write_dataset_s": t_write,
            "metrics": logged,
            "serve_trained": {k: served[k] for k in (
                "lps", "bas_valid", "launches", "inf_time_s")}}


def categorize(seen: dict) -> dict:
    """Device ms of one profiled call by kind of kernel: the SpMM, the GEN
    aggregation's kernels, cuBLAS GEMMs, the optimizer (Adam's foreach
    kernels), the rest (losses, casts, activations, norms, reductions)."""
    out = {"spmm_csr": 0.0, "gen_agg": 0.0, "gemm": 0.0, "optimizer": 0.0,
           "other": 0.0}
    for k, (t, _) in seen.items():
        low = k.lower()
        if "spmm_csr_kernel" in low:
            out["spmm_csr"] += t
        elif "gen_agg_" in low:
            out["gen_agg"] += t
        elif any(w in low for w in ("gemm", "nvjet", "xmma", "cutlass")):
            out["gemm"] += t
        elif "multi_tensor_apply" in low:
            out["optimizer"] += t
        else:
            out["other"] += t
    return out


def train_breakdown(seed: int, arch: str = ARCH,
                    per_step: dict | None = None) -> dict:
    """One training step of ``arch`` on one bench-shape LP, bf16, balanced
    CE, Adam, the graph as the trainer builds it (the input aggregation
    cache where the model reads it): 2 warm-up steps, then medians of 10 of
    the step's wall time on the host clock (ends when the loss reaches the
    host) and its span on the card (CUDA events around the step's
    launches), the kernels' launches a step (``per_step``, exact), the peak
    of allocated device memory; then one step's device time by kernel
    (``torch.profiler``, after an unrecorded warm-up round) and the card's
    idle share of the step (1 - kernel time / span, and / wall)."""
    per_step = per_step or {"spmm_csr": SPMM_PER_STEP}
    g = bench_graph(seed + 3000)
    model = build_model(bf16_arch(arch),
                        generator=torch.Generator().manual_seed(seed))
    model = model.to("cuda")
    gt = trainer.train_graph(model, g, "cuda")
    optimizer = trainer.make_optimizer(model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(seed)
    loss_fn = LOSS_REGISTRY["balanced"]

    def step():
        return trainer.train_step(model, optimizer, gt, loss_fn, gen)[0]

    for _ in range(2):
        float(step())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    walls, spans, launches = [], [], []
    for _ in range(10):
        before = {kern.__name__: kern.launches for kern in KERNELS}
        t0 = time.perf_counter()
        ev0.record()
        loss = step()
        ev1.record()
        float(loss)
        walls.append((time.perf_counter() - t0) * 1e3)
        spans.append(ev0.elapsed_time(ev1))
        launches.append({k.__name__: k.launches - before[k.__name__]
                         for k in KERNELS})
    peak = torch.cuda.max_memory_allocated()
    want = {**no_launches(), **per_step}
    if any(n != want for n in launches):
        raise SmokeFailure(f"train step launches {launches}, expected "
                           f"{want} each")
    seen, complete = profile_kernels(
        step, 1, {f"{k}_kernel": n for k, n in per_step.items()})
    kinds = categorize(seen)
    busy = sum(kinds.values())
    top = {k[:90]: t for k, (t, _) in sorted(seen.items(),
                                             key=lambda kv: -kv[1][0])[:15]}
    counts = {k[:90]: n for k, (_, n) in seen.items() if k[:90] in top}
    wall, span = sorted(walls)[5], sorted(spans)[5]
    return {"arch": bf16_arch(arch), "lp_nodes": M + N, "nnz": E,
            "step_wall_ms": wall,
            "step_wall_ms_all": walls, "step_device_span_ms": span,
            "step_device_span_ms_all": spans, "spmm_launches_per_step":
            want["spmm_csr"], "launches_per_step": want,
            "device_ms_by_kind": kinds,
            "device_ms_busy": busy, "idle_share_of_span": 1 - busy / span,
            "idle_share_of_wall": 1 - busy / wall,
            "device_ms_top_kernels": top, "top_kernel_launches": counts,
            "profile_complete": complete,
            "max_memory_allocated_bytes": peak}


def state_of(model) -> dict:
    return {k: v.detach().float().cpu() for k, v in model.state_dict().items()}


def max_diff(a: dict, b: dict) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def spmm_sum_in_x_dtype(ptr, idx, val, x):
    """The plain SpMM summed in x's dtype (``spmm_csr_plain`` sums in fp32):
    the fp64 reference's aggregation."""
    num_dst = ptr.shape[0] - 1
    dst = torch.repeat_interleave(torch.arange(num_dst, device=x.device),
                                  (ptr[1:] - ptr[:-1]).long())
    out = torch.zeros(num_dst, x.shape[1], dtype=x.dtype, device=x.device)
    return out.index_add_(0, dst, x.index_select(0, idx.long())
                          * val[:, None].to(x.dtype))


def small_train_run(arch: str, sd: dict, g: BipartiteGraph, dev: str,
                    fp64: bool, steps: int = 3):
    """``steps`` Adam steps of ``arch`` from ``sd`` on ``g`` on ``dev``,
    dropout 0, the graph as the trainer builds it: (losses, the first
    step's gradients, the params after the last), the tensors copied to
    the host as fp64. ``fp64``: the model and its convs in fp64 (the SpMM
    summed in fp64; GEN's plain aggregation and its gather's backward take
    fp64 as they are; the knowledge mask and the loss stay fp32, as in
    every run)."""
    loss_fn = LOSS_REGISTRY["balanced"]
    model = build_model(arch)
    model.load_state_dict(sd)
    model.dp = 0.0
    real = spmm_mod.spmm_csr
    if fp64:
        model.double()
        model.cdtype = torch.float64
        spmm_mod.spmm_csr = spmm_sum_in_x_dtype
    try:
        model.to(dev)
        gt = trainer.train_graph(model, g, dev)
        opt = trainer.make_optimizer(model.parameters())
        losses = [float(trainer.train_step(model, opt, gt, loss_fn)[0])]
        # the step leaves its gradient in .grad until the next one
        grad1 = {k: p.grad.detach().double().cpu().clone()
                 for k, p in model.named_parameters()}
        losses += [float(trainer.train_step(model, opt, gt, loss_fn)[0])
                   for _ in range(steps - 1)]
    finally:
        spmm_mod.spmm_csr = real
    return losses, grad1, {k: v.detach().double().cpu()
                           for k, v in model.state_dict().items()}


def held_to(run, ref, sd: dict) -> dict:
    """``run`` against ``ref`` (both from ``small_train_run``, from ``sd``):
    the largest relative loss difference; each parameter's first-step
    gradient and its update over the steps, relative to ``ref``'s norm;
    the whole model's update; and a parameter's largest entry difference
    with the count of entries over 1e-4."""
    (l_a, g_a, p_a), (l_b, g_b, p_b) = run, ref
    sd = {k: v.double() for k, v in sd.items()}

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp(min=1e-30))
    upd = {k: (p_a[k] - sd[k], p_b[k] - sd[k]) for k in p_b}
    return {"loss_max_rel": max(abs(a - b) / abs(b) for a, b in zip(l_a, l_b)),
            "grad1_rel": {k: rel(g_a[k], g_b[k]) for k in g_b},
            "update_rel": {k: rel(*upd[k]) for k in upd},
            "update_rel_all": rel(torch.cat([a.flatten() for a, _ in upd.values()]),
                                  torch.cat([b.flatten() for _, b in upd.values()])),
            "param_max_abs_n_over_1e-4": {
                k: [float((p_a[k] - p_b[k]).abs().max()),
                    int(((p_a[k] - p_b[k]).abs() > 1e-4).sum())] for k in p_b}}


# limits (loss, first-step gradient, update) of the card's 3 small steps
# against the CPU's fp64 run and its fp32 run; measured on an H100 at seed 0:
# (6.5e-7, 2.1e-6, 7.6e-4) and (1.4e-5, 5.6e-4, 1.3e-2)
RTOL_SMALL_RUN = {"card_vs_cpu_fp64": (1e-5, 1e-4, 5e-3),
                  "card_vs_cpu_fp32": (1e-4, 1e-2, 2e-2)}


def train_reference(seed: int) -> dict:
    """Training on the card held to its references.
    1. card vs CPU: GCN_FC at full width, fp32, dropout 0, 3 Adam steps on
       a small graph from one state_dict, on the card, on the CPU in fp32
       and on the CPU in fp64 (the convs and the SpMM's sums in fp64). The
       card is held to each CPU run, parameter by parameter
       (``RTOL_SMALL_RUN``): the losses; each parameter's first-step
       gradient, relative to the reference's norm; each parameter's update
       over the 3 steps, and the whole model's, relative to the
       reference's. The fp32 limits are wider: the two fp32 runs differ
       from fp64 by round-off, which a ReLU input near 0 can turn into a
       sign, and Adam turns a gradient entry near 0 into a step of +-lr.
       The CPU fp32 run's distance to fp64 is reported beside them.
    2. kernel vs plain: at the bench shape in fp32, one forward, then its
       backward twice: through the kernel, and with ``spmm_csr_plain`` in
       the kernel's place (the same activations, so the same ReLU masks);
       each parameter's gradient within 1e-5 of the plain one's norm
       (relative). The loss of a forward through the plain version within
       rtol 1e-5 of the kernel's.
    3. remat: at the bench shape in bf16 with dropout 0.1 (its mask drawn
       outside the recomputed conv), 2 steps with ``remat=True`` against
       ``remat=False`` from one state_dict and generator seed: the first
       loss equal, the second within rtol 1e-3, params within 1e-5; SpMM
       launches a step 6 against 4; peak device memory of each."""
    loss_fn = LOSS_REGISTRY["balanced"]
    out = {}
    # 1. card vs CPU, fp32 and fp64
    g = bench_graph(seed + 4000, m=300, n=500, e=4000)
    arch32 = f"{ARCH[:-1]},dp=0.0)"
    sd = build_model(arch32, generator=torch.Generator().manual_seed(seed)
                     ).state_dict()
    card = small_train_run(arch32, sd, g, "cuda", fp64=False)
    cpu32 = small_train_run(arch32, sd, g, "cpu", fp64=False)
    cpu64 = small_train_run(arch32, sd, g, "cpu", fp64=True)
    held = {"card_vs_cpu_fp64": held_to(card, cpu64, sd),
            "card_vs_cpu_fp32": held_to(card, cpu32, sd)}
    for name, h in held.items():
        worst = (h["loss_max_rel"], max(h["grad1_rel"].values()),
                 max(max(h["update_rel"].values()), h["update_rel_all"]))
        if any(w > lim for w, lim in zip(worst, RTOL_SMALL_RUN[name])):
            raise SmokeFailure(f"train_reference {name}: loss, grad1, update "
                               f"rel {worst} (limits {RTOL_SMALL_RUN[name]})"
                               f": {h}")
        h["max_rel_loss_grad1_update"] = worst
        h["limits"] = RTOL_SMALL_RUN[name]
    held["cpu_fp32_vs_cpu_fp64"] = held_to(cpu32, cpu64, sd)
    out["card_vs_cpu"] = {"losses_card": card[0], "losses_cpu_fp32": cpu32[0],
                          "losses_cpu_fp64": cpu64[0], **held,
                          "float32_matmul_precision":
                          torch.get_float32_matmul_precision()}
    # 2. kernel vs plain: one forward, its backward through each
    g = bench_graph(seed + 5000)
    model = build_model(arch32, generator=torch.Generator().manual_seed(seed))
    model = model.to("cuda")
    gt = GraphTensors.from_graph(g, "cuda", labels=True)

    def step_loss():
        lc, lv = model(gt)
        ms, mt = trainer.seed_masks(gt)
        return loss_fn(lc, lv, gt.y_s, gt.y_t, ms, mt)

    def grads(loss):
        return dict(zip((k for k, _ in model.named_parameters()),
                        torch.autograd.grad(loss, list(model.parameters()),
                                            retain_graph=True)))

    before = spmm_csr.launches
    loss = step_loss()
    g_k = grads(loss)
    n_kernel = spmm_csr.launches - before
    real = spmm_mod.spmm_csr
    spmm_mod.spmm_csr = lambda ptr, idx, val, x: spmm_csr_plain(ptr, idx,
                                                                val, x)
    try:
        g_p = grads(loss)
        with torch.no_grad():
            l_p = float(step_loss())
    finally:
        spmm_mod.spmm_csr = real
    l_k = float(loss.detach())
    rel = {k: float((g_k[k] - g_p[k]).norm() / g_p[k].norm().clamp(min=1e-30))
           for k in g_k}
    worst = max(rel.values())
    loss_rel = abs(l_k - l_p) / abs(l_p)
    if worst > 1e-5 or loss_rel > 1e-5 or n_kernel != 6:
        raise SmokeFailure(f"train_reference kernel vs plain: grad rel "
                           f"{worst}, loss rel {loss_rel}, {n_kernel} "
                           "launches (limits 1e-5, 1e-5, 6)")
    out["kernel_vs_plain"] = {"loss_kernel": l_k, "loss_plain": l_p,
                              "loss_rel": loss_rel, "grad_max_rel": worst,
                              "grad_rel_by_param": rel,
                              "spmm_launches": n_kernel,
                              "rtol_grad": 1e-5, "rtol_loss": 1e-5}
    del model, gt, loss, g_k, g_p
    torch.cuda.empty_cache()
    # 3. remat against no remat, bf16, dropout on
    arch16 = f"{ARCH[:-1]},dtype='bfloat16')"
    sd = build_model(arch16, generator=torch.Generator().manual_seed(seed)
                     ).state_dict()
    g = bench_graph(seed + 6000)
    gt = attach_input_agg(GraphTensors.from_graph(g, "cuda", labels=True),
                          torch.bfloat16)
    runs = {}
    for remat in (False, True):
        model = build_model(arch16[:-1] + f",remat={remat})")
        model.load_state_dict(sd)
        model.to("cuda")
        opt = trainer.make_optimizer(model.parameters())
        gen = torch.Generator(device="cuda").manual_seed(seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = spmm_csr.launches
        losses = [float(trainer.train_step(model, opt, gt, loss_fn, gen)[0])
                  for _ in range(2)]
        runs[remat] = {"losses": losses,
                       "spmm_per_step": (spmm_csr.launches - before) / 2,
                       "max_memory_allocated_bytes":
                       torch.cuda.max_memory_allocated(),
                       "state": state_of(model)}
        del model, opt
    p_err = max_diff(runs[True].pop("state"), runs[False].pop("state"))
    l0, l1 = runs[False]["losses"], runs[True]["losses"]
    if (l1[0] != l0[0] or abs(l1[1] - l0[1]) > 1e-3 * abs(l0[1])
            or p_err > 1e-5 or runs[True]["spmm_per_step"] != 6
            or runs[False]["spmm_per_step"] != SPMM_PER_STEP):
        raise SmokeFailure(f"train_reference remat: {runs}, params max "
                           f"|diff| {p_err}")
    out["remat"] = {"no_remat": runs[False], "remat": runs[True],
                    "param_max_abs": p_err, "bit_identical": p_err == 0.0,
                    "atol_param": 1e-5}
    return out


# ----------------------------------------------------------------- pipeline
def machine_probe() -> dict:
    """What the solver and the reporting find on this machine: scipy and
    its HiGHS, pandas, pytables, g++."""
    out = {"scipy": scipy.__version__,
           "highspy_core": highs_bridge.HAVE_HIGHS,
           "highs": highs_bridge.HIGHS_VERSION, "gxx": shutil.which("g++"),
           "cpus": os.cpu_count()}
    for mod in ("pandas", "tables"):
        try:
            out[mod] = importlib.import_module(mod).__version__
        except ImportError:
            out[mod] = None
    return out


def time_stages(stages: dict, module, names: tuple[str, ...]) -> dict:
    """Wrap ``module.<name>`` for each name so that its wall seconds add up
    in ``stages[name]`` (ending in a device synchronize); returns the real
    functions, to put back."""
    real = {n: getattr(module, n) for n in names}

    def wrap(name):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return real[name](*a, **kw)
            finally:
                torch.cuda.synchronize()
                stages[name] = stages.get(name, 0.0) + time.perf_counter() - t0
        return timed

    for n in names:
        setattr(module, n, wrap(n))
    return real


def valid_basis(path: str) -> tuple[bool, int]:
    """(valid, m): exactly m basic, #basic structurals = #nonbasic rows."""
    con, var = read_bas_highs(path)
    n_basic = int((con == 1).sum() + (var == 1).sum())
    return (n_basic == len(con) and
            int((var == 1).sum()) == int(((con == 0) | (con == 2)).sum()),
            len(con))


def check_prep(ds: str, n_lps: int) -> tuple[dict, list[int]]:
    """A prepped family under ``ds``: n_lps of each prep artifact, every
    cold solve Optimal. Returns the counts and the cold iterations."""
    counts = {sub: len(os.listdir(osp.join(ds, sub))) for sub in (
        "mps", "highs-basis", "log/highs-no-bas", "log/highs-ca-bas-m1",
        "highs-inp_tgt/raw")}
    counts["highs-inp_tgt/processed"] = len(
        [f for f in os.listdir(osp.join(ds, "highs-inp_tgt", "processed"))
         if f.endswith(".pk")])
    if set(counts.values()) != {n_lps}:
        raise SmokeFailure(f"{ds}: prep wrote {counts}, expected {n_lps}")
    cold = [extract_time(osp.join(ds, "log/highs-no-bas", f))[0]
            for f in sorted(os.listdir(osp.join(ds, "log/highs-no-bas")))]
    if min(cold) < 0:
        raise SmokeFailure(f"{ds}: cold solves not all Optimal: {cold}")
    return counts, cold


def check_run(run: str, dataset: str, n_val: int,
              managers: tuple[str, ...]) -> tuple[list, dict, list, list]:
    """A run dir of ``run_train_test`` (and passes after it): finite
    losses and ``mdl.pth``; ``warm_gate.json`` with k in [5, 12]; for each
    inference manager a valid predicted basis and a warm log a val LP,
    none rejected; the results columns of every val LP; the run-dir logs.
    Returns the losses, the gate, the val rows and the columns checked."""
    losses = []
    with open(osp.join(run, "metrics.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            if r["tag"] == "train/loss":
                losses.append(r["value"])
    if not losses or not np.isfinite(losses).all() or \
            not osp.exists(osp.join(run, "mdl.pth")):
        raise SmokeFailure(f"{run}: losses {losses}, or no mdl.pth")
    gate = json_load(osp.join(run, "warm_gate.json"))
    if not 5 <= gate["k"] <= 12:
        raise SmokeFailure(f"{run}: warm gate calibrated on {gate['k']} "
                           f"LPs: {gate}")
    cols = ["highs-no-bas/niter"]
    for spec in managers:
        mng = parse_inference_manager(spec, dataset)
        bas_dir = osp.join(run, mng.get_basis_folder())
        bases = sorted(f for f in os.listdir(bas_dir) if f.endswith(".bas"))
        valid = [valid_basis(osp.join(bas_dir, f)) for f in bases]
        if len(bases) != n_val or not all(v for v, _ in valid):
            raise SmokeFailure(f"{run} {spec}: predicted bases {bases}: "
                               f"valid {valid}")
        warm_dir = osp.join(run, "log", mng.get_log_folder())
        warm_logs = sorted(os.listdir(warm_dir))
        rejected = []
        for f in warm_logs:
            with open(osp.join(warm_dir, f)) as fh:
                if port_family_table.REJECTED in fh.read():
                    rejected.append(f)
        if len(warm_logs) != n_val or rejected:
            raise SmokeFailure(f"{run} {spec}: warm logs {warm_logs}, "
                               f"rejected {rejected}")
        cols += [f"{mng.get_log_folder()}/niter",
                 f"{mng.get_log_folder()}/impr_niter"]
    cols += ["acc", "cvg/acc"]
    rows = json_load(osp.join(run, "time.json"))
    val = [r for r in rows if r.get("split") == "val"]
    missing = [(r["fn"], c) for r in val for c in cols if r.get(c) is None]
    if len(val) != n_val or missing:
        raise SmokeFailure(f"{run}: results table: {len(val)} val rows, "
                           f"missing {missing}")
    for f in ("log-ing", "log-prt", "log-prt-err"):
        if not osp.exists(osp.join(run, f)):
            raise SmokeFailure(f"run dir has no {f}")
    return losses, gate, val, cols


def pipeline_phase(seed: int, epochs: int, n_lps: int,
                   keep: str | None = None) -> dict:
    """The flagship pipeline through its entry points (in this process,
    through runpy): ``run_prep_data`` preps the recipe's family
    (``mirp_like --size bench``, n_lps instances, the HiGHS engine, one
    worker process a CPU), then ``run_train_test`` trains
    GCN_FC(8,8,hids=1024,depth=3) in bf16 with balanced CE for ``epochs``,
    predicts, calibrates the warm gate (``--warm_gate auto``), warm-starts
    the val split, validates and reports. Checks: every prep artifact for
    each LP and every cold solve Optimal; finite losses and ``mdl.pth``;
    ``warm_gate.json`` with k in [5, 12]; a valid predicted basis a val LP;
    a warm log a val LP with no basis rejected; the results columns of
    every val LP; the run-dir logs; ``spmm_csr`` launched exactly as the
    design counts (SPMM_PIPELINE), no other kernel. ``keep``: a directory
    the prepped blobs and the MPS files are copied into
    (``mirp_bench/highs-inp_tgt``, ``mirp_bench/mps``) for later phases."""
    from lp_gnn_tpu_torch.utils.misc import split_idxs_train_val
    n_train, n_val = map(len, split_idxs_train_val(n_lps))
    workers = min(8, os.cpu_count() or 1)
    stages: dict = {}
    with tempfile.TemporaryDirectory(prefix="lp_gnn_smoke_pipe_") as tmp:
        data_prefix = osp.join(tmp, "lp-dataset")
        common = ["--dataset", "mirp_bench", "--data_prefix", data_prefix,
                  "--seed", str(seed), "--engine", "highs"]
        real_prep = time_stages(stages, port_prep, (
            "stage_generate", "stage_run_solver", "stage_cvt_to_pkl",
            "stage_process"))
        try:
            t_prep = run_module("lp_gnn_tpu_torch.run_prep_data", [
                *common, "--family", "mirp_like", "--size", "bench",
                "--n_instances", str(n_lps), "--num_workers", str(workers)])
        finally:
            for n, f in real_prep.items():
                setattr(port_prep, n, f)
        ds = osp.join(data_prefix, "mirp_bench")
        proc = osp.join(ds, "highs-inp_tgt")
        counts, cold = check_prep(ds, n_lps)

        log_prefix = osp.join(tmp, "runs")
        argv = [*common, "--log_prefix", log_prefix, "--exp_nm", "pipe",
                "--arch", ARCH, "--fp16", "1", "--loss", "balanced",
                "--epochs", str(epochs), "--warm_gate", "auto"]
        real_pipe = time_stages(stages, port_pipeline, (
            "stage_train", "predict_and_write_bases", "calibrate_warm_gate",
            "timed_inference", "stage_warm_start", "stage_val",
            "stage_extract"))
        real_train = time_stages(stages, trainer,
                                 ("train_step", "save_checkpoint"))
        for kern in KERNELS:
            kern.launches = 0
        torch.cuda.reset_peak_memory_stats()
        try:
            t_run = run_module("lp_gnn_tpu_torch.run_train_test", argv)
        finally:
            for mod, real in ((port_pipeline, real_pipe),
                              (trainer, real_train)):
                for n, f in real.items():
                    setattr(mod, n, f)
        launches = {kern.__name__: kern.launches for kern in KERNELS}
        peak = torch.cuda.max_memory_allocated()
        run = osp.join(log_prefix, "pipe")
        losses, gate, val, cols = check_run(run, "mirp_bench", n_val,
                                            ("InferenceManager(0,)",))
        k = gate["k"]
        # spmm_csr: 2 a train graph once (the input aggregation cache), 4 a
        # step, 4 a forward: the val LPs' prediction, k calibration LPs,
        # the timing pass (1 + 3 a val LP), validation twice (labels and
        # converged bases)
        formula = (f"2 x {n_train} + 4 x {n_train} x {epochs} + 4 x {n_val}"
                   f" + 4 x {k} + 16 x {n_val} + 8 x {n_val}")
        want = (2 * n_train + SPMM_PER_STEP * n_train * epochs
                + SPMM_PER_FORWARD * (n_val + k + 4 * n_val + 2 * n_val))
        if launches != {**no_launches(), "spmm_csr": want}:
            raise SmokeFailure(f"pipeline launches {launches}, expected "
                               f"spmm_csr {want} = {formula} and no other")
        with open(osp.join(run, "log-prt")) as fh:
            if "gnn-bas-0/impr_niter" not in fh.read():
                raise SmokeFailure("log-prt holds no summary")
        if keep:
            shutil.copytree(osp.join(proc, "processed"), osp.join(
                keep, "mirp_bench", "highs-inp_tgt", "processed"))
            shutil.copytree(osp.join(ds, "mps"),
                            osp.join(keep, "mirp_bench", "mps"))
    order = ("stage_generate", "stage_run_solver", "stage_cvt_to_pkl",
             "stage_process", "stage_train", "predict_and_write_bases",
             "calibrate_warm_gate", "timed_inference", "stage_warm_start",
             "stage_val", "stage_extract")
    names = ("generate", "cold_solves", "cvt", "process", "train", "predict",
             "calibrate", "timing_pass", "warm_start", "val", "extract")
    return {"engine": "highs", "machine": machine_probe(), "lps": n_lps,
            "train_lps": n_train, "val_lps": n_val, "epochs": epochs,
            "workers": workers, "prep_counts": counts,
            "cold_niter": cold,
            "gate": {key: gate[key] for key in (
                "proceed", "mean_impr", "ci90", "k", "failures")},
            "gate_lps": gate["lps"],
            "val_mean": {c: float(np.mean([r[c] for r in val]))
                         for c in cols},
            "val_std": {c: float(np.std([r[c] for r in val], ddof=1))
                        for c in cols},
            "val_rows": [{c: r[c] for c in ("fn", *cols)} for r in val],
            "bases_valid": n_val, "warm_logs": n_val,
            "launches": launches, "spmm_expected": want,
            "spmm_formula": formula,
            "train_loss_first_last": [losses[0], losses[-1]],
            "stage_s": {nm: stages.get(st) for st, nm in zip(order, names)},
            # inside train: the steps (each to a device synchronize) and the
            # checkpoints, one an epoch
            "train_steps_s": stages.get("train_step"),
            "train_step_ms": 1e3 * stages.get("train_step", 0.0)
            / (n_train * epochs),
            "checkpoints_s": stages.get("save_checkpoint"),
            "prep_s": t_prep, "run_train_test_s": t_run,
            "peak_device_bytes": peak}


# ------------------------------------------------------------- family table
FAMILY_CUT = ("transport", "svm")   # top-m and sparsity-mult; a gate-off pass
FAMILY_CUT_LPS = 12                 # 8 train (the gate's k up to 8), 4 val
FAMILY_CUT_EPOCHS = 30
FAMILY_PREP = ("stage_generate", "stage_run_solver", "stage_cvt_to_pkl",
               "stage_process")
FAMILY_PIPE = ("stage_train", "predict_and_write_bases", "calibrate_warm_gate",
               "timed_inference", "stage_warm_start", "stage_val",
               "stage_extract")


def time_family_stages(stages: dict, module, names: tuple[str, ...],
                       now: dict) -> dict:
    """``time_stages`` by family: each wrapped stage's wall seconds add up
    in ``stages[family][name]``, the family the dataset of the Config among
    its arguments, or, for a stage without one (``train_step``), of the
    last stage that had one (``now["family"]``); returns the real
    functions, to put back."""
    real = {n: getattr(module, n) for n in names}

    def wrap(name):
        def timed(*a, **kw):
            cfg = [x for x in (*a, *kw.values()) if isinstance(x, Config)]
            if cfg:
                now["family"] = cfg[0].dataset
            fam = now.get("family")
            t0 = time.perf_counter()
            try:
                return real[name](*a, **kw)
            finally:
                torch.cuda.synchronize()
                per = stages.setdefault(fam, {})
                per[name] = per.get(name, 0.0) + time.perf_counter() - t0
        return timed

    for n in names:
        setattr(module, n, wrap(n))
    return real


def check_family(data_prefix: str, row: dict, n_lps: int, epochs: int,
                 gate_off: bool) -> dict:
    """What ``pipeline_phase`` checks (``check_prep``, ``check_run``), for
    one family of the table and its gate-off pass where that ran; the
    twin's row equal to the val means of the run's ``time.json``. Returns
    the family's figures and its SpMM launches by the design."""
    from lp_gnn_tpu_torch.utils.misc import split_idxs_train_val
    fam = row["family"]
    counts, cold = check_prep(osp.join(data_prefix, fam), n_lps)
    n_train, n_val = map(len, split_idxs_train_val(n_lps))
    managers = (port_family_table.INFERENCE_MANAGER,) + (
        (port_family_table.GATE_OFF_MANAGER,) if gate_off else ())
    losses, gate, val, cols = check_run(row["run_dir"], fam, n_val, managers)
    means = {c: float(np.mean([r[c] for r in val])) for c in cols}
    read = {"highs-no-bas/niter": row["cold_niter"], "acc": row["acc"],
            f"{row['decode']}/niter": row["warm_niter"],
            f"{row['decode']}/impr_niter": row["impr"]}
    if gate_off:
        read.update({"gnn-bas-1/niter": row["gate_off_niter"],
                     "gnn-bas-1/impr_niter": row["gate_off_impr"]})
    wrong = {c: (v, means[c]) for c, v in read.items()
             if not np.isclose(v, means[c], rtol=1e-12, atol=0)}
    if wrong or row["gate"]["k"] != gate["k"]:
        raise SmokeFailure(f"{fam}: the twin's row {row} against the run's "
                           f"files: {wrong}")
    # spmm_csr: 2 a train graph once (the input cache), 4 a step, 4 a
    # forward: the val LPs' prediction, k calibration LPs, the timing pass
    # (1 + 3 a val LP), validation twice; the gate-off pass predicts and
    # times again
    per_val = 4 + 16 + 8 + (20 if gate_off else 0)
    spmm = (2 * n_train + SPMM_PER_STEP * n_train * epochs
            + SPMM_PER_FORWARD * gate["k"] + per_val * n_val)
    formula = (f"2 x {n_train} + 4 x {n_train} x {epochs} + 4 x {gate['k']}"
               f" + {per_val} x {n_val}")
    return {"prep_counts": counts, "cold_niter_lps": cold,
            "train_lps": n_train, "val_lps": n_val, "gate_lps": gate["lps"],
            "gate_ci90": gate["ci90"],
            "train_loss_first_last": [losses[0], losses[-1]],
            "spmm": spmm, "spmm_formula": formula}


def family_table_phase(seed: int, families=FAMILY_CUT,
                       n_lps: int = FAMILY_CUT_LPS,
                       epochs: int = FAMILY_CUT_EPOCHS) -> dict:
    """The twin of ``scripts/run_family_table.sh`` on the card
    (``run_family_table.family_table``, in this process): the script's
    prep, training of GCN_FC(8,8,hids=256,depth=3) in fp32, the ``auto``
    decode and warm gate, and the gate-off pass of svm and stoch, over
    ``families`` at ``n_lps`` LPs and ``epochs`` epochs (the script's
    values under ``--family_table``; its run prints its rows, one JSON
    line a family). Each family checked as ``check_family`` says;
    ``spmm_csr`` launched exactly as the design counts, summed over the
    families, and no other kernel. Each stage's wall seconds a family."""
    stages: dict = {}
    now: dict = {}
    real = [(mod, time_family_stages(stages, mod, names, now))
            for mod, names in ((port_prep, FAMILY_PREP),
                               (port_pipeline, FAMILY_PIPE),
                               (trainer, ("train_step",)))]
    with tempfile.TemporaryDirectory(prefix="lp_gnn_smoke_families_") as tmp:
        data_prefix = osp.join(tmp, "lp-dataset")
        for kern in KERNELS:
            kern.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            with entry_point_io("lp_gnn_tpu_torch.run_family_table", []):
                rows = port_family_table.family_table(
                    families, n_lps, epochs, device="cuda",
                    data_prefix=data_prefix,
                    log_prefix=osp.join(tmp, "runs"), seed=seed)
        finally:
            for mod, fns in real:
                for n, f in fns.items():
                    setattr(mod, n, f)
        twin_s = time.perf_counter() - t0
        launches = {kern.__name__: kern.launches for kern in KERNELS}
        peak = torch.cuda.max_memory_allocated()
        checked = {r["family"]: check_family(
            data_prefix, r, n_lps, epochs,
            r["family"] in port_family_table.GATE_OFF_FAMILIES) for r in rows}
    want = sum(c["spmm"] for c in checked.values())
    formula = " + ".join(f"({c['spmm_formula']})" for c in checked.values())
    if launches != {**no_launches(), "spmm_csr": want}:
        raise SmokeFailure(f"family_table launches {launches}, expected "
                           f"spmm_csr {want} = {formula} and no other")
    names = dict(zip(FAMILY_PREP, ("generate", "cold_solves", "cvt",
                                   "process")))
    names.update(zip(FAMILY_PIPE, ("train", "predict", "calibrate",
                                   "timing_pass", "warm_start", "val",
                                   "extract")))
    for r in rows:
        per = stages.get(r["family"], {})
        steps = checked[r["family"]]["train_lps"] * epochs
        r["stage_s"] = {nm: per.get(st) for st, nm in names.items()}
        r["train_step_ms"] = 1e3 * per.get("train_step", 0.0) / steps
        r.update({k: v for k, v in checked[r["family"]].items()
                  if k not in ("spmm", "spmm_formula")})
    return {"engine": "highs", "machine": machine_probe(),
            "families": rows, "lps": n_lps, "epochs": epochs,
            "arch": port_family_table.ARCH,
            "workers": port_family_table.NUM_WORKERS,
            "launches": launches, "spmm_expected": want,
            "spmm_formula": formula, "twin_s": twin_s,
            "peak_device_bytes": peak}


# ---------------------------------------------------------------------- GEN
# limits (loss, first-step gradient, update) of the card's 3 small GEN
# steps against the CPU's fp64 run and its fp32 run
RTOL_GEN_RUN = {"card_vs_cpu_fp64": (1e-5, 1e-3, 2e-2),
                "card_vs_cpu_fp32": (1e-4, 1e-2, 5e-2)}


def gen_reference(seed: int) -> dict:
    """GENDeeper(8,8,hids=256,depth=5) held to the CPU on a small graph
    (300 x 500, 4,000 edges), the same weights:
    1. logits: fp32 max |err| <= 1e-3 on the +-10-scaled logits (the
       kernel's online softmax, fmaf and expf against the plain two-pass
       version); bf16: the card's mean |err| against the CPU's fp32 logits
       at most twice the CPU bf16 logits' (the plain version rounds as JAX
       does; the kernel keeps its message and softmax in fp32).
    2. training: 3 Adam steps, fp32, dropout 0, on the card, on the CPU in
       fp32 and in fp64 (the plain aggregation, its gather's backward and
       the norms in fp64), held as ``train_reference`` holds GCN_FC
       (``RTOL_GEN_RUN``)."""
    arch = "GENDeeper(8,8,hids=256,depth=5)"
    g = bench_graph(seed + 7000, m=300, n=500, e=4000)
    logits = {}
    for dtype in ("float32", "bfloat16"):
        model = build_model(f"{arch[:-1]},dtype='{dtype}')",
                            generator=torch.Generator().manual_seed(seed)).eval()
        for dev in ("cpu", "cuda"):
            got = np.concatenate(model_inference(model.to(dev), g))
            if not (np.isfinite(got).all() and got.shape == (800, 3)):
                raise SmokeFailure(f"gen_reference {dtype} on {dev}: bad logits")
            logits[dtype, dev] = got
    ref = logits["float32", "cpu"]
    err32 = float(np.abs(logits["float32", "cuda"] - ref).max())
    card16 = np.abs(logits["bfloat16", "cuda"] - ref)
    cpu16 = np.abs(logits["bfloat16", "cpu"] - ref)
    if err32 > 1e-3 or card16.mean() > 2 * cpu16.mean():
        raise SmokeFailure(f"gen_reference logits: fp32 max |err| {err32} "
                           f"(1e-3); bf16 card mean |err| {card16.mean()} "
                           f"(2 x the CPU's {cpu16.mean()})")
    out = {"logits": {"float32": {"max_abs_err": err32, "atol": 1e-3},
                      "bfloat16": {"card_mean_abs_err": float(card16.mean()),
                                   "cpu_mean_abs_err": float(cpu16.mean()),
                                   "card_max_abs_err": float(card16.max()),
                                   "cpu_max_abs_err": float(cpu16.max())}}}
    sd = build_model(arch, generator=torch.Generator().manual_seed(seed)
                     ).state_dict()
    before = {k.__name__: k.launches for k in KERNELS}
    card = small_train_run(arch, sd, g, "cuda", fp64=False)
    card_launches = {k.__name__: k.launches - before[k.__name__]
                     for k in KERNELS}
    cpu32 = small_train_run(arch, sd, g, "cpu", fp64=False)
    cpu64 = small_train_run(arch, sd, g, "cpu", fp64=True)
    held = {"card_vs_cpu_fp64": held_to(card, cpu64, sd),
            "card_vs_cpu_fp32": held_to(card, cpu32, sd)}
    for name, h in held.items():
        worst = (h["loss_max_rel"], max(h["grad1_rel"].values()),
                 max(max(h["update_rel"].values()), h["update_rel_all"]))
        if any(w > lim for w, lim in zip(worst, RTOL_GEN_RUN[name])):
            raise SmokeFailure(f"gen_reference {name}: loss, grad1, update "
                               f"rel {worst} (limits {RTOL_GEN_RUN[name]})")
        h["max_rel_loss_grad1_update"] = worst
        h["limits"] = RTOL_GEN_RUN[name]
        del h["param_max_abs_n_over_1e-4"]
    held["cpu_fp32_vs_cpu_fp64"] = held_to(cpu32, cpu64, sd)
    del held["cpu_fp32_vs_cpu_fp64"]["param_max_abs_n_over_1e-4"]
    out["train"] = {"losses_card": card[0], "losses_cpu_fp32": cpu32[0],
                    "losses_cpu_fp64": cpu64[0],
                    "card_launches_3_steps": card_launches, **held}
    return out


def gen_serve(seed: int) -> dict:
    """The slice's configuration serving N_GEN_LPS bench-shape LPs through
    the entry point: GEN_PER_FORWARD gen_agg_fwd launches a forward, no
    other kernel; then one LP's breakdown with the forward's device time
    by kernel."""
    with tempfile.TemporaryDirectory(prefix="lp_gnn_smoke_gen_") as tmp:
        res = run_pred_basis(tmp, seed + 300, N_GEN_LPS,
                             {"gen_agg_fwd": GEN_PER_FORWARD}, [], GEN_ARCH)
    del res["data_prefix"], res["part_time_s"]
    res["breakdown"] = breakdown(seed + 300, GEN_ARCH,
                                 {"gen_agg_fwd_kernel": GEN_PER_FORWARD})
    return {"arch": GEN_ARCH, **res}


def gen_ab(seed: int) -> dict:
    """The ``--gen_ab`` measurement of this checkout (module docstring):
    its GEN kernels on the bench graph, a GEN forward, a GEN step. It keeps
    to the wrappers' arguments that predate ``need_lse``, so that a copy
    of the script measures an older checkout as well."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    gt = GraphTensors.from_graph(bench_graph(seed), "cuda")
    dirs = {"v2c": (gt.rowptr, gt.col, gt.val_r, gt.nvars),
            "c2v": (gt.colptr, gt.row, gt.val_c, gt.ncons)}
    cases = []
    for dname, (ptr, src, a, n_src) in dirs.items():
        for d in (256, 3):
            dt = torch.bfloat16
            args = (ptr, src, a, *gen_operands(n_src, d, dt, gen))
            case = f"{dname} D={d} bfloat16"
            aggr, lse = gen_agg_fwd(*args)
            g = torch.randn(aggr.shape, generator=gen, device="cuda")
            err, ok = within(aggr, gen_agg_fwd_plain(*args)[0],
                             *GEN_FWD_TOL[dt])
            berr, bok = within(gen_agg_bwd(*args, g, aggr, lse)[0],
                               gen_agg_bwd_plain(*args, g, aggr, lse)[0],
                               *GEN_DPRE_TOL[dt])
            if not (ok and bok):
                raise SmokeFailure(f"gen_ab {case}: aggr max |err| {err}, "
                                   f"dpre {berr}")

            def fwd():
                return gen_agg_fwd(*args)

            def bwd():
                return gen_agg_bwd(*args, g, aggr, lse)

            iters = 200 if d == 3 else 20
            fwd()
            torch.cuda.synchronize()
            t0 = time.perf_counter()   # enqueue only: the host's cost a call
            for _ in range(iters):
                fwd()
            host_us = (time.perf_counter() - t0) / iters * 1e6
            torch.cuda.synchronize()
            cases.append({
                "case": case, "fwd_ms": time_ms(fwd, iters),
                "fwd_host_us": host_us,
                "fwd_device_ms": kernel_device_ms(fwd, "gen_agg_fwd_kernel"),
                "bwd_ms": time_ms(bwd, iters),
                "bwd_device_ms": kernel_device_ms(bwd, "gen_agg_bwd_kernel")})
            del args, aggr, lse, g
    del gt, dirs
    torch.cuda.empty_cache()
    forward = breakdown(seed + 300, GEN_ARCH,
                        {"gen_agg_fwd_kernel": GEN_PER_FORWARD})
    torch.cuda.empty_cache()
    step = train_breakdown(seed, GEN_ARCH, GEN_PER_STEP)
    return {"cases": cases,
            "forward": {k: v for k, v in forward.items()
                        if k.startswith("forward")},
            "step": {k: step[k] for k in (
                "step_wall_ms", "step_device_span_ms",
                "step_device_span_ms_all", "device_ms_by_kind",
                "device_ms_busy", "idle_share_of_span", "profile_complete")}}


def gen_train(seed: int) -> dict:
    """The slice's configuration through the training entry point (``train``
    with GEN's launch formula), then one step's breakdown."""
    res = train(seed, GEN_ARCH, GEN_EPOCHS, 200, gen_train_launches,
                {"gen_agg_fwd": GEN_PER_FORWARD})
    torch.cuda.empty_cache()
    res["step"] = train_breakdown(seed, GEN_ARCH, GEN_PER_STEP)
    return res


def zoo_serve(seed: int) -> dict:
    """The rest of the zoo at width 256 in bf16 through the entry point on
    N_ZOO_LPS bench-shape LPs each: valid bases, the SpMM launched
    ZOO_SERVE times a forward (the input conv's 2 included: serving builds
    no cache), no other kernel."""
    out = {}
    with tempfile.TemporaryDirectory(prefix="lp_gnn_smoke_zoo_") as tmp:
        data_prefix = osp.join(tmp, "data")
        write_dataset(osp.join(data_prefix, "smoke", "highs-inp_tgt"),
                      seed + 400, N_ZOO_LPS)
        for i, (arch, per) in enumerate(ZOO_SERVE.items()):
            ckpt = save_seeded(arch, seed, osp.join(tmp, f"mdl{i}.pth"))
            res = serve_and_check(data_prefix, osp.join(tmp, f"runs{i}"), ckpt,
                                  seed, N_ZOO_LPS, "trainval",
                                  {"spmm_csr": per}, [], arch)
            out[bf16_arch(arch)] = {
                "spmm_per_forward": per,
                **{k: res[k] for k in ("lps", "bas_valid", "forwards",
                                       "launches", "inf_time_s")}}
    total = no_launches()
    for r in out.values():
        for k, n in r["launches"].items():
            total[k] += n
    return {"archs": out, "launches": total}


# ------------------------------------------- sampled, batched and dp paths
# The bench-shape LPs (1M edges) above SAMPLED_THRESH take the sampler:
# exact shards when serving, fanout-6 subgraphs when training, seed batches
# of SAMPLED_BATCH nodes (the 196,608 nodes make 6 whole batches)
SAMPLED_THRESH = 500_000
SAMPLED_BATCH = 32_768
SAMPLED_ARGS = ["--edge_num_thresh", str(SAMPLED_THRESH),
                "--batch_size", str(SAMPLED_BATCH)]
SHARDS_PER_LP = -(-(M + N) // SAMPLED_BATCH)
N_SAMPLED_LPS = 1            # the script's time budget
# GCN_FC without dropout, for the batched and dp steps held to a serial
# step: the ranks' dropout masks differ from a single process's
ARCH_NO_DROPOUT = f"{ARCH[:-1]},dp=0.0)"
# an SGD step's update (w0 - w1) / lr against another's, per tensor, in
# fp32: relative to the tensor's largest update (Adam's first step is
# lr * sign(g), which would turn rounding-level gradient differences near
# 0 into lr-sized ones). At lr 1 the update is the size of the weights, so
# their fp32 rounding stays far below it (at lr 1e-3 one ulp of a weight
# of 0.35 is 5e-5 of the largest update)
UPDATE_RTOL = 1e-4
UPDATE_LR = 1.0
DP_RANKS = 2


def sampled_reference(seed: int, g: BipartiteGraph) -> dict:
    """One bench-shape LP's exact sampled logits (bf16, the served
    configuration) against its full-graph forward on the card, same
    weights. Exact sampling equals the full graph (GCN_FC's 2 convs read 2
    hops), and bf16 is held to its own spread, as the reference phase
    holds the card: the sampled logits' mean |err| against the full fp32
    logits at most twice the full bf16 logits'."""
    logits = {}
    for dtype, kw in (("float32", {}), ("bfloat16", {}),
                      ("bfloat16_sampled", dict(
                          edge_num_thresh=SAMPLED_THRESH,
                          batch_size=SAMPLED_BATCH, depth=3))):
        model = build_model(f"{ARCH[:-1]},dtype='{dtype.split('_')[0]}')",
                            generator=torch.Generator().manual_seed(seed))
        got = np.concatenate(model_inference(model.to("cuda").eval(), g, **kw))
        if not (np.isfinite(got).all() and got.shape == (M + N, 3)):
            raise SmokeFailure(f"sampled_reference {dtype}: bad logits")
        logits[dtype] = got
    ref = logits["float32"]
    samp = np.abs(logits["bfloat16_sampled"] - ref)
    full = np.abs(logits["bfloat16"] - ref)
    if samp.mean() > 2 * full.mean():
        raise SmokeFailure(f"sampled_reference: sampled bf16 mean |err| "
                           f"{samp.mean()} > 2 x the full graph's "
                           f"{full.mean()}")
    vs16 = np.abs(logits["bfloat16_sampled"] - logits["bfloat16"])
    return {"lp": g.fn, "sampled_mean_abs_err": float(samp.mean()),
            "full_mean_abs_err": float(full.mean()),
            "sampled_max_abs_err": float(samp.max()),
            "full_max_abs_err": float(full.max()),
            "sampled_vs_full_bf16_max": float(vs16.max()),
            "sampled_vs_full_bf16_mean": float(vs16.mean())}


def sampled_breakdown(seed: int, g: BipartiteGraph) -> dict:
    """Where one LP's sampled ``inf_time`` goes (bf16, one pass after the
    entry point's): the host sampling of the exact shards, their graph
    tensors built and copied to the card, the shards' forwards (ends in a
    synchronize; their span on the card by CUDA events), the seed logits
    back to the host, the top-m decode; and the shards' sizes."""
    model = build_model(bf16_arch(ARCH),
                        generator=torch.Generator().manual_seed(seed))
    model = model.to("cuda").eval()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    shards = sample_subgraphs(g, np.random.RandomState(0), [-1, -1],
                              SAMPLED_BATCH, shuffle=False, drop_last=False,
                              exact=True)
    t1 = time.perf_counter()
    gts = [GraphTensors.from_graph(sub.g, "cuda") for sub in shards]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ev0.record()
    with torch.inference_mode():
        outs = [model(gt) for gt in gts]
    ev1.record()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    lc = np.concatenate([o[0][:sub.s_bs].cpu().numpy()
                         for o, sub in zip(outs, shards)])
    lv = np.concatenate([o[1][:sub.t_bs].cpu().numpy()
                         for o, sub in zip(outs, shards)])
    t4 = time.perf_counter()
    inference_gnn(np.concatenate([lc, lv]), g.ncons)
    t5 = time.perf_counter()
    return {"lp": g.fn, "shards": [
        {"nnz": sub.g.nnz, "ncons": sub.g.ncons, "nvars": sub.g.nvars,
         "s_bs": sub.s_bs, "t_bs": sub.t_bs} for sub in shards],
        "sampling_s": t1 - t0, "graph_tensors_s": t2 - t1,
        "forward_s": t3 - t2, "forward_device_ms": ev0.elapsed_time(ev1),
        "to_host_s": t4 - t3, "decode_s": t5 - t4, "total_s": t5 - t0}


def first_subgraph(g: BipartiteGraph, rng, fanout, batch_size: int,
                   exact: bool = False) -> BipartiteGraph:
    """The first subgraph ``sample_subgraphs`` draws (exact: its seeds in
    index order; else shuffled), without drawing the batches after it,
    which cost seconds of the host's time and are not used."""
    from lp_gnn_tpu_torch.data.sampling import _BipartiteCSR, sample_one_batch
    nodes = np.arange(g.ncons + g.nvars)
    if not exact:
        nodes = rng.permutation(nodes)
    chunk = nodes[:min(batch_size, len(nodes))]
    return sample_one_batch(g, _BipartiteCSR(g), chunk[chunk < g.ncons],
                            chunk[chunk >= g.ncons] - g.ncons,
                            [-1] * len(fanout) if exact else fanout, rng).g


def spmm_sequence(g: BipartiteGraph, seed: int) -> list[dict]:
    """The SpMM on graphs of falling, then rising size, as the sampled
    paths launch it (each launch's grid and workspace sized anew): the
    full graph, an exact shard, a fanout-6 subgraph, a small one and one
    without an edge, then back; each direction at D=1024 bf16 against its
    plain version (SPMM_TOL)."""
    rng = np.random.RandomState(seed)
    subs = [first_subgraph(g, rng, [-1, -1], SAMPLED_BATCH, exact=True),
            first_subgraph(g, rng, [6, 6], SAMPLED_BATCH),
            first_subgraph(g, rng, [6, 6], 1024)]
    empty = BipartiteGraph(
        row=np.zeros(0, np.int32), col=np.zeros(0, np.int32),
        val=np.zeros(0, np.float32), c_feas=g.c_feas[:300],
        v_feas=g.v_feas[:500], y_s=g.y_s[:300], y_t=g.y_t[:500])
    seq = [g, *subs, empty]
    gts = [GraphTensors.from_graph(x, "cuda") for x in seq]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for gt in gts + gts[-2::-1]:
        row = {"nnz": gt.nnz, "ncons": gt.ncons, "nvars": gt.nvars}
        for name, ptr, idx, val, n_src in (
                ("v2c", gt.rowptr, gt.col, gt.val_r, gt.nvars),
                ("c2v", gt.colptr, gt.row, gt.val_c, gt.ncons)):
            x = torch.randn(n_src, 1024, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            err, ok = within(spmm_csr(ptr, idx, val, x),
                             spmm_csr_plain(ptr, idx, val, x),
                             *SPMM_TOL[torch.bfloat16])
            if not ok:
                raise SmokeFailure(f"spmm_sequence {name} on {row}: max "
                                   f"|err| {err}")
            row[f"{name}_max_abs_err"] = err
        out.append(row)
    return out


def sampled_serve(seed: int) -> dict:
    """The sampled serving path through the entry point: N_SAMPLED_LPS
    bench-shape LPs above SAMPLED_THRESH served by exact shards of
    SAMPLED_BATCH seeds: valid bases, the SpMM launched SPMM_PER_FORWARD
    times a shard forward, each LP's logits held to its full-graph forward
    (``sampled_reference``); one LP's breakdown, the SpMM over a sequence
    of falling and rising sizes; then GENDeeper on 1 LP (10 gen_agg_fwd a
    shard forward; its 5 convs read more than the 4 hops sampled, so its
    logits are not held to the full graph)."""
    with tempfile.TemporaryDirectory(prefix="lp_gnn_smoke_sampled_") as tmp:
        res = run_pred_basis(tmp, seed + 500, N_SAMPLED_LPS,
                             {"spmm_csr": SPMM_PER_FORWARD * SHARDS_PER_LP},
                             SAMPLED_ARGS)
        ds = LPDataset(osp.join(res.pop("data_prefix"), "smoke",
                                "highs-inp_tgt"))
        res["reference"] = [sampled_reference(seed + 500, ds[i])
                            for i in range(len(ds))]
        g = ds[0]
    del res["part_time_s"]
    res["breakdown"] = sampled_breakdown(seed + 500, g)
    res["spmm_sequence"] = spmm_sequence(g, seed)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="lp_gnn_smoke_sampled_") as tmp:
        gen_res = run_pred_basis(
            tmp, seed + 700, 1, {"gen_agg_fwd": GEN_PER_FORWARD * SHARDS_PER_LP},
            SAMPLED_ARGS, GEN_ARCH)
    res["gen"] = {"arch": GEN_ARCH, **{k: gen_res[k] for k in (
        "lps", "bas_valid", "forwards", "launches", "inf_time_s")}}
    return {"arch": bf16_arch(ARCH), "edge_num_thresh": SAMPLED_THRESH,
            "batch_size": SAMPLED_BATCH, "shards_per_lp": SHARDS_PER_LP,
            "spmm_formula": f"{SPMM_PER_FORWARD} x {SHARDS_PER_LP} shards x "
                            f"{FORWARDS_PER_LP} forwards x {N_SAMPLED_LPS} LPs",
            **res}


class StepTrace:
    """Wrappers of the trainer's functions that read what a run does and
    add no work on the card but a synchronize where a host time needs one:
    the sampler's host seconds, each graph's tensors (host and copy), each
    partition's host seconds and its tensors on the card (the input cache
    included), each step's loss, span on the card (CUDA events) and kernel
    launches, and the SpMM launches of the backward passes."""

    def __init__(self):
        self.sample_s, self.tensors_s, self.steps = [], [], []
        self.partition_s, self.dist_tensors_s = [], []
        self.backward_spmm = 0
        self.model = None     # the model the steps updated
        self._saved = []

    def _patch(self, owner, name, fn):
        self._saved.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, fn)

    def __enter__(self):
        real = {n: getattr(trainer, n) for n in (
            "sample_subgraphs", "train_graph", "train_step", "dp_train_step",
            "dist_train_step", "dp_edge_train_step", "cached_partition_graph",
            "dist_tensors")}
        real_bwd = spmm_mod.SpmmCSR.backward

        def sample(*a, **kw):
            t0 = time.perf_counter()
            out = real["sample_subgraphs"](*a, **kw)
            self.sample_s.append(time.perf_counter() - t0)
            return out

        def timed(name, into):
            def call(*a, **kw):
                t0 = time.perf_counter()
                out = real[name](*a, **kw)
                torch.cuda.synchronize()
                into.append(time.perf_counter() - t0)
                return out
            return call

        def stepper(name):
            def step(*a, **kw):
                before = {k.__name__: k.launches for k in KERNELS}
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                out = real[name](*a, **kw)
                ev[1].record()
                self.model = a[0]
                loss = out[0] if isinstance(out, tuple) else out
                self.steps.append({
                    "kind": name, "loss": float(loss),
                    "device_ms": ev[0].elapsed_time(ev[1]),
                    "launches": {k.__name__: k.launches - before[k.__name__]
                                 for k in KERNELS}})
                return out
            return step

        def backward(ctx, grad):
            n0 = spmm_csr.launches
            out = real_bwd(ctx, grad)
            self.backward_spmm += spmm_csr.launches - n0
            return out

        self._patch(trainer, "sample_subgraphs", sample)
        self._patch(trainer, "train_graph", timed("train_graph",
                                                  self.tensors_s))
        self._patch(trainer, "cached_partition_graph",
                    timed("cached_partition_graph", self.partition_s))
        self._patch(trainer, "dist_tensors", timed("dist_tensors",
                                                   self.dist_tensors_s))
        for name in ("train_step", "dp_train_step", "dist_train_step",
                     "dp_edge_train_step"):
            self._patch(trainer, name, stepper(name))
        self._patch(spmm_mod.SpmmCSR, "backward", staticmethod(backward))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)


def run_train(tmp: str, data_prefix: str, argv: list[str], exp: str):
    """``python -m lp_gnn_tpu_torch.train`` on the dataset ``smoke`` (in
    this process), the launch counts set to 0 just before and read just
    after, under a ``StepTrace``; returns (launches, trace, seconds, peak
    allocated bytes, log dir)."""
    argv = ["--dataset", "smoke", "--data_prefix", data_prefix,
            "--log_prefix", osp.join(tmp, "runs"), "--exp_nm", exp, *argv]
    for kern in KERNELS:
        kern.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with StepTrace() as tr:
        t = run_module("lp_gnn_tpu_torch.train", argv)
    launches = {kern.__name__: kern.launches for kern in KERNELS}
    log_dir = osp.join(tmp, "runs", exp)
    for f in ("mdl.pth", "train_state.pth", "args.json", "metrics.jsonl"):
        if not osp.exists(osp.join(log_dir, f)):
            raise SmokeFailure(f"{exp} wrote no {f}")
    losses = [st["loss"] for st in tr.steps]
    if not losses or not np.isfinite(losses).all():
        raise SmokeFailure(f"{exp} step losses {losses}")
    return launches, tr, t, torch.cuda.max_memory_allocated(), log_dir


def sampled_train(seed: int) -> dict:
    """The sampled training path through the entry point: 4 bench-shape LPs
    (2 train, 2 val) above SAMPLED_THRESH, GCN_FC bf16, balanced CE, Adam,
    1 epoch: each train graph sampled afresh (fanout [6, 6], SAMPLED_BATCH
    seeds, the short last batch dropped: 6 subgraphs a graph), one step a
    subgraph, its tensors with the input cache. Checks the steps, finite
    losses and the SpMM launches exactly: 2 a subgraph (the cache) + 2 a
    step forward, 2 a step backward."""
    from lp_gnn_tpu_torch.utils.misc import split_idxs_train_val
    n_train = len(split_idxs_train_val(N_TRAIN_LPS)[0])
    steps = n_train * ((M + N) // SAMPLED_BATCH)
    want_bwd = 2 * steps
    want = {**no_launches(), "spmm_csr": 2 * steps + 2 * steps + want_bwd}
    with tempfile.TemporaryDirectory(prefix="lp_gnn_smoke_strain_") as tmp:
        data_prefix = osp.join(tmp, "data")
        write_dataset(osp.join(data_prefix, "smoke", "highs-inp_tgt"),
                      seed + 600, N_TRAIN_LPS)
        launches, tr, t, peak, _ = run_train(
            tmp, data_prefix, ["--arch", ARCH, "--fp16", "1", "--loss",
                               "balanced", "--epochs", "1", "--seed",
                               str(seed), *SAMPLED_ARGS], "strain")
    if launches != want or tr.backward_spmm != want_bwd or \
            len(tr.steps) != steps:
        raise SmokeFailure(
            f"sampled_train: {len(tr.steps)} steps, launches {launches} "
            f"({tr.backward_spmm} in backwards), expected {steps} steps, "
            f"{want} ({want_bwd})")
    dev = [st["device_ms"] for st in tr.steps]
    return {"arch": bf16_arch(ARCH), "train_lps": n_train,
            "fanout": [6, 6], "batch_size": SAMPLED_BATCH, "steps": steps,
            "launches": launches, "spmm_forward": want["spmm_csr"] - want_bwd,
            "spmm_backward": tr.backward_spmm,
            "spmm_formula": f"2 x {steps} subgraphs (input cache) + "
                            f"2 x {steps} forward + 2 x {steps} backward",
            "step_losses": [st["loss"] for st in tr.steps],
            "sampling_s": tr.sample_s, "graph_tensors_s_total":
            sum(tr.tensors_s), "graph_tensors_s": tr.tensors_s,
            "step_device_ms": dev, "step_device_ms_median": sorted(dev)[len(dev) // 2],
            "train_s": t, "max_memory_allocated_bytes": peak}


def twin_graphs(seed: int) -> list[BipartiteGraph]:
    """Two bench-shape LPs of one constraint pattern (an LP family's
    members share it) with their own values, features and labels: the
    same stack key, so --graph_batch 2 and dp=2 stack them."""
    g = bench_graph(seed)
    other = bench_graph(seed + 1)
    return [g, BipartiteGraph(row=g.row, col=g.col, val=other.val,
                              c_feas=other.c_feas, v_feas=other.v_feas,
                              y_s=other.y_s, y_t=other.y_t)]


def split_dataset(n_lps: int, train: list, seed: int) -> list:
    """``train`` at the train positions of the 70/30 split of n_lps LPs,
    small bench-like LPs at the val positions (no val pass reads them)."""
    from lp_gnn_tpu_torch.utils.misc import split_idxs_train_val
    train_idx = list(split_idxs_train_val(n_lps)[0])
    assert len(train_idx) == len(train)
    it = iter(train)
    return [next(it) if i in train_idx else
            bench_graph(seed + 50 + i, m=M // 16, n=N // 16, e=E // 16)
            for i in range(n_lps)]


def update_rels(w0: dict, a: dict, b: dict, lr: float) -> dict:
    """Per tensor: max |u_a - u_b| / max |u_b|, where u is an SGD step's
    update (w0 - w) / lr."""
    out = {}
    for k in w0:
        ua = (w0[k].double() - a[k].double().cpu()) / lr
        ub = (w0[k].double() - b[k].double().cpu()) / lr
        out[k] = float((ua - ub).abs().max()
                       / ub.abs().max().clamp(min=1e-30))
    return out


def update_diff(w0: dict, a: dict, b: dict, lr: float) -> float:
    """The largest, over tensors, of ``update_rels``."""
    return max(update_rels(w0, a, b, lr).values())


def seeded_state(arch: str, seed: int) -> dict:
    model = build_model(arch, generator=torch.Generator().manual_seed(seed))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def union_vs_serial(seed: int, graphs: list) -> dict:
    """One ``dp_train_step`` over the union of ``graphs`` against one step
    on the serial mean of the same graphs' losses, on the card from the
    same weights: GCN_FC at full width, fp32, no dropout, SGD at
    UPDATE_LR; the loss within rtol 1e-5, the updates within
    UPDATE_RTOL."""
    from lp_gnn_tpu_torch.data.graph import union
    from lp_gnn_tpu_torch.parallel.dp import dp_train_step
    lr = UPDATE_LR
    w0 = seeded_state(ARCH_NO_DROPOUT, seed)
    loss_fn = LOSS_REGISTRY["balanced"]
    out = {}
    for way in ("union", "serial"):
        model = build_model(ARCH_NO_DROPOUT)
        model.load_state_dict(w0)
        model = model.to("cuda").train()
        opt = trainer.make_optimizer(model.parameters(), "sgd", lr)
        gts = [trainer.train_graph(model, g, "cuda") for g in graphs]
        if way == "union":
            before = spmm_csr.launches
            loss = float(dp_train_step(model, opt, union(gts), loss_fn))
            out["union_step_spmm"] = spmm_csr.launches - before
        else:
            total = 0.0
            for gt in gts:
                lc, lv = model(gt)
                total = total + loss_fn(lc, lv, gt.y_s, gt.y_t,
                                        *trainer.seed_masks(gt))
            total = total / len(gts)
            opt.zero_grad()
            total.backward()
            opt.step()
            loss = float(total.detach())
        out[way] = ({k: v.detach().cpu() for k, v in
                     model.state_dict().items()}, loss)
        del model, opt, gts
        torch.cuda.empty_cache()
    diff = update_diff(w0, out["union"][0], out["serial"][0], lr)
    lu, ls = out["union"][1], out["serial"][1]
    if abs(lu - ls) > 1e-5 * abs(ls) or diff > UPDATE_RTOL:
        raise SmokeFailure(f"union vs serial step: loss {lu} vs {ls}, "
                           f"update rel diff {diff} > {UPDATE_RTOL}")
    return {"loss_union": lu, "loss_serial": ls, "update_rel_diff": diff,
            "update_rtol": UPDATE_RTOL,
            "union_step_spmm": out["union_step_spmm"]}


def graph_batch(seed: int) -> dict:
    """``--graph_batch 2`` through the train entry point (GCN_FC bf16, 1
    epoch) on 3 train LPs: two of one stack key (a stack) and one of
    another (half the edges: a single). Checks the stacks, singles and
    sampled graphs the trainer made, the SpMM launches (2 a member for its
    input cache, 4 the union step, not 4 a graph; 2 + 4 the single) and
    finite losses; then ``union_vs_serial`` on the twins."""
    from lp_gnn_tpu_torch.data.stacking import stack_key
    twins = twin_graphs(seed + 800)
    single = bench_graph(seed + 803, e=E // 2)
    if stack_key(twins[0]) != stack_key(twins[1]) or \
            stack_key(single) == stack_key(twins[0]):
        raise SmokeFailure("graph_batch: stack keys not as designed")
    groups = {}
    real_groups = trainer.stack_groups

    def seen_groups(*a, **kw):
        groups["v"] = real_groups(*a, **kw)
        return groups["v"]
    with tempfile.TemporaryDirectory(prefix="lp_gnn_smoke_gb_") as tmp:
        data_prefix = osp.join(tmp, "data")
        write_dataset(osp.join(data_prefix, "smoke", "highs-inp_tgt"), 0, 5,
                      split_dataset(5, [*twins, single], seed))
        trainer.stack_groups = seen_groups
        try:
            launches, tr, t, peak, _ = run_train(
                tmp, data_prefix, ["--arch", ARCH, "--fp16", "1", "--epochs",
                                   "1", "--graph_batch", "2", "--seed",
                                   str(seed)], "gb")
        finally:
            trainer.stack_groups = real_groups
    stacks, singles, sampled = groups["v"]
    kinds = [st["kind"] for st in tr.steps]
    per_step = [st["launches"]["spmm_csr"] for st in tr.steps]
    want = {**no_launches(), "spmm_csr": 2 * 2 + 4 + 2 + 4}
    if (len(stacks), len(singles), len(sampled)) != (1, 1, 0) or \
            kinds != ["dp_train_step", "train_step"] or \
            per_step != [4, 4] or launches != want:
        raise SmokeFailure(f"graph_batch: stacks {stacks}, singles "
                           f"{singles}, sampled {sampled}, steps {kinds}, "
                           f"SpMM a step {per_step}, launches {launches} "
                           f"(expected {want})")
    torch.cuda.empty_cache()
    return {"arch": bf16_arch(ARCH), "stacks": stacks, "singles": singles,
            "sampled": sampled, "steps": kinds,
            "spmm_per_step": per_step, "launches": launches,
            "spmm_formula": "2 x 2 members' input caches + 4 the union step "
                            "+ (2 + 4) the single",
            "step_losses": [st["loss"] for st in tr.steps],
            "step_device_ms": [st["device_ms"] for st in tr.steps],
            "graph_tensors_s": tr.tensors_s, "train_s": t,
            "max_memory_allocated_bytes": peak,
            "union_vs_serial": union_vs_serial(seed, twins)}


def free_port() -> int:
    return free_ports(1)[0]


def free_ports(n: int) -> list[int]:
    """``n`` distinct free ports (all bound at once, then released)."""
    import socket
    with contextlib.ExitStack() as stack:
        socks = [stack.enter_context(socket.socket()) for _ in range(n)]
        for sock in socks:
            sock.bind(("localhost", 0))
        return [sock.getsockname()[1] for sock in socks]


def nccl_allreduce(numel: int) -> dict:
    """One process joins an NCCL group through the LP_GNN_DIST_* contract
    (NPROCS=1) and all-reduces ``numel`` fp32 values on the card (the
    size of the model's gradients), checked and timed; the group is
    destroyed and the contract taken off after."""
    from lp_gnn_tpu_torch.parallel import mesh
    env = {"LP_GNN_DIST_COORD": f"localhost:{free_port()}",
           "LP_GNN_DIST_NPROCS": "1", "LP_GNN_DIST_PROC_ID": "0"}
    os.environ.update(env)
    try:
        dev, created = mesh.init_distributed(torch.device("cuda"))
        try:
            backend = torch.distributed.get_backend()
            x = torch.arange(numel, dtype=torch.float32, device=dev)
            want = x.clone()
            torch.distributed.all_reduce(x)
            torch.cuda.synchronize()
            ms = time_ms(lambda: torch.distributed.all_reduce(x), 10)
            if backend != "nccl" or not created or not torch.equal(x, want):
                raise SmokeFailure(f"nccl: backend {backend}, created "
                                   f"{created}, all-reduce wrong")
        finally:
            torch.distributed.destroy_process_group()
    finally:
        for k in env:
            del os.environ[k]
    return {"backend": backend, "world": 1, "device": str(dev),
            "numel": numel, "allreduce_ms": ms}


def run_ranks(name: str, args_of, ranks: int = DP_RANKS, port: int = 0,
              env_of=lambda rank: {}) -> tuple[list[str], float, list[str]]:
    """``ranks`` processes of this Python, ``args_of(rank)`` each (and
    ``env_of(rank)`` in its environment), joined by the LP_GNN_DIST_*
    contract on the one card (over gloo: NCCL refuses two ranks on one
    device), started together and waited for; returns their output, the
    wall seconds of all and each rank's ``process group:`` lines. Every
    process is ended before it returns; a rank that fails fails the phase.
    ``port``: rank 0's (a free one if 0)."""
    root = osp.dirname(osp.abspath(__file__))
    port = port or free_port()
    procs, outs = [], []
    t0 = time.perf_counter()
    try:
        for rank in range(ranks):
            env = dict(os.environ, LP_GNN_DIST_COORD=f"localhost:{port}",
                       LP_GNN_DIST_NPROCS=str(ranks),
                       LP_GNN_DIST_PROC_ID=str(rank), **env_of(rank))
            procs.append(subprocess.Popen(
                [sys.executable, *args_of(rank)], cwd=root, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    if [p.returncode for p in procs] != [0] * ranks:
        raise SmokeFailure(f"{name} ranks failed: " + " | ".join(
            o[-2000:] for o in outs))
    groups = [ln.split("process group:")[1].strip() for o in outs
              for ln in o.splitlines() if "process group:" in ln]
    return outs, wall, groups


def dp_phase(seed: int) -> dict:
    """Two ranks on the one card (processes of ``python -m
    lp_gnn_tpu_torch.train`` joined over gloo by the LP_GNN_DIST_*
    contract; NCCL refuses two ranks on one device) take ``--mesh_shape
    dp=2`` for 1 epoch on the twins (one dp step), GCN_FC fp32 without
    dropout, SGD at UPDATE_LR; the single-process ``--graph_batch 2`` run
    on the same data and weights takes the same step. Rank 0's
    ``mdl.pth`` is held to the single process's (updates within
    UPDATE_RTOL); rank 1 writes no file. Then ``nccl_allreduce``."""
    lr = UPDATE_LR
    with tempfile.TemporaryDirectory(prefix="lp_gnn_smoke_dp_") as tmp:
        data_prefix = osp.join(tmp, "data")
        write_dataset(osp.join(data_prefix, "smoke", "highs-inp_tgt"), 0, 4,
                      split_dataset(4, twin_graphs(seed + 900), seed))
        argv = ["--arch", ARCH_NO_DROPOUT, "--opt", "sgd", "--lr", str(lr),
                "--epochs", "1", "--seed", str(seed)]
        _, t_ranks, groups = run_ranks("dp", lambda rank: [
            "-m", "lp_gnn_tpu_torch.train", "--dataset", "smoke",
            "--data_prefix", data_prefix, "--exp_nm", "dp", *argv,
            "--mesh_shape", f"dp={DP_RANKS}", "--log_prefix",
            osp.join(tmp, f"rank{rank}")])
        if osp.exists(osp.join(tmp, "rank1")):
            raise SmokeFailure("dp: rank 1 wrote files")
        ranks = torch.load(osp.join(tmp, "rank0", "dp", "mdl.pth"),
                           weights_only=True)
        launches, tr, t, peak, log_dir = run_train(
            tmp, data_prefix, argv + ["--graph_batch", "2"], "gb")
        single = torch.load(osp.join(log_dir, "mdl.pth"), weights_only=True)
    diff = update_diff(seeded_state(ARCH_NO_DROPOUT, seed), ranks, single,
                       lr)
    if diff > UPDATE_RTOL or len(groups) != DP_RANKS or \
            not all("gloo" in s for s in groups):
        raise SmokeFailure(f"dp: update rel diff {diff} (limit "
                           f"{UPDATE_RTOL}), groups {groups}")
    return {"ranks": DP_RANKS, "groups": groups, "ranks_s": t_ranks,
            "update_rel_diff_vs_graph_batch": diff,
            "update_rtol": UPDATE_RTOL, "launches": launches,
            "single_step_losses": [st["loss"] for st in tr.steps],
            "single_train_s": t,
            "nccl": nccl_allreduce(sum(v.numel() for v in single.values()))}


# ------------------------------------- edge-partitioned training and the zoo
# Every shard of K_EDGE on the one card. A GraphConv conv over the partition
# launches one gather (the gather direction), one stacked K1 (the reduce
# direction) and K x 5 SpMMs; its backward the same again, the halo pair's
# backwards swapping the gather and K1 (HaloGather's is a K1 and K SpMMs,
# HaloReduce's one gather) and every SpMM's backward one SpMM over its
# partner CSR. A GEN conv launches one gather (r2l's halo), K gen_agg_fwd a
# direction, one K1 and one gen_lse_merge (l2r's owners); its backward one
# K1 and K SpMMs (HaloGather), one gather (l2r's statistics to the slots),
# K gen_agg_bwd a direction and K SpMMs a direction (the gathers' backward).
DIST_ARGS = ["--mesh_shape", f"edge={K_EDGE}", "--edge_num_thresh", "0"]
DIST_CONV = {"halo_all_to_all": 1, "gather_rows": 1, "spmm_csr": 5 * K_EDGE}
DIST_GEN_CONV = {"gather_rows": 1, "gen_agg_fwd": 2 * K_EDGE,
                 "halo_all_to_all": 1, "gen_lse_merge": 1}
DIST_GEN_CONV_BWD = {"halo_all_to_all": 1, "gather_rows": 1,
                     "gen_agg_bwd": 2 * K_EDGE, "spmm_csr": 3 * K_EDGE}
# the all-gather layout (K_EDGE shards on the card): a GraphConv conv one
# SpMM a shard over full v2c and one over full c2v (their backward the
# same); a GEN conv 2 gen_agg_fwd a shard and one merge of the K parts,
# its backward 2 gen_agg_bwd and 2 SpMMs (the gathers' transpose) a shard;
# no K1, no gather
AG_CONV = {"spmm_csr": 2 * K_EDGE}
AG_GEN_CONV = {"gen_agg_fwd": 2 * K_EDGE, "gen_lse_merge": 1}
AG_GEN_CONV_BWD = {"gen_agg_bwd": 2 * K_EDGE, "spmm_csr": 2 * K_EDGE}
N_DIST_TRAIN_LPS = 3        # 2 train, 1 val
DIST_TRAIN_EPOCHS = 2
# the zoo served edge-partitioned at the GEN phases' width: convs a forward
DIST_ZOO = {"GCN(8,8,hids=256)": 3, "GCNDeeper(8,8,hids=256,depth=5)": 5,
            "GENDeeper(8,8,hids=256,depth=5)": 5, "GCNRand()": 0}
DIST_GEN_ARCH = "GENDeeper(8,8,hids=256,depth=5)"
# dist vs single-card logits in bf16: the dist mean |err| against the single
# card's fp32 at most this times the single card's own bf16 mean |err| (the
# rule of tests/test_torch_edge_partition.py's bf16 test)
DIST_BF16_SPREAD = 3.0
# the dist step's fp32 update against the single card's, per tensor: at
# most this times the single card's own spread in that tensor against its
# fp64 step (each fp32 step lies within about that spread of the fp64
# one), and never below UPDATE_RTOL
DIST_UPDATE_SPREAD = 2.0


def scaled(per: dict, n: int) -> dict:
    return {k: v * n for k, v in per.items()}


def add_launches(*parts: dict) -> dict:
    out = no_launches()
    for p in parts:
        for k, v in p.items():
            out[k] += v
    return out


def launch_counts() -> dict:
    return {kern.__name__: kern.launches for kern in KERNELS}


def launches_since(before: dict) -> dict:
    now = launch_counts()
    return {k: now[k] - before[k] for k in now}


def dist_step_launches(arch: str, halo: bool = True) -> dict:
    """Launches of one dist step (input cache built) over the halo or the
    all-gather layout: GCN_FC(depth=3)'s one hidden conv forward and
    backward (conv1 reads the cache and its inputs take no gradient); every
    GEN conv of DIST_GEN_ARCH forward and backward (no cache, no remat)."""
    if arch.startswith("GENDeeper"):
        convs = DIST_ZOO[DIST_GEN_ARCH]
        fwd, bwd = (DIST_GEN_CONV, DIST_GEN_CONV_BWD) if halo else \
            (AG_GEN_CONV, AG_GEN_CONV_BWD)
        return add_launches(scaled(fwd, convs), scaled(bwd, convs))
    return add_launches(scaled(DIST_CONV if halo else AG_CONV, 2))


def dist_forward_launches(arch: str, halo: bool = True) -> dict:
    """Launches of one dist forward (no input cache) over the halo or the
    all-gather layout: GCN_FC(depth=3)'s two convs; every GEN conv of
    DIST_GEN_ARCH."""
    if arch.startswith("GENDeeper"):
        return add_launches(scaled(DIST_GEN_CONV if halo else AG_GEN_CONV,
                                   DIST_ZOO[DIST_GEN_ARCH]))
    return add_launches(scaled(DIST_CONV if halo else AG_CONV, 2))


def step_states(arch: str, w0: dict, g: BipartiteGraph, ways,
                halo: bool = True, mesh=None) -> dict:
    """One step of ``arch`` from the weights ``w0`` on ``g`` each way of
    ``ways``: ``single`` (the single card's, fp32), ``dist`` (K_EDGE
    shards on the card over the halo or the all-gather layout, the
    trainer's tensors and input cache, fp32),
    ``fp64`` (the single card's with its convs and SpMM sums in fp64);
    dropout 0, SGD at UPDATE_LR, balanced CE. Returns each way's weights on
    the host, loss, launches, span on the card (CUDA events) and peak
    memory. ``mesh``: the dist way's (K_EDGE shards stacked on the card by
    default)."""
    lr = UPDATE_LR
    loss_fn = LOSS_REGISTRY["balanced"]
    dg = edge_partition.partition_graph(g, K_EDGE, halo=halo)
    mesh = mesh or make_mesh(K_EDGE, "cuda")
    out = {}
    for way in ways:
        model = build_model(arch)
        model.load_state_dict(w0)
        model.dp = 0.0
        real = spmm_mod.spmm_csr
        if way == "fp64":
            model.double()
            model.cdtype = torch.float64
            spmm_mod.spmm_csr = spmm_sum_in_x_dtype
        try:
            model = model.to("cuda").train()
            opt = trainer.make_optimizer(model.parameters(), "sgd", lr)
            if way == "dist":
                data = edge_partition.dist_tensors(model, dg, mesh,
                                                   input_agg=True)
            else:
                data = trainer.train_graph(model, g, "cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            before = launch_counts()
            ev[0].record()
            if way == "dist":
                loss = edge_partition.dist_train_step(model, opt, data,
                                                      loss_fn)
            else:
                loss, _ = trainer.train_step(model, opt, data, loss_fn)
            ev[1].record()
            torch.cuda.synchronize()
        finally:
            spmm_mod.spmm_csr = real
        out[way] = {"state": {k: v.detach().cpu() for k, v in
                              model.state_dict().items()},
                    "loss": float(loss), "launches": launches_since(before),
                    "step_device_ms": ev[0].elapsed_time(ev[1]),
                    "max_memory_allocated_bytes":
                        torch.cuda.max_memory_allocated()}
        del model, opt, data
        torch.cuda.empty_cache()
    return out


def dist_vs_single_step(seed: int, arch: str, g: BipartiteGraph,
                        fp64_witness: bool = False, halo: bool = True) -> dict:
    """One dist step (K_EDGE shards on the card, the trainer's tensors and
    input cache) against the single-card step, from the same weights on
    the same LP: ``arch`` in fp32, dropout 0, SGD at UPDATE_LR, balanced CE.
    The loss within rtol 1e-5; each tensor's update within its limit of
    that tensor's largest (``update_rels``): UPDATE_RTOL, or with
    ``fp64_witness`` the larger of UPDATE_RTOL and DIST_UPDATE_SPREAD times
    the single card's own spread in that tensor, its ``update_rels`` of the
    fp32 step against the same step with its convs and SpMM sums in fp64
    (the SpMM's plain version summed in fp64 on the card; the loss stays
    fp32, as in every run). The dist step's launches exact
    (``dist_step_launches``); both fp32 steps' spans on the card (CUDA
    events) and peak memory. ``halo``: the dist step's layout."""
    lr = UPDATE_LR
    w0 = seeded_state(arch, seed)
    out = step_states(arch, w0, g, ("single", "dist")
                      + (("fp64",) if fp64_witness else ()), halo)
    want = dist_step_launches(arch, halo)
    got = out["dist"]["launches"]
    rels = update_rels(w0, out["dist"]["state"], out["single"]["state"], lr)
    held = {"update_rels": rels}
    limits = {k: UPDATE_RTOL for k in rels}
    if fp64_witness:
        spread = update_rels(w0, out["single"]["state"],
                             out["fp64"]["state"], lr)
        limits = {k: max(UPDATE_RTOL, DIST_UPDATE_SPREAD * spread[k])
                  for k in rels}
        held.update(single_vs_fp64_update_rels=spread,
                    dist_vs_fp64_update_rels=update_rels(
                        w0, out["dist"]["state"], out["fp64"]["state"], lr),
                    loss_fp64=out["fp64"]["loss"],
                    spread_factor=DIST_UPDATE_SPREAD)
    ld, ls = out["dist"]["loss"], out["single"]["loss"]
    worst = max(rels, key=lambda k: rels[k] / limits[k])
    if got != want or abs(ld - ls) > 1e-5 * abs(ls) or \
            rels[worst] > limits[worst]:
        raise SmokeFailure(
            f"{arch} dist vs single-card step: launches {got} (expected "
            f"{want}), loss {ld} vs {ls}, update rel diff {rels[worst]} in "
            f"{worst} > {limits[worst]}: {json.dumps(held)}")
    return {"arch": arch, "K": K_EDGE, "dtype": "float32", "lr": lr,
            "layout": "halo" if halo else "all-gather",
            "loss_dist": ld, "loss_single": ls,
            "update_diff_max": max(rels.values()),
            "nearest_limit": {"tensor": worst, "update_diff": rels[worst],
                              "limit": limits[worst]},
            **held, "launches": got,
            **{f"{way}_{k}": out[way][k] for way in ("single", "dist")
               for k in ("step_device_ms", "max_memory_allocated_bytes")}}


def dist_train(seed: int) -> dict:
    """The flagship recipe edge-partitioned through ``python -m
    lp_gnn_tpu_torch.train --mesh_shape edge=4 --edge_num_thresh 0``: GCN_FC
    bf16, balanced CE, Adam, N_DIST_TRAIN_LPS bench-shape LPs (2 train, 1
    val), DIST_TRAIN_EPOCHS epochs and a val pass through the dist forward.
    Checks finite losses, the checkpoints, and the launches exactly, by
    step and in all: a train graph's input cache one conv's, a step the
    hidden conv's forward and backward, a val forward two convs'. Reports
    each epoch's wall time, the steps' spans on the card, the partitions'
    host seconds and tensors, peak memory; then ``dist_vs_single_step``."""
    from lp_gnn_tpu_torch.utils.misc import split_idxs_train_val
    n_train, n_val = map(len, split_idxs_train_val(N_DIST_TRAIN_LPS))
    steps = n_train * DIST_TRAIN_EPOCHS
    per_step = dist_step_launches(ARCH)
    want = add_launches(scaled(DIST_CONV, n_train),
                        scaled(per_step, steps),
                        scaled(DIST_CONV, 2 * n_val))
    epoch_ends = []
    real_save = trainer.save_checkpoint

    def save_seen(*a, **kw):
        epoch_ends.append(time.perf_counter())
        return real_save(*a, **kw)

    with tempfile.TemporaryDirectory(prefix="lp_gnn_smoke_dtrain_") as tmp:
        data_prefix = osp.join(tmp, "data")
        write_dataset(osp.join(data_prefix, "smoke", "highs-inp_tgt"),
                      seed + 1000, N_DIST_TRAIN_LPS)
        trainer.save_checkpoint = save_seen
        t0 = time.perf_counter()
        try:
            launches, tr, t, peak, _ = run_train(
                tmp, data_prefix, ["--arch", ARCH, "--fp16", "1", "--loss",
                                   "balanced", "--epochs",
                                   str(DIST_TRAIN_EPOCHS), "--eval_every",
                                   str(DIST_TRAIN_EPOCHS), "--seed",
                                   str(seed), *DIST_ARGS], "dtrain")
        finally:
            trainer.save_checkpoint = real_save
    kinds = {st["kind"] for st in tr.steps}
    per = [st["launches"] for st in tr.steps]
    if launches != want or len(tr.steps) != steps or \
            kinds != {"dist_train_step"} or any(p != per_step for p in per):
        raise SmokeFailure(f"dist_train: {len(tr.steps)} steps {kinds}, "
                           f"launches {launches} (expected {want}), a step "
                           f"{per} (expected {per_step})")
    dev = [st["device_ms"] for st in tr.steps]
    ends = [t0] + epoch_ends
    return {"arch": bf16_arch(ARCH), "K": K_EDGE, "train_lps": n_train,
            "val_lps": n_val, "epochs": DIST_TRAIN_EPOCHS, "steps": steps,
            "launches": launches, "launches_expected": want,
            "launches_per_step": per_step,
            "launch_formula": f"one conv's (DIST_CONV {DIST_CONV}) x "
                              f"{n_train} input caches + a step's x {steps} "
                              f"+ 2 convs' x {n_val} val forwards",
            "step_losses": [st["loss"] for st in tr.steps],
            "step_device_ms": dev,
            "step_device_ms_median_after_first": sorted(dev[1:])[
                len(dev[1:]) // 2] if len(dev) > 1 else None,
            "epoch_wall_s": [b - a for a, b in zip(ends, ends[1:])],
            "partition_s": tr.partition_s,
            "dist_tensors_s": tr.dist_tensors_s, "train_s": t,
            "max_memory_allocated_bytes": peak,
            "vs_single_card": dist_vs_single_step(
                seed, ARCH_NO_DROPOUT, bench_graph(seed + 1100),
                fp64_witness=True)}


def dist_zoo_per_forward(arch: str) -> dict:
    convs = DIST_ZOO[arch]
    if arch.startswith("GENDeeper"):
        return scaled(DIST_GEN_CONV, convs)
    return scaled(DIST_CONV, convs)


def dist_zoo_serve(seed: int) -> dict:
    """GCN, GCNDeeper, GENDeeper (width 256) and GCNRand through
    ``pred_basis --mesh_shape edge=4 --edge_num_thresh 0`` on one
    bench-shape LP each (the partition cached by the first): valid bases,
    the launches of ``dist_zoo_per_forward`` exactly in every forward,
    ``inf_time``; then each arch's dist logits on that LP against the
    single card's with the same weights: fp32 max |err| <= 1e-3, bf16 mean
    |err| against the single card's fp32 at most DIST_BF16_SPREAD times the
    single card's bf16 mean |err| (GCNRand: finite, of the shape)."""
    out = {}
    g = bench_graph(seed + 1200)
    mesh = make_mesh(K_EDGE, "cuda")
    dg = edge_partition.partition_graph(g, K_EDGE, halo=True)
    with tempfile.TemporaryDirectory(prefix="lp_gnn_smoke_dzoo_") as tmp:
        data_prefix = osp.join(tmp, "data")
        write_dataset(osp.join(data_prefix, "smoke", "highs-inp_tgt"), 0, 1,
                      [g])
        for i, arch in enumerate(DIST_ZOO):
            ckpt = save_seeded(arch, seed, osp.join(tmp, f"mdl{i}.pth"))
            per = dist_zoo_per_forward(arch)
            res = serve_and_check(data_prefix, osp.join(tmp, f"runs{i}"), ckpt,
                                  seed, 1, "trainval", per, DIST_ARGS, arch)
            out[bf16_arch(arch)] = {
                "per_forward": per, "reference": dist_logits_held(arch, seed,
                                                                  g, dg, mesh),
                **{k: res[k] for k in ("lps", "bas_valid", "forwards",
                                       "launches", "inf_time_s",
                                       "part_time_s")}}
            torch.cuda.empty_cache()
    total = no_launches()
    for r in out.values():
        for k, n in r["launches"].items():
            total[k] += n
    return {"K": K_EDGE, "archs": out, "launches": total}


def dist_logits_held(arch: str, seed: int, g: BipartiteGraph, dg, mesh) -> dict:
    """``arch``'s dist logits on ``g`` (partition ``dg``) against the single
    card's, with the weights ``save_seeded`` gives (dist_zoo_serve's rule)."""
    logits = {}
    for dtype in ("float32", "bfloat16"):
        base = arch.strip()[:-1]
        spec = base + ("" if base.endswith("(") else ",") + f"dtype='{dtype}')"
        model = build_model(spec, generator=torch.Generator().manual_seed(seed))
        model = model.to("cuda").eval()
        with torch.inference_mode():
            for path in ("single", "dist"):
                if path == "single":
                    lc, lv = model(GraphTensors.from_graph(g, "cuda"))
                else:
                    lc, lv = edge_partition.dist_apply(model, dg, mesh)
                    lc, lv = lc[:g.ncons], lv[:g.nvars]
                got = torch.cat([lc, lv]).cpu().numpy()
                if not (np.isfinite(got).all() and got.shape == (M + N, 3)):
                    raise SmokeFailure(f"{arch} {dtype} {path}: bad logits")
                logits[dtype, path] = got
        del model
    if arch == "GCNRand()":
        return {"checked": "finite, (M+N, 3): its logits are random"}
    ref = logits["float32", "single"]
    err32 = np.abs(logits["float32", "dist"] - ref)
    dist16 = np.abs(logits["bfloat16", "dist"] - ref).mean()
    single16 = np.abs(logits["bfloat16", "single"] - ref).mean()
    if err32.max() > 1e-3 or dist16 > DIST_BF16_SPREAD * single16:
        raise SmokeFailure(f"{arch}: dist vs single fp32 max |err| "
                           f"{err32.max()} (limit 1e-3); bf16 mean |err| "
                           f"{dist16} > {DIST_BF16_SPREAD} x {single16}")
    return {"float32_max_abs_err": float(err32.max()), "atol": 1e-3,
            "bfloat16_dist_mean_abs_err": float(dist16),
            "bfloat16_single_mean_abs_err": float(single16),
            "bf16_spread_factor": DIST_BF16_SPREAD}


def dist_gen_train(seed: int) -> dict:
    """One dist GENDeeper(8,8,hids=256,depth=5) step at K=4 held against
    the single-card GEN step (``dist_vs_single_step``, every tensor's
    update within UPDATE_RTOL); its measured launches are this path's."""
    return dist_vs_single_step(seed, DIST_GEN_ARCH, bench_graph(seed + 1400))


# ------------------------------------------------------- dp x edge training
# DP_RANKS ranks on the one card, each holding its block of a batch (one of
# the twins) as K_EDGE shards; every oversize graph is a batch member.
DP_EDGE_ARGS = ["--mesh_shape", f"dp={DP_RANKS},edge={K_EDGE}",
                "--edge_num_thresh", "0"]
DP_EDGE_EPOCHS = 2


def traced_run(module: str, argv: list[str]) -> dict:
    """``python -m module argv`` in this process under a ``StepTrace``, the
    launch counts set to 0 just before and read just after; the
    partitions' host seconds and each gradient all-reduce's wall ms
    (``combined.average_over_ranks`` over the dp ranks, ``grid_average``
    over the grid: synchronized on both sides, after a barrier whose wait
    is kept apart) read from wrappers that add no work on the card.
    Returns its launches, steps, partition and tensor seconds, all-reduce
    ms and waits, peak memory, wall seconds, the JSON lines it printed and
    the digest of the stepped model's final weights (``weights_digest``;
    None if it took no step)."""
    from lp_gnn_tpu_torch.parallel import combined
    allreduce_ms, wait_ms, partition_s = [], [], []
    real = {n: getattr(combined, n)
            for n in ("average_over_ranks", "grid_average")}
    real_part = trainer.partition_batch

    def timed(name):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.distributed.barrier()
            t1 = time.perf_counter()
            out = real[name](*a, **kw)
            torch.cuda.synchronize()
            wait_ms.append((t1 - t0) * 1e3)
            allreduce_ms.append((time.perf_counter() - t1) * 1e3)
            return out
        return call

    def part(*a, **kw):
        t0 = time.perf_counter()
        out = real_part(*a, **kw)
        partition_s.append(time.perf_counter() - t0)
        return out

    for kern in KERNELS:
        kern.launches = 0
    torch.cuda.reset_peak_memory_stats()
    for name in real:
        setattr(combined, name, timed(name))
    trainer.partition_batch = part
    buf = io.StringIO()
    try:
        with StepTrace() as tr, contextlib.redirect_stdout(buf):
            t = run_module(module, argv)
    finally:
        for name, fn in real.items():
            setattr(combined, name, fn)
        trainer.partition_batch = real_part
    return {"launches": launch_counts(), "steps": tr.steps,
            "partition_s": partition_s,
            "dist_tensors_s": tr.dist_tensors_s,
            "allreduce_ms": allreduce_ms, "allreduce_wait_ms": wait_ms,
            "wall_s": t,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "lines": [json.loads(ln) for ln in buf.getvalue().splitlines()
                      if ln.startswith("{")],
            "weights_digest": weights_digest(tr.model)}


def weights_digest(model) -> str | None:
    """sha256 of every tensor of ``model``'s state dict, byte for byte, in
    its order; None for no model."""
    if model is None:
        return None
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().reshape(-1).contiguous().view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()


def grid_rank(payload_path: str) -> None:
    """One rank of the grid phases, in this process (``--grid_rank``):
    each of the payload's runs in turn, an entry point through
    ``traced_run`` in a process group of its own (the run's coordinates;
    the run's ``argv`` and a log prefix of the rank's own). Writes the
    runs' reports, by name, into the payload's directory."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    with open(payload_path) as f:
        p = json.load(f)
    rank = int(os.environ["LP_GNN_DIST_PROC_ID"])
    report = {}
    for run in p["runs"]:
        os.environ["LP_GNN_DIST_COORD"] = run["coord"]
        argv = list(run["argv"])
        if run.get("log"):
            argv += ["--log_prefix", osp.join(p["dir"], f"{run['log']}{rank}")]
        report[run["name"]] = traced_run(run["module"], argv)
        torch.cuda.empty_cache()
    with open(osp.join(p["dir"], f"{p['name']}_rank{rank}.json"), "w") as f:
        json.dump(report, f)


def union_step_fp64(seed: int, graphs: list, lr: float) -> dict:
    """The single process's ``--graph_batch 2`` step on ``graphs`` (one
    ``dp_train_step`` over their union, from the seeded weights of
    ARCH_NO_DROPOUT, SGD at ``lr``, balanced CE) with its convs and SpMM
    sums in fp64 on the card (``dist_vs_single_step``'s witness); returns
    the weights."""
    from lp_gnn_tpu_torch.data.graph import union
    from lp_gnn_tpu_torch.parallel.dp import dp_train_step
    model = build_model(ARCH_NO_DROPOUT)
    model.load_state_dict(seeded_state(ARCH_NO_DROPOUT, seed))
    model.double()
    model.cdtype = torch.float64
    real = spmm_mod.spmm_csr
    spmm_mod.spmm_csr = spmm_sum_in_x_dtype
    try:
        model = model.to("cuda").train()
        opt = trainer.make_optimizer(model.parameters(), "sgd", lr)
        u = union([trainer.train_graph(model, g, "cuda") for g in graphs])
        dp_train_step(model, opt, u, LOSS_REGISTRY["balanced"])
    finally:
        spmm_mod.spmm_csr = real
    out = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del model, opt, u
    torch.cuda.empty_cache()
    return out


def dp_edge(seed: int) -> dict:
    """dp x edge training through ``python -m lp_gnn_tpu_torch.train
    --mesh_shape dp=2,edge=4 --edge_num_thresh 0``: DP_RANKS processes on
    the one card (gloo), the twins as one batch, each rank one of them as
    K_EDGE shards. Parity: one epoch (one dp x edge step) of GCN_FC fp32
    without dropout, SGD at UPDATE_LR; rank 0's ``mdl.pth`` held to the
    single process's ``--graph_batch 2`` step on the same twins and
    weights, each tensor's update within the larger of UPDATE_RTOL and
    DIST_UPDATE_SPREAD times that step's own spread against its fp64
    witness (``union_step_fp64``); both groups gloo, no rank-1 file.
    Recipe: the same ranks (one launch of this script's ``--grid_rank``,
    each entry point under a ``StepTrace``) run GCN_FC bf16, balanced CE,
    Adam, the arch's dropout, DP_EDGE_EPOCHS epochs: each rank's launches
    exactly one input cache (one dist conv) and a dist step's a step,
    equal finite losses on both ranks; each rank's step spans on the card,
    all-reduce ms, peak memory, partition and tensor seconds, wall."""
    lr = UPDATE_LR
    twins = twin_graphs(seed + 1200)
    with tempfile.TemporaryDirectory(prefix="lp_gnn_smoke_dpe_") as tmp:
        data_prefix = osp.join(tmp, "data")
        write_dataset(osp.join(data_prefix, "smoke", "highs-inp_tgt"), 0, 4,
                      split_dataset(4, twins, seed))
        data = ["--dataset", "smoke", "--data_prefix", data_prefix]
        argv = ["--arch", ARCH_NO_DROPOUT, "--opt", "sgd", "--lr", str(lr),
                "--epochs", "1", "--seed", str(seed)]
        recipe = ["--arch", ARCH, "--fp16", "1", "--loss", "balanced",
                  "--epochs", str(DP_EDGE_EPOCHS), "--seed", str(seed)]
        train = "lp_gnn_tpu_torch.train"
        reports, t_ranks, groups = rank_runs("dp_edge", DP_RANKS, tmp, [
            {"name": "parity", "module": train, "log": "rank",
             "argv": [*data, "--exp_nm", "dpe", *argv, *DP_EDGE_ARGS]},
            {"name": "recipe", "module": train, "log": "recipe",
             "argv": [*data, "--exp_nm", "dpe_recipe", *recipe,
                      *DP_EDGE_ARGS]}])
        if osp.exists(osp.join(tmp, "rank1")) or \
                len(groups) != 2 * DP_RANKS or \
                not all("gloo" in g for g in groups):
            raise SmokeFailure(f"dp_edge: groups {groups}, rank 1's files "
                               f"{osp.exists(osp.join(tmp, 'rank1'))}")
        ranks = torch.load(osp.join(tmp, "rank0", "dpe", "mdl.pth"),
                           weights_only=True)
        _, tr_single, _, _, log_dir = run_train(
            tmp, data_prefix, argv + ["--graph_batch", "2"], "gb")
        single = torch.load(osp.join(log_dir, "mdl.pth"), weights_only=True)
        recipe_files = [osp.exists(osp.join(tmp, f"recipe{r}", "dpe_recipe",
                                            "mdl.pth"))
                        for r in range(DP_RANKS)]
        recipe_rank1 = osp.exists(osp.join(tmp, "recipe1"))
        per_rank = [r["recipe"] for r in reports]
    fp64 = union_step_fp64(seed, twins, lr)
    w0 = seeded_state(ARCH_NO_DROPOUT, seed)
    rels = update_rels(w0, ranks, single, lr)
    spread = update_rels(w0, single, fp64, lr)
    limits = {k: max(UPDATE_RTOL, DIST_UPDATE_SPREAD * spread[k])
              for k in rels}
    worst = max(rels, key=lambda k: rels[k] / limits[k])
    if rels[worst] > limits[worst]:
        raise SmokeFailure(f"dp_edge vs --graph_batch 2: update rel diff "
                           f"{rels[worst]} in {worst} > {limits[worst]}: "
                           f"{json.dumps(rels)}")
    per_step = dist_step_launches(ARCH)
    want = add_launches(DIST_CONV, scaled(per_step, DP_EDGE_EPOCHS))
    losses = [[st["loss"] for st in r["steps"]] for r in per_rank]
    for r, rep in enumerate(per_rank):
        kinds = {st["kind"] for st in rep["steps"]}
        if rep["launches"] != want or kinds != {"dp_edge_train_step"} or \
                len(rep["steps"]) != DP_EDGE_EPOCHS or \
                any(st["launches"] != per_step for st in rep["steps"]):
            raise SmokeFailure(
                f"dp_edge recipe rank {r}: {len(rep['steps'])} steps "
                f"{kinds}, launches {rep['launches']} (expected {want}), a "
                f"step {[st['launches'] for st in rep['steps']]} (expected "
                f"{per_step})")
    if losses[0] != losses[1] or not np.isfinite(losses[0]).all() or \
            recipe_files != [True, False] or recipe_rank1:
        raise SmokeFailure(f"dp_edge recipe: losses {losses}, mdl.pth by "
                           f"rank {recipe_files}")
    return {"arch": bf16_arch(ARCH), "ranks": DP_RANKS, "K": K_EDGE,
            "groups": groups,
            "parity": {"arch": ARCH_NO_DROPOUT, "dtype": "float32",
                       "lr": lr,
                       "single_step_losses": [st["loss"] for st in
                                              tr_single.steps],
                       "update_rels": rels,
                       "single_vs_fp64_update_rels": spread,
                       "dp_edge_vs_fp64_update_rels": update_rels(
                           w0, ranks, fp64, lr),
                       "spread_factor": DIST_UPDATE_SPREAD,
                       "nearest_limit": {"tensor": worst,
                                         "update_diff": rels[worst],
                                         "limit": limits[worst]}},
            "epochs": DP_EDGE_EPOCHS, "launches": add_launches(
                *(r["launches"] for r in per_rank)),
            "launches_per_rank": want, "launches_per_step": per_step,
            "launch_formula": f"a rank: one conv's (DIST_CONV {DIST_CONV}) "
                              f"input cache + a dist step's x "
                              f"{DP_EDGE_EPOCHS} steps",
            "step_losses": losses[0],
            "step_device_ms": [[st["device_ms"] for st in r["steps"]]
                               for r in per_rank],
            "allreduce_ms": [r["allreduce_ms"] for r in per_rank],
            "allreduce_wait_ms": [r["allreduce_wait_ms"] for r in per_rank],
            "max_memory_allocated_bytes": [r["max_memory_allocated_bytes"]
                                           for r in per_rank],
            "partition_s": [r["partition_s"] for r in per_rank],
            "dist_tensors_s": [r["dist_tensors_s"] for r in per_rank],
            "rank_wall_s": [r["wall_s"] for r in per_rank],
            "ranks_s": t_ranks}


# ------------------------------------------------ edge shards on their ranks
# EDGE_RANKS ranks time-share the one card (gloo for the IPC handles, the
# windows' set-up and the gradients; K1's exchanges ordered by flags on
# the card), shard k on rank k. A conv over the ranks'
# shards launches, on each rank: one gather of the send rows, K1's rank
# form twice (the gather direction, then the reduce direction), each
# exchange two launches of its kernel (the write into the ranks' windows
# and the copy-out of the rank's own), and 5 SpMMs
# (local v2c, local c2v, halo v2c, halo c2v, the owner's reduce); its
# backward the same again (the halo pair's backwards swap the two routes,
# each SpMM's backward is one SpMM over its partner CSR). The stacked K1
# launches nowhere on this path.
EDGE_RANKS = K_EDGE
N_RANK_LPS = 2              # LPs served over the ranks (the time budget)
RANK_CONV = {"gather_rows": 1, "halo_all_to_all_ranks": 4, "spmm_csr": 5}
# a GEN conv over the ranks' shards, per rank: r2l's halo gather (the send
# rows' gather and K1), 2 gen_agg_fwd (r2l, l2r), l2r's K1 and merge; its
# backward: r2l's and l2r's gen_agg_bwd, HaloGather's K1 and owner SpMM,
# l2r's statistics to the slots (a gather and K1), the two gathers'
# transpose SpMMs
RANK_GEN_CONV = {"gather_rows": 1, "halo_all_to_all_ranks": 4,
                 "gen_agg_fwd": 2, "gen_lse_merge": 1}
RANK_GEN_CONV_BWD = {"gather_rows": 1, "halo_all_to_all_ranks": 4,
                     "gen_agg_bwd": 2, "spmm_csr": 3}
RANK_ARGS = ["--mesh_shape", f"edge={EDGE_RANKS}", "--edge_num_thresh", "0"]
# rank vs stacked logits in bf16, the same kernels on the same rows: within
# atol + rtol |stacked| (about two bf16 roundings of a logit of 1-10)
RANK_LOGIT_TOL = (2 ** -6, 2 ** -6)   # rtol, atol


class CaptureLogits:
    """``infer/predict.py model_inference`` wrapped to keep each LP's
    first logits this process receives (the bases' decode; rank 0's alone
    over ranks), keyed by LP name."""

    def __init__(self):
        from lp_gnn_tpu_torch.infer import predict
        self.mod, self.real, self.logits = predict, predict.model_inference, {}

    def __enter__(self):
        def capture(model, g, *a, **kw):
            lc, lv = self.real(model, g, *a, **kw)
            if lc is not None and g.fn not in self.logits:
                self.logits[g.fn] = np.concatenate([lc, lv])
            return lc, lv
        self.mod.model_inference = capture
        return self

    def __exit__(self, *exc):
        self.mod.model_inference = self.real


class WindowPeak:
    """``parallel/halo.py _make_window`` wrapped to keep the most bytes
    this process's receive windows (each pair's two windows) held at
    once: cudaMalloc'ed outside torch's caching allocator, they stand
    beside ``max_memory_allocated``."""

    def __enter__(self):
        self.real, self.peak = halo_mod._make_window, halo_mod.window_bytes()

        def make(nbytes, group, dev):
            w = self.real(nbytes, group, dev)
            self.peak = max(self.peak,
                            halo_mod.window_bytes() + w.alloc_bytes)
            return w
        halo_mod._make_window = make
        return self

    def __exit__(self, *exc):
        halo_mod._make_window = self.real


# back-to-back exchanges of the rank form's stress check, and the sleep
# (cycles) that holds one rank's card back before every other write
RANK_STRESS = 64
RANK_HOLD_CYCLES = 2_000_000


class NoHostSync:
    """The host's collectives and synchronises made to raise while the
    rank form's exchanges run: an exchange must make none of them."""
    SYNCS = [(torch.distributed, n) for n in ("barrier", "all_gather",
                                              "all_gather_object")] + [
        (torch.cuda.Stream, "synchronize"), (torch.cuda, "synchronize")]

    def __enter__(self):
        self.saved = [(m, n, getattr(m, n)) for m, n in self.SYNCS]
        for m, n in self.SYNCS:
            def refuse(*a, _name=f"{m.__name__}.{n}", **kw):
                raise SmokeFailure(f"{_name} during the rank form's "
                                   "exchanges")
            setattr(m, n, refuse)
        return self

    def __exit__(self, *exc):
        for m, n, fn in self.saved:
            setattr(m, n, fn)


def rank_launches() -> int:
    """The rank form's launches so far, of either form (one of the two
    counts moves in a group)."""
    return halo_all_to_all_ranks.launches + halo_rank_signalled.launches


def rank_form() -> str:
    """The form of this rank's one window pair (``parallel/halo.py
    rank_form``: the group's layout picked it)."""
    (win,) = halo_mod._WINDOWS.values()
    return win.form


class ExchangeMarks:
    """CUDA events on this rank's stream after each operation of the flags
    form's exchanges (``parallel/halo.py _enqueue`` wrapped), and one before
    each exchange (``start``): the exchange's parts, with a card a rank
    (ROADMAP B5)."""
    PARTS = ("wait_done", "write", "signal_arrival", "wait_arrival",
             "copy_out", "signal_done")

    def __enter__(self):
        self.real, self.marks = halo_mod._enqueue, []

        def enqueue(dev, win, fn_name, *args):
            self.real(dev, win, fn_name, *args)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks[-1].append(ev)
        halo_mod._enqueue = enqueue
        return self

    def start(self) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append([ev])

    def __exit__(self, *exc):
        halo_mod._enqueue = self.real

    def parts_ms(self) -> dict:
        """Each part's mean ms over the exchanges marked (each from e = 3
        on: all six operations), and the whole exchange's."""
        torch.cuda.synchronize()
        rows = [[a.elapsed_time(b) for a, b in zip(m, m[1:])]
                for m in self.marks if len(m) == 1 + len(self.PARTS)]
        out = {p: float(np.mean([r[i] for r in rows]))
               for i, p in enumerate(self.PARTS)}
        out["exchange_ms"] = float(np.mean([sum(r) for r in rows]))
        out["exchanges"] = len(rows)
        return out


# exchanges the parts of an exchange are averaged over, after 2 untimed
SPLIT_EXCHANGES = 10


def flags_form_split(buf: torch.Tensor) -> dict:
    """The flags form's exchange with a card a rank, split into its parts
    by CUDA events on this rank's stream (``ExchangeMarks``): the group
    made to take the flags form (``parallel/mesh.py rank_form`` patched for
    this measurement, the windows and routes made anew), SPLIT_EXCHANGES exchanges
    back to back on every rank at once after 2 untimed, each exact, then
    the windows released again so the layout's form is made anew."""
    real = mesh_mod.rank_form
    halo_mod.release_windows()
    mesh_mod.forget_routes()
    mesh_mod.rank_form = lambda *a: mesh_mod.FLAGS
    try:
        want = halo_all_to_all_ranks(buf)
        again = halo_all_to_all_ranks(buf)
        torch.cuda.synchronize()
        form = rank_form()
        torch.distributed.barrier()
        with ExchangeMarks() as marks:
            outs = []
            for _ in range(SPLIT_EXCHANGES):
                marks.start()
                outs.append(halo_all_to_all_ranks(buf))
            parts = marks.parts_ms()
        exact = torch.equal(want, again) and all(torch.equal(o, want)
                                                 for o in outs)
        del outs, want, again
        halo_mod.release_windows()
    finally:
        mesh_mod.rank_form = real
        mesh_mod.forget_routes()
    return {"form": form, "exact_repeat": exact, **parts}


def signalled_span(buf: torch.Tensor) -> dict:
    """The signalled form's one kernel an exchange, CUDA events on this
    rank's stream around it, over SPLIT_EXCHANGES back-to-back exchanges on
    every rank at once after 2 untimed: its mean and median span a rank,
    and the host's ms an exchange to enqueue them (the span includes any
    wait for a peer whose host is slower)."""
    halo_all_to_all_ranks(buf)
    halo_all_to_all_ranks(buf)
    torch.cuda.synchronize()
    torch.distributed.barrier()
    ev = []
    t0 = time.perf_counter()
    for _ in range(SPLIT_EXCHANGES):
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        pair[0].record()
        halo_all_to_all_ranks(buf)
        pair[1].record()
        ev.append(pair)
    host_ms = (time.perf_counter() - t0) * 1e3 / SPLIT_EXCHANGES
    torch.cuda.synchronize()
    spans = [a.elapsed_time(b) for a, b in ev]
    return {"form": rank_form(), "exchange_ms": float(np.mean(spans)),
            "exchange_ms_median": float(np.median(spans)),
            "exchange_ms_range": [float(min(spans)), float(max(spans))],
            "host_enqueue_ms": host_ms, "exchanges": SPLIT_EXCHANGES}


def rank_kernels_alone(buf: torch.Tensor, out: torch.Tensor):
    """One exchange's two kernels without its flags, as the path launches
    them (``parallel/halo.py _kernels``): the write into window 0 of every
    rank's pair, the copy-out of this rank's (comparison launches: not
    counted). Run while no other rank exchanges."""
    win = halo_mod._window(buf.nbytes, None, buf.device)
    calls = halo_mod._kernels(win, buf, out, 0)

    def launch():
        rcs = [launch_on(buf.device, halo_mod._rank_lib(name), *args)
               for name, args in calls]
        if any(rcs):
            raise SmokeFailure(f"K1's rank kernels alone: CUDA errors {rcs}")
    return launch


def rank_stress(seed: int, bh: int) -> dict:
    """RANK_STRESS exchanges of the rank form back to back, two shapes in
    turn within the windows (Bh x 8 and Bh/8 x 64 bf16), rank 0's card held
    back by ``torch.cuda._sleep`` before every other write, no collective
    and no synchronise of the host among them (``NoHostSync``); each result
    against the stacked plain version, bit for bit. The host's wall from
    the first exchange enqueued to the card's end."""
    k, me = torch.distributed.get_world_size(), torch.distributed.get_rank()
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    shapes = [(bh, 8), (bh // 8, 64)]
    ins, wants = [], []
    for i in range(RANK_STRESS):
        rows, d = shapes[i % 2]
        bufs = torch.randn(k, k * rows, d, generator=gen,
                           device="cuda").to(torch.bfloat16)
        wants.append(halo_all_to_all_plain(bufs)[me].clone())
        ins.append(bufs[me].clone())
        del bufs
    halo_all_to_all_ranks(ins[0])   # the windows exist (grown if need be)
    torch.cuda.synchronize()
    torch.distributed.barrier()
    before = rank_launches()
    t0 = time.perf_counter()
    with NoHostSync():
        outs = []
        for i, x in enumerate(ins):
            if me == 0 and i % 2:
                torch.cuda._sleep(RANK_HOLD_CYCLES)
            outs.append(halo_all_to_all_ranks(x))
        enqueued = time.perf_counter()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bad = [i for i in range(RANK_STRESS) if not torch.equal(outs[i],
                                                            wants[i])]
    return {"exchanges": RANK_STRESS, "exact": not bad, "differ": bad,
            "launches": rank_launches() - before, "form": rank_form(),
            "enqueue_ms": (enqueued - t0) * 1e3, "wall_ms": wall * 1e3,
            "ms_per_exchange": wall * 1e3 / RANK_STRESS,
            "shapes": [list(sh) for sh in shapes]}


def rank_abort(seed: int) -> dict:
    """One rank's launch refused at the C entry: after a good exchange, the
    last rank's buffer is 2 bytes off 16 (cudaErrorInvalidValue), with no
    collective or synchronise of the host among the exchanges. Each rank's
    error (it must raise within three exchanges, naming that rank and its
    error) and seconds; then the windows released and made anew, and an
    exchange exact again."""
    k, me = torch.distributed.get_world_size(), torch.distributed.get_rank()
    gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    bufs = torch.randn(k, k * 40, 64, generator=gen,
                       device="cuda").to(torch.bfloat16)
    want = halo_all_to_all_plain(bufs)[me].clone()
    x = bufs[me].clone()
    bad = x
    if me == k - 1:
        flat = torch.empty(x.numel() + 8, dtype=x.dtype, device="cuda")
        bad = flat[1:1 + x.numel()].view(x.shape)
        bad.copy_(x)
    torch.cuda.synchronize()
    torch.distributed.barrier()
    err, tries, t0 = None, 0, time.perf_counter()
    with NoHostSync():
        halo_all_to_all_ranks(x)
        for tries in range(1, 4):
            try:
                halo_all_to_all_ranks(bad)
            except RuntimeError as ex:
                err = str(ex)
                break
    took = time.perf_counter() - t0
    halo_mod.release_windows()
    again = halo_all_to_all_ranks(x)
    torch.cuda.synchronize()
    return {"error": err, "exchanges_to_raise": tries, "raise_s": took,
            "deadline_s": halo_mod.DEADLINE_S,
            "exact_after": torch.equal(again, want)}


def rank_k1_cases(seed: int, bh: int, plain_group=None,
                  nccl: bool = False) -> dict:
    """K1's rank form on this rank, bench shape (K=EDGE_RANKS, the bench
    graph's Bh) at D=1024 and D=8 bf16, in the form the group's layout
    takes (the flags form where the ranks share a card, the signalled form
    with a card a rank): every rank makes all K buffers from one seed and
    holds its result (twice: the windows reused) and the plain version's
    (gloo, host copies) to the stacked plain version's, bit for bit.
    Times: the flags form's two kernels alone, the write into the windows
    and the copy-out of the own (CUDA events over back-to-back pairs and
    the profiler's device time, one rank at a time while the others
    wait); the signalled form's kernel cannot run alone (it waits for its
    peers): its back-to-back exchanges (``ms``, every rank at once), its
    launch by CUDA events on the rank's stream (``device_ms``) and the
    profiler's. Either form: the whole exchange with its synchronisation
    on the card (``with_sync_ms``: CUDA events over back-to-back
    exchanges, every rank at once); the plain version (one call, host
    clock). Bytes: each flags-form kernel reads and writes K*Bh*D*b,
    4*K*Bh*D*b the pair. Then the stress and abort checks
    (``rank_stress``, ``rank_abort``). ``plain_group``: the gloo group of
    the plain version where the ranks' group is NCCL's; ``nccl``: also
    NCCL's ``all_to_all_single`` of the same blocks on the card
    (``library_ms``: CUDA events over back-to-back calls, every rank at
    once) and, the ranks having a card each, the flags form's exchange
    split into its parts (``flags_form_split``) beside the signalled
    form's span (``signalled_span``)."""
    k, me = torch.distributed.get_world_size(), torch.distributed.get_rank()
    rows = []
    for d in (1024, 8):
        gen = torch.Generator(device="cuda").manual_seed(seed + d)
        bufs = torch.randn(k, k * bh, d, generator=gen,
                           device="cuda").to(torch.bfloat16)
        want = halo_all_to_all_plain(bufs)[me].clone()
        buf = bufs[me].clone()
        del bufs
        split = flags_form_split(buf) if nccl else None
        got = halo_all_to_all_ranks(buf)
        again = halo_all_to_all_ranks(buf)
        torch.cuda.synchronize()
        form = rank_form()
        diff = float((got.float() - want.float()).abs().max())
        exact = torch.equal(got, want) and torch.equal(again, want)
        del got, again
        host = buf.cpu()
        torch.distributed.barrier()
        t0 = time.perf_counter()
        plain = halo_all_to_all_ranks_plain(host, plain_group)
        plain_ms = (time.perf_counter() - t0) * 1e3
        exact_plain = torch.equal(plain, want.cpu())
        del host, plain, want
        ms = device_ms = device_ms_profiler = span = None
        if form == halo_mod.FLAGS:
            out = torch.empty_like(buf)
            launch = rank_kernels_alone(buf, out)
            for r in range(k):
                torch.distributed.barrier()
                if r == me:
                    ms = time_ms(launch, kernel_iters(d))
                    launch()
                    torch.cuda.synchronize()
                    iters = 5
                    seen, complete = profile_kernels(
                        launch, iters, {"halo_pairs_kernel": iters,
                                        "halo_copy_out_kernel": iters})
                    if complete:
                        device_ms = sum(t for name, (t, _) in seen.items()
                                        if "halo_pairs_kernel" in name or
                                        "halo_copy_out_kernel" in name) / iters
                torch.cuda.synchronize()
            del out
        else:
            torch.distributed.barrier()
            ms = time_ms(lambda: halo_all_to_all_ranks(buf), kernel_iters(d))
            span = signalled_span(buf)
            device_ms = span["exchange_ms"]
            torch.distributed.barrier()
            # every rank the same calls: one profiled run, no retry
            seen, complete = profile_kernels(
                lambda: halo_all_to_all_ranks(buf), 5,
                {"halo_rank_signalled_kernel": 5}, tries=1)
            if complete:
                device_ms_profiler = sum(
                    t for name, (t, _) in seen.items()
                    if "halo_rank_signalled_kernel" in name) / 5
        torch.distributed.barrier()
        with_sync_ms = time_ms(lambda: halo_all_to_all_ranks(buf), 10)
        library_ms = None
        if nccl:
            recv = torch.empty_like(buf)
            torch.distributed.barrier()
            library_ms = time_ms(lambda: torch.distributed.all_to_all_single(
                recv, buf), 10)
            if not torch.equal(recv, halo_all_to_all_ranks(buf)):
                raise SmokeFailure("NCCL's all_to_all_single differs from "
                                   "K1's rank form")
            del recv
        n_bytes = 4.0 * k * bh * d * buf.element_size()
        rows.append({"D": d, "form": form, "exact": exact,
                     "exact_plain": exact_plain,
                     "max_abs_err": diff, "ms": ms, "device_ms": device_ms,
                     "device_ms_profiler": device_ms_profiler,
                     "with_sync_ms": with_sync_ms, "library_ms": library_ms,
                     "plain_ms": plain_ms, "bytes": n_bytes,
                     "nvlink_bytes": (k - 1) * bh * d * buf.element_size(),
                     "flags_split": split, "signalled_span": span,
                     "window_bytes": halo_mod.window_bytes()})
        del buf
        torch.cuda.empty_cache()
    return {"rows": rows, "stress": rank_stress(seed, bh),
            "abort": rank_abort(seed)}


def rank_step(seed: int, out_path: str, arch: str, g: BipartiteGraph,
              halo: bool = True) -> dict:
    """One fp32 dist step of ``arch`` on this rank's shard of ``g`` over the
    halo or the all-gather layout (from the seeded weights, dropout 0, SGD
    at UPDATE_LR, balanced CE, the input cache built first where the arch
    reads it), its launches (cache and step) counted from 0; rank 0 writes
    the weights to ``out_path``."""
    k, me = torch.distributed.get_world_size(), torch.distributed.get_rank()
    dg = edge_partition.partition_graph(g, k, halo=halo)
    mesh = make_mesh(k, "cuda", torch.distributed.group.WORLD)
    model = build_model(arch)
    model.load_state_dict(seeded_state(arch, seed))
    model.dp = 0.0
    model = model.to("cuda").train()
    opt = trainer.make_optimizer(model.parameters(), "sgd", UPDATE_LR)
    for kern in KERNELS:
        kern.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with WindowPeak() as win:
        dgt = edge_partition.dist_tensors(model, dg, mesh, input_agg=True)
        cache = launch_counts()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        loss = edge_partition.dist_train_step(model, opt, dgt,
                                              LOSS_REGISTRY["balanced"])
        ev[1].record()
        torch.cuda.synchronize()
    if me == 0:
        torch.save({n: v.detach().cpu() for n, v in
                    model.state_dict().items()}, out_path)
    return {"loss": float(loss), "cache_launches": cache,
            "launches": launches_since(cache),
            "step_device_ms": ev[0].elapsed_time(ev[1]),
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "window_bytes": win.peak}


def edge_rank(payload_path: str) -> None:
    """One rank of the edge_ranks phase, in this process (``--edge_rank``):
    (1) K1's rank form and one fp32 step, in a group of its own; (2) the
    pred_basis entry point; (3) the train entry point under a
    ``StepTrace``, the gloo gradient all-reduce timed after a barrier. Each
    entry point joins a group of its own (the payload's coordinates), the
    launch counts set to 0 just before it and read just after. Writes its
    report (and rank 0 its logits) into the payload's directory."""
    from lp_gnn_tpu_torch.parallel import mesh as mesh_mod
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    with open(payload_path) as f:
        p = json.load(f)
    rank = int(os.environ["LP_GNN_DIST_PROC_ID"])
    t_all = time.perf_counter()
    report = {}
    os.environ["LP_GNN_DIST_COORD"] = p["coords"][0]
    _, created = mesh_mod.init_distributed(torch.device("cuda"))
    try:
        report["k1"] = rank_k1_cases(p["seed"], p["bh"])
        report["step"] = rank_step(
            p["seed"], osp.join(p["dir"], "rank_step.pth"), ARCH_NO_DROPOUT,
            bench_graph(p["seed"] + 1100))
        torch.cuda.empty_cache()
        report["gen_step"] = rank_step(
            p["seed"], osp.join(p["dir"], "rank_gen_step.pth"),
            DIST_GEN_ARCH, bench_graph(p["seed"] + 1400))
    finally:
        mesh_mod.leave_distributed(created)
    torch.cuda.empty_cache()

    os.environ["LP_GNN_DIST_COORD"] = p["coords"][1]
    for kern in KERNELS:
        kern.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with CaptureLogits() as cap, WindowPeak() as win:
        t = run_module("lp_gnn_tpu_torch.pred_basis",
                       [*p["serve"], "--log_prefix",
                        osp.join(p["dir"], f"serve{rank}")])
    report["serve"] = {"launches": launch_counts(), "wall_s": t,
                       "max_memory_allocated_bytes":
                           torch.cuda.max_memory_allocated(),
                       "window_bytes": win.peak}
    if cap.logits:
        np.savez(osp.join(p["dir"], "rank_logits.npz"), **cap.logits)
    torch.cuda.empty_cache()

    os.environ["LP_GNN_DIST_COORD"] = p["coords"][2]
    allreduce_ms, wait_ms = [], []
    real_sum = edge_partition.sum_over_ranks

    def timed_sum(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.distributed.barrier()
        t1 = time.perf_counter()
        out = real_sum(*a, **kw)
        torch.cuda.synchronize()
        wait_ms.append((t1 - t0) * 1e3)
        allreduce_ms.append((time.perf_counter() - t1) * 1e3)
        return out

    for kern in KERNELS:
        kern.launches = 0
    torch.cuda.reset_peak_memory_stats()
    edge_partition.sum_over_ranks = timed_sum
    try:
        with StepTrace() as tr, WindowPeak() as win:
            t = run_module("lp_gnn_tpu_torch.train",
                           [*p["train"], "--log_prefix",
                            osp.join(p["dir"], f"train{rank}")])
    finally:
        edge_partition.sum_over_ranks = real_sum
    report["train"] = {"launches": launch_counts(), "steps": tr.steps,
                       "partition_s": tr.partition_s,
                       "dist_tensors_s": tr.dist_tensors_s,
                       "allreduce_ms": allreduce_ms,
                       "allreduce_wait_ms": wait_ms, "wall_s": t,
                       "max_memory_allocated_bytes":
                           torch.cuda.max_memory_allocated(),
                       "window_bytes": win.peak}
    report["wall_s"] = time.perf_counter() - t_all
    with open(osp.join(p["dir"], f"report{rank}.json"), "w") as f:
        json.dump(report, f)


def k1_rank_rows(per_rank: list[dict], k: int, bh: int,
                 launches: int) -> list[dict]:
    """The kernels line's rows of K1's rank form, one a width, under the
    name of the form the group took (``halo_all_to_all_ranks``, the flags
    form; ``halo_rank_signalled``): rank 0's times, each rank's beside
    them."""
    rows = []
    for i, r0 in enumerate(per_rank[0]["k1"]["rows"]):
        d = r0["D"]
        cases = [r["k1"]["rows"][i] for r in per_rank]
        bound_ms, bound_by = bound(r0["bytes"], 0.0)
        signalled = r0["form"] == halo_mod.SIGNALLED
        rows.append({
            "name": "halo_rank_signalled" if signalled
            else "halo_all_to_all_ranks", "route": "cuda",
            "source": "lp_gnn_tpu_torch/ops/csrc/halo_a2a.cu",
            "replaces": "lp_gnn_tpu/parallel/pallas_halo.py:39",
            "launches": launches, "max_abs_err": max(
                c["max_abs_err"] for c in cases),
            "ms": r0["ms"], "device_ms": r0["device_ms"],
            "plain_ms": r0["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": r0.get("library_ms"),
            "with_sync_ms": r0["with_sync_ms"],
            "by_rank": {key: [c.get(key) for c in cases] for key in (
                "ms", "device_ms", "device_ms_profiler", "with_sync_ms",
                "plain_ms", "library_ms", "exact", "exact_plain", "form",
                "flags_split", "signalled_span")},
            "case": f"rank form K={k} Bh={bh} D={d} bfloat16, one rank's "
                    + ("exchange: one signalled kernel (ms: back-to-back "
                       "exchanges, device_ms its launch by CUDA events)"
                       if signalled else
                       "exchange: the write and the copy-out"),
            "form": r0["form"], "nvlink_bytes": r0.get("nvlink_bytes"),
            "K": k, "Bh": bh, "D": d, "tol": "exact",
            "bytes": r0["bytes"], "bound_ms_all_ranks": k * bound_ms,
            "path": "edge_ranks", "on_path": "edge_ranks",
            "also_replaces": ["lp_gnn_tpu/parallel/pallas_halo.py:54",
                              "lp_gnn_tpu/parallel/pallas_halo.py:69"],
            "plain": "all_to_all_single over gloo on host copies (one call)",
            "library": "none: NCCL's all_to_all_single refuses ranks that "
                       "share one card",
            "note": f"{k} ranks time-share one card: no figure here stands "
                    f"for {k} cards"})
    return rows


@contextlib.contextmanager
def edge_layout(per_device: bool):
    """The layout that ``--mesh_shape edge=K`` takes in one process without
    dp, whatever the cards visible: one shard a device (the K shards'
    streams sharing a card where there are fewer cards) or every shard on
    the run's card. The entry points take JAX's rule
    (``parallel/mesh.py one_shard_a_device``: one a device with K cards
    visible); the phases name their layout, so that a machine with K_EDGE
    cards runs them as one with a card. The same rule lays ``dp=D[,edge=E]``
    of one process over its devices (``parallel/mesh.py DeviceGrid``):
    ``per_device`` names that layout too (``grid_devices``), and without
    it dp falls back as with one card."""
    real = mesh_mod.one_shard_a_device
    mesh_mod.one_shard_a_device = lambda device, n: per_device
    try:
        yield
    finally:
        mesh_mod.one_shard_a_device = real


def serve_inputs(seed: int, root: str, graphs: list | None = None) -> None:
    """The serve's inputs in ``root``: N_RANK_LPS bench LPs (or ``graphs``)
    in ``serve_data`` and the seeded recipe checkpoint ``mdl.pth``."""
    write_dataset(osp.join(root, "serve_data", "smoke", "highs-inp_tgt"),
                  seed, N_RANK_LPS, graphs)
    save_seeded(ARCH, seed, osp.join(root, "mdl.pth"))


def mirp_serve_graphs(seed: int) -> list[BipartiteGraph]:
    """N_RANK_LPS LPs of the pipeline's structure (``mirp_bench_graph``)."""
    return [mirp_bench_graph(seed + 1200 + i) for i in range(N_RANK_LPS)]


def stacked_serve_reference(seed: int, root: str, graphs: list | None = None,
                            write: bool = True) -> dict:
    """The edge-partitioned serve that ``edge_ranks``, ``edge_devices`` and
    ``edge_hosts`` hold their own against, in ``root``: its inputs
    (``serve_inputs``: N_RANK_LPS bench LPs, or ``graphs``, and the seeded
    recipe checkpoint; written first unless ``write`` is False) and the
    stacked path's ``pred_basis`` of them (``stacked/smoke/pred-basis``,
    the logits in ``stacked_logits.npz``). Returns the serve's record."""
    if write:
        serve_inputs(seed, root, graphs)
    shapes = ((M, N),) if graphs is None else \
        tuple({(g.ncons, g.nvars) for g in graphs})
    with CaptureLogits() as cap, edge_layout(False):
        stacked = serve_and_check(osp.join(root, "serve_data"),
                                  osp.join(root, "stacked"),
                                  osp.join(root, "mdl.pth"), seed, N_RANK_LPS,
                                  "trainval", DIST_PER_FORWARD, DIST_ARGS,
                                  shapes=shapes)
    np.savez(osp.join(root, "stacked_logits.npz"), **cap.logits)
    return stacked


def edge_ranks(seed: int, keep: str | None = None) -> dict:
    """Edge shards on their own ranks: EDGE_RANKS processes of this script
    (``--edge_rank``) time-share the card under the LP_GNN_DIST_* contract,
    shard k on rank k. K1's rank form against its plain version, bit for
    bit, timed (``rank_k1_cases``); one fp32 step held to the one-process
    stacked dist step on the same partition, each tensor's update within
    the larger of UPDATE_RTOL and DIST_UPDATE_SPREAD times the single
    card's own fp32-vs-fp64 spread (``step_states``), and one GENDeeper
    step held to the stacked dist GEN step (UPDATE_RTOL); ``pred_basis
    --mesh_shape edge=4`` on N_RANK_LPS bench LPs with a seeded recipe
    checkpoint, each .bas valid and equal to the stacked path's on the same
    data and checkpoint, rank 0's logits within RANK_LOGIT_TOL of the
    stacked path's; the recipe through ``train`` (bf16, 2 train LPs and 1
    val, DIST_TRAIN_EPOCHS epochs), finite losses equal on every rank,
    rank 0 alone writing. Each rank's launches exact: RANK_CONV a conv, no
    stacked K1. With ``keep`` (a directory) the phase works there and
    leaves the served LPs (``serve_data``), the checkpoint (``mdl.pth``),
    the stacked path's bases (``stacked/smoke/pred-basis``) and logits
    (``stacked_logits.npz``) for ``edge_devices``."""
    from lp_gnn_tpu_torch.utils.misc import split_idxs_train_val
    k = EDGE_RANKS
    script = osp.abspath(__file__)
    n_train, n_val = map(len, split_idxs_train_val(N_DIST_TRAIN_LPS))
    bh = edge_partition.compute_halo_width(bench_graph(seed), k)
    with (contextlib.nullcontext(keep) if keep else
          tempfile.TemporaryDirectory(prefix="lp_gnn_smoke_ranks_")) as tmp:
        # the served LPs, the checkpoint and the stacked path's serve of
        # them in this process, then the ranks on the same data
        stacked = stacked_serve_reference(seed, tmp)
        torch.cuda.empty_cache()
        serve_data, ckpt = osp.join(tmp, "serve_data"), osp.join(tmp, "mdl.pth")
        with np.load(osp.join(tmp, "stacked_logits.npz")) as z:
            st_logits = {n: z[n] for n in z.files}
        train_data = osp.join(tmp, "train_data")
        write_dataset(osp.join(train_data, "smoke", "highs-inp_tgt"),
                      seed + 1000, N_DIST_TRAIN_LPS)
        serve_argv = ["--dataset", "smoke", "--data_prefix", serve_data,
                      "--exp_nm", "smoke", "--arch", ARCH, "--fp16", "1",
                      "--load_from", ckpt, "--split", "trainval",
                      "--warm_gate", "off", "--seed", str(seed), *RANK_ARGS]
        payload = {"dir": tmp, "seed": seed, "bh": bh,
                   "coords": [f"localhost:{free_port()}" for _ in range(3)],
                   "serve": serve_argv,
                   "train": ["--dataset", "smoke", "--data_prefix",
                             train_data, "--exp_nm", "recipe", "--arch", ARCH,
                             "--fp16", "1", "--loss", "balanced", "--epochs",
                             str(DIST_TRAIN_EPOCHS), "--eval_every",
                             str(DIST_TRAIN_EPOCHS), "--seed", str(seed),
                             *RANK_ARGS]}
        payload_path = osp.join(tmp, "payload.json")
        with open(payload_path, "w") as f:
            json.dump(payload, f)
        _, t_ranks, groups = run_ranks("edge_ranks", lambda rank: [
            script, "--edge_rank", payload_path], ranks=k)
        per_rank = []
        for r in range(k):
            with open(osp.join(tmp, f"report{r}.json")) as f:
                per_rank.append(json.load(f))
        rank_state = torch.load(osp.join(tmp, "rank_step.pth"),
                                weights_only=True)
        rank_gen_state = torch.load(osp.join(tmp, "rank_gen_step.pth"),
                                    weights_only=True)
        others = [osp.exists(osp.join(tmp, f"{w}{r}")) for r in range(1, k)
                  for w in ("serve", "train")]
        recipe_mdl = osp.exists(osp.join(tmp, "train0", "recipe", "mdl.pth"))
        rank_dir = osp.join(tmp, "serve0", "smoke")
        n_bas = check_bases(osp.join(rank_dir, "pred-basis"), N_RANK_LPS)
        inf = json_load(osp.join(rank_dir, "inf_time.json"))
        with np.load(osp.join(tmp, "rank_logits.npz")) as z:
            rank_logits = {n: z[n] for n in z.files}
        st_dir = osp.join(tmp, "stacked", "smoke", "pred-basis")
        bas = sorted(f for f in os.listdir(st_dir) if f.endswith(".bas"))
        same_bas = {f: filecmp.cmp(osp.join(st_dir, f),
                                   osp.join(rank_dir, "pred-basis", f),
                                   shallow=False) for f in bas}
        same_sort = {f: filecmp.cmp(osp.join(st_dir, f + ".sort"),
                                    osp.join(rank_dir, "pred-basis",
                                             f + ".sort"), shallow=False)
                     for f in bas}
    # three groups a rank: K1 and the step's, pred_basis', train's
    groups_ok = len(groups) == 3 * k and all("gloo" in gr for gr in groups)
    if not groups_ok or any(others) or not recipe_mdl:
        raise SmokeFailure(f"edge_ranks: groups {groups}, files of ranks "
                           f"1-{k - 1} {others}, rank 0's mdl.pth "
                           f"{recipe_mdl}")
    for r, rep in enumerate(per_rank):
        for c in rep["k1"]["rows"]:
            if not (c["exact"] and c["exact_plain"]):
                raise SmokeFailure(f"edge_ranks rank {r}: K1's rank form at "
                                   f"D={c['D']} differs from the plain "
                                   f"version (max |err| {c['max_abs_err']}, "
                                   f"plain exact {c['exact_plain']})")
        st, ab = rep["k1"]["stress"], rep["k1"]["abort"]
        if not st["exact"] or st["launches"] != 2 * RANK_STRESS:
            raise SmokeFailure(f"edge_ranks rank {r}: K1's stress run: "
                               f"exchanges {st['differ']} differ from the "
                               f"plain version, {st['launches']} launches "
                               f"(expected {2 * RANK_STRESS})")
        named = f"rank {k - 1}'s launch failed: CUDA error 1"
        if ab["error"] is None or named not in ab["error"] or \
                ab["raise_s"] >= ab["deadline_s"] or not ab["exact_after"]:
            raise SmokeFailure(f"edge_ranks rank {r}: K1's abort check: "
                               f"raised {ab['error']!r} (must name "
                               f"{named!r}) in {ab['raise_s']} s, exact "
                               f"after the windows' renewal "
                               f"{ab['exact_after']}")
    # launches, a rank
    serve_want = add_launches(scaled(RANK_CONV, 2 * FORWARDS_PER_LP
                                     * N_RANK_LPS))
    per_step = add_launches(scaled(RANK_CONV, 2))
    train_want = add_launches(scaled(RANK_CONV, n_train),
                              scaled(per_step, n_train * DIST_TRAIN_EPOCHS),
                              scaled(RANK_CONV, 2 * n_val))
    step_want = {"cache_launches": add_launches(RANK_CONV),
                 "launches": per_step}
    gen_want = {"cache_launches": no_launches(), "launches": add_launches(
        *[RANK_GEN_CONV, RANK_GEN_CONV_BWD] * DIST_ZOO[DIST_GEN_ARCH])}
    for r, rep in enumerate(per_rank):
        steps = rep["train"]["steps"]
        bad = [rep["serve"]["launches"] != serve_want,
               rep["train"]["launches"] != train_want,
               {st["kind"] for st in steps} != {"dist_train_step"},
               len(steps) != n_train * DIST_TRAIN_EPOCHS,
               any(st["launches"] != per_step for st in steps),
               any(rep["step"][key] != v for key, v in step_want.items()),
               any(rep["gen_step"][key] != v for key, v in gen_want.items())]
        if any(bad):
            raise SmokeFailure(
                f"edge_ranks rank {r} launches: serve "
                f"{rep['serve']['launches']} (expected {serve_want}), train "
                f"{rep['train']['launches']} (expected {train_want}), steps "
                f"{[st['launches'] for st in steps]} (a step {per_step}), "
                f"the fp32 step {rep['step']['cache_launches']} + "
                f"{rep['step']['launches']}, the GEN step "
                f"{rep['gen_step']['launches']} (expected {gen_want})")
    losses = [[st["loss"] for st in rep["train"]["steps"]]
              for rep in per_rank]
    if any(ls != losses[0] for ls in losses) or \
            not np.isfinite(losses[0]).all():
        raise SmokeFailure(f"edge_ranks recipe losses by rank {losses}")
    # the bases and logits against the stacked path's
    worst = {}
    for fn, got in rank_logits.items():
        want = st_logits[fn]
        err, ok = within(torch.from_numpy(got), torch.from_numpy(want),
                         *RANK_LOGIT_TOL)
        worst[fn] = err
        if not ok:
            raise SmokeFailure(f"edge_ranks {fn}: rank logits max |err| "
                               f"{err} vs the stacked path's, beyond rtol, "
                               f"atol {RANK_LOGIT_TOL}")
    if len(rank_logits) != N_RANK_LPS or n_bas != N_RANK_LPS or \
            not all(same_bas.values()):
        raise SmokeFailure(f"edge_ranks: {n_bas} valid bases, logits of "
                           f"{sorted(rank_logits)}, .bas equal to the "
                           f"stacked path's {same_bas}")
    # the fp32 step against the stacked dist step
    lr = UPDATE_LR
    w0 = seeded_state(ARCH_NO_DROPOUT, seed)
    ref = step_states(ARCH_NO_DROPOUT, w0, bench_graph(seed + 1100),
                      ("single", "dist", "fp64"))
    rels = update_rels(w0, rank_state, ref["dist"]["state"], lr)
    spread = update_rels(w0, ref["single"]["state"], ref["fp64"]["state"],
                         lr)
    limits = {n: max(UPDATE_RTOL, DIST_UPDATE_SPREAD * spread[n])
              for n in rels}
    near = max(rels, key=lambda n: rels[n] / limits[n])
    loss_r, loss_s = per_rank[0]["step"]["loss"], ref["dist"]["loss"]
    if rels[near] > limits[near] or abs(loss_r - loss_s) > 1e-5 * abs(loss_s):
        raise SmokeFailure(f"edge_ranks fp32 step vs the stacked dist step: "
                           f"loss {loss_r} vs {loss_s}, update rel diff "
                           f"{rels[near]} in {near} > {limits[near]}")
    # GENDeeper's step over ranks against the stacked dist GEN step
    w0g = seeded_state(DIST_GEN_ARCH, seed)
    ref_g = step_states(DIST_GEN_ARCH, w0g, bench_graph(seed + 1400),
                        ("dist",))["dist"]
    rels_g = update_rels(w0g, rank_gen_state, ref_g["state"], lr)
    near_g = max(rels_g, key=rels_g.get)
    loss_gr = per_rank[0]["gen_step"]["loss"]
    if rels_g[near_g] > UPDATE_RTOL or \
            abs(loss_gr - ref_g["loss"]) > 1e-5 * abs(ref_g["loss"]):
        raise SmokeFailure(f"edge_ranks GEN step vs the stacked dist step: "
                           f"loss {loss_gr} vs {ref_g['loss']}, update rel "
                           f"diff {rels_g[near_g]} in {near_g} > "
                           f"{UPDATE_RTOL}")
    total = add_launches(*(rep["serve"]["launches"] for rep in per_rank),
                         *(rep["train"]["launches"] for rep in per_rank))
    return {
        "ranks": k, "groups": groups, "Bh": bh, "ranks_s": t_ranks,
        "note": f"{k} ranks time-share one card: its spans are not a "
                f"{k}-card figure",
        "launches": total,
        "launches_per_rank": {"serve": serve_want, "train": train_want,
                              "step": per_step,
                              "fp32_step": step_want,
                              "gen_step": gen_want["launches"]},
        "launch_formula": f"RANK_CONV {RANK_CONV} a conv: serve 2 convs x "
                          f"{FORWARDS_PER_LP * N_RANK_LPS} forwards; train "
                          f"{n_train} input caches + 2 a step x "
                          f"{n_train * DIST_TRAIN_EPOCHS} + 2 x {n_val} val",
        "k1": [{key: c[key] for key in ("D", "ms", "device_ms",
                                        "with_sync_ms", "plain_ms",
                                        "window_bytes")}
               | {"rank": r} for r, rep in enumerate(per_rank)
               for c in rep["k1"]["rows"]],
        "k1_stress": [{key: rep["k1"]["stress"][key] for key in (
            "exchanges", "exact", "launches", "enqueue_ms", "wall_ms",
            "ms_per_exchange")} for rep in per_rank],
        "k1_abort": [rep["k1"]["abort"] for rep in per_rank],
        "serve": {"bas_valid": n_bas, "bas_equal_stacked": same_bas,
                  "sort_equal_stacked": same_sort,
                  "logits_max_abs_err_vs_stacked": worst,
                  "logit_tol": {"rtol": RANK_LOGIT_TOL[0],
                                "atol": RANK_LOGIT_TOL[1]},
                  "inf_time_s": inf["inf_time"],
                  "part_time_s": inf.get("part_time", {}),
                  "stacked_inf_time_s": stacked["inf_time_s"],
                  "rank_wall_s": [rep["serve"]["wall_s"] for rep in per_rank],
                  "max_memory_allocated_bytes": [
                      rep["serve"]["max_memory_allocated_bytes"]
                      for rep in per_rank],
                  "window_bytes": [rep["serve"]["window_bytes"]
                                   for rep in per_rank]},
        "step": {"arch": ARCH_NO_DROPOUT, "dtype": "float32", "lr": lr,
                 "loss_ranks": loss_r, "loss_stacked": loss_s,
                 "update_rels_vs_stacked": rels,
                 "stacked_single_vs_fp64_update_rels": spread,
                 "ranks_vs_fp64_update_rels": update_rels(
                     w0, rank_state, ref["fp64"]["state"], lr),
                 "spread_factor": DIST_UPDATE_SPREAD,
                 "nearest_limit": {"tensor": near, "update_diff": rels[near],
                                   "limit": limits[near]},
                 "rank_step_device_ms": [rep["step"]["step_device_ms"]
                                         for rep in per_rank],
                 "rank_max_memory_allocated_bytes": [
                     rep["step"]["max_memory_allocated_bytes"]
                     for rep in per_rank],
                 "rank_window_bytes": [rep["step"]["window_bytes"]
                                       for rep in per_rank],
                 "stacked_step_device_ms": ref["dist"]["step_device_ms"]},
        "gen_step": {"arch": DIST_GEN_ARCH, "dtype": "float32", "lr": lr,
                     "loss_ranks": loss_gr, "loss_stacked": ref_g["loss"],
                     "update_rel_max_vs_stacked": rels_g[near_g],
                     "tensor": near_g, "update_rtol": UPDATE_RTOL,
                     "launches_per_rank": gen_want["launches"],
                     "rank_step_device_ms": [rep["gen_step"]["step_device_ms"]
                                             for rep in per_rank],
                     "rank_max_memory_allocated_bytes": [
                         rep["gen_step"]["max_memory_allocated_bytes"]
                         for rep in per_rank],
                     "rank_window_bytes": [rep["gen_step"]["window_bytes"]
                                           for rep in per_rank],
                     "stacked_step_device_ms": ref_g["step_device_ms"],
                     "stacked_max_memory_allocated_bytes":
                         ref_g["max_memory_allocated_bytes"]},
        "recipe": {"arch": bf16_arch(ARCH), "epochs": DIST_TRAIN_EPOCHS,
                   "train_lps": n_train, "val_lps": n_val,
                   "step_losses": losses[0],
                   "step_device_ms": [[st["device_ms"] for st in
                                       rep["train"]["steps"]]
                                      for rep in per_rank],
                   "allreduce_ms": [rep["train"]["allreduce_ms"]
                                    for rep in per_rank],
                   "allreduce_wait_ms": [rep["train"]["allreduce_wait_ms"]
                                         for rep in per_rank],
                   "partition_s": [rep["train"]["partition_s"]
                                   for rep in per_rank],
                   "dist_tensors_s": [rep["train"]["dist_tensors_s"]
                                      for rep in per_rank],
                   "rank_wall_s": [rep["train"]["wall_s"] for rep in per_rank],
                   "max_memory_allocated_bytes": [
                       rep["train"]["max_memory_allocated_bytes"]
                       for rep in per_rank],
                   "window_bytes": [rep["train"]["window_bytes"]
                                    for rep in per_rank]},
        "rank_wall_s": [rep["wall_s"] for rep in per_rank],
        "kernels": k1_rank_rows(per_rank, k, bh, total[
            "halo_all_to_all_ranks"]),
    }


# ------------------------------------------------- one edge shard a device


def on_devices(rank: dict, k: int = K_EDGE) -> dict:
    """One rank's launches (its one shard) as all k shards' with one shard
    a device: every count k times, and the rank form's two launches an
    exchange (the write and the copy-out) as the device form's k (one a
    source)."""
    out = {n: v * k for n, v in rank.items()
           if n != "halo_all_to_all_ranks"}
    out["halo_all_to_all_devices"] = \
        rank.get("halo_all_to_all_ranks", 0) // 2 * k
    return add_launches(out)


# a conv over all K shards, one a device: a send-row gather a shard, two
# exchanges of K1's device form (the gather and the reduce direction), 5
# SpMMs a shard
DEV_CONV = on_devices(RANK_CONV)
DEV_LOGIT_TOL = (2 ** -6, 2 ** -6)   # rtol, atol against the stacked path
DEV_UPDATE_RTOL = 1e-5      # an fp32 step's update against the stacked one
NVLINK_BYTES_S = 450e9      # H100 NVLink, one direction a card


K1_TIMED = 10    # timed exchanges of the device form (CUDA events a launch)


def k1_launch_times(exchange, bufs, streams) -> dict:
    """Each source's launch of K1's device form timed by CUDA events on its
    own stream (``parallel/halo.py DEVICE_TIMING``) over K1_TIMED exchanges,
    one at a time: per exchange the launches' sum and the span from the
    first start to the last end (one card only: events of distinct cards
    share no clock), their means, and each source's mean."""
    sums, spans, per = [], [], []
    halo_mod.DEVICE_TIMING = True
    try:
        exchange()
        for _ in range(K1_TIMED):
            exchange()
            t = halo_mod.device_form_times(bufs, streams)
            sums.append(t["sum_ms"])
            spans.append(t["span_ms"])
            per.append(t["per_source_ms"])
    finally:
        halo_mod.DEVICE_TIMING = False
    torch.cuda.synchronize()
    return {"sum_ms": float(np.mean(sums)),
            "span_ms": None if None in spans else float(np.mean(spans)),
            "per_source_ms": [float(v) for v in np.mean(per, axis=0)],
            "sum_ms_range": [float(min(sums)), float(max(sums))],
            "exchanges": K1_TIMED}


def k1_device_ms(exchange, k: int, tries: int = 5) -> tuple:
    """(device ms, launches seen): the device time of the K kernels of one
    exchange of K1's device form, summed, from ``torch.profiler`` over 5
    calls of ``exchange`` (the mean an exchange), or None where the profiler
    did not see all 5*K launches in any of ``tries`` runs; and how many
    launches its last run saw."""
    exchange()
    torch.cuda.synchronize()
    seen, complete = profile_kernels(exchange, 5,
                                     {"halo_pairs_kernel": 5 * k},
                                     tries=tries)
    hits = [tn for name, tn in seen.items() if "halo_pairs_kernel" in name]
    n_seen = sum(n for _, n in hits)
    return (sum(t for t, _ in hits) / 5 if complete else None), n_seen


def device_k1_case(devs: list, streams: list, bh: int, d: int, gen) -> dict:
    """K1's device form at (K, Bh, D) bf16 over ``devs`` with a stream a
    shard, bit for bit against the stacked form on the same blocks; timed
    (CUDA events around back-to-back exchanges, each shard stream first
    waiting for the timing stream and the timing stream for every shard
    stream after), its kernels' device time from the profiler (K launches
    an exchange, summed; None where it missed one, ``k1_device_ms``) on the
    shard streams and, where the devices are one card, on one stream, its
    plain version, and as the library yardstick
    the same exchange as K*K ``Tensor.copy_`` of the blocks, each on its
    destination's stream, into buffers made once."""
    k = len(devs)
    stacked_in = torch.randn(k, k * bh, d, generator=gen,
                             device="cuda").to(torch.bfloat16)
    bufs = []
    for dv, s in zip(devs, streams):
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.device(dv), torch.cuda.stream(s):
            bufs.append(stacked_in[len(bufs)].to(dv, copy=True))
    want = halo_all_to_all(stacked_in)
    cur = torch.cuda.current_stream()

    def exchange():
        for s in streams:
            s.wait_stream(cur)
        out = halo_all_to_all_devices(bufs, streams)
        for s in streams:
            cur.wait_stream(s)
        return out

    before = halo_all_to_all_devices.launches
    out = exchange()
    torch.cuda.synchronize()
    launches = halo_all_to_all_devices.launches - before
    exact = all(torch.equal(o.to("cuda"), want[q]) for q, o in enumerate(out))
    plain = halo_all_to_all_plain(bufs)
    exact_plain = all(torch.equal(a, b) for a, b in zip(out, plain))
    if not (exact and exact_plain) or launches != k:
        raise SmokeFailure(f"edge_devices K1 device form D={d}: exact vs the "
                           f"stacked form {exact}, vs the plain version "
                           f"{exact_plain}, {launches} launches (expected "
                           f"{k})")
    del out, plain
    outs = [torch.empty_like(b) for b in bufs]

    def library():
        for q, (o, s) in enumerate(zip(outs, streams)):
            s.wait_stream(cur)
            with torch.cuda.device(o.device), torch.cuda.stream(s):
                for p, b in enumerate(bufs):
                    o[p * bh:(p + 1) * bh].copy_(b[q * bh:(q + 1) * bh],
                                                 non_blocking=True)
            cur.wait_stream(s)

    def plain():
        out = halo_all_to_all_plain(bufs)   # on each device's current stream
        for dv in set(devs):
            cur.wait_stream(torch.cuda.current_stream(dv))
        return out

    iters = kernel_iters(d)
    ms = time_ms(exchange, iters)
    # the K kernels' device time an exchange: CUDA events around each
    # source's launch on its own stream, summed and as a span; the
    # profiler's sum beside it as a cross-check, only where it saw every
    # one of the 5*K launches (None else, beside the count it saw); on
    # one card also with the K launches one after another on one stream
    # (no overlap between the sources)
    events = k1_launch_times(exchange, bufs, streams)
    prof_ms, n_dev = k1_device_ms(exchange, k)
    one = one_events = None
    if len(set(devs)) == 1:
        with torch.cuda.device(devs[0]):
            def one_stream():
                return halo_all_to_all_devices(bufs, [cur] * k)
            one = k1_device_ms(one_stream, k)
            one_events = k1_launch_times(one_stream, bufs, [cur] * k)
    n_bytes = 2.0 * k * k * bh * d * 2
    bound_ms, bound_by = bound(n_bytes, 0.0)
    nvlink_bytes = (k - 1) * bh * d * 2.0
    row = {
        "name": "halo_all_to_all_devices", "route": "cuda",
        "source": "lp_gnn_tpu_torch/ops/csrc/halo_a2a.cu",
        "replaces": "lp_gnn_tpu/parallel/pallas_halo.py:39",
        "launches": None, "max_abs_err": 0.0, "ms": ms,
        "device_ms": events["sum_ms"], "device_span_ms": events["span_ms"],
        "device_events": events, "device_ms_profiler": prof_ms,
        "device_ms_one_stream": one_events["sum_ms"] if one else None,
        "device_ms_one_stream_profiler": one[0] if one else None,
        "device_launches_seen_one_stream": one[1] if one else None,
        "plain_ms": time_ms(plain, 10),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": time_ms(library, iters),
        "case": f"device form K={k} Bh={bh} D={d} bfloat16 over "
                f"{[str(x) for x in devs]}, a stream a shard: K launches "
                "an exchange (device_ms: the K launches' CUDA-event times "
                "summed, device_span_ms first start to last end)",
        "K": k, "Bh": bh, "D": d, "tol": "exact", "bytes": n_bytes,
        "launches_per_exchange": launches, "device_launches_seen": n_dev,
        "device_launches_profiled": 5 * k,
        "nvlink_bytes_per_card": nvlink_bytes,
        "bound_nvlink_ms": nvlink_bytes / NVLINK_BYTES_S * 1e3,
        "distinct_devices": len(set(devs)),
        "path": "edge_devices", "on_path": "edge_devices",
        "also_replaces": ["lp_gnn_tpu/parallel/pallas_halo.py:54",
                          "lp_gnn_tpu/parallel/pallas_halo.py:69"],
        "library": "K*K Tensor.copy_ of the blocks on the destinations' "
                   "streams into buffers made once",
        "note": "bound_ms: the stacked form's bytes over the card's memory "
                "rate (one card); across cards the NVLink bytes a card "
                "(bound_nvlink_ms), not measured on one card"}
    del bufs, outs, want, stacked_in
    torch.cuda.empty_cache()
    return row


# exchanges of the one-card check of the signalled form: each width's
# exact ones (both windows, then the first again), and the stress's
SIGNALLED_EXACT = 3
SIGNALLED_STRESS = 16


def signalled_launch_times(ranks, bufs, streams, n: int = K1_TIMED) -> dict:
    """Each rank's launch of the signalled form timed by CUDA events on its
    own stream around it, over ``n`` exchanges one at a time (``ranks`` a
    ``halo.StreamRanks``: the K ranks' streams on one card, one clock):
    each launch's mean, their mean, and the span from the first start to
    the last end."""
    cur = torch.cuda.current_stream()
    per, spans = [], []
    for _ in range(n):
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in streams]
        for (a, _), s in zip(ev, streams):
            s.wait_stream(cur)
            a.record(s)
        ranks.exchange(bufs)
        for (_, b), s in zip(ev, streams):
            b.record(s)
            cur.wait_stream(s)
        torch.cuda.synchronize()
        per.append([a.elapsed_time(b) for a, b in ev])
        t0 = ev[0][0]
        spans.append(max(t0.elapsed_time(b) for _, b in ev)
                     - min(t0.elapsed_time(a) for a, _ in ev))
    means = [float(v) for v in np.mean(per, axis=0)]
    return {"per_rank_ms": means, "launch_ms": float(np.mean(means)),
            "span_ms": float(np.mean(spans)),
            "launch_ms_range": [float(np.min(per)), float(np.max(per))],
            "exchanges": n}


def check_signalled_streams(g: BipartiteGraph, gen: torch.Generator
                            ) -> tuple[list[dict], dict]:
    """K1's signalled rank form on one card: the K_EDGE ranks' kernels as
    K_EDGE streams of this process on cuda:0 (``halo.StreamRanks``, a
    quarter wave a launch), at the bench graph's Bh, D=1024 and D=8 bf16.
    The path (launches counted from 0 just before it, read just after):
    SIGNALLED_EXACT exchanges a width, each bit for bit the plain version
    on the same blocks, then SIGNALLED_STRESS exchanges of two shapes in
    turn with one stream held back before every other, each exact too, and
    no abort recorded. Then each width timed: back-to-back exchanges
    (``ms``), each launch by CUDA events on its stream (``device_ms``, and
    the span of the K), the profiler's device time a launch, the plain
    version and, as the library yardstick, the stacked transpose of the
    same blocks. Returns the kernels line's rows and the path's record."""
    k = K_EDGE
    bh = edge_partition.compute_halo_width(g, k)
    streams = [torch.cuda.Stream() for _ in range(k)]
    cur = torch.cuda.current_stream()
    cases = {d: torch.randn(k, k * bh, d, generator=gen,
                            device="cuda").to(torch.bfloat16)
             for d in (1024, 8)}
    ranks = halo_mod.StreamRanks(cases[1024].device, k, cases[1024][0].nbytes,
                                 streams)

    def exchange(bufs, hold=None):
        for q, s in enumerate(streams):
            s.wait_stream(cur)
            if q == hold:
                with torch.cuda.stream(s):
                    torch.cuda._sleep(RANK_HOLD_CYCLES)
        out = ranks.exchange(bufs)
        for s in streams:
            cur.wait_stream(s)
        return out

    halo_rank_signalled.launches = 0
    bad = []
    for d, stacked in cases.items():
        want = halo_all_to_all_plain(stacked)
        for i in range(SIGNALLED_EXACT):
            out = exchange(list(stacked.unbind(0)))
            if not all(torch.equal(o, want[q]) for q, o in enumerate(out)):
                bad.append((d, i))
        del want, out
    shapes = [(bh, 8), (bh // 8, 64)]
    stress_in = [torch.randn(k, k * rows, d, generator=gen,
                             device="cuda").to(torch.bfloat16)
                 for rows, d in shapes]
    stress_want = [halo_all_to_all_plain(x) for x in stress_in]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stress_out = [exchange(list(stress_in[i % 2].unbind(0)),
                           hold=(i // 2) % k if i % 2 else None)
                  for i in range(SIGNALLED_STRESS)]
    torch.cuda.synchronize()
    stress_wall = time.perf_counter() - t0
    stress_bad = [i for i, out in enumerate(stress_out)
                  if not all(torch.equal(o, stress_want[i % 2][q])
                             for q, o in enumerate(out))]
    launches = {"halo_rank_signalled": halo_rank_signalled.launches}
    want_n = k * (len(cases) * SIGNALLED_EXACT + SIGNALLED_STRESS)
    if bad or stress_bad or ranks.status() or \
            launches["halo_rank_signalled"] != want_n:
        raise SmokeFailure(f"K1's signalled form on {k} streams: inexact "
                           f"(D, exchange) {bad}, stress {stress_bad}, "
                           f"status {ranks.status():#x}, launches "
                           f"{launches} (expected {want_n})")
    del stress_in, stress_want, stress_out
    rows = []
    for d, stacked in cases.items():
        bufs = list(stacked.unbind(0))
        iters = kernel_iters(d)
        events = signalled_launch_times(ranks, bufs, streams)
        seen, complete = profile_kernels(
            lambda: exchange(bufs), 5, {"halo_rank_signalled_kernel": 5 * k})
        prof = sum(t for name, (t, _) in seen.items()
                   if "halo_rank_signalled_kernel" in name)
        n_bytes = 2.0 * k * k * bh * d * stacked.element_size()
        bound_ms, bound_by = bound(n_bytes, 0.0)
        rows.append({
            "name": "halo_rank_signalled", "route": "cuda",
            "source": "lp_gnn_tpu_torch/ops/csrc/halo_a2a.cu",
            "replaces": "lp_gnn_tpu/parallel/pallas_halo.py:39",
            "launches": None, "max_abs_err": 0.0,
            "ms": time_ms(lambda: exchange(bufs), iters),
            "device_ms": events["launch_ms"],
            "device_span_ms": events["span_ms"], "device_events": events,
            "device_ms_profiler": prof / (5 * k) if complete else None,
            "plain_ms": time_ms(lambda: halo_all_to_all_plain(stacked), 10),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": time_ms(lambda: stacked.view(k, k, bh, d)
                                  .transpose(0, 1).contiguous(), iters),
            "case": f"signalled rank form K={k} Bh={bh} D={d} bfloat16, "
                    f"the {k} ranks' kernels on {k} streams of one process "
                    "on one card (a quarter wave each): ms an exchange, "
                    "device_ms a rank's launch (CUDA events on its stream)",
            "K": k, "Bh": bh, "D": d, "tol": "exact", "bytes": n_bytes,
            "path": "k1_streams", "on_path": "k1_streams",
            "stress": {"exchanges": SIGNALLED_STRESS, "exact": True,
                       "wall_ms": stress_wall * 1e3,
                       "shapes": [list(sh) for sh in shapes]},
            "also_replaces": ["lp_gnn_tpu/parallel/pallas_halo.py:54",
                              "lp_gnn_tpu/parallel/pallas_halo.py:69"],
            "library": "stacked.view(K,K,Bh,D).transpose(0,1).contiguous() "
                       "of the same blocks",
            "note": "one card: the ranks' route takes this kernel only with "
                    "a card a rank (chip_smoke.py --edge_devices on 4 "
                    "cards); bound_ms the stacked form's bytes over the "
                    "card's memory rate"})
    del ranks, cases
    torch.cuda.empty_cache()
    return rows, {"launches": launches, "Bh": bh, "streams": k}


LINK_REPS = 10     # back-to-back launches a set of the link probe


def k1_link_probe(devs: list, bh: int, d: int) -> dict:
    """The links under K1's device form, K distinct cards, blocks of Bh x D
    bf16 (the bench halo's, 61.5 MB at D=1024), through its kernel
    (``lp_halo_pairs``, a whole wave a launch): each (source, destination)
    pair alone, the K-1 remote pairs of one source in one launch, every
    source's remote pairs at once (all K(K-1) links), and each source's
    whole exchange launch at once (its own block too, as the exchange runs
    it). A single source's sets are timed by CUDA events on its stream over
    LINK_REPS back-to-back launches; the sets of every source at once by the
    host's clock from a synchronise of every card to the next, LINK_REPS
    launches a stream. Rates are the bytes a source sends over its links
    (its remote blocks) a second. The exchange's exactness is checked
    apart."""
    k = len(devs)
    block = bh * d * 2
    srcs = [torch.randn(k * bh, d, device=dv).to(torch.bfloat16)
            for dv in devs]
    dsts = [torch.zeros(k * bh, d, dtype=torch.bfloat16, device=dv)
            for dv in devs]
    streams = [torch.cuda.Stream(device=dv) for dv in devs]
    pairs_fn = halo_mod._rank_lib("lp_halo_pairs")
    vp = ctypes.c_void_p

    def launch(p: int, qs: list[int]):
        n = len(qs)
        src = (vp * n)(*(srcs[p].data_ptr() + q * block for q in qs))
        dst = (vp * n)(*(dsts[q].data_ptr() + p * block for q in qs))
        # the remote pairs round robin, a source's own block after them
        n_inter = sum(q != p for q in qs)
        with torch.cuda.device(devs[p]):
            rc = pairs_fn(src, dst, n_inter, n, block, 1,
                          streams[p].cuda_stream)
        if rc != 0:
            raise SmokeFailure(f"k1 link probe: CUDA error {rc}")

    def on_stream(p, qs) -> float:
        s = streams[p]
        for _ in range(2):
            launch(p, qs)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record(s)
        for _ in range(LINK_REPS):
            launch(p, qs)
        t1.record(s)
        t1.synchronize()
        return t0.elapsed_time(t1) / LINK_REPS

    def all_at_once(sets) -> float:
        for p, qs in sets:
            launch(p, qs)
        for dv in devs:
            torch.cuda.synchronize(dv)
        t0 = time.perf_counter()
        for _ in range(LINK_REPS):
            for p, qs in sets:
                launch(p, qs)
        for dv in devs:
            torch.cuda.synchronize(dv)
        return (time.perf_counter() - t0) * 1e3 / LINK_REPS

    def gbs(n_blocks, ms):
        return n_blocks * block / (ms * 1e-3) / 1e9

    orders = halo_mod.device_orders(k)
    pairs = {f"{p}->{q}": on_stream(p, [q])
             for p in range(k) for q in range(k) if q != p}
    sources = {str(p): on_stream(p, orders[p][:-1]) for p in range(k)}
    links = all_at_once([(p, orders[p][:-1]) for p in range(k)])
    whole = all_at_once([(p, orders[p]) for p in range(k)])
    del srcs, dsts
    torch.cuda.empty_cache()
    return {"block_bytes": block, "Bh": bh, "D": d, "reps": LINK_REPS,
            "pair_ms": pairs,
            "pair_gb_s": {n: gbs(1, t) for n, t in pairs.items()},
            "source_remote_ms": sources,
            "source_remote_gb_s": {n: gbs(k - 1, t)
                                   for n, t in sources.items()},
            "all_links_ms": links, "all_links_gb_s_a_card": gbs(k - 1, links),
            "exchange_launches_ms": whole,
            "exchange_launches_gb_s_a_card": gbs(k - 1, whole)}


# a recipe conv over the ranks' shards with a card each, per rank: the send
# rows' gather, two exchanges of the signalled form (one launch each), the
# SpMMs (RANK_CONV with K1 one launch an exchange)
SIGNALLED_CONV = {"gather_rows": 1, "halo_rank_signalled": 2, "spmm_csr": 5}
# a conv over the COLLECTIVE route of a group over several hosts, per rank:
# the send rows' gather and 5 SpMMs, its 2 exchanges the backend's
# all-to-all (no launch of K1)
HOST_CONV = {"gather_rows": 1, "spmm_csr": 5}
HOST_EXCHANGES_A_CONV = 2
ROUTE_CONV = {halo_mod.SIGNALLED: SIGNALLED_CONV, halo_mod.FLAGS: RANK_CONV,
              halo_mod.COLLECTIVE: HOST_CONV}
RECIPE_ARCH = bf16_arch(ARCH_NO_DROPOUT)


class K1Share:
    """CUDA events on the rank's stream around each call of K1's rank form
    on the edge-partitioned path (``edge_partition.halo_all_to_all_ranks``
    wrapped): the device ms of its exchanges, summed."""

    def __enter__(self):
        self.real, self.events = edge_partition.halo_all_to_all_ranks, []

        def timed(buf, group=None):
            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            pair[0].record()
            out = self.real(buf, group)
            pair[1].record()
            self.events.append(pair)
            return out
        edge_partition.halo_all_to_all_ranks = timed
        return self

    def __exit__(self, *exc):
        edge_partition.halo_all_to_all_ranks = self.real

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


def recipe_graph(seed: int, mirp: bool = False) -> BipartiteGraph:
    """The LP the ranks' recipe runs on: a bench LP, or with ``mirp`` one of
    the pipeline's structure (``mirp_bench_graph``)."""
    return mirp_bench_graph(seed + 1100) if mirp else bench_graph(seed + 1100)


def rank_recipe(seed: int, out_dir: str, mirp: bool = False) -> dict:
    """The recipe (RECIPE_ARCH, GCN_FC hids=1024 bf16, dropout 0, seeded
    weights) over this rank's shard of ``recipe_graph(seed, mirp)`` through
    the group's route
    (``out["form"]``; COLLECTIVE's exchanges counted beside the launches):
    one forward (eval, after an untimed one; the logits gathered to rank
    0) and one training step from the seeded weights (the input cache
    built first, SGD at UPDATE_LR, balanced CE), each with its launches
    counted from 0 just before it and read just after; the forward's span
    on the card (CUDA events) and K1's share of it (``K1Share``), and so a
    second step's (the first pays for its first-use set-up). Rank 0 writes
    the gathered logits and the first step's weights into ``out_dir``."""
    k, me = torch.distributed.get_world_size(), torch.distributed.get_rank()
    dg = edge_partition.partition_graph(recipe_graph(seed, mirp), k,
                                        halo=True)
    mesh = make_mesh(k, "cuda", torch.distributed.group.WORLD)
    model = build_model(RECIPE_ARCH)
    model.load_state_dict(seeded_state(RECIPE_ARCH, seed))
    model.dp = 0.0
    model = model.to("cuda").eval()
    out = {}
    with torch.no_grad():
        dgt = edge_partition.dist_tensors(model, dg, mesh)
        edge_partition.dist_forward(model, dgt)   # the windows, untimed
        torch.cuda.synchronize()
        torch.distributed.barrier()
        reset_launches()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with K1Share() as k1:
            ev[0].record()
            lc, lv = edge_partition.dist_forward(model, dgt)
            ev[1].record()
            k1_ms = k1.ms()
        out["form"] = mesh_mod.ROUTES[tuple(range(k))]
        out["forward"] = {"launches": launch_counts(),
                          "collective_exchanges":
                              halo_all_to_all_ranks.collective_exchanges,
                          "span_ms": ev[0].elapsed_time(ev[1]),
                          "k1_ms": k1_ms, "k1_exchanges": len(k1.events)}
        lc, lv = edge_partition.gather_logits(lc, lv, mesh)
    if me == 0:
        np.savez(osp.join(out_dir, "recipe_logits.npz"),
                 lc=lc.cpu().numpy(), lv=lv.cpu().numpy())
    del dgt
    model.train()
    opt = trainer.make_optimizer(model.parameters(), "sgd", UPDATE_LR)
    dgt = edge_partition.dist_tensors(model, dg, mesh, input_agg=True)
    torch.cuda.synchronize()
    torch.distributed.barrier()
    reset_launches()
    loss = edge_partition.dist_train_step(model, opt, dgt,
                                          LOSS_REGISTRY["balanced"])
    out["step"] = {"launches": launch_counts(), "loss": float(loss),
                   "collective_exchanges":
                       halo_all_to_all_ranks.collective_exchanges}
    if me == 0:
        torch.save({n: v.detach().cpu() for n, v in
                    model.state_dict().items()},
                   osp.join(out_dir, "recipe_step.pth"))
    torch.cuda.synchronize()
    torch.distributed.barrier()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with K1Share() as k1:
        ev[0].record()
        edge_partition.dist_train_step(model, opt, dgt,
                                       LOSS_REGISTRY["balanced"])
        ev[1].record()
        k1_ms = k1.ms()
    out["step"].update({"span_ms": ev[0].elapsed_time(ev[1]), "k1_ms": k1_ms,
                        "k1_exchanges": len(k1.events)})
    return out


def k1_card_rank(payload_path: str) -> None:
    """One rank of the card-ranks sub-phase of edge_devices, in this
    process (``--k1_rank``): with a card of its own (the LP_GNN_DIST_*
    contract over K ranks and K cards: NCCL, ``mesh.init_distributed``),
    K1's rank form as ``rank_k1_cases`` runs it (the signalled form the
    layout takes, bit for bit, timed, the flags form's parts, the stress
    and the abort), its plain version over a gloo group, and NCCL's
    ``all_to_all_single`` on the same blocks as the library yardstick; then
    the recipe's forward and step through the rank route
    (``rank_recipe``); writes its report into the payload's directory."""
    from lp_gnn_tpu_torch.parallel import mesh as mesh_mod
    with open(payload_path) as f:
        p = json.load(f)
    rank = int(os.environ["LP_GNN_DIST_PROC_ID"])
    device, created = mesh_mod.init_distributed(torch.device("cuda"))
    report = {"device": str(device),
              "backend": torch.distributed.get_backend()}
    try:
        gloo = torch.distributed.new_group(backend="gloo")
        report["k1"] = rank_k1_cases(p["seed"], p["bh"], plain_group=gloo,
                                     nccl=True)
        torch.cuda.empty_cache()
        report["recipe"] = rank_recipe(p["seed"], p["dir"])
    finally:
        mesh_mod.leave_distributed(created)
    with open(osp.join(p["dir"], f"report{rank}.json"), "w") as f:
        json.dump(report, f)


def recipe_vs_stacked(seed: int, tmp: str, per_rank: list[dict],
                      mirp: bool = False) -> dict:
    """The ranks' recipe forward and step (``rank_recipe`` on
    ``recipe_graph(seed, mirp)``) against the stacked path's on cuda:0
    (K_EDGE shards stacked, the same partition, weights and step): rank 0's logits within RANK_LOGIT_TOL of the stacked
    forward's; the step's loss within RANK_LOGIT_TOL and each tensor's
    update within RANK_LOGIT_TOL's rtol of its largest; each rank's
    launches those of its route a conv
    (ROUTE_CONV), 2 a forward and 2 a step, and the COLLECTIVE route's
    HOST_EXCHANGES_A_CONV exchanges a conv (none on the others)."""
    g = recipe_graph(seed, mirp)
    w0 = seeded_state(RECIPE_ARCH, seed)
    model = build_model(RECIPE_ARCH)
    model.load_state_dict(w0)
    model.dp = 0.0
    model = model.to("cuda").eval()
    dg = edge_partition.partition_graph(g, K_EDGE, halo=True)
    with torch.no_grad():
        st_lc, st_lv = edge_partition.dist_apply(model, dg,
                                                 make_mesh(K_EDGE, "cuda"))
    del model
    with np.load(osp.join(tmp, "recipe_logits.npz")) as z:
        got = np.concatenate([z["lc"], z["lv"]])
    ref = torch.cat([st_lc, st_lv]).float().cpu()
    err, ok = within(torch.from_numpy(got), ref, *RANK_LOGIT_TOL)
    step = step_states(RECIPE_ARCH, w0, g, ("dist",))["dist"]
    state = torch.load(osp.join(tmp, "recipe_step.pth"), weights_only=True)
    rels = update_rels(w0, state, step["state"], UPDATE_LR)
    near = max(rels, key=rels.get)
    loss = per_rank[0]["recipe"]["step"]["loss"]
    loss_ok = abs(loss - step["loss"]) <= RANK_LOGIT_TOL[1] + \
        RANK_LOGIT_TOL[0] * abs(step["loss"])
    form = per_rank[0]["recipe"]["form"]
    want = add_launches(scaled(ROUTE_CONV[form], 2))
    want_x = 2 * HOST_EXCHANGES_A_CONV if form == halo_mod.COLLECTIVE else 0
    launches = [[rep["recipe"][w]["launches"] for w in ("forward", "step")]
                for rep in per_rank]
    exchanges = [[rep["recipe"][w]["collective_exchanges"]
                  for w in ("forward", "step")] for rep in per_rank]
    if not ok or not loss_ok or rels[near] > RANK_LOGIT_TOL[0] or \
            any(n != want for pair in launches for n in pair) or \
            any(x != want_x for pair in exchanges for x in pair) or \
            any(rep["recipe"]["form"] != form for rep in per_rank):
        raise SmokeFailure(f"ranks' recipe vs the stacked path: logits "
                           f"max |err| {err} (tol {RANK_LOGIT_TOL}), loss "
                           f"{loss} vs {step['loss']}, update rel diff "
                           f"{rels[near]} in {near}, launches {launches} "
                           f"(each {want}), collective exchanges "
                           f"{exchanges} (each {want_x}), forms "
                           f"{[rep['recipe']['form'] for rep in per_rank]}")
    spans = {w: [rep["recipe"][w]["span_ms"] for rep in per_rank]
             for w in ("forward", "step")}
    k1 = {w: [rep["recipe"][w]["k1_ms"] for rep in per_rank]
          for w in ("forward", "step")}
    return {"arch": RECIPE_ARCH, "form": form,
            "lp": "mirp_bench" if mirp else "bench",
            "logits_max_abs_err_vs_stacked": err,
            "logit_tol": {"rtol": RANK_LOGIT_TOL[0],
                          "atol": RANK_LOGIT_TOL[1]},
            "loss": loss, "loss_stacked": step["loss"],
            "update_rel_max_vs_stacked": rels[near], "tensor": near,
            "launches_per_rank": want,
            "collective_exchanges_per_rank": want_x,
            "span_ms": spans, "k1_ms": k1,
            "k1_share": {w: [a / b for a, b in zip(k1[w], spans[w])]
                         for w in spans},
            "k1_exchanges": [rep["recipe"]["step"]["k1_exchanges"]
                             for rep in per_rank],
            "stacked_step_device_ms": step["step_device_ms"]}


def k1_card_ranks(seed: int, bh: int) -> dict:
    """K1's rank form with a card a rank: K_EDGE processes of this script
    (``--k1_rank``), rank k on cuda:k, over NCCL, where the group takes the
    signalled form; the rows of the kernels line as ``k1_rank_rows`` makes
    them, with NCCL's all_to_all_single as library_ms and the NVLink bytes
    a card as the bound, the flags form's parts beside them; the stress
    and abort checks; the recipe's forward and step against the stacked
    path (``recipe_vs_stacked``). Needs K_EDGE cards (skipped else, with
    the reason)."""
    if torch.cuda.device_count() < K_EDGE:
        return {"skipped": f"needs {K_EDGE} cards, "
                           f"{torch.cuda.device_count()} visible"}
    with tempfile.TemporaryDirectory(prefix="lp_gnn_smoke_k1ranks_") as tmp:
        path = osp.join(tmp, "payload.json")
        with open(path, "w") as f:
            json.dump({"dir": tmp, "seed": seed, "bh": bh}, f)
        _, wall, groups = run_ranks("k1_card_ranks", lambda rank: [
            osp.abspath(__file__), "--k1_rank", path], ranks=K_EDGE)
        per_rank = []
        for r in range(K_EDGE):
            with open(osp.join(tmp, f"report{r}.json")) as f:
                per_rank.append(json.load(f))
        recipe = recipe_vs_stacked(seed, tmp, per_rank)
    launches = sum(n for rep in per_rank for w in ("forward", "step")
                   for n in [rep["recipe"][w]["launches"][
                       "halo_rank_signalled"]])
    rows = k1_rank_rows(per_rank, K_EDGE, bh, launches)
    for row in rows:
        row["note"] = f"{K_EDGE} ranks, a card each (NCCL)"
        row["library"] = "NCCL all_to_all_single on the same blocks"
        row["path"] = row["on_path"] = "edge_devices"
        row["bound_ms"] = row["nvlink_bytes"] / NVLINK_BYTES_S * 1e3
        row["bound_by"] = "bytes"
        row["bound_note"] = ("the NVLink bytes a card sends, (K-1)*Bh*D*b, "
                             "at 450 GB/s one way")
    forms = {c["form"] for rep in per_rank for c in rep["k1"]["rows"]}
    bad = [(r["D"], key) for r in rows for key in ("exact", "exact_plain")
           if not all(r["by_rank"][key])]
    splits = [c["flags_split"] for rep in per_rank
              for c in rep["k1"]["rows"]]
    stress = [rep["k1"]["stress"] for rep in per_rank]
    named = f"rank {K_EDGE - 1}'s launch failed: CUDA error 1"
    aborts = [rep["k1"]["abort"] for rep in per_rank]
    if bad or forms != {halo_mod.SIGNALLED} or \
            not all(sp["form"] == halo_mod.FLAGS and sp["exact_repeat"]
                    for sp in splits) or \
            not all(st["exact"] and st["launches"] == RANK_STRESS
                    for st in stress) or \
            not all(ab["error"] and named in ab["error"] and
                    ab["exact_after"] for ab in aborts):
        raise SmokeFailure(f"k1 card ranks: inexact {bad}, forms {forms}, "
                           f"split forms {[sp['form'] for sp in splits]}, "
                           f"stress {[(st['exact'], st['launches']) for st in stress]}, "
                           f"aborts {aborts}")
    return {"ranks_s": wall, "groups": groups,
            "devices": [rep["device"] for rep in per_rank],
            "backends": [rep["backend"] for rep in per_rank],
            "abort": aborts, "stress": stress, "recipe": recipe,
            "launches": {"halo_rank_signalled": launches},
            "kernels": rows}


STEADY_REPS = 5    # timed steps and forwards of each layout, after one untimed


def busy_by_card(prof) -> dict:
    """Each card's busy ms in a profiled span: the union of the spans of
    the work the profiler saw on it (kernels, copies, sets)."""
    spans: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                not e.name.startswith("ProfilerStep"):
            spans.setdefault(e.device_index, []).append(
                (e.time_range.start, e.time_range.end))
    out = {}
    for dev, iv in spans.items():
        busy, end = 0.0, float("-inf")
        for a, b in sorted(iv):
            if b > end:
                busy += b - max(a, end)
                end = b
        out[f"cuda:{dev}"] = busy / 1e3
    return out


def steady_layout(seed: int, mesh) -> dict:
    """The recipe's model in a steady state on ``mesh``: GCN_FC hids=1024
    bf16 (dropout 0, Adam at the trainer's lr) on one bench graph with the
    trainer's tensors and input cache, one untimed dist step then
    STEADY_REPS, and one untimed dist forward under ``torch.no_grad`` then
    STEADY_REPS. Each call's ``wall_ms`` (host clock, to the synchronise
    of every card after it) and ``host_ms`` (until the call returned: the
    host queueing the work; with one shard a device, the K shards' threads
    taking turns at the GIL), their medians; then one more step under the
    profiler (``profiled_step``)."""
    model = build_model(bf16_arch(ARCH_NO_DROPOUT),
                        generator=torch.Generator().manual_seed(seed))
    model = model.to("cuda")
    opt = trainer.make_optimizer(model.parameters(), "adam", 1e-3)
    dg = edge_partition.partition_graph(bench_graph(seed + 1100), K_EDGE,
                                        halo=True)
    data = edge_partition.dist_tensors(model, dg, mesh, input_agg=True)
    loss_fn = LOSS_REGISTRY["balanced"]

    def step():
        edge_partition.dist_train_step(model, opt, data, loss_fn)

    def forward():
        with torch.no_grad():
            model.eval()
            edge_partition.dist_forward(model, data)

    out = {name: timed_reps(fn, STEADY_REPS)
           for name, fn in (("step", step), ("forward", forward))}
    out["profiled_step"] = profiled_step(step, mesh.per_device)
    del model, opt, data
    torch.cuda.empty_cache()
    return out


def sync_cards() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def timed_call(fn) -> tuple[float, float, object]:
    """(host ms until ``fn`` returned, wall ms to the synchronise of every
    card after it, its result)."""
    sync_cards()
    t0 = time.perf_counter()
    out = fn()
    t1 = time.perf_counter()
    sync_cards()
    return (t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3, out


def timed_reps(fn, reps: int) -> dict:
    """One untimed call of ``fn``, then ``reps`` timed: host and wall ms
    each and their medians."""
    fn()
    runs = [timed_call(fn)[:2] for _ in range(reps)]
    return {"host_ms": [h for h, _ in runs], "wall_ms": [w for _, w in runs],
            "host_ms_median": float(np.median([h for h, _ in runs])),
            "wall_ms_median": float(np.median([w for _, w in runs]))}


def profiled_step(step, per_device: bool) -> dict:
    """One ``step`` under the profiler: its wall ms, K1's launches in it
    (the device form's with one shard a device, else the stacked form's)
    and those the profiler saw, and, where it saw them all, each card's
    busy ms (the union of its work's spans) and idle share of the wall
    (else None, ``profile_complete``)."""
    k1 = halo_all_to_all_devices if per_device else halo_all_to_all
    k1_kernel = "halo_pairs_kernel" if per_device else "halo_a2a_kernel"
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    before = k1.launches
    with torch.profiler.profile(activities=acts) as prof:
        _, wall, _ = timed_call(step)
    launched = k1.launches - before
    seen = sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and k1_kernel in e.name)
    busy = busy_by_card(prof) if seen == launched else None
    return {"wall_ms": wall, "k1_launches": launched, "k1_seen": seen,
            "profile_complete": seen == launched, "busy_ms_by_card": busy,
            "idle_share_by_card": {c: 1 - b / wall for c, b in busy.items()}
            if busy else None}


def edge_devices(seed: int, ranks_dir: str, stacked_inf: dict | None = None
                 ) -> dict:
    """Edge shards on several devices of one process: K_EDGE shards, shard
    k on cuda:(k mod the cards), one thread and stream a shard (on one
    card its K streams share it; ``edge_layout(True)``). K1's device form at
    the bench graph's Bh, D=1024 and D=8 bf16, bit for bit against the
    stacked form (``device_k1_case``); ``pred_basis --mesh_shape edge=4`` on
    the N_RANK_LPS bench LPs and the seeded recipe checkpoint of
    ``stacked_serve_reference`` in ``ranks_dir`` (``edge_ranks``' where it
    ran there, else made here), its launches from 0 exact (DEV_CONV a conv,
    no stacked K1), every .bas valid and equal to the stacked path's there,
    the logits within DEV_LOGIT_TOL of the stacked path's, ``inf_time``
    beside the stacked path's (``stacked_inf``, that serve's); one fp32
    GCN_FC step against the stacked dist step (each tensor's update within
    DEV_UPDATE_RTOL of its largest), one fp32 GENDeeper step (UPDATE_RTOL)
    and GCNRand's forward over the all-gather partition (equal); the
    recipe's steady steps and forwards beside the stacked layout's on
    cuda:0 (``steady_layout``)."""
    k, n = K_EDGE, torch.cuda.device_count()
    devs = shard_devices(torch.device("cuda", 0), k)
    mesh = make_mesh(k, devs)
    t0 = time.perf_counter()
    peer_new = halo_mod.enable_peer_access(sorted({d.index for d in devs}))
    peer_s = time.perf_counter() - t0
    bh = edge_partition.compute_halo_width(bench_graph(seed), k)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = [device_k1_case(devs, mesh.threads.streams, bh, d, gen)
            for d in (1024, 8)]
    distinct = len(set(devs)) == k
    links = k1_link_probe(devs, bh, 1024) if distinct else {
        "skipped": f"needs {k} distinct cards"}
    card_ranks = k1_card_ranks(seed, bh)
    per_forward = add_launches(scaled(DEV_CONV, 2))
    if not osp.exists(osp.join(ranks_dir, "stacked_logits.npz")):
        stacked_inf = stacked_serve_reference(seed, ranks_dir)["inf_time_s"]
        torch.cuda.empty_cache()
    with np.load(osp.join(ranks_dir, "stacked_logits.npz")) as z:
        st_logits = {n: z[n] for n in z.files}
    with CaptureLogits() as cap_dev, edge_layout(True):
        served = serve_and_check(osp.join(ranks_dir, "serve_data"),
                                 osp.join(ranks_dir, "devices"),
                                 osp.join(ranks_dir, "mdl.pth"), seed,
                                 N_RANK_LPS, "trainval", per_forward,
                                 DIST_ARGS)
    dirs = [osp.join(ranks_dir, w, "smoke", "pred-basis")
            for w in ("stacked", "devices")]
    bas = sorted(os.listdir(dirs[0]))
    same_bas = {f: filecmp.cmp(osp.join(dirs[0], f), osp.join(dirs[1], f),
                               shallow=False) for f in bas}
    worst = {}
    for fn, got in cap_dev.logits.items():
        err, ok = within(torch.from_numpy(got),
                         torch.from_numpy(st_logits[fn]), *DEV_LOGIT_TOL)
        worst[fn] = err
        if not ok:
            raise SmokeFailure(f"edge_devices {fn}: logits max |err| {err} "
                               f"vs the stacked path's, beyond {DEV_LOGIT_TOL}")
    if len(worst) != N_RANK_LPS or not all(same_bas.values()):
        raise SmokeFailure(f"edge_devices: logits of {sorted(worst)}, files "
                           f"equal to the stacked path's {same_bas}")
    # an fp32 step of each kind against the stacked dist step
    steps = {}
    for arch, g_seed, rtol in ((ARCH_NO_DROPOUT, 1100, DEV_UPDATE_RTOL),
                               (DIST_GEN_ARCH, 1400, UPDATE_RTOL)):
        w0 = seeded_state(arch, seed)
        g = bench_graph(seed + g_seed)
        ref = step_states(arch, w0, g, ("dist",))["dist"]
        got = step_states(arch, w0, g, ("dist",), mesh=mesh)["dist"]
        rels = update_rels(w0, got["state"], ref["state"], UPDATE_LR)
        near = max(rels, key=rels.get)
        want_l = on_devices(add_launches(*[
            RANK_GEN_CONV, RANK_GEN_CONV_BWD] * DIST_ZOO[DIST_GEN_ARCH])) \
            if arch == DIST_GEN_ARCH else on_devices(add_launches(
                scaled(RANK_CONV, 2)))
        if rels[near] > rtol or got["launches"] != want_l or \
                abs(got["loss"] - ref["loss"]) > 1e-5 * abs(ref["loss"]):
            raise SmokeFailure(f"edge_devices {arch} step vs the stacked "
                               f"dist step: loss {got['loss']} vs "
                               f"{ref['loss']}, update rel diff {rels[near]} "
                               f"in {near} > {rtol}, launches "
                               f"{got['launches']} (expected {want_l})")
        steps[arch.split("(")[0]] = {
            "arch": arch, "dtype": "float32", "lr": UPDATE_LR,
            "loss": got["loss"], "loss_stacked": ref["loss"],
            "update_rel_max_vs_stacked": rels[near], "tensor": near,
            "update_rtol": rtol, "launches": got["launches"],
            "step_device_ms": got["step_device_ms"],
            "stacked_step_device_ms": ref["step_device_ms"],
            "max_memory_allocated_bytes": got["max_memory_allocated_bytes"],
            "stacked_max_memory_allocated_bytes":
                ref["max_memory_allocated_bytes"]}
    # GCNRand over the all-gather partition: the lead draws every row
    rand = build_model("GCNRand()").to("cuda").eval()
    dg_ag = edge_partition.partition_graph(bench_graph(seed), k, halo=False)
    with torch.no_grad():
        r_dev = edge_partition.dist_apply(rand, dg_ag, mesh)
        r_st = edge_partition.dist_apply(rand, dg_ag, make_mesh(k, "cuda"))
    if not all(torch.equal(a, b) for a, b in zip(r_dev, r_st)):
        raise SmokeFailure("edge_devices: GCNRand's logits differ from the "
                           "stacked path's")
    rand_rows = [int(r_dev[0].shape[0]), int(r_dev[1].shape[0])]
    del r_dev, r_st, dg_ag
    torch.cuda.empty_cache()
    steady = {"devices": steady_layout(seed, mesh),
              "stacked": steady_layout(seed, make_mesh(k, "cuda"))}
    return {
        "K": k, "devices": [str(d) for d in devs], "cards": n,
        "distinct_devices": len(set(devs)),
        "peer_access": [list(p) for p in peer_new] or "none",
        "peer_access_s": peer_s,
        "note": f"{k} shards, {len(set(devs))} distinct device(s): a stream "
                "a shard; with one card the shards' streams share it, and "
                "no figure here is a several-card figure",
        "Bh": bh, "launches": served["launches"],
        "launches_per_forward": per_forward,
        "serve": {"bas_valid": served["bas_valid"],
                  "bas_equal_stacked": same_bas,
                  "logits_max_abs_err_vs_stacked": worst,
                  "logit_tol": {"rtol": DEV_LOGIT_TOL[0],
                                "atol": DEV_LOGIT_TOL[1]},
                  "inf_time_s": served["inf_time_s"],
                  "stacked_inf_time_s": stacked_inf,
                  "part_time_s": served["part_time_s"],
                  "pred_basis_s": served["pred_basis_s"]},
        "steps": steps,
        "steady": {"arch": bf16_arch(ARCH_NO_DROPOUT), "reps": STEADY_REPS,
                   **steady},
        "gcn_rand_all_gather": {"equal_stacked": True,
                                "rows": rand_rows},
        "links": links, "card_ranks": card_ranks,
        "kernels": rows,
    }


# ------------------------------------ dp and the (dp, edge) grid of devices
# JAX's layout of --mesh_shape dp=D[,edge=E] in one process: cell (d, e) on
# cuda:(d*E + e) mod the cards, a thread and stream a cell (on one card
# every cell on cuda:0). A row's conv over its E shards, one a device:
# on_devices(RANK_CONV, E); a grid step a row's two convs (the hidden
# conv's forward and backward) on every row; the input cache one conv a
# graph
GRID_DEV = {"dp": 2, "edge": 2}
GRID_DEV_ARGS = ["--mesh_shape",
                 f"dp={GRID_DEV['dp']},edge={GRID_DEV['edge']}",
                 "--edge_num_thresh", "0"]
GRID_DEV_EPOCHS = 2
GRID_DEV_CONV = on_devices(RANK_CONV, GRID_DEV["edge"])
GRID_DEV_STEP = scaled(GRID_DEV_CONV, 2 * GRID_DEV["dp"])
# the stacked layout's conv at E shards (DIST_CONV at K = E)
GRID_STACKED_CONV = {"halo_all_to_all": 1, "gather_rows": 1,
                     "spmm_csr": 5 * GRID_DEV["edge"]}
# a dp step on devices against --graph_batch's union step on one card, an
# fp32 SGD step's update per tensor: the same sums, one graph a replica
DP_DEV_UPDATE_RTOL = 1e-5
GRID_DEV_REPS = 3           # timed steps of each way, after one untimed


def card_peaks(devs) -> dict:
    return {f"cuda:{i}": torch.cuda.max_memory_allocated(i)
            for i in sorted({d.index for d in devs})}


def reset_card_peaks(devs) -> None:
    for i in {d.index for d in devs}:
        torch.cuda.reset_peak_memory_stats(i)


def dp_devices_case(graphs: list, w0: dict, d: int) -> dict:
    """One fp32 SGD step (ARCH_NO_DROPOUT, UPDATE_LR) of dp=d on d devices
    (block c of ``graphs`` one union on cell c's device, its replica in a
    thread of its own) against ``--graph_batch len(graphs)``'s step on one
    card over the same stack: each tensor's update within
    DP_DEV_UPDATE_RTOL of its largest; the devices' step twice from w0,
    bit for bit; each way's launches and host and wall ms (GRID_DEV_REPS
    timed after one)."""
    from lp_gnn_tpu_torch.data.graph import union
    from lp_gnn_tpu_torch.parallel.dp import dp_train_step, rank_block
    grid = make_device_grid(d, 1, shard_devices(torch.device("cuda", 0), d))
    loss_fn = LOSS_REGISTRY["balanced"]
    out = {}
    for way in ("devices", "devices_again", "one_card"):
        model = build_model(ARCH_NO_DROPOUT)
        model.load_state_dict(w0)
        model = model.to("cuda").train()
        opt = trainer.make_optimizer(model.parameters(), "sgd", UPDATE_LR)
        if way == "one_card":
            g = union([trainer.train_graph(model, x, "cuda") for x in graphs])
            threads = None
        else:
            g = [union([trainer.train_graph(model, x, dev)
                        for x in rank_block(graphs, d, c)])
                 for c, dev in enumerate(grid.col.devices)]
            threads = grid.col
        before = launch_counts()
        host, wall, loss = timed_call(lambda: dp_train_step(
            model, opt, g, loss_fn, None, threads))
        out[way] = {"state": {k: v.detach().to("cpu", copy=True) for k, v in
                              model.state_dict().items()},
                    "loss": float(loss), "launches": launches_since(before),
                    "first_host_ms": host, "first_wall_ms": wall}
        if way != "devices_again":
            out[way]["timing"] = timed_reps(lambda: dp_train_step(
                model, opt, g, loss_fn, None, threads), GRID_DEV_REPS)
        del model, opt, g
        torch.cuda.empty_cache()
    dev, again, one = out["devices"], out["devices_again"], out["one_card"]
    rels = update_rels(w0, dev["state"], one["state"], UPDATE_LR)
    near = max(rels, key=rels.get)
    same = dev["loss"] == again["loss"] and all(
        torch.equal(v, again["state"][k]) for k, v in dev["state"].items())
    want = scaled({"spmm_csr": SPMM_PER_STEP}, d)
    if rels[near] > DP_DEV_UPDATE_RTOL or not same or \
            dev["launches"] != add_launches(want) or \
            abs(dev["loss"] - one["loss"]) > 1e-5 * abs(one["loss"]):
        raise SmokeFailure(
            f"grid_devices dp={d}: loss {dev['loss']} vs --graph_batch's "
            f"{one['loss']}, update rel diff {rels[near]} in {near} > "
            f"{DP_DEV_UPDATE_RTOL}, repeat bit for bit {same}, launches "
            f"{dev['launches']} (expected {want})")
    return {"dp": d, "devices": [str(x) for x in grid.col.devices],
            "arch": ARCH_NO_DROPOUT, "dtype": "float32", "lr": UPDATE_LR,
            "loss": dev["loss"], "loss_graph_batch": one["loss"],
            "update_rel_max_vs_graph_batch": rels[near], "tensor": near,
            "update_rtol": DP_DEV_UPDATE_RTOL, "repeat_bit_equal": same,
            "launches": dev["launches"], "launches_graph_batch":
                one["launches"],
            "devices_timing": dev["timing"],
            "graph_batch_timing": one["timing"]}


def batch_tensors(model, parts: list, grid):
    """The trainer's tensors of a batch's partitions, with the input cache:
    on ``grid`` each row's block on the row's edge mesh, or with None the
    whole batch on the stacked layout (the E shards on cuda:0)."""
    from lp_gnn_tpu_torch.parallel.dp import rank_block
    if grid is None:
        mesh = make_mesh(GRID_DEV["edge"], "cuda")
        return [edge_partition.dist_tensors(model, p, mesh, input_agg=True)
                for p in parts]
    return [[edge_partition.dist_tensors(model, parts[i], row,
                                         input_agg=True)
             for i in rank_block(list(range(len(parts))), grid.dp, d)]
            for d, row in enumerate(grid.rows)]


def grid_step_case(seed: int, twins: list, parts: list, w0: dict,
                   grid) -> dict:
    """One fp32 SGD step (ARCH_NO_DROPOUT, UPDATE_LR) of dp x edge on the
    device ``grid`` (row d block d of the twins' partitions, on its edge
    mesh) against ``dp_edge_train_step`` over the whole batch on the
    stacked layout (the E shards on cuda:0): each tensor's update within
    the bound the dp_edge phase holds its layout to (the larger of
    UPDATE_RTOL and DIST_UPDATE_SPREAD times the stacked step's own spread
    against its fp64 witness, ``union_step_fp64``); the grid step twice
    from w0, bit for bit; launches exact."""
    from lp_gnn_tpu_torch.parallel.combined import dp_edge_train_step
    loss_fn = LOSS_REGISTRY["balanced"]
    out = {}
    for way in ("grid", "grid_again", "stacked"):
        model = build_model(ARCH_NO_DROPOUT)
        model.load_state_dict(w0)
        model = model.to("cuda").train()
        opt = trainer.make_optimizer(model.parameters(), "sgd", UPDATE_LR)
        on = None if way == "stacked" else grid
        dgs = batch_tensors(model, parts, on)
        before = launch_counts()
        host, wall, loss = timed_call(lambda: dp_edge_train_step(
            model, opt, dgs, loss_fn, None, on))
        out[way] = {"state": {k: v.detach().cpu() for k, v in
                              model.state_dict().items()},
                    "loss": float(loss), "launches": launches_since(before),
                    "host_ms": host, "wall_ms": wall}
        del model, opt, dgs
        torch.cuda.empty_cache()
    fp64 = union_step_fp64(seed, twins, UPDATE_LR)
    got, again, st = out["grid"], out["grid_again"], out["stacked"]
    rels = update_rels(w0, got["state"], st["state"], UPDATE_LR)
    spread = update_rels(w0, st["state"], fp64, UPDATE_LR)
    limits = {k: max(UPDATE_RTOL, DIST_UPDATE_SPREAD * spread[k])
              for k in rels}
    worst = max(rels, key=lambda k: rels[k] / limits[k])
    same = got["loss"] == again["loss"] and all(
        torch.equal(v, again["state"][k]) for k, v in got["state"].items())
    want = add_launches(GRID_DEV_STEP)
    if rels[worst] > limits[worst] or not same or \
            got["launches"] != want or \
            abs(got["loss"] - st["loss"]) > 1e-5 * abs(st["loss"]):
        raise SmokeFailure(
            f"grid_devices grid step: loss {got['loss']} vs the stacked "
            f"{st['loss']}, update rel diff {rels[worst]} in {worst} > "
            f"{limits[worst]}, repeat bit for bit {same}, launches "
            f"{got['launches']} (expected {want})")
    return {"arch": ARCH_NO_DROPOUT, "dtype": "float32", "lr": UPDATE_LR,
            "loss": got["loss"], "loss_stacked": st["loss"],
            "update_rels_vs_stacked": rels,
            "stacked_vs_fp64_update_rels": spread,
            "spread_factor": DIST_UPDATE_SPREAD,
            "nearest_limit": {"tensor": worst, "update_diff": rels[worst],
                              "limit": limits[worst]},
            "repeat_bit_equal": same, "launches": got["launches"],
            "launches_stacked": st["launches"],
            "first_step_host_ms": got["host_ms"],
            "first_step_wall_ms": got["wall_ms"],
            "stacked_first_step_wall_ms": st["wall_ms"]}


def steady_grid(seed: int, parts: list, grid) -> dict:
    """The recipe's model (GCN_FC hids=1024 bf16, dropout 0, Adam at the
    trainer's lr) in a steady state: one untimed step then STEADY_REPS, on
    the device grid and on the stacked layout (the whole batch, E shards
    on cuda:0): host and wall ms, their medians, peak memory a card; then
    one grid step under the profiler (``profiled_step``)."""
    from lp_gnn_tpu_torch.parallel.combined import dp_edge_train_step
    loss_fn = LOSS_REGISTRY["balanced"]
    out = {}
    for way in ("grid", "stacked"):
        model = build_model(bf16_arch(ARCH_NO_DROPOUT),
                            generator=torch.Generator().manual_seed(seed))
        model = model.to("cuda").train()
        opt = trainer.make_optimizer(model.parameters(), "adam", 1e-3)
        on = None if way == "stacked" else grid
        dgs = batch_tensors(model, parts, on)
        reset_card_peaks(grid.devices)

        def step():
            dp_edge_train_step(model, opt, dgs, loss_fn, None, on)

        out[way] = timed_reps(step, STEADY_REPS)
        out[way]["max_memory_allocated_bytes"] = card_peaks(grid.devices)
        if on is not None:
            out["profiled_step"] = profiled_step(step, True)
        del model, opt, dgs
        torch.cuda.empty_cache()
    return out


def grid_devices(seed: int) -> dict:
    """dp and the (dp, edge) grid over the devices of one process
    (``parallel/mesh.py DeviceGrid``, JAX's layout of ``--mesh_shape
    dp=D[,edge=E]`` with D*E cards visible): cell (d, e) on
    cuda:(d*E + e mod the cards), a thread and stream a cell (on one card
    every cell on cuda:0), on the dp_edge phase's twins. Checks: a dp=2
    step against --graph_batch 2 (``dp_devices_case``) and a dp=2,edge=2
    grid step against the stacked layout's (``grid_step_case``), each
    bit for bit when repeated; the recipe through ``python -m
    lp_gnn_tpu_torch.train --mesh_shape dp=2,edge=2 --edge_num_thresh 0``
    (GRID_DEV_EPOCHS epochs, Adam, bf16) with its launches counted from 0
    exactly (the input cache one row conv a graph, a step GRID_DEV_STEP;
    no stacked K1, no rank form), finite losses and each card's peak
    memory; its steady steps beside the stacked layout's with each card's
    busy ms and idle share (``steady_grid``); ``pred_basis --mesh_shape
    dp=2,edge=2`` on the twins (served over the first E cards, one shard a
    device): valid .bas equal to the stacked serve's, byte for byte, the
    logits within DEV_LOGIT_TOL. With 4 cards also dp=4 alone
    (``dp_devices_case`` on 4 LPs of the twins' pattern)."""
    dp, e = GRID_DEV["dp"], GRID_DEV["edge"]
    cards = torch.cuda.device_count()
    devs = shard_devices(torch.device("cuda", 0), dp * e)
    grid = make_device_grid(dp, e, devs)
    from lp_gnn_tpu_torch.parallel.combined import partition_batch
    twins = twin_graphs(seed + 1200)
    w0 = seeded_state(ARCH_NO_DROPOUT, seed)
    dp_case = dp_devices_case(twins, w0, dp)
    t0 = time.perf_counter()
    parts = partition_batch(twins, e, halo=True)
    partition_s = time.perf_counter() - t0
    step_case = grid_step_case(seed, twins, parts, w0, grid)
    steady = steady_grid(seed, parts, grid)
    del parts
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="lp_gnn_smoke_gdev_") as tmp:
        data_prefix = osp.join(tmp, "data")
        write_dataset(osp.join(data_prefix, "smoke", "highs-inp_tgt"), 0, 4,
                      split_dataset(4, twins, seed))
        recipe = ["--arch", ARCH, "--fp16", "1", "--loss", "balanced",
                  "--epochs", str(GRID_DEV_EPOCHS), "--seed", str(seed),
                  *GRID_DEV_ARGS]
        reset_card_peaks(devs)
        with edge_layout(True):
            launches, tr, t_train, _, _ = run_train(tmp, data_prefix, recipe,
                                                    "grid_recipe")
        peaks = card_peaks(devs)
        want = add_launches(scaled(GRID_DEV_CONV, dp),
                            scaled(GRID_DEV_STEP, GRID_DEV_EPOCHS))
        kinds = [st["kind"] for st in tr.steps]
        if launches != want or kinds != ["dp_edge_train_step"] * \
                GRID_DEV_EPOCHS or any(st["launches"] != add_launches(
                    GRID_DEV_STEP) for st in tr.steps):
            raise SmokeFailure(
                f"grid_devices recipe: steps {kinds}, launches {launches} "
                f"(expected {want}), a step "
                f"{[st['launches'] for st in tr.steps]} (expected "
                f"{GRID_DEV_STEP})")
        # the twins alone (check_bases holds bench-shape LPs)
        serve_data = osp.join(tmp, "serve_data")
        write_dataset(osp.join(serve_data, "smoke", "highs-inp_tgt"), 0, 2,
                      twins)
        ckpt = save_seeded(ARCH, seed, osp.join(tmp, "mdl.pth"))
        served = {}
        logits = {}
        for layout, per_fwd in (("stacked", scaled(GRID_STACKED_CONV, 2)),
                                ("devices", scaled(GRID_DEV_CONV, 2))):
            with CaptureLogits() as cap, edge_layout(layout == "devices"):
                served[layout] = serve_and_check(
                    serve_data, osp.join(tmp, layout), ckpt, seed, 2,
                    "trainval", per_fwd, GRID_DEV_ARGS)
            logits[layout] = cap.logits
        dirs = [osp.join(tmp, w, "smoke", "pred-basis")
                for w in ("stacked", "devices")]
        # the bases byte for byte; their .sort files hold the logits, held
        # to DEV_LOGIT_TOL below
        bas = sorted(f for f in os.listdir(dirs[0]) if f.endswith(".bas"))
        same_bas = {f: filecmp.cmp(osp.join(dirs[0], f),
                                   osp.join(dirs[1], f), shallow=False)
                    for f in bas}
    worst = {}
    for fn, got in logits["devices"].items():
        err, ok = within(torch.from_numpy(got),
                         torch.from_numpy(logits["stacked"][fn]),
                         *DEV_LOGIT_TOL)
        worst[fn] = err
        if not ok:
            raise SmokeFailure(f"grid_devices serve {fn}: logits max |err| "
                               f"{err} vs the stacked serve's, beyond "
                               f"{DEV_LOGIT_TOL}")
    if len(worst) != 2 or not all(same_bas.values()):
        raise SmokeFailure(f"grid_devices serve: logits of {sorted(worst)}, "
                           f"files equal to the stacked serve's {same_bas}")
    dp4 = dp_devices_case(pattern_twins(seed + 1300, 4),
                          w0, 4) if cards >= 4 else {
        "skipped": f"needs 4 cards, has {cards}"}
    return {
        "cards": cards, "dp": dp, "edge": e,
        "cells": {f"({i // e}, {i % e})": str(d) for i, d in enumerate(devs)},
        "distinct_devices": len(set(devs)),
        "note": f"{dp * e} cells on {len(set(devs))} distinct device(s), a "
                "thread and stream a cell; with one card every cell on "
                "cuda:0, and no figure here is a several-card figure",
        "launches": add_launches(launches, served["devices"]["launches"]),
        "dp_step": dp_case, "grid_step": step_case,
        "partition_s": partition_s,
        "recipe": {"arch": bf16_arch(ARCH), "epochs": GRID_DEV_EPOCHS,
                   "launches": launches, "launches_per_step": GRID_DEV_STEP,
                   "launch_formula": "the input cache one row conv a graph "
                                     f"(GRID_DEV_CONV {GRID_DEV_CONV}) x "
                                     f"{dp} + a grid step x "
                                     f"{GRID_DEV_EPOCHS}",
                   "step_losses": [st["loss"] for st in tr.steps],
                   "step_device_ms": [st["device_ms"] for st in tr.steps],
                   "partition_s": tr.partition_s,
                   "dist_tensors_s": tr.dist_tensors_s,
                   "max_memory_allocated_bytes": peaks,
                   "train_s": t_train},
        "steady": {"arch": bf16_arch(ARCH_NO_DROPOUT), "reps": STEADY_REPS,
                   **steady},
        "serve": {"bas_valid": served["devices"]["bas_valid"],
                  "bas_equal_stacked": same_bas,
                  "logits_max_abs_err_vs_stacked": worst,
                  "logit_tol": {"rtol": DEV_LOGIT_TOL[0],
                                "atol": DEV_LOGIT_TOL[1]},
                  "launches": served["devices"]["launches"],
                  "inf_time_s": served["devices"]["inf_time_s"],
                  "stacked_inf_time_s": served["stacked"]["inf_time_s"]},
        "dp4": dp4,
    }


MERGE_TOL = (1e-5, 1e-6)   # rtol, atol: expf / logf and the online order


def merge_case(case: str, args: tuple, on_path, local: bool = True,
               path: str = "dist_gen_train") -> dict:
    """gen_lse_merge against its plain version (MERGE_TOL), bit-identical
    over two calls, timed beside it; its bound is bytes (without ``local``
    no row has a local part, and the local operands are not read)."""
    local_edges, loc_aggr, loc_lse, ptr, idx, parts = args
    aggr, lse = gen_lse_merge(*args)
    again = gen_lse_merge(*args)
    want = gen_lse_merge_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(aggr, again[0]) and torch.equal(lse, again[1])):
        raise SmokeFailure(f"gen_lse_merge {case}: two calls differ")
    err, ok = within(aggr, want[0], *MERGE_TOL)
    err_l, ok_l = within(lse, want[1], *MERGE_TOL)
    if not (ok and ok_l):
        raise SmokeFailure(f"gen_lse_merge {case}: max |err| {err}, {err_l} "
                           f"beyond rtol, atol {MERGE_TOL}")
    rows, d = loc_aggr.shape
    n = idx.shape[0]
    n_bytes = rows * 4 + (rows + 1) * 4 + n * 4 \
        + (4 if local else 2) * rows * d * 4 + n * 2 * d * 4
    bound_ms, bound_by = bound(n_bytes, 6.0 * (rows + n) * d)
    return {
        "name": "gen_lse_merge", "route": "cuda",
        "source": "lp_gnn_tpu_torch/ops/csrc/gen_lse_merge.cu",
        "replaces": "lp_gnn_tpu/parallel/edge_partition.py:930",
        "launches": None, "max_abs_err": max(err, err_l),
        "ms": time_ms(lambda: gen_lse_merge(*args), 20),
        "device_ms": kernel_device_ms(lambda: gen_lse_merge(*args),
                                      "gen_lse_merge_kernel"),
        "plain_ms": time_ms(lambda: gen_lse_merge_plain(*args), 5),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "case": case, "on_path": on_path, "path": path,
        "rows": rows, "slot_parts": n, "D": d,
        "tol": {"rtol": MERGE_TOL[0], "atol": MERGE_TOL[1]},
        "library": "none: no one PyTorch call merges log-sum-exps by segment",
    }


def check_dist_gen_kernels(g: BipartiteGraph, gen: torch.Generator) -> list:
    """GEN's kernels at the shapes the dist GEN layer runs on the bench
    graph at K=4 (shard 0, the most edges): gen_agg_fwd / gen_agg_bwd over
    the l2r compact CSR (ns + nh rows from ms constraints) and the r2l CSR
    (ms rows from ns + nh compact sources), D=256 bf16; and gen_lse_merge
    over the owners' K*ns rows with the slot parts that K1 delivers from the
    l2r forwards of all 4 shards, D=256 and D=3 (conv_out) fp32."""
    dgt = edge_partition.DistGraphTensors.from_partition(
        edge_partition.partition_graph(g, K_EDGE, halo=True),
        make_mesh(K_EDGE, "cuda"), gen=True)
    k, ms, ns, nh = dgt.n_shards, dgt.ms, dgt.ns, dgt.nh
    dg = dgt.gen
    rows = []
    on = "dist_zoo_serve, dist_gen_train"
    for dname, csr, n_src in (("l2r", dg.l2r[0], ms),
                              ("r2l", dg.r2l[0], ns + nh)):
        args = (*csr, *gen_operands(n_src, 256, torch.bfloat16, gen))
        case = (f"dist {dname} shard 0 compact ({csr.ptr.shape[0] - 1} rows, "
                f"{n_src} sources) D=256 bfloat16")
        row, aggr, lse = gen_fwd_case(case, args, on)
        brow, _ = gen_bwd_case(case, args, aggr, lse, gen, "dist_gen_train")
        rows += [{**row, "path": "dist_gen_train"},
                 {**brow, "path": "dist_gen_train"}]
        del args, aggr, lse
        torch.cuda.empty_cache()
    for d in (256, 3):
        x, w, b, t = gen_operands(ms, d, torch.float32, gen)
        parts = [gen_agg_fwd(*dg.l2r[s], x, w, b, t) for s in range(k)]
        send = torch.zeros(k, nh, gen_agg_mod.padded_width(2 * d,
                                                           torch.float32),
                           device="cuda")
        for s, (a, lse) in enumerate(parts):
            send[s, :, :d], send[s, :, d:2 * d] = a[ns:], lse[ns:]
        back = halo_all_to_all(send)
        args = (dg.local_edges, torch.cat([a[:ns] for a, _ in parts]),
                torch.cat([lse[:ns] for _, lse in parts]), dg.merge_ptr,
                dg.merge_idx, back.view(k * nh, back.shape[2]))
        rows.append(merge_case(f"owners' merge K={k}, {k * ns} rows, "
                               f"D={d} float32", args, on))
        del parts, send, back, args
        torch.cuda.empty_cache()
    return rows


def check_all_gather_kernels(g: BipartiteGraph,
                             gen: torch.Generator) -> list:
    """The kernels at the all-gather branch's shapes on the bench graph at
    K=4 (shard 0, the most edges): the SpMM over shard 0's full v2c (ms
    rows from all n_pad variables) and full c2v (all n_pad rows from ms
    constraints), D=8 and D=1024 bf16; gen_agg_fwd / gen_agg_bwd over the
    l2r CSR of all n_pad variable rows and the r2l CSR of ms rows from
    n_pad sources, D=256 bf16; and gen_lse_merge of the 4 shards' parts of
    every variable row (no local part), D=256 and D=3 fp32."""
    dg = edge_partition.partition_graph(g, K_EDGE)
    dgt = edge_partition.DistGraphTensors.from_partition(
        dg, make_mesh(K_EDGE, "cuda"), gen=True)
    k, ms, n_pad = dgt.n_shards, dgt.ms, dgt.n_pad
    rows = []
    for d in (8, 1024):
        for name, m, n_src in (("full v2c", dgt.full_v2c[0], n_pad),
                               ("full c2v", dgt.full_c2v[0], ms)):
            x = torch.randn(n_src, d, generator=gen, device="cuda")
            rows.append({**spmm_case(
                f"all-gather shard 0 {name} D={d} bfloat16", *m,
                x.to(torch.bfloat16), "all_gather"), "path": "all_gather"})
    gt = dgt.gen
    for dname, csr, n_src in (("l2r", gt.l2r[0], ms),
                              ("r2l", gt.r2l[0], n_pad)):
        args = (*csr, *gen_operands(n_src, 256, torch.bfloat16, gen))
        case = (f"all-gather {dname} shard 0 ({csr.ptr.shape[0] - 1} rows, "
                f"{n_src} sources) D=256 bfloat16")
        row, aggr, lse = gen_fwd_case(case, args, "all_gather")
        brow, _ = gen_bwd_case(case, args, aggr, lse, gen, "all_gather")
        rows += [{**row, "path": "all_gather"},
                 {**brow, "path": "all_gather"}]
        del args, aggr, lse
        torch.cuda.empty_cache()
    for d in (256, 3):
        x, w, b, t = gen_operands(ms, d, torch.float32, gen)
        parts = torch.empty(k, n_pad, 2 * d, device="cuda")
        for s in range(k):
            parts[s, :, :d], parts[s, :, d:] = gen_agg_fwd(*gt.l2r[s], x, w,
                                                           b, t)
        flat = parts.view(k * n_pad, 2 * d)
        unread = flat.new_empty((n_pad, d))
        args = (gt.local_edges, unread, unread, gt.merge_ptr, gt.merge_idx,
                flat)
        rows.append(merge_case(
            f"all-gather merge of K={k} full-width parts, {n_pad} rows, "
            f"D={d} float32", args, "all_gather", local=False,
            path="all_gather"))
        del parts, flat, unread, args
        torch.cuda.empty_cache()
    return rows


# ----------------------------------------------------------- steps_per_call
SCAN_K = 4                  # steps a call: --steps_per_call 4
SCAN_VISITS = 3             # visits of a stack: eager, capture + replay,
                            # replay
SCAN_TIMED_CALLS = 5        # K-step calls a timing turn
SCAN_TRACE_EPOCHS = 2       # --trace 1 traces the second


def reset_launches() -> None:
    """Every wrapper's count, the COLLECTIVE route's exchanges and the
    K-step call's capture and replay counts set to 0."""
    for kern in KERNELS:
        kern.launches = 0
    halo_all_to_all_ranks.collective_exchanges = 0
    scan_mod.reset_counts()


def card_launches() -> dict:
    """Each kernel's launches on the card since ``reset_launches``: its
    wrapper's count (eager launches, and calls recorded by a CUDA graph
    capture, which launch nothing) less the recorded calls plus the calls
    the graphs' replays ran (``train/scan.py``): a graph's kernel nodes
    are the wrapper calls its capture recorded."""
    return {k.__name__: scan_mod.card_launches(k.__name__, k.launches)
            for k in KERNELS}


def pattern_twins(seed: int, n: int) -> list[BipartiteGraph]:
    """n bench-shape LPs on the sparsity pattern of ``bench_graph(seed)``
    (so one stack key), each with values, features and labels of its own
    (from ``seed + 1 + i``)."""
    base = bench_graph(seed)
    out = []
    for i in range(n):
        rng = np.random.RandomState(seed + 1 + i)
        feas = []
        for rows in (M, N):
            fe = rng.rand(rows, 8).astype(np.float32) - 0.5
            fe[:, -3] = rng.randint(-1, 2, rows)
            fe[:, -1] = rng.randint(-1, 2, rows)
            feas.append(fe)
        out.append(BipartiteGraph(
            row=base.row, col=base.col,
            val=rng.rand(E).astype(np.float32) - 0.5, c_feas=feas[0],
            v_feas=feas[1], y_s=rng.randint(0, 3, M).astype(np.int32),
            y_t=rng.randint(0, 3, N).astype(np.int32)))
    return out


def scan_setup(arch: str, seed: int):
    """A seeded bf16 model on the card in training mode, Adam built
    capturable (as the trainer builds it for --steps_per_call above 1) and
    the dropout generator: the same for the same arguments."""
    model = build_model(bf16_arch(arch),
                        generator=torch.Generator().manual_seed(seed))
    model = model.to("cuda").train()
    opt = trainer.make_optimizer(model.parameters(), capturable=True)
    return model, opt, torch.Generator(device="cuda").manual_seed(seed)


def scan_vs_eager(seed: int, arch: str, graphs: list, stacked: bool, k: int,
                  visits: int, per_step: dict) -> dict:
    """``visits`` calls of the K-step function (the first eager on its
    capture stream, the second captured and replayed, the rest replayed)
    against the same steps taken one ``train_step`` at a time on the
    default stream, from the same weights, Adam state and generator: the
    losses, the accuracies (asked for at every other step, -1 elsewhere),
    every parameter, Adam's moments and step counts and the generator's
    state must be equal bit for bit; the K-step run's launches on the
    card exactly ``per_step`` a step."""
    runs = [scan_setup(arch, seed) for _ in range(2)]
    gts = [trainer.train_graph(runs[0][0], g, "cuda") for g in graphs]
    stack = gts if stacked else gts * k
    step = scan_mod.make_scan_train_step(runs[0][0], "balanced", runs[0][1],
                                         stacked=stacked,
                                         generator=runs[0][2])
    acc_on = [i % 2 == 0 for i in range(k)]
    reset_launches()
    got_l, got_a = [], []
    for _ in range(visits):
        losses, accs = step(gts if stacked else gts[0], acc_on=acc_on, k=k)
        got_l += losses.tolist()
        got_a += accs.tolist()
    launches = card_launches()
    nodes = dict(scan_mod.CAPTURED)
    model, opt, gen = runs[1]
    loss_fn = LOSS_REGISTRY["balanced"]
    want_l, want_a = [], []
    for _ in range(visits):
        for gt, on in zip(stack, acc_on):
            loss, acc = trainer.train_step(model, opt, gt, loss_fn, gen, on)
            want_l.append(float(loss))
            want_a.append(float(acc) if on else -1.0)
    diff = max_diff(state_of(runs[0][0]), state_of(model))
    opt_equal = all(torch.equal(runs[0][1].state[pa][key], opt.state[pb][key])
                    for pa, pb in zip(runs[0][0].parameters(),
                                      model.parameters())
                    for key in ("exp_avg", "exp_avg_sq", "step"))
    gen_equal = torch.equal(runs[0][2].get_state(), gen.get_state())
    bitwise = (got_l == want_l and got_a == want_a and diff == 0.0
               and opt_equal and gen_equal)
    out = {"arch": bf16_arch(arch), "stacked": stacked, "k": k,
           "visits": visits, "captures": step.captures,
           "replays": step.replays, "losses": got_l, "eager_losses": want_l,
           "accs": got_a, "params_max_abs_diff": diff,
           "adam_state_equal": opt_equal, "generator_equal": gen_equal,
           "bit_for_bit": bitwise, "launches": launches,
           "graph_nodes": nodes}
    if not bitwise:
        raise SmokeFailure(f"captured steps differ from eager ones: {out}")
    want = {**no_launches(),
            **{name: n * k * visits for name, n in per_step.items()}}
    if launches != want or step.captures != 1 or \
            step.replays != visits - 1:
        raise SmokeFailure(f"K-step launches {launches}, expected {want} "
                           f"({per_step} a step), {step.captures} captures, "
                           f"{step.replays} replays: {out}")
    return out


def scan_timing(seed: int, g: BipartiteGraph) -> dict:
    """The flagship step on one bench-shape LP, K=SCAN_K steps a call,
    eager (K ``train_step`` calls, the loss read after each, as the
    trainer at --steps_per_call 1 reads it) and captured (one replay, one
    read of the K losses), in turns E, C, C, E of SCAN_TIMED_CALLS calls:
    host wall a step, the device span a step (CUDA events), the peak of
    allocated memory (a replay allocates nothing: the graph's own
    temporaries lie in its pool, whose reserved bytes are given apart);
    then each mode's device time from ``torch.profiler`` over one call and
    the card's idle share of its span, the replay's SpMM kernels by name
    against the graph's recorded calls, and the cost of the decode
    accuracy where a step asks for it (after a replay, from the step's
    logits)."""
    model, opt, gen = scan_setup(ARCH, seed)
    gt = trainer.train_graph(model, g, "cuda")
    loss_fn = LOSS_REGISTRY["balanced"]
    step = scan_mod.make_scan_train_step(model, "balanced", opt,
                                         stacked=False, generator=gen)
    acc_on = [False] * SCAN_K

    def eager():
        for _ in range(SCAN_K):
            float(trainer.train_step(model, opt, gt, loss_fn, gen)[0])

    def captured():
        losses, accs = step(gt, acc_on=acc_on, k=SCAN_K)
        torch.stack((losses, accs)).tolist()

    eager()                         # Adam's state, cuBLAS's workspace
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    step(gt, k=SCAN_K)              # the first visit: eager, then capture
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    pool_bytes = torch.cuda.memory_reserved() - reserved0
    captured()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    turns = []
    for mode, fn in (("eager", eager), ("captured", captured),
                     ("captured", captured), ("eager", eager)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ev0.record()
        for _ in range(SCAN_TIMED_CALLS):
            fn()
        ev1.record()
        ev1.synchronize()
        n = SCAN_TIMED_CALLS * SCAN_K
        turns.append({"mode": mode,
                      "host_wall_ms_per_step":
                      (time.perf_counter() - t0) * 1e3 / n,
                      "device_span_ms_per_step": ev0.elapsed_time(ev1) / n,
                      "max_memory_allocated_bytes":
                      torch.cuda.max_memory_allocated(),
                      "max_memory_reserved_bytes":
                      torch.cuda.max_memory_reserved()})
    st = next(iter(step.stacks.values()))
    profiled = {}
    for mode, fn in (("eager", eager), ("captured", captured)):
        seen, complete = profile_kernels(
            fn, 1, {"spmm_csr_kernel": SPMM_PER_STEP * SCAN_K})
        busy = sum(t for t, _ in seen.values())
        span = np.median([t["device_span_ms_per_step"] for t in turns
                          if t["mode"] == mode]) * SCAN_K
        profiled[mode] = {
            "device_ms_by_kind": categorize(seen), "busy_ms": busy,
            "idle_share_of_span": 1 - busy / span,
            "spmm_kernels": sum(n for name, (_, n) in seen.items()
                                if "spmm_csr_kernel" in name),
            "profile_complete": complete}
    if profiled["captured"]["spmm_kernels"] != st.nodes.get("spmm_csr"):
        raise SmokeFailure(f"a replay ran {profiled['captured']} SpMM "
                           f"kernels, its capture recorded {st.nodes}")
    with torch.no_grad():
        lc, lv = model(gt, generator=gen)
    ms, mt = trainer.seed_masks(gt)
    decode_ms = time_ms(lambda: trainer.step_accuracy(gt, lc, lv, ms, mt), 20)
    return {"arch": bf16_arch(ARCH), "k": SCAN_K, "lp_nodes": M + N,
            "nnz": E, "turns": turns, "profiled": profiled,
            "graph_nodes": st.nodes, "graph_pool_reserved_bytes": pool_bytes,
            "decode_acc_ms_per_step": decode_ms}


def trace_read(path: str) -> dict:
    """The card's activity in one torch.profiler trace (Chrome JSON):
    kernels (and copies, sets) by count, those of the SpMM, their union's
    busy ms over the span from the first to the last, the idle share."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    spmm = sum(1 for e in events if e.get("cat") == "kernel"
               and "spmm_csr_kernel" in e.get("name", ""))
    busy, end = 0.0, -np.inf
    for a, b in dev:   # sorted by start: what is new lies past ``end``
        if b > end:
            busy += b - max(a, end)
            end = b
    span = (dev[-1][1] - dev[0][0]) if dev else 0.0
    return {"file": osp.basename(path), "bytes": osp.getsize(path),
            "device_events": len(dev), "spmm_kernels": spmm,
            "busy_ms": busy / 1e3, "span_ms": span / 1e3,
            "idle_share": 1 - busy / span if span else None}


def mirp_train_turns(seed: int, data_prefix: str) -> dict:
    """The train stage (``python -m lp_gnn_tpu_torch.train``) on the
    pipeline's mirp_bench family (21 train LPs), the recipe's arch in bf16,
    PIPE_EPOCHS epochs, with --steps_per_call SCAN_K and 1 in turns (K, 1,
    1, K), the counts set to 0 just before each run and read just after:
    each run's stacks and singles, epoch wall seconds, last logged loss,
    peak memory and SpMM launches on the card against the printed formula
    (the same for both: 2 a train graph for the input cache, SPMM_PER_STEP
    a step); under K the graph nodes recorded and replayed exactly (one
    capture a stack, replayed every epoch after the first two). Then
    ``--trace 1`` over SCAN_TRACE_EPOCHS epochs at K: the trace under
    ``{log_dir}/trace`` names the SpMM kernel; its idle share."""
    from lp_gnn_tpu_torch.data.dataset import split_train_val
    from lp_gnn_tpu_torch.parallel.dp import stack_groups
    train_ds, _ = split_train_val(LPDataset(osp.join(
        data_prefix, "mirp_bench", "highs-inp_tgt")), seed)
    n_train = len(train_ds)
    stacks, singles, _ = stack_groups(train_ds, SCAN_K, 4e6 * 3)
    n_stacked = SCAN_K * len(stacks)
    formula = f"2 x {n_train} + {SPMM_PER_STEP} x {n_train} x epochs"
    tmp = tempfile.mkdtemp(prefix="lp_gnn_smoke_scan_")
    runs = []

    def run(k: int, exp: str, epochs: int, extra: list) -> tuple:
        argv = ["--dataset", "mirp_bench", "--data_prefix", data_prefix,
                "--log_prefix", osp.join(tmp, "runs"), "--exp_nm", exp,
                "--arch", ARCH, "--fp16", "1", "--loss", "balanced",
                "--epochs", str(epochs), "--seed", str(seed),
                "--steps_per_call", str(k), *extra]
        ends = []
        real_save = trainer.save_checkpoint

        def save_seen(*a, **kw):
            ends.append(time.perf_counter())
            return real_save(*a, **kw)

        trainer.save_checkpoint = save_seen
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            wall = run_module("lp_gnn_tpu_torch.train", argv)
        finally:
            trainer.save_checkpoint = real_save
        launches = card_launches()
        want = {**no_launches(), "spmm_csr": 2 * n_train
                + SPMM_PER_STEP * n_train * epochs}
        nodes = {"recorded": dict(scan_mod.CAPTURED),
                 "replayed": dict(scan_mod.REPLAYED)}
        want_nodes = {"recorded": {}, "replayed": {}} if k == 1 else {
            "recorded": {"spmm_csr": SPMM_PER_STEP * n_stacked},
            "replayed": {"spmm_csr": SPMM_PER_STEP * n_stacked
                         * (epochs - 1)}}
        if launches != want or nodes != want_nodes:
            raise SmokeFailure(f"steps_per_call {k}: launches {launches}, "
                               f"nodes {nodes}; expected {want} ({formula})"
                               f", nodes {want_nodes}")
        log_dir = osp.join(tmp, "runs", exp)
        with open(osp.join(log_dir, "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        losses = [r["value"] for r in logged if r["tag"] == "train/loss"]
        if not losses or not np.isfinite(losses).all():
            raise SmokeFailure(f"steps_per_call {k}: losses {losses}")
        ends = [t0] + ends
        return log_dir, {
            "steps_per_call": k, "epochs": epochs, "wall_s": wall,
            "epoch_wall_s": [b - a for a, b in zip(ends, ends[1:])],
            "last_logged_loss": losses[-1], "launches": launches,
            "graph_nodes": nodes, "max_memory_allocated_bytes":
            torch.cuda.max_memory_allocated(), "max_memory_reserved_bytes":
            torch.cuda.max_memory_reserved()}

    try:
        for i, k in enumerate((SCAN_K, 1, 1, SCAN_K)):
            runs.append(run(k, f"k{k}_{i}", PIPE_EPOCHS, [])[1])
        log_dir, traced = run(SCAN_K, "trace", SCAN_TRACE_EPOCHS,
                              ["--trace", "1"])
        files = sorted(os.listdir(osp.join(log_dir, "trace")))
        if len(files) != 1 or not files[0].endswith(".pt.trace.json"):
            raise SmokeFailure(f"--trace 1 wrote {files} under "
                               f"{log_dir}/trace")
        traced["trace"] = trace_read(osp.join(log_dir, "trace", files[0]))
        if traced["trace"]["spmm_kernels"] == 0:
            raise SmokeFailure(f"the trace names no SpMM kernel: {traced}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"train_lps": n_train, "stacks": len(stacks),
            "stacked_lps": n_stacked, "singles": len(singles),
            "spmm_formula": formula, "turns": runs, "trace": traced,
            "launches": runs[0]["launches"]}


def steps_per_call(seed: int, mirp_prefix: str) -> dict:
    """Phase 25 (module docstring)."""
    twins = pattern_twins(seed + 5000, SCAN_K)
    keys = {stack_key(g) for g in twins}
    if len(keys) != 1:
        raise SmokeFailure(f"the twins' stack keys differ: {keys}")
    per_step = {"spmm_csr": SPMM_PER_STEP}
    single = scan_vs_eager(seed, ARCH, twins[:1], False, SCAN_K, SCAN_VISITS,
                           per_step)
    stacked = scan_vs_eager(seed, ARCH, twins, True, SCAN_K, SCAN_VISITS,
                            per_step)
    timing = scan_timing(seed, twins[0])
    torch.cuda.empty_cache()
    gen = scan_vs_eager(seed, GEN_ARCH, [bench_graph(seed + 5100)], False,
                        2, 2, GEN_PER_STEP)
    torch.cuda.empty_cache()
    mirp = mirp_train_turns(seed, mirp_prefix)
    return {"bench_lps": "4 bench-shape LPs on one sparsity pattern (one "
            "stack key), values, features and labels of their own",
            "single": single, "stacked": stacked, "timing": timing,
            "gen": gen, "mirp_bench": mirp, "launches": mirp["launches"]}


# ------------------------------------------------------------- all_gather
AG_RANKS = K_EDGE
# a GraphConv conv over the ranks' all-gather layout, per rank: one SpMM
# over its full v2c and one over its full c2v
AG_RANK_CONV = {"spmm_csr": 2}
AG_TIMED = 3                # timed forwards / steps a route, after a warm-up


def ag_logits_held(arch: str, seed: int, g: BipartiteGraph, dg_ag, dg_halo,
                   mesh) -> dict:
    """``arch``'s logits over the all-gather layout against the halo
    route's and the single card's, with the weights ``save_seeded`` gives:
    fp32 max |err| <= 1e-3 against each (the dist_serve phase's limit);
    bf16 mean |err| against the single card's fp32 at most
    DIST_BF16_SPREAD times the single card's own bf16 mean |err|
    (``dist_logits_held``'s rule), the halo route's beside it."""
    logits = {}
    for dtype in ("float32", "bfloat16"):
        base = arch.strip()[:-1]
        spec = base + ("" if base.endswith("(") else ",") + f"dtype='{dtype}')"
        model = build_model(spec, generator=torch.Generator().manual_seed(seed))
        model = model.to("cuda").eval()
        with torch.inference_mode():
            for path, dg in (("single", None), ("all_gather", dg_ag),
                             ("halo", dg_halo)):
                if dg is None:
                    lc, lv = model(GraphTensors.from_graph(g, "cuda"))
                else:
                    lc, lv = edge_partition.dist_apply(model, dg, mesh)
                    lc, lv = lc[:g.ncons], lv[:g.nvars]
                got = torch.cat([lc, lv]).float().cpu().numpy()
                if not (np.isfinite(got).all() and
                        got.shape == (g.ncons + g.nvars, 3)):
                    raise SmokeFailure(f"{arch} {dtype} {path}: bad logits")
                logits[dtype, path] = got
        del model
        torch.cuda.empty_cache()
    ref = logits["float32", "single"]
    vs_single = np.abs(logits["float32", "all_gather"] - ref).max()
    vs_halo = np.abs(logits["float32", "all_gather"]
                     - logits["float32", "halo"]).max()
    mean16 = {p: float(np.abs(logits["bfloat16", p] - ref).mean())
              for p in ("single", "all_gather", "halo")}
    if max(vs_single, vs_halo) > 1e-3 or \
            mean16["all_gather"] > DIST_BF16_SPREAD * mean16["single"]:
        raise SmokeFailure(f"{arch} all-gather logits: fp32 max |err| "
                           f"{vs_single} vs single, {vs_halo} vs halo (limit "
                           f"1e-3); bf16 mean |err| {mean16}")
    return {"float32_max_abs_err_vs_single": float(vs_single),
            "float32_max_abs_err_vs_halo": float(vs_halo), "atol": 1e-3,
            "bfloat16_mean_abs_err": mean16,
            "bf16_spread_factor": DIST_BF16_SPREAD}


def median(xs: list) -> float:
    return sorted(xs)[len(xs) // 2]


def route_figures(seed: int, dg, mesh, arch: str = ARCH) -> dict:
    """One route's figures for ``arch`` in bf16 (seeded; the recipe's
    GCN_FC hids=1024 by default): a forward (eval, no input cache) and a
    train step (Adam, dropout, the input cache where the arch reads one),
    each AG_TIMED times after a warm-up: spans on the card (CUDA events),
    launches a forward / step (exact: the layout's formula), peak memory.
    ``launches``: the whole run's, warm-ups and cache included."""
    halo = dg.halo
    model = build_model(bf16_arch(arch),
                        generator=torch.Generator().manual_seed(seed)).to("cuda")
    per = {"forward": dist_forward_launches(arch, halo),
           "step": dist_step_launches(arch, halo)}
    cache = (DIST_CONV if halo else AG_CONV) if model.reads_input_agg else {}
    out = {"arch": arch, "layout": "halo" if halo else "all-gather",
           "launches": add_launches(cache, *(scaled(v, AG_TIMED + 1)
                                             for v in per.values()))}
    for kind in ("forward", "step"):
        dgt = edge_partition.dist_tensors(model, dg, mesh,
                                          input_agg=kind == "step")
        opt = trainer.make_optimizer(model.parameters(), "adam", 1e-3)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        loss_fn = LOSS_REGISTRY["balanced"]

        def run():
            if kind == "forward":
                with torch.inference_mode():
                    return edge_partition.dist_forward(model.eval(), dgt)
            return edge_partition.dist_train_step(model, opt, dgt, loss_fn,
                                                  gen)

        run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = launch_counts()
        spans, outs = [], []
        for _ in range(AG_TIMED):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            outs.append(run())
            ev[1].record()
            torch.cuda.synchronize()
            spans.append(ev[0].elapsed_time(ev[1]))
        got = launches_since(before)
        if got != scaled(add_launches(per[kind]), AG_TIMED):
            raise SmokeFailure(f"{arch} {out['layout']} {kind}: launches "
                               f"{got}, expected {per[kind]}")
        if kind == "step" and not all(np.isfinite(float(v)) for v in outs):
            raise SmokeFailure(f"{out['layout']} step: a loss not finite")
        out[kind] = {"device_ms": spans, "device_ms_median": median(spans),
                     "launches": per[kind],
                     "max_memory_allocated_bytes":
                         torch.cuda.max_memory_allocated()}
        del dgt, opt, outs
        torch.cuda.empty_cache()
    return out


def ag_rank(payload_path: str) -> None:
    """One rank of the all_gather phase's rank run, in this process
    (``--ag_rank``): shard k of the bench LP's all-gather partition on rank
    k (gloo, the LP_GNN_DIST_* contract). The recipe's forward (GCN_FC
    hids=1024 bf16, seeded, eval) with its logits gathered to rank 0, its
    launches counted from 0 and its span timed (AG_TIMED after a
    warm-up); one fp32 step (``rank_step`` over the all-gather layout);
    each collective at the recipe's width alone, after a barrier whose
    wait is timed (the all-gather of the rank's (ns, 1024) bf16 rows, the
    reduce-scatter of its (n_pad, 1024) partials). Writes its report, and
    rank 0 its logits and weights, into the payload's directory."""
    from lp_gnn_tpu_torch.parallel import mesh as mesh_mod
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    with open(payload_path) as f:
        p = json.load(f)
    rank = int(os.environ["LP_GNN_DIST_PROC_ID"])
    _, created = mesh_mod.init_distributed(torch.device("cuda"))
    report = {}
    try:
        group = torch.distributed.group.WORLD
        k = torch.distributed.get_world_size()
        g = bench_graph(p["seed"] + 1500)
        dg = edge_partition.partition_graph(g, k)
        mesh = make_mesh(k, "cuda", group)
        model = build_model(bf16_arch(ARCH), generator=torch.Generator(
            ).manual_seed(p["seed"])).to("cuda").eval()
        dgt = edge_partition.dist_tensors(model, dg, mesh)
        reset_launches()
        with torch.inference_mode():
            lc, lv = edge_partition.gather_logits(
                *edge_partition.dist_forward(model, dgt), mesh)
        report["forward_launches"] = launch_counts()
        if lc is not None:
            np.save(osp.join(p["dir"], "ag_rank_logits.npy"),
                    torch.cat([lc[:g.ncons], lv[:g.nvars]]).numpy())
        spans = []
        for _ in range(AG_TIMED):
            torch.distributed.barrier()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            with torch.inference_mode():
                edge_partition.dist_forward(model, dgt)
            ev[1].record()
            torch.cuda.synchronize()
            spans.append(ev[0].elapsed_time(ev[1]))
        report["forward_device_ms"] = spans
        del model, dgt
        torch.cuda.empty_cache()
        report["step"] = rank_step(
            p["seed"], osp.join(p["dir"], "ag_rank_step.pth"),
            ARCH_NO_DROPOUT, bench_graph(p["seed"] + 1100), halo=False)
        torch.cuda.empty_cache()
        gen = torch.Generator(device="cuda").manual_seed(p["seed"] + rank)
        rows = torch.randn(dg.ns, 1024, generator=gen,
                           device="cuda").bfloat16()
        parts = torch.randn(1, dg.n_pad, 1024, generator=gen,
                            device="cuda").bfloat16()
        coll = {}
        for name, fn in (
                ("all_gather", lambda: edge_partition.all_gather_vars(
                    rows, group)),
                ("reduce_scatter", lambda: edge_partition.reduce_scatter_vars(
                    parts, group))):
            wait, ms = [], []
            for _ in range(AG_TIMED + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                torch.distributed.barrier()
                t1 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wait.append((t1 - t0) * 1e3)
                ms.append((time.perf_counter() - t1) * 1e3)
            coll[name] = {"ms": ms[1:], "wait_ms": wait[1:]}
        report["collectives"] = coll
        report["backend"] = torch.distributed.get_backend()
    finally:
        mesh_mod.leave_distributed(created)
    with open(osp.join(p["dir"], f"ag_report{rank}.json"), "w") as f:
        json.dump(report, f)


def all_gather_ranks(seed: int, dg, mesh) -> dict:
    """AG_RANKS processes of this script (``--ag_rank``) time-share the
    card, shard k of the all-gather partition on rank k (``ag_rank``).
    Rank 0's gathered bf16 logits against the stacked route's on the same
    partition and weights: bit for bit (the reduce-scatter sums the ranks'
    blocks in rank order, as the stacked route sums its shards), else
    within RANK_LOGIT_TOL, and the line says which; the fp32 step's weights
    against the stacked all-gather step's (``step_states``): bit for bit,
    else each tensor's update within UPDATE_RTOL. Each rank's launches
    exact: a forward AG_RANK_CONV a conv, 2 convs; a step's input cache
    one conv's and the step the hidden conv's forward and backward; no K1
    in either form and no gather."""
    g = bench_graph(seed + 1500)
    model = build_model(bf16_arch(ARCH),
                        generator=torch.Generator().manual_seed(seed))
    model = model.to("cuda").eval()
    with torch.inference_mode():
        lc, lv = edge_partition.dist_apply(model, dg, mesh)
    stacked = torch.cat([lc[:g.ncons], lv[:g.nvars]]).cpu().numpy()
    del model, lc, lv
    w0 = seeded_state(ARCH_NO_DROPOUT, seed)
    step = step_states(ARCH_NO_DROPOUT, w0, bench_graph(seed + 1100),
                       ("dist",), halo=False)["dist"]
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="lp_gnn_smoke_agrank_") as tmp:
        payload = osp.join(tmp, "payload.json")
        with open(payload, "w") as f:
            json.dump({"seed": seed, "dir": tmp}, f)
        script = osp.abspath(__file__)
        _, wall, groups = run_ranks(
            "all_gather", lambda r: [script, "--ag_rank", payload], AG_RANKS)
        reports = []
        for r in range(AG_RANKS):
            with open(osp.join(tmp, f"ag_report{r}.json")) as f:
                reports.append(json.load(f))
        got = np.load(osp.join(tmp, "ag_rank_logits.npy"))
        state = torch.load(osp.join(tmp, "ag_rank_step.pth"))
    fwd = add_launches(scaled(AG_RANK_CONV, 2))
    cache = add_launches(AG_RANK_CONV)
    per_step = add_launches(scaled(AG_RANK_CONV, 2))
    bad = [r for r, rep in enumerate(reports)
           if rep["forward_launches"] != fwd
           or rep["step"]["cache_launches"] != cache
           or rep["step"]["launches"] != per_step]
    logits_equal = bool(np.array_equal(got, stacked))
    err = float(np.abs(got - stacked).max())
    rtol, atol = RANK_LOGIT_TOL
    state_equal = all(torch.equal(state[n], step["state"][n]) for n in w0)
    rels = update_rels(w0, state, step["state"], UPDATE_LR)
    if bad or not (logits_equal or np.all(
            np.abs(got - stacked) <= atol + rtol * np.abs(stacked))) or \
            max(rels.values()) > UPDATE_RTOL:
        raise SmokeFailure(
            f"all_gather ranks: launches off on ranks {bad} "
            f"({[rep['forward_launches'] for rep in reports]}, expected "
            f"{fwd}; step {cache} + {per_step}); logits max |err| {err}; "
            f"update rels {max(rels.values())}")
    return {
        "ranks": AG_RANKS, "process_groups": groups, "wall_s": wall,
        "logits_bit_for_bit": logits_equal, "logits_max_abs_err": err,
        "logits_tol_if_not_bit_for_bit": {"rtol": rtol, "atol": atol},
        "step_bit_for_bit": state_equal,
        "step_update_rel_max": max(rels.values()),
        "step_loss_rank0": reports[0]["step"]["loss"],
        "step_loss_stacked": step["loss"],
        "launches_forward": fwd, "launches_cache": cache,
        "launches_step": per_step,
        "forward_device_ms": [rep["forward_device_ms"] for rep in reports],
        "step_device_ms": [rep["step"]["step_device_ms"] for rep in reports],
        "max_memory_allocated_bytes": [
            rep["step"]["max_memory_allocated_bytes"] for rep in reports],
        "collectives": [rep["collectives"] for rep in reports],
        "backend": reports[0]["backend"],
        "transport": "gloo on host copies: the all-gather an all_gather of "
                     "(ns, D) rows, the reduce-scatter an all_to_all_single "
                     "of the (n_pad, D) partials and the sum of the K "
                     "received blocks in rank order on the card",
        "note": f"{AG_RANKS} ranks time-share one card: no figure here "
                f"stands for {AG_RANKS} cards"}


def all_gather_phase(seed: int) -> dict:
    """The all-gather branch (queue item 7d) at the bench shape, K=4, all
    shards on the card; then over AG_RANKS gloo ranks sharing it.

    First the checks, which hold the all-gather route against the halo
    route and the single card and so launch their kernels too (their
    launches stand under ``checks_launches``): GCN_FC(8,8,hids=1024,
    depth=3)'s logits against both (``ag_logits_held``); the halo route's
    figures (``route_figures``); the stacked reduce-scatter's and K1's ms
    at the recipe's width; one fp32 step held per tensor to the single
    card's by the DIST_UPDATE_SPREAD rule with its fp64 witness
    (``dist_vs_single_step``); GENDeeper(8,8,hids=256,depth=5)'s logits
    against both routes, and one fp32 step within UPDATE_RTOL a tensor of
    the single card's.

    Then the path itself, the all-gather route's own runs, with the launch
    counts set to 0 just before them and read just after (``launches``,
    exact, no K1 and no gather): GCN_FC's and GENDeeper's forwards and
    steps with their spans and peak memory (``route_figures``). Last the
    rank form (``all_gather_ranks``), whose ranks count their launches in
    their own processes."""
    g = bench_graph(seed + 1500)
    mesh = make_mesh(K_EDGE, "cuda")
    t0 = time.perf_counter()
    dg_ag = edge_partition.partition_graph(g, K_EDGE)
    t1 = time.perf_counter()
    dg_h = edge_partition.partition_graph(g, K_EDGE, halo=True)
    t2 = time.perf_counter()
    g_gen = bench_graph(seed + 1400)
    dg_gen_ag, dg_gen_h = (edge_partition.partition_graph(
        g_gen, K_EDGE, halo=halo) for halo in (False, True))
    out = {"K": K_EDGE, "ms": dg_ag.ms, "ns": dg_ag.ns, "n_pad": dg_ag.n_pad,
           "Bh": dg_h.bh, "edges_per_shard": dg_ag.nnz_s.tolist(),
           "partition_s": {"all_gather": t1 - t0, "halo": t2 - t1}}
    reset_launches()
    out["gcn_fc_logits"] = ag_logits_held(ARCH, seed, g, dg_ag, dg_h, mesh)
    halo_route = route_figures(seed, dg_h, mesh)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    parts = torch.randn(K_EDGE, dg_ag.n_pad, 1024, generator=gen,
                        device="cuda").bfloat16()
    out["reduce_scatter_ms"] = time_ms(
        lambda: edge_partition.reduce_scatter_vars(parts), 10)
    del parts
    bufs = torch.randn(K_EDGE, dg_h.nh, 1024, generator=gen,
                       device="cuda").bfloat16()
    out["halo_k1_ms"] = time_ms(lambda: halo_all_to_all(bufs), 10)
    del bufs
    torch.cuda.empty_cache()
    out["gcn_fc_step"] = dist_vs_single_step(
        seed, ARCH_NO_DROPOUT, bench_graph(seed + 1100), fp64_witness=True,
        halo=False)
    torch.cuda.empty_cache()
    out["gen_logits"] = ag_logits_held(DIST_GEN_ARCH, seed, g_gen, dg_gen_ag,
                                       dg_gen_h, mesh)
    torch.cuda.empty_cache()
    out["gen_step"] = dist_vs_single_step(seed, DIST_GEN_ARCH, g_gen,
                                          halo=False)
    torch.cuda.empty_cache()
    out["checks_launches"] = card_launches()

    reset_launches()
    routes = (route_figures(seed, dg_ag, mesh),
              route_figures(seed, dg_gen_ag, mesh, DIST_GEN_ARCH))
    out["launches"] = card_launches()
    want = add_launches(*(r["launches"] for r in routes))
    if out["launches"] != want:
        raise SmokeFailure(f"all_gather path: launches {out['launches']}, "
                           f"expected {want}")
    out["routes"] = {"all-gather": routes[0], "halo": halo_route}
    out["gen_route"] = routes[1]
    torch.cuda.empty_cache()
    out["ranks"] = all_gather_ranks(seed, dg_ag, mesh)
    return out


# ------------------------------------------------------------------ bench
BENCH_STEPS = 25            # (2 warm-up + 3 timed calls) x 5 steps a call
SCALING_ARGS = ["--devices", str(K_EDGE)]
# the banded graph's halo wire volume by shard count, the JAX script's
# (scripts/make_scaling_artifact.py wire_volume; tests/test_torch_scripts_
# twins.py holds the twin and this table to it)
SCALING_WIRE_VOLUME = {
    "2": {"halo_rows_per_shard_layer": 96,
          "allgather_rows_per_shard_layer": 8192, "ratio": 0.0117},
    "4": {"halo_rows_per_shard_layer": 192,
          "allgather_rows_per_shard_layer": 8192, "ratio": 0.0234},
    "8": {"halo_rows_per_shard_layer": 384,
          "allgather_rows_per_shard_layer": 8192, "ratio": 0.0469}}


def twin_line(module: str, argv: list[str], env: dict) -> tuple[dict, dict]:
    """``python -m module argv`` in this process with ``env`` set (the
    launch counts set to 0 just before and read just after), its one JSON
    line, printed here too, and its launches on the card."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    buf = io.StringIO()
    reset_launches()
    try:
        with contextlib.redirect_stdout(buf):
            run_module(module, argv)
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v
    launches = card_launches()
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()
             if ln.startswith("{")]
    if len(lines) != 1:
        raise SmokeFailure(f"{module} {argv}: {len(lines)} JSON lines")
    emit(lines[0])
    return lines[0], launches


def bench_phase(seed: int) -> dict:
    """The benchmark twins through their entry points:
    ``lp_gnn_tpu_torch.bench`` at its defaults and with
    ``BENCH_MEASURE_BASELINE=1``, ``lp_gnn_tpu_torch.bench_scaling
    --devices 4`` with and without ``--halo``. Holds: the flagship's 6
    traversals a step and edge against its launches (2 SpMMs for the input
    cache, then 4 a step on the card: BENCH_STEPS steps, captured or
    eager), ``value`` = E * 6 / min(step time), the baseline measured live
    (its SpMM the plain version: no launch), every step loss finite;
    ``bench_scaling``'s launches at 1, 2 and 4 shards (all-gather: 2d
    SpMMs for the cache and 4d a step; halo: 5d, a K1 and a gather for the
    cache, 10d, 2 K1 and 2 gathers a step; 1 warm-up + 3 timed steps).
    The graph is the repo's own (``bench.make_graph``, seed 0)."""
    from lp_gnn_tpu_torch import bench as port_bench
    out = {}
    flagship = add_launches({"spmm_csr": 2},
                            scaled({"spmm_csr": 4}, BENCH_STEPS))
    for name, env in (("bench", {"BENCH_MEASURE_BASELINE": ""}),
                      ("bench_baseline", {"BENCH_MEASURE_BASELINE": "1"})):
        line, launches = twin_line("lp_gnn_tpu_torch.bench", [], env)
        value = port_bench.SPMM_PER_EDGE * E / min(line["step_s"])
        measured = name == "bench_baseline"
        if launches != flagship or \
                abs(line["value"] - value) > 1e-9 * value or \
                not np.isfinite(line["losses"]).all() or \
                port_bench.SPMM_PER_EDGE != 2 + 4 or \
                (line["baseline_source"] == "measured") != measured or \
                (line["vs_baseline"] is None) == measured:
            raise SmokeFailure(f"{name}: launches {launches} (expected "
                               f"{flagship}), line {json.dumps(line)}")
        out[name] = {"line": line, "launches": launches}
    steps = 4   # 1 warm-up + 3 timed
    ds = [1, 2, K_EDGE]
    want = {
        "all_gather": add_launches({"spmm_csr": sum(
            2 * d + steps * 4 * d for d in ds)}),
        "halo": add_launches({"spmm_csr": sum(
            5 * d + steps * 10 * d for d in ds),
            "halo_all_to_all": len(ds) * (1 + 2 * steps),
            "gather_rows": len(ds) * (1 + 2 * steps)})}
    for name, argv in (("all_gather", SCALING_ARGS),
                       ("halo", SCALING_ARGS + ["--halo"])):
        line, launches = twin_line("lp_gnn_tpu_torch.bench_scaling", argv,
                                   {})
        losses = [v for vs in line["losses"].values() for v in vs]
        if launches != want[name] or line["mode"] != "one-card" or \
                line["collectives"] != name.replace("_", "-") or \
                set(line["step_time_s"]) != {str(d) for d in ds} or \
                not np.isfinite(losses).all():
            raise SmokeFailure(f"bench_scaling {name}: launches {launches} "
                               f"(expected {want[name]}), line "
                               f"{json.dumps(line)}")
        out[f"scaling_{name}"] = {"line": line, "launches": launches}
    out["launches"] = add_launches(*(r["launches"] for r in out.values()))
    return out


# ------------------------------------------------------------------ native
# one of the sweep's three default managers (the blend: run_train_test
# has just run InferenceManager(0,)), and no 10M-edge partition cell, for
# the phase's time (PERF.md, the native phase)
NATIVE_MANAGERS = ["InferenceManager(2,mode='add',gnn_wei=0.5)"]
# the first third of the pipeline phase's LPs (7 train, 3 val): the
# phase's prep and engine table are serial solves, and the script passed
# 1000 s with all 40, and again with 15 once edge_hosts came (PERF.md)
N_NATIVE_LPS = N_PIPE_LPS // 3
# about as many steps as the pipeline phase's run (its 21 train LPs x 20
# epochs): fewer leave the bases worse and the warm solves slow (call 3)
NATIVE_EPOCHS = PIPE_EPOCHS * N_PIPE_LPS // N_NATIVE_LPS
N_DEGEN_LPS = 4
# bench_partition: 1M edges at 2 and 8 shards with the per-pair width and
# the cache
PARTITION_RUNS = (["--edges", "1000000", "--shards", "2", "8", "--naive"],)
ENGINE_OBJ_TOL = 1e-6   # native vs HiGHS objectives, rtol and atol


def host_cpu() -> str:
    """The host CPU as ``lscpu`` names it (the solves run there): its model
    name, or where that is "unknown" its vendor, family and model
    numbers; and the CPU count."""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    f = dict(ln.split(":", 1) for ln in out.splitlines() if ":" in ln)
    f = {k.strip(): v.strip() for k, v in f.items()}
    name = f.get("Model name", "unknown")
    if name == "unknown":
        name = (f"{f.get('Vendor ID', '?')} family {f.get('CPU family', '?')}"
                f" model {f.get('Model', '?')}")
    return f"{name}, {f.get('CPU(s)', '?')} CPUs"


def native_logs(folder: str, n: int) -> dict:
    """``n`` native logs in ``folder``, each Optimal (no rejected basis)
    with its ``Rank_deficiency`` and ``time elapsed for factorize:``
    lines; returns each log's (iterations, repairs, seconds)."""
    logs = sorted(f for f in os.listdir(folder) if f.endswith(".log"))
    out, bad = {}, []
    for f in logs:
        with open(osp.join(folder, f)) as fh:
            text = fh.read()
        rep = [ln for ln in text.splitlines() if ln.startswith("Rank_deficiency ")]
        if "tpulp native" not in text or len(rep) != 1 or \
                "time elapsed for factorize: " not in text or \
                extract_time(osp.join(folder, f))[0] < 0:
            bad.append(f)
            continue
        niter, secs = extract_time(osp.join(folder, f))
        out[f[:-len(".log")]] = (niter, int(rep[0].split()[1]), secs)
    if len(logs) != n or bad:
        raise SmokeFailure(f"{folder}: {len(logs)} logs of {n}, not native, "
                           f"not Optimal or without the repair and factorize "
                           f"lines: {bad}")
    return out


def native_phase(seed: int, keep: str | None = None) -> dict:
    """The native C++ simplex engine on the flagship pipeline, through the
    entry points in this process. The library is built from the port's
    sources (``solver/native/tpulp.cc``, g++, timed); ``run_prep_data
    --engine native`` cold-solves N_NATIVE_LPS of the pipeline phase's
    mirp_bench LPs (the first of its MPS files in ``keep``, generated
    where there are none), one worker process a CPU up to 8;
    ``run_train_test --engine native`` trains GCN_FC(8,8,hids=1024,depth=3)
    bf16 for NATIVE_EPOCHS, calibrates the warm gate (``--warm_gate
    auto``), warm-starts and reports; then the twins:
    ``engine_table`` (both engines cold and warm on the val LPs),
    ``decode_sweep`` over the run's ``mdl.pth`` with NATIVE_MANAGERS,
    ``degeneracy_probe`` on the first N_DEGEN_LPS LPs and
    ``bench_partition`` (PARTITION_RUNS). Holds: every cold solve Optimal
    with a valid ``.bas``; every log native, with its repair and factorize
    lines, and the results table's ``repair_p``, ``repair_p2`` and
    ``fact_time`` on every val LP; k in [5, 12]; native and HiGHS objectives
    within ENGINE_OBJ_TOL on every val LP, cold and warm, no failed solve;
    each manager's basis folders complete and valid; the degeneracy
    fractions in [0, 1]; the per-pair halo width the fast one; and
    ``spmm_csr`` launched exactly as the design counts (counted from 0 just
    before run_train_test and read after the last twin: the pipeline
    phase's formula, then 4 a forward of each manager's prediction,
    calibration and timing passes), no other kernel."""
    import lp_gnn_tpu_torch
    from lp_gnn_tpu_torch.infer.decode import parse_inference_manager
    from lp_gnn_tpu_torch.solver import _cxx_build, native
    from lp_gnn_tpu_torch.utils.misc import split_idxs_train_val
    t_phase = time.perf_counter()
    n_lps, epochs = N_NATIVE_LPS, NATIVE_EPOCHS
    n_train, n_val = map(len, split_idxs_train_val(n_lps))
    workers = min(8, os.cpu_count() or 1)
    existed = _cxx_build.output_path("libtpulp").exists()
    t0 = time.perf_counter()
    lib = native.build()
    build_s = time.perf_counter() - t0
    if osp.dirname(lib) != osp.join(osp.dirname(lp_gnn_tpu_torch.__file__),
                                    "_build") or not native.available():
        raise SmokeFailure(f"native library {lib} not from the port's build")
    stages: dict = {}
    with tempfile.TemporaryDirectory(prefix="lp_gnn_smoke_native_") as tmp:
        data_prefix = osp.join(tmp, "lp-dataset")
        ds = osp.join(data_prefix, "mirp_bench")
        common = ["--dataset", "mirp_bench", "--data_prefix", data_prefix,
                  "--seed", str(seed), "--engine", "native"]
        prep_argv = [*common, "--num_workers", str(workers)]
        kept = osp.join(keep, "mirp_bench", "mps") if keep else ""
        if kept and osp.isdir(kept):
            os.makedirs(osp.join(ds, "mps"))
            for f in sorted(os.listdir(kept))[:n_lps]:
                shutil.copy(osp.join(kept, f), osp.join(ds, "mps", f))
        else:
            prep_argv += ["--family", "mirp_like", "--size", "bench",
                          "--n_instances", str(n_lps)]
        real_prep = time_stages(stages, port_prep, (
            "stage_generate", "stage_run_solver", "stage_cvt_to_pkl",
            "stage_process"))
        try:
            t_prep = run_module("lp_gnn_tpu_torch.run_prep_data", prep_argv)
        finally:
            for n, f in real_prep.items():
                setattr(port_prep, n, f)
        counts = {sub: len(os.listdir(osp.join(ds, sub))) for sub in (
            "mps", "highs-basis", "log/highs-no-bas", "log/highs-ca-bas-m1",
            "highs-inp_tgt/raw")}
        if set(counts.values()) != {n_lps}:
            raise SmokeFailure(f"native prep wrote {counts}, expected "
                               f"{n_lps} each")
        cold = native_logs(osp.join(ds, "log", "highs-no-bas"), n_lps)
        crash = native_logs(osp.join(ds, "log", "highs-ca-bas-m1"), n_lps)
        bas_dir = osp.join(ds, "highs-basis")
        invalid = [f for f in sorted(os.listdir(bas_dir))
                   if not valid_basis(osp.join(bas_dir, f))[0]]
        if invalid:
            raise SmokeFailure(f"cold bases not valid: {invalid}")

        log_prefix = osp.join(tmp, "runs")
        run = osp.join(log_prefix, "native")
        run_argv = [*common, "--log_prefix", log_prefix, "--exp_nm",
                    "native", "--arch", ARCH, "--fp16", "1", "--warm_gate",
                    "auto"]
        gates: list = []
        real_pipe = time_stages(stages, port_pipeline, (
            "stage_train", "calibrate_warm_gate", "stage_warm_start",
            "stage_val", "stage_extract"))
        timed_gate = port_pipeline.calibrate_warm_gate

        def recorded_gate(*a, **kw):
            gates.append(timed_gate(*a, **kw))
            return gates[-1]

        port_pipeline.calibrate_warm_gate = recorded_gate
        reset_launches()
        try:
            t_run = run_module("lp_gnn_tpu_torch.run_train_test", [
                *run_argv, "--loss", "balanced", "--epochs", str(epochs)])
            run_stages = dict(stages)
            warm = native_logs(osp.join(run, "log", "gnn-bas-0"), n_val)
            rows = [r for r in json_load(osp.join(run, "time.json"))
                    if r.get("split") == "val"]
            cols = ("gnn-bas-0/repair_p", "gnn-bas-0/repair_p2",
                    "gnn-bas-0/fact_time", "gnn-bas-0/niter",
                    "gnn-bas-0/impr_niter", "highs-no-bas/niter")
            missing = [(r["fn"], c) for r in rows for c in cols
                       if r.get(c) is None or ("impr" not in c and r[c] < 0)]
            if len(rows) != n_val or missing:
                raise SmokeFailure(f"results table: {len(rows)} val rows, "
                                   f"missing {missing}")
            et, et_lines, t_et = call_main("lp_gnn_tpu_torch.engine_table", [
                *common, "--log_prefix", log_prefix, "--exp_nm", "native"])
            (_, sweep_summary), _, t_sweep = call_main(
                "lp_gnn_tpu_torch.decode_sweep", [
                    *run_argv, "--load_from", osp.join(run, "mdl.pth"),
                    "--managers", *NATIVE_MANAGERS])
            folders = {}
            for i, mng in enumerate(NATIVE_MANAGERS):
                im = parse_inference_manager(mng, "mirp_bench")
                b = im.get_basis_folder()
                for sub in (b, f"opt-from-{b}"):
                    fs = sorted(f for f in os.listdir(osp.join(run, sub))
                                if f.endswith(".bas"))
                    bad = [f for f in fs
                           if not valid_basis(osp.join(run, sub, f))[0]]
                    if len(fs) != n_val or bad:
                        raise SmokeFailure(f"{mng}: {sub} holds {len(fs)} "
                                           f"bases of {n_val}, invalid {bad}")
                logs = native_logs(osp.join(run, "log", im.get_log_folder()),
                                   n_val)
                folders[mng] = {
                    "folder": b, "gate": {key: gates[1 + i][key]
                                          for key in ("proceed", "k",
                                                      "mean_impr")},
                    "warm_niter_mean": float(np.mean(
                        [v[0] for v in logs.values()])),
                    "repairs_mean": float(np.mean(
                        [v[1] for v in logs.values()]))}
            (degen, degen_summary), _, t_degen = call_main(
                "lp_gnn_tpu_torch.degeneracy_probe", [
                    "--dataset", "mirp_bench", "--data_prefix", data_prefix,
                    "--n", str(N_DEGEN_LPS)])
            cells, t_part = [], 0.0
            for argv in PARTITION_RUNS:
                try:
                    c, _, t = call_main("lp_gnn_tpu_torch.bench_partition", [
                        *argv, "--cache_dir", osp.join(tmp, "part")])
                except RuntimeError as ex:   # the widths disagree
                    raise SmokeFailure(f"bench_partition {argv}: {ex}")
                cells += c
                t_part += t
        finally:
            for n, f in real_pipe.items():
                setattr(port_pipeline, n, f)
        launches = card_launches()
    # the run's gate, then one a manager
    ks = [g["k"] for g in gates]
    want = (2 * n_train + SPMM_PER_STEP * n_train * epochs
            + SPMM_PER_FORWARD * (n_val + ks[0] + 4 * n_val + 2 * n_val)
            + sum(SPMM_PER_FORWARD * (n_val + k + 4 * n_val) for k in ks[1:]))
    formula = (f"2 x {n_train} + 4 x {n_train} x {epochs} + 4 x (7 x {n_val}"
               f" + {ks[0]}) + sum over the {len(ks) - 1} managers of 4 x "
               f"(5 x {n_val} + k) with k = {ks[1:]}")
    if len(ks) != 1 + len(NATIVE_MANAGERS) or launches != {
            **no_launches(), "spmm_csr": want}:
        raise SmokeFailure(f"native launches {launches}, expected spmm_csr "
                           f"{want} = {formula} and no other")
    if not all(5 <= k <= 12 for k in ks):
        raise SmokeFailure(f"warm gates calibrated on {ks} LPs")
    engines = et["engines"]
    if set(engines) != {"highs", "native"} or any(
            r.get("failed") != 0 or r.get("n") != n_val
            for r in engines.values()):
        raise SmokeFailure(f"engine table {json.dumps(engines)}")
    obj_off = []
    for h, nt in zip(et["lps"]["highs"], et["lps"]["native"]):
        for key in ("cold_obj", "warm_obj"):
            if not np.isclose(nt[key], h[key], rtol=ENGINE_OBJ_TOL,
                              atol=ENGINE_OBJ_TOL):
                obj_off.append((h["fn"], key, nt[key], h[key]))
    if obj_off:
        raise SmokeFailure(f"native vs HiGHS objectives: {obj_off}")
    fracs = ("zero_rc_frac", "degen_basic_frac", "seed_disagree_frac")
    bad = [r for r in degen if r.get("status") != "Optimal" or any(
        not 0.0 <= r[k] <= 1.0 for k in fracs
        if not (k == "seed_disagree_frac" and not r["seed_obj_equal"]))]
    if len(degen) != N_DEGEN_LPS or bad:
        raise SmokeFailure(f"degeneracy probe: {degen}")
    if len(cells) != 2 or not all("halo_width_naive_s" in c and
                                  "cache_load_s" in c for c in cells):
        raise SmokeFailure(f"bench_partition cells {cells}")
    return {
        "engine": "native", "library": osp.basename(lib),
        "built_here": not existed, "build_s": build_s, "cpu": host_cpu(),
        "machine": machine_probe(), "lps": n_lps, "val_lps": n_val,
        "workers": workers, "epochs": epochs,
        "cold_niter": [v[0] for v in cold.values()],
        "cold_s": [v[2] for v in cold.values()],
        "cold_repairs": sum(v[1] for v in cold.values()),
        "crash_niter": [v[0] for v in crash.values()],
        "crash_s": [v[2] for v in crash.values()],
        "gate": {key: gates[0][key] for key in (
            "proceed", "mean_impr", "ci90", "k", "failures")},
        "val_mean": {c: float(np.mean([r[c] for r in rows])) for c in cols},
        "warm_repairs": [v[1] for v in warm.values()],
        "engine_table": engines, "engine_lps": et["lps"],
        "engine_table_line": et_lines[0],
        "managers": folders,
        "sweep_val_mean": {m: sweep_summary.get("val", {}).get(
            f"{parse_inference_manager(m, 'mirp_bench').get_log_folder()}"
            "/impr_niter") for m in NATIVE_MANAGERS},
        "degeneracy": degen_summary, "degeneracy_lps": degen,
        "partition": cells, "launches": launches, "spmm_expected": want,
        "spmm_formula": formula,
        "stage_s": {"build": build_s, "prep": t_prep,
                    "cold_solves": stages.get("stage_run_solver"),
                    "cvt": stages.get("stage_cvt_to_pkl"),
                    "process": stages.get("stage_process"),
                    "run_train_test": t_run,
                    "train": run_stages.get("stage_train"),
                    "calibrate": run_stages.get("calibrate_warm_gate"),
                    "warm_start": run_stages.get("stage_warm_start"),
                    "val": run_stages.get("stage_val"),
                    "extract": run_stages.get("stage_extract"),
                    "engine_table": t_et, "decode_sweep": t_sweep,
                    "degeneracy_probe": t_degen, "bench_partition": t_part,
                    "phase": time.perf_counter() - t_phase}}


# ------------------------------------------------------------------ big
BIG_SAMPLE = 4096           # destination rows the full-size SpMM is held on
LONG_ROW = 256              # spmm.cu kLongRow: a longer row takes a whole CTA
PROBE_SHARE_MAX = 1.05      # above it a probe's time is a timing fault


def sample_rows(ptr: torch.Tensor, n: int, gen: torch.Generator) -> torch.Tensor:
    """At least ``n`` distinct destination rows of a CSR, sorted: its
    longest row, n/2 of the tenth of its rows with the most edges and n of
    all its rows."""
    deg = ptr[1:] - ptr[:-1]
    hot = torch.topk(deg, max(deg.numel() // 10, 1)).indices
    pick = [deg.argmax().view(1),
            hot[torch.randperm(hot.numel(), generator=gen,
                               device=ptr.device)[:n // 2]],
            torch.randperm(deg.numel(), generator=gen,
                           device=ptr.device)[:n]]
    return torch.unique(torch.cat(pick))


def rows_csr(ptr, idx, val, rows: torch.Tensor) -> tuple:
    """The CSR of ``rows`` alone: their pointers from 0, their edges."""
    start, cnt = ptr[rows].long(), (ptr[rows + 1] - ptr[rows]).long()
    sub = torch.zeros(rows.numel() + 1, dtype=torch.int64, device=ptr.device)
    torch.cumsum(cnt, 0, out=sub[1:])
    eid = torch.repeat_interleave(start - sub[:-1], cnt) + \
        torch.arange(int(sub[-1]), device=ptr.device)
    return sub.to(torch.int32), idx[eid], val[eid]


def exact_rows(ptr, idx, val, x) -> torch.Tensor:
    """The SpMM of a CSR, in ``x``'s dtype, from its sums in fp64. The
    plain version sums in fp32 in the order its atomics add (on the card a
    new order each call); over rows of about 1000 edges two orders can
    round to bf16 values 2 ulps apart, past SPMM_TOL, where the fp64 sums
    round the same whatever the order."""
    return spmm_csr_plain(ptr, idx, val.double(), x.double()).to(x.dtype)


def big_spmm_case(case: str, ptr, idx, val, x, gen) -> dict:
    """spmm_csr at bench_big's size against its plain version on a sample
    of destination rows (the plain version of the whole would hold an
    (E, D) message: 100 GB at 10^8 edges, D=256), its sums in fp64
    (``exact_rows``), with SPMM_TOL; its event
    ms and device ms a launch beside its bound, every input read once (x's
    rows that are used, once), and beside a reference cost that is no
    bound: one gathered row an edge, what a kernel pays where every edge's
    row misses L2. ``share_of_bound`` is the device ms's (profiled up to
    three times; null where the profiler never saw every launch)."""
    out = spmm_csr(ptr, idx, val, x)
    rows = sample_rows(ptr, BIG_SAMPLE, gen)
    sp, si, sv = rows_csr(ptr, idx, val, rows)
    ref = exact_rows(sp, si, sv, x)
    rtol, atol = SPMM_TOL[x.dtype]
    err, ok = within(out[rows.long()], ref, rtol, atol)
    if not ok:
        raise SmokeFailure(f"big spmm_csr {case}: max |err| {err} on "
                           f"{rows.numel()} sampled rows beyond rtol={rtol}, "
                           f"atol={atol}")
    del out, ref
    deg = (ptr[1:] - ptr[:-1]).long()
    n_dst, n_e, d, b = deg.numel(), idx.numel(), x.shape[1], x.element_size()
    s_used = int(torch.unique(idx).numel())
    read_once = (n_dst + 1) * 4 + n_e * 8 + s_used * d * b + n_dst * d * b
    miss_every_edge = (n_dst + 1) * 4 + n_e * 8 + n_e * d * b + n_dst * d * b
    long_rows = deg > LONG_ROW

    def call():
        return spmm_csr(ptr, idx, val, x)

    ms, device_ms = time_ms(call, 5), None
    for _ in range(3):
        device_ms = kernel_device_ms(call, "spmm_csr_kernel")
        if device_ms is not None:
            break
    bound_ms = read_once / HBM_BYTES_S * 1e3
    return {
        "case": case, "num_dst": n_dst, "num_src": x.shape[0], "nnz": n_e,
        "D": d, "dtype": str(x.dtype).split(".")[-1],
        "sample_rows": rows.numel(), "sample_edges": si.numel(),
        "longest_row": int(deg.max()), "mean_row": n_e / n_dst,
        "hot_tenth_least_row": int(torch.topk(deg, n_dst // 10).values.min()),
        "long_rows": int(long_rows.sum()),
        "long_row_edges": int(deg[long_rows].sum()),
        "slab_bytes_at_8_pieces": x.shape[0] * 16 * 8,
        "max_abs_err": err, "tol": {"rtol": rtol, "atol": atol},
        "ms": ms, "device_ms": device_ms,
        "bound_ms": bound_ms,
        "miss_every_edge_ms": miss_every_edge / HBM_BYTES_S * 1e3,
        "share_of_bound": bound_ms / device_ms if device_ms else None,
    }


def layout_gemms(seed: int) -> dict:
    """The recipe's forward (RECIPE_ARCH, seeded, eval) over K_EDGE shards
    stacked on cuda:0, on ``recipe_graph(seed, mirp)`` for both LPs, with
    cuBLAS's bf16 split-K partials summed in bf16 and in fp32
    (``allow_bf16_reduced_precision_reduction`` True, False): each of its
    GEMMs (``F.linear``) with every Linear over all stacked rows, against
    the same GEMM a shard's rows at a time (where they differ: the shape and
    how many outputs), and those logits against the port's forward, whose
    narrow Linears run a GEMM a shard (``models/layers.py shard_rows``) as
    a rank does: max |diff| and the rows past RANK_LOGIT_TOL."""
    from lp_gnn_tpu_torch.models import layers
    fl, matmul = torch.nn.functional.linear, torch.backends.cuda.matmul
    port_partials, narrow = matmul.allow_bf16_reduced_precision_reduction, \
        layers.NARROW
    seen = []

    def linear(x, w, b=None):
        out = fl(x, w, b)
        if x.dim() == 2 and x.shape[0] % K_EDGE == 0:
            shards = torch.cat([fl(c, w, b) for c in x.chunk(K_EDGE)])
            seen.append({"M": x.shape[0], "K": x.shape[1], "N": w.shape[0],
                         "differ": int((out != shards).sum()),
                         "of": out.numel()})
        return out

    def forward(g):
        model = build_model(RECIPE_ARCH)
        model.load_state_dict(seeded_state(RECIPE_ARCH, seed))
        model.dp = 0.0
        model = model.to("cuda").eval()
        with torch.no_grad():
            lc, lv = edge_partition.dist_apply(
                model, edge_partition.partition_graph(g, K_EDGE, halo=True),
                make_mesh(K_EDGE, "cuda"))
        return torch.cat([lc, lv]).float()

    out = {}
    try:
        for lp, mirp in (("mirp_bench", True), ("bench", False)):
            g = recipe_graph(seed, mirp)
            for partials in ("bf16", "fp32"):
                matmul.allow_bf16_reduced_precision_reduction = \
                    partials == "bf16"
                port = forward(g)
                seen.clear()
                layers.NARROW = 0
                torch.nn.functional.linear = linear
                try:
                    all_rows = forward(g)
                finally:
                    torch.nn.functional.linear = fl
                    layers.NARROW = narrow
                d = (all_rows - port).abs()
                past = (d > RANK_LOGIT_TOL[1]
                        + RANK_LOGIT_TOL[0] * port.abs()).any(1)
                out[f"{lp} {partials} partials"] = {
                    "gemms": len(seen),
                    "gemms_differing": [c for c in seen if c["differ"]],
                    "logits_all_rows_vs_port_max_abs": float(d.max()),
                    "rows_past_logit_tol": int(past.sum()),
                    "rows": port.shape[0]}
                torch.cuda.empty_cache()
    finally:
        matmul.allow_bf16_reduced_precision_reduction = port_partials
    return out


HOST_SORT_REPEATS = {"bench_big": 1, "mirp_bench": 21}


def host_sort(seed: int) -> dict:
    """``from_graph``'s orderings of one graph's edges both ways, in the
    branch it takes for that graph: bench_big's draws (in draw order: the
    row-major and the col-major order, ``np.lexsort`` of the two keys) and
    a mirp_bench LP (row-major, as ``LPDataset.get`` hands it out: the
    col-major order alone, a stable ``np.argsort``). Holds the two ways'
    permutations equal; each time is the median of HOST_SORT_REPEATS."""
    from lp_gnn_tpu_torch import bench, bench_big
    from lp_gnn_tpu_torch.data.graph import lex_order
    big = bench_big.parse_args([])
    cases = []
    for name, make in (
            ("bench_big", lambda: bench.make_graph(0, big.edges, big.cons,
                                                   big.vars)),
            ("mirp_bench", lambda: mirp_bench_graph(seed))):
        g = make()
        m, n = g.ncons, g.nvars
        row, col = g.row.astype(np.int64), g.col.astype(np.int64)
        dr = np.diff(row)
        row_major = bool(np.all((dr > 0) | ((dr == 0) & (np.diff(col) >= 0))))
        del g, dr
        if row_major:
            ways = {"numpy": lambda: (np.argsort(col, kind="stable"),),
                    "lex_order": lambda: (lex_order(col),)}
        else:
            ways = {"numpy": lambda: (np.lexsort((col, row)),
                                      np.lexsort((row, col))),
                    "lex_order": lambda: (lex_order(row, col, n),
                                          lex_order(col, row, m))}
        secs, perms = {}, {}
        for way, fn in ways.items():
            ts = []
            for _ in range(HOST_SORT_REPEATS[name]):
                t0 = time.perf_counter()
                perms[way] = fn()
                ts.append(time.perf_counter() - t0)
            secs[way] = float(np.median(ts))
        if not all(np.array_equal(a, b) for a, b in
                   zip(perms["numpy"], perms["lex_order"])):
            raise SmokeFailure(f"host_sort {name}: lex_order's permutation "
                               "is not numpy's")
        cases.append({"graph": name, "edges": int(row.size), "ncons": m,
                      "nvars": n, "row_major": row_major,
                      "sorts": len(perms["numpy"]),
                      "repeats": HOST_SORT_REPEATS[name],
                      "numpy_s": secs["numpy"],
                      "lex_order_s": secs["lex_order"],
                      "numpy_over_lex_order":
                          secs["numpy"] / secs["lex_order"]})
        del row, col, perms
    return {"cases": cases, "cpu": host_cpu(),
            "torch_threads": torch.get_num_threads()}


def big_phase(seed: int) -> dict:
    """``lp_gnn_tpu_torch.bench_big`` at its defaults (10^8 edges, GCN_FC
    hids=256 bf16, 3 warm-up + 2 timed steps) through its ``run``, which
    ``main`` prints: the launches over the run exactly (2 SpMMs for the
    input cache, 4 a step), finite losses, ``traversals_per_s`` = edges x 6
    / ``step_time_s``; then, on the graph the run built (the host build
    paid once), one v2c and one c2v ``spmm_csr`` at D=256 bf16 held to its
    plain version on BIG_SAMPLE or more rows (``big_spmm_case``; those
    launches counted apart)."""
    from lp_gnn_tpu_torch import bench_big
    args = bench_big.parse_args([])
    want = add_launches({"spmm_csr": 2 + SPMM_PER_STEP * (
        bench_big.WARMUP_STEPS + args.steps)})
    t0 = time.perf_counter()
    reset_launches()
    line, gt = bench_big.run(args, torch.device("cuda"))
    launches = card_launches()
    wall = time.perf_counter() - t0
    emit(line)
    tps = line["edges"] * bench_big.SPMM_PER_EDGE / line["step_time_s"]
    if launches != want or line["edges"] != args.edges or \
            not np.isfinite(line["losses"]).all() or \
            abs(line["traversals_per_s"] - tps) > 1e-9 * tps:
        raise SmokeFailure(f"bench_big: launches {launches} (expected "
                           f"{want}), line {json.dumps(line)}")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = []
    for case, ptr, idx, val, n_src in (
            ("v2c", gt.rowptr, gt.col, gt.val_r, gt.nvars),
            ("c2v", gt.colptr, gt.row, gt.val_c, gt.ncons)):
        x = torch.randn(n_src, args.hids, generator=gen,
                        device="cuda").to(torch.bfloat16)
        cases.append(big_spmm_case(case, ptr, idx, val, x, gen))
        del x
    del gt
    return {"line": line, "launches": launches, "spmm_expected": want,
            "spmm": cases, "wall_s": wall,
            "phase_s": time.perf_counter() - t0}


def probe_phase(module: str) -> dict:
    """A probe twin (``lp_gnn_tpu_torch.probe_spmm`` or
    ``.probe_gen_floor``) at its defaults through its entry point: every
    probe timed (ms > 0) and within PROBE_SHARE_MAX of its bound, and the
    port kernels launched exactly as the twin counts its calls."""
    t0 = time.perf_counter()
    line, launches = twin_line(module, [], {})
    want = add_launches(line["launches"])
    bad = [r for r in line["probes"] if not (
        r["ms"] > 0 and r["share_of_bound"] is not None
        and r["share_of_bound"] <= PROBE_SHARE_MAX)]
    if bad or launches != want or line["device"] == "cpu":
        raise SmokeFailure(f"{module}: probes off their bounds {bad}, "
                           f"launches {launches} (expected {want})")
    return {"line": line, "launches": launches,
            "phase_s": time.perf_counter() - t0}


# ----------------------------------------- one edge shard a rank, dp across
# The (dp=2, edge=2) grid of GRID_RANKS processes on the one card (gloo):
# rank (d, e) holds shard e of row d's graph. A rank's launches are those
# of the edge_ranks phase's ranks, RANK_CONV a conv: the input cache one
# conv, a GCN_FC step two (the hidden conv forward and backward).
GRID_DP, GRID_EDGE = 2, 2
GRID_RANKS = GRID_DP * GRID_EDGE
GRID_ARGS = ["--mesh_shape", f"dp={GRID_DP},edge={GRID_EDGE}",
             "--edge_num_thresh", "0"]
# --graph_batch 2 over edge=2 ranks: the two small train LPs (bench shape
# / 16, one pattern) one union a step, the twins above the threshold one
# dist step each over the ranks
GRID_BATCH_THRESH = 500_000
GRID_BATCH_LPS = 6          # train positions 1, 2 (twins), 3, 5 (small)


def rank_runs(name: str, ranks: int, tmp: str, runs: list[dict],
              ports: list[int] | None = None):
    """``ranks`` processes of this script (``--grid_rank``) running
    ``runs`` in turn, each in a process group of its own (``ports``: the
    launch's and each run's, free ones if None); returns each rank's
    reports by run name and the ranks' wall seconds and groups."""
    ports = ports or free_ports(1 + len(runs))
    for run, port in zip(runs, ports[1:]):
        run["coord"] = f"localhost:{port}"
    payload = osp.join(tmp, f"{name}.json")
    with open(payload, "w") as f:
        json.dump({"name": name, "dir": tmp, "runs": runs}, f)
    _, wall, groups = run_ranks(name, lambda rank: [
        osp.abspath(__file__), "--grid_rank", payload], ranks, ports[0])
    reports = []
    for r in range(ranks):
        with open(osp.join(tmp, f"{name}_rank{r}.json")) as f:
            reports.append(json.load(f))
    return reports, wall, groups


def dp_edge_grid(seed: int, ports: list[int] | None = None) -> dict:
    """One edge shard a rank with dp across: ``python -m
    lp_gnn_tpu_torch.train --mesh_shape dp=2,edge=2 --edge_num_thresh 0``
    over GRID_RANKS gloo ranks on the card, on the dp_edge phase's twins
    (one grid batch: row d takes twin d, rank (d, e) its shard e).
    Parity: one epoch of GCN_FC fp32 without dropout, SGD at UPDATE_LR;
    rank 0's ``mdl.pth`` held to the dp_edge phase's layout (dp=2 ranks
    each holding both shards of its twin) on the same twins and weights,
    by that phase's rule (each tensor's update within the larger of
    UPDATE_RTOL and DIST_UPDATE_SPREAD times that layout's spread against
    the fp64 witness, ``union_step_fp64``). Recipe: ARCH bf16, balanced
    CE, Adam, the arch's dropout, DP_EDGE_EPOCHS epochs: each rank's step
    spans, launches exactly one input cache and a dist step's a step (K1's
    rank form and the gather included, no stacked K1), equal finite
    losses on every rank, the gradient all-reduce's ms and wait, peak
    memory, wall; only rank 0 writes. At the same time (a launch of 2
    ranks beside the 4: each launch is mostly its processes' start, and
    the figures above are taken beside it) the layout and ``--mesh_shape
    edge=2 --graph_batch 2`` over 2 ranks: a union step of the two small
    LPs and a dist step of each twin, each rank's launches as counted. In
    every run each rank's final weights equal rank 0's byte for byte.
    ``ports``: the two launches' and their runs' (6), free ones if None."""
    t0 = time.perf_counter()
    lr = UPDATE_LR
    twins = twin_graphs(seed + 1200)
    s0, s1 = (bench_graph(seed + i, m=M // 16, n=N // 16, e=E // 16)
              for i in (1300, 1301))
    small = [s0, BipartiteGraph(row=s0.row, col=s0.col, val=s1.val,
                                c_feas=s1.c_feas, v_feas=s1.v_feas,
                                y_s=s1.y_s, y_t=s1.y_t)]   # one stack key
    parity = ["--arch", ARCH_NO_DROPOUT, "--opt", "sgd", "--lr", str(lr),
              "--epochs", "1", "--seed", str(seed)]
    recipe = ["--arch", ARCH, "--fp16", "1", "--loss", "balanced",
              "--seed", str(seed)]
    train = "lp_gnn_tpu_torch.train"
    with tempfile.TemporaryDirectory(prefix="lp_gnn_smoke_grid_") as tmp:
        data_prefix = osp.join(tmp, "data")
        write_dataset(osp.join(data_prefix, "smoke", "highs-inp_tgt"), 0, 4,
                      split_dataset(4, twins, seed))
        data = ["--dataset", "smoke", "--data_prefix", data_prefix]
        batch_prefix = osp.join(tmp, "batch_data")
        write_dataset(osp.join(batch_prefix, "smoke", "highs-inp_tgt"), 0,
                      GRID_BATCH_LPS,
                      split_dataset(GRID_BATCH_LPS, twins + small, seed))
        # both launches at once: each is mostly its processes' start
        ports = ports or free_ports(6)
        with ThreadPoolExecutor(2) as pool:
            grid_run = pool.submit(rank_runs, "grid", GRID_RANKS, tmp, [
                {"name": "parity", "module": train, "log": "parity",
                 "argv": [*data, "--exp_nm", "grid", *parity, *GRID_ARGS]},
                {"name": "recipe", "module": train, "log": "recipe",
                 "argv": [*data, "--exp_nm", "grid_recipe", *recipe,
                          "--epochs", str(DP_EDGE_EPOCHS), *GRID_ARGS]}],
                ports[:3])
            rows_run = pool.submit(rank_runs, "rows", GRID_DP, tmp, [
                {"name": "parity", "module": train, "log": "rows",
                 "argv": [*data, "--exp_nm", "rows", *parity, "--mesh_shape",
                          f"dp={GRID_DP},edge={GRID_EDGE}",
                          "--edge_num_thresh", "0"]},
                {"name": "batched", "module": train, "log": "batched",
                 "argv": ["--dataset", "smoke", "--data_prefix",
                          batch_prefix, "--exp_nm", "batched", *recipe,
                          "--epochs", "1", "--mesh_shape",
                          f"edge={GRID_EDGE}", "--graph_batch", "2",
                          "--edge_num_thresh", str(GRID_BATCH_THRESH)]}],
                ports[3:])
            grid, t_grid, groups = grid_run.result()
            rows, t_rows, groups_rows = rows_run.result()
        files = {run: [osp.exists(osp.join(tmp, f"{run}{r}"))
                       for r in range(n)]
                 for run, n in (("parity", GRID_RANKS),
                                ("recipe", GRID_RANKS), ("rows", GRID_DP),
                                ("batched", GRID_DP))}
        got = torch.load(osp.join(tmp, "parity0", "grid", "mdl.pth"),
                         weights_only=True)
        layout = torch.load(osp.join(tmp, "rows0", "rows", "mdl.pth"),
                            weights_only=True)
    if any(f != [True] + [False] * (len(f) - 1) for f in files.values()) \
            or not all("gloo" in g for g in groups + groups_rows) or \
            len(groups) != 2 * GRID_RANKS:
        raise SmokeFailure(f"dp_edge_grid: files by rank {files}, groups "
                           f"{groups} / {groups_rows}")
    # only rank 0 writes mdl.pth: every rank's final weights must be its
    digests = {f"{name}_{run}": [r[run]["weights_digest"] for r in reports]
               for name, reports, runs in (
                   ("grid", grid, ("parity", "recipe")),
                   ("rows", rows, ("parity", "batched")))
               for run in runs}
    if any(d[0] is None or len(set(d)) != 1 for d in digests.values()):
        raise SmokeFailure(f"dp_edge_grid: the ranks' final weights differ: "
                           f"{digests}")
    fp64 = union_step_fp64(seed, twins, lr)
    w0 = seeded_state(ARCH_NO_DROPOUT, seed)
    rels = update_rels(w0, got, layout, lr)
    spread = update_rels(w0, layout, fp64, lr)
    limits = {k: max(UPDATE_RTOL, DIST_UPDATE_SPREAD * spread[k])
              for k in rels}
    worst = max(rels, key=lambda k: rels[k] / limits[k])
    if rels[worst] > limits[worst]:
        raise SmokeFailure(f"dp_edge_grid vs dp_edge's layout: update rel "
                           f"diff {rels[worst]} in {worst} > "
                           f"{limits[worst]}: {json.dumps(rels)}")
    per_step = add_launches(scaled(RANK_CONV, 2))
    want = add_launches(RANK_CONV, scaled(per_step, DP_EDGE_EPOCHS))
    recipe_r = [r["recipe"] for r in grid]
    losses = [[st["loss"] for st in r["steps"]] for r in recipe_r]
    for r, rep in enumerate(recipe_r):
        kinds = {st["kind"] for st in rep["steps"]}
        if rep["launches"] != want or kinds != {"dp_edge_train_step"} or \
                len(rep["steps"]) != DP_EDGE_EPOCHS or \
                any(st["launches"] != per_step for st in rep["steps"]):
            raise SmokeFailure(
                f"dp_edge_grid recipe rank {r}: {len(rep['steps'])} steps "
                f"{kinds}, launches {rep['launches']} (expected {want}), a "
                f"step {[st['launches'] for st in rep['steps']]} (expected "
                f"{per_step})")
    if any(x != losses[0] for x in losses) or \
            not np.isfinite(losses[0]).all():
        raise SmokeFailure(f"dp_edge_grid recipe: losses {losses}")
    batch_r = [r["batched"] for r in rows]
    # a rank: the union of the two small LPs (2 SpMMs a graph's cache, 4
    # the step), each twin's cache and dist step (3 convs over the ranks)
    want_b = add_launches({"spmm_csr": 2 * 2 + SPMM_PER_STEP},
                          scaled(RANK_CONV, 2 * 3))
    for r, rep in enumerate(batch_r):
        kinds = sorted(st["kind"] for st in rep["steps"])
        if rep["launches"] != want_b or \
                kinds != ["dist_train_step"] * 2 + ["dp_train_step"] or \
                not np.isfinite([st["loss"] for st in rep["steps"]]).all():
            raise SmokeFailure(
                f"dp_edge_grid --graph_batch 2 rank {r}: steps {kinds}, "
                f"launches {rep['launches']} (expected {want_b})")
    if [st["loss"] for st in batch_r[0]["steps"]] != \
            [st["loss"] for st in batch_r[1]["steps"]]:
        raise SmokeFailure("dp_edge_grid --graph_batch 2: the ranks' losses "
                           "differ")
    return {"arch": bf16_arch(ARCH), "grid": [GRID_DP, GRID_EDGE],
            "ranks": GRID_RANKS, "groups": groups,
            "weights_digest": {k: d[0] for k, d in digests.items()},
            "parity": {"arch": ARCH_NO_DROPOUT, "dtype": "float32",
                       "lr": lr, "held_to": "dp_edge's layout: dp=2 ranks, "
                       "each both shards of its twin",
                       "step_losses": [st["loss"] for st in
                                       grid[0]["parity"]["steps"]],
                       "layout_step_losses": [st["loss"] for st in
                                              rows[0]["parity"]["steps"]],
                       "update_rels": rels,
                       "layout_vs_fp64_update_rels": spread,
                       "grid_vs_fp64_update_rels": update_rels(
                           w0, got, fp64, lr),
                       "spread_factor": DIST_UPDATE_SPREAD,
                       "nearest_limit": {"tensor": worst,
                                         "update_diff": rels[worst],
                                         "limit": limits[worst]}},
            "epochs": DP_EDGE_EPOCHS,
            "launches": add_launches(*(r["launches"] for r in recipe_r),
                                     *(r["launches"] for r in batch_r)),
            "launches_per_rank": want, "launches_per_step": per_step,
            "launch_formula": f"a grid rank: one conv's (RANK_CONV "
                              f"{RANK_CONV}) input cache + 2 convs a step x "
                              f"{DP_EDGE_EPOCHS} steps; a --graph_batch 2 "
                              f"rank {want_b}",
            "step_losses": losses[0],
            "step_device_ms": [[st["device_ms"] for st in r["steps"]]
                               for r in recipe_r],
            "allreduce_ms": [r["allreduce_ms"] for r in recipe_r],
            "allreduce_wait_ms": [r["allreduce_wait_ms"] for r in recipe_r],
            "max_memory_allocated_bytes": [r["max_memory_allocated_bytes"]
                                           for r in recipe_r],
            "partition_s": [r["partition_s"] for r in recipe_r],
            "rank_wall_s": [r["wall_s"] for r in recipe_r],
            "graph_batch": {
                "steps": [[st["kind"], st["loss"], st["device_ms"]]
                          for st in batch_r[0]["steps"]],
                "launches_per_rank": want_b,
                "rank_wall_s": [r["wall_s"] for r in batch_r]},
            "grid_ranks_s": t_grid, "rows_ranks_s": t_rows,
            "phase_s": time.perf_counter() - t0}


# ----------------------------------------------------------------- edge_hosts
# the host each rank of the phase reports (``mesh.host_key`` replaced in the
# rank before it joins): ranks 0-1 host A, 2-3 host B, a host a grid row
HOSTS = "AABB"
HOST_REPS = 3       # timed COLLECTIVE exchanges a width, after one untimed
HOST_WIDTHS = (1024, 8)


def forced_host_cards(rank: int) -> dict:
    """The environment of rank ``rank`` of the phase with a card a rank:
    each host sees its own two of the first four visible cards, as two
    hosts of two cards would (rank k on card k)."""
    vis = os.environ.get("CUDA_VISIBLE_DEVICES", "")
    cards = vis.split(",") if vis else \
        [str(i) for i in range(torch.cuda.device_count())]
    host = HOSTS.index(HOSTS[rank])
    return {"CUDA_VISIBLE_DEVICES": ",".join(cards[host:host + 2])}


def host_exchanges(seed: int, bh: int, dev: torch.device) -> list[dict]:
    """K1 over the world's group at the bench halo (K=4, Bh ``bh``) at
    D=1024 and D=8 bf16, through the route the placement gives it: every
    rank makes all K buffers on its card from one seed and holds its
    result to the stacked form's plain version, bit for bit; then
    HOST_REPS exchanges after a barrier, each synchronised (``ms``: the
    host's clock, which includes gloo's host copies) and between CUDA
    events on the stream (``device_ms``)."""
    k, me = torch.distributed.get_world_size(), torch.distributed.get_rank()
    rows = []
    for d in HOST_WIDTHS:
        gen = torch.Generator(device=dev).manual_seed(seed + d)
        bufs = torch.randn(k, k * bh, d, generator=gen, device=dev,
                           dtype=torch.bfloat16)
        want = halo_all_to_all_plain(bufs)[me]
        before = halo_all_to_all_ranks.collective_exchanges
        got = halo_all_to_all_ranks(bufs[me].contiguous())
        exact = torch.equal(got, want)
        ms, dev_ms = [], []
        for _ in range(HOST_REPS):
            torch.cuda.synchronize()
            torch.distributed.barrier()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            t0 = time.perf_counter()
            ev[0].record()
            got = halo_all_to_all_ranks(bufs[me].contiguous())
            ev[1].record()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            dev_ms.append(ev[0].elapsed_time(ev[1]))
            exact = exact and torch.equal(got, want)
        rows.append({"D": d, "Bh": bh, "K": k, "exact": exact,
                     "ms": ms, "device_ms": dev_ms,
                     "bytes_a_rank": bufs[me].nbytes,
                     "bytes_sent_a_rank": bufs[me].nbytes * (k - 1) // k,
                     "collective_exchanges":
                         halo_all_to_all_ranks.collective_exchanges - before,
                     "rank_launches": rank_launches()})
        del bufs, want, got
        torch.cuda.empty_cache()
    return rows


def host_grid_graphs(seed: int) -> list[BipartiteGraph]:
    """The grid step's batch: two LPs of the bench shape / 16, a dp row
    each."""
    return [bench_graph(seed + 1500 + i, m=M // 16, n=N // 16, e=E // 16)
            for i in range(2)]


def host_grid_step(seed: int, out_dir: str) -> dict:
    """One fp32 dp=2,edge=2 step on this rank's cell (ARCH_NO_DROPOUT from
    the seeded weights, SGD at UPDATE_LR, balanced CE, the input cache
    built first), twice from the same weights: each step's loss, launches
    and COLLECTIVE exchanges counted from 0 just before it, and the
    weights' digest; rank 0 writes the first step's weights."""
    from lp_gnn_tpu_torch.parallel import combined
    from lp_gnn_tpu_torch.parallel.dp import rank_block
    grid = mesh_mod.make_grid(2, 2)
    row = make_mesh(2, "cuda", grid.row, row=grid.d)
    parts = combined.partition_batch(host_grid_graphs(seed), 2, halo=True,
                                     own=rank_block([0, 1], 2, grid.d))
    w0 = seeded_state(ARCH_NO_DROPOUT, seed)
    runs = []
    for again in range(2):
        model = build_model(ARCH_NO_DROPOUT)
        model.load_state_dict(w0)
        model.dp = 0.0
        model = model.to("cuda").train()
        opt = trainer.make_optimizer(model.parameters(), "sgd", UPDATE_LR)
        dgs = [edge_partition.dist_tensors(model, dg, row, input_agg=True)
               for dg in parts]
        torch.cuda.synchronize()
        torch.distributed.barrier()
        reset_launches()
        loss = combined.dp_edge_train_step(model, opt, dgs,
                                           LOSS_REGISTRY["balanced"], None,
                                           grid)
        torch.cuda.synchronize()
        runs.append({"loss": float(loss), "launches": launch_counts(),
                     "collective_exchanges":
                         halo_all_to_all_ranks.collective_exchanges,
                     "weights_digest": weights_digest(model)})
        if again == 0 and torch.distributed.get_rank() == 0:
            torch.save({n: v.detach().cpu() for n, v in
                        model.state_dict().items()},
                       osp.join(out_dir, "host_grid_step.pth"))
        del model, opt, dgs
    ranks = torch.distributed.get_process_group_ranks(grid.row)
    return {"runs": runs, "route": mesh_mod.ROUTES[tuple(ranks)],
            "row": ranks}


def host_rank(payload_path: str) -> None:
    """One rank of the edge_hosts phase, in this process (``--host_rank``):
    it reports the payload's host for its rank (``mesh.host_key``
    replaced before every join) and runs, in a group of its own, the
    placement and the routes it gives, the COLLECTIVE exchange
    (``host_exchanges``), the recipe over edge=4 (``rank_recipe``) and the
    dp=2,edge=2 step (``host_grid_step``); then the pred_basis entry point
    (a group of its own), the launch counts and exchanges set to 0 just
    before it and read just after. With the payload's mode ``signalled``
    (every rank on one host) the exchange alone. Writes its report (and
    rank 0 its logits) into the payload's directory."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    with open(payload_path) as f:
        p = json.load(f)
    rank = int(os.environ["LP_GNN_DIST_PROC_ID"])
    mesh_mod.host_key = lambda: p["hosts"][rank]
    report = {}
    os.environ["LP_GNN_DIST_COORD"] = p["coords"][0]
    dev, created = mesh_mod.init_distributed(torch.device("cuda"))
    try:
        pl = mesh_mod.placement()
        rows = mesh_mod.grid_ranks(2, 2)[0]
        report["placement"] = {
            "backend": torch.distributed.get_backend(), "device": str(dev),
            "hosts": pl.hosts, "local": pl.local, "cards": pl.cards,
            "routes": {"edge=4": mesh_mod.rank_form(pl, range(len(pl.hosts))),
                       "rows": [mesh_mod.rank_form(pl, r) for r in rows]}}
        report["exchange"] = host_exchanges(p["seed"], p["bh"], dev)
        if p["mode"] == "hosts":
            torch.cuda.empty_cache()
            report["recipe"] = rank_recipe(p["seed"], p["dir"], p["mirp"])
            report["window_bytes"] = halo_mod.window_bytes()
            torch.cuda.empty_cache()
            report["grid"] = host_grid_step(p["seed"], p["dir"])
        report["routes_seen"] = [[list(r), v]
                                 for r, v in mesh_mod.ROUTES.items()]
    finally:
        mesh_mod.leave_distributed(created)
    if p["mode"] == "hosts":
        torch.cuda.empty_cache()
        os.environ["LP_GNN_DIST_COORD"] = p["coords"][1]
        reset_launches()
        with CaptureLogits() as cap, WindowPeak() as win:
            t = run_module("lp_gnn_tpu_torch.pred_basis",
                           [*p["serve"], "--log_prefix",
                            osp.join(p["dir"], f"serve{rank}")])
        report["serve"] = {"launches": launch_counts(), "wall_s": t,
                           "collective_exchanges":
                               halo_all_to_all_ranks.collective_exchanges,
                           "window_bytes": win.peak}
        if cap.logits:
            np.savez(osp.join(p["dir"], "host_logits.npz"), **cap.logits)
    with open(osp.join(p["dir"], f"{p['mode']}{rank}.json"), "w") as f:
        json.dump(report, f)


def host_runs(mode: str, tmp: str, payload: dict, env_of,
              ports: list[int] | None = None) -> tuple:
    """The phase's ranks in ``mode`` (``--host_rank``; ``ports``: the
    launch's and its two groups', free ones if None): their reports and
    wall seconds and their ``process group:`` lines."""
    ports = ports or free_ports(3)
    payload = dict(payload, mode=mode,
                   coords=[f"localhost:{q}" for q in ports[1:]])
    path = osp.join(tmp, f"{mode}.json")
    with open(path, "w") as f:
        json.dump(payload, f)
    _, wall, groups = run_ranks(f"edge_hosts {mode}", lambda rank: [
        osp.abspath(__file__), "--host_rank", path], len(payload["hosts"]),
        ports[0], env_of)
    reports = []
    for r in range(len(payload["hosts"])):
        with open(osp.join(tmp, f"{mode}{r}.json")) as f:
            reports.append(json.load(f))
    return reports, wall, groups


def host_grid_reference(seed: int) -> tuple[float, dict]:
    """The stacked layout's dp x edge step in this process on the grid
    step's batch (both LPs, each edge=2 shards stacked on cuda:0, the same
    weights and step): its loss and weights."""
    from lp_gnn_tpu_torch.parallel import combined
    model = build_model(ARCH_NO_DROPOUT)
    model.load_state_dict(seeded_state(ARCH_NO_DROPOUT, seed))
    model.dp = 0.0
    model = model.to("cuda").train()
    opt = trainer.make_optimizer(model.parameters(), "sgd", UPDATE_LR)
    dgs = [edge_partition.dist_tensors(model, dg, make_mesh(2, "cuda"),
                                       input_agg=True)
           for dg in combined.partition_batch(host_grid_graphs(seed), 2,
                                              halo=True)]
    loss = combined.dp_edge_train_step(model, opt, dgs,
                                       LOSS_REGISTRY["balanced"])
    return float(loss), {n: v.detach().cpu()
                         for n, v in model.state_dict().items()}


def edge_hosts_launch(seed: int, tmp: str, ranks_dir: str,
                      ports: list[int] | None = None) -> dict:
    """The ranks of ``edge_hosts`` in ``tmp`` (``ports``: the launch's and
    its groups', free ones if None); with 4 cards then the same cards as
    one host. With 4 cards the recipe runs on a bench LP and the serve on
    the bench LPs and checkpoint of ``stacked_serve_reference`` in
    ``ranks_dir``; on one card both on LPs of the pipeline's structure
    (``recipe_graph(seed, True)``, ``mirp_serve_graphs``), the serve's
    inputs written into ``tmp`` first (``serve_root``). Nothing else in
    this process: the full run starts it beside other phases' launches.
    Returns the reports, where the ranks wrote them, the launch's wall
    seconds and its ``process group:`` lines."""
    four = torch.cuda.device_count() >= 4
    mirp = not four
    serve_root = tmp if mirp else ranks_dir
    if mirp:
        serve_inputs(seed, serve_root, mirp_serve_graphs(seed))
    serve_argv = ["--dataset", "smoke", "--data_prefix",
                  osp.join(serve_root, "serve_data"), "--exp_nm", "smoke",
                  "--arch", ARCH, "--fp16", "1", "--load_from",
                  osp.join(serve_root, "mdl.pth"), "--split", "trainval",
                  "--warm_gate", "off", "--seed", str(seed), *RANK_ARGS]
    payload = {"dir": tmp, "seed": seed, "hosts": HOSTS, "serve": serve_argv,
               "mirp": mirp,
               "bh": edge_partition.compute_halo_width(bench_graph(seed), 4)}
    per_rank, wall, groups = host_runs(
        "hosts", tmp, payload, forced_host_cards if four else
        lambda rank: {}, ports)
    signalled = None
    if four:   # the same cards as one host: K1's signalled form
        signalled, _, _ = host_runs("signalled", tmp,
                                    dict(payload, hosts="HHHH"),
                                    lambda rank: {})
    return {"dir": tmp, "bh": payload["bh"], "per_rank": per_rank,
            "signalled": signalled, "wall": wall, "groups": groups,
            "mirp": mirp, "serve_root": serve_root}


def edge_hosts(seed: int, ranks_dir: str | None = None,
               stacked_inf: dict | None = None,
               launched: dict | None = None) -> dict:
    """Edge shards and the (dp, edge) grid over ranks on two hosts: four
    processes of this script (``--host_rank``), ranks 0-1 reporting host
    A and 2-3 host B (``mesh.host_key`` replaced in each rank: this machine
    is one host, so the cross-host route runs over its NVLink or its host
    copies, never over a network). With 4 cards rank k on card k (each
    host sees its own two), over NCCL, and the recipe and serve on bench
    LPs; on one card the ranks share it (gloo), and the recipe and serve
    run on LPs of the pipeline's structure (mirp_bench, at full width: a
    cut of the LPs' size, since gloo stages every cross-host exchange
    through host copies). Holds: the route table (edge=4
    over both hosts COLLECTIVE, a row a host the signalled form with 4
    cards or the flags form on one, the same on every rank, and no window
    for the COLLECTIVE group); the COLLECTIVE exchange at the bench halo
    (D=1024, D=8 bf16) bit for bit against the stacked form's plain
    version, timed beside, with 4 cards, the signalled form over the same
    cards as one host (a second launch of the ranks); the recipe's
    forward and fp32 step over edge=4 against the stacked path
    (``recipe_vs_stacked``: launches HOST_CONV a conv, no launch of K1,
    HOST_EXCHANGES_A_CONV exchanges a conv); one fp32 dp=2,edge=2 step,
    a row a host, against the stacked layout's step within dp_edge_grid's
    bound, bit for bit when repeated, launches exact (its rows' form of
    K1, no COLLECTIVE exchange); ``pred_basis --mesh_shape edge=4`` over
    both hosts on 2 LPs, its .bas equal to the stacked serve's byte for
    byte, its logits within RANK_LOGIT_TOL, its launches and exchanges
    exact. With 4 cards the serve's LPs, checkpoint and stacked serve are
    ``stacked_serve_reference``'s in ``ranks_dir`` (``edge_ranks``' where
    it kept them, ``stacked_inf`` their ``inf_time``), made here without
    it; on one card the launch writes the mirp_bench LPs and checkpoint and
    the stacked serve runs here after the ranks; ``launched``: ``edge_hosts_launch``'s result where the ranks ran
    already (its directory the caller's), else they run here."""
    t0 = time.perf_counter()
    four = torch.cuda.device_count() >= 4
    rows_form = halo_mod.SIGNALLED if four else halo_mod.FLAGS
    with tempfile.TemporaryDirectory(prefix="lp_gnn_smoke_hosts_") as tmp:
        ranks_dir = ranks_dir or tmp
        if four and not osp.exists(osp.join(ranks_dir, "stacked_logits.npz")):
            stacked_inf = stacked_serve_reference(seed, ranks_dir)[
                "inf_time_s"]
            torch.cuda.empty_cache()
        run = launched or edge_hosts_launch(seed, tmp, ranks_dir)
        mirp, serve_root = run["mirp"], run["serve_root"]
        shapes = ((M, N),)
        if mirp:   # the stacked serve of the LPs the ranks served
            graphs = mirp_serve_graphs(seed)
            shapes = tuple({(g.ncons, g.nvars) for g in graphs})
            stacked_inf = stacked_serve_reference(
                seed, serve_root, graphs, write=False)["inf_time_s"]
            torch.cuda.empty_cache()
        with np.load(osp.join(serve_root, "stacked_logits.npz")) as z:
            st_logits = {n: z[n] for n in z.files}
        per_rank, signalled = run["per_rank"], run["signalled"]
        wall, groups, bh, out_dir = (run["wall"], run["groups"], run["bh"],
                                     run["dir"])
        # the placement and the routes, the same on every rank
        backend = "nccl" if four else "gloo"
        table = {"edge=4": halo_mod.COLLECTIVE, "rows": [rows_form] * 2}
        world = list(range(len(HOSTS)))
        for r, rep in enumerate(per_rank):
            pl, seen = rep["placement"], dict(
                (tuple(k), v) for k, v in rep["routes_seen"])
            row = [0, 1] if r < 2 else [2, 3]
            bad = [pl["backend"] != backend, pl["routes"] != table,
                   list(pl["hosts"]) != list(HOSTS),
                   list(pl["local"]) != [0, 1, 0, 1],
                   seen != {tuple(world): halo_mod.COLLECTIVE,
                            tuple(row): rows_form},
                   rep["grid"]["route"] != rows_form,
                   rep["window_bytes"] != 0]
            if any(bad):
                raise SmokeFailure(f"edge_hosts rank {r}: placement {pl}, "
                                   f"routes taken {seen} (expected {table}, "
                                   f"backend {backend})")
        # the COLLECTIVE exchange
        for r, rep in enumerate(per_rank):
            for c in rep["exchange"]:
                n = c["collective_exchanges"]
                if not c["exact"] or n != 1 + HOST_REPS or \
                        c["rank_launches"] != 0:
                    raise SmokeFailure(f"edge_hosts rank {r}: the COLLECTIVE "
                                       f"exchange at D={c['D']}: exact "
                                       f"{c['exact']}, {n} exchanges, K1 "
                                       f"launches {c['rank_launches']}")
        if signalled is not None and not all(
                c["exact"] and rep["placement"]["routes"]["edge=4"] ==
                halo_mod.SIGNALLED
                for rep in signalled for c in rep["exchange"]):
            raise SmokeFailure(f"edge_hosts: the one-host signalled exchange "
                               f"{[rep['exchange'] for rep in signalled]}")
        recipe = recipe_vs_stacked(seed, out_dir, per_rank, mirp)
        rank_dir = osp.join(out_dir, "serve0", "smoke")
        n_bas = check_bases(osp.join(rank_dir, "pred-basis"), N_RANK_LPS,
                            shapes)
        inf = json_load(osp.join(rank_dir, "inf_time.json"))
        with np.load(osp.join(out_dir, "host_logits.npz")) as z:
            rank_logits = {n: z[n] for n in z.files}
        st_dir = osp.join(serve_root, "stacked", "smoke", "pred-basis")
        bas = sorted(f for f in os.listdir(st_dir) if f.endswith(".bas"))
        same_bas = {f: filecmp.cmp(osp.join(st_dir, f),
                                   osp.join(rank_dir, "pred-basis", f),
                                   shallow=False) for f in bas}
        others = [osp.exists(osp.join(out_dir, f"serve{r}"))
                  for r in range(1, len(HOSTS))]
        grid_state = torch.load(osp.join(out_dir, "host_grid_step.pth"),
                                weights_only=True)
    # the grid step against the stacked layout's, dp_edge_grid's bound
    lr = UPDATE_LR
    w0 = seeded_state(ARCH_NO_DROPOUT, seed)
    s_loss, s_state = host_grid_reference(seed)
    fp64 = union_step_fp64(seed, host_grid_graphs(seed), lr)
    rels = update_rels(w0, grid_state, s_state, lr)
    spread = update_rels(w0, s_state, fp64, lr)
    limits = {n: max(UPDATE_RTOL, DIST_UPDATE_SPREAD * spread[n])
              for n in rels}
    near = max(rels, key=lambda n: rels[n] / limits[n])
    step_want = add_launches(scaled(ROUTE_CONV[rows_form], 2))
    runs = [run for rep in per_rank for run in rep["grid"]["runs"]]
    g_loss = runs[0]["loss"]
    if rels[near] > limits[near] or \
            abs(g_loss - s_loss) > 1e-5 * abs(s_loss) or \
            any(run["launches"] != step_want or
                run["collective_exchanges"] != 0 for run in runs) or \
            len({run["weights_digest"] for run in runs}) != 1 or \
            len({run["loss"] for run in runs}) != 1:
        raise SmokeFailure(f"edge_hosts grid step vs the stacked layout: "
                           f"loss {g_loss} vs {s_loss}, update rel diff "
                           f"{rels[near]} in {near} > {limits[near]}, "
                           f"launches {[run['launches'] for run in runs]} "
                           f"(each {step_want}), exchanges "
                           f"{[run['collective_exchanges'] for run in runs]},"
                           f" digests "
                           f"{[run['weights_digest'] for run in runs]}")
    # the serve over both hosts
    serve_want = add_launches(scaled(HOST_CONV, 2 * FORWARDS_PER_LP
                                     * N_RANK_LPS))
    serve_x = 2 * HOST_EXCHANGES_A_CONV * FORWARDS_PER_LP * N_RANK_LPS
    worst = {}
    for fn, got in rank_logits.items():
        err, ok = within(torch.from_numpy(got),
                         torch.from_numpy(st_logits[fn]), *RANK_LOGIT_TOL)
        worst[fn] = err
        if not ok:
            raise SmokeFailure(f"edge_hosts {fn}: rank logits max |err| "
                               f"{err} vs the stacked path's, beyond rtol, "
                               f"atol {RANK_LOGIT_TOL}")
    if len(rank_logits) != N_RANK_LPS or n_bas != N_RANK_LPS or \
            not all(same_bas.values()) or any(others) or \
            any(rep["serve"]["launches"] != serve_want or
                rep["serve"]["collective_exchanges"] != serve_x or
                rep["serve"]["window_bytes"] != 0 for rep in per_rank):
        raise SmokeFailure(
            f"edge_hosts serve: {n_bas} valid bases, logits of "
            f"{sorted(rank_logits)}, .bas equal to the stacked path's "
            f"{same_bas}, files of ranks 1-3 {others}, launches "
            f"{[rep['serve']['launches'] for rep in per_rank]} (each "
            f"{serve_want}), exchanges "
            f"{[rep['serve']['collective_exchanges'] for rep in per_rank]} "
            f"(each {serve_x}), windows "
            f"{[rep['serve']['window_bytes'] for rep in per_rank]}")
    launches = add_launches(
        *(rep["recipe"][w]["launches"] for rep in per_rank
          for w in ("forward", "step")),
        *(run["launches"] for run in runs),
        *(rep["serve"]["launches"] for rep in per_rank))
    exchanges = {
        f"D={c['D']}": {
            "route": halo_mod.COLLECTIVE, "backend": backend,
            "bytes_a_rank": c["bytes_a_rank"],
            "bytes_sent_a_rank": c["bytes_sent_a_rank"],
            "ms_by_rank": [rep["exchange"][i]["ms"] for rep in per_rank],
            "device_ms_by_rank": [rep["exchange"][i]["device_ms"]
                                  for rep in per_rank],
            "signalled_ms_by_rank": None if signalled is None else
            [rep["exchange"][i]["ms"] for rep in signalled],
            "signalled_device_ms_by_rank": None if signalled is None else
            [rep["exchange"][i]["device_ms"] for rep in signalled]}
        for i, c in enumerate(per_rank[0]["exchange"])}
    return {
        "ranks": len(HOSTS), "hosts": HOSTS, "cards": 4 if four else 1,
        "note": "two hosts reported by the ranks of one machine: the "
                "COLLECTIVE route runs over " + ("NVLink (NCCL)" if four
                                                 else "host copies (gloo)")
                + ", not over a network between hosts",
        "groups": groups, "backend": backend, "route_table": table,
        "devices": [rep["placement"]["device"] for rep in per_rank],
        "exchange": exchanges, "Bh": bh,
        "recipe": recipe,
        "grid": {"form": rows_form, "loss": g_loss, "loss_stacked": s_loss,
                 "update_rels": rels, "layout_vs_fp64_update_rels": spread,
                 "nearest_limit": {"tensor": near, "update_diff": rels[near],
                                   "limit": limits[near]},
                 "launches_per_rank": step_want,
                 "weights_digest": runs[0]["weights_digest"]},
        "serve": {"lps": N_RANK_LPS, "bas_equal": same_bas,
                  "lp": "mirp_bench" if mirp else "bench",
                  "logits_max_abs_err": worst,
                  "launches_per_rank": serve_want,
                  "collective_exchanges_per_rank": serve_x,
                  "wall_s": [rep["serve"]["wall_s"] for rep in per_rank],
                  "inf_time_s": inf["inf_time"],
                  "stacked_inf_time_s": stacked_inf},
        "launches": launches, "ranks_s": wall,
        "phase_s": time.perf_counter() - t0}


# the full run starts the rank launches of these phases together (main):
# each phase's fields below were timed beside the others' processes on the
# same card and host CPUs, and compare with no run of the phase alone
CONTENDED = {
    "dp_edge_grid": ["step_device_ms", "allreduce_ms", "allreduce_wait_ms",
                     "partition_s", "rank_wall_s", "graph_batch.steps",
                     "graph_batch.rank_wall_s", "grid_ranks_s",
                     "rows_ranks_s", "phase_s"],
    "edge_hosts": ["exchange", "recipe.span_ms", "recipe.k1_ms",
                   "recipe.k1_share", "serve.wall_s", "serve.inf_time_s",
                   "serve.stacked_inf_time_s", "ranks_s", "phase_s"],
    "dryrun_multihost": ["grid.ranks_s", "rows.ranks_s", "phase_s"]}


def contended(phase: str) -> dict:
    """What ``phase``'s record says of its timings in the full run."""
    return {"beside": [p for p in CONTENDED if p != phase],
            "fields": CONTENDED[phase]}


# the dry-run twin: one step a launch, GCN_FC(8,8,hids=16,depth=3) over the
# all-gather layout without the input cache, a rank's SpMMs: 2 a conv
# forward (2 convs), the hidden conv's 2 backward (AG_RANK_CONV a conv);
# in the rows layout each rank holds all shards of its graph (AG_CONV)
DRYRUN_MESH = {"dp": 2, "edge": 4}
DRYRUN_RANKS = {"grid": DRYRUN_MESH["dp"] * DRYRUN_MESH["edge"],
                "rows": DRYRUN_MESH["dp"]}
DRYRUN_RTOL = 1e-5


def dryrun_phase(seed: int, ports: list[int] | None = None) -> dict:
    """``python -m lp_gnn_tpu_torch.dryrun_multihost`` at its defaults
    (dp=2, edge=4: 8 ranks on the card, one shard a rank) and, at the same
    time, ``--layout rows`` over 2 ranks (each all 4 shards of its graph):
    rank 0 of each prints the script's line, the other ranks nothing; the two
    losses agree within DRYRUN_RTOL (the same step on the same weights);
    each rank's launches exactly 3 convs' (AG_RANK_CONV, or AG_CONV in the
    rows layout). ``ports``: the two launches' and their runs' (4), free
    ones if None."""
    t0 = time.perf_counter()
    out, launches = {}, []
    ports = ports or free_ports(2 * len(DRYRUN_RANKS))
    with tempfile.TemporaryDirectory(prefix="lp_gnn_smoke_dryrun_") as tmp, \
            ThreadPoolExecutor(len(DRYRUN_RANKS)) as pool:
        # both launches at once: each is mostly its processes' start
        running = {layout: pool.submit(
            rank_runs, f"dryrun_{layout}", ranks, tmp, [
                {"name": "dryrun",
                 "module": "lp_gnn_tpu_torch.dryrun_multihost",
                 "argv": ["--layout", layout]}], ports[2 * i:2 * i + 2])
            for i, (layout, ranks) in enumerate(DRYRUN_RANKS.items())}
        for layout, ranks in DRYRUN_RANKS.items():
            reports, wall, groups = running[layout].result()
            reps = [r["dryrun"] for r in reports]
            per_conv = AG_RANK_CONV if layout == "grid" else AG_CONV
            want = add_launches(scaled(per_conv, 3))
            lines = [r["lines"] for r in reps]
            if [len(x) for x in lines] != [1] + [0] * (ranks - 1) or \
                    any(r["launches"] != want for r in reps) or \
                    len(groups) != ranks:
                raise SmokeFailure(f"dryrun_multihost {layout}: lines "
                                   f"{lines}, launches "
                                   f"{[r['launches'] for r in reps]} "
                                   f"(expected {want}), groups {groups}")
            line = lines[0][0]
            emit(line)
            if line["mesh"] != DRYRUN_MESH or line["num_processes"] != \
                    ranks or not line["ok"] or not line["distributed"]:
                raise SmokeFailure(f"dryrun_multihost {layout}: {line}")
            out[layout] = {"line": line, "ranks_s": wall,
                           "groups": groups, "launches_per_rank": want}
            launches += [r["launches"] for r in reps]
    a, b = out["grid"]["line"]["loss"], out["rows"]["line"]["loss"]
    if abs(a - b) > DRYRUN_RTOL * abs(b):
        raise SmokeFailure(f"dryrun_multihost: grid loss {a} vs rows {b}")
    return {**out, "loss_rel_diff": abs(a - b) / abs(b),
            "rtol": DRYRUN_RTOL, "launches": add_launches(*launches),
            "phase_s": time.perf_counter() - t0}


SCALING_ROUND = 17
SCALING_DEVICES = [1, 2, 4, 8]   # make_scaling_artifact's --devices 8


def scaling_artifact_phase(seed: int) -> dict:
    """``python -m lp_gnn_tpu_torch.make_scaling_artifact`` at its and
    bench_scaling's defaults into a temp dir, the artifact read back: a
    step time > 0 at every width of both modes, labelled one card, the
    wire volume SCALING_WIRE_VOLUME. The all-gather mode runs as a user
    runs it, through the twin's own ``run_mode`` (a ``bench_scaling``
    subprocess, no LP_GNN_DIST_* variables, from the package's parent),
    its line checked; the halo mode's bench_scaling runs in this process
    (``twin_line``), so that its launches, which cover every kernel of
    the path, are read: exactly bench_phase's formula at 1, 2, 4 and 8
    shards."""
    from lp_gnn_tpu_torch import make_scaling_artifact as msa
    t0 = time.perf_counter()
    runs = []
    real = msa.run_mode

    def halo_in_process(devices, halo, device, edges=None):
        if not halo:
            line = real(devices, halo, device, edges)
            runs.append({"halo": halo, "line": line})
            return line
        line, launches = twin_line(
            "lp_gnn_tpu_torch.bench_scaling",
            ["--devices", str(devices), "--device", device, "--halo"], {})
        runs.append({"halo": halo, "launches": launches})
        return line

    steps = 4   # bench_scaling: 1 warm-up + 3 timed
    ds = SCALING_DEVICES
    want = add_launches({"spmm_csr": sum(5 * d + steps * 10 * d for d in ds),
                         "halo_all_to_all": len(ds) * (1 + 2 * steps),
                         "gather_rows": len(ds) * (1 + 2 * steps)})
    msa.run_mode = halo_in_process
    try:
        with tempfile.TemporaryDirectory(prefix="lp_gnn_smoke_scal_") as tmp:
            call_main("lp_gnn_tpu_torch.make_scaling_artifact",
                      ["--round", str(SCALING_ROUND), "--out_dir", tmp])
            names = os.listdir(tmp)
            with open(osp.join(tmp, f"SCALING_torch_r{SCALING_ROUND}.json")
                      ) as f:
                art = json.load(f)
    finally:
        msa.run_mode = real
    times = art["step_time_s"]
    sub = runs[0]["line"]
    if names != [f"SCALING_torch_r{SCALING_ROUND}.json"] or \
            set(times) != {"all-gather", "halo"} or \
            any(set(t) != {str(d) for d in ds} or
                not all(v > 0 for v in t.values()) for t in times.values()) \
            or not art["mode"].startswith("one card (") or \
            art["wire_volume_banded_mirp_like"]["by_shards"] != \
            SCALING_WIRE_VOLUME or [r["halo"] for r in runs] != \
            [False, True] or sub["collectives"] != "all-gather" or \
            sub["mode"] != "one-card" or sub["multihost"] or \
            sub["device"] == "cpu" or \
            sub["step_time_s"] != times["all-gather"] or \
            not np.isfinite(list(sub["losses"].values())).all() or \
            runs[1]["launches"] != want:
        raise SmokeFailure(f"scaling_artifact: files {names}, artifact "
                           f"{json.dumps(art)}, the subprocess's line "
                           f"{json.dumps(sub)}, halo launches "
                           f"{runs[1].get('launches')} (expected {want})")
    return {"artifact": art, "launches": runs[1]["launches"],
            "subprocess_line": sub,
            "phase_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--flagship", action="store_true",
                    help="run only the pipeline phase, with the recipe's "
                         f"{FLAGSHIP_EPOCHS} epochs")
    ap.add_argument("--family_table", action="store_true",
                    help="run only the family_table phase, the six demo "
                         "families at the script's 40 LPs and "
                         f"{port_family_table.EPOCHS} epochs")
    ap.add_argument("--gen_ab", action="store_true",
                    help="measure only the GEN aggregation of this "
                         "checkout (kernels, a forward, a step)")
    ap.add_argument("--host_sort", action="store_true",
                    help="measure only from_graph's edge orderings on the "
                         "host, numpy's against lex_order's")
    ap.add_argument("--layout_gemms", action="store_true",
                    help="measure only the recipe's GEMMs over the stacked "
                         "shards against a shard at a time")
    ap.add_argument("--edge_devices", action="store_true",
                    help="run only the edge_devices phase (one edge shard "
                         "a card where the cards are as many as the shards)")
    ap.add_argument("--grid_devices", action="store_true",
                    help="run only the grid_devices phase (dp and the (dp, "
                         "edge) grid over the cards of this process, a card "
                         "a cell where there are as many)")
    ap.add_argument("--edge_rank", metavar="PAYLOAD",
                    help="run as one rank of the edge_ranks phase, with the "
                         "phase's PAYLOAD (a JSON file)")
    ap.add_argument("--k1_rank", metavar="PAYLOAD",
                    help="run as one rank of edge_devices' card ranks (K1's "
                         "rank form, a card a rank), with the PAYLOAD")
    ap.add_argument("--ag_rank", metavar="PAYLOAD",
                    help="run as one rank of the all_gather phase's ranks, "
                         "with the phase's PAYLOAD (a JSON file)")
    ap.add_argument("--edge_hosts", action="store_true",
                    help="run only the edge_hosts phase (ranks reported as "
                         "two hosts; a card a rank where 4 are visible)")
    ap.add_argument("--host_rank", metavar="PAYLOAD",
                    help="run as one rank of the edge_hosts phase, with the "
                         "phase's PAYLOAD (a JSON file)")
    ap.add_argument("--grid_rank", metavar="PAYLOAD",
                    help="run as one rank of the dp_edge, dp_edge_grid or "
                         "dryrun_multihost phases, with the phase's PAYLOAD "
                         "(a JSON file)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if args.edge_rank:
        edge_rank(args.edge_rank)
        return 0
    if args.k1_rank:
        k1_card_rank(args.k1_rank)
        return 0
    if args.ag_rank:
        ag_rank(args.ag_rank)
        return 0
    if args.grid_rank:
        grid_rank(args.grid_rank)
        return 0
    if args.host_rank:
        host_rank(args.host_rank)
        return 0
    if args.host_sort:
        emit({"phase": "host_sort", "nvidia_smi": nvidia_smi(),
              **host_sort(args.seed)})
        return 0
    if args.layout_gemms:
        _build.build_all(["spmm", "gather", "halo_a2a"])
        emit({"phase": "layout_gemms", "nvidia_smi": nvidia_smi(),
              **layout_gemms(args.seed)})
        return 0
    if args.edge_devices:
        _build.build_all(["spmm", "gather", "halo_a2a", "gen_agg",
                          "gen_lse_merge"])
        t0 = time.perf_counter()
        try:
            with tempfile.TemporaryDirectory(
                    prefix="lp_gnn_smoke_devices_") as tmp:
                devd = edge_devices(args.seed, tmp)
        except SmokeFailure as ex:
            print(f"chip_smoke: FAIL: {ex}", file=sys.stderr)
            return 1
        emit({"phase": "edge_devices", "nvidia_smi": nvidia_smi(),
              "phase_s": time.perf_counter() - t0, **devd})
        return 0
    if args.edge_hosts:
        _build.build_all(["spmm", "gather", "halo_a2a"])
        t0 = time.perf_counter()
        try:
            hosted = edge_hosts(args.seed)
        except SmokeFailure as ex:
            print(f"chip_smoke: FAIL: {ex}", file=sys.stderr)
            return 1
        emit({"phase": "edge_hosts", "nvidia_smi": nvidia_smi(),
              "phase_s": time.perf_counter() - t0, **hosted})
        return 0
    if args.grid_devices:
        _build.build_all(["spmm", "gather", "halo_a2a"])
        t0 = time.perf_counter()
        try:
            gdev = grid_devices(args.seed)
        except SmokeFailure as ex:
            print(f"chip_smoke: FAIL: {ex}", file=sys.stderr)
            return 1
        emit({"phase": "grid_devices", "nvidia_smi": nvidia_smi(),
              "phase_s": time.perf_counter() - t0, **gdev})
        return 0
    # the pipeline's prepped family, kept for the steps_per_call phase
    mirp_keep = tempfile.mkdtemp(prefix="lp_gnn_smoke_mirp_")
    # edge_ranks' LPs, checkpoint and stacked serve, for edge_devices and
    # edge_hosts; the directory of edge_hosts' ranks
    ranks_keep = tempfile.mkdtemp(prefix="lp_gnn_smoke_ranks_")
    hosts_keep = tempfile.mkdtemp(prefix="lp_gnn_smoke_hosts_")
    # every phase but edge_devices keeps the edge shards of one process
    # stacked on cuda:0, also where K_EDGE cards are visible
    layout = contextlib.ExitStack()
    layout.enter_context(edge_layout(False))
    try:
        smi = nvidia_smi()
        t0 = time.perf_counter()
        logs = _build.build_all(
            ["spmm"] if args.flagship or args.family_table
            else ["spmm", "gen_agg"] if args.gen_ab
            else ["spmm", "gather", "halo_a2a", "gen_agg", "gen_lse_merge"])
        ptxas = {k: [ln.strip() for ln in v.splitlines()
                     if "registers" in ln or "spill" in ln] for k, v in logs.items()}
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "nvidia_smi": smi, "ptxas": ptxas,
              "torch": torch.__version__, "cuda": torch.version.cuda})
        if args.gen_ab:
            emit({"phase": "gen_ab", "nvidia_smi": smi,
                  **gen_ab(args.seed)})
            return 0
        if args.flagship or args.family_table:
            if args.flagship:
                emit({"phase": "pipeline", **pipeline_phase(
                    args.seed, FLAGSHIP_EPOCHS, FLAGSHIP_LPS)})
            else:
                emit({"phase": "family_table", "nvidia_smi": smi,
                      **family_table_phase(
                          args.seed, port_family_table.FAMILIES,
                          port_family_table.N_INSTANCES,
                          port_family_table.EPOCHS)})
            print(smi, flush=True)
            emit({"ok": True, "device": {
                "platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count()}})
            return 0

        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        rng = np.random.RandomState(args.seed)
        g = bench_graph(args.seed)
        gt = GraphTensors.from_graph(g, "cuda")
        kernels = (check_spmm(gt, gen) + check_spmm_backward(gt, gen)
                   + check_spmm_widths(gt, gen)
                   + check_spmm_shapes(gen, rng)
                   + check_spmm_pipeline(args.seed, gen)
                   + check_gather(gt, gen, rng))
        del gt
        kernels += check_dist_kernels(g, gen)
        torch.cuda.empty_cache()
        kernels += check_gen_kernels(g, gen, rng, args.seed)
        torch.cuda.empty_cache()
        kernels += check_dist_gen_kernels(g, gen)
        torch.cuda.empty_cache()
        kernels += check_all_gather_kernels(g, gen)
        torch.cuda.empty_cache()
        signalled_rows, k1_streams = check_signalled_streams(g, gen)
        kernels += signalled_rows
        emit({"phase": "kernels", "cases": len(kernels), "ok": True,
              "gather_floor": gather_floor(kernels),
              "k1_streams": k1_streams})
        torch.cuda.empty_cache()

        emit({"phase": "reference", **check_reference(args.seed)})

        served = serve(args.seed)
        emit({"phase": "serve", **served})
        emit({"phase": "breakdown", **breakdown(args.seed)})
        dist = dist_serve(args.seed)
        emit({"phase": "dist_serve", **dist})
        emit({"phase": "dist_reference", **dist_reference(args.seed)})
        torch.cuda.empty_cache()
        trained = train(args.seed)
        emit({"phase": "train", **trained})
        emit({"phase": "train_breakdown", **train_breakdown(args.seed)})
        torch.cuda.empty_cache()
        emit({"phase": "train_reference", **train_reference(args.seed)})
        torch.cuda.empty_cache()
        piped = pipeline_phase(args.seed, PIPE_EPOCHS, N_PIPE_LPS,
                               keep=mirp_keep)
        emit({"phase": "pipeline", **piped})
        torch.cuda.empty_cache()
        families = family_table_phase(args.seed)
        emit({"phase": "family_table", **families})
        torch.cuda.empty_cache()
        emit({"phase": "gen_reference", **gen_reference(args.seed)})
        torch.cuda.empty_cache()
        gen_served = gen_serve(args.seed)
        emit({"phase": "gen_serve", **gen_served})
        torch.cuda.empty_cache()
        gen_trained = gen_train(args.seed)
        emit({"phase": "gen_train", **gen_trained})
        torch.cuda.empty_cache()
        zoo = zoo_serve(args.seed)
        emit({"phase": "zoo_serve", **zoo})
        torch.cuda.empty_cache()
        sampled = sampled_serve(args.seed)
        emit({"phase": "sampled_serve", **sampled})
        torch.cuda.empty_cache()
        strained = sampled_train(args.seed)
        emit({"phase": "sampled_train", **strained})
        torch.cuda.empty_cache()
        batched = graph_batch(args.seed)
        emit({"phase": "graph_batch", **batched})
        torch.cuda.empty_cache()
        dp = dp_phase(args.seed)
        emit({"phase": "dp", **dp})
        torch.cuda.empty_cache()
        dtrained = dist_train(args.seed)
        emit({"phase": "dist_train", **dtrained})
        torch.cuda.empty_cache()
        dzoo = dist_zoo_serve(args.seed)
        emit({"phase": "dist_zoo_serve", **dzoo})
        torch.cuda.empty_cache()
        dgen = dist_gen_train(args.seed)
        emit({"phase": "dist_gen_train", **dgen})
        torch.cuda.empty_cache()
        dpe = dp_edge(args.seed)
        emit({"phase": "dp_edge", **dpe})
        torch.cuda.empty_cache()
        ranked = edge_ranks(args.seed, ranks_keep)
        kernels += ranked.pop("kernels")
        emit({"phase": "edge_ranks", **ranked})
        torch.cuda.empty_cache()
        devd = edge_devices(args.seed, ranks_keep,
                            ranked["serve"]["stacked_inf_time_s"])
        kernels += devd.pop("kernels")
        emit({"phase": "edge_devices", **devd})
        torch.cuda.empty_cache()
        gdev = grid_devices(args.seed)
        emit({"phase": "grid_devices", **gdev})
        torch.cuda.empty_cache()
        scanned = steps_per_call(args.seed, mirp_keep)
        emit({"phase": "steps_per_call", "nvidia_smi": smi, **scanned})
        torch.cuda.empty_cache()
        gathered = all_gather_phase(args.seed)
        emit({"phase": "all_gather", **gathered})
        torch.cuda.empty_cache()
        benched = bench_phase(args.seed)
        emit({"phase": "bench", "nvidia_smi": smi, **benched})
        torch.cuda.empty_cache()
        natived = native_phase(args.seed, mirp_keep)
        emit({"phase": "native", "nvidia_smi": smi, **natived})
        torch.cuda.empty_cache()
        big = big_phase(args.seed)
        emit({"phase": "big", "nvidia_smi": smi, "cpu": host_cpu(), **big})
        torch.cuda.empty_cache()
        probed = probe_phase("lp_gnn_tpu_torch.probe_spmm")
        emit({"phase": "probe_spmm", "nvidia_smi": smi, **probed})
        torch.cuda.empty_cache()
        floors = probe_phase("lp_gnn_tpu_torch.probe_gen_floor")
        emit({"phase": "probe_gen_floor", "nvidia_smi": smi, **floors})
        torch.cuda.empty_cache()
        # the last rank launches start together, each mostly its
        # processes' start: edge_hosts' and the dry run's (threads that
        # only launch and wait) beside dp_edge_grid's; the phases' checks
        # then run in their order in this thread
        ports = free_ports(13)
        with ThreadPoolExecutor(2) as pool:
            hosts_run = pool.submit(edge_hosts_launch, args.seed, hosts_keep,
                                    ranks_keep, ports[6:9])
            dry_run = pool.submit(dryrun_phase, args.seed, ports[9:])
            gridded = dp_edge_grid(args.seed, ports[:6])
            emit({"phase": "dp_edge_grid", "nvidia_smi": smi,
                  "contended": contended("dp_edge_grid"), **gridded})
            torch.cuda.empty_cache()
            hosted = edge_hosts(args.seed, ranks_keep,
                                ranked["serve"]["stacked_inf_time_s"],
                                hosts_run.result())
            emit({"phase": "edge_hosts", "nvidia_smi": smi,
                  "contended": contended("edge_hosts"), **hosted})
            torch.cuda.empty_cache()
            dried = dry_run.result()
        emit({"phase": "dryrun_multihost", "nvidia_smi": smi,
              "contended": contended("dryrun_multihost"), **dried})
        torch.cuda.empty_cache()
        scaled_art = scaling_artifact_phase(args.seed)
        emit({"phase": "scaling_artifact", "nvidia_smi": smi, **scaled_art})
    except SmokeFailure as ex:
        print(f"chip_smoke: FAIL: {ex}", file=sys.stderr)
        return 1
    finally:
        layout.close()
        shutil.rmtree(mirp_keep, ignore_errors=True)
        shutil.rmtree(ranks_keep, ignore_errors=True)
        shutil.rmtree(hosts_keep, ignore_errors=True)
    # launches: the SpMM, the gather and K1 on the edge-partitioned path,
    # the one path that runs all three; the GEN kernels on the GEN training
    # path, which runs both; a case at the dist GEN layer's shapes (and the
    # merge) on the dist GEN step; each path's count beside it
    paths = {"serve": served, "dist_serve": dist, "train": trained,
             "pipeline": piped, "family_table": families,
             "gen_serve": gen_served,
             "gen_train": gen_trained, "zoo_serve": zoo,
             "sampled_serve": sampled, "sampled_serve_gen": sampled["gen"],
             "sampled_train": strained, "graph_batch": batched,
             "dp_graph_batch": dp, "dist_train": dtrained,
             "dist_zoo_serve": dzoo, "dist_gen_train": dgen,
             "dp_edge": dpe, "edge_ranks": ranked, "edge_devices": devd,
             "grid_devices": gdev,
             "steps_per_call": scanned, "all_gather": gathered,
             "bench": benched, "native": natived, "big": big,
             "probe_spmm": probed, "probe_gen_floor": floors,
             "dp_edge_grid": gridded, "edge_hosts": hosted,
             "dryrun_multihost": dried,
             "scaling_artifact": scaled_art, "k1_streams": k1_streams}
    for k in kernels:
        main_path = paths[k["path"]] if "path" in k else \
            gen_trained if k["name"].startswith("gen_agg") else dist
        k["launches"] = main_path["launches"][k["name"]]
        k["launches_by_path"] = {p: r["launches"].get(k["name"], 0)
                                 for p, r in paths.items()}
        k["card"] = smi
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
