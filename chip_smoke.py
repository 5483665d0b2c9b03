"""Smoke run of the torch port on one NVIDIA card.

    python3 chip_smoke.py                      # the whole run
    python3 chip_smoke.py --groups 4,8,32 [model keys...]
                                               # lanes-per-seed sweep only

Drives the port's main path — 5-node raft leader election batched over
seeds (``madsim_tpu_torch``) — and then every other model family of the
port (the ``BENCH_SPECS`` and ``SOAK_SPECS`` models) through the
hand-written CUDA run and drain kernels, and holds each against the
plain eager step:

1. the card's name and power limit, torch and CUDA versions;
2. builds every model's kernel library from ``madsim_tpu_torch/csrc``
   with nvcc, one process per library (the registered ones and phase
   72's), all started together, and prints
   each kernel's registers and stack frame, and per pool its lanes per
   seed (G), seeds per block, shared bytes per block and resident
   blocks per SM (the card's occupancy calculator);
3. the ``entry()`` shape (pool 128, loss 0.02, 1,024 seeds):
   ``make_step`` and a 60-step ``make_run`` through the kernel, every
   field equal to the plain step on the card;
4. the main path, raft at its full-width bench shape
   (``BENCH_SPECS["raft"]``: 65,536 seeds, ``make_run_while`` capped at
   600 steps), then, phases 5-10, every other model at its full-width
   ``BENCH_SPECS`` shape: microbench, pingpong, broadcast, kvchaos,
   kvchaos with the payload arena (the kvchaos config) and raftlog;
   then, phases 11-15, the five families at their full-width
   ``SOAK_SPECS`` shape (the JAX package's soak configurations):
   snapshot, twophase, paxos, leasekv and shardkv.
   Each drives ``make_run_while`` (a run kernel and a drain kernel
   launch) with the launch counts read around it, checks that every
   seed halted with no pool overflow, holds every field against the
   plain step on the card (run once, timed that once, and counting the
   work of the bound) and the first 64 seeds against the plain step on
   the CPU, holds the drain kernel alone against its plain version, and
   times the kernel path by CUDA events (median of 5, min, max). Raft
   also checks its election latency and splits the kernel path's time
   into the run pass, the drain kernel and the rest;
16. the compacted runner (``make_run_compacted``) on raft at the bench
   shape (65,536 seeds, ``min_size`` by bench.py's rule, shrink 4),
   kvchaos and shardkv at theirs: one run kernel launch and no drain,
   every banked field (``step`` included) equal to the plain phase
   program on the card, every field but ``step`` equal to
   ``make_run_while``; ``compute`` timed alone;
17. seed search: raft at 65,536 seeds with the invariant "some node is
   leader" (no violation, every seed halted); kvchaos ``writes=5`` at
   4,096 seeds with a too-strong invariant, with ``compact`` off and
   on (same verdicts and traces, some but not all seeds failing); the
   first failing seed alone reproduces its trace, and its oracle
   replay refolds to it;
18. measurement: ``measure_throughput`` on raft at 65,536 seeds and
   ``measure_latency`` on pingpong, each dict printed, no overflow and
   every seed halted; ``null_dispatch_stats``;
19. ``check_determinism`` and ``check_layouts`` on raft at 65,536 seeds
   for 60 steps;
20. a checkpoint of raft at 65,536 seeds after 20 steps, saved, loaded
   and run 580 more steps, equal in every field to the 600-step run;
21-30. the record libraries (``RECORD_VARIANTS``: each of the seven
   families that records operation histories, with ``record=True``,
   and kvchaos, leasekv and shardkv also with their planted ``bug``) at
   their family's full-width shape, held as in phases 4-15, every
   history row included, with ``hist_count > 0``; each one's kernel
   time printed beside its sibling's without recording;
31. history search on the card: kvchaos ``bug=True``, ``writes=5``,
   pool 192, loss 0.05, 1,024 seeds, 1,500 steps, with
   ``stale_reads & read_your_writes`` as the history invariant: some
   seeds fail, the final-state durability invariant passes on every
   seed, and the failing seeds equal those of the plain step's run on
   the card, with compact off and on;
32. a checkpoint of leasekv-record at 4,096 seeds after 150 steps,
   saved, loaded and run 450 more, equal in every field (the history
   rows included) to the 600-step run;
33. (inside phases 21-30) each record library's history columns judged
   on the card by its family's screens (``check/device.py``), the
   verdicts equal to the numpy checkers on the host copy; the screens'
   and the fold's times beside the run kernel's, the host path's (copy
   and numpy) and the bytes each path moves to the host;
34. phase 31's hunt with ``device_check`` in place of the history
   invariant, lockstep and compacted: both flag phase 31's seeds, every
   flagged history fails the exact checker; the screened compacted run
   folds losslessly and keeps the flagged seeds' columns verbatim;
35. the slice's main path: raft-record at 65,536 seeds searched with
   ``device_check=election_safety(OP_ELECT)``, lockstep and compacted,
   each timed, the verdicts equal to the host path's;
36. the fault-plan libraries (the ``chaos=False`` libraries of
   ``engine/fused.py`` ``MODELS``) at full width under the nemesis soak's plans (``tools/nemesis_soak.py``,
   its shapes and step caps): raft-record at pool 64 and 65,536 seeds
   under its pause-storm and gray-failure plan; kvchaos-bug and
   kvchaos-record without their own chaos (``writes=10``, pool 192, loss
   0.05, 8,192 seeds) under the crash storm, and kvchaos-record under a
   plan mixing every fault spec with ``dup_rows`` (cap 1,000, where its
   plain step and CPU sample stop: some seeds never halt); paxos-record under
   its proposer crash storm and twophase-record under crash and
   duplication, with ``dup_rows`` and without (the flag set and stored,
   no shadow row sent), all at pool 96 and 8,192 seeds. Each is
   held as in phases 4-15 (every field against the plain step on the
   card, the first 64 seeds on the CPU, the drain kernel alone) and
   timed, beside kvchaos-bug with its own chaos at the same shape;
37. the nemesis certificates 1-3 and 5-7 of ``tools/nemesis_soak.py``
   at 8,192 seeds on the card, each search's seeds equal to the plain
   step's run on the card, the counts and the shrunk seed's repro pinned
   from the JAX package's run of the soak: amplification (the plan
   catches the lost write on more seeds than the model's own kill), the
   clean model clean, the first failing seed shrunk to its pinned
   events and its replay's trace, and raft election, paxos and twophase
   with no violation; each search's wall ms and the plan compile's
   host ms;
37.4. the nemesis soak's certificate 4: raftlog-durable-record (pool
   96, loss 0.02, clog backoff at most 2 s, cap 6,000, 8,192 seeds)
   under its crash storm and gray failure, election safety on OP_ELECT
   and OP_COMMIT: 0 violations, 0 overflows, 0 unhalted and the trace
   column's digest as the JAX package's run of the same search;
38. the storage libraries and the metrics runs, each held as phases
   4-15 (every field, the storage columns and ``met`` included):
   38.1 raftlog-durable at the raftlog bench shape, and its seeds 0,
   7, ..., 63 at pool 128 equal to the C++ oracle's traces; 38.2-38.4
   raftlog-durable-record under the store soak's plan and under the
   lying disk, and raftlog-nosync-record under the store plan (8,192
   seeds, pool 128, cap 6,000, ``metrics=True``; the plain step on the
   card holds the first 2,048 seeds); 38.5 the main path with
   ``metrics=True``, every field but ``met`` equal to the run without,
   its time beside phase 4's; 38.6 phase 36.4's run with
   ``metrics=True`` (its cap), every field but ``met`` equal to 36.4's
   plain run on the card, every field on the first 64 seeds on the CPU, its
   dup, pause, clog-block and crash counters summed over every seed
   non-zero;
39. the store soak's certificates at 8,192 seeds on the card, each
   search's counts and trace digest pinned from the JAX package's run
   on the CPU (``tests/_torch_store_pins.py``), its failing seeds among
   the first 2,048 equal to phase 38's plain runs: 39.1 no disk fault
   (the kernel, the plain step and ``make_run_compacted`` agree); 39.2
   the store plan clean, the fleet's syncs, lied syncs, torn kills and
   crashes summed on the card; 39.3 the lying disk flagged; 39.4 the
   nosync mutant caught by committed-value loss, its first failing
   seed shrunk to the pinned events and replayed; 39.5 the EIO storm
   clean with failed syncs on most seeds;
40. the main path with every observability tap: raft at 65,536 seeds
   with ``metrics=True, timeline_cap=256, cov_words=64,
   cov_hitcount=True``, held as phase 4 (every field, the bitmap, hit
   counters and ring included, against the plain step on the card and
   the first 64 seeds on the CPU), every field but the tap columns and
   ``met`` equal to phase 4's run, the kernel's ms beside phase 4's and
   each tap alone timed with its shared bytes a block;
41. coverage searches: the new library raftlog-durable-spread
   (``cov_spread=True``) held as phases 4-15 at the raftlog bench shape
   with the taps, then ``search_seeds(cov_words=64, cov_hitcount=True)``
   at 8,192 seeds on kvchaos-bug without its own chaos under the nemesis
   plan (phase 37.1's 1,609 catches), leasekv, shardkv and raftlog
   ``durable`` with ``cov_spread``: each report's bitmaps and traces
   equal the plain step's on the card for the first 2,048 seeds (a
   halted seed's bitmap is final), its verdicts and traces those of the
   search without taps;
42. forensics: phase 37's first failing seed under its shrunk plan,
   replayed on the card with ``timeline_cap=4096``: the port's
   ``obs.decode_timeline`` reads the ring, the rows refold to the pinned
   trace, nothing dropped, one row per dispatched step, the ring equal
   to the plain step's on the CPU;
43. the tail-latency tap at the latency soak's shape
   (``tools/latency_soak.py``): kvchaos-army-nochaos (two replicas, a
   client army of 64 three-round ops, pool 160, 700 ms clock cap) under
   the army and GrayFailure plan at 8,192 seeds with
   ``LatencySpec(ops=64, phases=2, phase_ns=2**28)``, held as phases
   4-15 (the plain step on the card on the first 1,024 seeds, the five
   ``lat_*`` columns included, and a CPU sample); the same run with the
   tap off has every other field equal, traces included; the kernel's
   ms with and without the tap;
44. the latency soak's certificates 2 and 3 on the card through
   ``obs.fleet_latency`` (reduced on the card): 4,096 seeds under the
   gray plan, whose fleet sketch equals the exact bucketing of the
   per-op clocks, whose sharded merge (``parallel.merge_latency`` of two
   halves) equals the whole and whose p50, p90, p99 and p99.9 land
   within one bucket of numpy's; 2,048 seeds clean and gray, the p99
   blowup at least 2x; each run's completed ops, ops per window and
   sketch digest equal the JAX package's (``LAT_PINS``);
45. the step goldens' two army scenarios (``tools/step_goldens.py``:
   ``raftlog/army-obs`` and ``kvchaos/army-obs``, 32 seeds, 240 steps,
   every tap) through the run kernel, ``make_run`` and
   ``make_run_compacted``, each digest equal to ``ARMY_GOLDENS`` (this
   script's copy of ``tests/_step_goldens.py``); each of the two
   libraries then held as phases 4-15 at 4,096 seeds under its
   scenario, to 300 steps;
46. leasekv-army and shardkv-record-army-nochaos under their client
   armies (a crash storm, and the retry soak's gray failure without its
   policy) at 8,192 seeds with the tap, held as phases 4-15; then the
   SLO screen: ``search_seeds(latency=...)`` at phase 43's shape with
   the numpy ``check.slo_bounded`` invariant, and
   ``check.device.slo_breaches`` on the sweep's sketches on the card,
   flagging the same seeds;
47. causal provenance (``tools/causal_soak.py`` on the card), its
   certificate 1: kvchaos-bug-nochaos at the soak's shape (pool 192,
   loss 0.05, its crash storm, 4,096 seeds, cap 4,000) with metrics, a
   128-row ring and ``causal=True``, held as phases 4-15 (the six
   causal columns against the plain step on the card on the first 512
   seeds and a CPU sample); without the axis every other field, the
   traces and the screens' verdicts are equal, and so are the searches
   with ``device_check``, lockstep and compacted (the JAX package's 781
   flagged seeds and trace digest); the kernel's ms with and without;
48. certificate 2: ``obs.fleet_reduce(met, lam=)`` of that run on the
   card gives the JAX package's causal depth and width; seeds 1000-1005
   with a 256-row ring: ``obs.rederive`` equals the device fold and the
   seqs strictly increase;
49. cones: the screen sweep with a 512-row causal ring, its flagged
   seeds the plain step's, each ``check.device.violation_cones`` cone
   closed; then certificate 3's hunt shape on the new library
   raftlog-record-w16-nochaos (16 writes, pool 192, 2,048 seeds, cap
   20,000, an 8,192-row ring; G = 32), held as phases 4-15 on the first
   128 seeds to 300 steps, searched to 20,000 with election safety on
   OP_COMMIT and OP_ELECT:
   the JAX package's 43 flagged seeds, and each of the first 8 seeds'
   cone cut at its conflicting COMMIT, the best (seed 137, 142 of 589
   rows) at or under 0.25 of its ring;
50. certificate 4: the new library kvchaos-bug-nochaos-dup under the
   soak's duplication and gray-failure plan, held as phases 4-15 at
   1,024 seeds with a 512-row causal ring; seeds 77-84 decoded, the
   exact and the stripped Perfetto documents differ on 1,050 arrow
   anchors and all 1,291 exact arrows match the parent column (the JAX
   package's counts);
51. client retries (``tools/retry_soak.py`` on the card), its
   certificate 1: the new library kvchaos-record-army-r2-nochaos (two
   replicas, pool 96, 450 ms clock cap) under the soak's gray plan and
   kvchaos policy, and shardkv-record-army-nochaos (pool 96) under its
   policied plan, 2,048 seeds, cap 3,000, each held as phases 4-15 (the
   three retry columns against the plain step on the card on the first
   256 seeds and a CPU sample) with its kernel ms beside the same plan's
   without the policy, then searched with its history invariant
   (shardkv's judged on the card by the device screens of its two
   checkers, ``device_check``): 0
   violations, the re-sends, give-ups and traces of the JAX package's
   runs (``RETRY_PINS``, from ``tests/_torch_retry_pins.py 2048``);
52. certificate 2: 512 seeds of the quiet plan against the gray one,
   the re-sends the JAX package's and the gray failure's at least twice
   the quiet plan's;
53. certificate 3 on the fixed hunt plan: the new library
   shardkv-noidem-army-nochaos held as phases 4-15 on the first 128 of
   1,024 seeds, swept with exactly_once (the JAX package's flagged
   seeds and traces); each of the first 8 flagged seeds alone caught by
   exactly_once and by no shard_coverage; the first shrunk under the
   plan's policy to the JAX package's events, rounds, probes and trace,
   and the shrunk plan replayed twice to that trace and the violation;
54. the policy with every tap and the causal axis on the OBS build of
   kvchaos-record-army (pool 72): the step goldens' army scenario with
   the soak's kvchaos policy, 4,096 seeds, cap 2,000, held as phases
   4-15 on the first 512 seeds; seeds 0-7 decoded, their Perfetto try
   arrows and re-sent army rows the JAX package's counts;
55. coverage-guided exploration (``tools/explore_soak.py`` on the card),
   its certificate 1: kvchaos-bug-nochaos (writes=10, pool 192, loss
   0.05, cap 4,000, 64 coverage words) under the soak's crash storm, a
   uniform sweep of 2,048 seeds and the guided host campaign
   (``explore.run``, 8 generations of 256, root 7) judged by
   ``stale_reads & read_your_writes``: violations, coverage bits, both
   curves and the campaign's digest the JAX package's
   (``EXPLORE_PINS``, from ``tests/_torch_explore_pins.py``); then
   ``explore.run_device`` with the two screens as ``history_check``:
   the host campaign's digest, one host sync a generation; each
   generation's dispatch and sync ms and its parts' CUDA-event ms;
56. certificate 2: the 3 x 64 campaign twice, identical and pinned; its
   first violation replayed, shrunk to the pinned events, rounds,
   probes and trace, and the shrunk plan replayed;
57. certificates 3-4, the diskless-raftlog hunt on the new library
   raftlog-record-nochaos (pool 128, loss 0.02, clog backoff at most
   2 s, cap 6,000, the taps kernel): 8 generations of 256, root 2024,
   election safety on OP_COMMIT and OP_ELECT; violations, curves,
   digest and first find pinned; the find replayed, shrunk to the
   pinned events, rounds, probes and trace (its wall seconds printed),
   the shrunk plan replayed to the violation;
58. the retry soak's noidem hunt (shardkv-noidem-army-nochaos, its new
   taps kernel at pool 96, 32 coverage words, the latency tap, 3 x 128,
   root 14) and the causal soak's cone hunt (raftlog-record-w16-nochaos,
   pool 192, cap 20,000, 2 x 256, root 2024) as campaigns, each
   campaign's violations, digest and first find pinned; the cone hunt's
   bred children held against the plain step to 300 steps;
59. ``explore.run_device`` on raft at pool 64 (its new taps kernel) under
   the JAX package's device-test plan, 8 generations of 4,096, cap 600,
   16 coverage words; a second campaign with another root builds
   nothing (``compile_wall_s`` 0.0 each generation) and, under
   ``explore.device.strict_syncs``, waits for no card but at the
   consume point; its first two generations, under
   ``explore.device.counted_syncs``, wait once, counted by
   ``torch.profiler`` (``obs.prof.count_syncs``: one event wait, no
   pageable copy); every generation's
   parts (mutate, compile, sweep, judge, admit) by CUDA events; the
   mutator's first-maximum pick on the card.
   In each of 55-59 the first 64 children of a bred generation (their
   seeds and plan rows, the bitmap on) run through the kernel, every
   field against the plain step on the card, timed (55's and 56's, 64
   each, in one batch: the plain step's cost on the card is its step
   count; they are held for 1,000 steps, not the 4,000-step cap, and
   ``EXPLORE_PINS`` hold the full-cap campaigns);
60. the flight soak's certificates (``tools/flight_soak.py`` at its
   defaults: raft at pool 64 under its plan, batches of 4,096, 4
   generations, 64 steps, 32 coverage words): three ``run_device``
   campaigns under one ``obs.prof`` profiler build each generation
   program once and campaigns 2-3 nothing (``compile_wall_s`` 0), each
   campaign the JAX package's (``OBS_PINS``); the cache A/B printed; the
   flight recorder on and off gives the same halt hunt (3 x 4,096, 96
   steps) on both drivers, with the wall-split schema and one host sync
   a device generation (the device driver under
   ``explore.device.strict_syncs``, where any other wait for the card
   raises, and ``counted_syncs``, where the profiler counts each
   generation's waits);
   that hunt's ``campaign_perfetto`` has one span a
   generation, monotone counter tracks and compile instants;
61. the farm soak's certificate 1 at its shape (raft 64, 1,024 a
   generation, 6 generations, 256 steps, 3 interleaved rounds, organic
   and with an emulated slow collector): ``farm.run_pipelined`` and
   ``run_device``, each checkpointing every generation and writing a
   flight log, are bit-identical (the JAX package's digest), their
   checkpoint files byte-equal, every timed round under
   ``strict_syncs``; one more campaign of each under ``counted_syncs``
   waits for the card once a generation by the profiler's count (the
   checkpoint reads its generation's pinned host copy; the count's own
   end waits for the card, so it is not timed);
   the ratios and the queue/idle split printed, not gated;
62. certificate 2: three tenants in one-generation quanta through
   ``farm.run_farm``: each equals its standalone campaign and the JAX
   package's, one build per program key, no eviction, tenant-tagged
   generation records;
63. certificates 3-4: adaptive energy against uniform on
   kvchaos-bug-nochaos 192 (loss 0.02, 800 steps, 8 x 256, roots 7, 13
   and 29) on the host driver, every count the JAX package's
   (``FARM_PINS``); energy absent, ``None`` and ``mode="uniform"`` one
   campaign;
64. ``tools/obs_soak.py`` certificates 3 and 5: the diskless-raftlog hunt
   (raftlog-record-nochaos 128, 2 x 256, root 2024) with a ``JsonlSink``
   and a checkpoint; its first violation shrunk, replayed with a
   4,096-row ring and metrics and refolded; ``write_perfetto``,
   ``obs.explain`` and ``explain(causal=True)`` equal the JAX package's
   (sha256 pinned); the checkpoint reloads to the identical corpus;
65. ``parallel`` on a world of one card (NCCL, a ``file://`` store):
   ``shard_run_compacted`` with ``hist_screen`` on kvchaos-bug (1,024
   seeds, pool 192) equals ``make_run_compacted`` in every field; the
   four merges equal one device's; ``run_device(mesh=)`` equals phase
   60's campaign under ``strict_syncs``, its first two generations one
   counted wait each;
66. the determinism lint on the card: ``madsim_tpu_torch.lint``'s
   ``lint_repo`` finds nothing and no unused pragma in the checkout;
   ``lint.check_noninterference`` through the run kernel (``make_run``,
   4 chunks, perturbation seeds 1 and 2) on five libraries at their
   earlier phases' shapes, nothing cut: raft at pool 40 with metrics and
   every tap (phase 40), raft-record at 40 (21), kvchaos-bug-nochaos at
   192 with metrics, a 128-row ring and the causal axis under its crash
   storm (47), kvchaos-record-army at 72 with every tap, the latency
   tap, the causal axis and its retry policy (54), and
   raftlog-durable-spread at 64 with the coverage taps (41.0). Before
   each chunk the derived columns are overwritten with values drawn
   within their contracts; the core columns (the retry books and the
   storage columns among them) and the trace must equal the clean run's
   on every seed, the chunked clean run the unchunked one, and every
   chunk boundary must hold its contracts (``check_ranges``). The live
   control: perturbing raft's ``seed``, a core column, is reported;
67. the store soak's certificate 4 (``tools/store_soak.py``) on the new
   taps build of raftlog-nosync-record at pool 128: the missing-sync
   hunt (``explore.run``, 8 x 256 from root 1031, 6,000 steps, 64
   coverage words, the soak's history invariant), its first violation
   replayed (committed-value loss), shrunk, the shrunk plan replayed by
   ``search_seeds`` and told by ``obs.explain(max_events=24)``: every
   count, curve, event, trace and the explain text's sha256 the JAX
   package's (``HUNT_PINS``, from ``tests/_torch_hunt_pins.py``); the
   first 64 children of generation 1 held against the plain step;
68. the latency soak's certificates 4-5 (``tools/latency_soak.py``) on the
   new taps build of kvchaos-army-nochaos at pool 160: a uniform sweep of
   2,048 over the blip space calibrates the SLO at its worst window-p99
   bucket and breaches it nowhere; the guided campaign (8 x 256, root
   7, the latency tap, 64 coverage words) judged by ``slo_bounded``
   breaches it; the first breach shrunk, replayed exactly and told by
   ``obs.explain`` with a 4,096-row ring and the tap (the percentiles and
   the verdict narrated): every pin the JAX package's; the first 64
   children of generation 1 held against the plain step to 300 steps
   (they halt within some 630);
69. the lint's other three axes through the run kernel
   (``lint.check_campaign``, ``check_noninterference(verdict=...)``), the
   JAX package's flags: sharded-campaign on kvchaos-army-nochaos 160 over
   the SLO-hunt space and sharded-causal on kvchaos-bug-nochaos 192 over
   phase 55's crash storm, each 2 x 256 unsharded and on a one-card NCCL
   world: generation 1's children through ``make_run`` (and
   ``shard_over_seeds``) under perturbation, and the campaign's outcome
   equal with every generation's non-guidance derived columns perturbed;
   flight-campaign the same inside a ``FlightRecorder`` with its profiler
   on, the reports equal to the recorder-off ones and each counted
   generation one wait; device-check on raftlog-nosync-record 128
   (election and recovery safety) and kvchaos-bug-nochaos 192 (stale
   reads, read your writes) at 2,048 seeds: the history and the verdict
   equal with every other derived column perturbed; every live control
   (the met leak around the runner, the guidance, the history columns)
   reported;
70. the dual-mode raft hunt: the crash plan ``CrashStorm(targets=(0, 1,
   2, 3, 4), n=2)`` over seeds 1-512. (a) its rows compiled on the card
   (``compile_batch(device=True)``) are, seed by seed, the events of the
   port's ``Nemesis`` inside a port ``Runtime`` and numpy's ``compile``;
   (b) ``search_seeds`` runs raft-record at pool 64, loss 0.02, under the
   plan through the run kernel (one run and one drain launch) with
   ``election_safety`` as the history invariant; (c) on the host, the
   port's copy of the raft KV example (``tests/_torch_raft_kv.py``) runs
   each seed for 2 simulated seconds at 2% loss under ``Nemesis(plan)``
   with a ``Recorder`` spy on election wins: every seed elects, every
   nemesis log is its seed's compiled events, and the verdicts equal
   (b)'s, all true; the kernel's ms (median of 5) and the runtime's wall
   seconds and simulated seconds per wall second printed;
71. the etcd lease convergence (``tests/_torch_lease.py``): three
   clients hold a 5 s lease each and renew it every second, client 1
   stops at 2 s. (a) leasekv-record without its own chaos, with
   ``ka_stop_ms``, at 4,096 seeds, pool 48, loss 0, 140 steps, through
   the run kernel, held as in phases 4-15 (every field against the plain
   step on the card, the first 64 seeds on the CPU, the drain kernel
   alone, the kernel's ms over 5 runs): on every seed lease 1 expires,
   leases 2 and 3 survive, the watcher's events name lease 1 only, and
   ``lease_safety`` holds on the card; (b) the port's etcd server and
   three lease clients on one port ``Runtime`` a seed, seeds 1-256: each
   seed's expired and surviving leases equal its card verdict, and the
   expiry seconds lie in the window the CPU test fixed against the JAX
   package; the host's wall seconds and simulated seconds per wall
   second printed;
72. factory variants off the registry, each through a library derived
   from its workload (``engine/fused.py`` ``FAMILIES``) and built in
   phase 2 beside the registered ones: raft with 3 nodes (pool 40) and
   7 (pool 96) at 65,536 seeds, broadcast with 4 nodes and no partition
   (16,384), the kvchaos army at its defaults under a 16-op army with a
   retry policy and the latency tap (pool 64, 4,096), paxos with 3
   durable acceptors (96), shardkv with 3 groups of 5 (64), leasekv with
   5 clients and client 1's keepalive stall under its own chaos (48),
   raftlog durable and recording with its chaos (16,384), and raft with
   every tap at pool 512 (65,536; 8 seeds a block, not 16). Each is one
   ``make_run_while`` (one run and one drain launch, counted), its first
   64 seeds held per field against the plain step on the CPU, the drain
   kernel alone against its plain version, timed (median of 5);
73. one JSON line describing each kernel, with its launches on every
   path above (each path driven with the counts set to 0 just before
   it and read just after) and its library's launch shape (the
   occupancy calculator's numbers and the registers of the kernels
   without the taps), then the card's name and power limit, then
   ``{"ok": true, "device": ...}`` as the last line.

Each group of phases prints its wall seconds as it ends (``[time]``).

Phase 2 also holds the launch shape of each library without recording
against ``BASE_SHAPES`` (measured on an H100 80GB HBM3), and prints the
shape of each library's run kernel with metrics.

Any mismatch or exception exits non-zero. Without a card it exits
non-zero before printing any result. Imports nothing of JAX or of the
JAX package.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager, nullcontext

import numpy as np
import torch

ENTRY_SEEDS = 1024
# the CPU sample of phases 4-15, 21-30, 36, 38, 40 and 41 (256 until PR
# 14, which cut it to make room for phases 55-59)
CPU_SAMPLE = 64
REPEATS = 5
# Bound terms (NVIDIA H100 SXM data sheet): 3.35 TB/s of HBM; integer
# issue of 132 SMs x 64 int32 lanes per clock at the card's max clock
HBM_BYTES_PER_S = 3.35e12
INT32_LANES = 132 * 64
# int32 operations per threefry2x32-20 block: 20 rounds of add, rotate,
# xor, 5 key injections of 3 adds, the parity word and the 2 key adds
THREEFRY_OPS = 20 * 3 + 5 * 3 + 2 + 2
# per pool slot of the pop scan: the valid test, the compare, the select
POP_OPS_PER_SLOT = 3
# the runner phases: raft at the bench shape and the ported models whose
# compacted runs are held (name, kernel model key, factory kwargs)
COMPACT_PHASES = (
    ("raft", "raft", {}),
    ("kvchaos", "kvchaos", {}),
    ("shardkv", "shardkv", {}),
)
# kvchaos search (phase 17): writes is a runtime word of its library
KV_WRITES = 5
# the history search (phase 31): the JAX package's lost-write hunt
HIST_SEARCH_KW = dict(pool_size=192, loss_p=0.05)
HIST_SEARCH_SEEDS, HIST_SEARCH_CAP = 1024, 1500
# the launch shapes of the libraries without recording (NVIDIA H100
# 80GB HBM3): key -> pool -> (run kernel shared bytes per block, blocks
# per SM, drain kernel's the same). The seed's dup flag, stored since
# the chaos write-back, crosses an 8-byte boundary of the shared seed
# state for raft, microbench, pingpong, twophase and leasekv (+8 B a
# seed, +128 B a block); microbench's run kernel went from at most 40 to
# 48 registers with the extended kinds, so 10 blocks fit an SM, not 12
# (its 1,024 seeds fill 64 blocks, one an SM)
BASE_SHAPES = {
    "raft": {40: (27008, 8, 5504, 16), 64: (36224, 6, 8576, 16),
             128: (60928, 3, 17024, 12), 256: (110336, 2, 33920, 6)},
    "microbench": {32: (16512, 10, 4352, 16)},
    "pingpong": {32: (17920, 12, 4352, 16)},
    "broadcast": {40: (27136, 8, 5504, 16)},
    "kvchaos": {40: (27648, 8, 5504, 16)},
    "kvchaos-payload": {40: (33664, 6, 5504, 16)},
    "raftlog": {64: (66048, 3, 8576, 16)},
    "snapshot": {96: (48512, 4, 12800, 16)},
    "twophase": {64: (43392, 5, 8576, 16)},
    "paxos": {64: (48384, 4, 8576, 16)},
    "leasekv": {48: (30208, 7, 6528, 16)},
    "shardkv": {64: (69504, 3, 8576, 16)},
    # the soaks' hunts' libraries, which have taps builds too
    "raftlog-nosync-record": {128: (120448, 1, 17024, 12)},
    "kvchaos-army-nochaos": {160: (71936, 3, 21248, 10)},
}


# the fault-plan phases (36-37): the nemesis soak's shapes
# (tools/nemesis_soak.py), its plans and step caps
NEMESIS_SEEDS = 8192
NEMESIS_KV_WRITES = 10
NEMESIS_KV_KW = dict(pool_size=192, loss_p=0.05)
NEMESIS_STEPS = 4000
# the mixed plan's runs (36.4, 38.6) stop at this cap, not the soak's:
# some of their seeds never halt, so the plain step on the card and both
# CPU samples run to the cap (109.6, 69.1 and 57.6 s at 4,000 steps, and
# 49.6 s and 14.7 s of the first two at 2,000, on an NVIDIA H100 80GB
# HBM3, 700.00 W, and its host: PERF.md); every fault kind has struck
# well before 1,000 (38.6's counters)
MIXED_STEPS = 1000
# what the JAX package's run of tools/nemesis_soak.py 8192 on the CPU
# gives: the lost-write catches of the model's own schedule and of the
# plan; the first failing seed under the plan, its shrink (events kept
# of 4, rounds, candidates), the shrunk plan's hash and the trace. The
# hash hashes repr() of the plan's events: NEMESIS_r08.txt's
# 27d022dfa91ec6e9 is the same plan from before FaultEvent had its
# ``node`` field, which every repr now shows
NEMESIS_BUILTIN_CATCHES = 557
NEMESIS_PLAN_CATCHES = 1609
NEMESIS_FIRST_FAILING = 1
NEMESIS_SHRUNK = dict(events=((212187184, 1, 1, 0, 0),), rounds=2, tested=10,
                      plan_hash="b326c7e871b514ce", trace=0x1A5D2F7E741270A4)

# the storage phases (37.4, 38-39): raftlog durable=True at the store
# soak's shape (tools/store_soak.py), at the nemesis soak's certificate 4
# and at the raftlog bench shape
STORE_SEEDS = 8192
STORE_KW = dict(pool_size=128, loss_p=0.02, clog_backoff_max_ns=2_000_000_000)
STORE_STEPS, EIO_STEPS = 6000, 4000
NEMESIS_RAFT_KW = dict(pool_size=96, loss_p=0.02, clog_backoff_max_ns=2_000_000_000)
# the plain step on the card holds the first this many seeds of the
# store runs (38.2-38.4, 39.1); the kernel runs all 8,192
STORE_PLAIN_SEEDS = 2048
# what the JAX package's runs on the CPU of the same searches give
# (seeds 0..8191, the plans, configs and caps below), printed by
#   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/_torch_store_pins.py 8192
# (failing seeds, overflows, unhalted, sha256 of the trace column)
STORE_PINS = {
    "raft": dict(failing=0, overflowed=0, unhalted=0, traces="5fc40abc7504dff1"),
    "off": dict(failing=0, overflowed=0, unhalted=0, traces="a5f5ff11f1fd9ffe"),
    "store": dict(failing=0, overflowed=0, unhalted=0, traces="5fa40dc6d5b44885"),
    "lie": dict(failing=141, overflowed=0, unhalted=0, traces="8cb5cd76ba5476d0"),
    "nosync": dict(failing=28, overflowed=0, unhalted=0, traces="16329922b5ef438a"),
    "eio": dict(failing=0, overflowed=0, unhalted=0, traces="271f6b0dfd97c3e8"),
}
# certificate 2's fleet totals of met (sync, sync_lost, torn, crash); the
# nosync mutant's first failing seed, all 28 by committed-value loss, and
# its shrink; the EIO storm's seeds with a failed sync
STORE_FLEET = dict(sync=330493, sync_lost=0, torn=1165, crash=8615)
NOSYNC_FIRST, NOSYNC_COMMIT_LOSS = 413, 28
NOSYNC_SHRUNK = dict(
    events=((420795719, 0, 0, 0, 0), (597604476, 1, 0, 0, 0), (177725973, 0, 2, 0, 0),
            (333195096, 1, 2, 0, 0), (190079147, 2, 0, 3, 0), (431238660, 3, 0, 3, 0),
            (190079147, 2, 0, 4, 0), (190079147, 2, 2, 3, 0), (190079147, 2, 2, 4, 0)),
    rounds=13, tested=176, plan_hash="e7a3720e4586196d", trace=0x6A58EE54DE33BEB2)
EIO_SYNC_LOST_SEEDS = 7602


def store_plans() -> dict:
    """tools/store_soak.py's STORE_PLAN and LIE_PLAN, the EIO storm of
    tests/test_lint.py and tools/nemesis_soak.py's RAFT_PLAN, in the
    port's classes."""
    from madsim_tpu_torch.chaos import CrashStorm, DiskFault, FaultPlan, FlappingPartition, GrayFailure

    nodes = (0, 1, 2, 3, 4)
    crash = CrashStorm(targets=nodes, n=2, t_min_ns=150_000_000, t_max_ns=500_000_000,
                       down_min_ns=100_000_000, down_max_ns=400_000_000)
    return {
        "store": FaultPlan((
            crash,
            FlappingPartition(targets=nodes, n_cycles=2, t_min_ns=50_000_000,
                              t_max_ns=400_000_000, dur_min_ns=100_000_000,
                              dur_max_ns=300_000_000, up_min_ns=20_000_000,
                              up_max_ns=200_000_000),
            DiskFault(targets=nodes, n_torn=2, t_min_ns=50_000_000, t_max_ns=500_000_000),
        ), name="store-hunt"),
        "lie": FaultPlan((
            crash,
            DiskFault(targets=nodes, n_torn=0, n_sync_loss=3, t_min_ns=10_000_000,
                      t_max_ns=400_000_000, dur_min_ns=200_000_000, dur_max_ns=600_000_000),
        ), name="lying-disk"),
        "eio": FaultPlan((
            crash,
            DiskFault(targets=nodes, n_torn=0, n_sync_loss=0, n_eio=3, t_min_ns=10_000_000,
                      t_max_ns=400_000_000, dur_min_ns=100_000_000, dur_max_ns=400_000_000),
        ), name="eio-storm"),
        "raft": FaultPlan((
            CrashStorm(targets=nodes, n=2, t_min_ns=100_000_000, t_max_ns=600_000_000,
                       down_min_ns=100_000_000, down_max_ns=500_000_000),
            GrayFailure(targets=nodes, n_links=2, t_min_ns=50_000_000, t_max_ns=500_000_000,
                        dur_min_ns=100_000_000, dur_max_ns=400_000_000, mult_min=4,
                        mult_max=16),
        ), name="raft-nemesis"),
    }


def store_inv(box: dict):
    """The store soak's history invariant, keeping each detector's
    verdicts in ``box``."""
    from madsim_tpu_torch.check import election_safety, recovery_safety
    from madsim_tpu_torch.models.raftlog import OP_COMMIT, OP_ELECT, OP_RECOVER, OP_SYNCED

    def inv(h):
        box["commit"] = election_safety(h, elect_op=OP_COMMIT)
        box["elect"] = election_safety(h, elect_op=OP_ELECT)
        box["recover"] = recovery_safety(h, sync_op=OP_SYNCED, recover_op=OP_RECOVER)
        box["ok"] = box["commit"] & box["elect"] & box["recover"]
        return box["ok"]

    return inv


def recovery_inv(box: dict):
    from madsim_tpu_torch.check import recovery_safety
    from madsim_tpu_torch.models.raftlog import OP_RECOVER, OP_SYNCED

    def inv(h):
        box["ok"] = recovery_safety(h, sync_op=OP_SYNCED, recover_op=OP_RECOVER)
        return box["ok"]

    return inv


def traces_digest(traces) -> str:
    """sha256 of the uint64 trace column, 16 hex digits (as
    tests/_torch_store_pins.py prints it)."""
    import hashlib

    return hashlib.sha256(np.asarray(traces, np.uint64).tobytes()).hexdigest()[:16]


def nemesis_plans() -> dict:
    """tools/nemesis_soak.py's plans, in the port's classes, and a plan
    that mixes every fault spec."""
    from madsim_tpu_torch.chaos import (
        ClockSkew, CrashStorm, DiskFault, Duplicate, FaultPlan, FlappingPartition,
        GrayFailure, Partition, PauseStorm,
    )

    return {
        "kv": FaultPlan((CrashStorm(
            targets=(1, 2, 3, 4), n=2, t_min_ns=20_000_000, t_max_ns=400_000_000,
            down_min_ns=50_000_000, down_max_ns=250_000_000),), name="kv-nemesis"),
        "raft_el": FaultPlan((
            PauseStorm(targets=(0, 1, 2, 3, 4), n=2, t_min_ns=20_000_000,
                       t_max_ns=400_000_000, down_min_ns=50_000_000, down_max_ns=300_000_000),
            GrayFailure(targets=(0, 1, 2, 3, 4), n_links=2, t_min_ns=20_000_000,
                        t_max_ns=400_000_000, dur_min_ns=50_000_000, dur_max_ns=300_000_000,
                        mult_min=4, mult_max=16),
        ), name="raft-election-nemesis"),
        "paxos": FaultPlan((
            CrashStorm(targets=(5, 6, 7), n=2, t_min_ns=30_000_000, t_max_ns=200_000_000,
                       down_min_ns=80_000_000, down_max_ns=300_000_000),
            GrayFailure(targets=(0, 1, 2, 3, 4, 5, 6, 7), n_links=2, t_min_ns=10_000_000,
                        t_max_ns=200_000_000, dur_min_ns=50_000_000, dur_max_ns=200_000_000,
                        mult_min=4, mult_max=16),
        ), name="paxos-nemesis"),
        "twophase": FaultPlan((
            CrashStorm(targets=(1, 2, 3, 4), n=1, t_min_ns=20_000_000, t_max_ns=250_000_000,
                       down_min_ns=100_000_000, down_max_ns=400_000_000),
            Duplicate(t_min_ns=10_000_000, t_max_ns=300_000_000, dur_min_ns=50_000_000,
                      dur_max_ns=300_000_000),
        ), name="twophase-nemesis"),
        "mixed": FaultPlan((
            CrashStorm(targets=(1, 2, 3, 4), n=1), PauseStorm(targets=(1, 2, 3, 4), n=1),
            Partition(targets=(0, 1, 2, 3)),
            Partition(targets=(0, 1, 2), asymmetric=True),
            Partition(targets=(1, 2, 3), partial_p=0.5),
            FlappingPartition(targets=(1, 2, 3), n_cycles=2, asymmetric=True),
            GrayFailure(targets=(0, 1, 2, 3, 4, 5), n_links=2), Duplicate(),
            ClockSkew(targets=(0, 1, 2, 3, 4, 5), n=2),
            DiskFault(targets=(1, 2), n_torn=1, n_sync_loss=1, n_eio=1),
        ), name="mixed"),
    }


def nemesis_cases() -> tuple:
    """Phase 36's cases: (library key, factory, factory kwargs, engine
    kwargs, seeds, plan name, dup_rows, step cap, every seed halts)."""
    from madsim_tpu_torch.models import make_kvchaos, make_paxos, make_raft, make_twophase

    kv = dict(writes=NEMESIS_KV_WRITES, record=True, chaos=False)
    return (
        ("raft-record", make_raft, dict(record=True), dict(pool_size=64, loss_p=0.02),
         65536, "raft_el", False, 2000, True),
        ("kvchaos-bug-nochaos", make_kvchaos, {**kv, "bug": True}, NEMESIS_KV_KW,
         NEMESIS_SEEDS, "kv", False, NEMESIS_STEPS, True),
        ("kvchaos-record-nochaos", make_kvchaos, kv, NEMESIS_KV_KW, NEMESIS_SEEDS, "kv",
         False, NEMESIS_STEPS, True),
        ("kvchaos-record-nochaos-dup", make_kvchaos, kv, NEMESIS_KV_KW, NEMESIS_SEEDS,
         "mixed", True, MIXED_STEPS, False),
        ("paxos-record-nochaos", make_paxos, dict(record=True, chaos=False),
         dict(pool_size=96, loss_p=0.05), NEMESIS_SEEDS, "paxos", False, NEMESIS_STEPS, True),
        ("twophase-record-nochaos", make_twophase, dict(record=True, chaos=False),
         dict(pool_size=96, loss_p=0.05), NEMESIS_SEEDS, "twophase", False, NEMESIS_STEPS,
         False),
        ("twophase-record-nochaos-dup", make_twophase, dict(record=True, chaos=False),
         dict(pool_size=96, loss_p=0.05), NEMESIS_SEEDS, "twophase", True, NEMESIS_STEPS,
         False),
    )


# the model phases, in order: (BENCH_SPECS or SOAK_SPECS name, kernel
# model key, factory keyword arguments); raft, the main path, first
MODEL_PHASES = (
    ("raft", "raft", {}),
    ("microbench", "microbench", {}),
    ("pingpong", "pingpong", {}),
    ("broadcast", "broadcast", {}),
    ("kvchaos", "kvchaos", {}),
    ("kvchaos", "kvchaos-payload", {"payload": True}),
    ("raftlog", "raftlog", {}),
    ("snapshot", "snapshot", {}),
    ("twophase", "twophase", {}),
    ("paxos", "paxos", {}),
    ("leasekv", "leasekv", {}),
    ("shardkv", "shardkv", {}),
)


def record_phases() -> tuple:
    """The record phases (21-30), in the MODEL_PHASES form: (BENCH_SPECS
    or SOAK_SPECS name, kernel model key, factory keyword arguments)."""
    from madsim_tpu_torch.engine.fused import kernel_model
    from madsim_tpu_torch.models import BENCH_SPECS, RECORD_VARIANTS, SOAK_SPECS

    specs = {**BENCH_SPECS, **SOAK_SPECS}
    return tuple((spec_name, kernel_model(specs[spec_name][0](**kw)).key, kw)
                 for spec_name, kw in RECORD_VARIANTS.values())


def family_screens(spec_name: str) -> tuple:
    """The history screens of a record family (phases 33-35)."""
    from madsim_tpu_torch.check import device as dc
    from madsim_tpu_torch.models import leasekv, paxos, raft, raftlog, shardkv, twophase

    return {
        "raft": (dc.election_safety(raft.OP_ELECT),),
        "raftlog": (dc.election_safety(raftlog.OP_ELECT),),
        "twophase": (dc.election_safety(twophase.OP_DECIDE),),
        "paxos": (dc.election_safety(paxos.OP_DECIDE),),
        "kvchaos": (dc.stale_reads(), dc.read_your_writes(), dc.monotonic_reads()),
        "leasekv": (dc.lease_safety(leasekv.OP_PUT, leasekv.OP_EXPIRE),),
        "shardkv": (dc.shard_coverage(shardkv.OP_SHARD_OWN, shardkv.OP_SHARD_WRITE),),
    }[spec_name]


def log(*a) -> None:
    print(*a, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    return float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6


def max_abs_err(a, b, skip: tuple = ()) -> int:
    """Largest |a - b| over every field of two states but ``skip``,
    exact in int."""
    from madsim_tpu_torch.engine import STATE_FIELDS

    worst = 0
    for f in (f for f in STATE_FIELDS if f not in skip):
        x, y = getattr(a, f).cpu(), getattr(b, f).cpu()
        if x.shape != y.shape:
            raise AssertionError(f"field {f}: shape {x.shape} vs {y.shape}")
        diff = x != y
        if bool(diff.any()):
            xs = x[diff].to(torch.int64).tolist()
            ys = y[diff].to(torch.int64).tolist()
            worst = max(worst, max(abs(p - q) for p, q in zip(xs, ys)))
    return worst


def assert_equal(a, b, what: str, skip: tuple = ()) -> None:
    from madsim_tpu_torch.engine import STATE_FIELDS

    bad = [
        f for f in STATE_FIELDS
        if f not in skip and not torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
    ]
    if bad:
        raise AssertionError(f"{what}: fields differ: {bad}")
    log(f"  {what}: every field " + (f"but {', '.join(skip)} " if skip else "") + "equal")


def time_ms(fn, repeats: int, device) -> list:
    """Per-call milliseconds; CUDA events on the card."""
    out = []
    for _ in range(repeats):
        if device.type == "cuda":
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn()
            t1.record()
            torch.cuda.synchronize()
            out.append(t0.elapsed_time(t1))
        else:
            t = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t) * 1e3)
    return out


def host_ms(fn, repeats: int) -> tuple:
    """``(fn()'s last result, per-call milliseconds)`` on the host clock
    between two synchronisations, for calls that end on the host."""
    out, ms = None, []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    return out, ms


def spread(ms: list) -> str:
    return f"{statistics.median(ms):.4f} [{min(ms):.4f}, {max(ms):.4f}]"


def state_bytes(st) -> int:
    from madsim_tpu_torch.engine import STATE_FIELDS

    return sum(getattr(st, f).nbytes for f in STATE_FIELDS)


def entry_phase(device, entry_seeds: int) -> int:
    """Phase 3: raft at the ``entry()`` shape, ``make_step`` and a
    60-step ``make_run`` through the kernel against the plain step."""
    from madsim_tpu_torch.engine import (
        EngineConfig, make_init, make_run, make_run_plain, make_step,
        make_step_plain,
    )
    from madsim_tpu_torch.models import make_raft

    wl, cfg = make_raft(), EngineConfig(pool_size=128, loss_p=0.02)
    log(f"[3] entry shape: raft, pool 128, loss 0.02, {entry_seeds} seeds")
    st = make_init(wl, cfg, device=device)(np.arange(entry_seeds, dtype=np.uint64))
    assert_equal(make_step(wl, cfg)(st), make_step_plain(wl, cfg)(st),
                 "make_step (kernel, 1 step) vs plain")
    entry_k = make_run(wl, cfg, 60)(st)
    entry_p = make_run_plain(wl, cfg, 60)(st)
    assert_equal(entry_k, entry_p, "make_run 60 steps (kernel) vs plain")
    return max_abs_err(entry_k, entry_p)


def plain_reference(wl, cfg, cap: int, st, dup_rows: bool = False, metrics: bool = False,
                    taps: dict | None = None):
    """The plain step until every seed has halted, at most ``cap``
    times (the loop of ``make_run_while_plain``), counting on the way
    what the bound needs: the seed-steps taken before each seed halts,
    and those among them that drop a stale event (a dead or restarted
    destination) and so draw no block. A dispatch folds the trace, a
    reschedule keeps the popped slot valid; a drop does neither.
    Returns ``(state, seed_steps, drops)``."""
    from madsim_tpu_torch.engine import make_step_plain

    step = make_step_plain(wl, cfg, dup_rows, metrics, **(taps or {}))
    seed_steps = drops = 0
    i = 0
    while i < cap and not bool(st.halted.all()):
        nxt = step(st)
        live = ~st.halted
        dropped = live & (nxt.trace == st.trace) & (
            nxt.ev_valid.sum(1) == st.ev_valid.sum(1) - 1)
        seed_steps = seed_steps + live.sum()
        drops = drops + dropped.sum()
        st, i = nxt, i + 1
    return st, int(seed_steps), int(drops)


def raft_extras(device, wl, cfg, cap: int, st, out, med: float) -> None:
    """Raft's own checks and split of the kernel path's time."""
    from madsim_tpu_torch.engine.fused import KERNEL, _first_pass, kernel_model

    if not bool((out.halt_time > 0).all()):
        raise AssertionError("a halted seed has no election latency")
    log(f"  median election latency {float(out.halt_time.double().median()) / 1e6:.3f} ms")
    if device.type == "cuda":
        # where the kernel path's time goes: the run pass (the wrapper's
        # allocations and the run kernel), the drain kernel alone, and
        # the rest; no state is copied
        run_ms = time_ms(lambda: _first_pass(wl, cfg, st, cap, True), REPEATS, device)
        spec = kernel_model(wl)
        _spec, first, iters, tmax = _first_pass(wl, cfg, st, cap, True)
        drain_ms = []
        for _ in range(REPEATS):
            x = type(first)(**{**vars(first), "step": first.step.clone(),
                               "ev_valid": first.ev_valid.clone()})
            drain_ms += time_ms(lambda: KERNEL.drain(spec, x, iters, tmax), 1, device)
        r, d = statistics.median(run_ms), statistics.median(drain_ms)
        log(f"  breakdown (medians): run pass {r:.4f} ms, drain kernel {d:.4f} ms, "
            f"the rest {med - r - d:.4f} ms (no state copy)")


def drain_check(wl, cfg, cap: int, st, dup_rows: bool = False, latency=None,
                retry=None) -> None:
    """The drain kernel alone against its plain version on the card,
    from the run kernel's stop-at-halt outputs: every seed takes its
    ``tmax - iters`` remaining halted steps; ``step`` and ``ev_valid``
    must be equal."""
    from madsim_tpu_torch.engine.fused import KERNEL, _first_pass, drain_plain

    spec, first, iters, tmax = _first_pass(wl, cfg, st, cap, True, dup_rows, latency, retry)
    want_step, want_valid = drain_plain(first.step, first.ev_valid, first.ev_time,
                                        tmax - iters)
    KERNEL.drain(spec, first, iters, tmax)
    if not (torch.equal(first.step, want_step) and torch.equal(first.ev_valid, want_valid)):
        raise AssertionError(f"{spec.key}: the drain kernel disagrees with its plain version")


def model_phase(device, idx: int, spec_name: str, key: str, factory_kw: dict,
                cpu_sample: int, repeats: int, extras=None, refs: dict | None = None) -> dict:
    """One model at its full-width BENCH_SPECS (else SOAK_SPECS) shape,
    through :func:`kernel_phase`."""
    from madsim_tpu_torch.engine import EngineConfig
    from madsim_tpu_torch.models import BENCH_SPECS, SOAK_SPECS

    factory, kw, n_seeds, cap = {**SOAK_SPECS, **BENCH_SPECS}[spec_name]
    log(f"[{idx}] {key}: {kw}, {n_seeds} seeds, make_run_while cap {cap}")
    return kernel_phase(device, key, factory(**factory_kw), EngineConfig(**kw), n_seeds,
                        cap, cpu_sample, repeats, extras, refs=refs)


def plain_head(wl, cfg, n_steps: int, st, dup_rows: bool = False, metrics: bool = False,
               taps: dict | None = None):
    """``make_run_plain(n_steps)`` of ``st`` by a cheaper road with the
    same result: the plain step until every seed has halted (at most
    ``n_steps`` times), then ``drain_plain`` for the rest, which is what
    a halted seed's steps do. The card reference of a cut phase (38.2-38.4,
    39.1); its CPU sample is ``make_run_plain``. Returns ``(state,
    seed-steps, drops)`` of the stepped part, as :func:`plain_reference`."""
    from madsim_tpu_torch.engine.fused import drain_plain

    out, seed_steps, drops = plain_reference(wl, cfg, n_steps, st, dup_rows, metrics, taps)
    taken = int((out.step - st.step)[0]) if st.step.numel() else 0
    if taken < n_steps:
        step, valid = drain_plain(out.step, out.ev_valid, out.ev_time,
                                  torch.full_like(out.step, n_steps - taken))
        out = type(out)(**{**vars(out), "step": step, "ev_valid": valid})
    return out, seed_steps, drops


def head_of(st, k: int):
    from madsim_tpu_torch.engine import STATE_FIELDS

    return type(st)(**{f: getattr(st, f)[:k] for f in STATE_FIELDS})


def kernel_phase(device, key: str, wl, cfg, n_seeds: int, cap: int, cpu_sample: int,
                 repeats: int, extras=None, plan=None, dup_rows: bool = False,
                 all_halt: bool = True, refs: dict | None = None, metrics: bool = False,
                 plain_seeds: int | None = None, reuse: tuple | None = None,
                 taps: dict | None = None, seeds=None, rows=None) -> dict:
    """One library at a full-width shape: the main path through the
    kernel with the launch counts read around it, the checks, every
    field against the plain step (on the device, run and timed once, and
    the first seeds on the CPU), the kernel's time and the bound's
    inputs. ``plan`` seeds each run with its compiled rows, and
    ``dup_rows`` runs the step with the duplication rows; ``metrics``
    folds the fleet counters; ``all_halt`` requires every seed to halt
    with no pool overflow; ``refs[key]`` keeps the plain step's final
    state. ``plain_seeds`` holds the plain step on the card on the first
    that many seeds only (the kernel still runs all of them). ``reuse``
    is ``(state, seed-steps, drops)`` of an earlier phase's plain run on
    the card of the same seeds without metrics: every field but ``met``
    is held against it, the plain step is not run again on the card,
    and the CPU sample, which holds every field, gives the plain ms.
    ``taps`` (``cov_words``, ``cov_hitcount``, ``timeline_cap``,
    ``latency``, ``causal``, ``retry``) runs the coverage taps, the
    timeline ring, the tail-latency tap, the causal fold and the
    client-retry timers on every side. ``seeds`` and ``rows`` (a
    ``PlanRows``) run those seeds with those plan rows instead of seeds
    0..n-1 and ``plan``'s compile: an explore generation's children.
    ``cpu_sample=0`` holds no CPU sample (the card's plain run holds
    every seed).
    ``extras(device, wl, cfg, cap, st, out, ms)`` adds a model's own
    checks and timings, given the kernel's median."""
    from madsim_tpu_torch.engine import make_init, make_run_plain, make_run_while
    from madsim_tpu_torch.engine.fused import KERNEL, halt_counts

    seeds = np.arange(n_seeds, dtype=np.uint64) if seeds is None else seeds
    taps = taps or {}
    if rows is not None:
        slots = int(rows.time.shape[1])
        init = make_init(wl, cfg, device=device, plan_slots=slots, metrics=metrics, **taps)
        st = init(seeds, rows)
        log(f"  {n_seeds} children of an explore generation: {slots} plan slots, "
            f"{int(rows.valid.sum())} events; dup_rows {dup_rows}")
    elif plan is None:
        init = make_init(wl, cfg, device=device, metrics=metrics, **taps)
        st = init(seeds)
    else:
        t = time.perf_counter()
        rows = plan.compile_batch(seeds, wl=wl)
        compile_ms = (time.perf_counter() - t) * 1e3
        init = make_init(wl, cfg, device=device, plan_slots=plan.slots, metrics=metrics,
                         **taps)
        st = init(seeds, rows)
        log(f"  plan {plan.name} ({plan.hash()}): {plan.slots} slots, "
            f"{int(rows.valid.sum())} events over {n_seeds} seeds, compiled in "
            f"{compile_ms:.2f} ms (host); dup_rows {dup_rows}")
    run = make_run_while(wl, cfg, cap, dup_rows=dup_rows, metrics=metrics, **taps)
    if device.type == "cuda":
        torch.cuda.synchronize()
    KERNEL.reset()
    out = run(st)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = KERNEL.counts.get(key, 0)
    drains = KERNEL.counts.get(f"{key}/drain", 0)
    log(f"  main path: {key} run kernel launched {launches} times, drain kernel {drains}")

    n_steps = int(out.step[0])
    if not bool((out.step == n_steps).all()):
        raise AssertionError(f"{key}: seeds disagree on the step count")
    n_over, n_run = int((out.overflow > 0).sum()), int((~out.halted).sum())
    if all_halt and n_over:
        raise AssertionError(f"{key}: pool overflow, {int(out.overflow.sum())} events dropped")
    if all_halt and n_run:
        raise AssertionError(f"{key}: {n_run} seeds did not halt")
    sends = int((out.msg_count - st.msg_count).sum())
    log(f"  {n_seeds - n_run} of {n_seeds} seeds halted within {n_steps} steps; "
        f"{n_over} overflowed; {sends} messages sent; median halt time "
        f"{float(out.halt_time.double().median()) / 1e6:.3f} ms")
    if wl.history is not None:
        if int(out.hist_count.max()) < 1 or int(out.hist_drop.max()) != 0:
            raise AssertionError(f"{key}: no history recorded, or records dropped")
        log(f"  history: {int(out.hist_count.sum())} records in {out.hist_word.shape[1]} rows a "
            f"seed (at most {int(out.hist_count.max())} a seed), none dropped")
    # the plain step's one run: the reference, its time and the counts
    # of the bound (on the first plain_seeds seeds when cut)
    ks = n_seeds if plain_seeds is None else min(plain_seeds, n_seeds)
    if reuse is None:
        got = []
        plain_ms = time_ms(lambda: got.append(
            plain_reference(wl, cfg, cap, st, dup_rows, metrics, taps) if ks == n_seeds
            else plain_head(wl, cfg, n_steps, head_of(st, ks), dup_rows, metrics, taps)),
            1, device)[0]
        ref, seed_steps, drops = got[0]
        what = "make_run_while (kernel) vs plain on the card"
        if ks < n_seeds:
            what = f"first {ks} seeds of the kernel's make_run_while vs plain on the card"
        assert_equal(out if ks == n_seeds else head_of(out, ks), ref, what)
        err = max_abs_err(out if ks == n_seeds else head_of(out, ks), ref)
    else:
        (ref, seed_steps, drops), plain_ms = reuse, None
        assert_equal(out, ref, "make_run_while (kernel) vs the earlier plain run on the card",
                     skip=("met",))
        err = max_abs_err(out, ref, skip=("met",))
    if refs is not None:
        refs[key] = ref
    if device.type == "cuda":
        iters = halt_counts(wl, cfg, cap, st, dup_rows, taps.get("latency"), taps.get("retry"))
        counted = int(iters[:ks].sum())
        if counted != seed_steps:
            raise AssertionError(
                f"{key}: the kernel's stop-at-halt pass counts {counted} "
                f"seed-steps, the plain run {seed_steps}")
        if ks < n_seeds:
            # the bound's work term over every seed: the kernel's own
            # seed-steps; the seeds the plain step did not run count no
            # poll block, so the term stays a lower bound
            seed_steps, drops = int(iters.sum()), drops + int(iters[ks:].sum())
        drain_check(wl, cfg, cap, st, dup_rows, taps.get("latency"), taps.get("retry"))
        log("  drain kernel alone vs its plain version: step and ev_valid equal")
    k = min(cpu_sample, n_seeds)
    t = time.perf_counter()
    if k:
        cpu_ref = make_run_plain(wl, cfg, n_steps, dup_rows, metrics, **taps)(
            head_of(st, k).to("cpu"))
        head = head_of(out, k)
        assert_equal(head, cpu_ref, f"first {k} seeds (kernel) vs plain on the CPU")
        err = max(err, max_abs_err(head, cpu_ref))
    cpu_ms = (time.perf_counter() - t) * 1e3

    ms = time_ms(lambda: run(st), repeats, device)
    med = statistics.median(ms)
    sim_s = float(out.now.double().sum()) / 1e9
    log(f"  kernel ms over {repeats} runs: median {med:.4f}, min {min(ms):.4f}, "
        f"max {max(ms):.4f}, all {[round(x, 4) for x in ms]}")
    if reuse is None:
        log(f"  plain ms (the one correctness run): {plain_ms:.2f}; the CPU sample "
            f"{cpu_ms:.2f} (host clock)")
    else:
        # the plain step with metrics ran only on the CPU
        plain_ms = cpu_ms
        log(f"  plain ms: the CPU sample {cpu_ms:.2f} (host clock; the card's plain run "
            f"is the earlier phase's)")
    log(f"  simulated seconds {sim_s:.3f}: {sim_s / (med / 1e3):.1f} sim_s/s "
        f"(kernel), {sim_s / (plain_ms / 1e3):.1f} sim_s/s (plain)")
    log(f"  state holds {state_bytes(st)} bytes ({state_bytes(st) / n_seeds:.1f} per seed)")
    if extras is not None:
        extras(device, wl, cfg, cap, st, out, med)
    r = dict(
        launches=launches, drains=drains, err=err, ms=med, ms_all=ms, plain_ms=plain_ms,
        pool=cfg.pool_size,
        **bound_terms(st, out, cfg.pool_size, seed_steps, drops, sends),
    )
    if reuse is not None:
        r["plain_ms_of"] = f"make_run_plain on the CPU, first {k} seeds (host clock)"
    if metrics:
        r["met_total"] = out.met.to(torch.int64).sum(0).tolist()
    return r


def bound_terms(st, out, pool: int, seed_steps: int, drops: int, sends: int) -> dict:
    """The bound's inputs: the state's bytes in and out once, and the
    integer work this run's data needs. Every seed-step before its seed
    halts scans the pool; each of them but a stale drop draws the poll
    block, and every send draws its latency block. The handlers' own
    draws are not counted, so the work term stays a lower bound."""
    from madsim_tpu_torch.engine.fused import (
        HISTORY_COLUMNS, KERNEL_FIELDS, READ_ONLY_FIELDS,
    )

    # a workload that records nothing leaves its history columns alone;
    # a record run reads and writes every history row
    read = [f for f in KERNEL_FIELDS
            if st.hist_word.shape[1] > 0 or f not in HISTORY_COLUMNS]
    in_bytes = sum(getattr(st, f).nbytes for f in read)
    written = [f for f in read if f not in READ_ONLY_FIELDS]
    out_bytes = sum(getattr(out, f).nbytes for f in written)
    blocks = seed_steps - drops + sends
    ops = seed_steps * POP_OPS_PER_SLOT * pool + blocks * THREEFRY_OPS
    return dict(in_bytes=in_bytes, out_bytes=out_bytes, ops=ops,
                seed_steps=seed_steps, drops=drops, blocks=blocks)


def launch_shape(spec, pool: int, card: str = "") -> str:
    """G, seeds per block, shared bytes per block and resident blocks
    per SM of a library's run and drain kernels at ``pool``; on an H100
    80GB HBM3 a library of ``BASE_SHAPES`` must have its shape there."""
    from madsim_tpu_torch.engine.fused import KERNEL

    o = KERNEL.occupancy(spec, pool)
    base = BASE_SHAPES.get(spec.key, {}).get(pool)
    got = (o["run_smem_bytes"], o["run_blocks_per_sm"], o["drain_smem_bytes"],
           o["drain_blocks_per_sm"])
    if base is not None and "H100 80GB HBM3" in card and got != base:
        raise AssertionError(f"{spec.key} at pool {pool}: launch shape {got}, "
                             f"BASE_SHAPES has {base}")
    if min(o["run_blocks_per_sm"], o["drain_blocks_per_sm"], o["met_blocks_per_sm"]) < 1:
        raise AssertionError(f"{spec.key} at pool {pool}: no block fits an SM: {o}")
    return (f"G {o['group']}, {o['seeds_per_block']} seeds per block of "
            f"{o['group'] * o['seeds_per_block']} threads; "
            f"run kernel {o['run_smem_bytes']} B shared per block, "
            f"{o['run_blocks_per_sm']} blocks per SM; drain kernel "
            f"{o['drain_smem_bytes']} B, {o['drain_blocks_per_sm']} blocks per SM; run kernel "
            f"with metrics {o['met_smem_bytes']} B, {o['met_blocks_per_sm']} blocks per SM")


def kernel_line(name: str, model_source: str, r: dict, clock_hz: float,
                paths: dict, extra: dict, shape: dict | None = None) -> dict:
    """One entry of the kernels line, with the bound computed here, the
    model's [run, drain] launches on each path it ran (``paths``), its
    runner timings (``extra``) and its library's launch shape at the
    phase's pool (``shape``: the occupancy calculator's numbers and the
    registers of the kernels without the taps)."""
    bytes_ms = (r["in_bytes"] + r["out_bytes"]) / HBM_BYTES_PER_S * 1e3
    ops_ms = r["ops"] / (INT32_LANES * clock_hz) * 1e3
    log(f"  {name} bound: bytes {r['in_bytes']} + {r['out_bytes']} -> {bytes_ms:.5f} ms; "
        f"{r['seed_steps']} seed-steps ({r['drops']} stale drops), {r['blocks']} "
        f"threefry blocks, {r['ops']} int32 ops -> {ops_ms:.5f} ms")
    return {
        "name": name,
        "route": "cuda",
        "source": "madsim_tpu_torch/csrc/run_kernel.cu",
        "model_source": model_source,
        "replaces": "madsim_tpu/engine/vmem.py:110",
        "replaces_fn": "engine/vmem.py:make_run_vmem",
        "launches": r["launches"] + r["drains"],
        "launches_run": r["launches"],
        "launches_drain": r["drains"],
        "max_abs_err": r["err"],
        "max_abs_diff": r["err"],
        "ms": r["ms"],
        "ms_min": min(r["ms_all"]),
        "ms_max": max(r["ms_all"]),
        "plain_ms": r["plain_ms"],
        **({"plain_ms_of": r["plain_ms_of"]} if "plain_ms_of" in r else {}),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "launches_by_path": paths,
        **({"launch_shape": shape} if shape else {}),
        **extra,
    }


def base_registers(build_log: str, pool: int, taps: bool = False) -> dict:
    """The registers of a library's kernels without the taps at ``pool``
    (the run kernel with and without metrics, the drain kernel), from
    nvcc's ``--resource-usage`` lines: ``{kernel: registers}``. With
    ``taps``, those of its taps kernel (``run_kernel<E, MET, true>``)
    with and without metrics instead (``engine.fused.kernel_registers``)."""
    from madsim_tpu_torch.engine.fused import kernel_registers

    return kernel_registers(build_log, pool, taps)


def run_variant(spec, wl, cfg, cap: int, st):
    """make_run_while through the library ``spec`` (a registered
    model's library built at another G): the run kernel, then the
    drain kernel."""
    from madsim_tpu_torch.engine.fused import (
        KERNEL, _tables, config_words, fresh_outputs,
    )

    out = fresh_outputs(st)
    iters = torch.empty_like(st.now)
    tmax = torch.empty((1,), dtype=torch.int64, device=st.device)
    KERNEL.launch(spec, st, out, _tables(wl, st.device), iters, tmax,
                  config_words(wl, cfg), cap, True)
    KERNEL.drain(spec, out, iters, tmax)
    return out


def group_sweep(device, groups: list, keys: list) -> None:
    """Time make_run_while at each model's full-width shape with G =
    each of ``groups`` lanes per seed, in turns (the order rotates each
    round), every variant's output equal to the registered library's."""
    import dataclasses

    from madsim_tpu_torch.engine import EngineConfig, make_init, make_run_while
    from madsim_tpu_torch.engine.fused import MODELS, build_libraries
    from madsim_tpu_torch.models import BENCH_SPECS, SOAK_SPECS

    variants = {
        (k, g): dataclasses.replace(MODELS[k], key=f"{k}-g{g}", group=g)
        for k in keys for g in groups
    }
    t = time.perf_counter()
    build_libraries(variants.values())
    log(f"[sweep] {len(variants)} libraries built in {time.perf_counter() - t:.1f} s")
    phases = {key: (name, kw) for name, key, kw in MODEL_PHASES}
    for key in keys:
        spec_name, factory_kw = phases[key]
        factory, kw, n_seeds, cap = {**SOAK_SPECS, **BENCH_SPECS}[spec_name]
        wl, cfg = factory(**factory_kw), EngineConfig(**kw)
        st = make_init(wl, cfg, device=device)(np.arange(n_seeds, dtype=np.uint64))
        ref = make_run_while(wl, cfg, cap)(st)
        times = {g: [] for g in groups}
        for g in groups:
            assert_equal(run_variant(variants[key, g], wl, cfg, cap, st), ref,
                         f"{key} G={g} vs the registered library")
        for rnd in range(REPEATS):
            order = groups[rnd % len(groups):] + groups[:rnd % len(groups)]
            for g in order:
                spec = variants[key, g]
                times[g] += time_ms(lambda: run_variant(spec, wl, cfg, cap, st), 1, device)
        for g in groups:
            ms = times[g]
            log(f"  {key} G={g}: median {statistics.median(ms):.4f} ms, min {min(ms):.4f}, "
                f"max {max(ms):.4f}; {launch_shape(variants[key, g], cfg.pool_size)}")


def path_launches(fn):
    """``fn()`` with every launch count set to 0 just before it and read
    just after: ``(result, {kernel: launches})``."""
    from madsim_tpu_torch.engine.fused import KERNEL

    torch.cuda.synchronize()
    KERNEL.reset()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(KERNEL.counts)


@contextmanager
def profiler_counts():
    """Collect every ``obs.prof.count_syncs`` count the block makes (the
    device drivers count their generations under
    ``explore.device.counted_syncs``): yields the list they are appended
    to."""
    from madsim_tpu_torch.obs import prof

    counts, real = [], prof.count_syncs

    @contextmanager
    def spy():
        with real() as sc:
            counts.append(sc)
            yield sc

    prof.count_syncs = spy
    try:
        yield counts
    finally:
        prof.count_syncs = real


def sync_text(counts: list) -> str:
    """What the profiler counted, generation by generation."""
    return "; ".join(f"{c.syncs} sync {c.pageable} pageable {c.names}" for c in counts)


def run_drain(counts: dict, key: str) -> list:
    """[run kernel, drain kernel] launches of model ``key``."""
    return [counts.get(key, 0), counts.get(f"{key}/drain", 0)]


def bench_min_size(n_seeds: int) -> int:
    """bench.py's ``_min_size`` rule for the compacted runner."""
    return min(2048, max(n_seeds // 4, 1))


def spec_of(spec_name: str, factory_kw: dict):
    from madsim_tpu_torch.engine import EngineConfig
    from madsim_tpu_torch.models import BENCH_SPECS, SOAK_SPECS

    factory, kw, n_seeds, cap = {**SOAK_SPECS, **BENCH_SPECS}[spec_name]
    return factory(**factory_kw), EngineConfig(**kw), n_seeds, cap


def compacted_phase(device, paths: dict, extra: dict) -> None:
    """Phase 16: the compacted runner's one launch against the plain
    phase program on the card (every banked field, step included) and
    against make_run_while (every field but step)."""
    from madsim_tpu_torch.engine import make_init, make_run_while
    from madsim_tpu_torch.engine.compact import (
        RESULT_FIELDS, make_run_compacted, make_run_compacted_plain,
    )
    from madsim_tpu_torch.engine.convert import state_to_numpy

    for spec_name, key, factory_kw in COMPACT_PHASES:
        wl, cfg, n_seeds, cap = spec_of(spec_name, factory_kw)
        ms_rule = bench_min_size(n_seeds)
        log(f"[16] compacted {key}: {n_seeds} seeds, cap {cap}, shrink 4, min_size {ms_rule}")
        st = make_init(wl, cfg, device=device)(np.arange(n_seeds, dtype=np.uint64))
        run = make_run_compacted(wl, cfg, cap, shrink=4, min_size=ms_rule)
        got, counts = path_launches(lambda: run(st))
        paths.setdefault(key, {})["compacted"] = run_drain(counts, key)
        if run_drain(counts, key) != [1, 0] or set(counts) != {key}:
            raise AssertionError(f"{key}: the compacted path launched {counts}, not one run kernel")
        plain = []
        plain_ms = time_ms(lambda: plain.append(
            make_run_compacted_plain(wl, cfg, cap, shrink=4, min_size=ms_rule)(st)), 1, device)
        lock = state_to_numpy(make_run_while(wl, cfg, cap)(st))
        for f in RESULT_FIELDS:
            a, b = getattr(got, f), getattr(plain[0], f)
            if not np.array_equal(a, b):
                raise AssertionError(f"{key}: compacted field {f} differs from the plain phase program")
            if f != "step" and not np.array_equal(a, lock[f]):
                raise AssertionError(f"{key}: compacted field {f} differs from make_run_while")
        if not got.halted.all() or got.overflow.any():
            raise AssertionError(f"{key}: a compacted seed did not halt or overflowed")
        log(f"  one run kernel launch, no drain; every banked field equal to the plain "
            f"phase program on the card (step max {int(got.step.max())}, min {int(got.step.min())}), "
            f"every field but step equal to make_run_while")
        ms = time_ms(lambda: run.compute(st), REPEATS, device)
        banks = run.compute(st)
        torch.cuda.synchronize()
        t = time.perf_counter()
        run.assemble(banks)
        asm_ms = (time.perf_counter() - t) * 1e3
        med = statistics.median(ms)
        log(f"  compute ms over {REPEATS} runs: median {med:.4f}, min {min(ms):.4f}, "
            f"max {max(ms):.4f}; assemble (host clock) {asm_ms:.3f} ms; plain phase "
            f"program {plain_ms[0]:.2f} ms")
        extra.setdefault(key, {}).update(
            compacted_ms=med, compacted_ms_min=min(ms), compacted_ms_max=max(ms),
            compacted_assemble_ms=asm_ms, compacted_plain_ms=plain_ms[0],
        )


def has_leader(v):
    return (v["node_state"][:, :, 0] == 2).any(axis=1)


def replicas_current(v):
    # too strong on purpose: a chaos kill wipes a RAM-only replica's
    # apply counter, and the re-sync replays only the current write
    return (np.asarray(v["node_state"])[:, 1:5, 1] >= KV_WRITES).all(axis=1)


def search_phase(device, paths: dict) -> None:
    """Phase 17: seed search, compact off and on, a solo repro and the
    oracle replay of the first failing seed."""
    from madsim_tpu_torch.engine import refold, replay, search_seeds
    from madsim_tpu_torch.models import make_kvchaos

    wl, cfg, n_seeds, cap = spec_of("raft", {})
    log(f"[17] search raft: {n_seeds} seeds, cap {cap}, invariant: some node is leader")
    rep, counts = path_launches(lambda: search_seeds(
        wl, cfg, has_leader, n_seeds=n_seeds, max_steps=cap, device=device))
    paths["raft"]["search"] = run_drain(counts, "raft")
    if rep.failing_seeds.size or rep.unhalted_seeds.size or run_drain(counts, "raft")[0] < 1:
        raise AssertionError(f"raft search: {rep.banner()}; launches {counts}")
    log(f"  {rep.banner()}; launches {counts}; build {rep.build_wall_s:.3f} s")

    _wl, cfg, _n, cap = spec_of("kvchaos", {})
    wl, n_seeds = make_kvchaos(writes=KV_WRITES), 4096
    log(f"[17] search kvchaos writes={KV_WRITES}: {n_seeds} seeds, cap {cap}, "
        f"a too-strong invariant")
    full, counts = path_launches(lambda: search_seeds(
        wl, cfg, replicas_current, n_seeds=n_seeds, max_steps=cap, device=device))
    fast, counts_c = path_launches(lambda: search_seeds(
        wl, cfg, replicas_current, n_seeds=n_seeds, max_steps=cap, compact=True, device=device))
    paths["kvchaos"]["search"] = run_drain(counts, "kvchaos")
    paths["kvchaos"]["search_compact"] = run_drain(counts_c, "kvchaos")
    n_bad = full.failing_seeds.size
    if not 0 < n_bad < n_seeds:
        raise AssertionError(f"kvchaos search found {n_bad} of {n_seeds} failing seeds")
    for attr in ("ok", "halted", "traces", "failing_seeds"):
        if not np.array_equal(getattr(full, attr), getattr(fast, attr)):
            raise AssertionError(f"kvchaos search: compact on and off differ in {attr}")
    if run_drain(counts, "kvchaos") != [1, 1] or run_drain(counts_c, "kvchaos") != [1, 0]:
        raise AssertionError(f"kvchaos search launches: {counts}, compact {counts_c}")
    log("  " + full.banner(limit=3).replace("\n", "\n  "))
    log(f"  compact on and off: the same verdicts and traces; launches {counts} and {counts_c}")
    bad = int(full.failing_seeds[0])
    want = int(full.traces[list(full.seeds).index(bad)])
    solo = search_seeds(wl, cfg, replicas_current, n_seeds=1, max_steps=cap, seed_base=bad,
                        device=device)
    if solo.failing_seeds.tolist() != [bad] or int(solo.traces[0]) != want:
        raise AssertionError(f"kvchaos seed {bad} does not reproduce alone")
    events, res = replay(wl, cfg, bad, cap)
    if not refold(events, wl) == res.trace == want:
        raise AssertionError(f"kvchaos seed {bad}: the replay does not refold to the kernel's trace")
    log(f"  seed {bad} fails alone with trace {want:#018x}; its oracle replay "
        f"({len(events)} events) refolds to it")


def measure_phase(device, paths: dict) -> None:
    """Phase 18: the measurement harness on the card."""
    from madsim_tpu_torch.engine.measure import (
        measure_latency, measure_throughput, null_dispatch_stats,
    )

    wl, cfg, n_seeds, cap = spec_of("raft", {})
    log(f"[18] measure_throughput raft: {n_seeds} seeds, cap {cap}, target 1.0 s, 3 dispatches")
    thr, counts = path_launches(lambda: measure_throughput(
        wl, cfg, cap, n_seeds, target_wall_s=1.0, n_measure=3, seed_mod=524288,
        min_size=bench_min_size(n_seeds), device=device))
    paths["raft"]["measure"] = run_drain(counts, "raft")
    log(f"  {json.dumps(thr)}; launches {counts}")
    wl, cfg, _n, cap = spec_of("pingpong", {})
    log(f"[18] measure_latency pingpong: cap {cap}, target 0.5 s")
    lat, counts_p = path_launches(lambda: measure_latency(
        wl, cfg, cap, target_wall_s=0.5, seed_mod=131072, device=device))
    paths["pingpong"]["measure"] = run_drain(counts_p, "pingpong")
    log(f"  {json.dumps(lat)}; launches {counts_p}")
    for name, rec, c in (("raft", thr, counts), ("pingpong", lat, counts_p)):
        if rec["overflow"] or not rec["all_halted"] or c.get(name, 0) < 1 or len(c) != 1:
            raise AssertionError(f"{name} measurement: {rec}; launches {c}")
    log(f"  null dispatch: {json.dumps(null_dispatch_stats(device=device))}")


def verify_phase(device, paths: dict) -> None:
    """Phase 19: the determinism checks on the card."""
    from madsim_tpu_torch.engine import check_determinism, check_layouts

    wl, cfg, n_seeds, _cap = spec_of("raft", {})
    seeds = np.arange(n_seeds, dtype=np.uint64)
    log(f"[19] check_determinism and check_layouts raft: {n_seeds} seeds, 60 steps")
    _, counts = path_launches(lambda: (check_determinism(wl, cfg, seeds, 60, device=device),
                                       check_layouts(wl, cfg, seeds, 60, device=device)))
    paths["raft"]["verify"] = run_drain(counts, "raft")
    if run_drain(counts, "raft") != [3, 0]:
        raise AssertionError(f"the determinism checks launched {counts}")
    log(f"  two kernel runs agree; the kernel equals the plain step on the card and the "
        f"first 256 seeds on the CPU; launches {counts}")


def checkpoint_phase(device, paths: dict) -> None:
    """Phase 20: save after 20 steps, load, 580 more steps: equal to the
    uninterrupted 600-step run in every field."""
    from pathlib import Path

    from madsim_tpu_torch.engine import load_checkpoint, make_init, make_run, save_checkpoint

    wl, cfg, n_seeds, cap = spec_of("raft", {})
    log(f"[20] checkpoint raft: {n_seeds} seeds, 20 steps, save, load, {cap - 20} more")
    path = Path(__file__).resolve().parent / "build" / "checkpoints" / "chip_smoke_raft.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    st = make_init(wl, cfg, device=device)(np.arange(n_seeds, dtype=np.uint64))

    def resume():
        save_checkpoint(str(path), make_run(wl, cfg, 20)(st), cfg)
        return make_run(wl, cfg, cap - 20)(load_checkpoint(str(path), cfg, device=device))

    try:
        resumed, counts = path_launches(resume)
        size = path.stat().st_size
    finally:
        path.unlink(missing_ok=True)
    paths["raft"]["checkpoint"] = run_drain(counts, "raft")
    assert_equal(resumed, make_run(wl, cfg, cap)(st), "resumed vs uninterrupted 600-step run")
    log(f"  checkpoint file {size} bytes; launches {counts}")


def history_search_phase(device, paths: dict) -> np.ndarray:
    """Phase 31: the lost-write hunt over recorded histories on the card,
    compact off and on, against the plain step's run on the card.
    Returns the failing seeds."""
    from madsim_tpu_torch.check import BatchHistory, check_kv, read_your_writes, stale_reads
    from madsim_tpu_torch.engine import (
        EngineConfig, make_init, make_run_while_plain, search_seeds,
    )
    from madsim_tpu_torch.engine.convert import state_to_numpy
    from madsim_tpu_torch.engine.fused import kernel_model
    from madsim_tpu_torch.models import make_kvchaos

    wl, cfg = make_kvchaos(writes=KV_WRITES, record=True, bug=True), EngineConfig(**HIST_SEARCH_KW)
    n, cap, key = HIST_SEARCH_SEEDS, HIST_SEARCH_CAP, kernel_model(wl).key
    log(f"[31] history search {wl.name} writes={KV_WRITES}: {HIST_SEARCH_KW}, {n} seeds, "
        f"cap {cap}, history invariant stale_reads & read_your_writes")
    final = {}

    def durability(v):
        # the final-state invariant, kept aside: it must pass every seed
        ns = np.asarray(v["node_state"])
        final["ok"] = (ns[:, 5, 0] == KV_WRITES) & ((ns[:, 1:5, 0] >= KV_WRITES).sum(axis=1) >= 3)
        return np.ones_like(final["ok"])

    def lost_write(h):
        return stale_reads(h) & read_your_writes(h)

    reps = {}
    for compact, want in ((False, [1, 1]), (True, [1, 0])):
        rep, counts = path_launches(lambda: search_seeds(
            wl, cfg, durability, n_seeds=n, max_steps=cap, history_invariant=lost_write,
            compact=compact, device=device))
        paths.setdefault(key, {})["history_search_compact" if compact else "history_search"] = \
            run_drain(counts, key)
        if run_drain(counts, key) != want or len(counts) != sum(want):
            raise AssertionError(f"history search (compact {compact}) launched {counts}")
        if not final["ok"].all():
            raise AssertionError("the final-state durability invariant failed a seed")
        reps[compact] = rep
    rep = reps[False]
    if not 0 < rep.failing_seeds.size < n or rep.overflowed.any():
        raise AssertionError(f"history search: {rep.banner()}")
    for attr in ("ok", "halted", "traces", "failing_seeds", "hist_dropped"):
        if not np.array_equal(getattr(rep, attr), getattr(reps[True], attr)):
            raise AssertionError(f"history search: compact on and off differ in {attr}")
    # the plain step's run on the card, judged by the same rule
    plain = []
    plain_ms = time_ms(lambda: plain.append(state_to_numpy(make_run_while_plain(wl, cfg, cap)(
        make_init(wl, cfg, device=device)(rep.seeds)))), 1, device)
    view = plain[0]
    h = BatchHistory.from_view(view)
    if (h.drop > 0).any() or (view["overflow"] > 0).any():
        raise AssertionError("the plain run dropped records or events")
    bad = rep.seeds[~(lost_write(h) & view["halted"])]
    if not np.array_equal(bad, rep.failing_seeds):
        raise AssertionError(f"history search: the kernel flags {rep.failing_seeds.tolist()}, "
                             f"the plain step {bad.tolist()}")
    for s in bad[:3]:
        if check_kv(h.ops(int(np.searchsorted(rep.seeds, s)))).ok:
            raise AssertionError(f"seed {int(s)}: the exact checker finds it linearizable")
    log("  " + rep.banner(limit=3).replace("\n", "\n  "))
    log(f"  the durability invariant passes all {n} seeds; the history checkers flag "
        f"{bad.size} ({bad[:32].tolist()}), the same seeds as the plain step's run on the "
        f"card ({plain_ms[0]:.1f} ms) "
        f"and the exact checker; compact on and off agree; launches {paths[key]}")
    return bad


def screen_phase(device, key: str, screens: tuple, out, run_ms: float) -> dict:
    """Phase 33: a record library's final history columns judged on the
    card by ``screens``, against the numpy checkers on the host copy;
    the screens' (to the packed verdict words) and the fold's times by
    CUDA events beside the run kernel's, the host path's (copy the four
    columns, then numpy) on the host clock, and the bytes each moves to
    the host: the words and the flagged seeds' two history columns, or
    the four columns."""
    from madsim_tpu_torch.check import BatchHistory
    from madsim_tpu_torch.check.device import (
        fold_verified, pack_verdicts, screen_ok, screens_invariant, unpack_verdicts,
    )

    cols = [out.hist_word, out.hist_t, out.hist_count, out.hist_drop]
    n, h_dim = out.hist_word.shape[:2]
    inv = screens_invariant(screens)

    def screen():
        return pack_verdicts(screen_ok(screens, *cols))

    words = screen()
    if words.device.type != "cuda":
        raise AssertionError(f"{key}: the screens left the card")
    ok = unpack_verdicts(words, n)
    host, host_path_ms = host_ms(lambda: inv(BatchHistory(*(c.cpu().numpy() for c in cols))), REPEATS)
    if not np.array_equal(ok, host):
        raise AssertionError(f"{key}: the screens flag {np.nonzero(~ok)[0].tolist()[:16]}, "
                             f"the host checkers {np.nonzero(~host)[0].tolist()[:16]}")
    screen_ms = time_ms(screen, REPEATS, device)
    ok_t = screen_ok(screens, *cols)
    word2, _t2, count2, fold = fold_verified(*cols, ok_t)
    if not torch.equal(count2 + fold, out.hist_count):
        raise AssertionError(f"{key}: the fold lost records")
    fold_ms = time_ms(lambda: fold_verified(*cols, ok_t), REPEATS, device)
    n_flag = int((~ok).sum())
    row_bytes = h_dim * (5 * 4 + 8)
    dev_bytes = words.nbytes + n_flag * row_bytes
    host_bytes = sum(c.nbytes for c in cols)
    log(f"  [33] {key}: screens {inv.__name__} flag {n_flag} of {n} seeds "
        f"({np.nonzero(~ok)[0][:8].tolist()}), equal to the host checkers; "
        f"{int(fold.sum())} records fold out of {int(out.hist_count.sum())}")
    log(f"    screens ms {spread(screen_ms)}, fold ms {spread(fold_ms)}, beside the run "
        f"kernel's {run_ms:.4f} ms; host path (copy + numpy) ms {spread(host_path_ms)}")
    log(f"    bytes to the host: {dev_bytes} (verdict words + flagged rows) against "
        f"{host_bytes} (the four history columns)")
    return dict(
        screen_ms=statistics.median(screen_ms), screen_ms_min=min(screen_ms),
        screen_ms_max=max(screen_ms), fold_ms=statistics.median(fold_ms),
        fold_ms_min=min(fold_ms), fold_ms_max=max(fold_ms),
        host_path_ms=statistics.median(host_path_ms), host_path_ms_min=min(host_path_ms),
        host_path_ms_max=max(host_path_ms), screen_bytes=dev_bytes, host_path_bytes=host_bytes,
        flagged=n_flag,
    )


def device_check_phase(device, paths: dict, want: np.ndarray) -> None:
    """Phase 34: phase 31's hunt with ``device_check``, lockstep and
    compacted; both must flag phase 31's seeds ``want``."""
    from madsim_tpu_torch.check import check_kv
    from madsim_tpu_torch.check.device import read_your_writes, screens_invariant, stale_reads
    from madsim_tpu_torch.engine import EngineConfig, make_init, make_run_while, search_seeds
    from madsim_tpu_torch.engine.compact import make_run_compacted
    from madsim_tpu_torch.engine.fused import kernel_model
    from madsim_tpu_torch.models import make_kvchaos

    wl, cfg = make_kvchaos(writes=KV_WRITES, record=True, bug=True), EngineConfig(**HIST_SEARCH_KW)
    n, cap, key = HIST_SEARCH_SEEDS, HIST_SEARCH_CAP, kernel_model(wl).key
    screens = (stale_reads(), read_your_writes())
    log(f"[34] device-checked history search {wl.name}: {n} seeds, cap {cap}, screens "
        f"stale_reads & read_your_writes on the card")
    reps, times = {}, {}
    for compact, launches in ((False, [1, 1]), (True, [1, 0])):
        def search(compact=compact):
            return search_seeds(wl, cfg, None, n_seeds=n, max_steps=cap, device_check=screens,
                                compact=compact, device=device)

        rep, counts = path_launches(search)
        name = "search_device_check_compact" if compact else "search_device_check"
        paths.setdefault(key, {})[name] = run_drain(counts, key)
        if run_drain(counts, key) != launches or len(counts) != sum(launches):
            raise AssertionError(f"{name} launched {counts}")
        if not (np.array_equal(rep.failing_seeds, want)
                and np.array_equal(rep.seeds[rep.flagged_idx], want)):
            raise AssertionError(f"{name}: flags {rep.failing_seeds.tolist()}, phase 31 "
                                 f"{want.tolist()}")
        fh = rep.flagged_history
        for i in range(len(fh)):
            if check_kv(fh.ops(i)).ok:
                raise AssertionError(f"{name}: flagged seed {int(rep.flagged_idx[i])} is linearizable")
        _r, times[name] = host_ms(search, REPEATS)
        reps[compact] = rep
        log("  " + rep.banner(limit=2).replace("\n", "\n  "))
        log(f"  {name}: flags phase 31's {want.size} seeds, each failing the exact checker; "
            f"launches {counts}; ms {spread(times[name])}")
    if not np.array_equal(reps[False].verdict_words, reps[True].verdict_words):
        raise AssertionError("device_check: lockstep and compact verdict words differ")
    _r, inv_ms = host_ms(lambda: search_seeds(
        wl, cfg, None, n_seeds=n, max_steps=cap, history_invariant=screens_invariant(screens),
        device=device), REPEATS)
    log(f"  the same search with history_invariant (host numpy): ms {spread(inv_ms)}")
    # the screened compacted run against the lockstep columns
    st = make_init(wl, cfg, device=device)(np.arange(n, dtype=np.uint64))
    lock = make_run_while(wl, cfg, cap)(st)
    folded = make_run_compacted(wl, cfg, cap, hist_screen=screens)(st)
    flag = ~folded.hist_ok
    if not np.array_equal(folded.hist_count + folded.hist_fold, lock.hist_count.cpu().numpy()):
        raise AssertionError("hist_screen: hist_count + hist_fold differs from the lockstep count")
    for f in ("hist_word", "hist_t"):
        if not np.array_equal(getattr(folded, f)[flag], getattr(lock, f).cpu().numpy()[flag]):
            raise AssertionError(f"hist_screen: a flagged seed's {f} is not verbatim")
    if not np.array_equal(np.nonzero(flag)[0], reps[False].flagged_idx):
        raise AssertionError("hist_screen: the banked verdicts differ from the lockstep screens")
    log(f"  hist_screen: {int(folded.hist_fold.sum())} records folded out of "
        f"{int(lock.hist_count.sum())}, {int(folded.hist_count.max())} rows copied a seed of "
        f"{lock.hist_word.shape[1]}; count + fold equals the lockstep count, the {int(flag.sum())} "
        f"flagged seeds verbatim")


def main_path_screen_phase(device, paths: dict, extra: dict) -> None:
    """Phase 35: raft-record at 65,536 seeds, searched with its election
    screen on the card, lockstep and compacted, each timed and held
    against the host path's verdicts."""
    from madsim_tpu_torch.check.device import screens_invariant
    from madsim_tpu_torch.engine import search_seeds
    from madsim_tpu_torch.engine.fused import kernel_model

    wl, cfg, n, cap = spec_of("raft", {"record": True})
    key, screens = kernel_model(wl).key, family_screens("raft")
    log(f"[35] main path with its screen: {wl.name}, {n} seeds, cap {cap}, "
        f"device_check {screens_invariant(screens).__name__}")

    def host_path():
        return search_seeds(wl, cfg, None, n_seeds=n, max_steps=cap,
                            history_invariant=screens_invariant(screens), device=device)

    host, inv_ms = host_ms(host_path, REPEATS)
    out = {"history_invariant_ms": inv_ms}
    for compact, launches in ((False, [1, 1]), (True, [1, 0])):
        def search(compact=compact):
            return search_seeds(wl, cfg, None, n_seeds=n, max_steps=cap, device_check=screens,
                                compact=compact, device=device)

        rep, counts = path_launches(search)
        name = "search_device_check_compact" if compact else "search_device_check"
        paths.setdefault(key, {})[name] = run_drain(counts, key)
        if run_drain(counts, key) != launches or len(counts) != sum(launches):
            raise AssertionError(f"{name} launched {counts}")
        for attr in ("ok", "failing_seeds", "traces", "halted"):
            if not np.array_equal(getattr(rep, attr), getattr(host, attr)):
                raise AssertionError(f"{name}: {attr} differs from the host path")
        if not np.array_equal(rep.flagged_idx, np.nonzero(~host.ok & host.halted)[0]):
            raise AssertionError(f"{name}: flagged seeds differ from the host path")
        _r, out[f"{name}_ms"] = host_ms(search, REPEATS)
        log("  " + rep.banner(limit=2).replace("\n", "\n  ") + f"\n  launches {counts}")
    for name, ms in out.items():
        log(f"  {name.removesuffix('_ms')} ms {spread(ms)}")
    extra.setdefault(key, {}).update(
        {k: statistics.median(v) for k, v in out.items()}
        | {f"{k}_all": v for k, v in out.items()})


def record_checkpoint_phase(device, paths: dict) -> None:
    """Phase 32: leasekv-record saved after 150 steps, loaded and run
    450 more: equal in every field, the history included, to the
    600-step run."""
    from pathlib import Path

    from madsim_tpu_torch.engine import load_checkpoint, make_init, make_run, save_checkpoint
    from madsim_tpu_torch.engine.fused import kernel_model

    wl, cfg, n_seeds, _cap = spec_of("leasekv", {"record": True})
    key, split, total = kernel_model(wl).key, 150, 600
    log(f"[32] checkpoint {wl.name}: {n_seeds} seeds, {split} steps, save, load, "
        f"{total - split} more")
    path = Path(__file__).resolve().parent / "build" / "checkpoints" / "chip_smoke_leasekv.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    st = make_init(wl, cfg, device=device)(np.arange(n_seeds, dtype=np.uint64))
    mid = {}

    def resume():
        mid["st"] = make_run(wl, cfg, split)(st)
        save_checkpoint(str(path), mid["st"], cfg)
        return make_run(wl, cfg, total - split)(load_checkpoint(str(path), cfg, device=device))

    try:
        resumed, counts = path_launches(resume)
        size = path.stat().st_size
    finally:
        path.unlink(missing_ok=True)
    paths.setdefault(key, {})["checkpoint"] = run_drain(counts, key)
    if int(mid["st"].hist_count.min()) < 1 or run_drain(counts, key) != [2, 0]:
        raise AssertionError(f"{key} checkpoint: no history at the split, or launches {counts}")
    assert_equal(resumed, make_run(wl, cfg, total)(st), f"resumed vs uninterrupted {total}-step run")
    log(f"  checkpoint file {size} bytes with {int(mid['st'].hist_count.sum())} history "
        f"records; launches {counts}")


def plan_phases(device, results: list, paths: dict, extra: dict, card: str) -> dict:
    """Phase 36: each fault-plan library at full width under its plan,
    held as in phases 4-15; kvchaos-bug with its own chaos timed at the
    same shape beside the plan run. Returns the plain step's final
    states, by library key."""
    from madsim_tpu_torch.engine import EngineConfig, make_init, make_run_while
    from madsim_tpu_torch.engine.fused import kernel_model
    from madsim_tpu_torch.models import make_kvchaos

    plans, refs = nemesis_plans(), {}
    for i, (key, factory, fkw, kw, n, plan, dup, cap, all_halt) in enumerate(nemesis_cases()):
        wl, cfg = factory(**fkw), EngineConfig(**kw)
        if kernel_model(wl, dup).key != key:
            raise AssertionError(f"{key}: the registry picks {kernel_model(wl, dup).key}")
        log(f"[36.{i + 1}] {key}: {kw}, {n} seeds, make_run_while cap {cap}, plan {plan}")
        r = kernel_phase(device, key, wl, cfg, n, cap, CPU_SAMPLE, REPEATS, plan=plans[plan],
                         dup_rows=dup, all_halt=all_halt, refs=refs)
        if r["launches"] != 1 or r["drains"] != 1 or r["err"] != 0:
            raise AssertionError(f"{key}: launches {r['launches']}, {r['drains']}; "
                                 f"error {r['err']}")
        # a plan run of a library that phases 4-30 ran too is its own entry
        results.append((key, f"make_run_fused/{key}/plan-{plan}",
                        f"madsim_tpu_torch/csrc/{kernel_model(wl, dup).header}", r))
        paths.setdefault(key, {})["run_while_plan"] = [r["launches"], r["drains"]]
        extra.setdefault(key, {})["plan_hash"] = plans[plan].hash()
    # kvchaos-bug with its own chaos, at the plan run's shape, no plan
    wl = make_kvchaos(writes=NEMESIS_KV_WRITES, record=True, bug=True)
    cfg = EngineConfig(**NEMESIS_KV_KW)
    st = make_init(wl, cfg, device=device)(np.arange(NEMESIS_SEEDS, dtype=np.uint64))
    run = make_run_while(wl, cfg, NEMESIS_STEPS)
    ms = time_ms(lambda: run(st), REPEATS, device)
    plan_ms = next(r["ms"] for k, _n, _s, r in results if k == "kvchaos-bug-nochaos")
    extra["kvchaos-bug-nochaos"].update(sibling_chaos_ms=statistics.median(ms),
                                        sibling_chaos_ms_all=ms)
    log(f"  kvchaos-bug-nochaos under the plan {plan_ms:.4f} ms beside kvchaos-bug with its "
        f"own chaos {spread(ms)} ms ({NEMESIS_SEEDS} seeds, pool 192, this call, {card})")
    return refs


def lost_write_inv(box: dict):
    """The soak's kvchaos history invariant, keeping its verdicts."""
    from madsim_tpu_torch.check import read_your_writes, stale_reads

    def inv(h):
        box["ok"] = stale_reads(h) & read_your_writes(h)
        return box["ok"]

    return inv


def flagged_by_plain(ref, inv) -> np.ndarray:
    """The seeds the soak's rule flags in a plain run's final state: the
    history invariant fails and neither the pool nor the history
    overflowed."""
    from madsim_tpu_torch.check import BatchHistory
    from madsim_tpu_torch.engine.convert import state_to_numpy

    view = state_to_numpy(ref)
    over = (view["overflow"] > 0) | (view["hist_drop"] > 0)
    ok = np.asarray(inv(BatchHistory.from_view(view)), bool)
    return np.nonzero(~ok & ~over)[0].astype(np.uint64)


def nemesis_phase(device, refs: dict, paths: dict, extra: dict) -> tuple:
    """Phase 37: the nemesis certificates 1-3 and 5-7 on the card, the
    counts and the shrunk repro pinned from the JAX package's soak.
    Returns ``(workload, config, first failing seed, shrunk plan, the
    plan's catches)`` for the forensics phase."""
    from madsim_tpu_torch.chaos import shrink_plan
    from madsim_tpu_torch.check import election_safety
    from madsim_tpu_torch.engine import EngineConfig, make_init, make_run_while_plain, search_seeds
    from madsim_tpu_torch.engine.fused import kernel_model
    from madsim_tpu_torch.models import make_kvchaos, make_paxos, make_raft, make_twophase
    from madsim_tpu_torch.models.paxos import OP_DECIDE as PX_OP_DECIDE
    from madsim_tpu_torch.models.raft import OP_ELECT
    from madsim_tpu_torch.models.twophase import OP_DECIDE as TP_OP_DECIDE

    plans, n = nemesis_plans(), NEMESIS_SEEDS
    kv_cfg = EngineConfig(**NEMESIS_KV_KW)
    timing = {}

    def search(name, wl, cfg, plan, cap, inv, box, **kw):
        key = kernel_model(wl, bool(plan and plan.uses_dup())).key

        def go():
            return search_seeds(wl, cfg, None, n_seeds=n, max_steps=cap,
                                history_invariant=inv, plan=plan, device=device, **kw)

        rep, counts = path_launches(go)
        if run_drain(counts, key) != [1, 1] or len(counts) != 2:
            raise AssertionError(f"{name}: launched {counts}")
        paths.setdefault(key, {})[f"nemesis_{name}"] = run_drain(counts, key)
        verdict = box["ok"].copy()
        _r, timing[name] = host_ms(go, 3)
        return rep, verdict

    # 1. amplification: the model's own kill against the plan
    wl_b = make_kvchaos(writes=NEMESIS_KV_WRITES, record=True, bug=True)
    box = {}
    rep_b, ok_b = search("builtin", wl_b, kv_cfg, None, NEMESIS_STEPS, lost_write_inv(box), box)
    caught_b = rep_b.seeds[~ok_b & ~rep_b.overflowed]
    plain_b = make_run_while_plain(wl_b, kv_cfg, NEMESIS_STEPS)(
        make_init(wl_b, kv_cfg, device=device)(rep_b.seeds))
    if not np.array_equal(caught_b, flagged_by_plain(plain_b, lost_write_inv({}))):
        raise AssertionError("certificate 1: the built-in run's catches differ from the plain step's")
    wl_n = make_kvchaos(writes=NEMESIS_KV_WRITES, record=True, bug=True, chaos=False)
    box = {}
    rep_n, ok_n = search("plan", wl_n, kv_cfg, plans["kv"], NEMESIS_STEPS,
                         lost_write_inv(box), box)
    caught_n = rep_n.seeds[~ok_n & ~rep_n.overflowed]
    if not np.array_equal(caught_n, flagged_by_plain(refs["kvchaos-bug-nochaos"],
                                                     lost_write_inv({}))):
        raise AssertionError("certificate 1: the plan run's catches differ from the plain step's")
    if (caught_b.size, caught_n.size) != (NEMESIS_BUILTIN_CATCHES, NEMESIS_PLAN_CATCHES):
        raise AssertionError(f"certificate 1: {caught_b.size} and {caught_n.size} catches, the "
                             f"JAX package {NEMESIS_BUILTIN_CATCHES} and {NEMESIS_PLAN_CATCHES}")
    if caught_n.size <= caught_b.size or rep_n.unhalted_seeds.size:
        raise AssertionError("certificate 1: the plan does not amplify, or a seed did not halt")
    log(f"[37.1] amplification: the plan ({rep_n.plan_hash}) catches the lost write on "
        f"{caught_n.size} of {n} seeds, the model's own kill on {caught_b.size} "
        f"({caught_n.size / caught_b.size:.2f}x), each set equal to the plain step's on the "
        f"card and to the JAX package's counts; search ms {spread(timing['plan'])} and "
        f"{spread(timing['builtin'])}")
    # 2. the clean model under the same plan
    box = {}
    rep_c, ok_c = search("clean", make_kvchaos(writes=NEMESIS_KV_WRITES, record=True,
                                               chaos=False),
                         kv_cfg, plans["kv"], NEMESIS_STEPS, lost_write_inv(box), box)
    bad = (int((~ok_c & ~rep_c.overflowed).sum()), int(rep_c.overflowed.sum()),
           int(rep_c.unhalted_seeds.size))
    if bad != (0, 0, 0):
        raise AssertionError(f"certificate 2: violations, overflows, unhalted {bad}")
    log(f"[37.2] clean model under the plan: 0 violations, 0 overflows, 0 unhalted; "
        f"search ms {spread(timing['clean'])}")
    # 3. shrink the first failing seed, then replay the shrunk plan
    first = int(caught_n[0])
    t = time.perf_counter()
    res, counts = path_launches(lambda: shrink_plan(
        wl_n, kv_cfg, first, plans["kv"], history_invariant=lost_write_inv({}),
        max_steps=NEMESIS_STEPS, device=device))
    shrink_ms = (time.perf_counter() - t) * 1e3
    key = kernel_model(wl_n).key
    paths[key]["shrink"] = run_drain(counts, key)
    got = dict(events=tuple(tuple(vars(e).values()) for e in res.events), rounds=res.rounds,
               tested=res.tested, plan_hash=res.plan.hash(), trace=res.trace)
    if first != NEMESIS_FIRST_FAILING or got != NEMESIS_SHRUNK:
        raise AssertionError(f"certificate 3: seed {first} shrinks to {got}; the JAX package: "
                             f"seed {NEMESIS_FIRST_FAILING}, {NEMESIS_SHRUNK}")
    box = {}
    rep_r = search_seeds(wl_n, kv_cfg, None, n_seeds=1, max_steps=NEMESIS_STEPS,
                         seed_base=first, history_invariant=lost_write_inv(box),
                         plan=res.plan, device=device)
    if rep_r.failing_seeds.tolist() != [first] or int(rep_r.traces[0]) != res.trace:
        raise AssertionError("certificate 3: the shrunk plan's replay diverged")
    log("[37.3] " + res.banner().replace("\n", "\n  "))
    log(f"  {res.original_events} -> {len(res.events)} events in {res.rounds} rounds "
        f"({res.tested} candidates), each round one run and one drain launch "
        f"({paths[key]['shrink']}); {shrink_ms:.1f} ms; the replay fails with the same trace")
    # 5-7. raft election, paxos and twophase under their plans
    certs = (
        ("5", "raft_election", make_raft(record=True), dict(pool_size=64, loss_p=0.02),
         "raft_el", 2000, OP_ELECT, True),
        ("6", "paxos", make_paxos(record=True, chaos=False), dict(pool_size=96, loss_p=0.05),
         "paxos", NEMESIS_STEPS, PX_OP_DECIDE, True),
        ("7", "twophase", make_twophase(record=True, chaos=False),
         dict(pool_size=96, loss_p=0.05), "twophase", NEMESIS_STEPS, TP_OP_DECIDE, False),
    )
    for num, name, wl, kw, plan, cap, op, halt in certs:
        box = {}

        def inv(h, op=op, box=box):
            box["ok"] = election_safety(h, elect_op=op)
            return box["ok"]

        rep, ok = search(name, wl, EngineConfig(**kw), plans[plan], cap, inv, box,
                         require_halt=halt)
        bad = (int((~ok & ~rep.overflowed).sum()), int(rep.overflowed.sum()),
               int(rep.unhalted_seeds.size))
        if bad[:2] != (0, 0) or (halt and bad[2]):
            raise AssertionError(f"certificate {num} ({name}): violations, overflows, "
                                 f"unhalted {bad}")
        log(f"[37.{num}] {name} under {plans[plan].name} ({rep.plan_hash}): {bad[0]} "
            f"violations, {bad[1]} overflows, {bad[2]} unhalted; search ms "
            f"{spread(timing[name])}")
    extra.setdefault("kvchaos-bug-nochaos", {}).update(
        shrink_ms=shrink_ms, shrink_rounds=res.rounds,
        **{f"nemesis_{k}_search_ms": statistics.median(v) for k, v in timing.items()})
    return wl_n, kv_cfg, first, res.plan, caught_n


def store_search(device, paths: dict, name: str, wl, cfg, plan, cap: int, inv, n: int,
                 pin: str, **kw):
    """One storage search at ``n`` seeds on the card, its launches read
    around it; the failing, overflowed and unhalted counts and the
    digest of the trace column must be the JAX package's
    (``STORE_PINS[pin]``). Returns the report and its host ms."""
    from madsim_tpu_torch.engine import search_seeds
    from madsim_tpu_torch.engine.fused import kernel_model

    key = kernel_model(wl).key

    def go():
        return search_seeds(wl, cfg, None, n_seeds=n, max_steps=cap, history_invariant=inv,
                            plan=plan, device=device, **kw)

    t = time.perf_counter()
    rep, counts = path_launches(go)
    ms = (time.perf_counter() - t) * 1e3
    paths.setdefault(key, {})[name] = run_drain(counts, key)
    if run_drain(counts, key) != [1, 1] or len(counts) != 2:
        raise AssertionError(f"{name}: launched {counts}")
    got = dict(failing=int(rep.failing_seeds.size), overflowed=int(rep.overflowed.sum()),
               unhalted=int(rep.unhalted_seeds.size), traces=traces_digest(rep.traces))
    if got != STORE_PINS[pin]:
        raise AssertionError(f"{name}: {got}; the JAX package: {STORE_PINS[pin]}")
    return rep, ms


def raft_nemesis_phase(device, paths: dict, extra: dict) -> None:
    """Phase 37.4: the nemesis soak's certificate 4, durable raftlog
    under its crash storm and gray failure, pinned to the JAX package's
    run."""
    from madsim_tpu_torch.check import election_safety
    from madsim_tpu_torch.engine import EngineConfig
    from madsim_tpu_torch.models import make_raftlog
    from madsim_tpu_torch.models.raftlog import OP_COMMIT, OP_ELECT

    wl, cfg, plan = (make_raftlog(record=True, chaos=False, durable=True),
                     EngineConfig(**NEMESIS_RAFT_KW), store_plans()["raft"])
    box = {}

    def inv(h):
        box["ok"] = election_safety(h, elect_op=OP_ELECT) & election_safety(h, elect_op=OP_COMMIT)
        return box["ok"]

    rep, ms = store_search(device, paths, "nemesis_raftlog", wl, cfg, plan, STORE_STEPS, inv,
                           NEMESIS_SEEDS, "raft")
    viol = int((~box["ok"] & ~rep.overflowed).sum())
    if viol:
        raise AssertionError(f"certificate 4: {viol} violations")
    extra.setdefault("raftlog-durable-record", {})["nemesis_raftlog_search_ms"] = ms
    log(f"[37.4] durable raftlog under {plan.name} ({rep.plan_hash}), {NEMESIS_SEEDS} seeds, "
        f"pool 96: 0 election/log-agreement violations, 0 overflows, 0 unhalted, traces "
        f"{traces_digest(rep.traces)} as the JAX package's run; search ms {ms:.2f}; "
        f"launches {paths['raftlog-durable-record']['nemesis_raftlog']}")


def store_kernel_phases(device, results: list, paths: dict, extra: dict, card: str,
                        ms_of: dict, plan_refs: dict) -> dict:
    """Phase 38: the storage libraries and the metrics runs, each held as
    phases 4-15; 38.6 against phase 36.4's plain run (``plan_refs``).
    Returns the plain step's final states of 38.2-38.4 (the first
    STORE_PLAIN_SEEDS seeds), by plan name."""
    from madsim_tpu_torch.engine import (
        STATE_FIELDS, EngineConfig, make_init, make_run_while, search_seeds,
    )
    from madsim_tpu_torch.engine.core import (
        MET_CLOG_BLOCK, MET_CRASH, MET_DUP, MET_PAUSE, MET_SYNC, MET_SYNC_LOST, MET_TORN,
    )
    from madsim_tpu_torch.engine.fused import kernel_model
    from madsim_tpu_torch.engine.oracle import run_oracle
    from madsim_tpu_torch.models import BENCH_SPECS, make_kvchaos, make_raft, make_raftlog

    plans, refs = store_plans(), {}

    def held(label, key, wl, cfg, n, cap, plan=None, metrics=False, dup=False,
             plain_seeds=None, all_halt=True, reuse=None):
        if kernel_model(wl, dup).key != key:
            raise AssertionError(f"{key}: the registry picks {kernel_model(wl, dup).key}")
        box = {}
        r = kernel_phase(device, key, wl, cfg, n, cap, CPU_SAMPLE, REPEATS, plan=plan,
                         dup_rows=dup, all_halt=all_halt, refs=box, metrics=metrics,
                         plain_seeds=plain_seeds, reuse=reuse)
        if r["launches"] != 1 or r["drains"] != 1 or r["err"] != 0:
            raise AssertionError(f"{key}: launches {r['launches']}, {r['drains']}; "
                                 f"error {r['err']}")
        name = f"make_run_fused/{key}" + (f"/plan-{label}" if plan else "") + (
            "/metrics" if metrics else "")
        results.append((key, name, f"madsim_tpu_torch/csrc/{kernel_model(wl, dup).header}", r))
        paths.setdefault(key, {})[f"run_while_{label}"] = [r["launches"], r["drains"]]
        return r, box[key]

    # 38.1 raftlog-durable at the raftlog bench shape, and the store
    # soak's oracle sample at pool 128
    _f, kw, n, cap = BENCH_SPECS["raftlog"]
    wl = make_raftlog(durable=True)
    log(f"[38.1] raftlog-durable: {kw}, {n} seeds, make_run_while cap {cap}")
    held("bench", "raftlog-durable", wl, EngineConfig(**kw), n, cap)
    cfg = EngineConfig(**STORE_KW)
    orc, counts = path_launches(lambda: search_seeds(
        wl, cfg, lambda v: np.ones(64, bool), n_seeds=64, max_steps=STORE_STEPS,
        require_halt=False, device=device))
    paths["raftlog-durable"]["oracle_sample"] = run_drain(counts, "raftlog-durable")
    sample = range(0, 64, 7)
    for seed in sample:
        o = run_oracle(wl, cfg, seed, STORE_STEPS, n_writes=4)
        if o.trace != int(orc.traces[seed]):
            raise AssertionError(f"raftlog-durable seed {seed}: trace {int(orc.traces[seed]):#x}, "
                                 f"the C++ oracle {o.trace:#x}")
    log(f"  pool 128, {STORE_STEPS} steps: seeds {list(sample)} equal the C++ oracle's traces "
        f"(the verbatim-durable semantics); launches {counts}")

    # 38.2-38.4 the store shape under the soak's plans, with metrics
    store_wl = make_raftlog(record=True, chaos=False, durable=True)
    bug_wl = make_raftlog(record=True, chaos=False, durable=True, bug="nosync")
    for i, (ref, key, w, plan) in enumerate((
            ("store", "raftlog-durable-record", store_wl, "store"),
            ("lie", "raftlog-durable-record", store_wl, "lie"),
            ("nosync", "raftlog-nosync-record", bug_wl, "store"))):
        log(f"[38.{i + 2}] {key}: {STORE_KW}, {STORE_SEEDS} seeds, make_run_while cap "
            f"{STORE_STEPS}, plan {plans[plan].name}, metrics; the plain step on the card "
            f"holds the first {STORE_PLAIN_SEEDS} seeds")
        r, refs[ref] = held(plan, key, w, cfg, STORE_SEEDS, STORE_STEPS, plan=plans[plan],
                            metrics=True, plain_seeds=STORE_PLAIN_SEEDS)
        met = refs[ref].met.to(torch.int64).sum(0).tolist()
        log(f"  the plain step's {STORE_PLAIN_SEEDS} seeds: syncs {met[MET_SYNC]}, lied "
            f"{met[MET_SYNC_LOST]}, torn kills {met[MET_TORN]}, crashes {met[MET_CRASH]}")

    # 38.5 the main path with metrics: every field but met equals the
    # run without them (phase 4's)
    wl, cfg, n, cap = spec_of("raft", {})
    log(f"[38.5] raft with metrics: {n} seeds, make_run_while cap {cap}")
    r, _ref = held("metrics", "raft", wl, cfg, n, cap, metrics=True)
    seeds = np.arange(n, dtype=np.uint64)
    plain_run = make_run_while(wl, cfg, cap)(make_init(wl, cfg, device=device)(seeds))
    met_run = make_run_while(wl, cfg, cap, metrics=True)(
        make_init(wl, cfg, device=device, metrics=True)(seeds))
    bad = [f for f in STATE_FIELDS
           if f != "met" and not torch.equal(getattr(plain_run, f), getattr(met_run, f))]
    if bad:
        raise AssertionError(f"raft: metrics changed {bad}")
    extra.setdefault("raft", {}).update(metrics_ms=r["ms"], metrics_ms_all=r["ms_all"])
    log(f"  every field but met equals the run without metrics; kernel median {r['ms']:.4f} ms "
        f"with metrics beside {ms_of['raft']:.4f} ms without (phase 4, this call, {card})")

    # 38.6 phase 36.4's run with metrics: every field but met against
    # 36.4's plain run of all its seeds on the card, every field on the
    # CPU sample
    key = "kvchaos-record-nochaos-dup"
    r36 = next(r for _k, name, _s, r in results if name == f"make_run_fused/{key}/plan-mixed")
    kv = dict(writes=NEMESIS_KV_WRITES, record=True, chaos=False)
    log(f"[38.6] {key}: {NEMESIS_KV_KW}, {NEMESIS_SEEDS} seeds, cap {MIXED_STEPS}, the "
        f"mixed plan, dup_rows, metrics; held against phase 36.4's plain run on the card")
    r, _ref = held("mixed", key, make_kvchaos(**kv), EngineConfig(**NEMESIS_KV_KW),
                   NEMESIS_SEEDS, MIXED_STEPS, metrics=True, plan=nemesis_plans()["mixed"],
                   dup=True, all_halt=False,
                   reuse=(plan_refs[key], r36["seed_steps"], r36["drops"]))
    totals = r["met_total"]
    for slot, label in ((MET_DUP, "dup"), (MET_PAUSE, "pause"),
                        (MET_CLOG_BLOCK, "clog_block"), (MET_CRASH, "crash")):
        if totals[slot] <= 0:
            raise AssertionError(f"38.6: MET_{label.upper()} is 0")
    log(f"  the kernel's counters over all {NEMESIS_SEEDS} seeds: dup {totals[MET_DUP]}, "
        f"pause {totals[MET_PAUSE]}, clog_block {totals[MET_CLOG_BLOCK]}, crash "
        f"{totals[MET_CRASH]}")
    return refs


def store_certificates(device, refs: dict, paths: dict, extra: dict) -> None:
    """Phase 39: the store soak's certificates at 8,192 seeds on the card,
    each count pinned to the JAX package's run; each search's failing
    seeds among the first STORE_PLAIN_SEEDS equal those of phase 38's
    plain runs."""
    from madsim_tpu_torch.chaos import shrink_plan
    from madsim_tpu_torch.engine import EngineConfig, make_init, make_run_while, search_seeds
    from madsim_tpu_torch.engine.compact import RESULT_FIELDS, make_run_compacted
    from madsim_tpu_torch.engine.convert import state_to_numpy
    from madsim_tpu_torch.engine.core import MET_CRASH, MET_SYNC, MET_SYNC_LOST, MET_TORN
    from madsim_tpu_torch.models import make_raftlog

    plans, cfg, n = store_plans(), EngineConfig(**STORE_KW), STORE_SEEDS
    wl = make_raftlog(record=True, chaos=False, durable=True)
    wl_bug = make_raftlog(record=True, chaos=False, durable=True, bug="nosync")
    key, bug_key = "raftlog-durable-record", "raftlog-nosync-record"
    kw = dict(require_halt=False)
    timing = {}

    def same_as_plain(name, rep, ref, inv):
        k = ref.seed.shape[0]
        got = rep.failing_seeds[rep.failing_seeds < k]
        want = flagged_by_plain(ref, inv)
        if not np.array_equal(got, want):
            raise AssertionError(f"{name}: the kernel fails {got.tolist()} of the first {k} "
                                 f"seeds, the plain step {want.tolist()}")
        return got.size

    # 39.1 certificate 1: no disk fault; the kernel, the plain step and
    # the compacted runner agree
    rep, timing["off"] = store_search(device, paths, "store_off", wl, cfg, None, STORE_STEPS,
                                      store_inv({}), n, "off", **kw)
    st = make_init(wl, cfg, device=device)(np.arange(n, dtype=np.uint64))
    out, counts = path_launches(lambda: make_run_while(wl, cfg, STORE_STEPS)(st))
    ref = plain_head(wl, cfg, int(out.step[0]), head_of(st, STORE_PLAIN_SEEDS))[0]
    assert_equal(head_of(out, STORE_PLAIN_SEEDS), ref,
                 f"39.1: the first {STORE_PLAIN_SEEDS} seeds (kernel) vs plain on the card")
    comp, ccounts = path_launches(lambda: make_run_compacted(wl, cfg, STORE_STEPS)(st))
    paths[key]["compacted_off"] = run_drain(ccounts, key)
    lock = state_to_numpy(out)
    for f in RESULT_FIELDS:
        if f != "step" and not np.array_equal(getattr(comp, f), lock[f]):
            raise AssertionError(f"39.1: compacted field {f} differs from make_run_while")
    if run_drain(ccounts, key) != [1, 0]:
        raise AssertionError(f"39.1: the compacted path launched {ccounts}")
    log(f"[39.1] certificate 1, no disk fault: 0 violations, traces {traces_digest(rep.traces)} "
        f"as the JAX package's; the kernel's run equals the plain step on the first "
        f"{STORE_PLAIN_SEEDS} seeds, and make_run_compacted (launches {ccounts}) every banked "
        f"field but step (disk included); search ms {timing['off']:.2f}")

    # 39.2 certificate 2: correct placement clean under the store plan
    box = {}
    rep, timing["store"] = store_search(device, paths, "store_clean", wl, cfg, plans["store"],
                                        STORE_STEPS, store_inv(box), n, "store", metrics=True,
                                        **kw)
    same_as_plain("39.2", rep, refs["store"], store_inv({}))
    tot = torch.as_tensor(rep.met, device=device).to(torch.int64).sum(0)
    fleet = dict(sync=int(tot[MET_SYNC]), sync_lost=int(tot[MET_SYNC_LOST]),
                 torn=int(tot[MET_TORN]), crash=int(tot[MET_CRASH]))
    if fleet != STORE_FLEET or fleet["torn"] == 0:
        raise AssertionError(f"39.2: fleet {fleet}; the JAX package: {STORE_FLEET}")
    log(f"[39.2] certificate 2, {plans['store'].name} ({rep.plan_hash}): 0 violations, 0 "
        f"overflows; fleet: syncs {fleet['sync']}, lied {fleet['sync_lost']}, torn kills "
        f"{fleet['torn']}, crashes {fleet['crash']} (summed on the card), as the JAX "
        f"package's; search ms {timing['store']:.2f}")

    # 39.3 certificate 3: the lying disk, the detector's positive control
    rep, timing["lie"] = store_search(device, paths, "store_lie", wl, cfg, plans["lie"],
                                      STORE_STEPS, recovery_inv({}), n, "lie", **kw)
    head = same_as_plain("39.3", rep, refs["lie"], recovery_inv({}))
    log(f"[39.3] certificate 3, {plans['lie'].name} ({rep.plan_hash}): recovery_safety flags "
        f"{rep.failing_seeds.size} seeds ({head} of the first {STORE_PLAIN_SEEDS} equal to "
        f"the plain step's), as the JAX package's; search ms {timing['lie']:.2f}")

    # 39.4 the missing-sync mutant, its shrink and the shrunk replay
    box = {}
    rep, timing["nosync"] = store_search(device, paths, "store_nosync", wl_bug, cfg,
                                         plans["store"], STORE_STEPS, store_inv(box), n,
                                         "nosync", **kw)
    same_as_plain("39.4", rep, refs["nosync"], store_inv({}))
    loss = int((~box["commit"] & ~rep.overflowed).sum())
    first = int(rep.failing_seeds[0])
    if (first, loss) != (NOSYNC_FIRST, NOSYNC_COMMIT_LOSS):
        raise AssertionError(f"39.4: first failing seed {first}, {loss} by committed-value "
                             f"loss; the JAX package: {NOSYNC_FIRST}, {NOSYNC_COMMIT_LOSS}")
    t = time.perf_counter()
    res, counts = path_launches(lambda: shrink_plan(
        wl_bug, cfg, first, plans["store"], history_invariant=store_inv({}),
        max_steps=STORE_STEPS, device=device))
    shrink_ms = (time.perf_counter() - t) * 1e3
    paths[bug_key]["shrink"] = run_drain(counts, bug_key)
    got = dict(events=tuple(tuple(vars(e).values()) for e in res.events), rounds=res.rounds,
               tested=res.tested, plan_hash=res.plan.hash(), trace=res.trace)
    if got != NOSYNC_SHRUNK:
        raise AssertionError(f"39.4: seed {first} shrinks to {got}; the JAX package: "
                             f"{NOSYNC_SHRUNK}")
    box_r = {}
    rep_r = search_seeds(wl_bug, cfg, None, seeds=np.asarray([first], np.uint64),
                         max_steps=STORE_STEPS, history_invariant=store_inv(box_r),
                         plan=res.plan, device=device, **kw)
    if (rep_r.failing_seeds.tolist() != [first] or int(rep_r.traces[0]) != res.trace
            or bool(box_r["commit"][0])):
        raise AssertionError("39.4: the shrunk plan's replay diverged")
    log(f"[39.4] the nosync mutant under {plans['store'].name}: {rep.failing_seeds.size} "
        f"failing seeds, all {loss} by committed-value loss, as the JAX package's; search ms "
        f"{timing['nosync']:.2f}")
    log("  " + res.banner().replace("\n", "\n  "))
    log(f"  {res.original_events} -> {len(res.events)} events in {res.rounds} rounds "
        f"({res.tested} candidates), launches {paths[bug_key]['shrink']}, {shrink_ms:.1f} ms; "
        f"the replay loses a committed value with the same trace")

    # 39.5 the EIO storm: correct code reacts, nothing is lost
    rep, timing["eio"] = store_search(device, paths, "store_eio", wl, cfg, plans["eio"],
                                      EIO_STEPS, store_inv({}), n, "eio", metrics=True, **kw)
    lost = int((torch.as_tensor(rep.met, device=device)[:, MET_SYNC_LOST] > 0).sum())
    if lost != EIO_SYNC_LOST_SEEDS or 2 * lost <= n:
        raise AssertionError(f"39.5: {lost} seeds with a failed sync; the JAX package: "
                             f"{EIO_SYNC_LOST_SEEDS}")
    log(f"[39.5] the EIO storm ({rep.plan_hash}), cap {EIO_STEPS}: 0 violations, 0 overflows; "
        f"{lost} of {n} seeds saw a sync fail, as the JAX package's; search ms "
        f"{timing['eio']:.2f}")
    extra.setdefault(key, {}).update(
        {f"store_{k}_search_ms": v for k, v in timing.items() if k != "nosync"})
    extra.setdefault(bug_key, {}).update(store_nosync_search_ms=timing["nosync"],
                                         shrink_ms=shrink_ms, shrink_rounds=res.rounds)

# the observability phases (40-42): every tap on the main path, the
# coverage searches' widths, the plain step's seeds of their card
# references, and the forensics ring's capacity
OBS_TAPS = dict(cov_words=64, cov_hitcount=True, timeline_cap=256)
COV_TAPS = dict(cov_words=64, cov_hitcount=True)
COV_SEEDS, COV_PLAIN_SEEDS = 8192, 2048
FORENSICS_CAP = 4096


def obs_main_path_phase(device, results: list, paths: dict, extra: dict, card: str,
                        ms_of: dict, phase4) -> None:
    """Phase 40: the main path with every tap (``metrics``,
    ``timeline_cap``, ``cov_words``, ``cov_hitcount``), held as phase 4
    (every field, the new columns included, against the plain step on
    the card and on the CPU sample); every field but the derived ones
    equal to phase 4's run, the kernel's ms beside phase 4's."""
    from madsim_tpu_torch.engine import OBS_FIELDS, STATE_FIELDS, make_init, make_run_while
    from madsim_tpu_torch.engine.convert import field_to_numpy
    from madsim_tpu_torch.engine.fused import KERNEL, kernel_model, obs_bytes

    wl, cfg, n, cap = spec_of("raft", {})
    log(f"[40] raft with metrics and {OBS_TAPS}: {n} seeds, make_run_while cap {cap}")
    box = {}
    r = kernel_phase(device, "raft", wl, cfg, n, cap, CPU_SAMPLE, REPEATS, refs=box,
                     metrics=True, taps=OBS_TAPS)
    if r["launches"] != 1 or r["drains"] != 1 or r["err"] != 0:
        raise AssertionError(f"raft with taps: launches {r['launches']}, {r['drains']}; "
                             f"error {r['err']}")
    out = box["raft"]
    bad = [f for f in STATE_FIELDS if f not in (*OBS_FIELDS, "met")
           and not torch.equal(getattr(out, f), getattr(phase4, f))]
    if bad:
        raise AssertionError(f"raft: the taps changed {bad}")
    if int(out.tl_drop.sum()) or not bool((out.tl_count > 0).all()) or not bool(
            out.cov.any(1).all()):
        raise AssertionError("raft with taps: a ring dropped rows, or a seed has no coverage")
    fleet = np.bitwise_or.reduce(field_to_numpy("cov", out.cov), axis=0)
    results.append(("raft", "make_run_fused/obs",
                    f"madsim_tpu_torch/csrc/{kernel_model(wl).header}", r))
    paths["raft"]["run_while_obs"] = [r["launches"], r["drains"]]
    extra.setdefault("raft", {}).update(obs_ms=r["ms"], obs_ms_all=r["ms_all"])
    log(f"  every field but the tap columns and met equals phase 4's run; rings hold "
        f"{int(out.tl_count.sum())} rows (at most {int(out.tl_count.max())} a seed), none "
        f"dropped; {int(out.cov_hits.to(torch.int64).sum())} tap hits, "
        f"{int(np.unpackbits(fleet.view(np.uint8)).sum())} of {64 * 32} bits set fleet-wide")
    log(f"  kernel median {r['ms']:.4f} ms with every tap beside {ms_of['raft']:.4f} ms "
        f"without (phase 4, this call, {card})")
    # each tap alone, timed only (the run above holds them together),
    # and the shared memory a block takes with them
    occ = KERNEL.occupancy(kernel_model(wl), cfg.pool_size)
    seed_bytes = occ["run_smem_bytes"] // occ["seeds_per_block"]
    seeds = np.arange(n, dtype=np.uint64)
    for label, taps in (("cov", dict(cov_words=64)),
                        ("cov_hits", dict(cov_words=64, cov_hitcount=True)),
                        ("ring", dict(timeline_cap=256)), ("all", OBS_TAPS)):
        st = make_init(wl, cfg, device=device, **taps)(seeds)
        run = make_run_while(wl, cfg, cap, **taps)
        ms = time_ms(lambda: run(st), REPEATS, device)
        tail = obs_bytes(wl.n_nodes, cfg.pool_size, **taps)
        block = occ["seeds_per_block"] * ((seed_bytes + 15) // 16 * 16 + tail)
        extra["raft"][f"obs_{label}_ms"] = statistics.median(ms)
        log(f"  {taps}: kernel ms {spread(ms)}; {tail} B of taps a seed, {block} B shared "
            f"a block (without: {occ['run_smem_bytes']})")


def coverage_phase(device, results: list, paths: dict, extra: dict, repro: tuple) -> None:
    """Phase 41: ``search_seeds`` with coverage (``COV_TAPS``) at 8,192
    seeds on four libraries: kvchaos-bug without its own chaos under the
    nemesis plan (phase 37's catches), leasekv and shardkv with their
    hooks, raftlog ``durable=True, cov_spread=True``; each report's
    bitmaps equal the plain step's on the card (its first 2,048 seeds,
    which are frozen once a seed halts), its verdicts and traces those
    of the search without the taps. The new library also runs as phases
    4-15 at the raftlog bench shape with the taps."""
    from madsim_tpu_torch.engine import EngineConfig, make_init, make_run_while_plain, search_seeds
    from madsim_tpu_torch.engine.convert import field_to_numpy
    from madsim_tpu_torch.engine.fused import kernel_model
    from madsim_tpu_torch.models import BENCH_SPECS, SOAK_SPECS, make_leasekv, make_raftlog
    from madsim_tpu_torch.models import make_shardkv

    wl_n, kv_cfg, _first, _plan, caught = repro
    plans = nemesis_plans()
    _f, lease_kw, _n, lease_cap = SOAK_SPECS["leasekv"]
    _f, shard_kw, _n, shard_cap = SOAK_SPECS["shardkv"]
    _f, rlog_kw, rlog_n, rlog_cap = BENCH_SPECS["raftlog"]
    spread_wl = make_raftlog(durable=True, cov_spread=True)
    key = "raftlog-durable-spread"
    log(f"[41.0] {key}: {rlog_kw}, {rlog_n} seeds, make_run_while cap {rlog_cap}, {COV_TAPS}")
    r = kernel_phase(device, key, spread_wl, EngineConfig(**rlog_kw), rlog_n, rlog_cap,
                     CPU_SAMPLE, REPEATS, taps=COV_TAPS)
    if r["launches"] != 1 or r["drains"] != 1 or r["err"] != 0:
        raise AssertionError(f"{key}: launches {r['launches']}, {r['drains']}; error {r['err']}")
    results.append((key, f"make_run_fused/{key}/cov",
                    f"madsim_tpu_torch/csrc/{kernel_model(spread_wl).header}", r))
    paths[key] = {"run_while_cov": [r["launches"], r["drains"]]}
    seeds = np.arange(COV_SEEDS, dtype=np.uint64)
    cases = (
        ("41.1", wl_n, kv_cfg, plans["kv"], NEMESIS_STEPS),
        ("41.2", make_leasekv(), EngineConfig(**lease_kw), None, lease_cap),
        ("41.3", make_shardkv(), EngineConfig(**shard_kw), None, shard_cap),
        ("41.4", spread_wl, EngineConfig(**rlog_kw), None, rlog_cap),
    )
    for num, wl, cfg, plan, cap in cases:
        key = kernel_model(wl).key
        hist = lost_write_inv({}) if plan is not None else None
        inv = None if hist is not None else (lambda v: np.ones(COV_SEEDS, bool))
        kw = dict(n_seeds=COV_SEEDS, max_steps=cap, plan=plan, device=device,
                  history_invariant=hist, require_halt=hist is not None)

        def go(taps, kw=kw, wl=wl, cfg=cfg, inv=inv):
            return search_seeds(wl, cfg, inv, **kw, **taps)

        t = time.perf_counter()
        rep, counts = path_launches(lambda: go(COV_TAPS))
        ms = (time.perf_counter() - t) * 1e3
        if run_drain(counts, key) != [1, 1] or len(counts) != 2:
            raise AssertionError(f"{num} {key}: launched {counts}")
        paths.setdefault(key, {})["search_cov"] = run_drain(counts, key)
        off = go({})
        for attr in ("ok", "overflowed", "halted", "traces"):
            if not np.array_equal(getattr(rep, attr), getattr(off, attr)):
                raise AssertionError(f"{num} {key}: the taps changed {attr}")
        if plan is not None and not np.array_equal(rep.failing_seeds, caught):
            raise AssertionError(f"{num}: {rep.failing_seeds.size} catches, phase 37.1 "
                                 f"{caught.size}")
        head = seeds[:COV_PLAIN_SEEDS]
        init = make_init(wl, cfg, device=device, plan_slots=plan.slots if plan else 0,
                         **COV_TAPS)
        st = init(head, plan.compile_batch(head, wl=wl)) if plan else init(head)
        t = time.perf_counter()
        ref = make_run_while_plain(wl, cfg, cap, **COV_TAPS)(st)
        plain_s = time.perf_counter() - t
        want_cov = field_to_numpy("cov", ref.cov)
        if not np.array_equal(rep.cov[:COV_PLAIN_SEEDS], want_cov):
            raise AssertionError(f"{num} {key}: the bitmaps differ from the plain step's")
        if not np.array_equal(rep.traces[:COV_PLAIN_SEEDS], field_to_numpy("trace", ref.trace)):
            raise AssertionError(f"{num} {key}: the traces differ from the plain step's")
        fleet = np.bitwise_or.reduce(rep.cov, axis=0)
        per_seed = np.unpackbits(rep.cov.view(np.uint8), axis=1).sum(1)
        extra.setdefault(key, {})["cov_search_ms"] = ms
        log(f"[{num}] {key}: search_seeds({COV_TAPS}), {COV_SEEDS} seeds, cap {cap}"
            + (f", plan {plan.name}" if plan else "") + f": launches {counts}; "
            f"{rep.failing_seeds.size} failing, the verdicts and traces of the search "
            f"without taps; bitmaps of the first {COV_PLAIN_SEEDS} seeds equal the plain "
            f"step's on the card ({plain_s:.1f} s); {int(np.unpackbits(fleet.view(np.uint8)).sum())} "
            f"of {64 * 32} bits set fleet-wide, {int(per_seed.min())}-{int(per_seed.max())} a "
            f"seed; search {ms:.1f} ms (host clock)")


def dispatched_run(wl, cfg, st, cap: int, timeline_cap: int) -> tuple:
    """``make_run_while_plain`` of one seed with the timeline ring, also
    counting the steps that dispatch an event (fold the trace): ``(final
    state, dispatched steps)``."""
    from madsim_tpu_torch.engine import make_step_plain

    step, n, i = make_step_plain(wl, cfg, timeline_cap=timeline_cap), 0, 0
    while i < cap and not bool(st.halted.all()):
        nxt = step(st)
        n += int((nxt.trace != st.trace).sum())
        st, i = nxt, i + 1
    return st, n


def forensics_phase(device, paths: dict, repro: tuple) -> None:
    """Phase 42: phase 37's first failing seed under its shrunk plan,
    replayed on the card with the timeline ring (``FORENSICS_CAP``): the
    port's decoder reads the ring, the rows refold to the trace, the ring
    dropped nothing and holds one row per dispatched step, and its
    columns equal the plain step's on the CPU."""
    from madsim_tpu_torch.engine import TIMELINE_FIELDS, format_timeline, make_init, search_seeds
    from madsim_tpu_torch.engine.convert import field_to_numpy
    from madsim_tpu_torch.engine.fused import kernel_model
    from madsim_tpu_torch.obs import decode_timeline, refold_timeline

    wl, cfg, first, plan, _caught = repro
    key = kernel_model(wl).key
    rep, counts = path_launches(lambda: search_seeds(
        wl, cfg, None, n_seeds=1, max_steps=NEMESIS_STEPS, seed_base=first,
        history_invariant=lost_write_inv({}), plan=plan, timeline_cap=FORENSICS_CAP,
        device=device))
    paths[key]["forensics"] = run_drain(counts, key)
    events = decode_timeline(rep.timeline, wl, 0)
    trace = int(rep.traces[0])
    if rep.failing_seeds.tolist() != [first] or trace != NEMESIS_SHRUNK["trace"]:
        raise AssertionError(f"42: seed {first} under the shrunk plan: {rep.banner()}")
    if refold_timeline(events, wl) != trace:
        raise AssertionError("42: the decoded ring does not refold to the trace")
    seeds = np.array([first], np.uint64)
    st = make_init(wl, cfg, device="cpu", plan_slots=plan.slots, timeline_cap=FORENSICS_CAP)(
        seeds, plan.compile_batch(seeds, wl=wl))
    ref, n_disp = dispatched_run(wl, cfg, st, NEMESIS_STEPS, FORENSICS_CAP)
    tl_count, tl_drop = int(rep.timeline.tl_count[0]), int(rep.timeline.tl_drop[0])
    if tl_drop or tl_count != n_disp or len(events) != tl_count:
        raise AssertionError(f"42: ring holds {tl_count} rows ({tl_drop} dropped), "
                             f"decoded {len(events)}, the run dispatched {n_disp}")
    for f in TIMELINE_FIELDS:
        if not np.array_equal(getattr(rep.timeline, f), field_to_numpy(f, getattr(ref, f))):
            raise AssertionError(f"42: ring column {f} differs from the plain step's")
    msgs = [e for e in events if e.src >= 0]
    log(f"[42] seed {first} under {plan.name} ({plan.hash()}), timeline_cap {FORENSICS_CAP}: "
        f"launches {counts}; {tl_count} rows, one per dispatched step, none dropped; the "
        f"ring equals the plain step's on the CPU; the decoded rows refold to the trace "
        f"{trace:#018x}; {len(msgs)} messages, each emitted "
        f"{statistics.median(e.time_ns - e.emit_ns for e in msgs) / 1e6:.3f} ms (median) "
        f"before its dispatch")
    log("  " + format_timeline(events[-4:], wl=wl).replace("\n", "\n  "))


class Laps:
    """Per-phase wall seconds, printed as each phase ends."""

    def __init__(self):
        self.start = self.last = time.perf_counter()
        self.laps = {}

    def __call__(self, label: str) -> None:
        now = time.perf_counter()
        self.laps[label] = now - self.last
        log(f"[time] {label}: {now - self.last:.1f} s (run so far {now - self.start:.1f} s)")
        self.last = now



# ---------------------------------------------------------------------------
# phases 43-46: the tail-latency tap and the client army
# ---------------------------------------------------------------------------

# tools/latency_soak.py's shape: kvchaos, two replicas and no chaos of its
# own, under a client army of 64 three-round ops over 5-500 ms, pool 160,
# a 700 ms clock cap, and a GrayFailure over the client<->primary path
LAT_SEEDS = 8192
LAT_STEPS = 4000
LAT_PLAIN_SEEDS = 1024
LAT_CPU_SAMPLE = 64
LAT_KW = dict(pool_size=160, time_limit_ns=700_000_000)
# certificates 2-3 of tools/latency_soak.py by the JAX package on the CPU:
# seeds, completed ops, ops per window and the digest of the merged
# (P, 64) sketch (sketch_digest); the p99s of certificate 3 in ns
LAT_PINS = {
    "cert2-gray": (4096, 258174, (144651, 113523), "ead622022c0e23e6"),
    "cert3-clean": (2048, 119984, (72536, 47448), "7fb30433503c2cc4"),
    "cert3-gray": (2048, 129163, (72371, 56792), "ae20a768b14dd65c"),
}
LAT_P99 = {"cert3-clean": 56431603, "cert3-gray": 451452825}
# the SLO screen's objective: p99 at most 319.23 ms (the top of ladder
# bucket 49) in each window of at least 8 ops; under the gray plan about
# half the seeds breach it
SLO_BOUND_NS = 319225354
SLO_MIN_OPS = 8

# the step goldens (tools/step_goldens.py): 32 seeds, 240 steps, every
# observability tap; this script's copy of the digests of its two army
# scenarios (tests/_step_goldens.py; a tier-1 test holds the copy equal)
GOLDEN_SEEDS = 32
GOLDEN_STEPS = 240
GOLDEN_OBS = dict(cov_words=8, metrics=True, timeline_cap=48, cov_hitcount=True)
ARMY_GOLDENS = {
    "raftlog/army-obs": "36351f09d73b17f2c71ee94f0b18db5d85589688c18deb513c9a8e1f2d114176",
    "raftlog/army-obs/compact": "f78e96071f53675c045a143229de613f0bd6303dbd0c4609b8c33a61ed53469f",
    "kvchaos/army-obs": "90432c7f65a8f920b9b736ba005566b3d23e1549a649281d06cf7b22c7f56f8b",
    "kvchaos/army-obs/compact": "5e5d9161e3c76e86076b03fd5a0dd39c4f8237d145a5ca1867d5afe7ed95d973",
}
# the JAX package's SimState fields in its order, less the ones the
# digest skips (the pool index summaries, the causal and retry columns);
# its met digests the slots before MET_RETRY
GOLDEN_FIELDS = (
    "seed", "now", "step", "halted", "halt_time", "trace", "overflow", "msg_count",
    "ev_time", "ev_valid", "ev_meta", "ev_epoch", "ev_args", "ev_pay", "alive", "paused",
    "epoch", "node_state", "clog", "slow", "dup", "skew", "disk", "wmask", "sync_loss",
    "sync_eio", "torn", "hist_count", "hist_drop", "hist_word", "hist_t", "cov",
    "cov_last", "cov_hits", "met", "tl_count", "tl_drop", "tl_t", "tl_meta", "tl_args",
    "tl_pay", "ev_emit", "tl_emit", "lat_inv", "lat_resp", "lat_hist", "lat_count",
    "lat_drop",
)
GOLDEN_MET_SLOTS = 16
# the fields the digest skips by name that the port carries: the causal
# and the retry columns (the port carries no pool index)
GOLDEN_SKIP = ("lam", "ev_parent", "ev_lam", "tl_seq", "tl_parent", "tl_lam",
               "rt_done", "rt_attempt", "rt_deadline")
# phase 45 holds each golden library at this many seeds (the plain step
# on the card on the first GOLDEN_PLAIN_SEEDS) under its scenario, for
# at most GOLDEN_CAP steps (its digests take the goldens' own 240)
GOLDEN_HELD_SEEDS = 4096
GOLDEN_PLAIN_SEEDS = 512
GOLDEN_CAP = 300


def latency_soak():
    """``(workload, config, spec, clean plan, gray plan)`` of
    tools/latency_soak.py."""
    from madsim_tpu_torch.chaos import FaultPlan, GrayFailure
    from madsim_tpu_torch.engine import EngineConfig, LatencySpec
    from madsim_tpu_torch.models import kvchaos

    wl = kvchaos.make_kvchaos(writes=20, n_replicas=2, chaos=False, army=True, army_probes=3)
    army = kvchaos.client_army(n_ops=64, t_min_ns=5_000_000, t_max_ns=500_000_000,
                               n_replicas=2)
    gray = GrayFailure(targets=(0, 3), n_links=1, mult_min=8, mult_max=16,
                       t_min_ns=20_000_000, t_max_ns=250_000_000,
                       dur_min_ns=250_000_000, dur_max_ns=450_000_000)
    return (wl, EngineConfig(**LAT_KW), LatencySpec(ops=64, phases=2, phase_ns=1 << 28),
            FaultPlan((army,), name="army-clean"), FaultPlan((army, gray), name="army-gray"))


def sketch_digest(hist) -> str:
    """The first 16 hex digits of the sha256 of a (P, 64) sketch as int64."""
    a = np.ascontiguousarray(np.asarray(hist, np.int64))
    return hashlib.sha256(a.tobytes()).hexdigest()[:16]


def golden_digest(fields: dict, names) -> str:
    """tools/step_goldens.py ``digest_state``: sha256 over ``names`` in
    order, each field's name, numpy dtype, shape and bytes."""
    h = hashlib.sha256()
    for name in names:
        a = np.asarray(fields[name])
        if name == "met" and a.ndim >= 1 and a.shape[-1] > GOLDEN_MET_SLOTS:
            a = a[..., :GOLDEN_MET_SLOTS]
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def golden_scenarios() -> dict:
    """The two army scenarios of tools/step_goldens.py ``scenarios()``:
    name -> (workload, config, plan, latency spec)."""
    from madsim_tpu_torch.chaos import CrashStorm, FaultPlan, GrayFailure
    from madsim_tpu_torch.engine import EngineConfig, LatencySpec
    from madsim_tpu_torch.models import kvchaos, raftlog

    def plan(army_fn):
        servers = tuple(range(5))
        return FaultPlan((
            army_fn(n_ops=10, t_min_ns=5_000_000, t_max_ns=400_000_000),
            CrashStorm(targets=servers, n=1, t_min_ns=50_000_000, t_max_ns=200_000_000,
                       down_min_ns=20_000_000, down_max_ns=80_000_000),
            GrayFailure(targets=servers, n_links=1, mult_min=4, mult_max=8,
                        t_min_ns=30_000_000, t_max_ns=150_000_000,
                        dur_min_ns=50_000_000, dur_max_ns=150_000_000),
        ))

    kw = dict(loss_p=0.02, clog_backoff_max_ns=2_000_000_000)
    lat = LatencySpec(ops=10, phases=3, phase_ns=1 << 27)
    return {
        "raftlog/army-obs": (raftlog.make_raftlog(record=True, army=True),
                             EngineConfig(pool_size=96, **kw), plan(raftlog.client_army), lat),
        "kvchaos/army-obs": (kvchaos.make_kvchaos(record=True, army=True, army_probes=2),
                             EngineConfig(pool_size=72, **kw), plan(kvchaos.client_army), lat),
    }


def latency_soak_phase(device, results: list, paths: dict, extra: dict, card: str) -> None:
    """Phase 43: kvchaos-army-nochaos at the latency soak's shape (8,192
    seeds, the gray plan, the tap on), held as phases 4-15 with the plain
    step on the card on the first 1,024 seeds; the same run with the tap
    off has every other field equal, traces included; both timed."""
    from madsim_tpu_torch.engine import LATENCY_FIELDS, STATE_FIELDS, make_init, make_run_while
    from madsim_tpu_torch.engine.fused import kernel_model

    wl, cfg, spec, _clean, gray = latency_soak()
    key = "kvchaos-army-nochaos"
    log(f"[43] {key}: {LAT_KW}, {LAT_SEEDS} seeds, make_run_while cap {LAT_STEPS}, plan "
        f"{gray.name}, {spec}; the plain step on the card holds the first "
        f"{LAT_PLAIN_SEEDS} seeds")
    off = {}

    def extras(device, wl, cfg, cap, st, out, med):
        if int(out.lat_count.sum()) < 1 or int(out.lat_drop.sum()):
            raise AssertionError(f"{key}: no op completed, or markers dropped")
        seeds = np.arange(LAT_SEEDS, dtype=np.uint64)
        st_off = make_init(wl, cfg, device=device, plan_slots=gray.slots)(
            seeds, gray.compile_batch(seeds, wl=wl))
        run_off = make_run_while(wl, cfg, cap)
        o = run_off(st_off)
        bad = [f for f in STATE_FIELDS if f not in LATENCY_FIELDS
               and not torch.equal(getattr(o, f), getattr(out, f))]
        if bad or o.lat_inv.numel():
            raise AssertionError(f"{key}: the tap changed {bad}")
        off["ms"] = time_ms(lambda: run_off(st_off), REPEATS, device)
        log(f"  the tap off: traces and every other field equal; {int(out.lat_count.sum())} "
            f"ops completed, none dropped; kernel ms {spread(off['ms'])} without the tap")

    r = kernel_phase(device, key, wl, cfg, LAT_SEEDS, LAT_STEPS, LAT_CPU_SAMPLE, REPEATS,
                     extras=extras, plan=gray, all_halt=False, plain_seeds=LAT_PLAIN_SEEDS,
                     taps=dict(latency=spec))
    if r["launches"] != 1 or r["drains"] != 1 or r["err"] != 0:
        raise AssertionError(f"{key}: launches {r['launches']}, {r['drains']}; error {r['err']}")
    results.append((key, f"make_run_fused/{key}/plan-{gray.name}/latency",
                    f"madsim_tpu_torch/csrc/{kernel_model(wl).header}", r))
    paths.setdefault(key, {})["run_while_latency"] = [r["launches"], r["drains"]]
    extra.setdefault(key, {}).update(tap_off_ms=statistics.median(off["ms"]),
                                     tap_off_ms_all=off["ms"])
    log(f"  kernel median {r['ms']:.4f} ms with the tap, {statistics.median(off['ms']):.4f} "
        f"without (this call, {card})")


def latency_certificates_phase(device, paths: dict, extra: dict) -> None:
    """Phase 44: the latency soak's certificates 2 and 3 on the card, each
    fleet sketch's completed ops, windows and digest equal to the JAX
    package's (LAT_PINS)."""
    from madsim_tpu_torch.engine import N_LAT_BUCKETS, lat_bucket, make_init, make_run_while
    from madsim_tpu_torch.obs import fleet_latency, hist_quantile_bucket
    from madsim_tpu_torch.parallel import merge_latency

    wl, cfg, spec, clean, gray = latency_soak()
    key = "kvchaos-army-nochaos"
    fleets, timing = {}, {}
    for name, plan in (("cert2-gray", gray), ("cert3-clean", clean), ("cert3-gray", gray)):
        n, ops, windows, digest = LAT_PINS[name]
        t = time.perf_counter()
        fl, counts = path_launches(lambda: fleet_latency(
            wl, cfg, spec, n_seeds=n, max_steps=LAT_STEPS, plan=plan, device=device))
        timing[name] = (time.perf_counter() - t) * 1e3
        paths.setdefault(key, {})[f"fleet_{name}"] = run_drain(counts, key)
        if run_drain(counts, key) != [1, 1]:
            raise AssertionError(f"{name}: launched {counts}")
        got = (fl.completed, tuple(int(x) for x in fl.hist.sum(1)), sketch_digest(fl.hist))
        if got != (ops, windows, digest) or fl.dropped:
            raise AssertionError(f"{name}: {got}, {fl.dropped} dropped; the JAX package: "
                                 f"{(ops, windows, digest)}")
        fleets[name] = fl
    # certificate 2: the sketch against the exact per-op latencies
    n = LAT_PINS["cert2-gray"][0]
    seeds = np.arange(n, dtype=np.uint64)
    st = make_init(wl, cfg, device=device, plan_slots=gray.slots, latency=spec)(
        seeds, gray.compile_batch(seeds, wl=wl))
    out = make_run_while(wl, cfg, LAT_STEPS, latency=spec)(st)
    inv, resp = out.lat_inv.cpu().numpy(), out.lat_resp.cpu().numpy()
    done = (inv >= 0) & (resp >= 0)
    lats = (resp - inv)[done]
    merged = fleets["cert2-gray"].hist.sum(0)
    exact = np.bincount(lat_bucket(lats), minlength=N_LAT_BUCKETS)
    whole = merge_latency(out.lat_hist)
    halves = merge_latency(out.lat_hist[: n // 2]) + merge_latency(out.lat_hist[n // 2:])
    if not (np.array_equal(merged, exact) and np.array_equal(whole, halves)
            and np.array_equal(whole, fleets["cert2-gray"].hist)):
        raise AssertionError("certificate 2: the sketch is not the exact bucketing, or the "
                             "sharded merge is not the whole")
    log(f"[44.2] {int(done.sum())} completed ops over {n} seeds (the JAX package "
        f"{LAT_PINS['cert2-gray'][1]}): the fleet sketch (reduced on the card) equals the "
        f"exact bucketing, the merge of halves the whole; fleet_latency ms "
        f"{timing['cert2-gray']:.1f} (host clock)")
    for q in (0.5, 0.9, 0.99, 0.999):
        sk = int(hist_quantile_bucket(merged, q))
        ex = int(lat_bucket(float(np.quantile(lats, q))))
        if abs(sk - ex) > 1:
            raise AssertionError(f"certificate 2: p{q * 100:g} bucket {sk}, exact {ex}")
        log(f"  p{q * 100:g}: sketch bucket {sk}, exact bucket {ex}")
    # certificate 3: the clean tail against the gray-failure blowup
    p99c, p99g = fleets["cert3-clean"].quantile(0.99), fleets["cert3-gray"].quantile(0.99)
    if (p99c, p99g) != (LAT_P99["cert3-clean"], LAT_P99["cert3-gray"]) or p99g < 2 * p99c:
        raise AssertionError(f"certificate 3: p99 {p99c} and {p99g} ns")
    for name in ("cert3-clean", "cert3-gray"):
        log(f"[44.3] {name} ({LAT_PINS[name][0]} seeds, the JAX package's counts); "
            f"fleet_latency ms {timing[name]:.1f} (host clock)")
        log("  " + fleets[name].format().replace("\n", "\n  "))
    log(f"  p99 clean {p99c / 1e6:.2f} ms, gray {p99g / 1e6:.2f} ms: blowup "
        f"{p99g / p99c:.2f}x")
    extra.setdefault(key, {}).update(
        **{f"fleet_{k}_ms": v for k, v in timing.items()}, p99_blowup=p99g / p99c)


def golden_phase(device, results: list, paths: dict, extra: dict) -> None:
    """Phase 45: the step goldens' two army scenarios through the run
    kernel, ``make_run`` and ``make_run_compacted``, each digest equal to
    tests/_step_goldens.py's; then each library held as phases 4-15 at
    4,096 seeds under its scenario."""
    from madsim_tpu_torch.engine import make_init, make_run, make_run_compacted
    from madsim_tpu_torch.engine.convert import state_to_numpy
    from madsim_tpu_torch.engine.fused import kernel_model

    for name, (wl, cfg, plan, lat) in golden_scenarios().items():
        key = kernel_model(wl).key
        seeds = np.arange(GOLDEN_SEEDS, dtype=np.uint64)
        st = make_init(wl, cfg, device=device, plan_slots=plan.slots, latency=lat,
                       **GOLDEN_OBS)(seeds, plan.compile_batch(seeds, wl=wl))
        out, c_run = path_launches(
            lambda: make_run(wl, cfg, GOLDEN_STEPS, latency=lat, **GOLDEN_OBS)(st))
        co, c_com = path_launches(lambda: make_run_compacted(
            wl, cfg, GOLDEN_STEPS, latency=lat, min_size=8, **GOLDEN_OBS)(st))
        got = (golden_digest(state_to_numpy(out), GOLDEN_FIELDS),
               golden_digest(vars(co), [f for f in sorted(vars(co)) if f not in GOLDEN_SKIP]))
        if got != (ARMY_GOLDENS[name], ARMY_GOLDENS[f"{name}/compact"]):
            raise AssertionError(f"golden {name}: {got}")
        if run_drain(c_run, key) != [1, 0] or run_drain(c_com, key) != [1, 0]:
            raise AssertionError(f"golden {name}: launched {c_run} and {c_com}")
        paths.setdefault(key, {}).update(golden_run=run_drain(c_run, key),
                                         golden_compact=run_drain(c_com, key))
        log(f"[45] golden {name} through {key}: make_run ({GOLDEN_STEPS} steps) and "
            f"make_run_compacted digests equal tests/_step_goldens.py "
            f"({got[0][:16]}..., {got[1][:16]}...)")
        n, cap = GOLDEN_HELD_SEEDS, GOLDEN_CAP
        log(f"  {key} at {n} seeds under the scenario's plan, every tap and {lat}, "
            f"make_run_while cap {cap}; the plain step on the card holds the first "
            f"{GOLDEN_PLAIN_SEEDS} seeds")
        r = kernel_phase(device, key, wl, cfg, n, cap, LAT_CPU_SAMPLE, REPEATS, plan=plan,
                         all_halt=False, metrics=True, plain_seeds=GOLDEN_PLAIN_SEEDS,
                         taps=dict(latency=lat, cov_words=8, cov_hitcount=True,
                                   timeline_cap=48))
        if r["launches"] != 1 or r["drains"] != 1 or r["err"] != 0:
            raise AssertionError(f"{key}: launches {r['launches']}, {r['drains']}; "
                                 f"error {r['err']}")
        results.append((key, f"make_run_fused/{key}/plan/obs/latency",
                        f"madsim_tpu_torch/csrc/{kernel_model(wl).header}", r))
        paths[key]["run_while_latency"] = [r["launches"], r["drains"]]


def army_phase(device, results: list, paths: dict, extra: dict) -> None:
    """Phase 46: leasekv-army and shardkv-record-army-nochaos under their
    client armies at 8,192 seeds with the tap on, held as phases 4-15;
    then the SLO screen: ``search_seeds(latency=...)`` at the latency
    soak's shape with the numpy ``slo_bounded`` invariant, and
    ``check.device.slo_breaches`` on the sweep's sketches on the card,
    flagging the same seeds."""
    from madsim_tpu_torch.chaos import CrashStorm, FaultPlan, GrayFailure
    from madsim_tpu_torch.check import slo_bounded
    from madsim_tpu_torch.check.device import slo_breaches
    from madsim_tpu_torch.engine import EngineConfig, LatencySpec, make_sweep, search_seeds
    from madsim_tpu_torch.engine.fused import kernel_model
    from madsim_tpu_torch.models import SOAK_SPECS, leasekv, shardkv

    cases = (
        ("46.1", leasekv.make_leasekv(army=True), EngineConfig(**SOAK_SPECS["leasekv"][1]),
         FaultPlan((leasekv.client_army(n_ops=16, t_min_ns=5_000_000, t_max_ns=300_000_000),
                    CrashStorm(targets=(1, 2, 3), n=1)), name="lease-army-crash"),
         LatencySpec(ops=16, phases=2), 4000),
        ("46.2", shardkv.make_shardkv(record=True, army=True, chaos=False),
         EngineConfig(pool_size=96, time_limit_ns=600_000_000),
         FaultPlan((shardkv.client_army(n_ops=16, t_min_ns=5_000_000, t_max_ns=280_000_000),
                    GrayFailure(targets=(0, 1), n_links=1, mult_min=8, mult_max=16)),
                   name="shard-army-gray"),
         LatencySpec(ops=16), 3000),
    )
    for idx, wl, cfg, plan, lat, cap in cases:
        key = kernel_model(wl).key
        log(f"[{idx}] {key}: {cfg}, {LAT_SEEDS} seeds, make_run_while cap {cap}, plan "
            f"{plan.name}, {lat}; the plain step on the card holds the first "
            f"{LAT_PLAIN_SEEDS} seeds")
        r = kernel_phase(device, key, wl, cfg, LAT_SEEDS, cap, LAT_CPU_SAMPLE, REPEATS,
                         plan=plan, plain_seeds=LAT_PLAIN_SEEDS, taps=dict(latency=lat))
        if r["launches"] != 1 or r["drains"] != 1 or r["err"] != 0:
            raise AssertionError(f"{key}: launches {r['launches']}, {r['drains']}; "
                                 f"error {r['err']}")
        results.append((key, f"make_run_fused/{key}/plan-{plan.name}/latency",
                        f"madsim_tpu_torch/csrc/{kernel_model(wl).header}", r))
        paths.setdefault(key, {})["run_while_latency"] = [r["launches"], r["drains"]]
    # the SLO screen
    wl, cfg, spec, _clean, gray = latency_soak()
    key = "kvchaos-army-nochaos"
    n = LAT_SEEDS
    inv = slo_bounded(SLO_BOUND_NS, min_ops=SLO_MIN_OPS)
    t = time.perf_counter()
    rep, counts = path_launches(lambda: search_seeds(
        wl, cfg, inv, n_seeds=n, max_steps=LAT_STEPS, plan=gray, latency=spec,
        require_halt=False, device=device))
    search_ms = (time.perf_counter() - t) * 1e3
    paths[key]["slo_search"] = run_drain(counts, key)
    seeds = np.arange(n, dtype=np.uint64)
    view, counts = path_launches(lambda: make_sweep(
        wl, cfg, LAT_STEPS, device=device, plan_slots=gray.slots, latency=spec)(
            seeds, gray.compile_batch(seeds, wl=wl)))
    paths[key]["slo_sweep"] = run_drain(counts, key)
    got = []
    screen_ms = time_ms(lambda: got.append(
        slo_breaches(view["lat_hist"], SLO_BOUND_NS, min_ops=SLO_MIN_OPS)), REPEATS, device)
    flagged = got[-1].cpu().numpy()
    host = ~rep.ok
    if not np.array_equal(flagged, host) or not 0 < int(host.sum()) < n or rep.overflowed.any():
        raise AssertionError(f"SLO screen: {int(flagged.sum())} flagged on the card, "
                             f"{int(host.sum())} by slo_bounded")
    extra.setdefault(key, {}).update(slo_search_ms=search_ms,
                                     slo_screen_ms=statistics.median(screen_ms))
    log(f"[46.3] the SLO screen (p99 <= {SLO_BOUND_NS / 1e6:.2f} ms per window of at least "
        f"{SLO_MIN_OPS} ops) at {n} seeds under {gray.name}: search_seeds with slo_bounded "
        f"flags {int(host.sum())} seeds ({search_ms:.1f} ms, host clock); "
        f"check.device.slo_breaches on the sweep's sketches on the card flags the same "
        f"seeds in {spread(screen_ms)} ms; launches {paths[key]['slo_search']} and "
        f"{paths[key]['slo_sweep']}")


# ---------------------------------------------------------------------------
# phases 47-50: causal provenance (tools/causal_soak.py on the card)
# ---------------------------------------------------------------------------

# the soak's kvchaos shape: kvchaos bug=True without its own chaos,
# writes=10, pool 192, loss 0.05, 4,000 steps, its crash storm
CAUSAL_SEEDS = 4096
CAUSAL_KV_W = 10
CAUSAL_KV_KW = dict(pool_size=192, loss_p=0.05)
CAUSAL_STEPS = 4000
CAUSAL_PLAIN_SEEDS = 512
CAUSAL_CPU_SAMPLE = 64
# certificate 2's sampled seeds and ring; certificate 4's seeds and ring
FOLD_SEEDS, FOLD_CAP = tuple(range(1000, 1006)), 256
ARROW_SEEDS, ARROW_CAP = tuple(range(77, 85)), 512
ARROW_HELD_SEEDS = 1024
# certificate 3's hunt shape: the 16-write diskless raftlog-record, pool
# 192, loss 0.02, clog backoff at most 2 s, 20,000 steps, an 8,192-row
# ring, 2,048 seeds of the fixed hunt plan (phase 58 runs the JAX tool's
# campaign over it); the plain step on the card holds the first 128 seeds
# to HUNT_STEPS, every field and the search's flags, and no CPU sample
# runs that deep
HUNT_SEEDS, HUNT_PLAIN_SEEDS, HUNT_CPU_SAMPLE = 2048, 128, 0
HUNT_KW = dict(pool_size=192, loss_p=0.02, clog_backoff_max_ns=2_000_000_000)
HUNT_STEPS, HUNT_CAP, CONE_BAR = 20000, 8192, 0.25
HUNT_CONES = 8  # flagged seeds whose cone is cut at a conflicting COMMIT
# what the JAX package gives on the CPU for the same runs: the causal
# soak (tools/causal_soak.py 4096, today's run equal to CAUSAL_r13.txt)
# certificate 2's fleet shape over the 4,096-seed search (depth min and
# max, the mean concurrency width) and certificate 4's arrow-anchor
# difference and exact arrows over seeds 77-84; the JAX package's
# search_seeds of the hunt shape: the flagged seeds and the best cone
# (seed, cone rows, ring rows) among the first HUNT_CONES of them
CAUSAL_FLEET = (77, 142, 5.524386402978896)
# the JAX package's search_seeds of phase 47's shape (device_check, no
# ring, 4,096 seeds): its flagged seeds and the digest of its traces
CAUSAL_KV_PINS = (781, "e3b96b998f59e415")
ARROW_PINS = (1050, 1291)
HUNT_FLAGGED = (96, 137, 181, 242, 245, 248, 293, 352, 413, 448, 481, 573, 587, 616, 655, 674,
                765, 768, 841, 964, 991, 1077, 1190, 1213, 1265, 1293, 1305, 1309, 1318, 1482,
                1554, 1555, 1578, 1590, 1682, 1698, 1701, 1734, 1772, 1839, 1851, 1863, 1940)
HUNT_BEST_CONE = (137, 142, 589)


def causal_plans() -> dict:
    """tools/causal_soak.py's three plans: ``kv`` (its crash storm),
    ``hunt`` (crash storm and flapping partition over raftlog's servers)
    and ``arrow`` (duplication and slowed links)."""
    from madsim_tpu_torch.chaos import CrashStorm, Duplicate, FaultPlan, FlappingPartition
    from madsim_tpu_torch.chaos import GrayFailure

    nodes = (0, 1, 2, 3, 4)
    return {
        "kv": FaultPlan((CrashStorm(targets=(1, 2, 3, 4), n=2, t_min_ns=20_000_000,
                                    t_max_ns=400_000_000, down_min_ns=50_000_000,
                                    down_max_ns=250_000_000),), name="kv-nemesis"),
        "hunt": FaultPlan((
            CrashStorm(targets=nodes, n=2, t_min_ns=150_000_000, t_max_ns=500_000_000,
                       down_min_ns=100_000_000, down_max_ns=400_000_000),
            FlappingPartition(targets=nodes, n_cycles=2, t_min_ns=50_000_000,
                              t_max_ns=400_000_000, dur_min_ns=100_000_000,
                              dur_max_ns=300_000_000, up_min_ns=20_000_000,
                              up_max_ns=200_000_000),
        ), name="raftlog-cone-hunt"),
        "arrow": FaultPlan((
            Duplicate(t_min_ns=20_000_000, t_max_ns=600_000_000, dur_min_ns=100_000_000,
                      dur_max_ns=500_000_000),
            GrayFailure(targets=nodes, n_links=2, t_min_ns=20_000_000, t_max_ns=600_000_000,
                        dur_min_ns=100_000_000, dur_max_ns=500_000_000, mult_min=8,
                        mult_max=32),
        ), name="dup-slowlink"),
    }


def kv_screens() -> tuple:
    from madsim_tpu_torch.check.device import read_your_writes, stale_reads

    return (stale_reads(), read_your_writes())


def screened(screens, st) -> np.ndarray:
    """The screens' verdict on a state's history columns, on its device."""
    from madsim_tpu_torch.check.device import screen_ok

    return screen_ok(screens, st.hist_word, st.hist_t, st.hist_count, st.hist_drop).cpu().numpy()


def causal_kv_phase(device, results: list, paths: dict, extra: dict, card: str) -> dict:
    """Phase 47 (certificate 1): kvchaos-bug-nochaos at the soak's shape
    with metrics, a 128-row ring and the causal axis, held as phases 4-15
    (the six columns against the plain step on the card on the first 512
    seeds and on a CPU sample); the same run without the axis has every
    other field equal (traces and the screens' verdicts too), and so do
    the search and the compacted run; the kernel's ms with and without.
    Phase 48 (certificate 2) rides it: the fleet's causal shape of the
    kernel run, reduced on the card. Returns the plain reference and the
    search report."""
    from madsim_tpu_torch.engine import (
        CAUSAL_STATE_FIELDS, STATE_FIELDS, EngineConfig, make_init, make_run_while, search_seeds,
    )
    from madsim_tpu_torch.engine.fused import kernel_model, obs_bytes
    from madsim_tpu_torch.models import make_kvchaos
    from madsim_tpu_torch.obs import fleet_reduce

    wl = make_kvchaos(writes=CAUSAL_KV_W, record=True, bug=True, chaos=False)
    cfg, plan, key = EngineConfig(**CAUSAL_KV_KW), causal_plans()["kv"], "kvchaos-bug-nochaos"
    taps = dict(timeline_cap=128, causal=True)
    log(f"[47] {key}: {CAUSAL_KV_KW}, {CAUSAL_SEEDS} seeds, make_run_while cap "
        f"{CAUSAL_STEPS}, plan {plan.name}, metrics and {taps}; the plain step on the card "
        f"holds the first {CAUSAL_PLAIN_SEEDS} seeds")
    box, off, fleet = {}, {}, {}

    def extras(device, wl, cfg, cap, st, out, med):
        seeds = np.arange(CAUSAL_SEEDS, dtype=np.uint64)
        st_off = make_init(wl, cfg, device=device, plan_slots=plan.slots, metrics=True,
                           timeline_cap=128)(seeds, plan.compile_batch(seeds, wl=wl))
        run_off = make_run_while(wl, cfg, cap, metrics=True, timeline_cap=128)
        o = run_off(st_off)
        bad = [f for f in STATE_FIELDS if f not in CAUSAL_STATE_FIELDS
               and not torch.equal(getattr(o, f), getattr(out, f))]
        if bad or any(getattr(o, f).numel() for f in CAUSAL_STATE_FIELDS):
            raise AssertionError(f"{key}: the causal axis changed {bad}")
        if not np.array_equal(screened(kv_screens(), o), screened(kv_screens(), out)):
            raise AssertionError(f"{key}: the causal axis changed a verdict")
        off["ms"] = time_ms(lambda: run_off(st_off), REPEATS, device)
        fleet["fm"] = fleet_reduce(out.met, overflow=out.overflow, lam=out.lam)
        log(f"  the axis off: traces, verdicts and every other field equal, the causal "
            f"columns zero-size; kernel ms {spread(off['ms'])} without the axis")

    r = kernel_phase(device, key, wl, cfg, CAUSAL_SEEDS, CAUSAL_STEPS, CAUSAL_CPU_SAMPLE,
                     REPEATS, extras=extras, plan=plan, all_halt=False, refs=box, metrics=True,
                     plain_seeds=CAUSAL_PLAIN_SEEDS, taps=taps)
    if r["launches"] != 1 or r["drains"] != 1 or r["err"] != 0:
        raise AssertionError(f"{key}: launches {r['launches']}, {r['drains']}; error {r['err']}")
    results.append((key, f"make_run_fused/{key}/plan-{plan.name}/causal",
                    f"madsim_tpu_torch/csrc/{kernel_model(wl).header}", r))
    paths[key]["run_while_causal"] = [r["launches"], r["drains"]]
    extra.setdefault(key, {}).update(causal_off_ms=statistics.median(off["ms"]),
                                     causal_off_ms_all=off["ms"])
    tail = {c: obs_bytes(wl.n_nodes, cfg.pool_size, timeline_cap=128, causal=c)
            for c in (False, True)}
    extra[key].update(causal_tail_bytes=tail[True] - tail[False])
    log(f"  kernel median {r['ms']:.4f} ms with the axis, {statistics.median(off['ms']):.4f} "
        f"without (this call, {card}); the axis adds {tail[True] - tail[False]} B of shared "
        f"memory a seed ({tail[False]} -> {tail[True]} B of taps)")
    # the runners: the search (lockstep and compacted) against the one
    # without the axis
    reports = {}
    for compact in (False, True):
        for causal in (False, True):
            rep, counts = path_launches(lambda: search_seeds(
                wl, cfg, None, n_seeds=CAUSAL_SEEDS, max_steps=CAUSAL_STEPS, plan=plan,
                device_check=kv_screens(), metrics=True, require_halt=False, compact=compact,
                device=device, **({"timeline_cap": 128, "causal": True} if causal else {})))
            reports[compact, causal] = rep
            if run_drain(counts, key) != [1, 0 if compact else 1]:
                raise AssertionError(f"{key} search: launched {counts}")
            if causal:
                paths[key][f"search_causal{'_compact' if compact else ''}"] = run_drain(
                    counts, key)
    base = reports[False, False]
    for (compact, causal), rep in reports.items():
        for attr in ("ok", "traces", "flagged_idx", "overflowed", "halted"):
            if not np.array_equal(getattr(rep, attr), getattr(base, attr)):
                raise AssertionError(f"{key} search compact={compact} causal={causal}: "
                                     f"{attr} differs")
        if causal != (rep.lam is not None):
            raise AssertionError(f"{key} search: report.lam with causal={causal}")
    on = reports[False, True]
    for f in ("lam", "tl_seq", "tl_parent", "tl_lam"):
        a = on.lam if f == "lam" else getattr(on.timeline, f)
        b = reports[True, True].lam if f == "lam" else getattr(reports[True, True].timeline, f)
        if not np.array_equal(a, b):
            raise AssertionError(f"{key}: the compacted search banks another {f}")
    if (len(base.flagged_idx), traces_digest(base.traces)) != CAUSAL_KV_PINS:
        raise AssertionError(f"47: {len(base.flagged_idx)} flagged, traces "
                             f"{traces_digest(base.traces)}; the JAX package's {CAUSAL_KV_PINS}")
    log(f"[47] search_seeds with device_check, lockstep and compacted, with and without the "
        f"axis: verdicts, traces and {len(base.flagged_idx)} flagged seeds identical; the "
        f"compacted search banks the lockstep one's lam and ring columns")
    # phase 48's fleet shape: the kernel run's, reduced on the card, and
    # the search report's host copy, against the JAX package's
    fm = fleet["fm"]
    host = fleet_reduce(on.met, lam=on.lam)
    want_min, want_max, want_width = CAUSAL_FLEET
    # the width is a float64 mean: the card sums in another order than
    # the JAX package on the CPU, so it is held to 1e-12 relative
    if ((fm.depth_min, fm.depth_max) != (want_min, want_max)
            or abs(fm.width_mean - want_width) > 1e-12 * want_width
            or host.format() != fm.format()):
        raise AssertionError(f"48: fleet causal shape {fm.depth_min}, {fm.depth_max}, "
                             f"{fm.width_mean}; the JAX package's {CAUSAL_FLEET}")
    log(f"[48] fleet_reduce(met, lam=) over {CAUSAL_SEEDS} seeds, on the card: depth min "
        f"{fm.depth_min} max {fm.depth_max}, mean concurrency width {fm.width_mean!r} (the "
        f"JAX package's {CAUSAL_FLEET}); the search report's host copy reduces alike; "
        f"{CAUSAL_KV_PINS[0]} flagged and the traces the JAX package's")
    return {"ref": box[key], "report": on, "wl": wl, "cfg": cfg, "plan": plan}


def capture(wl, cfg, plan, seeds, cap: int, steps: int, device, dup_rows: bool = False):
    """The soak's ``obs.telemetry._capture`` for a few seeds: metrics, a
    ``cap``-row ring and the causal axis, through the kernel."""
    from madsim_tpu_torch.engine import make_init, make_run_while

    seeds = np.asarray(seeds, np.uint64)
    taps = dict(metrics=True, timeline_cap=cap, causal=True)
    st = make_init(wl, cfg, device=device, plan_slots=plan.slots, **taps)(
        seeds, plan.compile_batch(seeds, wl=wl))
    return make_run_while(wl, cfg, steps, dup_rows=dup_rows, **taps)(st)


def causal_fold_phase(device, paths: dict, kv: dict) -> None:
    """Phase 48 (certificate 2, the rest): seeds 1000-1005 through the
    kernel with a 256-row ring; the host's re-derivation of the Lamport
    clocks from the decoded rows equals the device fold, and the
    dispatch seqs strictly increase."""
    from madsim_tpu_torch.obs import decode_timeline, rederive

    key = "kvchaos-bug-nochaos"
    out, counts = path_launches(lambda: capture(kv["wl"], kv["cfg"], kv["plan"], FOLD_SEEDS,
                                                FOLD_CAP, CAUSAL_STEPS, device))
    paths[key]["causal_fold"] = run_drain(counts, key)
    rows = 0
    for s in range(len(FOLD_SEEDS)):
        ev = decode_timeline(out, None, s)
        seqs = [e.seq for e in ev]
        if rederive(ev) != [e.lam for e in ev] or not all(a < b for a, b in zip(seqs, seqs[1:])):
            raise AssertionError(f"48: seed {FOLD_SEEDS[s]}: the device fold is not the DAG's")
        rows += len(ev)
    log(f"[48] seeds {FOLD_SEEDS[0]}-{FOLD_SEEDS[-1]}, ring {FOLD_CAP}: launches {counts}; "
        f"rederive equals the device fold on all {rows} rows, seqs strictly increase")


def closed(cone) -> bool:
    """Every cone member's causes (its parent, its node's previous
    dispatch) are members: the backward closure."""
    from madsim_tpu_torch.obs import derive_parents

    ev, member = cone.events, set(cone.indices)
    parents, last, pred = derive_parents(ev), {}, []
    for i, e in enumerate(ev):
        pred.append(last.get(e.node))
        last[e.node] = i
    return cone.anchor in member and all(
        j is None or j in member for i in member for j in (parents[i], pred[i]))


def cones_phase(device, results: list, paths: dict, extra: dict, kv: dict) -> None:
    """Phase 49: cones on the card. The kvchaos screen sweep with a
    512-row causal ring: its flagged seeds among the first 512 are the
    plain step's (phase 47's reference, screened on the card), and each
    seed's ``violation_cones`` cone is closed and holds its anchor. Then
    the hunt shape on raftlog-record-w16-nochaos, held as phases 4-15 on
    the first 128 seeds, searched with election safety on OP_COMMIT and
    OP_ELECT: the flagged seeds are the JAX package's, and the cones cut
    at each of the first flagged seeds' conflicting COMMIT, the best at
    or under CONE_BAR of its ring."""
    from madsim_tpu_torch.check.device import election_safety, violation_cones
    from madsim_tpu_torch.engine import EngineConfig, search_seeds
    from madsim_tpu_torch.engine.fused import kernel_model
    from madsim_tpu_torch.models import make_raftlog
    from madsim_tpu_torch.models.raftlog import OP_COMMIT, OP_ELECT
    from madsim_tpu_torch.obs import causal_slice, decode_timeline

    key = "kvchaos-bug-nochaos"
    rep, counts = path_launches(lambda: search_seeds(
        kv["wl"], kv["cfg"], None, n_seeds=CAUSAL_SEEDS, max_steps=CAUSAL_STEPS, plan=kv["plan"],
        device_check=kv_screens(), require_halt=False, timeline_cap=512, causal=True,
        device=device))
    paths[key]["search_cones"] = run_drain(counts, key)
    head = rep.flagged_idx[rep.flagged_idx < CAUSAL_PLAIN_SEEDS]
    ref = kv["ref"]
    plain = np.nonzero(~screened(kv_screens(), ref) & ~(ref.hist_drop.cpu().numpy() > 0))[0]
    if not np.array_equal(head, plain) or not np.array_equal(
            rep.flagged_idx, kv["report"].flagged_idx):
        raise AssertionError(f"49: flagged {head.tolist()}, the plain step's {plain.tolist()}")
    t = time.perf_counter()
    cones = violation_cones(rep, kv["wl"])
    cone_ms = (time.perf_counter() - t) * 1e3
    if list(cones) != [int(i) for i in rep.flagged_idx] or not all(map(closed, cones.values())):
        raise AssertionError("49: a violation cone is not closed or misses its anchor")
    frac = [c.fraction for c in cones.values()]
    log(f"[49.1] search_seeds(device_check, timeline_cap=512, causal=True), {CAUSAL_SEEDS} "
        f"seeds: launches {counts}; {len(rep.flagged_idx)} flagged, those among the first "
        f"{CAUSAL_PLAIN_SEEDS} the plain step's; violation_cones in {cone_ms:.1f} ms (host): "
        f"every cone closed with its anchor, fraction of the ring min {min(frac):.3f}, median "
        f"{statistics.median(frac):.3f}, max {max(frac):.3f}")
    extra.setdefault(key, {}).update(violation_cones_ms=cone_ms)
    # the hunt shape
    wl = make_raftlog(record=True, chaos=False, durable=False, n_writes=16)
    cfg, plan = EngineConfig(**HUNT_KW), causal_plans()["hunt"]
    key = kernel_model(wl).key
    taps = dict(timeline_cap=HUNT_CAP, causal=True)
    log(f"[49.2] {key}: {HUNT_KW}, {HUNT_SEEDS} seeds, make_run_while cap {HUNT_STEPS}, plan "
        f"{plan.name}, {taps}; the plain step on the card holds the first {HUNT_PLAIN_SEEDS}")
    box = {}
    r = kernel_phase(device, key, wl, cfg, HUNT_SEEDS, HUNT_STEPS, HUNT_CPU_SAMPLE, REPEATS,
                     plan=plan, all_halt=False, refs=box, plain_seeds=HUNT_PLAIN_SEEDS, taps=taps)
    if r["launches"] != 1 or r["drains"] != 1 or r["err"] != 0:
        raise AssertionError(f"{key}: launches {r['launches']}, {r['drains']}; error {r['err']}")
    results.append((key, f"make_run_fused/{key}/plan-{plan.name}/causal",
                    f"madsim_tpu_torch/csrc/{kernel_model(wl).header}", r))
    paths[key] = {"run_while_causal": [r["launches"], r["drains"]]}
    screens = (election_safety(OP_COMMIT), election_safety(OP_ELECT))
    t = time.perf_counter()
    rep, counts = path_launches(lambda: search_seeds(
        wl, cfg, None, n_seeds=HUNT_SEEDS, max_steps=HUNT_STEPS, plan=plan,
        device_check=screens, require_halt=False, device=device, **taps))
    search_ms = (time.perf_counter() - t) * 1e3
    paths[key]["search_cones"] = run_drain(counts, key)
    plain = np.nonzero(~screened(screens, box[key]))[0]
    if (tuple(int(i) for i in rep.flagged_idx) != HUNT_FLAGGED
            or not np.array_equal(rep.flagged_idx[rep.flagged_idx < HUNT_PLAIN_SEEDS], plain)):
        raise AssertionError(f"49.2: flagged {rep.flagged_idx.tolist()}; the JAX package's "
                             f"{HUNT_FLAGGED}, the plain step's {plain.tolist()}")
    best, h = None, rep.flagged_history
    for j, row in enumerate(rep.flagged_idx[:HUNT_CONES]):
        ev = decode_timeline(rep.timeline, wl, int(row))
        seen, anchor = {}, None
        for i in range(int(h.count[j])):
            w = tuple(int(x) for x in h.word[j, i])
            if w[0] != OP_COMMIT:
                continue
            if w[1] in seen and seen[w[1]] != w[2]:
                anchor = (int(h.t[j, i]), w)
                break
            seen.setdefault(w[1], w[2])
        if anchor is None:
            log(f"  seed {int(row)}: NEGATIVE, no conflicting COMMIT pair in its history")
            continue
        cone = causal_slice(ev, anchor=(anchor[0], anchor[1][3]))
        if not closed(cone):
            raise AssertionError(f"49.2: seed {int(row)}'s cone is not closed")
        log(f"  seed {int(row)}: conflicting COMMIT key={anchor[1][1]} args "
            f"{seen[anchor[1][1]]} vs {anchor[1][2]} at t={anchor[0]} ns; cone "
            f"{len(cone.indices)}/{len(ev)} = {cone.fraction:.3f} of the ring (depth "
            f"{cone.depth}, {len(cone.chaos_indices)} fault dispatches inside)")
        if best is None or cone.fraction < best[1].fraction:
            best = (int(row), cone)
    if best is None:
        log("  NEGATIVE: flagged seeds but none witnessed by a conflicting COMMIT pair")
    else:
        row, cone = best
        got = (row, len(cone.indices), len(cone.events))
        if got != HUNT_BEST_CONE or cone.fraction > CONE_BAR:
            raise AssertionError(f"49.2: best cone {got}, the JAX package's {HUNT_BEST_CONE}")
        log(f"  best cone: seed {row}, {cone.fraction:.3f} <= {CONE_BAR} of its ring (the JAX "
            f"package's {HUNT_BEST_CONE})")
    extra.setdefault(key, {})["search_ms"] = search_ms
    log(f"[49.2] search_seeds(device_check, timeline_cap={HUNT_CAP}, causal=True): launches "
        f"{counts}; {len(rep.flagged_idx)} flagged, the JAX package's seeds, those among the "
        f"first {HUNT_PLAIN_SEEDS} the plain step's; {search_ms:.1f} ms (host clock, the "
        f"{HUNT_SEEDS * HUNT_CAP} ring rows copied to the host)")


def arrow_endpoints(doc) -> dict:
    """Multiset of flow-arrow start anchors (pid, ts) of a Perfetto doc."""
    out: dict = {}
    for row in doc["traceEvents"]:
        if row.get("cat") == "flow" and row.get("ph") == "s":
            out[row["pid"], row["ts"]] = out.get((row["pid"], row["ts"]), 0) + 1
    return out


def arrows_phase(device, results: list, paths: dict, kv: dict) -> None:
    """Phase 50 (certificate 4): kvchaos-bug-nochaos-dup under the soak's
    duplication and gray-failure plan, held as phases 4-15 at 1,024 seeds
    with a 512-row causal ring; seeds 77-84 decoded: the exact and the
    stripped Perfetto documents differ on arrow anchors, every exact
    arrow matches its parent column, and the counts are the JAX
    package's."""
    import dataclasses

    from madsim_tpu_torch.engine.fused import kernel_model
    from madsim_tpu_torch.obs import decode_timeline, to_perfetto

    wl, cfg, plan = kv["wl"], kv["cfg"], causal_plans()["arrow"]
    key = kernel_model(wl, dup_rows=True).key
    taps = dict(timeline_cap=ARROW_CAP, causal=True)
    log(f"[50] {key}: {CAUSAL_KV_KW}, {ARROW_HELD_SEEDS} seeds, make_run_while cap "
        f"{CAUSAL_STEPS}, plan {plan.name} with dup_rows, metrics and {taps}")
    r = kernel_phase(device, key, wl, cfg, ARROW_HELD_SEEDS, CAUSAL_STEPS, CAUSAL_CPU_SAMPLE,
                     REPEATS, plan=plan, dup_rows=True, all_halt=False, metrics=True, taps=taps)
    if r["launches"] != 1 or r["drains"] != 1 or r["err"] != 0:
        raise AssertionError(f"{key}: launches {r['launches']}, {r['drains']}; error {r['err']}")
    results.append((key, f"make_run_fused/{key}/plan-{plan.name}/causal",
                    f"madsim_tpu_torch/csrc/{kernel_model(wl).header}", r))
    paths[key] = {"run_while_causal": [r["launches"], r["drains"]]}
    out, counts = path_launches(lambda: capture(wl, cfg, plan, ARROW_SEEDS, ARROW_CAP,
                                                CAUSAL_STEPS, device, dup_rows=True))
    paths[key]["arrows"] = run_drain(counts, key)
    diff = exact = 0
    for s, seed in enumerate(ARROW_SEEDS):
        ev = decode_timeline(out, wl, s)
        a_exact = arrow_endpoints(to_perfetto(ev, wl, seed=seed))
        a_heur = arrow_endpoints(to_perfetto(
            [dataclasses.replace(x, seq=-1, parent=-1, emit_ns=-1) for x in ev], wl, seed=seed))
        diff += sum(abs(a_exact.get(k, 0) - a_heur.get(k, 0)) for k in set(a_exact) | set(a_heur))
        by_seq = {x.seq: x for x in ev}
        for x in ev:
            if x.src >= 0 and x.parent >= 0 and x.parent in by_seq:
                p = by_seq[x.parent]
                if (p.node, (x.emit_ns if x.emit_ns >= 0 else p.time_ns) / 1e3) not in a_exact:
                    raise AssertionError(f"50: seed {seed}: an exact arrow misses its parent")
                exact += 1
    if (diff, exact) != ARROW_PINS:
        raise AssertionError(f"50: {diff} anchors differ, {exact} exact arrows; the JAX "
                             f"package's {ARROW_PINS}")
    log(f"[50] seeds {ARROW_SEEDS[0]}-{ARROW_SEEDS[-1]}, ring {ARROW_CAP}: launches {counts}; "
        f"the exact and the stripped Perfetto documents differ on {diff} arrow anchors, all "
        f"{exact} exact arrows match the parent column (the JAX package's {ARROW_PINS})")


# ---------------------------------------------------------------------------
# phases 51-54: client retries (tools/retry_soak.py on the card)
# ---------------------------------------------------------------------------

# the soak's shapes: kvchaos-record army with two replicas and shardkv
# army, both without their own chaos, pool 96, 3,000 steps, 16 ops; the
# plain step on the card holds the first 256 seeds
RETRY_N_OPS = 16
RETRY_SEEDS, RETRY_PLAIN_SEEDS, RETRY_CPU_SAMPLE = 2048, 256, 8
RETRY_STEPS = 3000
RETRY_KV_KW = dict(pool_size=96, time_limit_ns=450_000_000, clog_backoff_max_ns=2_000_000_000)
RETRY_SK_KW = dict(pool_size=96, time_limit_ns=600_000_000)
RETRY_KV_LAT = dict(ops=RETRY_N_OPS, phases=3, phase_ns=1 << 27)
RETRY_SK_LAT = dict(ops=RETRY_N_OPS)
# certificate 2's seeds; certificate 3's sweep on the fixed hunt plan
# (phase 58 runs the JAX tool's campaign over it), its plain seeds and
# the flagged seeds checked alone
RETRY_AMP_SEEDS = 512
NOIDEM_SEEDS, NOIDEM_PLAIN_SEEDS, NOIDEM_CHECKED = 1024, 128, 8
# phase 54: the step goldens' kvchaos army scenario (pool 72) with the
# soak's kvchaos policy on its army, every tap and the causal axis
RETRY_OBS_KW = dict(pool_size=72, loss_p=0.02, clog_backoff_max_ns=2_000_000_000)
RETRY_OBS_LAT = dict(ops=10, phases=3, phase_ns=1 << 27)
RETRY_OBS_SEEDS, RETRY_OBS_PLAIN_SEEDS, RETRY_OBS_STEPS = 4096, 512, 2000
RETRY_OBS_TAPS = dict(causal=True, timeline_cap=256, cov_words=64, cov_hitcount=True)
RETRY_OBS_DECODED = 8
# what the JAX package gives on the CPU for the same runs
# (tests/_torch_retry_pins.py 2048; its certificates 1 and 2 equal
# tools/retry_soak.py's run and RETRY_r14.txt): per search (failing,
# re-sends, give-ups, trace digest); phase 53's flagged count and trace
# digest and first flagged seeds, its exclusivity counts, the shrunk
# events, rounds, probes and trace; phase 54's try arrows, re-sent army
# rows, trace digest and ring drops over seeds 0-7
RETRY_PINS = {
    "kv": (0, 8319, 0, "e6c48bc4b1211d6e"),
    "sk": (0, 27281, 8234, "e7b7e2e0e232d323"),
    "kv-quiet": (0, 0, 0, "b5ea70111c89e3eb"),
    "kv-gray": (0, 2049, 0, "d699e350cdc34072"),
    "noidem": (1024, "0d1c0472f2ac532e", [0, 1, 2, 3, 4, 5, 6, 7]),
    "exclusive": (8, 0),
    "shrink": ([(149768918, 25, 0, 0, 1), (122549377, 25, 1, 0, 1)], 4, 18,
               "0x845cf52ef4d73a92"),
    # the army's probes carry the plain op id, so no message arrow names
    # an attempt (0); the re-sent army rows are timers in the rings
    "obs": (0, 86, "e58659fb82771811", 827),
}


def retry_plans() -> dict:
    """tools/retry_soak.py's plans (its kvchaos army quiet and under the
    gray failure, its shardkv army plan) and phase 54's, with the port's
    classes (tests/_torch_retry_pins.py ``retry_plans``)."""
    from madsim_tpu_torch.chaos import CrashStorm, FaultPlan, GrayFailure, RetryPolicy
    from madsim_tpu_torch.models import kvchaos, shardkv

    kv_pol = RetryPolicy(timeout_ns=50_000_000, max_attempts=3, backoff_base_ns=10_000_000,
                         backoff_mult=2.0, jitter=0.5)
    sk_pol = RetryPolicy(timeout_ns=8_000_000, max_attempts=3, backoff_base_ns=4_000_000,
                         backoff_mult=2.0, jitter=0.25)
    kv_army = kvchaos.client_army(n_ops=RETRY_N_OPS, t_min_ns=5_000_000, t_max_ns=280_000_000,
                                  n_replicas=2, retry=kv_pol)
    gray = GrayFailure(targets=(0, 3), n_links=1, mult_min=6, mult_max=12)

    def sk(name):
        return FaultPlan((shardkv.client_army(n_ops=RETRY_N_OPS, t_min_ns=5_000_000,
                                              t_max_ns=280_000_000, retry=sk_pol),
                          GrayFailure(targets=(0, 1), n_links=1, mult_min=8, mult_max=16)),
                         name=name)

    servers = tuple(range(5))
    return {
        "kv-quiet": FaultPlan((kv_army,), name="kv-retry-quiet"),
        "kv-gray": FaultPlan((kv_army, gray), name="kv-retry-gray"),
        "sk-clean": sk("sk-retry-clean"),
        "sk-hunt": sk("sk-noidem-hunt"),
        "kv-obs": FaultPlan((
            kvchaos.client_army(n_ops=10, t_min_ns=5_000_000, t_max_ns=400_000_000,
                                retry=kv_pol),
            CrashStorm(targets=servers, n=1, t_min_ns=50_000_000, t_max_ns=200_000_000,
                       down_min_ns=20_000_000, down_max_ns=80_000_000),
            GrayFailure(targets=servers, n_links=1, mult_min=4, mult_max=8,
                        t_min_ns=30_000_000, t_max_ns=150_000_000, dur_min_ns=50_000_000,
                        dur_max_ns=150_000_000),
        )),
    }


def retry_workloads() -> dict:
    """The soak's workloads: kvchaos-record army (two replicas), shardkv
    army clean and noidem, and phase 54's golden kvchaos army."""
    from madsim_tpu_torch.models import make_kvchaos, make_shardkv

    return {
        "kv": make_kvchaos(writes=12, n_replicas=2, chaos=False, army=True, record=True),
        "sk": make_shardkv(record=True, chaos=False, army=True),
        "noidem": make_shardkv(record=True, chaos=False, army=True, bug="noidem"),
        "obs": make_kvchaos(record=True, army=True, army_probes=2),
    }


def retry_invariants() -> dict:
    """The soak's history invariants: the kvchaos floors, the shardkv
    pair and the noidem hunt's exactly_once."""
    from madsim_tpu_torch.check import exactly_once, read_your_writes, shard_coverage
    from madsim_tpu_torch.check import stale_reads
    from madsim_tpu_torch.models import shardkv

    return {
        "kv": lambda h: stale_reads(h) & read_your_writes(h),
        "sk": lambda h: (exactly_once(h, shardkv.OP_ARMY_PUT)
                         & shard_coverage(h, shardkv.OP_SHARD_OWN, shardkv.OP_SHARD_WRITE)),
        "noidem": lambda h: exactly_once(h, shardkv.OP_ARMY_PUT),
    }


def shardkv_screens() -> tuple:
    """The device screens of retry_invariants()'s shardkv pair."""
    from madsim_tpu_torch.check import device as dc
    from madsim_tpu_torch.models import shardkv

    return (dc.exactly_once(shardkv.OP_ARMY_PUT),
            dc.shard_coverage(shardkv.OP_SHARD_OWN, shardkv.OP_SHARD_WRITE))


def retry_counts(rep) -> tuple:
    """(failing, re-sends, give-ups, trace digest) of a search report."""
    from madsim_tpu_torch.engine import MET_RETRY, MET_RETRY_GIVEUP

    met = rep.met.astype(np.int64)
    return (int(rep.failing_seeds.size), int(met[:, MET_RETRY].sum()),
            int(met[:, MET_RETRY_GIVEUP].sum()), traces_digest(rep.traces))


def retry_kernel(device, idx: str, key: str, wl, cfg, plan, lat, n_seeds: int, steps: int,
                 plain_seeds: int, metrics: bool, results: list, paths: dict, extra: dict,
                 card: str, taps: dict | None = None) -> dict:
    """One retry library held as phases 4-15 under ``plan``'s policy
    (the three columns against the plain step on the card on the first
    ``plain_seeds`` seeds and a CPU sample), the kernel's ms beside the
    same plan's without the policy (the compiled rows are the same)."""
    from madsim_tpu_torch.engine import make_init, make_run_while
    from madsim_tpu_torch.engine.fused import kernel_model

    rt = plan.retry_spec()
    taps = dict(taps or {}, latency=lat)
    log(f"[{idx}] {key}: {cfg}, {n_seeds} seeds, make_run_while cap {steps}, plan "
        f"{plan.name} ({plan.hash()}) with {rt}; metrics {metrics}, {taps}; the plain step "
        f"on the card holds the first {plain_seeds} seeds")
    off = {}

    def extras(device, wl, cfg, cap, st, out, med):
        seeds = np.arange(n_seeds, dtype=np.uint64)
        st_off = make_init(wl, cfg, device=device, plan_slots=plan.slots, metrics=metrics,
                           **taps)(seeds, plan.compile_batch(seeds, wl=wl))
        run_off = make_run_while(wl, cfg, cap, metrics=metrics, **taps)
        off["ms"] = time_ms(lambda: run_off(st_off), REPEATS, device)
        if not out.rt_done.any() or out.rt_attempt.shape != (n_seeds, rt.n_ops):
            raise AssertionError(f"{key}: no op saw its response under the policy")

    r = kernel_phase(device, key, wl, cfg, n_seeds, steps, RETRY_CPU_SAMPLE, REPEATS,
                     extras=extras, plan=plan, metrics=metrics, plain_seeds=plain_seeds,
                     taps=dict(taps, retry=rt))
    if r["launches"] != 1 or r["drains"] != 1 or r["err"] != 0:
        raise AssertionError(f"{key}: launches {r['launches']}, {r['drains']}; error {r['err']}")
    results.append((key, f"make_run_fused/{key}/plan-{plan.name}/retry",
                    f"madsim_tpu_torch/csrc/{kernel_model(wl).header}", r))
    paths.setdefault(key, {})[f"run_while_retry_{idx}"] = [r["launches"], r["drains"]]
    extra.setdefault(key, {}).update({f"retry_off_ms_{idx}": statistics.median(off["ms"])})
    log(f"  kernel median {r['ms']:.4f} ms with the policy, {statistics.median(off['ms']):.4f} "
        f"without ({spread(off['ms'])}; this call, {card})")
    return r


def retry_clean_phase(device, results: list, paths: dict, extra: dict, card: str) -> None:
    """Phase 51 (certificate 1): the clean models under retries, each held
    as phases 4-15 and searched at the soak's shape with its history
    invariant; the counts are the JAX package's."""
    from madsim_tpu_torch.engine import EngineConfig, LatencySpec, search_seeds
    from madsim_tpu_torch.engine.fused import kernel_model

    plans, wls, invs = retry_plans(), retry_workloads(), retry_invariants()
    for idx, pin, cfg_kw, lat_kw, plan in (
            ("51.1", "kv", RETRY_KV_KW, RETRY_KV_LAT, plans["kv-gray"]),
            ("51.2", "sk", RETRY_SK_KW, RETRY_SK_LAT, plans["sk-clean"])):
        wl, cfg, lat = wls[pin], EngineConfig(**cfg_kw), LatencySpec(**lat_kw)
        key = kernel_model(wl).key
        retry_kernel(device, idx, key, wl, cfg, plan, lat, RETRY_SEEDS, RETRY_STEPS,
                     RETRY_PLAIN_SEEDS, True, results, paths, extra, card)
        # 51.2's histories (1,088 rows a seed) are judged on the card by the
        # device screens of its two checkers (held equal to them in 33)
        judge = (dict(device_check=shardkv_screens()) if pin == "sk"
                 else dict(history_invariant=invs[pin]))
        t = time.perf_counter()
        rep, counts = path_launches(lambda: search_seeds(
            wl, cfg, None, n_seeds=RETRY_SEEDS, max_steps=RETRY_STEPS, plan=plan, latency=lat,
            metrics=True, require_halt=False, device=device, **judge))
        search_ms = (time.perf_counter() - t) * 1e3
        paths[key][f"search_retry_{idx}"] = run_drain(counts, key)
        got = retry_counts(rep)
        if got != RETRY_PINS[pin] or rep.overflowed.any() or rep.unhalted_seeds.size:
            raise AssertionError(f"{idx}: (failing, re-sends, give-ups, traces) {got}, "
                                 f"{int(rep.overflowed.sum())} overflowed; the JAX package's "
                                 f"{RETRY_PINS[pin]}")
        extra[key][f"retry_search_ms_{idx}"] = search_ms
        log(f"[{idx}] search_seeds with {'the device screens' if 'device_check' in judge else 'the history invariant'}, {RETRY_SEEDS} seeds: launches "
            f"{counts}; {got[0]} violations, {got[1]} re-sent attempts, {got[2]} give-ups, "
            f"traces {got[3]} (the JAX package's); {search_ms:.1f} ms (host clock)")


def retry_amplification_phase(device, paths: dict) -> None:
    """Phase 52 (certificate 2): the kvchaos army quiet and under the gray
    failure, 512 seeds each: the re-sends are the JAX package's and the
    slow link at least doubles them."""
    from madsim_tpu_torch.engine import EngineConfig, LatencySpec, search_seeds
    from madsim_tpu_torch.engine.fused import kernel_model

    plans, wl = retry_plans(), retry_workloads()["kv"]
    cfg, lat, key = EngineConfig(**RETRY_KV_KW), LatencySpec(**RETRY_KV_LAT), kernel_model(wl).key
    ones = lambda v: np.ones(v["halted"].shape[0], bool)  # noqa: E731
    got = {}
    for name in ("kv-quiet", "kv-gray"):
        rep, counts = path_launches(lambda: search_seeds(
            wl, cfg, ones, n_seeds=RETRY_AMP_SEEDS, max_steps=RETRY_STEPS, plan=plans[name],
            latency=lat, metrics=True, require_halt=False, device=device))
        paths[key][f"amplification_{name}"] = run_drain(counts, key)
        got[name] = retry_counts(rep)
        if got[name] != RETRY_PINS[name]:
            raise AssertionError(f"52 {name}: {got[name]}; the JAX package's {RETRY_PINS[name]}")
    quiet, gray = got["kv-quiet"][1], got["kv-gray"][1]
    if gray == 0 or gray < 2 * quiet:
        raise AssertionError(f"52: gray failure {gray} re-sends against quiet {quiet}")
    log(f"[52] retry amplification over {RETRY_AMP_SEEDS} seeds: quiet {quiet} re-sends, gray "
        f"failure {gray} (the JAX package's); launches "
        f"{paths[key]['amplification_kv-quiet']}, {paths[key]['amplification_kv-gray']}")


def noidem_phase(device, results: list, paths: dict, extra: dict, card: str) -> None:
    """Phase 53 (certificate 3 on the fixed hunt plan): the new library
    shardkv-noidem-army-nochaos held as phases 4-15 on the first 128 of
    1,024 seeds, then swept with exactly_once: the flagged seeds and
    traces are the JAX package's; exactly_once catches each of the first
    8 flagged seeds alone and shard_coverage none; the first shrinks
    under the plan's policy to the JAX package's events, rounds, probes
    and trace, and the shrunk plan replays twice to that trace and the
    violation."""
    from madsim_tpu_torch.chaos import shrink_plan
    from madsim_tpu_torch.check import shard_coverage
    from madsim_tpu_torch.engine import EngineConfig, LatencySpec, search_seeds
    from madsim_tpu_torch.engine.fused import kernel_model
    from madsim_tpu_torch.models import shardkv

    plan, wl = retry_plans()["sk-hunt"], retry_workloads()["noidem"]
    inv = retry_invariants()["noidem"]
    cfg, lat, key = EngineConfig(**RETRY_SK_KW), LatencySpec(**RETRY_SK_LAT), kernel_model(wl).key
    rt = plan.retry_spec()
    retry_kernel(device, "53", key, wl, cfg, plan, lat, NOIDEM_SEEDS, RETRY_STEPS,
                 NOIDEM_PLAIN_SEEDS, False, results, paths, extra, card)
    rep, counts = path_launches(lambda: search_seeds(
        wl, cfg, None, n_seeds=NOIDEM_SEEDS, max_steps=RETRY_STEPS, plan=plan, latency=lat,
        require_halt=False, history_invariant=inv, device=device))
    paths[key]["sweep"] = run_drain(counts, key)
    first = [int(x) for x in rep.failing_seeds[:NOIDEM_CHECKED]]
    got = (int(rep.failing_seeds.size), traces_digest(rep.traces), first)
    if got != RETRY_PINS["noidem"]:
        raise AssertionError(f"53: (flagged, traces, first) {got}; the JAX package's "
                             f"{RETRY_PINS['noidem']}")
    box = {}

    def both(h):
        box["cov"] = shard_coverage(h, shardkv.OP_SHARD_OWN, shardkv.OP_SHARD_WRITE)
        return inv(h)

    eo = cov = 0
    for seed in first:
        one = search_seeds(wl, cfg, None, seeds=np.asarray([seed], np.uint64),
                           max_steps=RETRY_STEPS, plan=plan, history_invariant=both, latency=lat,
                           require_halt=False, retry=rt, device=device)
        eo += int(not bool(one.ok[0]))
        cov += int(not bool(box["cov"][0]))
    if (eo, cov) != RETRY_PINS["exclusive"]:
        raise AssertionError(f"53: exactly_once catches {eo}, shard_coverage {cov}")
    log(f"[53] sweep of {NOIDEM_SEEDS} seeds: launches {counts}; {got[0]} flagged, traces "
        f"{got[1]}, the first {first} (the JAX package's); alone, exactly_once catches {eo} "
        f"of them and shard_coverage {cov}")
    t = time.perf_counter()
    res, counts = path_launches(lambda: shrink_plan(
        wl, cfg, first[0], plan, history_invariant=inv, max_steps=RETRY_STEPS, latency=lat,
        device=device))
    shrink_ms = (time.perf_counter() - t) * 1e3
    paths[key]["shrink"] = run_drain(counts, key)
    shrunk = ([tuple(vars(e).values()) for e in res.events], res.rounds, res.tested,
              f"{res.trace:#x}")
    if shrunk != RETRY_PINS["shrink"]:
        raise AssertionError(f"53: shrunk to {shrunk}; the JAX package's {RETRY_PINS['shrink']}")
    for _ in range(2):
        one = search_seeds(wl, cfg, None, seeds=np.asarray([first[0]], np.uint64),
                           max_steps=RETRY_STEPS, plan=res.plan, history_invariant=inv,
                           latency=lat, require_halt=False, retry=rt, device=device)
        if bool(one.ok[0]) or int(one.traces[0]) != res.trace:
            raise AssertionError("53: the shrunk plan does not replay its violation and trace")
    extra[key].update(shrink_ms=shrink_ms)
    log(f"[53] shrink_plan of seed {first[0]} under the plan's policy: {len(res.events)} of "
        f"{len(plan.compile(first[0]))} events in {res.rounds} rounds, {res.tested} probes "
        f"(launches {counts}, {shrink_ms:.1f} ms host clock), trace {res.trace:#x} (the JAX "
        f"package's); replayed twice with the spec: the same trace and the violation")


def retry_obs_phase(device, results: list, paths: dict, extra: dict, card: str) -> None:
    """Phase 54: the policy with every tap and the causal axis on the OBS
    build of kvchaos-record-army (pool 72): the step goldens' army
    scenario with the soak's kvchaos policy, held as phases 4-15 on the
    first 512 seeds (every column: the bitmap, hit counts, ring, causal
    and retry columns); seeds 0-7 decoded, their Perfetto documents'
    try arrows and re-sent army rows the JAX package's counts."""
    from madsim_tpu_torch.engine import EngineConfig, LatencySpec, make_init, make_run_while
    from madsim_tpu_torch.engine import retry_token_attempt
    from madsim_tpu_torch.engine.fused import kernel_model
    from madsim_tpu_torch.obs import decode_timeline, to_perfetto

    plan, wl = retry_plans()["kv-obs"], retry_workloads()["obs"]
    cfg, lat, key = EngineConfig(**RETRY_OBS_KW), LatencySpec(**RETRY_OBS_LAT), kernel_model(wl).key
    rt = plan.retry_spec()
    retry_kernel(device, "54", key, wl, cfg, plan, lat, RETRY_OBS_SEEDS, RETRY_OBS_STEPS,
                 RETRY_OBS_PLAIN_SEEDS, True, results, paths, extra, card, taps=RETRY_OBS_TAPS)
    seeds = np.arange(RETRY_OBS_DECODED, dtype=np.uint64)
    taps = dict(RETRY_OBS_TAPS, metrics=True, latency=lat, retry=rt)
    out, counts = path_launches(lambda: make_run_while(wl, cfg, RETRY_OBS_STEPS, **taps)(
        make_init(wl, cfg, device=device, plan_slots=plan.slots, **taps)(
            seeds, plan.compile_batch(seeds, wl=wl))))
    paths[key]["retry_capture"] = run_drain(counts, key)
    arrows = retried = 0
    for s in range(RETRY_OBS_DECODED):
        ev = decode_timeline(out, wl, s)
        doc = to_perfetto(ev, name=wl.name, seed=s)
        arrows += sum(1 for row in doc["traceEvents"] if row.get("cat") == "flow"
                      and row.get("ph") == "s" and " try" in row["name"])
        retried += sum(1 for e in ev if e.kind == rt.kind and e.node == rt.node
                       and retry_token_attempt(int(e.args[0])) > 0)
    got = (arrows, retried, traces_digest(out.trace.cpu().numpy().view(np.uint64)),
           int(out.tl_drop.sum()))
    if got != RETRY_PINS["obs"]:
        raise AssertionError(f"54: (try arrows, re-sent rows, traces, ring drops) {got}; the "
                             f"JAX package's {RETRY_PINS['obs']}")
    log(f"[54] seeds 0-{RETRY_OBS_DECODED - 1} captured with {taps}: launches {counts}; "
        f"{arrows} try arrows and {retried} re-sent army rows in the Perfetto documents and "
        f"rings ({got[3]} rows past the rings), traces {got[2]} (the JAX package's)")


# ---------------------------------------------------------------------------
# phases 55-59: coverage-guided exploration on the card
# ---------------------------------------------------------------------------

# the explore soak's shapes (tools/explore_soak.py): kvchaos-bug without
# its own chaos (writes=10, pool 192, loss 0.05, 4,000 steps, 64
# coverage words) under its crash storm, 8 generations of 256 against a
# uniform sweep of 2,048; the 3 x 64 determinism campaign; the
# diskless-raftlog hunt (pool 128, loss 0.02, clog backoff at most 2 s,
# 6,000 steps) under the crash storm and flapping partition. Each
# phase holds the first EXPLORE_HELD children of a bred generation (its
# seeds and plan rows, the bitmap on) against the plain step on the card
EXPLORE_KV_W, EXPLORE_KV_STEPS, EXPLORE_CW = 10, 4000, 64
EXPLORE_KV_KW = dict(pool_size=192, loss_p=0.05)
EXPLORE_RL_KW = dict(pool_size=128, loss_p=0.02, clog_backoff_max_ns=2_000_000_000)
EXPLORE_RL_STEPS = 6000
EXPLORE_HELD = 64
# phases 55-56 hold their bred children to this many steps, not the
# 4,000-step cap (the plain step on the card costs some 18 ms a step
# there; EXPLORE_PINS hold the full-cap campaigns)
EXPLORE_KV_HELD_STEPS = 1000
# phase 58 holds the cone hunt's bred children to this many steps, not
# to halt (some 1,100 steps, 35 ms a step of the plain step on the card;
# EXPLORE_PINS hold the full-cap campaign)
CONE_HELD_STEPS = 300
EXPLORE_KV_RUN = dict(generations=8, batch=256, root_seed=7, max_steps=EXPLORE_KV_STEPS,
                      cov_words=EXPLORE_CW, max_ops=1, inherit_seed_p=0.9)
EXPLORE_SMALL_RUN = dict(EXPLORE_KV_RUN, generations=3, batch=64)
EXPLORE_HUNT_RUN = dict(generations=8, batch=256, root_seed=2024, max_steps=EXPLORE_RL_STEPS,
                        cov_words=EXPLORE_CW, select_top=24, max_ops=2, inherit_seed_p=0.85,
                        require_halt=False)
# the retry soak's noidem hunt (tools/retry_soak.py: shardkv-noidem-army
# at pool 96 with the latency tap, 32 coverage words) and the causal
# soak's cone hunt (tools/causal_soak.py: the 16-write diskless
# raftlog-record at pool 192, 20,000 steps), as campaigns
EXPLORE_RETRY_RUN = dict(generations=3, batch=128, root_seed=14, max_steps=RETRY_STEPS,
                         cov_words=32, select_top=16, max_ops=2)
EXPLORE_CONE_RUN = dict(generations=2, batch=256, root_seed=2024, max_steps=HUNT_STEPS,
                        cov_words=EXPLORE_CW, select_top=24, max_ops=2, inherit_seed_p=0.85,
                        require_halt=False)
# phase 59: run_device on raft at pool 64 (the JAX package's device
# test plan), 8 generations of 4,096, 600 steps, 16 coverage words
DEVICE_KW = dict(pool_size=64, loss_p=0.02)
DEVICE_RUN = dict(generations=8, batch=4096, root_seed=11, max_steps=600, cov_words=16)
# the generations of a campaign whose waits for the card phases 59 and
# 65 count (the profiler costs about a second a generation)
SYNC_COUNTED = 2
# what the JAX package gives on the CPU for the same campaigns
# (tests/_torch_explore_pins.py; its 55-57 equal tools/explore_soak.py
# 2048's counts, curves and traces): the uniform sweep's violations and
# bits; each campaign's violations, bits, curves, its digest (corpus,
# coverage map, violations, curves: explore_digest) and first find's
# (generation, id, seed, trace); each shrink's events, original count,
# rounds, probes and trace
EXPLORE_PINS = {'uniform': (409, 207),
 'guided': {'viol': 1052,
            'bits': 330,
            'curve': [201, 300, 326, 329, 329, 330, 330, 330],
            'viol_curve': [41, 129, 257, 417, 586, 740, 891, 1052],
            'digest': 'b2155b2eb632e6f9'},
 'small': {'viol': 52,
           'digest': 'ba1359b5534f4cb5',
           'first': (0, 13, 13757108714105341989, '0xf9bcc89d446e5bb6'),
           'shrink': {'events': [(147059402, 1, 2, 0, 0)],
                      'original': 4,
                      'rounds': 2,
                      'tested': 14,
                      'trace': '0x5d0276f6da658715'}},
 'hunt': {'viol': 896,
          'bits': 1122,
          'curve': [850, 938, 1001, 1040, 1076, 1088, 1111, 1122],
          'viol_curve': [2, 9, 58, 209, 383, 543, 722, 896],
          'digest': 'd14b2a65699daf1d',
          'first': (0, 56, 11941286033598001408, '0x75017e711dd009ad'),
          'shrink': {'events': [(277209742, 0, 2, 0, 0), (608581647, 1, 4, 0, 0),
                                (171632634, 2, 0, 3, 0), (171632634, 2, 1, 2, 0),
                                (171632634, 2, 2, 3, 0)],
                     'original': 24,
                     'rounds': 22,
                     'tested': 514,
                     'trace': '0x2418867612c8a9c'}},
 'retry': {'viol': 382,
           'sims': 384,
           'digest': 'b4478789dc553da1',
           'first': (0, 0, 11260745734605262195, '0xca0bef9ff84c765c')},
 'cone': {'viol': 20,
          'sims': 512,
          'digest': 'a992608c560ae165',
          'first': (0, 56, 11941286033598001408, '0x1959c2b405347ec0')}}


def explore_digest(rep) -> str:
    """sha256 of a campaign's corpus (ids, generations, parents, seeds,
    plan names and hashes, traces, new bits, verdicts, halt clocks),
    coverage map, violations and curves, 16 hex digits (the pins
    script's ``campaign_digest``)."""
    fp = (
        [(e.id, e.generation, e.parent, int(e.seed), e.plan.name, e.plan.hash(),
          int(e.trace), int(e.new_bits), bool(e.violating), int(e.halt_t))
         for e in rep.corpus],
        [int(w) for w in np.asarray(rep.cov_map, np.uint32)],
        [(int(e.seed), int(e.trace)) for e in rep.violations],
        [int(x) for x in rep.curve],
        [int(x) for x in rep.viol_curve],
    )
    return hashlib.sha256(repr(fp).encode()).hexdigest()[:16]


def first_key(rep):
    """The first violation's repro key (generation, id, seed, trace)."""
    if not rep.violations:
        return None
    e = rep.violations[0]
    return (e.generation, e.id, int(e.seed), f"{int(e.trace):#x}")


def shrunk_pins(res) -> dict:
    return dict(events=[tuple(int(x) for x in vars(e).values()) for e in res.events],
                original=res.original_events, rounds=res.rounds, tested=res.tested,
                trace=f"{res.trace:#x}")


def check_pins(idx: str, got: dict, want: dict) -> None:
    bad = {k: (got[k], want[k]) for k in want if got.get(k) != want[k]}
    if bad:
        raise AssertionError(f"{idx}: (got, the JAX package's) differ: {bad}")


class RecordedSweeps:
    """Records the (seeds, plan rows) of every generation an explore
    campaign sends through the kernel: the host driver's ``search_seeds``
    calls, or the device campaign's sweeps (``make_sweep``), patched for
    the campaign and restored after."""

    def __init__(self, device_side: bool):
        from madsim_tpu_torch.explore import device as xdev
        from madsim_tpu_torch.explore import driver as xdrv

        self.mod, self.name = (xdev, "make_sweep") if device_side else (xdrv, "search_seeds")
        self.calls = []

    def __enter__(self):
        real = self.real = getattr(self.mod, self.name)
        calls = self.calls
        if self.name == "search_seeds":
            def rec(*a, **kw):
                calls.append((np.asarray(kw["seeds"], np.uint64).copy(), kw["plan_rows"]))
                return real(*a, **kw)
        else:
            def rec(*a, **kw):
                sweep = real(*a, **kw)

                def recorded(seeds, rows=None):
                    calls.append((seeds, rows))
                    return sweep(seeds, rows)
                return recorded
        setattr(self.mod, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.real)

    def head(self, g: int, k: int):
        """The first ``k`` children of generation ``g``: numpy seeds and
        numpy ``PlanRows``."""
        from madsim_tpu_torch.engine import PlanRows

        seeds, rows = self.calls[g]
        if isinstance(seeds, torch.Tensor):
            seeds = seeds.cpu().numpy().view(np.uint64)
        cols = {f: getattr(rows, f) for f in ("time", "kind", "args", "valid", "node")}
        cols = {f: (v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))[:k]
                for f, v in cols.items()}
        return np.asarray(seeds, np.uint64)[:k].copy(), PlanRows(**cols)


def held_generation(device, idx: str, key: str, wl, cfg, sweeps, g: int, cap: int, taps: dict,
                    results: list, paths: dict, dup_rows: bool = False) -> dict:
    """The first EXPLORE_HELD children of generation ``g`` (its seeds and
    plan rows) through the kernel, every field (the bitmap included)
    against the plain step on the card, timed; into the kernels line.
    A tuple of recorders holds each one's children in one batch."""
    from madsim_tpu_torch.engine import PlanRows
    from madsim_tpu_torch.engine.fused import kernel_model

    heads = [r.head(g, EXPLORE_HELD) for r in (sweeps if isinstance(sweeps, tuple)
                                                else (sweeps,))]
    seeds = np.concatenate([h[0] for h in heads])
    rows = PlanRows(**{f: np.concatenate([getattr(h[1], f) for h in heads])
                       for f in ("time", "kind", "args", "valid", "node")})
    log(f"[{idx}] {key}: the first {len(seeds)} children of generation {g} held against "
        f"the plain step on the card for at most {cap} steps, {taps}")
    r = kernel_phase(device, key, wl, cfg, len(seeds), cap, 0, REPEATS, seeds=seeds,
                     rows=rows, dup_rows=dup_rows, all_halt=False, taps=taps)
    if r["launches"] != 1 or r["drains"] != 1 or r["err"] != 0:
        raise AssertionError(f"{idx}: launches {r['launches']}, {r['drains']}; error {r['err']}")
    results.append((key, f"make_run_fused/{key}/explore-{idx}",
                    f"madsim_tpu_torch/csrc/{kernel_model(wl).header}", r))
    paths.setdefault(key, {})[f"run_while_explore_{idx}"] = [r["launches"], r["drains"]]
    return r


def walls(records: list) -> str:
    """Each generation's wall split from a campaign's telemetry."""
    out = []
    for r in records:
        if r.get("event") != "generation":
            continue
        part = f"g{r['generation']} dispatch {r['dispatch_wall_s'] * 1e3:.1f}"
        if "sync_wall_s" in r:
            part += f" sync {r['sync_wall_s'] * 1e3:.1f}"
            part += " parts " + "/".join(f"{v:.1f}" for v in r["parts_ms"].values())
        else:
            part += f" host {r['host_wall_s'] * 1e3:.1f}"
        out.append(part)
    return "; ".join(out)


def kv_explore_plan():
    from madsim_tpu_torch.chaos import CrashStorm, FaultPlan

    return FaultPlan((CrashStorm(targets=(1, 2, 3, 4), n=2, t_min_ns=20_000_000,
                                 t_max_ns=400_000_000, down_min_ns=50_000_000,
                                 down_max_ns=250_000_000),), name="kv-nemesis")


def hunt_explore_plan(name: str = "raftlog-hunt"):
    plan = causal_plans()["hunt"]
    return type(plan)(plan.specs, name=name)


def explore_guided_phase(device, results: list, paths: dict, extra: dict) -> dict:
    """Phase 55 (the explore soak's certificate 1): the uniform sweep
    and the guided host campaign at 2,048 simulations a side on
    kvchaos-bug-nochaos, their counts, curves and digests the JAX
    package's; the device campaign with the two screens equal to the
    host campaign with one host sync a generation; a bred generation's
    first 64 children held against the plain step."""
    from madsim_tpu_torch import explore
    from madsim_tpu_torch.check import read_your_writes, stale_reads
    from madsim_tpu_torch.engine import EngineConfig, search_seeds
    from madsim_tpu_torch.engine.fused import kernel_model
    from madsim_tpu_torch.models import make_kvchaos

    pins = EXPLORE_PINS
    wl = make_kvchaos(writes=EXPLORE_KV_W, record=True, bug=True, chaos=False)
    cfg, plan, key = EngineConfig(**EXPLORE_KV_KW), kv_explore_plan(), kernel_model(wl).key
    box = {}

    def hinv(h):
        box["ok"] = stale_reads(h) & read_your_writes(h)
        return box["ok"]

    budget = EXPLORE_KV_RUN["generations"] * EXPLORE_KV_RUN["batch"]
    t = time.perf_counter()
    rep, counts = path_launches(lambda: search_seeds(
        wl, cfg, None, n_seeds=budget, max_steps=EXPLORE_KV_STEPS, history_invariant=hinv,
        plan=plan, cov_words=EXPLORE_CW, device=device))
    u_ms = (time.perf_counter() - t) * 1e3
    paths.setdefault(key, {})["explore_uniform"] = run_drain(counts, key)
    u_viol = int((~box["ok"] & ~rep.overflowed).sum())
    u_bits = explore.popcount(explore.merge(np.where(rep.overflowed[:, None], 0, rep.cov)))
    if (u_viol, u_bits) != tuple(pins["uniform"]):
        raise AssertionError(f"55: uniform {u_viol} violations, {u_bits} bits; the JAX "
                             f"package's {pins['uniform']}")
    log(f"[55] uniform sweep of {budget} on {key}: launches {counts}, {u_viol} violations, "
        f"{u_bits} coverage bits ({u_ms:.1f} ms host clock; the JAX package's)")
    records = []
    t = time.perf_counter()
    with RecordedSweeps(False) as sweeps:
        guided, counts = path_launches(lambda: explore.run(
            wl, cfg, plan, history_invariant=hinv, telemetry=records.append, device=device,
            **EXPLORE_KV_RUN))
    g_ms = (time.perf_counter() - t) * 1e3
    paths[key]["explore_run"] = run_drain(counts, key)
    got = dict(viol=len(guided.violations), bits=guided.coverage_bits, curve=guided.curve,
               viol_curve=guided.viol_curve, digest=explore_digest(guided))
    check_pins("55 guided", got, pins["guided"])
    log(f"[55] guided campaign {EXPLORE_KV_RUN}: launches {counts}; {got} (the JAX "
        f"package's); {g_ms:.1f} ms host clock; guided/uniform "
        f"{got['viol'] / max(u_viol, 1):.2f}x violations, +{got['bits'] - u_bits} bits")
    log(f"  host driver walls (ms): {walls(records)}")
    records = []
    t = time.perf_counter()
    dev, counts = path_launches(lambda: explore.run_device(
        wl, cfg, plan, invariant=None, history_check=kv_screens(), telemetry=records.append,
        device=device, **EXPLORE_KV_RUN))
    d_ms = (time.perf_counter() - t) * 1e3
    paths[key]["explore_device"] = run_drain(counts, key)
    if explore_digest(dev) != got["digest"] or dev.host_syncs != EXPLORE_KV_RUN["generations"]:
        raise AssertionError(f"55: run_device digest {explore_digest(dev)}, host syncs "
                             f"{dev.host_syncs}; the host campaign's {got['digest']}")
    log(f"[55] run_device with the screens: launches {counts}; the host campaign's corpus, "
        f"map, violations and curves, {dev.host_syncs} host syncs; {d_ms:.1f} ms host clock")
    log(f"  device walls (ms; parts {'/'.join(('mutate', 'compile', 'sweep', 'judge', 'admit'))}"
        f" by CUDA events): {walls(records)}")
    extra.setdefault(key, {}).update(explore_run_ms=g_ms, explore_device_ms=d_ms)
    # the bred generation is held with phase 56's (one plain run on the
    # card for both: its cost is the step count, not the seeds)
    return dict(wl=wl, cfg=cfg, plan=plan, hinv=hinv, box=box, sweeps=sweeps)


def explore_determinism_phase(device, results: list, paths: dict, kv: dict) -> None:
    """Phase 56 (certificate 2): the 3 x 64 campaign twice, identical and
    the JAX package's; its first violation replays to its trace and
    verdict; its shrink gives the JAX package's events and trace, and
    the shrunk plan replays to that trace. Phase 55's and this phase's
    bred generations (64 children each) are held in one batch."""
    from madsim_tpu_torch import explore
    from madsim_tpu_torch.chaos import shrink_plan
    from madsim_tpu_torch.engine.fused import kernel_model

    pins = EXPLORE_PINS["small"]
    wl, cfg, plan, hinv, box = kv["wl"], kv["cfg"], kv["plan"], kv["hinv"], kv["box"]
    key = kernel_model(wl).key
    with RecordedSweeps(False) as sweeps:
        a = explore.run(wl, cfg, plan, history_invariant=hinv, device=device,
                        **EXPLORE_SMALL_RUN)
    b = explore.run(wl, cfg, plan, history_invariant=hinv, device=device, **EXPLORE_SMALL_RUN)
    if explore_digest(a) != explore_digest(b):
        raise AssertionError("56: the same root gave two campaigns")
    e = a.violations[0]
    r = explore.replay_entry(wl, cfg, e, history_invariant=hinv,
                             max_steps=EXPLORE_KV_STEPS, device=device)
    if int(r.traces[0]) != e.trace or bool(box["ok"][0]):
        raise AssertionError("56: the first violation does not replay")
    t = time.perf_counter()
    res, counts = path_launches(lambda: shrink_plan(
        wl, cfg, e.seed, e.plan, history_invariant=hinv, max_steps=EXPLORE_KV_STEPS,
        device=device))
    s_ms = (time.perf_counter() - t) * 1e3
    paths[key]["explore_shrink"] = run_drain(counts, key)
    got = dict(viol=len(a.violations), digest=explore_digest(a), first=first_key(a),
               shrink=shrunk_pins(res))
    check_pins("56", got, pins)
    again = explore.replay_entry(wl, cfg, explore.CorpusEntry(
        id=-1, generation=-1, parent=-1, seed=e.seed, plan=res.plan, trace=res.trace,
        cov=e.cov, new_bits=0, violating=True), history_invariant=hinv,
        max_steps=EXPLORE_KV_STEPS, device=device)
    if int(again.traces[0]) != res.trace:
        raise AssertionError("56: the shrunk plan does not replay its trace")
    log(f"[56] two {EXPLORE_SMALL_RUN} campaigns identical, {got['viol']} violations, "
        f"digest {got['digest']}; g{e.generation} id{e.id} replays; shrink {res.original_events}"
        f" -> {len(res.events)} events in {res.rounds} rounds, {res.tested} probes (launches "
        f"{counts}, {s_ms:.1f} ms host clock), trace {res.trace:#x}: the JAX package's; the "
        f"shrunk plan replays")
    held_generation(device, "55-56", key, wl, cfg, (kv["sweeps"], sweeps), 1,
                    EXPLORE_KV_HELD_STEPS, dict(cov_words=EXPLORE_CW), results, paths)


def explore_hunt_phase(device, results: list, paths: dict, extra: dict) -> None:
    """Phase 57 (certificates 3-4): the diskless-raftlog hunt on the new
    library raftlog-record-nochaos (pool 128, the taps kernel): its
    violations, curves, digest and first find the JAX package's; the
    find replays; its shrink gives the JAX package's events, rounds,
    probes and trace, and the shrunk plan replays to the violation."""
    from madsim_tpu_torch import explore
    from madsim_tpu_torch.chaos import shrink_plan
    from madsim_tpu_torch.check import election_safety
    from madsim_tpu_torch.engine import EngineConfig, search_seeds
    from madsim_tpu_torch.engine.fused import kernel_model
    from madsim_tpu_torch.models import make_raftlog, raftlog

    pins = EXPLORE_PINS["hunt"]
    wl = make_raftlog(record=True, chaos=False, durable=False)
    cfg, plan, key = EngineConfig(**EXPLORE_RL_KW), hunt_explore_plan(), kernel_model(wl).key

    def inv(h):
        return (election_safety(h, elect_op=raftlog.OP_COMMIT)
                & election_safety(h, elect_op=raftlog.OP_ELECT))

    t = time.perf_counter()
    with RecordedSweeps(False) as sweeps:
        hunt, counts = path_launches(lambda: explore.run(
            wl, cfg, plan, history_invariant=inv, device=device, **EXPLORE_HUNT_RUN))
    h_ms = (time.perf_counter() - t) * 1e3
    paths.setdefault(key, {})["explore_run"] = run_drain(counts, key)
    e = hunt.violations[0]
    r = explore.replay_entry(wl, cfg, e, history_invariant=inv, max_steps=EXPLORE_RL_STEPS,
                             device=device)
    if int(r.traces[0]) != e.trace or bool(r.ok[0]):
        raise AssertionError("57: the first find does not replay")
    t = time.perf_counter()
    res, s_counts = path_launches(lambda: shrink_plan(
        wl, cfg, e.seed, e.plan, history_invariant=inv, max_steps=EXPLORE_RL_STEPS,
        device=device))
    s_s = time.perf_counter() - t
    paths[key]["explore_shrink"] = run_drain(s_counts, key)
    got = dict(viol=len(hunt.violations), bits=hunt.coverage_bits, curve=hunt.curve,
               viol_curve=hunt.viol_curve, digest=explore_digest(hunt), first=first_key(hunt),
               shrink=shrunk_pins(res))
    check_pins("57", got, pins)
    rs = search_seeds(wl, cfg, None, seeds=np.asarray([e.seed], np.uint64),
                      max_steps=EXPLORE_RL_STEPS, history_invariant=inv, plan=res.plan,
                      require_halt=False, device=device)
    if int(rs.traces[0]) != res.trace or bool(rs.ok[0]):
        raise AssertionError("57: the shrunk plan does not replay its violation and trace")
    extra.setdefault(key, {}).update(explore_run_ms=h_ms, shrink_s=s_s)
    log(f"[57] diskless-raftlog hunt on {key} {EXPLORE_HUNT_RUN}: launches {counts}; "
        f"{got['viol']} violations, {got['bits']} bits, curves {got['curve']} "
        f"{got['viol_curve']}, first find {got['first']} ({h_ms:.1f} ms host clock); shrink "
        f"{res.original_events} -> {len(res.events)} events in {res.rounds} rounds, "
        f"{res.tested} probes (launches {s_counts}) in {s_s:.2f} s wall, trace "
        f"{res.trace:#x}: the JAX package's; the shrunk plan replays the violation")
    held_generation(device, "57", key, wl, cfg, sweeps, 1, EXPLORE_RL_STEPS,
                    dict(cov_words=EXPLORE_CW), results, paths)


def explore_soak_hunts_phase(device, results: list, paths: dict) -> None:
    """Phase 58: the retry soak's noidem hunt and the causal soak's cone
    hunt as the campaigns those tools run: each campaign's violations,
    digest and first find the JAX package's, a bred generation held
    against the plain step."""
    from madsim_tpu_torch import explore
    from madsim_tpu_torch.check import election_safety
    from madsim_tpu_torch.engine import EngineConfig, LatencySpec
    from madsim_tpu_torch.engine.fused import kernel_model
    from madsim_tpu_torch.models import make_raftlog, raftlog

    plan, wl = retry_plans()["sk-hunt"], retry_workloads()["noidem"]
    cfg, lat, key = EngineConfig(**RETRY_SK_KW), LatencySpec(**RETRY_SK_LAT), kernel_model(wl).key
    t = time.perf_counter()
    with RecordedSweeps(False) as sweeps:
        rep, counts = path_launches(lambda: explore.run(
            wl, cfg, plan, history_invariant=retry_invariants()["noidem"], latency=lat,
            device=device, **EXPLORE_RETRY_RUN))
    ms = (time.perf_counter() - t) * 1e3
    paths.setdefault(key, {})["explore_run"] = run_drain(counts, key)
    got = dict(viol=len(rep.violations), sims=rep.sims, digest=explore_digest(rep),
               first=first_key(rep))
    check_pins("58 retry hunt", got, EXPLORE_PINS["retry"])
    log(f"[58] the noidem hunt on {key} {EXPLORE_RETRY_RUN}: launches {counts}; {got} (the "
        f"JAX package's; {ms:.1f} ms host clock)")
    held_generation(device, "58", key, wl, cfg, sweeps, 1, RETRY_STEPS,
                    dict(cov_words=EXPLORE_RETRY_RUN["cov_words"], latency=lat,
                         retry=plan.retry_spec()), results, paths)

    wl = make_raftlog(record=True, chaos=False, durable=False, n_writes=16)
    cfg, plan, key = EngineConfig(**HUNT_KW), causal_plans()["hunt"], kernel_model(wl).key

    def inv(h):
        return (election_safety(h, elect_op=raftlog.OP_COMMIT)
                & election_safety(h, elect_op=raftlog.OP_ELECT))

    t = time.perf_counter()
    with RecordedSweeps(False) as sweeps:
        rep, counts = path_launches(lambda: explore.run(
            wl, cfg, plan, history_invariant=inv, device=device, **EXPLORE_CONE_RUN))
    ms = (time.perf_counter() - t) * 1e3
    paths.setdefault(key, {})["explore_run"] = run_drain(counts, key)
    got = dict(viol=len(rep.violations), sims=rep.sims, digest=explore_digest(rep),
               first=first_key(rep))
    check_pins("58 cone hunt", got, EXPLORE_PINS["cone"])
    log(f"[58] the cone hunt on {key} {EXPLORE_CONE_RUN}: launches {counts}; {got} (the JAX "
        f"package's; {ms:.1f} ms host clock)")
    held_generation(device, "58", key, wl, cfg, sweeps, 1, CONE_HELD_STEPS,
                    dict(cov_words=EXPLORE_CW), results, paths)


def explore_device_phase(device, results: list, paths: dict, extra: dict) -> None:
    """Phase 59: run_device on raft at pool 64 (the taps kernel built
    there), 8 generations of 4,096: the first 64 children of a bred
    generation held against the plain step (the bitmap included); a
    second campaign with a new root seed builds nothing
    (``compile_wall_s`` 0.0 in every generation); each generation's
    parts timed by CUDA events; the mutator's first-maximum pick on the
    card."""
    from madsim_tpu_torch import explore
    from madsim_tpu_torch.chaos import FaultPlan, GrayFailure, PauseStorm
    from madsim_tpu_torch.engine import EngineConfig
    from madsim_tpu_torch.engine.fused import kernel_model
    from madsim_tpu_torch.explore import device as xdev
    from madsim_tpu_torch.models import make_raft

    mask = torch.tensor([[False, True, True, False, True], [True] * 5, [False] * 5],
                        device=device)
    picks = xdev._kth_true(mask, torch.tensor([1, 4, 0], device=device)).tolist()
    if picks != [2, 4, 0]:
        raise AssertionError(f"59: the device pick takes {picks}, not the first maximum")
    nodes = (0, 1, 2, 3, 4)
    plan = FaultPlan((
        PauseStorm(targets=nodes, n=1, t_min_ns=20_000_000, t_max_ns=300_000_000,
                   down_min_ns=50_000_000, down_max_ns=200_000_000),
        GrayFailure(targets=nodes, n_links=1),
    ), name="device-explore-test")
    wl, cfg = make_raft(), EngineConfig(**DEVICE_KW)
    key = kernel_model(wl).key

    def inv(view):
        return view["halted"]

    runs = []
    for root in (DEVICE_RUN["root_seed"], DEVICE_RUN["root_seed"] + 1):
        records = []
        # the second, warm campaign runs under the sync guard and counts
        # its first SYNC_COUNTED generations' waits for the card (the
        # profiler's end waits too: its wall is not the first's)
        strict = root != DEVICE_RUN["root_seed"]
        t = time.perf_counter()
        with (nullcontext() if strict else RecordedSweeps(True)) as sweeps, \
                profiler_counts() as syncs, \
                (xdev.strict_syncs() if strict else nullcontext()), \
                (xdev.counted_syncs(SYNC_COUNTED) if strict else nullcontext()):
            rep, counts = path_launches(lambda: explore.run_device(
                wl, cfg, plan, invariant=inv, telemetry=records.append, device=device,
                **dict(DEVICE_RUN, root_seed=root)))
        ms = (time.perf_counter() - t) * 1e3
        runs.append((rep, counts, records, sweeps, ms, syncs))
    (rep, counts, records, sweeps, ms, _s), second = runs[0], runs[1]
    paths.setdefault(key, {})["explore_device"] = run_drain(counts, key)
    if rep.host_syncs != DEVICE_RUN["generations"] or not rep.corpus:
        raise AssertionError(f"59: {rep.host_syncs} consume points, {len(rep.corpus)} entries")
    cold = [r["compile_wall_s"] for r in second[2] if r["event"] == "generation"]
    counted = [r["host_syncs"] for r in second[2] if r["event"] == "generation"]
    want = [1] * SYNC_COUNTED + [None] * (DEVICE_RUN["generations"] - SYNC_COUNTED)
    if any(cold) or counted != want or len(second[5]) != SYNC_COUNTED or \
            second[0].host_syncs != DEVICE_RUN["generations"]:
        raise AssertionError(f"59: the second campaign's compile_wall_s {cold}, counted "
                             f"host syncs {counted} ({sync_text(second[5])})")
    log(f"[59] run_device on {key} {DEVICE_RUN}: launches {counts}; corpus "
        f"{len(rep.corpus)}, {rep.coverage_bits} bits, {len(rep.violations)} violations, "
        f"curve {rep.curve}, {rep.host_syncs} consume points, {ms:.1f} ms host clock; the "
        f"second campaign (root {DEVICE_RUN['root_seed'] + 1}) under strict_syncs: "
        f"compile_wall_s {cold}, host syncs a generation {counted} (counted: "
        f"{sync_text(second[5])}), {second[4]:.1f} ms host clock")
    log(f"  walls (ms; parts mutate/compile/sweep/judge/admit by CUDA events): "
        f"{walls(records)}")
    log(f"  second campaign walls: {walls(second[2])}")
    extra.setdefault(key, {}).update(explore_device_ms=ms, explore_device_second_ms=second[4])
    held_generation(device, "59", key, wl, cfg, sweeps, 1, DEVICE_RUN["max_steps"],
                    dict(cov_words=DEVICE_RUN["cov_words"]), results, paths)


# ---------------------------------------------------------------------------
# phases 60-65: the campaign observability, the farm and seed sharding
# ---------------------------------------------------------------------------

# tools/flight_soak.py at its defaults: raft at pool 64 under its plan,
# three campaigns of 4 x 4,096 (64 steps, 32 coverage words, roots 7-9)
# and the halt-invariant hunt (3 x 4,096, 96 steps, root 7)
SOAK_RAFT_KW = dict(pool_size=64, loss_p=0.02)
FLIGHT_RUN = dict(generations=4, batch=4096, max_steps=64, cov_words=32)
FLIGHT_ROOTS = (7, 8, 9)
FLIGHT_HALT = dict(generations=3, batch=4096, root_seed=7, max_steps=96, cov_words=32)
# tools/farm_soak.py at its defaults: certificate 1's raft campaign (1,024
# a generation, 6 generations, 256 steps, 3 interleaved rounds, organic
# and loaded), certificate 2's three tenants, certificates 3-4 on the
# kvchaos lost-write mutant (pool 192, loss 0.02, 800 steps, 8 x 256)
FARM_RUN = dict(generations=6, batch=1024, root_seed=7, max_steps=256, cov_words=32)
FARM_ROUNDS = 3
FARM_TENANTS = {
    "halt": dict(batch=256, root_seed=11, max_steps=256, cov_words=32),
    "biased": dict(batch=272, root_seed=5, max_steps=256, cov_words=32),
    "wide": dict(batch=256, root_seed=2, max_steps=384, cov_words=64),
}
FARM_TENANT_INV = {"halt": "halt", "biased": "biased", "wide": "halt"}
FARM_KV_KW = dict(pool_size=192, loss_p=0.02)
FARM_KV_RUN = dict(generations=8, batch=256, max_steps=800, cov_words=64, max_ops=1,
                   inherit_seed_p=0.9)
FARM_KV_ROOTS = (7, 13, 29)
# tools/obs_soak.py certificates 3 and 5: the diskless-raftlog hunt
# (raftlog-record-nochaos, pool 128), 2 x 256, root 2024
OBS_RL_RUN = dict(generations=2, batch=256, root_seed=2024, max_steps=EXPLORE_RL_STEPS,
                  cov_words=EXPLORE_CW, select_top=24, max_ops=2, inherit_seed_p=0.85,
                  require_halt=False)
OBS_RING = 4096
# phase 65: the compacted runner sharded over a world of one card, at
# phase 31's hunt shape (kvchaos bug=True, writes 5, pool 192, loss 0.05)
SHARD_SEEDS = 1024
SHARD_STEPS = 1500
# what the JAX package gives on the CPU for the same campaigns: the
# corpus, bits, violations and digests (explore_digest) of each,
# tests/_torch_farm_pins.py and tests/_torch_obs_pins.py (the energy
# pins are (uniform violations, bits, adaptive violations, bits) per
# root; the forensics pins are sha256 prefixes of the Perfetto document
# and of the two explain texts)
FARM_PINS = {'blocking': {'corpus': 52, 'bits': 204, 'viol': 0, 'digest': '3f1061e9bb7cde8b'},
 'tenants': {'halt': {'corpus': 109, 'bits': 201, 'viol': 64, 'digest': '2c5a11e8689617a4'},
             'biased': {'corpus': 229, 'bits': 191, 'viol': 191, 'digest': 'bb272d60b7bed63b'},
             'wide': {'corpus': 50, 'bits': 218, 'viol': 4, 'digest': 'ed77cfbfe2d8c7e9'}},
 'energy': {7: (931, 325, 1039, 324), 13: (904, 325, 1000, 325), 29: (986, 328, 974, 323)},
 'inert': {'corpus': 273, 'viol': 249, 'digest': '1f845d46e16f30a4'}}
OBS_PINS = {'flight': {7: {'corpus': 41, 'bits': 154, 'digest': '7fafab498658fdfa'},
                       8: {'corpus': 46, 'bits': 172, 'digest': 'b693ece38b05c9ec'},
                       9: {'corpus': 57, 'bits': 165, 'digest': '2bfe7c35ffb55328'}},
 'halt': {'corpus': 180, 'viol': 139, 'digest': '361f13d697e7810f'},
 'hunt': {'viol': 9, 'bits': 938, 'digest': '85e7455227fd3f4b'},
 'forensics': {'events': 120, 'refold': True, 'trace': '0x2418867612c8a9c',
               'perfetto': 'ae0b20fb38e2dd0b', 'explain': 'e9a751e45b2bb9b2',
               'explain_causal': '72d716b64f872846', 'shrunk': 5}}


def soak_plan(name: str):
    """The flight and farm soaks' raft plan: a crash storm, a pause storm
    and a gray failure."""
    from madsim_tpu_torch.chaos import CrashStorm, FaultPlan, GrayFailure, PauseStorm

    nodes = (0, 1, 2, 3, 4)
    return FaultPlan((
        CrashStorm(targets=(1, 2, 3), n=2, t_min_ns=20_000_000, t_max_ns=400_000_000,
                   down_min_ns=50_000_000, down_max_ns=250_000_000),
        PauseStorm(targets=nodes, n=1, t_min_ns=20_000_000, t_max_ns=300_000_000,
                   down_min_ns=50_000_000, down_max_ns=200_000_000),
        GrayFailure(targets=nodes, n_links=1),
    ), name=name)


def soak_invariants() -> dict:
    """The soaks' final-state invariants over the tensor view."""
    return {
        "cov": lambda view: view["halted"] | True,
        "halt": lambda view: view["halted"],
        "biased": lambda view: (view["trace"] & 7) != 0,
    }


def campaign_pins(rep, *keys) -> dict:
    got = dict(corpus=len(rep.corpus), bits=rep.coverage_bits, viol=len(rep.violations),
               digest=explore_digest(rep))
    return {k: got[k] for k in keys}


def scratch_dir(fresh: bool = False):
    """The phases' files (flight logs, checkpoints, a store), under
    ``build/checkpoints/`` (``.gitignore``); ``fresh`` empties it first:
    a flight log appends."""
    import shutil
    from pathlib import Path

    path = Path(__file__).resolve().parent / "build" / "checkpoints" / "phases_60_65"
    if fresh:
        shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True, exist_ok=True)
    return path


def jsonl(path) -> list:
    return [json.loads(line) for line in open(path)]


def flight_phase(device, paths: dict, extra: dict) -> dict:
    """Phase 60 (tools/flight_soak.py at its defaults): three run_device
    campaigns under one profiler build each program once and campaigns
    2-3 nothing; the recorder on and off gives the same campaigns on
    both drivers with the wall-split schema and one host sync a device
    generation (``strict_syncs``); the halt hunt's campaign Perfetto; the cache A/B
    printed. Returns the halt hunt's device campaign (phase 65's
    unsharded reference)."""
    from madsim_tpu_torch import explore, obs
    from madsim_tpu_torch.engine import EngineConfig
    from madsim_tpu_torch.explore import device as xdev
    from madsim_tpu_torch.models import make_raft
    from madsim_tpu_torch.obs import prof

    wl, cfg, plan, inv = make_raft(), EngineConfig(**SOAK_RAFT_KW), soak_plan("flight-soak"), \
        soak_invariants()
    tmp = scratch_dir()
    xdev._GEN_CACHE.clear()
    walls_c, got = [], {}
    with prof.profiled() as p:
        for root in FLIGHT_ROOTS:
            t = time.perf_counter()
            rep, counts = path_launches(lambda: explore.run_device(
                wl, cfg, plan, invariant=inv["cov"], root_seed=root, device=device,
                **FLIGHT_RUN))
            walls_c.append((rep.wall_compile_s, time.perf_counter() - t))
            got[root] = campaign_pins(rep, "corpus", "bits", "digest")
            paths["raft"][f"flight_campaign_{root}"] = run_drain(counts, "raft")
        retr = p.retraces("explore.device")
        table = p.report()
    if not retr or any(v != 1 for v in retr.values()) or walls_c[1][0] or walls_c[2][0]:
        raise AssertionError(f"60: retraces {retr}, compile walls {walls_c}")
    check_pins("60 flight campaigns", got, OBS_PINS["flight"])
    log(f"[60] three run_device campaigns {FLIGHT_RUN} on raft 64 (roots {FLIGHT_ROOTS}): "
        f"retraces {sorted(set(retr.values()))} over {len(retr)} keys, compile_wall_s "
        f"{[round(c, 3) for c, _w in walls_c]}, wall {[round(w, 2) for _c, w in walls_c]} s; "
        f"corpus, bits and digests the JAX package's")
    for line in table.splitlines():
        log(f"    {line}")
    # the cache A/B: a fresh workload and invariant identity builds again
    ab = {}
    for tag, w, i in (("cached", wl, inv["cov"]), ("uncached", make_raft(),
                                                   lambda v: v["halted"] | True)):
        t = time.perf_counter()
        rep = explore.run_device(w, cfg, plan, invariant=i, root_seed=20, device=device,
                                 **FLIGHT_RUN)
        ab[tag] = (time.perf_counter() - t, rep.wall_compile_s)
    log(f"  cache A/B (printed, not gated): cached {ab['cached'][0]:.2f} s (compile "
        f"{ab['cached'][1]:.3f}), uncached {ab['uncached'][0]:.2f} s (compile "
        f"{ab['uncached'][1]:.3f})")
    # the recorder on and off, both drivers
    halt = {}
    for tag, runner in (("device", explore.run_device), ("host", explore.run)):
        off, counts = path_launches(lambda: runner(wl, cfg, plan, invariant=inv["halt"],
                                                   device=device, **FLIGHT_HALT))
        paths["raft"][f"flight_{tag}"] = run_drain(counts, "raft")
        path = tmp / f"{tag}.jsonl"
        # strict_syncs holds the device driver to its one sync a
        # generation, counted by the profiler under counted_syncs; the
        # host driver has no device session: its waits are counted over
        # the campaign
        host = tag == "host"
        with profiler_counts() as syncs, (prof.count_syncs() if host else xdev.strict_syncs()), \
                (nullcontext() if host else xdev.counted_syncs()), \
                obs.FlightRecorder(str(path), heartbeat_s=0.0) as fr:
            on = runner(wl, cfg, plan, invariant=inv["halt"], telemetry=fr, device=device,
                        **FLIGHT_HALT)
        recs = jsonl(path)
        gens = [r for r in recs if r["event"] == "generation"]
        want = (("dispatch_wall_s", "compile_wall_s", "sync_wall_s") if tag == "device" else
                ("dispatch_wall_s", "compile_wall_s", "mutate_wall_s", "admit_wall_s",
                 "host_wall_s"))
        hbs = [r["generations_done"] for r in recs if r["event"] == "heartbeat"]
        ok = (explore_digest(on) == explore_digest(off)
              and len(gens) == FLIGHT_HALT["generations"]
              and all(all(k in g for k in want) for g in gens)
              and (tag == "host" or ([g["host_syncs"] for g in gens] == [1] * len(gens)
                                     and len(syncs) == len(gens)))
              and [r["seq"] for r in recs] == list(range(len(recs)))
              and hbs == list(range(1, len(gens) + 1)))
        if not ok:
            raise AssertionError(f"60: recorder on/off on the {tag} driver: {walls(recs)}")
        halt[tag] = off
        counted = (f"the campaign's waits counted: {sync_text(syncs)}" if tag == "host" else
                   f"counted host syncs a generation {[g['host_syncs'] for g in gens]} "
                   f"({sync_text(syncs[:1])}, ...)")
        log(f"  {tag} driver {FLIGHT_HALT}: recorder on == off, schema, heartbeats {hbs}; "
            f"{counted}; walls (ms) {walls(recs)}")
    check_pins("60 halt hunt", campaign_pins(halt["device"], "corpus", "viol", "digest"),
               OBS_PINS["halt"])
    if explore_digest(halt["host"]) != explore_digest(halt["device"]):
        raise AssertionError("60: the halt hunt's host and device campaigns differ")
    # the campaign Perfetto of a cold halt hunt
    path = tmp / "hunt.jsonl"
    xdev._GEN_CACHE.clear()
    with obs.FlightRecorder(str(path), heartbeat_s=0.0) as fr:
        rep = explore.run_device(wl, cfg, plan, invariant=inv["halt"], telemetry=fr,
                                 device=device, **FLIGHT_HALT)
    doc = obs.write_campaign_perfetto(str(tmp / "campaign_trace.json"), str(path))
    spans = [e for e in doc["traceEvents"] if e.get("cat") == "generation"]
    compiles = [e for e in doc["traceEvents"] if e.get("cat") == "compile"]

    def track(name):
        return [e["args"][name] for e in doc["traceEvents"]
                if e.get("ph") == "C" and e.get("name") == name]

    cov, vio = track("cov_bits"), track("violations")
    if (len(spans) != FLIGHT_HALT["generations"] or not rep.violations or cov != sorted(cov)
            or vio != sorted(vio) or not compiles):
        raise AssertionError(f"60: campaign Perfetto: {len(spans)} spans, {len(compiles)} "
                             f"compiles, tracks {cov} {vio}")
    summary = jsonl(path)[-1]
    log(f"  campaign Perfetto: {len(spans)} generation spans, cov track {cov}, violation "
        f"track {vio}, {len(compiles)} compile instants "
        f"({[e['args'].get('compile_s') for e in compiles]} s), {len(doc['traceEvents'])} "
        f"events; flight_summary memory {summary.get('memory')}, gen_cache "
        f"{summary.get('gen_cache')}")
    extra.setdefault("raft", {}).update(flight_campaign_s=[round(w, 3) for _c, w in walls_c],
                                        flight_cache_ab_s=[round(ab["cached"][0], 3),
                                                           round(ab["uncached"][0], 3)])
    return halt["device"]


class SlowSink:
    """The farm soak's emulated slow collector: each generation record
    costs ``delay`` seconds before it reaches the inner sink."""

    def __init__(self, inner, delay: float):
        self.inner, self.delay = inner, delay

    def __call__(self, rec):
        if rec.get("event") == "generation":
            time.sleep(self.delay)
        self.inner(rec)


def farm_pipeline_phase(device, paths: dict, extra: dict) -> None:
    """Phase 61 (the farm soak's certificate 1 at its shape): the
    pipelined and blocking campaigns, checkpointing every generation and
    recording to a JSONL flight log, 3 interleaved rounds, organic and
    loaded: bit-identical campaigns (the JAX package's digest), byte-equal
    checkpoint files; every round under ``strict_syncs`` (any other
    wait for the card raises); a counted round first, both drivers under
    ``counted_syncs`` too (the profiler counts each generation's waits:
    one); the ratios and the queue/idle split printed."""
    from madsim_tpu_torch import explore, farm, obs
    from madsim_tpu_torch.engine import EngineConfig
    from madsim_tpu_torch.explore import device as xdev
    from madsim_tpu_torch.models import make_raft

    wl, cfg, plan = make_raft(), EngineConfig(**SOAK_RAFT_KW), soak_plan("farm-soak")
    kw = dict(FARM_RUN, invariant=soak_invariants()["cov"], device=device)
    tmp = scratch_dir()
    explore.run_device(wl, cfg, plan, **dict(kw, generations=2))  # build both programs
    t = time.perf_counter()
    explore.run_device(wl, cfg, plan, **kw)
    gen_wall = (time.perf_counter() - t) / FARM_RUN["generations"]
    drain = 0.6 * gen_wall

    def campaign(runner, tag, r, delay, counted=False):
        ck, jl = tmp / f"{tag}{r}.ckpt", tmp / f"{tag}{r}.jsonl"
        t = time.perf_counter()
        with xdev.strict_syncs(), (xdev.counted_syncs() if counted else nullcontext()), \
                obs.FlightRecorder(str(jl), heartbeat_s=0.0, profile=False) as fr:
            sink = SlowSink(fr, delay) if delay else fr
            rep, counts = path_launches(lambda: runner(wl, cfg, plan, telemetry=sink,
                                                       checkpoint_path=str(ck), **kw))
        return rep, time.perf_counter() - t, ck.read_bytes(), jsonl(jl), counts

    # the counted round: both drivers under counted_syncs, each
    # generation's waits counted by the profiler (whose end waits for the
    # card, so the round is not timed)
    counted = {}
    for tag, runner in (("blocking", explore.run_device), ("pipelined", farm.run_pipelined)):
        with profiler_counts() as syncs:
            rep_c, _t, ck_c, rec_c, _n = campaign(runner, f"count-{tag}", 0, 0.0, counted=True)
        gens = [g["host_syncs"] for g in rec_c if g["event"] == "generation"]
        counted[tag] = (rep_c, ck_c, gens, syncs)
        if gens != [1] * FARM_RUN["generations"] or len(syncs) != len(gens):
            raise AssertionError(f"61: {tag} counted host syncs {gens} ({sync_text(syncs)})")
        log(f"[61] counted round, {tag}: host syncs a generation {gens} "
            f"({sync_text(syncs[:1])}, ...)")
    if (explore_digest(counted["blocking"][0]) != explore_digest(counted["pipelined"][0])
            or counted["blocking"][1] != counted["pipelined"][1]):
        raise AssertionError("61: the counted round's campaigns or checkpoints differ")

    ratios = {}
    for regime, delay in (("organic", 0.0), ("loaded", drain)):
        wb, wp = [], []
        for r in range(FARM_ROUNDS):
            rb, tb, cb, recb, counts_b = campaign(explore.run_device, f"blk-{regime}", r, delay)
            rp, tp, cp, recp, counts_p = campaign(farm.run_pipelined, f"pipe-{regime}", r, delay)
            wb.append(tb)
            wp.append(tp)
            gens = all(len([g for g in recs if g["event"] == "generation"])
                       == FARM_RUN["generations"] == rep.host_syncs
                       for recs, rep in ((recb, rb), (recp, rp)))
            if explore_digest(rb) != explore_digest(rp) or cb != cp or not gens:
                raise AssertionError(f"61: {regime} round {r}: pipelined != blocking "
                                     f"(checkpoints equal {cb == cp}, records {gens})")
            check_pins("61", campaign_pins(rp, "corpus", "bits", "viol", "digest"),
                       FARM_PINS["blocking"])
            end = next(x for x in recp if x["event"] == "campaign_end")
            end_b = next(x for x in recb if x["event"] == "campaign_end")
            log(f"[61] {regime:7} round {r}: blocking {tb:.3f} s (sync "
                f"{end_b['wall_sync_s']:.3f} s) | pipelined {tp:.3f} s ({tb / tp:.2f}x) | "
                f"queue {end['wall_queue_s']:.3f} s idle {end['wall_idle_s']:.3f} s respec "
                f"{end['respeculations']}")
        paths["raft"]["farm_blocking"] = run_drain(counts_b, "raft")
        paths["raft"]["farm_pipelined"] = run_drain(counts_p, "raft")
        ratios[regime] = statistics.median(wb) / statistics.median(wp)
        extra.setdefault("raft", {})[f"farm_{regime}_s"] = dict(
            blocking=[round(x, 3) for x in wb], pipelined=[round(x, 3) for x in wp])
    log(f"  generation wall {gen_wall * 1e3:.1f} ms, loaded drain {drain * 1e3:.1f} ms a "
        f"generation; median ratios (printed, not gated): organic {ratios['organic']:.3f}x, "
        f"loaded {ratios['loaded']:.3f}x; every round bit-identical with byte-equal "
        f"checkpoints; the JAX package's digest")
    for p in tmp.glob("*.ckpt"):
        p.unlink()


def farm_session_phase(device, paths: dict) -> None:
    """Phase 62 (certificate 2): three tenants in one-generation quanta:
    each tenant's scheduled campaign equals its standalone run (and the
    JAX package's digest), one build per program key, no eviction, every
    generation record tenant-tagged."""
    from madsim_tpu_torch import explore, farm, obs
    from madsim_tpu_torch.engine import EngineConfig
    from madsim_tpu_torch.explore import device as xdev
    from madsim_tpu_torch.models import make_raft
    from madsim_tpu_torch.obs import prof

    wl, cfg, plan, inv = make_raft(), EngineConfig(**SOAK_RAFT_KW), soak_plan("farm-soak"), \
        soak_invariants()
    gens = FARM_RUN["generations"]
    kws = {n: dict(k, invariant=inv[FARM_TENANT_INV[n]], device=device)
           for n, k in FARM_TENANTS.items()}
    xdev._GEN_CACHE.clear()
    ev0 = xdev.gen_cache_stats()["evictions"]
    path = scratch_dir() / "farm.jsonl"
    with prof.profiled() as p:
        refs = {n: explore.run_device(wl, cfg, plan, generations=gens, **k)
                for n, k in kws.items()}
        t = time.perf_counter()
        with obs.FlightRecorder(str(path), heartbeat_s=0.0, profile=False) as fr:
            rep, counts = path_launches(lambda: farm.run_farm(
                [farm.Tenant(n, wl, cfg, plan, generations=gens, kwargs=k)
                 for n, k in kws.items()], quantum=1, telemetry=fr))
        fw = time.perf_counter() - t
        retr = p.retraces("explore.device")
    paths["raft"]["farm_session"] = run_drain(counts, "raft")
    evictions = xdev.gen_cache_stats()["evictions"] - ev0
    tags = [x["tenant"] for x in jsonl(path) if x["event"] == "generation"]
    same = all(explore_digest(rep.reports[n]) == explore_digest(refs[n]) for n in kws)
    if (not same or not retr or any(v != 1 for v in retr.values()) or evictions
            or sorted(tags) != sorted(list(kws) * gens)):
        raise AssertionError(f"62: scheduled == standalone {same}, retraces {retr}, "
                             f"evictions {evictions}, tags {tags}")
    check_pins("62", {n: campaign_pins(rep.reports[n], "corpus", "bits", "viol", "digest")
                      for n in kws}, FARM_PINS["tenants"])
    log(f"[62] three tenants, one-generation quanta: {rep.slices} slices in {fw:.2f} s, "
        f"preemptions {rep.preemptions}, launches {counts}; scheduled == standalone == the "
        f"JAX package's digests; retraces {sorted(set(retr.values()))} over {len(retr)} "
        f"keys, {evictions} evictions; {len(tags)} tenant-tagged generation records")
    for line in rep.banner().splitlines():
        log(f"  {line}")


def energy_phase(device, paths: dict) -> None:
    """Phase 63 (certificates 3-4): adaptive energy against uniform on the
    kvchaos mutant, 8 x 256 at roots 7, 13 and 29 on the host driver:
    each campaign's violations and bits the JAX package's; energy absent,
    None and mode="uniform" one campaign (the JAX package's digest)."""
    from madsim_tpu_torch import explore, farm
    from madsim_tpu_torch.check import read_your_writes, stale_reads
    from madsim_tpu_torch.engine import EngineConfig
    from madsim_tpu_torch.engine.fused import kernel_model
    from madsim_tpu_torch.models import make_kvchaos

    wl = make_kvchaos(writes=10, record=True, bug=True, chaos=False)
    cfg, plan, key = EngineConfig(**FARM_KV_KW), kv_explore_plan(), kernel_model(wl).key

    def hinv(h):
        return stale_reads(h) & read_your_writes(h)

    got, tot = {}, [0, 0]
    t = time.perf_counter()
    for rs in FARM_KV_ROOTS:
        u = explore.run(wl, cfg, plan, root_seed=rs, history_invariant=hinv, device=device,
                        **FARM_KV_RUN)
        a, counts = path_launches(lambda: explore.run(
            wl, cfg, plan, root_seed=rs, history_invariant=hinv, energy=farm.EnergySchedule(),
            device=device, **FARM_KV_RUN))
        got[rs] = (len(u.violations), u.coverage_bits, len(a.violations), a.coverage_bits)
        tot[0] += got[rs][0]
        tot[1] += got[rs][2]
    e_s = time.perf_counter() - t
    paths.setdefault(key, {})["explore_energy"] = run_drain(counts, key)
    check_pins("63 energy", got, FARM_PINS["energy"])
    ikw = dict(FARM_KV_RUN, generations=3, root_seed=7)
    base = explore.run(wl, cfg, plan, history_invariant=hinv, device=device, **ikw)
    for off in (None, farm.EnergySchedule(mode="uniform")):
        if explore_digest(explore.run(wl, cfg, plan, history_invariant=hinv, energy=off,
                                      device=device, **ikw)) != explore_digest(base):
            raise AssertionError(f"63: energy={off!r} is not the uniform campaign")
    check_pins("63 inert", {"corpus": len(base.corpus), "viol": len(base.violations),
                            "digest": explore_digest(base)}, FARM_PINS["inert"])
    log(f"[63] adaptive energy vs uniform on {key} {FARM_KV_RUN}: per root (uniform "
        f"violations, bits, adaptive violations, bits) {got}, aggregate uniform {tot[0]} | "
        f"adaptive {tot[1]} ({e_s:.1f} s for the six campaigns); the JAX package's; energy "
        f"absent == None == uniform ({len(base.corpus)} corpus entries, "
        f"{len(base.violations)} violations)")


def obs_forensics_phase(device, paths: dict) -> None:
    """Phase 64 (tools/obs_soak.py certificates 3 and 5): the
    diskless-raftlog hunt with a JsonlSink and a checkpoint; its first
    violation shrunk, replayed with a 4,096-row ring and metrics and
    refolded; the Perfetto document, explain and explain(causal=True)
    the JAX package's (sha256 pinned); the checkpoint reloads to the
    identical corpus."""
    from madsim_tpu_torch import explore, obs
    from madsim_tpu_torch.chaos import shrink_plan
    from madsim_tpu_torch.check import election_safety
    from madsim_tpu_torch.engine import EngineConfig
    from madsim_tpu_torch.engine.fused import kernel_model
    from madsim_tpu_torch.models import make_raftlog, raftlog

    wl = make_raftlog(record=True, chaos=False, durable=False)
    cfg, plan, key = EngineConfig(**EXPLORE_RL_KW), hunt_explore_plan(), kernel_model(wl).key
    tmp = scratch_dir()
    tel, ck = tmp / "obs_soak_telemetry.jsonl", tmp / "obs_soak_campaign.json"

    def inv(h):
        return (election_safety(h, elect_op=raftlog.OP_COMMIT)
                & election_safety(h, elect_op=raftlog.OP_ELECT))

    def sha(text):
        return hashlib.sha256(text.encode()).hexdigest()[:16]

    t = time.perf_counter()
    with obs.JsonlSink(str(tel)) as sink:
        hunt, counts = path_launches(lambda: explore.run(
            wl, cfg, plan, history_invariant=inv, telemetry=sink, checkpoint_path=str(ck),
            device=device, **OBS_RL_RUN))
    h_s = time.perf_counter() - t
    paths.setdefault(key, {})["obs_hunt"] = run_drain(counts, key)
    check_pins("64 hunt", campaign_pins(hunt, "viol", "bits", "digest"), OBS_PINS["hunt"])
    e = hunt.violations[0]
    res = shrink_plan(wl, cfg, e.seed, e.plan, history_invariant=inv,
                      max_steps=EXPLORE_RL_STEPS, device=device)
    entry = explore.CorpusEntry(id=-1, generation=-1, parent=-1, seed=e.seed, plan=res.plan,
                                trace=res.trace, cov=e.cov, new_bits=0, violating=True)
    r, counts = path_launches(lambda: explore.replay_entry(
        wl, cfg, entry, history_invariant=inv, max_steps=EXPLORE_RL_STEPS,
        timeline_cap=OBS_RING, metrics=True, device=device))
    paths[key]["obs_replay"] = run_drain(counts, key)
    events = obs.decode_timeline(r.timeline, wl, 0)
    doc = obs.write_perfetto(str(tmp / "raftlog_trace.json"), events, wl, seed=e.seed)
    texts, counts = path_launches(lambda: [obs.explain(
        wl, cfg, seed=e.seed, plan=res.plan, history_invariant=inv,
        max_steps=EXPLORE_RL_STEPS, timeline_cap=OBS_RING, max_events=40, causal=c,
        device=device) for c in (False, True)])
    paths[key]["explain"] = run_drain(counts, key)
    got = dict(events=len(events), refold=obs.refold_timeline(events, wl) == int(r.traces[0]),
               trace=f"{int(r.traces[0]):#x}",
               perfetto=sha(json.dumps(doc, sort_keys=True)), explain=sha(texts[0]),
               explain_causal=sha(texts[1]), shrunk=len(res.events))
    check_pins("64 forensics", got, OBS_PINS["forensics"])
    n_disp = sum(1 for x in doc["traceEvents"] if x.get("cat") == "dispatch")
    recs = jsonl(tel)
    st = explore.load_campaign(str(ck))
    if (n_disp != len(events) or len([x for x in recs if x["event"] == "generation"]) != 2
            or st.generations_done != 2 or [x.id for x in st.corpus] != [x.id for x in hunt.corpus]
            or not np.array_equal(st.cov_map, hunt.cov_map)):
        raise AssertionError("64: the Perfetto rows, the telemetry or the checkpoint")
    log(f"[64] the diskless-raftlog hunt on {key} {OBS_RL_RUN}: {got} ({h_s:.1f} s for the "
        f"hunt); the JAX package's texts and document; {len(recs)} JSONL records; the "
        f"checkpoint reloads to the identical corpus. explain (tail):")
    for line in texts[0].splitlines()[-12:]:
        log(f"    {line}")
    for p in (tel, ck):
        p.unlink()


def parallel_phase(device, paths: dict, halt_ref) -> None:
    """Phase 65: parallel on a world of one card (NCCL, a file:// store):
    shard_run_compacted with hist_screen equals make_run_compacted per
    field; the four merges equal the one-device ones; run_device(mesh=)
    equals phase 60's run_device()."""
    import torch.distributed as dist

    from madsim_tpu_torch import explore, parallel
    from madsim_tpu_torch.check import device as dc
    from madsim_tpu_torch.explore import device as xdev
    from madsim_tpu_torch.engine import EngineConfig, make_init
    from madsim_tpu_torch.engine.compact import RESULT_FIELDS, SCREEN_FIELDS, make_run_compacted
    from madsim_tpu_torch.engine.fused import kernel_model
    from madsim_tpu_torch.models import make_kvchaos, make_raft

    store = scratch_dir() / "world_store"
    store.unlink(missing_ok=True)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}", world_size=1, rank=0)
    try:
        mesh = parallel.make_mesh()
        wl = make_kvchaos(writes=KV_WRITES, record=True, bug=True)
        cfg, key = EngineConfig(**HIST_SEARCH_KW), kernel_model(wl).key
        screens = (dc.stale_reads(), dc.read_your_writes())
        st = make_init(wl, cfg, device=device)(np.arange(SHARD_SEEDS, dtype=np.uint64))
        kw = dict(min_size=256, hist_screen=screens)
        sharded, counts = path_launches(lambda: parallel.shard_run_compacted(
            wl, cfg, SHARD_STEPS, mesh, **kw)(st))
        paths.setdefault(key, {})["parallel_compacted"] = run_drain(counts, key)
        solo = make_run_compacted(wl, cfg, SHARD_STEPS, **kw)(st)
        bad = [f for f in RESULT_FIELDS + SCREEN_FIELDS
               if not np.array_equal(getattr(sharded, f), getattr(solo, f))]
        if bad or sharded.hist_ok.all() or not sharded.hist_fold.any():
            raise AssertionError(f"65: sharded compacted run differs in {bad}")
        rng = np.random.default_rng(5)
        inputs = dict(
            merge_coverage=torch.from_numpy(rng.integers(0, 2**32, size=(4096, 32),
                                                         dtype=np.uint64).view(np.int64)
                                            & 0xFFFFFFFF).to(device),
            merge_metrics=torch.from_numpy(rng.integers(0, 2**31 - 1, size=(4096, 16))
                                           .astype(np.int32)).to(device),
            merge_latency=torch.from_numpy(rng.integers(0, 1000, size=(4096, 2, 12))
                                           .astype(np.int32)).to(device),
            merge_verdicts=torch.from_numpy(rng.random(4096) < 0.7).to(device),
        )
        for name, x in inputs.items():
            a, b = getattr(parallel, name)(x, mesh), getattr(parallel, name)(x)
            if a.dtype != b.dtype or not np.array_equal(a, b):
                raise AssertionError(f"65: {name} over the world differs from one device")
        wl_r, cfg_r = make_raft(), EngineConfig(**SOAK_RAFT_KW)
        records = []
        with profiler_counts() as syncs, xdev.strict_syncs(), \
                xdev.counted_syncs(SYNC_COUNTED):
            rep, counts = path_launches(lambda: explore.run_device(
                wl_r, cfg_r, soak_plan("flight-soak"), invariant=soak_invariants()["halt"],
                mesh=mesh, telemetry=records.append, **FLIGHT_HALT))
        paths["raft"]["parallel_run_device"] = run_drain(counts, "raft")
        gens = [r["host_syncs"] for r in records if r["event"] == "generation"]
        want = [1] * SYNC_COUNTED + [None] * (FLIGHT_HALT["generations"] - SYNC_COUNTED)
        if (explore_digest(rep) != explore_digest(halt_ref) or records[0]["mesh_devices"] != 1
                or rep.host_syncs != FLIGHT_HALT["generations"]
                or gens != want or len(syncs) != SYNC_COUNTED):
            raise AssertionError(f"65: run_device(mesh=) differs from run_device(), or its "
                                 f"counted host syncs {gens} ({sync_text(syncs)})")
        log(f"[65] a world of one card (NCCL, file:// store): shard_run_compacted with "
            f"hist_screen on {key} ({SHARD_SEEDS} seeds, {SHARD_STEPS} steps) equals "
            f"make_run_compacted in every field ({int((~sharded.hist_ok).sum())} flagged, "
            f"{int(sharded.hist_fold.sum())} records folded); the four merges equal one "
            f"device's; run_device(mesh=) {FLIGHT_HALT} equals phase 60's campaign "
            f"(mesh_devices {records[0]['mesh_devices']}), counted host syncs a generation "
            f"{gens}")
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)


# ---------------------------------------------------------------------------
# phase 66: the determinism lint on the card
# ---------------------------------------------------------------------------

# each library runs clean, then under each perturbation seed, in this
# many equal chunks of its earlier phase's step cap
NI_CHUNKS, NI_PERTURB = 4, (1, 2)


def noninterference_cases() -> tuple:
    """Phase 66's libraries at their earlier phases' shapes, nothing cut:
    (phase, workload, config, seeds, steps, plan or None, build flags,
    the model's certification horizon in ns)."""
    from madsim_tpu_torch.engine import EngineConfig, LatencySpec
    from madsim_tpu_torch.models import BENCH_SPECS, kvchaos, make_kvchaos, make_raftlog
    from madsim_tpu_torch.models import raft as raft_mod
    from madsim_tpu_torch.models import raftlog

    raft, raft_cfg, raft_n, raft_cap = spec_of("raft", {})
    rec, rec_cfg, rec_n, rec_cap = spec_of("raft", {"record": True})
    _f, rlog_kw, rlog_n, rlog_cap = BENCH_SPECS["raftlog"]
    army_plan = retry_plans()["kv-obs"]
    return (
        ("40", raft, raft_cfg, raft_n, raft_cap, None, dict(metrics=True, **OBS_TAPS),
         raft_mod.ABSINT_HORIZON_NS),
        ("21", rec, rec_cfg, rec_n, rec_cap, None, {}, raft_mod.ABSINT_HORIZON_NS),
        ("47", make_kvchaos(writes=CAUSAL_KV_W, record=True, bug=True, chaos=False),
         EngineConfig(**CAUSAL_KV_KW), CAUSAL_SEEDS, CAUSAL_STEPS, causal_plans()["kv"],
         dict(metrics=True, timeline_cap=128, causal=True), kvchaos.ABSINT_HORIZON_NS),
        ("54", retry_workloads()["obs"], EngineConfig(**RETRY_OBS_KW), RETRY_OBS_SEEDS,
         RETRY_OBS_STEPS, army_plan,
         dict(RETRY_OBS_TAPS, metrics=True, latency=LatencySpec(**RETRY_OBS_LAT),
              retry=army_plan.retry_spec()), kvchaos.ABSINT_HORIZON_NS),
        ("41.0", make_raftlog(durable=True, cov_spread=True), EngineConfig(**rlog_kw), rlog_n,
         rlog_cap, None, COV_TAPS, raftlog.ABSINT_HORIZON_NS),
    )


def lint_phase(device, paths: dict, extra: dict) -> None:
    """Phase 66: the port's lint on the card machine (no JAX there), and
    non-interference held through the run kernel: each of five libraries
    at its earlier phase's shape runs clean and under two perturbations
    of its derived columns in 4 chunks, the core columns and the trace
    equal on every seed, every chunk boundary within its contracts; the
    live control perturbs raft's ``seed``, a core column."""
    from madsim_tpu_torch.engine import make_init, make_run
    from madsim_tpu_torch.engine.fused import kernel_model
    from madsim_tpu_torch.lint import check_lanes, check_noninterference, lint_repo

    t = time.perf_counter()
    res, lanes = lint_repo(), check_lanes()
    if not res.ok or lanes["findings"]:
        raise AssertionError(f"66: lint findings {[str(f) for f in res.findings]}, lane "
                             f"findings {lanes['findings']}")
    log(f"[66] lint_repo: {res.n_files} files, no finding, {len(res.allowed)} pragmas all "
        f"used; {lanes['sites']} draw sites over lanes {lanes['lanes']}, no lane finding "
        f"({time.perf_counter() - t:.1f} s)")
    for phase, wl, cfg, n, steps, plan, flags, horizon in noninterference_cases():
        key = kernel_model(wl).key
        seeds = np.arange(n, dtype=np.uint64)
        st = make_init(wl, cfg, device=device, plan_slots=plan.slots if plan else 0, **flags)
        st = st(seeds, plan.compile_batch(seeds, wl=wl)) if plan else st(seeds)
        t = time.perf_counter()
        rep, counts = path_launches(lambda: check_noninterference(
            wl, cfg, run=make_run, seeds=st, n_steps=steps, chunks=NI_CHUNKS,
            perturb_seeds=NI_PERTURB, horizon_ns=horizon, **flags))
        ms = (time.perf_counter() - t) * 1e3
        if not rep.ok or rep.n_seeds != n or rep.horizon_ns != horizon:
            raise AssertionError(f"66 ({phase}) {key}: {rep.summary()}")
        paths.setdefault(key, {})[f"noninterference_{phase}"] = run_drain(counts, key)
        extra.setdefault(key, {})[f"noninterference_{phase}_ms"] = round(ms, 1)
        log(f"  ({phase}) {key}: {rep.summary()}; {len(rep.derived)} columns "
            f"{list(rep.derived)}; launches {counts}; {ms:.1f} ms host clock")
    # the live control: raft's seed, a core column, perturbed the same way
    phase, wl, cfg, n, steps, plan, flags, _h = noninterference_cases()[0]
    st = make_init(wl, cfg, device=device, **flags)(np.arange(n, dtype=np.uint64))
    rep = check_noninterference(wl, cfg, run=make_run, seeds=st, n_steps=steps,
                                chunks=NI_CHUNKS, perturb_seeds=NI_PERTURB[:1],
                                fields=("seed",), ranges=False, **flags)
    if rep.ok or "seed" not in rep.diffs or "trace" not in rep.diffs:
        raise AssertionError(f"66: perturbing raft's seed went unreported: {rep.diffs}")
    log(f"  the control: raft's seed perturbed is reported: {sorted(rep.diffs)} differ "
        f"(trace on {rep.diffs['trace']['seeds']} of {n} seeds after chunk "
        f"{rep.diffs['trace']['chunk']})")


# ---------------------------------------------------------------------------
# phases 67-68: the store and latency soaks' guided hunts
# ---------------------------------------------------------------------------

# tools/store_soak.py certificate 4 (raftlog durable, record, nosync at the
# store config, STORE_PLAN) and tools/latency_soak.py certificates 4-5
# (the latency soak's army workload at pool 160 over the hunt_gray blip
# space), their shapes, nothing cut
STORE_HUNT_RUN = dict(generations=8, batch=256, root_seed=1031, max_steps=STORE_STEPS,
                      cov_words=64, select_top=24, max_ops=2, inherit_seed_p=0.85,
                      require_halt=False)
SLO_HUNT_RUN = dict(generations=8, batch=256, root_seed=7, max_steps=LAT_STEPS, cov_words=64)
# phase 68 holds its bred children to this many steps, not to halt (some
# 630 steps, 33 ms a step of the plain step on the card with the taps)
SLO_HELD_STEPS = 300
SLO_Q, SLO_RING = 0.99, 4096
# what the JAX package gives on the CPU for the same calls, printed by
#   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/_torch_hunt_pins.py
# (violations, coverage bits, both curves, the first find's generation,
# id, seed and trace, the replays' (trace equal, violation kept), the
# shrink, the uniform side's (budget, worst window-p99 bucket, bound,
# breaches) and the sha256 of each explain text)
HUNT_PINS = {'store': {'viol': 705,
           'bits': 1098,
           'curve': [885, 972, 1022, 1059, 1069, 1077, 1081, 1098],
           'viol_curve': [1, 4, 27, 152, 276, 409, 554, 705],
           'first': (0, 34, 10636629163940057250, '0x7032cca88c216057'),
           'replay': (True, True),
           'kind': 'committed-value-loss',
           'shrink': {'events': [(232728095, 0, 4, 0, 0),
                                 (418142506, 1, 4, 0, 0),
                                 (168363485, 2, 0, 1, 0),
                                 (427471745, 3, 0, 1, 0),
                                 (168363485, 2, 0, 2, 0),
                                 (427471745, 3, 0, 2, 0),
                                 (168363485, 2, 1, 3, 0),
                                 (427471745, 3, 1, 3, 0),
                                 (168363485, 2, 1, 4, 0),
                                 (427471745, 3, 1, 4, 0),
                                 (168363485, 2, 2, 3, 0),
                                 (427471745, 3, 2, 3, 0),
                                 (168363485, 2, 2, 4, 0),
                                 (427471745, 3, 2, 4, 0),
                                 (69712644, 253, 0, 0, 0),
                                 (381066598, 254, 0, 0, 0),
                                 (132316564, 253, 1, 0, 0),
                                 (425163044, 254, 1, 0, 0)],
                      'original': 32,
                      'rounds': 8,
                      'tested': 116,
                      'trace': '0xec11f9e5d9f51598'},
           'shrunk_replay': (True, True),
           'explain': 'c7d986da41d300a1c9404860979d01ecc1d33e7934dba737eb72696b59ead2a3'},
 'slo': {'uniform': (2048, 47, 225726413, 0),
         'viol': 1262,
         'bits': 176,
         'curve': [156, 174, 174, 174, 174, 176, 176, 176],
         'viol_curve': [0, 3, 48, 287, 529, 773, 1017, 1262],
         'first': (1, 19, 2505859882325233988, '0xefb58ae5f2ca3821'),
         'shrink': {'events': [(216806840, 22, 45, 0, 3),
                               (92620344, 22, 46, 0, 3),
                               (145287155, 22, 47, 0, 3),
                               (123946823, 22, 51, 0, 3),
                               (8856170, 22, 52, 0, 3),
                               (236661001, 22, 54, 0, 3),
                               (112008222, 22, 62, 0, 3),
                               (236468391, 22, 63, 0, 3),
                               (198496023, 244, 3, 3073, 0)],
                    'original': 66,
                    'rounds': 18,
                    'tested': 308,
                    'trace': '0x77f739d62e526967'},
         'replay': (True, True),
         'narrates': (True, True),
         'explain': 'a07a4412417d402e004a8b6b790f13d6640421ef2f2691e7f1a2793d62f9f75e'}}


def taps_block(wl, cfg, **taps) -> str:
    """The taps kernel's shared bytes a block at ``taps`` (the base seed
    state rounded to 16 plus the taps tail, ``obs_tail_bytes``), and how
    many such blocks an SM's 228 KB of shared memory holds (1 KB a block
    reserved; registers may allow fewer)."""
    from madsim_tpu_torch.engine.fused import KERNEL, kernel_model, obs_bytes

    occ = KERNEL.occupancy(kernel_model(wl), cfg.pool_size)
    seed = occ["run_smem_bytes"] // occ["seeds_per_block"]
    tail = obs_bytes(wl.n_nodes, cfg.pool_size, **taps)
    block = occ["seeds_per_block"] * ((seed + 15) // 16 * 16 + tail)
    return (f"{taps}: {tail} B of taps a seed, {block} B shared a block, "
            f"at most {(228 * 1024) // (block + 1024)} blocks an SM by shared memory (without: "
            f"{occ['run_smem_bytes']} B, {occ['run_blocks_per_sm']})")


def hunt_campaign_pins(rep) -> dict:
    """A campaign's violations, coverage bits, curves and first find, as
    tests/_torch_hunt_pins.py pins them."""
    e = rep.violations[0] if rep.violations else None
    return dict(viol=len(rep.violations), bits=rep.coverage_bits, curve=list(rep.curve),
                viol_curve=list(rep.viol_curve),
                first=(e.generation, e.id, int(e.seed), f"{int(e.trace):#x}") if e else None)


def sha256(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


def slo_space():
    """``(workload, config, spec, space)`` of the latency soak's hunt:
    its army workload at pool 160 over the ``hunt_gray`` blip space."""
    from madsim_tpu_torch.chaos import FaultPlan, GrayFailure

    wl, cfg, spec, clean, _gray = latency_soak()
    blip = GrayFailure(targets=(0, 1, 2, 3), n_links=1, mult_min=4, mult_max=12,
                       t_min_ns=20_000_000, t_max_ns=600_000_000, dur_min_ns=50_000_000,
                       dur_max_ns=80_000_000)
    return wl, cfg, spec, FaultPlan((*clean.specs, blip), name="slo-hunt")


def store_hunt_phase(device, results: list, paths: dict, extra: dict) -> None:
    """Phase 67 (the store soak's certificate 4): the missing-sync hunt
    on the new taps build of raftlog-nosync-record at pool 128, every pin
    the JAX package's: the campaign, its first violation's replay and
    kind, its shrink, the shrunk plan's replay and the explain text; the
    first 64 children of generation 1 held against the plain step."""
    from madsim_tpu_torch import explore, obs
    from madsim_tpu_torch.chaos import shrink_plan
    from madsim_tpu_torch.engine import EngineConfig, search_seeds
    from madsim_tpu_torch.engine.fused import kernel_model
    from madsim_tpu_torch.models import make_raftlog

    wl = make_raftlog(record=True, chaos=False, durable=True, bug="nosync")
    cfg, plan, key = EngineConfig(**STORE_KW), store_plans()["store"], kernel_model(wl).key
    t = time.perf_counter()
    with RecordedSweeps(False) as sweeps:
        hunt, counts = path_launches(lambda: explore.run(
            wl, cfg, plan, history_invariant=store_inv({}), device=device, **STORE_HUNT_RUN))
    h_ms = (time.perf_counter() - t) * 1e3
    paths.setdefault(key, {})["explore_run"] = run_drain(counts, key)
    got = hunt_campaign_pins(hunt)
    e = hunt.violations[0]
    box = {}
    r = explore.replay_entry(wl, cfg, e, history_invariant=store_inv(box),
                             max_steps=STORE_STEPS, device=device)
    got["replay"] = (int(r.traces[0]) == e.trace, not bool(r.ok[0]))
    got["kind"] = ("committed-value-loss" if not bool(box["commit"][0]) else
                   "double-vote" if not bool(box["elect"][0]) else "recovery-regression")
    t = time.perf_counter()
    res, s_counts = path_launches(lambda: shrink_plan(
        wl, cfg, e.seed, e.plan, history_invariant=store_inv({}), max_steps=STORE_STEPS,
        device=device))
    s_s = time.perf_counter() - t
    paths[key]["explore_shrink"] = run_drain(s_counts, key)
    got["shrink"] = shrunk_pins(res)
    rs = search_seeds(wl, cfg, None, seeds=np.asarray([e.seed], np.uint64),
                      max_steps=STORE_STEPS, history_invariant=store_inv({}), plan=res.plan,
                      require_halt=False, device=device)
    got["shrunk_replay"] = (int(rs.traces[0]) == res.trace, not bool(rs.ok[0]))
    text, x_counts = path_launches(lambda: obs.explain(
        wl, cfg, e.seed, plan=res.plan, history_invariant=store_inv({}), max_steps=STORE_STEPS,
        max_events=24, device=device))
    paths[key]["explain"] = run_drain(x_counts, key)
    got["explain"] = sha256(text)
    check_pins("67", got, HUNT_PINS["store"])
    extra.setdefault(key, {}).update(store_hunt_ms=h_ms, store_shrink_s=s_s)
    log(f"[67] the missing-sync hunt on {key} {STORE_HUNT_RUN}: launches {counts}; "
        f"{got['viol']} violations, {got['bits']} bits, curves {got['curve']} "
        f"{got['viol_curve']} ({h_ms:.1f} ms host clock); first find {got['first']}, "
        f"{got['kind']}, replays; shrink {res.original_events} -> {len(res.events)} events "
        f"in {res.rounds} rounds, {res.tested} probes (launches {s_counts}, {s_s:.2f} s "
        f"wall), trace {res.trace:#x}, the shrunk plan replays the violation; explain "
        f"sha256 {got['explain'][:16]}: the JAX package's")
    log(f"  the taps kernel at pool {cfg.pool_size}: "
        f"{taps_block(wl, cfg, cov_words=STORE_HUNT_RUN['cov_words'])}; explain's "
        f"{taps_block(wl, cfg, timeline_cap=1024)}")
    held_generation(device, "67", key, wl, cfg, sweeps, 1, STORE_STEPS,
                    dict(cov_words=STORE_HUNT_RUN["cov_words"]), results, paths)


def slo_hunt_phase(device, results: list, paths: dict, extra: dict) -> None:
    """Phase 68 (the latency soak's certificates 4-5): the uniform sweep
    of 2,048 calibrates the SLO at its worst window-p99 bucket with no
    breach; the guided campaign on the new taps build of
    kvchaos-army-nochaos at pool 160 breaches it; its first breach
    shrunk, replayed and told by explain with a 4,096-row ring, every
    pin the JAX package's; the first 64 children of generation 1 held
    against the plain step."""
    from madsim_tpu_torch import explore, obs
    from madsim_tpu_torch.chaos import shrink_plan
    from madsim_tpu_torch.check import slo_bounded, slo_breaches
    from madsim_tpu_torch.engine import lat_bucket_hi, search_seeds
    from madsim_tpu_torch.engine.fused import kernel_model

    wl, cfg, spec, space = slo_space()
    key = kernel_model(wl).key
    budget = SLO_HUNT_RUN["generations"] * SLO_HUNT_RUN["batch"]
    t = time.perf_counter()
    uni, counts = path_launches(lambda: search_seeds(
        wl, cfg, lambda v: np.ones(v["halted"].shape[0], bool), plan=space, n_seeds=budget,
        max_steps=LAT_STEPS, require_halt=False, latency=spec, device=device))
    u_ms = (time.perf_counter() - t) * 1e3
    paths.setdefault(key, {})["slo_uniform"] = run_drain(counts, key)
    hist = np.asarray(uni.lat_hist)
    qb = np.where(hist.sum(axis=-1) >= SLO_MIN_OPS, obs.hist_quantile_bucket(hist, SLO_Q), -1)
    worst = int(qb.max())
    bound = int(lat_bucket_hi(worst))
    slo = slo_bounded(bound, q=SLO_Q, min_ops=SLO_MIN_OPS)
    got = dict(uniform=(budget, worst, bound, int(slo_breaches(
        hist, bound, q=SLO_Q, min_ops=SLO_MIN_OPS).sum())))
    t = time.perf_counter()
    with RecordedSweeps(False) as sweeps:
        rep, counts = path_launches(lambda: explore.run(
            wl, cfg, space, invariant=slo, latency=spec, device=device, **SLO_HUNT_RUN))
    g_ms = (time.perf_counter() - t) * 1e3
    paths[key]["explore_run"] = run_drain(counts, key)
    got.update(hunt_campaign_pins(rep))
    e = rep.violations[0]
    t = time.perf_counter()
    res, s_counts = path_launches(lambda: shrink_plan(
        wl, cfg, e.seed, e.plan, invariant=slo, max_steps=LAT_STEPS, latency=spec,
        device=device))
    s_s = time.perf_counter() - t
    paths[key]["explore_shrink"] = run_drain(s_counts, key)
    got["shrink"] = shrunk_pins(res)
    import dataclasses

    r = explore.replay_entry(wl, cfg, dataclasses.replace(e, plan=res.plan), invariant=slo,
                             max_steps=LAT_STEPS, latency=spec, device=device)
    got["replay"] = (int(r.traces[0]) == res.trace, not bool(r.ok[0]))
    text, x_counts = path_launches(lambda: obs.explain(
        wl, cfg, e.seed, plan=res.plan, invariant=slo, max_steps=LAT_STEPS,
        timeline_cap=SLO_RING, latency=spec, device=device))
    paths[key]["explain_ring"] = run_drain(x_counts, key)
    got["narrates"] = ("--- latency:" in text and "p99<=" in text, "VIOLATED" in text)
    got["explain"] = sha256(text)
    check_pins("68", got, HUNT_PINS["slo"])
    extra.setdefault(key, {}).update(slo_uniform_ms=u_ms, slo_hunt_ms=g_ms, slo_shrink_s=s_s)
    log(f"[68] the SLO hunt on {key}: the uniform sweep of {budget} ({u_ms:.1f} ms host "
        f"clock) reaches window-p99 bucket {worst}: SLO p99 <= {bound / 1e6:.2f} ms, "
        f"{got['uniform'][3]} breaches; guided {SLO_HUNT_RUN}: launches {counts}, "
        f"{got['viol']} breaches, {got['bits']} bits, curves {got['curve']} "
        f"{got['viol_curve']} ({g_ms:.1f} ms host clock); first {got['first']}; shrink "
        f"{res.original_events} -> {len(res.events)} events in {res.rounds} rounds, "
        f"{res.tested} probes (launches {s_counts}, {s_s:.2f} s wall), trace {res.trace:#x}, "
        f"replayed exactly with the breach; explain with a {SLO_RING}-row ring narrates "
        f"{got['narrates']} (launches {x_counts}), sha256 {got['explain'][:16]}: the JAX "
        f"package's")
    log(f"  the taps kernel at pool {cfg.pool_size}: "
        f"{taps_block(wl, cfg, cov_words=SLO_HUNT_RUN['cov_words'])}; explain's "
        f"{taps_block(wl, cfg, timeline_cap=SLO_RING)}")
    held_generation(device, "68", key, wl, cfg, sweeps, 1, SLO_HELD_STEPS,
                    dict(cov_words=SLO_HUNT_RUN["cov_words"], latency=spec), results, paths)


# ---------------------------------------------------------------------------
# phase 69: the lint's campaign, flight and check axes through the kernel
# ---------------------------------------------------------------------------

# each campaign check: 2 generations of 256 (generation 1, bred, holds
# the children), the explore soak's step caps
AXES_RUN = dict(generations=2, batch=256, root_seed=7)
AXES_CHECK_SEEDS = 2048


def axes_phase(device, paths: dict, extra: dict) -> None:
    """Phase 69: the JAX package's CAMPAIGN_AXES, FLIGHT_AXES and
    CHECK_AXES rows as the port's dynamic checks, through the run kernel
    (``make_run``) on the card, each with its live control reported:
    sharded-campaign on kvchaos-army-nochaos 160 over the SLO-hunt space,
    sharded-causal on kvchaos-bug-nochaos 192 over phase 55's crash storm,
    each unsharded and on a one-card NCCL world; flight-campaign as the
    first inside a FlightRecorder with its profiler on; device-check on
    raftlog-nosync-record 128 (election and recovery safety) and on
    kvchaos-bug-nochaos 192 (stale reads, read your writes)."""
    import torch.distributed as dist

    from madsim_tpu_torch import parallel
    from madsim_tpu_torch.check import device as dc
    from madsim_tpu_torch.engine import EngineConfig, make_init, make_run
    from madsim_tpu_torch.engine.fused import kernel_model
    from madsim_tpu_torch.lint import (CAMPAIGN_AXES, CHECK_AXES, FLIGHT_AXES, check_campaign,
                                       check_noninterference, screens_verdict)
    from madsim_tpu_torch.models import kvchaos, make_kvchaos, make_raftlog, raftlog

    wl_a, cfg_a, _spec, space_a = slo_space()
    bound = HUNT_PINS["slo"]["uniform"][2]

    def slo_inv(v):
        return ~dc.slo_breaches(v["lat_hist"], bound, q=SLO_Q, min_ops=2)

    wl_k = make_kvchaos(writes=EXPLORE_KV_W, record=True, bug=True, chaos=False)
    cfg_k = EngineConfig(**EXPLORE_KV_KW)
    cases = (
        ("sharded-campaign", wl_a, cfg_a, space_a, dict(invariant=slo_inv, reads=("lat_hist",)),
         LAT_STEPS, CAMPAIGN_AXES["sharded-campaign"], kvchaos.ABSINT_HORIZON_NS),
        ("sharded-causal", wl_k, cfg_k, kv_explore_plan(), dict(history_check=kv_screens()),
         EXPLORE_KV_STEPS, CAMPAIGN_AXES["sharded-causal"], kvchaos.ABSINT_HORIZON_NS),
        ("flight-campaign", wl_a, cfg_a, space_a, dict(invariant=slo_inv, reads=("lat_hist",)),
         LAT_STEPS, FLIGHT_AXES["flight-campaign"], kvchaos.ABSINT_HORIZON_NS),
    )
    store = scratch_dir() / "axes_store"
    store.unlink(missing_ok=True)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}", world_size=1, rank=0)
    try:
        mesh = parallel.make_mesh()
        for axis, wl, cfg, space, judge, steps, flags, horizon in cases:
            key = kernel_model(wl).key
            for m in (None, mesh):
                if axis == "flight-campaign" and m is None:
                    continue
                t = time.perf_counter()
                rep, counts = path_launches(lambda: check_campaign(
                    wl, cfg, space, max_steps=steps, run=make_run, mesh=m, horizon_ns=horizon,
                    device=device, **judge, **AXES_RUN, **flags))
                ms = (time.perf_counter() - t) * 1e3
                tag = axis + ("" if m is None else "-mesh")
                if not rep.ok:
                    raise AssertionError(f"69 {tag} {key}: {rep.summary()}")
                paths.setdefault(key, {})[f"axes_{tag}"] = run_drain(counts, key)
                extra.setdefault(key, {})[f"axes_{tag}_ms"] = round(ms, 1)
                log(f"[69] {tag} on {key} ({'the one-card NCCL world' if m else 'unsharded'}"
                    f"): {rep.summary()}; controls {rep.controls}; campaign "
                    f"{ {k: v for k, v in rep.parts['campaign'].items() if k != 'corpus_ids'} }; "
                    f"launches {counts}; {ms:.1f} ms host clock")
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    # device-check: the check axis on two record libraries with their screens
    rl = make_raftlog(record=True, chaos=False, durable=True, bug="nosync")
    checks = (
        (rl, EngineConfig(**STORE_KW), store_plans()["store"], STORE_STEPS,
         (dc.election_safety(raftlog.OP_COMMIT), dc.election_safety(raftlog.OP_ELECT),
          dc.recovery_safety(raftlog.OP_SYNCED, raftlog.OP_RECOVER)),
         raftlog.ABSINT_HORIZON_NS),
        (wl_k, cfg_k, kv_explore_plan(), EXPLORE_KV_STEPS, kv_screens(),
         kvchaos.ABSINT_HORIZON_NS),
    )
    seeds = np.arange(AXES_CHECK_SEEDS, dtype=np.uint64)
    for wl, cfg, plan, steps, screens, horizon in checks:
        key = kernel_model(wl).key
        flags = CHECK_AXES["device-check"]
        init_flags = {k: v for k, v in flags.items() if k != "check"}
        st = make_init(wl, cfg, device=device, plan_slots=plan.slots, **init_flags)(
            seeds, plan.compile_batch(seeds, wl=wl))
        t = time.perf_counter()
        rep, counts = path_launches(lambda: check_noninterference(
            wl, cfg, run=make_run, seeds=st, n_steps=steps, horizon_ns=horizon,
            verdict=screens_verdict(screens), **flags))
        ms = (time.perf_counter() - t) * 1e3
        if not rep.ok:
            raise AssertionError(f"69 device-check {key}: {rep.summary()}")
        paths.setdefault(key, {})["axes_device-check"] = run_drain(counts, key)
        extra.setdefault(key, {})["axes_device-check_ms"] = round(ms, 1)
        log(f"[69] device-check on {key} ({AXES_CHECK_SEEDS} seeds, {steps} steps, "
            f"{plan.name}; screens {[s.kind for s in screens]}): {rep.summary()}; the control "
            f"{rep.controls['verdict']}; launches {counts}; {ms:.1f} ms host clock")


def farm_phases(device, paths: dict, extra: dict, lap) -> None:
    """Phases 60-65, each timed; their files are removed at the end."""
    import shutil

    tmp = scratch_dir(fresh=True)
    halt_ref = flight_phase(device, paths, extra)
    lap("phase 60")
    farm_pipeline_phase(device, paths, extra)
    lap("phase 61")
    farm_session_phase(device, paths)
    lap("phase 62")
    energy_phase(device, paths)
    lap("phase 63")
    obs_forensics_phase(device, paths)
    lap("phase 64")
    parallel_phase(device, paths, halt_ref)
    lap("phase 65")
    shutil.rmtree(tmp, ignore_errors=True)


# the dual-mode raft hunt (phase 70): seeds 1..DUAL_SEEDS, the engine's
# step cap, the runtime's simulated seconds a seed
DUAL_SEEDS, DUAL_STEPS, DUAL_SECONDS = 512, 600, 2.0


def dual_mode_phase(device, paths: dict, card: str) -> None:
    """Phase 70: one crash plan, both execution modes. The batched run
    is raft-record on the card; the runtime side is the port's raft KV
    application on the host, one ``Runtime`` a seed, with no torch work
    inside a simulation."""
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import _torch_raft_kv as app
    from _torch_dual import election_verdict, nemesis_events, raft_cluster, rows_events

    import madsim_tpu_torch as ms
    from madsim_tpu_torch.chaos import CrashStorm, FaultPlan
    from madsim_tpu_torch.check import election_safety
    from madsim_tpu_torch.engine import EngineConfig, make_init, make_run_while, search_seeds
    from madsim_tpu_torch.engine.fused import kernel_model
    from madsim_tpu_torch.models import make_raft
    from madsim_tpu_torch.models.raft import OP_ELECT

    t_phase = time.perf_counter()
    plan = FaultPlan((CrashStorm(targets=(0, 1, 2, 3, 4), n=2),), name="dual-crash")
    seeds = np.arange(1, DUAL_SEEDS + 1, dtype=np.uint64)
    # (a) the card's compile, numpy's and the nemesis's, seed by seed
    rows = plan.compile_batch(torch.as_tensor(seeds.astype(np.int64), device=device),
                              device=True)
    host_rows = plan.compile_batch(seeds)
    compiled = [rows_events(rows, s) for s in range(DUAL_SEEDS)]
    for s, seed in enumerate(seeds.tolist()):
        if compiled[s] != rows_events(host_rows, s):
            raise AssertionError(f"70a: seed {seed}: the card's rows are not numpy's")
        if compiled[s] != nemesis_events(ms, plan, seed):
            raise AssertionError(f"70a: seed {seed}: the nemesis's events are not the rows")
    n_events = sum(len(c) for c in compiled)
    # (b) the batched run through the run kernel
    wl, cfg = make_raft(record=True), EngineConfig(pool_size=64, loss_p=0.02)
    key = kernel_model(wl).key
    box = {}

    def inv(h):
        box["ok"] = election_safety(h, elect_op=OP_ELECT)
        box["count"] = h.count
        return box["ok"]

    rep, counts = path_launches(lambda: search_seeds(
        wl, cfg, None, n_seeds=DUAL_SEEDS, seed_base=1, max_steps=DUAL_STEPS,
        history_invariant=inv, plan=plan, device=device))
    paths.setdefault(key, {})["dual_mode_hunt"] = run_drain(counts, key)
    if run_drain(counts, key) != [1, 1] or len(counts) != 2:
        raise AssertionError(f"70b: launched {counts}")
    if rep.unhalted_seeds.size or rep.overflowed.any():
        raise AssertionError(f"70b: {rep.unhalted_seeds.size} unhalted, "
                             f"{int(rep.overflowed.sum())} overflowed")
    engine = [bool(v) for v in box["ok"]]
    st = make_init(wl, cfg, device=device, plan_slots=plan.slots)(seeds, host_rows)
    run = make_run_while(wl, cfg, DUAL_STEPS)
    kernel_ms = time_ms(lambda: run(st), REPEATS, device)
    # (c) the runtime side on the host
    t = time.perf_counter()
    runtime, elections = [], 0
    for s, seed in enumerate(seeds.tolist()):
        out = raft_cluster(ms, app, seed, plan, seconds=DUAL_SECONDS)
        if len(out["elect"]) == 0:
            raise AssertionError(f"70c: seed {seed} elected no leader")
        if [e[1:] for e in out["log"]] != compiled[s]:
            raise AssertionError(f"70c: seed {seed}: nemesis log {out['log']}, "
                                 f"compiled {compiled[s]}")
        elections += len(out["elect"])
        runtime.append(election_verdict(ms, out["elect"]))
    wall = time.perf_counter() - t
    if runtime != engine or not all(engine):
        bad = [int(seeds[i]) for i in range(DUAL_SEEDS) if runtime[i] != engine[i] or not engine[i]]
        raise AssertionError(f"70c: verdicts differ or fail at seeds {bad[:10]}")
    phase_s = time.perf_counter() - t_phase
    log(f"[70] dual-mode raft hunt, {plan.name} ({plan.hash()}), seeds 1-{DUAL_SEEDS}: "
        f"(a) {n_events} events, the card's rows = numpy's = the nemesis's on every seed; "
        f"(b) raft-record pool 64, loss 0.02, {DUAL_STEPS}-step cap, launches "
        f"{paths[key]['dual_mode_hunt']}, engine elections {int(np.asarray(box['count']).sum())}, "
        f"0 unhalted, 0 overflowed; (c) runtime elections {elections}, every nemesis log its "
        f"compiled events; verdicts equal, all {DUAL_SEEDS} true")
    log(f"  70 kernel (make_run_while, raft-record 64, {DUAL_SEEDS} seeds under the plan) "
        f"median {spread(kernel_ms)} ms ({card})")
    log(f"  70 runtime side: {wall:.3f} s wall for {DUAL_SEEDS} seeds x {DUAL_SECONDS} s "
        f"simulated, {DUAL_SEEDS * DUAL_SECONDS / wall:.2f} simulated s per wall s on the "
        f"host ({card})")
    log(f"  70 phase wall {phase_s:.2f} s ({card})")


# the etcd lease convergence (phase 71): the card's seeds and the host
# side's seeds 1..LEASE_HOST_SEEDS (some 30 ms each on a CPU core)
LEASE_SEEDS, LEASE_HOST_SEEDS = 4096, 256


def lease_phase(device, results: list, paths: dict, card: str) -> None:
    """Phase 71: one lease scenario, both execution modes. The batched
    run is leasekv-record without its own chaos on the card; the host
    side is the port's etcd server and three lease clients, one
    ``Runtime`` a seed, with no torch work inside a simulation."""
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import _torch_lease as lease

    import madsim_tpu_torch as ms
    from madsim_tpu_torch.check.device import lease_safety
    from madsim_tpu_torch.check.history import OK_FAIL, OK_OK
    from madsim_tpu_torch.engine import EngineConfig
    from madsim_tpu_torch.engine.fused import MODELS, kernel_model
    from madsim_tpu_torch.models.leasekv import OP_EXPIRE, OP_PUT, OP_WATCH_EVT, make_leasekv

    t_phase = time.perf_counter()
    wl = make_leasekv(**lease.FACTORY_KW)
    cfg = EngineConfig(pool_size=lease.POOL, loss_p=0.0)
    key = kernel_model(wl).key
    log(f"[71] etcd lease convergence: {key}, {lease.FACTORY_KW}, pool {lease.POOL}, loss 0, "
        f"{LEASE_SEEDS} seeds, {lease.STEPS} steps")
    box = {}

    def verdicts(device, _wl, _cfg, _cap, _st, out, _med):
        box["safe"] = screened((lease_safety(OP_PUT, OP_EXPIRE),), out)
        box["card"] = lease.card_verdicts(out.hist_word.cpu().numpy(),
                                          out.hist_count.cpu().numpy(), OP_EXPIRE,
                                          OP_WATCH_EVT, OK_OK, OK_FAIL)

    # (a) the card
    r = kernel_phase(device, key, wl, cfg, LEASE_SEEDS, lease.STEPS, CPU_SAMPLE, REPEATS,
                     extras=verdicts, all_halt=False)
    if r["launches"] != 1 or r["drains"] != 1 or r["err"] != 0:
        raise AssertionError(f"71a: launches {r['launches']}, {r['drains']}; error {r['err']}")
    if not box["safe"].all():
        raise AssertionError(f"71a: lease_safety fails on {int((~box['safe']).sum())} seeds")
    card_v = box["card"]
    bad = [s for s, v in enumerate(card_v)
           if v[:2] != ([1], [2, 3]) or v[3] != [1]]
    if bad:
        raise AssertionError(f"71a: seeds {bad[:10]}: {[card_v[s] for s in bad[:3]]}")
    results.append((key, f"make_run_fused/{key}", f"madsim_tpu_torch/csrc/{MODELS[key].header}",
                    r))
    paths[key] = {"lease_convergence": [r["launches"], r["drains"]]}
    # (b) the host
    t = time.perf_counter()
    host_v = {seed: lease.host_verdict(lease.lease_cluster(ms, seed))
              for seed in range(1, LEASE_HOST_SEEDS + 1)}
    wall = time.perf_counter() - t
    for seed, hv in host_v.items():
        why = lease.check_seed(card_v[seed], hv)
        if why is not None:
            raise AssertionError(f"71b: seed {seed}: {why}")
    secs = sorted({(tuple(v[2]), tuple(card_v[seed][2])) for seed, v in host_v.items()})
    phase_s = time.perf_counter() - t_phase
    log(f"  71 verdicts: card seeds 0-{LEASE_SEEDS - 1} all lease 1 expired, 2 and 3 alive, "
        f"the watcher's events name lease 1 only, lease_safety true; host seeds "
        f"1-{LEASE_HOST_SEEDS} equal to the card's; (host, card) expiry seconds {secs}; "
        f"window host {lease.HOST_EXPIRY_S}, card minus host {lease.CARD_MINUS_HOST_S}")
    log(f"  71 kernel ({key} {lease.POOL}, {LEASE_SEEDS} seeds, {lease.STEPS} steps) median "
        f"{spread(r['ms_all'])} ms ({card})")
    log(f"  71 host side: {wall:.3f} s wall for {LEASE_HOST_SEEDS} seeds x {lease.END_S} s "
        f"simulated, {LEASE_HOST_SEEDS * lease.END_S / wall:.2f} simulated s per wall s "
        f"({card})")
    log(f"  71 phase wall {phase_s:.2f} s ({card})")


# phase 72: factory variants off the registry, each through a library
# derived from its workload (engine/fused.py FAMILIES) and built with
# the registered ones in phase 2; the first VARIANT_SAMPLE seeds held
# against the plain step on the CPU
VARIANT_SAMPLE = 64
VARIANT_LAT = dict(ops=16, phases=3, phase_ns=1 << 27)
VARIANT_TAPS = dict(cov_words=64, cov_hitcount=True, timeline_cap=256)


def variant_cases() -> list:
    """Phase 72's variants: ``(index, factory call, workload, config,
    seeds, make_run_while cap, plan, taps)``, each at the width of its
    family's earlier phase (raft 4, broadcast 7, raftlog 10, paxos 13,
    leasekv 14, shardkv 15, the kvchaos army at the retry soak's policy)."""
    from madsim_tpu_torch.chaos import FaultPlan, RetryPolicy
    from madsim_tpu_torch.engine import EngineConfig, LatencySpec
    from madsim_tpu_torch.models import (
        kvchaos, make_broadcast, make_kvchaos, make_leasekv, make_paxos, make_raft,
        make_raftlog, make_shardkv,
    )

    clog = dict(clog_backoff_max_ns=2_000_000_000)
    pol = RetryPolicy(timeout_ns=50_000_000, max_attempts=3, backoff_base_ns=10_000_000,
                      backoff_mult=2.0, jitter=0.5)
    army = FaultPlan((kvchaos.client_army(n_ops=VARIANT_LAT["ops"], t_min_ns=5_000_000,
                                          t_max_ns=280_000_000, retry=pol),),
                     name="kv-army-retry")
    return [
        ("72.1", "make_raft(n_nodes=3)", make_raft(n_nodes=3),
         EngineConfig(pool_size=40, loss_p=0.02, **clog), 65536, 600, None, {}),
        ("72.2", "make_raft(n_nodes=7)", make_raft(n_nodes=7),
         EngineConfig(pool_size=96, loss_p=0.02, **clog), 65536, 600, None, {}),
        ("72.3", "make_broadcast(n_nodes=4, partition=False)",
         make_broadcast(n_nodes=4, partition=False),
         EngineConfig(pool_size=40, loss_p=0.05, **clog), 16384, 500, None, {}),
        ("72.4", "make_kvchaos(army=True)", make_kvchaos(army=True),
         EngineConfig(pool_size=64, loss_p=0.02, **clog), 4096, 900, army,
         dict(latency=LatencySpec(**VARIANT_LAT), retry=army.retry_spec())),
        ("72.5", "make_paxos(n_acceptors=3, durable_acceptors=True)",
         make_paxos(n_acceptors=3, durable_acceptors=True),
         EngineConfig(pool_size=96, loss_p=0.02), 4096, 400, None, {}),
        ("72.6", "make_shardkv(n_groups=3, group_size=5)",
         make_shardkv(n_groups=3, group_size=5),
         EngineConfig(pool_size=64, loss_p=0.02, **clog), 4096, 6000, None, {}),
        ("72.7", "make_leasekv(n_clients=5, ka_stop_ms=2000)",
         make_leasekv(n_clients=5, ka_stop_ms=2000),
         EngineConfig(pool_size=48, loss_p=0.02, **clog), 4096, 4000, None, {}),
        ("72.8", "make_raftlog(durable=True, record=True)",
         make_raftlog(durable=True, record=True),
         EngineConfig(pool_size=64, loss_p=0.02, **clog), 16384, 4000, None, {}),
        ("72.9", "make_raft() with every tap", make_raft(),
         EngineConfig(pool_size=512, loss_p=0.02, **clog), 65536, 600, None,
         dict(VARIANT_TAPS)),
    ]


def lib_taps(taps: dict) -> dict:
    """The taps that pick a library's instantiation (``fused.library_for``)."""
    return {k: v for k, v in taps.items()
            if k in ("cov_words", "cov_hitcount", "timeline_cap", "causal")}


def variant_specs() -> list:
    """The libraries phase 72 launches, for phase 2's one parallel build."""
    from madsim_tpu_torch.engine.fused import library_for

    return [library_for(wl, cfg.pool_size, **lib_taps(taps))
            for _i, _c, wl, cfg, _n, _cap, _plan, taps in variant_cases()]


def variants_phase(device, results: list, paths: dict, shapes: dict, builds: dict,
                   card: str) -> None:
    """Phase 72: each variant once through ``make_run_while`` on the card
    (one run and one drain launch of its derived library, the counts set
    to 0 just before and read just after), every field of the first
    VARIANT_SAMPLE seeds against the plain step on the CPU (``plain_head``:
    until they halt, then ``drain_plain``), the stop-at-halt counts
    against the plain run's seed-steps, the drain kernel alone against
    its plain version, the kernel's ms (median of 5) and the bound's
    terms; into the kernels line with its launch shape."""
    from madsim_tpu_torch.engine import make_init, make_run_while
    from madsim_tpu_torch.engine.fused import KERNEL, halt_counts, library_for

    t_phase = time.perf_counter()
    for idx, call, wl, cfg, n, cap, plan, taps in variant_cases():
        spec = library_for(wl, cfg.pool_size, **lib_taps(taps))
        key, pool = spec.key, cfg.pool_size
        seeds = np.arange(n, dtype=np.uint64)
        init = make_init(wl, cfg, device=device, plan_slots=plan.slots if plan else 0, **taps)
        st = init(seeds, plan.compile_batch(seeds, wl=wl)) if plan else init(seeds)
        log(f"[{idx}] {call}: library {key} ({spec.cxx}, G {spec.group}, {spec.threads} "
            f"threads a block), pool {pool}, loss {cfg.loss_p}, {n} seeds, make_run_while cap "
            f"{cap}" + (f", plan {plan.name} ({plan.hash()})" if plan else "")
            + (f", {taps}" if taps else ""))
        log(f"  pool {pool}: {launch_shape(spec, pool, card)}")
        run = make_run_while(wl, cfg, cap, **taps)
        torch.cuda.synchronize()
        KERNEL.reset()
        out = run(st)
        torch.cuda.synchronize()
        launches, drains = KERNEL.counts.get(key, 0), KERNEL.counts.get(f"{key}/drain", 0)
        if (launches, drains) != (1, 1) or set(KERNEL.counts) != {key, f"{key}/drain"}:
            raise AssertionError(f"{idx}: launches {KERNEL.counts}, want {key} [1, 1]")
        n_steps = int(out.step[0])
        if not bool((out.step == n_steps).all()):
            raise AssertionError(f"{idx}: seeds disagree on the step count")
        n_over, n_run = int((out.overflow > 0).sum()), int((~out.halted).sum())
        if n_over:
            raise AssertionError(f"{idx}: pool overflow on {n_over} seeds")
        sends = int((out.msg_count - st.msg_count).sum())
        log(f"  main path: {key} run kernel launched {launches} time, drain kernel {drains}; "
            f"{n - n_run} of {n} seeds halted within {n_steps} steps, none overflowed; "
            f"{sends} messages sent")
        k = VARIANT_SAMPLE
        t = time.perf_counter()
        want, seed_steps, drops = plain_head(wl, cfg, n_steps, head_of(st, k).to("cpu"),
                                             taps=taps)
        plain_ms = (time.perf_counter() - t) * 1e3
        assert_equal(head_of(out, k), want, f"first {k} seeds (kernel) vs plain on the CPU")
        err = max_abs_err(head_of(out, k), want)
        iters = halt_counts(wl, cfg, cap, st, latency=taps.get("latency"),
                            retry=taps.get("retry"))
        if int(iters[:k].sum()) != seed_steps:
            raise AssertionError(f"{idx}: the stop-at-halt pass counts {int(iters[:k].sum())} "
                                 f"seed-steps of the sample, the plain run {seed_steps}")
        # the bound's work over every seed: the kernel's own seed-steps,
        # those the plain step did not run counting no poll block
        seed_steps, drops = int(iters.sum()), drops + int(iters[k:].sum())
        drain_check(wl, cfg, cap, st, latency=taps.get("latency"), retry=taps.get("retry"))
        ms = time_ms(lambda: run(st), REPEATS, device)
        log(f"  drain kernel alone vs its plain version: step and ev_valid equal; kernel ms "
            f"{spread(ms)} ({card}); plain ms on the CPU (host clock, {k} seeds) "
            f"{plain_ms:.2f}")
        r = dict(launches=launches, drains=drains, err=err, ms=statistics.median(ms), ms_all=ms,
                 plain_ms=plain_ms, pool=pool,
                 plain_ms_of=f"make_run_plain on the CPU, first {k} seeds (host clock)",
                 **bound_terms(st, out, pool, seed_steps, drops, sends))
        obs = bool(lib_taps(taps))
        shapes[key, pool] = {**KERNEL.occupancy(spec, pool),
                             "threads": spec.threads,
                             "registers": base_registers(builds[key][1], pool)}
        if obs:
            shapes[key, pool]["taps_registers"] = base_registers(builds[key][1], pool, True)
        results.append((key, f"make_run_fused/{key}", f"madsim_tpu_torch/csrc/{spec.header}", r))
        paths[key] = {"run_while_variant": [launches, drains]}
    log(f"  72 phase wall {time.perf_counter() - t_phase:.2f} s ({card})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if "--groups" in sys.argv:
        # python3 chip_smoke.py --groups 4,8,32 [model keys...]: the
        # lanes-per-seed sweep alone
        device = torch.device("cuda")
        log(f"[1] card: {nvidia_smi('name,power.limit')}; torch {torch.__version__}")
        at = sys.argv.index("--groups")
        groups = [int(x) for x in sys.argv[at + 1].split(",")]
        keys = sys.argv[at + 2:] or [key for _n, key, _kw in MODEL_PHASES]
        group_sweep(device, groups, keys)
        return 0
    from madsim_tpu_torch.engine.fused import KERNEL, MODELS, build_libraries

    device = torch.device("cuda")
    # the CPU samples step small batches of a few hundred seeds, where
    # each op is too small for the intra-op thread pool to pay
    torch.set_num_threads(1)
    lap = Laps()
    card = nvidia_smi("name,power.limit")
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t = time.perf_counter()
    # the registered libraries and phase 72's derived ones, in one build
    specs = {m.key: m for m in (*MODELS.values(), *variant_specs())}
    libs = build_libraries(specs.values())
    shapes = {}
    log(f"[2] {len(libs)} run kernel libraries built in {time.perf_counter() - t:.1f} s "
        f"(one nvcc per model, in parallel; {len(libs) - len(MODELS)} derived for phase 72)")
    for key, (path, build_log) in libs.items():
        log(f"  {key}: {path}")
        for line in build_log.splitlines():
            if "registers" in line or "bytes stack" in line or "Function properties" in line:
                log(f"    {line.strip()}")
            if line.startswith("# ") and line.endswith(" s"):
                log(f"    nvcc {line[2:]}")
        for pool in specs[key].pools:
            log(f"    pool {pool}: {launch_shape(specs[key], pool, card)}")
            shapes[key, pool] = {**KERNEL.occupancy(specs[key], pool),
                                 "registers": base_registers(build_log, pool)}
            if pool in specs[key].obs_pools:
                shapes[key, pool]["taps_registers"] = base_registers(build_log, pool, True)
    lap("phases 1-2")

    clock = max_sm_clock_hz()
    entry_err = entry_phase(device, ENTRY_SEEDS)
    results, phase4 = [], {}
    for i, (spec_name, key, factory_kw) in enumerate(MODEL_PHASES):
        raft = key == "raft"
        r = model_phase(device, 4 + i, spec_name, key, factory_kw, CPU_SAMPLE,
                        REPEATS, extras=raft_extras if raft else None,
                        refs=phase4 if raft else None)
        if raft:
            r["err"] = max(r["err"], entry_err)
        name = "make_run_fused" if raft else f"make_run_fused/{key}"
        results.append((key, name, f"madsim_tpu_torch/csrc/{MODELS[key].header}", r))
    for _key, name, _src, r in results:
        if r["launches"] < 1 or r["drains"] < 1:
            raise AssertionError(f"{name}: the main path did not launch its run and drain kernels")
        if r["err"] != 0:
            raise AssertionError(f"{name}: kernel disagrees with the plain step: {r['err']}")
    # the runners, each path driven with the counts set to 0 just before
    # it and read just after
    paths = {key: {"run_while": [r["launches"], r["drains"]]} for key, _n, _s, r in results}
    extra = {}
    lap("phases 3-15")
    compacted_phase(device, paths, extra)
    search_phase(device, paths)
    measure_phase(device, paths)
    verify_phase(device, paths)
    checkpoint_phase(device, paths)
    lap("phases 16-20")
    # the record libraries, after the runner phases, each timed beside
    # its family's library without recording
    ms_of = {key: r["ms"] for key, _n, _s, r in results}
    sibling = {spec_name: (4 + i, key)
               for i, (spec_name, key, kw) in enumerate(MODEL_PHASES) if not kw}
    def screens_of(spec_name, key):
        # phase 33 rides on each record phase's kernel run
        def extras(device, _wl, _cfg, _cap, _st, out, med):
            extra.setdefault(key, {}).update(
                screen_phase(device, key, family_screens(spec_name), out, med))
        return extras

    for i, (spec_name, key, factory_kw) in enumerate(record_phases()):
        r = model_phase(device, 21 + i, spec_name, key, factory_kw, CPU_SAMPLE, REPEATS,
                        extras=screens_of(spec_name, key))
        if r["launches"] < 1 or r["drains"] < 1 or r["err"] != 0:
            raise AssertionError(f"{key}: launches {r['launches']}, {r['drains']}; error {r['err']}")
        results.append((key, f"make_run_fused/{key}", f"madsim_tpu_torch/csrc/{MODELS[key].header}", r))
        paths[key] = {"run_while": [r["launches"], r["drains"]]}
        phase, base = sibling[spec_name]
        log(f"  {key} kernel median {r['ms']:.4f} ms beside {base} {ms_of[base]:.4f} ms "
            f"(phase {phase}, this call, {card})")
    lap("phases 21-30, 33")
    hunted = history_search_phase(device, paths)
    record_checkpoint_phase(device, paths)
    device_check_phase(device, paths, hunted)
    main_path_screen_phase(device, paths, extra)
    lap("phases 31-32, 34-35")
    refs = plan_phases(device, results, paths, extra, card)
    lap("phase 36")
    repro = nemesis_phase(device, refs, paths, extra)
    raft_nemesis_phase(device, paths, extra)
    lap("phase 37")
    store_refs = store_kernel_phases(device, results, paths, extra, card, ms_of, refs)
    lap("phase 38")
    store_certificates(device, store_refs, paths, extra)
    lap("phase 39")
    obs_main_path_phase(device, results, paths, extra, card, ms_of, phase4["raft"])
    lap("phase 40")
    coverage_phase(device, results, paths, extra, repro)
    lap("phase 41")
    forensics_phase(device, paths, repro)
    lap("phase 42")
    latency_soak_phase(device, results, paths, extra, card)
    lap("phase 43")
    latency_certificates_phase(device, paths, extra)
    lap("phase 44")
    golden_phase(device, results, paths, extra)
    lap("phase 45")
    army_phase(device, results, paths, extra)
    lap("phase 46")
    kv = causal_kv_phase(device, results, paths, extra, card)
    causal_fold_phase(device, paths, kv)
    lap("phases 47-48")
    cones_phase(device, results, paths, extra, kv)
    lap("phase 49")
    arrows_phase(device, results, paths, kv)
    lap("phase 50")
    retry_clean_phase(device, results, paths, extra, card)
    lap("phase 51")
    retry_amplification_phase(device, paths)
    lap("phase 52")
    noidem_phase(device, results, paths, extra, card)
    lap("phase 53")
    retry_obs_phase(device, results, paths, extra, card)
    lap("phase 54")
    kv = explore_guided_phase(device, results, paths, extra)
    lap("phase 55")
    explore_determinism_phase(device, results, paths, kv)
    lap("phase 56")
    explore_hunt_phase(device, results, paths, extra)
    lap("phase 57")
    explore_soak_hunts_phase(device, results, paths)
    lap("phase 58")
    explore_device_phase(device, results, paths, extra)
    lap("phase 59")
    farm_phases(device, paths, extra, lap)
    lint_phase(device, paths, extra)
    lap("phase 66")
    store_hunt_phase(device, results, paths, extra)
    lap("phase 67")
    slo_hunt_phase(device, results, paths, extra)
    lap("phase 68")
    axes_phase(device, paths, extra)
    lap("phase 69")
    dual_mode_phase(device, paths, card)
    lap("phase 70")
    lease_phase(device, results, paths, card)
    lap("phase 71")
    variants_phase(device, results, paths, shapes, libs, card)
    lap("phase 72")
    kernels = {"kernels": [
        kernel_line(name, src, r, clock, paths[key], extra.get(key, {}),
                    shapes.get((key, r["pool"])))
        for key, name, src, r in results
    ]}
    print(json.dumps(kernels), flush=True)
    print(nvidia_smi("name,power.limit"), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
