#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --compare SRC   # the last redesigned kernels only
    python3 chip_smoke.py --decoder       # phases 1 and 12 only
    python3 chip_smoke.py --zoo           # phases 1, 13 and 14 only
    python3 chip_smoke.py --pod           # phases 1 and 15 only
    python3 chip_smoke.py --fsdp          # phases 1 and 16 only
    python3 chip_smoke.py --dist-serve    # phases 1 and 17 only
    python3 chip_smoke.py --scale         # phases 1 and 18 only
    python3 chip_smoke.py --surface       # phases 1 and 19 only

It imports nothing of JAX or of the JAX package, and fails (exit code 1,
no result printed) without a CUDA card or without ``src/repro_torch``
beside it.  ``--compare SRC`` times only the kernels redesigned last
(``f32_mean_xla`` at every shape the paths launch, the per-leaf
``hist2side`` on both passes over a seeded leaf of f1's size, and
``masked_moments`` on that leaf at ``bm=8, lanes=128`` and at the default
tile) with the package under ``SRC``, such as a parent commit's ``src`` unpacked into
``build/parent``: run it for both versions in turns, in one chip call.
Without arguments, phases, each of which fails the run:

  1. print the card's name and power limit (``nvidia-smi``); build the
     CUDA kernels from ``src/repro_torch/kernels/csrc`` with ``nvcc`` for
     ``sm_90a`` (one ``nvcc`` per source, all at once) and print the build
     time;
  2. the hist path: ``repro_torch.run.build_run`` for LeNet5 (1,256,010
     parameters, batch 128, p = 0.01) on the GSPMD backend's flat hist
     engine, 5 rounds.  Every kernel's launch count is set to 0 just
     before and read just after; every round must launch
     ``seg_hist2side`` twice, ``seg_moments`` and ``seg_binarize_apply``
     once, ``f32_mean_xla`` once (the mean of the clients' losses every
     GSPMD round takes) and no packer, every loss must be finite, and the last round's
     residual must be ``acc − ΔW*`` bit for bit with each segment's ΔW*
     holding only 0 and that segment's μ.  The last round's accumulator
     goes through the hist pipeline once more with each kernel's operands
     captured: each kernel is held against its plain PyTorch version on
     the same operands (counts equal, binarize bit-equal, moment sums to
     ``rtol=1e-6``, with the largest relative error printed), the kernel
     pipeline against the plain pipeline, and both are timed.  The
     persistent grid of ``seg_hist2side`` and ``seg_moments`` is printed
     (G and the CTAs an SM holds), and each call of either must be one
     device operation (the per-call counts of the profiler's trace);
  3. the exact path: ``build_run`` for the same model on the exact engine
     with the device-packed Golomb wire and wire metering
     (``flat_engine="exact", device_pack=True, measure_wire=True``), 5
     rounds.  Every round must launch ``seg_packbits`` once (its
     stream-order entry, ``pack_bit_rows``), ``f32_mean_xla`` seven times
     (one a segment, one for the loss) and nothing else; every loss
     must be finite; on the last round the residual must be ``acc − ΔW*``
     bit for bit, and each (segment, row) of ΔW* must hold one value ±μ
     in exactly k slots; every (segment, row)'s slice of the packed words
     and its bit count must equal the host Golomb encoder's bytes of the
     row's positions (``encode_positions_packed``), byte for byte;
     ``seg_select_pack`` on the same rows' masks must give the same words
     and bit counts; and the ledger's measured bits must be Σ nbits + 32 ·
     n_mu for every round.  ``seg_packbits`` is held against its plain
     version on the path's own stream-order bits (and equal to the path's
     words) and, through its planes entry, on the same bits as planes;
     ``seg_select_pack`` on every segment's mask (all exactly).  All three
     are timed (``seg_select_pack`` on the largest row, f1, whose tiles and
     persistent grid are printed, and also on every other segment's mask
     and on seeded masks of the card tests' 1,000-slot rows); each call of
     ``seg_select_pack`` and of the stream-order ``seg_packbits`` must be
     one device operation.  ``f32_mean_xla`` (XLA's f32 reduce order for
     μ, one launch per segment a round) is held bit for bit against its
     plain cascade on the path's own top-k values of every segment, and
     timed on f1's (2 x 12,250 values, with its CTAs and
     ``torch.sum(vals, dim=-1)`` on the same operands as ``library_ms``)
     and on seeded values of every shape the exact, codec and local paths
     launch
     (``MEAN_SHAPES``: bit-equal, one device operation a call, beside
     ``torch.sum``); the profiled round's device operations are printed
     beside the 812 of the round before this kernel (PERF.md §5);
  4. the per-leaf path: ``repro_torch.kernels.ops.sbc_compress_hist(leaf,
     p=0.01, bm=8, lanes=128)`` on each of LeNet5's 6 leaves, as views
     into the hist path's last accumulator, with the launch counts set to
     0 just before and read just after: 12 ``hist2side``, 6
     ``masked_moments``, 6 ``binarize_apply`` and nothing else.  Each
     leaf's ΔW*, residual, μ and count must equal the flat hist engine's
     on the same buffer bit for bit, and its residual ``acc − ΔW*``; the
     six calls run again under ``torch.cuda.set_sync_debug_mode("error")``
     (a host sync fails the run).  Each kernel is held against its plain
     version on every call's operands (counts equal; binarize bit-equal;
     ``masked_moments`` bit-equal at ``bm=8, lanes=128`` and at the
     default tile) and timed on f1 (n 1,225,000), ``hist2side`` on both
     its passes, coarse and zoomed, and ``masked_moments`` at both tiles,
     each one device operation a call.  The
     survivor count of each leaf is printed against k; the reference's
     ±2% band (on k, and on μ against the exact top-k's) is checked on
     seeded Gaussian data of f1's size, the data it is asserted on;
  5. the codec + wire path: LeNet5 at full width under
     ``policy_from_spec(RunSpec(compressor="sbc", dense_pattern=
     "^f[12]b$"))`` (four SBC leaves, f1b and f2b dense, per leaf, p =
     0.01), five rounds, each on the ΔW of one Adam step at batch 128:
     ``ResolvedPolicy.compress`` with error feedback,
     ``Wire.pack_with_bits(device_pack=True)`` and ``Wire.unpack``, with
     the launch counts set to 0 just before and read just after (every
     round 4 ``seg_select_pack``, one per Golomb leaf, and 8
     ``f32_mean_xla``).  Every round the device-packed blob must equal the
     host-packed blob byte for byte, the unpacked ΔW* and the residual
     ``acc − ΔW*`` must be bit for bit, each SBC leaf must hold exactly k
     survivors at ±μ, and the measured payload bits must be Σ ``nbits`` +
     32 per μ + 32 per dense entry (printed beside Eq. 1's total).  It
     prints the host ms a round of compress, device pack, host pack and
     unpack, and ``seg_select_pack``'s device µs on each leaf's mask.
     Every ``f32_mean_xla`` call of the rounds must have a shape of
     ``MEAN_SHAPES``, and the last round's 8 are held bit for bit against
     the plain cascade on their own operands.
     Then one GSPMD exact round with the same dense pattern through
     ``build_run`` (1 ``seg_packbits``, 4 ``f32_mean_xla``);
  6. the local path: five full-width LeNet5 rounds of ``build_run(RunSpec(
     preset="lenet5", backend="local", clients=4, batch=128, sparsity=0.01,
     measure_wire=True))`` with ``fast=False`` (per leaf, client by client:
     48 ``f32_mean_xla`` a round) and with ``fast=True`` (the flat space,
     the four clients as rows: 6 ``f32_mean_xla`` a round), nothing else
     launched, each with the counts set to 0 just before and read just
     after; per round the loss, step ms, launches and the ledger's measured
     bits against Eq. 1's, and one profiled round each.  The
     ``f32_mean_xla`` calls of the rounds must have the path's own shapes
     (``path_mean_shapes``: the flat path's 8 x k rows, the per-leaf
     path's 2 x k and 1 x k a leaf) and each is held bit for bit against
     the plain cascade on its own operands.  Each ledger row must be C x
     client 0's packed bits and C x Eq. 1, the last round's residual
     ``acc − ΔW*`` bit for bit for every client, and the two paths must
     give bit-identical params, residuals, Adam states and ledger rows;
  7. the CharLSTM phase: the paper's second preset at full width (2 x 200,
     vocab 98, 680,800 parameters in 8 leaves, batch 8 x 64 tokens, p =
     0.01), five rounds on every run path with the counts set to 0 just
     before each and read just after: the local backend per leaf (4
     clients, 64 ``f32_mean_xla`` a round) and flat (8), with phase 6's
     checks; the GSPMD hist engine (2 ``seg_hist2side``, 1 ``seg_moments``,
     1 ``seg_binarize_apply`` a round, 1 ``f32_mean_xla``), with phase 2's
     checks and each
     hist kernel held against its plain version on the path's operands;
     and the GSPMD exact engine with the device-packed wire (1
     ``seg_packbits``, 8 + 1 ``f32_mean_xla`` a round), with phase 3's word,
     ledger and ``f32_mean_xla`` checks; each with a profiled round.  Then
     the local flat path once more with telemetry on (``repro_torch.obs``):
     5 ``round``, ``exchange`` and ``encode`` spans, the port's validators
     clean, the ``repro-obs-v1`` files written to a temporary directory,
     params bit-identical to the run without telemetry, and the step ms
     with telemetry on and off;
  8. clients across ranks: (a) a real NCCL process group of one rank:
     its ``all_gather_rows`` and ``pmean`` return their input bit for bit,
     and five LeNet5 rounds of the hist engine and of the exact engine with
     the device pack and the ledger through the group equal the same
     rounds without one (params, optimizer state, residual, losses, ledger
     rows), under deterministic cuDNN; (b) two ranks on the one card, one
     process and one client each, over gloo (NCCL refuses two ranks on one
     card; gloo's ``all_gather`` takes the CUDA tensors), five rounds of
     each of ``MULTI_PATHS`` (LeNet5 hist; LeNet5 exact with the device
     pack and the ledger; LeNet5 per leaf with f1b and f2b dense; CharLSTM
     exact with the device pack) with the counts set to 0 just before and
     read just after: each rank's launches a round as the one-client
     path's, the params identical on both ranks, the last round's mean
     equal to the one recomputed from both clients' gathered ΔW*, every
     kernel call of the last round equal to its plain version on its own
     operands (all bit for bit, but ``seg_moments``' sums, to
     ``rtol=1e-6``), one profiled round, and ``golomb_decode_rows`` on the
     gathered words of the device pack, checked against both clients'
     survivors and timed;
  9. federation (the fed backend: a parameter server and a client pool on
     the card, real SBW1 bytes both ways).  (a) LeNet5 at full width
     (``FED``: batch 128, p = 0.01, 8 clients, cohorts of 4 in two
     profiles of delay 1 and 2, one member a tile), five sync rounds with
     ``fast=True`` (24 ``f32_mean_xla`` a round: one a segment a tile) and
     per leaf (48), then the flat path on the host store: the counts set
     to 0 just before and read just after each run; every
     ``f32_mean_xla`` call held bit for bit against the plain cascade on
     its own operands; every accepted upload decoded on the server equal
     to the member's ΔW* as the pool computed it on the card; with the
     dense downstream the replica equal to W after every round; the
     ledger reconciled (``rel=0.1``); the three runs' params, client rows
     and ledger rows bit-identical.  (b) The same with a 5% downstream
     (30 ``f32_mean_xla`` a round: the broadcast's 6 on the card): the
     replica advances by exactly the broadcast's decoded bytes every round,
     and W − replica stays within 64 ulps of |W| of the downstream
     residual (the reference's own rounding; the worst is printed).  (c)
     A corrupt upload and a straggler in round 2 (their rows as before the
     round), a kill after round 4's aggregation, then checkpoint, rebuild,
     restore and resume: params and ledger totals bit-identical to the
     run without the kill.  (d) Async rounds (``max_staleness=2``, the
     staleness aggregator): the staleness draws equal
     ``default_rng([seed, r, 7])``'s.  (e) CharLSTM at full width, flat,
     4 clients, cohorts of 2, 3 rounds (8 ``f32_mean_xla`` a round), with
     (a)'s checks.  For each path: every round's step ms, the server's
     decode ms (the host Golomb decoder over the round's uploads) and
     receive ms, and one profiled round (device operations, busy ms and
     busy share);
  10. the paper's baselines and its other two models.  (a) Table II:
     every point of ``TABLE2`` (``benchmarks/common.py``'s methods:
     ``none``, ``topk`` at 0.001, ``none`` at n 10, SBC(1)-(3); the
     ``fedavg`` codec at n 10; ``dgc``, ``dgc_policy``, ``signsgd``,
     ``onebit``, ``terngrad``, ``qsgd``, ``randomk``, ``variance`` at n 1)
     on LeNet5's local backend, 4 clients, batch 128, per leaf, 2 rounds
     each, with the counts set to 0 just before and read just after: each
     round's loss finite, its ``f32_mean_xla`` launches as counted from
     the stages (``table2_means``) and nothing else, every call bit-equal
     to the plain cascade, its Eq. 1 bits equal to ``TABLE2_BITS`` (which
     a CPU test holds to the reference's), the ledger's rows C x client
     0's packed bits and C x Eq. 1, and ``variance``'s last upload through
     ``Wire.pack_with_bits(device_pack=True)``, with the counts set to 0
     again (6 ``seg_select_pack``, one a Golomb leaf), equal to the host
     pack byte for byte.  (b) ResNet-32 at full width (466,714 parameters
     in 97 leaves) on CIFAR-shaped class blobs, batch 128, momentum at lr
     0.01, p = 0.01, through ``build_dist_train`` and ``DSGDTrainer``,
     each of which must turn off the TF32 the script turns on before it:
     one forward and gradient against f64 (``RESNET32_F64_TOL``; the same
     with cuDNN's TF32 on must miss it), the GSPMD hist engine with
     phase 2's checks (and each hist kernel against its plain version over
     the 97 segments), the exact engine with the device pack and the
     ledger with phase 3's checks (1 ``seg_packbits`` + 98
     ``f32_mean_xla`` a round), and the local backend with 4 clients per
     leaf (776) and flat (97) with phase 6's checks, 5 rounds each.  (c)
     WordLSTM at full width (19,765,200 parameters) on the markov task of
     vocabulary 10,000, batch 20 x 35, SGD at lr 1.0, p = 0.01, through
     the library: the local backend with 4 clients on the flat space (8
     a round) and the GSPMD exact engine with the device pack (1 + 9), 3
     rounds each, and the card's peak memory.  Each path prints its step
     ms and a profiled round;
  11. delta broadcast (``repro_torch.serve`` on the card).  (a) Phase
     9's LeNet5 fed spec with a 5% downstream that rides the broadcast
     log (``broadcast_log=True, delta_horizon=4``), 5 rounds with phase
     9's checks and the counts set to 0 just before and read just after
     (30 ``f32_mean_xla`` a round, as phase 9b's round without the log):
     the log's replica on the card; round 1 pulls nothing; each round's
     down bytes equal the cohort members' plans' bytes; each member's
     replica, moved by its plan and by the stacked and full messages not
     chosen, equals the log's replica bit for bit; a checkpoint after
     round 3, restored into a fresh run, resumes rounds 4-5 to the
     uninterrupted run's log, ``_last_sync``, ledger rows and W bit for
     bit; step ms, the host ms of ``DeltaLog.append`` and of a round's
     planning, and a profiled round.  (b) ``simulate_fanout`` on LeNet5's
     parameters at ``benchmarks/broadcast_fanout.py``'s settings (16
     rounds, horizon 8, a 2% downstream, periods 1, 2, 4, 8, three
     verified classes, the default ``sbc`` + dense-small policy) at
     10,000 and 100,000 subscribers, and (c) on WordLSTM's 19,765,200
     parameters at 10,000 subscribers, the same settings: each with the
     counts set to 0 just before and read just after (the server's 2
     ``f32_mean_xla`` a leaf a round, each bit-equal to the plain
     cascade), the pool's state on the card, the reference's gates (a
     bit-exact stack, catch-ups cheaper than a resync at every lag, a
     reconciled ledger), and prints rounds/s, subscriber syncs/s, bytes
     a subscriber a round, the saving against a full resync, the plan by
     lag, the host ms of append and planning, and the peak memory;
  12. the dense decoders (ROADMAP A12, part 2).  (a) lm-100m at full
     width (137,841,408 parameters in 11 leaves, 110 SBC rows on the GSPMD
     engines) on the reference's training default: the local backend
     through ``build_run`` (4 clients, per leaf, batch 8 x 256, p =
     0.001: 88 ``f32_mean_xla`` a round, phase 6's checks), then one
     client on the GSPMD hist engine (2/1/1 + 1, phase 2's checks, each
     hist kernel against its plain version on the path's operands, the
     largest bin count beside 2^24; not timed there: at 137.8 M entries
     the profiler lost 14 of 240 records of every trace) and on the exact engine with the
     device-packed wire (1 ``seg_packbits`` + 12, phase 3's checks,
     ``seg_packbits`` against its plain version), 3 rounds each and a
     profiled round: every loss finite and the held-out loss lower after
     the rounds, Eq. 1 bits the pinned reference's (``LM100M_EQ1``), the
     ledgers reconciled; round ms, each path's peak memory.  (b) the
     serving engine of ``repro_torch.launch.serve`` on gemma3-1b at full
     width in bf16 (999,812,736 parameters drawn on the card; 4 prompts
     of 2,048 tokens, 32 new): greedy tokens equal in two runs and in
     range, the decode at position 2,048 within 5% of the largest logit
     of a prefill of the 2,049 tokens, no hand kernel launched; prefill
     ms, decode ms a token, tokens/s, peak memory.
     ``python3 chip_smoke.py --decoder`` runs phases 1 and 12 alone;
  13. the MoE and recurrent decoders (ROADMAP A12, part 3, items 1 and
     2).  (a) mixtral-8x7b at full width cut to 1 of its 32 layers
     (1,582,346,240 parameters; its expert stacks are 469,762,048-entry
     segments), in the labelled variant ``MIXTRAL1_VARIANT`` (f32 leaves
     and residual, which the hist engine needs; client mode "data", the
     GSPMD backend's one, one client at world 1), on the GSPMD hist engine
     (the markov task at vocabulary 32,000, batch 8 x 256, p = 0.001, SGD
     at base_lr), 3 rounds and a profiled one: 2/1/1 + 1 launches a
     round, one mu a segment, each hist kernel call bit-equal to its plain
     version on the path's operands,
     the largest bin beside 2^24, Eq. 1 bits the pinned reference's
     (``MIXTRAL1_EQ1``), the held-out loss lower; round ms, busy share,
     top device operations, peak memory.  (b) ``SERVE_ZOO``: mixtral (8
     layers), llama4 (2: one dense, one MoE of 128 experts), jamba (one
     superblock of 8) and rwkv6 (24, uncut) at full width in bf16 through
     ``ServeEngine``, 32 new greedy tokens each: tokens equal in two runs and in range, no
     hand kernel, the share of (token, expert) pairs the prefill drops at
     capacity factor 1.25, and the decode at position P within 5% of a
     prefill of P + 1 at capacity factor E/k (nothing dropped; llama4's
     flat dispatch on one prompt, its C = T otherwise 8,196); prefill ms,
     decode ms a token, tokens/s, peak memory;
  14. the rest of the zoo (ROADMAP A12, part 3, items 3-5).  (a)
     seamless-m4t-medium at full width and depth (12 + 12 layers,
     614,803,456 parameters in 31 leaves) and (b) phi-3-vision at full
     width, 8 of 32 layers (1,004,522,496; full depth passes 2^31 entries
     and its f32 Adam state one card), each in the labelled variant
     ``STUB_VARIANT`` (f32 leaves), one client on the GSPMD hist engine
     with phase 13a's checks (2/1/1 + 1 launches a round, each hist kernel
     call bit-equal to its plain version and its byte bound, one mu a
     segment, the largest bin beside 2^24, Eq. 1 bits the pinned
     reference's, ``SEAMLESS_PINS``/``PHI3V_PINS``, a lower held-out loss;
     step ms, busy share, peak memory): seamless on the markov task over
     its first 32,000 token ids with 8 x 256 frames of 1,024, phi-3-vision
     on the markov task at its vocabulary, batch 4 x 1,024 with a 576 x
     3,072 prefix.  (c) ``SERVE_STUBS``: both at full
     width and depth in bf16 through ``ServeEngine`` (seamless: 4 prompts of
     256 tokens over 1,024 frames; phi-3-vision: 4 x 1,024 tokens, the first
     576 the prefix), phase 13b's checks and prints.  (d) the reference's
     ``TestNonIID`` statistics on tables drawn on the card, then the fed
     launcher's non-IID run (``NONIID_ARGV``: fed-tiny, 16 clients, skew 2,
     delay 5, p 0.01, a 5% downstream, 5 rounds) through phase 9's checks:
     launches a round, the held-out loss over the clients' chains lower,
     the host ms a round spent drawing batches.  ``python3 chip_smoke.py
     --zoo`` runs phases 1, 13 and 14 alone;
  15. pod mode and the "model" axis (``POD_PINS``, pinned to the
     reference's by ``tests/test_torch_pod_run.py``): (a) granite-20b at
     full width, 2 of 52 layers, one client of 256 shards on
     ``SINGLE_POD`` in its f32 variant through phase 13a's checks (the
     hist kernels over 3,328 (segment, device) segments, one mu a
     (segment, device)); (b) two ranks on the card over gloo, ``POD_TWO``
     = (2, 2, 2), 2 clients of 4 shards of a widened reduced granite, hist
     and exact with the device pack through phase 8b's checks, every
     device's packed ``nbits`` against the host encoder; (c) mixtral at its
     own bf16, 1 layer, 256 shards, the per-leaf exchange with and without
     ``lean_moe``, 3 timed rounds and an untimed one each (13
     ``f32_mean_xla`` a round, each of the untimed round's bit-equal to
     its plain version, the dropped pairs' share from the untimed round).  ``python3 chip_smoke.py --pod``
     runs phases 1 and 15 alone;
  16. one rank a device (``FSDP_PINS``, pinned to the reference's by
     ``tests/test_torch_fsdp_run.py``): (a) phase 15a's granite variant on
     ``FSDP_LAYOUT`` = (data 2, model 2), pod mode, 1 client of 4 devices,
     first as one rank holding the 4 devices' buffers, then as 4 ranks
     over gloo on the card, each holding one device's blocks (the model
     gathers each leaf at its use, the backward leaves each block the
     pod's mean gradient): each through phase 15a's checks (launches 2/1/1
     + 1 a round on every rank, each hist kernel call bit-equal to its
     plain version), Eq. 1 the same on both, rank 0's gathered params
     after round 1 within ``rtol=1e-5, atol=1e-7`` of the one-rank run's
     but 2 entries a row, and the peak memory of the rounds a rank beside
     ``FSDP_PREDICTED_GIB``; (b) ``FSDP_TWO_PODS`` = (pod 2, data 2, model
     1): 2 clients of 2 ranks of the widened reduced granite, the exchange
     over the ranks of one device coordinate, hist and exact with the
     device pack through phase 8b's checks.  ``python3 chip_smoke.py
     --fsdp`` runs phases 1 and 16 alone;
  17. serving across ranks (``DIST_SERVE``): granite-20b (2 of 52 layers)
     and rwkv6-1.6b (4 of 24) at full width in bf16, drawn on the card
     from a generator seeded 0, first through the one-rank
     ``ServeEngine`` on the whole params (a prefill of 4 prompts of 2,048
     tokens, then 8 greedy tokens), then as 4 ranks over gloo on the card,
     one device each of ``FSDP_LAYOUT`` = (data 2, model 2), through
     ``make_dist_prefill`` and ``make_dist_serve`` (each rank holds its
     device's blocks of the params and of the caches: granite's MQA cache
     cut over its sequence, rwkv6's ``s`` over heads and its token shifts
     over channels; 2 prompts a "data" rank), fed the one-rank run's
     greedy tokens: over the steps the logits within
     ``2 * 2^-8 * max|logits|`` of the one-rank run's, each rank's cache
     blocks within the same bound of the one-rank caches' blocks, or
     within the control where that is larger, ``pos`` equal.  The
     one-rank run is held against the ranks on each "data" coordinate's 2
     prompts alone (the GEMM shapes of that coordinate's ranks), and runs
     the 4 prompts again, timed, fed the same tokens: the control, how far
     one rank's own numbers move with the batch's shape alone (rwkv6's
     bf16 token shifts move past the bound); the greedy tokens that
     agree (a count, no gate), prefill ms, decode ms a token and peak
     memory a rank beside the one-rank run's, and no hand kernel launched.  ``python3 chip_smoke.py --dist-serve``
     runs phases 1 and 17 alone;
  18. the scale planner (``repro_torch.scale``) and the dry run
     (``repro_torch.launch.dryrun``): (a) ``plan_real`` of lenet5 and
     charlstm on the card (the local backend per leaf, 4 clients, p =
     0.01, 3 rounds): the cost model's f32 replay equal to the ledger bit
     for bit, Eq. 1 bits and the ledger the pinned reference's
     (``SCALE_PINS``), ``f32_mean_xla`` 48 and 64 launches a round, step
     ms; (b) phase 15a's granite-20b variant (2 full-width layers, f32,
     hist) on one device, batch 4 x 512: the dry run's prediction on the
     ``meta`` device, printed before the card's run (argument + temp
     bytes, kernel calls a step, the roofline's step time on the H100's
     datasheet terms), then the card's first 2 steps: predicted / measured
     peak (``torch.cuda.max_memory_allocated``) within ``SCALE_PEAK_RATIO``,
     launches 2/1/1 + 1 a step equal to the dry run's, step ms beside the
     estimate, and a third step's hist kernel calls bit-equal to their
     plain versions; (c) ``python -m repro_torch.launch.dryrun --all --mesh
     single`` in a subprocess started after phase 1 (records under
     ``build/dryrun_torch``): each ok pair's memory and roofline terms,
     the counts of ok, skip and error and the seconds; any error fails.
     ``python3 chip_smoke.py --scale`` runs phases 1 and 18 alone;
  19. the public surface (``--surface`` runs phases 1 and 19 alone):
     (a) lm-100m at full width (4 clients, batch 4 x 128, p = 0.001, 3
     rounds) through the legacy ``DSGDTrainer(fast=True)``, whose params,
     residuals and Eq. 1 bits must equal ``build_run(RunSpec(
     backend="local", fast=True))``'s on the same batches bit for bit, then
     ``fast=False`` and ``residual_dtype=torch.bfloat16`` (per leaf), each
     with its ``f32_mean_xla`` launches a round (11 flat, 88 per leaf) and
     step ms; (b) lm-100m on the GSPMD hist engine, one rank, 3 rounds
     (2/1/1 + 1, each hist kernel call == plain), ``evaluate`` finite,
     ``checkpoint`` to ``build/`` and restored into a fresh state, whose
     4th round must equal the live run's bit for bit; (c)
     ``FedRun.evaluate`` after 2 rounds of phase 9's LeNet5 fed spec; (d)
     each of the five ``examples/torch_*.py`` in a subprocess on the card
     (``torch_train_lm_100m`` at ``--rounds 3``), each exiting 0 with its
     ✓ lines, and its seconds;
  20. print one ``{"kernels": [...]}`` line with all nine kernels (the
     ``seg_packbits`` row times the stream-order entry, which the path
     launches, and holds the planes entry's times in its ``planes_*``
     fields; ``seg_select_pack`` and ``f32_mean_xla`` count the codec +
     wire path's launches, the exact path's in ``launches_exact_path``
     and the local paths' in ``launches_local_*_path``; every row holds
     its launches on each CharLSTM path in ``launches_charlstm`` and on
     each multi-rank path (rank 0) in ``launches_multi_rank``;
     ``masked_moments`` holds its default tile's times in
     ``default_tile_*`` fields; ``f32_mean_xla`` replaces no Pallas
     kernel, which its ``reference`` field says; it also holds its
     launches on each fed path in ``launches_fed``; the rows phase 10
     launches hold its counts in ``launches_baselines``,
     ``launches_resnet32`` and ``launches_wordlstm``, and
     ``seg_select_pack`` the variance pack check's in
     ``launches_variance_pack_check``; every row holds phase 11's in
     ``launches_broadcast``, the rows phase 12a launches its counts in
     ``launches_decoder``, the rows phase 13a launches its counts in
     ``launches_moe``, and the rows phase 14 launches its counts in
     ``launches_encdec``, the rows phase 15 launches its counts in
     ``launches_pod`` and the hist kernels their 256-shard byte bounds in
     ``bound_ms_pod_256_shards``, the rows phase 16 launches its counts
     in ``launches_fsdp``, every row phase 17's, all zero, in
     ``launches_dist_serve``, and every row phase 18's main paths' (18a
     and 18b's first 2 steps) in ``launches_scale``, and the rows phase
     19a-c launches its counts in ``launches_surface``), then the card line,
     then the last line ``{"ok": true, "device": {...}}``.

After each path's five rounds one more round runs under ``torch.profiler``
and the script prints its device-busy share and its costliest device
operations; the exact path also prints the host-clock time of its
exchange with and without the device pack, on the last round's operands.

``ms`` and ``plain_ms`` are device time per call of the wrapper and of
the plain version, from CUPTI (``torch.profiler``): the sum over all the
device work one call launches, averaged over many calls after a warm-up.
The calls rotate over copies of the operands that together exceed the
50 MB L2 cache, so every call reads device memory, as ``bound_ms``
assumes.  Time
between CUDA events would include the host's cost of a launch through
the Python wrapper, several times the kernels' own; so the script fails
if the profiler sees no device time, and has no other timing.  The bound
is the larger of bytes moved (each input read once, each output written
once) over 3.35 TB/s and operations over 67 T/s (an H100 SXM's published
f32 rate outside the tensor cores, used for the packers' integer
operations too).
"""
from __future__ import annotations

import atexit
import contextlib
import io
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
ROUNDS = 5
KERNELS = ("seg_hist2side", "seg_moments", "seg_binarize_apply", "seg_packbits",
           "seg_select_pack", "hist2side", "masked_moments", "binarize_apply",
           "f32_mean_xla", "seg_accumulate")
LEAF_KERNELS = ("hist2side", "masked_moments", "binarize_apply")
ONE_OP = ("seg_hist2side", "seg_moments")  # one device operation per call


def per_call(**counts) -> dict:
    """Launches of every kernel: ``counts``, and 0 for the others."""
    return {name: counts.get(name, 0) for name in KERNELS}


# every GSPMD round also takes one f32_mean_xla of the clients' losses; with
# one device a client the exchange's front (flatten, residual add, each
# segment's max |x|) is one seg_accumulate, with several (HIST_SHARDS_PER_ROUND)
# it stays tensor ops over the buffers gathered from the shards' blocks
HIST_PER_ROUND = per_call(seg_accumulate=1, seg_hist2side=2, seg_moments=1,
                          seg_binarize_apply=1, f32_mean_xla=1)
HIST_SHARDS_PER_ROUND = dict(HIST_PER_ROUND, seg_accumulate=0)
EXACT_PER_ROUND = per_call(seg_packbits=1, f32_mean_xla=6 + 1)  # one mean per segment
# the codec + wire phase: LeNet5 under sbc with f1b and f2b dense (four SBC
# leaves): a mean for topk_signed and one for binarize per SBC leaf, and
# one seg_select_pack per Golomb leaf in the device pack
DENSE_PATTERN = r"^f[12]b$"
CODEC_PER_ROUND = per_call(seg_select_pack=4, f32_mean_xla=8)
DENSE_EXACT_PER_ROUND = per_call(seg_packbits=1, f32_mean_xla=4 + 1)
# the profiled exact round's device operations before f32_mean_xla, when
# each side's mean was three torch operations (PERF.md §5)
EXACT_DEVICE_OPS_BEFORE = 812
# (rows, n) of the f32_mean_xla calls timed by mean_shapes: those of the
# exact path (2 x k a segment), of the codec + wire and the local per-leaf
# paths (2 x k and 1 x k an SBC leaf) and of the local flat path (2 sides x
# 4 clients x k a segment), for LeNet5 (k 1, 5, 50, 250, 12,250) and
# CharLSTM (k 8, 196, 1,600), and the widest the port meets, WordLSTM's
# embedding and head (k 65,000) on the exact and the local flat path
MEAN_SHAPES = ((2, 1), (1, 1), (2, 5), (1, 5), (2, 50), (1, 50), (2, 250), (1, 250),
               (2, 12_250), (1, 12_250), (8, 1), (8, 5), (8, 50), (8, 250), (8, 12_250),
               (2, 8), (1, 8), (8, 8), (2, 196), (1, 196), (8, 196),
               (2, 1_600), (1, 1_600), (8, 1_600), (2, 65_000), (8, 65_000))
# (rows, n, k, b*) of the card tests' seg_select_pack rows, timed beside f1
SELECT_PACK_SHAPES = ((5, 1000, 37, 4), (1, 1000, 10, 6))
LEAF_PER_LEAF = per_call(hist2side=2, masked_moments=1, binarize_apply=1)
# masked_moments' tiles: the per-leaf path's (the flat engine's blocks), and
# the reference's default (DEFAULT_BM, DEFAULT_LANES)
MOMENT_TILES = ((8, 128), (256, 1024))
# the local phase: the reference's default run (RunSpec's lenet5, local,
# four clients) at the paper's batch and p; f32_mean_xla a round: one per
# segment on the flat path (the clients' rows at once), two per SBC leaf
# and client on the per-leaf path
LOCAL_SPEC = dict(preset="lenet5", backend="local", clients=4, batch=128, sparsity=0.01,
                  measure_wire=True, rounds=ROUNDS)
LOCAL_PER_ROUND = {True: per_call(f32_mean_xla=6), False: per_call(f32_mean_xla=2 * 6 * 4)}
# the CharLSTM phase: the paper's second preset at full width (2 x 200,
# vocab 98, 680,800 parameters in 8 leaves) at the reference's run
# defaults (batch 8 x 64 tokens, 4 clients on the local backend), p = 0.01
CHARLSTM = dict(preset="charlstm", sparsity=0.01, batch=8, seq_len=64, rounds=ROUNDS)
CHARLSTM_LOCAL = dict(CHARLSTM, backend="local", clients=4, measure_wire=True)
CHARLSTM_GSPMD = dict(CHARLSTM, backend="gspmd", fast=True)
CHARLSTM_LEAVES = 8
CHARLSTM_LOCAL_PER_ROUND = {True: per_call(f32_mean_xla=CHARLSTM_LEAVES),
                            False: per_call(f32_mean_xla=2 * CHARLSTM_LEAVES * 4)}
CHARLSTM_EXACT_PER_ROUND = per_call(seg_packbits=1, f32_mean_xla=CHARLSTM_LEAVES + 1)
# phase 12a: the reference's training default (repro/launch/train.py:
# lm-100m, 4 clients, batch 8 x 256 tokens, p = 0.001) at full width:
# 137,841,408 parameters in 11 leaves, the 9 under stack/scan 12 rows each
# (101 SBC rows on the GSPMD engines); 3 rounds a path
LM100M_ROUNDS = 3
LM100M = dict(preset="lm-100m", sparsity=0.001, batch=8, seq_len=256, rounds=LM100M_ROUNDS)
LM100M_LOCAL = dict(LM100M, backend="local", clients=4, measure_wire=True)
LM100M_PARAMS = 137_841_408
LM100M_LEAVES = 11
LM100M_ROWS = 2 + 9 * 12
# the local backend's default, per leaf: two means per leaf and client
LM100M_LOCAL_PER_ROUND = {False: per_call(f32_mean_xla=2 * LM100M_LEAVES * 4)}
LM100M_EXACT_PER_ROUND = per_call(seg_packbits=1, f32_mean_xla=LM100M_LEAVES + 1)
# Eq. 1 bits a client a round (local: k a leaf; GSPMD: k a row), pinned to
# the reference's by tests/test_torch_decoder_run.py::test_chip_smoke_pins_are_the_references
LM100M_EQ1 = {"local": 1584809.1439180223, "gspmd": 1588000.1332195308}
# phase 12b: the serving engine on gemma3-1b at full width in bf16
# (999,812,736 parameters in 74 leaves), through repro_torch.launch.serve's
# flags: 4 prompts of 2,048 tokens (two query chunks of 1,024 in the
# prefill; the 512-token local window rolls), 32 new tokens
SERVE_ARGV = ["--arch", "gemma3-1b", "--full-size", "--batch", "4", "--prompt-len", "2048",
              "--new-tokens", "32"]
GEMMA3_PARAMS = 999_812_736
# the prefill of 2,049 tokens that the decode at position 2,048 is held
# against: 2,049 = 3 x 683 (the default rule's chunk, 1,024, does not
# divide it, and the reference asserts that it does)
SERVE_REF_Q_CHUNK = 683
DECODE_TOL = 0.05  # tests/test_arch_smoke.py::test_decode_matches_prefill's bound
# phase 13a: mixtral-8x7b at full width (d 4,096, 32 heads / 8 KV, d_ff
# 14,336, 8 experts top-2, window 4,096, vocabulary 32,000), cut in depth
# from 32 layers to 1 (two would pass 2^31 entries in the flat buffer), on
# the GSPMD hist engine at world 1, in a labelled variant: the hist engine
# takes f32 leaves and an f32 residual only, and "data" is the GSPMD
# backend's one client mode (one client at world 1, as pod mode would be)
MIXTRAL1_VARIANT = dict(dtype="float32", residual_dtype="float32", client_mode="data")
MIXTRAL1_ROUNDS = 3
MIXTRAL1 = dict(preset="mixtral_8x7b", sparsity=0.001, batch=8, seq_len=256,
                rounds=MIXTRAL1_ROUNDS)
MIXTRAL1_PARAMS = 1_582_346_240  # cfg.param_count() leaves the final norm out: 1,582,342,144
MIXTRAL1_SEGMENT = 469_762_048  # each of the expert stacks up, gate, down
MIXTRAL1_LEAVES = 12
# Eq. 1 bits a client a round, pinned to the reference's
# (tests/test_torch_zoo_run.py::test_chip_smoke_mixtral_pin_is_the_references)
MIXTRAL1_EQ1 = 18188887.14773302
# the mixtral benchmark cell's layer: the variant with the published untied
# head, whose head/embedding is a thirteenth leaf (seg_accumulate's row)
MIXTRAL1_CELL_VARIANT = dict(MIXTRAL1_VARIANT, tie_embeddings=False)
MIXTRAL1_CELL_PARAMS = 1_713_418_240
MIXTRAL1_CELL_LEAVES = 13
# phase 13b: each config serves at full width in bf16, cut in depth
SERVE_ZOO = (
    # (config, layers, prompts, prompt length, parameters)
    ("mixtral_8x7b", 8, 4, 2048, 11_741_237_248),
    ("llama4_maverick_400b_a17b", 2, 4, 2048, 17_392_952_320),
    ("jamba_v01_52b", 8, 4, 512, 13_026_799_616),
    ("rwkv6_1p6b", 24, 4, 512, 1_449_824_256),
)
SERVE_ZOO_NEW = 32
# phase 14a: seamless-m4t-medium at full width and full depth (12 encoder +
# 12 decoder layers, d 1,024, 16 heads, tied 256,206 vocabulary) on the
# GSPMD hist engine at world 1 in the labelled variant STUB_VARIANT (f32
# leaves: the hist engine's only input; the residual and the client mode
# "data" are the config's own), with the preset's frames, 8 x 256 x 1,024
# (0.1 x normal), Adam at base_lr, 3 rounds; its tokens are the markov
# task's over the first SEAMLESS_TASK_VOCAB ids of the vocabulary (a table
# of 256,206^2 f32 entries would be 263 GB; the affine kind, whose
# successor map is a bijection, has no next-token marginal that a held-out
# batch could share)
STUB_VARIANT = dict(dtype="float32", residual_dtype="float32")
SEAMLESS = dict(preset="seamless_m4t_medium", sparsity=0.001, batch=8, seq_len=256, rounds=3)
SEAMLESS_TASK_VOCAB = 32_000
# parameters (31 leaves; the tied embedding is the largest segment) and
# Eq. 1 bits a client a round, pinned to the reference's from shapes by
# tests/test_torch_encdec.py::test_chip_smoke_pins_are_the_references
SEAMLESS_PINS = dict(params=614_803_456, leaves=31, segment=262_354_944,
                     eq1=7077595.532298076)
# phase 14b: phi-3-vision at full width, 8 of its 32 layers (at full depth
# its 3,722,578,944 entries pass the kernels' 2^31 offsets, and its f32
# Adam state would not fit on one card), the markov task at vocabulary
# 32,064, batch 4 x 1,024 with a 576 x 3,072 prefix (0.1 x normal)
PHI3V_LAYERS = 8
PHI3V = dict(preset="phi3_vision_4p2b", sparsity=0.001, batch=4, seq_len=1024, rounds=3)
PHI3V_PINS = dict(params=1_004_522_496, leaves=11, segment=201_326_592,
                  eq1=11548974.57565877)
# phase 14c: both serve at full width and full depth in bf16; seamless's
# encoder reads SERVE_ENC_FRAMES frames a prompt, phi-3-vision's prompts
# begin with its 576 patch embeddings
SERVE_STUBS = (
    # (config, layers, prompts, prompt length, parameters)
    ("seamless_m4t_medium", 12, 4, 256, 614_803_456),
    ("phi3_vision_4p2b", 32, 4, 1024, 3_722_578_944),
)
SERVE_ENC_FRAMES = 1024
# phase 14d: the fed launcher's own non-IID settings (fed-tiny, 16 clients,
# the dense-small rule, lr 0.05) with --non-iid --skew 2.0 --delay 5
# --sparsity 0.01 --down-sparsity 0.05, 5 rounds: per leaf, 2 means for
# each of the 8 SBC leaves of each of the 16 members, and 2 for each leaf
# of the server's downstream
NONIID_ARGV = ["--non-iid", "--skew", "2.0", "--delay", "5", "--sparsity", "0.01",
               "--down-sparsity", "0.05", "--rounds", "5"]
NONIID_ROUNDS = 5
NONIID_PER_ROUND = per_call(f32_mean_xla=2 * 8 * 16 + 2 * 8)
# phase 15, pod mode and the "model" axis: one client a "pod" coordinate,
# each leaf compressed per shard of its spec, all of a client's shards on
# its rank.  (a) granite-20b at full width, 2 of its 52 layers, on the
# single-pod layout (16, 16): 1 client of 256 shards, in a labelled f32
# variant (the hist engine takes f32 leaves and an f32 residual; the config
# is bf16), the config's SGD at base_lr, p = 0.001, batch 4 x 512 on the
# markov task at its vocabulary, 3 rounds and a profiled one; (b) two pods
# on the one card, (2, 2, 2): 2 clients (ranks, over gloo) of 4 shards, a
# reduced granite widened until its embedding and MLP stacks shard (the
# CPU tests' torch_dist_cases.WIDE), f32, on the hist engine and on the
# exact engine with the device pack; (c) mixtral-8x7b at its own dtypes
# (bf16 leaves and residual: the per-leaf exchange, a top-k and an
# f32_mean_xla a leaf) on (16, 16), 1 of 32 layers, 3 timed rounds and an
# untimed one with the launch option "lean_moe" and as many without.  Eq. 1 bits, parameters, rows (L x
# shards, summed), one device's padded length and the devices a client are
# pinned to the reference's by
# tests/test_torch_pod_run.py::test_chip_smoke_pod_pins_are_the_references
SINGLE_POD = {"data": 16, "model": 16}
POD_TWO = {"pod": 2, "data": 2, "model": 2}
POD_WIDE = dict(d_model=256, d_ff=1024, vocab_size=2048, head_dim=64)
POD_PINS = {
    "a": dict(preset="granite_20b", changes=dict(n_layers=2, dtype="float32",
                                                 residual_dtype="float32"),
              layout=SINGLE_POD, sparsity=0.001, fast=True, eq1=12289996.334429111,
              params=1_060_171_776, leaves=13, rows=3_338, n_pad=4_202_496, shards=256),
    "b": dict(preset="granite_20b", reduced=True,
              changes=dict(POD_WIDE, fsdp=True, dtype="float32", residual_dtype="float32"),
              layout=POD_TWO, sparsity=0.01, fast=True, eq1=155509.5309912474,
              params=1_903_104, leaves=13, rows=38, n_pad=727_040, shards=4),
    "c": dict(preset="mixtral_8x7b", changes=dict(n_layers=1), layout=SINGLE_POD,
              sparsity=0.001, fast=False, eq1=18231540.95516018, params=1_582_346_240,
              leaves=12, rows=1_332, n_pad=None, shards=None),
}
POD_A = dict(preset="granite_20b", sparsity=0.001, batch=4, seq_len=512, rounds=3)
POD_B = dict(batch=4, seq_len=64, rounds=3)
POD_B_EXACT_PER_ROUND = per_call(seg_packbits=1, f32_mean_xla=13 + 1)  # one mean a segment
POD_C = dict(batch=4, seq_len=512, task_vocab=32_000, rounds=3)  # and one untimed
POD_C_PER_ROUND = per_call(f32_mean_xla=12 + 1)  # one a leaf, and the loss mean
POD_TIMEOUT_S = 300
# phase 16, one rank a device (a shard axis across ranks): (a) phase 15a's
# granite-20b variant (2 of 52 layers at full width, f32, hist, SGD, p =
# 0.001, batch 4 x 512, 3 rounds and a profiled fourth; the markov task
# over FSDP_TASK_VOCAB ids) on FSDP_LAYOUT, pod mode (1 client of 4
# devices), twice on the card: one rank holding the 4
# devices' buffers, then 4 ranks over gloo of one device each; (b) the
# widened reduced granite of phase 15b on FSDP_TWO_PODS, 2 clients of 2
# ranks each (the exchange over the client ranks of one device
# coordinate), hist and exact with the device pack.  Eq. 1 bits, the
# parameters, leaves, rows (L x shards, summed) and one device's padded
# length are pinned to the reference's by
# tests/test_torch_fsdp_run.py::test_chip_smoke_fsdp_pins_are_the_references
FSDP_LAYOUT = {"data": 2, "model": 2}
FSDP_TWO_PODS = {"pod": 2, "data": 2, "model": 1}
FSDP_PINS = {
    "a": dict(POD_PINS["a"], layout=FSDP_LAYOUT, eq1=12188336.858037286, rows=62,
              n_pad=265_089_024, shards=4),
    "b": dict(POD_PINS["b"], layout=FSDP_TWO_PODS, eq1=155238.1784524112, rows=28,
              n_pad=1_120_256, shards=2),
}
FSDP_RANKS = 4
# phase 15a's 3 rounds (and its profiled fourth): gloo moves each rank's
# gathers through the host, seconds a round at full width
FSDP_A = dict(POD_A)
# the markov task over the first 8,192 ids: each rank walks its own table
# on the host, and four of 15a's 49,152² (9.7 GB each) pass the machine's
# 96 GiB beside the ranks' gloo buffers
FSDP_TASK_VOCAB = 8192
# the one-rank run's params after round 1, a .npy a leaf, for the ranks
FSDP_REF = ROOT / "build" / "fsdp_round1"
FSDP_TIMEOUT_S = 600
# the predicted peak of one rank (written before the first run), GiB
FSDP_PREDICTED_GIB = (8.0, 16.0)
# phase 17, serving across ranks: (config, layers) at full width in bf16,
# served on FSDP_LAYOUT by DIST_SERVE_RANKS ranks of one device each
DIST_SERVE = (("granite_20b", 2), ("rwkv6_1p6b", 4))
DIST_SERVE_RANKS = 4
DIST_SERVE_BATCH, DIST_SERVE_PROMPT, DIST_SERVE_NEW = 4, 2048, 8
DIST_SERVE_TOL = 2 * 2 ** -8  # of the largest |value|: tests/test_torch_decoder.py's bf16 bound
# the one-rank run's prompts, greedy tokens, logits and caches, for the ranks
DIST_SERVE_REF = ROOT / "build" / "dist_serve_one_rank"
DIST_SERVE_TIMEOUT_S = 420
# phase 18, the scale planner and the dry run (ROADMAP A13): (a)
# repro_torch.scale.plan_real on the card for SCALE_REAL's configs (the
# local backend per leaf, 4 clients, p = 0.01, 3 rounds), whose Eq. 1 bits
# a step and ledger total are pinned to the reference by
# tests/test_torch_scale.py, and f32_mean_xla's launches a round (2 an SBC
# leaf and client); (b) phase 15a's granite-20b variant (2 full-width
# layers, f32, hist) on SCALE_LAYOUT, one rank of one device: the dry
# run's peak (argument + temp bytes, printed before the card's run) within
# SCALE_PEAK_RATIO of torch.cuda.max_memory_allocated over the first 2
# steps, its kernel calls a step equal to the card's launches; (c) the dry
# run of every (arch, shape) on the single-pod layout in a subprocess,
# started after phase 1 and read here, with no error
SCALE_REAL = dict(rounds=3, sparsity=0.01)
SCALE_PINS = {
    "lenet5": dict(up_bits_per_step=102035.45994645605, up_bits_ledger=1224425.53125,
                   means_per_round=2 * 6 * 4),
    "charlstm": dict(up_bits_per_step=55454.652600547146, up_bits_ledger=665455.78125,
                     means_per_round=2 * 8 * 4),
}
SCALE_LAYOUT = {"data": 1, "model": 1}
SCALE_B = dict(batch=4, seq_len=512, steps=2, sparsity=0.001)
SCALE_B_PER_STEP = HIST_PER_ROUND  # one rank of (1, 1): one device a client
SCALE_PEAK_RATIO = (0.8, 1.25)  # predicted / measured peak
SCALE_DRYRUN = ["--all", "--mesh", "single", "--jobs", "2"]
SCALE_DRYRUN_OUT = ROOT / "build" / "dryrun_torch"
SCALE_DRYRUN_TIMEOUT_S = 900
# the leaves the reference keeps in f32 inside a bf16 model
F32_LEAVES = ("router", "A_log", "D", "mix", "mix_w", "w0", "bonus", "ln_x", "cmix_k", "cmix_r")
SEG_SBC = "src/repro_torch/kernels/csrc/seg_sbc.cu"
SOURCE = {name: SEG_SBC for name in KERNELS}
SOURCE.update(seg_packbits="src/repro_torch/kernels/csrc/pack.cu",
              seg_select_pack="src/repro_torch/kernels/csrc/pack.cu",
              f32_mean_xla="src/repro_torch/kernels/csrc/reduce.cu")
REPLACES = {
    "seg_hist2side": "src/repro/kernels/flat.py:71",
    "seg_moments": "src/repro/kernels/flat.py:126",
    "seg_binarize_apply": "src/repro/kernels/flat.py:168",
    "seg_packbits": "src/repro/kernels/pack.py:128",
    "seg_select_pack": "src/repro/kernels/pack.py:183",
    "hist2side": "src/repro/kernels/hist2side.py:70",
    "masked_moments": "src/repro/kernels/moments.py:45",
    "binarize_apply": "src/repro/kernels/binarize_apply.py:40",
    # no Pallas kernel: the jnp.mean of the exact engine's top-k values,
    # which XLA lowers to its f32 reduce-window cascade
    "f32_mean_xla": "src/repro/core/flat.py:733",
    # no Pallas kernel: the hist exchange's flatten, residual add and
    # per-segment max |x|, which XLA fuses
    "seg_accumulate": "src/repro/core/flat.py:877",
}
REFERENCE = {"f32_mean_xla": "XLA's f32 reduce lowering of jnp.mean (src/repro/core/"
                             "flat.py:733, core/stages.py:161 and :330, kernels/ops.py:152), "
                             "not a Pallas kernel",
             "seg_accumulate": "XLA's fusion of the hist exchange's flatten and residual add "
                               "(src/repro/core/flat.py:877) with jnp.max(jnp.abs(...)) a "
                               "segment (:124), not a Pallas kernel"}
# operations per element of the buffer, counted from each SBC kernel's body
OPS_PER_ELEMENT = {"seg_hist2side": 12, "seg_moments": 4, "seg_binarize_apply": 3,
                   "hist2side": 12, "masked_moments": 4, "binarize_apply": 3,
                   "seg_accumulate": 3}
SPEC = dict(preset="lenet5", backend="gspmd", fast=True, sparsity=0.01, batch=128,
            rounds=ROUNDS)


# the device symbols of the hand kernels (csrc/*.cu), as the profiler names them
HAND_KERNEL = re.compile(r"\b(seg_\w+|hist2side|masked_moments|binarize_apply|f32_mean_xla_\w+)"
                         r"_kernel\b")


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _run(fn, operands, iters: int) -> None:
    for i in range(iters):
        fn(*operands[i % len(operands)])


def _self_device_us(event) -> float:
    return getattr(event, "self_device_time_total", None) or getattr(
        event, "self_cuda_time_total", 0.0)


# torch.cuda._sleep's kernel, which opens and closes each window that
# device_ms profiles: LEAD_IN of them before the timed calls, LEAD_OUT after
SPIN_KERNEL = "spin_kernel"
LEAD_IN, LEAD_OUT, SPIN_CYCLES = 32, 8, 1000
# the most device records a retaken trace may hold, and the traces a timing may take
RECORDS_PER_TRACE, TRACES = 6000, 5


def device_ms(fn, operands, iters: int, label: str = "", ops: int | None = None,
              counted: list | None = None) -> float:
    """Mean device ms per call of ``fn(*operands[i % len(operands)])``,
    summed over the kernels, memsets and copies that the call launches,
    from CUPTI (``torch.profiler``).  Fails if the profiler saw no device
    time, or, with ``ops``, unless each call is ``ops`` device operations;
    appends the device operations a call to ``counted`` where given.
    With a ``label``, prints each device operation's share of a call.

    Every call launches the same device operations, so each one's count
    is a whole multiple of ``iters``, its operations a call.  The trace
    loses records (seen on the card with torch 2.11): the first records of
    a window, more of them the longer the process has run (1 to 3 of 240
    one-kernel calls over a process's first 160 s; about 1,400 of a
    32,000-record window late in a run), and in windows of tens of
    thousands of records, runs of records inside them too.  So each window
    opens with ``LEAD_IN`` spin kernels, which take the first loss and are
    not counted, and closes with ``LEAD_OUT``.  A count within ``iters //
    50`` records (and one) of a whole multiple is taken as that multiple,
    and the operation's time a call as its mean time times the multiple,
    which a lost record does not move; a trace with any other count is
    taken again with at most ``RECORDS_PER_TRACE`` records, up to
    ``TRACES`` in all, and then fails the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    _run(fn, operands, 5)
    for attempt in range(TRACES):
        slack = max(1, iters // 50)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(LEAD_IN):
                torch.cuda._sleep(SPIN_CYCLES)
            _run(fn, operands, iters)
            for _ in range(LEAD_OUT):
                torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if _self_device_us(e) > 0 and SPIN_KERNEL not in e.key]
        mult = [round(e.count / iters) for e in events]
        if events and all(m >= 1 and abs(e.count - m * iters) <= slack
                          for e, m in zip(events, mult)):
            break
        records = sum(e.count for e in events)
        print(f"  {label or 'plain'}: the trace lost records "
              f"({[e.count for e in events]} for {iters} calls); timing again")
        iters = max(2, min(iters, RECORDS_PER_TRACE * iters // max(records, 1)))
    else:
        raise SmokeFailure(f"{label or 'plain'}: the profiler lost records in "
                           f"{TRACES} traces")
    total_us = iters * sum(_self_device_us(e) / e.count * m for e, m in zip(events, mult))
    check(total_us > 0, "torch.profiler saw no device time")
    per_call = sum(mult)
    check(ops is None or per_call == ops,
          f"{label}: {per_call:g} device operations per call, not {ops}")
    if counted is not None:
        counted.append(per_call)
    if label:
        for e, m in sorted(zip(events, mult), key=lambda em: _self_device_us(em[0]),
                           reverse=True):
            print(f"  {label}: {_self_device_us(e) / e.count * m:.2f} us per call, "
                  f"{e.count / iters:g} per call: {e.key[:80]}")
    return total_us / iters / 1e3


def copies_past_l2(nbytes: int) -> int:
    """How many copies of ``nbytes`` of operands exceed the 50 MB L2."""
    return max(2, -(-60_000_000 // max(nbytes, 1)))


def kernel_row(name, launches, err, ms, plain_ms, nbytes, ops, label=None,
               library_ms=None) -> dict:
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / OPS_PER_S * 1e3
    row = {
        "name": name, "route": "cuda", "source": SOURCE[name], "replaces": REPLACES[name],
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }
    if name in REFERENCE:
        row["reference"] = REFERENCE[name]
    library = "" if library_ms is None else f", library {library_ms * 1e3:.2f} us"
    print(f"{label or name}: {ms * 1e3:.2f} us device per call, plain {plain_ms * 1e3:.2f} us"
          f"{library}, bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}, {nbytes} "
          f"bytes), {launches} launches on the path")
    return row


def recording(module, names, log):
    """Stand-ins for ``module.<name>`` that append ``(name, args, kwargs)``
    to ``log`` and call through."""
    def recorder(name, fn):
        def call(*args, **kwargs):
            log.append((name, args, kwargs))
            return fn(*args, **kwargs)
        return call

    return {name: recorder(name, getattr(module, name)) for name in names}


@contextlib.contextmanager
def swapped(module, replacements):
    """Replace module attributes for the duration of the block."""
    saved = {name: getattr(module, name) for name in replacements}
    try:
        for name, fn in replacements.items():
            setattr(module, name, fn)
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def drive(run, exchange_name: str, per_round: dict, label: str, rounds: int = ROUNDS,
          on_round=None, state=None) -> dict:
    """``rounds`` rounds of ``run`` from ``state`` (default ``run.init()``)
    with the launch counts set to 0 just before and read just after; the
    space's ``exchange_name`` method is observed so the last round's
    operands and outputs are kept; ``on_round(run, r, state)`` runs after
    each round's clock and counts.  Returns the
    capture: ``launches`` (counts of the run), ``last`` (bodies, res, out
    of the last exchange), ``metrics`` (each round's train-step metrics,
    before the run's metering consumes them) and the run's ``state``."""
    import torch
    from repro_torch import kernels

    space = run.fns.flat_space
    exchange = getattr(space, exchange_name)
    last, metrics = {}, []

    def observed_exchange(bodies, res_flat, **kw):
        out = exchange(bodies, res_flat, **kw)
        if len(metrics) == rounds - 1:  # the last round's: one copy of the flat buffers
            last.update(bodies=[b.clone() for b in bodies], res=res_flat.clone(), out=out)
        return out

    step = run.fns.train_step

    def observed_step(state, batch):
        state, m = step(state, batch)
        metrics.append(dict(m))
        return state, m

    setattr(space, exchange_name, observed_exchange)
    run.fns = run.fns._replace(train_step=observed_step)
    try:
        state = run.init() if state is None else state
        torch.cuda.synchronize()
        kernels.reset_launches()
        losses, counts, step_ms = [], [], []
        for r in range(rounds):
            before = kernels.launch_counts()
            t0 = time.perf_counter()
            state, m = run.step(state, r)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            after = kernels.launch_counts()
            counts.append({k: after[k] - before[k] for k in after})
            losses.append(loss)
            print(f"{label} round {r + 1}: loss {loss:.6f}  step {step_ms[-1]:.3f} ms  "
                  f"launches {counts[-1]}")
            if on_round is not None:
                on_round(run, r, state)
        launches = kernels.launch_counts()
    finally:
        delattr(space, exchange_name)
        run.fns = run.fns._replace(train_step=step)
    check(all(math.isfinite(x) for x in losses), f"{label}: non-finite loss: {losses}")
    check(all(c == per_round for c in counts), f"{label}: launches per round {counts}")
    acc = last["res"] + space.flatten_local(last["bodies"])
    mean, own, new_res = last["out"][:3]
    check(torch.equal(new_res.view(torch.int32), (acc - own).view(torch.int32)),
          f"{label}: residual != acc - dW* bit for bit")
    check(mean is own, f"{label}: one client: the mean is the client's own dW*")
    return {"launches": launches, "last": last, "acc": acc, "metrics": metrics,
            "state": state, "losses": losses, "step_ms": step_ms}


def profiled_round(run, state, label: str) -> None:
    """One more round under the profiler: where a round's time goes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = run.step(state, ROUNDS)
        float(m["loss"])
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    events = sorted(prof.key_averages(), key=_self_device_us, reverse=True)
    busy_ms = sum(_self_device_us(e) for e in events) / 1e3
    check(busy_ms > 0, f"{label}: torch.profiler saw no device time in the profiled round")
    on_device = sum(e.count for e in events if _self_device_us(e) > 0)
    print(f"{label} profiled round {ROUNDS + 1}: step {step_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / step_ms:.1f}% of the step), "
          f"{sum(e.count for e in events)} profiler events, {on_device} of them device "
          f"operations; top by device time:")
    for e in events[:12]:
        print(f"  {_self_device_us(e) / 1e3:9.4f} ms  x{e.count:<4d} {e.key[:100]}")
    hand = [(m.group(0), e) for e in events if (m := HAND_KERNEL.search(e.key))]
    if hand:
        print(f"{label}: the hand kernels in that round: " + ", ".join(
            f"{name} {_self_device_us(e) / 1e3 / e.count:.4f} ms a call x{e.count}"
            for name, e in hand))
    # the data draw's share: the same round's batches drawn once more alone
    draw = getattr(run, "batch_fn", None) or run._batch
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        draw(ROUNDS)
        torch.cuda.synchronize()
        draw_ms = (time.perf_counter() - t0) * 1e3
    draw_ops = sum(e.count for e in prof.key_averages() if _self_device_us(e) > 0)
    print(f"{label}: the round's data draw alone {draw_ms:.3f} ms ({100 * draw_ms / step_ms:.1f}% "
          f"of the profiled step), {draw_ops} device operations")
    return on_device


# --------------------------------------------------------------- hist path


def hist_path(dev) -> tuple:
    """Phase 2; returns the three SBC kernels' rows of the kernels line,
    and the last round's accumulator with the flat engine's results on it
    (``acc``, ``space``, ``out``, ``res``, ``stats``) for phase 4."""
    import torch
    from repro_torch.kernels import flat as kflat
    from repro_torch.run import RunSpec, build_run

    run = build_run(RunSpec(**SPEC, flat_engine="hist"), device=dev)
    space = run.fns.flat_space
    n_params = sum(s.global_size for s in space.segments)
    print(f"lenet5: {n_params} params in {len(space.segments)} segments, "
          f"{space.n_blocks} blocks, n_pad {space.n_pad}; "
          f"bits_per_client {run.fns.bits_per_client:.1f}")
    check(n_params == 1_256_010 and space.n_pad == 1_259_520, "LeNet5 layout")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name in ONE_OP:
        grid, resident = kflat.launch_grid(name, dev, space.n_blocks)
        print(f"{name}: persistent grid G = {grid} CTAs ({resident} resident per SM x "
              f"{sms} SMs, {space.n_blocks} blocks), one launch per call")

    cap = drive(run, "exchange_local_hist", HIST_PER_ROUND, "hist")
    one_mu_per_segment(space, cap, "hist")
    profiled_round(run, cap["state"], "hist")
    rows, pipe = hist_kernels_vs_plain(cap["acc"], space, dev, "hist",
                                       launches=cap["launches"])
    rows["seg_accumulate"] = accumulate_row(dev, cap["launches"]["seg_accumulate"])
    return rows, {"acc": cap["acc"], "space": space, **pipe}


def one_mu_per_segment(space, cap: dict, label: str) -> None:
    """The last round's ΔW* holds, per segment (and per device of the
    client, with several), 0 and that segment's μ."""
    import torch

    own = cap["last"]["out"][1].reshape(space.shards_per_client, space.n_pad)
    inf = torch.tensor(float("inf"), device=own.device)
    for s in space.segments:
        x = own[:, s.offset:s.offset + s.rows * s.n_loc]
        hi = torch.where(x != 0, x, -inf).amax(dim=1)
        lo = torch.where(x != 0, x, inf).amin(dim=1)
        check(bool(((hi == lo) | (hi == -inf)).all()),
              f"{label} segment {s.path}: a device's dW* holds more than one value")
    per = "segment" if space.shards_per_client == 1 else (
        f"(segment, device) of {space.shards_per_client} devices")
    print(f"{label} last round: residual == acc - dW* bit for bit; dW* per {per} is 0 or "
          f"its mu; {int((own != 0).sum())} entries sent")


def hist_kernels_vs_plain(acc, space, dev, label: str, launches: dict | None = None) -> tuple:
    """The hist pipeline once more on the last round's accumulator ``acc``
    with each kernel's operands captured: the kernel pipeline against the
    plain one, and each kernel against its plain version on the same
    operands (counts equal, binarize bit-equal, moment sums to
    ``rtol=1e-6``).  With ``launches`` (the path's counts), each kernel is
    also timed and its row of the kernels line returned.  Returns
    ``(rows, {"out", "res", "stats"})`` of the kernel pipeline."""
    import torch
    from repro_torch.core import flat as core_flat
    from repro_torch.kernels import flat as kflat

    bounds = [(s.offset, s.rows * s.n_loc) for s in space.segments]
    ks = [s.k for s in space.segments]
    rates = [s.rate for s in space.segments]
    sob = torch.from_numpy(space.seg_of_block.astype("int64")).to(dev)

    def pipeline():
        return core_flat._hist_pipeline(acc, bounds, ks, rates, sob, space.n_blocks,
                                        space.bm, space.lanes, 128,
                                        absmax=kflat.seg_absmax(acc, bounds))

    names = ("seg_hist2side", "seg_moments", "seg_binarize_apply")
    calls: list = []
    with swapped(core_flat, recording(core_flat, names, calls)):
        k_out, k_res, k_stats = pipeline()
    plain = {"seg_hist2side": kflat.seg_hist2side_plain,
             "seg_moments": kflat.seg_moments_plain,
             "seg_binarize_apply": kflat.seg_binarize_apply_plain}
    with swapped(core_flat, plain):
        p_out, p_res, p_stats = pipeline()
    torch.cuda.synchronize()
    check(torch.equal(k_out != 0, p_out != 0),
          f"{label}: kernel and plain pipelines select differently")
    check(torch.equal(k_res, acc - k_out), f"{label}: kernel pipeline residual")
    check(torch.allclose(k_stats["mu"], p_stats["mu"], rtol=1e-6, atol=0),
          f"{label}: pipeline mu")
    print(f"{label}: kernel pipeline == plain pipeline on the last round's accumulator "
          "(same selection, mu to rtol 1e-6)")

    rows, moments_rel = {}, 0.0
    for name, args, kwargs in calls:
        xpad, params = args
        got = getattr(kflat, name)(xpad, params, **kwargs)
        want = plain[name](xpad, params, **kwargs)
        torch.cuda.synchronize()
        if name == "seg_hist2side":
            check(torch.equal(got, want), f"{label} {name}: counts differ")
            err = float((got - want).abs().max())
        elif name == "seg_moments":
            check(torch.equal(got[:, :, 1], want[:, :, 1]), f"{label} {name}: counts differ")
            check(torch.allclose(got[:, :, 0], want[:, :, 0], rtol=1e-6, atol=0),
                  f"{label} {name}: sums beyond rtol 1e-6")
            err = float((got - want).abs().max())
            sums = want[:, :, 0] != 0
            rel = (got[:, :, 0] - want[:, :, 0]).abs()[sums] / want[:, :, 0].abs()[sums]
            moments_rel = max(moments_rel, float(rel.max()) if rel.numel() else 0.0)
        else:
            check(all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                      for g, w in zip(got, want)), f"{label} {name}: not bit-equal")
            err = 0.0
        if launches is None or name in rows:  # time the first call of each kernel
            continue
        copies = [(xpad.clone(), params.clone()) for _ in range(12)]  # > 50 MB
        fn_k = lambda x, p, f=getattr(kflat, name), kw=kwargs: f(x, p, **kw)
        fn_p = lambda x, p, f=plain[name], kw=kwargs: f(x, p, **kw)
        out_bytes = {"seg_hist2side": 4 * kwargs.get("nseg", 0) * 2 * kwargs.get("nbins", 128),
                     "seg_moments": 4 * kwargs.get("nseg", 0) * 4,
                     "seg_binarize_apply": 2 * 4 * xpad.numel()}[name]
        rows[name] = kernel_row(
            name, launches[name], err,
            device_ms(fn_k, copies, 240, name, ops=1 if name in ONE_OP else None),
            device_ms(fn_p, copies, 48), 4 * (xpad.numel() + params.numel()) + out_bytes,
            OPS_PER_ELEMENT[name] * xpad.numel(), label=f"{name} ({label} path)")
        del copies
    check(sorted({c[0] for c in calls}) == sorted(names), f"{label}: kernels compared "
                                                           f"{sorted({c[0] for c in calls})}")
    check(launches is None or set(rows) == set(names), f"{label}: kernels timed {sorted(rows)}")
    print(f"{label}: {len(calls)} kernel calls == their plain versions on the path's "
          f"operands; seg_moments' sums' largest relative error {moments_rel:.3e} (limit 1e-6)")
    return rows, {"out": k_out, "res": k_res, "stats": k_stats}


def accumulate_row(dev, launches: int) -> dict:
    """``seg_accumulate`` at the mixtral cell's width (one layer with the
    published untied head: ``MIXTRAL1_CELL_LEAVES`` leaves,
    ``MIXTRAL1_CELL_PARAMS`` entries) on seeded leaves and residual: the
    kernel bit-equal to its plain version (the composition the hist
    exchange ran before it), then both timed on two copies of the operands,
    beside the bound of 12 bytes an entry (the leaves and the residual
    read, ``acc`` written) over 3.35 TB/s.  Returns its row of the kernels
    line (``launches``: the hist path's)."""
    import dataclasses

    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core.tree import tree_flatten
    from repro_torch.kernels import flat as kflat
    from repro_torch.models.model import build_model

    variant = {k: getattr(torch, v) if k.endswith("dtype") else v
               for k, v in MIXTRAL1_CELL_VARIANT.items()}
    cfg = dataclasses.replace(get_config("mixtral_8x7b"), n_layers=1, **variant)
    with torch.device("meta"):
        shapes = [tuple(v.shape) for v in tree_flatten(build_model(cfg).init(torch.Generator()))[0]]
    bounds, n_pad = [], 0
    for shape in shapes:
        bounds.append((n_pad, math.prod(shape)))
        n_pad += max(1, -(-bounds[-1][1] // 1024)) * 1024
    check(sum(b for _, b in bounds) == MIXTRAL1_CELL_PARAMS
          and len(bounds) == MIXTRAL1_CELL_LEAVES, f"seg_accumulate: mixtral's leaves {shapes}")
    gen = torch.Generator(device=dev).manual_seed(0)
    copies = [([torch.randn(shape, generator=gen, device=dev) * 1e-3 for shape in shapes],
               torch.randn(n_pad, generator=gen, device=dev) * 1e-4) for _ in range(2)]
    fn_k = lambda leaves, res: kflat.seg_accumulate(leaves, res, bounds, n_pad)
    fn_p = lambda leaves, res: kflat.seg_accumulate_plain(leaves, res, bounds, n_pad)
    got, want = fn_k(*copies[0]), fn_p(*copies[0])
    torch.cuda.synchronize(dev)
    check(all(bit_equal(g, w) for g, w in zip(got, want)),
          "seg_accumulate: kernel != plain version at the mixtral cell's width")
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    del got, want
    ms = device_ms(fn_k, copies, 24, "seg_accumulate", ops=1)
    plain_ms = device_ms(fn_p, copies, 6)
    nbytes = 4 * (sum(b for _, b in bounds) + 2 * n_pad + len(bounds))
    grid, resident = kflat.launch_grid("seg_accumulate", dev, n_pad // 1024)
    row = kernel_row("seg_accumulate", launches, err, ms, plain_ms, nbytes,
                     OPS_PER_ELEMENT["seg_accumulate"] * n_pad,
                     label=f"seg_accumulate (mixtral-8x7b cell, 1 layer, {n_pad} entries)")
    row["hbm_share"] = row["bound_ms"] / ms
    print(f"seg_accumulate: {row['hbm_share']:.1%} of {HBM_BYTES_PER_S / 1e12:.2f} TB/s over "
          f"{nbytes} bytes; persistent grid G = {grid} ({resident} resident per SM); bit-equal "
          f"to its plain version (acc and {len(bounds)} maxima)")
    del copies
    torch.cuda.empty_cache()
    return row


# -------------------------------------------------------------- exact path


def exact_path(dev) -> dict:
    """Phase 3; returns the two packers' rows of the kernels line."""
    import numpy as np
    import torch
    from repro_torch.kernels import pack as kpack
    from repro_torch.run import RunSpec, build_run

    run = build_run(RunSpec(**SPEC, flat_engine="exact", device_pack=True,
                            measure_wire=True), device=dev)
    space = run.fns.flat_space
    print(f"exact: n_mu {space.n_mu}, n_pos {space.n_pos}, n_pack_words "
          f"{space.n_pack_words}; (b*, words/row, word offset) per segment "
          f"{list(space._pack_info)}")
    check((space.n_mu, space.n_pos, space.n_pack_words) == (6, 12_561, 3_358),
          "LeNet5 exact layout")
    cap = drive(run, "exchange_local", EXACT_PER_ROUND, "exact")
    masks, words, nbits = exact_wire_checks(run, cap, dev, "exact")
    ops = profiled_round(run, cap["state"], "exact")
    print(f"exact profiled round: {ops} device operations (before f32_mean_xla: "
          f"{EXACT_DEVICE_OPS_BEFORE}; {ops - EXACT_DEVICE_OPS_BEFORE:+d})")

    # where the exchange's time goes: with and without the device pack
    last = cap["last"]
    for pack in (False, True):
        for _ in range(2):
            space.exchange_local(last["bodies"], last["res"], device_pack=pack)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            space.exchange_local(last["bodies"], last["res"], device_pack=pack)
        torch.cuda.synchronize()
        print(f"exact exchange_local (device_pack={pack}): "
              f"{(time.perf_counter() - t0) * 100:.3f} ms host clock per call")

    rows = {}
    # the path's one launch: seg_packbits on its stream-order bits
    allbits = packbits_vs_plain(space, last, words, "exact")
    nwords = -(-allbits.numel() // 32)
    copies = [(allbits.clone(),) for _ in range(copies_past_l2(4 * allbits.numel()))]
    stream = kernel_row(
        "seg_packbits", cap["launches"]["seg_packbits"], 0.0,
        device_ms(kpack.seg_packbits_stream, copies, 240, "seg_packbits (stream order)",
                  ops=1),
        device_ms(kpack.seg_packbits_stream_plain, copies, 48),
        4 * (allbits.numel() + nwords), 64 * nwords, label="seg_packbits (stream order)")
    del copies

    # the planes entry, the reference's signature, on the same bits as planes
    pad = -allbits.numel() % (32 * space.lanes)
    planes = torch.cat([allbits, allbits.new_zeros((pad,))]).reshape(-1, 32).T.contiguous()
    got = kpack.seg_packbits(planes, lanes=space.lanes)
    want = kpack.seg_packbits_plain(planes, lanes=space.lanes)
    torch.cuda.synchronize()
    check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
          "seg_packbits: kernel words != plain words")
    check(torch.equal(got[:space.n_pack_words].view(torch.int32), words.view(torch.int32)),
          "seg_packbits: words != the path's words")
    pwords = planes.shape[1]
    print(f"seg_packbits (planes): {pwords} words ({pwords // space.lanes} blocks of "
          f"{space.lanes}) bit-equal to the plain version and the path")
    copies = [(planes.clone(),) for _ in range(copies_past_l2(4 * planes.numel()))]
    planes_row = kernel_row(
        "seg_packbits", 0, 0.0,
        device_ms(lambda p: kpack.seg_packbits(p, lanes=space.lanes), copies, 240,
                  "seg_packbits (planes)"),
        device_ms(lambda p: kpack.seg_packbits_plain(p, lanes=space.lanes), copies, 48),
        4 * (planes.numel() + pwords), 64 * pwords, label="seg_packbits (planes)")
    del copies
    # the row is the stream-order entry's, which the path launches; the
    # planes entry, which no path launches, has fields of its own
    stream.update({f"planes_{key}": planes_row[key]
                   for key in ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")})
    rows["seg_packbits"] = stream

    # seg_select_pack on the path's masks: the same words and bit counts
    mu_row = 0
    for s, b, w, off, mask in masks:
        sw, snb = kpack.seg_select_pack(mask, k=s.k, bstar=b)
        pw, pnb = kpack.seg_select_pack_plain(mask, k=s.k, bstar=b)
        torch.cuda.synchronize()
        seg_words = words[off:off + s.rows * w].view(torch.int32).reshape(s.rows, w)
        check(torch.equal(sw.view(torch.int32), pw.view(torch.int32))
              and torch.equal(snb, pnb), f"seg_select_pack {s.path}: kernel != plain")
        check(torch.equal(sw.view(torch.int32), seg_words)
              and torch.equal(snb, nbits[mu_row:mu_row + s.rows]),
              f"seg_select_pack {s.path}: words != seg_packbits' words")
        mu_row += s.rows
    print("seg_select_pack: every segment's words and bit counts equal to its plain "
          "version and to seg_packbits'")
    s, b, w, off, mask = max(masks, key=lambda e: e[4].numel())
    nrows, n = mask.shape
    grid, resident, tiles = kpack.select_pack_grid(dev, nrows, n, b)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"seg_select_pack on {s.path}: {tiles} tiles of T = {kpack.TILE_SLOTS} slots over "
          f"a persistent grid of {grid} CTAs ({resident} resident per SM x {sms} SMs), "
          f"one launch per call")
    copies = [(mask.clone(),) for _ in range(copies_past_l2(4 * mask.numel()))]
    rows["seg_select_pack"] = kernel_row(
        "seg_select_pack", cap["launches"]["seg_select_pack"], 0.0,
        device_ms(lambda m: kpack.seg_select_pack(m, k=s.k, bstar=b), copies, 240,
                  "seg_select_pack", ops=1),
        device_ms(lambda m: kpack.seg_select_pack_plain(m, k=s.k, bstar=b), copies, 12),
        4 * (nrows * n + nrows * w + nrows), 2 * nrows * n + 8 * nrows * s.k)
    print(f"seg_select_pack timed on {s.path}: n {n}, k {s.k}, {w} words")
    del copies
    # the other rows it is timed on: every other segment's mask, and seeded
    # masks of the card tests' 1,000-slot rows (one tile a row)
    rng = np.random.default_rng(0)
    shapes = [(f"{s.path} mask", mask, s.k, b) for s, b, w, off, mask in masks
              if mask.numel() < nrows * n]
    for srows, sn, sk, sb in SELECT_PACK_SHAPES:
        m = np.zeros((srows, sn), np.int32)
        for r in range(srows):
            m[r, rng.choice(sn, sk, replace=False)] = 1
        shapes.append((f"seeded {srows} x {sn}", torch.from_numpy(m).to(dev), sk, sb))
    for label, m, sk, sb in shapes:
        sw, snb = kpack.seg_select_pack(m, k=sk, bstar=sb)
        pw, pnb = kpack.seg_select_pack_plain(m, k=sk, bstar=sb)
        torch.cuda.synchronize()
        check(bit_equal(sw, pw) and torch.equal(snb, pnb),
              f"seg_select_pack {label}: kernel != plain")
        # as many copies as calls: small rows stay in the L2 (and a few
        # bytes' worth of copies past it would be millions of tensors)
        copies = [(m.clone(),) for _ in range(min(copies_past_l2(4 * m.numel()), 240))]
        us = 1e3 * device_ms(lambda x: kpack.seg_select_pack(x, k=sk, bstar=sb), copies,
                             240, f"seg_select_pack on {label}", ops=1)
        del copies
        grid, _, tiles = kpack.select_pack_grid(dev, *m.shape, sb)
        print(f"seg_select_pack on {label}: rows {m.shape[0]}, n {m.shape[1]}, k {sk}, "
              f"b* {sb}, {tiles} tiles on {grid} CTAs: {us:.2f} us device per call")

    from repro_torch.kernels import reduce as kreduce

    calls = exact_means_vs_plain(space, last, "exact")
    vals = max((c[1][0] for c in calls), key=lambda v: v.numel())
    copies = [(vals.clone(),) for _ in range(copies_past_l2(4 * vals.numel()))]
    rows["f32_mean_xla"] = kernel_row(
        "f32_mean_xla", cap["launches"]["f32_mean_xla"], 0.0,
        device_ms(kreduce.f32_mean_xla, copies, len(copies), "f32_mean_xla", ops=1),
        device_ms(kreduce.f32_mean_xla_plain, copies, 12),
        4 * (vals.numel() + vals.shape[0]), cascade_adds(vals.shape[1]) * vals.shape[0],
        label=f"f32_mean_xla on f1's top-k values {tuple(vals.shape)} "
              f"({kreduce.launch_ctas(*vals.shape, dev)} CTAs)",
        library_ms=device_ms(lambda v: torch.sum(v, dim=-1), copies, len(copies)))
    del copies
    rows["f32_mean_xla"]["shapes"] = mean_shapes(dev)
    return rows


def exact_wire_checks(run, cap: dict, dev, label: str) -> tuple:
    """The exact path's last round: ΔW* per (segment, row) is one ±μ in
    exactly k slots and its packed stream is the host encoder's bytes, bit
    count and word for word; and every round's ledger meters Σ nbits + 32
    bits per μ.  Returns each segment's ``(segment, b*, words a row, word
    offset, int32 mask)``, the words and the bit counts."""
    import numpy as np
    import torch
    from repro_torch.core.golomb import encode_positions_packed, packed_words_to_bytes

    space = run.fns.flat_space
    _, own, _, words, nbits = cap["last"]["out"]
    m_last = cap["metrics"][-1]
    check(torch.equal(m_last["packed_words_client0"][0].view(torch.int32),
                      words.view(torch.int32)),
          f"{label}: packed_words_client0 != the exchange's words")
    own_np, words_np, nbits_np = own.cpu().numpy(), words.cpu().numpy(), nbits.cpu().numpy()
    masks, mu_row = [], 0
    for s, (b, w, off) in zip(space._sparse, space._pack_info):
        x = own_np[s.offset:s.offset + s.rows * s.n_loc].reshape(s.rows, s.n_loc)
        for r in range(s.rows):
            pos = np.flatnonzero(x[r])
            vals = np.unique(x[r][pos])
            check(pos.size == s.k and vals.size == 1,
                  f"{label} {s.path} row {r}: dW* holds {vals.size} values in {pos.size} "
                  f"slots, not one in k={s.k}")
            host, host_nb = encode_positions_packed(pos, s.rate)
            nb = int(nbits_np[mu_row])
            check(nb == host_nb and packed_words_to_bytes(
                words_np[off + r * w:off + (r + 1) * w], nb) == host,
                f"{label} {s.path} row {r}: packed words are not the host encoder's bytes")
            mu_row += 1
        masks.append((s, b, w, off, torch.from_numpy((x != 0).astype(np.int32)).to(dev)))
    print(f"{label} last round: residual == acc - dW* bit for bit; each of {space.n_mu} "
          f"rows holds one +-mu in exactly k slots; its packed words are the host "
          f"encoder's bytes ({int(nbits_np.sum())} bits)")

    # the ledger meters Σ nbits + 32 bits per μ every round
    led = run.ledger.history()["up_bits_measured"]
    want = [float(m["packed_nbits"].sum()) + 32.0 * space.n_mu for m in cap["metrics"]]
    check(led == want, f"{label}: ledger measured bits {led} != sum(nbits) + 32 n_mu {want}")
    print(f"{label} ledger: up_bits_measured per round {led} (analytic "
          f"{run.ledger.records[0].up_bits_analytic}); up bytes "
          f"{run.ledger.totals()['up_bytes']}")
    return masks, words, nbits


def exact_means_vs_plain(space, last: dict, label: str) -> list:
    """``f32_mean_xla`` on the exact path's own top-k values: the last
    round's exchange once more, both sides of every segment, one call per
    segment of shape ``(2 rows, k)``, each bit-equal to the plain cascade.
    Returns the recorded calls."""
    import torch
    from repro_torch.kernels import reduce as kreduce
    from repro_torch.kernels import topk as ktopk

    calls: list = []
    with swapped(ktopk, recording(ktopk, ("f32_mean_xla",), calls)):
        space.exchange_local(last["bodies"], last["res"], device_pack=True)
    check(len(calls) == len(space._sparse),
          f"{label}: one f32_mean_xla call per segment, saw {len(calls)}")
    for (_, args, _), s in zip(calls, space._sparse):
        vals = args[0]
        got, want = kreduce.f32_mean_xla(vals), kreduce.f32_mean_xla_plain(vals)
        torch.cuda.synchronize()
        check(tuple(vals.shape) == (2 * s.rows, s.k) and bit_equal(got, want),
              f"{label} f32_mean_xla {s.path}: kernel != plain cascade on {tuple(vals.shape)}")
    seen = {tuple(c[1][0].shape) for c in calls}
    print(f"{label} f32_mean_xla: bit-equal to the plain cascade on the top-k values of every "
          f"segment ({len(calls)} calls, shapes {sorted(seen)})")
    return calls


def mean_shapes(dev) -> list:
    """``f32_mean_xla`` on seeded values of every shape the exact, codec
    and local paths launch (``MEAN_SHAPES``): bit-equal to the plain cascade,
    one device operation a call where the package has this design, and
    its device µs beside ``torch.sum(vals, dim=-1)``'s on the same
    operands.  A package without ``launch_ctas`` (the parent design: one
    CTA a row) is timed all the same, its operations counted."""
    import numpy as np
    import torch
    from repro_torch.kernels import reduce as kreduce

    split = hasattr(kreduce, "launch_ctas")
    rng = np.random.default_rng(5)
    out = []
    for rows, n in MEAN_SHAPES:
        vals = torch.from_numpy(rng.standard_normal((rows, n)).astype(np.float32)).to(dev)
        check(bit_equal(kreduce.f32_mean_xla(vals), kreduce.f32_mean_xla_plain(vals)),
              f"f32_mean_xla {(rows, n)}: kernel != plain cascade")
        copies = [(vals.clone(),) for _ in range(240)]  # all in the L2, as on the path
        label = f"f32_mean_xla {(rows, n)}"
        counted: list = []
        us = 1e3 * device_ms(kreduce.f32_mean_xla, copies, 240, label, ops=1 if split else None,
                             counted=counted)
        ops = counted[0]
        sum_us = 1e3 * device_ms(lambda v: torch.sum(v, dim=-1), copies, 240)
        ctas = kreduce.launch_ctas(rows, n, dev) if split else None
        print(f"{label}: {us:.2f} us device per call, {ops:g} device operations, "
              f"{ctas if split else rows} CTAs; torch.sum {sum_us:.2f} us")
        out.append({"rows": rows, "n": n, "ctas": ctas, "us": us, "ops": ops,
                    "sum_us": sum_us})
        del copies
    return out


def cascade_adds(n: int) -> int:
    """f32 operations of one row of XLA's reduce cascade over n values:
    32 adds a window at each level, the last partials, one multiply."""
    ops = 0
    while n > 32:
        n = -(-n // 32)
        ops += 32 * n
    return ops + n + 1


# ----------------------------------------------------------- per-leaf path


def bit_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def leaf_path(dev, hist: dict) -> dict:
    """Phase 4; returns the three per-leaf kernels' rows of the kernels line."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import binarize_apply as kbin
    from repro_torch.kernels import hist2side as khist
    from repro_torch.kernels import moments as kmom
    from repro_torch.kernels import ops

    acc, space = hist["acc"], hist["space"]
    segs = [(s, s.offset, s.rows * s.n_loc) for s in space.segments]
    leaves = [acc[off:off + size] for _, off, size in segs]  # views into the flat buffer

    def compress_all():
        return [ops.sbc_compress_hist(leaf, p=s.rate, bm=space.bm, lanes=space.lanes)
                for leaf, (s, _, _) in zip(leaves, segs)]

    torch.cuda.synchronize()
    kernels.reset_launches()
    outs = compress_all()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    want = {name: c * len(leaves) for name, c in LEAF_PER_LEAF.items()}
    check(launches == want, f"per-leaf launches {launches} != {want}")
    print(f"per-leaf: sbc_compress_hist on {len(leaves)} leaves (views into the hist "
          f"path's last accumulator, bm={space.bm}, lanes={space.lanes}): launches "
          f"{ {k: v for k, v in launches.items() if v} }, no other kernel")
    for i, ((s, off, size), leaf, out) in enumerate(zip(segs, leaves, outs)):
        check(bit_equal(out.delta_star, hist["out"][off:off + size])
              and bit_equal(out.residual, hist["res"][off:off + size])
              and bit_equal(out.mean, hist["stats"]["mu"][i])
              and bit_equal(out.count, hist["stats"]["count"][i]),
              f"{s.path}: per-leaf dW*, residual, mu or count != the flat engine's")
        check(bit_equal(out.residual, leaf - out.delta_star),
              f"{s.path}: residual != acc - dW* bit for bit")
        print(f"  {s.path}: n {size}, k {s.k}, survivors {int(out.count)} "
              f"({float(out.count) / s.k - 1:+.2%}), mu {float(out.mean):.6e}")
    print("per-leaf == flat hist engine bit for bit on every leaf (dW*, residual, mu, "
          "count); residual == acc - dW* bit for bit")

    torch.cuda.set_sync_debug_mode("error")
    try:
        again = compress_all()
    except RuntimeError as e:
        raise SmokeFailure(f"per-leaf path waited for the card: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(all(bit_equal(a.delta_star, b.delta_star) for a, b in zip(again, outs)),
          "per-leaf: a second run differs")
    print("per-leaf: the six calls ran again under set_sync_debug_mode('error'): "
          "no host sync, same results")

    # each kernel against its plain version, on the path's own operands
    wrap = {"hist2side": khist.hist2side, "masked_moments": kmom.masked_moments,
            "binarize_apply": kbin.binarize_apply}
    plain = {"hist2side": khist.hist2side_plain,
             "masked_moments": kmom.masked_moments_plain,
             "binarize_apply": kbin.binarize_apply_plain}
    calls: list = []
    with swapped(ops, recording(ops, LEAF_KERNELS, calls)):
        compress_all()
    check([c[0] for c in calls] == list(LEAF_KERNELS[:1] + LEAF_KERNELS) * len(leaves),
          f"per-leaf calls {[c[0] for c in calls]}")
    errs = {name: 0.0 for name in LEAF_KERNELS}
    for name, args, kwargs in calls:
        got, want_ = wrap[name](*args, **kwargs), plain[name](*args, **kwargs)
        torch.cuda.synchronize()
        if name == "hist2side":
            check(torch.equal(got, want_), f"{name}: counts differ")
        elif name == "masked_moments":
            for bm, lanes in MOMENT_TILES:  # the path's tile and the default one
                tile = dict(kwargs, bm=bm, lanes=lanes)
                check(bit_equal(wrap[name](*args, **tile), plain[name](*args, **tile)),
                      f"{name} at bm={bm}, lanes={lanes}: not bit-equal to plain")
        else:
            check(all(bit_equal(g, w) for g, w in zip(got, want_)), f"{name}: not bit-equal")
        err = 0.0 if name == "binarize_apply" else float((got - want_).abs().max())
        errs[name] = max(errs[name], err)
    print(f"per-leaf kernels == plain versions on all {len(calls)} calls of the path "
          f"(counts equal; binarize and masked_moments bit-equal, the latter at "
          f"bm x lanes {MOMENT_TILES}); largest absolute differences {errs}")

    # timed on the largest leaf (f1), operands rotated past the L2 cache:
    # its calls are hist2side twice (the coarse pass, then the zoomed one),
    # masked_moments and binarize_apply
    f1 = max(range(len(leaves)), key=lambda i: leaves[i].numel())
    rows, nbins = {}, 128
    for name, args, kwargs in calls:
        x = args[0]
        if x.numel() != leaves[f1].numel():
            continue
        nel = x.numel()
        copies = [(x.clone(), *args[1:]) for _ in range(copies_past_l2(4 * nel))]
        zoomed = name in rows
        label = "hist2side (zoomed pass)" if zoomed else name
        ms = device_ms(lambda *a, f=wrap[name], kw=kwargs: f(*a, **kw), copies, 240, label,
                       ops=1 if name in ("hist2side", "masked_moments") else None)
        plain_ms = device_ms(lambda *a, f=plain[name], kw=kwargs: f(*a, **kw), copies, 24)
        if name == "masked_moments":  # the reference's default tile too
            kw = dict(kwargs, bm=MOMENT_TILES[1][0], lanes=MOMENT_TILES[1][1])
            default_ms = device_ms(lambda *a: wrap[name](*a, **kw), copies, 240,
                                   "masked_moments (default tile)", ops=1)
            # 8 calls: its 1,037 device operations a call over 24 calls (24,888
            # records) overran the profiler's buffer and lost records
            default_plain_ms = device_ms(lambda *a: plain[name](*a, **kw), copies, 8)
        del copies
        if zoomed:
            rows[name].update(zoomed_ms=ms, zoomed_plain_ms=plain_ms)
            print(f"{label}: {ms * 1e3:.2f} us device per call, plain {plain_ms * 1e3:.2f} us")
            continue
        out_bytes = {"hist2side": 4 * 2 * nbins, "masked_moments": 16,
                     "binarize_apply": 8 * nel}[name]
        scalar_bytes = {"hist2side": 16, "masked_moments": 8, "binarize_apply": 16}[name]
        rows[name] = kernel_row(
            name, launches[name], errs[name], ms, plain_ms,
            4 * nel + scalar_bytes + out_bytes, OPS_PER_ELEMENT[name] * nel,
            label="hist2side (coarse pass)" if name == "hist2side" else None)
    rows["masked_moments"].update(default_tile_ms=default_ms,
                                  default_tile_plain_ms=default_plain_ms)
    print(f"masked_moments at the default tile {MOMENT_TILES[1]}: {default_ms * 1e3:.2f} us "
          f"device per call, plain {default_plain_ms * 1e3:.2f} us")
    check("zoomed_ms" in rows["hist2side"], "hist2side: the zoomed pass was not timed")
    check(set(rows) == set(LEAF_KERNELS), f"per-leaf kernels timed: {sorted(rows)}")
    print(f"per-leaf kernels timed on {segs[f1][0].path}: n {leaves[f1].numel()}, "
          f"k {segs[f1][0].k}")

    # the survivor band of the reference's own test, on seeded Gaussian data
    n_f1, p = leaves[f1].numel(), segs[f1][0].rate
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(n_f1).astype(np.float32)
                         ).to(dev)
    gh, ge = ops.sbc_compress_hist(g, p=p), ops.sbc_compress_exact(g, p=p)
    k = max(1, round(p * n_f1))
    count, mean, exact_mean = float(gh.count), float(gh.mean), float(ge.mean)
    check(abs(count - k) <= max(2, 0.02 * k)
          and abs(mean - exact_mean) <= 0.02 * abs(exact_mean),
          f"Gaussian n {n_f1}: survivors {count} against k {k}, mu {mean} against the "
          f"exact {exact_mean}: outside the +-2% band")
    print(f"Gaussian n {n_f1}, p {p}: survivors {int(count)} against k {k} "
          f"({count / k - 1:+.2%}), mu {mean:.6e} against the exact top-k's "
          f"{exact_mean:.6e}: inside the +-2% band")
    return rows


# ------------------------------------------------------- codec + wire path


def codec_path(dev) -> dict:
    """Phase 5: the codec, policy and SBW1 wire at LeNet5's full width, and
    one GSPMD exact round with the same dense pattern.  Returns the launch
    counts of its five rounds and the time of each Golomb leaf's
    ``seg_select_pack``."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import stages as core_stages
    from repro_torch.core import wire as core_wire
    from repro_torch.core.stages import k_for
    from repro_torch.core.tree import tree_map
    from repro_torch.core.wire import wire_for
    from repro_torch.kernels import pack as kpack
    from repro_torch.kernels import reduce as kreduce
    from repro_torch.kernels import topk as ktopk
    from repro_torch.models.model import build_model
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.run import RunSpec, build_preset, build_run, policy_from_spec

    p = SPEC["sparsity"]
    cfg, task = build_preset("lenet5", batch=SPEC["batch"], seq_len=0, seed=0, device=dev)
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = {k: v.to(dev) for k, v in model.init(gen).items()}
    opt = get_optimizer(cfg.local_opt)
    opt_state = opt.init(params)
    policy = policy_from_spec(RunSpec(preset="lenet5", compressor="sbc",
                                      dense_pattern=DENSE_PATTERN))
    resolved = policy.resolve(params)
    state = resolved.init_state(params)
    wire = wire_for(resolved, params, p)
    sbc = [s for s in wire.specs if s.encoder == "golomb"]
    n_dense = sum(s.n for s in wire.specs if s.selector == "dense")
    print(f"codec: policy {policy.name!r} (fast={policy.fast}), "
          f"{sum(s.n for s in wire.specs)} params in {len(wire.specs)} leaves: "
          f"{[(s.path, s.selector, s.n, s.k) for s in wire.specs]}")
    check(len(sbc) == 4 and n_dense == 510, "codec: LeNet5 under sbc with f1b, f2b dense")

    # the device pack's seg_select_pack calls, their outputs kept
    packed = []

    def kept_select_pack(mask, **kw):
        out = kpack.seg_select_pack(mask, **kw)
        packed.append((mask, kw, out))
        return out

    def delta_of_one_step(r):
        nonlocal params, opt_state
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = model.loss_fn(leaves, task.sample(r, 0))
        keys = sorted(leaves)
        grads = dict(zip(keys, torch.autograd.grad(loss, [leaves[k] for k in keys])))
        with torch.no_grad():
            p2, opt_state = opt.apply(opt_state, grads, params, cfg.base_lr, 0)
        return {k: p2[k] - params[k] for k in keys}, float(loss.detach())

    times = {"compress": [], "device pack": [], "host pack": [], "unpack": []}
    means: list = []  # every f32_mean_xla call of the rounds
    torch.cuda.synchronize()
    kernels.reset_launches()
    counts = []
    with swapped(core_wire, {"seg_select_pack": kept_select_pack}), \
            swapped(ktopk, recording(ktopk, ("f32_mean_xla",), means)), \
            swapped(core_stages, recording(core_stages, ("f32_mean_xla",), means)):
        for r in range(ROUNDS):
            delta, loss = delta_of_one_step(r)
            check(math.isfinite(loss), f"codec round {r + 1}: loss {loss}")
            acc = tree_map(lambda d, res: d.reshape(-1) + res.reshape(-1), delta,
                           state.residual)
            torch.cuda.synchronize()
            before = kernels.launch_counts()
            t0 = time.perf_counter()
            comp, dense, state = resolved.compress(delta, state, resolved.rates(p))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            packed.clear()
            blob, bits = wire.pack_with_bits(comp, device_pack=True)
            t2 = time.perf_counter()
            host_blob, host_bits = wire.pack_with_bits(comp)
            t3 = time.perf_counter()
            rec = wire.unpack(blob)
            t4 = time.perf_counter()
            after = kernels.launch_counts()
            counts.append({k: after[k] - before[k] for k in after})
            for key, dt in zip(times, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                times[key].append(dt * 1e3)
            check(blob == host_blob and bits == host_bits,
                  f"codec round {r + 1}: device-packed blob != host-packed blob")
            for key in dense:
                check(bit_equal(rec[key].to(dev), dense[key]),
                      f"codec round {r + 1}: unpack of the blob != dW* on {key}")
                check(bit_equal(state.residual[key].reshape(-1), acc[key] - dense[key].reshape(-1)),
                      f"codec round {r + 1}: residual != acc - dW* on {key}")
            for s in sbc:
                c, d = comp[s.path], dense[s.path].reshape(-1)
                k = k_for(s.n, s.p)
                vals = torch.unique(d[c.idx.long()])
                check(c.idx.numel() == k and int((d != 0).sum()) == k and vals.numel() == 1
                      and bit_equal(vals[0], c.mean),
                      f"codec round {r + 1}: {s.path} holds {int((d != 0).sum())} survivors, "
                      f"not k={k} at one +-mu")
            nbits = sum(int(out[1][0]) for _, _, out in packed)
            want = nbits + 32 * len(sbc) + 32 * n_dense
            check(len(packed) == len(sbc) and bits == want,
                  f"codec round {r + 1}: measured {bits} bits != sum(nbits) {nbits} + 32 per mu "
                  f"+ 32 per dense entry = {want}")
            analytic = float(resolved.total_bits(comp))
            print(f"codec round {r + 1}: loss {loss:.6f}; blob {len(blob)} bytes, measured "
                  f"{bits} payload bits (Golomb {nbits} + {32 * len(sbc)} mu + {32 * n_dense} "
                  f"dense) against Eq. 1's {analytic:.2f}; launches "
                  f"{ {k: v for k, v in counts[-1].items() if v} }")
            with torch.no_grad():  # one client: apply the transmitted update
                params = {k: params[k] + dense[k] for k in params}
    launches = kernels.launch_counts()
    check(all(c == CODEC_PER_ROUND for c in counts), f"codec: launches per round {counts}")
    print("codec: every round's device-packed blob == host-packed blob byte for byte; "
          "unpack == dW* and residual == acc - dW* bit for bit; k survivors at +-mu per "
          "SBC leaf; measured bits == sum(nbits) + 32 per mu + 32 per dense entry")
    for key, ms in times.items():
        print(f"codec host ms per round, {key}: {', '.join(f'{t:.3f}' for t in ms)}")
    shapes = sorted({tuple(args[0].shape) for _, args, _ in means})
    check(set(shapes) <= set(MEAN_SHAPES), f"codec f32_mean_xla shapes {shapes} not all in "
                                           f"MEAN_SHAPES")
    for _, args, kwargs in means[-CODEC_PER_ROUND["f32_mean_xla"]:]:
        check(bit_equal(kreduce.f32_mean_xla(*args, **kwargs),
                        kreduce.f32_mean_xla_plain(*args, **kwargs)),
              f"codec f32_mean_xla {tuple(args[0].shape)}: kernel != plain cascade")
    print(f"codec: f32_mean_xla on shapes {shapes}; the last round's 8 calls bit-equal to the "
          f"plain cascade on their own operands")

    # seg_select_pack on each Golomb leaf's mask of the last round
    select_us = {}
    for (mask, kw, _), s in zip(packed, sbc):
        copies = [(mask.clone(),) for _ in range(min(copies_past_l2(4 * mask.numel()), 240))]
        us = 1e3 * device_ms(lambda m, kw=kw: kpack.seg_select_pack(m, **kw), copies, 240,
                             f"seg_select_pack on the {s.path} leaf", ops=1)
        del copies
        select_us[s.path] = us
        print(f"seg_select_pack on the {s.path} leaf mask: n {s.n}, k {kw['k']}, "
              f"b* {kw['bstar']}: {us:.2f} us device per call")

    # one GSPMD exact round with the same dense pattern, through build_run
    run = build_run(RunSpec(**SPEC, flat_engine="exact", device_pack=True, measure_wire=True,
                            dense_pattern=DENSE_PATTERN), device=dev)
    space = run.fns.flat_space
    st = run.init()
    torch.cuda.synchronize()
    kernels.reset_launches()
    st, m = run.step(st, 0)
    loss = float(m["loss"])
    torch.cuda.synchronize()
    got = kernels.launch_counts()
    check(math.isfinite(loss) and got == DENSE_EXACT_PER_ROUND,
          f"exact round with dense pattern: loss {loss}, launches {got}")
    rec = run.ledger.records[0]
    print(f"exact round with --dense-pattern {DENSE_PATTERN!r}: loss {loss:.6f}, "
          f"{space.n_mu} SBC rows and {sum(s.global_size for s in space.segments if s.kind == 'dense')} "
          f"dense entries; measured {rec.up_bits_measured:.0f} bits against Eq. 1's "
          f"{rec.up_bits_analytic:.2f}; launches { {k: v for k, v in got.items() if v} }")
    return {"launches": launches, "select_us": select_us}


# ------------------------------------------------------------ local path


def local_path(dev, spec: dict = LOCAL_SPEC, per_round: dict = LOCAL_PER_ROUND,
               name: str = "local", build=None, rounds: int = ROUNDS,
               profile: bool = True) -> dict:
    """Phase 6, and the local rounds of phases 7 and 10: the local
    backend's Alg. 1 round (``LocalRun``) of ``spec`` at full width,
    ``rounds`` rounds on each path that ``per_round`` names (``False`` per
    leaf, the reference's default; ``True`` the flat space), each with the
    launch counts set to 0 just before and read just after (``per_round``
    a round, nothing else) and, with ``profile``, one profiled round.
    ``build(fast)`` builds the run where ``spec`` is not a preset's
    (through the library).  Checks: every loss finite; the last round's
    residual ``acc − ΔW*`` bit for bit for every client (codecs with error
    feedback); every ``f32_mean_xla`` call bit-equal to its plain cascade
    on its operands, and their shapes the path's own
    (:func:`path_mean_shapes`); each ledger row's measured bits C x client
    0's packed upload (the wire's ``measured_bits``) and its analytic bits
    C x the round's Eq. 1; with both paths, bit-identical params,
    residuals, optimizer states and ledger rows.  Returns, by path, the
    launches, each round's metrics and step ms, the state, the run and
    the last round's client-0 upload."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import stages as core_stages
    from repro_torch.core.tree import tree_flatten
    from repro_torch.kernels import reduce as kreduce
    from repro_torch.kernels import topk as ktopk
    from repro_torch.optim import AdamState
    from repro_torch.run import RunSpec, build_run

    check(spec.get("measure_wire"), f"{name}: the ledger's checks need measure_wire")
    out = {key: {} for key in ("launches", "metrics", "step_ms", "states", "runs", "upload")}
    for fast, want in per_round.items():
        run = (build(fast) if build is not None
               else build_run(RunSpec(**spec, fast=fast), device=dev))
        label = f"{name} ({'flat' if fast else 'per-leaf'} path)"
        channel = run.channel
        exchange, record = channel.round_exchange, channel.record_round
        last, uploads, means = {}, [], []

        def observed(deltas, comp_state, *a, exchange=exchange, last=last, **kw):
            ex = exchange(deltas, comp_state, *a, **kw)
            last.update(deltas=deltas, residual=comp_state.residual, ex=ex)
            return ex

        def metered(round_idx, record=record, uploads=uploads, **kw):
            uploads.append(kw)
            return record(round_idx, **kw)

        channel.round_exchange, channel.record_round = observed, metered
        state = run.init()
        torch.cuda.synchronize()
        kernels.reset_launches()
        counts, metrics, step_ms = [], [], []
        try:
            with swapped(ktopk, recording(ktopk, ("f32_mean_xla",), means)), \
                    swapped(core_stages, recording(core_stages, ("f32_mean_xla",), means)):
                for r in range(rounds):
                    before = kernels.launch_counts()
                    t0 = time.perf_counter()
                    state, m = run.step(state, r)
                    loss = float(m["loss"])
                    torch.cuda.synchronize()
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                    after = kernels.launch_counts()
                    counts.append({k: after[k] - before[k] for k in after})
                    metrics.append(m)
                    check(math.isfinite(loss), f"{label} round {r + 1}: loss {loss}")
                    print(f"{label} round {r + 1}: loss {loss:.6f}  step {step_ms[-1]:.3f} ms"
                          f"  launches { {k: v for k, v in counts[-1].items() if v} }  upload "
                          f"bits measured {float(m['measured_bits_per_client']):.0f}, Eq. 1 "
                          f"{float(m['bits_per_client']):.2f} a client ({run.n_clients} "
                          f"clients)")
            launches = kernels.launch_counts()
        finally:
            del channel.round_exchange, channel.record_round
        check(all(c == want for c in counts), f"{label}: launches per round {counts}, "
                                              f"not {want}")
        # every client's residual is acc - dW* bit for bit (the flat path's
        # rows unflattened to the tree)
        ex, res = last["ex"], last["residual"]
        if tree_flatten(res)[0]:
            new_res = ex.state.residual
            if fast:
                space = run.trainer.resolved(state.params).flat_space(state.params)
                res, new_res = space.unflatten(res), space.unflatten(new_res)
            for old, delta, sent, new in zip(*(tree_flatten(x)[0] for x in (
                    res, last["deltas"], ex.transmitted, new_res))):
                check(bit_equal(new, (old + delta) - sent),
                      f"{label}: the last round's residual != acc - dW* bit for bit")
            print(f"{label}: last round's residual == acc - dW* bit for bit, every client")
        # every f32_mean_xla call of the rounds, of the path's own shapes,
        # against the plain cascade on its own operands (these launches come
        # after the counts were read)
        seen = {tuple(args[0].shape) for _, args, _ in means}
        shapes = path_mean_shapes(spec.get("compressor", "sbc"), state.params,
                                  spec["sparsity"], fast, run.n_clients)
        check(seen == shapes, f"{label}: f32_mean_xla shapes {sorted(seen)}, the path's "
                              f"{sorted(shapes)}")
        for _, args, kwargs in means:
            check(bit_equal(kreduce.f32_mean_xla(*args, **kwargs),
                            kreduce.f32_mean_xla_plain(*args, **kwargs)),
                  f"{label}: f32_mean_xla on {tuple(args[0].shape)}: kernel != plain cascade")
        print(f"{label}: all {len(means)} f32_mean_xla calls bit-equal to the plain cascade "
              f"on their operands, {len(seen)} shapes, the path's own: "
              f"{sorted(seen) if len(seen) <= 30 else sorted(seen)[:30] + ['...']}")
        # each ledger row: C x client 0's packed bits and C x Eq. 1
        C = run.n_clients
        for r, (rec, m, up) in enumerate(zip(run.ledger.records, metrics, uploads)):
            packed = float(channel.wire(up["params"], up["rate"], r).measured_bits(
                up["compressed0"]))
            check(float(m["measured_bits_per_client"]) == packed
                  and rec.up_bits_measured == packed * C
                  and rec.up_bits_analytic == float(m["bits_per_client"]) * C,
                  f"{label} round {r + 1}: the ledger's row ({rec.up_bits_measured}, "
                  f"{rec.up_bits_analytic}) != C x (packed {packed}, Eq. 1 "
                  f"{float(m['bits_per_client'])})")
        print(f"{label}: the ledger's {rounds} rows are C x client 0's packed and Eq. 1 bits")
        if profile:
            profiled_round(run, state, label)
        for key, value in (("launches", launches), ("metrics", metrics), ("step_ms", step_ms),
                           ("states", state), ("runs", run), ("upload", uploads[rounds - 1])):
            out[key][fast] = value

    if len(per_round) == 2:
        runs, slow, quick = out["runs"], out["states"][False], out["states"][True]
        space = runs[True].trainer.resolved(quick.params).flat_space(quick.params)
        # Adam's (m, v) as a plain pair: the tree walk takes a NamedTuple for a leaf
        opt = [tuple(s.opt_states) if isinstance(s.opt_states, AdamState) else s.opt_states
               for s in (quick, slow)]
        for what, a, b in (("params", quick.params, slow.params),
                           ("residual", space.unflatten(quick.comp_state.residual),
                            slow.comp_state.residual),
                           ("optimizer state", *opt)):
            fa, fb = tree_flatten(a)[0], tree_flatten(b)[0]
            check(len(fa) == len(fb) and all(bit_equal(x, y) for x, y in zip(fa, fb)),
                  f"{name}: the {what} differs between the flat and the per-leaf path")
        check(runs[True].ledger.history() == runs[False].ledger.history(),
              f"{name}: the two paths' ledger rows differ")
        runs[True].ledger.reconcile(rel=0.25)
        print(f"{name}: after {rounds} rounds{' (and one profiled)' if profile else ''} the "
              f"flat and the per-leaf path give bit-identical params, residuals, optimizer "
              f"states and ledger rows")
    return out


def leaf_mean_shapes(compressor: str, n: int, k: int) -> tuple:
    """The ``(rows, n)`` of each ``f32_mean_xla`` call that one client's
    leaf of ``n`` values (``k`` kept) makes a round on the per-leaf path,
    counted from core/stages.py: SBC's top-k means (both sides in one
    call) and its binarize; sign's mean |v|; two_means' two sides; the
    stochastic quantizer's norm; the variance selector's block RMS (blocks
    of 256); none for dense, top-k, ternary and random-k."""
    b = min(256, n)
    return {"sbc": ((2, k), (1, k)), "signsgd": ((1, n),), "onebit": ((2, n),),
            "qsgd": ((1, n),), "variance": ((-(-n // b), b),)}.get(compressor, ())


def path_mean_shapes(compressor: str, params, p: float, fast: bool, clients: int) -> set:
    """The ``(rows, n)`` of the ``f32_mean_xla`` calls a local round makes:
    :func:`leaf_mean_shapes` of every leaf, or on the flat path (SBC) one
    call of both sides of every client, ``(2 C, k)``, a segment."""
    from repro_torch.core.stages import k_for
    from repro_torch.core.tree import tree_flatten

    sizes = [v.numel() for v in tree_flatten(params)[0]]
    if fast:
        return {(2 * clients, k_for(n, p)) for n in sizes}
    return {s for n in sizes for s in leaf_mean_shapes(compressor, n, k_for(n, p))}


# ------------------------------------------------------------ CharLSTM


def charlstm_phase(dev) -> dict:
    """Phase 7: the paper's second preset, CharLSTM at full width (2 x
    200, vocab 98, 680,800 parameters in 8 leaves), on every run path:
    the local backend per leaf and flat (:func:`local_path`: 4 clients,
    64 and 8 ``f32_mean_xla`` a round), the GSPMD hist engine (2
    ``seg_hist2side``, 1 ``seg_moments``, 1 ``seg_binarize_apply`` a
    round over 8 segments) and the GSPMD exact engine with the
    device-packed wire (1 ``seg_packbits``, 8 ``f32_mean_xla``), five
    rounds each with the same checks as LeNet5's, and the hist kernels
    held against their plain versions on the path's operands.  Then the
    local flat path once more with telemetry on.  Returns every path's
    launches of its five rounds."""
    from repro_torch.run import RunSpec, build_run

    local = local_path(dev, CHARLSTM_LOCAL, CHARLSTM_LOCAL_PER_ROUND, "charlstm local")
    out = {"local_per_leaf": local["launches"][False], "local_flat": local["launches"][True]}

    run = build_run(RunSpec(**CHARLSTM_GSPMD, flat_engine="hist"), device=dev)
    space = run.fns.flat_space
    n_params = sum(s.global_size for s in space.segments)
    print(f"charlstm: {n_params} params in {len(space.segments)} segments "
          f"{[(s.path, s.global_size, s.k) for s in space.segments]}, n_pad {space.n_pad}; "
          f"bits_per_client {run.fns.bits_per_client:.2f}")
    check(n_params == 680_800 and len(space.segments) == CHARLSTM_LEAVES, "CharLSTM layout")
    cap = drive(run, "exchange_local_hist", HIST_PER_ROUND, "charlstm hist")
    one_mu_per_segment(space, cap, "charlstm hist")
    profiled_round(run, cap["state"], "charlstm hist")
    hist_kernels_vs_plain(cap["acc"], space, dev, "charlstm hist")
    out["hist"] = cap["launches"]

    run = build_run(RunSpec(**CHARLSTM_GSPMD, flat_engine="exact", device_pack=True,
                            measure_wire=True), device=dev)
    cap = drive(run, "exchange_local", CHARLSTM_EXACT_PER_ROUND, "charlstm exact")
    exact_wire_checks(run, cap, dev, "charlstm exact")
    exact_means_vs_plain(run.fns.flat_space, cap["last"], "charlstm exact")
    profiled_round(run, cap["state"], "charlstm exact")
    out["exact"] = cap["launches"]

    telemetry_check(dev, local)
    return out


def telemetry_check(dev, local: dict) -> None:
    """The CharLSTM local flat run once more with telemetry on, its files
    written into a temporary directory: 5 ``round``, ``exchange`` and
    ``encode`` spans, no error from the port's validators, the
    ``repro-obs-v1`` header, and the same params as the run without
    telemetry, bit for bit (the same seed and data).  Prints the step ms
    with telemetry on beside the run without it; no gate on the
    difference."""
    import tempfile

    import torch
    from repro_torch import obs
    from repro_torch.core.tree import tree_flatten
    from repro_torch.obs.export import read_metrics_jsonl, read_trace_json
    from repro_torch.run import RunSpec, build_run

    run = build_run(RunSpec(**CHARLSTM_LOCAL, fast=True, telemetry=True), device=dev)
    check(run.telemetry.enabled and run.channel.telemetry is run.telemetry,
          "telemetry: the run and its channel do not share one enabled handle")
    state, hist = run.run()
    torch.cuda.synchronize()
    events = run.telemetry.tracer.events
    names = [e["name"] for e in events]
    counts = {n: names.count(n) for n in ("round", "exchange", "encode")}
    check(counts == {"round": ROUNDS, "exchange": ROUNDS, "encode": ROUNDS},
          f"telemetry: spans {counts}")
    errs = obs.validate_span_events(events) + obs.validate_metric_events(
        run.telemetry.metrics.events())
    check(not errs, f"telemetry: validators: {errs[:3]}")
    with tempfile.TemporaryDirectory() as tmp:
        with contextlib.redirect_stdout(io.StringIO()):
            paths = obs.finish_run(run.telemetry, trace=f"{tmp}/trace.json",
                                   metrics_out=f"{tmp}/metrics.jsonl",
                                   meta={"backend": "local", "preset": "charlstm",
                                         "rounds": ROUNDS})
        header, metric_events = read_metrics_jsonl(paths["metrics"])
        trace_events = read_trace_json(paths["trace"])
    check(header["schema"] == "repro-obs-v1" and len(metric_events) == len(
        run.telemetry.metrics.samples) and len(trace_events) == len(events),
          f"telemetry: files {header}, {len(metric_events)} metrics, {len(trace_events)} "
          f"trace events")
    off = tree_flatten(local["states"][True].params)[0]
    check(all(bit_equal(a, b) for a, b in zip(tree_flatten(state.params)[0], off)),
          "telemetry: params differ from the run without telemetry")
    on_ms = [s["value"] for s in run.telemetry.metrics.series("train/step_ms")]
    print(f"telemetry: {counts} spans, {len(metric_events)} metric events, validators "
          f"clean, repro-obs-v1 header; params bit-identical to the run without it")
    print(f"telemetry: step ms rounds 2-{ROUNDS} on {', '.join(f'{t:.3f}' for t in on_ms[1:])}"
          f"; off {', '.join(f'{t:.3f}' for t in local['step_ms'][True][1:])}")


# ----------------------------------------------------- clients across ranks


# the multi-rank phase: two ranks (one client each) on the one card, over
# gloo (NCCL refuses two ranks on one card); per rank and round: the path's
# launches of one client, plus the loss mean
MULTI_WORLD = 2
LEAF_PER_ROUND = per_call(f32_mean_xla=4 + 1)  # one a SBC leaf: c1, c2, f1, f2
MULTI_PATHS = (
    ("lenet5 hist", dict(SPEC, flat_engine="hist"), HIST_PER_ROUND),
    ("lenet5 exact", dict(SPEC, flat_engine="exact", device_pack=True, measure_wire=True),
     EXACT_PER_ROUND),
    ("lenet5 per-leaf", dict(SPEC, fast=False, flat_engine="exact", measure_wire=True,
                             dense_pattern=DENSE_PATTERN), LEAF_PER_ROUND),
    ("charlstm exact", dict(CHARLSTM_GSPMD, flat_engine="exact", device_pack=True,
                            measure_wire=True), CHARLSTM_EXACT_PER_ROUND),
)
MULTI_TIMEOUT_S = 420


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms for the block: without them the
    card's convolution weight gradients may change bits from run to run
    (ROADMAP C), and two runs could not be compared bit for bit."""
    import torch

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def five_rounds(run) -> tuple:
    """``(state, losses)`` of ROUNDS rounds of ``run`` from its seed."""
    import torch

    state, losses = run.init(), []
    for r in range(ROUNDS):
        state, m = run.step(state, r)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    return state, losses


def flat_bits(tree):
    """Every leaf of ``tree`` (Adam's ``(m, v)`` opened), as int32 bits, in
    one vector."""
    import torch
    from repro_torch.core.tree import tree_flatten

    if hasattr(tree, "_fields"):
        return torch.cat([flat_bits(part) for part in tree])
    return torch.cat([v.detach().reshape(-1).view(torch.int32)
                      for v in tree_flatten(tree)[0]])


def nccl_world_one(dev) -> None:
    """Phase 8a: a real NCCL process group of one rank.  Its collectives
    return their input bit for bit, and five LeNet5 rounds of the hist
    engine and of the exact engine with the device pack and the ledger
    through the group equal the same rounds without a group (params,
    residual, optimizer state, losses, ledger rows), both under
    deterministic cuDNN."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch.launch.mesh import ClientGroup
    from repro_torch.run import RunSpec, build_run

    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal(1000).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.integers(0, 2 ** 32, 77, dtype=np.uint64).astype(np.uint32)
                         .view(np.int32)).to(dev).view(torch.uint32)
    with tempfile.TemporaryDirectory() as tmp:
        group = ClientGroup.connect(rank=0, world=1, device=dev, backend="nccl",
                                    init_method=f"file://{tmp}/store")
        try:
            rows, words, mean = group.all_gather_rows(x), group.all_gather_rows(w), group.pmean(x)
            torch.cuda.synchronize()
            check(tuple(rows.shape) == (1, 1000) and bit_equal(rows[0], x)
                  and words.dtype == torch.uint32 and bit_equal(words[0], w)
                  and bit_equal(mean, x), "NCCL world 1: the collectives change their input")
            print(f"nccl world 1: all_gather_rows (f32, uint32 words) and pmean return their "
                  f"input bit for bit (backend {group.backend})")
            with deterministic_cudnn():
                for engine, extra in (("hist", {}), ("exact", dict(device_pack=True,
                                                                   measure_wire=True))):
                    spec = RunSpec(**SPEC, flat_engine=engine, **extra)
                    alone = build_run(spec, device=dev)
                    grouped = build_run(spec, group=group)
                    check(grouped.group is group and grouped.n_clients == 1,
                          "nccl world 1: the run did not take the group")
                    (s0, l0), (s1, l1) = five_rounds(alone), five_rounds(grouped)
                    for key in ("params", "opt", "residual"):
                        check(torch.equal(flat_bits(s0[key]), flat_bits(s1[key])),
                              f"nccl world 1 {engine}: {key} differ from the no-group run")
                    check(l0 == l1 and alone.ledger.history() == grouped.ledger.history(),
                          f"nccl world 1 {engine}: losses or ledger rows differ")
                    print(f"nccl world 1 {engine}: {ROUNDS} rounds through the group == without "
                          f"it, bit for bit (params, opt, residual, losses {l1[-1]:.6f}, "
                          f"{len(grouped.ledger.records)} ledger rows)")
        finally:
            group.close()


def spawn_ranks(flag: str, world: int, timeout_s: float, label: str) -> tuple:
    """``world`` processes of this script (``flag RANK WORLD STORE OUT``) on
    the one card, meeting at a ``file://`` store; waits for all of them
    within ``timeout_s`` (killing the rest when one fails) and returns
    their logs and their JSON results, one a rank."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), flag, str(r),
             str(world), f"{tmp}/store", f"{tmp}/rank{r}.json"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        deadline = time.monotonic() + timeout_s
        failed = None
        try:
            while failed is None and any(p.poll() is None for p in procs):
                failed = next((p for p in procs if p.poll() not in (None, 0)), None)
                check(time.monotonic() < deadline,
                      f"{label}: the ranks outlived {timeout_s} s")
                time.sleep(0.2)
            failed = failed or next((p for p in procs if p.returncode != 0), None)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        logs = [p.stdout.read() for p in procs]
        for p in procs:
            p.stdout.close()
        if failed is not None:
            raise SmokeFailure(f"{label}: rank {procs.index(failed)} exited "
                               f"{failed.returncode}:\n{logs[procs.index(failed)][-3000:]}")
        results = [json.loads(Path(f"{tmp}/rank{r}.json").read_text()) for r in range(world)]
    print(logs[0].rstrip())
    print("\n".join(f"[rank {r}] {line}" for r in range(1, world)
                    for line in logs[r].splitlines() if "round" in line and "loss" in line))
    return logs, results


def multi_rank_phase(dev) -> dict:
    """Phase 8b: MULTI_WORLD ranks on the one card (one process a rank, a
    client each, over gloo), every path of ``MULTI_PATHS``; each rank's
    checks are in :func:`multi_rank_path`.  Prints rank 0's report and
    returns its launch counts of every path."""
    _, results = spawn_ranks("--rank-worker", MULTI_WORLD, MULTI_TIMEOUT_S, "multi-rank")
    for label, _, per_round in MULTI_PATHS:
        for r, res in enumerate(results):
            check(res[label]["launches"] == {k: ROUNDS * v for k, v in per_round.items()},
                  f"multi-rank {label} rank {r}: launches {res[label]['launches']}")
    return {label: results[0][label]["launches"] for label, _, _ in MULTI_PATHS}


def rank_worker(rank: int, world: int, store: str, out: str) -> int:
    """One rank of phase 8b (``--rank-worker``): one client on the card,
    every path of ``MULTI_PATHS`` through ``build_run``; writes its
    results as JSON to ``out``."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import ClientGroup

    dev = torch.device("cuda", 0)
    group = ClientGroup.connect(rank=rank, world=world, device=dev, backend="gloo",
                                init_method=f"file://{store}")
    print(f"multi-rank: rank {rank} of {world} on {torch.cuda.get_device_name(dev)}, "
          f"transport {group.backend} (CUDA tensors into gloo's all_gather; NCCL refuses "
          f"two ranks on one card); compute on the card")
    results = {}
    try:
        for label, spec, per_round in MULTI_PATHS:
            results[label] = multi_rank_path(group, label, spec, per_round)
    finally:
        group.close()
    Path(out).write_text(json.dumps(results))
    return 0


def kernels_vs_plain_calls(calls: list, label: str) -> dict:
    """Each recorded kernel call of a round against its plain version on
    its own operands: bit-equal, but ``seg_moments``' sums, which are held
    to ``rtol=1e-6`` with equal counts, as phase 2 holds them.  Returns
    ``{kernel: calls compared}``."""
    import torch
    from repro_torch.kernels import flat as kflat
    from repro_torch.kernels import pack as kpack
    from repro_torch.kernels import reduce as kreduce

    pairs = {"seg_hist2side": (kflat.seg_hist2side, kflat.seg_hist2side_plain),
             "seg_moments": (kflat.seg_moments, kflat.seg_moments_plain),
             "seg_binarize_apply": (kflat.seg_binarize_apply, kflat.seg_binarize_apply_plain),
             # the block size (bm, lanes) is the kernel's grid alone
             "seg_accumulate": (kflat.seg_accumulate,
                                lambda *a, **_: kflat.seg_accumulate_plain(*a)),
             "pack_bit_rows": (kpack.seg_packbits_stream, kpack.seg_packbits_stream_plain),
             "f32_mean_xla": (kreduce.f32_mean_xla, kreduce.f32_mean_xla_plain)}
    seen: dict = {}
    moments_bitwise = True
    for name, args, kwargs in calls:
        kernel, plain = pairs[name]
        got, want = kernel(*args, **kwargs), plain(*args, **kwargs)
        torch.cuda.synchronize()
        if name == "seg_moments":
            check(torch.equal(got[:, :, 1], want[:, :, 1])
                  and torch.allclose(got[:, :, 0], want[:, :, 0], rtol=1e-6, atol=0),
                  f"{label} seg_moments: counts differ or sums beyond rtol 1e-6")
            moments_bitwise &= bit_equal(got, want)
        else:
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            check(all(bit_equal(g, w) for g, w in zip(got, want)),
                  f"{label} {name}: kernel != plain version on its operands")
        seen[name] = seen.get(name, 0) + 1
    note = "" if "seg_moments" not in seen else (
        f"; seg_moments {'bit-equal' if moments_bitwise else 'sums within rtol 1e-6'}")
    print(f"{label}: every kernel call of the last round == its plain version on its own "
          f"operands {seen}{note}")
    return seen


def multi_rank_path(group, label: str, spec: dict, per_round: dict, run=None,
                    rounds: int = ROUNDS, keep: dict | None = None) -> dict:
    """``rounds`` rounds of one path on this rank (``build_run`` of
    ``spec``, or ``run``), the launch counts set to 0 just before and read
    just after; then: every round's launches are ``per_round``; the params
    are the same on every rank bit for bit; the last round's mean equals
    the one recomputed from every client's gathered ΔW* bit for bit (μ / C
    added in client order; dense and hist leaves: the pmean); each kernel
    call of the last round equals its plain version; one profiled round;
    the device pack's gathered words decoded (``golomb_decode_rows``),
    timed.  ``keep`` receives the last round's exchange outputs
    (``"out"``)."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import flat as core_flat
    from repro_torch.core.tree import tree_flatten
    from repro_torch.kernels import reduce as kreduce
    from repro_torch.kernels import topk as ktopk
    from repro_torch.launch import dist as ldist
    from repro_torch.run import RunSpec, build_run

    tag = f"{label} [rank {group.rank}]"
    run = run or build_run(RunSpec(**spec), group=group)
    ch = run.channel
    # the ranks the exchange crosses: every rank, or with one rank a
    # device the ranks of this device coordinate (one a client)
    xg = run.fns.ranks.exchange if run.fns.ranks is not None else group
    check(run.n_clients == xg.world and ch.n_clients == xg.world,
          f"{tag}: {run.n_clients} clients, not the exchange group's {xg.world}")
    last: dict = {}
    exchange = ch.round_exchange

    def observed(residual, deltas, *, need_own):
        last["out"] = exchange(residual, deltas, need_own=need_own)
        return last["out"]

    ch.round_exchange = observed
    calls: list = []
    flat_names = ("seg_hist2side", "seg_moments", "seg_binarize_apply", "seg_accumulate",
                  "pack_bit_rows")
    try:
        state = run.init()
        torch.cuda.synchronize()
        kernels.reset_launches()
        counts, step_ms, losses = [], [], []
        for r in range(rounds):
            before = kernels.launch_counts()
            with contextlib.ExitStack() as stack:
                if r == rounds - 1:
                    for module, names in ((core_flat, flat_names), (ktopk, ("f32_mean_xla",)),
                                          (ldist, ("f32_mean_xla",))):
                        stack.enter_context(swapped(module, recording(module, names, calls)))
                t0 = time.perf_counter()
                state, m = run.step(state, r)
                losses.append(float(m["loss"]))
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
            after = kernels.launch_counts()
            counts.append({k: after[k] - before[k] for k in after})
            print(f"{tag} round {r + 1}: loss {losses[-1]:.6f}  step {step_ms[-1]:.3f} ms  "
                  f"launches {counts[-1]}")
        launches = kernels.launch_counts()
    finally:
        del ch.round_exchange
    check(all(math.isfinite(x) for x in losses), f"{tag}: non-finite loss {losses}")
    check(all(c == per_round for c in counts), f"{tag}: launches per round {counts}")
    if keep is not None:
        keep.update(last)

    # the same params on every client's rank (of this device), bit for bit
    rows = xg.all_gather_rows(flat_bits(state["params"]))
    check(all(torch.equal(rows[0], row) for row in rows[1:]),
          f"{tag}: params differ across ranks")
    # the mean recomputed from every client's ΔW*
    mean_tree, _, own_tree = last["out"][:3]
    inv = kreduce._reciprocal(xg.world, group.device)
    engine = ch.flat_engine if ch.flat_space is not None else "per-leaf"
    for gl, mean, own in zip(ch.leaves, tree_flatten(mean_tree)[0], tree_flatten(own_tree)[0]):
        owns = xg.all_gather_rows(own[0].to(torch.float32))
        if gl.mode == "skip":
            want = torch.zeros_like(owns[0])
        elif gl.mode == "dense" or engine == "hist":  # the pmean
            want = owns[0]
            for o in owns[1:]:
                want = want + o
            want = want * inv
        else:  # μ / C of each client added in client order
            want = torch.zeros_like(owns[0])
            for o in owns:
                want = want + o * inv
        check(bit_equal(mean[0].to(torch.float32), want),
              f"{tag} {gl.path}: the mean != the one recomputed from the gathered dW*")
    print(f"{tag}: params identical on all {xg.world} clients' ranks; the mean == the one "
          f"recomputed from the gathered dW* ({engine}), bit for bit")
    compared = kernels_vs_plain_calls(calls, tag)
    ops = profiled_round(run, state, tag)

    decode_us = decode_host_ms = None
    if ch.device_pack:
        space = ch.flat_space
        words = last["out"][3][0][0]  # (devices a client, n_pack_words)
        gw = xg.all_gather_rows(words)
        gpos = space._decode_gathered(gw)
        own_all = xg.all_gather_rows(
            space.flatten_local([o[0] for o in tree_flatten(own_tree)[0]])
        ).reshape(xg.world, -1)
        sel = torch.zeros_like(own_all, dtype=torch.bool)
        sel.scatter_(1, gpos, True)
        sparse = torch.zeros(space.n_pad, dtype=torch.bool, device=group.device)
        for s in space._sparse:
            sparse[s.offset:s.offset + s.rows * s.n_loc] = True
        check(torch.equal(sel, (own_all != 0) & sparse.repeat(space.shards_per_client)),
              f"{tag}: decoded positions != every client's survivors")
        copies = [(gw.clone(),) for _ in range(20)]
        counted: list = []
        decode_us = 1e3 * device_ms(space._decode_gathered, copies, 40, counted=counted)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            space._decode_gathered(gw)
        torch.cuda.synchronize()
        decode_host_ms = (time.perf_counter() - t0) * 1e3 / 20
        print(f"{tag}: golomb_decode_rows on the gathered words u32{tuple(gw.shape)} "
              f"({len(space._sparse)} segments, {gpos.shape[1]} positions a client): "
              f"{decode_us:.2f} us device in {counted[0]:g} device operations, "
              f"{decode_host_ms:.3f} ms host clock per exchange; positions == every "
              f"client's survivors")
    return {"launches": launches, "step_ms": step_ms, "losses": losses, "device_ops": ops,
            "compared": compared, "decode_us": decode_us, "decode_host_ms": decode_host_ms}


# ------------------------------------------------------------ federation


# phase 9: the fed backend on the card.  LeNet5 at full width, 8 clients,
# cohorts of 4 in two profiles (delay 1 and 2, p = 0.01), one member a
# tile; f32_mean_xla a round: one a segment a tile on the flat path (4
# tiles x 6), two per SBC leaf and member per leaf (4 x 12); the dense
# downstream launches none, the 5% downstream one a segment (6)
FED = dict(preset="lenet5", backend="fed", clients=8, cohort=4, batch=128, sparsity=0.01,
           profiles=((1, 0.01, 1.0), (2, 0.01, 1.0)), cohort_tile=1, rounds=ROUNDS)
FED_PER_ROUND = {True: per_call(f32_mean_xla=4 * 6), False: per_call(f32_mean_xla=4 * 2 * 6)}
FED_DOWN = dict(FED, fast=True, down_sparsity=0.05)
FED_DOWN_PER_ROUND = per_call(f32_mean_xla=4 * 6 + 6)
# CharLSTM: 4 clients, cohorts of 2 in one profile, one tile: 8 a round
FED_CHARLSTM = dict(CHARLSTM, backend="fed", clients=4, cohort=2, fast=True, rounds=3)
FED_CHARLSTM_PER_ROUND = per_call(f32_mean_xla=CHARLSTM_LEAVES)
FED_KILL_ROUND = 3


def fed_drive(dev, spec: dict, per_round: dict, label: str, rounds: int = ROUNDS,
              run=None, before_round=None) -> dict:
    """``rounds`` rounds of the fed backend (``spec`` through ``build_run``,
    or the given ``run`` already initialized), with the launch counts set
    to 0 just before and read just after; ``before_round(r, sched)`` runs
    before each round, outside its timer.  Per round: the loss, step ms,
    launches, the server's decode ms (the Golomb host decoder of every
    upload) and its receive ms; every loss finite; with the dense
    downstream Ŵ == W after each round.  Every ``f32_mean_xla`` call of the
    rounds is held bit for bit against the plain cascade on its own
    operands, and every accepted upload decodes on the server to the
    member's ΔW* as the pool computed it on the card.  Returns the run, its
    scheduler, the launches, step ms, decode ms and the uploads."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import stages as core_stages
    from repro_torch.core import wire as core_wire
    from repro_torch.core.tree import tree_flatten
    from repro_torch.fed import clients as fed_clients
    from repro_torch.kernels import reduce as kreduce
    from repro_torch.kernels import topk as ktopk
    from repro_torch.run import RunSpec, build_run

    if run is None:
        run = build_run(RunSpec(**spec), device=dev)
        run.init()
    sched = run.scheduler
    means: list = []  # every f32_mean_xla call of the rounds
    tiles: list = []  # (round, member ids) of every tile, as the pool runs them
    dense_rows: list = []  # every tile's ΔW* rows, as the pool computed them
    decode_s: list = []
    uploads: list = []
    compress = fed_clients.compress_clients
    unpack = core_wire.Wire.unpack_compressed
    local = sched.pool._local

    def observed_local(round_idx, group_ids, *a, **kw):
        tiles.append((round_idx, [int(c) for c in group_ids]))
        return local(round_idx, group_ids, *a, **kw)

    def observed_compress(resolved, deltas, state, rates):
        out = compress(resolved, deltas, state, rates)
        dense_rows.append(tree_flatten(out[1])[0])
        return out

    def timed_unpack(self, data):
        t0 = time.perf_counter()
        try:
            return unpack(self, data)
        finally:
            decode_s.append(time.perf_counter() - t0)

    receive = sched.server.receive
    receive_ms: list = []

    def observed_receive(ups, round_idx):
        uploads.append((round_idx, list(ups)))
        t0 = time.perf_counter()
        info = receive(ups, round_idx)
        receive_ms.append((time.perf_counter() - t0) * 1e3)
        return info

    sched.server.receive = observed_receive
    sched.pool._local = observed_local
    torch.cuda.synchronize()
    kernels.reset_launches()
    counts, step_ms, decode_ms, ms_list = [], [], [], []
    try:
        with swapped(ktopk, recording(ktopk, ("f32_mean_xla",), means)), \
                swapped(core_stages, recording(core_stages, ("f32_mean_xla",), means)), \
                swapped(fed_clients, {"compress_clients": observed_compress}), \
                swapped(core_wire.Wire, {"unpack_compressed": timed_unpack}):
            for r in range(rounds):
                if before_round is not None:
                    before_round(r, sched)
                before, n_dec = kernels.launch_counts(), len(decode_s)
                t0 = time.perf_counter()
                m = sched.step(r)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                after = kernels.launch_counts()
                counts.append({k: after[k] - before[k] for k in after})
                decode_ms.append(1e3 * sum(decode_s[n_dec:]))
                check(math.isfinite(m["loss"]), f"{label} round {r + 1}: loss {m['loss']}")
                if sched.server.down_sparsity >= 1:
                    check(all(bit_equal(w, e) for w, e in zip(
                        tree_flatten(sched.server.params)[0],
                        tree_flatten(sched.server.estimate)[0])),
                          f"{label} round {r + 1}: dense downstream, but the replica != W")
                print(f"{label} round {r + 1}: loss {m['loss']:.6f}  step {step_ms[-1]:.3f} ms  "
                      f"launches { {k: v for k, v in counts[-1].items() if v} }  server decode "
                      f"{decode_ms[-1]:.3f} ms, receive {receive_ms[-1]:.3f} ms  accepted "
                      f"{m['accepted']}  staleness {m['staleness']}")
                ms_list.append(m)
        launches = kernels.launch_counts()
    finally:
        sched.server.receive = receive
        del sched.pool._local
    check(all(c == per_round for c in counts), f"{label}: launches per round {counts}")
    shapes = sorted({tuple(args[0].shape) for _, args, _ in means})
    for _, args, kwargs in means:
        check(bit_equal(kreduce.f32_mean_xla(*args, **kwargs),
                        kreduce.f32_mean_xla_plain(*args, **kwargs)),
              f"{label}: f32_mean_xla on {tuple(args[0].shape)}: kernel != plain cascade")
    print(f"{label}: all {len(means)} f32_mean_xla calls of the {rounds} rounds bit-equal to "
          f"the plain cascade on their operands, shapes {shapes}")
    # every accepted upload decodes to the member's ΔW* as computed on the card
    check(len(tiles) == len(dense_rows), f"{label}: {len(tiles)} tiles, {len(dense_rows)} "
          f"compressions")
    row_of = {}
    for (r, ids), rows in zip(tiles, dense_rows):
        for j, cid in enumerate(ids):
            row_of.setdefault((r, cid), [leaf[j] for leaf in rows])
    checked = 0
    for r, ups in uploads:
        for u in ups:
            wire = sched.server.up_wire(u.rate, r)
            try:
                got = tree_flatten(wire.dense_of(wire.unpack_compressed(u.blob)))[0]
            except ValueError:
                continue  # a corrupt upload, rejected
            want = row_of[(r, int(u.client_id))]
            check(all(bit_equal(g, w.cpu()) for g, w in zip(got, want)),
                  f"{label} round {r + 1}: client {u.client_id}'s upload does not decode to "
                  f"its ΔW*")
            checked += 1
    print(f"{label}: {checked} accepted uploads decode on the server to the members' ΔW* "
          f"bit for bit")
    return {"run": run, "sched": sched, "launches": launches, "step_ms": step_ms,
            "decode_ms": decode_ms, "metrics": ms_list, "uploads": uploads,
            "state": fed_state(sched), "history": sched.ledger.history()}


def fed_profiled_round(sched, r: int, label: str) -> int:
    """One more round under the profiler: its device operations, busy ms and
    busy share of the step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sched.step(r)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    events = sorted(prof.key_averages(), key=_self_device_us, reverse=True)
    busy_ms = sum(_self_device_us(e) for e in events) / 1e3
    check(busy_ms > 0, f"{label}: torch.profiler saw no device time in the profiled round")
    on_device = sum(e.count for e in events if _self_device_us(e) > 0)
    print(f"{label} profiled round {r + 1}: step {step_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / step_ms:.1f}% of the step), {on_device} device operations; "
          f"top by device time:")
    for e in events[:8]:
        print(f"  {_self_device_us(e) / 1e3:9.4f} ms  x{e.count:<4d} {e.key[:100]}")
    return on_device


def fed_state(sched) -> list:
    """The server's params and the pool's rows as one flat list of tensors
    (the flat residual unflattened to the tree, so both paths compare)."""
    import torch
    from repro_torch.core.tree import tree_flatten

    st = sched.pool.export_state()
    res = st["residual"]
    space = sched.pool._resolved.flat_space(sched.server.params) \
        if sched.pool.policy.fast else None
    if space is not None:
        res = space.unflatten(torch.from_numpy(res), cast=False)
    return (tree_flatten(sched.server.params)[0]
            + [torch.as_tensor(x) for x in tree_flatten(res)[0]]
            + [torch.as_tensor(x) for x in tree_flatten(
                tuple(st["opt"]) if isinstance(st["opt"], tuple) else st["opt"])[0]])


def fed_phase(dev) -> tuple:
    """Phase 9: the fed backend on the card (ROADMAP A8).  Returns each
    path's f32_mean_xla launches, and 9b's per-round losses and trained
    state (``fed_state``) after its rounds."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch.core.tree import tree_flatten
    from repro_torch.fed import ServerKilled, restore_fed_state
    from repro_torch.run import RunSpec, build_run

    launches, paths = {}, {}
    # 9a. LeNet5, flat and per leaf, then the flat path on the host store
    for fast in (True, False):
        label = f"fed lenet5 ({'flat' if fast else 'per-leaf'})"
        paths[fast] = fed_drive(dev, dict(FED, fast=fast), FED_PER_ROUND[fast], label)
        paths[fast]["sched"].ledger.reconcile(rel=0.1)
        launches[label] = paths[fast]["launches"]["f32_mean_xla"]
        fed_profiled_round(paths[fast]["sched"], ROUNDS, label)
    paths["host"] = fed_drive(dev, dict(FED, fast=True, client_store="host"),
                              FED_PER_ROUND[True], "fed lenet5 (flat, host store)")
    # the states after the five rounds (before the profiled one)
    for other, what in ((False, "per-leaf path"), ("host", "host store")):
        a, b = paths[True]["state"], paths[other]["state"]
        check(len(a) == len(b) and all(bit_equal(x.cpu(), y.cpu()) for x, y in zip(a, b))
              and paths[True]["history"] == paths[other]["history"],
              f"fed lenet5: the {what}'s params, client rows or ledger rows differ from the "
              f"flat path's")
    print(f"fed lenet5: after {ROUNDS} rounds (and one profiled) the flat and the per-leaf "
          f"path, and the host store, give bit-identical params, client rows and ledger rows")

    # 9b. the 5% downstream: the broadcast compresses on the card; the
    # replica advances by exactly the broadcast's decoded bytes
    label = "fed lenet5 (flat, 5% downstream)"
    run = build_run(RunSpec(**FED_DOWN), device=dev)
    server = run.init().server
    broadcast, sent = server.broadcast, []

    def observed_broadcast(round_idx):
        before = server.estimate
        bc = broadcast(round_idx)
        sent.append((round_idx, before, server.estimate, bc.blob))
        return bc

    server.broadcast = observed_broadcast
    down = fed_drive(dev, None, FED_DOWN_PER_ROUND, label, run=run)
    del server.broadcast
    # decoded after the rounds, so the rounds' decode ms are the server's own
    for r, before, after, blob in sent:
        wire = server.down_wire(r)
        got = tree_flatten(wire.dense_of(wire.unpack_compressed(blob)))[0]
        check(all(bit_equal(new, old + d.to(old.device)) for new, old, d in zip(
                  tree_flatten(after)[0], tree_flatten(before)[0], got)),
              f"{label} round {r + 1}: the replica did not advance by the broadcast's "
              f"decoded bytes")
    # W − Ŵ against the downstream residual: the reference's own rounding
    # ((W − Ŵ − r) + r is not W − Ŵ in f32) makes them differ by a few ulps
    worst = 0.0
    for w, e, res in zip(*(tree_flatten(x)[0] for x in (server.params, server.estimate,
                                                         server.down_residual))):
        ulp = 2.0 ** -23 * torch.maximum(w.abs(), e.abs()).clamp_min(1e-30)
        worst = max(worst, float(((w - e - res).abs() / ulp).max()))
    check(worst <= 64, f"{label}: W - replica is {worst:.1f} ulps of W off the residual")
    print(f"{label}: the replica advanced by exactly the decoded broadcast every round; "
          f"W - replica within {worst:.2f} ulps of |W| of the downstream residual")
    # no reconcile here: the gap broadcast at p = 0.05 holds fewer non-zero
    # entries than k in round 1, so its positions are no geometric draw
    t = down["sched"].ledger.totals()
    print(f"{label}: measured/analytic up x{t['up_bits_measured'] / t['up_bits_analytic']:.3f}, "
          f"down x{t['down_bits_measured'] / t['down_bits_analytic']:.3f}; down "
          f"{t['down_bytes'] / 1e3:.1f} kB against the dense path's "
          f"{sum(paths[True]['history']['down_bytes']) / 1e3:.1f} kB in {ROUNDS} rounds")
    launches[label] = down["launches"]["f32_mean_xla"]
    trained = {"losses": [m["loss"] for m in down["metrics"]], "state": down["state"]}
    fed_profiled_round(down["sched"], ROUNDS, label)

    # 9c. elasticity: a corrupt upload and a straggler in round 1, a kill
    # after round 3's aggregation; checkpoint, rebuild, restore, resume
    probe = build_run(RunSpec(**FED, fast=True), device=dev)
    cohort = [int(c) for c in probe.init().pool.sample_cohort(1, FED["cohort"])]
    corrupt, slow = cohort[0], cohort[1]
    faults = {"corrupt": [[1, corrupt]], "slow": [[1, slow, 5.0]]}
    spec = dict(FED, fast=True, straggler_timeout=2.5, rounds=ROUNDS)
    rows: dict = {}

    def rows_of(st, cid):
        return [np.asarray(x)[cid] for x in tree_flatten(
            (tuple(st["opt"]), st["residual"], st["rng"], st["step"]))[0]]

    def around_round_2(r, sched):
        if r in (1, 2):  # before and after the faults' round
            st = sched.pool.export_state()
            rows[r] = {cid: rows_of(st, cid) for cid in (corrupt, slow)}

    label = "fed lenet5 (flat, faults)"
    whole = fed_drive(dev, dict(spec, faults=json.dumps(faults)), FED_PER_ROUND[True],
                      label, before_round=around_round_2)
    ws = whole["sched"]
    m = whole["metrics"][1]
    check(m["rejected"] == [corrupt] and m["stragglers"] == [slow],
          f"fed faults round 2: rejected {m['rejected']}, stragglers {m['stragglers']}")
    for cid in (corrupt, slow):
        check(all(np.array_equal(a, b) for a, b in zip(rows[1][cid], rows[2][cid])),
              f"fed faults: client {cid}'s row moved in its failed round")
    killed = build_run(RunSpec(**spec, faults=json.dumps(
        {**faults, "kill_server": [[FED_KILL_ROUND, "post_aggregate"]]})), device=dev)
    ks = killed.init()
    try:
        for r in range(ROUNDS):
            ks.step(r)
        raise SmokeFailure("fed faults: the scheduled kill did not fire")
    except ServerKilled as e:
        check(e.round_idx == FED_KILL_ROUND, f"fed faults: killed at round {e.round_idx}")
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            killed.checkpoint(ks, f"{tmp}/fed.npz", rounds_done=e.round_idx)
            save_ms = (time.perf_counter() - t0) * 1e3
            fresh = build_run(RunSpec(**spec, faults=killed.spec.faults), device=dev)
            t0 = time.perf_counter()
            restore_fed_state(f"{tmp}/fed.npz", fresh.init())
            restore_ms = (time.perf_counter() - t0) * 1e3
        rs = fresh.scheduler
        check(rs.resume_pending() is not None, "fed faults: no pending round after restore")
        for r in range(e.round_idx + 1, ROUNDS):
            rs.step(r)
    check(all(bit_equal(x, y) for x, y in zip(tree_flatten(rs.server.params)[0],
                                              tree_flatten(ws.server.params)[0]))
          and rs.ledger.totals() == ws.ledger.totals(),
          "fed faults: the resumed run differs from the run without the kill")
    t = ws.ledger.totals()
    print(f"fed faults: round 2 rejected client {corrupt}'s corrupt upload and aborted client "
          f"{slow}'s (straggler), both rows as before the round; {t['up_bytes_wasted']} bytes "
          f"wasted; killed after round {FED_KILL_ROUND + 1}'s aggregation, checkpoint "
          f"{save_ms:.1f} ms, restore {restore_ms:.1f} ms, resumed: params and ledger totals "
          f"bit-identical to the run without the kill")
    launches[label] = whole["launches"]["f32_mean_xla"]
    fed_profiled_round(ws, ROUNDS, label)

    # 9d. async rounds, stale starts, the staleness aggregator
    label = "fed lenet5 (async)"
    spec = dict(FED, fast=True, async_rounds=True, max_staleness=2, agg="staleness")
    asy = fed_drive(dev, spec, FED_PER_ROUND[True], label)
    for r, m in enumerate(asy["metrics"]):
        want = np.random.default_rng([FED.get("seed", 0), r, 7]).integers(
            0, min(2, r) + 1, size=len(m["staleness"]))
        check(m["staleness"] == [int(s) for s in want],
              f"{label} round {r + 1}: staleness {m['staleness']}, drawn {list(want)}")
    print(f"{label}: staleness draws {[m['staleness'] for m in asy['metrics']]} == "
          f"default_rng([seed, r, 7])'s")
    launches[label] = asy["launches"]["f32_mean_xla"]
    fed_profiled_round(asy["sched"], ROUNDS, label)

    # 9e. CharLSTM at full width
    label = "fed charlstm (flat)"
    lstm = fed_drive(dev, FED_CHARLSTM, FED_CHARLSTM_PER_ROUND, label,
                     rounds=FED_CHARLSTM["rounds"])
    lstm["sched"].ledger.reconcile(rel=0.1)
    launches[label] = lstm["launches"]["f32_mean_xla"]
    fed_profiled_round(lstm["sched"], FED_CHARLSTM["rounds"], label)
    return launches, trained


# ------------------------------------------- the paper's baselines and models


# phase 10a: the paper's Table II operating points (benchmarks/common.py
# METHODS: label, compressor, delay n, sparsity p), then the fedavg codec
# and every other baseline at n 1, on LeNet5's local backend (4 clients,
# batch 128, per leaf: the reference's default), 2 rounds each
TABLE2 = (("baseline", "none", 1, 1.0), ("grad_dropping", "topk", 1, 0.001),
          ("fedavg", "none", 10, 1.0), ("sbc1", "sbc", 1, 0.001), ("sbc2", "sbc", 10, 0.01),
          ("sbc3", "sbc", 100, 0.01), ("fedavg_codec", "fedavg", 10, 1.0),
          ("dgc", "dgc", 1, 0.001), ("dgc_policy", "dgc_policy", 1, 0.001),
          ("signsgd", "signsgd", 1, 0.001), ("onebit", "onebit", 1, 0.001),
          ("terngrad", "terngrad", 1, 0.001), ("qsgd", "qsgd", 1, 0.001),
          ("randomk", "randomk", 1, 0.001), ("variance", "variance", 1, 0.001))
TABLE2_ROUNDS = 2
TABLE2_CLIENTS = 4
# Eq. 1 bits a client in rounds 1 and 2 of each point (LeNet5, 1,256,010
# parameters); tests/test_torch_baselines_run.py holds them equal to the
# reference's.  dgc_policy's warm-up lowers its rate from round to round.
TABLE2_BITS = {
    "none": (40_192_320.0, 40_192_320.0), "fedavg": (40_192_320.0, 40_192_320.0),
    "topk": (60_384.0, 60_384.0), "dgc": (60_384.0, 60_384.0),
    "dgc_policy": (3_790_416.0, 953_280.0), "signsgd": (1_256_202.0, 1_256_202.0),
    "onebit": (1_256_394.0, 1_256_394.0), "terngrad": (1_990_920.875, 1_990_920.875),
    "qsgd": (6_222_712.0, 6_222_712.0), "randomk": (40_448.0, 40_448.0),
    "variance": (54_716.26953125, 54_716.26953125),
    ("sbc", 0.001): (14_652.2724609375, 14_652.2724609375),
    ("sbc", 0.01): (102_035.4609375, 102_035.4609375),
}
LENET5_LEAVES = 6
# ResNet-32 at full width (paper §IV-A; 466,714 parameters in 97 leaves) on
# CIFAR-shaped class blobs, batch 128 (paper Table III), momentum at lr
# 0.01, p = 0.01
RESNET32_PARAMS, RESNET32_LEAVES = 466_714, 97
RESNET32_EQ1 = 41_267.933283016355  # tests/test_torch_resnet32.py
# one forward and gradient against f64 (resnet32_vs_f64): the loss's
# relative error and the gradients' in norm.  On the CPU at batch 16 the
# port's f32 is inside and a TF32 rounding of the convolutions outside
# (tests/test_torch_resnet32.py::test_f32_gradients_against_f64_and_a_tf32_control)
RESNET32_F64_TOL = {"loss": 1e-6, "grads": 5e-3}
RESNET32_EXACT_PER_ROUND = per_call(seg_packbits=1, f32_mean_xla=RESNET32_LEAVES + 1)
RESNET32_LOCAL_PER_ROUND = {True: per_call(f32_mean_xla=RESNET32_LEAVES),
                            False: per_call(f32_mean_xla=2 * RESNET32_LEAVES * 4)}
# WordLSTM at full width (Zaremba et al. "medium": 2 x 650, vocabulary
# 10,000; 19,765,200 parameters in 8 leaves), SGD at lr 1.0, batch 20 x 35
# tokens, p = 0.01, 3 rounds
WORDLSTM_PARAMS, WORDLSTM_LEAVES, WORDLSTM_ROUNDS = 19_765_200, 8, 3
WORDLSTM_BATCH, WORDLSTM_SEQ = 20, 35
WORDLSTM_LOCAL_PER_ROUND = per_call(f32_mean_xla=WORDLSTM_LEAVES)
WORDLSTM_EXACT_PER_ROUND = per_call(seg_packbits=1, f32_mean_xla=WORDLSTM_LEAVES + 1)


def table2_bits(compressor: str, p: float) -> tuple:
    return TABLE2_BITS[(compressor, p) if compressor == "sbc" else compressor]


def table2_means(compressor: str) -> int:
    """``f32_mean_xla`` launches a round of a point, on LeNet5's per-leaf
    path with ``TABLE2_CLIENTS`` clients."""
    return len(leaf_mean_shapes(compressor, 1, 1)) * LENET5_LEAVES * TABLE2_CLIENTS


@contextlib.contextmanager
def builder_turns_tf32_off(label: str):
    """TF32 on, as cuDNN's default has it for convolutions, around a
    library builder, which must turn it off for matmuls and convolutions
    itself (:func:`repro_torch.device.full_f32_math`)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    yield
    check(not (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32),
          f"{label}: the builder left TF32 on")


def library_local_run(cfg, task, spec, dev):
    """A :class:`~repro_torch.run.LocalRun` of ``cfg`` on ``task`` through
    the library, the trainer built by ``DSGDTrainer`` as
    ``benchmarks/common.py`` ``run_training`` builds it (the model is not
    a preset's): ``spec``'s policy, clients and the config's lr."""
    import warnings

    from repro_torch.data import client_batches
    from repro_torch.models.model import build_model
    from repro_torch.optim import get_optimizer
    from repro_torch.run import LocalRun, lr_schedule, policy_from_spec
    from repro_torch.train import DSGDTrainer

    model = build_model(cfg)
    with builder_turns_tf32_off("DSGDTrainer"), warnings.catch_warnings():
        # the direct constructor warns that build_run is the declarative surface
        warnings.simplefilter("ignore", DeprecationWarning)
        trainer = DSGDTrainer(model=model, compressor=policy_from_spec(spec),
                              optimizer=get_optimizer(cfg.local_opt), n_clients=spec.clients,
                              lr=lr_schedule(cfg.base_lr), device=dev)
    return LocalRun(spec=spec, cfg=cfg, model=model, task=task, channel=trainer.channel,
                    trainer=trainer, batch_fn=client_batches(task, spec.clients, spec.delay),
                    device=dev)


def library_gspmd_run(cfg, task, spec, dev, group=None, mesh_shape=None, opts=frozenset(),
                      model=None, fast=True):
    """A :class:`~repro_torch.run.GspmdRun` of ``cfg`` on ``task`` through
    ``build_dist_train``, the way the reference reaches ResNet-32 (its
    preset has no image task): one client on ``dev`` unless ``group`` is
    given, on the layout ``mesh_shape`` with the launch ``opts``; the flat
    path unless ``fast`` is False."""
    from repro_torch.launch.dist import build_dist_train
    from repro_torch.launch.mesh import make_host_group
    from repro_torch.models.model import build_model
    from repro_torch.run import GspmdRun

    group = group or make_host_group(dev)
    model = model or build_model(cfg)
    with builder_turns_tf32_off("build_dist_train"):
        fns = build_dist_train(cfg, group=group, compressor=spec.compressor,
                               sparsity=spec.sparsity, fast=fast,
                               flat_engine=spec.flat_engine, measure=spec.measure_wire,
                               device_pack=spec.device_pack, model=model,
                               mesh_shape=mesh_shape, opts=opts)
    return GspmdRun(spec=spec, cfg=cfg, model=model, task=task, channel=fns.channel, fns=fns,
                    n_clients=fns.channel.n_clients, device=group.device, group=group)


def table2_phase(dev) -> dict:
    """Phase 10a: every point of ``TABLE2`` on LeNet5's local backend at
    full width (4 clients, batch 128), ``TABLE2_ROUNDS`` rounds each on the
    per-leaf path through ``build_run``, with :func:`local_path`'s checks,
    each round's Eq. 1 bits equal to ``TABLE2_BITS`` and its
    ``f32_mean_xla`` launches to :func:`table2_means`.  Then, with the
    counts set to 0, ``variance``'s last upload through
    ``Wire.pack_with_bits(device_pack=True)``: one ``seg_select_pack`` a
    Golomb leaf, the host pack's bytes and bits.  Returns each point's
    ``f32_mean_xla`` launches, and the ``seg_select_pack`` launches of
    the pack check."""
    import torch
    from repro_torch import kernels

    launches = {}
    print(f"table II: LeNet5, local, {TABLE2_CLIENTS} clients, batch 128, per leaf, "
          f"{TABLE2_ROUNDS} rounds a point")
    for label, comp, delay, p in TABLE2:
        spec = dict(preset="lenet5", backend="local", compressor=comp, delay=delay,
                    sparsity=p, clients=TABLE2_CLIENTS, batch=128, measure_wire=True,
                    rounds=TABLE2_ROUNDS)
        cap = local_path(dev, spec, {False: per_call(f32_mean_xla=table2_means(comp))},
                         f"table II {label} ({comp}, n {delay}, p {p})", rounds=TABLE2_ROUNDS,
                         profile=False)
        bits = tuple(float(m["bits_per_client"]) for m in cap["metrics"][False])
        check(bits == table2_bits(comp, p), f"table II {label}: Eq. 1 bits {bits}, not "
                                            f"{table2_bits(comp, p)}")
        dense = float(cap["metrics"][False][0]["bits_dense"])
        print(f"table II {label}: Eq. 1 {bits[-1]:.2f} bits a client a round against dense "
              f"{dense:.0f} (x{dense / bits[-1]:.1f}); step ms "
              f"{', '.join(f'{t:.3f}' for t in cap['step_ms'][False])}")
        launches[label] = {"f32_mean_xla": cap["launches"][False]["f32_mean_xla"]}
        if comp == "variance":
            up = cap["upload"][False]
            wire = cap["runs"][False].channel.wire(up["params"], up["rate"], TABLE2_ROUNDS - 1)
            golomb = sum(s.encoder == "golomb" for s in wire.specs)
            host = wire.pack_with_bits(up["compressed0"])
            torch.cuda.synchronize()
            kernels.reset_launches()
            got = wire.pack_with_bits(up["compressed0"], device_pack=True)
            torch.cuda.synchronize()
            packs = kernels.launch_counts()["seg_select_pack"]
            check(got == host and packs == golomb == LENET5_LEAVES,
                  f"table II variance: device pack ({len(got[0])} bytes, {got[1]} bits, "
                  f"{packs} seg_select_pack) != host pack ({len(host[0])}, {host[1]}, "
                  f"{golomb} Golomb leaves)")
            print(f"table II variance: Wire.pack_with_bits(device_pack=True) == the host "
                  f"pack byte for byte ({len(host[0])} bytes, {host[1]} bits), "
                  f"{packs} seg_select_pack (one a Golomb leaf)")
        del cap
    return {"launches": launches, "variance_pack": packs}


def resnet32_vs_f64(cfg, model, params, batch, label: str) -> None:
    """One ResNet-32 forward and gradient on the card through the model's
    f32 loss, with cuDNN as the library left it, against the same
    computation in f64 (its own log-softmax, since the model's loss takes
    f32 logits): the loss within ``RESNET32_F64_TOL["loss"]`` relative
    and every gradient within ``RESNET32_F64_TOL["grads"]`` (the error's
    norm over all leaves over the f64 gradient's).  The control, the same
    f32 computation with cuDNN's TF32 on, must miss one of the two."""
    import torch
    from repro_torch.core.tree import tree_flatten
    from repro_torch.models import cnn

    leaves, treedef = tree_flatten(params)
    labels = batch["labels"].long()

    def f64():
        ls = [v.detach().double().requires_grad_(True) for v in leaves]
        logits = cnn.resnet32_apply(treedef.unflatten(ls), batch["images"].double(), cfg)
        loss = torch.mean(torch.logsumexp(logits, -1) - logits.gather(-1, labels[:, None])[:, 0])
        return loss, torch.autograd.grad(loss, ls)

    def f32():
        ls = [v.detach().requires_grad_(True) for v in leaves]
        loss = model.loss_fn(treedef.unflatten(ls), batch)
        return loss, torch.autograd.grad(loss, ls)

    loss64, grads64 = f64()
    norm64 = torch.sqrt(sum(torch.sum(g * g) for g in grads64))

    def errors(got) -> tuple:
        loss, grads = got
        diff = torch.sqrt(sum(torch.sum((g.double() - w) ** 2) for g, w in zip(grads, grads64)))
        return (abs(float(loss.detach()) - float(loss64.detach())) / abs(float(loss64.detach())),
                float(diff / norm64))

    full = errors(f32())
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = errors(f32())
    finally:
        torch.backends.cudnn.allow_tf32 = False
    tol = (RESNET32_F64_TOL["loss"], RESNET32_F64_TOL["grads"])
    print(f"{label}: against f64 (batch {labels.shape[0]}), loss and gradient errors "
          f"{full[0]:.3e}, {full[1]:.3e} in f32; {tf32[0]:.3e}, {tf32[1]:.3e} with cuDNN's "
          f"TF32 on (tolerance {tol[0]:g}, {tol[1]:g})")
    check(full[0] <= tol[0] and full[1] <= tol[1], f"{label}: f32 off f64 by {full}")
    check(tf32[0] > tol[0] or tf32[1] > tol[1],
          f"{label}: the check cannot see TF32 ({tf32} within {tol})")


def resnet32_phase(dev) -> dict:
    """Phase 10b: ResNet-32 at full width (466,714 parameters in 97 leaves)
    on CIFAR-shaped class blobs (32 x 32 x 3, batch 128), momentum at lr
    0.01, p = 0.01, through the library, whose builders must turn TF32
    off (:func:`builder_turns_tf32_off`): one forward and gradient against
    f64 (:func:`resnet32_vs_f64`); the GSPMD hist engine (one client, 5
    rounds, phase 2's checks, each hist kernel held against its plain
    version on the path's operands over 97 segments), the exact engine
    with the device-packed wire and the ledger (phase 3's checks), and the
    local backend with 4 clients per leaf and flat (:func:`local_path`),
    each with a profiled round.  Returns every path's launches."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.data import make_classification_task
    from repro_torch.run import RunSpec

    cfg = get_config("resnet32")
    task = make_classification_task(n_classes=10, img_size=32, channels=3, batch=128,
                                    device=dev)
    gspmd = dict(preset="resnet32", backend="gspmd", fast=True, sparsity=0.01, batch=128,
                 rounds=ROUNDS)
    run = library_gspmd_run(cfg, task, RunSpec(**gspmd, flat_engine="hist"), dev)
    resnet32_vs_f64(cfg, run.model, run.init()["params"], task.sample(0, 0), "resnet32")
    space = run.fns.flat_space
    n_params = sum(s.global_size for s in space.segments)
    small = sum(s.global_size < 1024 for s in space.segments)
    print(f"resnet32: {n_params} params in {len(space.segments)} segments ({small} of them "
          f"under 1,024 entries; k per segment {sorted({s.k for s in space.segments})}), "
          f"{space.n_blocks} blocks, n_pad {space.n_pad}; bits_per_client "
          f"{run.fns.bits_per_client:.2f}")
    check(n_params == RESNET32_PARAMS and len(space.segments) == RESNET32_LEAVES
          and run.fns.bits_per_client == RESNET32_EQ1, "ResNet-32 layout and Eq. 1 bits")
    out = {}
    cap = drive(run, "exchange_local_hist", HIST_PER_ROUND, "resnet32 hist")
    one_mu_per_segment(space, cap, "resnet32 hist")
    profiled_round(run, cap["state"], "resnet32 hist")
    hist_kernels_vs_plain(cap["acc"], space, dev, "resnet32 hist")
    out["hist"] = cap["launches"]

    run = library_gspmd_run(cfg, task, RunSpec(**gspmd, flat_engine="exact",
                                               device_pack=True, measure_wire=True), dev)
    cap = drive(run, "exchange_local", RESNET32_EXACT_PER_ROUND, "resnet32 exact")
    exact_wire_checks(run, cap, dev, "resnet32 exact")
    exact_means_vs_plain(run.fns.flat_space, cap["last"], "resnet32 exact")
    profiled_round(run, cap["state"], "resnet32 exact")
    out["exact"] = cap["launches"]
    del run, cap
    local_spec = dict(preset="resnet32", backend="local", clients=4, batch=128, sparsity=0.01,
                      measure_wire=True, rounds=ROUNDS)
    local = local_path(dev, local_spec, RESNET32_LOCAL_PER_ROUND, "resnet32 local",
                       build=lambda fast: library_local_run(
                           cfg, task, RunSpec(**local_spec, fast=fast), dev))
    out["local_per_leaf"], out["local_flat"] = local["launches"][False], local["launches"][True]
    torch.cuda.synchronize()
    return out


def wordlstm_phase(dev) -> dict:
    """Phase 10c: WordLSTM at full width (2 x 650, vocabulary 10,000;
    19,765,200 parameters) on the markov task of vocabulary 10,000 (its
    transition table 400 MB of f32 on the card), batch 20 x 35 tokens, SGD
    at lr 1.0, p = 0.01, through the library as ``benchmarks/common.py``
    ``run_training`` goes (the reference's preset reduces it): the local
    backend with 4 clients on the flat space (:func:`local_path`) and the
    GSPMD exact engine with the device-packed wire (phase 3's checks), 3
    rounds each with a profiled round.  Prints the card's peak memory.
    Returns every path's launches."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core.tree import tree_flatten
    from repro_torch.data import make_lm_task
    from repro_torch.run import RunSpec

    cfg = get_config("wordlstm")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    task = make_lm_task(vocab=cfg.vocab_size, batch=WORDLSTM_BATCH, seq_len=WORDLSTM_SEQ,
                        temperature=0.5, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"wordlstm: the markov task of vocabulary {cfg.vocab_size} built in "
          f"{time.perf_counter() - t0:.2f} s (entropy floor {task.entropy_floor:.3f} nats)")
    common = dict(preset="wordlstm", sparsity=0.01, batch=WORDLSTM_BATCH,
                  seq_len=WORDLSTM_SEQ, rounds=WORDLSTM_ROUNDS)
    local_spec = dict(common, backend="local", clients=4, measure_wire=True)
    local = local_path(dev, local_spec, {True: WORDLSTM_LOCAL_PER_ROUND}, "wordlstm local",
                       build=lambda fast: library_local_run(
                           cfg, task, RunSpec(**local_spec, fast=fast), dev),
                       rounds=WORDLSTM_ROUNDS)
    local["runs"][True].ledger.reconcile(rel=0.25)
    n_params = sum(v.numel() for v in tree_flatten(local["states"][True].params)[0])
    check(n_params == WORDLSTM_PARAMS, f"WordLSTM: {n_params} params")
    print(f"wordlstm: {n_params} params in {WORDLSTM_LEAVES} leaves")
    out = {"local_flat": local["launches"][True]}
    del local
    run = library_gspmd_run(cfg, task, RunSpec(**common, backend="gspmd", fast=True,
                                               flat_engine="exact", device_pack=True,
                                               measure_wire=True), dev)
    space = run.fns.flat_space
    print(f"wordlstm exact: {[(s.path, s.global_size, s.k) for s in space.segments]}, "
          f"bits_per_client {run.fns.bits_per_client:.2f}")
    cap = drive(run, "exchange_local", WORDLSTM_EXACT_PER_ROUND, "wordlstm exact",
                rounds=WORDLSTM_ROUNDS)
    exact_wire_checks(run, cap, dev, "wordlstm exact")
    exact_means_vs_plain(space, cap["last"], "wordlstm exact")
    profiled_round(run, cap["state"], "wordlstm exact")
    out["exact"] = cap["launches"]
    print(f"wordlstm: the card's peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} "
          f"GiB (torch.cuda.max_memory_allocated)")
    return out


# ------------------------------------------------------------ delta broadcast


# phase 11a: phase 9's LeNet5 fed spec with a 5% downstream that rides the
# broadcast log (horizon 4): the log adds no launch, so a round launches
# phase 9b's 30 f32_mean_xla (4 tiles x 6, and the broadcast's 6)
FED_LOG = dict(FED_DOWN, broadcast_log=True, delta_horizon=4)
FED_LOG_PER_ROUND = FED_DOWN_PER_ROUND
FED_LOG_CKPT_ROUND = 2  # checkpoint after round 3 (index 2), resume rounds 4 and 5
# 11b: benchmarks/broadcast_fanout.py's settings (16 rounds, horizon 8, a 2%
# downstream, sync periods 1, 2, 4, 8, three verified classes, sbc with the
# small leaves dense) on LeNet5, at 10,000 and 100,000 subscribers; the
# server's per-leaf downstream compress takes 2 f32_mean_xla a leaf
FANOUT = dict(rounds=16, horizon=8, down_sparsity=0.02, periods=(1, 2, 4, 8),
              verify_classes=3, seed=0)
FANOUT_SUBSCRIBERS = (10_000, 100_000)
LENET5_PARAMS = 1_256_010
FANOUT_LENET5_PER_ROUND = per_call(f32_mean_xla=2 * LENET5_LEAVES)
# 11c: the same settings, uncut, on WordLSTM (19,765,200 parameters,
# 395,304 positions a broadcast at 2%), the largest union to code; the
# host Golomb coder sets its time (a horizon cut below the longest period,
# 8, would force that class to full resyncs)
FANOUT_WORDLSTM_PER_ROUND = per_call(f32_mean_xla=2 * WORDLSTM_LEAVES)


@contextlib.contextmanager
def broadcast_observed(plans: list, append_ms: list, plan_ms: list, others: bool = False):
    """Time every ``DeltaLog.append`` and ``CatchupPlanner.plan`` (host ms,
    appended to the lists) and record every plan as ``(head, from_round,
    plan, the log's replica then, the SBD1 messages not chosen)``; the last
    two only with ``others`` (else None and []): the stacked message (where
    the window is held) and the full one, encoded after the timer."""
    from repro_torch.serve import broadcast as sb
    from repro_torch.serve import deltalog as sd

    append, plan = sd.DeltaLog.append, sb.CatchupPlanner.plan

    def timed_append(self, *args, **kwargs):
        t0 = time.perf_counter()
        entry = append(self, *args, **kwargs)
        append_ms.append((time.perf_counter() - t0) * 1e3)
        return entry

    def timed_plan(self, from_round):
        t0 = time.perf_counter()
        got = plan(self, from_round)
        plan_ms.append((self.log.head, (time.perf_counter() - t0) * 1e3))
        replica, rest = None, []
        if others:
            replica = self.log.replica_flat()
            if got.kind not in ("stacked", "none") and self.log.can_stack(from_round):
                rest.append(self.log.encode_stacked(from_round).blob)
            if got.kind not in ("full", "none"):
                rest.append(self.log.encode_full().blob)
        plans.append((self.log.head, from_round, got, replica, rest))
        return got

    with swapped(sd.DeltaLog, {"append": timed_append}), \
            swapped(sb.CatchupPlanner, {"plan": timed_plan}):
        yield


def log_state(sched) -> dict:
    """The log path's state: the log's head, replica and held blobs, the
    channel's sync horizon, the ledger's rows and W."""
    from repro_torch.core.tree import tree_flatten

    log = sched.server.delta_log
    return {"head": log.head, "replica": [r.clone() for r in log._replica],
            "blobs": [(e.round, e.blob) for e in log._entries],
            "last_sync": dict(sched.channel._last_sync), "history": sched.ledger.history(),
            "params": [x.clone() for x in tree_flatten(sched.server.params)[0]]}


def same_log_state(a: dict, b: dict) -> bool:
    return (a["head"] == b["head"] and a["blobs"] == b["blobs"]
            and a["last_sync"] == b["last_sync"] and a["history"] == b["history"]
            and all(bit_equal(x, y) for x, y in zip(a["replica"], b["replica"]))
            and all(bit_equal(x, y) for x, y in zip(a["params"], b["params"])))


def fed_log_phase(dev, trained: dict) -> int:
    """Phase 11a: the fed backend with the broadcast log on the card, held
    to phase 9b's run of the same spec without the log (``trained``: its
    per-round losses and trained state).  Returns the f32_mean_xla
    launches of its rounds."""
    import tempfile

    from repro_torch.core.tree import tree_flatten
    from repro_torch.fed import restore_fed_state
    from repro_torch.run import RunSpec, build_run
    from repro_torch.serve import apply_catchup_flat, apply_plan

    label = "fed lenet5 (broadcast log)"
    run = build_run(RunSpec(**FED_LOG), device=dev)
    sched = run.init()
    log, channel = sched.server.delta_log, sched.channel
    check(log is not None and log.device.type == "cuda"
          and all(r.is_cuda for r in log._replica), f"{label}: the log's replica is not on the card")
    initial = log.replica_flat()
    cohorts, synced_before, plans, append_ms, plan_ms = {}, {}, [], [], []
    exchange = channel.round_exchange

    def observed_exchange(round_idx, cohort, *args, **kwargs):
        cohorts[round_idx] = [int(c) for c in cohort]
        return exchange(round_idx, cohort, *args, **kwargs)

    def before_round(r, s):
        synced_before[r] = dict(channel._last_sync)

    channel.round_exchange = observed_exchange
    try:
        with broadcast_observed(plans, append_ms, plan_ms, others=True):
            drove = fed_drive(dev, None, FED_LOG_PER_ROUND, label, run=run,
                              before_round=before_round)
    finally:
        del channel.round_exchange
    whole = log_state(sched)
    # the log changes what is metered, not what is trained
    losses = [m["loss"] for m in drove["metrics"]]
    check(losses == trained["losses"] and len(drove["state"]) == len(trained["state"])
          and all(bit_equal(a, b) for a, b in zip(drove["state"], trained["state"])),
          f"{label}: losses {losses} or the params and client rows differ from phase 9b's "
          f"run without the log ({trained['losses']})")
    print(f"{label}: per-round losses, params and client rows bit-identical to phase 9b's "
          f"run of the same spec without the log")

    # round 0 pulls nothing; a round's down bytes are its members' plans'
    # bytes; a member's replica moved by its plan, each replayed SBW1 blob
    # decoded through the server's down wire as a receiver decodes it, is
    # the log's replica bit for bit
    def receiver_dense(round_idx, blob):
        dense = sched.server.down_wire(round_idx).unpack(blob)
        return [x.reshape(-1).to(dev) for x in tree_flatten(dense)[0]]

    members = {}
    by_round: dict = {}
    for head, frm, plan, replica, rest in plans:
        by_round.setdefault(head + 1, {})[frm] = (plan, replica, rest)
    moved = others = decoded = 0
    for r, m in enumerate(drove["metrics"]):
        made = by_round.get(r, {})
        want = 0
        for cid in cohorts[r]:
            frm = synced_before[r].get(cid, -1)
            check(frm in made, f"{label} round {r + 1}: no plan from round {frm}")
            plan, replica, rest = made[frm]
            want += plan.nbytes
            if plan.kind == "none":
                continue
            at, flats = members.get(cid, (-1, initial))
            check(at == frm, f"{label} round {r + 1}: client {cid} holds round {at}, not {frm}")
            # the messages not chosen move the same replica to the same bits
            for blob in rest:
                got = apply_catchup_flat(flats, blob)[0]
                check(all(bit_equal(a, b) for a, b in zip(got, replica)),
                      f"{label} round {r + 1}: client {cid}'s replica moved by the "
                      f"{'stacked' if blob[4] == 0 else 'full'} message != the log's replica")
                others += 1
            flats = apply_plan(flats, plan, receiver_dense)
            decoded += len(plan.blobs) if plan.kind == "replay" else 0
            check(all(bit_equal(a, b) for a, b in zip(flats, replica)),
                  f"{label} round {r + 1}: client {cid}'s replica moved by its {plan.kind} plan "
                  f"!= the log's replica")
            members[cid] = (plan.to_round, flats)
            moved += 1
        check(m["down_bytes"] == want, f"{label} round {r + 1}: down bytes {m['down_bytes']} != "
              f"the members' plans' {want}")
    check(drove["metrics"][0]["down_bytes"] == 0, f"{label}: round 1 pulled bytes")
    kinds = sorted({p[2].kind for p in plans})
    print(f"{label}: round 1 pulled nothing; every round's down bytes == the members' plans' "
          f"bytes ({[m['down_bytes'] for m in drove['metrics']]}); {moved} member replicas moved "
          f"by their plans ({kinds}; {decoded} replayed SBW1 blobs decoded through the down "
          f"wire), and by the {others} stacked and full messages not chosen, == the log's "
          f"replica bit for bit on the card")
    # no reconcile, as in phase 9b: round 1's gap broadcast at p = 0.05 holds
    # fewer non-zero entries than k, so its positions are no geometric draw
    per_round = [sum(ms for h, ms in plan_ms if h == r - 1) for r in range(ROUNDS)]
    print(f"{label}: step ms rounds 2-{ROUNDS} {[round(x, 3) for x in drove['step_ms'][1:]]}; "
          f"DeltaLog.append host ms {[round(x, 3) for x in append_ms]}; planning host ms a "
          f"round {[round(x, 3) for x in per_round]}")
    fed_profiled_round(sched, ROUNDS, label)

    # a checkpoint after round 3 resumes rounds 4 and 5 to the same log
    part = build_run(RunSpec(**FED_LOG), device=dev)
    ps = part.init()
    for r in range(FED_LOG_CKPT_ROUND + 1):
        ps.step(r)
    with tempfile.TemporaryDirectory() as tmp:
        part.checkpoint(ps, f"{tmp}/fed.npz", rounds_done=FED_LOG_CKPT_ROUND + 1)
        fresh = build_run(RunSpec(**FED_LOG), device=dev)
        rs = fresh.init()
        meta = restore_fed_state(f"{tmp}/fed.npz", rs)
    check(meta["log"]["head"] == FED_LOG_CKPT_ROUND, f"{label}: checkpoint log {meta['log']}")
    for r in range(FED_LOG_CKPT_ROUND + 1, ROUNDS):
        rs.step(r)
    check(same_log_state(log_state(rs), whole),
          f"{label}: the resumed run's log, last_sync, ledger or params differ from the "
          f"uninterrupted run's")
    print(f"{label}: checkpoint after round {FED_LOG_CKPT_ROUND + 1}, restore, rounds "
          f"{FED_LOG_CKPT_ROUND + 2}-{ROUNDS}: log (head {whole['head']}, replica, "
          f"{len(whole['blobs'])} blobs), last_sync, ledger rows and W bit-identical to the "
          f"uninterrupted run")
    t = sched.ledger.totals()
    print(f"{label}: down {t['down_bytes'] / 1e3:.1f} kB in {ROUNDS} rounds, measured/analytic "
          f"down x{t['down_bits_measured'] / max(t['down_bits_analytic'], 1):.3f}")
    return drove["launches"]["f32_mean_xla"]


def fanout_run(dev, preset: str, n_subscribers: int, settings: dict, per_round: dict,
               label: str) -> dict:
    """``simulate_fanout`` on ``preset``'s parameters (the model's seed-0
    init) on the card, with the launch counts set to 0 just before and read
    just after (``per_round`` a round, nothing else), every ``f32_mean_xla``
    call held bit for bit against the plain cascade, the pool's state and
    the log's replica on the card, and the reference's gates: a bit-exact
    stack, catch-ups cheaper than a resync at every lag, a reconciled
    ledger.  Prints the rates, bytes, saving, plan by lag and host ms."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs.base import get_config
    from repro_torch.core import stages as core_stages
    from repro_torch.core.tree import tree_flatten
    from repro_torch.kernels import reduce as kreduce
    from repro_torch.kernels import topk as ktopk
    from repro_torch.models.model import build_model
    from repro_torch.serve import broadcast as sb
    from repro_torch.serve import simulate_fanout

    params = build_model(get_config(preset)).init(torch.Generator().manual_seed(0))
    means, pools, plans, append_ms, plan_ms = [], [], [], [], []
    sync = sb.SubscriberPool.sync_round

    def observed_sync(self, round_idx):
        if not pools:
            pools.append(self)
        return sync(self, round_idx)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    with swapped(ktopk, recording(ktopk, ("f32_mean_xla",), means)), \
            swapped(core_stages, recording(core_stages, ("f32_mean_xla",), means)), \
            swapped(sb.SubscriberPool, {"sync_round": observed_sync}), \
            broadcast_observed(plans, append_ms, plan_ms):
        t0 = time.perf_counter()
        out = simulate_fanout(params, n_subscribers=n_subscribers, device=dev, **settings)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    rounds = settings["rounds"]
    check(launches == {k: v * rounds for k, v in per_round.items()},
          f"{label}: launches {launches}, not {per_round} a round for {rounds} rounds")
    pool = pools[0]
    check(pool._synced.is_cuda and pool._bytes.is_cuda and pool.log._replica[0].is_cuda,
          f"{label}: the pool's state or the log's replica is not on the card")
    for _, args, kwargs in means:
        check(bit_equal(kreduce.f32_mean_xla(*args, **kwargs),
                        kreduce.f32_mean_xla_plain(*args, **kwargs)),
              f"{label}: f32_mean_xla on {tuple(args[0].shape)}: kernel != plain cascade")
    check(out["n_params"] == sum(v.numel() for v in tree_flatten(params)[0]),
          f"{label}: {out['n_params']} params")
    check(out["stack_bit_exact"] and out["catchup_beats_full_all_lags"]
          and out["ledger_reconciles"], f"{label}: gates {out}")
    classes = {p.kind for _, _, p, _, _ in plans}
    per_round_plan = [sum(ms for h, ms in plan_ms if h == r) for r in range(rounds)]
    print(f"{label}: {n_subscribers} subscribers x {rounds} rounds (horizon "
          f"{settings['horizon']}, p_down {settings['down_sparsity']}, {out['n_params']} params) "
          f"in {wall_s:.2f} s: {out['rounds_per_sec']:.3f} rounds/s, "
          f"{out['subscriber_syncs_per_sec']:.0f} subscriber syncs/s, "
          f"{out['bytes_per_subscriber_per_round']:.1f} B a subscriber a round (full resync "
          f"{out['full_resync_bytes']} B), saving x{out['bytes_saving_vs_full_resync']:.2f} "
          f"against a full resync; stack bit-exact ({pool.verified_syncs} verified syncs), "
          f"catch-ups beat a resync at every lag, ledger reconciled; plans made {sorted(classes)}")
    print(f"{label}: plan by lag " + json.dumps(
        {lag: {"kind": v["kind"], "nbytes": v["nbytes"]} for lag, v in out["plan_by_lag"].items()}))
    print(f"{label}: DeltaLog.append host ms {[round(x, 1) for x in append_ms]}; planning host "
          f"ms a round {[round(x, 1) for x in per_round_plan]}; {len(means)} f32_mean_xla calls "
          f"bit-equal to the plain cascade; the card's peak memory {peak / 2**30:.3f} GiB "
          f"(torch.cuda.max_memory_allocated)")
    return launches


def broadcast_phase(dev, trained: dict) -> dict:
    """Phase 11: delta broadcast on the card (ROADMAP A10); ``trained`` is
    phase 9b's run without the log.  Returns each path's launches (every
    kernel, its whole run)."""
    out = {"fed lenet5 (broadcast log)": {"f32_mean_xla": fed_log_phase(dev, trained)}}
    for n in FANOUT_SUBSCRIBERS:
        label = f"fanout lenet5 ({n} subscribers)"
        out[label] = fanout_run(dev, "lenet5", n, FANOUT, FANOUT_LENET5_PER_ROUND, label)
    label = f"fanout wordlstm ({FANOUT_SUBSCRIBERS[0]} subscribers)"
    out[label] = fanout_run(dev, "wordlstm", FANOUT_SUBSCRIBERS[0], FANOUT,
                            FANOUT_WORDLSTM_PER_ROUND, label)
    return out


# ------------------------------------------------------------ decoders


def heldout_loss(model, params, task) -> float:
    """The loss of ``params`` on one held-out batch (a stream no client
    draws), the same batch every call."""
    import torch

    with torch.no_grad():
        return float(model.loss_fn(params, task.sample(0, 99)))


def _falls(losses: list, before: float, after: float, label: str) -> None:
    """Every round's loss finite, and the held-out loss lower after the
    rounds than at the start (each round's training loss is on its own
    batch, whose noise is larger than three rounds' progress at p = 0.001)."""
    check(all(math.isfinite(x) for x in losses) and after < before,
          f"{label}: losses {losses}; held-out {before} -> {after}")
    print(f"{label}: held-out loss {before:.6f} -> {after:.6f} after the rounds")


def _rounds_ms(step_ms: list) -> str:
    return ", ".join(f"{x:.3f}" for x in step_ms[1:])


def packbits_vs_plain(space, last: dict, words, label: str):
    """The exact path's one ``seg_packbits`` (stream order) on the last
    round's bits once more: bit-equal to its plain version and to the
    path's words.  Returns the bits."""
    import torch
    from repro_torch.core import flat as core_flat
    from repro_torch.kernels import pack as kpack

    calls: list = []
    with swapped(core_flat, recording(core_flat, ("pack_bit_rows",), calls)):
        space.exchange_local(last["bodies"], last["res"], device_pack=True)
    check(len(calls) == 1, f"{label}: one pack_bit_rows call per exchange, saw {len(calls)}")
    allbits = calls[0][1][0]
    got, want = kpack.seg_packbits_stream(allbits), kpack.seg_packbits_stream_plain(allbits)
    torch.cuda.synchronize()
    check(torch.equal(got.view(torch.int32), want.view(torch.int32))
          and torch.equal(got.view(torch.int32), words.view(torch.int32)),
          f"{label}: seg_packbits != its plain version or the path's words")
    print(f"{label}: seg_packbits (stream order) on the path's {allbits.numel()} bits -> "
          f"{got.numel()} words, no pad and no transpose, bit-equal to the plain version and "
          f"the path")
    return allbits


def largest_bins(acc, space, label: str) -> None:
    """The largest count of any bin in the hist pipeline's two passes on
    ``acc``, beside 2^24, the last integer f32 holds exactly: the kernel and
    its plain version count in integers and round to f32 once (the
    reference's Pallas kernel adds f32 block counts, ROADMAP C)."""
    import torch
    from repro_torch.core import flat as core_flat
    from repro_torch.kernels import flat as kflat

    bounds = [(s.offset, s.rows * s.n_loc) for s in space.segments]
    sob = torch.from_numpy(space.seg_of_block.astype("int64")).to(acc.device)
    calls: list = []
    with swapped(core_flat, recording(core_flat, ("seg_hist2side",), calls)):
        core_flat._hist_pipeline(acc, bounds, [s.k for s in space.segments],
                                 [s.rate for s in space.segments], sob, space.n_blocks,
                                 space.bm, space.lanes, 128,
                                 absmax=kflat.seg_absmax(acc, bounds))
    tops = [int(kflat.seg_hist2side(*a, **kw).max()) for _, a, kw in calls]
    print(f"{label}: the largest bin count of each pass {tops} (2^24 = {2 ** 24}); "
          f"{'above' if max(tops) > 2 ** 24 else 'within'} f32's exact integers")


def lm100m_phase(dev) -> dict:
    """Phase 12a: lm-100m at full width (137,841,408 parameters) on the
    reference's training default, the local backend (4 clients, per leaf,
    batch 8 x 256, p = 0.001, through ``build_run``), then one client on
    the GSPMD hist engine and on the exact engine with the device-packed
    wire and its ledger (the same task), 3 rounds each and a profiled
    round: finite losses that fall, each round's Eq. 1 bits the pinned
    reference's (``LM100M_EQ1``), the ledger reconciled, the launches a
    round predicted, every kernel call equal to its plain version on the
    path's operands (phases 2, 3 and 6's checks), and the largest count a
    histogram bin holds against f32's exact integers (2^24).  Prints
    round ms (rounds 2 on) and each path's peak memory.  Returns every
    path's launches."""
    import torch
    from repro_torch.core.tree import tree_flatten
    from repro_torch.run import RunSpec

    torch.cuda.reset_peak_memory_stats(dev)
    out = {}
    local = local_path(dev, LM100M_LOCAL, LM100M_LOCAL_PER_ROUND, "lm-100m local",
                       rounds=LM100M_ROUNDS)
    run, metrics = local["runs"][False], local["metrics"][False]
    n_params = sum(v.numel() for v in tree_flatten(local["states"][False].params)[0])
    check(n_params == LM100M_PARAMS, f"lm-100m: {n_params} params")
    # the local path reports Eq. 1 as the f32 sum of its leaves' terms, as
    # the reference's metric does: within one f32 ulp of the f64 pin
    bits = [float(m["bits_per_client"]) for m in metrics]
    pin = LM100M_EQ1["local"]
    check(all(abs(b - pin) <= pin * 2 ** -23 for b in bits),
          f"lm-100m local Eq. 1 bits {bits}, not {pin!r} within one f32 ulp")
    _falls([float(m["loss"]) for m in metrics],
           heldout_loss(run.model, run.init().params, run.task),
           heldout_loss(run.model, local["states"][False].params, run.task), "lm-100m local")
    run.ledger.reconcile(rel=0.25)
    print(f"lm-100m local: {n_params} params; Eq. 1 {bits[0]!r} bits a client a round (the "
          f"reference's {pin!r} in f32); ledger reconciled; round ms (rounds 2 on) "
          f"{_rounds_ms(local['step_ms'][False])}; the card's peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB (torch.cuda."
          f"max_memory_allocated, the task's table included)")
    out["local_per_leaf"] = local["launches"][False]
    task, cfg = run.task, run.cfg
    del local, run, metrics
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)

    for engine, per_round in (("hist", HIST_PER_ROUND), ("exact", LM100M_EXACT_PER_ROUND)):
        label = f"lm-100m {engine}"
        extra = dict(device_pack=True, measure_wire=True) if engine == "exact" else {}
        run = library_gspmd_run(cfg, task, RunSpec(**LM100M, backend="gspmd", fast=True,
                                                   flat_engine=engine, **extra), dev)
        space = run.fns.flat_space
        check(sum(s.global_size for s in space.segments) == LM100M_PARAMS
              and len(space.segments) == LM100M_LEAVES
              and sum(s.rows for s in space.segments) == LM100M_ROWS
              and run.fns.bits_per_client == LM100M_EQ1["gspmd"],
              f"{label}: layout or Eq. 1 bits {run.fns.bits_per_client!r}")
        print(f"{label}: {len(space.segments)} segments, {LM100M_ROWS} rows, {space.n_blocks} "
              f"blocks, n_pad {space.n_pad}; Eq. 1 {run.fns.bits_per_client!r} bits a client "
              f"a round (the reference's)")
        exchange = "exchange_local_hist" if engine == "hist" else "exchange_local"
        cap = drive(run, exchange, per_round, label, rounds=LM100M_ROUNDS)
        _falls(cap["losses"], heldout_loss(run.model, run.init()["params"], task),
               heldout_loss(run.model, cap["state"]["params"], task), label)
        if engine == "hist":
            one_mu_per_segment(space, cap, label)
            hist_kernels_vs_plain(cap["acc"], space, dev, label)
            largest_bins(cap["acc"], space, label)
        else:
            _, words, _ = exact_wire_checks(run, cap, dev, label)
            exact_means_vs_plain(space, cap["last"], label)
            packbits_vs_plain(space, cap["last"], words, label)
            run.ledger.reconcile(rel=0.25)
        profiled_round(run, cap["state"], label)
        print(f"{label}: round ms (rounds 2 on) {_rounds_ms(cap['step_ms'])}; the card's peak "
              f"memory {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
        out[engine] = cap["launches"]
        del run, cap
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    return out


def serve_phase(dev) -> dict:
    """Phase 12b: ``repro_torch.launch.serve``'s engine on gemma3-1b at
    full width in bf16 (``SERVE_ARGV``): the prefill alone, then
    ``generate`` twice (greedy tokens equal and in range), and the decode
    step at position 2,048 against a prefill of the 2,049 tokens (within
    ``DECODE_TOL`` of the largest logit).  Prints prefill ms, decode ms a
    token, tokens/s and the card's peak memory.  Returns the path's
    launches (the serving path runs no hand kernel: the reference's
    attention, MLP and logits are plain jnp, ported as torch ops)."""
    import torch
    from repro_torch import kernels
    from repro_torch.core.tree import tree_flatten
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    torch.cuda.reset_peak_memory_stats(dev)
    args = serve.build_parser().parse_args(SERVE_ARGV + ["--device", str(dev)])
    t0 = time.perf_counter()
    cfg, engine, params, batch = serve.build_engine(args)
    torch.cuda.synchronize()
    leaves = tree_flatten(params)[0]
    n_params = sum(v.numel() for v in leaves)
    check(n_params == GEMMA3_PARAMS and all(v.dtype == torch.bfloat16 and v.is_cuda
                                            for v in leaves),
          f"gemma3-1b: {n_params} params, dtypes {sorted({str(v.dtype) for v in leaves})}")
    print(f"serve gemma3-1b: {n_params} bf16 params in {len(leaves)} leaves drawn on the card "
          f"in {time.perf_counter() - t0:.2f} s; prompts {tuple(batch['tokens'].shape)}")
    B, S, new = args.batch, args.prompt_len, args.new_tokens
    kernels.reset_launches()
    with torch.no_grad():
        engine.prefill(params, batch)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = engine.prefill(params, batch)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        outs, gen_ms = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            outs.append(engine.generate(params, batch, max_new_tokens=new).cpu())
            gen_ms.append((time.perf_counter() - t0) * 1e3)
        check(torch.equal(outs[0], outs[1]), "serve: greedy tokens differ between two runs")
        check(tuple(outs[0].shape) == (B, new) and int(outs[0].min()) >= 0
              and int(outs[0].max()) < cfg.vocab_size, f"serve: tokens out of range")
        # the decode step at position S against a prefill of S + 1 tokens
        nxt = outs[0][:, :1].to(dev)
        step_logits, _ = engine.serve_step(params, nxt, caches, S)
        hidden, _ = engine.model.prefill(
            params, {"tokens": torch.cat([batch["tokens"], nxt], dim=1)},
            q_chunk=SERVE_REF_Q_CHUNK)
        emb = transformer.output_embedding(params, cfg)
        ref = hidden[:, -1:, :].to(torch.float32) @ emb.to(torch.float32).T
        rel = float((step_logits - ref).abs().max()) / (float(ref.abs().max()) + 1e-6)
        check(bool(torch.isfinite(step_logits).all()) and rel < DECODE_TOL,
              f"serve: decode at position {S} vs prefill of {S + 1}: {rel:.4f}")
    launches = kernels.launch_counts()
    check(not any(launches.values()), f"serve: hand kernels launched {launches}")
    best = min(gen_ms)
    decode_ms = (best - prefill_ms) / (new - 1)
    print(f"serve gemma3-1b: prefill {B} x {S} tokens {prefill_ms:.3f} ms; generate {new} "
          f"tokens {', '.join(f'{x:.3f}' for x in gen_ms)} ms; decode {decode_ms:.3f} ms a "
          f"token (after the prefill), {B * new / (best / 1e3):.1f} tokens/s; greedy tokens "
          f"equal in two runs, in range; decode at {S} vs prefill of {S + 1}: "
          f"{rel:.4e} of the largest logit (limit {DECODE_TOL}); sample "
          f"{outs[0][0, :8].tolist()}")
    print(f"serve gemma3-1b: no hand kernel on the path ({launches}); the card's peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
    return launches


def decoder_phase(dev) -> dict:
    """Phase 12: lm-100m's training paths and gemma3-1b's serving.
    Returns each path's launches."""
    import torch

    torch.cuda.synchronize(dev)  # the card's context, before its memory stats are reset
    out = {f"lm-100m {k}": v for k, v in lm100m_phase(dev).items()}
    out["serve gemma3-1b"] = serve_phase(dev)
    return out


# ------------------------------------------------------- MoE and recurrent


def mixtral_phase(dev) -> dict:
    """Phase 13a: mixtral-8x7b at full width, one layer (``MIXTRAL1_PARAMS``
    parameters, 469.8 M-entry expert segments), in the labelled variant
    ``MIXTRAL1_VARIANT``, one client on the GSPMD hist engine at world 1
    (the markov LM task at vocabulary 32,000, batch 8 x 256, p = 0.001, SGD
    at the config's base_lr), with :func:`hist_at_scale`'s checks.  Returns
    the path's launches."""
    import dataclasses

    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.data import make_lm_task

    label = "mixtral-8x7b hist"
    torch.cuda.reset_peak_memory_stats(dev)
    variant = {k: getattr(torch, v) if k.endswith("dtype") else v
               for k, v in MIXTRAL1_VARIANT.items()}
    cfg = dataclasses.replace(get_config("mixtral_8x7b"), n_layers=1, **variant)
    print(f"{label}: the labelled variant {MIXTRAL1_VARIANT} of mixtral-8x7b, 1 of its "
          f"{get_config('mixtral_8x7b').n_layers} layers (the hist engine takes f32 leaves and "
          f"an f32 residual; 'data' is the GSPMD backend's one client mode, one client at "
          f"world 1 as pod mode would be)")
    task = make_lm_task(vocab=cfg.vocab_size, batch=MIXTRAL1["batch"],
                        seq_len=MIXTRAL1["seq_len"], temperature=0.5, seed=0, device=dev)
    pins = dict(params=MIXTRAL1_PARAMS, leaves=MIXTRAL1_LEAVES, segment=MIXTRAL1_SEGMENT,
                eq1=MIXTRAL1_EQ1)
    return hist_at_scale(dev, label, cfg, task, MIXTRAL1, pins)


def hist_at_scale(dev, label: str, cfg, task, spec: dict, pins: dict,
                  mesh_shape=None, group=None, on_round=None, heldout: bool = True) -> dict:
    """One client of ``cfg`` on ``task`` on the GSPMD hist engine at world 1
    (``spec``: sparsity, batch, sequence, rounds), the config's optimizer
    at its base_lr: the layout and Eq. 1 bits against ``pins`` (parameters,
    leaves, largest segment, bits a client a round), the rounds and a
    profiled one (launches 1/2/1/1 + 1 a round with one device a client,
    0/2/1/1 + 1 with several: ``HIST_PER_ROUND``; one mu a segment, the
    residual ``acc - dW*`` bit for bit, finite losses and a lower held-out
    loss), then each hist kernel call on the last accumulator bit-equal to
    its plain version (whose histogram and moments run over runs of
    blocks, so their temporaries fit beside the model), with its byte
    bound at these operands, and the largest bin beside 2^24.  Prints
    round ms, the busy share, top device operations and peak memory (since
    the caller's reset, and over the rounds alone).  ``group`` (one rank a
    device of ``mesh_shape``) holds this rank's device; the held-out loss
    and the parameter count (neither without ``heldout``) read the
    gathered params.  ``on_round`` goes to :func:`drive`.  Returns the path's
    launches (with ``mesh_shape``, a dict of them and the numbers the
    caller reports)."""
    import torch
    from repro_torch.core import flat as core_flat
    from repro_torch.core.tree import tree_flatten
    from repro_torch.kernels import flat as kflat
    from repro_torch.run import RunSpec

    run = library_gspmd_run(cfg, task, RunSpec(**spec, backend="gspmd", fast=True,
                                               flat_engine="hist"), dev, group=group,
                            mesh_shape=mesh_shape)
    space = run.fns.flat_space
    S = space.shards_per_client
    sizes = [s.global_size for s in space.segments]
    got = dict(params=sum(sizes), leaves=len(sizes), segment=max(sizes),
               eq1=run.fns.bits_per_client, rows=sum(s.rows * s.n_shards for s in space.segments),
               n_pad=space.n_pad, shards=S)
    check(all(got[k] == v for k, v in pins.items() if k in got),
          f"{label}: layout or Eq. 1 bits {got} against the pins {pins}")
    eq1 = got["eq1"]
    print(f"{label}: {sum(sizes)} params in {len(sizes)} segments (the largest "
          f"{max(sizes)}), {got['rows']} rows of {S} device(s) a client, {space.n_blocks} blocks "
          f"and n_pad {space.n_pad} a device ({S * space.n_pad / 2 ** 31:.3f} of 2^31 in all); "
          f"Eq. 1 {run.fns.bits_per_client!r} bits a client a round (the reference's, pinned)")
    init = [run.init()]  # handed to drive, which keeps no other reference
    before = None
    if heldout:
        whole = run.params_to_tree(init[0])
        n_params = sum(v.numel() for v in tree_flatten(whole)[0])
        check(n_params == pins["params"], f"{label}: {n_params} params drawn")
        before = heldout_loss(run.model, whole, task)
        del whole
    peak_before = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    cap = drive(run, "exchange_local_hist", HIST_PER_ROUND if S == 1 else HIST_SHARDS_PER_ROUND,
                label, rounds=spec["rounds"], on_round=on_round, state=init.pop())
    rounds_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    if heldout:
        _falls(cap["losses"], before,
               heldout_loss(run.model, run.params_to_tree(cap["state"]), task), label)
    one_mu_per_segment(space, cap, label)
    del cap["last"]
    profiled_round(run, cap["state"], label)
    peak_gib = max(peak_before, torch.cuda.max_memory_allocated(dev)) / 2**30
    print(f"{label}: round ms (rounds 2 on) {_rounds_ms(cap['step_ms'])}; the card's peak "
          f"memory {peak_gib:.3f} GiB (torch.cuda.max_memory_allocated, the task's table "
          f"included), {rounds_gib:.3f} GiB over the {spec['rounds']} rounds alone (this process)")
    del cap["state"]
    torch.cuda.empty_cache()

    # each kernel call of the pipeline on the last accumulator against its
    # plain version on the same operands (S device buffers: one call each)
    acc = cap["acc"]
    bounds = [(s.offset, s.rows * s.n_loc) for s in space.segments]
    sob = torch.from_numpy(space.seg_of_block.astype("int64")).to(dev)
    names = ("seg_hist2side", "seg_moments", "seg_binarize_apply")
    calls: list = []
    with swapped(core_flat, recording(core_flat, names, calls)):
        out, res, stats = core_flat._hist_pipeline(
            acc, bounds, [s.k for s in space.segments], [s.rate for s in space.segments], sob,
            space.n_blocks, space.bm, space.lanes, 128, absmax=kflat.seg_absmax(acc, bounds))
    check(torch.equal(res, acc - out), f"{label}: pipeline residual != acc - dW*")
    del out, res
    tops, bounds_ms = [], {}
    for name, args, kwargs in calls:
        xpad, params = args
        out_bytes = 2 * 4 * xpad.numel() if name == "seg_binarize_apply" else 0
        bounds_ms[name] = (4 * (xpad.numel() + params.numel()) + out_bytes) / HBM_BYTES_PER_S * 1e3
        got = getattr(kflat, name)(*args, **kwargs)
        want = getattr(kflat, f"{name}_plain")(*args, **kwargs)
        torch.cuda.synchronize()
        if name == "seg_binarize_apply":
            check(all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                      for g, w in zip(got, want)), f"{label} {name}: not bit-equal")
        else:
            check(torch.equal(got, want), f"{label} {name}: != its plain version")
        if name == "seg_hist2side":
            tops.append(int(got.max()))
        del got, want
    check(sorted({c[0] for c in calls}) == sorted(names) and len(calls) == 4,
          f"{label}: kernel calls {[c[0] for c in calls]}")
    print(f"{label}: {len(calls)} kernel calls bit-equal to their plain versions on the "
          f"path's {acc.numel()}-entry operands ({S * len(space.segments)} segments)")
    print(f"{label}: each kernel's bound at these operands (bytes over "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in bounds_ms.items()))
    print(f"{label}: the largest bin count of each pass {tops} (2^24 = {2 ** 24}); "
          f"{'above' if max(tops) > 2 ** 24 else 'within'} f32's exact integers")
    launches, cap_ms = cap["launches"], cap["step_ms"]
    del run, cap, acc, calls, task
    torch.cuda.empty_cache()
    return launches if mesh_shape is None else {
        "launches": launches, "bound_ms": bounds_ms, "largest_bins": tops,
        "step_ms": cap_ms, "rounds_gib": rounds_gib, "peak_gib": peak_gib, "eq1": eq1}


def prefill_chunk(n: int) -> int:
    """The ``q_chunk`` of a prefill of ``n`` tokens: 0 (the reference's
    rule) where the rule's chunk holds ``n`` or divides it, else the least
    divisor of ``n`` from 128 up (2,049 = 3 x 683; 1,025 = 5 x 205)."""
    rule = max(128, min(1024, (1 << 22) // n))
    if n <= rule or n % rule == 0:
        return 0
    return next(c for c in range(128, n + 1) if n % c == 0)


def stub_inputs(cfg, B: int, dev) -> dict:
    """A served batch's modality stub as the config's preset draws it
    (``repro_torch.run.presets.modality_fields``, from a host generator
    seeded 1): an encoder-decoder's ``SERVE_ENC_FRAMES`` frames, a vision
    config's ``n_prefix`` patch embeddings, else nothing."""
    import torch
    from repro_torch.run.presets import modality_fields

    fields = modality_fields(cfg, B, SERVE_ENC_FRAMES)
    if fields is None:
        return {}
    return {k: v.to(dev) for k, v in fields(torch.Generator().manual_seed(1)).items()}


def serve_zoo_phase(dev, entries=SERVE_ZOO) -> dict:
    """Phase 13b (and 14c with ``SERVE_STUBS``): each of ``entries`` at full
    width in bf16, cut in depth where the entry says,
    through ``ServeEngine`` as ``repro_torch.launch.serve`` builds it (its
    parameters drawn on the card from a generator seeded 0, the prompts from
    a second, the modality stub's input from a third, :func:`stub_inputs`):
    the prefill alone, then ``generate``
    twice (greedy tokens equal and in range, ``SERVE_ZOO_NEW`` new), no
    hand kernel; the MoE configs print the share of (token, expert) pairs
    their prefill drops at the config's capacity factor; then the decode
    step at position P against a prefill of P + 1 tokens within
    ``DECODE_TOL`` of the largest logit, with ``moe_capacity_factor = E/k``
    (C = S or T: nothing dropped, as the reference's test runs at
    ``reduced``'s 8.0).  Prints prefill ms, decode ms a token, tokens/s and
    the peak memory.  Returns each config's launches."""
    import dataclasses

    import torch
    from repro_torch import kernels
    from repro_torch.configs.base import get_config
    from repro_torch.core.policy import path_str
    from repro_torch.core.tree import tree_flatten, tree_flatten_with_path
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer
    from repro_torch.models.model import build_model
    from repro_torch.serve import ServeEngine

    out = {}
    for name, layers, B, S, count in entries:
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(name), n_layers=layers)
        engine = ServeEngine(build_model(cfg))
        params = engine.model.init(torch.Generator(device=dev).manual_seed(0))
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), device=dev,
                                         generator=torch.Generator(device=dev).manual_seed(0)),
                 **stub_inputs(cfg, B, dev)}
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        dtypes = {path_str(p): v.dtype for p, v in tree_flatten_with_path(params)[0]}
        n_params = sum(v.numel() for v in tree_flatten(params)[0])
        f32 = sorted({k.split("/")[-1] for k, d in dtypes.items() if d == torch.float32})
        check(n_params == count and set(f32) <= set(F32_LEAVES)
              and all(d in (torch.bfloat16, torch.float32) for d in dtypes.values()),
              f"serve {name}: {n_params} params; f32 leaves {f32}")
        print(f"serve {name}: {layers} of {get_config(name).n_layers} layers, {n_params} "
              f"params drawn on the card in {init_s:.2f} s, bf16 but the reference's f32 "
              f"leaves {f32 or 'none'}; prompts {tuple(batch['tokens'].shape)}"
              + "".join(f", {k} {tuple(v.shape)}" for k, v in batch.items() if k != "tokens"))
        drops: list = []
        apply = moe_lib.moe_apply

        def observed_moe(p, x, c, **kw):
            if not kw.get("full_capacity"):
                drops.append(moe_lib.dropped_share(p, x, c))
            return apply(p, x, c, **kw)

        kernels.reset_launches()
        with torch.no_grad(), swapped(moe_lib, {"moe_apply": observed_moe}):
            engine.prefill(params, batch)  # warm-up
            torch.cuda.synchronize()
            drops.clear()
            t0 = time.perf_counter()
            engine.prefill(params, batch)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
            first_drops = list(drops)
            outs, gen_ms = [], []
            for _ in range(2):
                t0 = time.perf_counter()
                outs.append(engine.generate(params, batch, max_new_tokens=SERVE_ZOO_NEW).cpu())
                gen_ms.append((time.perf_counter() - t0) * 1e3)
        check(torch.equal(outs[0], outs[1]), f"serve {name}: greedy tokens differ")
        check(tuple(outs[0].shape) == (B, SERVE_ZOO_NEW) and int(outs[0].min()) >= 0
              and int(outs[0].max()) < cfg.vocab_size, f"serve {name}: tokens out of range")
        launches = kernels.launch_counts()
        check(not any(launches.values()), f"serve {name}: hand kernels launched {launches}")
        best = min(gen_ms)
        decode_ms = (best - prefill_ms) / (SERVE_ZOO_NEW - 1)
        print(f"serve {name}: prefill {B} x {S} tokens {prefill_ms:.3f} ms; generate "
              f"{SERVE_ZOO_NEW} tokens {', '.join(f'{x:.3f}' for x in gen_ms)} ms; decode "
              f"{decode_ms:.3f} ms a token (after the prefill), "
              f"{B * SERVE_ZOO_NEW / (best / 1e3):.1f} tokens/s; greedy tokens equal in two "
              f"runs, in range; no hand kernel ({launches}); sample {outs[0][0, :8].tolist()}")
        if cfg.moe_experts:
            E, k = cfg.moe_experts, cfg.moe_top_k
            print(f"serve {name}: the prefill drops {', '.join(f'{d:.4f}' for d in first_drops)}"
                  f" of its (token, expert) pairs in its {len(first_drops)} MoE layers at "
                  f"capacity factor {cfg.moe_capacity_factor} ({cfg.moe_dispatch} dispatch, "
                  f"{E} experts, top-{k})")
        # decode at position S against a prefill of S + 1 tokens, nothing dropped
        full = build_model(dataclasses.replace(
            cfg, moe_capacity_factor=cfg.moe_experts / cfg.moe_top_k)) if cfg.moe_experts \
            else engine.model
        rows = 1 if cfg.moe_dispatch != "grouped" and cfg.moe_experts else B
        sub = {k: v[:rows] for k, v in batch.items()}
        nxt = outs[0][:rows, :1].to(dev)
        with torch.no_grad():
            _, caches = full.prefill(params, sub)
            step_logits, _ = full.decode_step(params, nxt, caches, S)
            del caches
            hidden, _ = full.prefill(params, {**sub, "tokens": torch.cat([sub["tokens"], nxt],
                                                                         dim=1)},
                                     q_chunk=prefill_chunk(S + 1))
            emb = transformer.output_embedding(params, cfg)
            ref = hidden[:, -1:, :].to(torch.float32) @ emb.to(torch.float32).T
        rel = float((step_logits - ref).abs().max()) / (float(ref.abs().max()) + 1e-6)
        check(bool(torch.isfinite(step_logits).all()) and rel < DECODE_TOL,
              f"serve {name}: decode at {S} vs prefill of {S + 1}: {rel:.4f}")
        print(f"serve {name}: decode at {S} vs prefill of {S + 1} on {rows} prompt(s)"
              f"{' at capacity factor E/k = ' + str(cfg.moe_experts / cfg.moe_top_k) + ' (nothing dropped)' if cfg.moe_experts else ''}: "
              f"{rel:.4e} of the largest logit (limit {DECODE_TOL}); the card's peak memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
        out[f"serve {name}"] = launches
        del engine, params, batch, full, hidden, emb, ref, step_logits, outs, sub, nxt
        torch.cuda.empty_cache()
    return out


def stub_variant(name: str, **changes):
    """``name``'s config in ``STUB_VARIANT`` (f32 leaves and residual) with
    ``changes``."""
    import dataclasses

    import torch
    from repro_torch.configs.base import get_config

    return dataclasses.replace(get_config(name), **{k: getattr(torch, v)
                                                    for k, v in STUB_VARIANT.items()}, **changes)


def encdec_train_phase(dev) -> dict:
    """Phase 14a-b: seamless-m4t-medium at full width and depth (614.8 M
    parameters) and phi-3-vision at full width, 8 of 32 layers (1.0 G), each
    one client on the GSPMD hist engine with :func:`hist_at_scale`'s checks,
    their samples carrying the preset's frames or prefix.  Returns each
    path's launches."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.data import make_lm_task
    from repro_torch.run.presets import modality_fields

    out = {}
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = stub_variant("seamless_m4t_medium")
    label = "seamless-m4t-medium hist"
    print(f"{label}: the labelled variant {STUB_VARIANT} of seamless-m4t-medium at full depth "
          f"({cfg.enc_layers} + {cfg.n_layers} layers; the hist engine takes f32 leaves), the "
          f"markov task over the first {SEAMLESS_TASK_VOCAB} of its {cfg.vocab_size} token ids "
          f"(a table at the whole vocabulary would be {4 * cfg.vocab_size ** 2 / 1e9:.0f} GB), "
          f"frames {SEAMLESS['batch']} x {SEAMLESS['seq_len']} x {cfg.d_model}")
    task = make_lm_task(vocab=SEAMLESS_TASK_VOCAB, batch=SEAMLESS["batch"],
                        seq_len=SEAMLESS["seq_len"], temperature=0.5, seed=0, device=dev,
                        extra_fields=modality_fields(cfg, SEAMLESS["batch"], SEAMLESS["seq_len"]))
    out[label] = hist_at_scale(dev, label, cfg, task, SEAMLESS, SEAMLESS_PINS)
    del task
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats(dev)
    cfg = stub_variant("phi3_vision_4p2b", n_layers=PHI3V_LAYERS)
    label = "phi-3-vision hist"
    print(f"{label}: the labelled variant {STUB_VARIANT} of phi-3-vision-4.2b, {PHI3V_LAYERS} of "
          f"its {get_config('phi3_vision_4p2b').n_layers} layers (at full depth its "
          f"3,722,578,944 entries pass the kernels' 2^31 offsets and its f32 Adam state would "
          f"not fit on one card), the markov task at vocabulary {cfg.vocab_size}, prefix "
          f"{PHI3V['batch']} x {cfg.n_prefix} x {cfg.d_model}")
    task = make_lm_task(vocab=cfg.vocab_size, batch=PHI3V["batch"], seq_len=PHI3V["seq_len"],
                        temperature=0.5, seed=0, device=dev,
                        extra_fields=modality_fields(cfg, PHI3V["batch"], PHI3V["seq_len"]))
    out[label] = hist_at_scale(dev, label, cfg, task, PHI3V, PHI3V_PINS)
    del task
    torch.cuda.empty_cache()
    return out


def bigrams(task, client: int, steps, vocab: int):
    """The empirical bigram distribution of one client's stream over
    ``steps`` (the reference's ``tests/test_fed.py`` helper)."""
    import numpy as np

    h = np.zeros((vocab, vocab))
    for step in steps:
        tok = task.sample(step, client)["tokens"].cpu().numpy()
        np.add.at(h, (tok[:, :-1].ravel(), tok[:, 1:].ravel()), 1)
    return h / h.sum()


def noniid_phase(dev) -> dict:
    """Phase 14d: the reference's ``TestNonIID`` statistics on tables drawn
    on the card (vocabulary 32, 4 clients, batch 8 x 64, temperature 0.3:
    two clients' bigram distributions more than 0.3 apart in L1 at skew 5;
    at skew 0 the distance across clients within 2 x the noise within one
    client + 0.05), then the fed launcher's own non-IID run
    (``NONIID_ARGV``) through :func:`fed_drive` (launches a round, every
    ``f32_mean_xla`` call against its plain cascade, every upload decoded to
    the member's ΔW*): the mean held-out loss over the 16 clients' chains
    falls.  Prints the host ms a round spent drawing batches.  Returns the
    path's launches."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.data import make_non_iid_lm_task
    from repro_torch.launch import fed
    from repro_torch.run.build import build_run
    from repro_torch.run.flags import spec_from_args

    label = "fed-tiny non-IID"
    skewed = make_non_iid_lm_task(vocab=32, batch=8, seq_len=64, n_clients=4, skew=5.0,
                                  temperature=0.3, seed=0, device=dev)
    apart = float(np.abs(bigrams(skewed, 0, [0], 32) - bigrams(skewed, 1, [0], 32)).sum())
    shared = make_non_iid_lm_task(vocab=32, batch=8, seq_len=64, n_clients=4, skew=0.0,
                                  temperature=0.3, seed=0, device=dev)
    noise = float(np.abs(bigrams(shared, 0, [0, 1], 32) - bigrams(shared, 0, [2, 3], 32)).sum())
    cross = float(np.abs(bigrams(shared, 0, [0, 1], 32) - bigrams(shared, 1, [0, 1], 32)).sum())
    check(apart > 0.3 and cross < 2.0 * noise + 0.05,
          f"{label}: L1 apart {apart} at skew 5; across {cross}, noise {noise} at skew 0")
    print(f"{label}: tables drawn on the card; two clients' bigrams {apart:.4f} apart in L1 at "
          f"skew 5 (> 0.3); at skew 0 across clients {cross:.4f}, within one client {noise:.4f} "
          f"(limit {2.0 * noise + 0.05:.4f})")

    args = fed.build_parser().parse_args(NONIID_ARGV + ["--device", str(dev)])
    spec = spec_from_args(args, backend="fed")
    run = build_run(spec, device=dev)
    check(run.task.name == f"lm_markov_noniid{spec.clients}", f"{label}: task {run.task.name}")
    sched = run.init()
    draw_s: list = []
    sample = run.task.sample

    def timed_sample(step, client):
        t0 = time.perf_counter()
        try:
            return sample(step, client)
        finally:
            draw_s.append(time.perf_counter() - t0)

    sched.pool.task = dataclasses.replace(run.task, sample=timed_sample)

    def heldout(params) -> float:  # a stream of each chain no client draws
        with torch.no_grad():
            return float(np.mean([float(run.model.loss_fn(params, sample(10 ** 6, c)))
                                  for c in range(spec.clients)]))

    before = heldout(sched.server.params)
    cap = fed_drive(dev, None, NONIID_PER_ROUND, label, rounds=NONIID_ROUNDS, run=run)
    after = heldout(sched.server.params)
    _falls([m["loss"] for m in cap["metrics"]], before, after, label)
    print(f"{label}: {spec.clients} clients, skew {spec.skew}, delay {spec.delay}, p "
          f"{spec.sparsity}, downstream {spec.down_sparsity}; round ms "
          f"{', '.join(f'{x:.3f}' for x in cap['step_ms'])}; host ms drawing batches "
          f"{1e3 * sum(draw_s) / NONIID_ROUNDS:.3f} a round ({len(draw_s) // NONIID_ROUNDS} "
          f"samples)")
    launches = cap["launches"]
    del run, sched, cap
    return launches


def encdec_phase(dev) -> dict:
    """Phase 14: the rest of the zoo (ROADMAP A12, part 3, items 3-5):
    seamless's and phi-3-vision's training, their serving, the non-IID fed
    run.  Returns each path's launches."""
    import torch

    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = encdec_train_phase(dev)
    out.update(serve_zoo_phase(dev, SERVE_STUBS))
    out["fed-tiny non-IID"] = noniid_phase(dev)
    print(f"phase 14 took {time.perf_counter() - t0:.1f} s")
    return out


def zoo_phase(dev) -> dict:
    """Phase 13: mixtral's training path and the four configs' serving.
    Returns each path's launches."""
    import torch

    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = {"mixtral-8x7b hist": mixtral_phase(dev)}
    out.update(serve_zoo_phase(dev))
    print(f"phase 13 took {time.perf_counter() - t0:.1f} s")
    return out


# ------------------------------------------------- pod mode, "model" axis


def pod_cfg(key: str):
    """The port's config of a ``POD_PINS`` entry."""
    import dataclasses

    import torch
    from repro_torch.configs.base import get_config, reduced

    pin = POD_PINS[key]
    cfg = get_config(pin["preset"])
    if pin.get("reduced"):
        cfg = reduced(cfg)
    return dataclasses.replace(cfg, **{k: getattr(torch, v) if k.endswith("dtype") else v
                                       for k, v in pin["changes"].items()})


def pod_granite_phase(dev) -> dict:
    """Phase 15a: granite-20b, 2 layers at full width, 1 client of 256
    shards on ``SINGLE_POD``, the f32 variant, through
    :func:`hist_at_scale` (launches 2/1/1 + 1 a round, one mu a (segment,
    device), each hist kernel call bit-equal to its plain version with its
    byte bound, the largest bin beside 2^24, Eq. 1 and the layout the
    pinned reference's, a lower held-out loss; step ms, busy share, peak)."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.data import make_lm_task

    label = "granite-20b pod hist"
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = pod_cfg("a")
    print(f"{label}: the labelled variant {POD_PINS['a']['changes']} of granite-20b, "
          f"{cfg.n_layers} of its {get_config('granite_20b').n_layers} layers at full width (the "
          f"hist engine takes f32 leaves and an f32 residual; the config is bf16), client mode "
          f"{cfg.client_mode!r} on the layout {SINGLE_POD}: 1 client of 256 shards")
    task = make_lm_task(vocab=cfg.vocab_size, batch=POD_A["batch"], seq_len=POD_A["seq_len"],
                        temperature=0.5, seed=0, device=dev)
    pins = {k: POD_PINS["a"][k] for k in ("eq1", "params", "leaves", "rows", "n_pad", "shards")}
    return hist_at_scale(dev, label, cfg, task, POD_A, pins, mesh_shape=SINGLE_POD)


# a client of POD_TWO holds 4 devices' buffers; one of FSDP_TWO_PODS's ranks
# one device's
POD_B_PATHS = (("hist", dict(flat_engine="hist", measure_wire=True), HIST_SHARDS_PER_ROUND),
               ("exact", dict(flat_engine="exact", device_pack=True, measure_wire=True),
                POD_B_EXACT_PER_ROUND))
FSDP_B_PATHS = (("hist", POD_B_PATHS[0][1], HIST_PER_ROUND), POD_B_PATHS[1])


def pod_rank_worker(rank: int, world: int, store: str, out: str) -> int:
    """One rank (one pod, one client of 4 shards) of phase 15b
    (``--pod-rank-worker``): every path of ``POD_B_PATHS`` through
    :func:`multi_rank_path`, then the pins, each device's packed ``nbits``
    against the host Golomb encoder, and the ledger; writes its results as
    JSON to ``out``."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.golomb import encode_positions
    from repro_torch.core.tree import tree_flatten
    from repro_torch.data import make_lm_task
    from repro_torch.launch.mesh import ClientGroup
    from repro_torch.run import RunSpec

    dev = torch.device("cuda", 0)
    group = ClientGroup.connect(rank=rank, world=world, device=dev, backend="gloo",
                                init_method=f"file://{store}")
    print(f"pod ranks: rank {rank} of {world} (pod {rank}) on {torch.cuda.get_device_name(dev)}, "
          f"transport {group.backend}: NCCL refuses two ranks on one card, and NCCL with two "
          f"ranks on two cards is still ROADMAP C3")
    cfg = pod_cfg("b")
    pin = POD_PINS["b"]
    task = make_lm_task(vocab=cfg.vocab_size, batch=POD_B["batch"], seq_len=POD_B["seq_len"],
                        temperature=0.5, seed=0, device=dev)
    results = {}
    try:
        for engine, extra, per_round in POD_B_PATHS:
            label = f"two pods {engine}"
            spec = RunSpec(preset="granite_20b", backend="gspmd", fast=True,
                           sparsity=pin["sparsity"], **extra)
            run = library_gspmd_run(cfg, task, spec, dev, group=group, mesh_shape=POD_TWO)
            space = run.fns.flat_space
            got = dict(eq1=run.fns.bits_per_client, n_pad=space.n_pad,
                       shards=space.shards_per_client,
                       rows=sum(s.rows * s.n_shards for s in space.segments),
                       params=sum(s.global_size for s in space.segments))
            check(run.n_clients == world and all(got[k] == pin[k] for k in got),
                  f"{label}: {run.n_clients} clients, layout {got} against the pins {pin}")
            last: dict = {}
            results[engine] = multi_rank_path(group, label, None, per_round, run=run,
                                              rounds=POD_B["rounds"], keep=last)
            if engine == "exact":
                # each device's packed bit counts of the last counted round
                # against the host Golomb encoder on its rows
                words, nbits = last["out"][3]
                own = space.flatten_local([o[0] for o in tree_flatten(last["out"][2])[0]])
                host, row = [], 0
                for s in space._sparse:
                    x = own[:, s.offset:s.offset + s.rows * s.n_loc].reshape(
                        space.shards_per_client, s.rows, s.n_loc).cpu()
                    for d in range(space.shards_per_client):
                        for r in range(s.rows):
                            pos = torch.nonzero(x[d, r]).reshape(-1).numpy()
                            host.append((d, row + r, int(encode_positions(pos, s.rate).size)))
                    row += s.rows
                nb = nbits[0].cpu()
                check(all(int(nb[d, r]) == b for d, r, b in host),
                      f"{label}: packed nbits != the host encoder's bits")
                led = run.ledger.history()["up_bits_measured"] if rank == 0 else None
                print(f"{label} [rank {rank}]: every (device, row)'s packed nbits == the host "
                      f"Golomb encoder's ({len(host)} rows of {space.shards_per_client} "
                      f"devices); Eq. 1 {got['eq1']!r} bits a client a round (the pinned "
                      f"reference's)" + (f"; ledger measured bits {led}" if led else ""))
            results[engine]["eq1"] = got["eq1"]
            del run
            torch.cuda.empty_cache()
    finally:
        group.close()
    Path(out).write_text(json.dumps(results))
    return 0


def pod_ranks_phase(dev) -> dict:
    """Phase 15b: two pods on the one card (``POD_TWO``: two ranks over
    gloo, 2 clients of 4 shards), each path of ``POD_B_PATHS``; the mean
    the same on both ranks bit for bit, and every check of
    :func:`multi_rank_path`.  Returns rank 0's launches a path."""
    _, results = spawn_ranks("--pod-rank-worker", 2, POD_TIMEOUT_S, "two pods")
    for engine, _, per_round in POD_B_PATHS:
        for r, res in enumerate(results):
            check(res[engine]["launches"] == {k: POD_B["rounds"] * v
                                              for k, v in per_round.items()},
                  f"two pods {engine} rank {r}: launches {res[engine]['launches']}")
    return {f"two pods {e}": results[0][e]["launches"] for e, _, _ in POD_B_PATHS}


def pod_moe_phase(dev) -> dict:
    """Phase 15c: mixtral-8x7b at its own dtypes (bf16 leaves and residual),
    1 of 32 layers at full width, 1 client of 256 shards on
    ``SINGLE_POD``: the per-leaf exchange (a top-k per shard and row, one
    ``f32_mean_xla`` a leaf) without launch options and with
    ``opts={"lean_moe"}``, each from the same drawn state:
    ``POD_C["rounds"]`` timed rounds with nothing but the step in the
    window, then one untimed round that measures the share of dropped
    (token, expert) pairs of the MoE layer and records every
    ``f32_mean_xla`` call.  Checks launches a round, finite losses, Eq. 1
    the pinned reference's and every recorded call bit-equal to its plain
    version; prints step ms (rounds 2 on), the dropped share and peak
    memory under each.  Returns the launches of the rounds, read before
    the comparison with the plain version."""
    import torch
    from repro_torch import kernels
    from repro_torch.core.tree import tree_flatten
    from repro_torch.data import make_lm_task
    from repro_torch.kernels import topk as ktopk
    from repro_torch.launch import dist as ldist
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.model import build_model
    from repro_torch.run import RunSpec

    label = "mixtral-8x7b pod bf16"
    torch.cuda.reset_peak_memory_stats(dev)
    cfg, pin = pod_cfg("c"), POD_PINS["c"]
    task = make_lm_task(vocab=POD_C["task_vocab"], batch=POD_C["batch"],
                        seq_len=POD_C["seq_len"], temperature=0.5, seed=0, device=dev)
    model = build_model(cfg)
    spec = RunSpec(preset="mixtral_8x7b", backend="gspmd", sparsity=pin["sparsity"])
    out, state0 = {}, None
    for opts in (frozenset(), frozenset({"lean_moe"})):
        tag = f"{label} opts={sorted(opts)}"
        run = library_gspmd_run(cfg, task, spec, dev, mesh_shape=SINGLE_POD, opts=opts,
                                model=model, fast=False)
        rows = sum((gl.global_shape[0] if gl.scanned else 1) * gl.n_shards
                   for gl in run.channel.leaves)
        check(run.fns.flat_space is None and run.fns.bits_per_client == pin["eq1"]
              and rows == pin["rows"] and len(run.channel.leaves) == pin["leaves"],
              f"{tag}: the per-leaf layout or Eq. 1 bits {run.fns.bits_per_client!r}")
        if state0 is None:
            state0 = run.init()
            n_params = sum(v.numel() for v in tree_flatten(state0["params"])[0])
            check(n_params == pin["params"], f"{label}: {n_params} params drawn")
            print(f"{label}: {n_params} params in bf16 ({cfg.n_layers} of 32 layers, full "
                  f"width), 1 client of 256 shards on {SINGLE_POD}; {rows} SBC rows (L x "
                  f"shards); Eq. 1 {run.fns.bits_per_client!r} bits a client a round (the "
                  f"pinned reference's); the per-leaf exchange (bf16 residual)")
        drops: list = []
        apply = moe_lib.moe_apply

        def observed_moe(p, x, c, **kw):
            with torch.no_grad():
                drops.append(moe_lib.dropped_share(p, x.detach(), c))
            return apply(p, x, c, **kw)

        state, calls, counts, step_ms, losses = state0, [], [], [], []
        kernels.reset_launches()
        for r in range(POD_C["rounds"] + 1):
            observed = r == POD_C["rounds"]
            before = kernels.launch_counts()
            with contextlib.ExitStack() as stack:
                if observed:  # the untimed round: the dropped share and the recorder
                    stack.enter_context(swapped(moe_lib, {"moe_apply": observed_moe}))
                    for module in (ktopk, ldist):
                        stack.enter_context(swapped(module, recording(
                            module, ("f32_mean_xla",), calls)))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = run.step(state, r)
                torch.cuda.synchronize()
                if not observed:
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(m["loss"]))
            after = kernels.launch_counts()
            counts.append({k: after[k] - before[k] for k in after})
            print(f"{tag} round {r + 1}: loss {losses[-1]:.6f}  "
                  + (f"dropped pairs {drops[-1]:.6f} (untimed)" if observed
                     else f"step {step_ms[-1]:.3f} ms")
                  + f"  launches {counts[-1]}")
        check(all(math.isfinite(x) for x in losses), f"{tag}: losses {losses}")
        check(all(c == POD_C_PER_ROUND for c in counts), f"{tag}: launches a round {counts}")
        out[tag] = {k: sum(c[k] for c in counts) for k in counts[0]}
        kernels_vs_plain_calls(calls, tag)
        print(f"{tag}: the capacity factor {cfg.moe_capacity_factor}"
              f"{' capped at 1.0 (lean_moe)' if opts else ''}; dropped (token, expert) pairs "
              f"{drops[-1]:.6f} (round {len(counts)}, untimed); step ms (rounds 2 to "
              f"{POD_C['rounds']}) {_rounds_ms(step_ms)}; the card's peak memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
        del run, state, calls
        torch.cuda.empty_cache()
    del state0, model, task
    torch.cuda.empty_cache()
    return out


def pod_phase(dev) -> dict:
    """Phase 15: pod mode and the "model" axis, (a) to (c).  Returns each
    path's launches, and phase a's kernel bounds and largest bins."""
    import torch

    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    a = pod_granite_phase(dev)
    out = {"granite-20b pod hist": a["launches"]}
    out.update(pod_ranks_phase(dev))
    out.update(pod_moe_phase(dev))
    print(f"phase 15 took {time.perf_counter() - t0:.1f} s")
    return {"launches": out, "bound_ms": a["bound_ms"], "largest_bins": a["largest_bins"]}


# ------------------------------------------- one rank a device (FSDP)


def fsdp_pins(key: str, shards: int) -> dict:
    """The pinned layout of ``FSDP_PINS[key]`` as :func:`hist_at_scale`
    checks it, with ``shards`` device buffers a rank."""
    pin = FSDP_PINS[key]
    return dict({k: pin[k] for k in ("eq1", "params", "leaves", "rows", "n_pad")},
                shards=shards)


def fsdp_one_rank(dev) -> dict:
    """Phase 16a, item 6's path: granite's 2 layers (``pod_cfg("a")``) as
    one rank holding the 4 devices' buffers of ``FSDP_LAYOUT``, through
    :func:`hist_at_scale`; the params after round 1 go to ``FSDP_REF``, one
    ``.npy`` a leaf, for the ranks to compare."""
    import numpy as np
    import torch
    from repro_torch.core.tree import tree_flatten
    from repro_torch.data import make_lm_task

    label = "granite-20b one rank, 4 devices"
    cfg = pod_cfg("a")
    task = make_lm_task(vocab=FSDP_TASK_VOCAB, batch=FSDP_A["batch"],
                        seq_len=FSDP_A["seq_len"], temperature=0.5, seed=0, device=dev)

    def keep_round1(run, r, state):
        if r == 0:
            for i, v in enumerate(tree_flatten(state["params"])[0]):
                np.save(FSDP_REF / f"{i}.npy", v.cpu().numpy())

    torch.cuda.reset_peak_memory_stats(dev)
    print(f"{label}: the variant {POD_PINS['a']['changes']} of granite-20b on {FSDP_LAYOUT}, "
          f"one rank a client (item 6's path)")
    return hist_at_scale(dev, label, cfg, task, FSDP_A, fsdp_pins("a", 4),
                         mesh_shape=FSDP_LAYOUT, on_round=keep_round1)


def fsdp_rank_worker(rank: int, world: int, store: str, out: str) -> int:
    """One rank, one device, of phase 16 (``--fsdp-rank-worker``): (a) the
    granite run of :func:`fsdp_one_rank` on ``FSDP_LAYOUT``, its gathered
    params after round 1 against that run's (rank 0; a leaf gathered at a
    time), then (b) ``FSDP_B_PATHS`` on ``FSDP_TWO_PODS`` through
    :func:`multi_rank_path`; writes its results as JSON to ``out``."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.tree import tree_flatten
    from repro_torch.data import make_lm_task
    from repro_torch.launch.mesh import ClientGroup
    from repro_torch.launch.shards import assemble
    from repro_torch.run import RunSpec

    dev = torch.device("cuda", 0)
    group = ClientGroup.connect(rank=rank, world=world, device=dev, backend="gloo",
                                init_method=f"file://{store}")
    print(f"fsdp ranks: rank {rank} of {world} (one device of {FSDP_LAYOUT}) on "
          f"{torch.cuda.get_device_name(dev)}, transport {group.backend}: NCCL refuses "
          f"several ranks on one card, and NCCL across cards is still ROADMAP C3")
    results: dict = {}
    try:
        label = f"granite-20b rank {rank} of {world}"
        cfg = pod_cfg("a")
        task = make_lm_task(vocab=FSDP_TASK_VOCAB, batch=FSDP_A["batch"],
                            seq_len=FSDP_A["seq_len"], temperature=0.5, seed=0, device=dev)
        compared: dict = {}

        def against_one_rank(run, r, state):
            """After round 1: each leaf gathered (a collective of every
            rank), rank 0 holds it against the one-rank run's within the
            CPU tests' tolerance but for swaps of a row's k-th entry."""
            if r != 0:
                return
            fns = run.fns
            off = total = 0
            for i, (v, lb) in enumerate(zip(tree_flatten(state["params"])[0], fns.blocks)):
                whole = (v if math.prod(lb.grid) == 1 else
                         assemble(fns.ranks.client_ranks.gather_list(v), lb.grid, lb.dev_block))
                if rank == 0:
                    want = torch.from_numpy(np.load(FSDP_REF / f"{i}.npy")).to(dev)
                    off += int((~torch.isclose(whole, want, rtol=1e-5, atol=1e-7)).sum())
                    total += want.numel()
                    del want
                del whole
            compared.update(off=off, entries=total)

        torch.cuda.reset_peak_memory_stats(dev)
        a = hist_at_scale(dev, label, cfg, task, FSDP_A, fsdp_pins("a", 1),
                          mesh_shape=FSDP_LAYOUT, group=group, on_round=against_one_rank,
                          heldout=False)
        rows = FSDP_PINS["a"]["rows"]
        if rank == 0:
            check(compared["off"] <= 2 * rows,
                  f"{label}: {compared['off']} params off the one-rank run's after round 1, "
                  f"more than 2 a row ({rows} rows) allow")
            print(f"{label}: the gathered params after round 1 within rtol 1e-5, atol 1e-7 of "
                  f"the one-rank run's but {compared['off']} of {compared['entries']} entries "
                  f"({2 * rows} swaps of a row's k-th entry allowed)")
        results["granite"] = dict(a, compared=compared)
        torch.cuda.empty_cache()

        cfg_b, pin = pod_cfg("b"), FSDP_PINS["b"]
        task_b = make_lm_task(vocab=cfg_b.vocab_size, batch=POD_B["batch"],
                              seq_len=POD_B["seq_len"], temperature=0.5, seed=0, device=dev)
        for engine, extra, per_round in FSDP_B_PATHS:
            label = f"two pods of two ranks {engine}"
            spec = RunSpec(preset="granite_20b", backend="gspmd", fast=True,
                           sparsity=pin["sparsity"], **extra)
            run = library_gspmd_run(cfg_b, task_b, spec, dev, group=group,
                                    mesh_shape=FSDP_TWO_PODS)
            space = run.fns.flat_space
            got = dict(eq1=run.fns.bits_per_client, n_pad=space.n_pad,
                       rows=sum(s.rows * s.n_shards for s in space.segments),
                       params=sum(s.global_size for s in space.segments))
            check(run.n_clients == 2 and space.shards_per_client == 1
                  and all(got[k] == pin[k] for k in got),
                  f"{label}: {run.n_clients} clients, layout {got} against the pins {pin}")
            results[engine] = multi_rank_path(group, label, None, per_round, run=run,
                                              rounds=POD_B["rounds"])
            results[engine]["eq1"] = got["eq1"]
            del run
            torch.cuda.empty_cache()
    finally:
        group.close()
    Path(out).write_text(json.dumps(results))
    return 0


def fsdp_phase(dev) -> dict:
    """Phase 16: one rank a device.  (a) granite on ``FSDP_LAYOUT`` as one
    rank of 4 devices' buffers, then as ``FSDP_RANKS`` ranks over gloo of
    one device each (launches 2/1/1 + 1 a round on every rank, each hist
    kernel call == plain, Eq. 1 the same, the params after round 1 within
    tolerance, the rounds' peak memory a rank beside the prediction); (b)
    two pods of two ranks, hist and exact with the device pack.  Returns
    the launches of each path (rank 0's)."""
    import shutil

    import torch

    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    FSDP_REF.mkdir(parents=True, exist_ok=True)
    try:
        one = fsdp_one_rank(dev)
        torch.cuda.empty_cache()
        print(f"fsdp: the one-rank run took {time.perf_counter() - t0:.1f} s")
        _, results = spawn_ranks("--fsdp-rank-worker", FSDP_RANKS, FSDP_TIMEOUT_S, "fsdp ranks")
    finally:
        shutil.rmtree(FSDP_REF, ignore_errors=True)
    want = {k: FSDP_A["rounds"] * v for k, v in HIST_PER_ROUND.items()}
    for r, res in enumerate(results):
        g = res["granite"]
        check(g["launches"] == want and g["eq1"] == one["eq1"],
              f"fsdp rank {r}: launches {g['launches']}, Eq. 1 {g['eq1']!r} (one rank's "
              f"{one['eq1']!r})")
        for engine, _, per_round in FSDP_B_PATHS:
            check(res[engine]["launches"] == {k: POD_B["rounds"] * v
                                              for k, v in per_round.items()},
                  f"two pods of two ranks {engine} rank {r}: launches {res[engine]['launches']}")
    lo, hi = FSDP_PREDICTED_GIB
    print(f"fsdp: Eq. 1 {one['eq1']!r} bits a client a round on both paths; peak memory over "
          f"the rounds: one rank of 4 devices {one['rounds_gib']:.3f} GiB, the 4 ranks "
          + ", ".join(f"{res['granite']['rounds_gib']:.3f}" for res in results)
          + f" GiB (predicted {lo:g}-{hi:g} GiB a rank); round ms (rounds 2 on) one rank "
          f"{_rounds_ms(one['step_ms'])}, 4 ranks (rank 0) "
          f"{_rounds_ms(results[0]['granite']['step_ms'])}")
    print(f"phase 16 took {time.perf_counter() - t0:.1f} s")
    out = {"granite one rank of 4 devices": one["launches"],
           "granite 4 ranks (rank 0)": results[0]["granite"]["launches"]}
    out.update({f"two pods of two ranks {e} (rank 0)": results[0][e]["launches"]
                for e, _, _ in FSDP_B_PATHS})
    return out


def dist_serve_one_rank(dev, name: str, layers: int) -> dict:
    """Phase 17's one-rank run of ``name`` at ``layers`` layers through
    ``ServeEngine`` on the whole params: on each "data" coordinate's
    prompts alone (the prefill, then ``DIST_SERVE_NEW`` greedy steps),
    then on the whole batch of ``DIST_SERVE_BATCH`` prompts fed the same
    tokens, timed; every step's logits and caches go to
    ``DIST_SERVE_REF / name`` for the ranks.  A rank of a coordinate runs
    its GEMMs at that share's shapes, and the card's bf16 GEMMs round
    otherwise at other shapes, so the ranks are held to the one-rank run
    of their own prompts, and the whole batch's run against it is the
    control.  Returns the timed run's times, peak and launches."""
    import dataclasses

    import torch
    from repro_torch import kernels
    from repro_torch.configs.base import get_config
    from repro_torch.core.tree import tree_flatten
    from repro_torch.models.model import build_model
    from repro_torch.serve import ServeEngine

    B, S, new = DIST_SERVE_BATCH, DIST_SERVE_PROMPT, DIST_SERVE_NEW
    rows = B // FSDP_LAYOUT["data"]
    cfg = dataclasses.replace(get_config(name), n_layers=layers)
    engine = ServeEngine(build_model(cfg))
    torch.cuda.reset_peak_memory_stats(dev)
    params = engine.model.init(torch.Generator(device=dev).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (B, S), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(0))
    out = DIST_SERVE_REF / name
    out.mkdir(parents=True, exist_ok=True)
    kernels.reset_launches()
    with torch.no_grad():
        feed = []
        for d in range(FSDP_LAYOUT["data"]):  # each "data" coordinate's prompts alone
            logits, caches = engine.prefill(params, {"tokens": tokens[d * rows:(d + 1) * rows]})
            torch.save({"caches": caches}, out / f"share{d}_prefill.pt")
            fed = []
            for i in range(new):
                fed.append(torch.argmax(logits[:, -1], dim=-1))
                logits, caches = engine.serve_step(params, fed[-1][:, None], caches, S + i)
                torch.save({"logits": logits, "caches": caches}, out / f"share{d}_step{i}.pt")
            feed.append(torch.stack(fed))
        feed = torch.cat(feed, dim=1)
        del caches
        # the whole batch, timed, fed the same tokens: also the control, how far
        # one rank's own numbers move with the GEMM shapes alone
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        logits, caches = engine.prefill(params, {"tokens": tokens})
        torch.cuda.synchronize(dev)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        torch.save({"caches": caches}, out / "whole_prefill.pt")
        step_ms = []
        for i in range(new):
            t0 = time.perf_counter()
            logits, caches = engine.serve_step(params, feed[i][:, None], caches, S + i)
            torch.cuda.synchronize(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            torch.save({"logits": logits, "caches": caches}, out / f"whole_step{i}.pt")
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    torch.save({"tokens": tokens, "feed": feed}, out / "inputs.pt")
    launches = kernels.launch_counts()
    check(not any(launches.values()), f"one-rank serve {name}: hand kernels {launches}")
    return dict(prefill_ms=prefill_ms, step_ms=step_ms, peak_gib=peak, launches=launches,
                params=sum(v.numel() for v in tree_flatten(params)[0]))


def _ms(values) -> str:
    return ", ".join(f"{x:.3f}" for x in values)


def _block_err(got, want) -> float:
    """``max|got - want|`` over ``max|want|`` (a 0 denominator counts as 1)."""
    want = want.float()
    return float((got.float() - want).abs().max()) / (float(want.abs().max()) or 1.0)


def serve_rank_worker(rank: int, world: int, store: str, out: str) -> int:
    """One rank, one device of ``FSDP_LAYOUT``, of phase 17
    (``--serve-rank-worker``): each of ``DIST_SERVE`` through
    ``make_dist_prefill`` and ``make_dist_serve``, its blocks of the params
    drawn as the one-rank run's (seed 0) and cut as they are drawn, fed the
    one-rank runs' greedy tokens; over the steps its logits and cache
    blocks against the one-rank run of its "data" coordinate's prompts
    within ``DIST_SERVE_TOL`` of the largest, or within the control (the
    one-rank run of the whole batch against that of the prompts) where
    that is larger, ``pos`` equal; writes its times, peak, errors and
    launches as JSON to ``out``."""
    import dataclasses

    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels
    from repro_torch.configs.base import get_config
    from repro_torch.core.policy import path_str
    from repro_torch.core.tree import tree_flatten, tree_flatten_with_path
    from repro_torch.device import full_f32_math
    from repro_torch.launch.dist import make_dist_prefill, make_dist_serve
    from repro_torch.launch.mesh import ClientGroup
    from repro_torch.launch.shards import cut_tree
    from repro_torch.models.model import build_model

    dev = torch.device("cuda", 0)
    full_f32_math()
    group = ClientGroup.connect(rank=rank, world=world, device=dev, backend="gloo",
                                init_method=f"file://{store}")
    torch.cuda.synchronize(dev)
    if rank == 0:
        print(f"dist serve: rank {rank} of {world} (one device of {FSDP_LAYOUT}) on "
              f"{torch.cuda.get_device_name(dev)}, transport {group.backend}: NCCL refuses "
              f"several ranks on one card, and NCCL across cards is still ROADMAP C3")
    results: dict = {}
    B, S, new = DIST_SERVE_BATCH, DIST_SERVE_PROMPT, DIST_SERVE_NEW
    try:
        for name, layers in DIST_SERVE:
            label = f"dist serve {name} rank {rank}"
            cfg = dataclasses.replace(get_config(name), n_layers=layers)
            model = build_model(cfg)
            pf = make_dist_prefill(cfg, group=group, mesh_shape=FSDP_LAYOUT, model=model)
            sv = make_dist_serve(cfg, group=group, batch=B, seq_len=S, mesh_shape=FSDP_LAYOUT,
                                 model=model)
            torch.cuda.reset_peak_memory_stats(dev)
            params = sv.init_params(torch.Generator(device=dev).manual_seed(0))
            mine = sum(v.numel() for v in tree_flatten(params)[0])
            ref = DIST_SERVE_REF / name
            inputs = torch.load(ref / "inputs.pt", map_location=dev)
            errs: dict = {"logits": 0.0}  # the largest error of the logits and of each leaf
            agree, step_ms = 0, []

            # the one-rank run of this rank's "data" coordinate: its rows are all there
            share = sv.ranks.coords["data"]
            share_sizes = dict(FSDP_LAYOUT, data=1)
            share_at = dict(sv.ranks.coords, data=0)

            def one_rank(i: int, key: str):
                return torch.load(ref / f"share{i}_{key}.pt", map_location=dev)

            control: dict = {"logits": 0.0}  # the whole batch's one-rank run against the share's

            def held(caches, want_tree, what: str, whole_tree) -> None:
                want = cut_tree(want_tree, sv.cache_specs, share_sizes, share_at)
                for (p, w), c in zip(tree_flatten_with_path(want)[0],
                                     tree_flatten(sv.caches_from_tree(whole_tree))[0]):
                    if not path_str(p).endswith("pos"):
                        kind = f"{what.split()[0]} {path_str(p)}"
                        control[kind] = max(control.get(kind, 0.0), _block_err(c, w))
                for (p, got), w in zip(tree_flatten_with_path(caches)[0],
                                       tree_flatten(want)[0]):
                    key = path_str(p)
                    check(tuple(got.shape) == tuple(w.shape),
                          f"{label} {what} {key}: block {tuple(got.shape)}, not {tuple(w.shape)}")
                    if key.endswith("pos"):
                        check(torch.equal(got, w), f"{label} {what} {key}: pos differs")
                        continue
                    kind = f"{what.split()[0]} {key}"
                    errs[kind] = max(errs.get(kind, 0.0), _block_err(got, w))

            kernels.reset_launches()
            with torch.no_grad():
                pf.prefill(params, {"tokens": inputs["tokens"][:, :128]})  # warm-up
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                _, caches = pf.prefill(params, {"tokens": inputs["tokens"]})
                torch.cuda.synchronize(dev)
                prefill_ms = (time.perf_counter() - t0) * 1e3
                held(caches, one_rank(share, "prefill")["caches"], "prefill",
                     torch.load(ref / "whole_prefill.pt", map_location=dev)["caches"])
                for i in range(new):
                    t0 = time.perf_counter()
                    logits, caches = sv.serve_step(params, inputs["feed"][i][:, None], caches,
                                                   S + i)
                    torch.cuda.synchronize(dev)
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                    want = one_rank(share, f"step{i}")
                    want["logits"] = torch.cat([one_rank(d, f"step{i}")["logits"]
                                                for d in range(FSDP_LAYOUT["data"])])
                    whole = torch.load(ref / f"whole_step{i}.pt", map_location=dev)
                    control["logits"] = max(control["logits"],
                                            _block_err(whole["logits"], want["logits"]))
                    err = _block_err(logits, want["logits"])
                    errs["logits"] = max(errs["logits"], err)
                    check(tuple(logits.shape) == (B, 1, cfg.vocab_size)
                          and bool(torch.isfinite(logits).all()),
                          f"{label} step {i}: logits {tuple(logits.shape)}, not all finite")
                    held(caches, want["caches"], f"step {i}", whole["caches"])
                    agree += int((torch.argmax(logits[:, -1], -1)
                                  == torch.argmax(want["logits"][:, -1], -1)).sum())
                    del want
            # each within the bf16 bound, or within the control where one rank's
            # own numbers move further than that with the batch's shape alone
            over = [f"{k} {v:.3e} (control {control[k]:.3e})" for k, v in errs.items()
                    if v > max(DIST_SERVE_TOL, control[k])]
            if rank == 0 or over:
                print(f"{label}: the largest error of the logits and of each cache leaf over "
                      f"the steps, of the largest |value|: "
                      + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                      + "; the control (one rank on the whole batch against one rank on this "
                      "rank's prompts): " + ", ".join(f"{k} {v:.3e}" for k, v in control.items()))
            check(not over, f"{label}: past both {DIST_SERVE_TOL:.3e} of the largest and the "
                  f"control: {over}")
            launches = kernels.launch_counts()
            check(not any(launches.values()), f"{label}: hand kernels launched {launches}")
            results[name] = dict(prefill_ms=prefill_ms, step_ms=step_ms, errs=errs, agree=agree,
                                 control=control,
                                 params=mine, launches=launches,
                                 peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
            del params, caches, pf, sv
            torch.cuda.empty_cache()
    finally:
        group.close()
    Path(out).write_text(json.dumps(results))
    return 0


def dist_serve_phase(dev) -> dict:
    """Phase 17: serving across ranks.  Each of ``DIST_SERVE`` first on one
    rank (:func:`dist_serve_one_rank`), then on ``DIST_SERVE_RANKS`` ranks
    over gloo of one device each of ``FSDP_LAYOUT``
    (:func:`serve_rank_worker`, every check on every rank); prints the
    greedy tokens that agree, prefill ms, decode ms a token and the peak
    memory a rank beside the one-rank run's.  Returns each path's
    launches (all zero)."""
    import shutil

    import torch
    from repro_torch.device import full_f32_math

    torch.cuda.synchronize(dev)  # the context, before the peak's reset
    t0 = time.perf_counter()
    full_f32_math()
    one = {}
    try:
        for name, layers in DIST_SERVE:
            one[name] = dist_serve_one_rank(dev, name, layers)
            torch.cuda.empty_cache()
        print(f"dist serve: the one-rank runs took {time.perf_counter() - t0:.1f} s")
        _, results = spawn_ranks("--serve-rank-worker", DIST_SERVE_RANKS, DIST_SERVE_TIMEOUT_S,
                                 "dist serve ranks")
    finally:
        shutil.rmtree(DIST_SERVE_REF, ignore_errors=True)
    n_steps = DIST_SERVE_NEW * DIST_SERVE_BATCH
    out = {}
    for name, layers in DIST_SERVE:
        o = one[name]
        rs = [res[name] for res in results]
        print(f"dist serve {name}: {layers} layers at full width in bf16, {o['params']} params "
              f"({', '.join(str(r['params']) for r in rs)} a rank); prefill "
              f"{DIST_SERVE_BATCH} x {DIST_SERVE_PROMPT} one rank {o['prefill_ms']:.3f} ms, 4 "
              f"ranks {_ms(r['prefill_ms'] for r in rs)} ms; decode ms a token one rank "
              f"{_ms(o['step_ms'])}, rank 0 {_ms(rs[0]['step_ms'])} (mean "
              f"{sum(rs[0]['step_ms']) / len(rs[0]['step_ms']):.3f}); peak one rank "
              f"{o['peak_gib']:.3f} GiB, the ranks {_ms(r['peak_gib'] for r in rs)} GiB; "
              f"greedy tokens that agree "
              f"with the one-rank run's: {', '.join(str(r['agree']) for r in rs)} of {n_steps} "
              f"a rank; largest error over the steps (of the largest |value|, limit "
              f"{DIST_SERVE_TOL:.3e}): logits {max(r['errs']['logits'] for r in rs):.3e}, "
              f"caches {max(v for r in rs for k, v in r['errs'].items() if k != 'logits'):.3e}"
              f" (the control: logits {max(r['control']['logits'] for r in rs):.3e}, caches "
              f"{max(v for r in rs for k, v in r['control'].items() if k != 'logits'):.3e})"
              f"; no hand kernel "
              f"({rs[0]['launches']})")
        out[f"{name} one rank"] = o["launches"]
        out[f"{name} 4 ranks (rank 0)"] = rs[0]["launches"]
    print(f"phase 17 took {time.perf_counter() - t0:.1f} s")
    return out


def start_dryrun() -> subprocess.Popen:
    """Phase 18c's subprocess: ``python -m repro_torch.launch.dryrun`` with
    ``SCALE_DRYRUN`` (CPU work on ``meta`` tensors), its records under
    ``SCALE_DRYRUN_OUT`` and its output in a file there."""
    import os

    SCALE_DRYRUN_OUT.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    with open(SCALE_DRYRUN_OUT / "dryrun.log", "w") as log:
        proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun",
                                 *SCALE_DRYRUN, "--out-dir", str(SCALE_DRYRUN_OUT)],
                                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)
    proc.started = time.perf_counter()
    return proc


def stop_dryrun(proc: subprocess.Popen) -> None:
    """Kill :func:`start_dryrun`'s process and its workers (its session)."""
    import os
    import signal

    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def scale_real(dev) -> dict:
    """Phase 18a: ``plan_real`` of each ``SCALE_PINS`` config on the card:
    the reconcile bit-exact, Eq. 1 and the ledger the pinned reference's,
    ``f32_mean_xla`` launches a round; step ms printed."""
    from repro_torch import kernels
    from repro_torch.scale import planner

    out = {}
    for name, pin in SCALE_PINS.items():
        label = f"scale {name} real"
        kernels.reset_launches()
        rec, run = planner.plan_real(name, device=dev, **SCALE_REAL)
        launches = kernels.launch_counts()
        r = rec["real"]
        check(rec["reconciles"] and r["up_bits_predicted"] == r["up_bits_ledger"],
              f"{label}: predicted {r['up_bits_predicted']!r} != ledger {r['up_bits_ledger']!r}")
        check(rec["up_bits_per_step"] == pin["up_bits_per_step"]
              and r["up_bits_ledger"] == pin["up_bits_ledger"],
              f"{label}: Eq. 1 {rec['up_bits_per_step']!r}, ledger {r['up_bits_ledger']!r} "
              f"against the pins {pin}")
        want = per_call(f32_mean_xla=pin["means_per_round"] * SCALE_REAL["rounds"])
        check(launches == want, f"{label}: launches {launches} != {want}")
        print(f"{label}: {r['executed_params']} params, {SCALE_REAL['rounds']} rounds on "
              f"{r['device']}: Eq. 1 {rec['up_bits_per_step']!r} bits a client a step, ledger "
              f"{r['up_bits_ledger']!r} == the f32 replay (bit-exact, the pinned reference's); "
              f"measured/analytic x{r['measured_ratio']:.4f}; step ms {r['step_ms_warm']:.1f} "
              f"(round 1), {r['step_ms_mean']:.1f} (rounds 2 on); f32_mean_xla "
              f"{pin['means_per_round']} a round")
        out[f"{name} real"] = launches
        del run
    return out


def scale_dryrun_vs_card(dev) -> dict:
    """Phase 18b: the dry run's prediction of granite's 2 full-width layers
    (phase 15a's variant, hist, one rank of ``SCALE_LAYOUT``) against the
    card's first ``SCALE_B["steps"]`` steps: peak memory, kernel launches a
    step, step time against the roofline's estimate; then each hist kernel
    call of a further step bit-equal to its plain version."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import flat as core_flat
    from repro_torch.kernels import flat as kflat
    from repro_torch.launch import dryrun
    from repro_torch.launch.dist import build_dist_train
    from repro_torch.launch.mesh import make_host_group

    label = "scale granite dry run"
    cfg = pod_cfg("a")
    B, S, steps = SCALE_B["batch"], SCALE_B["seq_len"], SCALE_B["steps"]
    build = dict(sparsity=SCALE_B["sparsity"], fast=True, flat_engine="hist")
    shape = (1, B, S)
    meta = {k: torch.empty(shape, dtype=torch.int64, device="meta") for k in ("tokens", "labels")}
    got = dryrun.dry_train(cfg, SCALE_LAYOUT, meta, **build)
    rf = dryrun.summarize(got, cfg, "train_4k", SCALE_LAYOUT)["roofline"]
    predicted = got["argument_bytes"] + got["temp_bytes"]
    est_ms = 1e3 * (max(rf["compute_s"], rf["memory_s"]) + rf["collective_s"])
    dry_calls = {k: v["launches"] for k, v in got["kernels"].items()}
    print(f"{label}: prediction, written before the card's run: {cfg.n_layers} layers, "
          f"batch {B} x {S} on {SCALE_LAYOUT}: argument {got['argument_bytes'] / 2**30:.3f} GiB "
          f"+ temp {got['temp_bytes'] / 2**30:.3f} GiB = {predicted / 2**30:.3f} GiB peak; "
          f"kernel calls a step {dry_calls}; roofline (H100 datasheet terms) compute "
          f"{1e3 * rf['compute_s']:.2f} ms, memory {1e3 * rf['memory_s']:.2f} ms, collective "
          f"{1e3 * rf['collective_s']:.2f} ms: {est_ms:.2f} ms a step ({got['run_s']:.1f} s on "
          f"the host)")
    check(dry_calls == {k: v for k, v in SCALE_B_PER_STEP.items() if v},
          f"{label}: the dry run's kernel calls {dry_calls} != {SCALE_B_PER_STEP}")
    del got

    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    with builder_turns_tf32_off("build_dist_train"):
        fns = build_dist_train(cfg, group=make_host_group(dev), mesh_shape=SCALE_LAYOUT, **build)
    state = fns.init_state(torch.Generator().manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, shape, generator=gen, device=dev)
             for k in ("tokens", "labels")}
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    step_ms, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = fns.train_step(state, batch)
        torch.cuda.synchronize(dev)
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
    launches = kernels.launch_counts()
    measured = torch.cuda.max_memory_allocated(dev) - base
    ratio = predicted / measured
    print(f"{label}: the card's first {steps} steps: peak {measured / 2**30:.3f} GiB "
          f"(torch.cuda.max_memory_allocated above the {base / 2**30:.3f} GiB held before the "
          f"state), predicted / measured {ratio:.4f} (allowed {SCALE_PEAK_RATIO}); step ms "
          f"{[round(t, 1) for t in step_ms]} against the roofline's {est_ms:.2f}; losses "
          f"{losses}; launches {launches}")
    check(all(math.isfinite(x) for x in losses), f"{label}: losses {losses}")
    check(SCALE_PEAK_RATIO[0] <= ratio <= SCALE_PEAK_RATIO[1],
          f"{label}: predicted / measured peak {ratio:.4f} outside {SCALE_PEAK_RATIO}")
    want = {k: v * steps for k, v in SCALE_B_PER_STEP.items()}
    check(launches == want, f"{label}: launches {launches} != {want} (the dry run's)")

    # one more step, each hist kernel call held against its plain version
    names = ("seg_hist2side", "seg_moments", "seg_binarize_apply")
    calls: list = []
    with swapped(core_flat, recording(core_flat, names, calls)):
        state, _ = fns.train_step(state, batch)
    del state
    for name, args, kw in calls:
        a = getattr(kflat, name)(*args, **kw)
        b = getattr(kflat, f"{name}_plain")(*args, **kw)
        same = (all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b))
                if name == "seg_binarize_apply" else torch.equal(a, b))
        check(same, f"{label} {name}: != its plain version")
        del a, b
    check(sorted(c[0] for c in calls) == sorted(names + ("seg_hist2side",)),
          f"{label}: kernel calls {[c[0] for c in calls]}")
    print(f"{label}: a third step's {len(calls)} hist kernel calls bit-equal to their plain "
          "versions")
    del calls, fns, batch
    torch.cuda.empty_cache()
    return {"granite dry run vs card": launches}


def scale_dryrun_all(proc: subprocess.Popen) -> None:
    """Phase 18c: wait for :func:`start_dryrun`'s subprocess; its counts of
    ok, skip and error, and its seconds; any error fails."""
    try:
        rc = proc.wait(timeout=max(1.0, SCALE_DRYRUN_TIMEOUT_S
                                   - (time.perf_counter() - proc.started)))
    except subprocess.TimeoutExpired:
        stop_dryrun(proc)
        raise SmokeFailure(f"the dry run outlived {SCALE_DRYRUN_TIMEOUT_S} s")
    took = time.perf_counter() - proc.started
    text = (SCALE_DRYRUN_OUT / "dryrun.log").read_text(errors="replace")
    m = re.search(r"== dry-run: (\d+) ok / (\d+) skip / (\d+) error ==", text)
    check(rc == 0 and m is not None, f"the dry run exited {rc}:\n{text[-3000:]}")
    ok, skip, err = (int(g) for g in m.groups())
    for path in sorted(SCALE_DRYRUN_OUT.glob("*.json")):
        rec = json.loads(path.read_text())
        if rec["status"] == "ok":
            mem, rf = rec["memory"], rec["roofline"]
            print(f"dry run {rec['arch']} {rec['shape']}: args {mem['argument_bytes'] / 2**30:.3f}"
                  f" GiB, temp {mem['temp_bytes'] / 2**30:.3f} GiB, {rf['dominant']} "
                  f"(C {rf['compute_s']:.4g} s, M {rf['memory_s']:.4g} s, X "
                  f"{rf['collective_s']:.4g} s), kernels {rec['kernels']}, {rec['run_s']} s")
    print(f"dry run {' '.join(SCALE_DRYRUN)}: {ok} ok / {skip} skip / {err} error in "
          f"{took:.1f} s (records in {SCALE_DRYRUN_OUT.relative_to(ROOT)})")
    check(err == 0 and ok > 0, f"the dry run: {err} errors")


def scale_phase(dev, proc: subprocess.Popen) -> dict:
    """Phase 18: (a) ``plan_real`` on the card, (b) the dry run against the
    card, (c) the dry run of the zoo (``proc``, started after phase 1)."""
    launches = scale_real(dev)
    launches.update(scale_dryrun_vs_card(dev))
    scale_dryrun_all(proc)
    return launches


# ---------------------------------------------------------------- phase 19

SURFACE_ROUNDS = 3
SURFACE_LOCAL = dict(preset="lm-100m", backend="local", clients=4, batch=4, seq_len=128,
                     sparsity=0.001, rounds=SURFACE_ROUNDS)
# f32_mean_xla a round: flat, one a segment; per leaf (fast off, or a bf16
# residual, which the flat path does not take), two a leaf and client
SURFACE_LOCAL_PER_ROUND = {"fast": per_call(f32_mean_xla=LM100M_LEAVES),
                           "per_leaf": per_call(f32_mean_xla=2 * LM100M_LEAVES * 4),
                           "bf16": per_call(f32_mean_xla=2 * LM100M_LEAVES * 4)}
SURFACE_GSPMD = dict(SURFACE_LOCAL, backend="gspmd", fast=True, flat_engine="hist")
SURFACE_FED = dict(FED, fast=True, rounds=2)
SURFACE_CKPT = ROOT / "build" / "surface_ckpt.npz"
SURFACE_EXAMPLES = (("torch_quickstart", []), ("torch_federated_wire", []),
                    ("torch_sparsity_tradeoff", []), ("torch_serve_batched", []),
                    ("torch_train_lm_100m", ["--rounds", "3"]))
SURFACE_EXAMPLE_TIMEOUT_S = 300


def _leaves_of(tree) -> list:
    """A tree's tensors in key order, through dicts, NamedTuples (Adam's
    state), tuples and lists."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_of(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves_of(v)]
    return [tree]


def _same_leaves(a, b) -> bool:
    """Two trees' leaves equal bit for bit, dtype and shape included."""
    import torch

    la, lb = _leaves_of(a), _leaves_of(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y) for x, y in zip(la, lb))


def _counted_rounds(step, state, rounds: int, label: str, per_round: dict) -> tuple:
    """``rounds`` rounds of ``step(state, r) -> (state, metrics)`` with the
    launch counts set to 0 just before and read just after; every round's
    counts must be ``per_round``.  Returns ``(state, metrics, step ms,
    launches)``."""
    import torch
    from repro_torch import kernels

    torch.cuda.synchronize()
    kernels.reset_launches()
    metrics, step_ms, counts = [], [], []
    for r in range(rounds):
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, r)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        after = kernels.launch_counts()
        counts.append({k: after[k] - before[k] for k in after})
        metrics.append(m)
        print(f"{label} round {r + 1}: loss {loss:.6f}  step {step_ms[-1]:.3f} ms  "
              f"launches {counts[-1]}")
    check(all(math.isfinite(float(m["loss"])) for m in metrics), f"{label}: a loss not finite")
    check(all(c == per_round for c in counts), f"{label}: launches per round {counts}")
    return state, metrics, step_ms, kernels.launch_counts()


def surface_legacy(dev) -> dict:
    """Phase 19a: lm-100m at full width through the legacy
    ``DSGDTrainer(fast=True)`` (4 clients, batch 4 x 128, p = 0.001, 3
    rounds) beside ``build_run(RunSpec(backend="local", fast=True))`` on
    the same batches: params, residuals and each round's Eq. 1 bits bit
    for bit (the reference's shim contract); then the trainer with
    ``fast=False`` and with ``residual_dtype=torch.bfloat16`` (per leaf,
    as the reference's flat residual is f32 only).  Prints each path's
    ``f32_mean_xla`` launches a round and step ms.  Returns each path's
    launches."""
    import warnings

    import torch
    from repro_torch.core.api import make_compressor
    from repro_torch.optim import get_optimizer
    from repro_torch.run import RunSpec, build_run, lr_schedule
    from repro_torch.train import DSGDTrainer

    spec = RunSpec(**SURFACE_LOCAL, fast=True)
    run = build_run(spec, device=dev)
    out = {}

    def trainer(**fields):
        with warnings.catch_warnings():  # the legacy surface warns; that is its contract
            warnings.simplefilter("ignore", DeprecationWarning)
            return DSGDTrainer(model=run.model, compressor=make_compressor(spec.compressor),
                               optimizer=get_optimizer(run.cfg.local_opt),
                               n_clients=spec.clients, lr=lr_schedule(run.cfg.base_lr),
                               device=dev, **fields)

    def steps(tr):
        return lambda state, r: tr.step(state, run.batch_fn(r), r, n_delay=spec.delay,
                                        sparsity=spec.sparsity)

    want, want_m, want_ms, _ = _counted_rounds(run.step, run.init(), spec.rounds,
                                               "19a build_run(fast=True)",
                                               SURFACE_LOCAL_PER_ROUND["fast"])
    for path, fields in (("fast", dict(fast=True)), ("per_leaf", dict(fast=False)),
                         ("bf16", dict(fast=True, residual_dtype=torch.bfloat16))):
        tr = trainer(**fields)
        label = f"19a DSGDTrainer({', '.join(f'{k}={v}' for k, v in fields.items())})"
        state, metrics, step_ms, out[path] = _counted_rounds(
            steps(tr), tr.init(None, spec.seed), spec.rounds, label,
            SURFACE_LOCAL_PER_ROUND[path])
        flat = isinstance(state.comp_state.residual, torch.Tensor)
        check(flat == (path == "fast"), f"{label}: the flat residual is {flat}")
        if path == "bf16":
            check(all(v.dtype == torch.bfloat16
                      for v in tr.resolved(state.params)._leaves_of(state.comp_state.residual)),
                  f"{label}: the residual is not bf16")
        if path == "fast":
            check(_same_leaves(state.params, want.params)
                  and _same_leaves(state.comp_state.residual, want.comp_state.residual)
                  and [float(m["bits_per_client"]) for m in metrics]
                  == [float(m["bits_per_client"]) for m in want_m],
                  f"{label}: params, residuals or Eq. 1 bits != build_run's")
            print(f"{label}: params, residuals and Eq. 1 bits "
                  f"{float(metrics[0]['bits_per_client'])!r} a client a round == "
                  f"build_run(RunSpec(fast=True))'s, bit for bit")
        print(f"{label}: f32_mean_xla {out[path]['f32_mean_xla'] // spec.rounds} a round; "
              f"step ms (rounds 2 on) {_rounds_ms(step_ms)} (build_run's "
              f"{_rounds_ms(want_ms)})")
        del tr, state, metrics
        torch.cuda.empty_cache()
    del run, want
    torch.cuda.empty_cache()
    return out


def surface_gspmd(dev) -> dict:
    """Phase 19b: lm-100m at full width on the GSPMD hist engine, one rank,
    through ``build_run`` (batch 4 x 128, p = 0.001), 3 rounds (2/1/1 + 1
    a round, each hist kernel call == its plain version on the path's
    operands); ``evaluate`` finite; ``checkpoint`` to ``build/``, restored
    into a fresh state; a 4th round from the restored state == the live
    run's 4th round bit for bit.  Prints the checkpoint's ms and bytes,
    then profiles one more round.  Returns the 3 rounds' launches."""
    import torch
    from repro_torch.checkpoint.io import load_pytree
    from repro_torch.run import RunSpec, build_run

    label = "19b lm-100m gspmd hist"
    run = build_run(RunSpec(**SURFACE_GSPMD), device=dev)
    cap = drive(run, "exchange_local_hist", HIST_PER_ROUND, label, rounds=SURFACE_ROUNDS)
    hist_kernels_vs_plain(cap["acc"], run.fns.flat_space, dev, label)
    state, launches = cap["state"], cap["launches"]
    del cap
    t0 = time.perf_counter()
    ev = run.evaluate(state)
    eval_ms = (time.perf_counter() - t0) * 1e3
    check(math.isfinite(ev["loss"]), f"{label}: evaluate gave {ev}")
    SURFACE_CKPT.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    run.checkpoint(state, str(SURFACE_CKPT))
    ckpt_ms = (time.perf_counter() - t0) * 1e3
    size = SURFACE_CKPT.stat().st_size
    t0 = time.perf_counter()
    restored = load_pytree(str(SURFACE_CKPT), like=run.init())
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    SURFACE_CKPT.unlink()
    check(_same_leaves(restored, state), f"{label}: the restored state != the live state")
    live, live_m = run.step(state, SURFACE_ROUNDS)
    del state
    back, back_m = run.step(restored, SURFACE_ROUNDS)
    check(_same_leaves(back, live) and float(back_m["loss"]) == float(live_m["loss"]),
          f"{label}: round {SURFACE_ROUNDS + 1} from the checkpoint != the live run's")
    print(f"{label}: evaluate {ev['loss']:.6f} (held-out, {eval_ms:.1f} ms); checkpoint "
          f"{size} bytes in {ckpt_ms:.1f} ms, restored in {load_ms:.1f} ms; round "
          f"{SURFACE_ROUNDS + 1} from it == the live run's (params, Adam state, residual, "
          f"loss {float(live_m['loss']):.6f}), bit for bit")
    del back, restored
    profiled_round(run, live, label)
    del run, live
    torch.cuda.empty_cache()
    return launches


def surface_fed(dev) -> dict:
    """Phase 19c: ``FedRun.evaluate`` after phase 9's LeNet5 fed spec (8
    clients, cohorts of 4, flat) for 2 rounds through ``build_run``: a
    finite held-out loss, and the server's params are what it evaluates.
    Returns the rounds' launches."""
    from repro_torch.run import RunSpec, build_run

    label = "19c fed LeNet5"
    run = build_run(RunSpec(**SURFACE_FED), device=dev)
    state, metrics, step_ms, launches = _counted_rounds(run.step, run.init(),
                                                        SURFACE_FED["rounds"], label,
                                                        FED_PER_ROUND[True])
    ev = run.evaluate(state)
    check(math.isfinite(ev["loss"]), f"{label}: evaluate gave {ev}")
    check(run.params_of(state) is state.server.params, f"{label}: params_of is not the server's")
    print(f"{label}: evaluate {ev['loss']:.6f} (held-out) after {len(metrics)} rounds; round "
          f"ms {', '.join(f'{x:.3f}' for x in step_ms)}")
    return launches


def surface_examples() -> dict:
    """Phase 19d: each of the five ``examples/torch_*.py`` in a subprocess
    on the card (the default device), ``torch_train_lm_100m`` at
    ``--rounds 3``: each exits 0 and prints its ✓ lines.  Returns each
    example's seconds."""
    import os

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    seconds = {}
    for name, argv in SURFACE_EXAMPLES:
        t0 = time.perf_counter()
        try:
            out = subprocess.run([sys.executable, str(ROOT / "examples" / f"{name}.py"), *argv],
                                 capture_output=True, text=True, env=env, cwd=str(ROOT),
                                 timeout=SURFACE_EXAMPLE_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            raise SmokeFailure(f"19d {name}: outlived {SURFACE_EXAMPLE_TIMEOUT_S} s")
        seconds[name] = round(time.perf_counter() - t0, 1)
        ticks = [line.strip() for line in out.stdout.splitlines() if "✓" in line]
        check(out.returncode == 0 and ticks,
              f"19d {name}: exit {out.returncode}, no ✓ line:\n{out.stdout[-2000:]}\n"
              f"{out.stderr[-3000:]}")
        print(f"19d {name} {' '.join(argv)}: exit 0 in {seconds[name]} s; " + "; ".join(ticks))
    return seconds


def surface_phase(dev) -> dict:
    """Phase 19, the public surface: 19a-d.  Returns each path's launches
    (19a's three trainer paths, 19b's hist rounds, 19c's fed rounds)."""
    import torch

    t0 = time.perf_counter()
    out = {f"legacy_{k}": v for k, v in surface_legacy(dev).items()}
    out["gspmd_hist"] = surface_gspmd(dev)
    out["fed_evaluate"] = surface_fed(dev)
    torch.cuda.empty_cache()
    seconds = surface_examples()
    print(f"phase 19: {time.perf_counter() - t0:.1f} s (examples {seconds})")
    return out


def compare(src: Path) -> int:
    """``--compare SRC``: the kernels redesigned last, timed with the
    package under ``SRC`` (the ``src`` of another checkout, such as the
    parent commit's) on seeded operands, so that two versions can be
    compared on one card, in turns: ``f32_mean_xla`` at every shape in
    ``MEAN_SHAPES``, and the per-leaf ``hist2side`` (both passes) and
    ``masked_moments`` (at each of ``MOMENT_TILES``) of
    ``sbc_compress_hist`` over a seeded Gaussian leaf of f1's size.  Every
    call is checked against its plain version; prints one
    ``{"compare": ...}`` line."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: no CUDA card")
    check((src / "repro_torch").is_dir(), f"no repro_torch package under {src}")
    sys.path.insert(0, str(src.resolve()))
    from repro_torch.kernels import _build
    from repro_torch.kernels import hist2side as khist
    from repro_torch.kernels import moments as kmom
    from repro_torch.kernels import ops

    card = card_line()
    print(f"card: {card}; package {src}")
    _build.build()
    _build.library()
    dev = torch.device("cuda", 0)
    shapes = mean_shapes(dev)
    leaf = torch.from_numpy(np.random.default_rng(0).standard_normal(1_225_000)
                            .astype(np.float32)).to(dev)
    calls: list = []
    with swapped(ops, recording(ops, ("hist2side", "masked_moments"), calls)):
        ops.sbc_compress_hist(leaf, p=SPEC["sparsity"], bm=8, lanes=128)
    check([c[0] for c in calls] == ["hist2side", "hist2side", "masked_moments"],
          f"sbc_compress_hist called {[c[0] for c in calls]}")
    passes = {}
    for name, (_, args, kwargs) in zip(("coarse", "zoomed"), calls[:2]):
        check(torch.equal(khist.hist2side(*args, **kwargs),
                          khist.hist2side_plain(*args, **kwargs)),
              f"hist2side ({name} pass): kernel != plain")
        copies = [(args[0].clone(), *args[1:]) for _ in range(copies_past_l2(4 * leaf.numel()))]
        label = f"hist2side ({name} pass)"
        counted: list = []
        us = 1e3 * device_ms(lambda *a: khist.hist2side(*a, **kwargs), copies, 240, label,
                             counted=counted)
        passes[name] = {"us": us, "ops": counted[0]}
        print(f"{label}: {us:.2f} us device per call, {counted[0]:g} device operations")
        del copies
    moments = {}
    _, args, _ = calls[2]
    for bm, lanes in MOMENT_TILES:
        kw = dict(bm=bm, lanes=lanes)
        check(bit_equal(kmom.masked_moments(*args, **kw), kmom.masked_moments_plain(*args, **kw)),
              f"masked_moments at bm={bm}, lanes={lanes}: kernel != plain")
        copies = [(args[0].clone(), *args[1:]) for _ in range(copies_past_l2(4 * leaf.numel()))]
        label = f"masked_moments (bm={bm}, lanes={lanes})"
        counted = []
        us = 1e3 * device_ms(lambda *a, kw=kw: kmom.masked_moments(*a, **kw), copies, 240,
                             label, counted=counted)
        moments[f"{bm}x{lanes}"] = {"us": us, "ops": counted[0]}
        print(f"{label}: {us:.2f} us device per call, {counted[0]:g} device operations")
        del copies
    print(json.dumps({"compare": {"src": str(src), "card": card, "f32_mean_xla": shapes,
                                  "hist2side": passes, "masked_moments": moments}}))
    return 0


def main(argv: list) -> int:
    import torch

    if argv[:1] == ["--compare"] and len(argv) == 2:
        return compare(Path(argv[1]))
    if argv[:1] == ["--rank-worker"] and len(argv) == 5:
        return rank_worker(int(argv[1]), int(argv[2]), argv[3], argv[4])
    if argv[:1] == ["--pod-rank-worker"] and len(argv) == 5:
        return pod_rank_worker(int(argv[1]), int(argv[2]), argv[3], argv[4])
    if argv[:1] == ["--fsdp-rank-worker"] and len(argv) == 5:
        return fsdp_rank_worker(int(argv[1]), int(argv[2]), argv[3], argv[4])
    if argv[:1] == ["--serve-rank-worker"] and len(argv) == 5:
        return serve_rank_worker(int(argv[1]), int(argv[2]), argv[3], argv[4])
    decoder_only, zoo_only, pod_only = argv == ["--decoder"], argv == ["--zoo"], argv == ["--pod"]
    fsdp_only, serve_only = argv == ["--fsdp"], argv == ["--dist-serve"]
    scale_only, surface_only = argv == ["--scale"], argv == ["--surface"]
    check(not argv or decoder_only or zoo_only or pod_only or fsdp_only or serve_only
          or scale_only or surface_only,
          f"usage: {Path(__file__).name} [--compare SRC | --decoder | --zoo | --pod | --fsdp | "
          f"--dist-serve | --scale | --surface]; got {argv}")
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: no CUDA card")
    check((ROOT / "src" / "repro_torch").is_dir(),
          f"no src/repro_torch beside {Path(__file__).name}: run it from a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)

    # ---- 1. card and build
    card = card_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    libs = _build.build()
    _build.library()
    print(f"built {[str(p.relative_to(ROOT)) for p in libs]} in "
          f"{time.perf_counter() - t0:.2f} s")

    # phase 18c's dry run of the zoo, CPU work on meta tensors, runs beside
    # the card's phases from here and is read in phase 18
    dry = None if (decoder_only or zoo_only or pod_only or fsdp_only or serve_only
                   or surface_only) else start_dryrun()
    if dry is not None:  # a failing phase leaves no process behind
        atexit.register(stop_dryrun, dry)

    if decoder_only:  # phase 12 alone
        print(json.dumps({"launches_decoder": decoder_phase(dev)}))
        return 0
    if zoo_only:  # phases 13 and 14 alone
        moe = zoo_phase(dev)
        print(json.dumps({"launches_moe": moe, "launches_encdec": encdec_phase(dev)}))
        print(card)
        return 0
    if pod_only or fsdp_only or serve_only or scale_only or surface_only:
        # phase 15, 16, 17, 18 or 19 alone
        key, phase = (("launches_pod", pod_phase) if pod_only else
                      ("launches_fsdp", fsdp_phase) if fsdp_only else
                      ("launches_dist_serve", dist_serve_phase) if serve_only else
                      ("launches_surface", surface_phase) if surface_only else
                      ("launches_scale", lambda dev: scale_phase(dev, dry)))
        print(json.dumps({key: phase(dev)}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # ---- 2. to 7. the paths, one client
    rows, hist = hist_path(dev)
    rows.update(exact_path(dev))
    rows.update(leaf_path(dev, hist))
    codec = codec_path(dev)
    local = local_path(dev)["launches"]
    charlstm = charlstm_phase(dev)

    # ---- 8. clients across ranks
    nccl_world_one(dev)
    multi = multi_rank_phase(dev)

    # ---- 9. federation
    fed, fed_down = fed_phase(dev)

    # ---- 10. the paper's baselines, ResNet-32 and WordLSTM
    baselines = table2_phase(dev)
    resnet32 = resnet32_phase(dev)
    wordlstm = wordlstm_phase(dev)

    # ---- 11. delta broadcast
    broadcast = broadcast_phase(dev, fed_down)
    check(set(rows) == set(KERNELS), f"kernels compared: {sorted(rows)}")
    rows["f32_mean_xla"]["launches_local_per_leaf_path"] = local[False]["f32_mean_xla"]
    rows["f32_mean_xla"]["launches_local_flat_path"] = local[True]["f32_mean_xla"]
    # each kernel's launches in the five rounds of each CharLSTM path
    for name in KERNELS:
        rows[name]["launches_charlstm"] = {path: counts[name]
                                           for path, counts in charlstm.items()}
        # and in the five rounds of each multi-rank path, on rank 0
        rows[name]["launches_multi_rank"] = {path: counts[name]
                                             for path, counts in multi.items()}
    # the codec + wire path is the one that launches seg_select_pack (4 a
    # round) and most f32_mean_xla; the exact path's counts stay beside them
    for name in ("seg_select_pack", "f32_mean_xla"):
        rows[name]["launches_exact_path"] = rows[name]["launches"]
        rows[name]["launches"] = codec["launches"][name]
    rows["seg_select_pack"]["leaf_us"] = codec["select_us"]
    # f32_mean_xla's launches in the rounds of each fed path
    rows["f32_mean_xla"]["launches_fed"] = fed
    # phase 10's launches, on the rows its paths launch
    for name in KERNELS:
        for key, paths in (("launches_baselines", baselines["launches"]),
                           ("launches_resnet32", resnet32), ("launches_wordlstm", wordlstm)):
            counts = {path: c.get(name, 0) for path, c in paths.items()}
            if any(counts.values()):
                rows[name][key] = counts
    # the variance upload's device pack, a check made after its rounds
    rows["seg_select_pack"]["launches_variance_pack_check"] = baselines["variance_pack"]
    # phase 11's launches, on every row: the broadcast paths launch
    # f32_mean_xla only (the server's downstream compress)
    for name in KERNELS:
        rows[name]["launches_broadcast"] = {path: counts.get(name, 0)
                                            for path, counts in broadcast.items()}

    # ---- 12. the dense decoders: lm-100m's training, gemma3-1b's serving
    decoder = decoder_phase(dev)
    for name in KERNELS:
        counts = {path: c.get(name, 0) for path, c in decoder.items()}
        if any(counts.values()):
            rows[name]["launches_decoder"] = counts

    # ---- 13. the MoE and recurrent decoders: mixtral's training, the
    # four configs' serving
    moe = zoo_phase(dev)
    # ---- 14. the rest of the zoo: seamless's and phi-3-vision's training
    # and serving, the non-IID fed run
    encdec = encdec_phase(dev)
    for name in KERNELS:
        for key, paths in (("launches_moe", moe), ("launches_encdec", encdec)):
            counts = {path: c.get(name, 0) for path, c in paths.items()}
            if any(counts.values()):
                rows[name][key] = counts

    # ---- 15. pod mode and the "model" axis: granite on 256 shards, two pods
    # on the card, mixtral at its own dtypes
    pod = pod_phase(dev)
    for name in KERNELS:
        counts = {path: c.get(name, 0) for path, c in pod["launches"].items()}
        if any(counts.values()):
            rows[name]["launches_pod"] = counts
        if name in pod["bound_ms"]:
            rows[name]["bound_ms_pod_256_shards"] = pod["bound_ms"][name]

    # ---- 16. one rank a device: granite's 2 layers over 4 ranks, two pods
    # of two ranks
    fsdp = fsdp_phase(dev)
    for name in KERNELS:
        counts = {path: c.get(name, 0) for path, c in fsdp.items()}
        if any(counts.values()):
            rows[name]["launches_fsdp"] = counts

    # ---- 17. serving across ranks: granite's and rwkv6's caches cut over 4
    # ranks (no hand kernel: every row holds its zeros)
    dist_serve = dist_serve_phase(dev)
    for name in KERNELS:
        rows[name]["launches_dist_serve"] = {path: c.get(name, 0)
                                             for path, c in dist_serve.items()}

    # ---- 18. the scale planner's real runs, the dry run against the card,
    # the dry run of the zoo
    scale = scale_phase(dev, dry)
    for name in KERNELS:
        rows[name]["launches_scale"] = {path: c.get(name, 0) for path, c in scale.items()}

    # ---- 19. the public surface: the legacy trainer and the run verbs at
    # lm-100m's width, FedRun.evaluate, the five examples
    surface = surface_phase(dev)
    for name in KERNELS:
        counts = {path: c.get(name, 0) for path, c in surface.items()}
        if any(counts.values()):
            rows[name]["launches_surface"] = counts

    # ---- 20. results
    print(json.dumps({"kernels": [rows[k] for k in KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
