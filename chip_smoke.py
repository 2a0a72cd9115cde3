"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a card:

    python3 chip_smoke.py

Phases (any failure exits nonzero):

1. environment: versions and the card's name and power limit; builds
   every CUDA kernel of the port from ``horovod_tpu_torch/ops/csrc``
   (one nvcc per source, all started together) and prints ptxas's
   registers, shared memory and spills of K4 / K5 / K6 at D 64; profiles
   one loss forward + backward for phase 5 (before any other profiler
   session in the process).
2. kernel vs plain: the paged-attention kernel (K1) against its plain
   PyTorch version at Llama_1B head shapes (H 32, KV 4, D 64, block 16)
   for the decode (T = 1, the split-KV design) and prefill (T = 128, 512,
   the tensor-core design in bf16) steps, bf16 and fp32, with -1 table
   entries, shared and copy-on-write blocks and mid-block positions; one
   long request (B 1, L 2048), rows ending on the key ranges' bounds,
   inactive all -1 rows, G = 1 (GPT-2's 12 heads), D 8, 16, 24, 32, 48,
   96 and 128, D 4, 5 and 12 (zero-padded to a multiple of 8 by the
   wrapper), a prefill after a prefix hit (T 128 at pos 256), the
   speculative verify step (B 8, T 4 = spec_k + 1: 32 rows a kv head, the
   prefill design; also with NaN bytes, inactive rows and D 5), NaN bytes
   wherever no query may look, and two calls bit for bit
   (``paged.check_against_plain``: fp32 max |err| <= 1e-4; bf16 every
   element within 2^-7 (|ref| + sum_j p_j |v_j|) + 1e-4 and ||err|| /
   ||ref|| <= 1e-2); then its times at decode B 8 and B 1, L 2048,
   prefill B 8, T 512, the verify step B 8, T 4, L 2048, and at decode B
   8 and prefill B 8 at D 48, D 4 (with the wrapper's pad copy) and D 8
   (host loop and CUDA graph) beside the plain version, one
   ``scaled_dot_product_attention`` call on the gathered KV (yardstick
   only) and the bound (bytes over 3.35 TB/s).
3. serve, full width, bf16: Llama_1B (22 layers, random weights from a
   seed), max_batch 8, block 16, max_len 2048, buckets (128, 512),
   prefix cache on; greedy requests of 64-500 prompt tokens (half share
   a 256-token system prompt), 32 new tokens each, one through
   ``POST /generate``. All must finish ok, through the CUDA kernel, and
   every executor step of the burst must be a CUDA-graph replay with
   ``jit_cache_size()`` the same before and after. Prints the graphs,
   each signature's capture ms, the warm-up's seconds, the phase's peak
   memory, step p50 by kind (traffic only), tokens/s, and a hot swap's ms
   at full width (the same weights as version 2).
4. stream parity, full width, fp32: the same requests through the kernel
   path and through the plain path; streams must be identical except a
   divergence whose first differing step has a plain-path top-2 logit
   gap < 1e-3 (printed, not a failure).

5. CE kernels vs plain: K2 / K3 (fused softmax cross entropy, forward
   and backward, one launch each way, through autograd with int64
   labels as the main path calls them) against their plain PyTorch
   versions at [128, 1000] fp32 (the ResNet head of phase 6), [8192,
   32000] bf16 and fp32 (the Llama_1B LM head), and [7, 33] fp32 / [300,
   1000] bf16 with -1 labels (``ce.check_against_plain``: loss and lse
   max |err| <= 1e-5 in both dtypes; dlogits max |err| <= 1e-6 fp32, bf16
   every element within 2^-7 |ref| + c |g / T|); int32 labels and a
   second call give the same bits; at the first two shapes two CUDA
   graphs captured before either is replayed, replayed in the other
   order and on two streams, equal the eager call; at the first ``loss
   /= 4`` then ``backward()`` gives a quarter of the gradient; a profiled
   loss forward + backward runs two kernels, K2 and K3. Then their times
   at both heads beside the plain versions, ``F.cross_entropy`` forward
   and backward (yardstick only; host loop and graph) and the bound
   (bytes over 3.35 TB/s); and the loss as the main path calls it (int64
   labels, the mean, forward and forward + backward) against
   ``F.cross_entropy`` the same way.
6. train, full width, bf16: ``hvd.init()`` (one rank over NCCL),
   ResNet-50 (conv7 stem, 1000 classes, random weights from a seed),
   224x224, batch 128, SGD(0.01, momentum 0.9) in DistributedOptimizer,
   parameters and optimizer state broadcast from rank 0; one synthetic
   batch from the seed, 3 warm-up and 20 timed steps. Every loss must be
   finite, the mean of the last 5 below the mean of the first 5, and K2
   and K3 launched once per step.
7. train-step parity, fp32 (no TF32, deterministic cuDNN): one ResNet-50
   step at batch 16 from the same weights through the kernel loss and
   through the plain loss; losses within 1e-5 relative, parameters
   within 1e-3 of the largest update.

8. flash attention kernels vs plain: K4 / K5 / K6 (forward, dq, dk / dv)
   against their plain PyTorch versions, fp32 and bf16, causal and not,
   G = 1, 8 and 16, a ragged S (50), Sq != Skv (48 x 33), a ragged causal
   S 2100 (K6's pieces split the query range, some empty), D 8, 16, 24,
   32, 48, 96 and 128, D 4, 5 and 12 (zero-padded to a multiple of 8 by
   the wrapper; D 64 elsewhere), and both main-path shapes in
   bf16 (Llama_1B B 4, H 32, KV 4, S 2048; GPT-2-small B 8, H 12, S
   1024), each at the
   scale 1 / sqrt(D), the backward with a live lse cotangent; then
   flash_attention_lse through autograd (max |err| <= 1e-4 fp32 on o and
   lse, <= 2e-4 x max|ref| on dq / dk / dv; bf16 per element <= 2^-7 x
   (|ref| + the sum of absolute terms behind it) + 1e-4, and ||err|| /
   ||ref|| <= 1e-2); K4, K5 and K6 twice bit for bit;
   then their times at both main-path shapes, and at Llama_1B's with D
   48, D 4 (with the pad copy) and D 8 (host loop, CUDA graph)
   beside the plain versions, SDPA forward and backward (yardstick only;
   host loop and CUDA graph) and the bounds, with K5 + K6 (all of K6's
   launches) against the SDPA backward and K6's scratch bytes.
9. LM training, full width, bf16: Llama_1B (22 layers, 32 / 4 heads,
   head_dim 64, vocab 32000, mlp 5504, fp32 parameters) from
   ``build_lm_train_step``, batch 4 x seq 2048, AdamW(1e-3, weight decay
   1e-4) in DistributedOptimizer over one NCCL rank, fused CE on fp32
   logits; 3 warm-up and 10 timed steps on a fixed seeded batch. Losses
   finite and falling (last-5 median below first-5 median, so that one
   step's spike cannot decide it); K4 / K5 / K6 launched 22 times per
   step, K2 / K3 once.
10. the same for GPT-2-small at the reference's bench defaults (12
    layers, 12 heads, seq 1024, batch 8, vocab 50304), 3 + 10 steps (the
    recipe's loss spikes for one step at step 6, on the plain attention
    path too).
11. LM train-step parity, fp32: Llama at full width, 2 layers, seq 512,
    batch 2, one SGD step through K4-K6 and K2 / K3 and one through the
    plain attention and plain CE from the same weights; losses within
    1e-5 relative, parameters within 1e-3 of the largest update.
12. sampled and speculative serve, full width, bf16: phase 3's stack
    (its target paged through K1) with a slotted self-draft of the same
    weights (the reference's bench configuration) at spec_k 3; phase 3's
    requests, the odd ones and the one through ``POST /generate`` sampled
    (temperature 0.8, top_p 0.9, seeds from the run's seed), the rest
    greedy, 32 new tokens each. All must finish ok, K1 must run in every
    verify step (one launch a layer), and the first sampled request
    longer than 128 tokens, submitted again in another batch at another
    row, must give the same stream. Every step of the target and of the
    drafter in the burst must be a graph replay, and neither adds a
    graph. Prints the accept rate, target steps per generated token,
    tokens/s, step p50 by kind (the drafter's too), the graphs and
    capture ms of both executors, warm-up seconds and peak memory.
13. speculative stream parity, full width, fp32: greedy speculation
    through K1 with the self-draft, and with a rejecting drafter (a
    2-layer Llama of the same width from another seed), against phase
    4's target-only greedy streams through K1 by phase 4's rule; sampled
    speculation through K1 against the same on the plain path: identical
    except a divergence whose first differing step's target logits
    differ between the runs by less than 1e-3 (printed, not a failure).
    Prints each run's accept rate.
14. captured steps, fp32, Llama_1B's width at 2 layers: for each
    signature (the target's decode, prefill 128 and verify T 4, the
    drafter's decode and prefill 128, each greedy and sampled) the first
    replay's outputs (tokens, ``last_logits``, the drafter's probs) equal
    the eager body's on the same staged inputs and cache state bit for
    bit (else the largest difference is printed and tokens may differ
    only at a top-2 gap under 1e-3), and each target replay counts one
    K1 launch a layer. Then 4 requests served, ``swap_params`` to
    another seed's weights (version 2), the same 4 served again: the
    streams equal a fresh executor's on the second weights, no graph is
    added, and a re-submitted version 2 is refused.
15. KV integrity and the KV tier, full width, bf16: phase 3's stack with
    ``kv_crc=True``, the KV tier (host ring 8 MiB, a temporary spill
    directory) and a chaos plan (one ``serve.kv`` corrupt at iteration
    3, one ``kvtier.promote`` corrupt at burst B's last promotion, both
    printed). Burst A: phase 3's 9 requests, three carrying a minted
    ``TraceContext``; every refcount-zero run evicted down the ladder;
    burst B: the five shared-prefix requests return and promote from
    the host ring and from disk; every run evicted again; a hot swap to
    the same weights at version 2; burst C: the five again. Baseline: the
    same bursts with ``kv_crc`` off and no plan, in the same process,
    the five cold. Checks: one KV corruption injected and one detected,
    its request re-prefilled; bursts A-C give the baseline streams by
    phase 4's rule; the promote corrupt caught before any device byte
    (``hvd_serve_kvtier_corrupt_total`` 1); every promoted block's bytes
    re-read from the pool match their demoted crc32s; burst C promotes
    nothing and the host ring is empty after the swap; each traced
    request has its queue_wait / prefill / decode spans, queue_wait +
    prefill within 1 ms of its TTFT; every step a replay, graphs flat.
    Prints step p50 with ``kv_crc`` on and off, the ledger's ms a step,
    verify-on-read ms per retiring request, demote and promote ms per
    block, each rung's counts and bytes, TTFT of the returning requests
    against the same prompts cold, peak memory, each with the card; and
    under ``--profile`` the ledger's device-to-host copies and host
    syncs per decode step.
16. the in-process serving fleet, full width, bf16: two Llama_1B
    replicas (``replica_id`` 0 and 1, phase 15's stack each: prefix
    cache, ``kv_crc``, the KV tier with a host ring of 8 MiB and a spill
    directory of its own) behind ``FleetRouter`` (the router's default
    heartbeat 0.25 s / suspect 1.0 s) and ``make_fleet_server``, one fp32
    copy of the seeded weights loaded into both, a ``WeightSubscriber``
    each on a ``WeightPublisher``'s channel in an in-process
    ``StoreServer`` (version 1 at start). The reference: phase 3's 9
    requests on replica 0's executor alone. Four bursts, one request of
    each through ``POST /generate``: (1) fan-out, the 9 twice over; (2) a
    ``serve.step`` crash on replica 0 three iterations in, version 2
    published through the stream just before: it is ejected within the
    suspect threshold, its
    requests re-queued once onto replica 1, it is rebuilt over its
    executor with no capture and re-admitted on version 2; (3) the 5
    shared-prefix requests served on replica 0, its runs demoted to its
    ladder, then returning while a ``serve.route`` partition cuts replica
    0 off: they land on replica 1, the router pulls the runs (the first
    payload corrupted on its way and refused by the crc gate), every
    installed block re-reads with its demoted crc32; (4) SIGTERM
    mid-burst: the drain sheds new submits with ``retry_after_ms`` (429
    with ``Retry-After`` over HTTP), finishes the tail and stops the
    replicas. Every handle is answered exactly once; the streams of
    bursts 1-3 equal the one-replica streams except a divergence at a
    step whose logits, in the two runs, differ by more than the
    one-replica run's top-2 gap and by at most 2^-5 of the row's largest
    |logit|; each replica counts one K1 launch a layer a replay and adds
    no graph. Prints the ``fleet`` line: tokens/s beside phase 3's, router
    dispatch and e2e p50 / p99, failover ms, re-admission s, re-queued /
    duplicates / rejected, pulls with their blocks and ms, each replica's
    K1 launches, replays and graphs before and after, peak memory.
17. the process fleet, full width, bf16: one port ``StoreServer`` (the
    native library, g++ from ``csrc/``), ``ProcessFleetRouter`` over two
    worker processes (``python -m horovod_tpu_torch.serve.worker``, each
    its own CUDA context; the router's defaults 0.25 s / 1.0 s) and
    ``make_fleet_server``; each worker runs ``llama_builder`` (Llama_1B
    from phase 3's seed) in phase 15's stack (prefix cache, ``kv_crc``,
    the tier with a host ring of 8 MiB, a spill directory each). The
    reference: phase 3's 9 requests on one replica's stack in this
    process, freed before anything spawns. Four bursts, one request of
    each through ``POST /generate``: (1) fan-out, the 9 twice over; (2)
    a ``serve.proc`` crash armed in replica 0 (its endpoint's ``chaos``
    op) three iterations into the burst, a real SIGKILL: ejected within
    2 x suspect, its requests moved once onto replica 1, generation 1
    spawned, warmed up and re-admitted; (3) a ``serve.dispatch`` window
    (a ``conn_reset``, two ``flaky`` drops) on replica 1's socket,
    absorbed by the ladder with no failover, the replay served from the
    worker's dedupe cache; (4) SIGTERM mid-burst: the drain sheds new
    submits (429 with ``Retry-After`` over HTTP), finishes the tail, and
    every worker exits 0. Streams of bursts 1-3 equal the one-replica
    streams (a divergence only at a near tie: the reference's top two
    within 2^-5 of its largest |logit|); each worker counts 22 K1
    launches a replay and none outside, graphs flat; no worker's pid
    holds the card afterwards. Prints the ``proc_fleet`` line: fan-out
    tokens/s beside phases 3 and 16, each worker's cold start (import,
    CUDA context, weights, K1's load, capture), the respawn, dispatch
    and e2e p50 / p99, eject s after the kill and failover ms, moved /
    re-queued / duplicates / rejected, dedupe hits and absorbed retries,
    each worker's K1 launches, replays and graphs, each worker's card
    memory (its own ``torch.cuda`` counts, beside what ``nvidia-smi
    --query-compute-apps`` lists) and the card.
18. disaggregated serving, full width, bf16: one port ``StoreServer``,
    ``DisaggRouter(2, 1)`` (two prefill worker processes, one decode
    worker; 0.25 s / 1.0 s) and ``make_fleet_server``, each worker phase
    17's stack, ``HOROVOD_SERVE_WIRE_MAX_FRAME`` 64 MiB (a full row's KV
    is 46 MB; the default 4 MiB refuses it). Every request is prefilled on a prefill worker
    (``hold_kv``, one token), its KV blocks pushed to the decode worker,
    installed there and decoded there. The reference: phase 3's 9
    requests and 9 fresh ones on one replica's stack in this process,
    freed before anything spawns. Four bursts, one request of each
    through ``POST /generate``: (1) fan-out, the 9 twice over, each
    migrated once; (2) a ``serve.migrate`` window in prefill worker 0 (a
    ``corrupt`` push caught by the decode side's block crc and migrated
    again from the parked row, a ``conn_reset`` whose replay is served
    the deduped install ack; no re-prefill), 9 fresh prompts; (3) a
    ``serve.proc`` crash of prefill worker 0 three iterations in, a real
    SIGKILL: its requests go to prefill worker 1 once, generation 1 is
    re-admitted and prefills a share of the fresh prompts again; (4) SIGTERM mid-burst: new submits shed (429 over
    HTTP), the tail finishes, every worker exits 0. Streams of bursts
    1-3 equal the one-replica streams (phase 17's near-tie rule); burst
    1's migration bytes are its prompts' positions' (22,528 B each);
    ``/healthz`` carries the per-pool breakdown and ``/metrics?fleet=1``
    the migration families; the decode worker replays no prefill graph;
    each worker counts 22 K1 launches a replay and none outside, graphs
    flat; no worker's pid holds the card afterwards. Prints the
    ``disagg`` line: fan-out tokens/s beside phases 3 and 17, TTFT (the
    router's prefill leg, and the workers' own beside phase 17's), the
    migration's ms, bytes and MB/s, the decode leg and e2e p50 / p99,
    each worker's cold start, re-prefills, dedupe hits, duplicates and
    rejected, each worker's K1 launches, replays and graphs, each
    process's card memory, and the card.
19. checkpoint and resume, full width: ``hvd.init()`` and phase 9's
    Llama_1B training step (fp32 parameters, AdamW in
    DistributedOptimizer, batch 4 x 2048, K2-K6); steps 1-3, the state
    cloned on the card; step 3 saved by ``ShardedCheckpointer(async_save
    =True)`` (~13 GB) while steps 4-6 run (run A); ``verify_step``; the
    clone copied back and steps 4-6 again without a writer (run B); a
    fresh model and optimizer from another seed, step 3 restored into
    them on the card through ``target=`` (every tensor equal to the
    clone in dtype, shape, device and bits), steps 4-6 again (run C).
    Runs A, B and C must give the same losses bit for bit. Free disk is
    checked first; the checkpoint directory is deleted afterwards.
    Prints the ``ckpt`` line: bytes and leaves, blocking and save ms
    with the write GB/s, restore ms with the read GB/s and the host
    crc32's share, verify ms, step ms with and without the writer, and
    the card.
20. online learning, full width: phase 9's Llama_1B trainer at batch 1 x
    2048 (a cut from batch 4: it shares the card) publishes its
    parameters, cast to the serving dtypes on the card, as version 1 on
    a ``WeightPublisher`` (an in-process ``StoreServer``) before
    ``ProcessFleetRouter(2, channel=)`` starts two of phase 17's workers,
    whose own seeded weights differ: each passes its weight gate by
    fetching v1 (2.2 GB) before it is admitted. A comparison stack in
    this process (the workers' own) adopts through a ``WeightSubscriber``
    of its own. Burst A equals the comparison at v1 (phase 17's near-tie
    rule); 5 AdamW steps (K2-K6); a ``redist.transport`` corrupt armed in
    worker 1; burst B's waves run while v2 is published and adopted —
    worker 1's first fetch of v2 refused by the chunk crc32, every
    request answered once, no version going backwards, one adoption of
    v2 a worker; burst C equals the comparison at v2 and differs from
    burst A. Prints the ``stream`` line: publish ms (cast, snapshot, chunk
    sets) with bytes, chunks and GB/s; each worker's gate seconds in its
    cold start, adoption (fetch with crc32, assembly, ``swap_params`` and
    its fenced copy); decode step p50 / p99 and tokens/s of bursts A, B
    and C; K1 launches and replays a worker, K2-K6 in the trainer; this
    process's peak and each worker's reserved memory; the store's keys
    and bytes; the card.
21. the serve soaks on the card: ``run_fleet_soak(replicas=2, clients=4,
    seed=7)``, ``run_disagg_soak(prefill=2, decode=1, seed=7)``,
    ``run_serve_soak()`` and ``run_kvtier_soak()``, their workers and
    models on the card at the soak models' widths; every verdict printed
    whole (``soak_<name>`` lines) must be ok with every scheduled fault
    fired.
22. the collective surface and the gradient path, one rank over NCCL:
    ``alltoall`` (with splits and equal), ``reducescatter`` (uniform and
    ragged, Sum / Average / Min / Max), the four ``quantized_*`` and
    Adasum on each wire, on CUDA tensors of fp32, bf16, int32, int8 and
    bool where the reference takes them, over the global set and over a
    set [0] with its own NCCL group, each held to the same call on CPU
    tensors over a gloo group (``collective_check`` lines; world 1:
    parity across ranks rests on the gloo CPU tests). Then ResNet-50 at
    full width, phase 6's batch and seed, 2 + 6 steps in each of: phase
    6's configuration, ``Compression.int8``, ``op=Adasum``, and every
    BatchNorm as ``SyncBatchNorm`` with the classifier's gradients
    rank-local (``local_vars``): losses finite, the first within 1e-3
    relative of phase 6's, K2 / K3 once a step, step p50s beside phase
    6's and the wire bytes a step from the counters
    (``collective_train`` lines).
23. the async engine, one rank over NCCL: every function of the async
    surface (``allreduce_async`` ... ``grouped_*``, ``poll``,
    ``synchronize``, ``wait``, ``join``, ``sparse_allreduce(_async)``) in
    fp32, bf16 and int32 bit for bit against the synchronous collectives
    (``sparse_*`` against ``index_add_``) on the same CUDA tensors; 200
    small tensors in one burst in few buckets; a duplicate name refused;
    ``stop()`` aborting a pending handle; ``allreduce(algo=)`` for direct,
    rs_ag and two_level equal to direct (rhd: the reference's refusal at
    world 1) and the rhd and two_level sums themselves; the int8 and bf16
    fused wires over three calls bit for bit against their plain
    composition (block quantize with the carried residual, dequantize;
    one bf16 cast) (``engine`` line). Then Llama_1B at full width (phase
    9's configuration), 3 + 10 steps with the gradient hooks on the
    engine beside the same seed through the step-time path: losses bit
    for bit (or within the spread of two step-time runs, printed), step
    p50s, peak memory, buckets a step, ``hvd_engine_cycle_ms`` p50, the
    device gap between the backward's end and AdamW's start (CUDA events)
    and K2-K6's launches; ResNet-50 (phase 6's configuration and its 3 +
    20 steps) with no compression (from the hooks and at ``step()``),
    int8 and fp16 (the bf16 wire), each gradient set one grouped op, and
    the host time in the hooks: losses fall, step p50s beside PR 15's per-tensor int8
    (122.76 ms) and the share of bytes on the wire (``engine_train``
    lines).
24. the image models at full width, one rank over NCCL, each through
    ``make_train_step`` (the gradient hooks), 3 + 10 steps on a fixed
    seeded batch: ViT-B/16 (224 px, patch 16, 12 layers of 12 heads of
    64, mean pool, 1000 classes, fp32 parameters, bf16 compute, batch
    128, Adam(1e-3)); VGG-16 (224 px, batch 64) and Inception V3 (299
    px, batch 64) from their frozen bench rows, SGD(0.01, momentum 0.9).
    Losses finite and falling (last-5 median below first-5 median); K4 /
    K5 / K6 launched non-causal 12 times a ViT step and never in the
    convnets, K2 / K3 once a step in each; VGG-16's buckets over the
    fusion threshold hold one gradient each (``vision_buckets`` line);
    Inception's running statistics unchanged bit for bit. Prints step
    p50, img/s, peak memory, buckets a step and launches by design
    (``vision_train`` lines). Then one fp32 step of ViT-B/16 at full
    width, 2 layers, batch 8, on the kernels against the plain path by
    phase 11's rule (``vision_parity``), and K4 / K5 / K6 at ViT-B/16's
    attention (B 128, H 12, S 196 = 3 x 64 + 4, D 64, non-causal, bf16)
    against their plain versions and timed beside non-causal SDPA
    (``vision_flash_check``, the ``flash_time`` line).

Head dims above 128: phase 2 also checks K1 at D 136, 192, 200, 250 and
256 (decode, prefill, the verify step, NaN bytes, inactive rows, G 1 and
8) and at D 264, 384 and 512 (decode and prefill, two column parts), in
both dtypes: bf16 on the decode and prefill designs at a stored width of
256, fp32 on the CUDA-core wide design. It times K1 at Gemma-2B's
attention (H 8, KV 1, D 256: decode and the verify step at L 2048,
prefill B 8 x 512; fp32 decode; D 512 decode and prefill) and serves
phase 4's requests through a 2-layer Llama_1B-width model with that
attention in fp32 (streams against the plain path by phase 4's rule)
and in bf16 (by phase 17's near-tie rule), each with K1's launches by
design (``wide_serve`` lines). Phase 8 checks K4-K6 at D 136, 192, 200,
250 and 256 (bf16 on the tensor-core designs at a stored width of 256,
fp32 on the CUDA-core ones), at Gemma-2B's shape (B 4, S 2048, H 8, KV 1,
D 256) and at G 8, KV 1 with a ragged causal S 2100 (empty K6 pieces),
and at D 264, 384 and 512 in both dtypes, and that K4, K5, K6 and a
differentiable call refuse D 520 before any launch; times them at
Gemma-2B's shape (in fp32 too) and at D 512 in both dtypes; trains the
same 2-layer model at seq 2048, batch 4 for 3 + 7 steps (``lm_train``
line of ``llama_d256``, K4-K6 by design; ``lm_train_wide`` prints its
p50 beside the step's on the CUDA-core backward) and holds one fp32 step
of it to the plain path (``lm_parity``). Phase 1 prints ptxas's
registers and spills of the DS-256 instances (``ptxas_d256``).

``--profile`` traces the serve phase, the ResNet train phase, the Llama
train phase and the speculative serve phase with torch.profiler, and
phase 15's decode steps with the crc ledger on (idle
share, top device kernels, the device time of each of the port's
kernels, the host's ops by their own CPU time, its CUDA runtime calls
(``cudaLaunchKernel``, ``cudaGraphLaunch``, copies, syncs; per generated
token in the serve phases) and the ops that launch kernels one by one,
outside the graphs). ``--serve`` runs phase 1 and the serving phases 3,
4, 12, 13, 14, 15, 16, 17, 18, 20 and 21, writes
``chiprun_out/chip_smoke_serve.json`` and stops. ``--stream`` runs phase
1 and phase 20 (``chip_smoke_stream.json``), ``--soak`` phase 1 and
phase 21 (``chip_smoke_soak.json``). ``--fleet`` runs phase 1
and phase 16, writes ``chiprun_out/chip_smoke_fleet.json`` and stops;
``--proc-fleet`` runs phase 1 and phase 17, writes
``chiprun_out/chip_smoke_proc_fleet.json`` and stops; ``--disagg`` runs
phase 1 and phase 18 (``chip_smoke_disagg.json``), ``--ckpt`` phase 1
and phase 19 (``chip_smoke_ckpt.json``). ``--flash`` runs
phase 1, phase 8's checks and times and K6 under each split limit of
``FLASH_MAX_TILES`` at Llama_1B's, GPT-2-small's and Gemma-2B's shapes
(with K5 and K4 beside it), writes ``chiprun_out/chip_smoke_flash.json``
and stops: the way to time the flash kernels alone. ``--ce`` runs phase
1, phase 5 and the host cost of each step of the loss's wrapper at the
ResNet head, writes ``chiprun_out/chip_smoke_ce.json`` and stops.
``--collectives`` runs phase 1 and phase 22
(``chip_smoke_collectives.json``; its first-loss check then holds the
runs to phase 22's own run of phase 6's configuration). ``--engine`` runs
phase 1 and phase 23 (``chip_smoke_engine.json``); with ``--profile`` it
traces one Llama_1B step each way too (``llama_1b_{hooks,step}_profile``).
``--vision`` runs phase 1 and phase 24 (``chip_smoke_vision.json``); with
``--profile`` it traces two steps of each model.

Prints one JSON line describing each kernel, the nvidia-smi line, and as
the last line ``{"ok": true, "device": {...}}``. Writes the details to
``chiprun_out/chip_smoke.json``.
"""
import argparse
import gc
import glob
import itertools
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS = 67e12               # H100 SXM fp32 outside the tensor cores
#: CE checks (phase 5): (T, V, logits dtype, -1 labels); the first two
#: (the ResNet head, the Llama_1B LM head in bf16) are also timed; T 7
#: and 300 are not multiples of a block's 8 rows; at T 8192 as many blocks
#: meet at the ticket
CE_CASES = ((128, 1000, torch.float32, False),
            (8192, 32000, torch.bfloat16, False),
            (7, 33, torch.float32, True), (300, 1000, torch.bfloat16, True),
            (8192, 32000, torch.float32, False))
TRAIN_BATCH, WARMUP_STEPS, TIMED_STEPS = 128, 3, 20
#: flash attention checks: (B, H, KV, Sq, Skv, D, causal, dtype); G = 1,
#: 8 and 16, causal and not, a ragged S, Sq != Skv, a ragged causal S 2100
#: whose K6 pieces split the query range (some pieces empty), the other
#: head dims (D 8 stored as D-16 tiles; D 24 / 48 / 96 on the D-32 / 64 /
#: 128 instances, K6 in two pieces at D 48; D 4, 5 and 12 zero-padded to
#: 8, 8 and 16 by the wrapper), then both main-path shapes
FLASH_CASES = tuple(
    (B, Hq, Hkv, Sq, Skv, Dh, causal, dt)
    for dt in (torch.float32, torch.bfloat16)
    for B, Hq, Hkv, Sq, Skv, Dh, causal in (
        (2, 8, 8, 256, 256, 64, True), (2, 8, 1, 256, 256, 64, False),
        (2, 32, 4, 50, 50, 64, True), (1, 8, 8, 48, 33, 64, True),
        (1, 8, 8, 48, 33, 64, False), (1, 32, 2, 512, 512, 64, True),
        (1, 4, 2, 2100, 2100, 64, True), (2, 8, 2, 300, 300, 8, True),
        (1, 8, 8, 48, 33, 8, False), (2, 8, 1, 600, 600, 8, True),
        (2, 8, 2, 300, 300, 16, True), (2, 8, 2, 300, 300, 32, True),
        (2, 8, 2, 300, 300, 128, True), (2, 8, 2, 300, 300, 24, True),
        (2, 8, 2, 300, 300, 48, True), (1, 8, 1, 600, 600, 48, True),
        (2, 8, 2, 300, 300, 96, True), (1, 8, 8, 48, 33, 96, False),
        (2, 8, 2, 300, 300, 4, True), (1, 8, 8, 48, 33, 5, False),
        (2, 8, 1, 600, 600, 12, True),
        # head dims above 128: stored width 256 in bf16, the CUDA-core
        # designs in fp32 (GQA, ragged, Sq != Skv, D 250 padded to 256; G
        # 8, KV 1 at a ragged causal S 2100, where some of K6's pieces are
        # empty)
        (2, 8, 2, 300, 300, 136, True), (1, 8, 8, 48, 33, 136, False),
        (2, 8, 1, 300, 300, 192, True), (1, 8, 2, 48, 33, 192, True),
        (2, 8, 2, 300, 300, 200, True), (1, 4, 4, 33, 48, 200, False),
        (2, 8, 1, 300, 300, 256, True), (1, 8, 8, 48, 33, 256, False),
        (1, 4, 2, 1000, 1000, 256, True), (1, 8, 2, 100, 100, 250, True),
        (1, 8, 1, 2100, 2100, 256, True),
        # above 256, two output column parts (bf16's backward on the
        # CUDA-core designs): GQA with a ragged causal S, Sq != Skv
        # non-causal, G 4 causal
        *((B, Hq, Hkv, Sq, Skv, Dh, causal)
          for Dh in (264, 384, 512)
          for B, Hq, Hkv, Sq, Skv, causal in (
              (2, 8, 2, 300, 300, True), (1, 8, 8, 48, 33, False),
              (1, 4, 1, 200, 200, True))))
    ) + (
    (4, 32, 4, 2048, 2048, 64, True, torch.bfloat16),
    (8, 12, 12, 1024, 1024, 64, True, torch.bfloat16),
    # Gemma-2B's attention: B 4, S 2048, H 8, KV 1, D 256
    (4, 8, 1, 2048, 2048, 256, True, torch.bfloat16),
    # ViT-B/16 at 224 px (phase 24): non-causal, G 1, S 196 = 3 x 64 + 4
    (128, 12, 12, 196, 196, 64, False, torch.bfloat16))
#: the LM training phases: (name, warm-up steps, timed steps,
#: build_lm_train_step arguments)
LLAMA_SPEC = ("llama_1b", 3, 10, dict(
    family="llama", layers=22, heads=32, kv_heads=4, head_dim=64,
    seq=2048, batch=4, vocab=32000))
GPT_SPEC = ("gpt2_small", 3, 10, dict(family="gpt"))  # the bench defaults
#: phase 8's main path at head dim 256: Gemma-2B's attention (8 query
#: heads, 1 kv head, head_dim 256) at Llama_1B's width, depth cut to 2
WIDE_SPEC = ("llama_d256", 3, 7, dict(
    family="llama", layers=2, heads=8, kv_heads=1, head_dim=256,
    seq=2048, batch=4, vocab=32000))
#: ``--flash``: K6's split limits timed side by side
#: (attention.DKV_MAX_TILES); the first is the default
FLASH_MAX_TILES = (64, 32, 16)
#: the D-256 LM step's p50 in ms while bf16's K5 / K6 ran the CUDA-core
#: designs at that head dim (NVIDIA H100 80GB HBM3 at 700 W), printed
#: beside this run's
WIDE_STEP_CUDA_CORE_MS = 166.2
#: phase 24, the image models at full width: ViT-B/16 (224 px, patch 16,
#: 12 layers of 12 heads of 64, mean pool) and its attention (B, H, KV, S,
#: D; non-causal), VGG-16 at 224 px and Inception V3 at 299 px; batches,
#: warm-up and timed steps; the fp32 ViT step held to the plain path
VIT_BATCH = 128
VISION_ROWS = (("vgg16", 224, 64), ("inception3", 299, 64))
VIT_ATTENTION = (128, 12, 12, 196, 64)
VISION_WARMUP, VISION_STEPS = 3, 10
VIT_PARITY_LAYERS, VIT_PARITY_BATCH = 2, 8
H, KV, D, BS = 32, 4, 64, 16     # Llama_1B attention shapes
SEED, NEW_TOKENS = 0, 32         # weights/requests seed; tokens per request
#: CUDA runtime calls counted by ``--profile`` (host launches of single
#: kernels, graph replays, copies, syncs)
RUNTIME_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                 "cudaGraphLaunch", "cudaMemcpyAsync",
                 "cudaStreamSynchronize")
#: speculative decoding (phases 12-13): draft depth and the sampled
#: requests' controls
SPEC_K = 3
SAMPLING = dict(temperature=0.8, top_p=0.9)


def log(*a):
    print(*a, flush=True)


def log_err(*a):
    """A failed phase's worker log tails: on standard error, where the
    end of a failed run is read."""
    print(*a, file=sys.stderr, flush=True)


def cuda_ms(fn, iters, warmup=3):
    """Mean device time of ``fn(i)`` over ``iters`` calls (CUDA events)."""
    for i in range(warmup):
        fn(i)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 2: the kernel against its plain version
# ---------------------------------------------------------------------------

def paged_case(B, T, L, dtype, seed, dev, H=H, KV=KV, D=D, lengths=None,
               inactive=(), nan=False):
    """Pool, tables and positions shaped like the serve plane's: rows 0-3
    share a 256-token prefix run, row 4 holds a copy-on-write copy of a
    shared block, positions sit mid-block, unassigned entries are -1.
    Row b holds ``lengths[b]`` tokens (random when not given) and its last
    query sits at the last of them; rows in ``inactive`` have all -1
    tables at position 0 (an empty batch slot). Returns the kernel's
    arguments and the clean ones for the plain version: with ``nan``,
    every pool byte that no query may see (past a row's ``pos + T - 1``,
    and every block of no row) is a NaN pattern in the former."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.RandomState(seed)
    nblk = L // BS
    NB = B * nblk + 32
    pk = torch.randn(NB, BS, KV, D, generator=g, device=dev).to(dtype)
    pv = torch.randn(NB, BS, KV, D, generator=g, device=dev).to(dtype)
    q = torch.randn(B, T, H, D, generator=g, device=dev).to(dtype)
    free = list(rng.permutation(NB))
    shared = [free.pop() for _ in range(256 // BS)]
    tbl = np.full((B, nblk), -1, np.int32)
    pos = np.zeros(B, np.int32)
    for b in range(B):
        need = (rng.randint(T, L + 1) if lengths is None
                else lengths[b])                      # tokens this row holds
        if b in inactive:
            continue
        n_b = -(-need // BS)
        own = [free.pop() for _ in range(n_b)]
        if b < 4 and n_b > len(shared):
            own[:len(shared)] = shared
        tbl[b, :n_b] = own
        pos[b] = need - T                             # last query at need-1
    if B > 4 and tbl[4, 0] >= 0 and 4 not in inactive:  # CoW of shared[1]
        pk[tbl[4, 0]] = pk[shared[1]]
        pv[tbl[4, 0]] = pv[shared[1]]
    tt, tp = torch.from_numpy(tbl).to(dev), torch.from_numpy(pos).to(dev)
    clean = (q, pk, pv, tt, tp)
    if not nan:
        return clean, clean
    seen = torch.zeros(NB, BS, dtype=torch.bool)
    for b in range(B):
        for j in range(int(pos[b]) + T if tbl[b, 0] >= 0 else 0):
            seen[tbl[b, j // BS], j % BS] = True
    seen = seen.to(dev)[:, :, None, None]
    bad = torch.full((), float("nan"), dtype=dtype, device=dev)
    return (q, torch.where(seen, pk, bad), torch.where(seen, pv, bad), tt,
            tp), clean


#: K1 checks (phase 2), each in bf16 and fp32: label, paged_case's
#: arguments. "boundaries": row lengths on, one before and one past the
#: ends of the decode design's key ranges.
K1_CASES = (
    ("decode", dict(B=8, T=1, L=2048)),
    ("prefill", dict(B=8, T=128, L=2048)),
    ("prefill", dict(B=4, T=512, L=2048)),
    ("decode, one long request", dict(B=1, T=1, L=2048, lengths=[2048])),
    ("decode, split boundaries", dict(B=8, T=1, L=2048,
                                      lengths="boundaries")),
    ("decode, inactive rows", dict(B=8, T=1, L=2048, inactive=(2, 5))),
    ("prefill, inactive rows", dict(B=8, T=128, L=2048, inactive=(2, 5))),
    ("decode, G 1 (GPT-2)", dict(B=8, T=1, L=1024, H=12, KV=12)),
    ("prefill, G 1 (GPT-2)", dict(B=8, T=128, L=1024, H=12, KV=12)),
    ("decode, D 32", dict(B=8, T=1, L=2048, D=32)),
    ("prefill, D 32", dict(B=4, T=128, L=2048, D=32)),
    ("decode, D 128", dict(B=8, T=1, L=2048, D=128)),
    ("prefill, D 128", dict(B=4, T=128, L=2048, D=128)),
    ("decode, D 16", dict(B=8, T=1, L=2048, D=16)),
    ("prefill, D 16", dict(B=4, T=128, L=2048, D=16)),
    ("decode, D 8", dict(B=8, T=1, L=2048, D=8)),
    ("prefill, D 8", dict(B=4, T=128, L=2048, D=8)),
    ("decode, D 8, G 1", dict(B=8, T=1, L=1024, H=12, KV=12, D=8)),
    ("decode, D 24", dict(B=8, T=1, L=2048, D=24)),
    ("prefill, D 24", dict(B=4, T=128, L=2048, D=24)),
    ("decode, D 48", dict(B=8, T=1, L=2048, D=48)),
    ("prefill, D 48", dict(B=4, T=128, L=2048, D=48)),
    ("decode, D 96", dict(B=8, T=1, L=2048, D=96)),
    ("prefill, D 96", dict(B=4, T=128, L=2048, D=96)),
    ("decode, D 48, G 1", dict(B=8, T=1, L=1024, H=12, KV=12, D=48)),
    ("prefill, D 16, stale NaN bytes", dict(B=4, T=128, L=2048, D=16,
                                            nan=True)),
    ("prefill after a prefix hit (T 128 at pos 256)",
     dict(B=4, T=128, L=2048, lengths=[384] * 4)),
    ("decode, stale NaN bytes", dict(B=8, T=1, L=2048, nan=True)),
    ("prefill, stale NaN bytes", dict(B=4, T=128, L=2048, nan=True)),
    ("verify (spec_k 3, 32 rows: the prefill design)",
     dict(B=8, T=SPEC_K + 1, L=2048)),
    ("verify, stale NaN bytes", dict(B=8, T=SPEC_K + 1, L=2048, nan=True)),
    ("verify, inactive rows", dict(B=8, T=SPEC_K + 1, L=2048,
                                   inactive=(3, 6))),
    ("decode, D 4", dict(B=8, T=1, L=2048, D=4)),
    ("prefill, D 4", dict(B=4, T=128, L=2048, D=4)),
    ("decode, D 5, G 1", dict(B=8, T=1, L=1024, H=12, KV=12, D=5)),
    ("verify, D 5", dict(B=8, T=SPEC_K + 1, L=2048, D=5)),
    ("decode, D 12", dict(B=8, T=1, L=2048, D=12)),
    ("prefill, D 12", dict(B=4, T=128, L=2048, D=12)),
    # head dims above 128 (DS 256): bf16 on the tensor-core decode and
    # prefill designs, fp32 on the CUDA-core wide design; at each of D 136,
    # 192, 200, 250 (padded to 256) and 256 (Gemma-2B's attention: H 8, KV
    # 1, G 8) decode, prefill, the verify step, stale NaN bytes, inactive
    # rows and G 1; above 256 (two column parts) decode and prefill at D
    # 264, 384 and 512
) + tuple(
    (f"{label}, D {d}", dict(spec, D=d))
    for d in (136, 192, 200, 250, 256)
    for label, spec in (
        ("decode", dict(B=8, T=1, L=2048, H=8, KV=1)),
        ("prefill", dict(B=4, T=128, L=2048, H=8, KV=1)),
        ("verify", dict(B=8, T=SPEC_K + 1, L=2048, H=8, KV=1)),
        ("decode, stale NaN bytes", dict(B=8, T=1, L=2048, H=8, KV=1,
                                         nan=True)),
        ("verify, stale NaN bytes", dict(B=8, T=SPEC_K + 1, L=2048, H=8,
                                         KV=1, nan=True)),
        ("prefill, inactive rows", dict(B=8, T=128, L=1024, H=8, KV=1,
                                        inactive=(2, 5))),
        ("decode, G 1", dict(B=8, T=1, L=1024, H=12, KV=12)),
        ("prefill, G 1", dict(B=4, T=128, L=1024, H=12, KV=12)))
) + tuple(
    (f"{label}, D {d} (two column parts)", dict(spec, D=d))
    for d in (264, 384, 512)
    for label, spec in (
        ("decode", dict(B=8, T=1, L=1024, H=8, KV=1, nan=True)),
        ("prefill", dict(B=4, T=128, L=1024, H=8, KV=2))))


def check_kernel(paged, dev):
    """K1 against its plain version (``paged.check_against_plain``'s
    bars: fp32 max |err| <= 1e-4; bf16 every element within 2^-7 (|ref| +
    sum_j p_j |v_j|) + 1e-4 and ||err|| / ||ref|| <= 1e-2), each line with
    its largest share of the bar (xN, <= 1 passes); then two calls of each
    design must give the same bits."""
    results = []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for i, (label, spec) in enumerate(K1_CASES):
        spec = dict(spec)
        if spec.get("lengths") == "boundaries":
            _, kps = paged.split_plan(spec["B"], spec.get("KV", KV),
                                      spec["L"] // BS, BS, sms)
            spec["lengths"] = [kps, 2 * kps, 2 * kps - 1, 2 * kps + 1,
                               3 * kps, 1, 17, spec["L"]]
        for dtype in (torch.bfloat16, torch.float32):
            args, clean = paged_case(dtype=dtype, seed=spec["T"] + spec["B"]
                                     + i, dev=dev, **spec)
            got = paged.paged_attention_fused(*args)
            torch.cuda.synchronize()
            errs = paged.compare_with_plain(
                got, *paged.plain_reference(*clean), dtype)
            results.append({"case": label, "dtype": str(dtype).split(".")[-1],
                            **{k: v for k, v in spec.items()
                               if k not in ("lengths",)}, **errs})
            log(f"kernel_check {label}: dtype={results[-1]['dtype']} "
                + " ".join(f"{k}={v}" for k, v in spec.items()
                           if k not in ("lengths", "nan"))
                + f" max_abs_err={errs['max_abs_err']:.3g} "
                f"x{errs['ratio']:.2f} rel={errs['rel_norm']:.2g} "
                f"{'ok' if errs['ok'] else 'FAIL'}")
            del got, args, clean
    for B, T, kw in ((8, 1, {}), (4, 512, {}),
                     (8, 1, dict(H=8, KV=1, D=256)),
                     (8, SPEC_K + 1, dict(H=8, KV=1, D=256)),
                     (4, 128, dict(H=8, KV=1, D=256)),
                     (8, 1, dict(H=8, KV=1, D=512))):
        args, _ = paged_case(B, T, 2048, torch.bfloat16, seed=B + T,
                             dev=dev, **kw)
        same = torch.equal(paged.paged_attention_fused(*args),
                           paged.paged_attention_fused(*args))
        results.append({"case": "determinism", "B": B, "T": T,
                        "D": kw.get("D", D), "dtype": "bfloat16",
                        "ok": same})
        log(f"kernel_check determinism B={B} T={T} D={kw.get('D', D)}: "
            f"two calls {'bit-identical ok' if same else 'differ FAIL'}")
    torch.cuda.empty_cache()
    if not all(r["ok"] for r in results):
        raise SystemExit("phase 2: kernel disagrees with its plain version")
    return results


def time_kernel(paged, kvc, dev, B, T, L, dtype, D=D, H=H, KV=KV):
    """Kernel, plain and library times on inputs rotated over enough
    distinct pools (> 50 MB) that L2 holds none of them between calls,
    as a layer's pool is cold when the next layer reads its own: a host
    loop timed by CUDA events (``ms``, the mean of two loops taken in
    turns with the library's), and the same calls replayed from a CUDA
    graph (``graph_ms``: the device's time alone)."""
    sets = []
    isz = 2 if dtype == torch.bfloat16 else 4
    nblk = L // BS
    per_set = 2 * B * L * KV * D * isz + 2 * B * T * H * D * isz
    n_sets = max(2, int(np.ceil(120e6 / per_set)))
    for s in range(n_sets):
        g = torch.Generator(device=dev).manual_seed(100 + s)
        pk = torch.randn(B * nblk, BS, KV, D, generator=g,
                         device=dev).to(dtype)
        pv = torch.randn(B * nblk, BS, KV, D, generator=g,
                         device=dev).to(dtype)
        q = torch.randn(B, T, H, D, generator=g, device=dev).to(dtype)
        tbl = torch.randperm(B * nblk, generator=g, device=dev).reshape(
            B, nblk).to(torch.int32)
        pos = torch.full((B,), L - T, dtype=torch.int32, device=dev)
        sets.append((q, pk, pv, tbl, pos))
    n = len(sets)
    turn = itertools.count()
    # the library yardstick: one SDPA call on KV already gathered per row
    # (the gather is not timed); [B, H, T, D] x [B, KV, L, D]
    gathered = []
    for q, pk, pv, tbl, pos in sets:
        k = pk[tbl.long()].reshape(B, L, KV, D).transpose(1, 2).contiguous()
        v = pv[tbl.long()].reshape(B, L, KV, D).transpose(1, 2).contiguous()
        gathered.append((q.transpose(1, 2).contiguous(), k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kw = {"is_causal": T > 1}
    if T > 1 and T != L:
        # prefill of the LAST T positions: key j valid iff j <= L - T + t
        j = torch.arange(L, device=dev)
        t = torch.arange(T, device=dev)
        kw = {"attn_mask": j[None, :] <= (L - T) + t[:, None]}
    try:
        sdpa(*gathered[0], enable_gqa=True, **kw)
        kw["enable_gqa"] = True
    except TypeError:   # a PyTorch without enable_gqa: expand the heads
        gathered = [(q, k.repeat_interleave(H // KV, 1),
                     v.repeat_interleave(H // KV, 1))
                    for q, k, v in gathered]

    def kern_loop():
        return cuda_ms(lambda i: paged.paged_attention_fused(*sets[i % n]),
                       iters=100)

    def lib_loop():
        return cuda_ms(lambda i: sdpa(*gathered[i % n], **kw), iters=100)

    # host loops in turns (kernel, library, library, kernel): the host's
    # pace drifts, and both calls are host-bound at decode
    k1, l1, l2, k2 = kern_loop(), lib_loop(), lib_loop(), kern_loop()
    kern, lib = (k1 + k2) / 2, (l1 + l2) / 2
    kern_graph = graph_ms(
        lambda: paged.paged_attention_fused(*sets[next(turn) % n]))
    lib_graph = graph_ms(lambda: sdpa(*gathered[next(turn) % n], **kw))
    plain = cuda_ms(lambda i: kvc.paged_attention(*sets[i % n]), iters=10)
    # the bound: each input read once, each output written once
    keys = B * sum(L - T + t + 1 for t in range(T))      # (row, t, key)
    kv_keys = B * L                                      # distinct keys
    bytes_ = (2 * B * T * H * D * isz + 2 * kv_keys * KV * D * isz
              + B * nblk * 4 + B * 4)
    flops = 4 * keys * H * D
    peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, Dp = T * (H // KV), -(-D // 8) * 8
    design = paged.design_of(dtype, Dp, rows)
    n_split, kps = (
        paged.wide_plan(B, KV, nblk, BS, rows, sms)
        if design == "paged_wide_kernel"
        else paged.decode_plan(B, KV, nblk, BS, rows, Dp, sms)
        if design.startswith("decode") else (0, 0))
    out = {"B": B, "T": T, "L": L, "H": H, "KV": KV, "D": D,
           "dtype": str(dtype).split(".")[-1], "design": design,
           "n_split": n_split, "keys_per_split": kps,
           "ms": kern, "ms_turns": [k1, k2], "graph_ms": kern_graph,
           "plain_ms": plain, "library_ms": lib,
           "library_ms_turns": [l1, l2], "library_graph_ms": lib_graph,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": bytes_, "flops": flops}
    log("kernel_time " + " ".join(f"{k}={v}" for k, v in out.items()))
    del sets, gathered
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 3 and 4: the serving path at full width
# ---------------------------------------------------------------------------

def make_requests(seed, n=9):
    rng = np.random.RandomState(seed)
    system = [int(t) for t in rng.randint(0, 32000, 256)]
    prompts = []
    for i in range(n):
        if i % 2 == 0:
            tail = int(rng.randint(8, 245))          # 264..500 tokens
            prompts.append(system + [int(t) for t in
                                     rng.randint(0, 32000, tail)])
        else:
            prompts.append([int(t) for t in
                            rng.randint(0, 32000, rng.randint(64, 501))])
    return prompts


def free_cuda():
    """Release the last phase's executors (graphs and their pools
    included: a traced step makes a reference cycle) and cached blocks."""
    gc.collect()
    torch.cuda.empty_cache()


def build_stack(ht, sd, dtype, kernel, dev, draft=None, cfg_kw=None,
                **batcher_kw):
    """The serving stack of phases 3, 4, 12, 13 and 15: a paged Llama_1B
    target from ``sd`` and, with ``draft`` (a drafter's executor, or a
    state dict for a self-draft of the target's width), speculation at
    depth SPEC_K; ``batcher_kw`` goes to the batcher (phase 15's crc
    ledger and KV tier); ``cfg_kw`` overrides Llama_1B's config (phase
    2's Gemma-width attention). ``warmup()`` captures every step's graphs;
    its seconds are kept in ``b.warmup_s``."""
    from horovod_tpu_torch.models.llama import Llama, Llama_1B
    cfg = Llama_1B(dtype=dtype, kv_block_size=BS,
                   kv_pool_blocks=ht.pool_blocks_for(8, 2048, BS),
                   decode_kernel=kernel, **(cfg_kw or {}))
    model = Llama(cfg, device=dev)
    model.load_state_dict(sd)
    ex = ht.ShardedExecutor(model, max_batch=8, max_len=2048, device=dev)
    if isinstance(draft, dict):
        draft = build_drafter(ht, draft, dtype, dev)
    q = ht.AdmissionQueue(max_queue=64)
    b = ht.ContinuousBatcher(ex, q, buckets=(128, 512), prefix_cache=True,
                             draft_executor=draft, spec_k=SPEC_K,
                             **batcher_kw)
    t0 = time.perf_counter()
    b.warmup()
    torch.cuda.synchronize()
    b.warmup_s = time.perf_counter() - t0
    # step p50s count the traffic's steps, not warm-up's captures
    for e in (ex, draft):
        for lat in (e.step_latencies_ms.values() if e is not None else ()):
            lat.clear()
    return ex, q, b


def graph_stats(ex):
    """An executor's captured graphs: how many, and each signature's
    capture ms (its warm-up run included)."""
    return {"graphs": ex.jit_cache_size(),
            "capture_ms": {f"{k}/{T}/{'sampled' if s else 'greedy'}": ms
                           for (k, T, s), ms in ex.capture_ms.items()}}


class ReplayCheck:
    """Every step an executor runs between ``__init__`` and ``done()`` is
    a graph replay, and no graph is added."""

    def __init__(self, ex):
        self.ex = ex
        self.g0, self.s0, self.r0 = ex.jit_cache_size(), ex.steps, ex.replays

    def done(self):
        ex = self.ex
        out = {"graphs_before": self.g0, "graphs_after": ex.jit_cache_size(),
               "steps": ex.steps - self.s0, "replays": ex.replays - self.r0}
        out["ok"] = (out["graphs_before"] == out["graphs_after"]
                     and out["steps"] == out["replays"] > 0)
        return out


def build_drafter(ht, sd, dtype, dev, layers=None):
    """A slotted Llama_1B-width draft executor (the reference's
    self-draft configuration, or ``layers`` of it) from ``sd``."""
    from horovod_tpu_torch.models.llama import Llama, Llama_1B
    kw = {} if layers is None else {"num_layers": layers}
    model = Llama(Llama_1B(dtype=dtype, decode=True, **kw), device=dev)
    model.load_state_dict(sd)
    return ht.ShardedExecutor(model, max_batch=8, max_len=2048, device=dev,
                              role="draft")


def _busy_us(events):
    """Device busy time: the union of the kernels' (and copies')
    intervals. Summing ``self_device_time_total`` over every event would
    count each kernel twice, under its own event and under the CPU op
    that launched it."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    return busy + (cur_e - cur_s if cur_e is not None else 0.0)


def port_kernels():
    """The names of the __global__ functions in the port's CUDA sources
    (``horovod_tpu_torch/ops/csrc/*.cu``)."""
    names = set()
    csrc = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "horovod_tpu_torch", "ops", "csrc")
    for path in glob.glob(os.path.join(csrc, "*.cu")):
        with open(path) as f:
            names.update(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^\n]*\)\s+)?"
                r"(\w+)\s*\(", f.read()))
    return names


def port_kernel(key, names):
    """Whether a profiler event names one of ``names``, the port's kernels
    (they sit in the top-level anonymous namespace of their source)."""
    m = re.match(r"void \(anonymous namespace\)::(\w+)<", key)
    return bool(m) and m.group(1) in names


def launches_by_op(events):
    """Host launches of single kernels (outside any graph), counted by
    the innermost ``aten::`` op around each on its thread."""
    from torch.autograd import DeviceType
    ops = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith("aten::"):
            ops.setdefault(e.thread, []).append(e)
    out = {}
    for e in events:
        if e.name not in ("cudaLaunchKernel", "cudaLaunchKernelExC"):
            continue
        around = [o for o in ops.get(e.thread, ())
                  if o.time_range.start <= e.time_range.start
                  and o.time_range.end >= e.time_range.end]
        op = (min(around, key=lambda o: o.time_range.elapsed_us()).name
              if around else "-")
        out[op] = out.get(op, 0) + 1
    return dict(sorted(out.items(), key=lambda kv: -kv[1])[:12])


class _Profile:
    """``torch.profiler`` over a phase's main path (``--profile`` only:
    tracing slows every launch). Writes the per-kernel device-time table
    and the device busy share to the output directory."""

    def __init__(self, on, name="serve"):
        self.on, self.name = on, name
        self.result = None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile
            # every thread's ops: the serve phases step on the batcher's
            # thread, and the ops that launch kernels outside the graphs
            # are named by the op around each launch
            from torch._C._profiler import _ExperimentalConfig
            self.prof = profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                experimental_config=_ExperimentalConfig(
                    profile_all_threads=True))
            self.prof.__enter__()
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if not self.on:
            return False
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - self.t0) * 1e6
        self.prof.__exit__(*exc)
        from torch.autograd import DeviceType
        avgs = self.prof.key_averages()
        busy_us = _busy_us(self.prof.events())
        kernels = [e for e in avgs if e.device_type == DeviceType.CUDA]
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", f"{self.name}_profile.txt"),
                  "w") as f:
            f.write(avgs.table(sort_by="self_device_time_total",
                               row_limit=30))
            # the host's side: ops by their own CPU time
            f.write(avgs.table(sort_by="self_cpu_time_total", row_limit=30))
        log(f"profile phase={self.name} wall_ms={wall_us / 1e3:.1f} "
            f"device_busy_ms={busy_us / 1e3:.1f} "
            f"idle_share={1 - busy_us / wall_us:.3f}")
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        for e in top:
            log(f"profile_top phase={self.name} name={e.key[:60]!r} "
                f"calls={e.count} "
                f"device_ms={e.self_device_time_total / 1e3:.2f}")
        # the port's own kernels, wherever they rank
        names = port_kernels()
        port = [e for e in kernels if port_kernel(e.key, names)]
        for e in port:
            log(f"profile_kernel phase={self.name} name={e.key[:60]!r} "
                f"calls={e.count} "
                f"device_ms={e.self_device_time_total / 1e3:.3f}")
        # the host's CUDA runtime calls, and the ops that launch kernels
        # one by one (outside any graph)
        calls = {e.key: e.count for e in avgs if e.key in RUNTIME_CALLS}
        outside = launches_by_op(self.prof.events())
        log(f"profile_calls phase={self.name} {json.dumps(calls)} "
            f"kernel_launches_by_op={json.dumps(outside)}")
        if not port:
            log(f"profile phase={self.name}: no device event names a port "
                f"kernel (graph kernels not attributed by the profiler?)")
        self.result = {"wall_ms": wall_us / 1e3,
                       "device_busy_ms": busy_us / 1e3,
                       "idle_share": 1 - busy_us / wall_us,
                       "runtime_calls": calls,
                       "kernel_launches_by_op": outside,
                       "top": [[e.key, e.count,
                                e.self_device_time_total / 1e3]
                               for e in top],
                       "port_kernels": [[e.key, e.count,
                                         e.self_device_time_total / 1e3]
                                        for e in port]}
        return False


def serve_phase(ht, paged, dev, seed, new_tokens, profile=False):
    from horovod_tpu_torch.models.llama import Llama_1B
    cfg = Llama_1B(dtype=torch.bfloat16)
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sd = ht.init_llama_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), dev)
    ex, q, b = build_stack(ht, sd, torch.bfloat16, None, dev)
    setup_s = time.perf_counter() - t0
    if ex.kernel != "cuda":
        raise SystemExit(f"phase 3: executor resolved kernel {ex.kernel}")
    prompts = make_requests(seed)
    replays = ReplayCheck(ex)
    # ---- the main path: counts from 0, read right after ----
    paged.paged_attention_fused.launches = 0
    srv, http_thread = ht.serve_http(b)
    http_reply = {}

    def post():
        body = json.dumps({"tokens": prompts[0],
                           "max_new_tokens": new_tokens}).encode()
        req = urllib.request.Request(
            "http://%s:%d/generate" % srv.server_address, data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            http_reply.update(json.loads(r.read()), code=r.status)

    with _Profile(profile) as prof:
        t_start = time.perf_counter()
        poster = threading.Thread(target=post)
        poster.start()
        handles = [q.submit(p, max_new_tokens=new_tokens)
                   for p in prompts[1:]]
        for h in handles:
            h.wait(timeout=600)
        poster.join(timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
    launches = paged.paged_attention_fused.launches
    srv.shutdown()
    srv.server_close()
    b.stop()
    http_thread.join(timeout=10)
    graphs = replays.done()
    statuses = [h.status for h in handles] + [http_reply.get("status")]
    streams = [h.tokens for h in handles] + [http_reply.get("tokens", [])]
    ok = (all(s == "ok" for s in statuses)
          and all(len(s) == new_tokens and all(0 <= t < 32000 for t in s)
                  for s in streams)
          and launches > 0 and http_reply.get("code") == 200
          and graphs["ok"])
    gen = sum(len(s) for s in streams)
    peak = torch.cuda.max_memory_allocated() / 1e9
    # a hot swap at full width (the same weights as version 2), cast to
    # the serving dtypes by the publisher (here) and staged on the card
    # already, so it times the in-place copy under the lock
    live = ex.model.state_dict()
    sd = {k: v.to(live[k].dtype) for k, v in sd.items()}
    del live
    t_swap = time.perf_counter()
    swapped = ex.swap_params(sd, version=2)
    swap_ms = (time.perf_counter() - t_swap) * 1e3
    del sd
    out = {"requests": len(prompts), "statuses": statuses,
           "launches": launches, "generated_tokens": gen, "wall_s": wall,
           "tokens_per_s": gen / wall,
           "ttft_p50_ms": float(np.median(b.ttft_ms)),
           "step_p50_ms": {k: ex.p50_step_ms(k)
                           for k in ("prefill", "decode")},
           "steps": {k: len(v) for k, v in ex.step_latencies_ms.items()},
           "prefix_hits": b.prefix.hits,
           "prefix_tokens_saved": b.prefix.tokens_saved,
           "setup_s": setup_s, "warmup_s": b.warmup_s,
           "replays": graphs, **graph_stats(ex),
           "swap_ms": swap_ms, "swapped": swapped,
           "peak_mem_gb": peak, "profile": per_token(prof.result, gen)}
    ok = ok and swapped and ex.jit_cache_size() == graphs["graphs_after"]
    log("serve " + json.dumps(out))
    del ex, q, b
    free_cuda()
    if not ok:
        raise SystemExit("phase 3: serving failed: " + json.dumps(out))
    return out


def per_token(result, tokens):
    """A ``--profile`` result with its runtime calls per generated token
    (None without ``--profile``)."""
    if result is None:
        return None
    return dict(result, per_token={k: n / max(tokens, 1) for k, n in
                                   result["runtime_calls"].items()})


class StepTrace:
    """Wraps a target executor's step. For each row a step runs, keyed by
    (request id, tokens the row had emitted before the step): the top-2
    logit gap (the smallest over a verify step's positions) and, with
    ``keep_logits``, the row's logits on the host."""

    def __init__(self, ex, b, keep_logits=False):
        self.gaps, self.logits = {}, {}
        step = ex.step

        def traced(*a, **kw):
            out = step(*a, **kw)
            lg = ex.last_logits
            top2 = torch.topk(lg, 2, dim=-1).values
            gap = (top2[..., 0] - top2[..., 1]).cpu().numpy()
            for row, seq in b._active.items():
                if a[2][row]:
                    key = (seq.req.rid, len(seq.out))
                    self.gaps[key] = float(np.min(gap[row]))
                    if keep_logits:
                        self.logits[key] = lg[row].float().cpu()
            return out
        ex.step = traced

    def step_of(self, rid, k):
        """The key of the step that emitted token ``k`` of ``rid``."""
        return max(key for key in self.gaps if key[0] == rid and key[1] <= k)


def first_divergences(streams, want):
    """``[(request, index)]`` of each stream's first token that differs
    from ``want``'s (a shorter stream differs where it ends)."""
    out = []
    for rid, (a, r) in enumerate(zip(streams, want)):
        if a != r:
            out.append((rid, next((i for i, (x, y) in enumerate(zip(a, r))
                                   if x != y), min(len(a), len(r)))))
    return out


def greedy_rule(streams, want, trace):
    """Phase 4's rule: ``streams`` equal ``want`` except a divergence whose
    first differing token had a top-2 logit gap under 1e-3 where ``want``
    was decoded (``trace``). Returns (report, the clear divergences)."""
    diverged = [{"request": rid, "step": k,
                 "top2_gap": trace.gaps.get((rid, k))}
                for rid, k in first_divergences(streams, want)]
    bad = [d for d in diverged if d["top2_gap"] is None
           or d["top2_gap"] >= 1e-3]
    return {"requests": len(streams),
            "identical": len(streams) - len(diverged),
            "diverged": diverged}, bad


#: phase 2's serve at head dim 256: Llama_1B's width (2048) as Gemma-2B's
#: attention (8 query heads, 1 kv head, head_dim 256), depth cut to 2
WIDE_SERVE_CFG = dict(num_layers=2, num_heads=8, num_kv_heads=1,
                      head_dim=256)
#: the K1 designs each dtype's D-256 serve must run, and must not
WIDE_SERVE_DESIGNS = {
    torch.float32: ({"paged_wide_kernel"},
                    {"decode_bf16_kernel", "prefill_bf16_kernel"}),
    torch.bfloat16: ({"decode_bf16_kernel", "prefill_bf16_kernel"},
                     {"paged_wide_kernel"})}


def near_tie_rule(streams, want, trace):
    """Phase 17's rule (``_near_tie``) against a plain-path run whose
    ``trace`` kept its logits: each stream equals ``want`` or leaves it
    at a step where that run's top two logits are within FLEET_LOGIT_BAR
    of its largest |logit|, to the second of them. Returns (report, the
    divergences it does not explain)."""
    tops = {}
    for (rid, k), lg in trace.logits.items():
        v, i = torch.topk(lg.float(), 2)
        tops.setdefault(rid, {})[k] = (v.tolist(), i.tolist(),
                                       float(lg.float().abs().max()))
    diverged = [d for d in (_near_tie(tops.get(rid, {}), s, w)
                            for rid, (s, w) in enumerate(zip(streams, want)))
                if d is not None]
    return {"requests": len(streams),
            "identical": len(streams) - len(diverged),
            "diverged": diverged}, [d for d in diverged if not d["ok"]]


def wide_serve_phase(ht, paged, dev, seed, new_tokens):
    """Phase 2's main path at head dim 256: phase 4's serving stack with
    WIDE_SERVE_CFG's attention, phase 4's requests through K1 and
    through the plain attention, in fp32 (K1's CUDA-core design; streams
    held to each other by phase 4's rule) and in bf16 (the tensor-core
    decode and prefill designs at DS 256; held by phase 17's near-tie
    rule). K1 counted from 0 around each kernel-path run: its executor's
    replays, in all and by design (WIDE_SERVE_DESIGNS). Returns each
    dtype's report."""
    from horovod_tpu_torch.models.llama import Llama_1B
    torch.backends.cuda.matmul.allow_tf32 = False
    prompts = make_requests(seed)[:8]
    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        cfg = Llama_1B(dtype=dtype, **WIDE_SERVE_CFG)
        sd = ht.init_llama_params(cfg, torch.Generator(
            device=dev).manual_seed(seed + 5), dev)
        streams, out = {}, {}
        for kernel in ("cuda", "reference"):
            ex, q, b = build_stack(ht, sd, dtype, kernel, dev,
                                   cfg_kw=WIDE_SERVE_CFG)
            # the plain path's steps are traced (its logits kept in bf16,
            # for the near-tie rule); the kernel path's run untouched
            trace = (StepTrace(ex, b, keep_logits=dtype == torch.bfloat16)
                     if kernel == "reference" else None)
            # ---- the main path: counts from 0, read right after ----
            paged.paged_attention_fused.launches = 0
            paged.paged_attention_fused.design_launches = {}
            k0 = ex.k1_launches
            t0 = time.perf_counter()
            hs = [q.submit(p, max_new_tokens=new_tokens) for p in prompts]
            b.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if kernel == "cuda":
                out.update(
                    launches=ex.k1_launches - k0,
                    launches_by_design=dict(
                        paged.paged_attention_fused.design_launches),
                    wrapper_calls=paged.paged_attention_fused.launches,
                    kernel=ex.kernel, wall_s=wall,
                    tokens_per_s=sum(len(h.tokens) for h in hs) / wall,
                    step_p50_ms={k: ex.p50_step_ms(k)
                                 for k in ("prefill", "decode")},
                    steps={k: len(v)
                           for k, v in ex.step_latencies_ms.items()})
            if not all(h.status == "ok" for h in hs):
                raise SystemExit(f"phase 2 (D 256 serve, {dn}): {kernel} "
                                 f"path: {[h.status for h in hs]}")
            streams[kernel] = [h.tokens for h in hs]
            del ex, q, b
            free_cuda()
        del sd
        if dtype == torch.float32:
            rule, bad = greedy_rule(streams["cuda"], streams["reference"],
                                    trace)
        else:
            rule, bad = near_tie_rule(streams["cuda"], streams["reference"],
                                      trace)
        del trace
        out.update(rule, model=WIDE_SERVE_CFG, dtype=dn,
                   new_tokens=new_tokens)
        log("wide_serve " + json.dumps(out))
        must, must_not = WIDE_SERVE_DESIGNS[dtype]
        ran = {k for k, n in out["launches_by_design"].items() if n > 0}
        if (bad or out["launches"] <= 0 or out["kernel"] != "cuda"
                or not must <= ran or ran & must_not):
            raise SystemExit(f"phase 2 (D 256 serve, {dn}): "
                             f"{json.dumps(out)}")
        report[dn] = out
    return report


def parity_phase(ht, dev, seed, new_tokens):
    """Phase 4; returns the report and the kernel path's streams and
    trace (phase 13 holds speculation to them)."""
    from horovod_tpu_torch.models.llama import Llama_1B
    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 products
    cfg = Llama_1B(dtype=torch.float32)
    sd = ht.init_llama_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), dev)
    prompts = make_requests(seed)[:8]
    streams, traces = {}, {}
    for kernel in ("cuda", "reference"):
        ex, q, b = build_stack(ht, sd, torch.float32, kernel, dev)
        # the top-2 logit gap per (request, token)
        traces[kernel] = StepTrace(ex, b)
        hs = [q.submit(p, max_new_tokens=new_tokens) for p in prompts]
        b.run()
        if not all(h.status == "ok" for h in hs):
            raise SystemExit(f"phase 4: {kernel} path: "
                             f"{[h.status for h in hs]}")
        streams[kernel] = [h.tokens for h in hs]
        del ex, q, b
        free_cuda()
    del sd
    out, bad = greedy_rule(streams["cuda"], streams["reference"],
                           traces["reference"])
    for d in out["diverged"]:
        d["plain_top2_gap"] = d.pop("top2_gap")
    log("parity " + json.dumps(out))
    if bad:
        raise SystemExit(f"phase 4: streams diverge at a clear margin: "
                         f"{bad}")
    return out, streams["cuda"], traces["cuda"]


# ---------------------------------------------------------------------------
# phases 12 and 13: sampled and speculative serving
# ---------------------------------------------------------------------------

def accept_rate(b):
    """The mean of the per-verify-step accept fractions the batcher
    observed (``hvd_serve_spec_accept_rate``), or None."""
    h = b._m_accept
    return h.sum / h.count if h.count else None


def serve_spec_phase(ht, paged, dev, seed, new_tokens, profile=False):
    """Phase 12: phase 3's stack and requests with a slotted self-draft
    and sampled requests; checks, then the determinism of a seeded
    request at another batch position."""
    from horovod_tpu_torch.models.llama import Llama_1B
    cfg = Llama_1B(dtype=torch.bfloat16)
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sd = ht.init_llama_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), dev)
    ex, q, b = build_stack(ht, sd, torch.bfloat16, None, dev, draft=sd)
    del sd
    setup_s = time.perf_counter() - t0
    if ex.kernel != "cuda" or b.draft is None or b.draft.paged:
        raise SystemExit(f"phase 12: kernel {ex.kernel}, drafter "
                         f"{b.draft and b.draft.kernel}")
    prompts = make_requests(seed)
    rng = np.random.RandomState(seed + 12)
    seeds = [int(x) for x in rng.randint(0, 2 ** 32, len(prompts),
                                         dtype=np.uint64)]
    # odd requests sample, even ones are greedy; request 0 (through POST
    # /generate) samples too, so the front end's sampling keys are used
    sampled = [i % 2 == 1 or i == 0 for i in range(len(prompts))]

    def sampling(i):
        return dict(SAMPLING, seed=seeds[i]) if sampled[i] else {}

    # target steps and K1 launches by step kind, and the row each request
    # was prefilled in
    by_kind = {"prefill": 0, "decode": 0, "verify": 0}
    n_steps = dict(by_kind)
    rows = {}
    cur = {"b": b}
    step = ex.step

    def counted(*a, kind="decode", **kw):
        n0 = paged.paged_attention_fused.launches
        out = step(*a, kind=kind, **kw)
        by_kind[kind] += paged.paged_attention_fused.launches - n0
        n_steps[kind] += 1
        if kind == "prefill":
            for row, seq in cur["b"]._active.items():
                if a[2][row]:
                    rows[id(seq.req.handle)] = row
        return out
    ex.step = counted
    replays = {"target": ReplayCheck(ex), "draft": ReplayCheck(b.draft)}

    # ---- the main path: counts from 0, read right after ----
    paged.paged_attention_fused.launches = 0
    srv, http_thread = ht.serve_http(b)
    http_reply = {}

    def post():
        body = json.dumps({"tokens": prompts[0], "max_new_tokens":
                           new_tokens, **sampling(0)}).encode()
        req = urllib.request.Request(
            "http://%s:%d/generate" % srv.server_address, data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            http_reply.update(json.loads(r.read()), code=r.status)

    with _Profile(profile, "serve_spec") as prof:
        t_start = time.perf_counter()
        poster = threading.Thread(target=post)
        poster.start()
        handles = [q.submit(p, max_new_tokens=new_tokens, **sampling(i))
                   for i, p in enumerate(prompts) if i > 0]
        for h in handles:
            h.wait(timeout=600)
        poster.join(timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
    launches = paged.paged_attention_fused.launches
    launches_by_kind, steps_by_kind = dict(by_kind), dict(n_steps)
    srv.shutdown()
    srv.server_close()
    b.stop()
    http_thread.join(timeout=10)
    replays = {k: r.done() for k, r in replays.items()}
    statuses = [http_reply.get("status")] + [h.status for h in handles]
    streams = [http_reply.get("tokens", [])] + [h.tokens for h in handles]
    gen = sum(len(s) for s in streams)
    layers = len(ex.cache)
    out = {"requests": len(prompts), "sampled": sum(sampled),
           "statuses": statuses, "launches": launches,
           "launches_by_kind": launches_by_kind,
           "target_steps": steps_by_kind,
           "generated_tokens": gen, "wall_s": wall,
           "tokens_per_s": gen / wall,
           "accept_rate": accept_rate(b),
           "target_steps_per_token": b.gen_steps / max(b.gen_tokens, 1),
           "ttft_p50_ms": float(np.median(b.ttft_ms)),
           "step_p50_ms": {k: ex.p50_step_ms(k)
                           for k in ("prefill", "decode", "verify")},
           "draft_step_p50_ms": {k: b.draft.p50_step_ms(k)
                                 for k in ("prefill", "decode")},
           "draft_steps": {k: len(v) for k, v in
                           b.draft.step_latencies_ms.items()},
           "prefix_hits": b.prefix.hits, "setup_s": setup_s,
           "warmup_s": b.warmup_s, "replays": replays,
           "graphs": {"target": graph_stats(ex),
                      "draft": graph_stats(b.draft)},
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "profile": per_token(prof.result, gen)}
    ok = (all(st == "ok" for st in statuses)
          and all(len(s) == new_tokens and all(0 <= t < 32000 for t in s)
                  for s in streams)
          and http_reply.get("code") == 200 and launches > 0
          and steps_by_kind["verify"] > 0
          and launches_by_kind["verify"] == layers * steps_by_kind["verify"]
          and all(r["ok"] for r in replays.values()))
    # the same seeded request again, in another batch (a fresh batcher and
    # prefix cache on the same executors) at another row: the first
    # sampled prompt longer than the smaller bucket, with no prefix that
    # another request shares, so its prefill runs at the same bucket
    t_idx = next(i for i in range(1, len(prompts), 2)
                 if len(prompts[i]) > 128)
    first = handles[t_idx - 1]
    q2 = ht.AdmissionQueue(max_queue=64)
    b2 = ht.ContinuousBatcher(ex, q2, buckets=(128, 512), prefix_cache=True,
                              draft_executor=b.draft, spec_k=SPEC_K)
    cur["b"] = b2
    # a fresh batcher hands out rows 0, 1, ... in admission order: n
    # shorter greedy requests ahead put the repeat at row n
    n_fill = (rows.get(id(first), -1) + 1) % 8
    fillers = [q2.submit([int(t) for t in rng.randint(
        0, 32000, rng.randint(64, 100))], max_new_tokens=8)
        for _ in range(n_fill)]
    again = q2.submit(prompts[t_idx], max_new_tokens=new_tokens,
                      **sampling(t_idx))
    b2.run()
    again_row = rows.get(id(again))
    out["repeat"] = {"request": t_idx, "row": rows.get(id(first)),
                     "row_again": again_row,
                     "same_stream": again.tokens == first.tokens,
                     "fillers_ok": all(h.status == "ok" for h in fillers)}
    ok = (ok and again.status == "ok" and again.tokens == first.tokens
          and again_row is not None and again_row != rows.get(id(first)))
    log("serve_spec " + json.dumps(out))
    del ex, q, b, b2, q2
    free_cuda()
    if not ok:
        raise SystemExit("phase 12: speculative serving failed: "
                         + json.dumps(out))
    return out


def spec_parity_phase(ht, dev, seed, new_tokens, greedy, greedy_trace):
    """Phase 13, fp32: greedy speculation (a self-draft, then a rejecting
    2-layer drafter) through K1 against phase 4's target-only greedy
    streams through K1, by phase 4's rule; sampled speculation through K1
    against the same on the plain path: identical, except a divergence
    whose first differing step's target logits, in the two runs, differ
    by less than 1e-3 (max |err| over the step's row: a near-tie of the
    sampler that the kernel's fp32 rounding tipped, not a wrong
    kernel)."""
    from horovod_tpu_torch.models.llama import Llama_1B
    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 products
    cfg = Llama_1B(dtype=torch.float32)
    sd = ht.init_llama_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), dev)
    prompts = make_requests(seed)[:8]
    rng = np.random.RandomState(seed + 13)
    seeds = [int(x) for x in rng.randint(0, 2 ** 32, len(prompts),
                                         dtype=np.uint64)]
    self_draft = build_drafter(ht, sd, torch.float32, dev)
    rej_sd = ht.init_llama_params(
        Llama_1B(dtype=torch.float32, num_layers=2),
        torch.Generator(device=dev).manual_seed(seed + 1), dev)
    rejecting = build_drafter(ht, rej_sd, torch.float32, dev, layers=2)
    del rej_sd

    def run(kernel, draft, sampled, keep_logits=False):
        ex, q, b = build_stack(ht, sd, torch.float32, kernel, dev,
                               draft=draft)
        trace = StepTrace(ex, b, keep_logits)
        hs = [q.submit(p, max_new_tokens=new_tokens,
                       **(dict(SAMPLING, seed=seeds[i]) if sampled else {}))
              for i, p in enumerate(prompts)]
        b.run()
        if not all(h.status == "ok" for h in hs):
            raise SystemExit(f"phase 13: {kernel} path: "
                             f"{[h.status for h in hs]}")
        rate = accept_rate(b)
        spt = b.gen_steps / max(b.gen_tokens, 1)
        del ex, q, b
        free_cuda()
        return [h.tokens for h in hs], trace, rate, spt

    out, bad = {}, []
    for name, draft in (("self_draft", self_draft),
                        ("rejecting_draft", rejecting)):
        streams, _, rate, spt = run("cuda", draft, False)
        out[name], clear = greedy_rule(streams, greedy, greedy_trace)
        out[name].update(accept_rate=rate, target_steps_per_token=spt)
        bad += [dict(d, run=name) for d in clear]
    runs = {kernel: run(kernel, self_draft, True, keep_logits=True)
            for kernel in ("cuda", "reference")}
    (s_k, t_k, rate, spt), (s_p, t_p, _, _) = runs["cuda"], runs["reference"]
    diverged = []
    for rid, k in first_divergences(s_k, s_p):
        key = t_p.step_of(rid, k)
        both = key in t_k.logits and key in t_p.logits
        err = (float((t_k.logits[key] - t_p.logits[key]).abs().max())
               if both else None)
        diverged.append({"request": rid, "step": k, "logits_max_err": err})
    out["sampled"] = {"requests": len(prompts),
                      "identical": len(prompts) - len(diverged),
                      "diverged": diverged, "accept_rate": rate,
                      "target_steps_per_token": spt}
    bad += [dict(d, run="sampled") for d in diverged
            if d["logits_max_err"] is None or d["logits_max_err"] >= 1e-3]
    log("spec_parity " + json.dumps(out))
    del sd, self_draft, rejecting, runs
    free_cuda()
    if bad:
        raise SystemExit(f"phase 13: streams diverge at a clear margin: "
                         f"{bad}")
    return out


# ---------------------------------------------------------------------------
# phase 14: the captured steps against the eager body, and a hot swap
# ---------------------------------------------------------------------------

#: phase 14's signatures: (executor, kind, T)
GRAPH_SIGNATURES = (("target", "decode", 1), ("target", "prefill", 128),
                    ("target", "verify", SPEC_K + 1),
                    ("draft", "decode", 1), ("draft", "prefill", 128))


def step_inputs(ex, T, sampled, rng):
    """Seeded inputs of one ``[8, T]`` step: six live rows at assorted
    positions (their pages from a permutation of the pool), two idle;
    rows 1, 3 and 5 sample when ``sampled``."""
    B = ex.max_batch
    positions = np.array([0, 17, 130, 300, 1000, 5, 0, 0], np.int32)
    mask = np.array([True] * 6 + [False] * 2)
    tables = None
    if ex.paged:
        tables = np.full((B, ex.blocks_per_seq), -1, np.int32)
        perm, used = rng.permutation(ex.kv_pool_blocks), 0
        for r in range(6):
            n = -(-(int(positions[r]) + T) // ex.kv_block_size)
            tables[r, :n] = perm[used:used + n]
            used += n
    temperature = np.zeros(B, np.float32)
    if sampled:
        temperature[[1, 3, 5]] = SAMPLING["temperature"]
    sample = {"temperature": temperature,
              "top_p": np.full(B, SAMPLING["top_p"], np.float32),
              "seed": rng.randint(0, 2 ** 32, B, dtype=np.uint64).astype(
                  np.uint32),
              "ctr": rng.randint(0, 100, B).astype(np.int32)}
    n_draft = np.array([3, 2, 3, 0, 3, 1, 0, 0], np.int32)
    return (rng.randint(0, 32000, (B, T)).astype(np.int32), positions,
            mask, rng.randint(0, T, B).astype(np.int32), tables, sample,
            n_draft)


def step_outputs(sig):
    return {k: t.clone() for k, t in (("tokens", sig.out),
                                      ("logits", sig.logits),
                                      ("probs", sig.probs))
            if t is not None}


def replay_vs_eager(ex, kind, T, sampled, rng):
    """One signature's first replay (warm-up, capture, replay) against the
    eager body on the same staged inputs and the same cache state."""
    sig = ex._signature(kind, T)
    sig.stage(*step_inputs(ex, T, sampled, rng))
    if kind == "verify":
        sig.draft_probs.copy_(torch.softmax(torch.randn(
            sig.draft_probs.shape, device=ex.device), dim=-1))
    snap = [(k.clone(), v.clone()) for k, v in ex.cache]
    ex._run(sig, sampled)
    torch.cuda.synchronize()
    got = step_outputs(sig)
    for (k, v), (k0, v0) in zip(ex.cache, snap):
        k.copy_(k0)
        v.copy_(v0)
    ex._body(sig, sampled)
    torch.cuda.synchronize()
    want = step_outputs(sig)
    out = {"kind": kind, "T": T, "sampled": sampled,
           "bit_equal": all(torch.equal(got[k], want[k]) for k in want),
           "k1_launches_per_replay": sig.k1_launches.get(sampled),
           "capture_ms": ex.capture_ms[(kind, T, sampled)]}
    if not out["bit_equal"]:
        # phase 4's rule: differing tokens only where the eager logits'
        # top-2 gap is under 1e-3
        err = {k: float((got[k].double() - want[k].double()).abs().max())
               for k in want if k != "tokens"}
        lg = want["logits"].float()
        top2 = torch.topk(lg, 2, dim=-1).values
        gap = (top2[..., 0] - top2[..., 1]).reshape(lg.shape[0], -1).amin(1)
        n_tok = got["tokens"].numel() // lg.shape[0]
        rows = (got["tokens"].reshape(-1, n_tok)[:lg.shape[0]]
                != want["tokens"].reshape(-1, n_tok)[:lg.shape[0]]).any(1)
        out.update(max_err=err, differing_rows=int(rows.sum()),
                   near_tie=bool((gap[rows] < 1e-3).all()))
    out["ok"] = out["bit_equal"] or (out["near_tie"]
                                     and out["max_err"]["logits"] < 1e-3)
    return out


def graph_phase(ht, paged, dev, seed, new_tokens):
    """Phase 14, fp32, Llama_1B's width at 2 layers: each signature's
    replay equals the eager body (greedy and sampled; K1 launches counted
    per replay), then a hot swap to another seed's weights serves what a
    fresh executor on those weights serves, with no graph added."""
    from horovod_tpu_torch.models.llama import Llama, Llama_1B
    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 products
    layers = 2

    def params(s):
        return ht.init_llama_params(
            Llama_1B(dtype=torch.float32, num_layers=layers),
            torch.Generator(device=dev).manual_seed(s), dev)

    def target(sd):
        cfg = Llama_1B(dtype=torch.float32, num_layers=layers,
                       kv_block_size=BS,
                       kv_pool_blocks=ht.pool_blocks_for(8, 2048, BS),
                       decode_kernel="cuda")
        model = Llama(cfg, device=dev)
        model.load_state_dict(sd)
        return ht.ShardedExecutor(model, max_batch=8, max_len=2048,
                                  device=dev)

    sd_a, sd_b = params(seed + 14), params(seed + 15)
    exs = {"target": target(sd_a),
           "draft": build_drafter(ht, sd_a, torch.float32, dev, layers)}
    gen = torch.Generator(device=dev).manual_seed(seed)
    for e in exs.values():      # a cache of seeded bytes to attend over
        for k, v in e.cache:
            k.normal_(generator=gen)
            v.normal_(generator=gen)
    rng = np.random.RandomState(seed + 14)
    checks = [dict(replay_vs_eager(exs[role], kind, T, sampled, rng),
                   executor=role)
              for role, kind, T in GRAPH_SIGNATURES
              for sampled in (False, True)]
    k1_ok = all(c["k1_launches_per_replay"] == layers for c in checks
                if c["executor"] == "target")
    del exs
    free_cuda()

    def serve(ex):
        q = ht.AdmissionQueue(max_queue=64)
        b = ht.ContinuousBatcher(ex, q, buckets=(128, 512),
                                 prefix_cache=True)
        b.warmup()
        hs = [q.submit(p, max_new_tokens=new_tokens)
              for p in make_requests(seed)[:4]]
        b.run()
        return [h.tokens if h.status == "ok" else h.status for h in hs], b

    ex = target(sd_a)
    streams_a, b = serve(ex)
    j0 = ex.jit_cache_size()
    swapped = ex.swap_params(sd_b, version=2)
    hs = [b.queue.submit(p, max_new_tokens=new_tokens)
          for p in make_requests(seed)[:4]]
    b.run()
    streams_ab = [h.tokens if h.status == "ok" else h.status for h in hs]
    again = ex.swap_params(sd_b, version=2)
    swap = {"swapped": swapped, "resubmitted_v2": again,
            "version": ex.params_version,
            "graphs_before": j0, "graphs_after": ex.jit_cache_size(),
            "streams_differ_from_a": streams_ab != streams_a}
    del ex, b
    free_cuda()
    streams_b, _ = serve(target(sd_b))
    swap["equal_to_fresh_b"] = streams_ab == streams_b
    swap["ok"] = (swapped and not again and swap["equal_to_fresh_b"]
                  and swap["streams_differ_from_a"]
                  and swap["graphs_before"] == swap["graphs_after"])
    out = {"checks": checks, "k1_counted": k1_ok, "swap": swap}
    log("graph " + json.dumps(out))
    free_cuda()
    if not (all(c["ok"] for c in checks) and k1_ok and swap["ok"]):
        raise SystemExit("phase 14: captured steps or swap failed: "
                         + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 15: KV integrity and the KV tier at full width
# ---------------------------------------------------------------------------

#: phase 15's host-RAM ring bound (MiB): some of burst A's demoted blocks
#: spill past it to the disk rung
KVTIER_HOST_MB = 8
#: the batcher iteration at which the serve.kv corrupt fires (burst A)
KV_CORRUPT_AT = 3
#: tracing contexts ride these requests of burst A
TRACED = (1, 2, 3)


class _IndexTrace:
    """A ``StepTrace``'s gaps keyed by (index in a burst, token) in place
    of (request id, token), for ``greedy_rule``."""

    def __init__(self, trace, rids):
        pos = {rid: i for i, rid in enumerate(rids)}
        self.gaps = {(pos[rid], k): g for (rid, k), g in trace.gaps.items()
                     if rid in pos}


def _unwrap(ex):
    """Drop a ``StepTrace`` / counting wrapper from ``ex.step``."""
    ex.__dict__.pop("step", None)


def _burst(b, prompts, new_tokens, times=None, extra=None):
    """Submit ``prompts`` on ``b``'s queue (``extra[i]``: request i's
    further submit arguments) and step it until drained (the main thread
    drives it, so every step of the burst is accounted for); with
    ``times``, each iteration's host ms is appended."""
    hs = [b.queue.submit(p, max_new_tokens=new_tokens,
                         **(extra or {}).get(i, {}))
          for i, p in enumerate(prompts)]
    busy = True
    while busy:
        t0 = time.perf_counter()
        busy = b.step()
        if times is not None:
            times.append((time.perf_counter() - t0) * 1e3)
    return hs


def _evict_all(b, timing):
    """Evict every refcount-zero prefix run (``tests/test_kvtier.py``'s
    ``_evict_all``): with the tier on, each demotes down the ladder;
    each demotion's host ms is appended to ``timing``."""
    tier = b.kvtier
    orig = tier.on_evict

    def timed(ev):
        t0 = time.perf_counter()
        orig(ev)
        timing.append((time.perf_counter() - t0) * 1e3)
    b.prefix.on_evict = timed
    try:
        while b.prefix.evictable_blocks() > 0:
            if b.prefix.evict(64) == 0:
                raise SystemExit("phase 15: eviction freed nothing")
    finally:
        b.prefix.on_evict = orig


def _rung_stats(b, reg):
    """The tier's counts and bytes on each rung, and its metric series."""
    t = b.kvtier
    out = dict(t.stats(), host_bytes=t.host.bytes(),
               disk_bytes=t.disk.bytes() if t.disk is not None else 0)
    for fam in ("demotions", "promotions", "hits"):
        out[fam] = {tier: reg.get(f"hvd_serve_kvtier_{fam}_total",
                                  {"tier": tier}).value
                    for tier in ("host", "disk")}
    out["misses"] = reg.get("hvd_serve_kvtier_misses_total").value
    out["corrupt_total"] = reg.get("hvd_serve_kvtier_corrupt_total").value
    return out


def _p50(xs):
    return float(np.median(xs)) if len(xs) else None


def ledger_profile(ht, b, prompts, iters=6):
    """``--profile``: the device-to-host copies and host syncs of
    ``iters`` decode-only iterations with the crc ledger on (no other
    wrapper on the executor's step): totals per iteration, and the
    ledger's share (less the step's own readback: one copy, one sync)."""
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    hs = [b.queue.submit(p, max_new_tokens=iters + 6) for p in prompts[:8]]
    for _ in range(2):              # the admission wave and its prefill
        b.step()
    r0 = b.executor.kv_reads
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            b.step()
        torch.cuda.synchronize()
    reads = b.executor.kv_reads - r0
    b.run()
    ev = prof.events()
    dtoh = sum(1 for e in ev if e.device_type == DeviceType.CUDA
               and "DtoH" in e.name)
    htod = sum(1 for e in ev if e.device_type == DeviceType.CUDA
               and "HtoD" in e.name)
    syncs = sum(1 for e in ev if e.name == "cudaStreamSynchronize")
    launches = sum(1 for e in ev if e.name in ("cudaLaunchKernel",
                                               "cudaLaunchKernelExC"))
    return {"iterations": iters, "ok": all(h.status == "ok" for h in hs),
            "dtoh_per_iter": dtoh / iters, "htod_per_iter": htod / iters,
            "syncs_per_iter": syncs / iters,
            "kernel_launches_per_iter": launches / iters,
            "ledger_reads_per_iter": reads / iters,
            "ledger_dtoh_per_iter": dtoh / iters - 1,
            "ledger_syncs_per_iter": syncs / iters - 1}


def kv_tier_phase(ht, paged, dev, seed, new_tokens, smi, profile=False):
    """Phase 15: the crc ledger, the chaos serve.kv and kvtier.promote
    sites, trace spans and the KV tier on phase 3's stack at full width.

    Baseline (kv_crc off, no plan, the same process): burst A (phase 3's 9
    requests) and the five shared-prefix requests cold. Then the stack
    with ``kv_crc=True``, the KV tier (host ring KVTIER_HOST_MB, a
    temporary spill directory) and a chaos plan (one serve.kv corrupt at
    iteration KV_CORRUPT_AT, one kvtier.promote corrupt at the last
    promotion of burst B): burst A (three requests traced), every
    refcount-zero run evicted down the ladder, burst B (the five
    shared-prefix requests return), every run evicted again, a hot swap
    to the same weights at version 2, burst C (the five again)."""
    import tempfile
    import zlib
    from horovod_tpu_torch.chaos import inject as chaos
    from horovod_tpu_torch.chaos.plan import ChaosPlan
    from horovod_tpu_torch.models.llama import Llama_1B
    from horovod_tpu_torch.obs import metrics as obs_metrics
    from horovod_tpu_torch.trace import TraceContext, get_recorder
    cfg = Llama_1B(dtype=torch.bfloat16)
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    # what earlier phases leave allocated in this process
    mem_at_start = torch.cuda.memory_allocated() / 1e9
    t_phase = time.perf_counter()
    sd = ht.init_llama_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), dev)
    prompts = make_requests(seed)
    shared = [prompts[i] for i in range(0, len(prompts), 2)]
    out = {"card": smi, "host_mb": KVTIER_HOST_MB,
           "mem_at_start_gb": mem_at_start}
    bad = []

    # ---- baseline: kv_crc off, no plan ----
    ex, q, b = build_stack(ht, sd, torch.bfloat16, None, dev, kv_crc=False,
                           kv_tier=False)
    trace = StepTrace(ex, b)
    it_off = []
    hs = _burst(b, prompts, new_tokens, it_off)
    base_a = [h.tokens for h in hs]
    gaps_a = _IndexTrace(trace, [h.rid for h in hs])
    _unwrap(ex)
    off_p50 = {k: ex.p50_step_ms(k) for k in ("prefill", "decode")}
    b2 = ht.ContinuousBatcher(ex, ht.AdmissionQueue(max_queue=64),
                              buckets=(128, 512), prefix_cache=True,
                              kv_crc=False, kv_tier=False)
    trace = StepTrace(ex, b2)
    hs = _burst(b2, shared, new_tokens)
    base_b = [h.tokens for h in hs]
    gaps_b = _IndexTrace(trace, [h.rid for h in hs])
    ttft_cold = [h.ttft_ms for h in hs]
    if not all(h.status == "ok" for h in hs) or len(base_a) != 9:
        raise SystemExit("phase 15: the baseline failed")
    del ex, q, b, b2, trace, hs
    free_cuda()
    # the phase's peak so far (the baseline's), and what stays allocated
    # once the baseline is released (the state dict, kept for the swap)
    out["baseline_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["mem_after_baseline_gb"] = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()

    # ---- the stack under test ----
    spill = tempfile.mkdtemp(prefix="kvtier_")
    ex, q, b = build_stack(ht, sd, torch.bfloat16, None, dev, kv_crc=True,
                           kv_tier=True, kvtier_host_mb=KVTIER_HOST_MB,
                           kvtier_dir=spill)
    if ex.kernel != "cuda" or b.kvtier is None:
        raise SystemExit(f"phase 15: kernel {ex.kernel}, tier {b.kvtier}")
    # the promote corrupt lands on burst B's last promotion: request 0's
    # promotable blocks (all demoted), then request 8's past the shared
    # 256-token prefix (16 blocks, promoted with request 0's)
    n0, n8 = ((len(p) - 1) // BS for p in (shared[0], shared[-1]))
    promote_at = n0 + max(n8 - 256 // BS, 0) - 1
    plan = {"seed": seed, "faults": [
        {"rank": 0, "site": "serve.kv", "kind": "corrupt",
         "at": KV_CORRUPT_AT},
        {"rank": 0, "site": "kvtier.promote", "kind": "corrupt",
         "at": promote_at}]}
    out["plan"] = plan
    log("kvtier_plan " + json.dumps(plan))
    reg = obs_metrics.get_registry()
    rec = get_recorder()
    verify_ms, crc_ms, demote_ms, promote = [], {}, [], []
    orig_verify, orig_crc = b._kv_verify, b._crc_write
    orig_promote, orig_install = b.kvtier.promote_for, ex.install_kv_blocks

    def timed_verify(seq):
        t0 = time.perf_counter()
        ok = orig_verify(seq)
        if b.kv_crc and seq.cache_len > 0:
            verify_ms.append((time.perf_counter() - t0) * 1e3)
        return ok

    def timed_crc(spans):
        t0 = time.perf_counter()
        orig_crc(spans)
        kind = ("decode" if spans and all(hi - lo == 1
                                          for _, lo, hi in spans)
                else "prefill" if spans and all(hi - lo > 1
                                                for _, lo, hi in spans)
                else "other")
        crc_ms.setdefault(kind, []).append(
            (time.perf_counter() - t0) * 1e3)

    def timed_promote(prompt):
        t0 = time.perf_counter()
        n = orig_promote(prompt)
        if n:
            promote.append(((time.perf_counter() - t0) * 1e3, n))
        return n

    # the prefill buckets of each burst (a returning request's suffix
    # may fit the smaller one)
    buckets = {"a": [], "b": [], "c": []}
    cur = {"burst": "a"}
    orig_bucket = b._bucket_for

    def bucket_for(n):
        got = orig_bucket(n)
        buckets[cur["burst"]].append(got)
        return got
    b._bucket_for = bucket_for
    demoted_crcs = set()
    reread = {"blocks": 0, "equal": 0, "installs": 0}

    def checked_install(blocks, payload, lengths):
        orig_install(blocks, payload, lengths)
        reread["installs"] += 1
        for blk, lb, n in zip(blocks, payload, lengths):
            got = [zlib.crc32(x) for x in ex.kv_block_bytes(blk, 0, n)]
            reread["blocks"] += 1
            reread["equal"] += int(got == [zlib.crc32(x) for x in lb]
                                   and tuple(got) in demoted_crcs)

    b._kv_verify, b._crc_write = timed_verify, timed_crc
    b.kvtier.promote_for = timed_promote
    ex.install_kv_blocks = checked_install
    trace = StepTrace(ex, b)
    replays = ReplayCheck(ex)
    corrupt0 = reg.get("hvd_serve_kvtier_corrupt_total").value
    chaos.install(ChaosPlan.from_dict(plan), rank=0)
    try:
        # ---- the main path: counts from 0, read right after ----
        paged.paged_attention_fused.launches = 0
        ctxs = {i: TraceContext.mint() for i in TRACED}
        it_on = []
        reads0 = ex.kv_reads
        hs_a = _burst(b, prompts, new_tokens, it_on, {
            i: {"trace": c.to_wire()} for i, c in ctxs.items()})
        reads_a = ex.kv_reads - reads0
        a_rule, a_bad = greedy_rule([h.tokens for h in hs_a], base_a,
                                    gaps_a)
        spans = {}
        for i, c in ctxs.items():
            got = {s["name"]: s for s in rec.drain(c.trace_id)
                   if s.get("trace") == c.trace_id}
            qp = sum((got[n]["t1"] - got[n]["t0"]) * 1e3
                     for n in ("queue_wait", "prefill") if n in got)
            spans[i] = {"names": sorted(got), "queue_wait_plus_prefill_ms":
                        qp, "ttft_ms": hs_a[i].ttft_ms}
        chaos_a = {"injected": b.kv_corruptions_injected,
                   "detected": b.kv_corruptions_detected,
                   "reprefills": b.kv_reprefills,
                   "metric": reg.get(
                       "hvd_serve_kv_corruptions_total").value}
        _evict_all(b, demote_ms)
        after_a = _rung_stats(b, reg)
        for e in b.kvtier.host._entries.values():
            demoted_crcs.add(tuple(e.crcs))
        for name in os.listdir(spill):
            demoted_crcs.add(tuple(ht.read_spill_file(
                os.path.join(spill, name))[0]["crcs"]))

        cur["burst"] = "b"
        hs_b = _burst(b, shared, new_tokens)
        b_rule, b_bad = greedy_rule([h.tokens for h in hs_b], base_b,
                                    gaps_b)
        after_b = _rung_stats(b, reg)
        _evict_all(b, demote_ms)
        before_swap = _rung_stats(b, reg)
        live = ex.model.state_dict()
        swapped = ex.swap_params({k: v.to(live[k].dtype)
                                  for k, v in sd.items()}, version=2)
        del live
        cur["burst"] = "c"
        hs_c = _burst(b, shared, new_tokens)
        c_rule, c_bad = greedy_rule([h.tokens for h in hs_c], base_b,
                                    gaps_b)
        after_c = _rung_stats(b, reg)
        torch.cuda.synchronize()
        launches = paged.paged_attention_fused.launches
    finally:
        chaos.uninstall()
    graphs = replays.done()
    del sd
    out.update({
        "launches": launches, "graphs": graphs,
        "statuses": [h.status for h in hs_a + hs_b + hs_c],
        "chaos_a": chaos_a, "kvtier_corrupt_total":
        after_c["corrupt_total"] - corrupt0,
        "streams": {"a": a_rule, "b": b_rule, "c": c_rule},
        "spans": spans,
        "ladder": {"after_a": after_a, "after_b": after_b,
                   "before_swap": before_swap, "after_c": after_c},
        "promoted_reread": reread, "swapped": swapped,
        "version": ex.params_version,
        "step_p50_ms": {"kv_crc_on": {k: ex.p50_step_ms(k) for k in
                                      ("prefill", "decode")},
                        "kv_crc_off": off_p50},
        "iteration_p50_ms_burst_a": {"kv_crc_on": _p50(it_on),
                                     "kv_crc_off": _p50(it_off)},
        "ledger_ms_p50": {k: _p50(v) for k, v in crc_ms.items()},
        "ledger_calls": {k: len(v) for k, v in crc_ms.items()},
        "ledger_reads_burst_a": reads_a,
        "ledger_read_bytes": ex.kv_read_bytes,
        "verify_ms": {"p50": _p50(verify_ms),
                      "max": max(verify_ms, default=None),
                      "n": len(verify_ms)},
        "demote_ms_per_block": {"p50": _p50(demote_ms),
                                "n": len(demote_ms)},
        "promote_ms_per_block": [ms / n for ms, n in promote],
        "promote_calls": [[ms, n] for ms, n in promote],
        "ttft_p50_ms": {"returning_promoted": _p50(
            [h.ttft_ms for h in hs_b]), "cold": _p50(ttft_cold),
            "returning_after_swap": _p50([h.ttft_ms for h in hs_c])},
        "prefill_buckets": buckets})
    if profile:
        _unwrap(ex)
        out["ledger_profile"] = ledger_profile(ht, b, prompts)
    out["peak_mem_gb"] = max(torch.cuda.max_memory_allocated() / 1e9,
                             out["baseline_peak_mem_gb"])
    out["main_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["phase_s"] = time.perf_counter() - t_phase
    promoted_b = after_b["promoted_blocks"] - after_a["promoted_blocks"]
    checks = {
        "all_ok": all(st == "ok" for st in out["statuses"]),
        "launched_k1": launches > 0,
        "replays": graphs["ok"],
        "one_kv_corruption": (chaos_a["injected"], chaos_a["detected"],
                              chaos_a["reprefills"]) == (1, 1, 1),
        "streams_a": not a_bad, "streams_b": not b_bad,
        "streams_c": not c_bad,
        "spans": all(v["names"] == ["decode", "prefill", "queue_wait"]
                     and abs(v["queue_wait_plus_prefill_ms"]
                             - v["ttft_ms"]) <= 1.0
                     for v in spans.values()),
        "promote_corrupt_caught": out["kvtier_corrupt_total"] == 1
        and after_b["corrupt_detected"] == 1,
        "promoted_from_both_rungs": promoted_b > 0
        and after_b["promotions"]["host"] > 0
        and after_b["promotions"]["disk"] > 0,
        "spilled_to_disk": after_a["disk_runs"] > 0,
        "promoted_bytes_equal": reread["blocks"] > 0
        and reread["equal"] == reread["blocks"],
        "swap_fenced": swapped and ex.params_version == 2
        and after_c["promoted_blocks"] == after_b["promoted_blocks"]
        and after_c["host_runs"] == 0,
    }
    out["checks"] = checks
    log("kvtier " + json.dumps(out))
    b.stop()
    # the wrappers above and the methods they wrap hold the stack
    del ex, q, b, trace, replays, timed_verify, timed_crc, timed_promote
    del checked_install, bucket_for, orig_verify, orig_crc, orig_promote
    del orig_install, orig_bucket
    free_cuda()
    if not all(checks.values()):
        raise SystemExit("phase 15: KV integrity / tier failed: "
                         + json.dumps({k: v for k, v in checks.items()
                                       if not v}))
    return out


# ---------------------------------------------------------------------------
# phase 16: the in-process serving fleet at full width
# ---------------------------------------------------------------------------

#: the fleet router's heartbeat interval and suspect threshold (s): the
#: router's defaults. The threshold must exceed the longest scheduling
#: iteration (a full prefill wave with its crc ledger, both replicas on
#: one GIL: the ``fleet`` line's ``heartbeat_gaps_s``); a dead scheduler
#: thread is ejected at the next sweep (interval / 2) whatever it is.
FLEET_INTERVAL_S, FLEET_SUSPECT_S = 0.25, 1.0
#: replica 0's serve.step crash lands this many iterations into burst 2
FLEET_CRASH_AFTER = 3
#: phase 16's stream rule (phase 13's clear margin, in bf16): a stream may
#: leave the one-replica stream only at a step whose logits, in the two
#: runs, differ by more than the one-replica run's top-2 gap there (the
#: difference tipped a near tie) and by at most this share of the row's
#: largest |logit| (bf16 rounding of another batch composition or prefill
#: bucket; a wrong kernel or wrong KV moves logits by O(1))
FLEET_LOGIT_BAR = 2 ** -5


class _LogitTrace:
    """The logits row of every active request at every step of the
    wrapped executors, kept on the device (cloned on the executor's
    stream, no host sync), keyed by (prompt, index of the token the step
    emits)."""

    def __init__(self):
        self.rows = {}
        self.lock = threading.Lock()

    def wrap(self, ex, batcher_of):
        step = ex.step

        def traced(*a, **kw):
            out = step(*a, **kw)
            b, lg = batcher_of(), ex.last_logits
            with ex.on_stream():
                for row, seq in list(b._active.items()):
                    if a[2][row]:
                        key = (tuple(seq.req.prompt), len(seq.out))
                        got = lg[row].clone()
                        with self.lock:
                            self.rows.setdefault(key, []).append(got)
            return out
        ex.step = traced


def fleet_rule(streams, prompts, want, ref, got):
    """``streams[i]`` (of ``prompts[i]``) against ``want[prompt]`` (one
    replica alone) by FLEET_LOGIT_BAR's rule, ``ref`` / ``got`` the two
    runs' ``_LogitTrace``. Returns (report, the clear divergences)."""
    diverged = []
    for s, p in zip(streams, prompts):
        w = want[tuple(p)]
        if s == w:
            continue
        k = next((i for i, (x, y) in enumerate(zip(s, w)) if x != y),
                 min(len(s), len(w)))
        r = ref.rows.get((tuple(p), k))
        f = got.rows.get((tuple(p), k), [])
        d = {"prompt_len": len(p), "step": k}
        if r and f:
            lr = r[0].float()
            top2 = torch.topk(lr, 2).values
            d["ref_top2_gap"] = float(top2[0] - top2[1])
            d["logits_max_diff"] = max(float((x.float() - lr).abs().max())
                                       for x in f)
            d["bar"] = FLEET_LOGIT_BAR * max(1.0, float(lr.abs().max()))
        d["ok"] = bool(r and f and d["ref_top2_gap"]
                       <= d["logits_max_diff"] <= d["bar"])
        diverged.append(d)
    return ({"requests": len(streams),
             "identical": len(streams) - len(diverged),
             "diverged": diverged},
            [d for d in diverged if not d["ok"]])


def _post_generate(base, prompt, new_tokens, out):
    """``POST /generate`` of one request; ``out`` gets the reply, its
    status code and its headers."""
    req = urllib.request.Request(
        base + "/generate", data=json.dumps(
            {"tokens": prompt, "max_new_tokens": new_tokens}).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            out.update(json.loads(r.read()), code=r.status,
                       headers=dict(r.headers))
    except urllib.error.HTTPError as e:
        out.update(json.loads(e.read()), code=e.code, headers=dict(e.headers))


def _on_scheduler(rep, fn, timeout=60.0):
    """Run ``fn(batcher)`` on replica ``rep``'s scheduler thread, at the
    top of its next iteration (through its heartbeat hook), and wait."""
    b, done, err = rep.batcher, threading.Event(), []
    hb = b.heartbeat

    def once():
        b.heartbeat = hb
        try:
            fn(b)
        except Exception as e:  # noqa: BLE001 — re-raised by the caller
            err.append(e)
        finally:
            done.set()
        hb()
    b.heartbeat = once
    if not done.wait(timeout):
        raise SystemExit("phase 16: the scheduler never ran the request")
    if err:
        raise err[0]


def _k1_state(rep):
    ex = rep.executor
    return {"k1_launches": ex.k1_launches, "replays": ex.replays,
            "graphs": ex.jit_cache_size(), "version": ex.params_version}


def _pct(xs, q):
    xs = [x for x in xs if x is not None]
    return float(np.percentile(xs, q)) if xs else None


class _StallWatch:
    """Each replica's longest gap between heartbeats, and, when a
    replica's heartbeat age passes ``limit`` seconds (before the router
    would suspect it), every thread's stack, logged once per stall: what
    held the scheduler."""

    def __init__(self, reps, limit):
        self.reps, self.limit = reps, limit
        self.max_gap = {r.id: 0.0 for r in reps}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="fleet-stall-watch")
        self._thread.start()

    def _loop(self):
        import traceback
        stalled = set()
        while not self._stop.wait(0.02):
            now = time.monotonic()
            for r in self.reps:
                if r.state != "up":
                    stalled.discard(r.id)
                    continue
                age = now - r.hb_time
                self.max_gap[r.id] = max(self.max_gap[r.id], age)
                if age <= self.limit:
                    stalled.discard(r.id)
                elif r.id not in stalled:
                    stalled.add(r.id)
                    names = {t.ident: t.name for t in threading.enumerate()}
                    stacks = "".join(
                        f"--- {names.get(i, i)}\n"
                        + "".join(traceback.format_stack(f)[-6:])
                        for i, f in sys._current_frames().items())
                    log(f"fleet_stall replica={r.id} heartbeat_age_s="
                        f"{age:.3f}\n{stacks}")

    def gaps(self):
        return dict(self.max_gap)

    def stop(self):
        self._stop.set()
        self._thread.join(5)


def fleet_phase(ht, paged, dev, seed, new_tokens, smi, serve_tps=None):
    """Phase 16: two full-width Llama_1B replicas (bf16, ``replica_id`` 0
    and 1, max_batch 8, block 16, max_len 2048, buckets (128, 512), the
    prefix cache, ``kv_crc`` and the KV tier with a host ring of
    KVTIER_HOST_MB and a spill directory each) behind ``FleetRouter``
    (heartbeat FLEET_INTERVAL_S, suspect FLEET_SUSPECT_S) and
    ``make_fleet_server``, seeded weights (one fp32 copy, loaded into
    both), a ``WeightSubscriber`` each on a ``WeightPublisher``'s channel
    in an in-process ``StoreServer`` (version 1 at start). First the
    reference: phase 3's 9 requests on replica 0's executor alone. Then
    four bursts, each with one request through ``POST /generate``:

    1. fan-out: the 9 twice over (18), held to the reference streams;
    2. crash: a serve.step crash on replica 0 FLEET_CRASH_AFTER
       iterations in (version 2 published through the stream just
       before: a 2.2 GB publish takes seconds, which the dying
       scheduler thread must not spend): ejected,
       its requests re-queued once on replica 1, rebuilt over its
       executor with no capture, re-admitted on version 2;
    3. pull: the 5 shared-prefix requests served on replica 0, their runs
       demoted to its ladder, then returning while a serve.route
       partition cuts replica 0 off: they land on replica 1, which the
       router grafts the runs into (one payload corrupted on its way and
       refused), held to the reference streams;
    4. drain: SIGTERM mid-burst; submits then are shed with
       retry_after_ms (429 over HTTP), the tail finishes, every request
       is answered once.
    """
    import signal
    import tempfile
    import zlib
    from horovod_tpu_torch.chaos import inject as chaos
    from horovod_tpu_torch.chaos.plan import ChaosPlan
    from horovod_tpu_torch.models.llama import Llama, Llama_1B
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    cfg = Llama_1B(dtype=torch.bfloat16)
    sd = ht.init_llama_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), dev)

    def executor(rid):
        c = Llama_1B(dtype=torch.bfloat16, kv_block_size=BS,
                     kv_pool_blocks=ht.pool_blocks_for(8, 2048, BS))
        model = Llama(c, device=dev)
        model.load_state_dict(sd)
        return ht.ShardedExecutor(model, max_batch=8, max_len=2048,
                                  device=dev, replica_id=rid)

    execs = [executor(0), executor(1)]
    if any(ex.kernel != "cuda" for ex in execs):
        raise SystemExit("phase 16: an executor did not resolve the kernel")
    live = execs[0].model.state_dict()
    pub_sd = {k: v.to(live[k].dtype) for k, v in sd.items()}
    del live, sd
    free_cuda()
    spill = tempfile.mkdtemp(prefix="fleet_")
    tier_kw = dict(kv_crc=True, prefix_cache=True, kv_tier=True,
                   kvtier_host_mb=KVTIER_HOST_MB)
    prompts = make_requests(seed)
    shared = [prompts[i] for i in range(0, len(prompts), 2)]
    out = {"card": smi, "interval_s": FLEET_INTERVAL_S,
           "suspect_s": FLEET_SUSPECT_S, "host_mb": KVTIER_HOST_MB}
    checks = {}

    # ---- the reference: replica 0's executor alone ----
    ref_b = ht.ContinuousBatcher(
        execs[0], ht.AdmissionQueue(max_queue=64), buckets=(128, 512),
        kvtier_dir=os.path.join(spill, "alone"), **tier_kw)
    ref_b.warmup()
    ref = _LogitTrace()
    ref.wrap(execs[0], lambda: ref_b)
    hs = _burst(ref_b, prompts, new_tokens)
    _unwrap(execs[0])
    if not all(h.status == "ok" for h in hs):
        raise SystemExit("phase 16: the one-replica reference failed")
    want = {tuple(p): h.tokens for p, h in zip(prompts, hs)}
    del ref_b, hs

    # ---- the fleet, on the weight stream ----
    from horovod_tpu_torch.native.store import StoreServer
    from horovod_tpu_torch.redist.stream import (WeightPublisher,
                                                 WeightSubscriber)
    store = StoreServer()
    pub = WeightPublisher("phase16", kv_addr="127.0.0.1",
                          kv_port=store.port, resume_timeout=0.05)
    pub.publish(pub_sd)                                     # version 1
    out["publish_v1"] = dict(pub.last)
    subs = [WeightSubscriber("phase16", kv_addr="127.0.0.1",
                             kv_port=store.port, template=execs[i].model)
            for i in range(2)]
    reps = [ht.Replica(i, execs[i], buckets=(128, 512), max_queue=64,
                       subscriber=subs[i],
                       kvtier_dir=os.path.join(spill, str(i)), **tier_kw)
            for i in range(2)]
    router = ht.FleetRouter(reps, interval_s=FLEET_INTERVAL_S,
                            suspect_s=FLEET_SUSPECT_S)
    events = []
    router.add_listener(events.append)
    t0 = time.perf_counter()
    router.start()
    out["start_s"] = time.perf_counter() - t0
    watch = _StallWatch(reps, 0.6 * FLEET_SUSPECT_S)
    srv = None
    try:
        srv = ht.make_fleet_server(router)
        srv_thread = threading.Thread(target=srv.serve_forever, daemon=True)
        srv_thread.start()
        base = "http://%s:%d" % srv.server_address
        deadline = time.monotonic() + 60
        while any(r.executor.params_version != 1 for r in reps):
            if time.monotonic() > deadline:
                raise SystemExit("phase 16: version 1 was not adopted")
            time.sleep(0.02)
        all_handles, dispatch_ms = [], []

        def burst(ps, http_index=0):
            """Submit ``ps`` through the router, ``ps[http_index]`` through
            ``POST /generate``; wait for all. Returns (handles, HTTP reply,
            wall seconds)."""
            reply = {}
            poster = threading.Thread(target=_post_generate, args=(
                base, ps[http_index], new_tokens, reply))
            t_start = time.perf_counter()
            poster.start()
            hs = []
            for i, p in enumerate(ps):
                if i == http_index:
                    continue
                t = time.perf_counter()
                hs.append(router.submit(p, max_new_tokens=new_tokens))
                dispatch_ms.append((time.perf_counter() - t) * 1e3)
            for h in hs:
                h.wait(600)
            poster.join(600)
            all_handles.extend(hs)
            return hs, reply, time.perf_counter() - t_start

        def streams_of(hs, reply, ps, http_index=0):
            st = [h.tokens for h in hs]
            st.insert(http_index, reply.get("tokens", []))
            return st

        before = [_k1_state(r) for r in reps]
        # ---- the main path: counts from 0, read right after ----
        paged.paged_attention_fused.launches = 0

        # the crc ledger's host ms a call, by replica (burst 1's batchers)
        ledger = {r.id: [] for r in reps}
        for r in reps:
            def timed_crc(spans, r=r, orig=r.batcher._crc_write):
                t = time.perf_counter()
                orig(spans)
                ledger[r.id].append((time.perf_counter() - t) * 1e3)
            r.batcher._crc_write = timed_crc
            r.executor.kv_read_ms.clear()
        # ---- burst 1: fan-out ----
        fan = prompts + prompts
        got = _LogitTrace()
        for r in reps:
            got.wrap(r.executor, lambda r=r: r.batcher)
        hs, reply, wall = burst(fan)
        for r in reps:
            _unwrap(r.executor)
        st = streams_of(hs, reply, fan)
        rule1, bad1 = fleet_rule(st, fan, want, ref, got)
        gen = sum(len(x) for x in st)
        e2e = [h.latency_ms for h in hs] + [reply.get("latency_ms")]
        out["fanout"] = {
            "requests": len(fan), "generated_tokens": gen, "wall_s": wall,
            "tokens_per_s": gen / wall, "phase3_tokens_per_s": serve_tps,
            "by_replica": {str(i): sum(1 for h in hs if h.replica == i)
                           + int(reply.get("replica") == i) for i in (0, 1)},
            "e2e_ms_p50": _pct(e2e, 50), "e2e_ms_p99": _pct(e2e, 99),
            "streams": rule1}
        out["fanout"]["ledger_ms"] = {
            str(i): {"max": max(v, default=None), "p50": _p50(v),
                     "n": len(v), "read_max": max(
                         reps[i].executor.kv_read_ms, default=None)}
            for i, v in ledger.items()}
        checks["fanout_ok"] = (all(h.status == "ok" for h in hs)
                               and reply.get("code") == 200
                               and all(len(x) == new_tokens for x in st))
        checks["fanout_streams"] = not bad1
        checks["fanout_spread"] = all(v > 0 for v in
                                      out["fanout"]["by_replica"].values())
        del got

        # ---- burst 2: replica 0 crashes mid-burst ----
        crash = {}

        def on_fire(ev):
            # inside the injector, on the dying thread: version 2 is the
            # newest published as the replica crashes, so its re-admission
            # must reach it
            if ev["kind"] == "crash":
                crash["t"] = time.time()
                crash["version"] = pub._version
        pub.publish(pub_sd)                                 # version 2
        out["publish_v2"] = dict(pub.last)
        it0 = reps[0].batcher.iterations
        plan = {"seed": seed, "faults": [
            {"rank": 0, "site": "serve.step", "kind": "crash", "peer": 0,
             "at": it0 + FLEET_CRASH_AFTER}]}
        stats0 = router.stats()
        graphs0 = [r.executor.jit_cache_size() for r in reps]
        got = _LogitTrace()
        for r in reps:
            got.wrap(r.executor, lambda r=r: r.batcher)
        chaos.install(ChaosPlan.from_dict(plan), rank=0)
        chaos.injector().add_listener(on_fire)
        try:
            hs, reply, wall = burst(prompts, http_index=1)
            deadline = time.monotonic() + 120
            while not any(e["event"] == "readmit" for e in events):
                if time.monotonic() > deadline:
                    raise SystemExit(
                        "phase 16: replica 0 was not re-admitted: "
                        + json.dumps(events, default=str))
                time.sleep(0.02)
        finally:
            chaos.uninstall()
        for r in reps:
            _unwrap(r.executor)
        st = streams_of(hs, reply, prompts, 1)
        rule2, bad2 = fleet_rule(st, prompts, want, ref, got)
        del got
        stats2 = router.stats()
        eject = next(e for e in events if e["event"] == "eject")
        readmit = next(e for e in events if e["event"] == "readmit")
        requeued = stats2["requeued"] - stats0["requeued"]
        moved = [h for h in hs if h.attempts > 1]
        out["crash"] = {
            "plan": plan, "eject": eject, "readmit": readmit,
            "eject_after_crash_s": eject["t"] - crash.get("t", float("nan")),
            "failover_ms": router.last_failover_ms,
            "readmission_s": readmit["t"] - eject["t"],
            "readmitted": "rebuilt" if readmit.get("rebuilt") else "recovered",
            "requeued": requeued,
            "attempts": [h.attempts for h in hs],
            "duplicates_suppressed": stats2["duplicates_suppressed"],
            "rejected": stats2["rejected"] - stats0["rejected"],
            "graphs_before": graphs0,
            "graphs_after": [r.executor.jit_cache_size() for r in reps],
            "restarts": [r.restarts for r in reps],
            "versions": [r.executor.params_version for r in reps],
            "streams": rule2}
        checks["crash_answered"] = (all(h.status == "ok" for h in hs)
                                    and reply.get("code") == 200)
        checks["crash_streams"] = not bad2
        checks["crash_ejected_in_time"] = (
            eject["replica"] == 0
            and out["crash"]["eject_after_crash_s"] <= FLEET_SUSPECT_S)
        # the request through HTTP is re-queued too when it was on replica 0
        checks["crash_requeued_once"] = (
            requeued > 0 and len(moved) <= requeued <= len(moved) + 1
            and all(h.attempts == 2 and h.replica == 1 for h in moved)
            and all(h.attempts <= 2 for h in hs))
        checks["crash_rebuilt_no_capture"] = (
            readmit["replica"] == 0 and readmit.get("rebuilt") is True
            and reps[0].restarts == 1
            and out["crash"]["graphs_after"] == graphs0)
        checks["crash_readmitted_on_v2"] = (
            crash.get("version") == 2 and readmit["weights_version"] == 2)

        # ---- burst 3: the pull ----
        deadline = time.monotonic() + 60
        while any(r.executor.params_version != 2 for r in reps):
            if time.monotonic() > deadline:
                raise SystemExit("phase 16: version 2 was not adopted")
            time.sleep(0.02)
        warm = [reps[0].queue.submit(p, max_new_tokens=new_tokens)
                for p in shared]
        for h in warm:
            h.wait(600)
        demote_ms = []
        _on_scheduler(reps[0], lambda b: _evict_all(b, demote_ms))
        tier0 = reps[0].batcher.kvtier
        demoted = {tuple(e.crcs) for e in tier0.host._entries.values()}
        d0 = os.path.join(spill, "0")
        for name in os.listdir(d0):
            demoted.add(tuple(ht.read_spill_file(os.path.join(d0, name))[0]
                              ["crcs"]))
        deadline = time.monotonic() + 30
        while not all(router.kvtier_index.lookup(p).get(0, (0, "hbm"))[1]
                      in ("host", "disk") for p in shared):
            if time.monotonic() > deadline:
                raise SystemExit("phase 16: the index never saw the demotion")
            time.sleep(0.02)
        pulls = {"exports": [], "pull_ms": [], "corrupted": 0}
        orig_export = tier0.export_run

        def export(p, version):
            packed = orig_export(p, version)
            if packed is not None:
                pulls["exports"].append(len(packed[0]["blocks"]))
                if not pulls["corrupted"]:
                    # the first payload is damaged on its way: the router's
                    # crc gate must refuse it
                    pulls["corrupted"] += 1
                    hdr, pay = packed
                    packed = hdr, bytes([pay[0] ^ 0x10]) + pay[1:]
            return packed
        tier0.export_run = export
        orig_pull = router._maybe_pull_run

        def timed_pull(rep, p, matched):
            t = time.perf_counter()
            orig_pull(rep, p, matched)
            pulls["pull_ms"].append((time.perf_counter() - t) * 1e3)
        router._maybe_pull_run = timed_pull
        ex1 = reps[1].executor
        orig_install = ex1.install_kv_blocks
        reread = {"blocks": 0, "equal": 0}

        def checked_install(blocks, payload, lengths):
            orig_install(blocks, payload, lengths)
            for blk, lb, n in zip(blocks, payload, lengths):
                c = [zlib.crc32(x) for x in ex1.kv_block_bytes(blk, 0, n)]
                reread["blocks"] += 1
                reread["equal"] += int(c == [zlib.crc32(x) for x in lb]
                                       and tuple(c) in demoted)
        ex1.install_kv_blocks = checked_install
        pulls0 = router._m_kvtier_pulls.value
        saved0 = reps[1].batcher.prefix.tokens_saved
        got = _LogitTrace()
        got.wrap(ex1, lambda: reps[1].batcher)
        chaos.install(ChaosPlan.from_dict({"seed": seed, "faults": [
            {"rank": 0, "site": "serve.route", "kind": "partition", "peer": 0,
             "at": router._dispatches[0], "seconds": 300.0}]}), rank=0)
        try:
            hs, reply, wall = burst(shared, http_index=2)
        finally:
            chaos.uninstall()
            router._maybe_pull_run = orig_pull
            tier0.export_run = orig_export
            _unwrap(ex1)
        st = streams_of(hs, reply, shared, 2)
        rule3, bad3 = fleet_rule(st, shared, want, ref, got)
        del got
        n_pulls = router._m_kvtier_pulls.value - pulls0
        out["pull"] = {
            "demote_ms_per_block_p50": _p50(demote_ms),
            "demoted_blocks": len(demote_ms),
            "rungs": {"host": tier0.host.count(), "disk": tier0.disk.count()},
            "pulls": n_pulls,
            "pull_corrupt_refused": router.kvtier_pull_corrupt,
            "blocks_a_pull": pulls["exports"],
            "pull_ms": pulls["pull_ms"],
            "pull_ms_p50": _p50(pulls["pull_ms"]),
            "installed_reread": reread,
            "pulls_in": reps[1].batcher.kvtier.pulls_in,
            "tokens_saved_replica1":
            reps[1].batcher.prefix.tokens_saved - saved0,
            "by_replica": [h.replica for h in hs] + [reply.get("replica")],
            "streams": rule3}
        checks["pull_answered"] = (all(h.status == "ok" for h in hs)
                                   and reply.get("code") == 200)
        checks["pull_routed_around"] = set(out["pull"]["by_replica"]) == {1}
        checks["pull_corrupt_refused"] = router.kvtier_pull_corrupt == 1
        checks["pull_installed_crcs"] = (n_pulls > 0 and reread["blocks"] > 0
                                         and reread["equal"]
                                         == reread["blocks"])
        checks["pull_streams"] = not bad3
        ex1.install_kv_blocks = orig_install

        # ---- burst 4: SIGTERM drain mid-burst ----
        old = signal.getsignal(signal.SIGTERM)
        router.install_sigterm(drain_timeout_s=300)
        shed, late_reply = [], {}

        def late():
            while not router.draining:
                time.sleep(0.001)
            for p in prompts[:3]:
                try:
                    router.submit(p, max_new_tokens=new_tokens)
                    shed.append(None)
                except ht.Rejected as e:
                    shed.append(e.retry_after_ms)
            _post_generate(base, prompts[3], new_tokens, late_reply)

        reply = {}
        poster = threading.Thread(target=_post_generate, args=(
            base, prompts[0], new_tokens, reply))
        poster.start()
        hs = [router.submit(p, max_new_tokens=new_tokens) for p in prompts[1:]]
        all_handles.extend(hs)
        steps0 = sum(r.executor.steps for r in reps)
        while sum(r.executor.steps for r in reps) < steps0 + 8:
            time.sleep(0.001)
        late_thread = threading.Thread(target=late)
        late_thread.start()
        t_drain = time.perf_counter()
        signal.raise_signal(signal.SIGTERM)     # the handler drains, here
        drain_s = time.perf_counter() - t_drain
        signal.signal(signal.SIGTERM, old)
        late_thread.join(60)
        poster.join(600)
        launches = paged.paged_attention_fused.launches
        after = [_k1_state(r) for r in reps]
        srv.shutdown()
        srv.server_close()
        stats = router.stats()
        out["drain"] = {
            "drain_s": drain_s, "statuses": [h.status for h in hs]
            + [reply.get("status")], "shed_retry_after_ms": shed,
            "http_during_drain": {"code": late_reply.get("code"),
                                  "retry_after": late_reply.get(
                                      "headers", {}).get("Retry-After")}}
        checks["drain_tail_answered"] = (
            all(h.done() for h in hs) and reply.get("code") in (200, 429)
            and all(h.status in ("ok", "rejected") for h in hs)
            and sum(h.status == "ok" for h in hs) > 0)
        checks["drain_sheds_with_retry"] = (
            len(shed) == 3 and all(x is not None and x > 0 for x in shed)
            and late_reply.get("code") == 429
            and int(late_reply.get("headers", {}).get("Retry-After", 0)) >= 1)
        checks["answered_once"] = all(h.done() and h.resolutions == 1
                                      for h in all_handles)
        checks["stopped"] = not any(r.batcher.alive() for r in reps)
        # ---- K1 by replica: one launch a layer a replay ----
        per = []
        for b4, a4 in zip(before, after):
            per.append({"before": b4, "after": a4,
                        "k1_launches": a4["k1_launches"] - b4["k1_launches"],
                        "replays": a4["replays"] - b4["replays"]})
        layers = cfg.num_layers
        checks["k1_per_replay"] = all(
            p["replays"] > 0 and p["k1_launches"] == layers * p["replays"]
            for p in per)
        checks["k1_counted_by_replicas"] = launches == sum(
            p["k1_launches"] for p in per) > 0
        checks["graphs_flat"] = all(a4["graphs"] == b4["graphs"]
                                    for b4, a4 in zip(before, after))
        out.update({
            "launches": launches, "replicas": per,
            "router_ms": {"dispatch_p50": _pct(dispatch_ms, 50),
                          "dispatch_p99": _pct(dispatch_ms, 99),
                          "e2e_p50": _pct([h.latency_ms for h in all_handles],
                                          50),
                          "e2e_p99": _pct([h.latency_ms for h in all_handles],
                                          99)},
            "stats": stats, "peak_mem_gb": torch.cuda.max_memory_allocated()
            / 1e9, "phase_s": time.perf_counter() - t_phase, "checks": checks})
    except BaseException:
        # a failed phase leaves nothing running
        router.close()
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        raise
    finally:
        watch.stop()
        for sub in subs:
            sub.close()
        pub.close()
        store.close()
    out["adoption"] = [dict(sub.last) for sub in subs]
    out["heartbeat_gaps_s"] = watch.gaps()
    log("fleet " + json.dumps(out, default=str))
    del router, reps, execs, pub, pub_sd, ex1, subs
    del orig_install, checked_install, export, timed_pull, orig_export
    free_cuda()
    if not all(checks.values()):
        raise SystemExit("phase 16: the fleet failed: " + json.dumps(
            {k: v for k, v in checks.items() if not v}))
    return out


# ---------------------------------------------------------------------------
# phase 17: the process fleet — replica worker processes on one card
# ---------------------------------------------------------------------------

#: the process fleet's crash lands this many iterations into burst 2
PROC_CRASH_IN = 3


def _smi_apps():
    """``{pid: used MiB}`` of the processes holding the card, from
    ``nvidia-smi --query-compute-apps``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout
    apps = {}
    for line in out.strip().splitlines():
        parts = [x.strip() for x in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit():
            apps[int(parts[0])] = float(parts[1]) if parts[1].replace(
                ".", "", 1).isdigit() else parts[1]
    return apps


class _Kept:
    """A histogram child whose every observation is also kept."""

    def __init__(self, hist):
        self.hist, self.values = hist, []

    def observe(self, v):
        self.values.append(v)
        self.hist.observe(v)


def _ttft_counts(snaps):
    """(bounds, counts) of ``hvd_serve_ttft_ms`` summed over the workers'
    metrics snapshots (each worker's histogram: submit -> its first
    token, queue wait and prefill step)."""
    bounds, counts = None, None
    for snap in snaps:
        for h in snap.get("histograms", ()):
            if h["name"] == "hvd_serve_ttft_ms":
                bounds = h["bounds"]
                counts = (list(h["counts"]) if counts is None else
                          [a + b for a, b in zip(counts, h["counts"])])
    return bounds, counts


def _ttft_pcts(before, after):
    """p50 and p99 (bucket interpolation) of the TTFTs observed between
    two ``_ttft_counts`` readings of the same workers."""
    from horovod_tpu_torch.obs.metrics import percentile_from_buckets
    bounds, c1 = after
    if bounds is None:
        return None, None
    c0 = before[1] or [0] * len(c1)
    d = [a - b for a, b in zip(c1, c0)]
    return (percentile_from_buckets(bounds, d, 0.5),
            percentile_from_buckets(bounds, d, 0.99))


def proc_worker_cfg(seed, root):
    """Phase 17's worker config: phase 15's stack (max_batch 8, block 16,
    max_len 2048, buckets (128, 512), the prefix cache, ``kv_crc``, the KV
    tier with a host ring of KVTIER_HOST_MB and a spill directory a
    replica under ``root``) over ``llama_builder``: full-width Llama_1B in
    bf16 from phase 3's seed, on the card."""
    return {"builder": "horovod_tpu_torch.serve.worker:llama_builder",
            "builder_kwargs": {"preset": "Llama_1B", "seed": seed,
                               "dtype": "bfloat16", "max_batch": 8,
                               "max_len": 2048, "kv_block_size": BS,
                               "buckets": [128, 512]},
            "max_queue": 64, "kv_crc": True, "prefix_cache": True,
            "kv_tier": True, "kvtier_host_mb": KVTIER_HOST_MB,
            "kvtier_dir": root}


def _near_tie(top, stream, want):
    """Phase 17's stream rule for one request: ``stream`` equals ``want``
    (one replica alone), or leaves it at a step k where the one-replica
    run's top two logits are within FLEET_LOGIT_BAR of its largest
    |logit| and ``stream[k]`` is the second of them. ``top[k]`` is that
    run's ``(top-2 values, top-2 ids, max |logit|)`` at step k (the same
    prefix, teacher-forced through the one-replica model, gives the same
    row). Returns None when equal, else the divergence with ``ok``."""
    if stream == want:
        return None
    k = next((i for i, (x, y) in enumerate(zip(stream, want)) if x != y),
             min(len(stream), len(want)))
    d = {"step": k, "ok": False}
    if k in top and k < len(stream):
        vals, ids, amax = top[k]
        d.update(gap=vals[0] - vals[1], bar=FLEET_LOGIT_BAR * max(1.0, amax),
                 second=ids[1], got=stream[k])
        d["ok"] = d["gap"] <= d["bar"] and stream[k] == ids[1]
    return d


def proc_fleet_phase(ht, dev, seed, new_tokens, smi, serve_tps=None,
                     fleet_tps=None):
    """Phase 17: the process fleet on the card. One port ``StoreServer``
    on 127.0.0.1, ``ProcessFleetRouter`` over two worker processes (the
    router's defaults: heartbeat 0.25 s, suspect 1.0 s), each serving
    ``proc_worker_cfg`` through K1 in its own CUDA context, and
    ``make_fleet_server`` in front. The reference: phase 3's 9 requests,
    greedy, on one replica's stack in this process (the same builder and
    config), freed before anything spawns. Four bursts, one request of
    each through ``POST /generate``:

    1. fan-out: the 9 twice over (18), against the reference's streams;
    2. crash: a ``serve.proc`` crash armed in replica 0 (its endpoint's
       ``chaos`` op) PROC_CRASH_IN iterations into the burst, a real
       SIGKILL: ejected within 2 x suspect, its requests re-queued once
       onto replica 1, a fresh process (generation 1) warms up, captures
       its graphs and is re-admitted;
    3. a ``serve.dispatch`` window (a ``conn_reset``, then ``flaky``
       drops) on replica 1's socket: the ladder absorbs it with no
       failover, the replays served from the worker's dedupe cache;
    4. drain: SIGTERM mid-burst; submits then are shed with
       ``retry_after_ms`` (429 and ``Retry-After`` over HTTP), the tail
       finishes, every worker exits 0.

    Every handle is answered once; each worker counts one K1 launch a
    layer a replay and none outside replays, and adds no graph after its
    warm-up; no worker outlives the phase. On a failure every worker's
    process group is killed and the tail of each log printed."""
    import signal
    import tempfile
    from horovod_tpu_torch.native.store import StoreServer
    from horovod_tpu_torch.serve import wire
    from horovod_tpu_torch.serve import worker as wk
    from horovod_tpu_torch.serve.proc_fleet import ProcessFleetRouter
    free_cuda()
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="proc_fleet_")
    cfg = proc_worker_cfg(seed, os.path.join(root, "spill"))
    prompts = make_requests(seed)
    # burst 3's prompts: fresh, so no replica holds their runs and the
    # index steers none of them (generation 1 takes a share too)
    fresh = make_requests(seed + 1)
    out = {"card": smi, "interval_s": FLEET_INTERVAL_S,
           "suspect_s": FLEET_SUSPECT_S, "host_mb": KVTIER_HOST_MB}
    checks = {}

    # ---- the reference: one replica's stack in this process ----
    t0 = time.perf_counter()
    ref_cfg = dict(cfg, kvtier_dir=os.path.join(root, "alone"))
    st = wk.build_replica_stack(ref_cfg, 0, dev)
    if st.executor.kernel != "cuda":
        raise SystemExit("phase 17: the reference did not resolve K1")
    layers = st.executor.model.cfg.num_layers
    st.batcher.warmup()
    ref = _LogitTrace()
    ref.wrap(st.executor, lambda: st.batcher)
    hs = _burst(st.batcher, prompts + fresh, new_tokens)
    _unwrap(st.executor)
    if not all(h.status == "ok" for h in hs):
        raise SystemExit("phase 17: the one-replica reference failed")
    want = {tuple(p): h.tokens for p, h in zip(prompts + fresh, hs)}
    # each step's top two logits and largest |logit|, kept on the host
    tops = {}
    for (p, k), rows in ref.rows.items():
        v, i = torch.topk(rows[0].float(), 2)
        tops.setdefault(p, {})[k] = (v.tolist(), i.tolist(),
                                     float(rows[0].float().abs().max()))
    out["reference_s"] = time.perf_counter() - t0
    del st, ref, hs
    free_cuda()

    srv = StoreServer()
    router = ProcessFleetRouter(
        2, kv_addr="127.0.0.1", kv_port=srv.port, worker=cfg,
        interval_s=FLEET_INTERVAL_S, suspect_s=FLEET_SUSPECT_S,
        log_dir=os.path.join(root, "logs"),
        events_dir=os.path.join(root, "events"))
    events = []
    router.add_listener(events.append)
    procs = []          # every worker process, every generation
    http = None
    # the router's dispatch-leg histogram, each value also kept
    dispatch = router._m_router["dispatch"] = _Kept(
        router._m_router["dispatch"])
    dispatch_ms = dispatch.values

    def healthz(rid):
        h = router._fetch_healthz(router.replicas[rid], timeout=10.0)
        if h is None:
            raise SystemExit(f"phase 17: replica {rid} gave no healthz")
        return h

    def k1_of(h):
        return {k: h[k] for k in ("k1_launches", "k1_launches_process",
                                  "replays", "steps", "graphs", "kernel")}

    try:
        t0 = time.time()
        router.start()
        out["start_s"] = time.time() - t0
        procs += [r.proc for r in router.replicas.values()]
        cold = {}
        for rid, rep in router.replicas.items():
            s = dict(rep.startup or {})
            cold[str(rid)] = {
                "pid": rep.pid,
                "import_s": s.get("t_main", 0) - rep.spawned_at,
                "cuda_context_s": s.get("cuda_s"),
                "weights_s": s.get("weights_s"),
                "kernel_load_s": s.get("kernel_s"),
                "capture_s": s.get("capture_s"),
                "spawn_to_ready_s": s.get("t_ready", 0) - rep.spawned_at}
        out["cold_start"] = cold
        # the main path: each worker's counts from here (set to 0 in
        # effect: deltas), read right after its last burst
        first = {rid: k1_of(healthz(rid)) for rid in router.replicas}
        out["gpu_mem"] = {
            "nvidia_smi_mib": {str(pid): mib for pid, mib in
                               _smi_apps().items()},
            "workers": {str(rid): healthz(rid).get("cuda_mem")
                        for rid in router.replicas},
            "this_process_reserved_gb": torch.cuda.memory_reserved() / 1e9}
        http = ht.make_fleet_server(router)
        threading.Thread(target=http.serve_forever, daemon=True).start()
        base = "http://%s:%d" % http.server_address
        all_handles = []

        def burst(ps, http_index=0):
            reply = {}
            poster = threading.Thread(target=_post_generate, args=(
                base, ps[http_index], new_tokens, reply))
            t_start = time.perf_counter()
            poster.start()
            hs = [router.submit(p, max_new_tokens=new_tokens)
                  for i, p in enumerate(ps) if i != http_index]
            for h in hs:
                h.wait(600)
            poster.join(600)
            all_handles.extend(hs)
            st = [h.tokens for h in hs]
            st.insert(http_index, reply.get("tokens", []))
            return hs, reply, st, time.perf_counter() - t_start

        def rule(st, ps):
            bad = [d for d in (_near_tie(tops[tuple(p)], s, want[tuple(p)])
                               for s, p in zip(st, ps)) if d is not None]
            return ({"requests": len(st), "identical": len(st) - len(bad),
                     "diverged": bad}, [d for d in bad if not d["ok"]])

        # ---- burst 1: fan-out ----
        fan = prompts + prompts
        ttft0 = _ttft_counts(router.metrics_snapshots(timeout=10.0))
        hs, reply, st, wall = burst(fan)
        ttft = _ttft_pcts(ttft0, _ttft_counts(
            router.metrics_snapshots(timeout=10.0)))
        rule1, bad1 = rule(st, fan)
        gen = sum(len(x) for x in st)
        out["fanout"] = {
            "requests": len(fan), "generated_tokens": gen, "wall_s": wall,
            "tokens_per_s": gen / wall, "phase3_tokens_per_s": serve_tps,
            "phase16_tokens_per_s": fleet_tps,
            "ttft_worker_ms_p50": ttft[0], "ttft_worker_ms_p99": ttft[1],
            "by_replica": {str(i): sum(1 for h in hs if h.replica == i)
                           + int(reply.get("replica") == i) for i in (0, 1)},
            "e2e_ms_p50": _pct([h.latency_ms for h in hs], 50),
            "e2e_ms_p99": _pct([h.latency_ms for h in hs], 99),
            "streams": rule1}
        checks["fanout_ok"] = (all(h.status == "ok" for h in hs)
                               and reply.get("code") == 200
                               and all(len(x) == new_tokens for x in st))
        checks["fanout_streams"] = not bad1
        checks["fanout_spread"] = all(v > 0 for v in
                                      out["fanout"]["by_replica"].values())
        last = {rid: k1_of(healthz(rid)) for rid in router.replicas}

        # ---- burst 2: replica 0's process is SIGKILLed mid-burst ----
        stats0 = router.stats()
        rep0 = router.replicas[0]
        i0 = healthz(0)["iterations"]
        at = i0 + 40                     # ~2 s of idle iterations ahead
        s = wire.connect(rep0.addr, timeout=5.0)
        try:
            wire.send_msg(s, {"op": "chaos", "plan": {
                "seed": seed, "faults": [
                    {"rank": 0, "site": "serve.proc", "kind": "crash",
                     "peer": 0, "at": at, "epoch": 0}]}})
            armed = wire.recv_msg(s, timeout=10.0)
        finally:
            s.close()
        if armed.get("ack") != "armed" or armed["iterations"] >= at - 5:
            raise SystemExit(f"phase 17: arming the crash failed: {armed}")
        while True:
            it = healthz(0)["iterations"]
            if it >= at - PROC_CRASH_IN:
                break
            time.sleep(0.005)
        hs, reply, st, wall = burst(prompts, http_index=1)
        deadline = time.monotonic() + 300
        while not any(e["event"] == "readmit" for e in events):
            if time.monotonic() > deadline:
                raise SystemExit("phase 17: replica 0 was not re-admitted: "
                                 + json.dumps(events, default=str))
            time.sleep(0.02)
        procs.append(rep0.proc)
        rule2, bad2 = rule(st, prompts)
        stats2 = router.stats()
        with open(os.path.join(root, "events",
                               "replica.0.events.jsonl")) as f:
            fired = [json.loads(x) for x in f if x.strip()]
        crash_t = next(e["t"] for e in fired if e["kind"] == "crash")
        eject = next(e for e in events if e["event"] == "eject")
        respawn = next(e for e in events if e["event"] == "respawn")
        readmit = next(e for e in events if e["event"] == "readmit")
        # the dead replica's requests move once, either re-queued by the
        # ejection or re-dispatched by their dispatcher when the ladder
        # gives up on the dead socket first
        requeued = stats2["requeued"] - stats0["requeued"]
        moved = [h for h in hs if h.attempts > 1]
        s1 = dict(rep0.startup or {})
        out["crash"] = {
            "armed_at_iteration": at, "burst_began_at_iteration": it,
            "gen0_rc": procs[0].poll(),
            "eject_after_kill_s": eject["t"] - crash_t,
            "failover_ms": router.last_failover_ms,
            "requeued": requeued, "moved": len(moved),
            "attempts": [h.attempts for h in hs],
            "duplicates_suppressed": stats2["duplicates_suppressed"],
            "rejected": stats2["rejected"] - stats0["rejected"],
            "respawn": {
                "pid": rep0.pid, "gen": rep0.gen,
                "spawn_to_readmit_s": readmit["t"] - rep0.spawned_at,
                "eject_to_readmit_s": readmit["t"] - eject["t"],
                "respawn_event_to_spawn_s": rep0.spawned_at - respawn["t"],
                "import_s": s1.get("t_main", 0) - rep0.spawned_at,
                "cuda_context_s": s1.get("cuda_s"),
                "weights_s": s1.get("weights_s"),
                "kernel_load_s": s1.get("kernel_s"),
                "capture_s": s1.get("capture_s")},
            "streams": rule2}
        checks["crash_answered"] = (all(h.status == "ok" for h in hs)
                                    and reply.get("code") == 200)
        checks["crash_streams"] = not bad2
        checks["crash_sigkilled"] = procs[0].poll() == -signal.SIGKILL
        checks["crash_ejected_in_time"] = (
            eject["replica"] == 0
            and 0 <= out["crash"]["eject_after_kill_s"]
            <= 2 * FLEET_SUSPECT_S)
        checks["crash_moved_once"] = (
            len(moved) > 0 and requeued <= len(moved) + 1
            and all(h.attempts == 2 and h.replica == 1 for h in moved)
            and all(h.attempts <= 2 for h in hs))
        checks["crash_respawned_gen1"] = (
            readmit["replica"] == 0 and rep0.gen == 1
            and rep0.restarts == 1 and rep0.state == "up")
        # the fresh process's counts start at its re-admission
        first["0g1"] = k1_of(healthz(0))

        # ---- burst 3: a dispatch fault window on replica 1's socket ----
        # (fresh prompts: both workers, generation 1 too, take a share)
        from horovod_tpu_torch.chaos import inject as chaos
        from horovod_tpu_torch.chaos.plan import ChaosPlan
        from horovod_tpu_torch.native import resilience
        absorbed = lambda: resilience._registry().counter(  # noqa: E731
            "hvd_net_retries_total", resilience.RETRIES_HELP,
            {"site": "serve.dispatch", "outcome": "absorbed"}).value
        a0, d0 = absorbed(), healthz(1)["dedupe_hits"]
        n1 = router._dispatches[1]
        plan = {"seed": seed, "faults": [
            {"rank": 0, "site": "serve.dispatch", "kind": "conn_reset",
             "peer": 1, "at": n1},
            {"rank": 0, "site": "serve.dispatch", "kind": "flaky",
             "peer": 1, "prob": 1.0, "after": n1 + 1, "until": n1 + 2}]}
        stats0 = router.stats()
        chaos.install(ChaosPlan.from_dict(plan), rank=0)
        try:
            hs, reply, st, wall = burst(fresh, http_index=2)
        finally:
            chaos.uninstall()
        rule3, bad3 = rule(st, fresh)
        stats3 = router.stats()
        out["dispatch_window"] = {
            "plan": plan, "absorbed": absorbed() - a0,
            "dedupe_hits": healthz(1)["dedupe_hits"] - d0,
            "failovers": stats3["failovers"] - stats0["failovers"],
            "by_replica": [h.replica for h in hs] + [reply.get("replica")],
            "streams": rule3}
        checks["window_answered"] = (all(h.status == "ok" for h in hs)
                                     and reply.get("code") == 200)
        checks["window_absorbed"] = (out["dispatch_window"]["absorbed"] >= 3
                                     and out["dispatch_window"]["failovers"]
                                     == 0)
        checks["window_deduped"] = out["dispatch_window"]["dedupe_hits"] > 0
        checks["window_streams"] = not bad3
        checks["window_spread"] = set(
            out["dispatch_window"]["by_replica"]) == {0, 1}
        # every worker idle: the counts the K1 checks read (a snapshot
        # taken mid-step may catch a replay whose step is not counted)
        end = {rid: k1_of(healthz(rid)) for rid in router.replicas}

        # ---- burst 4: SIGTERM drain mid-burst ----
        # prompts no replica holds, so both workers take a share
        drain_ps = make_requests(seed + 2)
        shed, late_reply = [], {}

        def late():
            while not router.draining:
                time.sleep(0.001)
            for p in drain_ps[:3]:
                try:
                    router.submit(p, max_new_tokens=new_tokens)
                    shed.append(None)
                except ht.Rejected as e:
                    shed.append(e.retry_after_ms)
            _post_generate(base, drain_ps[3], new_tokens, late_reply)

        old = signal.getsignal(signal.SIGTERM)
        signal.signal(signal.SIGTERM,
                      lambda *_: router.drain(timeout_s=300))
        reply = {}
        steps0 = [healthz(r)["steps"] for r in (0, 1)]
        poster = threading.Thread(target=_post_generate, args=(
            base, drain_ps[0], new_tokens, reply))
        poster.start()
        hs = [router.submit(p, max_new_tokens=new_tokens)
              for p in drain_ps[1:]]
        all_handles.extend(hs)
        # both workers mid-burst (a few steps each), then SIGTERM
        deadline = time.monotonic() + 120
        while any(healthz(r)["steps"] < s0 + 4
                  for r, s0 in zip((0, 1), steps0)):
            if time.monotonic() > deadline:
                raise SystemExit("phase 17: burst 4 never reached both "
                                 "workers")
            time.sleep(0.01)
        late_thread = threading.Thread(target=late)
        late_thread.start()
        t_drain = time.perf_counter()
        signal.raise_signal(signal.SIGTERM)   # the handler drains, here
        drain_s = time.perf_counter() - t_drain
        signal.signal(signal.SIGTERM, old)
        late_thread.join(60)
        poster.join(600)
        rcs = [p.poll() for p in procs]
        stats = router.stats()
        out["drain"] = {
            "drain_s": drain_s, "statuses": [h.status for h in hs]
            + [reply.get("status")], "shed_retry_after_ms": shed,
            "http_during_drain": {"code": late_reply.get("code"),
                                  "retry_after": late_reply.get(
                                      "headers", {}).get("Retry-After")},
            "exit_codes": rcs}
        checks["drain_tail_answered"] = (
            all(h.done() for h in hs) and reply.get("code") in (200, 429)
            and all(h.status in ("ok", "rejected") for h in hs)
            and sum(h.status == "ok" for h in hs) > 0)
        checks["drain_sheds_with_retry"] = (
            len(shed) == 3 and all(x is not None and x > 0 for x in shed)
            and late_reply.get("code") == 429
            and int(late_reply.get("headers", {}).get("Retry-After", 0)) >= 1)
        checks["workers_exit_0"] = rcs[1:] == [0, 0]
        checks["answered_once"] = all(h.done() and h.resolutions == 1
                                      for h in all_handles)
        # ---- K1 by worker: one launch a layer a replay, none outside ----
        per = {}
        for key, a, b in (("0g0", first[0], last[0]),
                          ("0g1", first["0g1"], end[0]),
                          ("1g0", first[1], end[1])):
            d = {k: b[k] - a[k] for k in ("k1_launches",
                                          "k1_launches_process",
                                          "replays", "steps")}
            d.update(graphs_before=a["graphs"], graphs_after=b["graphs"],
                     kernel=b["kernel"])
            per[key] = d
        checks["k1_per_replay"] = all(
            d["replays"] > 0 and d["k1_launches"] == layers * d["replays"]
            for d in per.values())
        checks["k1_only_in_replays"] = all(
            d["k1_launches_process"] == d["k1_launches"]
            and d["steps"] == d["replays"] for d in per.values())
        checks["graphs_flat"] = all(d["graphs_before"] == d["graphs_after"]
                                    > 0 for d in per.values())
        e2e = [h.latency_ms for h in all_handles]
        out.update({
            "launches": sum(d["k1_launches"] for d in per.values()),
            "workers": per,
            "router_ms": {"dispatch_p50": _pct(dispatch_ms, 50),
                          "dispatch_p99": _pct(dispatch_ms, 99),
                          "e2e_p50": _pct(e2e, 50), "e2e_p99": _pct(e2e, 99)},
            "stats": stats})
    except BaseException:
        # a failed phase leaves nothing running, and says why
        for p in procs + [r.proc for r in router.replicas.values()]:
            if p is not None:
                p.kill()
        for name in sorted(os.listdir(os.path.join(root, "logs"))
                           if os.path.isdir(os.path.join(root, "logs"))
                           else []):
            with open(os.path.join(root, "logs", name)) as f:
                tail = f.read()[-4000:]
            log_err(f"--- {name} (tail)\n{tail}")
        raise
    finally:
        router.close()
        if http is not None:
            http.shutdown()
            http.server_close()
        for p in procs:
            p.kill()
        srv.close()
    pids = {p.proc.pid for p in procs}
    apps = _smi_apps()
    left = {pid for pid in apps if pid in pids}
    out["nvidia_smi_after_mib"] = {str(k): v for k, v in apps.items()}
    checks["no_worker_holds_the_card"] = (not left and all(
        p.poll() is not None for p in procs))
    out.update(worker_pids_on_card_after=sorted(left),
               phase_s=time.perf_counter() - t_phase, checks=checks)
    log("proc_fleet " + json.dumps(out, default=str))
    if not all(checks.values()):
        raise SystemExit("phase 17: the process fleet failed: " + json.dumps(
            {k: v for k, v in checks.items() if not v}))
    return out


# ---------------------------------------------------------------------------
# phase 18: disaggregated serving — a prefill pool and a decode pool
# ---------------------------------------------------------------------------

#: phase 18's pools: prefill workers, decode workers
DISAGG_POOLS = (2, 1)
#: phase 18's prefill crash lands this many iterations into burst 3
DISAGG_CRASH_IN = 3
#: phase 18's wire frame ceiling (HOROVOD_SERVE_WIRE_MAX_FRAME)
DISAGG_MAX_FRAME = 64 << 20


def disagg_phase(ht, dev, seed, new_tokens, smi, serve_tps=None,
                 proc_fleet=None):
    """Phase 18: disaggregated serving on the card. One port
    ``StoreServer``, ``DisaggRouter`` over DISAGG_POOLS worker processes
    (prefill replicas 0 and 1, decode replica 2; heartbeat 0.25 s,
    suspect 1.0 s), each serving ``proc_worker_cfg`` through K1 in its
    own CUDA context, and ``make_fleet_server`` in front. Every request
    is prefilled on a prefill worker (``hold_kv``, one token), its KV
    blocks pushed to the decode worker and installed there, and decoded
    there. The reference: phase 3's 9 requests and 9 fresh ones, greedy,
    on one replica's stack in this process, freed before anything
    spawns. Four bursts, one request of each through ``POST /generate``:

    1. fan-out: the 9 twice over (18), each migrated once;
    2. a ``serve.migrate`` window armed in prefill replica 0 (its
       endpoint's ``chaos`` op): a ``corrupt`` push, caught by the decode
       side's block crc before any token and migrated again from the
       parked row (the reference's policy: an in-flight corrupt re-packs,
       a corrupt source re-prefills), and a ``conn_reset`` after the
       frame landed, whose ladder replay is served the deduped install
       ack; 9 fresh prompts;
    3. a ``serve.proc`` crash armed in prefill replica 0, a real SIGKILL
       DISAGG_CRASH_IN iterations into the burst: its requests go to
       replica 1 once (attempts 2), generation 1 is respawned and
       re-admitted, then serves a share of the 9 fresh prompts again;
    4. drain: SIGTERM mid-burst; new submits shed with
       ``retry_after_ms`` (429 over HTTP), the tail finishes, every
       worker exits 0.

    Checks: every handle answered once; the streams of bursts 1-3 equal
    the one-replica streams (phase 17's near-tie rule); burst 1 counts
    one migration a request and the bytes its prompts' positions imply;
    the decode worker replays no prefill graph; each worker counts one
    K1 launch a layer a replay and none outside replays, and adds no
    graph after its warm-up; no worker outlives the phase. On a failure
    every worker's process group is killed and each log's tail printed."""
    import signal
    import tempfile
    from horovod_tpu_torch.chaos import inject as chaos
    from horovod_tpu_torch.native.store import StoreServer
    from horovod_tpu_torch.obs import metrics as obs_metrics
    from horovod_tpu_torch.serve import wire
    from horovod_tpu_torch.serve import worker as wk
    from horovod_tpu_torch.serve.disagg import DisaggRouter, MIGRATIONS_HELP
    free_cuda()
    chaos.uninstall()
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="disagg_")
    cfg = proc_worker_cfg(seed, os.path.join(root, "spill"))
    prompts = make_requests(seed)
    fresh = make_requests(seed + 1)
    n_pre, n_dec = DISAGG_POOLS
    out = {"card": smi, "pools": {"prefill": n_pre, "decode": n_dec},
           "interval_s": FLEET_INTERVAL_S, "suspect_s": FLEET_SUSPECT_S}
    checks = {}

    # ---- the reference: one replica's stack in this process ----
    t0 = time.perf_counter()
    st = wk.build_replica_stack(dict(cfg, kvtier_dir=os.path.join(
        root, "alone")), 0, dev)
    if st.executor.kernel != "cuda":
        raise SystemExit("phase 18: the reference did not resolve K1")
    mcfg = st.executor.model.cfg
    layers = mcfg.num_layers
    # KV bytes one position migrates: every layer's k and v rows
    per_pos = (layers * 2 * mcfg.num_kv_heads * mcfg.head_dim
               * torch.tensor([], dtype=mcfg.dtype).element_size())
    block = BS * per_pos
    st.batcher.warmup()
    ref = _LogitTrace()
    ref.wrap(st.executor, lambda: st.batcher)
    hs = _burst(st.batcher, prompts + fresh, new_tokens)
    _unwrap(st.executor)
    if not all(h.status == "ok" for h in hs):
        raise SystemExit("phase 18: the one-replica reference failed")
    want = {tuple(p): h.tokens for p, h in zip(prompts + fresh, hs)}
    tops = {}
    for (p, k), rows in ref.rows.items():
        v, i = torch.topk(rows[0].float(), 2)
        tops.setdefault(p, {})[k] = (v.tolist(), i.tolist(),
                                     float(rows[0].float().abs().max()))
    out["reference_s"] = time.perf_counter() - t0
    del st, ref, hs
    free_cuda()

    # a migration frame carries a whole row's KV (22,528 B a position at
    # full width, 46 MB at max_len): the wire's 4 MiB default ceiling
    # refuses it loudly, so the workers (they inherit this environment)
    # get one above the largest row
    frame_env = os.environ.get("HOROVOD_SERVE_WIRE_MAX_FRAME")
    os.environ["HOROVOD_SERVE_WIRE_MAX_FRAME"] = str(DISAGG_MAX_FRAME)
    out["wire_max_frame"] = DISAGG_MAX_FRAME
    srv = StoreServer()
    router = DisaggRouter(
        n_pre, n_dec, kv_addr="127.0.0.1", kv_port=srv.port,
        prefill_worker=cfg, decode_worker=cfg,
        interval_s=FLEET_INTERVAL_S, suspect_s=FLEET_SUSPECT_S,
        log_dir=os.path.join(root, "logs"),
        events_dir=os.path.join(root, "events"))
    events = []
    router.add_listener(events.append)
    procs = []          # every worker process, every generation
    http = None
    legs = {k: _Kept(h) for k, h in router._m_leg.items()}
    router._m_leg = legs
    mig_ms = router._m_migrate_ms = _Kept(router._m_migrate_ms)
    R = obs_metrics.get_registry()

    def migrations(outcome):
        return R.counter("hvd_serve_migrations_total", MIGRATIONS_HELP,
                         {"outcome": outcome}).value

    def pool_of(rid):
        return router.prefill if rid in router.prefill.replicas \
            else router.decode

    def rep_of(rid):
        return pool_of(rid).replicas[rid]

    rids = list(router.prefill.replicas) + list(router.decode.replicas)
    dec_rid = rids[-1]

    def healthz(rid):
        h = pool_of(rid)._fetch_healthz(rep_of(rid), timeout=10.0)
        if h is None:
            raise SystemExit(f"phase 18: worker {rid} gave no healthz")
        return h

    def k1_of(h):
        return {k: h[k] for k in ("k1_launches", "k1_launches_process",
                                  "replays", "steps", "graphs", "kernel")}

    try:
        t0 = time.time()
        router.start()
        out["start_s"] = time.time() - t0
        procs += [rep_of(r).proc for r in rids]
        cold = {}
        for rid in rids:
            rep = rep_of(rid)
            s = dict(rep.startup or {})
            cold[str(rid)] = {
                "pool": pool_of(rid).pool, "pid": rep.pid,
                "import_s": s.get("t_main", 0) - rep.spawned_at,
                "cuda_context_s": s.get("cuda_s"),
                "weights_s": s.get("weights_s"),
                "kernel_load_s": s.get("kernel_s"),
                "capture_s": s.get("capture_s"),
                "spawn_to_ready_s": s.get("t_ready", 0) - rep.spawned_at}
        out["cold_start"] = cold
        # the main path: each worker's counts from here (deltas), read
        # idle right after its last burst
        first = {r: k1_of(healthz(r)) for r in rids}
        out["gpu_mem"] = {
            "nvidia_smi_mib": {str(pid): mib for pid, mib in
                               _smi_apps().items()},
            "workers": {str(r): healthz(r).get("cuda_mem") for r in rids},
            "this_process_reserved_gb": torch.cuda.memory_reserved() / 1e9}
        http = ht.make_fleet_server(router)
        threading.Thread(target=http.serve_forever, daemon=True).start()
        base = "http://%s:%d" % http.server_address
        all_handles = []

        def burst(ps, http_index=0):
            reply = {}
            poster = threading.Thread(target=_post_generate, args=(
                base, ps[http_index], new_tokens, reply))
            t_start = time.perf_counter()
            poster.start()
            hs = [router.submit(p, max_new_tokens=new_tokens)
                  for i, p in enumerate(ps) if i != http_index]
            for h in hs:
                h.wait(600)
            poster.join(600)
            all_handles.extend(hs)
            st = [h.tokens for h in hs]
            st.insert(http_index, reply.get("tokens", []))
            return hs, reply, st, time.perf_counter() - t_start

        def rule(st, ps):
            bad = [d for d in (_near_tie(tops[tuple(p)], s, want[tuple(p)])
                               for s, p in zip(st, ps)) if d is not None]
            return ({"requests": len(st), "identical": len(st) - len(bad),
                     "diverged": bad}, [d for d in bad if not d["ok"]])

        def outcomes():
            return {o: migrations(o) for o in (
                "ok", "migrate_corrupt", "unreachable", "rejected",
                "version_mismatch", "not_parked", "source_corrupt",
                "stalled")}

        # ---- burst 1: fan-out ----
        fan = prompts + prompts
        stats0, out0 = router.stats(), outcomes()
        kinds0 = healthz(dec_rid)["steps_by_kind"]
        ttft0 = _ttft_counts(router.prefill.metrics_snapshots(timeout=10.0))
        n_leg = {k: len(v.values) for k, v in legs.items()}
        n_mig = len(mig_ms.values)
        hs, reply, st, wall = burst(fan)
        ttft = _ttft_pcts(ttft0, _ttft_counts(
            router.prefill.metrics_snapshots(timeout=10.0)))
        rule1, bad1 = rule(st, fan)
        stats1, out1 = router.stats(), outcomes()
        kinds1 = healthz(dec_rid)["steps_by_kind"]
        gen = sum(len(x) for x in st)
        moved_bytes = stats1["migrate_bytes"] - stats0["migrate_bytes"]
        want_bytes = per_pos * sum(len(p) for p in fan)
        pre_leg = legs["prefill"].values[n_leg["prefill"]:]
        dec_leg = legs["decode"].values[n_leg["decode"]:]
        ms = mig_ms.values[n_mig:]
        pf = proc_fleet or {}
        hz = {}
        _get_json(base + "/healthz", hz)
        met = {}
        _get_text(base + "/metrics?fleet=1", met)
        out["fanout"] = {
            "requests": len(fan), "generated_tokens": gen, "wall_s": wall,
            "tokens_per_s": gen / wall, "phase3_tokens_per_s": serve_tps,
            "phase17_tokens_per_s": (pf.get("fanout") or {}).get(
                "tokens_per_s"),
            "ttft_router_ms_p50": _pct(pre_leg, 50),
            "ttft_router_ms_p99": _pct(pre_leg, 99),
            "ttft_worker_ms_p50": ttft[0], "ttft_worker_ms_p99": ttft[1],
            "phase17_ttft_worker_ms_p50": (pf.get("fanout") or {}).get(
                "ttft_worker_ms_p50"),
            "phase17_ttft_worker_ms_p99": (pf.get("fanout") or {}).get(
                "ttft_worker_ms_p99"),
            "migrate_ms_p50": _pct(ms, 50), "migrate_ms_p99": _pct(ms, 99),
            "migrations": {o: out1[o] - out0[o] for o in out1},
            "migrate_bytes": moved_bytes,
            "migrate_bytes_from_positions": want_bytes,
            "migrate_bytes_from_whole_blocks": block * sum(
                -(-len(p) // BS) for p in fan),
            "migrate_mb_per_s": (moved_bytes / 1e6) / (sum(ms) / 1e3)
            if ms else None,
            "decode_leg_ms_p50": _pct(dec_leg, 50),
            "decode_leg_ms_p99": _pct(dec_leg, 99),
            "e2e_ms_p50": _pct([h.latency_ms for h in hs], 50),
            "e2e_ms_p99": _pct([h.latency_ms for h in hs], 99),
            "prefill_by_worker": {
                str(r): healthz(r)["steps_by_kind"] for r in rids[:-1]},
            "decode_worker_steps": {k: kinds1[k] - kinds0[k]
                                    for k in kinds1},
            "healthz": {"code": hz.get("code"), "pools": hz.get("pools")},
            "metrics_fleet": {"code": met.get("code"), "has_migrations":
                              "hvd_serve_migrations_total"
                              in met.get("text", "")},
            "streams": rule1}
        checks["fanout_ok"] = (all(h.status == "ok" for h in hs)
                               and reply.get("code") == 200
                               and all(len(x) == new_tokens for x in st))
        checks["fanout_streams"] = not bad1
        # a "rejected" outcome is a full decode pool telling the router
        # to wait on the parked row: not a failed migration
        checks["fanout_migrated_once_each"] = (
            out["fanout"]["migrations"]["ok"] == len(fan)
            and not any(v for o, v in out["fanout"]["migrations"].items()
                        if o not in ("ok", "rejected"))
            and all(h.attempts == 1 for h in hs))
        checks["fanout_bytes"] = moved_bytes == want_bytes
        checks["decode_replays_no_prefill"] = (
            out["fanout"]["decode_worker_steps"]["prefill"] == 0
            and out["fanout"]["decode_worker_steps"]["decode"] > 0)
        checks["healthz_pools"] = (
            hz.get("code") == 200 and (hz.get("pools") or {}).get(
                "prefill", {}).get("admitting") is True
            and "migration_backlog" in (hz.get("pools") or {}).get(
                "decode", {}))
        checks["metrics_fleet"] = out["fanout"]["metrics_fleet"] == {
            "code": 200, "has_migrations": True}
        last = {r: k1_of(healthz(r)) for r in rids}

        # ---- burst 2: a serve.migrate window on prefill replica 0 ----
        h_dec0, h_pre0 = healthz(dec_rid), healthz(rids[0])
        stats0, out0 = router.stats(), outcomes()
        s = wire.connect(rep_of(rids[0]).addr, timeout=5.0)
        try:
            wire.send_msg(s, {"op": "chaos", "plan": {
                "seed": seed, "faults": [
                    {"rank": 0, "site": "serve.migrate", "kind": "corrupt",
                     "at": 0},
                    {"rank": 0, "site": "serve.migrate",
                     "kind": "conn_reset", "at": 1}]}})
            armed = wire.recv_msg(s, timeout=10.0)
        finally:
            s.close()
        if armed.get("ack") != "armed":
            raise SystemExit(f"phase 18: arming the window failed: {armed}")
        hs, reply, st, wall = burst(fresh, http_index=2)
        rule2, bad2 = rule(st, fresh)
        stats2, out2 = router.stats(), outcomes()
        h_dec1, h_pre1 = healthz(dec_rid), healthz(rids[0])
        out["migrate_window"] = {
            "migrations": {o: out2[o] - out0[o] for o in out2},
            "corrupt_detected_on_decode": (
                h_dec1["migrate_corrupt_detected"]
                - h_dec0["migrate_corrupt_detected"]),
            "absorbed_on_prefill": (h_pre1["migrate_absorbed"]
                                    - h_pre0["migrate_absorbed"]),
            "dedupe_hits_on_decode": (h_dec1["dedupe_hits"]
                                      - h_dec0["dedupe_hits"]),
            "reprefills": stats2["reprefills"] - stats0["reprefills"],
            "attempts": [h.attempts for h in hs],
            "replica0_prefills": (h_pre1["steps_by_kind"]["prefill"]
                                  - h_pre0["steps_by_kind"]["prefill"]),
            "streams": rule2}
        mw = out["migrate_window"]
        checks["window_answered"] = (all(h.status == "ok" for h in hs)
                                     and reply.get("code") == 200)
        checks["window_streams"] = not bad2
        checks["window_corrupt_caught"] = (
            mw["corrupt_detected_on_decode"] == 1
            and mw["migrations"]["migrate_corrupt"] == 1)
        checks["window_reset_absorbed"] = (mw["absorbed_on_prefill"] >= 1
                                           and mw["dedupe_hits_on_decode"]
                                           >= 1)
        checks["window_no_reprefill"] = (mw["reprefills"] == 0 and all(
            h.attempts == 1 for h in hs))

        # ---- burst 3: prefill replica 0's process is SIGKILLed ----
        stats0 = router.stats()
        rep0 = rep_of(rids[0])
        i0 = healthz(rids[0])["iterations"]
        at = i0 + 40                     # ~2 s of idle iterations ahead
        s = wire.connect(rep0.addr, timeout=5.0)
        try:
            wire.send_msg(s, {"op": "chaos", "plan": {
                "seed": seed, "faults": [
                    {"rank": 0, "site": "serve.proc", "kind": "crash",
                     "peer": rids[0], "at": at, "epoch": 0}]}})
            armed = wire.recv_msg(s, timeout=10.0)
        finally:
            s.close()
        if armed.get("ack") != "armed" or armed["iterations"] >= at - 5:
            raise SystemExit(f"phase 18: arming the crash failed: {armed}")
        while True:
            it = healthz(rids[0])["iterations"]
            if it >= at - DISAGG_CRASH_IN:
                break
            time.sleep(0.005)
        hs, reply, st, wall = burst(prompts, http_index=1)
        deadline = time.monotonic() + 300
        while not any(e["event"] == "readmit" for e in events):
            if time.monotonic() > deadline:
                raise SystemExit("phase 18: prefill replica 0 was not "
                                 "re-admitted: "
                                 + json.dumps(events, default=str))
            time.sleep(0.02)
        procs.append(rep0.proc)
        rule3, bad3 = rule(st, prompts)
        stats3 = router.stats()
        with open(os.path.join(root, "events",
                               f"replica.{rids[0]}.events.jsonl")) as f:
            fired = [json.loads(x) for x in f if x.strip()]
        crash_t = next(e["t"] for e in fired if e["kind"] == "crash")
        eject = next(e for e in events if e["event"] == "eject")
        readmit = next(e for e in events if e["event"] == "readmit")
        moved = [h for h in hs if h.attempts > 1]
        s1 = dict(rep0.startup or {})
        out["crash"] = {
            "armed_at_iteration": at, "burst_began_at_iteration": it,
            "gen0_rc": procs[0].poll(),
            "eject_after_kill_s": eject["t"] - crash_t,
            "moved": len(moved), "attempts": [h.attempts for h in hs],
            "reprefills": stats3["reprefills"] - stats0["reprefills"],
            "duplicates_suppressed": stats3["duplicates_suppressed"],
            "rejected": stats3["rejected"] - stats0["rejected"],
            "respawn": {
                "pid": rep0.pid, "gen": rep0.gen,
                "spawn_to_readmit_s": readmit["t"] - rep0.spawned_at,
                "eject_to_readmit_s": readmit["t"] - eject["t"],
                "import_s": s1.get("t_main", 0) - rep0.spawned_at,
                "cuda_context_s": s1.get("cuda_s"),
                "weights_s": s1.get("weights_s"),
                "capture_s": s1.get("capture_s")},
            "streams": rule3}
        checks["crash_answered"] = (all(h.status == "ok" for h in hs)
                                    and reply.get("code") == 200)
        checks["crash_streams"] = not bad3
        checks["crash_sigkilled"] = procs[0].poll() == -signal.SIGKILL
        checks["crash_ejected_in_time"] = (
            eject["replica"] == rids[0]
            and 0 <= out["crash"]["eject_after_kill_s"]
            <= 2 * FLEET_SUSPECT_S)
        checks["crash_moved_once"] = (
            len(moved) > 0 and all(h.attempts == 2 for h in moved)
            and stats3["duplicates_suppressed"] == 0
            and out["crash"]["rejected"] == 0)
        checks["crash_respawned_gen1"] = (
            readmit["replica"] == rids[0] and rep0.gen == 1
            and rep0.restarts == 1 and rep0.state == "up")
        # generation 1 serves: the fresh prompts again, through the pool
        first["0g1"] = k1_of(healthz(rids[0]))
        pre0 = {r: healthz(r)["steps_by_kind"]["prefill"] for r in rids[:-1]}
        hs, reply, st, wall = burst(fresh, http_index=4)
        rule3b, bad3b = rule(st, fresh)
        out["crash"]["after_readmit"] = {
            "prefills": {str(r): healthz(r)["steps_by_kind"]["prefill"]
                         - pre0[r] for r in rids[:-1]},
            "streams": rule3b}
        checks["gen1_serves"] = (
            all(h.status == "ok" for h in hs) and reply.get("code") == 200
            and not bad3b
            and out["crash"]["after_readmit"]["prefills"][str(rids[0])] > 0)
        # every worker idle: the counts the K1 checks read
        end = {r: k1_of(healthz(r)) for r in rids}
        kinds_end = healthz(dec_rid)["steps_by_kind"]

        # ---- burst 4: SIGTERM drain mid-burst ----
        drain_ps = make_requests(seed + 2)
        shed, late_reply = [], {}

        def late():
            while not router.draining:
                time.sleep(0.001)
            for p in drain_ps[:3]:
                try:
                    router.submit(p, max_new_tokens=new_tokens)
                    shed.append(None)
                except ht.Rejected as e:
                    shed.append(e.retry_after_ms)
            _post_generate(base, drain_ps[3], new_tokens, late_reply)

        old = signal.getsignal(signal.SIGTERM)
        signal.signal(signal.SIGTERM,
                      lambda *_: router.drain(timeout_s=300))
        reply = {}
        d0 = healthz(dec_rid)["steps_by_kind"]["decode"]
        poster = threading.Thread(target=_post_generate, args=(
            base, drain_ps[0], new_tokens, reply))
        poster.start()
        hs = [router.submit(p, max_new_tokens=new_tokens)
              for p in drain_ps[1:]]
        all_handles.extend(hs)
        # the decode worker a few steps into the burst, then SIGTERM
        deadline = time.monotonic() + 120
        while healthz(dec_rid)["steps_by_kind"]["decode"] < d0 + 4:
            if time.monotonic() > deadline:
                raise SystemExit("phase 18: burst 4 never reached the "
                                 "decode worker")
            time.sleep(0.01)
        late_thread = threading.Thread(target=late)
        late_thread.start()
        t_drain = time.perf_counter()
        signal.raise_signal(signal.SIGTERM)   # the handler drains, here
        drain_s = time.perf_counter() - t_drain
        signal.signal(signal.SIGTERM, old)
        late_thread.join(60)
        poster.join(600)
        rcs = [p.poll() for p in procs]
        stats = router.stats()
        out["drain"] = {
            "drain_s": drain_s, "statuses": [h.status for h in hs]
            + [reply.get("status")], "shed_retry_after_ms": shed,
            "http_during_drain": {"code": late_reply.get("code"),
                                  "retry_after": late_reply.get(
                                      "headers", {}).get("Retry-After")},
            "exit_codes": rcs}
        checks["drain_tail_answered"] = (
            all(h.done() for h in hs) and reply.get("code") in (200, 429)
            and all(h.status in ("ok", "rejected") for h in hs)
            and sum(h.status == "ok" for h in hs) > 0)
        checks["drain_sheds_with_retry"] = (
            len(shed) == 3 and all(x is not None and x > 0 for x in shed)
            and late_reply.get("code") == 429
            and int(late_reply.get("headers", {}).get("Retry-After", 0)) >= 1)
        checks["workers_exit_0"] = rcs[1:] == [0] * (len(rcs) - 1)
        checks["answered_once"] = all(h.done() and h.resolutions == 1
                                      for h in all_handles)
        # ---- K1 by worker: one launch a layer a replay, none outside ----
        per = {}
        for key, a, b in ([("0g0", first[rids[0]], last[rids[0]]),
                           ("0g1", first["0g1"], end[rids[0]])]
                          + [(f"{r}g0", first[r], end[r])
                             for r in rids[1:]]):
            d = {k: b[k] - a[k] for k in ("k1_launches",
                                          "k1_launches_process",
                                          "replays", "steps")}
            d.update(graphs_before=a["graphs"], graphs_after=b["graphs"],
                     kernel=b["kernel"])
            per[key] = d
        checks["k1_per_replay"] = all(
            d["replays"] > 0 and d["k1_launches"] == layers * d["replays"]
            for d in per.values())
        checks["k1_only_in_replays"] = all(
            d["k1_launches_process"] == d["k1_launches"]
            and d["steps"] == d["replays"] for d in per.values())
        checks["graphs_flat"] = all(d["graphs_before"] == d["graphs_after"]
                                    > 0 for d in per.values())
        checks["decode_never_prefills"] = kinds_end["prefill"] == \
            kinds0["prefill"]
        e2e = [h.latency_ms for h in all_handles]
        out.update({
            "launches": sum(d["k1_launches"] for d in per.values()),
            "workers": per,
            "router_ms": {"e2e_p50": _pct(e2e, 50), "e2e_p99": _pct(e2e, 99)},
            "stats": {k: v for k, v in stats.items()
                      if k not in ("prefill", "decode", "replicas")}})
    except BaseException:
        # a failed phase leaves nothing running, and says why
        log("disagg (failed) " + json.dumps(dict(out, checks=checks),
                                            default=str))
        for p in procs + [rep_of(r).proc for r in rids]:
            if p is not None:
                p.kill()
        for name in sorted(os.listdir(os.path.join(root, "logs"))
                           if os.path.isdir(os.path.join(root, "logs"))
                           else []):
            with open(os.path.join(root, "logs", name)) as f:
                tail = f.read()[-4000:]
            log_err(f"--- {name} (tail)\n{tail}")
        raise
    finally:
        router.close()
        if http is not None:
            http.shutdown()
            http.server_close()
        for p in procs:
            p.kill()
        srv.close()
        if frame_env is None:
            os.environ.pop("HOROVOD_SERVE_WIRE_MAX_FRAME", None)
        else:
            os.environ["HOROVOD_SERVE_WIRE_MAX_FRAME"] = frame_env
    pids = {p.proc.pid for p in procs}
    apps = _smi_apps()
    left = {pid for pid in apps if pid in pids}
    out["nvidia_smi_after_mib"] = {str(k): v for k, v in apps.items()}
    checks["no_worker_holds_the_card"] = (not left and all(
        p.poll() is not None for p in procs))
    out.update(worker_pids_on_card_after=sorted(left),
               phase_s=time.perf_counter() - t_phase, checks=checks)
    log("disagg " + json.dumps(out, default=str))
    if not all(checks.values()):
        raise SystemExit("phase 18: disaggregated serving failed: "
                         + json.dumps({k: v for k, v in checks.items()
                                       if not v}))
    return out


def _get_json(url, out):
    """``GET url``; ``out`` gets the JSON reply and its status code."""
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            out.update(json.loads(r.read()), code=r.status)
    except urllib.error.HTTPError as e:
        out.update(json.loads(e.read()), code=e.code)


def _get_text(url, out):
    with urllib.request.urlopen(url, timeout=60) as r:
        out.update(text=r.read().decode(), code=r.status)


# ---------------------------------------------------------------------------
# phase 19: checkpoint and resume of Llama_1B training
# ---------------------------------------------------------------------------

#: phase 19: steps before the save, and steps run after it
CKPT_BEFORE, CKPT_AFTER = 3, 3


def _clone_state(tree):
    """A copy of a state tree whose every tensor is a clone on its own
    device (the optimizer's ``state_dict`` returns its live tensors)."""
    if isinstance(tree, dict):
        return type(tree)((k, _clone_state(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone_state(v) for v in tree)
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree


def _state_diffs(got, want):
    """The paths at which ``got`` differs from ``want``: a tensor in
    dtype, shape, device or any bit; anything else by ``==``."""
    from horovod_tpu_torch.ckpt import flatten_with_paths
    gp, gl, gs = flatten_with_paths(got)
    wp, wl, ws = flatten_with_paths(want)
    if (gp, gs) != (wp, ws):
        return ["<structure>"]
    bad = []
    for p, a, b in zip(wp, gl, wl):
        if isinstance(b, torch.Tensor):
            if not (isinstance(a, torch.Tensor) and a.dtype == b.dtype
                    and a.shape == b.shape and a.device == b.device
                    and torch.equal(a, b)):
                bad.append(p)
        elif a != b:
            bad.append(p)
    return bad


def _copy_state_(model, opt, state):
    """Put ``state`` (a ``_clone_state`` of model and optimizer) back into
    the live model and optimizer in place, so ``state`` stays intact."""
    with torch.no_grad():
        for k, v in model.state_dict().items():
            v.copy_(state["params"][k])
        sd = opt.state_dict()
        for i, s in sd["state"].items():
            for k, v in s.items():
                v.copy_(state["opt"]["state"][i][k])


def ckpt_phase(ht, dev, smi):
    """Phase 19: phase 9's Llama_1B training (``build_lm_train_step``:
    full width, fp32 parameters, batch 4 x seq 2048, AdamW in
    DistributedOptimizer, fused CE on fp32 logits; K2-K6 on the main
    path), one rank over NCCL, checkpointed and resumed:

    1. steps 1-3 on phase 9's fixed seeded batch; the state (model and
       optimizer ``state_dict``) cloned on the card;
    2. step 3 saved with ``ShardedCheckpointer(async_save=True)`` (``{
       "params", "opt", "step": 3}``, ~13 GB); steps 4-6 run while the
       writer writes (run A), then ``wait_until_finished`` and
       ``verify_step``;
    3. the clone copied back in place and steps 4-6 run again with no
       writer (run B: two uninterrupted runs of the same steps);
    4. the model and optimizer dropped, a fresh pair built from another
       seed (one step so the optimizer holds state), step 3 restored
       into them on the card through ``target=``, every tensor compared
       with the clone; steps 4-6 once more (run C).

    Checks: A, B and C give the same losses bit for bit; every restored
    tensor equals the clone in dtype, shape, device and bits; K2-K6 ran
    on every step. Free disk under the temporary root is checked before
    the save (too little fails naming the bytes needed); the checkpoint
    directory is deleted in a ``finally``."""
    import shutil
    import tempfile
    import zlib
    from horovod_tpu_torch.ckpt import (ShardedCheckpointer, load_manifest,
                                        shard_name, step_dir, verify_step)
    from horovod_tpu_torch.models.bench_zoo import build_lm_train_step
    from horovod_tpu_torch.obs import metrics as obs_metrics
    from horovod_tpu_torch.ops import attention as attn
    from horovod_tpu_torch.ops import ce
    free_cuda()
    t_phase = time.perf_counter()
    name, _, _, kw = LLAMA_SPEC
    out = {"card": smi, "model": name}
    checks = {}
    ht.init()
    root = None
    try:
        step, model, (tokens, targets) = build_lm_train_step(
            seed=SEED, device=dev, **kw)
        fa, fce = attn.flash_attention, ce.fused_softmax_cross_entropy
        fa.fwd_launches = fa.dq_launches = fa.dkv_launches = 0
        fce.fwd_launches = fce.bwd_launches = 0

        def run(st, n):
            losses, ms = [], []
            for _ in range(n):
                t0 = time.perf_counter()
                losses.append(float(st(tokens, targets)))   # waits
                ms.append((time.perf_counter() - t0) * 1e3)
            return losses, ms

        first, _ = run(step, CKPT_BEFORE)
        opt = step.optimizer
        torch.cuda.synchronize()
        clone = _clone_state({"params": model.state_dict(),
                              "opt": opt.state_dict()})
        state_bytes = sum(v.numel() * v.element_size() for v in
                          model.state_dict().values()) + sum(
            v.numel() * v.element_size() for s in opt.state_dict()[
                "state"].values() for v in s.values()
            if isinstance(v, torch.Tensor))
        tmp = tempfile.gettempdir()
        free = shutil.disk_usage(tmp).free
        need = int(state_bytes * 1.05) + (1 << 30)
        out.update(state_bytes=state_bytes, disk_free_bytes=free,
                   disk_needed_bytes=need, tmp_root=tmp)
        if free < need:
            raise SystemExit(
                f"phase 19: {need} bytes needed under {tmp} for the "
                f"checkpoint of {state_bytes} bytes; {free} free")
        root = tempfile.mkdtemp(prefix="ckpt_", dir=tmp)
        R = obs_metrics.get_registry()
        save_h = R.histogram("hvd_ckpt_save_ms",
                             "checkpoint save, submit -> durable commit")
        n0, s0 = save_h.count, save_h.sum
        ck = ShardedCheckpointer(root, async_save=True, max_to_keep=0)
        try:
            t0 = time.perf_counter()
            assert ck.save(CKPT_BEFORE, {"params": model.state_dict(),
                                         "opt": opt.state_dict(),
                                         "step": CKPT_BEFORE})
            blocking_ms = (time.perf_counter() - t0) * 1e3
            loss_a, ms_a = run(step, CKPT_AFTER)
            t1 = time.perf_counter()
            ck.wait_until_finished()
            wait_ms = (time.perf_counter() - t1) * 1e3
        finally:
            ck.close()
        save_ms = (save_h.sum - s0) if save_h.count == n0 + 1 else None
        man = load_manifest(root, CKPT_BEFORE)
        nbytes = sum(c["nbytes"] for cs in man["chunks"].values()
                     for c in cs)
        t0 = time.perf_counter()
        ver = verify_step(root, CKPT_BEFORE)
        verify_ms = (time.perf_counter() - t0) * 1e3
        # the host's crc32 rate over the shard's bytes (the share of a
        # restore that the crc takes)
        crc_s, crc_bytes = 0.0, 0
        with open(os.path.join(step_dir(root, CKPT_BEFORE),
                               shard_name(0)), "rb") as f:
            while True:
                buf = f.read(1 << 28)
                if not buf:
                    break
                t0 = time.perf_counter()
                zlib.crc32(buf)
                crc_s += time.perf_counter() - t0
                crc_bytes += len(buf)
                del buf

        # ---- run B: the same steps from the clone, no writer ----
        _copy_state_(model, opt, clone)
        loss_b, ms_b = run(step, CKPT_AFTER)
        launches_main = {"fwd": fa.fwd_launches, "dq": fa.dq_launches,
                         "dkv": fa.dkv_launches,
                         "ce_fwd": fce.fwd_launches,
                         "ce_bwd": fce.bwd_launches}
        del step, model, opt
        free_cuda()

        # ---- run C: a fresh pair from another seed, restored ----
        step, model, _ = build_lm_train_step(seed=SEED + 1, device=dev,
                                             **kw)
        opt = step.optimizer
        float(step(tokens, targets))      # the optimizer's state exists
        torch.cuda.synchronize()
        ck = ShardedCheckpointer(root, async_save=False, max_to_keep=0)
        try:
            t0 = time.perf_counter()
            got = ck.restore(CKPT_BEFORE, target={
                "params": model.state_dict(), "opt": opt.state_dict(),
                "step": 0})
            torch.cuda.synchronize()
            restore_ms = (time.perf_counter() - t0) * 1e3
        finally:
            ck.close()
        diffs = _state_diffs({"params": got["params"], "opt": got["opt"]},
                             clone)
        model.load_state_dict(got["params"])
        opt.load_state_dict(got["opt"])
        restored_step = got["step"]
        del got, clone
        free_cuda()
        loss_c, ms_c = run(step, CKPT_AFTER)
        del step, model, opt
        out.update({
            "layers": kw["layers"], "batch": kw["batch"], "seq": kw["seq"],
            "losses_before": first, "losses_run_a_writer": loss_a,
            "losses_run_b": loss_b, "losses_run_c_restored": loss_c,
            "step_ms_writer": ms_a, "step_ms_no_writer": ms_b,
            "step_ms_restored": ms_c,
            "leaves": len(man["leaves"]), "bytes": nbytes,
            "blocking_ms": blocking_ms, "save_ms": save_ms,
            "wait_after_steps_ms": wait_ms,
            "write_gb_per_s": nbytes / 1e9 / (save_ms / 1e3)
            if save_ms else None,
            "verify_ms": verify_ms, "verify": ver,
            "restore_ms": restore_ms,
            "read_gb_per_s": nbytes / 1e9 / (restore_ms / 1e3),
            "crc32_gb_per_s": crc_bytes / 1e9 / crc_s if crc_s else None,
            "crc32_share_of_restore": (nbytes / (crc_bytes / crc_s))
            / (restore_ms / 1e3) if crc_s else None,
            "restored_step": restored_step, "state_diffs": diffs[:8],
            "launches": launches_main,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        steps = CKPT_BEFORE + 2 * CKPT_AFTER
        checks["saved"] = nbytes >= state_bytes and ver["chunks"] > 0
        checks["restored_bit_exact"] = not diffs and restored_step == \
            CKPT_BEFORE
        checks["uninterrupted_runs_agree"] = loss_a == loss_b
        checks["resumed_losses_agree"] = loss_c == loss_a
        checks["losses_finite"] = bool(np.all(np.isfinite(
            first + loss_a + loss_b + loss_c)))
        checks["kernels_every_step"] = launches_main == {
            "fwd": kw["layers"] * steps, "dq": kw["layers"] * steps,
            "dkv": kw["layers"] * steps, "ce_fwd": steps, "ce_bwd": steps}
    finally:
        if root is not None:
            shutil.rmtree(root, ignore_errors=True)
        ht.shutdown()
        free_cuda()
    out.update(phase_s=time.perf_counter() - t_phase, checks=checks)
    log("ckpt " + json.dumps(out, default=str))
    if not all(checks.values()):
        raise SystemExit("phase 19: checkpoint and resume failed: "
                         + json.dumps({k: v for k, v in checks.items()
                                       if not v}))
    return out


# ---------------------------------------------------------------------------
# phase 5: the CE kernels against their plain versions
# ---------------------------------------------------------------------------

def graph_ms(fn, iters=20):
    """Device time of one ``fn()`` with the host out of the way: ``iters``
    calls captured in a CUDA graph, the graph replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return cuda_ms(lambda i: graph.replay(), 10) / iters


def ce_inputs(T, V, dtype, neg, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(T, V, generator=g, device=dev) * 3).to(dtype)
    y = torch.randint(0, V, (T,), generator=g, device=dev,
                      dtype=torch.int32)
    if neg:
        y[::3] = -1
    return x, y


def ce_loss_path(ce, x, y, g):
    """The loss through autograd as the main path calls it: K2, then K3
    at the cotangent ``g``; returns (loss, the lse K2 saved, dlogits)."""
    xx = x.detach().clone().requires_grad_()
    loss = ce.fused_softmax_cross_entropy(xx, y)
    lse = ce.saved_lse(loss)
    (d,) = torch.autograd.grad(loss, xx, g)
    return loss.detach(), lse, d


def ce_graph_equals_eager(ce, x, y, g, want):
    """The loss path captured into two CUDA graphs (on torch's one capture
    stream) before either is replayed; the second replayed first, the
    first then on another stream, each twice: every replay gives
    ``want``'s bits."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ce_loss_path(ce, x, y, g)
    torch.cuda.current_stream().wait_stream(side)
    graphs, outs = [torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()], []
    for graph in graphs:
        with torch.cuda.graph(graph):
            outs.append(ce_loss_path(ce, x, y, g))
    same = True
    for graph, out, stream in ((graphs[1], outs[1], None),
                               (graphs[0], outs[0], side)):
        for _ in range(2):
            with torch.cuda.stream(stream):
                graph.replay()
            torch.cuda.synchronize()
            same = same and all(torch.equal(a, b)
                                for a, b in zip(want, out))
    del graphs, outs
    return same


def ce_inplace_backward(ce, x, y, d):
    """``loss /= 4`` on the returned loss, then ``backward()``: the
    gradient is ``d / 4`` bit for bit (``d`` at the cotangent 1; a scale
    by a power of two commutes with fp32 rounding)."""
    xx = x.detach().clone().requires_grad_()
    loss = ce.fused_softmax_cross_entropy(xx, y)
    loss /= 4
    loss.backward()
    return torch.equal(xx.grad, d / 4)


def ce_kernels_of_one_loss(ce, dev):
    """The CUDA kernels a profiled loss forward plus backward runs at the
    ResNet head (128 x 1000 fp32, int64 labels as phase 6 draws them, the
    cotangent given: ``loss.backward()`` adds autograd's fill of it).
    Called right after the build, before any other profiler session: on
    the H100 machine a short session that follows another one in the
    process (``--profile``'s serve phase) recorded no device events."""
    from torch.profiler import ProfilerActivity, profile
    x, y = ce_inputs(128, 1000, torch.float32, False, dev, seed=1)
    y = y.long()
    g = torch.ones((), device=dev)
    ce_loss_path(ce, x, y, g)
    xr = x.clone().requires_grad_()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loss = ce.fused_softmax_cross_entropy(xr, y)
        torch.autograd.grad(loss, xr, g)
        torch.cuda.synchronize()
    from torch.autograd import DeviceType
    return [e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def check_ce(ce, dev, names):
    """Each case through autograd as the main path calls it (int64
    labels), held by ``ce.check_against_plain`` (loss and lse max |err| <=
    1e-5 in both dtypes; dlogits max |err| <= 1e-6 in fp32, bf16 per
    element within 2^-7 |ref| + c |g / T|); int32 labels and a second
    call must give the same bits; at the first two shapes the replays of
    two CUDA graphs captured before either is replayed must equal the
    eager call; at the first an in-place ``loss /= 4`` must backpropagate;
    and ``names``, the kernels of one profiled loss
    (:func:`ce_kernels_of_one_loss`), must be K2 and K3."""
    results = []
    for i, (T, V, dtype, neg) in enumerate(CE_CASES):
        x, y = ce_inputs(T, V, dtype, neg, dev, seed=T + V)
        y64 = y.long()
        g = torch.ones((), device=dev)
        runs = [ce_loss_path(ce, x, yy, g) for yy in (y64, y, y64)]
        torch.cuda.synchronize()
        res = ce.check_against_plain(x, y64, *runs[0], g)
        same = all(torch.equal(a, b) for r in runs[1:]
                   for a, b in zip(runs[0], r))
        graph = ce_graph_equals_eager(ce, x, y64, g, runs[0]) if i < 2 \
            else None
        inplace = ce_inplace_backward(ce, x, y64, runs[0][2]) if i == 0 \
            else None
        ok = res["ok"] and same and graph is not False \
            and inplace is not False
        results.append({"T": T, "V": V, "dtype": str(dtype).split(".")[-1],
                        "neg_labels": neg, **res,
                        "int32_int64_repeat_bit_identical": same,
                        "two_graphs_replay_equal_eager": graph,
                        "inplace_loss_backward": inplace, "ok": ok})
        log(f"ce_check T={T} V={V} dtype={results[-1]['dtype']} neg={neg} "
            f"loss_err={res['loss_err']:.3g} lse_err={res['lse_err']:.3g} "
            f"dlogits_err={res['dlogits_max_abs_err']:.3g} "
            f"x{res['worst_share_of_bar']:.3f} int32=int64=repeat:{same} "
            f"graphs=eager:{graph} inplace:{inplace} "
            f"{'ok' if ok else 'FAIL'}")
        del x, y, y64, runs
    two = (len(names) == 2 and "ce_fwd_kernel" in names[0]
           and "ce_bwd_kernel" in names[1])
    results.append({"kernels_of_one_loss": names, "ok": two})
    log(f"ce_check kernels of one loss (fwd + bwd, 128 x 1000 fp32, int64 "
        f"labels): {len(names)} {names} {'ok' if two else 'FAIL'}")
    torch.cuda.empty_cache()
    if not all(r["ok"] for r in results):
        raise SystemExit("phase 5: a CE kernel disagrees with its plain "
                         "version, is not deterministic, or a loss runs "
                         "other kernels")
    return results


def host_us(fn, n=20000):
    """Host microseconds of one ``fn()``: the mean over ``n`` calls (with
    a synchronize after, so a launch's queue never fills)."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def time_ce_loss(ce, dev, T, V, dtype):
    """The loss as the main path calls it (int64 labels, the mean
    included, logits that require grad), forward and forward + backward
    (``autograd.grad``), against ``F.cross_entropy`` the same way: host
    loops timed by CUDA events, in turns (library, port, port, library),
    and CUDA-graph replays (the device's time alone)."""
    F = torch.nn.functional
    x, y = ce_inputs(T, V, dtype, False, dev, seed=7)
    y64 = y.long()
    xg = x.detach().clone().requires_grad_()
    fce = ce.fused_softmax_cross_entropy
    calls = {
        "loss_fwd": lambda: fce(xg, y64),
        "loss_fwd_bwd": lambda: torch.autograd.grad(fce(xg, y64), xg),
        "lib_loss_fwd": lambda: F.cross_entropy(xg, y64),
        "lib_loss_fwd_bwd": lambda: torch.autograd.grad(
            F.cross_entropy(xg, y64), xg)}
    iters = 50 if T * V >= 1 << 24 else 500
    out = {"T": T, "V": V, "dtype": str(dtype).split(".")[-1],
           "labels": "int64"}
    for kind in ("loss_fwd", "loss_fwd_bwd"):
        port, lib = calls[kind], calls["lib_" + kind]
        l1, p1, p2, l2 = (cuda_ms(lambda i: f(), iters)
                          for f in (lib, port, port, lib))
        out[f"{kind}_ms"], out[f"{kind}_ms_turns"] = (p1 + p2) / 2, [p1, p2]
        out[f"lib_{kind}_ms"], out[f"lib_{kind}_ms_turns"] = ((l1 + l2) / 2,
                                                              [l1, l2])
        out[f"{kind}_graph_ms"] = graph_ms(port)
        out[f"lib_{kind}_graph_ms"] = graph_ms(lib)
    log("ce_loss_time " + " ".join(f"{k}={v}" for k, v in out.items()))
    del x, xg
    return out


def time_ce_host_steps(ce, dev, T=128, V=1000):
    """``--ce``: host microseconds of each step of the loss's wrapper at
    the ResNet head, beside what it replaced: the second input check (the
    backward's), the outputs (the loss and lse with the partials, two
    allocations, against ``empty(2, T).unbind``), the Python stream
    object against the raw handle, the device query (the C side asks CUDA
    now), the library's lock, the launches that are gone from a loss (the
    int32 cast, the mean, the mean's backward, the backward's dtype /
    contiguity calls), and the capture check that each launch adds. Each a
    host loop of 20,000; ``saved_us_per_loss``: the old step less the new,
    times the calls a loss makes."""
    from horovod_tpu_torch.ops import _native
    x, y = ce_inputs(T, V, torch.float32, False, dev, seed=7)
    y64 = y.long()
    rows = torch.empty(T, device=dev)
    g0 = torch.ones((), device=dev)
    lse = torch.empty(T, device=dev)
    nb = ce._n_blocks(T, V)
    idx = dev.index or 0
    # name: (the old step or None, what took its place or None, the calls
    # a loss made of it: forward and backward each did some)
    steps = {
        "check_inputs": (lambda: ce._check_cuda(x, y64), None, 1),
        "outputs": (lambda: torch.empty(2, T, device=dev).unbind(0),
                    lambda: (torch.empty((), device=dev),
                             torch.empty(T + nb, device=dev)), 1),
        "stream_handle": (
            lambda: torch.cuda.current_stream(dev).cuda_stream,
            lambda: torch._C._cuda_getCurrentRawStream(idx), 2),
        "device_query": (lambda: torch.cuda.current_device(), None, 2),
        "library_lock": (lambda: _native.load(ce.LIBRARY), None, 2),
        "label_cast_launch": (lambda: y64.to(torch.int32), None, 1),
        "mean_launch": (lambda: rows.mean(), None, 1),
        "mean_backward_launch": (lambda: g0.expand(T).div(T), None, 1),
        "bwd_dtype_contiguous": (
            lambda: (lse.float().contiguous(), g0.float().contiguous()),
            None, 1),
        "capture_check": (None, torch.cuda.is_current_stream_capturing, 1)}
    out = {}
    for name, (old, new, count) in steps.items():
        out[f"{name}_old_us"] = host_us(old) if old else 0.0
        out[f"{name}_new_us"] = host_us(new) if new else 0.0
        out[f"{name}_saved_us_per_loss"] = count * (out[f"{name}_old_us"]
                                                    - out[f"{name}_new_us"])
    out["saved_us_per_loss"] = sum(v for k, v in out.items()
                                   if k.endswith("_saved_us_per_loss"))
    log("ce_host_steps " + " ".join(f"{k}={v:.3f}" for k, v in out.items()))
    return out


def time_ce(ce, dev, T, V, dtype):
    """K2 / K3 through their wrappers (``ce_fwd_kernel`` /
    ``ce_bwd_kernel``, int64 labels), their plain versions and
    F.cross_entropy (host loops timed by CUDA events; ``*_graph_ms``: the
    same calls replayed from a CUDA graph, the device's time alone), each
    beside the bound: bytes (logits and labels read once; lse and the
    loss written; the backward reads the logits, labels, lse and the
    cotangent and writes dlogits) over 3.35 TB/s, or the ~5 (forward) /
    ~4 (backward) fp32 operations per logit over 67 TFLOP/s, whichever
    is larger; then the loss as the main path calls it
    (:func:`time_ce_loss`). The library's backward in a graph: its
    forward + backward captured together, less its forward."""
    F = torch.nn.functional
    x, y = ce_inputs(T, V, dtype, False, dev, seed=7)
    y64 = y.long()
    isz = x.element_size()
    _, lse = ce.ce_fwd_kernel(x, y64)
    g = torch.ones((), device=dev)
    out = {"T": T, "V": V, "dtype": str(dtype).split(".")[-1]}
    iters = 50 if T * V >= 1 << 24 else 200
    out["fwd_ms"] = cuda_ms(lambda i: ce.ce_fwd_kernel(x, y64), iters)
    out["bwd_ms"] = cuda_ms(lambda i: ce.ce_bwd_kernel(x, y64, lse, g),
                            iters)
    out["fwd_plain_ms"] = cuda_ms(lambda i: ce.ce_fwd_plain(x, y64), 10)
    out["bwd_plain_ms"] = cuda_ms(
        lambda i: ce.ce_bwd_plain(x, y64, lse, g), 10)
    out["fwd_library_ms"] = cuda_ms(lambda i: F.cross_entropy(x, y64),
                                    iters)
    # the same calls with launch overhead removed (kernel time only)
    out["fwd_graph_ms"] = graph_ms(lambda: ce.ce_fwd_kernel(x, y64))
    out["bwd_graph_ms"] = graph_ms(lambda: ce.ce_bwd_kernel(x, y64, lse, g))
    out["fwd_library_graph_ms"] = graph_ms(lambda: F.cross_entropy(x, y64))
    xr = x.clone().requires_grad_()
    lib_loss = F.cross_entropy(xr, y64)
    out["bwd_library_ms"] = cuda_ms(
        lambda i: torch.autograd.grad(lib_loss, xr, retain_graph=True),
        iters)
    xg = x.clone().requires_grad_()
    out["bwd_library_graph_ms"] = graph_ms(
        lambda: torch.autograd.grad(F.cross_entropy(xg, y64), xg)
    ) - out["fwd_library_graph_ms"]
    for d, nbytes, ops in (
            ("fwd", T * V * isz + T * 8 + T * 4 + 4, 5 * T * V),
            ("bwd", 2 * T * V * isz + T * 8 + T * 4 + 4, 4 * T * V)):
        t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
        out[f"{d}_bound_ms"] = max(t_b, t_o)
        out[f"{d}_bound_by"] = "bytes" if t_b >= t_o else "operations"
        out[f"{d}_bytes"] = nbytes
        out[f"{d}_share_of_bound"] = out[f"{d}_bound_ms"] / out[f"{d}_ms"]
    log("ce_time " + " ".join(f"{k}={v}" for k, v in out.items()))
    del x, xr, lib_loss, xg
    out["loss"] = time_ce_loss(ce, dev, T, V, dtype)
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 6 and 7: data-parallel ResNet-50 training
# ---------------------------------------------------------------------------

def _allreduce_counts(reg):
    lab = {"collective": "allreduce"}
    calls = reg.get("hvd_collective_calls_total", lab)
    nbytes = reg.get("hvd_collective_bytes_total", lab)
    return (0 if calls is None else int(calls.value),
            0 if nbytes is None else int(nbytes.value))


def train_phase(ht, ce, dev, seed, profile=False):
    from horovod_tpu_torch.models.bench_zoo import build_benchmark_model
    from horovod_tpu_torch.obs import get_registry, step_timer
    t0 = time.perf_counter()
    ht.init()
    if ht.size() != 1 or torch.distributed.get_backend() != "nccl":
        raise SystemExit("phase 6: expected one rank over NCCL")
    model, has_bn = build_benchmark_model(
        "resnet50", 224, num_classes=1000, seed=seed,
        dtype=torch.bfloat16, device=dev)
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    ht.broadcast_parameters(model.state_dict(), root_rank=0)
    ht.broadcast_optimizer_state(opt, root_rank=0)
    step = ht.make_train_step(model, opt, has_batch_stats=has_bn)
    g = torch.Generator(device=dev).manual_seed(seed)
    images = torch.rand(TRAIN_BATCH, 224, 224, 3, generator=g, device=dev)
    labels = torch.randint(0, 1000, (TRAIN_BATCH,), generator=g,
                           device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    reg = get_registry()
    # ---- the main path: counts from 0, read right after ----
    fn = ce.fused_softmax_cross_entropy
    fn.fwd_launches = fn.bwd_launches = 0
    calls0, bytes0 = _allreduce_counts(reg)
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        ts = time.perf_counter()
        with step_timer(registry=reg):
            loss = step(images, labels)
            losses.append(float(loss))          # readback: waits
        if i >= WARMUP_STEPS:
            times.append((time.perf_counter() - ts) * 1e3)
    fwd, bwd = fn.fwd_launches, fn.bwd_launches
    calls1, bytes1 = _allreduce_counts(reg)
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = _Profile(profile, "train")
    with prof:
        for _ in range(5 if profile else 0):
            float(step(images, labels))
    steps = WARMUP_STEPS + TIMED_STEPS
    p50 = float(np.median(times))
    out = {"model": "resnet50", "image": 224, "batch": TRAIN_BATCH,
           "dtype": "bfloat16", "world_size": ht.size(),
           "backend": "nccl", "steps": steps, "losses": losses,
           "img_per_s": TRAIN_BATCH * len(times) / (sum(times) / 1e3),
           "step_p50_ms": p50, "step_ms": times,
           "hvd_step_time_ms_p50": reg.get("hvd_step_time_ms")
           .percentile(0.5),
           "peak_mem_gb": peak, "fwd_launches": fwd, "bwd_launches": bwd,
           "allreduce_calls": calls1 - calls0,
           "allreduce_bytes": bytes1 - bytes0, "setup_s": setup_s,
           "profile": prof.result}
    log("train " + json.dumps({k: v for k, v in out.items()
                               if k not in ("step_ms",)}))
    bad = []
    if not all(np.isfinite(losses)):
        bad.append("a loss is not finite")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    if not last < first:
        bad.append(f"loss did not fall: first-5 mean {first}, last-5 "
                   f"mean {last}")
    if fwd != steps or bwd != steps:
        bad.append(f"K2/K3 launched {fwd}/{bwd} times in {steps} steps")
    del model, opt, step, images, labels
    torch.cuda.empty_cache()
    if bad:
        raise SystemExit("phase 6: " + "; ".join(bad))
    return out


def train_parity_phase(ht, dev, seed):
    """One fp32 ResNet-50 step at batch 16 through the kernel loss and
    through the plain loss, from the same weights."""
    from horovod_tpu_torch.models.bench_zoo import build_benchmark_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    model, has_bn = build_benchmark_model(
        "resnet50", 224, num_classes=1000, seed=seed + 1,
        dtype=torch.float32, device=dev)
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    images = torch.rand(16, 224, 224, 3, generator=g, device=dev)
    labels = torch.randint(0, 1000, (16,), generator=g, device=dev)
    got = {}
    for name, loss_fn in (("kernel", ht.fused_cross_entropy_loss),
                          ("plain", ht.cross_entropy_loss)):
        model.load_state_dict(sd0)
        opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
        step = ht.make_train_step(model, opt, has_batch_stats=has_bn,
                                  loss_fn=loss_fn)
        loss = float(step(images, labels))
        got[name] = (loss, {k: p.detach().clone()
                            for k, p in model.named_parameters()})
    lk, pk = got["kernel"]
    lp, pp = got["plain"]
    loss_rel = abs(lk - lp) / abs(lp)
    max_update = max(float((pp[k] - sd0[k]).abs().max()) for k in pp)
    max_diff = max(float((pk[k] - pp[k]).abs().max()) for k in pp)
    out = {"batch": 16, "dtype": "float32", "loss_kernel": lk,
           "loss_plain": lp, "loss_rel_diff": loss_rel,
           "max_param_diff": max_diff, "max_update": max_update}
    log("train_parity " + json.dumps(out))
    del model, sd0, got, pk, pp
    torch.cuda.empty_cache()
    if not (loss_rel <= 1e-5 and max_diff <= 1e-3 * max_update
            and max_update > 0):
        raise SystemExit("phase 7: kernel-path and plain-path steps "
                         "differ: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 8: the flash attention kernels against their plain versions
# ---------------------------------------------------------------------------

def flash_inputs(B, H, KV, Sq, Skv, dtype, dev, seed, Dh=D):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(B, H, Sq, Dh, generator=g, device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(B, KV, Skv, Dh, generator=g, device=dev).to(dtype)
            for _ in range(2))
    dlse = torch.randn(B, H, Sq, generator=g, device=dev)
    return q, k, v, do, dlse


def _flash_line(errs):
    return " ".join(f"{n}={e['max_abs_err']:.3g}(x{e['ratio']:.2f}"
                    f",rel={e['rel_norm']:.2g})" for n, e in errs.items())


def check_flash(attn, dev):
    """K4 / K5 / K6 against their plain versions on the same inputs
    (``attention.check_against_plain``: the plain backward fed the
    kernel's lse and a delta with a live lse cotangent; fp32 max |err|
    <= 1e-4 on o and lse, <= 2e-4 x max|ref| on dq / dk / dv; bf16 every
    element within 2^-7 (|ref| + its term sum) + 1e-4 and ||err|| /
    ||ref|| <= 1e-2), then flash_attention_lse through autograd against
    the plain versions composed the same way. Each line prints max |err|,
    its largest share of the bar (xN, <= 1 passes) and the relative
    norm."""
    results = []
    for B, H, KV, Sq, Skv, Dh, causal, dtype in FLASH_CASES:
        q, k, v, do, dlse = flash_inputs(B, H, KV, Sq, Skv, dtype, dev,
                                         seed=Sq + Skv + H + Dh, Dh=Dh)
        errs = attn.check_against_plain(q, k, v, do, dlse, causal,
                                        1.0 / Dh ** 0.5)
        ok = all(e["ok"] for e in errs.values())
        results.append({"B": B, "H": H, "KV": KV, "Sq": Sq, "Skv": Skv,
                        "D": Dh, "causal": causal,
                        "dtype": str(dtype).split(".")[-1],
                        "errors": errs, "ok": ok})
        log(f"flash_check B={B} H={H} KV={KV} Sq={Sq} Skv={Skv} D={Dh} "
            f"causal={causal} dtype={results[-1]['dtype']} "
            f"{_flash_line(errs)} {'ok' if ok else 'FAIL'}")
        del q, k, v, do, dlse
        torch.cuda.empty_cache()
    # autograd with a live lse cotangent: the Function's backward
    q, k, v, do, dlse = flash_inputs(2, 32, 4, 300, 300, torch.float32,
                                     dev, seed=3)
    scale = 1.0 / D ** 0.5
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    o, lse = attn.flash_attention_lse(*xs, causal=True)
    ((o * do).sum() + (lse * dlse).sum()).backward()
    o_p, lse_p = attn.flash_fwd_plain(q, k, v, True, scale)
    delta_p = (do * o_p).sum(-1) - dlse
    dk_p, dv_p = attn.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta_p, True,
                                          scale)
    errs = attn.compare_with_plain(
        {"o": o.detach(), "lse": lse.detach(), "dq": xs[0].grad,
         "dk": xs[1].grad, "dv": xs[2].grad},
        {"o": o_p, "lse": lse_p, "dq": attn.flash_bwd_dq_plain(
            q, k, v, do, lse_p, delta_p, True, scale), "dk": dk_p,
         "dv": dv_p}, {}, torch.float32)
    ok = all(e["ok"] for e in errs.values())
    results.append({"autograd_lse_cotangent": True, "errors": errs,
                    "ok": ok})
    log("flash_check autograd lse cotangent B=2 H=32 KV=4 S=300 fp32 "
        f"{_flash_line(errs)} {'ok' if ok else 'FAIL'}")
    del xs, o, lse, q, k, v, do
    # K4, K5 and K6 twice on the same inputs give the same bits: no
    # atomics anywhere, K6 sums its pieces in a fixed order (the Llama_1B
    # shape, S 2100, where K6 also splits the query range, and D 256 at G
    # 8, KV 1, two pieces of 4 heads)
    for B, H_, KV_, S, Dh in ((4, 32, 4, 2048, D), (1, 4, 2, 2100, D),
                              (2, 8, 1, 1024, 256)):
        q, k, v, do, _ = flash_inputs(B, H_, KV_, S, S, torch.bfloat16, dev,
                                      seed=13, Dh=Dh)
        scale = 1.0 / Dh ** 0.5
        runs = []
        for _ in range(2):
            o, lse = attn.flash_fwd_kernel(q, k, v, True, scale)
            delta = (do.float() * o.float()).sum(-1)
            runs.append((o, lse, attn.flash_bwd_dq_kernel(
                q, k, v, do, lse, delta, True, scale),
                *attn.flash_bwd_dkv_kernel(q, k, v, do, lse, delta, True,
                                           scale)))
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        results.append({"determinism": "o, lse, dq, dk, dv", "B": B,
                        "H": H_, "KV": KV_, "S": S, "D": Dh, "ok": same})
        log(f"flash_check determinism B={B} H={H_} KV={KV_} S={S} D={Dh} "
            f"bf16: "
            f"K4 / K5 / K6 twice "
            f"{'bit-identical ok' if same else 'differ FAIL'}")
        del q, k, v, do, o, lse, delta, runs
    # above 512 every kernel refuses the head dim, and so does a call that
    # needs a gradient, before anything launches
    Dh = 520
    q, k, v, do, _ = flash_inputs(1, 4, 2, 64, 64, torch.bfloat16, dev,
                                  seed=Dh, Dh=Dh)
    lse = torch.zeros(1, 4, 64, device=dev)
    refused = []
    for what, call in (
            ("fwd", lambda: attn.flash_fwd_kernel(q, k, v, True, 0.1)),
            ("dq", lambda: attn.flash_bwd_dq_kernel(
                q, k, v, do, lse, lse, True, 0.1)),
            ("dkv", lambda: attn.flash_bwd_dkv_kernel(
                q, k, v, do, lse, lse, True, 0.1)),
            ("flash_attention with a gradient", lambda:
             attn.flash_attention(q.clone().requires_grad_(), k, v))):
        n0 = dict(attn.flash_attention.design_launches)
        try:
            call()
            refused.append(f"{what}: no error")
        except ValueError as e:
            if not (str(Dh) in str(e) and "512" in str(e)):
                refused.append(f"{what}: {e}")
        if attn.flash_attention.design_launches != n0:
            refused.append(f"{what}: launched before refusing")
    results.append({"refuses": True, "D": Dh, "ok": not refused,
                    "errors": refused})
    log(f"flash_check D={Dh}: K4, K5, K6 and a differentiable call refuse "
        f"the head dim, naming D and 512, before any launch "
        f"{'ok' if not refused else 'FAIL ' + '; '.join(refused)}")
    del q, k, v, do, lse
    torch.cuda.empty_cache()
    if not all(r["ok"] for r in results):
        raise SystemExit("phase 8: a flash attention kernel disagrees with "
                         "its plain version, or K4 / K5 / K6 are not "
                         "deterministic, or a head dim above 512 was not "
                         "refused")
    return results


def causal_pairs(B, H, Sq, Skv, causal):
    """(query, key) pairs a causal (top-left) or full mask keeps."""
    if not causal:
        return B * H * Sq * Skv
    return B * H * sum(min(i + 1, Skv) for i in range(Sq))


def time_flash(attn, dev, B, H, KV, S, dtype=torch.bfloat16, D=D,
               kinds=("fwd", "dq", "dkv"), causal=True):
    """``kinds`` of K4 / K5 / K6 at one main-path shape (causal, or not
    for the encoders; the backward's SDPA times with K5 and K6 only):
    host loop and CUDA graph times, the plain versions, SDPA forward and
    backward (one call each; the backward computes dq, dk and dv
    together, to be set against K5 + K6) and the bounds. Operations: 2 D
    per (query, key) pair the mask keeps and product; K4 does q k and p v
    (4 D), K5 q k, do v and ds k (6 D), K6 q k, do v, p^T do and ds^T q (8
    D). Bytes: each input read once and each output written once."""
    F = torch.nn.functional
    q, k, v, do, _ = flash_inputs(B, H, KV, S, S, dtype, dev, seed=11, Dh=D)
    scale = 1.0 / D ** 0.5
    o, lse = attn.flash_fwd_kernel(q, k, v, causal, scale)
    delta = (do.float() * o.float()).sum(-1)
    isz = q.element_size()
    pairs = causal_pairs(B, H, S, S, causal)
    qb, kb, rb = B * H * S * D * isz, B * KV * S * D * isz, B * H * S * 4
    work = {"fwd": (4 * pairs * D, 2 * qb + 2 * kb + rb),
            "dq": (6 * pairs * D, 3 * qb + 2 * kb + 2 * rb),
            "dkv": (8 * pairs * D, 2 * qb + 4 * kb + 2 * rb)}
    calls = {"fwd": lambda: attn.flash_fwd_kernel(q, k, v, causal, scale),
             "dq": lambda: attn.flash_bwd_dq_kernel(q, k, v, do, lse, delta,
                                                    causal, scale),
             "dkv": lambda: attn.flash_bwd_dkv_kernel(q, k, v, do, lse,
                                                      delta, causal, scale)}
    plains = {"fwd": lambda: attn.flash_fwd_plain(q, k, v, causal, scale),
              "dq": lambda: attn.flash_bwd_dq_plain(q, k, v, do, lse, delta,
                                                    causal, scale),
              "dkv": lambda: attn.flash_bwd_dkv_plain(q, k, v, do, lse,
                                                      delta, causal, scale)}
    out = {"B": B, "H": H, "KV": KV, "S": S, "D": D, "causal": causal,
           "dtype": str(dtype).split(".")[-1]}
    peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    for name in kinds:
        out[f"{name}_ms"] = cuda_ms(lambda i: calls[name](), 20)
        out[f"{name}_graph_ms"] = graph_ms(calls[name], 10)
        out[f"{name}_plain_ms"] = cuda_ms(lambda i: plains[name](), 3, 1)
        flops, nbytes = work[name]
        t_o, t_b = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        out[f"{name}_bound_ms"] = max(t_o, t_b)
        out[f"{name}_bound_by"] = "operations" if t_o >= t_b else "bytes"
        out[f"{name}_flops"], out[f"{name}_bytes"] = flops, nbytes
    # the library yardstick, never called by the port. The backward's
    # graph time is that of forward + backward captured together, less
    # the forward's: a backward alone would run on the stream of a
    # forward outside the capture. The captured pair has leaves of its
    # own (a leaf's gradient node, kept alive by ``ref``'s graph, would
    # tie the capture to the default stream).
    kw = {"is_causal": causal, "enable_gqa": True}
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def sdpa_fwd():
        return F.scaled_dot_product_attention(q, k, v, **kw)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(F.scaled_dot_product_attention(
            qg, kg, vg, **kw), (qg, kg, vg), do)

    out["sdpa_fwd_ms"] = cuda_ms(lambda i: sdpa_fwd(), 20)
    out["sdpa_fwd_graph_ms"] = graph_ms(sdpa_fwd, 10)
    out["design"] = {n: attn.design_of(n, dtype, attn.padded_dim(D))
                     for n in kinds}
    if "dq" not in kinds:
        log("flash_time " + " ".join(f"{k}={v}" for k, v in out.items()))
        del q, k, v, do, o, lse, delta, qr, kr, vr, qg, kg, vg
        torch.cuda.empty_cache()
        return out
    ref = F.scaled_dot_product_attention(qr, kr, vr, **kw)
    out["sdpa_bwd_ms"] = cuda_ms(lambda i: torch.autograd.grad(
        ref, (qr, kr, vr), do, retain_graph=True), 20)
    out["sdpa_bwd_graph_ms"] = (graph_ms(sdpa_fwd_bwd, 10)
                                - out["sdpa_fwd_graph_ms"])
    # the attention backward: K5 + K6 (all of K6's launches) against the
    # one SDPA call that computes dq, dk and dv together
    for t in ("", "_graph"):
        out[f"bwd_pair{t}_ms"] = out[f"dq{t}_ms"] + out[f"dkv{t}_ms"]
        out[f"bwd_pair{t}_over_sdpa_bwd"] = (out[f"bwd_pair{t}_ms"]
                                             / out[f"sdpa_bwd{t}_ms"])
    plan = attn.dkv_split_plan(H // KV, S)
    # K6 runs in pieces on its tensor-core design only
    one = out["design"]["dkv"] != "bwd_dkv_bf16"
    out.update(dkv_plan=[] if one else list(plan),
               dkv_pieces=1 if one else attn.dkv_pieces(H // KV, plan),
               dkv_scratch_bytes=0 if one else attn.dkv_scratch_bytes(
                   B, KV, S, attn.padded_dim(D), H // KV, plan))
    log("flash_time " + " ".join(f"{k}={v}" for k, v in out.items()))
    del q, k, v, do, o, lse, delta, qr, kr, vr, qg, kg, vg, ref
    torch.cuda.empty_cache()
    return out


def time_flash_wide(attn, dev):
    """K4-K6 at Gemma-2B's attention in fp32 (the CUDA-core designs), and
    at D 512 (two output column parts) in both dtypes."""
    return [time_flash(attn, dev, 4, 8, 1, 2048, torch.float32, D=256),
            time_flash(attn, dev, 4, 8, 1, 2048, D=512),
            time_flash(attn, dev, 4, 8, 1, 2048, torch.float32, D=512)]


def time_flash_split(attn, dev):
    """``--flash``: K6 at the main-path shapes (bf16, causal: Llama_1B's,
    GPT-2-small's and Gemma-2B's) under each split limit of
    ``FLASH_MAX_TILES``, each first held to its plain version; host loop
    and CUDA graph times, with K5 (untouched by the split) and K4 beside
    them."""
    saved = attn.DKV_MAX_TILES
    rows = []
    try:
        for B, H_, KV_, S, Dh in ((4, 32, 4, 2048, D), (8, 12, 12, 1024, D),
                                  (4, 8, 1, 2048, 256)):
            scale = 1.0 / Dh ** 0.5
            q, k, v, do, dlse = flash_inputs(B, H_, KV_, S, S,
                                             torch.bfloat16, dev, seed=11,
                                             Dh=Dh)
            o, lse = attn.flash_fwd_kernel(q, k, v, True, scale)
            delta = (do.float() * o.float()).sum(-1)

            def dq():
                return attn.flash_bwd_dq_kernel(q, k, v, do, lse, delta,
                                                True, scale)

            def dkv():
                return attn.flash_bwd_dkv_kernel(q, k, v, do, lse, delta,
                                                 True, scale)

            fwd_ms = cuda_ms(lambda i: attn.flash_fwd_kernel(q, k, v, True,
                                                             scale), 20)
            dq_ms = cuda_ms(lambda i: dq(), 20)
            for max_tiles in FLASH_MAX_TILES:
                attn.DKV_MAX_TILES = max_tiles
                plan = attn.dkv_split_plan(H_ // KV_, S)
                errs = attn.check_against_plain(q, k, v, do, dlse, True,
                                                scale)
                r = {"B": B, "H": H_, "KV": KV_, "S": S, "D": Dh,
                     "dkv_max_tiles": max_tiles, "dkv_plan": list(plan),
                     "dkv_pieces": attn.dkv_pieces(H_ // KV_, plan),
                     "dkv_scratch_bytes": attn.dkv_scratch_bytes(
                         B, KV_, S, Dh, H_ // KV_, plan),
                     "ok": all(e["ok"] for e in errs.values()),
                     "worst_ratio": max(e["ratio"] for e in errs.values()),
                     "dkv_ms": cuda_ms(lambda i: dkv(), 20),
                     "dkv_graph_ms": graph_ms(dkv, 10), "dq_ms": dq_ms,
                     "fwd_ms": fwd_ms}
                r["pair_ms"] = r["dq_ms"] + r["dkv_ms"]
                rows.append(r)
                log("flash_split " + " ".join(f"{a}={b}"
                                              for a, b in r.items()))
            del q, k, v, do, dlse, o, lse, delta
            torch.cuda.empty_cache()
    finally:
        attn.DKV_MAX_TILES = saved
    if not all(r["ok"] for r in rows):
        raise SystemExit("--flash: a split disagrees with the plain "
                         "versions")
    return rows


def ptxas_usage(log, kernels=("fwd_bf16", "bwd_dq_bf16", "bwd_dkv_bf16",
                              "dkv_combine")):
    """Registers, static shared memory and spill bytes of each instance
    of ``kernels`` in an ``nvcc -Xptxas -v`` log, keyed by its template
    arguments: ``name<DS,false>`` is the instance of stored width DS for
    D == DS, ``name<DS,true>`` the one for the narrower D it pads."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = None
            for name in kernels:
                t = re.search(name + r"I((?:L[ib]\d+E)+)E", m.group(1))
                if t:
                    args = [v if k == "i" else ("true" if v == "1"
                                                else "false")
                            for k, v in re.findall(r"L([ib])(\d+)E",
                                                   t.group(1))]
                    cur = f"{name}<{','.join(args)}>"
                    out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[cur]["spill_stores"], out[cur]["spill_loads"] = map(
                int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[cur]["static_smem"] = int(sm.group(1)) if sm else 0
    return out


# ---------------------------------------------------------------------------
# phases 9-11: LM training
# ---------------------------------------------------------------------------

def lm_params(model):
    """Parameters that take part in products (all but the input
    embedding table): the N of 6 N tokens."""
    return sum(p.numel() for n, p in model.named_parameters()
               if not n.startswith("embed."))


def lm_train_phase(ht, ce, attn, dev, spec, profile=False):
    """Train one LM from ``build_lm_train_step`` for ``warmup + timed``
    steps on a fixed seeded batch, one rank over NCCL; the kernel counts
    are set to 0 just before and read right after."""
    from horovod_tpu_torch.models.bench_zoo import build_lm_train_step
    name, warmup, timed, kw = spec
    t0 = time.perf_counter()
    step, model, (tokens, targets) = build_lm_train_step(
        seed=SEED, device=dev, **kw)
    cfg = model.cfg
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    fa, fce = attn.flash_attention, ce.fused_softmax_cross_entropy
    # ---- the main path: counts from 0, read right after ----
    fa.fwd_launches = fa.dq_launches = fa.dkv_launches = 0
    fa.design_launches = {}
    fce.fwd_launches = fce.bwd_launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(warmup + timed):
        ts = time.perf_counter()
        losses.append(float(step(tokens, targets)))     # readback: waits
        if i >= warmup:
            times.append((time.perf_counter() - ts) * 1e3)
    launches = {"fwd": fa.fwd_launches, "dq": fa.dq_launches,
                "dkv": fa.dkv_launches, "ce_fwd": fce.fwd_launches,
                "ce_bwd": fce.bwd_launches}
    by_design = dict(fa.design_launches)
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = _Profile(profile, name)
    with prof:
        for _ in range(2 if profile else 0):
            float(step(tokens, targets))
    steps = warmup + timed
    B, S = tokens.shape
    p50 = float(np.median(times))
    n_params = lm_params(model)
    pairs = causal_pairs(B, cfg.num_heads, S, S, True)
    flops = (6 * n_params * B * S
             + 12 * pairs * cfg.head_dim * cfg.num_layers)
    out = {"model": name, "layers": cfg.num_layers,
           "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
           "head_dim": cfg.head_dim, "vocab": cfg.vocab_size,
           "mlp": cfg.mlp_dim, "batch": B, "seq": S,
           "dtype": str(cfg.dtype).split(".")[-1],
           "logits_dtype": str(cfg.logits_dtype).split(".")[-1],
           "remat": cfg.remat, "world_size": ht.size(), "steps": steps,
           "losses": losses, "tokens_per_s": B * S * len(times)
           / (sum(times) / 1e3), "step_p50_ms": p50,
           "step_min_ms": min(times), "step_max_ms": max(times),
           "step_ms": times, "peak_mem_gb": peak, "params": sum(
               p.numel() for p in model.parameters()),
           "matmul_params": n_params, "flops_per_step": flops,
           "mfu_est": flops / (p50 / 1e3) / BF16_FLOPS,
           "launches": launches, "launches_by_design": by_design,
           "setup_s": setup_s, "profile": prof.result}
    log("lm_train " + json.dumps({k: v for k, v in out.items()
                                  if k != "step_ms"}))
    bad = []
    if not all(np.isfinite(losses)):
        bad.append("a loss is not finite")
    first, last = np.median(losses[:5]), np.median(losses[-5:])
    if not last < first:
        bad.append(f"loss did not fall: first-5 median {first}, last-5 "
                   f"median {last}")
    per = cfg.num_layers * (2 if cfg.remat else 1)
    want = {"fwd": per * steps, "dq": cfg.num_layers * steps,
            "dkv": cfg.num_layers * steps, "ce_fwd": steps,
            "ce_bwd": steps}
    if launches != want:
        bad.append(f"launches {launches}, expected {want}")
    del step, model, tokens, targets
    torch.cuda.empty_cache()
    if bad:
        raise SystemExit(f"{name}: " + "; ".join(bad))
    return out


def lm_parity_phase(ht, dev, cfg_kw=None, label="phase 11"):
    """One fp32 step of Llama at full width (2 layers, seq 512, batch 2;
    ``cfg_kw`` overrides its attention) through K4-K6 and K2 / K3 and one
    through the plain attention and plain cross entropy, from the same
    weights. SGD(0.01, momentum 0.9), as in phase 7: the bars are phase
    7's, set for an update linear in the gradient (Adam's per-element
    scaling turns fp32 rounding noise in a near-zero gradient element into
    a full-size step). K4-K6 counted by design around the kernel step."""
    from horovod_tpu_torch.models import convert, llama
    from horovod_tpu_torch.ops import attention as attn
    torch.backends.cuda.matmul.allow_tf32 = False
    got = {}
    for name, impl, loss_fn in (("kernel", None,
                                 ht.fused_cross_entropy_loss),
                                ("plain", "reference",
                                 ht.cross_entropy_loss)):
        cfg = llama.Llama_1B(num_layers=2, max_seq_len=512,
                             dtype=torch.float32, attention_impl=impl,
                             **(cfg_kw or {}))
        model = llama.Llama(cfg, device=dev)
        model.load_state_dict(convert.init_llama_params(
            cfg, torch.Generator(device=dev).manual_seed(SEED + 2), dev))
        sd0 = {k: v.detach().clone() for k, v in model.named_parameters()}
        g = torch.Generator(device=dev).manual_seed(SEED + 2)
        tokens = torch.randint(0, cfg.vocab_size, (2, 512), generator=g,
                               device=dev, dtype=torch.int32)
        opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
        step = ht.make_train_step(model, opt, loss_fn=loss_fn)
        # ---- the main path: counts from 0, read right after ----
        attn.flash_attention.design_launches = {}
        loss = float(step(tokens, torch.roll(tokens, -1, 1)))
        if name == "kernel":
            designs = dict(attn.flash_attention.design_launches)
        got[name] = (loss, {k: p.detach().clone()
                            for k, p in model.named_parameters()})
        del model, opt, step
    lk, pk = got["kernel"]
    lp, pp = got["plain"]
    loss_rel = abs(lk - lp) / abs(lp)
    max_update = max(float((pp[k] - sd0[k]).abs().max()) for k in pp)
    max_diff = max(float((pk[k] - pp[k]).abs().max()) for k in pp)
    out = {"model": "llama_1b_width_2_layers", "attention": cfg_kw or {},
           "batch": 2, "seq": 512, "dtype": "float32", "loss_kernel": lk,
           "loss_plain": lp, "loss_rel_diff": loss_rel,
           "max_param_diff": max_diff, "max_update": max_update,
           "launches_by_design": designs}
    log("lm_parity " + json.dumps(out))
    del got, pk, pp, sd0
    torch.cuda.empty_cache()
    if not (loss_rel <= 1e-5 and max_diff <= 1e-3 * max_update
            and max_update > 0 and designs):
        raise SystemExit(f"{label}: kernel-path and plain-path steps "
                         "differ: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 20: online learning — a trainer streams weights into a live fleet
# ---------------------------------------------------------------------------

#: phase 20's channel, its trainer (phase 9's Llama_1B recipe at batch 1 x
#: 2048, cut from phase 9's batch 4 so it fits beside two workers and the
#: comparison stack) and the AdamW steps between versions 1 and 2
STREAM_CHANNEL = "phase20"
STREAM_TRAIN = dict(LLAMA_SPEC[3], batch=1)
STREAM_STEPS = 5


def _healthz_steps(rep, timeout=10.0):
    """A worker's healthz with its recent step host ms by kind."""
    from horovod_tpu_torch.serve import wire
    s = wire.connect(rep.addr, timeout=timeout)
    try:
        wire.send_msg(s, {"op": "healthz", "step_ms": True})
        return wire.recv_msg(s, timeout=timeout)
    finally:
        s.close()


def _decode_ms(h0, h1):
    """The host ms of the decode steps a worker ran between two
    ``_healthz_steps`` replies."""
    n = (h1["steps_by_kind"].get("decode", 0)
         - h0["steps_by_kind"].get("decode", 0))
    xs = h1["step_ms"]["decode"]
    return xs[-n:] if n > 0 else []


def stream_phase(ht, ce, attn, paged, dev, seed, new_tokens, smi):
    """Phase 20: online learning at full width. A ``StoreServer`` in this
    process carries channel STREAM_CHANNEL. The trainer is phase 9's
    Llama_1B ``build_lm_train_step`` (AdamW, the fused CE on fp32 logits,
    K2-K6) at STREAM_TRAIN's batch 1 x 2048; its parameters, cast on the
    card to the serving model's dtypes under the serving names, are
    published as version 1 before the fleet starts. ``ProcessFleetRouter
    (2, channel=)`` runs two workers of phase 17's config, whose builder
    draws from ``seed + 1``: each passes its weight gate by fetching v1
    (2.2 GB) before it is admitted. A comparison stack in this process,
    the workers' own, adopts through a ``WeightSubscriber`` of its own
    (``attach_weights``): the yardstick of the streams.

    Burst A (phase 3's 9 requests) equals the comparison's streams at v1
    (phase 17's near-tie rule). The trainer takes STREAM_STEPS steps; a
    ``redist.transport`` corrupt is armed in worker 1 (its ``chaos`` op);
    burst B's waves of the 9 run while v2 is published and adopted:
    worker 1's first fetch of v2 is refused by the chunk crc32 and a
    later poll adopts it, every request is answered once, no worker's
    version goes backwards, each adopts v2 once. Burst C, after both
    report v2, equals the comparison's streams at v2, and differs from
    burst A somewhere. Publish, adoption, decode-step and memory numbers
    are printed beside the card."""
    import tempfile
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.models.bench_zoo import build_lm_train_step
    from horovod_tpu_torch.native.store import StoreClient, StoreServer
    from horovod_tpu_torch.redist.stream import (WeightPublisher,
                                                 WeightSubscriber)
    from horovod_tpu_torch.serve import wire
    from horovod_tpu_torch.serve import worker as wk
    from horovod_tpu_torch.serve.proc_fleet import ProcessFleetRouter
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="stream_")
    cfg = proc_worker_cfg(seed + 1, os.path.join(root, "spill"))
    prompts = make_requests(seed)
    out = {"card": smi, "channel": STREAM_CHANNEL,
           "trainer": {"batch": STREAM_TRAIN["batch"],
                       "seq": STREAM_TRAIN["seq"], "steps": STREAM_STEPS,
                       "cut": "batch 1 x 2048 (phase 9: 4 x 2048), beside "
                              "two workers and the comparison stack"}}
    log("stream: the trainer runs at batch 1 x 2048, cut from phase 9's "
        "batch 4 to share the card with two workers and the comparison "
        "stack")
    checks = {}
    fa, fce = attn.flash_attention, ce.fused_softmax_cross_entropy
    ht.init()
    srv = StoreServer()
    pub = WeightPublisher(STREAM_CHANNEL, kv_addr="127.0.0.1",
                          kv_port=srv.port, resume_timeout=0.05)
    router, st, csub, procs = None, None, None, []
    watch_stop = threading.Event()
    seen = {0: [], 1: []}           # every weights_version each worker said
    try:
        t0 = time.perf_counter()
        step, model, (tokens, targets) = build_lm_train_step(
            seed=seed, device=dev, **STREAM_TRAIN)
        torch.cuda.synchronize()
        out["trainer"]["setup_s"] = time.perf_counter() - t0
        serving = llama.Llama(llama.Llama_1B(
            dtype=torch.bfloat16, kv_block_size=BS,
            kv_pool_blocks=ht.pool_blocks_for(8, 2048, BS)),
            device="meta").state_dict()
        trained = model.state_dict()
        if set(serving) != set(trained) or any(
                serving[k].shape != trained[k].shape for k in serving):
            raise SystemExit(
                "phase 20: the trainer's state dict and the serving "
                "model's differ: " + json.dumps(sorted(
                    k for k in set(serving) | set(trained)
                    if k not in serving or k not in trained
                    or serving[k].shape != trained[k].shape)[:20]))
        del trained

        def publish():
            """Cast on the card to the serving dtypes, then publish."""
            t0 = time.perf_counter()
            with torch.no_grad():
                live = model.state_dict()
                sd = {k: live[k].detach().to(serving[k].dtype)
                      for k in serving}
            torch.cuda.synchronize()
            cast_ms = (time.perf_counter() - t0) * 1e3
            v = pub.publish(sd)
            del sd
            rec = dict(pub.last, cast_ms=cast_ms,
                       total_ms=(time.perf_counter() - t0) * 1e3)
            rec["gb_per_s"] = rec["bytes"] / (rec["total_ms"] / 1e3) / 1e9
            return v, rec

        v1, out["publish_v1"] = publish()
        log("stream publish_v1 " + json.dumps(out["publish_v1"]))
        checks["published_v1"] = v1 == 1

        # ---- the fleet: each worker gates on v1 ----
        router = ProcessFleetRouter(
            2, kv_addr="127.0.0.1", kv_port=srv.port, worker=cfg,
            channel=STREAM_CHANNEL, interval_s=FLEET_INTERVAL_S,
            suspect_s=FLEET_SUSPECT_S, log_dir=os.path.join(root, "logs"),
            events_dir=os.path.join(root, "events"))
        events = []
        router.add_listener(events.append)
        t0 = time.time()
        router.start()
        out["start_s"] = time.time() - t0
        procs += [r.proc for r in router.replicas.values()]

        def healthz(rid):
            h = _healthz_steps(router.replicas[rid])
            if h is None:
                raise SystemExit(f"phase 20: replica {rid} gave no healthz")
            return h

        first = {rid: healthz(rid) for rid in router.replicas}
        out["cold_start"] = {}
        for rid, rep in router.replicas.items():
            s = dict(rep.startup or {})
            ready = s.get("t_ready", 0) - rep.spawned_at
            out["cold_start"][str(rid)] = {
                "spawn_to_ready_s": ready, "gate_s": s.get("gate_s"),
                "gate_share": (s.get("gate_s") or 0) / ready if ready else
                None, "capture_s": s.get("capture_s"),
                "weights_s": s.get("weights_s"),
                "reserved_gb": (first[rid].get("cuda_mem") or {}).get(
                    "reserved_gb"),
                "adopt_v1": first[rid].get("stream"),
                "swap_v1": first[rid].get("last_swap")}
        checks["gated_on_v1"] = all(
            h["weights_version"] == 1 and h["swaps"] == 1
            and (router.replicas[r].startup or {}).get("gate_s")
            and router.replicas[r].weights_version == 1
            for r, h in first.items())

        def watch():
            while not watch_stop.wait(0.05):
                for rid, rep in router.replicas.items():
                    h = router._fetch_healthz(rep, timeout=2.0)
                    if h is not None and h.get("weights_version"):
                        seen[rid].append(h["weights_version"])
        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()

        # ---- the comparison stack, on its own subscriber ----
        t0 = time.perf_counter()
        st = wk.build_replica_stack(
            dict(cfg, kvtier_dir=os.path.join(root, "alone")), 0, dev)
        if st.executor.kernel != "cuda":
            raise SystemExit("phase 20: the comparison did not resolve K1")
        layers = st.executor.model.cfg.num_layers
        st.batcher.warmup()
        csub = WeightSubscriber(STREAM_CHANNEL, kv_addr="127.0.0.1",
                                kv_port=srv.port, template=st.executor.model)
        st.batcher.attach_weights(csub, min_interval_s=0.0)

        def adopt(v):
            deadline = time.monotonic() + 120
            while (st.executor.params_version or 0) < v:
                if time.monotonic() > deadline:
                    raise SystemExit(f"phase 20: the comparison stack did "
                                     f"not adopt version {v}")
                st.batcher._maybe_swap_weights()
                time.sleep(0.02)
            return dict(csub.last, swap=dict(st.executor.last_swap))

        out["comparison"] = {"adopt_v1": adopt(1),
                             "build_s": time.perf_counter() - t0}

        def reference():
            trace = _LogitTrace()
            trace.wrap(st.executor, lambda: st.batcher)
            hs = _burst(st.batcher, prompts, new_tokens)
            _unwrap(st.executor)
            if not all(h.status == "ok" for h in hs):
                raise SystemExit("phase 20: the comparison stack failed")
            tops = {}
            for (p, k), rows in trace.rows.items():
                v, i = torch.topk(rows[0].float(), 2)
                tops.setdefault(p, {})[k] = (
                    v.tolist(), i.tolist(), float(rows[0].float().abs().max()))
            return {tuple(p): h.tokens for p, h in zip(prompts, hs)}, tops

        # the main path: K1 counts in this process from 0
        paged.paged_attention_fused.launches = 0
        want1, tops1 = reference()

        def burst(ps):
            h0 = {rid: healthz(rid) for rid in router.replicas}
            t0 = time.perf_counter()
            hs = [router.submit(p, max_new_tokens=new_tokens) for p in ps]
            for h in hs:
                h.wait(600)
            wall = time.perf_counter() - t0
            h1 = {rid: healthz(rid) for rid in router.replicas}
            dec = sum((_decode_ms(h0[r], h1[r]) for r in h0), [])
            gen = sum(len(h.tokens or ()) for h in hs)
            return hs, {"requests": len(hs), "wall_s": wall,
                        "tokens_per_s": gen / wall,
                        "decode_steps": len(dec),
                        "decode_ms_p50": _pct(dec, 50),
                        "decode_ms_p99": _pct(dec, 99)}

        def rule(hs, want, tops):
            bad = [d for d in (_near_tie(tops[tuple(p)], h.tokens,
                                         want[tuple(p)])
                               for h, p in zip(hs, prompts))
                   if d is not None]
            return ({"requests": len(hs), "identical": len(hs) - len(bad),
                     "diverged": bad}, [d for d in bad if not d["ok"]])

        # ---- burst A on v1 ----
        hsA, out["burst_a"] = burst(prompts)
        out["burst_a"]["streams"], badA = rule(hsA, want1, tops1)
        checks["a_answered"] = all(h.status == "ok" and h.resolutions == 1
                                   and len(h.tokens) == new_tokens
                                   for h in hsA)
        checks["a_streams_v1"] = not badA

        # ---- train: K2-K6 counts from 0 ----
        fa.fwd_launches = fa.dq_launches = fa.dkv_launches = 0
        fce.fwd_launches = fce.bwd_launches = 0
        t0 = time.perf_counter()
        losses = [float(step(tokens, targets)) for _ in range(STREAM_STEPS)]
        out["trainer"].update(
            losses=losses, train_s=time.perf_counter() - t0,
            launches={"fwd": fa.fwd_launches, "dq": fa.dq_launches,
                      "dkv": fa.dkv_launches, "ce_fwd": fce.fwd_launches,
                      "ce_bwd": fce.bwd_launches})
        nl = model.cfg.num_layers
        checks["train_finite"] = bool(np.all(np.isfinite(losses)))
        checks["train_kernels"] = out["trainer"]["launches"] == {
            "fwd": nl * STREAM_STEPS, "dq": nl * STREAM_STEPS,
            "dkv": nl * STREAM_STEPS, "ce_fwd": STREAM_STEPS,
            "ce_bwd": STREAM_STEPS}

        # ---- burst B: v2 published and adopted mid-traffic ----
        rep1 = router.replicas[1]
        s = wire.connect(rep1.addr, timeout=5.0)
        try:
            wire.send_msg(s, {"op": "chaos", "plan": {"seed": seed, "faults": [
                {"rank": 0, "site": "redist.transport", "kind": "corrupt",
                 "at": 0}]}})
            armed = wire.recv_msg(s, timeout=10.0)
        finally:
            s.close()
        if armed.get("ack") != "armed":
            raise SystemExit(f"phase 20: arming the corrupt failed: {armed}")
        hB0 = {rid: healthz(rid) for rid in router.replicas}
        waves, stop_waves = [], threading.Event()

        def traffic():
            while not stop_waves.is_set():
                hs = [router.submit(p, max_new_tokens=new_tokens)
                      for p in prompts]
                waves.append(hs)
                for h in hs:
                    h.wait(600)

        t0 = time.perf_counter()
        feeder = threading.Thread(target=traffic, daemon=True)
        feeder.start()
        # v2 goes out once the workers decode burst B's first wave
        deadline = time.monotonic() + 120
        while sum(healthz(r)["steps_by_kind"].get("decode", 0)
                  for r in (0, 1)) < sum(
                h["steps_by_kind"].get("decode", 0) for h in hB0.values()) + 4:
            if time.monotonic() > deadline:
                raise SystemExit("phase 20: burst B never decoded")
            time.sleep(0.005)
        v2, out["publish_v2"] = publish()
        log("stream publish_v2 " + json.dumps(out["publish_v2"]))
        # the workers' decode steps from here to both on v2: the steps
        # that ran beside an adoption (fetch, crc32, assembly, staging)
        hP = {rid: healthz(rid) for rid in router.replicas}
        t_pub = time.perf_counter()
        deadline = time.monotonic() + 180
        while any(healthz(r)["weights_version"] != 2 for r in (0, 1)):
            if time.monotonic() > deadline:
                raise SystemExit("phase 20: version 2 was not adopted")
            time.sleep(0.05)
        adoption_s = time.perf_counter() - t_pub
        stop_waves.set()
        feeder.join(600)
        wall = time.perf_counter() - t0
        hB1 = {rid: healthz(rid) for rid in router.replicas}
        hsB = [h for w in waves for h in w]
        # (each worker keeps its last 1024 step times: burst B's are its
        # last 1024 a worker, the adoption window's all of its own)
        dec = sum((_decode_ms(hB0[r], hB1[r]) for r in hB0), [])
        adopting = sum((_decode_ms(hP[r], hB1[r]) for r in hP), [])
        out["burst_b"] = {
            "waves": len(waves), "requests": len(hsB), "wall_s": wall,
            "tokens_per_s": sum(len(h.tokens or ()) for h in hsB) / wall,
            "decode_steps": len(dec), "decode_ms_p50": _pct(dec, 50),
            "decode_ms_p99": _pct(dec, 99),
            "publish_to_both_on_v2_s": adoption_s,
            "adopting_decode_steps": len(adopting),
            "adopting_decode_ms_p50": _pct(adopting, 50),
            "adopting_decode_ms_p99": _pct(adopting, 99)}
        with open(os.path.join(root, "events",
                               "replica.1.events.jsonl")) as f:
            fired = [json.loads(x) for x in f if x.strip()]
        out["adoption_v2"] = {
            str(r): {"stream": hB1[r].get("stream"),
                     "swap": hB1[r].get("last_swap"),
                     "swaps": hB1[r]["swaps"],
                     "version": hB1[r]["weights_version"],
                     "reserved_gb": (hB1[r].get("cuda_mem") or {}).get(
                         "reserved_gb")} for r in (0, 1)}
        checks["b_published_v2"] = v2 == 2
        checks["b_answered_once"] = all(
            h.status == "ok" and h.resolutions == 1
            and len(h.tokens) == new_tokens for h in hsB)
        checks["b_corrupt_refused"] = (
            any(e.get("site") == "redist.transport"
                and e.get("kind") == "corrupt" for e in fired)
            and hB1[1]["stream"]["refused"] == 1
            and hB1[0]["stream"]["refused"] == 0)
        checks["b_adopted_once"] = all(
            hB1[r]["swaps"] == 2 and hB1[r]["weights_version"] == 2
            and hB1[r]["stream"]["version"] == 2 for r in (0, 1))

        # ---- burst C on v2 ----
        out["comparison"]["adopt_v2"] = adopt(2)
        want2, tops2 = reference()
        hsC, out["burst_c"] = burst(prompts)
        out["burst_c"]["streams"], badC = rule(hsC, want2, tops2)
        checks["c_answered"] = all(h.status == "ok" and h.resolutions == 1
                                   and len(h.tokens) == new_tokens
                                   for h in hsC)
        checks["c_streams_v2"] = not badC
        checks["weights_changed"] = any(a.tokens != c.tokens
                                        for a, c in zip(hsA, hsC))
        watch_stop.set()
        watcher.join(5)
        checks["versions_monotone"] = all(
            xs and xs == sorted(xs) and xs[-1] == 2 for xs in seen.values())
        # an adoption must not cost a worker its place in the fleet
        out["events"] = events
        checks["no_ejection"] = not any(e["event"] == "eject"
                                        for e in events)

        # ---- K1 in the workers and this process ----
        end = {rid: healthz(rid) for rid in router.replicas}
        per = {}
        for rid in router.replicas:
            per[str(rid)] = {k: end[rid][k] - first[rid][k]
                             for k in ("k1_launches", "k1_launches_process",
                                       "replays", "steps")}
        out["launches"] = sum(d["k1_launches"] for d in per.values())
        out["comparison"]["k1_launches"] = int(
            paged.paged_attention_fused.launches)
        out["workers"] = per
        checks["k1_per_replay"] = all(
            d["replays"] > 0 and d["k1_launches"] == layers * d["replays"]
            and d["k1_launches_process"] == d["k1_launches"]
            for d in per.values())
        kv = StoreClient("127.0.0.1", srv.port)
        try:
            keys = kv.stat()["data"]
        finally:
            kv.close()
        out["store"] = {
            # the channel's head and version key, both slots' chunks, and
            # each worker's heartbeat and registration keys
            "keys": keys,
            "keys_expected": 2 + out["publish_v1"]["chunks"]
            + out["publish_v2"]["chunks"] + 2 * len(router.replicas),
            "bytes": out["publish_v1"]["bytes"] + out["publish_v2"]["bytes"],
            "tree_bytes": out["publish_v2"]["bytes"]}
        checks["store_two_slots"] = keys == out["store"]["keys_expected"]
        out["memory"] = {
            "this_process_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "this_process_reserved_gb": torch.cuda.memory_reserved() / 1e9,
            "workers": {str(r): end[r].get("cuda_mem") for r in (0, 1)},
            "nvidia_smi_mib": {str(pid): mib for pid, mib in
                               _smi_apps().items()}}
        del step, model, tokens, targets
    except BaseException:
        for p in procs + ([r.proc for r in router.replicas.values()]
                          if router is not None else []):
            if p is not None:
                p.kill()
        logs = os.path.join(root, "logs")
        for name in sorted(os.listdir(logs) if os.path.isdir(logs) else []):
            with open(os.path.join(logs, name)) as f:
                log_err(f"--- {name} (tail)\n{f.read()[-4000:]}")
        raise
    finally:
        watch_stop.set()
        if router is not None:
            router.close()
        for p in procs:
            p.kill()
        if csub is not None:
            csub.close()
        pub.close()
        srv.close()
        if st is not None:
            st.batcher.stop()
        del st
        ht.shutdown()
        free_cuda()
    pids = {p.proc.pid for p in procs}
    left = sorted(pid for pid in _smi_apps() if pid in pids)
    checks["no_worker_holds_the_card"] = not left and all(
        p.poll() is not None for p in procs)
    out.update(phase_s=time.perf_counter() - t_phase, checks=checks,
               worker_pids_on_card_after=left)
    log("stream " + json.dumps(out, default=str))
    if not all(checks.values()):
        raise SystemExit("phase 20: the weight stream failed: " + json.dumps(
            {k: v for k, v in checks.items() if not v}))
    return out


# ---------------------------------------------------------------------------
# phase 21: the serve soaks on the card
# ---------------------------------------------------------------------------

#: phase 21's soaks: (name, runner, arguments) — the reference's own
#: acceptance calls, at the soak models' widths
SOAKS = (("fleet", "run_fleet_soak", dict(replicas=2, clients=4, seed=7)),
         ("disagg", "run_disagg_soak", dict(prefill=2, decode=1, seed=7)),
         ("serve", "run_serve_soak", {}),
         ("kvtier", "run_kvtier_soak", {}))


def _soak_faults_fired(v, out_dir):
    """Every scheduled fault (flaky windows aside) against the chaos
    events the soak logged: (fired, missing)."""
    want = {(f["site"], f["kind"], f.get("peer"))
            for f in v["plan"]["faults"] if f["kind"] != "flaky"}
    got = set()
    with open(os.path.join(out_dir, "events.jsonl")) as f:
        for line in f:
            e = json.loads(line)
            if e.get("kind") == "chaos":
                got.add((e.get("site"), e.get("fault"), e.get("peer")))
    return sorted(want & got), sorted(want - got)


def soak_phase(paged, smi):
    """Phase 21: the port's four serve soaks with their workers and
    models on the card (SOAKS). Each verdict is printed whole on a line
    of its own and must be ok, with every scheduled fault fired."""
    import tempfile
    from horovod_tpu_torch.serve import soak
    free_cuda()
    t_phase = time.perf_counter()
    out = {"card": smi}
    paged.paged_attention_fused.launches = 0
    bad = {}
    for name, fn, kw in SOAKS:
        work = tempfile.mkdtemp(prefix=f"soak_{name}_")
        t0 = time.perf_counter()
        v = getattr(soak, fn)(work, **kw)
        fired, missing = _soak_faults_fired(v, work)
        log(f"soak_{name} " + json.dumps(v, default=str, sort_keys=True))
        out[name] = {"ok": v["ok"], "seconds": time.perf_counter() - t0,
                     "wall_s": v.get("wall_s"), "faults_fired": fired,
                     "faults_missing": missing,
                     "statuses": v.get("statuses"),
                     "p99_outside_ms": v.get("p99_outside_ms")}
        if v["ok"] is not True or missing:
            bad[name] = {"ok": v["ok"], "missing": missing}
        free_cuda()
    # K1 in this process: the in-process soaks' replicas (serve, kvtier)
    out["launches"] = int(paged.paged_attention_fused.launches)
    out["phase_s"] = time.perf_counter() - t_phase
    log("soaks " + json.dumps(out, default=str))
    if bad or out["launches"] == 0:
        raise SystemExit("phase 21: a soak failed: " + json.dumps(
            bad, default=str))
    return out


# ---------------------------------------------------------------------------
# phase 22: the collective surface and the gradient path on the card
# ---------------------------------------------------------------------------

#: phase 22's dtypes per collective, where the reference takes them
COLL_DTYPES = (torch.float32, torch.bfloat16, torch.int32, torch.int8,
               torch.bool)
#: phase 22's ResNet-50 runs: warm-up and timed steps each
COLL_WARMUP, COLL_STEPS = 2, 6
#: the quantized collectives' block size
COLL_BS = 128


def _coll_input(dt, shape, g):
    """A seeded CPU tensor of ``dt``."""
    if dt == torch.bool:
        return torch.rand(shape, generator=g) > 0.5
    if dt in (torch.int32, torch.int8):
        return torch.randint(-100, 100, shape, generator=g).to(dt)
    return (torch.randn(shape, generator=g) * 3).to(dt)


def _coll_same(got, want, dt):
    """Card result against the CPU result: the same bits for integer,
    int8 and bool payloads and for pure transport; fp32 / bf16
    reductions within one rounding of their dtype."""
    got = got.cpu()
    if got.dtype != want.dtype or got.shape != want.shape:
        return False, float("inf")
    if not got.is_floating_point():
        return bool(torch.equal(got, want)), 0.0
    err = float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0
    tol = 1e-6 if dt == torch.float32 else 2 ** -8
    scale = float(want.float().abs().max()) if want.numel() else 0.0
    return err <= tol * max(scale, 1.0), err


def collectives_check(ht, dev):
    """Every collective of the slice on CUDA tensors over NCCL at world 1,
    over the global set and over an added set [0] with its own NCCL group,
    each held to the same call on CPU tensors over a gloo group of the
    same rank. At world 1 the sums, gathers and trees are over one rank:
    what runs on the card is the port's whole path (splits exchange,
    padding, quantization, group dispatch) and NCCL's; parity across
    ranks rests on the gloo tests of ``tests/test_torch_port_
    collectives.py``."""
    from horovod_tpu_torch.core import basics
    from horovod_tpu_torch.optim import compression as C
    from horovod_tpu_torch.ops import adasum
    table = basics.get_state().process_set_table
    # add_process_set([0]) is refused at world 1 (the global set's ranks),
    # as the reference refuses it; the card's sub-set is registered below
    try:
        ht.add_process_set([0])
        refused = None
    except ValueError as e:
        refused = str(e)
    sub = ht.ProcessSet([0])
    table.register(sub)
    cpu = ht.ProcessSet([0])
    table.register(cpu, backend="gloo")
    g = torch.Generator().manual_seed(22)
    rows, bad = [], []

    def check(name, fn, x, dt, *args):
        for label, ps in (("global", None), ("set[0]", sub)):
            got = fn(x.to(dev), *args, process_set=ps)
            want = fn(x, *args, process_set=cpu)
            pairs = (list(zip(got, want)) if isinstance(got, tuple)
                     else [(got, want)])
            ok, err = True, 0.0
            for a, b in pairs:
                if isinstance(a, list):
                    ok = ok and a == b
                    continue
                o, e = _coll_same(a, b, dt)
                ok, err = ok and o, max(err, e)
            rows.append({"collective": name, "set": label,
                         "dtype": str(dt).split(".")[-1], "ok": ok,
                         "max_abs_err": err})
            if not ok:
                bad.append(rows[-1])

    for dt in COLL_DTYPES:
        x = _coll_input(dt, (7, 5), g)
        check("alltoall/splits", ht.alltoall, x, dt, [7])
        check("alltoall", ht.alltoall, _coll_input(dt, (4, 3), g), dt)
        if dt != torch.int8:
            for op in (ht.Sum, ht.Average, ht.Min, ht.Max):
                if dt == torch.bool and op == ht.Average:
                    continue
                check(f"reducescatter/{op.name}", ht.reducescatter,
                      _coll_input(dt, (6, 4), g), dt, op)
                check(f"reducescatter/{op.name}/ragged", ht.reducescatter,
                      _coll_input(dt, (5, 3), g), dt, op)
    for dt in (torch.float32, torch.bfloat16):
        x = _coll_input(dt, (8, 300), g)
        check("quantized_allgather", partial_kw(ht.quantized_allgather,
                                                block_size=COLL_BS), x, dt)
        check("quantized_alltoall", partial_kw(ht.quantized_alltoall,
                                               block_size=COLL_BS), x, dt)
        for op in (ht.Sum, ht.Average):
            check(f"quantized_reducescatter/{op.name}",
                  partial_kw(ht.quantized_reducescatter,
                             block_size=COLL_BS), x, dt, op)
        def qar(t, average, process_set):
            # the payload quantized on the tensor's device
            qq, ss = C.block_quantize(t.float().reshape(-1), COLL_BS)
            return ht.quantized_allreduce(qq, ss, average,
                                          process_set=process_set)
        for average in (True, False):
            check(f"quantized_allreduce/avg={average}", qar, x, dt,
                  average)
        for wire in adasum.ADASUM_WIRE_FORMATS:
            def ada(t, process_set, wire=wire):
                return adasum.adasum_allreduce(t, process_set=process_set,
                                               wire=wire,
                                               block_size=COLL_BS)
            check(f"adasum/{wire}", ada, x, dt)
        check("allreduce/Adasum", partial_kw(ht.allreduce, op=ht.Adasum),
              x, dt)
    for ps in (sub, cpu):
        ht.remove_process_set(ps)
    adasum.reset_error_feedback()
    out = {"checks": len(rows), "failed": bad,
           "add_global_ranks_refused": refused,
           "note": "world 1 over NCCL (one card); parity across ranks rests "
                   "on the gloo tests"}
    log("collectives " + json.dumps(out))
    for r in rows:
        log("collective_check " + json.dumps(r))
    if bad or refused is None:
        raise SystemExit("phase 22: a collective disagrees with its CPU "
                         "result: " + json.dumps(bad))
    return out


def partial_kw(fn, **kw):
    """``fn`` with keyword arguments fixed (``process_set`` passed
    through)."""
    def call(*a, process_set=None):
        return fn(*a, process_set=process_set, **kw)
    return call


#: phase 22's ResNet-50 runs: name, make_train_step keywords, SyncBN
COLL_RUNS = (("none", {}, False),
             ("int8", {"compression": "int8"}, False),
             ("adasum", {"op": "adasum"}, False),
             ("syncbn_local", {"local_vars": ["Dense_0"]}, True))


def collective_train_runs(ht, ce, dev, seed, phase6=None):
    """ResNet-50 at full width, phase 6's batch and seed, one rank over
    NCCL, COLL_WARMUP + COLL_STEPS steps in each of COLL_RUNS: phase 6's
    configuration (the comparison of this call), Compression.int8,
    op=Adasum, and every BatchNorm swapped for SyncBatchNorm with the
    classifier's gradients rank-local. Losses finite, the first within
    1e-3 relative of phase 6's (of the ``none`` run under
    ``--collectives``), K2 / K3 once a step; step p50s and, from the
    counters, each step's wire bytes."""
    from horovod_tpu_torch.models.bench_zoo import build_benchmark_model
    from horovod_tpu_torch.obs import get_registry
    reg = get_registry()
    fn = ce.fused_softmax_cross_entropy
    out = {}

    def counter(name, labels):
        c = reg.get(name, labels)
        return 0 if c is None else int(c.value)
    # an engine registers its counter families anew when it is made (here
    # the first hooked step would make it): made first, the wire-byte
    # counters read below are the ones the runs add to
    ht.get_engine()
    for name, kw, sync in COLL_RUNS:
        free_cuda()
        model, has_bn = build_benchmark_model(
            "resnet50", 224, num_classes=1000, seed=seed,
            dtype=torch.bfloat16, device=dev)
        if sync:
            model = ht.SyncBatchNorm.convert_sync_batchnorm(model)
        opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
        ht.broadcast_parameters(model.state_dict(), root_rank=0)
        ht.broadcast_optimizer_state(opt, root_rank=0)
        kw = dict(kw)
        if "compression" in kw:
            kw["compression"] = getattr(ht.Compression, kw["compression"])
        if "op" in kw:
            kw["op"] = ht.Adasum
        step = ht.make_train_step(model, opt, has_batch_stats=has_bn, **kw)
        g = torch.Generator(device=dev).manual_seed(seed)
        images = torch.rand(TRAIN_BATCH, 224, 224, 3, generator=g,
                            device=dev)
        labels = torch.randint(0, 1000, (TRAIN_BATCH,), generator=g,
                               device=dev)
        torch.cuda.synchronize()
        # ---- the main path: counts from 0, read right after ----
        fn.fwd_launches = fn.bwd_launches = 0
        w0 = [counter("hvd_wire_bytes_total", {"kind": k})
              for k in ("logical", "actual")]
        c0 = counter("hvd_collective_bytes_total",
                     {"collective": "allreduce"})
        losses, times = [], []
        for i in range(COLL_WARMUP + COLL_STEPS):
            ts = time.perf_counter()
            losses.append(float(step(images, labels)))
            if i >= COLL_WARMUP:
                times.append((time.perf_counter() - ts) * 1e3)
        steps = COLL_WARMUP + COLL_STEPS
        w1 = [counter("hvd_wire_bytes_total", {"kind": k})
              for k in ("logical", "actual")]
        c1 = counter("hvd_collective_bytes_total",
                     {"collective": "allreduce"})
        run = {"losses": losses, "step_p50_ms": float(np.median(times)),
               "step_ms": times, "ce_fwd_launches": fn.fwd_launches,
               "ce_bwd_launches": fn.bwd_launches,
               "wire_logical_bytes_per_step": (w1[0] - w0[0]) / steps,
               "wire_actual_bytes_per_step": (w1[1] - w0[1]) / steps,
               "allreduce_bytes_per_step": (c1 - c0) / steps,
               "sync_batchnorms": sum(isinstance(m, ht.SyncBatchNorm)
                                      for m in model.modules())}
        out[name] = run
        log(f"collective_train {name} " + json.dumps(
            {k: v for k, v in run.items() if k != "step_ms"}))
        del model, opt, step, images, labels
    free_cuda()
    base = phase6 or out["none"]
    first = base["losses"][0]
    bad = []
    for name, run in out.items():
        ls = run["losses"]
        if not all(np.isfinite(ls)):
            bad.append(f"{name}: a loss is not finite")
        if abs(ls[0] - first) > 1e-3 * abs(first):
            bad.append(f"{name}: first loss {ls[0]} against {first}")
        steps = COLL_WARMUP + COLL_STEPS
        if run["ce_fwd_launches"] != steps or run["ce_bwd_launches"] != \
                steps:
            bad.append(f"{name}: K2/K3 launched {run['ce_fwd_launches']}/"
                       f"{run['ce_bwd_launches']} in {steps} steps")
    if out["int8"]["wire_actual_bytes_per_step"] <= 0 or \
            out["syncbn_local"]["sync_batchnorms"] == 0:
        bad.append("the int8 wire or the SyncBatchNorms did not run")
    summary = {name: {"step_p50_ms": r["step_p50_ms"],
                      "first_loss": r["losses"][0]}
               for name, r in out.items()}
    summary["phase6_step_p50_ms"] = (phase6 or {}).get("step_p50_ms")
    summary["int8_wire_actual_over_logical"] = (
        out["int8"]["wire_actual_bytes_per_step"]
        / max(out["int8"]["wire_logical_bytes_per_step"], 1))
    log("collective_train_summary " + json.dumps(summary))
    if bad:
        raise SystemExit("phase 22: " + "; ".join(bad))
    return out


def collectives_phase(ht, ce, dev, seed, phase6=None):
    """Phase 22: the collectives on the card, then ResNet-50's three
    runs."""
    ht.init()
    try:
        if ht.size() != 1 or torch.distributed.get_backend() != "nccl":
            raise SystemExit("phase 22: expected one rank over NCCL")
        t0 = time.perf_counter()
        out = {"collectives": collectives_check(ht, dev),
               "train": collective_train_runs(ht, ce, dev, seed, phase6)}
        out["phase_s"] = time.perf_counter() - t0
    finally:
        ht.shutdown()
    return out


# ---------------------------------------------------------------------------
# phase 23: the async engine
# ---------------------------------------------------------------------------

#: phase 23's dtypes of the async surface
ENGINE_DTYPES = (torch.float32, torch.bfloat16, torch.int32)
#: the tensors of phase 23's burst
ENGINE_BURST = 200
#: phase 23's ResNet-50 runs: warm-up and timed steps (phase 6's), and
#: the wires
ENGINE_WARMUP, ENGINE_STEPS = WARMUP_STEPS, TIMED_STEPS
ENGINE_WIRES = ("none", "int8", "fp16")
#: phase 22's ResNet-50 step p50 with per-tensor int8 and its share of
#: bytes on the wire (PR 15 run 2, NVIDIA H100 80GB HBM3, 700.00 W)
PER_TENSOR_INT8_MS, PER_TENSOR_INT8_SHARE = 122.76, 0.2578


def _bits_equal(a, b):
    """Same dtype, shape and bits (lists and tuples element by element)."""
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(
            _bits_equal(x, y) for x, y in zip(a, b))
    if not torch.is_tensor(a):
        return a == b
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        torch.equal(a.view(torch.uint8) if a.dtype == torch.bool else a,
                    b.view(torch.uint8) if b.dtype == torch.bool else b))


def _hist_delta(reg, name):
    """(count, bounds, counts) of a histogram, for deltas."""
    h = reg.get(name)
    if h is None:
        return 0, None, None
    snap = [e for e in reg.snapshot()["histograms"] if e["name"] == name]
    return int(h.count), snap[0]["bounds"], list(snap[0]["counts"])


def _delta_p50(before, after):
    from horovod_tpu_torch.obs.metrics import percentile_from_buckets
    if after[1] is None:
        return None
    c0 = before[2] or [0] * len(after[2])
    return percentile_from_buckets(after[1],
                                   [a - b for a, b in zip(after[2], c0)],
                                   0.5)


def engine_check(ht, dev):
    """The async surface on CUDA tensors at world 1 over NCCL, each call
    against the synchronous collective on the same inputs, bit for bit;
    fusion, the refusals, the algorithms and the fused wires."""
    from horovod_tpu_torch.obs import get_registry
    from horovod_tpu_torch.ops import collective_ops as co
    from horovod_tpu_torch.optim import compression as C
    reg = get_registry()
    eng = ht.get_engine()
    g = torch.Generator().manual_seed(23)
    rows, bad = [], []

    def check(name, got, want):
        ok = _bits_equal(got, want)
        rows.append({"check": name, "ok": ok})
        if not ok:
            bad.append(name)

    for dt in ENGINE_DTYPES:
        tag = str(dt).split(".")[-1]
        x = _coll_input(dt, (8, 5), g).to(dev)
        for op in (ht.Sum, ht.Average, ht.Max):
            check(f"allreduce_async/{op.name}/{tag}",
                  ht.allreduce_async(x, op).wait(), ht.allreduce(x, op))
        check(f"allgather_async/{tag}", ht.allgather_async(x).wait(),
              ht.allgather(x))
        check(f"broadcast_async/{tag}", ht.broadcast_async(x, 0).wait(),
              ht.broadcast(x, 0))
        check(f"alltoall_async/{tag}", ht.alltoall_async(x).wait(),
              ht.alltoall(x))
        check(f"alltoall_async/splits/{tag}",
              ht.alltoall_async(x, splits=[8]).wait(),
              ht.alltoall(x, splits=[8]))
        check(f"reducescatter_async/{tag}",
              ht.reducescatter_async(x, ht.Sum).wait(),
              ht.reducescatter(x, ht.Sum))
        xs = [x, _coll_input(dt, (3,), g).to(dev)]
        check(f"grouped_allreduce/{tag}", ht.grouped_allreduce(xs, ht.Sum),
              [ht.allreduce(t, ht.Sum) for t in xs])
        check(f"grouped_allreduce_async/{tag}", [
            ht.synchronize(h) for h in ht.grouped_allreduce_async(
                xs, ht.Average)], [ht.allreduce(t, ht.Average) for t in xs])
        check(f"grouped_allgather/{tag}", ht.grouped_allgather(xs),
              [ht.allgather(t) for t in xs])
        check(f"grouped_reducescatter/{tag}",
              ht.grouped_reducescatter(xs, ht.Sum),
              [ht.reducescatter(t, ht.Sum) for t in xs])
        h = ht.allreduce_async(x, ht.Sum)
        ht.wait(h)
        torch.cuda.synchronize()
        check(f"poll/{tag}", ht.poll(h), True)
    idx = torch.tensor([3, 0, 3, 7], device=dev)
    val = torch.randn(4, 6, generator=g).to(dev)
    dense = torch.zeros(9, 6, device=dev).index_add_(0, idx, val)
    check("sparse_allreduce/dense",
          ht.sparse_allreduce(idx, val, ht.Sum, dense=True, dense_dim0=9),
          dense)
    check("sparse_allreduce_async/coalesced",
          ht.sparse_allreduce_async(idx, val, ht.Average).wait(),
          (torch.tensor([0, 3, 7], device=dev), dense[[0, 3, 7]] / 1))
    check("join", ht.join(), 0)
    # 200 small tensors in one burst: few buckets
    hist = reg.get("hvd_fusion_bucket_tensors")
    b0 = hist.count
    xs = [_coll_input(torch.float32, (16,), g).to(dev)
          for _ in range(ENGINE_BURST)]
    hs = [ht.allreduce_async(t, ht.Sum, f"burst.{i}")
          for i, t in enumerate(xs)]
    check("burst", [h.wait() for h in hs], xs)
    burst_buckets = hist.count - b0
    # the refusals: a duplicate name, stop() with a pending handle
    old = eng.cycle_time_s
    eng.cycle_time_s = 0.5
    h = ht.allreduce_async(xs[0], ht.Sum, "dup")
    try:
        ht.allreduce_async(xs[0], ht.Sum, "dup")
        dup = None
    except ht.DuplicateNameError as e:
        dup = str(e)
    h.wait()
    eng.cycle_time_s = 5.0
    h = ht.allreduce_async(xs[0], ht.Sum, "pending")
    eng._running = False
    eng._wake.set()
    eng._thread.join(timeout=20)
    eng.stop()
    try:
        h.wait()
        aborted = None
    except RuntimeError as e:
        aborted = str(e)
    eng.cycle_time_s = old
    eng._stopped = False
    eng.start()
    if dup is None or aborted is None or "shut down" not in aborted:
        bad.append(f"refusals: duplicate {dup!r}, pending {aborted!r}")
    # the algorithms at world 1
    ps = ht.global_process_set
    x = _coll_input(torch.float32, (1000,), g).to(dev)
    direct = ht.allreduce(x, ht.Sum, algo="direct")
    for a in ("rs_ag", "two_level"):
        check(f"algo/{a}", ht.allreduce(x, ht.Sum, algo=a), direct)
        check(f"algo_async/{a}",
              ht.allreduce_async(x, ht.Sum, algo=a).wait(), direct)
    try:
        ht.allreduce(x, ht.Sum, algo="rhd")
        rhd_refusal = None
    except ValueError as e:
        rhd_refusal = str(e)
    if rhd_refusal is None:
        bad.append("algo=rhd was not refused at world 1")
    check("algo/rhd_sum", co._sum_(x.clone(), "rhd", ps), direct)
    check("algo/two_level_sum", co._sum_(x.clone(), "two_level", ps), direct)
    # the fused wires over three calls against their plain composition
    a_shape, b_n = (37, 9), 300
    res = None
    for wire in ("int8", "bf16"):
        res = None
        for call in range(3):
            a = _coll_input(torch.float32, a_shape, g).to(dev)
            b = _coll_input(torch.float32, (b_n,), g).to(dev)
            got = ht.grouped_allreduce([a, b], ht.Average, "wire." + wire,
                                       compression=wire)
            flat = torch.cat([a.reshape(-1), b])
            if wire == "int8":
                acc = flat if res is None else flat + res
                q, s = C.block_quantize(acc, COLL_BS)
                res = acc - C.block_dequantize(q, s, flat.numel())
                want = C.block_dequantize(q, s, flat.numel()) / 1
            else:
                want = flat.to(torch.bfloat16).div_(1).to(torch.float32)
            want = [want[:a.numel()].view(a_shape), want[a.numel():]]
            check(f"wire/{wire}/{call}", got, want)
    out = {"checks": len(rows), "failed": bad, "burst_tensors": ENGINE_BURST,
           "burst_buckets": burst_buckets,
           "hvd_fusion_bucket_tensors_p50": hist.percentile(0.5),
           "duplicate_refused": dup, "pending_aborted": aborted,
           "rhd_refusal_at_world_1": rhd_refusal,
           "cache": eng.cache_summary()}
    log("engine " + json.dumps(out, default=str))
    if bad:
        raise SystemExit("phase 23: " + json.dumps(bad))
    return out


def _gap_events(step):
    """CUDA events around the device gap between the backward's end and
    AdamW's start: one recorded when the optimizer wrapper's step begins
    (after ``loss.backward()`` returns), one when the wrapped optimizer's
    step begins (after the reduced gradients are written back)."""
    dist_opt = step.optimizer
    inner, outer = dist_opt._opt.step, dist_opt.step
    marks = []

    def outer_step(*a, **k):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append([e])
        return outer(*a, **k)

    def inner_step(*a, **k):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks[-1].append(e)
        return inner(*a, **k)

    dist_opt.step = outer_step
    dist_opt._opt.step = inner_step
    return marks


def engine_lm_run(ht, ce, attn, dev, hooks, profile=False):
    """Llama_1B (phase 9's configuration) for 3 + 10 steps through
    ``make_train_step``, its gradients reduced from hooks on the engine or
    at ``step()``; counts from 0 just before, read right after."""
    from horovod_tpu_torch.models.bench_zoo import build_lm_train_step
    from horovod_tpu_torch.obs import get_registry
    reg = get_registry()
    name, warmup, timed, kw = LLAMA_SPEC
    free_cuda()
    step, model, (tokens, targets) = build_lm_train_step(
        seed=SEED, device=dev, use_grad_hooks=hooks, **kw)
    cfg = model.cfg
    marks = _gap_events(step)
    torch.cuda.synchronize()
    fa, fce = attn.flash_attention, ce.fused_softmax_cross_entropy
    # ---- the main path: counts from 0, read right after ----
    fa.fwd_launches = fa.dq_launches = fa.dkv_launches = 0
    fce.fwd_launches = fce.bwd_launches = 0
    bk0 = _hist_delta(reg, "hvd_fusion_bucket_tensors")
    cy0 = _hist_delta(reg, "hvd_engine_cycle_ms")
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(warmup + timed):
        ts = time.perf_counter()
        losses.append(float(step(tokens, targets)))
        if i >= warmup:
            times.append((time.perf_counter() - ts) * 1e3)
    launches = {"fwd": fa.fwd_launches, "dq": fa.dq_launches,
                "dkv": fa.dkv_launches, "ce_fwd": fce.fwd_launches,
                "ce_bwd": fce.bwd_launches}
    bk1 = _hist_delta(reg, "hvd_fusion_bucket_tensors")
    cy1 = _hist_delta(reg, "hvd_engine_cycle_ms")
    peak = torch.cuda.max_memory_allocated() / 1e9
    gaps = [m[0].elapsed_time(m[1]) for m in marks[warmup:] if len(m) == 2]
    steps = warmup + timed
    prof = _Profile(profile, f"llama_1b_{'hooks' if hooks else 'step'}")
    with prof:
        for _ in range(1 if profile else 0):
            float(step(tokens, targets))
    out = {"hooks": hooks, "losses": losses,
           "step_p50_ms": float(np.median(times)), "step_ms": times,
           "peak_mem_gb": peak, "buckets_per_step": (bk1[0] - bk0[0]) / steps,
           "hvd_engine_cycle_ms_p50": _delta_p50(cy0, cy1),
           "bwd_end_to_adamw_gap_ms_p50": float(np.median(gaps)),
           "bwd_end_to_adamw_gap_ms": gaps, "launches": launches,
           "tokens_per_s": tokens.numel() * len(times) / (sum(times) / 1e3),
           "profile": prof.result}
    want = {"fwd": cfg.num_layers * steps, "dq": cfg.num_layers * steps,
            "dkv": cfg.num_layers * steps, "ce_fwd": steps, "ce_bwd": steps}
    del step, model, tokens, targets
    free_cuda()
    if launches != want:
        raise SystemExit(f"phase 23: Llama_1B launches {launches}, "
                         f"expected {want}")
    return out


def _time_calls(obj, names):
    """Sum the host seconds spent in ``obj``'s methods ``names`` (the
    optimizer's hooks call ``_grad_hook`` by attribute, so a wrapper on
    the instance sees every call); returns the running sums."""
    sums = {n: 0.0 for n in names}
    for n in names:
        fn = getattr(obj, n)

        def timed(*a, _fn=fn, _n=n, **k):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                sums[_n] += time.perf_counter() - t0
        setattr(obj, n, timed)
    return sums


def engine_resnet_run(ht, ce, dev, seed, wire, hooks=True, profile=False):
    """ResNet-50 (phase 6's configuration), ENGINE_WARMUP + ENGINE_STEPS
    steps with ``wire``'s compressor (int8 and fp16 travel as one grouped
    op, quantized or cast once a dtype), from the gradient hooks or at
    ``step()``."""
    from horovod_tpu_torch.models.bench_zoo import build_benchmark_model
    from horovod_tpu_torch.obs import get_registry
    reg = get_registry()
    free_cuda()
    model, has_bn = build_benchmark_model(
        "resnet50", 224, num_classes=1000, seed=seed, dtype=torch.bfloat16,
        device=dev)
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    ht.broadcast_parameters(model.state_dict(), root_rank=0)
    ht.broadcast_optimizer_state(opt, root_rank=0)
    step = ht.make_train_step(model, opt, has_batch_stats=has_bn,
                              compression=getattr(ht.Compression, wire),
                              use_grad_hooks=hooks)
    gen = torch.Generator(device=dev).manual_seed(seed)
    images = torch.rand(TRAIN_BATCH, 224, 224, 3, generator=gen, device=dev)
    labels = torch.randint(0, 1000, (TRAIN_BATCH,), generator=gen,
                           device=dev)
    torch.cuda.synchronize()

    def counter(kind):
        c = reg.get("hvd_wire_bytes_total", {"kind": kind})
        return 0 if c is None else int(c.value)
    fn = ce.fused_softmax_cross_entropy
    host = _time_calls(step.optimizer, ("_grad_hook", "synchronize"))
    # ---- the main path: counts from 0, read right after ----
    fn.fwd_launches = fn.bwd_launches = 0
    w0 = (counter("logical"), counter("actual"))
    bk0 = _hist_delta(reg, "hvd_fusion_bucket_tensors")
    losses, times = [], []
    for i in range(ENGINE_WARMUP + ENGINE_STEPS):
        ts = time.perf_counter()
        losses.append(float(step(images, labels)))
        if i >= ENGINE_WARMUP:
            times.append((time.perf_counter() - ts) * 1e3)
    w1 = (counter("logical"), counter("actual"))
    bk1 = _hist_delta(reg, "hvd_fusion_bucket_tensors")
    fwd, bwd = fn.fwd_launches, fn.bwd_launches
    steps = ENGINE_WARMUP + ENGINE_STEPS
    host_ms = {k: 1e3 * v / steps for k, v in host.items()}
    n_grads = sum(1 for p in model.parameters() if p.requires_grad)
    prof = _Profile(profile, f"resnet50_{wire}_{'hooks' if hooks else 'step'}")
    with prof:
        for _ in range(3 if profile else 0):
            float(step(images, labels))
    out = {"wire": wire, "hooks": hooks, "losses": losses,
           "step_p50_ms": float(np.median(times)), "step_ms": times,
           # a hook needs the GIL: the process's other Python threads
           "threads": sorted(t.name for t in threading.enumerate()),
           "gradients": n_grads,
           "buckets_per_step": (bk1[0] - bk0[0]) / steps,
           "wire_share": (w1[1] - w0[1]) / max(w1[0] - w0[0], 1),
           "ce_fwd_launches": fwd, "ce_bwd_launches": bwd,
           "host_ms_per_step": host_ms, "profile": prof.result}
    del model, opt, step, images, labels
    free_cuda()
    bad = []
    if not all(np.isfinite(losses)):
        bad.append("a loss is not finite")
    if not np.mean(losses[-3:]) < np.mean(losses[:3]):
        bad.append(f"loss did not fall: {losses}")
    if out["ce_fwd_launches"] != steps or out["ce_bwd_launches"] != steps:
        bad.append(f"K2/K3 launched {out['ce_fwd_launches']}/"
                   f"{out['ce_bwd_launches']} in {steps} steps")
    if bad:
        raise SystemExit(f"phase 23: ResNet-50 {wire}: " + "; ".join(bad))
    return out


def engine_phase(ht, ce, attn, dev, seed, profile=False):
    """Phase 23: the async surface, then Llama_1B both ways and ResNet-50
    on each wire."""
    ht.init()
    try:
        if ht.size() != 1 or torch.distributed.get_backend() != "nccl":
            raise SystemExit("phase 23: expected one rank over NCCL")
        t0 = time.perf_counter()
        out = {"check": engine_check(ht, dev)}
        step_run = engine_lm_run(ht, ce, attn, dev, False, profile)
        hooks_run = engine_lm_run(ht, ce, attn, dev, True, profile)
        diff = max(abs(a - b) for a, b in zip(hooks_run["losses"],
                                              step_run["losses"]))
        spread = None
        if diff:
            # the limit is the step-time path's own spread, if any
            again = engine_lm_run(ht, ce, attn, dev, False)
            spread = max(abs(a - b) for a, b in zip(again["losses"],
                                                    step_run["losses"]))
        lm = {"step": step_run, "hooks": hooks_run,
              "max_loss_diff": diff, "step_path_spread": spread}
        for k in ("step", "hooks"):
            log(f"engine_train llama_1b {k} " + json.dumps(
                {x: v for x, v in lm[k].items()
                 if x not in ("step_ms", "bwd_end_to_adamw_gap_ms")}))
        log("engine_train llama_1b " + json.dumps(
            {"max_loss_diff": diff, "step_path_spread": spread,
             "hooks_step_p50_ms": hooks_run["step_p50_ms"],
             "step_path_step_p50_ms": step_run["step_p50_ms"]}))
        if diff and (spread is None or diff > spread):
            raise SystemExit(f"phase 23: Llama_1B losses with hooks differ "
                             f"from the step-time path's by {diff} (their "
                             f"own spread {spread})")
        out["llama_1b"] = lm
        # phase 6's configuration with the gradients reduced at step()
        # (run first: the hooks' run does not take the first slot after
        # Llama_1B's)
        out["resnet50_step"] = engine_resnet_run(ht, ce, dev, seed, "none",
                                                 False, profile)
        out["resnet50"] = {w: engine_resnet_run(ht, ce, dev, seed, w,
                                                profile=profile)
                           for w in ENGINE_WIRES}
        log("engine_train resnet50 none step " + json.dumps(
            {x: v for x, v in out["resnet50_step"].items()
             if x != "step_ms"}))
        for w, r in out["resnet50"].items():
            log(f"engine_train resnet50 {w} " + json.dumps(
                {x: v for x, v in r.items() if x != "step_ms"}))
        log("engine_train resnet50 " + json.dumps({
            "step_p50_ms": {w: r["step_p50_ms"]
                            for w, r in out["resnet50"].items()},
            "none_step_time_path_step_p50_ms":
                out["resnet50_step"]["step_p50_ms"],
            "wire_share": {w: r["wire_share"]
                           for w, r in out["resnet50"].items()},
            "per_tensor_int8_step_p50_ms_pr15": PER_TENSOR_INT8_MS,
            "per_tensor_int8_wire_share_pr15": PER_TENSOR_INT8_SHARE}))
        out["phase_s"] = time.perf_counter() - t0
    finally:
        ht.shutdown()
    return out


# ---------------------------------------------------------------------------
# phase 24: the image models at full width (ViT-B/16, VGG-16, Inception V3)
# ---------------------------------------------------------------------------

def vision_train_run(ht, ce, attn, dev, name, model, opt, size, batch, seed,
                     profile=False):
    """``VISION_WARMUP + VISION_STEPS`` steps of ``model`` through
    ``make_train_step`` (the gradient hooks, the default) on a fixed
    seeded batch, one rank over NCCL; the kernel counts are set to 0 just
    before and read right after. Returns the run's numbers and the
    optimizer's buckets (tensors and bytes each)."""
    from horovod_tpu_torch.obs import get_registry
    reg = get_registry()
    ht.broadcast_parameters(model.state_dict(), root_rank=0)
    ht.broadcast_optimizer_state(opt, root_rank=0)
    step = ht.make_train_step(model, opt)
    g = torch.Generator(device=dev).manual_seed(seed)
    images = torch.rand(batch, size, size, 3, generator=g, device=dev)
    labels = torch.randint(0, 1000, (batch,), generator=g, device=dev)
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if k.endswith((".mean", ".var"))}
    torch.cuda.synchronize()
    fa, fce = attn.flash_attention, ce.fused_softmax_cross_entropy
    # ---- the main path: counts from 0, read right after ----
    fa.fwd_launches = fa.dq_launches = fa.dkv_launches = 0
    fa.design_launches = {}
    fce.fwd_launches = fce.bwd_launches = 0
    bk0 = _hist_delta(reg, "hvd_fusion_bucket_tensors")
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(VISION_WARMUP + VISION_STEPS):
        ts = time.perf_counter()
        losses.append(float(step(images, labels)))      # readback: waits
        if i >= VISION_WARMUP:
            times.append((time.perf_counter() - ts) * 1e3)
    launches = {"fwd": fa.fwd_launches, "dq": fa.dq_launches,
                "dkv": fa.dkv_launches, "ce_fwd": fce.fwd_launches,
                "ce_bwd": fce.bwd_launches}
    by_design = dict(fa.design_launches)
    bk1 = _hist_delta(reg, "hvd_fusion_bucket_tensors")
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = _Profile(profile, name)
    with prof:
        for _ in range(2 if profile else 0):
            float(step(images, labels))
    steps = VISION_WARMUP + VISION_STEPS
    buckets = [[len(b), sum(p.numel() * p.element_size() for p in b),
                [n for n, q in model.named_parameters()
                 if any(q is p for p in b)][:2]]
               for b in step.optimizer._groups or ()]
    out = {"model": name, "image": size, "batch": batch,
           "params": sum(p.numel() for p in model.parameters()),
           "world_size": ht.size(), "steps": steps, "losses": losses,
           "step_p50_ms": float(np.median(times)),
           "img_per_s": batch * len(times) / (sum(times) / 1e3),
           "step_ms": times, "peak_mem_gb": peak, "launches": launches,
           "launches_by_design": by_design,
           "buckets_per_step": (bk1[0] - bk0[0]) / steps,
           "buckets": buckets,
           "running_stats_unchanged": all(
               torch.equal(v, model.state_dict()[k])
               for k, v in stats.items()),
           "running_stats": len(stats), "profile": prof.result}
    bad = []
    if not all(np.isfinite(losses)):
        bad.append("a loss is not finite")
    first, last = np.median(losses[:5]), np.median(losses[-5:])
    if not last < first:
        bad.append(f"loss did not fall: first-5 median {first}, last-5 "
                   f"median {last}")
    del step, images, labels, stats
    return out, bad


def vit_parity(ht, dev, seed):
    """One fp32 step of ViT-B/16 at full width, depth cut to
    ``VIT_PARITY_LAYERS``, batch ``VIT_PARITY_BATCH``, through K4-K6 and
    K2 / K3 and one through the plain attention and plain cross entropy,
    from the same weights; phase 11's rule (SGD(0.01, momentum 0.9), loss
    within 1e-5 relative, parameters within 1e-3 of the largest update),
    with each gradient's largest difference over its largest value
    printed beside it."""
    from horovod_tpu_torch.models import convert, vit
    from horovod_tpu_torch.ops import attention as attn
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    got = {}
    for name, impl, loss_fn in (("kernel", None,
                                 ht.fused_cross_entropy_loss),
                                ("plain", "reference",
                                 ht.cross_entropy_loss)):
        cfg = vit.ViTConfig(num_layers=VIT_PARITY_LAYERS,
                            dtype=torch.float32, attention_impl=impl)
        model = vit.ViT(cfg, device=dev)
        model.load_state_dict(convert.init_vit_params(
            cfg, torch.Generator(device=dev).manual_seed(seed + 3), dev))
        sd0 = {k: v.detach().clone() for k, v in model.named_parameters()}
        g = torch.Generator(device=dev).manual_seed(seed + 3)
        images = torch.rand(VIT_PARITY_BATCH, cfg.image_size,
                            cfg.image_size, 3, generator=g, device=dev)
        labels = torch.randint(0, 1000, (VIT_PARITY_BATCH,), generator=g,
                               device=dev)
        opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
        step = ht.make_train_step(model, opt, loss_fn=loss_fn)
        # ---- the main path: counts from 0, read right after ----
        attn.flash_attention.design_launches = {}
        loss = float(step(images, labels))
        designs = dict(attn.flash_attention.design_launches)
        got[name] = (loss, {k: p.detach().clone()
                            for k, p in model.named_parameters()},
                     {k: p.grad.detach().clone()
                      for k, p in model.named_parameters()}, designs)
        del model, opt, step
    lk, pk, gk, designs = got["kernel"]
    lp, pp, gp, plain_designs = got["plain"]
    loss_rel = abs(lk - lp) / abs(lp)
    max_update = max(float((pp[k] - sd0[k]).abs().max()) for k in pp)
    max_diff = max(float((pk[k] - pp[k]).abs().max()) for k in pp)
    grad_ratio = {k: float((gk[k] - gp[k]).abs().max()
                           / gp[k].abs().max().clamp(min=1e-30))
                  for k in gp}
    worst = max(grad_ratio, key=grad_ratio.get)
    out = {"model": "vit_b16_width_2_layers", "batch": VIT_PARITY_BATCH,
           "dtype": "float32", "loss_kernel": lk, "loss_plain": lp,
           "loss_rel_diff": loss_rel, "max_param_diff": max_diff,
           "max_update": max_update, "worst_grad": worst,
           "worst_grad_diff_over_max": grad_ratio[worst],
           "launches_by_design": designs,
           "plain_launches_by_design": plain_designs}
    log("vision_parity " + json.dumps(out))
    del got, pk, pp, gk, gp, sd0
    free_cuda()
    if not (loss_rel <= 1e-5 and max_diff <= 1e-3 * max_update
            and max_update > 0 and designs and not plain_designs):
        raise SystemExit("phase 24: the fp32 ViT step on the kernels "
                         "differs from the plain path: " + json.dumps(out))
    return out


def vision_phase(ht, ce, attn, dev, seed, profile=False):
    """Phase 24: ViT-B/16, VGG-16 and Inception V3 trained at full width,
    the fp32 ViT step held to the plain path, and K4 / K5 / K6 at
    ViT-B/16's attention checked and timed."""
    from horovod_tpu_torch.core import basics
    from horovod_tpu_torch.models import convert, vit
    from horovod_tpu_torch.models.bench_zoo import build_benchmark_model
    t0 = time.perf_counter()
    ht.init()
    out, bad = {}, []
    try:
        if ht.size() != 1 or torch.distributed.get_backend() != "nccl":
            raise SystemExit("phase 24: expected one rank over NCCL")
        threshold = basics.get_config().fusion_threshold_bytes
        # an engine registers its metric families anew when it is made
        # (else the first hooked step would make it, after the bucket
        # count is read): made first, the counts read below are its own
        ht.get_engine()
        # a. ViT-B/16: fp32 parameters, bf16 compute, Adam(1e-3) as
        # examples/vit_train.py
        free_cuda()
        cfg = vit.ViTConfig()
        model = vit.ViT(cfg, device=dev)
        model.load_state_dict(convert.init_vit_params(
            cfg, torch.Generator(device=dev).manual_seed(seed), dev))
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        out["vit_b16"], b = vision_train_run(
            ht, ce, attn, dev, "vit_b16", model, opt, cfg.image_size,
            VIT_BATCH, seed, profile)
        per = cfg.num_layers * (VISION_WARMUP + VISION_STEPS)
        want = {"fwd": per, "dq": per, "dkv": per}
        bad += [f"ViT-B/16: {m}" for m in b]
        del model, opt
        # b, c. the frozen bench rows, SGD(0.01, momentum 0.9) as bench.py
        for name, size, batch in VISION_ROWS:
            free_cuda()
            model, _ = build_benchmark_model(
                name, size, num_classes=1000, seed=seed,
                dtype=torch.bfloat16, device=dev)
            opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
            out[name], b = vision_train_run(ht, ce, attn, dev, name, model,
                                            opt, size, batch, seed, profile)
            bad += [f"{name}: {m}" for m in b]
            del model, opt
        free_cuda()
        steps = VISION_WARMUP + VISION_STEPS
        for name in ("vit_b16", "vgg16", "inception3"):
            r = out[name]
            expect = dict(want if name == "vit_b16" else
                          {"fwd": 0, "dq": 0, "dkv": 0},
                          ce_fwd=steps, ce_bwd=steps)
            if r["launches"] != expect:
                bad.append(f"{name}: launches {r['launches']}, expected "
                           f"{expect}")
            log(f"vision_train {name} " + json.dumps(
                {k: v for k, v in r.items() if k not in ("step_ms",
                                                         "buckets")}))
        # VGG-16's FC gradients above the fusion threshold travel alone
        big = [bk for bk in out["vgg16"]["buckets"] if bk[1] > threshold]
        log("vision_buckets vgg16 threshold_bytes=" + str(threshold) + " "
            + json.dumps(out["vgg16"]["buckets"]))
        if not big or any(bk[0] != 1 for bk in big):
            bad.append(f"vgg16: buckets over the fusion threshold "
                       f"{threshold}: {big}")
        if not out["inception3"]["running_stats_unchanged"] or \
                not out["inception3"]["running_stats"]:
            bad.append("inception3: the running statistics moved")
        if bad:
            raise SystemExit("phase 24: " + "; ".join(bad))
        # d. the fp32 ViT step against the plain path
        out["parity"] = vit_parity(ht, dev, seed)
        # e. K4 / K5 / K6 at ViT-B/16's attention: checked, then timed
        B, H_, KV_, S, Dh = VIT_ATTENTION
        q, k, v, do, dlse = flash_inputs(B, H_, KV_, S, S, torch.bfloat16,
                                         dev, seed=S, Dh=Dh)
        errs = attn.check_against_plain(q, k, v, do, dlse, False,
                                        1.0 / Dh ** 0.5)
        ok = all(e["ok"] for e in errs.values())
        out["flash_check"] = {"B": B, "H": H_, "KV": KV_, "S": S, "D": Dh,
                              "causal": False, "dtype": "bfloat16",
                              "errors": errs, "ok": ok}
        log(f"vision_flash_check B={B} H={H_} KV={KV_} S={S} D={Dh} "
            f"causal=False bf16 {_flash_line(errs)} "
            f"{'ok' if ok else 'FAIL'}")
        del q, k, v, do, dlse
        free_cuda()
        if not ok:
            raise SystemExit("phase 24: K4 / K5 / K6 disagree with their "
                             "plain versions at ViT-B/16's attention")
        out["flash_time"] = time_flash(attn, dev, B, H_, KV_, S, D=Dh,
                                       causal=False)
        out["phase_s"] = time.perf_counter() - t0
        log("vision " + json.dumps({
            "phase_s": out["phase_s"],
            **{f"{n}_step_p50_ms": out[n]["step_p50_ms"]
               for n in ("vit_b16", "vgg16", "inception3")},
            **{f"{n}_img_per_s": out[n]["img_per_s"]
               for n in ("vit_b16", "vgg16", "inception3")}}))
    finally:
        ht.shutdown()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace the serve, ResNet, Llama training and "
                         "speculative serve phases with torch.profiler "
                         "(slower; writes {serve,train,llama_1b,"
                         "serve_spec}_profile.txt)")
    ap.add_argument("--flash", action="store_true",
                    help="phase 1, then only the flash attention kernels: "
                         "phase 8, and K6 under each split limit of "
                         "FLASH_MAX_TILES")
    ap.add_argument("--ce", action="store_true",
                    help="phase 1, then only the CE kernels: phase 5 and "
                         "the host steps of their wrapper")
    ap.add_argument("--serve", action="store_true",
                    help="phase 1, then only the serving phases 3, 4, 12, "
                         "13, 14, 15, 16, 17, 18, 20 and 21")
    ap.add_argument("--fleet", action="store_true",
                    help="phase 1, then only phase 16 (the fleet)")
    ap.add_argument("--proc-fleet", action="store_true",
                    help="phase 1, then only phase 17 (the process "
                         "fleet)")
    ap.add_argument("--disagg", action="store_true",
                    help="phase 1, then only phase 18 (disaggregated "
                         "serving)")
    ap.add_argument("--ckpt", action="store_true",
                    help="phase 1, then only phase 19 (checkpoint and "
                         "resume of Llama_1B training)")
    ap.add_argument("--stream", action="store_true",
                    help="phase 1, then only phase 20 (a Llama_1B trainer "
                         "streaming weights into a live process fleet)")
    ap.add_argument("--soak", action="store_true",
                    help="phase 1, then only phase 21 (the serve soaks)")
    ap.add_argument("--engine", action="store_true",
                    help="phase 1, then only phase 23 (the async engine, "
                         "Llama_1B through the gradient hooks and "
                         "ResNet-50 on the fused wires)")
    ap.add_argument("--vision", action="store_true",
                    help="phase 1, then only phase 24 (ViT-B/16, VGG-16 and "
                         "Inception V3 at full width, K4-K6 at ViT-B/16's "
                         "attention)")
    ap.add_argument("--collectives", action="store_true",
                    help="phase 1, then only phase 22 (the collectives "
                         "and ResNet-50's int8 / Adasum / SyncBatchNorm "
                         "runs)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this test needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    import horovod_tpu_torch as ht
    from horovod_tpu_torch.ops import _native, ce, paged
    from horovod_tpu_torch.ops import attention as attn
    from horovod_tpu_torch.serve import kv_cache as kvc
    dev = torch.device("cuda")
    report = {}

    # ---- phase 1: environment + build ----
    log(f"env python={sys.version.split()[0]} torch={torch.__version__} "
        f"cuda={torch.version.cuda} device={torch.cuda.get_device_name(0)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"card {smi}")        # so a run that fails later still names its card
    t0 = time.perf_counter()
    libs = [paged.KERNEL_NAME, ce.LIBRARY, attn.LIBRARY]
    logs = _native.build(libs)
    report["build_s"] = time.perf_counter() - t0
    log(f"build kernels={libs} seconds={report['build_s']:.2f}")
    # what ptxas gave K4 / K5 / K6 at D 64 (the main paths), beside the
    # dynamic shared memory their launches ask for
    usage = ptxas_usage(logs.get(attn.LIBRARY, ""))
    report["ptxas"] = usage
    main_path = {n: u for n, u in usage.items()
                 if re.search(rf"<{D},false[,>]", n)}
    log("ptxas " + json.dumps(main_path) + " dynamic_smem "
        + json.dumps({k: attn.smem_bytes(k, D)
                      for k in ("fwd", "dq", "dkv")}))
    # the tensor-core designs at DS 256 (head dims 136 .. 512): K4's
    # forward, K5, K6 and its combine, and K1's decode and prefill; each
    # should spill nothing
    wide = {n: u for n, u in itertools.chain(
        usage.items(), ptxas_usage(logs.get(paged.KERNEL_NAME, ""),
                                   ("decode_bf16_kernel",
                                    "prefill_bf16_kernel")).items())
        if "<256," in n}
    report["ptxas_d256"] = wide
    log("ptxas_d256 " + json.dumps(wide) + " dynamic_smem "
        + json.dumps({f"{k}_{d}": attn.smem_bytes(k, d)
                      for k in ("fwd", "dq", "dkv") for d in (256, 512)})
        + " spill_bytes "
        + str(sum(u.get("spill_stores", 0) + u.get("spill_loads", 0)
                  for u in wide.values())))
    # phase 5's profiled loss, taken before any other profiler session
    ce_kernels = ce_kernels_of_one_loss(ce, dev)

    if args.flash:
        report["flash_checks"] = check_flash(attn, dev)
        report["flash_time"] = [time_flash(attn, dev, 4, 32, 4, 2048),
                                time_flash(attn, dev, 8, 12, 12, 1024),
                                time_flash(attn, dev, 4, 8, 1, 2048, D=256)]
        report["flash_wide_time"] = time_flash_wide(attn, dev)
        report["flash_split"] = time_flash_split(attn, dev)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "chip_smoke_flash.json"),
                  "w") as f:
            json.dump(report, f, indent=1)
        log("flash ok")
        return 0
    if args.ce:
        report["ce_checks"] = check_ce(ce, dev, ce_kernels)
        report["ce_time"] = [time_ce(ce, dev, T, V, dt)
                             for T, V, dt, _ in CE_CASES[:2]]
        report["ce_time"].append(time_ce(ce, dev, 8192, 32000,
                                         torch.float32))
        report["ce_host_steps"] = time_ce_host_steps(ce, dev)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "chip_smoke_ce.json"),
                  "w") as f:
            json.dump(report, f, indent=1)
        log("ce ok")
        return 0

    if args.fleet:
        report["fleet"] = fleet_phase(ht, paged, dev, SEED, NEW_TOKENS, smi)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "chip_smoke_fleet.json"),
                  "w") as f:
            json.dump(report, f, indent=1, default=str)
        log("fleet ok")
        return 0
    if args.proc_fleet:
        report["proc_fleet"] = proc_fleet_phase(ht, dev, SEED, NEW_TOKENS,
                                                smi)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "chip_smoke_proc_fleet.json"),
                  "w") as f:
            json.dump(report, f, indent=1, default=str)
        log("proc_fleet ok")
        return 0
    if args.disagg:
        report["disagg"] = disagg_phase(ht, dev, SEED, NEW_TOKENS, smi)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "chip_smoke_disagg.json"),
                  "w") as f:
            json.dump(report, f, indent=1, default=str)
        log("disagg ok")
        return 0
    if args.ckpt:
        report["ckpt"] = ckpt_phase(ht, dev, smi)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "chip_smoke_ckpt.json"),
                  "w") as f:
            json.dump(report, f, indent=1, default=str)
        log("ckpt ok")
        return 0
    if args.stream:
        report["stream"] = stream_phase(ht, ce, attn, paged, dev, SEED,
                                        NEW_TOKENS, smi)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "chip_smoke_stream.json"),
                  "w") as f:
            json.dump(report, f, indent=1, default=str)
        log("stream ok")
        return 0
    if args.soak:
        report["soak"] = soak_phase(paged, smi)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "chip_smoke_soak.json"),
                  "w") as f:
            json.dump(report, f, indent=1, default=str)
        log("soak ok")
        return 0
    if args.engine:
        report["engine"] = engine_phase(ht, ce, attn, dev, SEED,
                                        args.profile)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "chip_smoke_engine.json"),
                  "w") as f:
            json.dump(report, f, indent=1, default=str)
        log("engine ok")
        return 0
    if args.vision:
        report["vision"] = vision_phase(ht, ce, attn, dev, SEED,
                                        args.profile)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "chip_smoke_vision.json"),
                  "w") as f:
            json.dump(report, f, indent=1, default=str)
        log("vision ok")
        return 0
    if args.collectives:
        report["collectives"] = collectives_phase(ht, ce, dev, SEED)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out",
                               "chip_smoke_collectives.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
        log("collectives ok")
        return 0
    if args.serve:
        report["serve"] = serve_phase(ht, paged, dev, SEED, NEW_TOKENS,
                                      args.profile)
        report["parity"], greedy_streams, greedy_trace = parity_phase(
            ht, dev, SEED, NEW_TOKENS)
        report["serve_spec"] = serve_spec_phase(ht, paged, dev, SEED,
                                                NEW_TOKENS, args.profile)
        report["spec_parity"] = spec_parity_phase(
            ht, dev, SEED, NEW_TOKENS, greedy_streams, greedy_trace)
        report["graph"] = graph_phase(ht, paged, dev, SEED, NEW_TOKENS)
        report["kvtier"] = kv_tier_phase(ht, paged, dev, SEED, NEW_TOKENS,
                                         smi, args.profile)
        report["fleet"] = fleet_phase(ht, paged, dev, SEED, NEW_TOKENS, smi,
                                      report["serve"]["tokens_per_s"])
        report["proc_fleet"] = proc_fleet_phase(
            ht, dev, SEED, NEW_TOKENS, smi, report["serve"]["tokens_per_s"],
            report["fleet"]["fanout"]["tokens_per_s"])
        report["disagg"] = disagg_phase(
            ht, dev, SEED, NEW_TOKENS, smi, report["serve"]["tokens_per_s"],
            report["proc_fleet"])
        report["stream"] = stream_phase(ht, ce, attn, paged, dev, SEED,
                                        NEW_TOKENS, smi)
        report["soak"] = soak_phase(paged, smi)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "chip_smoke_serve.json"),
                  "w") as f:
            json.dump(report, f, indent=1, default=str)
        log("serve ok")
        return 0

    # ---- phase 2: kernel vs plain, then times ----
    report["checks"] = check_kernel(paged, dev)
    report["decode_time"] = time_kernel(paged, kvc, dev, 8, 1, 2048,
                                        torch.bfloat16)
    report["decode_b1_time"] = time_kernel(paged, kvc, dev, 1, 1, 2048,
                                           torch.bfloat16)
    report["prefill_time"] = time_kernel(paged, kvc, dev, 8, 512, 512,
                                         torch.bfloat16)
    # a padded head dim (48 on the D-64 instance) at the same shapes
    report["decode_d48_time"] = time_kernel(paged, kvc, dev, 8, 1, 2048,
                                            torch.bfloat16, D=48)
    report["prefill_d48_time"] = time_kernel(paged, kvc, dev, 8, 512, 512,
                                             torch.bfloat16, D=48)
    # the speculative verify step of phase 12 (T = spec_k + 1, 32 rows a
    # kv head: the prefill design)
    report["verify_time"] = time_kernel(paged, kvc, dev, 8, SPEC_K + 1,
                                        2048, torch.bfloat16)
    # head dims the wrapper pads (D 4 -> 8: the time includes the copy of
    # q and both pools) beside D 8 itself
    for d in (4, 8):
        report[f"decode_d{d}_time"] = time_kernel(paged, kvc, dev, 8, 1,
                                                  2048, torch.bfloat16, D=d)
        report[f"prefill_d{d}_time"] = time_kernel(
            paged, kvc, dev, 8, 512, 512, torch.bfloat16, D=d)
    # head dim 256 at Gemma-2B's attention (H 8, KV 1): decode, the verify
    # step and a prefill on the bf16 designs at DS 256, decode on the fp32
    # wide design; D 512's two column parts; then the main path, a served
    # model in each dtype
    for name, T, L in (("decode", 1, 2048), ("verify", SPEC_K + 1, 2048),
                       ("prefill", 512, 512)):
        report[f"{name}_d256_time"] = time_kernel(
            paged, kvc, dev, 8, T, L, torch.bfloat16, D=256, H=8, KV=1)
    report["decode_d256_f32_time"] = time_kernel(
        paged, kvc, dev, 8, 1, 2048, torch.float32, D=256, H=8, KV=1)
    for name, T, L in (("decode", 1, 2048), ("prefill", 512, 512)):
        report[f"{name}_d512_time"] = time_kernel(
            paged, kvc, dev, 8, T, L, torch.bfloat16, D=512, H=8, KV=1)
    report["wide_serve"] = wide_serve_phase(ht, paged, dev, SEED, NEW_TOKENS)

    # ---- phase 3: the main path ----
    report["serve"] = serve_phase(ht, paged, dev, SEED, NEW_TOKENS,
                                  args.profile)

    # ---- phase 4: stream parity, fp32 ----
    report["parity"], greedy_streams, greedy_trace = parity_phase(
        ht, dev, SEED, NEW_TOKENS)

    # ---- phase 5: CE kernels vs plain, then times ----
    report["ce_checks"] = check_ce(ce, dev, ce_kernels)
    report["ce_time"] = [time_ce(ce, dev, T, V, dt)
                         for T, V, dt, _ in CE_CASES[:2]]
    # the Llama_1B LM head of phase 9: fp32 logits [8192, 32000]
    report["ce_time"].append(time_ce(ce, dev, 8192, 32000, torch.float32))

    # ---- phase 6: data-parallel training, the main path ----
    try:
        report["train"] = train_phase(ht, ce, dev, SEED, args.profile)
        # ---- phase 7: train-step parity, fp32 ----
        report["train_parity"] = train_parity_phase(ht, dev, SEED)

        # ---- phase 8: flash attention kernels vs plain, then times ----
        report["flash_checks"] = check_flash(attn, dev)
        report["flash_time"] = [time_flash(attn, dev, 4, 32, 4, 2048),
                                time_flash(attn, dev, 8, 12, 12, 1024),
                                time_flash(attn, dev, 4, 32, 4, 2048, D=48),
                                # D 4 (padded to 8 by a copy) beside D 8
                                time_flash(attn, dev, 4, 32, 4, 2048, D=4),
                                time_flash(attn, dev, 4, 32, 4, 2048, D=8),
                                # head dim 256 at Gemma-2B's attention
                                time_flash(attn, dev, 4, 8, 1, 2048, D=256)]
        # fp32's CUDA-core designs at D 256, both dtypes at D 512
        report["flash_wide_time"] = time_flash_wide(attn, dev)
        # the main path at head dim 256: a bf16 LM; then an fp32 step held
        # to the plain path (K4-K6's fp32 designs above 128)
        lw = report["lm_train_wide"] = lm_train_phase(ht, ce, attn, dev,
                                                      WIDE_SPEC)
        log(f"lm_train_wide step_p50_ms={lw['step_p50_ms']} "
            f"cuda_core_backward_step_p50_ms={WIDE_STEP_CUDA_CORE_MS} "
            f"mfu_est={lw['mfu_est']} "
            f"launches_by_design={json.dumps(lw['launches_by_design'])}")
        report["lm_parity_wide"] = lm_parity_phase(
            ht, dev, dict(num_heads=8, num_kv_heads=1, head_dim=256),
            "phase 8 (D 256)")

        # ---- phases 9 and 10: LM training, the main paths ----
        report["lm_train_llama"] = lm_train_phase(ht, ce, attn, dev,
                                                  LLAMA_SPEC, args.profile)
        report["lm_train_gpt"] = lm_train_phase(ht, ce, attn, dev,
                                                GPT_SPEC)

        # ---- phase 11: LM train-step parity, fp32 ----
        report["lm_parity"] = lm_parity_phase(ht, dev)
    finally:
        ht.shutdown()

    # ---- phase 12: sampled and speculative serving, the main path ----
    report["serve_spec"] = serve_spec_phase(ht, paged, dev, SEED,
                                            NEW_TOKENS, args.profile)
    # ---- phase 13: speculative stream parity, fp32 ----
    report["spec_parity"] = spec_parity_phase(ht, dev, SEED, NEW_TOKENS,
                                              greedy_streams, greedy_trace)
    # ---- phase 14: replay vs eager, hot swap, fp32 ----
    report["graph"] = graph_phase(ht, paged, dev, SEED, NEW_TOKENS)
    # ---- phase 15: KV integrity and the KV tier, the main path ----
    report["kvtier"] = kv_tier_phase(ht, paged, dev, SEED, NEW_TOKENS, smi,
                                     args.profile)
    # ---- phase 16: the in-process fleet, the main path ----
    report["fleet"] = fleet_phase(ht, paged, dev, SEED, NEW_TOKENS, smi,
                                  report["serve"]["tokens_per_s"])
    # ---- phase 17: the process fleet, the main path ----
    report["proc_fleet"] = proc_fleet_phase(
        ht, dev, SEED, NEW_TOKENS, smi, report["serve"]["tokens_per_s"],
        report["fleet"]["fanout"]["tokens_per_s"])
    # ---- phase 18: disaggregated serving, the main path ----
    report["disagg"] = disagg_phase(
        ht, dev, SEED, NEW_TOKENS, smi, report["serve"]["tokens_per_s"],
        report["proc_fleet"])
    # ---- phase 19: checkpoint and resume of Llama_1B training ----
    report["ckpt"] = ckpt_phase(ht, dev, smi)
    # ---- phase 20: online learning, trainer -> weight stream -> fleet ----
    report["stream"] = stream_phase(ht, ce, attn, paged, dev, SEED,
                                    NEW_TOKENS, smi)
    # ---- phase 21: the serve soaks ----
    report["soak"] = soak_phase(paged, smi)
    # ---- phase 22: the collectives and the gradient path ----
    report["collectives"] = collectives_phase(ht, ce, dev, SEED,
                                              report["train"])
    # ---- phase 23: the async engine ----
    report["engine"] = engine_phase(ht, ce, attn, dev, SEED)
    eng_lm = report["engine"]["llama_1b"]["hooks"]["launches"]
    eng_rn = report["engine"]["resnet50"]
    # ---- phase 24: the image models at full width ----
    report["vision"] = vision_phase(ht, ce, attn, dev, SEED)
    vis = report["vision"]

    dec = report["decode_time"]
    kernels = [{
        "name": paged.KERNEL_NAME, "route": "cuda",
        "source": paged.KERNEL_SOURCE, "replaces": paged.KERNEL_REPLACES,
        "launches": report["serve"]["launches"],
        # each main path that runs K1, its counts from 0 around it
        "launches_by_path": {"serve": report["serve"]["launches"],
                             "serve_spec": report["serve_spec"]["launches"],
                             "kvtier": report["kvtier"]["launches"],
                             "fleet": report["fleet"]["launches"],
                             "proc_fleet": report["proc_fleet"]["launches"],
                             "disagg": report["disagg"]["launches"],
                             "stream": report["stream"]["launches"],
                             "stream_comparison": report["stream"][
                                 "comparison"]["k1_launches"],
                             "soak": report["soak"]["launches"]},
        # phase 16's by replica: one launch a layer a replay
        "launches_by_replica": {
            str(i): r["k1_launches"]
            for i, r in enumerate(report["fleet"]["replicas"])},
        # phase 17's by worker process (replica, generation), read from
        # each worker's healthz
        "launches_by_worker": {
            k: w["k1_launches"]
            for k, w in report["proc_fleet"]["workers"].items()},
        # phase 18's by worker process of the two pools
        "launches_by_disagg_worker": {
            k: w["k1_launches"]
            for k, w in report["disagg"]["workers"].items()},
        "max_abs_err": max(c["max_abs_err"] for c in report["checks"]
                           if c["dtype"] == "bfloat16"
                           and "max_abs_err" in c),
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"],
        "design": "decode (T*G <= 16): split-KV over ranges of whole pages, "
                  "one block per (range, kv head, row), 64-key tiles in a "
                  "2-stage cp.async ring, bf16 products on mma.sync "
                  "m16n8k16, then a combine launch that merges the ranges "
                  "in fixed order (no atomics); prefill: 64 query rows x "
                  "64-key tiles through the block table, mma.sync in bf16, "
                  "causal tiles skipped"}]
    # K1 above head dim 128, on phase 2's D-256 serves: the bf16 decode
    # and prefill designs at DS 256, then the fp32 wide design
    ws, wd = report["wide_serve"], report["decode_d256_time"]
    wide_k1 = [c for c in report["checks"]
               if c.get("D", D) > 128 and "max_abs_err" in c]
    kernels.append({
        "name": paged.KERNEL_NAME + "_d256", "route": "cuda",
        "source": paged.KERNEL_SOURCE, "replaces": paged.KERNEL_REPLACES,
        "launches": ws["bfloat16"]["launches"],
        "launches_by_design": ws["bfloat16"]["launches_by_design"],
        "max_abs_err": max(c["max_abs_err"] for c in wide_k1
                           if c["dtype"] == "bfloat16"),
        "ms": wd["ms"], "plain_ms": wd["plain_ms"],
        "bound_ms": wd["bound_ms"], "bound_by": wd["bound_by"],
        "library_ms": wd["library_ms"],
        "times_ms": {n: {k: report[f"{n}_d256_time"][k]
                         for k in ("ms", "graph_ms", "library_graph_ms")}
                     for n in ("decode", "verify", "prefill")},
        "design": "bf16, head dims 136-512: the decode design (split-KV "
                  "over ranges of at least 64 keys, 16-row tiles of up to "
                  "64 rows, so the verify step too) and the prefill "
                  "design at a stored width of 256: mma.sync m16n8k16 "
                  "fed by ldmatrix, a 1-stage cp.async ring (3 and 2 "
                  "blocks an SM), a row's pool offset worked out once a "
                  "copy pass; above 256 the output's columns in two parts "
                  "over the grid"})
    wf = report["decode_d256_f32_time"]
    kernels.append({
        "name": paged.WIDE_NAME, "route": "cuda",
        "source": paged.KERNEL_SOURCE, "replaces": paged.KERNEL_REPLACES,
        "launches": ws["float32"]["launches"],
        "launches_by_design": ws["float32"]["launches_by_design"],
        "max_abs_err": max(c["max_abs_err"] for c in wide_k1
                           if c["dtype"] == "float32"),
        "ms": wf["ms"], "plain_ms": wf["plain_ms"],
        "bound_ms": wf["bound_ms"], "bound_by": wf["bound_by"],
        "library_ms": wf["library_ms"],
        "design": "fp32, head dims 136-512, every T: 16 query rows x one "
                  "range of whole pages x one 256-column part a block, 32 "
                  "keys a pass staged through the block table, scores and "
                  "P.V on the CUDA cores, partials merged by the decode "
                  "design's combine launch"})
    head = report["ce_time"][0]               # the phase-6 shape
    ce_designs = {
        "fwd": "one launch a loss: int32 or int64 labels read in place; a "
               "warp a row (8 rows a block) up to V 2048, a block a row "
               "above, eight fp32 or one bf16 16-byte load in flight a "
               "thread, a running "
               "(max, sum of exp) per thread; writes lse and the mean loss "
               "(block partials summed in a fixed order by the block that "
               "takes the last ticket: no float atomics)",
        "bwd": "one launch a loss: the mean's cotangent read from device "
               "memory, dlogits = (exp(x - lse) - onehot) g / T written in "
               "the logits' dtype, 16-byte loads and stores, four in "
               "flight a thread"}
    for d, name, replaces in (("fwd", ce.FWD_NAME, ce.FWD_REPLACES),
                              ("bwd", ce.BWD_NAME, ce.BWD_REPLACES)):
        kernels.append({
            "name": name, "route": "cuda", "source": ce.KERNEL_SOURCE,
            "replaces": replaces,
            "launches": report["train"][f"{d}_launches"],
            "launches_by_path": {
                "train": report["train"][f"{d}_launches"],
                "lm_train": report["lm_train_llama"]["launches"][
                    f"ce_{d}"],
                "ckpt": report["ckpt"]["launches"][f"ce_{d}"],
                "stream": report["stream"]["trainer"]["launches"][
                    f"ce_{d}"],
                "engine_train_llama": eng_lm[f"ce_{d}"],
                "engine_train_resnet": sum(
                    r[f"ce_{d}_launches"] for r in eng_rn.values()),
                **{f"vision_{n}": vis[n]["launches"][f"ce_{d}"]
                   for n in ("vit_b16", "vgg16", "inception3")}},
            "max_abs_err": max(
                max(c["loss_err"], c["lse_err"]) if d == "fwd"
                else c["dlogits_max_abs_err"]
                for c in report["ce_checks"] if "loss_err" in c),
            "ms": head[f"{d}_ms"], "plain_ms": head[f"{d}_plain_ms"],
            "bound_ms": head[f"{d}_bound_ms"],
            "bound_by": head[f"{d}_bound_by"],
            "library_ms": head[f"{d}_library_ms"],
            "design": ce_designs[d]})
    ft = report["flash_time"][0]              # the phase-9 shape
    vt = vis["flash_time"]                    # phase 24's ViT-B/16 shape
    bf16_checks = [c for c in report["flash_checks"]
                   if c.get("dtype") == "bfloat16" and c["D"] <= 128]
    plan = ft["dkv_plan"]
    designs = {
        "fwd": "64 query rows per block (one warpgroup), heaviest causal "
               "tiles first; the Q tile copied once, 128-key K/V tiles in "
               "a 2-stage cp.async ring, stored 128-byte swizzled; s = q "
               "k^T on wgmma m64n128k16 from shared memory, the online "
               "softmax on the accumulator in registers (masks on edge "
               "tiles only), o += p v on wgmma with p in registers; fp32 "
               "accumulation",
        "dq": "64 query rows per block (one warpgroup), heaviest causal "
              "tiles first; 64-key K/V tiles in a 2-stage cp.async ring, "
              "stored 128-byte swizzled; s = q k^T and dp = do v^T on "
              "wgmma m64n64k16 from shared memory, dq += ds k on wgmma "
              "with ds in registers; fp32 accumulation",
        "dkv": "64 keys per block (one warpgroup) over one piece: the GQA "
               "group's heads and the query range split so no block walks "
               f"more than {attn.DKV_MAX_TILES} query tiles "
               f"({ft['dkv_pieces']} pieces of {plan[0]} head(s) at "
               "Llama_1B), heaviest key tiles first; Q/dO/lse/delta tiles "
               "in a 2-stage cp.async ring; s^T and dp^T on wgmma from "
               "shared memory, dv += p^T do and dk += ds^T q on wgmma with "
               f"p^T / ds^T in registers; fp32 partials "
               f"({ft['dkv_scratch_bytes']} bytes of torch.empty scratch) "
               "summed in piece order by a combine launch, no atomics"}
    for d, name, replaces, errs, lib in (
            ("fwd", attn.FWD_NAME, attn.FWD_REPLACES, ("o",), "sdpa_fwd"),
            ("dq", attn.DQ_NAME, attn.DQ_REPLACES, ("dq",), "sdpa_bwd"),
            ("dkv", attn.DKV_NAME, attn.DKV_REPLACES, ("dk", "dv"),
             "sdpa_bwd")):
        kernels.append({
            "name": name, "route": "cuda", "source": attn.KERNEL_SOURCE,
            "replaces": replaces,
            "launches": report["lm_train_llama"]["launches"][d],
            "launches_by_path": {
                "lm_train": report["lm_train_llama"]["launches"][d],
                "ckpt": report["ckpt"]["launches"][d],
                "stream": report["stream"]["trainer"]["launches"][d],
                "engine_train": eng_lm[d],
                "vision_vit_b16": vis["vit_b16"]["launches"][d]},
            "max_abs_err": max(c["errors"][e]["max_abs_err"]
                               for c in bf16_checks for e in errs),
            "ms": ft[f"{d}_ms"], "plain_ms": ft[f"{d}_plain_ms"],
            "bound_ms": ft[f"{d}_bound_ms"], "bound_by": ft[f"{d}_bound_by"],
            "library_ms": ft[f"{lib}_ms"], "design": designs[d],
            # phase 24's shape: ViT-B/16's attention, non-causal
            "vit_b16": {x: vt[f"{d}{y}"] for x, y in (
                ("ms", "_ms"), ("graph_ms", "_graph_ms"),
                ("plain_ms", "_plain_ms"), ("bound_ms", "_bound_ms"),
                ("bound_by", "_bound_by"))} | {
                "library_ms": vt[f"{lib}_ms"],
                "max_abs_err": max(vis["flash_check"]["errors"][e][
                    "max_abs_err"] for e in errs)}})
    # head dims above 128, on phase 8's D-256 LM (bf16) and its fp32 step
    # held to the plain path
    fw = report["flash_time"][-1]             # Gemma-2B's attention
    ff = report["flash_wide_time"][0]         # the same in fp32
    lw, pw = report["lm_train_wide"], report["lm_parity_wide"]
    wide_designs = {
        "fwd_d256": "bf16, head dims 136-512: the wgmma design at a stored "
                    "width of 256: two warpgroups of 64 query rows share "
                    "each 64-key K/V tile of a 2-stage cp.async ring (192 "
                    "KB, one block an SM), s on m64n64k16, o += p v as two "
                    "m64n128k16 products; above 256 the output's columns "
                    "in two parts over the grid (one warpgroup, one stage)",
        "dq_d256": "bf16, head dims 136-256: the wgmma design at a stored "
                   "width of 256: two warpgroups of 64 query rows share "
                   "each 32-key K/V stage (K and V the two halves of one "
                   "swizzled 64-row tile) of a 2-stage cp.async ring (192 "
                   "KB, one block an SM), s and dp on m64n32k16, dq += ds "
                   "k as two m64n128k16 products a k step with ds in "
                   "registers",
        "dkv_d256": "bf16, head dims 136-256: the wgmma design at a stored "
                    "width of 256, in pieces with the fixed-order combine: "
                    "two warpgroups on the same 64 keys, warpgroup 0 "
                    "s^T = k q^T and p^T, warpgroup 1 dp^T = v do^T and "
                    "ds^T, exchanged through 24 KB of shared memory; each "
                    "accumulates dk and dv for its 128 columns on "
                    "m64n128k16 (218 KB, one block an SM)",
        "fwd": "fp32, head dims 136-512: 16 query rows a block, 32-key K/V "
               "tiles staged as fp32, scores on the CUDA cores (a half warp "
               "a row, online softmax by shuffles), o in registers a column "
               "a thread; above 256 in two column parts",
        "dq": "fp32 at head dims 136-512, bf16 at 264-512: 16 query rows a "
              "block, 32-key K/V tiles staged as fp32, s and dp on the CUDA "
              "cores, dq in registers a column a thread; above 256 in two "
              "column parts",
        "dkv": "fp32 at head dims 136-512, bf16 at 264-512: 16 keys a block "
               "over the whole GQA group and every query (no pieces, no "
               "scratch), 32-query Q/dO tiles staged as fp32, dk and dv in "
               "registers a column a thread; above 256 in two column parts"}
    for d, name, replaces, errs, t, dt, runs in (
            ("fwd_d256", attn.FWD_NAME + "_d256", attn.FWD_REPLACES, ("o",),
             fw, "bfloat16", lw),
            ("dq_d256", attn.DQ_NAME + "_d256", attn.DQ_REPLACES, ("dq",),
             fw, "bfloat16", lw),
            ("dkv_d256", attn.DKV_NAME + "_d256", attn.DKV_REPLACES,
             ("dk", "dv"), fw, "bfloat16", lw),
            ("fwd", attn.WIDE_NAMES["fwd"], attn.FWD_REPLACES, ("o",), ff,
             "float32", pw),
            ("dq", attn.WIDE_NAMES["dq"], attn.DQ_REPLACES, ("dq",), ff,
             "float32", pw),
            ("dkv", attn.WIDE_NAMES["dkv"], attn.DKV_REPLACES, ("dk", "dv"),
             ff, "float32", pw)):
        k = d.split("_")[0]
        design = attn.design_of(k, getattr(torch, dt), 256)
        # every check above 128 that ran this design
        ran = [c for c in report["flash_checks"]
               if isinstance(c.get("errors"), dict) and "dtype" in c
               and c["D"] > 128 and attn.design_of(
                   k, getattr(torch, c["dtype"]),
                   attn.padded_dim(c["D"])) == design]
        lib = "sdpa_fwd" if k == "fwd" else "sdpa_bwd"
        kernels.append({
            "name": name, "route": "cuda",
            "source": attn.KERNEL_SOURCE, "replaces": replaces,
            "launches": runs["launches_by_design"].get(f"{design}/{dt}", 0),
            "launches_by_design": runs["launches_by_design"],
            "max_abs_err": max(c["errors"][e]["max_abs_err"]
                               for c in ran for e in errs),
            "ms": t[f"{k}_ms"], "plain_ms": t[f"{k}_plain_ms"],
            "bound_ms": t[f"{k}_bound_ms"], "bound_by": t[f"{k}_bound_by"],
            "library_ms": t[f"{lib}_ms"], "design": wide_designs[d]})
    # every kernel of a main path ran there
    idle = [kn["name"] for kn in kernels if not kn["launches"]]
    if idle:
        raise SystemExit(f"kernels with no launch on their main path: "
                         f"{idle}")
    report.update(kernels=kernels, nvidia_smi=smi)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
