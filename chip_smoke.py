#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py                # every phase
    python3 chip_smoke.py --phase 24     # the build, then phase 24 alone

``--phase`` takes the phases whose inputs are their own (16-19, 21-28;
repeatable; phase 16 alone loads phase 7's engine as its A); the others
run only in the whole script. A guard thread stops
the run (exit 3) if the host's available memory falls below
HOST_FLOOR_GIB.

Phases (each prints its own lines; any failure raises and the exit code is
non-zero):

1. device — requires CUDA; prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   gives them;
2. build — compiles the port's CUDA kernels from
   ``distributed_gpu_inference_torch/csrc`` with nvcc (one process per
   source, and per geometry variant of the quantized matmul that phase 9
   sweeps, all in parallel) and prints the build seconds and ptxas'
   resource lines;
3. kernel parity at llama3-8b widths (Nh 32, Hkv 8, D 128, Bk 16, bf16):
   each kernel against its plain PyTorch version on the card;
4. serving — ``TorchLLMEngine`` for llama3-8b at full depth in bf16 with
   seeded random weights serves 8 concurrent requests (plus one prefix-
   cache hit) through ``BatcherServing``; the kernels' launch counters are
   zeroed just before and read just after; then one full-width
   ``forward_chunk`` prefill and decode step run through the kernels and
   through the plain versions and their logits are compared;
5. times — each kernel at the serving shapes (CUDA events, median of 30
   calls, L2 flushed before each; and the same call replayed as a captured
   CUDA graph, device time without the host's launch gap — capture also
   proves the wrapper never synchronises), its bound on the card and its
   share of it, its plain version and ``scaled_dot_product_attention`` on
   the same context gathered contiguous (a yardstick only; the port never
   calls it), timed both ways too; the fused decode kernel also as a CUDA
   graph with 64, 128, 256 and 512 keys a split, its plan's size marked.

Quantized serving (int8 / fp8 weights through the W8A16 kernel, int8 / fp8
KV pools through both attention kernels):

6. quantized parity at llama3-8b widths — the quantized matmul (int8 and
   fp8 codes) at every projection shape at M in {1, 8, 40} and at the row
   bound, all 32 layers' indexing on one shape; the ragged and fused
   kernels over int8 and fp8 pools, with code and scale pools
   bit-identical after the fused write and the negative control on the
   int8 paths;
7. int8 serving — ``TorchLLMEngine`` loads llama3-8b (full depth) with
   ``quantization="int8"`` and ``kv_cache_dtype="int8"`` and serves the
   same 8 requests plus the prefix hit; the launch counters of all three
   kernels are zeroed just before and read just after; one prefill and one
   decode step through the kernels against the plain versions; the share
   of greedy tokens that match the bf16 run (information);
8. fp8 serving — the engine with fp8 weights and fp8 pools at llama3-8b
   width, depth cut to 4 layers, generates for 4 requests (counters zeroed
   before, read after);
9. times — the quantized matmul for one layer's seven projections at M = 8
   against its plain version and ``torch.matmul`` on the pre-dequantized
   bf16 weights; each projection call by call and as a CUDA graph with its
   share of the bound; the seven twice (bitwise equal) and replayed from a
   graph (bitwise equal to the eager calls); the seven as a graph at each
   ring depth x stage height of QMM_SWEEP (the build's marked); the kernel
   against the library route at M in {8, ..., 256}, which sets the
   dispatch bound; the int8 and fp8 attention variants timed as in phase
   5.

10. long shapes at llama3-8b widths with 4096-key rows (block tables of
    width 256), for bf16, int8 and fp8 pools: a ragged 8 x 256 round (2
    chunk rows at positions 3840-4095, 6 decode rows) and a decode step of
    8 active rows, each held to its plain version with the phase-3/6
    tolerances, two calls bitwise equal, the fused write's code and scale
    pools bit-identical to the plain write; then both kernels timed as in
    phase 5.

The serving surface (the worker's direct mode):

11. direct server — phase 7's int8 engine, before it is unloaded, behind
    ``worker/direct_server.py`` ``DirectServer`` on 127.0.0.1 with a small
    worker object (shared serving claims up to 8, a checkpoint store for
    ``adopt_stream_checkpoint``); all HTTP through ``http.client`` with
    socket timeouts. 8 concurrent ``POST /inference/stream`` of 32 greedy
    tokens (offsets 1..32, ids in vocabulary, text = the tokenizer's decode
    of the ids, usage); a lone stream and the same request through
    ``POST /inference`` give the same ids; a 256-token stream whose client
    hangs up after 4 events is cancelled (batcher ``cancelled`` + 1, no
    slot left); a hedged 512-token ``/inference`` cancelled through
    ``/inference/cancel`` ends in ``abort``; a 256-token stream dropped
    after 8 events resumes at offset 8 from the admission checkpoint the
    engine pushed and splices to exactly the ids and text of the undropped
    run (a resume is a ragged admission, so it computes what the first
    admission computed); resumed from the latest pushed checkpoint (k
    tokens) it splices to the same checkpoint resumed with no drop and
    equals the undropped run over the k tokens, and where it later parts
    from the undropped run the script prints both runs' top-2 logits at
    that step (the k tokens' KV was computed by decode steps in one run and
    by a prefill chunk in the other). The launch counters are zeroed before
    and read after: all three kernels launched. The streams' TTFT and
    inter-event times as the client sees them are information;
12. small head dims — both attention kernels at ``llama3-mini``'s head
    shape (Nh 8, Hkv 4, D 32) against their plain versions with the
    phase-3 tolerances, then ``TorchLLMEngine`` with its default
    ``llama3-mini`` serves 4 requests of 16 tokens through both kernels
    (counters zeroed before, read after), then both kernels timed at that
    head shape on phase 5's round and decode step, as phase 5 times them
    (``@d32`` entries).

The worker process:

13. worker — ``worker/cli.py`` ``cmd_start`` on a thread starts worker A
    from a ``config.yaml`` in a temp dir, the JAX worker's YAML, written by
    the port's ``save_worker_config`` (``engines.llm``: llama3-8b with int8
    weights and the default bf16 KV pool; the direct server on port 0;
    polls every 0.05 s, heartbeats every 0.5 s; 8 concurrent jobs) against
    :class:`StandInPlane`, the plane's worker routes on ``http.server``
    (HMAC-checked, epoch-fenced). It registers with a topology naming the
    card, and the credentials it writes back to the YAML file read back
    equal to its own; one direct ``POST /inference/stream`` and the 8 serving prompts
    as polled jobs of 32 greedy tokens complete (ids in vocabulary, text =
    decode(ids), usage right); a ``serving.target_step_ms`` pushed through
    the plane's config reaches the live batcher; a 256-token job is
    drained once a heartbeat checkpoint holds 8 tokens
    (``request_shutdown``): it migrates with its checkpoint, worker A goes
    offline, unloads and hands the card's memory back; its heartbeats
    carried the batcher's ``capacity``, a prefix summary, a job checkpoint
    and more than one active slot. Worker B, started from the same file,
    keeps the worker id through the persisted credentials, claims the
    requeued job and completes it with the checkpoint's tokens first; where
    it parts from an undropped run of the same job the script prints both
    runs' top-2 logits. Counters zeroed before, read after: all three
    kernels launched. Job latency from queue to completion and the
    heartbeat round trip are information.

Serving under pressure:

14. spill tiers, fault seams, deadlines and the flight recorder — for the
    default bf16 KV pool and then the int8 pool, ``TorchLLMEngine`` loads
    llama3-8b (full depth, int8 weights) with a budget of 64 blocks, an L2
    tier (``kv_spill_host_blocks``) and an L3 tier
    (``kv_remote_url=redis://127.0.0.1:<port>``) against
    :class:`RespStandIn`, a RESP store on loopback. (a) Prompt A (192
    tokens) is served, then again: the L1-hit reference. (b) Fillers evict
    A: ``spills`` rises, and every batched download equals the pool page it
    came from, bit for bit. (c) A is served from L2: its 11 restorable
    blocks come back, the restored pool pages equal the spilled ones bit
    for bit, and the greedy stream equals the reference. (d) The same from
    L3 over RESP, with L1 and L2 cleared. (e) One L3 entry corrupted: it is
    quarantined (and deleted), and A is recomputed to the cold run's
    stream. (f) With an ``io.spill.host.put`` fault plan the host breaker
    trips, serving completes, and the worker's ``kv_spill`` heartbeat block
    reports both. (g) ``serving.abandon_deadlines`` pushed live; of 8
    concurrent requests one has a deadline it cannot meet: it ends with the
    typed ``deadline_abandoned`` error, ``abandoned`` is 1, the other seven
    finish their 32 tokens in vocabulary, and the reclaimable block count
    returns to its value before. Counters zeroed before, read after: all
    three kernels launched. Information: the batched download and upload
    of one page and of A's 11 pages (CUDA events around the call, median
    of 30) against 64 GB/s. (h) Phase 13's polled jobs carried a ``trace_id``: each result's
    timeline has the batcher's events in causal order, and the plane's
    heartbeats carried ``engine_stats["flight"]``.

Speculative decoding:

15. speculative decoding — ``TorchLLMEngine`` loads llama3-8b (full depth,
    int8 weights) with ``speculative_decode: true`` (K = 4, a random draft
    head) beside the same engine without speculation on the same weights,
    first with the bf16 KV pool, then with the int8 pool; each serves the 8
    serving prompts as greedy requests of 32 tokens in one
    ``batch_inference`` call, counters zeroed before and read after. (a)
    Both engines run under one :class:`SampleTrace`, which keeps the top-8
    logits of every row each sample took: every token of the run without
    speculation was recorded and is its argmax; where a speculating stream
    parts from that run, the first parting token is judged in the logits a
    run sampled there — the other token must lie less than 0.05 below the
    argmax (a near-tie; each printed) — and a runner-up planted where a
    recorded top-2 gap is widest must be rejected. (Until PR 16 this check
    held the tokens to one teacher-forced re-score, which runs other
    kernels and chunks and once put a correct token 0.0398 below its
    argmax.) (b) After the requests the allocator's free and
    cached counts, radix nodes, refcounts and each sequence's cached prefix
    equal the never-speculated engine's. (c) The ragged kernel ran the
    verify rows (K+1 queries), the quantized matmul's kernel served M =
    8·(K+1) = 40 rows and its library route never did, the fused decode
    kernel never launched, ``spec_tokens_per_step`` >= 1. (d) is (a)-(c)
    with the int8 pool. (e) Oracle rates 0, 0.5 and 1.0 on the live engine
    (``set_spec_oracle``), 8 requests of 64 tokens with ``ignore_eos``:
    ``spec_tokens_per_step`` within 0.25 of 1 + rate·K; tok/s beside the
    engine without speculation (information). (f) CUDA-event medians of 10
    at batch 8 over the serving contexts: the draft chain, the verify pass,
    one plain decode step and ``project_logits`` alone. (g) ``engine:
    jax-speculative`` with widths (4, 2, 2): two short greedy prompts ride
    one spec wave of the batcher; (a) on their streams against the same
    weights served without speculation, the decoder's stats, and the plain
    tree verify timed. (h) The worker's
    ``_spec_engine_stats`` heartbeat block equals the engine's counters.
    Then the ragged kernel on the verify round (8 x 5 queries, bf16 and
    int8 pools) and the quantized matmul's seven projections at M = 40 are
    held to their plain versions and timed as phases 5 and 9 time them
    (``@verify`` and ``@m40`` entries).

Prefill/decode disaggregation:

16. PD — twice, with int8 pools (A is phase 7's engine, after phase 11)
    and with bf16 pools (A loads llama3-8b with int8 weights): engine B, the
    same model and weights (seed 0), behind the port's ``DataPlaneServer``
    on 127.0.0.1 (A runs one too); both prefill in chunks of at most 256
    tokens. (a) The 600-token prompt through ``pd_stage: prefill`` on A
    pushed one-shot and streamed to B, then ``pd_stage: decode`` on B: B's
    adopted pages and scales, read back with ``pull_pages``, bit-identical
    to the wire, and the greedy ids equal to A alone (A's local-affinity
    prefill and decode). (b) A serves the 8 serving prompts itself (its
    hybrid run), then they go PD, streamed (pieces of 4 blocks) and
    one-shot: prefills one after another on A with no cached block, then
    all 8 decode together on B; every PD stream equals A's exactly (the
    same prefill arithmetic: a one-shot prefill of a prompt within one
    chunk runs one row, as a streamed chunk does; where one parts, both
    runs' top-2 logits are printed, and the check fails after the TTFT
    line); the streamed run is also judged in the logits each run sampled
    (``check_sampled``: a fork a near-tie there, a runner-up planted in a
    stream rejected); pushes of prompts past one chunk
    sent bytes before the first token. (c) ``migrate_kv_device`` A → B:
    pages and scales bit-identical, continued on B equal to A alone; a
    one-layer engine with another KV dtype, and one on the CPU, are
    refused. (d) B holds the shared 128-token prefix and pulls the rest of
    a prompt hot on A through A's ``/kv/export`` (a router hint): only the
    18 missing blocks ship, bit-identical to A's, and B serves it with 416
    tokens cached. (e) Port fault plans: a piece truncated at
    ``kv.receiver.message`` aborts the session (B's reclaimable blocks
    unchanged), a dropped piece push at ``worker.pd.push`` is retried
    (``piece_retries`` + 1), an injected 409 is not. (f) (bf16 pass) Worker
    B through ``cmd_start`` with ``role: decode`` and a
    ``pd_data_plane_url`` against :class:`StandInPlane` registers both, A
    pushes to its data plane, the decode-stage job ``server/pd_flow.py``
    writes completes as a polled job, and a push losing every piece shows
    in its heartbeat ``pd`` block. Counters zeroed before, read after: all
    three kernels launched; A launched the ragged kernel and qmm, B the
    fused decode kernel and qmm (the split printed). Information: bytes,
    export / adopt ms against 64 GB/s, serialize / push / deserialize ms,
    the device-path migrate against two HBM passes, TTFT, and the pull
    against a recompute.

Weights and tokenizer from local files:

17. local files — (a) a llama3-8b checkpoint at full width and depth in
    bf16 and HF's layout (HF names, ``[out, in]``, four shard files, an
    index and a config.json), each tensor drawn from a seeded
    ``torch.Generator`` on the card, written with :func:`write_safetensors`
    (the card's machine has no ``safetensors``) into a temp directory
    after a check of the free space; beside it a Llama 3-style
    ``tokenizer.json`` (the split regex, the 256 ByteLevel symbols, 2048
    merges learned from README.md, the vocab filled to 128000, the special
    tokens from 128000, a BOS template, ``clean_up_tokenization_spaces``)
    and a chat template. (b) ``TorchLLMEngine`` loads it with
    ``checkpoint_path``, ``tokenizer_id``, int8 weights and int8 pools: the
    load's seconds and GB/s of file bytes, and the peak device memory
    before the KV pools against the int8 tree. (c) Every written tensor,
    drawn again, is bit-identical to its place in the loaded tree (codes
    and scales against ``quantize_params``), and so is a bf16 load of the
    directory. (d) Eight requests (six texts, two chats) of 32 greedy
    tokens, one at a time with the prefix cache off, through ``inference``
    and ``stream_inference``: the ids equal those of an engine given the
    bf16 tree as ``params=``, the stream's ids equal ``inference``'s and
    its text is the tokenizer's decode of them; counters zeroed before and
    read after: all three kernels launched. Host encode and decode times
    are information. The directory is deleted at the end.

The fleet harness:

18. fleet — ``testing/harness.py`` ``LiveFleet`` with two ``FleetWorker``s
    (each a ``Worker`` with a ``TorchLLMEngine`` for llama3-8b at full
    width and depth, int8 weights, the default bf16 pool, its
    ``DirectServer`` and heartbeat / poll threads; 8 shared claims each)
    against :class:`StandInPlane` with a heartbeat timeout of 2 s. The 8
    serving prompts twice, 32 greedy tokens each: every third request a
    direct stream read with ``http.client`` from member 0, the rest
    polled jobs. Once member 0 holds its streams' first tokens and a job,
    a ``FleetFaultPlan`` with explicit events runs: member 0 is killed
    (connections cut, engine unloaded); 1 s in, member 1 stalls for 3 s,
    longer than the timeout (no heartbeats and no engine rounds, as a
    paused host; its polls go on, so it may claim member 0's requeued
    jobs before its own sweep); 4.5 s in, member 0 restarts. The sweep
    takes member 1 offline and requeues its stalled jobs; when the stall
    ends their runs finish as zombie work and post completions the plane
    must fence, and only then do member 1's heartbeats return. Checks:
    every job completes exactly once; member 1's stalled jobs were swept
    and at least one of its stale completions was fenced; every stream,
    resumed at its last offset on member 1,
    ends with ``done`` and offsets 1..32; ids in vocabulary and text =
    decode(ids); each run resumed from a checkpoint starts with its
    tokens; after the kill the card's memory falls back to one engine's
    level (+ 512 MiB) before the restart; the restarted member keeps its
    worker id and serves a direct request; where an output parts from a
    calm replay of the 8 prompts (a resume recomputes its checkpoint's
    tokens as a prefill chunk and the batches differ), it parts at a
    near-tie: in the logits of at least one run that chose either token
    there, as the engines sampled them, the other token lies less than
    0.05 below the argmax (phase 16's "either run's own logits"; every
    run's deficit is printed). One run's logits are a noisy judge: on an
    H100 two runs at one fork put the same two tokens 0.0551 apart in one
    and reversed in the other, and a teacher-forced re-score (other kernels
    and chunks) put a correct run's own tokens up to 0.0398 below its
    argmax, so none is run.
    A stream resumed past its last pushed checkpoint splices two runs
    where its new run re-generated a delivered token otherwise (ROADMAP §3
    item 3): each stretch between resumes is then held to the calm replay
    as the run that sampled it.
    Each token a run sampled is the argmax of the logits recorded for it,
    and none is missing; all three
    kernels launched (counters zeroed before the phase, read after the
    calm replay).
    Information: kill → requeue seconds, requeue → first token on the
    member that resumed the job (member 1 once its stall ends, or the
    restarted member 0), the restart's cold start, the kill's offset from
    the start of the traffic, job latency from queue to completion, and
    the ms a token of the resumed jobs against the calm replay's.

Mixtral MoE:

19. mixtral-8x7b — the card is freed of every earlier engine; a bf16
    mixtral-8x7b (93.4 GB) is refused at load with its size and nothing
    allocated. ``TorchLLMEngine`` loads it at full width and depth (32
    layers, 8 experts top-2, hidden 4096, intermediate 14336, vocab 32000)
    with ``quantization: int8``, seed 0, the default bf16 pool,
    ``max_batch_size`` 8 and a Mixtral-style tokenizer written to a temp
    directory (:func:`write_mixtral_tokenizer`: byte-fallback BPE, vocab
    32000, 2048 merges from README.md, ``<s>`` / ``</s>``): the streamed
    init (``models/loader.py`` ``init_route``), its seconds, the tree's
    bytes against ``param_bytes(1)``, and the load's peak device memory
    within the int8 tree, one f32 ``[E, H, I]`` slice and 512 MiB. (a)
    One layer's ``_moe_mlp`` at M = 8 and 256 through the kernels (qmm; the
    library route above its row bound) against the plain route
    (``qmm_plain`` for every expert): the router's top-k identical, the
    outputs within MOE_ATOL, RTOL and VEC_REL, and row 0 with its first
    routed expert's term dropped rejected. (b) The 8 serving prompts and
    the prefix hit, 32 greedy tokens each, through ``BatcherServing``:
    counters zeroed before and read after (all three kernels launched),
    ids in vocabulary, text = the tokenizer's decode of the ids; the rows
    each expert received (information). (c) ``compare_forward``, and every
    committed token against a teacher-forced re-score routed as served:
    wherever the re-score's argmax differs, the fork is judged as phase 18
    judges one between two runs: the other token must lie less than 0.05
    below the argmax in the served logits (recorded by :class:`SampleTrace`
    while serving) or in the re-score's own, and a runner-up planted at the
    widest recorded gap is rejected; so is one more request served with the
    keys of its first KV page written one position off from their values
    in every layer (``served_with_kv_fault``): some fork from its own re-score lies 0.05
    or more below in both views. A router decision flips where
    two runs' rounding straddles a near-tie of router probabilities, and a
    flipped expert moves a token's logits by a discrete step, so the
    second run of each comparison routes every token as the first did
    (:class:`RoutePins`; the plain pass as the kernel pass, the re-score
    as the serving) and the flips its own router would have made are
    printed. (d) Times (information): one MoE layer at M = 8 call by call
    and as a CUDA graph against its byte bound and against the layer on
    pre-dequantized bf16 experts; a full decode step at batch 8 (device
    and host enqueue) and one 2,048-row prefill round; qmm at the three
    expert shapes (``@moe-we_gate``, ``@moe-we_up``, ``@moe-we_down``
    entries).

20. distillation and the non-LLM engines — after mixtral is freed. (a)
    ``TorchLLMEngine`` llama3-8b, int8 weights and a bf16 pool, speculating
    with K = 4 as phase 15, loads with ``spec_distill_steps: 400``: the
    distillation's seconds and first and last losses (information); the
    loss falls (mean of the last 10 steps under the first 10's); on the
    first batch of its own streams the distilled head's feature MSE is
    under 0.8x that of phase 15's random head, and on held-out random
    streams it is printed (information: 4,032 training positions are fewer
    than the head's fused input width 2H = 8,192, so the fit does not
    carry to streams it never saw; ``tests/distill_witness.py`` shows the
    JAX function and the port alike gaining nothing held-out at fewer
    positions than 2H, at either vocabulary). The bound of the JAX test
    ``test_distilled_draft_beats_random`` (held-out under 0.8x random) is
    gated on ``llama3-mini`` (2H = 512), distilled the same way through
    ``TorchLLMEngine`` on the card. The 8 prompts, 32 greedy tokens
    each in one admission: phase 15's check (c) (verify rows through the
    ragged kernel, qmm's kernel at M = 40, no fused decode, which a
    speculating engine never runs), its accept rate and tokens per step
    beside phase 15's random head (information), and phase 15's check (a)
    against the same weights served without speculation (whose decode
    steps launch the fused kernel, counted with (a)); then the 8 prompts
    and the prefix hit through ``BatcherServing`` (counters zeroed before
    and read after: ragged and qmm launched). (b) ``EmbeddingEngine``
    llama3-8b in bf16 embeds the 8 prompts in one call (counters zeroed
    before and read after: ragged launched; ``kv_lens`` zero as in the JAX
    engine, so every query sees no key); each row against the plain
    versions' (``plain_kernels``) within EMBED_COS_BOUND of cosine 1, unit
    norms, and one prompt alone against its row; the negative control, the
    plain versions with each row's tokens attending, must read more than
    EMBED_COS_BOUND from the kernels' rows. (c) ``VisionEngine``
    small-vit + llama3-1b (out_dim 2048 = hidden 2048), bf16 decoder: a
    224x224 ``pixels`` request and a PNG written by ``utils/png.py``, 32
    new tokens each (counters: ragged and fused decode launched), ids in
    vocabulary, the prefill logits through the kernels against the plain
    versions within LOGITS_REL_BOUND. (d) ``WhisperEngine`` small-whisper
    on 30 s of seeded audio, as 16-bit WAV and as the same samples in
    ``pcm_f32``: one transcript; the CTC logits on the card against the
    same weights on the CPU within WHISPER_REL_BOUND relative L2. (e)
    ``ImageGenEngine`` small-diffusion, 2 images, 20 steps, seed 0, twice:
    byte-identical PNGs, each decoding (``utils/png.py``) to 64x64x3. The
    milliseconds of a call of (b)-(e) are printed beside the card's name
    and power limit. Phase 20's launches are added to the bf16 ragged,
    fused decode and int8 qmm entries of the kernels line.

21. pipeline stages — after phase 20. (a) ``TorchEngine`` loads llama3-8b
    at full width, depth cut to PIPE_LAYERS (8 of 32, for the script's
    time), with int8 weights (one quantized tree, bf16 pools,
    one request at a time, the prompt lengths as its prefill buckets so a
    prompt prefills unpadded, as a stage does); ``uniform_stages(8, 2)``
    splits it into (0, 4) and (4, 8); two ``PipelineStageWorker`` s and
    a spare for (4, 8), bf16 pools of 64 blocks each, take
    ``slice_stage_params`` views of the engine's tree, each behind its own
    ``DataPlaneServer`` on 127.0.0.1: the allocated bytes before and after
    the stages (no more than their pools, + 1 MiB) and every stage leaf a
    view of the tree. (b) Four prompts of 40, 64, 88 and 120 seeded tokens,
    32 greedy tokens each, through ``DistributedInferenceSession
    .generate_greedy`` (counters zeroed just before) against the engine on
    the same prompts: streams identical, or parted at a near-tie (the
    other token less than NEAR_TIE below the argmax in the last stage's
    logits or in the engine's sampled logits, each printed); the last
    stage's prefill logits against the engine's (max abs err, printed).
    (d) Prompts 1 and 3 at once from two threads through the same stages:
    each stream equal to its solo run; and ``qmm_streams_check``: two
    threads on a CUDA stream each share the quantized matmul's scratch,
    every result bitwise the call's alone (its cross-stream order). (c) A
    session of prompt 0 whose stage-1 plane stops after 8 decode steps:
    the stream equal to (b)'s run token for token, one reroute to the
    spare, the chunks recorded at the kill replayed (the replay's ms
    printed); the launch counters are read here. (g) Information, with
    the card's name and power limit: the pipeline's and the engine's
    decode tokens/s, each hop's p50 / p95 ms split into the stage's
    forward and framing + HTTP, and the bytes each way a hop. (e) Every
    stage back to num_blocks - 1 free blocks after its sessions close (the
    stopped stage's orphan session closed in process); after the stages,
    planes and tree are freed, the allocated bytes back to their level
    before the phase within PIPE_MEM_SLACK. (f) ragged, fused decode and
    qmm launched in (b)-(d); the counts are added to the bf16 ragged,
    fused decode and int8 qmm entries of the kernels line.

Direct mode, sub-wave admission and the weight cache:

22. after phase 21, llama3-8b at full width and depth with int8 weights
    and int8 pools, random weights from seed 0, one tree shared by the
    phase's engines. (a) A ``TorchLLMEngine`` with ``serving: {mode:
    direct}`` (no batcher: the legacy ``generate`` path under the engine
    lock) serves the 8 serving prompts through ``inference``, 32 greedy
    tokens each, one at a time; a batcher-mode engine serves them as one
    batch; the two judged in the sampled logits as phase 15 (a) judges
    (both engines under one :class:`SampleTrace`). (b) Four direct-mode
    streams through ``DirectServer`` (exclusive claims, one at a time):
    client TTFT and inter-event p50 / p95 and a ``decode_step``'s ms; then
    prompt 0's 64-token stream, cut by its client after 12 events, resumes
    from its checkpoint on the batcher-mode engine's server, each stretch
    judged by the run that sampled it (``stream_stretches``) against the
    uncut stream. (c) A 64-token queued job on the direct engine,
    interrupted after 2 decode rounds: ``JobMigrated``, its checkpoint
    resumed by the batcher-mode engine, judged against an undisturbed run.
    (d) Batcher-mode engines with ``serving.ragged: false`` (the legacy
    wave admission through ``submit_batch``) at ``subwave`` 0, 2, and 2
    with ``interleave: 2`` (while an earlier request is already decoding):
    the 8 prompts as one wave, each request's TTFT and the wave's prefill
    calls printed; streams judged against ``subwave: 0`` with every
    prefill forward of the three on qmm's library route (the kernel serves
    up to the decode width, so decode steps still launch it); the earlier
    request advanced during the interleaved admission. (e) ``TorchEngine``
    loads llama3-8b int8 twice through ``EngineConfig.quant_cache_dir``
    in a temporary directory: built and written, then read (both load
    times, the file's bytes, the read's GB/s of a page-cache read plus the
    copy to the card); the trees bitwise equal, 4 greedy streams identical;
    the directory deleted. Each part's launches are counted (all three
    kernels) and added to the int8 entries of the kernels line.

Tensor and expert parallelism:

23. after phase 22, on ``torch.distributed`` with two ranks on cuda:0 (the
    engine-level ``rank_devices``; the worker's ``tp_size`` takes one card
    a rank). A probe first: two processes on the card, where NCCL refuses
    the shared device and gloo must all-reduce and broadcast CUDA tensors.
    (a) llama3-8b at full width, depth cut to TP_LAYERS (8 of 32, for the
    script's time), int8 weights and int8 pools,
    seed 0: the tp 1 engine and then the tp 2 engine (rank 1 a spawned
    process holding its shard) serve the 8 serving prompts, 32 greedy
    tokens each, through ``BatcherServing``, both under one
    :class:`SampleTrace`; the tp 2 streams judged against tp 1's as phase
    15 (a) judges (each fork a near-tie below NEAR_TIE, a planted runner-up
    rejected); both ranks' counters (zeroed before, gathered from rank 1
    after) show ragged and qmm launched and the fused decode kernel not (an
    int8 decode step under tensor parallelism writes through the
    max-reduced quantize and reads through the ragged kernel); tok/s, a
    decode step's ms at batch 8 and its all-reduces and broadcast (count
    and ms, rank 0) beside tp 1's; then one wave of the 8 prompts on each
    engine: both ranks' scale pools bitwise equal, layer 0's scales at
    every prompt position bitwise equal to tp 1's, and deeper layers'
    within TP_SCALE_ULP bf16 ulp of them (their share equal printed). (b) The same with bf16 pools: both ranks launch the
    fused decode kernel. (c) mixtral-8x7b int8 at tp 2 (EP: 4 of the 8
    experts a rank, and attention TP): at full depth both ranks' streamed
    inits at once, the card's memory in use and each rank's peak; then at
    TP_MOE_LAYERS layers, full width, bf16 pools, the 8 prompts through
    ``generate`` with the routing recorded on rank 0, replayed by the tp 1
    engine at the same depth (:class:`RoutePins`, the flips its own router
    would have made printed), the streams judged as in (a); all three
    kernels launched on both ranks. Then each kernel at one rank's shard
    shapes (Nh 16, Hkv 4; the projections' halves) against its plain
    version and timed as phases 5 and 9 time them (``@tp2`` entries). The
    phase's launches (both ranks) are added to the kernels line's int8
    and bf16 entries.

Sequence parallelism:

24. after phase 23, on the ``seq`` axis with two ranks on cuda:0
    (``TorchEngine(mesh=MeshPlan(seq=2))``, gloo). llama3-8b at full width
    and depth, int8 weights and int8 pools, seed 0, ``max_seq_len`` 8192,
    block 16; two long prompts of SEQ_LONG seeded ids (3x the 2048 prefill
    bucket) and six short ones, 32 greedy tokens each through
    ``generate``. The seq 1 engine serves them first (the reference), then
    (a) ring and (b) Ulysses over replicated pools (each long prompt ONE
    seq-parallel pass, rank 0 serving the rest alone) and (c)
    ``kv_seq_sharded`` pools (each rank 1/2 of the blocks, every rank
    running every forward, reads through the partial-softmax ops), which
    also serves a prefix-cache hit continued over two prefill chunks and
    one continued in one chunk (the seq 1 engine serves those prompts
    too). (d) (c)'s engine streams the first long prompt into a tp 2
    decode engine (``StreamedExport`` → ``HandoffReceiver``; the engine of
    a ``tp_size: 2`` worker in direct mode), then a PD request: prefilled
    on a ``tp_size: 2`` worker, pushed over a ``DataPlaneServer``, decoded
    on the other; then that prefill worker's L2 spill and restore (the
    restored pages gathered from both ranks bitwise equal to the spilled
    ones, the stream equal to the L1-hit reference). Every stream of
    (a)-(d) is judged against the seq 1 engine's in the logits each run
    sampled, as phase 23 judges; each pass prints its tok/s, the
    seq-parallel prefills' ms, TTFT, each rank's collectives (count and
    ms), peak memory and pool bytes (c: 1/2 of seq 1's a rank), and each
    rank's launches (checked: replicated pools launch all three kernels on
    rank 0 and none on rank 1; block-sharded pools launch qmm on both ranks
    and no attention kernel). Then the plain ring, Ulysses and
    partial-softmax ops timed on two ranks at the path's shapes. Then the
    three kernels at every shape the path gave them (:class:`PathShapes`
    records them in this process while (a)-(d) run: the seq engines' 512-
    wide tables, the tp 2 engines' heads) held to their plain versions on
    seeded pools of the engines' size with the recorded tables, positions
    and lengths; the seq engines' decode shape and the tp 2 decode
    engine's ragged round timed as phase 10 times (``@seq`` entries). The
    phase's launches (every rank) are added to the kernels line's int8
    entries. (c)'s extra prompts and (d)'s requests take SEQ_SIDE_TOKENS
    greedy tokens.

The whole deployment on the card's host:

25. after phase 24, the card freed of earlier engines. The port's control
    plane (``server/app.py``) runs as its own process, started through its
    CLI with ``--port 0`` (the banner names the bound port), its sqlite DB
    in a temp directory, a heartbeat timeout of DEPLOY_HB_TIMEOUT_S and a
    background sweep every DEPLOY_SWEEP_S. Two workers start through
    ``worker/cli.py`` ``cmd_start`` on threads, as phase 13's do (llama3-8b
    at full width and depth, int8 weights, the default bf16 pool, the
    direct server on port 0; each registers with a fingerprint of its own,
    as two workers in one process share the machine's). The port's SDK
    (``sdk/client.py``) submits 8 queued chats of 32 greedy tokens
    (``create_job`` -> ``wait_for_job``), one ``/jobs/sync`` chat and one
    ``stream_chat(use_direct=True)`` found through
    ``/jobs/direct/nearest``: ids in vocabulary, text = decode(ids), usage
    right. Then a 256-token job on worker A (B's polls held until A has
    it): once a heartbeat checkpoint of 8 tokens stands on the plane, A is
    hard-killed (its plane connections cut first, then its poll loop,
    direct server and engine); the plane's own sweep requeues the job, and
    B completes it with the checkpoint's tokens first. The store's rows
    (read from the sqlite file): every job completed with one usage
    record, the long job claimed twice (epoch 2), every other once. The
    plane's records: a job's ``/api/v1/debug/requests/{id}/timeline`` has
    the server's and the batcher's events; ``queue_stats`` and
    ``/metrics`` (``inference_requests_total``) count the 10 jobs queued
    and completed. Counters zeroed before the workers start and read after
    B stops: all three kernels launched (added to the bf16 ragged, fused
    decode and int8 qmm entries of the kernels line). Information, with
    the card's name and power limit: job latency from queue to completion
    p50 / p95, the heartbeat round trip p50 / p95, kill -> requeue and
    kill -> first resumed token seconds, the phase's seconds.

The native radix index, seq x model meshes, migration under TP and the
in-mesh stage pipeline:

26. after phase 25. llama3-8b at full width (hidden 4096, 32/8 heads,
    vocab 128256), int8 weights, MESH_LAYERS of its 32 layers, seed 0;
    every rank on cuda:0 over gloo. (a) The C++ radix index
    (``native/src/radix_index.cpp``, built with the system g++ into
    ``build/native/`` at first use): its library and source named; every
    engine of the whole run holds it (:class:`NativeIndexCheck`, installed
    before the first engine, fails the run on a Python fallback); a seeded
    parity fuzz against the Python index at block sizes 16, 4 and 1 (the
    interior-eviction refusal met); insert and match timed on phase 7's
    prompts (host times, the host's CPU named). (b) seq 2 x model 2, four
    ranks: a seq 1 x model 1 engine at the same depth serves a
    MESH_LONG-token prompt then a wave of four short ones (MESH_TOKENS
    greedy tokens each; prefill buckets up to 1024, so the long prompt
    takes one ring pass on the mesh); then the 2-D engine with
    ``kv_seq_sharded`` int8 pools (each rank 1/4 of each data pool and 1/2
    of each scale pool; every rank launches qmm and no attention kernel)
    and with replicated int8 pools (seq row 0 a tp 2 engine launching
    ragged and qmm, row 1 joining only the ring prefill) serve the same;
    their streams judged against the seq 1 x model 1 engine's with
    ``check_sampled``; each pass prints tok/s, TTFT, the ring prefill's ms,
    each rank's peak memory and pool bytes against seq 1 x model 1's, and
    the collectives (count, ms) of the group over every rank and of each
    rank's ``model`` and ``seq`` sub-groups. (c) bf16 pools: a tp 2 engine
    exports a MIGRATE_PREFIX-token prefix (``export_prefix_frames``) to a
    one-device engine's ``HandoffReceiver`` and the one-device engine
    another back, pages bitwise equal on both sides; the pulled prompt's
    TTFT against a recompute; ``migrate_kv_device`` between two tp 2
    engines (through the ranks' gathers and pushes), pages bitwise equal
    and the donor's and recipient's greedy continuations equal. (d)
    ``pipelined_forward`` on PIPE_STAGES stage ranks (``run_group``):
    PIPE_MICRO x PIPE_MB x PIPE_S then one decode tick against
    ``forward_chunk`` on one rank, logits by the argmax and NEAR_TIE rules,
    every stage's pools bitwise equal to its layers of the one-rank pools;
    ms a tick. Then the kernels at every shape (b) and (c) gave them
    (:class:`PathShapes`) held to their plain versions, the decode shapes
    timed (``@mesh`` entries, each with the launches of its pool kind; a
    shape whose kind launched nothing counted, the one-device reference's,
    is timed and left out of the line). Launches (every rank) are added to
    the kernels line's entries: (b)'s to the int8 ones, (c)'s and (d)'s to
    the bf16 ragged and fused decode ones, qmm to the int8 qmm entry. NCCL is
    not exercised: it refuses ranks that share one card.

Images without Pillow:

27. after phase 26. The host image path (``utils/jpeg.py``,
    ``utils/png.py``, ``utils/resize.py``; C++ in
    ``native/src/image_codec.cpp``, built with g++ at first use) on the
    seeded fixtures of ``tests/fixtures/images`` (a 4032 x 3024 baseline
    4:2:0 JPEG, a 1920 x 1080 progressive one, 4:4:4 with restart markers,
    4:2:2 at an odd size, grey, an Adam7 RGBA PNG and a 16-bit RGB PNG):
    each native decode and each native resize to 224 x 224 has the
    SHA-256 of Pillow's answer in the fixtures' manifest (Pillow is not on
    the card's machine); native and plain versions agree on the two
    smallest. ``VisionEngine`` (small-vit + llama3-1b, decoder bf16, as
    phase 20 (c)) answers one base64 ``image`` request for each fixture:
    counters zeroed before and read after, both attention kernels launched
    (added to the bf16 ragged and fused decode entries of the kernels
    line); no plain host version taken (``native.PLAIN_TAKEN``); ids in
    vocabulary; the kernels' prefill logits on the 12 MP photo's prefix
    within LOGITS_REL_BOUND of the plain versions'. Printed for each
    fixture, host times with the host CPU's name: decode ms and MP/s,
    resize ms; the request's ms, and, from a second run of each request
    with every stage timed to its end (``stage_clock``), its split into
    decode, resize, ViT, decoder prefill and decode steps, with the card's
    name and power limit.

The gRPC stage plane on the standard library:

28. after phase 27. ``comm/grpc_plane.py`` (HTTP/2, HPACK and the proto3
    codec of ``comm/{h2,hpack,pb}.py``; no grpcio). (a) llama3-8b at full
    width and GRPC_LAYERS of its 32 layers (cut for the script's time
    limit; a reply's size does not depend on the depth), int8 weights (one
    tree, seed 0), bf16 pools: two ``PipelineStageWorker`` s (``uniform_stages``,
    ``slice_stage_params`` views), each behind a ``GrpcDataPlane`` and a
    ``DataPlaneServer`` on 127.0.0.1. Phase 21's four prompts
    (PIPE_LENGTHS), GRPC_TOKENS greedy tokens each, prefill in chunks of
    GRPC_CHUNK tokens: over one ``StreamForward`` stream a stage (counters
    zeroed just before, read just after: ragged, fused decode and qmm all
    launched, added to the kernels line's bf16 ragged and fused decode and
    int8 qmm entries), over unary ``Forward`` and over the HTTP
    ``WorkerSession.forward``: every step's logits bitwise equal across
    the three routes, streams identical; against ``forward_chunk`` on one
    device on the same tree and chunks, streams identical or parted at a
    near-tie (NEAR_TIE, judged in both runs' logits as phase 21 judges).
    Tensors ride zstd-compressed (level 3 from 4,096 B, as the JAX plane
    writes them), so grpcio's 4 MiB receive limit, which the JAX plane has
    too, falls on the compressed message: prefill chunks from GRPC_CHUNK +
    1 tokens up pass at the last stage's reply until one fails with
    ``RESOURCE_EXHAUSTED`` (``CLIENT: Received message larger than max (N
    vs. 4194304)``, N > 4 MiB), the last that passed uncompressed above the
    limit; a decode step after it gives (c) and phase 29 their tensors. (b) Two
    ``TorchLLMEngine`` s (llama3-8b, int8 weights and int8 pools, as phase
    16 sets them up): A exports phase 16's prompt streamed in pieces of
    GRPC_PIECE_BLOCKS blocks; the frames are pushed one by one through
    ``TransferKVCache`` to B's ``kv_receiver`` behind a ``GrpcDataPlane``
    (the commit answers B's slot), and the same frames over HTTP
    ``/kv/transfer`` to a second adoption on B: both decode to the same
    GRPC_TOKENS tokens. A piece of 4 blocks fails with
    ``RESOURCE_EXHAUSTED`` (``SERVER: ...``) and its session is aborted;
    its frames are uncompressed (streamed pieces are, by the JAX default),
    and what zstd would make of its int8 codes is printed.
    Counters zeroed before A's export and read after B's decodes: added to
    the int8 entries. (c) Information, with the card's name and power
    limit: decode tok/s over StreamForward, unary Forward and HTTP on the
    same stages; each hop's p50 / p95 ms split into the stage's forward and
    framing + transport; message bytes each way a hop, compressed and
    uncompressed, on a real decode step's tensors; the handoff's MB/s over
    gRPC and over HTTP.

zstd frames and YAML configs on the standard library:

29. after phase 28. ``utils/zstd.py`` over ``native/src/zstd_codec.cpp``
    (built with g++ at first use) and ``utils/yaml_config.py``; the card's
    machine has neither ``zstandard`` nor PyYAML. (a) Each libzstd fixture
    of ``tests/fixtures/zstd`` decodes natively to its manifest's SHA-256,
    and through the plain decoder too where it holds up to
    ZSTD_PLAIN_BYTES; the frames libzstd refuses (no content size, a
    dictionary, a skippable frame, truncated, two flipped bits) are
    refused, each in a child process, by both decoders. (b) Two
    ``TorchLLMEngine`` s (llama3-8b, int8 weights and int8 pools, as phase
    16 sets them up): A exports phase 16's prompt in one blob,
    ``serialize_handoff(compress=True)`` (the default), which holds zstd
    frames; B adopts it and decodes PD_TOKENS greedy tokens, then the same
    handoff re-framed uncompressed, and both decode the same tokens.
    Counters zeroed before A's export, read after B's decodes: all three
    kernels launched, added to the kernels line's int8 entries. (c) The
    JAX worker's ``tests/fixtures/config/config.yaml`` reads equal to its
    JSON twin, builds the same ``WorkerConfig``, and the port's
    ``safe_dump`` of the twin is the file byte for byte. (d) Information,
    with the card's name and power limit and the host CPU's name: the
    native codec's encode and decode MB/s and wire bytes on the handoff's
    pages and scales, on phase 28's decode-step hidden and logits and a
    prefill chunk's logits, and on a logits row B sampled; phases 21 and
    28's message bytes a decode hop, compressed and uncompressed. After
    every phase the run asserts that no host function took its plain
    version (``native.PLAIN_TAKEN``).

The last four lines are the script's seconds, the kernels JSON (every entry
with ``ms`` and ``graph_ms``; ``@long`` entries for phase 10, ``@d32``
entries for phase 12, ``@verify`` / ``@m40`` entries for phase 15,
``@moe-*`` entries for phase 19, ``@tp2`` entries for phase 23, ``@seq``
entries for phase 24, ``@mesh`` entries for phase 26), the
nvidia-smi line and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import http.client
import json
import re
import subprocess
import sys
import threading
import time
import weakref

import numpy as np

# published peaks of one H100 SXM (dense bf16 tensor rate, HBM3 rate)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# bf16 kernel vs its plain version (f32 inside, bf16 out): about one bf16
# ulp relative (2^-7 = 7.8e-3) plus a small absolute term. The ragged
# kernel rounds the softmax weights to bf16 for its tensor-core P·V, which
# costs up to ~2.4e-3 absolute where a query with 2-4 keys cancels to near
# zero, hence its larger absolute term. Besides, each (row, query, head)
# output vector must agree within VEC_REL relative L2: one key dropped from
# a 512-key row moves its vector by ~1e-1.
RAGGED_ATOL, FUSED_ATOL, RTOL, VEC_REL = 3e-3, 2e-3, 1e-2, 1e-2
# over an int8 pool the ragged kernel also rounds each dequantized K and V
# element (code * scale, exact in the plain version) to bf16 for its tensor
# cores: half an ulp, 2^-9 of the value. An output that cancels to near zero
# keeps that error in absolute terms, so the absolute term grows by 2^-9
# times the largest dequantized value (fp8 -> bf16 is exact: no growth).
BF16_HALF_ULP = 2.0 ** -9
LOGITS_REL_BOUND = 5e-2     # ||kernel - plain|| / ||plain|| over 32 layers
# the quantized matmul vs its plain version: both accumulate in f32 and
# round once to bf16, only the summation order differs (one bf16 ulp)
QMM_ATOL = 2e-3
NH, HKV, D, BK = 32, 8, 128, 16
MAX_SEQ = 1024
M = MAX_SEQ // BK
HIDDEN, FFN = 4096, 14336
# one llama3-8b layer's projections: (name, K, N)
LAYER_PROJ = (("wq", HIDDEN, NH * D), ("wk", HIDDEN, HKV * D), ("wv", HIDDEN, HKV * D),
              ("wo", NH * D, HIDDEN), ("w_gate", HIDDEN, FFN), ("w_up", HIDDEN, FFN),
              ("w_down", FFN, HIDDEN))
PROJ_SHAPES = ((HIDDEN, HIDDEN), (HIDDEN, HKV * D), (HIDDEN, FFN), (FFN, HIDDEN))
BOUND_ROWS = (8, 16, 32, 64, 128, 256)
SERVE_BATCH = 8
LONG_M = 256                # table width of the long shapes: 4096 keys a row
# (bytes an element, bytes of scale a token) of each KV pool type
KV_BYTES = {"bf16": (2, 0), "int8": (1, 2), "fp8": (1, 0)}
# keys a split of the fused decode kernel, timed against its plan's
SPLIT_SWEEP = (64, 128, 256, 512)
# compile-time geometry of the quantized matmul timed against its build's
# (ring stages, K rows a stage): the sweep that chose the defaults
QMM_SWEEP = ((2, 64), (3, 64), (4, 64), (6, 64), (2, 128), (3, 128))
QMM_ROWS = (1, 8, 40)       # parity rows below the row bound (which is checked too)
SRC = "distributed_gpu_inference_torch/csrc/"
PALLAS = "distributed_gpu_inference_tpu/ops/paged_attention_pallas.py"
QPALLAS = "distributed_gpu_inference_tpu/ops/qmm_pallas.py"


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, flush, iters: int = 30, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``iters`` calls (CUDA events),
    with the L2 cache flushed before each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def graph_ms(torch, fn, flush, iters: int = 30) -> float:
    """Device time of ``fn`` replayed as one captured CUDA graph: the same
    launches without the host's launch gaps between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(torch, graph.replay, flush, iters)


def errors(torch, got, want, atol):
    """(ok, max abs err, max relative L2 err of one head's output vector):
    ok iff every element is within atol + RTOL*|want| and every vector
    within VEC_REL (vectors whose plain output is all zero must be zero)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    vec = (g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)
    max_vec = float(vec.max().item())
    ok = bool(torch.all(diff <= atol + RTOL * w.abs()).item()) and max_vec <= VEC_REL
    return ok, float(diff.max().item()), max_vec


# ---------------------------------------------------------------- inputs

def ragged_round_case(torch, dev, window=None, hs=(NH, HKV, D)):
    """One ragged round at serving shapes: 8 rows x 256-wide bucket mixing
    decode rows, 256-wide chunk rows (first and continuing), a pad row, a
    row over a cached prefix (its table shares another row's first 8
    pages) and a short chunk with a padded tail; heads (Nh, Hkv, D) ``hs``."""
    nh, hkv, d = hs
    rng = np.random.default_rng(1)
    b, s = 8, 256
    n = 1 + b * M
    kp = torch.tensor(rng.standard_normal((n, hkv, BK, d)), dtype=torch.bfloat16, device=dev)
    vp = torch.tensor(rng.standard_normal((n, hkv, BK, d)), dtype=torch.bfloat16, device=dev)
    q = torch.tensor(rng.standard_normal((b, s, nh, d)), dtype=torch.bfloat16, device=dev)
    tables = np.arange(1, n, dtype=np.int32).reshape(b, M)
    tables[5, :8] = tables[2, :8]            # row 5 reuses row 2's prefix
    tables[4] = 0                            # pad row
    spans = [  # (first position, live queries, kv_len)
        (299, 1, 300), (76, 1, 77), (0, 256, 256), (256, 256, 512),
        (0, 0, 0), (128, 200, 328), (0, 40, 40), (599, 1, 600),
    ]
    pos = np.full((b, s), -1, np.int32)
    lens = np.zeros((b,), np.int32)
    for i, (p0, nq, kv) in enumerate(spans):
        pos[i, :nq] = np.arange(p0, p0 + nq)
        lens[i] = kv
    t = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)  # noqa: E731
    return q, kp, vp, t(tables), t(pos), t(lens), (tables, pos, lens)


def decode_case(torch, dev, hs=(NH, HKV, D)):
    """One decode step of 8 rows of different lengths, one inactive, on
    two-layer stacked pools (layer 1 addressed); heads (Nh, Hkv, D) ``hs``."""
    nh, hkv, d = hs
    rng = np.random.default_rng(2)
    b, L = 8, 2
    n = 1 + b * M
    kp = torch.tensor(rng.standard_normal((L, n, hkv, BK, d)), dtype=torch.bfloat16, device=dev)
    vp = torch.tensor(rng.standard_normal((L, n, hkv, BK, d)), dtype=torch.bfloat16, device=dev)
    q = torch.tensor(rng.standard_normal((b, 1, nh, d)), dtype=torch.bfloat16, device=dev)
    nk = torch.tensor(rng.standard_normal((b, 1, hkv, d)), dtype=torch.bfloat16, device=dev)
    nv = torch.tensor(rng.standard_normal((b, 1, hkv, d)), dtype=torch.bfloat16, device=dev)
    tables = np.arange(1, n, dtype=np.int32).reshape(b, M)
    lens = np.array([1, 17, 96, 129, 300, 513, 0, 632], np.int32)   # row 6 inactive
    tables[6] = 0
    pos = (lens - 1).astype(np.int32)[:, None]
    t = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)  # noqa: E731
    return q, nk, nv, kp, vp, 1, t(tables), t(pos), t(lens), lens


def ragged_cost(tables, pos, lens, window, kv_bytes=2, scale_bytes=0, hs=(NH, HKV, D)):
    """(bytes, flops) the ragged round needs: q of the live positions once,
    out of every position once (pad outputs are written as zeros), K and V
    of each distinct (page, slot) that some row's visible key range covers
    once (a prefix two rows share is read once; ``kv_bytes`` per element
    and ``scale_bytes`` per token of each pool), tables/positions/lengths
    once; 4*D flops per visible (query head, key) pair; heads ``hs``."""
    nh, hkv, d = hs
    b, s = pos.shape
    pairs, slots = 0, []
    for i in range(b):
        live = pos[i][pos[i] >= 0]
        if live.size == 0 or lens[i] == 0:
            continue
        lo = max(0, int(live.min()) - window + 1) if window else 0
        hi = min(int(live.max()) + 1, int(lens[i]))
        j = np.arange(lo, hi)
        slots.append(tables[i, j // BK].astype(np.int64) * BK + j % BK)
        for p in live:
            first = max(0, int(p) - window + 1) if window else 0
            pairs += max(min(int(p) + 1, int(lens[i])) - first, 0)
    keys = np.unique(np.concatenate(slots)).size if slots else 0
    live_q = int((pos >= 0).sum())
    nbytes = ((live_q + b * s) * nh * d * 2 + keys * (hkv * d * kv_bytes + scale_bytes) * 2
              + (b * tables.shape[1] + b * s + b) * 4)
    return nbytes, 4 * d * nh * pairs


def long_ragged_case(torch, dev):
    """The long round at llama3-8b widths, M = 256: 8 rows x 256 bucket,
    2 chunk rows at positions 3840-4095 and 6 decode rows at position 4095,
    every row at kv 4096 over its own pages."""
    rng = np.random.default_rng(6)
    b, s, m = 8, 256, LONG_M
    n = 1 + b * m
    kp = torch.tensor(rng.standard_normal((n, HKV, BK, D)), dtype=torch.bfloat16, device=dev)
    vp = torch.tensor(rng.standard_normal((n, HKV, BK, D)), dtype=torch.bfloat16, device=dev)
    q = torch.tensor(rng.standard_normal((b, s, NH, D)), dtype=torch.bfloat16, device=dev)
    tables = np.arange(1, n, dtype=np.int32).reshape(b, m)
    keys = m * BK
    pos = np.full((b, s), -1, np.int32)
    pos[:2] = np.arange(keys - s, keys)
    pos[2:, 0] = keys - 1
    lens = np.full((b,), keys, np.int32)
    t = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)  # noqa: E731
    return q, kp, vp, t(tables), t(pos), t(lens), (tables, pos, lens)


def long_decode_case(torch, dev):
    """One decode step of 8 active rows at kv 4096 (M = 256), one layer."""
    rng = np.random.default_rng(7)
    b, m = 8, LONG_M
    n = 1 + b * m
    kp = torch.tensor(rng.standard_normal((1, n, HKV, BK, D)), dtype=torch.bfloat16, device=dev)
    vp = torch.tensor(rng.standard_normal((1, n, HKV, BK, D)), dtype=torch.bfloat16, device=dev)
    q = torch.tensor(rng.standard_normal((b, 1, NH, D)), dtype=torch.bfloat16, device=dev)
    nk = torch.tensor(rng.standard_normal((b, 1, HKV, D)), dtype=torch.bfloat16, device=dev)
    nv = torch.tensor(rng.standard_normal((b, 1, HKV, D)), dtype=torch.bfloat16, device=dev)
    tables = np.arange(1, n, dtype=np.int32).reshape(b, m)
    lens = np.full((b,), m * BK, np.int32)
    pos = (lens - 1).astype(np.int32)[:, None]
    t = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)  # noqa: E731
    return q, nk, nv, kp, vp, 0, t(tables), t(pos), t(lens), lens


def decode_cost(lens, kv_bytes=2, scale_bytes=0, m=None, hs=(NH, HKV, D)):
    """(bytes, flops) of one fused decode step: the active rows' q once,
    every row's out once, the active rows' new K/V read once (bf16) and
    written once (``kv_bytes`` per element, ``scale_bytes`` per token of
    each pool), the context already in the pool (kv_len - 1 keys per active
    row) read once, tables ([B, m], m = M unless given)/positions/lengths
    once; 4*D flops per (query head, key) pair over the whole context, the
    new key included; heads ``hs``."""
    nh, hkv, d = hs
    b = len(lens)
    active = lens[lens > 0]
    a, ctx = len(active), int(active.sum())
    token = hkv * d * kv_bytes + scale_bytes
    nbytes = (a * nh * d * 2 + b * nh * d * 2
              + a * (hkv * d * 2 + token) * 2
              + (ctx - a) * token * 2
              + (b * (M if m is None else m) + 2 * b) * 4)
    return nbytes, 4 * d * nh * ctx


def qmm_cost(m, shapes):
    """(bytes, flops) of the quantized matmul over ``shapes`` [(K, N)]: x
    (bf16), the one-byte codes and the f32 scales read once, out (bf16)
    written once; 2*M*K*N flops each."""
    nbytes = sum(m * k * 2 + k * n + n * 4 + m * n * 2 for k, n in shapes)
    return nbytes, sum(2 * m * k * n for k, n in shapes)


def bound(nbytes, flops):
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def gathered(torch, pool, tables):
    """[N, Hkv, Bk, D] pages gathered by [B, M] tables → [B, Hkv, J, D]."""
    b, m = tables.shape
    hkv, d = pool.shape[1], pool.shape[3]
    return pool[tables.long()].permute(0, 2, 1, 3, 4).reshape(b, hkv, m * BK, d)


def sdpa_call(torch, q_bshd, kc, vc, pos, lens):
    """scaled_dot_product_attention over contiguous context with the same
    visibility mask; GQA by expanding the kv heads (outside the timing)."""
    import torch.nn.functional as F

    b, s = pos.shape
    j = kc.shape[2]
    key = torch.arange(j, device=q_bshd.device)
    mask = (key[None, None, :] <= pos[:, :, None]) & (key[None, None, :] < lens[:, None, None])
    qh = q_bshd.transpose(1, 2).contiguous()
    rep = q_bshd.shape[2] // kc.shape[1]
    kx = kc.repeat_interleave(rep, dim=1).contiguous()
    vx = vc.repeat_interleave(rep, dim=1).contiguous()
    m4 = mask[:, None].contiguous()
    return lambda: F.scaled_dot_product_attention(qh, kx, vx, attn_mask=m4)


def dequantized(torch, pool, scale):
    """A pool [N, Hkv, Bk, D] as bf16 (int8: code * its token's scale), for
    the library yardstick."""
    if scale is None:
        return pool.to(torch.bfloat16)
    return (pool.float() * scale.float()[:, None, :, None]).to(torch.bfloat16)


def kv_pools(torch, kp, vp, kind):
    """bf16 pools (one layer [N, ...] or stacked [L, N, ...]) → (k, v,
    k_scale, v_scale) in ``kind``: "bf16" as they are, "int8" with
    per-token scales, "fp8"."""
    from distributed_gpu_inference_torch.ops.attention import quantize_kv_pool
    from distributed_gpu_inference_torch.ops.quantization import to_float8_e4m3

    if kind == "bf16":
        return kp, vp, None, None
    if kind == "fp8":
        return to_float8_e4m3(kp), to_float8_e4m3(vp), None, None
    if kp.dim() == 4:
        (kq, ks), (vq, vs) = quantize_kv_pool(kp), quantize_kv_pool(vp)
        return kq, vq, ks, vs
    ks = [quantize_kv_pool(kp[i]) for i in range(kp.shape[0])]
    vs = [quantize_kv_pool(vp[i]) for i in range(vp.shape[0])]
    return (torch.stack([c for c, _ in ks]), torch.stack([c for c, _ in vs]),
            torch.stack([x for _, x in ks]), torch.stack([x for _, x in vs]))


def ragged_in(torch, case, kind):
    """A ``*ragged*_case`` with its pools in ``kind`` → (q, k, v, k_scale,
    v_scale, tables, positions, lens, host arrays)."""
    q, kp, vp, tables, pos, lens, host = case
    return (q, *kv_pools(torch, kp, vp, kind), tables, pos, lens, host)


def decode_in(torch, case, kind):
    """A ``*decode_case`` with its pools in ``kind`` → (q, new_k, new_v, k,
    v, k_scale, v_scale, layer, tables, positions, lens, host lens)."""
    q, nk, nv, kp, vp, layer, tables, pos, lens, lens_np = case
    return (q, nk, nv, *kv_pools(torch, kp, vp, kind), layer, tables, pos, lens, lens_np)


def raw(torch, t):
    """A tensor's bits, for bit-identity checks (NaN codes included)."""
    return t.view(torch.uint8) if t.element_size() == 1 else t.view(torch.int16)


def time_attention(torch, tag, flush, fn, plain_fn, lib_fn, cost):
    """One attention kernel at one shape: the kernel and the SDPA yardstick
    call by call (events) and replayed as a CUDA graph, the plain version
    call by call, the bound of ``cost`` = (bytes, flops) and the kernel's
    share of it; prints one line. → the kernels-JSON timing keys."""
    ms, g_ms = time_ms(torch, fn, flush), graph_ms(torch, fn, flush)
    plain_ms = time_ms(torch, plain_fn, flush, iters=10, warmup=1)
    lib_ms, lib_g_ms = time_ms(torch, lib_fn, flush), graph_ms(torch, lib_fn, flush)
    nbytes, flops = cost
    b_ms, by = bound(nbytes, flops)
    print(f"{tag}: kernel {ms:.4f} ms (as a CUDA graph {g_ms:.4f} ms, {b_ms / g_ms:.1%} of the "
          f"bound), plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms (graph {lib_g_ms:.4f} ms), "
          f"bound {b_ms:.4f} ms ({by}: {nbytes} B, {flops} flop)", flush=True)
    return {"ms": ms, "graph_ms": g_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": lib_ms, "library_graph_ms": lib_g_ms}


def ragged_times(torch, pa, ref, flush, tag, case, kind, hs=(NH, HKV, D)):
    """:func:`time_attention` of the ragged kernel on ``ragged_in``'s
    ``case`` (pools in ``kind``, heads ``hs``); SDPA runs on the
    dequantized context."""
    q, kq, vq, ks, vs, tables, pos, lens, host = case
    fn = lambda: pa.ragged_paged_attention(q, kq, vq, tables, pos, lens, BK,  # noqa: E731
                                           k_scale=ks, v_scale=vs)
    plain = lambda: ref(q, kq, vq, tables, pos, lens, BK, k_scale=ks, v_scale=vs)  # noqa: E731
    lib = sdpa_call(torch, q, gathered(torch, dequantized(torch, kq, ks), tables),
                    gathered(torch, dequantized(torch, vq, vs), tables), pos, lens)
    return time_attention(torch, tag, flush, fn, plain, lib,
                          ragged_cost(*host, None, *KV_BYTES[kind], hs=hs))


def decode_times(torch, pa, flush, tag, case, kind, hs=(NH, HKV, D)):
    """:func:`time_attention` of the fused decode kernel on ``decode_in``'s
    ``case`` (the plain version writes into copies of the pools), then the
    kernel as a CUDA graph with each of SPLIT_SWEEP keys a split (one line;
    the plan the wrapper takes is marked); heads ``hs``."""
    q, nk, nv, kq, vq, ks, vs, layer, tables, pos, lens, lens_np = case
    sc = {} if ks is None else dict(k_scale=ks, v_scale=vs)
    kq2, vq2 = kq.clone(), vq.clone()
    sc2 = {} if ks is None else dict(k_scale=ks.clone(), v_scale=vs.clone())
    fn = lambda: pa.paged_decode_attention_fused(q, nk, nv, kq, vq, layer, tables,  # noqa: E731
                                                 pos, lens, BK, **sc)
    plain = lambda: pa.paged_decode_attention_fused_plain(  # noqa: E731
        q, nk, nv, kq2, vq2, layer, tables, pos, lens, BK, **sc2)
    lk = dequantized(torch, kq[layer], None if ks is None else ks[layer])
    lv = dequantized(torch, vq[layer], None if vs is None else vs[layer])
    lib = sdpa_call(torch, q, gathered(torch, lk, tables), gathered(torch, lv, tables), pos, lens)
    del lk, lv
    m = tables.shape[1]
    times = time_attention(torch, tag, flush, fn, plain, lib,
                           decode_cost(lens_np, *KV_BYTES[kind], m=m, hs=hs))
    del lib, kq2, vq2, sc2
    plan, sweep = pa.kv_split_plan(m, BK), []
    for keys in SPLIT_SWEEP:
        alt = pa.kv_split_plan(m, BK, keys)
        t = graph_ms(torch, lambda: pa.launch_decode_kernel(
            q, nk, nv, kq, vq, layer, tables, pos, lens, None, ks, vs, alt), flush)
        sweep.append(f"{keys} keys {alt} {t:.4f} ms" + (" (the plan)" if alt == plan else ""))
    print(f"{tag}, keys a split (pages, splits), as a CUDA graph: " + "; ".join(sweep),
          flush=True)
    return times


def qmm_repeat(torch, qmm, xs, weights):
    """One layer's projections (``weights`` [(codes, scale)], inputs ``xs``
    by K) twice, and replayed from a captured CUDA graph: (two calls
    bitwise equal, the replay bitwise equal to the eager call)."""
    def run():
        return [qmm.launch_kernel(xs[qw.shape[1]], qw, sc) for qw, sc in weights]

    first, second = run(), run()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    graph.replay()
    torch.cuda.synchronize()
    same = lambda a, b: all(torch.equal(raw(torch, u), raw(torch, v))  # noqa: E731
                            for u, v in zip(a, b))
    return same(first, second), same(first, captured)


def entry(name, source, replaces, launches, max_abs_err, times):
    """One entry of the kernels JSON line."""
    return {"name": name, "route": "cuda", "source": SRC + source, "replaces": replaces,
            "launches": launches, "max_abs_err": max_abs_err, **times}


def serving_prompts():
    rng = np.random.default_rng(3)
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz ,.ABCDEFGHIJ"))
    shared = "".join(rng.choice(alphabet, 128))
    lengths = [64, 150, 233, 310, 388, 450, 530, 600]
    prompts = ["".join(rng.choice(alphabet, n)) for n in lengths]
    prompts[3] = shared + prompts[3][128:]
    prompts[6] = shared + prompts[6][128:]
    return shared, lengths, prompts


def serve(torch, pa, llm, prompts, shared, min_cached=128):
    """8 concurrent requests of 32 greedy tokens plus one prefix hit
    through ``TorchLLMEngine.inference``, with the launch counters zeroed
    just before and read just after; the hit must find ``min_cached``
    tokens cached (128: one token a byte). → (tokens of the 8 requests by
    prompt, payloads, hit payload, wall seconds, launches, batcher
    stats)."""
    responses = {}
    lock = threading.Lock()
    real_submit = llm.serving.submit

    def recording_submit(req, *a, **kw):
        resp = real_submit(req, *a, **kw)
        with lock:
            responses[tuple(req.prompt_token_ids)] = resp
        return resp

    llm.serving.submit = recording_submit
    payloads = [None] * len(prompts)

    def call(i):
        payloads[i] = llm.inference({"prompt": prompts[i], "max_new_tokens": 32,
                                     "temperature": 0.0, "ignore_eos": True})

    pa.reset_launch_counts()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(prompts))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    if any(th.is_alive() for th in threads):
        raise AssertionError("serving requests did not finish within 600 s")
    wall = time.perf_counter() - t0
    hit = llm.inference({"prompt": shared + "zz" * 40, "max_new_tokens": 32,
                         "ignore_eos": True})
    torch.cuda.synchronize()
    launches = pa.launch_counts()
    vocab = llm.engine.model_cfg.vocab_size
    if len(responses) != 9 or any(r.error for r in responses.values()):
        raise AssertionError(f"serving errors: {[r.error for r in responses.values()]}")
    for r in responses.values():
        if len(r.token_ids) != 32 or not all(0 <= t < vocab for t in r.token_ids):
            raise AssertionError(f"bad tokens in {r.request_id}: {r.token_ids}")
    if any(p is None or p["usage"]["completion_tokens"] != 32 for p in payloads):
        raise AssertionError(f"bad payloads: {payloads}")
    if hit["usage"]["cached_tokens"] < min_cached:
        raise AssertionError(f"prefix cache missed: {hit['usage']}")
    hit_key = tuple(llm.tokenizer.encode(shared + "zz" * 40))
    tokens = {k: list(r.token_ids) for k, r in responses.items() if k != hit_key}
    stats = llm.serving.get_stats()
    del llm.serving.submit      # drop the wrapper: it would keep the engine alive
    return tokens, payloads, hit, wall, launches, stats


def report_serving(tag, lengths, payloads, hit, wall, stats):
    ttft = sorted(p["ttft_ms"] for p in payloads)
    n_tok = sum(p["usage"]["completion_tokens"] for p in payloads)
    print(f"[{tag}] 8 concurrent requests (prompts {lengths} bytes, 2 sharing a "
          f"128-token prefix), 32 greedy tokens each: {n_tok} tokens in {wall:.2f} s "
          f"= {n_tok / wall:.1f} tok/s end to end; TTFT p50 {ttft[len(ttft) // 2]:.1f} ms; "
          f"prefix hit request cached {hit['usage']['cached_tokens']} tokens; "
          f"rounds {stats.get('decode_rounds')} ragged {stats.get('ragged_rounds')}",
          flush=True)


@contextlib.contextmanager
def plain_kernels():
    """The model's kernels swapped for their plain versions."""
    from distributed_gpu_inference_torch.models import llama
    from distributed_gpu_inference_torch.ops import paged_attention as pa
    from distributed_gpu_inference_torch.ops import qmm
    from distributed_gpu_inference_torch.ops.attention import paged_attention_ref

    saved = (llama.ragged_paged_attention, llama.paged_decode_attention_fused,
             qmm.qmm_w8a16)
    llama.ragged_paged_attention = paged_attention_ref
    llama.paged_decode_attention_fused = pa.paged_decode_attention_fused_plain
    qmm.qmm_w8a16 = qmm.qmm_plain
    try:
        yield
    finally:
        (llama.ragged_paged_attention, llama.paged_decode_attention_fused,
         qmm.qmm_w8a16) = saved


def compare_forward(torch, tag, cfg, params, kv_dtype, dev):
    """One full-width prefill and one decode step through the kernels and
    through the plain versions (fresh scratch pools, the served weights);
    their logits must agree within LOGITS_REL_BOUND. An MoE model's plain
    pass routes every token as the kernel pass did (:class:`RoutePins`)."""
    from distributed_gpu_inference_torch.models import llama

    def run_forward():
        kv = llama.init_kv_pools(cfg, 1 + 2 * 17, BK, kv_dtype, dev)
        g = torch.Generator(device=dev).manual_seed(4)
        toks = torch.randint(0, 256, (2, 256), generator=g, device=dev, dtype=torch.int32)
        pos = torch.arange(256, device=dev, dtype=torch.int32).repeat(2, 1)
        pos[1, 200:] = -1
        tables = torch.arange(1, 35, device=dev, dtype=torch.int32).reshape(2, 17)
        lens = torch.tensor([256, 200], device=dev, dtype=torch.int32)
        pre = llama.forward_chunk(cfg, params, toks, pos, kv, tables, lens, block_size=BK).logits
        step = llama.forward_chunk(cfg, params, toks[:, :1], lens[:, None].clone(), kv,
                                   tables, lens + 1, block_size=BK).logits
        return pre.float(), step.float()

    from distributed_gpu_inference_torch.models import llama as llama_mod

    pins = RoutePins(torch, llama_mod)
    with torch.no_grad():
        with pins.record() if cfg.num_experts else contextlib.nullcontext():
            k_pre, k_step = run_forward()
        with plain_kernels(), pins.order() if cfg.num_experts else contextlib.nullcontext():
            p_pre, p_step = run_forward()
        if cfg.num_experts:
            with plain_kernels():
                free = torch.cat([t.flatten() for t in run_forward()])
            kern = torch.cat([k_pre.flatten(), k_step.flatten()])
            print(f"[{tag}] the plain pass routed as the kernel pass: {pins.pinned} "
                  f"row-layers pinned, {pins.flips} of them its own router would have routed "
                  f"otherwise; routed by its own router, its logits part from the kernels' by "
                  f"rel L2 {float(((kern - free).norm() / free.norm()).item()):.3e} "
                  f"(information)", flush=True)
    for name, a, b in (("prefill", k_pre, p_pre), ("decode step", k_step, p_step)):
        rel = float(((a - b).norm() / b.norm()).item())
        agree = float((a.argmax(-1) == b.argmax(-1)).float().mean().item())
        print(f"[{tag}] forward_chunk {name} logits, kernels vs plain: rel L2 err "
              f"{rel:.3e} (bound {LOGITS_REL_BOUND}), argmax agreement {agree:.2f}",
              flush=True)
        if not (rel <= LOGITS_REL_BOUND and np.isfinite(rel)):
            raise AssertionError(f"{tag} {name} logits drift beyond the bound: {rel}")


def long_parity(torch, pa, ref, kind, rcase, dcase):
    """Phase 10's checks for one pool type: both kernels at the long shapes
    against their plain versions with the phase-3/6 tolerances, two calls
    bitwise equal, pad queries exact zero, the fused write's code and scale
    pools bit-identical to the plain write. → (ragged, fused) max abs err."""
    q, kq, vq, ks, vs, tables, pos, lens, _ = rcase
    want = ref(q, kq, vq, tables, pos, lens, BK, k_scale=ks, v_scale=vs)
    atol = RAGGED_ATOL
    if kind == "int8":
        atol += BF16_HALF_ULP * float(torch.maximum(
            dequantized(torch, kq, ks).abs().max(), dequantized(torch, vq, vs).abs().max()).item())
    got = pa.ragged_paged_attention(q, kq, vq, tables, pos, lens, BK, k_scale=ks, v_scale=vs)
    again = pa.ragged_paged_attention(q, kq, vq, tables, pos, lens, BK, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    ok, r_err, r_vec = errors(torch, got, want, atol)
    same = bool(torch.equal(raw(torch, got), raw(torch, again)))
    pad_zero = bool((got[pos < 0] == 0).all().item())
    print(f"[long] ragged {kind} 8x256 round at kv 4096 (M {LONG_M}): max_abs_err {r_err:.3e} "
          f"max_vector_rel_err {r_vec:.3e} (bound atol {atol:.3e} rtol {RTOL}, vector "
          f"{VEC_REL}); two calls bitwise equal: {same}; pad queries exact zero: {pad_zero}",
          flush=True)
    if not (ok and same and pad_zero):
        raise AssertionError(f"ragged {kind} kernel disagrees at the long shape")
    d_err = long_parity_fused(torch, pa, kind, dcase,
                              f"[long] fused decode {kind} 8 rows at kv 4096 (M {LONG_M}, "
                              f"split plan {pa.kv_split_plan(LONG_M, BK)})")
    return r_err, d_err


def long_parity_fused(torch, pa, kind, dcase, label):
    """The fused decode kernel on ``decode_in``'s ``dcase`` against its
    plain version (writing into copies of the pools), phase 10's checks:
    the phase-3 tolerance, two calls bitwise equal, the code and scale
    pools bit-identical to the plain write; one line led by ``label``. →
    max abs err."""
    q, nk, nv, kq, vq, ks, vs, layer, tables, pos, lens, _ = dcase
    kq2, vq2 = kq.clone(), vq.clone()
    sc = {} if ks is None else dict(k_scale=ks, v_scale=vs)
    sc2 = {} if ks is None else dict(k_scale=ks.clone(), v_scale=vs.clone())
    got = pa.paged_decode_attention_fused(q, nk, nv, kq, vq, layer, tables, pos, lens, BK, **sc)[0]
    want = pa.paged_decode_attention_fused_plain(q, nk, nv, kq2, vq2, layer, tables, pos, lens,
                                                 BK, **sc2)[0]
    again = pa.paged_decode_attention_fused(q, nk, nv, kq, vq, layer, tables, pos, lens, BK,
                                            **sc)[0]
    torch.cuda.synchronize()
    ok, d_err, d_vec = errors(torch, got, want, FUSED_ATOL)
    same = bool(torch.equal(raw(torch, got), raw(torch, again)))
    pools_equal = bool(torch.equal(raw(torch, kq), raw(torch, kq2))
                       and torch.equal(raw(torch, vq), raw(torch, vq2)))
    scales_equal = ks is None or bool(torch.equal(raw(torch, ks), raw(torch, sc2["k_scale"]))
                                      and torch.equal(raw(torch, vs), raw(torch, sc2["v_scale"])))
    print(f"{label}: max_abs_err {d_err:.3e} max_vector_rel_err {d_vec:.3e} (bound atol "
          f"{FUSED_ATOL} rtol {RTOL}, vector {VEC_REL}); two calls bitwise equal: {same}; code "
          f"pools bit-identical after the write: {pools_equal}; scale pools bit-identical: "
          f"{scales_equal}", flush=True)
    if not (ok and same and pools_equal and scales_equal):
        raise AssertionError(f"fused decode {kind} kernel disagrees: {label}")
    return d_err


# ---------------------------------------------------------------- serving surface

HTTP_TIMEOUT = 120.0        # socket timeout of every client call of phase 11


class SmokeWorker:
    """The worker surface ``DirectServer`` reads: shared serving claims up
    to ``cap`` (a batcher-backed engine) or one exclusive claim at a time
    (``exclusive``: a ``serving.mode: direct`` engine), and a checkpoint
    store fed by the engine's ``checkpoint_sink``, read back by
    ``adopt_stream_checkpoint``."""

    def __init__(self, engine, cap=8, exclusive=False):
        from distributed_gpu_inference_torch.utils.data_structures import WorkerState

        self.state = WorkerState.IDLE
        self.engines = {"llm": engine}
        self.cap, self.active, self.exclusive = cap, 0, exclusive
        self.lock = threading.Lock()
        self.checkpoints = {}        # the latest entry of each key
        self.history = {}            # every entry of each key, in order

    def sink(self, entry):
        with self.lock:
            self.checkpoints[entry["key"]] = entry
            self.history.setdefault(entry["key"], []).append(entry)

    def try_begin_serving(self):
        with self.lock:
            if self.active >= self.cap:
                return False
            self.active += 1
            return True

    def end_serving(self):
        with self.lock:
            self.active -= 1

    def try_begin_job(self):
        with self.lock:
            if not self.exclusive or self.active:
                return False    # a batcher-backed engine takes shared claims
            self.active = 1
            return True

    def end_job(self):
        with self.lock:
            self.active = 0

    def get_status(self):
        return {"state": self.state.value, "active": self.active}

    def adopt_stream_checkpoint(self, stream_id):
        with self.lock:
            entry = self.checkpoints.get(stream_id)
        return None if entry is None else {"checkpoint": entry["state"],
                                           "epoch": entry["epoch"]}


def http_json(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=HTTP_TIMEOUT)
    try:
        conn.request("POST", path, body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def stream_events(port, body, limit=None):
    """POST /inference/stream and read up to ``limit`` events (all when
    None), then hang up. → (events, arrival times, send time)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=HTTP_TIMEOUT)
    events, times = [], []
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/inference/stream", body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            raise AssertionError(f"stream answered HTTP {resp.status}: {resp.read()!r}")
        while limit is None or len(events) < limit:
            line = resp.readline()
            if not line:
                break
            if line.startswith(b"data: "):
                events.append(json.loads(line[6:]))
                times.append(time.perf_counter())
        resp.close()
    finally:
        conn.close()
    return events, times, t0


def wait_until(cond, timeout=60.0):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


class LogitTrace:
    """The top-2 logits of the one live slot at every sample the engine
    takes during a recorded run (kept on the device, read afterwards)."""

    def __init__(self, engine):
        self.engine, self.runs = engine, {}

    @contextlib.contextmanager
    def recording(self, name):
        eng, rows = self.engine, []
        real = eng._sample

        def sample(logits, *a, **kw):
            live = [i for i, s in enumerate(eng.slots)
                    if s is not None and s.finish_reason is None]
            if len(live) == 1:
                rows.append(logits[live[0]].float().topk(2))
            return real(logits, *a, **kw)

        eng._sample = sample
        try:
            yield
        finally:
            del eng._sample
            self.runs[name] = rows

    def at(self, name, step):
        rows = self.runs[name]
        if not 0 <= step < len(rows):
            return "not recorded"
        vals, ids = rows[step].values.tolist(), rows[step].indices.tolist()
        return (f"id {ids[0]} {vals[0]:.4f} / id {ids[1]} {vals[1]:.4f} "
                f"(margin {vals[0] - vals[1]:.4f})")


def split_stream(events, first_offset=1):
    """Token events and the final event of one stream; offsets must run
    contiguously from ``first_offset``, one token an event."""
    body, final = events[:-1], events[-1]
    if not final.get("done") or any("error" in e for e in events):
        raise AssertionError(f"stream did not end cleanly: {events[-3:]}")
    offsets = [e["offset"] for e in body]
    if offsets != list(range(first_offset, first_offset + len(body))):
        raise AssertionError(f"stream offsets not contiguous: {offsets}")
    ids = [t for e in body for t in e["token_ids"]]
    if len(ids) != len(body):
        raise AssertionError("a stream event carried other than one token")
    return body, final, ids, "".join(e["text_delta"] for e in body)


def pctl(values, q):
    v = sorted(values)
    return v[min(len(v) - 1, int(round(q * (len(v) - 1))))]


def direct_server_phase(torch, pa, llm, prompts, smi):
    """Phase 11 on a loaded llama3-8b int8 engine (see the module
    docstring); raises on any failed check."""
    from distributed_gpu_inference_torch.worker.direct_server import DirectServer

    vocab = llm.engine.model_cfg.vocab_size
    tok = llm.tokenizer
    worker = SmokeWorker(llm)
    llm.checkpoint_sink = worker.sink
    server = DirectServer(worker, host="127.0.0.1", port=0)
    server.start()
    port = server.port

    def params(i, n=32, **kw):
        return dict({"prompt": prompts[i], "max_new_tokens": n, "temperature": 0.0,
                     "ignore_eos": True}, **kw)

    pa.reset_launch_counts()
    try:
        # ---- 8 concurrent streams
        results = [None] * len(prompts)

        def run(i):
            results[i] = stream_events(port, {"type": "llm", "params": params(i),
                                              "stream_id": f"smoke-{i}"})

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        if any(th.is_alive() for th in threads) or any(r is None for r in results):
            raise AssertionError("concurrent streams did not finish")
        ttft, gaps = [], []
        for i, (events, times, sent) in enumerate(results):
            body, final, ids, text = split_stream(events)
            if len(ids) != 32 or not all(0 <= t < vocab for t in ids):
                raise AssertionError(f"stream {i}: bad ids {ids}")
            if text != tok.decode(ids):
                raise AssertionError(f"stream {i}: text is not the decode of its ids")
            usage = final["usage"]
            if (usage["completion_tokens"], usage["prompt_tokens"], final["offset"]) != \
                    (32, len(tok.encode(prompts[i])), 32):
                raise AssertionError(f"stream {i}: usage {usage} offset {final['offset']}")
            ttft.append((times[0] - sent) * 1e3)
            gaps += [(b - a) * 1e3 for a, b in zip(times, times[1:len(body)])]
        print(f"[direct] 8 concurrent streams of 32 greedy tokens through POST "
              f"/inference/stream in {wall:.2f} s: offsets 1..32 contiguous, ids in "
              f"vocabulary, text = decode(ids), usage right; as the client sees them "
              f"(information): TTFT p50 {pctl(ttft, 0.5):.1f} ms p95 {pctl(ttft, 0.95):.1f} "
              f"ms, inter-event p50 {pctl(gaps, 0.5):.2f} ms p95 {pctl(gaps, 0.95):.2f} ms "
              f"({smi})", flush=True)

        # ---- a lone stream and the same request through /inference
        _, _, lone_ids, _ = split_stream(stream_events(
            port, {"type": "llm", "params": params(0), "stream_id": "smoke-lone"})[0])
        seen = []
        real_submit = llm.serving.submit

        def recording_submit(req, *a, **kw):
            resp = real_submit(req, *a, **kw)
            seen.append(list(resp.token_ids))
            return resp

        llm.serving.submit = recording_submit
        try:
            status, out = http_json(port, "/inference", {"type": "llm", "params": params(0)})
        finally:
            del llm.serving.submit
        if status != 200 or seen != [lone_ids]:
            raise AssertionError(f"lone stream {lone_ids} vs /inference {seen} ({status})")
        print(f"[direct] a lone stream and the same request through POST /inference: "
              f"identical {len(lone_ids)} token ids", flush=True)

        # ---- the client hangs up after 4 events
        before = llm.serving.get_stats()["cancelled"]
        got, _, _ = stream_events(port, {"type": "llm", "params": params(0, 256)}, limit=4)
        t_drop = time.perf_counter()
        quiet = wait_until(lambda: llm.serving.get_stats()["cancelled"] == before + 1
                           and llm.engine.num_active == 0 and worker.active == 0)
        print(f"[direct] a 256-token stream whose client hung up after {len(got)} events: "
              f"batcher cancelled +{llm.serving.get_stats()['cancelled'] - before}, "
              f"active slots {llm.engine.num_active}, claims {worker.active}, "
              f"{time.perf_counter() - t_drop:.2f} s after the hang-up", flush=True)
        if not quiet:
            raise AssertionError("the hung-up stream was not cancelled")

        # ---- hedged cancel
        out = {}
        th = threading.Thread(target=lambda: out.update(r=http_json(
            port, "/inference", {"type": "llm",
                                 "params": params(0, 512, hedge_key="smoke-hedge")})))
        th.start()
        started = wait_until(lambda: any(s is not None and s.generated
                                         for s in llm.engine.slots))
        cancelled = http_json(port, "/inference/cancel", {"hedge_key": "smoke-hedge"})
        th.join(timeout=600)
        status, body = out.get("r", (None, {}))
        result = body.get("result") or {}
        print(f"[direct] hedged /inference of 512 tokens cancelled once its first tokens "
              f"were out: cancel answered {cancelled}; finish_reason "
              f"{result.get('finish_reason')}, {result.get('usage', {}).get('completion_tokens')} "
              f"tokens", flush=True)
        if not (started and cancelled == (200, {"cancelled": True}) and status == 200
                and result["finish_reason"] == "abort"
                and result["usage"]["completion_tokens"] < 512):
            raise AssertionError("the hedged cancel did not abort the request")

        # ---- a dropped stream resumes from a pushed checkpoint: from the
        # admission checkpoint (no token yet) it must splice to exactly the
        # undropped run; from the latest (k tokens) to the same checkpoint
        # resumed with no drop, and to the undropped run over the k tokens
        n = 256
        sid = "smoke-resume"
        trace = LogitTrace(llm.engine)
        with trace.recording("undropped"):
            _, _, ref_ids, ref_text = split_stream(stream_events(
                port, {"type": "llm", "params": params(1, n)})[0])
        first, _, _ = stream_events(port, {"type": "llm", "params": params(1, n),
                                           "stream_id": sid}, limit=8)
        if not (wait_until(lambda: llm.engine.num_active == 0 and worker.active == 0)
                and wait_until(lambda: len(worker.checkpoints[sid]["state"]["generated"])
                               >= 8)):
            raise AssertionError("the dropped stream did not end with a checkpoint "
                                 "past the client's offset")
        admission, latest = worker.history[sid][0], worker.checkpoints[sid]
        k = len(latest["state"]["generated"])
        head_ids = [t for e in first for t in e["token_ids"]]
        head_text = "".join(e["text_delta"] for e in first)

        def resume(entry, offset, text_offset):
            worker.checkpoints[sid] = entry       # the resumed run pushes its own
            return split_stream(stream_events(port, {
                "type": "llm", "params": params(1, n), "resume": {
                    "stream_id": sid, "offset": offset, "text_offset": text_offset}})[0],
                first_offset=offset + 1)

        _, final, tail_ids, tail_text = resume(admission, 8, len(head_text))
        exact0 = (head_ids + tail_ids == ref_ids and head_text + tail_text == ref_text
                  and final["offset"] == n)
        print(f"[direct] a {n}-token stream dropped after 8 events, resumed at offset 8 "
              f"from its admission checkpoint ({len(admission['state']['generated'])} "
              f"tokens): offsets 9..{final['offset']} contiguous; ids and text equal to the "
              f"undropped run: {exact0}", flush=True)
        with trace.recording("resumed"):
            _, final, tail_ids, tail_text = resume(latest, 8, len(head_text))
        _, _, alone_ids, alone_text = resume(latest, 0, 0)
        spliced = head_ids + tail_ids
        exact = (spliced == alone_ids and head_text + tail_text == alone_text
                 and len(spliced) == n and final["offset"] == n)
        covered = spliced[:k] == ref_ids[:k]
        agree = next((i for i, (a, b) in enumerate(zip(spliced, ref_ids)) if a != b), n)
        witness = ""
        if agree < n:
            witness = (f"; at token {agree} the top-2 logits were, undropped: "
                       f"{trace.at('undropped', agree)}, resumed: "
                       f"{trace.at('resumed', agree - k)}")
        print(f"[direct] the same stream resumed at offset 8 from the latest checkpoint "
              f"({k} tokens): offsets 9..{final['offset']} contiguous; ids and text equal "
              f"to the same checkpoint resumed with no drop: {exact}; equal to the "
              f"undropped run over the checkpoint's {k} tokens: {covered}; (information) "
              f"equal to the undropped run for the first {agree} of {n} tokens (its {k} "
              f"tokens' KV was recomputed as one ragged prefill chunk, where the "
              f"undropped run wrote it in decode steps){witness}", flush=True)
        if not (exact0 and exact and covered):
            raise AssertionError(f"resumed {spliced} != {alone_ids} (undropped {ref_ids})")
        torch.cuda.synchronize()
        counts = pa.launch_counts()
    finally:
        server.stop()
        llm.checkpoint_sink = None
    print(f"[direct] kernel launches over the phase: {counts}", flush=True)
    check_counts("direct", counts, qmm=True)
    return ttft, gaps


def check_counts(tag, counts, qmm):
    """The kernels of a serving path all launched."""
    kernels = ["ragged_paged_attention", "paged_decode_attention_fused"] + (
        ["qmm_w8a16"] if qmm else [])
    if not all(counts[k] > 0 for k in kernels):
        raise AssertionError(f"[{tag}] a kernel of the path never launched: {counts}")


def small_parity(torch, pa, dev, nh, hkv, d):
    """Both attention kernels at a small model's head shape (bf16 pool)
    against their plain versions, with the phase-3 tolerances: a ragged
    round of a decode row, two 32-wide chunk rows and an empty row, then a
    decode step of the same rows. → (ragged, fused) max abs err."""
    from distributed_gpu_inference_torch.ops.attention import paged_attention_ref

    rng = np.random.default_rng(5)
    b, s, m = 4, 32, 8
    n = 1 + b * m
    t = lambda a, dt=torch.bfloat16: torch.tensor(a, dtype=dt, device=dev)  # noqa: E731
    kp = t(rng.standard_normal((2, n, hkv, BK, d)))
    vp = t(rng.standard_normal((2, n, hkv, BK, d)))
    tables = t(np.arange(1, n).reshape(b, m), torch.int32)
    lens = t([40, 90, 0, 128], torch.int32)
    pos = np.full((b, s), -1)
    pos[0, :1] = 39
    pos[1, :32] = np.arange(58, 90)
    pos[3, :32] = np.arange(96, 128)
    pos = t(pos, torch.int32)
    q = t(rng.standard_normal((b, s, nh, d)))
    got = pa.ragged_paged_attention(q, kp[1], vp[1], tables, pos, lens, BK)
    want = paged_attention_ref(q, kp[1], vp[1], tables, pos, lens, BK)
    r_ok, r_err, r_vec = errors(torch, got, want, RAGGED_ATOL)
    q1 = t(rng.standard_normal((b, 1, nh, d)))
    nk = t(rng.standard_normal((b, 1, hkv, d)))
    nv = t(rng.standard_normal((b, 1, hkv, d)))
    p1 = (lens - 1).clamp(min=-1)[:, None].to(torch.int32)
    kp2, vp2 = kp.clone(), vp.clone()
    got, _, _ = pa.paged_decode_attention_fused(q1, nk, nv, kp, vp, 1, tables, p1, lens, BK)
    want, _, _ = pa.paged_decode_attention_fused_plain(q1, nk, nv, kp2, vp2, 1, tables, p1,
                                                       lens, BK)
    d_ok, d_err, d_vec = errors(torch, got, want, FUSED_ATOL)
    pools = torch.equal(kp, kp2) and torch.equal(vp, vp2)
    print(f"[small] kernels at Nh {nh}, Hkv {hkv}, D {d}, bf16 pool: ragged max_abs_err "
          f"{r_err:.3e} max_vector_rel_err {r_vec:.3e} (bound atol {RAGGED_ATOL} rtol {RTOL}, "
          f"vector {VEC_REL}); fused decode max_abs_err {d_err:.3e} max_vector_rel_err "
          f"{d_vec:.3e} (bound atol {FUSED_ATOL}); pools bit-identical after the write: "
          f"{pools}", flush=True)
    if not (r_ok and d_ok and pools):
        raise AssertionError(f"an attention kernel disagrees at head_dim {d}")
    return r_err, d_err


def small_model_phase(torch, pa):
    """Phase 12: the worker's default model (llama3-mini, head_dim 32) on
    the card through both attention kernels, then both kernels timed at its
    head shape as phase 5 times llama3-8b's. → ((ragged, fused) max abs
    err, launches, (ragged, fused) times)."""
    from distributed_gpu_inference_torch.ops.attention import paged_attention_ref
    from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine

    llm = TorchLLMEngine({"model": "llama3-mini", "max_batch_size": 4, "max_seq_len": 256,
                          "device": "cuda", "seed": 0})
    llm.load_model()
    mc = llm.engine.model_cfg
    try:
        errs = small_parity(torch, pa, llm.engine.device, mc.num_heads, mc.num_kv_heads,
                            mc.head_dim)
        seen = []
        real_submit = llm.serving.submit

        def recording_submit(req, *a, **kw):
            resp = real_submit(req, *a, **kw)
            seen.append(list(resp.token_ids))
            return resp

        llm.serving.submit = recording_submit
        pa.reset_launch_counts()
        outs = [None] * 4

        def call(i):
            outs[i] = llm.inference({"prompt": f"small model request {i}",
                                     "max_new_tokens": 16, "ignore_eos": True})

        threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        torch.cuda.synchronize()
        counts = pa.launch_counts()
        del llm.serving.submit
    finally:
        llm.unload()
    print(f"[small] llama3-mini (head_dim {mc.head_dim}) on the card: 4 requests x 16 "
          f"tokens; launches {counts}", flush=True)
    if any(o is None or o["usage"]["completion_tokens"] != 16 for o in outs) or \
            len(seen) != 4 or not all(0 <= t < mc.vocab_size for ids in seen for t in ids):
        raise AssertionError(f"llama3-mini did not serve: {outs} {seen}")
    check_counts("small", counts, qmm=False)
    hs, dev = (mc.num_heads, mc.num_kv_heads, mc.head_dim), torch.device("cuda")
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    rcase = ragged_in(torch, ragged_round_case(torch, dev, hs=hs), "bf16")
    dcase = decode_in(torch, decode_case(torch, dev, hs=hs), "bf16")
    tag = f"[small times] Nh {hs[0]}, Hkv {hs[1]}, D {hs[2]}:"
    times = (ragged_times(torch, pa, paged_attention_ref, flush, f"{tag} ragged round 8x256",
                          rcase, "bf16", hs=hs),
             decode_times(torch, pa, flush, f"{tag} fused decode 8 rows", dcase, "bf16",
                          hs=hs))
    del flush, rcase, dcase
    torch.cuda.empty_cache()
    return errs, counts, times


# ---------------------------------------------------------------- the worker process

class StandInPlane:
    """The control plane's worker routes, as the JAX package's
    ``server/app.py`` handlers answer them, on ``http.server`` (127.0.0.1,
    port 0), keeping only the state those routes touch: register, verify,
    refresh-token, config, heartbeat, next-job, complete, release, job and
    stream checkpoints, going-offline and offline. Every
    request after registration must carry the worker's bearer token and an
    HMAC-SHA256 signature over METHOD:PATH:sha256(BODY):TIMESTAMP, checked
    here with ``hmac``/``hashlib``. Completions and checkpoints are fenced by
    ``assignment_epoch``; a checkpoint with ``migrate`` requeues the job
    with it and leaves its retry count alone. Its remote config is the
    plane's ``WorkerRemoteConfig`` with a fleet default of 8 concurrent
    jobs; :meth:`push_serving` bumps its version as ``PUT .../config``
    does. :meth:`hold` makes next-job answer 204 (no job).

    What a fleet needs (phase 18), as the plane's guarantee sweeps and
    registration handle it: with ``heartbeat_timeout_s``, :meth:`sweep`
    marks a worker whose last heartbeat is older than that offline and
    requeues its RUNNING jobs with their last checkpoint (an offline or
    draining worker claims nothing; a heartbeat revives it); a
    registration with a known fingerprint lands on the same row, and one
    with a new ``boot_id`` there requeues the dead
    incarnation's RUNNING jobs at once; a stream checkpoint is adopted by
    another worker through ``streams/<id>/adopt``, which bumps its epoch
    and so fences the old owner's later writes out. Every claim, requeue
    and fenced completion is logged with its time. It is a context
    manager and has the ``alive`` / ``port`` / ``sweep`` surface of a
    plane ``testing/harness.py`` ``LiveFleet`` takes."""

    def __init__(self, heartbeat_timeout_s=None):
        import secrets
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self._secrets = secrets
        self.lock = threading.Lock()
        self.workers, self.jobs, self.streams = {}, {}, {}
        self.registrations, self.heartbeats, self.migrations = [], [], []
        self.rejected = []              # (path, reason) of refused requests
        self.heartbeat_timeout_s = heartbeat_timeout_s
        # (time, job, worker, epoch, checkpoint tokens) of each claim;
        # (time, job, worker, reason, checkpoint tokens) of each requeue;
        # (time, job, worker, epoch) of each completion fenced by its epoch
        # and (time, job, worker, epoch) of each accepted completion
        self.claims, self.requeues, self.fenced, self.completed = [], [], [], []
        self.alive = True
        self.config = {"version": 1, "load_control": {
            "acceptance_rate": 1.0, "max_concurrent_jobs": 8, "max_jobs_per_hour": 0,
            "max_hbm_utilization": 0.9, "working_hours": None, "task_type_weights": {},
            "cooldown_seconds": 0.0, "max_queue_depth": 0, "tier_queue_fractions": {}},
            "security": {"require_signing": True, "token_ttl_hours": 168.0,
                         "allowed_ips": None},
            "model_configs": {}, "serving": {}, "updated_at": time.time()}
        self.held = False
        plane = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _answer(self, status, body=None):
                data = b"" if body is None else json.dumps(body).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _handle(self, method):
                raw = self.rfile.read(int(self.headers.get("Content-Length") or 0))
                try:
                    status, body = plane.route(method, self.path, raw, self.headers)
                except Exception as exc:  # noqa: BLE001 — a 500, as aiohttp answers
                    status, body = 500, {"detail": f"{type(exc).__name__}: {exc}"}
                self._answer(status, body)

            def do_GET(self):
                self._handle("GET")

            def do_POST(self):
                self._handle("POST")

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def stop(self):
        if not self.alive:
            return
        self.alive = False
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    def sweep(self):
        """One pass of the dead-worker sweep: a worker not offline whose
        last heartbeat is older than the timeout goes offline and its
        RUNNING jobs requeue with their checkpoints."""
        if self.heartbeat_timeout_s is None:
            return
        now = time.time()
        with self.lock:
            for w in self.workers.values():
                if w["status"] != "offline" \
                        and now - w["last_heartbeat"] > self.heartbeat_timeout_s:
                    w["status"] = "offline"
                    self._requeue_worker(w["id"], "heartbeat_stale")

    # -- the smoke's own side
    def queue_job(self, params):
        with self.lock:
            jid = f"job-{len(self.jobs)}"
            self.jobs[jid] = {"id": jid, "type": "llm", "params": params, "priority": 0,
                              "status": "queued", "worker_id": None, "assignment_epoch": 0,
                              "checkpoint": None, "result": None, "error": None,
                              "retry_count": 0, "created_at": time.time(),
                              "started_at": None, "completed_at": None}
            return jid

    def push_serving(self, **serving):
        with self.lock:
            self.config["serving"] = {**self.config["serving"], **serving}
            self.config["version"] += 1
            self.config["updated_at"] = time.time()

    def job(self, jid):
        with self.lock:
            return json.loads(json.dumps(self.jobs[jid]))

    def hold(self, held):
        self.held = held

    # -- the routes
    def _issue(self, w):
        for key in ("auth_token", "refresh_token", "signing_secret"):
            w[key] = self._secrets.token_hex(16)
        return {"auth_token": w["auth_token"], "refresh_token": w["refresh_token"],
                "signing_secret": w["signing_secret"]}

    def _authorized(self, w, method, path, raw, headers):
        import hashlib
        import hmac

        if headers.get("Authorization", "") != f"Bearer {w['auth_token']}":
            return "invalid token"
        ts = headers.get("X-Timestamp", "")
        msg = f"{method}:{path}:{hashlib.sha256(raw).hexdigest()}:{ts}"
        want = hmac.new(w["signing_secret"].encode(), msg.encode(),
                        hashlib.sha256).hexdigest()
        try:
            fresh = abs(time.time() - float(ts)) <= 300
        except ValueError:
            fresh = False
        if not (fresh and hmac.compare_digest(want, headers.get("X-Signature", ""))):
            return "invalid signature"
        return None

    def _requeue(self, job, reason="released"):
        self.requeues.append((time.time(), job["id"], job["worker_id"], reason,
                              len((job["checkpoint"] or {}).get("generated") or [])))
        job.update(status="queued", worker_id=None, started_at=None)

    def _requeue_worker(self, wid, reason):
        for job in self.jobs.values():
            if job["status"] == "running" and job["worker_id"] == wid:
                self._requeue(job, reason)

    def route(self, method, path, raw, headers):
        body = json.loads(raw) if raw else {}
        parts = path.split("?")[0].strip("/").split("/")
        if path == "/health":
            return 200, {"status": "ok"}
        if parts[:3] != ["api", "v1", "workers"] or len(parts) < 4:
            return 404, {"detail": "not found"}
        with self.lock:
            if parts[3] == "register" and method == "POST":
                return self._register(body)
            w = self.workers.get(parts[3])
            if w is None:
                return 404, {"detail": "worker not found"}
            rest = parts[4:]
            if rest == ["refresh-token"]:
                if body.get("refresh_token") != w["refresh_token"]:
                    return 401, {"detail": "invalid refresh token"}
                return 200, {"worker_id": w["id"], **self._issue(w)}
            why = self._authorized(w, method, path.split("?")[0], raw, headers)
            if why is not None:
                self.rejected.append((path, why))
                return 401, {"detail": why}
            return self._worker_route(w, method, rest, body)

    def _register(self, body):
        fp = body.get("machine_fingerprint")
        wid = body.get("worker_id") or next(
            (w["id"] for w in self.workers.values() if fp and w["fingerprint"] == fp),
            f"worker-{len(self.workers)}")
        old = self.workers.get(wid)
        if old is not None and old.get("boot_id") and body.get("boot_id") \
                and old["boot_id"] != body["boot_id"]:
            # a new process on the row: the old incarnation is dead
            self._requeue_worker(wid, "rejoin")
        w = {"id": wid, "fingerprint": fp, "boot_id": body.get("boot_id"),
             "topology": body.get("topology"), "status": "idle", "current_job_id": None,
             "last_heartbeat": time.time()}
        bundle = self._issue(w)
        self.workers[wid] = w
        self.registrations.append(body)
        return 200, {"worker_id": wid, **bundle, "config": self.config,
                     "heartbeat_interval_s": 30}

    def _worker_route(self, w, method, rest, body):
        if rest == ["verify"]:
            return 200, {"ok": True, "worker_id": w["id"]}
        if rest == ["config"] and method == "GET":
            return 200, json.loads(json.dumps(self.config))
        if rest == ["heartbeat"]:
            return self._heartbeat(w, body)
        if rest == ["next-job"]:
            if self.held or w["status"] in ("offline", "draining"):
                # an offline or draining worker claims nothing (the
                # scheduler's atomic_assign_job); a heartbeat revives it
                return 204, None
            job = next((j for j in self.jobs.values() if j["status"] == "queued"), None)
            if job is None:
                return 204, None
            job.update(status="running", worker_id=w["id"], started_at=time.time(),
                       assignment_epoch=job["assignment_epoch"] + 1)
            w.update(status="busy", current_job_id=job["id"])
            self.claims.append((time.time(), job["id"], w["id"], job["assignment_epoch"],
                                len((job["checkpoint"] or {}).get("generated") or [])))
            return 200, {"job": json.loads(json.dumps(job))}
        if rest == ["going-offline"]:
            w["status"] = "draining"
            return 200, {"ok": True, "drain": True}
        if rest == ["offline"]:
            w["status"] = "offline"
            requeued = []
            for job in self.jobs.values():
                if job["status"] == "running" and job["worker_id"] == w["id"]:
                    self._requeue(job, "offline")
                    requeued.append(job["id"])
            return 200, {"ok": True, "requeued_jobs": requeued}
        if len(rest) == 3 and rest[0] == "jobs":
            job = self.jobs.get(rest[1])
            if job is None or job["worker_id"] != w["id"]:
                if job is not None and rest[2] == "complete":
                    self.fenced.append((time.time(), job["id"], w["id"],
                                        body.get("assignment_epoch")))
                return 404, {"detail": "job not assigned to this worker"}
            return self._job_route(w, job, rest[2], body)
        if len(rest) == 3 and rest[0] == "streams" and rest[2] == "adopt":
            cur = self.streams.get(rest[1])
            if cur is None or cur["state"] is None:
                return 404, {"detail": f"no checkpoint for stream {rest[1]}"}
            cur.update(epoch=cur["epoch"] + 1, worker_id=w["id"])
            return 200, {"stream_id": rest[1], "checkpoint": cur["state"],
                         "epoch": cur["epoch"]}
        if len(rest) == 3 and rest[0] == "streams" and rest[2] == "checkpoint":
            sid = rest[1]
            if body.get("done"):
                self.streams.pop(sid, None)
                return 200, {"ok": True, "deleted": True}
            cur = self.streams.get(sid)
            if cur is not None and int(body.get("epoch") or 0) < cur["epoch"]:
                return 409, {"detail": f"stale stream epoch for {sid}"}
            self.streams[sid] = {"epoch": int(body.get("epoch") or 0),
                                 "state": body.get("state"), "worker_id": w["id"]}
            return 200, {"ok": True}
        return 404, {"detail": "not found"}

    def _heartbeat(self, w, body):
        self.heartbeats.append({"t": time.time(), "worker": w["id"], **body})
        w["status"] = body.get("status", w["status"])
        w["last_heartbeat"] = time.time()
        for cp in (body.get("checkpoints") or [])[:32]:
            job = self.jobs.get(str(cp.get("key")))
            if cp.get("kind") == "job" and job is not None and job["worker_id"] == w["id"] \
                    and job["status"] == "running" \
                    and int(cp.get("epoch") or 0) == job["assignment_epoch"]:
                job["checkpoint"] = cp.get("state")
        stale = [jid for jid in (body.get("active_job_ids") or [])
                 if self.jobs.get(jid, {}).get("worker_id") != w["id"]]
        out = {"ok": True, "config_changed":
               self.config["version"] > int(body.get("config_version") or 0),
               "stale_job": bool(body.get("current_job_id")) and self.jobs.get(
                   body["current_job_id"], {}).get("worker_id") != w["id"]}
        if stale:
            out["stale_jobs"] = stale
        ps = (body.get("engine_stats") or {}).get("prefix_summary")
        if ps is not None:
            # a full snapshot always applies; a delta only on the base it
            # was diffed against, else the worker resends in full
            base = w.get("summary_seq")
            ok = "full" in ps or ps.get("base_seq") == base
            if ok:
                w["summary_seq"] = ps.get("seq")
            out["prefix_summary_resync"] = not ok
        return 200, out

    def _job_route(self, w, job, action, body):
        if action == "release":
            if job["status"] == "running":
                self._requeue(job)
            return 200, {"status": "released"}
        epoch = body.get("assignment_epoch")
        if epoch is not None and int(epoch) != job["assignment_epoch"]:
            if action == "complete":
                self.fenced.append((time.time(), job["id"], w["id"], int(epoch)))
            return 409, {"detail": f"stale assignment epoch {epoch} "
                                   f"(job is at {job['assignment_epoch']})"}
        if action == "complete":
            if job["status"] != "running":
                done = "completed" if body.get("success", True) else "failed"
                return (200, {"ok": True, "duplicate": True}) if job["status"] == done \
                    else (409, {"detail": f"job is {job['status']}, not running"})
            job.update(status="completed" if body.get("success", True) else "failed",
                       result=body.get("result"), error=body.get("error"),
                       completed_at=time.time())
            self.completed.append((time.time(), job["id"], w["id"], job["assignment_epoch"]))
            w.update(status="idle", current_job_id=None)
            return 200, {"ok": True}
        if action == "checkpoint":
            if job["status"] != "running":
                return 409, {"detail": f"job is {job['status']}, not running"}
            if body.get("state") is not None:
                job["checkpoint"] = body["state"]
            if body.get("migrate"):
                self.migrations.append({"job": job["id"], "state": body.get("state")})
                self._requeue(job, "migrate")
            return 200, {"ok": True, "requeued": bool(body.get("migrate"))}
        return 404, {"detail": "not found"}


WORKER_JOB_TOKENS = 32       # greedy tokens of each polled job of phase 13
DRAIN_TOKENS = 256           # the job drained mid-run and resumed elsewhere


class RecordedIds:
    """The token ids of every response an engine's batcher returns (the
    job result payload carries text, not ids)."""

    def __init__(self, llm):
        self.serving, self.ids = llm.serving, []
        real = llm.serving.submit

        def submit(req, *a, **kw):
            resp = real(req, *a, **kw)
            self.ids.append((tuple(req.prompt_token_ids), list(resp.token_ids)))
            return resp

        llm.serving.submit = submit

    def close(self):
        # neither the wrapper nor this object may keep the engine alive
        del self.serving.submit
        self.serving = None


def start_cli_worker(config_path):
    """``worker/cli.py`` ``cmd_start`` on a thread (no signal handlers);
    → (thread, worker once its llm engine is loaded)."""
    import argparse

    from distributed_gpu_inference_torch.worker import cli

    box = []
    args = argparse.Namespace(config=str(config_path), log_level="WARNING")
    th = threading.Thread(target=cli.cmd_start, args=(args,),
                          kwargs={"on_worker": box.append}, daemon=True)
    th.start()
    if not wait_until(lambda: box and box[0].state.value == "idle"
                      and "llm" in box[0].engines, timeout=600):
        raise AssertionError("the CLI-started worker did not come up")
    return th, box[0]


def worker_phase(torch, pa, smi, prompts, model="llama3-8b", quantization="int8"):
    """Phase 13 (see the module docstring): the worker process started
    through its CLI against the stand-in plane; raises on any failed check.
    → the phase's information (job latencies, heartbeat round trips)."""
    import tempfile

    from distributed_gpu_inference_torch.utils import config as wconfig

    t_phase = time.perf_counter()
    plane = StandInPlane()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_worker_")
    workers = []
    try:
        # the JAX worker's file: YAML, written as save_worker_config writes it
        path = f"{tmp.name}/config.yaml"
        wconfig.save_worker_config(wconfig.build(wconfig.WorkerConfig, {
            "name": "chip-smoke", "server": {"url": plane.url},
            "engines": {"llm": {"model": model, "quantization": quantization}},
            "direct": {"enabled": True, "host": "127.0.0.1", "port": 0},
            "poll_interval_s": 0.05, "heartbeat_interval_s": 0.5,
            "load_control": {"max_concurrent_jobs": 8},
        }), path)
        with open(path) as f:
            first = f.readline().rstrip("\n")
        pa.reset_launch_counts()
        mem0 = torch.cuda.memory_allocated()
        th_a, wa = start_cli_worker(path)
        workers.append((th_a, wa))
        llm = wa.engines["llm"]
        vocab = llm.engine.model_cfg.vocab_size
        tok = llm.tokenizer
        reg = plane.registrations[-1]
        card = torch.cuda.get_device_name(0)
        print(f"[worker] worker A up through the CLI ({model}, {quantization} weights) from "
              f"the YAML config.yaml the port's save_worker_config wrote (its first line "
              f"{first!r}): registered as {wa.api.worker_id}, topology {reg['topology']}",
              flush=True)
        if reg["topology"]["chip_type"] != card:
            raise AssertionError(f"registered topology does not name the card {card}")
        # the credentials the registration wrote back read back equal, in YAML
        back = wconfig.load_worker_config(path, environ={}).server
        with open(path) as f:
            text = f.read()
        creds_ok = (back.worker_id, back.auth_token, back.refresh_token,
                    back.signing_secret) == (wa.api.worker_id, wa.api.auth_token,
                                             wa.api.refresh_token, wa.api.signing_secret)
        print(f"[worker] after registration config.yaml holds the issued credentials "
              f"(YAML, {len(text)} B, not JSON: {not text.lstrip().startswith('{')}); read "
              f"back equal to worker A's: {creds_ok}", flush=True)
        if not creds_ok or text.lstrip().startswith("{") or back.auth_token is None:
            raise AssertionError("the registered credentials did not read back from "
                                 "config.yaml")

        # ---- 8 polled jobs and one direct stream
        rec = RecordedIds(llm)
        stream = {}
        th_s = threading.Thread(target=lambda: stream.update(r=stream_events(
            wa._direct.port, {"type": "llm", "stream_id": "worker-stream", "params": {
                "prompt": prompts[0], "max_new_tokens": WORKER_JOB_TOKENS,
                "temperature": 0.0, "ignore_eos": True}})))
        th_s.start()
        wait_until(lambda: llm.engine.num_active > 0, timeout=60)
        jids = [plane.queue_job({"prompt": p, "max_new_tokens": WORKER_JOB_TOKENS,
                                 "temperature": 0.0, "ignore_eos": True,
                                 "trace_id": f"smoke-job-{i}"})
                for i, p in enumerate(prompts)]
        done = wait_until(lambda: all(plane.job(j)["status"] in ("completed", "failed")
                                      for j in jids), timeout=600)
        th_s.join(timeout=600)
        rec.close()
        jobs = [plane.job(j) for j in jids]
        if not done or any(j["status"] != "completed" for j in jobs):
            raise AssertionError(f"polled jobs: {[(j['status'], j['error']) for j in jobs]}")
        by_prompt = dict(rec.ids)
        for p, j in zip(prompts, jobs):
            ids = by_prompt.get(tuple(tok.encode(p)))
            usage = j["result"]["usage"]
            if ids is None or len(ids) != WORKER_JOB_TOKENS \
                    or not all(0 <= t < vocab for t in ids) \
                    or (usage["prompt_tokens"], usage["completion_tokens"]) != \
                    (len(tok.encode(p)), WORKER_JOB_TOKENS) \
                    or j["result"]["text"] != tok.decode(ids):
                raise AssertionError(f"job {j['id']}: ids {ids} result {j['result']}")
        _, final, s_ids, _ = split_stream(stream["r"][0])
        if len(s_ids) != WORKER_JOB_TOKENS or final["offset"] != WORKER_JOB_TOKENS:
            raise AssertionError(f"direct stream: {final}")
        latency = [(j["completed_at"] - j["created_at"]) * 1e3 for j in jobs]
        print(f"[worker] 8 polled jobs of {WORKER_JOB_TOKENS} greedy tokens completed with ids "
              f"in vocabulary, text = decode(ids), usage right; a direct stream of "
              f"{len(s_ids)} tokens beside them; queue-to-completion latency (information) "
              f"p50 {pctl(latency, 0.5):.1f} ms p95 {pctl(latency, 0.95):.1f} ms ({smi})",
              flush=True)

        # ---- a pushed serving knob reaches the live batcher
        plane.push_serving(target_step_ms=50.0)
        pushed = wait_until(
            lambda: llm.serving.batcher.cfg.target_step_latency_ms == 50.0, timeout=30)
        print(f"[worker] serving.target_step_ms 50 pushed through the plane's config: "
              f"live batcher target {llm.serving.batcher.cfg.target_step_latency_ms} ms",
              flush=True)
        if not pushed:
            raise AssertionError("the pushed serving config did not reach the batcher")

        # ---- drain: a long job migrates once a heartbeat checkpoints it
        before = wa.stats["jobs_migrated"]
        drain_params = {"prompt": prompts[1], "max_new_tokens": DRAIN_TOKENS,
                        "temperature": 0.0, "ignore_eos": True}
        jd = plane.queue_job(drain_params)
        if not wait_until(lambda: len((plane.job(jd)["checkpoint"] or {}).get(
                "generated", [])) >= 8, timeout=300):
            raise AssertionError("no heartbeat checkpoint of 8 tokens for the long job")
        hb_k = len(plane.job(jd)["checkpoint"]["generated"])
        mem_loaded = torch.cuda.memory_allocated()
        wa.request_shutdown()
        th_a.join(timeout=300)
        mig = [m for m in plane.migrations if m["job"] == jd]
        k = len(mig[0]["state"]["generated"]) if mig else 0
        # the card's memory handed back: no more than 256 MiB above where
        # the phase began
        unloaded = (llm.engine is None and llm.serving is None and not llm.loaded
                    and torch.cuda.memory_allocated() <= mem0 + (256 << 20))
        print(f"[worker] drain: heartbeat checkpoint of {hb_k} tokens, then request_shutdown: "
              f"jobs_migrated +{wa.stats['jobs_migrated'] - before}, plane got migrate=True "
              f"with a {k}-token checkpoint; job {plane.job(jd)['status']}; worker A "
              f"{plane.workers[wa.api.worker_id]['status']} and unloaded: {unloaded}; "
              f"device memory {mem_loaded / 2**30:.1f} -> "
              f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB", flush=True)
        if th_a.is_alive() or wa.stats["jobs_migrated"] != before + 1 or len(mig) != 1 \
                or k < 8 or plane.job(jd)["status"] != "queued" \
                or plane.job(jd)["checkpoint"] != mig[0]["state"] \
                or plane.workers[wa.api.worker_id]["status"] != "offline" or not unloaded:
            raise AssertionError("the drained job did not migrate cleanly")
        hbs = [h for h in plane.heartbeats if h["worker"] == wa.api.worker_id]
        es = [h.get("engine_stats") or {} for h in hbs]
        # the flight recorder's record of the traced jobs, for phase 14 (h)
        flight = {"timelines": [(f"smoke-job-{i}", j["result"].get("timeline"))
                                for i, j in enumerate(jobs)],
                  "beats": [e["flight"] for e in es if "flight" in e]}
        checks = {
            "capacity": any((e.get("batcher") or {}).get("capacity") == 8 for e in es),
            "prefix_summary": any(e.get("prefix_summary") for e in es),
            "checkpoints": any(any(c.get("kind") == "job" for c in h.get("checkpoints") or [])
                               for h in hbs),
            "batched": any(max((e.get("batcher") or {}).get("active_slots", 0),
                               (e.get("batcher") or {}).get("avg_occupancy", 0)) > 1
                           for e in es),
        }
        rtt = [h["hb_rtt_ms"] for h in hbs if "hb_rtt_ms" in h]
        print(f"[worker] worker A's {len(hbs)} heartbeats: {checks}; round trip (information) "
              f"p50 {pctl(rtt, 0.5):.2f} ms p95 {pctl(rtt, 0.95):.2f} ms ({smi})", flush=True)
        if not all(checks.values()):
            raise AssertionError(f"heartbeats lack a part: {checks}")

        # ---- worker B: same config file, persisted credentials
        plane.hold(True)
        th_b, wb = start_cli_worker(path)
        workers.append((th_b, wb))
        llm_b = wb.engines["llm"]
        trace = LogitTrace(llm_b.engine)
        rec_b = RecordedIds(llm_b)
        with trace.recording("resumed"):
            plane.hold(False)
            if not wait_until(lambda: plane.job(jd)["status"] == "completed", timeout=600):
                raise AssertionError(f"worker B did not complete the migrated job: "
                                     f"{plane.job(jd)}")
        with trace.recording("undropped"):
            ju = plane.queue_job(drain_params)
            if not wait_until(lambda: plane.job(ju)["status"] == "completed", timeout=600):
                raise AssertionError("worker B did not complete the undropped run")
        rec_b.close()
        (_, resumed), (_, undropped) = rec_b.ids
        ckpt = mig[0]["state"]["generated"]
        same_id = wb.api.worker_id == wa.api.worker_id and wb.boot_id != wa.boot_id
        usage = plane.job(jd)["result"]["usage"]
        agree = next((i for i, (a, b) in enumerate(zip(resumed, undropped)) if a != b),
                     DRAIN_TOKENS)
        witness = ""
        if agree < DRAIN_TOKENS:
            witness = (f"; at token {agree} the top-2 logits were, undropped: "
                       f"{trace.at('undropped', agree)}, resumed: "
                       f"{trace.at('resumed', agree - k)}")
        print(f"[worker] worker B from the same config: worker id kept {same_id} (new boot_id, "
              f"{len(plane.registrations)} registration in all); it claimed the requeued job "
              f"with its {k}-token checkpoint and completed it: {usage['completion_tokens']} "
              f"tokens, the first {k} equal to the checkpoint's: {resumed[:k] == ckpt}; "
              f"(information) equal to an undropped run of the same job for the first "
              f"{agree} of {DRAIN_TOKENS} tokens{witness}", flush=True)
        if not (same_id and len(plane.registrations) == 1 and resumed[:k] == ckpt
                and usage["completion_tokens"] == DRAIN_TOKENS
                and len(resumed) == DRAIN_TOKENS
                and all(0 <= t < vocab for t in resumed)):
            raise AssertionError("worker B did not resume the migrated job")
        wb.request_shutdown()
        th_b.join(timeout=300)
        if th_b.is_alive() or plane.rejected:
            raise AssertionError(f"worker B did not stop, or requests were refused: "
                                 f"{plane.rejected}")
        torch.cuda.synchronize()
        counts = pa.launch_counts()
    finally:
        for th, w in workers:
            if th.is_alive():
                w.request_shutdown()
                th.join(timeout=120)
        plane.stop()
        tmp.cleanup()
    print(f"[worker] kernel launches over the phase: {counts}; phase ran in "
          f"{time.perf_counter() - t_phase:.1f} s ({smi})", flush=True)
    check_counts("worker", counts, qmm=quantization is not None)
    return latency, rtt, counts, flight


# ---------------------------------------------------------------- serving under pressure

SPILL_POOL_BLOCKS = 64      # the engine's block budget (63 usable, 16 tokens a block)
SPILL_PROMPT_TOKENS = 192   # prompt A: 12 full blocks, 11 restorable (one stays fresh)
SPILL_RESTORED = SPILL_PROMPT_TOKENS // BK - 1
SPILL_TOKENS = 16           # greedy tokens of each run of A and of each filler
SPILL_FILLERS = 24          # at most this many fillers to evict A
SPILL_HOST_BLOCKS = 64      # the L2 tier's blocks
DEADLINE_JOBS, DEADLINE_TOKENS, DEADLINE_HOPELESS = 8, 32, 128
PCIE_BYTES = 64e9           # PCIe Gen5 x16, one direction (bytes/s)


class RespStandIn:
    """A RESP2 store on 127.0.0.1 (port 0): GET, SET (PX accepted, not
    enforced), DEL, PING, SELECT and AUTH, one thread a connection — what
    the L3 tier's client (``runtime/redis_kv.py``) speaks. The card's
    machine has no redis server."""

    def __init__(self):
        import socket

        self.data = {}
        self.lock = threading.Lock()
        self.sock = socket.socket()
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(16)
        self.port = self.sock.getsockname()[1]
        self.conns = []
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def stop(self):
        self.sock.close()
        for conn in self.conns:
            conn.close()
        self.thread.join(timeout=10)

    def _serve(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            self.conns.append(conn)
            threading.Thread(target=self._client, args=(conn,), daemon=True).start()

    def _client(self, conn):
        f = conn.makefile("rb")
        try:
            while True:
                line = f.readline()
                if not line:
                    return
                args = []
                for _ in range(int(line[1:])):
                    n = int(f.readline()[1:])
                    args.append(f.read(n + 2)[:-2])
                conn.sendall(self._dispatch(args))
        except (OSError, ValueError):
            pass
        finally:
            conn.close()

    def _dispatch(self, args):
        cmd = args[0].upper()
        with self.lock:
            if cmd == b"PING":
                return b"+PONG\r\n"
            if cmd in (b"AUTH", b"SELECT"):
                return b"+OK\r\n"
            if cmd == b"SET":
                self.data[args[1]] = args[2]
                return b"+OK\r\n"
            if cmd == b"GET":
                v = self.data.get(args[1])
                return b"$-1\r\n" if v is None else b"$%d\r\n%s\r\n" % (len(v), v)
            if cmd == b"DEL":
                return b":%d\r\n" % int(self.data.pop(args[1], None) is not None)
        return b"-ERR unknown command\r\n"


def same_bits(torch, a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


class PageWitness:
    """Holds the engine's batched spill transfers to the pools: each page
    the batched download brings to the host is compared with the pool page
    read by plain indexing (before the block id is reused), and each
    batched upload is read back from the pools. ``restored`` keeps the read
    backs of the last upload, in block order."""

    def __init__(self, torch, engine):
        self.torch, self.engine = torch, engine
        self.downloaded, self.restored, self.mismatch = 0, [], []
        pull, push = engine.pull_pages, engine.push_pages
        kv = engine.kv

        def pull_checked(bids):
            out = pull(bids)
            for b, (page, scale) in zip(bids, out):
                direct = torch.stack((kv["k"][:, b], kv["v"][:, b]), 1).cpu()
                ok = same_bits(torch, page, direct)
                if scale is not None:
                    ok = ok and same_bits(torch, scale, torch.stack(
                        (kv["k_scale"][:, b], kv["v_scale"][:, b]), 1).cpu())
                if not ok:
                    self.mismatch.append(("download", b))
            self.downloaded += len(bids)
            return out

        def push_checked(bids, pages, scales):
            push(bids, pages, scales)
            back = pull(bids)
            for b, page, scale, (bp, bs) in zip(bids, pages, scales, back):
                if not same_bits(torch, page, bp) or (
                        scale is not None and not same_bits(torch, scale, bs)):
                    self.mismatch.append(("upload", b))
            self.restored = back

        engine.pull_pages, engine.push_pages = pull_checked, push_checked

    def close(self):
        del self.engine.pull_pages, self.engine.push_pages
        self.engine = None


def serve_ids(llm, text, n, **params):
    """One request through ``TorchLLMEngine.inference`` → (greedy ids, the
    result payload)."""
    rec = RecordedIds(llm)
    try:
        out = llm.inference({"prompt": text, "max_new_tokens": n, "temperature": 0.0,
                             "ignore_eos": True, **params})
    finally:
        rec.close()
    (_, ids), = rec.ids
    return ids, out


def spill_text(seed, n=SPILL_PROMPT_TOKENS):
    rng = np.random.default_rng(seed)
    return "".join(rng.choice(np.array(list("abcdefghijklmnopqrstuvwxyz ,.")), n))


def transfer_times(torch, engine, bids):
    """Median wall time (CUDA events around the call, 30 calls) of the
    batched download and upload of the pages of ``bids`` (free blocks: the
    upload writes back what the download read) → (D2H ms, H2D ms, bytes
    moved each way, bytes of the same pages on the L3 wire)."""
    pages = engine.pull_pages(bids)
    moved = sum(p.numel() * p.element_size()
                + (0 if s is None else s.numel() * s.element_size()) for p, s in pages)
    wire = sum(p.numel() * p.element_size()
               + (0 if s is None else s.numel() * s.element_size() * p.shape[-1])
               for p, s in pages)

    def timed(fn):
        out = []
        for _ in range(30):
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            fn()
            t1.record()
            t1.synchronize()
            out.append(t0.elapsed_time(t1))
        return float(np.median(out))

    d2h = timed(lambda: engine.pull_pages(bids))
    h2d = timed(lambda: engine.push_pages(bids, [p for p, _ in pages], [s for _, s in pages]))
    return d2h, h2d, moved, wire


def spill_restore_check(torch, llm, keys, tag):
    """Checks (a)-(c) of phase 14 (see the module docstring) on a loaded
    ``TorchLLMEngine`` with an L2 tier: A served twice (the second run hits
    the radix: the L1-hit reference), fillers until A's restorable blocks
    are all spilled (each download bitwise equal to its pool page), then A
    served from L2 with the restored pool pages bitwise equal to the
    spilled ones and the stream equal to the reference. → (the cold
    stream, the reference, ``restore_from(tier, prepare)`` for the later
    tiers, the witness to close)."""
    eng, mgr = llm.engine, llm.engine.manager
    text = spill_text(0)
    spilled = {}
    store = mgr.store_spilled

    def record(key, page, scale=None):
        spilled[key] = (page, scale)
        store(key, page, scale)

    mgr.store_spilled = record
    witness = PageWitness(torch, eng)

    def restore_from(tier, prepare):
        """``prepare()``, then A served again → (hits of ``tier``, restored
        pages bitwise equal to the spilled ones, ids, payload)."""
        prepare()
        witness.restored = []
        before = mgr.get_stats()[f"{tier}_hits"]
        ids, out = serve_ids(llm, text, SPILL_TOKENS)
        hits = mgr.get_stats()[f"{tier}_hits"] - before
        same = len(witness.restored) == len(keys) and all(
            same_bits(torch, p, spilled[k][0])
            and (s is None or same_bits(torch, s, spilled[k][1]))
            for k, (p, s) in zip(keys, witness.restored))
        return hits, same and not witness.mismatch, ids, out

    try:
        cold, _ = serve_ids(llm, text, SPILL_TOKENS)
        ref, out = serve_ids(llm, text, SPILL_TOKENS)
        if out["usage"]["cached_tokens"] != SPILL_RESTORED * BK:
            raise AssertionError(f"[spill] {tag}: the second run of A did not hit the "
                                 f"radix: {out['usage']}")
        print(f"[spill] {tag} (a): A ({SPILL_PROMPT_TOKENS} tokens) served, then again as the "
              f"L1-hit reference ({out['usage']['cached_tokens']} tokens cached)", flush=True)
        spills0, fillers = mgr.get_stats()["spills"], 0
        while not set(keys) <= set(spilled) and fillers < SPILL_FILLERS:
            serve_ids(llm, spill_text(100 + fillers), SPILL_TOKENS)
            fillers += 1
        spills = mgr.get_stats()["spills"] - spills0
        print(f"[spill] {tag} (b): {fillers} fillers evicted A: spills +{spills}, "
              f"{witness.downloaded} pages downloaded, each bitwise equal to its pool page: "
              f"{not witness.mismatch}", flush=True)
        if not set(keys) <= set(spilled) or spills < len(keys) or witness.mismatch:
            raise AssertionError(f"[spill] {tag}: A's blocks were not all spilled intact: "
                                 f"{len(set(keys) & set(spilled))} of {len(keys)}, "
                                 f"{witness.mismatch}")
        hits, same, ids, out = restore_from("l2", lambda: None)
        print(f"[spill] {tag} (c): A served from L2: l2_hits +{hits}, restored pool pages "
              f"bitwise equal to the spilled ones: {same}; greedy stream equal to the L1-hit "
              f"reference: {ids == ref}", flush=True)
        if hits != len(keys) or not same or ids != ref \
                or out["usage"]["cached_tokens"] != SPILL_RESTORED * BK:
            raise AssertionError(f"[spill] {tag}: the L2 restore failed: hits {hits}, pages "
                                 f"{same}, stream {ids} vs {ref}")
    except BaseException:
        witness.close()
        raise
    return cold, ref, restore_from, witness


def spill_phase(torch, pa, smi, kv_cache_dtype, resp, model="llama3-8b",
                quantization="int8", device="cuda"):
    """Phase 14 (see the module docstring) for one KV pool dtype; raises on
    any failed check."""
    import types

    from distributed_gpu_inference_torch.testing import faults
    from distributed_gpu_inference_torch.utils.data_structures import compute_prefix_hash
    from distributed_gpu_inference_torch.worker import main as worker_main
    from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine

    t_phase = time.perf_counter()
    tag = f"{model}, {quantization or 'bf16'} weights, {kv_cache_dtype or 'bf16'} pool"
    llm = TorchLLMEngine({
        "model": model, "quantization": quantization, "kv_cache_dtype": kv_cache_dtype,
        "max_batch_size": DEADLINE_JOBS, "max_seq_len": 512,
        "num_blocks": SPILL_POOL_BLOCKS, "kv_spill_host_blocks": SPILL_HOST_BLOCKS,
        "kv_remote_url": f"redis://127.0.0.1:{resp.port}", "device": device, "seed": 0,
        "prefix_summary_top_n": 0})
    llm.load_model()
    eng, mgr = llm.engine, llm.engine.manager
    keys = [compute_prefix_hash(llm.tokenizer.encode(spill_text(0)), (i + 1) * BK)
            for i in range(SPILL_RESTORED)]
    witness = None
    try:
        pa.reset_launch_counts()
        cold, ref, restore_from, witness = spill_restore_check(torch, llm, keys, tag)

        # ---- (d) L2 cleared: A from L3 over RESP
        def drop_l1_and_l2():
            mgr.remote_store.flush()
            mgr.clear_cached(spill=False)
            for k in keys:
                mgr.host_store.delete(k)

        hits, same, ids, _ = restore_from("l3", drop_l1_and_l2)
        print(f"[spill] {tag} (d): L2 cleared, A served from L3 over RESP: l3_hits +{hits}, "
              f"restored pool pages bitwise equal to the spilled ones: {same}; stream equal "
              f"to the L1-hit reference: {ids == ref}", flush=True)
        if hits != len(keys) or not same or ids != ref:
            raise AssertionError(f"[spill] {tag}: the L3 restore failed: hits {hits}, "
                                 f"pages {same}, stream {ids} vs {ref}")

        # ---- (e) a corrupt L3 entry: quarantined, A recomputed
        drop_l1_and_l2()
        stored = resp.data[b"dgi:kv:" + keys[0].encode()]
        i = len(stored) // 2
        resp.data[b"dgi:kv:" + keys[0].encode()] = \
            stored[:i] + bytes([stored[i] ^ 0xFF]) + stored[i + 1:]
        q0 = mgr.spill_io["remote_quarantined_corrupt"]
        ids, out = serve_ids(llm, spill_text(0), SPILL_TOKENS)
        mgr.remote_store.flush()
        quarantined = mgr.spill_io["remote_quarantined_corrupt"] - q0
        gone = b"dgi:kv:" + keys[0].encode() not in resp.data
        print(f"[spill] {tag} (e): one L3 entry corrupted: remote_quarantined_corrupt "
              f"+{quarantined}, deleted from the store: {gone}; A recomputed "
              f"({out['usage']['cached_tokens']} tokens restored), stream equal to the cold "
              f"run: {ids == cold}", flush=True)
        if quarantined != 1 or not gone or ids != cold or out["usage"]["cached_tokens"]:
            raise AssertionError(f"[spill] {tag}: the corrupt entry was not quarantined "
                                 f"cleanly")

        # ---- (f) host-tier puts fail: the breaker trips, serving goes on
        rule = faults.FaultRule("io.spill.host.put", "error")
        served = 0
        with faults.active(faults.FaultPlan(seed=0, rules=[rule])):
            while served < SPILL_FILLERS and not (
                    mgr.breakers["host"].trips and mgr.spill_io["host_put_errors"] >= 3):
                ids, out = serve_ids(llm, spill_text(1000 + served), SPILL_TOKENS)
                if len(ids) != SPILL_TOKENS:
                    raise AssertionError(f"[spill] {tag}: serving failed under the fault")
                served += 1
        block = worker_main.Worker._kv_spill_engine_stats(
            types.SimpleNamespace(engines={"llm": llm}))
        print(f"[spill] {tag} (f): io.spill.host.put failing: {served} requests served in "
              f"full; heartbeat kv_spill block {block}", flush=True)
        if not block or block.get("host_put_errors", 0) < 3 \
                or block.get("breaker_host_trips", 0) < 1 \
                or "breaker_host_state" not in block:
            raise AssertionError(f"[spill] {tag}: the kv_spill block lacks the breaker trip")

        # ---- (g) deadlines: one of 8 concurrent requests cannot meet its
        llm.apply_serving_config({"abandon_deadlines": True, "deadline_grace_s": 0.0})
        if not wait_until(lambda: llm.serving.batcher.cfg.abandon_deadlines, timeout=30):
            raise AssertionError("abandon_deadlines did not reach the live batcher")
        if not wait_until(lambda: eng.num_active == 0, timeout=60):
            raise AssertionError("the engine did not go idle")
        reclaim0 = mgr.num_reclaimable
        abandoned0 = llm.serving_stats()["abandoned"]
        rec = RecordedIds(llm)
        results = [None] * DEADLINE_JOBS
        texts = [spill_text(2000 + i, 48) for i in range(DEADLINE_JOBS)]

        def run(i):
            params = {"prompt": texts[i], "max_new_tokens": DEADLINE_TOKENS,
                      "temperature": 0.0, "ignore_eos": True}
            if i == 3:
                params.update(max_new_tokens=DEADLINE_HOPELESS, deadline_s=0.05)
            try:
                results[i] = llm.inference(params)
            except Exception as exc:  # noqa: BLE001 — the typed error is the result
                results[i] = exc

        threads = [threading.Thread(target=run, args=(i,)) for i in range(DEADLINE_JOBS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        rec.close()
        idle = wait_until(lambda: eng.num_active == 0, timeout=60)
        vocab = eng.model_cfg.vocab_size
        hopeless_prompt = tuple(llm.tokenizer.encode(texts[3]))
        done = [ids for p, ids in rec.ids
                if p != hopeless_prompt and len(ids) == DEADLINE_TOKENS]
        hopeless = results[3]
        abandoned = llm.serving_stats()["abandoned"] - abandoned0
        print(f"[spill] {tag} (g): {DEADLINE_JOBS} concurrent requests, one with a 0.05 s "
              f"deadline for {DEADLINE_HOPELESS} tokens: {type(hopeless).__name__} "
              f"{getattr(hopeless, 'error_code', None)}; abandoned +{abandoned}; "
              f"{len(done)} others finished {DEADLINE_TOKENS} tokens in vocabulary: "
              f"{all(0 <= t < vocab for ids in done for t in ids)}; reclaimable blocks "
              f"{reclaim0} -> {mgr.num_reclaimable}", flush=True)
        if getattr(hopeless, "error_code", None) != "deadline_abandoned" or abandoned != 1 \
                or len(done) != DEADLINE_JOBS - 1 \
                or not all(isinstance(r, dict) for i, r in enumerate(results) if i != 3) \
                or not all(0 <= t < vocab for ids in done for t in ids) \
                or not idle or mgr.num_reclaimable != reclaim0:
            raise AssertionError(f"[spill] {tag}: deadline abandonment failed: {results}")

        if device == "cuda":
            torch.cuda.synchronize()
        counts = pa.launch_counts()
        witness.close()
        witness = None
        # ---- information: the batched page transfers over PCIe (free
        # blocks, the engine idle, the cache dropped so that A's 11 fit)
        if device == "cuda":
            mgr.clear_cached(spill=False)
            free = list(mgr.free_list[-SPILL_RESTORED:])
            for bids in (free[:1], free):
                d2h, h2d, moved, wire = transfer_times(torch, eng, bids)
                print(f"[spill] {tag}: {len(bids)} page(s), {moved / 2**20:.3f} MiB moved each "
                      f"way ({wire / 2**20:.3f} MiB on the L3 wire): D2H {d2h:.4f} ms "
                      f"({moved / d2h / 1e6:.2f} GB/s), H2D {h2d:.4f} ms "
                      f"({moved / h2d / 1e6:.2f} GB/s); bound {moved / PCIE_BYTES * 1e3:.4f} ms "
                      f"at 64 GB/s ({smi})", flush=True)
    finally:
        if witness is not None:
            witness.close()
        llm.unload()
    print(f"[spill] {tag}: kernel launches over the phase: {counts}; phase ran in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    check_counts("spill", counts, qmm=quantization is not None)


def flight_check(flight):
    """Check (h) of phase 14: phase 13's traced jobs came back with their
    timelines — the batcher's events present and in causal order — and the
    plane's heartbeats carried the flight block."""
    order = ["batcher.enqueued", "batcher.admitted", "batcher.first_token",
             "batcher.completed", "worker.done"]
    bad = []
    for tid, wire in flight["timelines"]:
        if not wire or wire.get("trace_id") != tid:
            bad.append((tid, "no timeline"))
            continue
        first = {}
        for name, ts, _ in wire["events"]:
            first.setdefault(name, ts)
        if not all(n in first for n in order) \
                or [first[n] for n in order] != sorted(first[n] for n in order):
            bad.append((tid, [e[0] for e in wire["events"]]))
    beats = flight["beats"]
    timelines = max((b.get("timelines", 0) for b in beats), default=0)
    print(f"[flight] (h): {len(flight['timelines'])} traced jobs of phase 13 came back with "
          f"timelines in causal order: {not bad}; the plane got engine_stats['flight'] in "
          f"{len(beats)} heartbeats ({timelines} timelines)", flush=True)
    if bad or timelines < len(flight["timelines"]):
        raise AssertionError(f"[flight] timelines: {bad}, heartbeat counts {timelines}")


# ---------------------------------------------------------------- speculative decoding

SPEC_K = 4                  # draft tokens a verify round (phase 15)
SPEC_TOKENS = 32            # greedy tokens of each phase-15 request
SPEC_ORACLE_TOKENS = 64     # tokens of each request at each oracle rate
SPEC_ORACLE_RATES = (0.0, 0.5, 1.0)
SPEC_WIDTHS = (4, 2, 2)     # the standalone tree decoder's widths
# a top-2 logit gap below which bf16 rounding may pick either token: the
# verify rows run the ragged kernel where plain decode runs the fused one
NEAR_TIE = 0.05
SPEC_SAMPLES = 10           # CUDA-event samples of each per-round time


class SpecRoutes:
    """While installed: the row count M of every quantized-matmul call by
    route (the kernel's launch or the library route) and the query width
    of every ragged-kernel call of the model. Wraps module functions their
    callers look up at call time; the kernels count their own launches as
    before."""

    def __init__(self):
        from distributed_gpu_inference_torch.models import llama
        from distributed_gpu_inference_torch.ops import qmm

        self.kernel_m, self.library_m, self.ragged_s = {}, {}, {}
        self._sites = [(qmm, "_launch", self.kernel_m, lambda a: a[0].shape[0]),
                       (qmm, "_library_route", self.library_m, lambda a: a[0].shape[0]),
                       (llama, "ragged_paged_attention", self.ragged_s,
                        lambda a: a[0].shape[1])]
        self._real = [getattr(mod, name) for mod, name, _, _ in self._sites]
        for (mod, name, store, key_of), fn in zip(self._sites, self._real):
            def counted(*a, _fn=fn, _store=store, _key=key_of, **kw):
                k = _key(a)
                _store[k] = _store.get(k, 0) + 1
                return _fn(*a, **kw)

            setattr(mod, name, counted)

    def close(self):
        for (mod, name, _, _), fn in zip(self._sites, self._real):
            setattr(mod, name, fn)


def spec_serve(torch, pa, llm, prompts, n):
    """``prompts`` as one ``TorchLLMEngine.batch_inference`` call (every
    request in the batcher's first admission) of ``n`` greedy tokens each,
    the launch counters zeroed just before and read just after. → (rows of
    (prompt ids, token ids) in prompt order, wall seconds, launches,
    :class:`SpecRoutes`)."""
    futs = []
    real = llm.serving.submit_async

    def submit_async(req, *a, **kw):
        fut = real(req, *a, **kw)
        futs.append((tuple(req.prompt_token_ids), fut))
        return fut

    llm.serving.submit_async = submit_async
    pa.reset_launch_counts()
    routes = SpecRoutes()
    try:
        t0 = time.perf_counter()
        outs = llm.batch_inference([{"prompt": p, "max_new_tokens": n, "temperature": 0.0,
                                     "ignore_eos": True} for p in prompts])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = pa.launch_counts()
    finally:
        routes.close()
        del llm.serving.submit_async     # the wrapper would keep the engine alive
    ids = {k: list(f.result().token_ids) for k, f in futs}
    rows = [(list(k), ids[k]) for k in (tuple(llm.tokenizer.encode(p)) for p in prompts)]
    vocab = llm.engine.model_cfg.vocab_size
    if any(o["usage"]["completion_tokens"] != n for o in outs) or \
            any(len(t) != n or not all(0 <= x < vocab for x in t) for _, t in rows):
        raise AssertionError(f"speculative serving returned bad tokens: {rows}")
    return rows, wall, counts, routes


def rescore(torch, engine, rows, chunk=256):
    """One teacher-forced pass of each (prompt ids, tokens) row through the
    engine's model: ``forward_chunk`` over prompt + tokens in chunks of
    ``chunk`` on a scratch pool of the engine's KV dtype, through the
    kernels. → per row, per token: (the target's argmax there, its
    runner-up, the top-2 logit gap, how far the token's own logit lies
    below the argmax's)."""
    from distributed_gpu_inference_torch.models import llama

    cfg, dev, bs = engine.model_cfg, engine.device, engine.cfg.block_size
    seqs = [list(p) + list(t) for p, t in rows]
    b, longest = len(seqs), max(len(s) for s in seqs)
    m = -(-longest // bs)
    kv = llama.init_kv_pools(cfg, 1 + b * m, bs, engine.kv_dtype, dev)
    tables = torch.arange(1, 1 + b * m, dtype=torch.int32, device=dev).reshape(b, m)
    lens = np.asarray([len(s) for s in seqs])
    top = np.zeros((b, longest, 2), np.int64)
    gap, deficit = np.zeros((b, longest)), np.zeros((b, longest))
    t = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)  # noqa: E731
    with torch.no_grad():
        for c0 in range(0, longest, chunk):
            toks = np.zeros((b, chunk), np.int32)
            nxt = np.zeros((b, chunk), np.int64)      # the token each position predicts
            pos = np.full((b, chunk), -1, np.int32)
            for i, s in enumerate(seqs):
                part = s[c0:c0 + chunk]
                toks[i, :len(part)] = part
                follow = s[c0 + 1:c0 + chunk + 1]
                nxt[i, :len(follow)] = follow
                pos[i, :len(part)] = np.arange(c0, c0 + len(part))
            out = llama.forward_chunk(cfg, engine.params, t(toks), t(pos), kv, tables,
                                      t(np.minimum(lens, c0 + chunk)), block_size=bs,
                                      last_only=False, allow_fused=False)
            vals, idx = out.logits.topk(2, dim=-1)
            own = out.logits.gather(-1, torch.from_numpy(nxt).to(dev)[..., None])[..., 0]
            n = min(chunk, longest - c0)
            top[:, c0:c0 + n] = idx[:, :n].cpu().numpy()
            gap[:, c0:c0 + n] = (vals[..., 0] - vals[..., 1])[:, :n].float().cpu().numpy()
            deficit[:, c0:c0 + n] = (vals[..., 0] - own)[:, :n].float().cpu().numpy()
            del out, vals, idx, own
    del kv
    # the logits at position q predict the token at q + 1
    return [[(int(top[i, q, 0]), int(top[i, q, 1]), float(gap[i, q]), float(deficit[i, q]))
             for q in range(len(p) - 1, len(p) - 1 + len(toks_))]
            for i, (p, toks_) in enumerate(rows)]


def greedy_misses(rows, scores):
    """Tokens that are not the target's greedy choice → (violations, near-tie
    exceptions), each [(row, index, token, argmax, its logit's deficit)]:
    an exception is a token whose logit lies less than NEAR_TIE below the
    argmax's (so that position's top-2 gap is below NEAR_TIE too)."""
    bad, ties = [], []
    for r, ((_, toks), sc) in enumerate(zip(rows, scores)):
        for j, (tok, (first, _, _, short)) in enumerate(zip(toks, sc)):
            if tok != first:
                (ties if short < NEAR_TIE else bad).append((r, j, tok, first, short))
    return bad, ties


def fork_deficits(rows, want_rows, runs, every=False, ref=None):
    """Where each served row (prompt ids, tokens) parts from ``want_rows``
    (the same prompts' tokens from another run; with ``every``, a reference
    token at each position of the served context, as a re-score gives),
    the fork judged in the logits the runs sampled (``SampleTrace.runs()``):
    at the first parting index (every parting index with ``every``), each
    traced run that sampled there after the prompt and the tokens before it
    gives how far the other token lay below its argmax — the served token's
    rival where the run chose the served token, else the served token.
    ``ref``, where the reference is a teacher-forced pass, gives that
    pass's own view: ``ref(rows)`` → per row and index how far the row's
    token lay below the pass's argmax there (the pass chose the reference
    token), counted as one more run. → [(row, index, served token,
    reference token, the least deficit over those runs (inf when none
    sampled there), its top-2 as text)]."""
    out = []
    views = ref(rows) if ref is not None else None
    for r, ((prompt, ids), (_, want)) in enumerate(zip(rows, want_rows)):
        for d, (a, b) in enumerate(zip(ids, want)):
            if a == b:
                continue
            best = ("not recorded", float("inf"))
            for _, p, gen, start, own in runs:
                if p != tuple(prompt) or start > d or d not in own or d >= len(gen) \
                        or list(gen[:d]) != list(ids[:d]):
                    continue
                other = b if gen[d] == a else a
                best = min(best, top_deficit(own[d], other), key=lambda x: x[1])
            if views is not None:
                best = min(best, ("in the reference pass", views[r][d]), key=lambda x: x[1])
            out.append((r, d, a, b, best[1], best[0]))
            if not every:
                break
    return out


def check_sampled(tag, rows, want_rows, runs, what, every=False, tie=NEAR_TIE, ref=None):
    """Check (a) of phases 15, 19 and 20, judged in the logits each run
    sampled: every fork of ``rows`` from ``want_rows`` (``what`` names the
    reference) is a near-tie — the other token less than ``tie`` (NEAR_TIE)
    below the argmax in a run's own logits there — each printed; a runner-up
    planted where a recorded sample's top-2 gap is widest (before its row's
    first fork) must be rejected. ``ref``: as :func:`fork_deficits`. → the
    forks."""
    forks = fork_deficits(rows, want_rows, runs, every, ref)
    for r, d, a, b, deficit, top in forks:
        print(f"[{tag}] (a) request {r} parts from {what} at token {d}: {a} vs {b}; the "
              f"other token {deficit:.4f} below the argmax in the logits of a run that "
              f"chose either (top-2 {top}; near-tie bound {tie})", flush=True)
    first = {r: d for r, d, *_ in forks}
    best = None
    for r, (prompt, ids) in enumerate(rows):
        for _, p, gen, start, own in runs:
            if p != tuple(prompt):
                continue
            for j, (vals, idx) in own.items():
                if j < first.get(r, len(ids)) and j < len(gen) \
                        and list(gen[:j]) == list(ids[:j]) \
                        and (best is None or vals[0] - vals[1] > best[0]):
                    best = (vals[0] - vals[1], r, j, idx[1])
    if best is None:
        raise AssertionError(f"[{tag}] no sampled logits were recorded for the rows")
    gap, r, j, runner = best
    planted = list(rows[r][1])
    planted[j] = runner
    caught = fork_deficits([(rows[r][0], planted)], [want_rows[r]], runs, every, ref)
    rejected = any(d == j and deficit >= tie for _, d, _, _, deficit, _ in caught)
    n = sum(len(t) for _, t in rows)
    worst = max((f[4] for f in forks), default=0.0)
    print(f"[{tag}] (a) {n} served tokens against {what}: {len(forks)} fork(s), each judged "
          f"in the sampled logits (the widest other-token deficit {worst:.4f}, bound "
          f"{tie}); the runner-up planted at request {r} token {j} (top-2 gap "
          f"{gap:.4f}) rejected: {rejected}", flush=True)
    if worst >= tie:
        raise AssertionError(f"[{tag}] served tokens part from {what} beyond a near-tie: "
                             f"{[f for f in forks if f[4] >= tie]}")
    if not rejected or gap < tie:
        raise AssertionError(f"[{tag}] the sampled-logits judge accepts a planted flip")
    return forks


def check_aligned(tag, runs, tags=None):
    """The trace lines up with the tokens: each token a run sampled and
    recorded is the argmax of its recorded logits (or tied with it), and
    every token of the runs tagged ``tags`` was recorded."""
    own = [(gen[j], top) for _, _, gen, _, o in runs for j, top in o.items() if j < len(gen)]
    aligned = all(t == ids[0] or vals[0] == vals[1] for t, (vals, ids) in own)
    full = [(len(gen) - max(start, 0), sum(1 for j in o if j < len(gen)))
            for t, _, gen, start, o in runs if tags is None or t in tags]
    covered = all(a == b for a, b in full)
    print(f"[{tag}] (a) {len(runs)} runs traced, {len(own)} sampled tokens recorded, each "
          f"its run's argmax: {aligned}; every token of the {tags or 'all'} runs recorded: "
          f"{covered}", flush=True)
    if not (aligned and covered):
        raise AssertionError(f"[{tag}] the sampled logits do not line up with the tokens")


class Tag:
    """The label ``SampleTrace`` gives each slot it first sees."""

    def __init__(self, tag=None):
        self.tag = tag


def allocator_state(engine, rows):
    """Check (b)'s view of an engine's allocator after its requests: free
    and cached counts, radix nodes, block metas, live sequences, all
    refcounts zero, and the cached prefix length of each served sequence."""
    m = engine.manager
    return {"free": m.num_free, "cached": len(m.cached_lru), "radix": len(m.radix),
            "metas": len(m.metas), "live": len(m.seq_blocks),
            "refcounts_zero": all(meta.ref_count == 0 for meta in m.metas.values()),
            "prefix": [len(m.radix.match_prefix(p + t)) for p, t in rows]}


def check_routes(tag, counts, routes, stats, quantized):
    """Check (c): the ragged kernel ran the verify rows (K+1 queries), the
    quantized matmul's kernel served M = 8·(K+1) rows and its library route
    never did, the fused decode kernel never launched, and every verify
    round committed at least one token a slot."""
    m = SERVE_BATCH * (SPEC_K + 1)
    print(f"[{tag}] (c) launches {counts}; ragged calls by query width "
          f"{dict(sorted(routes.ragged_s.items()))}; qmm rows by route: kernel "
          f"{dict(sorted(routes.kernel_m.items()))}, library "
          f"{dict(sorted(routes.library_m.items()))}; spec_tokens_per_step "
          f"{stats['spec_tokens_per_step']:.3f}, accept rate {stats['spec_accept_rate']:.4f}",
          flush=True)
    ok = (counts["ragged_paged_attention"] > 0 and routes.ragged_s.get(SPEC_K + 1, 0) > 0
          and counts["paged_decode_attention_fused"] == 0
          and stats["spec_tokens_per_step"] >= 1.0)
    if quantized:
        ok = ok and routes.kernel_m.get(m, 0) > 0 and routes.library_m.get(m, 0) == 0
    if not ok:
        raise AssertionError(f"[{tag}] a speculative round took the wrong route")


def traced_spec_serving(torch, pa, tag, llm, plain, prompts, n):
    """``prompts`` served by ``llm`` (speculating) and by ``plain`` (the same
    weights without speculation), both engines under one
    :class:`SampleTrace`; then check (a): the trace lines up with the plain
    run's tokens, and every fork of the speculating rows from the plain ones
    is a near-tie in the logits a run sampled there. → (rows, wall,
    launches, routes, plain rows, plain wall, plain launches)."""
    tags = Tag("spec")
    trace = SampleTrace(torch, [llm.engine, plain.engine], tags=tags)
    try:
        rows, wall, counts, routes = spec_serve(torch, pa, llm, prompts, n)
        tags.tag = "plain"
        prows, pwall, pcounts, _ = spec_serve(torch, pa, plain, prompts, n)
    finally:
        trace.close()
    runs = trace.runs()
    check_aligned(tag, runs, tags=("plain",))
    check_sampled(tag, rows, prows, runs, "the run without speculation")
    same = sum(a == b for (_, t1), (_, t2) in zip(rows, prows) for a, b in zip(t1, t2))
    print(f"[{tag}] (a) tokens equal to the run without speculation: {same}/"
          f"{sum(len(t) for _, t in rows)}", flush=True)
    return rows, wall, counts, routes, prows, pwall, pcounts


def spec_pass(torch, pa, tag, llm, plain, prompts, quantized):
    """Checks (a)-(c) and (h) on a speculating ``TorchLLMEngine`` and the
    same engine without speculation (``plain``, the same weights). → (the
    spec run's launches, its routes, its rows)."""
    from types import SimpleNamespace

    from distributed_gpu_inference_torch.worker import main as wmain

    rows, wall, counts, routes, prows, pwall, _ = traced_spec_serving(
        torch, pa, tag, llm, plain, prompts, SPEC_TOKENS)
    stats = llm.engine.get_stats()
    n_tok = len(prompts) * SPEC_TOKENS
    print(f"[{tag}] {len(prompts)} requests x {SPEC_TOKENS} greedy tokens, K={SPEC_K}: "
          f"{wall:.2f} s = {n_tok / wall:.1f} tok/s end to end (information)", flush=True)
    check_routes(tag, counts, routes, stats, quantized)
    print(f"[{tag}] without speculation: {pwall:.2f} s = {n_tok / pwall:.1f} tok/s end to "
          f"end (information)", flush=True)
    got, want = allocator_state(llm.engine, rows), allocator_state(plain.engine, prows)
    print(f"[{tag}] (b) allocator after the requests: speculating {got}, never "
          f"speculated {want}", flush=True)
    if got != want or not got["refcounts_zero"] or got["live"]:
        raise AssertionError(f"[{tag}] speculation left the allocator unlike a "
                             f"never-speculated engine")
    # (h) the worker's heartbeat block of this engine
    block = wmain.Worker._spec_engine_stats(SimpleNamespace(engines={"llm": llm}))
    keys = ("spec_accepted", "spec_drafted", "spec_slot_steps", "spec_emitted",
            "spec_accept_rate", "spec_tokens_per_step")
    print(f"[{tag}] (h) heartbeat block {block}", flush=True)
    if block is None or any(block[k] != stats[k] for k in keys) or set(block) != set(keys):
        raise AssertionError(f"[{tag}] the speculation heartbeat block disagrees with the "
                             f"engine: {block} vs {stats}")
    return counts, routes, rows


def oracle_rates(torch, pa, llm, plain, prompts):
    """Check (e): at each oracle rate, ``spec_tokens_per_step`` over the
    rate's requests is within 0.25 of 1 + rate·K; decode tok/s beside the
    engine without speculation (information)."""
    n_tok = len(prompts) * SPEC_ORACLE_TOKENS
    _, pwall, _, _ = spec_serve(torch, pa, plain, prompts, SPEC_ORACLE_TOKENS)
    for rate in SPEC_ORACLE_RATES:
        llm.engine.set_spec_oracle(rate)
        before = dict(llm.engine.stats)
        _, wall, _, _ = spec_serve(torch, pa, llm, prompts, SPEC_ORACLE_TOKENS)
        st = llm.engine.stats
        tps = ((st["spec_emitted"] - before["spec_emitted"])
               / (st["spec_slot_steps"] - before["spec_slot_steps"]))
        print(f"[spec oracle] rate {rate}: spec_tokens_per_step {tps:.3f} (expected "
              f"{1 + rate * SPEC_K:.2f} +- 0.25); {n_tok / wall:.1f} tok/s end to end vs "
              f"{n_tok / pwall:.1f} without speculation ({len(prompts)} requests x "
              f"{SPEC_ORACLE_TOKENS} tokens, information)", flush=True)
        if abs(tps - (1 + rate * SPEC_K)) > 0.25:
            raise AssertionError(f"oracle rate {rate}: {tps} tokens a step")
    llm.engine.set_spec_oracle(None)


def round_times(torch, engine, flush, ctx):
    """Check (f): CUDA-event medians of SPEC_SAMPLES calls at batch 8 over
    contexts ``ctx`` on a scratch pool: the draft chain (K draft-head
    steps, each with ``project_logits``), the verify pass (one forward of
    K+1 queries a row + argmax), one plain decode step (one query a row,
    the fused kernel, + argmax), and ``project_logits`` alone at [8, 1, H]."""
    from distributed_gpu_inference_torch.models import llama

    cfg, dev, bs = engine.model_cfg, engine.device, engine.cfg.block_size
    b = len(ctx)
    m = -(-(int(max(ctx)) + SPEC_K + 2) // bs)
    kv = llama.init_kv_pools(cfg, 1 + b * m, bs, engine.kv_dtype, dev)
    tables = torch.arange(1, 1 + b * m, dtype=torch.int32, device=dev).reshape(b, m)
    g = torch.Generator(device=dev).manual_seed(15)
    pending = torch.randint(0, cfg.vocab_size, (b,), generator=g, device=dev,
                            dtype=torch.int32)
    h = torch.randn((b, cfg.hidden_size), generator=g, device=dev).to(engine.dtype)
    lens = torch.tensor(ctx, dtype=torch.int32, device=dev)
    chunk = engine._draft_chain(pending, h)
    pos = lens[:, None] + torch.arange(SPEC_K + 1, device=dev, dtype=torch.int32)[None, :]

    def verify():
        out = llama.forward_chunk(cfg, engine.params, chunk, pos, kv, tables,
                                  lens + SPEC_K + 1, block_size=bs, last_only=False,
                                  allow_fused=False)
        return out.logits.argmax(-1)

    def decode():
        out = llama.forward_chunk(cfg, engine.params, pending[:, None], lens[:, None], kv,
                                  tables, lens + 1, block_size=bs)
        return out.logits.argmax(-1)

    hid = h[:, None, :]
    with torch.no_grad():
        out = {name: time_ms(torch, fn, flush, iters=SPEC_SAMPLES, warmup=2) for name, fn in (
            ("draft chain", lambda: engine._draft_chain(pending, h)),
            ("verify pass", verify), ("plain decode step", decode),
            ("project_logits", lambda: llama.project_logits(cfg, engine.params, hid)))}
    del kv
    print(f"[spec times] batch {b}, K={SPEC_K}, contexts {list(ctx)} (CUDA events, median of "
          f"{SPEC_SAMPLES}): " + "; ".join(f"{k} {v:.3f} ms" for k, v in out.items())
          + f"; a round = draft chain + verify pass = "
          f"{out['draft chain'] + out['verify pass']:.3f} ms vs "
          f"{out['plain decode step']:.3f} ms a plain step", flush=True)


def tree_phase(torch, pa, smi, params, base, prompts):
    """Check (g): ``engine: jax-speculative`` with widths SPEC_WIDTHS; two
    short greedy prompts in one ``batch_inference`` call ride one spec
    wave; check (a) on their streams against the same weights served
    without speculation, the decoder's stats, and the plain tree verify
    (``forward_tree_chunk``) timed at that wave's shape."""
    from distributed_gpu_inference_torch.models import llama
    from distributed_gpu_inference_torch.runtime.speculative import TreeTopology
    from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine

    # a 50 ms admission latch: the pair forms one admission, so one wave
    llm = TorchLLMEngine({**base, "engine": "jax-speculative",
                          "spec_widths": list(SPEC_WIDTHS), "params": params,
                          "serving": {"max_wait_ms": 50.0}})
    llm.load_model()
    plain = TorchLLMEngine({**base, "params": params})
    plain.load_model()
    try:
        rows, wall, counts, _, _, _, _ = traced_spec_serving(
            torch, pa, "spec tree", llm, plain, prompts, SPEC_TOKENS)
        stats = llm.serving.get_stats()
        print(f"[spec tree] widths {SPEC_WIDTHS}: {len(prompts)} requests x {SPEC_TOKENS} "
              f"greedy tokens in {wall:.2f} s; batcher spec_waves {stats['spec_waves']}, "
              f"spec_completed {stats['spec_completed']}; decoder stats {stats['spec']}; "
              f"launches {counts}", flush=True)
        if stats["spec_waves"] < 1 or stats["spec_completed"] != len(prompts):
            raise AssertionError("the batcher did not route the greedy pair to a spec wave")
        dec = llm._spec
        topo = TreeTopology(SPEC_WIDTHS)
        n = topo.num_nodes
        dev, cfg, bs = dec.device, dec.model_cfg, dec.block_size
        prefix = torch.tensor([len(p) + SPEC_TOKENS for p, _ in rows], dtype=torch.int32,
                              device=dev)
        b = len(rows)
        m = -(-(int(prefix.max()) + n + 1) // bs)
        kv = llama.init_kv_pools(cfg, 1 + b * m, bs, dec.kv_dtype, dev)
        tables = torch.arange(1, 1 + b * m, dtype=torch.int32, device=dev).reshape(b, m)
        toks = torch.randint(0, cfg.vocab_size, (b, n), device=dev, dtype=torch.int32)
        depths = torch.as_tensor(topo.depths, device=dev, dtype=torch.int32)
        node = torch.arange(n, device=dev, dtype=torch.int32)
        mask = torch.as_tensor(topo.ancestor_mask, device=dev)
        flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

        def verify():
            return llama.forward_tree_chunk(
                cfg, dec.params, toks, prefix[:, None] + depths[None], prefix[:, None]
                + node[None], kv, tables, prefix, mask, block_size=bs).logits.argmax(-1)

        with torch.no_grad():
            ms = time_ms(torch, verify, flush, iters=SPEC_SAMPLES, warmup=2)
        print(f"[spec tree] plain tree verify (forward_tree_chunk, {b} rows x {n} nodes, "
              f"paged_tree_attention in plain torch): {ms:.3f} ms (CUDA events, median of "
              f"{SPEC_SAMPLES}; {smi})", flush=True)
        del kv, flush
    finally:
        plain.unload()
        llm.unload()


def verify_case(torch, dev, ctx):
    """Phase 15's verify round at llama3-8b widths: 8 rows x K+1 queries at
    positions ctx..ctx+K (``ctx``: each serving prompt's length plus its
    32 tokens), each row over its own pages (M = 64)."""
    rng = np.random.default_rng(9)
    b, s = len(ctx), SPEC_K + 1
    n = 1 + b * M
    kp = torch.tensor(rng.standard_normal((n, HKV, BK, D)), dtype=torch.bfloat16, device=dev)
    vp = torch.tensor(rng.standard_normal((n, HKV, BK, D)), dtype=torch.bfloat16, device=dev)
    q = torch.tensor(rng.standard_normal((b, s, NH, D)), dtype=torch.bfloat16, device=dev)
    tables = np.arange(1, n, dtype=np.int32).reshape(b, M)
    pos = (np.asarray(ctx, np.int32)[:, None] + np.arange(s, dtype=np.int32)[None, :])
    lens = (np.asarray(ctx, np.int32) + s).astype(np.int32)
    t = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)  # noqa: E731
    return q, kp, vp, t(tables), t(pos), t(lens), (tables, pos, lens)


def verify_kernel_entries(torch, pa, flush, ctx, launches, qmm_launches):
    """The kernels-JSON entries of phase 15's new shapes: the ragged kernel
    on the verify round (bf16 and int8 pools; parity against its plain
    version with the phase-3/6 tolerances, then timed as phase 5 times it)
    and the quantized matmul's seven projections at M = 8·(K+1) (int8
    codes; parity, events, graph, plain and ``torch.matmul`` on the bf16
    weights)."""
    from distributed_gpu_inference_torch.ops import qmm
    from distributed_gpu_inference_torch.ops.attention import paged_attention_ref
    from distributed_gpu_inference_torch.ops.quantization import quantize_weight

    dev = torch.device("cuda")
    entries = []
    for kind in ("bf16", "int8"):
        case = ragged_in(torch, verify_case(torch, dev, ctx), kind)
        q, kq, vq, ks, vs, tables, pos, lens, _ = case
        atol = RAGGED_ATOL
        if kind == "int8":
            atol += BF16_HALF_ULP * float(torch.maximum(
                dequantized(torch, kq, ks).abs().max(), dequantized(torch, vq, vs).abs().max()))
        ok, err, vec = errors(torch, pa.ragged_paged_attention(
            q, kq, vq, tables, pos, lens, BK, k_scale=ks, v_scale=vs), paged_attention_ref(
            q, kq, vq, tables, pos, lens, BK, k_scale=ks, v_scale=vs), atol)
        print(f"[spec parity] ragged {kind} verify round 8x{SPEC_K + 1}: max_abs_err {err:.3e} "
              f"max_vector_rel_err {vec:.3e} (bound atol {atol:.3e} rtol {RTOL})", flush=True)
        if not ok:
            raise AssertionError(f"the ragged kernel disagrees on the verify round ({kind})")
        times = ragged_times(torch, pa, paged_attention_ref, flush,
                             f"[spec times] ragged verify round 8x{SPEC_K + 1} {kind} pools",
                             case, kind)
        suffix = "" if kind == "bf16" else "[int8]"
        entries.append(entry(f"ragged_paged_attention{suffix}@verify",
                             "ragged_paged_attention.cu", PALLAS + ":932", launches[kind],
                             err, times))
        del case
    m = SERVE_BATCH * (SPEC_K + 1)
    g = torch.Generator(device=dev).manual_seed(40)
    weights, deq = [], []
    for _, kdim, ndim in LAYER_PROJ:
        qw = quantize_weight(torch.randn((1, kdim, ndim), generator=g, device=dev)
                             * kdim ** -0.5, "int8")
        weights.append((qw["qw"], qw["scale"]))
        deq.append((qw["qw"][0].float() * qw["scale"][0]).to(torch.bfloat16))
    xs = {k: torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
          for k in {kd for _, kd, _ in LAYER_PROJ}}
    err = 0.0
    for qw, sc in weights:
        ok, e, _ = errors(torch, qmm.launch_kernel(xs[qw.shape[1]], qw, sc),
                          qmm.qmm_plain(xs[qw.shape[1]], qw, sc), QMM_ATOL)
        if not ok:
            raise AssertionError(f"qmm disagrees with its plain version at M={m}")
        err = max(err, e)

    def calls(fn):
        return lambda: [fn(xs[qw.shape[1]], qw, sc) for qw, sc in weights]

    lib = lambda: [torch.matmul(xs[w.shape[0]], w) for w in deq]  # noqa: E731
    nbytes, flops = qmm_cost(m, [(k, n) for _, k, n in LAYER_PROJ])
    b_ms, by = bound(nbytes, flops)
    times = {"ms": time_ms(torch, calls(qmm.launch_kernel), flush),
             "graph_ms": graph_ms(torch, calls(qmm.launch_kernel), flush),
             "plain_ms": time_ms(torch, calls(qmm.qmm_plain), flush, iters=10, warmup=1),
             "bound_ms": b_ms, "bound_by": by,
             "library_ms": time_ms(torch, lib, flush),
             "library_graph_ms": graph_ms(torch, lib, flush)}
    print(f"[spec times] qmm int8, one layer's 7 projections at M={m} (the verify rows): "
          f"max_abs_err {err:.3e}; kernel {times['ms']:.4f} ms (as a CUDA graph "
          f"{times['graph_ms']:.4f} ms, {b_ms / times['graph_ms']:.1%} of the bound), plain "
          f"{times['plain_ms']:.4f} ms, torch.matmul on bf16 weights {times['library_ms']:.4f} "
          f"ms (graph {times['library_graph_ms']:.4f} ms), bound {b_ms:.4f} ms ({by}: "
          f"{nbytes} B, {flops} flop)", flush=True)
    entries.append(entry(f"qmm_w8a16[int8]@m{m}", "qmm_w8a16.cu", QPALLAS + ":88",
                         qmm_launches, err, times))
    return entries


def spec_phase(torch, pa, smi, prompts, lengths, model="llama3-8b", quantization="int8",
               device="cuda"):
    """Phase 15 (see the module docstring). → (the kernels-JSON entries of
    the verify shapes, the bf16-pool engine's stats after check (a)'s
    serving: its random head's accept rate, for phase 20)."""
    from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine

    t_phase = time.perf_counter()
    base = {"model": model, "max_batch_size": SERVE_BATCH, "max_seq_len": MAX_SEQ,
            "enable_prefix_cache": True, "dtype": "bfloat16", "device": device, "seed": 0,
            "quantization": quantization, "prefix_summary_top_n": 0}
    spec = {"speculative_decode": True, "spec_num_draft_tokens": SPEC_K}
    params, launches, qmm_m = None, {}, 0
    for kv in (None, "int8"):
        tag = f"spec {kv or 'bf16'} pool"
        pool = {} if kv is None else {"kv_cache_dtype": kv}
        shared = {} if params is None else {"params": params}
        t0 = time.perf_counter()
        llm = TorchLLMEngine({**base, **pool, **spec, **shared})
        llm.load_model()
        params = llm.engine.params
        plain = TorchLLMEngine({**base, **pool, "params": params})
        plain.load_model()
        print(f"[{tag}] {model} ({quantization} weights, {kv or 'bf16'} KV) speculating "
              f"(K={SPEC_K}, random draft head) and plain engines loaded in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        try:
            counts, routes, _ = spec_pass(torch, pa, tag, llm, plain, prompts,
                                          quantized=quantization is not None)
            launches["int8" if kv else "bf16"] = counts["ragged_paged_attention"]
            if kv is None:
                random_head = dict(llm.engine.get_stats())
                qmm_m = routes.kernel_m.get(SERVE_BATCH * (SPEC_K + 1), 0)
                oracle_rates(torch, pa, llm, plain, prompts)
                flush = torch.empty(128 << 20, dtype=torch.uint8, device=device)
                round_times(torch, llm.engine, flush, [n + SPEC_TOKENS for n in lengths])
                del flush
        finally:
            plain.unload()
            llm.unload()
    tree_phase(torch, pa, smi, params, base, [prompts[0], prompts[1][:100]])
    del params
    torch.cuda.empty_cache()
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=device)
    entries = verify_kernel_entries(torch, pa, flush, [n + SPEC_TOKENS for n in lengths],
                                    launches, qmm_m)
    del flush
    torch.cuda.empty_cache()
    print(f"[spec] phase ran in {time.perf_counter() - t_phase:.1f} s ({smi})", flush=True)
    return entries, random_head


# ---------------------------------------------------------------- phases

# ---------------------------------------------------------------- PD disaggregation

PD_TOKENS = 32              # greedy tokens of each phase-16 request
PD_PIECE_BLOCKS = 4         # blocks a streamed piece
# prefill chunks of 256 tokens on both sides: prompts past 256 tokens span
# two or more chunks, so a streamed push overlaps the prefill
PD_BUCKETS = (16, 32, 64, 128, 256)
PD_SAMPLES = 10             # samples of each phase-16 transfer time


def pd_engine_config(model, quantization, kv, device, **over):
    return {"model": model, "max_batch_size": SERVE_BATCH, "max_seq_len": MAX_SEQ,
            "enable_prefix_cache": True, "dtype": "bfloat16", "device": device, "seed": 0,
            "quantization": quantization, "kv_cache_dtype": kv,
            "prefill_buckets": list(PD_BUCKETS), **over}


class ThreadSplit:
    """While installed: calls of the model's two attention wrappers and
    the quantized matmul's kernel launches (``qmm._launch``) by the thread
    that made them (each engine's batcher runs its engine work on its own
    executor thread, so this splits the work between two engines of one
    process). The kernels count their own launches as before."""

    def __init__(self, names):
        from distributed_gpu_inference_torch.models import llama
        from distributed_gpu_inference_torch.ops import qmm

        self.names, self.calls = names, {}
        self._sites = [(llama, "ragged_paged_attention", "ragged_paged_attention"),
                       (llama, "paged_decode_attention_fused", "paged_decode_attention_fused"),
                       (qmm, "_launch", "qmm_w8a16")]
        self._real = [getattr(mod, f) for mod, f, _ in self._sites]
        for (mod, f, name), fn in zip(self._sites, self._real):
            def counted(*a, _fn=fn, _name=name, **kw):
                key = (self.names.get(threading.get_ident(), "other"), _name)
                self.calls[key] = self.calls.get(key, 0) + 1
                return _fn(*a, **kw)

            setattr(mod, f, counted)

    def of(self, who):
        return {name: self.calls.get((who, name), 0) for _, _, name in self._sites}

    def close(self):
        for (mod, f, _), fn in zip(self._sites, self._real):
            setattr(mod, f, fn)


class SampleTrace:
    """While installed on engines: the top-8 logits of every row each
    sample takes (with a ``prefix``, only samples with a row whose request
    ``session_id`` starts with it), kept on the device with the slot that
    took it. Read afterwards keyed by (session id, the position sampled) —
    the PD key and prompt_len + index of the token — or slot by slot
    (``runs``). The decode-time logits a greedy stream was committed from
    (a re-score runs other kernels). ``tags.tag``, where given, labels each
    slot when it is first seen."""

    def __init__(self, torch, engines, prefix=None, tags=None):
        self.torch, self.engines, self.prefix, self.tags = torch, [], prefix, tags
        self.calls, self.first = [], {}   # first: id(slot) -> (slot, own start, tag)
        for eng in engines:
            self.install(eng)

    def install(self, eng):
        real = eng._sample
        self.engines.append(weakref.ref(eng))   # a killed member's engine must go

        def sample(logits, rows, positions, mode):
            slots = [eng.slots[i] for i in rows]
            keys = [s.request.session_id if s is not None else None for s in slots]
            if self.prefix is None or any(k and k.startswith(self.prefix) for k in keys):
                for s in slots:
                    # a slot's own samples start at its prompt (a resumed
                    # slot's holds its checkpoint) plus what it had generated
                    # when first seen: earlier positions are mid-prefill rows
                    if s is not None and id(s) not in self.first:
                        self.first[id(s)] = (s, len(s.request.prompt_token_ids)
                                             + len(s.generated),
                                             self.tags.tag if self.tags else None)
                top = logits.float().topk(8, dim=-1)
                pos = positions if isinstance(positions, self.torch.Tensor) else \
                    self.torch.as_tensor(np.asarray(positions))
                self.calls.append((slots, keys, pos.clone(), top.values, top.indices))
            return real(logits, rows, positions, mode)

        eng._sample = sample

    def close(self):
        for ref in self.engines:
            if (eng := ref()) is not None:
                del eng._sample
        self.table, self.own = {}, {i: {} for i in self.first}
        for slots, keys, pos, vals, idx in self.calls:
            pos, vals, idx = pos.tolist(), vals.tolist(), idx.tolist()
            for r, (s, k) in enumerate(zip(slots, keys)):
                if k and k.startswith(self.prefix or "") and pos[r] > 0:
                    self.table[(k, int(pos[r]))] = (vals[r], idx[r])
                if s is not None and pos[r] >= self.first[id(s)][1]:
                    self.own[id(s)][pos[r] - len(s.request.prompt_token_ids)] = (vals[r], idx[r])
        self.calls = []

    def deficit(self, key, pos, token):
        """(the sample's top-2 as text, how far ``token``'s logit lay below
        the argmax's there: a lower bound when it was not in the top 8)."""
        return top_deficit(self.table.get((key, pos), (None, None)), token)

    def runs(self):
        """→ [(tag, prompt ids, generated ids, index of the first token the
        slot sampled itself, {token index: (top logits, top ids)} of those
        tokens)], after ``close``."""
        return [(t, tuple(s.request.prompt_token_ids), list(s.generated),
                 start - len(s.request.prompt_token_ids), self.own[i])
                for i, (s, start, t) in self.first.items()]


def top_deficit(top, token):
    """(one sample's top-2 as text, how far ``token``'s logit lay below the
    argmax's there: a lower bound when it was not in its top 8)."""
    vals, idx = top
    if vals is None:
        return "not recorded", float("inf")
    text = f"id {idx[0]} {vals[0]:.4f} / id {idx[1]} {vals[1]:.4f}"
    return text, (vals[0] - vals[idx.index(token)] if token in idx else vals[0] - vals[-1])


class CapturedRx:
    """The bodies a data plane's ``/kv/transfer`` received, in order."""

    def __init__(self, plane):
        self.raws, real = [], plane.kv_receiver

        def rx(raw):
            self.raws.append(raw)
            return real(raw)

        plane.kv_receiver = rx

    def wire_pages(self, key):
        """{block index: (page, scales)} of the handoff of ``key`` as it
        crossed the wire (one blob or stream pieces)."""
        from distributed_gpu_inference_torch.runtime import kv_handoff as kh

        out = {}
        for raw in self.raws:
            if not kh.is_stream_message(raw):
                h = kh.deserialize_handoff(raw)
                if (h.request.session_id or h.request.request_id) == key:
                    for i in range(h.num_blocks):
                        out[i] = (h.pages[i], None if h.scale_pages is None
                                  else h.scale_pages[i])
                continue
            kind, meta, payload = kh._unpack_stream(raw)
            if kind != kh._KIND_PIECE or meta.get("key") != key:
                continue
            blobs = kh._read_blobs(payload, 2) if meta.get("has_scales") else [payload, None]
            pages, scales = kh._read_pages(*blobs)
            for j in range(pages.shape[0]):
                out[meta["block_lo"] + j] = (pages[j], None if scales is None else scales[j])
        return out


def adopted_equal(torch, b, key, wire):
    """B's adopted pages and scales for ``key``, read back with
    ``pull_pages``, bit-identical to the wire's → (blocks compared, ok)."""
    slot, seq, _ = b._pd_slots[key]
    blocks = list(b.engine.manager.seq_blocks[seq.seq_id])
    idx = [i for i in range(len(blocks)) if i in wire]
    back = b.serving.run_exclusive(lambda: b.engine.pull_pages([blocks[i] for i in idx]))
    ok = all(same_bits(torch, p, wire[i][0])
             and (s is None or same_bits(torch, s, wire[i][1]))
             for i, (p, s) in zip(idx, back))
    return len(idx), ok and len(idx) > 0


def pd_params(text, key, url=None, **over):
    p = {"pd_stage": "prefill", "prompt": text, "max_new_tokens": PD_TOKENS,
         "temperature": 0.0, "ignore_eos": True, "kv_cache_key": key,
         "pd_stream_piece_blocks": PD_PIECE_BLOCKS, **over}
    if url is not None:
        p.update(decode_url=url, decode_worker="B", target_worker="A")
    return p


def clear_cached(llm):
    llm.serving.run_exclusive(llm.engine.manager.clear_cached)


def pd_run(a, b, url, text, key, **over):
    """One request through ``pd_stage: prefill`` on A (pushed to ``url``)
    and ``pd_stage: decode`` on B → (prefill result, decode result)."""
    pre = a.inference(pd_params(text, key, url, **over))
    return pre, b.inference({"pd_stage": "decode", "kv_cache_key": key})


def in_turns(n, prefill, decode):
    """``n`` requests whose prefills run one at a time in order, each on A
    with no cached block (no prefill takes another's prefix, so its chunks
    are the same from run to run), then whose decodes all run together
    (threads), sharing the rounds."""
    pres = [prefill(i) for i in range(n)]
    errors = []

    def one(i):
        try:
            decode(i, pres[i])
        except BaseException as exc:  # noqa: BLE001 — raised below
            errors.append(exc)

    ths = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=600)
    if errors or any(th.is_alive() for th in ths):
        raise AssertionError(f"[pd] decodes failed: {errors}")


def timed_ms(torch, fn, n=PD_SAMPLES):
    """Median of ``n`` calls: CUDA events around the call on the card,
    the host clock otherwise."""
    out = []
    for _ in range(n):
        if torch.cuda.is_available():
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            fn()
            t1.record()
            t1.synchronize()
            out.append(t0.elapsed_time(t1))
        else:
            s = time.perf_counter()
            fn()
            out.append((time.perf_counter() - s) * 1e3)
    return float(np.median(out))


def pd_times(torch, a, b, tag, text, smi):
    """Phase 16's information times for one request of ``text``: handoff
    bytes, export (gather + D2H) and adopt (H2D + ``index_copy_``) against
    PCIe Gen5 x16, serialize / push / deserialize over loopback, and the
    device-path migrate against two HBM passes."""
    from distributed_gpu_inference_torch.comm.data_plane import DataPlaneServer, post_bytes
    from distributed_gpu_inference_torch.runtime import kv_handoff as kh
    from distributed_gpu_inference_torch.worker.engines.base import GenerationConfig

    params = pd_params(text, "t")
    req = a._pd_request(params, GenerationConfig.from_params(params))
    clear_cached(a)
    ea, eb = a.engine, b.engine
    slot = a.serving.run_exclusive(lambda: ea.submit(req))
    try:
        blocks = list(ea.manager.seq_blocks[ea.slots[slot].seq_id])
        h = a.serving.run_exclusive(lambda: kh.export_slot_kv(ea, slot))
        nbytes = h.nbytes + (0 if h.scale_pages is None else
                             h.scale_pages.numel() * h.scale_pages.element_size())
        export_ms = a.serving.run_exclusive(lambda: timed_ms(torch, lambda: ea.gather_pages(blocks)))
        free = list(eb.manager.free_list)[-len(blocks):]
        pages = [h.pages[i] for i in range(len(blocks))]
        scales = [None if h.scale_pages is None else h.scale_pages[i] for i in range(len(blocks))]
        adopt_ms = b.serving.run_exclusive(
            lambda: timed_ms(torch, lambda: eb.push_pages(free, pages, scales)))
        t0 = time.perf_counter()
        raw = kh.serialize_handoff(h)
        ser_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        kh.deserialize_handoff(raw)
        de_ms = (time.perf_counter() - t0) * 1e3
        null = DataPlaneServer(kv_receiver=lambda body: {"n": len(body)})
        null.start()
        try:
            push_ms = timed_ms(torch, lambda: post_bytes(null.url + "/kv/transfer", raw, 120.0),
                               n=3)
        finally:
            null.stop()

        def migrate():
            d = kh.migrate_kv_device(ea, eb, slot)
            eb.finish_slot(d, cache=False)

        mig_ms = b.serving.run_exclusive(lambda: timed_ms(torch, migrate))
    finally:
        a.serving.run_exclusive(lambda: ea.finish_slot(slot, cache=False))
    pcie = nbytes / PCIE_BYTES * 1e3
    hbm = 2 * nbytes / PEAK_HBM_BYTES * 1e3
    print(f"[pd] {tag} times (information) for one {len(req.prompt_token_ids)}-token request: "
          f"{nbytes} B of pages+scales ({len(raw)} B on the wire, one blob); export (gather + "
          f"D2H) {export_ms:.3f} ms and adopt (H2D + index_copy_) {adopt_ms:.3f} ms against "
          f"bytes / 64 GB/s = {pcie:.3f} ms; serialize {ser_ms:.2f} ms, push over loopback "
          f"{push_ms:.2f} ms, deserialize {de_ms:.2f} ms; device-path migrate_kv_device "
          f"{mig_ms:.3f} ms against 2 x bytes / 3.35 TB/s = {hbm:.4f} ms ({smi})", flush=True)


def pd_worker_check(torch, a, text, smi, model, quantization):
    """Check (f): worker B through ``cli.cmd_start`` with ``role: decode``
    and a ``pd_data_plane_url`` against :class:`StandInPlane` (the worker's
    own engine geometry, the default bf16 KV pool)."""
    import socket
    import tempfile

    from distributed_gpu_inference_torch.testing import faults

    plane = StandInPlane()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_pd_")
    th = wb = None
    try:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        url = f"http://127.0.0.1:{port}"
        path = f"{tmp.name}/worker.json"
        with open(path, "w") as f:
            json.dump({"name": "chip-smoke-decode", "server": {"url": plane.url},
                       "role": "decode", "pd_data_plane_url": url,
                       "engines": {"llm": {"model": model, "quantization": quantization}},
                       "poll_interval_s": 0.05, "heartbeat_interval_s": 0.5}, f)
        th, wb = start_cli_worker(path)
        reg = plane.registrations[-1]
        key = "pd-worker"
        pre = a.inference(pd_params(text, key, url, decode_worker=wb.api.worker_id,
                                    target_worker="A"))
        # the decode stage as server/pd_flow.py writes it, as a polled job
        params = {k: v for k, v in pd_params(text, key, url).items()
                  if k not in ("pd_stage", "target_worker", "prompt", "prompt_token_ids",
                               "messages", "decode_url")}
        params.update({"pd_stage": "decode", "target_worker": wb.api.worker_id,
                       "kv_cache_key": key, "pd_prefill_result": {
                           k: pre.get(k) for k in ("first_token", "ttft_ms", "migration_bytes",
                                                   "migration_ms")}})
        jid = plane.queue_job(params)
        done = wait_until(lambda: plane.job(jid)["status"] in ("completed", "failed"), 300)
        job = plane.job(jid)
        # a streamed push that loses every piece: A aborts, B counts it
        plan = faults.FaultPlan(0, [faults.FaultRule(site="worker.pd.push", kind="flap",
                                                     times=None, match={"kind": "piece"})])
        with faults.active(plan):
            try:
                a.inference(pd_params(text, "pd-worker-lost", url,
                                      decode_worker=wb.api.worker_id, target_worker="A"))
                lost = False
            except Exception:  # noqa: BLE001 — the push must fail
                lost = True
        beat = wait_until(lambda: any(
            (h.get("engine_stats") or {}).get("pd", {}).get("rx_aborts")
            for h in plane.heartbeats if h["worker"] == wb.api.worker_id), 30)
        pd_block = next((h["engine_stats"]["pd"] for h in reversed(plane.heartbeats)
                         if h["worker"] == wb.api.worker_id
                         and "pd" in (h.get("engine_stats") or {})), None)
        ids = (job.get("result") or {}).get("token_ids") or []
        vocab = a.engine.model_cfg.vocab_size
        good = (len(ids) == PD_TOKENS and ids[0] == pre["first_token"]
                and all(0 <= t < vocab for t in ids))
        print(f"[pd] (f) worker B through cmd_start: registered with role "
              f"{reg.get('role')!r} and data_plane_url {reg.get('data_plane_url')!r}; A pushed "
              f"{pre['migration_bytes']} B to its data plane; the decode-stage job (pd_flow's "
              f"params) polled and {job['status']} with {len(ids)} tokens in vocabulary, the "
              f"first A's: {good}; a push losing every piece failed on A ({lost}) and B's "
              f"heartbeat pd block {pd_block} ({smi})", flush=True)
        if not (done and job["status"] == "completed" and good and lost and beat
                and reg.get("role") == "decode" and reg.get("data_plane_url") == url
                and pre["local"] is False):
            raise AssertionError(f"[pd] (f) failed: {job}")
        wb.request_shutdown()
        th.join(timeout=300)
        if th.is_alive() or plane.rejected:
            raise AssertionError(f"[pd] (f) worker B did not stop cleanly: {plane.rejected}")
    finally:
        if th is not None and th.is_alive():
            wb.request_shutdown()
            th.join(timeout=120)
        plane.stop()
        tmp.cleanup()


def int8_serving_engine():
    """Phase 7's engine (phase 16's A for the int8 pools): llama3-8b at
    full width and depth, int8 weights and pools, seed 0, not loaded."""
    from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine

    return TorchLLMEngine({
        "model": "llama3-8b", "max_batch_size": SERVE_BATCH, "max_seq_len": MAX_SEQ,
        "enable_prefix_cache": True, "dtype": "bfloat16", "device": "cuda",
        "seed": 0, "quantization": "int8", "kv_cache_dtype": "int8",
    })


def pd_bf16_phase(torch, pa, smi, prompts, shared):
    """Phase 16 with bf16 pools and the worker roles: A loads llama3-8b
    with int8 weights, serves the 8 prompts, then :func:`pd_phase`."""
    from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine

    t0 = time.perf_counter()
    llm = TorchLLMEngine(pd_engine_config("llama3-8b", "int8", None, "cuda"))
    llm.load_model()
    print(f"[pd] A for the bf16 pools (llama3-8b, int8 weights, seed 0) loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    pd_tokens, pd_payloads, *_ = serve(torch, pa, llm, prompts, shared)
    pd_phase(torch, pa, smi, llm, prompts, (pd_tokens, pd_payloads), None, worker=True)
    llm.unload()
    del llm
    torch.cuda.empty_cache()


def pd_alone(torch, pa, smi, prompts, shared):
    """Phase 16 alone (``--phase 16``): phase 7's engine loaded and serving
    the 8 prompts as A for the int8 pools (phases 7's other checks and 11
    are not run), then the bf16 pools."""
    llm = int8_serving_engine()
    llm.load_model()
    i8_tokens, payloads, *_ = serve(torch, pa, llm, prompts, shared)
    pd_phase(torch, pa, smi, llm, prompts, (i8_tokens, payloads), "int8")
    llm.unload()
    del llm
    torch.cuda.empty_cache()
    pd_bf16_phase(torch, pa, smi, prompts, shared)


def pd_phase(torch, pa, smi, a, prompts, hybrid, kv, model="llama3-8b",
             quantization="int8", device="cuda", worker=False, mismatch=False):
    """Phase 16 for one KV pool on a loaded prefill-side engine A (see the
    module docstring); ``hybrid`` = (A's own greedy ids by prompt ids, the
    payloads of that run). Loads and unloads engine B. Raises on any
    failed check."""
    from distributed_gpu_inference_torch.comm.data_plane import DataPlaneServer
    from distributed_gpu_inference_torch.models.configs import get_model_config
    from distributed_gpu_inference_torch.runtime import kv_handoff as kh
    from distributed_gpu_inference_torch.runtime.engine import EngineConfig, TorchEngine
    from distributed_gpu_inference_torch.testing import faults
    from distributed_gpu_inference_torch.utils.data_structures import (
        InferenceRequest,
        SamplingParams,
    )
    from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine

    tag = f"{kv or 'bf16'} pools"
    t_phase = time.perf_counter()
    hyb_ids, hyb_payloads = hybrid
    a.engine.cfg.prefill_buckets = PD_BUCKETS
    b = TorchLLMEngine(pd_engine_config(model, quantization, kv, device))
    b.load_model()
    tok = a.tokenizer
    planes, split = [], None
    try:
        b_plane = DataPlaneServer(kv_receiver=b.kv_receiver, kv_exporter=b.kv_export)
        a_plane = DataPlaneServer(kv_receiver=a.kv_receiver, kv_exporter=a.kv_export)
        for p in (b_plane, a_plane):
            p.start()
            planes.append(p)
        cap = CapturedRx(b_plane)
        url = b_plane.url
        names = {a.serving.run_exclusive(threading.get_ident): "A",
                 b.serving.run_exclusive(threading.get_ident): "B"}
        pa.reset_launch_counts()
        split = ThreadSplit(names)

        # ---- (a) one request, one-shot and streamed, against A alone
        text = prompts[-1]
        n_tok = len(tok.encode(text))
        clear_cached(a)
        a.inference(pd_params(text, "pd-alone"))
        alone = a.inference({"pd_stage": "decode", "kv_cache_key": "pd-alone"})["token_ids"]
        results = {}
        for mode, stream in (("one-shot", False), ("streamed", True)):
            clear_cached(a)
            clear_cached(b)
            key = f"pd-a-{mode}"
            pre = a.inference(pd_params(text, key, url, pd_stream=stream))
            n_blocks, same = adopted_equal(torch, b, key, cap.wire_pages(key))
            dec = b.inference({"pd_stage": "decode", "kv_cache_key": key})
            results[mode] = (pre, dec)
            print(f"[pd] {tag} (a) {mode}: {n_tok}-token prompt, {pre['migration_bytes']} B "
                  f"pushed ({pre.get('pieces', 1)} message(s) of pages, "
                  f"{pre.get('bytes_before_first_token', 0)} B before the first token); B's "
                  f"{n_blocks} adopted pages and scales read back bit-identical to the wire: "
                  f"{same}; greedy ids equal to A alone: {dec['token_ids'] == alone}", flush=True)
            if not same or dec["token_ids"] != alone or pre["local"] is not False:
                raise AssertionError(f"[pd] {tag} (a) {mode}: {dec['token_ids']} vs {alone}")

        # ---- (b) the 8 serving prompts, PD and streamed, decoding together on B;
        # first A's hybrid run of them, traced: A prefills each (the single-row
        # chunks a PD prefill runs) and decodes all 8 together in its rounds
        clear_cached(a)
        hyb_trace = SampleTrace(torch, [a.engine], "pd-h-")
        hyb_rows = [None] * len(prompts)

        def local_prefill(i):
            clear_cached(a)
            return a.inference(pd_params(prompts[i], f"pd-h-{i}"))

        hyb_ttft = [None] * len(prompts)

        def local_decode(i, pre):
            hyb_ttft[i] = pre["ttft_ms"]
            hyb_rows[i] = a.inference({"pd_stage": "decode",
                                       "kv_cache_key": f"pd-h-{i}"})["token_ids"]

        try:
            in_turns(len(prompts), local_prefill, local_decode)
        finally:
            hyb_trace.close()
        if any(r is None for r in hyb_rows):
            raise AssertionError(f"[pd] {tag} (b): A's hybrid run did not finish")
        ttft, mig, failed = {}, {}, []
        for mode, stream in (("streamed", True), ("one-shot", False)):
            clear_cached(a)
            clear_cached(b)
            peak = [0]
            real = b.engine.decode_multi

            def decode_multi(*args, _real=real, **kw):
                peak[0] = max(peak[0], b.engine.num_active)
                return _real(*args, **kw)

            b.engine.decode_multi = decode_multi
            trace = SampleTrace(torch, [a.engine, b.engine], f"pd-b-{mode}-")
            out = [None] * len(prompts)

            def pd_prefill(i, stream=stream):
                clear_cached(a)
                return a.inference(pd_params(prompts[i], f"pd-b-{mode}-{i}", url,
                                             pd_stream=stream))

            def pd_decode(i, pre):
                out[i] = (pre, b.inference({"pd_stage": "decode",
                                            "kv_cache_key": f"pd-b-{mode}-{i}"}))

            try:
                in_turns(len(prompts), pd_prefill, pd_decode)
            finally:
                del b.engine.decode_multi
                trace.close()
            if any(o is None for o in out):
                raise AssertionError(f"[pd] {tag} (b) {mode}: a request did not finish")
            rows = [(tok.encode(p), o[1]["token_ids"]) for p, o in zip(prompts, out)]
            ttft[mode] = [o[0]["ttft_ms"] for o in out]
            mig[mode] = [o[0]["migration_ms"] for o in out]
            # A's hybrid run prefilled each prompt as a one-shot PD prefill
            # does (one single-row forward when the prompt fits a chunk:
            # runtime/engine.py submit_batch, a prompt alone in its bucket;
            # single-row chunks beyond), and a streamed prompt prefills by
            # single-row chunks too, so every PD stream must equal it
            # exactly. Where one parts all the same, both runs' top-2 are
            # printed
            multi = [len(ids) > PD_BUCKETS[-1] for ids, _ in rows]
            parts, unequal = [], []
            for r, (ids, toks_) in enumerate(rows):
                want = hyb_rows[r]
                d = next((k for k, (x, y) in enumerate(zip(toks_, want)) if x != y), None)
                if d is None:
                    continue
                unequal.append((r, d))
                if mode == "one-shot" or multi[r]:
                    continue
                top_b, short_b = trace.deficit(f"pd-b-{mode}-{r}", len(ids) + d, want[d])
                top_a, short_a = hyb_trace.deficit(f"pd-h-{r}", len(ids) + d, toks_[d])
                parts.append(f"request {r} token {d}: PD {toks_[d]} vs hybrid {want[d]}; "
                             f"PD top-2 {top_b}, the hybrid token {short_b:.4f} below; "
                             f"hybrid top-2 {top_a}, the PD token {short_a:.4f} below; "
                             f"within {NEAR_TIE}: {min(short_a, short_b) < NEAR_TIE}")
            same = sum(x == y for (_, t), h in zip(rows, hyb_rows) for x, y in zip(t, h))
            # information: the serving run before this phase admitted the
            # same prompts together in ragged rounds (other prefill shapes)
            batched = sum(x == y for (ids, t) in rows
                          for x, y in zip(t, hyb_ids.get(tuple(ids), [])))
            line = (f"[pd] {tag} (b) 8 prompts PD {mode}"
                    + (f" (pieces of {PD_PIECE_BLOCKS} blocks)" if mode == "streamed" else "")
                    + f", decoding together on B (up to {peak[0]} slots a round): {same}/"
                    f"{sum(len(t) for _, t in rows)} tokens equal to A's hybrid run, "
                    f"{len(rows)} streams held equal: "
                    f"{not unequal} {unequal or ''}; {batched} tokens equal to the batched "
                    f"serving run (information)")
            if mode == "streamed":
                early = [o[0]["bytes_before_first_token"]
                         for o, m in zip(out, multi) if m]
                line += (f"; where a one-chunk prompt parts: {parts or 'nowhere'}; bytes "
                         f"before the first token of the {len(early)} prompts past one "
                         f"{PD_BUCKETS[-1]}-token chunk: {early}")
                if not early or not all(x > 0 for x in early):
                    raise AssertionError(f"[pd] {tag} (b): no bytes before the first token")
            print(line, flush=True)
            if mode == "streamed":
                # judged in the logits each run sampled (B's streams and A's
                # hybrid run, both traced): a fork is a near-tie there, and a
                # runner-up planted in a stream is rejected
                check_sampled(f"pd {tag} (b) streamed", rows,
                              [(ids, h) for (ids, _), h in zip(rows, hyb_rows)],
                              trace.runs() + hyb_trace.runs(), "A's hybrid run")
            if unequal or peak[0] < 2:
                failed.append(f"[pd] {tag} (b) {mode}: streams part from A's hybrid run "
                              f"{unequal}, peak {peak[0]}")
            vocab = a.engine.model_cfg.vocab_size
            if any(len(t) != PD_TOKENS or not all(0 <= x < vocab for x in t) for _, t in rows):
                failed.append(f"[pd] {tag} (b) {mode}: bad tokens {rows}")
        print(f"[pd] {tag} TTFT p50 of the 8 requests prefilled one after another "
              f"(information): PD "
              f"streamed {pctl(ttft['streamed'], 0.5):.1f} ms, PD one-shot "
              f"{pctl(ttft['one-shot'], 0.5):.1f} ms, A hybrid {pctl(hyb_ttft, 0.5):.1f} ms; "
              f"the batched serving run before the phase (all 8 admitted at once) "
              f"{pctl([p['ttft_ms'] for p in hyb_payloads], 0.5):.1f} ms; migration_ms p50 / "
              f"max: PD streamed {pctl(mig['streamed'], 0.5):.1f} / {max(mig['streamed']):.1f} "
              f"ms, PD one-shot {pctl(mig['one-shot'], 0.5):.1f} / {max(mig['one-shot']):.1f} "
              f"ms ({smi})", flush=True)
        one = [i for i, p in enumerate(prompts) if len(tok.encode(p)) <= PD_BUCKETS[-1]]
        print(f"[pd] {tag} TTFT of the {len(one)} prompts within one chunk (information): "
              + "; ".join(f"{name} {[round(t[i], 1) for i in one]} ms" for name, t in (
                  ("PD streamed", ttft["streamed"]), ("PD one-shot", ttft["one-shot"]),
                  ("A hybrid", hyb_ttft))), flush=True)
        if failed:
            raise AssertionError("; ".join(failed))

        # ---- (c) the device path
        clear_cached(a)
        clear_cached(b)
        req = InferenceRequest(prompt_token_ids=tok.encode(text), sampling=SamplingParams(
            max_new_tokens=PD_TOKENS, ignore_eos=True), session_id="pd-device")
        ea, eb = a.engine, b.engine
        slot = a.serving.run_exclusive(lambda: ea.submit(req))
        src_blocks = list(ea.manager.seq_blocks[ea.slots[slot].seq_id])
        dslot = b.serving.run_exclusive(lambda: kh.migrate_kv_device(ea, eb, slot))
        dst_blocks = list(eb.manager.seq_blocks[eb.slots[dslot].seq_id])
        raw = lambda t: t.contiguous().view(torch.uint8)  # noqa: E731
        pages_same = all(torch.equal(raw(ea.kv[k][:, src_blocks]), raw(eb.kv[k][:, dst_blocks]))
                         for k in ea.kv)
        a.serving.run_exclusive(lambda: ea.finish_slot(slot, cache=False))
        moved = b.serving.adopt_slot(dslot).token_ids
        # one-layer engines of the same model name: another KV dtype on the
        # card, the same KV dtype on the CPU (skipped when A is on the CPU)
        refused = []
        small = get_model_config(model, num_layers=1, vocab_size=256)
        cases = [("KV dtype", "int8" if kv is None else None, device)]
        if device != "cpu":
            cases.append(("device", kv, "cpu"))
        for what, eng_kv, dev in cases:
            other = TorchEngine(small, EngineConfig(max_batch_size=1, max_seq_len=MAX_SEQ,
                                                    num_blocks=64, kv_cache_dtype=eng_kv),
                                seed=0, device=dev)
            slot = a.serving.run_exclusive(lambda: ea.submit(req))
            try:
                a.serving.run_exclusive(lambda: kh.migrate_kv_device(ea, other, slot))
                refused.append(False)
            except ValueError as exc:
                refused.append(("kv_cache_dtype" in str(exc)) == (what == "KV dtype"))
            finally:
                a.serving.run_exclusive(lambda: ea.finish_slot(slot, cache=False))
            del other
        print(f"[pd] {tag} (c) migrate_kv_device A -> B on one card: pages and scales "
              f"bit-identical: {pages_same}; continued on B equal to A alone: "
              f"{moved == alone}; refused a different KV dtype and a CPU engine: {refused}",
              flush=True)
        if not (pages_same and moved == alone and refused and all(refused)):
            raise AssertionError(f"[pd] {tag} (c) failed")

        # ---- (d) cluster KV migration: B pulls a hot prefix from A's /kv/export
        shared = prompts[3][:128]
        t_hot = shared + spill_text(7, 300)
        t_cold = shared + spill_text(8, 300)
        clear_cached(b)
        b.inference({"prompt": shared + "x" * 40, "max_new_tokens": 1, "ignore_eos": True})
        for t_ in (t_hot, t_cold):
            a.inference({"prompt": t_, "max_new_tokens": 1, "ignore_eos": True})
        ids = tok.encode(t_hot)
        n_full = len(ids) // BK
        local = len(eb.manager.radix.match_prefix(ids))
        st = b.kv_migrate_stats
        before = dict(st)
        t0 = time.perf_counter()
        out = b.inference({"prompt": t_hot, "max_new_tokens": 1, "ignore_eos": True,
                           "kv_migrate_from": {"data_plane_url": a_plane.url,
                                               "worker_id": "A", "tier": "dev"}})
        pull_wall = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        b.inference({"prompt": t_cold, "max_new_tokens": 1, "ignore_eos": True})
        cold_wall = (time.perf_counter() - t0) * 1e3
        shipped = st["pull_blocks"] - before["pull_blocks"]
        a_blocks = ea.manager.radix.match_prefix(ids)
        b_blocks = eb.manager.radix.match_prefix(ids)
        pulled_same = len(a_blocks) == len(b_blocks) == n_full and all(
            torch.equal(raw(ea.kv[k][:, a_blocks[local:]]), raw(eb.kv[k][:, b_blocks[local:]]))
            for k in ea.kv)
        print(f"[pd] {tag} (d) B held {local} of the {n_full} full blocks and pulled the rest "
              f"from A's /kv/export: pulled {st['pulled'] - before['pulled']}, "
              f"{shipped} blocks shipped, {st['pull_bytes'] - before['pull_bytes']} B; pulled "
              f"pages bit-identical to A's: {pulled_same}; served with "
              f"{out['usage']['cached_tokens']} tokens cached; wall to the first token "
              f"(information): with the pull {pull_wall:.1f} ms, recomputed {cold_wall:.1f} ms "
              f"({smi})", flush=True)
        if not (st["pulled"] == before["pulled"] + 1 and shipped == n_full - local
                and pulled_same and out["usage"]["cached_tokens"] >= (n_full - 1) * BK):
            raise AssertionError(f"[pd] {tag} (d) failed: {st}")

        # ---- (e) faults through a port fault plan
        def blocks_free():
            return b.serving.run_exclusive(lambda: eb.manager.num_reclaimable)

        free0 = blocks_free()
        rx0 = dict(b._handoff_rx.stats)
        aborted0 = a.pd_stats["handoffs_aborted"]
        plan = faults.FaultPlan(0, [faults.FaultRule(site="kv.receiver.message",
                                                     kind="truncate", cut=64, after=1,
                                                     times=1)])
        with faults.active(plan):
            try:
                a.inference(pd_params(prompts[5], "pd-e-corrupt", url))
                corrupt_failed = False
            except Exception:  # noqa: BLE001 — the handoff must fail
                corrupt_failed = True
        corrupt_ok = (corrupt_failed and blocks_free() == free0 and not b._handoff_rx._sessions
                      and a.pd_stats["handoffs_aborted"] == aborted0 + 1)
        retries0 = a.pd_stats["piece_retries"]
        plan = faults.FaultPlan(0, [faults.FaultRule(site="worker.pd.push", kind="drop",
                                                     times=1, match={"kind": "piece"})])
        with faults.active(plan):
            pre, dec = pd_run(a, b, url, prompts[5], "pd-e-blip")
        blip_ok = (a.pd_stats["piece_retries"] == retries0 + 1
                   and len(dec["token_ids"]) == PD_TOKENS)
        plan = faults.FaultPlan(0, [faults.FaultRule(site="worker.pd.push", kind="error",
                                                     status=409, times=1,
                                                     match={"kind": "begin"})])
        free1 = blocks_free()
        with faults.active(plan):
            try:
                a.inference(pd_params(prompts[5], "pd-e-4xx", url))
                rejected = False
            except Exception as exc:  # noqa: BLE001
                rejected = "409" in str(exc)
        reject_ok = (rejected and a.pd_stats["piece_retries"] == retries0 + 1
                     and blocks_free() == free1)
        print(f"[pd] {tag} (e) a piece truncated at kv.receiver.message aborted the session "
              f"(B's reclaimable blocks {free0} -> {blocks_free()}, receiver stats "
              f"{ {k: v - rx0.get(k, 0) for k, v in b._handoff_rx.stats.items() if v != rx0.get(k, 0)} }): "
              f"{corrupt_ok}; a dropped piece push retried (piece_retries +"
              f"{a.pd_stats['piece_retries'] - retries0}) and the request completed: "
              f"{blip_ok}; an injected 409 on the begin failed the push with no retry: "
              f"{reject_ok}", flush=True)
        if not (corrupt_ok and blip_ok and reject_ok):
            raise AssertionError(f"[pd] {tag} (e) failed")

        # ---- (f) the worker roles
        if worker:
            pd_worker_check(torch, a, text, smi, model, quantization)

        if device == "cuda":
            torch.cuda.synchronize()
        counts = pa.launch_counts()
        sa, sb = split.of("A"), split.of("B")
        split.close()
        split = None
        print(f"[pd] {tag} kernel launches over the phase: {counts}; by engine (attention "
              f"wrapper calls, qmm kernel launches): A {sa}, B {sb} (B's ragged calls are its "
              f"admission rounds: (d)'s serving)", flush=True)
        check_counts(f"pd {tag}", counts, qmm=quantization is not None)
        # qmm's kernel launches only on the card (its plain version on the CPU)
        if not (sa["ragged_paged_attention"] > 0 and sb["paged_decode_attention_fused"] > 0
                and (quantization is None or device == "cpu"
                     or (sa["qmm_w8a16"] > 0 and sb["qmm_w8a16"] > 0))):
            raise AssertionError(f"[pd] {tag}: an engine's kernels did not run: A {sa} B {sb}")
        pd_times(torch, a, b, tag, text, smi)
        print(f"[pd] {tag} phase ran in {time.perf_counter() - t_phase:.1f} s ({smi})",
              flush=True)
    finally:
        if split is not None:
            split.close()
        for p in planes:
            p.stop()
        b.unload()
        del b


# ---- phase 17: weights and tokenizer from local files

CKPT_SEED = 17
CKPT_SHARDS = 4
CKPT_MERGES = 2048          # BPE merges learned from the repo's own text
LOCAL_TOKENS = 32           # greedy tokens of each phase-17 request
# safetensors dtype names of the dtypes the writer takes
ST_NAMES = {"torch.bfloat16": "BF16", "torch.float16": "F16", "torch.float32": "F32",
            "torch.float64": "F64", "torch.int8": "I8", "torch.uint8": "U8",
            "torch.int16": "I16", "torch.int32": "I32", "torch.int64": "I64",
            "torch.bool": "BOOL", "torch.float8_e4m3fn": "F8_E4M3",
            "torch.float8_e5m2": "F8_E5M2"}
LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
                r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
LLAMA3_SPECIALS = (["<|begin_of_text|>", "<|end_of_text|>", "<|reserved_special_token_0|>",
                    "<|reserved_special_token_1|>", "<|finetune_right_pad_id|>",
                    "<|reserved_special_token_2|>", "<|start_header_id|>",
                    "<|end_header_id|>", "<|eom_id|>", "<|eot_id|>", "<|python_tag|>"]
                   + [f"<|reserved_special_token_{i}|>" for i in range(3, 248)])
LLAMA3_TEMPLATE = (
    "{{- bos_token }}\n"
    "{%- for message in messages %}\n"
    "{{- '<|start_header_id|>' + message['role'] + '<|end_header_id|>\\n\\n' + "
    "message['content'] | trim + '<|eot_id|>' }}\n"
    "{%- endfor %}\n"
    "{%- if add_generation_prompt %}\n"
    "{{- '<|start_header_id|>assistant<|end_header_id|>\\n\\n' }}\n"
    "{%- endif %}\n")


def write_safetensors(path, entries, metadata=None):
    """Write one safetensors file: an 8-byte little-endian header length,
    the JSON header (padded with spaces to 8 bytes), then each tensor's
    raw bytes in order. ``entries``: (name, dtype, shape, make), where
    ``make()`` gives the tensor (on any device) when its bytes are due, so
    a shard never sits whole in memory. → bytes written."""
    import math
    import struct

    import torch

    header, off = {}, 0
    for name, dtype, shape, _ in entries:
        n = math.prod(shape) * dtype.itemsize
        header[name] = {"dtype": ST_NAMES[str(dtype)], "shape": list(shape),
                        "data_offsets": [off, off + n]}
        off += n
    if metadata is not None:
        header["__metadata__"] = metadata
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name, dtype, shape, make in entries:
            t = make()
            if t.dtype != dtype or tuple(t.shape) != tuple(shape):
                raise AssertionError(f"{name}: made {t.dtype} {tuple(t.shape)}, "
                                     f"declared {dtype} {tuple(shape)}")
            f.write(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().data)
    return 8 + len(raw) + off


def learn_merges(text, n):
    """Greedy byte-level BPE merges from ``text``, pre-tokenized with Llama
    3's split regex (:func:`learn_word_merges`). → [(a, b), ...] in rank
    order."""
    import collections
    import re

    from distributed_gpu_inference_torch.utils.hf_tokenizer import (
        _bytes_to_unicode,
        translate_pattern,
    )

    table = _bytes_to_unicode()
    return learn_word_merges(collections.Counter(
        "".join(table[b] for b in m.group(0).encode("utf-8"))
        for m in re.finditer(translate_pattern(LLAMA3_SPLIT), text)), n)


def learn_word_merges(words, n):
    """Greedy BPE merges over ``words`` (a Counter of words): merge the most
    frequent adjacent pair (the largest pair among ties) ``n`` times,
    counts kept up to date word by word. → [(a, b), ...] in rank order."""
    import collections

    syms = [list(w) for w in words]
    freq = list(words.values())
    pairs = collections.Counter()
    where = collections.defaultdict(set)
    for i, s in enumerate(syms):
        for pair in zip(s, s[1:]):
            pairs[pair] += freq[i]
            where[pair].add(i)
    merges = []
    while len(merges) < n and pairs:
        best = max(pairs, key=lambda p: (pairs[p], p))
        if pairs[best] < 2:
            break
        merges.append(best)
        for i in list(where.pop(best, ())):
            s = syms[i]
            for pair in zip(s, s[1:]):
                pairs[pair] -= freq[i]
                if pairs[pair] <= 0:
                    del pairs[pair]
            out, j = [], 0
            while j < len(s):
                if j + 1 < len(s) and (s[j], s[j + 1]) == best:
                    out.append(s[j] + s[j + 1])
                    j += 2
                else:
                    out.append(s[j])
                    j += 1
            syms[i] = out
            for pair in zip(out, out[1:]):
                pairs[pair] += freq[i]
                where[pair].add(i)
    return merges


def write_llama3_tokenizer(d, text, n_merges=CKPT_MERGES):
    """A Llama 3-style ``tokenizer.json`` + ``tokenizer_config.json`` in
    ``d``: the split regex, the 256 ByteLevel symbols, ``n_merges`` merges
    learned from ``text`` and unreachable fillers up to id 128000,
    ``ignore_merges``, the special tokens from id 128000, ``TemplateProcessing`` BOS, ``clean_up_tokenization_spaces``
    and a chat template. → the number of merges."""
    import pathlib

    from distributed_gpu_inference_torch.utils.hf_tokenizer import _bytes_to_unicode

    merges = learn_merges(text, n_merges)
    vocab = {c: i for i, c in enumerate(_bytes_to_unicode().values())}
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    # tokens no merge reaches fill the vocab to Llama 3's 128000, where the
    # special tokens start (a tokenizer.json numbers its added tokens on
    # from the vocab's end)
    while len(vocab) < 128000:
        vocab[f"<|unused_{len(vocab)}|>"] = len(vocab)
    bos = LLAMA3_SPECIALS[0]
    tok = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": 128000 + i, "content": t, "single_word": False,
                          "lstrip": False, "rstrip": False, "normalized": False,
                          "special": True} for i, t in enumerate(LLAMA3_SPECIALS)],
        "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_SPLIT}, "behavior": "Isolated",
             "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
             "use_regex": False}]},
        "post_processor": {"type": "Sequence", "processors": [
            {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": False,
             "use_regex": True},
            {"type": "TemplateProcessing",
             "single": [{"SpecialToken": {"id": bos, "type_id": 0}},
                        {"Sequence": {"id": "A", "type_id": 0}}],
             "pair": [{"SpecialToken": {"id": bos, "type_id": 0}},
                      {"Sequence": {"id": "A", "type_id": 0}},
                      {"SpecialToken": {"id": bos, "type_id": 1}},
                      {"Sequence": {"id": "B", "type_id": 1}}],
             "special_tokens": {bos: {"id": bos, "ids": [128000], "tokens": [bos]}}}]},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                    "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": False, "byte_fallback": False, "ignore_merges": True,
                  "vocab": vocab, "merges": [[a, b] for a, b in merges]},
    }
    config = {"bos_token": bos, "eos_token": "<|eot_id|>",
              "clean_up_tokenization_spaces": True, "model_max_length": 131072,
              "tokenizer_class": "PreTrainedTokenizerFast", "chat_template": LLAMA3_TEMPLATE}
    d = pathlib.Path(d)
    (d / "tokenizer.json").write_text(json.dumps(tok, ensure_ascii=False), encoding="utf-8")
    (d / "tokenizer_config.json").write_text(json.dumps(config, indent=2), encoding="utf-8")
    return len(merges)


MIXTRAL_MERGES = 2048        # phase 19's merges learned from the repo's own text
MIXTRAL_VOCAB = 32000
SP_SPACE = "\u2581"          # SentencePiece's space
MIXTRAL_TEMPLATE = (
    "{{ bos_token }}{% for message in messages %}"
    "{% if (message['role'] == 'user') != (loop.index0 % 2 == 0) %}"
    "{{ raise_exception('Conversation roles must alternate user/assistant/user/assistant/...') }}"
    "{% endif %}"
    "{% if message['role'] == 'user' %}{{ '[INST] ' + message['content'] + ' [/INST]' }}"
    "{% elif message['role'] == 'assistant' %}{{ message['content'] + eos_token }}"
    "{% else %}{{ raise_exception('Only user and assistant roles are supported!') }}"
    "{% endif %}{% endfor %}")


def write_mixtral_tokenizer(d, text, n_merges=MIXTRAL_MERGES, vocab_size=MIXTRAL_VOCAB):
    """A Mixtral-style ``tokenizer.json`` + ``tokenizer_config.json`` in
    ``d``: SentencePiece-style byte-fallback BPE as Mixtral's own file has
    it (``<unk>``, ``<s>``, ``</s>`` at 0-2, the 256 ``<0xXX>`` pieces at
    3-258, the characters of ``text``, ``n_merges`` merges learned from its
    words cut before every SentencePiece space, unreachable fillers up to
    ``vocab_size``), the ``Prepend`` / ``Replace`` normalizers and no
    pre-tokenizer, the decoder chain ``Replace``, ``ByteFallback``,
    ``Fuse``, ``Strip``, a ``<s>`` template and Mixtral's chat template.
    → the number of merges."""
    import collections
    import pathlib

    normalized = SP_SPACE + text.replace(" ", SP_SPACE)
    cuts = [i for i, c in enumerate(normalized) if c == SP_SPACE and i > 0]
    words = collections.Counter(normalized[a:b] for a, b in
                                zip([0] + cuts, cuts + [len(normalized)]))
    merges = learn_word_merges(words, n_merges)
    specials = ["<unk>", "<s>", "</s>"]
    vocab = {t: i for i, t in enumerate(specials)}
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    for c in sorted(set(normalized)):
        vocab.setdefault(c, len(vocab))
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    while len(vocab) < vocab_size:
        vocab[f"<unused_{len(vocab)}>"] = len(vocab)
    tok = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": i, "content": t, "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": False, "special": True}
                         for i, t in enumerate(specials)],
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": SP_SPACE},
            {"type": "Replace", "pattern": {"String": " "}, "content": SP_SPACE}]},
        "pre_tokenizer": None,
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                     {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "<s>", "type_id": 1}},
                     {"Sequence": {"id": "B", "type_id": 1}}],
            "special_tokens": {"<s>": {"id": "<s>", "ids": [1], "tokens": ["<s>"]}}},
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": SP_SPACE}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": True, "byte_fallback": True, "ignore_merges": False,
                  "vocab": vocab, "merges": [[a, b] for a, b in merges]},
    }
    config = {"tokenizer_class": "LlamaTokenizer", "bos_token": "<s>", "eos_token": "</s>",
              "unk_token": "<unk>", "add_bos_token": True, "add_eos_token": False,
              "legacy": True, "clean_up_tokenization_spaces": False,
              "model_max_length": 32768, "chat_template": MIXTRAL_TEMPLATE}
    d = pathlib.Path(d)
    (d / "tokenizer.json").write_text(json.dumps(tok, ensure_ascii=False), encoding="utf-8")
    (d / "tokenizer_config.json").write_text(json.dumps(config, indent=2), encoding="utf-8")
    return len(merges)


def hf_llama_entries(torch, cfg, dev, seed=CKPT_SEED):
    """The tensors of an HF Llama checkpoint of ``cfg`` in HF's names and
    layout (``[out, in]``), in HF's order: (name, dtype, shape, make).
    Tensor i is drawn in f32 from a ``torch.Generator`` on ``dev`` seeded
    ``seed * 100003 + i`` (norms around 1), scaled by fan_in^-0.5 and cast
    to bf16, so ``make()`` gives the same bits every call."""
    h, d, L = cfg.hidden_size, cfg.head_dim, cfg.num_layers
    nh, nkv, inter, v = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size, cfg.vocab_size
    shapes = [("model.embed_tokens.weight", (v, h))]
    for li in range(L):
        p = f"model.layers.{li}."
        shapes += [(p + "input_layernorm.weight", (h,)),
                   (p + "self_attn.q_proj.weight", (nh * d, h)),
                   (p + "self_attn.k_proj.weight", (nkv * d, h)),
                   (p + "self_attn.v_proj.weight", (nkv * d, h)),
                   (p + "self_attn.o_proj.weight", (h, nh * d)),
                   (p + "post_attention_layernorm.weight", (h,)),
                   (p + "mlp.gate_proj.weight", (inter, h)),
                   (p + "mlp.up_proj.weight", (inter, h)),
                   (p + "mlp.down_proj.weight", (h, inter))]
    shapes += [("model.norm.weight", (h,))]
    if not cfg.tie_word_embeddings:
        shapes += [("lm_head.weight", (v, h))]

    def maker(i, shape):
        def make():
            g = torch.Generator(device=dev).manual_seed(seed * 100003 + i)
            x = torch.randn(shape, generator=g, device=dev, dtype=torch.float32)
            x = 1.0 + 0.1 * x if len(shape) == 1 else x * shape[-1] ** -0.5
            return x.to(torch.bfloat16)
        return make

    return [(name, torch.bfloat16, shape, maker(i, shape))
            for i, (name, shape) in enumerate(shapes)]


def write_hf_checkpoint(torch, d, cfg, entries, shards=CKPT_SHARDS):
    """``entries`` as ``shards`` files of about equal size, HF's shard
    names, ``model.safetensors.index.json`` and a ``config.json``. →
    bytes written."""
    import math
    import pathlib

    d = pathlib.Path(d)
    sizes = [math.prod(shape) * dtype.itemsize for _, dtype, shape, _ in entries]
    per = sum(sizes) / shards
    groups, acc = [[] for _ in range(shards)], 0
    for e, n in zip(entries, sizes):
        groups[min(shards - 1, int(acc // per))].append(e)
        acc += n
    weight_map, total = {}, 0
    for k, group in enumerate(groups):
        fname = f"model-{k + 1:05d}-of-{shards:05d}.safetensors"
        total += write_safetensors(d / fname, group, metadata={"format": "pt"})
        weight_map.update({name: fname for name, *_ in group})
    (d / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": sum(sizes)}, "weight_map": weight_map}, indent=2))
    (d / "config.json").write_text(json.dumps({
        "architectures": ["LlamaForCausalLM"], "model_type": "llama",
        "hidden_size": cfg.hidden_size, "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads, "vocab_size": cfg.vocab_size,
        "rms_norm_eps": cfg.rms_norm_eps, "rope_theta": cfg.rope_theta,
        "max_position_embeddings": cfg.max_position_embeddings,
        "tie_word_embeddings": cfg.tie_word_embeddings, "torch_dtype": "bfloat16"},
        indent=2))
    return total


# HF layer-tensor suffix → (tree leaf, transposed): phase 17's own map, so
# its check does not lean on the loader's table
HF_TO_TREE = {"input_layernorm.weight": ("attn_norm", False),
              "self_attn.q_proj.weight": ("wq", True), "self_attn.k_proj.weight": ("wk", True),
              "self_attn.v_proj.weight": ("wv", True), "self_attn.o_proj.weight": ("wo", True),
              "post_attention_layernorm.weight": ("mlp_norm", False),
              "mlp.gate_proj.weight": ("w_gate", True), "mlp.up_proj.weight": ("w_up", True),
              "mlp.down_proj.weight": ("w_down", True)}
HF_TOP = {"model.embed_tokens.weight": "embedding", "model.norm.weight": "final_norm",
          "lm_head.weight": "lm_head"}


def local_prompts(readme):
    """Phase 17's requests: six texts and two chats."""
    texts = ["The quick brown fox jumps over the lazy dog.",
             "Grüße aus München — 東京 😀 naïve café",
             readme[:1500],
             "def f(x):\n    return x * 2\n\nprint(f(21))\n",
             "12345 67890 3.14159 2.71828",
             "It's the port's tokenizer; they'll say we've done it ."]
    chats = [[{"role": "system", "content": "You are brief."},
              {"role": "user", "content": "What does a paged KV cache hold?"}],
             [{"role": "user", "content": "Tell me about 東京."},
              {"role": "assistant", "content": "It is a large city."},
              {"role": "user", "content": "How large?"}]]
    return [{"prompt": t} for t in texts] + [{"messages": m} for m in chats]


def same_bits_t(torch, a, b):
    """Two tensors bit for bit (bf16 / f32 / int8 / fp8 alike)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    width = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[a.element_size()]
    return bool(torch.equal(a.contiguous().view(width), b.contiguous().view(width)))


def check_loaded_tree(torch, tree, entries, quantize):
    """Check (c) of phase 17: every written tensor, made again from its
    seed, against its place in a loaded tree; with ``quantize`` the matmul
    weights against ``quantize_params`` of the made slice. → the number of
    tensors checked."""
    import re

    from distributed_gpu_inference_torch.ops.quantization import quantize_params

    bad = []
    for name, _, _, make in entries:
        w = make()
        m = re.match(r"^model\.layers\.(\d+)\.(.+)$", name)
        if m is None:
            ok = same_bits_t(torch, tree[HF_TOP[name]], w)
        else:
            key, transpose = HF_TO_TREE[m.group(2)]
            li = int(m.group(1))
            ref = w.t() if transpose else w
            leaf = tree["layers"][key]
            if quantize and isinstance(leaf, dict):
                q = quantize_params({"layers": {key: ref[None].contiguous()}},
                                    quantize)["layers"][key]
                ok = (same_bits_t(torch, leaf["qw"][li], q["qw"][0])
                      and same_bits_t(torch, leaf["scale"][li], q["scale"][0]))
            else:
                ok = same_bits_t(torch, leaf[li], ref.contiguous())
        if not ok:
            bad.append(name)
    if bad:
        raise AssertionError(f"[local] (c) {len(bad)} tensors differ from the written ones: "
                             f"{bad[:6]}")
    return len(entries)


def tree_bytes(tree):
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def serve_local(torch, llm, requests, stream):
    """Phase 17's requests one at a time as greedy requests of LOCAL_TOKENS
    through ``inference``, or through ``stream_inference`` with ``stream``.
    With the prefix cache off, every run of a request prefills in the same
    shapes, so runs compute the same bits (a cached prefix would prefill
    the rest in other chunks, and random-weight logits are full of
    near-ties). → [(ids, text), ...]."""
    import asyncio

    recorded = {}
    real_submit = llm.serving.submit

    def recording_submit(req, *a, **kw):
        resp = real_submit(req, *a, **kw)
        recorded["ids"] = list(resp.token_ids)
        return resp

    async def collect(params):
        return [c async for c in llm.stream_inference(params)]

    llm.serving.submit = recording_submit
    out = []
    try:
        for i, req in enumerate(requests):
            params = dict(req, max_new_tokens=LOCAL_TOKENS, temperature=0.0, ignore_eos=True)
            if stream:
                chunks = asyncio.run(collect(dict(params, stream_id=f"local-{i}")))
                body, final = chunks[:-1], chunks[-1]
                if any("error" in c for c in chunks) or not final.get("done"):
                    raise AssertionError(f"[local] stream {i} failed: {chunks[-3:]}")
                ids = [t for c in body for t in c.get("token_ids", [])]
                if [c["offset"] for c in body] != list(range(1, len(ids) + 1)):
                    raise AssertionError(f"[local] stream {i}: offsets {[c['offset'] for c in body]}")
                out.append((ids, "".join(c.get("text_delta", "") for c in body)))
            else:
                recorded.clear()
                payload = llm.inference(params)
                out.append((recorded["ids"], payload["text"]))
    finally:
        del llm.serving.submit
    for ids, _ in out:
        if len(ids) != LOCAL_TOKENS:
            raise AssertionError(f"[local] a request produced {len(ids)} tokens")
    return out


def local_files_phase(torch, pa, smi, cfg=None, device="cuda"):
    """Phase 17 (see the module docstring): write a checkpoint of ``cfg``
    (llama3-8b at full depth unless given) and a Llama 3 tokenizer, load
    both through ``TorchLLMEngine`` with int8 weights and int8 pools, hold
    the loaded trees to the written tensors and serve. → the kernel
    launches of the serving run."""
    import math
    import pathlib
    import shutil
    import tempfile

    from distributed_gpu_inference_torch.models import llama
    from distributed_gpu_inference_torch.models.configs import get_model_config
    from distributed_gpu_inference_torch.models.loader import load_hf_llama
    from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine

    t_phase = time.perf_counter()
    dev = torch.device(device)
    cfg = cfg or get_model_config("llama3-8b")
    # the registry's name where the config is the registry's
    model = cfg.name if cfg == get_model_config(cfg.name) else cfg
    entries = hf_llama_entries(torch, cfg, dev)
    need = sum(math.prod(shape) * dtype.itemsize for _, dtype, shape, _ in entries)
    root = tempfile.gettempdir()
    free = shutil.disk_usage(root).free
    print(f"[local] {cfg.name}: {cfg.num_layers} layers, checkpoint of {need} bytes of "
          f"tensors; {free} bytes free under {root}", flush=True)
    if free < need + (2 << 30):
        raise AssertionError(f"[local] {free} bytes free under {root}; the checkpoint needs "
                             f"{need} bytes and 2 GiB to spare")
    readme = pathlib.Path(__file__).with_name("README.md").read_text(encoding="utf-8")
    d = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=root))
    llm = plain = tree = None
    try:
        # ---- (a) write the checkpoint and the tokenizer
        t0 = time.perf_counter()
        written = write_hf_checkpoint(torch, d, cfg, entries)
        t_ck = time.perf_counter() - t0
        n_merges = write_llama3_tokenizer(d, readme)
        print(f"[local] (a) wrote {written} bytes in {CKPT_SHARDS} shards + index in "
              f"{t_ck:.1f} s ({written / t_ck / 1e9:.2f} GB/s, drawn on the card); "
              f"tokenizer.json with {n_merges} merges learned from README.md, the vocab "
              f"filled to 128000, {len(LLAMA3_SPECIALS)} special tokens from 128000", flush=True)

        # ---- (b) load through TorchLLMEngine: int8 weights, int8 pools
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        at_pools = {}
        real_pools = llama.init_kv_pools

        def pools_hook(*a, **kw):
            torch.cuda.synchronize()
            at_pools.setdefault("t", time.perf_counter())
            at_pools.setdefault("peak", torch.cuda.max_memory_allocated())
            return real_pools(*a, **kw)

        llama.init_kv_pools = pools_hook
        try:
            t0 = time.perf_counter()
            llm = TorchLLMEngine({
                "model": model, "checkpoint_path": str(d),
                "tokenizer_id": str(d), "quantization": "int8", "kv_cache_dtype": "int8",
                "max_batch_size": SERVE_BATCH, "max_seq_len": MAX_SEQ, "device": device,
                "prefix_summary_top_n": 0, "enable_prefix_cache": False})
            llm.load_model()
            torch.cuda.synchronize()
            t_load = time.perf_counter() - t0
        finally:
            llama.init_kv_pools = real_pools
        t_weights = at_pools["t"] - t0
        qbytes = tree_bytes(llm.engine.params)
        peak = at_pools["peak"] - base
        print(f"[local] (b) TorchLLMEngine loaded in {t_load:.2f} s (weights and tokenizer "
              f"{t_weights:.2f} s = {need / t_weights / 1e9:.2f} GB/s of file bytes); peak "
              f"device memory before the KV pools {peak} bytes against the int8 tree's "
              f"{qbytes} bytes (+{peak - qbytes}) ({smi})", flush=True)

        # ---- (c) the loaded trees against the written tensors
        n = check_loaded_tree(torch, llm.engine.params, entries, "int8")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree = load_hf_llama(d, cfg, dtype=torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        t_bf16 = time.perf_counter() - t0
        check_loaded_tree(torch, tree, entries, None)
        print(f"[local] (c) int8 codes and scales of all {n} tensors bit-identical to "
              f"quantize_params of the drawn tensors; a bf16 load ({t_bf16:.2f} s = "
              f"{need / t_bf16 / 1e9:.2f} GB/s) bit-identical to the written tensors, leaf "
              f"by leaf", flush=True)

        # ---- (d) serve, against an engine given the same tree as params=
        requests = local_prompts(readme)
        tok = llm.tokenizer
        t0 = time.perf_counter()
        encoded = [tok.encode(llm._to_prompt(r.get("messages") or r["prompt"]))
                   for r in requests]
        t_enc = time.perf_counter() - t0
        pa.reset_launch_counts()
        got = serve_local(torch, llm, requests, stream=False)
        streamed = serve_local(torch, llm, requests, stream=True)
        torch.cuda.synchronize()
        launches = pa.launch_counts()
        print(f"[local] (d) kernel launches over the serving run: {launches}", flush=True)
        check_counts("local", launches, qmm=True)
        plain = TorchLLMEngine({
            "model": model, "params": tree,
            "tokenizer_id": str(d), "quantization": "int8", "kv_cache_dtype": "int8",
            "max_batch_size": SERVE_BATCH, "max_seq_len": MAX_SEQ, "device": device,
            "prefix_summary_top_n": 0, "enable_prefix_cache": False})
        plain.load_model()
        want = serve_local(torch, plain, requests, stream=False)
        t0 = time.perf_counter()
        decoded = [tok.decode(ids) for ids, _ in got]
        t_dec = time.perf_counter() - t0
        for i, ((ids, text), (sids, stext), (pids, _)) in enumerate(zip(got, streamed, want)):
            if ids != pids:
                raise AssertionError(f"[local] request {i}: ids {ids} differ from the params= "
                                     f"engine's {pids}")
            if sids != ids or stext != tok.decode(sids) or text != decoded[i]:
                raise AssertionError(f"[local] request {i}: stream ids / text disagree with "
                                     f"inference ({sids} vs {ids}; {stext!r} vs {text!r})")
        print(f"[local] (d) {len(requests)} requests ({len(requests) - 2} texts, 2 chats; prompts "
              f"of {[len(e) for e in encoded]} tokens) x {LOCAL_TOKENS} greedy tokens through "
              f"inference and stream_inference: ids equal to the params= engine's, stream text "
              f"= decode(ids); tokenizer on the host: encode {t_enc * 1e3:.2f} ms and decode "
              f"{t_dec * 1e3:.2f} ms for the 8 (information); e.g. {got[1][1][:60]!r}",
              flush=True)
        print(f"[local] phase ran in {time.perf_counter() - t_phase:.1f} s ({smi})", flush=True)
        return launches
    finally:
        for eng in (llm, plain):
            if eng is not None:
                eng.unload()
        del llm, plain, tree
        torch.cuda.empty_cache()
        shutil.rmtree(d, ignore_errors=True)


# ---------------------------------------------------------------- the fleet harness

FLEET_TOKENS = 32           # greedy tokens of each phase-18 request
FLEET_HB_TIMEOUT_S = 2.0    # the stand-in plane's heartbeat timeout in phase 18
FLEET_STALL_S = 3.0         # member 1's stall: longer than the timeout and one beat and sweep
FLEET_MEM_SLACK = 512 << 20  # the survivor's activations while the dead member's memory returns


class FleetRecords:
    """Every batcher response of every phase-18 member, incarnation by
    incarnation: (tag, member, prompt ids, ids, checkpoint tokens it resumed
    from, submit / first new token / done times, error). The first new token
    is stamped by an ``observer`` added to the submit (the batcher calls it
    after each round with the slot's generated tokens)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.rows, self.tag = [], "fleet"

    def wrap(self, index, llm):
        real, records = llm.serving.submit, self

        def submit(req, *a, **kw):
            pre = kw.get("resume_from")
            ckpt = list(pre.generated) if pre is not None else []
            row = {"tag": records.tag, "member": index, "prompt": tuple(req.prompt_token_ids),
                   "ckpt": ckpt, "t_submit": time.time(), "t_first": None}
            chained = kw.get("observer")

            def observer(gen):
                if row["t_first"] is None and len(gen) > len(ckpt):
                    row["t_first"] = time.time()
                if chained is not None:
                    chained(gen)

            kw["observer"] = observer
            resp = real(req, *a, **kw)
            row.update(ids=list(resp.token_ids), error=resp.error, t_done=time.time())
            with records.lock:
                records.rows.append(row)
            return resp

        llm.serving.submit = submit

    def of(self, tag, prompt=None):
        with self.lock:
            return [r for r in self.rows if r["tag"] == tag and r["error"] is None
                    and (prompt is None or r["prompt"] == prompt)]


def resumable_stream(first_port, other_port, body, sid, deadline_s=600.0):
    """A direct stream read with ``http.client``: when the connection dies
    before the ``done`` event, it is resumed at the last offset on
    ``other_port`` (a ``resume {stream_id, offset, text_offset}`` body; a
    503 — busy, or the adoption not possible yet — is retried). → (events,
    the offset of each resume)."""
    events, resumes, port = [], [], first_port
    req = dict(body, stream_id=sid)
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=HTTP_TIMEOUT)
        try:
            conn.request("POST", "/inference/stream", body=json.dumps(req).encode(),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            if resp.status == 503 and events:
                resp.read()
                time.sleep(0.2)
                continue
            if resp.status != 200:
                raise AssertionError(f"stream {sid} answered HTTP {resp.status}: "
                                     f"{resp.read()!r}")
            while True:
                line = resp.readline()
                if not line:
                    break
                if line.startswith(b"data: "):
                    events.append(json.loads(line[6:]))
                    if events[-1].get("done") or "error" in events[-1]:
                        return events, resumes
        except (OSError, http.client.HTTPException):
            pass              # the member died mid-stream
        finally:
            conn.close()
        offset = events[-1]["offset"] if events else 0
        resumes.append(offset)
        if len(resumes) > 8:
            raise AssertionError(f"stream {sid}: more than 8 resumes")
        text = "".join(e.get("text_delta") or "" for e in events)
        req = dict(body, stream_id=sid, resume={"stream_id": sid, "offset": offset,
                                                "text_offset": len(text)})
        port = other_port
    raise AssertionError(f"stream {sid} did not finish in {deadline_s} s")


def stream_stretches(runs, prompt, ids, cuts, what):
    """Phase 18's outputs of one stream: (prompt, ids, what) to hold to the
    calm replay. ``runs`` are ``SampleTrace.runs()``, ``cuts`` the offsets
    the stream resumed at. Each stretch between resumes was sampled by one
    run, which began at or before it; a resume past the stream's last
    pushed checkpoint re-generates the delivered tokens after the
    checkpoint unsent, and where one came out otherwise (a near-tie) the
    stream splices two runs. Unspliced, the stream is one output; spliced,
    each stretch is held to the calm replay as the run that sampled it
    (that run's own tokens)."""
    ids, found = list(ids), []
    for a, b in zip([0] + cuts, cuts + [len(ids)]):
        cands = [g for _, p, g, st, o in runs if p == prompt and st <= a
                 and g[a:b] == ids[a:b] and all(j in o for j in range(a, b))]
        gen = next((g for g in cands if g[:a] == ids[:a]), cands[0] if cands else None)
        if gen is None:
            raise AssertionError(f"{what}: no traced run sampled its tokens {a}-{b - 1}")
        found.append((a, b, gen))
    if all(g[:a] == ids[:a] for a, _, g in found):
        return [(prompt, ids, what)]
    out = []
    for a, b, g in found:
        k = next((j for j in range(a) if g[j] != ids[j]), None)
        out.append((prompt, g[:b], f"{what} tokens {a}-{b - 1}" + (
            "" if k is None else f" (a splice: their run re-generated token {k} as "
            f"{g[k]}, the stream holds {ids[k]})")))
    print(f"[fleet] {what} splices runs at its resumes {cuts}: " + "; ".join(
        o[2] for o in out), flush=True)
    return out


def fleet_phase(torch, pa, smi, prompts, model="llama3-8b", quantization="int8",
                device="cuda"):
    """Phase 18 (see the module docstring): two port ``FleetWorker``s in a
    ``LiveFleet`` behind :class:`StandInPlane`, a seeded fault plan with a
    kill, a blackout and a restart under traffic; raises on any failed
    check. → the phase's launch counts."""
    import gc

    from distributed_gpu_inference_torch.testing.faults import FleetEvent, FleetFaultPlan
    from distributed_gpu_inference_torch.testing.harness import (
        DEFAULT_FLEET_ENGINE,
        FleetWorker,
        LiveFleet,
    )

    t_phase = time.perf_counter()
    engine = {**DEFAULT_FLEET_ENGINE, "model": model, "quantization": quantization,
              "max_batch_size": SERVE_BATCH, "max_seq_len": MAX_SEQ, "device": device,
              "seed": 0}
    records = FleetRecords()
    trace = SampleTrace(torch, [], tags=records)
    mem = {"base": torch.cuda.memory_allocated()}
    log = {"cold_start_s": [], "kill_t": None, "after_kill": None}

    class Member(FleetWorker):
        """A fleet member whose every incarnation's responses are recorded,
        that takes 8 shared claims (the batch), whose kill waits for the
        card's memory to come back, and whose blackout is a stall: its
        engine rounds wait as its heartbeats do. When the stall ends, the
        runs it held finish as zombie work before its heartbeats return."""

        def start(self):
            t0 = time.perf_counter()
            super().start()
            log["cold_start_s"].append((self.index, time.perf_counter() - t0))
            self.worker.config.load_control.max_concurrent_jobs = SERVE_BATCH
            records.wrap(self.index, self.llm)
            trace.install(self.llm.engine)
            mem.setdefault(f"loaded{self.index}", torch.cuda.memory_allocated())
            self.awake = threading.Event()
            self.awake.set()
            eng = self.llm.engine
            for name in ("ragged_round", "decode_multi"):
                def gated(*a, _real=getattr(eng, name), **kw):
                    self.awake.wait()
                    return _real(*a, **kw)

                setattr(eng, name, gated)

        def blackout(self, on):
            if on:
                super().blackout(True)
                self.awake.clear()
                log["stall"] = [time.time(), None]
                return
            self.awake.set()
            # held off the plane until its zombie runs have posted
            wait_until(lambda: not self.worker._active_jobs, timeout=120)
            log["stall"][1] = time.time()
            super().blackout(False)

        def kill(self):
            log["kill_t"] = time.time()
            self.awake.set()
            super().kill()
            target = mem["loaded0"] + FLEET_MEM_SLACK
            deadline = time.perf_counter() + 20.0
            while True:
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                now = torch.cuda.memory_allocated()
                if now <= target or time.perf_counter() > deadline:
                    break
                time.sleep(0.1)
            log["after_kill"] = now

    pa.reset_launch_counts()
    plane = StandInPlane(heartbeat_timeout_s=FLEET_HB_TIMEOUT_S)
    fleet = LiveFleet(n=2, planes=[plane], hb_interval_s=0.25, poll_interval_s=0.05,
                      member_factory=lambda i, url, role: Member(i, url, engine))
    with fleet:
        m0, m1 = fleet.members
        ids0 = (m0.worker_id, m1.worker_id)
        tok, vocab = m1.llm.tokenizer, m1.llm.engine.model_cfg.vocab_size
        mem["two"] = torch.cuda.memory_allocated()
        print(f"[fleet] two {model} ({quantization} weights) FleetWorkers up against the "
              f"stand-in plane: {ids0}; cold starts {log['cold_start_s']} s; device memory "
              f"{mem['base'] / 2**30:.2f} -> {mem['loaded0'] / 2**30:.2f} -> "
              f"{mem['two'] / 2**30:.2f} GiB", flush=True)

        # ---- traffic: the 8 prompts twice; every third request a direct stream
        work = [(i, prompts[i % len(prompts)]) for i in range(2 * len(prompts))]
        streams = [(i, p) for i, p in work if i % 3 == 2]
        jobs_in = [(i, p) for i, p in work if i % 3 != 2]
        out, errors = {}, []

        def run_stream(i, p):
            try:
                out[i] = resumable_stream(m0.server.port, m1.server.port, {
                    "type": "llm", "params": {"prompt": p, "max_new_tokens": FLEET_TOKENS,
                                              "temperature": 0.0, "ignore_eos": True}},
                    sid=f"fleet-stream-{i}")
            except BaseException as exc:  # noqa: BLE001 — raised below
                errors.append(exc)

        threads = [threading.Thread(target=run_stream, args=sp, daemon=True) for sp in streams]
        t_traffic = time.time()
        for t in threads:
            t.start()
        jids = {i: plane.queue_job({"prompt": p, "max_new_tokens": FLEET_TOKENS,
                                    "temperature": 0.0, "ignore_eos": True})
                for i, p in jobs_in}

        def member0_busy():
            streaming = sum(1 for h in plane.streams.values() if h["worker_id"] == m0.worker_id
                            and (h["state"] or {}).get("generated"))
            running = [j for j in plane.jobs.values() if j["status"] == "running"
                       and j["worker_id"] == m0.worker_id]
            return streaming >= len(streams) and running

        if not wait_until(member0_busy, timeout=300):
            raise AssertionError("member 0 never held its streams' first tokens and a job")
        # the stall starts 1 s in (the kill's own time included), so member
        # 0's jobs requeue at most 2.25 s in and member 1 is swept at least
        # 2.75 s in: member 1 holds stalled claims at its sweep, its own or
        # member 0's, whichever way the traffic fell
        plan = FleetFaultPlan(18, n_workers=2, duration_s=6.0)
        plan.events = [FleetEvent(0.0, "kill", 0),
                       FleetEvent(1.0, "blackout", 1, duration_s=FLEET_STALL_S),
                       FleetEvent(4.5, "restart", 0)]
        fleet.run_chaos(plan)
        for t in threads:
            t.join(timeout=600)
        fleet.wait_chaos(timeout_s=600)
        if errors:
            raise errors[0]
        done = wait_until(lambda: all(plane.job(j)["status"] in ("completed", "failed")
                                      for j in jids.values()), timeout=600)
        jobs = {i: plane.job(j) for i, j in jids.items()}
        if not done or any(j["status"] != "completed" for j in jobs.values()):
            raise AssertionError(f"fleet jobs: {[(j['id'], j['status'], j['error']) for j in jobs.values()]}")
        print(f"[fleet] chaos plan executed: {plan.trace}; {len(jobs)} jobs completed, "
              f"{len(out)} streams ended", flush=True)

        # ---- exactly once, gapless, checkpoint-prefixed
        completions = {}
        for _, jid, _, _ in plane.completed:
            completions[jid] = completions.get(jid, 0) + 1
        once = all(completions.get(j["id"]) == 1 for j in jobs.values())
        stream_ids, stream_cuts, resumed_streams = {}, {}, 0
        for i, (events, resumes) in out.items():
            _, final, ids, text = split_stream(events)
            if final["offset"] != FLEET_TOKENS or text != tok.decode(ids):
                raise AssertionError(f"stream {i}: final {final}, text {text!r}")
            stream_ids[i], resumed_streams = ids, resumed_streams + bool(resumes)
            stream_cuts[i] = sorted({o for o in resumes if 0 < o < len(ids)})
        rows = records.of("fleet")
        resumed = [r for r in rows if r["ckpt"]]
        prefixed = all(r["ids"][:len(r["ckpt"])] == r["ckpt"] for r in resumed)
        in_vocab = all(0 <= t < vocab for r in rows for t in r["ids"]) and all(
            0 <= t < vocab for ids in stream_ids.values() for t in ids)
        texts = all(any(len(r["ids"]) == FLEET_TOKENS and tok.decode(r["ids"]) ==
                        jobs[i]["result"]["text"] for r in records.of("fleet", tuple(tok.encode(p))))
                    and jobs[i]["result"]["usage"]["completion_tokens"] == FLEET_TOKENS
                    for i, p in jobs_in)
        swept = {jid for _, jid, wid, why, _ in plane.requeues
                 if wid == ids0[1] and why == "heartbeat_stale"}
        fenced = {jid for _, jid, wid, _ in plane.fenced if wid == ids0[1]}
        zombies = bool(fenced) and fenced <= swept
        print(f"[fleet] member 1's stall {log['stall'][1] - log['stall'][0]:.2f} s: swept "
              f"offline with {len(swept)} running jobs requeued {sorted(swept)}; its zombie "
              f"completions fenced for {sorted(fenced)} ({len(plane.fenced)} fenced posts in "
              f"all): {zombies}", flush=True)
        print(f"[fleet] every job completed exactly once: {once}; "
              f"{len(out)} streams gapless 1..{FLEET_TOKENS} with done, "
              f"{resumed_streams} resumed on member 1 at their last offset; ids in vocabulary "
              f"{in_vocab}; job text = decode(ids) {texts}; {len(resumed)} runs resumed from "
              f"a checkpoint, each starting with its checkpoint's tokens: {prefixed}", flush=True)
        if not zombies:
            raise AssertionError("member 1's stall left no fenced zombie completion")
        if not (once and in_vocab and texts and prefixed and resumed_streams == len(streams)):
            raise AssertionError("fleet outputs break exactly-once or the checkpoint prefix")

        # ---- the card's memory, the restarted member
        level = mem["loaded0"]
        mem_ok = log["after_kill"] is not None and log["after_kill"] <= level + FLEET_MEM_SLACK
        same_row = (m0.worker_id, m1.worker_id) == ids0 and m0.alive
        records.tag = "restarted"
        status, body = http_json(m0.server.port, "/inference", {
            "type": "llm", "params": {"prompt": prompts[0], "max_new_tokens": FLEET_TOKENS,
                                      "temperature": 0.0, "ignore_eos": True}})
        served = status == 200 and len(records.of("restarted")) == 1
        print(f"[fleet] after the kill device memory {log['after_kill'] / 2**30:.2f} GiB "
              f"(one engine's level {level / 2**30:.2f} GiB + {FLEET_MEM_SLACK >> 20} MiB): "
              f"{mem_ok}; member 0 restarted on its worker id {m0.worker_id}: {same_row} "
              f"(registrations {len(plane.registrations)}) and served a direct request: "
              f"{served}", flush=True)
        if not (mem_ok and same_row and served):
            raise AssertionError("the killed member's memory or its restart is wrong")

        # ---- calm replay: where an output parts from it, a near-tie in the
        # logits of a run that chose either token there
        records.tag = "calm"
        calm_j = [plane.queue_job({"prompt": p, "max_new_tokens": FLEET_TOKENS,
                                   "temperature": 0.0, "ignore_eos": True}) for p in prompts]
        if not wait_until(lambda: all(plane.job(j)["status"] == "completed" for j in calm_j),
                          timeout=600):
            raise AssertionError("the calm replay did not complete")
        calm = {}
        for r in records.of("calm"):
            calm.setdefault(r["prompt"], r["ids"])
        outputs = [(r["prompt"], r["ids"], f"member {r['member']} job"
                    + (f" resumed from {len(r['ckpt'])} tokens" if r["ckpt"] else ""))
                   for r in rows + records.of("restarted")]
        torch.cuda.synchronize()
        counts = pa.launch_counts()    # the fleet's own launches
        trace.close()
        runs = trace.runs()
        # the trace is aligned with the tokens: each one a run sampled is the
        # argmax of the logits recorded for it, and none is missing
        own = [(gen[j], top) for _, _, gen, start, o in runs for j, top in o.items()
               if j < len(gen)]
        aligned = all(t == ids[0] or vals[0] == vals[1] for t, (vals, ids) in own)
        covered = sum(len(gen) - max(start, 0) for _, _, gen, start, _ in runs)
        print(f"[fleet] {len(runs)} runs traced, {len(own)} of their {covered} sampled tokens "
              f"recorded, each its run's argmax: {aligned}", flush=True)
        if not aligned or len(own) != covered:
            raise AssertionError("the sampled logits do not line up with the tokens")

        for i, p in streams:
            outputs += stream_stretches(runs, tuple(tok.encode(p)), stream_ids[i],
                                        stream_cuts[i], f"stream {i}")

        def chose(prompt, ids, d):
            """The recorded logits of every run that sampled ids[d] itself after
            the prompt and ids[:d]."""
            return [o[d] for _, p, gen, start, o in runs if p == prompt and start <= d
                    and d in o and gen[:d + 1] == list(ids[:d + 1])]

        parted = []
        for prompt, ids, what in outputs:
            want = calm[prompt]
            d = next((k for k, (a, b) in enumerate(zip(ids, want)) if a != b), None)
            if d is not None:
                parted.append((prompt, ids, want, d, what))
        worst = 0.0
        for prompt, ids, want, d, what in parted:
            mine, theirs = chose(prompt, ids, d), chose(prompt, want, d)
            if not (mine and theirs):
                raise AssertionError(f"{what}: no traced run sampled token {d} "
                                     f"({len(mine)} / {len(theirs)})")
            # each run at the fork: how far the other token lay below its own
            fork = sorted([top_deficit(t, want[d]) for t in mine]
                          + [top_deficit(t, ids[d]) for t in theirs], key=lambda x: x[1])
            worst = max(worst, fork[0][1])
            print(f"[fleet] {what} parts from the calm replay at token {d}: {ids[d]} vs "
                  f"{want[d]}; {len(mine)} / {len(theirs)} run(s) chose them there, the other "
                  f"token {fork[0][1]:.4f}-{fork[-1][1]:.4f} below their argmax (nearest top-2 "
                  f"{fork[0][0]}; near-tie bound {NEAR_TIE})", flush=True)
        print(f"[fleet] {len(outputs)} outputs against the calm replay: {len(outputs) - len(parted)}"
              f" identical, {len(parted)} part at a near-tie (the nearest run's deficit up to "
              f"{worst:.4f})", flush=True)
        if worst >= NEAR_TIE:
            raise AssertionError("a fleet output parts from the calm replay beyond a near-tie")

        # ---- information: recovery times and job latency
        kill_t = log["kill_t"]
        requeued = [(t, jid, k) for t, jid, wid, _, k in plane.requeues
                    if wid == ids0[0] and t >= kill_t]
        by_job = {j["id"]: p for (i, p), j in zip(jobs_in, jobs.values())}
        firsts = []
        for t_rq, jid, k in requeued:
            prompt = tuple(tok.encode(by_job[jid])) if jid in by_job else None
            cand = [r["t_first"] for r in rows if r["prompt"] == prompt
                    and r["t_submit"] >= t_rq and r["t_first"] is not None]
            if cand:
                firsts.append(min(cand) - t_rq)
        latency = [(j["completed_at"] - j["created_at"]) * 1e3 for j in jobs.values()]
        restart = [s for i, s in log["cold_start_s"] if i == 0][-1]
        print(f"[fleet] (information) kill -> requeue "
              f"{[round(t - kill_t, 3) for t, _, _ in requeued]} s ({len(requeued)} jobs); "
              f"requeue -> first token where it resumed {[round(f, 3) for f in firsts]} s; the "
              f"restart's cold start {restart:.2f} s; the kill {kill_t - t_traffic:.2f} s after "
              f"the traffic began; job latency queue -> completion p50 "
              f"{pctl(latency, 0.5):.1f} ms p95 {pctl(latency, 0.95):.1f} ms ({smi})", flush=True)
        # the pace of decoding: the resumed jobs shared the card and the
        # process with the other member and the streams; the calm replay
        # ran on one member alone
        pace = {tag: [(r["t_done"] - r["t_first"]) * 1e3 / (len(r["ids"]) - len(r["ckpt"]) - 1)
                      for r in records.of(tag) if r["t_first"] and (tag == "calm" or r["ckpt"])]
                for tag in ("fleet", "calm")}
        p50 = {tag: pctl(v, 0.5) if v else float("nan") for tag, v in pace.items()}
        print(f"[fleet] (information) ms a token after the first, p50: resumed jobs "
              f"{p50['fleet']:.1f} ({len(pace['fleet'])} runs), calm replay "
              f"{p50['calm']:.1f} ({len(pace['calm'])} runs) ({smi})", flush=True)
        if not requeued:
            raise AssertionError("member 0's running jobs were never requeued")
    plane.stop()
    print(f"[fleet] kernel launches of the fleet (its traffic, the restarted member's request "
          f"and the calm replay): {counts}; phase ran in "
          f"{time.perf_counter() - t_phase:.1f} s ({smi})", flush=True)
    check_counts("fleet", counts, qmm=quantization is not None)
    return counts


# ---------------------------------------------------------------- Mixtral MoE

MOE_MODEL = "mixtral-8x7b"
MOE_ROWS = (8, 256)          # one layer's MoE MLP: the decode batch and a prefill chunk
MOE_PREFILL = 2048           # rows of the timed prefill round (8 rows x 256)
# the MoE layer, kernel route vs plain route: each expert's chain rounds to
# bf16 three times (gate and up, their product, the expert's output)
# before the f32 sum, where one qmm rounds once (at M = 256 the library
# route rounds each product before its scale too): errors of a few 1e-3
# std on outputs of order 0.3. The row bound is phase 6's VEC_REL;
# dropping one routed expert's term moves its row by ~0.5.
MOE_ATOL = 2.0 ** -6
INIT_SLACK = 512 << 20       # the init's peak above the int8 tree and one f32 slice


def moe_layer(params, layer):
    """One layer's MoE leaves as views (``forward_chunk``'s slicing)."""
    from distributed_gpu_inference_torch.ops.quantization import is_quantized

    return {name: ({"qw": leaf["qw"][layer], "scale": leaf["scale"][layer]}
                   if is_quantized(leaf) else leaf[layer])
            for name, leaf in params["layers"].items()
            if name in ("w_router", "we_gate", "we_up", "we_down")}


@contextlib.contextmanager
def patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def moe_parity(torch, cfg, lp, rows, g, dev):
    """Check (a) at ``rows`` rows: ``_moe_mlp`` through the kernels
    against the plain route (``qmm_plain`` for every expert) on one input,
    the router's top-k of both, and the negative control (row 0 with its
    first routed expert's term dropped). → max abs err."""
    from distributed_gpu_inference_torch.models import llama

    x = torch.randn((1, rows, cfg.hidden_size), generator=g, device=dev).to(torch.bfloat16)
    xf = x.reshape(rows, -1)
    k = cfg.num_experts_per_tok
    with torch.no_grad():
        topi_k = llama.route_experts(xf, lp["w_router"], k)[1]
        got = llama._moe_mlp(x, lp, cfg)
        with plain_kernels():
            topi_p = llama.route_experts(xf, lp["w_router"], k)[1]
            want = llama._moe_mlp(x, lp, cfg)
            real = llama.route_experts

            def drop_first(xf_, w, k_):
                weights, topi = real(xf_, w, k_)
                weights = weights.clone()
                weights[0, topi[0, 0]] = 0.0
                return weights, topi

            with patched(llama, "route_experts", drop_first):
                dropped = llama._moe_mlp(x, lp, cfg)
    torch.cuda.synchronize()
    same_topk = bool(torch.equal(topi_k, topi_p))
    ok, max_abs, max_vec = errors(torch, got[0], want[0], MOE_ATOL)
    drop_ok, _, drop_vec = errors(torch, dropped[0], want[0], MOE_ATOL)
    print(f"[moe] (a) one layer's MoE MLP at M={rows}, kernel route vs plain: max_abs_err "
          f"{max_abs:.3e} max_row_rel_err {max_vec:.3e} (bound atol {MOE_ATOL:.3e} rtol {RTOL}, "
          f"row {VEC_REL}); router top-{k} identical: {same_topk}; row 0 with its first "
          f"routed expert dropped: max_row_rel_err {drop_vec:.3e}, rejected: {not drop_ok}",
          flush=True)
    if drop_ok:
        raise AssertionError("the MoE parity check accepts a dropped expert term")
    if not (ok and same_topk):
        raise AssertionError(f"the MoE layer disagrees with its plain route at M={rows}")
    return max_abs


class RoutePins:
    """Expert choices pinned across two runs of one model. A discrete choice
    flips where a token's k-th and next router probabilities lie closer
    than two runs' rounding, and a flipped expert moves that token's
    hidden by a step no rounding bound covers (phase 19 prints both
    comparisons unpinned too, as information); so the second run routes
    every token it can find as the first did, weighted by its own
    probabilities, and the flips it would have made are counted.

    ``record()`` keeps, for every forward call, the rows' positions and
    block tables, each layer's choices and the block chain of each live
    sequence (by prompt): a row belongs to the sequence whose chain holds
    the block it writes, since a block with room is never shared.
    ``order()`` replays the choices call by call (the same calls: kernels
    vs plain); ``by_sequence(prompts)`` replays them by (prompt,
    position), row i of each call being prompts[i]."""

    def __init__(self, torch, llama, engine=None):
        self.torch, self.llama, self.engine = torch, llama, engine
        self.calls, self.flips, self.pinned = [], 0, 0

    @contextlib.contextmanager
    def _patched(self, route_with, before_call):
        llama = self.llama
        inner_route, inner_forward = llama.route_experts, llama.forward_chunk

        def forward(cfg, params, token_ids, positions, kv, tables, *a, **kw):
            before_call(positions, tables)
            return inner_forward(cfg, params, token_ids, positions, kv, tables, *a, **kw)

        llama.route_experts = lambda xf, w, k: route_with(inner_route, xf, w, k)
        llama.forward_chunk = forward
        try:
            yield self
        finally:
            llama.route_experts, llama.forward_chunk = inner_route, inner_forward

    def record(self):
        def before(positions, tables):
            chains = {}
            if self.engine is not None:
                m = self.engine.manager
                chains = {tuple(s.request.prompt_token_ids): list(m.seq_blocks[s.seq_id])
                          for s in self.engine.slots
                          if s is not None and s.seq_id in m.seq_blocks}
            self.calls.append({"positions": positions.clone(), "tables": tables.clone(),
                               "chains": chains, "topi": []})

        def route(inner, xf, w, k):
            weights, topi = inner(xf, w, k)
            self.calls[-1]["topi"].append(topi.clone())
            return weights, topi

        return self._patched(route, before)

    def _replay(self, pins_of_call):
        torch, state = self.torch, {}

        def before(positions, tables):
            state["pins"], state["layer"] = pins_of_call(positions), 0

        def route(inner, xf, w, k):
            weights, own = inner(xf, w, k)
            pins = state["pins"]
            pin = pins[state["layer"]] if pins is not None and state["layer"] < len(pins) \
                else None
            state["layer"] += 1
            if pin is None or pin.shape != own.shape:
                return weights, own
            has = pin[:, 0] >= 0
            topi = torch.where(has[:, None], pin, own)
            probs = torch.softmax(xf.float() @ w.float(), dim=-1)
            topv = probs.gather(1, topi)
            weights = torch.zeros_like(probs).scatter_(1, topi, topv / topv.sum(-1, keepdim=True))
            differs = has & (topi.sort(-1).values != own.sort(-1).values).any(-1)
            self.flips += int(differs.sum())
            self.pinned += int(has.sum())
            return weights, topi

        return self._patched(route, before)

    def order(self):
        """Replay the recorded calls' choices in call order."""
        it = iter(self.calls)

        def pins(positions):
            call = next(it, None)
            return None if call is None else call["topi"]

        return self._replay(pins)

    def by_sequence(self, prompts):
        """Replay the choices of each (prompt, position) the record holds."""
        torch = self.torch
        seen = {}
        for call in self.calls:
            if not call["topi"]:
                continue
            pos, tab = call["positions"].cpu().numpy(), call["tables"].cpu().numpy()
            topi = torch.stack(call["topi"]).cpu().numpy()         # [L, rows, k]
            owner = {}
            for prompt, chain in call["chains"].items():
                for li, blk in enumerate(chain):
                    owner[(li, blk)] = prompt
            width = pos.shape[1]
            for b in range(pos.shape[0]):
                live = pos[b][pos[b] >= 0]
                if not live.size:
                    continue
                last = int(live.max())
                prompt = owner.get((last // BK, int(tab[b, last // BK])))
                if prompt is None:
                    continue
                for j in np.nonzero(pos[b] >= 0)[0]:
                    seen[(prompt, int(pos[b, j]))] = topi[:, b * width + j]
        prompts = [tuple(p) for p in prompts]

        def pins(positions):
            pos = positions.cpu().numpy()
            layers = len(next(iter(seen.values()))) if seen else 0
            k = next(iter(seen.values())).shape[-1] if seen else 1
            out = np.full((layers, pos.size, k), -1, np.int64)
            for i, j in zip(*np.nonzero(pos >= 0)):
                hit = seen.get((prompts[i], int(pos[i, j]))) if i < len(prompts) else None
                if hit is not None:
                    out[:, i * pos.shape[1] + j] = hit
            t = torch.from_numpy(out).to(positions.device)
            return [t[layer] for layer in range(layers)]

        return self._replay(pins)


class ExpertTally:
    """Rows each expert received, summed on the device as ``route_experts``
    runs (pad rows included)."""

    def __init__(self, torch, llama, n_experts, dev):
        self.counts = torch.zeros(n_experts, dtype=torch.int64, device=dev)
        self.llama, self.real = llama, llama.route_experts

    def __enter__(self):
        def counting(xf, w, k):
            weights, topi = self.real(xf, w, k)
            self.counts += topi.flatten().bincount(minlength=self.counts.numel())
            return weights, topi

        self.llama.route_experts = counting
        return self

    def __exit__(self, *exc):
        self.llama.route_experts = self.real


def moe_times(torch, cfg, params, lp, dev, flush, smi):
    """Check (d), information: one MoE layer at M = 8 call by call and as a
    CUDA graph against its byte bound and against the same layer on
    pre-dequantized bf16 experts; a full decode step and a 2,048-row
    prefill round of the model; qmm at the three expert shapes. → the
    @moe timings by leaf."""
    from distributed_gpu_inference_torch.models import llama
    from distributed_gpu_inference_torch.ops import qmm

    h, inter, e = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    g = torch.Generator(device=dev).manual_seed(19)
    x = torch.randn((1, SERVE_BATCH, h), generator=g, device=dev).to(torch.bfloat16)
    layer = lambda: llama._moe_mlp(x, lp, cfg)  # noqa: E731
    shapes = [(h, inter)] * (2 * e) + [(inter, h)] * e
    nbytes, flops = qmm_cost(SERVE_BATCH, shapes)
    nbytes += h * e * 2                          # the router
    b_ms, b_by = bound(nbytes, flops)
    k_ms = time_ms(torch, layer, flush, iters=20)
    kg_ms = graph_ms(torch, layer, flush, iters=20)
    deq = {n: (lp[n]["qw"].float() * lp[n]["scale"]).to(torch.bfloat16)
           for n in ("we_gate", "we_up", "we_down")}
    lib = dict(deq, w_router=lp["w_router"])
    l_ms = time_ms(torch, lambda: llama._moe_mlp(x, lib, cfg), flush, iters=20)
    lg_ms = graph_ms(torch, lambda: llama._moe_mlp(x, lib, cfg), flush, iters=20)
    print(f"[moe] (d) on {smi}: one MoE layer at M={SERVE_BATCH} (router + {3 * e} expert "
          f"products): "
          f"{k_ms:.4f} ms call by call, {kg_ms:.4f} ms as a CUDA graph = {b_ms / kg_ms:.1%} of "
          f"the bound {b_ms:.4f} ms ({b_by}: {nbytes} B); the same layer on pre-dequantized "
          f"bf16 experts (torch.matmul): {l_ms:.4f} ms, as a CUDA graph {lg_ms:.4f} ms",
          flush=True)
    out = {}
    for name, (kd, nd) in (("we_gate", (h, inter)), ("we_up", (h, inter)),
                           ("we_down", (inter, h))):
        qw, sc = lp[name]["qw"][0], lp[name]["scale"][0]
        xi = torch.randn((SERVE_BATCH, kd), generator=g, device=dev).to(torch.bfloat16)
        one = lambda: qmm.launch_kernel(xi, qw, sc)  # noqa: E731
        want = qmm.qmm_plain(xi, qw, sc)
        err = errors(torch, one(), want, QMM_ATOL)
        if not err[0]:
            raise AssertionError(f"qmm disagrees with its plain version at {name}'s shape")
        t = {"ms": time_ms(torch, one, flush), "graph_ms": graph_ms(torch, one, flush),
             "plain_ms": time_ms(torch, lambda: qmm.qmm_plain(xi, qw, sc), flush, iters=10),
             "library_ms": time_ms(torch, lambda: torch.matmul(xi, deq[name][0]), flush)}
        t["bound_ms"], t["bound_by"] = bound(*qmm_cost(SERVE_BATCH, [(kd, nd)]))
        print(f"[moe] (d) qmm int8 {name} expert 0 K={kd} N={nd} M={SERVE_BATCH}: kernel "
              f"{t['ms']:.4f} ms, as a CUDA graph {t['graph_ms']:.4f} ms = "
              f"{t['bound_ms'] / t['graph_ms']:.1%} of the bound {t['bound_ms']:.4f} ms; plain "
              f"{t['plain_ms']:.4f} ms; torch.matmul on bf16 {t['library_ms']:.4f} ms; "
              f"max_abs_err {err[1]:.3e}", flush=True)
        out[name] = (t, err[1])
    del deq, lib

    # a decode step of the whole model at batch 8 and a 2,048-row prefill round
    kv = llama.init_kv_pools(cfg, 1 + SERVE_BATCH * 17, BK, torch.bfloat16, dev)
    tables = torch.arange(1, 1 + SERVE_BATCH * 17, device=dev,
                          dtype=torch.int32).reshape(SERVE_BATCH, 17)
    toks = torch.randint(0, 256, (SERVE_BATCH, 256), generator=g, device=dev,
                         dtype=torch.int32)
    pos = torch.arange(256, device=dev, dtype=torch.int32).repeat(SERVE_BATCH, 1)
    lens = torch.full((SERVE_BATCH,), 256, device=dev, dtype=torch.int32)
    with torch.no_grad():
        prefill = lambda: llama.forward_chunk(cfg, params, toks, pos, kv, tables, lens,  # noqa
                                              block_size=BK)
        p_ms = time_ms(torch, prefill, flush, iters=3, warmup=1)
        host = []

        def step():
            t0 = time.perf_counter()
            llama.forward_chunk(cfg, params, toks[:, :1], lens[:, None], kv, tables, lens + 1,
                                block_size=BK)
            host.append((time.perf_counter() - t0) * 1e3)

        d_ms = time_ms(torch, step, flush, iters=10, warmup=2)
    print(f"[moe] (d) {cfg.name} int8, {cfg.num_layers} layers: one decode step at batch "
          f"{SERVE_BATCH} "
          f"(256 keys a row) {d_ms:.2f} ms device = {d_ms / SERVE_BATCH:.3f} ms a token "
          f"(host enqueue {float(np.median(host)):.2f} ms a step); one prefill round of "
          f"{SERVE_BATCH} x 256 = {MOE_PREFILL} rows {p_ms:.1f} ms", flush=True)
    del kv
    return out


def served_with_kv_fault(engine, ids, n):
    """One greedy request of ``n`` tokens driven on ``engine`` (on its
    executor, between rounds) with a planted KV fault: after its prefill,
    the first page of its sequence holds each token's key (and its scale)
    one row off from its value in every layer, an off-by-one key write.
    Its blocks are freed uncached. → its tokens."""
    from distributed_gpu_inference_torch.utils.data_structures import (
        InferenceRequest,
        SamplingParams,
    )

    slot = engine.submit(InferenceRequest(
        prompt_token_ids=list(ids),
        sampling=SamplingParams(max_new_tokens=n, temperature=0.0, ignore_eos=True)))
    bid = int(engine._block_tables[slot][0])
    for name in ("k", "k_scale"):
        if name in engine.kv:
            # pages [L, N, Hkv, Bk, D], scales [L, N, Bk]: a page's token axis
            page = engine.kv[name][:, bid]
            page.copy_(page.roll(1, dims=page.dim() - 2 if name == "k" else 1))
    while engine.slots[slot].finish_reason is None:
        engine.decode_multi()
    return list(engine.finish_slot(slot, cache=False).token_ids)


def moe_phase(torch, pa, smi, prompts, shared, model=MOE_MODEL, device="cuda"):
    """Phase 19 (see the module docstring): mixtral-8x7b at full width and
    depth with int8 weights through the streamed init, its MoE layer held
    to the plain route, served, re-scored and timed. → the @moe kernel
    entries' timings and the serving launches."""
    import gc
    import pathlib
    import tempfile

    from distributed_gpu_inference_torch.models import llama, loader
    from distributed_gpu_inference_torch.models.configs import get_model_config
    from distributed_gpu_inference_torch.runtime.engine import EngineConfig, TorchEngine
    from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_model_config(model)
    dev = torch.device(device)
    base = torch.cuda.memory_allocated()
    free, total = torch.cuda.mem_get_info()
    slice_bytes = cfg.num_experts * cfg.hidden_size * cfg.intermediate_size * 4
    print(f"[moe] before loading: {base / 2**30:.2f} GiB allocated, {free / 2**30:.1f} of "
          f"{total / 2**30:.1f} GiB free; init route for int8: "
          f"{loader.init_route(cfg, 'bfloat16', 'int8', dev)} (bf16 tree "
          f"{cfg.param_bytes(2) / 1e9:.1f} GB)", flush=True)
    if loader.init_route(cfg, "bfloat16", "int8", dev) != "streamed":
        raise AssertionError(f"{model} int8 does not take the streamed init")
    try:
        TorchEngine(cfg, EngineConfig(max_batch_size=1, max_seq_len=64), device=device)
        raise AssertionError(f"a bf16 {model} loaded on the card")
    except ValueError as exc:
        print(f"[moe] bf16 {model} refused at load: {exc}; allocated after the refusal "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
        if torch.cuda.memory_allocated() != base or "GB" not in str(exc):
            raise AssertionError("the bf16 refusal allocated memory or named no size")

    with tempfile.TemporaryDirectory(prefix="moe-tok-") as tok:
        readme = (pathlib.Path(__file__).resolve().parent / "README.md").read_text(
            encoding="utf-8")
        n_merges = write_mixtral_tokenizer(tok, readme)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        llm = TorchLLMEngine({
            "model": model, "max_batch_size": SERVE_BATCH, "max_seq_len": MAX_SEQ,
            "enable_prefix_cache": True, "dtype": "bfloat16", "device": device, "seed": 0,
            "quantization": "int8", "tokenizer_id": tok})
        llm.load_model()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
    engine = llm.engine
    params = engine.params
    tree = tree_bytes(params)
    peak = torch.cuda.max_memory_allocated() - base
    print(f"[moe] {model} ({cfg.num_layers} layers, {cfg.num_experts} experts top-"
          f"{cfg.num_experts_per_tok}, int8 weights through the streamed init, seed 0; a "
          f"Mixtral-style tokenizer: byte-fallback BPE, {n_merges} merges from README.md, "
          f"vocab {llm.tokenizer.vocab_size}) loaded in {init_s:.1f} s; tree "
          f"{tree} B against param_bytes(1) {cfg.param_bytes(1)} B; peak device memory of "
          f"the load {peak / 2**30:.2f} GiB against the int8 tree + one f32 slice "
          f"{(tree + slice_bytes) / 2**30:.2f} GiB (+ {INIT_SLACK >> 20} MiB allowed)",
          flush=True)
    if peak > tree + slice_bytes + INIT_SLACK:
        raise AssertionError("the streamed init's peak exceeds the tree and one f32 slice")

    # (a) one layer's MoE MLP, kernel route against the plain route
    g = torch.Generator(device=dev).manual_seed(190)
    lp = moe_layer(params, 0)
    moe_err = max(moe_parity(torch, cfg, lp, rows, g, dev) for rows in MOE_ROWS)

    # (b) serving through BatcherServing
    enc = llm.tokenizer.encode
    pa_ids, hit_ids = enc(prompts[3]), enc(shared + "zz" * 40)
    common = next((i for i, (a, b) in enumerate(zip(pa_ids, hit_ids)) if a != b),
                  min(len(pa_ids), len(hit_ids)))
    pins = RoutePins(torch, llama, engine)
    trace = SampleTrace(torch, [engine])
    try:
        with ExpertTally(torch, llama, cfg.num_experts, dev) as tally, pins.record():
            tokens, payloads, hit, wall, launches, stats = serve(
                torch, pa, llm, prompts, shared, min_cached=BK * ((common - 1) // BK))
    finally:
        trace.close()
    print(f"[moe] (b) kernel launches on the main path: {launches}", flush=True)
    check_counts("moe", launches, qmm=True)
    report_serving("moe", [len(p) for p in prompts], payloads, hit, wall, stats)
    for p, payload in zip(prompts, payloads):
        ids = tokens[tuple(enc(p))]
        if payload["text"] != llm.tokenizer.decode(ids):
            raise AssertionError(f"[moe] text is not the decode of the ids: {payload['text']!r}")
    counts = tally.counts.tolist()
    print(f"[moe] (b) rows each expert received over all layers while serving (pad rows "
          f"included; information): {counts}, {sum(counts) // cfg.num_experts_per_tok} "
          f"routed rows", flush=True)

    # (c) one prefill and decode step kernels vs plain, and every committed
    # token against one teacher-forced pass routed as the serving, each
    # parting judged in the logits the serving sampled
    compare_forward(torch, "moe", cfg, params, torch.bfloat16, dev)
    rows = [(enc(p), tokens[tuple(enc(p))]) for p in prompts]
    with pins.by_sequence([r[0] for r in rows]):
        scores = rescore(torch, engine, rows)
    pinned, flips = pins.pinned, pins.flips
    unpinned = greedy_misses(rows, rescore(torch, engine, rows))[0]
    print(f"[moe] (c) information: re-scored with its own routing, {len(unpinned)} committed "
          f"token(s) lie {NEAR_TIE} or more below the re-score's argmax", flush=True)
    runs = trace.runs()
    check_aligned("moe", runs)
    argmax = [(p, [sc[0] for sc in score]) for (p, _), score in zip(rows, scores)]

    def rescored(rows_):
        """The re-score's own view of each row's tokens, routed as served."""
        if rows_ is rows:
            return [[x[3] for x in sc] for sc in scores]
        with pins.by_sequence([p for p, _ in rows_]):
            return [[x[3] for x in sc] for sc in rescore(torch, engine, rows_)]

    forks = check_sampled("moe", rows, argmax, runs,
                          f"the re-score routed as served ({pinned} row-layers pinned; its "
                          f"own router would have routed {flips} otherwise)", every=True,
                          ref=rescored)
    for r, d, *_ in forks:
        print(f"[moe] (c) information: the re-score's top-2 gap at request {r} token {d} "
              f"{scores[r][d][2]:.4f}, the served token {scores[r][d][3]:.4f} below its "
              f"argmax there", flush=True)
    # the judge counts the re-score as one more run: it must still reject a
    # row served from a KV fault
    fault_ids = enc("kv fault: " + prompts[0])
    ftrace = SampleTrace(torch, [engine])
    try:
        with pins.record():
            fault_gen = llm.serving.run_exclusive(
                lambda: served_with_kv_fault(engine, fault_ids, len(rows[0][1])))
    finally:
        ftrace.close()
    frow = [(fault_ids, fault_gen)]
    with pins.by_sequence([fault_ids]):
        fargmax = [(fault_ids, [sc[0] for sc in rescore(torch, engine, frow)[0]])]
    fruns = ftrace.runs()
    fforks = fork_deficits(frow, fargmax, fruns, every=True, ref=rescored)
    served_only = fork_deficits(frow, fargmax, fruns, every=True)
    worst = max((f[4] for f in fforks), default=0.0)
    print(f"[moe] (c) a request served with the keys of its first KV page one position "
          f"off from their values in every layer: {len(fforks)} fork(s) from its re-score, the widest "
          f"{worst:.4f} in the judge (either view), "
          f"{max((f[4] for f in served_only), default=0.0):.4f} in the served logits "
          f"alone; rejected: {worst >= NEAR_TIE}", flush=True)
    if worst < NEAR_TIE:
        raise AssertionError("[moe] (c) the judge accepts a row served from a KV fault")

    # (d) times
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    timed = moe_times(torch, cfg, params, lp, dev, flush, smi)
    del flush
    llm.unload()
    del llm, engine, params, lp
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[moe] phase ran in {time.perf_counter() - t_phase:.1f} s ({smi})", flush=True)
    return timed, launches, moe_err


# ---------------------------------------------------------------- phase 20

DISTILL_STEPS = 400
DISTILL_MSE_RATIO = 0.8      # the bound of the JAX test test_distilled_draft_beats_random
# (b): each embedding row through the kernels against the plain versions'
# row, and a prompt alone against its row in the batch: with kv_lens zero
# both attentions give exact zeros, and the bf16 products of 32 layers at
# another padding move a mean-pooled unit vector by well under 1e-3 of
# cosine; rows whose tokens attend must read above it (the control)
EMBED_COS_BOUND = 1e-3
VISION_TOKENS = 32
# (d): f32 on both sides (TF32 off) and the same weights: only the
# summation order differs, ~1e-6 relative over a 12-layer encoder
WHISPER_REL_BOUND = 1e-4
IMAGE_STEPS = 20
PHASE20_REPEATS = 3          # timed calls of each of (b)-(e)


class IdRecorder:
    """Records the ids a tokenizer is asked to decode (an engine's
    answers) while installed on its ``decode``."""

    def __init__(self, tok):
        self.ids, self._tok, self._real = [], tok, tok.decode

        def decode(ids):
            self.ids.append(list(ids))
            return self._real(ids)

        tok.decode = decode

    def close(self):
        self._tok.decode = self._real


def feature_mse(torch, engine, head, toks):
    """(the draft head's next-hidden regression error on the token streams
    ``toks`` [B, S] (the JAX test's measure), the mean square of the
    target hiddens: the error of predicting zero)."""
    from distributed_gpu_inference_torch.models import llama
    from distributed_gpu_inference_torch.runtime.speculative import draft_apply

    cfg, dev = engine.model_cfg, engine.device
    b, s = toks.shape
    m = -(-s // BK)
    with torch.no_grad():
        h = llama.forward_chunk(
            cfg, engine.params, toks.to(torch.int32),
            torch.arange(s, dtype=torch.int32, device=dev).repeat(b, 1),
            llama.init_kv_pools(cfg, 1 + b * m, BK, engine.kv_dtype, dev),
            torch.arange(1, 1 + b * m, dtype=torch.int32, device=dev).reshape(b, m),
            torch.full((b,), s, dtype=torch.int32, device=dev), block_size=BK,
            with_logits=False).hidden.float()
        emb = llama.embed_tokens(engine.params, toks[:, 1:], cfg).float()
        pred = draft_apply(cfg, {k: v.float() for k, v in head.items()}, h[:, :-1], emb)
        return (float(torch.mean(torch.square(pred - h[:, 1:])).item()),
                float(torch.mean(torch.square(h[:, 1:])).item()))


def head_mse(torch, engine, streams):
    """The distilled head's feature MSE against the engine's random head
    (phase 15's: ``init_draft_params`` from ``draft_seed``) on each of
    ``streams`` {name: tokens} → {name: (distilled, random, zero)}."""
    from distributed_gpu_inference_torch.runtime.speculative import init_draft_params

    rand = init_draft_params(engine.model_cfg, torch.Generator(device=engine.device).manual_seed(
        engine.cfg.speculative.draft_seed), dtype=engine.dtype, device=engine.device)
    out = {}
    for name, toks in streams.items():
        d, zero = feature_mse(torch, engine, engine._draft_params, toks)
        out[name] = (d, feature_mse(torch, engine, rand, toks)[0], zero)
    return out


def random_streams(torch, engine, seed, b=4, s=64):
    g = torch.Generator(device=engine.device).manual_seed(seed)
    return torch.randint(0, engine.model_cfg.vocab_size, (b, s), generator=g,
                         device=engine.device)


def mini_distill(torch, smi, device, model="llama3-mini"):
    """Phase 20 (a), the JAX test's bound where it can hold: the distilled
    head's feature MSE on held-out random streams under 0.8x the random
    head's, on a model narrow enough that the 4,032 training positions
    exceed the head's fused input width 2H."""
    from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine

    llm = TorchLLMEngine({"model": model, "max_batch_size": 2, "max_seq_len": 256,
                          "dtype": "bfloat16", "device": device, "seed": 0,
                          "speculative_decode": True, "spec_num_draft_tokens": SPEC_K,
                          "spec_distill_steps": DISTILL_STEPS})
    llm.load_model()
    try:
        d, r, zero = head_mse(torch, llm.engine,
                              {"held-out": random_streams(torch, llm.engine, 77)})["held-out"]
        losses = llm.distill_losses.numpy()
        print(f"[distill] {model} (bf16, vocab {llm.engine.model_cfg.vocab_size}), "
              f"spec_distill_steps={DISTILL_STEPS}: loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
              f"held-out feature MSE: distilled {d:.4f}, random {r:.4f}, ratio {d / r:.4f} "
              f"(bound {DISTILL_MSE_RATIO}), predicting zero {zero:.4f} ({smi})", flush=True)
        if not d < DISTILL_MSE_RATIO * r:
            raise AssertionError(f"[distill] {model}: the distilled head does not beat a "
                                 f"random one on held-out streams")
    finally:
        llm.unload()


def distill_serving(torch, pa, smi, prompts, shared, random_head, model, quantization, device):
    """Phase 20 (a). → its launches: the distilled engine's serving, and
    the fused decode launches of the comparison without speculation."""
    from distributed_gpu_inference_torch.runtime import engine as eng_mod
    from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine

    tag = "distill"
    base = {"model": model, "max_batch_size": SERVE_BATCH, "max_seq_len": MAX_SEQ,
            "enable_prefix_cache": True, "dtype": "bfloat16", "device": device, "seed": 0,
            "quantization": quantization, "prefix_summary_top_n": 0}
    secs = []
    real = eng_mod.TorchEngine.distill_draft

    def timed(self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(self, *a, **kw)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        return out

    t0 = time.perf_counter()
    with patched(eng_mod.TorchEngine, "distill_draft", timed):
        llm = TorchLLMEngine({**base, "speculative_decode": True,
                              "spec_num_draft_tokens": SPEC_K,
                              "spec_distill_steps": DISTILL_STEPS})
        llm.load_model()
    losses = llm.distill_losses.numpy()
    print(f"[{tag}] {model} ({quantization} weights, bf16 KV, K={SPEC_K}) loaded with "
          f"spec_distill_steps={DISTILL_STEPS} in {time.perf_counter() - t0:.1f} s, of which "
          f"the distillation {secs[0]:.2f} s ({smi}); loss first {losses[0]:.4f}, last "
          f"{losses[-1]:.4f}; mean of the first 10 steps {losses[:10].mean():.4f}, of the "
          f"last 10 {losses[-10:].mean():.4f}", flush=True)
    if not (np.isfinite(losses).all() and losses[-10:].mean() < losses[:10].mean()):
        raise AssertionError(f"[{tag}] the distillation loss did not fall: {losses}")
    engine = llm.engine
    # the first batch of the distillation's own streams (its generator,
    # seeded with draft_seed, draws them first), and held-out streams
    g = torch.Generator(device=engine.device).manual_seed(engine.cfg.speculative.draft_seed)
    train = torch.randint(0, engine.model_cfg.vocab_size, (SERVE_BATCH, 64), generator=g,
                          device=engine.device)
    mse = head_mse(torch, engine, {"training": train,
                                   "held-out": random_streams(torch, engine, 77)})
    for name, (d, r, zero) in mse.items():
        print(f"[{tag}] feature MSE on {name} streams: distilled head {d:.4f}, phase 15's "
              f"random head {r:.4f} (ratio {d / r:.4f}), predicting zero {zero:.4f}",
              flush=True)
    d, r, _ = mse["training"]
    if not d < DISTILL_MSE_RATIO * r:
        raise AssertionError(f"[{tag}] the distilled head does not fit its streams: {mse}")
    mini_distill(torch, smi, device)
    plain = TorchLLMEngine({**base, "params": engine.params})
    plain.load_model()
    try:
        rows, wall, counts, routes, prows, pwall, pcounts = traced_spec_serving(
            torch, pa, tag, llm, plain, prompts, SPEC_TOKENS)
        stats = engine.get_stats()
        check_routes(tag, counts, routes, stats, quantized=quantization is not None)
        n_tok = len(prompts) * SPEC_TOKENS
        print(f"[{tag}] {len(prompts)} requests x {SPEC_TOKENS} greedy tokens with the "
              f"distilled head: accept rate {stats['spec_accept_rate']:.4f}, tokens per step "
              f"{stats['spec_tokens_per_step']:.3f}, {n_tok / wall:.1f} tok/s end to end; "
              f"phase 15's random head on the same requests: accept rate "
              f"{random_head['spec_accept_rate']:.4f}, tokens per step "
              f"{random_head['spec_tokens_per_step']:.3f} (information)", flush=True)
        print(f"[{tag}] the same weights without speculation: {n_tok / pwall:.1f} tok/s end to "
              f"end; launches {pcounts}", flush=True)
        if pcounts["paged_decode_attention_fused"] == 0:
            raise AssertionError(f"[{tag}] plain decode launched no fused decode kernel")
    finally:
        plain.unload()
        del plain
    _, _, hit, wall, launches, _ = serve(torch, pa, llm, prompts, shared)
    print(f"[{tag}] 8 concurrent requests and the prefix hit with the distilled head: "
          f"{wall:.2f} s; prefix hit cached {hit['usage']['cached_tokens']} tokens; launches "
          f"{launches} (a speculating engine runs no fused decode)", flush=True)
    if not (launches["ragged_paged_attention"] > 0 and launches["qmm_w8a16"] > 0):
        raise AssertionError(f"[{tag}] a kernel of the path never launched: {launches}")
    llm.unload()
    return {k: launches[k] + (pcounts[k] if k == "paged_decode_attention_fused" else 0)
            for k in launches}


def embedding_check(torch, pa, smi, prompts, model, device):
    """Phase 20 (b). → its launches."""
    from distributed_gpu_inference_torch.models import llama
    from distributed_gpu_inference_torch.worker.engines.embedding import EmbeddingEngine

    tag = "embedding"
    t0 = time.perf_counter()
    emb = EmbeddingEngine({"model": model, "device": device, "dtype": "bfloat16",
                           "max_seq_len": MAX_SEQ, "seed": 0})
    emb.load_model()
    print(f"[{tag}] {model} bf16 loaded in {time.perf_counter() - t0:.1f} s", flush=True)
    try:
        pa.reset_launch_counts()
        out = emb.inference({"texts": prompts})
        torch.cuda.synchronize()
        launches = pa.launch_counts()
        got = np.asarray(out["embeddings"], np.float64)

        def cosine(want):
            return (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                           * np.linalg.norm(want, axis=-1))

        with plain_kernels():
            cos = cosine(np.asarray(emb.inference({"texts": prompts})["embeddings"],
                                    np.float64))
            real = llama.forward_chunk

            def attending(cfg, params, toks, positions, kv, tables, kv_lens, **kw):
                return real(cfg, params, toks, positions, kv, tables,
                            (positions >= 0).sum(1, dtype=torch.int32), **kw)

            with patched(llama, "forward_chunk", attending):
                control = cosine(np.asarray(emb.inference({"texts": prompts})["embeddings"],
                                            np.float64))
        norms = np.linalg.norm(got, axis=-1)
        alone = np.asarray(emb.inference({"text": prompts[5]})["embeddings"][0], np.float64)
        cos_alone = float(alone @ got[5] / (np.linalg.norm(alone) * norms[5]))
        ms = timed_ms(torch, lambda: emb.inference({"texts": prompts}), PHASE20_REPEATS)
        print(f"[{tag}] {len(prompts)} prompts ({out['usage']['prompt_tokens']} tokens) in one "
              f"call, dim {out['dim']}: launches {launches}; 1 - cosine against the plain "
              f"versions per row {[f'{1 - c:.2e}' for c in cos]} (bound {EMBED_COS_BOUND}); "
              f"max |norm - 1| {np.abs(norms - 1).max():.2e}; prompt 5 alone against its row: "
              f"1 - cosine {1 - cos_alone:.2e}; negative control (plain, tokens attending) "
              f"per row {[f'{1 - c:.2e}' for c in control]} (must exceed the bound); "
              f"{ms:.2f} ms a call ({smi})", flush=True)
        if launches["ragged_paged_attention"] == 0:
            raise AssertionError(f"[{tag}] the ragged kernel never launched: {launches}")
        if not ((1 - cos).max() < EMBED_COS_BOUND and 1 - cos_alone < EMBED_COS_BOUND
                and np.abs(norms - 1).max() < 1e-5):
            raise AssertionError(f"[{tag}] embeddings disagree: {cos}, {cos_alone}, {norms}")
        if not (1 - control).min() > EMBED_COS_BOUND:
            raise AssertionError(f"[{tag}] the comparison cannot tell attending rows from "
                                 f"the engine's: {control}")
    finally:
        emb.unload()
    return launches


def vision_check(torch, pa, smi, device, vit_model="small-vit", llm_model="llama3-1b"):
    """Phase 20 (c). → the launches of its two requests."""
    import base64

    from distributed_gpu_inference_torch.utils.png import encode_png
    from distributed_gpu_inference_torch.worker.engines.vision import VisionEngine

    tag = "vision"
    t0 = time.perf_counter()
    vis = VisionEngine({"model": llm_model, "vit_model": vit_model, "device": device,
                        "max_new_tokens": VISION_TOKENS, "seed": 0})
    vis.load_model()
    size = vis._vit_cfg.image_size
    print(f"[{tag}] {vit_model} + {llm_model} (decoder {vis._dtype}) loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    try:
        rng = np.random.default_rng(20)
        pix = rng.random((size, size, 3)).astype(np.float32)
        png = (rng.random((size, size, 3)) * 255).astype(np.uint8)
        reqs = [{"task": "caption", "pixels": pix.tolist()},
                {"task": "image_qa", "question": "what is written here?",
                 "image": base64.b64encode(encode_png(png)).decode("ascii")}]
        rec = IdRecorder(vis._tokenizer)
        pa.reset_launch_counts()
        outs = [vis.inference(r) for r in reqs]
        torch.cuda.synchronize()
        launches = pa.launch_counts()
        rec.close()
        vocab = vis._llm_cfg.vocab_size
        ok_ids = all(0 <= t < vocab for ids in rec.ids for t in ids)
        toks = vis._tokenizer.encode("Describe the image: ")
        with torch.no_grad():
            k_logits = vis.prefill(pix, toks).float()
            with plain_kernels():
                p_logits = vis.prefill(pix, toks).float()
        rel = float(((k_logits - p_logits).norm() / p_logits.norm()).item())
        ms = timed_ms(torch, lambda: vis.inference(dict(reqs[1])), PHASE20_REPEATS)
        print(f"[{tag}] 2 requests ({size}x{size} pixels; a PNG from utils/png.py): "
              f"{[o['usage'] for o in outs]}; ids in vocabulary {ok_ids}; launches {launches}; "
              f"prefill logits, kernels vs plain: rel L2 {rel:.3e} (bound {LOGITS_REL_BOUND}), "
              f"argmax equal {bool(k_logits.argmax() == p_logits.argmax())}; {ms:.1f} ms a "
              f"request ({smi})", flush=True)
        if not (launches["ragged_paged_attention"] > 0
                and launches["paged_decode_attention_fused"] > 0):
            raise AssertionError(f"[{tag}] a kernel of the path never launched: {launches}")
        if not (ok_ids and len(rec.ids) == 2 and rel <= LOGITS_REL_BOUND):
            raise AssertionError(f"[{tag}] bad answer ids or logits: {rec.ids}, {rel}")
    finally:
        vis.unload()
    return launches


def whisper_check(torch, smi, device, model="small-whisper"):
    """Phase 20 (d)."""
    import base64
    import io
    import wave

    from distributed_gpu_inference_torch.worker.engines.whisper import WhisperEngine

    tag = "whisper"
    asr = WhisperEngine({"model": model, "device": device, "seed": 0})
    asr.load_model()
    on_cpu = {k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict) else v.cpu())
              for k, v in asr._params.items()}
    cpu = WhisperEngine({"model": model, "device": "cpu", "params": on_cpu})
    cpu.load_model()
    n, rate = asr._cfg.max_samples, asr._cfg.sample_rate
    rng = np.random.default_rng(21)
    t = np.arange(n, dtype=np.float32) / rate
    audio = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(n)
    pcm16 = np.clip(audio * 32767, -32768, 32767).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm16.tobytes())
    # the samples the WAV decodes to, sent as raw f32
    same = pcm16.astype(np.float32) / 32768.0
    wav_req = {"audio": base64.b64encode(buf.getvalue()).decode("ascii")}
    pcm_req = {"audio": base64.b64encode(same.tobytes()).decode("ascii"),
               "audio_format": "pcm_f32"}
    a, b = asr.inference(dict(wav_req)), asr.inference(dict(pcm_req))
    ms = timed_ms(torch, lambda: asr.inference(dict(wav_req)), PHASE20_REPEATS)
    k, c = asr.logits(same), cpu.logits(same)
    rel = float(np.linalg.norm(k - c) / np.linalg.norm(c))
    agree = float((k.argmax(-1) == c.argmax(-1)).mean())
    print(f"[{tag}] {model}, {a['duration_seconds']:.1f} s of seeded audio as WAV and as "
          f"pcm_f32: transcripts identical {a['text'] == b['text']} ({len(a['text'])} chars); "
          f"CTC logits {list(k.shape)} on the card vs the CPU: rel L2 {rel:.3e} (bound "
          f"{WHISPER_REL_BOUND}), frame argmax agreement {agree:.4f}; {ms:.1f} ms a request "
          f"({smi})", flush=True)
    if not (a["text"] == b["text"] and rel <= WHISPER_REL_BOUND and np.isfinite(k).all()):
        raise AssertionError(f"[{tag}] transcripts or logits disagree: {rel}")
    asr.unload()
    cpu.unload()


def image_check(torch, smi, device, model="small-diffusion"):
    """Phase 20 (e)."""
    import base64

    from distributed_gpu_inference_torch.utils.png import decode_png
    from distributed_gpu_inference_torch.worker.engines.image_gen import ImageGenEngine

    tag = "image_gen"
    gen = ImageGenEngine({"model": model, "device": device, "seed": 0})
    gen.load_model()
    size = gen._cfg.image_size
    req = {"prompt": "a lighthouse at dusk", "num_inference_steps": IMAGE_STEPS,
           "num_images": 2, "seed": 0}
    first, second = gen.inference(dict(req)), gen.inference(dict(req))
    ms = timed_ms(torch, lambda: gen.inference(dict(req)), PHASE20_REPEATS)
    shapes = [decode_png(base64.b64decode(im)).shape for im in first["images"]]
    same = first["images"] == second["images"]
    print(f"[{tag}] {model}, 2 images, {IMAGE_STEPS} steps, seed 0, twice: PNGs "
          f"byte-identical {same}; decoded shapes {shapes}; the two images differ "
          f"{first['images'][0] != first['images'][1]}; {ms:.1f} ms a request ({smi})",
          flush=True)
    if not (same and shapes == [(size, size, 3)] * 2):
        raise AssertionError(f"[{tag}] seeded images differ or are malformed: {shapes}")
    gen.unload()


def engines_phase(torch, pa, smi, prompts, shared, random_head, model="llama3-8b",
                  quantization="int8", device="cuda",
                  small=("small-vit", "llama3-1b", "small-whisper", "small-diffusion")):
    """Phase 20 (see the module docstring). → its launches by kernel.
    ``small``: the models of (c)-(e) (ViT, its decoder, ASR, DiT)."""
    t_phase = time.perf_counter()
    total = distill_serving(torch, pa, smi, prompts, shared, random_head, model, quantization,
                            device)
    torch.cuda.empty_cache()
    for launches in (embedding_check(torch, pa, smi, prompts, model, device),
                     vision_check(torch, pa, smi, device, *small[:2])):
        total = {k: total[k] + launches[k] for k in total}
    torch.cuda.empty_cache()
    whisper_check(torch, smi, device, small[2])
    image_check(torch, smi, device, small[3])
    torch.cuda.empty_cache()
    print(f"[engines] phase 20 launches {total}; ran in {time.perf_counter() - t_phase:.1f} s "
          f"({smi})", flush=True)
    return total


# ---------------------------------------------------------------- phase 21: pipeline stages

PIPE_LENGTHS = (40, 64, 88, 120)   # prompt tokens of (b); each is a prefill bucket
PIPE_LAYERS = 8                    # the model's depth (full width), two stages of 4
PIPE_TOKENS = 32                   # greedy tokens a session
PIPE_SEQ = 256                     # max_seq_len of the engine = 16 blocks a table
PIPE_BLOCKS = 64                   # blocks of each stage's pools
PIPE_KILL_AFTER = 8                # decode steps of (c) before stage 1's plane stops
PIPE_PROFILE_STEPS = 8             # decode forwards a stage profiled for its device time
PIPE_MEM_SLACK = 1 << 20           # (e): allocated bytes back within this (qmm's scratch aside)
PIPE_SESSION = dict(max_length=PIPE_SEQ, max_retries_per_hop=2, retry_backoff_s=0.05)
PIPE_HOP_TIMEOUT_S = 120.0         # each WorkerSession's socket timeout, spare included
QMM_STREAM_ROUNDS = 64             # (d): quantized matmuls a thread, each on its own stream
QMM_STREAM_HOLD_CYCLES = 50_000_000  # (d): ~25 ms of spinning before both streams start


def pipeline_prompts(vocab):
    rng = np.random.default_rng(21)
    return [rng.integers(0, vocab, size=n).tolist() for n in PIPE_LENGTHS]


class PipeClock:
    """While installed: each stage's in-process forward seconds, each hop's
    client-side seconds and its request and reply bytes (``WorkerSession``
    calls, one per forward), and each session step's seconds and last-row
    logits."""

    def __init__(self, stages):
        self.stage_s = {id(s): [] for s in stages}
        for st in stages:
            real = st.forward

            def fwd(*a, _real=real, _key=id(st), **k):
                t0 = time.perf_counter()
                out = _real(*a, **k)
                self.stage_s[_key].append(time.perf_counter() - t0)
                return out

            st.forward = fwd
        self.hops = []          # (base_url, seconds, request bytes, reply bytes)
        self.bodies = {}        # base_url -> the first two (request, reply) bodies

    def watch(self, ws):
        real = ws._call

        def call(path, body, *a, **k):
            t0 = time.perf_counter()
            resp = real(path, body, *a, **k)
            if path == "/inference/forward":
                self.hops.append((ws.base_url, time.perf_counter() - t0, len(body),
                                  len(resp.content)))
                kept = self.bodies.setdefault(ws.base_url, [])
                if len(kept) < 2:
                    kept.append((bytes(body), bytes(resp.content)))
            return resp

        ws._call = call
        return ws

    def trace(self, sess):
        """→ a list that gets each step of ``sess``: its seconds and
        logits[0, -1]."""
        real, steps = sess.step, []

        def step(*a, **k):
            t0 = time.perf_counter()
            logits = real(*a, **k)
            steps.append((time.perf_counter() - t0, logits[0, -1].clone()))
            return logits

        sess.step = step
        return steps


class EngineRows:
    """While installed on a ``TorchEngine``: each sample's f32 logits row
    (row 0; the engine serves one request at a time here) and the time its
    token was on the host."""

    def __init__(self, eng):
        self.eng, self.rows, self.times = eng, [], []
        real = eng._sample

        def sample(logits, rows, positions, mode):
            out = real(logits, rows, positions, mode)
            self.rows.append(logits[0].float().cpu())
            self.times.append(time.perf_counter())
            return out

        eng._sample = sample

    def take(self):
        rows, times = self.rows, self.times
        self.rows, self.times = [], []
        return rows, times

    def close(self):
        del self.eng._sample


def row_deficit(row, token):
    """How far ``token``'s logit lies below the argmax's in ``row``, and the
    row's top-2 as text."""
    top = row.topk(2)
    v, i = top.values.tolist(), top.indices.tolist()
    return float(v[0] - row[token]), f"id {i[0]} {v[0]:.4f} / id {i[1]} {v[1]:.4f}"


def stage_device_ms(torch, stages, prompt, tokens):
    """Device time of a decode forward of each stage, from the CUDA
    activity ``torch.profiler`` records: ``prompt`` prefilled in process
    on a session of its own, then the first PIPE_PROFILE_STEPS decode
    steps of ``tokens``, each stage profiled over its own forwards (stage
    1 takes the hiddens stage 0 gave) → [ms a forward per stage]."""
    from torch.profiler import ProfilerActivity, profile

    sid, n = "device-time", len(prompt)
    for st in stages:
        st.create_session(sid)
    x = stages[0].forward(sid, [prompt], [list(range(n))], n)["hidden"]
    stages[1].forward(sid, x, [list(range(n))], n)
    steps = [([[n + i]], n + i + 1) for i in range(PIPE_PROFILE_STEPS)]
    xs, out = [[[t]] for t in tokens[:PIPE_PROFILE_STEPS]], []
    for st in stages:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            xs = [st.forward(sid, x, pos, kv)["hidden"] for x, (pos, kv) in zip(xs, steps)]
        out.append(sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages())
                   / 1e3 / len(steps))
    for st in stages:
        st.close_session(sid)
    return out


def settled_bytes(torch):
    """Allocated device bytes once the device is idle, with cuBLAS's
    per-handle workspaces released (torch's own leak check does the same):
    every thread that multiplies holds one, and a data plane serves each
    request on a thread of its own."""
    torch.cuda.synchronize()
    if hasattr(torch._C, "_cuda_clearCublasWorkspaces"):
        torch._C._cuda_clearCublasWorkspaces()
    return torch.cuda.memory_allocated()


def qmm_scratch_bytes(qmm):
    """Bytes the quantized matmul keeps per device for the process (its
    split-K partials and arrival counters, grown and never shrunk)."""
    return sum(t.numel() * t.element_size() for s in qmm._scratch_by_device.values()
               for t in (s.ws, s.counters, *s.retired) if t is not None)


def qmm_streams_check(torch, dev, rounds=QMM_STREAM_ROUNDS):
    """Two threads, each launching the quantized matmul on a CUDA stream of
    its own at split-K decode shapes (M 1 and 8 through llama3-8b's K
    projection: 128 blocks a launch, so two launches fit the card at
    once), while the wrapper keeps one scratch for the device →
    (results compared, results not bitwise equal to the same call made
    alone on the current stream). Both streams first wait on one event
    behind a spin of QMM_STREAM_HOLD_CYCLES, so that both hold all their
    launches when they are let go: unordered, they would run at once. The
    arrival counters must be back at zero after."""
    from distributed_gpu_inference_torch.ops import qmm
    from distributed_gpu_inference_torch.ops.quantization import quantize_weight

    rng = np.random.default_rng(5)
    k, n = 4096, 1024
    w = torch.tensor(rng.standard_normal((1, k, n)) * k ** -0.5, dtype=torch.float32,
                     device=dev)
    q = quantize_weight(w, "int8")
    del w
    xs = [torch.tensor(rng.standard_normal((m, k)), dtype=torch.bfloat16, device=dev)
          for m in (1, 8)]
    if any(qmm.split_plan(x.shape[0], k, n)[0] < 2 for x in xs):
        raise AssertionError("qmm_streams_check: a shape without a split-K plan")
    alone = [qmm.qmm_w8a16(x, q["qw"], q["scale"]) for x in xs]
    torch.cuda.synchronize()
    outs = [[], []]
    gate = torch.cuda.Stream(device=dev)
    with torch.cuda.stream(gate):
        torch.cuda._sleep(QMM_STREAM_HOLD_CYCLES)
    go = torch.cuda.Event()
    go.record(gate)

    def run(i):
        side = torch.cuda.Stream(device=dev)
        side.wait_event(go)
        with torch.cuda.stream(side):
            for _ in range(rounds):
                outs[i].append(qmm.qmm_w8a16(xs[i], q["qw"], q["scale"]))
        side.synchronize()

    threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    bad = sum(not torch.equal(o.view(torch.int16), alone[i].view(torch.int16))
              for i in (0, 1) for o in outs[i])
    if int(qmm._scratch_by_device[xs[0].device.index].counters.abs().sum()):
        raise AssertionError("qmm_streams_check: arrival counters left non-zero")
    return sum(map(len, outs)), bad


def pipeline_phase(torch, pa, smi, model="llama3-8b", quantization="int8", device="cuda"):
    """Phase 21 (see the module docstring). → its launches by kernel."""
    import gc

    from distributed_gpu_inference_torch.ops import qmm

    from distributed_gpu_inference_torch.comm.data_plane import DataPlaneServer
    from distributed_gpu_inference_torch.comm.session import (
        DistributedInferenceSession,
        WorkerSession,
    )
    from distributed_gpu_inference_torch.comm.stage_worker import PipelineStageWorker
    from distributed_gpu_inference_torch.comm.wire import pack_message, unpack_message
    from distributed_gpu_inference_torch.models.configs import get_model_config
    from distributed_gpu_inference_torch.parallel.pipeline import (
        create_shard_plan,
        device_bytes,
        slice_stage_params,
        uniform_stages,
    )
    from distributed_gpu_inference_torch.runtime.engine import EngineConfig, TorchEngine
    from distributed_gpu_inference_torch.utils.data_structures import (
        BlockRange,
        InferenceRequest,
        SamplingParams,
        SessionConfig,
    )

    t_phase = time.perf_counter()
    cfg = get_model_config(model, num_layers=PIPE_LAYERS)
    mem_before, scratch_before = settled_bytes(torch), qmm_scratch_bytes(qmm)

    # ---- (a) one int8 tree, two stages and a spare viewing it
    t0 = time.perf_counter()
    eng = TorchEngine(cfg, EngineConfig(
        max_batch_size=1, max_seq_len=PIPE_SEQ, prefill_buckets=PIPE_LENGTHS,
        enable_prefix_cache=False, quantization=quantization), seed=0, device=device)
    torch.cuda.synchronize()
    mem_tree = torch.cuda.memory_allocated()
    plan = uniform_stages(cfg.num_layers, 2)
    ranges = plan + [plan[1]]
    stages = [PipelineStageWorker(cfg, rng, params=slice_stage_params(
        eng.params, *rng, num_layers=cfg.num_layers), num_blocks=PIPE_BLOCKS,
        max_blocks_per_seq=eng.cfg.max_blocks_per_seq, dtype="bfloat16", device=device)
        for rng in ranges]
    torch.cuda.synchronize()
    mem_stages = torch.cuda.memory_allocated()
    pools = sum(t.numel() * t.element_size() for st in stages for t in st.kv.values())

    def storages(tree):
        out = set()
        for v in tree.values():
            out |= storages(v) if isinstance(v, dict) else {v.untyped_storage().data_ptr()}
        return out

    views = all(storages(st.params) <= storages(eng.params) for st in stages)
    # (e) checks that nothing holds these once the phase lets them go
    held = [weakref.ref(x) for x in stages + [eng]]
    planes = [DataPlaneServer(stage=st) for st in stages]
    _ = [p.start() for p in planes]
    shard_plan = create_shard_plan(cfg, [device_bytes(device)] * 2) \
        if device != "cpu" else "not measured (no card)"
    print(f"[pipeline] {model} ({cfg.num_layers} layers, {quantization} weights, seed 0) "
          f"loaded once in {time.perf_counter() - t0:.2f} s; stages {plan} + a spare for "
          f"{plan[1]}, each behind its own data plane ({', '.join(p.url for p in planes)}); "
          f"allocated {mem_before / 2**30:.3f} GiB before the phase, {mem_tree / 2**30:.3f} "
          f"GiB with the tree, {mem_stages / 2**30:.3f} GiB with the three stages (+"
          f"{mem_stages - mem_tree} B; their bf16 pools {pools} B); every stage's leaves "
          f"views of the one tree: {views}; create_shard_plan on two cards of this one's free "
          f"memory (bf16 layer bytes, information): {shard_plan} ({smi})", flush=True)
    if not views or mem_stages - mem_tree > pools + (1 << 20):
        raise AssertionError("[pipeline] (a) the stages copied the weight tree")

    clock = PipeClock(stages)

    def session(urls, spare=None):
        route = [clock.watch(WorkerSession(u, BlockRange(*r), timeout_s=PIPE_HOP_TIMEOUT_S))
                 for u, r in zip(urls, plan)]
        spares = [clock.watch(WorkerSession(spare, BlockRange(*plan[1]),
                                            timeout_s=PIPE_HOP_TIMEOUT_S))] if spare else None
        return DistributedInferenceSession(route, SessionConfig(**PIPE_SESSION),
                                           spare_workers=spares)

    urls = [p.url for p in planes]
    prompts = pipeline_prompts(cfg.vocab_size)

    # ---- (b) the engine on the same tree, one prompt at a time
    rec = EngineRows(eng)
    eng_runs = []
    try:
        for ids in prompts:
            out = eng.generate([InferenceRequest(
                prompt_token_ids=ids,
                sampling=SamplingParams(max_new_tokens=PIPE_TOKENS, temperature=0.0,
                                        ignore_eos=True))])[0]
            if out.error or len(out.token_ids) != PIPE_TOKENS:
                raise AssertionError(f"[pipeline] the engine failed: {out.error}")
            eng_runs.append((list(out.token_ids), *rec.take()))
    finally:
        rec.close()

    # (d)'s scratch check, made before the counters are zeroed: not the pipeline's launches
    n_streams, bad_streams = (qmm_streams_check(torch, eng.device) if device != "cpu"
                              else (0, 0))

    # ---- (b) the pipeline: counters zeroed just before its sessions
    torch.cuda.synchronize()
    pa.reset_launch_counts()
    pipe_runs = []
    for ids in prompts:
        sess = session(urls)
        steps = clock.trace(sess)
        toks = sess.generate_greedy(ids, max_new_tokens=PIPE_TOKENS)
        sess.close()
        pipe_runs.append((toks, steps))
    worst, parts = 0.0, []
    for r, ((etoks, erows, _), (ptoks, steps)) in enumerate(zip(eng_runs, pipe_runs)):
        d = next((k for k, (a, b) in enumerate(zip(ptoks, etoks)) if a != b), None)
        if d is None:
            continue
        # each run at the fork: how far the other's token lay below its own argmax
        p_short, p_top = row_deficit(steps[d][1], etoks[d])
        e_short, e_top = row_deficit(erows[d], ptoks[d])
        worst = max(worst, min(p_short, e_short))
        parts.append(f"prompt {r} token {d}: pipeline {ptoks[d]} vs engine {etoks[d]}; "
                     f"pipeline top-2 {p_top}, the engine's token {p_short:.4f} below; engine "
                     f"top-2 {e_top}, the pipeline's token {e_short:.4f} below")
    prefill_err = max(float((steps[0][1] - erows[0]).abs().max())
                      for (_, erows, _), (_, steps) in zip(eng_runs, pipe_runs))
    same = sum(a == b for (e, *_), (p, _) in zip(eng_runs, pipe_runs) for a, b in zip(e, p))
    print(f"[pipeline] (b) {len(prompts)} prompts of {list(PIPE_LENGTHS)} tokens, "
          f"{PIPE_TOKENS} greedy tokens each, through two stages over HTTP: {same}/"
          f"{len(prompts) * PIPE_TOKENS} tokens equal to TorchEngine's on the same tree, "
          f"{len(prompts) - len(parts)} streams identical; where one parts: "
          f"{'; '.join(parts) or 'nowhere'} (near-tie bound {NEAR_TIE}, judged in both runs' "
          f"own logits); the last stage's prefill logits against the engine's: max abs "
          f"err {prefill_err:.3e}", flush=True)
    if worst >= NEAR_TIE:
        raise AssertionError("[pipeline] (b) a stream parts from the engine's beyond a near-tie")

    # ---- (d) two sessions at once from two threads through the same stages
    conc, errs = {}, []

    def run(i):
        try:
            s = session(urls)
            conc[i] = s.generate_greedy(prompts[i], max_new_tokens=PIPE_TOKENS)
            s.close()
        except Exception as exc:  # noqa: BLE001 — re-raised below
            errs.append(exc)

    threads = [threading.Thread(target=run, args=(i,)) for i in (1, 3)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    conc_s = time.perf_counter() - t0
    if errs or any(t.is_alive() for t in threads):
        raise AssertionError(f"[pipeline] (d) a concurrent session failed: {errs}")
    conc_ok = all(conc[i] == pipe_runs[i][0] for i in (1, 3))
    print(f"[pipeline] (d) prompts 1 and 3 at once from two threads through the same stages "
          f"in {conc_s:.2f} s: each stream equal to its solo run: {conc_ok}; the quantized "
          f"matmul's one scratch shared by two threads on a CUDA stream each: {bad_streams} "
          f"of {n_streams} results unlike the same call alone", flush=True)
    if not conc_ok or bad_streams:
        raise AssertionError("[pipeline] (d) concurrent sessions or streams part from their "
                             "solo runs")

    # ---- (c) stage 1's plane stops mid-generation: reroute to the spare, replay
    sess = session(urls, spare=urls[2])
    replay_s = []
    real_fail = sess._handle_hop_failure

    def timed_failure(*a):
        t0 = time.perf_counter()
        real_fail(*a)
        replay_s.append(time.perf_counter() - t0)

    sess._handle_hop_failure = timed_failure
    logits = sess.step(np.asarray([prompts[0]], np.int32))
    tok, toks, at_kill = int(torch.argmax(logits[0, -1])), [], None
    for k in range(PIPE_TOKENS):
        toks.append(tok)
        if k == PIPE_KILL_AFTER:
            planes[1].stop()
            at_kill = len(sess.history)
        logits = sess.step(np.asarray([[tok]], np.int32))
        tok = int(torch.argmax(logits[0, -1]))
    sess.close()
    st = sess.stats
    rec_ok = (toks == pipe_runs[0][0] and st["reroutes"] == 1
              and st["replayed_chunks"] == at_kill and sess.route[1].base_url == urls[2])
    print(f"[pipeline] (c) stage 1's plane stopped after {PIPE_KILL_AFTER} decode steps "
          f"({at_kill} chunks recorded): {st['retries']} retries, {st['reroutes']} reroute to "
          f"the spare, {st['replayed_chunks']} chunks replayed through both hops in "
          f"{sum(replay_s) * 1e3:.1f} ms; the stream equal to the undisturbed run token for "
          f"token: {toks == pipe_runs[0][0]} ({smi})", flush=True)
    if not rec_ok:
        raise AssertionError(f"[pipeline] (c) recovery is wrong: {st}, {toks} vs "
                             f"{pipe_runs[0][0]}")
    torch.cuda.synchronize()
    launches = pa.launch_counts()

    # ---- (g) numbers (information)
    dec = [t for _, steps in pipe_runs for t, _ in steps[1:]]
    eng_dec = [(len(times) - 1) / (times[-1] - times[0]) for _, _, times in eng_runs]
    n_b = len(prompts) * (PIPE_TOKENS + 1)     # (b)'s forwards a hop, made first
    decode_idx = [i for i in range(n_b) if i % (PIPE_TOKENS + 1)]
    device_ms = (stage_device_ms(torch, stages[:2], prompts[0], pipe_runs[0][0])
                 if device != "cpu" else [float("nan")] * 2)
    lines, hop_bytes = [], []
    for h in range(len(plan)):
        calls = [c[1:] for c in clock.hops if c[0] == urls[h]][:n_b]
        inside = clock.stage_s[id(stages[h])][:n_b]
        tot = [calls[i][0] * 1e3 for i in decode_idx]
        ins = [inside[i] * 1e3 for i in decode_idx]
        rest = [a - b for a, b in zip(tot, ins)]
        # the decode step's bodies as they crossed (zstd frames, as the JAX
        # session writes them) and as they would without compression
        raw_sizes = [len(pack_message(*unpack_message(b), compress=False))
                     for b in clock.bodies[urls[h]][1]]
        hop_bytes.append(((calls[1][1], calls[1][2]), tuple(raw_sizes)))
        lines.append(f"hop {h} (stage {plan[h]}): {pctl(tot, 0.5):.2f} / {pctl(tot, 0.95):.2f} "
                     f"ms, of it the stage's forward (launches, device work and the copy "
                     f"back, synchronised) {pctl(ins, 0.5):.2f} / {pctl(ins, 0.95):.2f}, the "
                     f"device busy {device_ms[h]:.2f} ms of it, and framing + HTTP (zstd "
                     f"frames encoded and decoded included) {pctl(rest, 0.5):.2f} / "
                     f"{pctl(rest, 0.95):.2f}; {calls[1][1]} B out, {calls[1][2]} B back a "
                     f"decode step, {raw_sizes[0]} / {raw_sizes[1]} B uncompressed "
                     f"({calls[0][1]} / {calls[0][2]} B at prompt 0's prefill)")
    HOP_BYTES["phase 21 HTTP"] = hop_bytes
    print(f"[pipeline] (g) decode: the pipeline {len(dec) / sum(dec):.1f} tokens/s "
          f"({1e3 * sum(dec) / len(dec):.2f} ms a step, one session, two stages over "
          f"loopback HTTP), TorchEngine on the same tree {np.mean(eng_dec):.1f} tokens/s; "
          f"per decode hop p50 / p95: {'; '.join(lines)} (device busy: torch.profiler's CUDA "
          f"time over {PIPE_PROFILE_STEPS} decode forwards of prompt 0's stream a stage, "
          f"in process; nan without a card) ({smi})", flush=True)

    # ---- (e) blocks and memory returned
    stages[1].close_session(sess.session_id)    # its plane is down: closed in process
    free = [st.health()["free_blocks"] for st in stages]
    active = [st.health()["active_sessions"] for st in stages]
    _ = [p.stop() for p in planes]
    del stages, planes, clock, sess, eng, eng_runs, pipe_runs, rec
    gc.collect()
    torch.cuda.empty_cache()
    mem_after = settled_bytes(torch)
    grown = qmm_scratch_bytes(qmm) - scratch_before
    alive = sum(r() is not None for r in held)
    print(f"[pipeline] (e) free blocks after every session closed: {free} (each "
          f"{PIPE_BLOCKS - 1} = num_blocks - 1), active sessions {active}; stages and engine "
          f"still referenced: {alive}; allocated {mem_after / 2**30:.3f} GiB after the phase "
          f"freed its stages, planes and tree ({mem_after - mem_before:+d} B against before "
          f"the phase, of it {grown} B the quantized matmul's scratch grew, which it keeps for "
          f"the process; the rest bound {PIPE_MEM_SLACK} B)", flush=True)
    if free != [PIPE_BLOCKS - 1] * 3 or any(active) or alive or \
            abs(mem_after - mem_before - grown) > PIPE_MEM_SLACK:
        raise AssertionError("[pipeline] (e) blocks or card memory not returned")

    # ---- (f) kernels
    print(f"[pipeline] (f) kernel launches of the pipeline's sessions ((b)-(d), the engine's "
          f"excluded): {launches}; phase 21 ran in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    check_counts("pipeline", launches, qmm=quantization is not None)
    return launches


# ---------------------------------------------------------------- phase 22: direct mode, sub-waves, the weight cache

DIRECT_TOKENS = 32          # greedy tokens of each phase-22 request
SUBWAVE_WIDTH = SERVE_BATCH + 2     # phase 22 (d)'s slots: the wave and the earlier request
DIRECT_STREAMS = 4          # direct-mode streams through DirectServer
DIRECT_CUT = 12             # events the cut stream's client reads
CACHE_TOKENS = 16           # greedy tokens of each quant-cache request


def phase22_config(model, device, **over):
    """Phase 22's engines: llama3-8b, int8 weights and int8 pools, seed 0."""
    return dict({"model": model, "max_batch_size": SERVE_BATCH, "max_seq_len": MAX_SEQ,
                 "enable_prefix_cache": False, "dtype": "bfloat16", "device": device,
                 "seed": 0, "quantization": "int8", "kv_cache_dtype": "int8",
                 "prefix_summary_top_n": 0}, **over)


def traced_rows(runs, tag, prompts_ids):
    """The tokens each run tagged ``tag`` generated, in ``prompts_ids``
    order (the first such run of each prompt)."""
    by = {}
    for t, p, gen, _, _ in runs:
        if t == tag:
            by.setdefault(p, list(gen))
    missing = [i for i, p in enumerate(prompts_ids) if tuple(p) not in by]
    if missing:
        raise AssertionError(f"no {tag} run of prompts {missing} was traced")
    return [(list(p), by[tuple(p)]) for p in prompts_ids]


def add_counts(total, counts):
    for k in ("ragged_paged_attention", "paged_decode_attention_fused", "qmm_w8a16"):
        total[k] = total.get(k, 0) + counts[k]


def direct_streams(torch, pa, direct, batcher, prompts, tags, smi):
    """Phase 22 (b): DIRECT_STREAMS direct-mode streams through
    ``DirectServer`` (exclusive claims: one at a time), then prompt 0's
    stream cut after DIRECT_CUT events and resumed from its checkpoint by
    the batcher-mode engine's server. → (launches, the outputs to judge
    against the uncut streams, the uncut streams' tokens)."""
    from distributed_gpu_inference_torch.worker.direct_server import DirectServer

    tok, vocab = direct.tokenizer, direct.engine.model_cfg.vocab_size
    w1, w2 = SmokeWorker(direct, exclusive=True), SmokeWorker(batcher)
    w2.checkpoints, w2.history = w1.checkpoints, w1.history     # one plane's store
    direct.checkpoint_sink = batcher.checkpoint_sink = w1.sink
    s1, s2 = DirectServer(w1, host="127.0.0.1", port=0), DirectServer(w2, host="127.0.0.1",
                                                                      port=0)
    s1.start()
    s2.start()
    eng = direct.engine
    step_ms = []
    real_step = eng.decode_step

    def timed_step():
        t0 = time.perf_counter()
        out = real_step()         # reads its tokens on the host: synchronous
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    eng.decode_step = timed_step

    def params(i, n=DIRECT_TOKENS):
        return {"prompt": prompts[i], "max_new_tokens": n, "temperature": 0.0,
                "ignore_eos": True}

    try:
        pa.reset_launch_counts()
        tags.tag = "direct stream"
        ttft, gaps, calm = [], [], {}
        for i in range(DIRECT_STREAMS):
            # the exclusive claim is released once the server's handler has
            # closed the engine's stream, a moment after the done event
            if not wait_until(lambda: w1.active == 0):
                raise AssertionError("[direct mode] a stream's claim was never released")
            events, times, sent = stream_events(s1.port, {"type": "llm", "params": params(i),
                                                          "stream_id": f"direct-{i}"})
            body, final, ids, text = split_stream(events)
            if len(ids) != DIRECT_TOKENS or not all(0 <= t < vocab for t in ids) \
                    or text != tok.decode(ids) or final["offset"] != DIRECT_TOKENS:
                raise AssertionError(f"[direct mode] stream {i}: bad stream {ids}")
            calm[i] = ids
            ttft.append((times[0] - sent) * 1e3)
            gaps += [(b - a) * 1e3 for a, b in zip(times, times[1:len(body)])]
        print(f"[direct mode] (b) {DIRECT_STREAMS} direct-mode streams of {DIRECT_TOKENS} "
              f"greedy tokens through DirectServer (exclusive claims, one at a time): offsets "
              f"contiguous, ids in vocabulary, text = decode(ids); as the client sees them: "
              f"TTFT p50 {pctl(ttft, 0.5):.1f} ms p95 {pctl(ttft, 0.95):.1f} ms, inter-event "
              f"p50 {pctl(gaps, 0.5):.2f} ms p95 {pctl(gaps, 0.95):.2f} ms; one decode_step "
              f"(B = 1, the token read on the host) p50 {pctl(step_ms, 0.5):.2f} ms p95 "
              f"{pctl(step_ms, 0.95):.2f} ms = {1e3 / pctl(step_ms, 0.5):.1f} tok/s ({smi})",
              flush=True)
        # prompt 0 again, cut by its client, resumed on the batcher-mode engine
        n, sid = 2 * DIRECT_TOKENS, "direct-cut"
        tags.tag = "cut"
        wait_until(lambda: w1.active == 0)
        head, _, _ = stream_events(s1.port, {"type": "llm", "params": params(0, n),
                                             "stream_id": sid}, limit=DIRECT_CUT)
        if not (wait_until(lambda: eng.num_active == 0 and w1.active == 0)
                and wait_until(lambda: len(w1.checkpoints.get(sid, {"state": {
                    "generated": []}})["state"]["generated"]) >= DIRECT_CUT - 4)):
            raise AssertionError("[direct mode] the cut stream left no checkpoint past "
                                 "its first tokens")
        k = len(w1.checkpoints[sid]["state"]["generated"])
        head_ids = [t for e in head for t in e["token_ids"]]
        tags.tag = "resumed"
        tail = stream_events(s2.port, {"type": "llm", "params": params(0, n), "resume": {
            "stream_id": sid, "offset": len(head),
            "text_offset": len("".join(e["text_delta"] for e in head))}})[0]
        _, final, tail_ids, _ = split_stream(tail, first_offset=len(head) + 1)
        ids = head_ids + tail_ids
        if len(ids) != n or final["offset"] != n:
            raise AssertionError(f"[direct mode] the resumed stream has {len(ids)} tokens")
        torch.cuda.synchronize()
        counts = pa.launch_counts()
        print(f"[direct mode] (b) a {n}-token direct stream cut by its client after "
              f"{len(head)} events (checkpoint of {k} tokens) and resumed at offset "
              f"{len(head)} on the batcher-mode engine: offsets {len(head) + 1}..{n} "
              f"contiguous; launches over (b) {counts}", flush=True)
        check_counts("direct mode (b)", counts, qmm=True)
    finally:
        del eng.decode_step
        s1.stop()
        s2.stop()
        direct.checkpoint_sink = batcher.checkpoint_sink = None
    # the stretches of the stream: [0, offset) from the cut run; from a
    # checkpoint past the offset, its tokens up to it from the cut run too
    cuts = [len(head)] + ([k] if k > len(head) else [])
    return counts, (tuple(tok.encode(prompts[0])), ids, cuts), calm


def subwave_pass(torch, pa, params, prompts, sv, trace, earlier=None, model="llama3-8b",
                 device="cuda"):
    """One phase-22 (d) engine: batcher mode, ``serving.ragged: false`` and
    ``sv``, under ``trace``; the prompts as one wave of DIRECT_TOKENS greedy
    tokens each (with ``earlier``, a request already decoding when the wave
    arrives).
    → (payloads, prefill calls of the wave, launches, the earlier request's
    tokens before and after the wave's admission, its tokens)."""
    from distributed_gpu_inference_torch.worker.engines.base import GenerationConfig
    from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine

    llm = TorchLLMEngine(phase22_config(model, device, params=params,
                                        max_batch_size=SUBWAVE_WIDTH,
                                        serving=dict({"ragged": False}, **sv)))
    llm.load_model()
    eng = llm.engine
    trace.install(eng)
    real_submit = eng.submit_batch
    seen = {}

    def submit_batch(requests, *a, **kw):
        live = [i for i, x in enumerate(eng.slots) if x is not None]
        before = {i: len(eng.slots[i].generated) for i in live}
        calls = eng.stats["prefill_calls"]
        out = real_submit(requests, *a, **kw)
        seen.setdefault("waves", []).append(len(requests))
        seen.setdefault("calls", []).append(eng.stats["prefill_calls"] - calls)
        seen.setdefault("advanced", []).append(
            {i: (n0, len(eng.slots[i].generated) if eng.slots[i] is not None else None)
             for i, n0 in before.items()})
        return out

    eng.submit_batch = submit_batch
    batcher = llm.serving.batcher
    real_admit = batcher._admit
    gathering = threading.Event()

    async def admit():
        # while the wave is being submitted (one request at a time from one
        # thread, which may outlast the admission latch on a loaded host),
        # nothing is admitted: the whole wave is queued at the next admission
        if gathering.is_set():
            if len(batcher._heap) < len(prompts):
                return None
            gathering.clear()
        return await real_admit()

    batcher._admit = admit
    held = threading.Event()
    real_decode = eng.decode_multi

    def decode_multi(*a, **kw):
        # while the wave is being submitted the earlier request's rounds
        # wait, so the whole wave is queued at the next admission
        held.wait(timeout=60)
        return real_decode(*a, **kw)

    try:
        pa.reset_launch_counts()
        fut = None
        if earlier is not None:
            eng.decode_multi = decode_multi
            held.set()
            fut = llm.serving.submit_async(llm._build_request(
                earlier, GenerationConfig.from_params({"max_new_tokens": 4 * DIRECT_TOKENS,
                                                       "temperature": 0.0,
                                                       "ignore_eos": True})))
            if not wait_until(lambda: any(x is not None and len(x.generated) >= 2
                                          for x in eng.slots)):
                raise AssertionError("[direct mode] the earlier request never decoded")
            held.clear()
            time.sleep(0.05)     # the batcher is now held in its next round
        out = {}
        gathering.set()
        th = threading.Thread(target=lambda: out.update(p=llm.batch_inference([
            {"prompt": p, "max_new_tokens": DIRECT_TOKENS, "temperature": 0.0,
             "ignore_eos": True} for p in prompts])))
        th.start()
        if earlier is not None:
            wait_until(lambda: len(llm.serving.batcher._heap) >= len(prompts), timeout=10)
            held.set()
        th.join(timeout=600)
        early = fut.result(timeout=600) if fut is not None else None
        torch.cuda.synchronize()
        counts = pa.launch_counts()
    finally:
        held.set()
        gathering.clear()
        for name in ("submit_batch", "decode_multi"):
            eng.__dict__.pop(name, None)
        batcher.__dict__.pop("_admit", None)
        llm.unload()
    payloads = out.get("p")
    if payloads is None or any(p["usage"]["completion_tokens"] != DIRECT_TOKENS
                               for p in payloads):
        raise AssertionError(f"[direct mode] the wave did not complete: {payloads}")
    wave = [i for i, w in enumerate(seen.get("waves", [])) if w == len(prompts)]
    if not wave:
        raise AssertionError(f"[direct mode] the {len(prompts)} requests were not one wave: "
                             f"waves {seen.get('waves')}")
    adv = seen["advanced"][wave[0]]
    return payloads, seen["calls"][wave[0]], counts, adv, early


def quant_cache_check(torch, pa, smi, prompts, model="llama3-8b", device="cuda"):
    """Phase 22 (e): llama3-8b int8 loaded twice through
    ``EngineConfig.quant_cache_dir`` in a temporary directory: built and
    written, then read. → launches."""
    import pathlib
    import shutil
    import tempfile

    from distributed_gpu_inference_torch.runtime.engine import EngineConfig, TorchEngine
    from distributed_gpu_inference_torch.utils.data_structures import (
        InferenceRequest,
        SamplingParams,
    )

    d = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_qcache_"))
    try:
        cfg = EngineConfig(max_batch_size=SERVE_BATCH, max_seq_len=MAX_SEQ,
                           quantization="int8", kv_cache_dtype="int8",
                           enable_prefix_cache=False, quant_cache_dir=str(d))
        engines, secs = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engines.append(TorchEngine(model, cfg, seed=0, device=device))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        files = list(d.iterdir())
        if len(files) != 1:
            raise AssertionError(f"[quant cache] {len(files)} cache files: {files}")
        nbytes = files[0].stat().st_size

        def leaves(tree, prefix=""):
            for k, v in sorted(tree.items()):
                if isinstance(v, dict):
                    yield from leaves(v, f"{prefix}{k}/")
                else:
                    yield f"{prefix}{k}", v

        a, b = dict(leaves(engines[0].params)), dict(leaves(engines[1].params))
        bitwise = a.keys() == b.keys() and all(
            a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            and torch.equal(a[k].view(torch.uint8), b[k].view(torch.uint8)) for k in a)
        pa.reset_launch_counts()
        streams = []
        for eng in engines:
            reqs = [InferenceRequest(prompt_token_ids=list(p.encode()),
                                     sampling=SamplingParams(max_new_tokens=CACHE_TOKENS,
                                                             ignore_eos=True))
                    for p in prompts[:4]]
            streams.append([r.token_ids for r in eng.generate(reqs, use_multi_step=True)])
        torch.cuda.synchronize()
        counts = pa.launch_counts()
        print(f"[quant cache] {model} int8 loaded through quant_cache_dir: built and "
              f"written in {secs[0]:.2f} s, read back in {secs[1]:.2f} s; the file "
              f"{files[0].name} holds {nbytes} B, read and copied to the card at "
              f"{nbytes / secs[1] / 1e9:.2f} GB/s (a page-cache read plus the host-to-card "
              f"copy, the whole load: not a PCIe or disk rate); trees bitwise equal: "
              f"{bitwise}; 4 requests x {CACHE_TOKENS} greedy tokens identical: "
              f"{streams[0] == streams[1]}; launches {counts} ({smi})", flush=True)
        if not (bitwise and streams[0] == streams[1]):
            raise AssertionError("[quant cache] the cached tree or its streams differ")
        check_counts("quant cache", counts, qmm=True)
        del engines, a, b
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if d.exists():
        raise AssertionError(f"[quant cache] {d} was not deleted")
    return counts


def direct_mode_phase(torch, pa, smi, prompts, model="llama3-8b", device="cuda"):
    """Phase 22 (see the module docstring). → its launches."""
    import gc

    from distributed_gpu_inference_torch.worker.engines.base import JobMigrated
    from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine

    t_phase = time.perf_counter()
    launches = {}
    t0 = time.perf_counter()
    direct = TorchLLMEngine(phase22_config(model, device, serving={"mode": "direct"}))
    direct.load_model()
    params = direct.engine.params
    batcher = TorchLLMEngine(phase22_config(model, device, params=params))
    batcher.load_model()
    print(f"[direct mode] {model} (int8 weights, int8 pools, seed 0) in serving.mode: direct "
          f"and a batcher-mode engine on the same tree loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    enc = direct.tokenizer.encode
    ids_of = [enc(p) for p in prompts]
    tags = Tag()
    trace = SampleTrace(torch, [direct.engine, batcher.engine], tags=tags)
    try:
        # (a) blocking requests, direct against batcher
        pa.reset_launch_counts()
        tags.tag = "direct"
        t0 = time.perf_counter()
        outs = [direct.inference({"prompt": p, "max_new_tokens": DIRECT_TOKENS,
                                  "temperature": 0.0, "ignore_eos": True}) for p in prompts]
        dwall = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = pa.launch_counts()
        check_counts("direct mode (a)", counts, qmm=True)
        add_counts(launches, counts)
        tags.tag = "batcher"
        t0 = time.perf_counter()
        bouts = batcher.batch_inference([{"prompt": p, "max_new_tokens": DIRECT_TOKENS,
                                          "temperature": 0.0, "ignore_eos": True}
                                         for p in prompts])
        bwall = time.perf_counter() - t0
        if any(o["usage"]["completion_tokens"] != DIRECT_TOKENS for o in outs + bouts):
            raise AssertionError("[direct mode] (a) a request returned the wrong count")
        n_tok = len(prompts) * DIRECT_TOKENS
        print(f"[direct mode] (a) {len(prompts)} requests x {DIRECT_TOKENS} greedy tokens "
              f"through inference one at a time (the legacy generate path): {dwall:.2f} s = "
              f"{n_tok / dwall:.1f} tok/s, TTFT p50 "
              f"{pctl([o['ttft_ms'] for o in outs], 0.5):.1f} ms; the batcher-mode engine's "
              f"batch of the same: {bwall:.2f} s = {n_tok / bwall:.1f} tok/s; launches "
              f"(direct) {counts} ({smi})", flush=True)

        # (b) direct streams, one cut and resumed on the batcher-mode engine
        counts, cut, calm = direct_streams(torch, pa, direct, batcher, prompts, tags, smi)
        add_counts(launches, counts)

        # (c) a queued job interrupted at a step boundary, resumed by the
        # batcher-mode engine
        job = {"prompt": prompts[1], "max_new_tokens": 2 * DIRECT_TOKENS,
               "temperature": 0.0, "ignore_eos": True}
        tags.tag = "job calm"
        pa.reset_launch_counts()
        direct.inference(dict(job, _failover_ctx={"key": "job-calm", "epoch": 1}))
        eng = direct.engine
        real = eng.decode_multi
        rounds = []

        def interrupting(*a, **kw):
            out = real(*a, **kw)
            rounds.append(1)
            if len(rounds) == 2:
                direct.interrupt_live()
            return out

        eng.decode_multi = interrupting
        tags.tag = "job"
        try:
            direct.inference(dict(job, _failover_ctx={"key": "job-22", "epoch": 1}))
            raise AssertionError("[direct mode] (c) the interrupted job was not migrated")
        except JobMigrated as mig:
            ckpt, k = mig.checkpoint, mig.tokens
        finally:
            del eng.decode_multi
            direct._interrupt.clear()
        tags.tag = "job resumed"
        out = batcher.inference(dict(job, _failover_ctx={"key": "job-22", "epoch": 2,
                                                         "checkpoint": ckpt}))
        torch.cuda.synchronize()
        counts = pa.launch_counts()
        add_counts(launches, counts)
        if out["usage"]["completion_tokens"] != 2 * DIRECT_TOKENS or eng.num_active:
            raise AssertionError(f"[direct mode] (c) the resumed job returned {out}")
        print(f"[direct mode] (c) a {2 * DIRECT_TOKENS}-token queued job on the direct engine "
              f"interrupted after 2 decode rounds: JobMigrated with {k} tokens, resumed by the "
              f"batcher-mode engine to {out['usage']['completion_tokens']} tokens", flush=True)
    finally:
        trace.close()
    runs = trace.runs()
    check_aligned("direct mode", runs, tags=("direct", "batcher", "direct stream",
                                             "job calm"))
    check_sampled("direct mode", traced_rows(runs, "direct", ids_of),
                  traced_rows(runs, "batcher", ids_of), runs, "the batcher-mode engine")
    prompt, ids, cuts = cut
    outputs = stream_stretches(runs, prompt, ids, cuts, "the resumed direct stream")
    check_sampled("direct mode", [(list(p), o) for p, o, _ in outputs],
                  [(list(prompt), calm[0])] * len(outputs), runs, "the uncut stream")
    resumed = [(list(p), g) for t, p, g, _, _ in runs if t == "job resumed"]
    check_sampled("direct mode", resumed[:1], traced_rows(runs, "job calm", [ids_of[1]]),
                  runs, "the undisturbed job")
    batcher.unload()
    direct.unload()
    del direct, batcher

    # (d) sub-wave admission on the legacy path. Every prefill forward, whole
    # wave or narrow, takes qmm's library route (the kernel serves up to the
    # decode width here), so both admissions run the same products; decode
    # steps still launch the kernel
    from distributed_gpu_inference_torch.ops import qmm

    rows, calls, payloads, adv = {}, {}, {}, None
    tags = Tag()
    for name, sv in (("subwave 0", {}), ("subwave 2", {"subwave": 2}),
                     ("subwave 2 interleave 2", {"subwave": 2, "interleave": 2})):
        tags.tag = name
        trace = SampleTrace(torch, [], tags=tags)
        try:
            # a prompt of its own: rows are read by prompt
            earlier = prompts[7][::-1] if "interleave" in name else None
            with patched(qmm, "MAX_KERNEL_ROWS", SUBWAVE_WIDTH):
                payloads[name], calls[name], counts, advanced, early = subwave_pass(
                    torch, pa, params, prompts, sv, trace, earlier=earlier, model=model,
                    device=device)
        finally:
            trace.close()
        add_counts(launches, counts)
        check_counts(f"direct mode (d) {name}", counts, qmm=True)
        runs = trace.runs()
        rows[name] = traced_rows(runs, name, ids_of)
        if early is not None:
            adv = advanced
            if early.error or len(early.token_ids) != 4 * DIRECT_TOKENS:
                raise AssertionError(f"[direct mode] (d) the earlier request: {early}")
        ttft = [round(p["ttft_ms"], 1) for p in payloads[name]]
        print(f"[direct mode] (d) {name}: the 8 requests as one wave of the legacy path, "
              f"prefill calls {calls[name]}, TTFT ms by request {ttft} (p50 "
              f"{pctl(ttft, 0.5):.1f}); launches {counts}", flush=True)
        if name != "subwave 0":
            check_sampled("direct mode (d)", rows[name], rows["subwave 0"], runs + base_runs,
                          "the whole-wave admission")
            firsts = {ids_of.index(list(p)): (own[0], base_own[p])
                      for _, p, _, start, own in runs if start == 0 and 0 in own
                      and p in base_own and list(p) in ids_of}
            same = {i: max(abs(a - b) for a, b in zip(x[0], y[0]))
                    for i, (x, y) in firsts.items() if x[1] == y[1]}
            print(f"[direct mode] (d) {name}: each request's first-token top-8 logits against "
                  f"the whole wave's: the same ids for requests {sorted(same)}, max abs "
                  f"difference {max(same.values(), default=0.0):.4f}; other ids for "
                  f"{sorted(set(firsts) - set(same))} (information; both on qmm's library "
                  f"route)", flush=True)
        else:
            base_runs = runs
            base_own = {p: own[0] for _, p, _, start, own in runs if start == 0 and 0 in own}
    moved = [(a, b) for a, b in adv.values() if b is None or b > a]
    print(f"[direct mode] (d) the earlier request (already decoding) over the interleaved "
          f"admission: tokens before and after {list(adv.values())}", flush=True)
    if not moved:
        raise AssertionError("[direct mode] (d) the earlier request did not advance during "
                             "the interleaved admission")
    if not calls["subwave 2"] > calls["subwave 0"]:
        raise AssertionError(f"[direct mode] (d) the sub-waves ran no narrow prefills: {calls}")

    # (e) the quantized-weight cache
    del params
    gc.collect()
    torch.cuda.empty_cache()
    add_counts(launches, quant_cache_check(torch, pa, smi, prompts, model=model,
                                           device=device))
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[direct mode] phase 22 launches {launches}; ran in "
          f"{time.perf_counter() - t_phase:.1f} s ({smi})", flush=True)
    return launches


# ---------------------------------------------------------------- phase 23

TP_RANKS = 2                       # tensor-parallel ranks of phase 23, both on cuda:0
TP_TOKENS = 32                     # greedy tokens of each phase-23 request
TP_HS = (NH // TP_RANKS, HKV // TP_RANKS, D)   # one rank's heads of llama3-8b
TP_MOE_LAYERS = 8                  # (c): mixtral-8x7b's depth, cut
TP_LAYERS = 8                      # (a), (b): llama3-8b's depth, cut
TP_STEP_PROMPT = 64                # tokens of each prompt of the timed decode steps
TP_STEPS = 16                      # timed decode steps
# (a): the widest gap, in bf16 ulp, allowed between a deeper layer's int8
# scales and the tp 1 engine's. Sound runs part by at most 7 (each rank's
# bf16 partial sum of wo / w_down is rounded before the all-reduce). A wo
# sum left out (each rank keeping its own part, the ranks' scales still
# equal) parts by 148 on llama3-tiny; a part off by 2% stays within 16
TP_SCALE_ULP = 16
# one rank's share of a llama3-8b layer's projections at tp 2: (name, K, N)
TP_PROJ = tuple((n, k // TP_RANKS if n in ("wo", "w_down") else k,
                 n_ if n in ("wo", "w_down") else n_ // TP_RANKS) for n, k, n_ in LAYER_PROJ)


def _tp_probe_rank(rank, path, out):
    """One of two processes on cuda:0: an NCCL group (refused on a shared
    card, the error kept), then a gloo group given CUDA tensors."""
    import datetime

    import torch
    import torch.distributed as dist

    res = {}
    timeout = datetime.timedelta(seconds=60)
    try:
        store = dist.FileStore(path, 2)
        try:
            torch.cuda.set_device(0)
            opts = dist.ProcessGroupNCCL.Options()
            opts._timeout = timeout
            pg = dist.ProcessGroupNCCL(dist.PrefixStore("nccl", store), rank, 2, opts)
            t = torch.full((4,), float(rank + 1), device="cuda:0")
            pg.allreduce([t]).wait()
            torch.cuda.synchronize()
            res["nccl"] = f"ran: {t.tolist()}"
        except Exception as exc:   # noqa: BLE001 — the refusal is the finding
            res["nccl"] = f"refused: {type(exc).__name__}: " + " ".join(
                ln for ln in str(exc).splitlines() if "Duplicate" in ln or "error" in ln)[:300]
        pg = dist.ProcessGroupGloo(dist.PrefixStore("gloo", store), rank, 2, timeout)
        t = torch.full((4,), float(rank + 1), device="cuda:0", dtype=torch.bfloat16)
        pg.allreduce([t]).wait()
        b = torch.full((3,), float(rank + 7), device="cuda:0", dtype=torch.int32)
        opts = dist.BroadcastOptions()
        opts.rootRank = 0
        pg.broadcast([b], opts).wait()
        torch.cuda.synchronize()
        res["gloo"] = {"all_reduce": t.float().tolist(), "broadcast": b.tolist()}
    except Exception as exc:       # noqa: BLE001 — reported to the parent
        res["error"] = f"{type(exc).__name__}: {exc}"
    out.put((rank, res))


def tp_backend_probe():
    """Two processes on cuda:0: what NCCL and gloo do with two ranks on one
    card. → the gloo result (it must hold the sum and rank 0's values)."""
    import multiprocessing
    import queue
    import shutil
    import tempfile

    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    d = tempfile.mkdtemp(prefix="tp-probe-")
    procs = [ctx.Process(target=_tp_probe_rank, args=(r, f"{d}/store", out), daemon=True)
             for r in range(2)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:
            rank, res = out.get(timeout=180)
            got[rank] = res
    except queue.Empty:
        pass
    for p in procs:
        p.join(30)
        if p.is_alive():
            p.kill()
    shutil.rmtree(d, ignore_errors=True)
    for rank in range(2):
        print(f"[tp] backend probe, rank {rank} of 2 on cuda:0: {got.get(rank)}", flush=True)
    want = {"all_reduce": [3.0] * 4, "broadcast": [7] * 3}
    if any(got.get(r, {}).get("gloo") != want for r in range(2)):
        raise AssertionError(f"[tp] gloo with CUDA tensors on one card failed: {got}")
    return got


def tp_engine(torch, model_cfg, kv, tp, device="cuda"):
    """Phase 23's engines: ``model_cfg`` with int8 weights, seed 0, pools
    ``kv`` (None = bf16), the prefix cache off; ``tp`` ranks, all on
    ``device`` (cuda:0)."""
    from distributed_gpu_inference_torch.runtime.engine import EngineConfig, TorchEngine

    cfg = EngineConfig(max_batch_size=SERVE_BATCH, max_seq_len=MAX_SEQ,
                       enable_prefix_cache=False, quantization="int8", kv_cache_dtype=kv)
    dev = "cuda:0" if device == "cuda" else device
    t0 = time.perf_counter()
    eng = TorchEngine(model_cfg, cfg, seed=0, device=device,
                      rank_devices=[dev] * tp if tp > 1 else None)
    torch.cuda.synchronize()
    return eng, time.perf_counter() - t0


def tp_requests(ids, n=TP_TOKENS):
    from distributed_gpu_inference_torch.utils.data_structures import (
        InferenceRequest,
        SamplingParams,
    )

    return [InferenceRequest(prompt_token_ids=list(p), sampling=SamplingParams(
        max_new_tokens=n, temperature=0.0, ignore_eos=True)) for p in ids]


def tp_batcher_serve(torch, engine, ids):
    """The requests of ``ids`` all at once through ``BatcherServing``
    (``ContinuousBatcher`` on its own loop). → (the token ids by request,
    wall seconds)."""
    from distributed_gpu_inference_torch.runtime.batcher import BatcherServing

    serving = BatcherServing(engine)
    try:
        t0 = time.perf_counter()
        futs = [serving.submit_async(r) for r in tp_requests(ids)]
        outs = [f.result(timeout=900) for f in futs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        serving.stop(drain=False)
    bad = [o for o in outs if o.error or len(o.token_ids) != TP_TOKENS]
    if bad:
        raise AssertionError(f"[tp] requests failed: {[(o.error, o.token_ids) for o in bad]}")
    return [list(o.token_ids) for o in outs], wall


def tp_step_ms(torch, engine, ids):
    """Decode steps at batch 8 on short prompts: → (ms a step, each rank's
    collectives over the steps)."""
    reqs = tp_requests([p[:TP_STEP_PROMPT] for p in ids], n=TP_STEPS + 8)
    slots = engine.submit_batch(reqs)
    torch.cuda.synchronize()
    if engine.tp > 1:
        engine.rank_collective_stats(reset=True)
    t0 = time.perf_counter()
    engine.decode_multi(TP_STEPS)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / TP_STEPS
    stats = engine.rank_collective_stats() if engine.tp > 1 else []
    for s in slots:
        engine.finish_slot(s, cache=False)
    return ms, stats


def tp_prompt_scales(torch, engine, ids):
    """The 8 prompts prefilled in one wave (the block manager lays them out
    alike in every engine): → (each rank's scale pools as bits, each
    request's scales at its prompt positions [pool][L, n] from each rank's
    pools)."""
    slots = engine.submit_batch(tp_requests(ids, n=2))
    pools = engine.rank_pools(("k_scale", "v_scale"))
    per = []
    for s, p in zip(slots, ids):
        pos = np.arange(len(p))
        pages = engine._block_tables[s][pos // BK]
        per.append([{k: v[:, pages, pos % BK] for k, v in rank.items()} for rank in pools])
    for s in slots:
        engine.finish_slot(s, cache=False)
    return pools, per


def tp_counts_check(tag, counts, fused):
    """Every rank launched ragged and qmm, and the fused decode kernel as
    ``fused`` says (int8 pools under tensor parallelism decode through the
    ragged kernel)."""
    for r, c in enumerate(counts):
        ok = c["ragged_paged_attention"] > 0 and c["qmm_w8a16"] > 0 and \
            (c["paged_decode_attention_fused"] > 0) == fused
        if not ok:
            raise AssertionError(f"[{tag}] rank {r} launched {c}")


def tp_serving_pass(torch, pa, smi, tag, kv, ids, llama, model="llama3-8b", device="cuda"):
    """(a) / (b): llama3-8b at full width and TP_LAYERS deep, int8
    weights, pools ``kv``; the tp 1 engine and the tp 2 engine (two ranks
    on cuda:0) serve the 8 prompts through the batcher under one
    SampleTrace; the streams judged; counts, tok/s, a step's ms and
    collectives. → (the tp 2 ranks' summed launches, the scale-pool
    findings or None)."""
    from distributed_gpu_inference_torch.models.configs import get_model_config

    cfg = get_model_config(model, num_layers=TP_LAYERS)
    tags = Tag()
    trace = SampleTrace(torch, [], tags=tags)
    scales = None
    one, t_one = tp_engine(torch, cfg, kv, 1, device)
    try:
        trace.install(one)
        tags.tag = "tp1"
        _, wall1 = tp_batcher_serve(torch, one, ids)
        tags.tag = None         # the timed steps and the scale wave: other runs
        step1, _ = tp_step_ms(torch, one, ids)
        if kv == "int8":
            _, one_scales = tp_prompt_scales(torch, one, ids)
        two, t_two = tp_engine(torch, cfg, kv, TP_RANKS, device)
        try:
            free, total = torch.cuda.mem_get_info()
            print(f"[tp] {tag}: tp 1 engine loaded in {t_one:.1f} s, tp {TP_RANKS} engine "
                  f"(ranks on {two._ranks.spec.devices}, backend "
                  f"{two.get_stats()['tp']['backend']}) in {t_two:.1f} s; the card's memory in "
                  f"use with both {(total - free) / 2**30:.1f} GiB", flush=True)
            trace.install(two)
            tags.tag = "tp2"
            two.reset_rank_launch_counts()
            two.rank_collective_stats(reset=True)
            _, wall2 = tp_batcher_serve(torch, two, ids)
            counts = two.rank_launch_counts()
            serve_stats = two.rank_collective_stats()
            tp_counts_check(f"tp {tag}", counts, fused=kv != "int8")
            tags.tag = None
            step2, step_stats = tp_step_ms(torch, two, ids)
            if kv == "int8":
                pools, two_scales = tp_prompt_scales(torch, two, ids)
                scales = (pools, two_scales, one_scales)
        finally:
            two.shutdown()
    finally:
        trace.close()
    n_tok = len(ids) * TP_TOKENS
    per_step = {k: v / TP_STEPS for k, v in step_stats[0].items()}
    print(f"[tp] {tag}: {len(ids)} requests x {TP_TOKENS} greedy tokens through the batcher: "
          f"tp 1 {wall1:.2f} s = {n_tok / wall1:.1f} tok/s, tp {TP_RANKS} {wall2:.2f} s = "
          f"{n_tok / wall2:.1f} tok/s; a decode step at batch 8: tp 1 {step1:.2f} ms, tp "
          f"{TP_RANKS} {step2:.2f} ms with {per_step['all_reduce']:.0f} all-reduces "
          f"({per_step['all_reduce_s'] * 1e3:.2f} ms) and {per_step['broadcast']:.0f} "
          f"broadcast ({per_step['broadcast_s'] * 1e3:.2f} ms) a step on rank 0; serving's "
          f"collectives by rank {serve_stats}; launches by rank {counts} ({smi})", flush=True)
    runs = trace.runs()
    check_aligned(f"tp {tag}", runs, tags=("tp1", "tp2"))
    check_sampled(f"tp {tag}", traced_rows(runs, "tp2", ids), traced_rows(runs, "tp1", ids),
                  runs, "the tp 1 engine")
    total = {}
    for c in counts:
        add_counts(total, c)
    return total, scales


def tp_scale_check(scales):
    """(a)'s int8 scale pools: both ranks' bitwise equal, and each request's
    prompt scales against the tp 1 engine's: layer 0's bitwise equal,
    deeper layers' within TP_SCALE_ULP bf16 ulp (the share equal printed
    by layer)."""
    pools, two_scales, one_scales = scales
    same_ranks = all(np.array_equal(pools[0][k], pools[r][k])
                     for r in range(1, len(pools)) for k in pools[0])
    by_layer = None
    ulps = 0
    for two_req, one_req in zip(two_scales, one_scales):
        for k in ("k_scale", "v_scale"):
            a, b = two_req[0][k], one_req[0][k]          # int16 bits [L, n]
            eq = (a == b).mean(axis=1)
            by_layer = eq if by_layer is None else np.minimum(by_layer, eq)
            ulps = max(ulps, int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max()))
            same_ranks &= all(np.array_equal(two_req[0][k], r[k]) for r in two_req[1:])
    print(f"[tp] (a) int8 scale pools: rank 0's and rank 1's bitwise equal: {same_ranks}; "
          f"against the tp 1 engine at each request's prompt positions, the share equal by "
          f"layer (least over requests) {[round(float(x), 4) for x in by_layer]}, the widest "
          f"difference {ulps} bf16 ulp, at most {TP_SCALE_ULP} allowed (layer 0, whose K and V "
          f"both engines compute from the same inputs, must be bitwise equal; deeper layers "
          f"may part: under bf16 activations each rank's row-parallel partial sum is "
          f"rounded before the all-reduce)", flush=True)
    if not same_ranks:
        raise AssertionError("[tp] (a) the ranks' replicated scale pools differ")
    if by_layer[0] != 1.0:
        raise AssertionError("[tp] (a) layer 0's scales differ from the tp 1 engine's")
    if ulps > TP_SCALE_ULP:
        raise AssertionError(f"[tp] (a) a deeper layer's scales are {ulps} bf16 ulp from the "
                             f"tp 1 engine's, over {TP_SCALE_ULP}")
    return by_layer


def tp_moe_pass(torch, pa, smi, ids, llama, model=MOE_MODEL, device="cuda"):
    """(c): mixtral-8x7b at full width, depth TP_MOE_LAYERS, int8 weights,
    bf16 pools: tp 2 (EP over E = 8 and attention TP) serves the prompts
    through ``generate`` with its routing recorded on rank 0 (both ranks
    route alike: the router is replicated and the hidden states all-reduced);
    the tp 1 engine at the same depth replays that routing (RoutePins) and
    the streams are judged. → the tp 2 ranks' summed launches."""
    import gc

    from distributed_gpu_inference_torch.models.configs import get_model_config

    full = get_model_config(model)
    torch.cuda.reset_peak_memory_stats()
    whole, t_whole = tp_engine(torch, full, None, TP_RANKS, device)
    free, total = torch.cuda.mem_get_info()
    mem = whole.rank_memory()
    whole.shutdown()
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    peaks = [m.get("peak", 0) for m in mem]
    print(f"[tp] (c) {model} at full depth ({full.num_layers} layers, int8 weights), tp "
          f"{TP_RANKS} on one card: both ranks' inits at once in {t_whole:.1f} s; the card's "
          f"memory in use after them {(total - free) / 2**30:.2f} GiB of {total / 2**30:.2f}; "
          f"each rank's peak {[round(p / 2**30, 2) for p in peaks]} GiB against the whole "
          f"int8 tree's {full.param_bytes(1) / 2**30:.2f} GiB (a rank holds half the "
          f"experts and heads, and the embedding, head and router whole; information: the "
          f"depth served below is cut)", flush=True)
    if device == "cuda" and sum(peaks) > total:
        raise AssertionError("[tp] (c) the two ranks' inits exceed the card")
    cfg = get_model_config(model, num_layers=min(TP_MOE_LAYERS, full.num_layers))
    ids = [[t % cfg.vocab_size for t in p] for p in ids]
    tags = Tag()
    trace = SampleTrace(torch, [], tags=tags)
    torch.cuda.reset_peak_memory_stats()
    two, t_two = tp_engine(torch, cfg, None, TP_RANKS, device)
    free, total = torch.cuda.mem_get_info()
    try:
        trace.install(two)
        tags.tag = "tp2"
        pins = RoutePins(torch, llama, engine=two)
        two.reset_rank_launch_counts()
        t0 = time.perf_counter()
        with pins.record():
            outs = two.generate(tp_requests(ids), use_multi_step=True)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
        counts = two.rank_launch_counts()
        tp_counts_check("tp (c)", counts, fused=True)
        experts = two.params["layers"]["we_gate"]["qw"].shape[1]
    finally:
        two.shutdown()
    del two
    gc.collect()
    torch.cuda.empty_cache()
    one, t_one = tp_engine(torch, cfg, None, 1, device)
    try:
        trace.install(one)
        tags.tag = "tp1"
        t0 = time.perf_counter()
        with pins.by_sequence(ids):
            one.generate(tp_requests(ids), use_multi_step=True)
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
    finally:
        trace.close()
    del one
    gc.collect()
    torch.cuda.empty_cache()
    if any(o.error or len(o.token_ids) != TP_TOKENS for o in outs):
        raise AssertionError(f"[tp] (c) requests failed: {[o.error for o in outs]}")
    n_tok = len(ids) * TP_TOKENS
    print(f"[tp] (c) {model} at {cfg.num_layers} of 32 layers (full width, int8 weights, "
          f"bf16 pools), tp {TP_RANKS} = {experts} of {cfg.num_experts} experts and half the "
          f"heads a rank: loaded in {t_two:.1f} s (card memory in use {(total - free) / 2**30:.1f}"
          f" GiB with both ranks), {len(ids)} requests x {TP_TOKENS} tokens through generate "
          f"in {wall2:.2f} s = {n_tok / wall2:.1f} tok/s; the tp 1 engine loaded in "
          f"{t_one:.1f} s, replayed the tp {TP_RANKS} routing in {wall1:.2f} s "
          f"({pins.pinned} routed rows pinned, {pins.flips} its own router would have "
          f"flipped); launches by rank {counts} ({smi})", flush=True)
    runs = trace.runs()
    check_aligned("tp (c)", runs, tags=("tp1", "tp2"))
    check_sampled("tp (c)", traced_rows(runs, "tp2", ids), traced_rows(runs, "tp1", ids), runs,
                  "the tp 1 engine routed as tp 2")
    total_counts = {}
    for c in counts:
        add_counts(total_counts, c)
    return total_counts


def qmm_layer_parity(torch, qmm, dev, proj, tag, m=SERVE_BATCH):
    """The quantized matmul (int8) at each of ``proj`` [(name, K, N)] and
    ``m`` rows against its plain version (seeded weights and inputs). →
    (the weights [(codes, scale)], their bf16 dequantized copies, the
    inputs by K, max abs err)."""
    from distributed_gpu_inference_torch.ops.quantization import quantize_weight

    g = torch.Generator(device=dev).manual_seed(23)
    weights, deq, q_err = [], [], 0.0
    xs = {k: torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
          for k in {k for _, k, _ in proj}}
    for _, kdim, ndim in proj:
        w = torch.randn((1, kdim, ndim), generator=g, device=dev) * kdim ** -0.5
        qw = quantize_weight(w, "int8")
        weights.append((qw["qw"], qw["scale"]))
        deq.append((qw["qw"][0].float() * qw["scale"][0]).to(torch.bfloat16))
        x = xs[kdim]
        ok_q, err, _ = errors(torch, qmm.launch_kernel(x, qw["qw"], qw["scale"]),
                              qmm.qmm_plain(x, qw["qw"], qw["scale"]), QMM_ATOL)
        if not ok_q:
            raise AssertionError(f"{tag} qmm at K={kdim} N={ndim} disagrees with its plain "
                                 "version")
        q_err = max(q_err, err)
    return weights, deq, xs, q_err


def qmm_layer_times(torch, qmm, flush, dev, proj, tag, what):
    """The quantized matmul (int8) at ``proj`` [(name, K, N)] and M =
    SERVE_BATCH: each projection against its plain version
    (:func:`qmm_layer_parity`), then the set timed call by call and as a
    CUDA graph, its plain version and ``torch.matmul`` on bf16 weights,
    against the bound. → (max abs err,
    the kernels-JSON timing keys)."""
    weights, deq, xs, q_err = qmm_layer_parity(torch, qmm, dev, proj, tag)
    calls = lambda fn: lambda: [fn(xs[qw.shape[1]], qw, sc) for qw, sc in weights]  # noqa: E731
    lib = lambda: [torch.matmul(xs[w.shape[0]], w) for w in deq]  # noqa: E731
    q_bound, q_by = bound(*qmm_cost(SERVE_BATCH, [(k, n) for _, k, n in proj]))
    q_times = {"ms": time_ms(torch, calls(qmm.launch_kernel), flush),
               "graph_ms": graph_ms(torch, calls(qmm.launch_kernel), flush),
               "plain_ms": time_ms(torch, calls(qmm.qmm_plain), flush, iters=10),
               "bound_ms": q_bound, "bound_by": q_by, "library_ms": time_ms(torch, lib, flush),
               "library_graph_ms": graph_ms(torch, lib, flush)}
    plans = {n: qmm.split_plan(SERVE_BATCH, k, n_) for n, k, n_ in proj}
    print(f"{tag} qmm int8, {what} at M={SERVE_BATCH} "
          f"({[(n, k, n_) for n, k, n_ in proj]}, plans {plans}): kernel "
          f"{q_times['ms']:.4f} ms (graph {q_times['graph_ms']:.4f} ms = "
          f"{q_bound / q_times['graph_ms']:.1%} of the bound {q_bound:.4f} ms, {q_by}), plain "
          f"{q_times['plain_ms']:.4f} ms, torch.matmul on bf16 weights "
          f"{q_times['library_ms']:.4f} ms (graph {q_times['library_graph_ms']:.4f} ms); max abs "
          f"err {q_err:.3e}", flush=True)
    return q_err, q_times


def tp_kernel_entries(torch, pa, flush, launches, dev):
    """Each kernel at one rank's shard shapes of llama3-8b at tp 2 (Nh 16,
    Hkv 4; the projections' halves), against its plain version, timed as
    phases 5 and 9 time them: ``@tp2`` entries."""
    from distributed_gpu_inference_torch.ops import qmm
    from distributed_gpu_inference_torch.ops.attention import paged_attention_ref

    out = []
    rcase = ragged_in(torch, ragged_round_case(torch, dev, hs=TP_HS), "int8")
    q, kq, vq, ks, vs, tables, pos, lens, _ = rcase
    got = pa.ragged_paged_attention(q, kq, vq, tables, pos, lens, BK, k_scale=ks, v_scale=vs)
    want = paged_attention_ref(q, kq, vq, tables, pos, lens, BK, k_scale=ks, v_scale=vs)
    atol = RAGGED_ATOL + BF16_HALF_ULP * float(torch.maximum(
        dequantized(torch, kq, ks).abs().max(), dequantized(torch, vq, vs).abs().max()).item())
    ok, r_err, _ = errors(torch, got, want, atol)
    r_times = ragged_times(torch, pa, paged_attention_ref, flush,
                           f"[tp] ragged round 8x256 int8 pools at a rank's heads {TP_HS}",
                           rcase, "int8", hs=TP_HS)
    dcase = decode_in(torch, decode_case(torch, dev, hs=TP_HS), "bf16")
    q, nk, nv, kp, vp, _, _, layer, tables, pos, lens, _ = dcase
    kp2, vp2 = kp.clone(), vp.clone()
    got, _, _ = pa.paged_decode_attention_fused(q, nk, nv, kp, vp, layer, tables, pos, lens, BK)
    want, _, _ = pa.paged_decode_attention_fused_plain(q, nk, nv, kp2, vp2, layer, tables, pos,
                                                       lens, BK)
    ok_d, d_err, _ = errors(torch, got, want, FUSED_ATOL)
    del kp2, vp2
    d_times = decode_times(torch, pa, flush, f"[tp] fused decode 8 rows bf16 pools at a rank's "
                           f"heads {TP_HS}", dcase, "bf16", hs=TP_HS)
    q_err, q_times = qmm_layer_times(torch, qmm, flush, dev, TP_PROJ, "[tp]",
                                     "a rank's share of one layer's 7 projections")
    if not (ok and ok_d):
        raise AssertionError("[tp] an attention kernel disagrees with its plain version at a "
                             "rank's heads")
    out += [entry("ragged_paged_attention[int8]@tp2", "ragged_paged_attention.cu",
                  PALLAS + ":932", launches["ragged_paged_attention"], r_err, r_times),
            entry("paged_decode_attention_fused@tp2", "paged_decode_fused.cu", PALLAS + ":469",
                  launches["paged_decode_attention_fused"], d_err, d_times),
            entry("qmm_w8a16[int8]@tp2", "qmm_w8a16.cu", QPALLAS + ":88",
                  launches["qmm_w8a16"], q_err, q_times)]
    return out


def tp_phase(torch, pa, smi, prompts, model="llama3-8b", moe_model=MOE_MODEL,
             device="cuda"):
    """Phase 23 (see the module docstring). → (its launches by pool:
    {"int8": ..., "bf16": ...}, the ``@tp2`` kernel entries)."""
    import gc

    from distributed_gpu_inference_torch.models import llama
    from distributed_gpu_inference_torch.worker.engines.llm import ByteTokenizer

    t_phase = time.perf_counter()
    tp_backend_probe()
    ids = [ByteTokenizer().encode(p) for p in prompts]
    a_counts, scales = tp_serving_pass(torch, pa, smi, "(a) int8 pools", "int8", ids, llama,
                                       model, device)
    tp_scale_check(scales)
    del scales
    gc.collect()
    torch.cuda.empty_cache()
    b_counts, _ = tp_serving_pass(torch, pa, smi, "(b) bf16 pools", None, ids, llama, model,
                                  device)
    gc.collect()
    torch.cuda.empty_cache()
    c_counts = tp_moe_pass(torch, pa, smi, ids, llama, moe_model, device)
    dev = torch.device(device)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    total = {}
    for c in (a_counts, b_counts, c_counts):
        add_counts(total, c)
    entries = tp_kernel_entries(torch, pa, flush, {
        "ragged_paged_attention": a_counts["ragged_paged_attention"],
        "paged_decode_attention_fused": b_counts["paged_decode_attention_fused"]
        + c_counts["paged_decode_attention_fused"],
        "qmm_w8a16": total["qmm_w8a16"]}, dev)
    del flush
    torch.cuda.empty_cache()
    print(f"[tp] phase 23 launches (both ranks): (a) {a_counts}, (b) {b_counts}, (c) "
          f"{c_counts}; ran in {time.perf_counter() - t_phase:.1f} s ({smi})", flush=True)
    bf16 = dict(b_counts)
    add_counts(bf16, c_counts)
    return {"int8": a_counts, "bf16": bf16}, entries


# ---------------------------------------------------------------- phase 24

SEQ_RANKS = 2                 # sequence-parallel ranks of phase 24, both on cuda:0
SEQ_LONG = 6144               # tokens of each long prompt: 3x the 2048 prefill bucket
SEQ_SHORT = (48, 130, 256, 400, 777, 1100)   # tokens of the six short prompts
SEQ_TOKENS = 32               # greedy tokens of each phase-24 request
SEQ_MAX_LEN = 8192
SEQ_BLOCKS = 2048             # pool blocks of the phase's serving engines (16 tokens each)
SEQ_HIT_PREFIX = 3000         # (c): tokens of the second long prompt a request reuses
SEQ_FRESH = 2500              # (c): its fresh tokens after them (two prefill chunks)
SEQ_HIT_SHORT = 200           # (c): fresh tokens after the fifth short prompt (one chunk)
SEQ_PD_PROMPT = 3             # (d): the short prompt PD prefills (400 tokens)
SEQ_SIDE_TOKENS = 8           # greedy tokens of (c)'s extra prompts and of (d)'s requests
SEQ_SPILL_TOKENS = 4          # greedy tokens of each request of (d)'s spill check
SEQ_OP_REPS = 3               # timed calls of each plain seq op (the median kept)
ALL_KERNELS = {"ragged_paged_attention", "paged_decode_attention_fused", "qmm_w8a16"}


def seq_prompt_ids(vocab):
    """Phase 24's prompts, seeded token ids: two long, six short."""
    rng = np.random.default_rng(24)
    return ([[int(t) for t in rng.integers(0, vocab, SEQ_LONG)] for _ in range(2)]
            + [[int(t) for t in rng.integers(0, vocab, n)] for n in SEQ_SHORT])


def seq_hit_ids(ids):
    """(c)'s two extra prompts: the second long prompt's first
    SEQ_HIT_PREFIX tokens then SEQ_FRESH new ones (a prefix-cache hit whose
    continuation spans two prefill chunks), and the fifth short prompt then
    SEQ_HIT_SHORT new ones (a hit continued in one chunk)."""
    return [ids[1][:SEQ_HIT_PREFIX] + ids[0][:SEQ_FRESH],
            ids[6] + ids[0][SEQ_FRESH:SEQ_FRESH + SEQ_HIT_SHORT]]


def sync(torch, device):
    if device == "cuda":
        torch.cuda.synchronize()


def gib(n):
    return f"{n / 2**30:.2f} GiB"


def seq_engine(torch, model_cfg, device, seq=1, **over):
    """Phase 24's engines: int8 weights and int8 pools, seed 0, the prefix
    cache off unless ``over`` says otherwise; ``seq`` ranks, all on
    ``device`` (cuda:0). → (the engine, its load seconds)."""
    from distributed_gpu_inference_torch.parallel.mesh import MeshPlan
    from distributed_gpu_inference_torch.runtime.engine import EngineConfig, TorchEngine

    cfg = EngineConfig(**{**dict(max_batch_size=SERVE_BATCH, max_seq_len=SEQ_MAX_LEN,
                                 num_blocks=SEQ_BLOCKS, enable_prefix_cache=False,
                                 quantization="int8", kv_cache_dtype="int8"), **over})
    dev = "cuda:0" if device == "cuda" else device
    t0 = time.perf_counter()
    eng = TorchEngine(model_cfg, cfg, seed=0, device=device,
                      rank_devices=[dev] * seq if seq > 1 else None,
                      mesh=MeshPlan(seq=seq) if seq > 1 else None)
    sync(torch, device)
    return eng, time.perf_counter() - t0


def trace_on(trace, engine):
    """Install ``trace`` on ``engine`` once."""
    if "_sample" not in vars(engine):
        trace.install(engine)


def seq_pass(torch, tag, engine, ids, tags, trace, device, n=None):
    """``ids`` through ``generate`` (multi-step decode, ``n`` greedy tokens
    each, SEQ_TOKENS by default) under the trace, tagged ``tag``; the
    launch counters and collectives zeroed just before and read just after.
    → (responses, wall seconds, launches by rank, collectives by rank,
    memory by rank)."""
    n = n or SEQ_TOKENS
    trace_on(trace, engine)
    if engine._ranks is not None:
        engine.rank_collective_stats(reset=True)
    engine.reset_rank_launch_counts()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tags.tag = tag
    t0 = time.perf_counter()
    outs = engine.generate(tp_requests(ids, n), use_multi_step=True)
    sync(torch, device)
    wall = time.perf_counter() - t0
    tags.tag = None
    bad = [(o.error, len(o.token_ids)) for o in outs if o.error or len(o.token_ids) != n]
    if bad:
        raise AssertionError(f"[seq] {tag}: requests failed: {bad}")
    counts = engine.rank_launch_counts()
    coll = engine.rank_collective_stats() if engine._ranks is not None else []
    return outs, wall, counts, coll, engine.rank_memory()


def seq_report(what, engine, outs, wall, counts, coll, mem, n_long, smi):
    """One line for a pass: tok/s, the seq-parallel prefills' ms, TTFT,
    each rank's collectives (count and ms), peak memory, pool bytes and
    launches."""
    n_sp = engine.stats.get("seq_parallel_prefills", 0)
    sp_ms = engine.stats.get("seq_parallel_prefill_s", 0.0) * 1e3 / max(n_sp, 1)
    ttft = [round(o.ttft_ms, 1) for o in outs]
    colls = [coll_text(c) for c in coll]
    n_tok = sum(len(o.token_ids) for o in outs)
    print(f"[seq] {what}: {len(outs)} requests x {len(outs[0].token_ids)} greedy tokens in "
          f"{wall:.2f} s "
          f"({n_tok / wall:.1f} tok/s); seq-parallel prefills so far {n_sp}, {sp_ms:.1f} ms "
          f"each; TTFT ms of the long prompts {ttft[:n_long]}, of the others {ttft[n_long:]}; "
          f"collectives by rank (count, ms) {colls}; peak memory by rank "
          f"{[gib(m.get('peak', 0)) for m in mem]}, pools by rank "
          f"{[gib(m['pool_bytes']) for m in mem]}; launches by rank {counts} ({smi})",
          flush=True)


def coll_text(stats):
    """A rank's collective stats without the zeros, seconds as ms."""
    return {k: (round(v * 1e3, 2) if k.endswith("_s") else int(v))
            for k, v in stats.items() if v}


def seq_counts_check(tag, counts, want):
    """Rank r launched exactly the kernels ``want[r]`` names."""
    for r, (c, names) in enumerate(zip(counts, want)):
        for k in ("ragged_paged_attention", "paged_decode_attention_fused", "qmm_w8a16"):
            if (c[k] > 0) != (k in names):
                raise AssertionError(f"[seq] {tag}: rank {r} launched {c}, expected only "
                                     f"{sorted(names)}")


def release(torch, device, *engines):
    import gc

    for eng in engines:
        if eng is not None:
            eng.shutdown()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


def seq_serving(torch, smi, cfg, ids, tags, trace, device, over):
    """(a)-(c): the seq 1 engine, then ring and Ulysses over replicated
    pools and block-sharded pools at seq 2, each serving ``ids``; the seq 1
    engine and (c) also serve :func:`seq_hit_ids` (on (c) a prefix-cache
    hit and a chunked continuation). → (launches summed over every rank,
    the (c) engine, kept for (d))."""
    hit = seq_hit_ids(ids)
    total = {}
    one, t_one = seq_engine(torch, cfg, device, **over)
    try:
        print(f"[seq] seq 1 engine loaded in {t_one:.1f} s", flush=True)
        res = seq_pass(torch, "seq1", one, ids, tags, trace, device)
        seq_report("seq 1", one, *res, 2, smi)
        seq_counts_check("seq 1", res[2], [ALL_KERNELS])
        pools_one = res[4][0]["pool_bytes"]
        hres = seq_pass(torch, "seq1", one, hit, tags, trace, device, SEQ_SIDE_TOKENS)
        seq_report("seq 1, (c)'s prompts", one, *hres, 0, smi)
    finally:
        release(torch, device, one)
        del one
    kept = None
    for tag, extra in (("ring", {}), ("ulysses", {"seq_parallel_impl": "ulysses"}),
                       ("sharded", {"kv_seq_sharded": True, "enable_prefix_cache": True})):
        eng, t_load = seq_engine(torch, cfg, device, seq=SEQ_RANKS, **{**over, **extra})
        try:
            print(f"[seq] {tag}: seq {SEQ_RANKS} engine (ranks on {eng._ranks.spec.devices}, "
                  f"backend {eng.get_stats()['seq']['backend']}) loaded in {t_load:.1f} s",
                  flush=True)
            res = seq_pass(torch, tag, eng, ids, tags, trace, device)
            seq_report(tag, eng, *res, 2, smi)
            n_long = sum(len(p) > eng.cfg.prefill_buckets[-1] for p in ids)
            if eng.stats.get("seq_parallel_prefills") != n_long:
                raise AssertionError(f"[seq] {tag}: {eng.stats.get('seq_parallel_prefills')} "
                                     f"seq-parallel prefills, not {n_long}")
            for c in res[2]:
                add_counts(total, c)
            if tag != "sharded":
                # rank 0 serves alone outside the long prompts' prefill, and
                # rank 1's prefill rows are above qmm's row bound
                seq_counts_check(tag, res[2], [ALL_KERNELS, set()])
                continue
            # block-sharded: every rank runs every forward (qmm at decode);
            # attention reads are the partial-softmax ops, no kernel
            seq_counts_check(tag, res[2], [{"qmm_w8a16"}] * SEQ_RANKS)
            ratio = [m["pool_bytes"] / pools_one for m in res[4]]
            print(f"[seq] (c) pool bytes by rank {[gib(m['pool_bytes']) for m in res[4]]} "
                  f"against seq 1's {gib(pools_one)}: {[round(r, 4) for r in ratio]}",
                  flush=True)
            if any(abs(r - 1 / SEQ_RANKS) > 1e-3 for r in ratio):
                raise AssertionError(f"[seq] (c): the ranks hold {ratio} of the pool")
            hres = seq_pass(torch, "sharded-hit", eng, hit, tags, trace, device,
                            SEQ_SIDE_TOKENS)
            seq_report("(c) a prefix-cache hit and a chunked continuation", eng, *hres, 0, smi)
            cached = [o.cached_tokens for o in hres[0]]
            want = [SEQ_HIT_PREFIX // BK * BK, len(ids[6]) // BK * BK]
            print(f"[seq] (c) cached tokens {cached} (at least {want})", flush=True)
            if any(c < w for c, w in zip(cached, want)):
                raise AssertionError(f"[seq] (c): the prefix cache did not hit: {cached}")
            seq_counts_check("sharded-hit", hres[2], [{"qmm_w8a16"}] * SEQ_RANKS)
            for c in hres[2]:
                add_counts(total, c)
            kept, eng = eng, None
        finally:
            release(torch, device, eng)
    return total, kept


def seq_spill_check(torch, llm, tag):
    """(d)'s spill: on a ``tp_size: 2`` worker with an L2 tier, prompt A
    served twice (the L1-hit reference), fillers until A's restorable
    blocks are all spilled, then A served from L2: the restored pages
    (gathered across the ranks) bitwise equal to the spilled ones, and the
    stream equal to the reference. → l2 hits."""
    from distributed_gpu_inference_torch.utils.data_structures import compute_prefix_hash

    eng, mgr = llm.engine, llm.engine.manager
    text = spill_text(0)
    keys = [compute_prefix_hash(llm.tokenizer.encode(text), (i + 1) * BK)
            for i in range(SPILL_RESTORED)]
    spilled, restored = {}, []
    store, push = mgr.store_spilled, eng.push_pages

    def record(key, page, scale=None):
        spilled[key] = (page, scale)
        store(key, page, scale)

    def push_read(bids, pages, scales):
        push(bids, pages, scales)
        restored.append(eng.gather_pages(bids))

    mgr.store_spilled, eng.push_pages = record, push_read
    try:
        serve_ids(llm, text, SEQ_SPILL_TOKENS)
        ref, out = serve_ids(llm, text, SEQ_SPILL_TOKENS)
        fillers = 0
        while not set(keys) <= set(spilled) and fillers < SPILL_FILLERS:
            serve_ids(llm, spill_text(100 + fillers), SEQ_SPILL_TOKENS)
            fillers += 1
        before = mgr.get_stats()["l2_hits"]
        restored.clear()
        ids, out = serve_ids(llm, text, SEQ_SPILL_TOKENS)
        hits = mgr.get_stats()["l2_hits"] - before
        block = restored[-1] if restored else None
        same = block is not None and len(block.pages) == len(keys) and all(
            same_bits(torch, block.pages[i], spilled[k][0])
            and same_bits(torch, block.scales[i], spilled[k][1]) for i, k in enumerate(keys))
    finally:
        del mgr.store_spilled, eng.push_pages
    print(f"[seq] (d) {tag}: A ({SPILL_PROMPT_TOKENS} tokens) served, {fillers} fillers "
          f"spilled its {len(keys)} restorable blocks to L2 (spills "
          f"{mgr.get_stats()['spills']}); served again: l2_hits +{hits}, the restored pages "
          f"gathered from both ranks bitwise equal to the spilled ones: {same}; stream equal "
          f"to the L1-hit reference: {ids == ref}", flush=True)
    if hits != len(keys) or not same or ids != ref:
        raise AssertionError(f"[seq] (d) {tag}: the L2 restore failed: hits {hits}, pages "
                             f"{same}, stream {ids} vs {ref}")
    return hits


def seq_handoffs(torch, smi, model, ids, box, tags, trace, device, over):
    """(d): the block-sharded seq 2 engine of (c) (``box["donor"]``, released
    here once it has streamed) streams the first long prompt into a tp 2
    decode engine (``StreamedExport`` → ``HandoffReceiver``); then one
    request through ``pd_stage: prefill`` on a ``tp_size: 2`` worker and
    ``pd_stage: decode`` on another (the decode one is the stream's
    recipient), pushed over a ``DataPlaneServer``; then the prefill worker's
    L2 spill and restore. → launches summed over every rank."""
    from distributed_gpu_inference_torch.comm.data_plane import DataPlaneServer
    from distributed_gpu_inference_torch.ops import paged_attention as pa
    from distributed_gpu_inference_torch.runtime import kv_handoff as kh
    from distributed_gpu_inference_torch.worker.engines import llm as llm_mod

    dev = torch.device("cuda", 0) if device == "cuda" else torch.device("cpu")
    base = {"model": model, "device": device, "seed": 0, "quantization": "int8",
            "kv_cache_dtype": "int8", "max_batch_size": SERVE_BATCH, "tp_size": 2,
            "prefix_summary_top_n": 0}
    total, dec, pre, plane = {}, None, None, None
    donor = box.pop("donor")

    def worker(cfg):
        # a worker takes one card a rank; here both ranks share cuda:0
        with patched(llm_mod, "rank_devices", lambda d, tp: [dev] * tp):
            t0 = time.perf_counter()
            llm = llm_mod.TorchLLMEngine({**base, **cfg})
            llm.load_model()
        trace_on(trace, llm.engine)
        return llm, time.perf_counter() - t0

    try:
        dec, t_dec = worker({"max_seq_len": SEQ_MAX_LEN, "num_blocks": SEQ_BLOCKS,
                             "enable_prefix_cache": False, "serving": {"mode": "direct"},
                             **over})
        # rank 0 of every engine here is this process: one counter, zeroed once
        for eng in (donor, dec.engine):
            eng.reset_rank_launch_counts()
            eng.rank_collective_stats(reset=True)
        donor.manager.clear_cached()        # the stream starts from an empty radix
        rx = kh.HandoffReceiver(dec.engine)
        req = tp_requests([ids[0]], SEQ_SIDE_TOKENS)[0]
        tags.tag = "d-donor"
        t0 = time.perf_counter()
        exp = kh.StreamedExport(donor, req, key="seq-stream", piece_blocks=PD_PIECE_BLOCKS)
        result = None
        for msg in exp.messages():
            result = rx.handle(msg)
        sync(torch, device)
        t_stream = time.perf_counter() - t0
        if result is None or result.get("state") != "committed":
            raise AssertionError(f"[seq] (d) the stream did not commit: {result}")
        tags.tag = "d-stream"
        slot, eng = result["slot"], dec.engine
        while eng.slots[slot].finish_reason is None:
            eng.decode_multi()
        got = eng.finish_slot(slot, cache=False)
        tags.tag = None
        donor_own = donor.rank_launch_counts()[1:]
        print(f"[seq] (d) seq {SEQ_RANKS} block-sharded donor -> tp 2 recipient (a tp 2 "
              f"worker, loaded in {t_dec:.1f} s): {len(ids[0])}-token prompt streamed in "
              f"{t_stream:.2f} s ({exp.bytes_before_first_token} B before the first token), "
              f"{len(got.token_ids)} tokens; collectives by rank (count, ms): donor "
              f"{[coll_text(c) for c in donor.rank_collective_stats()]}, recipient "
              f"{[coll_text(c) for c in dec.engine.rank_collective_stats()]} ({smi})",
              flush=True)
        if len(got.token_ids) != SEQ_SIDE_TOKENS:
            raise AssertionError(f"[seq] (d) the streamed request gave {got.token_ids}")
        exp = None                          # it holds the donor
        release(torch, device, donor)       # its card memory before the next worker's
        donor = None

        pre, t_pre = worker({"max_seq_len": 512, "num_blocks": SPILL_POOL_BLOCKS,
                             "kv_spill_host_blocks": SPILL_HOST_BLOCKS,
                             **{k: v for k, v in over.items()
                                if k in ("prefill_buckets", "dtype")}})
        plane = DataPlaneServer(kv_receiver=dec.kv_receiver)
        plane.start()
        prompt = ids[2 + SEQ_PD_PROMPT]
        tags.tag = "d-pd-prefill"
        t0 = time.perf_counter()
        pre_out = pre.inference(pd_params("", "seq-pd", plane.url, prompt_token_ids=prompt,
                                          max_new_tokens=SEQ_SIDE_TOKENS))
        tags.tag = "d-pd"
        dec_out = dec.inference({"pd_stage": "decode", "kv_cache_key": "seq-pd"})
        t_pd = time.perf_counter() - t0
        tags.tag = None
        print(f"[seq] (d) PD under tp 2: a {len(prompt)}-token prompt prefilled on a tp 2 "
              f"worker (loaded in {t_pre:.1f} s), pushed over the data plane, decoded on the "
              f"other in {t_pd:.2f} s (prefill {pre_out.get('usage')}, decode "
              f"{dec_out.get('usage')})", flush=True)
        if len(dec_out.get("token_ids", ())) != SEQ_SIDE_TOKENS:
            raise AssertionError(f"[seq] (d) PD decode gave {dec_out}")
        seq_spill_check(torch, pre, "L2 under tp 2")
        own = [donor_own, dec.engine.rank_launch_counts()[1:],
               pre.engine.rank_launch_counts()[1:]]
        add_counts(total, pa.launch_counts())
        for counts in own:
            for c in counts:
                add_counts(total, c)
        print(f"[seq] (d) launches: rank 0 of the three engines (this process) "
              f"{pa.launch_counts()}; rank 1 of the donor {own[0]}, of the decode worker "
              f"{own[1]}, of the prefill worker {own[2]}", flush=True)
        # int8 pools under tensor parallelism decode through the ragged kernel
        tp_reads = {"ragged_paged_attention", "qmm_w8a16"}
        seq_counts_check("(d) rank 0, the decode worker and the prefill worker",
                         [pa.launch_counts()] + own[1] + own[2], [tp_reads] * 3)
    finally:
        tags.tag = None
        if plane is not None:
            plane.stop()
        for llm in (pre, dec):
            if llm is not None:
                llm.unload()
        release(torch, device, donor)
    return total


def _seq_ops_rank(group, dims, reps):
    """One rank of the plain seq ops at the path's shapes (run by
    ``runtime/tp.py`` ``run_group``, every rank on the same device): ring
    and Ulysses over a long prompt's rows, the paged decode op over 8 rows
    of a block-sharded int8 pool, and the chunk op of one prefill chunk
    over a long context. → the median ms of each, and the collectives."""
    import torch

    from distributed_gpu_inference_torch.parallel import ring_attention as ra

    s, nh, hkv, d, ctx, chunk, rows = dims
    dev = group.device
    mine = torch.Generator(device=dev).manual_seed(24 + group.rank)
    same = torch.Generator(device=dev).manual_seed(24)   # replicated inputs
    per = s // group.size
    q, k, v = (torch.randn((1, per, h, d), generator=mine, device=dev).to(torch.bfloat16)
               for h in (nh, hkv, hkv))
    lens = torch.tensor([s], device=dev)
    m = -(-ctx // BK)
    blocks = -(-rows * m // group.size) * group.size
    nloc = blocks // group.size
    kp = torch.randint(-127, 128, (nloc, hkv, BK, d), generator=mine, device=dev,
                       dtype=torch.int8)
    vp = torch.randint(-127, 128, (nloc, hkv, BK, d), generator=mine, device=dev,
                       dtype=torch.int8)
    ks = (torch.rand((nloc, BK), generator=mine, device=dev) * 0.02).to(torch.bfloat16)
    vs = (torch.rand((nloc, BK), generator=mine, device=dev) * 0.02).to(torch.bfloat16)
    tables = torch.randperm(blocks, generator=same, device=dev)[:rows * m].reshape(rows, m)
    tables = tables.to(torch.int32)
    qd = torch.randn((rows, 1, nh, d), generator=same, device=dev).to(torch.bfloat16)
    kl = torch.full((rows,), ctx, dtype=torch.int32, device=dev)
    qc = torch.randn((1, chunk, nh, d), generator=same, device=dev).to(torch.bfloat16)
    pc = torch.arange(ctx - chunk, ctx, dtype=torch.int32, device=dev)[None]

    def timed(fn):
        out = []
        for _ in range(reps + 1):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            out.append(time.perf_counter() - t0)
        return float(np.median(out[1:])) * 1e3

    group.reset_stats()
    times = {
        "ring": timed(lambda: ra.ring_self_attention(q, k, v, lens, group)),
        "ulysses": timed(lambda: ra.ulysses_self_attention(q, k, v, lens, group)),
        "paged_decode": timed(lambda: ra.seq_parallel_paged_decode_attention(
            qd, kp, vp, tables, kl[:, None] - 1, kl, group, BK, k_scale=ks, v_scale=vs)),
        "paged_chunk": timed(lambda: ra.seq_parallel_paged_chunk_attention(
            qc, kp, vp, tables[:1], pc, kl[:1], group, BK, k_scale=ks, v_scale=vs)),
    }
    times["collectives"] = coll_text(group.stats)
    if dev.type == "cuda":
        times["peak"] = torch.cuda.max_memory_allocated(dev)
    return times


def seq_op_times(torch, smi, device, dims):
    """The plain ring, Ulysses and partial-softmax ops timed on two ranks
    (their own processes, both on ``device``) at ``dims``; prints each
    rank's median ms."""
    from distributed_gpu_inference_torch.runtime import tp as tp_ranks

    dev = "cuda:0" if device == "cuda" else device
    t0 = time.perf_counter()
    out = tp_ranks.run_group(_seq_ops_rank, [dev] * SEQ_RANKS, dims, SEQ_OP_REPS)
    s, nh, hkv, d, ctx, chunk, rows = dims
    for r, t in enumerate(out):
        print(f"[seq] plain ops, rank {r} of {SEQ_RANKS} (median of {SEQ_OP_REPS}, host clock "
              f"around a synchronized call): ring over {s} rows ({s // SEQ_RANKS} a rank, Nh "
              f"{nh}, Hkv {hkv}, D {d}) {t['ring']:.2f} ms, Ulysses {t['ulysses']:.2f} ms; "
              f"partial-softmax paged decode, {rows} rows at kv {ctx} over int8 pages "
              f"{t['paged_decode']:.2f} ms; paged chunk of {chunk} queries at kv {ctx} "
              f"{t['paged_chunk']:.2f} ms; collectives over all timed calls "
              f"{t['collectives']}; peak {gib(t.get('peak', 0))} ({smi})", flush=True)
    print(f"[seq] plain ops timed in {time.perf_counter() - t0:.1f} s", flush=True)
    return out


class PathShapes:
    """What phase 24's main path gives the three kernels in this process
    (rank 0 of every engine; the other ranks launch at the same shapes: a
    tp rank at rank 0's, a block-sharded rank 1 qmm at rank 0's rows, a
    replicated rank 1 nothing), recorded by wrapping the names that
    ``models/llama.py`` calls: for each kernel and call shape, the tables,
    positions and lengths of its latest call (a decode's longest context),
    and qmm's (M, K, N) on its kernel route."""

    def __init__(self):
        self.ragged, self.fused, self.qmm = {}, {}, set()

    @contextlib.contextmanager
    def recording(self, llama, qmm):
        ragged, fused, matmul = (llama.ragged_paged_attention,
                                 llama.paged_decode_attention_fused, llama.matmul)

        def rec_ragged(q, kp, vp, tables, pos, lens, *a, **kw):
            key = (tuple(q.shape), tuple(kp.shape), kw.get("k_scale") is not None,
                   kw.get("window"))
            self.ragged[key] = (tables.clone(), pos.clone(), lens.clone())
            return ragged(q, kp, vp, tables, pos, lens, *a, **kw)

        def rec_fused(q, nk, nv, kp, vp, layer, tables, pos, lens, *a, **kw):
            key = (tuple(q.shape), tuple(kp.shape), kw.get("k_scale") is not None,
                   kw.get("window"))
            self.fused[key] = (tables.clone(), pos.clone(), lens.clone())
            return fused(q, nk, nv, kp, vp, layer, tables, pos, lens, *a, **kw)

        def rec_matmul(x, w):
            if isinstance(w, dict) and x.numel() // x.shape[-1] <= qmm.MAX_KERNEL_ROWS:
                self.qmm.add((x.numel() // x.shape[-1], *w["qw"].shape[-2:]))
            return matmul(x, w)

        with patched(llama, "ragged_paged_attention", rec_ragged), \
                patched(llama, "paged_decode_attention_fused", rec_fused), \
                patched(llama, "matmul", rec_matmul):
            yield self


def path_pools(torch, g, shape, scaled, dev):
    """Seeded pools of ``shape`` ([N, Hkv, Bk, D] or [L, N, Hkv, Bk, D]):
    standard-normal bf16 K and V, quantized per token as the engine
    quantizes (int8 codes with bf16 scales, phases 6 and 10's pools) when
    ``scaled``. → (k, v, k_scale, v_scale)."""
    kp, vp = (torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
              for _ in range(2))
    return kv_pools(torch, kp, vp, "int8" if scaled else "bf16")


def seq_kernel_parity(torch, pa, shapes, flush, dev, tag="seq", max_len=None):
    """The three kernels at every shape :class:`PathShapes` recorded on
    the path, on seeded pools of the engines' own size with the recorded
    tables, positions and lengths, held to their plain versions with the
    phase 3/6/10 tolerances (the ragged kernel's plain version row by
    row, to bound its scores' memory); the fused kernel's pools bitwise
    equal to the plain write's. Then the seq engines' decode shape and the
    tp 2 decode engine's, each timed as phase 10 times: ``@seq`` entries
    (launches filled in by the caller). ``tag`` names the phase in its
    lines and entries (``@<tag>``), ``max_len`` its engines' longest
    tables (SEQ_MAX_LEN). → (max abs err by kernel, the timed cases'
    timing keys by entry name)."""
    from distributed_gpu_inference_torch.ops import qmm
    from distributed_gpu_inference_torch.ops.attention import paged_attention_ref

    max_len = max_len or SEQ_MAX_LEN
    g = torch.Generator(device=dev).manual_seed(24)
    worst = {"ragged_paged_attention": 0.0, "paged_decode_attention_fused": 0.0,
             "qmm_w8a16": 0.0}
    timed, bad = {}, []
    for (qs, ps, scaled, window), (tables, pos, lens) in sorted(shapes.ragged.items(),
                                                               key=lambda kv: str(kv[0])):
        q = torch.randn(qs, generator=g, device=dev).to(torch.bfloat16)
        kq, vq, ks, vs = path_pools(torch, g, ps, scaled, dev)
        sc = dict(k_scale=ks, v_scale=vs, window=window)
        got = pa.ragged_paged_attention(q, kq, vq, tables, pos, lens, BK, **sc)
        atol = RAGGED_ATOL
        if scaled:
            atol += BF16_HALF_ULP * float(torch.maximum(
                dequantized(torch, kq, ks).abs().max(),
                dequantized(torch, vq, vs).abs().max()).item())
        ok, err, vec, rows = True, 0.0, 0.0, 0
        for i in range(qs[0]):
            if not bool((pos[i] >= 0).any().item()):
                continue
            want = paged_attention_ref(q[i:i + 1], kq, vq, tables[i:i + 1], pos[i:i + 1],
                                       lens[i:i + 1], BK, **sc)
            r_ok, r_err, r_vec = errors(torch, got[i:i + 1], want, atol)
            ok, err, vec, rows = ok and r_ok, max(err, r_err), max(vec, r_vec), rows + 1
        pad_zero = bool((got[pos < 0] == 0).all().item())
        print(f"[{tag}] path shape: ragged q {list(qs)}, pool {list(ps)}, M {tables.shape[1]}, "
              f"kv lens {sorted(set(lens.tolist()))} ({rows} live rows): max_abs_err {err:.3e} "
              f"max_vector_rel_err {vec:.3e} (bound atol {atol:.3e} rtol {RTOL}, vector "
              f"{VEC_REL}); pad queries exact zero: {pad_zero}", flush=True)
        if not (ok and pad_zero):
            bad.append(f"ragged at {qs}, M {tables.shape[1]}")
        worst["ragged_paged_attention"] = max(worst["ragged_paged_attention"], err)
        if qs[1] == 1 and tables.shape[1] == max_len // BK:
            # a decode round (one query a row) at the long tables: the tp 2
            # decode engine's, whose int8 pools decode through this kernel
            hs, kind = (qs[2], ps[1], qs[3]), "int8" if scaled else "bf16"
            case = (q, kq, vq, ks, vs, tables, pos, lens,
                    (tables.cpu().numpy(), pos.cpu().numpy(), lens.cpu().numpy()))
            name = f"ragged_paged_attention[{kind}]@{tag}" + ("-tp2" if qs[2] < NH else "")
            timed[name] = (ragged_times(
                torch, pa, paged_attention_ref, flush, f"[{tag}] ragged decode round, heads {hs}, "
                f"M {tables.shape[1]}, kv lens {lens.tolist()}", case, kind, hs=hs), err)
        del q, kq, vq, ks, vs, got
    for (qs, ps, scaled, window), (tables, pos, lens) in sorted(shapes.fused.items(),
                                                               key=lambda kv: str(kv[0])):
        b, _, nh, d = qs
        q = torch.randn(qs, generator=g, device=dev).to(torch.bfloat16)
        nk, nv = (torch.randn((b, 1, ps[2], d), generator=g, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        kq, vq, ks, vs = path_pools(torch, g, ps, scaled, dev)
        layer = ps[0] - 1
        lens_np = lens.cpu().numpy()
        case = (q, nk, nv, kq, vq, ks, vs, layer, tables, pos, lens, lens_np)
        kind = "int8" if scaled else "bf16"
        try:
            err = long_parity_fused(torch, pa, kind, case,
                                    f"[{tag}] path shape: fused decode q {list(qs)}, pools "
                                    f"{list(ps)} (layer {layer}), M {tables.shape[1]} (plan "
                                    f"{pa.kv_split_plan(tables.shape[1], BK)}), kv lens "
                                    f"{lens_np.tolist()}")
        except AssertionError as e:
            bad.append(str(e))
            continue
        worst["paged_decode_attention_fused"] = max(worst["paged_decode_attention_fused"], err)
        name = f"paged_decode_attention_fused[{kind}]@{tag}" + ("-tp2" if nh < NH else "")
        timed[name] = (decode_times(
            torch, pa, flush, f"[{tag}] fused decode of the seq engines, M {tables.shape[1]}, kv "
            f"lens {lens_np.tolist()}", case, kind, hs=(nh, ps[2], d)), err)
        del q, nk, nv, kq, vq, ks, vs, case
    for m, k, n in sorted(shapes.qmm):
        try:
            *_, err = qmm_layer_parity(torch, qmm, dev, [("path", k, n)], f"[{tag}]", m=m)
        except AssertionError as e:
            bad.append(str(e))
            continue
        print(f"[{tag}] path shape: qmm int8 M={m} K={k} N={n} (plan "
              f"{qmm.split_plan(m, k, n)}): max abs err {err:.3e} (bound atol {QMM_ATOL} "
              f"rtol {RTOL}, row {VEC_REL})", flush=True)
        worst["qmm_w8a16"] = max(worst["qmm_w8a16"], err)
    torch.cuda.empty_cache()
    print(f"[{tag}] the kernels at every shape the path gave them ({len(shapes.ragged)} ragged, "
          f"{len(shapes.fused)} fused decode, {len(shapes.qmm)} qmm) against their plain "
          f"versions: max abs err {worst}", flush=True)
    if bad:
        raise AssertionError(f"[{tag}] kernels disagree with their plain versions: {bad}")
    return worst, timed


def seq_phase(torch, pa, smi, model="llama3-8b", device="cuda", over=None):
    """Phase 24 (see the module docstring). → (its launches summed over
    every rank, its ``@seq`` kernel entries). ``over``: engine settings
    for every engine of the phase."""
    from distributed_gpu_inference_torch.models import llama
    from distributed_gpu_inference_torch.models.configs import get_model_config
    from distributed_gpu_inference_torch.ops import qmm
    from distributed_gpu_inference_torch.runtime.engine import EngineConfig

    over = dict(over or {})
    t_phase = time.perf_counter()
    cfg = get_model_config(model)
    ids = seq_prompt_ids(cfg.vocab_size)
    tags = Tag()
    trace = SampleTrace(torch, [], tags=tags)
    shapes = PathShapes()
    try:
        with shapes.recording(llama, qmm):
            total, donor = seq_serving(torch, smi, cfg, ids, tags, trace, device, over)
            box = {"donor": donor}      # held only by (d), which releases it early
            del donor
            add_counts(total, seq_handoffs(torch, smi, model, ids, box, tags, trace, device,
                                           over))
    finally:
        trace.close()
    runs = trace.runs()
    hit = seq_hit_ids(ids)
    pd = [ids[2 + SEQ_PD_PROMPT]]
    check_aligned("seq", runs, tags=("seq1", "ring", "ulysses", "sharded", "sharded-hit",
                                     "d-stream", "d-pd"))
    for tag, prompts in (("ring", ids), ("ulysses", ids), ("sharded", ids),
                         ("sharded-hit", hit), ("d-stream", ids[:1]), ("d-pd", pd)):
        check_sampled(f"seq {tag}", traced_rows(runs, tag, prompts),
                      traced_rows(runs, "seq1", prompts), runs, "the seq 1 engine")
    bucket = over.get("prefill_buckets", EngineConfig.prefill_buckets)[-1]
    seq_op_times(torch, smi, device, (SEQ_LONG, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                                      SEQ_LONG + SEQ_TOKENS, bucket, SERVE_BATCH))
    entries = []
    if device == "cuda":
        flush = torch.empty(128 << 20, dtype=torch.uint8, device=device)
        _, timed = seq_kernel_parity(torch, pa, shapes, flush, torch.device(device))
        del flush
        for name, (times, err) in timed.items():
            base = name.split("[")[0]
            source = ("ragged_paged_attention.cu" if base == "ragged_paged_attention"
                      else "paged_decode_fused.cu")
            line = ":932" if base == "ragged_paged_attention" else ":469"
            entries.append(entry(name, source, PALLAS + line, total[base], err, times))
    print(f"[seq] phase 24 launches (every rank): {total}; ran in "
          f"{time.perf_counter() - t_phase:.1f} s ({smi})", flush=True)
    return total, entries


# ------------------------------------------------------- the whole deployment

DEPLOY_TOKENS = 32            # greedy tokens of each phase-25 chat
DEPLOY_LONG_TOKENS = 256      # the job whose worker is killed mid-run
DEPLOY_CKPT_TOKENS = 8        # the heartbeat checkpoint it must hold first
DEPLOY_HB_TIMEOUT_S = 5.0     # the plane's heartbeat timeout (its CLI flag)
DEPLOY_SWEEP_S = 0.5          # the plane's background sweep interval
DEPLOY_HB_S = 0.5             # each worker's heartbeat interval


class PlaneProcess:
    """The port's control plane as its own process, started through its
    CLI (``python -m distributed_gpu_inference_torch.server.app --port
    0``) with the sqlite DB in ``db``; the banner names the bound port. A
    thread drains its output (kept in ``lines``)."""

    def __init__(self, db):
        import os

        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
        self.lines = []
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "distributed_gpu_inference_torch.server.app",
             "--host", "127.0.0.1", "--port", "0", "--db", db,
             "--heartbeat-timeout-s", str(DEPLOY_HB_TIMEOUT_S),
             "--sweep-interval-s", str(DEPLOY_SWEEP_S)],
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        ready = threading.Event()
        self.port = None

        def drain():
            import re

            for line in self.proc.stdout:
                self.lines.append(line.rstrip())
                m = re.search(r"Running on http://127\.0\.0\.1:(\d+)", line)
                if m and self.port is None:
                    self.port = int(m.group(1))
                    ready.set()
            ready.set()

        threading.Thread(target=drain, daemon=True).start()
        if not ready.wait(120) or self.port is None:
            self.stop()
            raise AssertionError(f"the plane did not come up: {self.lines[-20:]}")
        self.url = f"http://127.0.0.1:{self.port}"

    def get(self, path):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=HTTP_TIMEOUT)
        try:
            conn.request("GET", path)
            r = conn.getresponse()
            body = r.read()
            ctype = r.getheader("Content-Type") or ""
            return r.status, (json.loads(body) if ctype.startswith("application/json")
                              else body.decode())
        finally:
            conn.close()

    def stop(self):
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def hard_kill(worker, thread):
    """Worker A dies as a crashed process would: its plane connections are
    cut first (nothing of it reaches the plane again: no release, no
    completion, no offline call), then its poll loop, direct server and
    engine stop; the plane learns of it when the heartbeats stop."""
    worker.api.close()
    worker._shutdown.set()
    if worker._direct is not None:
        worker._direct.stop()
    worker.engines["llm"].unload()
    thread.join(timeout=300)
    if thread.is_alive():
        raise AssertionError("the killed worker's thread did not end")


def metric_value(text, name, **labels):
    """The value of one sample of a Prometheus text page (0.0 if absent)."""
    want = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    key = name + ("{" + want + "}" if want else "")
    for line in text.splitlines():
        if line.startswith(key + " "):
            return float(line.split()[-1])
    return 0.0


def deployment_phase(torch, pa, smi, prompts, model="llama3-8b", quantization="int8"):
    """Phase 25 (see the module docstring): the port's plane as a process,
    two CLI workers on threads, the port's SDK as the client; raises on any
    failed check. → the phase's launch counts."""
    import sqlite3
    import tempfile

    from distributed_gpu_inference_torch.sdk.client import InferenceClient
    from distributed_gpu_inference_torch.worker import main as wmain

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_deploy_")
    plane = PlaneProcess(f"{tmp.name}/plane.sqlite")
    workers = {}
    client = InferenceClient(plane.url, backoff_s=0.05, timeout_s=HTTP_TIMEOUT)
    try:
        print(f"[deploy] the port's plane up as its own process (pid {plane.proc.pid}) on "
              f"{plane.url}, heartbeat timeout {DEPLOY_HB_TIMEOUT_S} s, sweep every "
              f"{DEPLOY_SWEEP_S} s", flush=True)
        pa.reset_launch_counts()
        rtt = {}
        for name in ("A", "B"):
            path = f"{tmp.name}/worker-{name}.json"
            # a worker registers before its direct server binds, so the
            # plane learns the URL only from the config: a free port, named
            port = free_port()
            with open(path, "w") as f:
                json.dump({
                    "name": f"deploy-{name}", "server": {"url": plane.url},
                    "engines": {"llm": {"model": model, "quantization": quantization}},
                    "direct": {"enabled": True, "host": "127.0.0.1", "port": port,
                               "public_url": f"http://127.0.0.1:{port}"},
                    "poll_interval_s": 0.05, "heartbeat_interval_s": DEPLOY_HB_S,
                    "load_control": {"max_concurrent_jobs": 8},
                }, f)

            class OwnFingerprint:
                """Two workers in one process share the machine's
                fingerprint: each registers with one of its own."""

                def __init__(self, *a, _fp=f"chip-smoke-deploy-{name}", **kw):
                    self._fp = _fp

                def get_or_create(self):
                    return self._fp

            with patched(wmain, "MachineFingerprint", OwnFingerprint):
                th, w = start_cli_worker(path)
            workers[name] = (th, w)
            rtt[name] = []
            beat = w._heartbeat_once

            def timed_beat(_beat=beat, _w=w, _out=rtt[name]):
                _beat()
                if _w._hb_rtt_ms is not None:
                    _out.append(_w._hb_rtt_ms)

            w._heartbeat_once = timed_beat
        (th_a, wa), (th_b, wb) = workers["A"], workers["B"]
        if wa.api.worker_id == wb.api.worker_id:
            raise AssertionError("both workers landed on one plane row")
        tok = wa.engines["llm"].tokenizer
        vocab = wa.engines["llm"].engine.model_cfg.vocab_size
        recs = {n: RecordedIds(w.engines["llm"]) for n, (_, w) in workers.items()}
        print(f"[deploy] workers A {wa.api.worker_id} and B {wb.api.worker_id} up through the "
              f"CLI ({model}, {quantization} weights, bf16 pools)", flush=True)

        # ---- one direct stream (first, while both workers have headroom for
        # discovery), then 8 queued chats beside one /jobs/sync chat
        params = {"max_new_tokens": DEPLOY_TOKENS, "temperature": 0.0, "ignore_eos": True}
        jids, out, errors = [], {}, []
        out["nearest"] = client._get_nearest_worker()
        out["stream"] = list(client.stream_chat(prompt=prompts[1] + " stream",
                                                timeout_s=600.0, **params))

        def sync_chat():
            try:
                out["sync"] = client.chat(prompt=prompts[0] + " sync", sync=True,
                                          timeout_s=600.0, **params)
            except BaseException as exc:  # noqa: BLE001 — raised below
                errors.append(exc)

        side = threading.Thread(target=sync_chat)
        side.start()
        for i, p in enumerate(prompts):
            jids.append(client.create_job("llm", {"prompt": p, "trace_id": f"deploy-{i}",
                                                  **params}))
        jobs = [client.wait_for_job(j, timeout_s=600.0, poll_s=0.05) for j in jids]
        side.join(timeout=600)
        if errors:
            raise errors[0]
        by_prompt = {}
        for r in recs.values():
            by_prompt.update(dict(r.ids))
        answers = [(p, j["result"]) for p, j in zip(prompts, jobs)] + [
            (prompts[0] + " sync", out["sync"])]
        for p, res in answers:
            ids = by_prompt.get(tuple(tok.encode(p)))
            usage = res.get("usage") or {}
            if ids is None or len(ids) != DEPLOY_TOKENS or not all(0 <= t < vocab for t in ids) \
                    or (usage.get("prompt_tokens"), usage.get("completion_tokens")) != \
                    (len(tok.encode(p)), DEPLOY_TOKENS) or res.get("text") != tok.decode(ids):
                raise AssertionError(f"[deploy] answer to {p[:24]!r}: ids {ids} result {res}")
        if any(j["status"] != "completed" for j in jobs):
            raise AssertionError(f"[deploy] queued jobs: {[j['status'] for j in jobs]}")
        chunks = out["stream"]
        s_ids = [t for ch in chunks[:-1] for t in ch.get("token_ids") or []]
        s_text = "".join(ch.get("text_delta") or "" for ch in chunks[:-1])
        if not chunks[-1].get("done") or len(s_ids) != DEPLOY_TOKENS \
                or not all(0 <= t < vocab for t in s_ids) or s_text != tok.decode(s_ids) \
                or chunks[-1].get("usage", {}).get("completion_tokens") != DEPLOY_TOKENS \
                or out["nearest"].get("direct_url") is None:
            raise AssertionError(f"[deploy] direct stream: {chunks[-1]} {out['nearest']}")
        served_by = sorted({j["worker_id"] for j in jobs})
        latency = [(j["completed_at"] - j["created_at"]) * 1e3 for j in jobs]
        # where a queued job's time went, by the flight recorder's phases
        phases = {}
        for j in jids:
            for k, v in (plane.get(f"/api/v1/debug/requests/{j}/timeline")[1]
                         .get("phases") or {}).items():
                phases.setdefault(k, []).append(v * 1e3)
        print(f"[deploy] 8 queued chats (create_job -> wait_for_job), one /jobs/sync chat and "
              f"one stream_chat(use_direct=True) through {out['nearest']['worker_id']}: "
              f"{DEPLOY_TOKENS} greedy tokens each, ids in vocabulary, text = decode(ids), usage "
              f"right; queued jobs served by {len(served_by)} worker(s); queue-to-completion "
              f"latency (information) p50 {pctl(latency, 0.5):.1f} ms p95 "
              f"{pctl(latency, 0.95):.1f} ms; by the plane's timelines, p50 ms of "
              + ", ".join(f"{k} {pctl(v, 0.5):.1f}" for k, v in sorted(phases.items()))
              + f" ({smi})", flush=True)

        # ---- worker loss: A killed mid-job, the plane's sweep requeues, B resumes
        hold = threading.Event()
        hold.set()
        real_poll, held_polls = wb._poll_once, []

        def held_poll():
            if hold.is_set():
                held_polls.append(1)
                return False
            return real_poll()

        wb._poll_once = held_poll
        # B's poll loop is sequential: once it calls the held poll twice,
        # no poll it began before the hold is still in flight
        if not wait_until(lambda: len(held_polls) >= 2, timeout=60):
            raise AssertionError("[deploy] worker B's poll loop did not pause")
        long_params = dict(params, max_new_tokens=DEPLOY_LONG_TOKENS, trace_id="deploy-long")
        # a prompt of its own: the chats above ran prompts[2] already
        long_prompt = prompts[2] + " long"
        jl = client.create_job("llm", {"prompt": long_prompt, **long_params})
        if not wait_until(lambda: len(((client.get_job(jl).get("checkpoint") or {})
                                       .get("generated") or [])) >= DEPLOY_CKPT_TOKENS,
                          timeout=300):
            raise AssertionError(f"[deploy] no heartbeat checkpoint of {DEPLOY_CKPT_TOKENS} "
                                 f"tokens: {client.get_job(jl)}")
        if client.get_job(jl)["worker_id"] != wa.api.worker_id:
            raise AssertionError("[deploy] the long job is not on worker A")
        hold.clear()
        t_kill = time.time()
        hard_kill(wa, th_a)
        ckpt = list(client.get_job(jl)["checkpoint"]["generated"])
        requeued = None
        while time.time() - t_kill < 120:
            j = client.get_job(jl)
            if j["worker_id"] != wa.api.worker_id:
                requeued = time.time()
                break
            time.sleep(0.02)
        if requeued is None:
            raise AssertionError("[deploy] the plane never requeued the dead worker's job")
        jlong = client.wait_for_job(jl, timeout_s=600.0, poll_s=0.05)
        resumed = [ids for p, ids in recs["B"].ids if p == tuple(tok.encode(long_prompt))]
        tl_status, tl = plane.get(f"/api/v1/debug/requests/{jl}/timeline")
        # a resumed admission logs ``batcher.resumed``; its prefill's last
        # chunk round samples the first new token
        rounds = [e["ts"] for e in (tl.get("events") or []) if tl_status == 200
                  and e.get("source") == wb.api.worker_id and e["ts"] > t_kill
                  and e.get("event") in ("batcher.chunk_round", "batcher.first_token")]
        first_tok = (max(rounds) - t_kill) if rounds else float("nan")
        k = len(ckpt)
        print(f"[deploy] worker loss: A hard-killed while its {k}-token heartbeat checkpoint "
              f"stood on the plane; the plane's sweep requeued the job {requeued - t_kill:.2f} s "
              f"after the kill (timeout {DEPLOY_HB_TIMEOUT_S} s); B completed it "
              f"({jlong['status']}, {jlong['result']['usage']['completion_tokens']} tokens), its "
              f"first {k} equal to the checkpoint's: {bool(resumed) and resumed[0][:k] == ckpt}; "
              f"kill -> first resumed token (information) {first_tok:.2f} s ({smi})", flush=True)
        if jlong["status"] != "completed" or jlong["worker_id"] != wb.api.worker_id \
                or len(resumed) != 1 or resumed[0][:k] != ckpt or k < DEPLOY_CKPT_TOKENS \
                or len(resumed[0]) != DEPLOY_LONG_TOKENS \
                or not all(0 <= t < vocab for t in resumed[0]) \
                or jlong["result"]["text"] != tok.decode(resumed[0]):
            raise AssertionError(f"[deploy] the requeued job did not resume on B: {jlong}")
        for r in recs.values():
            r.close()

        # ---- the store's rows: nothing lost, nothing run twice
        con = sqlite3.connect(f"file:{tmp.name}/plane.sqlite?mode=ro", uri=True, timeout=30)
        try:
            rows = con.execute("SELECT id, status, worker_id, assignment_epoch, retry_count "
                               "FROM jobs").fetchall()
            usage_rows = dict(con.execute(
                "SELECT job_id, COUNT(*) FROM usage_records GROUP BY job_id").fetchall())
        finally:
            con.close()
        bad = [r for r in rows if r[1] != "completed"
               or usage_rows.get(r[0]) != 1
               or r[3] != (2 if r[0] == jl else 1)]
        print(f"[deploy] the store: {len(rows)} jobs, every one completed with one usage "
              f"record; claims: the long job twice (A, then B), every other once: "
              f"{not bad}", flush=True)
        if bad or len(rows) != len(prompts) + 2:
            raise AssertionError(f"[deploy] store rows: {bad or rows}")

        # ---- the plane's records: timeline, queue_stats, /metrics
        _, t0 = plane.get(f"/api/v1/debug/requests/{jids[0]}/timeline")
        stats = client.queue_stats()
        _, metrics = plane.get("/metrics")
        n_jobs = len(prompts) + 2
        done_metric = metric_value(metrics, "inference_requests_total", job_type="llm",
                                   status="completed")
        # the plane counts a /jobs/sync submission at its completion only
        queued_metric = metric_value(metrics, "inference_requests_total", job_type="llm",
                                     status="queued")
        names = {e.get("event") for e in t0.get("events") or []}
        print(f"[deploy] the plane's records: job 0's timeline {len(t0.get('events') or [])} "
              f"events ({sorted(names)[:6]}...); queue_stats completed "
              f"{stats['jobs'].get('completed')}; /metrics inference_requests_total "
              f"queued {queued_metric:.0f} (the sync job is not) completed "
              f"{done_metric:.0f}", flush=True)
        if "server.submitted" not in names or "batcher.first_token" not in names \
                or stats["jobs"].get("completed") != n_jobs \
                or done_metric != n_jobs or queued_metric != n_jobs - 1:
            raise AssertionError(f"[deploy] the plane's records: {stats} {t0}")

        wb.request_shutdown()
        th_b.join(timeout=300)
        if th_b.is_alive():
            raise AssertionError("[deploy] worker B did not stop")
        torch.cuda.synchronize()
        counts = pa.launch_counts()
        beats = rtt["A"] + rtt["B"]
        print(f"[deploy] heartbeat round trip (information) p50 {pctl(beats, 0.5):.2f} ms p95 "
              f"{pctl(beats, 0.95):.2f} ms over {len(beats)} beats ({smi})", flush=True)
    finally:
        client.close()
        for th, w in workers.values():
            if th.is_alive():
                w.request_shutdown()
                th.join(timeout=120)
        plane.stop()
        tmp.cleanup()
    print(f"[deploy] kernel launches over the phase: {counts}; phase ran in "
          f"{time.perf_counter() - t_phase:.1f} s ({smi})", flush=True)
    check_counts("deploy", counts, qmm=quantization is not None)
    return counts


# ------------------------------------- the native index, seq x model meshes,
# migration under TP and the in-mesh stage pipeline

MESH_LAYERS = 8               # llama3-8b's depth in phase 26, cut (full width)
MESH_SEQ, MESH_MODEL = 2, 2   # (b): four ranks on cuda:0
MESH_LONG = 2048              # (b): the long prompt, through the ring prefill
MESH_WAVE = (40, 120, 300, 600)   # (b): the wave of four short prompts
MESH_TOKENS = 16              # greedy tokens of each (b) request
MESH_BUCKETS = (16, 32, 64, 128, 256, 512, 1024)   # so the long prompt takes the ring
MESH_MAX_LEN = 4096
MESH_BLOCKS = 512             # pool blocks of (b)'s engines (16 tokens each)
MIGRATE_PREFIX = 512          # (c): tokens of the migrated prefix
MIGRATE_TAIL = 16             # (c): fresh tokens after it in the pulled prompt
MIGRATE_TOKENS = 8            # (c): greedy tokens of each request
PIPE_MICRO, PIPE_MB, PIPE_S = 4, 2, 256   # (d): n_micro x mb x S
PIPE_STAGES = 2
PIPE_BLOCKS = 1 + PIPE_MICRO * PIPE_MB * (PIPE_S // BK + 1)
NATIVE_FUZZ_OPS = 4000        # (a): operations of the seeded parity fuzz
NATIVE_TIMED_REPS = 200       # (a): timed rounds of match and insert


class NativeIndexCheck:
    """Every prefix index the script's engines build is the C++ one:
    ``runtime/kv_cache.py`` ``make_radix_index`` wrapped so that a Python
    fallback fails the run; ``built`` counts the indexes built."""

    def __init__(self):
        from distributed_gpu_inference_torch.runtime import kv_cache

        self.built = 0
        real = kv_cache.make_radix_index

        def checked(block_size=16):
            idx = real(block_size)
            if not getattr(idx, "native", False):
                raise AssertionError(f"an engine's block manager holds {type(idx).__name__}, "
                                     "not the native radix index")
            self.built += 1
            return idx

        kv_cache.make_radix_index = checked


def host_name():
    """The host's CPU as ``/proc/cpuinfo`` names it (its architecture where
    it names none), and its core count."""
    import os
    import platform

    model = None
    try:
        with open("/proc/cpuinfo") as f:
            model = next((ln.split(":", 1)[1].strip() for ln in f
                          if ln.split(":")[0].strip() in ("model name", "Model")), None)
    except OSError:
        pass
    return f"{model or platform.machine() + ' CPU'}, {os.cpu_count()} cores"


def native_fuzz(seed, bs, n_ops):
    """The port's native index and its Python index through the same
    seeded operations → (operations, interior refusals); raises where they
    part."""
    import random

    from distributed_gpu_inference_torch.native.radix import NativeRadixPrefixIndex
    from distributed_gpu_inference_torch.runtime.kv_cache import RadixPrefixIndex

    rng = random.Random(seed)
    cc, py = NativeRadixPrefixIndex(bs), RadixPrefixIndex(bs)
    nxt, inserted, refused = 1, [], 0
    for step in range(n_ops):
        r = rng.random()
        toks = [rng.randrange(0, 6) for _ in range(rng.randrange(0, 8 * bs))]
        if r < 0.4:
            got = [cc.match_prefix(toks), py.match_prefix(toks)]
        elif r < 0.75:
            blocks = list(range(nxt, nxt + len(toks) // bs + rng.randrange(0, 2)))
            nxt += len(blocks)
            inserted += blocks
            got = [cc.insert(np.asarray(toks, np.int32), blocks), py.insert(toks, blocks)]
        elif inserted:
            bid = rng.choice(inserted)
            got = []
            for idx in (cc, py):
                try:
                    idx.remove_block(bid)
                    got.append(("removed", idx.contains_block(bid), idx.is_leaf(bid)))
                except ValueError:
                    got.append(("refused", idx.contains_block(bid), idx.is_leaf(bid)))
            refused += got[0][0] == "refused"
        else:
            continue
        if got[0] != got[1] or len(cc) != len(py):
            raise AssertionError(f"[mesh] (a) the native index parts from the Python one at "
                                 f"operation {step}: {got}, sizes {len(cc)} vs {len(py)}")
    return n_ops, refused


def native_times(prompts):
    """Match and insert on phase 7's prompts (one token a byte, block 16):
    µs a call, native and Python, on the host's clock."""
    from distributed_gpu_inference_torch.native.radix import NativeRadixPrefixIndex
    from distributed_gpu_inference_torch.runtime.kv_cache import RadixPrefixIndex

    ids = [list(p.encode()) for p in prompts]
    out = {}
    for name, make in (("native", NativeRadixPrefixIndex), ("python", RadixPrefixIndex)):
        ins = mat = 0.0
        for rep in range(NATIVE_TIMED_REPS):
            idx = make(BK)
            t0 = time.perf_counter()
            for i, p in enumerate(ids):
                idx.insert(np.asarray(p, np.int32), list(range(1 + 64 * i, 1 + 64 * i + 64)))
            t1 = time.perf_counter()
            for p in ids:
                idx.match_prefix(p)
            t2 = time.perf_counter()
            ins, mat = ins + t1 - t0, mat + t2 - t1
        calls = NATIVE_TIMED_REPS * len(ids)
        out[name] = (ins / calls * 1e6, mat / calls * 1e6)
    return out


def native_check(smi, prompts, check):
    """(a): the native index built from the checkout's source, held to the
    Python index on seeded operations, and timed on phase 7's prompts."""
    from distributed_gpu_inference_torch import native

    if not native.native_available():
        raise AssertionError("[mesh] (a) the native radix index did not build")
    lib = native.library_path()
    print(f"[mesh] (a) native radix index: {lib.relative_to(lib.parents[2])} built from "
          f"{native.SRC.relative_to(native.SRC.parents[3])} ({lib.stat().st_size} B); "
          f"{check.built} engine indexes built so far, every one native", flush=True)
    fuzz = [native_fuzz(seed, bs, NATIVE_FUZZ_OPS) for seed, bs in ((26, BK), (27, 4), (28, 1))]
    print(f"[mesh] (a) seeded parity fuzz against the Python index, block sizes 16 / 4 / 1: "
          f"{[n for n, _ in fuzz]} operations, interior evictions refused "
          f"{[r for _, r in fuzz]}, no difference", flush=True)
    if not all(r > 0 for _, r in fuzz):
        raise AssertionError("[mesh] (a) the fuzz never met an interior eviction")
    t = native_times(prompts)
    print(f"[mesh] (a) phase 7's 8 prompts (64-600 tokens, one a byte), host times on "
          f"{host_name()}: insert native {t['native'][0]:.2f} µs a call, Python "
          f"{t['python'][0]:.2f} µs; match native {t['native'][1]:.2f} µs, Python "
          f"{t['python'][1]:.2f} µs ({smi})", flush=True)


def mesh_engine(torch, cfg, device, plan=None, **over):
    """Phase 26's engines: ``cfg`` with int8 weights, seed 0, the prefix
    cache off unless ``over`` says otherwise, pools ``over`` gives (int8
    by default); ``plan`` a (seq, model) mesh with every rank on ``device``
    (cuda:0). → (the engine, its load seconds)."""
    from distributed_gpu_inference_torch.parallel.mesh import MeshPlan
    from distributed_gpu_inference_torch.runtime.engine import EngineConfig, TorchEngine

    base = dict(max_batch_size=len(MESH_WAVE), max_seq_len=MESH_MAX_LEN,
                num_blocks=MESH_BLOCKS, enable_prefix_cache=False, quantization="int8",
                kv_cache_dtype="int8", prefill_buckets=MESH_BUCKETS)
    dev = "cuda:0" if device == "cuda" else device
    n = plan[0] * plan[1] if plan else 1
    t0 = time.perf_counter()
    eng = TorchEngine(cfg, EngineConfig(**{**base, **over}), seed=0, device=device,
                      rank_devices=[dev] * n if n > 1 else None,
                      mesh=MeshPlan(seq=plan[0], model=plan[1]) if plan else None)
    sync(torch, device)
    return eng, time.perf_counter() - t0


def mesh_ids(vocab):
    """(b)'s prompts: the long one, then the wave."""
    rng = np.random.default_rng(26)
    return ([[int(t) for t in rng.integers(0, vocab, MESH_LONG)]]
            + [[int(t) for t in rng.integers(0, vocab, n)] for n in MESH_WAVE])


def mesh_serve(torch, tag, engine, ids, tags, trace, device):
    """The long prompt alone, then the wave, through ``generate`` under
    the trace (tag ``tag``): counters and collectives zeroed before, read
    after. → (responses, wall s, launches by rank, collectives by rank and
    axis, memory by rank)."""
    trace_on(trace, engine)
    mesh = engine._ranks is not None
    if mesh:
        engine.rank_collective_stats(reset=True)
    engine.reset_rank_launch_counts()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tags.tag = tag
    t0 = time.perf_counter()
    outs = [o for batch in (ids[:1], ids[1:]) for o in
            engine.generate(tp_requests(batch, MESH_TOKENS), use_multi_step=True)]
    sync(torch, device)
    wall = time.perf_counter() - t0
    tags.tag = None
    bad = [(o.error, len(o.token_ids)) for o in outs
           if o.error or len(o.token_ids) != MESH_TOKENS]
    if bad:
        raise AssertionError(f"[mesh] {tag}: requests failed: {bad}")
    coll = ({axis: engine.rank_collective_stats(axis=axis) for axis in (None, "model", "seq")}
            if mesh else {})
    return outs, wall, engine.rank_launch_counts(), coll, engine.rank_memory()


def mesh_report(tag, engine, res, one_pools, smi):
    outs, wall, counts, coll, mem = res
    n_sp = engine.stats.get("seq_parallel_prefills", 0)
    sp_ms = engine.stats.get("seq_parallel_prefill_s", 0.0) * 1e3 / max(n_sp, 1)
    n_tok = sum(len(o.token_ids) for o in outs)
    line = (f"[mesh] {tag}: the {MESH_LONG}-token prompt then a wave of {len(MESH_WAVE)}, "
            f"{MESH_TOKENS} greedy tokens each, in {wall:.2f} s ({n_tok / wall:.1f} tok/s); "
            f"seq-parallel prefills {n_sp} ({sp_ms:.1f} ms each); TTFT ms "
            f"{[round(o.ttft_ms, 1) for o in outs]}; peak memory by rank "
            f"{[gib(m.get('peak', 0)) for m in mem]}, pools by rank "
            f"{[gib(m['pool_bytes']) for m in mem]}")
    if one_pools:
        line += (f" = {[round(m['pool_bytes'] / one_pools, 4) for m in mem]} of seq 1 x "
                 f"model 1's {gib(one_pools)}")
    for axis, stats in coll.items():
        name = "every rank" if axis is None else f"the {axis} sub-groups"
        line += f"; collectives of {name} by rank (count, ms) {[coll_text(c) for c in stats]}"
    print(line + f"; launches by rank {counts} ({smi})", flush=True)


def mesh_serving(torch, smi, cfg, tags, trace, device):
    """(b): the one-device engine, then the seq 2 x model 2 engines, block-
    sharded and replicated, serving :func:`mesh_ids`. → launches summed
    over every rank."""
    ids = mesh_ids(cfg.vocab_size)
    total = {}
    one, t_one = mesh_engine(torch, cfg, device)
    try:
        print(f"[mesh] seq 1 x model 1 engine ({MESH_LAYERS} layers, int8 weights and pools) "
              f"loaded in {t_one:.1f} s", flush=True)
        res = mesh_serve(torch, "one", one, ids, tags, trace, device)
        one_pools = res[4][0]["pool_bytes"]
        mesh_report("seq 1 x model 1", one, res, None, smi)
    finally:
        release(torch, device, one)
        del one
    data_share = (1 / (MESH_SEQ * MESH_MODEL), 1 / MESH_SEQ)
    for tag, over in (("sharded", {"kv_seq_sharded": True}), ("replicated", {})):
        eng, t_load = mesh_engine(torch, cfg, device, (MESH_SEQ, MESH_MODEL), **over)
        try:
            st = eng.get_stats()["mesh"]
            print(f"[mesh] {tag}: seq {st['seq']} x model {st['model']} engine (ranks on "
                  f"{eng._ranks.spec.devices}, backend {st['backend']}) loaded in "
                  f"{t_load:.1f} s", flush=True)
            res = mesh_serve(torch, tag, eng, ids, tags, trace, device)
            mesh_report(f"seq 2 x model 2, {tag} pools", eng, res, one_pools, smi)
            if eng.stats.get("seq_parallel_prefills") != 1:
                raise AssertionError(f"[mesh] {tag}: the long prompt did not take the ring")
            counts = res[2]
            for c in counts:
                add_counts(total, c)
            if tag == "sharded":
                # every rank runs every forward: qmm; reads are the
                # partial-softmax ops, no kernel
                seq_counts_check(tag, counts, [{"qmm_w8a16"}] * 4)
                # data pools: heads / model and blocks / seq; scales blocks / seq
                whole = MESH_BLOCKS * MESH_LAYERS * BK
                shares = (eng.kv["k"].numel() / (whole * cfg.num_kv_heads * cfg.head_dim),
                          eng.kv["k_scale"].numel() / whole)
                print(f"[mesh] sharded: rank 0 holds {shares[0]:.4f} of each data pool and "
                      f"{shares[1]:.4f} of each scale pool", flush=True)
                if any(abs(a - b) > 1e-9 for a, b in zip(shares, data_share)):
                    raise AssertionError(f"[mesh] sharded: rank 0 holds {shares}")
            else:
                # seq row 0 serves as a tp 2 engine: int8 pools decode through
                # ragged; row 1 joins only the ring prefill (no kernel: its
                # rows are above qmm's row bound)
                seq_counts_check(tag, counts, [{"ragged_paged_attention", "qmm_w8a16"}] * 2
                                 + [set()] * 2)
        finally:
            release(torch, device, eng)
            del eng
    return total, ids


def migrate_pages_equal(torch, a, a_blocks, b, b_blocks):
    pa_, pb = a.gather_pages(a_blocks), b.gather_pages(b_blocks)
    return bool(torch.equal(raw(torch, pa_.pages), raw(torch, pb.pages)))


def prefix_export(kh, src, dst, prompt, key):
    """``src`` serves ``prompt`` (its radix then holds the prefix), then
    exports the prefix's frames to ``dst``'s receiver. → (blocks, bytes,
    ms of export + adopt, src blocks, dst blocks)."""
    src.generate(tp_requests([prompt], 1))
    t0 = time.perf_counter()
    frames, info = kh.export_prefix_frames(src, prompt, key)
    rx = kh.HandoffReceiver(dst)
    last = [rx.handle(f) for f in frames][-1]
    ms = (time.perf_counter() - t0) * 1e3
    if last.get("state") != "committed" or info["dev_blocks"] != MIGRATE_PREFIX // BK:
        raise AssertionError(f"[mesh] (c) the prefix did not migrate: {last}, {info}")
    n = MIGRATE_PREFIX // BK
    return (n, sum(len(f) for f in frames), ms, src.manager.radix.match_prefix(prompt)[:n],
            dst.manager.radix.match_prefix(prompt)[:n])


def mesh_migration(torch, smi, cfg, device):
    """(c), bf16 pools: a tp 2 engine's 512-token prefix to a one-device
    engine and another back, bitwise; the pulled prompt's TTFT against a
    recompute; ``migrate_kv_device`` between two tp 2 engines. → launches
    summed over every rank."""
    from distributed_gpu_inference_torch.runtime import kv_handoff as kh

    rng = np.random.default_rng(260)
    p_out, p_back = ([int(t) for t in rng.integers(0, cfg.vocab_size, MIGRATE_PREFIX)]
                     for _ in range(2))
    tail = [int(t) for t in rng.integers(0, cfg.vocab_size, MIGRATE_TAIL)]
    total = {}
    over = dict(kv_cache_dtype=None, enable_prefix_cache=True)
    tp_a = one = tp_b = None
    try:
        tp_a, t_a = mesh_engine(torch, cfg, device, (1, 2), **over)
        one, t_one = mesh_engine(torch, cfg, device, **over)
        print(f"[mesh] (c) tp 2 and one-device engines (bf16 pools) loaded in {t_a:.1f} s and "
              f"{t_one:.1f} s", flush=True)
        for eng in (tp_a, one):
            eng.reset_rank_launch_counts()
        n, nbytes, ms, a_blocks, o_blocks = prefix_export(kh, tp_a, one, p_out, "tp-out")
        out_eq = migrate_pages_equal(torch, tp_a, a_blocks, one, o_blocks)
        n2, nbytes2, ms2, o_blocks2, a_blocks2 = prefix_export(kh, one, tp_a, p_back, "tp-back")
        back_eq = migrate_pages_equal(torch, one, o_blocks2, tp_a, a_blocks2)
        print(f"[mesh] (c) prefix frames: tp 2 → one device {n} blocks, {nbytes} B in "
              f"{ms:.1f} ms (pages bitwise equal: {out_eq}); one device → tp 2 {n2} blocks, "
              f"{nbytes2} B in {ms2:.1f} ms (bitwise equal: {back_eq}) ({smi})", flush=True)
        if not (out_eq and back_eq):
            raise AssertionError("[mesh] (c) migrated pages are not bitwise equal")
        pulled = one.generate(tp_requests([p_out + tail], MIGRATE_TOKENS))[0]
        one.manager.clear_cached()
        recomputed = one.generate(tp_requests([p_out + tail], MIGRATE_TOKENS))[0]
        sync(torch, device)
        print(f"[mesh] (c) the pulled prompt ({MIGRATE_PREFIX} + {MIGRATE_TAIL} tokens): TTFT "
              f"{pulled.ttft_ms:.1f} ms with the {pulled.cached_tokens} migrated tokens cached, "
              f"{recomputed.ttft_ms:.1f} ms recomputed ({recomputed.cached_tokens} cached); "
              f"greedy ids equal: {list(pulled.token_ids) == list(recomputed.token_ids)} "
              f"(information) ({smi})", flush=True)
        if pulled.cached_tokens < MIGRATE_PREFIX:
            raise AssertionError(f"[mesh] (c) the pulled prompt found {pulled.cached_tokens} "
                                 "tokens cached")
        for c in tp_a.rank_launch_counts()[1:] + [launch_counts_now()]:
            add_counts(total, c)
        release(torch, device, one)
        one = None
        tp_b, t_b = mesh_engine(torch, cfg, device, (1, 2), **over)
        for eng in (tp_a, tp_b):
            eng.reset_rank_launch_counts()
            eng.rank_collective_stats(reset=True)
        prompt = p_back[:200]
        slot = tp_a.submit(tp_requests([prompt], 3 * MIGRATE_TOKENS)[0])
        tp_a.decode_multi(MIGRATE_TOKENS)
        blocks = list(tp_a.manager.seq_blocks[tp_a.slots[slot].seq_id])
        sync(torch, device)
        t0 = time.perf_counter()
        dslot = kh.migrate_kv_device(tp_a, tp_b, slot)
        sync(torch, device)
        mv_ms = (time.perf_counter() - t0) * 1e3
        moved = list(tp_b.manager.seq_blocks[tp_b.slots[dslot].seq_id])
        mv_eq = migrate_pages_equal(torch, tp_a, blocks, tp_b, moved)
        page_b = tp_a._page_layout()[1]
        cont = []
        for eng, s in ((tp_a, slot), (tp_b, dslot)):
            while eng.slots[s].finish_reason is None:
                eng.decode_multi()
            cont.append(list(eng.finish_slot(s).token_ids))
        print(f"[mesh] (c) migrate_kv_device between two tp 2 engines on cuda:0: {len(blocks)} "
              f"blocks ({len(blocks) * page_b} B of pages) through the donor ranks' gather "
              f"and the recipient ranks' push (pinned host staging, gloo) in {mv_ms:.1f} ms; "
              f"pages bitwise equal: {mv_eq}; the donor's and the recipient's greedy "
              f"continuations equal: {cont[0] == cont[1]} ({smi})", flush=True)
        if not (mv_eq and cont[0] == cont[1]):
            raise AssertionError("[mesh] (c) migrate_kv_device between tp 2 engines parted")
        for c in tp_a.rank_launch_counts()[1:] + tp_b.rank_launch_counts()[1:] \
                + [launch_counts_now()]:
            add_counts(total, c)
    finally:
        release(torch, device, tp_a, one, tp_b)
    return total


def launch_counts_now():
    from distributed_gpu_inference_torch.ops import paged_attention as pa

    return pa.launch_counts()


def _mesh_pipe_rank(group, model, layers, inputs, seed):
    """(d) on one stage rank: the whole seeded tree built on the card, this
    stage's cut kept (its own copy), then the prefill and the decode tick
    through ``pipelined_forward``. → (logits of both calls, this stage's
    pools as bits, launches, ms a tick of each call)."""
    import torch

    from distributed_gpu_inference_torch.models import llama
    from distributed_gpu_inference_torch.models.configs import get_model_config
    from distributed_gpu_inference_torch.ops import paged_attention as pa
    from distributed_gpu_inference_torch.parallel import pipeline
    from distributed_gpu_inference_torch.runtime.engine import EngineConfig, engine_params
    from distributed_gpu_inference_torch.runtime.tp import tensor_bits

    dev = group.device
    cfg = get_model_config(model, num_layers=layers)
    whole = engine_params(cfg, EngineConfig(quantization="int8"), None, seed, dev)
    n, s = group.size, group.rank

    def own(tree):
        return ({k: own(v) for k, v in tree.items()} if isinstance(tree, dict)
                else tree.clone())

    params = own(pipeline.shard_params_stages(whole, s, n))
    del whole
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
    kv = pipeline.shard_kv_stages(llama.init_kv_pools(cfg, PIPE_BLOCKS, BK, torch.bfloat16,
                                                      dev), s, n)
    kv = {k: v.clone() for k, v in kv.items()}
    pa.reset_launch_counts()
    logits, ms = [], []
    for toks, pos, tables, lens in inputs:
        args = [torch.tensor(a, device=dev) for a in (toks, pos, tables, lens)]
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, kv = pipeline.pipelined_forward(cfg, params, args[0], args[1], kv, args[2],
                                             args[3], group, block_size=BK)
        if cuda:
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3 / (toks.shape[0] + n - 1))
        logits.append(out.cpu().numpy() if s == 0 else None)
    return logits, {k: tensor_bits(v) for k, v in kv.items()}, pa.launch_counts(), ms


def pipe_inputs(vocab):
    """(d)'s prefill (n_micro x mb x S, row 1 of each microbatch 40 tokens
    short) and decode tick, with each row's own blocks."""
    rng = np.random.default_rng(261)
    m, b, s = PIPE_MICRO, PIPE_MB, PIPE_S
    toks = rng.integers(0, vocab, (m, b, s)).astype(np.int32)
    pos = np.tile(np.arange(s, dtype=np.int32), (m, b, 1))
    pos[:, 1, s - 40:] = -1
    lens = (pos >= 0).sum(-1).astype(np.int32)
    per = s // BK + 1
    tables = (1 + per * np.arange(m * b, dtype=np.int32)[:, None]
              + np.arange(per, dtype=np.int32)[None, :]).reshape(m, b, per)
    dec = (rng.integers(0, vocab, (m, b, 1)).astype(np.int32), lens[..., None].copy(),
           tables, lens + 1)
    return [(toks, pos, tables, lens), dec]


def mesh_pipeline(torch, smi, model, device):
    """(d): ``pipelined_forward`` on two stage ranks of cuda:0 against
    ``forward_chunk`` on one rank here, microbatch by microbatch: logits by
    the argmax and NEAR_TIE rules, and the pools. → launches of the stage
    ranks."""
    from distributed_gpu_inference_torch.models import llama
    from distributed_gpu_inference_torch.models.configs import get_model_config
    from distributed_gpu_inference_torch.runtime import tp as tp_ranks
    from distributed_gpu_inference_torch.runtime.engine import EngineConfig, engine_params

    dev = "cuda:0" if device == "cuda" else device
    cfg = get_model_config(model, num_layers=MESH_LAYERS)
    inputs = pipe_inputs(cfg.vocab_size)
    t0 = time.perf_counter()
    outs = tp_ranks.run_group(_mesh_pipe_rank, [dev] * PIPE_STAGES, model, MESH_LAYERS,
                              inputs, 0)
    t_ranks = time.perf_counter() - t0
    params = engine_params(cfg, EngineConfig(quantization="int8"), None, 0, torch.device(dev))
    kv = llama.init_kv_pools(cfg, PIPE_BLOCKS, BK, torch.bfloat16, dev)
    ref = []
    for toks, pos, tables, lens in inputs:
        step = []
        for i in range(PIPE_MICRO):
            out = llama.forward_chunk(cfg, params, *(torch.tensor(a[i], device=dev) for a in
                                                     (toks, pos)), kv,
                                      torch.tensor(tables[i], device=dev),
                                      torch.tensor(lens[i], device=dev), block_size=BK)
            step.append(out.logits[:, 0].float().cpu().numpy())
        ref.append(np.stack(step))
    worst, flips, exact = 0.0, [], True
    for call, (got, want) in enumerate(zip(outs[0][0], ref)):
        worst = max(worst, float(np.abs(got - want).max()))
        exact &= bool(np.array_equal(got, want))
        for i in range(PIPE_MICRO):
            for r in range(PIPE_MB):
                a, b = int(got[i, r].argmax()), int(want[i, r].argmax())
                if a != b:
                    flips.append((call, i, r, float(want[i, r, b] - want[i, r, a])))
    per = MESH_LAYERS // PIPE_STAGES
    pools_eq = all(np.array_equal(bits[k], tp_ranks.tensor_bits(kv[k][s * per:(s + 1) * per]))
                   for s, (_, bits, _, _) in enumerate(outs) for k in ("k", "v"))
    counts = {}
    for _, _, c, _ in outs:
        add_counts(counts, c)
    ms = outs[0][3]
    print(f"[mesh] (d) pipelined_forward, {PIPE_STAGES} stages of {per} layers on cuda:0 "
          f"(gloo), {PIPE_MICRO} x {PIPE_MB} x {PIPE_S} prefill then one decode tick: "
          f"{ms[0]:.1f} ms a prefill tick, {ms[1]:.1f} ms a decode tick "
          f"({PIPE_MICRO + PIPE_STAGES - 1} ticks each; the ranks ran in {t_ranks:.1f} s "
          f"with their start and weights); logits against forward_chunk on one rank: max abs "
          f"diff {worst:.3e}, bitwise equal {exact}, argmax flips {flips} (near-tie bound "
          f"{NEAR_TIE}); every stage's pools bitwise equal to its layers of the one-rank "
          f"pools: {pools_eq}; launches of the stage ranks {counts} ({smi})", flush=True)
    if any(d >= NEAR_TIE for *_, d in flips) or not pools_eq:
        raise AssertionError("[mesh] (d) the pipelined forward parts from forward_chunk")
    check_counts("mesh (d)", counts, qmm=True)
    del params, kv
    if device == "cuda":
        torch.cuda.empty_cache()
    return counts


def mesh_phase(torch, pa, smi, check, guard=None, model="llama3-8b", device="cuda"):
    """Phase 26 (see the module docstring). → (its launches summed over
    every rank by the pools they ran on, "int8" and "bf16"; its ``@mesh``
    kernel entries)."""
    from distributed_gpu_inference_torch.models import llama
    from distributed_gpu_inference_torch.models.configs import get_model_config
    from distributed_gpu_inference_torch.ops import qmm

    t_phase = time.perf_counter()
    _, _, prompts = serving_prompts()
    native_check(smi, prompts, check)
    cfg = get_model_config(model, num_layers=MESH_LAYERS)
    tags = Tag()
    trace = SampleTrace(torch, [], tags=tags)
    shapes = PathShapes()
    by_kind = {"int8": {}, "bf16": {}}
    try:
        with shapes.recording(llama, qmm):
            counts, ids = mesh_serving(torch, smi, cfg, tags, trace, device)
            add_counts(by_kind["int8"], counts)
            add_counts(by_kind["bf16"], mesh_migration(torch, smi, cfg, device))
    finally:
        trace.close()
    runs = trace.runs()
    check_aligned("mesh", runs, tags=("one", "sharded", "replicated"))
    for tag in ("sharded", "replicated"):
        check_sampled(f"mesh {tag}", traced_rows(runs, tag, ids), traced_rows(runs, "one", ids),
                      runs, "the one-device engine")
    add_counts(by_kind["bf16"], mesh_pipeline(torch, smi, model, device))
    total = {}
    for counts in by_kind.values():
        add_counts(total, counts)
    entries = []
    if device == "cuda":
        flush = torch.empty(128 << 20, dtype=torch.uint8, device=device)
        _, timed = seq_kernel_parity(torch, pa, shapes, flush, torch.device(device),
                                     tag="mesh", max_len=MESH_MAX_LEN)
        del flush
        for name, (times, err) in timed.items():
            base, kind = name.split("[")[0], name.split("[")[1].split("]")[0]
            launches = by_kind[kind].get(base, 0)
            if not launches:
                # a shape of an uncounted reference engine (the one-device
                # engine of (b)): its pool kind launched nothing counted
                print(f"[mesh] {name} timed but not listed: {kind} pools launched no "
                      f"{base} on the counted path", flush=True)
                continue
            source = ("ragged_paged_attention.cu" if base == "ragged_paged_attention"
                      else "paged_decode_fused.cu")
            line = ":932" if base == "ragged_paged_attention" else ":469"
            entries.append(entry(name, source, PALLAS + line, launches, err, times))
    check_counts("mesh", total, qmm=True)
    print(f"[mesh] phase 26 launches (every rank): {total} (int8 pools {by_kind['int8']}, "
          f"bf16 pools {by_kind['bf16']}); {check.built} engine indexes "
          f"built, every one native; the host's lowest available memory "
          f"{'not read' if guard is None else f'{guard.low:.1f} GiB'}; ran in "
          f"{time.perf_counter() - t_phase:.1f} s ({smi})", flush=True)
    return by_kind, entries


HOST_FLOOR_GIB = 14.0       # the host memory a run leaves free, or it stops itself
# phases whose inputs are their own, which ``--phase`` runs alone
ALONE = (13, 16, 17, 18, 19, 21, 22, 23, 24, 25, 26, 27, 28, 29)


class HostGuard:
    """A daemon thread that reads the host's available memory four times a
    second: below HOST_FLOOR_GIB it kills this run's child processes and
    exits the script with code 3, so a run that would exhaust the host
    fails alone. ``low`` is the lowest reading (GiB)."""

    def __init__(self):
        self.low = float("inf")
        threading.Thread(target=self._watch, daemon=True).start()

    @staticmethod
    def available_gib():
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) / 2**20
        return float("inf")

    def _watch(self):
        import multiprocessing
        import os

        while True:
            self.low = min(self.low, self.available_gib())
            if self.low < HOST_FLOOR_GIB:
                print(f"[host] available memory {self.low:.1f} GiB < {HOST_FLOOR_GIB}: "
                      "stopping the run", flush=True)
                for child in multiprocessing.active_children():
                    child.kill()
                os._exit(3)
            time.sleep(0.25)


# ------------------------------------------------------ images without Pillow

FIXTURE_DIR = "tests/fixtures/images"
PHOTO_TOKENS = 8              # greedy tokens of each photo request
PHOTO_REPEATS = 3             # host-timed decodes and resizes of each fixture


def host_cpu_name():
    """``lscpu``'s "Model name"; where lscpu says nothing or "unknown",
    ``/proc/cpuinfo``'s "model name" (and the vendor id) beside it."""
    name = "unknown"
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
        name = next((line.split(":", 1)[1].strip() for line in out.splitlines()
                     if line.startswith("Model name:")), name)
    except (OSError, subprocess.SubprocessError):
        pass
    if name.lower() not in ("", "unknown", "-"):
        return name
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                info.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    return (f"lscpu: {name}; /proc/cpuinfo: {info.get('model name', 'unknown')} "
            f"({info.get('vendor_id', 'vendor unknown')}, family {info.get('cpu family', '?')} "
            f"model {info.get('model', '?')})")


@contextlib.contextmanager
def stage_clock(torch, vis, ms):
    """Inside the block, the vision request's stages (image decode, resize,
    ViT, decoder prefill with the ViT in it, decode steps) each add their
    ms to ``ms``, timed to their end on the card (a synchronize after
    each); the engine and the modules are as they were outside it."""
    from distributed_gpu_inference_torch.models import vit
    from distributed_gpu_inference_torch.utils import jpeg, png, resize

    def timed(stage, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            ms[stage] = ms.get(stage, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return run

    seams = [(jpeg, "decode_jpeg", "decode"), (png, "decode_png", "decode"),
             (resize, "resize_bicubic", "resize"), (vit, "encode_image", "vit"),
             (vis, "prefill", "prefill"), (vis, "decode", "steps")]
    missing = object()
    saved = [(obj, name, vars(obj).get(name, missing)) for obj, name, _ in seams]
    for obj, name, stage in seams:
        setattr(obj, name, timed(stage, getattr(obj, name)))
    try:
        yield ms
    finally:
        for obj, name, fn in saved:
            if fn is missing:
                delattr(obj, name)
            else:
                setattr(obj, name, fn)


def photo_phase(torch, pa, smi, vit_model="small-vit", llm_model="llama3-1b", device="cuda"):
    """Phase 27 (see the module docstring). → the launches of its requests."""
    import base64
    import hashlib
    import os

    from distributed_gpu_inference_torch import native
    from distributed_gpu_inference_torch.utils.jpeg import decode_jpeg, decode_jpeg_plain, is_jpeg
    from distributed_gpu_inference_torch.utils.png import decode_png, decode_png_plain
    from distributed_gpu_inference_torch.utils.resize import resize_bicubic, resize_bicubic_plain
    from distributed_gpu_inference_torch.worker.engines.vision import VisionEngine, _decode_image

    tag = "photo"
    t_phase = time.perf_counter()
    cpu = host_cpu_name()
    if not native.native_available(native.IMAGE_SRC):
        raise AssertionError(f"[{tag}] the native image codec did not build")
    native.PLAIN_TAKEN.clear()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), FIXTURE_DIR)
    with open(os.path.join(root, "manifest.json")) as f:
        manifest = json.load(f)
    side = manifest["resize"]

    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    files, host = {}, {}
    for e in manifest["images"]:
        with open(os.path.join(root, e["file"]), "rb") as f:
            data = f.read()
        if hashlib.sha256(data).hexdigest() != e["file_sha256"]:
            raise AssertionError(f"[{tag}] {e['file']} is not the committed fixture")
        dec = decode_jpeg if is_jpeg(data) else decode_png
        d_ms, r_ms = [], []
        for _ in range(PHOTO_REPEATS):
            t0 = time.perf_counter()
            rgb = dec(data)
            t1 = time.perf_counter()
            small = resize_bicubic(rgb, (side, side))
            d_ms.append((t1 - t0) * 1e3)
            r_ms.append((time.perf_counter() - t1) * 1e3)
        same = sha(rgb) == e["decoded_sha256"] and sha(small) == e[f"resized_{side}_sha256"]
        mp = e["width"] * e["height"] / 1e6
        host[e["file"]] = (pctl(d_ms, 0.5), mp / pctl(d_ms, 0.5) * 1e3, pctl(r_ms, 0.5))
        print(f"[{tag}] {e['file']} ({e['width']}x{e['height']}, {e['bytes']} B): native "
              f"decode and {side}x{side} resize equal to Pillow {manifest['pillow']}'s by "
              f"SHA-256: {same}; decode {host[e['file']][0]:.2f} ms = {host[e['file']][1]:.1f} "
              f"MP/s, resize {host[e['file']][2]:.2f} ms (median of {PHOTO_REPEATS}; host "
              f"CPU {cpu})", flush=True)
        if not same or rgb.shape != (e["height"], e["width"], 3):
            raise AssertionError(f"[{tag}] {e['file']}: decode or resize differs from Pillow's")
        files[e["file"]] = (data, rgb)
    smallest = sorted(files, key=lambda n: files[n][1].size)[:2]
    for name in smallest:
        data, rgb = files[name]
        plain = decode_jpeg_plain(data) if is_jpeg(data) else decode_png_plain(data)
        agree = np.array_equal(plain, rgb) and np.array_equal(
            resize_bicubic_plain(rgb, (side, side)), resize_bicubic(rgb, (side, side)))
        print(f"[{tag}] {name}: native and plain decode and resize bit-identical: {agree}",
              flush=True)
        if not agree:
            raise AssertionError(f"[{tag}] {name}: native and plain versions disagree")

    t0 = time.perf_counter()
    vis = VisionEngine({"model": llm_model, "vit_model": vit_model, "device": device,
                        "max_new_tokens": PHOTO_TOKENS, "seed": 0})
    vis.load_model()
    size = vis._vit_cfg.image_size
    print(f"[{tag}] {vit_model} + {llm_model} (decoder {vis._dtype}) loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    try:
        reqs = {name: {"task": "image_qa", "question": "what is in the photo?",
                       "image": base64.b64encode(data).decode("ascii")}
                for name, (data, _) in files.items()}
        vis.inference(dict(reqs[smallest[0]]))        # warm-up: cuBLAS, the kernels' loads
        torch.cuda.synchronize()
        rec = IdRecorder(vis._tokenizer)
        native.PLAIN_TAKEN.clear()
        pa.reset_launch_counts()
        request_ms = {}
        for name, req in reqs.items():
            t0 = time.perf_counter()
            out = vis.inference(dict(req))
            torch.cuda.synchronize()
            request_ms[name] = ((time.perf_counter() - t0) * 1e3,
                                out["usage"]["completion_tokens"])
        launches = pa.launch_counts()
        rec.close()
        plain_taken = dict(native.PLAIN_TAKEN)
        vocab = vis._llm_cfg.vocab_size
        ok_ids = len(rec.ids) == len(reqs) and all(0 <= t < vocab for ids in rec.ids
                                                   for t in ids)
        for name, req in reqs.items():
            with stage_clock(torch, vis, {}) as t:
                t0 = time.perf_counter()
                vis.inference(dict(req))
                clocked = (time.perf_counter() - t0) * 1e3
            ms, n_tok = request_ms[name]
            print(f"[{tag}] request {name}: {ms:.1f} ms; timed by stage, {clocked:.1f} ms = "
                  f"decode {t['decode']:.1f} + resize {t.get('resize', 0.0):.1f} (host CPU "
                  f"{cpu}) + ViT {t['vit']:.1f} + prefill {t['prefill'] - t['vit']:.1f} + "
                  f"{n_tok} decode steps {t.get('steps', 0.0):.1f} ms ({smi})", flush=True)
        big = max(files, key=lambda n: files[n][1].size)
        image = _decode_image(reqs[big], size)
        toks = vis._tokenizer.encode("Answer the question about the image: what is in the photo?")
        with torch.no_grad():
            k_logits = vis.prefill(image, toks).float()
            with plain_kernels():
                p_logits = vis.prefill(image, toks).float()
        rel = float(((k_logits - p_logits).norm() / p_logits.norm()).item())
        print(f"[{tag}] {len(reqs)} photo requests: launches {launches}; plain host versions "
              f"taken {plain_taken or 'none'}; ids in vocabulary {ok_ids}; prefill logits on "
              f"{big}'s prefix, kernels vs plain: rel L2 {rel:.3e} (bound {LOGITS_REL_BOUND}), "
              f"argmax equal {bool(k_logits.argmax() == p_logits.argmax())}", flush=True)
        if not (launches["ragged_paged_attention"] > 0
                and launches["paged_decode_attention_fused"] > 0):
            raise AssertionError(f"[{tag}] a kernel of the path never launched: {launches}")
        if plain_taken:
            raise AssertionError(f"[{tag}] a plain host version was taken: {plain_taken}")
        if not (ok_ids and rel <= LOGITS_REL_BOUND and bool(torch.isfinite(k_logits).all())):
            raise AssertionError(f"[{tag}] bad answer ids or logits: {rec.ids}, {rel}")
    finally:
        vis.unload()
        torch.cuda.empty_cache()
    print(f"[{tag}] phase 27 ran in {time.perf_counter() - t_phase:.1f} s ({smi})", flush=True)
    return launches


# ---------------------------------------------------------------- phase 28: the gRPC stage plane

GRPC_CHUNK = 7              # prefill tokens a chunk
GRPC_LIMIT_MAX = 16         # (a)'s receive-limit probe: chunks of GRPC_CHUNK + 1 up to this
GRPC_TOKENS = 32            # greedy tokens a session
GRPC_LAYERS = PIPE_LAYERS   # (a)'s depth, cut (full width): at 32 the whole script
                            # took 1,175.5 s of its 1,200 on a slow host
GRPC_BLOCKS = 64            # blocks of each stage's pools
GRPC_PIECE_BLOCKS = 3       # (b): 4 int8 blocks of 32 layers (4 MiB of codes) pass 4 MiB
GRPC_HOP_TIMEOUT_S = 120.0  # each client's timeout a call
GRPC_ROUTES = ("StreamForward", "Forward", "HTTP")


class StageClock:
    """While installed on stages: each forward's in-process seconds, by
    stage, in the order the forwards ran (``take`` empties them)."""

    def __init__(self, stages):
        self.s = [[] for _ in stages]
        for i, st in enumerate(stages):
            real = st.forward

            def fwd(*a, _real=real, _i=i, **k):
                t0 = time.perf_counter()
                out = _real(*a, **k)
                self.s[_i].append(time.perf_counter() - t0)
                return out

            st.forward = fwd

    def take(self):
        out, self.s = self.s, [[] for _ in self.s]
        return out


def chunked_greedy(hop, prompt, sid, n_tokens=GRPC_TOKENS, chunk=GRPC_CHUNK):
    """``prompt`` in chunks of ``chunk`` tokens, then greedy decode steps,
    each through ``hop(stage, sid, x, positions, kv_len_after)`` for the two
    stages in turn → (tokens, [(seconds, [each hop's seconds], digest of
    the step's logits, logits[0, -1])] a step)."""
    import hashlib

    import torch

    steps = []

    def step(ids, start):
        x = np.asarray([ids], np.int32)
        pos = np.asarray([list(range(start, start + len(ids)))], np.int32)
        t0, hops = time.perf_counter(), []
        for i in range(2):
            t1 = time.perf_counter()
            out = hop(i, sid, x, pos, start + len(ids))
            hops.append(time.perf_counter() - t1)
            x = out["hidden"]
        logits = out["logits"]
        steps.append((time.perf_counter() - t0, hops,
                      hashlib.sha256(logits.contiguous().numpy().tobytes()).hexdigest(),
                      logits[0, -1].clone()))
        return int(torch.argmax(logits[0, -1]))

    for c in range(0, len(prompt), chunk):
        tok = step(prompt[c:c + chunk], c)
    toks, n = [tok], len(prompt)
    while len(toks) < n_tokens:
        toks.append(step([toks[-1]], n))
        n += 1
    return toks, steps


def one_device_greedy(torch, cfg, params, prompt, dev, n_tokens=GRPC_TOKENS, chunk=GRPC_CHUNK):
    """The same chunks and steps through ``forward_chunk`` on one device →
    (tokens, [logits[0, -1] a step])."""
    from distributed_gpu_inference_torch.models import llama

    kv = llama.init_kv_pools(cfg, GRPC_BLOCKS, BK, torch.bfloat16, dev)
    table = torch.arange(1, 1 + PIPE_SEQ // BK, dtype=torch.int32, device=dev)[None]
    rows = []

    def step(ids, start):
        out = llama.forward_chunk(
            cfg, params, torch.tensor([ids], dtype=torch.int32, device=dev),
            torch.arange(start, start + len(ids), dtype=torch.int32, device=dev)[None], kv,
            table, torch.tensor([start + len(ids)], dtype=torch.int32, device=dev),
            block_size=BK)
        rows.append(out.logits[0, -1].float().cpu())
        return int(torch.argmax(rows[-1]))

    for c in range(0, len(prompt), chunk):
        tok = step(prompt[c:c + chunk], c)
    toks, n = [tok], len(prompt)
    while len(toks) < n_tokens:
        toks.append(step([toks[-1]], n))
        n += 1
    del kv
    return toks, rows


def grpc_hop_bytes(torch, hid, out, compress=True):
    """Message bytes of a decode step's hops (each with its 5-byte gRPC
    prefix; HTTP: the ``comm/wire.py`` bodies), ``hid`` the first stage's
    hidden state and ``out`` the last stage's answer, TPUT frames
    zstd-compressed as both planes write them (or not) → {route: [(out,
    back) a stage]}."""
    from distributed_gpu_inference_torch.comm import pb
    from distributed_gpu_inference_torch.comm.wire import pack_message
    from distributed_gpu_inference_torch.utils.serialization import serialize

    def msg(t):
        return {"frame": serialize(t, compress=compress)}

    tok = torch.zeros((1, 1), dtype=torch.int32)
    sid, kv = "0123456789abcdef0123456789abcdef", 200
    outs = [{"hidden": hid}, out]
    grpc_b = [(5 + len(pb.encode(pb.FORWARD_REQUEST, {
        "session_id": sid, "kv_len_after": kv, "x": msg(x), "positions": msg(tok)})),
        5 + len(pb.encode(pb.FORWARD_RESPONSE, {"session_id": sid, **{
            k: msg(v) for k, v in o.items()}})))
        for x, o in zip((tok, hid), outs)]
    http_b = [(len(pack_message({"session_id": sid, "kv_len_after": kv},
                                {"x": x, "positions": tok}, compress=compress)),
               len(pack_message({"session_id": sid}, o, compress=compress)))
              for x, o in zip((tok, hid), outs)]
    return {"StreamForward": grpc_b, "Forward": grpc_b, "HTTP": http_b}


def grpc_pipeline(torch, pa, smi, model, device, layers):
    """Phase 28 (a) and (c)'s pipeline numbers → the StreamForward route's
    launches."""
    import gc

    from distributed_gpu_inference_torch.comm.data_plane import DataPlaneServer
    from distributed_gpu_inference_torch.comm import grpc_plane as gp
    from distributed_gpu_inference_torch.comm.grpc_plane import (
        GrpcDataPlane,
        GrpcStageClient,
        RpcError,
        StatusCode,
    )
    from distributed_gpu_inference_torch.comm.session import WorkerSession
    from distributed_gpu_inference_torch.comm.stage_worker import PipelineStageWorker
    from distributed_gpu_inference_torch.models.configs import get_model_config
    from distributed_gpu_inference_torch.parallel.pipeline import (
        slice_stage_params,
        uniform_stages,
    )
    from distributed_gpu_inference_torch.runtime.engine import EngineConfig, engine_params
    from distributed_gpu_inference_torch.utils.data_structures import BlockRange

    cfg = get_model_config(model) if layers is None else get_model_config(
        model, num_layers=layers)
    dev = torch.device(device)
    t0 = time.perf_counter()
    params = engine_params(cfg, EngineConfig(quantization="int8"), None, 0, dev)
    plan = uniform_stages(cfg.num_layers, 2)
    stages = [PipelineStageWorker(cfg, r, params=slice_stage_params(
        params, *r, num_layers=cfg.num_layers), num_blocks=GRPC_BLOCKS,
        max_blocks_per_seq=PIPE_SEQ // BK, dtype="bfloat16", device=device) for r in plan]
    clock = StageClock(stages)
    grpcs = [GrpcDataPlane(st, host="127.0.0.1", port=0) for st in stages]
    https = [DataPlaneServer(stage=st) for st in stages]
    for p in grpcs + https:
        p.start()
    clients = [GrpcStageClient(f"127.0.0.1:{g.port}", timeout_s=GRPC_HOP_TIMEOUT_S)
               for g in grpcs]
    sessions = [WorkerSession(h.url, BlockRange(*r), timeout_s=GRPC_HOP_TIMEOUT_S)
                for h, r in zip(https, plan)]
    health = [c.health() for c in clients]
    print(f"[grpc] (a) {model} ({cfg.num_layers} layers, int8 weights, seed 0, bf16 pools) "
          f"in stages {plan} built in {time.perf_counter() - t0:.2f} s, each behind a "
          f"GrpcDataPlane (ports {[g.port for g in grpcs]}) and a DataPlaneServer; HealthCheck "
          f"answers layer_start / layer_end {[(h['layer_start'], h['layer_end']) for h in health]}"
          f" (the stage answers layer_range: 0, as the JAX plane answers; ROADMAP §3 item 4), "
          f"is_first / is_last {[(h['is_first'], h['is_last']) for h in health]}", flush=True)
    if [(h["is_first"], h["is_last"]) for h in health] != [(True, False), (False, True)]:
        raise AssertionError(f"[grpc] (a) the stages' health is wrong: {health}")
    prompts = pipeline_prompts(cfg.vocab_size)
    runs = {route: [] for route in GRPC_ROUTES}
    inside = {route: [] for route in GRPC_ROUTES}
    counts = None
    try:
        for route in GRPC_ROUTES:
            if route == "StreamForward":
                torch.cuda.synchronize()
                pa.reset_launch_counts()
            clock.take()
            for r, ids in enumerate(prompts):
                sid = f"grpc-{route}-{r}"
                if route == "HTTP":
                    for ws in sessions:
                        ws.create(sid)
                    runs[route].append(chunked_greedy(
                        lambda i, *a: sessions[i].forward(*a), ids, sid))
                    for ws in sessions:
                        ws.close(sid)
                    continue
                for c in clients:
                    c.create_session(sid)
                if route == "Forward":
                    runs[route].append(chunked_greedy(
                        lambda i, *a: clients[i].forward(*a), ids, sid))
                else:
                    streams = [c.open_stream() for c in clients]
                    try:
                        runs[route].append(chunked_greedy(
                            lambda i, *a: streams[i].step(*a), ids, sid))
                    finally:
                        for s in streams:
                            s.close()
                for c in clients:
                    c.close_session(sid)
            inside[route] = clock.take()
            if route == "StreamForward":
                torch.cuda.synchronize()
                counts = pa.launch_counts()
        # the receive limit: prefill chunks of GRPC_CHUNK + 1 tokens and up
        # until the last stage's reply, zstd-compressed as the JAX plane
        # compresses it, passes grpcio's 4 MiB no more; then one decode step
        # after the last chunk that passed, whose tensors (d) and phase 29
        # measure
        limit, passed = None, {}
        for n in range(GRPC_CHUNK + 1, GRPC_LIMIT_MAX + 1):
            sid = f"grpc-limit-{n}"
            for c in clients:
                c.create_session(sid)
            x, pos = (np.asarray([prompts[0][:n]], np.int32),
                      np.arange(n, dtype=np.int32)[None])
            hidden = clients[0].forward(sid, x, pos, n)["hidden"]
            try:
                out = clients[1].forward(sid, hidden, pos, n)
                passed[n] = out
                tok = np.asarray([[int(torch.argmax(out["logits"][0, -1]))]], np.int32)
                step_hid = clients[0].forward(sid, tok, np.asarray([[n]], np.int32), n + 1)[
                    "hidden"]
                step_out = clients[1].forward(sid, step_hid, np.asarray([[n]], np.int32), n + 1)
            except RpcError as exc:
                limit = (n, exc.code(), exc.details())
            for c in clients:
                c.close_session(sid)
            if limit is not None:
                break
        ref = [one_device_greedy(torch, cfg, params, ids, dev) for ids in prompts]
    finally:
        for c in clients:
            c.close()
        for p in grpcs:
            p.stop(0)
        for p in https:
            p.stop()
    refused_bytes = None
    if limit is not None:
        m = re.match(r"CLIENT: Received message larger than max \((\d+) vs\. (\d+)\)$",
                     limit[2])
        refused_bytes = int(m.group(1)) if m and int(m.group(2)) == gp.MAX_MESSAGE_BYTES \
            else None
    last = max(passed) if passed else None
    sizes = {n: (grpc_hop_bytes(torch, o["hidden"], o)["Forward"][1][1],
                 grpc_hop_bytes(torch, o["hidden"], o, compress=False)["Forward"][1][1])
             for n, o in passed.items()}
    limit_ok = (limit is not None and limit[1] == StatusCode.RESOURCE_EXHAUSTED
                and refused_bytes is not None and refused_bytes > gp.MAX_MESSAGE_BYTES
                and last == limit[0] - 1
                and all(z <= gp.MAX_MESSAGE_BYTES for z, _ in sizes.values())
                and sizes[last][1] > gp.MAX_MESSAGE_BYTES)
    print(f"[grpc] (a) the receive limit ({gp.MAX_MESSAGE_BYTES} B, grpcio's default, in the "
          f"JAX plane too) on zstd-compressed replies: prefill chunks of "
          f"{', '.join(f'{n} tokens passed at {z} B ({r} B uncompressed)' for n, (z, r) in sizes.items())}"
          f"; {limit[0] if limit else None} tokens refused at the client with "
          f"{limit[1].name if limit else None}: {limit and limit[2]!r}", flush=True)
    if not limit_ok:
        raise AssertionError(f"[grpc] (a) the receive limit is not where compression puts it: "
                             f"{limit}, {sizes}")
    HOP_TENSORS.update(hidden=step_hid, out=step_out, chunk=passed[last], chunk_tokens=last)
    # ---- (a) checks: the routes bitwise, the one-device run within a near-tie
    base = runs["StreamForward"]
    same = {route: all(t == bt and [s[2] for s in st] == [s[2] for s in bs]
                       for (t, st), (bt, bs) in zip(runs[route], base))
            for route in GRPC_ROUTES[1:]}
    n_steps = sum(len(st) for _, st in base)
    worst, parts = 0.0, []
    for r, ((ptoks, steps), (etoks, erows), ids) in enumerate(zip(base, ref, prompts)):
        d = next((k for k, (a, b) in enumerate(zip(ptoks, etoks)) if a != b), None)
        if d is None:
            continue
        first = -(-len(ids) // GRPC_CHUNK) - 1      # the step that gave token 0
        p_short, p_top = row_deficit(steps[first + d][3], etoks[d])
        e_short, e_top = row_deficit(erows[first + d], ptoks[d])
        worst = max(worst, min(p_short, e_short))
        parts.append(f"prompt {r} token {d}: gRPC {ptoks[d]} vs one device {etoks[d]}; gRPC "
                     f"top-2 {p_top}, the other token {p_short:.4f} below; one device top-2 "
                     f"{e_top}, the other token {e_short:.4f} below")
    prefill_err = max(float((st[-(GRPC_TOKENS)][3] - er[-(GRPC_TOKENS)]).abs().max())
                      for (_, st), (_, er) in zip(base, ref))
    print(f"[grpc] (a) {len(prompts)} prompts of {list(PIPE_LENGTHS)} tokens in chunks of "
          f"{GRPC_CHUNK}, {GRPC_TOKENS} greedy tokens each ({n_steps} steps a route): every "
          f"step's logits bitwise equal to StreamForward's over unary Forward: "
          f"{same['Forward']}, over HTTP: {same['HTTP']}; against forward_chunk on one device "
          f"on the same tree and chunks: {len(prompts) - len(parts)} streams identical; where "
          f"one parts: {'; '.join(parts) or 'nowhere'} (near-tie bound {NEAR_TIE}); the last "
          f"prefill step's logits max abs diff {prefill_err:.3e}; kernel launches of the "
          f"StreamForward route: {counts}", flush=True)
    if not all(same.values()):
        raise AssertionError(f"[grpc] (a) the routes' logits differ: {same}")
    if worst >= NEAR_TIE:
        raise AssertionError("[grpc] (a) a stream parts from the one-device run beyond a "
                             "near-tie")
    check_counts("grpc (a)", counts, qmm=True)

    # ---- (c) numbers (information)
    nbytes = grpc_hop_bytes(torch, step_hid, step_out)
    raw_bytes = grpc_hop_bytes(torch, step_hid, step_out, compress=False)
    for route in ("StreamForward", "HTTP"):
        HOP_BYTES[f"phase 28 {route}"] = list(zip(nbytes[route], raw_bytes[route]))
    lines = []
    for route in GRPC_ROUTES:
        dec = [(s[0], s[1]) for toks, st in runs[route] for s in st[-(GRPC_TOKENS - 1):]]
        fwd = [[], []]
        for h in range(2):
            k = 0
            for _, st in runs[route]:
                k += len(st) - (GRPC_TOKENS - 1)      # the prefill steps
                fwd[h] += inside[route][h][k:k + GRPC_TOKENS - 1]
                k += GRPC_TOKENS - 1
        hops = []
        for h in range(2):
            tot = [hs[h] * 1e3 for _, hs in dec]
            ins = [x * 1e3 for x in fwd[h]]
            rest = [a - b for a, b in zip(tot, ins)]
            hops.append(f"hop {h} {pctl(tot, 0.5):.2f} / {pctl(tot, 0.95):.2f} ms = stage "
                        f"{pctl(ins, 0.5):.2f} / {pctl(ins, 0.95):.2f} + framing and "
                        f"transport {pctl(rest, 0.5):.2f} / {pctl(rest, 0.95):.2f}, "
                        f"{nbytes[route][h][0]} B out, {nbytes[route][h][1]} B back "
                        f"({raw_bytes[route][h][0]} / {raw_bytes[route][h][1]} B "
                        f"uncompressed)")
        lines.append(f"{route}: {len(dec) / sum(t for t, _ in dec):.2f} tok/s; "
                     + "; ".join(hops))
    print(f"[grpc] (c) decode of one session over two stages on loopback (p50 / p95 of the "
          f"{len(prompts) * (GRPC_TOKENS - 1)} decode steps; message bytes a decode step): "
          + " | ".join(lines) + f" ({smi})", flush=True)
    del stages, grpcs, https, clients, sessions, params, clock, runs, ref
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def grpc_handoff(torch, pa, smi, model, device):
    """Phase 28 (b) → its launches."""
    from distributed_gpu_inference_torch.comm.data_plane import DataPlaneServer, post_bytes
    from distributed_gpu_inference_torch.comm.grpc_plane import (
        GrpcDataPlane,
        GrpcStageClient,
        RpcError,
        StatusCode,
    )
    from distributed_gpu_inference_torch.runtime import kv_handoff as kh
    from distributed_gpu_inference_torch.utils import serialization
    from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine

    text = serving_prompts()[2][-1]
    t0 = time.perf_counter()
    a = TorchLLMEngine(pd_engine_config(model, "int8", "int8", device))
    b = TorchLLMEngine(pd_engine_config(model, "int8", "int8", device))
    a.load_model()
    b.load_model()
    frames = []

    def record(raw):
        frames.append(raw)
        return {"recorded": len(raw)}

    recorder = DataPlaneServer(kv_receiver=record)
    g = GrpcDataPlane(None, host="127.0.0.1", port=0, kv_receiver=b.kv_receiver)
    h = DataPlaneServer(kv_receiver=b.kv_receiver)
    for p in (recorder, g, h):
        p.start()
    cli = GrpcStageClient(f"127.0.0.1:{g.port}", timeout_s=GRPC_HOP_TIMEOUT_S)
    try:
        print(f"[grpc] (b) A and B ({model}, int8 weights and int8 pools, seed 0) loaded in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        torch.cuda.synchronize()
        pa.reset_launch_counts()
        key = "grpc-pd"
        clear_cached(a)
        pre = a.inference(pd_params(text, key, recorder.url, pd_stream=True,
                                    pd_stream_piece_blocks=GRPC_PIECE_BLOCKS))
        sent = list(frames)
        kinds = [kh.message_kind(f) for f in sent]
        clear_cached(b)
        t0 = time.perf_counter()
        answers = [cli.transfer_kv(raw) for raw in sent]
        t_grpc = time.perf_counter() - t0
        slot = b._pd_slots.get(key, (None,))[0]
        dec_grpc = b.inference({"pd_stage": "decode", "kv_cache_key": key})["token_ids"]
        clear_cached(b)
        t0 = time.perf_counter()
        statuses = [post_bytes(h.url + "/kv/transfer", raw, GRPC_HOP_TIMEOUT_S).status_code
                    for raw in sent]
        t_http = time.perf_counter() - t0
        dec_http = b.inference({"pd_stage": "decode", "kv_cache_key": key})["token_ids"]
        torch.cuda.synchronize()
        counts = pa.launch_counts()
        total = sum(map(len, sent))
        big = max(map(len, sent))
        answers_ok = (answers[-1]["slot"] == slot and slot is not None and slot >= 0
                      and all(x["slot"] == -1 for x in answers[:-1])
                      and [x["bytes_received"] for x in answers] == [len(f) for f in sent])
        print(f"[grpc] (b) phase 16's prompt exported streamed in pieces of {GRPC_PIECE_BLOCKS} "
              f"blocks: {len(sent)} frames ({kinds.count('piece')} pieces, the largest {big} B), "
              f"{total} B; pushed one by one through "
              f"TransferKVCache: the commit answered slot {answers[-1]['slot']} (B's slot {slot}"
              f"), the others -1, bytes_received each frame's: {answers_ok}; the same frames "
              f"over HTTP /kv/transfer: statuses {sorted(set(statuses))}; the two adoptions "
              f"decode to the same {len(dec_grpc)} tokens: {dec_grpc == dec_http}; the first "
              f"token {pre['first_token']} leads both: "
              f"{dec_grpc[:1] == [pre['first_token']]}; kernel launches of (b): {counts}",
              flush=True)
        if not answers_ok or set(statuses) != {200} or dec_grpc != dec_http or \
                len(dec_grpc) != PD_TOKENS:
            raise AssertionError(f"[grpc] (b) the adoptions differ: {answers}, {statuses}, "
                                 f"{dec_grpc} vs {dec_http}")
        check_counts("grpc (b)", counts, qmm=True)

        # a piece of 4 blocks passes the limit at B's plane
        frames.clear()
        key4 = "grpc-pd-4"
        clear_cached(a)
        a.inference(pd_params(text, key4, recorder.url, pd_stream=True,
                              pd_stream_piece_blocks=4))
        refused = None
        for raw in list(frames):
            try:
                cli.transfer_kv(raw)
            except RpcError as exc:
                refused = (kh.message_kind(raw), len(raw), exc.code(), exc.details())
                break
        # the piece's frames are raw, as the JAX StreamedExport writes them by
        # default (compress=False), so compression does not move this limit;
        # and its int8 codes would barely shrink under zstd
        _, meta, payload = kh._unpack_stream(raw)
        blobs = kh._read_blobs(payload, 2) if meta.get("has_scales") else [payload]
        piece_flags = [blob[5] & 1 for blob in blobs]
        codes = kh._read_pages(*(blobs + [None])[:2])[0]
        packed = len(serialization.serialize(codes, compress=True))
        aborted = cli.transfer_kv(kh.abort_message(key4))
        live = key4 in b._handoff_rx._sessions
        print(f"[grpc] (b) pieces of 4 blocks: the first {refused and refused[0]} of "
              f"{refused and refused[1]} B refused with {refused and refused[2].name}: "
              f"{refused and refused[3]!r}; the session aborted over gRPC ({aborted}), none "
              f"left on B: {not live}; its TPUT frames' zstd flags {piece_flags} (streamed "
              f"pieces go uncompressed, the JAX default); its int8 codes would zstd to "
              f"{packed} B of {codes.numel()}", flush=True)
        if refused is None or refused[2] != StatusCode.RESOURCE_EXHAUSTED or \
                not refused[3].startswith("SERVER: Received message larger than max") or live \
                or any(piece_flags):
            raise AssertionError(f"[grpc] (b) a 4-block piece was not refused: {refused}")
        print(f"[grpc] (c) the handoff of {total} B: {total / t_grpc / 1e6:.1f} MB/s over gRPC "
              f"({len(sent)} unary calls, {t_grpc * 1e3:.1f} ms), {total / t_http / 1e6:.1f} "
              f"MB/s over HTTP ({t_http * 1e3:.1f} ms), each with B's adoption (loopback; "
              f"{smi})", flush=True)
    finally:
        cli.close()
        g.stop(0)
        for p in (recorder, h):
            p.stop()
        a.unload()
        b.unload()
    del a, b
    torch.cuda.empty_cache()
    return counts


def grpc_phase(torch, pa, smi, model="llama3-8b", device="cuda", layers=GRPC_LAYERS):
    """Phase 28 (see the module docstring) → {"bf16": (a)'s launches,
    "int8": (b)'s}."""
    t_phase = time.perf_counter()
    bf16 = grpc_pipeline(torch, pa, smi, model, device, layers)
    int8 = grpc_handoff(torch, pa, smi, model, device)
    print(f"[grpc] phase 28 ran in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"bf16": bf16, "int8": int8}


# ------------------------------------------ phase 29: zstd frames and YAML configs

ZSTD_FIXTURES = "tests/fixtures/zstd"
CONFIG_FIXTURES = "tests/fixtures/config"
ZSTD_PLAIN_BYTES = 70_000     # (a) fixtures whose content the plain decoder reads too
ZSTD_REPEATS = 5              # (d) timed encodes and decodes of each payload (median kept)
HOP_TENSORS = {}              # phase 28 (a): a decode step's hidden and answer, a chunk's
HOP_BYTES = {}                # route -> [((bytes out, back), (uncompressed out, back)) a hop]

ZSTD_CHILD = """
import json, sys
sys.path.insert(0, {root!r})
from distributed_gpu_inference_torch import native
from distributed_gpu_inference_torch.utils import zstd
data = open({path!r}, "rb").read()
said = {{}}
for name, fn in (("native", zstd.decompress), ("plain", zstd.decompress_plain)):
    try:
        said[name] = "read %d bytes" % len(fn(data))
    except zstd.CodecUnavailable as exc:
        said[name] = "CodecUnavailable: %s" % exc
    except ValueError as exc:
        said[name] = "ValueError: %s" % exc
print(json.dumps({{"said": said, "plain_taken": native.PLAIN_TAKEN}}))
"""


def no_plain_taken(tag):
    """No host function of the run took its plain version (``native.PLAIN_TAKEN``):
    the native radix index, image codec and zstd codec all built and loaded."""
    from distributed_gpu_inference_torch import native

    if native.PLAIN_TAKEN:
        raise AssertionError(f"[{tag}] a plain host version was taken: {native.PLAIN_TAKEN}")


def zstd_fixtures_check(tag):
    """(a): every libzstd fixture decoded natively to its manifest's
    SHA-256, the plain decoder on the smallest, the refused ones each in a
    child process → (frames read, frames refused)."""
    import hashlib
    import os

    from distributed_gpu_inference_torch import native
    from distributed_gpu_inference_torch.utils import zstd

    manifest = json.load(open(f"{ZSTD_FIXTURES}/manifest.json"))
    if not native.native_available(native.ZSTD_SRC):
        raise AssertionError(f"[{tag}] the native zstd codec did not build")
    read, refused, children = [], [], []
    for e in manifest["frames"]:
        path = f"{ZSTD_FIXTURES}/{e['file']}"
        data = open(path, "rb").read()
        if hashlib.sha256(data).hexdigest() != e["file_sha256"]:
            raise AssertionError(f"[{tag}] {e['file']} is not the committed fixture")
        if "refused" in e:
            children.append((e, subprocess.Popen(
                [sys.executable, "-c", ZSTD_CHILD.format(root=os.getcwd(), path=path)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
            continue
        out = zstd.decompress(data)
        ok = hashlib.sha256(out).hexdigest() == e["content_sha256"]
        if e["content_bytes"] <= ZSTD_PLAIN_BYTES:
            ok = ok and zstd.decompress_plain(data) == out
        read.append(e["file"])
        if not ok:
            raise AssertionError(f"[{tag}] {e['file']} decodes to other bytes than libzstd's")
    for e, proc in children:
        out, err = proc.communicate(timeout=120)
        if proc.returncode != 0:
            raise AssertionError(f"[{tag}] {e['file']}: the decoding child failed "
                                 f"({proc.returncode}): {err[-2000:]}")
        said = json.loads(out.strip().splitlines()[-1])
        want = "CodecUnavailable" if e["refused"] == "dictionary" else "ValueError"
        if said["plain_taken"] or not all(v.startswith(want) for v in said["said"].values()):
            raise AssertionError(f"[{tag}] {e['file']} ({e['refused']}): {said}")
        refused.append(f"{e['file']} ({said['said']['native']})")
    print(f"[{tag}] (a) the {len(read)} libzstd {manifest['libzstd']} fixtures of "
          f"{ZSTD_FIXTURES} (levels -5 to 19, checksum, multi-block, bf16 / f32 / zero / "
          f"incompressible int8 pages, two frames back to back, raw and RLE blocks past the "
          f"block maximum) decode natively to their "
          f"manifest's SHA-256, the plain decoder too where they hold up to {ZSTD_PLAIN_BYTES} B; "
          f"refused, each in a child process, native and plain alike: {'; '.join(refused)}",
          flush=True)
    return read, refused


def zstd_handoff(torch, pa, smi, model, device):
    """(b) → (its launches, the handoff's pages and scales wire tensors, a
    logits row B sampled)."""
    from distributed_gpu_inference_torch.comm.data_plane import DataPlaneServer
    from distributed_gpu_inference_torch.runtime import kv_handoff as kh
    from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine

    text = serving_prompts()[2][-1]
    t0 = time.perf_counter()
    a = TorchLLMEngine(pd_engine_config(model, "int8", "int8", device))
    b = TorchLLMEngine(pd_engine_config(model, "int8", "int8", device))
    a.load_model()
    b.load_model()
    blobs, rows = [], []
    recorder = DataPlaneServer(kv_receiver=lambda raw: blobs.append(raw) or {"ok": 1})
    recorder.start()
    sample = b.engine._sample

    def first_row(logits, *args):
        if not rows:
            rows.append(logits[0].float().cpu())
        return sample(logits, *args)

    b.engine._sample = first_row
    try:
        print(f"[zstd] (b) A and B ({model}, int8 weights and int8 pools, seed 0) loaded in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        torch.cuda.synchronize()
        pa.reset_launch_counts()
        key = "zstd-pd"
        clear_cached(a)
        pre = a.inference(pd_params(text, key, recorder.url, pd_stream=False))
        blob = blobs[-1]
        h = kh.deserialize_handoff(blob)
        raw = kh.serialize_handoff(h, compress=False)
        frames = kh._read_blobs(blob, 3 if h.scale_pages is not None else 2)[1:]
        flags = [f[5] & 1 for f in frames]
        decoded = {}
        for name, wire in (("zstd", blob), ("uncompressed", raw)):
            clear_cached(b)
            b.kv_receiver(wire)
            decoded[name] = b.inference({"pd_stage": "decode", "kv_cache_key": key})["token_ids"]
        torch.cuda.synchronize()
        counts = pa.launch_counts()
    finally:
        del b.engine._sample
        recorder.stop()
        a.unload()
        b.unload()
    same = decoded["zstd"] == decoded["uncompressed"]
    print(f"[zstd] (b) phase 16's prompt ({len(h.token_ids)} tokens, {h.num_blocks} blocks) "
          f"exported by A in one blob, serialize_handoff(compress=True): {len(blob)} B against "
          f"{len(raw)} B uncompressed ({len(blob) / len(raw):.4f}), pages / scales frames zstd: "
          f"{flags}; B adopted it and decoded {len(decoded['zstd'])} greedy tokens, the same as "
          f"from the uncompressed wire: {same}; the first token {pre['first_token']} leads "
          f"both: {decoded['zstd'][:1] == [pre['first_token']]}; kernel launches of (b): "
          f"{counts} ({smi})", flush=True)
    if not same or len(decoded["zstd"]) != PD_TOKENS or not any(flags) \
            or decoded["zstd"][:1] != [pre["first_token"]] or len(blob) >= len(raw):
        raise AssertionError(f"[zstd] (b) the compressed handoff did not decode as the "
                             f"uncompressed one: {decoded}, flags {flags}")
    check_counts("zstd (b)", counts, qmm=True)
    wire = {"handoff pages (int8 codes)": h.pages}
    if h.scale_pages is not None:
        wire["handoff scales (bf16, over D lanes)"] = kh.expand_scales(
            h.scale_pages, h.pages.shape[-1]).contiguous()
    del a, b
    torch.cuda.empty_cache()
    return counts, wire, rows[0]


def config_fixture_check(tag):
    """(c): the JAX worker's committed ``config.yaml`` reads equal to its
    JSON twin, builds the same ``WorkerConfig``, and the port's dump of the
    twin is the file byte for byte."""
    from distributed_gpu_inference_torch.utils import config as wconfig
    from distributed_gpu_inference_torch.utils import yaml_config

    text = open(f"{CONFIG_FIXTURES}/config.yaml").read()
    twin = json.load(open(f"{CONFIG_FIXTURES}/config.json"))
    loaded = yaml_config.safe_load(text) == twin
    built = wconfig.config_dict(wconfig.load_worker_config(
        f"{CONFIG_FIXTURES}/config.yaml", environ={})) == twin
    dumped = yaml_config.safe_dump(twin) == text
    print(f"[{tag}] (c) {CONFIG_FIXTURES}/config.yaml ({len(text)} B, the JAX worker's "
          f"save_worker_config): reads equal to its JSON twin {loaded}, builds the same "
          f"WorkerConfig {built}, the port's safe_dump of the twin is the file byte for byte "
          f"{dumped}", flush=True)
    if not (loaded and built and dumped):
        raise AssertionError(f"[{tag}] (c) the JAX worker's config.yaml reads otherwise")


def codec_rates(torch, tag, payloads, smi):
    """(d): the native codec's encode and decode MB/s and wire bytes on
    each payload (information)."""
    from distributed_gpu_inference_torch.utils import zstd

    cpu = host_cpu_name()
    lines = []
    for name, t in payloads.items():
        data = t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()
        enc, dec = [], []
        for _ in range(ZSTD_REPEATS):
            t0 = time.perf_counter()
            frame = zstd.compress(data)
            t1 = time.perf_counter()
            out = zstd.decompress(frame, expected_size=data.size)
            dec.append(time.perf_counter() - t1)
            enc.append(t1 - t0)
        if bytes(out) != data.tobytes():
            raise AssertionError(f"[{tag}] (d) {name}: the codec does not round-trip")
        mb = data.size / 1e6
        lines.append(f"{name} {tuple(t.shape)} {t.dtype}: {data.size} -> {len(frame)} B "
                     f"({len(frame) / data.size:.4f}), encode {mb / pctl(enc, 0.5):.1f} MB/s, "
                     f"decode {mb / pctl(dec, 0.5):.1f} MB/s")
    print(f"[{tag}] (d) the native codec (median of {ZSTD_REPEATS}; host CPU {cpu}; {smi}): "
          + "; ".join(lines), flush=True)
    hops = [f"{route}: " + ", ".join(f"hop {h} {o} / {b} B ({ro} / {rb} B uncompressed)"
                                     for h, ((o, b), (ro, rb)) in enumerate(v))
            for route, v in HOP_BYTES.items()]
    print(f"[{tag}] (d) a decode step's message bytes out / back a hop, as phases 21 and 28 "
          f"sent them in this run: {'; '.join(hops) or 'neither ran'}", flush=True)


def zstd_phase(torch, pa, smi, model="llama3-8b", device="cuda"):
    """Phase 29 (see the module docstring) → (b)'s launches."""
    t_phase = time.perf_counter()
    zstd_fixtures_check("zstd")
    counts, wire, row = zstd_handoff(torch, pa, smi, model, device)
    config_fixture_check("zstd")
    payloads = dict(wire)
    if HOP_TENSORS:
        payloads["a decode step's hidden (phase 28)"] = HOP_TENSORS["hidden"]
        payloads["a decode step's logits (phase 28)"] = HOP_TENSORS["out"]["logits"]
        payloads[f"a {HOP_TENSORS['chunk_tokens']}-token chunk's logits (phase 28)"] = \
            HOP_TENSORS["chunk"]["logits"]
    payloads["a decode logits row B sampled (b)"] = row
    codec_rates(torch, "zstd", payloads, smi)
    no_plain_taken("zstd")
    print(f"[zstd] phase 29 ran in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts


def run_alone(torch, pa, smi, phases, check, guard):
    """``--phase N`` (repeatable): the kernels built, then only phases N of
    ALONE, in the order given."""
    from distributed_gpu_inference_torch.ops import _build

    print(f"[build] kernels built in {_build.build(list(_build.KERNEL_SOURCES)):.1f} s",
          flush=True)
    shared, _, prompts = serving_prompts()
    run = {13: lambda: worker_phase(torch, pa, smi, prompts),
           16: lambda: pd_alone(torch, pa, smi, prompts, shared),
           17: lambda: local_files_phase(torch, pa, smi),
           18: lambda: fleet_phase(torch, pa, smi, prompts),
           19: lambda: moe_phase(torch, pa, smi, prompts, shared),
           21: lambda: pipeline_phase(torch, pa, smi),
           22: lambda: direct_mode_phase(torch, pa, smi, prompts),
           23: lambda: tp_phase(torch, pa, smi, prompts),
           24: lambda: seq_phase(torch, pa, smi),
           25: lambda: deployment_phase(torch, pa, smi, prompts),
           26: lambda: mesh_phase(torch, pa, smi, check, guard),
           27: lambda: photo_phase(torch, pa, smi),
           28: lambda: grpc_phase(torch, pa, smi),
           29: lambda: zstd_phase(torch, pa, smi)}
    for n in phases:
        t0 = time.perf_counter()
        run[n]()
        no_plain_taken(f"phase {n}")
        print(f"[alone] phase {n} ran in {time.perf_counter() - t0:.1f} s", flush=True)


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one GPU.")
    ap.add_argument("--phase", type=int, action="append", choices=ALONE,
                    help="run only this phase after the build (repeatable): one of "
                    f"{', '.join(map(str, ALONE))}")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    guard = HostGuard()
    # every engine of the run must hold the C++ prefix index
    check = NativeIndexCheck()
    from distributed_gpu_inference_torch.models import llama
    from distributed_gpu_inference_torch.models.configs import get_model_config
    from distributed_gpu_inference_torch.ops import _build
    from distributed_gpu_inference_torch.ops import paged_attention as pa
    from distributed_gpu_inference_torch.ops import qmm
    from distributed_gpu_inference_torch.ops.attention import paged_attention_ref
    from distributed_gpu_inference_torch.ops.quantization import quantize_weight
    from distributed_gpu_inference_torch.runtime.engine import EngineConfig, TorchEngine
    from distributed_gpu_inference_torch.utils.data_structures import (
        InferenceRequest,
        SamplingParams,
    )
    from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"nvidia-smi: {smi}", flush=True)
    if args.phase:
        run_alone(torch, pa, smi, args.phase, check, guard)
        print(f"[done] phases {args.phase} ran in {time.perf_counter() - t_start:.1f} s; the "
              f"host's lowest available memory {guard.low:.1f} GiB", flush=True)
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
        return 0

    # ---- 2. build
    qmm_variants = [(("QMM_STAGES", st), ("QMM_BK", bk)) for st, bk in QMM_SWEEP
                    if (st, bk) != qmm.GEOMETRY[:2]]
    secs = _build.build(list(_build.KERNEL_SOURCES) + [("qmm_w8a16", v) for v in qmm_variants])
    print(f"[build] kernels built in {secs:.1f} s (with {len(qmm_variants)} geometry variants "
          f"of qmm_w8a16 for phase 9's sweep)", flush=True)
    for name in _build.KERNEL_SOURCES:
        log = _build.build_log_path(name)
        if log.is_file():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[build] {name}: {line.strip()}")

    # ---- 3. kernel parity at llama3-8b widths
    parity = {}
    for window in (None, 64):
        q, kp, vp, tables, pos, lens, _ = ragged_round_case(torch, dev, window)
        got = pa.ragged_paged_attention(q, kp, vp, tables, pos, lens, BK, window=window)
        want = paged_attention_ref(q, kp, vp, tables, pos, lens, BK, window=window)
        torch.cuda.synchronize()
        ok, max_abs, max_vec = errors(torch, got, want, RAGGED_ATOL)
        pad_zero = bool((got[pos < 0] == 0).all().item())
        near_zero = want.float().abs() < 0.1
        near_zero_err = float((got.float() - want.float()).abs()[near_zero].max().item())
        # negative control: the same check must reject the plain version
        # with one key dropped from a 512-key row and a 600-key row
        lens_drop = lens.clone()
        lens_drop[3] -= 1
        lens_drop[7] -= 1
        dropped = paged_attention_ref(q, kp, vp, tables, pos, lens_drop, BK, window=window)
        drop_ok, _, drop_vec = errors(torch, dropped, want, RAGGED_ATOL)
        print(f"[parity] ragged window={window}: max_abs_err {max_abs:.3e} "
              f"max_vector_rel_err {max_vec:.3e} (bound atol {RAGGED_ATOL} rtol {RTOL}, "
              f"vector {VEC_REL}); max abs err where |plain| < 0.1: {near_zero_err:.3e}; "
              f"pad queries exact zero: {pad_zero}; one key dropped from rows 3 and 7: "
              f"max_vector_rel_err {drop_vec:.3e}, rejected: {not drop_ok}", flush=True)
        if drop_ok:
            raise AssertionError("the parity check accepts an output with a key dropped")
        if not (ok and pad_zero):
            raise AssertionError(f"ragged kernel disagrees with its plain version (window={window})")
        if window is None:
            parity["ragged_paged_attention"] = max_abs
    q, nk, nv, kp, vp, layer, tables, pos, lens, lens_np = decode_case(torch, dev)
    kp2, vp2 = kp.clone(), vp.clone()
    got, _, _ = pa.paged_decode_attention_fused(q, nk, nv, kp, vp, layer, tables, pos, lens, BK)
    want, _, _ = pa.paged_decode_attention_fused_plain(q, nk, nv, kp2, vp2, layer, tables, pos, lens, BK)
    torch.cuda.synchronize()
    ok, max_abs, max_vec = errors(torch, got, want, FUSED_ATOL)
    pools_equal = bool(torch.equal(kp, kp2) and torch.equal(vp, vp2))
    inactive_zero = bool((got[6] == 0).all().item())
    print(f"[parity] fused decode: max_abs_err {max_abs:.3e} max_vector_rel_err {max_vec:.3e} "
          f"(bound atol {FUSED_ATOL} rtol {RTOL}, vector {VEC_REL}); "
          f"pools bit-identical after the write: "
          f"{pools_equal}; inactive row exact zero: {inactive_zero}", flush=True)
    if not (ok and pools_equal and inactive_zero):
        raise AssertionError("fused decode kernel disagrees with its plain version")
    parity["paged_decode_attention_fused"] = max_abs

    # ---- 4. serving at full width and depth
    t0 = time.perf_counter()
    llm = TorchLLMEngine({
        "model": "llama3-8b", "max_batch_size": SERVE_BATCH, "max_seq_len": MAX_SEQ,
        "enable_prefix_cache": True, "dtype": "bfloat16", "device": "cuda",
        "seed": 0,
    })
    llm.load_model()
    torch.cuda.synchronize()
    print(f"[serving] llama3-8b (32 layers, bf16, random weights seed 0) loaded in "
          f"{time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated", flush=True)
    shared, lengths, prompts = serving_prompts()
    bf16_tokens, payloads, hit, wall, launches, stats = serve(torch, pa, llm, prompts, shared)
    print(f"[serving] kernel launches on the main path: {launches}", flush=True)
    check_counts("serving", launches, qmm=False)
    report_serving("serving", lengths, payloads, hit, wall, stats)
    compare_forward(torch, "serving", llm.engine.model_cfg, llm.engine.params,
                    torch.bfloat16, dev)
    llm.unload()
    del llm
    torch.cuda.empty_cache()

    # ---- 5. times at the serving shapes
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    rcase = ragged_in(torch, ragged_round_case(torch, dev), "bf16")
    dcase = decode_in(torch, decode_case(torch, dev), "bf16")
    r_times = ragged_times(torch, pa, paged_attention_ref, flush,
                           "[times] ragged round 8x256 (Nh 32, Hkv 8, D 128)", rcase, "bf16")
    d_times = decode_times(torch, pa, flush,
                           f"[times] fused decode 8 rows (kv {dcase[-1].tolist()})", dcase, "bf16")
    kernels = [
        entry("ragged_paged_attention", "ragged_paged_attention.cu", PALLAS + ":932",
              launches["ragged_paged_attention"], parity["ragged_paged_attention"], r_times),
        entry("paged_decode_attention_fused", "paged_decode_fused.cu", PALLAS + ":469",
              launches["paged_decode_attention_fused"], parity["paged_decode_attention_fused"],
              d_times),
    ]
    del flush, rcase, dcase
    torch.cuda.empty_cache()

    # ---- 6. quantized parity at llama3-8b widths
    g = torch.Generator(device=dev).manual_seed(5)
    qparity = {}
    for mode in ("int8", "fp8"):
        worst = 0.0
        for kdim, ndim in PROJ_SHAPES:
            w = torch.randn((1, kdim, ndim), generator=g, device=dev) * kdim ** -0.5
            qw = quantize_weight(w, mode)
            for m in QMM_ROWS + (qmm.MAX_KERNEL_ROWS,):
                x = torch.randn((m, kdim), generator=g, device=dev).to(torch.bfloat16)
                got = qmm.launch_kernel(x, qw["qw"], qw["scale"])
                want = qmm.qmm_plain(x, qw["qw"], qw["scale"])
                torch.cuda.synchronize()
                ok, max_abs, max_vec = errors(torch, got, want, QMM_ATOL)
                print(f"[qparity] qmm {mode} M={m} K={kdim} N={ndim}: max_abs_err "
                      f"{max_abs:.3e} max_row_rel_err {max_vec:.3e} (bound atol {QMM_ATOL} "
                      f"rtol {RTOL}, row {VEC_REL})", flush=True)
                if not ok:
                    raise AssertionError(f"qmm {mode} disagrees with its plain version")
                worst = max(worst, max_abs)
        # every layer's indexing of a 32-layer stack on one shape
        w = torch.randn((32, HIDDEN, HKV * D), generator=g, device=dev) * HIDDEN ** -0.5
        qw = quantize_weight(w, mode)
        del w
        x = torch.randn((8, HIDDEN), generator=g, device=dev).to(torch.bfloat16)
        layer_ok = True
        for layer in range(32):
            got = qmm.launch_kernel(x, qw["qw"], qw["scale"], layer)
            ok, max_abs, _ = errors(torch, got, qmm.qmm_plain(x, qw["qw"], qw["scale"], layer),
                                    QMM_ATOL)
            other = qmm.qmm_plain(x, qw["qw"], qw["scale"], (layer + 1) % 32)
            layer_ok &= ok and not errors(torch, got, other, QMM_ATOL)[0]
            worst = max(worst, max_abs)
        print(f"[qparity] qmm {mode}: all 32 layers of a [32, {HIDDEN}, {HKV * D}] stack "
              f"match their own layer and not the next: {layer_ok}", flush=True)
        if not layer_ok:
            raise AssertionError(f"qmm {mode} layer indexing is wrong")
        qparity[f"qmm_w8a16[{mode}]"] = worst
        del qw

    for kv_kind in ("int8", "fp8"):
        for window in (None, 64):
            q, kp, vp, tables, pos, lens, _ = ragged_round_case(torch, dev, window)
            kq, vq, ks, vs = kv_pools(torch, kp, vp, kv_kind)
            got = pa.ragged_paged_attention(q, kq, vq, tables, pos, lens, BK, window=window,
                                            k_scale=ks, v_scale=vs)
            want = paged_attention_ref(q, kq, vq, tables, pos, lens, BK, window=window,
                                       k_scale=ks, v_scale=vs)
            torch.cuda.synchronize()
            atol = RAGGED_ATOL
            if kv_kind == "int8":
                atol += BF16_HALF_ULP * float(torch.maximum(
                    dequantized(torch, kq, ks).abs().max(),
                    dequantized(torch, vq, vs).abs().max()).item())
            ok, max_abs, max_vec = errors(torch, got, want, atol)
            pad_zero = bool((got[pos < 0] == 0).all().item())
            near_zero = want.float().abs() < 0.1
            near_zero_err = float((got.float() - want.float()).abs()[near_zero].max().item())
            line = (f"[qparity] ragged {kv_kind} window={window}: max_abs_err {max_abs:.3e} "
                    f"max_vector_rel_err {max_vec:.3e} (bound atol {atol:.3e} rtol {RTOL}, "
                    f"vector {VEC_REL}); max abs err where |plain| < 0.1: {near_zero_err:.3e}; "
                    f"pad queries exact zero: {pad_zero}")
            if kv_kind == "int8":
                lens_drop = lens.clone()
                lens_drop[3] -= 1
                lens_drop[7] -= 1
                dropped = paged_attention_ref(q, kq, vq, tables, pos, lens_drop, BK,
                                              window=window, k_scale=ks, v_scale=vs)
                drop_ok, _, drop_vec = errors(torch, dropped, want, atol)
                line += (f"; one key dropped from rows 3 and 7: max_vector_rel_err "
                         f"{drop_vec:.3e}, rejected: {not drop_ok}")
                if drop_ok:
                    raise AssertionError("the int8 parity check accepts a dropped key")
            print(line, flush=True)
            if not (ok and pad_zero):
                raise AssertionError(f"ragged {kv_kind} kernel disagrees (window={window})")
            if window is None:
                qparity[f"ragged_paged_attention[{kv_kind}]"] = max_abs

        q, nk, nv, kp, vp, layer, tables, pos, lens, lens_np = decode_case(torch, dev)
        if kv_kind == "fp8":
            # past e4m3's range: JAX's cast gives NaN above 464, not ±448
            nk[0, 0, 0, :4] = torch.tensor([470.0, -500.0, 440.0, 464.0])
        else:
            nk[1, 0, 3, 7] = 60.0                 # one wide value sets row 1's scale
        kq, vq, ks, vs = kv_pools(torch, kp, vp, kv_kind)
        kq2, vq2 = kq.clone(), vq.clone()
        ks2 = vs2 = None
        if ks is not None:
            ks2, vs2 = ks.clone(), vs.clone()
        got, _, _ = pa.paged_decode_attention_fused(q, nk, nv, kq, vq, layer, tables, pos,
                                                    lens, BK, k_scale=ks, v_scale=vs)
        want, _, _ = pa.paged_decode_attention_fused_plain(q, nk, nv, kq2, vq2, layer, tables,
                                                           pos, lens, BK, k_scale=ks2,
                                                           v_scale=vs2)
        torch.cuda.synchronize()
        # fp8: row 0's key holds NaN in both (checked in the pools); its
        # attention output is not held
        rows = slice(1, None) if kv_kind == "fp8" else slice(None)
        ok, max_abs, max_vec = errors(torch, got[rows], want[rows], FUSED_ATOL)
        pools_equal = bool(torch.equal(raw(torch, kq), raw(torch, kq2))
                           and torch.equal(raw(torch, vq), raw(torch, vq2)))
        scales_equal = ks is None or bool(torch.equal(raw(torch, ks), raw(torch, ks2))
                                          and torch.equal(raw(torch, vs), raw(torch, vs2)))
        inactive_zero = bool((got[6] == 0).all().item())
        line = (f"[qparity] fused decode {kv_kind}: max_abs_err {max_abs:.3e} "
                f"max_vector_rel_err {max_vec:.3e} (bound atol {FUSED_ATOL} rtol {RTOL}, "
                f"vector {VEC_REL}); code pools bit-identical after the write: "
                f"{pools_equal}; scale pools bit-identical: {scales_equal}; inactive row "
                f"exact zero: {inactive_zero}")
        if kv_kind == "fp8":
            written = raw(torch, kq)[layer, tables[0, int(pos[0, 0]) // BK], 0,
                                     int(pos[0, 0]) % BK, :4].tolist()
            line += f"; codes written for 470, -500, 440, 464: {[hex(v & 0xFF) for v in written]}"
        else:
            lens_drop = lens.clone()
            lens_drop[5] -= 1
            kq3, vq3, ks3, vs3 = kq2.clone(), vq2.clone(), ks2.clone(), vs2.clone()
            dropped, _, _ = pa.paged_decode_attention_fused_plain(
                q, nk, nv, kq3, vq3, layer, tables, pos, lens_drop, BK, k_scale=ks3,
                v_scale=vs3)
            drop_ok, _, drop_vec = errors(torch, dropped, want, FUSED_ATOL)
            line += (f"; the new key dropped from row 5: max_vector_rel_err {drop_vec:.3e}, "
                     f"rejected: {not drop_ok}")
            if drop_ok:
                raise AssertionError("the int8 fused parity check accepts a dropped key")
        print(line, flush=True)
        if not (ok and pools_equal and scales_equal and inactive_zero):
            raise AssertionError(f"fused decode {kv_kind} kernel disagrees with its plain version")
        qparity[f"paged_decode_attention_fused[{kv_kind}]"] = max_abs
    del q, kp, vp, kq, vq, kq2, vq2
    torch.cuda.empty_cache()

    # ---- 7. int8 serving at full width and depth
    t0 = time.perf_counter()
    llm = int8_serving_engine()
    llm.load_model()
    torch.cuda.synchronize()
    print(f"[int8 serving] llama3-8b (32 layers, int8 weights, int8 KV, random weights "
          f"seed 0) loaded in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated", flush=True)
    i8_tokens, payloads, hit, wall, i8_launches, stats = serve(torch, pa, llm, prompts, shared)
    print(f"[int8 serving] kernel launches on the main path: {i8_launches}", flush=True)
    check_counts("int8 serving", i8_launches, qmm=True)
    report_serving("int8 serving", lengths, payloads, hit, wall, stats)
    same = sum(a == b for key in bf16_tokens for a, b in zip(bf16_tokens[key], i8_tokens[key]))
    total = sum(len(v) for v in bf16_tokens.values())
    print(f"[int8 serving] greedy tokens equal to the bf16 run (information): "
          f"{same}/{total} = {same / total:.3f}", flush=True)
    compare_forward(torch, "int8 serving", llm.engine.model_cfg, llm.engine.params,
                    torch.int8, dev)

    # ---- 11. the direct server on the int8 engine
    direct_server_phase(torch, pa, llm, prompts, smi)
    no_plain_taken("phase 11")

    # ---- 16. PD disaggregation, int8 pools: phase 7's engine is A
    pd_phase(torch, pa, smi, llm, prompts, (i8_tokens, payloads), "int8")
    no_plain_taken("phase 16")
    llm.unload()
    del llm
    torch.cuda.empty_cache()

    # ---- 16. PD disaggregation, bf16 pools (int8 weights), and the worker roles
    pd_bf16_phase(torch, pa, smi, prompts, shared)
    no_plain_taken("phase 16")

    # ---- 8. fp8 serving at llama3-8b width, 4 layers
    cfg4 = get_model_config("llama3-8b", num_layers=4)
    eng = TorchEngine(cfg4, EngineConfig(max_batch_size=4, max_seq_len=MAX_SEQ,
                                         quantization="fp8", kv_cache_dtype="fp8"),
                      seed=0, device="cuda")
    reqs = [InferenceRequest(prompt_token_ids=list(range(5 + i, 5 + i + 40 * (i + 1))),
                             sampling=SamplingParams(max_new_tokens=16, ignore_eos=True))
            for i in range(4)]
    pa.reset_launch_counts()
    outs = eng.generate(reqs, use_multi_step=True)
    torch.cuda.synchronize()
    f8_launches = pa.launch_counts()
    print(f"[fp8 serving] llama3-8b width, 4 layers, fp8 weights + fp8 KV: 4 requests x 16 "
          f"tokens; kernel launches: {f8_launches}", flush=True)
    if any(o.error or len(o.token_ids) != 16 for o in outs):
        raise AssertionError(f"fp8 serving errors: {[(o.error, o.token_ids) for o in outs]}")
    check_counts("fp8 serving", f8_launches, qmm=True)
    compare_forward(torch, "fp8 serving", cfg4, eng.params, torch.float8_e4m3fn, dev)
    del eng
    torch.cuda.empty_cache()

    # ---- 9. times of the quantized variants
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    main_launches = {"bf16": launches, "int8": i8_launches, "fp8": f8_launches}
    for mode in ("int8", "fp8"):
        weights = []
        for _, kdim, ndim in LAYER_PROJ:
            w = torch.randn((1, kdim, ndim), generator=g, device=dev) * kdim ** -0.5
            qw = quantize_weight(w, mode)
            weights.append((qw["qw"], qw["scale"]))
            del w
        deq = [(qw[0].float() * sc[0]).to(torch.bfloat16) for qw, sc in weights]
        xs = {m: {k: torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
                  for k in {kd for _, kd, _ in LAYER_PROJ}} for m in BOUND_ROWS}

        def layer_calls(fn, m):
            return lambda: [fn(xs[m][qw.shape[1]], qw, sc) for qw, sc in weights]

        k_ms = time_ms(torch, layer_calls(qmm.launch_kernel, SERVE_BATCH), flush)
        p_ms = time_ms(torch, layer_calls(qmm.qmm_plain, SERVE_BATCH), flush, iters=20)
        l_ms = time_ms(torch, lambda: [torch.matmul(xs[SERVE_BATCH][w.shape[0]], w)
                                       for w in deq], flush)
        kg_ms = graph_ms(torch, layer_calls(qmm.launch_kernel, SERVE_BATCH), flush)
        lg_ms = graph_ms(torch, lambda: [torch.matmul(xs[SERVE_BATCH][w.shape[0]], w)
                                         for w in deq], flush)
        q_bytes, q_flops = qmm_cost(SERVE_BATCH, [(k, n) for _, k, n in LAYER_PROJ])
        q_bound, q_by = bound(q_bytes, q_flops)
        print(f"[qtimes] qmm {mode}, one layer's 7 projections at M={SERVE_BATCH}: kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, torch.matmul on bf16 weights {l_ms:.4f} ms, "
              f"bound {q_bound:.4f} ms ({q_by}: {q_bytes} B, {q_flops} flop); replayed as a "
              f"CUDA graph (no host launch gaps): kernel {kg_ms:.4f} ms, torch.matmul "
              f"{lg_ms:.4f} ms", flush=True)
        for (name, kdim, ndim), (qw, sc) in zip(LAYER_PROJ, weights):
            one = lambda: qmm.launch_kernel(xs[SERVE_BATCH][kdim], qw, sc)  # noqa: E731
            e1, g1 = time_ms(torch, one, flush), graph_ms(torch, one, flush)
            b1 = bound(*qmm_cost(SERVE_BATCH, [(kdim, ndim)]))[0]
            print(f"[qtimes] qmm {mode} {name} K={kdim} N={ndim} M={SERVE_BATCH} (plan "
                  f"{qmm.split_plan(SERVE_BATCH, kdim, ndim)}): kernel {e1:.4f} ms, as a CUDA "
                  f"graph {g1:.4f} ms = {b1 / g1:.1%} of the bound {b1:.4f} ms", flush=True)
        repeat_ok, graph_ok = qmm_repeat(torch, qmm, xs[SERVE_BATCH], weights)
        print(f"[qtimes] qmm {mode}: one layer's 7 projections at M={SERVE_BATCH} twice: bitwise "
              f"equal {repeat_ok}; a CUDA-graph replay equal to the eager calls: {graph_ok}",
              flush=True)
        if not (repeat_ok and graph_ok):
            raise AssertionError(f"qmm {mode} is not bitwise repeatable")
        sweep = []
        for stages, rows in QMM_SWEEP:
            variant = () if (stages, rows) == qmm.GEOMETRY[:2] else (
                ("QMM_STAGES", stages), ("QMM_BK", rows))
            t = graph_ms(torch, lambda: [qmm.launch_kernel(
                xs[SERVE_BATCH][qw.shape[1]], qw, sc, variant=variant) for qw, sc in weights],
                flush)
            sweep.append(f"{stages} x {rows} rows {t:.4f} ms" + (" (the build)" if not variant
                                                                 else ""))
        print(f"[qtimes] qmm {mode}, one layer's 7 projections at M={SERVE_BATCH} as a CUDA graph "
              f"by ring stages x K rows a stage: " + "; ".join(sweep), flush=True)
        measured = 0
        for m in BOUND_ROWS:
            km = time_ms(torch, layer_calls(qmm.launch_kernel, m), flush)
            lm = time_ms(torch, layer_calls(qmm._library_route, m), flush)
            print(f"[qtimes] qmm {mode} row bound: M={m}: kernel {km:.4f} ms, codes to bf16 + "
                  f"torch.matmul {lm:.4f} ms", flush=True)
            if km <= lm and measured == max([0] + [r for r in BOUND_ROWS if r < m]):
                measured = m
        print(f"[qtimes] qmm {mode}: the kernel is at least as fast as the library route up "
              f"to M={measured}; the dispatch bound MAX_KERNEL_ROWS is {qmm.MAX_KERNEL_ROWS} "
              f"(max_batch_size {SERVE_BATCH})", flush=True)
        kernels.append(entry(
            f"qmm_w8a16[{mode}]", "qmm_w8a16.cu", QPALLAS + ":88",
            main_launches[mode]["qmm_w8a16"], qparity[f"qmm_w8a16[{mode}]"],
            {"ms": k_ms, "graph_ms": kg_ms, "plain_ms": p_ms, "bound_ms": q_bound,
             "bound_by": q_by, "library_ms": l_ms, "library_graph_ms": lg_ms}))
        del weights, deq, xs
    if qmm.MAX_KERNEL_ROWS < SERVE_BATCH:
        raise AssertionError("the qmm row bound is below max_batch_size")

    for kv_kind in ("int8", "fp8"):
        rcase = ragged_in(torch, ragged_round_case(torch, dev), kv_kind)
        dcase = decode_in(torch, decode_case(torch, dev), kv_kind)
        r_times = ragged_times(torch, pa, paged_attention_ref, flush,
                               f"[qtimes] ragged round 8x256 {kv_kind} pools", rcase, kv_kind)
        d_times = decode_times(torch, pa, flush, f"[qtimes] fused decode 8 rows {kv_kind} pools",
                               dcase, kv_kind)
        for name, source, line, times in (
                ("ragged_paged_attention", "ragged_paged_attention.cu", ":932", r_times),
                ("paged_decode_attention_fused", "paged_decode_fused.cu", ":469", d_times)):
            kernels.append(entry(f"{name}[{kv_kind}]", source, PALLAS + line,
                                 main_launches[kv_kind][name], qparity[f"{name}[{kv_kind}]"],
                                 times))
        del rcase, dcase

    # ---- 10. both attention kernels at the long shapes, every pool type
    for kv_kind in ("bf16", "int8", "fp8"):
        suffix = "" if kv_kind == "bf16" else f"[{kv_kind}]"
        rcase = ragged_in(torch, long_ragged_case(torch, dev), kv_kind)
        dcase = decode_in(torch, long_decode_case(torch, dev), kv_kind)
        r_err, d_err = long_parity(torch, pa, paged_attention_ref, kv_kind, rcase, dcase)
        r_times = ragged_times(torch, pa, paged_attention_ref, flush,
                               f"[long] ragged {kv_kind} 8x256 round at kv 4096", rcase, kv_kind)
        d_times = decode_times(torch, pa, flush, f"[long] fused decode {kv_kind} 8 rows at kv 4096",
                               dcase, kv_kind)
        kernels += [
            entry(f"ragged_paged_attention{suffix}@long", "ragged_paged_attention.cu",
                  PALLAS + ":932", main_launches[kv_kind]["ragged_paged_attention"], r_err,
                  r_times),
            entry(f"paged_decode_attention_fused{suffix}@long", "paged_decode_fused.cu",
                  PALLAS + ":469", main_launches[kv_kind]["paged_decode_attention_fused"], d_err,
                  d_times),
        ]
        del rcase, dcase
        torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()

    # ---- 12. the worker's default model (head_dim 32) through both kernels
    (r_err, d_err), small_launches, (r_times, d_times) = small_model_phase(torch, pa)
    kernels += [
        entry("ragged_paged_attention@d32", "ragged_paged_attention.cu", PALLAS + ":932",
              small_launches["ragged_paged_attention"], r_err, r_times),
        entry("paged_decode_attention_fused@d32", "paged_decode_fused.cu", PALLAS + ":469",
              small_launches["paged_decode_attention_fused"], d_err, d_times),
    ]

    # ---- 13. the worker process against a stand-in control plane
    *_, flight = worker_phase(torch, pa, smi, prompts)
    no_plain_taken("phase 13")

    # ---- 14. serving under pressure: spill tiers, fault seams, deadlines, flight
    resp = RespStandIn()
    try:
        for kv in (None, "int8"):
            spill_phase(torch, pa, smi, kv, resp)
    finally:
        resp.stop()
    flight_check(flight)
    no_plain_taken("phase 14")

    # ---- 15. speculative decoding: integrated rounds and the tree decoder
    spec_entries, random_head = spec_phase(torch, pa, smi, prompts, lengths)
    no_plain_taken("phase 15")
    kernels += spec_entries

    # ---- 17. weights and tokenizer from local files
    local_files_phase(torch, pa, smi)
    no_plain_taken("phase 17")

    # ---- 18. a fleet of two workers, killed, blacked out and restarted
    fleet_phase(torch, pa, smi, prompts)
    no_plain_taken("phase 18")

    # ---- 19. mixtral-8x7b: the MoE layer, the streamed init, serving, times
    moe_timed, moe_launches, _ = moe_phase(torch, pa, smi, prompts, shared)
    no_plain_taken("phase 19")
    for name, (times, err) in moe_timed.items():
        kernels.append(entry(f"qmm_w8a16[int8]@moe-{name}", "qmm_w8a16.cu", QPALLAS + ":88",
                             moe_launches["qmm_w8a16"], err, times))

    # ---- 20. draft distillation and the embedding, vision, whisper and image engines
    p20 = engines_phase(torch, pa, smi, prompts, shared, random_head)
    no_plain_taken("phase 20")
    # ---- 21. pipeline stages: llama3-8b int8 in two stages and a spare
    p21 = pipeline_phase(torch, pa, smi)
    no_plain_taken("phase 21")
    # ---- 22. serving.mode: direct, sub-wave admission, the weight cache
    p22 = direct_mode_phase(torch, pa, smi, prompts)
    no_plain_taken("phase 22")
    # ---- 23. tensor and expert parallelism: two ranks on the card
    p23, tp_entries = tp_phase(torch, pa, smi, prompts)
    no_plain_taken("phase 23")
    # ---- 24. sequence parallelism: ring, Ulysses, block-sharded pools, handoffs
    p24, seq_entries = seq_phase(torch, pa, smi)
    no_plain_taken("phase 24")
    # ---- 25. the whole deployment: the port's plane, two CLI workers, the SDK
    p25 = deployment_phase(torch, pa, smi, prompts)
    no_plain_taken("phase 25")
    # ---- 26. the native index, seq x model meshes, migration under TP, stages
    p26, mesh_entries = mesh_phase(torch, pa, smi, check, guard)
    no_plain_taken("phase 26")
    # ---- 27. images without Pillow: the fixtures' photos through the vision engine
    p27 = photo_phase(torch, pa, smi)
    no_plain_taken("phase 27")
    # ---- 28. the gRPC stage plane: a pipeline over StreamForward, a streamed handoff
    p28 = grpc_phase(torch, pa, smi)
    no_plain_taken("phase 28")
    # ---- 29. zstd frames and YAML configs on the standard library
    p29 = zstd_phase(torch, pa, smi)
    for e in kernels:
        if e["name"] in ("ragged_paged_attention", "paged_decode_attention_fused"):
            e["launches"] += (p20[e["name"]] + p21[e["name"]] + p23["bf16"][e["name"]]
                              + p25[e["name"]] + p26["bf16"][e["name"]] + p27[e["name"]]
                              + p28["bf16"][e["name"]])
        elif e["name"] in ("ragged_paged_attention[int8]", "paged_decode_attention_fused[int8]"):
            base = e["name"].split("[")[0]
            e["launches"] += (p22[base] + p23["int8"][base] + p24[base] + p26["int8"][base]
                              + p28["int8"][base] + p29[base])
        elif e["name"] == "qmm_w8a16[int8]":
            e["launches"] += (p20["qmm_w8a16"] + p21["qmm_w8a16"] + p22["qmm_w8a16"]
                              + p23["int8"]["qmm_w8a16"] + p23["bf16"]["qmm_w8a16"]
                              + p24["qmm_w8a16"] + p25["qmm_w8a16"]
                              + p26["int8"]["qmm_w8a16"] + p26["bf16"]["qmm_w8a16"]
                              + p28["bf16"]["qmm_w8a16"] + p28["int8"]["qmm_w8a16"]
                              + p29["qmm_w8a16"])
    kernels += tp_entries + seq_entries + mesh_entries

    print(f"[done] chip_smoke.py ran in {time.perf_counter() - t_start:.1f} s; the host's "
          f"lowest available memory {guard.low:.1f} GiB", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
