#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

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
    from a JSON config in a temp dir (``engines.llm``: llama3-8b with int8
    weights and the default bf16 KV pool; the direct server on port 0;
    polls every 0.05 s, heartbeats every 0.5 s; 8 concurrent jobs) against
    :class:`StandInPlane`, the plane's worker routes on ``http.server``
    (HMAC-checked, epoch-fenced). It registers with a topology naming the
    card; one direct ``POST /inference/stream`` and the 8 serving prompts
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
    Each finished stream is re-scored by one teacher-forced forward: every
    committed token is the target's argmax except at a near-tie, where its
    own logit lies less than 0.05 below the argmax's (so that position's
    top-2 gap is below 0.05; each exception printed with both), a runner-up
    planted at the widest gap is rejected, and where a
    stream parts from the run without speculation the first divergence is
    printed with its gap. (b) After the requests the allocator's free and
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
    one spec wave of the batcher; (a) on their streams, the decoder's
    stats, and the plain tree verify timed. (h) The worker's
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
    all 8 decode together on B; the one-shot streams and the streamed
    ones past one chunk equal A's exactly (the same prefill arithmetic), a
    streamed prompt within one chunk prefills as one single-row chunk,
    so where it parts both runs' top-2 logits (the logits each committed
    from) are printed with a re-score; pushes of prompts past one chunk
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
    calm replay of the 8 prompts, both tokens there lie less than 0.05
    below the argmax of one teacher-forced re-score (its top-2 and both
    deficits printed: the near-tie rule of phases 11, 13 and 15, since a
    resume recomputes its checkpoint's tokens as a prefill chunk and the
    batches differ); all three kernels launched (counters zeroed before
    the phase, read after the calm replay and before the re-score).
    Information: kill → requeue seconds, requeue → first token on the
    member that resumed the job (member 1 once its stall ends, or the
    restarted member 0), the restart's cold start, the kill's offset from
    the start of the traffic, job latency from queue to completion, and
    the ms a token of the resumed jobs against the calm replay's.

The last four lines are the script's seconds, the kernels JSON (every entry
with ``ms`` and ``graph_ms``; ``@long`` entries for phase 10, ``@d32``
entries for phase 12, ``@verify`` / ``@m40`` entries for phase 15), the
nvidia-smi line and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import http.client
import json
import subprocess
import sys
import threading
import time

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


def serve(torch, pa, llm, prompts, shared):
    """8 concurrent requests of 32 greedy tokens plus one prefix hit
    through ``TorchLLMEngine.inference``, with the launch counters zeroed
    just before and read just after. → (tokens of the 8 requests by
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
    if hit["usage"]["cached_tokens"] < 128:
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
    their logits must agree within LOGITS_REL_BOUND."""
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

    with torch.no_grad():
        k_pre, k_step = run_forward()
        with plain_kernels():
            p_pre, p_step = run_forward()
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
    print(f"[long] fused decode {kind} 8 rows at kv 4096 (M {LONG_M}, split plan "
          f"{pa.kv_split_plan(LONG_M, BK)}): max_abs_err {d_err:.3e} max_vector_rel_err "
          f"{d_vec:.3e} (bound atol {FUSED_ATOL} rtol {RTOL}, vector {VEC_REL}); two calls "
          f"bitwise equal: {same}; code pools bit-identical after the write: {pools_equal}; "
          f"scale pools bit-identical: {scales_equal}", flush=True)
    if not (ok and same and pools_equal and scales_equal):
        raise AssertionError(f"fused decode {kind} kernel disagrees at the long shape")
    return r_err, d_err


# ---------------------------------------------------------------- serving surface

HTTP_TIMEOUT = 120.0        # socket timeout of every client call of phase 11


class SmokeWorker:
    """The worker surface ``DirectServer`` reads: shared serving claims up
    to ``cap`` and a checkpoint store fed by the engine's
    ``checkpoint_sink``, read back by ``adopt_stream_checkpoint``."""

    def __init__(self, engine, cap=8):
        from distributed_gpu_inference_torch.utils.data_structures import WorkerState

        self.state = WorkerState.IDLE
        self.engines = {"llm": engine}
        self.cap, self.active = cap, 0
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
        return False            # the batcher-backed engine takes shared claims

    def end_job(self):
        pass

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

    t_phase = time.perf_counter()
    plane = StandInPlane()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_worker_")
    workers = []
    try:
        path = f"{tmp.name}/worker.json"
        with open(path, "w") as f:
            json.dump({
                "name": "chip-smoke", "server": {"url": plane.url},
                "engines": {"llm": {"model": model, "quantization": quantization}},
                "direct": {"enabled": True, "host": "127.0.0.1", "port": 0},
                "poll_interval_s": 0.05, "heartbeat_interval_s": 0.5,
                "load_control": {"max_concurrent_jobs": 8},
            }, f)
        pa.reset_launch_counts()
        mem0 = torch.cuda.memory_allocated()
        th_a, wa = start_cli_worker(path)
        workers.append((th_a, wa))
        llm = wa.engines["llm"]
        vocab = llm.engine.model_cfg.vocab_size
        tok = llm.tokenizer
        reg = plane.registrations[-1]
        card = torch.cuda.get_device_name(0)
        print(f"[worker] worker A up through the CLI ({model}, {quantization} weights): "
              f"registered as {wa.api.worker_id}, topology {reg['topology']}", flush=True)
        if reg["topology"]["chip_type"] != card:
            raise AssertionError(f"registered topology does not name the card {card}")

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


def check_greedy(torch, tag, engine, rows, plain_rows=None):
    """Check (a) of phase 15: every committed token is the target's argmax
    under one teacher-forced re-score, but for near-ties — a token whose
    logit lies less than NEAR_TIE below the argmax's, which needs a top-2
    gap below NEAR_TIE there (each printed with both numbers); a
    runner-up planted at the widest-gap position must be
    rejected; where a row parts from ``plain_rows`` (the same requests
    without speculation) the first divergence is printed with its gap."""
    scores = rescore(torch, engine, rows)
    bad, ties = greedy_misses(rows, scores)
    for r, j, tok, first, short in ties:
        print(f"[{tag}] (a) near-tie exception: request {r} token {j}: committed {tok}, "
              f"argmax {first}: its logit {short:.4f} below the argmax's (top-2 gap "
              f"{scores[r][j][2]:.4f})", flush=True)
    if bad:
        raise AssertionError(f"[{tag}] committed tokens that are not the target's greedy "
                             f"choice (row, index, token, argmax, logit deficit): {bad}")
    r, j = max(((r, j) for r, sc in enumerate(scores) for j in range(len(sc))),
               key=lambda rj: scores[rj[0]][rj[1]][2])
    planted = list(rows[r][1])
    planted[j] = scores[r][j][1]
    caught, _ = greedy_misses([(rows[r][0], planted)],
                              rescore(torch, engine, [(rows[r][0], planted)]))
    print(f"[{tag}] (a) {sum(len(t) for _, t in rows)} committed tokens re-scored: all the "
          f"target's argmax but {len(ties)} near-tie(s) (gap < {NEAR_TIE}); the runner-up "
          f"planted at request {r} token {j} (gap {scores[r][j][2]:.4f}) rejected: "
          f"{any(x[1] == j for x in caught)}", flush=True)
    if scores[r][j][2] < NEAR_TIE or not any(x[1] == j for x in caught):
        raise AssertionError(f"[{tag}] the greedy check accepts a planted flip")
    for i, ((_, toks), (_, want)) in enumerate(zip(rows, plain_rows or [])):
        d = next((k for k, (a, b) in enumerate(zip(toks, want)) if a != b), None)
        if d is not None:
            print(f"[{tag}] (a) request {i} parts from the run without speculation at token "
                  f"{d}: {toks[d]} vs {want[d]}, top-2 gap there {scores[i][d][2]:.4f}",
                  flush=True)
    if plain_rows is not None:
        same = sum(a == b for (_, t1), (_, t2) in zip(rows, plain_rows) for a, b in zip(t1, t2))
        print(f"[{tag}] (a) tokens equal to the run without speculation: {same}/"
              f"{sum(len(t) for _, t in rows)}", flush=True)


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


def spec_pass(torch, pa, tag, llm, plain, prompts, quantized):
    """Checks (a)-(c) and (h) on a speculating ``TorchLLMEngine`` and the
    same engine without speculation (``plain``, the same weights). → (the
    spec run's launches, its routes, its rows)."""
    from types import SimpleNamespace

    from distributed_gpu_inference_torch.worker import main as wmain

    rows, wall, counts, routes = spec_serve(torch, pa, llm, prompts, SPEC_TOKENS)
    stats = llm.engine.get_stats()
    n_tok = len(prompts) * SPEC_TOKENS
    print(f"[{tag}] {len(prompts)} requests x {SPEC_TOKENS} greedy tokens, K={SPEC_K}: "
          f"{wall:.2f} s = {n_tok / wall:.1f} tok/s end to end (information)", flush=True)
    check_routes(tag, counts, routes, stats, quantized)
    prows, pwall, _, _ = spec_serve(torch, pa, plain, prompts, SPEC_TOKENS)
    print(f"[{tag}] without speculation: {pwall:.2f} s = {n_tok / pwall:.1f} tok/s end to "
          f"end (information)", flush=True)
    check_greedy(torch, tag, llm.engine, rows, prows)
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
    wave; check (a) on their streams, the decoder's stats, and the plain
    tree verify (``forward_tree_chunk``) timed at that wave's shape."""
    from distributed_gpu_inference_torch.models import llama
    from distributed_gpu_inference_torch.runtime.speculative import TreeTopology
    from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine

    # a 50 ms admission latch: the pair forms one admission, so one wave
    llm = TorchLLMEngine({**base, "engine": "jax-speculative",
                          "spec_widths": list(SPEC_WIDTHS), "params": params,
                          "serving": {"max_wait_ms": 50.0}})
    llm.load_model()
    try:
        rows, wall, counts, _ = spec_serve(torch, pa, llm, prompts, SPEC_TOKENS)
        stats = llm.serving.get_stats()
        print(f"[spec tree] widths {SPEC_WIDTHS}: {len(prompts)} requests x {SPEC_TOKENS} "
              f"greedy tokens in {wall:.2f} s; batcher spec_waves {stats['spec_waves']}, "
              f"spec_completed {stats['spec_completed']}; decoder stats {stats['spec']}; "
              f"launches {counts}", flush=True)
        if stats["spec_waves"] < 1 or stats["spec_completed"] != len(prompts):
            raise AssertionError("the batcher did not route the greedy pair to a spec wave")
        check_greedy(torch, "spec tree", llm.engine, rows)
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
    """Phase 15 (see the module docstring). → the kernels-JSON entries of
    the verify shapes."""
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
    return entries


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
    sample takes, kept on the device and keyed afterwards by (the row's
    request ``session_id``, the position sampled) — the PD key and
    prompt_len + index of the token. The decode-time logits a greedy
    stream was committed from (a re-score runs other kernels)."""

    def __init__(self, torch, engines, prefix):
        self.torch, self.engines, self.prefix, self.calls = torch, engines, prefix, []
        for eng in engines:
            real = eng._sample

            def sample(logits, rows, positions, mode, _real=real, _eng=eng):
                rows = list(rows)
                keys = [(s.request.session_id if (s := _eng.slots[i]) is not None else None)
                        for i in rows]
                if any(k and k.startswith(self.prefix) for k in keys):
                    top = logits.float().topk(8, dim=-1)
                    pos = positions if isinstance(positions, self.torch.Tensor) else \
                        self.torch.as_tensor(np.asarray(positions))
                    self.calls.append((keys, pos.clone(), top.values, top.indices))
                return _real(logits, rows, positions, mode)

            eng._sample = sample

    def close(self):
        for eng in self.engines:
            del eng._sample
        self.table = {}
        for keys, pos, vals, idx in self.calls:
            pos, vals, idx = pos.tolist(), vals.tolist(), idx.tolist()
            for r, k in enumerate(keys):
                if k and k.startswith(self.prefix) and pos[r] > 0:
                    self.table[(k, int(pos[r]))] = (vals[r], idx[r])
        self.calls = []

    def deficit(self, key, pos, token):
        """(the sample's top-2 as text, how far ``token``'s logit lay below
        the argmax's there: a lower bound when it was not in the top 8)."""
        vals, idx = self.table.get((key, pos), (None, None))
        if vals is None:
            return "not recorded", float("inf")
        top = f"id {idx[0]} {vals[0]:.4f} / id {idx[1]} {vals[1]:.4f}"
        return top, (vals[0] - vals[idx.index(token)] if token in idx
                     else vals[0] - vals[-1])


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
        ttft = {}
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
            # A's hybrid run prefilled each prompt as a one-shot PD prefill
            # does (one forward over the batch width when the prompt fits a
            # chunk, single-row chunks beyond), so the one-shot PD streams
            # and the streamed ones past one chunk must equal it exactly; a
            # streamed prompt within one chunk prefills as one single-row
            # chunk, which rounds otherwise: where it parts, both runs'
            # top-2 are printed with the re-score's, and whether the two
            # tokens lie within NEAR_TIE in either run's own logits
            multi = [len(ids) > PD_BUCKETS[-1] for ids, _ in rows]
            scores = rescore(torch, b.engine, rows) if mode == "streamed" else None
            parts, unequal = [], []
            for r, (ids, toks_) in enumerate(rows):
                want = hyb_rows[r]
                d = next((k for k, (x, y) in enumerate(zip(toks_, want)) if x != y), None)
                if d is None:
                    continue
                if mode == "one-shot" or multi[r]:
                    unequal.append((r, d))
                    continue
                top_b, short_b = trace.deficit(f"pd-b-{mode}-{r}", len(ids) + d, want[d])
                top_a, short_a = hyb_trace.deficit(f"pd-h-{r}", len(ids) + d, toks_[d])
                parts.append(f"request {r} token {d}: PD {toks_[d]} vs hybrid {want[d]}; "
                             f"PD top-2 {top_b}, the hybrid token {short_b:.4f} below; "
                             f"hybrid top-2 {top_a}, the PD token {short_a:.4f} below; "
                             f"within {NEAR_TIE}: {min(short_a, short_b) < NEAR_TIE} "
                             f"(re-score: top-2 {scores[r][d][0]} / {scores[r][d][1]}, "
                             f"gap {scores[r][d][2]:.4f})")
            same = sum(x == y for (_, t), h in zip(rows, hyb_rows) for x, y in zip(t, h))
            # information: the serving run before this phase admitted the
            # same prompts together in ragged rounds (other prefill shapes)
            batched = sum(x == y for (ids, t) in rows
                          for x, y in zip(t, hyb_ids.get(tuple(ids), [])))
            line = (f"[pd] {tag} (b) 8 prompts PD {mode}"
                    + (f" (pieces of {PD_PIECE_BLOCKS} blocks)" if mode == "streamed" else "")
                    + f", decoding together on B (up to {peak[0]} slots a round): {same}/"
                    f"{sum(len(t) for _, t in rows)} tokens equal to A's hybrid run, "
                    f"{sum(multi) if mode == 'streamed' else len(rows)} streams held equal: "
                    f"{not unequal} {unequal or ''}; {batched} tokens equal to the batched "
                    f"serving run (information)")
            if mode == "streamed":
                bad, ties = greedy_misses(rows, scores)
                early = [o[0]["bytes_before_first_token"]
                         for o, m in zip(out, multi) if m]
                line += (f"; where a one-chunk prompt parts: {parts or 'nowhere'}; re-scored "
                         f"(information): {len(bad)} tokens not the argmax by {NEAR_TIE} or "
                         f"more, {len(ties)} near-tie(s); bytes before the first token of the "
                         f"{len(early)} prompts past one {PD_BUCKETS[-1]}-token chunk: {early}")
                if not early or not all(x > 0 for x in early):
                    raise AssertionError(f"[pd] {tag} (b): no bytes before the first token")
            print(line, flush=True)
            if unequal or peak[0] < 2:
                raise AssertionError(f"[pd] {tag} (b) {mode}: streams part from A's hybrid run "
                                     f"{unequal}, peak {peak[0]}")
            vocab = a.engine.model_cfg.vocab_size
            if any(len(t) != PD_TOKENS or not all(0 <= x < vocab for x in t) for _, t in rows):
                raise AssertionError(f"[pd] {tag} (b) {mode}: bad tokens {rows}")
        print(f"[pd] {tag} TTFT p50 of the 8 requests prefilled one after another "
              f"(information): PD "
              f"streamed {pctl(ttft['streamed'], 0.5):.1f} ms, PD one-shot "
              f"{pctl(ttft['one-shot'], 0.5):.1f} ms, A hybrid {pctl(hyb_ttft, 0.5):.1f} ms; "
              f"the batched serving run before the phase (all 8 admitted at once) "
              f"{pctl([p['ttft_ms'] for p in hyb_payloads], 0.5):.1f} ms ({smi})", flush=True)

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
    """Greedy byte-level BPE merges from ``text``: pre-tokenize with Llama
    3's split regex, then merge the most frequent adjacent pair (the
    largest pair among ties) ``n`` times, counts kept up to date word by
    word. → [(a, b), ...] in rank order."""
    import collections
    import re

    from distributed_gpu_inference_torch.utils.hf_tokenizer import (
        _bytes_to_unicode,
        translate_pattern,
    )

    table = _bytes_to_unicode()
    words = collections.Counter(
        "".join(table[b] for b in m.group(0).encode("utf-8"))
        for m in re.finditer(translate_pattern(LLAMA3_SPLIT), text))
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
    resumes)."""
    events, resumes, port = [], 0, first_port
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
        resumes += 1
        if resumes > 8:
            raise AssertionError(f"stream {sid}: more than 8 resumes")
        offset = events[-1]["offset"] if events else 0
        text = "".join(e.get("text_delta") or "" for e in events)
        req = dict(body, stream_id=sid, resume={"stream_id": sid, "offset": offset,
                                                "text_offset": len(text)})
        port = other_port
    raise AssertionError(f"stream {sid} did not finish in {deadline_s} s")


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
        stream_ids, resumed_streams = {}, 0
        for i, (events, resumes) in out.items():
            _, final, ids, text = split_stream(events)
            if final["offset"] != FLEET_TOKENS or text != tok.decode(ids):
                raise AssertionError(f"stream {i}: final {final}, text {text!r}")
            stream_ids[i], resumed_streams = ids, resumed_streams + (resumes > 0)
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

        # ---- calm replay: the near-tie rule where an output parts from it
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
        outputs += [(tuple(tok.encode(p)), stream_ids[i], f"stream {i}") for i, p in streams]
        torch.cuda.synchronize()
        counts = pa.launch_counts()    # the fleet's own launches: not the re-score's
        parted = []
        for prompt, ids, what in outputs:
            want = calm[prompt]
            d = next((k for k, (a, b) in enumerate(zip(ids, want)) if a != b), None)
            if d is not None:
                parted.append((prompt, ids, want, d, what))
        scores = rescore(torch, m1.llm.engine, [(p, i) for p, i, _, _, _ in parted]
                         + [(p, w) for p, _, w, _, _ in parted]) if parted else []
        worst = 0.0
        for n, (prompt, ids, want, d, what) in enumerate(parted):
            first, second, gap, mine = scores[n][d]
            theirs = scores[n + len(parted)][d][3]
            worst = max(worst, mine, theirs)
            print(f"[fleet] {what} parts from the calm replay at token {d}: {ids[d]} vs "
                  f"{want[d]}; the re-scored top-2 there: id {first} / id {second} (gap "
                  f"{gap:.4f}); deficit of the fleet's token {mine:.4f}, of the calm run's "
                  f"{theirs:.4f} (near-tie bound {NEAR_TIE})", flush=True)
        print(f"[fleet] {len(outputs)} outputs against the calm replay: {len(outputs) - len(parted)}"
              f" identical, {len(parted)} part at a near-tie", flush=True)
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
          f"and the calm replay; not the re-score): {counts}; phase ran in "
          f"{time.perf_counter() - t_phase:.1f} s ({smi})", flush=True)
    check_counts("fleet", counts, qmm=quantization is not None)
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
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
    llm = TorchLLMEngine({
        "model": "llama3-8b", "max_batch_size": SERVE_BATCH, "max_seq_len": MAX_SEQ,
        "enable_prefix_cache": True, "dtype": "bfloat16", "device": "cuda",
        "seed": 0, "quantization": "int8", "kv_cache_dtype": "int8",
    })
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

    # ---- 16. PD disaggregation, int8 pools: phase 7's engine is A
    pd_phase(torch, pa, smi, llm, prompts, (i8_tokens, payloads), "int8")
    llm.unload()
    del llm
    torch.cuda.empty_cache()

    # ---- 16. PD disaggregation, bf16 pools (int8 weights), and the worker roles
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

    # ---- 14. serving under pressure: spill tiers, fault seams, deadlines, flight
    resp = RespStandIn()
    try:
        for kv in (None, "int8"):
            spill_phase(torch, pa, smi, kv, resp)
    finally:
        resp.stop()
    flight_check(flight)

    # ---- 15. speculative decoding: integrated rounds and the tree decoder
    kernels += spec_phase(torch, pa, smi, prompts, lengths)

    # ---- 17. weights and tokenizer from local files
    local_files_phase(torch, pa, smi)

    # ---- 18. a fleet of two workers, killed, blacked out and restarted
    fleet_phase(torch, pa, smi, prompts)

    print(f"[done] chip_smoke.py ran in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
