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
    (counters zeroed before, read after).

The last four lines are the script's seconds, the kernels JSON (every entry
with ``ms`` and ``graph_ms``; ``@long`` entries for phase 10), the
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

def ragged_round_case(torch, dev, window=None):
    """One ragged round at serving shapes: 8 rows x 256-wide bucket mixing
    decode rows, 256-wide chunk rows (first and continuing), a pad row, a
    row over a cached prefix (its table shares another row's first 8
    pages) and a short chunk with a padded tail."""
    rng = np.random.default_rng(1)
    b, s = 8, 256
    n = 1 + b * M
    kp = torch.tensor(rng.standard_normal((n, HKV, BK, D)), dtype=torch.bfloat16, device=dev)
    vp = torch.tensor(rng.standard_normal((n, HKV, BK, D)), dtype=torch.bfloat16, device=dev)
    q = torch.tensor(rng.standard_normal((b, s, NH, D)), dtype=torch.bfloat16, device=dev)
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


def decode_case(torch, dev):
    """One decode step of 8 rows of different lengths, one inactive, on
    two-layer stacked pools (layer 1 addressed)."""
    rng = np.random.default_rng(2)
    b, L = 8, 2
    n = 1 + b * M
    kp = torch.tensor(rng.standard_normal((L, n, HKV, BK, D)), dtype=torch.bfloat16, device=dev)
    vp = torch.tensor(rng.standard_normal((L, n, HKV, BK, D)), dtype=torch.bfloat16, device=dev)
    q = torch.tensor(rng.standard_normal((b, 1, NH, D)), dtype=torch.bfloat16, device=dev)
    nk = torch.tensor(rng.standard_normal((b, 1, HKV, D)), dtype=torch.bfloat16, device=dev)
    nv = torch.tensor(rng.standard_normal((b, 1, HKV, D)), dtype=torch.bfloat16, device=dev)
    tables = np.arange(1, n, dtype=np.int32).reshape(b, M)
    lens = np.array([1, 17, 96, 129, 300, 513, 0, 632], np.int32)   # row 6 inactive
    tables[6] = 0
    pos = (lens - 1).astype(np.int32)[:, None]
    t = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)  # noqa: E731
    return q, nk, nv, kp, vp, 1, t(tables), t(pos), t(lens), lens


def ragged_cost(tables, pos, lens, window, kv_bytes=2, scale_bytes=0):
    """(bytes, flops) the ragged round needs: q of the live positions once,
    out of every position once (pad outputs are written as zeros), K and V
    of each distinct (page, slot) that some row's visible key range covers
    once (a prefix two rows share is read once; ``kv_bytes`` per element
    and ``scale_bytes`` per token of each pool), tables/positions/lengths
    once; 4*D flops per visible (query head, key) pair."""
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
    nbytes = ((live_q + b * s) * NH * D * 2 + keys * (HKV * D * kv_bytes + scale_bytes) * 2
              + (b * tables.shape[1] + b * s + b) * 4)
    return nbytes, 4 * D * NH * pairs


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


def decode_cost(lens, kv_bytes=2, scale_bytes=0, m=None):
    """(bytes, flops) of one fused decode step: the active rows' q once,
    every row's out once, the active rows' new K/V read once (bf16) and
    written once (``kv_bytes`` per element, ``scale_bytes`` per token of
    each pool), the context already in the pool (kv_len - 1 keys per active
    row) read once, tables ([B, m], m = M unless given)/positions/lengths
    once; 4*D flops per (query head, key) pair over the whole context, the
    new key included."""
    b = len(lens)
    active = lens[lens > 0]
    a, ctx = len(active), int(active.sum())
    token = HKV * D * kv_bytes + scale_bytes
    nbytes = (a * NH * D * 2 + b * NH * D * 2
              + a * (HKV * D * 2 + token) * 2
              + (ctx - a) * token * 2
              + (b * (M if m is None else m) + 2 * b) * 4)
    return nbytes, 4 * D * NH * ctx


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
    return pool[tables.long()].permute(0, 2, 1, 3, 4).reshape(b, HKV, m * BK, D)


def sdpa_call(torch, q_bshd, kc, vc, pos, lens):
    """scaled_dot_product_attention over contiguous context with the same
    visibility mask; GQA by expanding the kv heads (outside the timing)."""
    import torch.nn.functional as F

    b, s = pos.shape
    j = kc.shape[2]
    key = torch.arange(j, device=q_bshd.device)
    mask = (key[None, None, :] <= pos[:, :, None]) & (key[None, None, :] < lens[:, None, None])
    qh = q_bshd.transpose(1, 2).contiguous()
    rep = NH // HKV
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


def ragged_times(torch, pa, ref, flush, tag, case, kind):
    """:func:`time_attention` of the ragged kernel on ``ragged_in``'s
    ``case`` (pools in ``kind``); SDPA runs on the dequantized context."""
    q, kq, vq, ks, vs, tables, pos, lens, host = case
    fn = lambda: pa.ragged_paged_attention(q, kq, vq, tables, pos, lens, BK,  # noqa: E731
                                           k_scale=ks, v_scale=vs)
    plain = lambda: ref(q, kq, vq, tables, pos, lens, BK, k_scale=ks, v_scale=vs)  # noqa: E731
    lib = sdpa_call(torch, q, gathered(torch, dequantized(torch, kq, ks), tables),
                    gathered(torch, dequantized(torch, vq, vs), tables), pos, lens)
    return time_attention(torch, tag, flush, fn, plain, lib,
                          ragged_cost(*host, None, *KV_BYTES[kind]))


def decode_times(torch, pa, flush, tag, case, kind):
    """:func:`time_attention` of the fused decode kernel on ``decode_in``'s
    ``case`` (the plain version writes into copies of the pools), then the
    kernel as a CUDA graph with each of SPLIT_SWEEP keys a split (one line;
    the plan the wrapper takes is marked)."""
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
                           decode_cost(lens_np, *KV_BYTES[kind], m=m))
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
    the card through both attention kernels."""
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
    return errs, counts


# ---------------------------------------------------------------- phases

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
    small_model_phase(torch, pa)

    print(f"[done] chip_smoke.py ran in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
