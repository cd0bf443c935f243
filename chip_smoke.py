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
   source, in parallel) and prints the build seconds and ptxas' resource
   lines;
3. kernel parity at llama3-8b widths (Nh 32, Hkv 8, D 128, Bk 16, bf16):
   each kernel against its plain PyTorch version on the card;
4. serving — ``TorchLLMEngine`` for llama3-8b at full depth in bf16 with
   seeded random weights serves 8 concurrent requests (plus one prefix-
   cache hit) through ``BatcherServing``; the kernels' launch counters are
   zeroed just before and read just after; then one full-width
   ``forward_chunk`` prefill and decode step run through the kernels and
   through the plain versions and their logits are compared;
5. times — each kernel at the serving shapes (CUDA events, median of 30
   calls, L2 flushed before each), its bound on the card, its plain
   version and ``scaled_dot_product_attention`` on the same context
   gathered contiguous (a yardstick only; the port never calls it).

Quantized serving (int8 / fp8 weights through the W8A16 kernel, int8 / fp8
KV pools through both attention kernels):

6. quantized parity at llama3-8b widths — the quantized matmul (int8 and
   fp8 codes) at every projection shape at M = 8 and at the row bound, all
   32 layers' indexing on one shape; the ragged and fused kernels over int8
   and fp8 pools, with code and scale pools bit-identical after the fused
   write and the negative control on the int8 paths;
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
   bf16 weights; the kernel against the library route at M in {8, ...,
   256}, which sets the dispatch bound; the int8 and fp8 attention variants
   at the phase-5 shapes.

The last three lines are the kernels JSON, the nvidia-smi line and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
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
              + (b * M + b * s + b) * 4)
    return nbytes, 4 * D * NH * pairs


def decode_cost(lens, kv_bytes=2, scale_bytes=0):
    """(bytes, flops) of one fused decode step: the active rows' q once,
    every row's out once, the active rows' new K/V read once (bf16) and
    written once (``kv_bytes`` per element, ``scale_bytes`` per token of
    each pool), the context already in the pool (kv_len - 1 keys per active
    row) read once, tables/positions/lengths once; 4*D flops per (query
    head, key) pair over the whole context, the new key included."""
    b = len(lens)
    active = lens[lens > 0]
    a, ctx = len(active), int(active.sum())
    token = HKV * D * kv_bytes + scale_bytes
    nbytes = (a * NH * D * 2 + b * NH * D * 2
              + a * (HKV * D * 2 + token) * 2
              + (ctx - a) * token * 2
              + (b * M + 2 * b) * 4)
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
    """A quantized pool [N, Hkv, Bk, D] as bf16 (int8: code * its token's
    scale), for the library yardstick."""
    if scale is None:
        return pool.to(torch.bfloat16)
    return (pool.float() * scale.float()[:, None, :, None]).to(torch.bfloat16)


def quantized_pools(torch, kp, vp, kind):
    """bf16 pools (one layer [N, ...] or stacked [L, N, ...]) → (k, v,
    k_scale, v_scale) in ``kind`` ("int8" with per-token scales, "fp8")."""
    from distributed_gpu_inference_torch.ops.attention import quantize_kv_pool
    from distributed_gpu_inference_torch.ops.quantization import to_float8_e4m3

    if kind == "fp8":
        return to_float8_e4m3(kp), to_float8_e4m3(vp), None, None
    if kp.dim() == 4:
        (kq, ks), (vq, vs) = quantize_kv_pool(kp), quantize_kv_pool(vp)
        return kq, vq, ks, vs
    ks = [quantize_kv_pool(kp[i]) for i in range(kp.shape[0])]
    vs = [quantize_kv_pool(vp[i]) for i in range(vp.shape[0])]
    return (torch.stack([c for c, _ in ks]), torch.stack([c for c, _ in vs]),
            torch.stack([x for _, x in ks]), torch.stack([x for _, x in vs]))


def raw(torch, t):
    """A tensor's bits, for bit-identity checks (NaN codes included)."""
    return t.view(torch.uint8) if t.element_size() == 1 else t.view(torch.int16)


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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"nvidia-smi: {smi}", flush=True)

    # ---- 2. build
    secs = _build.build()
    print(f"[build] kernels built in {secs:.1f} s", flush=True)
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
    if not (launches["ragged_paged_attention"] > 0
            and launches["paged_decode_attention_fused"] > 0):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    report_serving("serving", lengths, payloads, hit, wall, stats)
    compare_forward(torch, "serving", llm.engine.model_cfg, llm.engine.params,
                    torch.bfloat16, dev)
    llm.unload()
    del llm
    torch.cuda.empty_cache()

    # ---- 5. times at the serving shapes
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    q, kp, vp, tables, pos, lens, host = ragged_round_case(torch, dev)
    ragged_ms = time_ms(torch, lambda: pa.ragged_paged_attention(q, kp, vp, tables, pos, lens, BK), flush)
    ragged_plain = time_ms(torch, lambda: paged_attention_ref(q, kp, vp, tables, pos, lens, BK), flush, iters=20)
    ragged_lib = time_ms(torch, sdpa_call(torch, q, gathered(torch, kp, tables),
                                          gathered(torch, vp, tables), pos, lens), flush)
    r_bytes, r_flops = ragged_cost(*host, None)
    r_bound, r_by = bound(r_bytes, r_flops)

    q, nk, nv, kp, vp, layer, tables, pos, lens, lens_np = decode_case(torch, dev)
    kp2, vp2 = kp.clone(), vp.clone()
    dec_ms = time_ms(torch, lambda: pa.paged_decode_attention_fused(
        q, nk, nv, kp, vp, layer, tables, pos, lens, BK), flush)
    dec_plain = time_ms(torch, lambda: pa.paged_decode_attention_fused_plain(
        q, nk, nv, kp2, vp2, layer, tables, pos, lens, BK), flush, iters=20)
    dec_lib = time_ms(torch, sdpa_call(torch, q, gathered(torch, kp[layer], tables),
                                       gathered(torch, vp[layer], tables), pos, lens), flush)
    d_bytes, d_flops = decode_cost(lens_np)
    d_bound, d_by = bound(d_bytes, d_flops)
    print(f"[times] ragged round 8x256 (Nh 32, Hkv 8, D 128): kernel {ragged_ms:.4f} ms, "
          f"plain {ragged_plain:.4f} ms, sdpa {ragged_lib:.4f} ms, bound {r_bound:.4f} ms "
          f"({r_by}: {r_bytes} B, {r_flops} flop)", flush=True)
    print(f"[times] fused decode 8 rows (kv {lens_np.tolist()}): kernel {dec_ms:.4f} ms, "
          f"plain {dec_plain:.4f} ms, sdpa {dec_lib:.4f} ms, bound {d_bound:.4f} ms "
          f"({d_by}: {d_bytes} B, {d_flops} flop)", flush=True)

    src = "distributed_gpu_inference_torch/csrc/"
    pallas = "distributed_gpu_inference_tpu/ops/paged_attention_pallas.py"
    kernels = [
        {"name": "ragged_paged_attention", "route": "cuda",
         "source": src + "ragged_paged_attention.cu", "replaces": pallas + ":932",
         "launches": launches["ragged_paged_attention"],
         "max_abs_err": parity["ragged_paged_attention"], "ms": ragged_ms,
         "plain_ms": ragged_plain, "bound_ms": r_bound, "bound_by": r_by,
         "library_ms": ragged_lib},
        {"name": "paged_decode_attention_fused", "route": "cuda",
         "source": src + "paged_decode_fused.cu", "replaces": pallas + ":469",
         "launches": launches["paged_decode_attention_fused"],
         "max_abs_err": parity["paged_decode_attention_fused"], "ms": dec_ms,
         "plain_ms": dec_plain, "bound_ms": d_bound, "bound_by": d_by,
         "library_ms": dec_lib},
    ]
    del flush, q, kp, vp, kp2, vp2
    torch.cuda.empty_cache()

    # ---- 6. quantized parity at llama3-8b widths
    g = torch.Generator(device=dev).manual_seed(5)
    qparity = {}
    for mode in ("int8", "fp8"):
        worst = 0.0
        for kdim, ndim in PROJ_SHAPES:
            w = torch.randn((1, kdim, ndim), generator=g, device=dev) * kdim ** -0.5
            qw = quantize_weight(w, mode)
            for m in (8, qmm.MAX_KERNEL_ROWS):
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
            kq, vq, ks, vs = quantized_pools(torch, kp, vp, kv_kind)
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
        kq, vq, ks, vs = quantized_pools(torch, kp, vp, kv_kind)
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
    if not all(v > 0 for v in i8_launches.values()):
        raise AssertionError(f"a kernel of the int8 path never launched: {i8_launches}")
    report_serving("int8 serving", lengths, payloads, hit, wall, stats)
    same = sum(a == b for key in bf16_tokens for a, b in zip(bf16_tokens[key], i8_tokens[key]))
    total = sum(len(v) for v in bf16_tokens.values())
    print(f"[int8 serving] greedy tokens equal to the bf16 run (information): "
          f"{same}/{total} = {same / total:.3f}", flush=True)
    compare_forward(torch, "int8 serving", llm.engine.model_cfg, llm.engine.params,
                    torch.int8, dev)
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
    if not all(v > 0 for v in f8_launches.values()):
        raise AssertionError(f"a kernel of the fp8 path never launched: {f8_launches}")
    compare_forward(torch, "fp8 serving", cfg4, eng.params, torch.float8_e4m3fn, dev)
    del eng
    torch.cuda.empty_cache()

    # ---- 9. times of the quantized variants
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    qtimes = {}
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
            if name in ("wq", "wk", "w_gate", "w_down"):
                one = time_ms(torch, lambda: qmm.launch_kernel(xs[SERVE_BATCH][kdim], qw, sc),
                              flush)
                b1, f1 = qmm_cost(SERVE_BATCH, [(kdim, ndim)])
                print(f"[qtimes] qmm {mode} {name} K={kdim} N={ndim} M={SERVE_BATCH}: kernel "
                      f"{one:.4f} ms, bound {bound(b1, f1)[0]:.4f} ms", flush=True)
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
        qtimes[f"qmm_w8a16[{mode}]"] = (k_ms, p_ms, q_bound, q_by, l_ms)
        del weights, deq, xs
    if qmm.MAX_KERNEL_ROWS < SERVE_BATCH:
        raise AssertionError("the qmm row bound is below max_batch_size")

    for kv_kind in ("int8", "fp8"):
        kv_bytes, scale_bytes = 1, (2 if kv_kind == "int8" else 0)
        q, kp, vp, tables, pos, lens, host = ragged_round_case(torch, dev)
        kq, vq, ks, vs = quantized_pools(torch, kp, vp, kv_kind)
        r_ms = time_ms(torch, lambda: pa.ragged_paged_attention(
            q, kq, vq, tables, pos, lens, BK, k_scale=ks, v_scale=vs), flush)
        r_plain = time_ms(torch, lambda: paged_attention_ref(
            q, kq, vq, tables, pos, lens, BK, k_scale=ks, v_scale=vs), flush, iters=20)
        r_lib = time_ms(torch, sdpa_call(torch, q, gathered(torch, dequantized(torch, kq, ks), tables),
                                         gathered(torch, dequantized(torch, vq, vs), tables),
                                         pos, lens), flush)
        rb, rf = ragged_cost(*host, None, kv_bytes, scale_bytes)
        r_b, r_by_q = bound(rb, rf)
        qtimes[f"ragged_paged_attention[{kv_kind}]"] = (r_ms, r_plain, r_b, r_by_q, r_lib)
        print(f"[qtimes] ragged round 8x256 {kv_kind} pools: kernel {r_ms:.4f} ms, plain "
              f"{r_plain:.4f} ms, sdpa on dequantized context {r_lib:.4f} ms, bound {r_b:.4f} ms "
              f"({r_by_q}: {rb} B, {rf} flop)", flush=True)
        q, nk, nv, kp, vp, layer, tables, pos, lens, lens_np = decode_case(torch, dev)
        kq, vq, ks, vs = quantized_pools(torch, kp, vp, kv_kind)
        kq2, vq2 = kq.clone(), vq.clone()
        ks2 = vs2 = None
        if ks is not None:
            ks2, vs2 = ks.clone(), vs.clone()
        d_ms = time_ms(torch, lambda: pa.paged_decode_attention_fused(
            q, nk, nv, kq, vq, layer, tables, pos, lens, BK, k_scale=ks, v_scale=vs), flush)
        d_plain = time_ms(torch, lambda: pa.paged_decode_attention_fused_plain(
            q, nk, nv, kq2, vq2, layer, tables, pos, lens, BK, k_scale=ks2, v_scale=vs2),
            flush, iters=20)
        lk = dequantized(torch, kq[layer], None if ks is None else ks[layer])
        lv = dequantized(torch, vq[layer], None if vs is None else vs[layer])
        d_lib = time_ms(torch, sdpa_call(torch, q, gathered(torch, lk, tables),
                                         gathered(torch, lv, tables), pos, lens), flush)
        db, df = decode_cost(lens_np, kv_bytes, scale_bytes)
        d_b, d_by_q = bound(db, df)
        qtimes[f"paged_decode_attention_fused[{kv_kind}]"] = (d_ms, d_plain, d_b, d_by_q, d_lib)
        print(f"[qtimes] fused decode 8 rows {kv_kind} pools: kernel {d_ms:.4f} ms, plain "
              f"{d_plain:.4f} ms, sdpa on dequantized context {d_lib:.4f} ms, bound "
              f"{d_b:.4f} ms ({d_by_q}: {db} B, {df} flop)", flush=True)

    qpallas = "distributed_gpu_inference_tpu/ops/qmm_pallas.py"
    meta = {"qmm_w8a16": ("qmm_w8a16", "qmm_w8a16.cu", qpallas + ":88"),
            "ragged_paged_attention": ("ragged_paged_attention", "ragged_paged_attention.cu",
                                       pallas + ":932"),
            "paged_decode_attention_fused": ("paged_decode_attention_fused",
                                             "paged_decode_fused.cu", pallas + ":469")}
    for variant, (ms, plain_ms, bound_ms, bound_by, lib_ms) in qtimes.items():
        base, mode = variant.split("[")
        mode = mode.rstrip("]")
        counter, source, replaces = meta[base]
        main_launches = (i8_launches if mode == "int8" else f8_launches)[counter]
        kernels.append({"name": variant, "route": "cuda", "source": src + source,
                        "replaces": replaces, "launches": main_launches,
                        "max_abs_err": qparity[variant], "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
