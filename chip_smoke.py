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
LOGITS_REL_BOUND = 5e-2     # ||kernel - plain|| / ||plain|| over 32 layers
NH, HKV, D, BK = 32, 8, 128, 16
MAX_SEQ = 1024
M = MAX_SEQ // BK


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


def ragged_cost(tables, pos, lens, window):
    """(bytes, flops) the ragged round needs: q of the live positions once,
    out of every position once (pad outputs are written as zeros), K and V
    of each distinct (page, slot) that some row's visible key range covers
    once (a prefix two rows share is read once), tables/positions/lengths
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
    nbytes = ((live_q + b * s) * NH * D * 2 + keys * HKV * D * 2 * 2
              + (b * M + b * s + b) * 4)
    return nbytes, 4 * D * NH * pairs


def decode_cost(lens):
    """(bytes, flops) of one fused decode step: the active rows' q once,
    every row's out once, the active rows' new K/V read once and written
    once, the context already in the pool (kv_len - 1 keys per active row)
    read once, tables/positions/lengths once; 4*D flops per (query head,
    key) pair over the whole context, the new key included."""
    b = len(lens)
    active = lens[lens > 0]
    a, ctx = len(active), int(active.sum())
    nbytes = (a * NH * D * 2 + b * NH * D * 2
              + 2 * a * HKV * D * 2 * 2
              + (ctx - a) * HKV * D * 2 * 2
              + (b * M + 2 * b) * 4)
    return nbytes, 4 * D * NH * ctx


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


# ---------------------------------------------------------------- phases

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    from distributed_gpu_inference_torch.models import llama
    from distributed_gpu_inference_torch.ops import _build
    from distributed_gpu_inference_torch.ops import paged_attention as pa
    from distributed_gpu_inference_torch.ops.attention import paged_attention_ref
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
        "model": "llama3-8b", "max_batch_size": 8, "max_seq_len": MAX_SEQ,
        "enable_prefix_cache": True, "dtype": "bfloat16", "device": "cuda",
        "seed": 0,
    })
    llm.load_model()
    torch.cuda.synchronize()
    print(f"[serving] llama3-8b (32 layers, bf16, random weights seed 0) loaded in "
          f"{time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated", flush=True)
    vocab = llm.engine.model_cfg.vocab_size
    rng = np.random.default_rng(3)
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz ,.ABCDEFGHIJ"))
    shared = "".join(rng.choice(alphabet, 128))
    lengths = [64, 150, 233, 310, 388, 450, 530, 600]
    prompts = ["".join(rng.choice(alphabet, n)) for n in lengths]
    prompts[3] = shared + prompts[3][128:]
    prompts[6] = shared + prompts[6][128:]
    responses = []
    lock = threading.Lock()
    real_submit = llm.serving.submit

    def recording_submit(req, *a, **kw):
        resp = real_submit(req, *a, **kw)
        with lock:
            responses.append(resp)
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
    print(f"[serving] kernel launches on the main path: {launches}", flush=True)
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if len(responses) != 9 or any(r.error for r in responses):
        raise AssertionError(f"serving errors: {[r.error for r in responses]}")
    for r in responses:
        if len(r.token_ids) != 32 or not all(0 <= t < vocab for t in r.token_ids):
            raise AssertionError(f"bad tokens in {r.request_id}: {r.token_ids}")
    if any(p is None or p["usage"]["completion_tokens"] != 32 for p in payloads):
        raise AssertionError(f"bad payloads: {payloads}")
    if hit["usage"]["cached_tokens"] < 128:
        raise AssertionError(f"prefix cache missed: {hit['usage']}")
    ttft = sorted(p["ttft_ms"] for p in payloads)
    n_tok = sum(p["usage"]["completion_tokens"] for p in payloads)
    stats = llm.serving.get_stats()
    print(f"[serving] 8 concurrent requests (prompts {lengths} bytes, 2 sharing a "
          f"128-token prefix), 32 greedy tokens each: {n_tok} tokens in {wall:.2f} s "
          f"= {n_tok / wall:.1f} tok/s end to end; TTFT p50 {ttft[len(ttft) // 2]:.1f} ms; "
          f"prefix hit request cached {hit['usage']['cached_tokens']} tokens; "
          f"rounds {stats.get('decode_rounds')} ragged {stats.get('ragged_rounds')}",
          flush=True)

    # one full-width prefill + decode step through the kernels and through
    # the plain versions (fresh scratch pools, the served weights)
    cfg, params = llm.engine.model_cfg, llm.engine.params

    @contextlib.contextmanager
    def plain_attention():
        saved = (llama.ragged_paged_attention, llama.paged_decode_attention_fused)
        llama.ragged_paged_attention = paged_attention_ref
        llama.paged_decode_attention_fused = pa.paged_decode_attention_fused_plain
        try:
            yield
        finally:
            llama.ragged_paged_attention, llama.paged_decode_attention_fused = saved

    def run_forward():
        kv = llama.init_kv_pools(cfg, 1 + 2 * 17, BK, torch.bfloat16, dev)
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
        with plain_attention():
            p_pre, p_step = run_forward()
    for name, a, b in (("prefill", k_pre, p_pre), ("decode step", k_step, p_step)):
        rel = float(((a - b).norm() / b.norm()).item())
        agree = float((a.argmax(-1) == b.argmax(-1)).float().mean().item())
        print(f"[serving] forward_chunk {name} logits, kernels vs plain: rel L2 err "
              f"{rel:.3e} (bound {LOGITS_REL_BOUND}), argmax agreement {agree:.2f}",
              flush=True)
        if not (rel <= LOGITS_REL_BOUND and np.isfinite(rel)):
            raise AssertionError(f"{name} logits drift beyond the bound: {rel}")
    llm.unload()
    del llm, params
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
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
