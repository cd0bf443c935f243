"""The port's attention kernels in their plain form (what a wrapper runs on
a CPU tensor) against the JAX package: the ragged plain version against
``paged_attention_xla`` over the ragged-round cases of
``tests/test_ragged_attention.py`` and against the Pallas
``ragged_paged_attention`` in interpret mode on a subset; the fused decode
plain version against the Pallas ``paged_decode_attention_fused`` in
interpret mode on both the output and the pools after the write.
Tolerance atol = rtol = 2e-5 in f32: only the summation order differs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from distributed_gpu_inference_torch.ops import paged_attention as tpa  # noqa: E402
from distributed_gpu_inference_torch.ops.attention import (  # noqa: E402
    dense_causal_attention,
    paged_attention_ref,
    write_kv_pages,
)
from distributed_gpu_inference_tpu.ops.attention import paged_attention_xla  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)


def _ragged(rows, nh, hkv, d, block, m, seed=0):
    """One ragged batch from per-row (span, kv_len) specs, queries at the
    TAIL of each row's context (span 0 = inactive row), as numpy."""
    rng = np.random.default_rng(seed)
    b = len(rows)
    s = max(max(span for span, _ in rows), 1)
    n = 1 + b * m
    k_pool = rng.standard_normal((n, hkv, block, d)).astype(np.float32)
    v_pool = rng.standard_normal((n, hkv, block, d)).astype(np.float32)
    q = rng.standard_normal((b, s, nh, d)).astype(np.float32)
    tables = np.zeros((b, m), np.int32)
    positions = np.full((b, s), -1, np.int32)
    lens = np.zeros((b,), np.int32)
    for i, (span, kv_len) in enumerate(rows):
        tables[i] = np.arange(1 + i * m, 1 + (i + 1) * m)
        lens[i] = kv_len
        if span:
            positions[i, :span] = np.arange(kv_len - span, kv_len)
    return q, k_pool, v_pool, tables, positions, lens


def _port(args, block, window=None):
    t = [torch.from_numpy(a) for a in args]
    return tpa.ragged_paged_attention(*t, block_size=block, window=window).numpy()


CASES = {
    "decode_only": ([(1, 9), (1, 23), (1, 64)], 4, 2, 64, 16, 4, None),
    "prefill_only": ([(32, 300)], 8, 4, 64, 16, 20, None),
    "mixed_spans": ([(1, 40), (3, 25), (16, 90), (1, 7)], 4, 2, 64, 16, 8, None),
    "mid_prompt_chunk": ([(16, 48), (1, 30)], 4, 2, 64, 16, 8, None),
    "inactive_row": ([(1, 12), (0, 0), (4, 20)], 4, 2, 64, 16, 2, None),
    "padded_tails": ([(8, 33), (2, 17), (1, 5)], 4, 2, 64, 16, 4, None),
    "window_4": ([(1, 150), (6, 80), (16, 200)], 4, 2, 64, 16, 16, 4),
    "window_16": ([(1, 150), (6, 80), (16, 200)], 4, 2, 64, 16, 16, 16),
    "wide_span": ([(48, 80), (1, 11)], 4, 2, 64, 16, 8, None),
    "head_dim_128": ([(1, 40), (16, 64), (0, 0)], 8, 2, 128, 16, 4, None),
    "block_8": ([(1, 21), (9, 30)], 4, 2, 64, 8, 6, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ragged_plain_matches_xla(case):
    rows, nh, hkv, d, block, m, window = CASES[case]
    args = _ragged(rows, nh, hkv, d, block, m)
    want = np.asarray(paged_attention_xla(*map(jnp.asarray, args), block,
                                          window=window))
    got = _port(args, block, window)
    np.testing.assert_allclose(got, want, **TOL)
    positions = args[4]
    # pad queries (inactive rows, padded tails) are EXACT zeros
    assert np.all(got[positions < 0] == 0.0)


@pytest.mark.parametrize("case", ["mixed_spans", "window_4", "head_dim_128"])
def test_ragged_plain_matches_pallas_interpret(case):
    from distributed_gpu_inference_tpu.ops.paged_attention_pallas import (
        ragged_paged_attention,
    )

    rows, nh, hkv, d, block, m, window = CASES[case]
    args = _ragged(rows, nh, hkv, d, block, m, seed=1)
    want = np.asarray(ragged_paged_attention(
        *map(jnp.asarray, args), block, window=window, interpret=True))
    np.testing.assert_allclose(_port(args, block, window), want, **TOL)


def test_window_excluding_everything_gives_zeros():
    # a query whose window holds no key below kv_len (kv_len far behind
    # the query position) sees nothing: exact zeros, not NaN
    q, k, v, tables, positions, lens = _ragged([(1, 20)], 4, 2, 64, 16, 4)
    positions[0, 0] = 60          # kv_len 20 < 60 - window + 1
    got = _port((q, k, v, tables, positions, lens), 16, window=8)
    assert np.all(got == 0.0) and np.isfinite(got).all()


def test_ref_matches_dense_attention_on_contiguous_context():
    rng = np.random.default_rng(2)
    b, s, nh, hkv, d, bk = 2, 24, 4, 2, 64, 8
    q = torch.from_numpy(rng.standard_normal((b, s, nh, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, s, hkv, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, s, hkv, d)).astype(np.float32))
    m = s // bk
    tables = torch.arange(1, 1 + b * m, dtype=torch.int32).reshape(b, m)
    pos = torch.arange(s, dtype=torch.int32).repeat(b, 1)
    kp = torch.zeros((1 + b * m, hkv, bk, d))
    vp = torch.zeros_like(kp)
    write_kv_pages(kp, k, tables, pos, bk)
    write_kv_pages(vp, v, tables, pos, bk)
    lens = torch.full((b,), s, dtype=torch.int32)
    for window in (None, 5):
        got = paged_attention_ref(q, kp, vp, tables, pos, lens, bk, window=window)
        want = dense_causal_attention(q, k, v, lengths=lens, window=window)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_pad_writes_are_dropped_not_wrapped():
    # position -1 must drop the write: it must neither wrap onto the LAST
    # block (what index -1 would hit) nor land in pad block 0
    pool = torch.zeros((5, 2, 4, 8))
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    pos = torch.tensor([[5, -1], [-1, -1]], dtype=torch.int32)
    new = torch.ones((2, 2, 2, 8))
    write_kv_pages(pool, new, tables, pos, 4)
    assert pool[2, :, 1].eq(1).all()                 # position 5 → block 2 slot 1
    assert pool.sum() == 2 * 8                       # nothing else written
    assert not pool[0].any() and not pool[4].any()


def _fused_case(window, seed):
    rng = np.random.default_rng(seed)
    L, b, nh, hkv, d, bk, m = 2, 4, 4, 2, 64, 16, 4
    n = 1 + b * m
    kp = rng.standard_normal((L, n, hkv, bk, d)).astype(np.float32)
    vp = rng.standard_normal((L, n, hkv, bk, d)).astype(np.float32)
    kp[:, 0] = vp[:, 0] = 0.0
    q = rng.standard_normal((b, 1, nh, d)).astype(np.float32)
    nk = rng.standard_normal((b, 1, hkv, d)).astype(np.float32)
    nv = rng.standard_normal((b, 1, hkv, d)).astype(np.float32)
    tables = np.arange(1, n, dtype=np.int32).reshape(b, m)
    lens = np.array([17, 40, 0, 64], np.int32)        # row 2 inactive
    pos = (lens - 1)[:, None].astype(np.int32)
    tables[2] = 0
    return q, nk, nv, kp, vp, tables, pos, lens, window


@pytest.mark.parametrize("window", [None, 8])
def test_fused_plain_matches_pallas_interpret(window):
    from distributed_gpu_inference_tpu.ops.paged_attention_pallas import (
        paged_decode_attention_fused,
    )

    q, nk, nv, kp, vp, tables, pos, lens, window = _fused_case(window, 3)
    layer = 1
    jout, jk, jv = paged_decode_attention_fused(
        *map(jnp.asarray, (q, nk, nv, kp, vp)), jnp.int32(layer),
        *map(jnp.asarray, (tables, pos, lens)), 16, window=window,
        interpret=True,
    )
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tout, tk2, tv2 = tpa.paged_decode_attention_fused(
        *map(torch.from_numpy, (q, nk, nv)), tk, tv, layer,
        *map(torch.from_numpy, (tables, pos, lens)), 16, window=window,
    )
    assert tk2 is tk and tv2 is tv                    # updated in place
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    # the write lands bit-identically, and only where it should
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert np.all(tout.numpy()[2] == 0.0)            # inactive row: zeros


def test_fused_write_is_visible_to_its_own_query():
    # a one-token context: the only visible key is the one written this
    # step, so the output is exactly that token's V row for every head
    rng = np.random.default_rng(4)
    kp = torch.zeros((1, 3, 2, 16, 64))
    vp = torch.zeros_like(kp)
    q = torch.from_numpy(rng.standard_normal((1, 1, 4, 64)).astype(np.float32))
    nk = torch.from_numpy(rng.standard_normal((1, 1, 2, 64)).astype(np.float32))
    nv = torch.from_numpy(rng.standard_normal((1, 1, 2, 64)).astype(np.float32))
    tables = torch.tensor([[1, 2]], dtype=torch.int32)
    out, _, _ = tpa.paged_decode_attention_fused(
        q, nk, nv, kp, vp, 0, tables, torch.zeros((1, 1), dtype=torch.int32),
        torch.ones(1, dtype=torch.int32), 16,
    )
    want = nv[0, 0].repeat_interleave(2, dim=0)       # head h reads kv h // 2
    np.testing.assert_allclose(out[0, 0].numpy(), want.numpy(), **TOL)


def test_cpu_tensors_take_the_plain_version_without_launching():
    tpa.reset_launch_counts()
    args = [torch.from_numpy(a) for a in _ragged([(2, 9)], 4, 2, 64, 16, 2)]
    tpa.ragged_paged_attention(*args, block_size=16)
    tpa.qmm_w8a16(torch.ones((2, 16), dtype=torch.bfloat16),
                  torch.ones((16, 16), dtype=torch.int8), torch.ones((1, 16)))
    assert tpa.launch_counts() == {
        "ragged_paged_attention": 0, "paged_decode_attention_fused": 0,
        "qmm_w8a16": 0,
    }


# --------------------------------------------------------------------------
# The key-split plan of the fused decode kernel (and of the ragged kernel
# when it splits), and the merge of per-split partial softmax states
# --------------------------------------------------------------------------


class _RecordTorchCalls(torch.overrides.TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.calls.append(func)
        return func(*args, **(kwargs or {}))


def _split_of_key(j, pages, block):
    return j // (pages * block)


@pytest.mark.parametrize("max_blocks", [1, 3, 64, 256, 2048])
@pytest.mark.parametrize("block", [8, 16, 32])
def test_split_plan_covers_every_key_once_page_aligned(block, max_blocks):
    with _RecordTorchCalls() as rec:
        pages, splits = tpa.kv_split_plan(max_blocks, block)
    assert rec.calls == []                      # the plan reads no tensor
    assert isinstance(pages, int) and isinstance(splits, int)
    # the splits cover the table's pages, none of them empty
    assert pages >= 1 and pages * splits >= max_blocks > (splits - 1) * pages
    # each split starts on a page boundary and holds a whole number of pages
    keys = max_blocks * block
    starts = [s * pages * block for s in range(splits)]
    assert all(st % block == 0 for st in starts) and starts[0] == 0
    rng = np.random.default_rng(block * 10007 + max_blocks)
    for window in (None, 1, 7, 300):
        for kv_len in {1, keys, *rng.integers(1, keys + 1, size=6).tolist()}:
            pos = kv_len - 1
            lo = max(0, pos - window + 1) if window else 0
            hi = min(kv_len, pos + 1)
            # every visible key falls in exactly one split, the splits the
            # kernel blocks and the merge both take
            owners = [[s for s in range(splits)
                       if starts[s] <= j < (starts[s + 1] if s + 1 < splits else 1 << 62)]
                      for j in range(lo, hi)]
            assert all(len(o) == 1 for o in owners)
            assert [o[0] for o in owners] == [_split_of_key(j, pages, block)
                                              for j in range(lo, hi)]
            # exactly one split holds the page pos is written to, and every
            # slot of that page is in the same split
            page = pos // block
            holders = [s for s in range(splits) if s * pages <= page < (s + 1) * pages]
            assert len(holders) == 1
            assert {_split_of_key(page * block + i, pages, block)
                    for i in range(block)} == {holders[0]}


@pytest.mark.parametrize("max_blocks,block,plan", [
    (64, 16, (4, 16)),       # 1024-key tables: 16 splits of 64 keys
    (256, 16, (16, 16)),     # 4096-key tables: 16 splits of 256 keys
    (2048, 16, (16, 128)),   # wider tables keep 256 keys a split
    (3, 16, (3, 1)),         # a table narrower than 64 keys is one split
])
def test_split_plan_takes_its_size_from_the_table_width(max_blocks, block, plan):
    assert tpa.kv_split_plan(max_blocks, block) == plan
    # an explicit aim (chip_smoke.py times other sizes) overrides the width
    assert tpa.kv_split_plan(max_blocks, block, 512) == (
        min(max_blocks, 512 // block), -(-max_blocks // min(max_blocks, 512 // block)))


def _split_states(q, kp, vp, table, lo, hi, pages, block):
    """Per-split (m, l, acc) of one query row [Nh, D] over keys [lo, hi),
    in f32 natural-log form — the states a kernel block writes."""
    nh, d = q.shape
    hkv = kp.shape[1]
    qpk = nh // hkv
    split_keys = pages * block
    states = []
    for s in range(lo // split_keys, (hi - 1) // split_keys + 1):
        j = torch.arange(max(lo, s * split_keys), min(hi, (s + 1) * split_keys))
        page = table[j // block].long()
        k = kp[page, :, j % block]                   # [n, Hkv, D]
        v = vp[page, :, j % block]
        kh = k.repeat_interleave(qpk, dim=1)         # [n, Nh, D]
        vh = v.repeat_interleave(qpk, dim=1)
        sc = torch.einsum("hd,nhd->hn", q, kh) * d ** -0.5
        m = sc.max(dim=1).values
        p = torch.exp(sc - m[:, None])
        states.append((m, p.sum(dim=1), torch.einsum("hn,nhd->hd", p, vh)))
    return states


def _merge(states, nh, d):
    if not states:
        return torch.zeros((nh, d))
    m = torch.stack([s[0] for s in states]).max(dim=0).values
    l = sum(s[1] * torch.exp(s[0] - m) for s in states)
    acc = sum(s[2] * torch.exp(s[0] - m)[:, None] for s in states)
    return acc / l[:, None]


@pytest.mark.parametrize("lens,window", [
    ((1, 17, 0), None), ((256, 257, 1000), None), ((4096, 2049, 513), None),
    ((4096, 300, 1), 100), ((1000, 4096, 16), 257), ((255, 4096, 3000), 1),
])
def test_merged_split_states_match_the_plain_versions(lens, window):
    # f32 throughout: the split-and-merge order of the sums is the only
    # difference, so the tolerance stays at the file's f32 one
    nh, hkv, d, block, m = 4, 2, 64, 16, 256
    rows = [(1 if kv else 0, kv) for kv in lens]
    q, kp, vp, tables, positions, klens = _ragged(rows, nh, hkv, d, block, m, seed=7)
    pages, _ = tpa.kv_split_plan(m, block)
    want_ref = paged_attention_ref(*map(torch.from_numpy, (q, kp, vp, tables, positions, klens)),
                                   block, window=window).numpy()
    want_xla = np.asarray(paged_attention_xla(*map(jnp.asarray, (q, kp, vp, tables, positions,
                                                                  klens)), block, window=window))
    tq, tk, tv = map(torch.from_numpy, (q, kp, vp))
    for b, kv in enumerate(lens):
        pos = int(positions[b, 0])
        if pos < 0:
            states = []
        else:
            lo = max(0, pos - window + 1) if window else 0
            states = _split_states(tq[b, 0], tk, tv, torch.from_numpy(tables[b]), lo,
                                   min(kv, pos + 1), pages, block)
        assert len(states) == (0 if pos < 0 else len({
            j // (pages * block) for j in range(lo, min(kv, pos + 1))}))
        got = _merge(states, nh, d).numpy()
        np.testing.assert_allclose(got, want_ref[b, 0], **TOL)
        np.testing.assert_allclose(got, want_xla[b, 0], **TOL)
