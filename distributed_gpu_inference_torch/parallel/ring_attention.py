"""Sequence parallelism over the ``seq`` axis: ring and Ulysses attention,
and the partial-softmax reads of block-sharded KV pools.

The port of ``distributed_gpu_inference_tpu/parallel/ring_attention.py``.
The JAX package writes each op as a per-device body under ``shard_map``
and XLA runs the collectives; here every rank of a sequence-parallel
engine (one process each, ``runtime/tp.py``) calls the same function with
its own shard and its :class:`parallel.mesh.TPGroup`, and the function
calls the collectives itself. With ``group=None`` an op runs on one
device (an axis of size 1).

- **Ring** (:func:`ring_self_attention`): each rank holds a contiguous
  slice of the queries, keys and values; the K/V slices rotate n-1 hops
  around the ring (``TPGroup.ring_hop``, K and V stacked into one tensor a
  hop) while each rank accumulates blockwise attention with an online
  softmax. No head-count constraint.
- **Ulysses** (:func:`ulysses_self_attention`): two all-to-alls swap the
  sequence slice for a head slice, each rank runs full-sequence attention
  over its Nh/n heads, and a third swaps back. Needs ``num_kv_heads % n ==
  0``, refused by name otherwise; on a seq x model mesh the rank's
  model-local heads are gathered over ``model`` first where they alone do
  not divide.
- **Partial-softmax reads**: decode (:func:`seq_parallel_decode_attention`
  over contiguous context slices, :func:`seq_parallel_paged_decode_attention`
  over a paged pool whose block axis is sharded) and chunk
  (:func:`seq_parallel_paged_chunk_attention`, a flash-style loop over
  page groups). Each rank attends over the pages it holds; one max and two
  sums across the group merge the partial (max, sum, acc). Pages never
  move. int8 pools dequantize their local pages with their local scale
  pages.

All match ``ops.attention.dense_causal_attention`` (ring, Ulysses) and
``ops.attention.paged_attention_ref`` (the paged reads) on the unsharded
inputs: causal GQA with per-sequence valid lengths, f32 scores and sums.
On a seq x model mesh every op runs on the rank's model-local heads and
its collectives go over the rank's ``seq`` sub-group.

Plain PyTorch on every device: the JAX package computes these with XLA,
not Pallas, so no kernel is written for them until a chip run shows one
on the main path.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from distributed_gpu_inference_torch.ops.attention import (
    dense_causal_attention,
    dequantize_kv,
)

_NEG_INF = -1e30


def _axis(group: Optional[Any]) -> Tuple[int, int]:
    """(rank, size) of ``group``; (0, 1) without one."""
    return (0, 1) if group is None else (group.rank, group.size)


def _finish(acc: torch.Tensor, l: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """acc / l with rows that saw no key set to zero, [B, Hkv, qpk, S, D]
    → [B, S, Nh, D] in ``dtype``."""
    b, hkv, qpk, s, d = acc.shape
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out = torch.where((l > 0)[..., None], out, torch.zeros_like(out))
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, hkv * qpk, d).to(dtype)


def _ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: torch.Tensor, group: Optional[Any]) -> torch.Tensor:
    """One rank's ring attention. q ``[B, Sq, Nh, D]``, k/v ``[B, Skv, Hkv,
    D]``: this rank's contiguous slice of the sequence (rank r holds
    positions ``[r·Sq, (r+1)·Sq)``); ``lengths`` [B] global valid lengths.
    → ``[B, Sq, Nh, D]``."""
    idx, n = _axis(group)
    b, sq, nh, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qpk = nh // hkv
    qg = q.reshape(b, sq, hkv, qpk, d).float()
    q_pos = idx * sq + torch.arange(sq, dtype=torch.int32, device=q.device)
    lens = lengths.to(torch.int32)
    m = torch.full((b, hkv, qpk, sq), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, qpk, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, qpk, sq, d), dtype=torch.float32, device=q.device)
    kv = torch.stack((k, v))
    for r in range(n):
        # after r hops this rank holds the slice of rank (idx - r) mod n
        src = (idx - r) % n
        k_pos = src * skv + torch.arange(skv, dtype=torch.int32, device=q.device)
        scores = torch.einsum("bsgqd,bjgd->bgqsj", qg, kv[0].float()) * (d ** -0.5)
        causal = q_pos[:, None] >= k_pos[None, :]                        # [Sq, Skv]
        valid = k_pos[None, None, :] < lens[:, None, None]               # [B, 1, Skv]
        mask = (causal[None] & valid)[:, None, None, :, :]               # [B,1,1,Sq,Skv]
        scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None]) * mask
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bgqsj,bjgd->bgqsd", p, kv[1].float())
        m = m_new
        if r < n - 1:       # the last hop's slice would go unread
            kv = group.ring_hop(kv)
    return _finish(acc, l, q.dtype)


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lengths: torch.Tensor, group: Optional[Any] = None) -> torch.Tensor:
    """Causal GQA self-attention with Q/K/V sharded over the ``seq`` axis:
    each rank passes its contiguous slice ``[B, S/n, ., D]`` (every rank's
    slice the same length) and gets its slice of the output. K/V slices
    rotate n-1 ring hops; the result equals
    ``dense_causal_attention`` of the whole sequence."""
    if k.shape[1] != q.shape[1] or v.shape != k.shape:
        raise ValueError(f"ring attention needs q, k, v slices of one length, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    return _ring_attention_local(q, k, v, lengths, group)


def _ulysses_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   lengths: torch.Tensor, group: Optional[Any]) -> torch.Tensor:
    """One rank's Ulysses attention: all-to-all #1 scatters heads and
    gathers the sequence, full-sequence attention runs over this rank's
    head group, all-to-all #2 restores the sequence slices. Contiguous
    head splits keep GQA intact: rank p owns query heads [p·Nh/n,
    (p+1)·Nh/n) and exactly their KV heads [p·Hkv/n, (p+1)·Hkv/n)."""
    if group is None or group.size == 1:
        return dense_causal_attention(q, k, v, lengths)
    # q, k and v move in one exchange each; the three could share one, but
    # their head counts differ
    q_full = group.all_to_all(q, split_dim=2, concat_dim=1)     # [B, S, Nh/n, D]
    k_full = group.all_to_all(k, split_dim=2, concat_dim=1)     # [B, S, Hkv/n, D]
    v_full = group.all_to_all(v, split_dim=2, concat_dim=1)
    out = dense_causal_attention(q_full, k_full, v_full, lengths)
    return group.all_to_all(out, split_dim=1, concat_dim=2)    # [B, S/n, Nh, D]


def ulysses_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor, group: Optional[Any] = None,
                           model_group: Optional[Any] = None) -> torch.Tensor:
    """Causal GQA self-attention, seq-sharded, Ulysses all-to-all strategy.
    Same contract as :func:`ring_self_attention`; refuses a KV head count
    that does not divide over the axis.

    On a seq x model mesh (``model_group``, the rank's ``model`` peers) q,
    k and v hold the rank's model-local heads. Where those KV heads divide
    over the seq axis the all-to-alls split them as they are; where they
    do not (llama3-tiny's 2 KV heads on seq 2 x model 2: one a rank) the
    heads are first gathered over ``model``, as the JAX op sees every head
    inside its ``shard_map``, and the rank keeps its own heads of the
    result."""
    _, n = _axis(group)
    if k.shape[2] % n == 0:
        return _ulysses_local(q, k, v, lengths, group)
    if model_group is not None and model_group.size > 1:
        j, m = model_group.rank, model_group.size

        def gather_heads(t: torch.Tensor) -> torch.Tensor:
            return torch.cat(model_group.all_gather(t).unbind(0), dim=2)

        k_all = gather_heads(k)
        if k_all.shape[2] % n == 0:
            out = _ulysses_local(gather_heads(q), k_all, gather_heads(v), lengths, group)
            nh = q.shape[2]
            return out[:, :, j * nh:(j + 1) * nh]
        hkv = k_all.shape[2]
    else:
        hkv = k.shape[2]
    raise ValueError(f"ulysses needs num_kv_heads {hkv} divisible by the seq "
                     f"axis {n} (use ring_self_attention otherwise)")


def _merge(m_loc: torch.Tensor, l_loc: torch.Tensor, acc_loc: torch.Tensor,
           group: Optional[Any]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross-rank partial-softmax merge of a flash-style partial (its
    sums taken against its own running max): one max and two sums."""
    if group is None:
        return l_loc, acc_loc
    m_glob = group.all_reduce_max(m_loc.clone())
    corr = torch.exp(m_loc - m_glob)
    l = group.all_reduce_sum(l_loc * corr)
    acc = group.all_reduce_sum(acc_loc * corr[..., None])
    return l, acc


def _decode_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  visible: torch.Tensor, group: Optional[Any]) -> torch.Tensor:
    """Attention of one query a row over this rank's context ``[B, J, Hkv,
    D]`` (f32), ``visible`` [B, J]: scores against the global max (one
    max), then the two sums."""
    b, _, nh, d = q.shape
    hkv = k.shape[2]
    qpk = nh // hkv
    qg = q.reshape(b, 1, hkv, qpk, d).float()
    scores = torch.einsum("bsgqd,bjgd->bgqsj", qg, k) * (d ** -0.5)
    mask = visible[:, None, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    m = scores.amax(dim=-1)
    if group is not None:
        m = group.all_reduce_max(m)
    p = torch.where(mask, torch.exp(scores - m[..., None]), torch.zeros_like(scores))
    l = p.sum(dim=-1)
    acc = torch.einsum("bgqsj,bjgd->bgqsd", p, v)
    if group is not None:
        l = group.all_reduce_sum(l)
        acc = group.all_reduce_sum(acc)
    return _finish(acc, l, q.dtype)


def seq_parallel_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  lengths: torch.Tensor,
                                  group: Optional[Any] = None) -> torch.Tensor:
    """Decode attention against seq-sharded contiguous context: q ``[B, 1,
    Nh, D]`` on every rank, k/v ``[B, Sctx/n, Hkv, D]`` this rank's slice
    (rank r holds positions ``[r·Sctx/n, (r+1)·Sctx/n)``), ``lengths`` [B]
    global. Only the [B, Nh, D]-sized partials cross ranks."""
    idx, _ = _axis(group)
    skv = k.shape[1]
    k_pos = idx * skv + torch.arange(skv, dtype=torch.int32, device=q.device)
    visible = k_pos[None, :] < lengths.to(torch.int32)[:, None]
    return _decode_local(q, k.float(), v.float(), visible, group)


def _local_pages(block_tables: torch.Tensor, nloc: int,
                 group: Optional[Any]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global page ids → (this rank's slot for each, whether it holds the
    page). Rank r holds the global blocks ``[r·nloc, (r+1)·nloc)``; pages
    it does not hold gather slot 0 and are masked out."""
    idx, _ = _axis(group)
    local = block_tables.long() - idx * nloc
    held = (block_tables >= 0) & (local >= 0) & (local < nloc)
    return torch.where(held, local, torch.zeros_like(local)), held


def _page_ctx(pool: torch.Tensor, ids: torch.Tensor, block_size: int,
              scale: Optional[torch.Tensor]) -> torch.Tensor:
    """Pages ``ids`` [B, G] of a local pool [Nloc, Hkv, Bk, D] as token-major
    f32 context [B, G·Bk, Hkv, D], int8 pages dequantized by their scale
    pages ([Nloc, Bk]) with the plain read's arithmetic."""
    b, g = ids.shape
    _, hkv, _, d = pool.shape
    ctx = pool[ids].permute(0, 1, 3, 2, 4).reshape(b, g * block_size, hkv, d)
    if scale is None:
        return ctx.float()
    s_ctx = scale[ids].reshape(b, g * block_size)
    return dequantize_kv(ctx, s_ctx[:, :, None, None])


def _check_scales(k_scale: Optional[torch.Tensor], v_scale: Optional[torch.Tensor]) -> None:
    if (k_scale is None) != (v_scale is None):
        raise ValueError("int8-KV pools need BOTH k_scale and v_scale (or neither)")


def seq_parallel_paged_decode_attention(
    q: torch.Tensor,              # [B, 1, Nh, D] (the same on every rank)
    k_shard: torch.Tensor,        # [Nloc, Hkv, Bk, D]: this rank's blocks
    v_shard: torch.Tensor,
    block_tables: torch.Tensor,   # [B, M] GLOBAL block ids (the same on every rank)
    positions: torch.Tensor,      # [B, 1] query positions (-1 = inactive)
    kv_lens: torch.Tensor,        # [B] global context lengths
    group: Optional[Any] = None,
    block_size: int = 16,
    k_scale: Optional[torch.Tensor] = None,   # [Nloc, Bk] bf16, int8 pools
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode attention over a paged pool whose block axis is sharded over
    the ``seq`` axis: each rank reads only the pages it holds (rank r the
    global blocks ``[r·Nloc, (r+1)·Nloc)``, every rank the same Nloc) and
    one max and two sums merge the partial softmax. Semantics of
    ``ops.attention.paged_attention_ref`` over the whole pool (causal by
    ``positions``, bounded by ``kv_lens``, inactive rows zero), int8 pools
    included."""
    _check_scales(k_scale, v_scale)
    b, m = block_tables.shape
    j = m * block_size
    ids, held = _local_pages(block_tables, k_shard.shape[0], group)
    k_ctx = _page_ctx(k_shard, ids, block_size, k_scale)
    v_ctx = _page_ctx(v_shard, ids, block_size, v_scale)
    key_pos = torch.arange(j, dtype=torch.int32, device=q.device)[None, :]
    pos = positions.reshape(b).to(torch.int32)
    visible = ((key_pos < kv_lens.to(torch.int32)[:, None])
               & (key_pos <= pos[:, None])
               & held.repeat_interleave(block_size, dim=1))
    return _decode_local(q, k_ctx, v_ctx, visible, group)


def _paged_chunk_local(q: torch.Tensor, k_shard: torch.Tensor, v_shard: torch.Tensor,
                       block_tables: torch.Tensor, positions: torch.Tensor,
                       kv_lens: torch.Tensor, group: Optional[Any], block_size: int,
                       pages_per_step: int, k_scale: Optional[torch.Tensor],
                       v_scale: Optional[torch.Tensor]
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One rank's flash-style chunk attention over the pages it holds, a
    loop over groups of ``pages_per_step`` pages (the score tile stays
    [B, Nh, S, G·Bk]) → the partial (m, l, acc) before the merge."""
    b, s, nh, d = q.shape
    hkv = k_shard.shape[1]
    qpk = nh // hkv
    m_tab = block_tables.shape[1]
    g = min(pages_per_step, m_tab)
    n_steps = -(-m_tab // g)
    pad = n_steps * g - m_tab
    tables = block_tables.to(torch.int32)
    if pad:     # out-of-shard ids (masked): every step sees G pages
        tables = torch.cat([tables, tables.new_full((b, pad), -1)], dim=1)
    ids, held = _local_pages(tables, k_shard.shape[0], group)
    qg = q.reshape(b, s, hkv, qpk, d).float()
    qpos = positions.to(torch.int32)
    lens = kv_lens.to(torch.int32)
    m_run = torch.full((b, hkv, qpk, s), _NEG_INF, dtype=torch.float32, device=q.device)
    l_run = torch.zeros((b, hkv, qpk, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, qpk, s, d), dtype=torch.float32, device=q.device)
    for step in range(n_steps):
        sl = slice(step * g, (step + 1) * g)
        k_ctx = _page_ctx(k_shard, ids[:, sl], block_size, k_scale)
        v_ctx = _page_ctx(v_shard, ids[:, sl], block_size, v_scale)
        key_pos = (step * g * block_size
                   + torch.arange(g * block_size, dtype=torch.int32, device=q.device))[None, :]
        scores = torch.einsum("bsgqd,bjgd->bgqsj", qg, k_ctx) * (d ** -0.5)
        visible = ((key_pos < lens[:, None])[:, None, :]
                   & (key_pos[:, None, :] <= qpos[:, :, None])
                   & held[:, sl].repeat_interleave(block_size, dim=1)[:, None, :])
        mask = visible[:, None, None, :, :]
        scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
        m_new = torch.maximum(m_run, scores.amax(dim=-1))
        p = torch.where(mask, torch.exp(scores - m_new[..., None]), torch.zeros_like(scores))
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bgqsj,bjgd->bgqsd", p, v_ctx)
        m_run = m_new
    return m_run, l_run, acc


def seq_parallel_paged_chunk_attention(
    q: torch.Tensor,              # [B, S, Nh, D] (the same on every rank)
    k_shard: torch.Tensor,        # [Nloc, Hkv, Bk, D]: this rank's blocks
    v_shard: torch.Tensor,
    block_tables: torch.Tensor,   # [B, M] GLOBAL block ids
    positions: torch.Tensor,      # [B, S] query positions (-1 = padding)
    kv_lens: torch.Tensor,        # [B] context lengths AFTER the chunk
    group: Optional[Any] = None,
    block_size: int = 16,
    pages_per_step: int = 16,
    k_scale: Optional[torch.Tensor] = None,   # [Nloc, Bk] bf16, int8 pools
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Chunk attention (q_len >= 1) over a seq-sharded paged pool: what
    lets a sharded-pool engine serve prefix-cached prompts and continuation
    chunks. The chunk's K/V is already in the pools (the layer wrote it
    first, each page on the rank that holds it), so one partial-softmax
    read covers the cached prefix, earlier chunks and the in-chunk causal
    keys. The merge is the decode op's: one max, two sums."""
    _check_scales(k_scale, v_scale)
    m_loc, l_loc, acc_loc = _paged_chunk_local(
        q, k_shard, v_shard, block_tables, positions, kv_lens, group, block_size,
        pages_per_step, k_scale, v_scale)
    l, acc = _merge(m_loc, l_loc, acc_loc, group)
    return _finish(acc, l, q.dtype)
