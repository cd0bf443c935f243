"""Attention over paged KV: the plain PyTorch version (gather + einsum) that
every kernel is held to, and the paged write.

Semantics shared by every implementation (the JAX package's
``ops/attention.py`` contract):

- KV lives in a paged pool ``[num_blocks, n_kv_heads, block_size,
  head_dim]`` per layer; a sequence's context is the concatenation of its
  block table's pages, valid up to ``kv_lens[b]`` tokens. Block 0 is the
  pad block that pad table entries point at; it is never read as context
  beyond ``kv_lens``.
- Queries carry explicit ``positions`` (``-1`` = padding); causal masking is
  positional: a query at position p attends to context positions ``j <= p``
  (and, with a sliding window, ``j > p - window``).
- GQA: ``n_heads`` queries share ``n_kv_heads`` KV heads; query head ``h``
  reads KV head ``h // (n_heads // n_kv_heads)``.
- A query with no visible key (pad query, or a window that excludes
  everything) outputs exact zeros.

The dispatch is the ragged wrapper itself
(``ops.paged_attention.ragged_paged_attention``) and carries none of the
TPU's crossovers: on a CUDA tensor it launches the hand-written kernel, on
a CPU tensor it takes :func:`paged_attention_ref`.
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The int8-KV dequant arithmetic: bf16 cast of BOTH operands, then
    multiply. ``scale`` must already broadcast against ``codes``."""
    return codes.to(torch.bfloat16) * scale.to(torch.bfloat16)


def _gather_ctx(
    pool: torch.Tensor, block_tables: torch.Tensor, block_size: int,
    scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Materialize a batch's paged context: head-major pool [N, Hkv, Bk, D]
    gathered by [B, M] tables → [B, J, Hkv, D] token-major context.
    ``scale`` ([N, Bk, D] bf16, int8 pools) dequantizes the context-sized
    result, never the whole pool."""
    b, m = block_tables.shape
    _, hkv, _, d = pool.shape
    idx = block_tables.long()
    ctx = pool[idx].permute(0, 1, 3, 2, 4).reshape(b, m * block_size, hkv, d)
    if scale is None:
        return ctx
    s_ctx = scale[idx].reshape(b, m * block_size, d)
    return dequantize_kv(ctx, s_ctx[:, :, None, :])


def paged_attention_ref(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    positions: torch.Tensor,
    kv_lens: torch.Tensor,
    block_size: int = 16,
    window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain version: gather the whole table's context, f32 scores and
    softmax with the visibility mask, f32 P·V, cast to q's dtype."""
    b, s, nh, d = q.shape
    hkv = k_pool.shape[1]
    qpk = nh // hkv
    m = block_tables.shape[1]
    j = m * block_size

    k_ctx = _gather_ctx(k_pool, block_tables, block_size, k_scale)
    v_ctx = _gather_ctx(v_pool, block_tables, block_size, v_scale)

    qg = q.reshape(b, s, hkv, qpk, d).float()
    scores = torch.einsum("bsgqd,bjgd->bgqsj", qg, k_ctx.float()) * (d ** -0.5)

    key_pos = torch.arange(j, dtype=torch.int32, device=q.device)[None, :]
    pos = positions.to(torch.int32)
    causal = pos[:, :, None] >= key_pos[:, None, :]                    # [B, S, J]
    in_len = key_pos[:, None, :] < kv_lens.to(torch.int32)[:, None, None]
    visible = causal & in_len
    if window is not None:  # sliding window: key must be within (p-window, p]
        visible = visible & (key_pos[:, None, :] > pos[:, :, None] - window)
    mask = visible[:, None, None, :, :]                                # [B,1,1,S,J]
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))

    probs = torch.softmax(scores, dim=-1)
    # fully-masked rows (pad queries) → softmax of a -inf row is uniform
    # junk; zero them so pad outputs are exactly 0
    any_valid = mask.any(dim=-1, keepdim=True)
    probs = torch.where(any_valid, probs, torch.zeros_like(probs))

    out = torch.einsum("bgqsj,bjgd->bsgqd", probs, v_ctx.float())
    return out.reshape(b, s, nh, d).to(q.dtype)


def write_kv_pages(
    pool: torch.Tensor,          # [N, Hkv, Bk, D] single layer — updated IN PLACE
    new: torch.Tensor,           # [B, S, Hkv, D]
    block_tables: torch.Tensor,  # [B, M] int32 physical block ids
    positions: torch.Tensor,     # [B, S] int32 token positions (-1 = pad)
    block_size: int,
) -> torch.Tensor:
    """Scatter a chunk of new K or V rows into their page slots.

    The port updates the pool in place where the JAX package donated it
    and got a new array back. Pad rows (position < 0) are DROPPED: they
    are filtered out before the scatter, so they never wrap onto the last
    block (what -1 would index) and never touch the pad block either."""
    b, s = positions.shape
    valid = (positions >= 0).reshape(-1)
    safe = positions.clamp(min=0).long()
    logical = safe // block_size
    slot = (safe % block_size).reshape(-1)
    phys = torch.gather(block_tables.long(), 1, logical).reshape(-1)
    rows = valid.nonzero().squeeze(1)
    flat_new = new.reshape(b * s, *new.shape[2:]).to(pool.dtype)
    # advanced indices on dims 0 and 2 around the head slice: the indexed
    # view orders as [T, Hkv, D], exactly flat_new's layout
    pool[phys[rows], :, slot[rows]] = flat_new[rows]
    return pool


def dense_causal_attention(
    q: torch.Tensor,   # [B, S, Nh, D]
    k: torch.Tensor,   # [B, S, Hkv, D]
    v: torch.Tensor,   # [B, S, Hkv, D]
    lengths: Optional[torch.Tensor] = None,  # [B] valid lengths
    window: Optional[int] = None,
) -> torch.Tensor:
    """Plain causal GQA attention over contiguous KV — the test oracle."""
    b, s, nh, d = q.shape
    hkv = k.shape[2]
    qpk = nh // hkv
    qg = q.reshape(b, s, hkv, qpk, d).float()
    scores = torch.einsum("bsgqd,bjgd->bgqsj", qg, k.float()) * (d ** -0.5)
    idx = torch.arange(s, dtype=torch.int32, device=q.device)
    mask = idx[None, :, None] >= idx[None, None, :]             # [1, S, J]
    if window is not None:
        mask = mask & (idx[None, None, :] > idx[None, :, None] - window)
    if lengths is not None:
        mask = mask & (idx[None, None, :] < lengths.to(torch.int32)[:, None, None])
    scores = torch.where(mask[:, None, None, :, :], scores,
                         torch.full_like(scores, _NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgqsj,bjgd->bsgqd", probs, v.float())
    return out.reshape(b, s, nh, d).to(q.dtype)
