"""Attention over paged KV: the plain PyTorch version (gather + einsum) that
every kernel is held to, the paged write, and the int8-KV contract.

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

Quantized pools (``kv_cache_dtype``): an fp8 pool stores e4m3 codes,
written with JAX's cast and read by a plain upcast. An int8 pool stores
codes plus one bf16 scale per (page, token) in a scale pool ``[N, Bk]``
per layer (``[L, N, Bk]`` stacked), shared by every KV head of the token:
:func:`quantize_token_rows` is the contract (the JAX package's
``_quantize_token_rows``) and :func:`dequantize_kv` the arithmetic every
reader uses. The JAX package stores the same scale repeated over the
``D`` lanes (``[L, N, Bk, D]``) because TPU DMA slices and broadcasts need
it; on the card that repetition only adds 25% to every int8 KV read at
D = 128, so the port keeps one scale per token and expands it at the wire
formats (``models/convert.py``).

The dispatch is the ragged wrapper itself
(``ops.paged_attention.ragged_paged_attention``) and carries none of the
TPU's crossovers: on a CUDA tensor it launches the hand-written kernel, on
a CPU tensor it takes :func:`paged_attention_ref`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from distributed_gpu_inference_torch.ops.quantization import cast_to

_NEG_INF = -1e30
_INV_127 = 1.0 / 127.0      # applied as a float32 constant


def token_amax(x: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """Each token's amax over ``dims`` in f32, ``dims`` kept as size-1
    dims: what :func:`quantize_token_rows` scales by. Under tensor
    parallelism a rank holds some KV heads of each token, so the engine
    max-reduces this over the ranks and hands the result back as
    ``amax``."""
    return x.float().abs().amax(dim=tuple(dims), keepdim=True)


def quantize_token_rows(x: torch.Tensor, dims: Sequence[int],
                        amax: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """THE int8-KV quantization contract: one scale per token over every
    (head, channel) element — amax over ``dims`` floored at 1e-6, times
    1/127, ROUNDED TO bf16 BEFORE quantizing (the stored codes must match
    the stored bf16 scale) — code = round-half-even(x / scale) clipped to
    ±127, real = code * scale. The JAX package writes ``amax / 127``; its
    compiled graphs (what its engine runs) multiply by the float32
    reciprocal instead, and so does this. Returns (int8 like x, f32 scale
    with ``dims`` kept as size-1 dims). ``amax`` (:func:`token_amax`'s
    shape) replaces x's own amax: the max over every rank's heads of a
    tensor-parallel token."""
    x = x.float()
    if amax is None:
        amax = token_amax(x, dims)
    scale = (torch.clamp_min(amax, 1e-6) * _INV_127).to(torch.bfloat16).float()
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_kv_pool(pool: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """bf16/f32 pool ``[N, Hkv, Bk, D]`` → (int8 pool, ``[N, Bk]`` bf16
    scales): one scale per (page, token), amax over (Hkv, D)."""
    q, scale = quantize_token_rows(pool, (1, 3))
    return q, scale[:, 0, :, 0].to(torch.bfloat16)


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The int8-KV dequant arithmetic of the plain read: code times its
    bf16 scale in float32, which is exact (8-bit by 8-bit significands).
    The JAX package writes it as a bf16 multiply; its compiled read casts
    the product on to float32 and XLA keeps it unrounded, so the exact
    product is what its engine attends over. The kernels that feed bf16
    tensor cores round it to bf16, as the Pallas kernels do. ``scale``
    must already broadcast against ``codes``."""
    return codes.float() * scale.float()


def _gather_ctx(
    pool: torch.Tensor, block_tables: torch.Tensor, block_size: int,
    scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Materialize a batch's paged context: head-major pool [N, Hkv, Bk, D]
    gathered by [B, M] tables → [B, J, Hkv, D] token-major context.
    ``scale`` ([N, Bk] bf16, int8 pools) dequantizes the context-sized
    result, never the whole pool."""
    b, m = block_tables.shape
    _, hkv, _, d = pool.shape
    idx = block_tables.long()
    ctx = pool[idx].permute(0, 1, 3, 2, 4).reshape(b, m * block_size, hkv, d)
    if scale is None:
        return ctx
    s_ctx = scale[idx].reshape(b, m * block_size)
    return dequantize_kv(ctx, s_ctx[:, :, None, None])


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
    """The plain version: gather the whole table's context (int8 pools
    dequantized through ``k_scale``/``v_scale`` [N, Bk]), f32 scores and
    softmax with the visibility mask, f32 P·V, cast to q's dtype."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("int8-KV pools need BOTH k_scale and v_scale (or neither)")
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


def paged_tree_attention(
    q: torch.Tensor,             # [B, N, Nh, D] — one query per tree node
    k_pool: torch.Tensor,        # [Nb, Hkv, Bk, D]
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [B, M]
    prefix_lens: torch.Tensor,   # [B] committed context BEFORE the tree chunk
    tree_mask: torch.Tensor,     # [N, N] bool — node i may attend node j
    block_size: int = 16,
    node_positions: Optional[torch.Tensor] = None,  # [B, N] semantic positions
    window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,         # [Nb, Bk] — int8 pools
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention of speculative tree verification (the JAX package
    computes it with XLA, so it stays plain PyTorch on the card too).

    The N tree-node KV rows sit at cache positions ``prefix_len + i``
    (node index, not depth: siblings share a depth but need their own
    slots). Every node sees the committed prefix; within the chunk node i
    sees node j iff ``tree_mask[i, j]`` (its ancestors and itself). With a
    sliding window, prefix keys drop out by absolute position and
    in-chunk keys by their SEMANTIC position (prefix + depth): an ancestor
    more than ``window`` steps up is invisible, as in sequential decode."""
    b, n, nh, d = q.shape
    hkv = k_pool.shape[1]
    qpk = nh // hkv
    j = block_tables.shape[1] * block_size

    k_ctx = _gather_ctx(k_pool, block_tables, block_size, k_scale)
    v_ctx = _gather_ctx(v_pool, block_tables, block_size, v_scale)
    qg = q.reshape(b, n, hkv, qpk, d).float()
    scores = torch.einsum("bsgqd,bjgd->bgqsj", qg, k_ctx.float()) * (d ** -0.5)

    key_pos = torch.arange(j, dtype=torch.int32, device=q.device)[None, :]   # [1, J]
    prefix = prefix_lens.to(torch.int32)[:, None, None]
    is_prefix = key_pos[:, None, :] < prefix                                # [B, 1, J]
    chunk_idx = key_pos[:, None, :] - prefix                                # [B, 1, J]
    in_chunk = (chunk_idx >= 0) & (chunk_idx < n)
    safe_idx = chunk_idx.clamp(0, n - 1).long().expand(b, n, j)
    # tree_mask lookup per (query node, chunk key)
    tm = torch.gather(tree_mask.to(q.device)[None].expand(b, n, n), 2, safe_idx)  # [B, N, J]
    if window is not None and node_positions is not None:
        node_pos = node_positions.to(torch.int32)
        is_prefix = is_prefix & (key_pos[:, None, :] > node_pos[:, :, None] - window)
        key_node_pos = torch.gather(node_pos[:, None, :].expand(b, n, n), 2, safe_idx)
        tm = tm & (key_node_pos > node_pos[:, :, None] - window)
    mask = (is_prefix | (in_chunk & tm))[:, None, None, :, :]              # [B,1,1,N,J]
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(mask.any(dim=-1, keepdim=True), probs, torch.zeros_like(probs))
    out = torch.einsum("bgqsj,bjgd->bsgqd", probs, v_ctx.float())
    return out.reshape(b, n, nh, d).to(q.dtype)


def _page_slots(block_tables: torch.Tensor, positions: torch.Tensor,
                block_size: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(physical page, slot, flat row index) of every non-pad position."""
    valid = (positions >= 0).reshape(-1)
    safe = positions.clamp(min=0).long()
    logical = safe // block_size
    slot = (safe % block_size).reshape(-1)
    phys = torch.gather(block_tables.long(), 1, logical).reshape(-1)
    rows = valid.nonzero().squeeze(1)
    return phys[rows], slot[rows], rows


def write_kv_pages(
    pool: torch.Tensor,          # [N, Hkv, Bk, D] single layer — updated IN PLACE
    new: torch.Tensor,           # [B, S, Hkv, D]
    block_tables: torch.Tensor,  # [B, M] int32 physical block ids
    positions: torch.Tensor,     # [B, S] int32 token positions (-1 = pad)
    block_size: int,
) -> torch.Tensor:
    """Scatter a chunk of new K or V rows into their page slots, cast to
    the pool's dtype with JAX's rounding (an fp8 pool overflows to NaN past
    ±464, as ``astype`` does).

    The port updates the pool in place where the JAX package donated it
    and got a new array back. Pad rows (position < 0) are DROPPED: they
    are filtered out before the scatter, so they never wrap onto the last
    block (what -1 would index) and never touch the pad block either."""
    b, s = positions.shape
    phys, slot, rows = _page_slots(block_tables, positions, block_size)
    flat_new = cast_to(new.reshape(b * s, *new.shape[2:]), pool.dtype)
    # advanced indices on dims 0 and 2 around the head slice: the indexed
    # view orders as [T, Hkv, D], exactly flat_new's layout
    pool[phys, :, slot] = flat_new[rows]
    return pool


def write_scale_pages(
    pool: torch.Tensor,          # [N, Bk] bf16 scale pool (single layer) — IN PLACE
    new: torch.Tensor,           # [B, S] per-token scales
    block_tables: torch.Tensor,  # [B, M]
    positions: torch.Tensor,     # [B, S] (-1 = pad)
    block_size: int,
) -> torch.Tensor:
    """Scatter int8-KV scale rows with the same page/slot/pad-drop rules
    as :func:`write_kv_pages`."""
    phys, slot, rows = _page_slots(block_tables, positions, block_size)
    pool[phys, slot] = new.reshape(-1).to(pool.dtype)[rows]
    return pool


def write_quantized_kv(
    pool: torch.Tensor,          # [N, Hkv, Bk, D] int8 (single layer) — IN PLACE
    scale_pool: torch.Tensor,    # [N, Bk] bf16 — IN PLACE
    new: torch.Tensor,           # [B, S, Hkv, D]
    block_tables: torch.Tensor,
    positions: torch.Tensor,
    block_size: int,
    amax: Optional[torch.Tensor] = None,
) -> None:
    """Quantize a chunk's K or V rows per token (:func:`quantize_token_rows`
    over (Hkv, D), or by the given ``amax`` ``[B, S, 1, 1]``) and write
    codes and scales to their page slots."""
    codes, scale = quantize_token_rows(new, (2, 3), amax)
    write_kv_pages(pool, codes, block_tables, positions, block_size)
    write_scale_pages(scale_pool, scale[:, :, 0, 0], block_tables, positions,
                      block_size)


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
