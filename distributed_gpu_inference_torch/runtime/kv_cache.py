"""Host-side paged KV-cache management: block allocator, radix prefix index,
copy-on-write and LRU eviction.

The port's own copy of ``distributed_gpu_inference_tpu/runtime/kv_cache.py``
with the spill tiers (host RAM / remote store) left out: the device side is
a pair of pool tensors ``[L, N, Hkv, block, D]`` owned by the engine; this
module owns only the metadata (free list, refcounts, radix tree, LRU order)
and hands the device effects it decides on — copy-on-write page copies —
to the engine as a :class:`PendingDeviceOps` list. Block 0 is reserved as
the pad block and is never allocated.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from distributed_gpu_inference_torch.utils.data_structures import (
    KV_BLOCK_TOKENS,
    KVBlockMeta,
)


class OutOfBlocksError(RuntimeError):
    pass


@dataclass
class PendingDeviceOps:
    """Device-side effects for the engine to apply before its next forward.

    copies: (src_block, dst_block) page copies (copy-on-write of a shared
            tail block)
    """

    copies: List[Tuple[int, int]] = field(default_factory=list)

    @property
    def empty(self) -> bool:
        return not self.copies


class _RadixNode:
    __slots__ = ("children", "block_id", "parent", "edge", "last_access")

    def __init__(self, parent: Optional["_RadixNode"], edge: Optional[Tuple[int, ...]],
                 block_id: Optional[int]) -> None:
        self.children: Dict[Tuple[int, ...], _RadixNode] = {}
        self.block_id = block_id
        self.parent = parent
        self.edge = edge
        self.last_access = time.monotonic()


class RadixPrefixIndex:
    """Radix tree over full token blocks for prefix-cache lookup.

    Each edge is one *full* block of tokens; a node holds the physical block
    id caching that prefix block. Partial blocks are never shared.
    """

    def __init__(self, block_size: int = KV_BLOCK_TOKENS) -> None:
        self.block_size = block_size
        self.root = _RadixNode(None, None, None)
        self._nodes_by_block: Dict[int, _RadixNode] = {}

    def _chunks(self, token_ids: Sequence[int]) -> List[Tuple[int, ...]]:
        bs = self.block_size
        n_full = len(token_ids) // bs
        return [tuple(token_ids[i * bs : (i + 1) * bs]) for i in range(n_full)]

    def match_prefix(self, token_ids: Sequence[int]) -> List[int]:
        """Longest cached full-block prefix → list of physical block ids."""
        node = self.root
        out: List[int] = []
        now = time.monotonic()
        for chunk in self._chunks(token_ids):
            child = node.children.get(chunk)
            if child is None:
                break
            child.last_access = now
            out.append(child.block_id)  # type: ignore[arg-type]
            node = child
        return out

    def insert(self, token_ids: Sequence[int], block_ids: Sequence[int]) -> int:
        """Index ``block_ids`` as the cache of the full blocks of ``token_ids``.
        Returns the number of *newly indexed* blocks (already-present prefix
        nodes are left untouched)."""
        node = self.root
        added = 0
        for chunk, bid in zip(self._chunks(token_ids), block_ids):
            child = node.children.get(chunk)
            if child is None:
                child = _RadixNode(node, chunk, bid)
                node.children[chunk] = child
                self._nodes_by_block[bid] = child
                added += 1
            node = child
        return added

    def contains_block(self, block_id: int) -> bool:
        return block_id in self._nodes_by_block

    def is_leaf(self, block_id: int) -> bool:
        node = self._nodes_by_block.get(block_id)
        return node is not None and not node.children

    def remove_block(self, block_id: int) -> None:
        """Remove a (leaf) node from the tree; interior nodes must not be
        removed or descendant chains would dangle."""
        node = self._nodes_by_block.get(block_id)
        if node is None:
            return
        if node.children:
            raise ValueError(f"cannot evict interior radix block {block_id}")
        del self._nodes_by_block[block_id]
        assert node.parent is not None
        del node.parent.children[node.edge]  # type: ignore[index]

    def __len__(self) -> int:
        return len(self._nodes_by_block)


@dataclass
class KVCacheStats:
    """Hit-rate and pool statistics."""

    prefix_queries: int = 0
    prefix_hit_tokens: int = 0
    prefix_total_tokens: int = 0
    l1_hits: int = 0
    misses: int = 0
    evictions: int = 0
    cow_copies: int = 0
    allocated_blocks: int = 0
    cached_blocks: int = 0
    free_blocks: int = 0
    window_released_blocks: int = 0

    def as_dict(self) -> Dict[str, Any]:
        d = dict(self.__dict__)
        d["prefix_hit_rate"] = (
            self.prefix_hit_tokens / self.prefix_total_tokens
            if self.prefix_total_tokens
            else 0.0
        )
        return d


class PagedKVCacheManager:
    """Metadata brain for the device KV pools:

    - allocate/free per-sequence block chains with rollback on exhaustion
    - radix prefix reuse with refcounted sharing + copy-on-write
    - LRU eviction of cached (ref==0) leaf blocks
    - emits :class:`PendingDeviceOps` for the engine's pool updates
    """

    def __init__(
        self,
        num_blocks: int,
        block_size: int = KV_BLOCK_TOKENS,
        enable_prefix_cache: bool = True,
    ) -> None:
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (block 0 is reserved)")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.enable_prefix_cache = enable_prefix_cache
        self.metas: Dict[int, KVBlockMeta] = {}
        self.free_list: List[int] = list(range(num_blocks - 1, 0, -1))  # pop() → 1..
        self.cached_lru: "OrderedDict[int, None]" = OrderedDict()  # ref==0, indexed
        self.radix = RadixPrefixIndex(block_size)
        self.seq_blocks: Dict[str, List[int]] = {}
        self.seq_tokens: Dict[str, List[int]] = {}
        self.seq_shared_count: Dict[str, int] = {}
        # first logical block not yet window-released, per sequence — keeps
        # release_out_of_window O(1) amortized
        self.seq_window_front: Dict[str, int] = {}
        self.stats = KVCacheStats()
        self.pending = PendingDeviceOps()

    # -- core alloc ---------------------------------------------------------

    @property
    def num_free(self) -> int:
        return len(self.free_list)

    @property
    def num_reclaimable(self) -> int:
        return len(self.free_list) + len(self.cached_lru)

    def _pop_free_block(self) -> int:
        if self.free_list:
            bid = self.free_list.pop()
        else:
            bid = self._evict_one()
        self.metas[bid] = KVBlockMeta(block_id=bid, capacity=self.block_size)
        self.stats.allocated_blocks += 1
        return bid

    def _evict_one(self) -> int:
        """Evict the LRU cached *leaf* block."""
        for bid in list(self.cached_lru.keys()):
            if self.radix.is_leaf(bid):
                self._evict_block(bid)
                return bid
        raise OutOfBlocksError(
            f"KV pool exhausted: 0 free, {len(self.cached_lru)} cached "
            "(all interior), all others pinned by active sequences"
        )

    def _evict_block(self, bid: int) -> None:
        self.metas.pop(bid, None)
        if self.cached_lru.pop(bid, False) is None:
            # was present (values are literal None): keep the gauge honest
            self.stats.cached_blocks -= 1
        self.radix.remove_block(bid)
        self.stats.evictions += 1

    # -- sequence lifecycle -------------------------------------------------

    def allocate_sequence(self, seq_id: str, token_ids: Sequence[int]) -> Tuple[List[int], int]:
        """Allocate the block chain for a prompt. Returns (block_ids,
        num_cached_tokens) — the first ``num_cached_tokens`` positions already
        hold valid KV from the prefix cache (the engine skips recomputing
        them). Rolls back on exhaustion."""
        if seq_id in self.seq_blocks:
            raise ValueError(f"sequence {seq_id} already allocated")
        if isinstance(token_ids, np.ndarray):
            token_ids = token_ids.tolist()
        else:
            token_ids = [int(t) for t in token_ids]
        n_tokens = len(token_ids)
        needed_blocks = max(1, -(-n_tokens // self.block_size))

        cached: List[int] = []
        if self.enable_prefix_cache:
            self.stats.prefix_queries += 1
            self.stats.prefix_total_tokens += n_tokens
            cached = self.radix.match_prefix(token_ids)
            # never reuse the *entire* prompt from cache: the last token's
            # logits must be recomputed, so keep at least one token fresh
            while cached and len(cached) * self.block_size >= n_tokens:
                cached.pop()
        num_cached_tokens = len(cached) * self.block_size
        self.stats.prefix_hit_tokens += num_cached_tokens
        if cached:
            self.stats.l1_hits += len(cached)
        else:
            self.stats.misses += 1

        blocks: List[int] = []
        try:
            for bid in cached:
                meta = self.metas[bid]
                if bid in self.cached_lru:  # revive from cached → active
                    del self.cached_lru[bid]
                    self.stats.cached_blocks -= 1
                    meta.ref_count = 1
                else:
                    meta.incref()
                meta.touch()
                blocks.append(bid)
            for _ in range(needed_blocks - len(blocks)):
                blocks.append(self._pop_free_block())
        except OutOfBlocksError:
            # undo exactly what was done: drop OUR reference only; a block
            # another sequence still holds must never reach the free list
            for bid in blocks:
                if self.metas[bid].decref() == 0:
                    self._deactivate_block(bid)
            raise
        self.seq_blocks[seq_id] = blocks
        self.seq_tokens[seq_id] = token_ids
        self.seq_shared_count[seq_id] = len(cached)
        return blocks, num_cached_tokens

    def append_token(self, seq_id: str, token_id: int) -> Optional[int]:
        """Account one generated token; returns a newly allocated block id if
        the sequence crossed a block boundary, else None. Applies CoW if the
        tail block is shared."""
        blocks = self.seq_blocks[seq_id]
        tokens = self.seq_tokens[seq_id]
        pos = len(tokens)
        tokens.append(token_id)
        logical = pos // self.block_size
        if logical >= len(blocks):
            bid = self._pop_free_block()
            blocks.append(bid)
            return bid
        tail = blocks[logical]
        meta = self.metas[tail]
        if meta.is_shared:
            new_bid = self._pop_free_block()
            meta.decref()
            blocks[logical] = new_bid
            self.pending.copies.append((tail, new_bid))
            self.stats.cow_copies += 1
            return new_bid
        return None

    def reserve_tokens(self, seq_id: str, n: int) -> List[int]:
        """Pre-allocate blocks so the sequence can grow by ``n`` tokens without
        further allocation (required before a multi-step decode, where the
        host cannot allocate mid-loop). Also copy-on-writes a shared tail
        block. Returns newly allocated block ids."""
        blocks = self.seq_blocks[seq_id]
        cur = len(self.seq_tokens[seq_id])
        needed = max(1, -(-(cur + n) // self.block_size))
        added: List[int] = []
        # CoW the block the next token lands in, if shared
        logical = cur // self.block_size
        if logical < len(blocks):
            tail = blocks[logical]
            meta = self.metas[tail]
            if meta.is_shared:
                new_bid = self._pop_free_block()
                meta.decref()
                blocks[logical] = new_bid
                self.pending.copies.append((tail, new_bid))
                self.stats.cow_copies += 1
                added.append(new_bid)
        while len(blocks) < needed:
            bid = self._pop_free_block()
            blocks.append(bid)
            added.append(bid)
        return added

    def trim_reserved(self, seq_id: str) -> List[int]:
        """Release trailing reserved blocks beyond what the sequence's
        tokens (committed + pending) occupy, leaving it holding exactly
        ``ceil(len(seq_tokens)/block_size)`` blocks. Returns the freed ids."""
        blocks = self.seq_blocks[seq_id]
        needed = max(1, -(-len(self.seq_tokens[seq_id]) // self.block_size))
        freed: List[int] = []
        while len(blocks) > needed:
            bid = blocks.pop()
            meta = self.metas.get(bid)
            # reserved tail blocks are exclusively owned and unindexed, but
            # go through decref/_deactivate_block so an unexpected share
            # can never be force-freed
            if meta is not None and meta.decref() == 0:
                self._deactivate_block(bid)
            freed.append(bid)
        return freed

    def commit_tokens(self, seq_id: str, token_ids: Sequence[int]) -> None:
        """Record tokens whose KV was written on-device into already-reserved
        blocks (the multi-step decode path's post-loop bookkeeping)."""
        self.seq_tokens[seq_id].extend(int(t) for t in token_ids)
        if (len(self.seq_tokens[seq_id]) + self.block_size - 1) // self.block_size \
                > len(self.seq_blocks[seq_id]):
            raise RuntimeError(
                f"sequence {seq_id} outgrew its reserved blocks — reserve_tokens "
                "must cover the decode horizon"
            )

    def release_out_of_window(self, seq_id: str, window: int) -> List[int]:
        """Sliding-window models: free leading blocks every future query is
        past. A query at position p sees keys in (p - window, p]; the
        earliest future query is the pending token at position cur - 1, so
        only keys ≤ cur - 1 - window are dead. Freed logical slots are
        pinned to the pad block 0 — the window mask already drops those
        positions, so a pad-block read is never visible. Returns the
        released logical indices (the engine zeroes its block-table rows)."""
        blocks = self.seq_blocks[seq_id]
        cur = len(self.seq_tokens[seq_id])
        released: List[int] = []
        lb = self.seq_window_front.get(seq_id, 0)
        while lb < len(blocks):
            # block lb covers positions [lb*Bk, (lb+1)*Bk); dead iff its last
            # position (lb+1)*Bk - 1 ≤ cur - 1 - window
            if (lb + 1) * self.block_size > cur - window:
                break
            bid = blocks[lb]
            meta = self.metas.get(bid)
            if meta is not None and meta.decref() == 0:
                self._deactivate_block(bid)
            blocks[lb] = 0
            released.append(lb)
            lb += 1
        if released:
            self.seq_window_front[seq_id] = lb
            self.stats.window_released_blocks += len(released)
        return released

    def free_sequence(self, seq_id: str, cache: bool = True) -> None:
        """Release a sequence's blocks; full blocks are kept as prefix cache
        (ref 0, LRU-ordered) when ``cache=True``."""
        blocks = self.seq_blocks.pop(seq_id)
        tokens = self.seq_tokens.pop(seq_id, [])
        self.seq_shared_count.pop(seq_id, None)
        n_full = len(tokens) // self.block_size
        if self.seq_window_front.pop(seq_id, 0) > 0 or 0 in blocks[:n_full]:
            # window-released leading blocks: the chain is no longer a valid
            # prefix, so it cannot enter the radix index
            cache = False
        if cache and self.enable_prefix_cache and n_full > 0:
            self.radix.insert(tokens, blocks[:n_full])
        for bid in blocks:
            meta = self.metas.get(bid)
            if meta is None:
                continue
            if meta.decref() == 0:
                self._deactivate_block(bid)

    def _scrub_pending_for(self, bid: int) -> None:
        """Withdraw staged copies whose DESTINATION returns to the free
        list: the id can be reallocated before the ops apply, and a stale
        copy would clobber the new owner's page. A freed source's bytes
        stay intact until the id is reallocated and rewritten."""
        p = self.pending
        if p.copies:
            p.copies = [c for c in p.copies if c[1] != bid]

    def _deactivate_block(self, bid: int) -> None:
        """A block whose refcount just hit 0: park it as reusable cache if the
        radix still indexes it (interior nodes CANNOT be freed — descendant
        chains would dangle); otherwise return it to the free list."""
        if self.radix.contains_block(bid):
            self.cached_lru[bid] = None
            self.cached_lru.move_to_end(bid)
            self.stats.cached_blocks += 1
        else:
            self.metas.pop(bid, None)
            self._scrub_pending_for(bid)
            self.free_list.append(bid)

    # -- engine handshake ---------------------------------------------------

    def take_pending_ops(self) -> PendingDeviceOps:
        ops, self.pending = self.pending, PendingDeviceOps()
        return ops

    def block_table_for(self, seq_id: str, max_blocks: int, pad: int = 0) -> np.ndarray:
        blocks = self.seq_blocks[seq_id]
        if len(blocks) > max_blocks:
            raise ValueError(
                f"sequence {seq_id} uses {len(blocks)} blocks > table width {max_blocks}"
            )
        table = np.full((max_blocks,), pad, dtype=np.int32)
        table[: len(blocks)] = blocks
        return table

    def get_stats(self) -> Dict[str, Any]:
        self.stats.free_blocks = len(self.free_list)
        return self.stats.as_dict()
