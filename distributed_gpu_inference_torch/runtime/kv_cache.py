"""Host-side paged KV-cache management: block allocator, radix prefix index,
copy-on-write, LRU eviction, and spill tiers (device → host RAM → remote
store).

The port's own copy of ``distributed_gpu_inference_tpu/runtime/kv_cache.py``.
The device side is the engine's pool tensors ``[L, N, Hkv, block, D]``;
this module owns the metadata (free list, refcounts, radix tree, LRU order,
tier maps) and hands the device effects it decides on — spill downloads,
copy-on-write page copies, spill-restore uploads — to the engine as a
:class:`PendingDeviceOps` list. Block 0 is reserved as the pad block and is
never allocated.

Spill entries: a page is ``[L, 2, Hkv, Bk, D]`` (K and V stacked on axis 1,
the JAX layout) in the pool's dtype, on the host; an int8 pool's page
travels with its scales, ``[L, 2, Bk]`` bf16 here (one scale per token,
the port's compact layout) and ``[L, 2, Bk, D]`` on the remote wire (the
JAX layout, every lane equal). The host tier keeps (page, scale) tensors;
the remote tier keeps :func:`_pack_spill` frames, byte-compatible with the
JAX package's, under the same :func:`compute_prefix_hash` keys — one remote
store serves both packages, and the dtype screen keeps bf16, int8 and fp8
entries apart.
"""

from __future__ import annotations

import logging
import time
import zlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from distributed_gpu_inference_torch.runtime.io_guard import (
    IOBreaker,
    breaker_env_config,
)
from distributed_gpu_inference_torch.testing import faults as _faults
from distributed_gpu_inference_torch.utils import serialization
from distributed_gpu_inference_torch.utils.data_structures import (
    KV_BLOCK_TOKENS,
    KVBlockMeta,
    compute_prefix_hash,
)

log = logging.getLogger("dgi_kv_spill")


class OutOfBlocksError(RuntimeError):
    pass


class SpillIntegrityError(ValueError):
    """A spilled entry failed its CRC — bit rot or a torn write. The probe
    path QUARANTINES the entry and degrades to the next tier or a
    recompute; this error never crosses a request."""


#: checksummed spill-entry framing: magic + CRC32 of the body. Entries
#: without the magic are the JAX package's legacy form, accepted unchecked.
_SPILL_MAGIC = b"SPL2"

# a spill entry: (page [L, 2, Hkv, Bk, D], scales [L, 2, Bk] or None)
SpillEntry = Tuple[torch.Tensor, Optional[torch.Tensor]]


def _pack_spill(page: torch.Tensor, scale_page: Optional[torch.Tensor]) -> bytes:
    """Remote wire form of a spilled block: magic + CRC32, then the
    length-prefixed page frame and the optional scale frame (expanded over
    the D lanes to the JAX layout ``[L, 2, Bk, D]``). One entry per block:
    page and scales are atomic by construction. Frames are ``TPUT``
    frames (``utils/serialization.py``) with the JAX serializer's default:
    zstd level 3 for a payload of 4,096 bytes or more, where smaller."""
    pb = serialization.serialize(page, compress=True)
    body = len(pb).to_bytes(8, "little") + pb
    if scale_page is not None:
        body += serialization.serialize(expand_scales(scale_page, page.shape[-1]),
                                        compress=True)
    return _SPILL_MAGIC + zlib.crc32(body).to_bytes(4, "little") + body


def expand_scales(scales: torch.Tensor, d: int) -> torch.Tensor:
    """Compact int8 scales ``[..., Bk]`` → the JAX layout ``[..., Bk, D]``
    (every lane of a token carries its one scale), a broadcast view."""
    return scales[..., None].expand(*scales.shape, d)


def compact_scales(wide: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`expand_scales` for a wire tensor of either
    package: ``[..., Bk, D]`` → ``[..., Bk]``, after checking that every
    lane of each token carries the same scale (bit for bit). Raises
    ``ValueError`` otherwise."""
    words = wide.view(torch.int16) if wide.element_size() == 2 else wide
    if not bool((words == words[..., :1]).all()):
        raise ValueError("int8 KV scales: the lanes of a token differ")
    return wide[..., 0].contiguous()


def _unpack_spill(raw: bytes) -> SpillEntry:
    """The inverse of :func:`_pack_spill` (either package's entries): CPU
    tensors, scales compacted to ``[L, 2, Bk]`` after checking every lane
    carries the same scale. Raises :class:`SpillIntegrityError` /
    ``ValueError`` for a bad entry and
    ``serialization.CodecUnavailable`` for a frame this process cannot
    decode."""
    if raw[:4] == _SPILL_MAGIC:
        if len(raw) < 8:
            raise SpillIntegrityError(
                f"torn spill entry: {len(raw)} bytes is shorter than the "
                "checksummed header"
            )
        want = int.from_bytes(raw[4:8], "little")
        raw = raw[8:]
        got = zlib.crc32(raw)
        if got != want:
            raise SpillIntegrityError(
                f"spill entry checksum mismatch: stored {want:#010x}, "
                f"computed {got:#010x} over {len(raw)} bytes"
            )
    n = int.from_bytes(raw[:8], "little")
    if 8 + n > len(raw):
        raise ValueError(
            f"malformed spill entry: {n}-byte page blob overruns the "
            f"{len(raw)}-byte entry"
        )
    page = serialization.deserialize(raw[8:8 + n])
    scale = None
    if len(raw) > 8 + n:
        scale = compact_scales(serialization.deserialize(raw[8 + n:]))
    return page, scale


@dataclass
class PendingDeviceOps:
    """Device-side effects for the engine to apply before its next forward.

    downloads: (src_block, spill_key) pages to pull to the host BEFORE any
               write (spill-on-evict: the block id is about to be reused)
    copies:    (src_block, dst_block) page copies (copy-on-write)
    uploads:   (dst_block, page) spill-tier restores, ``page`` a host
               tensor ``[L, 2, Hkv, Bk, D]``
    scale_uploads: (dst_block, scales) the int8 scales of those restores,
               ``[L, 2, Bk]`` bf16
    """

    downloads: List[Tuple[int, str]] = field(default_factory=list)
    copies: List[Tuple[int, int]] = field(default_factory=list)
    uploads: List[Tuple[int, torch.Tensor]] = field(default_factory=list)
    scale_uploads: List[Tuple[int, torch.Tensor]] = field(default_factory=list)

    def merge(self, other: "PendingDeviceOps") -> None:
        self.downloads.extend(other.downloads)
        self.copies.extend(other.copies)
        self.uploads.extend(other.uploads)
        self.scale_uploads.extend(other.scale_uploads)

    @property
    def empty(self) -> bool:
        return not (self.downloads or self.copies or self.uploads
                    or self.scale_uploads)


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


def make_radix_index(block_size: int = KV_BLOCK_TOKENS):
    """The prefix index: the C++ one (``native/src/radix_index.cpp``, built
    at first use) when it builds and loads, else the exact-semantics Python
    :class:`RadixPrefixIndex` with a logged warning."""
    try:
        from distributed_gpu_inference_torch import native

        if native.native_available():
            from distributed_gpu_inference_torch.native.radix import NativeRadixPrefixIndex

            return NativeRadixPrefixIndex(block_size)
        logging.getLogger("torch_native").warning(
            "native radix index unavailable, using the Python fallback")
    except Exception as exc:  # noqa: BLE001 — any native fault: the fallback, said
        logging.getLogger("torch_native").warning(
            "native radix index unavailable, using the Python fallback: %s", exc)
    return RadixPrefixIndex(block_size)


@dataclass
class KVCacheStats:
    """Hit-rate and pool statistics."""

    prefix_queries: int = 0
    prefix_hit_tokens: int = 0
    prefix_total_tokens: int = 0
    l1_hits: int = 0
    l2_hits: int = 0
    l3_hits: int = 0
    misses: int = 0
    evictions: int = 0
    spills: int = 0
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


class HostKVStore:
    """L2 host-RAM spill tier: block-content-keyed entries with an LRU cap.

    An entry is one spilled block, ``(page, scales | None)`` — one LRU slot
    per block, so ``max_blocks`` means what it says. Entries are pageable
    host tensors (the tier can hold gigabytes; only the engine's transfer
    staging is pinned)."""

    def __init__(self, max_blocks: int = 1024) -> None:
        self.max_blocks = max_blocks
        self._store: "OrderedDict[str, Any]" = OrderedDict()

    def get(self, key: str) -> Optional[Any]:
        # seam: host-tier IO (an injected error models the host pool's
        # allocation failing; corrupt/torn kinds live on the remote tier)
        _faults.io_fault("io.spill.host.get", key=key)
        entry = self._store.get(key)
        if entry is not None:
            self._store.move_to_end(key)
        return entry

    def put(self, key: str, value: Any) -> None:
        if self.max_blocks <= 0:
            return
        _faults.io_fault("io.spill.host.put", key=key)
        self._store[key] = value
        self._store.move_to_end(key)
        while len(self._store) > self.max_blocks:
            self._store.popitem(last=False)

    def delete(self, key: str) -> None:
        """Quarantine hook: drop one entry (no seam — evicting a bad entry
        must never be blockable by the fault that exposed it)."""
        self._store.pop(key, None)

    def __len__(self) -> int:
        return len(self._store)


class RemoteKVStore:
    """L3 tier interface, in process: a TTL dict of :func:`_pack_spill`
    frames. ``runtime/redis_kv.py`` ``RedisKVStore`` is the same surface
    over a RESP store."""

    def __init__(self, ttl_s: float = 3600.0) -> None:
        self.ttl_s = ttl_s
        self._store: Dict[str, Tuple[float, bytes]] = {}

    def get(self, key: str) -> Optional[bytes]:
        item = self._store.get(key)
        if item is None:
            # the seam fires on a miss too (an io error is a failed READ,
            # hit or not); mutating kinds pass None through
            return _faults.io_bytes("io.spill.remote.get", None, key=key)
        expires, data = item
        if time.monotonic() > expires:
            del self._store[key]
            return None
        # seam: corrupt reads flip a byte, short reads truncate, errors
        # raise OSError — what the entry CRC and the quarantine defend
        return _faults.io_bytes("io.spill.remote.get", data, key=key)

    def put(self, key: str, data: bytes) -> None:
        # seam: a torn write persists only a prefix, caught by the CRC
        data = _faults.io_bytes("io.spill.remote.put", data, key=key)
        self._store[key] = (time.monotonic() + self.ttl_s, data)

    def delete(self, key: str) -> None:
        """Quarantine hook: evict one (corrupt) entry."""
        self._store.pop(key, None)


def _as_torch_dtype(dtype: Any) -> Optional[torch.dtype]:
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return serialization.dtype_from_name(str(dtype))


class PagedKVCacheManager:
    """Metadata brain for the device KV pools:

    - allocate/free per-sequence block chains with rollback on exhaustion
    - radix prefix reuse with refcounted sharing + copy-on-write
    - LRU eviction of cached (ref==0) leaf blocks, optional spill to L2/L3
    - emits :class:`PendingDeviceOps` for the engine's pool updates
    """

    def __init__(
        self,
        num_blocks: int,
        block_size: int = KV_BLOCK_TOKENS,
        enable_prefix_cache: bool = True,
        host_store: Optional[HostKVStore] = None,
        remote_store: Optional[Any] = None,
        spill_on_evict: bool = False,
        kv_dtype: Optional[Any] = None,
        page_shape: Optional[Tuple[int, ...]] = None,
    ) -> None:
        """``kv_dtype``: the engine's pool dtype (a torch dtype or its wire
        name) — a probed entry must match it exactly (a store shared across
        engines must never hand a bf16 engine int8 codes), and int8 entries
        must carry their scales. ``page_shape``: the engine's page shape
        ``[L, 2, Hkv, Bk, D]``; an entry of another shape (another model
        under the same token keys) is a miss. None disables either screen
        (a manager used alone in tests)."""
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (block 0 is reserved)")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.enable_prefix_cache = enable_prefix_cache
        self.host_store = host_store
        self.remote_store = remote_store
        self.spill_on_evict = spill_on_evict
        self.kv_dtype = _as_torch_dtype(kv_dtype)
        self.quantized_kv = self.kv_dtype == torch.int8
        self.page_shape = tuple(page_shape) if page_shape is not None else None

        # per-tier circuit breakers + cumulative error/quarantine counters:
        # a tier put/get that raises is counted and SKIPPED — an optional
        # cache tier never fails an eviction or a request — and a tier
        # failing repeatedly trips open so serving stops paying its latency.
        # Counters ride the heartbeat (spill_wire_stats → engine_stats
        # ["kv_spill"]).
        bcfg = breaker_env_config()
        self.breakers: Dict[str, IOBreaker] = {}
        if not bcfg["disabled"]:
            for tier in ("host", "remote"):
                self.breakers[tier] = IOBreaker(
                    tier, threshold=bcfg["threshold"],
                    open_s=bcfg["open_s"], jitter=bcfg["jitter"],
                )
        self.spill_io: Dict[str, int] = {
            "host_put_errors": 0, "host_get_errors": 0,
            "remote_put_errors": 0, "remote_get_errors": 0,
            "host_quarantined_corrupt": 0, "remote_quarantined_corrupt": 0,
            "breaker_skips": 0,
        }
        # remote entries this process could not decode (a zstd frame
        # made with a dictionary): a miss, the entry left in place for
        # peers that can read it
        self.codec_misses = 0

        self.metas: Dict[int, KVBlockMeta] = {}
        self.free_list: List[int] = list(range(num_blocks - 1, 0, -1))  # pop() → 1..
        self.cached_lru: "OrderedDict[int, None]" = OrderedDict()  # ref==0, indexed
        self.radix = make_radix_index(block_size)
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
        # seam: a fired ``pressure`` rule makes this allocation see a pool
        # with zero free blocks — the OutOfBlocksError a saturated pool
        # raises, so seeded storms drive preempt → spill → resume
        if _faults.kv_pressure("kv.block.alloc", num_free=len(self.free_list)):
            raise OutOfBlocksError(
                f"KV pool exhausted (kv_pressure fault injected with "
                f"{len(self.free_list)} actually free)"
            )
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

    def clear_cached(self, spill: bool = False) -> int:
        """Drop EVERY reclaimable cached block back to the free list → the
        count dropped (a cold start for a measurement, an admin flush).
        ``spill`` False suppresses spill-on-evict, so a flush does not flood
        the tiers with pages nobody asked to keep."""
        n = 0
        saved = self.spill_on_evict
        self.spill_on_evict = spill and saved
        try:
            # leaf at a time: parents become leaves as children go
            while self.cached_lru:
                self.free_list.append(self._evict_one())
                n += 1
        finally:
            self.spill_on_evict = saved
        return n

    def _evict_block(self, bid: int) -> None:
        meta = self.metas.pop(bid, None)
        if self.cached_lru.pop(bid, False) is None:
            # was present (values are literal None): keep the gauge honest
            self.stats.cached_blocks -= 1
        if self.spill_on_evict and meta is not None and meta.prefix_hash \
                and (self.host_store is not None
                     or self.remote_store is not None):
            # the block id is about to be reused: the engine pulls the page
            # to the host FIRST (downloads run before any write in
            # _apply_pending) and hands it to store_spilled()
            self.pending.downloads.append((bid, meta.prefix_hash))
            self.stats.spills += 1
        self.radix.remove_block(bid)
        self.stats.evictions += 1

    # -- spill tiers: breaker gating + error isolation ----------------------

    def _tier_allow(self, tier: str) -> bool:
        """Breaker gate for one tier; an open breaker skips the tier (and
        counts the skip)."""
        br = self.breakers.get(tier)
        if br is None or br.allow():
            return True
        self.spill_io["breaker_skips"] += 1
        return False

    def _tier_result(self, tier: str, ok: bool, op: str) -> None:
        br = self.breakers.get(tier)
        if ok:
            if br is not None:
                br.record_success()
            return
        self.spill_io[f"{tier}_{op}_errors"] += 1
        if br is not None:
            br.record_failure()
            if not br.closed:
                log.warning("spill tier %r breaker %s after %s failure",
                            tier, br.state, op)

    def _quarantine(self, tier: str, key: str, reason: str) -> None:
        """A provably bad entry (CRC mismatch, torn frame) is deleted from
        its tier — best effort: the delete failing must not block the
        degraded read path — and counted."""
        store = self.host_store if tier == "host" else self.remote_store
        try:
            delete = getattr(store, "delete", None)
            if delete is not None:
                delete(key)
        except Exception:  # noqa: BLE001 — quarantine is best-effort
            pass
        self.spill_io[f"{tier}_quarantined_{reason}"] += 1

    def spill_wire_stats(self) -> Dict[str, int]:
        """Cumulative spill-IO counters + breaker states for the heartbeat
        ``engine_stats["kv_spill"]`` channel."""
        out = dict(self.spill_io)
        for tier, br in self.breakers.items():
            out[f"breaker_{tier}_state"] = br.state_code
            out[f"breaker_{tier}_trips"] = br.trips
        return out

    def store_spilled(self, key: str, page: torch.Tensor,
                      scale_page: Optional[torch.Tensor] = None) -> None:
        """Engine callback with an evicted page on the host: the L2 entry,
        and write-through to L3. ``scale_page`` (int8 pools, ``[L, 2, Bk]``)
        is stored WITH the page, one atomic entry per block in both tiers.

        Tier writes are ISOLATED: a raising put is counted and skipped —
        losing a spill is a future miss, never a failed eviction — and a
        tier failing repeatedly trips its breaker."""
        if self.host_store is not None and self._tier_allow("host"):
            try:
                self.host_store.put(key, (page, scale_page))
            except Exception:  # noqa: BLE001 — optional tier, never fatal
                self._tier_result("host", False, "put")
            else:
                self._tier_result("host", True, "put")
        if self.remote_store is not None and self._tier_allow("remote"):
            try:
                self.remote_store.put(key, _pack_spill(page, scale_page))
            except Exception:  # noqa: BLE001 — optional tier, never fatal
                self._tier_result("remote", False, "put")
            else:
                self._tier_result("remote", True, "put")

    def _spill_entry_valid(self, page: torch.Tensor,
                           scale: Optional[torch.Tensor]) -> bool:
        """Screen a probed entry BEFORE adopting or promoting it: the page
        dtype must be the pool's (the wire names the dtype; a mismatch is a
        miss, never a cast), int8 entries must carry scales, and the page
        must have this engine's shape."""
        if self.kv_dtype is not None and page.dtype != self.kv_dtype:
            return False
        if self.quantized_kv and scale is None:
            return False
        if self.page_shape is not None and tuple(page.shape) != self.page_shape:
            return False
        return True

    def _probe_spill(self, key: str) -> Optional[SpillEntry]:
        """Probe the tiers for a spilled block → (page, scales | None), or
        None on a miss. An L3 hit is promoted to L2 after validation.

        A raising tier get is counted, charged to the breaker and falls
        through to the next tier; a corrupt L3 entry is QUARANTINED and
        degrades to a miss; a failing promote never discards the fetched
        page. Nothing here can fail the request that probed."""
        if self.host_store is not None and self._tier_allow("host"):
            entry: Any = None
            try:
                entry = self.host_store.get(key)
            except Exception:  # noqa: BLE001 — fall through to L3
                self._tier_result("host", False, "get")
            else:
                self._tier_result("host", True, "get")
            if entry is not None:
                page, scale = entry
                if self._spill_entry_valid(page, scale):
                    self.stats.l2_hits += 1
                    return page, scale
                return None
        if self.remote_store is not None and self._tier_allow("remote"):
            raw = None
            try:
                raw = self.remote_store.get(key)
            except Exception:  # noqa: BLE001 — degraded tier = miss
                self._tier_result("remote", False, "get")
            else:
                self._tier_result("remote", True, "get")
            if raw is not None:
                try:
                    page, scale = _unpack_spill(raw)
                except serialization.CodecUnavailable:
                    self.codec_misses += 1
                    return None
                except Exception:  # noqa: BLE001 — any bad frame
                    # corrupt entry: quarantine so the NEXT probe does not
                    # pay the decode-and-fail tax again, then miss
                    self._quarantine("remote", key, "corrupt")
                    return None
                if self._spill_entry_valid(page, scale):
                    self.stats.l3_hits += 1
                    if self.host_store is not None:
                        # promote-on-hit is advisory: a failing host put
                        # must NOT discard the page already fetched
                        try:
                            self.host_store.put(key, (page, scale))
                        except Exception:  # noqa: BLE001
                            self._tier_result("host", False, "put")
                    return page, scale
        return None

    # -- sequence lifecycle -------------------------------------------------

    def allocate_sequence(self, seq_id: str, token_ids: Sequence[int]) -> Tuple[List[int], int]:
        """Allocate the block chain for a prompt. Returns (block_ids,
        num_cached_tokens) — the first ``num_cached_tokens`` positions already
        hold valid KV from the prefix cache or a spill tier (the engine skips
        recomputing them; restored pages are staged as uploads). Rolls back
        on exhaustion."""
        if seq_id in self.seq_blocks:
            raise ValueError(f"sequence {seq_id} already allocated")
        if isinstance(token_ids, np.ndarray):
            token_ids = token_ids.tolist()
        else:
            token_ids = [int(t) for t in token_ids]
        n_tokens = len(token_ids)
        needed_blocks = max(1, -(-n_tokens // self.block_size))

        cached: List[int] = []
        spill_pages: List[SpillEntry] = []
        if self.enable_prefix_cache:
            self.stats.prefix_queries += 1
            self.stats.prefix_total_tokens += n_tokens
            cached = self.radix.match_prefix(token_ids)
            # never reuse the *entire* prompt from cache: the last token's
            # logits must be recomputed, so keep at least one token fresh
            while cached and len(cached) * self.block_size >= n_tokens:
                cached.pop()
            # past the L1 match: probe the spill tiers block by block —
            # restored pages upload into fresh blocks, the same
            # fresh-token rule applies
            if self.host_store is not None or self.remote_store is not None:
                idx = len(cached)
                while (idx + 1) * self.block_size < n_tokens:
                    key = compute_prefix_hash(
                        token_ids, (idx + 1) * self.block_size
                    )
                    hit = self._probe_spill(key)
                    if hit is None:
                        break
                    spill_pages.append(hit)
                    idx += 1
        num_cached_tokens = (len(cached) + len(spill_pages)) * self.block_size
        self.stats.prefix_hit_tokens += num_cached_tokens
        if cached or spill_pages:
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
            for page, scale_page in spill_pages:
                bid = self._pop_free_block()
                self.pending.uploads.append((bid, page))
                if scale_page is not None:
                    self.pending.scale_uploads.append((bid, scale_page))
                blocks.append(bid)
            for _ in range(needed_blocks - len(blocks)):
                blocks.append(self._pop_free_block())
        except OutOfBlocksError:
            # undo exactly what was done: drop OUR reference only; a block
            # another sequence still holds must never reach the free list.
            # Staged uploads for OUR fresh blocks must not fire either.
            ours = set(blocks) - set(cached)
            if ours:
                self.pending.uploads = [
                    (b, p) for b, p in self.pending.uploads if b not in ours
                ]
                self.pending.scale_uploads = [
                    (b, p) for b, p in self.pending.scale_uploads
                    if b not in ours
                ]
            for bid in blocks:
                if self.metas[bid].decref() == 0:
                    self._deactivate_block(bid)
            raise
        if spill_pages:
            # index the restored chain so concurrent/future requests hit L1
            n_idx = len(cached) + len(spill_pages)
            self.radix.insert(
                token_ids[: n_idx * self.block_size], blocks[:n_idx]
            )
        self.seq_blocks[seq_id] = blocks
        self.seq_tokens[seq_id] = token_ids
        self.seq_shared_count[seq_id] = len(cached) + len(spill_pages)
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

    def seed_window_front(self, seq_id: str, front_blocks: int) -> List[int]:
        """Replicate a donor's sliding-window release state on an adopted
        sequence (KV handoff): force-release the leading ``front_blocks``
        logical blocks — decref/free the physical blocks, pin the chain
        entries to pad block 0, and record ``seq_window_front`` so
        ``free_sequence`` keeps the truncated chain out of the radix index.
        Returns the released logical indices."""
        blocks = self.seq_blocks[seq_id]
        released: List[int] = []
        lb = self.seq_window_front.get(seq_id, 0)
        while lb < min(front_blocks, len(blocks)):
            bid = blocks[lb]
            if bid != 0:
                meta = self.metas.get(bid)
                if meta is not None and meta.decref() == 0:
                    self._deactivate_block(bid)
            blocks[lb] = 0
            released.append(lb)
            lb += 1
        if lb > self.seq_window_front.get(seq_id, 0):
            self.seq_window_front[seq_id] = lb
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
        for i, bid in enumerate(blocks):
            meta = self.metas.get(bid)
            if meta is None:
                continue
            if meta.decref() == 0:
                if cache and self.enable_prefix_cache and i < n_full and \
                        self.radix.contains_block(bid):
                    # the spill key of the block's prefix, should it be
                    # evicted later
                    meta.prefix_hash = compute_prefix_hash(
                        tokens, (i + 1) * self.block_size)
                self._deactivate_block(bid)

    def _scrub_pending_for(self, bid: int) -> None:
        """Withdraw staged device ops that reference a block returning to
        the free list: the id can be reallocated before the ops apply, and
        a stale upload or copy would clobber the new owner's page. Copies
        are filtered by DESTINATION only (a freed source's bytes stay
        intact until the id is reallocated and rewritten). Downloads are
        never scrubbed: a spill download is the evicted page's only copy."""
        p = self.pending
        if p.copies:
            p.copies = [c for c in p.copies if c[1] != bid]
        if p.uploads:
            p.uploads = [u for u in p.uploads if u[0] != bid]
        if p.scale_uploads:
            p.scale_uploads = [u for u in p.scale_uploads if u[0] != bid]

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
