"""Worker-side radix summary: the compact, bounded view of a worker's
prefix cache that rides heartbeats so the control plane can route for
locality (the JAX package's ``server/prefix_routing.py`` consumes it).

The port's own copy of ``distributed_gpu_inference_tpu/runtime/
prefix_summary.py``: the wire must be the same for the same prompts.

Design constraints, in order:

- **Bounded.** A worker serving millions of requests must advertise a
  fixed-size summary: entries are boundary fingerprints
  (``utils/prefixes.py``) held in an LRU of ``top_n`` — the *hot* set,
  not the whole radix tree.
- **Cheap on the hot path.** ``note()`` is called once per built request
  (one rolling-hash pass over ≤ ``MAX_PREFIX_BLOCKS`` blocks of text) and
  takes a lock only for dict bookkeeping.
- **Small on the wire.** Heartbeats carry deltas against the last state
  the server ACKed; a full snapshot goes out only on first contact or
  when the server asks for a resync (its view was lost — restart,
  missed delta, version change). The ack protocol is explicit because
  heartbeats are lossy: a delta is only committed as "known to the
  server" after the heartbeat round-trip succeeds.
- **Advisory.** Entries describe what was recently *seen* (and therefore
  very likely cached), not a transactional cache inventory. Eviction on
  the worker quietly invalidates entries; the server's staleness TTL and
  the engine's own prefix-cache probe bound the cost of a wrong hint to
  one re-prefill.

Wire format (versioned — the server rejects unknown versions):

    full:  {"v": 1, "seq": S, "block_chars": B, "full": [[fp, d, t], ...]}
    delta: {"v": 1, "seq": S, "base_seq": S0, "block_chars": B,
            "add": [[fp, d, t], ...], "del": [fp, ...]}

``fp`` is a boundary fingerprint, ``d`` its 1-based block depth, ``t`` a
tier tag (``dev`` = device-resident, ``host`` = host-RAM spill tier,
``spill`` = REMOTE-store spill tier). Since round 13 the tag is priced by
the router's KV-migration cost model (a remote-tier pull costs more than
a dev-tier one), so workers advertise the tier their evicted KV actually
landed in, not a blanket demotion.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from ..utils.prefixes import (
    MAX_PREFIX_BLOCKS,
    PREFIX_BLOCK_CHARS,
    canonical_prompt_text,
    prefix_fingerprints,
)

SUMMARY_WIRE_VERSION = 1

TIER_DEVICE = "dev"
TIER_HOST = "host"
TIER_SPILL = "spill"


class PrefixHotSet:
    """Bounded LRU of hot prefix-boundary fingerprints + delta encoder."""

    def __init__(self, top_n: int = 128,
                 block_chars: int = PREFIX_BLOCK_CHARS,
                 max_blocks: int = MAX_PREFIX_BLOCKS) -> None:
        self.top_n = max(1, int(top_n))
        self.block_chars = int(block_chars)
        self.max_blocks = int(max_blocks)
        self._lock = threading.Lock()
        # fp -> (depth, tier); insertion/touch order IS the LRU order
        self._entries: "OrderedDict[str, Tuple[int, str]]" = OrderedDict()
        self.seq = 0
        # last state the server ACKed (None = never synced → send full)
        self._acked: Optional[Dict[str, Tuple[int, str]]] = None
        self._acked_seq = 0
        # state shipped in the last wire() payload, committed by ack()
        self._pending: Optional[Dict[str, Tuple[int, str]]] = None
        self._pending_seq = 0
        self.stats = {"notes": 0, "evicted": 0, "wire_full": 0,
                      "wire_delta": 0, "resyncs": 0}

    # -- hot-path recording --------------------------------------------------

    def note(self, prompt_or_messages: Any,
             tier: str = TIER_DEVICE) -> int:
        """Record one served prompt: every full-block boundary fingerprint
        of its canonical text enters (or refreshes) the hot set. Returns
        the number of boundaries recorded."""
        return self.note_fingerprints(
            prefix_fingerprints(
                canonical_prompt_text(prompt_or_messages),
                self.block_chars, self.max_blocks,
            ),
            tier=tier,
        )

    def note_fingerprints(self, fps: List[str],
                          tier: str = TIER_DEVICE) -> int:
        """Record an already-computed boundary-fingerprint chain (depth
        order). Split from :meth:`note` so callers that hold the chain —
        a completed proactive-replication pull advertising adopted KV, a
        request builder that also feeds the export fp→tokens map — skip
        the hash pass. Semantics identical to :meth:`note`."""
        if not fps:
            return 0
        with self._lock:
            for depth, fp in enumerate(fps, start=1):
                if fp in self._entries:
                    # refresh recency; deepen/repair tier but never let a
                    # shallower duplicate shrink a recorded depth
                    d0, _ = self._entries[fp]
                    self._entries[fp] = (max(d0, depth), tier)
                    self._entries.move_to_end(fp)
                else:
                    self._entries[fp] = (depth, tier)
            while len(self._entries) > self.top_n:
                self._entries.popitem(last=False)
                self.stats["evicted"] += 1
            self.seq += 1
            self.stats["notes"] += 1
        return len(fps)

    def clear(self) -> None:
        """Empty the hot set (e.g. the engine's prefix cache was wiped):
        the next :meth:`wire` advertises the deletions so the control
        plane stops routing to KV that no longer exists."""
        with self._lock:
            if self._entries:
                self._entries.clear()
                self.seq += 1

    def drop(self, fraction: float) -> int:
        """Forget the coldest ``fraction`` of entries — used when the pool
        evicts WITHOUT a spill tier: those blocks are simply gone, and
        keeping them advertised (even demoted) would over-promise KV the
        worker must fully re-prefill."""
        with self._lock:
            n = int(len(self._entries) * max(0.0, min(1.0, fraction)))
            for fp in list(self._entries.keys())[:n]:
                del self._entries[fp]
            if n:
                self.seq += 1
                self.stats["evicted"] += n
            return n

    def demote(self, fraction: float, tier: str = TIER_HOST) -> int:
        """Mark the coldest ``fraction`` of entries as spilled off-device
        (the engine calls this when its manager reports evictions with
        spill tiers enabled — an estimate, like everything here)."""
        with self._lock:
            n = int(len(self._entries) * max(0.0, min(1.0, fraction)))
            changed = 0
            for fp in list(self._entries.keys())[:n]:
                depth, t0 = self._entries[fp]
                if t0 == TIER_DEVICE:
                    self._entries[fp] = (depth, tier)
                    changed += 1
            if changed:
                self.seq += 1
            return changed

    def __len__(self) -> int:
        return len(self._entries)

    # -- wire protocol --------------------------------------------------------

    def wire(self) -> Optional[Dict[str, Any]]:
        """Build the next heartbeat payload, or None when the server is
        already up to date. The snapshot it describes is held as *pending*
        until :meth:`ack` (heartbeat succeeded) or :meth:`resync`
        (heartbeat lost / server asked for a full)."""
        with self._lock:
            snap = dict(self._entries)
            if self._acked is None:
                self._pending, self._pending_seq = snap, self.seq
                self.stats["wire_full"] += 1
                return {
                    "v": SUMMARY_WIRE_VERSION, "seq": self.seq,
                    "block_chars": self.block_chars,
                    "full": [[fp, d, t] for fp, (d, t) in snap.items()],
                }
            if self.seq == self._acked_seq:
                self._pending, self._pending_seq = snap, self.seq
                return None
            add = [
                [fp, d, t] for fp, (d, t) in snap.items()
                if self._acked.get(fp) != (d, t)
            ]
            dels = [fp for fp in self._acked if fp not in snap]
            if not add and not dels:
                # recency-only churn (note() refreshed LRU order but no
                # entry changed): the server's view is already identical —
                # adopt the seq locally instead of shipping an empty delta
                # (which would cost an ingest + summary DB write per
                # heartbeat, fleet-wide, forever in steady state)
                self._acked, self._acked_seq = snap, self.seq
                self._pending = None
                return None
            self._pending, self._pending_seq = snap, self.seq
            self.stats["wire_delta"] += 1
            return {
                "v": SUMMARY_WIRE_VERSION, "seq": self.seq,
                "base_seq": self._acked_seq,
                "block_chars": self.block_chars,
                "add": add, "del": dels,
            }

    def ack(self) -> None:
        """The heartbeat that carried the last :meth:`wire` payload landed
        (and the server did not ask for a resync): commit the pending
        snapshot as the server's known state."""
        with self._lock:
            if self._pending is not None:
                self._acked = self._pending
                self._acked_seq = self._pending_seq
                self._pending = None

    def resync(self) -> None:
        """Forget what the server knows — the next :meth:`wire` sends a
        full snapshot. Called when a heartbeat fails or the server
        answers ``prefix_summary_resync``."""
        with self._lock:
            self._acked = None
            self._pending = None
            self.stats["resyncs"] += 1

    def snapshot(self) -> Dict[str, Tuple[int, str]]:
        with self._lock:
            return dict(self._entries)

