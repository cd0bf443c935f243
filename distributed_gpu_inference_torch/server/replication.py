"""Proactive prefix replication: the plane watches prefix
hit-VELOCITY at discovery time and, when a prefix is heating up, rides
``kv_replicate`` hints down the heartbeat response to workers that do
not hold it — each hint is one budget/backoff-bounded ``/kv/export``
pull on the worker (``engines/llm.kv_replicate``), so a storm
workload's prefix hits arrive BEFORE the burst instead of during it.

Stance (same as every routing signal here):

- **Advisory.** A hint the worker drops (budget full, peer dead, fp
  churned out of the exporter's map) costs nothing — the plane re-hints
  after a cooldown, and the reactive migrate path still exists. A wrong
  prediction costs one prefetch worth of bandwidth, never correctness.
- **Bounded.** Heat state is a bounded LRU of fingerprint chains;
  hints are capped per heartbeat; each (worker, prefix) pair is
  re-hinted at most once per ``replicate_cooldown_s``.
- **Off by default.** ``RoutingConfig.replicate`` gates both the heat
  accounting and the hint fan-out; off means the heartbeat response is
  byte-identical to a plane without replication.

The port's copy of ``distributed_gpu_inference_tpu/server/replication.py``, on the
standard library and the port's own modules.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Any, Deque, Dict, List, Optional, Sequence

from .prefix_routing import PrefixRegistry, RoutingConfig


class _Heat:
    __slots__ = ("fps", "hits")

    def __init__(self, fps: List[str]) -> None:
        self.fps = fps              # full boundary chain, depth order
        self.hits: Deque[float] = deque()


class ReplicationPlanner:
    """Discovery-time heat tracker + per-heartbeat hint planner."""

    # bounded heat state: prefixes beyond this evict coldest-first
    _MAX_PREFIXES = 1024
    # bounded cooldown map: (worker, fp) pairs beyond this evict oldest
    _MAX_COOLDOWNS = 8192

    def __init__(self, cfg: RoutingConfig,
                 registry: PrefixRegistry) -> None:
        self.cfg = cfg
        self.registry = registry
        self._lock = threading.Lock()
        # deepest-fp -> _Heat; insertion/touch order = LRU
        self._heat: "OrderedDict[str, _Heat]" = OrderedDict()
        # (worker_id, deepest-fp) -> last hint time
        self._cooldown: "OrderedDict[tuple, float]" = OrderedDict()
        self.stats = {"queries": 0, "hot": 0, "hints": 0}

    # -- discovery-time accounting ------------------------------------------

    def note_query(self, fps: Sequence[str],
                   now: Optional[float] = None) -> None:
        """One discovery query carried this fingerprint chain: record a
        hit on EVERY boundary it traverses, not just the deepest — a
        chat turn extends its conversation's chain with a fresh deepest
        fp each time, but the shared head (system prompt, earlier turns)
        recurs, and that shared part is what is worth replicating.
        Boundaries are content-addressed (cumulative hashes), so one
        key always maps to one chain. Gated on the flag by the CALLER
        (the discovery handler) so the off path costs nothing."""
        if not fps:
            return
        now = time.time() if now is None else now
        window = max(0.1, self.cfg.replicate_window_s)
        with self._lock:
            chain = [str(f) for f in fps]
            for i, key in enumerate(chain):
                h = self._heat.get(key)
                if h is None:
                    h = self._heat[key] = _Heat(chain[:i + 1])
                else:
                    self._heat.move_to_end(key)
                h.hits.append(now)
                while h.hits and h.hits[0] < now - window:
                    h.hits.popleft()
            while len(self._heat) > self._MAX_PREFIXES:
                self._heat.popitem(last=False)
            self.stats["queries"] += 1

    # -- heartbeat-time planning --------------------------------------------

    def hints_for(self, worker_id: str,
                  sources: Sequence[Dict[str, Any]],
                  now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Hints for the worker that just heartbeated: hot prefixes it
        does NOT advertise that some OTHER worker with a live data plane
        does. ``sources`` are candidate exporter rows (id +
        data_plane_url — the caller lists them only while the flag is
        on, so the off path costs no store query). At most
        ``replicate_max_hints`` per beat; each (worker, prefix) pair
        respects ``replicate_cooldown_s``."""
        now = time.time() if now is None else now
        window = max(0.1, self.cfg.replicate_window_s)
        threshold = max(1, self.cfg.replicate_hot_threshold)
        exporters = {
            str(s["id"]): s for s in sources
            if s.get("data_plane_url") and str(s.get("id")) != worker_id
        }
        if not exporters:
            return []
        with self._lock:
            hot = []
            for key, h in self._heat.items():
                while h.hits and h.hits[0] < now - window:
                    h.hits.popleft()
                if len(h.hits) >= threshold:
                    hot.append((len(h.hits), key, list(h.fps)))
            # one hint per lineage, at the DEEPEST still-hot boundary: an
            # ancestor is heated by every query that traverses it, so a
            # hot entry that is a strict prefix of another hot entry says
            # nothing the deeper one doesn't — replicating the deeper
            # chain covers it
            covered = set()
            for _c, _key, fps in hot:
                covered.update(fps[:-1])
            hot = [t for t in hot if t[1] not in covered]
            # hottest first: the hint budget goes to the biggest storms
            hot.sort(key=lambda t: -t[0])
        out: List[Dict[str, Any]] = []
        for _hits, key, fps in hot:
            if len(out) >= max(1, self.cfg.replicate_max_hints):
                break
            # the heartbeating worker already holds ANY of it → skip: the
            # reactive path (or a prior hint) is mid-landing, and a
            # partial-overlap prefetch would re-ship what it has
            n, _tw = self.registry.match_blocks(worker_id, fps, now=now)
            if n > 0:
                continue
            ck = (worker_id, key)
            with self._lock:
                last = self._cooldown.get(ck)
                if last is not None and \
                        now - last < self.cfg.replicate_cooldown_s:
                    continue
            src_id, src_blocks, src_tier = self.registry.best_match(
                list(exporters), fps, now=now,
            )
            if src_id is None or src_blocks <= 0:
                continue   # nobody exportable advertises it (anymore)
            with self._lock:
                self._cooldown[ck] = now
                while len(self._cooldown) > self._MAX_COOLDOWNS:
                    self._cooldown.popitem(last=False)
                self.stats["hints"] += 1
            out.append({
                "fps": fps,
                "worker_id": src_id,
                "data_plane_url": exporters[src_id]["data_plane_url"],
                "tier": src_tier,
            })
        if out:
            self.stats["hot"] += 1
        return out

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "tracked_prefixes": len(self._heat),
                **self.stats,
            }
