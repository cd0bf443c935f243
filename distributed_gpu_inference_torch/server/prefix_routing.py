"""Control-plane half of cache-aware routing: per-worker prefix-summary
registry + the affinity scoring the scheduler and the direct-mode
discovery endpoint share.

Workers advertise bounded radix summaries over the heartbeat
``engine_stats.prefix_summary`` channel (``runtime/prefix_summary.py``
wire format); this registry validates (version, size, block basis),
applies deltas, persists per worker (store table
``worker_prefix_summaries``, so a control-plane restart warm-starts
instead of routing blind until every worker resyncs), and answers
synchronous in-memory match queries from the scoring paths.

Invariants the rest of the plane relies on:

- **Advisory only.** A summary never gates placement — it adds a bounded
  score bonus. Claim atomicity, epoch fencing, failover, and backpressure
  are untouched: a routed worker dying fails over exactly as before.
- **Staleness-tolerant.** Summaries older than ``staleness_ttl_s`` score
  zero (the worker may have restarted with a cold cache); a worker that
  never advertises is simply locality-unknown.
- **Bounded ingest.** Oversized summaries are truncated (counted), bad
  versions and mismatched block bases rejected (counted) — a misbehaving
  worker cannot bloat the heartbeat path or the registry.

The port's copy of ``distributed_gpu_inference_tpu/server/prefix_routing.py``, on the
standard library and the port's own modules.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..runtime.prefix_summary import SUMMARY_WIRE_VERSION
from ..utils.prefixes import PREFIX_BLOCK_CHARS, deepest_match

# score multiplier per advertised tier: device-resident KV beats a host
# spill (restore is an upload) beats a remote spill (restore is a fetch)
TIER_WEIGHT = {"dev": 1.0, "host": 0.7, "spill": 0.5}

# per-tier transfer-cost multiplier for the MIGRATE decision: a dev-tier
# pull is one pool gather on the source; a host-tier pull adds the host
# read; a remote ("spill") tier pull pays the remote fetch + L2 promote
# before a single byte crosses to the puller
MIGRATE_TIER_COST = {"dev": 1.0, "host": 1.25, "spill": 1.75}


@dataclass
class RoutingConfig:
    """Live-pushable routing knobs (admin ``PUT /api/v1/admin/routing``)."""

    enabled: bool = True
    # affinity is a bounded BONUS on top of the base score (reliability/
    # region/online/perf/load sum to 1.0) — never a hard pin
    affinity_weight: float = 0.2
    # a fully-loaded worker keeps only this fraction of its affinity bonus,
    # so a hot replica spills over to the fleet instead of starving it —
    # strictly below WEIGHTS["load"]/affinity_weight (0.05/0.2), so a
    # saturated cached worker LOSES to an idle cold one, never ties it
    min_headroom_factor: float = 0.2
    # server-side entry cap per worker (workers self-cap lower; this is the
    # defense against a misbehaving one)
    summary_max_entries: int = 256
    # summaries older than this score zero (worker restarted / went quiet)
    staleness_ttl_s: float = 120.0
    block_chars: int = PREFIX_BLOCK_CHARS
    # request fingerprints accepted per job / discovery call
    max_fps_per_request: int = 32
    # -- cluster-wide KV migration -------------------------------
    # master switch for the per-request route-to-warm / migrate-KV /
    # recompute cost model. OFF by default: routing behaves byte-identically
    # to the advisory affinity scoring
    kv_migrate: bool = False
    # matches shallower than this never migrate (the transfer setup isn't
    # worth a block or two of saved prefill)
    migrate_min_blocks: int = 2
    # cost-model estimates. Fingerprints are text-space, so token counts
    # are estimated as blocks × block_chars (exact for the byte tokenizer,
    # advisory for every other — same stance as affinity itself):
    #   transfer_s  = matched_tokens × bytes_per_token × tier_cost / bw
    #   prefill_s   = tokens / prefill_tokens_per_s
    #   queue_s     = (1 − graded headroom) × queue_wait_s
    # defaults sized for intra-cluster links (≥1 GB/s effective): per
    # token, transfer (~0.07 ms at 64 KiB/token) undercuts re-prefill
    # (~0.25 ms at 4k tok/s), so deep matches migrate; a WAN deployment
    # should push its measured bandwidth here or migration over-fires
    migrate_bytes_per_token: float = 65536.0
    migrate_bandwidth_bytes_per_s: float = 1e9
    migrate_prefill_tokens_per_s: float = 4000.0
    migrate_queue_wait_s: float = 2.0
    # -- cost-model self-calibration -----------------------------
    # master switch: when ON, decide-time calls substitute per-worker
    # MEASURED prefill tok/s, queue-wait and per-(worker, tier) handoff
    # bandwidth (server/calibration.py, fed from flight traces and the
    # worker kv_migrate wire counters) for the four static priors above.
    # OFF by default: routing is byte-identical to the static cost model —
    # ingestion still runs (the /admin/routing snapshot shows what WOULD
    # be used), but no decision reads a learned value
    calibrate: bool = False
    # EMA smoothing for each estimator (higher = reacts faster)
    calibrate_alpha: float = 0.3
    # once warm, a sample further than this factor from the running value
    # is clamped before blending (one 60 s GC pause must not poison the
    # queue-wait estimate)
    calibrate_clamp: float = 5.0
    # estimators answer None (→ caller keeps the prior) below this many
    # samples — never steer placement off one lucky measurement
    calibrate_min_samples: int = 3
    # sliding window for the in-flight migrate-hint tracker: hints older
    # than this are presumed resolved (pull done or abandoned) and stop
    # inflating the cold-side queue estimate. Always on with kv_migrate —
    # it is a correctness-of-estimate fix, not a predictor
    migrate_hint_window_s: float = 10.0
    # -- proactive prefix replication ----------------------------
    # master switch: the plane watches prefix hit-velocity at discovery
    # time and rides kv_replicate hints down the heartbeat response to
    # cold workers, which pull via the existing /kv/export protocol under
    # the same budget/backoff as reactive migration. OFF by default
    replicate: bool = False
    # a deepest-boundary fingerprint is "hot" at this many discovery hits
    # inside replicate_window_s
    replicate_hot_threshold: int = 3
    replicate_window_s: float = 10.0
    # hints per heartbeat response (each is one bounded pull on the worker)
    replicate_max_hints: int = 2
    # per-(worker, prefix) re-hint cooldown: a worker that dropped or
    # failed a hint is not re-asked until this elapses
    replicate_cooldown_s: float = 30.0

    def update(self, d: Dict[str, Any]) -> None:
        # validate EVERYTHING before applying ANYTHING: a 400 answer must
        # leave the live config untouched (a half-applied push would flip
        # the A/B switch while reporting failure)
        staged: Dict[str, Any] = {}
        for flag in ("enabled", "kv_migrate", "calibrate", "replicate"):
            if d.get(flag) is not None:
                v = d[flag]
                if isinstance(v, str):
                    # bool("false") is True — the ONE coercion that would
                    # silently invert an A/B switch for shell/curl callers
                    low = v.strip().lower()
                    if low in ("true", "1", "on"):
                        v = True
                    elif low in ("false", "0", "off"):
                        v = False
                    else:
                        raise ValueError(f"{flag}: not a boolean: {v!r}")
                elif not isinstance(v, bool):
                    raise ValueError(f"{flag}: not a boolean: {v!r}")
                staged[flag] = v
        for k, lo, hi in (("affinity_weight", 0.0, 10.0),
                          ("min_headroom_factor", 0.0, 1.0),
                          ("staleness_ttl_s", 1.0, float("inf")),
                          ("migrate_bytes_per_token", 1.0, float("inf")),
                          ("migrate_bandwidth_bytes_per_s", 1.0,
                           float("inf")),
                          ("migrate_prefill_tokens_per_s", 1.0,
                           float("inf")),
                          ("migrate_queue_wait_s", 0.0, float("inf")),
                          ("calibrate_alpha", 0.0, 1.0),
                          ("calibrate_clamp", 1.0, float("inf")),
                          ("migrate_hint_window_s", 0.1, float("inf")),
                          ("replicate_window_s", 0.1, float("inf")),
                          ("replicate_cooldown_s", 0.0, float("inf"))):
            if d.get(k) is not None:
                v = float(d[k])
                if not lo <= v <= hi:
                    raise ValueError(f"{k}: {v} outside [{lo}, {hi}]")
                staged[k] = v
        for k in ("summary_max_entries", "max_fps_per_request",
                  "migrate_min_blocks", "calibrate_min_samples",
                  "replicate_hot_threshold", "replicate_max_hints"):
            if d.get(k) is not None:
                v = int(d[k])
                if v < 1:
                    raise ValueError(f"{k}: must be >= 1, got {v}")
                staged[k] = v
        # the documented no-starvation invariant: a SATURATED cached
        # worker's floored bonus must stay below an idle cold worker's
        # entire load term, or affinity becomes a de-facto pin
        aw = staged.get("affinity_weight", self.affinity_weight)
        floor = staged.get("min_headroom_factor", self.min_headroom_factor)
        from .scheduler import WEIGHTS
        if aw * floor >= WEIGHTS["load"]:
            raise ValueError(
                f"affinity_weight * min_headroom_factor ({aw} * {floor}) "
                f"must stay below the load weight {WEIGHTS['load']} — "
                "otherwise a saturated cached worker outranks an idle "
                "cold one and affinity starves the fleet"
            )
        for k, v in staged.items():
            setattr(self, k, v)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "enabled": self.enabled,
            "affinity_weight": self.affinity_weight,
            "min_headroom_factor": self.min_headroom_factor,
            "summary_max_entries": self.summary_max_entries,
            "staleness_ttl_s": self.staleness_ttl_s,
            "block_chars": self.block_chars,
            "max_fps_per_request": self.max_fps_per_request,
            "kv_migrate": self.kv_migrate,
            "migrate_min_blocks": self.migrate_min_blocks,
            "migrate_bytes_per_token": self.migrate_bytes_per_token,
            "migrate_bandwidth_bytes_per_s":
                self.migrate_bandwidth_bytes_per_s,
            "migrate_prefill_tokens_per_s":
                self.migrate_prefill_tokens_per_s,
            "migrate_queue_wait_s": self.migrate_queue_wait_s,
            "calibrate": self.calibrate,
            "calibrate_alpha": self.calibrate_alpha,
            "calibrate_clamp": self.calibrate_clamp,
            "calibrate_min_samples": self.calibrate_min_samples,
            "migrate_hint_window_s": self.migrate_hint_window_s,
            "replicate": self.replicate,
            "replicate_hot_threshold": self.replicate_hot_threshold,
            "replicate_window_s": self.replicate_window_s,
            "replicate_max_hints": self.replicate_max_hints,
            "replicate_cooldown_s": self.replicate_cooldown_s,
        }


@dataclass
class IngestResult:
    applied: bool = False
    resync: bool = False          # tell the worker to send a full snapshot
    reason: Optional[str] = None  # counted rejection/truncation reason
    truncated: int = 0


@dataclass
class _WorkerSummary:
    seq: int = 0
    block_chars: int = PREFIX_BLOCK_CHARS
    # fp -> (depth, tier)
    entries: Dict[str, Tuple[int, str]] = field(default_factory=dict)
    updated_at: float = 0.0


class PrefixRegistry:
    """In-memory per-worker summaries with write-through persistence."""

    def __init__(self, config: Optional[RoutingConfig] = None) -> None:
        self.config = config or RoutingConfig()
        self._workers: Dict[str, _WorkerSummary] = {}
        self._loaded = False

    # -- persistence ---------------------------------------------------------

    async def ensure_loaded(self, store: Any) -> None:
        """Warm-start from the store once per process — after a restart the
        plane routes on persisted summaries until fresh heartbeats arrive
        (the staleness TTL guards against routing on ancient state)."""
        if self._loaded:
            return
        self._loaded = True
        try:
            # reclaim rows from long-dead worker ids while we're here —
            # worker churn must not grow this table forever (anything
            # past 10x the TTL could never score again anyway)
            await store.execute(
                "DELETE FROM worker_prefix_summaries WHERE updated_at < ?",
                (time.time() - 10.0 * self.config.staleness_ttl_s,),
            )
            rows = await store.query(
                "SELECT worker_id, seq, block_chars, entries, updated_at "
                "FROM worker_prefix_summaries"
            )
        except Exception:  # noqa: BLE001 — a missing table must not 500
            return
        import json

        for r in rows:
            if r.get("worker_id") in self._workers:
                # a fresh summary was ingested while we awaited the DB
                # (concurrent heartbeat during warm start) — never clobber
                # live state with the persisted pre-restart row
                continue
            try:
                raw = r.get("entries")
                ent = json.loads(raw) if isinstance(raw, str) else (raw or [])
                self._workers[r["worker_id"]] = _WorkerSummary(
                    seq=int(r.get("seq") or 0),
                    block_chars=int(r.get("block_chars")
                                    or self.config.block_chars),
                    entries={
                        str(fp): (int(d), str(t)) for fp, d, t in ent
                    },
                    updated_at=float(r.get("updated_at") or 0.0),
                )
            except (ValueError, TypeError, KeyError):
                continue   # one corrupt row must not poison the warm start

    async def persist(self, worker_id: str, store: Any) -> None:
        ws = self._workers.get(worker_id)
        if ws is None:
            return
        import json

        await store.save_prefix_summary(
            worker_id, ws.seq, ws.block_chars,
            json.dumps([[fp, d, t] for fp, (d, t) in ws.entries.items()]),
            ws.updated_at,
        )

    def drop_worker(self, worker_id: str) -> None:
        self._workers.pop(worker_id, None)

    def invalidate_worker(self, worker_id: str, reason: str = "offline",
                          metrics: Optional[Any] = None) -> bool:
        """Zero a worker's advertised summary the MOMENT the plane decides
        it is gone (marked offline, heartbeat swept stale, partitioned) —
        not after ``staleness_ttl_s``. Affinity scoring must never prefer a
        dead warm worker over a live cold one: between the sweep and the
        TTL the dead worker's KV is as good as gone (it will restart cold,
        or never), while the bonus would keep steering spillover math and
        the claim path at its corpse.

        The whole record is dropped (not just emptied): a revived worker's
        next delta then base-mismatches → resync → full snapshot, so both
        sides converge in one round-trip instead of the worker diffing
        against entries the plane no longer holds. Returns True when a
        summary actually existed (callers use it to gate persistence
        cleanup and the counted metric)."""
        ws = self._workers.pop(worker_id, None)
        if ws is None:
            return False
        if metrics is not None:
            try:
                metrics.record_prefix_summary_invalidated(reason)
            except Exception:  # noqa: BLE001 — metrics are best-effort
                pass
        return True

    def touch(self, worker_id: str, now: Optional[float] = None) -> None:
        """A heartbeat arrived from this worker: its summary is still
        live even when no payload rode along (``wire()`` returns None
        while in sync). Without this, a warm worker that simply receives
        no NEW prefixes for ``staleness_ttl_s`` would lose all affinity
        while holding the KV — staleness must mean "stopped heartbeating
        or restarted", not "stopped changing"."""
        ws = self._workers.get(worker_id)
        if ws is not None:
            ws.updated_at = time.time() if now is None else now

    # -- ingest ---------------------------------------------------------------

    @staticmethod
    def _clean_entries(raw: Any, limit: int) -> Tuple[Dict[str, Tuple[int, str]], int, bool]:
        """→ (entries, truncated_count, malformed). Screens every field:
        worker-supplied payloads must degrade, never throw."""
        if not isinstance(raw, list):
            return {}, 0, True
        out: Dict[str, Tuple[int, str]] = {}
        truncated = max(0, len(raw) - limit)
        for item in raw[:limit]:
            if (not isinstance(item, (list, tuple)) or len(item) != 3
                    or not isinstance(item[0], str) or len(item[0]) > 32):
                return {}, 0, True
            try:
                depth = int(item[1])
            except (TypeError, ValueError):
                return {}, 0, True
            tier = item[2] if item[2] in TIER_WEIGHT else "dev"
            out[item[0]] = (max(1, depth), tier)
        return out, truncated, False

    def _gc(self, now: float) -> None:
        """Bound registry growth under worker-id churn: entries long past
        the staleness TTL score zero anyway — reclaim them once the
        registry is big enough for the dead weight to matter (workers
        that merely went quiet re-advertise with a full snapshot)."""
        if len(self._workers) <= 512:
            return
        cutoff = now - 10.0 * self.config.staleness_ttl_s
        for wid in [w for w, ws in self._workers.items()
                    if ws.updated_at < cutoff]:
            del self._workers[wid]

    def ingest(self, worker_id: str, payload: Any,
               now: Optional[float] = None) -> IngestResult:
        now = time.time() if now is None else now
        self._gc(now)
        cfg = self.config
        if not isinstance(payload, dict):
            return IngestResult(reason="summary_malformed", resync=True)
        if int(payload.get("v") or 0) != SUMMARY_WIRE_VERSION:
            # versioned channel: an unknown wire version is rejected with a
            # counted reason, never guessed at (no resync — the worker
            # would just resend the same unparseable thing)
            return IngestResult(reason="summary_bad_version")
        if int(payload.get("block_chars") or 0) != cfg.block_chars:
            # mismatched fingerprint basis would MIS-match, not just miss
            return IngestResult(reason="summary_block_mismatch")
        seq = int(payload.get("seq") or 0)
        limit = max(1, cfg.summary_max_entries)
        if "full" in payload:
            entries, truncated, bad = self._clean_entries(
                payload.get("full"), limit
            )
            if bad:
                return IngestResult(reason="summary_malformed", resync=True)
            self._workers[worker_id] = _WorkerSummary(
                seq=seq, block_chars=cfg.block_chars,
                entries=entries, updated_at=now,
            )
            return IngestResult(
                applied=True, truncated=truncated,
                reason="summary_truncated" if truncated else None,
            )
        # delta: only applicable on top of the exact base the worker diffed
        # against — anything else (restart on either side, lost heartbeat)
        # asks for a resync instead of silently diverging
        ws = self._workers.get(worker_id)
        base = int(payload.get("base_seq") or 0)
        if ws is None or ws.seq != base:
            return IngestResult(reason="summary_resync", resync=True)
        add, truncated, bad = self._clean_entries(
            payload.get("add") or [], limit
        )
        if bad:
            return IngestResult(reason="summary_malformed", resync=True)
        dels = payload.get("del") or []
        if not isinstance(dels, list):
            return IngestResult(reason="summary_malformed", resync=True)
        for fp in dels:
            if isinstance(fp, str):
                ws.entries.pop(fp, None)
        ws.entries.update(add)
        over = len(ws.entries) - limit
        if over > 0:
            # arbitrary-but-bounded trim; the worker's own LRU keeps it hot
            for fp in list(ws.entries.keys())[:over]:
                del ws.entries[fp]
            truncated += over
        ws.seq = seq
        ws.updated_at = now
        return IngestResult(
            applied=True, truncated=truncated,
            reason="summary_truncated" if truncated else None,
        )

    # -- match / scoring ------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self.config.enabled

    def _match(self, worker_id: str, fps: Sequence[str],
               now: Optional[float] = None) -> Tuple[int, str]:
        """→ (matched_blocks, tier) of the deepest request boundary this
        worker advertises; (0, "dev") when stale/unknown/no match. The ONE
        staleness-guarded lookup both scoring and peer selection share."""
        if not fps:
            return 0, "dev"
        ws = self._workers.get(worker_id)
        if ws is None:
            return 0, "dev"
        now = time.time() if now is None else now
        if now - ws.updated_at > self.config.staleness_ttl_s:
            return 0, "dev"
        n = deepest_match(fps, ws.entries)
        if n <= 0:
            return 0, "dev"
        _, tier = ws.entries[fps[n - 1]]
        return n, tier

    def match_blocks(self, worker_id: str, fps: Sequence[str],
                     now: Optional[float] = None) -> Tuple[int, float]:
        """→ (matched_blocks, tier_weight) of the deepest request boundary
        this worker advertises; (0, 0) when stale/unknown/no match."""
        n, tier = self._match(worker_id, fps, now=now)
        if n <= 0:
            return 0, 0.0
        return n, TIER_WEIGHT.get(tier, 1.0)

    def affinity(self, worker_id: str, fps: Sequence[str],
                 now: Optional[float] = None) -> float:
        """Fraction of the request's routable prefix this worker holds,
        tier-weighted, in [0, 1]."""
        if not fps:
            return 0.0
        n, tw = self.match_blocks(worker_id, fps, now=now)
        return (n / len(fps)) * tw

    def best_affinity(self, fps: Sequence[str],
                      now: Optional[float] = None
                      ) -> Tuple[Optional[str], float]:
        """Best (worker_id, affinity) across every advertised summary —
        the spillover detector's reference point."""
        best_w, best_a = None, 0.0
        for wid in self._workers:
            a = self.affinity(wid, fps, now=now)
            if a > best_a:
                best_w, best_a = wid, a
        return best_w, best_a

    def best_match(self, worker_ids: Sequence[str], fps: Sequence[str],
                   now: Optional[float] = None
                   ) -> Tuple[Optional[str], int, str]:
        """Peer selection for KV migration: the eligible worker advertising
        the DEEPEST match of ``fps`` → (worker_id, matched_blocks, tier).
        Depth wins; a warmer tier (dev > host > remote) breaks depth ties —
        the cost model prices the pull by both. (None, 0, "dev") when
        nobody matches."""
        best_w: Optional[str] = None
        best_n, best_tier = 0, "dev"
        for wid in worker_ids:
            n, tier = self._match(wid, fps, now=now)
            if n <= 0:
                continue
            if n > best_n or (n == best_n and
                              TIER_WEIGHT.get(tier, 0.0)
                              > TIER_WEIGHT.get(best_tier, 0.0)):
                best_w, best_n, best_tier = wid, n, tier
        return best_w, best_n, best_tier

    def best_affinity_among(self, worker_ids: Sequence[str],
                            fps: Sequence[str],
                            now: Optional[float] = None) -> float:
        """Best affinity across ONLY the given workers — the spillover
        metric's reference point must range over the workers actually
        eligible for this placement (excluding dead/excluded ones keeps
        the counter meaning 'a warmer ELIGIBLE worker was passed over')."""
        return max(
            (self.affinity(wid, fps, now=now) for wid in worker_ids),
            default=0.0,
        )

    def stats_for_metrics(self, now: Optional[float] = None
                          ) -> List[Tuple[str, int, float]]:
        """→ [(worker_id, entry_count, age_s)] for the /metrics gauges."""
        now = time.time() if now is None else now
        return [
            (wid, len(ws.entries), max(0.0, now - ws.updated_at))
            for wid, ws in self._workers.items()
        ]


# ---------------------------------------------------------------------------
# Cluster-wide KV migration: the per-request route cost model
# ---------------------------------------------------------------------------


def decide_kv_route(cfg: RoutingConfig, *, request_blocks: int,
                    matched_blocks: int, tier: str,
                    warm_headroom: float, cold_headroom: float,
                    warm_is_cold: bool = False,
                    warm_prefill_tps: Optional[float] = None,
                    cold_prefill_tps: Optional[float] = None,
                    warm_queue_wait_s: Optional[float] = None,
                    cold_queue_wait_s: Optional[float] = None,
                    migrate_bandwidth: Optional[float] = None,
                    cold_inflight_pulls: int = 0) -> Dict[str, Any]:
    """Choose route-to-warm / migrate-KV / recompute for ONE request.

    Inputs are the router's estimates: ``request_blocks`` = the request's
    routable prefix depth (its fingerprint count), ``matched_blocks`` +
    ``tier`` = the warmest eligible worker's advertised match
    (:meth:`PrefixRegistry.best_match`), and the two graded load headrooms
    ([0, 1] — 1 = idle) of that warm worker and of the load/region-best
    "cold" candidate. Costs (seconds, estimated):

    - warm:      wait(warm) + prefill(unmatched)          — affinity routing's choice
    - migrate:   wait(cold) + transfer(matched, tier) + prefill(unmatched)
    - recompute: wait(cold) + prefill(all)

    The five ``*_tps`` / ``*_wait`` / ``migrate_bandwidth`` keywords are
    the calibration overrides: a MEASURED per-worker rate replaces the
    corresponding ``cfg`` prior when given (None — the default, and what
    every call passes while calibration is off or cold — keeps the cost
    arithmetic byte-identical to the static model).
    ``cold_inflight_pulls`` folds the pulls the plane has already steered
    at the cold candidate into its queue estimate: each outstanding pull
    serializes on the worker's ``kv_migrate_budget``, so a target mid-way
    through its budget no longer prices as idle (the burst-race fix —
    without it every request in a storm migrates to the same exporter).

    The decision is advisory, exactly like affinity: a wrong estimate
    costs latency, never correctness (the worker-side pull falls back to
    recompute on any failure). Returns ``{"choice", "costs"}``;
    ``warm_is_cold`` (the score-best candidate IS the warm worker) and
    too-shallow matches short-circuit to warm/recompute."""
    bc = max(1, cfg.block_chars)
    total_tokens = max(request_blocks, matched_blocks, 1) * bc
    matched_tokens = max(0, matched_blocks) * bc

    def _wait(headroom: float, measured: Optional[float]) -> float:
        base = cfg.migrate_queue_wait_s if measured is None else measured
        return (1.0 - max(0.0, min(1.0, headroom))) * base

    def _prefill(tokens: float, measured: Optional[float]) -> float:
        tps = (cfg.migrate_prefill_tokens_per_s if measured is None
               else max(1.0, measured))
        return max(0.0, tokens) / tps

    bw = (cfg.migrate_bandwidth_bytes_per_s if migrate_bandwidth is None
          else max(1.0, migrate_bandwidth))
    transfer_s = (matched_tokens * cfg.migrate_bytes_per_token
                  * MIGRATE_TIER_COST.get(tier, 1.0) / bw)
    costs = {
        "warm": (_wait(warm_headroom, warm_queue_wait_s)
                 + _prefill(total_tokens - matched_tokens,
                            warm_prefill_tps)),
        "migrate": (
            _wait(cold_headroom, cold_queue_wait_s)
            + _prefill(total_tokens - matched_tokens, cold_prefill_tps)
            + transfer_s
            # each pull already in flight at the target serializes ahead
            # of this one on the worker's kv_migrate_budget
            + max(0, cold_inflight_pulls) * transfer_s
        ),
        "recompute": (_wait(cold_headroom, cold_queue_wait_s)
                      + _prefill(total_tokens, cold_prefill_tps)),
    }
    if matched_blocks <= 0:
        return {"choice": "recompute", "costs": costs}
    if warm_is_cold:
        # the load/region-best candidate already holds the KV: nothing to
        # move, nothing to trade off
        return {"choice": "warm", "costs": costs}
    eligible = ["warm", "recompute"]
    if matched_blocks >= cfg.migrate_min_blocks:
        eligible.append("migrate")
    choice = min(eligible, key=lambda c: costs[c])
    return {"choice": choice, "costs": costs}


def route_flight_attrs(choice: str,
                       decision: Optional[Dict[str, Any]] = None,
                       worker_id: Optional[str] = None) -> Dict[str, Any]:
    """Flat scalar attrs for a request's ``server.route`` flight event —
    the one formatter both route paths (direct discovery and the claim
    arbitration) use, so a timeline reader sees the same shape either
    way. Costs are rounded to keep the event wire-lean."""
    out: Dict[str, Any] = {"choice": str(choice)}
    if worker_id:
        out["worker"] = str(worker_id)
    if decision and isinstance(decision.get("costs"), dict):
        for k, v in decision["costs"].items():
            try:
                out[f"cost_{k}"] = round(float(v), 4)
            except (TypeError, ValueError):
                continue
    return out
