"""Score-based job→worker assignment + queue statistics.

Behavioral parity with the reference's ``server/app/services/scheduler.py``:
- Weighted scoring (:47-51): reliability 35, region proximity 25,
  predicted-online 20, performance 15, load 5.
- Static region distance matrix (:18-40).
- Job duration estimator by type/params (:166-192).
- Atomic claim — reference uses ``SELECT … FOR UPDATE SKIP LOCKED``
  (:194-234); here the Store's single-writer ``claim_next_job`` transaction
  provides the same at-most-once guarantee.
- Queue stats + wait estimate (:236-280).

TPU-aware additions: scoring knows chips/HBM so bigger slices win ties for
heavy jobs, and the duration estimator uses tokens-vs-MXU-throughput rather
than GPU heuristics.

The port's copy of ``distributed_gpu_inference_tpu/server/scheduler.py``, on the
standard library and the port's own modules.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional, Sequence

from ..utils.data_structures import JobStatus, WorkerState
from .reliability import ReliabilityService
from .store import Store

# Static inter-region "distance" (0 = same region; reference scheduler.py:18-40).
REGIONS = ("us-west", "us-east", "eu-west", "eu-central", "asia-east",
           "asia-southeast", "unknown")
_REGION_DISTANCE: Dict[str, Dict[str, float]] = {
    "us-west":        {"us-west": 0, "us-east": 1, "eu-west": 3, "eu-central": 3, "asia-east": 2, "asia-southeast": 2, "unknown": 2},
    "us-east":        {"us-west": 1, "us-east": 0, "eu-west": 2, "eu-central": 2, "asia-east": 3, "asia-southeast": 3, "unknown": 2},
    "eu-west":        {"us-west": 3, "us-east": 2, "eu-west": 0, "eu-central": 1, "asia-east": 3, "asia-southeast": 3, "unknown": 2},
    "eu-central":     {"us-west": 3, "us-east": 2, "eu-west": 1, "eu-central": 0, "asia-east": 2, "asia-southeast": 2, "unknown": 2},
    "asia-east":      {"us-west": 2, "us-east": 3, "eu-west": 3, "eu-central": 2, "asia-east": 0, "asia-southeast": 1, "unknown": 2},
    "asia-southeast": {"us-west": 2, "us-east": 3, "eu-west": 3, "eu-central": 2, "asia-east": 1, "asia-southeast": 0, "unknown": 2},
    "unknown":        {r: 2 for r in REGIONS},
}
_MAX_DISTANCE = 3.0

WEIGHTS = {
    "reliability": 0.35,
    "region": 0.25,
    "predicted_online": 0.20,
    "performance": 0.15,
    "load": 0.05,
}

# Duration estimates (reference scheduler.py:166-192), re-derived for TPU:
# decode ≈ max_new_tokens / per-chip decode tok/s; diffusion ≈ steps * s/step.
_DECODE_TOKS_PER_S_PER_CHIP = 30.0
_DIFFUSION_S_PER_STEP = 0.4


def region_distance(a: Optional[str], b: Optional[str]) -> float:
    return _REGION_DISTANCE.get(a or "unknown", _REGION_DISTANCE["unknown"]).get(
        b or "unknown", 2.0
    )


def estimate_job_duration_s(job_type: str, params: Optional[Dict[str, Any]],
                            num_chips: int = 1) -> float:
    params = params or {}
    if job_type == "llm":
        toks = float(params.get("max_new_tokens") or params.get("max_tokens") or 256)
        tps = _DECODE_TOKS_PER_S_PER_CHIP * max(1, num_chips)
        return 2.0 + toks / tps
    if job_type == "image_gen":
        steps = float(params.get("num_inference_steps") or 30)
        return 3.0 + steps * _DIFFUSION_S_PER_STEP
    if job_type == "vision":
        return 5.0
    if job_type == "whisper":
        return float(params.get("audio_seconds") or 30.0) * 0.3
    if job_type == "embedding":
        return 1.0
    return 10.0


# a batcher load snapshot older than this (vs last_heartbeat cadence) is
# ignored and the binary BUSY signal takes over — a worker that stopped
# serving through a batcher must not keep its stale headroom forever
_LOAD_STATS_TTL_S = 120.0


def graded_load_score(worker: Dict[str, Any],
                      now: Optional[float] = None) -> float:
    """Load headroom in [0, 1]. Batcher-backed workers run MANY jobs
    concurrently, so the binary current_job_id/BUSY signal reads "full" the
    moment one request is in flight — grade from the heartbeat batcher
    snapshot (active slots + queue depth vs the shared-claim capacity)
    instead, falling back to the binary signal for legacy workers."""
    ls = worker.get("load_stats")
    if isinstance(ls, str):
        try:
            ls = json.loads(ls)
        except ValueError:
            ls = None
    now = time.time() if now is None else now
    if isinstance(ls, dict) and ls.get("capacity"):
        ts = float(ls.get("ts") or 0.0)
        if now - ts <= _LOAD_STATS_TTL_S:
            try:
                active = max(0, int(ls.get("active_slots") or 0))
                queue = max(0, int(ls.get("queue_depth") or 0))
                cap = max(1, int(ls.get("capacity") or 1))
            except (TypeError, ValueError):
                return _binary_load(worker)
            # queued work counts double: it is latency ALREADY being paid
            return max(0.0, 1.0 - (active + 2.0 * queue) / cap)
    return _binary_load(worker)


def _binary_load(worker: Dict[str, Any]) -> float:
    load = 0.0 if worker.get("current_job_id") else 1.0
    if worker.get("status") == WorkerState.BUSY.value:
        load = 0.0
    return load


class SmartScheduler:
    """Scores candidate workers and drives atomic job claims."""

    def __init__(self, store: Store,
                 reliability: Optional[ReliabilityService] = None,
                 prefix_registry: Optional[Any] = None,
                 metrics: Optional[Any] = None) -> None:
        self._store = store
        self._reliability = reliability or ReliabilityService(store)
        # cache-aware routing (server/prefix_routing.py): advisory prefix
        # affinity — a bounded score bonus and a bounded claim reordering,
        # never a placement gate
        self._prefix_registry = prefix_registry
        self._metrics = metrics
        # request flight recorder: claim-path route decisions
        # land on the request's timeline. Attached post-construction by
        # ServerState (the recorder needs metrics/tracing built first).
        self._flight = None
        # replicated control planes: the plane_id stamped on
        # every claim this scheduler brokers. None (NULL stamp) on
        # single-plane deployments; set by ServerState when the cohort is
        # configured.
        self.plane_id: Optional[str] = None
        # gray-failure defense: quarantine gate on the claim
        # path. Attached post-construction by ServerState; None (or the
        # service disabled) keeps the claim path byte-identical.
        self._health = None
        # cost-model self-calibration: measured per-worker
        # prefill/queue/bandwidth estimates + the in-flight migrate-pull
        # tracker. Attached post-construction; None (or calibrate off)
        # keeps the claim-path cost model on its static priors.
        self._calibration = None
        self._migrate_hints = None

    def attach_flight(self, flight: Any) -> None:
        self._flight = flight

    def attach_health(self, health: Any) -> None:
        self._health = health

    def attach_calibration(self, calibration: Any,
                           migrate_hints: Any = None) -> None:
        self._calibration = calibration
        self._migrate_hints = migrate_hints

    def _flight_note(self, job: Dict[str, Any], event: str,
                     **attrs: Any) -> None:
        """Advisory flight event for a claimed job — never raises, never
        reorders (the recorder is an observer, not a participant)."""
        if self._flight is None:
            return
        params = job.get("params")
        tid = params.get("trace_id") if isinstance(params, dict) else None
        if not tid:
            return
        try:
            self._flight.note(tid, event, job_id=job.get("id"), **attrs)
        except Exception:  # noqa: BLE001 — recorder is advisory
            pass

    # -- scoring (reference scheduler.py:111-164) ---------------------------

    def _job_fps(self, job: Dict[str, Any]) -> List[str]:
        fps = job.get("prefix_fps")
        if isinstance(fps, str):
            try:
                fps = json.loads(fps)
            except ValueError:
                return []
        if not isinstance(fps, list):
            return []
        return [fp for fp in fps if isinstance(fp, str)]

    def prefix_affinity(self, worker: Dict[str, Any], job: Dict[str, Any],
                        now: Optional[float] = None) -> float:
        """Bounded routing bonus: (affinity fraction of the request's
        prefix this worker advertises) × affinity_weight, scaled DOWN by
        the worker's load so a hot replica spills over to the fleet
        instead of starving it. 0 when routing is disabled/unknown."""
        reg = self._prefix_registry
        if reg is None or not reg.enabled:
            return 0.0
        fps = self._job_fps(job)
        if not fps:
            return 0.0
        aff = reg.affinity(worker["id"], fps, now=now)
        if aff <= 0.0:
            return 0.0
        cfg = reg.config
        headroom = graded_load_score(worker, now=now)
        floor = max(0.0, min(1.0, cfg.min_headroom_factor))
        return cfg.affinity_weight * aff * (floor + (1.0 - floor) * headroom)

    def score_worker(self, worker: Dict[str, Any], job: Dict[str, Any],
                     now: Optional[float] = None) -> float:
        reliability = float(worker.get("reliability_score") or 0.5)

        dist = region_distance(job.get("preferred_region") or job.get("client_region"),
                               worker.get("region"))
        region_score = 1.0 - dist / _MAX_DISTANCE

        online = self._reliability.predict_online_probability(worker, now=now)

        # performance: normalized inverse latency, boosted by slice size
        avg_ms = float(worker.get("avg_latency_ms") or 0.0)
        perf = 1.0 / (1.0 + avg_ms / 1000.0)
        chips = max(1, int(worker.get("num_chips") or 1))
        perf = min(1.0, perf * (1.0 + 0.05 * (chips - 1)))

        load = graded_load_score(worker, now=now)

        return (
            WEIGHTS["reliability"] * reliability
            + WEIGHTS["region"] * region_score
            + WEIGHTS["predicted_online"] * online
            + WEIGHTS["performance"] * perf
            + WEIGHTS["load"] * load
            + self.prefix_affinity(worker, job, now=now)
        )

    async def rank_workers(self, job: Dict[str, Any],
                           now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Eligible workers sorted by descending score."""
        if self._prefix_registry is not None:
            await self._prefix_registry.ensure_loaded(self._store)
        cands = await self._store.list_workers(
            status=[WorkerState.IDLE.value, WorkerState.BUSY.value],
            supports_type=job.get("type"),
        )
        pref = job.get("preferred_region")
        if pref and not job.get("allow_cross_region", True):
            cands = [w for w in cands if w.get("region") == pref]
        scored = [(self.score_worker(w, job, now=now), w) for w in cands]
        scored.sort(key=lambda t: t[0], reverse=True)
        return [w for _, w in scored]

    # -- atomic claim (worker-pull path) ------------------------------------

    async def atomic_assign_job(self, worker_id: str) -> Optional[Dict[str, Any]]:
        w = await self._store.get_worker(worker_id)
        if w is None or w.get("status") in (
            WorkerState.OFFLINE.value,
            WorkerState.DRAINING.value,
        ):
            return None
        if self._health is not None and self._health.enabled and \
                not self._health.allow_canary(worker_id):
            # gray-failure defense: a quarantined worker's
            # poll claims nothing — it keeps heartbeating, finishes its
            # in-flight work, and serves /kv/export pulls, but new work
            # routes around it. Probation re-admits through the bounded
            # canary budget (allow_canary charges it); the service
            # disabled keeps this path byte-identical.
            return None
        prefer = None
        reg = self._prefix_registry
        if reg is not None and reg.enabled:
            # cache-aware claim: within the head priority band (bounded
            # window — see claim_next_job), prefer the queued job whose
            # prefix THIS worker advertises. Pure in-memory lookup, safe
            # inside the claim transaction.
            await reg.ensure_loaded(self._store)

            def prefer(row: Dict[str, Any]) -> float:  # noqa: F811
                return reg.affinity(worker_id, self._job_fps(row))

        job = await self._store.claim_next_job(
            worker_id,
            supported_types=list(w.get("supported_types") or []),
            region=w.get("region"),
            prefer=prefer,
            plane_id=self.plane_id,
        )
        cands: Optional[List[Dict[str, Any]]] = None
        if job is not None:
            await self._store.update_worker(
                worker_id, current_job_id=job["id"], status=WorkerState.BUSY.value
            )
            if prefer is not None and self._metrics is not None:
                fps = self._job_fps(job)
                if fps:
                    aff = reg.affinity(worker_id, fps)
                    # spillover reference: warmest worker ELIGIBLE for
                    # this job (same scoping as the direct path) — a
                    # draining/offline/wrong-type worker advertising a
                    # warm summary is not "passed over". One indexed
                    # SELECT per claimed fingerprinted job buys an
                    # operator signal that means what the docs say.
                    cands = await self._store.list_workers(
                        status=[WorkerState.IDLE.value,
                                WorkerState.BUSY.value],
                        supports_type=job.get("type"),
                    )
                    best = reg.best_affinity_among(
                        [c["id"] for c in cands], fps,
                    )
                    self._metrics.record_prefix_route(
                        "queued", hit=aff > 0.0,
                        spillover=best > aff,
                    )
        if job is not None and reg is not None and reg.enabled and \
                reg.config.kv_migrate:
            await self._maybe_stamp_migration(worker_id, job, cands=cands)
        return job

    async def _maybe_stamp_migration(self, worker_id: str,
                                     job: Dict[str, Any],
                                     cands: Optional[List[Dict[str, Any]]]
                                     = None) -> None:
        """Cluster-wide KV migration on the claim path: the claiming
        worker is FIXED (route-to-warm is off the table once the claim
        lands), so the cost model only arbitrates migrate-KV vs recompute
        — when this worker is cold for the job's prefix but a live peer
        advertises a deep match and the estimated transfer beats the
        re-prefill, the handed-out job carries a ``kv_migrate_from`` hint
        (in-memory only: a requeue re-decides against fresh summaries).
        Counted per decision in ``kv_route_decisions_total{path="queued"}``."""
        from .prefix_routing import decide_kv_route

        reg = self._prefix_registry
        fps = self._job_fps(job)
        if not fps:
            return
        choice = "recompute"
        if reg.affinity(worker_id, fps) > 0.0:
            choice = "warm"   # claim preference already landed it warm
        else:
            if cands is None:
                # the spillover-metrics block usually just fetched this
                # exact list — reuse it instead of a second worker-table
                # scan inside the claim hot path
                cands = await self._store.list_workers(
                    status=[WorkerState.IDLE.value, WorkerState.BUSY.value],
                    supports_type=job.get("type"),
                )
            by_id = {c["id"]: c for c in cands if c["id"] != worker_id}
            warm_id, blocks, tier = reg.best_match(list(by_id), fps)
            if warm_id is not None and \
                    blocks >= reg.config.migrate_min_blocks and \
                    by_id[warm_id].get("data_plane_url") and \
                    isinstance(job.get("params"), dict):
                me = next((c for c in cands if c["id"] == worker_id), None)
                cold_head = graded_load_score(me) if me is not None else 1.0
                cal = self._calibration
                decision = decide_kv_route(
                    reg.config, request_blocks=len(fps),
                    matched_blocks=blocks, tier=tier,
                    warm_headroom=graded_load_score(by_id[warm_id]),
                    cold_headroom=cold_head,
                    # self-calibration: measured values when
                    # attached + warm + flag on; every accessor returns
                    # None otherwise, keeping the static priors verbatim
                    warm_prefill_tps=(cal.prefill_tps(warm_id)
                                      if cal is not None else None),
                    cold_prefill_tps=(cal.prefill_tps(worker_id)
                                      if cal is not None else None),
                    warm_queue_wait_s=(cal.queue_wait_s(warm_id)
                                       if cal is not None else None),
                    cold_queue_wait_s=(cal.queue_wait_s(worker_id)
                                       if cal is not None else None),
                    migrate_bandwidth=(cal.bandwidth(worker_id, tier)
                                       if cal is not None else None),
                    cold_inflight_pulls=(
                        self._migrate_hints.inflight(worker_id)
                        if self._migrate_hints is not None else 0),
                )
                # wait(cold) appears in both remaining costs, so this is
                # exactly "transfer beats the saved prefill"
                if decision["costs"]["migrate"] < \
                        decision["costs"]["recompute"]:
                    choice = "migrate"
                    job["params"]["kv_migrate_from"] = {
                        "worker_id": warm_id,
                        "data_plane_url": by_id[warm_id]["data_plane_url"],
                        "matched_blocks": blocks,
                        "tier": tier,
                    }
                    if self._migrate_hints is not None:
                        self._migrate_hints.note(worker_id)
        if self._metrics is not None:
            self._metrics.record_kv_route_decision("queued", choice)
        from .prefix_routing import route_flight_attrs

        self._flight_note(job, "server.route",
                          **route_flight_attrs(choice, worker_id=worker_id))

    # -- queue stats (reference scheduler.py:236-280) ------------------------

    async def get_queue_stats(self) -> Dict[str, Any]:
        stats = await self._store.queue_stats()
        queued = await self._store.list_jobs(
            status=[JobStatus.QUEUED.value], limit=500
        )
        workers = await self._store.list_workers(
            status=[WorkerState.IDLE.value, WorkerState.BUSY.value]
        )
        total_chips = sum(max(1, int(w.get("num_chips") or 1)) for w in workers)
        est_backlog_s = sum(
            estimate_job_duration_s(j["type"], j.get("params")) for j in queued
        )
        wait = est_backlog_s / max(1, len(workers)) if workers else float("inf")
        # overload-control observability: the queued backlog by tenant
        # tier (params["tier"], stamped at admission) — the brownout panel
        # and the autoscaler read "who is actually waiting" from this
        by_tier: Dict[str, int] = {}
        for j in queued:
            params = j.get("params")
            if isinstance(params, str):
                try:
                    params = json.loads(params)
                except ValueError:
                    params = None
            tier = (params or {}).get("tier") if isinstance(params, dict) \
                else None
            key = str(tier) if tier else "untiered"
            by_tier[key] = by_tier.get(key, 0) + 1
        stats.update(
            {
                "active_workers": len(workers),
                "total_chips": total_chips,
                "estimated_wait_s": wait if workers else None,
                "queued_by_tier": by_tier,
            }
        )
        return stats
