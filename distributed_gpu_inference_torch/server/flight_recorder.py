"""Server-side flight recorder: merge, retain, and surface request timelines.

One :class:`FlightRecorder` lives on the control plane's ``ServerState``.
It accumulates:

- **server events** (``note``): admission decision, route decision, claim,
  completion — stamped with the plane's clock;
- **worker wire payloads** (``ingest_wire``): per-request event lists
  shipped through job results and heartbeat ``engine_stats["flight"]``.
  Each payload carries the FULL event list for its (trace, source), and
  the recorder UNIONS events per source keyed by (name, timestamp) —
  duplicate delivery (retried heartbeat, replayed completion) is
  idempotent by construction, and two timelines sharing one source
  (local PD: prefill + decode stages on the same worker; a retry on the
  same worker) compose instead of clobbering each other.

``finalize`` derives the canonical phase durations from the merged
timeline, feeds the ``request_phase_latency_seconds{phase}`` histograms
(each phase observed at most ONCE per trace, no matter how many times a
completion/heartbeat re-delivers), retains the N slowest traces per phase
in bounded exemplar rings, and emits one retroactive OTel span per phase
when the ``TracingManager`` is live.

Everything here is advisory: a malformed payload is a counted, skipped
sample; the per-trace store is a bounded LRU; no recorder failure can
fail a request (callers wrap in try/except at the boundary).

The port's copy of ``distributed_gpu_inference_tpu/server/flight_recorder.py``, on the
standard library and the port's own modules.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from ..runtime.flight import (
    BOUNDARY_EVENTS,
    FLIGHT_BOUNDARY_RESERVE,
    FLIGHT_EVENT_CAP,
    PHASES,
    flight_enabled,
    merge_events,
    phase_durations,
)

# server-side events are recorded under this merge-source key
SERVER_SOURCE = "server"

# bounded retention: traces beyond this evict oldest-first (the debug
# endpoint is for "what just happened", not a TSDB)
TRACE_CAP = 2048

# slowest-trace exemplars retained per phase
EXEMPLARS_PER_PHASE = 8


class ExemplarRing:
    """Bounded retention of the N slowest traces for one phase.

    A min-heap of ``(duration, seq, trace_id)`` capped at ``n``: pushing a
    faster-than-minimum sample on a full ring is a no-op, a slower one
    evicts the current minimum — so the ring always holds the N slowest
    samples seen, in O(log n) per push and O(n) memory, forever."""

    def __init__(self, n: int = EXEMPLARS_PER_PHASE) -> None:
        self.n = max(1, int(n))
        self._heap: List[Tuple[float, int, str]] = []
        self._seq = itertools.count()

    def push(self, duration_s: float, trace_id: str) -> None:
        item = (float(duration_s), next(self._seq), str(trace_id))
        if len(self._heap) < self.n:
            heapq.heappush(self._heap, item)
        elif item[0] > self._heap[0][0]:
            heapq.heapreplace(self._heap, item)

    def items(self) -> List[Dict[str, Any]]:
        """Slowest first."""
        return [
            {"trace_id": tid, "duration_s": round(d, 6)}
            for d, _seq, tid in sorted(self._heap, reverse=True)
        ]


class _Trace:
    __slots__ = ("trace_id", "sources", "dropped", "observed",
                 "created_at", "job_ids", "done_sources")

    def __init__(self, trace_id: str) -> None:
        self.trace_id = trace_id
        # source -> raw event list [(name, ts, attrs), ...]
        self.sources: Dict[str, List[Any]] = {}
        self.dropped = 0
        # phases already observed into the histograms (observe-once)
        self.observed: set = set()
        self.created_at = time.time()
        self.job_ids: List[str] = []
        self.done_sources: set = set()


class FlightRecorder:
    """Bounded per-trace event store + the /metrics·OTel·exemplar fan-out."""

    def __init__(self, metrics: Optional[Any] = None,
                 tracing: Optional[Any] = None,
                 trace_cap: int = TRACE_CAP,
                 event_cap: int = FLIGHT_EVENT_CAP,
                 exemplars_per_phase: int = EXEMPLARS_PER_PHASE,
                 calibration: Optional[Any] = None) -> None:
        self._metrics = metrics
        self._tracing = tracing
        # cost-model self-calibration sink (server/calibration.py): done
        # wires carry the full per-source event list, whose queue-wait /
        # prefill spans are the calibration samples. Optional and
        # best-effort — a calibration failure never rejects a wire
        self._calibration = calibration
        self._trace_cap = max(1, int(trace_cap))
        self._event_cap = max(1, int(event_cap))
        self._traces: "OrderedDict[str, _Trace]" = OrderedDict()
        self._by_job: "OrderedDict[str, str]" = OrderedDict()
        # traces evicted AFTER observing phases: the worker heartbeat
        # ring re-ships done wires for up to 8 recent requests per beat,
        # and re-creating an evicted trace with a fresh observed-set
        # would double-count its phases into the histograms/exemplars
        self._retired: "OrderedDict[str, None]" = OrderedDict()
        # one lock: ingest arrives from aiohttp handlers, tests poke from
        # threads — per-call cost is a dict op, contention is irrelevant
        self._lock = threading.Lock()
        self.exemplars: Dict[str, ExemplarRing] = {
            p: ExemplarRing(exemplars_per_phase) for p in PHASES
        }
        self.stats: Dict[str, int] = {
            "traces": 0, "server_events": 0, "wire_ingested": 0,
            "wire_rejected": 0, "events_capped": 0, "finalized": 0,
        }

    # -- internals ----------------------------------------------------------

    def _get(self, trace_id: str, create: bool = True) -> Optional[_Trace]:
        tr = self._traces.get(trace_id)
        if tr is not None:
            self._traces.move_to_end(trace_id)
            return tr
        if not create:
            return None
        tr = _Trace(trace_id)
        self._traces[trace_id] = tr
        self.stats["traces"] += 1
        while len(self._traces) > self._trace_cap:
            old_id, old = self._traces.popitem(last=False)
            for jid in old.job_ids:
                self._by_job.pop(jid, None)
            if old.observed:
                self._retired[old_id] = None
                while len(self._retired) > 4 * self._trace_cap:
                    self._retired.popitem(last=False)
        return tr

    # -- server-side events ---------------------------------------------------

    def note(self, trace_id: Optional[str], event: str,
             job_id: Optional[str] = None, **attrs: Any) -> None:
        """Record one server-side event NOW. Safe to call with a missing
        trace id (no-op) — callers never branch."""
        if not trace_id or not isinstance(trace_id, str) \
                or not flight_enabled():
            return
        with self._lock:
            tr = self._get(trace_id)
            if job_id:
                self.link_job(job_id, trace_id, _locked=True)
            evs = tr.sources.setdefault(SERVER_SOURCE, [])
            # same boundary reserve as Timeline.note: a saturating trace
            # must still land server.completed or e2e never finalizes
            if len(evs) >= self._event_cap or (
                len(evs) >= self._event_cap - FLIGHT_BOUNDARY_RESERVE
                and event not in BOUNDARY_EVENTS
            ):
                tr.dropped += 1
                self.stats["events_capped"] += 1
                return
            evs.append((str(event), time.time(),
                        {k: v for k, v in attrs.items() if v is not None}
                        or None))
            self.stats["server_events"] += 1

    def link_job(self, job_id: str, trace_id: str,
                 _locked: bool = False) -> None:
        """Index a job id onto its trace (PD stage children all link to
        the parent's trace, so one merged timeline answers any of them)."""
        if not job_id or not trace_id:
            return
        if not _locked:
            with self._lock:
                self.link_job(job_id, trace_id, _locked=True)
            return
        tr = self._get(trace_id)
        if job_id not in tr.job_ids:
            tr.job_ids.append(job_id)
        self._by_job[job_id] = trace_id
        while len(self._by_job) > 4 * self._trace_cap:
            self._by_job.popitem(last=False)

    def trace_for_job(self, job_id: str) -> Optional[str]:
        with self._lock:
            return self._by_job.get(job_id)

    # -- worker wire ingest ---------------------------------------------------

    def ingest_wire(self, worker_id: str, wire: Any) -> bool:
        """Adopt one worker-shipped timeline payload (``Timeline.wire()``).

        The payload carries the full event list for its (trace, source);
        per source the recorder UNIONS events keyed by (name, timestamp)
        — re-delivery of the same (or a stale shorter) payload changes
        nothing, which is the whole idempotency contract for the
        at-least-once result and heartbeat channels, while two distinct
        timelines that share a source (local PD stages on one worker, a
        retry on the same worker) compose instead of the later one
        clobbering the earlier. Returns True when the payload CHANGED
        the trace (new events, or a newly-done source) — the heartbeat
        ingest path finalizes only on True, so re-shipped ring entries
        cannot re-finalize a trace."""
        if not flight_enabled():
            return False
        if not isinstance(wire, dict):
            self.stats["wire_rejected"] += 1
            return False
        tid = wire.get("trace_id")
        events = wire.get("events")
        if not tid or not isinstance(tid, str) \
                or not isinstance(events, list):
            self.stats["wire_rejected"] += 1
            return False
        with self._lock:
            if tid in self._retired:
                # already observed and evicted: a re-shipped ring entry
                # must not resurrect it into a fresh double-count
                return False
        source = str(wire.get("source") or worker_id or "worker")
        if source == SERVER_SOURCE:
            source = f"worker:{worker_id}"  # never alias the plane's events
        cleaned: List[Any] = []
        for ev in events[: self._event_cap]:
            try:
                name = str(ev[0])
                ts = float(ev[1])
            except (TypeError, ValueError, IndexError):
                continue
            attrs = ev[2] if len(ev) > 2 and isinstance(ev[2], dict) else None
            cleaned.append((name, ts, attrs))
        with self._lock:
            tr = self._get(tid)
            changed = False
            prior = tr.sources.get(source)
            if prior is None:
                tr.sources[source] = cleaned
                changed = bool(cleaned)
            elif cleaned:
                seen = {(e[0], round(float(e[1]), 6)) for e in prior}
                fresh = [e for e in cleaned
                         if (e[0], round(float(e[1]), 6)) not in seen]
                if fresh:
                    combined = prior + fresh
                    if len(combined) > self._event_cap:
                        # truncate bulk events first — slicing off a
                        # freshly-arrived boundary event (worker.done,
                        # pd.decode.done, ...) would silently shorten
                        # e2e/decode, the exact failure the worker-side
                        # boundary reserve exists to prevent
                        bnd = [e for e in combined
                               if e[0] in BOUNDARY_EVENTS]
                        bulk = [e for e in combined
                                if e[0] not in BOUNDARY_EVENTS]
                        keep = max(0, self._event_cap - len(bnd))
                        combined = sorted(
                            bulk[:keep] + bnd[: self._event_cap],
                            key=lambda e: float(e[1]),
                        )[: self._event_cap]
                    tr.sources[source] = combined
                    changed = True
            try:
                tr.dropped = max(tr.dropped, int(wire.get("dropped") or 0))
            except (TypeError, ValueError):
                pass
            if wire.get("done") and source not in tr.done_sources:
                tr.done_sources.add(source)
                changed = True
            self.stats["wire_ingested"] += 1
        if self._calibration is not None and wire.get("done"):
            # done wires carry the full event list — one calibration
            # sample per (trace, worker), deduped inside the calibrator
            # (the heartbeat ring re-ships recent done wires every beat)
            try:
                self._calibration.ingest_trace(
                    str(worker_id or source), tid, cleaned)
            except Exception:  # noqa: BLE001 — advisory, never fatal
                pass
        return changed

    # -- merged views ---------------------------------------------------------

    def timeline(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """The merged, monotonically-ordered timeline + derived phases."""
        with self._lock:
            tr = self._get(trace_id, create=False)
            if tr is None:
                return None
            sources = {s: list(evs) for s, evs in tr.sources.items()}
            dropped = tr.dropped
            observed = sorted(tr.observed)
            job_ids = list(tr.job_ids)
        merged = merge_events(sources)
        return {
            "trace_id": trace_id,
            "events": merged,
            "phases": {k: round(v, 6)
                       for k, v in phase_durations(merged).items()},
            "sources": sorted(sources),
            "job_ids": job_ids,
            "observed_phases": observed,
            **({"events_dropped": dropped} if dropped else {}),
        }

    def timeline_for_job(self, job_id: str) -> Optional[Dict[str, Any]]:
        tid = self.trace_for_job(job_id)
        return self.timeline(tid) if tid else None

    def slowest(self) -> Dict[str, List[Dict[str, Any]]]:
        """Per-phase exemplar rings: the N slowest traces seen per phase
        (slowest first) — the 'which request blew the p95' index."""
        with self._lock:
            return {p: ring.items() for p, ring in self.exemplars.items()}

    # -- finalize -------------------------------------------------------------

    def finalize(self, trace_id: Optional[str],
                 partial: bool = False) -> Dict[str, float]:
        """Derive phases from the merged timeline and fan out: histogram
        observation (once per phase per trace — re-finalizing after more
        events arrive observes only phases not yet seen, so PD child
        completions and duplicate deliveries compose), exemplar retention,
        and retroactive OTel phase spans. Returns the durations observed
        THIS call.

        ``partial=True`` (a PD prefill child's completion) defers the
        phases whose right edge is the END of the request — e2e, decode,
        and the both-sides handoff span — to the terminal finalize;
        observing them here would lock a prefill-only span into the
        observe-once set and permanently exclude decode time. The same
        deferral applies automatically to a queued job whose worker wire
        arrived by heartbeat before ``complete_job`` stamped
        ``server.completed``."""
        if not trace_id:
            return {}
        with self._lock:
            tr = self._get(trace_id, create=False)
            if tr is None:
                return {}
            sources = {s: list(evs) for s, evs in tr.sources.items()}
            already = set(tr.observed)
        merged = merge_events(sources)
        durations = phase_durations(merged)
        names = {e["event"] for e in merged}
        if partial or ("server.submitted" in names
                       and "server.completed" not in names):
            durations = {p: d for p, d in durations.items()
                         if p not in ("e2e", "decode", "handoff")}
        fresh = {p: d for p, d in durations.items() if p not in already}
        if not fresh:
            return {}
        with self._lock:
            tr = self._get(trace_id, create=False)
            if tr is None:
                return {}
            # re-check under the lock: a concurrent finalize may have won
            fresh = {p: d for p, d in fresh.items() if p not in tr.observed}
            tr.observed.update(fresh)
            self.stats["finalized"] += 1
        m = self._metrics
        for phase, dur in fresh.items():
            if m is not None:
                try:
                    m.record_phase(phase, dur)   # Metrics has its own lock
                except Exception:  # noqa: BLE001 — advisory, never fatal
                    pass
        with self._lock:
            # heap pushes under the recorder lock: concurrent finalizes
            # interleaving heapq ops would break the ring invariant
            for phase, dur in fresh.items():
                ring = self.exemplars.get(phase)
                if ring is not None:
                    ring.push(dur, trace_id)
        tracing = self._tracing
        if tracing is not None and getattr(tracing, "enabled", False):
            self._emit_spans(trace_id, merged, fresh)
        return fresh

    def _emit_spans(self, trace_id: str, merged: List[Dict[str, Any]],
                    fresh: Dict[str, float]) -> None:
        """One retroactive OTel span per freshly-observed phase, anchored
        at the merged timeline's start. Best-effort by contract."""
        if not merged:
            return
        start = float(merged[0]["ts"])
        end = float(merged[-1]["ts"])
        for phase, dur in fresh.items():
            # anchor: e2e/ttft/queue_wait start at the trace start; the
            # rest end where their closing event landed — close enough
            # for a span waterfall, exact durations ride the histogram
            t1 = end if phase == "e2e" else min(start + dur, end)
            try:
                self._tracing.emit_span(
                    f"request.{phase}", t1 - dur, t1,
                    trace_id=trace_id, duration_s=round(dur, 6),
                )
            except Exception:  # noqa: BLE001
                pass
