"""Metrics, tracing, structured logging — the observability surface.

Behavioral parity with the reference's ``server/app/services/observability.py``:
- Prometheus metric set (:30-141): inference requests/latency, tokens and
  tokens/s, KV-cache hit rate / size / evictions per tier, worker status,
  accelerator memory, distributed hop latency histogram, KV migration latency,
  batch size, per-phase queue size, speculative accept rate + speedup.
- Metrics are written by the port's ``server/prom_text.py`` (the
  Prometheus text format, without ``prometheus_client``); tracing is off
  when OpenTelemetry is absent (``_otel``, imported lazily).
- ``MetricsCollector`` facade (:255-405), ``/metrics`` text endpoint factory
  (:410-450), ``StructuredLogger`` with bound context (:455-488).

Device trace: ``torch_profiler_trace`` wraps a region in a
``torch.profiler`` trace (CPU and CUDA activity), written as a Chrome trace.

The port's copy of ``distributed_gpu_inference_tpu/server/observability.py``, on the
standard library and the port's own modules.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Any, Dict, Iterator, Optional

from . import prom_text


def _otel() -> Optional[tuple]:
    """``(TracerProvider, BatchSpanProcessor, ConsoleSpanExporter)`` when
    OpenTelemetry is installed, else None (tracing is then off)."""
    try:
        from opentelemetry.sdk.trace import TracerProvider
        from opentelemetry.sdk.trace.export import (
            BatchSpanProcessor,
            ConsoleSpanExporter,
        )
    except Exception:  # noqa: BLE001 — optional dependency
        return None
    return TracerProvider, BatchSpanProcessor, ConsoleSpanExporter


# ---------------------------------------------------------------------------
# Prometheus metrics (server/prom_text.py)
# ---------------------------------------------------------------------------

# request_phase_latency_seconds bucket boundaries: sub-ms resolution for
# worker-side phases (queue wait on an idle batcher, a local handoff),
# stretching to multi-minute long-context e2e. Module-level so tests and
# dashboards share one source of truth.
PHASE_LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)


class Metrics:
    """All platform metrics on one registry (names mirror reference :30-141)."""

    def __init__(self) -> None:
        prom = prom_text
        self._generate = prom.generate_latest
        Counter, Gauge, Histogram = prom.Counter, prom.Gauge, prom.Histogram
        r = prom.CollectorRegistry()
        self.registry = r
        self.inference_requests = Counter(
            "inference_requests_total", "Inference requests",
            ["job_type", "status"], registry=r)
        self.inference_latency = Histogram(
            "inference_latency_seconds", "End-to-end inference latency",
            ["job_type"], registry=r,
            buckets=(0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60))
        self.tokens_generated = Counter(
            "tokens_generated_total", "Decoded tokens", registry=r)
        self.tokens_per_second = Gauge(
            "tokens_per_second", "Recent decode throughput", registry=r)
        self.kv_cache_hit_rate = Gauge(
            "kv_cache_hit_rate", "KV/prefix cache hit rate", ["tier"],
            registry=r)
        self.kv_cache_size = Gauge(
            "kv_cache_size_blocks", "Allocated KV blocks", ["tier"], registry=r)
        self.kv_cache_evictions = Counter(
            "kv_cache_evictions_total", "KV block evictions", ["tier"],
            registry=r)
        self.worker_status = Gauge(
            "worker_status", "Workers by status", ["status"], registry=r)
        self.hbm_used_bytes = Gauge(
            "hbm_used_bytes", "Per-device HBM in use", ["device"], registry=r)
        self.hop_latency = Histogram(
            "distributed_hop_latency_seconds", "Pipeline hop latency",
            registry=r,
            buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1))
        self.kv_migration_latency = Histogram(
            "kv_migration_latency_seconds", "PD KV migration latency",
            registry=r, buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1))
        self.batch_size = Gauge(
            "batch_size", "Current decode batch size", registry=r)
        self.queue_size = Gauge(
            "queue_size", "Queued requests per phase", ["phase"], registry=r)
        self.spec_accept_rate = Gauge(
            "speculative_accept_rate", "Draft token accept rate", registry=r)
        self.spec_speedup = Gauge(
            "speculative_speedup", "Tokens per verify step", registry=r)
        # per-worker speculation efficiency (engine-integrated decode mode):
        # counters scrape-delta cleanly into fleet accept-rate / tokens-per-
        # step panels; the gauges mirror the engine's own derived numbers
        self.spec_accepted_tokens = Counter(
            "speculative_accepted_tokens_total",
            "Accepted draft tokens", ["worker"], registry=r)
        self.spec_drafted_tokens = Counter(
            "speculative_drafted_tokens_total",
            "Drafted tokens offered to verification", ["worker"], registry=r)
        self.spec_decode_steps = Counter(
            "speculative_decode_steps_total",
            "Per-slot speculative verify steps", ["worker"], registry=r)
        self.spec_worker_accept_rate = Gauge(
            "speculative_worker_accept_rate",
            "Draft token accept rate per worker", ["worker"], registry=r)
        self.spec_worker_tokens_per_step = Gauge(
            "speculative_worker_tokens_per_step",
            "Committed tokens per verify step per worker (weight-stream "
            "amortization factor)", ["worker"], registry=r)
        # KV-pressure recovery: preemption is a scheduling event, and these
        # are its fleet health panel — a rising preemption rate means pools
        # are running hot; preemptions without matching resumes mean
        # requests are dying preempted_too_often
        self.kv_preemptions = Counter(
            "kv_preemptions_total",
            "Sequences preempted under KV-block pressure", ["worker"],
            registry=r)
        self.kv_resumes = Counter(
            "kv_resumes_total",
            "Preempted sequences resumed (spill/cache restore)", ["worker"],
            registry=r)
        self.kv_pressure_events = Counter(
            "kv_pressure_events_total",
            "Step-boundary KV pressure signals (frozen slots / deferred "
            "admissions)", ["worker"], registry=r)
        # crash-safe generation: checkpoints accepted/fenced and streams
        # adopted by failover workers. A rising checkpoints_rejected
        # {reason=stale_epoch} means zombie workers are still reporting
        # after their assignments were taken over — exactly what the epoch
        # fence exists to absorb, but worth watching at fleet scale.
        self.job_checkpoints = Counter(
            "job_checkpoints_total",
            "Generation checkpoints accepted by the control plane",
            ["worker"], registry=r)
        self.checkpoints_rejected = Counter(
            "checkpoints_rejected_total",
            "Checkpoints/completions rejected by epoch or ownership "
            "fencing", ["reason"], registry=r)
        self.stream_failovers = Counter(
            "stream_failovers_total",
            "Direct-stream checkpoints adopted by a failover worker",
            registry=r)
        self.kv_handoff_purged = Counter(
            "kv_handoff_sessions_purged_total",
            "Abandoned streamed-handoff sessions purged by receivers",
            ["worker"], registry=r)
        # batcher-backed serving (the production worker path since round
        # 6): per-worker batch health — queue depth growing while
        # occupancy sits at the slot count means the worker is saturated;
        # chunked admissions trending up means long prompts dominate.
        self.batcher_queue_depth = Gauge(
            "batcher_queue_depth",
            "Requests waiting in the worker's continuous-batching "
            "admission queue", ["worker"], registry=r)
        self.batcher_active_slots = Gauge(
            "batcher_active_slots",
            "Engine slots decoding right now", ["worker"], registry=r)
        self.batcher_occupancy = Gauge(
            "batcher_avg_occupancy",
            "Average decoding slots per engine round", ["worker"],
            registry=r)
        self.batcher_horizon = Gauge(
            "batcher_horizon",
            "Current adaptive decode horizon (device steps per host "
            "round-trip)", ["worker"], registry=r)
        self.batcher_decode_rounds = Counter(
            "batcher_decode_rounds_total",
            "Engine decode rounds driven by the batcher", ["worker"],
            registry=r)
        self.batcher_completed = Counter(
            "batcher_requests_completed_total",
            "Requests completed through the batcher serving path",
            ["worker"], registry=r)
        self.batcher_chunked_admissions = Counter(
            "batcher_chunked_admissions_total",
            "Long prompts admitted chunk-interleaved", ["worker"],
            registry=r)
        self.batcher_preemptions = Counter(
            "batcher_preemptions_total",
            "KV-pressure preemptions applied by the batcher's victim "
            "policy", ["worker"], registry=r)
        self.batcher_migrated = Counter(
            "batcher_requests_migrated_total",
            "In-flight requests frozen into checkpoints on graceful "
            "drain", ["worker"], registry=r)
        # cache-aware routing: hits = placements that landed on
        # a worker advertising the request's prefix; spillover = requests
        # whose warmest worker was passed over (load headroom scaling or
        # claim ordering) — a high spillover rate with low hit rate means
        # the fleet is too hot for locality to matter.
        self.prefix_route_hits = Counter(
            "prefix_route_hits_total",
            "Requests routed to a worker advertising their prefix",
            ["path"], registry=r)
        self.prefix_route_spillover = Counter(
            "prefix_route_spillover_total",
            "Requests whose warmest worker was passed over (load "
            "spillover)", ["path"], registry=r)
        self.prefix_summary_entries = Gauge(
            "prefix_summary_entries",
            "Advertised radix-summary entries per worker", ["worker"],
            registry=r)
        self.prefix_summary_age = Gauge(
            "prefix_summary_age_seconds",
            "Age of the last accepted radix summary per worker",
            ["worker"], registry=r)
        # heartbeat payload hygiene: oversized engine_stats, bad summary
        # versions, mismatched fingerprint bases — counted, never 500d
        # (a failing heartbeat gets a LIVE worker swept offline)
        self.heartbeat_payload_rejected = Counter(
            "heartbeat_payload_rejected_total",
            "Heartbeat side-channel payloads rejected or truncated",
            ["reason"], registry=r)
        # fleet-under-fire panel: a dead/partitioned worker's
        # advertised prefix summary is zeroed the MOMENT it is marked
        # offline (not after staleness_ttl_s), so affinity can never route
        # at a dead warm worker; rejoins and the serving/registered ratio
        # show the fleet absorbing and recovering from churn; chaos
        # counters are emitted by the harness-facing seams so a chaos
        # run's injected events and the plane's observed reactions land
        # in ONE scrape.
        self.prefix_summaries_invalidated = Counter(
            "prefix_summaries_invalidated_total",
            "Worker prefix summaries zeroed before their staleness TTL",
            ["reason"], registry=r)
        self.worker_rejoin = Counter(
            "worker_rejoin_total",
            "Workers that rejoined the fleet (heartbeat revival of a "
            "swept-offline worker, or re-registration on an existing "
            "machine fingerprint)", ["worker"], registry=r)
        self.fleet_degraded = Gauge(
            "fleet_degraded",
            "Replicas serving / replicas registered (1.0 = full strength)",
            registry=r)
        # gray-failure defense: the quarantine state machine's
        # externals — per-worker state gauge (codes match
        # server.health.STATE_CODES), transition counter (a worker
        # cycling suspect↔healthy is noise; healthy→…→quarantined edges
        # are pages), worker-side deadline abandonment, and hedged
        # dispatch (offered by discovery, cancelled losers reported back
        # through the worker's direct channel)
        self.worker_health_state = Gauge(
            "worker_health_state",
            "Gray-failure health state per worker "
            "(0=healthy 1=suspect 2=quarantined 3=probation)",
            ["worker"], registry=r)
        self.health_transitions = Counter(
            "health_transitions_total",
            "Health state-machine transitions",
            ["from", "to"], registry=r)
        self.jobs_abandoned = Counter(
            "jobs_abandoned_total",
            "Requests abandoned by the worker batcher (hopeless work: "
            "the deadline passed and the projected remaining decode "
            "cannot land)",
            ["worker", "reason"], registry=r)
        self.hedges = Counter(
            "hedges_total",
            "Hedged-dispatch lifecycle events", ["outcome"], registry=r)
        self.chaos_kills = Counter(
            "chaos_kills_total",
            "Hard worker kills injected by the chaos harness", registry=r)
        self.chaos_partitions = Counter(
            "chaos_partitions_total",
            "Network partitions/blackouts injected by the chaos harness",
            registry=r)
        self.chaos_events = Counter(
            "chaos_events_total",
            "All chaos events injected by the fleet harness", ["kind"],
            registry=r)
        # disaggregated prefill/decode under fire: handoff
        # lifecycle by outcome (sender commits/failures/aborts + receiver
        # abort/purge reasons — a rising failed:committed ratio means the
        # handoff link is sick), bytes actually moved, re-prefill
        # fallbacks by reason (the flow recovering a lost handoff/KV by
        # redoing the prompt), and the per-role free-capacity balance
        # (one side at 0 while the other has headroom = the brownout the
        # role-rebalance fallback absorbs).
        self.pd_handoffs = Counter(
            "pd_handoffs_total",
            "Prefill→decode KV handoff lifecycle events by outcome",
            ["worker", "outcome"], registry=r)
        self.pd_handoff_bytes = Counter(
            "pd_handoff_bytes_total",
            "Serialized KV handoff bytes pushed by prefill workers",
            ["worker"], registry=r)
        self.pd_reprefill = Counter(
            "pd_reprefill_total",
            "PD flows re-prefilled after a stage failure, by reason",
            ["reason"], registry=r)
        self.pd_fleet_balance = Gauge(
            "pd_fleet_balance",
            "Free PD serving capacity by role (prefill/decode slots "
            "available across the registered pool)", ["role"], registry=r)
        # cluster-wide KV migration: pulls by outcome (pulled /
        # aborted mid-pull / fallback_recompute — a rising aborted rate
        # means the fleet's data planes are flaky; fallback_recompute
        # rising means budgets/backoffs or peer evictions are eating the
        # wins), bytes moved by direction, and the router's three-way
        # decision mix (warm routing collapsing into migrate under load is
        # the whole point of the feature)
        self.kv_migrations = Counter(
            "kv_migrations_total",
            "Cluster-KV prefix migration pull outcomes per worker",
            ["worker", "outcome"], registry=r)
        self.kv_migration_bytes = Counter(
            "kv_migration_bytes_total",
            "Bytes moved by cluster-KV prefix migration",
            ["worker", "direction"], registry=r)
        self.kv_route_decisions = Counter(
            "kv_route_decisions_total",
            "Router cost-model decisions (warm / migrate / recompute)",
            ["path", "choice"], registry=r)
        # predictive placement: proactive-replication hints
        # handed out per heartbeat, and predictive PD rebalance actions —
        # both advisory signals, so a panel reading hints without a
        # matching rise in kv_migrations{outcome=replicated} means the
        # workers are dropping them (budget/backoff) rather than failing
        self.kv_replicate_hints = Counter(
            "kv_replicate_hints_total",
            "Proactive prefix-replication pull hints handed to workers",
            registry=r)
        self.predictive_rebalance = Counter(
            "predictive_rebalance_total",
            "Predictive PD rebalance actions "
            "(preflip / restore / scale_out_role)",
            ["action"], registry=r)
        # SLO-native overload control: every rung of the
        # degrade/shed ladder is counted by tier — a brownout panel reads
        # "free degrading, paid accepting" directly from this series, and
        # a paid:shed sample while free:accept still flows is the alarm
        # the tier contract exists to prevent.
        self.admission_decisions = Counter(
            "admission_decisions_total",
            "Overload-control ladder decisions (accept / degrade_clamp / "
            "degrade_no_spec / shed) by tenant tier",
            ["tenant_tier", "action"], registry=r)
        # per-tenant view, label-capped: MetricsCollector maps tenants
        # beyond the top-N LRU onto one "other" label so a tenant-id-
        # spraying client cannot blow up the registry
        self.tenant_admissions = Counter(
            "tenant_admission_decisions_total",
            "Admission decisions per tenant (top-N tenants by recency; "
            "overflow aggregates under tenant=\"other\")",
            ["tenant", "action"], registry=r)
        # brownout-driven autoscaling: decisions, the replica target, the
        # measured SLO-in-window the decisions were made from, and the
        # measured cold-start lead time the scale-out projection uses
        self.autoscaler_decisions = Counter(
            "autoscaler_decisions_total",
            "Autoscaler actions (scale_out / scale_in / hold)",
            ["action"], registry=r)
        self.autoscaler_replicas = Gauge(
            "autoscaler_target_replicas",
            "Replica count the autoscaler currently targets", registry=r)
        self.autoscaler_slo = Gauge(
            "autoscaler_slo_in_window",
            "Fraction of recent requests meeting the SLO bound inside "
            "the autoscaler's observation window", registry=r)
        self.autoscaler_cold_start = Gauge(
            "autoscaler_cold_start_seconds",
            "Measured replica cold-start time (EMA) used as scale-out "
            "lead time", registry=r)
        # request flight recorder: per-phase latency
        # attribution — until now only hop and kv-migration latencies had
        # histograms; a p95 blowout could not be attributed to queue wait
        # vs prefill vs handoff vs decode. Buckets span sub-ms worker-side
        # phases through multi-minute long-context e2e.
        self.request_phase_latency = Histogram(
            "request_phase_latency_seconds",
            "Per-request phase latency from merged flight-recorder "
            "timelines (queue_wait / prefill / ttft / handoff / decode / "
            "e2e)", ["phase"], registry=r,
            buckets=PHASE_LATENCY_BUCKETS)
        self.flight_timelines = Counter(
            "flight_timelines_total",
            "Per-request timelines recorded by each worker's flight "
            "recorder", ["worker"], registry=r)
        self.flight_events_dropped = Counter(
            "flight_events_dropped_total",
            "Flight-recorder events dropped at the per-request cap",
            ["worker"], registry=r)
        # durable tier under fire: spill-tier IO health per
        # worker — a browned-out host/remote tier shows up as rising
        # errors, tripped breakers (gauge 0=closed 1=half_open 2=open),
        # and quarantined corrupt entries; store_degraded flips to 1 while
        # the plane's own job store rejects writes (reads keep serving)
        self.kv_spill_errors = Counter(
            "kv_spill_errors_total",
            "Spill-tier put/get failures absorbed by the KV manager",
            ["worker", "tier", "op"], registry=r)
        self.spill_quarantined = Counter(
            "spill_quarantined_total",
            "Spilled/persisted entries quarantined instead of served",
            ["worker", "tier", "reason"], registry=r)
        self.io_breaker_state = Gauge(
            "io_breaker_state",
            "Per-tier spill circuit breaker state "
            "(0=closed, 1=half_open, 2=open)",
            ["worker", "tier"], registry=r)
        self.store_degraded = Gauge(
            "store_degraded",
            "1 while the plane's job store is rejecting writes "
            "(submissions bounce with error_code=store_unavailable)",
            registry=r)

    def render(self) -> bytes:
        return self._generate(self.registry)


class MetricsCollector:
    """High-level facade the runtime calls into (reference :255-405)."""

    # distinct tenant label values admitted into per-tenant series before
    # new tenants aggregate under "other" — the Prometheus registry must
    # stay bounded no matter how many tenant ids a client sprays
    TENANT_LABEL_CAP = 64

    def __init__(self, metrics: Optional[Metrics] = None,
                 tenant_label_cap: Optional[int] = None) -> None:
        self.metrics = metrics or Metrics()
        self._tok_window: list[tuple[float, int]] = []
        # last-seen cumulative spec counters per worker: engines report
        # monotonic totals, Prometheus counters advance by deltas
        self._spec_prev: Dict[str, Dict[str, int]] = {}
        self._pressure_prev: Dict[str, Dict[str, int]] = {}
        self._batcher_prev: Dict[str, Dict[str, int]] = {}
        self._pd_prev: Dict[str, Dict[str, int]] = {}
        self._kvmig_prev: Dict[str, Dict[str, int]] = {}
        self._kvspill_prev: Dict[str, Dict[str, int]] = {}
        self._flight_prev: Dict[str, Dict[str, int]] = {}
        self._direct_prev: Dict[str, Dict[str, int]] = {}
        # bounded tenant-label admission (insertion-ordered dict as LRU):
        # once full, unseen tenants map to "other" — existing series keep
        # their labels (a label that has emitted samples must not migrate)
        self._tenant_label_cap = int(
            tenant_label_cap if tenant_label_cap is not None
            else self.TENANT_LABEL_CAP
        )
        self._tenant_labels: Dict[str, None] = {}

    def record_request(self, job_type: str, status: str,
                       latency_s: Optional[float] = None) -> None:
        self.metrics.inference_requests.labels(job_type, status).inc()
        if latency_s is not None:
            self.metrics.inference_latency.labels(job_type).observe(latency_s)

    def record_tokens(self, n: int, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        self.metrics.tokens_generated.inc(n)
        self._tok_window.append((now, n))
        cutoff = now - 10.0
        self._tok_window = [(t, c) for t, c in self._tok_window if t >= cutoff]
        span = max(1e-6, now - self._tok_window[0][0]) if self._tok_window else 1.0
        total = sum(c for _, c in self._tok_window)
        self.metrics.tokens_per_second.set(total / span if span > 0 else 0.0)

    def record_kv_stats(self, tier: str, hit_rate: float, size_blocks: int,
                        evictions: int = 0) -> None:
        self.metrics.kv_cache_hit_rate.labels(tier).set(hit_rate)
        self.metrics.kv_cache_size.labels(tier).set(size_blocks)
        if evictions:
            self.metrics.kv_cache_evictions.labels(tier).inc(evictions)

    def record_worker_counts(self, by_status: Dict[str, int]) -> None:
        for status, n in by_status.items():
            self.metrics.worker_status.labels(status).set(n)

    def record_hop(self, latency_s: float) -> None:
        self.metrics.hop_latency.observe(latency_s)

    def record_kv_migration(self, latency_s: float) -> None:
        self.metrics.kv_migration_latency.observe(latency_s)

    def record_batch(self, size: int) -> None:
        self.metrics.batch_size.set(size)

    def record_queue(self, phase: str, size: int) -> None:
        self.metrics.queue_size.labels(phase).set(size)

    def record_speculative(self, accept_rate: float,
                           tokens_per_step: float) -> None:
        self.metrics.spec_accept_rate.set(accept_rate)
        self.metrics.spec_speedup.set(tokens_per_step)

    def record_spec_engine(self, worker: str,
                           engine_stats: Dict[str, Any]) -> None:
        """Ingest one worker engine's speculative counters
        (``TPUEngine.get_stats()`` — spec_accepted / spec_drafted /
        spec_slot_steps totals plus the derived rate/amortization gauges)
        so ``/metrics`` surfaces speculation efficiency per worker. Safe to
        call with stats from a non-speculative engine (no-op counters)."""
        prev = self._spec_prev.setdefault(worker, {})
        for key, metric in (
            ("spec_accepted", self.metrics.spec_accepted_tokens),
            ("spec_drafted", self.metrics.spec_drafted_tokens),
            ("spec_slot_steps", self.metrics.spec_decode_steps),
        ):
            try:
                cur = int(engine_stats.get(key, 0) or 0)
            except (TypeError, ValueError):
                # worker-supplied payload: one malformed field must degrade
                # to a skipped sample, never 500 the heartbeat (a failing
                # heartbeat gets a LIVE worker swept offline)
                continue
            delta = cur - prev.get(key, 0)
            if delta > 0:
                metric.labels(worker).inc(delta)
            # an engine restart resets totals — re-anchor instead of
            # emitting a bogus negative/huge delta
            prev[key] = cur
        if "spec_accept_rate" in engine_stats:
            try:
                rate = float(engine_stats.get("spec_accept_rate") or 0.0)
                tps = float(engine_stats.get("spec_tokens_per_step") or 0.0)
            except (TypeError, ValueError):
                return
            self.metrics.spec_worker_accept_rate.labels(worker).set(rate)
            self.metrics.spec_worker_tokens_per_step.labels(worker).set(tps)

    def record_pressure_engine(self, worker: str,
                               engine_stats: Dict[str, Any]) -> None:
        """Ingest one worker engine's KV-pressure counters (heartbeat
        ``engine_stats``: cumulative ``preemptions`` / ``resumes`` /
        ``kv_pressure_events`` from ``TPUEngine.get_stats()`` or the
        batcher) so ``/metrics`` surfaces per-worker preemption health.
        Same delta-anchoring as the spec counters: totals re-anchor on
        engine restart, malformed fields skip the sample, and a payload
        with no pressure keys is a no-op."""
        prev = self._pressure_prev.setdefault(worker, {})
        for key, metric in (
            ("preemptions", self.metrics.kv_preemptions),
            ("resumes", self.metrics.kv_resumes),
            ("kv_pressure_events", self.metrics.kv_pressure_events),
            # abandoned streamed-handoff sessions purged on the worker's
            # HandoffReceiver (TTL, no-progress, or session-cap eviction)
            # — rides the same heartbeat payload and delta anchoring
            ("kv_handoff_sessions_purged", self.metrics.kv_handoff_purged),
        ):
            if key not in engine_stats:
                continue
            try:
                cur = int(engine_stats.get(key, 0) or 0)
            except (TypeError, ValueError):
                continue
            delta = cur - prev.get(key, 0)
            if delta > 0:
                metric.labels(worker).inc(delta)
            prev[key] = cur

    def record_batcher_engine(self, worker: str,
                              stats: Dict[str, Any]) -> None:
        """Ingest one worker's batcher serving stats (heartbeat
        ``engine_stats["batcher"]`` — ``Worker._batcher_stats``): gauges
        set directly, counters delta-anchored like the spec/pressure
        payloads (totals re-anchor on engine restart, malformed fields
        skip the sample)."""
        for key, gauge in (
            ("queue_depth", self.metrics.batcher_queue_depth),
            ("active_slots", self.metrics.batcher_active_slots),
            ("avg_occupancy", self.metrics.batcher_occupancy),
            ("horizon", self.metrics.batcher_horizon),
        ):
            if key not in stats:
                continue
            try:
                gauge.labels(worker).set(float(stats.get(key) or 0.0))
            except (TypeError, ValueError):
                continue
        prev = self._batcher_prev.setdefault(worker, {})
        for key, metric in (
            ("decode_rounds", self.metrics.batcher_decode_rounds),
            ("completed", self.metrics.batcher_completed),
            ("chunked_admissions", self.metrics.batcher_chunked_admissions),
            ("preemptions", self.metrics.batcher_preemptions),
            ("migrated", self.metrics.batcher_migrated),
        ):
            if key not in stats:
                continue
            try:
                cur = int(stats.get(key, 0) or 0)
            except (TypeError, ValueError):
                continue
            delta = cur - prev.get(key, 0)
            if delta > 0:
                metric.labels(worker).inc(delta)
            prev[key] = cur
        if "abandoned" in stats:
            # deadline-abandonment: hopeless slots the batcher
            # freed at a step boundary — same cumulative channel, reason
            # label for future abandonment causes
            try:
                cur = int(stats.get("abandoned", 0) or 0)
            except (TypeError, ValueError):
                return
            delta = cur - prev.get("abandoned", 0)
            if delta > 0:
                self.metrics.jobs_abandoned.labels(
                    worker, "deadline").inc(delta)
            prev["abandoned"] = cur

    # heartbeat ``engine_stats["pd"]`` key → pd_handoffs_total outcome label
    _PD_OUTCOMES = (
        ("handoffs_committed", "committed"),
        ("handoffs_failed", "failed"),
        ("handoffs_aborted", "aborted"),
        ("handoffs_local", "local"),
        ("piece_retries", "piece_retry"),
        ("adopted_expired", "adopted_expired"),
        ("rx_aborts", "rx_abort"),
        ("rx_purged_ttl", "rx_purged_ttl"),
        ("rx_purged_no_progress", "rx_purged_no_progress"),
        ("rx_purged_cap", "rx_purged_cap"),
    )

    def record_pd_engine(self, worker: str,
                         pd_stats: Dict[str, Any]) -> None:
        """Ingest one worker's PD handoff lifecycle counters (heartbeat
        ``engine_stats["pd"]`` — ``TPULLMEngine.pd_wire_stats()``): sender
        outcomes + receiver abort/purge reasons into
        ``pd_handoffs_total{outcome}``, bytes into
        ``pd_handoff_bytes_total``. Same delta anchoring as the
        spec/pressure payloads: totals re-anchor on engine restart,
        malformed fields skip the sample."""
        prev = self._pd_prev.setdefault(worker, {})
        for key, outcome in self._PD_OUTCOMES:
            if key not in pd_stats:
                continue
            try:
                cur = int(pd_stats.get(key, 0) or 0)
            except (TypeError, ValueError):
                continue
            delta = cur - prev.get(key, 0)
            if delta > 0:
                self.metrics.pd_handoffs.labels(worker, outcome).inc(delta)
            prev[key] = cur
        if "handoff_bytes" in pd_stats:
            try:
                cur = int(pd_stats.get("handoff_bytes", 0) or 0)
            except (TypeError, ValueError):
                return
            delta = cur - prev.get("handoff_bytes", 0)
            if delta > 0:
                self.metrics.pd_handoff_bytes.labels(worker).inc(delta)
            prev["handoff_bytes"] = cur

    # heartbeat ``engine_stats["kv_migrate"]`` key → outcome label
    _KVMIG_OUTCOMES = (
        ("pulled", "pulled"),
        ("fallback_recompute", "fallback_recompute"),
        ("aborted", "aborted"),
        ("local_hits", "local_hit"),
        ("exports", "export_served"),
        ("prefix_commits", "prefix_commit"),
        # proactive replication: hint-driven pulls, keyed off
        # the same engine stats dict — committed / fp-miss (exporter
        # churned the prefix out) / aborted mid-pull
        ("replicated", "replicated"),
        ("replicate_miss", "replicate_miss"),
        ("replicate_aborted", "replicate_aborted"),
    )

    def record_kv_migrate_engine(self, worker: str,
                                 stats: Dict[str, Any]) -> None:
        """Ingest one worker's cluster-KV migration counters (heartbeat
        ``engine_stats["kv_migrate"]`` — ``TPULLMEngine.
        kv_migrate_wire_stats()``): pull outcomes into
        ``kv_migrations_total{outcome}``, bytes into
        ``kv_migration_bytes_total{direction}``. Same delta anchoring as
        the spec/pressure/pd payloads: totals re-anchor on engine restart,
        malformed fields skip the sample."""
        prev = self._kvmig_prev.setdefault(worker, {})
        for key, outcome in self._KVMIG_OUTCOMES:
            if key not in stats:
                continue
            try:
                cur = int(stats.get(key, 0) or 0)
            except (TypeError, ValueError):
                continue
            delta = cur - prev.get(key, 0)
            if delta > 0:
                self.metrics.kv_migrations.labels(worker, outcome).inc(delta)
            prev[key] = cur
        for key, direction in (("pull_bytes", "pull"),
                               ("export_bytes", "export")):
            if key not in stats:
                continue
            try:
                cur = int(stats.get(key, 0) or 0)
            except (TypeError, ValueError):
                continue
            delta = cur - prev.get(key, 0)
            if delta > 0:
                self.metrics.kv_migration_bytes.labels(
                    worker, direction
                ).inc(delta)
            prev[key] = cur

    def record_kv_replicate_hints(self, n: int) -> None:
        """Count proactive-replication hints handed out in a heartbeat
        response (the plane-side half; the worker-side outcomes arrive
        through ``record_kv_migrate_engine``)."""
        if n > 0:
            self.metrics.kv_replicate_hints.inc(n)

    def record_predictive_rebalance(self, action: str) -> None:
        """Count one predictive PD rebalance action (preflip / restore /
        scale_out_role)."""
        self.metrics.predictive_rebalance.labels(action).inc()

    def record_kv_spill_engine(self, worker: str,
                               stats: Dict[str, Any]) -> None:
        """Ingest one worker's spill-tier IO health counters (heartbeat
        ``engine_stats["kv_spill"]`` — ``TPULLMEngine.
        kv_spill_wire_stats()``): per-tier put/get failures into
        ``kv_spill_errors_total{tier,op}``, corrupt-entry quarantines (and
        refused corrupt checkpoints) into
        ``spill_quarantined_total{tier,reason}``, breaker states straight
        onto the ``io_breaker_state{tier}`` gauge. Same delta anchoring as
        the spec/pressure/pd/kv-migrate payloads: totals re-anchor on
        engine restart, malformed fields skip the sample."""
        prev = self._kvspill_prev.setdefault(worker, {})

        def _delta(key: str) -> int:
            try:
                cur = int(stats.get(key, 0) or 0)
            except (TypeError, ValueError):
                return 0
            d = cur - prev.get(key, 0)
            prev[key] = cur
            return max(0, d)

        for tier in ("host", "remote"):
            for op in ("put", "get"):
                d = _delta(f"{tier}_{op}_errors")
                if d:
                    self.metrics.kv_spill_errors.labels(
                        worker, tier, op
                    ).inc(d)
            d = _delta(f"{tier}_quarantined_corrupt")
            if d:
                self.metrics.spill_quarantined.labels(
                    worker, tier, "corrupt"
                ).inc(d)
            if f"breaker_{tier}_state" in stats:
                try:
                    self.metrics.io_breaker_state.labels(worker, tier).set(
                        int(stats[f"breaker_{tier}_state"])
                    )
                except (TypeError, ValueError):
                    pass
        d = _delta("ckpt_corrupt")
        if d:
            self.metrics.spill_quarantined.labels(
                worker, "checkpoint", "corrupt"
            ).inc(d)

    def record_store_degraded(self, degraded: bool) -> None:
        """Flip the ``store_degraded`` gauge: 1 while the plane's own job
        store rejects writes (submissions bounce typed-503), back to 0 on
        the next write that lands."""
        self.metrics.store_degraded.set(1 if degraded else 0)

    def record_phase(self, phase: str, seconds: float) -> None:
        """One derived flight-recorder phase duration → the
        ``request_phase_latency_seconds{phase}`` histogram. Unknown phase
        names are recorded as-is (the label set is the canonical
        ``runtime.flight.PHASES``, but the histogram is not the place to
        police it)."""
        try:
            self.metrics.request_phase_latency.labels(str(phase)).observe(
                float(seconds)
            )
        except (TypeError, ValueError):
            pass

    def record_flight_engine(self, worker: str,
                             stats: Dict[str, Any]) -> None:
        """Ingest one worker's flight-recorder counters (heartbeat
        ``engine_stats["flight"]`` — cumulative ``timelines`` /
        ``events_dropped``). Same delta anchoring as the
        spec/pressure/pd/kv-migrate payloads: totals re-anchor on engine
        restart (a smaller total emits no bogus negative delta, just
        re-anchors), malformed fields skip the sample."""
        prev = self._flight_prev.setdefault(worker, {})
        for key, metric in (
            ("timelines", self.metrics.flight_timelines),
            ("events_dropped", self.metrics.flight_events_dropped),
        ):
            if key not in stats:
                continue
            try:
                cur = int(stats.get(key, 0) or 0)
            except (TypeError, ValueError):
                continue
            delta = cur - prev.get(key, 0)
            if delta > 0:
                metric.labels(worker).inc(delta)
            prev[key] = cur

    def record_kv_route_decision(self, path: str, choice: str) -> None:
        """One cost-model route decision on ``path`` (``direct`` discovery
        or the ``queued`` claim): warm / migrate / recompute."""
        self.metrics.kv_route_decisions.labels(path, choice).inc()

    def record_pd_reprefill(self, reason: str) -> None:
        """One PD flow fell back to re-prefill (stage failure, lost
        handoff, dead kv_holder) — plane-side, counted by reason."""
        self.metrics.pd_reprefill.labels(reason).inc()

    def record_pd_fleet_balance(self, capacity: Dict[str, int]) -> None:
        """Refresh the per-role free-capacity gauge from the PD
        scheduler's registered pool (``capacity_by_role()``)."""
        for role in ("prefill", "decode"):
            self.metrics.pd_fleet_balance.labels(role).set(
                float(capacity.get(role, 0) or 0)
            )

    # -- overload control / autoscaling --------------------------

    def tenant_label(self, tenant: str) -> str:
        """Map a tenant id onto a bounded label set: known tenants keep
        their label, new tenants are admitted until the cap, then
        aggregate under ``other``. Deliberately NOT an evicting LRU for
        label purposes: a label that has emitted samples keeps meaning
        forever (re-assigning it would corrupt the series), so admission
        is first-come-first-labeled."""
        tenant = str(tenant)[:128]
        if tenant in self._tenant_labels:
            return tenant
        if len(self._tenant_labels) < self._tenant_label_cap:
            self._tenant_labels[tenant] = None
            return tenant
        return "other"

    def record_admission(self, tier: str, action: str,
                         tenant: Optional[str] = None) -> None:
        """One overload-ladder decision: counted by tier always, and per
        tenant under the bounded label map."""
        self.metrics.admission_decisions.labels(tier, action).inc()
        if tenant is not None:
            self.metrics.tenant_admissions.labels(
                self.tenant_label(tenant), action
            ).inc()

    def record_autoscaler(self, action: str,
                          target_replicas: Optional[int] = None,
                          slo_in_window: Optional[float] = None,
                          cold_start_s: Optional[float] = None) -> None:
        """One autoscaler tick: the decision (scale_out/scale_in/hold)
        plus the observations it was made from."""
        self.metrics.autoscaler_decisions.labels(action).inc()
        if target_replicas is not None:
            self.metrics.autoscaler_replicas.set(float(target_replicas))
        if slo_in_window is not None:
            self.metrics.autoscaler_slo.set(float(slo_in_window))
        if cold_start_s is not None:
            self.metrics.autoscaler_cold_start.set(float(cold_start_s))

    def record_prefix_route(self, path: str, hit: bool,
                            spillover: bool = False) -> None:
        """One routing decision on ``path`` (``direct`` discovery or the
        ``queued`` claim): hit when the chosen worker advertised the
        request's prefix, spillover when a warmer worker existed but was
        passed over."""
        if hit:
            self.metrics.prefix_route_hits.labels(path).inc()
        if spillover:
            self.metrics.prefix_route_spillover.labels(path).inc()

    def record_prefix_summary(self, worker: str, entries: int,
                              age_s: float) -> None:
        self.metrics.prefix_summary_entries.labels(worker).set(entries)
        self.metrics.prefix_summary_age.labels(worker).set(age_s)

    def record_heartbeat_payload_rejected(self, reason: str) -> None:
        self.metrics.heartbeat_payload_rejected.labels(reason).inc()

    def record_prefix_summary_invalidated(self, reason: str) -> None:
        """One worker's advertised summary zeroed ahead of its staleness
        TTL (marked offline, swept for a stale heartbeat, partitioned)."""
        self.metrics.prefix_summaries_invalidated.labels(reason).inc()

    def record_worker_rejoin(self, worker: str) -> None:
        self.metrics.worker_rejoin.labels(worker).inc()

    def record_fleet_strength(self, serving: int, registered: int) -> None:
        """Refresh the ``fleet_degraded`` gauge: replicas currently able
        to take work over replicas the plane knows about."""
        ratio = (serving / registered) if registered else 1.0
        self.metrics.fleet_degraded.set(max(0.0, min(1.0, ratio)))

    def record_health_transition(self, frm: str, to: str) -> None:
        """One edge of the gray-failure state machine."""
        self.metrics.health_transitions.labels(frm, to).inc()

    def record_health_states(self, states: Dict[str, str]) -> None:
        """Scrape-time refresh of the per-worker health-state gauge."""
        from .health import STATE_CODES

        for wid, state in states.items():
            self.metrics.worker_health_state.labels(wid).set(
                STATE_CODES.get(state, 0)
            )

    def record_hedge(self, outcome: str, n: int = 1) -> None:
        """Hedged-dispatch lifecycle: ``offered`` at discovery time
        (plane-side), ``cancelled`` losers delta-reported through the
        worker's direct channel."""
        if n > 0:
            self.metrics.hedges.labels(outcome).inc(n)

    def record_direct_engine(self, worker: str,
                             stats: Dict[str, Any]) -> None:
        """Ingest one worker's direct-serving channel (heartbeat
        ``engine_stats["direct"]`` — ``DirectServer.wire_stats()``):
        cancelled hedge losers into ``hedges_total{outcome=cancelled}``.
        Same delta anchoring as every other engine payload; the latency
        samples riding the same channel feed the HealthService, not a
        metric."""
        prev = self._direct_prev.setdefault(worker, {})
        if "hedge_cancels" in stats:
            try:
                cur = int(stats.get("hedge_cancels", 0) or 0)
            except (TypeError, ValueError):
                return
            delta = cur - prev.get("hedge_cancels", 0)
            if delta > 0:
                self.metrics.hedges.labels("cancelled").inc(delta)
            prev["hedge_cancels"] = cur

    def record_chaos_event(self, kind: str) -> None:
        """Harness-facing seam: the fleet chaos harness reports each event
        it executes, so injected faults and the plane's observed reactions
        (requeues, rejoins, invalidations) share one scrape timeline."""
        self.metrics.chaos_events.labels(kind).inc()
        if kind in ("kill",):
            self.metrics.chaos_kills.inc()
        elif kind in ("partition", "blackout", "handoff_partition"):
            self.metrics.chaos_partitions.inc()

    def record_checkpoint(self, worker: str) -> None:
        self.metrics.job_checkpoints.labels(worker).inc()

    def record_checkpoint_rejected(self, reason: str) -> None:
        self.metrics.checkpoints_rejected.labels(reason).inc()

    def record_stream_failover(self) -> None:
        self.metrics.stream_failovers.inc()

    def render(self) -> bytes:
        return self.metrics.render()


# ---------------------------------------------------------------------------
# Tracing (reference :157-246)
# ---------------------------------------------------------------------------


def otel_console_from_env() -> bool:
    """``DGI_OTEL_CONSOLE=1`` turns on the console span exporter — the
    previously-unreachable ``TracingManager(console_export=...)`` knob
    (no caller could ever enable it) is now operator-settable without a
    code change. Off by default."""
    return os.environ.get("DGI_OTEL_CONSOLE", "").strip().lower() in (
        "1", "true", "yes", "on",
    )


class TracingManager:
    def __init__(self, service_name: str = "dgi-tpu",
                 console_export: Optional[bool] = None) -> None:
        if console_export is None:
            console_export = otel_console_from_env()
        otel = _otel()
        self.enabled = otel is not None
        if otel is None:
            self._tracer = None
            return
        TracerProvider, BatchSpanProcessor, ConsoleSpanExporter = otel
        provider = TracerProvider()
        if console_export:  # deployments swap in OTLP/Jaeger exporters
            provider.add_span_processor(
                BatchSpanProcessor(ConsoleSpanExporter())
            )
        self._tracer = provider.get_tracer(service_name)

    @contextlib.contextmanager
    def span(self, name: str, **attributes: Any) -> Iterator[Any]:
        if not self.enabled or self._tracer is None:
            yield None
            return
        with self._tracer.start_as_current_span(name) as sp:
            for k, v in attributes.items():
                try:
                    sp.set_attribute(k, v)
                except Exception:  # noqa: BLE001
                    pass
            try:
                yield sp
            except Exception as exc:
                sp.record_exception(exc)
                raise

    def emit_span(self, name: str, start_s: float, end_s: float,
                  **attributes: Any) -> None:
        """One RETROACTIVE span (explicit wall-clock start/end): the
        flight recorder derives phase boundaries after the fact and maps
        each onto an OTel span. No-op without opentelemetry; best-effort
        with it (a tracing failure must never fail a request)."""
        if not self.enabled or self._tracer is None:
            return
        try:
            sp = self._tracer.start_span(
                name, start_time=int(float(start_s) * 1e9)
            )
            for k, v in attributes.items():
                try:
                    sp.set_attribute(k, v)
                except Exception:  # noqa: BLE001
                    pass
            sp.end(end_time=int(float(end_s) * 1e9))
        except Exception:  # noqa: BLE001 — advisory by contract
            pass


@contextlib.contextmanager
def torch_profiler_trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Wrap a region in a ``torch.profiler`` trace (CPU activity, and CUDA
    kernels when a card is present), exported as a Chrome trace under
    ``log_dir`` (default: ``dgi_torch_profile`` in the temp directory).

    No-op when torch's profiler cannot start; safe to leave in production
    paths — a failure to trace never fails the region itself."""
    import tempfile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "dgi_torch_profile")
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.__enter__()
    except Exception:  # noqa: BLE001 — profiling must never break serving
        yield
        return
    try:
        yield
    finally:
        try:
            prof.__exit__(None, None, None)
            os.makedirs(log_dir, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
        except Exception:  # noqa: BLE001 — profiling must never break serving
            pass


# ---------------------------------------------------------------------------
# Structured logging (reference :455-488)
# ---------------------------------------------------------------------------


class StructuredLogger:
    def __init__(self, name: str = "dgi-tpu",
                 context: Optional[Dict[str, Any]] = None) -> None:
        self._log = logging.getLogger(name)
        self._context = dict(context or {})

    def bind(self, **context: Any) -> "StructuredLogger":
        merged = {**self._context, **context}
        child = StructuredLogger(self._log.name, merged)
        return child

    def _emit(self, level: int, event: str, **fields: Any) -> None:
        payload = {"event": event, "ts": time.time(), **self._context, **fields}
        self._log.log(level, json.dumps(payload, default=str))

    def info(self, event: str, **fields: Any) -> None:
        self._emit(logging.INFO, event, **fields)

    def warning(self, event: str, **fields: Any) -> None:
        self._emit(logging.WARNING, event, **fields)

    def error(self, event: str, **fields: Any) -> None:
        self._emit(logging.ERROR, event, **fields)
