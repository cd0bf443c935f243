"""Control-plane REST API (the port's, on ``server/web.py``).

Endpoint parity with the reference's FastAPI surface:
- Jobs API     (``server/app/api/jobs.py``): create async/sync, get, cancel,
  direct-mode discovery, queue stats.
- Workers API  (``server/app/api/workers.py``): register (token issuance),
  heartbeat (config_changed flag), atomic next-job, complete, going-offline /
  offline, verify, refresh-token, remote config GET/PUT, list/detail with
  online-probability predictions.
- Admin API    (``server/app/api/admin.py``): dashboard/realtime stats,
  enterprise CRUD + API keys, usage summaries, bills, privacy/compliance.
- ``/health``, ``/regions`` (``server/app/main.py:99-121``), ``/metrics``
  (Prometheus text).

Auth model mirrors the reference (``workers.py:55-94``): Bearer token
verified against a salted hash with a 5-strike / 15-min lockout; optional
HMAC request signing; ``X-API-Key`` for the jobs/admin surface.

The port's copy of ``distributed_gpu_inference_tpu/server/app.py``: the
same routes in the same order, status codes, JSON bodies, headers and
sqlite schema, with the handler bodies carried over as they are. Only the
transport differs: ``server/web.py``, a small asyncio HTTP/1.1 server with
the aiohttp surface the handlers use, in place of aiohttp. Start it with
``torch-server --port 8000`` or
``python -m distributed_gpu_inference_torch.server.app`` (``--port 0``
draws a free port and the banner names it).
"""

from __future__ import annotations

import asyncio
import json
import os
import sqlite3
import time
import uuid
from typing import Any, Dict, Optional

from . import web

from ..utils.data_structures import JobStatus, WorkerState
from ..utils.prefixes import fingerprints_for_params, sanitize_fingerprints
from .admission import (
    TIER_PRIORITY_BOOST,
    AdmissionController,
    estimate_cost_tokens,
    tenant_of,
)
from .calibration import CostCalibration, MigrateHintTracker
from .flight_recorder import FlightRecorder
from .geo import GeoService
from .health import HealthService
from .observability import MetricsCollector, StructuredLogger, TracingManager
from .prefix_routing import (
    PrefixRegistry,
    RoutingConfig,
    decide_kv_route,
    route_flight_attrs,
)
from .replication import ReplicationPlanner
from .reliability import ReliabilityService
from .scheduler import (
    _MAX_DISTANCE,
    REGIONS,
    WEIGHTS,
    SmartScheduler,
    estimate_job_duration_s,
    graded_load_score,
    region_distance,
)
from .security import LockoutState, SecurityService
from .store import Store
from .plane_cluster import HOPS_HEADER, PlaneCluster, _parse_chain
from .pd_flow import PDFlowError, PDFlowService
from .task_guarantee import (
    SWEEP_INTERVAL_S,
    TaskGuaranteeBackgroundWorker,
    TaskGuaranteeService,
)
from .usage import UsageService
from .privacy import EnterprisePrivacyService
from .worker_config import WorkerConfigService

API = "/api/v1"

# serialized heartbeat ``engine_stats`` beyond this is dropped (counted:
# heartbeat_payload_rejected_total{reason="engine_stats_oversize"}) — one
# misbehaving worker must not bloat the heartbeat path for the fleet
_ENGINE_STATS_MAX_BYTES = 128 * 1024


class ServerState:
    """Bundles the store + every fleet service; attached to the app."""

    def __init__(self, db_path: str = ":memory:",
                 api_key: Optional[str] = None,
                 admin_key: Optional[str] = None,
                 require_signing: bool = False,
                 heartbeat_timeout_s: float = 90.0,
                 submit_queue_limit: int = 0,
                 plane_id: Optional[str] = None,
                 plane_peers: Optional[list] = None,
                 plane_forward_max_hops: Optional[int] = None) -> None:
        self.store = Store(db_path)
        # replicated control planes: this replica's identity +
        # peer membership. OFF unless plane_id/plane_peers are configured —
        # the default single-plane build is byte-identical (no new response
        # fields, NULL plane stamps, no forwarding).
        self.plane = PlaneCluster(
            plane_id=plane_id, peers=plane_peers,
            forward_max_hops=plane_forward_max_hops, api_key=api_key,
        )
        self.security = SecurityService()
        self.reliability = ReliabilityService(self.store)
        self.metrics = MetricsCollector()
        # cache-aware routing: per-worker radix summaries (heartbeat
        # engine_stats channel) + the live-pushable routing knobs the
        # scheduler/direct-discovery affinity terms read
        self.routing = RoutingConfig()
        self.prefix_registry = PrefixRegistry(self.routing)
        # cost-model self-calibration: per-worker online
        # estimators fed from flight-trace phase durations and
        # kv_migrate counter deltas. Accumulates always (cheap, bounded);
        # decide_kv_route only READS measured values while
        # routing.calibrate is on — off keeps the static priors verbatim.
        self.calibration = CostCalibration(self.routing)
        # in-flight migrate-pull pressure per cold worker: fixes the
        # blind spot where a target already running its full pull budget
        # was priced as idle (hints expire after migrate_hint_window_s)
        self.migrate_hints = MigrateHintTracker(self.routing)
        # proactive prefix replication: discovery-time heat
        # tracking + heartbeat-response hints. Gated on routing.replicate
        # at every call site, so off costs nothing.
        self.replication = ReplicationPlanner(self.routing,
                                              self.prefix_registry)
        self.scheduler = SmartScheduler(
            self.store, self.reliability,
            prefix_registry=self.prefix_registry, metrics=self.metrics,
        )
        self.scheduler.attach_calibration(self.calibration,
                                          self.migrate_hints)
        # claims brokered by this replica carry its plane_id (NULL when the
        # cohort is disabled) — the audit trail behind the epoch fence
        self.scheduler.plane_id = self.plane.claim_stamp
        self.pd_flow = PDFlowService(self.store, metrics=self.metrics)
        self.guarantee = TaskGuaranteeService(
            self.store, self.reliability, heartbeat_timeout_s,
            # sweeps that permanently fail a PD stage child must fail its
            # container promptly (and cancel orphaned siblings) instead of
            # stranding the parent until its own timeout
            on_permanent_failure=self.pd_flow.on_job_permanently_failed,
            # partition staleness: the moment a worker is marked offline
            # (self-reported, admin, or heartbeat sweep) its advertised
            # prefix summary is zeroed — affinity must never keep routing
            # at a dead warm worker while its staleness TTL runs down
            on_worker_offline=self._invalidate_prefix_summary,
        )
        self.background = TaskGuaranteeBackgroundWorker(self.guarantee)
        self.geo = GeoService()
        self.worker_config = WorkerConfigService(self.store)
        if submit_queue_limit:
            # end-to-end backpressure: POST /jobs beyond this queue depth
            # answers 429 + Retry-After instead of growing the queue
            # silently (threshold lives on the fleet-default LoadControl —
            # the same policy object the claim-side admission enforces)
            self.worker_config.set_submit_queue_limit(submit_queue_limit)
        self.usage = UsageService(self.store)
        # SLO-native overload control: per-tenant token-bucket
        # budgets + the degrade-before-reject ladder. Disabled by default
        # (untiered fleets keep the blanket backpressure path verbatim);
        # flipped/retuned live via GET/PUT /api/v1/admin/admission.
        self.admission = AdmissionController(metrics=self.metrics)
        self.privacy = EnterprisePrivacyService(self.store)
        # console export is env-driven (DGI_OTEL_CONSOLE) — the knob was
        # previously unreachable (no caller could ever enable it)
        self.tracing = TracingManager()
        # request flight recorder: merged per-request timelines
        # — server admission/route/claim/complete events plus worker-side
        # events shipped through results and heartbeats. Always-on and
        # advisory: every recorder call is wrapped so it can never fail or
        # reorder a request.
        self.flight = FlightRecorder(metrics=self.metrics,
                                     tracing=self.tracing,
                                     calibration=self.calibration)
        self.scheduler.attach_flight(self.flight)
        # gray-failure defense: windowed per-worker health
        # scores + the healthy→suspect→quarantined→probation machine.
        # Disabled by default (discovery/claim stay byte-identical);
        # flipped/retuned live via GET/PUT /api/v1/admin/health.
        self.health = HealthService(
            on_transition=lambda wid, frm, to:
                self.metrics.record_health_transition(frm, to)
        )
        self.scheduler.attach_health(self.health)
        self.log = StructuredLogger("dgi-tpu.server")
        self.api_key = api_key
        self.admin_key = admin_key or api_key
        self.require_signing = require_signing
        # serializes reserve→issue→upsert in register_worker: a retry racing
        # its own slow original must not interleave, or the store could end
        # up holding the ORIGINAL's token hashes while the client keeps the
        # retry's tokens (instant lockout spiral)
        self.register_lock = asyncio.Lock()
        # short-TTL queue-stats cache for the backpressure check: a 429
        # FLOOD (the case backpressure exists for) must not pay two
        # GROUP BY table scans per rejected request. Accepted submissions
        # invalidate it, so admission decisions always see fresh depth.
        self._bp_cache: Optional[tuple] = None   # (expires_at, stats)
        self.started_at = time.time()

    async def _invalidate_prefix_summary(self, worker_id: str,
                                         reason: str) -> None:
        """Offline-worker hook: drop the in-memory summary (counted) and
        its persisted warm-start row, so neither live scoring nor a
        control-plane restart resurrects a dead worker's affinity."""
        if self.prefix_registry.invalidate_worker(
            worker_id, reason=reason, metrics=self.metrics
        ):
            try:
                await self.store.delete_prefix_summary(worker_id)
            except Exception:  # noqa: BLE001 — cleanup is best-effort
                pass

    def bp_cache_clear(self) -> None:
        """Invalidate the backpressure queue-stats cache — called after any
        accepted job creation so the next admission check reads the real
        queue depth (rejections leave the depth unchanged, so the cache
        stays valid through a rejection storm)."""
        self._bp_cache = None


def _state(request: web.Request) -> ServerState:
    return request.app["state"]


def _stamp_trace(body: Dict[str, Any]) -> str:
    """Ensure the submission carries a ``trace_id`` (client-supplied on
    the body or params, minted otherwise) and stamp it into params so it
    rides the job to workers — PD stage children inherit parent params,
    so one trace spans the whole disaggregated flow. Returns the id."""
    params = body.get("params")
    if not isinstance(params, dict):
        params = {}
        body["params"] = params
    tid = body.get("trace_id") or params.get("trace_id")
    if not isinstance(tid, str) or not tid:
        tid = uuid.uuid4().hex[:16]
    params["trace_id"] = str(tid)[:64]
    return params["trace_id"]


def _log_submission(st: ServerState, trace_id: str,
                    body: Dict[str, Any], **extra: Any) -> None:
    """One-request-one-id greppability: server logs for this submission
    (and everything later code logs through a bound child) carry the
    trace id + admitted tenant/tier."""
    params = body.get("params") or {}
    st.log.bind(
        trace_id=trace_id,
        **({"tenant": params["tenant"]} if params.get("tenant") else {}),
        **({"tier": params["tier"]} if params.get("tier") else {}),
    ).info("job_submitted", job_type=body.get("type") or "llm", **extra)


def _flight_note(st: ServerState, trace_id: Optional[str], event: str,
                 job_id: Optional[str] = None, **attrs: Any) -> None:
    """Advisory server-side flight event: the recorder can NEVER fail or
    reorder a request, so every call is fenced here."""
    try:
        st.flight.note(trace_id, event, job_id=job_id, **attrs)
    except Exception:  # noqa: BLE001 — recorder is advisory by contract
        pass


def _json_error(status: int, detail: str,
                retry_after_s: Optional[float] = None,
                error_code: Optional[str] = None) -> web.Response:
    """JSON error body; capacity-style rejections (429/503) carry a
    machine-readable ``retry_after_s`` in the body AND the standard
    ``Retry-After`` header, so the SDK has ONE retry contract for both.
    ``error_code`` names the degradation class (``store_unavailable``)
    so clients can distinguish a browned-out durable tier from plain
    capacity without parsing the human-readable detail."""
    body: Dict[str, Any] = {"detail": detail}
    headers = None
    if error_code is not None:
        body["error_code"] = error_code
    if retry_after_s is not None:
        body["retry_after_s"] = round(float(retry_after_s), 3)
        headers = {"Retry-After": str(max(1, int(-(-retry_after_s // 1))))}
    return web.json_response(body, status=status, headers=headers)


def _store_unavailable(st: "ServerState", exc: Exception) -> web.Response:
    """Typed degraded-mode rejection for a failed store WRITE:
    a wedged/full backing store must bounce submissions with a retryable
    503 + ``error_code="store_unavailable"`` — not an opaque 500 — while
    read paths keep serving from the intact database. Flags the
    ``store_degraded`` gauge; the next successful write clears it."""
    st.metrics.record_store_degraded(True)
    return _json_error(
        503, f"job store unavailable: {exc}",
        retry_after_s=2.0, error_code="store_unavailable",
    )


async def _submit_backpressure(st: ServerState) -> Optional[web.Response]:
    """Queue-depth admission control for job submission: when the queue is
    saturated (fleet-default ``LoadControl.max_queue_depth``), reject with
    429 + Retry-After derived from current queue stats — real backpressure
    instead of silent queue growth. Returns None when the job may enter."""
    if st.worker_config.submit_queue_limit <= 0:
        return None    # backpressure disabled: skip the queue-stats scans
    queued, active = await _queue_snapshot(st)
    ok, retry_after = st.worker_config.should_accept_submission(
        queued, active
    )
    if ok:
        return None
    st.metrics.record_request("backpressure", "rejected")
    return _json_error(
        429,
        f"queue saturated ({queued} jobs queued); retry after "
        f"{retry_after:.1f}s",
        retry_after_s=retry_after,
    )


async def _queue_snapshot(st: ServerState) -> tuple:
    """(queued, active_workers) through the short-TTL backpressure cache —
    admission decisions under a rejection flood must not pay two GROUP BY
    scans per rejected request (same contract as _submit_backpressure)."""
    now = time.time()
    if st._bp_cache is not None and st._bp_cache[0] > now:
        stats = st._bp_cache[1]
    else:
        stats = await st.store.queue_stats()
        st._bp_cache = (now + 0.25, stats)
    queued = int(stats.get("queued") or 0)
    workers = stats.get("workers") or {}
    active = int(workers.get("idle") or 0) + int(workers.get("busy") or 0)
    return queued, active


async def _admit_submission(st: ServerState, body: Dict[str, Any]
                            ) -> Optional[web.Response]:
    """Overload control for job submission with the admission controller
    ENABLED (callers keep the legacy ``_submit_backpressure`` — which
    runs BEFORE body parsing, so a rejection flood never pays a JSON
    parse — on the disabled path): the submission runs down the
    per-tenant degrade/shed ladder. A shed answers 429 + Retry-After
    (same machine-readable contract); a degrade MUTATES the body in
    place (``max_tokens`` clamp, ``speculative`` off) and stamps
    tenant/tier/priority-boost so workers and usage metering see the
    tier the plane admitted."""
    tenant, tier = tenant_of(body)
    params = body.get("params")
    if not isinstance(params, dict):
        params = {}
        body["params"] = params
    queued, active = await _queue_snapshot(st)
    decode = int(params.get("max_new_tokens") or params.get("max_tokens")
                 or 256)
    decision = st.admission.decide(
        tenant, tier, estimate_cost_tokens(params),
        queued, active, st.worker_config, decode_tokens=decode,
    )
    # admission decision on the request's timeline (shed included — the
    # trace then records WHY nothing else ever happened to it)
    _flight_note(st, params.get("trace_id"), "server.admission",
                 **decision.flight_attrs())
    if not decision.admitted:
        st.metrics.record_request("backpressure", "rejected")
        return _json_error(
            429,
            f"overloaded: {decision.reason}; retry after "
            f"{decision.retry_after_s:.1f}s",
            retry_after_s=decision.retry_after_s,
        )
    if decision.max_tokens is not None:
        # graceful degradation rung 1: clamp the decode ask (reported
        # back to the client via the result's finish_reason/usage — the
        # request still completes, just shorter)
        for key in ("max_new_tokens", "max_tokens"):
            if params.get(key) is not None:
                params[key] = min(int(params[key]), decision.max_tokens)
        params.setdefault("max_new_tokens", decision.max_tokens)
        params["degraded_max_tokens"] = decision.max_tokens
    if decision.disable_spec:
        # rung 2: vanilla decode — drafting spends compute the fleet no
        # longer has at this saturation
        params["speculative"] = False
    # the tier the plane admitted rides the job: workers place it in the
    # batcher's priority/EDF heap, usage metering bills the right bucket
    params.setdefault("tenant", tenant)
    params["tier"] = decision.tier
    body["priority"] = int(body.get("priority") or 0) \
        + TIER_PRIORITY_BOOST.get(decision.tier, 0)
    return None


# ---------------------------------------------------------------------------
# auth helpers
# ---------------------------------------------------------------------------


def _check_api_key(request: web.Request) -> Optional[web.Response]:
    st = _state(request)
    if st.api_key and request.headers.get("X-API-Key") != st.api_key:
        return _json_error(401, "invalid API key")
    return None


def _check_admin_key(request: web.Request) -> Optional[web.Response]:
    st = _state(request)
    if st.admin_key and request.headers.get("X-Admin-Key") != st.admin_key:
        return _json_error(401, "invalid admin key")
    return None


async def _auth_worker(request: web.Request, worker_id: str
                       ) -> tuple[Optional[Dict[str, Any]], Optional[web.Response]]:
    """Bearer-token auth with lockout; returns (worker_row, error_response).

    Callers MUST test the error with ``is not None`` — ``web.Response``
    subclasses Mapping, so an empty 401/423 response is FALSY and a
    truthiness check silently waves the request through unauthenticated.
    """
    st = _state(request)
    w = await st.store.get_worker(worker_id)
    if w is None:
        return None, _json_error(404, "worker not found")
    lock = LockoutState(
        failed_attempts=int(w.get("failed_auth_attempts") or 0),
        last_failed=w.get("last_failed_auth"),
        locked_until=w.get("locked_until"),
    )
    if st.security.lockout.is_locked(lock):
        return None, _json_error(423, "worker locked out")
    auth = request.headers.get("Authorization", "")
    token = auth[7:] if auth.startswith("Bearer ") else ""
    ok = st.security.tokens.verify(
        token, w.get("auth_token_hash"), w.get("token_expires_at")
    )
    if not ok:
        lock = st.security.lockout.record_failure(lock)
        await st.store.update_worker(
            worker_id,
            failed_auth_attempts=lock.failed_attempts,
            last_failed_auth=lock.last_failed,
            locked_until=lock.locked_until,
        )
        st.security.audit.log("auth_failed", actor=worker_id)
        return None, _json_error(401, "invalid token")
    if st.require_signing and w.get("signing_secret"):
        body = await request.read()
        sig_ok = st.security.signer.verify(
            w["signing_secret"], request.method, request.path, body,
            request.headers.get("X-Timestamp", ""),
            request.headers.get("X-Signature", ""),
        )
        if not sig_ok:
            return None, _json_error(401, "invalid signature")
    if w.get("failed_auth_attempts"):
        await st.store.update_worker(
            worker_id, failed_auth_attempts=0, locked_until=None
        )
    return w, None


# ---------------------------------------------------------------------------
# workers API
# ---------------------------------------------------------------------------


async def register_worker(request: web.Request) -> web.Response:
    st = _state(request)
    body = await request.json()
    # the whole resolve→issue→upsert sequence runs under register_lock: a
    # retry racing its own slow original must not interleave, or the last
    # upsert could store the ORIGINAL's token hashes while the client keeps
    # the retry's tokens — every later call 401s into lockout
    async with st.register_lock:
        return await _register_worker_locked(st, body)


async def _register_worker_locked(st: ServerState,
                                  body: Dict[str, Any]) -> web.Response:
    worker_id = body.get("worker_id")
    fingerprint = body.get("machine_fingerprint")
    if not worker_id and fingerprint:
        # registration idempotency under a flapping server: a register whose
        # response was lost gets retried by the client — the retry must land
        # on the SAME row (keyed by machine fingerprint), not mint a
        # duplicate worker that would double fleet counts and strand the
        # first row's credentials. The reservation is atomic in the store,
        # so even a retry racing its own still-in-flight original resolves
        # to one row.
        worker_id = await st.store.reserve_worker_id_for_fingerprint(
            fingerprint, str(uuid.uuid4())
        )
    worker_id = worker_id or str(uuid.uuid4())
    # restart-with-reregistration: landing on a row that already completed
    # a registration (it holds issued credentials) AND looks dead (swept
    # offline, or heartbeat-silent past the timeout) means the previous
    # incarnation of this machine is gone — whatever it was RUNNING will
    # never complete. Requeue those jobs NOW (epoch bumps on the next
    # claim, fencing any zombie remnant) instead of stranding them until
    # the stale-job sweep's per-job timeout, and count the rejoin. A row
    # with a RECENT heartbeat is NOT treated as dead: a live worker
    # re-registers to recover from a credential blip (401 + failed
    # refresh), and destructively requeueing the work it is actively
    # generating would turn that blip into duplicate compute — its jobs
    # stay put, and the sweep covers the case where it really is dying.
    prior = await st.store.get_worker(worker_id)
    boot_id = body.get("boot_id")
    rejoined = False
    if prior is not None and prior.get("auth_token_hash") is not None:
        hb = prior.get("last_heartbeat")
        rejoined = (
            prior.get("status") == WorkerState.OFFLINE.value
            or hb is None
            or time.time() - float(hb) > st.guarantee._heartbeat_timeout_s
            # fast-restart fence: a NEW process (different boot_id) on the
            # same fingerprint proves the old incarnation is dead even when
            # the restart beat the heartbeat timeout — without this, its
            # RUNNING jobs strand until the job timeout (the fresh process
            # heartbeats happily, so no sweep ever fires)
            or (bool(boot_id) and bool(prior.get("boot_id"))
                and boot_id != prior.get("boot_id"))
        )
    bundle, stored = st.security.tokens.issue()
    row: Dict[str, Any] = {
        "id": worker_id,
        "name": body.get("name") or worker_id[:8],
        "region": body.get("region") or "unknown",
        "country": body.get("country"),
        "city": body.get("city"),
        "timezone": body.get("timezone"),
        "accelerator": body.get("accelerator") or "tpu",
        "chip_generation": body.get("chip_generation"),
        "num_chips": int(body.get("num_chips") or 1),
        "hbm_gb_per_chip": float(body.get("hbm_gb_per_chip") or 16.0),
        "topology": body.get("topology"),
        "mesh_shape": body.get("mesh_shape"),
        "cpu_cores": body.get("cpu_cores"),
        "ram_gb": body.get("ram_gb"),
        "supported_types": body.get("supported_types") or ["llm"],
        "loaded_models": body.get("loaded_models") or [],
        "status": WorkerState.IDLE.value,
        # validated: an unknown role string would poison PD placement later
        "role": body.get("role") if body.get("role") in (
            "prefill", "decode", "hybrid", "pipeline_stage"
        ) else "hybrid",
        "last_heartbeat": time.time(),
        "supports_direct": bool(body.get("supports_direct")),
        "direct_url": body.get("direct_url"),
        "data_plane_url": body.get("data_plane_url"),
        "machine_fingerprint": fingerprint,
        "boot_id": boot_id,
        **stored,
    }
    await st.store.upsert_worker(row)
    if rejoined:
        st.metrics.record_worker_rejoin(worker_id)
        for job in await st.store.list_jobs(
            status=[JobStatus.RUNNING.value], worker_id=worker_id
        ):
            # conditional requeue via the guarantee layer: a completion
            # racing this re-registration keeps its terminal status
            await st.guarantee.requeue_job(job, reason="worker_reregistered")
        # the fresh process starts with a COLD cache: its pre-restart
        # summary must not keep earning affinity until the TTL expires
        await st._invalidate_prefix_summary(worker_id, "worker_reregistered")
    await st.reliability.start_session(worker_id)
    cfg = await st.worker_config.get_config(worker_id)
    st.security.audit.log("worker_registered", actor=worker_id)
    return web.json_response(
        {
            "worker_id": worker_id,
            **bundle.to_dict(),
            "config": cfg.to_dict(),
            "heartbeat_interval_s": 30,
        }
    )


async def _ingest_checkpoint(st: ServerState, worker_id: str,
                             cp: Dict[str, Any]) -> None:
    """Store one piggybacked generation checkpoint, fenced.

    ``kind=job`` entries land on the job row only while the job is still
    RUNNING on this worker at this assignment epoch — a zombie whose job
    was requeued (epoch bumped on the next claim) or taken over cannot
    poison the live assignment's resume state. ``kind=stream`` entries go
    to the stream_checkpoints table with the same epoch fence (the adopt
    path bumps it)."""
    kind = cp.get("kind")
    key = cp.get("key")
    epoch = int(cp.get("epoch") or 0)
    state = cp.get("state")
    if not key:
        st.metrics.record_checkpoint_rejected("malformed")
        return
    if kind == "job":
        job = await st.store.get_job(str(key))
        if job is None or job.get("worker_id") != worker_id:
            st.metrics.record_checkpoint_rejected("not_owner")
            return
        if int(job.get("assignment_epoch") or 0) != epoch:
            st.metrics.record_checkpoint_rejected("stale_epoch")
            return
        if job["status"] != JobStatus.RUNNING.value:
            st.metrics.record_checkpoint_rejected("not_running")
            return
        if state is not None:
            await st.store.update_job(str(key), checkpoint=state)
            st.metrics.record_checkpoint(worker_id)
        return
    if kind == "stream":
        if cp.get("done"):
            await st.store.delete_stream_checkpoint(
                str(key), worker_id, epoch
            )
            return
        ok = await st.store.save_stream_checkpoint(
            str(key), worker_id, epoch, state
        )
        if ok:
            st.metrics.record_checkpoint(worker_id)
        else:
            st.metrics.record_checkpoint_rejected("stale_epoch")
        return
    st.metrics.record_checkpoint_rejected("malformed")


async def heartbeat(request: web.Request) -> web.Response:
    worker_id = request.match_info["worker_id"]
    w, err = await _auth_worker(request, worker_id)
    if err is not None:
        return err
    st = _state(request)
    body = await request.json() if request.can_read_body else {}
    fields: Dict[str, Any] = {"last_heartbeat": time.time()}
    for key in ("status", "hbm_used_gb", "loaded_models", "current_job_id"):
        if key in body:
            fields[key] = body[key]
    stale_job = False
    claimed = fields.get("current_job_id")
    if claimed:
        # a delayed/duplicate heartbeat can carry a claim the sweeps already
        # requeued (or another worker already finished): accepting it would
        # resurrect a phantom BUSY worker shadowing the real assignment
        job = await st.store.get_job(claimed)
        if job is None or job.get("worker_id") != worker_id:
            # requeued (worker_id cleared) or taken over: a true zombie
            stale_job = True
            fields["current_job_id"] = None
            if fields.get("status") == WorkerState.BUSY.value:
                fields["status"] = WorkerState.IDLE.value
        elif job["status"] != JobStatus.RUNNING.value:
            # terminal but still ours: the heartbeat thread raced our own
            # just-reported completion — drop the claim quietly, this is
            # NOT zombie work and must not trip the worker's stale alarm
            fields["current_job_id"] = None
            if fields.get("status") == WorkerState.BUSY.value:
                fields["status"] = WorkerState.IDLE.value
    stale_jobs: list = []
    extra_claims = body.get("active_job_ids")
    if isinstance(extra_claims, list):
        # a batcher-backed worker runs several jobs concurrently;
        # current_job_id carries only one of them — fence the REST of its
        # claims too, so a requeued/taken-over concurrent job is flagged
        # back instead of silently finishing as undetected zombie work
        jids = [jid for jid in extra_claims[:32]
                if isinstance(jid, str) and jid != claimed]
        jobs = await asyncio.gather(*(st.store.get_job(j) for j in jids))
        for jid, job in zip(jids, jobs):
            if job is None or job.get("worker_id") != worker_id:
                stale_jobs.append(jid)
    if w.get("status") == WorkerState.OFFLINE.value:
        # swept offline but evidently alive: revive (a heartbeat IS proof of
        # life) and open a fresh reliability session so online-time
        # accounting resumes. Counted as a fleet rejoin — the degradation
        # panel reads recovery from this counter.
        fields.setdefault("status", WorkerState.IDLE.value)
        await st.reliability.start_session(worker_id)
        st.metrics.record_worker_rejoin(worker_id)
    es = body.get("engine_stats")
    if isinstance(es, dict):
        # payload hygiene: the engine_stats side channel is worker-supplied
        # and unauthenticated in shape — cap its serialized size so one
        # misbehaving worker cannot bloat the heartbeat path (the summary
        # channel has its own per-entry cap on top of this)
        try:
            oversized = len(json.dumps(es)) > _ENGINE_STATS_MAX_BYTES
        except (TypeError, ValueError):
            oversized = True
        if oversized:
            st.metrics.record_heartbeat_payload_rejected(
                "engine_stats_oversize"
            )
            es = None
    else:
        es = None
    if es is not None:
        batcher = es.get("batcher")
        if isinstance(batcher, dict) and batcher.get("capacity"):
            # graded load for the scheduler: a batcher-backed worker runs
            # many jobs concurrently, so the binary BUSY signal lies —
            # persist the occupancy snapshot the scoring path grades from
            fields["load_stats"] = {
                "active_slots": batcher.get("active_slots"),
                "queue_depth": batcher.get("queue_depth"),
                "capacity": batcher.get("capacity"),
                "avg_occupancy": batcher.get("avg_occupancy"),
                "ts": time.time(),
            }
    await st.store.update_worker(worker_id, **fields)
    await st.reliability.update_online_pattern(worker_id, online=True)
    cps = body.get("checkpoints")
    if isinstance(cps, list):
        # crash-safe generation: workers piggyback portable generation
        # checkpoints on heartbeats. Each entry is fenced (assignment
        # epoch + ownership) and a malformed entry degrades to a skipped
        # sample — a failing checkpoint must never 500 the heartbeat (that
        # would get a LIVE worker swept offline).
        for cp in cps[:32]:
            if not isinstance(cp, dict):
                continue
            try:
                await _ingest_checkpoint(st, worker_id, cp)
            except Exception:  # noqa: BLE001
                st.metrics.record_checkpoint_rejected("malformed")
    summary_resync = None
    summary_rejected = False
    if es is not None:
        # speculation-efficiency counters ride the heartbeat (worker
        # main._spec_engine_stats) → /metrics surfaces accept-rate and
        # tokens-per-step per worker
        st.metrics.record_spec_engine(worker_id, es)
        # KV-pressure counters (preemptions / resumes / pressure events)
        # ride the same payload → per-worker preemption panels in /metrics
        st.metrics.record_pressure_engine(worker_id, es)
        # batcher serving stats (occupancy, queue depth, chunked
        # admissions, drain migrations) → per-worker batch-health panels
        batcher = es.get("batcher")
        if isinstance(batcher, dict):
            st.metrics.record_batcher_engine(worker_id, batcher)
        # PD handoff lifecycle counters (sender outcomes, piece retries,
        # receiver abort/purge reasons) → pd_handoffs_total{outcome} /
        # pd_handoff_bytes_total per worker
        pd = es.get("pd")
        if isinstance(pd, dict):
            st.metrics.record_pd_engine(worker_id, pd)
        # cluster-KV migration counters (pull outcomes, export service,
        # bytes) → kv_migrations_total{outcome} / kv_migration_bytes_total
        kvmig = es.get("kv_migrate")
        if isinstance(kvmig, dict):
            st.metrics.record_kv_migrate_engine(worker_id, kvmig)
            # self-calibration: per-tier pull_bytes/pull_ms deltas feed
            # the worker's measured handoff bandwidth (accumulates even
            # with calibrate off — flipping the flag uses warm estimates)
            try:
                st.calibration.ingest_kv_migrate(worker_id, kvmig)
            except Exception:  # noqa: BLE001 — advisory, never 500 a beat
                pass
        # spill-tier IO health: put/get errors, corrupt-entry
        # quarantines, breaker states → kv_spill_errors_total{tier} /
        # spill_quarantined_total{tier,reason} / io_breaker_state{tier}
        kvspill = es.get("kv_spill")
        if isinstance(kvspill, dict):
            st.metrics.record_kv_spill_engine(worker_id, kvspill)
        # direct-serving channel: cancelled hedge losers →
        # hedges_total{outcome=cancelled}; the latency samples riding
        # the same payload feed the HealthService below
        direct = es.get("direct")
        if isinstance(direct, dict):
            st.metrics.record_direct_engine(worker_id, direct)
        # flight-recorder channel: cumulative counters (delta-anchored,
        # restart re-anchors like every other engine payload) plus a
        # bounded ring of recently-completed stream timelines — direct
        # streams never pass complete_job, so their worker-side events
        # ship here. Ingest UNIONS events per (trace, source) keyed by
        # name+timestamp and returns False when nothing changed, so the
        # ring re-shipping on every beat (duplicate delivery) is a no-op
        # that cannot re-finalize a trace.
        fl = es.get("flight")
        if isinstance(fl, dict):
            st.metrics.record_flight_engine(worker_id, fl)
            recent = fl.get("recent")
            if isinstance(recent, list):
                for wire in recent[:16]:
                    try:
                        if st.flight.ingest_wire(worker_id, wire) and \
                                isinstance(wire, dict) and wire.get("done"):
                            st.flight.finalize(wire.get("trace_id"))
                    except Exception:  # noqa: BLE001 — never 500 a beat
                        pass
        ps = es.get("prefix_summary")
        if ps is not None:
            # cache-aware routing: the worker's advertised radix summary
            # (full snapshot or delta — runtime/prefix_summary.py wire
            # format). Validation/caps live in the registry; rejections
            # are counted and answered, never 500d.
            await st.prefix_registry.ensure_loaded(st.store)
            res = st.prefix_registry.ingest(worker_id, ps)
            summary_resync = res.resync
            # statically un-ingestable (wire version / fingerprint basis
            # skew): tell the worker explicitly, so it stops shipping
            # payloads this plane can never apply instead of ping-ponging
            # full snapshots forever
            summary_rejected = (not res.applied and not res.resync)
            if res.reason and res.reason != "summary_resync":
                # "summary_resync" is the PROTOCOL-NORMAL recovery path
                # (plane restart, lost heartbeat) — counting it here would
                # make the misbehaving-worker counter fire on every
                # restart; real rejections/truncations only
                st.metrics.record_heartbeat_payload_rejected(res.reason)
            if res.applied:
                try:
                    await st.prefix_registry.persist(worker_id, st.store)
                except Exception:  # noqa: BLE001 — persistence is warm-
                    pass           # start comfort, never heartbeat-fatal
    # gray-failure defense: every beat feeds the health score — direct
    # serving latencies/errors (es["direct"]) + the worker-measured
    # heartbeat round-trip (body["hb_rtt_ms"]) — and advances the
    # quarantine state machine. No-op (not even accumulation) while the
    # service is disabled.
    st.health.ingest(worker_id, es, body)
    if es is not None and es.get("prefix_summary_live"):
        # the worker declares its summary channel alive this beat (wire()
        # returns None while in sync, so no payload ≠ no summary): keep
        # its advertised state fresh — staleness means "stopped
        # heartbeating / restarted / channel disabled", not "stopped
        # serving new prefixes". A restarted worker that no longer ships
        # summaries omits the marker and ages out within one TTL.
        st.prefix_registry.touch(worker_id)
    replicate_hints = None
    if st.routing.enabled and st.routing.replicate:
        # proactive prefix replication: hot prefixes this worker does not
        # hold ride the response as pull hints. The store query runs only
        # while the flag is on; off keeps the beat byte-identical.
        try:
            srcs = await st.store.list_workers(
                status=[WorkerState.IDLE.value, WorkerState.BUSY.value]
            )
            hints = st.replication.hints_for(worker_id, srcs)
            if hints:
                replicate_hints = hints
                st.metrics.record_kv_replicate_hints(len(hints))
        except Exception:  # noqa: BLE001 — advisory, never 500 a beat
            pass
    client_version = int(body.get("config_version") or 0)
    changed = await st.worker_config.config_changed_since(
        worker_id, client_version
    )
    return web.json_response({
        "ok": True, "config_changed": changed, "stale_job": stale_job,
        **({"stale_jobs": stale_jobs} if stale_jobs else {}),
        **({"prefix_summary_resync": summary_resync}
           if summary_resync is not None else {}),
        **({"prefix_summary_applied": False} if summary_rejected else {}),
        # plane cohort: the replica answering this beat. The
        # worker watches for a CHANGE (its plane died, it failed over) and
        # resyncs a full prefix-summary snapshot — the new plane has no
        # ACKed delta base. Omitted single-plane: the response stays
        # byte-identical to the pre-cohort build.
        **({"plane_id": st.plane.plane_id} if st.plane.enabled else {}),
        # proactive replication: pull-ahead hints for prefixes
        # heating up that this worker does not advertise. Omitted unless
        # routing.replicate is on AND the planner found work — the beat
        # stays byte-identical otherwise.
        **({"kv_replicate": replicate_hints} if replicate_hints else {}),
    })


async def next_job(request: web.Request) -> web.Response:
    worker_id = request.match_info["worker_id"]
    w, err = await _auth_worker(request, worker_id)
    if err is not None:
        return err
    st = _state(request)
    job = await st.scheduler.atomic_assign_job(worker_id)
    if job is None:
        return web.Response(status=204)  # no job (reference api_client.py:161)
    # server-side admission policy (reference worker_config.py:195): release
    # the claim without burning a retry if load control declines it
    import random as _random

    if not await st.worker_config.should_accept_job(
        worker_id, job["type"], rand=_random.random(),
        ignore_job_id=job["id"],
    ):
        # conditional release: between our claim and this decline a sweep
        # (or admin cancel) may have moved the job — an unconditional
        # overwrite would clobber another worker's fresh claim or revert a
        # terminal status back to QUEUED (stale-claim race under
        # concurrent failover)
        await st.store.try_transition_job(
            job["id"], JobStatus.RUNNING.value, owned_by=worker_id,
            status=JobStatus.QUEUED.value, worker_id=None,
            started_at=None,
        )
        await st.store.update_worker(
            worker_id, current_job_id=None, status=WorkerState.IDLE.value
        )
        return web.Response(status=204)
    # the claim lands on the request's timeline (+ an OTel span): queue
    # wait on the queued path is submitted → claimed
    trace_id = (job.get("params") or {}).get("trace_id") \
        if isinstance(job.get("params"), dict) else None
    if trace_id:
        with st.tracing.span("job.claim", trace_id=trace_id,
                             worker=worker_id):
            _flight_note(st, trace_id, "server.claimed",
                         job_id=job["id"], worker=worker_id)
    st.metrics.record_queue("queued", (await st.store.queue_stats())["queued"])
    return web.json_response({"job": job})


async def release_job(request: web.Request) -> web.Response:
    """Worker declines a claimed job (client-side load control): requeue it
    without burning a retry or recording a failure — any other worker can run
    it. Mirrors the server-side admission release in ``next_job``."""
    worker_id = request.match_info["worker_id"]
    job_id = request.match_info["job_id"]
    w, err = await _auth_worker(request, worker_id)
    if err is not None:
        return err
    st = _state(request)
    job = await st.store.get_job(job_id)
    if job is None or job.get("worker_id") != worker_id:
        return _json_error(404, "job not assigned to this worker")
    if job["status"] == JobStatus.RUNNING.value:
        # conditional: a sweep requeue + another worker's re-claim can land
        # between our read and this write — releasing unconditionally
        # would yank the job out from under the NEW owner (stale-claim
        # race the fleet chaos suite drives via requeue storms)
        await st.store.try_transition_job(
            job_id, JobStatus.RUNNING.value, owned_by=worker_id,
            status=JobStatus.QUEUED.value, worker_id=None,
            started_at=None,
        )
    await st.store.update_worker(
        worker_id, current_job_id=None, status=WorkerState.IDLE.value
    )
    return web.json_response({"status": "released"})


async def complete_job(request: web.Request) -> web.Response:
    worker_id = request.match_info["worker_id"]
    job_id = request.match_info["job_id"]
    w, err = await _auth_worker(request, worker_id)
    if err is not None:
        return err
    st = _state(request)
    job = await st.store.get_job(job_id)
    if job is None or job.get("worker_id") != worker_id:
        return _json_error(404, "job not assigned to this worker")
    body = await request.json()
    success = bool(body.get("success", True))
    # flight recorder: the worker's per-request timeline rides the result
    # payload — lift it off before the result is stored (the merged
    # timeline lands on the job row separately at finalize)
    flight_wire = None
    if isinstance(body.get("result"), dict):
        flight_wire = body["result"].pop("timeline", None)
    claimed_epoch = body.get("assignment_epoch")
    if claimed_epoch is not None and \
            int(claimed_epoch) != int(job.get("assignment_epoch") or 0):
        # zombie fence: the job was requeued/reclaimed since this worker's
        # assignment (every claim bumps assignment_epoch — even a reclaim
        # by the SAME worker, which the worker_id check above cannot see).
        # The late result is discarded; release this worker's capacity
        # claim so it doesn't sit phantom-BUSY.
        w2 = await st.store.get_worker(worker_id)
        if w2 is not None and w2.get("current_job_id") == job_id:
            fields: Dict[str, Any] = {"current_job_id": None}
            if w2.get("status") == WorkerState.BUSY.value:
                # only BUSY→IDLE: a DRAINING worker must stay draining or
                # the scheduler would hand fresh work to a process that is
                # seconds from exiting
                fields["status"] = WorkerState.IDLE.value
            await st.store.update_worker(worker_id, **fields)
        st.metrics.record_checkpoint_rejected("stale_epoch")
        return _json_error(
            409, f"stale assignment epoch {claimed_epoch} "
                 f"(job is at {job.get('assignment_epoch') or 0})"
        )

    async def _already_terminal(status: str) -> web.Response:
        # always release this worker's capacity claim on the job
        w2 = await st.store.get_worker(worker_id)
        if w2 is not None and w2.get("current_job_id") == job_id:
            await st.store.update_worker(
                worker_id, current_job_id=None, status=WorkerState.IDLE.value
            )
        expected = (
            JobStatus.COMPLETED.value if success else JobStatus.FAILED.value
        )
        if status == expected:
            # duplicate delivery (response lost → client retried, or the
            # request was replayed in flight): the first delivery already
            # applied the status change, reliability delta, and usage —
            # acknowledge idempotently, never double-apply
            return web.json_response({"ok": True, "duplicate": True})
        # late completion of a cancelled/requeued job: never overwrite the
        # terminal status or bill usage for it
        return _json_error(409, f"job is {status}, not running")

    if job["status"] != JobStatus.RUNNING.value:
        return await _already_terminal(job["status"])
    now = time.time()
    dur_ms = (
        (now - float(job["started_at"])) * 1000.0 if job.get("started_at") else None
    )
    # atomic RUNNING→terminal claim: of N concurrent duplicate deliveries
    # exactly ONE wins and applies the reliability/usage/PD effects below;
    # losers re-read the row and take the duplicate/conflict path above
    won = await st.store.try_transition_job(
        job_id, JobStatus.RUNNING.value, owned_by=worker_id,
        status=JobStatus.COMPLETED.value if success else JobStatus.FAILED.value,
        result=body.get("result"),
        error=body.get("error"),
        completed_at=now,
        actual_duration_ms=dur_ms,
    )
    if not won:
        job2 = await st.store.get_job(job_id)
        return await _already_terminal(
            job2["status"] if job2 is not None else "gone"
        )
    await st.store.update_worker(
        worker_id, current_job_id=None, status=WorkerState.IDLE.value
    )
    await st.reliability.record_event(
        worker_id,
        "job_completed" if success else "job_failed",
        latency_ms=dur_ms,
    )
    st.metrics.record_request(
        job["type"], "completed" if success else "failed",
        latency_s=(dur_ms or 0) / 1000.0,
    )
    job2 = await st.store.get_job(job_id)
    if success:
        await st.usage.record_job_usage(job2, enterprise_id=None)
    if job2 is not None and st.pd_flow.is_pd_child(job2):
        # advance the PD flow (prefill done → enqueue pinned decode child;
        # decode done → merge results into the parent container job)
        await st.pd_flow.on_child_complete(job2)
    await _flight_complete(st, job2 or job, job_id, worker_id, success,
                           flight_wire)
    return web.json_response({"ok": True})


async def _flight_complete(st: ServerState, job: Dict[str, Any],
                           job_id: str, worker_id: str, success: bool,
                           flight_wire: Any) -> None:
    """Completion-time flight-recorder fan-in: ingest the worker's
    result-borne events, stamp the completion, derive + observe phases
    (observe-once per phase — PD children compose: the prefill child's
    completion lands prefill/ttft, the decode child's lands decode/e2e),
    and persist the merged timeline with the job (the PD parent's row for
    stage children). Advisory end to end — any failure is swallowed."""
    try:
        params = job.get("params")
        trace_id = params.get("trace_id") \
            if isinstance(params, dict) else None
        if not trace_id:
            return
        if flight_wire is not None:
            st.flight.ingest_wire(worker_id, flight_wire)
        with st.tracing.span("job.complete", trace_id=trace_id,
                             worker=worker_id, success=success):
            _flight_note(st, trace_id, "server.completed", job_id=job_id,
                         worker=worker_id, success=success)
        # a PD prefill child's completion is NOT the end of the request:
        # defer e2e/decode/handoff observation to the decode child's
        # finalize (observe-once would otherwise lock in a prefill-only
        # e2e and permanently exclude decode time from the histograms)
        st.flight.finalize(trace_id, partial=(
            st.pd_flow.is_pd_child(job)
            and (params or {}).get("pd_stage") == "prefill"
        ))
        tl = st.flight.timeline(trace_id)
        if tl is None:
            return
        target = job_id
        if st.pd_flow.is_pd_child(job):
            target = str((params or {}).get("pd_parent") or job_id)
        await st.store.update_job(target, timeline={
            "trace_id": trace_id,
            "events": tl["events"],
            "phases": tl["phases"],
        })
    except Exception:  # noqa: BLE001 — the recorder can never fail a request
        pass


async def checkpoint_job(request: web.Request) -> web.Response:
    """Worker-pushed generation checkpoint for a RUNNING job — the
    graceful-drain migration path (``migrate=true`` additionally requeues
    the job WITHOUT burning a retry, so the next claimant resumes from the
    checkpoint instead of regenerating). Fenced by assignment epoch like
    every other checkpoint write."""
    worker_id = request.match_info["worker_id"]
    job_id = request.match_info["job_id"]
    w, err = await _auth_worker(request, worker_id)
    if err is not None:
        return err
    st = _state(request)
    job = await st.store.get_job(job_id)
    if job is None or job.get("worker_id") != worker_id:
        return _json_error(404, "job not assigned to this worker")
    body = await request.json()
    epoch = int(body.get("assignment_epoch") or 0)
    if epoch != int(job.get("assignment_epoch") or 0):
        st.metrics.record_checkpoint_rejected("stale_epoch")
        return _json_error(
            409, f"stale assignment epoch {epoch} "
                 f"(job is at {job.get('assignment_epoch') or 0})"
        )
    if job["status"] != JobStatus.RUNNING.value:
        st.metrics.record_checkpoint_rejected("not_running")
        return _json_error(409, f"job is {job['status']}, not running")
    state = body.get("state")
    if state is not None:
        await st.store.update_job(job_id, checkpoint=state)
        st.metrics.record_checkpoint(worker_id)
    requeued = False
    if body.get("migrate"):
        # graceful migration: conditional RUNNING→QUEUED (a racing
        # completion keeps its terminal status), retry_count untouched —
        # a drain is not a failure. The checkpoint stays on the row; the
        # next claim bumps the epoch and resumes from it.
        requeued = await st.store.try_transition_job(
            job_id, JobStatus.RUNNING.value, owned_by=worker_id,
            status=JobStatus.QUEUED.value,
            worker_id=None,
            started_at=None,
        )
        w2 = await st.store.get_worker(worker_id)
        if w2 is not None and w2.get("current_job_id") == job_id:
            fields: Dict[str, Any] = {"current_job_id": None}
            if w2.get("status") == WorkerState.BUSY.value:
                fields["status"] = WorkerState.IDLE.value
            await st.store.update_worker(worker_id, **fields)
    return web.json_response({"ok": True, "requeued": requeued})


async def checkpoint_stream(request: web.Request) -> web.Response:
    """Worker-pushed checkpoint for a direct (queue-less) SSE stream —
    the per-token/periodic cadence between heartbeats. ``done=true``
    deletes the row when the stream finishes normally (fenced: a zombie's
    late "done" cannot erase the state its replacement resumes from)."""
    worker_id = request.match_info["worker_id"]
    stream_id = request.match_info["stream_id"]
    w, err = await _auth_worker(request, worker_id)
    if err is not None:
        return err
    st = _state(request)
    body = await request.json()
    epoch = int(body.get("epoch") or 0)
    try:
        if body.get("done"):
            await st.store.delete_stream_checkpoint(
                stream_id, worker_id, epoch
            )
            return web.json_response({"ok": True, "deleted": True})
        ok = await st.store.save_stream_checkpoint(
            stream_id, worker_id, epoch, body.get("state")
        )
    except sqlite3.OperationalError as exc:
        # a dark store costs checkpoint STALENESS, never an opaque 500:
        # the worker's pusher treats any failure as a skipped push and
        # the next cadence retries (typed so it shows up in SDK traces)
        return _store_unavailable(st, exc)
    st.metrics.record_store_degraded(False)
    if not ok:
        st.metrics.record_checkpoint_rejected("stale_epoch")
        return _json_error(
            409, f"stale stream epoch {epoch} for {stream_id}"
        )
    st.metrics.record_checkpoint(worker_id)
    return web.json_response({"ok": True})


async def adopt_stream(request: web.Request) -> web.Response:
    """Failover worker adopts a dropped stream's checkpoint: atomically
    bumps the epoch (fencing the previous owner's late writes out) and
    returns the latest state so the adopter resumes via
    ``TPUEngine.resume()`` and splices the continuation at the client's
    offset."""
    worker_id = request.match_info["worker_id"]
    stream_id = request.match_info["stream_id"]
    w, err = await _auth_worker(request, worker_id)
    if err is not None:
        return err
    st = _state(request)
    row = await st.store.adopt_stream_checkpoint(stream_id, worker_id)
    if row is None:
        return _json_error(404, f"no checkpoint for stream {stream_id}")
    st.metrics.record_stream_failover()
    return web.json_response({
        "stream_id": stream_id,
        "checkpoint": row["state"],
        "epoch": row["epoch"],
    })


async def going_offline(request: web.Request) -> web.Response:
    worker_id = request.match_info["worker_id"]
    w, err = await _auth_worker(request, worker_id)
    if err is not None:
        return err
    st = _state(request)
    await st.store.update_worker(worker_id, status=WorkerState.DRAINING.value)
    return web.json_response({"ok": True, "drain": True})


async def offline(request: web.Request) -> web.Response:
    worker_id = request.match_info["worker_id"]
    w, err = await _auth_worker(request, worker_id)
    if err is not None:
        return err
    st = _state(request)
    requeued = await st.guarantee.handle_worker_offline(worker_id, graceful=True)
    return web.json_response({"ok": True, "requeued_jobs": requeued})


async def verify_worker(request: web.Request) -> web.Response:
    worker_id = request.match_info["worker_id"]
    w, err = await _auth_worker(request, worker_id)
    if err is not None:
        return err
    return web.json_response({"ok": True, "worker_id": worker_id})


async def refresh_token(request: web.Request) -> web.Response:
    worker_id = request.match_info["worker_id"]
    st = _state(request)
    w = await st.store.get_worker(worker_id)
    if w is None:
        return _json_error(404, "worker not found")
    body = await request.json()
    if not st.security.tokens.verify(
        body.get("refresh_token", ""), w.get("refresh_token_hash")
    ):
        return _json_error(401, "invalid refresh token")
    bundle, stored = st.security.tokens.issue()
    await st.store.update_worker(worker_id, **stored)
    st.security.audit.log("token_refreshed", actor=worker_id)
    return web.json_response({"worker_id": worker_id, **bundle.to_dict()})


async def get_worker_config(request: web.Request) -> web.Response:
    worker_id = request.match_info["worker_id"]
    w, err = await _auth_worker(request, worker_id)
    if err is not None:
        return err
    st = _state(request)
    cfg = await st.worker_config.get_config(worker_id)
    await st.store.update_worker(worker_id, last_config_sync=time.time())
    return web.json_response(cfg.to_dict())


async def put_worker_config(request: web.Request) -> web.Response:
    worker_id = request.match_info["worker_id"]
    w, err = await _auth_worker(request, worker_id)
    if err is not None:
        return err
    st = _state(request)
    updates = await request.json()
    cfg = await st.worker_config.update_config(worker_id, updates)
    return web.json_response(cfg.to_dict())


async def list_workers(request: web.Request) -> web.Response:
    if (err := _check_api_key(request)) is not None:
        return err
    st = _state(request)
    workers = await st.store.list_workers()
    out = []
    for w in workers:
        out.append(
            {
                "id": w["id"], "name": w["name"], "region": w["region"],
                "status": w["status"], "role": w.get("role"),
                "accelerator": w.get("accelerator"),
                "chip_generation": w.get("chip_generation"),
                "num_chips": w.get("num_chips"),
                "reliability_score": w.get("reliability_score"),
                "online_probability": st.reliability.predict_online_probability(w),
                "supported_types": w.get("supported_types"),
                "loaded_models": w.get("loaded_models"),
                "last_heartbeat": w.get("last_heartbeat"),
            }
        )
    return web.json_response({"workers": out, "total": len(out)})


async def worker_detail(request: web.Request) -> web.Response:
    if (err := _check_api_key(request)) is not None:
        return err
    st = _state(request)
    w = await st.store.get_worker(request.match_info["worker_id"])
    if w is None:
        return _json_error(404, "worker not found")
    for secret in ("auth_token_hash", "refresh_token_hash", "signing_secret"):
        w.pop(secret, None)
    w["online_probability"] = st.reliability.predict_online_probability(w)
    w["predicted_remaining_minutes"] = st.reliability.predict_remaining_online_time(w)
    return web.json_response(w)


# ---------------------------------------------------------------------------
# jobs API
# ---------------------------------------------------------------------------


async def _make_job_row(request: web.Request, body: Dict[str, Any]
                        ) -> Dict[str, Any]:
    st = _state(request)
    client_ip = request.headers.get("X-Forwarded-For", request.remote or "")
    client_ip = client_ip.split(",")[0].strip()
    client_region = await st.geo.detect_client_region(client_ip)
    # cache-aware routing: the job row carries the request's prefix
    # boundary fingerprints — client-supplied (SDK prefix_hint / auto)
    # wins, server-side computation from the prompt/messages is the
    # fallback. Advisory: an empty list just means locality-blind.
    fps: list = []
    if st.routing.enabled and (body.get("type") or "llm") == "llm":
        fps = sanitize_fingerprints(
            body.get("prefix_fps"), st.routing.max_fps_per_request
        )
        if not fps:
            fps = fingerprints_for_params(
                body.get("params"), st.routing.block_chars,
                st.routing.max_fps_per_request,
            )
    return {
        "type": body.get("type") or "llm",
        "params": body.get("params") or {},
        **({"prefix_fps": fps} if fps else {}),
        "priority": int(body.get("priority") or 0),
        "preferred_region": body.get("preferred_region") or client_region,
        "allow_cross_region": bool(body.get("allow_cross_region", True)),
        "client_ip": client_ip or None,
        "client_region": client_region,
        "timeout_seconds": float(body.get("timeout_seconds") or 300.0),
        "max_retries": int(body.get("max_retries") or 3),
    }


async def _forward_or(st: ServerState, request: web.Request,
                      body: Dict[str, Any], local: web.Response,
                      sync: bool = False) -> web.Response:
    """Capacity rejection path with plane forwarding: before bouncing the
    client, offer the submission to a peer plane (bounded hops, loop
    fence — server/plane_cluster.py). A peer's definitive answer is
    relayed; when every peer declines too, the LOCAL rejection stands, so
    single-plane behavior (and the retry contract) is unchanged."""
    chain = _parse_chain(request.headers.get(HOPS_HEADER))
    fwd = await st.plane.forward_job(body, chain, sync=sync)
    if fwd is None:
        return local
    status, payload = fwd
    st.metrics.record_request("plane_forward", "sent")
    return web.json_response(payload, status=status)


async def create_job(request: web.Request) -> web.Response:
    if (err := _check_api_key(request)) is not None:
        return err
    st = _state(request)
    st.plane.note_received(_parse_chain(request.headers.get(HOPS_HEADER)))
    if not st.admission.cfg.enabled:
        # ladder OFF: the blanket queue-depth backpressure, still run
        # BEFORE body parsing so a 429 flood stays parse-free
        if (bp := await _submit_backpressure(st)) is not None:
            if not st.plane.enabled:
                return bp
            return await _forward_or(st, request, await request.json(), bp)
    body = await request.json()
    trace_id = _stamp_trace(body)
    if st.admission.cfg.enabled and \
            (bp := await _admit_submission(st, body)) is not None:
        return bp
    _log_submission(st, trace_id, body)
    row = await _make_job_row(request, body)
    if (row.get("params") or {}).get("pd_disaggregated"):
        # PD container job: created RUNNING (never claimable); the flow
        # service places prefill/decode and enqueues the pinned stage jobs
        row["status"] = JobStatus.RUNNING.value
        row["started_at"] = time.time()
        try:
            with st.tracing.span("job.submit", trace_id=trace_id, pd=True):
                job_id = await st.store.create_job(row)
        except sqlite3.OperationalError as exc:
            return _store_unavailable(st, exc)
        st.metrics.record_store_degraded(False)
        st.bp_cache_clear()
        _flight_note(st, trace_id, "server.submitted", job_id=job_id,
                     pd=True)
        job = await st.store.get_job(job_id)
        try:
            await st.pd_flow.submit(job)
        except PDFlowError as exc:
            await st.store.update_job(
                job_id, status=JobStatus.FAILED.value, error=str(exc),
                completed_at=time.time(),
            )
            # machine-readable retry hint: PD placement failures are
            # capacity problems (no prefill/decode pair free) — same retry
            # contract as the 429 backpressure path
            return _json_error(503, str(exc), retry_after_s=5.0)
        except Exception as exc:  # noqa: BLE001 — parent must not strand
            await st.store.update_job(
                job_id, status=JobStatus.FAILED.value,
                error=f"pd placement error: {exc}",
                completed_at=time.time(),
            )
            return _json_error(500, f"pd placement error: {exc}")
        st.metrics.record_request(row["type"], "queued")
        return web.json_response(
            {"job_id": job_id, "status": "running", "pd": True}, status=201
        )
    try:
        with st.tracing.span("job.submit", trace_id=trace_id):
            job_id = await st.store.create_job(row)
    except sqlite3.OperationalError as exc:
        return _store_unavailable(st, exc)
    st.metrics.record_store_degraded(False)
    st.bp_cache_clear()
    _flight_note(st, trace_id, "server.submitted", job_id=job_id)
    st.metrics.record_request(row["type"], "queued")
    return web.json_response({"job_id": job_id, "status": "queued"}, status=201)


async def create_job_sync(request: web.Request) -> web.Response:
    """503 with no capacity; priority boost +10; long-poll for the result
    (reference jobs.py:116-181)."""
    if (err := _check_api_key(request)) is not None:
        return err
    st = _state(request)
    st.plane.note_received(_parse_chain(request.headers.get(HOPS_HEADER)))
    if not st.admission.cfg.enabled:
        if (bp := await _submit_backpressure(st)) is not None:
            if not st.plane.enabled:
                return bp
            return await _forward_or(
                st, request, await request.json(), bp, sync=True
            )
    body = await request.json()
    trace_id = _stamp_trace(body)
    if st.admission.cfg.enabled and \
            (bp := await _admit_submission(st, body)) is not None:
        return bp
    stats = await st.scheduler.get_queue_stats()
    if stats["active_workers"] == 0:
        # a fleet with zero live workers drains nothing: tell clients to
        # come back on the heartbeat-revival timescale, not instantly —
        # unless a peer plane can take the job right now
        return await _forward_or(
            st, request, body,
            _json_error(503, "no workers available", retry_after_s=10.0),
            sync=True,
        )
    _log_submission(st, trace_id, body, sync=True)
    row = await _make_job_row(request, body)
    row["priority"] = row["priority"] + 10
    try:
        with st.tracing.span("job.submit", trace_id=trace_id, sync=True):
            job_id = await st.store.create_job(row)
    except sqlite3.OperationalError as exc:
        return _store_unavailable(st, exc)
    st.metrics.record_store_degraded(False)
    st.bp_cache_clear()
    _flight_note(st, trace_id, "server.submitted", job_id=job_id,
                 sync=True)
    timeout = min(float(body.get("timeout_seconds") or 120.0), 300.0)
    job = await st.guarantee.wait_for_job(job_id, timeout_s=timeout)
    if job is None:
        return _json_error(404, "job vanished")
    if job["status"] != JobStatus.COMPLETED.value:
        return web.json_response(
            {"job_id": job_id, "status": job["status"], "error": job.get("error")},
            status=504 if job["status"] == JobStatus.RUNNING.value else 500,
        )
    return web.json_response(
        {"job_id": job_id, "status": job["status"], "result": job.get("result")}
    )


async def get_job(request: web.Request) -> web.Response:
    if (err := _check_api_key(request)) is not None:
        return err
    st = _state(request)
    job = await st.store.get_job(request.match_info["job_id"])
    if job is None:
        return _json_error(404, "job not found")
    return web.json_response(job)


async def cancel_job(request: web.Request) -> web.Response:
    if (err := _check_api_key(request)) is not None:
        return err
    st = _state(request)
    job_id = request.match_info["job_id"]
    job = await st.store.get_job(job_id)
    if job is None:
        return _json_error(404, "job not found")
    if job["status"] in (JobStatus.COMPLETED.value, JobStatus.FAILED.value):
        return _json_error(409, f"job already {job['status']}")
    await st.store.update_job(
        job_id, status=JobStatus.CANCELLED.value, completed_at=time.time()
    )
    wid = job.get("worker_id")
    if wid:  # free the assigned worker's capacity state
        w = await st.store.get_worker(wid)
        if w is not None and w.get("current_job_id") == job_id:
            await st.store.update_worker(
                wid, current_job_id=None, status=WorkerState.IDLE.value
            )
    if (job.get("params") or {}).get("pd_disaggregated"):
        # cancelling a PD container must not orphan its pinned stage jobs:
        # on_parent_terminal cancels queued children (a RUNNING child
        # finishes on its worker and the completion hook finds the parent
        # terminal — no-op) and releases the scheduler placement
        await st.pd_flow.on_parent_terminal(job_id)
    return web.json_response({"job_id": job_id, "status": "cancelled"})


async def nearest_direct_worker(request: web.Request) -> web.Response:
    """Direct-mode discovery: closest direct-capable idle worker
    (reference jobs.py:282-338)."""
    if (err := _check_api_key(request)) is not None:
        return err
    st = _state(request)
    client_ip = (request.headers.get("X-Forwarded-For", request.remote or "")
                 .split(",")[0].strip())
    region = request.query.get("region") or await st.geo.detect_client_region(
        client_ip
    )
    # ``exclude``: comma-separated worker ids the client just watched fail
    # (dropped stream / refused connection) — a failover reconnect must not
    # be handed straight back to the worker that died on it while the
    # heartbeat sweep is still counting down
    exclude = {
        e for e in (request.query.get("exclude") or "").split(",") if e
    }
    # batcher-backed workers serve many requests concurrently and report
    # BUSY while doing so — they stay discoverable as long as their graded
    # load shows headroom (legacy workers keep the IDLE-only contract)
    workers = await st.store.list_workers(
        status=[WorkerState.IDLE.value, WorkerState.BUSY.value]
    )
    now = time.time()
    # grade each worker's load ONCE — the filter, the score loop, and the
    # sort key all reuse it (graded_load_score json-decodes load_stats)
    headroom = {w["id"]: graded_load_score(w, now=now) for w in workers}
    cands = [
        w for w in workers
        if w.get("supports_direct") and w.get("direct_url")
        and w["id"] not in exclude
        and (w.get("status") == WorkerState.IDLE.value
             or headroom[w["id"]] > 0.0)
    ]
    if not cands:
        return _json_error(404, "no direct workers available")
    if st.health.enabled:
        # gray-failure defense: quarantined workers drop out of the
        # ranking (they still heartbeat, still serve /kv/export pulls,
        # still finish in-flight work). admissible() falls back to the
        # unfiltered list rather than answering 404 — availability beats
        # purity. Disabled (default): this block never runs and the
        # ranking below is byte-identical to the pre-health build.
        allowed = set(st.health.admissible([w["id"] for w in cands]))
        cands = [w for w in cands if w["id"] in allowed]
    # cache-aware routing: ``prefix_fps`` (comma-separated boundary
    # fingerprints, SDK-computed) ranks workers by advertised prefix
    # affinity — load-headroom-scaled so a hot cached replica spills over —
    # with region distance as the tiebreak. Advisory: no fingerprints (or
    # routing disabled) keeps the pure region sort.
    fps = sanitize_fingerprints(
        [s for s in (request.query.get("prefix_fps") or "").split(",") if s],
        st.routing.max_fps_per_request,
    )
    if fps and st.routing.enabled and st.routing.replicate:
        # proactive replication: every fingerprinted discovery feeds the
        # prefix heat tracker (bounded, lock-scoped; gated here so the
        # off path costs nothing)
        st.replication.note_query(fps, now=now)
    affinity = {}
    score = {}
    if fps and st.routing.enabled:
        await st.prefix_registry.ensure_loaded(st.store)
        cfg = st.routing
        floor = max(0.0, min(1.0, cfg.min_headroom_factor))
        for w in cands:
            raw = st.prefix_registry.affinity(w["id"], fps, now=now)
            head = headroom[w["id"]]
            affinity[w["id"]] = raw * (floor + (1.0 - floor) * head)
            # same term balance as SmartScheduler.score_worker (bonus vs
            # load vs region): the floored bonus of a SATURATED cached
            # worker stays below an idle cold worker's load term
            # (spillover is strict), and keeping the region WEIGHT in the
            # score means a zero-affinity request never crosses regions
            # over a mere load-headroom delta
            region_score = 1.0 - region_distance(
                region, w.get("region")) / _MAX_DISTANCE
            score[w["id"]] = (
                cfg.affinity_weight * affinity[w["id"]]
                + WEIGHTS["load"] * head
                + WEIGHTS["region"] * region_score
            )
    cands.sort(key=lambda w: (
        -score.get(w["id"], 0.0),
        region_distance(region, w.get("region")),
        -headroom[w["id"]],
        # reliability's measured avg latency as the LAST tiebreak: when
        # score, region, and headroom all tie, the historically faster
        # worker wins — the legacy reliability signal and the health
        # score agree on one surface. Workers with no history (0.0) tie,
        # preserving the previous stable order.
        float(w.get("avg_latency_ms") or 0.0),
    ))
    best = cands[0]
    if st.health.enabled:
        # probation canary gate at SELECTION time: a probation worker may
        # win only while its bounded canary budget lasts (allow_canary
        # charges it); past budget the next-ranked candidate takes the
        # request. Healthy/suspect workers always pass.
        best = next(
            (w for w in cands if st.health.allow_canary(w["id"])), best
        )
    migrate_hint: Optional[Dict[str, Any]] = None
    route_choice: Optional[str] = None
    route_decision: Optional[Dict[str, Any]] = None
    if fps and st.routing.enabled and st.routing.kv_migrate:
        # cluster-wide KV migration: a per-request cost model
        # decides route-to-warm / migrate-KV / recompute instead of
        # letting a saturated warm worker's cached KV go to waste. The
        # flag OFF keeps this whole block out — byte-identical affinity
        # routing for the A/B.
        # source eligibility ≠ placement eligibility: a FULLY saturated
        # BUSY warm worker drops out of ``cands`` (it cannot take the
        # request) but its data plane can still SERVE the pull — which is
        # the storm scenario migration exists for. Sources come from every
        # live worker (minus client-excluded ones); placement stays cands.
        placeable = {w["id"] for w in cands}
        sources = {w["id"]: w for w in workers if w["id"] not in exclude}
        warm_id, warm_blocks, warm_tier = st.prefix_registry.best_match(
            list(sources), fps, now=now,
        )
        choice = "recompute"
        if warm_id is not None and warm_blocks > 0:
            # self-calibration: measured per-worker prefill rate, queue
            # wait, and handoff bandwidth replace the static priors when
            # routing.calibrate is on (every accessor returns None while
            # off or below min_samples — decide_kv_route then uses the
            # configured prior, byte-identical to the uncalibrated build)
            cal = st.calibration
            route_decision = decision = decide_kv_route(
                st.routing, request_blocks=len(fps),
                matched_blocks=warm_blocks, tier=warm_tier,
                warm_headroom=headroom[warm_id],
                cold_headroom=headroom[best["id"]],
                warm_is_cold=warm_id == best["id"],
                warm_prefill_tps=cal.prefill_tps(warm_id),
                cold_prefill_tps=cal.prefill_tps(best["id"]),
                warm_queue_wait_s=cal.queue_wait_s(warm_id),
                cold_queue_wait_s=cal.queue_wait_s(best["id"]),
                migrate_bandwidth=cal.bandwidth(best["id"], warm_tier),
                # a cold worker already running its pull budget is NOT
                # idle for one more: each hinted-but-unexpired pull adds
                # one queued transfer to the migrate estimate
                cold_inflight_pulls=st.migrate_hints.inflight(best["id"]),
            )
            choice = decision["choice"]
            costs = decision["costs"]
            if choice == "warm" and warm_id not in placeable:
                # the warm worker cannot take the request itself:
                # re-arbitrate the two remaining options
                choice = ("migrate"
                          if warm_blocks >= st.routing.migrate_min_blocks
                          and costs["migrate"] <= costs["recompute"]
                          else "recompute")
            if choice == "migrate" and \
                    not sources[warm_id].get("data_plane_url"):
                # the warm peer cannot serve a pull (no data plane):
                # re-arbitrate between the two feasible options rather
                # than hard-falling to recompute past a cheaper warm route
                choice = ("warm" if warm_id in placeable
                          and costs["warm"] <= costs["recompute"]
                          else "recompute")
            if choice == "warm":
                best = sources[warm_id]
            elif choice == "migrate":
                # the request runs on the score-best (cold) worker, which
                # pulls the prefix from the warm peer before admission
                migrate_hint = {
                    "worker_id": warm_id,
                    "data_plane_url": sources[warm_id]["data_plane_url"],
                    "matched_blocks": warm_blocks,
                    "tier": warm_tier,
                }
                st.migrate_hints.note(best["id"], now=now)
        st.metrics.record_kv_route_decision("direct", choice)
        route_choice = choice
    # direct-path requests never pass complete_job: a client that wants
    # the route decision on its timeline sends its trace_id with the
    # discovery query (the SDK/bench do) — the worker-side events arrive
    # through the heartbeat flight channel instead
    _flight_note(st, request.query.get("trace_id"), "server.route",
                 **route_flight_attrs(route_choice or "direct",
                                      route_decision,
                                      worker_id=best["id"]))
    if fps and st.routing.enabled:
        chosen_raw = st.prefix_registry.affinity(best["id"], fps, now=now)
        best_raw = st.prefix_registry.best_affinity_among(
            [w["id"] for w in cands], fps, now=now,
        )
        st.metrics.record_prefix_route(
            "direct", hit=chosen_raw > 0.0, spillover=best_raw > chosen_raw,
        )
    hedge_hint: Optional[Dict[str, Any]] = None
    if st.health.enabled and st.health.cfg.hedge \
            and request.query.get("hedge"):
        # hedged dispatch: a deadline-carrying client asked
        # for a backup — hand it the best-ranked DIFFERENT worker plus
        # the p95-derived fire delay. Both switches (health + hedge) and
        # the client's opt-in must agree, so the response is
        # byte-identical whenever any of the three is off.
        alt = next(
            (w for w in cands
             if w["id"] != best["id"] and st.health.allow_canary(w["id"])),
            None,
        )
        if alt is not None:
            hedge_hint = {
                "worker_id": alt["id"],
                "direct_url": alt["direct_url"],
                "delay_ms": round(st.health.hedge_delay_ms(), 1),
            }
            st.metrics.record_hedge("offered")
    return web.json_response(
        {
            "worker_id": best["id"],
            "direct_url": best["direct_url"],
            "region": best["region"],
            "client_region": region,
            **({"prefix_affinity": round(affinity.get(best["id"], 0.0), 4)}
               if affinity else {}),
            **({"kv_migrate": migrate_hint} if migrate_hint else {}),
            **({"hedge": hedge_hint} if hedge_hint else {}),
        }
    )


async def queue_stats(request: web.Request) -> web.Response:
    st = _state(request)
    return web.json_response(await st.scheduler.get_queue_stats())


# ---------------------------------------------------------------------------
# debug API: request flight recorder
# ---------------------------------------------------------------------------


async def debug_request_timeline(request: web.Request) -> web.Response:
    """Merged per-request timeline: server admission/route/claim/complete
    events + worker-side events (batcher, PD handoff from BOTH workers,
    kv-migration pulls), causally ordered, with the derived phase
    durations. The path segment accepts a job id (PD stage children
    resolve to the parent's trace) or a raw trace id; after a plane
    restart the completion-time snapshot persisted on the job row
    answers instead."""
    if (err := _check_api_key(request)) is not None:
        return err
    st = _state(request)
    ref = request.match_info["job_id"]
    tl = st.flight.timeline_for_job(ref) or st.flight.timeline(ref)
    if tl is not None:
        return web.json_response({"job_id": ref, **tl})
    job = await st.store.get_job(ref)
    if job is not None and isinstance(job.get("timeline"), dict):
        return web.json_response(
            {"job_id": ref, "stored": True, **job["timeline"]}
        )
    if job is not None and isinstance(job.get("params"), dict) \
            and job["params"].get("trace_id"):
        stored = st.flight.timeline(job["params"]["trace_id"])
        if stored is not None:
            return web.json_response({"job_id": ref, **stored})
    return _json_error(404, f"no timeline recorded for {ref}")


async def debug_slowest_requests(request: web.Request) -> web.Response:
    """Per-phase exemplar rings: the N slowest traces seen per phase
    (ring-buffered, slowest first) — the index from a histogram-tail
    alert to the concrete requests behind it."""
    if (err := _check_api_key(request)) is not None:
        return err
    st = _state(request)
    return web.json_response({
        "exemplars": st.flight.slowest(),
        "stats": dict(st.flight.stats),
    })


# ---------------------------------------------------------------------------
# admin API
# ---------------------------------------------------------------------------


async def admin_page(request: web.Request) -> web.Response:
    """Static admin SPA (reference serves server/static/admin/index.html —
    admin.py:75-87). Data calls authenticate with X-Admin-Key client-side."""
    import pathlib

    page = pathlib.Path(__file__).parent / "static" / "admin.html"
    return web.Response(text=page.read_text(), content_type="text/html")


async def admin_dashboard(request: web.Request) -> web.Response:
    if (err := _check_admin_key(request)) is not None:
        return err
    st = _state(request)
    stats = await st.store.queue_stats()
    usage = await st.usage.platform_stats()
    st.metrics.record_worker_counts(stats.get("workers", {}))
    return web.json_response(
        {
            "uptime_s": time.time() - st.started_at,
            "queue": stats,
            "usage": usage,
            "audit_recent": [
                {"ts": e.ts, "event": e.event, "actor": e.actor}
                for e in st.security.audit.recent(20)
            ],
        }
    )


async def admin_create_enterprise(request: web.Request) -> web.Response:
    if (err := _check_admin_key(request)) is not None:
        return err
    st = _state(request)
    body = await request.json()
    ent_id = await st.store.insert(
        "enterprises",
        {
            "name": body["name"],
            "contact_email": body.get("contact_email"),
            "custom_pricing": body.get("custom_pricing"),
            "price_plan_id": body.get("price_plan_id"),
            "allow_logging": int(body.get("allow_logging", True)),
            "retention_days": int(body.get("retention_days", 30)),
            "anonymize_data": int(body.get("anonymize_data", False)),
            "encrypt_fields": int(body.get("encrypt_fields", False)),
        },
    )
    return web.json_response({"enterprise_id": ent_id}, status=201)


async def admin_create_api_key(request: web.Request) -> web.Response:
    if (err := _check_admin_key(request)) is not None:
        return err
    st = _state(request)
    ent_id = request.match_info["enterprise_id"]
    from .security import generate_token, hash_token

    raw = generate_token()
    key_id = await st.store.insert(
        "api_keys",
        {
            "enterprise_id": ent_id,
            "key_hash": hash_token(raw),
            "name": (await request.json()).get("name") if request.can_read_body else None,
        },
    )
    return web.json_response({"api_key_id": key_id, "api_key": raw}, status=201)


async def admin_usage_summary(request: web.Request) -> web.Response:
    if (err := _check_admin_key(request)) is not None:
        return err
    st = _state(request)
    ent = request.query.get("enterprise_id")
    return web.json_response({"hourly": await st.usage.hourly_summary(ent)})


async def admin_generate_bill(request: web.Request) -> web.Response:
    if (err := _check_admin_key(request)) is not None:
        return err
    st = _state(request)
    body = await request.json()
    bill = await st.usage.generate_bill(
        request.match_info["enterprise_id"],
        float(body["period_start"]),
        float(body["period_end"]),
    )
    return web.json_response(bill, status=201)


async def admin_compliance(request: web.Request) -> web.Response:
    if (err := _check_admin_key(request)) is not None:
        return err
    st = _state(request)
    return web.json_response(await st.privacy.compliance_report())


async def admin_push_config(request: web.Request) -> web.Response:
    if (err := _check_admin_key(request)) is not None:
        return err
    st = _state(request)
    cfg = await st.worker_config.update_config(
        request.match_info["worker_id"], await request.json()
    )
    return web.json_response(cfg.to_dict())


async def admin_get_routing(request: web.Request) -> web.Response:
    if (err := _check_admin_key(request)) is not None:
        return err
    st = _state(request)
    # configured priors + what calibration has MEASURED, side by side:
    # the operator's predicted_vs_measured view of the cost model, plus
    # the replication planner's heat/hint counters
    return web.json_response({
        **st.routing.to_dict(),
        "calibration": st.calibration.snapshot(),
        "replication": st.replication.snapshot(),
    })


async def admin_put_routing(request: web.Request) -> web.Response:
    """Live routing A/B switch: flips/retunes the cache-aware routing
    knobs on the RUNNING control plane (no restart, no worker involvement
    — summaries keep flowing either way, only the scoring term reads the
    flag). ``block_chars`` is intentionally NOT pushable: changing the
    fingerprint basis requires a coordinated fleet restart.

    ``calibrate_reset: true`` (an action, not a stored knob) freezes the
    cost model back to the configured priors by dropping every learned
    estimate — combined with ``calibrate: false`` it is the hard half of
    the calibration A/B switch."""
    if (err := _check_admin_key(request)) is not None:
        return err
    st = _state(request)
    body = await request.json()
    if not isinstance(body, dict):
        return _json_error(400, "body must be a JSON object")
    reset = bool(body.pop("calibrate_reset", False))
    try:
        st.routing.update(body)
    except (TypeError, ValueError) as exc:
        return _json_error(400, f"bad routing config: {exc}")
    if reset:
        st.calibration.reset()
    await st.store.audit("admin_update_routing", actor="admin",
                         detail=st.routing.to_dict())
    return web.json_response({
        **st.routing.to_dict(),
        "calibration": st.calibration.snapshot(),
        "replication": st.replication.snapshot(),
    })


async def admin_get_health(request: web.Request) -> web.Response:
    if (err := _check_admin_key(request)) is not None:
        return err
    st = _state(request)
    st.health.evaluate()
    return web.json_response({
        **st.health.cfg.to_dict(),
        "snapshot": st.health.snapshot(),
    })


async def admin_put_health(request: web.Request) -> web.Response:
    """Live gray-failure A/B switch: flips/retunes health scoring,
    quarantine thresholds, and hedging on the RUNNING control plane (no
    restart, no worker involvement — workers ship the same telemetry
    either way, only the scoring/ranking paths read the flags). Same
    contract as the routing endpoint: a bad field 400s without
    half-applying."""
    if (err := _check_admin_key(request)) is not None:
        return err
    st = _state(request)
    body = await request.json()
    if not isinstance(body, dict):
        return _json_error(400, "body must be a JSON object")
    try:
        st.health.cfg.update(body)
    except (TypeError, ValueError) as exc:
        return _json_error(400, f"bad health config: {exc}")
    await st.store.audit("admin_update_health", actor="admin",
                         detail=st.health.cfg.to_dict())
    return web.json_response(st.health.cfg.to_dict())


async def admin_get_admission(request: web.Request) -> web.Response:
    if (err := _check_admin_key(request)) is not None:
        return err
    st = _state(request)
    return web.json_response({
        **st.admission.cfg.to_dict(),
        "snapshot": st.admission.snapshot(),
    })


async def admin_put_admission(request: web.Request) -> web.Response:
    """Live overload-control switch: flips/retunes the admission ladder on
    the RUNNING control plane (no restart, no worker involvement — only
    the submission path reads the config). Same contract as the routing
    A/B endpoint: a bad field 400s without half-applying."""
    if (err := _check_admin_key(request)) is not None:
        return err
    st = _state(request)
    body = await request.json()
    if not isinstance(body, dict):
        return _json_error(400, "body must be a JSON object")
    try:
        st.admission.cfg.update(body)
    except (TypeError, ValueError) as exc:
        return _json_error(400, f"bad admission config: {exc}")
    await st.store.audit("admin_update_admission", actor="admin",
                         detail=st.admission.cfg.to_dict())
    return web.json_response(st.admission.cfg.to_dict())


async def admin_realtime(request: web.Request) -> web.Response:
    """Realtime fleet stats (reference admin.py:74-141): worker states by
    region, queue depths, jobs completed/failed in the last hour."""
    if (err := _check_admin_key(request)) is not None:
        return err
    st = _state(request)
    stats = await st.store.queue_stats()
    workers = await st.store.list_workers()
    by_region: Dict[str, Dict[str, int]] = {}
    for w in workers:
        r = by_region.setdefault(w.get("region") or "unknown",
                                 {"online": 0, "busy": 0, "offline": 0})
        r[w.get("status", "offline")] = r.get(w.get("status", "offline"), 0) + 1
    hour_ago = time.time() - 3600.0
    recent = await st.store.query(
        "SELECT status, COUNT(*) AS n FROM jobs "
        "WHERE completed_at >= ? GROUP BY status", (hour_ago,),
    )
    return web.json_response(
        {
            "ts": time.time(),
            "queue": stats,
            "workers_by_region": by_region,
            "jobs_last_hour": {r["status"]: r["n"] for r in recent},
        }
    )


async def admin_list_workers(request: web.Request) -> web.Response:
    if (err := _check_admin_key(request)) is not None:
        return err
    st = _state(request)
    workers = await st.store.list_workers()
    out = []
    for w in workers:
        out.append({
            "id": w["id"], "name": w.get("name"),
            "region": w.get("region"), "status": w.get("status"),
            "current_job_id": w.get("current_job_id"),
            "reliability_score": w.get("reliability_score"),
            "total_jobs": w.get("total_jobs"),
            "completed_jobs": w.get("completed_jobs"),
            "failed_jobs": w.get("failed_jobs"),
            "last_heartbeat": w.get("last_heartbeat"),
            "supported_types": w.get("supported_types"),
            "loaded_models": w.get("loaded_models"),
            "config_version": w.get("config_version"),
        })
    return web.json_response({"workers": out})


async def admin_worker_detail(request: web.Request) -> web.Response:
    if (err := _check_admin_key(request)) is not None:
        return err
    st = _state(request)
    w = await st.store.get_worker(request.match_info["worker_id"])
    if w is None:
        return _json_error(404, "worker not found")
    w.pop("auth_token_hash", None)
    w.pop("refresh_token_hash", None)
    w.pop("signing_secret", None)
    w["predicted_online_probability"] = \
        st.reliability.predict_online_probability(w)
    return web.json_response(w)


async def admin_worker_force_offline(request: web.Request) -> web.Response:
    """Admin action: mark a worker offline and requeue its running jobs
    (reference worker admin actions, admin.py:172-320)."""
    if (err := _check_admin_key(request)) is not None:
        return err
    st = _state(request)
    wid = request.match_info["worker_id"]
    if await st.store.get_worker(wid) is None:
        return _json_error(404, "worker not found")
    requeued = await st.guarantee.handle_worker_offline(
        wid, graceful=False
    )
    await st.store.audit("admin_force_offline", actor="admin",
                         detail={"worker_id": wid})
    return web.json_response({"status": "offline", "requeued": requeued})


async def admin_worker_delete(request: web.Request) -> web.Response:
    if (err := _check_admin_key(request)) is not None:
        return err
    st = _state(request)
    wid = request.match_info["worker_id"]
    if await st.store.get_worker(wid) is None:
        return _json_error(404, "worker not found")
    # handle_worker_offline's on_worker_offline hook already invalidates
    # the registry entry and deletes the persisted summary row (counted)
    await st.guarantee.handle_worker_offline(wid, graceful=False)
    await st.store.delete_worker(wid)
    # clean death supersedes gray state: drop any quarantine record so a
    # re-registered worker with the same id starts healthy
    st.health.forget(wid)
    await st.store.audit("admin_delete_worker", actor="admin",
                         detail={"worker_id": wid})
    return web.json_response({"status": "deleted"})


async def admin_list_enterprises(request: web.Request) -> web.Response:
    if (err := _check_admin_key(request)) is not None:
        return err
    st = _state(request)
    rows = await st.store.query(
        "SELECT e.*, (SELECT COUNT(*) FROM api_keys k "
        " WHERE k.enterprise_id = e.id AND k.active = 1) AS active_keys "
        "FROM enterprises e ORDER BY e.created_at DESC"
    )
    return web.json_response({"enterprises": rows})


async def admin_get_enterprise(request: web.Request) -> web.Response:
    if (err := _check_admin_key(request)) is not None:
        return err
    st = _state(request)
    ent = await st.store.get("enterprises",
                             request.match_info["enterprise_id"])
    if ent is None:
        return _json_error(404, "enterprise not found")
    return web.json_response(ent)


_ENTERPRISE_FIELDS = (
    "name", "contact_email", "custom_pricing", "price_plan_id",
    "allow_logging", "retention_days", "anonymize_data", "encrypt_fields",
)


async def admin_update_enterprise(request: web.Request) -> web.Response:
    if (err := _check_admin_key(request)) is not None:
        return err
    st = _state(request)
    ent_id = request.match_info["enterprise_id"]
    if await st.store.get("enterprises", ent_id) is None:
        return _json_error(404, "enterprise not found")
    body = await request.json()
    fields = {k: body[k] for k in _ENTERPRISE_FIELDS if k in body}
    if not fields:
        return _json_error(400, "no updatable fields given")
    sets = ", ".join(f"{k} = ?" for k in fields)
    import json as _json

    vals = [
        _json.dumps(v) if isinstance(v, (dict, list)) else v
        for v in fields.values()
    ]
    await st.store.execute(
        f"UPDATE enterprises SET {sets} WHERE id = ?", (*vals, ent_id)
    )
    await st.store.audit("admin_update_enterprise", actor="admin",
                         detail={"enterprise_id": ent_id,
                                 "fields": sorted(fields)})
    return web.json_response(await st.store.get("enterprises", ent_id))


async def admin_delete_enterprise(request: web.Request) -> web.Response:
    """Delete an enterprise AND its data (jobs/usage/bills/keys) — the
    reference's enterprise offboarding path."""
    if (err := _check_admin_key(request)) is not None:
        return err
    st = _state(request)
    ent_id = request.match_info["enterprise_id"]
    if await st.store.get("enterprises", ent_id) is None:
        return _json_error(404, "enterprise not found")
    purged = await st.privacy.delete_enterprise_data(ent_id)
    await st.store.execute("DELETE FROM api_keys WHERE enterprise_id = ?",
                           (ent_id,))
    await st.store.execute("DELETE FROM enterprises WHERE id = ?", (ent_id,))
    await st.store.audit("admin_delete_enterprise", actor="admin",
                         detail={"enterprise_id": ent_id})
    return web.json_response({"status": "deleted", "purged": purged})


async def admin_list_api_keys(request: web.Request) -> web.Response:
    if (err := _check_admin_key(request)) is not None:
        return err
    st = _state(request)
    rows = await st.store.query(
        "SELECT id, enterprise_id, name, active, created_at, last_used_at "
        "FROM api_keys WHERE enterprise_id = ? ORDER BY created_at DESC",
        (request.match_info["enterprise_id"],),
    )
    return web.json_response({"api_keys": rows})


async def admin_revoke_api_key(request: web.Request) -> web.Response:
    if (err := _check_admin_key(request)) is not None:
        return err
    st = _state(request)
    key_id = request.match_info["key_id"]
    if await st.store.get("api_keys", key_id) is None:
        return _json_error(404, "api key not found")
    await st.store.execute("UPDATE api_keys SET active = 0 WHERE id = ?",
                           (key_id,))
    await st.store.audit("admin_revoke_api_key", actor="admin",
                         detail={"key_id": key_id})
    return web.json_response({"status": "revoked"})


async def admin_usage_records(request: web.Request) -> web.Response:
    """Raw usage records, newest first (reference admin.py:561-735)."""
    if (err := _check_admin_key(request)) is not None:
        return err
    st = _state(request)
    ent = request.query.get("enterprise_id")
    try:
        limit = int(request.query.get("limit", 100))
    except ValueError:
        return _json_error(400, "limit must be an integer")
    limit = max(0, min(limit, 1000))  # negative LIMIT = unlimited in sqlite
    if ent:
        rows = await st.store.query(
            "SELECT * FROM usage_records WHERE enterprise_id = ? "
            "ORDER BY created_at DESC LIMIT ?", (ent, limit),
        )
    else:
        rows = await st.store.query(
            "SELECT * FROM usage_records ORDER BY created_at DESC LIMIT ?",
            (limit,),
        )
    return web.json_response({"usage_records": rows})


async def admin_list_bills(request: web.Request) -> web.Response:
    if (err := _check_admin_key(request)) is not None:
        return err
    st = _state(request)
    ent = request.query.get("enterprise_id")
    if ent:
        rows = await st.store.query(
            "SELECT * FROM bills WHERE enterprise_id = ? "
            "ORDER BY created_at DESC", (ent,),
        )
    else:
        rows = await st.store.query(
            "SELECT * FROM bills ORDER BY created_at DESC LIMIT 200"
        )
    return web.json_response({"bills": rows})


_PRIVACY_FIELDS = ("allow_logging", "retention_days", "anonymize_data",
                   "encrypt_fields")


async def admin_get_privacy(request: web.Request) -> web.Response:
    if (err := _check_admin_key(request)) is not None:
        return err
    st = _state(request)
    ent = await st.store.get("enterprises",
                             request.match_info["enterprise_id"])
    if ent is None:
        return _json_error(404, "enterprise not found")
    return web.json_response({k: ent.get(k) for k in _PRIVACY_FIELDS})


async def admin_put_privacy(request: web.Request) -> web.Response:
    if (err := _check_admin_key(request)) is not None:
        return err
    st = _state(request)
    ent_id = request.match_info["enterprise_id"]
    if await st.store.get("enterprises", ent_id) is None:
        return _json_error(404, "enterprise not found")
    body = await request.json()
    fields: Dict[str, int] = {}
    for k in _PRIVACY_FIELDS:
        if k not in body:
            continue
        v = body[k]
        # the enterprise-update endpoint accepts richer shapes (e.g. a list
        # of field names for encrypt_fields); this endpoint's contract is
        # int flags/days — reject anything else with a 400, not a 500
        if isinstance(v, bool):
            v = int(v)
        if not isinstance(v, int):
            return _json_error(400, f"{k} must be an integer (got {type(v).__name__})")
        fields[k] = v
    if not fields:
        return _json_error(400, "no privacy fields given")
    sets = ", ".join(f"{k} = ?" for k in fields)
    await st.store.execute(
        f"UPDATE enterprises SET {sets} WHERE id = ?",
        (*fields.values(), ent_id),
    )
    await st.store.audit("admin_update_privacy", actor="admin",
                         detail={"enterprise_id": ent_id, **fields})
    ent = await st.store.get("enterprises", ent_id)
    return web.json_response({k: ent.get(k) for k in _PRIVACY_FIELDS})


async def admin_privacy_cleanup(request: web.Request) -> web.Response:
    """Run retention cleanup now (reference retention sweep :273-395)."""
    if (err := _check_admin_key(request)) is not None:
        return err
    st = _state(request)
    result = await st.privacy.retention.cleanup()
    await st.store.audit("admin_retention_cleanup", actor="admin",
                         detail=result)
    return web.json_response(result)


async def admin_privacy_export(request: web.Request) -> web.Response:
    if (err := _check_admin_key(request)) is not None:
        return err
    st = _state(request)
    ent_id = request.match_info["enterprise_id"]
    if await st.store.get("enterprises", ent_id) is None:
        return _json_error(404, "enterprise not found")
    return web.json_response(await st.privacy.export_enterprise_data(ent_id))


async def admin_privacy_delete_data(request: web.Request) -> web.Response:
    if (err := _check_admin_key(request)) is not None:
        return err
    st = _state(request)
    ent_id = request.match_info["enterprise_id"]
    if await st.store.get("enterprises", ent_id) is None:
        return _json_error(404, "enterprise not found")
    purged = await st.privacy.delete_enterprise_data(ent_id)
    await st.store.audit("admin_delete_enterprise_data", actor="admin",
                         detail={"enterprise_id": ent_id})
    return web.json_response({"status": "deleted", "purged": purged})


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------


async def health(request: web.Request) -> web.Response:
    st = _state(request)
    stats = await st.store.queue_stats()
    return web.json_response(
        {
            "status": "healthy",
            "uptime_s": time.time() - st.started_at,
            "workers": stats.get("workers", {}),
            "jobs": stats.get("jobs", {}),
            **({"plane": st.plane.describe()} if st.plane.enabled else {}),
        }
    )


async def regions(request: web.Request) -> web.Response:
    return web.json_response({"regions": list(REGIONS)})


async def metrics_endpoint(request: web.Request) -> web.Response:
    st = _state(request)
    # refresh summary gauges at SCRAPE time: age must keep climbing for a
    # worker that stopped advertising — the ingest-time value is ~0 by
    # construction and would hide exactly the staleness the gauge exposes
    for wid, n, age in st.prefix_registry.stats_for_metrics():
        st.metrics.record_prefix_summary(wid, n, age)
    # fleet strength at scrape time too: serving (idle/busy/draining still
    # count — a draining replica finishes its work) over every registered
    # replica. The ratio is what a brownout panel alerts on.
    stats = await st.store.queue_stats()
    w = stats.get("workers") or {}
    serving = sum(
        int(w.get(s) or 0)
        for s in (WorkerState.IDLE.value, WorkerState.BUSY.value,
                  WorkerState.DRAINING.value)
    )
    if st.health.enabled:
        # gray-failure defense: a quarantined worker is registered and
        # heartbeating but NOT taking new work — fleet strength must
        # count it degraded, not serving (dead/offline replicas alone
        # would miss it). Per-worker states refresh at
        # scrape time like the summary gauges above.
        st.health.evaluate()
        states = st.health.states()
        st.metrics.record_health_states(states)
        serving = max(0, serving - sum(
            1 for s in states.values() if s == "quarantined"
        ))
    st.metrics.record_fleet_strength(serving, sum(
        int(n or 0) for n in w.values()
    ))
    st.metrics.record_worker_counts(w)
    return web.Response(
        body=st.metrics.render(),
        content_type="text/plain",
        charset="utf-8",
    )


# ---------------------------------------------------------------------------
# app factory
# ---------------------------------------------------------------------------


@web.middleware
async def _store_degraded_middleware(request: web.Request, handler):
    """Backstop for the store-write seams the handlers don't wrap
    individually (heartbeat's update_worker, completion/release/claim
    transitions): a failed durable write surfaces as the SAME typed
    retryable 503 the submission path speaks — never a raw 500 stack
    trace. sqlite3.OperationalError is precisely the store-failure class
    (full disk, wedged file, injected chaos), so nothing else is
    masked."""
    try:
        return await handler(request)
    except sqlite3.OperationalError as exc:
        return _store_unavailable(_state(request), exc)


def create_app(state: Optional[ServerState] = None,
               start_background: bool = True) -> web.Application:
    app = web.Application(middlewares=[_store_degraded_middleware])
    app["state"] = state or ServerState()

    app.router.add_post(f"{API}/workers/register", register_worker)
    app.router.add_post(f"{API}/workers/{{worker_id}}/heartbeat", heartbeat)
    app.router.add_get(f"{API}/workers/{{worker_id}}/next-job", next_job)
    app.router.add_post(
        f"{API}/workers/{{worker_id}}/jobs/{{job_id}}/complete", complete_job
    )
    app.router.add_post(
        f"{API}/workers/{{worker_id}}/jobs/{{job_id}}/release", release_job
    )
    app.router.add_post(
        f"{API}/workers/{{worker_id}}/jobs/{{job_id}}/checkpoint",
        checkpoint_job,
    )
    app.router.add_post(
        f"{API}/workers/{{worker_id}}/streams/{{stream_id}}/checkpoint",
        checkpoint_stream,
    )
    app.router.add_post(
        f"{API}/workers/{{worker_id}}/streams/{{stream_id}}/adopt",
        adopt_stream,
    )
    app.router.add_post(f"{API}/workers/{{worker_id}}/going-offline", going_offline)
    app.router.add_post(f"{API}/workers/{{worker_id}}/offline", offline)
    app.router.add_post(f"{API}/workers/{{worker_id}}/verify", verify_worker)
    app.router.add_post(f"{API}/workers/{{worker_id}}/refresh-token", refresh_token)
    app.router.add_get(f"{API}/workers/{{worker_id}}/config", get_worker_config)
    app.router.add_put(f"{API}/workers/{{worker_id}}/config", put_worker_config)
    app.router.add_get(f"{API}/workers", list_workers)
    app.router.add_get(f"{API}/workers/{{worker_id}}", worker_detail)

    app.router.add_post(f"{API}/jobs", create_job)
    app.router.add_post(f"{API}/jobs/sync", create_job_sync)
    app.router.add_get(f"{API}/jobs/direct/nearest", nearest_direct_worker)
    app.router.add_get(f"{API}/jobs/stats/queue", queue_stats)
    app.router.add_get(f"{API}/jobs/{{job_id}}", get_job)
    app.router.add_delete(f"{API}/jobs/{{job_id}}", cancel_job)

    # static path FIRST (routes match in registration order): /slowest
    # must not be swallowed by the {job_id} route
    app.router.add_get(f"{API}/debug/requests/slowest",
                       debug_slowest_requests)
    app.router.add_get(f"{API}/debug/requests/{{job_id}}/timeline",
                       debug_request_timeline)

    app.router.add_get(f"{API}/admin/stats/dashboard", admin_dashboard)
    app.router.add_get(f"{API}/admin/stats/realtime", admin_realtime)
    app.router.add_get(f"{API}/admin/routing", admin_get_routing)
    app.router.add_put(f"{API}/admin/routing", admin_put_routing)
    app.router.add_get(f"{API}/admin/admission", admin_get_admission)
    app.router.add_put(f"{API}/admin/admission", admin_put_admission)
    app.router.add_get(f"{API}/admin/health", admin_get_health)
    app.router.add_put(f"{API}/admin/health", admin_put_health)
    app.router.add_get(f"{API}/admin/workers", admin_list_workers)
    app.router.add_get(f"{API}/admin/workers/{{worker_id}}",
                       admin_worker_detail)
    app.router.add_post(f"{API}/admin/workers/{{worker_id}}/offline",
                        admin_worker_force_offline)
    app.router.add_delete(f"{API}/admin/workers/{{worker_id}}",
                          admin_worker_delete)
    app.router.add_get(f"{API}/admin/enterprises", admin_list_enterprises)
    app.router.add_get(f"{API}/admin/enterprises/{{enterprise_id}}",
                       admin_get_enterprise)
    app.router.add_put(f"{API}/admin/enterprises/{{enterprise_id}}",
                       admin_update_enterprise)
    app.router.add_delete(f"{API}/admin/enterprises/{{enterprise_id}}",
                          admin_delete_enterprise)
    app.router.add_get(f"{API}/admin/enterprises/{{enterprise_id}}/api-keys",
                       admin_list_api_keys)
    app.router.add_delete(f"{API}/admin/api-keys/{{key_id}}",
                          admin_revoke_api_key)
    app.router.add_get(f"{API}/admin/usage/records", admin_usage_records)
    app.router.add_get(f"{API}/admin/bills", admin_list_bills)
    # static privacy paths FIRST: routes match in registration order and
    # /privacy/{enterprise_id} would otherwise swallow /privacy/compliance
    app.router.add_post(f"{API}/admin/privacy/cleanup",
                        admin_privacy_cleanup)
    app.router.add_get(f"{API}/admin/privacy/compliance", admin_compliance)
    app.router.add_get(f"{API}/admin/privacy/export/{{enterprise_id}}",
                       admin_privacy_export)
    app.router.add_delete(f"{API}/admin/privacy/data/{{enterprise_id}}",
                          admin_privacy_delete_data)
    app.router.add_get(f"{API}/admin/privacy/{{enterprise_id}}",
                       admin_get_privacy)
    app.router.add_put(f"{API}/admin/privacy/{{enterprise_id}}",
                       admin_put_privacy)
    app.router.add_post(f"{API}/admin/enterprises", admin_create_enterprise)
    app.router.add_post(
        f"{API}/admin/enterprises/{{enterprise_id}}/api-keys", admin_create_api_key
    )
    app.router.add_post(
        f"{API}/admin/enterprises/{{enterprise_id}}/bills", admin_generate_bill
    )
    app.router.add_get(f"{API}/admin/usage/summary", admin_usage_summary)
    app.router.add_put(
        f"{API}/admin/workers/{{worker_id}}/config", admin_push_config
    )

    app.router.add_get("/health", health)
    app.router.add_get("/regions", regions)
    app.router.add_get("/metrics", metrics_endpoint)
    app.router.add_get("/admin", admin_page)

    if start_background:
        async def _on_startup(app: web.Application) -> None:
            app["state"].background.start()

        async def _on_cleanup(app: web.Application) -> None:
            await app["state"].background.stop()

        app.on_startup.append(_on_startup)
        app.on_cleanup.append(_on_cleanup)

    async def _on_plane_cleanup(app: web.Application) -> None:
        await app["state"].plane.close()

    app.on_cleanup.append(_on_plane_cleanup)
    return app


def main() -> None:  # pragma: no cover - manual entry point
    import argparse

    ap = argparse.ArgumentParser(description="dgi-torch control plane")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--db", default="dgi_tpu.sqlite")
    ap.add_argument("--api-key", default=None)
    ap.add_argument("--submit-queue-limit", type=int, default=0,
                    help="reject job submissions with 429 + Retry-After "
                         "past this queue depth (0 = unlimited)")
    ap.add_argument("--plane-id",
                    default=os.environ.get("DGI_PLANE_ID") or None,
                    help="this control-plane replica's identity in a "
                         "multi-plane cohort (enables the cohort; claims "
                         "are stamped with it)")
    ap.add_argument("--plane-peers",
                    default=os.environ.get("DGI_PLANE_PEERS") or "",
                    help="comma-separated peer plane base URLs for job "
                         "forwarding (all replicas must share --db)")
    ap.add_argument("--heartbeat-timeout-s", type=float, default=90.0,
                    help="a worker whose last heartbeat is older is swept "
                         "offline and its running jobs requeued")
    ap.add_argument("--sweep-interval-s", type=float, default=SWEEP_INTERVAL_S,
                    help="seconds between the background guarantee sweeps")
    args = ap.parse_args()
    peers = [p.strip() for p in str(args.plane_peers).split(",") if p.strip()]
    state = ServerState(db_path=args.db, api_key=args.api_key,
                        submit_queue_limit=args.submit_queue_limit,
                        plane_id=args.plane_id, plane_peers=peers or None,
                        heartbeat_timeout_s=args.heartbeat_timeout_s)
    state.background = TaskGuaranteeBackgroundWorker(
        state.guarantee, interval_s=args.sweep_interval_s)
    # port 0 draws a free port: the banner names the one bound
    web.run_app(create_app(state), host=args.host, port=args.port)


if __name__ == "__main__":  # pragma: no cover
    main()
