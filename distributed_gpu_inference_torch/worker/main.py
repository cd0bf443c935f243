"""Worker runtime: register → load engines → heartbeat + poll → process jobs.

The port of ``distributed_gpu_inference_tpu/worker/main.py`` ``Worker``,
speaking the JAX control plane's wire protocol unchanged:

- ``register`` — verify persisted credentials first, register (with the
  machine fingerprint, topology and a per-process ``boot_id``) when they
  are stale, then fetch the server-pushed remote config;
- ``load_engines`` — one engine per task type from the registry
  (``worker/engines``); a type whose engine cannot load is dropped;
- ``_heartbeat_once`` — batcher stats with ``capacity``, KV-pressure
  counters, spill-tier IO health (``kv_spill``), the flight recorder's
  counters and recent timelines (``flight``), the direct server's wire
  stats, the radix prefix summary
  (ack / resync / disable, and a resync when a different plane answers),
  live checkpoints, ``active_job_ids`` and the previous beat's round trip;
  ``config_changed`` refetches the remote config, a 401 refreshes the token
  and re-registers when that fails;
- ``_poll_once`` — load-control gates before claiming, then a shared
  serving claim per job on the batcher-backed engine (several jobs decode
  in one batch) or the exclusive claim;
- ``process_job`` — reserved keys scrubbed, the poll-pickup instant
  stamped for a traced job (``trace_id``), the failover context handed to
  the engine, ``JobMigrated`` pushed back as ``checkpoint(migrate=True)``,
  completions fenced by the assignment epoch, claims released on shutdown;
- ``request_shutdown`` — graceful drain: in-flight jobs migrate, the server
  is told ``going-offline`` then ``offline``, engines unload.

The port serves one CUDA card: ``probe_topology`` reads it through
``torch.cuda``. Prefill/decode disaggregation: the ``role`` (``hybrid``,
``prefill`` or ``decode``) and ``pd_data_plane_url`` ride the
registration; with a ``pd_data_plane_url`` and an llm engine the worker
runs the KV data plane (``comm/data_plane.py``: ``/kv/transfer`` into the
engine's ``kv_receiver``, ``/kv/export`` into ``kv_export``) on that URL's
port. Each heartbeat runs the engines' ``pd_maintain`` first and carries
the JAX worker's blocks: the speculation counters (``_spec_engine_stats``),
``engine_stats["pd"]``, ``engine_stats["kv_migrate"]`` and
``kv_handoff_sessions_purged``; a response's ``kv_replicate`` hints go to
the first engine that takes them.
"""

from __future__ import annotations

import logging
import random
import signal
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional

from distributed_gpu_inference_torch.utils.config import WorkerConfig, config_dict
from distributed_gpu_inference_torch.utils.data_structures import (
    TpuTopology,
    WorkerState,
)
from distributed_gpu_inference_torch.worker.api_client import APIClient, APIError
from distributed_gpu_inference_torch.worker.engines import (
    EngineLoadError,
    create_engine,
)
from distributed_gpu_inference_torch.worker.engines.base import JobMigrated
from distributed_gpu_inference_torch.worker.machine_id import MachineFingerprint

log = logging.getLogger("torch_worker")

# published figures of the cards by device-name fragment: (NVLink GB/s a
# card, dense bf16 tensor TFLOP/s); a card not listed reports 0.0 for both
_CUDA_CARDS = (
    ("H100 80GB HBM3", (900.0, 989.0)),      # H100 SXM5
    ("H100 SXM", (900.0, 989.0)),
    ("H100 NVL", (600.0, 835.0)),
    ("H100 PCIe", (600.0, 756.0)),
)


def probe_topology() -> TpuTopology:
    """The CUDA devices the engines run on: the first device's name, the
    device count, its memory (GiB) from ``get_device_properties``, and the
    card's published NVLink and bf16 rates by name. Raises RuntimeError
    without a card: the worker never registers a made-up accelerator."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the PyTorch worker serves on a CUDA card "
            "(pass a topology to run it on the CPU)"
        )
    n = torch.cuda.device_count()
    name = torch.cuda.get_device_name(0)
    props = torch.cuda.get_device_properties(0)
    nvlink, tflops = next(
        (rates for frag, rates in _CUDA_CARDS if frag in name), (0.0, 0.0)
    )
    return TpuTopology(
        chip_type=name, num_chips=n,
        hbm_gb_per_chip=round(props.total_memory / 2**30, 2),
        mesh_shape=(n,), mesh_axis_names=("data",),
        ici_bandwidth_gbps=nvlink, peak_bf16_tflops=tflops,
    )


class Worker:
    """The fleet worker process on the PyTorch port."""

    def __init__(
        self,
        config: WorkerConfig,
        api: Optional[APIClient] = None,
        on_credentials: Optional[Callable[[Dict[str, str]], None]] = None,
        topology: Optional[TpuTopology] = None,
    ) -> None:
        self.config = config
        self.api = api or APIClient(
            # plane cohort: primary + fallbacks become the failover list
            [config.server.url, *(config.server.fallback_urls or [])],
            worker_id=config.server.worker_id,
            auth_token=config.server.auth_token,
            refresh_token=config.server.refresh_token,
            signing_secret=config.server.signing_secret,
            timeout_s=config.server.request_timeout_s,
        )
        self._on_credentials = on_credentials
        self.topology = topology or probe_topology()
        self.engines: Dict[str, Any] = {}
        self.state = WorkerState.INITIALIZING
        self.current_job_id: Optional[str] = None

        self._shutdown = threading.Event()
        self._direct: Optional[Any] = None
        # the KV data plane of a PD worker (pd_data_plane_url)
        self._pd_plane: Optional[Any] = None
        # round trip of the PREVIOUS heartbeat (ms), shipped on the next
        # beat for the plane's gray-failure health scoring
        self._hb_rtt_ms: Optional[float] = None
        # guards IDLE→BUSY transitions so the poll loop and the direct
        # server never run engine work concurrently on an exclusive claim
        self._state_lock = threading.Lock()
        # shared serving claims (batcher-backed engines): direct requests
        # and queued jobs sharing decode rounds, up to
        # load_control.max_concurrent_jobs, never with an exclusive claim
        self._serving_jobs = 0
        self._job_pool: Optional[ThreadPoolExecutor] = None
        self._job_pool_width = 16
        self._pool_inflight = 0
        self._active_jobs: set = set()
        # exclusive-needing work was fetched while shared claims ran: back
        # off from polling until this deadline instead of claim/release
        # churn on the same head-of-queue job
        self._exclusive_defer_until = 0.0
        self._heartbeat_thread: Optional[threading.Thread] = None
        self._hour_window: List[float] = []       # job-start times, rolling hour
        self._last_job_done_at = 0.0
        self._released_once: set = set()          # jobs we declined once
        self._rng = random.Random(0xC0FFEE)
        # per-PROCESS incarnation id: a new boot_id on the same fingerprint
        # tells the plane the old incarnation is dead (its RUNNING jobs
        # requeue at once); a credential-blip re-register keeps it
        self.boot_id = uuid.uuid4().hex
        # the control-plane replica that answered the last heartbeat; a
        # change means failover, and the prefix summary resyncs in full
        self._last_plane_id: Optional[str] = None
        self.stats: Dict[str, Any] = {
            "jobs_completed": 0, "jobs_failed": 0, "jobs_rejected": 0,
            "jobs_migrated": 0,
            "heartbeats": 0, "config_refetches": 0,
        }

    # -- registration --------------------------------------------------------

    def register(self) -> None:
        if self.api.worker_id and self.api.auth_token and \
                self.api.verify_credentials():
            log.info("existing credentials valid for %s", self.api.worker_id)
        else:
            info = {
                "name": self.config.name,
                "region": self.config.region,
                "machine_fingerprint": MachineFingerprint().get_or_create(),
                "supported_types": list(self.config.task_types),
                "topology": self.topology.to_dict(),
                "supports_direct": self.config.direct.enabled,
                "direct_url": self.config.direct.public_url,
                "role": self.config.role,
                "data_plane_url": self.config.pd_data_plane_url,
                "boot_id": self.boot_id,
            }
            data = self.api.register(info)
            if self._on_credentials:
                self._on_credentials({
                    "worker_id": data["worker_id"],
                    "auth_token": data["auth_token"],
                    "refresh_token": data["refresh_token"],
                    "signing_secret": data["signing_secret"],
                })
            log.info("registered as %s", data["worker_id"])
        self._fetch_remote_config()

    def _fetch_remote_config(self) -> None:
        """Server-pushed load control wins over local values; a ``serving``
        section retunes live batchers (a rejected push is logged, never
        fatal)."""
        try:
            remote = self.api.fetch_remote_config()
        except APIError as exc:
            log.warning("remote config fetch failed: %s", exc)
            return
        self.stats["config_refetches"] += 1
        self.config.config_version = int(remote.get("version", 0))
        lc = remote.get("load_control") or {}
        for key in (
            "acceptance_rate", "max_concurrent_jobs", "max_jobs_per_hour",
            "hbm_limit_fraction", "cooldown_seconds",
        ):
            if key in lc and lc[key] is not None:
                setattr(self.config.load_control, key, lc[key])
        if lc.get("working_hours"):
            self.config.load_control.working_hours = tuple(lc["working_hours"])
        if lc.get("job_type_weights"):
            self.config.load_control.job_type_weights = dict(
                lc["job_type_weights"]
            )
        serving = remote.get("serving")
        if isinstance(serving, dict) and serving:
            for eng in self.engines.values():
                apply = getattr(eng, "apply_serving_config", None)
                if apply is None:
                    continue
                try:
                    apply(dict(serving))
                except Exception:  # noqa: BLE001 — a bad push must not kill the worker
                    log.warning("serving config push rejected",
                                exc_info=True)

    # -- engines ---------------------------------------------------------------

    def load_engines(self) -> None:
        loaded: List[str] = []
        for task_type in list(self.config.task_types):
            try:
                cfg = self.config.engine_for(task_type)
                eng = create_engine(task_type, config_dict(cfg))
                eng.load_model()
                self.engines[task_type] = eng
                loaded.append(task_type)
            except (EngineLoadError, KeyError) as exc:
                log.warning("dropping task type %s: %s", task_type, exc)
        self.config.task_types = loaded
        if not loaded:
            raise EngineLoadError("no engine loaded for any task type")

    # -- heartbeat -------------------------------------------------------------

    def _spec_engine_stats(self) -> Optional[Dict[str, Any]]:
        """Speculation counters of every engine running the integrated
        speculative mode, summed, with the rates derived from the sums (so
        the gauges agree with the counters when several engines
        speculate); None when nothing speculates."""
        out: Dict[str, Any] = {}
        for eng in self.engines.values():
            core = getattr(eng, "engine", None)
            if core is None or \
                    getattr(getattr(core, "cfg", None), "speculative", None) is None:
                continue
            s = core.get_stats()
            for k in ("spec_accepted", "spec_drafted", "spec_slot_steps",
                      "spec_emitted"):
                out[k] = out.get(k, 0) + int(s.get(k, 0) or 0)
        if not out:
            return None
        out["spec_accept_rate"] = (
            out["spec_accepted"] / out["spec_drafted"]
            if out.get("spec_drafted") else 0.0
        )
        out["spec_tokens_per_step"] = (
            out["spec_emitted"] / out["spec_slot_steps"]
            if out.get("spec_slot_steps") else 0.0
        )
        return out

    def _pressure_engine_stats(self) -> Optional[Dict[str, Any]]:
        """Cumulative preemptions / resumes / pressure events of every
        loaded paged engine; None when no engine has them."""
        out: Dict[str, int] = {}
        for eng in self.engines.values():
            stats = getattr(getattr(eng, "engine", None), "stats", None)
            if isinstance(stats, dict):
                for k in ("preemptions", "resumes", "kv_pressure_events"):
                    if k in stats:
                        out[k] = out.get(k, 0) + int(stats.get(k, 0) or 0)
            # abandoned streamed-handoff sessions the engine's receiver
            # purged (kv_handoff_sessions_purged_total on the plane)
            purged = getattr(eng, "handoff_sessions_purged", None)
            if purged:
                out["kv_handoff_sessions_purged"] = (
                    out.get("kv_handoff_sessions_purged", 0) + int(purged))
        return out or None

    def _summed_engine_stats(self, name: str) -> Optional[Dict[str, Any]]:
        """The counters every loaded engine's ``name()`` returns, summed;
        None when none has any (the PD and KV-migration blocks)."""
        out: Dict[str, int] = {}
        for eng in self.engines.values():
            fn = getattr(eng, name, None)
            if fn is None:
                continue
            try:
                s = fn()
            except Exception:  # noqa: BLE001 — never break the heartbeat
                continue
            for k, v in (s or {}).items():
                out[k] = out.get(k, 0) + int(v)
        return out or None

    def _batcher_stats(self) -> Optional[Dict[str, Any]]:
        """Live batcher stats of every batcher-backed engine, with the
        shared-claim ``capacity`` the scheduler grades load against; None
        when no engine serves through a batcher."""
        out: Dict[str, Any] = {}
        for eng in self.engines.values():
            fn = getattr(eng, "serving_stats", None)
            if fn is None:
                continue
            try:
                s = fn()
            except Exception:  # noqa: BLE001 — never break the heartbeat
                continue
            if not s:
                continue
            for k in ("submitted", "completed", "rejected", "admitted",
                      "decode_rounds", "chunked_admissions",
                      "batched_waves", "preemptions", "resumes",
                      "preempted_too_often", "cancelled", "migrated",
                      "abandoned", "abandoned_predictive"):
                out[k] = out.get(k, 0) + int(s.get(k, 0) or 0)
            for k in ("queue_depth", "active_slots"):
                out[k] = out.get(k, 0) + int(s.get(k, 0) or 0)
            if s.get("avg_occupancy") is not None:
                out["avg_occupancy"] = round(
                    float(s.get("avg_occupancy") or 0.0), 3
                )
            if s.get("horizon") is not None:
                out["horizon"] = float(s["horizon"])
        if out:
            out["capacity"] = self.serving_capacity()
        return out or None

    def _kv_spill_engine_stats(self) -> Optional[Dict[str, Any]]:
        """Spill-tier IO health of every loaded engine (put/get errors,
        quarantines, breaker states and trips, refused corrupt
        checkpoints); breaker states are gauges (the sickest engine wins),
        the rest sums. None while everything is zero."""
        out: Dict[str, int] = {}
        for eng in self.engines.values():
            fn = getattr(eng, "kv_spill_wire_stats", None)
            if fn is None:
                continue
            try:
                s = fn()
            except Exception:  # noqa: BLE001 — never break the heartbeat
                continue
            for k, v in (s or {}).items():
                if k.endswith("_state"):
                    out[k] = max(out.get(k, 0), int(v))
                else:
                    out[k] = out.get(k, 0) + int(v)
        return out or None

    def _flight_engine_stats(self) -> Optional[Dict[str, Any]]:
        """Flight-recorder payload of every loaded engine: cumulative
        timeline/drop counters and the last 16 completed timelines (direct
        streams reach the plane's timeline store only this way). None when
        nothing was traced."""
        out: Dict[str, Any] = {}
        recent: List[Dict[str, Any]] = []
        for eng in self.engines.values():
            fn = getattr(eng, "flight_wire_stats", None)
            if fn is None:
                continue
            try:
                s = fn()
            except Exception:  # noqa: BLE001 — never break the heartbeat
                continue
            if not s:
                continue
            for k in ("timelines", "events_dropped"):
                out[k] = out.get(k, 0) + int(s.get(k, 0) or 0)
            r = s.get("recent")
            if isinstance(r, list):
                recent.extend(r)
        if not out:
            return None
        if recent:
            out["recent"] = recent[-16:]
        return out

    def _prefix_summary_payload(self) -> Optional[tuple]:
        """(engine, wire payload) of the first engine with a radix summary
        to ship this beat; None when every engine is in sync."""
        for eng in self.engines.values():
            fn = getattr(eng, "prefix_summary_wire", None)
            if fn is None:
                continue
            try:
                payload = fn()
            except Exception:  # noqa: BLE001 — never break the heartbeat
                continue
            if payload:
                return eng, payload
        return None

    def _collect_checkpoints(self) -> List[Dict[str, Any]]:
        """Portable checkpoints of every in-flight generation, piggybacked
        on heartbeats: the plane attaches the latest to a requeued job or
        an adoptable stream, and the next worker resumes from it."""
        out: List[Dict[str, Any]] = []
        for eng in self.engines.values():
            fn = getattr(eng, "checkpoint_live", None)
            if fn is None:
                continue
            try:
                out.extend(fn() or [])
            except Exception:  # noqa: BLE001 — never break the heartbeat
                log.debug("checkpoint collection failed", exc_info=True)
        return out

    def _heartbeat_payload(self) -> tuple:
        """(engine whose summary rides this beat or None, heartbeat
        keyword arguments)."""
        extra: Dict[str, Any] = {}
        engine_stats: Dict[str, Any] = {}
        spec = self._spec_engine_stats()
        if spec:
            engine_stats.update(spec)
        pressure = self._pressure_engine_stats()
        if pressure:
            engine_stats.update(pressure)
        batcher = self._batcher_stats()
        if batcher:
            engine_stats["batcher"] = batcher
        pd = self._summed_engine_stats("pd_wire_stats")
        if pd:
            engine_stats["pd"] = pd
        kv_spill = self._kv_spill_engine_stats()
        if kv_spill:
            engine_stats["kv_spill"] = kv_spill
        kv_migrate = self._summed_engine_stats("kv_migrate_wire_stats")
        if kv_migrate:
            engine_stats["kv_migrate"] = kv_migrate
        flight = self._flight_engine_stats()
        if flight:
            engine_stats["flight"] = flight
        direct = self._direct
        if direct is not None:
            # per-request direct latencies / 5xx / hedge cancels for the
            # plane's health scoring; omitted while empty
            try:
                ds = direct.wire_stats()
            except Exception:  # noqa: BLE001 — never break the beat
                ds = None
            if ds and (ds.get("recent_ms") or ds.get("new_errors")
                       or ds.get("hedge_cancels")):
                engine_stats["direct"] = ds
        summary_eng = None
        summary = self._prefix_summary_payload()
        if summary is not None:
            # committed as server-known only after the round trip succeeds
            summary_eng, engine_stats["prefix_summary"] = summary
        if any(getattr(eng, "prefix_hot", None) is not None
               for eng in self.engines.values()):
            # channel-alive marker: the plane keeps our summary fresh on
            # payload-less (in-sync) beats
            engine_stats["prefix_summary_live"] = True
        if engine_stats:
            extra["engine_stats"] = engine_stats
        checkpoints = self._collect_checkpoints()
        if checkpoints:
            extra["checkpoints"] = checkpoints
        with self._state_lock:
            active = list(self._active_jobs)
            current_job_id = self.current_job_id
        if len(active) > 1:
            # current_job_id carries one claim: report the full set so the
            # server's stale-claim guard covers every in-flight job
            extra["active_job_ids"] = active
        if self._hb_rtt_ms is not None:
            extra["hb_rtt_ms"] = round(self._hb_rtt_ms, 3)
        kw = dict(
            status=self.state.value,
            config_version=self.config.config_version,
            current_job_id=current_job_id,
            loaded_models=[
                getattr(e, "model_name", None) or str(type(e).__name__)
                for e in self.engines.values()
            ],
            stats={k: self.stats[k] for k in ("jobs_completed", "jobs_failed")},
            **extra,
        )
        return summary_eng, kw

    def _heartbeat_once(self) -> None:
        summary_eng = None
        for eng in self.engines.values():
            # PD housekeeping on the heartbeat cadence: adoptions whose
            # decode stage never came age out
            fn = getattr(eng, "pd_maintain", None)
            if fn is not None:
                try:
                    fn()
                except Exception:  # noqa: BLE001 — never break the beat
                    pass
        try:
            summary_eng, kw = self._heartbeat_payload()
            hb_t0 = time.perf_counter()
            resp = self.api.heartbeat(**kw)
            self._hb_rtt_ms = (time.perf_counter() - hb_t0) * 1000.0
            self.stats["heartbeats"] += 1
            if summary_eng is not None:
                if resp.get("prefix_summary_applied") is False:
                    # statically un-ingestable: stop shipping summaries
                    summary_eng.prefix_summary_disable()
                elif resp.get("prefix_summary_resync") is False:
                    summary_eng.prefix_summary_ack()
                else:
                    # asked to resync, or no answer for the payload: acking
                    # would commit a base the server does not hold
                    summary_eng.prefix_summary_resync()
                summary_eng = None
            plane_id = resp.get("plane_id")
            if isinstance(plane_id, str) and plane_id:
                if self._last_plane_id is not None \
                        and plane_id != self._last_plane_id:
                    # a different plane replica answered: it holds no ACKed
                    # base for our delta chain — resync a full snapshot
                    log.info("control plane changed (%s -> %s); resyncing "
                             "prefix summary", self._last_plane_id, plane_id)
                    self.stats["plane_failovers"] = \
                        self.stats.get("plane_failovers", 0) + 1
                    for eng in self.engines.values():
                        fn = getattr(eng, "prefix_summary_resync", None)
                        if fn is not None:
                            fn()
                self._last_plane_id = plane_id
            hints = resp.get("kv_replicate")
            if hints:
                # proactive prefix replication: the first engine that takes
                # the hints pulls them on its own thread
                for eng in self.engines.values():
                    fn = getattr(eng, "kv_replicate", None)
                    if fn is None:
                        continue
                    try:
                        if fn(hints):
                            self.stats["kv_replicate_hints"] = \
                                self.stats.get("kv_replicate_hints", 0) + len(hints)
                            break
                    except Exception:  # noqa: BLE001 — advisory prefetch
                        pass
            stale = list(resp.get("stale_jobs") or [])
            if resp.get("stale_job") and self.current_job_id:
                stale.insert(0, self.current_job_id)
            for jid in stale:
                # the server requeued a claim of ours (we looked dead): the
                # run finishes as zombie work and its completion is fenced
                log.warning("server reports job %s is no longer ours "
                            "(requeued after a heartbeat gap); finishing as "
                            "zombie work", jid)
                self.stats["stale_claims"] = \
                    self.stats.get("stale_claims", 0) + 1
            if resp.get("config_changed"):
                self._fetch_remote_config()
        except APIError as exc:
            if summary_eng is not None:
                # the beat carrying our summary delta was lost: the next
                # delta's base would be wrong — fall back to a full snapshot
                summary_eng.prefix_summary_resync()
            if exc.status == 401:
                try:
                    self.api.refresh_credentials()
                except APIError:
                    log.error("token refresh failed; re-registering")
                    self.api.auth_token = None
                    try:
                        self.register()
                    except APIError as reg_exc:
                        log.error("re-registration failed: %s", reg_exc)
            else:
                log.warning("heartbeat failed: %s", exc)

    def _heartbeat_loop(self) -> None:
        while not self._shutdown.wait(self.config.heartbeat_interval_s):
            try:
                self._heartbeat_once()
            except Exception:  # noqa: BLE001 — the thread must survive outages
                log.exception("heartbeat iteration failed")

    # -- load control ----------------------------------------------------------

    def gates_open(self, now: Optional[float] = None) -> bool:
        """Job-independent load-control gates, checked BEFORE claiming a job
        (working hours, cooldown, hourly cap, acceptance sampling)."""
        lc = self.config.load_control
        now = time.time() if now is None else now
        if lc.working_hours:
            start_h, end_h = lc.working_hours
            hour = time.localtime(now).tm_hour
            inside = (
                start_h <= hour < end_h if start_h <= end_h
                else hour >= start_h or hour < end_h
            )
            if not inside:
                return False
        if lc.cooldown_seconds > 0 and \
                now - self._last_job_done_at < lc.cooldown_seconds:
            return False
        if lc.max_jobs_per_hour > 0:
            with self._state_lock:
                # pool/direct threads append concurrently (note_job_done)
                self._hour_window = [
                    t for t in self._hour_window if now - t < 3600
                ]
                if len(self._hour_window) >= lc.max_jobs_per_hour:
                    return False
        if lc.acceptance_rate < 1.0 and self._rng.random() > lc.acceptance_rate:
            return False
        return True

    def should_accept_job(self, job: Dict[str, Any],
                          now: Optional[float] = None) -> bool:
        """Gates + per-type weight. The type throttle is one-shot per job: a
        job released once is accepted on re-encounter (no starvation)."""
        if not self.gates_open(now=now):
            return False
        lc = self.config.load_control
        job_id = job.get("id")
        if job_id and job_id in self._released_once:
            return True
        weight = lc.job_type_weights.get(job.get("type", ""), 1.0)
        if weight < 1.0 and self._rng.random() > weight:
            return False
        return True

    def note_job_done(self, started: float) -> None:
        """Load-control bookkeeping of queued AND direct jobs."""
        with self._state_lock:
            self._last_job_done_at = time.time()
            self._hour_window.append(started)

    # -- claims (poll loop vs direct server) -----------------------------------

    def try_begin_job(self) -> bool:
        """Atomically claim the worker for one EXCLUSIVE job (IDLE→BUSY);
        False when busy or draining."""
        with self._state_lock:
            if self.state != WorkerState.IDLE:
                return False
            self.state = WorkerState.BUSY
            return True

    def end_job(self) -> None:
        with self._state_lock:
            if self.state == WorkerState.BUSY:
                self.state = WorkerState.IDLE

    def serving_capacity(self) -> int:
        """Concurrent shared-claim ceiling (``load_control.
        max_concurrent_jobs``)."""
        return max(1, int(self.config.load_control.max_concurrent_jobs or 1))

    def try_begin_serving(self) -> bool:
        """Claim ONE shared serving slot on the batcher-backed engine:
        shared claims coexist up to :meth:`serving_capacity`, never with an
        exclusive claim, and a draining worker takes none."""
        with self._state_lock:
            if self.state == WorkerState.IDLE:
                self.state = WorkerState.BUSY
                self._serving_jobs = 1
                return True
            if self.state == WorkerState.BUSY and self._serving_jobs > 0 \
                    and self._serving_jobs < self.serving_capacity():
                self._serving_jobs += 1
                return True
            return False

    def end_serving(self) -> None:
        with self._state_lock:
            if self._serving_jobs > 0:
                self._serving_jobs -= 1
                if self._serving_jobs == 0 and \
                        self.state == WorkerState.BUSY:
                    self.state = WorkerState.IDLE

    def _upgrade_serving_to_exclusive(self) -> bool:
        """Turn OUR shared claim into the exclusive one — only when no
        other shared work is in flight."""
        with self._state_lock:
            if self.state == WorkerState.BUSY and self._serving_jobs == 1:
                self._serving_jobs = 0
                return True
            return False

    # -- job processing --------------------------------------------------------

    def _report_completion(self, job_id: str, success: bool,
                           result: Optional[Dict[str, Any]] = None,
                           error: Optional[str] = None,
                           deadline_s: float = 45.0,
                           **complete_kw: Any) -> Dict[str, Any]:
        """Report a terminal outcome, riding out plane-side store brownouts
        (a retryable 503) until ``deadline_s``. Safe to repeat: terminal
        completes are idempotent on the server and zombie results are
        epoch-fenced with a 409, which is not retried."""
        deadline = time.monotonic() + deadline_s
        while True:
            try:
                return self.api.complete_job(
                    job_id, success=success, result=result, error=error,
                    **complete_kw
                )
            except APIError as exc:
                if exc.status < 500 or self._shutdown.is_set() \
                        or time.monotonic() > deadline:
                    raise
                log.warning("completion report for %s bounced (%s); "
                            "retrying", job_id, exc)
                time.sleep(0.5)

    def process_job(self, job: Dict[str, Any],
                    release: Optional[Callable[[], None]] = None) -> None:
        """Run one claimed job. The caller holds a claim: the exclusive one
        (``try_begin_job``, released by default) or a shared serving slot
        (pass ``release=end_serving``). Failover-capable engines get a
        ``_failover_ctx`` (job id, assignment epoch, the claim's
        server-held checkpoint): they resume a requeued generation, register
        it for heartbeat checkpoints and, on drain, raise
        :class:`JobMigrated`, which hands the checkpoint back without
        burning a retry."""
        job_id = job["id"]
        task_type = job.get("type", "llm")
        engine = self.engines.get(task_type)
        with self._state_lock:
            self._active_jobs.add(job_id)
            self.current_job_id = job_id
        started = time.time()
        epoch = int(job.get("assignment_epoch") or 0)
        complete_kw: Dict[str, Any] = (
            {"assignment_epoch": epoch} if "assignment_epoch" in job else {}
        )
        try:
            if engine is None:
                raise RuntimeError(f"no engine loaded for type {task_type!r}")
            params = dict(job.get("params") or {})
            # reserved keys the worker mints: never taken from job params
            for key in ("_failover_ctx", "_flight_picked_up_ts", "_flight_tl"):
                params.pop(key, None)
            if params.get("trace_id"):
                # flight recorder: the poll-pickup instant, adopted into the
                # request's timeline by the engine
                params["_flight_picked_up_ts"] = time.time()
            if job.get("priority") is not None:
                # control-plane priority reaches the batcher's admission heap
                params.setdefault("priority", job.get("priority"))
            if getattr(engine, "supports_failover", False):
                params["_failover_ctx"] = {
                    "key": job_id, "kind": "job", "epoch": epoch,
                    "checkpoint": job.get("checkpoint"),
                }
            result = engine.inference(params)
            # the report has its own fault domain: a bounced POST must not
            # turn a computed result into a failed job
            try:
                self._report_completion(
                    job_id, success=True, result=result, **complete_kw
                )
            except APIError:
                # leave the claim to the sweeps / epoch fence: a rerun beats
                # a spuriously FAILED job
                log.error("could not report completion for job %s", job_id)
            else:
                with self._state_lock:
                    self.stats["jobs_completed"] += 1
        except JobMigrated as mig:
            log.info("job %s migrated on drain (%d tokens checkpointed)",
                     job_id, mig.tokens)
            try:
                self.api.checkpoint_job(
                    job_id, epoch, mig.checkpoint, migrate=True
                )
            except APIError:
                # the offline requeue still resumes from the last
                # heartbeat-piggybacked checkpoint
                log.error("could not push drain checkpoint for %s", job_id)
            with self._state_lock:
                self.stats["jobs_migrated"] += 1
        except Exception as exc:  # noqa: BLE001 — a job failure is a result
            if self._shutdown.is_set():
                # the worker is dying, not the job: release the claim
                # (RUNNING→QUEUED, retry untouched) instead of failing work
                # another replica can run
                log.warning("job %s aborted by shutdown (%s): releasing",
                            job_id, exc)
                try:
                    self.api.release_job(job_id)
                except Exception:  # noqa: BLE001 — the sweeps own it then
                    pass
                with self._state_lock:
                    self.stats["jobs_released_on_shutdown"] = \
                        self.stats.get("jobs_released_on_shutdown", 0) + 1
                return
            log.exception("job %s failed", job_id)
            code = getattr(exc, "error_code", None)
            if code:
                # machine-readable failure class next to the error text
                complete_kw["result"] = {"error_code": str(code)}
            try:
                self._report_completion(
                    job_id, success=False, error=str(exc), **complete_kw
                )
            except APIError:
                log.error("could not report failure for job %s", job_id)
            with self._state_lock:
                self.stats["jobs_failed"] += 1
        finally:
            self.note_job_done(started)
            with self._state_lock:
                self._active_jobs.discard(job_id)
                self.current_job_id = next(iter(self._active_jobs), None)
            (release or self.end_job)()

    def _llm_serving_active(self) -> bool:
        """True when the llm engine serves through a live batcher: queued
        llm jobs then run under SHARED claims and share decode rounds."""
        serving = getattr(self.engines.get("llm"), "serving", None)
        return serving is not None and getattr(serving, "active", False)

    def _job_runs_shared(self, job: Dict[str, Any]) -> bool:
        return job.get("type", "llm") == "llm" and self._llm_serving_active()

    def _dispatch_shared(self, job: Dict[str, Any]) -> None:
        """Run a shared-claim job on the job pool: polling resumes at once,
        so several queued jobs decode concurrently in one batch."""
        if self._job_pool is None:
            self._job_pool = ThreadPoolExecutor(
                max_workers=self._job_pool_width, thread_name_prefix="job"
            )
        with self._state_lock:
            self._pool_inflight += 1

        def run() -> None:
            try:
                self.process_job(job, release=self.end_serving)
            except Exception:  # noqa: BLE001 — a pool thread must not die silently
                log.exception("shared job %s crashed", job.get("id"))
            finally:
                with self._state_lock:
                    self._pool_inflight -= 1

        self._job_pool.submit(run)

    def _poll_once(self) -> bool:
        """One poll iteration; True if a job was processed (or dispatched
        to the shared pool)."""
        if not self.gates_open():  # gated: don't even claim work
            return False
        shared_mode = self._llm_serving_active()
        if shared_mode:
            if self._pool_inflight >= self._job_pool_width:
                # a further claim would start its server-side clock while
                # waiting unstarted in the pool queue
                return False
            with self._state_lock:
                other_shared = self._serving_jobs > 0
            if other_shared and time.time() < self._exclusive_defer_until:
                return False
            if not self.try_begin_serving():
                return False
            release = self.end_serving
        else:
            if not self.try_begin_job():  # direct work in flight / draining
                return False
            release = self.end_job
        job = None
        try:
            job = self.api.fetch_next_job()
        except APIError as exc:
            log.warning("poll failed: %s", exc)
        if job is None:
            release()
            return False
        if not self.should_accept_job(job):
            self.stats["jobs_rejected"] += 1
            self._released_once.add(job["id"])
            try:
                # requeue, don't fail: another worker can run it, and we
                # take it if it comes back
                self.api.release_job(job["id"])
            except APIError:
                pass
            release()
            return False
        self._released_once.discard(job["id"])
        if not shared_mode:
            self.process_job(job)
            return True
        if self._job_runs_shared(job):
            self._dispatch_shared(job)   # the claim travels with the job
            return True
        # the job needs exclusivity (a non-llm engine): upgrade when ours is
        # the sole shared claim, else hand it back and back off
        if self._upgrade_serving_to_exclusive():
            self.process_job(job)
            return True
        try:
            self.api.release_job(job["id"])
        except APIError:
            pass
        self.end_serving()
        self._exclusive_defer_until = time.time() + max(
            5.0, 5 * self.config.poll_interval_s
        )
        return False

    def _main_loop(self) -> None:
        while not self._shutdown.is_set():
            if not self._poll_once():
                self._shutdown.wait(self.config.poll_interval_s)

    # -- lifecycle -------------------------------------------------------------

    def _start_pd_plane(self) -> None:
        """A PD worker's KV data plane on its ``pd_data_plane_url``'s port
        (all interfaces, as the JAX worker binds it)."""
        from urllib.parse import urlsplit

        from distributed_gpu_inference_torch.comm.data_plane import DataPlaneServer

        llm = self.engines["llm"]
        self._pd_plane = DataPlaneServer(
            "0.0.0.0", urlsplit(self.config.pd_data_plane_url).port or 8472,
            health=lambda: {**llm.health(), "pd_kv_receiver": True},
            kv_receiver=getattr(llm, "kv_receiver", None),
            kv_exporter=getattr(llm, "kv_export", None),
        )
        self._pd_plane.start()

    def start(self, install_signal_handlers: bool = True,
              block: bool = True) -> None:
        self.register()
        self.load_engines()
        for eng in self.engines.values():
            # stream-checkpoint cadence between heartbeats (llm engine)
            if hasattr(eng, "checkpoint_sink"):
                eng.checkpoint_sink = self.push_stream_checkpoint
        if self.config.direct.enabled:
            from distributed_gpu_inference_torch.worker.direct_server import (
                DirectServer,
            )

            self._direct = DirectServer(
                self, host=self.config.direct.host,
                port=self.config.direct.port,
            )
            self._direct.start()
        if self.config.pd_data_plane_url and "llm" in self.engines:
            # a decode-capable PD worker: prefill peers push KV here
            self._start_pd_plane()
        self.state = WorkerState.IDLE
        if install_signal_handlers:
            try:
                signal.signal(signal.SIGTERM, self._signal_handler)
                signal.signal(signal.SIGINT, self._signal_handler)
            except ValueError:  # not the main thread
                pass
        self._heartbeat_thread = threading.Thread(
            target=self._heartbeat_loop, name="heartbeat", daemon=True
        )
        self._heartbeat_thread.start()
        self._heartbeat_once()
        if block:
            self._main_loop()
            self._finalize_shutdown()

    def _signal_handler(self, signum: int, frame: Any) -> None:
        log.info("signal %s: graceful shutdown", signum)
        self.request_shutdown()

    def request_shutdown(self) -> None:
        """Graceful drain: stop accepting, MIGRATE in-flight jobs (they
        freeze at the next step boundary and their checkpoints requeue
        them), then tell the server."""
        if self._shutdown.is_set():
            return
        with self._state_lock:
            self.state = WorkerState.DRAINING
        for eng in self.engines.values():
            interrupt = getattr(eng, "interrupt_live", None)
            if interrupt is not None:
                try:
                    interrupt()
                except Exception:  # noqa: BLE001
                    pass
        try:
            self.api.going_offline()
        except APIError:
            pass
        self._shutdown.set()

    # -- stream failover (the direct server drives these) ----------------------

    def adopt_stream_checkpoint(self, stream_id: str
                                ) -> Optional[Dict[str, Any]]:
        """Fetch-and-fence a dropped stream's checkpoint from the plane;
        None when there is none (the direct server answers 409)."""
        try:
            return self.api.adopt_stream(stream_id)
        except APIError as exc:
            if exc.status == 404:
                return None
            raise

    def push_stream_checkpoint(self, entry: Dict[str, Any]) -> None:
        """Checkpoint sink of the llm engine's stream cadence. Job-kind
        entries ride heartbeats only."""
        if entry.get("kind") != "stream":
            return
        self.api.checkpoint_stream(
            entry["key"], int(entry.get("epoch") or 0),
            entry.get("state"), done=bool(entry.get("done")),
        )

    def _finalize_shutdown(self) -> None:
        if self._job_pool is not None:
            # shared jobs were told to freeze (request_shutdown): wait for
            # their JobMigrated checkpoints before reporting offline
            self._job_pool.shutdown(wait=True)
        try:
            requeued = self.api.offline()
            if requeued:
                log.info("server requeued jobs: %s", requeued)
        except APIError:
            pass
        self.state = WorkerState.OFFLINE
        if self._direct is not None:
            self._direct.stop()
        if self._pd_plane is not None:
            self._pd_plane.stop()
        if self._heartbeat_thread is not None:
            self._heartbeat_thread.join(timeout=5.0)
        for eng in self.engines.values():
            try:
                eng.unload()
            except Exception:  # noqa: BLE001
                pass
        self.api.close()

    # -- introspection -----------------------------------------------------------

    def get_status(self) -> Dict[str, Any]:
        return {
            "worker_id": self.api.worker_id,
            "state": self.state.value,
            "current_job_id": self.current_job_id,
            "task_types": list(self.config.task_types),
            "topology": self.topology.to_dict(),
            "stats": dict(self.stats),
        }
