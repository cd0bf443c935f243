"""Server-pushed versioned worker configuration (load control, security,
per-task model configs).

Behavioral parity with the reference's ``server/app/services/worker_config.py``:
- Load-control knobs (:20-47): acceptance_rate, max_concurrent_jobs,
  max_jobs_per_hour, HBM utilization cap, working hours, per-type weights,
  cooldown between jobs.
- Security policy (:50-66) and per-type ``ModelConfig`` incl. quantization
  (:68-82).
- Versioned ``WorkerRemoteConfig`` (:85-107): bump on every update; workers
  learn of changes via the heartbeat ``config_changed`` flag
  (reference ``workers.py:276-289``).
- Server-side ``should_accept_job`` (:195) so admission policy is enforced
  even if a worker is stale.

TPU deltas: memory knob is HBM fraction (not VRAM), model configs carry
mesh-shape hints for pjit layouts.

The port's copy of ``distributed_gpu_inference_tpu/server/worker_config.py``, on the
standard library and the port's own modules.
"""

from __future__ import annotations

import time
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, Optional, Tuple

from .store import Store

# shed fractions of max_queue_depth by tenant tier when the fleet config
# doesn't override them (LoadControl.tier_queue_fractions): batch browns
# out first, then free; paid holds the full limit — the shed ORDER the
# overload ladder guarantees ("paid never shed while free-tier
# capacity exists") falls out of these being strictly ordered.
DEFAULT_TIER_QUEUE_FRACTIONS: Dict[str, float] = {
    "paid": 1.0,
    "free": 0.85,
    "batch": 0.6,
}


@dataclass
class LoadControl:
    acceptance_rate: float = 1.0          # probability of accepting any job
    # this is also the worker's SHARED serving-claim cap
    # (batcher-backed engines batch this many concurrent jobs/streams):
    # the fleet default matches the worker-local default
    # (utils.config.LoadControlConfig) — a server pushing 1 would silently
    # disable continuous batching on every worker it manages. Workers
    # whose engines have no batcher still serialize via the exclusive
    # claim regardless of this value.
    max_concurrent_jobs: int = 4
    max_jobs_per_hour: int = 0            # 0 = unlimited
    max_hbm_utilization: float = 0.9      # fraction of per-chip HBM usable
    working_hours: Optional[list] = None  # [start_hour, end_hour] UTC or None
    task_type_weights: Dict[str, float] = field(default_factory=dict)
    cooldown_seconds: float = 0.0
    # end-to-end backpressure: job submissions beyond this queue depth are
    # rejected with 429 + Retry-After instead of growing the queue silently
    # (the SDK's jittered backoff honors the hint). 0 = unlimited.
    max_queue_depth: int = 0
    # tier-aware shed fractions of max_queue_depth (overload
    # control): a tier sheds once the queue passes fraction * limit, so
    # lower tiers brown out FIRST and paid traffic is never shed while
    # free-tier capacity exists. Missing tiers fall back to
    # DEFAULT_TIER_QUEUE_FRACTIONS; untiered submissions keep the full
    # limit (fraction 1.0 — exactly the blanket behavior without tiers).
    tier_queue_fractions: Dict[str, float] = field(default_factory=dict)


@dataclass
class SecurityPolicy:
    require_signing: bool = True
    token_ttl_hours: float = 168.0
    allowed_ips: Optional[list] = None


@dataclass
class ModelConfig:
    model_id: str = ""
    quantization: Optional[str] = None    # int8 / fp8 (TPU-native AQT-style)
    max_seq_len: int = 4096
    mesh_shape: Optional[Dict[str, int]] = None  # e.g. {"tp": 4, "dp": 2}
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class WorkerRemoteConfig:
    version: int = 1
    load_control: LoadControl = field(default_factory=LoadControl)
    security: SecurityPolicy = field(default_factory=SecurityPolicy)
    model_configs: Dict[str, ModelConfig] = field(default_factory=dict)
    # batcher-serving SLO knobs pushed to live workers (the keys of
    # utils.config.ServingConfig that retune a RUNNING batcher between
    # decode rounds: target_step_ms, max_horizon, min_horizon, multi_step,
    # adaptive, max_wait_ms, queue_limit, default_timeout_s,
    # max_preemptions, spec_max_batch, spec_max_active, ragged).
    # Compile-affecting admission knobs (subwave/interleave) and `mode`
    # are load-time-only worker YAML and silently ignored by the worker if
    # pushed. The ragged serving path made subwave/interleave/
    # max_horizon degenerate: still accepted (saved SLO configs keep
    # deploying) but deprecation-warned once on ingest — see
    # utils.config.DEPRECATED_SERVING_KEYS. Empty dict = no override (the
    # worker keeps its local config).
    serving: Dict[str, Any] = field(default_factory=dict)
    updated_at: float = field(default_factory=time.time)

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "WorkerRemoteConfig":
        from distributed_gpu_inference_torch.utils.config import (
            warn_deprecated_serving_key,
        )

        lc = LoadControl(**(d.get("load_control") or {}))
        sec = SecurityPolicy(**(d.get("security") or {}))
        mcs = {
            k: ModelConfig(**v) for k, v in (d.get("model_configs") or {}).items()
        }
        for key, val in (d.get("serving") or {}).items():
            if val is not None:
                warn_deprecated_serving_key(key, "remote config push")
        return cls(
            version=int(d.get("version") or 1),
            load_control=lc,
            security=sec,
            model_configs=mcs,
            serving=dict(d.get("serving") or {}),
            updated_at=float(d.get("updated_at") or time.time()),
        )


class WorkerConfigService:
    """Source of truth for per-worker remote config, persisted on worker rows
    (``config_version`` + ``config_override``)."""

    def __init__(self, store: Store,
                 defaults: Optional[WorkerRemoteConfig] = None) -> None:
        self._store = store
        self._defaults = defaults or WorkerRemoteConfig()

    async def get_config(self, worker_id: str) -> WorkerRemoteConfig:
        w = await self._store.get_worker(worker_id)
        if w is None:
            return self._defaults
        override = w.get("config_override")
        if override:
            cfg = WorkerRemoteConfig.from_dict(override)
        else:
            cfg = WorkerRemoteConfig.from_dict(self._defaults.to_dict())
        cfg.version = int(w.get("config_version") or cfg.version or 1)
        return cfg

    async def update_config(self, worker_id: str,
                            updates: Dict[str, Any]) -> WorkerRemoteConfig:
        """Merge updates into the worker's config and bump the version."""
        cfg = await self.get_config(worker_id)
        d = cfg.to_dict()
        for key, val in updates.items():
            if key in ("load_control", "security", "serving") \
                    and isinstance(val, dict):
                d[key] = {**(d.get(key) or {}), **val}
            elif key == "model_configs" and isinstance(val, dict):
                merged = dict(d.get("model_configs") or {})
                for task, mc in val.items():
                    base = dict(merged.get(task) or {})
                    base.update(mc)
                    merged[task] = base
                d["model_configs"] = merged
            else:
                d[key] = val
        d["version"] = cfg.version + 1
        d["updated_at"] = time.time()
        new = WorkerRemoteConfig.from_dict(d)
        await self._store.update_worker(
            worker_id,
            config_version=new.version,
            config_override=new.to_dict(),
        )
        return new

    async def config_changed_since(self, worker_id: str, version: int) -> bool:
        w = await self._store.get_worker(worker_id)
        if w is None:
            return False
        return int(w.get("config_version") or 0) > version

    # -- submission backpressure (same policy object should_accept_job
    # enforces on the claim side; this is the client-facing half) ------------

    @property
    def submit_queue_limit(self) -> int:
        """Fleet-default queue-depth ceiling for job submissions (0 =
        backpressure disabled)."""
        return int(self._defaults.load_control.max_queue_depth or 0)

    def set_submit_queue_limit(self, limit: int) -> None:
        self._defaults.load_control.max_queue_depth = int(limit)

    def should_accept_submission(self, queued: int, active_workers: int,
                                 tier: Optional[str] = None
                                 ) -> Tuple[bool, float]:
        """Queue-depth admission control for POST /jobs. Returns
        ``(accept, retry_after_s)`` — when the fleet-default
        ``LoadControl.max_queue_depth`` is exceeded the submission is
        rejected and the hint estimates the drain time of the overflow
        (queue beyond the limit, spread over live workers), clamped to
        [1, 60] s so a burst never tells every client to come back at the
        same instant far in the future.

        ``tier`` (overload control) scales the limit by the
        tier's queue fraction: free/batch tiers shed at a fraction of the
        limit paid keeps, so the shed order under saturation is
        batch → free → paid by construction. ``tier=None`` (legacy
        untiered submissions) keeps the full limit — byte-identical to
        the pre-tier behavior."""
        limit = self.submit_queue_limit
        if limit <= 0:
            return True, 0.0
        if tier is not None:
            frac = (self._defaults.load_control.tier_queue_fractions.get(
                tier, DEFAULT_TIER_QUEUE_FRACTIONS.get(tier, 1.0)))
            limit = max(1, int(limit * max(0.0, min(1.0, float(frac)))))
        if queued < limit:
            return True, 0.0
        overflow = queued - limit + 1
        retry_after = min(60.0, max(1.0, overflow / max(1, active_workers)))
        return False, retry_after

    # -- server-side admission (reference worker_config.py:195) --------------

    async def should_accept_job(self, worker_id: str, job_type: str,
                                now: Optional[float] = None,
                                rand: float = 0.0,
                                ignore_job_id: Optional[str] = None) -> bool:
        cfg = await self.get_config(worker_id)
        lc = cfg.load_control
        now = time.time() if now is None else now

        if rand > lc.acceptance_rate:
            return False
        weight = lc.task_type_weights.get(job_type, 1.0)
        if weight <= 0:
            return False
        if lc.working_hours:
            start, end = lc.working_hours
            hour = time.gmtime(now).tm_hour
            in_window = (start <= hour < end) if start <= end else (
                hour >= start or hour < end
            )
            if not in_window:
                return False
        w = await self._store.get_worker(worker_id)
        if w is not None:
            current = w.get("current_job_id")
            if (current and current != ignore_job_id
                    and lc.max_concurrent_jobs <= 1):
                return False
            hbm_cap = lc.max_hbm_utilization * float(w.get("hbm_gb_per_chip") or 0)
            if hbm_cap and float(w.get("hbm_used_gb") or 0) > hbm_cap * max(
                1, int(w.get("num_chips") or 1)
            ):
                return False
        return True
