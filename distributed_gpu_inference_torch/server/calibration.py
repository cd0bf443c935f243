"""Cost-model self-calibration: per-worker online estimators that feed
MEASURED prefill throughput, queue wait, and handoff bandwidth back into
``decide_kv_route`` in place of the four static priors (the cost model
would otherwise price migration off four static guesses).

Three sources, all already on the wire:

- **Flight traces** (``server/flight_recorder.py``): a worker's ``done``
  wire carries the batcher's ``enqueued`` → ``admitted`` → ``first_token``
  events. admitted−enqueued is the request's real queue wait; the
  ``admitted`` event's ``tokens`` attr over first_token−admitted is the
  real prefill tok/s. Ingest dedups per (trace, worker) — the flight ring
  re-delivers wires, the estimator must not double-count.
- **Worker kv_migrate wire counters** (``engines/llm.py``): cumulative
  per-tier ``pull_bytes_<tier>`` / ``pull_ms_<tier>`` ride the heartbeat;
  deltas of the pair give measured pull bandwidth per (worker, tier).
  Delta-anchored exactly like the PD metrics: a counter that went
  BACKWARD means the worker restarted — re-anchor, never emit a negative.

Estimators are EMA + outlier clamp: once warm (>= min_samples), a sample
further than ``calibrate_clamp``x from the running value is clamped
before blending, so one GC pause or one cold-cache pull cannot poison
the estimate. Each also tracks ``err_ema`` — the EMA of the relative
error between the value it WOULD have predicted and the sample that
arrived — which is the published ``predicted_vs_measured`` number the
bench asserts falls round-over-round.

Everything here is advisory and read-locked behind
``RoutingConfig.calibrate``: ingestion always runs (the /admin/routing
snapshot shows what calibration WOULD use), but no placement decision
reads a learned value while the flag is off — byte-identical routing is
the A/B contract.

The port's copy of ``distributed_gpu_inference_tpu/server/calibration.py``, on the
standard library and the port's own modules.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

from .prefix_routing import MIGRATE_TIER_COST, RoutingConfig


class Estimator:
    """One EMA-with-clamp online estimator (value + sample count +
    relative-error EMA). Not thread-safe on its own — owners lock."""

    __slots__ = ("alpha", "clamp", "min_samples", "value", "n", "err_ema")

    def __init__(self, *, alpha: float = 0.3, clamp: float = 5.0,
                 min_samples: int = 3) -> None:
        self.alpha = min(1.0, max(0.0, alpha))
        self.clamp = max(1.0, clamp)
        self.min_samples = max(1, min_samples)
        self.value = 0.0
        self.n = 0
        self.err_ema: Optional[float] = None

    def observe(self, sample: float) -> None:
        if not (sample == sample) or sample in (float("inf"),
                                                float("-inf")):
            return  # NaN/inf: a degenerate measurement never lands
        if self.n == 0:
            self.value = float(sample)
            self.n = 1
            return
        # predicted-vs-measured BEFORE this sample updates the value —
        # the convergence signal the bench publishes
        err = abs(sample - self.value) / max(abs(sample), abs(self.value),
                                             1e-9)
        self.err_ema = (err if self.err_ema is None
                        else self.err_ema + self.alpha * (err - self.err_ema))
        s = float(sample)
        if self.n >= self.min_samples and self.value > 0.0:
            lo, hi = self.value / self.clamp, self.value * self.clamp
            s = min(max(s, lo), hi)
        self.value += self.alpha * (s - self.value)
        self.n += 1

    @property
    def warm(self) -> bool:
        return self.n >= self.min_samples

    def get(self) -> Optional[float]:
        """The calibrated value, or None below min_samples (caller keeps
        the static prior — never steer off one lucky measurement)."""
        return self.value if self.warm else None

    def snapshot(self) -> Dict[str, Any]:
        return {
            "value": round(self.value, 6),
            "samples": self.n,
            "warm": self.warm,
            "err_ema": (None if self.err_ema is None
                        else round(self.err_ema, 6)),
        }


class CostCalibration:
    """Per-worker estimator bank + the delta anchors for the cumulative
    wire counters. Thread-safe (heartbeats and discovery race)."""

    # bound per-process growth under worker-id churn
    _MAX_WORKERS = 512
    # (trace_id, worker_id) dedup ring: flight wires re-deliver
    _MAX_SEEN = 4096

    def __init__(self, cfg: RoutingConfig) -> None:
        self.cfg = cfg
        self._lock = threading.Lock()
        # worker_id -> estimator
        self._prefill: Dict[str, Estimator] = {}
        self._queue: Dict[str, Estimator] = {}
        # (worker_id, tier) -> estimator (bytes/s)
        self._bw: Dict[Tuple[str, str], Estimator] = {}
        # (worker_id, tier) -> (prev_bytes, prev_ms) cumulative anchors
        self._bw_prev: Dict[Tuple[str, str], Tuple[float, float]] = {}
        self._seen: set = set()
        self._seen_ring: Deque[Tuple[str, str]] = deque()

    def _estimator(self) -> Estimator:
        return Estimator(alpha=self.cfg.calibrate_alpha,
                         clamp=self.cfg.calibrate_clamp,
                         min_samples=self.cfg.calibrate_min_samples)

    def _get(self, table: Dict, key) -> Estimator:
        est = table.get(key)
        if est is None:
            if len(table) >= self._MAX_WORKERS:
                # arbitrary-but-bounded eviction; churned ids re-learn
                table.pop(next(iter(table)))
            est = table[key] = self._estimator()
        return est

    # -- ingest: flight traces ----------------------------------------------

    def ingest_trace(self, worker_id: str, trace_id: str,
                     events: Sequence[Tuple[str, float, Dict[str, Any]]]
                     ) -> bool:
        """Feed one worker's completed flight wire. Extracts queue wait
        (admitted − enqueued) and prefill tok/s (admitted ``tokens`` attr
        over first_token − admitted). Idempotent per (trace, worker).
        Returns True when a sample landed (tests use it)."""
        key = (str(trace_id), str(worker_id))
        with self._lock:
            if key in self._seen:
                return False
            self._seen.add(key)
            self._seen_ring.append(key)
            while len(self._seen_ring) > self._MAX_SEEN:
                self._seen.discard(self._seen_ring.popleft())
            enq = adm = ftk = None
            tokens = 0
            for name, ts, attrs in events:
                if name == "batcher.enqueued" and enq is None:
                    enq = ts
                elif name == "batcher.admitted" and adm is None:
                    adm = ts
                    try:
                        tokens = int((attrs or {}).get("tokens") or 0)
                    except (TypeError, ValueError):
                        tokens = 0
                elif name == "batcher.first_token" and ftk is None:
                    ftk = ts
            landed = False
            if enq is not None and adm is not None and adm >= enq:
                self._get(self._queue, worker_id).observe(adm - enq)
                landed = True
            if (adm is not None and ftk is not None and ftk > adm
                    and tokens > 0):
                self._get(self._prefill, worker_id).observe(
                    tokens / (ftk - adm))
                landed = True
            return landed

    # -- ingest: kv_migrate wire counters -----------------------------------

    def ingest_kv_migrate(self, worker_id: str,
                          stats: Dict[str, Any]) -> None:
        """Feed one heartbeat's cumulative kv_migrate engine stats. The
        puller reports per-tier ``pull_bytes_<tier>`` / ``pull_ms_<tier>``;
        a matched positive delta pair gives one bandwidth sample for
        (worker, tier). Counter regression (restart) re-anchors."""
        if not isinstance(stats, dict):
            return
        with self._lock:
            for tier in MIGRATE_TIER_COST:
                try:
                    cur_b = float(stats.get(f"pull_bytes_{tier}") or 0)
                    cur_ms = float(stats.get(f"pull_ms_{tier}") or 0)
                except (TypeError, ValueError):
                    continue
                if cur_b <= 0 and cur_ms <= 0:
                    continue
                key = (worker_id, tier)
                prev_b, prev_ms = self._bw_prev.get(key, (0.0, 0.0))
                db, dms = cur_b - prev_b, cur_ms - prev_ms
                self._bw_prev[key] = (cur_b, cur_ms)
                if db <= 0 or dms <= 0:
                    continue   # regression = restart re-anchor, or no pull
                self._get(self._bw, key).observe(db / (dms / 1000.0))

    # -- decide-time reads (None → caller keeps the prior) -------------------

    def prefill_tps(self, worker_id: str) -> Optional[float]:
        if not self.cfg.calibrate:
            return None
        with self._lock:
            est = self._prefill.get(worker_id)
            return est.get() if est is not None else None

    def queue_wait_s(self, worker_id: str) -> Optional[float]:
        if not self.cfg.calibrate:
            return None
        with self._lock:
            est = self._queue.get(worker_id)
            return est.get() if est is not None else None

    def bandwidth(self, worker_id: Optional[str],
                  tier: str) -> Optional[float]:
        """Measured pull bandwidth for (source worker, tier). The tier
        cost multiplier stays applied by ``decide_kv_route`` — the
        estimator already folds it in per-tier, so we divide it back out
        to return the cfg-equivalent base bandwidth."""
        if not self.cfg.calibrate or worker_id is None:
            return None
        with self._lock:
            est = self._bw.get((worker_id, tier))
            if est is None or not est.warm:
                return None
            # decide_kv_route divides by bw then multiplies by tier cost;
            # our samples measured the tier-inclusive effective rate
            return est.value * MIGRATE_TIER_COST.get(tier, 1.0)

    # -- admin surface -------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Live values + predicted_vs_measured error for /admin/routing."""
        with self._lock:
            workers: Dict[str, Dict[str, Any]] = {}
            for wid, est in self._prefill.items():
                workers.setdefault(wid, {})["prefill_tokens_per_s"] = \
                    est.snapshot()
            for wid, est in self._queue.items():
                workers.setdefault(wid, {})["queue_wait_s"] = est.snapshot()
            for (wid, tier), est in self._bw.items():
                workers.setdefault(wid, {}).setdefault(
                    "bandwidth_bytes_per_s", {})[tier] = est.snapshot()
            errs = [est.err_ema
                    for table in (self._prefill, self._queue)
                    for est in table.values() if est.err_ema is not None]
            errs += [e.err_ema for e in self._bw.values()
                     if e.err_ema is not None]
            return {
                "active": bool(self.cfg.calibrate),
                "workers": workers,
                "predicted_vs_measured": (
                    round(sum(errs) / len(errs), 6) if errs else None),
            }

    def reset(self) -> None:
        """Freeze back to priors: drop every learned value AND the delta
        anchors (the next cumulative reading re-anchors cleanly). The
        admin PUT ``calibrate_reset`` action — the A/B switch's hard
        half."""
        with self._lock:
            self._prefill.clear()
            self._queue.clear()
            self._bw.clear()
            self._bw_prev.clear()
            self._seen.clear()
            self._seen_ring.clear()


class MigrateHintTracker:
    """Counts the migrate/replicate pulls the plane has recently steered
    at each worker, so ``decide_kv_route`` can price a target that is
    already mid-budget (satellite fix: without this, every request in a
    burst races to the same 'idle' exporter). Entries expire after
    ``migrate_hint_window_s`` — a pull is presumed resolved by then
    (done, fallen back, or abandoned); the worker's own budget/backoff
    remains the hard limit either way."""

    _MAX_WORKERS = 512

    def __init__(self, cfg: RoutingConfig) -> None:
        self.cfg = cfg
        self._lock = threading.Lock()
        self._hints: Dict[str, Deque[float]] = {}

    def note(self, worker_id: str, now: Optional[float] = None) -> None:
        """The plane just handed out a hint whose PULLER is worker_id."""
        now = time.time() if now is None else now
        with self._lock:
            dq = self._hints.get(worker_id)
            if dq is None:
                if len(self._hints) >= self._MAX_WORKERS:
                    self._hints.pop(next(iter(self._hints)))
                dq = self._hints[worker_id] = deque()
            dq.append(now)

    def inflight(self, worker_id: str,
                 now: Optional[float] = None) -> int:
        now = time.time() if now is None else now
        cutoff = now - max(0.1, self.cfg.migrate_hint_window_s)
        with self._lock:
            dq = self._hints.get(worker_id)
            if not dq:
                return 0
            while dq and dq[0] < cutoff:
                dq.popleft()
            if not dq:
                del self._hints[worker_id]
                return 0
            return len(dq)
