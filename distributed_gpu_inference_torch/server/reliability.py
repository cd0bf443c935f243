"""Worker reliability scoring, online-pattern learning, availability predictors.

Behavioral parity with the reference's ``server/app/services/reliability.py``:
- Event-driven score deltas (:19-26): complete +0.02, fail −0.05,
  unexpected-offline −0.15, graceful-offline −0.02, long-session +0.05,
  fast-response +0.01; score clamped to [0, 1].
- Per-hour-of-day EMA online pattern (:98-108).
- Predictors: ``predict_online_probability`` (:130) and
  ``predict_remaining_online_time`` (:143).

Pure logic over Store rows — hermetically testable on CPU.

The port's copy of ``distributed_gpu_inference_tpu/server/reliability.py``, on the
standard library and the port's own modules.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from .store import Store

SCORE_DELTAS = {
    "job_completed": +0.02,
    "job_failed": -0.05,
    "unexpected_offline": -0.15,
    "graceful_offline": -0.02,
    "long_session": +0.05,      # session > LONG_SESSION_MINUTES
    "fast_response": +0.01,     # latency < FAST_RESPONSE_MS
}
LONG_SESSION_MINUTES = 60.0
FAST_RESPONSE_MS = 1000.0
PATTERN_EMA_ALPHA = 0.2


def _clamp(x: float, lo: float = 0.0, hi: float = 1.0) -> float:
    return max(lo, min(hi, x))


class ReliabilityService:
    """Maintains reliability stats on worker rows."""

    def __init__(self, store: Store) -> None:
        self._store = store

    # -- event recording ---------------------------------------------------

    async def record_event(self, worker_id: str, event: str,
                           latency_ms: Optional[float] = None,
                           now: Optional[float] = None) -> Optional[float]:
        """Apply a score delta + update aggregate stats; returns new score."""
        w = await self._store.get_worker(worker_id)
        if w is None:
            return None
        now = time.time() if now is None else now
        # NOT `or 0.5`: a worker pinned at the 0.0 rail must stay there —
        # falsy-0.0 coercion would bounce it back to the neutral prior on
        # every subsequent event, erasing the penalty history
        raw = w.get("reliability_score")
        score = 0.5 if raw is None else float(raw)
        fields: Dict[str, Any] = {}

        delta = SCORE_DELTAS.get(event, 0.0)
        score = _clamp(score + delta)

        if event == "job_completed":
            fields["total_jobs"] = int(w.get("total_jobs") or 0) + 1
            fields["completed_jobs"] = int(w.get("completed_jobs") or 0) + 1
            if latency_ms is not None:
                prev = float(w.get("avg_latency_ms") or 0.0)
                n = fields["completed_jobs"]
                fields["avg_latency_ms"] = prev + (latency_ms - prev) / n
                if latency_ms < FAST_RESPONSE_MS:
                    score = _clamp(score + SCORE_DELTAS["fast_response"])
        elif event == "job_failed":
            fields["total_jobs"] = int(w.get("total_jobs") or 0) + 1
            fields["failed_jobs"] = int(w.get("failed_jobs") or 0) + 1
        elif event == "unexpected_offline":
            fields["unexpected_offline_count"] = (
                int(w.get("unexpected_offline_count") or 0) + 1
            )

        total = int(fields.get("total_jobs", w.get("total_jobs") or 0))
        completed = int(fields.get("completed_jobs", w.get("completed_jobs") or 0))
        if total > 0:
            fields["success_rate"] = completed / total
        fields["reliability_score"] = score
        await self._store.update_worker(worker_id, **fields)
        return score

    # -- session tracking (reference reliability.py:110-128) ----------------

    async def start_session(self, worker_id: str,
                            now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        await self._store.update_worker(worker_id, current_session_start=now)

    async def end_session(self, worker_id: str, graceful: bool = True,
                          now: Optional[float] = None) -> Optional[float]:
        """Close a session; returns its length in minutes."""
        w = await self._store.get_worker(worker_id)
        if w is None or not w.get("current_session_start"):
            return None
        now = time.time() if now is None else now
        dur_s = max(0.0, now - float(w["current_session_start"]))
        sessions = int(w.get("total_sessions") or 0) + 1
        prev_avg = float(w.get("avg_session_minutes") or 0.0)
        avg = prev_avg + (dur_s / 60.0 - prev_avg) / sessions
        await self._store.update_worker(
            worker_id,
            current_session_start=None,
            total_sessions=sessions,
            avg_session_minutes=avg,
            total_online_seconds=float(w.get("total_online_seconds") or 0.0) + dur_s,
        )
        if dur_s / 60.0 >= LONG_SESSION_MINUTES:
            await self.record_event(worker_id, "long_session", now=now)
        await self.record_event(
            worker_id,
            "graceful_offline" if graceful else "unexpected_offline",
            now=now,
        )
        return dur_s / 60.0

    # -- online pattern ------------------------------------------------------

    async def update_online_pattern(self, worker_id: str, online: bool,
                                    now: Optional[float] = None) -> None:
        """EMA per hour-of-day of observed online-ness (reference :98-108)."""
        w = await self._store.get_worker(worker_id)
        if w is None:
            return
        now = time.time() if now is None else now
        hour = str(int(time.gmtime(now).tm_hour))
        pattern = dict(w.get("online_pattern") or {})
        prev = float(pattern.get(hour, 0.5))
        pattern[hour] = (
            (1 - PATTERN_EMA_ALPHA) * prev + PATTERN_EMA_ALPHA * (1.0 if online else 0.0)
        )
        await self._store.update_worker(worker_id, online_pattern=pattern)

    # -- predictors ----------------------------------------------------------

    def predict_online_probability(self, worker: Dict[str, Any],
                                   now: Optional[float] = None) -> float:
        """P(online at this hour) from the learned pattern, blended with
        the reliability score (reference :130-141)."""
        now = time.time() if now is None else now
        hour = str(int(time.gmtime(now).tm_hour))
        pattern = worker.get("online_pattern") or {}
        p_hour = float(pattern.get(hour, 0.5))
        raw = worker.get("reliability_score")   # 0.0 is a real score, not
        score = 0.5 if raw is None else float(raw)  # "unknown"
        return _clamp(0.7 * p_hour + 0.3 * score)

    def predict_remaining_online_time(self, worker: Dict[str, Any],
                                      now: Optional[float] = None) -> float:
        """Expected remaining minutes of the current session (reference :143)."""
        now = time.time() if now is None else now
        start = worker.get("current_session_start")
        avg_min = float(worker.get("avg_session_minutes") or 0.0)
        if not start or avg_min <= 0:
            return avg_min
        elapsed_min = max(0.0, (now - float(start)) / 60.0)
        return max(0.0, avg_min - elapsed_min)
