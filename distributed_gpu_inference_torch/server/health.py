"""Gray-failure defense: windowed per-worker health scoring
with a healthy → suspect → quarantined → probation state machine.

Clean deaths are easy — a killed worker stops heartbeating and the sweep
removes it. The dangerous replica is the one that is *alive and 10x
slow* (thermal throttle, dying disk, noisy neighbor) or answering 5xx at
some probability: it passes every liveness check, keeps winning affinity
for its warm prefixes, and silently blows every SLO routed through it.
This service turns the fleet's own phase-latency telemetry (the direct
serving channel + worker-measured heartbeat round-trips shipped over
heartbeats, the same side channel the flight recorder uses) into a
defensive routing signal.

Design invariants:

- **Relative, not absolute.** A worker is judged against the CURRENT
  fleet median p95 — a globally slow model/configuration quarantines
  nobody, and the thresholds need no per-deployment tuning.
- **Quarantine is a routing preference, not a death sentence.** A
  quarantined worker is excluded from discovery ranking and claim
  preference but keeps its registration, keeps heartbeating, still
  serves ``/kv/export`` pulls, and finishes in-flight work. Probation
  re-admits it through a bounded canary budget, so one noisy window
  cannot permanently evict a healthy replica.
- **Capped blast radius.** At most ``max_quarantined_frac`` of the
  scored fleet can be quarantined at once — if "everyone looks slow" the
  baseline is wrong, not the fleet.
- **Default OFF, byte-identical when disabled.** With ``enabled=False``
  nothing reads the samples, no response field changes, no ranking
  changes: the discovery/claim path without health, verbatim.

Live-pushable via ``GET/PUT /api/v1/admin/health`` exactly like
:class:`~.prefix_routing.RoutingConfig`.

The port's copy of ``distributed_gpu_inference_tpu/server/health.py``, on the
standard library and the port's own modules.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

# state-machine states, in escalation order; the numeric codes are what
# the ``worker_health_state`` gauge exports (keep them stable)
HEALTHY = "healthy"
SUSPECT = "suspect"
QUARANTINED = "quarantined"
PROBATION = "probation"
STATE_CODES = {HEALTHY: 0, SUSPECT: 1, QUARANTINED: 2, PROBATION: 3}


@dataclass
class HealthConfig:
    """Live-pushable health/quarantine/hedge knobs
    (admin ``PUT /api/v1/admin/health``)."""

    # master switch: OFF keeps discovery/claim byte-identical to the
    # pre-health build
    enabled: bool = False
    # hedged dispatch for deadline-carrying direct requests: discovery
    # returns a second-ranked candidate + a p95-derived fire delay and
    # the SDK races the two, first winner cancelling the loser. Separate
    # switch so quarantine and hedging A/B independently.
    hedge: bool = False
    # sliding sample window; older samples fall out of the score
    window_s: float = 60.0
    # per-worker samples required before it is judged (or used as a
    # baseline peer) — one slow request is noise, not a gray failure
    min_samples: int = 5
    # scored peers required for a fleet baseline: with one worker there
    # is nothing to be relatively slow against
    min_peers: int = 2
    # worker p95 / fleet median p95 at or above this → suspect
    suspect_ratio: float = 3.0
    # hysteresis: ratio must fall BELOW this to clear back to healthy
    # (strictly < suspect_ratio or a worker on the rail would flap)
    clear_ratio: float = 1.5
    # suspect must persist this long before quarantine — a single slow
    # GC pause or compile storm should clear on its own
    grace_s: float = 3.0
    # quarantined at least this long before probation opens
    probation_after_s: float = 10.0
    # canary requests probation may route to the worker; its fresh
    # samples then decide re-admission vs re-quarantine
    canary_budget: int = 3
    # each server-side error (flaky 5xx) scores as a synthetic sample of
    # this latency — a fast-failing replica is as gray as a slow one
    error_sample_ms: float = 2000.0
    # at most this fraction of the SCORED fleet may sit in
    # quarantined/probation at once (rounded down, min 1 when any
    # worker qualifies) — baseline-poisoning containment
    max_quarantined_frac: float = 0.34
    # hedge fire delay = hedge_delay_factor × fleet median p95, clamped
    # to [hedge_delay_min_ms, hedge_delay_max_ms]; the factor keeps the
    # hedge AFTER the common case finishes (cheap) but well before the
    # deadline burns down (useful)
    hedge_delay_factor: float = 1.5
    hedge_delay_min_ms: float = 50.0
    hedge_delay_max_ms: float = 5000.0

    def update(self, d: Dict[str, Any]) -> None:
        # validate EVERYTHING before applying ANYTHING (same contract as
        # RoutingConfig.update: a 400 must leave the live config intact)
        staged: Dict[str, Any] = {}
        for flag in ("enabled", "hedge"):
            if d.get(flag) is not None:
                v = d[flag]
                if isinstance(v, str):
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
        for k, lo, hi in (("window_s", 1.0, float("inf")),
                          ("suspect_ratio", 1.0, float("inf")),
                          ("clear_ratio", 1.0, float("inf")),
                          ("grace_s", 0.0, float("inf")),
                          ("probation_after_s", 0.0, float("inf")),
                          ("error_sample_ms", 0.0, float("inf")),
                          ("max_quarantined_frac", 0.0, 1.0),
                          ("hedge_delay_factor", 0.0, float("inf")),
                          ("hedge_delay_min_ms", 0.0, float("inf")),
                          ("hedge_delay_max_ms", 0.0, float("inf"))):
            if d.get(k) is not None:
                v = float(d[k])
                if not lo <= v <= hi:
                    raise ValueError(f"{k}: {v} outside [{lo}, {hi}]")
                staged[k] = v
        for k in ("min_samples", "min_peers", "canary_budget"):
            if d.get(k) is not None:
                v = int(d[k])
                if v < 1:
                    raise ValueError(f"{k}: must be >= 1, got {v}")
                staged[k] = v
        clear = staged.get("clear_ratio", self.clear_ratio)
        suspect = staged.get("suspect_ratio", self.suspect_ratio)
        if clear >= suspect:
            raise ValueError(
                f"clear_ratio ({clear}) must stay below suspect_ratio "
                f"({suspect}) — equal thresholds make the state machine "
                "flap on the rail"
            )
        for k, v in staged.items():
            setattr(self, k, v)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "enabled": self.enabled,
            "hedge": self.hedge,
            "window_s": self.window_s,
            "min_samples": self.min_samples,
            "min_peers": self.min_peers,
            "suspect_ratio": self.suspect_ratio,
            "clear_ratio": self.clear_ratio,
            "grace_s": self.grace_s,
            "probation_after_s": self.probation_after_s,
            "canary_budget": self.canary_budget,
            "error_sample_ms": self.error_sample_ms,
            "max_quarantined_frac": self.max_quarantined_frac,
            "hedge_delay_factor": self.hedge_delay_factor,
            "hedge_delay_min_ms": self.hedge_delay_min_ms,
            "hedge_delay_max_ms": self.hedge_delay_max_ms,
        }


@dataclass
class _WorkerHealth:
    # (ts, latency_ms) — bounded ring; the window prune is on read
    samples: Deque[Tuple[float, float]] = field(
        default_factory=lambda: deque(maxlen=512)
    )
    state: str = HEALTHY
    since: float = 0.0           # wall clock of the last state change
    suspect_since: float = 0.0   # first moment of the CURRENT suspect run
    canaries: int = 0            # canary requests granted this probation
    # fresh-sample watermark: probation verdicts only weigh samples
    # observed AFTER probation opened (pre-quarantine history must not
    # outvote the canary evidence either way)
    probation_mark: float = 0.0


def _p95(values: List[float]) -> float:
    if not values:
        return 0.0
    vs = sorted(values)
    # nearest-rank on the sorted window (small-n friendly: 1 sample → it)
    idx = min(len(vs) - 1, max(0, int(0.95 * len(vs) + 0.5) - 1))
    return vs[idx]


def _median(values: List[float]) -> float:
    if not values:
        return 0.0
    vs = sorted(values)
    mid = len(vs) // 2
    if len(vs) % 2:
        return vs[mid]
    return 0.5 * (vs[mid - 1] + vs[mid])


class HealthService:
    """Windowed per-worker latency scores + the quarantine state machine.

    Thread-safe (heartbeat ingest and discovery reads race): one lock
    around the sample rings and state table; every public read takes a
    consistent snapshot. Pure wall-clock logic over in-memory state —
    hermetically testable with injected ``now``."""

    def __init__(self, config: Optional[HealthConfig] = None,
                 on_transition: Optional[
                     Callable[[str, str, str], None]] = None) -> None:
        self.cfg = config or HealthConfig()
        self._workers: Dict[str, _WorkerHealth] = {}
        self._lock = threading.Lock()
        # (worker_id, from_state, to_state) → metrics counter; wrapped so
        # a metrics failure can never 500 a heartbeat
        self._on_transition = on_transition

    # -- ingest ---------------------------------------------------------------

    def observe(self, worker_id: str, latency_ms: float,
                now: Optional[float] = None) -> None:
        """One phase-latency sample for this worker (direct request
        wall time, heartbeat RTT, batcher step EMA — the score mixes
        whatever the worker ships)."""
        if not self.cfg.enabled:
            return   # disabled: do not even accumulate (byte-identical)
        now = time.time() if now is None else now
        try:
            ms = float(latency_ms)
        except (TypeError, ValueError):
            return
        if ms < 0.0 or ms != ms or ms == float("inf"):
            return
        with self._lock:
            wh = self._workers.setdefault(worker_id, _WorkerHealth())
            wh.samples.append((now, ms))

    def observe_error(self, worker_id: str, count: int = 1,
                      now: Optional[float] = None) -> None:
        """Server-side errors (flaky 5xx): each scores as a synthetic
        slow sample — a replica failing FAST must not look healthy."""
        for _ in range(max(0, min(int(count), 64))):
            self.observe(worker_id, self.cfg.error_sample_ms, now=now)

    def ingest(self, worker_id: str, engine_stats: Optional[Dict[str, Any]],
               body: Optional[Dict[str, Any]] = None,
               now: Optional[float] = None) -> None:
        """Heartbeat hook: pull every health-relevant sample out of one
        beat. Worker-supplied payloads degrade to skipped samples, never
        raise (a malformed beat must not get a live worker swept)."""
        if not self.cfg.enabled:
            return
        now = time.time() if now is None else now
        try:
            if isinstance(body, dict) and body.get("hb_rtt_ms") is not None:
                self.observe(worker_id, body["hb_rtt_ms"], now=now)
            direct = (engine_stats or {}).get("direct") \
                if isinstance(engine_stats, dict) else None
            if isinstance(direct, dict):
                recent = direct.get("recent_ms")
                if isinstance(recent, list):
                    for ms in recent[:64]:
                        self.observe(worker_id, ms, now=now)
                errs = direct.get("new_errors")
                if errs:
                    self.observe_error(worker_id, int(errs), now=now)
        except (TypeError, ValueError):
            pass
        self.evaluate(now=now)

    def forget(self, worker_id: str) -> None:
        """Worker deregistered/offline: a clean death supersedes gray
        state (the sweep path owns dead workers)."""
        with self._lock:
            self._workers.pop(worker_id, None)

    # -- scoring --------------------------------------------------------------

    def _window_values(self, wh: _WorkerHealth, now: float,
                       since: float = 0.0) -> List[float]:
        cutoff = max(now - self.cfg.window_s, since)
        return [ms for ts, ms in wh.samples if ts >= cutoff]

    def _scores(self, now: float) -> Dict[str, Tuple[float, int]]:
        """→ {worker: (p95_ms, n_samples)} over the live window."""
        out: Dict[str, Tuple[float, int]] = {}
        for wid, wh in self._workers.items():
            vals = self._window_values(wh, now)
            out[wid] = (_p95(vals), len(vals))
        return out

    def _baseline(self, scores: Dict[str, Tuple[float, int]]) -> float:
        """Fleet baseline: median of the qualified peers' p95s. Workers
        already quarantined are EXCLUDED — a quarantined straggler must
        not drag the baseline up and mask the next gray failure."""
        vals = [
            p95 for wid, (p95, n) in scores.items()
            if n >= self.cfg.min_samples and p95 > 0.0
            and self._workers[wid].state not in (QUARANTINED, PROBATION)
        ]
        if len(vals) < self.cfg.min_peers:
            return 0.0
        return _median(vals)

    # -- state machine --------------------------------------------------------

    def _transition(self, wid: str, wh: _WorkerHealth, to: str,
                    now: float) -> None:
        frm = wh.state
        if frm == to:
            return
        wh.state = to
        wh.since = now
        if to == SUSPECT:
            wh.suspect_since = now
        if to == PROBATION:
            wh.canaries = 0
            wh.probation_mark = now
        if self._on_transition is not None:
            try:
                self._on_transition(wid, frm, to)
            except Exception:  # noqa: BLE001 — metrics are best-effort
                pass

    def _quarantine_headroom(self, scores: Dict[str, Tuple[float, int]]
                             ) -> int:
        """How many MORE workers may enter quarantine right now."""
        scored = sum(1 for _, n in scores.values()
                     if n >= self.cfg.min_samples)
        cap = max(1, int(scored * self.cfg.max_quarantined_frac)) \
            if scored else 0
        held = sum(1 for wh in self._workers.values()
                   if wh.state in (QUARANTINED, PROBATION))
        return max(0, cap - held)

    def evaluate(self, now: Optional[float] = None) -> None:
        """Advance every worker's state machine against the current
        window. Called from heartbeat ingest; idempotent and cheap, so
        callers may also invoke it on demand (admin snapshot, tests)."""
        if not self.cfg.enabled:
            return
        now = time.time() if now is None else now
        with self._lock:
            scores = self._scores(now)
            baseline = self._baseline(scores)
            headroom = self._quarantine_headroom(scores)
            for wid, wh in self._workers.items():
                p95, n = scores[wid]
                ratio = (p95 / baseline) if baseline > 0.0 else 0.0
                judged = baseline > 0.0 and n >= self.cfg.min_samples
                if wh.state == HEALTHY:
                    if judged and ratio >= self.cfg.suspect_ratio:
                        self._transition(wid, wh, SUSPECT, now)
                elif wh.state == SUSPECT:
                    if not judged or ratio < self.cfg.clear_ratio:
                        self._transition(wid, wh, HEALTHY, now)
                    elif ratio >= self.cfg.suspect_ratio and \
                            now - wh.suspect_since >= self.cfg.grace_s:
                        if headroom > 0:
                            headroom -= 1
                            self._transition(wid, wh, QUARANTINED, now)
                elif wh.state == QUARANTINED:
                    if now - wh.since >= self.cfg.probation_after_s:
                        self._transition(wid, wh, PROBATION, now)
                elif wh.state == PROBATION:
                    fresh = self._window_values(wh, now,
                                                since=wh.probation_mark)
                    if len(fresh) >= min(self.cfg.min_samples,
                                         self.cfg.canary_budget):
                        fr = (_p95(fresh) / baseline) if baseline > 0.0 \
                            else 0.0
                        if baseline <= 0.0 or fr < self.cfg.clear_ratio:
                            self._transition(wid, wh, HEALTHY, now)
                        elif fr >= self.cfg.suspect_ratio:
                            # canaries came back slow: straight back to
                            # quarantine, probation timer restarts
                            self._transition(wid, wh, QUARANTINED, now)

    # -- routing reads --------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self.cfg.enabled

    def state(self, worker_id: str) -> str:
        with self._lock:
            wh = self._workers.get(worker_id)
            return wh.state if wh is not None else HEALTHY

    def is_quarantined(self, worker_id: str) -> bool:
        """Routing gate: True only for full quarantine — suspects still
        serve (grace window), probation admits via :meth:`allow_canary`."""
        if not self.cfg.enabled:
            return False
        return self.state(worker_id) == QUARANTINED

    def allow_canary(self, worker_id: str) -> bool:
        """Probation admission: grant one canary slot if the budget
        allows. Quarantined workers never pass; healthy/suspect always
        do (they are not rationed)."""
        if not self.cfg.enabled:
            return True
        with self._lock:
            wh = self._workers.get(worker_id)
            if wh is None or wh.state in (HEALTHY, SUSPECT):
                return True
            if wh.state == QUARANTINED:
                return False
            if wh.canaries >= self.cfg.canary_budget:
                return False
            wh.canaries += 1
            return True

    def admissible(self, worker_ids: List[str]) -> List[str]:
        """Filter a candidate list for placement: drop quarantined
        workers (probation workers stay listed — the canary budget is
        charged by :meth:`allow_canary` only at SELECTION time, so
        ranking them costs nothing). Falls back to the ORIGINAL list
        when filtering would empty it — availability beats purity
        (better a slow answer than none)."""
        if not self.cfg.enabled:
            return worker_ids
        kept = [w for w in worker_ids if not self.is_quarantined(w)]
        return kept if kept else worker_ids

    def hedge_delay_ms(self, now: Optional[float] = None) -> float:
        """p95-derived hedge fire delay: factor × fleet median p95 over
        the live window, clamped. With no baseline yet, the clamp floor
        (a sane constant) is the answer."""
        now = time.time() if now is None else now
        with self._lock:
            base = self._baseline(self._scores(now))
        raw = self.cfg.hedge_delay_factor * base
        return max(self.cfg.hedge_delay_min_ms,
                   min(self.cfg.hedge_delay_max_ms, raw))

    # -- introspection --------------------------------------------------------

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Admin/metrics view: per-worker state, score, sample count."""
        now = time.time() if now is None else now
        with self._lock:
            scores = self._scores(now)
            baseline = self._baseline(scores)
            return {
                "baseline_p95_ms": round(baseline, 3),
                "workers": {
                    wid: {
                        "state": wh.state,
                        "p95_ms": round(scores[wid][0], 3),
                        "samples": scores[wid][1],
                        "since": wh.since,
                        "canaries": wh.canaries,
                    }
                    for wid, wh in self._workers.items()
                },
            }

    def states(self) -> Dict[str, str]:
        with self._lock:
            return {wid: wh.state for wid, wh in self._workers.items()}
