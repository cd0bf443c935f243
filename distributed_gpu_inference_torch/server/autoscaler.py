"""Brownout-driven replica autoscaling.

Degradation is *measurable* — SLO-in-window, goodput and
time-to-recover ride the brownout bench and ``/metrics``. This module
makes the fleet *act* on those measurements:

- **Scale out on a projected SLO miss.** The controller keeps a sliding
  window of per-request SLO samples (did this request meet its latency
  bound?) and a linear trend over the window. Because a new replica
  takes a measured cold-start time to serve (engine build + compile +
  registration), the decision uses the SLO *projected one cold-start
  ahead*: by the time the replica is useful the window will have moved —
  scaling on the current value alone is always one cold-start late.
- **Measured cold start as lead time.** Every scale-out is timed from
  the decision to the replica's first served request
  (:meth:`note_scale_out_started` / :meth:`note_replica_serving`); the
  EMA feeds the projection AND is published
  (``autoscaler_cold_start_seconds``) so the lead time in the math is
  the lead time on the floor, not a config guess.
- **Scale in on sustained headroom only.** The SLO comfortably above
  target AND measured utilization low for ``headroom_ticks``
  consecutive ticks — a single quiet tick after a burst must not
  shrink the fleet straight back into the next brownout (cooldowns
  bound flapping in both directions).

The controller is deliberately fleet-agnostic: it consumes observations
and emits decisions (``scale_out`` / ``scale_in`` / ``hold``); the
harness that owns real replicas (``testing/harness.py``
:class:`FleetAutoscaler` for :class:`LiveFleet`, a k8s operator in a
real deployment) executes them. Decisions and their inputs land in
``/metrics`` (``autoscaler_decisions_total``,
``autoscaler_target_replicas``, ``autoscaler_slo_in_window``,
``autoscaler_cold_start_seconds``).

The port's copy of ``distributed_gpu_inference_tpu/server/autoscaler.py``, on the
standard library and the port's own modules.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Deque, Optional, Tuple
from collections import deque


@dataclass
class AutoscalerConfig:
    # per-request SLO bound the window samples are judged against (the
    # caller may also pre-judge and feed booleans; then this is unused)
    slo_latency_ms: float = 2000.0
    # scale out when the PROJECTED fraction of in-SLO requests drops
    # below this target
    slo_target: float = 0.9
    window_s: float = 10.0
    min_samples: int = 5          # no decisions on statistical noise
    min_replicas: int = 1
    max_replicas: int = 8
    # scale in only after this many consecutive ticks of headroom
    # (SLO >= headroom_slo AND utilization <= headroom_utilization)
    headroom_ticks: int = 3
    headroom_slo: float = 0.98
    headroom_utilization: float = 0.5
    scale_out_cooldown_s: float = 2.0
    scale_in_cooldown_s: float = 10.0
    # cold-start prior before the first measurement; the EMA replaces it
    default_cold_start_s: float = 5.0
    cold_start_ema: float = 0.5   # weight of the newest measurement


class BrownoutAutoscaler:
    """Sliding-window SLO controller. Thread-safe: the traffic harness
    calls :meth:`observe` from request threads while a ticker thread
    calls :meth:`tick`."""

    def __init__(self, cfg: Optional[AutoscalerConfig] = None,
                 metrics: Optional[Any] = None) -> None:
        self.cfg = cfg or AutoscalerConfig()
        self.metrics = metrics
        self._lock = threading.Lock()
        # (ts, in_slo) per completed request
        self._samples: "Deque[Tuple[float, bool]]" = deque()
        self._last_out = -float("inf")
        self._last_in = -float("inf")
        self._headroom_streak = 0
        self._cold_start_s = float(self.cfg.default_cold_start_s)
        self._out_started_at: Optional[float] = None
        self.stats = {"scale_out": 0, "scale_in": 0, "hold": 0,
                      "cold_starts_measured": 0}

    # -- observations ---------------------------------------------------------

    def observe(self, latency_ms: Optional[float] = None,
                in_slo: Optional[bool] = None,
                now: Optional[float] = None) -> None:
        """One completed request: either the raw latency (judged against
        ``slo_latency_ms``) or a pre-judged boolean. Failed/shed requests
        should be fed ``in_slo=False`` — a shed request is an SLO miss
        from the client's chair."""
        now = time.time() if now is None else now
        if in_slo is None:
            in_slo = (latency_ms is not None
                      and latency_ms <= self.cfg.slo_latency_ms)
        with self._lock:
            self._samples.append((now, bool(in_slo)))
            self._trim(now)

    def note_scale_out_started(self, now: Optional[float] = None) -> None:
        """The caller began bringing a replica up (measure from the
        DECISION, not process exec — queue/registration time is part of
        the lead time the projection must cover)."""
        self._out_started_at = time.time() if now is None else now

    def note_replica_serving(self, now: Optional[float] = None) -> None:
        """The scaled-out replica served its first request: fold the
        measured cold start into the EMA lead time."""
        now = time.time() if now is None else now
        if self._out_started_at is None:
            return
        measured = max(0.0, now - self._out_started_at)
        self._out_started_at = None
        a = self.cfg.cold_start_ema
        self._cold_start_s = (1 - a) * self._cold_start_s + a * measured
        self.stats["cold_starts_measured"] += 1

    @property
    def cold_start_s(self) -> float:
        return self._cold_start_s

    # -- window math ----------------------------------------------------------

    def _trim(self, now: float) -> None:
        cutoff = now - self.cfg.window_s
        while self._samples and self._samples[0][0] < cutoff:
            self._samples.popleft()

    def slo_in_window(self, now: Optional[float] = None) -> Optional[float]:
        """Fraction of windowed requests inside the SLO bound; None when
        the window is under ``min_samples`` (no decision-grade signal)."""
        now = time.time() if now is None else now
        with self._lock:
            self._trim(now)
            n = len(self._samples)
            if n < self.cfg.min_samples:
                return None
            return sum(1 for _, ok in self._samples if ok) / n

    def projected_slo(self, now: Optional[float] = None) -> Optional[float]:
        """SLO one cold-start ahead: current window value plus the linear
        trend (second window half minus first window half, per second)
        extrapolated over the measured cold-start lead time, clamped to
        [0, 1]. A worsening trend therefore triggers scale-out BEFORE the
        current value crosses the target."""
        now = time.time() if now is None else now
        with self._lock:
            self._trim(now)
            n = len(self._samples)
            if n < self.cfg.min_samples:
                return None
            samples = list(self._samples)
        cur = sum(1 for _, ok in samples if ok) / n
        half = now - self.cfg.window_s / 2.0
        early = [ok for ts, ok in samples if ts < half]
        late = [ok for ts, ok in samples if ts >= half]
        if not early or not late:
            return cur
        e = sum(early) / len(early)
        l_ = sum(late) / len(late)
        slope_per_s = (l_ - e) / max(self.cfg.window_s / 2.0, 1e-6)
        return max(0.0, min(1.0, cur + slope_per_s * self._cold_start_s))

    # -- the decision ---------------------------------------------------------

    def tick(self, replicas: int, utilization: Optional[float] = None,
             now: Optional[float] = None) -> str:
        """One control tick → ``scale_out`` | ``scale_in`` | ``hold``.

        ``replicas`` is the CURRENT serving replica count (the caller's
        truth, incl. chaos kills — decisions and failures must compose);
        ``utilization`` in [0, 1] gates scale-in (None = unknown = never
        scale in on SLO alone)."""
        now = time.time() if now is None else now
        slo = self.slo_in_window(now)
        projected = self.projected_slo(now)
        action = "hold"
        if projected is not None and projected < self.cfg.slo_target \
                and replicas < self.cfg.max_replicas \
                and now - self._last_out >= self.cfg.scale_out_cooldown_s:
            action = "scale_out"
            self._last_out = now
            self._headroom_streak = 0
        else:
            headroom = (
                slo is not None and slo >= self.cfg.headroom_slo
                and utilization is not None
                and utilization <= self.cfg.headroom_utilization
            )
            self._headroom_streak = self._headroom_streak + 1 if headroom \
                else 0
            if self._headroom_streak >= self.cfg.headroom_ticks \
                    and replicas > self.cfg.min_replicas \
                    and now - self._last_in >= self.cfg.scale_in_cooldown_s \
                    and now - self._last_out >= self.cfg.scale_in_cooldown_s:
                # the scale-out cooldown also gates scale-in: shrinking
                # while a cold replica is still warming up would measure
                # its warmup as headroom
                action = "scale_in"
                self._last_in = now
                self._headroom_streak = 0
        self.stats[action] += 1
        target = replicas + (1 if action == "scale_out" else 0) \
            - (1 if action == "scale_in" else 0)
        if self.metrics is not None:
            try:
                self.metrics.record_autoscaler(
                    action, target_replicas=target,
                    # None (window below min_samples — e.g. EVERY request
                    # hanging) must not publish as a perfect 1.0: skip
                    # the gauge and let it hold its last honest value
                    slo_in_window=slo,
                    cold_start_s=self._cold_start_s,
                )
            except Exception:  # noqa: BLE001 — metrics must not gate
                pass
        return action


# ---------------------------------------------------------------------------
# predictive PD rebalance
# ---------------------------------------------------------------------------


@dataclass
class PredictiveRebalanceConfig:
    # off by default: tick() is a no-op and the PD pool behaves exactly
    # as the reactive-only build
    enabled: bool = False
    # preflip when the PROJECTED SLO drops below this; None inherits the
    # autoscaler's own slo_target (one knob, one truth)
    slo_target: Optional[float] = None
    # restore preflips only once projected SLO recovers ABOVE
    # target + hysteresis — a value hovering at the target must not flap
    # roles every tick
    hysteresis: float = 0.05
    # preflip only when the starved side's free capacity is below this
    # fraction of the donor side's: a projected miss with BALANCED pools
    # is an under-provisioned fleet (scale out), not a role imbalance
    imbalance_ratio: float = 0.5
    # between consecutive preflips
    cooldown_s: float = 5.0
    # bound how much of the donor side a streak of misses can convert
    max_preflips: int = 1


class PredictiveRebalancer:
    """Couples the brownout autoscaler's projected-SLO signal to PD role
    rebalancing: when the projection says the fleet will miss its target
    one cold-start from now AND one PD side is starved for capacity while
    the other has headroom, flip a donor worker to HYBRID *before* the
    starved queue melts down (the reactive ``role_rebalance`` in
    :class:`~.pd_scheduler.PrefillDecodeScheduler` only fires once a side
    is already dark). The same starved-side signal is returned to the
    scaler so a scale-out lands a replica of the role the
    projection says will be short.

    Advisory and reversible: a wrong prediction costs one worker serving
    hybrid for a few ticks — roles gate new assignments only, in-flight
    work is untouched, and recovery past target + hysteresis restores
    the configured roles."""

    def __init__(self, autoscaler: BrownoutAutoscaler, pd_scheduler: Any,
                 cfg: Optional[PredictiveRebalanceConfig] = None,
                 metrics: Optional[Any] = None) -> None:
        self.autoscaler = autoscaler
        self.pd = pd_scheduler
        self.cfg = cfg or PredictiveRebalanceConfig()
        self.metrics = metrics
        self._last_flip = -float("inf")
        self.stats = {"ticks": 0, "preflips": 0, "restores": 0,
                      "suggestions": 0}

    def _record(self, action: str) -> None:
        if self.metrics is not None:
            try:
                self.metrics.record_predictive_rebalance(action)
            except Exception:  # noqa: BLE001 — metrics must not gate
                pass

    def tick(self, now: Optional[float] = None) -> Optional[str]:
        """One control pass. Returns the PD role the NEXT scale-out
        should target (the projected-starved side), or None (no signal /
        disabled / balanced)."""
        if not self.cfg.enabled:
            return None
        now = time.time() if now is None else now
        self.stats["ticks"] += 1
        projected = self.autoscaler.projected_slo(now)
        target = (self.autoscaler.cfg.slo_target
                  if self.cfg.slo_target is None else self.cfg.slo_target)
        if projected is None:
            return None
        if projected >= target + self.cfg.hysteresis:
            if self.pd.restore_preflips():
                self.stats["restores"] += 1
                self._record("restore")
            return None
        if projected >= target:
            return None   # inside the hysteresis band: hold current shape
        cap = self.pd.capacity_by_role()
        pf, dc = int(cap.get("prefill") or 0), int(cap.get("decode") or 0)
        if pf == dc:
            return None   # balanced shortage → plain scale-out territory
        starved = "prefill" if pf < dc else "decode"
        starved_free, donor_free = (pf, dc) if starved == "prefill" \
            else (dc, pf)
        self.stats["suggestions"] += 1
        self._record("scale_out_role")
        if donor_free > 0 and \
                starved_free < self.cfg.imbalance_ratio * donor_free and \
                len(self.pd._preflipped) < max(0, self.cfg.max_preflips) and \
                now - self._last_flip >= self.cfg.cooldown_s:
            if self.pd.preflip_role(starved) is not None:
                self._last_flip = now
                self.stats["preflips"] += 1
                self._record("preflip")
        return starved
