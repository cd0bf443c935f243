"""Request flight recorder — per-request phase timelines, dependency-free.

The port's own copy of ``distributed_gpu_inference_tpu/runtime/flight.py``
(same event names, wire and merge), so a control plane merges a PyTorch
worker's timelines as it merges a JAX worker's.

Every job/stream that carries a ``trace_id`` accumulates phase events on
its path: worker poll pickup, batcher queue wait and admission-chunk
rounds, first token, preempt/resume, and completion. The recorder is
ADVISORY end to end:

- the hot path is one ``time.monotonic()`` read + one list append
  (:class:`Timeline.note`); serialization happens only at result/heartbeat
  boundaries (:meth:`Timeline.wire`);
- a request without a trace id (or with ``DGI_FLIGHT=0``) gets the
  shared :data:`NULL_TIMELINE`, whose ``note`` is a no-op;
- the recorder can NEVER fail or reorder a request: events are bounded by
  :data:`FLIGHT_EVENT_CAP` (excess is counted, not raised) and attrs are
  sanitized at wire time.

Worker-side events ship through the result payload (``result["timeline"]``)
and the heartbeat (``engine_stats["flight"]``).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

# per-request event cap: a runaway event source (e.g. one chunk-round event
# per ragged round on a 100k-token prompt) saturates at the cap and counts
# the overflow instead of growing without bound
FLIGHT_EVENT_CAP = 256

# the last slice of the cap is reserved for phase-boundary events: a
# saturating repeater (chunk rounds) must not crowd out the terminal
# events every phase derivation hangs off — without the reserve, a
# capped timeline would END mid-prefill and e2e/ttft/decode would be
# silently wrong instead of merely truncated
FLIGHT_BOUNDARY_RESERVE = 16
BOUNDARY_EVENTS = frozenset((
    "batcher.first_token", "batcher.completed",
    "worker.done", "worker.stream.done",
    "pd.prefill.done", "pd.decode.done",
    "handoff.commit", "handoff.rx_commit", "handoff.failed",
    "server.completed",
))

# canonical phase names — the /metrics histogram label set and the bench
# attribution columns. Order is the documentation/reading order.
PHASES = ("queue_wait", "prefill", "ttft", "handoff", "decode", "e2e")


def flight_enabled() -> bool:
    """Process-wide recorder switch (default ON — the recorder is cheap
    enough to be always-on; per-request opt-in is the ``trace_id``)."""
    return os.environ.get("DGI_FLIGHT", "").strip().lower() not in (
        "0", "false", "off", "no",
    )


class _NullTimeline:
    """The recorder-off stand-in: every hook is a no-op, so hot paths call
    ``tl.note(...)`` unconditionally without branching on a flag."""

    __slots__ = ()
    enabled = False
    trace_id = ""
    events: List[Any] = []
    dropped = 0

    def note(self, name: str, **attrs: Any) -> None:
        pass

    def note_at(self, name: str, ts: float, **attrs: Any) -> None:
        pass

    def extend_at(self, events: Any) -> None:
        pass

    def wire(self, done: bool = False) -> Optional[Dict[str, Any]]:
        return None


NULL_TIMELINE = _NullTimeline()


def _safe_attrs(attrs: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """JSON-safe scalar attrs only — the wire rides job results and
    heartbeats, and one exotic value must not poison either channel."""
    if not attrs:
        return None
    out: Dict[str, Any] = {}
    for k, v in attrs.items():
        if v is None or isinstance(v, (bool, int, float)):
            out[str(k)] = v
        else:
            out[str(k)] = str(v)[:128]
    return out or None


class Timeline:
    """Per-request event accumulator (one per traced job/stream).

    Events are recorded as monotonic offsets from a wall-clock anchor
    captured at construction: intra-process ordering can never go
    backwards under a wall-clock step, while the wire format converts to
    wall-clock timestamps so timelines from different hosts merge on a
    shared (skew-tolerant, see ``merge_events``) axis.
    """

    __slots__ = ("trace_id", "source", "cap", "dropped",
                 "_wall0", "_mono0", "events")
    enabled = True

    def __init__(self, trace_id: str, source: str = "",
                 cap: int = FLIGHT_EVENT_CAP) -> None:
        self.trace_id = str(trace_id)
        self.source = str(source)
        self.cap = int(cap)
        self.dropped = 0
        self._wall0 = time.time()
        self._mono0 = time.monotonic()
        # [(name, wall_ts, attrs-or-None), ...]
        self.events: List[Any] = []

    # -- hot path ----------------------------------------------------------

    def _room_for(self, name: str) -> bool:
        n = len(self.events)
        if n >= self.cap:
            return False
        reserve = min(FLIGHT_BOUNDARY_RESERVE, self.cap // 2)
        if n >= self.cap - reserve and name not in BOUNDARY_EVENTS:
            return False
        return True

    def note(self, name: str, **attrs: Any) -> None:
        """Record one event NOW. List append + monotonic read; never
        raises (the recorder must never fail a request)."""
        if not self._room_for(name):
            self.dropped += 1
            return
        self.events.append(
            (name, self._wall0 + (time.monotonic() - self._mono0),
             attrs or None)
        )

    # -- boundary helpers --------------------------------------------------

    def note_at(self, name: str, ts: float, **attrs: Any) -> None:
        """Record one event at an explicit wall-clock timestamp (a
        boundary observed elsewhere — the poll pickup stamp, an engine
        slot's first-token time, a handoff receiver's commit)."""
        if not self._room_for(name):
            self.dropped += 1
            return
        try:
            self.events.append((name, float(ts), attrs or None))
        except (TypeError, ValueError):
            pass

    def extend_at(self, events: Any) -> None:
        """Adopt ``[(name, wall_ts), ...]`` pairs recorded by a component
        that has no timeline of its own (e.g. the HandoffReceiver, which
        knows only the session key). Malformed entries are skipped."""
        if not events:
            return
        for ev in events:
            try:
                self.note_at(str(ev[0]), float(ev[1]))
            except (TypeError, ValueError, IndexError):
                continue

    def wire(self, done: bool = False) -> Optional[Dict[str, Any]]:
        """Serialize for the result/heartbeat channel. Events are shipped
        as the FULL list each time — the server-side merge unions events
        per source keyed by (name, timestamp), so duplicate delivery (a
        heartbeat retried, a result replayed) is idempotent by
        construction."""
        if not self.events:
            return None
        out: Dict[str, Any] = {
            "trace_id": self.trace_id,
            "events": [
                [name, round(ts, 6), _safe_attrs(attrs) if attrs else None]
                for name, ts, attrs in self.events
            ],
        }
        if self.source:
            out["source"] = self.source
        if self.dropped:
            out["dropped"] = int(self.dropped)
        if done:
            out["done"] = True
        return out


def timeline_for(params: Any, source: str = "") -> Any:
    """A :class:`Timeline` for the request iff its params carry a
    ``trace_id`` and the process-wide recorder is enabled; the shared
    no-op :data:`NULL_TIMELINE` otherwise (zero per-request cost)."""
    if not isinstance(params, dict):
        return NULL_TIMELINE
    tid = params.get("trace_id")
    if not tid or not isinstance(tid, str) or not flight_enabled():
        return NULL_TIMELINE
    return Timeline(tid, source=source)


# ---------------------------------------------------------------------------
# merge + phase derivation (server-side, and the bench's client-side reader)
# ---------------------------------------------------------------------------


def merge_events(sources: Dict[str, List[Any]]) -> List[Dict[str, Any]]:
    """Merge per-source event lists into ONE causally-ordered timeline.

    Sort by wall timestamp (source name, then within-source order break
    ties deterministically), then clamp each timestamp to be >= its
    predecessor: the merged view is monotonically ordered even when the
    sources' clocks are skewed. Clamping is display-side only — the
    per-source lists keep their raw timestamps."""
    rows: List[Any] = []
    for src in sorted(sources):
        for i, ev in enumerate(sources[src] or []):
            try:
                name = str(ev[0])
                ts = float(ev[1])
            except (TypeError, ValueError, IndexError):
                continue
            attrs = ev[2] if len(ev) > 2 else None
            rows.append((ts, str(src), i, name, attrs))
    rows.sort(key=lambda r: (r[0], r[1], r[2]))
    out: List[Dict[str, Any]] = []
    prev = None
    for ts, src, _i, name, attrs in rows:
        if prev is not None and ts < prev:
            ts = prev
        prev = ts
        row: Dict[str, Any] = {"event": name, "ts": round(ts, 6),
                               "source": src}
        if isinstance(attrs, dict) and attrs:
            row["attrs"] = attrs
        out.append(row)
    return out


def _first(times: Dict[str, float], *names: str) -> Optional[float]:
    for n in names:
        if n in times:
            return times[n]
    return None


def phase_durations(merged: List[Dict[str, Any]]) -> Dict[str, float]:
    """Derive the canonical phase durations (seconds) from a merged
    timeline. Every phase is optional — only boundaries actually present
    yield a duration, and a nonsensical (negative) span is dropped rather
    than reported. The event names consumed here are the canonical table
    in docs/observability.md."""
    if not merged:
        return {}
    first: Dict[str, float] = {}
    last: Dict[str, float] = {}
    for ev in merged:
        name, ts = ev["event"], float(ev["ts"])
        first.setdefault(name, ts)
        last[name] = ts
    start = float(merged[0]["ts"])
    end = float(merged[-1]["ts"])
    out: Dict[str, float] = {}

    def put(phase: str, t0: Optional[float], t1: Optional[float]) -> None:
        if t0 is not None and t1 is not None and t1 >= t0:
            out[phase] = t1 - t0

    # queue wait: worker-side batcher wait preferred (the contended
    # resource), server-side submit→claim wait otherwise (queued path)
    put("queue_wait",
        _first(first, "batcher.enqueued", "server.submitted"),
        _first(first, "batcher.admitted", "server.claimed"))
    put("prefill",
        _first(first, "pd.prefill.start", "batcher.admitted"),
        _first(first, "pd.prefill.done", "batcher.first_token"))
    put("ttft", start,
        _first(first, "batcher.first_token", "pd.prefill.done"))
    # sender notes handoff.begin/commit, the receiving worker's data
    # plane notes handoff.rx_begin/rx_commit: the phase opens at the
    # FIRST begin either side observed and closes at the LAST commit
    h0 = _first(first, "handoff.begin", "handoff.rx_begin")
    h1 = _first(last, "handoff.commit", "handoff.rx_commit") \
        if ("handoff.commit" in last or "handoff.rx_commit" in last) \
        else None
    if h1 is not None and "handoff.commit" in last \
            and "handoff.rx_commit" in last:
        h1 = max(last["handoff.commit"], last["handoff.rx_commit"])
    put("handoff", h0, h1)
    put("decode",
        _first(first, "pd.decode.start", "batcher.first_token"),
        _first(last, "pd.decode.done", "batcher.completed"))
    put("e2e", start, end)
    return out
