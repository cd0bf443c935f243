"""Deterministic, seed-driven fault injection: the seams of the PyTorch port.

The port's own copy of the seam subset of
``distributed_gpu_inference_tpu/testing/faults.py``, with the same rule
kinds and site names, so one rule list drives a JAX worker and a port
worker alike. A :class:`FaultPlan` is a seeded RNG plus an ordered list of
:class:`FaultRule` s; the seams below consult the installed plan on every
hit and the FIRST matching rule that fires decides the effect. Rules match
by glob against a dotted site name (``worker.api.request``) and optionally
against call context (``match={"path": "*/complete"}``).

Determinism: the same seed, rules and call sequence fire identically and
record an identical ``trace``.

Zero cost when disabled: every seam starts with ``if _ACTIVE is None``.

Fleet chaos: :class:`FleetFaultPlan` is the seeded schedule of whole-replica
events (kills, restarts, blackouts, partitions, storms, gray and durable-tier
faults) that ``testing/harness.py`` ``LiveFleet`` executes, generated as the
JAX package generates it, so a seed names one schedule in both packages.
``python -m distributed_gpu_inference_torch.testing.faults --replay SEED``
(with ``--pd``, ``--planes``, ``--gray`` or ``--io`` for the other suites'
geometry) prints it.

Sites in the port: ``worker.api.request`` (:func:`wrap_http`),
``worker.direct.request`` (:func:`http_reject`), ``worker.direct.stream``
(:func:`stream_cut`), ``kv.block.alloc`` (:func:`kv_pressure`),
``io.spill.host.get`` / ``.put`` and ``io.file.write`` (:func:`io_fault`),
``io.spill.remote.get`` / ``.put`` (:func:`io_bytes`),
``io.spill.redis.get`` / ``.put`` (:func:`io_fault`), and on the KV
handoff ``kv.receiver.message`` (:func:`mutate_bytes`),
``io.handoff.stage`` (:func:`io_bytes`), ``worker.pd.push`` and
``worker.kv.pull`` (:func:`wrap_http`), on a pipeline session's hops
``comm.session.forward`` (:func:`wrap_http`), and on the control plane's
side ``server.store.execute`` and ``server.store.checkpoint``
(:func:`store_fault`) and the SDK's
``sdk.client.request`` (:func:`wrap_http`).

=========  =======================================================
kind       effect at a seam
=========  =======================================================
drop       HTTP: raise a transport error. ``where="response"``
           performs the call first (delivered, response lost).
           Stream: the stream dies here. IO: ``OSError``.
           Store: silently skip the mutation (lost write).
delay      sleep ``delay_s`` then proceed.
error      HTTP: synthesize a ``status`` response without calling;
           server seam: answer ``status``. IO: ``OSError``.
           Store: raise ``sqlite3.OperationalError``.
truncate   byte seams: keep only the first ``cut`` bytes.
corrupt    byte seams: flip one byte mid-payload.
duplicate  HTTP: perform the call twice, return the second response.
flap       a drop for the next ``times`` hits.
reorder    stream filter: hold the message, deliver it after the next.
pressure   KV allocator seam: this allocation sees a pool with zero
           free blocks (``OutOfBlocksError`` at the call site).
=========  =======================================================
"""

from __future__ import annotations

import fnmatch
import random
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field, replace
from typing import (
    Any,
    Callable,
    Dict,
    Iterable,
    Iterator,
    List,
    Optional,
    Sequence,
    Tuple,
)

_KINDS = {
    "drop", "delay", "error", "truncate", "duplicate", "flap", "reorder",
    "pressure", "corrupt",
}


@dataclass
class FaultRule:
    """One injection rule; see the module docstring for kind semantics."""

    site: str                      # glob over the dotted site name
    kind: str
    prob: float = 1.0              # per-hit firing probability (seeded RNG)
    after: int = 0                 # skip the first N matching hits
    times: Optional[int] = None    # max firings (None = unlimited)
    where: str = "request"         # drop: "request" | "response"
    status: int = 500              # error: synthesized HTTP status
    delay_s: float = 0.0
    cut: int = 64                  # truncate: bytes kept
    match: Dict[str, str] = field(default_factory=dict)  # ctx key → glob
    # live counters, owned by the plan (plans copy rules on construction
    # so one rule list can seed many replays)
    hits: int = 0
    fired: int = 0

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (one of {sorted(_KINDS)})"
            )
        if self.where not in ("request", "response"):
            raise ValueError("where must be 'request' or 'response'")


def flap(site: str, times: int = 1, after: int = 0, **kw: Any) -> FaultRule:
    """Sugar: the site is hard-down for the next ``times`` hits."""
    return FaultRule(site=site, kind="flap", prob=1.0, times=times,
                     after=after, **kw)


class FaultInjected(ConnectionError):
    """Raised at non-HTTP seams for injected drops."""


class FaultPlan:
    """Seeded rule set + trace. Install with :func:`install` /
    :func:`active`; seams consult it through the module-level helpers."""

    def __init__(self, seed: int = 0,
                 rules: Sequence[FaultRule] = ()) -> None:
        self.seed = seed
        # private copies: firing mutates counters, and a scenario reuses
        # one rule list across seeded replays
        self.rules: List[FaultRule] = [
            replace(r, hits=0, fired=0) for r in rules
        ]
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.trace: List[Tuple[str, str, str]] = []

    def fire(self, site: str, **ctx: Any) -> Optional[FaultRule]:
        """The first rule that fires for this hit, else None. Thread-safe;
        every firing is appended to ``trace``."""
        with self._lock:
            for r in self.rules:
                if not fnmatch.fnmatchcase(site, r.site):
                    continue
                if any(
                    not fnmatch.fnmatchcase(str(ctx.get(k, "")), pat)
                    for k, pat in r.match.items()
                ):
                    continue
                r.hits += 1
                if r.hits <= r.after:
                    continue
                if r.times is not None and r.fired >= r.times:
                    continue
                if r.prob < 1.0 and self._rng.random() >= r.prob:
                    continue
                r.fired += 1
                self.trace.append((site, r.kind, _ctx_str(ctx)))
                return r
        return None

    def add_rule(self, rule: FaultRule) -> FaultRule:
        """Append a rule to a LIVE plan (counters zeroed, private copy)."""
        r = replace(rule, hits=0, fired=0)
        with self._lock:
            self.rules.append(r)
        return r

    def remove_rule(self, rule: FaultRule) -> None:
        """Disarm a rule returned by :meth:`add_rule`."""
        with self._lock:
            try:
                self.rules.remove(rule)
            except ValueError:
                pass

    # -- stream filtering (transport-level loss/reorder/dup) ----------------

    def filter_stream(
        self,
        site: str,
        messages: Iterable[bytes],
        ctx_fn: Optional[Callable[[bytes], Dict[str, Any]]] = None,
    ) -> Iterator[bytes]:
        """Model an unreliable in-flight message sequence: apply drop /
        duplicate / reorder / truncate rules to each message of ``site``.
        ``ctx_fn(msg)`` supplies per-message match context (e.g. the stream
        message kind) so rules can target, say, only ``commit`` frames.

        ``reorder`` holds the message and releases it right after the next
        DELIVERED message (messages dropped in between don't flush it, and
        consecutive reorders queue up in order); anything still held when
        the sequence ends is delivered last."""
        held: List[bytes] = []
        for msg in messages:
            ctx = ctx_fn(msg) if ctx_fn is not None else {}
            rule = self.fire(site, **ctx)
            if rule is None:
                out = [msg]
            elif rule.kind in ("drop", "flap"):
                out = []
            elif rule.kind == "duplicate":
                out = [msg, msg]
            elif rule.kind == "truncate":
                out = [msg[: rule.cut]]
            elif rule.kind == "reorder":
                held.append(msg)
                continue
            elif rule.kind == "delay":
                time.sleep(rule.delay_s)
                out = [msg]
            else:
                raise ValueError(
                    f"rule kind {rule.kind!r} unsupported in filter_stream"
                )
            for m in out:
                yield m
                if held:
                    yield from held
                    held = []
        yield from held


def _ctx_str(ctx: Dict[str, Any]) -> str:
    return ",".join(f"{k}={ctx[k]}" for k in sorted(ctx))


# ---------------------------------------------------------------------------
# plan installation
# ---------------------------------------------------------------------------

_ACTIVE: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> FaultPlan:
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError(
            "a FaultPlan is already installed — uninstall it first "
            "(leaked plan from a previous scenario?)"
        )
    _ACTIVE = plan
    return plan


def uninstall() -> None:
    global _ACTIVE
    _ACTIVE = None


def current() -> Optional[FaultPlan]:
    return _ACTIVE


@contextmanager
def active(plan: FaultPlan) -> Iterator[FaultPlan]:
    install(plan)
    try:
        yield plan
    finally:
        uninstall()


# ---------------------------------------------------------------------------
# injection seams (all no-ops when no plan is installed)
# ---------------------------------------------------------------------------


def wrap_http(site: str, call: Callable[[], Any], **ctx: Any) -> Any:
    """HTTP client seam: ``call`` performs the real request and returns a
    ``worker/api_client.py`` ``Response``. Injected effects surface as the
    network would show them — a drop raises ``ConnectionError`` (a
    transport error), an error answers ``status`` — so the caller's retry
    ladder runs."""
    plan = _ACTIVE
    if plan is None:
        return call()
    rule = plan.fire(site, **ctx)
    if rule is None:
        return call()
    if rule.kind == "delay":
        time.sleep(rule.delay_s)
        return call()
    if rule.kind in ("drop", "flap"):
        if rule.where == "response":
            call()  # delivered server-side; the response is lost
        raise FaultInjected(f"fault injected: {rule.kind} at {site}")
    if rule.kind == "error":
        import json

        from distributed_gpu_inference_torch.worker.api_client import Response

        return Response(rule.status, json.dumps(
            {"detail": f"fault injected at {site}"}).encode())
    if rule.kind == "duplicate":
        call()
        return call()
    raise ValueError(f"rule kind {rule.kind!r} unsupported at HTTP seam")


def store_fault(site: str, **ctx: Any) -> bool:
    """Store mutation seam. Returns True when the write must be SKIPPED
    (injected lost write); raises ``sqlite3.OperationalError`` for injected
    backend errors."""
    plan = _ACTIVE
    if plan is None:
        return False
    rule = plan.fire(site, **ctx)
    if rule is None:
        return False
    if rule.kind == "delay":
        time.sleep(rule.delay_s)
        return False
    if rule.kind == "drop":
        return True
    if rule.kind in ("error", "flap"):
        import sqlite3

        raise sqlite3.OperationalError(f"fault injected at {site}")
    raise ValueError(f"rule kind {rule.kind!r} unsupported at store seam")


def kv_pressure(site: str, num_free: int, **ctx: Any) -> bool:
    """KV block-allocator seam (``PagedKVCacheManager._pop_free_block``):
    True when THIS allocation must behave as pool-exhausted — the caller
    raises ``OutOfBlocksError`` as a full pool would, driving the engine's
    preempt → spill → resume path."""
    plan = _ACTIVE
    if plan is None:
        return False
    rule = plan.fire(site, num_free=num_free, **ctx)
    if rule is None:
        return False
    if rule.kind == "pressure":
        return True
    if rule.kind == "delay":
        time.sleep(rule.delay_s)
        return False
    raise ValueError(f"rule kind {rule.kind!r} unsupported at kv seam")


def stream_cut(site: str, **ctx: Any) -> bool:
    """Server-push stream seam (worker SSE): True when the stream must die
    ABRUPTLY at this event — the handler hard-closes the socket, as a
    crashed worker would. ``after=N`` lets exactly N events through."""
    plan = _ACTIVE
    if plan is None:
        return False
    rule = plan.fire(site, **ctx)
    if rule is None:
        return False
    if rule.kind in ("drop", "flap"):
        return True
    if rule.kind == "delay":
        time.sleep(rule.delay_s)
        return False
    raise ValueError(f"rule kind {rule.kind!r} unsupported at stream seam")


def http_reject(site: str, **ctx: Any) -> Optional[int]:
    """Server-side rejection seam (worker direct endpoints): ``error`` →
    the rule's status (answer it: a flaky replica); ``drop``/``flap`` → 0
    (cut the connection); ``delay`` sleeps and passes; None = serve."""
    plan = _ACTIVE
    if plan is None:
        return None
    rule = plan.fire(site, **ctx)
    if rule is None:
        return None
    if rule.kind == "error":
        return rule.status
    if rule.kind in ("drop", "flap"):
        return 0
    if rule.kind == "delay":
        time.sleep(rule.delay_s)
        return None
    raise ValueError(f"rule kind {rule.kind!r} unsupported at reject seam")


def mutate_bytes(site: str, data: bytes, **ctx: Any) -> bytes:
    """Byte-message seam (the KV handoff receiver): ``truncate`` keeps the
    first ``cut`` bytes of the message, ``drop``/``flap`` lose it
    (:class:`FaultInjected`, which the data plane answers like any receive
    failure), ``delay`` sleeps and passes."""
    plan = _ACTIVE
    if plan is None:
        return data
    rule = plan.fire(site, size=len(data), **ctx)
    if rule is None:
        return data
    if rule.kind == "truncate":
        return data[: rule.cut]
    if rule.kind in ("drop", "flap"):
        raise FaultInjected(f"fault injected: {rule.kind} at {site}")
    if rule.kind == "delay":
        time.sleep(rule.delay_s)
        return data
    raise ValueError(f"rule kind {rule.kind!r} unsupported at byte seam")


def io_fault(site: str, **ctx: Any) -> None:
    """Durable-IO seam (host spill tier, the remote store's socket, file
    writes): injected failures surface as ``OSError``, as a full disk or a
    flaky device raises; ``delay`` models a browning-out device."""
    plan = _ACTIVE
    if plan is None:
        return
    rule = plan.fire(site, **ctx)
    if rule is None:
        return
    if rule.kind == "delay":
        time.sleep(rule.delay_s)
        return
    if rule.kind in ("drop", "flap", "error"):
        raise OSError(f"fault injected: {rule.kind} at {site}")
    raise ValueError(f"rule kind {rule.kind!r} unsupported at io seam")


def io_bytes(site: str, data: Optional[bytes],
             **ctx: Any) -> Optional[bytes]:
    """Byte-carrying durable-IO seam (remote spill tier): ``truncate``
    models a torn write or short read, ``corrupt`` flips one byte
    mid-payload (bit rot the entry checksum must catch),
    ``error``/``drop``/``flap`` raise ``OSError``. ``data`` may be None (a
    read that missed): mutating kinds pass it through."""
    plan = _ACTIVE
    if plan is None:
        return data
    rule = plan.fire(site, size=len(data) if data is not None else 0, **ctx)
    if rule is None:
        return data
    if rule.kind == "delay":
        time.sleep(rule.delay_s)
        return data
    if rule.kind in ("drop", "flap", "error"):
        raise OSError(f"fault injected: {rule.kind} at {site}")
    if data is None:
        return None
    if rule.kind == "truncate":
        return data[: rule.cut]
    if rule.kind == "corrupt":
        if not data:
            return data
        i = len(data) // 2
        return data[:i] + bytes([data[i] ^ 0xFF]) + data[i + 1:]
    raise ValueError(f"rule kind {rule.kind!r} unsupported at io seam")


# ---------------------------------------------------------------------------
# fleet-level chaos: seeded schedules of whole-replica events
# ---------------------------------------------------------------------------

# kinds a generated schedule draws from. ``restart`` never appears here —
# every ``kill`` emits its own paired restart event, so a schedule can
# never leave a replica dead forever by construction.
FLEET_EVENT_KINDS = ("kill", "blackout", "partition", "pressure", "slow")

# handoff-targeted kinds (round 11 — PD split fleets): chaos on the
# prefill→decode KV stream itself rather than on whole replicas.
# ``handoff_partition`` cuts a worker's outbound KV pushes (sender-side
# flap on ``worker.pd.push``), ``handoff_corrupt`` truncates received
# handoff messages in transit (``kv.receiver.message``, fleet-wide,
# probabilistic), ``handoff_delay`` injects per-piece latency so send
# timeouts + retries fire. Kept OUT of FLEET_EVENT_KINDS so round-9
# seeds keep regenerating their exact historical schedules.
HANDOFF_EVENT_KINDS = ("handoff_partition", "handoff_corrupt",
                       "handoff_delay")

# control-plane-targeted kinds (round 15 — replicated planes): chaos on the
# plane REPLICAS themselves rather than on workers. ``plane_kill``
# hard-stops one plane server mid-traffic (every ``plane_kill`` emits its
# own paired ``plane_restart``, mirroring worker kill/restart),
# ``plane_partition`` makes one plane unreachable (requests to it fail at
# the transport) while the process stays up, ``plane_slow`` taxes every
# request that plane answers with injected latency. The ``worker`` field of
# a plane event indexes the PLANE cohort, not the worker fleet. Kept OUT of
# FLEET_EVENT_KINDS so historical seeds keep regenerating their exact
# schedules.
PLANE_EVENT_KINDS = ("plane_kill", "plane_partition", "plane_slow")

# gray-failure kinds (round 18 — slow-worker quarantine): the worker is
# ALIVE and heartbeating the whole time, just wrong. ``degrade`` is a
# persistent slowdown (every direct request/stream of the replica pays
# ``delay_s`` for the WHOLE window — the 10x-slow worker that passes
# health checks), ``jitter`` is the probabilistic version (each event
# pays ``delay_s`` at ``prob`` — a noisy NIC / contended host), and
# ``flaky`` answers direct requests with a 5xx at ``prob`` while the
# process stays up. Kept OUT of FLEET_EVENT_KINDS so historical seeds
# keep regenerating their exact schedules.
GRAY_EVENT_KINDS = ("degrade", "jitter", "flaky")

# durable-tier kinds (round 19 — IO-fault immunity): storms on the bytes
# we PERSIST rather than the processes/links that move them. ``disk_full``
# fails every durable write fleet-wide (store mutations, spill puts,
# checkpoint saves, file writes) while reads keep serving; ``io_error``
# fails spill-tier/checkpoint IO probabilistically in BOTH directions;
# ``io_slow`` taxes every spill/checkpoint op with injected latency (the
# browning-out device the per-tier breaker exists to fence); ``corrupt_
# read`` flips bytes in spill entries read back (the entry CRC must catch
# it and quarantine, never poison a request); ``torn_write`` persists only
# a prefix of written spill entries (detected at read time the same way).
# Kept OUT of FLEET_EVENT_KINDS so historical seeds keep regenerating
# their exact schedules.
IO_CHAOS_KINDS = ("disk_full", "io_error", "io_slow", "corrupt_read",
                  "torn_write")
ALL_FLEET_EVENT_KINDS = (
    FLEET_EVENT_KINDS + HANDOFF_EVENT_KINDS + PLANE_EVENT_KINDS
    + GRAY_EVENT_KINDS + IO_CHAOS_KINDS
)

# the canonical suite/CLI geometry: ``--replay`` must reconstruct the EXACT
# schedule a failing suite seed ran, so both sides share these defaults
FLEET_CHAOS_WORKERS = 2
FLEET_CHAOS_DURATION_S = 6.0

# PD-split chaos suite geometry (tests/test_pd_chaos.py): 3 workers
# (1 prefill + 2 decode), kills + partitions + every handoff kind —
# ``--replay SEED --pd`` reconstructs these schedules
PD_CHAOS_WORKERS = 3
PD_CHAOS_KINDS = ("kill", "partition") + HANDOFF_EVENT_KINDS

# plane chaos suite geometry (tests/test_plane_chaos.py): 2 plane replicas
# over one shared job store, 2 workers, plane-level events mixed with
# worker kills so plane death lands mid-claim / mid-heartbeat / mid-stream
# — ``--replay SEED --planes`` reconstructs these schedules
PLANE_CHAOS_PLANES = 2
PLANE_CHAOS_WORKERS = 2
PLANE_CHAOS_KINDS = PLANE_EVENT_KINDS + ("kill",)

# gray-chaos suite geometry (tests/test_gray_chaos.py): 3 workers so the
# quarantine of one degraded replica still leaves a 2-replica serving
# fleet, gray kinds composed with clean kills — ``--replay SEED --gray``
# reconstructs these schedules
GRAY_CHAOS_WORKERS = 3
GRAY_CHAOS_KINDS = GRAY_EVENT_KINDS + ("kill",)

# io-chaos suite geometry (tests/test_io_chaos.py): 2 workers with spill
# tiers + per-token checkpoints enabled, every io kind composed with clean
# kills so a crash can land right after a window of failed/torn/corrupt
# durable writes — ``--replay SEED --io`` reconstructs these schedules
IO_CHAOS_WORKERS = 2
IO_CHAOS_SUITE_KINDS = IO_CHAOS_KINDS + ("kill",)


@dataclass(frozen=True)
class FleetEvent:
    """One scheduled fleet-level event.

    =========  ==========================================================
    kind       effect in :class:`~..testing.harness.LiveFleet`
    =========  ==========================================================
    kill       hard-stop a replica's servers/threads mid-traffic (no
               drain, no offline call) — a crashed process
    restart    rebuild the replica cold and re-register it on the SAME
               machine fingerprint (restart-with-reregistration)
    blackout   heartbeats stop for ``duration_s`` while the replica keeps
               serving — the one-directional partition that gets a LIVE
               worker swept offline
    partition  bidirectional: heartbeats stop AND the replica's direct
               endpoint refuses traffic for ``duration_s``
    pressure   fleet-wide KV pressure storm: ``kv.block.alloc`` fires
               pool-exhausted for ``duration_s`` at ``prob``
    slow       latency injection: every direct request/stream event of
               the replica sleeps ``delay_s`` for ``duration_s``
    handoff_partition  the worker's outbound KV handoff pushes hard-drop
               for ``duration_s`` (``worker.pd.push`` flap) — the
               prefill→decode stream is cut while both replicas live
    handoff_corrupt    received handoff messages truncate in transit at
               ``prob`` for ``duration_s`` (``kv.receiver.message``,
               fleet-wide) — pieces poison their session, commits abort
    handoff_delay      every outbound handoff piece of the worker pays
               ``delay_s`` for ``duration_s`` — send timeouts/retries
    plane_kill         hard-stop plane replica ``worker`` (index into the
               PLANE cohort) mid-traffic — a crashed control plane
    plane_restart      rebuild the killed plane over the SAME shared job
               store and rejoin the cluster
    plane_partition    every request to plane ``worker`` fails at the
               transport for ``duration_s`` while the process stays up
    plane_slow         every request plane ``worker`` answers pays
               ``delay_s`` for ``duration_s``
    degrade    persistent gray slowdown: every direct request/stream
               event of the replica pays ``delay_s`` for ``duration_s``
               (stretched to ≥ half the run) while heartbeats stay
               healthy — the alive-but-10x-slow worker
    jitter     probabilistic gray slowdown: each direct request/stream
               event of the replica pays ``delay_s`` at ``prob`` for
               ``duration_s``
    flaky      probabilistic 5xx: the replica's direct requests answer
               HTTP 500 at ``prob`` for ``duration_s`` while the
               process (and its heartbeats) stay up
    disk_full  fleet-wide: every durable WRITE fails for ``duration_s``
               (store INSERT/UPDATE, spill puts, checkpoint saves, file
               writes raise like a full disk) while reads keep serving
    io_error   fleet-wide: spill-tier and checkpoint IO fails at
               ``prob`` in both directions for ``duration_s``
    io_slow    fleet-wide: every spill/checkpoint op pays ``delay_s``
               for ``duration_s`` — the browning-out device the
               per-tier breaker fences off the serving path
    corrupt_read  spill entries read back bit-flipped at ``prob`` for
               ``duration_s`` — the entry CRC quarantines, serving
               falls back to the next tier or recompute
    torn_write    spill writes persist only a prefix at ``prob`` for
               ``duration_s`` — detected by the CRC at read time
    =========  ==========================================================
    """

    at_s: float            # offset from chaos start
    kind: str
    worker: int            # fleet member index; -1 = fleet-wide.
    #                        plane_* events index the plane cohort instead
    duration_s: float = 0.0
    prob: float = 1.0      # pressure: per-allocation firing probability
    delay_s: float = 0.0   # slow: injected per-hit latency


class FleetFaultPlan:
    """Seeded, deterministic schedule of fleet-level events.

    Pure function of ``(seed, n_workers, duration_s, kinds)``: the same
    arguments always produce the identical event list — the suite asserts
    this, and ``python -m distributed_gpu_inference_torch.testing.faults
    --replay <seed>`` prints the exact schedule a failing seed ran.

    Generated disruption windows are SEQUENTIAL (next window starts after
    the previous ends), so with ≥ 2 replicas at least one replica can take
    work at every instant — the suite's liveness assertions rely on it.
    ``trace`` records what the executor actually ran, wall-clock-stamped.
    """

    def __init__(self, seed: int,
                 n_workers: int = FLEET_CHAOS_WORKERS,
                 duration_s: float = FLEET_CHAOS_DURATION_S,
                 kinds: Sequence[str] = FLEET_EVENT_KINDS,
                 max_disruptions: int = 2,
                 n_planes: int = PLANE_CHAOS_PLANES) -> None:
        for k in kinds:
            if k not in ALL_FLEET_EVENT_KINDS:
                raise ValueError(
                    f"unknown fleet event kind {k!r} "
                    f"(one of {ALL_FLEET_EVENT_KINDS})"
                )
        self.seed = seed
        self.n_workers = n_workers
        self.duration_s = duration_s
        self.kinds = tuple(kinds)
        self.max_disruptions = max_disruptions
        # plane cohort size — only consulted when a plane_* kind is drawn,
        # so schedules without plane kinds are bit-identical to round 9
        self.n_planes = n_planes
        self.events: List[FleetEvent] = self._generate()
        self.trace: List[Tuple[float, str, int]] = []

    def _generate(self) -> List[FleetEvent]:
        rng = random.Random(0xF1EE7 * (self.seed + 1) + self.n_workers)
        n = 1
        if self.max_disruptions > 1 and rng.random() < 0.5:
            n = 2
        events: List[FleetEvent] = []
        cursor = self.duration_s * (0.10 + 0.15 * rng.random())
        for _ in range(n):
            kind = self.kinds[rng.randrange(len(self.kinds))]
            # plane events target the plane cohort; everything else the
            # worker fleet. One randrange draw either way, so kind sets
            # WITHOUT plane kinds consume the rng identically to round 9.
            if kind in PLANE_EVENT_KINDS:
                worker = rng.randrange(max(1, self.n_planes))
            else:
                worker = rng.randrange(self.n_workers)
            dur = self.duration_s * (0.20 + 0.25 * rng.random())
            if kind == "kill":
                events.append(FleetEvent(round(cursor, 3), "kill", worker))
                events.append(
                    FleetEvent(round(cursor + dur, 3), "restart", worker)
                )
            elif kind == "pressure":
                events.append(FleetEvent(
                    round(cursor, 3), "pressure", -1,
                    duration_s=round(dur, 3),
                    prob=0.25 + 0.5 * rng.random(),
                ))
            elif kind == "slow":
                events.append(FleetEvent(
                    round(cursor, 3), "slow", worker,
                    duration_s=round(dur, 3),
                    delay_s=round(0.02 + 0.08 * rng.random(), 3),
                ))
            elif kind == "handoff_corrupt":
                events.append(FleetEvent(
                    round(cursor, 3), "handoff_corrupt", -1,
                    duration_s=round(dur, 3),
                    prob=0.25 + 0.5 * rng.random(),
                ))
            elif kind == "handoff_delay":
                events.append(FleetEvent(
                    round(cursor, 3), "handoff_delay", worker,
                    duration_s=round(dur, 3),
                    delay_s=round(0.02 + 0.08 * rng.random(), 3),
                ))
            elif kind == "plane_kill":
                # like worker kill: every plane_kill pairs its own
                # plane_restart, so no schedule strands a dead plane
                events.append(
                    FleetEvent(round(cursor, 3), "plane_kill", worker)
                )
                events.append(
                    FleetEvent(round(cursor + dur, 3), "plane_restart",
                               worker)
                )
            elif kind == "plane_slow":
                events.append(FleetEvent(
                    round(cursor, 3), "plane_slow", worker,
                    duration_s=round(dur, 3),
                    delay_s=round(0.02 + 0.08 * rng.random(), 3),
                ))
            elif kind == "degrade":
                # persistent slowdown: heavier than ``slow`` (the worker
                # is 5-15x a healthy replica's latency, not 1.2x) and the
                # window stretches to most of the run — the gray failure
                # quarantine exists to catch. ``dur`` is stretched so the
                # sequential-window cursor below still never overlaps.
                dur = max(dur, self.duration_s * 0.5)
                events.append(FleetEvent(
                    round(cursor, 3), "degrade", worker,
                    duration_s=round(dur, 3),
                    delay_s=round(0.10 + 0.20 * rng.random(), 3),
                ))
            elif kind == "jitter":
                events.append(FleetEvent(
                    round(cursor, 3), "jitter", worker,
                    duration_s=round(dur, 3),
                    prob=0.25 + 0.5 * rng.random(),
                    delay_s=round(0.05 + 0.10 * rng.random(), 3),
                ))
            elif kind == "flaky":
                events.append(FleetEvent(
                    round(cursor, 3), "flaky", worker,
                    duration_s=round(dur, 3),
                    prob=0.25 + 0.5 * rng.random(),
                ))
            elif kind == "disk_full":
                # a full disk fails EVERY write until space frees — no
                # probability draw, so historical rng sequences without
                # io kinds are untouched by construction
                events.append(FleetEvent(
                    round(cursor, 3), "disk_full", -1,
                    duration_s=round(dur, 3),
                ))
            elif kind == "io_error":
                events.append(FleetEvent(
                    round(cursor, 3), "io_error", -1,
                    duration_s=round(dur, 3),
                    prob=0.5 + 0.5 * rng.random(),
                ))
            elif kind == "io_slow":
                events.append(FleetEvent(
                    round(cursor, 3), "io_slow", -1,
                    duration_s=round(dur, 3),
                    delay_s=round(0.02 + 0.08 * rng.random(), 3),
                ))
            elif kind in ("corrupt_read", "torn_write"):
                events.append(FleetEvent(
                    round(cursor, 3), kind, -1,
                    duration_s=round(dur, 3),
                    prob=0.25 + 0.5 * rng.random(),
                ))
            else:  # blackout / partition / handoff_partition / plane_partition
                events.append(FleetEvent(
                    round(cursor, 3), kind, worker,
                    duration_s=round(dur, 3),
                ))
            # sequential windows + breathing room: disruptions never
            # overlap, so a 2-replica fleet always has a live replica
            cursor += dur + self.duration_s * 0.10 * (1.0 + rng.random())
        return sorted(events, key=lambda e: e.at_s)

    def record(self, offset_s: float, kind: str, worker: int) -> None:
        """Executor hook: stamp one executed event into the trace."""
        self.trace.append((round(offset_s, 3), kind, worker))

    def describe(self) -> List[str]:
        out = [
            f"FleetFaultPlan(seed={self.seed}, workers={self.n_workers}, "
            f"duration={self.duration_s}s, kinds={','.join(self.kinds)})"
        ]
        for e in self.events:
            if e.worker < 0:
                tgt = "fleet"
            elif e.kind.startswith("plane_"):
                tgt = f"plane[{e.worker}]"
            else:
                tgt = f"worker[{e.worker}]"
            extra = ""
            if e.duration_s:
                extra += f" for {e.duration_s}s"
            if e.kind in ("pressure", "handoff_corrupt", "jitter",
                          "flaky", "io_error", "corrupt_read",
                          "torn_write"):
                extra += f" prob={e.prob:.2f}"
            if e.kind in ("slow", "handoff_delay", "plane_slow",
                          "degrade", "jitter", "io_slow"):
                extra += f" delay={e.delay_s}s"
            out.append(f"  t+{e.at_s:6.2f}s  {e.kind:<9} {tgt}{extra}")
        return out


# ---------------------------------------------------------------------------
# seeded-replay CLI: reconstruct a failing fleet-chaos seed's exact schedule
# ---------------------------------------------------------------------------


def _replay_main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m distributed_gpu_inference_torch.testing.faults --replay N``

    Prints the exact fleet FaultPlan a chaos-suite seed runs (same
    generator, same defaults as ``tests/test_fleet_chaos.py``), so a chaos
    flake reproduces one-shot: read the CI failure's seed, replay it, and
    the printed schedule IS what the failing run injected."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m distributed_gpu_inference_torch.testing.faults",
        description="Replay a seeded fleet FaultPlan schedule.",
    )
    ap.add_argument("--replay", type=int, required=True, metavar="SEED",
                    help="the failing suite seed to reconstruct")
    ap.add_argument("--workers", type=int, default=None,
                    help="fleet size the suite ran (default: suite default; "
                    "the PD suite's with --pd)")
    ap.add_argument("--duration", type=float,
                    default=FLEET_CHAOS_DURATION_S,
                    help="chaos window seconds (default: suite default)")
    ap.add_argument("--kinds", default=None,
                    help="comma-separated event kinds the suite allowed "
                    "(default: the fleet suite's kinds, or the PD suite's "
                    "with --pd)")
    ap.add_argument("--pd", action="store_true",
                    help="reconstruct a tests/test_pd_chaos.py seed: the "
                    "PD-split suite's kinds (kill/partition + handoff_"
                    "partition/corrupt/delay) and its 3-worker fleet "
                    "geometry")
    ap.add_argument("--planes", action="store_true",
                    help="reconstruct a tests/test_plane_chaos.py seed: "
                    "the plane suite's kinds (plane_kill/plane_partition/"
                    "plane_slow + worker kill) and its 2-plane / 2-worker "
                    "geometry")
    ap.add_argument("--gray", action="store_true",
                    help="reconstruct a tests/test_gray_chaos.py seed: "
                    "the gray-failure suite's kinds (degrade/jitter/flaky "
                    "+ worker kill) and its 3-worker fleet geometry")
    ap.add_argument("--io", action="store_true",
                    help="reconstruct a tests/test_io_chaos.py seed: the "
                    "durable-tier suite's kinds (disk_full/io_error/"
                    "io_slow/corrupt_read/torn_write + worker kill) and "
                    "its 2-worker fleet geometry")
    args = ap.parse_args(argv)
    if sum(1 for f in (args.pd, args.planes, args.gray, args.io) if f) > 1:
        ap.error("--pd, --planes, --gray and --io are mutually exclusive")
    kinds = args.kinds
    if kinds is None:
        if args.pd:
            kinds = ",".join(PD_CHAOS_KINDS)
        elif args.planes:
            kinds = ",".join(PLANE_CHAOS_KINDS)
        elif args.gray:
            kinds = ",".join(GRAY_CHAOS_KINDS)
        elif args.io:
            kinds = ",".join(IO_CHAOS_SUITE_KINDS)
        else:
            kinds = ",".join(FLEET_EVENT_KINDS)
    workers = args.workers
    if workers is None:
        if args.pd:
            workers = PD_CHAOS_WORKERS
        elif args.planes:
            workers = PLANE_CHAOS_WORKERS
        elif args.gray:
            workers = GRAY_CHAOS_WORKERS
        elif args.io:
            workers = IO_CHAOS_WORKERS
        else:
            workers = FLEET_CHAOS_WORKERS
    plan = FleetFaultPlan(
        args.replay, n_workers=workers, duration_s=args.duration,
        kinds=tuple(k for k in kinds.split(",") if k),
        n_planes=PLANE_CHAOS_PLANES,
    )
    for line in plan.describe():
        print(line)
    return 0


if __name__ == "__main__":  # pragma: no cover - manual entry point
    raise SystemExit(_replay_main())
