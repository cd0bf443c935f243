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

Sites in the port: ``worker.api.request`` (:func:`wrap_http`),
``worker.direct.request`` (:func:`http_reject`), ``worker.direct.stream``
(:func:`stream_cut`), ``kv.block.alloc`` (:func:`kv_pressure`),
``io.spill.host.get`` / ``.put`` and ``io.file.write`` (:func:`io_fault`),
``io.spill.remote.get`` / ``.put`` (:func:`io_bytes`),
``io.spill.redis.get`` / ``.put`` (:func:`io_fault`), and on the KV
handoff ``kv.receiver.message`` (:func:`mutate_bytes`),
``io.handoff.stage`` (:func:`io_bytes`), ``worker.pd.push`` and
``worker.kv.pull`` (:func:`wrap_http`).

=========  =======================================================
kind       effect at a seam
=========  =======================================================
drop       HTTP: raise a transport error. ``where="response"``
           performs the call first (delivered, response lost).
           Stream: the stream dies here. IO: ``OSError``.
delay      sleep ``delay_s`` then proceed.
error      HTTP: synthesize a ``status`` response without calling;
           server seam: answer ``status``. IO: ``OSError``.
truncate   byte seams: keep only the first ``cut`` bytes.
corrupt    byte seams: flip one byte mid-payload.
duplicate  HTTP: perform the call twice, return the second response.
flap       a drop for the next ``times`` hits.
reorder    (kept as a kind for shared rule lists; no port seam uses it)
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
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

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
