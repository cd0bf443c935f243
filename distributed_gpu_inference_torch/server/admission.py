"""SLO-native overload control: per-tenant admission budgets and
priority-aware shedding.

Without it, the fleet's behavior under pressure is a single blanket
queue-depth check (``worker_config.should_accept_submission``): past
``submit_queue_limit`` EVERY submission 429s — the paying tenant and the
tenant spraying free-tier bursts alike. This module turns saturation into
*graceful, prioritized degradation*:

- **Per-tenant token buckets with weighted fair sharing.** Every tenant
  owns a bucket refilled from the fleet budget
  (``rate_tokens_per_s``) in proportion to its tier weight over the
  currently-active tenant mix — one bursting free tenant cannot starve
  the others, and paid tenants hold the lion's share by construction.
  Buckets live in a bounded LRU (``max_tenants``): a tenant-id-spraying
  client recycles bucket slots instead of growing plane memory.
- **A degrade-before-reject ladder.** As queue saturation (queued /
  ``submit_queue_limit``) climbs, requests are first *degraded* —
  ``max_tokens`` clamped (``degrade_at``), then speculation disabled
  (``no_spec_at``) — and only *shed* (429 + Retry-After) past the
  tier's queue fraction (``LoadControl.tier_queue_fractions``). Free
  and batch tiers shed at lower fractions than paid, so **paid traffic
  is never shed while free-tier capacity exists**: by the time the
  queue reaches the paid fraction (the full limit), every lower tier
  has been shedding for a while.
- **Observability for every decision.**
  ``admission_decisions_total{tenant_tier,action}`` counts the ladder
  by tier, and ``tenant_admission_decisions_total{tenant,action}``
  counts per tenant with a top-N + ``other`` label cap (the Prometheus
  registry must survive a tenant-id-spraying client too).

Decisions are made at job submission (``server/app.py`` POST /jobs[,
/sync]); the tier also boosts the job's scheduler/batcher priority so
shed ordering and service ordering agree.

The port's copy of ``distributed_gpu_inference_tpu/server/admission.py``, on the
standard library and the port's own modules.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

# named tenant tiers, best-served-first. Unknown tier strings normalize to
# DEFAULT_TIER — a client cannot invent a "platinum" tier to jump the shed
# ladder.
TIERS = ("paid", "free", "batch")
DEFAULT_TIER = "free"

# control-plane priority boost per tier: shed ordering (this module) and
# service ordering (scheduler claim heap + batcher admission heap) must
# agree, or paid jobs would survive admission only to queue behind batch
TIER_PRIORITY_BOOST = {"paid": 10, "free": 0, "batch": -10}

# how long a tenant counts toward the active-weight denominator after its
# last submission — fair shares rebalance on this timescale
_ACTIVE_TTL_S = 30.0


def normalize_tier(tier: Any) -> str:
    t = str(tier or "").strip().lower()
    return t if t in TIERS else DEFAULT_TIER


def tenant_of(body: Dict[str, Any]) -> Tuple[str, str]:
    """Extract ``(tenant, tier)`` from a job-submission body. The tenant
    id may ride the top level or ``params`` (the SDK sends params);
    untenanted traffic shares one ``anonymous`` bucket at the default
    tier, so legacy clients are budgeted too, not waved through."""
    params = body.get("params") if isinstance(body.get("params"), dict) \
        else {}
    tenant = body.get("tenant") or params.get("tenant") or "anonymous"
    tier = body.get("tier") or params.get("tier")
    return str(tenant)[:128], normalize_tier(tier)


def estimate_cost_tokens(params: Optional[Dict[str, Any]],
                         default_max_tokens: int = 256) -> int:
    """Budget cost of one submission, in tokens: the decode ask plus a
    coarse prompt-size term (chars/4 ≈ tokens for the byte tokenizer's
    upper bound; exactness doesn't matter — the bucket is a rate shaper,
    not a bill)."""
    params = params or {}
    toks = int(params.get("max_new_tokens") or params.get("max_tokens")
               or default_max_tokens)
    prompt = params.get("prompt")
    if isinstance(prompt, str):
        toks += len(prompt) // 4
    return max(1, toks)


@dataclass
class AdmissionConfig:
    """Live-pushable overload-control knobs (GET/PUT
    ``/api/v1/admin/admission`` — the same A/B surface as routing)."""

    enabled: bool = False
    # fleet-wide admission budget in tokens/s, split across active tenants
    # by tier weight. 0 = unlimited budget: the ladder is then driven by
    # queue saturation alone (buckets never run dry).
    rate_tokens_per_s: float = 0.0
    # bucket capacity = tenant_rate * burst_s: how much a quiet tenant may
    # burst before its fair-share rate gates it
    burst_s: float = 5.0
    tier_weights: Dict[str, float] = field(
        default_factory=lambda: {"paid": 8.0, "free": 1.0, "batch": 0.25}
    )
    # bounded tenant tracking: the LRU evicts the least-recently-seen
    # bucket past this — plane memory is O(max_tenants) no matter how many
    # tenant ids a client sprays
    max_tenants: int = 256
    # degrade ladder thresholds, as fractions of submit_queue_limit
    # (must be <= every tier's shed fraction to degrade before rejecting)
    degrade_at: float = 0.5       # clamp max_tokens
    no_spec_at: float = 0.7       # + disable speculation
    clamp_max_tokens: int = 32    # the degraded decode budget
    min_retry_after_s: float = 1.0
    max_retry_after_s: float = 30.0

    def update(self, updates: Dict[str, Any]) -> None:
        """Apply a validated partial update (admin PUT). Raises
        TypeError/ValueError on a bad field — never half-applies."""
        coerced: Dict[str, Any] = {}
        for key, val in updates.items():
            if not hasattr(self, key):
                raise ValueError(f"unknown admission field {key!r}")
            cur = getattr(self, key)
            if isinstance(cur, bool):
                if isinstance(val, str):
                    val = val.strip().lower() in ("1", "true", "yes", "on")
                coerced[key] = bool(val)
            elif isinstance(cur, dict):
                if not isinstance(val, dict):
                    raise TypeError(f"{key} must be an object")
                # MERGE partial weight updates: a PUT raising one tier's
                # weight must not silently drop the others onto the
                # _tier_weight fallback (1.0 — which would QUADRUPLE
                # batch's share and invert the tier ordering)
                coerced[key] = {**cur,
                                **{str(k): float(v) for k, v in
                                   val.items()}}
            elif isinstance(cur, int):
                coerced[key] = int(val)
            else:
                coerced[key] = float(val)
        for key, val in coerced.items():
            setattr(self, key, val)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "enabled": self.enabled,
            "rate_tokens_per_s": self.rate_tokens_per_s,
            "burst_s": self.burst_s,
            "tier_weights": dict(self.tier_weights),
            "max_tenants": self.max_tenants,
            "degrade_at": self.degrade_at,
            "no_spec_at": self.no_spec_at,
            "clamp_max_tokens": self.clamp_max_tokens,
            "min_retry_after_s": self.min_retry_after_s,
            "max_retry_after_s": self.max_retry_after_s,
        }


class _Bucket:
    """One tenant's token bucket. Refill rate/capacity are recomputed by
    the controller every decision (fair shares move as tenants come and
    go), so the bucket only stores level + last-refill stamp."""

    __slots__ = ("level", "last", "tier")

    def __init__(self, tier: str, now: float, cap: float) -> None:
        self.tier = tier
        self.level = cap          # a fresh tenant starts with a full burst
        self.last = now

    def refill(self, rate: float, cap: float, now: float) -> None:
        self.level = min(cap, self.level + rate * max(0.0, now - self.last))
        self.last = now

    def deficit_s(self, cost: float, rate: float) -> float:
        """Seconds until the bucket affords ``cost`` at ``rate``."""
        if self.level >= cost:
            return 0.0
        if rate <= 0.0:
            return float("inf")
        return (cost - self.level) / rate


@dataclass
class AdmissionDecision:
    """One ladder outcome. ``action`` ∈ accept | degrade_clamp |
    degrade_no_spec | shed. Degrades compose: a ``degrade_no_spec``
    decision may also carry a clamp."""

    action: str
    tenant: str
    tier: str
    max_tokens: Optional[int] = None    # clamped decode budget, when set
    disable_spec: bool = False
    retry_after_s: float = 0.0          # shed only
    reason: str = ""

    @property
    def admitted(self) -> bool:
        return self.action != "shed"

    def flight_attrs(self) -> Dict[str, Any]:
        """Flat scalar attrs for the request's flight-recorder
        ``server.admission`` event — one place decides what a timeline
        reader sees about the ladder outcome, so the event shape cannot
        drift from the decision shape."""
        out: Dict[str, Any] = {"action": self.action, "tier": self.tier}
        if self.max_tokens is not None:
            out["max_tokens"] = int(self.max_tokens)
        if self.disable_spec:
            out["disable_spec"] = True
        if self.action == "shed":
            out["retry_after_s"] = round(float(self.retry_after_s), 3)
        return out


class AdmissionController:
    """Per-tenant budgeting + the degrade/shed ladder. One instance per
    control plane; every decision is counted (stats dict always, plane
    metrics when attached)."""

    def __init__(self, config: Optional[AdmissionConfig] = None,
                 metrics: Optional[Any] = None) -> None:
        self.cfg = config or AdmissionConfig()
        self.metrics = metrics
        # LRU: tenant -> _Bucket (move_to_end on touch, popitem(False) to
        # evict the coldest when over max_tenants)
        self._buckets: "OrderedDict[str, _Bucket]" = OrderedDict()
        self.stats: Dict[str, int] = {}

    # -- weighted fair sharing ------------------------------------------------

    def _tier_weight(self, tier: str) -> float:
        return max(0.0, float(self.cfg.tier_weights.get(tier, 1.0)))

    def _active_weight(self, now: float) -> float:
        """Sum of tier weights over tenants seen within the active TTL —
        the denominator of every tenant's fair share."""
        total = 0.0
        for b in self._buckets.values():
            if now - b.last <= _ACTIVE_TTL_S:
                total += self._tier_weight(b.tier)
        return total

    def tenant_rate(self, tier: str, now: Optional[float] = None) -> float:
        """This tier's per-tenant refill rate (tokens/s) under the current
        active mix. 0 budget = unlimited (callers treat rate 0 with an
        unlimited config as 'bucket never gates')."""
        if self.cfg.rate_tokens_per_s <= 0.0:
            return 0.0
        now = time.time() if now is None else now
        w = self._tier_weight(tier)
        denom = max(self._active_weight(now), w, 1e-9)
        return self.cfg.rate_tokens_per_s * w / denom

    def _touch(self, tenant: str, tier: str, now: float) -> _Bucket:
        b = self._buckets.get(tenant)
        rate = self.tenant_rate(tier, now)
        cap = max(rate * self.cfg.burst_s, float(self.cfg.clamp_max_tokens))
        if b is None:
            b = _Bucket(tier, now, cap)
            self._buckets[tenant] = b
            while len(self._buckets) > max(1, int(self.cfg.max_tenants)):
                self._buckets.popitem(last=False)   # coldest tenant out
        else:
            b.tier = tier
            b.refill(rate, cap, now)
            self._buckets.move_to_end(tenant)
        return b

    # -- the ladder -----------------------------------------------------------

    def decide(self, tenant: str, tier: str, cost_tokens: int,
               queued: int, active_workers: int,
               worker_config: Any,
               now: Optional[float] = None,
               decode_tokens: Optional[int] = None) -> AdmissionDecision:
        """Run one submission down the ladder. ``worker_config`` supplies
        the tier-aware queue-shed thresholds
        (``should_accept_submission(queued, active, tier=...)``) so the
        shed geometry lives with the other queue-depth policy.

        ``cost_tokens`` is the BUDGET cost (decode ask + prompt term);
        ``decode_tokens`` is the decode ask alone — the clamp applies to
        it (clamping cannot shrink a prompt), and defaults to
        ``cost_tokens`` for callers without the split."""
        now = time.time() if now is None else now
        tier = normalize_tier(tier)
        if not self.cfg.enabled:
            return self._done(AdmissionDecision("accept", tenant, tier))
        limit = int(getattr(worker_config, "submit_queue_limit", 0) or 0)
        saturation = (queued / limit) if limit > 0 else 0.0
        bucket = self._touch(tenant, tier, now)
        rate = self.tenant_rate(tier, now)
        budgeted = self.cfg.rate_tokens_per_s > 0.0

        # Stage D first — the tier's queue fraction is the hard floor no
        # budget can buy past (free/batch shed here long before paid's
        # fraction, which defaults to the full limit)
        ok_queue, retry_q = worker_config.should_accept_submission(
            queued, active_workers, tier=tier
        )
        if not ok_queue:
            retry = self._retry_after(max(retry_q, bucket.deficit_s(
                float(min(cost_tokens, self.cfg.clamp_max_tokens)), rate
            ) if budgeted else 0.0))
            return self._done(AdmissionDecision(
                "shed", tenant, tier, retry_after_s=retry,
                reason=f"queue saturated for tier {tier} "
                       f"({queued} queued)",
            ))

        clamp = None
        disable_spec = False
        decode = int(decode_tokens if decode_tokens is not None
                     else cost_tokens)
        cost = float(cost_tokens)
        over_budget = budgeted and bucket.level < cost
        if (saturation >= self.cfg.degrade_at or over_budget) \
                and decode > int(self.cfg.clamp_max_tokens):
            # Stage B: degrade the DECODE ask before rejecting anyone —
            # the clamp applies to the decode budget only (the prompt
            # term of the cost cannot be shrunk), and a request already
            # at/below the clamp is not "degraded"
            clamp = int(self.cfg.clamp_max_tokens)
            cost = max(1.0, cost - float(decode - clamp))
        if saturation >= self.cfg.no_spec_at:
            # Stage C: speculation spends draft compute the fleet no
            # longer has — serve vanilla
            disable_spec = True
        if budgeted and bucket.level < cost and tier != "paid":
            # even the clamped ask is over budget: shed (free/batch).
            # Paid debt is carried instead — the paid bucket floors at
            # its deficit and fairness catches up when the burst passes;
            # shedding paid on budget alone would violate the tier
            # contract while free capacity still exists.
            return self._done(AdmissionDecision(
                "shed", tenant, tier,
                retry_after_s=self._retry_after(
                    bucket.deficit_s(cost, rate)),
                reason=f"tenant budget exhausted "
                       f"({bucket.level:.0f} < {cost:.0f} tokens)",
            ))
        if budgeted:
            # charge; paid may run negative — debt bounded by the
            # TENANT's own burst allowance (not the fleet budget), so
            # one over-budget paid tenant free-rides at most one of its
            # own bursts past the weighted share before fairness gates it
            floor = -(rate * self.cfg.burst_s
                      + float(self.cfg.clamp_max_tokens))
            bucket.level = max(bucket.level - cost, floor)
        if disable_spec:
            return self._done(AdmissionDecision(
                "degrade_no_spec", tenant, tier, max_tokens=clamp,
                disable_spec=True,
            ))
        if clamp is not None:
            return self._done(AdmissionDecision(
                "degrade_clamp", tenant, tier, max_tokens=clamp,
            ))
        return self._done(AdmissionDecision("accept", tenant, tier))

    def _retry_after(self, hint_s: float) -> float:
        if hint_s == float("inf"):
            hint_s = self.cfg.max_retry_after_s
        return min(self.cfg.max_retry_after_s,
                   max(self.cfg.min_retry_after_s, float(hint_s)))

    def _done(self, d: AdmissionDecision) -> AdmissionDecision:
        key = f"{d.tier}:{d.action}"
        self.stats[key] = self.stats.get(key, 0) + 1
        if self.metrics is not None:
            try:
                self.metrics.record_admission(d.tier, d.action, d.tenant)
            except Exception:  # noqa: BLE001 — metrics must not gate
                pass
        return d

    # -- introspection --------------------------------------------------------

    def tracked_tenants(self) -> int:
        return len(self._buckets)

    def snapshot(self) -> Dict[str, Any]:
        """Admin/debug view: decision counts + bucket levels (top 32 by
        recency — the full map is bounded but still noisy)."""
        recent = list(self._buckets.items())[-32:]
        return {
            "decisions": dict(self.stats),
            "tracked_tenants": len(self._buckets),
            "buckets": {
                t: {"tier": b.tier, "level": round(b.level, 1)}
                for t, b in recent
            },
        }
