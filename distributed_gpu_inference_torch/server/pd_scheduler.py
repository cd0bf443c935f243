"""Prefill/decode-disaggregated scheduling (DistServe-style) for TPU pools.

Behavioral parity with the reference's ``server/app/services/pd_scheduler.py``:

- :class:`WorkerCapability` separates compute capacity (prefill is
  FLOPs-bound) from memory bandwidth (decode is HBM-bound) — reference
  ``pd_scheduler.py:38-79``.
- Separate prefill/decode queues (:133-135), batched pop with per-phase
  timeouts (prefill 20 ms, decode 5 ms — :121-123, :350-380).
- Prefill assignment maximizes ``flops / (1 + active)`` (:245-272); decode
  assignment is KV-affinity-first, else best bandwidth + migration flag
  (:274-323); analytic latency estimators (:325-348).
- :class:`KVCacheMigrator` dedups concurrent migrations of the same key
  (:432-438) — but unlike the reference, whose migration body is a simulated
  50 ms sleep (:462-472), migration here is REAL: a pluggable transport moves
  serialized KV pages between engines (`runtime/kv_handoff.py`), and the
  in-process default does a full export→wire→adopt round trip.

TPU re-design notes:

- Capacities derive from :class:`TpuTopology` (chip generation → bf16 TFLOP/s
  and HBM GB/s), not nvidia-smi probes. A v5e-64 deployment splits the pod's
  slices into a prefill partition and a decode partition (BASELINE config 5:
  16 prefill chips / 48 decode chips); each partition is one "worker" here.
- Intra-pod handoff rides ICI (device-to-device), so the migrator's transport
  is where the deployment chooses ICI vs DCN; the scheduler only decides
  *whether* and *where* to move KV.

The port's copy of ``distributed_gpu_inference_tpu/server/pd_scheduler.py``, on the
standard library and the port's own modules.
"""

from __future__ import annotations

import asyncio
import heapq
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple

from ..utils.data_structures import (
    TpuTopology,
    WorkerRole,
    estimate_kv_cache_bytes,
)

# Per-chip HBM bandwidth by generation (GB/s) — public TPU specs.
_HBM_GBPS = {"v4": 1228.0, "v5e": 819.0, "v5p": 2765.0, "v6e": 1640.0, "cpu": 50.0}

PREFILL_BATCH_TIMEOUT_S = 0.020   # reference pd_scheduler.py:121
DECODE_BATCH_TIMEOUT_S = 0.005    # reference pd_scheduler.py:123


@dataclass
class WorkerCapability:
    """Compute-vs-bandwidth profile of one pool partition
    (reference ``WorkerCapability``, pd_scheduler.py:38-79)."""

    worker_id: str
    role: WorkerRole = WorkerRole.HYBRID
    # bandwidth fields are GB/s (gigaBYTES), matching _HBM_GBPS
    compute_tflops: float = 197.0        # aggregate bf16 TFLOP/s
    memory_bandwidth_gbps: float = 819.0  # aggregate HBM GB/s
    hbm_gb: float = 16.0
    interconnect_gbps: float = 25.0      # GB/s to OTHER partitions (ICI/DCN)
    max_prefill_batch: int = 8
    max_decode_batch: int = 64

    @classmethod
    def from_topology(cls, worker_id: str, topo: TpuTopology,
                      role: WorkerRole = WorkerRole.HYBRID,
                      **kw: Any) -> "WorkerCapability":
        per_chip_bw = _HBM_GBPS.get(topo.chip_type, 819.0)
        derived: Dict[str, Any] = dict(
            worker_id=worker_id,
            role=role,
            compute_tflops=topo.peak_bf16_tflops * topo.num_chips,
            memory_bandwidth_gbps=per_chip_bw * topo.num_chips,
            hbm_gb=topo.total_hbm_gb,
            interconnect_gbps=topo.ici_bandwidth_gbps,
        )
        derived.update(kw)  # explicit overrides win over topology-derived
        return cls(**derived)

    @property
    def can_prefill(self) -> bool:
        return self.role in (WorkerRole.PREFILL, WorkerRole.HYBRID)

    @property
    def can_decode(self) -> bool:
        return self.role in (WorkerRole.DECODE, WorkerRole.HYBRID)


@dataclass
class _PoolWorker:
    cap: WorkerCapability
    active_prefill: int = 0
    active_decode: int = 0
    total_prefills: int = 0
    total_decodes: int = 0


@dataclass(order=True)
class _QueueEntry:
    sort_key: Tuple[int, float]
    req: "PDRequest" = field(compare=False)


@dataclass
class PDRequest:
    """One request tracked through both phases."""

    request_id: str = field(default_factory=lambda: uuid.uuid4().hex)
    prompt_tokens: int = 0
    max_new_tokens: int = 256
    priority: int = 0
    model_name: str = "llama3-8b"
    arrival: float = field(default_factory=time.time)
    # phase state
    phase: str = "prefill"               # prefill | decode | done
    prefill_worker: Optional[str] = None
    decode_worker: Optional[str] = None
    kv_cache_key: Optional[str] = None
    kv_holder: Optional[str] = None      # worker currently holding the KV
    needs_migration: bool = False
    excluded_workers: set = field(default_factory=set)  # failed migration dsts
    migration_attempts: int = 0
    # re-prefill fallback counter (pd_flow): a failed stage re-places the
    # WHOLE flow — prefill again from the prompt — up to the flow's budget,
    # without burning the job's own retry_count
    attempt: int = 0
    # model geometry for KV size estimates
    num_layers: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128

    @property
    def kv_bytes(self) -> int:
        return estimate_kv_cache_bytes(
            self.num_layers, self.num_kv_heads, self.head_dim,
            self.prompt_tokens + self.max_new_tokens,
        )


class PrefillDecodeScheduler:
    """Routes requests through disaggregated prefill and decode pools."""

    def __init__(self, migrator: Optional["KVCacheMigrator"] = None,
                 max_migration_attempts: int = 3,
                 allow_role_rebalance: bool = True) -> None:
        self._workers: Dict[str, _PoolWorker] = {}
        self._prefill_q: List[_QueueEntry] = []
        self._decode_q: List[_QueueEntry] = []
        # decode requests whose background KV migration has completed and are
        # ready to hand out on the next get_batch("decode")
        self._ready_migrated: deque = deque()
        self._bg_tasks: set = set()
        self._cv = asyncio.Condition()
        self.migrator = migrator
        self.max_migration_attempts = max_migration_attempts
        # brownout rebalance: when one SIDE of a split fleet has no capacity
        # (every prefill worker dead or saturated), workers of the OTHER
        # role temporarily accept hybrid work instead of idling while the
        # starved queue melts down — counted, so the condition is visible
        self.allow_role_rebalance = allow_role_rebalance
        # predictive rebalance: worker_id -> ORIGINAL role for
        # workers temporarily flipped to HYBRID ahead of a projected SLO
        # miss (reactive role_rebalance above only fires once a side is
        # already dark; the preflip acts on the projection)
        self._preflipped: Dict[str, WorkerRole] = {}
        self.stats: Dict[str, Any] = {
            "submitted": 0, "prefills_assigned": 0, "decodes_assigned": 0,
            "migrations_requested": 0, "affinity_hits": 0, "completed": 0,
            "migration_failures": 0, "migration_dropped": 0,
            "role_rebalanced_prefill": 0, "role_rebalanced_decode": 0,
            "preflipped": 0, "preflip_restored": 0,
        }

    # -- pool membership ----------------------------------------------------

    def register_worker(self, cap: WorkerCapability) -> None:
        self._workers[cap.worker_id] = _PoolWorker(cap=cap)

    def remove_worker(self, worker_id: str) -> None:
        self._workers.pop(worker_id, None)
        self._preflipped.pop(worker_id, None)

    def refresh_worker(self, cap: WorkerCapability) -> None:
        """Refresh a live worker's capability IN PLACE (register_worker
        would replace the pool entry and zero active_prefill/active_decode
        for live placements, unbinding the batch caps). A preflipped
        worker keeps its temporary HYBRID role across refreshes — the
        store-configured role becomes the restore target instead."""
        w = self._workers.get(cap.worker_id)
        if w is None:
            self.register_worker(cap)
            return
        if cap.worker_id in self._preflipped:
            self._preflipped[cap.worker_id] = cap.role
            cap.role = WorkerRole.HYBRID
        w.cap = cap

    # -- predictive preflip ---------------------------------------

    def preflip_role(self, starved: str) -> Optional[str]:
        """Flip ONE worker of the role OPPOSITE ``starved`` to HYBRID so
        it can absorb starved-side work before the projected brownout
        lands. Picks the donor with the most free capacity on its own
        side (the flip costs the donating side least). Returns the
        flipped worker id, or None (no single-role donor left). The
        original role is remembered; :meth:`restore_preflips` reverts."""
        donor_role = (WorkerRole.DECODE if starved == "prefill"
                      else WorkerRole.PREFILL)
        best: Optional[_PoolWorker] = None
        best_free = -1
        for w in self._workers.values():
            if w.cap.role is not donor_role or \
                    w.cap.worker_id in self._preflipped:
                continue
            free = (w.cap.max_decode_batch - w.active_decode
                    if donor_role is WorkerRole.DECODE
                    else w.cap.max_prefill_batch - w.active_prefill)
            if free > best_free:
                best, best_free = w, free
        if best is None:
            return None
        self._preflipped[best.cap.worker_id] = best.cap.role
        best.cap.role = WorkerRole.HYBRID
        self.stats["preflipped"] += 1
        return best.cap.worker_id

    def restore_preflips(self) -> int:
        """Put every preflipped worker back on its configured role (the
        projected miss resolved). Returns the number restored. In-flight
        work on a restored worker finishes normally — roles gate NEW
        assignments only."""
        n = 0
        for wid, role in list(self._preflipped.items()):
            w = self._workers.get(wid)
            if w is not None:
                w.cap.role = role
                n += 1
            del self._preflipped[wid]
        if n:
            self.stats["preflip_restored"] += n
        return n

    def worker(self, worker_id: str) -> Optional[_PoolWorker]:
        return self._workers.get(worker_id)

    @property
    def prefill_workers(self) -> List[_PoolWorker]:
        return [w for w in self._workers.values() if w.cap.can_prefill]

    @property
    def decode_workers(self) -> List[_PoolWorker]:
        return [w for w in self._workers.values() if w.cap.can_decode]

    # -- submission / phase transitions -------------------------------------

    async def submit_job(self, req: PDRequest) -> None:
        async with self._cv:
            req.phase = "prefill"
            heapq.heappush(
                self._prefill_q, _QueueEntry((-req.priority, req.arrival), req)
            )
            self.stats["submitted"] += 1
            self._cv.notify_all()

    async def transition_to_decode(self, req: PDRequest, kv_cache_key: str,
                                   holder_worker: str) -> None:
        """Prefill finished on ``holder_worker``; queue the decode phase
        (reference ``pd_scheduler.py:207-231``)."""
        async with self._cv:
            if req.prefill_worker:
                w = self._workers.get(req.prefill_worker)
                if w:
                    w.active_prefill = max(0, w.active_prefill - 1)
            req.phase = "decode"
            req.kv_cache_key = kv_cache_key
            req.kv_holder = holder_worker
            heapq.heappush(
                self._decode_q, _QueueEntry((-req.priority, req.arrival), req)
            )
            self._cv.notify_all()

    async def complete(self, req: PDRequest) -> None:
        async with self._cv:
            if req.decode_worker:
                w = self._workers.get(req.decode_worker)
                if w:
                    w.active_decode = max(0, w.active_decode - 1)
            req.phase = "done"
            self.stats["completed"] += 1

    # -- assignment (reference :245-323) -------------------------------------

    # -- direct placement (control-plane flow, server/pd_flow.py) ------------

    def place_prefill(self, req: PDRequest) -> Optional[str]:
        """Assign a prefill worker immediately (no queue wait) — the jobs-API
        path (``server/pd_flow.py``) places at submission; the queued
        ``submit_job``/``get_batch`` machinery serves pool-level batching."""
        return self._assign_prefill(req)

    def place_decode(self, req: PDRequest) -> Optional[str]:
        """Assign a decode worker immediately (KV-affinity first)."""
        return self._assign_decode(req)

    def release(self, req: PDRequest) -> None:
        """Return a placed request's worker slots (job finished or failed)."""
        for wid, attr in ((req.prefill_worker, "active_prefill"),
                          (req.decode_worker, "active_decode")):
            w = self._workers.get(wid or "")
            if w is not None and getattr(w, attr) > 0:
                setattr(w, attr, getattr(w, attr) - 1)

    def _assign_prefill(self, req: PDRequest) -> Optional[str]:
        # admission by queue depth: active_prefill counts this worker's
        # in-flight prefill placements (queued + running stage children);
        # a worker at max_prefill_batch takes nothing more, and with EVERY
        # prefill worker saturated the flow answers 503 + Retry-After —
        # backpressure, not silent queue growth
        def _pick(pool: List[_PoolWorker],
                  ignore_exclusions: bool) -> Optional[_PoolWorker]:
            best, best_score = None, -1.0
            for w in pool:
                if w.active_prefill >= w.cap.max_prefill_batch:
                    continue
                if not ignore_exclusions and \
                        w.cap.worker_id in req.excluded_workers:
                    continue
                score = w.cap.compute_tflops / (1.0 + w.active_prefill)
                if score > best_score:
                    best, best_score = w, score
            return best

        # exclusion fallback: workers that already failed THIS request are
        # skipped, and a HEALTHY rebalance candidate (other role) beats
        # retrying an excluded one — the excluded worker just failed us,
        # possibly persistently (partitioned pushes). Only when nothing
        # un-excluded exists anywhere does the retry-over-everyone pass
        # run, so a transient failure can never strand the request.
        rebalance = [w for w in self._workers.values()
                     if not w.cap.can_prefill] \
            if self.allow_role_rebalance else []
        best = _pick(self.prefill_workers, False)
        rebalanced = False
        if best is None and rebalance:
            best = _pick(rebalance, False)
            rebalanced = best is not None
        if best is None and req.excluded_workers:
            best = _pick(self.prefill_workers, True)
            rebalanced = False
        if best is None and rebalance and req.excluded_workers:
            best = _pick(rebalance, True)
            rebalanced = best is not None
        if best is None:
            return None
        if rebalanced:
            self.stats["role_rebalanced_prefill"] += 1
        best.active_prefill += 1
        best.total_prefills += 1
        req.prefill_worker = best.cap.worker_id
        self.stats["prefills_assigned"] += 1
        return best.cap.worker_id

    def _assign_decode(self, req: PDRequest) -> Optional[str]:
        # KV affinity first: the holder keeps the request if it can decode
        holder = self._workers.get(req.kv_holder or "")
        if holder is not None and holder.cap.can_decode and \
                holder.cap.worker_id not in req.excluded_workers and \
                holder.active_decode < holder.cap.max_decode_batch:
            holder.active_decode += 1
            holder.total_decodes += 1
            req.decode_worker = holder.cap.worker_id
            req.needs_migration = False
            self.stats["affinity_hits"] += 1
            self.stats["decodes_assigned"] += 1
            return holder.cap.worker_id

        # else: best aggregate bandwidth with headroom → migrate KV there.
        # Workers that already failed a migration for THIS request are skipped
        # (no livelock against a dead link); if exclusion empties the candidate
        # set, retry over everyone — a transient failure must not strand the
        # request when only one decode worker exists. A browned-out decode
        # side falls back to prefill-role workers (rebalance, counted).
        def _pick(pool: List[_PoolWorker],
                  ignore_exclusions: bool) -> Optional[_PoolWorker]:
            best, best_score = None, -1.0
            for w in pool:
                if w.active_decode >= w.cap.max_decode_batch:
                    continue
                if not ignore_exclusions and \
                        w.cap.worker_id in req.excluded_workers:
                    continue
                score = w.cap.memory_bandwidth_gbps / (1.0 + w.active_decode)
                if score > best_score:
                    best, best_score = w, score
            return best

        rebalance = [w for w in self._workers.values()
                     if not w.cap.can_decode] \
            if self.allow_role_rebalance else []
        best = _pick(self.decode_workers, False)
        rebalanced = False
        if best is None and rebalance:
            # healthy other-role capacity beats retrying an excluded
            # (just-failed) decode worker — same order as prefill
            best = _pick(rebalance, False)
            rebalanced = best is not None
        if best is None and req.excluded_workers:
            best = _pick(self.decode_workers, True)
            rebalanced = False
        if best is None and rebalance and req.excluded_workers:
            best = _pick(rebalance, True)
            rebalanced = best is not None
        if best is None:
            return None
        if rebalanced:
            self.stats["role_rebalanced_decode"] += 1
        best.active_decode += 1
        best.total_decodes += 1
        req.decode_worker = best.cap.worker_id
        req.needs_migration = req.kv_holder is not None and \
            req.kv_holder != best.cap.worker_id
        if req.needs_migration:
            self.stats["migrations_requested"] += 1
        self.stats["decodes_assigned"] += 1
        return best.cap.worker_id

    # -- batched pop (reference :350-380) ------------------------------------

    async def get_batch(self, phase: str, max_batch: int = 8,
                        timeout_s: Optional[float] = None) -> List[PDRequest]:
        """Pop up to ``max_batch`` assignable requests for ``phase``. Waits up
        to the per-phase timeout for the FIRST request, then drains what is
        immediately assignable (prefill batches amortize big matmuls; decode
        pops stay snappy to keep TPOT low)."""
        q = self._prefill_q if phase == "prefill" else self._decode_q
        assign = self._assign_prefill if phase == "prefill" else self._assign_decode
        if timeout_s is None:
            timeout_s = (
                PREFILL_BATCH_TIMEOUT_S if phase == "prefill"
                else DECODE_BATCH_TIMEOUT_S
            )
        out: List[PDRequest] = []
        deadline = time.monotonic() + timeout_s

        def _has_work() -> bool:
            if phase == "decode" and self._ready_migrated:
                return True
            return bool(q)

        async with self._cv:
            while not _has_work():
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return out
                try:
                    await asyncio.wait_for(self._cv.wait(), timeout=remaining)
                except asyncio.TimeoutError:
                    return out
            # migrated-and-ready requests go out first (their KV is local now)
            if phase == "decode":
                while self._ready_migrated and len(out) < max_batch:
                    out.append(self._ready_migrated.popleft())
            skipped: List[_QueueEntry] = []
            while q and len(out) < max_batch:
                entry = heapq.heappop(q)
                if assign(entry.req) is None:
                    skipped.append(entry)  # no capacity now; retain order
                    break
                req = entry.req
                if phase == "decode" and self.migrator is not None and \
                        req.needs_migration and req.kv_cache_key and \
                        req.kv_holder and req.decode_worker:
                    # KV must move first: run the transfer in the background so
                    # affinity-hit requests in this batch aren't stalled behind
                    # it; the request is delivered by a later get_batch once
                    # its migration lands in _ready_migrated
                    task = asyncio.ensure_future(self._migrate_bg(req))
                    self._bg_tasks.add(task)
                    task.add_done_callback(self._bg_tasks.discard)
                else:
                    out.append(req)
            for entry in skipped:
                heapq.heappush(q, entry)
        return out

    async def _migrate_bg(self, req: PDRequest) -> None:
        """Background KV migration with per-request failure isolation:
        a dead link excludes that destination and requeues the request (up to
        ``max_migration_attempts``), releasing the reserved decode capacity."""
        assert self.migrator is not None
        try:
            await self.migrator.migrate(
                req.kv_cache_key, req.kv_holder, req.decode_worker  # type: ignore[arg-type]
            )
        except Exception:
            async with self._cv:
                w = self._workers.get(req.decode_worker or "")
                if w:
                    w.active_decode = max(0, w.active_decode - 1)
                req.excluded_workers.add(req.decode_worker)
                req.migration_attempts += 1
                req.decode_worker = None
                req.needs_migration = False
                self.stats["migration_failures"] += 1
                if req.migration_attempts >= self.max_migration_attempts:
                    req.phase = "failed"
                    self.stats["migration_dropped"] += 1
                else:
                    heapq.heappush(
                        self._decode_q, _QueueEntry((-req.priority, req.arrival), req)
                    )
                self._cv.notify_all()
            return
        req.kv_holder = req.decode_worker
        async with self._cv:
            self._ready_migrated.append(req)
            self._cv.notify_all()

    # -- latency estimators (reference :325-348) -----------------------------

    def estimate_prefill_latency_ms(self, req: PDRequest,
                                    worker_id: Optional[str] = None) -> float:
        """Prefill is FLOPs-bound: ≈ 2·P·prompt_tokens / peak_flops, with P
        approximated from KV geometry (layers × heads × dim scaling)."""
        w = self._workers.get(worker_id or req.prefill_worker or "")
        tflops = w.cap.compute_tflops if w else 197.0
        # ~2 * params * tokens; params ≈ 12 * L * hidden² with hidden = heads*dim
        hidden = req.num_kv_heads * req.head_dim * 4  # GQA: q heads ≈ 4x kv
        params = 12.0 * req.num_layers * hidden * hidden
        flop = 2.0 * params * req.prompt_tokens
        return flop / (tflops * 1e12) * 1000.0

    def estimate_decode_tpot_ms(self, req: PDRequest,
                                worker_id: Optional[str] = None) -> float:
        """Decode is bandwidth-bound: each token streams weights + KV once."""
        w = self._workers.get(worker_id or req.decode_worker or "")
        bw = w.cap.memory_bandwidth_gbps if w else 819.0
        hidden = req.num_kv_heads * req.head_dim * 4
        weight_bytes = 2.0 * 12.0 * req.num_layers * hidden * hidden
        bytes_per_tok = weight_bytes + req.kv_bytes
        return bytes_per_tok / (bw * 1e9) * 1000.0

    def estimate_migration_ms(self, req: PDRequest, src: str, dst: str) -> float:
        w = self._workers.get(src)
        gBps = w.cap.interconnect_gbps if w else 25.0  # GB/s, like all BW here
        return req.kv_bytes / (gBps * 1e9) * 1000.0

    def capacity_by_role(self) -> Dict[str, int]:
        """Free serving capacity per PD role (prefill slots / decode slots
        still available across the registered pool) — the ``pd_fleet_
        balance`` gauge. A side at 0 while the other has headroom is the
        brownout the role-rebalance fallback exists for."""
        cap = {"prefill": 0, "decode": 0}
        for w in self._workers.values():
            if w.cap.can_prefill:
                cap["prefill"] += max(
                    0, w.cap.max_prefill_batch - w.active_prefill
                )
            if w.cap.can_decode:
                cap["decode"] += max(
                    0, w.cap.max_decode_batch - w.active_decode
                )
        return cap

    def get_stats(self) -> Dict[str, Any]:
        out = dict(self.stats)
        out["prefill_queue"] = len(self._prefill_q)
        out["decode_queue"] = len(self._decode_q)
        out["workers"] = {
            wid: {
                "role": w.cap.role.value,
                "active_prefill": w.active_prefill,
                "active_decode": w.active_decode,
                "total_prefills": w.total_prefills,
                "total_decodes": w.total_decodes,
            }
            for wid, w in self._workers.items()
        }
        if self.migrator is not None:
            out["migrator"] = self.migrator.get_stats()
        return out


# ---------------------------------------------------------------------------
# KV migration
# ---------------------------------------------------------------------------

# transport(kv_cache_key, src_worker, dst_worker) -> bytes moved
Transport = Callable[[str, str, str], Awaitable[int]]


class KVCacheMigrator:
    """Moves KV pages between pool partitions, deduping concurrent migrations
    of the same key (reference ``KVCacheMigrator``, pd_scheduler.py:404-479 —
    whose transfer body was a simulated sleep; ours calls a real transport)."""

    def __init__(self, transport: Transport) -> None:
        self._transport = transport
        self._in_flight: Dict[str, asyncio.Task] = {}
        self.stats: Dict[str, Any] = {
            "migrations": 0, "deduped": 0, "bytes_moved": 0, "failures": 0,
            # bounded: a long-lived scheduler must not grow stats without limit
            "latencies_ms": deque(maxlen=1024),
        }

    async def migrate(self, kv_cache_key: str, src: str, dst: str) -> int:
        """Returns bytes moved. Concurrent calls for the same key await ONE
        underlying transfer."""
        key = f"{kv_cache_key}->{dst}"
        task = self._in_flight.get(key)
        if task is not None:
            self.stats["deduped"] += 1
            return await asyncio.shield(task)
        task = asyncio.ensure_future(self._run(kv_cache_key, src, dst))
        self._in_flight[key] = task
        try:
            return await task
        finally:
            self._in_flight.pop(key, None)

    async def _run(self, kv_cache_key: str, src: str, dst: str) -> int:
        t0 = time.monotonic()
        try:
            moved = await self._transport(kv_cache_key, src, dst)
        except Exception:
            self.stats["failures"] += 1
            raise
        self.stats["migrations"] += 1
        self.stats["bytes_moved"] += moved
        self.stats["latencies_ms"].append((time.monotonic() - t0) * 1000.0)
        return moved

    def get_stats(self) -> Dict[str, Any]:
        lat = list(self.stats["latencies_ms"])
        out = {k: v for k, v in self.stats.items() if k != "latencies_ms"}
        if lat:
            s = sorted(lat)
            out["p50_ms"] = s[len(s) // 2]
            out["p95_ms"] = s[min(len(s) - 1, int(len(s) * 0.95))]
        return out


class InProcessKVTransport:
    """Real in-process transport for tests/benchmarks and single-host
    deployments: export from the source engine, frame the bytes through the
    DCN wire format, adopt into the destination engine.

    Register each partition's engine plus the slot resolver; production
    deployments swap this for an HTTP/ICI transport with the same signature.

    Engine access is serialized through ``executor``: pass the SAME
    single-thread executor the engines' batcher uses
    (``ContinuousBatcher._exec``) so export/adopt never race a decode_step;
    by default the transport owns a dedicated max_workers=1 executor, which
    is safe when nothing else drives the engines concurrently.
    """

    def __init__(self, compress: bool = True,
                 executor: Optional[Any] = None) -> None:
        from concurrent.futures import ThreadPoolExecutor

        self._engines: Dict[str, Any] = {}
        # kv_cache_key -> (worker_id, slot)
        self._locations: Dict[str, Tuple[str, int]] = {}
        self._adopted: Dict[str, int] = {}
        self.compress = compress
        self._exec = executor or ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="kv-migrate"
        )

    def register_engine(self, worker_id: str, engine: Any) -> None:
        self._engines[worker_id] = engine

    def record_location(self, kv_cache_key: str, worker_id: str, slot: int) -> None:
        self._locations[kv_cache_key] = (worker_id, slot)

    def adopted_slot(self, kv_cache_key: str) -> Optional[int]:
        return self._adopted.get(kv_cache_key)

    async def __call__(self, kv_cache_key: str, src: str, dst: str) -> int:
        from distributed_gpu_inference_torch.runtime.kv_handoff import (
            adopt_kv,
            deserialize_handoff,
            export_slot_kv,
            serialize_handoff,
        )

        loc = self._locations.get(kv_cache_key)
        if loc is None:
            raise KeyError(f"unknown kv_cache_key {kv_cache_key}")
        src_worker, slot = loc
        if src_worker != src:
            src = src_worker
        src_engine = self._engines[src]
        dst_engine = self._engines[dst]
        loop = asyncio.get_running_loop()

        def _move() -> Tuple[int, int]:
            handoff = export_slot_kv(src_engine, slot)
            wire = serialize_handoff(handoff, compress=self.compress)
            new_slot = adopt_kv(dst_engine, deserialize_handoff(wire))
            src_engine.finish_slot(slot, cache=False)
            return len(wire), new_slot

        nbytes, new_slot = await loop.run_in_executor(self._exec, _move)
        self._locations[kv_cache_key] = (dst, new_slot)
        self._adopted[kv_cache_key] = new_slot
        return nbytes
