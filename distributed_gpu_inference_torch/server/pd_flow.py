"""Control-plane orchestration of prefill/decode-disaggregated jobs.

This is the wiring the reference never built: its ``pd_scheduler.py`` is a
standalone service no API route consults (SURVEY C30 "standalone; not wired
into C24/C25"), and its KV migration is a 50 ms sleep
(``server/app/services/pd_scheduler.py:462-472``). Here a job submitted with
``params.pd_disaggregated`` flows end to end through the REAL pieces:

1. **Placement** — role-tagged registered workers (store ``role`` column,
   ``WorkerRole`` in C1) are mirrored into :class:`PrefillDecodeScheduler`
   capabilities (topology-derived TFLOPs/bandwidth) and the request is
   placed on a prefill worker and a decode worker at submission.
2. **Prefill stage** — a child job pinned to the prefill worker
   (``params.target_worker``; the store's claim loop enforces the pin). The
   worker's LLM engine prefills, samples the first token (TTFT), exports the
   sequence's KV pages (``runtime/kv_handoff.py``), and POSTs the serialized
   handoff DIRECTLY to the decode worker's data plane (``/kv/transfer``,
   the HTTP twin of grpc TransferKVCache) — KV bytes never pass through the
   control plane.
3. **Decode stage** — a second child pinned to the decode worker, which
   resumes the adopted slot and streams the rest of the generation
   (bit-exact greedy continuation — the kv_handoff invariant).
4. **Merge** — the parent job completes with the full token stream plus
   end-to-end TTFT and real migration bytes/ms in the result.

Parent jobs are created RUNNING (never claimable); children carry
``pd_parent`` and the flow advances in the ``complete_job`` hook.

The port's copy of ``distributed_gpu_inference_tpu/server/pd_flow.py``, on the
standard library and the port's own modules.
"""

from __future__ import annotations

import asyncio
import random
import time
import uuid
from typing import Any, Dict, Optional

from ..utils.data_structures import TpuTopology, WorkerRole
from .pd_scheduler import PDRequest, PrefillDecodeScheduler, WorkerCapability
from .store import Store


class PDFlowError(RuntimeError):
    pass


class PDFlowService:
    """Drives pd-disaggregated jobs through prefill → handoff → decode,
    with a re-prefill fallback: a failed stage (prefill worker died
    mid-transfer, decode worker died after adoption, handoff lost or
    corrupted) re-places the WHOLE flow — prompt prefilled again on a
    surviving worker, failed workers excluded — up to ``max_reprefills``
    times, WITHOUT burning the parent job's own retry budget (stage
    children carry their own ``retry_count``; the flow's attempt counter
    is independent of both)."""

    # re-prefill budget per flow: attempts 0..max_reprefills (the prompt
    # is recomputed from scratch each time, so this bounds wasted FLOPs,
    # not correctness — greedy outputs are identical on any attempt)
    MAX_REPREFILLS = 3
    # jittered exponential backoff BETWEEN attempts
    # (``U(0.5, 1.5)·base·2^(attempt-1)``): a handoff-partition window
    # lasting a couple of seconds must not eat the whole budget in its
    # first 200 ms — attempts spread past the outage instead. 0 disables
    # (immediate, synchronous re-placement — deterministic tests).
    REPREFILL_BACKOFF_S = 0.5

    def __init__(self, store: Store,
                 scheduler: Optional[PrefillDecodeScheduler] = None,
                 metrics: Optional[Any] = None,
                 max_reprefills: int = MAX_REPREFILLS,
                 reprefill_backoff_s: float = REPREFILL_BACKOFF_S) -> None:
        self.store = store
        self.scheduler = scheduler or PrefillDecodeScheduler()
        self.metrics = metrics
        self.max_reprefills = max_reprefills
        self.reprefill_backoff_s = reprefill_backoff_s
        # predictive rebalance: optional
        # ``server.autoscaler.PredictiveRebalancer`` ticked on every
        # placement sync — None (default) keeps the reactive-only build
        self.rebalancer: Optional[Any] = None
        # request_id → PDRequest (placement state released on completion)
        self._live: Dict[str, PDRequest] = {}
        # in-flight delayed re-placement tasks (strong refs)
        self._bg: set = set()
        self.stats = {"submitted": 0, "completed": 0, "failed": 0,
                      "reprefills": 0, "stale_stage_results": 0}

    # ---------------------------------------------------------------- sync

    async def _sync_workers(self) -> None:
        """Mirror role-tagged, live workers into scheduler capabilities."""
        rows = await self.store.list_workers(status=("idle", "online", "busy"))
        seen = set()
        for w in rows:
            if "llm" not in (w.get("supported_types") or []):
                continue
            topo = TpuTopology.from_dict(w["topology"]) if w.get("topology") \
                else TpuTopology()
            role = WorkerRole(w.get("role") or "hybrid")
            cap = WorkerCapability.from_topology(w["id"], topo, role=role)
            # refresh IN PLACE for live workers (register_worker would
            # zero active_prefill/active_decode for live placements,
            # unbinding the batch caps) — and a predictive preflip must
            # survive the refresh, so the scheduler owns the merge
            self.scheduler.refresh_worker(cap)
            seen.add(w["id"])
        for wid in [w.cap.worker_id for w in
                    self.scheduler._workers.values()]:
            if wid not in seen:
                self.scheduler.remove_worker(wid)
        if self.rebalancer is not None:
            # predictive rebalance rides the placement sync: the
            # projection is re-read against fresh capabilities, preflips
            # restore once it recovers. Advisory — a rebalancer failure
            # never blocks a placement.
            try:
                self.rebalancer.tick()
            except Exception:  # noqa: BLE001
                pass
        if self.metrics is not None:
            # pd_fleet_balance{role}: free capacity per side, refreshed on
            # every placement pass — a side pinned at 0 while the other
            # has headroom is the brownout rebalance absorbs
            self.metrics.record_pd_fleet_balance(
                self.scheduler.capacity_by_role()
            )

    # -------------------------------------------------------------- submit

    async def on_parent_terminal(self, parent_id: str) -> None:
        """A parent went terminal outside the normal child-completion path
        (cancellation, sweep timeout, permanent child failure): release the
        placement state and cancel any still-queued stage children — a
        pinned child of a dead container would otherwise sit QUEUED forever
        (nothing else may claim it) and pin scheduler capacity."""
        self._finish(parent_id, ok=False)
        await self._cancel_queued_children(parent_id)

    @staticmethod
    def _child_id(parent_id: str, stage: str, attempt: int) -> str:
        """Deterministic stage-child id per re-prefill attempt — attempt 0
        keeps the legacy un-suffixed id (restart compatibility), retries
        append ``-rN`` so a stale attempt's children never collide with
        the live attempt's."""
        base = f"{parent_id}-{stage}"
        return base if attempt <= 0 else f"{base}-r{attempt}"

    async def _cancel_queued_children(self, parent_id: str) -> None:
        for stage in ("prefill", "decode"):
            for attempt in range(self.max_reprefills + 1):
                child_id = self._child_id(parent_id, stage, attempt)
                child = await self.store.get_job(child_id)
                if child is not None and child["status"] == "queued":
                    # conditional transition: a pinned worker may claim/
                    # finish the child between the read and this write,
                    # and a terminal status must never be clobbered back
                    # to CANCELLED
                    await self.store.try_transition_job(
                        child_id, "queued", status="cancelled",
                        completed_at=time.time(),
                    )

    async def on_job_permanently_failed(self, job: Dict[str, Any]) -> None:
        """TaskGuarantee hook: the sweeps failed ``job`` for good (retries
        exhausted, container timeout, pinned worker gone). PD containers
        release placement and cancel orphaned children; PD stage children
        enter the RE-PREFILL fallback (the flow re-places the whole
        generation on surviving workers) and only fail their container
        when the re-prefill budget is spent — a stranded parent holds a
        scheduler placement and keeps its sync waiters hanging the full
        window."""
        params = job.get("params") or {}
        # child check FIRST: stage children inherit the container's params
        # (pd_disaggregated included) and would otherwise match the
        # container branch and silently orphan their parent
        if self.is_pd_child(job):
            parent_id = params["pd_parent"]
            parent = await self.store.get_job(parent_id)
            if parent is not None and parent["status"] not in (
                "completed", "failed", "cancelled"
            ):
                await self._stage_failed(parent_id, params["pd_stage"], job)
            return
        if params.get("pd_disaggregated"):
            await self.on_parent_terminal(job["id"])

    async def _prune_live(self) -> None:
        """Drop placements whose parent went terminal without passing
        through on_child_complete (e.g. swept by the stale-job timeout) so
        worker active-counters cannot leak."""
        for pid in list(self._live.keys()):
            job = await self.store.get_job(pid)
            if job is None or job["status"] in (
                "completed", "failed", "cancelled"
            ):
                self._finish(pid, ok=False)

    async def submit(self, parent: Dict[str, Any]) -> None:
        """Place a pd job and enqueue its prefill child. Parent is already
        stored with status=running (unclaimable container)."""
        await self._prune_live()
        await self._sync_workers()
        params = parent.get("params") or {}
        prompt = params.get("prompt_token_ids") or params.get("prompt") or []
        # token lists count exactly; raw text estimates ~4 chars/token so the
        # scheduler's prefill scoring isn't skewed 4-5x by character counts
        n_prompt = len(prompt) if isinstance(prompt, list) \
            else max(1, len(prompt) // 4)
        req = PDRequest(
            request_id=parent["id"],
            prompt_tokens=n_prompt,
            max_new_tokens=int(params.get("max_tokens") or 256),
            model_name=params.get("model") or "llama3-8b",
        )
        await self._place_and_enqueue(parent, req)
        self._live[parent["id"]] = req
        self.stats["submitted"] += 1

    async def _place_and_enqueue(self, parent: Dict[str, Any],
                                 req: PDRequest) -> None:
        """Place ``req`` on a prefill + decode pair and enqueue this
        attempt's pinned prefill child. Raises :class:`PDFlowError` (with
        placement fully released) when no capable pair exists."""
        params = parent.get("params") or {}
        pw = self.scheduler.place_prefill(req)
        if pw is None:
            raise PDFlowError("no prefill-capable worker available")
        # decode placed up front so the prefill worker knows where to push
        # KV; kv_holder is the prefill worker once prefill lands
        req.kv_holder = pw
        dw = self.scheduler.place_decode(req)
        if dw is None:
            self.scheduler.release(req)
            req.prefill_worker = None
            raise PDFlowError("no decode-capable worker available")
        decode_row = await self.store.get_worker(dw)
        decode_url = (decode_row or {}).get("data_plane_url")
        if dw != pw and not decode_url:
            self.scheduler.release(req)
            req.prefill_worker = req.decode_worker = None
            raise PDFlowError(
                f"decode worker {dw} advertises no data_plane_url for the "
                "KV handoff"
            )
        # fresh key per attempt: a stale attempt's adopted KV (if its push
        # landed after all) can never be claimed by the live attempt's
        # decode stage — it ages out via the worker's pd-slot TTL
        req.kv_cache_key = f"pd-{parent['id']}-{uuid.uuid4().hex[:8]}"
        child_params = {
            **params,
            "pd_stage": "prefill",
            "pd_parent": parent["id"],
            "pd_attempt": req.attempt,
            "target_worker": pw,
            "decode_worker": dw,
            "decode_url": decode_url,
            "kv_cache_key": req.kv_cache_key,
        }
        await self.store.create_job({
            "id": self._child_id(parent["id"], "prefill", req.attempt),
            "type": parent["type"],
            "params": child_params,
            "priority": int(parent.get("priority") or 0) + 5,
            "timeout_seconds": parent.get("timeout_seconds") or 300.0,
        })

    # ------------------------------------------------------------ advance

    def is_pd_child(self, job: Dict[str, Any]) -> bool:
        p = job.get("params") or {}
        return bool(p.get("pd_parent") and p.get("pd_stage"))

    async def on_child_complete(self, child: Dict[str, Any]) -> None:
        """Advance the flow when a pinned stage job finishes."""
        params = child.get("params") or {}
        parent_id = params["pd_parent"]
        stage = params["pd_stage"]
        parent = await self.store.get_job(parent_id)
        if parent is None:
            return
        if parent["status"] in ("completed", "failed", "cancelled"):
            # late child of a terminal (e.g. cancelled) parent: release any
            # placement state, never overwrite the terminal status
            self._finish(parent_id, ok=False)
            return
        req = self._live.get(parent_id)
        if req is not None and \
                int(params.get("pd_attempt") or 0) != req.attempt:
            # a STALE attempt's child finished late (its worker revived
            # after the flow re-prefilled elsewhere): the live attempt
            # owns the flow — ignore. KV the stale prefill pushed ages
            # out via the decode worker's pd-slot TTL (fresh key per
            # attempt, so the live decode stage can never claim it).
            self.stats["stale_stage_results"] += 1
            return
        if child["status"] != "completed":
            await self._stage_failed(parent_id, stage, child)
            return
        result = child.get("result") or {}
        if stage == "prefill":
            # decode needs only the sampling config + flow keys — NOT the
            # prompt (its KV already moved) or prefill-only routing. A
            # multi-MB prompt stored a third time would also hit the claim
            # path's params parse.
            decode_params = {
                k: v for k, v in params.items()
                if k not in ("pd_stage", "target_worker", "prompt",
                             "prompt_token_ids", "messages", "decode_url")
            }
            decode_params.update({
                "pd_stage": "decode",
                "target_worker": params["decode_worker"],
                "kv_cache_key": params["kv_cache_key"],
                # carried so the final merge needs no extra store round-trip
                "pd_prefill_result": {
                    "first_token": result.get("first_token"),
                    "ttft_ms": result.get("ttft_ms"),
                    "migration_bytes": result.get("migration_bytes"),
                    "migration_ms": result.get("migration_ms"),
                    "prefill_worker": child.get("worker_id"),
                },
            })
            await self.store.create_job({
                "id": self._child_id(
                    parent_id, "decode", int(params.get("pd_attempt") or 0)
                ),
                "type": parent["type"],
                "params": decode_params,
                "priority": int(parent.get("priority") or 0) + 5,
                "timeout_seconds": parent.get("timeout_seconds") or 300.0,
            })
            return
        # stage == "decode": merge and complete the parent
        pre = params.get("pd_prefill_result") or {}
        merged = {
            **result,
            "pd_disaggregated": True,
            "prefill_worker": pre.get("prefill_worker"),
            "decode_worker": child.get("worker_id"),
            "ttft_ms": pre.get("ttft_ms", result.get("ttft_ms")),
            "migration_bytes": pre.get("migration_bytes"),
            "migration_ms": pre.get("migration_ms"),
        }
        now = time.time()
        # conditional: a cancel racing this merge between the status check
        # above and here must keep its terminal state (terminal is terminal)
        won = await self.store.try_transition_job(
            parent_id, "running",
            status="completed", result=merged, completed_at=now,
            actual_duration_ms=(
                (now - float(parent["started_at"])) * 1000.0
                if parent.get("started_at") else None
            ),
        )
        self._finish(parent_id, ok=won)

    @staticmethod
    def _failure_reason(stage: str, error: str) -> str:
        """Counted re-prefill reason (``pd_reprefill_total{reason}``)."""
        low = (error or "").lower()
        if "no adopted kv" in low or "reclaimed" in low:
            return "kv_holder_lost"
        if "push" in low or "handoff" in low or "kv/transfer" in low:
            return "handoff_failed"
        return f"{stage}_failed"

    async def _stage_failed(self, parent_id: str, stage: str,
                            child: Dict[str, Any]) -> None:
        """A stage child went terminal without completing (worker died
        mid-transfer, handoff lost/corrupted, adopted KV gone, pinned
        worker swept): RE-PREFILL — release the placement, exclude the
        failed workers, and re-run the whole flow on survivors. The
        parent's own retry budget is untouched; the flow's attempt
        counter bounds the fallback. Out of budget (or flow state lost to
        a plane restart) → fail the parent as before."""
        params = child.get("params") or {}
        error = child.get("error") or f"{stage} stage failed"
        req = self._live.get(parent_id)
        if req is not None and \
                int(params.get("pd_attempt") or 0) != req.attempt:
            # stale attempt failing late: the live attempt owns the flow
            self.stats["stale_stage_results"] += 1
            return
        if req is None or req.attempt >= self.max_reprefills:
            await self._fail(parent_id, stage, error)
            return
        parent = await self.store.get_job(parent_id)
        if parent is None or parent["status"] in (
            "completed", "failed", "cancelled"
        ):
            self._finish(parent_id, ok=False)
            return
        # release the failed placement; exclude the stage's pinned worker
        # (and, for a prefill/handoff failure, the push target — a dead
        # RECEIVER fails the sender's child). Exclusions are advisory:
        # the scheduler retries over everyone before giving up.
        self.scheduler.release(req)
        excluded = {params.get("target_worker")}
        if stage == "prefill":
            excluded.add(params.get("decode_worker"))
        req.excluded_workers |= {w for w in excluded if w}
        req.prefill_worker = req.decode_worker = None
        req.kv_holder = None
        req.needs_migration = False
        req.attempt += 1
        self.stats["reprefills"] += 1
        if self.metrics is not None:
            self.metrics.record_pd_reprefill(
                self._failure_reason(stage, error)
            )
        # a still-queued sibling of the failed attempt (e.g. its decode
        # child) must not run against KV that no longer exists
        await self._cancel_queued_children(parent_id)
        if self.reprefill_backoff_s <= 0 or req.attempt == 1:
            # FIRST fallback places immediately: a one-off failure (worker
            # died, KV lost) recovers with no added latency, and a flow
            # whose re-placement cannot succeed at all (fleet dark) fails
            # promptly in the same pass
            await self._replace_now(parent_id, req, stage, error)
            return
        # repeat failures back off with jitter before the next attempt: a
        # handoff outage lasting a couple of seconds must not consume the
        # whole budget before it heals
        delay = (self.reprefill_backoff_s * (2 ** (req.attempt - 2))
                 * (0.5 + random.random()))
        task = asyncio.ensure_future(
            self._replace_later(parent_id, req, req.attempt, stage,
                                error, delay)
        )
        self._bg.add(task)
        task.add_done_callback(self._bg.discard)

    async def _replace_now(self, parent_id: str, req: PDRequest,
                           stage: str, error: str) -> None:
        await self._sync_workers()
        parent = await self.store.get_job(parent_id)
        if parent is None or parent["status"] in (
            "completed", "failed", "cancelled"
        ):
            self._finish(parent_id, ok=False)
            return
        try:
            await self._place_and_enqueue(parent, req)
        except PDFlowError as exc:
            await self._fail(
                parent_id, stage,
                f"{error}; re-prefill placement failed: {exc}",
            )

    async def _replace_later(self, parent_id: str, req: PDRequest,
                             attempt: int, stage: str, error: str,
                             delay: float) -> None:
        try:
            await asyncio.sleep(delay)
            # the flow may have gone terminal (cancel, timeout) or been
            # superseded while we slept — only the still-live attempt we
            # scheduled for may place
            if self._live.get(parent_id) is not req or \
                    req.attempt != attempt:
                return
            await self._replace_now(parent_id, req, stage, error)
        except Exception:  # noqa: BLE001 — a failed re-place must not
            # leak an unobserved task exception; the parent either fails
            # via _replace_now or the sweeps time it out
            pass

    async def _fail(self, parent_id: str, stage: str, error: str) -> None:
        # conditional: a cancel or completion racing this failure between
        # the caller's status check and here keeps its terminal state —
        # placement is released either way, but only the transition winner
        # cancels queued children (the racing path owns its own cleanup)
        won = await self.store.try_transition_job(
            parent_id, "running",
            status="failed",
            error=f"pd {stage} stage: {error}", completed_at=time.time(),
        )
        self._finish(parent_id, ok=False)
        if won:
            await self._cancel_queued_children(parent_id)

    def _finish(self, parent_id: str, ok: bool) -> None:
        req = self._live.pop(parent_id, None)
        if req is not None:
            # stats count each flow once — a late child arriving after the
            # parent went terminal finds _live already drained and is a no-op
            self.scheduler.release(req)
            self.stats["completed" if ok else "failed"] += 1

    def get_stats(self) -> Dict[str, Any]:
        return {**self.stats, "live": len(self._live),
                "scheduler": self.scheduler.get_stats()}
