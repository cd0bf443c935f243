"""Failure detection, retry/requeue, sync-wait — the delivery guarantee layer.

Behavioral parity with the reference's ``server/app/services/task_guarantee.py``:
- On worker offline: requeue its RUNNING jobs until ``max_retries``, then fail
  (:60-96).
- Stale-job sweep: RUNNING jobs past per-job timeout (default cap 30 min)
  are requeued/failed (:98-158).
- Dead-worker sweep: heartbeat older than 90 s → worker OFFLINE, its jobs
  requeued (:160-185).
- ``wait_for_job``: poll until terminal status or timeout (:187-228).
- Background loop every 30 s (:231-263).

The port's copy of ``distributed_gpu_inference_tpu/server/task_guarantee.py``, on the
standard library and the port's own modules.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Awaitable, Callable, Dict, List, Optional

from ..utils.data_structures import JobStatus, WorkerState
from .reliability import ReliabilityService
from .store import Store

log = logging.getLogger("dgi-tpu.task_guarantee")

HEARTBEAT_TIMEOUT_S = 90.0
STALE_JOB_CAP_S = 30 * 60.0
SWEEP_INTERVAL_S = 30.0
SYNC_POLL_INTERVAL_S = 0.5
# direct-stream checkpoints are retired by AGE, not by the worker: a worker
# cannot know its final SSE bytes reached the client, so an eager "done"
# delete could erase the state a tail-less client still needs to resume
STREAM_CHECKPOINT_TTL_S = 30 * 60.0


class TaskGuaranteeService:
    def __init__(self, store: Store,
                 reliability: Optional[ReliabilityService] = None,
                 heartbeat_timeout_s: float = HEARTBEAT_TIMEOUT_S,
                 on_permanent_failure: Optional[
                     Callable[[Dict[str, Any]], Awaitable[None]]
                 ] = None,
                 on_worker_offline: Optional[
                     Callable[[str, str], Awaitable[None]]
                 ] = None) -> None:
        self._store = store
        self._reliability = reliability or ReliabilityService(store)
        self._heartbeat_timeout_s = heartbeat_timeout_s
        # called with the job row whenever a sweep marks a job FAILED for
        # good (retries exhausted, container timeout, pinned worker gone);
        # the PD flow uses it to fail containers promptly (server/app.py)
        self.on_permanent_failure = on_permanent_failure
        # called with (worker_id, reason) whenever a worker is marked
        # offline — ServerState uses it to zero the worker's advertised
        # prefix summary immediately (routing must not keep preferring a
        # dead warm worker for the rest of its staleness TTL)
        self.on_worker_offline = on_worker_offline

    async def _notify_failed(self, job_id: str) -> None:
        if self.on_permanent_failure is None:
            return
        job = await self._store.get_job(job_id)
        if job is None:
            return
        try:
            await self.on_permanent_failure(job)
        except Exception:  # noqa: BLE001 — propagation must not break sweeps
            log.exception(
                "permanent-failure hook failed for job %s (its PD container,"
                " if any, will only terminate via its own timeout)",
                job.get("id"),
            )

    # -- requeue machinery ---------------------------------------------------

    async def requeue_job(self, job: Dict[str, Any],
                          reason: str = "worker_offline") -> str:
        """Requeue one job (or fail it if retries exhausted). Returns the
        job's resulting status value. Frees the assigned worker's capacity
        state so a timed-out job doesn't leave a phantom BUSY worker.

        Every job write is a CONDITIONAL transition from the caller's
        snapshot status: a completion racing the sweep (slow-but-alive
        worker reporting just as the sweep fires) must keep its terminal
        status — an unconditional overwrite would revert COMPLETED to
        QUEUED and re-execute the job, double-applying reliability and
        usage."""
        wid = job.get("worker_id")
        if wid:
            w = await self._store.get_worker(wid)
            if w is not None and w.get("current_job_id") == job["id"]:
                fields: Dict[str, Any] = {"current_job_id": None}
                if w.get("status") == WorkerState.BUSY.value:
                    fields["status"] = WorkerState.IDLE.value
                await self._store.update_worker(wid, **fields)

        async def _lost_race() -> str:
            cur = await self._store.get_job(job["id"])
            return cur["status"] if cur is not None else JobStatus.FAILED.value

        params = job.get("params") or {}
        if params.get("pd_disaggregated") and not params.get("pd_stage"):
            # a PD CONTAINER job must never become claimable: requeueing it
            # would hand the whole generation to an arbitrary worker while
            # its pinned stage children still run (double execution). On
            # timeout the flow fails; a late stage completion finds the
            # parent terminal and no-ops (pd_flow.on_child_complete guard).
            # Stage children requeue normally below — they INHERIT the
            # parent's params (pd_disaggregated included), so the pd_stage
            # exclusion above is what keeps them out of this branch.
            won = await self._store.try_transition_job(
                job["id"], job["status"],
                status=JobStatus.FAILED.value,
                error=f"pd flow timed out: {reason}",
                completed_at=time.time(),
            )
            if not won:
                return await _lost_race()
            await self._notify_failed(job["id"])
            return JobStatus.FAILED.value
        retries = int(job.get("retry_count") or 0)
        max_retries = int(job.get("max_retries") or 3)
        if retries + 1 > max_retries:
            fields: Dict[str, Any] = {
                "status": JobStatus.FAILED.value,
                "error": f"exceeded max_retries ({max_retries}): {reason}",
                "completed_at": time.time(),
            }
            partial = self._partial_from_checkpoint(job)
            if partial is not None and not job.get("result"):
                # the job dies, but its last checkpoint's decoded tokens
                # don't have to: surface them exactly like the engine's
                # preempted_too_often partials, so a client can keep what
                # the fleet DID produce across however many failovers
                fields["result"] = partial
            won = await self._store.try_transition_job(
                job["id"], job["status"], owned_by=wid, **fields
            )
            if not won:
                return await _lost_race()
            await self._notify_failed(job["id"])
            return JobStatus.FAILED.value
        # NOTE: the job's ``checkpoint`` column is deliberately untouched —
        # a requeued job carries its latest generation checkpoint to the
        # next claimant, which resumes instead of regenerating
        won = await self._store.try_transition_job(
            job["id"], job["status"], owned_by=wid,
            status=JobStatus.QUEUED.value,
            worker_id=None,
            started_at=None,
            retry_count=retries + 1,
        )
        if not won:
            return await _lost_race()
        return JobStatus.QUEUED.value

    @staticmethod
    def _partial_from_checkpoint(
        job: Dict[str, Any]
    ) -> Optional[Dict[str, Any]]:
        """Partial-output payload recovered from a job's latest generation
        checkpoint (None when there is nothing to preserve)."""
        ckpt = job.get("checkpoint")
        if not isinstance(ckpt, dict):
            return None
        gen = ckpt.get("generated")
        if not gen:
            return None
        return {
            "partial": True,
            "partial_token_ids": [int(t) for t in gen],
            "partial_tokens": len(gen),
        }

    async def handle_worker_offline(self, worker_id: str,
                                    graceful: bool = False,
                                    reason: str = "worker_offline"
                                    ) -> List[str]:
        """Mark worker offline and requeue its running jobs (:60-96)."""
        running = await self._store.list_jobs(
            status=[JobStatus.RUNNING.value], worker_id=worker_id
        )
        requeued = []
        for job in running:
            await self.requeue_job(job, reason=reason)
            requeued.append(job["id"])
        await self._store.update_worker(
            worker_id,
            status=WorkerState.OFFLINE.value,
            current_job_id=None,
        )
        await self._reliability.end_session(worker_id, graceful=graceful)
        if self.on_worker_offline is not None:
            try:
                await self.on_worker_offline(worker_id, reason)
            except Exception:  # noqa: BLE001 — advisory hook, never fatal
                log.exception("worker-offline hook failed for %s", worker_id)
        return requeued

    # -- sweeps ---------------------------------------------------------------

    async def sweep_stale_jobs(self, now: Optional[float] = None) -> List[str]:
        now = time.time() if now is None else now
        running = await self._store.list_jobs(
            status=[JobStatus.RUNNING.value], limit=1000
        )
        swept = []
        for job in running:
            started = job.get("started_at")
            if started is None:
                continue
            timeout = min(
                float(job.get("timeout_seconds") or 300.0), STALE_JOB_CAP_S
            )
            if now - float(started) > timeout:
                await self.requeue_job(job, reason="job_timeout")
                swept.append(job["id"])
        return swept

    async def sweep_dead_workers(self, now: Optional[float] = None) -> List[str]:
        now = time.time() if now is None else now
        workers = await self._store.list_workers(
            status=[
                WorkerState.IDLE.value,
                WorkerState.BUSY.value,
                WorkerState.DRAINING.value,
            ]
        )
        dead = []
        for w in workers:
            hb = w.get("last_heartbeat")
            if hb is None or now - float(hb) > self._heartbeat_timeout_s:
                # handle_worker_offline → end_session(graceful=False) already
                # applies the unexpected_offline penalty exactly once
                await self.handle_worker_offline(
                    w["id"], graceful=False, reason="heartbeat_stale"
                )
                dead.append(w["id"])
        return dead

    async def sweep_orphaned_pins(
        self, now: Optional[float] = None
    ) -> List[str]:
        """QUEUED jobs pinned to a worker (``params.target_worker`` — PD
        stage children, whose KV lives or lands on exactly that worker)
        can only ever be claimed by their pin. When the pinned worker is
        gone for good the job is unrunnable — no retry can help, because
        the pin IS the point — so fail it; the permanent-failure hook
        fails the container in the same pass. Without this sweep such a
        child sits QUEUED forever (the stale sweep covers only RUNNING)
        and strands its parent for the full container timeout.

        A freshly-OFFLINE worker gets a grace window of one extra
        heartbeat timeout: heartbeats revive OFFLINE workers (a flap is
        recoverable), and failing every pinned generation on a single
        missed heartbeat would turn a transient blip into data loss."""
        import json as _json

        now = time.time() if now is None else now
        # substring pre-filter (same idiom as the claim path): pinned jobs
        # are the rare case, so select exactly them — no LIMIT cap that
        # could silently exempt low-priority pins under a deep backlog
        rows = await self._store.query(
            "SELECT id, params FROM jobs WHERE status=? AND params LIKE ?",
            (JobStatus.QUEUED.value, '%"target_worker"%'),
        )
        failed = []
        worker_cache: Dict[str, Optional[Dict[str, Any]]] = {}
        for job in rows:
            try:
                target = (_json.loads(job["params"] or "{}")
                          .get("target_worker"))
            except ValueError:
                continue
            if not target:
                continue
            if target not in worker_cache:
                worker_cache[target] = await self._store.get_worker(target)
            w = worker_cache[target]
            if w is not None:
                if w.get("status") != WorkerState.OFFLINE.value:
                    continue
                hb = w.get("last_heartbeat")
                if hb is not None and \
                        now - float(hb) < 2.0 * self._heartbeat_timeout_s:
                    continue    # flap grace: the pin may still come back
            # conditional transition: a revived pin racing this sweep may
            # have just claimed the job (QUEUED→RUNNING) — never clobber a
            # live claim with FAILED
            won = await self._store.try_transition_job(
                job["id"], JobStatus.QUEUED.value,
                status=JobStatus.FAILED.value,
                error=f"pinned worker {target} offline",
                completed_at=now,
            )
            if not won:
                continue
            await self._notify_failed(job["id"])
            failed.append(job["id"])
        return failed

    async def sweep_stale_stream_checkpoints(
        self, now: Optional[float] = None
    ) -> List[str]:
        """Age out direct-stream checkpoints nobody resumed: a client that
        lost a stream tail reconnects within seconds, so anything older
        than ``STREAM_CHECKPOINT_TTL_S`` is an abandoned stream whose
        state would otherwise accumulate forever."""
        now = time.time() if now is None else now
        rows = await self._store.query(
            "SELECT stream_id FROM stream_checkpoints WHERE updated_at < ?",
            (now - STREAM_CHECKPOINT_TTL_S,),
        )
        purged = [r["stream_id"] for r in rows]
        if purged:
            await self._store.execute(
                "DELETE FROM stream_checkpoints WHERE updated_at < ?",
                (now - STREAM_CHECKPOINT_TTL_S,),
            )
        return purged

    async def sweep(self, now: Optional[float] = None) -> Dict[str, List[str]]:
        return {
            "dead_workers": await self.sweep_dead_workers(now=now),
            "stale_jobs": await self.sweep_stale_jobs(now=now),
            # after the dead-worker pass: once a pinned worker's flap grace
            # (2× heartbeat timeout) has elapsed, its freshly-OFFLINE state
            # and its children's orphaning land in the same sweep pass
            "orphaned_pins": await self.sweep_orphaned_pins(now=now),
            "stale_stream_checkpoints":
                await self.sweep_stale_stream_checkpoints(now=now),
        }

    # -- sync wait (reference :187-228) ---------------------------------------

    async def wait_for_job(self, job_id: str, timeout_s: float = 300.0,
                           poll_s: float = SYNC_POLL_INTERVAL_S
                           ) -> Optional[Dict[str, Any]]:
        deadline = time.monotonic() + timeout_s
        terminal = {
            JobStatus.COMPLETED.value,
            JobStatus.FAILED.value,
            JobStatus.CANCELLED.value,
        }
        while time.monotonic() < deadline:
            job = await self._store.get_job(job_id)
            if job is None:
                return None
            if job["status"] in terminal:
                return job
            await asyncio.sleep(poll_s)
        return await self._store.get_job(job_id)


class TaskGuaranteeBackgroundWorker:
    """Runs the sweeps every ``interval_s`` (reference :231-263)."""

    def __init__(self, service: TaskGuaranteeService,
                 interval_s: float = SWEEP_INTERVAL_S) -> None:
        self._service = service
        self._interval = interval_s
        self._task: Optional[asyncio.Task] = None
        self._stop = asyncio.Event()

    async def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                await self._service.sweep()
            except Exception:  # noqa: BLE001 — sweep must never kill the loop
                pass
            try:
                await asyncio.wait_for(self._stop.wait(), timeout=self._interval)
            except asyncio.TimeoutError:
                continue

    def start(self) -> None:
        if self._task is None:
            self._stop.clear()
            self._task = asyncio.get_running_loop().create_task(self._loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._stop.set()
            await self._task
            self._task = None
