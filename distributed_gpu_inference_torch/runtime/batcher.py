"""Continuous batching scheduler driving the slot-based engine.

The port's own copy of ``distributed_gpu_inference_tpu/runtime/batcher.py``
(``BatcherConfig``, ``split_prefill_budget``, ``ContinuousBatcher`` and
``BatcherServing``) over :class:`~distributed_gpu_inference_torch.runtime.engine.TorchEngine`:

- requests are admitted into fixed engine **slots** and every round runs
  one forward over all slots (a request joins/leaves the batch between
  rounds, nothing waits for stragglers);
- with admissions in flight a round is one ``engine.ragged_round`` (decode
  rows + prefill-chunk rows), otherwise ``engine.decode_multi`` over a
  quantized horizon the batcher tunes against a step-latency target;
- prefix grouping orders *admission* so sequences sharing cached prefix
  blocks land while those pages are hot;
- a traced request (``flight``, a ``runtime/flight.py`` Timeline) is noted
  at every boundary the JAX batcher notes: enqueued, admitted, chunk
  rounds, first token, preempted, resumed, completed;
- with ``abandon_deadlines`` on, work whose deadline passed (or, with
  ``predictive_abandon``, will pass) and whose projected remaining decode
  cannot land within ``deadline_grace_s`` is dropped at the step boundary
  with the typed ``deadline_abandoned`` response;
- with a standalone ``SpeculativeDecoder`` attached (``spec=``), a
  low-depth all-greedy queue routes through its spec waves, one bounded
  dispatch per loop iteration interleaved with the paged rounds; an engine
  that speculates itself (``EngineConfig.speculative``) needs nothing here
  — its rounds are verify rounds.

- the prefill/decode hand-off hooks: ``adopt_slot`` drives a slot that
  arrived through a KV handoff in the shared rounds (preemptible and
  resumable like a submitted one), and ``BatcherServing.run_exclusive``
  runs out-of-band engine work (PD prefill and export, adoption) between
  rounds.

Engine calls execute on a single dedicated thread (the engine is not
thread-safe); the asyncio side only schedules and resolves futures.
"""

from __future__ import annotations

import asyncio
import functools
import heapq
import itertools
import logging
import threading
import time
from concurrent.futures import Future as _Future
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from distributed_gpu_inference_torch.runtime.engine import (
    ChunkedAdmission,
    PreemptedSequence,
    TorchEngine,
)
from distributed_gpu_inference_torch.runtime.kv_cache import OutOfBlocksError
from distributed_gpu_inference_torch.utils.data_structures import (
    KV_BLOCK_TOKENS,
    InferenceRequest,
    InferenceResponse,
    compute_prefix_hash,
)

log = logging.getLogger(__name__)


class RequestMigrated(Exception):
    """A submitted request was frozen at a step boundary by its *interrupt*
    event (graceful drain): the generation did not fail — it carries a
    portable :class:`PreemptedSequence` the caller hands to the control
    plane so another worker resumes it. The serving layer translates this
    into the worker-level ``JobMigrated``."""

    def __init__(self, pre: PreemptedSequence) -> None:
        super().__init__(
            f"request migrated with {len(pre.generated)} generated tokens"
        )
        self.pre = pre


def synthesize_checkpoint(request: InferenceRequest) -> PreemptedSequence:
    """A zero-token checkpoint for a request the engine never admitted
    (interrupted while still queued, or the admission-time stream record).
    The slot key mirrors ``TorchEngine._bind_slot``'s derivation for seeded
    requests so a resume elsewhere stays seed-stable; unseeded sampling was
    never deterministic, so the (0, 0) fallback loses nothing."""
    seed = request.sampling.seed
    key = (
        ((int(seed) >> 32) & 0xFFFFFFFF, int(seed) & 0xFFFFFFFF)
        if seed is not None else (0, 0)
    )
    return PreemptedSequence(
        request=request,
        prompt_len=len(request.prompt_token_ids or []),
        generated=[],
        slot_key=key,
        start_time=request.arrival_time,
        first_token_time=None,
        cached_tokens=0,
    )


@dataclass
class BatcherConfig:
    max_wait_ms: float = 5.0          # admission latch
    multi_step: int = 8               # initial decode horizon
    min_multi_step: int = 1
    max_multi_step: int = 64
    adaptive: bool = True
    target_step_latency_ms: float = 100.0  # per host round-trip
    queue_limit: int = 1024
    default_timeout_s: float = 300.0
    # KV-pressure preemption policy: a request preempted more than this
    # many times errors with a distinct ``preempted_too_often`` reason
    # instead of thrashing the pool forever (pool genuinely too small for
    # the working set). Victims are picked (lowest priority first, then
    # most-recently-admitted — LIFO) and requeued at the FRONT of the heap
    # with their full generated context, so resume restores spilled/cached
    # pages instead of recomputing.
    max_preemptions: int = 3
    # horizon when admission work is waiting: bounded so a queued request
    # never waits more than this many decode steps for a slot, while still
    # amortizing host round-trips (decode_step per token would pay one RTT
    # per token)
    busy_multi_step: int = 4
    # standalone speculation: with a SpeculativeDecoder attached and the
    # ENTIRE waiting load at most this many greedy requests, they decode
    # through the spec tree (the low-depth regime where drafting pays);
    # deeper load decodes paged. 0 = never
    spec_max_batch: int = 2
    # a spec wave may START while up to this many paged slots are still
    # active (spec dispatches and paged rounds interleave); 0 = only on an
    # idle engine
    spec_max_active: int = 2
    # RAGGED rounds (the default): admission appends prefill-chunk
    # rows to the next engine round instead of scheduling competing prefill
    # dispatches — the round loop collapses to build-ragged-batch →
    # dispatch → commit, and the subwave/interleave admission-stall knobs
    # are obsolete. None = auto (ragged whenever the engine supports it:
    # every paged engine). False forces the legacy wave/chunk-interleaved
    # admission — kept for A/B comparison, not production.
    ragged: Optional[bool] = None
    # per-ROUND prefill token budget for ragged rounds (long-context
    # serving): the total prefill-chunk tokens all in-flight admissions may
    # land in one ragged round, split fairly across them (water-fill, with
    # a rotating start so sub-token shares starve nobody). Bounds the
    # matmul work a giant admission adds to each co-dispatched decode
    # round, so decode ITL for short requests stays flat while a 32k
    # prompt streams in over many rounds. 0 = unbudgeted (every admission gets a
    # full ``ragged_chunk`` slice per round — byte-identical outputs either way; the budget only shapes
    # WHEN prefill work lands). Live-pushable (serving.prefill_budget).
    prefill_budget: int = 0
    # hopeless-work abandonment: when ON, the serving loop drops work whose
    # deadline has ALREADY passed and whose projected remaining decode
    # (tokens_left × observed step latency) still cannot land within
    # ``deadline_grace_s`` — resolving the future with a typed
    # ``deadline_abandoned`` error and freeing its blocks at the next step
    # boundary. NEVER fires for deadline-less requests (deadline_s=None);
    # OFF (the default) leaves every request as it was.
    abandon_deadlines: bool = False
    deadline_grace_s: float = 0.5
    # predictive abandonment (requires abandon_deadlines): the projection
    # fires BEFORE the deadline passes — work whose remaining decode
    # already overruns deadline + grace stops using round slots now.
    # Counted apart (stats["abandoned_predictive"]).
    predictive_abandon: bool = False

    @property
    def horizon_levels(self) -> Tuple[int, ...]:
        """The ONLY decode horizons the batcher may request: powers of
        four between the min/max (a bounded set of distinct round shapes,
        kept identical to the JAX package's batcher)."""
        levels = [t for t in (1, 4, 16, 64)
                  if self.min_multi_step <= t <= self.max_multi_step]
        return tuple(levels) or (self.min_multi_step,)


def split_prefill_budget(needs: List[int], budget: int,
                         start: int = 0) -> List[int]:
    """Fair water-fill of a per-round prefill token ``budget`` across
    concurrent admissions. ``needs[i]`` is admission i's remaining demand
    this round (min of its unprefilled tokens and the chunk cap); returns
    per-admission grants summing to <= budget.

    Water-fill: every still-hungry admission repeatedly receives an equal
    share of what is left, so small admissions finish inside their share
    and release the remainder to large ones — a 32k prompt co-admitted
    with a 40-token prompt cannot crowd it out, and N giant prompts split
    the budget evenly instead of first-come-takes-all. When the budget is
    smaller than the admission count the integer share floors to zero;
    the minimum 1-token share plus the rotating ``start`` offset hands
    the scarce tokens to a DIFFERENT admission subset each round
    (starvation-free round-robin). Deterministic: same inputs, same
    grants."""
    n = len(needs)
    grants = [0] * n
    if n == 0 or budget <= 0:
        return grants
    remaining = budget
    order = [(start + k) % n for k in range(n)]
    while remaining > 0:
        hungry = [i for i in order if grants[i] < needs[i]]
        if not hungry:
            break
        share = max(1, remaining // len(hungry))
        for i in hungry:
            if remaining <= 0:
                break
            give = min(share, needs[i] - grants[i], remaining)
            grants[i] += give
            remaining -= give
    return grants


@dataclass(order=True)
class _QueueItem:
    # (-priority, deadline_at, arrival_time, seq): EDF *within* a priority
    # band — deadline_at is +inf for deadline-less requests, so
    # with no deadlines set every comparison falls through to the
    # arrival/seq components and admission order is byte-identical to the
    # pre-deadline batcher
    sort_key: Tuple[int, float, float, int]
    request: InferenceRequest = field(compare=False)
    future: "asyncio.Future[InferenceResponse]" = field(compare=False)
    enqueued_at: float = field(compare=False, default_factory=time.time)
    # KV-pressure state: a preempted request waits in the heap carrying its
    # frozen sequence; _admit resumes it instead of submitting fresh
    preempted: Optional[PreemptedSequence] = field(compare=False, default=None)
    preempt_count: int = field(compare=False, default=0)
    # consecutive resume failures seen while the engine held NOTHING else:
    # an idle pool that cannot re-admit the sequence never will
    idle_resume_oob: int = field(compare=False, default=0)
    # serving hooks (all optional): ``observer(tokens)`` is called on the
    # event-loop thread after every decode round the sequence survived with
    # the monotonic generated-token list (SSE streaming reads deltas off
    # it); ``cancel`` aborts at the next step boundary (client gone);
    # ``interrupt`` freezes into a checkpoint and fails the future with
    # :class:`RequestMigrated` (graceful drain)
    observer: Optional[Callable[[List[int]], None]] = \
        field(compare=False, default=None)
    cancel: Optional[Any] = field(compare=False, default=None)
    interrupt: Optional[Any] = field(compare=False, default=None)
    # flight recorder: the request's Timeline when it carries a trace_id
    # (noted at its step boundaries); None for untraced requests, which
    # cost one None check per boundary
    flight: Optional[Any] = field(compare=False, default=None)


class ContinuousBatcher:
    """Admission queue + decode loop over a :class:`TorchEngine`."""

    def __init__(self, engine: TorchEngine,
                 cfg: Optional[BatcherConfig] = None,
                 spec: Optional[Any] = None) -> None:
        """``spec``: a ``runtime.speculative.SpeculativeDecoder`` sharing the
        engine's target weights (its own KV pool); low-depth all-greedy
        load routes through its incremental wave API."""
        self.engine = engine
        self.cfg = cfg or BatcherConfig()
        self.spec = spec
        if spec is not None and \
                getattr(engine.cfg, "speculative", None) is not None:
            raise ValueError(
                "engine already speculates in-engine "
                "(EngineConfig.speculative); attaching a standalone "
                "SpeculativeDecoder would draft twice — pick one"
            )
        self._check_ragged_supported(self.cfg.ragged)
        # (wave, items) while a speculative wave is in flight
        self._spec_wave: Optional[Tuple[Any, List["_QueueItem"]]] = None
        # True while start_wave runs on the executor: the requests are off
        # the heap but the wave isn't registered yet — drain must wait
        self._spec_starting = False
        self._heap: List[_QueueItem] = []
        self._seq = itertools.count()
        self._wake = asyncio.Event()
        self._stopping = False
        self._run_task: Optional[asyncio.Task] = None
        self._exec = ThreadPoolExecutor(max_workers=1, thread_name_prefix="engine")
        self._levels: Tuple[int, ...] = ()
        self._level = 0
        self._horizon = 0.0
        self._rebuild_levels(float(self.cfg.multi_step))
        self._slot_items: Dict[int, _QueueItem] = {}
        # admission stamps for LIFO victim selection (slot indices recycle,
        # so recency must be tracked per admission, not per slot number)
        self._admit_stamp: Dict[int, int] = {}
        self._stamp = itertools.count()
        # after a preemption, resumes pause until one round runs
        # unpressured: the FROZEN slots must reserve the freed blocks
        # first, or the resume takes them straight back and the pressure
        # recurs every round until the victim dies preempted_too_often
        self._resume_hold = False
        # legacy path only: at most one chunk-interleaved long-prompt
        # admission in flight; its prefill advances one chunk per loop
        # iteration, between decode rounds
        self._chunked: Optional[Tuple[ChunkedAdmission, _QueueItem]] = None
        # ragged mode (the default): EVERY admission — short or long — is a
        # bound-but-unprefilled engine slot whose chunk rows ride the next
        # ragged round(s) co-dispatched with the active decodes. Several
        # may be in flight at once; an admission leaves this list for
        # _slot_items when its final chunk samples the first token.
        self._ragged: List[Tuple[ChunkedAdmission, _QueueItem]] = []
        # rotating start offset for the per-round prefill-budget split:
        # when the budget floors below one token per admission, a
        # different admission subset receives the scarce tokens each
        # round (split_prefill_budget's starvation-freedom)
        self._prefill_rr = 0
        self.stats: Dict[str, Any] = {
            "submitted": 0, "completed": 0, "rejected": 0, "timeouts": 0,
            "decode_rounds": 0, "admitted": 0, "queue_peak": 0,
            "step_latency_ema_ms": 0.0, "occupancy_sum": 0, "horizon": self._horizon,
            "chunked_admissions": 0, "batched_waves": 0,
            "ragged_admissions": 0, "ragged_rounds": 0,
            "budgeted_rounds": 0, "budget_skipped_admissions": 0,
            "spec_waves": 0, "spec_completed": 0, "spec_errors": 0,
            "preemptions": 0, "resumes": 0, "preemption_block_pressure": 0,
            "preempted_too_often": 0,
            "cancelled": 0, "migrated": 0,
            "abandoned": 0, "abandoned_predictive": 0,
            "adopted": 0,
        }

    @property
    def use_ragged(self) -> bool:
        """Ragged rounds are the DEFAULT serving path: admission appends
        rows to the next round instead of dispatching competing prefills.
        ``cfg.ragged=False`` forces the legacy path (A/B benches);
        ``cfg.ragged=True`` REQUIRES it (init/reconfigure reject engines
        that cannot serve it — a silent legacy fallback would make every
        A/B ratio downstream a lie); ``None`` = auto: engines without
        ragged support fall back automatically."""
        if self.cfg.ragged is False:
            return False
        return bool(getattr(self.engine, "supports_ragged", False))

    def _check_ragged_supported(self, requested: Any) -> None:
        """``ragged=True`` is REQUIRE, not prefer — reject it loudly on an
        engine that keeps the split admission paths."""
        if requested is True and \
                not getattr(self.engine, "supports_ragged", False):
            raise ValueError(
                "serving.ragged=true requires an engine with ragged-round "
                "support; use ragged=null (auto) to fall back silently"
            )

    def _rebuild_levels(self, anchor: float) -> None:
        """THE quantized-horizon level-set derivation (init + live
        reconfigure): adaptive mode exposes the power-of-4 levels, fixed
        mode honors the clamped ``multi_step`` verbatim; the current level
        snaps to the one nearest ``anchor`` so a retune never requests an
        uncompiled scan length mid-flight."""
        if self.cfg.adaptive:
            levels = self.cfg.horizon_levels
        else:
            # a fixed horizon compiles exactly one graph — honor it verbatim
            levels = (max(self.cfg.min_multi_step,
                          min(self.cfg.multi_step,
                              self.cfg.max_multi_step)),)
        self._levels = levels
        self._level = min(
            range(len(levels)), key=lambda i: abs(levels[i] - anchor)
        )
        self._horizon = float(levels[self._level])
        if hasattr(self, "stats"):
            self.stats["horizon"] = self._horizon

    # ---------------------------------------------------- speculative routing

    def _spec_eligible(self, item: "_QueueItem") -> bool:
        """A request may decode through the spec tree iff it is greedy
        (verify is an argmax match), its prompt fits one spec prefill
        bucket (and the paged engine's largest, the long-prompt boundary),
        the generation plus the worst verify tree fits the spec context,
        it carries no round-granular hook (observer, cancel, interrupt) and
        it did not opt out (``request.params['speculative'] = False``)."""
        r = item.request
        ids = r.prompt_token_ids or []
        if not ids or r.sampling.temperature > 0.0:
            return False
        if r.params.get("speculative") is False:
            return False
        if item.observer is not None or item.cancel is not None \
                or item.interrupt is not None:
            return False
        s = self.spec
        max_bucket = s.prefill_buckets[-1]
        eng_buckets = getattr(self.engine.cfg, "prefill_buckets", None)
        if eng_buckets:
            max_bucket = min(max_bucket, eng_buckets[-1])
        if len(ids) > max_bucket:
            return False
        # headroom for the WORST verify tree: the fits-freeze ends a row at
        # prefix + nodes + 1 > ctx, which would return fewer tokens than
        # the paged engine serves for the same request
        margin = s.worst_case_tree_nodes() + 1
        return len(ids) + r.sampling.max_new_tokens + margin <= s.max_seq_len

    async def _maybe_start_spec_wave(self) -> bool:
        """Route the ENTIRE waiting queue through the spec decoder when it
        is a low-depth all-greedy moment: queue depth <= spec_max_batch,
        every request eligible, at most spec_max_active paged slots still
        decoding, no wave in flight."""
        spec_cap = (
            min(self.cfg.spec_max_batch, self.spec.max_batch_size)
            if self.spec is not None else 0
        )
        if (
            self.spec is None
            or spec_cap <= 0
            or self._spec_wave is not None
            or self._chunked is not None
            or self._ragged
            or not self._heap
            or len(self._heap) > spec_cap
            or self.engine.num_active > self.cfg.spec_max_active
        ):
            return False
        items = [it for it in list(self._heap) if not it.future.cancelled()]
        if not items or not all(self._spec_eligible(it) for it in items):
            return False
        if any(it.preempted is not None for it in items):
            # a preempted sequence must RESUME its generated context; a
            # spec wave would regenerate it from token 0
            return False
        loop = asyncio.get_running_loop()
        self._heap.clear()
        self._spec_starting = True
        try:
            wave = await loop.run_in_executor(
                self._exec, self.spec.start_wave, [it.request for it in items],
            )
        except Exception:
            # fall back to the paged engine (a transient spec failure must
            # not error a servable request); marked so a persistent spec
            # fault cannot retry-loop
            for it in items:
                it.request.params["speculative"] = False
                heapq.heappush(self._heap, it)
            return False
        finally:
            self._spec_starting = False
        self._spec_wave = (wave, items)
        self.stats["spec_waves"] += 1
        self.stats["admitted"] += len(items)
        return True

    async def _step_spec_wave(self) -> None:
        """Advance the in-flight spec wave by ONE bounded dispatch; finish
        it and resolve futures when every row is done (or every caller
        gave up)."""
        if self._spec_wave is None:
            return
        wave, items = self._spec_wave
        loop = asyncio.get_running_loop()
        if all(it.future.done() for it in items):
            self._spec_wave = None
            await loop.run_in_executor(self._exec, self.spec.abort_wave, wave)
            return
        try:
            done = await loop.run_in_executor(self._exec, self.spec.advance_wave, wave)
        except Exception as e:
            self._spec_wave = None
            await loop.run_in_executor(self._exec, self.spec.abort_wave, wave)
            for it in items:
                if not it.future.done():
                    it.future.set_result(InferenceResponse(
                        request_id=it.request.request_id,
                        error=f"speculative engine error: {e}",
                    ))
                    self.stats["completed"] += 1
                    self.stats["spec_errors"] += 1
            return
        if done:
            self._spec_wave = None
            resps = await loop.run_in_executor(self._exec, self.spec.finish_wave, wave)
            # completed counts responses actually delivered
            for it, resp in zip(items, resps):
                if not it.future.done():
                    it.future.set_result(resp)
                    self.stats["completed"] += 1
                    self.stats["spec_completed"] += 1

    # ---------------------------------------------------------------- API

    @staticmethod
    def _note(item: "_QueueItem", name: str, at: Optional[float] = None,
              **attrs: Any) -> None:
        """Flight-recorder boundary note for one request: a None check when
        untraced, a list append when traced. ``at`` records an
        engine-observed wall-clock instant (the slot's first-token time)
        instead of now."""
        f = item.flight
        if f is None:
            return
        if at is not None:
            f.note_at(name, at, **attrs)
        else:
            f.note(name, **attrs)

    async def submit(
        self, request: InferenceRequest, timeout_s: Optional[float] = None,
        *,
        observer: Optional[Callable[[List[int]], None]] = None,
        cancel: Optional[Any] = None,
        interrupt: Optional[Any] = None,
        resume_from: Optional[PreemptedSequence] = None,
        flight: Optional[Any] = None,
    ) -> InferenceResponse:
        """Enqueue and await completion (the future resolves with the response; queue-full and timeout surface as
        errors in the response).

        Serving hooks: ``observer`` receives the monotonic generated-token
        list after every decode round (SSE streaming); ``cancel`` (an
        Event) aborts at the next step boundary; ``interrupt`` (an Event)
        freezes the sequence into a checkpoint and raises
        :class:`RequestMigrated` here instead of resolving (graceful
        drain). ``resume_from`` re-admits a server-held checkpoint instead
        of prefilling from scratch — head-of-line, through the same
        cache/spill-restoring resume path KV-pressure preemptions use.
        ``flight`` (a Timeline) is noted at each step boundary."""
        if self._stopping:
            raise RuntimeError("batcher is stopping")
        if len(self._heap) >= self.cfg.queue_limit:
            self.stats["rejected"] += 1
            return InferenceResponse(
                request_id=request.request_id, error="queue full",
                # machine-readable: nothing ran — an overload shed, safe
                # to retry elsewhere (vs request_timeout, which may still
                # be generating here)
                error_code="shed_overload",
            )
        if resume_from is None and not self.engine.request_fits_pool(request):
            # the PROMPT alone cannot fit even an idle pool: no amount of
            # preemption could ever admit it — reject up front. (The check
            # is deliberately not worst-case on max_new_tokens; generation
            # that outgrows the pool is handled dynamically by preemption,
            # bounded by max_preemptions and the idle-resume abort.
            # Checkpoint resumes skip it: they were admitted once and the
            # preempted_too_often cap owns their capacity endgame.)
            self.stats["rejected"] += 1
            return InferenceResponse(
                request_id=request.request_id,
                error="request exceeds KV pool capacity (worst case "
                      "cannot fit even an idle pool)",
                error_code="over_capacity",
            )
        loop = asyncio.get_running_loop()
        fut: "asyncio.Future[InferenceResponse]" = loop.create_future()
        item = _QueueItem(
            sort_key=(-request.priority, request.deadline_at,
                      request.arrival_time, next(self._seq)),
            request=request,
            future=fut,
            observer=observer,
            cancel=cancel,
            interrupt=interrupt,
            preempted=resume_from,
            flight=flight,
        )
        self._note(item, "batcher.enqueued", queue_depth=len(self._heap))
        heapq.heappush(self._heap, item)
        self.stats["submitted"] += 1
        self.stats["queue_peak"] = max(self.stats["queue_peak"], len(self._heap))
        self._wake.set()
        timeout_s = timeout_s or self.cfg.default_timeout_s
        try:
            return await asyncio.wait_for(fut, timeout=timeout_s)
        except asyncio.TimeoutError:
            self.stats["timeouts"] += 1
            return InferenceResponse(
                request_id=request.request_id,
                error=f"timeout after {timeout_s}s",
                # distinct from shed_overload: the caller's wait budget
                # elapsed — the request was (or may still be) running
                error_code="request_timeout",
            )

    async def adopt_slot(self, slot: int,
                         request: Optional[InferenceRequest] = None,
                         flight: Optional[Any] = None) -> InferenceResponse:
        """Drive an ALREADY-ADMITTED engine slot (the PD decode stage: the
        sequence arrived through a KV handoff, not through submit) inside
        the shared rounds and await its completion. The slot joins the
        batch as a submitted request does: it can be preempted, resumed and
        counted. A sequence that already finished (it decoded in earlier
        rounds while awaiting its claim) resolves at once."""
        if self._stopping:
            # a stop() between the caller's active check and this coroutine
            # would leave the item with no run task to resolve it
            raise RuntimeError("batcher is stopping")
        s = self.engine.slots[slot]
        if s is None:
            raise ValueError(f"slot {slot} is empty")
        self.stats["adopted"] += 1
        loop = asyncio.get_running_loop()
        if s.finish_reason is not None:
            resp = await loop.run_in_executor(self._exec, self.engine.finish_slot, slot)
            if flight is not None:
                flight.note("batcher.adopted", slot=slot)
                flight.note("batcher.completed", finish_reason=resp.finish_reason,
                            tokens=resp.completion_tokens)
            return resp
        req = request or s.request
        fut: "asyncio.Future[InferenceResponse]" = loop.create_future()
        item = _QueueItem(
            sort_key=(-req.priority, req.deadline_at, req.arrival_time,
                      next(self._seq)),
            request=req,
            future=fut,
            flight=flight,
        )
        self._note(item, "batcher.adopted", slot=slot)
        self._slot_items[slot] = item
        self._admit_stamp[slot] = next(self._stamp)
        self._wake.set()
        return await fut

    def start(self) -> None:
        if self._run_task is None:
            self._stopping = False
            self._run_task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self, drain: bool = True) -> None:
        """Graceful shutdown: optionally finish queued + active work
        first. Without drain,
        every still-pending future resolves with an error response so no
        caller is left waiting out its timeout against a dead loop."""
        self._stopping = True
        self._wake.set()
        if drain:
            # drain batcher-OWNED work only: a foreign engine slot is not
            # ours to wait on
            while self._heap or self._slot_items or self._chunked is not None \
                    or self._ragged \
                    or self._spec_wave is not None or self._spec_starting:
                await asyncio.sleep(0.01)
        if self._run_task:
            self._run_task.cancel()
            try:
                await self._run_task
            except asyncio.CancelledError:
                pass
            self._run_task = None
        pending = list(self._slot_items.values()) + list(self._heap)
        self._slot_items.clear()
        self._heap.clear()
        loop = asyncio.get_running_loop()
        if self._chunked is not None:
            # a request mid chunk-interleaved prefill is in NEITHER
            # collection above — abort its engine state and resolve it,
            # or its submit() would wait on a dead loop forever
            adm, chunk_item = self._chunked
            self._chunked = None
            try:
                await loop.run_in_executor(
                    self._exec, self.engine.abort_chunked, adm
                )
            except Exception:  # noqa: BLE001 — shutdown is best-effort
                pass
            pending.append(chunk_item)
        for adm, rag_item in self._ragged:
            # mid-prefill ragged admissions are in NEITHER collection above
            # either — abort their engine state and resolve them too
            try:
                await loop.run_in_executor(
                    self._exec, self.engine.abort_chunked, adm
                )
            except Exception:  # noqa: BLE001 — shutdown is best-effort
                pass
            pending.append(rag_item)
        self._ragged = []
        if self._spec_wave is not None:
            wave, items = self._spec_wave
            self._spec_wave = None
            try:
                await loop.run_in_executor(self._exec, self.spec.abort_wave, wave)
            except Exception:  # noqa: BLE001 — shutdown is best-effort
                pass
            pending.extend(items)
        for item in pending:
            if item.future.done():
                continue
            item.future.set_result(InferenceResponse(
                request_id=item.request.request_id,
                error="batcher stopped",
            ))
            self.stats["completed"] += 1
        self._exec.shutdown(wait=False)

    def reconfigure(self, **updates: Any) -> None:
        """Apply server-pushed SLO knobs to a LIVE batcher between rounds:
        any :class:`BatcherConfig` field by name (None values are ignored).
        Horizon-shaping fields (``max_multi_step``, ``min_multi_step``,
        ``multi_step``, ``adaptive``) rebuild the quantized level set; the
        current level snaps to the nearest surviving horizon so retuning
        never requests an uncompiled scan length mid-flight.

        ``ragged_chunk`` is the one ENGINE knob accepted here:
        the per-admission chunk-row width of ragged rounds. It is read
        per round, chunk widths bucket through ``prefill_buckets``, so retuning it
        live only selects among the bucketed widths. Together with ``prefill_budget``
        it makes the long-context prefill geometry live-pushable."""
        ragged_chunk = updates.pop("ragged_chunk", None)
        if ragged_chunk is not None:
            rc = int(ragged_chunk)
            if rc < 1:
                raise ValueError(
                    f"ragged_chunk must be >= 1, got {ragged_chunk}"
                )
        coerced: Dict[str, Any] = {}
        for key, val in updates.items():
            if val is None or not hasattr(self.cfg, key):
                continue
            cur = getattr(self.cfg, key)
            if (isinstance(cur, bool) or key == "ragged") \
                    and isinstance(val, str):
                # remote pushes arrive through an untyped dict and env/YAML
                # tooling stringifies scalars — bool("false") is True, so
                # coerce by content, not constructor ("ragged" is tri-state
                # Optional[bool], so its current value may be None)
                val = val.strip().lower() in ("1", "true", "yes", "on")
            if key == "ragged":
                self._check_ragged_supported(bool(val))
                coerced[key] = bool(val)
                continue
            coerced[key] = type(cur)(val) if cur is not None else val
        # all-or-nothing: coercion above raised before any cfg mutation,
        # so one bad value can't leave a half-applied retune
        for key, val in coerced.items():
            setattr(self.cfg, key, val)
        if ragged_chunk is not None and \
                hasattr(self.engine.cfg, "ragged_chunk"):
            self.engine.cfg.ragged_chunk = rc
        self._rebuild_levels(self._horizon)

    # ------------------------------------------------------------- internals

    def _admission_order(self) -> List[_QueueItem]:
        """Prefix-grouped admission: group queued
        requests by their first-block prefix hash; largest group first, then
        priority/FIFO inside the group. Preempted sequences ALWAYS lead:
        their pages are still warm in the prefix cache / spill tiers, and
        head-of-line resume is what bounds a preempted request's extra
        latency to one pressure episode."""
        resumes = sorted(
            (it for it in self._heap if it.preempted is not None),
            key=lambda it: it.sort_key,
        )
        groups: Dict[str, List[_QueueItem]] = {}
        for item in self._heap:
            if item.preempted is not None:
                continue
            ids = item.request.prompt_token_ids or []
            key = (
                compute_prefix_hash(ids, KV_BLOCK_TOKENS)
                if len(ids) >= KV_BLOCK_TOKENS
                else f"solo-{id(item)}"
            )
            groups.setdefault(key, []).append(item)
        ordered: List[_QueueItem] = []
        # largest group first; equal-size groups ordered by their best member
        # (priority, then FIFO) so priority still wins between singletons
        for _, members in sorted(
            groups.items(),
            key=lambda kv: (-len(kv[1]), min(it.sort_key for it in kv[1])),
        ):
            ordered.extend(sorted(members, key=lambda it: it.sort_key))
        return resumes + ordered

    async def _admit(self) -> int:
        """Admit queued requests into free slots. Heap mutation and future
        resolution happen HERE on the event-loop thread (asyncio futures and
        the heap are not thread-safe); only the engine call itself runs on the
        engine executor thread.

        Ragged mode (the default): every fresh admission binds its slot NOW
        (``engine.submit_chunked_start``) and its prompt rides the next
        ragged round(s) as chunk rows co-dispatched with the active decodes
        — admission IS "append rows to the next round"; several may be in
        flight at once. Legacy mode (``cfg.ragged=False`` or an engine
        without ragged support): short prompts are collected into a WAVE
        and admitted through ``engine.submit_batch`` — one batched prefill
        device call per bucket instead of one per request — while prompts longer than the largest prefill
        bucket start a chunk-interleaved admission instead (one at a time);
        their chunks run between decode rounds in ``_run``."""
        admitted = 0
        if self._resume_hold:
            # the round after a preemption belongs to the FROZEN slots:
            # neither resumes nor fresh admissions may take the freed
            # blocks before they re-reserve, or the pressure recurs every
            # round (thrash) no matter who stole them
            return 0
        free = self.engine.free_slots()
        if not free or not self._heap:
            return 0
        loop = asyncio.get_running_loop()
        max_bucket = self.engine.cfg.prefill_buckets[-1]
        wave: List[_QueueItem] = []
        requeue: List[_QueueItem] = []

        def _defer(item: "_QueueItem") -> bool:
            """Requeue an item the pool could not hold RIGHT NOW — unless
            its worst case statically can never fit the pool, in which
            case it errors out (the one capacity error that legitimately
            reaches a client). A PREEMPTED sequence is never statically
            rejected: it was admitted once and carries generated tokens —
            requeue it and let the preempted_too_often cap (which returns
            the partial output) decide if the pool can't sustain it.
            Returns True when the item was deferred."""
            if item.preempted is None and \
                    not self.engine.request_fits_pool(item.request):
                if not item.future.done():
                    item.future.set_result(InferenceResponse(
                        request_id=item.request.request_id,
                        error="request exceeds KV pool capacity (worst "
                              "case cannot fit even an idle pool)",
                    ))
                    # same counter as the submit()-time static rejection:
                    # one condition, one metric, wherever it is detected
                    self.stats["rejected"] += 1
                return False
            requeue.append(item)
            return True

        for item in self._admission_order():
            if not free:
                break
            # remove from the queue before any await so a concurrent submit()
            # (which only pushes) can never interleave with a removal
            try:
                self._heap.remove(item)
            except ValueError:
                continue  # already handled
            if item.future.cancelled():
                continue
            if item.preempted is not None:
                # resume a preempted sequence: head-of-line, restores
                # cached/spilled pages through the normal allocate+prefill
                # path (in ragged mode as a ragged admission, whose
                # recompute rides the next rounds as a prompt does). Pool
                # still too tight → stop admitting ANYTHING this pass (new
                # work must not steal the blocks the resume needs) and
                # retry next loop.
                ragged = self.use_ragged
                try:
                    got = await loop.run_in_executor(
                        self._exec,
                        self.engine.resume_chunked_start if ragged
                        else self.engine.resume,
                        item.preempted,
                    )
                except OutOfBlocksError:
                    if self.engine.num_active == 0 and \
                            self._chunked is None:
                        # an IDLE pool that STATICALLY cannot hold the
                        # sequence never will (nothing left to free):
                        # after a few consecutive tries, deliver the
                        # partial output instead of spinning until the
                        # client's timeout. A statically-fitting resume
                        # keeps retrying — an idle-pool allocation failure
                        # is then transient by construction (cache
                        # eviction in flight, injected chaos pressure),
                        # and aborting would turn a 2-second storm into a
                        # permanently failed request (fleet chaos suite).
                        item.idle_resume_oob += 1
                        if item.idle_resume_oob > 2 and not \
                                self.engine.resume_fits_pool(
                                    item.preempted):
                            pre = item.preempted
                            if not item.future.done():
                                item.future.set_result(InferenceResponse(
                                    request_id=item.request.request_id,
                                    token_ids=list(pre.generated),
                                    finish_reason="abort",
                                    prompt_tokens=pre.prompt_len,
                                    completion_tokens=len(pre.generated),
                                    error="request exceeds KV pool "
                                          "capacity: generated context "
                                          f"({len(pre.generated)} tokens) "
                                          "can no longer be resumed",
                                ))
                                self.stats["completed"] += 1
                            continue
                    else:
                        item.idle_resume_oob = 0
                    if _defer(item):
                        break
                    continue
                except Exception as e:
                    if not item.future.done():
                        item.future.set_result(InferenceResponse(
                            request_id=item.request.request_id,
                            error=f"resume failed: {e}",
                        ))
                        self.stats["completed"] += 1
                    continue
                item.idle_resume_oob = 0
                self.stats["resumes"] += 1
                slot = got.slot if ragged else got
                self._note(item, "batcher.resumed", slot=slot)
                if slot in free:
                    free.remove(slot)
                if ragged:
                    # ``preempted`` stays set until the first token lands:
                    # a cancel or drain mid-prefill still hands back the
                    # checkpoint's tokens
                    self._ragged.append((got, item))
                    self.stats["ragged_admissions"] += 1
                    continue
                item.preempted = None
                self._slot_items[slot] = item
                self._admit_stamp[slot] = next(self._stamp)
                admitted += 1
                continue
            if self.use_ragged:
                # ragged admission (the default): bind the slot NOW, run no
                # prefill — the prompt's chunk rows ride the next ragged
                # round(s) co-dispatched with the active decodes, so there
                # is no competing prefill dispatch and no short/long split
                try:
                    adm = await loop.run_in_executor(
                        self._exec, self.engine.submit_chunked_start,
                        item.request,
                    )
                except OutOfBlocksError:
                    _defer(item)
                    continue
                except Exception as e:
                    if not item.future.done():
                        item.future.set_result(
                            InferenceResponse(
                                request_id=item.request.request_id,
                                error=str(e),
                                # typed admission failures (e.g. the
                                # engine's over_length rejection) stay
                                # machine-readable through the batcher
                                error_code=getattr(e, "error_code", None),
                            )
                        )
                    continue
                free.pop(0)
                self._ragged.append((adm, item))
                self.stats["ragged_admissions"] += 1
                self._note(item, "batcher.admitted", slot=adm.slot,
                           mode="ragged",
                           tokens=len(item.request.prompt_token_ids or []))
                continue
            n_prompt = len(item.request.prompt_token_ids or [])
            if n_prompt > max_bucket:
                if self._chunked is not None:
                    # one interleaved admission at a time — requeue this one
                    # and keep admitting the rest (a second long prompt must
                    # not starve short requests behind it)
                    heapq.heappush(self._heap, item)
                    continue
                try:
                    adm = await loop.run_in_executor(
                        self._exec, self.engine.submit_chunked_start,
                        item.request,
                    )
                except OutOfBlocksError:
                    _defer(item)
                    continue
                except Exception as e:
                    if not item.future.done():
                        item.future.set_result(
                            InferenceResponse(
                                request_id=item.request.request_id,
                                error=str(e),
                                error_code=getattr(e, "error_code", None),
                            )
                        )
                    continue
                # consume the slot only on SUCCESS: a failed chunked start
                # rolled the engine back, and burning a free slot for it
                # would under-admit the rest of this pass (the slot leak)
                free.pop(0)
                self._chunked = (adm, item)
                self.stats["chunked_admissions"] += 1
                self._note(item, "batcher.admitted", slot=adm.slot,
                           mode="chunked", tokens=n_prompt)
                continue
            free.pop(0)
            wave.append(item)

        if wave:
            # admission instant of the whole wave: submit_batch prefills
            # AND samples the first token before returning, so "admitted"
            # noted after it would land after first_token
            t_admit = time.time()
            try:
                slots = await loop.run_in_executor(
                    self._exec,
                    functools.partial(
                        self.engine.submit_batch,
                        [it.request for it in wave], partial=True,
                    ),
                )
            except OutOfBlocksError:
                # pool can't hold the wave right now: requeue silently —
                # completions/preemptions free blocks and the requests
                # retry; clients never see the pressure
                for item in wave:
                    _defer(item)
                slots = None
            except Exception:
                # the wave is all-or-nothing (engine rolls back); isolate the
                # failing request(s) by falling back to per-request admission
                slots = None
                for item in wave:
                    t_admit = time.time()
                    try:
                        slot = await loop.run_in_executor(
                            self._exec, self.engine.submit, item.request
                        )
                    except OutOfBlocksError:
                        _defer(item)
                        continue
                    except Exception as e:
                        if not item.future.done():
                            item.future.set_result(
                                InferenceResponse(
                                    request_id=item.request.request_id,
                                    error=str(e),
                                    error_code=getattr(e, "error_code",
                                                       None),
                                )
                            )
                        continue
                    self._slot_items[slot] = item
                    self._admit_stamp[slot] = next(self._stamp)
                    self._note(item, "batcher.admitted", at=t_admit,
                               slot=slot, mode="wave",
                               tokens=len(item.request.prompt_token_ids
                                          or []))
                    self._note_first_token(item, slot)
                    admitted += 1
            if slots is not None:
                if slots:
                    self.stats["batched_waves"] += 1
                for item, slot in zip(wave, slots):
                    self._slot_items[slot] = item
                    self._admit_stamp[slot] = next(self._stamp)
                    self._note(item, "batcher.admitted", at=t_admit,
                               slot=slot, mode="wave",
                               tokens=len(item.request.prompt_token_ids
                                          or []))
                    self._note_first_token(item, slot)
                admitted += len(slots)
                # pressure deferred the wave's tail (possibly the whole
                # wave): requeue without error
                for item in wave[len(slots):]:
                    _defer(item)

        for item in requeue:
            heapq.heappush(self._heap, item)
        if self._heap:
            heapq.heapify(self._heap)
        self.stats["admitted"] += admitted
        return admitted

    def _note_first_token(self, item: "_QueueItem", slot: int) -> None:
        """Note the first-token boundary at the ENGINE's wall-clock stamp
        (the slot's ``first_token_time``, when the token was sampled), so
        ttft on the timeline matches the engine's own ttft_ms."""
        if item.flight is None:
            return
        s = self.engine.slots[slot]
        t = getattr(s, "first_token_time", None) if s is not None else None
        self._note(item, "batcher.first_token", at=t)

    async def _step_chunked(self) -> None:
        """Advance the in-flight chunk-interleaved admission by ONE chunk."""
        if self._chunked is None:
            return
        adm, item = self._chunked
        loop = asyncio.get_running_loop()
        if item.future.done():  # caller gave up (timeout/cancel): release
            await loop.run_in_executor(
                self._exec, self.engine.abort_chunked, adm
            )
            self._chunked = None
            return
        try:
            done = await loop.run_in_executor(
                self._exec, self.engine.submit_chunked_step, adm
            )
        except Exception as e:
            self._chunked = None
            if not item.future.done():
                item.future.set_result(
                    InferenceResponse(
                        request_id=item.request.request_id,
                        error=str(e),
                        error_code=getattr(e, "error_code", None),
                    )
                )
            return
        if done:
            self._slot_items[adm.slot] = item
            self._chunked = None
            self.stats["admitted"] += 1
            self._note_first_token(item, adm.slot)

    async def _check_pressure(self, after_round: bool = False) -> None:
        """Consume the engine's KV-pressure signal and apply the preemption
        policy. Decode-sourced pressure (active slots frozen, progress
        blocked) always preempts a victim; admission-sourced pressure
        preempts only when the waiting work outranks the victim — otherwise
        the deferred admissions simply wait for completions."""
        p = self.engine.take_pressure()
        if p is None:
            if after_round:
                # one full engine round ran unpressured: the frozen slots
                # got their reservations, resumes may flow again
                self._resume_hold = False
            return
        self.stats["preemption_block_pressure"] += 1
        if p.source == "decode":
            # skip if every frozen slot resolved meanwhile (finished this
            # very round and its blocks are already back)
            still_frozen = any(
                (s := self.engine.slots[sl]) is not None
                and s.finish_reason is None
                for sl in p.slots
            )
            if still_frozen:
                await self._preempt_victim(mandatory=True)
        else:
            await self._preempt_victim(mandatory=False)

    async def _preempt_victim(self, mandatory: bool) -> None:
        """Pick and preempt one victim: lowest priority first, then (round
        12, deadline-aware) the slot with the MOST deadline slack —
        deadline-less sequences before late-deadline ones before
        tight-deadline ones — ties broken most-recently-admitted (LIFO —
        the youngest sequence has the least compute invested and the
        warmest prefix to resume from; with no deadlines set the policy is
        byte-identical to the pre-deadline batcher). The frozen sequence
        requeues at the FRONT of the heap; past ``max_preemptions`` the
        request errors with ``preempted_too_often``."""
        cands = []
        for slot, item in self._slot_items.items():
            s = self.engine.slots[slot]
            if s is None or s.finish_reason is not None or s.prefilling:
                continue
            cands.append((item.request.priority,
                          -item.request.deadline_at,
                          -self._admit_stamp.get(slot, -1), slot, item))
        if not cands:
            return
        prio, _, _, slot, item = min(cands)
        if not mandatory:
            # admission pressure: only preempt for strictly higher-priority
            # waiting work — FIFO fairness is not worth a spill round-trip
            waiting = max(
                (it.request.priority for it in self._heap
                 if not it.future.done()),
                default=None,
            )
            if waiting is None or waiting <= prio:
                return
        loop = asyncio.get_running_loop()
        try:
            pre = await loop.run_in_executor(
                self._exec, self.engine.preempt_slot, slot
            )
        except Exception:
            return      # slot finished/changed under us: nothing to preempt
        self._slot_items.pop(slot, None)
        self.stats["preemptions"] += 1
        item.preempt_count += 1
        pre.preempt_count = item.preempt_count
        self._note(item, "batcher.preempted", slot=slot,
                   generated=len(pre.generated))
        if item.preempt_count > self.cfg.max_preemptions:
            self.stats["preempted_too_often"] += 1
            if not item.future.done():
                item.future.set_result(InferenceResponse(
                    request_id=item.request.request_id,
                    token_ids=list(pre.generated),
                    finish_reason="abort",
                    prompt_tokens=pre.prompt_len,
                    completion_tokens=len(pre.generated),
                    error=f"preempted_too_often: evicted "
                          f"{item.preempt_count} times under KV pressure",
                ))
                self.stats["completed"] += 1
            return
        item.preempted = pre
        # resort to the FRONT of the heap: resumes outrank every waiting
        # admission (their pages are warm; head-of-line bounds added
        # latency) — but pause resumes until one round runs unpressured,
        # so the frozen slots reserve the freed blocks first
        self._resume_hold = True
        item.sort_key = (
            -(1 << 20) - item.request.priority,
            item.request.deadline_at,
            item.request.arrival_time,
            next(self._seq),
        )
        heapq.heappush(self._heap, item)

    def _abort_slot(self, slot: int) -> Optional[InferenceResponse]:
        """Runs on the engine executor: mark a live slot aborted and finish
        it (partial tokens included). None when the slot vanished."""
        s = self.engine.slots[slot]
        if s is None:
            return None
        s.finish_reason = s.finish_reason or "abort"
        return self.engine.finish_slot(slot)

    async def _scan_signals(self) -> None:
        """Honor per-request cancel/interrupt events at the loop boundary —
        the only place slot state is quiescent. Cancels resolve with the
        partial output (finish_reason="abort"); interrupts freeze into a
        checkpoint and fail the future with :class:`RequestMigrated` so the
        serving layer migrates the job without burning a retry."""
        loop = asyncio.get_running_loop()
        changed = False
        for item in list(self._heap):
            if item.future.done():
                continue
            if item.cancel is not None and item.cancel.is_set():
                self._heap.remove(item)
                changed = True
                pre = item.preempted
                item.future.set_result(InferenceResponse(
                    request_id=item.request.request_id,
                    token_ids=list(pre.generated) if pre else [],
                    finish_reason="abort",
                    prompt_tokens=pre.prompt_len if pre
                    else len(item.request.prompt_token_ids or []),
                    completion_tokens=len(pre.generated) if pre else 0,
                ))
                self.stats["completed"] += 1
                self.stats["cancelled"] += 1
            elif item.interrupt is not None and item.interrupt.is_set():
                self._heap.remove(item)
                changed = True
                pre = item.preempted or synthesize_checkpoint(item.request)
                pre.preempt_count = item.preempt_count
                item.future.set_exception(RequestMigrated(pre))
                self.stats["migrated"] += 1
        if changed:
            heapq.heapify(self._heap)
        if self._chunked is not None:
            adm, item = self._chunked
            cancelled = item.cancel is not None and item.cancel.is_set()
            interrupted = item.interrupt is not None \
                and item.interrupt.is_set()
            if cancelled or interrupted:
                # a request mid chunk-interleaved prefill holds no
                # resumable engine state yet: abort the admission (frees
                # its slot + staged blocks) and either resolve with an
                # empty abort or migrate with a synthesized zero-token
                # checkpoint — burning the remaining prefill rounds on an
                # cancelled/draining request would stall everyone else
                self._chunked = None
                try:
                    await loop.run_in_executor(
                        self._exec, self.engine.abort_chunked, adm
                    )
                except Exception:  # noqa: BLE001 — abort is best-effort
                    pass
                if not item.future.done():
                    if cancelled:
                        item.future.set_result(InferenceResponse(
                            request_id=item.request.request_id,
                            finish_reason="abort",
                            prompt_tokens=len(
                                item.request.prompt_token_ids or []),
                        ))
                        self.stats["completed"] += 1
                        self.stats["cancelled"] += 1
                    else:
                        pre = synthesize_checkpoint(item.request)
                        pre.preempt_count = item.preempt_count
                        item.future.set_exception(RequestMigrated(pre))
                        self.stats["migrated"] += 1
        for adm, item in list(self._ragged):
            cancelled = item.cancel is not None and item.cancel.is_set()
            interrupted = item.interrupt is not None \
                and item.interrupt.is_set()
            if not (cancelled or interrupted or item.future.done()):
                continue
            # same contract as the legacy chunk-interleaved admission: a
            # request mid ragged prefill holds no resumable engine state
            # yet — abort (frees the slot + staged blocks) and resolve /
            # migrate with a synthesized zero-token checkpoint; a done
            # future (caller timeout) just releases the engine side
            self._ragged.remove((adm, item))
            try:
                await loop.run_in_executor(
                    self._exec, self.engine.abort_chunked, adm
                )
            except Exception:  # noqa: BLE001 — abort is best-effort
                pass
            if item.future.done():
                continue
            pre = item.preempted     # a resume mid-prefill keeps its tokens
            if cancelled:
                item.future.set_result(InferenceResponse(
                    request_id=item.request.request_id,
                    token_ids=list(pre.generated) if pre else [],
                    finish_reason="abort",
                    prompt_tokens=pre.prompt_len if pre
                    else len(item.request.prompt_token_ids or []),
                    completion_tokens=len(pre.generated) if pre else 0,
                ))
                self.stats["completed"] += 1
                self.stats["cancelled"] += 1
            else:
                pre = pre or synthesize_checkpoint(item.request)
                pre.preempt_count = item.preempt_count
                item.future.set_exception(RequestMigrated(pre))
                self.stats["migrated"] += 1
        for slot, item in list(self._slot_items.items()):
            s = self.engine.slots[slot]
            if s is None or s.finish_reason is not None:
                continue  # the round loop resolves finished slots
            if item.cancel is not None and item.cancel.is_set():
                try:
                    resp = await loop.run_in_executor(
                        self._exec, self._abort_slot, slot
                    )
                except Exception:
                    continue
                self._slot_items.pop(slot, None)
                if resp is not None and not item.future.done():
                    item.future.set_result(resp)
                    self.stats["completed"] += 1
                    self.stats["cancelled"] += 1
            elif item.interrupt is not None and item.interrupt.is_set() \
                    and not s.prefilling:
                try:
                    pre = await loop.run_in_executor(
                        self._exec, self.engine.preempt_slot, slot
                    )
                except Exception:
                    continue  # finished/changed under us — next pass
                self._slot_items.pop(slot, None)
                pre.preempt_count = item.preempt_count
                if not item.future.done():
                    item.future.set_exception(RequestMigrated(pre))
                    self.stats["migrated"] += 1

    def _deadline_hopeless(self, request: InferenceRequest,
                           tokens_left: int, now: float) -> bool:
        """True when ``request`` missed its deadline (or, predictive, will)
        AND its projected remaining decode (``tokens_left`` × observed step
        latency) cannot land even within the grace window. Guarded three
        ways: the flag, an explicit ``deadline_s is None`` check
        (deadline-less requests NEVER abandon) and ``tokens_left > 0`` (a
        sequence about to finish frees nothing by aborting)."""
        if not self.cfg.abandon_deadlines:
            return False
        if request.deadline_s is None:
            return False
        if tokens_left <= 0:
            return False
        deadline_at = request.deadline_at
        if now <= deadline_at and not self.cfg.predictive_abandon:
            # reactive mode waits for the deadline to pass; predictive mode
            # lets the projection below fire early
            return False
        # observed step latency, floored at 1 ms so a cold EMA still
        # projects some progress
        itl_s = max(float(self.stats["step_latency_ema_ms"]), 1.0) / 1000.0
        return now + tokens_left * itl_s > \
            deadline_at + self.cfg.deadline_grace_s

    def _count_abandon(self, request: InferenceRequest, now: float) -> None:
        """Every abandonment lands in ``abandoned``; one that fired before
        the deadline passed (predictive) also in ``abandoned_predictive``."""
        self.stats["completed"] += 1
        self.stats["abandoned"] += 1
        if now <= request.deadline_at:
            self.stats["abandoned_predictive"] += 1

    def _abandon_response(self, request: InferenceRequest,
                          token_ids: List[int],
                          prompt_tokens: int) -> InferenceResponse:
        return InferenceResponse(
            request_id=request.request_id,
            token_ids=list(token_ids),
            finish_reason="abort",
            prompt_tokens=prompt_tokens,
            completion_tokens=len(token_ids),
            error=f"deadline exceeded by {self.cfg.deadline_grace_s:.1f}s "
                  "grace and projected remaining decode cannot land",
            # machine-readable: the WORK was dropped (request_timeout means
            # only the caller's wait elapsed); a caller must not silently
            # retry it — its deadline has passed
            error_code="deadline_abandoned",
        )

    async def _scan_deadlines(self) -> None:
        """Abandon hopeless deadline-carrying work at the step boundary:
        queued items resolve at once; mid-prefill admissions abort their
        staged blocks; active slots free their KV through the abort path
        cancels use. No-op (not even a clock read) unless
        ``cfg.abandon_deadlines`` is on."""
        if not self.cfg.abandon_deadlines:
            return
        loop = asyncio.get_running_loop()
        now = time.time()
        changed = False
        for item in list(self._heap):
            if item.future.done():
                continue
            req = item.request
            pre = item.preempted
            tokens_left = max(0, int(req.sampling.max_new_tokens)
                              - (len(pre.generated) if pre else 0))
            if not self._deadline_hopeless(req, tokens_left, now):
                continue
            self._heap.remove(item)
            changed = True
            item.future.set_result(self._abandon_response(
                req, list(pre.generated) if pre else [],
                pre.prompt_len if pre
                else len(req.prompt_token_ids or []),
            ))
            self._count_abandon(req, now)
        if changed:
            heapq.heapify(self._heap)
        if self._chunked is not None:
            adm, item = self._chunked
            if not item.future.done() and self._deadline_hopeless(
                    item.request,
                    int(item.request.sampling.max_new_tokens), now):
                self._chunked = None
                try:
                    await loop.run_in_executor(
                        self._exec, self.engine.abort_chunked, adm
                    )
                except Exception:  # noqa: BLE001 — abort is best-effort
                    pass
                if not item.future.done():
                    item.future.set_result(self._abandon_response(
                        item.request, [],
                        len(item.request.prompt_token_ids or []),
                    ))
                    self._count_abandon(item.request, now)
        for adm, item in list(self._ragged):
            # a resume mid-prefill (ragged here) keeps its tokens
            pre = item.preempted
            done_tokens = list(pre.generated) if pre else []
            if item.future.done() or not self._deadline_hopeless(
                    item.request,
                    int(item.request.sampling.max_new_tokens)
                    - len(done_tokens), now):
                continue
            self._ragged.remove((adm, item))
            try:
                await loop.run_in_executor(
                    self._exec, self.engine.abort_chunked, adm
                )
            except Exception:  # noqa: BLE001 — abort is best-effort
                pass
            if not item.future.done():
                item.future.set_result(self._abandon_response(
                    item.request, done_tokens,
                    pre.prompt_len if pre
                    else len(item.request.prompt_token_ids or []),
                ))
                self._count_abandon(item.request, now)
        for slot, item in list(self._slot_items.items()):
            s = self.engine.slots[slot]
            if s is None or s.finish_reason is not None:
                continue  # the round loop resolves finished slots
            req = item.request
            tokens_left = max(
                0, int(req.sampling.max_new_tokens) - len(s.generated))
            if not self._deadline_hopeless(req, tokens_left, now):
                continue
            try:
                resp = await loop.run_in_executor(
                    self._exec, self._abort_slot, slot
                )
            except Exception:  # noqa: BLE001 — finished/changed: next pass
                continue
            self._slot_items.pop(slot, None)
            if resp is not None and not item.future.done():
                item.future.set_result(self._abandon_response(
                    req, list(resp.token_ids), resp.prompt_tokens))
                self._count_abandon(req, now)

    def _notify_observers(self) -> None:
        """Push per-round progress to streaming observers (loop thread;
        observers must only enqueue). Finished slots are excluded — their
        full token list rides the resolving response."""
        for slot, item in list(self._slot_items.items()):
            if item.observer is None:
                continue
            s = self.engine.slots[slot]
            if s is None or s.finish_reason is not None:
                continue
            try:
                item.observer(list(s.generated))
            except Exception:  # noqa: BLE001 — an observer must never wedge serving
                pass

    def _prefill_chunk_caps(
        self, adms: List[ChunkedAdmission],
    ) -> Optional[Dict[int, int]]:
        """Per-round prefill-budget split: the per-admission token
        caps the next ragged round may land, keyed by slot. None when the
        budget is off (``prefill_budget <= 0``) — the engine then runs its
        pre-budget behavior verbatim (every admission gets a full
        ``ragged_chunk`` slice), so budget-OFF is byte-identical to the
        pre-PR scheduler by construction. Runs on the engine thread just
        before the round (``_engine_round``), so the caps always reflect
        the admissions actually dispatched."""
        budget = int(self.cfg.prefill_budget)
        if budget <= 0 or not adms:
            return None
        eng_cfg = self.engine.cfg
        chunk_cap = min(
            max(int(getattr(eng_cfg, "ragged_chunk", budget)), 1),
            eng_cfg.prefill_buckets[-1],
        )
        # a fully-cached admission (empty ``fresh``) still needs ONE
        # budget token to ride a round and sample its first token — a
        # zero need would grant a zero cap and skip it forever
        needs = [max(1, min(len(adm.fresh), chunk_cap)) for adm in adms]
        grants = split_prefill_budget(needs, budget,
                                      start=self._prefill_rr)
        self._prefill_rr += 1
        if sum(grants) < sum(needs):
            self.stats["budgeted_rounds"] += 1
            self.stats["budget_skipped_admissions"] += sum(
                1 for g in grants if g <= 0
            )
        return {adm.slot: g for adm, g in zip(adms, grants)}

    def _engine_round(self) -> float:
        """One blocking engine round on the worker thread. Returns latency ms.

        Ragged mode with admissions in flight dispatches ONE
        ``engine.ragged_round``: every active decode slot advances one
        token and every admission advances one prefill chunk in the same
        invocation — build-ragged-batch → dispatch → commit, no competing
        prefill dispatch, no subwave/interleave stall shaping. With no
        admission in flight a ragged round degenerates to pure decode, so
        the multi-step scan (horizon amortization of the host RTT) is the
        better dispatch for the identical math and runs instead."""
        t0 = time.perf_counter()
        if self._ragged:
            adms = [adm for adm, _ in self._ragged]
            self.engine.ragged_round(adms, self._prefill_chunk_caps(adms))
            self.stats["ragged_rounds"] += 1
            return (time.perf_counter() - t0) * 1000.0
        steps = self._levels[self._level]
        if self._heap or self._chunked is not None:
            # work is waiting (queued requests or a mid-prefill chunked
            # admission): bounded horizon so admission latency stays low
            # without falling back to one-RTT-per-token stepping; snap
            # to the largest level ≤ the cap, or the smallest level when
            # every level exceeds it (only compiled lengths may run)
            cap = min(steps, self.cfg.busy_multi_step)
            eligible = [t for t in self._levels if t <= cap]
            steps = max(eligible) if eligible else min(self._levels)
        self.engine.decode_multi(steps)
        return (time.perf_counter() - t0) * 1000.0

    def _retune(self, latency_ms: float) -> None:
        """One quantized horizon level up/down against the latency target —
        levels only, so the set of decode horizons stays bounded."""
        ema = self.stats["step_latency_ema_ms"]
        ema = latency_ms if ema == 0 else 0.8 * ema + 0.2 * latency_ms
        self.stats["step_latency_ema_ms"] = ema
        if not self.cfg.adaptive:
            return
        if ema > self.cfg.target_step_latency_ms * 1.1:
            self._level = max(0, self._level - 1)
        elif ema < self.cfg.target_step_latency_ms * 0.9:
            self._level = min(len(self._levels) - 1, self._level + 1)
        self._horizon = float(self._levels[self._level])
        self.stats["horizon"] = self._horizon

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        latch_until = 0.0
        while True:
            # idle = no batcher-OWNED work. Deliberately not
            # engine.num_active: a foreign slot must neither keep this loop
            # spinning nor be finished behind its owner's back.
            if not self._heap and not self._slot_items \
                    and self._chunked is None and not self._ragged \
                    and self._spec_wave is None:
                self._wake.clear()
                if self._stopping:
                    return
                await self._wake.wait()
                # admission latch: give co-arriving requests a window to form
                # a batch
                latch_until = time.time() + self.cfg.max_wait_ms / 1000.0
            while time.time() < latch_until and \
                    len(self._heap) < len(self.engine.slots):
                await asyncio.sleep(0.001)
            # cancel/interrupt events land at this quiescent boundary:
            # aborted requests release their slots BEFORE admission so the
            # freed capacity admits waiting work this very pass
            await self._scan_signals()
            # hopeless deadline work drops at the same boundary, so its
            # freed blocks admit waiting on-time work this very pass
            await self._scan_deadlines()
            # low-depth all-greedy load routes through the spec tree BEFORE
            # paged admission claims it; requests arriving mid-wave admit to
            # paged slots below and the two interleave round for round
            await self._maybe_start_spec_wave()
            await self._admit()
            # admission-sourced KV pressure: deferred requests wait, or a
            # higher-priority arrival preempts the lowest-priority victim
            await self._check_pressure()
            # one prefill chunk of the in-flight long admission per loop
            # iteration — decode rounds below run between chunks, so active
            # slots stall at most one chunk per round
            await self._step_chunked()
            # one bounded dispatch of the in-flight spec wave
            await self._step_spec_wave()
            if not self._slot_items and self._chunked is None \
                    and not self._ragged:
                # no batcher-owned slot decodes: no frozen slot of OURS is
                # waiting on freed blocks, so resumes may flow immediately
                # (foreign slots are left untouched for their owner)
                self._resume_hold = False
                if self._heap:
                    # deferred (pressured) work with an idle engine: yield
                    # briefly instead of hot-spinning the admission loop
                    await asyncio.sleep(0.001)
                continue
            try:
                latency = await loop.run_in_executor(
                    self._exec, self._engine_round
                )
                self.stats["decode_rounds"] += 1
                self.stats["occupancy_sum"] += self.engine.num_active
                self._retune(latency)
                # admission-chunk rounds on the timeline: one bounded note
                # per in-flight traced admission per round
                for adm, item in self._ragged:
                    if item.flight is not None:
                        self._note(item, "batcher.chunk_round", off=adm.off)
                # ragged admissions whose final chunk sampled its first
                # token this round join the batch (the finished-slot sweep
                # below then resolves any that immediately hit stop/length)
                for adm, item in [p for p in self._ragged if p[0].done]:
                    self._ragged.remove((adm, item))
                    resumed = item.preempted is not None
                    item.preempted = None
                    self._slot_items[adm.slot] = item
                    self._admit_stamp[adm.slot] = next(self._stamp)
                    self.stats["admitted"] += 1
                    if not resumed:
                        # a resume keeps its first token's instant: the
                        # JAX batcher notes none for it either
                        self._note_first_token(item, adm.slot)
                for i, s in enumerate(list(self.engine.slots)):
                    if s is not None and s.finish_reason is not None \
                            and i in self._slot_items:
                        # OWNED slots only: a foreign sequence that finished
                        # while sharing our rounds keeps its slot until its
                        # owner collects it
                        resp = await loop.run_in_executor(
                            self._exec, self.engine.finish_slot, i
                        )
                        item = self._slot_items.pop(i, None)
                        if item and not item.future.done():
                            self._note(item, "batcher.completed",
                                       finish_reason=resp.finish_reason,
                                       tokens=resp.completion_tokens)
                            item.future.set_result(resp)
                            self.stats["completed"] += 1
                # streaming observers see each surviving slot's monotonic
                # token list once per round (finished slots resolved above)
                self._notify_observers()
                # decode-sourced KV pressure: slots froze this round —
                # preempt the policy victim so the next round progresses
                # (completions above may already have freed blocks; the
                # check skips if every frozen slot resolved). An
                # unpressured round releases the resume hold.
                await self._check_pressure(after_round=True)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # a failed round must not wedge the batcher: fail every
                # in-flight request, abort its slot, keep serving the queue
                self.stats["engine_errors"] = self.stats.get("engine_errors", 0) + 1
                if self._chunked is not None:
                    # the mid-prefill admission isn't in _slot_items yet —
                    # release its slot and resolve its future here or the
                    # caller hangs until timeout
                    adm, chunk_item = self._chunked
                    self._chunked = None
                    try:
                        await loop.run_in_executor(
                            self._exec, self.engine.abort_chunked, adm
                        )
                    except Exception:
                        pass
                    if not chunk_item.future.done():
                        chunk_item.future.set_result(
                            InferenceResponse(
                                request_id=chunk_item.request.request_id,
                                error=f"engine error: {e}",
                            )
                        )
                        self.stats["completed"] += 1
                # mid-prefill ragged admissions likewise aren't in
                # _slot_items yet — release their slots and resolve
                for adm, rag_item in list(self._ragged):
                    try:
                        await loop.run_in_executor(
                            self._exec, self.engine.abort_chunked, adm
                        )
                    except Exception:
                        pass
                    if not rag_item.future.done():
                        rag_item.future.set_result(
                            InferenceResponse(
                                request_id=rag_item.request.request_id,
                                error=f"engine error: {e}",
                            )
                        )
                        self.stats["completed"] += 1
                self._ragged.clear()
                for i in list(self._slot_items):
                    # fail OWNED slots only — a foreign slot's owner handles
                    # its own engine-error cleanup
                    if self.engine.slots[i] is not None:
                        try:
                            await loop.run_in_executor(
                                self._exec,
                                lambda i=i: self.engine.finish_slot(
                                    i, cache=False),
                            )
                        except Exception:
                            pass
                    item = self._slot_items.pop(i, None)
                    if item and not item.future.done():
                        item.future.set_result(
                            InferenceResponse(
                                request_id=item.request.request_id,
                                error=f"engine error: {e}",
                            )
                        )
                        self.stats["completed"] += 1

    def get_stats(self) -> Dict[str, Any]:
        out = dict(self.stats)
        out["queue_depth"] = len(self._heap)
        out["active_slots"] = self.engine.num_active
        out["ragged_mode"] = self.use_ragged
        out["ragged_in_flight"] = len(self._ragged)
        out["spec_wave_active"] = self._spec_wave is not None
        if self.spec is not None:
            out["spec"] = self.spec.get_stats()
        if getattr(self.engine.cfg, "speculative", None) is not None:
            # engine-integrated speculation: every round commits 1..K+1
            # tokens a slot, so these are this batcher's serving-efficiency
            # numbers
            es = self.engine.get_stats()
            out["spec_integrated"] = {
                "accept_rate": es.get("spec_accept_rate", 0.0),
                "tokens_per_step": es.get("spec_tokens_per_step", 0.0),
                "steps": es.get("spec_steps", 0),
                "accepted": es.get("spec_accepted", 0),
                "drafted": es.get("spec_drafted", 0),
            }
        if out["decode_rounds"]:
            out["avg_occupancy"] = out["occupancy_sum"] / out["decode_rounds"]
        return out


class BatcherServing:
    """Thread-hosted serving front-end over a :class:`ContinuousBatcher`.

    The batcher is asyncio-native; the worker's callers are plain threads
    (the poll loop, request handlers, tests). This
    wrapper owns a dedicated event loop thread running ONE batcher and
    exposes a thread-safe surface:

    - :meth:`submit` — blocking submit from any thread (the batcher's
      serving hooks — observer / cancel / interrupt / resume_from / flight
      — pass through), raising :class:`RequestMigrated` on drain.
    - :meth:`reconfigure` — apply server-pushed SLO knobs between rounds.
    """

    def __init__(self, engine: TorchEngine,
                 cfg: Optional[BatcherConfig] = None,
                 spec: Optional[Any] = None) -> None:
        self.engine = engine
        self._cfg = cfg
        self._spec = spec
        self.batcher: Optional[ContinuousBatcher] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._ready = threading.Event()
        self._stopped = False
        self._boot_error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, name="batcher-serving", daemon=True
        )
        self._thread.start()
        if not self._ready.wait(timeout=10.0):
            raise RuntimeError("batcher serving loop failed to start")
        if self._boot_error is not None:
            raise RuntimeError(
                f"batcher serving loop failed: {self._boot_error}"
            )

    def _run(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop

        async def boot() -> None:
            try:
                self.batcher = ContinuousBatcher(self.engine, self._cfg,
                                                 spec=self._spec)
                self.batcher.start()
            except BaseException as exc:  # noqa: BLE001 — surfaced to ctor
                self._boot_error = exc
            finally:
                self._ready.set()

        loop.run_until_complete(boot())
        if self._boot_error is None:
            loop.run_forever()
        loop.close()

    # -- thread-safe surface -------------------------------------------------

    def submit_async(self, request: InferenceRequest,
                     timeout_s: Optional[float] = None,
                     **hooks: Any) -> "_Future[InferenceResponse]":
        assert self.batcher is not None and self._loop is not None
        if self._stopped or not self._thread.is_alive():
            # a coroutine scheduled on a dead loop never runs and its
            # future never resolves — fail fast instead of hanging callers.
            # NOT loop.is_running(): that is False in the window between
            # boot() completing and run_forever() starting, and a coroutine
            # scheduled in that window runs fine once the loop spins up.
            raise RuntimeError("batcher serving is stopped")
        return asyncio.run_coroutine_threadsafe(
            self.batcher.submit(request, timeout_s, **hooks), self._loop
        )

    def submit(self, request: InferenceRequest,
               timeout_s: Optional[float] = None,
               **hooks: Any) -> InferenceResponse:
        return self.submit_async(request, timeout_s, **hooks).result()

    def adopt_slot(self, slot: int,
                   request: Optional[InferenceRequest] = None,
                   flight: Optional[Any] = None) -> InferenceResponse:
        """Blocking :meth:`ContinuousBatcher.adopt_slot` from any thread."""
        assert self.batcher is not None and self._loop is not None
        if self._stopped or not self._thread.is_alive():
            raise RuntimeError("batcher serving is stopped")
        return asyncio.run_coroutine_threadsafe(
            self.batcher.adopt_slot(slot, request, flight=flight), self._loop
        ).result()

    def run_exclusive(self, fn: Callable[..., Any], *args: Any, **kw: Any) -> Any:
        """Run ``fn`` on the batcher's engine-executor thread and return its
        result. Every engine call the batcher makes runs on that one thread,
        so this serializes out-of-band engine work (PD prefill and export,
        handoff adoption, releases) with the rounds: it runs between them,
        and no other thread touches the device."""
        assert self.batcher is not None
        return self.batcher._exec.submit(fn, *args, **kw).result()

    def reconfigure(self, **updates: Any) -> None:
        """Thread-safe config push: applied on the loop thread between
        iterations (the batcher reads its cfg only at loop boundaries)."""
        if self._loop is None or self.batcher is None:
            return

        def _apply() -> None:
            try:
                self.batcher.reconfigure(**updates)
            except Exception:  # noqa: BLE001 — an operator push must not
                # die in the event loop's default handler unseen
                log.exception("serving config push rejected: %r", updates)

        self._loop.call_soon_threadsafe(_apply)

    def get_stats(self) -> Dict[str, Any]:
        return self.batcher.get_stats() if self.batcher is not None else {}

    @property
    def active(self) -> bool:
        # explicit lifecycle flag, NOT loop.is_running(): the latter is
        # False between boot() and run_forever(), and a request arriving
        # in that window would silently fall through to the legacy
        # engine-lock path while the batcher thread comes up — two
        # drivers on one engine
        return (
            self.batcher is not None
            and self._loop is not None
            and not self._stopped
            and self._thread.is_alive()
        )

    def stop(self, drain: bool = True, timeout_s: float = 30.0) -> None:
        if self._loop is None or self.batcher is None or self._stopped:
            return
        self._stopped = True   # reject new submits before draining old ones
        try:
            asyncio.run_coroutine_threadsafe(
                self.batcher.stop(drain=drain), self._loop
            ).result(timeout=timeout_s)
        except Exception:  # noqa: BLE001 — drain stuck/timed out
            # the loop must NOT die with futures still pending (every
            # thread blocked in submit().result() would hang forever):
            # force a non-drain stop, which resolves all outstanding
            # futures with "batcher stopped" before the loop goes down
            try:
                asyncio.run_coroutine_threadsafe(
                    self.batcher.stop(drain=False), self._loop
                ).result(timeout=5.0)
            except Exception:  # noqa: BLE001 — loop wedged: give up
                pass
        try:
            self._loop.call_soon_threadsafe(self._loop.stop)
        except RuntimeError:   # loop already closed (boot failed earlier)
            pass
        self._thread.join(timeout=5.0)
        # the engine call in flight on the executor (a round, an export)
        # ends before stop returns, and none queued behind it starts: once
        # stopped, nothing touches the engine or its device memory
        self.batcher._exec.shutdown(wait=True, cancel_futures=True)
