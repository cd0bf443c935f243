"""The worker's LLM engine on PyTorch: tokenizer + ``TorchEngine`` behind
the continuous batcher.

The port of ``distributed_gpu_inference_tpu/worker/engines/llm.py``
``TPULLMEngine`` for the serving paths the direct server drives.
``load_model`` builds a :class:`TorchEngine` and a :class:`BatcherServing`
front end; every request goes through the batcher, so concurrent callers
share engine rounds through slot-level continuous batching:

- ``inference(params)`` — the blocking result payload of the JAX engine;
  a server-minted ``_cancel_evt`` (hedged dispatch) aborts it at the next
  step boundary with ``finish_reason="abort"``;
- ``stream(params, cancel)`` / ``stream_inference`` — token streaming, one
  event per token ``{"text_delta", "token_ids", "offset"}`` then a final
  ``{"done", "finish_reason", "usage", "offset"}``, exactly once across a
  resume (:class:`_StreamSplicer`);
- failover — a ``_failover_ctx`` in params registers the generation for
  ``checkpoint_live`` (slot checkpoints through
  ``TorchEngine.snapshot_slot``, wire-identical to the JAX package's),
  pushes stream checkpoints to ``checkpoint_sink``, resumes from a
  checkpoint either package wrote, and turns a drain (``interrupt_live``)
  into :class:`JobMigrated`.

Not in this slice: ``tokenizer_id`` (needs ``transformers``),
prefill/decode hand-off stages, KV migration, the flight recorder,
speculative decoding, spill tiers, tensor parallelism, and the JAX
package's per-step stream loop for engines without a batcher (the port
always serves through its batcher).
"""

from __future__ import annotations

import asyncio
import queue as _queue_mod
import threading
import time
from typing import Any, Dict, List, Optional

from distributed_gpu_inference_torch.runtime.batcher import (
    BatcherConfig,
    BatcherServing,
    RequestMigrated,
    synthesize_checkpoint,
)
from distributed_gpu_inference_torch.runtime.engine import (
    EngineConfig,
    PreemptedSequence,
    TorchEngine,
)
from distributed_gpu_inference_torch.utils.data_structures import (
    InferenceRequest,
    SamplingParams,
)
from distributed_gpu_inference_torch.worker.engines.base import (
    EngineLoadError,
    GenerationConfig,
    GenerationResult,
    JobMigrated,
    LLMBaseEngine,
    ServingError,
)

# the serving knobs the JAX worker reads from ``engines.llm.serving.*``
# (its ServingConfig defaults), limited to the ones this slice uses
SERVING_DEFAULTS: Dict[str, Any] = {
    "target_step_ms": 100.0,
    "max_horizon": 64,
    "min_horizon": 1,
    "multi_step": 8,
    "adaptive": True,
    "max_wait_ms": 5.0,
    "queue_limit": 1024,
    "default_timeout_s": 300.0,
    "max_preemptions": 3,
    "ragged": None,
    "prefill_budget": 0,
    "ragged_chunk": None,
}


def _raise_serving(resp: Any) -> None:
    """Raise the serving failure carried by an InferenceResponse, keeping
    its machine-readable ``error_code``."""
    raise ServingError(resp.error, error_code=getattr(resp, "error_code", None))


class ByteTokenizer:
    """Deterministic fallback: UTF-8 bytes offset past special ids.

    vocab = 256 + specials; id 0 = pad/bos, 1 = eos. Keeps the whole stack
    runnable hermetically (tests, benchmarks with random weights).
    """

    eos_token_id = 1
    bos_token_id = 0

    def __init__(self, offset: int = 4) -> None:
        self._offset = offset
        self.vocab_size = 256 + offset

    def encode(self, text: str) -> List[int]:
        return [b + self._offset for b in text.encode("utf-8")]

    def decode(self, ids: List[int]) -> str:
        # ids beyond the byte range (models with vocab > 256+offset emit
        # them under random weights) are dropped, not crashed on
        data = bytes(
            i - self._offset for i in ids
            if self._offset <= i < self._offset + 256
        )
        return data.decode("utf-8", errors="replace")

    def apply_chat_template(self, messages: List[Dict[str, str]]) -> str:
        parts = [f"<|{m.get('role', 'user')}|>{m.get('content', '')}"
                 for m in messages]
        return "".join(parts) + "<|assistant|>"


class _StreamSplicer:
    """Per-snapshot token→chunk derivation of the stream loop: the block
    the exactly-once streaming contract requires to stay byte-identical to
    the JAX package's: resume-splice re-derivation, whole-sequence
    re-decode (multi-byte chars and cross-chunk stop strings stay correct),
    the stop scan, holdback, and delta/new-ids emission.

    ``advance(gen, finished)`` consumes a monotonic generated-token
    prefix and returns ``(chunk | None, stop_cut)``; the caller stamps
    and yields the chunk (offset = ``sent_tokens``) and aborts the run
    when ``stop_cut`` is True."""

    def __init__(self, tokenizer, cfg, holdback: int,
                 resume_from: int, resume_text: int) -> None:
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.holdback = holdback
        self.resume_text = resume_text
        self.sent_tokens = 0
        self.sent_text = ""
        # splice point of a resumed stream: the client already consumed
        # tokens [0, resume_from) — regenerate silently up to it, then
        # re-derive the exact text the ORIGINAL stream had delivered at
        # that offset (same holdback formula, same deterministic tokens)
        self.splice: Optional[int] = resume_from if resume_from > 0 else None
        self.finish_override: Optional[str] = None

    @staticmethod
    def _trim_partial_tail(text: str, floor: int) -> str:
        """Withhold trailing replacement characters: a U+FFFD at the very
        end of an incremental decode is (usually) an INCOMPLETE multi-byte
        sequence the next token's bytes complete — emitting it now would
        bake the wrong character into the stream, and the whole-stream
        text would diverge from the batch decode of the same tokens.
        Held-back chars are delivered once resolved, or verbatim at finish
        (a genuine lone invalid byte still reaches the client). Never trims
        below ``floor`` (text already delivered)."""
        while len(text) > floor and text.endswith("\ufffd"):
            text = text[:-1]
        return text

    def advance(self, gen: List[int], finished: bool):
        if self.splice is not None and (len(gen) >= self.splice or finished):
            self.sent_tokens = min(self.splice, len(gen))
            raw = self.tokenizer.decode(gen[: self.sent_tokens])
            self.sent_text = raw
            if self.holdback:
                self.sent_text = self.sent_text[
                    : max(len(self.sent_text) - self.holdback, 0)
                ]
            # mirror the live stream's partial-tail holdback: at offset
            # ``splice`` the original stream had NOT yet delivered a
            # trailing replacement char, so the re-derived consumed text
            # must not count it either
            self.sent_text = self._trim_partial_tail(self.sent_text, 0)
            if self.resume_text > len(self.sent_text):
                # a holdback flush reached the client before the drop:
                # its characters are consumed even though the token
                # offset didn't advance
                self.sent_text = raw[: self.resume_text]
            self.splice = None
        if self.splice is not None or \
                (len(gen) <= self.sent_tokens and not finished):
            return None, False
        # decode the WHOLE sequence: multi-byte characters and
        # cross-chunk stop strings stay correct
        full = self.tokenizer.decode(gen)
        stop_idx = -1
        for st in self.cfg.stop:
            idx = full.find(st)
            if idx >= 0 and (stop_idx < 0 or idx < stop_idx):
                stop_idx = idx
        if stop_idx >= 0:
            target = full[:stop_idx]
            self.finish_override = "stop"
        elif finished:
            target = full
        else:
            target = full[: max(len(full) - self.holdback,
                                len(self.sent_text))]
            target = self._trim_partial_tail(target, len(self.sent_text))
        delta = target[len(self.sent_text):]
        # token ids past a stop cut are not emitted
        new_ids = [] if stop_idx >= 0 else list(gen[self.sent_tokens:])
        self.sent_text = target
        self.sent_tokens = len(gen)
        # emit on new token ids even when the text delta is empty (id
        # outside the tokenizer's decodable range, or held back):
        # exactly-once delivery means every sampled id reaches the client
        # in some chunk — silently skipped ids would desync the splice
        chunk = ({"text_delta": delta, "token_ids": new_ids}
                 if (delta or new_ids) else None)
        return chunk, stop_idx >= 0


class _CheckpointPusher:
    """Latest-wins background pusher for stream-cadence checkpoints.

    The sink is a blocking control-plane call, which must never stall the
    decode loop (a hung control plane would otherwise freeze every live
    stream for a full timeout per push). One pending entry per key is
    kept — a newer checkpoint supersedes an unsent older one, so a slow
    plane costs checkpoint STALENESS (bounded extra recompute on
    failover), never tokens/sec."""

    def __init__(self, sink) -> None:
        self._sink = sink
        self._latest: Dict[str, Dict[str, Any]] = {}
        self._cv = threading.Condition()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="ckpt-pusher"
        )
        self._thread.start()

    def put(self, entry: Dict[str, Any]) -> None:
        with self._cv:
            self._latest[str(entry.get("key"))] = entry
            self._cv.notify()

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._latest:
                    self._cv.wait()
                _, entry = self._latest.popitem()
            try:
                self._sink(entry)
            except Exception:  # noqa: BLE001 — best-effort by contract
                pass


class TorchLLMEngine(LLMBaseEngine):
    """config keys: model (name in the models/configs registry), tokenizer,
    max_batch_size, max_seq_len, multi_step, enable_prefix_cache,
    prefill_buckets, num_blocks, dtype, quantization (int8 | fp8 weight-only,
    ``ops/quantization.py``), kv_cache_dtype (int8 | fp8 | None = dtype),
    device (default ``cuda``), seed,
    params (a params tree already on the device, e.g. from
    ``models.convert.params_from_numpy``; random init from ``seed`` when
    absent), checkpoint_interval_tokens (the stream checkpoint cadence, 0 =
    the admission checkpoint only) and the ``serving`` knobs of
    :data:`SERVING_DEFAULTS`."""

    task_type = "llm"
    # the caller injects a ``_failover_ctx`` (job or stream key, assignment
    # epoch, server-held checkpoint) only into engines that advertise this
    supports_failover = True

    def __init__(self, config: Optional[Dict[str, Any]] = None) -> None:
        super().__init__(config)
        self.engine: Optional[TorchEngine] = None
        self.serving: Optional[BatcherServing] = None
        self.tokenizer = self.config.get("tokenizer")
        # key → live generation (request_id to find its slot, kind
        # job|stream, assignment epoch); checkpoint_live snapshots these
        # from another thread, reading host state only
        self._live: Dict[str, Dict[str, Any]] = {}
        self._live_lock = threading.Lock()
        # graceful drain: set by interrupt_live(); queued jobs freeze at
        # the next step boundary and raise JobMigrated
        self._interrupt = threading.Event()
        # where stream checkpoints go (the worker points it at its control
        # plane client): once at admission, then every
        # checkpoint_interval_tokens
        self.checkpoint_sink = None
        self._ckpt_pusher: Optional[_CheckpointPusher] = None
        # server-held checkpoints refused at resume (bad crc, unparseable):
        # each degrades to a from-scratch run
        self.ckpt_corrupt = 0
        self._ckpt_interval = int(
            self.config.get("checkpoint_interval_tokens", 8) or 0
        )

    # -- lifecycle -----------------------------------------------------------

    def load_model(self) -> None:
        model_name = self.config.get("model", "llama3-mini")
        if self.tokenizer is None:
            self.tokenizer = ByteTokenizer()
        sv = self._serving_config()
        eng_cfg = EngineConfig(
            max_batch_size=int(self.config.get("max_batch_size", 8)),
            max_seq_len=int(self.config.get("max_seq_len", 2048)),
            multi_step=int(self.config.get("multi_step", 16)),
            enable_prefix_cache=bool(
                self.config.get("enable_prefix_cache", True)
            ),
            dtype=str(self.config.get("dtype", "bfloat16")),
            quantization=self.config.get("quantization"),
            kv_cache_dtype=self.config.get("kv_cache_dtype"),
            num_blocks=(int(self.config["num_blocks"])
                        if self.config.get("num_blocks") else None),
        )
        if self.config.get("prefill_buckets"):
            eng_cfg.prefill_buckets = tuple(
                sorted(int(w) for w in self.config["prefill_buckets"])
            )
        if sv.get("ragged_chunk"):
            eng_cfg.ragged_chunk = int(sv["ragged_chunk"])
        try:
            self.engine = TorchEngine(
                model_name,
                eng_cfg,
                params=self.config.get("params"),
                seed=int(self.config.get("seed", 0)),
                device=self.config.get("device", "cuda"),
            )
        except (ValueError, KeyError, NotImplementedError) as exc:
            raise EngineLoadError(str(exc)) from exc
        try:
            self.serving = BatcherServing(self.engine, self._batcher_config(sv))
        except (ValueError, RuntimeError) as exc:
            raise EngineLoadError(
                f"batcher serving config invalid: {exc}"
            ) from exc
        self.loaded = True

    def _serving_config(self) -> Dict[str, Any]:
        """Merged serving knobs: defaults < ``config['serving']``."""
        out = dict(SERVING_DEFAULTS)
        src = self.config.get("serving")
        if isinstance(src, dict):
            out.update({k: v for k, v in src.items() if v is not None})
        return out

    @staticmethod
    def _batcher_config(sv: Dict[str, Any]) -> BatcherConfig:
        return BatcherConfig(
            max_wait_ms=float(sv["max_wait_ms"]),
            multi_step=int(sv["multi_step"]),
            min_multi_step=int(sv["min_horizon"]),
            max_multi_step=int(sv["max_horizon"]),
            adaptive=bool(sv["adaptive"]),
            target_step_latency_ms=float(sv["target_step_ms"]),
            queue_limit=int(sv["queue_limit"]),
            default_timeout_s=float(sv["default_timeout_s"]),
            max_preemptions=int(sv["max_preemptions"]),
            ragged=(None if sv.get("ragged") is None
                    else bool(sv["ragged"])),
            prefill_budget=int(sv.get("prefill_budget") or 0),
        )

    def serving_stats(self) -> Optional[Dict[str, Any]]:
        if self.serving is None or not self.serving.active:
            return None
        return self.serving.get_stats()

    def unload(self) -> None:
        if self.serving is not None:
            self.serving.stop(drain=False)
            self.serving = None
        self.engine = None
        super().unload()

    # -- requests -------------------------------------------------------------

    def _to_prompt(self, prompt_or_messages: Any) -> str:
        if isinstance(prompt_or_messages, str):
            return prompt_or_messages
        if isinstance(prompt_or_messages, list):  # chat messages
            tmpl = getattr(self.tokenizer, "apply_chat_template", None)
            if tmpl is not None:
                try:
                    out = tmpl(prompt_or_messages, tokenize=False,
                               add_generation_prompt=True)
                except TypeError:  # ByteTokenizer's simpler signature
                    out = tmpl(prompt_or_messages)
                return out
            return "\n".join(m.get("content", "") for m in prompt_or_messages)
        raise ValueError(f"bad prompt type {type(prompt_or_messages)}")

    def _stop_ids(self, cfg: GenerationConfig) -> tuple:
        ids = list(cfg.stop_token_ids)
        eos = getattr(self.tokenizer, "eos_token_id", None)
        if eos is not None and eos not in ids:
            ids.append(int(eos))
        return tuple(ids[:4])

    def _sampling_from(self, cfg: GenerationConfig) -> SamplingParams:
        return SamplingParams(
            max_new_tokens=cfg.max_new_tokens,
            temperature=cfg.temperature,
            top_k=cfg.top_k,
            top_p=cfg.top_p,
            stop_token_ids=(() if cfg.ignore_eos else self._stop_ids(cfg)),
            seed=cfg.seed,
            ignore_eos=cfg.ignore_eos,
        )

    def _encode_prompt(self, prompt_or_messages: Any,
                       cfg: GenerationConfig) -> List[int]:
        """Template, tokenize, and keep the tail that fits max_seq_len."""
        text = self._to_prompt(prompt_or_messages)
        token_ids = list(self.tokenizer.encode(text))
        max_prompt = self.engine.cfg.max_seq_len - cfg.max_new_tokens - 1
        if len(token_ids) > max_prompt > 0:
            token_ids = token_ids[-max_prompt:]  # keep the tail (recency)
        return token_ids

    def _build_request(self, prompt_or_messages: Any,
                       cfg: GenerationConfig) -> InferenceRequest:
        if not self.loaded or self.engine is None:
            raise EngineLoadError("engine not loaded")
        return InferenceRequest(
            prompt_token_ids=self._encode_prompt(prompt_or_messages, cfg),
            sampling=self._sampling_from(cfg),
            deadline_s=cfg.deadline_s,
        )

    def _params_request(self, params: Dict[str, Any],
                        cfg: GenerationConfig) -> InferenceRequest:
        """The request of a job's or a stream's params (prompt or chat
        messages, priority)."""
        req = self._build_request(
            params.get("messages") or params.get("prompt") or "", cfg,
        )
        if params.get("priority") is not None:
            req.priority = int(params.get("priority") or 0)
        return req

    def inference(self, params: Dict[str, Any]) -> Dict[str, Any]:
        if params.get("pd_stage") is not None:
            raise ServingError(
                "prefill/decode hand-off stages are not ported yet",
                error_code="unsupported",
            )
        if self.serving is None or not self.serving.active:
            raise EngineLoadError("engine not loaded")
        ctx = params.get("_failover_ctx")
        if isinstance(ctx, dict):
            return self._job_inference(params, ctx)
        return self._serving_inference(params)

    def _serving_inference(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Blocking request through the batcher front end: concurrent
        callers share engine rounds via slot-level continuous batching."""
        cfg = GenerationConfig.from_params(params)
        req = self._params_request(params, cfg)
        # hedged dispatch: the direct server mints a cancel event for a
        # request that carries a hedge key — the losing racer is aborted at
        # the batcher's next step boundary (partial output with
        # finish_reason="abort", never an error)
        cancel = params.pop("_cancel_evt", None)
        t0 = time.perf_counter()
        resp = self.serving.submit(req, cancel=cancel)
        if resp.error is not None:
            _raise_serving(resp)
        return self._finish_payload(
            list(resp.token_ids), resp.prompt_tokens, resp.cached_tokens,
            resp.finish_reason or "stop", cfg, resp.ttft_ms,
            time.perf_counter() - t0,
        )

    def _finish_payload(self, token_ids: List[int], prompt_tokens: int,
                        cached_tokens: int, finish_reason: str,
                        cfg: GenerationConfig, ttft_ms: Optional[float],
                        e2e_s: float) -> Dict[str, Any]:
        """Result payload: decode + stop-string truncation at the earliest
        stop string, as the stream cuts it (:class:`_StreamSplicer`)."""
        out_text = self.tokenizer.decode(token_ids) if self.tokenizer else ""
        finish = finish_reason
        cuts = [i for i in (out_text.find(s) for s in cfg.stop) if i >= 0]
        if cuts:
            out_text = out_text[:min(cuts)]
            finish = "stop"
        return GenerationResult(
            text=out_text,
            prompt_tokens=prompt_tokens,
            completion_tokens=len(token_ids),
            cached_tokens=cached_tokens,
            finish_reason=finish,
            ttft_ms=ttft_ms if ttft_ms is not None else e2e_s * 1000.0,
        ).to_result_payload()

    # -- token streaming -----------------------------------------------------

    def stream(self, params: Dict[str, Any],
               cancel: Optional[Any] = None):
        """Sync generator of stream chunks through the batcher: the
        sequence shares decode rounds with every other in-flight request.
        ``{"text_delta", "token_ids", "offset"}``... then a final
        ``{"done": True, "finish_reason", "usage", "offset"}``; ``offset``
        (and ``stream_id``) only when the request carries a stream key.
        ``cancel`` (an Event) aborts at the next step boundary."""
        if self.serving is None or not self.serving.active:
            raise EngineLoadError("engine not loaded")
        return self._stream_serving(params, cancel=cancel)

    def _stream_serving(self, params: Dict[str, Any],
                        cancel: Optional[Any] = None):
        """Batcher-backed token streaming: the request is submitted with a
        per-round observer; deltas are derived from the observer's
        monotonic token snapshots by :class:`_StreamSplicer`, so
        exactly-once token offsets and checkpoint/resume hold while the
        sequence shares rounds with other slots."""
        cfg = GenerationConfig.from_params(params)
        ctx = params.get("_failover_ctx")
        ctx = ctx if isinstance(ctx, dict) else {}
        key = str(ctx.get("key") or params.get("stream_id") or "") or None
        epoch = int(ctx.get("epoch") or 0)
        ckpt = ctx.get("checkpoint")
        resume_from = int(ctx.get("offset") or 0)
        # characters the client already consumed: holdback flushes advance
        # text WITHOUT advancing the token offset, so the token splice
        # alone could re-deliver (or withhold) the flushed tail
        resume_text = int(ctx.get("text_offset") or 0)

        def stamp(chunk: Dict[str, Any], offset: int) -> Dict[str, Any]:
            if key is not None:
                chunk["stream_id"] = key
                chunk["offset"] = offset
            return chunk

        holdback = max((len(s) for s in cfg.stop), default=0)
        holdback = max(holdback - 1, 0)
        pre = self._ckpt_from_wire(ckpt)
        if pre is not None:
            remaining = (pre.request.sampling.max_new_tokens
                         - len(pre.generated))
            if remaining <= 0:
                # the checkpoint holds the whole generation (the donor died
                # between its last decode and the final event): serve its
                # unconsumed tail straight from it, through the live
                # loop's splice, stop and holdback rules
                sp = _StreamSplicer(self.tokenizer, cfg, holdback,
                                    resume_from, resume_text)
                gen = list(pre.generated)
                chunk, _ = sp.advance(gen, finished=True)
                if chunk is not None:
                    yield stamp(chunk, sp.sent_tokens)
                yield stamp({
                    "done": True,
                    "finish_reason": sp.finish_override or "length",
                    "usage": {
                        "prompt_tokens": pre.prompt_len,
                        "completion_tokens": len(gen),
                        "total_tokens": pre.prompt_len + len(gen),
                        "cached_tokens": pre.cached_tokens,
                    },
                }, sp.sent_tokens)
                return
            req = pre.request
        else:
            req = self._params_request(params, cfg)
        request_id = req.request_id
        live_info = {"kind": "stream", "epoch": epoch,
                     "request_id": request_id}

        snaps: "_queue_mod.Queue" = _queue_mod.Queue()
        _DONE = object()
        stop_evt = threading.Event()   # batcher-side abort (cancel / stop cut)
        fut = self.serving.submit_async(
            req, observer=lambda toks: snaps.put(toks),
            cancel=stop_evt, resume_from=pre,
        )
        fut.add_done_callback(lambda f: snaps.put(_DONE))

        last_ckpt = len(pre.generated) if pre is not None else 0
        if key is not None:
            self._register_live(key, "stream", epoch, request_id)
            # admission checkpoint (synchronous): even a worker killed
            # before its first heartbeat leaves a resumable record. The
            # request may still be QUEUED, so the record is built without
            # the engine (the resumed prefix when resuming, zero tokens
            # when fresh) — cadence pushes below carry live slot state.
            self._push_checkpoint({
                "kind": "stream", "key": key, "epoch": epoch,
                "state": (pre or synthesize_checkpoint(req)).to_wire(),
            }, sync=True)
        sp = _StreamSplicer(self.tokenizer, cfg, holdback,
                            resume_from, resume_text)
        stopping = False               # stop string matched: drain silently
        final = None
        try:
            while True:
                try:
                    item = snaps.get(timeout=0.05) if cancel is not None \
                        else snaps.get()
                except _queue_mod.Empty:
                    # cancel-poll timeout: honor a client disconnect even
                    # while the request is still queued (no snapshots yet)
                    if cancel is not None and cancel.is_set():
                        stop_evt.set()
                    continue
                if item is _DONE:
                    final = fut.result()   # raises on engine/submit failure
                    if final.error is not None:
                        _raise_serving(final)
                    gen = list(final.token_ids)
                    finished = True
                else:
                    gen = list(item)
                    finished = False
                # a round snapshot may carry SEVERAL new tokens — process
                # them one at a time so the cadence is one event per token,
                # each stamped with its offset: clients and resume splices
                # count events
                ks = list(range(sp.sent_tokens + 1, len(gen) + 1))
                if not ks and finished:
                    ks = [len(gen)]       # flush held-back chars at EOS
                for k in ks:
                    if stopping:
                        break
                    fin_k = finished and k == len(gen)
                    chunk, stop_cut = sp.advance(gen[:k], fin_k)
                    if chunk is not None:
                        yield stamp(chunk, sp.sent_tokens)
                    if stop_cut and not fin_k:
                        # release the slot; the final (abort) response
                        # still carries the full usage accounting
                        stopping = True
                        stop_evt.set()
                if finished:
                    break
                if cancel is not None and cancel.is_set():
                    stop_evt.set()
                if key is not None and self._ckpt_interval > 0 \
                        and len(gen) - last_ckpt >= self._ckpt_interval:
                    self._push_checkpoint(
                        self._snapshot_live(key, live_info)
                    )
                    last_ckpt = len(gen)
        finally:
            stop_evt.set()     # no-op when already resolved; aborts a run
            #                    abandoned by a closed generator
            if key is not None:
                self._unregister_live(key)
        finish = sp.finish_override or final.finish_reason
        yield stamp({
            "done": True,
            "finish_reason": finish,
            "usage": {
                "prompt_tokens": final.prompt_tokens,
                "completion_tokens": final.completion_tokens,
                "total_tokens": final.prompt_tokens
                + final.completion_tokens,
                "cached_tokens": final.cached_tokens,
            },
        }, sp.sent_tokens)
        # the server-held checkpoint is NOT retired on completion: the
        # worker cannot know the final bytes reached the client; the
        # control plane ages stream checkpoints out

    async def stream_inference(self, params: Dict[str, Any]):
        """Async wrapper: the sync generator runs in a worker thread and
        chunks flow through a queue as they are produced. Closing this
        generator early (client disconnect) signals the pump thread to
        abort AND waits for it — the engine is quiet when control returns
        to the caller."""
        loop = asyncio.get_running_loop()
        q: "asyncio.Queue" = asyncio.Queue()
        _END = object()
        cancel = threading.Event()

        def pump():
            try:
                for chunk in self.stream(params, cancel=cancel):
                    loop.call_soon_threadsafe(q.put_nowait, chunk)
            except Exception as exc:  # noqa: BLE001 - surface to consumer
                chunk = {"error": str(exc)}
                code = getattr(exc, "error_code", None)
                if code:
                    # machine-readable class rides the error event
                    chunk["error_code"] = code
                loop.call_soon_threadsafe(q.put_nowait, chunk)
            finally:
                loop.call_soon_threadsafe(q.put_nowait, _END)

        fut = loop.run_in_executor(None, pump)
        try:
            while True:
                chunk = await q.get()
                if chunk is _END:
                    break
                yield chunk
        finally:
            cancel.set()
            await fut  # engine quiet before the caller releases the claim

    # -- crash-safe generation: live checkpoints + resumable jobs -----------

    def _register_live(self, key: str, kind: str, epoch: int,
                       request_id: str) -> None:
        with self._live_lock:
            self._live[key] = {
                "kind": kind, "epoch": int(epoch), "request_id": request_id,
            }

    def _unregister_live(self, key: str) -> None:
        with self._live_lock:
            self._live.pop(key, None)

    def interrupt_live(self) -> None:
        """Graceful drain: queued jobs freeze at the next step boundary and
        raise :class:`JobMigrated` with their checkpoint. Streams keep
        running to completion (they checkpoint continuously, so a client
        of a worker that then vanishes resumes on a failover peer)."""
        self._interrupt.set()

    def _snapshot_live(self, key: str,
                       info: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Portable checkpoint entry for one live generation, or None when
        its slot is gone, finished or unreadable. Runs beside the engine's
        thread: a torn read degrades to a skipped sample."""
        eng = self.engine
        if eng is None:
            return None
        try:
            for slot, s in enumerate(list(eng.slots)):
                if s is None or s.request.request_id != info["request_id"]:
                    continue
                pre = eng.snapshot_slot(slot)
                if pre.request.request_id != info["request_id"]:
                    # the slot was freed and reused by ANOTHER request
                    # between the scan and the snapshot: a foreign
                    # sequence must never be checkpointed under this key
                    return None
                return {
                    "kind": info["kind"], "key": key,
                    "epoch": info["epoch"], "state": pre.to_wire(),
                }
        except Exception:  # noqa: BLE001 — checkpointing must never break serving
            return None
        return None

    def checkpoint_live(self) -> List[Dict[str, Any]]:
        """Checkpoint entries for every in-flight generation — the payload
        a worker piggybacks on its heartbeats."""
        with self._live_lock:
            live = dict(self._live)
        out = []
        for key, info in live.items():
            entry = self._snapshot_live(key, info)
            if entry is not None:
                out.append(entry)
        return out

    def _push_checkpoint(self, entry: Optional[Dict[str, Any]],
                         sync: bool = False) -> None:
        """Push one checkpoint through ``checkpoint_sink``; sink failures
        are swallowed — a flaky control plane must never abort the
        generation it is trying to protect. ``sync=True`` blocks (the
        one-time admission checkpoint); cadence pushes go through the
        latest-wins background pusher so the stream never waits on the
        sink."""
        if self.checkpoint_sink is None or entry is None:
            return
        if sync:
            try:
                self.checkpoint_sink(entry)
            except Exception:  # noqa: BLE001
                pass
            return
        if self._ckpt_pusher is None:
            self._ckpt_pusher = _CheckpointPusher(self._sink_now)
        self._ckpt_pusher.put(entry)

    def _sink_now(self, entry: Dict[str, Any]) -> None:
        sink = self.checkpoint_sink          # resolved at drain time
        if sink is not None:
            sink(entry)

    def _ckpt_from_wire(self, ckpt: Any) -> Optional[PreemptedSequence]:
        """Parse a server-held checkpoint, degrading corruption (bad crc,
        missing fields, wrong version) to None — a from-scratch run —
        instead of failing the resumed request."""
        if not isinstance(ckpt, dict):
            return None
        try:
            return PreemptedSequence.from_wire(ckpt)
        except Exception:  # noqa: BLE001 — ValueError + anything torn JSON does
            self.ckpt_corrupt += 1
            return None

    def _job_inference(self, params: Dict[str, Any],
                       ctx: Dict[str, Any]) -> Dict[str, Any]:
        """Queued-job path with failover: resumes from the claim's
        server-held checkpoint (``ctx["checkpoint"]``, written by either
        package), shares rounds with every other in-flight request,
        registers for ``checkpoint_live`` and turns a drain interrupt into
        :class:`JobMigrated` — the batcher freezes the sequence at the next
        step boundary and hands back the portable checkpoint. Resume
        restores the key words and recomputes only what the prefix cache no
        longer holds (``TorchEngine.snapshot_slot`` says when a greedy
        continuation is the undisturbed one)."""
        cfg = GenerationConfig.from_params(params)
        key = str(ctx.get("key") or "")
        epoch = int(ctx.get("epoch") or 0)
        if self.engine is None or self.serving is None \
                or not self.serving.active:
            raise EngineLoadError("engine not loaded")
        t0 = time.perf_counter()
        pre = self._ckpt_from_wire(ctx.get("checkpoint"))
        if pre is not None:
            if pre.request.sampling.max_new_tokens - len(pre.generated) <= 0:
                # the checkpoint already holds the whole generation: the
                # previous worker died between its last decode and its
                # completion — deliver without touching the engine
                return self._finish_payload(
                    list(pre.generated), pre.prompt_len,
                    pre.cached_tokens, "length", cfg, None,
                    time.perf_counter() - t0,
                )
            req = pre.request
        else:
            req = self._params_request(params, cfg)
        self._register_live(key, "job", epoch, req.request_id)
        try:
            resp = self.serving.submit(req, resume_from=pre,
                                       interrupt=self._interrupt)
        except RequestMigrated as mig:
            raise JobMigrated(mig.pre.to_wire(),
                              tokens=len(mig.pre.generated)) from None
        finally:
            self._unregister_live(key)
        if resp.error is not None:
            _raise_serving(resp)
        return self._finish_payload(
            list(resp.token_ids), resp.prompt_tokens, resp.cached_tokens,
            resp.finish_reason or "stop", cfg, resp.ttft_ms,
            time.perf_counter() - t0,
        )

    # -- batch path ------------------------------------------------------------

    def batch_inference(self, batch: List[Dict[str, Any]]
                        ) -> List[Dict[str, Any]]:
        """Every request of the batch submitted at once to the batcher (the
        engine's one caller), so they share rounds; payloads in order, built
        as the blocking path builds them."""
        if self.serving is None or not self.serving.active:
            raise EngineLoadError("engine not loaded")
        cfgs = [GenerationConfig.from_params(p) for p in batch]
        reqs = [self._build_request(p.get("messages") or p.get("prompt") or "", c)
                for p, c in zip(batch, cfgs)]
        t0 = time.perf_counter()
        futs = [self.serving.submit_async(r) for r in reqs]
        out = []
        for fut, cfg in zip(futs, cfgs):
            resp = fut.result()
            if resp.error is not None:
                _raise_serving(resp)
            out.append(self._finish_payload(
                list(resp.token_ids), resp.prompt_tokens, resp.cached_tokens,
                resp.finish_reason or "stop", cfg, resp.ttft_ms,
                time.perf_counter() - t0,
            ))
        return out

    def health(self) -> Dict[str, Any]:
        h = super().health()
        if self.engine is not None:
            h["engine_stats"] = self.engine.get_stats()
        stats = self.serving_stats()
        if stats is not None:
            h["serving_stats"] = stats
        return h
