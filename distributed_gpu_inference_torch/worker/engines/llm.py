"""The worker's LLM engine on PyTorch: tokenizer + ``TorchEngine`` behind
the continuous batcher.

The port of ``distributed_gpu_inference_tpu/worker/engines/llm.py``
``TPULLMEngine`` for the paths the worker process and the direct server
drive. ``load_model`` builds a :class:`TorchEngine` and a
:class:`BatcherServing` front end; every request goes through the batcher,
so concurrent callers share engine rounds through slot-level continuous
batching:

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
  into :class:`JobMigrated`;
- the worker's heartbeat channels — ``serving_stats``, the radix prefix
  summary (``prefix_hot``, ``prefix_summary_wire`` / ``_ack`` /
  ``_resync`` / ``_disable``, wire-identical to the JAX engine's for the
  same prompts; blocks evicted into a spill tier are demoted to that tier),
  ``kv_spill_wire_stats`` (spill-tier IO errors, quarantines, breakers),
  ``flight_wire_stats`` (the flight recorder) and the live serving-config
  push (``apply_serving_config``);
- the KV spill tiers (``kv_spill_host_blocks``, ``kv_remote_url`` =
  ``redis://...`` or ``memory://``, ``kv_remote_ttl_s``), deadline
  abandonment (``serving.abandon_deadlines`` / ``deadline_grace_s`` /
  ``predictive_abandon``) and the flight recorder (a job or stream whose
  params carry a ``trace_id`` gets a ``runtime/flight.py`` timeline in its
  result or final chunk).

Speculative decoding, in either of the JAX engine's two modes:

- ``speculative_decode: true`` (with ``spec_num_draft_tokens``,
  ``spec_adaptive``, ``spec_adaptive_min_k``, ``spec_oracle_accept``) makes
  every round of the engine a draft→verify→accept round
  (``EngineConfig.speculative``);
- ``engine: jax-speculative`` (with ``spec_widths``) attaches a standalone
  tree decoder (``runtime/speculative.py`` ``SpeculativeDecoder``, sharing
  the target weights, with its own pool of ``max_batch_size ×
  blocks_per_seq + 2`` blocks) to which the batcher routes low-depth
  greedy load; ``params.speculative = False`` opts a request out, and
  streams always decode through the paged slots.

The two are mutually exclusive. ``load_model`` refuses, with
:class:`EngineLoadError` naming the key, what this port does not serve
rather than ignoring it: ``tokenizer_id`` (needs ``transformers``),
``spec_distill_steps`` (draft distillation is training), tensor parallelism
and the per-step ``serving.mode: direct`` stream loop. Prefill/decode
hand-off stages are refused per request.
"""

from __future__ import annotations

import asyncio
import collections
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
from distributed_gpu_inference_torch.runtime.speculative import (
    SpecDecodeConfig,
    SpeculativeConfig,
    SpeculativeDecoder,
)
from distributed_gpu_inference_torch.runtime.flight import (
    NULL_TIMELINE,
    timeline_for,
)
from distributed_gpu_inference_torch.runtime.prefix_summary import (
    TIER_HOST,
    TIER_SPILL,
    PrefixHotSet,
)
from distributed_gpu_inference_torch.runtime.redis_kv import remote_store_from_url
from distributed_gpu_inference_torch.utils.config import (
    ServingConfig,
    config_dict,
    warn_deprecated_serving_key,
)
from distributed_gpu_inference_torch.utils.data_structures import (
    InferenceRequest,
    SamplingParams,
)
from distributed_gpu_inference_torch.utils.prefixes import (
    canonical_prompt_text,
    prefix_fingerprints,
)
from distributed_gpu_inference_torch.worker.engines.base import (
    EngineLoadError,
    GenerationConfig,
    GenerationResult,
    JobMigrated,
    LLMBaseEngine,
    ServingError,
)

# Worker-config / remote-config serving knobs (``engines.llm.serving.*``):
# keys and defaults derived from ``utils.config.ServingConfig``, as the JAX
# engine derives its own, so plain-dict construction cannot drift from a
# configured worker.
SERVING_DEFAULTS: Dict[str, Any] = config_dict(ServingConfig())

# remote-config ``serving`` keys that may retune a LIVE batcher (a copy of
# the JAX engine's map: remote key → batcher config field)
SERVING_REMOTE_KEYS: Dict[str, str] = {
    "target_step_ms": "target_step_latency_ms",
    "max_horizon": "max_multi_step",
    "min_horizon": "min_multi_step",
    "multi_step": "multi_step",
    "adaptive": "adaptive",
    "max_wait_ms": "max_wait_ms",
    "queue_limit": "queue_limit",
    "default_timeout_s": "default_timeout_s",
    "max_preemptions": "max_preemptions",
    "spec_max_batch": "spec_max_batch",
    "spec_max_active": "spec_max_active",
    "ragged": "ragged",
    "prefill_budget": "prefill_budget",
    "ragged_chunk": "ragged_chunk",
    "abandon_deadlines": "abandon_deadlines",
    "deadline_grace_s": "deadline_grace_s",
    "predictive_abandon": "predictive_abandon",
}

# engine config keys of paths the port does not have: refused at load when
# set, naming the key, never ignored
_UNPORTED_CONFIG = {
    "tokenizer_id": "a tokenizer loaded through transformers",
}


def _truthy(value: Any) -> bool:
    """A pushed or configured flag: strings by content (bool("false") is
    True)."""
    if isinstance(value, str):
        return value.strip().lower() in ("1", "true", "yes", "on", "t", "y")
    return bool(value)


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
    kv_spill_host_blocks (the host-RAM L2 tier, 0 = none), kv_remote_url
    (the L3 tier: ``redis://host:port/db`` or ``memory://``),
    kv_remote_ttl_s, device (default ``cuda``), seed,
    params (a params tree already on the device, e.g. from
    ``models.convert.params_from_numpy``; random init from ``seed`` when
    absent), checkpoint_interval_tokens (the stream checkpoint cadence, 0 =
    the admission checkpoint only), prefix_summary_top_n (the radix
    summary's size, 0 = no summary), the ``serving`` knobs of
    :data:`SERVING_DEFAULTS` (also under ``extra``, which wins), and the
    worker's ``engine`` and ``extra.tp_size``."""

    task_type = "llm"
    # the caller injects a ``_failover_ctx`` (job or stream key, assignment
    # epoch, server-held checkpoint) only into engines that advertise this
    supports_failover = True

    def __init__(self, config: Optional[Dict[str, Any]] = None) -> None:
        super().__init__(config)
        self.engine: Optional[TorchEngine] = None
        self.serving: Optional[BatcherServing] = None
        # the standalone tree decoder (engine: jax-speculative), else None
        self._spec: Optional[SpeculativeDecoder] = None
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
        # cache-aware routing: bounded hot set of prefix boundary
        # fingerprints (runtime/prefix_summary.py) — rides heartbeats as
        # this worker's radix summary so the control plane can route
        # prefix-sharing requests back here; 0 disables the channel
        top_n = int(self.config.get("prefix_summary_top_n", 128) or 0)
        self.prefix_hot: Optional[PrefixHotSet] = (
            PrefixHotSet(top_n) if top_n > 0 else None
        )
        self._prefix_evictions_seen = 0
        # flight recorder: cumulative counters + a bounded ring of recent
        # timelines (direct streams ship theirs only through the heartbeat)
        self.flight_stats: Dict[str, int] = {
            "timelines": 0, "events_dropped": 0,
        }
        self._flight_recent: Any = collections.deque(maxlen=8)

    # -- lifecycle -----------------------------------------------------------

    def _refuse_unported(self, sv: Dict[str, Any]) -> None:
        """EngineLoadError naming each configured key whose path this port
        does not have."""
        for key, what in _UNPORTED_CONFIG.items():
            if self.config.get(key):
                raise EngineLoadError(
                    f"{key} ({what}) is not in the PyTorch port"
                )
        if int(self.config.get("spec_distill_steps") or 0) > 0:
            raise EngineLoadError(
                f"spec_distill_steps={self.config['spec_distill_steps']}: "
                "speculative draft distillation (training, with optax) is not "
                "in the PyTorch port; serve a random or given draft head"
            )
        tp = int(self.config.get("tp_size")
                 or (self.config.get("extra") or {}).get("tp_size") or 1)
        if tp > 1:
            raise EngineLoadError(
                f"extra.tp_size={tp}: tensor parallelism is not in the "
                "PyTorch port (one card)"
            )
        if sv.get("mode") != "batcher":
            raise EngineLoadError(
                f"serving.mode: {sv.get('mode')!r}: the PyTorch port serves "
                "through its batcher only (mode: batcher)"
            )

    def load_model(self) -> None:
        model_name = self.config.get("model", "llama3-mini")
        sv = self._serving_config()
        self._refuse_unported(sv)
        if self.tokenizer is None:
            self.tokenizer = ByteTokenizer()
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
            # the spill tiers: a host-RAM L2 block budget and an optional
            # L3 store from a URL (redis://host:port/db over
            # runtime/redis_kv.py, memory:// in process)
            spill_host_blocks=int(self.config.get("kv_spill_host_blocks") or 0),
            spill_remote_store=remote_store_from_url(
                self.config.get("kv_remote_url"),
                ttl_s=float(self.config.get("kv_remote_ttl_s") or 3600.0),
            ),
            num_blocks=(int(self.config["num_blocks"])
                        if self.config.get("num_blocks") else None),
        )
        if self.config.get("prefill_buckets"):
            eng_cfg.prefill_buckets = tuple(
                sorted(int(w) for w in self.config["prefill_buckets"])
            )
        if sv.get("ragged_chunk"):
            eng_cfg.ragged_chunk = int(sv["ragged_chunk"])
        standalone = self.config.get("engine") in ("jax-speculative", "speculative")
        if self.config.get("speculative_decode"):
            # engine-integrated: every round drafts, verifies and commits
            # 1..K+1 tokens a slot; greedy outputs unchanged
            try:
                oracle = self.config.get("spec_oracle_accept")
                eng_cfg.speculative = SpecDecodeConfig(
                    num_draft_tokens=int(self.config.get("spec_num_draft_tokens", 4)),
                    adaptive=bool(self.config.get("spec_adaptive", False)),
                    adaptive_min_k=int(self.config.get("spec_adaptive_min_k", 1)),
                    oracle_accept_rate=None if oracle is None else float(oracle),
                )
                eng_cfg.speculative.validate(eng_cfg)
            except (ValueError, TypeError) as exc:
                raise EngineLoadError(
                    f"speculative_decode config invalid: {exc}"
                ) from exc
            if standalone:
                raise EngineLoadError(
                    "speculative_decode (engine-integrated) and "
                    "engine=jax-speculative (standalone tree decoder) are "
                    "mutually exclusive — pick one"
                )
        try:
            self.engine = TorchEngine(
                model_name,
                eng_cfg,
                params=self.config.get("params"),
                seed=int(self.config.get("seed", 0)),
                device=self.config.get("device", "cuda"),
            )
        except BaseException as exc:
            store = eng_cfg.spill_remote_store
            if store is not None and hasattr(store, "close"):
                store.close()      # its writer thread would outlive the load
            if isinstance(exc, (ValueError, KeyError, NotImplementedError)):
                raise EngineLoadError(str(exc)) from exc
            raise
        if standalone:
            self._spec = self._standalone_decoder(model_name, eng_cfg)
        try:
            self.serving = BatcherServing(self.engine, self._batcher_config(sv),
                                          spec=self._spec)
        except (ValueError, RuntimeError) as exc:
            raise EngineLoadError(
                f"batcher serving config invalid: {exc}"
            ) from exc
        self.loaded = True

    def _standalone_decoder(self, model_name: str,
                            eng_cfg: EngineConfig) -> SpeculativeDecoder:
        """``engine: jax-speculative``: the tree decoder over the engine's
        target weights, its pool sized to one batch's worst case."""
        try:
            raw_w = self.config.get("spec_widths") or (4, 2, 2)
            if isinstance(raw_w, str):          # CLI/env: "4,2,2"
                raw_w = [p for p in raw_w.split(",") if p.strip()]
            widths = tuple(int(w) for w in raw_w)
            if not widths or any(w < 1 for w in widths):
                raise ValueError(f"invalid spec_widths {widths}")
            blocks_per_seq = -(-eng_cfg.max_seq_len // eng_cfg.block_size)
            return SpeculativeDecoder(
                model_name,
                params=self.engine.params,
                spec_cfg=SpeculativeConfig(widths=widths),
                max_batch_size=eng_cfg.max_batch_size,
                max_seq_len=eng_cfg.max_seq_len,
                num_blocks=eng_cfg.max_batch_size * blocks_per_seq + 2,
                prefill_buckets=eng_cfg.prefill_buckets,
                device=self.engine.device,
            )
        except (ValueError, TypeError) as exc:
            raise EngineLoadError(
                f"speculative engine config invalid: {exc}"
            ) from exc

    def _serving_config(self) -> Dict[str, Any]:
        """Merged serving knobs: defaults < ``config['serving']`` (worker
        config ``engines.llm.serving.*``) < ``extra['serving']``."""
        out = dict(SERVING_DEFAULTS)
        for src in (self.config.get("serving"),
                    (self.config.get("extra") or {}).get("serving")):
            if isinstance(src, dict):
                # plain-dict construction bypasses the config loader, so
                # the obsoleted-knob warning fires here too — only for
                # values that differ from the defaults
                for k, v in src.items():
                    if v is not None and v != SERVING_DEFAULTS.get(k):
                        warn_deprecated_serving_key(k, "engine serving config")
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
            spec_max_batch=int(sv["spec_max_batch"]),
            spec_max_active=int(sv["spec_max_active"]),
            ragged=(None if sv.get("ragged") is None
                    else bool(sv["ragged"])),
            prefill_budget=int(sv.get("prefill_budget") or 0),
            abandon_deadlines=_truthy(sv.get("abandon_deadlines")),
            deadline_grace_s=float(sv.get("deadline_grace_s") or 0.5),
            predictive_abandon=_truthy(sv.get("predictive_abandon")),
        )

    def apply_serving_config(self, updates: Optional[Dict[str, Any]]) -> None:
        """Server-pushed SLO retune (remote config ``serving`` section),
        applied to the LIVE batcher between rounds. Load-time knobs
        (``mode``, ``subwave``, ``interleave``) are not remote keys."""
        if self.serving is None or not updates:
            return
        kw = {
            SERVING_REMOTE_KEYS[k]: v
            for k, v in updates.items()
            if k in SERVING_REMOTE_KEYS and v is not None
        }
        if kw:
            self.serving.reconfigure(**kw)

    def serving_stats(self) -> Optional[Dict[str, Any]]:
        """Live batcher stats (occupancy, queue depth, counters) — ride the
        worker heartbeat. None when no batcher is serving."""
        if self.serving is None or not self.serving.active:
            return None
        return self.serving.get_stats()

    def prefix_summary_wire(self) -> Optional[Dict[str, Any]]:
        """Next heartbeat radix-summary payload (full snapshot or delta —
        ``runtime/prefix_summary.py`` wire format), or None when the control
        plane is up to date. Before encoding, cold entries are demoted in
        proportion to pool evictions since the last wire: to the spill tier
        the evicted blocks landed in (host first: spills write through L2
        and probes hit it first), or dropped when there is no spill tier —
        evicted KV is then gone."""
        hot = self.prefix_hot   # snapshot vs a concurrent disable()
        if hot is None:
            return None
        eng = self.engine
        if eng is not None:
            mgr = eng.manager
            ev = int(mgr.stats.evictions or 0)
            delta = ev - self._prefix_evictions_seen
            if delta > 0 and len(hot):
                frac = min(1.0, delta / len(hot))
                if mgr.spill_on_evict:
                    hot.demote(frac, tier=(TIER_HOST if mgr.host_store is not None
                                           else TIER_SPILL))
                else:
                    hot.drop(frac)
            self._prefix_evictions_seen = ev
        return hot.wire()

    def prefix_summary_ack(self) -> None:
        hot = self.prefix_hot
        if hot is not None:
            hot.ack()

    def prefix_summary_resync(self) -> None:
        hot = self.prefix_hot
        if hot is not None:
            hot.resync()

    def prefix_summary_disable(self) -> None:
        """The control plane statically rejected our summaries (wire
        version / fingerprint-basis skew): stop shipping them."""
        self.prefix_hot = None

    def unload(self) -> None:
        """Stop serving, close the remote spill store's connections and
        writer, and hand the device memory back (a worker restarted in the
        same process loads its engine again)."""
        if self.serving is not None:
            self.serving.stop(drain=False)
            self.serving = None
        store = (self.engine.cfg.spill_remote_store
                 if self.engine is not None else None)
        if store is not None and hasattr(store, "close"):
            store.close()
        device = self.engine.device if self.engine is not None else None
        self.engine = None
        self._spec = None
        self._prefix_evictions_seen = 0
        super().unload()
        if device is not None and device.type == "cuda":
            import gc

            import torch

            gc.collect()
            torch.cuda.empty_cache()

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
        hot = self.prefix_hot   # snapshot: the heartbeat thread may
        if hot is not None and \
                self.engine.cfg.enable_prefix_cache:  # disable() to None
            # every built request's prefix is radix-cached on completion:
            # note its boundary fingerprints for the heartbeat summary
            # (advisory; one pass over the prefix)
            hot.note_fingerprints(prefix_fingerprints(
                canonical_prompt_text(prompt_or_messages),
                hot.block_chars, hot.max_blocks,
            ))
        return InferenceRequest(
            prompt_token_ids=self._encode_prompt(prompt_or_messages, cfg),
            sampling=self._sampling_from(cfg),
            deadline_s=cfg.deadline_s,
        )

    def _params_request(self, params: Dict[str, Any],
                        cfg: GenerationConfig) -> InferenceRequest:
        """The request of a job's or a stream's params (prompt or chat
        messages, priority, the ``speculative: false`` opt-out of the
        standalone tree decoder)."""
        req = self._build_request(
            params.get("messages") or params.get("prompt") or "", cfg,
        )
        if params.get("priority") is not None:
            req.priority = int(params.get("priority") or 0)
        if params.get("speculative") is False:
            req.params["speculative"] = False
        return req

    def inference(self, params: Dict[str, Any]) -> Dict[str, Any]:
        if params.get("pd_stage") is not None:
            raise ServingError(
                "prefill/decode hand-off stages are not ported yet",
                error_code="unsupported",
            )
        if self.serving is None or not self.serving.active:
            raise EngineLoadError("engine not loaded")
        # flight recorder: the request's Timeline is minted here and rides
        # params to the serving path that closes it
        tl = self._flight_timeline(params)
        if tl.enabled:
            params["_flight_tl"] = tl
        ctx = params.get("_failover_ctx")
        if isinstance(ctx, dict):
            return self._job_inference(params, ctx)
        return self._serving_inference(params)

    def _serving_inference(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Blocking request through the batcher front end: concurrent
        callers share engine rounds via slot-level continuous batching."""
        cfg = GenerationConfig.from_params(params)
        tl = params.pop("_flight_tl", NULL_TIMELINE)
        tl.note("worker.start", path="serving")
        req = self._params_request(params, cfg)
        # hedged dispatch: the direct server mints a cancel event for a
        # request that carries a hedge key — the losing racer is aborted at
        # the batcher's next step boundary (partial output with
        # finish_reason="abort", never an error)
        cancel = params.pop("_cancel_evt", None)
        t0 = time.perf_counter()
        resp = self.serving.submit(req, cancel=cancel,
                                   flight=tl if tl.enabled else None)
        if resp.error is not None:
            _raise_serving(resp)
        tl.note("worker.done")
        payload = self._finish_payload(
            list(resp.token_ids), resp.prompt_tokens, resp.cached_tokens,
            resp.finish_reason or "stop", cfg, resp.ttft_ms,
            time.perf_counter() - t0,
        )
        self._flight_finish(tl, payload)
        return payload

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
        tl = self._flight_timeline(params)
        if tl.enabled:
            params["_flight_tl"] = tl
        return self._stream_serving(params, cancel=cancel)

    def _stream_serving(self, params: Dict[str, Any],
                        cancel: Optional[Any] = None):
        """Batcher-backed token streaming: the request is submitted with a
        per-round observer; deltas are derived from the observer's
        monotonic token snapshots by :class:`_StreamSplicer`, so
        exactly-once token offsets and checkpoint/resume hold while the
        sequence shares rounds with other slots."""
        cfg = GenerationConfig.from_params(params)
        tl = params.pop("_flight_tl", NULL_TIMELINE)
        tl.note("worker.stream.start")
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
        # spec waves buffer whole generations: a stream needs per-round
        # progress, so it always decodes through the paged slots
        req.params["speculative"] = False
        request_id = req.request_id
        live_info = {"kind": "stream", "epoch": epoch,
                     "request_id": request_id}

        snaps: "_queue_mod.Queue" = _queue_mod.Queue()
        _DONE = object()
        stop_evt = threading.Event()   # batcher-side abort (cancel / stop cut)
        fut = self.serving.submit_async(
            req, observer=lambda toks: snaps.put(toks),
            cancel=stop_evt, resume_from=pre,
            flight=tl if tl.enabled else None,
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
        tl.note("worker.stream.done", finish_reason=finish)
        done_chunk = {
            "done": True,
            "finish_reason": finish,
            "usage": {
                "prompt_tokens": final.prompt_tokens,
                "completion_tokens": final.completion_tokens,
                "total_tokens": final.prompt_tokens
                + final.completion_tokens,
                "cached_tokens": final.cached_tokens,
            },
        }
        # the final chunk carries the worker-side timeline (streams never
        # pass complete_job); the heartbeat ring ships it too
        self._flight_finish(tl, done_chunk)
        yield stamp(done_chunk, sp.sent_tokens)
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

    def kv_spill_wire_stats(self) -> Optional[Dict[str, int]]:
        """Cumulative spill-tier IO health counters (put/get errors,
        corrupt-entry quarantines, breaker states and trips), remote entries
        this process could not decode (``remote_undecodable``) and refused
        corrupt checkpoints — heartbeat ``engine_stats["kv_spill"]``. None
        while every counter is zero and every breaker closed."""
        eng = self.engine
        out: Dict[str, int] = {}
        if eng is not None:
            ws = eng.manager.spill_wire_stats()
            out.update({k: int(v) for k, v in ws.items() if v})
            if out:
                # once anything has fired, ship breaker states INCLUDING
                # zeros: a recovered breaker must drive the plane's gauge
                # back to healthy
                out.update({k: int(v) for k, v in ws.items()
                            if k.endswith("_state")})
            if eng.manager.codec_misses:
                out["remote_undecodable"] = int(eng.manager.codec_misses)
        if self.ckpt_corrupt:
            out["ckpt_corrupt"] = int(self.ckpt_corrupt)
        return out or None

    # -- request flight recorder ----------------------------------------------

    def _flight_timeline(self, params: Dict[str, Any]) -> Any:
        """A Timeline for the request iff it carries a ``trace_id`` (the
        shared no-op NULL_TIMELINE otherwise). Adopts the poll-pickup
        instant the worker stamped into params before dispatch."""
        tl = timeline_for(
            params, source=str(getattr(self, "fault_tag", "") or "")
        )
        ts = params.pop("_flight_picked_up_ts", None)
        if ts is not None and tl.enabled:
            tl.note_at("worker.picked_up", ts)
        return tl

    def _flight_finish(self, tl: Any,
                       payload: Optional[Dict[str, Any]] = None) -> None:
        """Close one request's timeline: count it, keep it in the bounded
        heartbeat ring, and attach the wire to the result payload when one
        is given. Never raises — the recorder is advisory."""
        try:
            if not getattr(tl, "enabled", False):
                return
            wire = tl.wire(done=True)
            if wire is None:
                return
            self.flight_stats["timelines"] += 1
            if tl.dropped:
                self.flight_stats["events_dropped"] += int(tl.dropped)
            self._flight_recent.append(wire)
            if payload is not None:
                payload["timeline"] = wire
        except Exception:  # noqa: BLE001 — never fail a request for this
            pass

    def flight_wire_stats(self) -> Optional[Dict[str, Any]]:
        """Heartbeat ``engine_stats["flight"]``: cumulative counters plus
        the ring of recently completed timelines (re-shipped every beat; the
        plane's merge is idempotent). None while nothing was traced."""
        if not self.flight_stats["timelines"]:
            return None
        return {
            "timelines": int(self.flight_stats["timelines"]),
            "events_dropped": int(self.flight_stats["events_dropped"]),
            "recent": list(self._flight_recent),
        }

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
        tl = params.pop("_flight_tl", NULL_TIMELINE)
        tl.note("worker.start", path="job_serving")
        pre = self._ckpt_from_wire(ctx.get("checkpoint"))
        if pre is not None:
            tl.note("worker.resume_from_checkpoint",
                    tokens=len(pre.generated))
            if pre.request.sampling.max_new_tokens - len(pre.generated) <= 0:
                # the checkpoint already holds the whole generation: the
                # previous worker died between its last decode and its
                # completion — deliver without touching the engine
                payload = self._finish_payload(
                    list(pre.generated), pre.prompt_len,
                    pre.cached_tokens, "length", cfg, None,
                    time.perf_counter() - t0,
                )
                self._flight_finish(tl, payload)
                return payload
            req = pre.request
        else:
            req = self._params_request(params, cfg)
        # a FRESH greedy job keeps the standalone tree decoder's speedup by
        # waiving the failover hooks (a spec wave is neither interruptible
        # nor checkpointable: a drain finishes it, a crash replays it)
        spec_fast = (pre is None and self._spec is not None
                     and cfg.temperature <= 0.0
                     and params.get("speculative") is not False)
        if not spec_fast:
            self._register_live(key, "job", epoch, req.request_id)
        try:
            resp = self.serving.submit(
                req, resume_from=pre,
                interrupt=None if spec_fast else self._interrupt,
                flight=tl if tl.enabled else None)
        except RequestMigrated as mig:
            raise JobMigrated(mig.pre.to_wire(),
                              tokens=len(mig.pre.generated)) from None
        finally:
            if not spec_fast:
                self._unregister_live(key)
        if resp.error is not None:
            _raise_serving(resp)
        tl.note("worker.done")
        payload = self._finish_payload(
            list(resp.token_ids), resp.prompt_tokens, resp.cached_tokens,
            resp.finish_reason or "stop", cfg, resp.ttft_ms,
            time.perf_counter() - t0,
        )
        self._flight_finish(tl, payload)
        return payload

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
