"""The worker's LLM engine on PyTorch: tokenizer + ``TorchEngine`` behind
the continuous batcher, or driven directly.

The port of ``distributed_gpu_inference_tpu/worker/engines/llm.py``
``TPULLMEngine`` for the paths the worker process and the direct server
drive. ``load_model`` builds a :class:`TorchEngine` and, with
``serving.mode: batcher`` (the default), a :class:`BatcherServing` front
end through which every request goes, so concurrent callers share engine
rounds through slot-level continuous batching. With ``serving.mode:
direct`` there is no batcher (``self.serving is None``): every
engine-touching path runs under ``_engine_lock`` and drives the engine
itself, one request at a time, as the JAX worker's direct mode does — the
blocking ``generate`` (``_generate``), the interruptible queued-job loop
over ``decode_multi``, the per-step stream over ``decode_step`` (or
``spec_decode_step``), ``batch_inference`` through ``generate`` and the PD
decode loop over an adopted slot. ``serving.subwave`` /
``serving.interleave`` (load-time) set the engine's sub-wave admission
(``EngineConfig.admission_subwave`` / ``admission_interleave_steps``),
which the legacy path's ``submit_batch`` runs (``serving.ragged: false``,
or direct mode). In either mode:

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
rather than ignoring it: a ``serving.mode`` other than ``batcher`` or
``direct``, and under ``tp_size`` > 1 speculative decoding. PD roles,
KV handoff, the spill tiers and ``kv_migrate`` (on by default, as in the
JAX worker) serve under ``tp_size`` > 1: the engine gathers and scatters
each rank's heads of a page (``TorchEngine.gather_pages`` /
``push_pages``).
``spec_distill_steps`` > 0 with ``speculative_decode`` distils the draft head against the target at load, before the batcher
starts (``TorchEngine.distill_draft``); the per-step losses are kept in
``distill_losses``.

Weights and tokenizer from local files: ``checkpoint_path`` names an HF
safetensors directory that ``TorchEngine`` loads onto the card, quantized
slice by slice as it is read when ``quantization`` is set
(``models/loader.py``); an orbax directory is JAX-only and refused.
``tokenizer_id`` names a local directory whose ``tokenizer.json`` /
``tokenizer_config.json`` / chat template ``utils/hf_tokenizer.py`` reads
(byte-level BPE: Llama 3, Qwen 2.5, GPT-2); a hub id, or a tokenizer this
reader does not have, raises :class:`EngineLoadError` naming the key. No
path falls back: not to ``ByteTokenizer`` (used only when neither
``tokenizer`` nor ``tokenizer_id`` is given), not to joined messages, not
to random weights.

Prefill/decode disaggregation and cluster KV migration
(``runtime/kv_handoff.py``, the data plane in ``comm/data_plane.py``):

- ``pd_stage: prefill`` prefills, samples the first token and pushes the
  KV to ``decode_url``'s ``/kv/transfer`` — streamed by default
  (``pd_stream``, ``pd_stream_piece_blocks``), one blob otherwise — over
  ``http.client`` with a per-piece timeout (``pd_push_timeout_s``) and a
  full-jitter retry ladder (``pd_push_retries``, ``pd_push_backoff_s``;
  no retry on a 4xx); when this worker is also the decode target the slot
  is retained under the key;
- ``kv_receiver`` (the data plane's ``/kv/transfer``) adopts pushed KV;
  ``pd_stage: decode`` drives the adopted slot through
  ``BatcherServing.adopt_slot``; adoptions never claimed age out after
  ``pd_slot_ttl_s`` (``pd_maintain``, on the heartbeat cadence);
- a router ``kv_migrate_from`` hint pulls a hot prefix from a peer's
  ``/kv/export`` before admission, and ``kv_replicate`` pulls the
  heartbeat's hints in the background (``kv_migrate``,
  ``kv_migrate_max_blocks``, ``kv_migrate_pull_timeout_s``,
  ``kv_migrate_budget``, ``kv_migrate_backoff_s``); ``kv_export`` serves
  peers' pulls;
- ``pd_wire_stats`` / ``kv_migrate_wire_stats`` /
  ``handoff_sessions_purged`` feed the worker's heartbeat blocks.

All engine work of these paths runs on the batcher's executor
(``run_exclusive``), or in direct mode under ``_engine_lock``: a data-plane
thread never touches the device beside a running request.
"""

from __future__ import annotations

import asyncio
import collections
import queue as _queue_mod
import random
import threading
import time
import uuid
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

from distributed_gpu_inference_torch.comm.data_plane import (
    TRANSPORT_ERRORS,
    HTTPPoster,
    HTTPStatusError,
    post_bytes,
)
from distributed_gpu_inference_torch.parallel.mesh import rank_devices
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
from distributed_gpu_inference_torch.runtime.kv_cache import OutOfBlocksError
from distributed_gpu_inference_torch.runtime.speculative import (
    SpecDecodeConfig,
    SpeculativeConfig,
    SpeculativeDecoder,
)
from distributed_gpu_inference_torch.runtime.kv_handoff import (
    HandoffReceiver,
    StreamedExport,
    abort_message,
    export_prefix_frames,
    export_slot_kv,
    message_kind,
    pack_export_request,
    serialize_handoff,
    split_frames,
    unpack_export_request,
    _frame_blobs,
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
from distributed_gpu_inference_torch.runtime.tp import RankFailed
from distributed_gpu_inference_torch.testing import faults as _faults
from distributed_gpu_inference_torch.utils.backoff import full_jitter_delay
from distributed_gpu_inference_torch.utils.config import (
    ServingConfig,
    config_dict,
    warn_deprecated_serving_key,
)
from distributed_gpu_inference_torch.utils.data_structures import (
    InferenceRequest,
    InferenceResponse,
    SamplingParams,
)
from distributed_gpu_inference_torch.utils.hf_tokenizer import HFTokenizer
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

# ``serving.mode``: through the batcher, or the engine driven directly
SERVING_MODES = ("batcher", "direct")


def _truthy(value: Any) -> bool:
    """A pushed or configured flag: strings by content (bool("false") is
    True)."""
    if isinstance(value, str):
        return value.strip().lower() in ("1", "true", "yes", "on", "t", "y")
    return bool(value)


def _load_hf_tokenizer(tokenizer_id: str) -> HFTokenizer:
    """The tokenizer of a local directory. The JAX engine calls
    ``AutoTokenizer.from_pretrained``, which may download; the port reads
    only local files, and anything it cannot load raises."""
    if not Path(tokenizer_id).is_dir():
        raise EngineLoadError(
            f"cannot load tokenizer {tokenizer_id!r} (tokenizer_id): not a local "
            "directory; the PyTorch port reads tokenizer.json from a local directory "
            "and downloads nothing")
    try:
        return HFTokenizer.from_dir(tokenizer_id)
    except (OSError, ValueError, KeyError) as exc:
        raise EngineLoadError(
            f"cannot load tokenizer {tokenizer_id!r} (tokenizer_id): {exc}") from exc


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
    """config keys: model (name in the models/configs registry), tokenizer
    (an object with encode/decode) or tokenizer_id (a local tokenizer
    directory), checkpoint_path (a local HF safetensors directory; both
    also under ``extra``, which wins), max_batch_size, max_seq_len,
    multi_step, enable_prefix_cache, prefill_buckets, num_blocks, dtype,
    quantization (int8 | fp8 weight-only, ``ops/quantization.py``),
    kv_cache_dtype (int8 | fp8 | None = dtype), kv_spill_host_blocks (the
    host-RAM L2 tier, 0 = none), kv_remote_url (the L3 tier:
    ``redis://host:port/db`` or ``memory://``), kv_remote_ttl_s, device
    (default ``cuda``), seed, params (a params tree already on the device,
    e.g. from ``models.convert.params_from_numpy``; random init from
    ``seed`` when neither it nor checkpoint_path is given),
    checkpoint_interval_tokens (the stream checkpoint cadence, 0 = the
    admission checkpoint only), prefix_summary_top_n (the radix summary's
    size, 0 = no summary), the ``serving`` knobs of
    :data:`SERVING_DEFAULTS` (also under ``extra``, which wins), the
    worker's ``engine`` and ``extra.tp_size``, and the PD and KV-migration
    keys of the module docstring (``pd_*``, ``kv_migrate*``)."""

    task_type = "llm"
    # the caller injects a ``_failover_ctx`` (job or stream key, assignment
    # epoch, server-held checkpoint) only into engines that advertise this
    supports_failover = True

    def __init__(self, config: Optional[Dict[str, Any]] = None) -> None:
        super().__init__(config)
        self.engine: Optional[TorchEngine] = None
        # spec_distill_steps: the distillation's per-step losses (host f32)
        self.distill_losses: Optional[Any] = None
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
        # PD disaggregation: kv_cache_key → (slot, seq, adopted_at) of an
        # adopted (or locally retained) sequence awaiting its decode stage;
        # ``seq`` identity-guards late frees (slot indices recycle) and
        # ``adopted_at`` drives the pd_slot_ttl_s purge
        self._pd_slots: Dict[str, tuple] = {}
        self.pd_slot_ttl_s = float(self.config.get("pd_slot_ttl_s", 180.0) or 180.0)
        # sender/receiver handoff lifecycle counters (heartbeat "pd")
        self.pd_stats: Dict[str, int] = {
            "handoffs_committed": 0,
            "handoffs_failed": 0,
            "handoffs_aborted": 0,
            "handoffs_local": 0,
            "handoff_bytes": 0,
            "piece_retries": 0,
            "adopted_expired": 0,
        }
        # per-piece push: timeout and a full-jitter retry ladder
        self._pd_push_timeout_s = float(self.config.get("pd_push_timeout_s", 30.0) or 30.0)
        self._pd_push_retries = int(self.config.get("pd_push_retries", 3) or 0)
        self._pd_push_backoff_s = float(self.config.get("pd_push_backoff_s", 0.2) or 0.2)
        self._pd_rng = random.Random(0x9D5)
        # serializes the PD bookkeeping (adoption index, the receiver's
        # sessions) between the job path and the data plane's threads; the
        # engine work itself runs on the batcher's executor
        self._engine_lock = threading.Lock()
        self._handoff_rx: Optional[HandoffReceiver] = None
        # cluster KV migration: pull a hot prefix from a peer's /kv/export
        # instead of re-prefilling, and serve peers' pulls (radix + spill
        # tiers); whether a request migrates is the router's decision
        self.kv_migrate_enabled = bool(self.config.get("kv_migrate", True))
        self._kvmig_max_blocks = int(self.config.get("kv_migrate_max_blocks", 64) or 64)
        self._kvmig_timeout_s = float(
            self.config.get("kv_migrate_pull_timeout_s", 20.0) or 20.0)
        # concurrent pulls beyond the budget recompute instead
        self._kvmig_budget = int(self.config.get("kv_migrate_budget", 2) or 2)
        self._kvmig_backoff_s = float(self.config.get("kv_migrate_backoff_s", 1.0) or 1.0)
        self._kvmig_lock = threading.Lock()
        self._kvmig_inflight = 0
        # peer url → (consecutive failures, monotonic deadline)
        self._kvmig_backoff: Dict[str, tuple] = {}
        self._kvmig_rng = random.Random(0x5CAF)
        # cumulative counters (heartbeat "kv_migrate")
        self.kv_migrate_stats: Dict[str, int] = {
            "pulled": 0, "fallback_recompute": 0, "aborted": 0,
            "local_hits": 0,
            "pull_bytes": 0, "pull_blocks": 0,
            "exports": 0, "export_bytes": 0,
            "replicated": 0, "replicate_miss": 0, "replicate_aborted": 0,
        }
        # fingerprint → prompt token ids, for fingerprint-keyed exports (a
        # plane-hinted puller knows only the fingerprint); bounded LRU
        self._kvmig_fp_tokens: "collections.OrderedDict[str, List[int]]" = \
            collections.OrderedDict()
        self._kvmig_fp_cap = 512

    # -- lifecycle -----------------------------------------------------------

    def _refuse_unported(self, sv: Dict[str, Any]) -> None:
        """EngineLoadError naming each configured key whose path this port
        does not have: refused at load when set, never ignored."""
        if sv.get("mode") not in SERVING_MODES:
            raise EngineLoadError(
                f"serving.mode: {sv.get('mode')!r} is not a serving mode; use "
                f"one of {list(SERVING_MODES)}"
            )

    def _tp_devices(self) -> Optional[List[Any]]:
        """``tp_size`` (top level or under ``extra``) > 1: the ranks'
        devices, one local card each (the JAX worker's rule: no more ranks
        than local devices; the CPU when ``device: cpu``), after refusing
        by name what the tensor-parallel slice does not take. None for one
        device."""
        tp = int(self.config.get("tp_size")
                 or (self.config.get("extra") or {}).get("tp_size") or 1)
        if tp <= 1:
            return None
        devices = rank_devices(self.config.get("device", "cuda"), tp)
        if devices is None:
            import torch

            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise EngineLoadError(f"tp_size={tp} but only {have} local devices")
        if self.config.get("speculative_decode"):
            raise EngineLoadError(
                f"speculative_decode is not supported under tensor parallelism "
                f"(tp_size={tp}): speculative decoding is single-chip")
        if self.config.get("engine") in ("jax-speculative", "speculative"):
            raise EngineLoadError(
                f"engine={self.config['engine']} is not supported under tensor "
                f"parallelism (tp_size={tp}): speculative decoding is single-chip")
        return devices

    def _local_file_key(self, key: str) -> Optional[str]:
        """``checkpoint_path`` / ``tokenizer_id``: a top-level key, or one
        under ``extra`` (which wins), where a worker config puts keys its
        engine section has no field for."""
        return (self.config.get("extra") or {}).get(key) or self.config.get(key)

    def load_model(self) -> None:
        model_name = self.config.get("model", "llama3-mini")
        sv = self._serving_config()
        self._refuse_unported(sv)
        tp_devices = self._tp_devices()
        if self.tokenizer is None:
            tok_id = self._local_file_key("tokenizer_id")
            self.tokenizer = _load_hf_tokenizer(tok_id) if tok_id else ByteTokenizer()
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
            # sub-wave admission of the legacy path (load-time only)
            admission_subwave=int(sv["subwave"]),
            admission_interleave_steps=int(sv["interleave"]),
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
                checkpoint_path=self._local_file_key("checkpoint_path"),
                rank_devices=tp_devices,
            )
        except BaseException as exc:
            store = eng_cfg.spill_remote_store
            if store is not None and hasattr(store, "close"):
                store.close()      # its writer thread would outlive the load
            if isinstance(exc, (ValueError, KeyError, NotImplementedError, OSError,
                                RankFailed)):
                raise EngineLoadError(str(exc)) from exc
            raise
        distill_steps = int(self.config.get("spec_distill_steps") or 0)
        if eng_cfg.speculative is not None and distill_steps > 0:
            # on-load draft distillation against the engine's own target
            # weights, before the batcher exists: a random head is correct
            # but accepts ~nothing, so a failure here drops the task type
            try:
                self.distill_losses = self.engine.distill_draft(steps=distill_steps)
            except Exception as exc:  # noqa: BLE001 — OOM, bad weights, ...
                self.engine = None
                store = eng_cfg.spill_remote_store
                if store is not None and hasattr(store, "close"):
                    store.close()
                raise EngineLoadError(
                    f"speculative draft distillation failed: {exc}"
                ) from exc
        if standalone:
            self._spec = self._standalone_decoder(model_name, eng_cfg)
        if sv["mode"] == "batcher":
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
        applied to the LIVE batcher between rounds; a no-op in direct mode.
        Load-time knobs (``mode``, ``subwave``, ``interleave``) are not
        remote keys."""
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
        worker heartbeat. None when no batcher is serving (direct mode)."""
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
        same process loads its engine again). The batcher's stop waits out
        the round in flight, and the card is synchronized before the
        engine's tensors are dropped, so no device work outlives it."""
        if self.serving is not None:
            self.serving.stop(drain=False)
            self.serving = None
        store = (self.engine.cfg.spill_remote_store
                 if self.engine is not None else None)
        if store is not None and hasattr(store, "close"):
            store.close()
        device = self.engine.device if self.engine is not None else None
        if self.engine is not None:
            self.engine.shutdown()      # stops the tensor-parallel ranks
        self.engine = None
        self._spec = None
        self._handoff_rx = None
        self._pd_slots.clear()
        self._prefix_evictions_seen = 0
        super().unload()
        if device is not None and device.type == "cuda":
            import gc

            import torch

            torch.cuda.synchronize(device)
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
                       cfg: GenerationConfig,
                       token_ids: Optional[List[int]] = None) -> InferenceRequest:
        """``token_ids``: the prompt already encoded (the KV-migration pull
        encoded these inputs)."""
        if not self.loaded or self.engine is None:
            raise EngineLoadError("engine not loaded")
        hot = self.prefix_hot   # snapshot: the heartbeat thread may
        if hot is not None and \
                self.engine.cfg.enable_prefix_cache:  # disable() to None
            # every built request's prefix is radix-cached on completion:
            # note its boundary fingerprints for the heartbeat summary
            # (advisory; one pass over the prefix)
            fps = prefix_fingerprints(
                canonical_prompt_text(prompt_or_messages),
                hot.block_chars, hot.max_blocks,
            )
            hot.note_fingerprints(fps)
            if fps and self.kv_migrate_enabled:
                if token_ids is None:
                    token_ids = self._encode_prompt(prompt_or_messages, cfg)
                # fingerprint-keyed exports resolve each boundary of this
                # prompt back to its token ids (one shared list)
                with self._kvmig_lock:
                    for fp in fps:
                        self._kvmig_fp_tokens[fp] = token_ids
                        self._kvmig_fp_tokens.move_to_end(fp)
                    while len(self._kvmig_fp_tokens) > self._kvmig_fp_cap:
                        self._kvmig_fp_tokens.popitem(last=False)
        if token_ids is None:
            token_ids = self._encode_prompt(prompt_or_messages, cfg)
        return InferenceRequest(
            prompt_token_ids=token_ids,
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
            token_ids=params.pop("_kvmig_token_ids", None),
        )
        if params.get("priority") is not None:
            req.priority = int(params.get("priority") or 0)
        if params.get("speculative") is False:
            req.params["speculative"] = False
        return req

    @property
    def _direct(self) -> bool:
        """Loaded in ``serving.mode: direct``: no batcher, the engine is
        driven under ``_engine_lock``."""
        return self.loaded and self.engine is not None and self.serving is None

    def _require_serving(self) -> None:
        """Raise unless a batcher serves or the engine is loaded direct."""
        if not self._direct and (self.serving is None or not self.serving.active):
            raise EngineLoadError("engine not loaded")

    def inference(self, params: Dict[str, Any]) -> Dict[str, Any]:
        stage = params.get("pd_stage")
        if stage == "prefill":
            return self.pd_prefill(params)
        self._require_serving()
        if stage == "decode" and not self._direct:
            return self.pd_decode(params)
        # flight recorder: the request's Timeline is minted here and rides
        # params to the serving path that closes it
        tl = self._flight_timeline(params) if stage != "decode" else NULL_TIMELINE
        if tl.enabled:
            params["_flight_tl"] = tl
        if stage is None:
            # router-hinted KV migration: pull the hot prefix from the
            # named peer before admission (never holding the engine lock:
            # the peer's export serializes on ITS engine)
            self._maybe_migrate_kv(params)
        ctx = params.get("_failover_ctx")
        if not self._direct:
            if isinstance(ctx, dict):
                return self._job_inference(params, ctx)
            return self._serving_inference(params)
        # direct mode: the lock covers every engine-touching path — the
        # data plane's kv_receiver adopts handoffs from its own threads
        with self._engine_lock:
            if stage == "decode":
                return self.pd_decode(params)
            if isinstance(ctx, dict):
                return self._job_inference(params, ctx)
            tl = params.pop("_flight_tl", NULL_TIMELINE)
            tl.note("worker.start", path="legacy")
            out = self._legacy_inference(params)
        tl.note("worker.done")
        self._flight_finish(tl, out)
        return out

    def _legacy_inference(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """The blocking legacy path of direct mode (the caller holds the
        engine lock): :meth:`_generate` to its result payload."""
        cfg = GenerationConfig.from_params(params)
        prompt = params.get("messages") or params.get("prompt") or ""
        return self._generate(prompt, cfg).to_result_payload()

    def _generate(self, prompt_or_messages: Any,
                  cfg: GenerationConfig) -> GenerationResult:
        """One request generated to completion by the engine itself
        (``generate`` with multi-step decode), or by the standalone tree
        decoder for a greedy prompt within one prefill bucket (its prefill
        is single-shot)."""
        req = self._build_request(prompt_or_messages, cfg)
        t0 = time.perf_counter()
        use_spec = (
            self._spec is not None
            and cfg.temperature <= 0.0
            and len(req.prompt_token_ids or []) <= self.engine.cfg.prefill_buckets[-1]
        )
        if use_spec:
            resp = self._spec.generate([req])[0]
        else:
            resp = self.engine.generate([req], use_multi_step=True)[0]
        e2e_ms = (time.perf_counter() - t0) * 1000.0
        return self._legacy_result(
            resp, cfg, resp.ttft_ms if resp.ttft_ms is not None else e2e_ms,
            stop_sets_finish=True)

    def _legacy_result(self, resp: InferenceResponse, cfg: GenerationConfig,
                       ttft_ms: Optional[float],
                       stop_sets_finish: bool) -> GenerationResult:
        """A legacy-path response as a result: the text cut at the first
        configured stop string found (not the earliest); the blocking path
        also reports such a cut as ``finish_reason="stop"``, the batch path
        keeps the engine's reason."""
        text = self.tokenizer.decode(resp.token_ids)
        finish = resp.finish_reason or "stop"
        for st in cfg.stop:
            idx = text.find(st)
            if idx >= 0:
                text = text[:idx]
                finish = "stop" if stop_sets_finish else finish
                break
        return GenerationResult(
            text=text,
            prompt_tokens=resp.prompt_tokens,
            completion_tokens=resp.completion_tokens,
            cached_tokens=resp.cached_tokens,
            finish_reason=finish,
            ttft_ms=ttft_ms,
        )

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

    # -- prefill/decode disaggregation (the control plane's pd_flow drives these)

    def _exclusive(self, fn: Callable[[], Any]) -> Any:
        """Run engine work on the batcher's executor thread, between rounds;
        in direct mode run it here (the caller holds ``_engine_lock``, the
        only serialization there is)."""
        if self._direct:
            return fn()
        if self.engine is None or self.serving is None or not self.serving.active:
            raise EngineLoadError("engine not loaded")
        return self.serving.run_exclusive(fn)

    def _pd_push(self, client: Any, url: str, content: bytes) -> Any:
        """POST one handoff message with a per-piece timeout and a bounded
        full-jitter retry ladder (``utils/backoff.py``): a transport error
        or a 5xx retries, a 4xx (the receiver rejected it) raises
        :class:`HTTPStatusError` at once. Begin and commit are idempotent on
        the receiver and re-staging a piece is harmless, so every message
        kind may retry. Retries are counted (``piece_retries``)."""
        kind = message_kind(content)
        attempt = 0
        while True:
            try:
                r = _faults.wrap_http(
                    "worker.pd.push",
                    lambda: client.post(
                        url, content=content,
                        headers={"content-type": "application/octet-stream"},
                        timeout=self._pd_push_timeout_s,
                    ),
                    worker=str(getattr(self, "fault_tag", "") or ""),
                    kind=kind,
                )
                if r.status_code < 400:
                    return r
                if r.status_code < 500:
                    raise HTTPStatusError(r, f"KV push {kind}")
                last: Exception = RuntimeError(
                    f"KV push {kind} answered HTTP {r.status_code}: {r.text[:200]}")
            except TRANSPORT_ERRORS as exc:
                last = exc
            if attempt >= self._pd_push_retries:
                raise last
            time.sleep(full_jitter_delay(self._pd_push_backoff_s, attempt,
                                         self._pd_rng) or 0.0)
            attempt += 1
            self.pd_stats["piece_retries"] += 1

    def _purge_stale_pd_slots(self) -> None:
        """Free adopted or retained PD slots whose decode stage never came
        within ``pd_slot_ttl_s``. Pop-to-claim: ``pd_decode`` pops without
        the lock, so the dict pop decides who owns the sequence."""
        if not self._pd_slots:
            return
        now = time.monotonic()
        eng = self.engine
        for key, (slot, seq, adopted_at) in list(self._pd_slots.items()):
            if now - adopted_at <= self.pd_slot_ttl_s:
                continue
            if self._pd_slots.pop(key, None) is None:
                continue
            self.pd_stats["adopted_expired"] += 1
            if eng is not None:
                self._release_adopted_slot(eng, slot, seq)

    def pd_maintain(self) -> None:
        """PD housekeeping on the heartbeat cadence: age out adoptions
        whose decode stage never came. A busy lock skips this beat."""
        if not self._pd_slots or self.engine is None:
            return
        if not self._engine_lock.acquire(blocking=False):
            return
        try:
            self._purge_stale_pd_slots()
        finally:
            self._engine_lock.release()

    def _pd_request(self, params: Dict[str, Any], cfg: GenerationConfig) -> InferenceRequest:
        prompt = params.get("prompt_token_ids") or params.get("messages") \
            or params.get("prompt") or ""
        if isinstance(prompt, list) and prompt and isinstance(prompt[0], int):
            return InferenceRequest(prompt_token_ids=[int(t) for t in prompt],
                                    sampling=self._sampling_from(cfg))
        return self._build_request(prompt, cfg)

    def pd_prefill(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Prefill stage: run the prompt, sample the first token, export
        the sequence's KV and push it to the decode worker's data plane
        (``decode_url`` + ``/kv/transfer``) — streamed by default, one
        blob for sliding-window models or ``pd_stream: false``. When this
        worker is the decode target (KV affinity) the slot is retained
        under the key: no bytes move. The framing (zstd, as JAX's default)
        and the push run outside any engine work, so the batcher's rounds
        do not wait on them and two workers pushing to each other cannot
        deadlock; a one-shot ``migration_ms`` counts both."""
        if not self.loaded or self.engine is None:
            raise EngineLoadError("engine not loaded")
        decode_url = params.get("decode_url")
        local = not decode_url or params.get("decode_worker") in (
            None, params.get("target_worker"))
        cfg = GenerationConfig.from_params(params)
        req = self._pd_request(params, cfg)
        key = params.get("kv_cache_key") or f"pd-{req.request_id}"
        # the key rides in the handoff so the receiver indexes the slot
        req.session_id = key
        tl = self._flight_timeline(params)
        tl.note("pd.prefill.start", key=key)
        stream_ok = (
            not local
            and bool(params.get("pd_stream", self.config.get("pd_stream", True)))
            and self.engine.model_cfg.sliding_window is None
        )
        if stream_ok:
            return self._pd_prefill_streamed(
                req, key, decode_url,
                piece_blocks=int(params.get("pd_stream_piece_blocks")
                                 or self.config.get("pd_stream_piece_blocks", 4)),
                tl=tl,
            )

        def _prefill_and_export():
            eng = self.engine
            slot = eng.submit_batch([req])[0]
            s = eng.slots[slot]
            first_token = int(eng._last_tokens[slot])
            ttft_ms = ((s.first_token_time - s.start_time) * 1000.0
                       if s.first_token_time else None)
            if local:
                # a re-run of the same child supersedes its earlier
                # retained slot: free that one (no TTL entry would)
                prev = self._pd_slots.get(key)
                if prev is not None and prev[0] != slot and eng.slots[prev[0]] is prev[1]:
                    self.pd_stats["adopted_expired"] += 1
                    eng.finish_slot(prev[0], cache=False)
                self._pd_slots[key] = (slot, s, time.monotonic())
                return slot, first_token, ttft_ms, s.prompt_len, None
            try:
                return slot, first_token, ttft_ms, s.prompt_len, export_slot_kv(eng, slot)
            finally:
                # the donor is done once its pages are on the host: a failed
                # or slow push cannot leak the slot
                eng.finish_slot(slot)

        with self._engine_lock:
            slot, first_token, ttft_ms, prompt_tokens, handoff = \
                self._exclusive(_prefill_and_export)
        tl.note("pd.prefill.done", ttft_ms=ttft_ms)
        usage = {"prompt_tokens": prompt_tokens, "completion_tokens": 0,
                 "total_tokens": prompt_tokens}
        if local:
            self.pd_stats["handoffs_local"] += 1
            tl.note("handoff.local")
            out = {"pd_stage": "prefill", "kv_cache_key": key,
                   "first_token": first_token, "ttft_ms": ttft_ms,
                   "migration_bytes": 0, "migration_ms": 0.0,
                   "decode_slot": slot, "local": True, "usage": usage}
            self._flight_finish(tl, out)
            return out
        # framed (and zstd-compressed) on this thread, after the engine is
        # released: the batcher's rounds do not wait on the encoder
        t0 = time.perf_counter()
        raw = serialize_handoff(handoff)
        del handoff
        tl.note("handoff.begin", bytes=len(raw))
        try:
            resp = self._pd_push(HTTPPoster(), decode_url.rstrip("/") + "/kv/transfer", raw)
        except Exception:
            self.pd_stats["handoffs_failed"] += 1
            tl.note("handoff.failed")
            self._flight_finish(tl)
            raise
        migration_ms = (time.perf_counter() - t0) * 1000.0
        remote = resp.json()
        self.pd_stats["handoffs_committed"] += 1
        self.pd_stats["handoff_bytes"] += len(raw)
        tl.note("handoff.commit", bytes=len(raw))
        out = {"pd_stage": "prefill", "kv_cache_key": key,
               "first_token": first_token, "ttft_ms": ttft_ms,
               "migration_bytes": len(raw), "migration_ms": migration_ms,
               "decode_slot": remote.get("slot"), "local": False, "usage": usage}
        self._flight_finish(tl, out)
        return out

    def _pd_prefill_streamed(self, req: InferenceRequest, key: str, decode_url: str,
                             piece_blocks: int = 4,
                             tl: Any = NULL_TIMELINE) -> Dict[str, Any]:
        """Streamed prefill stage (:class:`StreamedExport`): pieces cross
        the wire while the prompt is still computing. A sender thread
        drains the message queue, so no network I/O runs inside engine
        work; ``migration_ms`` is the decode-ready delay, first token
        sampled → commit acknowledged."""
        url = decode_url.rstrip("/") + "/kv/transfer"
        exp = StreamedExport(self.engine, req, key, piece_blocks=piece_blocks)
        q: "_queue_mod.SimpleQueue" = _queue_mod.SimpleQueue()
        state: Dict[str, Any] = {"exc": None, "last": None, "t_ack": None}
        client = HTTPPoster()

        def _sender() -> None:
            while True:
                item = q.get()
                if item is None:
                    return
                if state["exc"] is not None:
                    continue        # drain after a failure
                try:
                    r = self._pd_push(client, url, item)
                    state["last"] = r.json()
                    state["t_ack"] = time.perf_counter()
                except Exception as exc:  # noqa: BLE001 — surfaced below
                    state["exc"] = exc

        sender = threading.Thread(target=_sender, daemon=True, name="pd-stream-sender")
        sender.start()

        def _abort_remote() -> None:
            # direct POST: the sender skips queued items after a failure,
            # and the receiver's half-built session would pin its blocks.
            # A failed streamed handoff counts once, as "aborted"
            self.pd_stats["handoffs_aborted"] += 1
            try:
                post_bytes(url, abort_message(key), 10.0)
            except Exception:  # noqa: BLE001 — the receiver's TTL reclaims it
                pass

        gen = exp.messages()

        def _drive_export() -> Optional[float]:
            # the generator's cleanup (abort_chunked / finish_slot) mutates
            # the engine, so it runs here on the executor, closed explicitly
            t_end = None
            try:
                for msg in gen:
                    if state["exc"] is not None:
                        raise state["exc"]      # the push is doomed: stop
                    if t_end is None and exp.first_token is not None:
                        t_end = time.perf_counter()
                    q.put(msg)
            finally:
                gen.close()
            return t_end

        tl.note("handoff.begin", streamed=True)
        try:
            with self._engine_lock:
                t_prefill_end = self._exclusive(_drive_export)
        except Exception:
            q.put(None)
            sender.join(timeout=60.0)
            _abort_remote()
            tl.note("handoff.failed")
            self._flight_finish(tl)
            raise
        q.put(None)
        # wire budget: bytes / ~1 MB/s, floor 120 s; slower counts as failed
        sender.join(timeout=max(120.0, exp.bytes_sent / 1e6))
        if sender.is_alive():
            state["exc"] = state["exc"] or TimeoutError(
                f"streamed KV push did not finish ({exp.bytes_sent} bytes)")
        if state["exc"] is not None:
            _abort_remote()
            tl.note("handoff.failed")
            self._flight_finish(tl)
            raise state["exc"]
        remote = state["last"] or {}
        self.pd_stats["handoffs_committed"] += 1
        self.pd_stats["handoff_bytes"] += exp.bytes_sent
        migration_ms = ((state["t_ack"] - t_prefill_end) * 1000.0
                        if state["t_ack"] is not None and t_prefill_end is not None
                        else None)
        wall_minus_perf = time.time() - time.perf_counter()
        if t_prefill_end is not None:
            tl.note_at("pd.prefill.done", t_prefill_end + wall_minus_perf,
                       ttft_ms=exp.ttft_ms)
        else:
            tl.note("pd.prefill.done", ttft_ms=exp.ttft_ms)
        if state["t_ack"] is not None:
            tl.note_at("handoff.commit", state["t_ack"] + wall_minus_perf,
                       bytes=exp.bytes_sent, pieces=exp.pieces_sent)
        else:
            tl.note("handoff.commit", bytes=exp.bytes_sent)
        out = {
            "pd_stage": "prefill", "kv_cache_key": key,
            "first_token": exp.first_token, "ttft_ms": exp.ttft_ms,
            "migration_bytes": exp.bytes_sent,
            "migration_ms": migration_ms,
            "pd_streamed": True,
            "pieces": exp.pieces_sent,
            "bytes_before_first_token": exp.bytes_before_first_token,
            "decode_slot": remote.get("slot"), "local": False,
            "usage": {"prompt_tokens": exp.prompt_tokens, "completion_tokens": 0,
                      "total_tokens": exp.prompt_tokens},
        }
        self._flight_finish(tl, out)
        return out

    def pd_decode(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Decode stage: the adopted (or retained) slot joins the batcher's
        shared rounds (``serving.adopt_slot``) and runs to completion; in
        direct mode (the caller holds the engine lock) this driver decodes
        it alone with ``decode_multi``. TTFT and E2E stay end to end: the
        handoff carried the original times."""
        if not self.loaded or self.engine is None:
            raise EngineLoadError("engine not loaded")
        if self.serving is None and not self._direct:
            raise EngineLoadError("engine not loaded")
        key = params.get("kv_cache_key") or ""
        tl = self._flight_timeline(params)
        tl.note("pd.decode.start", key=key)
        if tl.enabled and self._handoff_rx is not None:
            tl.extend_at(self._handoff_rx.pop_flight(key))
        entry = self._pd_slots.pop(key, None)
        if entry is None:
            raise RuntimeError(f"no adopted KV for key {key!r} — handoff never arrived")
        slot, seq, _ = entry
        eng = self.engine
        if eng.slots[slot] is not seq:
            # reclaimed (TTL purge) or recycled: fail like a lost handoff
            # so the flow re-prefills
            raise RuntimeError(
                f"adopted KV for key {key!r} was reclaimed before the "
                "decode stage claimed it")
        if self._direct:
            try:
                while eng.slots[slot] is not None and \
                        eng.slots[slot].finish_reason is None:
                    eng.decode_multi()
                    self._raise_if_pressured(eng, slot)
            except Exception:
                # a failed job must release the adopted slot: leaked blocks
                # would add to the very pressure that failed it
                if eng.slots[slot] is not None:
                    eng.finish_slot(slot, cache=False)
                raise
            resp = eng.finish_slot(slot)
        else:
            try:
                resp = self.serving.adopt_slot(slot, flight=tl if tl.enabled else None)
            except Exception:
                self._release_adopted_slot(eng, slot, seq)
                raise
            if resp.error is not None:
                self._release_adopted_slot(eng, slot, seq)
                _raise_serving(resp)
        text = self.tokenizer.decode(resp.token_ids) if self.tokenizer else ""
        tl.note("pd.decode.done", tokens=resp.completion_tokens)
        out = {
            "pd_stage": "decode", "kv_cache_key": key,
            "text": text,
            "token_ids": list(resp.token_ids),
            "prompt_tokens": resp.prompt_tokens,
            "completion_tokens": resp.completion_tokens,
            "finish_reason": resp.finish_reason,
            "ttft_ms": resp.ttft_ms,
            "e2e_ms": resp.e2e_ms,
            # the decode child bills the completion, the prefill child the
            # prompt: together the non-PD job's total
            "usage": {"prompt_tokens": 0,
                      "completion_tokens": resp.completion_tokens,
                      "total_tokens": resp.completion_tokens},
        }
        self._flight_finish(tl, out)
        return out

    @staticmethod
    def _raise_if_pressured(eng: TorchEngine, slot: int) -> None:
        """A single-sequence driver of direct mode (PD decode, the stream)
        has no scheduler above it to preempt for: when the engine froze
        THIS slot at a pressure boundary, fail with OutOfBlocksError
        instead of spinning on empty rounds."""
        p = eng.take_pressure()
        if p is not None and slot in p.slots:
            raise OutOfBlocksError(
                f"KV pool exhausted while decoding slot {slot} and no "
                "scheduler is attached to preempt for it"
            )

    def _release_adopted_slot(self, eng: Any, slot: int, seq: Any) -> None:
        """Free an adopted slot a failed or expired decode stage leaves
        behind, on the executor (in direct mode under the caller's engine
        lock); identity-guarded (the index may have been recycled for
        another sequence, which is not ours to finish)."""
        def _free() -> None:
            if eng.slots[slot] is seq:
                eng.finish_slot(slot, cache=False)

        try:
            self._exclusive(_free)
        except Exception:  # noqa: BLE001 — release is best-effort
            pass

    def kv_receiver(self, raw: bytes) -> Dict[str, Any]:
        """Data-plane ``/kv/transfer`` hook: adopt a pushed handoff (one
        blob, or one begin / piece / commit / abort message) on the
        executor and index a bound slot by its kv_cache_key."""
        if not self.loaded or self.engine is None:
            raise EngineLoadError("engine not loaded")
        with self._engine_lock:
            if self._handoff_rx is None or self._handoff_rx.engine is not self.engine:
                self._handoff_rx = HandoffReceiver(self.engine)
            self._purge_stale_pd_slots()
            rx = self._handoff_rx
            result = self._exclusive(lambda: rx.handle(raw))
            if result.get("slot") is not None:
                slot, key = result["slot"], result["kv_cache_key"]
                prev = self._pd_slots.pop(key, None)
                if prev is not None and prev[0] != slot:
                    # a re-run of the same prefill child pushed the key
                    # again: the new adoption supersedes the old one
                    self.pd_stats["adopted_expired"] += 1
                    self._release_adopted_slot(self.engine, prev[0], prev[1])
                self._pd_slots[key] = (slot, self.engine.slots[slot], time.monotonic())
        return result

    # -- cluster KV migration

    def kv_export(self, raw: bytes) -> bytes:
        """Data-plane ``/kv/export`` hook: the longest locally cached
        full-block prefix of a peer's request as framed prefix-only
        messages, from the device radix and the spill tiers. An empty body
        means nothing cached (the peer recomputes); a mismatch raises
        ``ValueError`` (the plane answers 400)."""
        if not self.loaded or self.engine is None:
            raise EngineLoadError("engine not loaded")
        if not self.kv_migrate_enabled:
            raise ValueError("kv migration disabled on this worker")
        req = unpack_export_request(raw)
        eng = self.engine
        if req.get("model_name") != eng.model_cfg.name:
            raise ValueError(f"model mismatch: engine={eng.model_cfg.name} "
                             f"request={req.get('model_name')}")
        if int(req.get("block_size") or 0) != eng.cfg.block_size:
            raise ValueError("block_size mismatch between engines")
        if bool(req.get("int8_kv")) != ("k_scale" in eng.kv):
            raise ValueError("kv_cache_dtype mismatch: int8 pools can only export "
                             "to int8 pools (and vice versa)")
        max_blocks = min(self._kvmig_max_blocks, int(req.get("max_blocks") or 64))
        token_ids = req.get("token_ids") or []
        if not token_ids and req.get("fp"):
            # a fingerprint-keyed pull: resolve it to our token ids; a miss
            # answers empty, an honest "nothing cached"
            with self._kvmig_lock:
                token_ids = self._kvmig_fp_tokens.get(str(req["fp"])) or []
        with self._engine_lock:
            frames, _ = self._exclusive(lambda: export_prefix_frames(
                eng, token_ids, str(req.get("key") or ""),
                max_blocks=max_blocks, start_block=int(req.get("start_block") or 0),
            ))
        body = _frame_blobs(*frames) if frames else b""
        if frames:
            self.kv_migrate_stats["exports"] += 1
            self.kv_migrate_stats["export_bytes"] += len(body)
        return body

    def _kvmig_peer_allowed(self, url: str) -> bool:
        """Budget and per-peer backoff gate, taken together."""
        with self._kvmig_lock:
            _, until = self._kvmig_backoff.get(url, (0, 0.0))
            if time.monotonic() < until or self._kvmig_inflight >= self._kvmig_budget:
                return False
            self._kvmig_inflight += 1
            return True

    # a peer that rejected a pull (4xx) is pinned out this long
    _KVMIG_REJECT_PIN_S = 600.0

    def _kvmig_peer_result(self, url: str, ok: bool, permanent: bool = False) -> None:
        with self._kvmig_lock:
            self._kvmig_inflight = max(0, self._kvmig_inflight - 1)
            if ok:
                self._kvmig_backoff.pop(url, None)
                return
            fails = self._kvmig_backoff.get(url, (0, 0.0))[0] + 1
            if permanent:
                self._kvmig_backoff[url] = (fails, time.monotonic() + self._KVMIG_REJECT_PIN_S)
                return
            # the first failure only falls back; repeats arm a jittered
            # exponential window
            delay = full_jitter_delay(self._kvmig_backoff_s, fails - 1,
                                      self._kvmig_rng) if fails > 1 else 0.0
            self._kvmig_backoff[url] = (fails, time.monotonic() + (delay or 0.0))

    def _pull_prefix(self, url: str, req_raw: bytes,
                     on_begun: Callable[[], None]) -> Optional[tuple]:
        """POST a ``/kv/export`` pull and feed every answered frame through
        our own receiver → (commit result, bytes pulled), or None when the
        peer has nothing cached. Raises on any failure."""
        r = _faults.wrap_http(
            "worker.kv.pull",
            lambda: post_bytes(url + "/kv/export", req_raw, self._kvmig_timeout_s),
            worker=str(getattr(self, "fault_tag", "") or ""),
        )
        if r.status_code >= 400:
            raise HTTPStatusError(r, "kv export")
        frames = split_frames(r.content)
        if not frames:
            return None
        committed = None
        for frame in frames:
            on_begun()
            res = self.kv_receiver(frame)
            if res.get("state") == "committed":
                committed = res
        if committed is None:
            raise ValueError("kv export response ended without commit")
        return committed, sum(len(f) for f in frames)

    def _count_pull(self, tier: str, pull_bytes: int, t_pull: float) -> None:
        # per-tier (bytes, wall-ms) pairs: the plane's bandwidth samples
        stats = self.kv_migrate_stats
        stats["pull_bytes"] += pull_bytes
        pull_ms = max(1, int((time.monotonic() - t_pull) * 1000.0))
        stats[f"pull_bytes_{tier}"] = stats.get(f"pull_bytes_{tier}", 0) + pull_bytes
        stats[f"pull_ms_{tier}"] = stats.get(f"pull_ms_{tier}", 0) + pull_ms

    def _abort_pull(self, exc: Exception, url: str, key: str, begun: bool) -> None:
        # a 4xx is the peer REJECTING the pull: pin it out
        permanent = (isinstance(exc, HTTPStatusError)
                     and 400 <= exc.response.status_code < 500)
        self._kvmig_peer_result(url, ok=False, permanent=permanent)
        if begun:
            # drop the half-built session now, not at the receiver's TTL
            try:
                self.kv_receiver(abort_message(key))
            except Exception:  # noqa: BLE001 — abort is best-effort
                pass

    def _maybe_migrate_kv(self, params: Dict[str, Any]) -> None:
        """Honour a router ``kv_migrate_from`` hint: pull the hot prefix
        from the named peer before admission, landing it in our radix so
        the prefill that follows reuses it. Every failure — peer dead
        mid-pull, a corrupt piece, budget or backoff, no match — falls back
        to a plain recompute, counted (pulled / aborted /
        fallback_recompute) and noted on the timeline."""
        params.pop("_kvmig_token_ids", None)   # never trust an inbound stash
        hint = params.get("kv_migrate_from")
        if not isinstance(hint, dict):
            return
        tl = params.get("_flight_tl") or NULL_TIMELINE
        url = str(hint.get("data_plane_url") or "").rstrip("/")
        stats = self.kv_migrate_stats
        if not url or not self.kv_migrate_enabled or not self.loaded \
                or self.engine is None or not self.engine.cfg.enable_prefix_cache:
            stats["fallback_recompute"] += 1
            tl.note("kv_migrate.fallback", reason="disabled")
            return
        if not self._kvmig_peer_allowed(url):
            stats["fallback_recompute"] += 1
            tl.note("kv_migrate.fallback", reason="budget_or_backoff")
            return
        eng = self.engine
        key = f"kvmig-{uuid.uuid4().hex[:12]}"
        begun: List[bool] = []
        try:
            cfg = GenerationConfig.from_params(params)
            token_ids = self._encode_prompt(
                params.get("messages") or params.get("prompt") or "", cfg)
            # the admission that follows reuses this encode
            params["_kvmig_token_ids"] = token_ids
            bs = eng.cfg.block_size
            if len(token_ids) < bs:
                stats["fallback_recompute"] += 1
                tl.note("kv_migrate.fallback", reason="short_prompt")
                self._kvmig_peer_result(url, ok=True)
                return
            # already warm here (the router hints until our summary says
            # so): skip when the local radix covers the full-block prefix
            n_full = len(token_ids) // bs
            with self._engine_lock:
                local = self._exclusive(
                    lambda: len(eng.manager.radix.match_prefix(token_ids)))
            if local >= max(1, n_full - 1):
                stats["local_hits"] += 1
                tl.note("kv_migrate.local_hit", blocks=local)
                self._kvmig_peer_result(url, ok=True)
                return
            tl.note("kv_migrate.begin", peer=hint.get("worker_id"),
                    matched_blocks=hint.get("matched_blocks"))
            tier = hint.get("tier")
            if tier not in ("dev", "host", "spill"):
                tier = "dev"
            t_pull = time.monotonic()
            req_raw = pack_export_request(
                key=key, token_ids=token_ids, model_name=eng.model_cfg.name,
                block_size=bs, int8_kv="k_scale" in eng.kv,
                max_blocks=self._kvmig_max_blocks,
                # the peer ships only what we miss
                start_block=local,
            )
            got = self._pull_prefix(url, req_raw, lambda: begun.append(True))
            if got is None:
                stats["fallback_recompute"] += 1
                tl.note("kv_migrate.fallback", reason="peer_miss")
                self._kvmig_peer_result(url, ok=True)
                return
            committed, pull_bytes = got
            stats["pulled"] += 1
            # blocks the pull delivered: the chain minus what we held
            stats["pull_blocks"] += max(
                0, int(committed.get("blocks") or 0)
                - int(committed.get("cached_tokens") or 0) // bs)
            self._count_pull(tier, pull_bytes, t_pull)
            tl.note("kv_migrate.pulled", blocks=int(committed.get("blocks") or 0),
                    bytes=pull_bytes)
            self._kvmig_peer_result(url, ok=True)
        except Exception as exc:  # noqa: BLE001 — migration is best-effort
            stats["aborted"] += 1
            tl.note("kv_migrate.aborted")
            self._abort_pull(exc, url, key, bool(begun))

    def kv_replicate(self, hints: Any) -> int:
        """Plane-hinted proactive prefix replication (the heartbeat
        response's ``kv_replicate``): pull the named hot prefixes now, on a
        daemon thread, over the same ``/kv/export`` protocol with the same
        budget, backoff and recompute-on-failure stance. → the number of
        hints accepted."""
        if not self.kv_migrate_enabled or not self.loaded or self.engine is None \
                or not self.engine.cfg.enable_prefix_cache:
            return 0
        todo = []
        for h in hints if isinstance(hints, list) else []:
            if not isinstance(h, dict):
                continue
            fps = h.get("fps")
            url = str(h.get("data_plane_url") or "").rstrip("/")
            if not url or not isinstance(fps, list) or not fps \
                    or not all(isinstance(f, str) for f in fps):
                continue
            todo.append((h, url, [str(f) for f in fps]))
        if not todo:
            return 0
        threading.Thread(target=self._kv_replicate_run, args=(todo,),
                         name="kv-replicate", daemon=True).start()
        return len(todo)

    def _kv_replicate_run(self, todo: List[tuple]) -> None:
        for hint, url, fps in todo:
            try:
                self._kv_replicate_pull(hint, url, fps)
            except Exception:  # noqa: BLE001 — prefetch is best-effort
                pass

    def _kv_replicate_pull(self, hint: Dict[str, Any], url: str, fps: List[str]) -> None:
        eng = self.engine
        hot = self.prefix_hot
        stats = self.kv_migrate_stats
        if eng is None:
            return
        if hot is not None and fps[-1] in hot.snapshot():
            return      # a racing request already landed it
        if not self._kvmig_peer_allowed(url):
            return      # the plane re-hints past its cooldown
        key = f"kvrep-{uuid.uuid4().hex[:12]}"
        tier = hint.get("tier")
        if tier not in ("dev", "host", "spill"):
            tier = "dev"
        begun: List[bool] = []
        try:
            t_pull = time.monotonic()
            # fingerprint-keyed: the warm exporter resolves it to its token
            # ids and the begin frame carries them back
            req_raw = pack_export_request(
                key=key, token_ids=[], model_name=eng.model_cfg.name,
                block_size=eng.cfg.block_size, int8_kv="k_scale" in eng.kv,
                max_blocks=self._kvmig_max_blocks, fp=fps[-1],
            )
            got = self._pull_prefix(url, req_raw, lambda: begun.append(True))
            if got is None:
                stats["replicate_miss"] += 1
                self._kvmig_peer_result(url, ok=True)
                return
            stats["replicated"] += 1
            self._count_pull(tier, got[1], t_pull)
            if hot is not None:
                # advertise the adopted prefix so the next summary stops
                # the hints
                hot.note_fingerprints(fps)
            self._kvmig_peer_result(url, ok=True)
        except Exception as exc:  # noqa: BLE001 — prefetch is best-effort
            stats["replicate_aborted"] += 1
            self._abort_pull(exc, url, key, bool(begun))

    def kv_migrate_wire_stats(self) -> Optional[Dict[str, int]]:
        """Cumulative KV-migration counters (pull outcomes, export service)
        — heartbeat ``engine_stats["kv_migrate"]``. None when this engine
        never migrated."""
        out = {k: int(v) for k, v in self.kv_migrate_stats.items() if v}
        rx = self._handoff_rx
        if rx is not None:
            v = int(rx.stats.get("prefix_commits", 0) or 0)
            if v:
                out["prefix_commits"] = v
        return out or None

    @property
    def handoff_sessions_purged(self) -> int:
        """Abandoned streamed-handoff sessions this engine's receiver
        purged (heartbeat ``kv_handoff_sessions_purged``)."""
        rx = self._handoff_rx
        return int(rx.stats.get("sessions_purged", 0)) if rx is not None else 0

    def pd_wire_stats(self) -> Optional[Dict[str, int]]:
        """Cumulative PD handoff counters (sender outcomes, receiver abort
        and purge reasons) — heartbeat ``engine_stats["pd"]``. None when
        this engine never touched a handoff."""
        out = {k: int(v) for k, v in self.pd_stats.items() if v}
        rx = self._handoff_rx
        if rx is not None:
            for src, dst in (("rx_aborts", "rx_aborts"),
                             ("purged_ttl", "rx_purged_ttl"),
                             ("purged_no_progress", "rx_purged_no_progress"),
                             ("purged_cap", "rx_purged_cap")):
                v = int(rx.stats.get(src, 0) or 0)
                if v:
                    out[dst] = v
        return out or None

    # -- token streaming -----------------------------------------------------

    def stream(self, params: Dict[str, Any],
               cancel: Optional[Any] = None):
        """Sync generator of stream chunks through the batcher: the
        sequence shares decode rounds with every other in-flight request.
        ``{"text_delta", "token_ids", "offset"}``... then a final
        ``{"done": True, "finish_reason", "usage", "offset"}``; ``offset``
        (and ``stream_id``) only when the request carries a stream key.
        ``cancel`` (an Event) aborts at the next step boundary. In direct
        mode the per-step driver :meth:`_stream_direct` runs instead, under
        the engine lock, with the same chunk contract."""
        self._require_serving()
        tl = self._flight_timeline(params)
        if not self._direct:
            if tl.enabled:
                params["_flight_tl"] = tl
            return self._stream_serving(params, cancel=cancel)
        if tl.enabled:
            return self._stream_direct_traced(tl, params, cancel)
        return self._stream_direct(params, cancel=cancel)

    def _stream_direct_traced(self, tl: Any, params: Dict[str, Any],
                              cancel: Optional[Any] = None):
        """The direct stream with a flight timeline: notes the stream's
        boundaries and closes the timeline, attaching its wire to the final
        chunk as the serving stream does (an abandoned stream's partial
        timeline still reaches the heartbeat ring)."""
        tl.note("worker.stream.start", path="direct")
        done = False
        try:
            for chunk in self._stream_direct(params, cancel=cancel):
                if isinstance(chunk, dict) and chunk.get("done"):
                    done = True
                    tl.note("worker.stream.done",
                            finish_reason=chunk.get("finish_reason"))
                    self._flight_finish(tl, chunk)
                yield chunk
        finally:
            if not done:
                tl.note("worker.stream.done", finish_reason="abandoned")
                self._flight_finish(tl)

    @staticmethod
    def _stream_stamp(key: Optional[str]) -> Callable[[Dict[str, Any], int], Dict[str, Any]]:
        """A stream's chunk stamper: ``stream_id`` and the token ``offset``
        when the request carries a stream key."""
        def stamp(chunk: Dict[str, Any], offset: int) -> Dict[str, Any]:
            if key is not None:
                chunk["stream_id"] = key
                chunk["offset"] = offset
            return chunk
        return stamp

    def _stream_checkpoint_tail(self, pre: PreemptedSequence, cfg: GenerationConfig,
                                stamp: Callable, holdback: int, resume_from: int,
                                resume_text: int):
        """Serve the unconsumed tail of a checkpoint that holds the whole
        generation (the donor died between its last decode and the final
        event) straight from it, through the live loops' splice, stop and
        holdback rules — both stream drivers end here."""
        sp = _StreamSplicer(self.tokenizer, cfg, holdback, resume_from, resume_text)
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

    def _stream_direct(self, params: Dict[str, Any], cancel: Optional[Any] = None):
        """The per-step stream driver of direct mode: one ``decode_step``
        (``spec_decode_step`` when the engine speculates) a step under the
        engine lock, each new token through :class:`_StreamSplicer`
        (holdback, stop strings, resume splice), ``cancel`` checked at
        step boundaries. With a stream key it registers for
        ``checkpoint_live``, pushes a synchronous admission checkpoint and
        one every ``checkpoint_interval_tokens``, and stamps offsets; a
        resume context restores the sequence (``TorchEngine.resume``) and
        splices, from a checkpoint either package or either mode wrote."""
        cfg = GenerationConfig.from_params(params)
        ctx = params.get("_failover_ctx")
        ctx = ctx if isinstance(ctx, dict) else {}
        key = str(ctx.get("key") or params.get("stream_id") or "") or None
        epoch = int(ctx.get("epoch") or 0)
        resume_from = int(ctx.get("offset") or 0)
        resume_text = int(ctx.get("text_offset") or 0)
        stamp = self._stream_stamp(key)
        holdback = max(max((len(st) for st in cfg.stop), default=0) - 1, 0)
        pre = self._ckpt_from_wire(ctx.get("checkpoint"))
        if pre is not None and \
                pre.request.sampling.max_new_tokens - len(pre.generated) <= 0:
            yield from self._stream_checkpoint_tail(pre, cfg, stamp, holdback,
                                                    resume_from, resume_text)
            return
        eng = self.engine
        # engine work runs under the engine lock, one step at a time: the
        # lock is never held across a yield (a consumer may stall or drop
        # the generator)
        with self._engine_lock:
            if pre is not None:
                slot = eng.resume(pre)
                request_id = pre.request.request_id
            else:
                req = self._build_request(
                    params.get("messages") or params.get("prompt") or "", cfg,
                    token_ids=params.pop("_kvmig_token_ids", None),
                )
                slot = eng.submit(req)
                request_id = req.request_id
        live_info = {"kind": "stream", "epoch": epoch, "request_id": request_id}
        last_ckpt = len(eng.slots[slot].generated)
        if key is not None:
            self._register_live(key, "stream", epoch, request_id)
            # admission checkpoint (synchronous): a worker killed before
            # its first heartbeat still leaves a resumable record
            self._push_checkpoint(self._snapshot_live(key, live_info), sync=True)
        sp = _StreamSplicer(self.tokenizer, cfg, holdback, resume_from, resume_text)
        try:
            while True:
                s = eng.slots[slot]
                finished = s.finish_reason is not None
                chunk, stop_cut = sp.advance(list(s.generated), finished)
                if chunk is not None:
                    yield stamp(chunk, sp.sent_tokens)
                if stop_cut:
                    s.finish_reason = "stop"
                    finished = True
                if finished:
                    break
                if cancel is not None and cancel.is_set():
                    s.finish_reason = s.finish_reason or "abort"
                    break
                with self._engine_lock:
                    if eng.cfg.speculative is not None:
                        # up to K+1 tokens a round reach the stream
                        eng.spec_decode_step()
                    else:
                        eng.decode_step()
                    self._raise_if_pressured(eng, slot)
                if key is not None and self._ckpt_interval > 0:
                    s2 = eng.slots[slot]
                    n = len(s2.generated) if s2 is not None else last_ckpt
                    if n - last_ckpt >= self._ckpt_interval:
                        self._push_checkpoint(self._snapshot_live(key, live_info))
                        last_ckpt = n
        finally:
            if key is not None:
                self._unregister_live(key)
            with self._engine_lock:
                resp = eng.finish_slot(slot)
        yield stamp({
            "done": True,
            "finish_reason": sp.finish_override or resp.finish_reason,
            "usage": {
                "prompt_tokens": resp.prompt_tokens,
                "completion_tokens": resp.completion_tokens,
                "total_tokens": resp.prompt_tokens + resp.completion_tokens,
                "cached_tokens": resp.cached_tokens,
            },
        }, sp.sent_tokens)
        # the server-held checkpoint is NOT retired on completion: the
        # worker cannot know the final bytes reached the client

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
        stamp = self._stream_stamp(key)
        holdback = max((len(s) for s in cfg.stop), default=0)
        holdback = max(holdback - 1, 0)
        pre = self._ckpt_from_wire(ckpt)
        if pre is not None:
            remaining = (pre.request.sampling.max_new_tokens
                         - len(pre.generated))
            if remaining <= 0:
                # the checkpoint holds the whole generation: serve its
                # unconsumed tail straight from it
                yield from self._stream_checkpoint_tail(
                    pre, cfg, stamp, holdback, resume_from, resume_text)
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
        if self._direct:
            return self._job_inference_direct(params, cfg, key, epoch, ctx)
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

    def _job_inference_direct(self, params: Dict[str, Any], cfg: GenerationConfig,
                              key: str, epoch: int,
                              ctx: Dict[str, Any]) -> Dict[str, Any]:
        """The queued-job driver of direct mode (the caller holds the engine
        lock): submits, or resumes from the claim's checkpoint, registers
        for ``checkpoint_live``, decodes in ``decode_multi`` rounds so a
        drain interrupt lands at a step boundary — there it preempts the
        slot and raises :class:`JobMigrated` with the frozen state — and
        rides out KV pressure by preempt + resume. A fresh greedy job takes
        the standalone tree decoder where one is attached (its waves are
        neither interruptible nor checkpointable: a drain finishes it, a
        crash replays it)."""
        eng = self.engine
        tl = params.pop("_flight_tl", NULL_TIMELINE)
        tl.note("worker.start", path="job")
        ckpt = ctx.get("checkpoint")
        if not isinstance(ckpt, dict) and self._spec is not None \
                and cfg.temperature <= 0.0:
            return self._legacy_inference(params)
        t0 = time.perf_counter()
        pre = self._ckpt_from_wire(ckpt)
        if pre is not None:
            if pre.request.sampling.max_new_tokens - len(pre.generated) <= 0:
                # the checkpoint already holds the whole generation:
                # deliver without touching the engine
                return self._finish_payload(
                    list(pre.generated), pre.prompt_len,
                    pre.cached_tokens, "length", cfg, None,
                    time.perf_counter() - t0,
                )
            slot = eng.resume(pre)
            request_id = pre.request.request_id
        else:
            req = self._build_request(
                params.get("messages") or params.get("prompt") or "", cfg,
                token_ids=params.pop("_kvmig_token_ids", None),
            )
            slot = eng.submit(req)
            request_id = req.request_id
        self._register_live(key, "job", epoch, request_id)
        try:
            while eng.slots[slot] is not None and \
                    eng.slots[slot].finish_reason is None:
                if self._interrupt.is_set():
                    pre = eng.preempt_slot(slot)
                    raise JobMigrated(pre.to_wire(), tokens=len(pre.generated))
                eng.decode_multi()
                slot = self._ride_out_pressure(eng, slot)
        except JobMigrated:
            raise
        except Exception:
            if eng.slots[slot] is not None:
                eng.finish_slot(slot, cache=False)
            raise
        finally:
            self._unregister_live(key)
        resp = eng.finish_slot(slot)
        if tl.enabled and resp.extra.get("t_first_token") is not None:
            # the engine-observed instant, not the loop-observed one
            tl.note_at("batcher.first_token", resp.extra["t_first_token"])
        tl.note("worker.done")
        payload = self._finish_payload(
            list(resp.token_ids), resp.prompt_tokens, resp.cached_tokens,
            resp.finish_reason or "stop", cfg, resp.ttft_ms,
            time.perf_counter() - t0,
        )
        self._flight_finish(tl, payload)
        return payload

    def _ride_out_pressure(self, eng: TorchEngine, slot: int) -> int:
        """KV pressure under the direct job driver, with no batcher above
        it: when the engine froze THIS slot at a pressure boundary, preempt
        it (its full blocks park in the prefix cache) and resume at once.
        No wait loop — this runs under the engine lock, which the paths
        that free pinned blocks (adoptions, retained PD slots) also take.
        If the pool still cannot hold the sequence the job fails; a drain
        interrupt turns the frozen state into :class:`JobMigrated`."""
        p = eng.take_pressure()
        if p is None or slot not in p.slots:
            return slot
        pre = eng.preempt_slot(slot)
        if self._interrupt.is_set():
            raise JobMigrated(pre.to_wire(), tokens=len(pre.generated))
        try:
            return eng.resume(pre)
        except OutOfBlocksError:
            raise OutOfBlocksError(
                "KV pool cannot hold the queued job's sequence even after "
                "preempt/evict — blocks are pinned by concurrent sessions"
            ) from None

    # -- batch path ------------------------------------------------------------

    def batch_inference(self, batch: List[Dict[str, Any]]
                        ) -> List[Dict[str, Any]]:
        """Every request of the batch submitted at once to the batcher (the
        engine's one caller), so they share rounds; payloads in order, built
        as the blocking path builds them. In direct mode one
        ``generate`` over the batch, under the engine lock."""
        if self._direct:
            return self._batch_direct(batch)
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

    def _batch_direct(self, batch: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        """Direct mode's batch: the whole prompt of each (no truncation),
        one ``TorchEngine.generate`` over the batch, payloads in order, each
        text cut at the first configured stop string found (finish reason
        unchanged) — the JAX worker's batch path. That path takes no engine
        lock, so there it can race a handoff adoption; here the engine lock
        is held, and ``generate`` leaves an adopted slot to its decode
        stage."""
        reqs, cfgs = [], []
        for params in batch:
            cfg = GenerationConfig.from_params(params)
            cfgs.append(cfg)
            text = self._to_prompt(params.get("messages") or params.get("prompt") or "")
            reqs.append(InferenceRequest(
                prompt_token_ids=list(self.tokenizer.encode(text)),
                sampling=self._sampling_from(cfg),
            ))
        with self._engine_lock:
            resps = self.engine.generate(reqs, use_multi_step=True)
        return [self._legacy_result(resp, cfg, resp.ttft_ms,
                                    stop_sets_finish=False).to_result_payload()
                for resp, cfg in zip(resps, cfgs)]

    def health(self) -> Dict[str, Any]:
        h = super().health()
        if self.engine is not None:
            h["engine_stats"] = self.engine.get_stats()
        stats = self.serving_stats()
        if stats is not None:
            h["serving_stats"] = stats
        return h
