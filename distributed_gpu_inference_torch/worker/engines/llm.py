"""The worker's LLM engine on PyTorch: tokenizer + ``TorchEngine`` behind
the continuous batcher.

The port of ``distributed_gpu_inference_tpu/worker/engines/llm.py``
``TPULLMEngine`` for the blocking serving path: ``load_model`` builds a
:class:`TorchEngine` and a :class:`BatcherServing` front end, and
``inference(params)`` — what the worker's job loop and the direct server's
``/inference`` handler call — tokenizes, submits through the batcher, and
returns the same result payload as the JAX engine. Concurrent callers
share engine rounds through slot-level continuous batching.

Not in this slice: streaming, prefill/decode hand-off stages, KV
migration, checkpointed failover, the flight recorder, speculative
decoding, spill tiers and tensor parallelism.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from distributed_gpu_inference_torch.runtime.batcher import (
    BatcherConfig,
    BatcherServing,
)
from distributed_gpu_inference_torch.runtime.engine import (
    EngineConfig,
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


class TorchLLMEngine(LLMBaseEngine):
    """config keys: model (name in the models/configs registry), tokenizer,
    max_batch_size, max_seq_len, multi_step, enable_prefix_cache,
    prefill_buckets, num_blocks, dtype, quantization (int8 | fp8 weight-only,
    ``ops/quantization.py``), kv_cache_dtype (int8 | fp8 | None = dtype),
    device (default ``cuda``), seed,
    params (a params tree already on the device, e.g. from
    ``models.convert.params_from_numpy``; random init from ``seed`` when
    absent) and the ``serving`` knobs of :data:`SERVING_DEFAULTS`."""

    task_type = "llm"

    def __init__(self, config: Optional[Dict[str, Any]] = None) -> None:
        super().__init__(config)
        self.engine: Optional[TorchEngine] = None
        self.serving: Optional[BatcherServing] = None
        self.tokenizer = self.config.get("tokenizer")

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

    def inference(self, params: Dict[str, Any]) -> Dict[str, Any]:
        if params.get("pd_stage") is not None:
            raise ServingError(
                "prefill/decode hand-off stages are not ported yet",
                error_code="unsupported",
            )
        if self.serving is None or not self.serving.active:
            raise EngineLoadError("engine not loaded")
        return self._serving_inference(params)

    def _serving_inference(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Blocking request through the batcher front end: concurrent
        callers share engine rounds via slot-level continuous batching."""
        cfg = GenerationConfig.from_params(params)
        req = self._build_request(
            params.get("messages") or params.get("prompt") or "", cfg,
        )
        if params.get("priority") is not None:
            req.priority = int(params.get("priority") or 0)
        t0 = time.perf_counter()
        resp = self.serving.submit(req)
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
        """Result payload: decode + stop-string truncation."""
        out_text = self.tokenizer.decode(token_ids) if self.tokenizer else ""
        finish = finish_reason
        for s in cfg.stop:
            idx = out_text.find(s)
            if idx >= 0:
                out_text = out_text[:idx]
                finish = "stop"
                break
        return GenerationResult(
            text=out_text,
            prompt_tokens=prompt_tokens,
            completion_tokens=len(token_ids),
            cached_tokens=cached_tokens,
            finish_reason=finish,
            ttft_ms=ttft_ms if ttft_ms is not None else e2e_s * 1000.0,
        ).to_result_payload()
