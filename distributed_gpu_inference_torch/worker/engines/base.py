"""Engine base classes for the worker's engine API.

The port's own copy of the parts of
``distributed_gpu_inference_tpu/worker/engines/base.py`` the LLM engine
uses: the load/inference/unload lifecycle with its async, batch and stream
bridges, the per-request ``GenerationConfig``, the ``GenerationResult``
payload and the error types the worker maps to job outcomes.
"""

from __future__ import annotations

import abc
import asyncio
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Dict, List, Optional


class EngineLoadError(RuntimeError):
    """Model/deps unavailable — the worker should drop this task type."""


class ServingError(RuntimeError):
    """A serving-path request failed with a machine-readable class:
    ``error_code`` mirrors ``InferenceResponse.error_code``
    (``request_timeout`` / ``shed_overload`` / ``over_capacity`` / ...)."""

    def __init__(self, message: str,
                 error_code: Optional[str] = None) -> None:
        super().__init__(message)
        self.error_code = error_code


class JobMigrated(Exception):
    """A generation was interrupted at a step boundary (graceful drain) and
    frozen into a portable checkpoint instead of finishing. The worker
    hands ``checkpoint`` (the ``PreemptedSequence`` wire) to the control
    plane, which requeues the job so the next claimant resumes it — no
    tokens lost, no retry burned."""

    def __init__(self, checkpoint: Dict[str, Any], tokens: int = 0) -> None:
        super().__init__(f"job migrated with {tokens} generated tokens")
        self.checkpoint = checkpoint
        self.tokens = tokens


@dataclass
class GenerationConfig:
    """Per-request generation knobs."""

    max_new_tokens: int = 256
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    stop: List[str] = field(default_factory=list)
    # token-level stops (merged with the tokenizer's eos)
    stop_token_ids: List[int] = field(default_factory=list)
    seed: Optional[int] = None
    # run to the max_new_tokens budget, honoring no stops
    ignore_eos: bool = False
    # advisory completion deadline (seconds from admission)
    deadline_s: Optional[float] = None

    @classmethod
    def from_params(cls, params: Dict[str, Any]) -> "GenerationConfig":
        dl = params.get("deadline_s")
        return cls(
            deadline_s=float(dl) if dl is not None else None,
            max_new_tokens=int(
                params.get("max_new_tokens") or params.get("max_tokens") or 256
            ),
            temperature=float(params.get("temperature") or 0.0),
            top_k=int(params.get("top_k") or 0),
            top_p=float(params.get("top_p") or 1.0),
            stop=list(params.get("stop") or []),
            stop_token_ids=[int(t) for t in
                            (params.get("stop_token_ids") or [])],
            seed=params.get("seed"),
            ignore_eos=bool(params.get("ignore_eos") or False),
        )


@dataclass
class GenerationResult:
    """Uniform result surface."""

    text: str
    prompt_tokens: int = 0
    completion_tokens: int = 0
    cached_tokens: int = 0
    finish_reason: str = "stop"
    ttft_ms: Optional[float] = None
    extra: Dict[str, Any] = field(default_factory=dict)

    def to_result_payload(self) -> Dict[str, Any]:
        """Shape of the job ``result`` JSON the control plane stores/bills."""
        return {
            "text": self.text,
            "finish_reason": self.finish_reason,
            "usage": {
                "prompt_tokens": self.prompt_tokens,
                "completion_tokens": self.completion_tokens,
                "total_tokens": self.prompt_tokens + self.completion_tokens,
                "cached_tokens": self.cached_tokens,
            },
            **({"ttft_ms": self.ttft_ms} if self.ttft_ms is not None else {}),
            **self.extra,
        }


class BaseEngine(abc.ABC):
    """load_model → inference(params) → unload lifecycle."""

    task_type: str = "llm"

    def __init__(self, config: Optional[Dict[str, Any]] = None) -> None:
        self.config = dict(config or {})
        self.loaded = False

    @abc.abstractmethod
    def load_model(self) -> None: ...

    @abc.abstractmethod
    def inference(self, params: Dict[str, Any]) -> Dict[str, Any]: ...

    def unload(self) -> None:
        self.loaded = False

    def health(self) -> Dict[str, Any]:
        return {"loaded": self.loaded, "task_type": self.task_type}


class LLMBaseEngine(BaseEngine):
    """Async, batch and stream bridges over the blocking ``inference``."""

    async def inference_async(self, params: Dict[str, Any]) -> Dict[str, Any]:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, self.inference, params)

    def batch_inference(self, batch: List[Dict[str, Any]]
                        ) -> List[Dict[str, Any]]:
        return [self.inference(p) for p in batch]

    async def batch_inference_async(self, batch: List[Dict[str, Any]]
                                    ) -> List[Dict[str, Any]]:
        return await asyncio.gather(
            *[self.inference_async(p) for p in batch]
        )

    async def stream_inference(self, params: Dict[str, Any]
                               ) -> AsyncIterator[Dict[str, Any]]:
        """Default streaming = one final chunk; token-level engines override."""
        yield await self.inference_async(params)
