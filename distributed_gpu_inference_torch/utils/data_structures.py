"""Typed request/response and KV-block records the serving path uses.

The port's own copy of the parts of
``distributed_gpu_inference_tpu/utils/data_structures.py`` that the engine,
the block manager, the batcher and the direct server read: the worker's
lifecycle state, sampling controls, requests, responses, per-page block
metadata and the prefix hash. Pure Python.
"""

from __future__ import annotations

import hashlib
import time
import uuid
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional, Sequence, Tuple


class WorkerState(str, Enum):
    """Lifecycle state of a worker."""

    INITIALIZING = "initializing"
    IDLE = "idle"
    BUSY = "busy"
    DRAINING = "draining"       # graceful shutdown: finish running, accept none
    OFFLINE = "offline"
    FAILED = "failed"


class JobType(str, Enum):
    LLM = "llm"
    EMBEDDING = "embedding"
    VISION = "vision"
    ASR = "asr"
    IMAGE_GEN = "image_gen"


# ---------------------------------------------------------------------------
# KV cache block metadata
# ---------------------------------------------------------------------------

KV_BLOCK_TOKENS = 16  # tokens per page


@dataclass
class KVBlockMeta:
    """Host-side metadata for one page of a device-resident KV pool: the
    payload is an index into the pool tensor, never the tensor itself.
    Sharing a block = sharing the index; copy-on-write allocates a fresh
    index and copies the page on the device."""

    block_id: int
    num_tokens: int = 0
    capacity: int = KV_BLOCK_TOKENS
    ref_count: int = 1
    prefix_hash: Optional[str] = None
    last_access: float = field(default_factory=time.time)

    @property
    def is_full(self) -> bool:
        return self.num_tokens >= self.capacity

    @property
    def is_shared(self) -> bool:
        return self.ref_count > 1

    def touch(self, now: Optional[float] = None) -> None:
        self.last_access = time.time() if now is None else now

    def incref(self) -> int:
        self.ref_count += 1
        return self.ref_count

    def decref(self) -> int:
        if self.ref_count <= 0:
            raise ValueError(f"block {self.block_id}: decref below zero")
        self.ref_count -= 1
        return self.ref_count


# ---------------------------------------------------------------------------
# Requests / responses
# ---------------------------------------------------------------------------


@dataclass
class SamplingParams:
    """Decode-time sampling controls."""

    max_new_tokens: int = 256
    temperature: float = 0.0      # 0 → greedy
    top_k: int = 0                # 0 → disabled
    top_p: float = 1.0            # 1.0 → disabled
    stop_token_ids: Tuple[int, ...] = ()
    seed: Optional[int] = None
    # run to the max_new_tokens budget, honoring NO stop ids (engine eos
    # included) — benchmark workloads where every leg must generate the
    # same token count
    ignore_eos: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return {
            "max_new_tokens": self.max_new_tokens,
            "temperature": self.temperature,
            "top_k": self.top_k,
            "top_p": self.top_p,
            "stop_token_ids": list(self.stop_token_ids),
            "seed": self.seed,
            "ignore_eos": self.ignore_eos,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SamplingParams":
        d = dict(d)
        d["stop_token_ids"] = tuple(d.get("stop_token_ids", ()))
        d["ignore_eos"] = bool(d.get("ignore_eos", False))
        return cls(**d)


@dataclass
class InferenceRequest:
    """A unit of schedulable work."""

    request_id: str = field(default_factory=lambda: uuid.uuid4().hex)
    job_type: JobType = JobType.LLM
    model: Optional[str] = None
    prompt: Optional[str] = None
    prompt_token_ids: Optional[List[int]] = None
    messages: Optional[List[Dict[str, str]]] = None   # chat format
    sampling: SamplingParams = field(default_factory=SamplingParams)
    priority: int = 0
    session_id: Optional[str] = None
    arrival_time: float = field(default_factory=time.time)
    # relative completion deadline (seconds from arrival): within a
    # priority band the batcher admits earlier deadlines first (EDF) and
    # prefers later-deadline slots as preemption victims. None = no
    # deadline.
    deadline_s: Optional[float] = None
    params: Dict[str, Any] = field(default_factory=dict)  # task-specific extras

    @property
    def deadline_at(self) -> float:
        """Absolute deadline (epoch seconds), +inf when none is set —
        directly usable as an EDF sort component."""
        if self.deadline_s is None:
            return float("inf")
        return self.arrival_time + float(self.deadline_s)

    @property
    def num_prompt_tokens(self) -> int:
        return len(self.prompt_token_ids) if self.prompt_token_ids else 0


@dataclass
class InferenceResponse:
    """Result of an inference request."""

    request_id: str
    text: Optional[str] = None
    token_ids: List[int] = field(default_factory=list)
    finish_reason: Optional[str] = None
    prompt_tokens: int = 0
    completion_tokens: int = 0
    cached_tokens: int = 0          # prefix-cache hits
    ttft_ms: Optional[float] = None
    e2e_ms: Optional[float] = None
    error: Optional[str] = None
    # machine-readable error class next to the human-readable ``error``:
    # ``request_timeout`` (the caller's wait budget elapsed — the request
    # may still be generating), ``shed_overload`` (rejected at admission,
    # nothing ran), ``over_length``, ``over_capacity``, ...
    error_code: Optional[str] = None
    extra: Dict[str, Any] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return self.error is None


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def compute_prefix_hash(token_ids: Sequence[int], upto: Optional[int] = None) -> str:
    """Stable hash of a token prefix for prefix-cache keys; block-aligned
    callers pass ``upto`` = a multiple of KV_BLOCK_TOKENS."""
    ids = token_ids if upto is None else token_ids[:upto]
    h = hashlib.sha256()
    for t in ids:
        h.update(int(t).to_bytes(4, "little", signed=False))
    return h.hexdigest()
