"""Typed request/response and KV-block records the serving path uses.

The port's own copy of the parts of
``distributed_gpu_inference_tpu/utils/data_structures.py`` that the engine,
the block manager, the batcher and the worker read: the worker's lifecycle
state and topology record, the layer range a checkpoint load takes (and a
pipeline stage owns), sampling controls, requests, responses, per-page
block metadata, the prefix hash, and the pipeline's session and stage-plan
records (:class:`SessionConfig`, :class:`ModelShardConfig`). Pure Python.
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


@dataclass(frozen=True)
class BlockRange:
    """A contiguous half-open range of transformer layers ``[start, end)``:
    the layers a pipeline stage owns, and the layers
    ``models/loader.py`` ``load_hf_llama`` reads."""

    start: int
    end: int

    def __post_init__(self) -> None:
        if self.start < 0 or self.end < self.start:
            raise ValueError(f"invalid layer range [{self.start}, {self.end})")

    @property
    def num_layers(self) -> int:
        return self.end - self.start

    def __contains__(self, layer: int) -> bool:
        return self.start <= layer < self.end


@dataclass
class TpuTopology:
    """A worker's accelerators as registration reports them. Named after
    the JAX package's record, with the same ``to_dict`` keys, because the
    control plane stores ``topology`` as sent; the port fills it from
    ``torch.cuda`` (``worker/main.py`` ``probe_topology``): ``chip_type`` is
    the device name, ``ici_bandwidth_gbps`` the card's NVLink rate and
    ``peak_bf16_tflops`` its published dense bf16 rate."""

    chip_type: str = "cpu"
    num_chips: int = 1
    hbm_gb_per_chip: float = 0.0
    mesh_shape: Tuple[int, ...] = (1,)
    mesh_axis_names: Tuple[str, ...] = ("data",)
    ici_bandwidth_gbps: float = 0.0
    dcn_bandwidth_gbps: float = 25.0
    peak_bf16_tflops: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "chip_type": self.chip_type,
            "num_chips": self.num_chips,
            "hbm_gb_per_chip": self.hbm_gb_per_chip,
            "mesh_shape": list(self.mesh_shape),
            "mesh_axis_names": list(self.mesh_axis_names),
            "ici_bandwidth_gbps": self.ici_bandwidth_gbps,
            "dcn_bandwidth_gbps": self.dcn_bandwidth_gbps,
            "peak_bf16_tflops": self.peak_bf16_tflops,
        }


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
# Session / shard configuration
# ---------------------------------------------------------------------------


@dataclass
class SessionConfig:
    """Configuration of a distributed pipeline session (``comm/session.py``):
    the fields of the JAX record that its session reads, with their
    defaults. A hop's timeout is its ``WorkerSession``'s; the JAX record's
    ``model_name``, ``dtype``, ``timeout_s``, ``compress_dcn`` and
    ``use_ici_collectives`` are read by no session and left out (the port
    writes uncompressed frames)."""

    max_length: int = 8192
    max_retries_per_hop: int = 3
    retry_backoff_s: float = 0.5


@dataclass
class ModelShardConfig:
    """Stage plan for layer-sharded pipeline serving: stage order is the
    inference route's order (the embedding lives in stage 0, the final norm
    and LM head in the last)."""

    model_name: str
    num_layers: int
    stages: List[BlockRange] = field(default_factory=list)
    stage_workers: List[str] = field(default_factory=list)  # worker_id per stage

    def __post_init__(self) -> None:
        if self.stages:
            self.validate()

    def validate(self) -> None:
        if not self.stages:
            raise ValueError("no stages")
        if self.stages[0].start != 0:
            raise ValueError("first stage must start at layer 0")
        if self.stages[-1].end != self.num_layers:
            raise ValueError(
                f"last stage ends at {self.stages[-1].end}, expected {self.num_layers}"
            )
        for a, b in zip(self.stages, self.stages[1:]):
            if a.end != b.start:
                raise ValueError(f"gap/overlap between stages {a} and {b}")
        if self.stage_workers and len(self.stage_workers) != len(self.stages):
            raise ValueError("stage_workers length != stages length")

    @property
    def num_stages(self) -> int:
        return len(self.stages)

    def get_inference_route(self) -> List[Tuple[str, BlockRange]]:
        """Ordered (worker_id, layer_range) hops for a full forward pass."""
        self.validate()
        if not self.stage_workers:
            raise ValueError("no workers assigned to stages")
        return list(zip(self.stage_workers, self.stages))

    def stage_for_layer(self, layer: int) -> int:
        for i, rng in enumerate(self.stages):
            if layer in rng:
                return i
        raise ValueError(f"layer {layer} not in any stage")


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
