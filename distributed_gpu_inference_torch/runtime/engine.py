"""Slot-based serving engine over paged KV on one CUDA device, or on the
devices of its tensor- or sequence-parallel ranks.

The port of ``distributed_gpu_inference_tpu/runtime/engine.py``
``TPUEngine``. Weights may be quantized
on load
(``EngineConfig.quantization`` int8 / fp8, ``ops/quantization.py``) and the
KV pools stored as int8 with scale pools or as fp8
(``EngineConfig.kv_cache_dtype``). It owns

- the paged KV pools (``models.llama.init_kv_pools``), updated IN PLACE by
  the forward passes and the copy-on-write page copies,
- a :class:`PagedKVCacheManager` for block accounting, prefix reuse, CoW
  and the spill tiers (``EngineConfig.spill_host_blocks`` /
  ``spill_remote_store``): evicted pages go to the host and come back into
  the pools through ``_apply_pending``, batched over the blocks of a round
  (one gather and one device-to-host copy, one host-to-device copy and one
  ``index_copy_`` per pool),
- fixed-size **slot** state (block tables, lengths, sampling params, stop
  ids) as host numpy mirrors that stay authoritative for scheduling,

and exposes the surface the continuous batcher drives: ``submit`` /
``submit_batch``, chunk-interleaved admission, ``ragged_round`` (decode rows
and prefill-chunk rows in one forward), ``decode_multi`` (T decode steps with
stop/budget masking on the device and one host read at the end),
``snapshot_slot`` / ``preempt_slot`` / ``resume`` (or
``resume_chunked_start``, its ragged form), ``finish_slot`` and ``generate``.

With ``EngineConfig.speculative`` (``runtime/speculative.py``
``SpecDecodeConfig``) every decode round is a draft→verify→accept round:
each active slot drafts K tokens with the draft head, one forward verifies
them (K+1 queries a row, through the ragged kernel on the card) and the
slot commits its longest matching prefix plus the target's token — 1..K+1
tokens a round, the greedy stream unchanged. ``decode_multi`` runs up to T
such rounds as an eager loop with stop/budget masking on the device and the
per-round record replayed on the host (``_spec_decode_rounds``);
``ragged_round`` co-dispatches verify rows with admission chunk rows
(``_spec_ragged_round``). Drafts write their KV ahead into blocks reserved
for the window; at each step boundary ``trim_reserved`` hands back the
blocks acceptance never reached. ``distill_draft`` fits the draft head
against the engine's own weights before it serves.

Tensor and expert parallelism (``rank_devices`` with more than one
device; the JAX engine's ``model``-axis mesh): this engine is rank 0 and
keeps every piece of host state; ranks 1..tp-1 are processes of
``runtime/tp.py`` holding their shards of the weights and pools, sent a
command with the host arrays before each device call. Sequence
parallelism (``mesh=MeshPlan(seq=n)``, the JAX ``seq`` axis) runs over the
same ranks with the weights replicated: a fresh prompt longer than the
largest prefill bucket takes ONE seq-parallel pass, ring or Ulysses
attention over the ranks (``EngineConfig.seq_parallel_impl``), and its
pages land in the pools decode reads. With replicated pools rank 0 holds
every page and serves everything else alone; with
``EngineConfig.kv_seq_sharded`` each rank holds 1/n of the blocks, every
rank runs every forward, and reads merge partial softmaxes across the
ranks (``parallel/ring_attention.py``). :meth:`gather_pages` and
:meth:`push_pages` move each rank's heads or blocks of a page through the
group, so KV handoff, PD roles and the spill tiers work on either axis.
Both axes at once (``mesh=MeshPlan(seq=s, model=m)``, s*m ranks, JAX's
seq x model mesh): heads and weights cut over ``model``, pool blocks over
``seq`` when block-sharded (``runtime/tp.py`` :class:`RankLayout`); the
row-parallel sums run over each rank's ``model`` sub-group and the seq
ops over its ``seq`` sub-group. ``migrate_kv_device`` between a mesh
engine and another on the same devices moves pages through the ranks'
own gathers and pushes. Refused by name on a mesh: speculative decoding
(single-chip in the JAX engine too) and a data or stage axis.

Failure semantics: the JAX engine's device calls were functional, so a
failed call left the old pools intact. Here a round updates the pools in
place, so a failure part-way leaves them half-written: the engine records
the failure and every later device round raises :class:`EngineStateLost`
instead of serving from corrupt state.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import time
import uuid
import weakref
import zlib
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from distributed_gpu_inference_torch.models import llama
from distributed_gpu_inference_torch.models.configs import (
    ModelConfig,
    get_model_config,
)
from distributed_gpu_inference_torch.models.loader import (
    load_or_init_params,
    load_quant_cache,
    quant_cache_path,
    save_quant_cache,
)
from distributed_gpu_inference_torch.ops import _build
from distributed_gpu_inference_torch.ops.paged_attention import (
    kernel_takes,
    launch_counts,
    reset_launch_counts,
)
from distributed_gpu_inference_torch.ops.quantization import (
    QUANT_MODES,
    quantize_params,
)
from distributed_gpu_inference_torch.ops.sampling import (
    greedy_tokens,
    sample_tokens_per_slot,
)
from distributed_gpu_inference_torch.runtime.kv_cache import (
    HostKVStore,
    OutOfBlocksError,
    PagedKVCacheManager,
)
from distributed_gpu_inference_torch.parallel.mesh import (
    AXIS_MODEL,
    AXIS_SEQ,
    MeshPlan,
    TPGroup,
)
from distributed_gpu_inference_torch.parallel.sharding import (
    seq_num_blocks,
    shard_tree,
)
from distributed_gpu_inference_torch.runtime import tp as tp_ranks
from distributed_gpu_inference_torch.runtime.tp import (
    RankFailed,
    RankLayout,
    RankRoles,
    RankSpec,
    SeqRank,
    TPRanks,
    attention_kind,
    copy_blocks,
    decode_steps,
    gather_blocks,
    page_bytes,
    rendezvous_path,
    seq_prefill,
    tensor_bits,
    tree_to,
    unpack_pages,
    write_blocks,
)
from distributed_gpu_inference_torch.runtime.speculative import (
    SpecDecodeConfig,
    draft_apply,
    distill_draft_params,
    init_draft_params,
    mask_emission,
    ordered_emission,
)
from distributed_gpu_inference_torch.utils.data_structures import (
    InferenceRequest,
    InferenceResponse,
    SamplingParams,
)

MAX_STOP_IDS = 4
_BIG_BUDGET = 1 << 30


def _resolve_kv_dtype(kv_cache_dtype: Optional[str],
                      activation_dtype: torch.dtype) -> torch.dtype:
    """KV pool storage dtype (the JAX package's rules). ``fp8`` = e4m3 with
    no scales; ``int8`` pools carry per-(page, token) scale pools."""
    if kv_cache_dtype is None:
        return activation_dtype
    alias = {
        "fp8": torch.float8_e4m3fn,
        "float8_e4m3fn": torch.float8_e4m3fn,
        "bf16": torch.bfloat16,
        "bfloat16": torch.bfloat16,
        "int8": torch.int8,
    }
    if kv_cache_dtype not in alias:
        raise ValueError(
            f"unknown kv_cache_dtype {kv_cache_dtype!r}; use {sorted(alias)}"
        )
    return alias[kv_cache_dtype]


def check_kernels_take(model_cfg: ModelConfig, dtype: torch.dtype,
                       kv_dtype: torch.dtype) -> None:
    """Refuse a model the CUDA attention kernels do not take (head_dim,
    activation dtype, KV pool dtype): on the card every round runs them,
    so such a model would fail its first round instead of loading."""
    if not kernel_takes(model_cfg.head_dim, dtype, kv_dtype):
        raise ValueError(
            f"{model_cfg.name}: the CUDA attention kernels take head_dim 32, "
            f"64, 128 or 256, bf16 activations and bf16/int8/fp8 KV pools; "
            f"got head_dim {model_cfg.head_dim}, {dtype}, pool {kv_dtype}"
        )


@dataclass
class EngineConfig:
    max_batch_size: int = 8
    max_seq_len: int = 2048
    block_size: int = 16
    num_blocks: Optional[int] = None      # default: 1.5x worst-case + pad block
    prefill_buckets: Tuple[int, ...] = (16, 32, 64, 128, 256, 512, 1024, 2048)
    enable_prefix_cache: bool = True
    multi_step: int = 16                  # decode horizon of decode_multi
    dtype: str = "bfloat16"                # activations, weights and KV pools
    # max prefill-chunk width co-dispatched with decode rows in one
    # ragged_round(); clamped to the largest prefill bucket, widths bucket
    # through prefill_buckets
    ragged_chunk: int = 256
    # weight-only quantization on load: "int8" | "fp8" | None
    quantization: Optional[str] = None
    # KV pool storage: None = activation dtype, "int8" (with scale pools)
    # or "fp8" (e4m3)
    kv_cache_dtype: Optional[str] = None
    # spill tiers: host-RAM blocks of the L2 tier (0 disables it) and an L3
    # store (``runtime/kv_cache.py`` RemoteKVStore-like, e.g. redis_kv's)
    spill_host_blocks: int = 0
    spill_remote_store: Optional[Any] = None
    # engine-integrated speculative decoding (chain drafts, one verify
    # pass a round); None = plain decode
    speculative: Optional[SpecDecodeConfig] = None
    # sub-wave admission: ``submit_batch`` splits a wave into chunks of at
    # most this many sequences, each prefilled by a narrow forward, so the
    # first chunk samples its first tokens after one chunk's prefill
    # instead of the whole wave's. 0 = the whole wave in one forward.
    admission_subwave: int = 0
    # decode steps run between sub-waves, so slots already generating
    # advance instead of stalling for the whole admission. 0 = none (every
    # narrow forward is enqueued back to back)
    admission_interleave_steps: int = 0
    # keep the quantized weight tree in this directory after its first
    # build (one safetensors file a model, quantization, dtype and weight
    # source: ``models/loader.py`` ``quant_cache_path``), and read it from
    # there on later loads instead of quantizing again
    quant_cache_dir: Optional[str] = None
    # long-prompt prefill on a mesh with a ``seq`` axis: a fresh prompt
    # longer than the largest prefill bucket runs ONE seq-parallel pass,
    # ring or ulysses attention over the ranks (parallel/ring_attention.py)
    seq_parallel_impl: str = "ring"   # ring | ulysses
    # shard the KV pools' BLOCK axis over ``seq``: each rank holds 1/seq of
    # the blocks and reads merge partial softmaxes across the ranks; the
    # pool is rounded up to a multiple of the axis
    kv_seq_sharded: bool = False

    @property
    def max_blocks_per_seq(self) -> int:
        return -(-self.max_seq_len // self.block_size)

    def resolved_num_blocks(self) -> int:
        if self.num_blocks is not None:
            return self.num_blocks
        worst = self.max_batch_size * self.max_blocks_per_seq
        return int(worst * 1.5) + 1  # +1: reserved pad block 0


@dataclass
class _Slot:
    request: InferenceRequest
    seq_id: str
    prompt_len: int
    generated: List[int] = field(default_factory=list)
    cached_tokens: int = 0
    # TTFT clock origin: the REQUEST's arrival time, not slot-bind time —
    # queue wait is part of time-to-first-token
    start_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_reason: Optional[str] = None
    # True while a chunk-interleaved admission is mid-prefill: the slot's KV
    # is incomplete and its last_token is garbage, so decode rounds MUST
    # skip it until the final chunk samples the first token
    prefilling: bool = False

    def __post_init__(self) -> None:
        if self.start_time is None:
            self.start_time = self.request.arrival_time


@dataclass
class ChunkedAdmission:
    """In-flight chunk-interleaved admission (``submit_chunked_start``):
    the scheduler runs one prefill chunk at a time (``submit_chunked_step``
    or as rows of a ``ragged_round``) between decode rounds."""

    request: InferenceRequest
    slot: int
    seq_id: str
    fresh: List[int]
    off: int
    mode: str
    done: bool = False


class RequestOverLength(ValueError):
    """Prompt + max_new_tokens exceeds the engine's ``max_seq_len`` — a
    per-request input error, not a capacity condition. Carries the
    machine-readable ``error_code`` the serving layers thread through."""

    error_code = "over_length"


class EngineStateLost(RuntimeError):
    """A device round failed part-way through updating the KV pools in
    place; the engine refuses further device work rather than serve from
    half-written state."""


@dataclass
class KVPressure:
    """KV-block exhaustion observed at a step boundary — a SCHEDULING event,
    not an error. ``source``: "decode" means active slots could not reserve
    their next step's blocks (progress requires freeing blocks — preempt
    someone); "admission" means new work could not allocate."""

    source: str
    slots: List[int] = field(default_factory=list)   # slots that froze
    requests: int = 0                                # admissions deferred


#: wire version of the portable checkpoint format (same as the JAX package)
CHECKPOINT_WIRE_VERSION = 1


@dataclass
class PreemptedSequence:
    """A running sequence frozen by :meth:`TorchEngine.preempt_slot`: the
    original request, every token generated so far and the slot's key
    words — enough for :meth:`TorchEngine.resume` to continue it
    byte-identically (greedy). Device blocks are released at preempt time;
    full blocks park in the prefix cache so resume restores them through
    the radix index instead of recomputing the whole context."""

    request: InferenceRequest
    prompt_len: int
    generated: List[int]
    slot_key: Tuple[int, int]             # key words (hi, lo)
    start_time: Optional[float]
    first_token_time: Optional[float]
    cached_tokens: int
    preempt_count: int = 0                # maintained by the scheduler layer

    @staticmethod
    def _wire_crc(data: Dict[str, Any]) -> int:
        body = {k: v for k, v in data.items() if k != "crc"}
        return zlib.crc32(
            json.dumps(body, sort_keys=True, separators=(",", ":")).encode()
        )

    def to_wire(self) -> Dict[str, Any]:
        """Versioned JSON-safe checkpoint with a CRC over its body."""
        r = self.request
        data = {
            "v": CHECKPOINT_WIRE_VERSION,
            "request": {
                "request_id": r.request_id,
                "model": r.model,
                "prompt_token_ids": list(r.prompt_token_ids or []),
                "sampling": r.sampling.to_dict(),
                "priority": r.priority,
                "session_id": r.session_id,
                **({"deadline_at": r.deadline_at}
                   if r.deadline_s is not None else {}),
            },
            "prompt_len": self.prompt_len,
            "generated": list(self.generated),
            "slot_key": [int(self.slot_key[0]), int(self.slot_key[1])],
            "start_time": self.start_time,
            "first_token_time": self.first_token_time,
            "cached_tokens": self.cached_tokens,
            "preempt_count": self.preempt_count,
        }
        data["crc"] = self._wire_crc(data)
        return data

    @classmethod
    def from_wire(cls, data: Dict[str, Any]) -> "PreemptedSequence":
        if not isinstance(data, dict):
            raise ValueError("checkpoint must be a dict")
        ver = data.get("v")
        if ver != CHECKPOINT_WIRE_VERSION:
            raise ValueError(
                f"unsupported checkpoint version {ver!r} (this build "
                f"speaks v{CHECKPOINT_WIRE_VERSION})"
            )
        if "crc" in data and int(data["crc"]) != cls._wire_crc(data):
            raise ValueError("checkpoint integrity check failed (bad crc)")
        r = data["request"]
        request = InferenceRequest(
            request_id=r["request_id"],
            model=r.get("model"),
            prompt_token_ids=[int(t) for t in (r.get("prompt_token_ids")
                                               or [])],
            sampling=SamplingParams.from_dict(r["sampling"]),
            priority=int(r.get("priority") or 0),
            session_id=r.get("session_id"),
        )
        if r.get("deadline_at") is not None:
            request.deadline_s = max(
                0.0, float(r["deadline_at"]) - request.arrival_time
            )
        key = data.get("slot_key") or [0, 0]
        return cls(
            request=request,
            prompt_len=int(data["prompt_len"]),
            generated=[int(t) for t in (data.get("generated") or [])],
            slot_key=(int(key[0]), int(key[1])),
            start_time=data.get("start_time"),
            first_token_time=data.get("first_token_time"),
            cached_tokens=int(data.get("cached_tokens") or 0),
            preempt_count=int(data.get("preempt_count") or 0),
        )


@dataclass
class HostPages:
    """A batched gather of KV pages on the host (:meth:`TorchEngine.gather_pages`):
    ``pages`` ``[n, L, 2, Hkv, Bk, D]`` in the pool's dtype (K and V on
    axis 2, the handoff wire's layout), ``scales`` ``[n, L, 2, Bk]`` bf16
    for an int8 pool. Pinned when the pools are on a card; ``ready`` is the
    CUDA event of the copies while they may still run."""

    pages: torch.Tensor
    scales: Optional[torch.Tensor] = None
    ready: Optional[Any] = None

    def wait(self) -> "HostPages":
        if self.ready is not None:
            self.ready.synchronize()
            self.ready = None
        return self


def resolve_device(device: Any = "cuda") -> torch.device:
    """The engine's device: CUDA unless the caller asks for the CPU. A CUDA
    request on a machine without CUDA raises — the engine never carries on
    on the CPU by itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the engine runs on a CUDA device by "
            "default; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def engine_params(model_cfg: ModelConfig, cfg: EngineConfig,
                  checkpoint_path: Optional[str], seed: int, device: torch.device,
                  shard: Optional[Tuple[int, int]] = None) -> llama.Params:
    """The engine's weights when the caller gives none: the quantized-weight
    cache when ``EngineConfig.quant_cache_dir`` holds this tree, else a
    checkpoint or a random init from ``seed`` (``models/loader.py``),
    written to the cache after a quantized build. ``shard=(rank, tp)``:
    rank ``rank``'s tensor-parallel part of the same tree; a sharded build
    reads the cache but does not write it (no rank holds the whole tree)."""
    mode = cfg.quantization
    cache = (quant_cache_path(cfg.quant_cache_dir, model_cfg.name, mode, cfg.dtype,
                              checkpoint_path, seed)
             if cfg.quant_cache_dir and mode is not None else None)
    params = (load_quant_cache(cache, model_cfg, device, shard)
              if cache is not None else None)
    if params is None:
        params = load_or_init_params(
            model_cfg, checkpoint_path, dtype=llama.torch_dtype(cfg.dtype), seed=seed,
            device=device, quantization=mode, shard=shard,
        )
        if cache is not None and shard is None:
            save_quant_cache(cache, params)
    return params


def check_tp(model_cfg: ModelConfig, cfg: EngineConfig, tp: int) -> None:
    """Refuse a tensor-parallel configuration this engine cannot run, with
    the JAX engine's reasons (KV heads and experts must divide over the
    ranks; speculative decoding is single-device)."""
    if model_cfg.num_kv_heads % tp:
        raise ValueError(f"num_kv_heads {model_cfg.num_kv_heads} not divisible by "
                         f"model axis {tp}")
    if model_cfg.num_experts and model_cfg.num_experts % tp:
        raise ValueError(f"num_experts {model_cfg.num_experts} not divisible by "
                         f"model axis {tp} (EP shards experts)")
    if model_cfg.num_heads % tp or model_cfg.intermediate_size % tp:
        raise ValueError(f"num_heads {model_cfg.num_heads} and intermediate_size "
                         f"{model_cfg.intermediate_size} must divide over model axis {tp}")
    if cfg.speculative is not None:
        raise ValueError("speculative decode mode is single-chip: drop the mesh "
                         "or EngineConfig.speculative")


def check_seq(model_cfg: ModelConfig, cfg: EngineConfig, seq: int) -> None:
    """Refuse a sequence-parallel configuration with the JAX engine's
    reasons: ``kv_seq_sharded`` needs a seq axis above 1 and no sliding
    window, Ulysses needs the KV heads to divide over the axis, and
    speculative decoding is single-chip."""
    if cfg.seq_parallel_impl not in ("ring", "ulysses"):
        raise ValueError(f"seq_parallel_impl {cfg.seq_parallel_impl!r}: use 'ring' or "
                         "'ulysses'")
    if cfg.kv_seq_sharded:
        if seq <= 1:
            raise ValueError("kv_seq_sharded needs a mesh with a seq axis > 1")
        if model_cfg.sliding_window is not None:
            raise ValueError("kv_seq_sharded does not support sliding-window models")
    if seq > 1:
        if cfg.seq_parallel_impl == "ulysses" and model_cfg.num_kv_heads % seq:
            raise ValueError(f"ulysses needs num_kv_heads {model_cfg.num_kv_heads} "
                             f"divisible by the seq axis {seq} (use ring otherwise)")
        if cfg.speculative is not None:
            raise ValueError("speculative decode mode is single-chip: drop the mesh "
                             "or EngineConfig.speculative")


class TorchEngine:
    """Paged-KV serving engine for one model on one device, or on the
    devices of its tensor-parallel ranks."""

    def __init__(
        self,
        model_cfg: ModelConfig | str,
        engine_cfg: Optional[EngineConfig] = None,
        params: Optional[llama.Params] = None,
        seed: int = 0,
        eos_token_id: Optional[int] = None,
        device: Any = "cuda",
        checkpoint_path: Optional[str] = None,
        rank_devices: Optional[Sequence[Any]] = None,
        mesh: Optional[MeshPlan] = None,
    ) -> None:
        """``params``: a params tree in the JAX package's layout, already
        on ``device`` (``models.convert.params_from_numpy`` builds one).
        ``checkpoint_path``: an HF safetensors directory, loaded by
        ``models/loader.py`` straight onto ``device`` (an orbax checkpoint
        is refused: it is JAX-only). With neither, a random init from
        ``seed``; giving both is an error. With
        ``EngineConfig.quantization`` the matmul weights are quantized on
        load (or, with ``EngineConfig.quant_cache_dir``, read already
        quantized from the cache file an earlier load wrote): a checkpoint slice by slice as it is read (the full-precision
        leaf is never built), a random init leaf by leaf as it is consumed
        (the peak is the full-precision tree plus one quantized leaf), or,
        where that tree exceeds the device, drawn quantized one layer slice
        at a time (``models/loader.py`` ``init_route``); a caller's tree is
        left as it was. A full-precision tree larger than the device is
        refused before anything is allocated. MoE (Mixtral) layers serve on
        every path; ``forward_chunk`` takes them.

        ``rank_devices``: one device a tensor-parallel rank (the first is
        this engine's, and ``device`` is ignored); with more than one, the
        engine starts ranks 1..tp-1 as processes (``runtime/tp.py``), each
        holding its shard, and every device call runs on all of them. A
        device may repeat (two ranks on one card, over gloo). ``params``
        are then quantized whole here and cut for each rank; without
        ``params`` each rank builds its own shard of the same tree.

        ``mesh``: the axes the ranks run over, ``MeshPlan(model=n)`` (the
        default for n ``rank_devices``), ``MeshPlan(seq=n)``: the same
        ranks with the whole tree each, the sequence axis of the JAX
        engine's mesh (``EngineConfig.seq_parallel_impl``,
        ``kv_seq_sharded``), or ``MeshPlan(seq=s, model=m)`` on s*m
        ``rank_devices``, rank ``i*m + j`` at seq row i, model column j."""
        devices = [resolve_device(d) for d in (rank_devices or [device])]
        self.device = devices[0]
        self.rank_devices = devices
        # the JAX engine's mesh validations in its order: no data axis, then
        # the model axis (KV heads, experts), then the seq axis
        self.seq, self.tp = (mesh or MeshPlan(model=len(devices))).engine_axis()
        n = self.seq * self.tp
        if n != len(devices):
            axes = (f"seq x model axes of {self.seq} x {self.tp} need" if min(self.seq, self.tp) > 1
                    else f"{AXIS_SEQ if self.seq > 1 else AXIS_MODEL} axis of {n} needs")
            raise ValueError(f"the mesh's {axes} {n} rank devices, got {len(devices)}")
        self.model_cfg = (
            get_model_config(model_cfg) if isinstance(model_cfg, str) else model_cfg
        )
        self.cfg = engine_cfg or EngineConfig()
        if self.cfg.speculative is not None:
            self.cfg.speculative.validate(self.cfg)
        if self.tp > 1:
            check_tp(self.model_cfg, self.cfg, self.tp)
        check_seq(self.model_cfg, self.cfg, self.seq)
        if self.cfg.kv_seq_sharded and self.cfg.resolved_num_blocks() % self.seq:
            # round the pool UP so the block axis shards evenly
            self.cfg = replace(self.cfg, num_blocks=seq_num_blocks(
                self.cfg.resolved_num_blocks(), self.seq))
        self.dtype = llama.torch_dtype(self.cfg.dtype)
        self.kv_dtype = _resolve_kv_dtype(self.cfg.kv_cache_dtype, self.dtype)
        if self.device.type == "cuda":
            check_kernels_take(self.model_cfg, self.dtype, self.kv_dtype)
        mode = self.cfg.quantization
        if mode is not None and mode not in QUANT_MODES:
            raise ValueError(f"unknown quantization {mode!r}; use {QUANT_MODES}")
        if params is not None and checkpoint_path:
            raise ValueError("give params or checkpoint_path, not both")
        self._ranks: Optional[TPRanks] = None
        self._tp_group: Optional[TPGroup] = None
        # rank 0's place on the mesh, and its groups and pools
        self._layout = RankLayout(0, self.seq, self.tp, self.cfg.kv_seq_sharded)
        self._roles = RankRoles(self._layout, None, None, None, None)
        # the exception of a device round that failed mid-update (pools may
        # be half-written); set once, never cleared
        self._failed: Optional[BaseException] = None
        shard = (0, self.tp) if self.tp > 1 else None
        if params is not None:
            params = quantize_params(params, mode)
            if n > 1:
                # weights cut over model, replicated over seq: rank i*m + j
                # holds cut j
                cuts = ([tree_to(shard_tree(params, j, self.tp), "cpu")
                         for j in range(self.tp)] if shard is not None
                        else [tree_to(params, "cpu")])
                shards = [None] + [cuts[r % self.tp] for r in range(1, n)]
                if shard is not None:
                    params = shard_tree(params, 0, self.tp)
        if len(devices) > 1:
            self._start_ranks(devices, seed, checkpoint_path,
                              shards if params is not None else None)
        try:
            if params is None:
                params = engine_params(self.model_cfg, self.cfg, checkpoint_path, seed,
                                       self.device, shard)
            self.params = params
            self.num_blocks = self.cfg.resolved_num_blocks()
            self._roles = RankRoles.build(self._layout, self._tp_group, self.cfg,
                                          self.num_blocks)
            held = self._roles.held_blocks
            held = self.num_blocks if held is None else held
            self.kv = llama.init_kv_pools(
                self.model_cfg, held, self.cfg.block_size, self.kv_dtype,
                self.device, tp=self.tp,
            )
            if self._ranks is not None:
                self._ranks.wait_ready()
        except BaseException:
            self.shutdown()
            raise
        host_store = (
            HostKVStore(self.cfg.spill_host_blocks)
            if self.cfg.spill_host_blocks > 0 else None
        )
        spill = host_store is not None or self.cfg.spill_remote_store is not None
        self.manager = PagedKVCacheManager(
            self.num_blocks,
            self.cfg.block_size,
            enable_prefix_cache=self.cfg.enable_prefix_cache,
            host_store=host_store,
            remote_store=self.cfg.spill_remote_store,
            spill_on_evict=spill,
            kv_dtype=self.kv_dtype,
            page_shape=self._page_layout()[0],
        )
        self.eos_token_id = eos_token_id

        b, m = self.cfg.max_batch_size, self.cfg.max_blocks_per_seq
        self.slots: List[Optional[_Slot]] = [None] * b
        self._block_tables = np.zeros((b, m), dtype=np.int32)
        self._kv_lens = np.zeros((b,), dtype=np.int32)
        self._last_tokens = np.zeros((b,), dtype=np.int32)
        self._temps = np.zeros((b,), dtype=np.float32)
        self._top_ks = np.zeros((b,), dtype=np.int32)
        self._top_ps = np.ones((b,), dtype=np.float32)
        self._stop_ids = np.full((b, MAX_STOP_IDS), -1, dtype=np.int32)
        # one key per slot: a seeded request's random stream is independent
        # of which other requests share the batch
        self._slot_keys = np.zeros((b, 2), dtype=np.uint32)
        self._host_rng = np.random.default_rng(seed + 0x5EED)
        # pending KV-pressure signal (set at step boundaries, consumed by
        # the scheduler layer via take_pressure)
        self._pressure: Optional[KVPressure] = None
        self.stats: Dict[str, Any] = {
            "requests": 0, "completed": 0, "generated_tokens": 0,
            "prefill_tokens": 0, "prefill_calls": 0, "decode_calls": 0,
            "preemptions": 0, "resumes": 0, "kv_pressure_events": 0,
            "ragged_rounds": 0,
        }
        # integrated speculative decoding: the draft head's weights and
        # each slot's last verified hidden (on the device between rounds;
        # zeros for a fresh slot — its first round drafts garbage and
        # accepts ~nothing, which is correct since emission is verified)
        self._draft_params: Optional[Dict[str, torch.Tensor]] = None
        self._spec_h: Optional[torch.Tensor] = None
        self._spec_h_zero: set = set()
        if self.cfg.speculative is not None:
            sp = self.cfg.speculative
            if sp.draft_params is not None:
                self._draft_params = sp.draft_params
            else:
                gen = torch.Generator(device=self.device).manual_seed(sp.draft_seed)
                self._draft_params = init_draft_params(
                    self.model_cfg, gen, dtype=self.dtype, device=self.device)
            # adaptive depth: a per-slot EMA of the accepted length (host
            # float arithmetic over integer accept counts: same seed → same
            # K schedule); a fresh slot starts optimistic at K
            self._spec_k_ema = np.full((b,), float(sp.num_draft_tokens))
            # the oracle's fractional-rate accumulator, per slot
            self._spec_oracle_acc = np.zeros((b,))
            # test hook: a list collects each dispatch's [(slot, k), ...]
            self.spec_k_trace: Optional[List[Any]] = None
            self.stats.update({
                "spec_steps": 0, "spec_slot_steps": 0, "spec_drafted": 0,
                "spec_accepted": 0, "spec_emitted": 0,
            })

    # ------------------------------------------------- tensor-parallel ranks

    def _start_ranks(self, devices: Sequence[torch.device], seed: int,
                     checkpoint_path: Optional[str], shards: Optional[list]) -> None:
        """Start ranks 1..n-1 and join their group as rank 0. The CUDA
        kernels are built here first, once, so the ranks only load them."""
        if self.device.type == "cuda":
            _build.build()
        spec = RankSpec(
            model_cfg=self.model_cfg, engine_cfg=self.cfg,
            devices=[str(d) for d in devices], store_path=rendezvous_path(),
            timeout_s=tp_ranks.TIMEOUT_S, seed=seed,
            checkpoint_path=checkpoint_path, num_threads=torch.get_num_threads(),
            shape=(self.seq, self.tp),
        )
        self._ranks = TPRanks(spec, shards)
        self._tp_group = self._ranks.group
        # a dropped engine still stops its ranks (at exit at the latest)
        self._rank_finalizer = weakref.finalize(self, self._ranks.close)

    def shutdown(self) -> None:
        """Stop the tensor-parallel ranks (idempotent; nothing to do for a
        one-device engine). Device work after it raises."""
        if self._ranks is not None:
            self._ranks.close()
            if self._failed is None:
                self._failed = EngineStateLost("the engine was shut down")

    @property
    def _mirror(self) -> List[int]:
        """The ranks that run every device op with rank 0: every rank on
        the ``model`` axis and with block-sharded pools; with replicated
        pools on a ``seq`` axis only seq row 0's ``model`` peers (the rows
        hold no pages and join only the seq-parallel prefill)."""
        return [] if self._ranks is None else self._layout.mirrors()

    @property
    def _seq(self) -> Optional[SeqRank]:
        """Rank 0 of the seq axis (None at seq 1)."""
        return self._roles.seq

    @property
    def _model_group(self) -> Optional[TPGroup]:
        """Rank 0's ``model`` group (None at model 1)."""
        return self._roles.tp

    def refuse_other_devices(self, what: str, other: "TorchEngine") -> None:
        """Refuse ``what`` between this engine and ``other`` when they do
        not sit on the same devices (the JAX engine's condition for a
        device-side page move): a mesh engine's ranks on devices the other
        engine's ranks do not share."""
        mine = {str(d) for d in self.rank_devices}
        theirs = {str(d) for d in other.rank_devices}
        if self._ranks is not None and mine != theirs:
            raise NotImplementedError(
                f"{what} is not supported between engines on different devices "
                f"(tp={self.tp}, seq={self.seq}: {sorted(mine)} and {sorted(theirs)}); "
                "use the wire path (export_slot_kv / StreamedExport)")

    def rank_launch_counts(self) -> List[Dict[str, int]]:
        """Each rank's kernel launch counts (``ops.paged_attention
        .launch_counts``), rank 0's first."""
        counts = [launch_counts()]
        if self._ranks is not None:
            counts += self._ranks.query("counts")
        return counts

    def reset_rank_launch_counts(self) -> None:
        reset_launch_counts()
        if self._ranks is not None:
            self._ranks.send("reset_counts")

    def rank_pools(self, names: Sequence[str] = ("k_scale", "v_scale")
                   ) -> List[Dict[str, np.ndarray]]:
        """Each rank's pools ``names`` as raw bits on the host, rank 0's
        first (a bitwise check that replicated scale pools agree)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        out = [{k: tensor_bits(self.kv[k]) for k in names}]
        if self._ranks is not None:
            out += self._ranks.query("pools", names=tuple(names))
        return out

    def rank_memory(self) -> List[Dict[str, int]]:
        """Each rank's pool bytes, and on a card its allocated and peak
        device bytes, rank 0's first."""
        own = tp_ranks.device_memory(self.device, self.kv)
        return [own] + (self._ranks.query("memory") if self._ranks is not None else [])

    def rank_collective_stats(self, reset: bool = False,
                              axis: Optional[str] = None) -> List[Dict[str, float]]:
        """Each rank's collective counts and host seconds, rank 0's first:
        of the group over every rank, or with ``axis`` (``"model"`` /
        ``"seq"``) of each rank's sub-group on that axis."""
        if self._tp_group is None:
            return []
        group = self._tp_group if axis is None else self._tp_group.axis_group(axis)
        out = [None if group is None else dict(group.stats)] + \
            self._ranks.query("stats", axis=axis)
        if reset:
            self._tp_group.reset_stats()
            self._ranks.send("reset_stats")
        return out

    # ------------------------------------------------------- device helpers

    @contextlib.contextmanager
    def _device_work(self) -> Iterator[None]:
        """Every in-place pool update runs inside this guard: a failure
        marks the engine unusable (and is re-raised), and an unusable
        engine refuses the next round loudly. Under tensor parallelism a
        failure that a rank caused (it raised or exited) is raised as
        :class:`EngineStateLost` naming the rank."""
        if self._failed is not None:
            raise EngineStateLost(
                "engine state lost: an earlier device round failed while "
                f"updating the KV pools in place ({self._failed!r}); "
                "rebuild the engine"
            )
        try:
            yield
        except BaseException as exc:
            self._failed = exc
            # the draft hidden is device state of the failed round too
            self._spec_h = None
            self._spec_h_zero.clear()
            failed = exc if isinstance(exc, RankFailed) else (
                self._ranks.failure() if self._ranks is not None else None)
            if failed is not None:
                self._failed = EngineStateLost(
                    f"engine state lost: {failed}; rebuild the engine")
                raise self._failed from exc
            raise

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.tensor(arr, device=self.device)

    def _forward(self, toks_pos: np.ndarray, tables: np.ndarray,
                 lens: np.ndarray, *, with_logits: bool = True,
                 allow_fused: bool = True) -> Optional[torch.Tensor]:
        """One forward over host-built batch arrays → last-token logits
        [B, V] (None when ``with_logits`` is False). Under tensor
        parallelism and on block-sharded pools every rank runs it on the
        same arrays; block-sharded pools read through the attention kind
        the arrays call for (``runtime/tp.py`` :func:`attention_kind`)."""
        if self._mirror:
            self._ranks.send("forward", to=self._mirror, toks_pos=toks_pos, tables=tables,
                             lens=lens, allow_fused=allow_fused)
        positions, tables_t, lens_t = (self._tensor(toks_pos[1]), self._tensor(tables),
                                       self._tensor(lens))
        reads = self._roles.read_hooks
        hooks = ({} if reads is None else
                 reads.hooks(attention_kind(toks_pos[1], lens), tables_t, positions, lens_t))
        out = llama.forward_chunk(
            self.model_cfg, self.params, self._tensor(toks_pos[0]), positions, self.kv,
            tables_t, lens_t, block_size=self.cfg.block_size,
            last_only=True, with_logits=with_logits, allow_fused=allow_fused,
            tp=self._model_group, **hooks,
        )
        return None if out.logits is None else out.logits[:, 0, :]

    def _sample(self, logits: torch.Tensor, rows: Sequence[int],
                positions: Any, mode: str) -> torch.Tensor:
        """Sample one token per row of ``logits`` ([R, V]); ``rows`` are the
        slots whose sampling params / keys apply, ``positions`` the
        absolute positions folded into each row's random stream."""
        if mode == "greedy":
            return greedy_tokens(logits)
        idx = list(rows)
        return sample_tokens_per_slot(
            logits, self._slot_keys[idx], positions,
            self._tensor(self._temps[idx]), self._tensor(self._top_ks[idx]),
            self._tensor(self._top_ps[idx]),
        )

    def _decode_mode(self) -> str:
        for i, s in enumerate(self.slots):
            if s is not None and s.finish_reason is None \
                    and not s.prefilling and self._temps[i] > 0:
                return "mixed"
        return "greedy"

    def _apply_pending(self) -> None:
        """Apply the block manager's queued device ops before the next
        forward reads the pages, in the JAX engine's order: spill
        DOWNLOADS first (an evicted block's id is about to be reused), then
        copy-on-write page copies, then spill-restore uploads (all layers,
        K and V, and the scales of int8 pools — a page without its scales
        is garbage)."""
        ops = self.manager.take_pending_ops()
        if ops.empty:
            return
        with self._device_work():
            if ops.downloads:
                pages = self.pull_pages([b for b, _ in ops.downloads])
                for (_, key), (page, scale) in zip(ops.downloads, pages):
                    self.manager.store_spilled(key, page, scale)
            if ops.copies:
                if self._mirror:
                    self._ranks.send("copy", to=self._mirror,
                                     src=np.array([s for s, _ in ops.copies]),
                                     dst=np.array([d for _, d in ops.copies]))
                src = torch.tensor([s for s, _ in ops.copies],
                                   dtype=torch.long, device=self.device)
                dst = torch.tensor([d for _, d in ops.copies],
                                   dtype=torch.long, device=self.device)
                copy_blocks(self.kv, src, dst, self._roles.ops,
                            self._layout.serving_shape, 0, self._pool_blocks)
            if ops.uploads:
                scales = dict(ops.scale_uploads)
                self.push_pages([b for b, _ in ops.uploads],
                                [p for _, p in ops.uploads],
                                [scales.get(b) for b, _ in ops.uploads])

    # -- spill transfers: one page is [L, 2, Hkv, Bk, D] (K, V on axis 1),
    #    an int8 pool's scales [L, 2, Bk]; both move as the bytes of one
    #    [n, page + scale bytes] buffer, pinned on the host side

    def _page_layout(self) -> Tuple[Tuple[int, ...], int, Optional[Tuple[int, ...]], int]:
        """(page shape, page bytes, scale shape or None, scale bytes) of a
        whole page, every KV head, whatever rank 0 holds of it."""
        return page_bytes(self.model_cfg, self.kv, self.cfg.block_size)

    @property
    def _pool_blocks(self) -> Optional[Tuple[int, int]]:
        """The global blocks rank 0's pools hold; None: all of them."""
        return self._roles.pool_blocks

    def _staging(self, n: int, nbytes: int) -> torch.Tensor:
        """Host staging for n pages: pinned when the pools are on a card
        (PyTorch's pinned allocator holds a block until the copies that
        used it have run)."""
        return torch.empty((n, nbytes), dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")

    def gather_pages(self, bids: Sequence[int], wait: bool = True) -> "HostPages":
        """The pages (and int8 scales) of ``bids`` on the host as one block
        each: one gather per pool on the device, one device-to-host copy
        into pinned staging. ``wait=False`` leaves the copies enqueued on
        the engine's stream behind a CUDA event (:meth:`HostPages.wait`
        before reading); the default waits on that event only, not on the
        whole stream.

        On a mesh whose ranks hold parts of each page (the ``model`` axis:
        their KV heads; block-sharded pools: their blocks) every rank is
        sent the gather and the parts meet through the group
        (``runtime/tp.py`` ``gather_blocks``): the host layout is the
        single-device one."""
        idx = torch.tensor(list(bids), dtype=torch.long, device=self.device)

        def to_host(dev: torch.Tensor) -> torch.Tensor:
            if self.device.type != "cuda":
                return dev
            host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
            host.copy_(dev, non_blocking=True)
            return host

        if self._mirror:
            with self._device_work():
                self._ranks.send("gather", to=self._mirror,
                                 bids=np.asarray(list(bids), np.int64))
                pages, scales = gather_blocks(self.kv, idx, self._roles.ops,
                                              self._layout.serving_shape, self._pool_blocks)
        else:
            pages, scales = tp_ranks.local_pages(self.kv, idx, None)
        out = HostPages(to_host(pages), None if scales is None else to_host(scales))
        if self.device.type == "cuda":
            out.ready = torch.cuda.Event()
            out.ready.record(torch.cuda.current_stream(self.device))
        return out.wait() if wait else out

    def pull_pages(self, bids: Sequence[int]
                   ) -> List[Tuple[torch.Tensor, Optional[torch.Tensor]]]:
        """The pages (and int8 scales) of ``bids`` as pageable host tensors
        in the port's layout, one per block: :meth:`gather_pages`, then one
        host copy per page (the L2 tier keeps them; pinning every entry
        would pin gigabytes)."""
        block = self.gather_pages(bids)
        return [(block.pages[i].clone(),
                 None if block.scales is None else block.scales[i].clone())
                for i in range(len(bids))]

    def push_pages(self, bids: Sequence[int], pages: Sequence[torch.Tensor],
                   scales: Sequence[Optional[torch.Tensor]]) -> None:
        """Write host pages (and int8 scales) into blocks ``bids`` of the
        pools: the pages stacked into pinned staging, one host-to-device
        copy, then one ``index_copy_`` per pool on the engine's stream. On
        a mesh whose ranks hold parts of each page the staged pages are
        broadcast to every rank, and each writes its heads or its blocks
        (``runtime/tp.py`` ``write_blocks``)."""
        layout = self._page_layout()
        shape, pbytes, sshape, sbytes = layout
        n = len(bids)
        host = self._staging(n, pbytes + sbytes)
        for i, page in enumerate(pages):
            if page.dtype != self.kv["k"].dtype or tuple(page.shape) != shape:
                raise ValueError(f"restored page {page.dtype} {tuple(page.shape)} "
                                 f"does not fit the pool's {self.kv['k'].dtype} {shape}")
            host[i, :pbytes] = page.contiguous().reshape(-1).view(torch.uint8)
            if sshape is not None:
                if scales[i] is None:
                    raise ValueError("an int8 page restored without its scales")
                host[i, pbytes:] = scales[i].contiguous().reshape(-1).view(torch.uint8)
        dev = host.to(self.device, non_blocking=True)
        idx = torch.tensor(list(bids), dtype=torch.long, device=self.device)
        if self._mirror:
            self._ranks.send("push", to=self._mirror, bids=np.asarray(list(bids), np.int64))
            self._roles.ops.broadcast(dev, src=0)
        pages, scales = unpack_pages(dev, self.kv, layout)
        write_blocks(self.kv, idx, pages, scales, 0, self._pool_blocks)

    def _bucket_len(self, n: int) -> int:
        for b in self.cfg.prefill_buckets:
            if b >= n:
                return b
        raise ValueError(
            f"prompt chunk of {n} tokens exceeds largest prefill bucket "
            f"{self.cfg.prefill_buckets[-1]}"
        )

    # -------------------------------------------------------- slot API

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    @property
    def num_active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    # ------------------------------------------- KV pressure + preemption

    def _signal_pressure(self, source: str, slots: Sequence[int] = (),
                         requests: int = 0) -> None:
        """Record a step-boundary KV-pressure event for the scheduler; one
        ``KVPressure`` accumulates per round and "decode" outranks
        "admission"."""
        if self._pressure is None:
            self._pressure = KVPressure(source=source)
            self.stats["kv_pressure_events"] += 1
        elif source == "decode":
            self._pressure.source = "decode"
        for sl in slots:
            if sl not in self._pressure.slots:
                self._pressure.slots.append(sl)
        self._pressure.requests += requests

    def request_fits_pool(self, request: InferenceRequest) -> bool:
        """Can the request's PROMPT (plus its pending first token) fit an
        idle pool? Deliberately not a worst-case (prompt + max_new_tokens)
        test: growth beyond the pool is a dynamic condition the preemption
        machinery absorbs."""
        return self._fits_empty_pool(len(request.prompt_token_ids or []) + 1)

    def _fits_empty_pool(self, tokens: int) -> bool:
        """One fit rule for admission and resume: ``tokens`` of context
        (plus the verify window when the engine speculates) against the
        whole pool minus the pad block."""
        if self.cfg.speculative is not None:
            tokens += self.cfg.speculative.num_draft_tokens + 1
        need = -(-tokens // self.cfg.block_size)
        return need <= self.num_blocks - 1   # block 0 is the reserved pad

    def resume_fits_pool(self, pre: "PreemptedSequence") -> bool:
        return self._fits_empty_pool(pre.prompt_len + len(pre.generated) + 1)

    def take_pressure(self) -> Optional[KVPressure]:
        """Consume the pending pressure signal (None when the last round
        ran unpressured)."""
        p, self._pressure = self._pressure, None
        return p

    def snapshot_slot(self, slot: int) -> PreemptedSequence:
        """Checkpoint a LIVE slot without disturbing it: the state
        :meth:`preempt_slot` captures, while the slot keeps decoding — the
        worker's failover checkpoint, which :meth:`resume` on another
        engine (or the JAX package's) continues. ``generated`` may hold the
        pending token (sampled, KV unwritten); resume recomputes the whole
        list as prompt suffix, so a greedy continuation is the undisturbed
        one where that recompute rounds as the decode steps did (in f32 on
        the CPU; on the card the prefill and decode kernels round
        differently, and a near-tie can resolve the other way). Reads host
        state only, so it may run beside the engine's own thread: a torn
        read shows up as another request's id, which callers check."""
        s = self.slots[slot]
        if s is None:
            raise ValueError(f"slot {slot} is empty")
        if s.prefilling:
            raise ValueError(f"slot {slot} is mid-prefill")
        if s.finish_reason is not None:
            raise ValueError(f"slot {slot} already finished")
        return PreemptedSequence(
            request=s.request,
            prompt_len=s.prompt_len,
            generated=list(s.generated),
            slot_key=(int(self._slot_keys[slot, 0]),
                      int(self._slot_keys[slot, 1])),
            start_time=s.start_time,
            first_token_time=s.first_token_time,
            cached_tokens=s.cached_tokens,
        )

    def preempt_slot(self, slot: int) -> PreemptedSequence:
        """Freeze a RUNNING sequence and release its device blocks; full
        blocks park in the prefix cache for :meth:`resume`. The pending
        token (sampled, KV not yet written) is dropped from the manager's
        token log first, so only fully written blocks are cached; it stays
        in ``generated`` and is recomputed by the resume prefill."""
        s = self.slots[slot]
        if s is None:
            raise ValueError(f"slot {slot} is empty")
        if s.prefilling:
            raise ValueError(
                f"slot {slot} is mid-prefill (chunked admission) — abort it "
                "with abort_chunked instead of preempting"
            )
        if s.finish_reason is not None:
            raise ValueError(
                f"slot {slot} already finished ({s.finish_reason}) — use "
                "finish_slot"
            )
        seq = self.manager.seq_tokens[s.seq_id]
        committed = int(self._kv_lens[slot])
        while len(seq) > committed:
            seq.pop()
        self.manager.trim_reserved(s.seq_id)
        pre = self.snapshot_slot(slot)
        self.manager.free_sequence(s.seq_id, cache=True)
        self.slots[slot] = None
        self._kv_lens[slot] = 0
        if self.cfg.speculative is not None:
            self._spec_h_zero.add(slot)
        self.stats["preemptions"] += 1
        return pre

    def resume(self, pre: PreemptedSequence,
               slot: Optional[int] = None) -> int:
        """Re-admit a preempted sequence through the normal allocation +
        prefill path: the resume prompt is the original prompt plus every
        generated token, the prefix cache restores what it still holds and
        the prefill recomputes the rest. Raises OutOfBlocksError (state
        untouched) when the pool still cannot hold the sequence."""
        slot = self.submit(self._resume_request(pre), slot=slot)
        self._restore_resumed(slot, pre)
        return slot

    def resume_chunked_start(self, pre: PreemptedSequence,
                             slot: Optional[int] = None) -> ChunkedAdmission:
        """:meth:`resume` as a chunk-interleaved admission: the recompute
        rides the next ragged round(s) as a fresh admission's prompt does,
        so a resume computes what the original admission computed — a
        zero-token checkpoint resumed on the same engine state reproduces
        the original run bit for bit."""
        adm = self.submit_chunked_start(self._resume_request(pre), slot=slot)
        self._restore_resumed(adm.slot, pre)
        return adm

    @staticmethod
    def _resume_request(pre: PreemptedSequence) -> InferenceRequest:
        """The request that re-admits ``pre``: its prompt plus every
        generated token as the prompt, the remaining budget, and the
        checkpoint's key words as the seed."""
        sp = pre.request.sampling
        remaining = sp.max_new_tokens - len(pre.generated)
        if remaining <= 0:
            raise ValueError("preempted sequence has no remaining budget")
        token_ids = list(pre.request.prompt_token_ids or []) + \
            list(pre.generated)
        seed = (pre.slot_key[0] << 32) | pre.slot_key[1]
        return replace(
            pre.request,
            prompt_token_ids=token_ids,
            session_id=None,
            sampling=replace(sp, max_new_tokens=remaining, seed=seed),
        )

    def _restore_resumed(self, slot: int, pre: PreemptedSequence) -> None:
        """Give a re-admitted slot back the checkpoint's request, prompt
        length, generated tokens and times."""
        s = self.slots[slot]
        assert s is not None
        s.request = pre.request
        s.prompt_len = pre.prompt_len
        s.generated = list(pre.generated) + s.generated
        s.cached_tokens = pre.cached_tokens
        s.start_time = pre.start_time
        if pre.first_token_time is not None:
            s.first_token_time = pre.first_token_time
        self.stats["requests"] -= 1          # not a new client request
        self.stats["resumes"] += 1

    def _validate_request(self, request: InferenceRequest) -> List[int]:
        token_ids = request.prompt_token_ids
        if not token_ids:
            raise ValueError("request has no prompt_token_ids")
        if len(token_ids) + request.sampling.max_new_tokens > self.cfg.max_seq_len:
            raise RequestOverLength(
                f"prompt {len(token_ids)} + max_new {request.sampling.max_new_tokens}"
                f" exceeds max_seq_len {self.cfg.max_seq_len}"
            )
        return token_ids

    # ------------------------------------------------------------ admission

    def submit(self, request: InferenceRequest, slot: Optional[int] = None) -> int:
        """Admit a request into a slot: allocate blocks (prefix-cache aware),
        run prefill, sample the first token. Returns the slot index."""
        if slot is None:
            free = self.free_slots()
            if not free:
                raise RuntimeError("no free slots")
            slot = free[0]
        if self.slots[slot] is not None:
            raise RuntimeError(f"slot {slot} busy")
        token_ids = self._validate_request(request)
        seq_id = request.session_id or uuid.uuid4().hex
        try:
            _, cached = self.manager.allocate_sequence(seq_id, token_ids)
        except OutOfBlocksError:
            self._signal_pressure("admission", requests=1)
            raise
        try:
            return self._submit_allocated(request, slot, seq_id, token_ids, cached)
        except Exception as exc:
            self.slots[slot] = None
            self._kv_lens[slot] = 0
            self.manager.free_sequence(seq_id, cache=False)
            if isinstance(exc, OutOfBlocksError):
                self._signal_pressure("admission", requests=1)
            raise

    def submit_batch(self, requests: Sequence[InferenceRequest],
                     partial: bool = False) -> List[int]:
        """Admit several requests at once: same-bucket prefills run as ONE
        batched forward (full batch width, other rows masked with position
        -1), a prompt alone in its bucket one row wide; prompts longer than
        the largest bucket take the chunked path.
        With ``EngineConfig.admission_subwave`` = sw > 0 each bucket group
        is cut into chunks of at most sw sequences, each prefilled by a
        narrow forward (:meth:`_prefill_subwave`); with
        ``admission_interleave_steps`` = k > 0, ``decode_multi(k)`` runs
        between chunks. Each chunk's first tokens are read as its forward
        lands, before the next chunk is prefilled.

        ``partial``: when KV blocks run out mid-wave, admit the prefix of
        the wave that DID allocate and return only its slots (a pressure
        signal marks the deferred tail). With ``partial=False`` exhaustion
        rolls the whole wave back and raises ``OutOfBlocksError``."""
        if not requests:
            return []
        free = self.free_slots()
        if len(requests) > len(free):
            raise RuntimeError(
                f"{len(requests)} requests > {len(free)} free slots"
            )
        max_bucket = self.cfg.prefill_buckets[-1]
        slots_out: List[int] = []
        grouped: Dict[int, List[Tuple[InferenceRequest, int, str, List[int], int]]] = {}
        admitted: List[Tuple[int, str]] = []  # (slot, seq_id) for cleanup
        stats_snapshot = {
            k: self.stats[k]
            for k in ("requests", "prefill_tokens", "prefill_calls",
                      "generated_tokens")
        }
        mgr_stats_snapshot = dict(self.manager.stats.__dict__)
        downloads_before = len(self.manager.pending.downloads)
        interleaved_extra = 0   # decode tokens interleaving gave other slots

        def _rollback() -> None:
            for slot, seq_id in admitted:
                self.slots[slot] = None
                self._kv_lens[slot] = 0
                if seq_id in self.manager.seq_blocks:
                    self.manager.free_sequence(seq_id, cache=False)
            # staged uploads and copies into now-freed blocks must not
            # apply later (a freed id gets reallocated). Downloads are kept:
            # a spill download is the evicted page's only copy.
            alive = self.manager.metas
            p = self.manager.pending
            p.uploads = [u for u in p.uploads if u[0] in alive]
            p.scale_uploads = [u for u in p.scale_uploads if u[0] in alive]
            p.copies = [c for c in p.copies if c[0] in alive and c[1] in alive]
            # counters must not double-count requests a retry re-admits;
            # spills staged by this wave survive the rollback, so they stay
            kept_wave_spills = len(p.downloads) - downloads_before
            self.stats.update(stats_snapshot)
            self.manager.stats.__dict__.update(mgr_stats_snapshot)
            self.manager.stats.spills += max(kept_wave_spills, 0)

        try:
            for request, slot in zip(requests, free):
                token_ids = self._validate_request(request)
                seq_id = request.session_id or uuid.uuid4().hex
                try:
                    _, cached = self.manager.allocate_sequence(seq_id, token_ids)
                except OutOfBlocksError:
                    deferred = len(requests) - len(slots_out)
                    self._signal_pressure("admission", requests=deferred)
                    if not partial:
                        raise
                    break   # admit the prefix that allocated; tail deferred
                admitted.append((slot, seq_id))
                slots_out.append(slot)
                n_fresh = len(token_ids) - cached
                if n_fresh > max_bucket or (self.cfg.kv_seq_sharded and cached > 0):
                    # the chunked path, per request. Block-sharded pools
                    # also send CACHED prompts there: a batched prefill
                    # attends over its own chunk only, which cannot see a
                    # cached prefix, and the chunked path reads it through
                    # the partial-softmax chunk op
                    self._submit_allocated(request, slot, seq_id, token_ids, cached)
                    continue
                bucket = self._bucket_len(max(n_fresh, 1))
                grouped.setdefault(bucket, []).append(
                    (request, slot, seq_id, token_ids, cached)
                )

            b = len(self.slots)
            sw = self.cfg.admission_subwave
            groups = sorted(grouped.items())
            if sw > 0:
                wave_slots = {sl for sl, _ in admitted}
                chunks = [(bucket, items[i0:i0 + sw])
                          for bucket, items in groups
                          for i0 in range(0, len(items), sw)]
                k = self.cfg.admission_interleave_steps
                for ci, (bucket, chunk) in enumerate(chunks):
                    first = self._prefill_subwave(bucket, chunk)
                    for j, item in enumerate(chunk):
                        self._record_token(item[1], int(first[j]))
                    if k and ci < len(chunks) - 1:
                        out = self.decode_multi(k)
                        # only tokens _record_token counted: an emitted
                        # stop token ends its slot uncounted
                        for sl, toks in out.items():
                            if sl in wave_slots:
                                continue
                            s_ = self.slots[sl]
                            stop = 1 if s_ is not None and s_.finish_reason == "stop" else 0
                            interleaved_extra += len(toks) - stop
                groups = []
            for bucket, items in groups:
                if len(items) == 1:
                    # a lone prompt prefills one row wide, as a chunk of
                    # submit_chunked_step does: on the card the row count
                    # decides how the matmuls split their work, so both
                    # entry points then write the same pages
                    self._record_token(items[0][1], int(self._prefill_subwave(bucket, items)[0]))
                    continue
                self._apply_pending()
                toks_pos = np.zeros((2, b, bucket), np.int32)
                toks_pos[1] = -1
                lens = np.zeros((b,), np.int32)
                for item in items:
                    self._bind_prefill_row(item, item[1], toks_pos, lens)
                with self._device_work():
                    logits = self._forward(toks_pos, self._block_tables, lens)
                    first = self._sample(logits, range(b), lens,
                                         self._wave_mode(items)).cpu().numpy()
                self.stats["prefill_calls"] += 1
                for request, slot, seq_id, token_ids, cached in items:
                    self._record_token(slot, int(first[slot]))
        except Exception as exc:
            _rollback()
            # interleaved decode tokens that went to slots outside this wave
            # really happened and survive the rollback
            self.stats["generated_tokens"] += interleaved_extra
            if isinstance(exc, OutOfBlocksError):
                self._signal_pressure("admission", requests=len(requests))
            raise
        return slots_out

    @staticmethod
    def _wave_mode(items: list) -> str:
        """``_sample``'s mode for a prefill wave: greedy when every request
        of the wave is."""
        return ("greedy" if all(it[0].sampling.temperature <= 0 for it in items)
                else "mixed")

    def _bind_prefill_row(self, item: tuple, row: int, toks_pos: np.ndarray,
                          lens: np.ndarray) -> None:
        """Bind an allocated wave item ``(request, slot, seq_id, token_ids,
        cached)`` to its slot and write its fresh tokens, their positions
        and its length into ``row`` of a prefill forward's inputs."""
        request, slot, seq_id, token_ids, cached = item
        s = _Slot(request=request, seq_id=seq_id, prompt_len=len(token_ids),
                  cached_tokens=cached)
        self._bind_slot(slot, s, kv_len=len(token_ids))
        n = len(token_ids) - cached
        toks_pos[0, row, :n] = token_ids[cached:]
        toks_pos[1, row, :n] = np.arange(cached, cached + n)
        lens[row] = cached + n
        self.stats["prefill_tokens"] += n

    def _prefill_subwave(self, bucket: int, chunk: list) -> np.ndarray:
        """Bind and prefill a sub-wave (at most ``admission_subwave``
        sequences), or a prompt alone in its bucket, through one narrow
        forward — its width the next power of two at or above the
        chunk, capped at the slot count; row j carries slot ``chunk[j]``'s
        table row, pad rows position -1 (no KV write) — and sample their
        first tokens with their own slots' keys and sampling parameters at
        their own lengths. → the first tokens on the host, read once the
        chunk's forward lands: the point each of its sequences' TTFT
        stops."""
        self._apply_pending()
        w = 1
        while w < len(chunk):
            w *= 2
        w = min(w, len(self.slots))
        toks_pos = np.zeros((2, w, bucket), np.int32)
        toks_pos[1] = -1
        tables = np.zeros((w, self.cfg.max_blocks_per_seq), np.int32)
        lens = np.zeros((w,), np.int32)
        for j, item in enumerate(chunk):
            self._bind_prefill_row(item, j, toks_pos, lens)
            tables[j] = self._block_tables[item[1]]
        n = len(chunk)
        with self._device_work():
            logits = self._forward(toks_pos, tables, lens)
            first = self._sample(logits[:n], [it[1] for it in chunk], lens[:n],
                                 self._wave_mode(chunk)).cpu().numpy()
        self.stats["prefill_calls"] += 1
        return first

    def _bind_slot(self, slot: int, s: "_Slot", kv_len: int) -> None:
        """Install slot state (block table, committed length, sampling,
        stop ids, key words) for a sequence already allocated."""
        self.slots[slot] = s
        self._block_tables[slot] = self.manager.block_table_for(
            s.seq_id, self.cfg.max_blocks_per_seq
        )
        self._kv_lens[slot] = kv_len
        sp = s.request.sampling
        self._temps[slot] = sp.temperature
        self._top_ks[slot] = sp.top_k
        self._top_ps[slot] = sp.top_p
        self._stop_ids[slot] = -1
        # ignore_eos: no stop ids at all — generation runs to its budget
        stop = [] if sp.ignore_eos else list(sp.stop_token_ids)[:MAX_STOP_IDS]
        if self.eos_token_id is not None and self.eos_token_id not in stop \
                and len(stop) < MAX_STOP_IDS and not sp.ignore_eos:
            stop.append(self.eos_token_id)
        self._stop_ids[slot, : len(stop)] = stop
        # key words: [seed >> 32, seed & 0xffffffff] for seeded requests
        if sp.seed is not None:
            seed_val = int(sp.seed)
            self._slot_keys[slot] = (
                (seed_val >> 32) & 0xFFFFFFFF, seed_val & 0xFFFFFFFF
            )
        else:
            self._slot_keys[slot] = self._host_rng.integers(
                0, 2**32, size=2, dtype=np.uint32
            )
        if self.cfg.speculative is not None:
            # fresh occupant: its draft feature starts at zeros, its
            # adaptive-depth EMA restarts at K, its oracle dither resets
            self._spec_h_zero.add(slot)
            self._spec_k_ema[slot] = float(self.cfg.speculative.num_draft_tokens)
            self._spec_oracle_acc[slot] = 0.0
        self.stats["requests"] += 1

    def _submit_allocated(self, request: InferenceRequest, slot: int,
                          seq_id: str, token_ids: List[int], cached: int) -> int:
        self._apply_pending()
        s = _Slot(request=request, seq_id=seq_id, prompt_len=len(token_ids),
                  cached_tokens=cached)
        self._bind_slot(slot, s, kv_len=len(token_ids))
        # CHUNKED prefill of the uncached suffix: full-bucket pieces + a
        # bucketed tail; each chunk attends to all prior context and only
        # the final chunk's logits (the last prompt token) are sampled
        fresh = token_ids[cached:]
        max_bucket = self.cfg.prefill_buckets[-1]
        off = cached
        mode = "greedy" if request.sampling.temperature <= 0 else "mixed"
        if self.seq > 1 and cached == 0 and len(fresh) > max_bucket:
            # one seq-parallel pass over the whole prompt
            self._record_token(slot, self._prefill_seq_parallel(slot, fresh, mode))
            return slot
        while True:
            piece = fresh[: max_bucket]
            fresh = fresh[max_bucket:]
            is_last = not fresh
            first = self._prefill_one_chunk(slot, piece, off, is_last, mode)
            off += len(piece)
            if is_last:
                break
        self._record_token(slot, int(first))
        return slot

    def _prefill_seq_parallel(self, slot: int, fresh: List[int], mode: str) -> int:
        """Whole-prompt seq-parallel prefill (JAX
        ``TPUEngine._prefill_seq_parallel``): every rank runs its 1/n of the
        rows, attention ring or Ulysses over the ranks, and the pages land
        in the pools decode reads (``runtime/tp.py`` :func:`seq_prefill`).
        The prompt is padded to a multiple of n x max(block, 16). → the
        first token."""
        n = len(fresh)
        step = self.seq * max(self.cfg.block_size, 16)
        padded = -(-n // step) * step
        toks_pos = np.zeros((2, 1, padded), np.int32)
        toks_pos[1] = -1
        toks_pos[0, 0, :n] = fresh
        toks_pos[1, 0, :n] = np.arange(n)
        table = self._block_tables[slot: slot + 1].copy()
        t0 = time.perf_counter()
        with self._device_work():
            self._ranks.send("seq_prefill", toks_pos=toks_pos, table=table, n=n)
            logits = seq_prefill(self.model_cfg, self.params, self.kv, self._seq, toks_pos,
                                 table, n, with_logits=True)
            first = int(self._sample(logits, [slot], np.asarray([n], np.int32), mode)[0])
        # keys of their own only once used, as in the JAX engine
        self.stats["seq_parallel_prefill_s"] = (
            self.stats.get("seq_parallel_prefill_s", 0.0) + time.perf_counter() - t0)
        self.stats["seq_parallel_prefills"] = self.stats.get("seq_parallel_prefills", 0) + 1
        self.stats["prefill_tokens"] += n
        self.stats["prefill_calls"] += 1
        return first

    def _prefill_one_chunk(self, slot: int, piece: List[int], off: int,
                           is_last: bool, mode: str) -> Optional[int]:
        """One single-sequence prefill chunk; the final chunk samples the
        first token, intermediate chunks skip the LM head."""
        n = len(piece)
        bucket = (
            self._bucket_len(max(n, 1)) if is_last
            else self.cfg.prefill_buckets[-1]
        )
        toks_pos = np.zeros((2, 1, bucket), np.int32)
        toks_pos[1] = -1
        toks_pos[0, 0, :n] = piece
        toks_pos[1, 0, :n] = np.arange(off, off + n)
        lens = np.asarray([off + n], np.int32)
        first = None
        with self._device_work():
            logits = self._forward(toks_pos, self._block_tables[slot: slot + 1],
                                   lens, with_logits=is_last)
            if is_last:
                first = int(self._sample(logits, [slot], lens, mode)[0])
        self.stats["prefill_tokens"] += n
        self.stats["prefill_calls"] += 1
        return first

    # ------------------------------------------- chunk-interleaved admission

    def submit_chunked_start(
        self, request: InferenceRequest, slot: Optional[int] = None
    ) -> ChunkedAdmission:
        """Begin a chunk-interleaved admission: allocate + bind the slot but
        run NO prefill yet. The slot is marked ``prefilling`` so decode
        rounds skip it until its final chunk samples the first token."""
        if slot is None:
            free = self.free_slots()
            if not free:
                raise RuntimeError("no free slots")
            slot = free[0]
        if self.slots[slot] is not None:
            raise RuntimeError(f"slot {slot} busy")
        token_ids = self._validate_request(request)
        seq_id = request.session_id or uuid.uuid4().hex
        try:
            _, cached = self.manager.allocate_sequence(seq_id, token_ids)
        except OutOfBlocksError:
            self._signal_pressure("admission", requests=1)
            raise
        try:
            self._apply_pending()
            s = _Slot(request=request, seq_id=seq_id,
                      prompt_len=len(token_ids), cached_tokens=cached,
                      prefilling=True)
            self._bind_slot(slot, s, kv_len=len(token_ids))
        except Exception:
            self.slots[slot] = None
            self._kv_lens[slot] = 0
            self.manager.free_sequence(seq_id, cache=False)
            raise
        return ChunkedAdmission(
            request=request, slot=slot, seq_id=seq_id,
            fresh=list(token_ids[cached:]), off=cached,
            mode="greedy" if request.sampling.temperature <= 0 else "mixed",
        )

    def submit_chunked_step(self, adm: ChunkedAdmission) -> bool:
        """Run ONE prefill chunk of an in-flight admission; True once the
        admission completed (first token sampled)."""
        if adm.done:
            return True
        s = self.slots[adm.slot]
        if s is None or s.seq_id != adm.seq_id:
            raise RuntimeError("chunked admission slot was freed")
        max_bucket = self.cfg.prefill_buckets[-1]
        if len(adm.fresh) <= max_bucket:
            # the upcoming chunk is the LAST one: pre-reserve the sampled
            # first token's block so exhaustion is a step-boundary retry
            try:
                if self.manager.reserve_tokens(s.seq_id, 1):
                    self._block_tables[adm.slot] = \
                        self.manager.block_table_for(
                            s.seq_id, self.cfg.max_blocks_per_seq
                        )
            except OutOfBlocksError:
                self.manager.trim_reserved(s.seq_id)
                self._signal_pressure("admission", requests=1)
                return False
        self._apply_pending()
        piece = adm.fresh[: max_bucket]
        adm.fresh = adm.fresh[max_bucket:]
        is_last = not adm.fresh
        try:
            first = self._prefill_one_chunk(
                adm.slot, piece, adm.off, is_last, adm.mode
            )
        except Exception:
            self.abort_chunked(adm)
            raise
        adm.off += len(piece)
        if is_last:
            s.prefilling = False
            self._record_token(adm.slot, int(first))
            adm.done = True
        else:
            self._release_prefill_window(adm)
        return adm.done

    def abort_chunked(self, adm: ChunkedAdmission) -> None:
        """Release a failed/cancelled chunked admission's slot and blocks."""
        s = self.slots[adm.slot]
        adm.done = True
        if s is None or s.seq_id != adm.seq_id:
            return
        self.slots[adm.slot] = None
        self._kv_lens[adm.slot] = 0
        self.manager.free_sequence(adm.seq_id, cache=False)

    # ------------------------------------------------------- ragged rounds

    @property
    def supports_ragged(self) -> bool:
        """False for block-sharded pools, as in the JAX engine: the batcher
        keeps its split admission there (a ragged round still serves when
        called, its rows read through the chunk op)."""
        return not self.cfg.kv_seq_sharded

    def ragged_round(
        self, admissions: Sequence[ChunkedAdmission] = (),
        chunk_caps: Optional[Dict[int, int]] = None,
    ) -> Dict[int, List[int]]:
        """ONE forward serving a ragged row batch: every active decode slot
        advances AND every in-flight admission advances one prefill chunk.
        Decode rows feed their pending token at position ``_kv_lens``
        (block pre-reserved; pressure freezes the row at the step boundary)
        or, when the engine speculates, are verify rows
        (:meth:`_spec_ragged_round`); admission rows run their next chunk,
        the final chunk sampling the first token (a pressured final chunk
        is NOT consumed and retries next round).

        ``chunk_caps``: optional per-admission prefill-token caps for THIS
        round, keyed by slot; a cap <= 0 skips the admission this round.
        Returns {slot: [tokens]} for every row that sampled; admissions are
        mutated in place and ``adm.done`` flips when the first token lands."""
        if self.cfg.speculative is not None:
            return self._spec_ragged_round(admissions, chunk_caps)
        return self._plain_ragged_round(admissions, chunk_caps)

    def _live_admissions(self, admissions: Sequence[ChunkedAdmission]
                         ) -> List[ChunkedAdmission]:
        admissions = [a for a in admissions if not a.done]
        for adm in admissions:
            s = self.slots[adm.slot]
            if s is None or s.seq_id != adm.seq_id:
                raise RuntimeError("ragged admission slot was freed")
        return admissions

    def _ragged_admission_rows(
        self, admissions: Sequence[ChunkedAdmission],
        chunk_caps: Optional[Dict[int, int]] = None,
    ) -> Tuple[List[Tuple[ChunkedAdmission, List[int], bool]], int]:
        """Slice each admission's next chunk row for a ragged round, with
        the final chunk's pending-block pre-reservation (a pressured final
        chunk skips this round); shared by the plain and spec rounds.
        → (ready rows, max chunk width)."""
        chunk_cap = min(max(int(self.cfg.ragged_chunk), 1), self.cfg.prefill_buckets[-1])
        ready: List[Tuple[ChunkedAdmission, List[int], bool]] = []
        width = 1
        for adm in admissions:
            s = self.slots[adm.slot]
            assert s is not None
            cap = chunk_cap
            if chunk_caps is not None:
                cap = min(cap, int(chunk_caps.get(adm.slot, cap)))
                if cap <= 0:
                    continue
            piece = adm.fresh[:cap]
            is_last = len(adm.fresh) <= cap
            if is_last:
                try:
                    if self.manager.reserve_tokens(s.seq_id, 1):
                        self._block_tables[adm.slot] = \
                            self.manager.block_table_for(
                                s.seq_id, self.cfg.max_blocks_per_seq
                            )
                except OutOfBlocksError:
                    self.manager.trim_reserved(s.seq_id)
                    self._signal_pressure("admission", requests=1)
                    continue
            ready.append((adm, piece, is_last))
            width = max(width, len(piece))
        return ready, width

    @staticmethod
    def _fill_ragged_admission_rows(ready, toks_pos: np.ndarray,
                                    lens_after: np.ndarray) -> bool:
        """Write the admission chunk rows into a round's host arrays; True
        when any admission samples non-greedily."""
        mixed = False
        for adm, piece, _ in ready:
            sl, n = adm.slot, len(piece)
            toks_pos[0, sl, :n] = piece
            toks_pos[1, sl, :n] = np.arange(adm.off, adm.off + n)
            lens_after[sl] = adm.off + n
            mixed = mixed or adm.mode != "greedy"
        return mixed

    def _commit_ragged_admissions(self, ready, toks: np.ndarray,
                                  out: Dict[int, List[int]]) -> None:
        """After a ragged round: advance chunk offsets, count prefill
        tokens and record each completed admission's first token."""
        for adm, piece, is_last in ready:
            s = self.slots[adm.slot]
            assert s is not None
            adm.fresh = adm.fresh[len(piece):]
            adm.off += len(piece)
            self.stats["prefill_tokens"] += len(piece)
            if is_last:
                s.prefilling = False
                tok = int(toks[adm.slot])
                out[adm.slot] = [tok]
                self._record_token(adm.slot, tok)
                adm.done = True
            else:
                self._release_prefill_window(adm)

    def _plain_ragged_round(
        self, admissions: Sequence[ChunkedAdmission] = (),
        chunk_caps: Optional[Dict[int, int]] = None,
    ) -> Dict[int, List[int]]:
        """:meth:`ragged_round` with one-token decode rows."""
        admissions = self._live_admissions(admissions)
        b = len(self.slots)

        # --- decode rows: pre-reserve each pending token's block
        kept: List[int] = []
        pressured: List[int] = []
        for i, s in enumerate(self.slots):
            if s is None or s.finish_reason is not None or s.prefilling:
                continue
            if len(self.manager.seq_tokens[s.seq_id]) >= self.cfg.max_seq_len:
                kept.append(i)      # length-finish triggers in _record_token
                continue
            try:
                added = self.manager.reserve_tokens(s.seq_id, 1)
            except OutOfBlocksError:
                self.manager.trim_reserved(s.seq_id)
                self._block_tables[i] = self.manager.block_table_for(
                    s.seq_id, self.cfg.max_blocks_per_seq
                )
                pressured.append(i)
                continue
            if added:
                self._block_tables[i] = self.manager.block_table_for(
                    s.seq_id, self.cfg.max_blocks_per_seq
                )
            kept.append(i)
        if pressured:
            self._signal_pressure("decode", slots=pressured)

        # --- admission chunk rows (final chunks pre-reserve their block)
        ready, width = self._ragged_admission_rows(admissions, chunk_caps)
        if not kept and not ready:
            return {}

        self._apply_pending()
        s_w = self._bucket_len(width)
        toks_pos = np.zeros((2, b, s_w), np.int32)
        toks_pos[1] = -1
        lens_after = np.zeros((b,), np.int32)
        mode = "greedy"
        for i in kept:
            toks_pos[0, i, 0] = self._last_tokens[i]
            toks_pos[1, i, 0] = self._kv_lens[i]
            lens_after[i] = self._kv_lens[i] + 1
            if self._temps[i] > 0:
                mode = "mixed"
        if self._fill_ragged_admission_rows(ready, toks_pos, lens_after):
            mode = "mixed"
        with self._device_work():
            logits = self._forward(toks_pos, self._block_tables, lens_after,
                                   allow_fused=False)
            toks = self._sample(logits, range(b), lens_after, mode).cpu().numpy()
        self.stats["ragged_rounds"] += 1
        if kept:
            self.stats["decode_calls"] += 1
        if ready:
            self.stats["prefill_calls"] += 1
        out: Dict[int, List[int]] = {}
        for i in kept:
            self._kv_lens[i] += 1   # the fed token's KV is now committed
            tok = int(toks[i])
            out[i] = [tok]
            self._record_token(i, tok)
        self._commit_ragged_admissions(ready, toks, out)
        return out

    # ------------------------------------------------------------- decoding

    def _record_token(self, slot: int, tok: int,
                      already_committed: bool = False) -> None:
        """Account a freshly *sampled* token. ``_kv_lens[slot]`` is the
        **committed** context length; a sampled token is *pending* until
        it is fed in the next decode step. Records the sample, checks
        stop/length and (unless ``already_committed`` — multi-step decode
        pre-reserves) allocates the block its KV will land in."""
        s = self.slots[slot]
        assert s is not None
        now = time.time()
        if s.first_token_time is None:
            s.first_token_time = now
        if tok in self._stop_ids[slot]:
            s.finish_reason = "stop"
            return
        s.generated.append(tok)
        self.stats["generated_tokens"] += 1
        self._last_tokens[slot] = tok
        if len(s.generated) >= s.request.sampling.max_new_tokens:
            s.finish_reason = s.finish_reason or "length"
            return
        if int(self._kv_lens[slot]) >= self.cfg.max_seq_len:
            s.finish_reason = "length"
            return
        if not already_committed:
            new_block = self.manager.append_token(s.seq_id, tok)
            if new_block is not None:
                self._block_tables[slot] = self.manager.block_table_for(
                    s.seq_id, self.cfg.max_blocks_per_seq
                )
            self._apply_pending()
            self._maybe_release_window(slot)

    def _release_prefill_window(self, adm: ChunkedAdmission) -> None:
        """Sliding-window models, MID-prefill: hand back blocks every
        REMAINING chunk query is already past (only keys <= adm.off - window
        release)."""
        w = self.model_cfg.sliding_window
        if w is None:
            return
        s = self.slots[adm.slot]
        if s is None:
            return
        cur = len(self.manager.seq_tokens[s.seq_id])
        released = self.manager.release_out_of_window(
            s.seq_id, w + max(cur - adm.off, 0)
        )
        for lb in released:
            self._block_tables[adm.slot, lb] = 0

    def _maybe_release_window(self, slot: int) -> None:
        """Sliding-window models: hand blocks every future query is past
        back to the pool; released logical slots point at pad block 0,
        which the window mask already excludes."""
        w = self.model_cfg.sliding_window
        if w is None:
            return
        s = self.slots[slot]
        assert s is not None
        released = self.manager.release_out_of_window(s.seq_id, w)
        for lb in released:
            self._block_tables[slot, lb] = 0

    def _decode_loop(self, active_mask: np.ndarray, budgets: np.ndarray,
                     num_steps: int, mode: str) -> np.ndarray:
        """Up to ``num_steps`` decode steps with the per-slot state on the
        device (``runtime/tp.py`` ``decode_steps``): each not-done row
        feeds its pending token at position ``lens`` (writing its KV) and
        advances; a row is done once it emits a stop id or its budget. One
        host read at the end → emitted [B, T] (-1 = masked-out step). Steps
        past the largest budget would be all-masked, so the loop stops
        there. Under tensor parallelism and on block-sharded pools every
        rank runs the same steps and this engine samples each step's tokens
        for all of them."""
        b = len(self.slots)
        steps = int(min(num_steps, int(budgets.max(initial=0))))
        emitted = np.full((b, num_steps), -1, np.int32)
        if steps <= 0:
            return emitted
        with self._device_work():
            if self._mirror:
                self._ranks.send("decode", to=self._mirror, last=self._last_tokens,
                                 lens=self._kv_lens,
                                 active=active_mask, budgets=budgets.astype(np.int32),
                                 stops=self._stop_ids, tables=self._block_tables,
                                 steps=steps)
            cols = decode_steps(
                self.model_cfg, self.params, self.kv, self.cfg.block_size,
                self._tensor(self._last_tokens), self._tensor(self._kv_lens),
                self._tensor(~active_mask), self._tensor(budgets.astype(np.int32)),
                self._tensor(self._stop_ids), self._tensor(self._block_tables), steps,
                lambda logits, cur: self._sample(logits, range(b), cur, mode),
                self._model_group, self._roles.read_hooks, self._roles.ops,
            )
            emitted[:, :steps] = cols.cpu().numpy()
        return emitted

    def decode_step(self) -> Dict[int, int]:
        """One decode step for all active unfinished slots: feeds each
        slot's pending token, samples the next. Returns {slot: token}
        (stop tokens included, then the slot finishes)."""
        active = [
            i for i, s in enumerate(self.slots)
            if s is not None and s.finish_reason is None and not s.prefilling
        ]
        if not active:
            return {}
        kept: List[int] = []
        pressured: List[int] = []
        for i in active:
            s = self.slots[i]
            assert s is not None
            if len(self.manager.seq_tokens[s.seq_id]) >= self.cfg.max_seq_len:
                kept.append(i)
                continue
            try:
                added = self.manager.reserve_tokens(s.seq_id, 1)
            except OutOfBlocksError:
                self.manager.trim_reserved(s.seq_id)
                self._block_tables[i] = self.manager.block_table_for(
                    s.seq_id, self.cfg.max_blocks_per_seq
                )
                pressured.append(i)
                continue
            if added:
                self._block_tables[i] = self.manager.block_table_for(
                    s.seq_id, self.cfg.max_blocks_per_seq
                )
            kept.append(i)
        if pressured:
            self._signal_pressure("decode", slots=pressured)
        if not kept:
            return {}
        self._apply_pending()
        active_mask = np.zeros(len(self.slots), dtype=bool)
        active_mask[kept] = True
        # stop/length decisions stay host-side in _record_token
        budgets = np.where(active_mask, _BIG_BUDGET, 0).astype(np.int32)
        emitted = self._decode_loop(active_mask, budgets, 1, self._decode_mode())
        self.stats["decode_calls"] += 1
        out: Dict[int, int] = {}
        for i in kept:
            self._kv_lens[i] += 1  # the fed token's KV is now committed
            tok = int(emitted[i, 0])
            out[i] = tok
            self._record_token(i, tok)
        return out

    def decode_multi(self, num_steps: Optional[int] = None) -> Dict[int, List[int]]:
        """Run T decode steps with stop/budget masking on the device; the
        host sees tokens only at the end. With ``EngineConfig.speculative``
        the T steps are draft→verify→accept rounds instead, each committing
        1..K+1 tokens a slot."""
        num_steps = num_steps or self.cfg.multi_step
        if self.cfg.speculative is not None:
            return self._spec_decode_rounds(int(num_steps))
        active_mask = np.array(
            [s is not None and s.finish_reason is None and not s.prefilling
             for s in self.slots]
        )
        if not active_mask.any():
            return {}
        budgets = np.array(
            [
                min(
                    s.request.sampling.max_new_tokens - len(s.generated),
                    self.cfg.max_seq_len - int(self._kv_lens[i]),
                ) if active_mask[i] and s is not None else 0
                for i, s in enumerate(self.slots)
            ],
            dtype=np.int32,
        )
        budgets = np.maximum(budgets, 0)
        active_mask &= budgets > 0
        if not active_mask.any():
            return {}
        # pre-reserve KV blocks for each slot's horizon; a slot whose
        # reservation exhausts the pool is FROZEN for this round
        pressured: List[int] = []
        for i, s in enumerate(self.slots):
            if active_mask[i] and s is not None:
                cur = len(self.manager.seq_tokens[s.seq_id])
                n_res = min(int(min(num_steps, budgets[i])),
                            self.cfg.max_seq_len - cur)
                if n_res <= 0:
                    continue
                try:
                    self.manager.reserve_tokens(s.seq_id, n_res)
                except OutOfBlocksError:
                    self.manager.trim_reserved(s.seq_id)
                    active_mask[i] = False
                    pressured.append(i)
                self._block_tables[i] = self.manager.block_table_for(
                    s.seq_id, self.cfg.max_blocks_per_seq
                )
        if pressured:
            self._signal_pressure("decode", slots=pressured)
        if not active_mask.any():
            return {}
        self._apply_pending()
        budgets = np.where(active_mask, budgets, 0).astype(np.int32)
        emitted = self._decode_loop(active_mask, budgets, int(num_steps),
                                    self._decode_mode())
        self.stats["decode_calls"] += num_steps
        out: Dict[int, List[int]] = {}
        for i, s in enumerate(self.slots):
            if not active_mask[i] or s is None:
                continue
            toks = [int(t) for t in emitted[i] if t >= 0]
            out[i] = toks
            # each emitted token corresponds to one step that fed (and thus
            # committed) the previous pending token
            self._kv_lens[i] += len(toks)
            for t in toks:
                if s.finish_reason is not None:
                    break
                self._record_token(i, t, already_committed=True)
            commit = toks if s.finish_reason is None else toks[:-1]
            self.manager.commit_tokens(s.seq_id, commit)
            self._maybe_release_window(i)
        return out

    # ------------------------------------------------ speculative decoding

    def _spec_h_device(self) -> torch.Tensor:
        """Each slot's last verified hidden for the draft head, on the
        device between rounds; rebinds and failures zero the affected rows."""
        if self._spec_h is None:
            self._spec_h = torch.zeros((len(self.slots), self.model_cfg.hidden_size),
                                       dtype=self.dtype, device=self.device)
            self._spec_h_zero.clear()
        elif self._spec_h_zero:
            rows = torch.tensor(sorted(self._spec_h_zero), dtype=torch.long,
                                device=self.device)
            self._spec_h[rows] = 0
            self._spec_h_zero.clear()
        return self._spec_h

    def _select_spec_ks(self, active: Sequence[int]) -> np.ndarray:
        """Per-slot draft depth for the next dispatch: the configured K, or
        (adaptive) the smallest choice of ``k_choices`` strictly above the
        slot's accepted-length EMA, capped at the largest."""
        sp = self.cfg.speculative
        assert sp is not None
        ks = np.full((len(self.slots),), sp.num_draft_tokens, np.int32)
        if sp.adaptive:
            choices = sp.k_choices()
            for i in active:
                ema = float(self._spec_k_ema[i])
                sel = choices[-1]
                for c in choices:
                    if ema < c:
                        sel = c
                        break
                ks[i] = sel
        if self.spec_k_trace is not None:
            self.spec_k_trace.append([(int(i), int(ks[i])) for i in active])
        return ks

    def _spec_ema_update(self, slot: int, accepted: int) -> None:
        sp = self.cfg.speculative
        assert sp is not None
        a = float(sp.adaptive_ema)
        self._spec_k_ema[slot] = (
            a * float(self._spec_k_ema[slot]) + (1.0 - a) * float(accepted)
        )

    def _spec_forced(self, active: Sequence[int], rounds: int,
                     ks: np.ndarray) -> np.ndarray:
        """Oracle-forced accepted lengths [rounds, B] (-1 = real acceptance,
        also every inactive row). Fractional targets (rate × K) dither
        through a per-slot accumulator: the mean over rounds hits the rate
        and the schedule is deterministic."""
        sp = self.cfg.speculative
        assert sp is not None
        out = np.full((rounds, len(self.slots)), -1, np.int32)
        rate = sp.oracle_accept_rate
        if rate is None:
            return out
        for i in active:
            target = float(rate) * float(ks[i])
            for r in range(rounds):
                self._spec_oracle_acc[i] += target
                f = int(np.floor(self._spec_oracle_acc[i] + 1e-9))
                f = max(0, min(f, int(ks[i])))
                self._spec_oracle_acc[i] -= f
                out[r, i] = f
        return out

    def distill_draft(self, steps: int = 400, **kw: Any) -> torch.Tensor:
        """Distil the integrated draft head against this engine's own
        target weights (``runtime.speculative.distill_draft_params``, from
        a generator seeded with ``draft_seed``) and serve it from the next
        round: acceptance goes from ~0 (a random head) to what the target
        allows. Run it before the engine serves (no live slot), so that no
        round reads a head half replaced. → the per-step losses."""
        if self.cfg.speculative is None:
            raise ValueError("engine has no speculative config to distill")
        if any(s is not None for s in self.slots):
            raise RuntimeError("distill_draft runs before the engine serves: a slot is live")
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.speculative.draft_seed)
        head, losses = distill_draft_params(self.model_cfg, self.params, gen, steps=steps,
                                            **kw)
        self._draft_params = {k: v.to(self.dtype) for k, v in head.items()}
        return losses

    def set_spec_oracle(self, rate: Optional[float]) -> None:
        """Set the oracle draft's forced acceptance rate on a live engine
        (None restores real acceptance)."""
        sp = self.cfg.speculative
        if sp is None:
            raise ValueError("engine has no speculative config")
        if rate is not None and not (0.0 <= float(rate) <= 1.0):
            raise ValueError(f"oracle rate {rate} must be in [0, 1]")
        sp.oracle_accept_rate = None if rate is None else float(rate)
        self._spec_oracle_acc[:] = 0.0

    def _draft_chain(self, pending: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """The K-token greedy draft chain from each slot's pending token and
        last verified hidden → [B, K+1] (pending first). Draft logits go
        through ``project_logits`` (final norm + head), the readout the
        draft head is trained against."""
        cfg, params = self.model_cfg, self.params
        toks = [pending]
        hh = h
        for _ in range(self.cfg.speculative.num_draft_tokens):
            hh = draft_apply(cfg, self._draft_params, hh,
                             llama.embed_tokens(params, toks[-1], cfg))
            logits = llama.project_logits(cfg, params, hh[:, None, :])
            toks.append(greedy_tokens(logits[:, 0, :]))
        return torch.stack(toks, dim=1)

    @staticmethod
    def _accept_chain(chunk: torch.Tensor, target_pred: torch.Tensor,
                      ks: torch.Tensor, forced: torch.Tensor, lens: torch.Tensor,
                      caps: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
        """Longest matching prefix of the draft (greedy match) within each
        slot's selected depth; the oracle (forced >= 0) overrides the match.
        Clamped so committed + pending stays inside the reserved blocks."""
        match = ((chunk[:, 1:] == target_pred[:, :-1])
                 & (offs[:, 1:] <= ks[:, None])).to(torch.int32)
        n_acc = torch.cumprod(match, dim=1).sum(dim=1, dtype=torch.int32)
        n_acc = torch.where(forced >= 0, torch.minimum(forced, ks), n_acc)
        return torch.minimum(n_acc, (caps - lens - 2).clamp(min=0))

    def spec_decode_step(self) -> Dict[int, List[int]]:
        """One speculative round for all active slots (1..K+1 tokens each);
        the contract of ``decode_multi``."""
        return self._spec_decode_rounds(1)

    def _spec_decode_rounds(self, num_steps: int) -> Dict[int, List[int]]:
        """Up to ``num_steps`` draft→verify→accept rounds with stop/budget
        masking on the device; the per-round records replay on the host so
        the cache manager's commits and the emission match the per-step
        path exactly. Rounds per dispatch bucket to a power of two, as the
        JAX engine's scan lengths do: the reservations, the oracle schedule
        and the adaptive trace follow the same dispatch structure."""
        spec = self.cfg.speculative
        assert spec is not None
        active = [
            i for i, s in enumerate(self.slots)
            if s is not None and s.finish_reason is None and not s.prefilling
        ]
        if not active:
            return {}
        b = len(self.slots)
        active_mask = np.zeros(b, dtype=bool)
        caps = np.zeros(b, dtype=np.int32)
        budgets = np.zeros(b, dtype=np.int32)
        for i in active:
            s = self.slots[i]
            budgets[i] = max(s.request.sampling.max_new_tokens - len(s.generated), 0)
        active = [i for i in active if budgets[i] > 0]
        if not active:
            return {}
        rounds = max(1, min(int(num_steps), int(max(budgets[i] for i in active))))
        rounds = 1 << (rounds.bit_length() - 1)
        ks_sel = self._select_spec_ks(active)
        pressured: List[int] = []
        for i in active:
            s = self.slots[i]
            # reserve the dispatch's worst case up front: commits are
            # bounded by min(rounds*(K+1), budget), plus K+1 so the last
            # round's full window and the pending token stay covered (K =
            # the slot's SELECTED depth); near max_seq_len the window
            # shrinks and the acceptance clamp + freeze honour the cap
            cur = len(self.manager.seq_tokens[s.seq_id])
            ki = int(ks_sel[i])
            want = min(rounds * (ki + 1), int(budgets[i])) + ki + 1
            n_res = max(min(want, self.cfg.max_seq_len - cur), 0)
            try:
                if n_res > 0 and self.manager.reserve_tokens(s.seq_id, n_res):
                    self._block_tables[i] = self.manager.block_table_for(
                        s.seq_id, self.cfg.max_blocks_per_seq)
            except OutOfBlocksError:
                # the pool cannot hold this slot's verify window: freeze it
                # for this dispatch (step-boundary pressure)
                self.manager.trim_reserved(s.seq_id)
                self._block_tables[i] = self.manager.block_table_for(
                    s.seq_id, self.cfg.max_blocks_per_seq)
                pressured.append(i)
                continue
            active_mask[i] = True
            caps[i] = cur + n_res
        if pressured:
            self._signal_pressure("decode", slots=pressured)
        if not active_mask.any():
            return {}
        self._apply_pending()
        forced = self._spec_forced([i for i in active if active_mask[i]], rounds, ks_sel)
        with self._device_work():
            rec_emit, rec_nacc, rec_act = self._spec_device_rounds(
                active_mask, caps, budgets, ks_sel, forced, rounds, self._decode_mode())
        self.stats["decode_calls"] += rounds
        out: Dict[int, List[int]] = {}
        for r in range(rec_act.shape[0]):
            act = rec_act[r]
            if not act.any():
                break
            self.stats["spec_steps"] += 1
            for i in active:
                if not act[i]:
                    continue
                if spec.adaptive:
                    # the EMA sees every round the row was live (sampled
                    # rows' structural zeros converge them to the floor)
                    self._spec_ema_update(i, int(rec_nacc[r, i]))
                s = self.slots[i]
                if s is None or s.finish_reason is not None:
                    continue
                self._commit_spec_row(i, rec_emit[r, i], int(rec_nacc[r, i]),
                                      int(ks_sel[i]), out)
        for i in active:
            s = self.slots[i]
            if s is None:
                continue
            # rollback of the rejected windows: hand back reserved blocks
            # acceptance never reached (the footprint of a per-step engine)
            if self.manager.trim_reserved(s.seq_id):
                self._block_tables[i] = self.manager.block_table_for(
                    s.seq_id, self.cfg.max_blocks_per_seq)
            self._maybe_release_window(i)
        return out

    def _commit_spec_row(self, i: int, emitted: np.ndarray, a: int, k: int,
                         out: Dict[int, List[int]]) -> None:
        """Host replay of one slot's round: the verify pass committed the
        pending token and ``a`` accepted drafts; record the emission up to
        a stop or the budget and commit what the slot keeps."""
        s = self.slots[i]
        assert s is not None
        self._kv_lens[i] += a + 1
        if self._temps[i] <= 0.0:
            # efficiency counters describe SPECULATING slots only: sampled
            # slots never accept drafts by design
            self.stats["spec_slot_steps"] += 1
            self.stats["spec_drafted"] += k
            self.stats["spec_accepted"] += a
            self.stats["spec_emitted"] += a + 1
        commit: List[int] = []
        for t in emitted:
            if t < 0 or s.finish_reason is not None:
                break
            out.setdefault(i, []).append(int(t))
            self._record_token(i, int(t), already_committed=True)
            if s.finish_reason is None:
                commit.append(int(t))
        self.manager.commit_tokens(s.seq_id, commit)

    def _spec_device_rounds(self, active_mask: np.ndarray, caps: np.ndarray,
                            budgets: np.ndarray, ks_sel: np.ndarray,
                            forced: np.ndarray, rounds: int, mode: str
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The rounds of :meth:`_spec_decode_rounds` on the device: draft
        chain, one verify forward (K+1 queries a row, never the fused
        decode op), acceptance, emission record and stop/budget masking,
        until every row is done. → per-round (emitted [R, B, K+1], accepted
        counts [R, B], active [R, B])."""
        k = self.cfg.speculative.num_draft_tokens
        b = len(self.slots)
        lens = self._tensor(self._kv_lens)
        pending = self._tensor(self._last_tokens)
        h = self._spec_h_device()
        done = self._tensor(~active_mask)
        n_emit = torch.zeros_like(lens)
        tables = self._tensor(self._block_tables)
        caps_t, budgets_t = self._tensor(caps), self._tensor(budgets)
        ks_t, forced_t = self._tensor(ks_sel), self._tensor(forced)
        stops = self._tensor(self._stop_ids)
        is_sampled = self._tensor(self._temps) > 0.0
        offs = torch.arange(k + 1, dtype=torch.int32, device=self.device)[None, :]
        rows = torch.arange(b, device=self.device)
        recs = []
        for r in range(rounds):
            act = ~done
            chunk = self._draft_chain(pending, h)                        # [B, K+1]
            # the pending token commits its KV as a plain step would;
            # drafts write ahead into the reserved window (up to the
            # slot's selected depth)
            pos = lens[:, None] + offs
            pos = torch.where(act[:, None] & (offs <= ks_t[:, None]) & (pos < caps_t[:, None]),
                              pos, torch.full_like(pos, -1))
            kv_after = torch.where(act, lens + ks_t + 1, torch.zeros_like(lens))
            out = llama.forward_chunk(
                self.model_cfg, self.params, chunk, pos, self.kv, tables, kv_after,
                block_size=self.cfg.block_size, last_only=False, allow_fused=False)
            target_pred = greedy_tokens(out.logits)                     # [B, K+1]
            n_acc = self._accept_chain(chunk, target_pred, ks_t, forced_t[r], lens,
                                       caps_t, offs)
            bonus = target_pred[rows, n_acc.long()]
            if mode == "mixed":
                # sampled slots ride the round at one token: the pending
                # token's logits, the key folded at lens + 1 as a plain
                # step folds it; they never accept drafts
                sampled0 = self._sample(out.logits[:, 0, :], range(b), lens + 1, mode)
                n_acc = torch.where(is_sampled, torch.zeros_like(n_acc), n_acc)
                bonus = torch.where(is_sampled, sampled0, bonus)
            emitted = ordered_emission(chunk[:, 1:], n_acc, bonus, act)
            n_emit, stop_hit = mask_emission(emitted, stops, n_emit, budgets_t)
            recs.append((emitted, n_acc, act))
            new_h = out.hidden[rows, n_acc.long()]
            lens = torch.where(act, lens + n_acc + 1, lens)
            pending = torch.where(act, bonus, pending)
            h = torch.where(act[:, None], new_h, h)
            # freeze rows whose next window no longer fits the reservation
            done = done | (act & (stop_hit | (n_emit >= budgets_t) | (lens + 2 > caps_t)))
            if r + 1 < rounds and bool(done.all()):
                break
        self._spec_h = h
        return tuple(torch.stack(x).cpu().numpy() for x in zip(*recs))

    def _spec_ragged_round(
        self, admissions: Sequence[ChunkedAdmission] = (),
        chunk_caps: Optional[Dict[int, int]] = None,
    ) -> Dict[int, List[int]]:
        """The speculating engine's ragged round: ONE forward serving VERIFY
        rows (per active slot: pending token + draft chain, 2..K+1 queries)
        beside admission chunk rows. Verify rows reserve their worst-case
        window and commit 1..K+1 tokens with the ``trim_reserved`` rollback
        at this same step boundary (``_spec_decode_rounds`` at one round);
        admission rows keep the plain round's contract. With no verify row
        the plain round serves."""
        spec = self.cfg.speculative
        assert spec is not None
        k = spec.num_draft_tokens
        admissions = self._live_admissions(admissions)
        b = len(self.slots)

        # --- verify rows: depth selection + worst-case reservation (up to
        # K+1 fed tokens plus the pending one); exhaustion freezes the row
        budgets = np.zeros((b,), np.int32)
        cand: List[int] = []
        for i, s in enumerate(self.slots):
            if s is None or s.finish_reason is not None or s.prefilling:
                continue
            rem = s.request.sampling.max_new_tokens - len(s.generated)
            if rem <= 0:
                continue
            budgets[i] = rem
            cand.append(i)
        ks_sel = self._select_spec_ks(cand)
        caps = np.zeros((b,), np.int32)
        spec_rows = np.zeros((b,), bool)
        pressured: List[int] = []
        for i in cand:
            s = self.slots[i]
            assert s is not None
            cur = len(self.manager.seq_tokens[s.seq_id])
            ki = int(ks_sel[i])
            want = min(ki + 1, int(budgets[i])) + ki + 1
            n_res = max(min(want, self.cfg.max_seq_len - cur), 0)
            try:
                if n_res > 0 and self.manager.reserve_tokens(s.seq_id, n_res):
                    self._block_tables[i] = self.manager.block_table_for(
                        s.seq_id, self.cfg.max_blocks_per_seq)
            except OutOfBlocksError:
                self.manager.trim_reserved(s.seq_id)
                self._block_tables[i] = self.manager.block_table_for(
                    s.seq_id, self.cfg.max_blocks_per_seq)
                pressured.append(i)
                continue
            spec_rows[i] = True
            caps[i] = cur + n_res
        if pressured:
            self._signal_pressure("decode", slots=pressured)
        if not spec_rows.any():
            # no verify row (admission-only, or every candidate pressured
            # out of its window): the plain round serves the chunk rows
            # with the same arithmetic, and a pressured slot may still fit
            # a one-token step
            return self._plain_ragged_round(admissions, chunk_caps)

        ready, width = self._ragged_admission_rows(admissions, chunk_caps)
        self._apply_pending()
        # a pure-verify round is K+1 wide; wider chunk rows bucket as usual
        s_w = k + 1 if width <= k + 1 else self._bucket_len(width)
        toks_pos = np.zeros((2, b, s_w), np.int32)
        toks_pos[1] = -1
        lens_after = np.zeros((b,), np.int32)
        mode = "mixed" if any(self._temps[i] > 0 for i in np.nonzero(spec_rows)[0]) \
            else "greedy"
        if self._fill_ragged_admission_rows(ready, toks_pos, lens_after):
            mode = "mixed"
        verify = [int(i) for i in np.nonzero(spec_rows)[0]]
        forced = self._spec_forced(verify, 1, ks_sel)[0]
        with self._device_work():
            tok0, emitted, n_acc = self._spec_ragged_device(
                toks_pos, lens_after, spec_rows, ks_sel, caps, forced, mode)
        self.stats["ragged_rounds"] += 1
        self.stats["decode_calls"] += 1
        self.stats["spec_steps"] += 1
        if ready:
            self.stats["prefill_calls"] += 1
        out: Dict[int, List[int]] = {}
        for i in verify:
            if spec.adaptive:
                self._spec_ema_update(i, int(n_acc[i]))
            s = self.slots[i]
            assert s is not None
            self._commit_spec_row(i, emitted[i], int(n_acc[i]), int(ks_sel[i]), out)
            # rollback of the rejected window at the same step boundary
            if self.manager.trim_reserved(s.seq_id):
                self._block_tables[i] = self.manager.block_table_for(
                    s.seq_id, self.cfg.max_blocks_per_seq)
            self._maybe_release_window(i)
        self._commit_ragged_admissions(ready, tok0, out)
        return out

    def _spec_ragged_device(self, toks_pos: np.ndarray, lens_after: np.ndarray,
                            spec_rows: np.ndarray, ks_sel: np.ndarray, caps: np.ndarray,
                            forced: np.ndarray, mode: str
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The device part of :meth:`_spec_ragged_round`: the draft chain
        overwrites the verify rows' columns, one forward with no LM head,
        then the head over a gathered [B, K+1] slice (chain offsets for
        verify rows, the last valid index for chunk rows). → (each row's
        first sample [B], emission record [B, K+1], accepted counts [B])."""
        k = self.cfg.speculative.num_draft_tokens
        b, s_w = toks_pos.shape[1:]
        lens = self._tensor(self._kv_lens)
        spec_t = self._tensor(spec_rows)
        ks_t, caps_t = self._tensor(ks_sel), self._tensor(caps)
        lens_after_t = self._tensor(lens_after)
        offs = torch.arange(k + 1, dtype=torch.int32, device=self.device)[None, :]
        rows = torch.arange(b, device=self.device)
        h = self._spec_h_device()
        chunk = self._draft_chain(self._tensor(self._last_tokens), h)
        pos_spec = lens[:, None] + offs
        pos_spec = torch.where(
            spec_t[:, None] & (offs <= ks_t[:, None]) & (pos_spec < caps_t[:, None]),
            pos_spec, torch.full_like(pos_spec, -1))
        pad = s_w - (k + 1)
        token_ids = torch.where(spec_t[:, None], F.pad(chunk, (0, pad)),
                                self._tensor(toks_pos[0]))
        positions = torch.where(spec_t[:, None], F.pad(pos_spec, (0, pad), value=-1),
                                self._tensor(toks_pos[1]))
        kv_lens = torch.where(spec_t, lens + ks_t + 1, lens_after_t)
        out = llama.forward_chunk(
            self.model_cfg, self.params, token_ids, positions, self.kv,
            self._tensor(self._block_tables), kv_lens, block_size=self.cfg.block_size,
            last_only=False, with_logits=False, allow_fused=False)
        last_idx = ((positions >= 0).sum(dim=1) - 1).clamp(min=0)
        gidx = torch.where(spec_t[:, None], offs.clamp(max=s_w - 1), last_idx[:, None])
        hsel = torch.gather(out.hidden, 1,
                            gidx.long()[:, :, None].expand(-1, -1, out.hidden.shape[-1]))
        logits = llama.project_logits(self.model_cfg, self.params, hsel)
        target_pred = greedy_tokens(logits)
        n_acc = self._accept_chain(chunk, target_pred, ks_t, self._tensor(forced), lens,
                                   caps_t, offs)
        bonus = target_pred[rows, n_acc.long()]
        # sample positions: lens + 1 for verify rows, lens_after for chunk
        # rows — the plain paths' key folds
        samp_pos = torch.where(spec_t, lens + 1, lens_after_t)
        tok0 = self._sample(logits[:, 0, :], range(b), samp_pos, mode)
        if mode == "mixed":
            is_sampled = self._tensor(self._temps) > 0.0
            n_acc = torch.where(is_sampled & spec_t, torch.zeros_like(n_acc), n_acc)
            bonus = torch.where(is_sampled, tok0, bonus)
        emitted = ordered_emission(chunk[:, 1:], n_acc, bonus, spec_t)
        new_h = hsel[rows, n_acc.long()]
        self._spec_h = torch.where(spec_t[:, None], new_h, h)
        return tok0.cpu().numpy(), emitted.cpu().numpy(), n_acc.cpu().numpy()

    def finish_slot(self, slot: int, cache: bool = True) -> InferenceResponse:
        s = self.slots[slot]
        if s is None:
            raise ValueError(f"slot {slot} empty")
        self.manager.free_sequence(s.seq_id, cache=cache)
        self.slots[slot] = None
        self._kv_lens[slot] = 0
        self.stats["completed"] += 1
        now = time.time()
        resp = InferenceResponse(
            request_id=s.request.request_id,
            token_ids=list(s.generated),
            finish_reason=s.finish_reason or "abort",
            prompt_tokens=s.prompt_len,
            completion_tokens=len(s.generated),
            cached_tokens=s.cached_tokens,
            ttft_ms=(s.first_token_time - s.start_time) * 1000.0
            if s.first_token_time
            else None,
            e2e_ms=(now - s.start_time) * 1000.0,
        )
        # flight recorder: the engine's own wall-clock boundaries, so
        # timeline events anchor where the engine observed them
        if s.start_time is not None:
            resp.extra["t_start"] = s.start_time
        if s.first_token_time is not None:
            resp.extra["t_first_token"] = s.first_token_time
        return resp

    # ---------------------------------------------------------- generate

    def generate(
        self,
        requests: Sequence[InferenceRequest],
        use_multi_step: bool = False,
        max_preemptions: int = 8,
    ) -> List[InferenceResponse]:
        """Batch-generate to completion (waves of <= max_batch_size).
        KV-pressure safe: admissions the pool cannot hold wait, decode
        pressure preempts the most-recently-admitted sequence (resume
        continues it byte-identically), and a request preempted more than
        ``max_preemptions`` times finishes with a ``preempted_too_often``
        error instead of livelocking the wave.

        Only this call's own requests are driven to the end, preempted and
        finished: a slot someone else holds (an adopted PD handoff waiting
        for its decode stage, a stream between steps) shares the decode
        rounds but stays bound for its owner."""
        own = {r.request_id for r in requests}

        def own_slots() -> List[int]:
            return [i for i, s in enumerate(self.slots)
                    if s is not None and s.request.request_id in own]

        pending = []
        responses: Dict[str, InferenceResponse] = {}
        for r in requests:
            if self.request_fits_pool(r):
                pending.append(r)
            else:
                responses[r.request_id] = InferenceResponse(
                    request_id=r.request_id,
                    error="request exceeds KV pool capacity (prompt cannot "
                          "fit an idle pool)",
                )
        preempted: List[PreemptedSequence] = []
        stamp = itertools.count()
        admitted_at: Dict[int, int] = {}
        preempt_counts: Dict[str, int] = {}
        stalled = 0
        # after a preemption, resumes pause for one unpressured round so
        # the FROZEN slots reserve first
        hold_resume = False
        while pending or preempted or own_slots():
            progressed = False
            n_free = len(self.free_slots())
            while preempted and n_free > 0 and not hold_resume:
                try:
                    slot = self.resume(preempted[0])
                except OutOfBlocksError:
                    break
                preempted.pop(0)
                admitted_at[slot] = next(stamp)
                n_free -= 1
                progressed = True
            if pending and n_free > 0:
                wave, pending = pending[:n_free], pending[n_free:]
                try:
                    slots = self.submit_batch(wave, partial=True)
                except OutOfBlocksError:
                    slots = []
                pending = wave[len(slots):] + pending
                for sl in slots:
                    admitted_at[sl] = next(stamp)
                progressed = progressed or bool(slots)
            if own_slots():
                out = (
                    self.decode_multi() if use_multi_step
                    else self.decode_step()
                )
                progressed = progressed or bool(out)
            pressure = self.take_pressure()
            if pressure is None:
                hold_resume = False
            elif pressure.source == "decode":
                victims = [
                    i for i in own_slots()
                    if self.slots[i].finish_reason is None
                    and not self.slots[i].prefilling
                ]
                if victims:
                    victim = max(
                        victims, key=lambda sl: admitted_at.get(sl, -1)
                    )
                    pre = self.preempt_slot(victim)
                    rid = pre.request.request_id
                    count = preempt_counts.get(rid, 0) + 1
                    preempt_counts[rid] = count
                    pre.preempt_count = count
                    if count > max_preemptions:
                        responses[rid] = InferenceResponse(
                            request_id=rid,
                            token_ids=list(pre.generated),
                            finish_reason="abort",
                            prompt_tokens=pre.prompt_len,
                            completion_tokens=len(pre.generated),
                            error="preempted_too_often: KV pool cannot "
                                  f"sustain this sequence ({count} "
                                  "preemptions)",
                        )
                    else:
                        preempted.append(pre)
                        hold_resume = True
                    progressed = True
            if not progressed:
                stalled += 1
                if stalled > 8 and preempted and not own_slots() \
                        and not pending:
                    pre = preempted.pop(0)
                    rid = pre.request.request_id
                    responses[rid] = InferenceResponse(
                        request_id=rid,
                        token_ids=list(pre.generated),
                        finish_reason="abort",
                        prompt_tokens=pre.prompt_len,
                        completion_tokens=len(pre.generated),
                        error="request exceeds KV pool capacity: generated "
                              f"context ({len(pre.generated)} tokens) can "
                              "no longer be resumed",
                    )
                    stalled = 0
                elif stalled > 32:
                    raise OutOfBlocksError(
                        "generate wedged under KV pressure: "
                        f"{len(pending)} pending, {len(preempted)} "
                        f"preempted, {len(own_slots())} active — the pool "
                        "cannot hold even one waiting sequence"
                    )
            else:
                stalled = 0
            for i in own_slots():
                if self.slots[i].finish_reason is not None:
                    resp = self.finish_slot(i)
                    responses[resp.request_id] = resp
        return [responses[r.request_id] for r in requests]

    def get_stats(self) -> Dict[str, Any]:
        out = dict(self.stats)
        out["kv_cache"] = self.manager.get_stats()
        out["active_slots"] = self.num_active
        if self._tp_group is not None:
            if self.tp > 1 and self.seq > 1:
                # the group over every rank, and each axis's sub-group
                out["mesh"] = {"seq": self.seq, "model": self.tp,
                               "backend": self._tp_group.backend, **self._tp_group.stats}
                for key, axis, size in (("tp", AXIS_MODEL, self.tp),
                                        ("seq", AXIS_SEQ, self.seq)):
                    out[key] = {"size": size, "backend": self._tp_group.backend,
                                **self._tp_group.axis_group(axis).stats}
            else:
                out["tp" if self.tp > 1 else "seq"] = {
                    "size": max(self.tp, self.seq), "backend": self._tp_group.backend,
                    **self._tp_group.stats}
        if self.cfg.speculative is not None:
            drafted = out.get("spec_drafted", 0)
            slot_steps = out.get("spec_slot_steps", 0)
            # accepted / drafted, and tokens committed per slot-round (the
            # weight-stream amortization factor)
            out["spec_accept_rate"] = (
                out.get("spec_accepted", 0) / drafted if drafted else 0.0)
            out["spec_tokens_per_step"] = (
                out.get("spec_emitted", 0) / slot_steps if slot_steps else 0.0)
        return out
