"""Slot-based serving engine over paged KV on one CUDA device.

The port of ``distributed_gpu_inference_tpu/runtime/engine.py`` ``TPUEngine``
(plain engine only: no speculative decoding, no mesh, no sequence-sharded
pools, no spill tiers). Weights may be quantized on load
(``EngineConfig.quantization`` int8 / fp8, ``ops/quantization.py``) and the
KV pools stored as int8 with scale pools or as fp8
(``EngineConfig.kv_cache_dtype``). It owns

- the paged KV pools (``models.llama.init_kv_pools``), updated IN PLACE by
  the forward passes and the copy-on-write page copies,
- a :class:`PagedKVCacheManager` for block accounting, prefix reuse and CoW,
- fixed-size **slot** state (block tables, lengths, sampling params, stop
  ids) as host numpy mirrors that stay authoritative for scheduling,

and exposes the surface the continuous batcher drives: ``submit`` /
``submit_batch``, chunk-interleaved admission, ``ragged_round`` (decode rows
and prefill-chunk rows in one forward), ``decode_multi`` (T decode steps with
stop/budget masking on the device and one host read at the end),
``snapshot_slot`` / ``preempt_slot`` / ``resume`` (or
``resume_chunked_start``, its ragged form), ``finish_slot`` and ``generate``.

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
import zlib
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from distributed_gpu_inference_torch.models import llama
from distributed_gpu_inference_torch.models.configs import (
    ModelConfig,
    get_model_config,
)
from distributed_gpu_inference_torch.ops.paged_attention import kernel_takes
from distributed_gpu_inference_torch.ops.quantization import (
    QUANT_MODES,
    quantize_params,
)
from distributed_gpu_inference_torch.ops.sampling import (
    greedy_tokens,
    sample_tokens_per_slot,
)
from distributed_gpu_inference_torch.runtime.kv_cache import (
    OutOfBlocksError,
    PagedKVCacheManager,
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


class TorchEngine:
    """Paged-KV serving engine for one model on one device."""

    def __init__(
        self,
        model_cfg: ModelConfig | str,
        engine_cfg: Optional[EngineConfig] = None,
        params: Optional[llama.Params] = None,
        seed: int = 0,
        eos_token_id: Optional[int] = None,
        device: Any = "cuda",
    ) -> None:
        """``params``: a params tree in the JAX package's layout, already
        on ``device`` (``models.convert.params_from_numpy`` builds one);
        random init from ``seed`` when absent. With
        ``EngineConfig.quantization`` the matmul weights are quantized on
        load: a random init is consumed leaf by leaf (the peak is the
        full-precision tree plus one quantized leaf); a caller's tree is
        left as it was."""
        self.device = resolve_device(device)
        self.model_cfg = (
            get_model_config(model_cfg) if isinstance(model_cfg, str) else model_cfg
        )
        self.cfg = engine_cfg or EngineConfig()
        if self.model_cfg.num_experts:
            raise NotImplementedError("MoE models are not ported yet")
        self.dtype = llama.torch_dtype(self.cfg.dtype)
        self.kv_dtype = _resolve_kv_dtype(self.cfg.kv_cache_dtype, self.dtype)
        if self.device.type == "cuda":
            check_kernels_take(self.model_cfg, self.dtype, self.kv_dtype)
        mode = self.cfg.quantization
        if mode is not None and mode not in QUANT_MODES:
            raise ValueError(f"unknown quantization {mode!r}; use {QUANT_MODES}")
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = quantize_params(
                llama.init_params(self.model_cfg, gen, self.dtype, self.device),
                mode, consume=True,
            )
        else:
            params = quantize_params(params, mode)
        self.params = params
        self.num_blocks = self.cfg.resolved_num_blocks()
        self.kv = llama.init_kv_pools(
            self.model_cfg, self.num_blocks, self.cfg.block_size, self.kv_dtype,
            self.device,
        )
        self.manager = PagedKVCacheManager(
            self.num_blocks,
            self.cfg.block_size,
            enable_prefix_cache=self.cfg.enable_prefix_cache,
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
        # the exception of a device round that failed mid-update (pools may
        # be half-written); set once, never cleared
        self._failed: Optional[BaseException] = None
        self.stats: Dict[str, Any] = {
            "requests": 0, "completed": 0, "generated_tokens": 0,
            "prefill_tokens": 0, "prefill_calls": 0, "decode_calls": 0,
            "preemptions": 0, "resumes": 0, "kv_pressure_events": 0,
            "ragged_rounds": 0,
        }

    # ------------------------------------------------------- device helpers

    @contextlib.contextmanager
    def _device_work(self) -> Iterator[None]:
        """Every in-place pool update runs inside this guard: a failure
        marks the engine unusable (and is re-raised), and an unusable
        engine refuses the next round loudly."""
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
            raise

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.tensor(arr, device=self.device)

    def _forward(self, toks_pos: np.ndarray, tables: np.ndarray,
                 lens: np.ndarray, *, with_logits: bool = True,
                 allow_fused: bool = True) -> Optional[torch.Tensor]:
        """One forward over host-built batch arrays → last-token logits
        [B, V] (None when ``with_logits`` is False)."""
        out = llama.forward_chunk(
            self.model_cfg, self.params, self._tensor(toks_pos[0]),
            self._tensor(toks_pos[1]), self.kv, self._tensor(tables),
            self._tensor(lens), block_size=self.cfg.block_size,
            last_only=True, with_logits=with_logits, allow_fused=allow_fused,
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
        """Apply the block manager's queued copy-on-write page copies (all
        layers, K and V, and the scale pages of int8 pools — a page without
        its scale is garbage) before the next forward reads the pages."""
        ops = self.manager.take_pending_ops()
        if ops.empty:
            return
        src = torch.tensor([s for s, _ in ops.copies], dtype=torch.long,
                           device=self.device)
        dst = torch.tensor([d for _, d in ops.copies], dtype=torch.long,
                           device=self.device)
        with self._device_work():
            for pool in self.kv.values():
                pool[:, dst] = pool[:, src]

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
        -1); prompts longer than the largest bucket take the chunked path.

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

        def _rollback() -> None:
            for slot, seq_id in admitted:
                self.slots[slot] = None
                self._kv_lens[slot] = 0
                if seq_id in self.manager.seq_blocks:
                    self.manager.free_sequence(seq_id, cache=False)
            # staged copies into now-freed blocks must not apply later
            alive = self.manager.metas
            p = self.manager.pending
            p.copies = [c for c in p.copies if c[0] in alive and c[1] in alive]
            self.stats.update(stats_snapshot)
            self.manager.stats.__dict__.update(mgr_stats_snapshot)

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
                if n_fresh > max_bucket:
                    self._submit_allocated(request, slot, seq_id, token_ids, cached)
                    continue
                bucket = self._bucket_len(max(n_fresh, 1))
                grouped.setdefault(bucket, []).append(
                    (request, slot, seq_id, token_ids, cached)
                )

            b = len(self.slots)
            for bucket, items in sorted(grouped.items()):
                self._apply_pending()
                toks_pos = np.zeros((2, b, bucket), np.int32)
                toks_pos[1] = -1
                lens = np.zeros((b,), np.int32)
                for request, slot, seq_id, token_ids, cached in items:
                    s = _Slot(request=request, seq_id=seq_id,
                              prompt_len=len(token_ids), cached_tokens=cached)
                    self._bind_slot(slot, s, kv_len=len(token_ids))
                    fresh = token_ids[cached:]
                    n = len(fresh)
                    toks_pos[0, slot, :n] = fresh
                    toks_pos[1, slot, :n] = np.arange(cached, cached + n)
                    lens[slot] = cached + n
                    self.stats["prefill_tokens"] += n
                mode = (
                    "greedy"
                    if all(it[0].sampling.temperature <= 0 for it in items)
                    else "mixed"
                )
                with self._device_work():
                    logits = self._forward(toks_pos, self._block_tables, lens)
                    first = self._sample(logits, range(b), lens, mode).cpu().numpy()
                self.stats["prefill_calls"] += 1
                for request, slot, seq_id, token_ids, cached in items:
                    self._record_token(slot, int(first[slot]))
        except Exception as exc:
            _rollback()
            if isinstance(exc, OutOfBlocksError):
                self._signal_pressure("admission", requests=len(requests))
            raise
        return slots_out

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
        return True

    def ragged_round(
        self, admissions: Sequence[ChunkedAdmission] = (),
        chunk_caps: Optional[Dict[int, int]] = None,
    ) -> Dict[int, List[int]]:
        """ONE forward serving a ragged row batch: every active decode slot
        advances one token AND every in-flight admission advances one
        prefill chunk. Decode rows feed their pending token at position
        ``_kv_lens`` (block pre-reserved; pressure freezes the row at the
        step boundary); admission rows run their next chunk, the final
        chunk sampling the first token (a pressured final chunk is NOT
        consumed and retries next round).

        ``chunk_caps``: optional per-admission prefill-token caps for THIS
        round, keyed by slot; a cap <= 0 skips the admission this round.
        Returns {slot: [token]} for every row that sampled; admissions are
        mutated in place and ``adm.done`` flips when the first token lands."""
        admissions = [a for a in admissions if not a.done]
        for adm in admissions:
            s = self.slots[adm.slot]
            if s is None or s.seq_id != adm.seq_id:
                raise RuntimeError("ragged admission slot was freed")
        b = len(self.slots)
        max_bucket = self.cfg.prefill_buckets[-1]
        chunk_cap = min(max(int(self.cfg.ragged_chunk), 1), max_bucket)

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
        for adm, piece, _ in ready:
            sl, n = adm.slot, len(piece)
            toks_pos[0, sl, :n] = piece
            toks_pos[1, sl, :n] = np.arange(adm.off, adm.off + n)
            lens_after[sl] = adm.off + n
            if adm.mode != "greedy":
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
        device: each not-done row feeds its pending token at position
        ``lens`` (writing its KV) and advances; a row is done once it emits
        a stop id or its budget. One host read at the end → emitted
        [B, T] (-1 = masked-out step). Steps past the largest budget would
        be all-masked, so the loop stops there."""
        b = len(self.slots)
        steps = int(min(num_steps, int(budgets.max(initial=0))))
        emitted = np.full((b, num_steps), -1, np.int32)
        if steps <= 0:
            return emitted
        with self._device_work():
            last = self._tensor(self._last_tokens)
            lens = self._tensor(self._kv_lens)
            done = self._tensor(~active_mask)
            n_emit = torch.zeros_like(lens)
            budgets_t = self._tensor(budgets.astype(np.int32))
            stops = self._tensor(self._stop_ids)
            tables = self._tensor(self._block_tables)
            cols = []
            for _ in range(steps):
                cur = (lens + 1).masked_fill(done, 0)
                positions = lens[:, None].masked_fill(done[:, None], -1)
                logits = llama.forward_chunk(
                    self.model_cfg, self.params, last[:, None], positions,
                    self.kv, tables, cur, block_size=self.cfg.block_size,
                    last_only=True,
                ).logits[:, 0, :]
                toks = self._sample(logits, range(b), cur, mode)
                hit_stop = (toks[:, None] == stops).any(dim=1)
                cols.append(toks.masked_fill(done, -1))
                n_emit = n_emit + (~done).to(n_emit.dtype)
                lens = lens + (~done).to(lens.dtype)
                last = torch.where(done, last, toks)
                done = done | hit_stop | (n_emit >= budgets_t)
            emitted[:, :steps] = torch.stack(cols, dim=1).cpu().numpy()
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
        host sees tokens only at the end."""
        num_steps = num_steps or self.cfg.multi_step
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

    def finish_slot(self, slot: int, cache: bool = True) -> InferenceResponse:
        s = self.slots[slot]
        if s is None:
            raise ValueError(f"slot {slot} empty")
        self.manager.free_sequence(s.seq_id, cache=cache)
        self.slots[slot] = None
        self._kv_lens[slot] = 0
        self.stats["completed"] += 1
        now = time.time()
        return InferenceResponse(
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
        error instead of livelocking the wave."""
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
        while pending or preempted or self.num_active:
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
            if self.num_active:
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
                    i for i, s in enumerate(self.slots)
                    if s is not None and s.finish_reason is None
                    and not s.prefilling
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
                if stalled > 8 and preempted and self.num_active == 0 \
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
                        f"preempted, {self.num_active} active — the pool "
                        "cannot hold even one waiting sequence"
                    )
            else:
                stalled = 0
            for i, s in enumerate(list(self.slots)):
                if s is not None and s.finish_reason is not None:
                    resp = self.finish_slot(i)
                    responses[resp.request_id] = resp
        return [responses[r.request_id] for r in requests]

    def get_stats(self) -> Dict[str, Any]:
        out = dict(self.stats)
        out["kv_cache"] = self.manager.get_stats()
        out["active_slots"] = self.num_active
        return out
