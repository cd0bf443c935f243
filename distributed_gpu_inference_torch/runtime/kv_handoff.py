"""Prefill→decode KV handoff and cluster KV migration on PyTorch: export a
sequence's KV pages, move the bytes, and adopt them into another engine
mid-generation.

The port of ``distributed_gpu_inference_tpu/runtime/kv_handoff.py``, wire
compatible with it both ways (a JAX donor's messages adopt here, and this
module's adopt in a JAX engine):

- **One-shot**: :func:`export_slot_kv` gathers a slot's block chain on the
  device and copies it to pinned host memory in one batched copy per pool
  (``TorchEngine.gather_pages``); :func:`serialize_handoff` frames the
  msgpack metadata and the pages as one ``[n, L, 2, Hkv, Bk, D]`` tensor
  straight from that staging block; :func:`adopt_kv` allocates a chain in
  the recipient (prefix-cache aware), stages the page uploads through the
  manager's ``PendingDeviceOps`` (one host-to-device copy and one
  ``index_copy_`` per pool when they apply) and binds a slot with the exact
  pending-token state, so the next decode round continues the generation.
- **Device path**: :func:`migrate_kv_device` moves a live sequence between
  two engines whose pools share one device — one ``index_select`` +
  ``index_copy_`` per pool, scale pools included, with no host hop.
- **Streamed**: :class:`StreamedExport` runs a (chunked) prefill and yields
  ``TPUS`` v1 ``begin`` / ``piece`` / ``commit`` messages; each piece's
  gather and device-to-host copy are enqueued behind the prefill chunk that
  completed its blocks and waited on (a CUDA event) only when the message
  is built, while the next chunk computes. :class:`HandoffReceiver` is the
  recipient's session machine for those messages and one-shot blobs alike.
- **Cluster KV migration**: :func:`export_prefix_frames` answers a peer's
  ``/kv/export`` pull with prefix-only frames of the same protocol, sourced
  from the device radix and the spill tiers.

Wire rules: frames are ``TPUT`` tensors (``utils/serialization.py``),
zstd-compressed where the JAX package compresses them by default (the
one-shot handoff), through the port's own codec (``utils/zstd.py``);
streamed pieces and prefix exports go uncompressed, as JAX writes them by
default, and a compressed piece from a JAX peer is read all the same. An
int8 pool's compact scales
``[L, 2, Bk]`` travel expanded to the JAX layout ``[n, L, 2, Bk, D]`` and
come back after the every-lane check. Every metadata map is the hand-written
msgpack of ``utils/serialization.py``, byte-identical to the JAX package's.

No step falls back: a failed gather, copy or adopt raises, and the device
path never becomes the wire path by itself.
"""

from __future__ import annotations

import io
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from distributed_gpu_inference_torch.runtime.kv_cache import (
    compact_scales,
    expand_scales,
)
from distributed_gpu_inference_torch.testing import faults as _faults
from distributed_gpu_inference_torch.utils import serialization
from distributed_gpu_inference_torch.utils.data_structures import (
    InferenceRequest,
    SamplingParams,
    compute_prefix_hash,
)

if TYPE_CHECKING:  # pragma: no cover
    from distributed_gpu_inference_torch.runtime.engine import HostPages, TorchEngine


@dataclass
class KVHandoff:
    """Everything needed to continue a generation on another engine."""

    request: InferenceRequest
    model_name: str
    block_size: int
    token_ids: List[int]            # prompt + generated incl. the pending token
    kv_len: int                     # committed positions (KV valid for [0, kv_len))
    pending_token: int              # sampled, KV not yet written
    prompt_len: int
    generated: List[int]
    # carried across so TTFT/E2E stay end-to-end truthful
    start_time: float
    first_token_time: Optional[float]
    # the slot's key words: an unseeded sampled generation keeps its stream
    slot_key: Optional[List[int]] = None
    # sliding-window models: leading logical blocks the donor released
    # (their exported pages are pad garbage; the recipient skips them and
    # replicates the release state)
    window_front: int = 0
    # a donor whose FIRST sampled token hit a stop id finished with
    # generated=[]: the recipient must not decode it
    finish_reason: Optional[str] = None
    # int8 pools: scales [n, L, 2, Bk] bf16 (the port's compact layout;
    # [n, L, 2, Bk, D] on the wire)
    scale_pages: Optional[torch.Tensor] = field(repr=False, default=None)
    # pages [n, L, 2, Hkv, Bk, D] in the pool's dtype, on the host
    pages: Optional[torch.Tensor] = field(repr=False, default=None)

    @property
    def num_blocks(self) -> int:
        return 0 if self.pages is None else int(self.pages.shape[0])

    @property
    def nbytes(self) -> int:
        return 0 if self.pages is None else self.pages.numel() * self.pages.element_size()


def _request_meta(req: InferenceRequest) -> Dict[str, Any]:
    """The request map of a handoff's metadata. The deadline crosses as an
    ABSOLUTE time, omitted (not null) when unset."""
    return {
        "request_id": req.request_id,
        "model": req.model,
        "prompt_token_ids": req.prompt_token_ids,
        "sampling": req.sampling.to_dict(),
        "priority": req.priority,
        "session_id": req.session_id,
        **({"deadline_at": req.deadline_at}
           if req.deadline_s is not None else {}),
    }


def _request_from_meta(r: Dict[str, Any]) -> InferenceRequest:
    request = InferenceRequest(
        request_id=r["request_id"],
        model=r.get("model"),
        prompt_token_ids=r.get("prompt_token_ids"),
        sampling=SamplingParams.from_dict(r["sampling"]),
        priority=r.get("priority", 0),
        session_id=r.get("session_id"),
    )
    if r.get("deadline_at") is not None:
        # absolute → relative against this engine's fresh arrival_time:
        # elapsed handoff time stays spent, EDF order survives
        request.deadline_s = max(0.0, float(r["deadline_at"]) - request.arrival_time)
    return request


def export_slot_kv(engine: "TorchEngine", slot: int) -> KVHandoff:
    """Snapshot ``slot``'s sequence out of ``engine`` (the slot stays live;
    callers that migrate ``finish_slot`` afterwards). The pages are the
    pinned staging block of one batched gather, not per-page copies."""
    s = engine.slots[slot]
    if s is None:
        raise ValueError(f"slot {slot} empty")
    host = engine.gather_pages(engine.manager.seq_blocks[s.seq_id])
    return KVHandoff(
        request=s.request,
        model_name=engine.model_cfg.name,
        block_size=engine.cfg.block_size,
        token_ids=list(engine.manager.seq_tokens[s.seq_id]),
        kv_len=int(engine._kv_lens[slot]),
        pending_token=int(engine._last_tokens[slot]),
        prompt_len=s.prompt_len,
        generated=list(s.generated),
        start_time=s.start_time,
        first_token_time=s.first_token_time,
        slot_key=[int(x) for x in engine._slot_keys[slot]],
        window_front=engine.manager.seq_window_front.get(s.seq_id, 0),
        finish_reason=s.finish_reason,
        pages=host.pages,
        scale_pages=host.scales,
    )


def _validate_capacity(engine: "TorchEngine", n_tokens: int,
                       kv_len: int, remaining: int) -> None:
    """Reject a migration the recipient cannot hold or finish — before any
    allocator, device or wire work, so a rejected handoff leaks nothing.
    Shared by the one-shot, streamed and device paths."""
    n_blocks = max(1, -(-n_tokens // engine.cfg.block_size))
    if n_blocks > engine.cfg.max_blocks_per_seq:
        raise ValueError(
            f"handoff needs {n_blocks} blocks > engine max_blocks_per_seq "
            f"{engine.cfg.max_blocks_per_seq}"
        )
    if n_tokens > engine.cfg.max_seq_len:
        raise ValueError("handoff sequence exceeds engine max_seq_len")
    if kv_len + 1 + remaining > engine.cfg.max_seq_len:
        raise ValueError(
            f"handoff needs headroom for {remaining} more tokens at kv_len "
            f"{kv_len}, exceeding engine max_seq_len {engine.cfg.max_seq_len}"
        )


def _check_pages(engine: "TorchEngine", pages: torch.Tensor,
                 scales: Optional[torch.Tensor]) -> None:
    """Reject wire pages that do not fit the recipient's pools (dtype,
    page shape, scales present iff int8) before they are staged: a bad
    upload must fail the handoff, never the engine's device round."""
    layout = getattr(engine, "_page_layout", None)
    if layout is None:
        return
    shape, _, sshape, _ = layout()
    want = engine.kv["k"].dtype
    if pages.dtype != want or tuple(pages.shape[1:]) != tuple(shape):
        raise ValueError(
            f"handoff pages {pages.dtype} {tuple(pages.shape[1:])} do not fit "
            f"the pool's {want} {tuple(shape)}"
        )
    if (scales is None) != (sshape is None) or (
            scales is not None and (tuple(scales.shape) != (pages.shape[0], *sshape)
                                    or scales.dtype != torch.bfloat16)):
        raise ValueError("handoff scales do not fit the pool's scale layout")


def _bind_migrated(engine: "TorchEngine", slot: int, *, request, seq_id: str,
                   prompt_len: int, generated, cached_tokens: int,
                   start_time: float, first_token_time, kv_len: int,
                   pending_token: int, slot_key, finish_reason) -> None:
    """Install a migrated sequence into ``slot``: the one bind sequence all
    three migration paths share, so pending-token, key-word and
    finish-state semantics cannot drift between them. The caller owns the
    allocator/session cleanup on failure."""
    from distributed_gpu_inference_torch.runtime.engine import _Slot

    s = _Slot(
        request=request,
        seq_id=seq_id,
        prompt_len=prompt_len,
        generated=list(generated),
        cached_tokens=cached_tokens,
        start_time=start_time,
        first_token_time=first_token_time,
        # a donor that already finished stays finished: decode rounds skip
        # the slot and finish_slot reports the donor's reason
        finish_reason=finish_reason,
    )
    engine._bind_slot(slot, s, kv_len=kv_len)
    engine._last_tokens[slot] = int(pending_token)
    if slot_key is not None:
        engine._slot_keys[slot] = np.asarray(slot_key, np.uint32)
    engine._apply_pending()


def _drop_staged(engine: "TorchEngine", staged: Sequence[int]) -> None:
    """Withdraw staged uploads into ``staged`` blocks: once those ids
    return to the free list a later apply would write donor pages over
    another sequence's blocks."""
    if not staged:
        return
    drop = set(staged)
    p = engine.manager.pending
    p.uploads = [(b, page) for b, page in p.uploads if b not in drop]
    p.scale_uploads = [(b, page) for b, page in p.scale_uploads if b not in drop]


def adopt_kv(engine: "TorchEngine", handoff: KVHandoff,
             slot: Optional[int] = None) -> int:
    """Materialize ``handoff`` into ``engine``: allocate blocks, stage page
    uploads, bind a slot. Returns the slot index; the next decode round
    resumes the generation."""
    if engine.model_cfg.name != handoff.model_name:
        raise ValueError(
            f"model mismatch: engine={engine.model_cfg.name} "
            f"handoff={handoff.model_name}"
        )
    if engine.cfg.block_size != handoff.block_size:
        raise ValueError("block_size mismatch between engines")
    if (handoff.scale_pages is not None) != ("k_scale" in engine.kv):
        raise ValueError(
            "kv_cache_dtype mismatch: an int8-KV handoff (raw int8 pages + "
            "scales) can only adopt into an int8-KV engine, and vice versa"
        )
    _check_pages(engine, handoff.pages, handoff.scale_pages)
    if slot is None:
        free = engine.free_slots()
        if not free:
            raise RuntimeError("no free slots")
        slot = free[0]
    if engine.slots[slot] is not None:
        raise RuntimeError(f"slot {slot} busy")
    req = handoff.request
    # capacity first: a rejected handoff must leave the allocator and the
    # pending ops as they were; the recipient must be able to FINISH
    _validate_capacity(
        engine, len(handoff.token_ids), handoff.kv_len,
        0 if handoff.finish_reason is not None else
        req.sampling.max_new_tokens - len(handoff.generated),
    )
    seq_id = f"{req.request_id}-pd"
    blocks, cached_tokens = engine.manager.allocate_sequence(seq_id, handoff.token_ids)
    staged: List[int] = []
    try:
        cached_blocks = cached_tokens // engine.cfg.block_size
        for i in range(cached_blocks, len(blocks)):
            if i < handoff.window_front:
                continue    # released by the donor: its page is pad garbage
            engine.manager.pending.uploads.append((blocks[i], handoff.pages[i]))
            if handoff.scale_pages is not None:
                engine.manager.pending.scale_uploads.append(
                    (blocks[i], handoff.scale_pages[i]))
            staged.append(blocks[i])
        # the donor's release state, before binding: released entries pin
        # to pad block 0 and free_sequence keeps the chain out of the radix
        if handoff.window_front > 0:
            engine.manager.seed_window_front(seq_id, handoff.window_front)
        _bind_migrated(
            engine, slot, request=req, seq_id=seq_id,
            prompt_len=handoff.prompt_len, generated=handoff.generated,
            cached_tokens=cached_tokens, start_time=handoff.start_time,
            first_token_time=handoff.first_token_time,
            kv_len=handoff.kv_len, pending_token=handoff.pending_token,
            slot_key=handoff.slot_key, finish_reason=handoff.finish_reason,
        )
    except Exception:
        engine.slots[slot] = None
        engine._kv_lens[slot] = 0
        _drop_staged(engine, staged)
        engine.manager.free_sequence(seq_id, cache=False)
        raise
    return slot


# ---------------------------------------------------------------- wire


def _frame_blobs(*blobs: bytes) -> bytes:
    """The 8-byte-little-endian length-prefixed multi-blob framing every
    handoff encoder shares."""
    out = io.BytesIO()
    for b in blobs:
        out.write(len(b).to_bytes(8, "little"))
        out.write(b)
    return out.getvalue()


def _read_blobs(data: bytes, count: int) -> List[bytes]:
    view = memoryview(data)
    off, out = 0, []
    for _ in range(count):
        if off + 8 > len(view):
            raise ValueError(
                f"malformed handoff frame: truncated length prefix at "
                f"offset {off} (frame is {len(view)} bytes)"
            )
        n = int.from_bytes(view[off:off + 8], "little")
        if off + 8 + n > len(view):
            raise ValueError(
                f"malformed handoff frame: blob of {n} bytes at offset "
                f"{off} overruns the {len(view)}-byte frame"
            )
        out.append(bytes(view[off + 8:off + 8 + n]))
        off += 8 + n
    return out


def _wire_scales(scales: torch.Tensor, d: int, compress: bool = False) -> bytes:
    return serialization.serialize(expand_scales(scales, d), compress=compress)


def _read_pages(pages_blob: bytes, scales_blob: Optional[bytes]
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    pages = serialization.deserialize(pages_blob)
    scales = None if scales_blob is None else compact_scales(
        serialization.deserialize(scales_blob))
    return pages, scales


def serialize_handoff(h: KVHandoff, compress: bool = True) -> bytes:
    """Frame a handoff for a network hop: msgpack metadata, the pages as
    one ``TPUT`` tensor and, for int8 pools, the scales in the JAX layout,
    zstd-compressed where ``compress`` (the JAX default). With
    ``compress=False`` the bytes equal the JAX package's
    ``serialize_handoff(h, compress=False)`` of the same state.
    Pickle-free: a peer cannot smuggle executable payloads."""
    meta = {
        "request": _request_meta(h.request),
        "model_name": h.model_name,
        "block_size": h.block_size,
        "token_ids": h.token_ids,
        "kv_len": h.kv_len,
        "pending_token": h.pending_token,
        "prompt_len": h.prompt_len,
        "generated": h.generated,
        "start_time": h.start_time,
        "first_token_time": h.first_token_time,
        "slot_key": h.slot_key,
        "window_front": h.window_front,
        "finish_reason": h.finish_reason,
        "has_scales": h.scale_pages is not None,
    }
    blobs = [serialization.packb(meta), serialization.serialize(h.pages, compress=compress)]
    if h.scale_pages is not None:
        blobs.append(_wire_scales(h.scale_pages, h.pages.shape[-1], compress))
    return _frame_blobs(*blobs)


def deserialize_handoff(data: bytes) -> KVHandoff:
    meta: Dict[str, Any] = serialization.unpackb(_read_blobs(data, 1)[0])
    blobs = _read_blobs(data, 3 if meta.get("has_scales") else 2)
    pages, scales = _read_pages(blobs[1], blobs[2] if meta.get("has_scales") else None)
    return KVHandoff(
        request=_request_from_meta(meta["request"]),
        model_name=meta["model_name"],
        block_size=meta["block_size"],
        token_ids=meta["token_ids"],
        kv_len=meta["kv_len"],
        pending_token=meta["pending_token"],
        prompt_len=meta["prompt_len"],
        generated=meta["generated"],
        start_time=meta["start_time"],
        first_token_time=meta["first_token_time"],
        slot_key=meta.get("slot_key"),
        window_front=meta.get("window_front", 0),
        finish_reason=meta.get("finish_reason"),
        pages=pages,
        scale_pages=scales,
    )


# ---------------------------------------------------------------- device path


def migrate_kv_device(src: "TorchEngine", dst: "TorchEngine", slot: int,
                      dst_slot: Optional[int] = None) -> int:
    """Move a live sequence between two engines whose pools share devices:
    the pages move pool→pool as one ``index_select`` + ``index_copy_``
    per pool (scale pools included) on the current stream, with no host
    hop; only slot metadata rides the host. The donor slot stays live (the
    caller decides ``finish_slot``, as with :func:`export_slot_kv`).
    Engines on different devices raise: that is the wire path's job.

    Engines on a mesh (tensor, sequence or both axes) whose ranks sit on
    the same devices as the other engine's (JAX's condition: the two
    engines share devices): each engine's ranks are processes of their
    own, so the pages go through the ranks' own page transfers, the
    donor's :meth:`TorchEngine.gather_pages` (every rank's heads and
    blocks of each page met in its group, into pinned host staging) and
    the recipient's :meth:`TorchEngine.push_pages` (broadcast to its ranks,
    each writing its heads and blocks). Pages and scales arrive bitwise."""
    src.refuse_other_devices("migrate_kv_device", dst)
    dst.refuse_other_devices("migrate_kv_device", src)
    s = src.slots[slot]
    if s is None:
        raise ValueError(f"slot {slot} empty")
    if src.model_cfg.name != dst.model_cfg.name:
        raise ValueError("model mismatch between engines")
    if src.cfg.block_size != dst.cfg.block_size:
        raise ValueError("block_size mismatch between engines")
    if src.kv_dtype != dst.kv_dtype:
        raise ValueError("kv_cache_dtype mismatch between engines")
    on_mesh = src._ranks is not None or dst._ranks is not None
    if src.device != dst.device and not on_mesh:
        raise ValueError(
            f"migrate_kv_device needs engines on one device (got {src.device} "
            f"and {dst.device}); use the wire path (export_slot_kv / "
            "StreamedExport) across devices"
        )
    window_front = src.manager.seq_window_front.get(s.seq_id, 0)
    token_ids = list(src.manager.seq_tokens[s.seq_id])
    src_blocks = list(src.manager.seq_blocks[s.seq_id])
    if dst_slot is None:
        free = dst.free_slots()
        if not free:
            raise RuntimeError("no free slots")
        dst_slot = free[0]
    if dst.slots[dst_slot] is not None:
        raise RuntimeError(f"slot {dst_slot} busy")
    req = s.request
    kv_len = int(src._kv_lens[slot])
    _validate_capacity(
        dst, len(token_ids), kv_len,
        0 if s.finish_reason is not None else
        req.sampling.max_new_tokens - len(s.generated),
    )
    seq_id = f"{req.request_id}-pd"
    dst_blocks, cached_tokens = dst.manager.allocate_sequence(seq_id, token_ids)
    try:
        cached_blocks = cached_tokens // dst.cfg.block_size
        pairs = [(src_blocks[i], dst_blocks[i]) for i in range(len(dst_blocks))
                 if i >= cached_blocks and i >= window_front and i < len(src_blocks)]
        if pairs:
            # the recipient's own pending ops (copy-on-write from the
            # allocation) land before the pages are overwritten
            dst._apply_pending()
            if on_mesh:
                host = src.gather_pages([a for a, _ in pairs])
                n = len(pairs)
                with dst._device_work():
                    dst.push_pages([b for _, b in pairs], list(host.pages.unbind(0)),
                                   [None] * n if host.scales is None
                                   else list(host.scales.unbind(0)))
            else:
                with dst._device_work():
                    src_idx = torch.tensor([a for a, _ in pairs], dtype=torch.long,
                                           device=dst.device)
                    dst_idx = torch.tensor([b for _, b in pairs], dtype=torch.long,
                                           device=dst.device)
                    for key in sorted(src.kv):
                        dst.kv[key].index_copy_(1, dst_idx,
                                                src.kv[key].index_select(1, src_idx))
        if window_front > 0:
            dst.manager.seed_window_front(seq_id, window_front)
        _bind_migrated(
            dst, dst_slot, request=req, seq_id=seq_id,
            prompt_len=s.prompt_len, generated=s.generated,
            cached_tokens=cached_tokens, start_time=s.start_time,
            first_token_time=s.first_token_time, kv_len=kv_len,
            pending_token=int(src._last_tokens[slot]),
            slot_key=src._slot_keys[slot],
            finish_reason=s.finish_reason,
        )
    except Exception:
        dst.slots[dst_slot] = None
        dst._kv_lens[dst_slot] = 0
        dst.manager.free_sequence(seq_id, cache=False)
        raise
    return dst_slot


# ---------------------------------------------------------------- streamed handoff
#
# Three message kinds on the same /kv/transfer socket (magic-discriminated,
# so one-shot blobs keep working): ``begin`` at prefill start (the receiver
# allocates its chain while the donor computes), ``piece`` — a block range's
# pages once those positions' KV is final — and ``commit`` after the first
# token samples (the receiver binds the slot). ``abort`` drops a session.

_STREAM_MAGIC = b"TPUS"
_KIND_BEGIN, _KIND_PIECE, _KIND_COMMIT, _KIND_ABORT = 0, 1, 2, 3


def is_stream_message(data: bytes) -> bool:
    return data[:4] == _STREAM_MAGIC


def message_kind(data: bytes) -> str:
    """Name of a handoff message's kind (fault-rule ``match`` context of
    the sender's push seam); one-shot blobs are ``blob``."""
    if len(data) < 6 or not is_stream_message(data):
        return "blob"
    return {_KIND_BEGIN: "begin", _KIND_PIECE: "piece",
            _KIND_COMMIT: "commit", _KIND_ABORT: "abort"}.get(data[5], "unknown")


def _pack_stream(kind: int, meta: Dict[str, Any], payload: bytes = b"") -> bytes:
    mb = serialization.packb(meta)
    return b"".join([_STREAM_MAGIC, bytes([1, kind]), len(mb).to_bytes(4, "little"),
                     mb, payload])


def _unpack_stream(data: bytes) -> Tuple[int, Dict[str, Any], bytes]:
    if data[:4] != _STREAM_MAGIC:
        raise ValueError("not a streamed handoff message")
    if len(data) < 10:
        raise ValueError(
            f"malformed handoff frame: {len(data)}-byte message is shorter "
            "than the 10-byte stream header"
        )
    if data[4] != 1:
        raise ValueError(f"unsupported stream version {data[4]}")
    kind = data[5]
    n = int.from_bytes(data[6:10], "little")
    if n == 0 or 10 + n > len(data):
        raise ValueError(
            f"malformed handoff frame: {n}-byte stream header overruns "
            f"the {len(data)}-byte message"
        )
    meta = serialization.unpackb(bytes(data[10:10 + n]))
    return kind, meta, bytes(data[10 + n:])


def _piece_frame(key: str, block_lo: int, pages: torch.Tensor,
                 scales: Optional[torch.Tensor]) -> bytes:
    pb = serialization.serialize(pages)
    if scales is None:
        return _pack_stream(_KIND_PIECE, {"key": key, "block_lo": block_lo}, pb)
    return _pack_stream(
        _KIND_PIECE, {"key": key, "block_lo": block_lo, "has_scales": True},
        _frame_blobs(pb, _wire_scales(scales, pages.shape[-1])),
    )


class StreamedExport:
    """The donor side: runs a request's (chunked) prefill on ``engine``
    and generates the streamed handoff messages::

        exp = StreamedExport(engine, request, key)
        for msg in exp.messages():
            send(msg)                  # POST to the receiver, in order
        exp.first_token, exp.ttft_ms   # set once messages() is exhausted

    The overlap: each loop iteration launches the next prefill chunk, then
    builds the previous piece — waiting on the CUDA event of its gather,
    which was enqueued right behind the chunk that completed its blocks —
    and only then enqueues the gather of the blocks this chunk completes.
    The host serializes and sends while the device computes; nothing here
    synchronises the whole stream. The donor slot is freed when the
    generator ends (or aborts). Sliding-window models are refused: window
    release during admission would stream pages the commit then discards.
    """

    def __init__(self, engine: "TorchEngine", request: InferenceRequest,
                 key: str, piece_blocks: int = 4) -> None:
        if engine.model_cfg.sliding_window is not None:
            raise ValueError(
                "streamed handoff does not support sliding-window models "
                "(use the one-shot path)"
            )
        self._quant = "k_scale" in engine.kv
        self.engine = engine
        self.request = request
        self.key = key
        self.piece_blocks = max(1, piece_blocks)
        # results (set when messages() completes)
        self.first_token: Optional[int] = None
        self.ttft_ms: Optional[float] = None
        self.prompt_tokens: int = 0
        self.bytes_sent: int = 0
        self.pieces_sent: int = 0
        # bytes handed to the sender BEFORE the first token (the overlap)
        self.bytes_before_first_token: int = 0

    def _begin_msg(self) -> bytes:
        return _pack_stream(_KIND_BEGIN, {
            "key": self.key,
            "model_name": self.engine.model_cfg.name,
            "block_size": self.engine.cfg.block_size,
            "int8_kv": self._quant,
            "request": _request_meta(self.request),
        })

    def _piece_msg(self, block_lo: int, host: "HostPages") -> bytes:
        host.wait()
        return _piece_frame(self.key, block_lo, host.pages, host.scales)

    def _gather(self, blocks: List[int]) -> "HostPages":
        return self.engine.gather_pages(blocks, wait=False)

    def messages(self):
        eng = self.engine
        bs = eng.cfg.block_size
        adm = eng.submit_chunked_start(self.request)
        slot = adm.slot
        try:
            yield self._begin_msg()
            chain = eng.manager.seq_blocks[adm.seq_id]
            sent = 0                            # blocks exported so far
            pending: Optional[Tuple[int, Any]] = None  # (block_lo, gather)
            while not adm.done:
                eng.submit_chunked_step(adm)    # launch the next chunk
                full = adm.off // bs
                if pending is not None:
                    msg = self._piece_msg(*pending)
                    if self.first_token is None:
                        self.bytes_before_first_token += len(msg)
                    self.bytes_sent += len(msg)
                    self.pieces_sent += 1
                    yield msg
                    pending = None
                if full > sent:
                    hi = min(full, sent + self.piece_blocks)
                    pending = (sent, self._gather(chain[sent:hi]))
                    sent = hi
            # prefill finished: record the results, then flush the tail
            s = eng.slots[slot]
            self.first_token = int(eng._last_tokens[slot])
            self.prompt_tokens = s.prompt_len
            self.ttft_ms = ((s.first_token_time - s.start_time) * 1000.0
                            if s.first_token_time else None)
            if pending is not None:
                msg = self._piece_msg(*pending)
                self.bytes_sent += len(msg)
                self.pieces_sent += 1
                yield msg
                pending = None
            # the pending token's append may have grown the chain by one
            # block (uncommitted; kv_len marks validity)
            chain = eng.manager.seq_blocks[adm.seq_id]
            while sent < len(chain):
                hi = min(len(chain), sent + self.piece_blocks)
                msg = self._piece_msg(sent, self._gather(chain[sent:hi]))
                self.bytes_sent += len(msg)
                self.pieces_sent += 1
                yield msg
                sent = hi
            commit = _pack_stream(_KIND_COMMIT, {
                "key": self.key,
                "token_ids": list(eng.manager.seq_tokens[adm.seq_id]),
                "kv_len": int(eng._kv_lens[slot]),
                "pending_token": int(eng._last_tokens[slot]),
                "prompt_len": s.prompt_len,
                "generated": list(s.generated),
                "start_time": s.start_time,
                "first_token_time": s.first_token_time,
                "slot_key": [int(x) for x in eng._slot_keys[slot]],
                "finish_reason": s.finish_reason,
            })
            self.bytes_sent += len(commit)
            yield commit
        except BaseException:
            # free the donor slot on ANY exit, the consumer closing the
            # generator early included; the transport tells the receiver
            if not adm.done:
                eng.abort_chunked(adm)
            elif eng.slots[slot] is not None:
                eng.finish_slot(slot, cache=False)
            raise
        else:
            eng.finish_slot(slot, cache=False)


def abort_message(key: str) -> bytes:
    """Tell a receiver to drop a streamed-handoff session (donor failed)."""
    return _pack_stream(_KIND_ABORT, {"key": key})


# ---------------------------------------------------------------- cluster KV migration
#
# A cold worker PULLS a peer's cached prefix instead of re-prefilling: it
# POSTs an export request to the peer's /kv/export, and the peer answers
# with framed prefix-only begin / piece / commit messages. The puller feeds
# them through its own HandoffReceiver; a prefix-only commit binds no slot
# and releases the chain into the radix, so the next admission hits L1.

EXPORT_REQUEST_VERSION = 1


def pack_export_request(*, key: str, token_ids: Sequence[int], model_name: str,
                        block_size: int, int8_kv: bool, max_blocks: int = 64,
                        start_block: int = 0, fp: Optional[str] = None) -> bytes:
    """Wire form of a ``/kv/export`` pull request. ``start_block``: leading
    full blocks the puller already holds (only the rest is shipped);
    ``fp``: a text-space prefix fingerprint in place of token ids (a
    plane-hinted puller never saw the prompt)."""
    return serialization.packb({
        "v": EXPORT_REQUEST_VERSION,
        "key": key,
        "token_ids": [int(t) for t in token_ids],
        "model_name": model_name,
        "block_size": int(block_size),
        "int8_kv": bool(int8_kv),
        "max_blocks": int(max_blocks),
        "start_block": max(0, int(start_block)),
        **({"fp": str(fp)} if fp else {}),
    })


def unpack_export_request(raw: bytes) -> Dict[str, Any]:
    req = serialization.unpackb(raw)
    if not isinstance(req, dict) or int(req.get("v") or 0) != EXPORT_REQUEST_VERSION:
        got = req.get("v") if isinstance(req, dict) else req
        raise ValueError(f"unsupported kv export request version {got!r}")
    return req


def split_frames(data: bytes) -> List[bytes]:
    """Split a ``/kv/export`` response body into its stream messages (an
    empty body = no match). Raises on truncation: a peer dying mid-response
    is a failed pull, never a silently shorter prefix."""
    view = memoryview(data)
    off, out = 0, []
    while off < len(view):
        if off + 8 > len(view):
            raise ValueError(
                f"truncated kv export response: length prefix cut at "
                f"offset {off} of {len(view)} bytes"
            )
        n = int.from_bytes(view[off:off + 8], "little")
        if off + 8 + n > len(view):
            raise ValueError(
                f"truncated kv export response: {n}-byte frame at offset "
                f"{off} overruns the {len(view)}-byte body"
            )
        out.append(bytes(view[off + 8:off + 8 + n]))
        off += 8 + n
    return out


def export_prefix_frames(engine: "TorchEngine", token_ids: Sequence[int],
                         key: str, *, piece_blocks: int = 4,
                         max_blocks: int = 64, start_block: int = 0
                         ) -> Tuple[List[bytes], Dict[str, int]]:
    """The prefix-only begin / piece / commit frames of the longest
    locally cached full-block prefix of ``token_ids``: device radix blocks
    in one batched gather, then blocks past the device-resident run probed
    out of the spill tiers (host RAM, then the remote store). Only blocks
    ``[start_block, n)`` ship. → (frames, {"dev_blocks", "spill_blocks"});
    no frames when the peer has nothing beyond ``start_block``. Runs
    serialized with the engine (its executor): the gather reads live pages
    and the probe mutates LRU state."""
    mgr = engine.manager
    bs = engine.cfg.block_size
    empty = {"dev_blocks": 0, "spill_blocks": 0}
    token_ids = [int(t) for t in token_ids]
    start = max(0, int(start_block))
    n_full = min(len(token_ids) // bs, max(0, int(max_blocks)))
    if n_full <= start or not mgr.enable_prefix_cache:
        return [], empty
    prefix = token_ids[: n_full * bs]
    cached = mgr.radix.match_prefix(prefix)[:n_full]
    quant = "k_scale" in engine.kv
    ship_dev = cached[start:]
    dev = engine.gather_pages(ship_dev) if ship_dev else None
    # past the device-resident run the spill tiers serve too; probe hits
    # are not this worker's serving traffic, so the l2/l3 hit counters are
    # restored (promote-on-hit is kept)
    spill: List[Tuple[torch.Tensor, Optional[torch.Tensor]]] = []
    spill_lo = max(len(cached), start)
    idx = spill_lo
    st = mgr.stats
    l2_before, l3_before = st.l2_hits, st.l3_hits
    try:
        while idx < n_full:
            hit = mgr._probe_spill(compute_prefix_hash(prefix, (idx + 1) * bs))
            if hit is None:
                break
            spill.append(hit)
            idx += 1
    finally:
        st.l2_hits, st.l3_hits = l2_before, l3_before
    n = idx
    if n <= start:
        return [], empty

    def piece(lo: int, hi: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        if hi <= len(cached):       # device blocks only: a slice of the block
            return (dev.pages[lo - start:hi - start],
                    dev.scales[lo - start:hi - start] if quant else None)
        rows = [(dev.pages[i - start], dev.scales[i - start] if quant else None)
                if i < len(cached) else spill[i - spill_lo] for i in range(lo, hi)]
        return (torch.stack([p for p, _ in rows]),
                torch.stack([s for _, s in rows]) if quant else None)

    frames = [_pack_stream(_KIND_BEGIN, {
        "key": key,
        "model_name": engine.model_cfg.name,
        "block_size": bs,
        "int8_kv": quant,
        "prefix_only": True,
        "token_ids": prefix[: n * bs],
    })]
    step = max(1, int(piece_blocks))
    for lo in range(start, n, step):
        frames.append(_piece_frame(key, lo, *piece(lo, min(n, lo + step))))
    frames.append(_pack_stream(_KIND_COMMIT, {
        "key": key, "prefix_only": True, "kv_len": n * bs,
    }))
    return frames, {"dev_blocks": len(ship_dev), "spill_blocks": len(spill)}


# ---------------------------------------------------------------- receiver


@dataclass
class _AdoptSession:
    seq_id: str
    request: InferenceRequest
    block_size: int
    blocks: List[int]
    cached_tokens: int
    prompt_len: int
    # cluster KV migration: a prefix-only session's commit releases the
    # chain into the radix instead of binding a slot
    prefix_only: bool = False
    staged: List[int] = field(default_factory=list)
    # refreshed on every piece: only sessions with no traffic for
    # SESSION_TTL_S are stale
    last_activity: float = field(default_factory=time.monotonic)
    # refreshed only when a piece stages a block not staged before: a
    # trickler re-sending one block forever hits the backstop
    last_progress: float = field(default_factory=time.monotonic)


def _missing_blocks(sess: _AdoptSession, kv_len: int) -> List[int]:
    """Blocks covering the committed KV range that were neither staged nor
    resident through the receiver's prefix cache."""
    cached_blocks = sess.cached_tokens // sess.block_size
    needed = -(-kv_len // sess.block_size)
    staged = set(sess.staged)
    return [i for i in range(cached_blocks, min(needed, len(sess.blocks)))
            if sess.blocks[i] not in staged]


class HandoffReceiver:
    """Recipient-side session machine: ``handle(raw)`` dispatches begin /
    piece / commit / abort messages AND one-shot blobs, so a data plane
    needs one receiver callable. The caller serializes it with the engine
    (the worker runs it on the batcher's executor)."""

    SESSION_TTL_S = 180.0
    # no-progress backstop: a donor that keeps a session warm without ever
    # staging a new block must not pin its blocks forever
    SESSION_MAX_NO_PROGRESS_S = 10 * 180.0
    # session count cap: past it the stalest session is evicted at begin
    MAX_SESSIONS = 32
    # recently committed keys: a retried commit whose ACK was lost answers
    # the original result instead of failing a handoff that landed
    MAX_COMMIT_MEMO = 32
    FLIGHT_KEY_CAP = 64

    def __init__(self, engine: "TorchEngine") -> None:
        self.engine = engine
        self._sessions: Dict[str, _AdoptSession] = {}
        self._recent_commits: Dict[str, Dict[str, Any]] = {}
        # abandoned sessions reclaimed (by reason), sender aborts, commits,
        # duplicate begins and commit replays: every recovery path counted
        self.stats: Dict[str, int] = {
            "sessions_purged": 0,
            "purged_ttl": 0,
            "purged_no_progress": 0,
            "purged_cap": 0,
            "rx_aborts": 0,
            "commits": 0,
            "prefix_commits": 0,
            "begin_duplicates": 0,
            "commit_replays": 0,
        }
        # flight recorder: receiver-side begin/commit/abort instants by
        # session key, popped by the decode stage that claims the adoption
        self._flight: Dict[str, List[Tuple[str, float]]] = {}

    def _flight_note(self, key: str, name: str) -> None:
        if not key:
            return
        evs = self._flight.get(key)
        if evs is None:
            while len(self._flight) >= self.FLIGHT_KEY_CAP:
                self._flight.pop(next(iter(self._flight)))
            evs = self._flight[key] = []
        if len(evs) < 8:
            evs.append((name, time.time()))

    def pop_flight(self, key: str) -> List[Tuple[str, float]]:
        """Drain the receiver-side flight events of one session key
        (``[(event, wall_ts), ...]``)."""
        return self._flight.pop(key, [])

    def handle(self, raw: bytes) -> Dict[str, Any]:
        # chaos seam: a fault plan can truncate or lose this message
        raw = _faults.mutate_bytes("kv.receiver.message", raw)
        self._purge_stale()
        if not is_stream_message(raw):
            handoff = deserialize_handoff(raw)
            key = handoff.request.session_id or handoff.request.request_id
            slot = adopt_kv(self.engine, handoff)
            return {"slot": slot, "bytes_received": len(raw),
                    "kv_cache_key": key, "streamed": False}
        kind, meta, payload = _unpack_stream(raw)
        if kind == _KIND_BEGIN:
            return self._begin(meta)
        if kind == _KIND_PIECE:
            try:
                return self._piece(meta, payload, len(raw))
            except Exception:
                # a malformed piece poisons the stream: abort the session
                # now so its blocks free at once
                self._drop(str(meta.get("key", "")))
                raise
        if kind == _KIND_COMMIT:
            return self._commit(meta)
        if kind == _KIND_ABORT:
            return self._abort(meta)
        raise ValueError(f"unknown stream message kind {kind}")

    def _count(self, name: str) -> None:
        self.stats[name] = self.stats.get(name, 0) + 1

    def _remember(self, key: str, result: Dict[str, Any]) -> None:
        self._recent_commits[key] = result
        while len(self._recent_commits) > self.MAX_COMMIT_MEMO:
            self._recent_commits.pop(next(iter(self._recent_commits)))

    def _begin(self, meta: Dict[str, Any]) -> Dict[str, Any]:
        eng = self.engine
        if eng.model_cfg.name != meta["model_name"]:
            raise ValueError(
                f"model mismatch: engine={eng.model_cfg.name} "
                f"handoff={meta['model_name']}"
            )
        if eng.cfg.block_size != meta["block_size"]:
            raise ValueError("block_size mismatch between engines")
        if bool(meta.get("int8_kv")) != ("k_scale" in eng.kv):
            raise ValueError(
                "kv_cache_dtype mismatch: int8-KV donors stream raw int8 "
                "pages + scales and can only land in int8-KV engines "
                "(and vice versa)"
            )
        key = meta["key"]
        prefix_only = bool(meta.get("prefix_only"))
        existing = self._sessions.get(key)
        if existing is not None:
            rid = (meta.get("request") or {}).get("request_id")
            if prefix_only:
                rid = f"kvmig-{key}"      # the key is the idempotency token
            if existing.request.request_id == rid:
                # a retried begin whose ACK was lost: same request
                self._count("begin_duplicates")
                return {"kv_cache_key": key, "state": "begun",
                        "cached_tokens": existing.cached_tokens,
                        "duplicate": True}
            raise ValueError(
                f"streamed handoff {key!r} already begun by another request"
            )
        # age out stale sessions, then evict the stalest past the cap
        self._purge_stale()
        while len(self._sessions) >= self.MAX_SESSIONS:
            stalest = min(self._sessions, key=lambda k: self._sessions[k].last_activity)
            self._drop(stalest)
            self._count("sessions_purged")
            self._count("purged_cap")
        if prefix_only:
            toks = [int(t) for t in (meta.get("token_ids") or [])]
            bs = int(meta["block_size"])
            if not toks or len(toks) % bs != 0:
                raise ValueError(
                    "prefix-only handoff needs a whole-block token_ids "
                    f"prefix (got {len(toks)} tokens, block size {bs})"
                )
            if len(toks) // bs > eng.cfg.max_blocks_per_seq or \
                    len(toks) > eng.cfg.max_seq_len:
                raise ValueError("prefix-only handoff exceeds engine sequence bounds")
            request = InferenceRequest(
                request_id=f"kvmig-{key}", prompt_token_ids=toks,
                sampling=SamplingParams(max_new_tokens=1),
            )
            seq_id = f"{key}-kvmig"
            # a transfer is not a serving request: restore the query stats
            # the allocation bumps (failure path included)
            st = eng.manager.stats
            before = (st.prefix_queries, st.prefix_hit_tokens,
                      st.prefix_total_tokens, st.misses, st.l1_hits)
            try:
                blocks, cached_tokens = eng.manager.allocate_sequence(seq_id, toks)
            finally:
                (st.prefix_queries, st.prefix_hit_tokens,
                 st.prefix_total_tokens, st.misses, st.l1_hits) = before
            self._sessions[key] = _AdoptSession(
                seq_id=seq_id, request=request, block_size=bs,
                blocks=list(blocks), cached_tokens=cached_tokens,
                prompt_len=len(toks), prefix_only=True,
            )
            return {"kv_cache_key": key, "state": "begun",
                    "cached_tokens": cached_tokens, "prefix_only": True}
        request = _request_from_meta(meta["request"])
        prompt = list(request.prompt_token_ids or [])
        if not prompt:
            raise ValueError("streamed handoff with empty prompt")
        # the full capacity check at begin: the commit state is prompt + 1
        # pending token, so remaining = max_new - 1 (the commit's bound)
        _validate_capacity(eng, len(prompt) + 1, len(prompt),
                           max(request.sampling.max_new_tokens - 1, 0))
        seq_id = f"{request.request_id}-pd"
        blocks, cached_tokens = eng.manager.allocate_sequence(seq_id, prompt)
        self._sessions[key] = _AdoptSession(
            seq_id=seq_id, request=request, block_size=meta["block_size"],
            blocks=list(blocks), cached_tokens=cached_tokens, prompt_len=len(prompt),
        )
        self._flight_note(key, "handoff.rx_begin")
        return {"kv_cache_key": key, "state": "begun", "cached_tokens": cached_tokens}

    def _piece(self, meta: Dict[str, Any], payload: bytes,
               raw_len: int) -> Dict[str, Any]:
        # receiver-side staging faults ride the corrupt-piece contract
        payload = _faults.io_bytes("io.handoff.stage", payload,
                                   key=str(meta.get("key", "")))
        sess = self._require(meta["key"])
        sess.last_activity = time.monotonic()
        if meta.get("has_scales"):
            pages, scales = _read_pages(*_read_blobs(payload, 2))
        else:
            pages, scales = _read_pages(payload, None)
        eng = self.engine
        _check_pages(eng, pages, scales)
        lo = int(meta["block_lo"])
        cached_blocks = sess.cached_tokens // sess.block_size
        uploaded = 0
        already = set(sess.staged)
        for j in range(pages.shape[0]):
            i = lo + j
            if i >= len(sess.blocks):
                # the donor's chain can grow one block past the prompt
                # (the pending token's): never read, skipped
                continue
            if i < cached_blocks:
                continue    # receiver-side prefix hit: already resident
            eng.manager.pending.uploads.append((sess.blocks[i], pages[j]))
            if scales is not None:
                eng.manager.pending.scale_uploads.append((sess.blocks[i], scales[j]))
            if sess.blocks[i] not in already:
                sess.last_progress = time.monotonic()
            sess.staged.append(sess.blocks[i])
            uploaded += 1
        eng._apply_pending()
        return {"kv_cache_key": meta["key"], "state": "staged",
                "blocks": uploaded, "bytes_received": raw_len}

    def _commit(self, meta: Dict[str, Any]) -> Dict[str, Any]:
        key = meta["key"]
        if key not in self._sessions and key in self._recent_commits:
            self._count("commit_replays")
            return {**self._recent_commits[key], "replay": True}
        sess = self._require(key)
        eng = self.engine
        if sess.prefix_only:
            missing = _missing_blocks(sess, int(meta.get("kv_len") or sess.prompt_len))
            if missing:
                self._drop(key)
                raise ValueError(
                    f"prefix handoff {key!r}: commit with unstaged blocks "
                    f"{missing[:8]}{'...' if len(missing) > 8 else ''} "
                    f"(piece lost in transit?) — session aborted"
                )
            eng.manager.free_sequence(sess.seq_id, cache=True)
            del self._sessions[key]
            self._count("prefix_commits")
            result = {"kv_cache_key": key, "state": "committed",
                      "prefix_only": True, "blocks": len(sess.blocks),
                      "cached_tokens": sess.cached_tokens, "streamed": True}
            self._remember(key, result)
            return result
        req = sess.request
        token_ids = list(meta["token_ids"])
        # committing over a lost piece would bind a slot to unwritten pages
        missing = _missing_blocks(sess, int(meta["kv_len"]))
        if missing:
            self._drop(key)
            raise ValueError(
                f"streamed handoff {key!r}: commit with unstaged blocks "
                f"{missing[:8]}{'...' if len(missing) > 8 else ''} "
                f"(piece lost in transit?) — session aborted"
            )
        try:
            _validate_capacity(
                eng, len(token_ids), int(meta["kv_len"]),
                0 if meta.get("finish_reason") is not None else
                req.sampling.max_new_tokens - len(meta["generated"]),
            )
        except ValueError:
            self._drop(key)
            raise
        free = eng.free_slots()
        if not free:
            self._drop(key)
            raise RuntimeError("no free slots")
        slot = free[0]
        try:
            # mirror the donor's pending-token append (may grow the chain)
            for tok in token_ids[len(eng.manager.seq_tokens[sess.seq_id]):]:
                eng.manager.append_token(sess.seq_id, tok)
            _bind_migrated(
                eng, slot, request=req, seq_id=sess.seq_id,
                prompt_len=sess.prompt_len, generated=meta["generated"],
                cached_tokens=sess.cached_tokens,
                start_time=meta["start_time"],
                first_token_time=meta["first_token_time"],
                kv_len=int(meta["kv_len"]),
                pending_token=int(meta["pending_token"]),
                slot_key=meta.get("slot_key"),
                finish_reason=meta.get("finish_reason"),
            )
        except Exception:
            eng.slots[slot] = None
            eng._kv_lens[slot] = 0
            self._drop(key)
            raise
        del self._sessions[key]
        self._count("commits")
        self._flight_note(key, "handoff.rx_commit")
        result = {"slot": slot, "kv_cache_key": key, "state": "committed",
                  "streamed": True}
        self._remember(key, result)
        return result

    def _abort(self, meta: Dict[str, Any]) -> Dict[str, Any]:
        key = str(meta.get("key", ""))
        if key in self._sessions:
            self._count("rx_aborts")
            self._flight_note(key, "handoff.rx_abort")
        self._drop(key)
        return {"kv_cache_key": meta.get("key"), "state": "aborted"}

    def _require(self, key: str) -> _AdoptSession:
        sess = self._sessions.get(key)
        if sess is None:
            raise ValueError(f"no streamed handoff session {key!r}")
        return sess

    def _drop(self, key: str) -> None:
        sess = self._sessions.pop(key, None)
        if sess is None:
            return
        eng = self.engine
        _drop_staged(eng, sess.staged)
        if sess.seq_id in eng.manager.seq_blocks:
            eng.manager.free_sequence(sess.seq_id, cache=False)

    def _purge_stale(self) -> None:
        now = time.monotonic()
        for key, sess in list(self._sessions.items()):
            if now - sess.last_activity > self.SESSION_TTL_S:
                reason = "purged_ttl"
            elif now - sess.last_progress > self.SESSION_MAX_NO_PROGRESS_S:
                reason = "purged_no_progress"
            else:
                continue
            self._drop(key)
            self._count("sessions_purged")
            self._count(reason)
