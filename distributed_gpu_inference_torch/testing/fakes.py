"""Lightweight engine stand-ins for receiver-side protocol tests: the
PyTorch port's copy of ``distributed_gpu_inference_tpu/testing/fakes.py``.

:class:`FakeKVEngine` implements exactly the surface
:class:`~distributed_gpu_inference_torch.runtime.kv_handoff.HandoffReceiver`
touches — block accounting, pending upload staging,
slot binding — with real conservation semantics (blocks leave a free list
on allocate and return on free) but no device, no model. Chaos
scenarios replay streamed-handoff failures across dozens of seeds in
milliseconds while still driving the production receiver code.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple


@dataclass
class FakeEngineConfig:
    block_size: int = 4
    max_blocks_per_seq: int = 16
    max_seq_len: int = 64


@dataclass
class _FakeModelCfg:
    name: str = "fake-model"
    sliding_window: Optional[int] = None


class _FakePending:
    def __init__(self) -> None:
        self.uploads: List[Tuple[int, Any]] = []
        self.scale_uploads: List[Tuple[int, Any]] = []


class FakeBlockManager:
    """Free-list block accounting with the BlockManager call surface the
    handoff receiver uses. No prefix cache (``cached_tokens`` is 0)."""

    def __init__(self, num_blocks: int, block_size: int) -> None:
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.free_blocks: List[int] = list(range(num_blocks))
        self.seq_blocks: Dict[str, List[int]] = {}
        self.seq_tokens: Dict[str, List[int]] = {}
        self.seq_window_front: Dict[str, int] = {}
        self.pending = _FakePending()
        # block id → last page applied (what a commit would decode from)
        self.applied: Dict[int, Any] = {}

    def allocate_sequence(self, seq_id: str,
                          token_ids: Sequence[int]) -> Tuple[List[int], int]:
        if seq_id in self.seq_blocks:
            raise ValueError(f"sequence {seq_id!r} already allocated")
        n = max(1, -(-len(token_ids) // self.block_size))
        if n > len(self.free_blocks):
            raise RuntimeError("fake pool out of blocks")
        blocks = [self.free_blocks.pop(0) for _ in range(n)]
        self.seq_blocks[seq_id] = blocks
        self.seq_tokens[seq_id] = [int(t) for t in token_ids]
        return list(blocks), 0

    def append_token(self, seq_id: str, token_id: int) -> None:
        toks = self.seq_tokens[seq_id]
        toks.append(int(token_id))
        if -(-len(toks) // self.block_size) > len(self.seq_blocks[seq_id]):
            self.seq_blocks[seq_id].append(self.free_blocks.pop(0))

    def free_sequence(self, seq_id: str, cache: bool = True) -> None:
        self.free_blocks.extend(self.seq_blocks.pop(seq_id))
        self.seq_tokens.pop(seq_id, None)
        self.seq_window_front.pop(seq_id, None)

    def seed_window_front(self, seq_id: str, front: int) -> None:
        self.seq_window_front[seq_id] = front


class FakeKVEngine:
    """Engine facade for :class:`HandoffReceiver` tests."""

    def __init__(self, cfg: Optional[FakeEngineConfig] = None,
                 num_blocks: int = 64, num_slots: int = 4,
                 model_name: str = "fake-model") -> None:
        self.cfg = cfg or FakeEngineConfig()
        self.model_cfg = _FakeModelCfg(name=model_name)
        self.kv: Dict[str, Any] = {"k": None, "v": None}
        self.manager = FakeBlockManager(num_blocks, self.cfg.block_size)
        self.slots: List[Any] = [None] * num_slots
        self._kv_lens = [0] * num_slots
        self._last_tokens = [0] * num_slots
        self._slot_keys: List[Any] = [None] * num_slots
        self.binds = 0

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def _bind_slot(self, slot: int, s: Any, kv_len: int) -> None:
        self.slots[slot] = s
        self._kv_lens[slot] = kv_len
        self.binds += 1

    def _apply_pending(self) -> None:
        # mirrors the real engine: staged uploads land immediately and the
        # pending lists drain; ``applied`` records what reached "device"
        for bid, page in self.manager.pending.uploads:
            self.manager.applied[bid] = page
        self.manager.pending.uploads = []
        self.manager.pending.scale_uploads = []

    # -- invariants ----------------------------------------------------------

    def leaked_blocks(self) -> int:
        """Blocks neither free nor owned by a live sequence."""
        owned = sum(len(b) for b in self.manager.seq_blocks.values())
        return self.manager.num_blocks - len(self.manager.free_blocks) - owned


# ---------------------------------------------------------------------------
# synthetic streamed-handoff message sequences
# ---------------------------------------------------------------------------


def stream_kind(msg: bytes) -> str:
    """Human name of a streamed-handoff message's kind byte (for fault-rule
    ``match`` context in ``FaultPlan.filter_stream``)."""
    if len(msg) < 6 or msg[:4] != b"TPUS":
        return "blob"
    return {0: "begin", 1: "piece", 2: "commit", 3: "abort"}.get(
        msg[5], "unknown"
    )


def make_stream_messages(
    key: str,
    prompt: Sequence[int],
    block_size: int = 4,
    piece_blocks: int = 2,
    max_new_tokens: int = 4,
    pending_token: int = 7,
) -> List[bytes]:
    """Build a full begin → pieces → commit sequence a
    :class:`HandoffReceiver` over a :class:`FakeKVEngine` accepts: the wire
    framing is the real one (``runtime.kv_handoff._pack_stream``), only the
    page payloads are tiny synthetic tensors, written as uncompressed
    ``TPUT`` frames — byte for byte what the JAX package's writer makes.
    Chaos scenarios mangle this sequence (loss / reorder / duplication /
    truncation) and assert the receiver's cleanup invariants."""
    import torch

    from ..runtime.kv_handoff import (
        _KIND_BEGIN,
        _KIND_COMMIT,
        _KIND_PIECE,
        _pack_stream,
    )
    from ..utils.serialization import serialize

    prompt = [int(t) for t in prompt]
    token_ids = prompt + [int(pending_token)]
    n_blocks = -(-len(token_ids) // block_size)
    msgs = [_pack_stream(_KIND_BEGIN, {
        "key": key,
        "model_name": "fake-model",
        "block_size": block_size,
        "int8_kv": False,
        "request": {
            "request_id": f"r-{key}",
            "model": None,
            "prompt_token_ids": prompt,
            "sampling": {"max_new_tokens": max_new_tokens,
                         "temperature": 0.0, "top_k": 0, "top_p": 1.0,
                         "stop_token_ids": [], "seed": None},
            "priority": 0,
            "session_id": key,
        },
    })]
    for lo in range(0, n_blocks, piece_blocks):
        hi = min(n_blocks, lo + piece_blocks)
        # [n, L=1, 2, H=1, Bk, D=2], value = block index (checkable later)
        pages = torch.stack([
            torch.full((1, 2, 1, block_size, 2), float(i), dtype=torch.float32)
            for i in range(lo, hi)
        ])
        msgs.append(_pack_stream(
            _KIND_PIECE, {"key": key, "block_lo": lo}, serialize(pages)
        ))
    msgs.append(_pack_stream(_KIND_COMMIT, {
        "key": key,
        "token_ids": token_ids,
        "kv_len": len(prompt),
        "pending_token": int(pending_token),
        "prompt_len": len(prompt),
        "generated": [],
        "start_time": 0.0,
        "first_token_time": 0.001,
        "slot_key": [1, 2, 3, 4],
        "finish_reason": None,
    }))
    return msgs
