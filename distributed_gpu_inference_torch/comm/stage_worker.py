"""Pipeline stage worker: owns a contiguous layer range and serves forwards.

The port of ``distributed_gpu_inference_tpu/comm/stage_worker.py``:

- Stage 0 receives token ids and embeds them; later stages receive the
  ``[B, S, H]`` hidden of the stage before; the last stage also applies
  the final norm and LM head and returns f32 logits for every position.
- Each stage keeps its OWN paged KV pools ``[L_stage, N, Hkv, Bk, D]`` for
  its layers only, addressed by per-session block lists (block 0 is the
  pad block). Only activations cross the wire; the KV stays put.
- Replays are idempotent: a page written again at the same position with
  the same values changes nothing, and a replayed chunk never moves a
  session's ``kv_len`` back. That is what lets ``comm/session.py``
  rebuild a replacement stage by re-driving the history.

A chunk of S > 1 runs the ragged attention kernel, S = 1 the fused decode
kernel, and every projection of an int8 or fp8 tree the quantized matmul
(``models/llama.py`` ``forward_hidden_chunk``); on CPU tensors their plain
versions. Hidden leaves the stage as f32, as in the JAX package.

Several stages may share one device, and the data plane serves each on
several threads. Their forwards enqueue on the device's current stream
(the default stream, which every thread shares), where kernels run in
order; the quantized matmul's one split-K scratch per device orders
itself across streams (``ops/qmm.py`` ``_claim``), so a stage takes no
lock around its device work.

As in the JAX package, all B rows of a chunk get the session's one block
list and one ``kv_lens``: the rows of a B > 1 session write into the same
pages, so one row's keys are the other rows' context (a reference fault
mirrored for parity, ROADMAP §3 item 3).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from distributed_gpu_inference_torch.models import llama
from distributed_gpu_inference_torch.models.configs import ModelConfig, get_model_config
from distributed_gpu_inference_torch.parallel.pipeline import slice_stage_params

def _tensor(a: Any) -> torch.Tensor:
    """A tensor as it is, a numpy array (or list) as a CPU tensor copy."""
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))


@dataclass
class _StageSession:
    session_id: str
    blocks: List[int] = field(default_factory=list)
    kv_len: int = 0
    created_at: float = field(default_factory=time.time)
    steps: int = 0


class StageOutOfBlocksError(RuntimeError):
    pass


class PipelineStageWorker:
    """One stage of a cross-host pipeline, on ``device`` ("cuda" unless
    the caller asks for the CPU).

    ``params``: this stage's tree (``slice_stage_params`` of a whole one);
    else ``full_params`` (a whole tree, in the port's layout) is sliced as
    views; else a random init from ``seed`` (the engine's init) is made
    and sliced. A stage runs whatever B a chunk carries (the JAX
    signature's ``max_batch`` bounds nothing there and is left out)."""

    def __init__(
        self,
        model_cfg: ModelConfig | str,
        layer_range: Tuple[int, int],
        *,
        params: Optional[llama.Params] = None,
        full_params: Optional[llama.Params] = None,
        num_blocks: int = 256,
        block_size: int = 16,
        max_blocks_per_seq: int = 64,
        dtype: str = "float32",
        seed: int = 0,
        device: Any = "cuda",
    ) -> None:
        from distributed_gpu_inference_torch.runtime.engine import (
            check_kernels_take,
            resolve_device,
        )

        self.device = resolve_device(device)
        self.cfg = (
            get_model_config(model_cfg) if isinstance(model_cfg, str) else model_cfg
        )
        self.start, self.end = layer_range
        self.is_first = self.start == 0
        self.is_last = self.end == self.cfg.num_layers
        self.block_size = block_size
        self.max_blocks_per_seq = max_blocks_per_seq
        self.dtype = llama.torch_dtype(dtype)
        if self.device.type == "cuda":
            check_kernels_take(self.cfg, self.dtype, self.dtype)

        if params is None:
            full = full_params
            if full is None:
                from distributed_gpu_inference_torch.models.loader import (
                    load_or_init_params,
                )

                full = load_or_init_params(self.cfg, dtype=self.dtype, seed=seed,
                                           device=self.device)
            params = slice_stage_params(
                full, self.start, self.end, num_layers=self.cfg.num_layers
            )
        wq = params["layers"]["wq"]
        width = (wq["qw"] if isinstance(wq, dict) else wq).shape[-1]
        if width != self.cfg.num_heads * self.cfg.head_dim:
            raise ValueError(
                f"a pipeline stage takes whole layers; wq is {width} wide, not "
                f"{self.cfg.num_heads * self.cfg.head_dim}: a tensor-parallel rank's shard "
                "(stages of tensor-parallel groups are not supported)")
        self.params = params

        # per-stage KV pools cover ONLY the owned layers
        shape = (self.end - self.start, num_blocks, self.cfg.num_kv_heads, block_size,
                 self.cfg.head_dim)
        self.kv = {k: torch.zeros(shape, dtype=self.dtype, device=self.device)
                   for k in ("k", "v")}
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))  # 0 reserved
        self._sessions: Dict[str, _StageSession] = {}
        self._lock = threading.Lock()
        self.stats: Dict[str, Any] = {
            "forwards": 0, "sessions_created": 0, "sessions_closed": 0,
            "tokens_processed": 0,
        }

    # -- session lifecycle ---------------------------------------------------

    def create_session(self, session_id: str) -> Dict[str, Any]:
        with self._lock:
            if session_id in self._sessions:
                # idempotent create: recovery may re-create after a reconnect
                return {"session_id": session_id, "existing": True}
            self._sessions[session_id] = _StageSession(session_id)
            self.stats["sessions_created"] += 1
        return {"session_id": session_id, "existing": False}

    def close_session(self, session_id: str) -> None:
        with self._lock:
            sess = self._sessions.pop(session_id, None)
            if sess is not None:
                self._free.extend(reversed(sess.blocks))
                self.stats["sessions_closed"] += 1

    def _ensure_blocks(self, sess: _StageSession, kv_len_after: int) -> None:
        needed = max(1, -(-kv_len_after // self.block_size))
        if needed > self.max_blocks_per_seq:
            raise StageOutOfBlocksError(
                f"session {sess.session_id} needs {needed} blocks "
                f"> per-seq limit {self.max_blocks_per_seq}"
            )
        while len(sess.blocks) < needed:
            if not self._free:
                raise StageOutOfBlocksError("stage KV pool exhausted")
            sess.blocks.append(self._free.pop())

    # -- forward -------------------------------------------------------------

    def forward(
        self,
        session_id: str,
        x: Any,                 # tokens [B, S] int (first) | hidden [B, S, H]
        positions: Any,         # [B, S] int, -1 = pad
        kv_len_after: int,
    ) -> Dict[str, torch.Tensor]:
        """Run one chunk through this stage's layers → ``{"hidden": [B, S,
        H] f32}`` and, on the last stage, ``{"logits": [B, S, V] f32}``, as
        CPU tensors. ``x`` and ``positions`` are tensors or numpy arrays.
        Raises ``KeyError`` for an unknown session and
        :class:`StageOutOfBlocksError` when its blocks run out."""
        with self._lock:
            sess = self._sessions.get(session_id)
            if sess is None:
                raise KeyError(f"unknown session {session_id}")
            self._ensure_blocks(sess, kv_len_after)
            table = np.zeros((self.max_blocks_per_seq,), np.int32)
            table[: len(sess.blocks)] = sess.blocks
        positions = _tensor(positions).to(torch.int32)
        x = _tensor(x)
        b, dev = positions.shape[0], self.device
        if self.is_first:
            hidden = llama.embed_tokens(self.params, x.to(dev, torch.int32), self.cfg)
        else:
            hidden = x.to(dev, self.dtype)
        hidden, _ = llama.forward_hidden_chunk(
            self.cfg, self.params, hidden, positions.to(dev), self.kv,
            torch.from_numpy(np.tile(table, (b, 1))).to(dev),
            torch.full((b,), kv_len_after, dtype=torch.int32, device=dev),
            block_size=self.block_size,
        )
        out: Dict[str, torch.Tensor] = {"hidden": hidden.float().cpu()}
        if self.is_last:
            out["logits"] = llama.project_logits(self.cfg, self.params, hidden).cpu()
        with self._lock:
            # a replayed chunk never moves the session's clock back
            sess.kv_len = max(sess.kv_len, kv_len_after)
            sess.steps += 1
            self.stats["forwards"] += 1
            self.stats["tokens_processed"] += int((positions >= 0).sum())
        return out

    # -- introspection -------------------------------------------------------

    def health(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "status": "ok",
                "layer_range": [self.start, self.end],
                "is_first": self.is_first,
                "is_last": self.is_last,
                "active_sessions": len(self._sessions),
                "free_blocks": len(self._free),
                "stats": dict(self.stats),
            }
