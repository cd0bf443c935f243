"""Client side of the cross-host pipeline: a session that walks a route of
stage workers, with per-hop retry, spare reroute and history replay.

The port of ``distributed_gpu_inference_tpu/comm/session.py`` on the
standard library's ``http.client`` (the card's machine has no httpx), one
connection a call with the session's timeout on every socket operation:

- :class:`WorkerSession` is one hop: a stage's data plane
  (``comm/data_plane.py`` with ``stage=``), reached by ``create``,
  ``forward`` (a ``comm/wire.py`` message each way) and ``close``;
- :class:`DistributedInferenceSession` drives one generation through the
  route. Each hop retries transport errors and the statuses 404, 500,
  502, 503 and 507 with backoff ``retry_backoff_s * 2**attempt``; any
  other status raises :class:`PipelineHopError` at once. When a hop's
  retries run out, ``_handle_hop_failure`` swaps in a spare that serves
  the same ``BlockRange``, creates the session there and replays every
  recorded chunk through hops ``[0, hop]``: the healthy stages rewrite the
  pages they hold with the same values, and the spare rebuilds its KV;
- :class:`SessionManager` keeps live sessions with LRU eviction.

A hop's forward goes through the fault seam ``comm.session.forward``
(``testing/faults.py`` ``wrap_http``), as in the JAX package.
"""

from __future__ import annotations

import itertools
import json
import logging
import time
import uuid
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from distributed_gpu_inference_torch.comm.data_plane import (
    TRANSPORT_ERRORS,
    HTTPStatusError,
    post_bytes,
)
from distributed_gpu_inference_torch.comm.wire import pack_message, unpack_message
from distributed_gpu_inference_torch.testing import faults as _faults
from distributed_gpu_inference_torch.utils.data_structures import BlockRange, SessionConfig

log = logging.getLogger("torch_pipeline_session")

#: what a hop retries (then reroutes) rather than raising at once
_RETRY_STATUSES = (404, 500, 502, 503, 507)


class PipelineHopError(RuntimeError):
    def __init__(self, hop: int, detail: str) -> None:
        super().__init__(f"hop {hop}: {detail}")
        self.hop = hop
        self.detail = detail


class WorkerSession:
    """One hop: the HTTP client of a stage worker's data plane."""

    def __init__(self, base_url: str, layer_range: BlockRange,
                 timeout_s: float = 60.0) -> None:
        self.base_url = base_url.rstrip("/")
        self.layer_range = layer_range
        self.timeout_s = timeout_s

    def _call(self, path: str, body: Optional[bytes], json_body: bool = False,
              method: str = "POST"):
        headers = {"Content-Type": "application/json"} if json_body else None
        return post_bytes(self.base_url + path, body, self.timeout_s, headers, method)

    def _checked(self, resp, what: str):
        if resp.status_code != 200:
            raise HTTPStatusError(resp, f"{what} {self.base_url}")
        return resp

    def health(self) -> Dict[str, Any]:
        return self._checked(self._call("/health", None, method="GET"), "health").json()

    def create(self, session_id: str) -> None:
        self._checked(self._call("/inference/create_session", json.dumps(
            {"session_id": session_id}).encode(), json_body=True), "create_session")

    def forward(self, session_id: str, x: Any, positions: Any,
                kv_len_after: int) -> Dict[str, torch.Tensor]:
        body = pack_message(
            {"session_id": session_id, "kv_len_after": kv_len_after},
            {"x": x, "positions": positions},
        )
        # chaos seam: drop/delay/error this hop like a flaky stage worker
        # (a passthrough without an installed FaultPlan)
        resp = _faults.wrap_http(
            "comm.session.forward",
            lambda: self._call("/inference/forward", body),
            url=self.base_url, method="POST",
        )
        _, tensors = unpack_message(self._checked(resp, "forward").content)
        return tensors

    def close(self, session_id: str) -> None:
        try:
            self._call("/inference/close", json.dumps(
                {"session_id": session_id}).encode(), json_body=True)
        except TRANSPORT_ERRORS:
            pass


@dataclass
class _ChunkRecord:
    tokens: np.ndarray        # [B, S] int32 (what stage 0 consumed)
    positions: np.ndarray     # [B, S] int32
    kv_len_after: int


class DistributedInferenceSession:
    """Drives a route of stage workers for one generation."""

    def __init__(
        self,
        route: Sequence[WorkerSession],
        config: Optional[SessionConfig] = None,
        spare_workers: Optional[List[WorkerSession]] = None,
        session_id: Optional[str] = None,
    ) -> None:
        if not route:
            raise ValueError("empty route")
        self.route: List[WorkerSession] = list(route)
        self.config = config or SessionConfig()
        self.spares: List[WorkerSession] = list(spare_workers or [])
        self.session_id = session_id or uuid.uuid4().hex
        self.kv_len = 0
        self.history: List[_ChunkRecord] = []
        self.stats: Dict[str, Any] = {
            "steps": 0, "retries": 0, "hop_failures": 0, "reroutes": 0,
            "replayed_chunks": 0,
        }
        self._setup_done = False

    # -- lifecycle -----------------------------------------------------------

    def setup(self) -> None:
        """Create the stage session on every hop."""
        for i, ws in enumerate(self.route):
            try:
                ws.create(self.session_id)
            except TRANSPORT_ERRORS + (HTTPStatusError,) as exc:
                raise PipelineHopError(i, f"create failed: {exc}") from exc
        self._setup_done = True

    def close(self) -> None:
        for ws in self.route:
            ws.close(self.session_id)
        self._setup_done = False

    # -- stepping ------------------------------------------------------------

    def _hop_forward(self, hop: int, x: Any, positions: np.ndarray,
                     kv_len_after: int) -> Dict[str, torch.Tensor]:
        """One hop with per-hop retry and backoff, then failure recovery."""
        ws = self.route[hop]
        last: Optional[Exception] = None
        for attempt in range(self.config.max_retries_per_hop):
            try:
                return ws.forward(self.session_id, x, positions, kv_len_after)
            except TRANSPORT_ERRORS + (HTTPStatusError,) as exc:
                # other 4xx are protocol bugs, not a dead worker
                if isinstance(exc, HTTPStatusError) and \
                        exc.response.status_code not in _RETRY_STATUSES:
                    raise PipelineHopError(hop, str(exc)) from exc
                last = exc
                self.stats["retries"] += 1
                time.sleep(self.config.retry_backoff_s * (2**attempt))
        self.stats["hop_failures"] += 1
        self._handle_hop_failure(hop, last)
        # the replacement is installed and rebuilt; run THIS chunk on it
        return self.route[hop].forward(self.session_id, x, positions, kv_len_after)

    def _handle_hop_failure(self, hop: int, cause: Optional[Exception]) -> None:
        """Swap the dead hop for a spare serving the same layers and rebuild
        its KV by replaying the history through the pipeline prefix."""
        dead = self.route[hop]
        replacement: Optional[WorkerSession] = None
        for i, spare in enumerate(self.spares):
            if spare.layer_range == dead.layer_range:
                replacement = self.spares.pop(i)
                break
        if replacement is None:
            raise PipelineHopError(
                hop,
                f"worker {dead.base_url} failed ({cause}) and no spare "
                f"serves layers {dead.layer_range}",
            )
        log.warning(
            "hop %d (%s) failed: rerouting to %s and replaying %d chunks",
            hop, dead.base_url, replacement.base_url, len(self.history),
        )
        replacement.create(self.session_id)
        self.route[hop] = replacement
        self.stats["reroutes"] += 1
        # rebuild the replacement's KV: drive every past chunk through hops
        # [0, hop]; healthy prefix stages rewrite identical pages
        for rec in self.history:
            x: Any = rec.tokens
            for j in range(hop + 1):
                x = self.route[j].forward(
                    self.session_id, x, rec.positions, rec.kv_len_after
                )["hidden"]
            self.stats["replayed_chunks"] += 1

    def step(self, token_ids: Any, positions: Optional[np.ndarray] = None) -> torch.Tensor:
        """Walk all hops for one chunk (a prefill piece or one decode
        token) → the last stage's logits [B, S, V] (f32, CPU)."""
        if not self._setup_done:
            self.setup()
        token_ids = np.asarray(token_ids, np.int32)
        if token_ids.ndim == 1:
            token_ids = token_ids[None, :]
        b, s = token_ids.shape
        if positions is None:
            positions = np.tile(
                np.arange(self.kv_len, self.kv_len + s, dtype=np.int32), (b, 1)
            )
        positions = np.asarray(positions, np.int32)
        kv_len_after = int(positions.max()) + 1
        if self.config.max_length and kv_len_after > self.config.max_length:
            raise ValueError(
                f"context {kv_len_after} exceeds session max_length "
                f"{self.config.max_length}"
            )

        x: Any = token_ids
        out: Dict[str, torch.Tensor] = {}
        for hop in range(len(self.route)):
            out = self._hop_forward(hop, x, positions, kv_len_after)
            x = out["hidden"]
        self.history.append(_ChunkRecord(token_ids, positions, kv_len_after))
        self.kv_len = max(self.kv_len, kv_len_after)
        self.stats["steps"] += 1
        if "logits" not in out:
            raise PipelineHopError(
                len(self.route) - 1, "last stage returned no logits"
            )
        return out["logits"]

    # -- convenience ---------------------------------------------------------

    def generate_greedy(self, prompt_ids: Sequence[int],
                        max_new_tokens: int = 16,
                        stop_ids: Sequence[int] = ()) -> List[int]:
        """Greedy driver: one prefill chunk, then one decode step a token
        (ties go to the lowest id, as ``np.argmax``)."""
        logits = self.step(np.asarray(list(prompt_ids), np.int32)[None, :])
        out: List[int] = []
        tok = int(torch.argmax(logits[0, -1]))
        for _ in range(max_new_tokens):
            out.append(tok)
            if tok in stop_ids:
                break
            logits = self.step(np.asarray([[tok]], np.int32))
            tok = int(torch.argmax(logits[0, -1]))
        return out


class SessionManager:
    """Pool of live sessions keyed by session_id with LRU capacity
    eviction. Uses are ordered by a counter, not the clock: two uses
    within one clock tick stay in order."""

    def __init__(self, max_sessions: int = 16) -> None:
        self.max_sessions = max_sessions
        self._sessions: Dict[str, DistributedInferenceSession] = {}
        self._last_used: Dict[str, int] = {}
        self._uses = itertools.count()

    def add(self, session: DistributedInferenceSession) -> None:
        while len(self._sessions) >= self.max_sessions:
            lru = min(self._last_used, key=self._last_used.get)
            self.remove(lru)
        self._sessions[session.session_id] = session
        self._last_used[session.session_id] = next(self._uses)

    def get(self, session_id: str) -> Optional[DistributedInferenceSession]:
        s = self._sessions.get(session_id)
        if s is not None:
            self._last_used[session_id] = next(self._uses)
        return s

    def remove(self, session_id: str) -> None:
        s = self._sessions.pop(session_id, None)
        self._last_used.pop(session_id, None)
        if s is not None:
            s.close()

    def close_all(self) -> None:
        for sid in list(self._sessions):
            self.remove(sid)

    def __len__(self) -> int:
        return len(self._sessions)
