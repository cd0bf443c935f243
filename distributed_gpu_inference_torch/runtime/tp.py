"""Tensor-parallel ranks of a :class:`runtime.engine.TorchEngine`.

The JAX engine takes a ``model``-axis mesh and XLA partitions every step.
The port runs one process per rank: rank 0 is the engine the batcher and
the worker see and owns all host state (slots, the block manager, the
sampling keys, stops and budgets); ranks 1..tp-1 are processes started
here with the ``spawn`` method, each holding its shard of the params and
KV pools (``parallel/sharding.py``) on its own device. Each time rank 0
runs device work it first sends every rank a small command over a pipe —
the op and the host arrays it was built from (tokens and positions,
block tables, lengths, budgets) — and the ranks run the same
``forward_chunk`` on their shards, meeting rank 0 in its collectives
(``parallel/mesh.py`` ``TPGroup``). In a decode loop rank 0 alone samples
and broadcasts each step's tokens (B int32); no other rank computes
logits.

Failures: a rank that raises sends its traceback up its pipe and exits,
which breaks the group's collectives on rank 0 (or its timeout does);
rank 0 then names the rank in ``EngineStateLost``. :meth:`TPRanks.close`
stops every rank, and a rank whose pipe closes (its parent died) exits.
"""

from __future__ import annotations

import multiprocessing
import os
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from distributed_gpu_inference_torch.models import llama
from distributed_gpu_inference_torch.ops import paged_attention
from distributed_gpu_inference_torch.parallel.mesh import TPGroup

#: the ops whose result a rank sends back
_QUERIES = ("counts", "pools", "stats", "memory")

#: the timeout of every collective and of a rank's answer, so that a rank
#: that dies makes rank 0 raise instead of hang; read when an engine starts
#: its ranks
TIMEOUT_S = 120.0


class RankFailed(RuntimeError):
    """A tensor-parallel rank raised or exited; ``rank`` names it."""

    def __init__(self, rank: int, detail: str) -> None:
        super().__init__(f"tensor-parallel rank {rank} failed: {detail}")
        self.rank = rank


@dataclass
class RankSpec:
    """What a rank process needs to build its half of the engine (sent
    pickled at spawn)."""

    model_cfg: Any
    engine_cfg: Any
    devices: List[str]
    store_path: str
    timeout_s: float
    seed: int
    checkpoint_path: Optional[str]
    num_threads: int


def decode_steps(model_cfg: Any, params: Any, kv: Dict[str, torch.Tensor], block_size: int,
                 last: torch.Tensor, lens: torch.Tensor, done: torch.Tensor,
                 budgets: torch.Tensor, stops: torch.Tensor, tables: torch.Tensor,
                 steps: int, sample: Optional[Callable[[torch.Tensor, torch.Tensor],
                                                       torch.Tensor]],
                 tp: Optional[TPGroup] = None) -> torch.Tensor:
    """``steps`` decode steps with the per-slot state on the device: each
    not-done row feeds its pending token at position ``lens`` (writing its
    KV) and advances; a row is done once it emits a stop id or its budget.
    → emitted ``[B, steps]`` on the device (-1 = masked-out step).

    ``sample(logits, cur)`` picks each step's tokens on the rank that
    samples; a rank without it (``sample`` None, tensor-parallel ranks
    1..tp-1) computes no logits and receives the tokens from rank 0."""
    n_emit = torch.zeros_like(lens)
    cols = []
    for _ in range(steps):
        cur = (lens + 1).masked_fill(done, 0)
        positions = lens[:, None].masked_fill(done[:, None], -1)
        out = llama.forward_chunk(model_cfg, params, last[:, None], positions, kv, tables,
                                  cur, block_size=block_size, last_only=True,
                                  with_logits=sample is not None, tp=tp)
        if sample is not None:
            toks = sample(out.logits[:, 0, :], cur).to(torch.int32)
        else:
            toks = torch.empty(lens.shape, dtype=torch.int32, device=lens.device)
        if tp is not None:
            tp.broadcast(toks, src=0)
        hit_stop = (toks[:, None] == stops).any(dim=1)
        cols.append(toks.masked_fill(done, -1))
        n_emit = n_emit + (~done).to(n_emit.dtype)
        lens = lens + (~done).to(lens.dtype)
        last = torch.where(done, last, toks)
        done = done | hit_stop | (n_emit >= budgets)
    return torch.stack(cols, dim=1)


class _RankHalf:
    """A rank's shard of the weights and pools, and the ops rank 0 sends."""

    def __init__(self, rank: int, spec: RankSpec, group: TPGroup,
                 params: Optional[Dict[str, Any]]) -> None:
        # the engine imports this module
        from distributed_gpu_inference_torch.runtime.engine import (
            _resolve_kv_dtype,
            engine_params,
        )

        self.rank, self.spec, self.group = rank, spec, group
        self.device = group.device
        cfg = spec.engine_cfg
        tp = group.size
        if params is not None:
            params = tree_to(params, self.device)
        else:
            params = engine_params(spec.model_cfg, cfg, spec.checkpoint_path, spec.seed,
                                   self.device, shard=(rank, tp))
        self.params = params
        kv_dtype = _resolve_kv_dtype(cfg.kv_cache_dtype, llama.torch_dtype(cfg.dtype))
        self.kv = llama.init_kv_pools(spec.model_cfg, cfg.resolved_num_blocks(),
                                      cfg.block_size, kv_dtype, self.device, tp=tp)

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(a, device=self.device)

    def run(self, op: str, kw: Dict[str, Any]) -> Any:
        cfg = self.spec.engine_cfg
        if op == "forward":
            llama.forward_chunk(
                self.spec.model_cfg, self.params, self._t(kw["toks_pos"][0]),
                self._t(kw["toks_pos"][1]), self.kv, self._t(kw["tables"]),
                self._t(kw["lens"]), block_size=cfg.block_size, with_logits=False,
                allow_fused=kw["allow_fused"], tp=self.group)
        elif op == "decode":
            decode_steps(
                self.spec.model_cfg, self.params, self.kv, cfg.block_size,
                self._t(kw["last"]), self._t(kw["lens"]), self._t(~kw["active"]),
                self._t(kw["budgets"]), self._t(kw["stops"]), self._t(kw["tables"]),
                kw["steps"], None, self.group)
        elif op == "copy":
            src, dst = self._t(kw["src"]).long(), self._t(kw["dst"]).long()
            for pool in self.kv.values():
                pool[:, dst] = pool[:, src]
        elif op == "counts":
            return paged_attention.launch_counts()
        elif op == "reset_counts":
            paged_attention.reset_launch_counts()
        elif op == "pools":
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return {k: tensor_bits(self.kv[k]) for k in kw["names"]}
        elif op == "stats":
            return dict(self.group.stats)
        elif op == "memory":
            if self.device.type != "cuda":
                return {}
            return {"allocated": torch.cuda.memory_allocated(self.device),
                    "peak": torch.cuda.max_memory_allocated(self.device)}
        elif op == "reset_stats":
            self.group.reset_stats()
        elif op == "raise":
            raise RuntimeError(kw.get("message", "a fault raised on request"))
        else:
            raise ValueError(f"unknown rank op {op!r}")
        return None


def tree_to(tree: Any, device: Any) -> Any:
    """A params tree (nested dicts of tensors) moved to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def tensor_bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's raw bits on the host (bf16 as int16 words, 1-byte types as
    uint8), for a bitwise comparison."""
    t = t.detach().cpu().contiguous()
    if t.element_size() == 2:
        return t.view(torch.int16).numpy()
    if t.element_size() == 1:
        return t.view(torch.uint8).numpy()
    return t.numpy()


def _rank_main(rank: int, spec: RankSpec, conn: Any, params: Optional[Dict[str, Any]]) -> None:
    """A rank process: join the group, build the shard, then run rank 0's
    commands until ``stop`` or until the pipe closes."""
    torch.set_num_threads(spec.num_threads)
    group = None
    try:
        group = TPGroup(rank, spec.devices, spec.store_path, spec.timeout_s)
        half = _RankHalf(rank, spec, group, params)
        del params
        conn.send(("ready", rank, None))
        while True:
            op, kw = conn.recv()
            if op == "stop":
                break
            result = half.run(op, kw)
            if op in _QUERIES:
                conn.send(("ok", rank, result))
    except EOFError:
        pass        # rank 0 is gone
    except BaseException:   # noqa: BLE001 — reported to rank 0, then the rank ends
        try:
            conn.send(("error", rank, traceback.format_exc()))
        except OSError:
            pass
    finally:
        if group is not None:
            group.close()
        conn.close()


class TPRanks:
    """Rank 0's handle on ranks 1..tp-1: starts them, joins the group as
    rank 0, sends commands, gathers query results and names a rank that
    failed. ``shards[r]`` (r >= 1), when given, is rank r's params tree on
    the host; otherwise each rank builds its own (``engine_params``)."""

    def __init__(self, spec: RankSpec, shards: Optional[Sequence[Any]] = None) -> None:
        self.spec = spec
        self.size = len(spec.devices)
        ctx = multiprocessing.get_context("spawn")
        self._procs: List[Any] = []
        self._conns: List[Any] = []
        self.group: Optional[TPGroup] = None
        self._closed = False
        try:
            for r in range(1, self.size):
                parent, child = ctx.Pipe()
                p = ctx.Process(target=_rank_main, name=f"tp-rank-{r}", daemon=True,
                                args=(r, spec, child, shards[r] if shards else None))
                p.start()
                child.close()
                self._procs.append(p)
                self._conns.append(parent)
            self.group = TPGroup(0, spec.devices, spec.store_path, spec.timeout_s)
        except BaseException:
            self.close()
            raise

    def wait_ready(self) -> None:
        """Block until every rank has built its shard (or raise naming the
        first that failed)."""
        for r, conn in enumerate(self._conns, start=1):
            kind, rank, detail = self._recv(r, conn, self.spec.timeout_s)
            if kind != "ready":
                raise RankFailed(rank, _last_line(detail))

    def _recv(self, r: int, conn: Any, timeout_s: float) -> tuple:
        deadline = time.monotonic() + timeout_s
        while not conn.poll(0.05):
            if not self._procs[r - 1].is_alive() and not conn.poll(0.05):
                raise RankFailed(r, f"exited with code {self._procs[r - 1].exitcode}")
            if time.monotonic() > deadline:
                raise RankFailed(r, f"no answer in {timeout_s:.0f} s")
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            code = self._procs[r - 1].exitcode
            raise RankFailed(r, f"its pipe closed (exit code {code})") from None
        if msg[0] == "error":
            raise RankFailed(msg[1], _last_line(msg[2]))
        return msg

    def check(self) -> None:
        """Raise :class:`RankFailed` for a rank that reported an error or
        exited."""
        for r, conn in enumerate(self._conns, start=1):
            if conn.poll():
                self._recv(r, conn, 0.0)
            if not self._procs[r - 1].is_alive():
                raise RankFailed(r, f"exited with code {self._procs[r - 1].exitcode}")

    def failure(self, wait_s: float = 2.0) -> Optional[RankFailed]:
        """The failure of a rank, waiting up to ``wait_s`` for its report
        (a collective on rank 0 can break before the rank's message lands);
        None when every rank is alive and silent."""
        deadline = time.monotonic() + wait_s
        while True:
            try:
                self.check()
            except RankFailed as exc:
                return exc
            if time.monotonic() >= deadline:
                return None
            time.sleep(0.05)

    def send(self, op: str, **kw: Any) -> None:
        """Send every rank the command ``op`` with its arguments."""
        self.check()
        for r, conn in enumerate(self._conns, start=1):
            try:
                conn.send((op, kw))
            except OSError as exc:
                raise RankFailed(r, f"cannot take commands ({exc})") from exc

    def query(self, op: str, **kw: Any) -> List[Any]:
        """Send ``op`` and gather each rank's answer (ranks 1..tp-1)."""
        self.send(op, **kw)
        return [self._recv(r, conn, self.spec.timeout_s)[2]
                for r, conn in enumerate(self._conns, start=1)]

    def close(self, timeout_s: float = 10.0) -> None:
        """Stop every rank (idempotent): a ``stop`` command, a join, then
        ``terminate`` for a rank stuck in a collective; the group and the
        rendezvous directory go last."""
        if self._closed:
            return
        self._closed = True
        for conn in self._conns:
            try:
                conn.send(("stop", {}))
            except OSError:
                pass
        deadline = time.monotonic() + timeout_s
        for p in self._procs:
            p.join(max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.terminate()
                p.join(5.0)
        for conn in self._conns:
            conn.close()
        if self.group is not None:
            self.group.close()
        shutil.rmtree(os.path.dirname(self.spec.store_path), ignore_errors=True)


def _last_line(detail: Optional[str]) -> str:
    lines = [ln for ln in (detail or "").strip().splitlines() if ln.strip()]
    return lines[-1].strip() if lines else "no detail"


def rendezvous_path() -> str:
    """A fresh ``FileStore`` path in a temporary directory of its own."""
    return os.path.join(tempfile.mkdtemp(prefix="tp-store-"), "store")
