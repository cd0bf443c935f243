"""Tensor- and sequence-parallel ranks of a :class:`runtime.engine.TorchEngine`.

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

The ``seq`` axis (``MeshPlan(seq=n)``) uses the same ranks and pipes
with the params replicated. With replicated pools (JAX's default under a
seq mesh) rank 0 holds every page and runs every op alone, and the other
ranks join only the seq-parallel prefill of a long prompt
(:func:`seq_prefill`): each rank runs its S/n rows through every layer,
attention goes ring or Ulysses over the group, and the K/V rows of every
rank are gathered and written into rank 0's pages. With block-sharded
pools (``EngineConfig.kv_seq_sharded``) rank r holds the global blocks
``[r·N/n, (r+1)·N/n)`` and every rank runs every op: page writes land on
the rank that holds the block, and reads are the partial-softmax ops of
``parallel/ring_attention.py`` (:class:`SeqRank` builds the hooks). Page
transfers (:func:`gather_blocks`, :func:`write_blocks`) move each rank's
heads or blocks of a page through the group, so KV handoff, PD and the
spill tiers see the single-device page layout on either axis.

Both axes (``MeshPlan(seq=s, model=m)``, JAX's seq x model mesh): s*m
ranks, rank ``i*m + j`` at seq row i and model column j
(:class:`RankLayout`), each holding the weights cut j of m and its
model-local KV heads. The row-parallel sums and the int8 amax reduce run
over the rank's ``model`` sub-group, the ring hops, all-to-alls and
partial-softmax merges over its ``seq`` sub-group. Replicated pools: seq
row 0 holds every block (its heads) and serves as a tensor-parallel
engine of m ranks; the other rows join only the seq-parallel prefill.
Block-sharded pools: every rank runs every op on its blocks and heads.

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
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from distributed_gpu_inference_torch.models import llama
from distributed_gpu_inference_torch.ops import paged_attention
from distributed_gpu_inference_torch.ops.attention import dense_causal_attention
from distributed_gpu_inference_torch.parallel import ring_attention
from distributed_gpu_inference_torch.parallel.mesh import AXIS_MODEL, AXIS_SEQ, TPGroup
from distributed_gpu_inference_torch.parallel.sharding import block_range, mesh_coords

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
    #: the engine's (seq, model) plan
    shape: Tuple[int, int] = (1, 1)


@dataclass(frozen=True)
class RankLayout:
    """Where rank ``rank`` of a (seq, model) engine sits and what it holds:
    its seq row and model column, its pool blocks, and whether it runs
    every op (the ranks that hold pages) or only the seq-parallel
    prefill."""

    rank: int
    seq: int
    model: int
    seq_sharded: bool

    @property
    def coords(self) -> Tuple[int, int]:
        return mesh_coords(self.rank, self.model)

    def pool_blocks(self, num_blocks: int) -> Optional[Tuple[int, int]]:
        """[lo, hi) of the global blocks this rank's pools hold; None: every
        block. Replicated pools on a seq axis: row 0 holds every block, the
        other rows none."""
        i, _ = self.coords
        if self.seq == 1:
            return None
        if self.seq_sharded:
            return block_range(num_blocks, i, self.seq)
        return None if i == 0 else (0, 0)

    @property
    def serving_shape(self) -> Tuple[int, int]:
        """(seq, model) of the ranks that run every op: the whole mesh for
        block-sharded pools, seq row 0 otherwise."""
        return (self.seq if self.seq_sharded else 1), self.model

    def mirrors(self) -> List[int]:
        """The ranks other than 0 that run every op."""
        s, m = self.serving_shape
        return list(range(1, s * m))

    def ops_group(self, group: Optional[TPGroup]) -> Optional[TPGroup]:
        """The group spanning the ranks that run every op (token broadcasts
        and page transfers meet there): the whole group, or seq row 0's
        ``model`` sub-group; None when rank 0 serves alone."""
        s, m = self.serving_shape
        if group is None or s * m == 1:
            return None
        return group if s * m == group.size else group.axis_group(AXIS_MODEL)


def attention_kind(positions: np.ndarray, lens: np.ndarray) -> str:
    """The read a forward over block-sharded pools takes, from its host
    arrays ``positions`` [B, S] (-1 = pad) and ``lens`` [B]: "dense" when
    every row's chunk is its whole context (its first live position 0 and
    its length its live count; rows with none aside), "chunk" otherwise."""
    live = positions >= 0
    count = live.sum(axis=1)
    first = np.where(live, positions, np.iinfo(np.int32).max).min(axis=1)
    rows = count > 0
    whole = (first[rows] == 0) & (np.asarray(lens)[rows] == count[rows])
    return "dense" if bool(whole.all()) else "chunk"


@dataclass
class SeqRank:
    """A rank of the ``seq`` axis: its group and the global blocks
    ``[lo, hi)`` its pools hold (None: every block, rank 0 of replicated
    pools). ``hooks`` are the ``forward_chunk`` keyword arguments of one
    forward: ``kind`` "dense" attends over the chunk itself (a fresh
    prompt), "chunk" and "decode" read the block-sharded pools through the
    partial-softmax ops, bound to the call's ``tables``, ``positions`` and
    ``kv_lens``."""

    group: TPGroup
    pool_blocks: Optional[Tuple[int, int]]
    block_size: int
    impl: str = "ring"
    #: the rank's ``model`` peers on a seq x model mesh (None on one axis)
    model_group: Optional[TPGroup] = None

    def hooks(self, kind: str, tables: torch.Tensor, positions: torch.Tensor,
              kv_lens: torch.Tensor) -> Dict[str, Any]:
        kw: Dict[str, Any] = {"pool_blocks": self.pool_blocks}
        group, bs = self.group, self.block_size
        reads = {"chunk": ring_attention.seq_parallel_paged_chunk_attention,
                 "decode": ring_attention.seq_parallel_paged_decode_attention}
        if kind == "dense":
            kw["dense_attn_fn"] = lambda q, k, v: dense_causal_attention(q, k, v, kv_lens)
        elif kind in reads:
            op = reads[kind]
            kw["attn_fn"] = lambda q, lk, lv, ks, vs: op(
                q, lk, lv, tables, positions, kv_lens, group, bs, k_scale=ks, v_scale=vs)
        else:
            raise ValueError(f"unknown attention kind {kind!r}")
        return kw

    def gather_seq(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``x`` [B, S/n, ...] in rank order → [B, S, ...]."""
        return torch.cat(self.group.all_gather(x).unbind(0), dim=1)


def seq_prefill(model_cfg: Any, params: Any, kv: Dict[str, torch.Tensor], seq: SeqRank,
                toks_pos: np.ndarray, table: np.ndarray, n_tokens: int,
                with_logits: bool) -> Optional[torch.Tensor]:
    """One rank's part of the seq-parallel prefill of one fresh prompt
    (JAX ``TPUEngine._prefill_seq_parallel``): ``toks_pos`` [2, 1, P] the
    whole prompt's tokens and positions padded to P (a multiple of the
    rank count, position -1 past ``n_tokens``); rank r runs rows [r·P/n,
    (r+1)·P/n) through every layer, attention ring or Ulysses over the
    group, and the K/V rows of every rank are gathered before the page
    writes, so each rank writes every page it holds. On a seq x model mesh
    the rank runs its model-local heads and sums over ``seq.model_group``.
    → the last prompt token's logits [1, V] (``with_logits``), its hidden
    row broadcast from the seq rank that computed it; None otherwise."""
    device = seq.group.device
    n = seq.group.size
    per = toks_pos.shape[-1] // n
    rows = slice(seq.group.rank * per, (seq.group.rank + 1) * per)
    lens = torch.tensor([n_tokens], dtype=torch.int32, device=device)
    if seq.impl == "ring":
        def attend(q, k, v):
            return ring_attention.ring_self_attention(q, k, v, lens, seq.group)
    else:
        def attend(q, k, v):
            return ring_attention.ulysses_self_attention(q, k, v, lens, seq.group,
                                                         seq.model_group)
    out = llama.forward_chunk(
        model_cfg, params, torch.tensor(toks_pos[0][:, rows], device=device),
        torch.tensor(toks_pos[1][:, rows], device=device), kv,
        torch.tensor(table, device=device), lens, block_size=seq.block_size,
        with_logits=False, pool_blocks=seq.pool_blocks, gather_rows=seq.gather_seq,
        write_positions=torch.tensor(toks_pos[1], device=device),
        dense_attn_fn=attend, tp=seq.model_group)
    owner, row = divmod(n_tokens - 1, per)
    last = (out.hidden[:, row:row + 1].contiguous() if seq.group.rank == owner
            else torch.empty((1, 1, out.hidden.shape[-1]), dtype=out.hidden.dtype,
                             device=device))
    seq.group.broadcast(last, src=owner)
    if not with_logits:
        return None
    return llama.project_logits(model_cfg, params, last)[:, 0, :]


def local_pages(kv: Dict[str, torch.Tensor], bids: torch.Tensor,
                pool_blocks: Optional[Tuple[int, int]]
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Pages ``bids`` (global ids, long) of this rank's pools in the port's
    page layout: ([n, L, 2, Hkv_rank, Bk, D], int8 scales [n, L, 2, Bk] or
    None). A page whose block this rank does not hold is zeros."""
    idx, held = bids, None
    if pool_blocks is not None:
        lo, hi = pool_blocks
        held = (bids >= lo) & (bids < hi)
        idx = torch.where(held, bids - lo, torch.zeros_like(bids))

    def take(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        out = torch.stack((a.index_select(1, idx), b.index_select(1, idx)), dim=2)
        out = out.movedim(1, 0).contiguous()
        if held is not None:
            out[~held] = 0
        return out

    scales = take(kv["k_scale"], kv["v_scale"]) if "k_scale" in kv else None
    return take(kv["k"], kv["v"]), scales


def gather_blocks(kv: Dict[str, torch.Tensor], bids: torch.Tensor, group: TPGroup,
                  shape: Tuple[int, int], pool_blocks: Optional[Tuple[int, int]]
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Whole pages ``bids`` on every rank of ``group``, in the single-device
    page layout ([n, L, 2, Hkv, Bk, D] and int8 scales [n, L, 2, Bk]).
    ``group`` spans the ranks that hold pages, ``shape`` their (seq,
    model) plan: each rank's KV heads are laid side by side over
    ``model`` (scales are whole there), and over a block-sharded ``seq``
    each page is taken from the row that holds its block. Every rank of
    the group calls it with the same ``bids``."""
    s, m = shape
    pages, scales = local_pages(kv, bids, pool_blocks)
    n, L, two, h, bk, d = pages.shape
    g = group.all_gather(pages).reshape(s, m, n, L, two, h, bk, d)
    rows = torch.arange(n, device=bids.device)
    if s > 1:
        owner = torch.div(bids, pool_blocks[1] - pool_blocks[0], rounding_mode="floor")
        g = g[owner, :, rows]                           # [n, m, L, 2, h, Bk, D]
        if scales is not None:
            scales = group.all_gather(scales).reshape(s, m, *scales.shape)[owner, 0, rows]
    else:
        g = g[0].movedim(0, 1)
    return g.permute(0, 2, 3, 1, 4, 5, 6).reshape(n, L, two, m * h, bk, d), scales


def write_blocks(kv: Dict[str, torch.Tensor], bids: torch.Tensor, pages: torch.Tensor,
                 scales: Optional[torch.Tensor], model_rank: int,
                 pool_blocks: Optional[Tuple[int, int]]) -> None:
    """Write whole pages (the single-device layout) into blocks ``bids`` of
    this rank's pools: its KV heads of each page (the heads at
    ``model_rank`` of the pools' width; scales whole), and only the pages
    whose blocks it holds (``pool_blocks``)."""
    h = kv["k"].shape[2]
    if h != pages.shape[3]:
        pages = pages[:, :, :, model_rank * h:(model_rank + 1) * h]
    idx = bids
    if pool_blocks is not None:
        lo, hi = pool_blocks
        held = (bids >= lo) & (bids < hi)
        idx = bids[held] - lo
        pages = pages[held]
        scales = None if scales is None else scales[held]
    kv["k"].index_copy_(1, idx, pages[:, :, 0].movedim(0, 1))
    kv["v"].index_copy_(1, idx, pages[:, :, 1].movedim(0, 1))
    if scales is not None:
        kv["k_scale"].index_copy_(1, idx, scales[:, :, 0].movedim(0, 1))
        kv["v_scale"].index_copy_(1, idx, scales[:, :, 1].movedim(0, 1))


def page_bytes(model_cfg: Any, kv: Dict[str, torch.Tensor], block_size: int
               ) -> Tuple[Tuple[int, ...], int, Optional[Tuple[int, ...]], int]:
    """The single-device page layout whatever this rank holds: (page shape
    [L, 2, Hkv, Bk, D], its bytes, scale shape [L, 2, Bk] or None, its
    bytes)."""
    k = kv["k"]
    shape = (k.shape[0], 2, model_cfg.num_kv_heads, block_size, k.shape[-1])
    pbytes = int(np.prod(shape)) * k.element_size()
    if "k_scale" not in kv:
        return shape, pbytes, None, 0
    sshape = (k.shape[0], 2, block_size)
    return shape, pbytes, sshape, int(np.prod(sshape)) * kv["k_scale"].element_size()


def unpack_pages(buf: torch.Tensor, kv: Dict[str, torch.Tensor], layout: tuple
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A staging buffer [n, page bytes + scale bytes] (uint8) → (pages,
    scales) in the single-device layout."""
    shape, pbytes, sshape, _ = layout
    n = buf.shape[0]
    pages = buf[:, :pbytes].contiguous().view(kv["k"].dtype).reshape(n, *shape)
    scales = (None if sshape is None else
              buf[:, pbytes:].contiguous().view(torch.bfloat16).reshape(n, *sshape))
    return pages, scales


def decode_steps(model_cfg: Any, params: Any, kv: Dict[str, torch.Tensor], block_size: int,
                 last: torch.Tensor, lens: torch.Tensor, done: torch.Tensor,
                 budgets: torch.Tensor, stops: torch.Tensor, tables: torch.Tensor,
                 steps: int, sample: Optional[Callable[[torch.Tensor, torch.Tensor],
                                                       torch.Tensor]],
                 tp: Optional[TPGroup] = None, seq: Optional[SeqRank] = None,
                 group: Optional[TPGroup] = None) -> torch.Tensor:
    """``steps`` decode steps with the per-slot state on the device: each
    not-done row feeds its pending token at position ``lens`` (writing its
    KV) and advances; a row is done once it emits a stop id or its budget.
    → emitted ``[B, steps]`` on the device (-1 = masked-out step).

    ``sample(logits, cur)`` picks each step's tokens on the rank that
    samples; a rank without it (``sample`` None, ranks 1..n-1) computes no
    logits and receives the tokens from rank 0 over ``group`` (the ranks
    that run the steps). ``tp``: the rank's ``model`` group; ``seq``: a
    rank of block-sharded pools, reading through the partial-softmax
    decode op."""
    n_emit = torch.zeros_like(lens)
    cols = []
    for _ in range(steps):
        cur = (lens + 1).masked_fill(done, 0)
        positions = lens[:, None].masked_fill(done[:, None], -1)
        hooks = {} if seq is None else seq.hooks("decode", tables, positions, cur)
        out = llama.forward_chunk(model_cfg, params, last[:, None], positions, kv, tables,
                                  cur, block_size=block_size, last_only=True,
                                  with_logits=sample is not None, tp=tp, **hooks)
        if sample is not None:
            toks = sample(out.logits[:, 0, :], cur).to(torch.int32)
        else:
            toks = torch.empty(lens.shape, dtype=torch.int32, device=lens.device)
        if group is not None:
            group.broadcast(toks, src=0)
        hit_stop = (toks[:, None] == stops).any(dim=1)
        cols.append(toks.masked_fill(done, -1))
        n_emit = n_emit + (~done).to(n_emit.dtype)
        lens = lens + (~done).to(lens.dtype)
        last = torch.where(done, last, toks)
        done = done | hit_stop | (n_emit >= budgets)
    return torch.stack(cols, dim=1)


@dataclass
class RankRoles:
    """The groups and pools one rank of a (seq, model) engine works with
    (rank 0 and the spawned ranks alike): ``tp`` its ``model`` sub-group
    (None at model 1), ``seq`` its seq rank (None at seq 1; its hooks only
    for block-sharded pools), ``ops`` the group of the ranks that run
    every op (:meth:`RankLayout.ops_group`), and ``pool_blocks`` the
    global blocks its pools hold."""

    layout: RankLayout
    tp: Optional[TPGroup]
    seq: Optional[SeqRank]
    ops: Optional[TPGroup]
    pool_blocks: Optional[Tuple[int, int]]

    @classmethod
    def build(cls, layout: RankLayout, group: Optional[TPGroup], cfg: Any,
              num_blocks: int) -> "RankRoles":
        pool_blocks = layout.pool_blocks(num_blocks)
        tp = None if group is None or layout.model == 1 else group.axis_group(AXIS_MODEL)
        seq = None
        if layout.seq > 1:
            seq = SeqRank(group.axis_group(AXIS_SEQ), pool_blocks, cfg.block_size,
                          cfg.seq_parallel_impl, model_group=tp)
        return cls(layout, tp, seq, layout.ops_group(group), pool_blocks)

    @property
    def held_blocks(self) -> Optional[int]:
        """The block count of this rank's pools (None: the whole pool)."""
        return None if self.pool_blocks is None else self.pool_blocks[1] - self.pool_blocks[0]

    @property
    def read_hooks(self) -> Optional[SeqRank]:
        """The seq rank whose partial-softmax reads serve this rank's ops
        (block-sharded pools only)."""
        return self.seq if self.layout.seq_sharded else None


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
        seq, model = spec.shape
        self.layout = RankLayout(rank, seq, model, cfg.kv_seq_sharded)
        j = self.layout.coords[1]
        if params is not None:
            params = tree_to(params, self.device)
        else:
            params = engine_params(spec.model_cfg, cfg, spec.checkpoint_path, spec.seed,
                                   self.device, shard=(j, model) if model > 1 else None)
        self.params = params
        kv_dtype = _resolve_kv_dtype(cfg.kv_cache_dtype, llama.torch_dtype(cfg.dtype))
        num_blocks = cfg.resolved_num_blocks()
        self.roles = RankRoles.build(self.layout, group, cfg, num_blocks)
        held = self.roles.held_blocks
        self.kv = llama.init_kv_pools(spec.model_cfg, num_blocks if held is None else held,
                                      cfg.block_size, kv_dtype, self.device, tp=model)

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(a, device=self.device)

    def run(self, op: str, kw: Dict[str, Any]) -> Any:
        cfg = self.spec.engine_cfg
        roles, j = self.roles, self.layout.coords[1]
        if op == "forward":
            positions, tables, lens = (self._t(kw["toks_pos"][1]), self._t(kw["tables"]),
                                       self._t(kw["lens"]))
            hooks = ({} if roles.read_hooks is None else roles.read_hooks.hooks(
                attention_kind(kw["toks_pos"][1], kw["lens"]), tables, positions, lens))
            llama.forward_chunk(
                self.spec.model_cfg, self.params, self._t(kw["toks_pos"][0]), positions,
                self.kv, tables, lens, block_size=cfg.block_size, with_logits=False,
                allow_fused=kw["allow_fused"], tp=roles.tp, **hooks)
        elif op == "decode":
            decode_steps(
                self.spec.model_cfg, self.params, self.kv, cfg.block_size,
                self._t(kw["last"]), self._t(kw["lens"]), self._t(~kw["active"]),
                self._t(kw["budgets"]), self._t(kw["stops"]), self._t(kw["tables"]),
                kw["steps"], None, roles.tp, roles.read_hooks, roles.ops)
        elif op == "seq_prefill":
            seq_prefill(self.spec.model_cfg, self.params, self.kv, roles.seq, kw["toks_pos"],
                        kw["table"], kw["n"], with_logits=False)
        elif op == "copy":
            copy_blocks(self.kv, self._t(kw["src"]).long(), self._t(kw["dst"]).long(),
                        roles.ops, self.layout.serving_shape, j, roles.pool_blocks)
        elif op == "gather":
            gather_blocks(self.kv, self._t(kw["bids"]).long(), roles.ops,
                          self.layout.serving_shape, roles.pool_blocks)
        elif op == "push":
            layout = page_bytes(self.spec.model_cfg, self.kv, cfg.block_size)
            buf = torch.empty((len(kw["bids"]), layout[1] + layout[3]), dtype=torch.uint8,
                              device=self.device)
            roles.ops.broadcast(buf, src=0)
            pages, scales = unpack_pages(buf, self.kv, layout)
            write_blocks(self.kv, self._t(kw["bids"]).long(), pages, scales, j,
                         roles.pool_blocks)
        elif op == "counts":
            return paged_attention.launch_counts()
        elif op == "reset_counts":
            paged_attention.reset_launch_counts()
        elif op == "pools":
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return {k: tensor_bits(self.kv[k]) for k in kw["names"]}
        elif op == "stats":
            group = self.group if kw.get("axis") is None else self.group.axis_group(kw["axis"])
            return None if group is None else dict(group.stats)
        elif op == "memory":
            return device_memory(self.device, self.kv)
        elif op == "reset_stats":
            self.group.reset_stats()
        elif op == "raise":
            raise RuntimeError(kw.get("message", "a fault raised on request"))
        else:
            raise ValueError(f"unknown rank op {op!r}")
        return None


def copy_blocks(kv: Dict[str, torch.Tensor], src: torch.Tensor, dst: torch.Tensor,
                group: Optional[TPGroup], shape: Tuple[int, int], model_rank: int,
                pool_blocks: Optional[Tuple[int, int]]) -> None:
    """The copy-on-write page copies ``src`` → ``dst`` (global ids) on one
    rank: in place where the rank holds both (one device, the ``model``
    axis: every rank its own heads); across ranks for block-sharded pools,
    whose source and destination blocks may sit on different ranks
    (``group`` and ``shape`` as for :func:`gather_blocks`)."""
    if shape[0] > 1:
        pages, scales = gather_blocks(kv, src, group, shape, pool_blocks)
        write_blocks(kv, dst, pages, scales, model_rank, pool_blocks)
        return
    for pool in kv.values():
        pool[:, dst] = pool[:, src]


def device_memory(device: torch.device, kv: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """A rank's pool bytes, and on a card its allocated and peak bytes."""
    out = {"pool_bytes": sum(t.numel() * t.element_size() for t in kv.values())}
    if device.type == "cuda":
        out.update(allocated=torch.cuda.memory_allocated(device),
                   peak=torch.cuda.max_memory_allocated(device))
    return out


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
        group = TPGroup(rank, spec.devices, spec.store_path, spec.timeout_s, spec.shape)
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
            self.group = TPGroup(0, spec.devices, spec.store_path, spec.timeout_s,
                                 spec.shape)
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

    def send(self, op: str, to: Optional[Sequence[int]] = None, **kw: Any) -> None:
        """Send the command ``op`` with its arguments to the ranks ``to``
        (default: every rank)."""
        self.check()
        for r, conn in enumerate(self._conns, start=1):
            if to is not None and r not in to:
                continue
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


def _group_main(rank: int, devices: List[str], store_path: str, timeout_s: float,
                fn: Callable[..., Any], args: tuple, conn: Any) -> None:
    group = None
    try:
        group = TPGroup(rank, devices, store_path, timeout_s)
        conn.send(("ok", fn(group, *args)))
    except BaseException:   # noqa: BLE001 — reported to the caller
        conn.send(("error", traceback.format_exc()))
    finally:
        if group is not None:
            group.close()
        conn.close()


def run_group(fn: Callable[..., Any], devices: Sequence[Any], *args: Any,
              timeout_s: Optional[float] = None) -> List[Any]:
    """Run ``fn(group, *args)`` on one spawned process per device, the
    processes joined in one :class:`TPGroup` → each rank's result, rank 0's
    first. ``fn`` must be a module-level function and return host data
    (numpy arrays, CPU tensors, numbers); a rank that raises fails the call
    with its traceback's last line, and every process is stopped."""
    timeout_s = TIMEOUT_S if timeout_s is None else timeout_s
    ctx = multiprocessing.get_context("spawn")
    store = rendezvous_path()
    procs, conns = [], []
    try:
        for r in range(len(devices)):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_group_main, daemon=True, name=f"group-rank-{r}",
                            args=(r, [str(d) for d in devices], store, timeout_s, fn,
                                  args, child))
            p.start()
            child.close()
            procs.append(p)
            conns.append(parent)
        out = []
        for r, conn in enumerate(conns):
            if not conn.poll(timeout_s + 60.0):
                raise RankFailed(r, f"no answer in {timeout_s + 60.0:.0f} s")
            kind, result = conn.recv()
            if kind == "error":
                raise RankFailed(r, _last_line(result))
            out.append(result)
        return out
    finally:
        for p in procs:
            p.join(5.0)
            if p.is_alive():
                p.terminate()
                p.join(5.0)
        for conn in conns:
            conn.close()
        shutil.rmtree(os.path.dirname(store), ignore_errors=True)


def rendezvous_path() -> str:
    """A fresh ``FileStore`` path in a temporary directory of its own."""
    return os.path.join(tempfile.mkdtemp(prefix="tp-store-"), "store")
