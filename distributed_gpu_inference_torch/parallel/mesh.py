"""Axis conventions, mesh plans, and the tensor-parallel process group.

The port of ``distributed_gpu_inference_tpu/parallel/mesh.py``: the same
axis names and :class:`MeshPlan` / :func:`infer_plan`, without JAX. The
JAX package builds a ``jax.sharding.Mesh`` and lets XLA insert the
collectives; the port runs one process per rank of the ``model`` axis,
each holding its shard of the weights and KV pools on its own device, and
calls the collectives itself through a :class:`TPGroup`. The same group
serves the ``seq`` axis (one process per rank of a sequence-parallel
engine, params replicated): its ring hop, all-to-all and all-gather are
what ring and Ulysses attention and the cross-rank page transfers call.
An engine on both axes (``MeshPlan(seq=s, model=m)``, JAX's seq x model
mesh) runs s*m ranks, rank ``i*m + j`` at row i of ``seq`` and column j
of ``model``: its group spans every rank and holds two sub-groups
(:meth:`TPGroup.axis_group`), the ``model`` peers of its seq row (the
row-parallel sums, the int8 amax reduce) and the ``seq`` peers of its
model column (the ring hops, the partial-softmax merges), each a process
group of its own over the same rendezvous that counts its own
collectives.

Axis names (fixed across the framework so sharding rules compose):

- ``data``  — request-level data parallelism (replica groups)
- ``model`` — tensor parallelism over attention heads / MLP width, and
  expert parallelism over a MoE layer's experts
- ``seq``   — sequence/context parallelism (ring attention)
- ``stage`` — pipeline stages

Backends (:func:`choose_backend`), chosen from the rank devices by name:
NCCL when every rank has a card of its own; gloo when the ranks run on the
CPU, or share one card. On an H100 80GB HBM3 (700 W, torch 2.11 + CUDA
12.8, NCCL 2.28.9) NCCL refuses two ranks on one device ("Duplicate GPU
detected : rank 0 and rank 1 both on CUDA device"), and gloo takes CUDA
tensors (bf16 ``allreduce``, f32 ``broadcast``) by staging them through
the host itself (``chip_smoke.py`` phase 23 probes both). The collectives
of the ``seq`` axis (``ring_hop``, ``all_to_all``, ``all_gather``) stage
CUDA tensors through pinned host buffers under gloo themselves: gloo's
point-to-point and all-to-all take CPU tensors only. The NCCL branch
needs a card a rank and is not exercised on a one-card machine.
Rendezvous goes through a ``FileStore`` in a temporary directory, not a
TCP port, and every group has a timeout, so a rank that dies makes the
others raise instead of hang.
"""

from __future__ import annotations

import datetime
import math
import time
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXIS_DATA = "data"
AXIS_MODEL = "model"
AXIS_SEQ = "seq"
AXIS_STAGE = "stage"

ALL_AXES = (AXIS_DATA, AXIS_STAGE, AXIS_SEQ, AXIS_MODEL)

#: the collectives a :class:`TPGroup` counts in ``stats`` (and their
#: seconds under ``<name>_s``)
COLLECTIVES = ("all_reduce", "broadcast", "ring_hop", "shift", "all_to_all",
               "all_gather")


@dataclass(frozen=True)
class MeshPlan:
    """A named factorization of the device count into parallelism axes."""

    data: int = 1
    stage: int = 1
    seq: int = 1
    model: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.stage * self.seq * self.model

    def axis_sizes(self) -> Dict[str, int]:
        return {
            AXIS_DATA: self.data,
            AXIS_STAGE: self.stage,
            AXIS_SEQ: self.seq,
            AXIS_MODEL: self.model,
        }

    def nontrivial_axes(self) -> Tuple[str, ...]:
        return tuple(a for a, s in self.axis_sizes().items() if s > 1)

    def engine_axis(self) -> Tuple[int, int]:
        """The engine's 2-D plan ``(seq, model)``: its ranks run over the
        ``seq`` and ``model`` axes, either or both above 1 (``(1, 1)`` for
        one device). A data or stage axis is refused, as the JAX engine
        refuses a data axis (data parallelism is request-level at the
        scheduler; pipeline stages are processes of their own or
        ``parallel/pipeline.py``'s stage ranks)."""
        if self.data > 1 or self.stage > 1:
            raise ValueError(f"an engine mesh takes no data or stage axis, got {self}")
        return self.seq, self.model


def infer_plan(num_devices: int, num_kv_heads: int, prefer: str = "model") -> MeshPlan:
    """Pick a default factorization: TP up to the KV-head count, remainder DP."""
    model = math.gcd(num_devices, num_kv_heads) if prefer == "model" else 1
    return MeshPlan(data=num_devices // model, model=model)


def choose_backend(devices: Sequence[torch.device]) -> str:
    """``"nccl"`` when every rank has a CUDA device of its own, ``"gloo"``
    when the ranks run on the CPU or share a card. Ranks on a mix of the
    CPU and cards are refused."""
    kinds = {d.type for d in devices}
    if kinds == {"cpu"}:
        return "gloo"
    if kinds != {"cuda"}:
        raise ValueError(f"tensor-parallel ranks must all be on the CPU or all on "
                         f"CUDA devices, got {[str(d) for d in devices]}")
    indices = [d.index if d.index is not None else 0 for d in devices]
    return "nccl" if len(set(indices)) == len(indices) else "gloo"


def _nccl_group(store: "dist.Store", rank: int, size: int,
                timeout: datetime.timedelta) -> "dist.ProcessGroup":
    opts = dist.ProcessGroupNCCL.Options()
    opts._timeout = timeout
    return dist.ProcessGroupNCCL(store, rank, size, opts)


class TPGroup:
    """One rank's view of the ``model`` or ``seq`` axis, or of a seq x
    model mesh: its rank, the group's size, its ``torch.device``, the
    process group, and the collectives the forward pass calls. Counts each
    collective and its host seconds (``stats``). A gloo collective on CUDA
    tensors blocks the host until its copy back has landed, so the device
    is synchronized before its clock starts (its copy to the host would
    wait for that work anyway): the seconds are the collective's own,
    waits for the other ranks included. An NCCL collective is only
    enqueued; its seconds are the enqueue's.

    ``shape=(seq, model)`` (default ``(1, size)``, the ``model`` axis): a
    group with both above 1 builds the rank's two sub-groups
    (:meth:`axis_group`); a one-axis group is its own sub-group on that
    axis."""

    def __init__(self, rank: int, devices: Sequence[torch.device], store_path: str,
                 timeout_s: float = 120.0, shape: Optional[Tuple[int, int]] = None) -> None:
        store = dist.FileStore(store_path, len(devices))
        self._join(rank, devices, store, "data", timeout_s)
        seq, model = shape or (1, self.size)
        if seq * model != self.size:
            raise ValueError(f"a {seq} x {model} mesh needs {seq * model} ranks, "
                             f"got {self.size}")
        self.shape = (seq, model)
        self._axes: Dict[str, "TPGroup"] = {}
        if seq > 1 and model > 1:
            i, j = divmod(rank, model)
            # every rank joins its model row first, then its seq column: a
            # row's members all join it before any of them waits on a column
            self._axes[AXIS_MODEL] = TPGroup._sub(
                store, f"model{i}", j, [self.devices[i * model + c] for c in range(model)],
                timeout_s)
            self._axes[AXIS_SEQ] = TPGroup._sub(
                store, f"seq{j}", i, [self.devices[r * model + j] for r in range(seq)],
                timeout_s)
        elif self.size > 1:
            self._axes[AXIS_SEQ if seq > 1 else AXIS_MODEL] = self

    @classmethod
    def _sub(cls, store: "dist.Store", prefix: str, rank: int,
             devices: Sequence[torch.device], timeout_s: float) -> "TPGroup":
        sub = cls.__new__(cls)
        sub._join(rank, devices, store, prefix, timeout_s)
        sub.shape = (1, sub.size)
        sub._axes = {}
        return sub

    def _join(self, rank: int, devices: Sequence[torch.device], store: "dist.Store",
              prefix: str, timeout_s: float) -> None:
        self.rank = rank
        self.devices = [torch.device(d) for d in devices]
        self.size = len(self.devices)
        self.device = self.devices[rank]
        self.backend = choose_backend(self.devices)
        timeout = datetime.timedelta(seconds=timeout_s)
        if self.backend == "nccl":
            torch.cuda.set_device(self.device)
            self.group = _nccl_group(dist.PrefixStore(prefix, store), rank, self.size,
                                     timeout)
        else:
            self.group = dist.ProcessGroupGloo(dist.PrefixStore(prefix, store), rank,
                                               self.size, timeout)
        self._sync = self.backend == "gloo" and self.device.type == "cuda"
        self.stats: Dict[str, float] = {}
        self.reset_stats()

    def axis_group(self, axis: str) -> Optional["TPGroup"]:
        """This rank's group over ``axis`` (``"model"`` or ``"seq"``): the
        sub-group of a seq x model mesh, this group on a one-axis mesh, None
        where the axis has one rank."""
        return self._axes.get(axis)

    def _run(self, kind: str, t: torch.Tensor, call) -> torch.Tensor:
        if self._sync:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        call(t).wait()
        self._count(kind, t0)
        return t

    def _count(self, kind: str, t0: float) -> None:
        self.stats[kind] += 1
        self.stats[kind + "_s"] += time.perf_counter() - t0

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where gloo can take it: a pinned host copy of a CUDA
        tensor under gloo (the device synchronized first), else ``t``."""
        if not self._sync:
            return t.contiguous()
        torch.cuda.synchronize(self.device)
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host

    def _back(self, host: torch.Tensor) -> torch.Tensor:
        return host.to(self.device) if self._sync else host

    def _empty(self, shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
        if self._sync:
            return torch.empty(tuple(shape), dtype=dtype, pin_memory=True)
        return torch.empty(tuple(shape), dtype=dtype, device=self.device)

    def ring_hop(self, t: torch.Tensor) -> torch.Tensor:
        """One hop of a ring: send ``t`` to rank+1, receive rank-1's
        tensor of the same shape and dtype (a new tensor)."""
        t0 = time.perf_counter()
        src = self._host(t)
        out = self._empty(src.shape, src.dtype)
        recv = self.group.recv([out], (self.rank - 1) % self.size, 0)
        send = self.group.send([src], (self.rank + 1) % self.size, 0)
        send.wait()
        recv.wait()
        out = self._back(out)
        self._count("ring_hop", t0)
        return out

    def shift(self, t: torch.Tensor) -> Optional[torch.Tensor]:
        """One one-way hop with no wrap (a pipeline's activations): send
        ``t`` to rank+1 (the last rank sends nothing), receive rank-1's
        tensor of the same shape and dtype (a new tensor; None on rank 0)."""
        t0 = time.perf_counter()
        src = self._host(t)
        out, waits = None, []
        if self.rank > 0:
            out = self._empty(src.shape, src.dtype)
            waits.append(self.group.recv([out], self.rank - 1, 1))
        if self.rank < self.size - 1:
            waits.append(self.group.send([src], self.rank + 1, 1))
        for w in waits:
            w.wait()
        if out is not None:
            out = self._back(out)
        self._count("shift", t0)
        return out

    def all_to_all(self, t: torch.Tensor, split_dim: int, concat_dim: int) -> torch.Tensor:
        """``lax.all_to_all(..., tiled=True)``: ``t`` cut into ``size``
        equal parts along ``split_dim``, part j sent to rank j, and the
        parts received concatenated along ``concat_dim`` in rank order (a
        new tensor)."""
        t0 = time.perf_counter()
        n = self.size
        if t.shape[split_dim] % n:
            raise ValueError(f"dim {split_dim} of size {t.shape[split_dim]} does not "
                             f"split over {n} ranks")
        parts = torch.stack(torch.chunk(t, n, dim=split_dim))   # [n, ...]
        src = self._host(parts)
        out = self._empty(src.shape, src.dtype)
        self.group.alltoall_base(out, src, [], [], dist.AllToAllOptions()).wait()
        out = self._back(out)
        self._count("all_to_all", t0)
        return torch.cat(out.unbind(0), dim=concat_dim)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked in rank order: ``[size, *t.shape]``
        (a new tensor)."""
        t0 = time.perf_counter()
        src = self._host(t)
        outs = [self._empty(src.shape, src.dtype) for _ in range(self.size)]
        self.group.allgather([outs], [src]).wait()
        out = self._back(torch.stack(outs))
        self._count("all_gather", t0)
        return out

    def _reduce(self, t: torch.Tensor, op: "dist.ReduceOp") -> torch.Tensor:
        opts = dist.AllreduceOptions()
        opts.reduceOp = op
        return self._run("all_reduce", t, lambda x: self.group.allreduce([x], opts))

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; every rank gets the same
        bits (each element is reduced once and copied to the others)."""
        return self._reduce(t, dist.ReduceOp.SUM)

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise max of ``t`` over the ranks, in place."""
        return self._reduce(t, dist.ReduceOp.MAX)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, in place."""
        opts = dist.BroadcastOptions()
        opts.rootRank = src
        return self._run("broadcast", t, lambda x: self.group.broadcast([x], opts))

    def reset_stats(self) -> None:
        """Zero the counts of this group and of its sub-groups."""
        for kind in COLLECTIVES:
            self.stats[kind] = 0
            self.stats[kind + "_s"] = 0.0
        for sub in getattr(self, "_axes", {}).values():
            if sub is not self:
                sub.reset_stats()

    def close(self) -> None:
        """Release the group and its sub-groups (idempotent)."""
        for sub in self._axes.values():
            if sub is not self:
                sub.close()
        group, self.group = self.group, None
        if group is not None and hasattr(group, "shutdown"):
            try:
                group.shutdown()
            except RuntimeError:
                pass


def rank_devices(device: str, tp: int) -> Optional[list]:
    """The devices of ``tp`` ranks for a worker's ``device`` setting, one
    card each (the worker's rule: no more ranks than local cards), or None
    when the machine does not have them."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")] * tp
    if not torch.cuda.is_available() or torch.cuda.device_count() < tp:
        return None
    return [torch.device("cuda", i) for i in range(tp)]
