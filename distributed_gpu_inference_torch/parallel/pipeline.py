"""Pipeline stages: which layers each stage owns, and a stage's weights.

The port of the host-side planning of
``distributed_gpu_inference_tpu/parallel/pipeline.py`` (``uniform_stages``,
``create_shard_plan``, ``slice_stage_params``), which the cross-host
pipeline (``comm/stage_worker.py``, ``comm/session.py``) runs on:

- :func:`uniform_stages` splits ``[0, L)`` evenly;
- :func:`create_shard_plan` gives each stage layers in proportion to its
  device memory less a KV reserve, in units of
  ``ModelConfig.layer_param_bytes``. On the card the byte counts come from
  ``torch.cuda.mem_get_info`` (:func:`device_bytes`);
- :func:`slice_stage_params` cuts one stage's tree out of a whole one as
  VIEWS of it: stages on one device share the weights' memory.

The JAX file's other half is the in-mesh SPMD pipeline, here on stage
ranks (one process each, ``runtime/tp.py`` ``run_group``) joined in a
``parallel.mesh.TPGroup``:

- :func:`shard_params_stages` / :func:`shard_kv_stages` give rank s the
  layers ``[s·L/n, (s+1)·L/n)`` of the stacked weights and of the pools
  (the embedding, final norm and LM head on every rank, as JAX's stage
  shardings replicate them);
- :func:`pipelined_forward` runs the GPipe diagonal: on tick t rank s
  works on microbatch t − s through ``models.llama.forward_hidden_chunk``
  (the ragged kernel, the fused decode kernel at S = 1, and qmm on int8
  weights), and its activations hop one way to rank s + 1
  (``TPGroup.shift``, JAX's ``ppermute`` with no wrap). Ticks outside a
  rank's diagonal run with every position −1, so they write no KV, as in
  JAX. The last rank projects each microbatch's last valid token and
  broadcasts the logits ``[n_micro, mb, V]`` to every rank.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from distributed_gpu_inference_torch.models import llama
from distributed_gpu_inference_torch.models.configs import ModelConfig
from distributed_gpu_inference_torch.models.llama import Params, torch_dtype


def uniform_stages(num_layers: int, num_stages: int) -> List[Tuple[int, int]]:
    """Even split of [0, L) into stages, the first ``L % n`` one layer
    longer."""
    base, rem = divmod(num_layers, num_stages)
    plan, start = [], 0
    for s in range(num_stages):
        n = base + (1 if s < rem else 0)
        plan.append((start, start + n))
        start += n
    return plan


def device_bytes(device: Any = "cuda") -> int:
    """The free memory of a CUDA device in bytes, as
    ``torch.cuda.mem_get_info`` reads it: what :func:`create_shard_plan`
    takes for a stage on that card."""
    return int(torch.cuda.mem_get_info(torch.device(device))[0])


def create_shard_plan(
    cfg: ModelConfig,
    hbm_bytes: Sequence[int],
    kv_reserve_frac: float = 0.3,
) -> List[Tuple[int, int]]:
    """Layer ranges proportional to each stage's device bytes less a KV
    reserve. Every stage gets at least one layer; a stage that fits none,
    or stages that together fit fewer layers than the model has, raise
    rather than overcommit."""
    usable = [max(0.0, b * (1.0 - kv_reserve_frac)) for b in hbm_bytes]
    per_layer = cfg.layer_param_bytes(torch_dtype(cfg.dtype).itemsize)
    cap = [int(u // per_layer) for u in usable]
    L, n = cfg.num_layers, len(hbm_bytes)
    if n > L:
        raise ValueError(f"{n} stages > {L} layers; every stage needs ≥1 layer")
    for s, c in enumerate(cap):
        if c < 1:
            raise ValueError(
                f"stage {s} fits 0 layers "
                f"(per-layer {per_layer / 1e6:.1f} MB > usable HBM)"
            )
    if sum(cap) < L:
        raise ValueError(
            f"stages fit {sum(cap)} layers < model's {L}; "
            f"add stages or HBM (per-layer {per_layer / 1e6:.1f} MB)"
        )
    total = sum(usable)
    raw = [u / total * L for u in usable]
    counts = [1] * n
    while sum(counts) < L:
        cands = [s for s in range(n) if counts[s] < cap[s]]
        s = max(cands, key=lambda j: raw[j] - counts[j])
        counts[s] += 1
    plan, start = [], 0
    for c in counts:
        plan.append((start, start + c))
        start += c
    return plan


def slice_stage_params(
    params: Params, start: int, end: int, *, num_layers: int
) -> Params:
    """One stage's params as views of ``params``: the layers ``[start,
    end)`` of every stacked leaf (a quantized ``{"qw", "scale"}`` leaf
    slices both parts on their L axis), the embedding on the first stage,
    the final norm and LM head on the last (tied embeddings: the last stage
    keeps the embedding table as its head)."""
    layers: Dict[str, Any] = {
        k: ({kk: vv[start:end] for kk, vv in v.items()} if isinstance(v, dict)
            else v[start:end])
        for k, v in params["layers"].items()
    }
    out: Params = {"layers": layers}
    if start == 0:
        out["embedding"] = params["embedding"]
    if end == num_layers:
        out["final_norm"] = params["final_norm"]
        if "lm_head" in params:
            out["lm_head"] = params["lm_head"]
        elif start != 0:
            out["embedding"] = params["embedding"]
    return out


# ---------------------------------------------------------------------------
# The in-mesh stage pipeline (JAX's shard_map over the stage axis)
# ---------------------------------------------------------------------------


def _check_even(num_layers: int, n_stages: int) -> None:
    if num_layers % n_stages:
        raise ValueError(
            f"{num_layers} layers not divisible by {n_stages} stages; "
            "use the cross-host planner (create_shard_plan) for uneven splits"
        )


def stage_layers(num_layers: int, stage: int, n_stages: int) -> Tuple[int, int]:
    """[start, end): the layers stage ``stage`` of ``n_stages`` holds (an
    even split, refused otherwise)."""
    _check_even(num_layers, n_stages)
    per = num_layers // n_stages
    return stage * per, (stage + 1) * per


def shard_params_stages(params: Params, stage: int, n_stages: int) -> Params:
    """Stage ``stage``'s params (JAX ``stage_param_shardings``): its layers
    of every stacked leaf (a quantized leaf's both parts), as views, and the
    embedding, final norm and LM head whole."""
    lo, hi = stage_layers(_num_layers(params), stage, n_stages)
    out: Params = {"layers": {
        k: ({kk: vv[lo:hi] for kk, vv in v.items()} if isinstance(v, dict) else v[lo:hi])
        for k, v in params["layers"].items()}}
    for name in ("embedding", "final_norm", "lm_head"):
        if name in params:
            out[name] = params[name]
    return out


def shard_kv_stages(kv: Dict[str, torch.Tensor], stage: int,
                    n_stages: int) -> Dict[str, torch.Tensor]:
    """Stage ``stage``'s pools (JAX ``stage_kv_sharding``): the layer axis
    follows the stage, as views."""
    lo, hi = stage_layers(kv["k"].shape[0], stage, n_stages)
    return {k: v[lo:hi] for k, v in kv.items()}


def _num_layers(params: Params) -> int:
    leaf = params["layers"]["attn_norm"]
    return leaf.shape[0]


def pipelined_forward(
    cfg: ModelConfig,
    params: Params,                # stage-local (shard_params_stages)
    tokens: torch.Tensor,          # [n_micro, mb, S] int
    positions: torch.Tensor,       # [n_micro, mb, S] int32, -1 = pad
    kv: Dict[str, torch.Tensor],   # stage-local [L/n, N, Hkv, Bk, D], IN PLACE
    block_tables: torch.Tensor,    # [n_micro, mb, M]
    kv_lens: torch.Tensor,         # [n_micro, mb]
    group: Optional[Any],
    *,
    block_size: int = 16,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Microbatched pipeline forward on one stage rank → (logits ``[n_micro,
    mb, V]`` f32 of the last stage, on every rank; the pools, updated in
    place). Every rank of ``group`` (the stage axis; None: one stage) calls
    it with the same inputs. Prefill (S = chunk) and decode (S = 1) alike.
    A model whose layers do not split evenly over the stages is refused."""
    n_stages, stage = (1, 0) if group is None else (group.size, group.rank)
    _check_even(cfg.num_layers, n_stages)
    n_micro, mb, s_len = tokens.shape
    device = tokens.device
    # the activation dtype follows the weights (a tree loaded in float32 on
    # the CPU runs in float32)
    act = torch.zeros((mb, s_len, cfg.hidden_size), dtype=params["embedding"].dtype,
                      device=device)
    out = torch.zeros((n_micro, mb, cfg.vocab_size), dtype=torch.float32, device=device)
    positions = positions.to(torch.int32)
    last = stage == n_stages - 1
    for t in range(n_micro + n_stages - 1):
        my_mb = t - stage
        valid = 0 <= my_mb < n_micro
        idx = min(max(my_mb, 0), n_micro - 1)
        pos = positions[idx]
        act_in = llama.embed_tokens(params, tokens[idx], cfg) if stage == 0 else act
        write_pos = pos if valid else torch.full_like(pos, -1)
        hidden, _ = llama.forward_hidden_chunk(cfg, params, act_in, write_pos, kv,
                                               block_tables[idx], kv_lens[idx],
                                               block_size=block_size)
        if last and valid:
            n_valid = (pos >= 0).sum(dim=1)
            last_idx = torch.clamp(n_valid - 1, min=0)
            h_last = torch.gather(hidden, 1,
                                  last_idx[:, None, None].expand(-1, 1, hidden.shape[-1]))
            out[idx] = llama.project_logits(cfg, params, h_last)[:, 0, :]
        if group is not None and t < n_micro + n_stages - 2:
            got = group.shift(hidden)
            if got is not None:
                act = got
    if group is not None and n_stages > 1:
        group.broadcast(out, src=n_stages - 1)
    return out, kv
