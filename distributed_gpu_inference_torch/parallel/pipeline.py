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

The JAX file's other half, the in-mesh SPMD pipeline
(``pipelined_forward`` with ``shard_map`` over a ``stage`` mesh axis and
``ppermute`` hops), needs a device mesh: it waits for a
``torch.distributed`` slice with tensor parallelism (ROADMAP §1 item 7).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch

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
