"""Tensor- and expert-parallel sharding rules for the params tree and the
KV pools, as slicing rules on tensors.

The port of ``distributed_gpu_inference_tpu/parallel/sharding.py``. The JAX
package states Megatron-style TP as ``NamedSharding``s and XLA inserts the
all-reduces; here every rank of the ``model`` axis holds the slice these
rules give it, and ``models/llama.py`` sums the row-parallel products
across ranks itself. The rule table is the JAX package's:

==================  ===========================  ==========================
param               shape                        rule
==================  ===========================  ==========================
embedding           [V, H]                       replicated
layers.attn_norm    [L, H]                       replicated
layers.wq           [L, H, Nh*D]                 cut the out dim
layers.wk / wv      [L, H, Nkv*D]                cut the out dim
layers.bq / bk / bv [L, N]                       cut the out dim
layers.wo           [L, Nh*D, H]                 cut the in dim
layers.w_gate/up    [L, H, I]                    cut the out dim
layers.w_down       [L, I, H]                    cut the in dim
layers.w_router     [L, H, E]                    replicated
layers.we_*         [L, E, ...]                  cut the expert axis E
final_norm          [H]                          replicated
lm_head             [V, H]                       replicated
kv pools            [L, N, Hkv, Bk, D]           cut Hkv
int8 scale pools    [L, N, Bk]                   replicated
==================  ===========================  ==========================

A quantized leaf ``{"qw", "scale"}`` cuts ``qw`` as its weight and cuts
``scale`` on the same axis only where the scale has that axis at full
size: with the out dim of a column-parallel weight and with E, replicated
for a row-parallel one (its scale is ``[L, 1, N]``, an amax over the whole
K). So a weight is quantized whole and then cut, never cut and then
quantized: a rank that quantized only its K-slice of ``wo`` would store
other codes and scales than the one-rank engine.

Every function here works on torch tensors and on numpy arrays alike
(basic slicing), and returns contiguous copies.

The ``seq`` axis (JAX ``kv_sharding_seq`` / ``kv_scale_sharding_seq``):
params are replicated over it, and block-sharded pools
(``EngineConfig.kv_seq_sharded``) cut the block axis N of every data and
scale pool, rank r holding the global blocks ``[r·N/n, (r+1)·N/n)``
(:func:`block_range`); block ids in the tables stay global. The engine
rounds N up to a multiple of n (:func:`seq_num_blocks`) as the JAX engine
does.

Both axes (a ``MeshPlan(seq=s, model=m)`` engine, JAX ``kv_sharding_seq``
with ``model`` above 1): rank ``i*m + j`` holds the weights cut j of m
over ``model`` (replicated over ``seq``), the data pools cut on Hkv over
``model`` and, block-sharded, on N over ``seq``, and the int8 scale pools
cut on N over ``seq`` only (:func:`shard_kv_mesh`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

# the axis of each stacked layer leaf [L, ...] cut over ``model``; None =
# replicated. Top-level leaves (embedding, final_norm, lm_head) are
# replicated.
LAYER_RULES: Dict[str, Optional[int]] = {
    "attn_norm": None,
    "wq": 2, "wk": 2, "wv": 2,
    "wo": 1,
    "bq": 1, "bk": 1, "bv": 1,
    "mlp_norm": None,
    "w_gate": 2, "w_up": 2,
    "w_down": 1,
    "w_router": None,
    "we_gate": 1, "we_up": 1, "we_down": 1,
}
TOP_RULES: Dict[str, Optional[int]] = {"embedding": None, "final_norm": None,
                                       "lm_head": None}
# KV data pools [L, N, Hkv, Bk, D] cut on Hkv; scale pools replicated
KV_AXIS = 2


def param_rules() -> Dict[str, Any]:
    """The rule tree matching ``models.llama.init_params``' layout: each
    leaf's cut axis over ``model`` or None (the JAX ``param_shardings``)."""
    return {**TOP_RULES, "layers": dict(LAYER_RULES)}


def scale_axis(axis: Optional[int], scale: Any) -> Optional[int]:
    """A quantized weight's scale keeps the weight's cut axis only where
    its dim there is larger than 1 (a reduced, size-1 dim carries no
    shard)."""
    keep = axis is not None and axis < scale.ndim and scale.shape[axis] > 1
    return axis if keep else None


def _quantized_leaf_rules(axis: Optional[int], leaf: Dict[str, Any]) -> Dict[str, Any]:
    """Expand a weight's rule over a quantized ``{"qw","scale"}`` leaf: qw
    keeps the weight's axis, the scale by :func:`scale_axis`."""
    return {"qw": axis, "scale": scale_axis(axis, leaf["scale"])}


def prune_rules(rules: Dict[str, Any], params: Dict[str, Any]) -> Dict[str, Any]:
    """Restrict a rule tree to the keys this model has (``lm_head`` absent
    when tied, bias keys absent for bias-free families) and expand the
    rules over quantized leaves, so the rule tree's structure matches the
    params tree's."""
    rules = {k: v for k, v in rules.items() if k == "layers" or k in params}
    rules["layers"] = {
        k: (_quantized_leaf_rules(v, params["layers"][k])
            if isinstance(params["layers"][k], dict) else v)
        for k, v in rules["layers"].items() if k in params["layers"]
    }
    return rules


def _contiguous(x: Any) -> Any:
    if isinstance(x, np.ndarray):
        return np.ascontiguousarray(x)
    return x.contiguous()


def cut(x: Any, axis: Optional[int], rank: int, tp: int) -> Any:
    """Rank ``rank``'s part of ``x`` along ``axis`` (None: all of it), a
    contiguous copy when cut. The dim must divide by ``tp``."""
    if axis is None or tp == 1:
        return x
    n = x.shape[axis]
    if n % tp:
        raise ValueError(f"dim {axis} of size {n} does not divide over {tp} ranks")
    part = n // tp
    index = (slice(None),) * axis + (slice(rank * part, (rank + 1) * part),)
    return _contiguous(x[index])


def shard_tree(params: Dict[str, Any], rank: int, tp: int) -> Dict[str, Any]:
    """Rank ``rank``'s params tree out of a whole one (quantized leaves
    cut by their expanded rules)."""
    rules = prune_rules(param_rules(), params)

    def go(node: Any, rule: Any) -> Any:
        if isinstance(node, dict):
            return {k: go(v, rule[k] if isinstance(rule, dict) else rule)
                    for k, v in node.items()}
        return cut(node, rule, rank, tp)

    out = {k: go(v, rules[k]) for k, v in params.items() if k != "layers"}
    out["layers"] = go(params["layers"], rules["layers"])
    return out


def leaf_axis(name: str) -> Optional[int]:
    """The cut axis of a stacked layer leaf or a top-level leaf by name."""
    if name in LAYER_RULES:
        return LAYER_RULES[name]
    return TOP_RULES.get(name)


def cut_quantized_at(q: Dict[str, Any], axis: Optional[int], rank: int,
                     tp: int) -> Dict[str, Any]:
    """A whole quantized ``{"qw", "scale"}`` (a leaf or a slice of one) cut
    on ``axis`` → rank ``rank``'s part."""
    rules = _quantized_leaf_rules(axis, q)
    return {k: cut(v, rules[k], rank, tp) for k, v in q.items()}


def cut_quantized(name: str, q: Dict[str, Any], rank: int, tp: int) -> Dict[str, Any]:
    """A whole quantized leaf ``{"qw", "scale"}`` → rank ``rank``'s part."""
    return cut_quantized_at(q, leaf_axis(name), rank, tp)


def shard_kv(kv: Dict[str, Any], rank: int, tp: int) -> Dict[str, Any]:
    """Rank ``rank``'s KV pools: data pools cut on Hkv, scale pools
    replicated (one scale per (page, token) over every KV head)."""
    return {k: (v if k.endswith("_scale") else cut(v, KV_AXIS, rank, tp))
            for k, v in kv.items()}


def expert_range(num_experts: int, rank: int, tp: int) -> Tuple[int, int]:
    """[e0, e1): the experts rank ``rank`` holds."""
    per = num_experts // tp
    return rank * per, (rank + 1) * per



# KV pools [L, N, ...] (data and scale pools alike) cut on N over ``seq``
BLOCK_AXIS = 1


def seq_num_blocks(num_blocks: int, seq: int) -> int:
    """The pool's block count rounded up to a multiple of the ``seq`` axis,
    so the block axis shards evenly."""
    return -(-num_blocks // seq) * seq


def block_range(num_blocks: int, rank: int, seq: int) -> Tuple[int, int]:
    """[lo, hi): the global blocks rank ``rank`` holds of a pool of
    ``num_blocks`` sharded over ``seq`` ranks; an uneven pool is refused."""
    if num_blocks % seq:
        raise ValueError(f"pool blocks {num_blocks} not divisible by seq axis {seq}")
    per = num_blocks // seq
    return rank * per, (rank + 1) * per


def shard_kv_blocks(kv: Dict[str, Any], rank: int, seq: int) -> Dict[str, Any]:
    """Rank ``rank``'s block-sharded pools: every data and scale pool cut
    on the block axis (:func:`block_range`, which refuses an uneven pool)."""
    out = {}
    for k, v in kv.items():
        lo, hi = block_range(v.shape[BLOCK_AXIS], rank, seq)
        out[k] = _contiguous(v[:, lo:hi])
    return out


def mesh_coords(rank: int, model: int) -> Tuple[int, int]:
    """(seq row i, model column j) of rank ``rank`` of a seq x model mesh:
    rank ``i*model + j``."""
    return divmod(rank, model)


def shard_kv_mesh(kv: Dict[str, Any], rank: int, seq: int, model: int,
                  seq_sharded: bool) -> Dict[str, Any]:
    """Rank ``rank``'s pools of a seq x model mesh out of whole ones: data
    pools cut on Hkv over ``model`` (scale pools whole over it), then,
    block-sharded, every pool cut on N over ``seq``."""
    i, j = mesh_coords(rank, model)
    out = shard_kv(kv, j, model)
    return shard_kv_blocks(out, i, seq) if seq_sharded else out
