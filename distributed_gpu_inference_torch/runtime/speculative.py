"""Speculative decoding: an EAGLE-style draft head and token-tree
verification over the paged KV pools.

The port of ``distributed_gpu_inference_tpu/runtime/speculative.py``:

- :class:`SpecDecodeConfig` configures the engine-INTEGRATED mode
  (``EngineConfig.speculative``): every active slot drafts a chain of K
  tokens with the draft head, one multi-query target pass (q_len = K+1 a
  slot, through the ragged kernel on the card) verifies it, and each slot
  commits 1..K+1 tokens (``runtime/engine.py``).
- :class:`SpeculativeDecoder` is the STANDALONE tree decoder
  (``engine: jax-speculative``): greedy requests draft a static token tree
  (``TreeTopology``), one target pass verifies it through
  :func:`ops.attention.paged_tree_attention` (plain torch: the reference
  computes it with XLA, not Pallas), and the accepted path's KV rows are
  compacted into depth order (:func:`_move_rows`).

With temperature 0 the emitted stream is the target's greedy stream
whatever the draft proposes: the draft only changes how many tokens a
round commits.

The JAX decoder runs ``rounds_per_dispatch`` rounds as one jitted
``lax.scan``; here the rounds run as an eager loop on the device with the
same per-round device state (done, emitted counts, stop and budget
masking) and the same per-round record, which the host replays into the
cache manager and the emission exactly as the JAX decoder does. The loop
stops once every row is done (the scan's later rounds are all-inactive,
and the host replay stops at the first of those). Draft weights drawn by
:func:`init_draft_params` come from a ``torch.Generator`` and are not the
JAX package's threefry draws; tests that compare the two packages carry
one set of draft weights across with ``models/convert.py``
``draft_params_from_numpy``. :func:`distill_draft_params` fits the
draft head against the frozen target with torch autograd and an Adam
written to optax's rule (the JAX package trains it with optax).
"""

from __future__ import annotations

import functools
import time
import uuid
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from distributed_gpu_inference_torch.models import llama
from distributed_gpu_inference_torch.models.configs import ModelConfig, get_model_config
from distributed_gpu_inference_torch.runtime.kv_cache import PagedKVCacheManager
from distributed_gpu_inference_torch.utils.data_structures import (
    InferenceRequest,
    InferenceResponse,
)

# ---------------------------------------------------------------------------
# Static token-tree topology
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TreeTopology:
    """Node 0 is the root (the pending token); ``widths[d]`` children per
    frontier node at depth d+1."""

    widths: Tuple[int, ...] = (4, 2)

    @functools.cached_property
    def parents(self) -> np.ndarray:
        parents = [-1]
        frontier = [0]
        for w in self.widths:
            nxt: List[int] = []
            for p in frontier:
                for _ in range(w):
                    parents.append(p)
                    nxt.append(len(parents) - 1)
            frontier = nxt
        return np.asarray(parents, np.int32)

    @functools.cached_property
    def depths(self) -> np.ndarray:
        d = np.zeros(len(self.parents), np.int32)
        for i, p in enumerate(self.parents):
            if p >= 0:
                d[i] = d[p] + 1
        return d

    @property
    def num_nodes(self) -> int:
        return len(self.parents)

    @property
    def max_depth(self) -> int:
        return len(self.widths)

    @functools.cached_property
    def ancestor_mask(self) -> np.ndarray:
        """mask[i, j] = node i attends node j (ancestor-or-self)."""
        n = self.num_nodes
        m = np.zeros((n, n), bool)
        for i in range(n):
            cur = i
            while cur >= 0:
                m[i, cur] = True
                cur = int(self.parents[cur])
        return m

    @functools.cached_property
    def level_slices(self) -> List[Tuple[int, int]]:
        """[(start, end)] node-index range per depth level (root excluded)."""
        out = []
        start = 1
        count = 1
        for w in self.widths:
            count *= w
            out.append((start, start + count))
            start += count
        return out


@dataclass
class SpecDecodeConfig:
    """Engine-integrated speculative decoding (``TorchEngine`` decode mode):
    every active slot drafts ``num_draft_tokens`` greedily with the draft
    head, then ONE multi-query target pass (q_len = K+1 a slot) verifies
    the chain and each slot commits 1..K+1 tokens. Chain positions are
    sequential, so accepted KV is already in place and a rejected suffix is
    overwritten by the next round: no tree compaction, and it composes with
    prefix caching, CoW, int8 KV and sliding windows."""

    # K drafted tokens per slot per round; the verify pass scores K+1
    # queries (bounded by the block-growth checks in ``validate``)
    num_draft_tokens: int = 4
    # draft head weights (``init_draft_params`` layout, tensors on the
    # engine's device). None = random init from ``draft_seed``: near-zero
    # acceptance but still correct (greedy outputs are target-verified)
    draft_params: Optional[Dict[str, torch.Tensor]] = None
    draft_seed: int = 1
    # acceptance-adaptive draft depth: a per-slot EMA of the ACCEPTED
    # length selects each slot's depth from ``k_choices()``; the chain
    # always drafts ``num_draft_tokens`` and deeper columns are masked.
    # Host float arithmetic over integer accept counts: same seed → same
    # K schedule
    adaptive: bool = False
    adaptive_min_k: int = 1
    adaptive_ema: float = 0.8            # EMA weight on the PREVIOUS value
    adaptive_k_choices: Optional[Tuple[int, ...]] = None  # None = powers
    #   of two from adaptive_min_k up, plus num_draft_tokens itself
    # ORACLE draft: force the per-round accepted length to ``rate * K``
    # (fractional rates dither deterministically) instead of matching
    # against the target. Draft cost, verify cost, KV writes, commits and
    # rollback are all real; committed tokens are the (garbage) drafts, so
    # pair it with ignore_eos requests. None = real acceptance
    oracle_accept_rate: Optional[float] = None

    def k_choices(self) -> Tuple[int, ...]:
        """The static set adaptive depth selects from (ascending, ending
        at ``num_draft_tokens``)."""
        if self.adaptive_k_choices is not None:
            return tuple(sorted(set(int(c) for c in self.adaptive_k_choices)))
        lo = max(1, int(self.adaptive_min_k))
        out = []
        c = lo
        while c < self.num_draft_tokens:
            out.append(c)
            c *= 2
        out.append(self.num_draft_tokens)
        return tuple(out)

    def validate(self, engine_cfg: Any) -> None:
        """Reject configs whose worst-case per-step block growth cannot fit
        the engine's per-sequence block table: a step writes K+1 new KV
        rows and keeps one pending token, so the worst case touches
        ``ceil((K+2)/block_size) + 1`` blocks."""
        k = self.num_draft_tokens
        if k < 1:
            raise ValueError(
                f"SpecDecodeConfig.num_draft_tokens={k}: need at least 1 "
                "drafted token (0 would be vanilla decode — disable "
                "speculative instead)"
            )
        bs = engine_cfg.block_size
        m = engine_cfg.max_blocks_per_seq
        growth = -(-(k + 2) // bs) + 1
        if growth > m:
            raise ValueError(
                f"SpecDecodeConfig.num_draft_tokens={k}: worst-case "
                f"per-step block growth {growth} exceeds max_blocks_per_seq="
                f"{m} (max_seq_len={engine_cfg.max_seq_len} / block_size="
                f"{bs}); num_draft_tokens is the limiting field — reduce it "
                "or raise max_seq_len"
            )
        if k + 2 >= engine_cfg.max_seq_len:
            raise ValueError(
                f"SpecDecodeConfig.num_draft_tokens={k}: a verify window of "
                f"{k + 1} tokens does not fit max_seq_len="
                f"{engine_cfg.max_seq_len}; num_draft_tokens is the "
                "limiting field"
            )
        if getattr(engine_cfg, "kv_seq_sharded", False):
            raise ValueError(
                "speculative + kv_seq_sharded is fenced: the seq-sharded "
                "pool decode read (shard_map partial-softmax op) has no "
                "multi-query verify-window variant, so draft/verify "
                "rounds cannot read sharded pools — drop kv_seq_sharded "
                "or EngineConfig.speculative"
            )
        if self.oracle_accept_rate is not None and not (
            0.0 <= float(self.oracle_accept_rate) <= 1.0
        ):
            raise ValueError(
                f"SpecDecodeConfig.oracle_accept_rate="
                f"{self.oracle_accept_rate}: must be in [0, 1] (fraction "
                "of drafted tokens force-accepted per round)"
            )
        if self.adaptive:
            if not (0.0 <= float(self.adaptive_ema) < 1.0):
                raise ValueError(
                    f"SpecDecodeConfig.adaptive_ema={self.adaptive_ema}: "
                    "must be in [0, 1)"
                )
            if not (1 <= int(self.adaptive_min_k) <= k):
                raise ValueError(
                    f"SpecDecodeConfig.adaptive_min_k="
                    f"{self.adaptive_min_k}: must be in "
                    f"[1, num_draft_tokens={k}]"
                )
            choices = self.k_choices()
            if choices[0] < 1 or choices[-1] != k:
                raise ValueError(
                    f"SpecDecodeConfig adaptive depth choices {choices} "
                    f"must lie in [1, num_draft_tokens={k}] and end at "
                    f"num_draft_tokens; adaptive_min_k/adaptive_k_choices "
                    "are the limiting fields"
                )


@dataclass
class SpeculativeConfig:
    """The standalone tree decoder's configuration."""

    widths: Tuple[int, ...] = (4, 2)
    adaptive: bool = True
    min_accept_rate: float = 0.3       # shrink depth below this
    grow_accept_rate: float = 0.7      # grow depth above this
    min_depth: int = 1
    max_depth: int = 4
    ema: float = 0.8
    # draft→verify→accept rounds per ``advance_wave`` call (the bounded
    # work a serving loop interleaves with paged rounds); bucketed to a
    # power of two as the JAX decoder's scan lengths are, so the dispatch
    # structure (and with it the adaptive schedule) is the same
    rounds_per_dispatch: int = 8
    # EAGLE-3-style multi-layer draft features: indices of target LAYERS
    # whose post-layer hiddens concat into the draft input. None =
    # last-layer-only. The draft gains a learned [k*H, H] input projection
    feature_layers: Optional[Tuple[int, ...]] = None

    def validate_blocks(self, max_blocks_per_seq: int,
                        block_size: int) -> None:
        """Reject width/depth combinations whose worst-case per-round block
        growth (the verify tree, adaptive depth growth included, plus the
        pending root) exceeds the per-sequence block table."""
        widths = tuple(self.widths)
        if not widths or any(w < 1 for w in widths):
            raise ValueError(
                f"SpeculativeConfig.widths={self.widths}: every tree level "
                "needs width >= 1; widths is the limiting field"
            )
        worst = widths
        if self.adaptive:
            worst = worst + (1,) * max(0, self.max_depth - len(worst))
        nodes = TreeTopology(worst).num_nodes
        growth = -(-(nodes + 1) // block_size) + 1
        if growth > max_blocks_per_seq:
            adapt = (
                f" (adaptive depth growth to max_depth={self.max_depth})"
                if self.adaptive else ""
            )
            raise ValueError(
                f"SpeculativeConfig.widths={self.widths}{adapt}: worst-case "
                f"verify tree of {nodes} nodes needs {growth} blocks per "
                f"round, exceeding max_blocks_per_seq={max_blocks_per_seq} "
                f"(block_size={block_size}); widths/max_depth are the "
                "limiting fields"
            )


# ---------------------------------------------------------------------------
# Draft heads
# ---------------------------------------------------------------------------


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype of the two (JAX's promotion)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def init_draft_params(
    cfg: ModelConfig, generator: torch.Generator, dtype: Any = None,
    num_feature_layers: int = 1, device: Any = None,
) -> Dict[str, torch.Tensor]:
    """EAGLE-style draft net: h_next = W2 · silu(W1 · [h ; e(tok)]), the
    JAX package's layout: ``w_fuse [2H, H]``, ``w_out [H, H]``, ``norm
    [H]`` and, for ``num_feature_layers > 1``, the EAGLE-3 input
    projection ``w_feat [k·H, H]``. Shares the target's embedding and LM
    head. Drawn in f32 from ``generator`` (normal, scaled by fan_in^-0.5):
    not the JAX package's threefry draws."""
    dtype = llama.torch_dtype(dtype or cfg.dtype)
    device = torch.device(device) if device is not None else generator.device
    h = cfg.hidden_size

    def _w(rows: int) -> torch.Tensor:
        w = torch.randn((rows, h), generator=generator, device=device,
                        dtype=torch.float32)
        return (w * rows ** -0.5).to(dtype)

    dp = {"w_fuse": _w(2 * h), "w_out": _w(h),
          "norm": torch.ones((h,), dtype=dtype, device=device)}
    if num_feature_layers > 1:
        dp["w_feat"] = _w(num_feature_layers * h)
    return dp


def draft_apply(
    cfg: ModelConfig, dp: Dict[str, torch.Tensor], hidden: torch.Tensor,
    tok_emb: torch.Tensor,
) -> torch.Tensor:
    """[..., H or k·H] × [..., H] → predicted next hidden [..., H]. A
    k·H-wide input (multi-layer features from a verify pass) goes through
    ``w_feat`` first; H-wide inputs (the draft's own predictions) skip it."""
    if "w_feat" in dp and hidden.shape[-1] == dp["w_feat"].shape[0]:
        hidden = hidden @ dp["w_feat"].to(hidden.dtype)
    dt = torch.promote_types(hidden.dtype, tok_emb.dtype)
    x = torch.cat([hidden.to(dt), tok_emb.to(dt)], dim=-1)
    x = _mm(F.silu(_mm(x, dp["w_fuse"])), dp["w_out"])
    return llama.rms_norm(x, dp["norm"], cfg.rms_norm_eps)


def _categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw a row from ``softmax(logits)`` by the Gumbel-max trick (the
    method of ``jax.random.categorical``, on torch's generator)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32).clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits.float() - torch.log(-torch.log(u)), dim=-1)


def distill_draft_params(
    cfg: ModelConfig,
    params: llama.Params,
    generator: Any = 0,
    steps: int = 400,
    batch: int = 8,
    seq_len: int = 64,
    num_batches: int = 8,
    lr: float = 2e-3,
    ce_weight: float = 0.2,
    feature_layers: Optional[Tuple[int, ...]] = None,
    on_policy: bool = False,
    data_stream: Any = None,
    init_draft: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """EAGLE-style draft-head distillation against the frozen target (the
    port of the JAX function of this name; same arguments and recipe).

    The teacher runs with no grad: ``forward_chunk`` over ``num_batches``
    fixed streams of ``batch x seq_len`` tokens (through the ragged kernel
    on the card), ``project_logits``, and the top-64 log-probs with their
    indices, ordered as ``lax.top_k`` orders them. The student, in f32,
    regresses ``draft(h_t, e(x_{t+1})) -> h_{t+1}`` (feature MSE) plus
    ``ce_weight`` times the cross-entropy against the teacher's top-k
    next-token distribution, for ``steps`` Adam updates on batch ``step %
    num_batches``. Adam is optax's ``adam(lr)`` rule written out (b1 0.9,
    b2 0.999, eps 1e-8, eps_root 0). The target's weights are never
    trainable: only the prediction's gradient flows back through
    ``project_logits``. The norm gain starts at the teacher hiddens' RMS.
    Returns the head in the model's dtype and, unlike the JAX function
    (which returns the head only), the ``[steps]`` f32 losses on the
    host.

    ``generator``: a ``torch.Generator`` on the params' device, or a seed;
    it draws the streams, the rollouts and (without ``init_draft``) the
    starting head. These are not the JAX package's ``jax.random`` draws,
    so the default streams differ from JAX's. ``data_stream(generator,
    batch, seq_len) -> [B, S]`` int tokens overrides the streams.
    ``on_policy`` samples each stream from the target itself (decode steps
    of S = 1, through the fused decode kernel on the card), one Gumbel-max
    draw a token from the generator: it cannot reproduce
    ``jax.random.categorical``'s draws. ``feature_layers`` distils on the
    concatenated hiddens of those layers (adds ``w_feat``). ``init_draft``
    (port-only) is the starting head, tensors on the device (e.g. the JAX
    head through ``models.convert.draft_params_from_numpy``)."""
    dev = params["embedding"].device
    act_dtype = params["embedding"].dtype
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=dev).manual_seed(int(generator))
    bs = 16
    m = -(-seq_len // bs)
    positions = torch.arange(seq_len, dtype=torch.int32, device=dev).repeat(batch, 1)
    lens = torch.full((batch,), seq_len, dtype=torch.int32, device=dev)
    tables = torch.arange(1, 1 + batch * m, dtype=torch.int32, device=dev).reshape(batch, m)
    collect = tuple(feature_layers) if feature_layers else None

    def pools():
        return llama.init_kv_pools(cfg, 1 + batch * m, bs, act_dtype, dev)

    def rollout() -> torch.Tensor:
        tok = torch.randint(0, cfg.vocab_size, (batch,), generator=generator, device=dev)
        kv, out = pools(), [tok]
        for p in range(seq_len - 1):
            pos = torch.full((batch, 1), p, dtype=torch.int32, device=dev)
            logits = llama.forward_chunk(cfg, params, tok[:, None], pos, kv, tables,
                                         lens.new_full((batch,), p + 1),
                                         block_size=bs).logits[:, 0]
            tok = _categorical(logits, generator)
            out.append(tok)
        return torch.stack(out, dim=1)

    label_k = min(64, cfg.vocab_size)
    hiddens, featss, top_lps, top_idxs, tokens_all = [], [], [], [], []
    with torch.no_grad():
        for _ in range(num_batches):
            if data_stream is not None:
                toks = torch.as_tensor(np.asarray(data_stream(generator, batch, seq_len)),
                                       device=dev)
            elif on_policy:
                toks = rollout()
            else:
                toks = torch.randint(0, cfg.vocab_size, (batch, seq_len), generator=generator,
                                     device=dev)
            toks = toks.to(torch.int32)
            out = llama.forward_chunk(cfg, params, toks, positions, pools(), tables, lens,
                                      block_size=bs, with_logits=False,
                                      collect_layers=collect)
            # the target's next-token distribution at every position
            logp = torch.log_softmax(llama.project_logits(cfg, params, out.hidden), dim=-1)
            top_lp, top_idx = llama.sorted_top_k(logp, label_k)
            del logp
            tokens_all.append(toks)
            hiddens.append(out.hidden.float())
            featss.append(out.features.float() if collect else hiddens[-1])
            top_lps.append(top_lp)
            top_idxs.append(top_idx)
        teacher_rms = torch.sqrt(torch.mean(torch.square(torch.stack(hiddens))))

    if init_draft is None:
        init_draft = init_draft_params(cfg, generator,
                                       num_feature_layers=len(collect) if collect else 1)
    dp = {k: v.detach().to(device=dev, dtype=torch.float32).clone()
          for k, v in init_draft.items()}
    dp["norm"] = dp["norm"] * teacher_rms
    # optax.adam(lr): scale_by_adam (b1, b2, eps, eps_root = 0), then -lr
    b1, b2, eps = 0.9, 0.999, 1e-8
    mu = {k: torch.zeros_like(v) for k, v in dp.items()}
    nu = {k: torch.zeros_like(v) for k, v in dp.items()}
    names = sorted(dp)
    losses = []
    with torch.enable_grad():
        for step in range(steps):
            i = step % num_batches
            leaves = [dp[k].requires_grad_(True) for k in names]
            toks, hidden = tokens_all[i], hiddens[i]
            emb_next = llama.embed_tokens(params, toks[:, 1:], cfg).float()
            pred = draft_apply(cfg, dict(zip(names, leaves)), featss[i][:, :-1], emb_next)
            mse = torch.mean(torch.square(pred - hidden[:, 1:]))
            pred_logp = torch.log_softmax(llama.project_logits(cfg, params, pred), dim=-1)
            sel = torch.gather(pred_logp, -1, top_idxs[i][:, 1:])
            ce = -torch.mean(torch.sum(torch.exp(top_lps[i][:, 1:]) * sel, dim=-1))
            loss = mse + ce_weight * ce
            grads = torch.autograd.grad(loss, leaves)
            losses.append(loss.detach())
            count = step + 1
            with torch.no_grad():
                for k, g in zip(names, grads):
                    mu[k] = (1 - b1) * g + b1 * mu[k]
                    nu[k] = (1 - b2) * (g * g) + b2 * nu[k]
                    mu_hat = mu[k] / (1 - b1 ** count)
                    nu_hat = nu[k] / (1 - b2 ** count)
                    dp[k] = dp[k].detach() + (-lr) * (mu_hat / (torch.sqrt(nu_hat) + eps))
    out_dtype = llama.torch_dtype(cfg.dtype)
    return ({k: v.detach().to(out_dtype) for k, v in dp.items()},
            torch.stack(losses).cpu() if losses else torch.zeros(0))


def init_medusa_params(
    cfg: ModelConfig, generator: torch.Generator, num_heads: int = 4,
    dtype: Any = None, device: Any = None,
) -> Dict[str, torch.Tensor]:
    """Medusa alternative: K residual projections of the last hidden, one
    per lookahead distance; shares the LM head."""
    dtype = llama.torch_dtype(dtype or cfg.dtype)
    device = torch.device(device) if device is not None else generator.device
    h = cfg.hidden_size
    w = torch.randn((num_heads, h, h), generator=generator, device=device,
                    dtype=torch.float32)
    return {"w": (w * h ** -0.5).to(dtype)}


def medusa_logits(
    cfg: ModelConfig, params: llama.Params, mp: Dict[str, torch.Tensor],
    hidden: torch.Tensor,
) -> torch.Tensor:
    """hidden [B, H] → [B, K, V] logits for +1..+K lookahead."""
    proj = torch.einsum("bh,khg->bkg", hidden.float(), mp["w"].float())
    proj = proj + hidden.float()[:, None, :]
    head = params["lm_head"] if "lm_head" in params else params["embedding"]
    return torch.einsum("bkh,vh->bkv", proj, head.float())


# ---------------------------------------------------------------------------
# A round's emission (shared by the engine's rounds and the tree decoder)
# ---------------------------------------------------------------------------


def ordered_emission(drafts: torch.Tensor, n_acc: torch.Tensor, bonus: torch.Tensor,
                     live: torch.Tensor) -> torch.Tensor:
    """A round's emission record [B, D+1]: the ``n_acc`` accepted drafts
    (``drafts`` [B, D], in order), then the target's ``bonus`` token; -1
    pads the rest and every row outside ``live``."""
    j = torch.arange(drafts.shape[1] + 1, dtype=torch.int32, device=drafts.device)[None, :]
    pad = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
    minus1 = torch.full_like(pad, -1)
    out = torch.where(j < n_acc[:, None], pad,
                      torch.where(j == n_acc[:, None], bonus[:, None], minus1))
    return torch.where(live[:, None], out, minus1)


def mask_emission(emitted: torch.Tensor, stops: torch.Tensor, n_emit: torch.Tensor,
                  budgets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The device's view of a round's emission record (it gates later
    rounds; the host replays the record itself): tokens before the first
    stop id count until each row's budget. → (emitted counts after the
    round, rows that hit a stop)."""
    is_stop = (emitted[:, :, None] == stops[:, None, :]).any(-1) & (emitted >= 0)
    stop_i = is_stop.to(torch.int32)
    pre_stop = (torch.cumsum(stop_i, dim=1) - stop_i) == 0
    emit_j = (emitted >= 0) & pre_stop & ~is_stop
    emit_i = emit_j.to(torch.int32)
    rank = torch.cumsum(emit_i, dim=1) - emit_i
    n_emit = n_emit + (emit_j & (n_emit[:, None] + rank < budgets[:, None])).sum(
        dim=1, dtype=torch.int32)
    return n_emit, (is_stop & pre_stop).any(dim=1)


# ---------------------------------------------------------------------------
# The standalone tree decoder
# ---------------------------------------------------------------------------


@dataclass
class _SpecWave:
    """In-flight speculative wave state (``SpeculativeDecoder.start_wave``),
    so a serving loop can interleave bounded spec dispatches with other
    engine work."""

    requests: List[InferenceRequest]
    seq_ids: List[str]
    start: float
    first_token_time: float
    pendings: np.ndarray
    h_last: Any
    tables: np.ndarray
    prefix_lens: np.ndarray
    cached_counts: List[int]
    emitted: List[List[int]]
    done: List[bool]
    finish: List[Optional[str]]
    stops: List[set]
    stop_pad: np.ndarray
    budgets_full: np.ndarray

    def emit(self, i: int, tok: int) -> None:
        if self.done[i]:
            return
        if tok in self.stops[i]:
            self.done[i] = True
            self.finish[i] = "stop"
            return
        self.emitted[i].append(tok)
        if len(self.emitted[i]) >= self.requests[i].sampling.max_new_tokens:
            self.done[i] = True
            self.finish[i] = "length"

    @property
    def all_done(self) -> bool:
        return all(self.done)


class SpeculativeDecoder:
    """Greedy speculative generation over its own paged KV pool.

    Batched: every sequence of a wave drafts/verifies the same tree shape
    each round; per-sequence accept lengths differ freely."""

    def __init__(
        self,
        model_cfg: ModelConfig | str,
        params: Optional[llama.Params] = None,
        draft_params: Optional[Dict[str, torch.Tensor]] = None,
        spec_cfg: Optional[SpeculativeConfig] = None,
        max_batch_size: int = 4,
        max_seq_len: int = 1024,
        block_size: int = 16,
        num_blocks: Optional[int] = None,
        seed: int = 0,
        eos_token_id: Optional[int] = None,
        prefill_buckets: Tuple[int, ...] = (16, 32, 64, 128, 256, 512, 1024),
        kv_cache_dtype: Optional[str] = None,
        device: Any = "cuda",
    ) -> None:
        """``params``: the target's weights on ``device`` (shared with a
        ``TorchEngine``; random init from ``seed`` when absent).
        ``kv_cache_dtype``: ``"int8"`` stores the pools quantized with
        compact per-(page, token) scale pools; path compaction moves code
        and scale rows as a pair. Sliding-window models speculate at any
        depth: the tree mask windows in-chunk visibility by semantic
        position."""
        from distributed_gpu_inference_torch.runtime.engine import resolve_device

        self.device = resolve_device(device)
        self.model_cfg = (
            get_model_config(model_cfg) if isinstance(model_cfg, str) else model_cfg
        )
        self.spec_cfg = spec_cfg or SpeculativeConfig()
        if kv_cache_dtype not in (None, "int8"):
            raise ValueError(
                f"SpeculativeDecoder kv_cache_dtype={kv_cache_dtype!r}: "
                "only int8 (or None = model dtype) is wired"
            )
        self.kv_dtype = torch.int8 if kv_cache_dtype == "int8" else None
        self.block_size = block_size
        self.max_batch_size = max_batch_size
        self.max_seq_len = max_seq_len
        self.max_blocks_per_seq = -(-max_seq_len // block_size)
        self.spec_cfg.validate_blocks(self.max_blocks_per_seq, block_size)
        self.num_blocks = num_blocks or int(
            max_batch_size * self.max_blocks_per_seq * 1.5
        ) + 1
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = llama.init_params(self.model_cfg, gen, device=self.device)
        self.params = params
        self._collect = (
            tuple(self.spec_cfg.feature_layers)
            if self.spec_cfg.feature_layers else None
        )
        if draft_params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed + 1)
            draft_params = init_draft_params(
                self.model_cfg, gen,
                num_feature_layers=len(self._collect) if self._collect else 1,
            )
        self.draft_params = draft_params
        self.kv = llama.init_kv_pools(
            self.model_cfg, self.num_blocks, block_size, dtype=self.kv_dtype,
            device=self.device,
        )
        self.manager = PagedKVCacheManager(self.num_blocks, block_size)
        self.eos_token_id = eos_token_id
        self.prefill_buckets = tuple(sorted(prefill_buckets))
        self._widths = tuple(self.spec_cfg.widths)
        self.accept_rate_ema = 0.5
        self.stats: Dict[str, Any] = {
            "steps": 0, "drafted": 0, "accepted": 0, "emitted": 0,
            "depth_changes": 0,
        }

    # ------------------------------------------------------------- helpers

    def _tensor(self, arr: Any, dtype: torch.dtype = torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr), dtype=dtype, device=self.device)

    def _apply_copies(self) -> None:
        """Copy-on-write page copies the manager queued (codes and int8
        scales move together)."""
        ops = self.manager.take_pending_ops()
        if not ops.copies:
            return
        src = torch.tensor([s for s, _ in ops.copies], dtype=torch.long,
                           device=self.device)
        dst = torch.tensor([d for _, d in ops.copies], dtype=torch.long,
                           device=self.device)
        for pool in self.kv.values():
            pool[:, dst] = pool[:, src]

    def _round(self, widths: Tuple[int, ...], pending: torch.Tensor,
               h_last: torch.Tensor, prefix_lens: torch.Tensor,
               tables: torch.Tensor, active: torch.Tensor):
        """One draft→verify→accept→compact round over the wave (pools
        updated in place) → (accepted path tokens [B, dmax] (-1 pads),
        accept counts [B], bonus tokens [B], next draft input [B, ·])."""
        topo = TreeTopology(widths)
        cfg, dp, params = self.model_cfg, self.draft_params, self.params
        dev = self.device
        parents = torch.as_tensor(topo.parents, dtype=torch.long, device=dev)
        depths = torch.as_tensor(topo.depths, dtype=torch.long, device=dev)
        tree_mask = torch.as_tensor(topo.ancestor_mask, device=dev)
        n, dmax = topo.num_nodes, topo.max_depth
        b = pending.shape[0]
        rows = torch.arange(b, device=dev)

        # ---- draft: grow the tree level by level
        tokens = torch.zeros((b, n), dtype=torch.int32, device=dev)
        tokens[:, 0] = pending
        frontier_h = draft_apply(cfg, dp, h_last,
                                 llama.embed_tokens(params, pending, cfg))[:, None, :]
        for li, w in enumerate(widths):
            # draft logits go through project_logits (final norm + head),
            # the readout the draft head is trained against
            logits = llama.project_logits(cfg, params, frontier_h)
            cand = torch.topk(logits, w, dim=-1).indices.to(torch.int32)  # [B, F, w]
            start, end = topo.level_slices[li]
            tokens[:, start:end] = cand.reshape(b, -1)
            child_emb = llama.embed_tokens(params, cand, cfg)          # [B, F, w, H]
            parent_h = frontier_h[:, :, None, :].expand(child_emb.shape)
            frontier_h = draft_apply(cfg, dp, parent_h, child_emb).reshape(
                b, -1, cfg.hidden_size)

        # ---- verify: one target pass over the tree. Finished rows write
        # no KV (their tables may not cover the tree range): position -1
        node = torch.arange(n, dtype=torch.int32, device=dev)
        rope_pos = prefix_lens[:, None] + depths.to(torch.int32)[None, :]
        cache_pos = prefix_lens[:, None] + node[None, :]
        cache_pos = torch.where(active[:, None], cache_pos, torch.full_like(cache_pos, -1))
        out = llama.forward_tree_chunk(
            cfg, params, tokens, rope_pos, cache_pos, self.kv, tables,
            prefix_lens, tree_mask, block_size=self.block_size,
            collect_layers=self._collect,
        )
        target_pred = torch.argmax(out.logits, dim=-1).to(torch.int32)   # [B, N]

        # ---- acceptance: greedy match down the tree
        accept = torch.zeros((b, n), dtype=torch.bool, device=dev)
        accept[:, 0] = True
        for i in range(1, n):
            p = int(topo.parents[i])
            accept[:, i] = accept[:, p] & (tokens[:, i] == target_pred[:, p])
        # deepest accepted node, ties → lowest index
        score = torch.where(accept, depths[None, :] * (n + 1) - node.long()[None, :],
                            torch.full_like(accept, -1, dtype=torch.long))
        best = torch.argmax(score, dim=-1)                                 # [B]
        n_accept = depths[best].to(torch.int32)                            # [B]

        # ---- path extraction (walk parents; dmax iterations)
        path = torch.full((b, dmax), n, dtype=torch.long, device=dev)     # n = sentinel
        cur = best
        for _ in range(dmax):
            d = depths[cur]
            on = d >= 1
            path[rows[on], d[on] - 1] = cur[on]
            cur = torch.where(d > 1, parents[cur], cur)
        path_valid = path < n
        safe_path = torch.where(path_valid, path, torch.zeros_like(path))
        accepted = torch.where(path_valid, torch.gather(tokens, 1, safe_path),
                               torch.full_like(safe_path, -1, dtype=torch.int32))
        bonus = target_pred[rows, best]
        src = out.features if self._collect else out.hidden
        new_h = src[rows, best]

        # ---- KV compaction: move accepted nodes' rows to depth order
        live = path_valid & active[:, None]
        base = prefix_lens.long()[:, None]
        src_pos = torch.where(live, base + path, torch.full_like(path, -1))
        dst_pos = torch.where(live, base + 1 + torch.arange(dmax, device=dev)[None, :],
                              torch.full_like(path, -1))
        _move_rows(self.kv["k"], tables, src_pos, dst_pos, self.block_size)
        _move_rows(self.kv["v"], tables, src_pos, dst_pos, self.block_size)
        # int8 pools: a code row without its scale is garbage — move both
        for sk in ("k_scale", "v_scale"):
            if sk in self.kv:
                _move_scale_rows(self.kv[sk], tables, src_pos, dst_pos, self.block_size)
        return accepted, n_accept, bonus, new_h

    def _rounds(self, widths: Tuple[int, ...], rounds: int, pendings: np.ndarray,
                h_last: torch.Tensor, prefix_lens: np.ndarray, tables: np.ndarray,
                done0: np.ndarray, budgets: np.ndarray, stop_ids: np.ndarray):
        """Up to ``rounds`` rounds with the per-row state on the device —
        the JAX decoder's scan body, stopping once every row is done. →
        (pendings, h_last, prefix lens, done) after the rounds and the
        per-round records (pending-in, accepted path, accept counts, bonus,
        active) as numpy [R, B, ...]."""
        n = TreeTopology(widths).num_nodes
        max_ctx = min(self.max_seq_len, self.max_blocks_per_seq * self.block_size)
        pending = self._tensor(pendings)
        prefix = self._tensor(prefix_lens)
        tables_t = self._tensor(tables)
        done = self._tensor(done0, torch.bool)
        budgets_t = self._tensor(budgets)
        stops = self._tensor(stop_ids)
        n_emit = torch.zeros_like(prefix)
        recs = []
        for _ in range(rounds):
            # a row whose next tree cannot fit below the context capacity
            # freezes here (the host labels it "length" after the dispatch)
            fits = prefix + n + 1 <= max_ctx
            active = (~done) & fits
            acc, n_acc, bonus, new_h = self._round(
                widths, pending, h_last, prefix, tables_t, active)
            n_emit, stop_hit = mask_emission(ordered_emission(acc, n_acc, bonus, active),
                                             stops, n_emit, budgets_t)
            recs.append((pending, acc, n_acc, bonus, active))
            done = done | (~fits) | (active & (stop_hit | (n_emit >= budgets_t)))
            pending = torch.where(active, bonus, pending)
            h_last = torch.where(active[:, None], new_h, h_last)
            prefix = torch.where(active, prefix + 1 + n_acc, prefix)
            if bool(done.all()):
                break
        recs_np = tuple(torch.stack(r).cpu().numpy() for r in zip(*recs))
        return (pending.cpu().numpy(), h_last, prefix.cpu().numpy(),
                done.cpu().numpy()), recs_np

    # ------------------------------------------------------------- generation

    def generate(self, requests: Sequence[InferenceRequest]) -> List[InferenceResponse]:
        """Greedy speculative batch generation (waves of ≤ max_batch_size).
        Only greedy sampling (the verify pass is an argmax match): sampled
        requests are rejected rather than silently decoded greedily."""
        for r in requests:
            if r.sampling.temperature and r.sampling.temperature > 0.0:
                raise ValueError(
                    "SpeculativeDecoder is greedy-only: request "
                    f"{r.request_id} has temperature={r.sampling.temperature}; "
                    "route sampled requests to TorchEngine"
                )
        out: List[InferenceResponse] = []
        for i in range(0, len(requests), self.max_batch_size):
            out.extend(self._generate_wave(requests[i: i + self.max_batch_size]))
        return out

    def _prefill(self, req: InferenceRequest, seq_id: str) -> Tuple[int, torch.Tensor, int]:
        token_ids = req.prompt_token_ids or []
        if not token_ids:
            raise ValueError("request has no prompt_token_ids")
        _, cached = self.manager.allocate_sequence(seq_id, token_ids)
        self._apply_copies()
        table = self.manager.block_table_for(seq_id, self.max_blocks_per_seq)
        fresh = token_ids[cached:]
        n = len(fresh)
        # bucket-padded as the JAX decoder's prefill shapes are
        bucket = next((bkt for bkt in self.prefill_buckets if bkt >= n), n)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :n] = fresh
        pos = np.full((1, bucket), -1, np.int32)
        pos[0, :n] = np.arange(cached, cached + n)
        out = llama.forward_chunk(
            self.model_cfg, self.params, self._tensor(toks), self._tensor(pos),
            self.kv, self._tensor(table[None]), self._tensor([len(token_ids)]),
            block_size=self.block_size, last_only=True,
            collect_layers=self._collect,
        )
        src = out.features if self._collect else out.hidden
        last_idx = max(n - 1, 0)
        pending = int(torch.argmax(out.logits[0, 0]))
        return pending, src[0, last_idx], cached

    def start_wave(self, requests: Sequence[InferenceRequest]) -> "_SpecWave":
        """Prefill a wave (≤ max_batch_size greedy requests) and return its
        state. Drive it with :meth:`advance_wave` (bounded work per call)
        and collect it with :meth:`finish_wave`."""
        requests = list(requests)
        if not requests or len(requests) > self.max_batch_size:
            raise ValueError(
                f"wave of {len(requests)} requests (max {self.max_batch_size})"
            )
        b = len(requests)
        seq_ids = [r.session_id or uuid.uuid4().hex for r in requests]
        start = time.time()
        pendings = np.zeros((b,), np.int32)
        h_lasts = []
        cached_counts = []
        tables = np.zeros((b, self.max_blocks_per_seq), np.int32)
        prefix_lens = np.zeros((b,), np.int32)
        try:
            for i, (r, sid) in enumerate(zip(requests, seq_ids)):
                pending, h_last, cached = self._prefill(r, sid)
                pendings[i] = pending
                h_lasts.append(h_last)
                cached_counts.append(cached)
                prefix_lens[i] = len(r.prompt_token_ids or [])
                tables[i] = self.manager.block_table_for(
                    sid, self.max_blocks_per_seq
                )
        except Exception:
            # a failed prefill must not strand the rows already allocated
            for sid in seq_ids:
                if sid in self.manager.seq_blocks:
                    self.manager.free_sequence(sid, cache=False)
            raise
        first_token_time = time.time()
        stops = [set(r.sampling.stop_token_ids) |
                 ({self.eos_token_id} if self.eos_token_id is not None else set())
                 for r in requests]
        # device stop-id table (pad -1 never matches: ordered tokens are >= 0)
        max_stops = max(1, max(len(s) for s in stops) if stops else 1)
        stop_pad = np.full((b, max_stops), -1, np.int32)
        for i, s in enumerate(stops):
            for si, tok in enumerate(sorted(s)):
                stop_pad[i, si] = tok
        wave = _SpecWave(
            requests=requests, seq_ids=seq_ids, start=start,
            first_token_time=first_token_time,
            pendings=pendings, h_last=torch.stack(h_lasts), tables=tables,
            prefix_lens=prefix_lens, cached_counts=cached_counts,
            emitted=[[] for _ in range(b)], done=[False] * b,
            finish=[None] * b, stops=stops, stop_pad=stop_pad,
            budgets_full=np.asarray(
                [r.sampling.max_new_tokens for r in requests], np.int32
            ),
        )
        # the prefill-sampled token is the first generated token
        for i in range(b):
            wave.emit(i, int(pendings[i]))
        return wave

    def advance_wave(self, wave: "_SpecWave") -> bool:
        """Run up to ``spec_cfg.rounds_per_dispatch`` tree rounds for the
        wave; True when every sequence finished."""
        b = len(wave.requests)
        seq_ids, emitted, done, finish = wave.seq_ids, wave.emitted, wave.done, wave.finish
        emit, prefix_lens, tables = wave.emit, wave.prefix_lens, wave.tables
        budgets_full = wave.budgets_full
        max_ctx = min(self.max_seq_len, self.max_blocks_per_seq * self.block_size)
        if all(done):
            return True
        widths = self._widths
        topo = TreeTopology(widths)
        topo_n, dmax = topo.num_nodes, topo.max_depth
        # rows whose next tree cannot fit finish with "length" (and must
        # not reserve blocks)
        for i in range(b):
            if not done[i] and int(prefix_lens[i]) + topo_n + 1 > max_ctx:
                done[i] = True
                finish[i] = "length"
        active_rows = [i for i in range(b) if not done[i]]
        if not active_rows:
            return True
        # rounds this call: capped by the largest remaining budget (each
        # active round emits >= 1 token), bucketed to a power of two
        max_remaining = max(int(budgets_full[i]) - len(emitted[i]) for i in active_rows)
        rounds = max(1, min(self.spec_cfg.rounds_per_dispatch, max_remaining))
        rounds = 1 << (rounds.bit_length() - 1)

        def blocks_needed(n_rounds: int) -> int:
            total = 0
            for i in active_rows:
                cur = len(self.manager.seq_tokens[seq_ids[i]])
                have = len(self.manager.seq_blocks[seq_ids[i]])
                t = min((n_rounds - 1) * (dmax + 1) + topo_n + 1,
                        max_ctx - int(prefix_lens[i]))
                total += max(0, -(-(cur + t) // self.block_size) - have)
            return total

        # shrink the dispatch rather than evict the prefix cache to
        # pre-book blocks most accept rates never use
        while rounds > 1 and blocks_needed(rounds) > self.manager.num_reclaimable:
            rounds >>= 1
        for i in active_rows:
            # worst-case growth: (rounds-1) committed paths of dmax+1 plus
            # the final round's tree
            need = (rounds - 1) * (dmax + 1) + topo_n + 1
            need = min(need, max_ctx - int(prefix_lens[i]))
            self.manager.reserve_tokens(seq_ids[i], need)
            tables[i] = self.manager.block_table_for(seq_ids[i], self.max_blocks_per_seq)
        self._apply_copies()
        budgets_rem = np.asarray(
            [int(budgets_full[i]) - len(emitted[i]) for i in range(b)], np.int32)
        (pend, h_last, prefix, done_dev), recs = self._rounds(
            widths, rounds, wave.pendings, wave.h_last, prefix_lens, tables,
            np.asarray(done), budgets_rem, wave.stop_pad)
        rec_pend, rec_acc, rec_nacc, rec_bonus, rec_active = recs
        # ---- host replay: commits + emission exactly as the per-round
        # loop would have done them
        for r in range(rec_active.shape[0]):
            act = rec_active[r]
            if not act.any():
                break
            self.stats["steps"] += 1
            for i in range(b):
                if not act[i]:
                    continue
                self.manager.commit_tokens(seq_ids[i], [int(rec_pend[r, i])])
                for d in range(int(rec_nacc[r, i])):
                    tok = int(rec_acc[r, i, d])
                    self.manager.commit_tokens(seq_ids[i], [tok])
                    emit(i, tok)
                    if done[i]:
                        break
                if not done[i]:
                    emit(i, int(rec_bonus[r, i]))
                self.stats["drafted"] += topo_n - 1
                self.stats["accepted"] += int(rec_nacc[r, i])
                self.stats["emitted"] += int(rec_nacc[r, i]) + 1
                self.stats["row_steps"] = self.stats.get("row_steps", 0) + 1
            # adapt on rows active THIS round; ema replayed per round
            live_rate = float(rec_nacc[r][act].mean()) / max(1, dmax)
            self.accept_rate_ema = (
                self.spec_cfg.ema * self.accept_rate_ema
                + (1 - self.spec_cfg.ema) * live_rate
            )
        wave.pendings = pend
        wave.prefix_lens = prefix
        wave.h_last = h_last
        # rows the device froze for capacity but the host didn't finish
        # otherwise: label them now so the loop terminates
        for i in range(b):
            if done_dev[i] and not done[i]:
                done[i] = True
                finish[i] = "length"
        self._maybe_adapt()
        return all(done)

    def finish_wave(self, wave: "_SpecWave") -> List[InferenceResponse]:
        """Free the wave's sequences (prefix-cached) and build responses."""
        responses = []
        now = time.time()
        for i, (r, sid) in enumerate(zip(wave.requests, wave.seq_ids)):
            self.manager.free_sequence(sid, cache=True)
            toks = wave.emitted[i][: r.sampling.max_new_tokens]
            responses.append(InferenceResponse(
                request_id=r.request_id,
                token_ids=toks,
                finish_reason=wave.finish[i] or "length",
                prompt_tokens=len(r.prompt_token_ids or []),
                completion_tokens=len(toks),
                cached_tokens=wave.cached_counts[i],
                ttft_ms=(wave.first_token_time - wave.start) * 1000.0,
                e2e_ms=(now - wave.start) * 1000.0,
            ))
        return responses

    def abort_wave(self, wave: "_SpecWave") -> None:
        """Release a wave's sequences without caching (serving-loop error
        recovery)."""
        for sid in wave.seq_ids:
            if sid in self.manager.seq_blocks:
                self.manager.free_sequence(sid, cache=False)

    def _generate_wave(self, requests: Sequence[InferenceRequest]) -> List[InferenceResponse]:
        wave = self.start_wave(requests)
        while not self.advance_wave(wave):
            pass
        return self.finish_wave(wave)

    def worst_case_tree_nodes(self) -> int:
        """Upper bound on the verify-tree size over adaptive depth growth —
        what an admission policy must budget per round on top of the
        generation itself."""
        widths = tuple(self._widths)
        if self.spec_cfg.adaptive:
            widths = widths + (1,) * max(0, self.spec_cfg.max_depth - len(widths))
        return TreeTopology(widths).num_nodes

    def _maybe_adapt(self) -> None:
        """Shrink the tree when acceptance is poor, grow it when high."""
        if not self.spec_cfg.adaptive:
            return
        depth = len(self._widths)
        if (self.accept_rate_ema < self.spec_cfg.min_accept_rate
                and depth > self.spec_cfg.min_depth):
            self._widths = self._widths[:-1]
            self.stats["depth_changes"] += 1
        elif (self.accept_rate_ema > self.spec_cfg.grow_accept_rate
                and depth < self.spec_cfg.max_depth):
            self._widths = self._widths + (1,)
            self.stats["depth_changes"] += 1

    def get_stats(self) -> Dict[str, Any]:
        out = dict(self.stats)
        # path-level acceptance: accepted tokens per step per sequence
        # over the max draft depth
        out["accept_rate_ema"] = self.accept_rate_ema
        if out["steps"]:
            out["tokens_per_step_batch"] = out["emitted"] / out["steps"]
            rows = max(self.stats.get("row_steps", 0), 1)
            out["tokens_per_step"] = out["emitted"] / rows
        out["current_widths"] = list(self._widths)
        return out


def _phys_slot(block_tables: torch.Tensor, pos: torch.Tensor, block_size: int):
    """(physical page, slot, valid) of token positions [B, P] (-1 invalid)."""
    valid = pos >= 0
    safe = pos.clamp(min=0).long()
    phys = torch.gather(block_tables.long(), 1, safe // block_size)
    return phys, safe % block_size, valid


def _move_rows(
    pool: torch.Tensor,          # [L, N, Hkv, Bk, D] — updated IN PLACE
    block_tables: torch.Tensor,  # [B, M]
    src_pos: torch.Tensor,       # [B, P] token positions (-1 invalid)
    dst_pos: torch.Tensor,       # [B, P]
    block_size: int,
) -> torch.Tensor:
    """Copy KV rows between token positions (all layers), dropping pairs
    where either position is invalid — the page compaction after tree
    acceptance. Every row is read before any is written."""
    sphys, sslot, svalid = _phys_slot(block_tables, src_pos, block_size)
    dphys, dslot, dvalid = _phys_slot(block_tables, dst_pos, block_size)
    keep = (svalid & dvalid).reshape(-1)
    rows = pool[:, sphys.reshape(-1)[keep], :, sslot.reshape(-1)[keep]]   # [T, L, Hkv, D]
    pool[:, dphys.reshape(-1)[keep], :, dslot.reshape(-1)[keep]] = rows
    return pool


def _move_scale_rows(
    pool: torch.Tensor,          # [L, N, Bk] bf16 scale pool (int8 KV) — IN PLACE
    block_tables: torch.Tensor,  # [B, M]
    src_pos: torch.Tensor,       # [B, P] token positions (-1 invalid)
    dst_pos: torch.Tensor,       # [B, P]
    block_size: int,
) -> torch.Tensor:
    """Scale-pool twin of :func:`_move_rows` over the port's compact
    scales (one per page and token): each code row's scale moves with it."""
    sphys, sslot, svalid = _phys_slot(block_tables, src_pos, block_size)
    dphys, dslot, dvalid = _phys_slot(block_tables, dst_pos, block_size)
    keep = (svalid & dvalid).reshape(-1)
    rows = pool[:, sphys.reshape(-1)[keep], sslot.reshape(-1)[keep]]     # [L, T]
    pool[:, dphys.reshape(-1)[keep], dslot.reshape(-1)[keep]] = rows
    return pool
