"""Token sampling: greedy / temperature / top-k / top-p with per-request
randomness.

The JAX package samples inside its jitted graphs with ``jax.random``
(threefry). The port draws its randomness from a ``torch.Generator``
seeded from the slot's key words and the absolute position, so a seeded
request reproduces exactly whichever other requests share its batch — but
the bits differ from the JAX package's threefry draws. Greedy decoding
(temperature <= 0) is an argmax and matches the JAX package exactly.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

_NEG_INF = -1e30
_MASK64 = (1 << 64) - 1


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """[B, V] → [B] int32 argmax (first maximum on ties, like jnp.argmax)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _nucleus_logits(
    logits: torch.Tensor,        # [B, V] float32
    temperature: torch.Tensor,   # [B] float32; <= 0 → greedy
    top_k: torch.Tensor,         # [B] int32; <= 0 → disabled
    top_p: torch.Tensor,         # [B] float32; >= 1 → disabled
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared top-k/top-p masking → (greedy_tok, nucleus_logits).

    One descending sort serves both filters: masking entries below the k-th
    largest value preserves the sorted order, so the top-p pass reuses the
    sorted array with an index mask instead of sorting again."""
    b, v = logits.shape
    logits = logits.float()
    greedy_tok = greedy_tokens(logits)

    temp = torch.clamp(temperature.float(), min=1e-6)[:, None]
    scaled = logits / temp
    sorted_logits = torch.sort(scaled, dim=-1, descending=True).values

    # top-k: threshold at the k-th largest logit (k <= 0 → keep all)
    top_k = top_k.to(torch.int64)
    k = torch.where(top_k <= 0, torch.full_like(top_k, v), torch.clamp(top_k, max=v))
    kth = torch.gather(sorted_logits, 1, (k - 1)[:, None])
    neg = torch.full_like(scaled, _NEG_INF)
    masked = torch.where(scaled >= kth, scaled, neg)

    # top-p over the top-k-masked distribution: sort(masked) desc ==
    # sorted_logits with ranks >= k forced to -inf
    rank = torch.arange(v, device=logits.device)[None, :]
    sorted_masked = torch.where(rank < k[:, None], sorted_logits, neg)
    probs_sorted = torch.softmax(sorted_masked, dim=-1)
    cumprobs = torch.cumsum(probs_sorted, dim=-1)
    p = torch.clamp(top_p.float(), 0.0, 1.0)[:, None]
    # keep tokens whose *preceding* cumulative mass is < p (always >= 1 token)
    keep_sorted = (cumprobs - probs_sorted) < p
    cutoff_count = keep_sorted.to(torch.int64).sum(dim=-1)
    cutoff_val = torch.gather(
        sorted_masked, 1, torch.clamp(cutoff_count - 1, min=0)[:, None]
    )
    nucleus = torch.where(masked >= cutoff_val, masked, neg)
    return greedy_tok, nucleus


def _row_seed(key: Sequence[int], position: int) -> int:
    """One 63-bit generator seed per (slot key, position): a splitmix64
    finalizer over the key words and the position, so neighbouring
    positions of one request draw unrelated streams."""
    x = ((int(key[0]) & 0xFFFFFFFF) << 32 | (int(key[1]) & 0xFFFFFFFF))
    x = (x ^ ((int(position) + 1) * 0x9E3779B97F4A7C15)) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) & 0x7FFFFFFFFFFFFFFF


def sample_tokens_per_slot(
    logits: torch.Tensor,        # [B, V] float32
    slot_keys: np.ndarray,       # [B, 2] uint32 — one key per request
    positions: Sequence[int],    # [B] — folded in so each step differs
    temperature: torch.Tensor,   # [B] float32; <= 0 → greedy
    top_k: torch.Tensor,         # [B] int32; <= 0 → disabled
    top_p: torch.Tensor,         # [B] float32; >= 1 → disabled
) -> torch.Tensor:
    """Per-request randomness: each row samples (Gumbel-max over its
    nucleus logits) from a generator seeded by ITS OWN key and position, so
    a seeded request reproduces regardless of its batch neighbours."""
    greedy_tok, nucleus = _nucleus_logits(logits, temperature, top_k, top_p)
    b, v = nucleus.shape
    pos = [int(x) for x in (positions.tolist() if torch.is_tensor(positions)
                            else positions)]
    u = torch.empty((b, v), dtype=torch.float32, device=logits.device)
    for i in range(b):
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(_row_seed(slot_keys[i], pos[i]))
        u[i].uniform_(1e-20, 1.0, generator=gen)
    gumbel = -torch.log(-torch.log(u))
    sampled = torch.argmax(nucleus + gumbel, dim=-1).to(torch.int32)
    return torch.where(temperature.to(logits.device) <= 0.0, greedy_tok, sampled)
