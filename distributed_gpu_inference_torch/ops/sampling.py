"""Token sampling: greedy / temperature / top-k / top-p with per-request
randomness that reproduces the JAX package's ``jax.random`` draws bit for
bit.

The JAX package samples each slot with
``jax.random.categorical(jax.random.fold_in(key, position), nucleus)``
where ``key`` is the slot's raw threefry key ``[hi, lo]`` (the words of
``PRNGKey(seed)``). That is Gumbel-max: ``argmax(nucleus + gumbel)`` with
``gumbel = -log(-log(uniform(tiny, 1)))`` and the uniforms made from
threefry-2x32 random bits. This module carries the same arithmetic in
torch integer ops (``jax_threefry_partitionable`` layout, JAX's default):

- :func:`threefry2x32` — the 20-round Threefry-2x32 hash;
- :func:`fold_in` — ``threefry2x32(key, (0, data))``;
- :func:`random_bits` — counter ``i`` of a ``[V]`` draw hashes the pair
  ``(i >> 32, i & 0xffffffff)`` and the word is the XOR of both outputs;
- :func:`uniform` / :func:`gumbel` — the mantissa trick of
  ``jax.random.uniform`` and the "low" Gumbel mode of ``jax.random.gumbel``.

torch has little uint32 support, so words travel as int64 tensors masked
to 32 bits. Greedy rows never pay for the noise: bits are drawn only for
rows whose temperature is above 0.
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple

import numpy as np
import torch

_NEG_INF = -1e30
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = float(np.finfo(np.float32).tiny)


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


# --------------------------------------------------------------------------
# threefry-2x32, as jax._src.prng computes it
# --------------------------------------------------------------------------


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1: Any, k2: Any, x1: Any, x2: Any) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of counter pairs ``(x1, x2)`` under key
    ``(k1, k2)``. Every argument is an int64 tensor of 32-bit words (or
    broadcastable to one); returns the two output words, int64."""
    k1 = k1 & _M32
    k2 = k2 & _M32
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & _M32
    b = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + i + 1) & _M32
    return a, b


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` on raw keys: ``key`` [..., 2] and ``data``
    [...] (taken mod 2^32, as JAX's uint32 cast does) → new keys [..., 2]."""
    data = data.to(torch.int64) & _M32
    o1, o2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([o1, o2], dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """32-bit words of ``jax.random.bits(key, (n,))`` for each key of
    ``keys`` [R, 2] → [R, n] int64 (partitionable threefry layout)."""
    counts = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    b1, b2 = threefry2x32(keys[:, 0:1], keys[:, 1:2], counts >> 32, counts & _M32)
    return b1 ^ b2


def uniform(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, tiny, 1.0)`` per key (the
    draw of the Gumbel noise): the top 23 bits become the mantissa of a
    float in [1, 2), minus 1, scaled into [tiny, 1) and floored at tiny."""
    bits = random_bits(keys, n)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(_F32_TINY, dtype=torch.float32, device=keys.device)
    span = torch.tensor(1.0, dtype=torch.float32, device=keys.device) - lo
    return torch.maximum(lo, f * span + lo)


# f32 constants of XLA's CPU logarithm (Cephes' logf, as XLA emits it)
_LOG_C = dict(
    sqrthf=0.707106781186547524, p0=7.0376836292e-2, p1=-1.1514610310e-1,
    p2=1.1676998740e-1, p3=-1.2420140846e-1, p4=1.4249322787e-1,
    p5=-1.6668057665e-1, p6=2.0000714765e-1, p7=-2.4999993993e-1,
    p8=3.3333331174e-1, q1=-2.12194440e-4, q2=0.693359375,
)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c as a fused multiply-add would give it in float32: the
    product of two float32 values is exact in float64, so only the sum
    rounds, to float64 and then to float32 (which differs from one rounding
    only when the float64 sum lands exactly on a float32 midpoint)."""
    return (a.double() * b.double() + c.double()).float()


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """Natural log of a float32 tensor with the arithmetic of XLA's CPU
    ``log``: the Cephes polynomial in the order XLA emits it, where the
    x86 backend fuses each multiply feeding an add into one fused
    multiply-add. It matches ``jnp.log`` bit for bit where a library
    logarithm rounds differently in about one value of seven. Non-positive
    inputs give NaN, 0 gives -inf and +inf gives +inf."""
    c = {k: torch.tensor(v, dtype=torch.float32, device=x.device)
         for k, v in _LOG_C.items()}
    one = torch.ones((), dtype=torch.float32, device=x.device)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    xc = torch.clamp_min(x, _F32_TINY)
    bits = xc.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + one
    m = ((bits & 0x807FFFFF) | 0x3F000000).view(torch.float32)
    low = m < c["sqrthf"]
    e = e - torch.where(low, one, zero)
    t = (m - one) + torch.where(low, m, zero)
    t2 = t * t
    t3 = t2 * t
    y = _fma(t, c["p0"], c["p1"])
    y1 = _fma(t, c["p3"], c["p4"])
    y2 = _fma(t, c["p6"], c["p7"])
    y = _fma(y, t, c["p2"])
    y1 = _fma(y1, t, c["p5"])
    y2 = _fma(y2, t, c["p8"])
    y = _fma(y, t3, y1)
    y = _fma(y, t3, y2)
    y = _fma(y, t3, c["q1"] * e)
    r = _fma(-0.5 * one, t2, t) + y
    r = _fma(c["q2"], e, r)
    r = torch.where(x == torch.inf, x, r)
    # subnormal inputs count as zero, as on XLA's CPU
    r = torch.where((x >= 0) & (x < _F32_TINY), torch.full_like(r, -torch.inf), r)
    return torch.where((x < 0) | torch.isnan(x), torch.full_like(r, torch.nan), r)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` in its default "low" mode."""
    return -log_f32(-log_f32(uniform(keys, n)))


def _as_key_tensor(slot_keys: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(slot_keys, dtype=np.uint32).astype(np.int64)
    return torch.from_numpy(arr).to(device)


def sample_tokens_per_slot(
    logits: torch.Tensor,        # [B, V] float32
    slot_keys: np.ndarray,       # [B, 2] uint32 — one raw threefry key per request
    positions: Sequence[int],    # [B] — folded in so each step differs
    temperature: torch.Tensor,   # [B] float32; <= 0 → greedy
    top_k: torch.Tensor,         # [B] int32; <= 0 → disabled
    top_p: torch.Tensor,         # [B] float32; >= 1 → disabled
) -> torch.Tensor:
    """Per-request randomness: each row samples Gumbel-max over its nucleus
    logits with noise from ``fold_in(its key, its position)`` — the JAX
    package's draw, bit for bit — so a seeded request reproduces whatever
    shares its batch and whichever package serves it."""
    greedy_tok, nucleus = _nucleus_logits(logits, temperature, top_k, top_p)
    dev = logits.device
    temperature = temperature.to(dev)
    rows = torch.nonzero(temperature > 0.0).flatten()
    if rows.numel() == 0:
        return greedy_tok
    pos = torch.as_tensor(positions, device=dev).reshape(-1).to(torch.int64)
    keys = fold_in(_as_key_tensor(slot_keys, dev)[rows], pos[rows])
    noise = gumbel(keys, nucleus.shape[1])
    sampled = torch.argmax(nucleus[rows] + noise, dim=-1).to(torch.int32)
    return greedy_tok.index_copy(0, rows, sampled)
