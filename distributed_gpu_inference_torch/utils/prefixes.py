"""Prefix fingerprints — the shared currency of cache-aware routing.

The port's own copy of the worker's half of
``distributed_gpu_inference_tpu/utils/prefixes.py`` (canonical text and
boundary fingerprints): both packages must give the same fingerprints for
the same prompt text.

Workers hold a radix prefix cache keyed by *token* blocks
(``runtime/kv_cache.py``), but the control plane and the SDK are
tokenizer-free: they see prompt text and chat messages only. Routing
therefore trades in **text-space fingerprints**: a rolling hash of the
canonical prompt text, sampled at fixed ``PREFIX_BLOCK_CHARS`` boundaries.
Every layer — SDK (``prefix_hint``/auto), control plane (server-side
fallback at job creation), worker (radix-summary builder) — computes the
SAME boundary fingerprints from the SAME canonicalization, so a request
and a worker's advertised cache can be compared without ever tokenizing
on the control plane.

The mapping text-block → KV-block is approximate (one char ≈ one token
only for the byte tokenizer); that is fine BY DESIGN: summaries are
advisory routing hints, never correctness inputs. A wrong match costs one
re-prefill — exactly what a locality-blind scheduler pays on every
request.

The hash is a polynomial rolling hash mod a 61-bit Mersenne prime —
stable across processes and Python versions (``hash()`` is salted;
hashlib per boundary would cost a full digest per block). It is NOT a
cryptographic commitment: a malicious client can at worst steer its own
request to a warmer worker.
"""

from __future__ import annotations

import os

from typing import Any, List

# one fingerprint boundary every this many canonical-text chars; both ends
# of a comparison MUST use the same value (workers advertise theirs and
# the registry rejects mismatches rather than mis-matching silently)
PREFIX_BLOCK_CHARS = 64


def _max_blocks_default() -> int:
    """Deployment-wide fingerprint depth cap, overridable via the
    ``TPU_PREFIX_MAX_BLOCKS`` env var (read once at import).

    The tradeoff is routing RESOLUTION vs summary cost: at the default 32
    blocks x 64 chars, affinity routing sees at most ~2k canonical chars —
    two 32k prompts sharing a 30k prefix look IDENTICAL to the router past
    depth 2k, so long-context fleets that want the router to distinguish
    deep RAG contexts should raise it (512 blocks ≈ 32k chars). The cost
    is linear everywhere: hashing per request, radix-summary wire size per
    heartbeat, and the control plane's advertised-set memory. Because every
    layer must agree on depth to compare fingerprints, set the SAME value
    on workers, planes, and SDK clients — a deeper client is harmless (the
    extra boundaries just never match) but a deeper worker advertises
    boundaries no request computes.
    """
    raw = os.environ.get("TPU_PREFIX_MAX_BLOCKS")
    if not raw:
        return 32
    try:
        val = int(raw)
    except ValueError:
        return 32
    return max(1, val)


# boundaries computed per prompt — bounds hashing work AND summary bloat
# for pathological prompts; 32 blocks = 2048 chars of routable prefix
# (see ``_max_blocks_default`` for the long-context resolution tradeoff)
MAX_PREFIX_BLOCKS = _max_blocks_default()

_MOD = (1 << 61) - 1          # Mersenne prime 2^61-1
_BASE = 1_000_003


def canonical_prompt_text(prompt_or_messages: Any) -> str:
    """One canonical text for a request's prompt, identical on every layer.

    Chat messages canonicalize to ``role\\x1fcontent`` records joined by
    ``\\x1e`` — NOT the worker's chat template (templates differ per
    tokenizer and the SDK cannot replicate them). What matters for routing
    is only that a conversation extended by one turn canonicalizes to a
    strict superstring of its previous turn, so the shared prefix grows
    monotonically.
    """
    if prompt_or_messages is None:
        return ""
    if isinstance(prompt_or_messages, str):
        return prompt_or_messages
    if isinstance(prompt_or_messages, (list, tuple)):
        parts = []
        for m in prompt_or_messages:
            if isinstance(m, dict):
                parts.append(
                    f"{m.get('role', '')}\x1f{m.get('content', '')}"
                )
            else:
                parts.append(str(m))
        return "\x1e".join(parts)
    return str(prompt_or_messages)


def prefix_fingerprints(text: str,
                        block_chars: int = PREFIX_BLOCK_CHARS,
                        max_blocks: int = MAX_PREFIX_BLOCKS) -> List[str]:
    """Boundary fingerprints of ``text``: entry ``i`` (0-based) is the
    rolling hash of the first ``(i+1) * block_chars`` characters. Only
    FULL blocks fingerprint (partial tails are never shared by the prefix
    cache either). One O(n) pass emits every boundary."""
    if block_chars <= 0:
        raise ValueError(f"block_chars must be positive, got {block_chars}")
    n_blocks = min(len(text) // block_chars, max_blocks)
    if n_blocks <= 0:
        return []
    out: List[str] = []
    h = 0
    data = text[: n_blocks * block_chars].encode("utf-8", "replace")
    # byte boundaries of char blocks (utf-8 multi-byte chars shift them)
    bounds = {
        len(text[: (i + 1) * block_chars].encode("utf-8", "replace")): i
        for i in range(n_blocks)
    }
    for pos, b in enumerate(data, start=1):
        h = (h * _BASE + b) % _MOD
        if pos in bounds:
            out.append(f"{h:016x}")
    return out
