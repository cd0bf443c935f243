"""Shared full-jitter retry backoff.

One formula for every client retry ladder (worker ``APIClient``, SDK
``InferenceClient``): ``delay ~ U(0, base·2^attempt)``. Full jitter
de-synchronizes a fleet that all lost the server at the same instant —
a deterministic schedule has every client retry in lockstep (thundering
herd on server restart). The optional ``remaining_s`` clamp implements a
per-request retry budget (None = budget exhausted, stop retrying).
"""

from __future__ import annotations

import random
from typing import Optional


def full_jitter_delay(
    base_s: float,
    attempt: int,
    rng: random.Random,
    remaining_s: Optional[float] = None,
) -> Optional[float]:
    """The next backoff delay in seconds, or None when ``remaining_s``
    (the caller's retry budget) is already spent. The caller sleeps and
    charges the returned delay against its budget."""
    if remaining_s is not None and remaining_s <= 0.0:
        return None
    delay = base_s * (2**attempt) * rng.uniform(0.0, 1.0)
    if remaining_s is not None:
        delay = min(delay, remaining_s)
    return delay
