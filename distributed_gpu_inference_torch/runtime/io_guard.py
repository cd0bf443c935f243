"""Durable-IO hardening: per-tier circuit breakers and crash-atomic file
writes.

The port's own copy of ``distributed_gpu_inference_tpu/runtime/io_guard.py``.
An optional durable surface (a spill tier, a persisted file) can never fail
a request: failures are counted and fenced, never propagated.

- :class:`IOBreaker` is the closed → open → half-open machine sized for a
  cache tier on the admission path: after ``threshold`` consecutive
  failures the tier trips OPEN and is skipped (no per-request timeout tax
  while the device browns out); after a jittered ``open_s`` window one
  probe is let through (half-open) — success closes the breaker, failure
  re-opens it with fresh jitter.
- :func:`atomic_write_bytes` / :func:`atomic_write_text`: temp + fsync +
  rename, so a crash or a full disk mid-write leaves the previous file
  intact. The worker writes its issued credentials and its machine
  fingerprint through them; the ``io.file.write`` seam lets a fault plan
  exercise the cleanup path.

Environment (read when a breaker set is built, the JAX package's names):

=============================  =============================================
``DGI_IO_BREAKER_THRESHOLD``   consecutive failures before tripping (3)
``DGI_IO_BREAKER_OPEN_S``      base open window seconds before a probe (10)
``DGI_IO_BREAKER_JITTER``      max fractional jitter on the window (0.5)
``DGI_IO_BREAKER_DISABLE``     "1" disables breakers (every op attempted)
=============================  =============================================
"""

from __future__ import annotations

import os
import random
import time
from pathlib import Path
from typing import Callable, Union

from distributed_gpu_inference_torch.testing import faults as _faults

# gauge state codes (io_breaker_state{tier}): closed is the healthy zero
BREAKER_CLOSED = 0
BREAKER_HALF_OPEN = 1
BREAKER_OPEN = 2

_STATE_NAMES = {BREAKER_CLOSED: "closed", BREAKER_HALF_OPEN: "half_open",
                BREAKER_OPEN: "open"}


def breaker_env_config() -> dict:
    """The environment's breaker geometry, shared by every tier. Malformed
    values fall back to the defaults: a bad variable must not take down the
    worker it configures."""
    def _f(name: str, default: float) -> float:
        try:
            return float(os.environ.get(name, "") or default)
        except ValueError:
            return default

    return {
        "threshold": max(1, int(_f("DGI_IO_BREAKER_THRESHOLD", 3))),
        "open_s": max(0.0, _f("DGI_IO_BREAKER_OPEN_S", 10.0)),
        "jitter": max(0.0, _f("DGI_IO_BREAKER_JITTER", 0.5)),
        "disabled": os.environ.get("DGI_IO_BREAKER_DISABLE", "") == "1",
    }


class IOBreaker:
    """Per-tier circuit breaker: closed → open → half-open → closed.

    Not thread-safe by itself: its caller (the KV manager) runs on the
    engine's one thread. ``clock`` is injectable for virtual time."""

    def __init__(self, name: str, threshold: int = 3, open_s: float = 10.0,
                 jitter: float = 0.5, seed: int = 0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if threshold < 1:
            raise ValueError("threshold must be >= 1")
        self.name = name
        self.threshold = threshold
        self.open_s = open_s
        self.jitter = jitter
        self._clock = clock
        # seeded per breaker: deterministic probe instants in tests, and
        # workers de-synchronize their probes of a recovering backend
        self._rng = random.Random(0x10C4E5 ^ seed ^ hash(name) & 0xFFFF)
        self._failures = 0
        self._state = BREAKER_CLOSED
        self._probe_at = 0.0
        self.trips = 0          # cumulative: rides the heartbeat

    def allow(self) -> bool:
        """May the caller attempt the tier now? OPEN answers False until
        the jittered probe instant, then turns HALF-OPEN and admits one
        probe; HALF-OPEN answers False while that probe is in flight."""
        if self._state == BREAKER_CLOSED:
            return True
        if self._state == BREAKER_OPEN:
            if self._clock() >= self._probe_at:
                self._state = BREAKER_HALF_OPEN
                return True
            return False
        return False

    def record_success(self) -> None:
        self._failures = 0
        self._state = BREAKER_CLOSED

    def record_failure(self) -> None:
        self._failures += 1
        if self._state == BREAKER_HALF_OPEN \
                or self._failures >= self.threshold:
            self._trip()

    def _trip(self) -> None:
        self._state = BREAKER_OPEN
        self.trips += 1
        self._probe_at = self._clock() + self.open_s * (
            1.0 + self.jitter * self._rng.random()
        )

    @property
    def state_code(self) -> int:
        return self._state

    @property
    def state(self) -> str:
        return _STATE_NAMES[self._state]

    @property
    def closed(self) -> bool:
        return self._state == BREAKER_CLOSED


def atomic_write_bytes(path: Union[str, Path], data: bytes) -> None:
    """Write ``data`` to ``path`` atomically: a sibling temp file is
    written and fsynced first, then renamed over the target (os.replace is
    atomic on POSIX within one filesystem). A failure at any point leaves
    the previous file intact; the temp is cleaned up. Raises OSError —
    callers decide whether the write was optional (fingerprint cache) or
    not (issued credentials)."""
    path = Path(path)
    _faults.io_fault("io.file.write", path=str(path))
    tmp = path.with_name(f".{path.name}.tmp.{os.getpid()}")
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            tmp.unlink()
        except OSError:
            pass
        raise


def atomic_write_text(path: Union[str, Path], text: str,
                      encoding: str = "utf-8") -> None:
    atomic_write_bytes(path, text.encode(encoding))
