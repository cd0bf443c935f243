"""Stable machine fingerprint for worker identity.

The port of ``distributed_gpu_inference_tpu/worker/machine_id.py``: the MAC
address, ``/etc/machine-id`` and the accelerator's identity combine into a
stable id, persisted so re-registrations keep the same identity. The
accelerator component comes from ``torch.cuda`` (device names and count)
where the JAX package reads ``jax.devices()``.
"""

from __future__ import annotations

import hashlib
import json
import os
import uuid
from pathlib import Path
from typing import Dict, Optional

from distributed_gpu_inference_torch.runtime.io_guard import atomic_write_text

DEFAULT_STATE_DIR = "~/.dgi_torch"


def _mac_address() -> str:
    return f"{uuid.getnode():012x}"


def _machine_id() -> str:
    for path in ("/etc/machine-id", "/var/lib/dbus/machine-id"):
        try:
            text = Path(path).read_text().strip()
            if text:
                return text
        except OSError:
            continue
    return ""


def _accelerator_identity() -> str:
    """Accelerator component: CUDA device names and count."""
    try:
        import torch

        if not torch.cuda.is_available():
            return "cpu-only"
        n = torch.cuda.device_count()
        names = sorted({torch.cuda.get_device_name(i) for i in range(n)})
        return f"cuda:{','.join(names)}:{n}"
    except Exception:  # noqa: BLE001 — the fingerprint must work without a card
        return "cpu-only"


class MachineFingerprint:
    """Computes and persists a stable fingerprint."""

    def __init__(self, state_dir: str = DEFAULT_STATE_DIR) -> None:
        self._dir = Path(os.path.expanduser(state_dir))
        self._file = self._dir / "machine_fingerprint.json"

    def components(self) -> Dict[str, str]:
        return {
            "mac": _mac_address(),
            "machine_id": _machine_id(),
            "accelerator": _accelerator_identity(),
        }

    def compute(self) -> str:
        blob = json.dumps(self.components(), sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:32]

    def load(self) -> Optional[str]:
        try:
            data = json.loads(self._file.read_text())
            return data.get("fingerprint") or None
        except (OSError, ValueError):
            return None

    def save(self, fingerprint: str) -> None:
        self._dir.mkdir(parents=True, exist_ok=True)
        payload = {"fingerprint": fingerprint, "components": self.components()}
        # atomic temp+fsync+rename: a crash mid-save must leave the OLD
        # fingerprint readable — a torn file would mint a new identity and
        # orphan this worker's server-side state (round 19)
        atomic_write_text(self._file, json.dumps(payload, indent=2))

    def get_or_create(self) -> str:
        """Persisted fingerprint wins (stable across hardware tweaks)."""
        existing = self.load()
        if existing:
            return existing
        fp = self.compute()
        try:
            self.save(fp)
        except OSError:  # read-only fs: still return a usable id
            pass
        return fp
