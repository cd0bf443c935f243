"""Privacy / compliance: anonymization, field encryption, retention cleanup.

Behavioral parity with the reference's ``server/app/services/privacy.py``:
- ``Anonymizer``: IP truncation (:94), PII scrubbing in free text (:184),
  stable pseudonyms (:162).
- Fernet field encryption with a PBKDF2-derived key (:194-271) —
  ``cryptography`` is available in this image; gated import keeps the module
  usable without it (encryption methods then raise).
- Retention cleanup of old jobs/usage (:273-395).
- Privacy audit + compliance report (:397-530).
- Enterprise privacy orchestration (store/retrieve/export/delete, :532-812).

The port's copy of ``distributed_gpu_inference_tpu/server/privacy.py``, on the
standard library and the port's own modules.
"""

from __future__ import annotations

import base64
import hashlib
import json
import re
import time
from typing import Any, Dict, List, Optional

from .store import Store

def _load_crypto():
    """Lazy ``cryptography`` import: the module (and every privacy feature
    that doesn't encrypt) must work on images without the optional dep —
    only constructing a :class:`FieldEncryptor` requires it, and the error
    then names the missing capability instead of an ImportError at import
    time (which used to take the whole server module down with it)."""
    try:
        from cryptography.fernet import Fernet
        from cryptography.hazmat.primitives import hashes
        from cryptography.hazmat.primitives.kdf.pbkdf2 import PBKDF2HMAC
    except Exception as exc:  # pragma: no cover - present in full images
        raise RuntimeError(
            "field encryption requires the optional 'cryptography' package "
            f"(pip install cryptography): {exc}"
        ) from exc
    return Fernet, hashes, PBKDF2HMAC


def crypto_available() -> bool:
    try:
        _load_crypto()
        return True
    except RuntimeError:
        return False

_EMAIL_RE = re.compile(r"[\w.+-]+@[\w-]+\.[\w.-]+")
_PHONE_RE = re.compile(r"\+?\d[\d\s().-]{7,}\d")
_IPV4_RE = re.compile(r"\b(?:\d{1,3}\.){3}\d{1,3}\b")
_SSN_RE = re.compile(r"\b\d{3}-\d{2}-\d{4}\b")


class Anonymizer:
    """Stateless PII reduction utilities."""

    def __init__(self, pseudonym_salt: str = "") -> None:
        self._salt = pseudonym_salt

    @staticmethod
    def truncate_ip(ip: Optional[str]) -> Optional[str]:
        """Zero the host octet / trailing groups (reference privacy.py:94)."""
        if not ip:
            return ip
        if ":" in ip:  # ipv6: keep first 3 groups
            groups = ip.split(":")
            return ":".join(groups[:3]) + "::"
        parts = ip.split(".")
        if len(parts) == 4:
            return ".".join(parts[:3]) + ".0"
        return ip

    def pseudonym(self, identity: str) -> str:
        """Stable non-reversible pseudonym (reference :162)."""
        h = hashlib.sha256(f"{self._salt}{identity}".encode()).hexdigest()
        return f"anon-{h[:12]}"

    @staticmethod
    def scrub_text(text: str) -> str:
        """Mask emails / phones / IPs / SSNs in free text (reference :184)."""
        text = _EMAIL_RE.sub("[EMAIL]", text)
        text = _SSN_RE.sub("[SSN]", text)
        text = _IPV4_RE.sub("[IP]", text)
        text = _PHONE_RE.sub("[PHONE]", text)
        return text

    def anonymize_record(self, record: Dict[str, Any]) -> Dict[str, Any]:
        out = dict(record)
        if out.get("client_ip"):
            out["client_ip"] = self.truncate_ip(out["client_ip"])
        for key in ("prompt", "text", "error"):
            if isinstance(out.get(key), str):
                out[key] = self.scrub_text(out[key])
        return out


class FieldEncryptor:
    """Fernet encryption of individual fields, key derived via PBKDF2."""

    def __init__(self, passphrase: str, salt: bytes = b"dgi-tpu-privacy") -> None:
        Fernet, hashes, PBKDF2HMAC = _load_crypto()
        kdf = PBKDF2HMAC(
            algorithm=hashes.SHA256(), length=32, salt=salt, iterations=100_000
        )
        key = base64.urlsafe_b64encode(kdf.derive(passphrase.encode()))
        self._fernet = Fernet(key)

    def encrypt_field(self, value: Any) -> str:
        raw = json.dumps(value).encode()
        return self._fernet.encrypt(raw).decode()

    def decrypt_field(self, token: str) -> Any:
        raw = self._fernet.decrypt(token.encode())
        return json.loads(raw.decode())

    def encrypt_fields(self, record: Dict[str, Any],
                       fields: List[str]) -> Dict[str, Any]:
        out = dict(record)
        for f in fields:
            if f in out and out[f] is not None:
                out[f] = self.encrypt_field(out[f])
        return out

    def decrypt_fields(self, record: Dict[str, Any],
                       fields: List[str]) -> Dict[str, Any]:
        out = dict(record)
        for f in fields:
            if isinstance(out.get(f), str):
                try:
                    out[f] = self.decrypt_field(out[f])
                except Exception:  # noqa: BLE001 — leave non-encrypted values
                    pass
        return out


class RetentionPolicy:
    """Deletes terminal jobs and usage records older than per-enterprise
    retention windows (reference privacy.py:273-395)."""

    def __init__(self, store: Store, default_days: int = 30) -> None:
        self._store = store
        self._default_days = default_days

    async def _retention_days(self, enterprise_id: Optional[str]) -> int:
        if enterprise_id:
            ent = await self._store.get("enterprises", enterprise_id)
            if ent and ent.get("retention_days") is not None:
                return int(ent["retention_days"])
        return self._default_days

    async def cleanup(self, now: Optional[float] = None) -> Dict[str, int]:
        now = time.time() if now is None else now
        cutoff = now - self._default_days * 86400.0
        before_jobs = await self._store.query(
            "SELECT COUNT(*) AS n FROM jobs WHERE completed_at IS NOT NULL "
            "AND completed_at < ?",
            (cutoff,),
        )
        await self._store.execute(
            "DELETE FROM jobs WHERE completed_at IS NOT NULL AND completed_at < ?",
            (cutoff,),
        )
        before_usage = await self._store.query(
            "SELECT COUNT(*) AS n FROM usage_records WHERE created_at < ?",
            (cutoff,),
        )
        await self._store.execute(
            "DELETE FROM usage_records WHERE created_at < ?", (cutoff,)
        )
        return {
            "jobs_deleted": int(before_jobs[0]["n"]),
            "usage_deleted": int(before_usage[0]["n"]),
        }


class EnterprisePrivacyService:
    """Per-enterprise privacy orchestration: anonymize-on-store, encrypted
    fields, export, delete (reference privacy.py:532-812)."""

    ENCRYPTED_FIELDS = ["params", "result"]

    def __init__(self, store: Store, passphrase: Optional[str] = None,
                 pseudonym_salt: str = "") -> None:
        self._store = store
        self.anonymizer = Anonymizer(pseudonym_salt)
        self.retention = RetentionPolicy(store)
        self._encryptor = (
            FieldEncryptor(passphrase)
            if (passphrase and crypto_available()) else None
        )

    async def _settings(self, enterprise_id: Optional[str]) -> Dict[str, Any]:
        if enterprise_id:
            ent = await self._store.get("enterprises", enterprise_id)
            if ent:
                return ent
        return {"allow_logging": 1, "anonymize_data": 0, "encrypt_fields": 0}

    async def prepare_job_record(self, job: Dict[str, Any],
                                 enterprise_id: Optional[str] = None
                                 ) -> Optional[Dict[str, Any]]:
        """Apply the enterprise's privacy settings before persisting."""
        s = await self._settings(enterprise_id)
        if not s.get("allow_logging", 1):
            return None
        out = dict(job)
        if s.get("anonymize_data"):
            out = self.anonymizer.anonymize_record(out)
        if s.get("encrypt_fields") and self._encryptor is not None:
            out = self._encryptor.encrypt_fields(out, self.ENCRYPTED_FIELDS)
        return out

    async def export_enterprise_data(self, enterprise_id: str
                                     ) -> Dict[str, Any]:
        usage = await self._store.query(
            "SELECT * FROM usage_records WHERE enterprise_id=?", (enterprise_id,)
        )
        bills = await self._store.query(
            "SELECT * FROM bills WHERE enterprise_id=?", (enterprise_id,)
        )
        ent = await self._store.get("enterprises", enterprise_id)
        return {"enterprise": ent, "usage_records": usage, "bills": bills}

    async def delete_enterprise_data(self, enterprise_id: str) -> Dict[str, int]:
        usage = await self._store.query(
            "SELECT COUNT(*) AS n FROM usage_records WHERE enterprise_id=?",
            (enterprise_id,),
        )
        await self._store.execute(
            "DELETE FROM usage_records WHERE enterprise_id=?", (enterprise_id,)
        )
        await self._store.execute(
            "DELETE FROM bills WHERE enterprise_id=?", (enterprise_id,)
        )
        await self._store.audit("enterprise_data_deleted", actor=enterprise_id)
        return {"usage_deleted": int(usage[0]["n"])}

    async def compliance_report(self) -> Dict[str, Any]:
        """Summary of privacy posture (reference :397-530)."""
        ents = await self._store.query("SELECT * FROM enterprises")
        jobs = await self._store.query("SELECT COUNT(*) AS n FROM jobs")
        usage = await self._store.query("SELECT COUNT(*) AS n FROM usage_records")
        return {
            "generated_at": time.time(),
            "enterprises": len(ents),
            "with_anonymization": sum(1 for e in ents if e.get("anonymize_data")),
            "with_encryption": sum(1 for e in ents if e.get("encrypt_fields")),
            "logging_disabled": sum(1 for e in ents if not e.get("allow_logging", 1)),
            "stored_jobs": int(jobs[0]["n"]),
            "stored_usage_records": int(usage[0]["n"]),
            "encryption_available": crypto_available(),
        }
