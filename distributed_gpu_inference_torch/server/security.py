"""Token issuance, HMAC request signing, lockout policy, audit events.

Behavioral parity with the reference's ``server/app/services/security.py``:
- ``TokenManager`` (:42-66): urlsafe tokens, salted-sha256 at rest,
  constant-time comparison.
- ``RequestSigner`` (:79-138): HMAC-SHA256 over ``METHOD:PATH:BODY_HASH:TS``
  with a 300 s validity window.
- Lockout policy (:256-271): 5 failures → 15 min lock
  (mirrors ``server/app/api/workers.py:55-94``).

Pure stdlib (hashlib/hmac/secrets) — no external crypto needed here.

The port's copy of ``distributed_gpu_inference_tpu/server/security.py``, on the
standard library and the port's own modules.
"""

from __future__ import annotations

import hashlib
import hmac
import secrets
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

TOKEN_BYTES = 32
SIGNATURE_VALIDITY_S = 300.0
MAX_FAILED_ATTEMPTS = 5
LOCKOUT_SECONDS = 15 * 60.0
TOKEN_TTL_S = 7 * 24 * 3600.0


def generate_token() -> str:
    return secrets.token_urlsafe(TOKEN_BYTES)


def hash_token(token: str, salt: str = "") -> str:
    """Salted SHA-256 digest for at-rest storage (never store raw tokens)."""
    return hashlib.sha256(f"{salt}{token}".encode()).hexdigest()


def verify_token(token: str, stored_hash: str, salt: str = "") -> bool:
    return hmac.compare_digest(hash_token(token, salt), stored_hash)


@dataclass
class TokenBundle:
    """What a successful registration hands back to a worker."""

    auth_token: str
    refresh_token: str
    signing_secret: str
    expires_at: float

    def to_dict(self) -> Dict[str, Any]:
        return {
            "auth_token": self.auth_token,
            "refresh_token": self.refresh_token,
            "signing_secret": self.signing_secret,
            "expires_at": self.expires_at,
        }


class TokenManager:
    """Issues and verifies worker credentials; hashes live in the store."""

    def __init__(self, salt: str = "", token_ttl_s: float = TOKEN_TTL_S) -> None:
        self._salt = salt
        self._ttl = token_ttl_s

    def issue(self, now: Optional[float] = None) -> Tuple[TokenBundle, Dict[str, Any]]:
        """Returns (bundle-for-worker, fields-for-store)."""
        now = time.time() if now is None else now
        bundle = TokenBundle(
            auth_token=generate_token(),
            refresh_token=generate_token(),
            signing_secret=secrets.token_hex(32),
            expires_at=now + self._ttl,
        )
        stored = {
            "auth_token_hash": hash_token(bundle.auth_token, self._salt),
            "refresh_token_hash": hash_token(bundle.refresh_token, self._salt),
            "signing_secret": bundle.signing_secret,
            "token_expires_at": bundle.expires_at,
        }
        return bundle, stored

    def verify(
        self,
        token: str,
        stored_hash: Optional[str],
        expires_at: Optional[float] = None,
        now: Optional[float] = None,
    ) -> bool:
        if not token or not stored_hash:
            return False
        now = time.time() if now is None else now
        if expires_at is not None and now > expires_at:
            return False
        return verify_token(token, stored_hash, self._salt)


class RequestSigner:
    """HMAC-SHA256 request signatures over METHOD:PATH:BODY_HASH:TIMESTAMP."""

    def __init__(self, validity_s: float = SIGNATURE_VALIDITY_S) -> None:
        self._validity = validity_s

    @staticmethod
    def canonical(method: str, path: str, body: bytes, timestamp: str) -> str:
        body_hash = hashlib.sha256(body or b"").hexdigest()
        return f"{method.upper()}:{path}:{body_hash}:{timestamp}"

    def sign(self, secret: str, method: str, path: str, body: bytes,
             timestamp: Optional[str] = None) -> Dict[str, str]:
        ts = timestamp or str(int(time.time()))
        msg = self.canonical(method, path, body, ts)
        sig = hmac.new(secret.encode(), msg.encode(), hashlib.sha256).hexdigest()
        return {"X-Timestamp": ts, "X-Signature": sig}

    def verify(self, secret: str, method: str, path: str, body: bytes,
               timestamp: str, signature: str,
               now: Optional[float] = None) -> bool:
        try:
            ts_val = float(timestamp)
        except (TypeError, ValueError):
            return False
        now = time.time() if now is None else now
        if abs(now - ts_val) > self._validity:
            return False
        msg = self.canonical(method, path, body, timestamp)
        expect = hmac.new(secret.encode(), msg.encode(), hashlib.sha256).hexdigest()
        return hmac.compare_digest(expect, signature or "")


@dataclass
class LockoutState:
    failed_attempts: int = 0
    last_failed: Optional[float] = None
    locked_until: Optional[float] = None


class LockoutPolicy:
    """5 strikes → 15 min lock; success resets (reference workers.py:55-94)."""

    def __init__(self, max_attempts: int = MAX_FAILED_ATTEMPTS,
                 lockout_s: float = LOCKOUT_SECONDS) -> None:
        self.max_attempts = max_attempts
        self.lockout_s = lockout_s

    def is_locked(self, state: LockoutState, now: Optional[float] = None) -> bool:
        now = time.time() if now is None else now
        return state.locked_until is not None and now < state.locked_until

    def record_failure(self, state: LockoutState,
                       now: Optional[float] = None) -> LockoutState:
        now = time.time() if now is None else now
        n = state.failed_attempts + 1
        locked_until = state.locked_until
        if n >= self.max_attempts:
            locked_until = now + self.lockout_s
            n = 0
        return LockoutState(n, now, locked_until)

    def record_success(self, state: LockoutState) -> LockoutState:
        return LockoutState()


@dataclass
class AuditEvent:
    ts: float
    event: str
    actor: Optional[str]
    detail: Dict[str, Any] = field(default_factory=dict)


class AuditLogger:
    """In-memory ring of structured audit events; optionally mirrored to a
    Store's audit_log table by the API layer (reference security.py:287-336)."""

    def __init__(self, capacity: int = 4096) -> None:
        self._events: list[AuditEvent] = []
        self._capacity = capacity

    def log(self, event: str, actor: Optional[str] = None,
            **detail: Any) -> AuditEvent:
        ev = AuditEvent(time.time(), event, actor, detail)
        self._events.append(ev)
        if len(self._events) > self._capacity:
            self._events = self._events[-self._capacity:]
        return ev

    def recent(self, n: int = 100) -> list[AuditEvent]:
        return self._events[-n:]


class SecurityService:
    """Facade bundling token manager + signer + lockout + audit."""

    def __init__(self, salt: str = "") -> None:
        self.tokens = TokenManager(salt)
        self.signer = RequestSigner()
        self.lockout = LockoutPolicy()
        self.audit = AuditLogger()
