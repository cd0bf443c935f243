"""HTTP client from worker to control plane, on the standard library.

The port of ``distributed_gpu_inference_tpu/worker/api_client.py`` on
``http.client`` (the card's machine has no ``httpx``), with the same routes
and the same behaviour:

- a retry ladder of full-jitter backoff (``utils/backoff.py``) under a
  per-request retry budget: 4xx never retried, 5xx and transport failures
  retried, ``APIError(599)`` when the transport never answered;
- sticky control-plane failover over an endpoint list, health-probed with
  ``GET /health``;
- a bearer token, and HMAC-SHA256 signatures over
  ``METHOD:PATH:sha256(BODY):TIMESTAMP`` of exactly the path and body bytes
  sent (``server/security.py`` ``RequestSigner``, the one canonicalization
  the port's plane verifies with);
- 204 from next-job means "no job";
- the ``worker.api.request`` fault seam (``testing/faults.py``
  ``wrap_http``) around every exchange, probes included, with the JAX
  client's match context (method, path, ``worker`` = ``fault_tag``,
  ``server``).

``http.client`` connections are not thread-safe, and the heartbeat
thread, the poll loop, the job pool and the direct server's handler
threads all call one client: every call opens its own connection, with the
configured socket timeout, and closes it.
"""

from __future__ import annotations

import http.client
import json
import random
import time
from typing import Any, Dict, List, Optional, Sequence, Union
from urllib.parse import urlsplit

from distributed_gpu_inference_torch.server.security import RequestSigner
from distributed_gpu_inference_torch.testing import faults as _faults
from distributed_gpu_inference_torch.utils.backoff import full_jitter_delay

# timeout of the failover /health probe (seconds)
PROBE_TIMEOUT_S = 2.0


class APIError(Exception):
    def __init__(self, status: int, detail: str = "") -> None:
        super().__init__(f"HTTP {status}: {detail}")
        self.status = status
        self.detail = detail


class Response:
    """One answered request: status, body bytes and headers (an
    ``http.client`` header message, case-insensitive ``get``)."""

    def __init__(self, status_code: int, content: bytes,
                 headers: Optional[Any] = None) -> None:
        self.status_code = status_code
        self.content = content
        self.headers = headers if headers is not None else {}

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", errors="replace")

    def json(self) -> Any:
        return json.loads(self.content)


# what a call that never got an answer raises: refused / reset connections
# and socket timeouts (OSError and its subclasses ConnectionError and
# socket.timeout), malformed or cut responses (HTTPException)
TRANSPORT_ERRORS = (OSError, http.client.HTTPException)


class APIClient:
    """Control-plane HTTP client with plane failover.

    ``base_url`` is one URL or a LIST of plane endpoints. With a list, a
    transport failure or 5xx on the active plane rotates to the next
    health-probed peer and retries there without burning a backoff attempt
    — the rotation sticks, so later calls target the surviving plane. The
    server's duplicate-delivery idempotency (terminal completes, epoch-
    fenced checkpoints) makes the cross-plane retry safe."""

    def __init__(
        self,
        base_url: Union[str, Sequence[str]],
        worker_id: Optional[str] = None,
        auth_token: Optional[str] = None,
        refresh_token: Optional[str] = None,
        signing_secret: Optional[str] = None,
        max_retries: int = 3,
        backoff_s: float = 0.5,
        retry_budget_s: float = 15.0,
        timeout_s: float = 30.0,
        rng: Optional[random.Random] = None,
    ) -> None:
        urls = [base_url] if isinstance(base_url, str) else list(base_url)
        if not urls:
            raise ValueError("APIClient needs at least one plane endpoint")
        self.endpoints: List[str] = [u.rstrip("/") for u in urls]
        self._active = 0
        self.worker_id = worker_id
        self.auth_token = auth_token
        self.refresh_token = refresh_token
        self.signing_secret = signing_secret
        self._max_retries = max_retries
        self._backoff_s = backoff_s
        self._retry_budget_s = retry_budget_s
        # full-jitter source; injectable so tests can pin the schedule
        self._rng = rng if rng is not None else random.Random()
        self._signer = RequestSigner()
        self._timeout_s = timeout_s
        # how often this worker changed planes
        self.plane_failovers = 0
        self._closed = False

    @property
    def base_url(self) -> str:
        """The ACTIVE plane endpoint (single-plane: the only one)."""
        return self.endpoints[self._active]

    def close(self) -> None:
        """Every call closes its own connection, so nothing is released;
        a call made after ``close`` fails as a refused connection would
        (APIError 599), so nothing reaches the plane from a closed client."""
        self._closed = True

    # -- transport -----------------------------------------------------------

    def _send(self, index: int, method: str, path: str, body: bytes,
              headers: Dict[str, str], timeout: float) -> Response:
        """One HTTP exchange with endpoint ``index`` on a connection of its
        own. ``path`` is the full request path (the endpoint's own path
        prefix included)."""
        url = urlsplit(self.endpoints[index])
        cls = (http.client.HTTPSConnection if url.scheme == "https"
               else http.client.HTTPConnection)
        conn = cls(url.hostname, url.port, timeout=timeout)
        try:
            conn.request(method, path, body=body or None, headers=headers)
            resp = conn.getresponse()
            return Response(resp.status, resp.read(), resp.headers)
        finally:
            conn.close()

    def _full_path(self, index: int, path: str) -> str:
        return urlsplit(self.endpoints[index]).path.rstrip("/") + path

    # -- plane failover ------------------------------------------------------

    def _probe_plane(self, index: int) -> bool:
        """GET /health on a candidate plane, through the same fault seam as
        real requests: a partitioned plane is alive but unreachable from
        this worker, and the probe must see what the worker sees."""
        try:
            resp = _faults.wrap_http(
                "worker.api.request",
                lambda: self._send(index, "GET",
                                   self._full_path(index, "/health"),
                                   b"", {}, PROBE_TIMEOUT_S),
                method="GET", path="/health",
                worker=str(getattr(self, "fault_tag", "") or ""),
                server=self.endpoints[index],
            )
            return resp.status_code == 200
        except Exception:  # noqa: BLE001 — any failure means unhealthy
            return False

    def _failover_plane(self) -> bool:
        """Rotate to the next healthy plane endpoint (sticky). Prefers a
        probe-healthy peer; falls back to plain round-robin when nothing
        probes healthy right now. False on a single-endpoint client."""
        if len(self.endpoints) <= 1:
            return False
        for step in range(1, len(self.endpoints)):
            cand = (self._active + step) % len(self.endpoints)
            if self._probe_plane(cand):
                self._active = cand
                self.plane_failovers += 1
                return True
        self._active = (self._active + 1) % len(self.endpoints)
        self.plane_failovers += 1
        return True

    # -- low-level ----------------------------------------------------------

    def _headers(self, method: str, path: str, body: bytes) -> Dict[str, str]:
        headers = {"Content-Type": "application/json"}
        if self.auth_token:
            headers["Authorization"] = f"Bearer {self.auth_token}"
        if self.signing_secret:
            headers.update(
                self._signer.sign(self.signing_secret, method, path, body)
            )
        return headers

    def _backoff(self, attempt: int, remaining_s: float) -> Optional[float]:
        """Sleep one full-jitter backoff step; the slept seconds, or None
        when the retry budget is spent (the caller stops retrying)."""
        delay = full_jitter_delay(
            self._backoff_s, attempt, self._rng, remaining_s
        )
        if delay is None:
            return None
        time.sleep(delay)
        return delay

    def _request(self, method: str, path: str,
                 payload: Optional[Dict[str, Any]] = None,
                 retries: Optional[int] = None) -> Response:
        if self._closed:
            raise APIError(599, "client closed")
        body = json.dumps(payload).encode() if payload is not None else b""
        attempts = (self._max_retries if retries is None else retries) + 1
        budget = self._retry_budget_s
        last_exc: Optional[Exception] = None
        # plane failover: a transport failure / 5xx rotates to a peer plane
        # and retries there without consuming a backoff attempt — at most
        # one lap of the endpoint list per request
        rotations = 0
        max_rotations = len(self.endpoints) - 1
        attempt = 0
        while attempt < attempts:
            index = self._active
            full = self._full_path(index, path)
            try:
                resp = _faults.wrap_http(
                    "worker.api.request",
                    lambda: self._send(index, method, full, body,
                                       self._headers(method, full, body),
                                       self._timeout_s),
                    method=method, path=path,
                    # per-replica targeting: a rule can cut ONE worker's
                    # plane traffic, or one plane's (``server``)
                    worker=str(getattr(self, "fault_tag", "") or ""),
                    server=self.base_url,
                )
            except TRANSPORT_ERRORS as exc:
                last_exc = exc
                if rotations < max_rotations and self._failover_plane():
                    rotations += 1
                    continue
                attempt += 1
                if attempt >= attempts:
                    break
                slept = self._backoff(attempt - 1, budget)
                if slept is None:
                    break
                budget -= slept
                continue
            if resp.status_code >= 500:
                last_exc = APIError(resp.status_code, resp.text[:200])
                if rotations < max_rotations and self._failover_plane():
                    rotations += 1
                    continue
                attempt += 1
                if attempt >= attempts:
                    raise last_exc
                slept = self._backoff(attempt - 1, budget)
                if slept is None:
                    raise last_exc
                budget -= slept
                continue
            if 400 <= resp.status_code < 500:  # never retried
                detail = ""
                try:
                    detail = resp.json().get("detail", "")
                except (ValueError, AttributeError):
                    pass
                raise APIError(resp.status_code, detail)
            return resp
        raise APIError(599, f"transport failed: {last_exc}")

    # -- registration / auth --------------------------------------------------

    def register(self, info: Dict[str, Any]) -> Dict[str, Any]:
        if self.worker_id:
            info = {**info, "worker_id": self.worker_id}
        data = self._request("POST", "/api/v1/workers/register", info).json()
        self.worker_id = data["worker_id"]
        self.auth_token = data["auth_token"]
        self.refresh_token = data["refresh_token"]
        self.signing_secret = data["signing_secret"]
        return data

    def verify_credentials(self) -> bool:
        if not (self.worker_id and self.auth_token):
            return False
        try:
            self._request(
                "POST", f"/api/v1/workers/{self.worker_id}/verify", {}
            )
            return True
        except APIError:
            return False

    def refresh_credentials(self) -> Dict[str, Any]:
        data = self._request(
            "POST",
            f"/api/v1/workers/{self.worker_id}/refresh-token",
            {"refresh_token": self.refresh_token},
        ).json()
        self.auth_token = data["auth_token"]
        self.refresh_token = data["refresh_token"]
        self.signing_secret = data["signing_secret"]
        return data

    # -- lifecycle -------------------------------------------------------------

    def heartbeat(self, status: str = "idle",
                  config_version: int = 0,
                  **extra: Any) -> Dict[str, Any]:
        return self._request(
            "POST",
            f"/api/v1/workers/{self.worker_id}/heartbeat",
            {"status": status, "config_version": config_version, **extra},
        ).json()

    def fetch_next_job(self) -> Optional[Dict[str, Any]]:
        resp = self._request(
            "GET", f"/api/v1/workers/{self.worker_id}/next-job", retries=0
        )
        if resp.status_code == 204:
            return None
        return resp.json()["job"]

    def complete_job(self, job_id: str, success: bool,
                     result: Optional[Dict[str, Any]] = None,
                     error: Optional[str] = None,
                     assignment_epoch: Optional[int] = None
                     ) -> Dict[str, Any]:
        payload: Dict[str, Any] = {
            "success": success, "result": result, "error": error,
        }
        if assignment_epoch is not None:
            # zombie fence: the server answers a completion whose epoch no
            # longer matches the job's assignment with a 409
            payload["assignment_epoch"] = int(assignment_epoch)
        return self._request(
            "POST",
            f"/api/v1/workers/{self.worker_id}/jobs/{job_id}/complete",
            payload,
        ).json()

    # -- crash-safe generation (checkpoints + stream failover) ---------------

    def checkpoint_job(self, job_id: str, assignment_epoch: int,
                       state: Optional[Dict[str, Any]],
                       migrate: bool = False) -> Dict[str, Any]:
        """Push a generation checkpoint for a RUNNING job; ``migrate=True``
        additionally requeues it (graceful drain) without burning a retry."""
        return self._request(
            "POST",
            f"/api/v1/workers/{self.worker_id}/jobs/{job_id}/checkpoint",
            {"assignment_epoch": int(assignment_epoch), "state": state,
             "migrate": bool(migrate)},
        ).json()

    def checkpoint_stream(self, stream_id: str, epoch: int,
                          state: Optional[Dict[str, Any]],
                          done: bool = False) -> Dict[str, Any]:
        """Push (or, with ``done=True``, retire) a direct stream's
        checkpoint — the per-token cadence between heartbeats."""
        return self._request(
            "POST",
            f"/api/v1/workers/{self.worker_id}/streams/{stream_id}"
            "/checkpoint",
            {"epoch": int(epoch), "state": state, "done": bool(done)},
            retries=0,
        ).json()

    def adopt_stream(self, stream_id: str) -> Dict[str, Any]:
        """Adopt a dropped stream's checkpoint (the epoch fences out the
        previous owner); raises APIError(404) when none exists."""
        return self._request(
            "POST",
            f"/api/v1/workers/{self.worker_id}/streams/{stream_id}/adopt",
            {},
        ).json()

    def release_job(self, job_id: str) -> None:
        """Decline a claimed job without failing it (client-side load
        control); the server requeues it for other workers."""
        self._request(
            "POST",
            f"/api/v1/workers/{self.worker_id}/jobs/{job_id}/release",
            {},
        )

    def going_offline(self) -> None:
        self._request(
            "POST", f"/api/v1/workers/{self.worker_id}/going-offline", {}
        )

    def offline(self) -> List[str]:
        resp = self._request(
            "POST", f"/api/v1/workers/{self.worker_id}/offline", {}
        )
        return resp.json().get("requeued_jobs", [])

    def fetch_remote_config(self) -> Dict[str, Any]:
        return self._request(
            "GET", f"/api/v1/workers/{self.worker_id}/config"
        ).json()
