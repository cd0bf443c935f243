"""Python client SDK: multi-server fallback, retries, sync/async jobs,
direct-to-worker mode.

Behavioral parity with the reference's ``sdk/python/inference_client.py``:

- Multi-server fallback + retry ladder: 503 → try the next server, 4xx →
  raise immediately, transport errors/5xx → exponential backoff then next
  server (:58-100).
- ``chat`` / ``generate_image`` with sync (long-poll ``/jobs/sync``) or
  async (create → poll) execution (:104-221).
- Job lifecycle: create / get / wait / cancel (:225-280).
- Direct mode: nearest-worker discovery via ``/api/v1/jobs/direct/nearest``
  with a 60 s cache (:284-306), then POST to the worker's ``/inference``
  (:308-329); on any direct failure, falls back to the queued path.
- Module-level one-shot helpers (:380-399).

The port's copy of ``distributed_gpu_inference_tpu/sdk/client.py`` with
every public method and retry rule kept, on ``http.client`` (the card's
machine has no ``httpx``): :class:`HTTPTransport` opens one connection per
call with the configured socket timeout, so one client may be shared by
threads (the hedged race posts from two). A connection that was refused
or never opened is a :class:`ConnectError` (the request was never sent);
any other transport failure a :class:`TransportError`.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import http.client
import json
import random
import time
import uuid
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence
from urllib.parse import urlencode, urlsplit

from ..testing import faults as _faults
from ..worker.api_client import Response
from ..utils.backoff import full_jitter_delay
from ..utils.prefixes import (
    canonical_prompt_text,
    fingerprints_for_params,
    prefix_fingerprints,
)

DIRECT_CACHE_TTL_S = 60.0  # reference inference_client.py:284-306
# sticky session→worker routing cache: kept SHORT (same staleness budget
# as the generic direct cache) because a sticky hit skips the server's
# load-spillover ranking — the pin must expire before a saturated worker
# can accumulate conversations the fleet should absorb
SESSION_CACHE_TTL_S = 60.0
_SESSION_CACHE_MAX = 1024


class TransportError(Exception):
    """No answer came back: the connection failed, was cut or timed out."""


class ConnectError(TransportError):
    """The connection was never opened: the request was not sent."""


class _StreamResponse:
    """A response whose body is read line by line (server-sent events)."""

    def __init__(self, resp: http.client.HTTPResponse) -> None:
        self._resp = resp
        self.status_code = resp.status
        self.headers = resp.headers

    def iter_lines(self) -> Iterator[str]:
        while True:
            try:
                raw = self._resp.readline()
            except (OSError, http.client.HTTPException) as exc:
                raise TransportError(str(exc) or type(exc).__name__) from exc
            if not raw:
                return
            yield raw.decode("utf-8", errors="replace").rstrip("\r\n")


class HTTPTransport:
    """The blocking HTTP client the SDK speaks through: ``request`` /
    ``post`` answer a :class:`~..worker.api_client.Response`, ``stream``
    opens a response whose body is read line by line. ``send`` replaces
    the network (tests): ``send(method, url, body, headers, timeout)`` →
    ``(status, headers, body bytes)``."""

    def __init__(self, timeout_s: float,
                 send: Optional[Callable[..., tuple]] = None) -> None:
        self.timeout_s = timeout_s
        self._send = send

    @staticmethod
    def _target(url: str, params: Optional[Dict[str, str]]) -> tuple:
        u = urlsplit(url)
        path = u.path or "/"
        query = "&".join(q for q in (u.query, urlencode(params or {})) if q)
        return u, path + ("?" + query if query else "")

    def _open(self, method: str, url: str, payload: Any,
              params: Optional[Dict[str, str]], headers: Optional[Dict[str, str]],
              timeout: Optional[float]) -> tuple:
        u, target = self._target(url, params)
        body = None if payload is None else json.dumps(payload).encode()
        hdrs = dict(headers or {})
        if body is not None:
            hdrs.setdefault("Content-Type", "application/json")
        cls = (http.client.HTTPSConnection if u.scheme == "https"
               else http.client.HTTPConnection)
        conn = cls(u.hostname, u.port,
                   timeout=self.timeout_s if timeout is None else timeout)
        try:
            conn.connect()
        except (OSError, http.client.HTTPException) as exc:
            conn.close()
            raise ConnectError(str(exc) or type(exc).__name__) from exc
        try:
            conn.request(method, target, body=body, headers=hdrs)
            return conn, conn.getresponse()
        except (OSError, http.client.HTTPException) as exc:
            conn.close()
            raise TransportError(str(exc) or type(exc).__name__) from exc

    def request(self, method: str, url: str, json: Any = None,
                params: Optional[Dict[str, str]] = None,
                headers: Optional[Dict[str, str]] = None,
                timeout: Optional[float] = None) -> Response:
        if self._send is not None:
            u, target = self._target(url, params)
            body = None if json is None else _json_dumps(json)
            status, hdrs, content = self._send(
                method, f"{u.scheme}://{u.netloc}{target}", body, dict(headers or {}),
                self.timeout_s if timeout is None else timeout)
            return Response(status, content, hdrs)
        conn, resp = self._open(method, url, json, params, headers, timeout)
        try:
            return Response(resp.status, resp.read(), resp.headers)
        except (OSError, http.client.HTTPException) as exc:
            raise TransportError(str(exc) or type(exc).__name__) from exc
        finally:
            conn.close()

    def post(self, url: str, json: Any = None,
             headers: Optional[Dict[str, str]] = None,
             timeout: Optional[float] = None) -> Response:
        return self.request("POST", url, json=json, headers=headers, timeout=timeout)

    @contextlib.contextmanager
    def stream(self, method: str, url: str, json: Any = None,
               headers: Optional[Dict[str, str]] = None,
               timeout: Optional[float] = None) -> Iterator[_StreamResponse]:
        conn, resp = self._open(method, url, json, None, headers, timeout)
        try:
            yield _StreamResponse(resp)
        finally:
            conn.close()

    def close(self) -> None:
        """Every call closes its own connection: nothing to release."""


def _json_dumps(payload: Any) -> bytes:
    return json.dumps(payload).encode()


class InferenceClientError(Exception):
    def __init__(self, status: int, detail: str = "",
                 retry_after_s: Optional[float] = None) -> None:
        super().__init__(f"HTTP {status}: {detail}")
        self.status = status
        self.detail = detail
        # server-provided backpressure hint (429/503 Retry-After header or
        # the machine-readable retry_after_s body field) — callers that
        # schedule their own retries should wait at least this long
        self.retry_after_s = retry_after_s


class NoWorkersAvailable(InferenceClientError):
    """Every configured server answered 503 (no capacity)."""

    def __init__(self, detail: str = "no workers available",
                 retry_after_s: Optional[float] = None) -> None:
        super().__init__(503, detail, retry_after_s=retry_after_s)


def _retry_after_of(resp: Response) -> Optional[float]:
    """Parse the server's retry hint: machine-readable ``retry_after_s`` in
    the JSON body (one contract for 429 backpressure AND 503 capacity
    errors), falling back to the standard Retry-After header."""
    try:
        val = resp.json().get("retry_after_s")
        if val is not None:
            return max(0.0, float(val))
    except (ValueError, AttributeError, TypeError):
        pass
    hdr = resp.headers.get("Retry-After")
    if hdr:
        try:
            return max(0.0, float(hdr))
        except ValueError:
            pass
    return None


class InferenceClient:
    def __init__(
        self,
        server_url: str | Sequence[str] = "http://127.0.0.1:8000",
        api_key: Optional[str] = None,
        timeout_s: float = 120.0,
        max_retries: int = 2,
        backoff_s: float = 0.5,
        transport: Optional[Callable[..., tuple]] = None,
        rng: Optional[random.Random] = None,
    ) -> None:
        self.servers = (
            [server_url] if isinstance(server_url, str) else list(server_url)
        )
        self.servers = [s.rstrip("/") for s in self.servers]
        self.api_key = api_key
        self._max_retries = max_retries
        self._backoff_s = backoff_s
        # full-jitter source; injectable so tests can pin the schedule
        self._rng = rng if rng is not None else random.Random()
        # ``transport``: a stand-in for the network (tests), see
        # :class:`HTTPTransport` ``send``
        self._client = HTTPTransport(timeout_s, send=transport)
        self._direct_cache: Optional[Dict[str, Any]] = None
        self._direct_cache_at = 0.0
        # cache-aware routing: session → (worker, ts) sticky cache. A
        # conversation keeps landing on the worker already holding its
        # KV prefix without re-asking the control plane every turn; any
        # failure drops the entry and rediscovers (affinity, never a pin).
        self._session_workers: Dict[str, tuple] = {}

    def close(self) -> None:
        self._client.close()

    def __enter__(self) -> "InferenceClient":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # -- transport with server fallback (reference :58-100) -----------------

    def _headers(self) -> Dict[str, str]:
        h = {"Content-Type": "application/json"}
        if self.api_key:
            h["X-API-Key"] = self.api_key
        return h

    def _sleep_backoff(self, attempt: int, floor_s: float = 0.0) -> None:
        """Full-jitter exponential backoff (``utils.backoff``); bounded by
        the attempt count, de-synchronized across a fleet of clients.
        ``floor_s``: a server-provided Retry-After hint — honored as a
        minimum wait with the jitter ADDED on top, so a saturated server's
        clients neither return early nor stampede back in lockstep."""
        time.sleep(
            floor_s + full_jitter_delay(self._backoff_s, attempt, self._rng)
        )

    def _request(self, method: str, path: str,
                 payload: Optional[Dict[str, Any]] = None,
                 params: Optional[Dict[str, str]] = None,
                 timeout: Optional[float] = None,
                 idempotent: bool = True) -> Response:
        """``idempotent=False`` marks calls whose SERVER-SIDE effect may have
        happened even when the response is lost (POST /jobs, /jobs/sync): they
        are sent exactly once — no transport retry, no 5xx retry, no
        next-server failover — because a blind re-POST would create or
        execute the job again."""
        last: Optional[Exception] = None
        saw_503 = False
        saw_conn_fail = False
        err_429: Optional[InferenceClientError] = None
        last_retry_after: Optional[float] = None
        for server in self.servers:
            for attempt in range(self._max_retries + 1):
                try:
                    resp = _faults.wrap_http(
                        "sdk.client.request",
                        lambda srv=server: self._client.request(
                            method, f"{srv}{path}", json=payload,
                            params=params, headers=self._headers(),
                            **({"timeout": timeout}
                               if timeout is not None else {}),
                        ),
                        method=method, path=path,
                        # destination endpoint: plane-targeted chaos rules
                        # (plane_partition / plane_slow) match on it
                        server=server,
                    )
                except (TransportError, _faults.FaultInjected) as exc:
                    last = exc
                    if not idempotent:
                        # an injected drop is a connect failure, as the
                        # JAX seam raises it
                        if isinstance(exc, (ConnectError, _faults.FaultInjected)):
                            # plane-connection loss BEFORE the request was
                            # ever sent: the job was definitively NOT
                            # created, so the next plane endpoint may
                            # safely take the submission — this is the one
                            # transport failure where failing over an
                            # effectful POST cannot double-execute it
                            saw_conn_fail = True
                            break
                        raise InferenceClientError(
                            599, f"transport failed: {exc}"
                        ) from exc
                    if attempt < self._max_retries:
                        self._sleep_backoff(attempt)
                    continue
                if resp.status_code == 503:
                    saw_503 = True
                    last_retry_after = _retry_after_of(resp)
                    break  # capacity problem: next server, don't retry here
                if resp.status_code == 429:
                    # queue backpressure: the job was NOT created, so a
                    # retry is safe even for non-idempotent POSTs. Honor
                    # Retry-After as the backoff floor with full jitter on
                    # top (no fleet-wide stampede when the hint expires);
                    # once this server's retries are spent, fail over to
                    # the next configured server exactly like the 503 path.
                    retry_after = _retry_after_of(resp) or 1.0
                    last_retry_after = retry_after
                    if attempt < self._max_retries:
                        self._sleep_backoff(attempt, floor_s=retry_after)
                        continue
                    err_429 = InferenceClientError(
                        429, "server backpressure: queue saturated",
                        retry_after_s=retry_after,
                    )
                    last = err_429
                    break
                if 400 <= resp.status_code < 500:
                    detail = ""
                    try:
                        detail = resp.json().get("detail", "")
                    except ValueError:
                        pass
                    raise InferenceClientError(resp.status_code, detail)
                if resp.status_code >= 500:
                    last = InferenceClientError(
                        resp.status_code, resp.text[:200]
                    )
                    if not idempotent:  # the job may have run: don't re-run it
                        raise last
                    if attempt < self._max_retries:
                        self._sleep_backoff(attempt)
                    continue
                return resp
            if not idempotent and not (
                saw_503 or err_429 is not None or saw_conn_fail
            ):
                break  # no cross-server failover for effectful calls
                #       (503/429/connect-refused mean the job was never
                #       created — safe)
        if saw_503:
            raise NoWorkersAvailable(retry_after_s=last_retry_after)
        if err_429 is not None:
            raise err_429  # every server backpressured: surface the hint
        raise InferenceClientError(599, f"all servers failed: {last}")

    # -- job lifecycle (reference :225-280) ----------------------------------

    def create_job(self, job_type: str, params: Dict[str, Any],
                   priority: int = 0,
                   preferred_region: Optional[str] = None,
                   **extra: Any) -> str:
        body: Dict[str, Any] = {
            "type": job_type, "params": params, "priority": priority, **extra,
        }
        if preferred_region:
            body["preferred_region"] = preferred_region
        resp = self._request("POST", "/api/v1/jobs", body, idempotent=False)
        return resp.json()["job_id"]

    def get_job(self, job_id: str) -> Dict[str, Any]:
        return self._request("GET", f"/api/v1/jobs/{job_id}").json()

    def wait_for_job(self, job_id: str, timeout_s: float = 300.0,
                     poll_s: float = 0.5) -> Dict[str, Any]:
        deadline = time.time() + timeout_s
        while True:
            try:
                job = self.get_job(job_id)
            except InferenceClientError as exc:
                # GET /jobs/{id} is idempotent: a transient blip (transport
                # failure = 599, or a 5xx the retry ladder exhausted on)
                # must not abort a long wait — keep polling until the
                # deadline. 4xx are real answers and surface immediately.
                if exc.status < 500:
                    raise
                if time.time() >= deadline:
                    raise TimeoutError(
                        f"job {job_id}: server unreachable at deadline "
                        f"({exc})"
                    ) from exc
                time.sleep(poll_s * self._rng.uniform(0.5, 1.0))
                continue
            if job["status"] in ("completed", "failed", "cancelled"):
                return job
            if time.time() >= deadline:
                raise TimeoutError(
                    f"job {job_id} still {job['status']} after {timeout_s}s"
                )
            time.sleep(poll_s)

    def cancel_job(self, job_id: str) -> None:
        self._request("DELETE", f"/api/v1/jobs/{job_id}")

    def queue_stats(self) -> Dict[str, Any]:
        return self._request("GET", "/api/v1/jobs/stats/queue").json()

    def get_request_timeline(self, job_or_trace_id: str) -> Dict[str, Any]:
        """Merged flight-recorder timeline for a job (PD stage children
        resolve to the parent's trace) or a raw trace id: causally-ordered
        events + derived per-phase durations. 404s (as
        InferenceClientError) when nothing was recorded — e.g. the request
        carried no ``trace_id``."""
        return self._request(
            "GET", f"/api/v1/debug/requests/{job_or_trace_id}/timeline"
        ).json()

    def _run_job(self, job_type: str, params: Dict[str, Any], sync: bool,
                 timeout_s: float, **extra: Any) -> Dict[str, Any]:
        if sync:
            # read timeout must outlive the server's long-poll window, and a
            # timeout must NOT be retried (the job may still complete)
            resp = self._request(
                "POST", "/api/v1/jobs/sync",
                {"type": job_type, "params": params,
                 "timeout_seconds": timeout_s, **extra},
                timeout=timeout_s + 15.0,
                idempotent=False,
            )
            data = resp.json()
            if data.get("status") != "completed":
                raise InferenceClientError(
                    500, data.get("error") or f"job {data.get('status')}"
                )
            return data["result"]
        job_id = self.create_job(job_type, params, **extra)
        job = self.wait_for_job(job_id, timeout_s=timeout_s)
        if job["status"] != "completed":
            raise InferenceClientError(
                500, job.get("error") or f"job {job['status']}"
            )
        return job["result"]

    # -- task helpers (reference :104-221) -----------------------------------

    @staticmethod
    def _routing_fps(params: Dict[str, Any],
                     prefix_hint: Optional[str]) -> List[str]:
        """Boundary fingerprints for cache-aware routing: the explicit
        ``prefix_hint`` (e.g. a shared system prompt) when given, else the
        request's own prompt/messages — same canonicalization and hash as
        the control plane and the workers (``utils/prefixes.py``)."""
        if prefix_hint is not None:
            if not prefix_hint:
                return []
            if params.get("messages"):
                # workers fingerprint the CANONICAL message text
                # ("role\x1fcontent\x1e..."), so a raw-text hint would
                # never match — wrap it as the leading system message it
                # names, whose canonical form IS a prefix of the
                # request's canonical text
                return prefix_fingerprints(canonical_prompt_text(
                    [{"role": "system", "content": prefix_hint}]
                ))
            return prefix_fingerprints(canonical_prompt_text(prefix_hint))
        # no hint: same messages-over-prompt precedence as the server's
        # fallback computation — ONE implementation, so client- and
        # server-side fingerprints of a request can never drift
        return fingerprints_for_params(params)

    def chat(
        self,
        messages: Optional[List[Dict[str, str]]] = None,
        prompt: Optional[str] = None,
        model: Optional[str] = None,
        sync: bool = True,
        use_direct: bool = False,
        timeout_s: float = 120.0,
        priority: int = 0,
        session: Optional[str] = None,
        prefix_hint: Optional[str] = None,
        trace_id: Optional[str] = None,
        **gen_params: Any,
    ) -> Dict[str, Any]:
        """``priority``: scheduling priority — orders the control-plane
        queue AND the worker batcher's admission heap (higher admits
        first; KV-pressure victims are picked lowest-priority-first).

        Cache-aware routing: ``session`` makes direct mode sticky — every
        call with the same session id prefers the worker that served the
        last one (whose radix cache holds the conversation's KV), falling
        back to rediscovery on any failure. ``prefix_hint`` names the
        shared prefix (a system prompt, a RAG document header) to
        fingerprint for affinity routing; without it the prompt/messages
        fingerprint themselves. Both are advisory — results are identical
        wherever the request lands."""
        params: Dict[str, Any] = dict(gen_params)
        if messages is not None:
            params["messages"] = messages
        if prompt is not None:
            params["prompt"] = prompt
        if model is not None:
            params["model"] = model
        if priority:
            params["priority"] = int(priority)
        if trace_id:
            # flight recorder: ride the request end to end — fetch the
            # merged timeline later via get_request_timeline()
            params["trace_id"] = str(trace_id)
        fps = self._routing_fps(params, prefix_hint)
        if use_direct:
            result = self._try_direct("llm", params, prefix_fps=fps,
                                      session=session)
            if result is not None:
                return result
        return self._run_job("llm", params, sync=sync, timeout_s=timeout_s,
                             **({"priority": int(priority)} if priority
                                else {}),
                             **({"prefix_fps": fps} if fps else {}))

    def generate_image(self, prompt: str, sync: bool = True,
                       timeout_s: float = 300.0,
                       **gen_params: Any) -> Dict[str, Any]:
        params = {"prompt": prompt, **gen_params}
        return self._run_job(
            "image_gen", params, sync=sync, timeout_s=timeout_s
        )

    def embed(self, texts: Sequence[str], sync: bool = True,
              timeout_s: float = 60.0, **params: Any) -> Dict[str, Any]:
        return self._run_job(
            "embedding", {"texts": list(texts), **params},
            sync=sync, timeout_s=timeout_s,
        )

    def transcribe(self, audio_b64: str, sync: bool = True,
                   timeout_s: float = 300.0, **params: Any) -> Dict[str, Any]:
        return self._run_job(
            "whisper", {"audio": audio_b64, **params},
            sync=sync, timeout_s=timeout_s,
        )

    def stream_chat(
        self,
        messages: Optional[List[Dict[str, str]]] = None,
        prompt: Optional[str] = None,
        model: Optional[str] = None,
        timeout_s: float = 300.0,
        max_stream_resumes: int = 3,
        priority: int = 0,
        session: Optional[str] = None,
        prefix_hint: Optional[str] = None,
        trace_id: Optional[str] = None,
        **gen_params: Any,
    ):
        """Token streaming via the nearest direct worker's SSE endpoint.

        Yields ``{"text_delta", "token_ids"}`` chunks then a final
        ``{"done": True, ...}``. When no direct worker is available (or the
        stream fails before the first chunk), falls back to one queued
        round trip yielded as a single chunk + done event. The queued
        fallback NEVER fires after a chunk was consumed — a re-run would
        duplicate the delivered prefix AND execute the prompt twice.

        Exactly-once resumable streams: offset-aware workers stamp every
        event with a monotonic token ``offset``. When such a stream drops
        mid-generation, the client reconnects — to the same worker or,
        excluding the one that just died, a failover peer — with a
        ``Last-Event-ID``-style ``resume {stream_id, offset}`` body. The
        worker adopts the generation's control-plane checkpoint and splices
        the continuation at the offset, so the consumer sees the exact
        token sequence an undropped stream would have produced: no gap, no
        duplicate. Streams from legacy (offset-less) workers keep the old
        contract: a mid-generation drop raises."""
        params: Dict[str, Any] = dict(gen_params)
        if messages is not None:
            params["messages"] = messages
        if prompt is not None:
            params["prompt"] = prompt
        if model is not None:
            params["model"] = model
        if priority:
            # reaches the worker batcher's admission heap: a high-priority
            # stream admits ahead of waiting work on a saturated worker
            params["priority"] = int(priority)
        if trace_id:
            # flight recorder: the stream's final done chunk carries the
            # worker-side timeline; the heartbeat channel ships it to the
            # plane's merged store too
            params["trace_id"] = str(trace_id)

        stream_id = uuid.uuid4().hex
        offset = 0            # token offset of the last consumed event
        text_len = 0          # characters consumed (holdback flushes can
        #                       advance text without advancing the token
        #                       offset — the resume must splice BOTH)
        yielded = False       # any chunk reached the consumer
        offset_aware = False  # the worker stamps offsets → resumable
        resumes = 0
        failed_workers: List[str] = []
        last_err: Any = None

        fps = self._routing_fps(params, prefix_hint)
        plane_retries = 0
        while True:
            resuming = yielded
            try:
                worker = self._get_nearest_worker(
                    exclude=failed_workers or None,
                    prefix_fps=fps, session=session,
                    raise_plane_errors=resuming,
                )
            except InferenceClientError as exc:
                # plane-connection loss during failover rediscovery: every
                # plane endpoint failed to ANSWER (this is not a worker
                # dying — the checkpoint is still adoptable once any plane
                # comes back). Retry discovery on its own bounded budget,
                # WITHOUT burning max_stream_resumes and WITHOUT
                # blacklisting the worker that was serving us.
                plane_retries += 1
                if plane_retries > self._max_retries + 1:
                    raise InferenceClientError(
                        599, "stream dropped mid-generation and no control "
                             f"plane reachable for failover: {exc}"
                    ) from exc
                self._sleep_backoff(plane_retries - 1)
                continue
            plane_retries = 0
            if worker is None:
                if resuming:
                    raise InferenceClientError(
                        599, "stream dropped mid-generation and no "
                             f"failover worker available: {last_err}"
                    )
                break  # nothing consumed: queued fallback is safe
            url = f"{worker['direct_url'].rstrip('/')}/inference/stream"
            body: Dict[str, Any] = {
                "type": "llm", "params": params, "stream_id": stream_id,
            }
            if resuming:
                body["resume"] = {"stream_id": stream_id, "offset": offset,
                                  "text_offset": text_len}
            dropped = False
            # a worker that DIED on us is excluded from rediscovery; one
            # that merely answered busy/5xx stays eligible (it frees up)
            blacklist = False
            retry_floor = 0.0
            try:
                with self._client.stream(
                    "POST", url, json=body,
                    headers=self._headers(), timeout=timeout_s,
                ) as resp:
                    if resp.status_code != 200:
                        self._direct_cache = None
                        if not resuming:
                            break  # busy/declined: queued fallback
                        if resp.status_code == 409:
                            # no checkpoint exists: the delivered prefix
                            # cannot be disowned and a re-run would
                            # double-generate it — surface the drop
                            raise InferenceClientError(
                                599, "stream dropped mid-generation: no "
                                     "checkpoint to resume from"
                            )
                        dropped = True
                        last_err = f"HTTP {resp.status_code}"
                        try:
                            retry_floor = float(
                                resp.headers.get("Retry-After") or 0.5
                            )
                        except ValueError:
                            retry_floor = 0.5
                    else:
                        for line in resp.iter_lines():
                            if not line.startswith("data: "):
                                continue
                            chunk = json.loads(line[len("data: "):])
                            if "error" in chunk:
                                raise InferenceClientError(
                                    500, chunk["error"]
                                )
                            off = chunk.get("offset")
                            if off is not None:
                                offset_aware = True
                                # belt-and-braces dedupe: the worker
                                # splices, but a replayed event must never
                                # re-deliver consumed tokens. Same-offset
                                # chunks WITHOUT token ids are legitimate
                                # (the final holdback flush emits text
                                # only, at an unchanged token offset) and
                                # must pass.
                                if not chunk.get("done") and yielded and (
                                    int(off) < offset
                                    or (int(off) == offset
                                        and chunk.get("token_ids"))
                                ):
                                    continue
                                offset = max(offset, int(off))
                            elif resuming:
                                # a resume answered by an offset-less
                                # (legacy or fresh-run) worker cannot be
                                # spliced safely — refuse the duplicate
                                raise InferenceClientError(
                                    599, "stream dropped mid-generation: "
                                         "resume target is not offset-"
                                         "aware"
                                )
                            yielded = True
                            text_len += len(chunk.get("text_delta") or "")
                            yield chunk
                            if chunk.get("done"):
                                return
                        # 200 stream ended with no done event: the
                        # connection died mid-body (worker crash)
                        dropped = True
                        blacklist = True
                        last_err = "stream ended before done event"
            except TransportError as exc:
                self._direct_cache = None
                dropped = True
                blacklist = True
                last_err = exc
            if not dropped:
                break  # non-200 first attempt fell through: queued path
            if not yielded:
                break  # nothing consumed: queued fallback is safe
            if not offset_aware:
                # legacy worker: no offsets, no safe splice
                raise InferenceClientError(
                    599, f"stream dropped mid-generation: {last_err}"
                )
            resumes += 1
            if resumes > max_stream_resumes:
                raise InferenceClientError(
                    599, f"stream dropped mid-generation: resume budget "
                         f"exhausted after {max_stream_resumes} attempts "
                         f"({last_err})"
                )
            if blacklist:
                wid = worker.get("worker_id")
                if wid and wid not in failed_workers:
                    failed_workers.append(wid)
            self._direct_cache = None
            self._drop_session_worker(session)
            # jittered backoff between resume attempts (Retry-After as the
            # floor on a busy answer) — no zero-delay stampede at the very
            # worker fleet the first failure just destabilized
            self._sleep_backoff(resumes - 1, floor_s=retry_floor)
        # fallback: queued path, emitted as one chunk (stream contract kept)
        result = self._run_job("llm", params, sync=True, timeout_s=timeout_s)
        yield {"text_delta": result.get("text", ""), "token_ids": []}
        yield {"done": True,
               "finish_reason": result.get("finish_reason", "stop"),
               "usage": result.get("usage", {})}

    # -- direct mode (reference :284-329) ------------------------------------

    def _get_nearest_worker(
        self, exclude: Optional[Sequence[str]] = None,
        prefix_fps: Optional[Sequence[str]] = None,
        session: Optional[str] = None,
        trace_id: Optional[str] = None,
        raise_plane_errors: bool = False,
        hedge: bool = False,
    ) -> Optional[Dict[str, Any]]:
        now = time.time()
        if session and not exclude and not hedge:
            cached = self._session_workers.get(session)
            if cached is not None and now - cached[1] < SESSION_CACHE_TTL_S:
                return cached[0]
        if not exclude and not prefix_fps and not hedge \
                and self._direct_cache is not None \
                and now - self._direct_cache_at < DIRECT_CACHE_TTL_S:
            return self._direct_cache
        query: Dict[str, str] = {}
        if hedge:
            # hedged dispatch: ask the plane for a second-ranked backup
            # worker + the p95-derived hedge delay alongside the primary.
            # Hedged discoveries bypass the caches above — the backup
            # choice and delay are per-request-fresh by design.
            query["hedge"] = "1"
        if exclude:
            # exclude: workers the caller just watched fail — a failover
            # reconnect must not land on the corpse
            query["exclude"] = ",".join(exclude)
        if prefix_fps:
            # cache-aware routing: the control plane ranks direct workers
            # by advertised prefix affinity (load-spillover-scaled)
            query["prefix_fps"] = ",".join(prefix_fps)
        if trace_id:
            # flight recorder: the plane notes its route decision on the
            # request's timeline (direct requests never pass complete_job)
            query["trace_id"] = str(trace_id)
        try:
            resp = self._request(
                "GET", "/api/v1/jobs/direct/nearest",
                params=query or None,
            )
        except NoWorkersAvailable:
            # a plane ANSWERED and said the fleet has no eligible worker —
            # that is a definitive routing result, never plane loss
            return None
        except InferenceClientError as exc:
            if raise_plane_errors and exc.status >= 500:
                # the discovery failed because no control plane answered
                # (transport = 599, or retry-exhausted 5xx) — NOT because
                # the fleet has no worker. Callers holding a resumable
                # stream need the distinction: plane loss is retryable
                # without spending worker-failover budget.
                raise
            return None
        worker = resp.json()
        if session:
            if len(self._session_workers) >= _SESSION_CACHE_MAX:
                # evict expired entries first, oldest-inserted as fallback
                cutoff = now - SESSION_CACHE_TTL_S
                for k in [k for k, (_, ts) in self._session_workers.items()
                          if ts < cutoff]:
                    del self._session_workers[k]
                while len(self._session_workers) >= _SESSION_CACHE_MAX:
                    del self._session_workers[
                        next(iter(self._session_workers))
                    ]
            # pop-then-insert: a refresh must move the session to the
            # recent end, or capacity eviction would drop the most ACTIVE
            # session just because it was inserted first
            self._session_workers.pop(session, None)
            self._session_workers[session] = (worker, now)
        if "hedge" in worker:
            # a hedge hint is per-request-fresh (backup pick + delay are
            # derived from live health state) — never cache it
            return worker
        if not prefix_fps or "prefix_affinity" not in worker:
            # the generic cache stays affinity-free: a fingerprinted pick
            # for one conversation must not leak to unrelated requests.
            # An answer WITHOUT a prefix_affinity field was not affinity-
            # ranked (routing disabled server-side, or no summaries) — it
            # is safe to cache, restoring the one-discovery-per-60s
            # behavior when the operator turns routing off.
            self._direct_cache = worker
            self._direct_cache_at = now
        return worker

    def _drop_session_worker(self, session: Optional[str]) -> None:
        if session:
            self._session_workers.pop(session, None)

    def _try_direct(self, job_type: str, params: Dict[str, Any],
                    prefix_fps: Optional[Sequence[str]] = None,
                    session: Optional[str] = None
                    ) -> Optional[Dict[str, Any]]:
        """POST straight to the nearest worker; any failure returns None so
        the caller falls back to the queued path (reference :308-329).

        Hedged dispatch (gray-failure round): DEADLINE-carrying requests
        ask discovery for a backup worker + a p95-derived hedge delay. If
        the primary has not answered within the delay, the same request
        fires at the backup and the first finisher wins — the loser is
        cancelled at its next step boundary via ``/inference/cancel``.
        Deadline-less requests keep the single-POST path bit-for-bit."""
        want_hedge = params.get("deadline_s") is not None
        worker = self._get_nearest_worker(prefix_fps=prefix_fps,
                                          session=session,
                                          trace_id=params.get("trace_id"),
                                          hedge=want_hedge)
        if worker is None:
            return None
        hint = worker.get("hedge") if want_hedge else None
        if isinstance(hint, dict) and hint.get("direct_url"):
            return self._race_hedged(job_type, params, worker, hint,
                                     session)
        try:
            resp = self._client.post(
                f"{worker['direct_url'].rstrip('/')}/inference",
                json={"type": job_type, "params": params},
                headers=self._headers(),
            )
        except TransportError:
            self._direct_cache = None
            self._drop_session_worker(session)
            return None
        if resp.status_code != 200:
            self._direct_cache = None  # busy/draining: rediscover next time
            self._drop_session_worker(session)
            return None
        return resp.json()["result"]

    def _post_direct_leg(self, direct_url: str, job_type: str,
                         params: Dict[str, Any],
                         hedge_key: str) -> Optional[Dict[str, Any]]:
        """One leg of a hedged race: the request carries its cancel key so
        the losing leg can be aborted server-side. Any failure (transport,
        busy 503, flaky 5xx) returns None — the OTHER leg is the retry."""
        try:
            resp = self._client.post(
                f"{direct_url.rstrip('/')}/inference",
                json={"type": job_type,
                      "params": {**params, "hedge_key": hedge_key}},
                headers=self._headers(),
            )
        except TransportError:
            return None
        if resp.status_code != 200:
            return None
        try:
            return resp.json()["result"]
        except (ValueError, KeyError):
            return None

    def _cancel_hedge_leg(self, direct_url: str, hedge_key: str) -> None:
        """Best-effort loser abort: idempotent server-side, and a miss
        (request already finished) costs nothing but the wasted decode."""
        try:
            self._client.post(
                f"{direct_url.rstrip('/')}/inference/cancel",
                json={"hedge_key": hedge_key},
                headers=self._headers(), timeout=5.0,
            )
        except Exception:  # noqa: BLE001 — the winner's result stands
            pass

    def _race_hedged(self, job_type: str, params: Dict[str, Any],
                     primary: Dict[str, Any], hint: Dict[str, Any],
                     session: Optional[str]) -> Optional[Dict[str, Any]]:
        """Primary fires immediately; the backup fires after the plane's
        hedge delay unless the primary already answered. First non-error
        answer wins and cancels the other leg. Both-legs-failed falls back
        to the queued path (None), same as the unhedged single POST."""
        legs = {
            "primary": (str(primary["direct_url"]), uuid.uuid4().hex),
            "hedge": (str(hint["direct_url"]), uuid.uuid4().hex),
        }
        delay_s = max(0.0, float(hint.get("delay_ms") or 0.0)) / 1000.0
        ex = concurrent.futures.ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="hedge"
        )
        futures: Dict[Any, str] = {}
        try:
            url, key = legs["primary"]
            pfut = ex.submit(self._post_direct_leg, url, job_type, params,
                             key)
            futures[pfut] = "primary"
            done, _ = concurrent.futures.wait([pfut], timeout=delay_s)
            if pfut in done:
                futures.pop(pfut, None)
                r = pfut.result()
                if r is not None:
                    return r   # primary beat the hedge delay: no hedge
                # primary failed fast: the backup leg IS the retry
            # primary slow (race it) or failed: fire the hedge leg
            url, key = legs["hedge"]
            hfut = ex.submit(self._post_direct_leg, url, job_type,
                             params, key)
            futures[hfut] = "hedge"
            result: Optional[Dict[str, Any]] = None
            while futures:
                done, _ = concurrent.futures.wait(
                    list(futures),
                    return_when=concurrent.futures.FIRST_COMPLETED,
                )
                for f in done:
                    futures.pop(f, None)
                    r = f.result()
                    if r is not None and result is None:
                        result = r
                        for lf, name in list(futures.items()):
                            lurl, lkey = legs[name]
                            self._cancel_hedge_leg(lurl, lkey)
                if result is not None:
                    return result
            # both legs failed: rediscover next time, queued fallback now
            self._direct_cache = None
            self._drop_session_worker(session)
            return None
        finally:
            ex.shutdown(wait=False)


# ---------------------------------------------------------------------------
# Module-level one-shots (reference :380-399)
# ---------------------------------------------------------------------------


def chat(messages=None, prompt=None, server_url="http://127.0.0.1:8000",
         **kw) -> Dict[str, Any]:
    with InferenceClient(server_url) as c:
        return c.chat(messages=messages, prompt=prompt, **kw)


def generate_image(prompt: str, server_url="http://127.0.0.1:8000",
                   **kw) -> Dict[str, Any]:
    with InferenceClient(server_url) as c:
        return c.generate_image(prompt, **kw)


def embed(texts: Sequence[str], server_url="http://127.0.0.1:8000",
          **kw) -> Dict[str, Any]:
    with InferenceClient(server_url) as c:
        return c.embed(texts, **kw)
