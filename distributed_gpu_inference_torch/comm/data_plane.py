"""The data plane on the standard library: a threading ``http.server``
for the prefill→decode KV handoff, cluster KV migration and, with a
pipeline stage, the stage's session routes; and the ``http.client`` calls
that reach it.

The port of ``distributed_gpu_inference_tpu/comm/data_plane.py``
``DataPlaneServer`` (aiohttp there; the card's machine has none), with the
same answers:

- ``POST /kv/transfer`` → ``kv_receiver(body)``: a one-shot handoff blob or
  one streamed-handoff message (``runtime/kv_handoff.py``); 200 with the
  receiver's JSON result, 500 ``{"detail"}`` when it raises, 501 when this
  plane is not a KV receiver;
- ``POST /kv/export`` → ``kv_exporter(body)``: a peer's prefix pull; 200
  with the framed prefix-only messages (empty = nothing cached), 400 for a
  ``ValueError`` (model, dtype or geometry mismatch), 500 otherwise;
- ``GET /health`` → ``health()`` (a stage's ``health()`` by default) as
  JSON;
- with ``stage=`` (``comm/stage_worker.py`` ``PipelineStageWorker``), the
  pipeline-session routes: ``POST /inference/create_session`` (JSON
  ``{"session_id"}`` → the stage's answer; 400 without a session id),
  ``POST /inference/close`` (JSON ``{"session_id"}`` → ``{"status":
  "closed"}``) and ``POST /inference/forward`` (a ``comm/wire.py``
  message with meta ``session_id`` / ``kv_len_after`` and tensors ``x`` /
  ``positions`` → a message of the stage's outputs; 400 for a message
  that does not unpack, 404 for an unknown session or a missing key, 507
  when the stage's blocks run out, 500 for anything else). Without a
  stage they answer 404: a PD receiver is not a pipeline stage.

Bodies are read by ``Content-Length`` in full (a llama3-8b bf16 handoff of a
600-token prompt is ~79 MB). ``port=0`` binds a free port (:attr:`port`).
Handlers run on the server's threads; the worker's receiver routes engine
work to the batcher's executor, so no handler thread touches an engine's
device state; a stage's forwards may run on several handler threads at
once (``comm/stage_worker.py``). A plane without a stage loads neither
the stage worker nor the tensor message.
"""

from __future__ import annotations

import http.client
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Mapping, Optional
from urllib.parse import urlsplit

from distributed_gpu_inference_torch.worker.api_client import Response


#: errors of the transport itself (connection refused or reset, timeouts,
#: a malformed response, an injected drop) — a push retries these
TRANSPORT_ERRORS = (OSError, http.client.HTTPException)

_SESSION_ROUTES = ("/inference/create_session", "/inference/close", "/inference/forward")


class HTTPStatusError(Exception):
    """A data-plane call answered an error status; ``response`` holds it."""

    def __init__(self, response: Response, what: str = "") -> None:
        super().__init__(f"{what} answered HTTP {response.status_code}: "
                         f"{response.text[:200]}".strip())
        self.response = response


def post_bytes(url: str, body: Optional[bytes], timeout: float,
               headers: Optional[Mapping[str, str]] = None,
               method: str = "POST") -> Response:
    """POST ``body`` to ``url`` (or send ``method`` with it) on a fresh
    ``http.client`` connection (the socket timeout applies to each read and
    write) → the status and the whole response body."""
    parts = urlsplit(url)
    cls = (http.client.HTTPSConnection if parts.scheme == "https"
           else http.client.HTTPConnection)
    conn = cls(parts.hostname, parts.port, timeout=timeout)
    try:
        conn.request(method, parts.path or "/", body=body, headers={
            "Content-Type": "application/octet-stream", **(headers or {})})
        r = conn.getresponse()
        return Response(r.status, r.read())
    finally:
        conn.close()


class HTTPPoster:
    """The client a handoff push goes through: ``post(url, content,
    headers, timeout)`` → :class:`Response` (one connection a call)."""

    def post(self, url: str, content: bytes,
             headers: Optional[Mapping[str, str]] = None,
             timeout: Optional[float] = None) -> Response:
        return post_bytes(url, content, timeout or 60.0, headers)


class DataPlaneServer:
    """Threading HTTP front of one PD engine's KV routes, or of one
    pipeline stage (``stage=``)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 stage: Any = None,
                 health: Optional[Callable[[], Dict[str, Any]]] = None,
                 kv_receiver: Optional[Callable[[bytes], Dict[str, Any]]] = None,
                 kv_exporter: Optional[Callable[[bytes], bytes]] = None) -> None:
        self.host = host
        self._want_port = port
        self.stage = stage
        self.health = health or (stage.health if stage is not None
                                 else (lambda: {"status": "ok"}))
        self.kv_receiver = kv_receiver
        self.kv_exporter = kv_exporter
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        assert self._httpd is not None, "data plane not started"
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def _route(self, method: str, path: str, body: bytes):
        """→ (status, content type, body bytes)."""
        def js(status: int, obj: Any):
            return status, "application/json", json.dumps(obj).encode()

        path = path.split("?")[0]
        if method == "GET" and path == "/health":
            return js(200, self.health())
        if method == "POST" and path in _SESSION_ROUTES and self.stage is not None:
            return self._session_route(path, body, js)
        if method != "POST" or path in _SESSION_ROUTES:
            return js(404, {"detail": "not found (a PD KV data plane, not a pipeline stage)"})
        if path == "/kv/transfer":
            if self.kv_receiver is None:
                return js(501, {"detail": "this endpoint is not a KV receiver"})
            try:
                return js(200, self.kv_receiver(body))
            except Exception as exc:  # noqa: BLE001 — answered as the JAX plane does
                return js(500, {"detail": str(exc)})
        if path == "/kv/export":
            if self.kv_exporter is None:
                return js(501, {"detail": "this endpoint is not a KV exporter"})
            try:
                return 200, "application/octet-stream", self.kv_exporter(body)
            except ValueError as exc:
                return js(400, {"detail": str(exc)})
            except Exception as exc:  # noqa: BLE001
                return js(500, {"detail": str(exc)})
        return js(404, {"detail": "not found"})

    def _session_route(self, path: str, body: bytes, js):
        """The stage's three routes, answered as the JAX plane answers.
        ``self.stage`` is a ``comm/stage_worker.py`` ``PipelineStageWorker``
        or anything with its ``create_session`` / ``close_session`` /
        ``forward``."""
        from distributed_gpu_inference_torch.comm.stage_worker import StageOutOfBlocksError
        from distributed_gpu_inference_torch.comm.wire import pack_message, unpack_message

        if path != "/inference/forward":
            try:
                sid = json.loads(body).get("session_id")
            except Exception as exc:  # noqa: BLE001 — an unreadable body is a 500 in JAX too
                return js(500, {"detail": str(exc)})
            if path == "/inference/close":
                self.stage.close_session(sid or "")
                return js(200, {"status": "closed"})
            if not sid:
                return js(400, {"detail": "session_id required"})
            return js(200, self.stage.create_session(sid))
        try:
            meta, tensors = unpack_message(body)
        except ValueError as exc:
            return js(400, {"detail": str(exc)})
        try:
            out = self.stage.forward(meta["session_id"], tensors["x"], tensors["positions"],
                                     int(meta["kv_len_after"]))
        except KeyError as exc:
            return js(404, {"detail": str(exc)})
        except StageOutOfBlocksError as exc:
            return js(507, {"detail": str(exc)})
        except Exception as exc:  # noqa: BLE001 — answered as the JAX plane does
            return js(500, {"detail": str(exc)})
        return 200, "application/octet-stream", pack_message(
            {"session_id": meta["session_id"]}, out)

    def start(self) -> None:
        plane = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a: Any) -> None:
                pass

            def _serve(self, method: str) -> None:
                n = self.headers.get("Content-Length")
                body = b""
                if n is not None:
                    body = self.rfile.read(int(n))
                    if len(body) != int(n):
                        self.close_connection = True
                        return          # the peer hung up mid-body
                elif method == "POST":
                    status, ctype, data = 411, "application/json", \
                        b'{"detail": "Content-Length required"}'
                    self._reply(status, ctype, data)
                    return
                self._reply(*plane._route(method, self.path, body))

            def _reply(self, status: int, ctype: str, data: bytes) -> None:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self) -> None:
                self._serve("GET")

            def do_POST(self) -> None:
                self._serve("POST")

        self._httpd = ThreadingHTTPServer((self.host, self._want_port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="data-plane", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        self._httpd = self._thread = None
