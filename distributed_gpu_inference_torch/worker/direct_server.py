"""Worker-hosted direct inference endpoint on the standard library.

The port of ``distributed_gpu_inference_tpu/worker/direct_server.py`` (which
runs on aiohttp) to ``http.server.ThreadingHTTPServer``: the card's machine
has no aiohttp, and the routes, admission, status codes and event framing
are the same, so clients of the JAX package (the SDK, httpx) read this one
unchanged.

- ``GET /health``, ``GET /status``
- ``POST /inference`` — ``{"type", "params"}`` → ``{"result": ...}``; 503
  while the worker is busy, draining or declines by load control (the
  client falls back to the control-plane queue); a ``hedge_key`` in params
  makes the request cancellable through ``POST /inference/cancel``
- ``POST /inference/stream`` — server-sent events over HTTP/1.1 chunked
  transfer, one ``id: <offset>`` / ``data: <json>`` event per chunk; a
  ``resume {stream_id, offset, text_offset}`` body adopts the stream's
  checkpoint (``worker.adopt_stream_checkpoint``) and splices the
  continuation at the client's offset.

The worker object supplies ``engines`` (task type → engine), ``state``,
``get_status()``, the claims ``try_begin_job`` / ``end_job`` and, for
engines that serve through a batcher, the shared claims
``try_begin_serving`` / ``end_serving``; optionally ``should_accept_job``,
``note_job_done``, ``adopt_stream_checkpoint`` and ``fault_tag``.

Fault seams (``testing/faults.py``, the JAX server's sites):
``worker.direct.request`` (``http_reject``) answers ``/inference`` with an
injected status or cuts its connection; ``worker.direct.stream``
(``stream_cut``) hard-closes a stream at an event, as a crashed worker
would.
"""

from __future__ import annotations

import asyncio
import json
import socket
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Tuple

from distributed_gpu_inference_torch.testing import faults as _faults

# params keys the server or the worker mints; a client never sets them
_RESERVED = ("_failover_ctx", "_cancel_evt")


class _Cut(Exception):
    """A fault seam decided to drop the connection without an answer."""


class _Reply(Exception):
    """An HTTP answer decided before the handler owns a claim."""

    def __init__(self, status: int, body: Dict[str, Any]) -> None:
        super().__init__(status)
        self.status = status
        self.body = body


class DirectServer:
    """Serves a worker's engines over local HTTP from a background thread;
    each request runs on a daemon thread of its own."""

    def __init__(self, worker: Any, host: str = "0.0.0.0",
                 port: int = 8471) -> None:
        self.worker = worker
        self.host = host
        self.port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.stats: Dict[str, Any] = {"requests": 0, "rejected": 0,
                                      "hedge_cancels": 0}
        # health telemetry drained by wire_stats(): request latencies (ms)
        # and served 5xx since the last drain
        self._stats_lock = threading.Lock()
        self._recent_ms: list = []
        self._new_errors = 0
        # hedged dispatch: in-flight requests that registered a hedge key,
        # cancellable at the next step boundary via POST /inference/cancel
        self._cancels: Dict[str, threading.Event] = {}
        # sockets of the streams in flight: stop() cuts them, as the death
        # of the process would
        self._streams: set = set()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """Bind (port 0 picks a free port, read back into ``port``) and
        serve from a daemon thread; returns once the socket listens."""
        server = self

        class Handler(_Handler):
            direct = server

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="direct-server",
            daemon=True,
        )
        self._thread.start()

    def stop(self) -> None:
        """Stop listening and cut every stream in flight: its client sees
        the connection drop with no terminating event and resumes from its
        offset elsewhere."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        with self._stats_lock:
            live = list(self._streams)
        for conn in live:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _fault_tag(self) -> str:
        """Per-worker context for the fault seams: a rule can target one
        replica (``match={"worker": "w1"}``); untagged workers match the
        empty string."""
        return str(getattr(self.worker, "fault_tag", "") or "")

    # -- admission -----------------------------------------------------------

    def _admit(self, body: Any, require_stream: bool = False
               ) -> Tuple[Any, Dict[str, Any], Callable[[float], None]]:
        """ONE admission pipeline for both inference routes (load-control
        caps hold whichever path a job takes) → ``(engine, body,
        release)`` with the worker CLAIMED; the caller owns the claim and
        must call ``release(started)``. Raises :class:`_Reply` otherwise.

        An engine serving through an active batcher takes a SHARED serving
        claim (concurrent requests join one batch, capped by the worker);
        everything else the exclusive IDLE→BUSY claim. Workers without the
        shared-claim surface always give the exclusive one."""
        if not isinstance(body, dict):
            raise _Reply(400, {"detail": "body must be a JSON object"})
        task_type = body.get("type", "llm")
        engine = self.worker.engines.get(task_type)
        if engine is None:
            raise _Reply(404, {"detail": f"task type {task_type!r} not loaded"})
        if require_stream and getattr(engine, "stream_inference", None) is None:
            raise _Reply(501, {"detail": f"engine for {task_type!r} does not stream"})
        params = body.get("params")
        if isinstance(params, dict):
            # the failover context and the cancel event are minted here or
            # by the worker: a forged checkpoint would drive the resume
            # path with arbitrary state, a forged event crash the batcher
            for k in list(params):
                if k in _RESERVED or k.startswith("_flight_"):
                    del params[k]
        accept = getattr(self.worker, "should_accept_job", None)
        if accept is not None and not accept({"type": task_type}):
            self.stats["rejected"] += 1
            raise _Reply(503, {"detail": "declined by load control"})
        serving = getattr(engine, "serving", None)
        begin_shared = getattr(self.worker, "try_begin_serving", None)
        is_pd = isinstance(params, dict) and params.get("pd_stage")
        if serving is not None and getattr(serving, "active", False) \
                and begin_shared is not None and not is_pd:
            claimed, end = begin_shared(), self.worker.end_serving
        else:
            claimed, end = self.worker.try_begin_job(), self.worker.end_job
        if not claimed:
            self.stats["rejected"] += 1
            raise _Reply(503, {"detail": f"worker {self.worker.state.value}"})
        self.stats["requests"] += 1

        def release(started: float) -> None:
            note = getattr(self.worker, "note_job_done", None)
            if note is not None:
                note(started)
            end()

        return engine, body, release

    # -- telemetry -----------------------------------------------------------

    def _record_sample(self, latency_ms: Optional[float] = None,
                       error: bool = False) -> None:
        """Accumulate one observation for the next drain; the sample buffer
        is bounded (old samples drop if nobody drains)."""
        with self._stats_lock:
            if latency_ms is not None:
                self._recent_ms.append(float(latency_ms))
                if len(self._recent_ms) > 512:
                    del self._recent_ms[:-256]
            if error:
                self._new_errors += 1

    def wire_stats(self) -> Dict[str, Any]:
        """Heartbeat ``engine_stats["direct"]`` channel: the latency
        samples and served-5xx count since the last call (deltas), and the
        CUMULATIVE hedge-cancel counter."""
        with self._stats_lock:
            recent = self._recent_ms
            self._recent_ms = []
            errors = self._new_errors
            self._new_errors = 0
        return {"recent_ms": recent, "new_errors": errors,
                "hedge_cancels": int(self.stats["hedge_cancels"])}

    # -- routes --------------------------------------------------------------

    def _inference(self, body: Any) -> Tuple[int, Dict[str, Any]]:
        t0 = time.time()   # before the seam: an injected delay is service time
        reject = _faults.http_reject("worker.direct.request",
                                     worker=self._fault_tag())
        if reject == 0:
            # the worker "dies" on this request: the handler hard-closes
            raise _Cut("fault injected: request cut")
        if reject is not None:
            # a flaky replica: the process is healthy, the answer a 5xx
            self.stats["rejected"] += 1
            self._record_sample(error=True)
            return reject, {"detail": "fault injected: flaky reply"}
        engine, body, release = self._admit(body)
        params = body.get("params") or {}
        hedge_key = None
        if isinstance(params, dict) and params.get("hedge_key"):
            # hedged dispatch: the client raced this request against another
            # replica; the loser is aborted at the next step boundary
            # through POST /inference/cancel instead of decoding to the end
            hedge_key = str(params.pop("hedge_key"))
            evt = threading.Event()
            params["_cancel_evt"] = evt
            self._cancels[hedge_key] = evt
        started = time.time()
        try:
            result = engine.inference(params)
        except Exception as exc:  # noqa: BLE001 - surface as a job error
            self._record_sample(error=True)
            return 500, {"detail": str(exc)}
        finally:
            release(started)
            if hedge_key is not None:
                self._cancels.pop(hedge_key, None)
        self._record_sample(latency_ms=(time.time() - t0) * 1000.0)
        return 200, {"result": result}

    def _inference_cancel(self, body: Any) -> Tuple[int, Dict[str, Any]]:
        """Hedge-loser abort: flips the event registered under the caller's
        ``hedge_key``. Idempotent; an unknown key (finished, or never
        started here) is a no-op 200 so racers never error out."""
        key = str((body if isinstance(body, dict) else {}).get("hedge_key") or "")
        evt = self._cancels.get(key) if key else None
        if evt is not None and not evt.is_set():
            evt.set()
            self.stats["hedge_cancels"] += 1
            return 200, {"cancelled": True}
        return 200, {"cancelled": False}

    def _open_stream(self, body: Any):
        """Admission and resume adoption of a stream → ``(engine, params,
        release, started)``; raises :class:`_Reply` (the claim released)."""
        engine, body, release = self._admit(body, require_stream=True)
        started = time.time()
        params = dict(body.get("params") or {})
        resume = body.get("resume") if isinstance(body.get("resume"), dict) else None
        stream_id = str((resume or {}).get("stream_id") or body.get("stream_id")
                        or uuid.uuid4().hex)
        if getattr(engine, "supports_failover", False):
            ctx: Dict[str, Any] = {"key": stream_id, "kind": "stream", "epoch": 0}
            if resume is not None:
                adopt = getattr(self.worker, "adopt_stream_checkpoint", None)
                adoption = None
                adopt_failed = adopt is None
                if adopt is not None:
                    try:
                        adoption = adopt(stream_id)
                    except Exception:  # noqa: BLE001 — control plane unreachable
                        adopt_failed = True
                if adoption is None:
                    release(started)
                    if adopt_failed:
                        # transient, not proof that no checkpoint exists: a
                        # 503 keeps the client's resume budget alive
                        raise _Reply(503, {"detail": "checkpoint adoption failed "
                                                     "(control plane unreachable)"})
                    raise _Reply(409, {"detail": f"no checkpoint for stream {stream_id}"})
                ctx["checkpoint"] = adoption.get("checkpoint")
                ctx["epoch"] = int(adoption.get("epoch") or 0)
                ctx["offset"] = int(resume.get("offset") or 0)
                ctx["text_offset"] = int(resume.get("text_offset") or 0)
            params["_failover_ctx"] = ctx
        elif resume is not None:
            release(started)
            raise _Reply(409, {"detail": "engine does not support stream resume"})
        return engine, params, release, started


def sse_event(chunk: Dict[str, Any]) -> bytes:
    """One server-sent event: ``id: <offset>`` when the chunk carries an
    offset (the Last-Event-ID idiom), then ``data: <json>``."""
    evt = b""
    if chunk.get("offset") is not None:
        evt += f"id: {chunk['offset']}\n".encode()
    return evt + f"data: {json.dumps(chunk)}\n\n".encode()


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # socket timeout: a client that stops sending its body or stops reading
    # a stream fails the call (a stream then cancels) instead of holding a
    # handler thread and its claim forever
    timeout = 120.0
    direct: DirectServer    # set on the subclass DirectServer.start builds

    def log_message(self, format: str, *args: Any) -> None:  # noqa: A002
        pass    # one line per request on stderr would drown a server's logs

    def _send_json(self, status: int, body: Dict[str, Any]) -> None:
        data = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(data)
        self.close_connection = True

    def _read_json(self) -> Any:
        try:
            n = int(self.headers.get("Content-Length") or 0)
            return json.loads(self.rfile.read(n) if n > 0 else b"")
        except ValueError:
            raise _Reply(400, {"detail": "invalid JSON"}) from None

    def do_GET(self) -> None:  # noqa: N802 - http.server's hook name
        if self.path == "/health":
            self._send_json(200, {"status": "ok", "ts": time.time()})
        elif self.path == "/status":
            self._send_json(200, self.direct.worker.get_status())
        else:
            self._send_json(404, {"detail": "not found"})

    def do_POST(self) -> None:  # noqa: N802 - http.server's hook name
        routes = {"/inference": self.direct._inference,
                  "/inference/cancel": self.direct._inference_cancel}
        try:
            body = self._read_json()
            if self.path == "/inference/stream":
                self._stream(*self.direct._open_stream(body))
                return
            route = routes.get(self.path)
            if route is None:
                raise _Reply(404, {"detail": "not found"})
            self._send_json(*route(body))
        except _Reply as reply:
            self._send_json(reply.status, reply.body)
        except _Cut:
            self._hard_close()

    def _hard_close(self) -> None:
        """Drop the connection with nothing more written, as a crashed
        process would."""
        self.close_connection = True
        try:
            self.wfile.flush()
        except OSError:
            pass
        try:
            self.connection.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    def _stream(self, engine: Any, params: Dict[str, Any],
                release: Callable[[float], None], started: float) -> None:
        """Write the engine's chunks as events. A write that fails because
        the client hung up ends the loop; closing the generator then sets
        the stream's cancel and WAITS for the engine to go quiet, so the
        claim is released only when the engine is idle."""
        self.close_connection = True
        with self.direct._stats_lock:
            self.direct._streams.add(self.connection)
        loop = asyncio.new_event_loop()
        agen = engine.stream_inference(params)
        try:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("X-Accel-Buffering", "no")
            self.send_header("Transfer-Encoding", "chunked")
            self.send_header("Connection", "close")
            self.end_headers()
            stream_id = str((params.get("_failover_ctx") or {}).get("key") or "")
            while True:
                try:
                    chunk = loop.run_until_complete(agen.__anext__())
                except StopAsyncIteration:
                    break
                if _faults.stream_cut("worker.direct.stream",
                                      stream_id=stream_id,
                                      worker=self.direct._fault_tag()):
                    # the worker "dies" mid-stream: an abrupt drop, no
                    # terminating chunk
                    self._hard_close()
                    return
                evt = sse_event(chunk)
                self.wfile.write(b"%x\r\n%s\r\n" % (len(evt), evt))
                self.wfile.flush()
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except OSError:
            pass    # the client went away mid-stream: aclose() aborts the run
        finally:
            with self.direct._stats_lock:
                self.direct._streams.discard(self.connection)
            loop.run_until_complete(agen.aclose())
            loop.run_until_complete(loop.shutdown_default_executor())
            loop.close()
            release(started)
