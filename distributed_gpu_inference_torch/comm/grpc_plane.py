"""The gRPC data plane of the port, on the standard library: gRPC's HTTP/2
protocol over ``comm/h2.py``, the proto3 codec of ``comm/pb.py``.

The port of ``distributed_gpu_inference_tpu/comm/grpc_plane.py`` (grpcio
there; the card's machine has none). It serves and calls the service
``dgi_tpu.dataplane.v1.PipelineDataPlane`` of ``proto/inference.proto``, and
a grpcio peer cannot tell it from the JAX plane:

- **Requests.** ``:method POST``, ``:scheme http``, ``:path
  /dgi_tpu.dataplane.v1.PipelineDataPlane/<Method>``, ``content-type
  application/grpc``, ``te trailers`` and ``grpc-timeout`` (units H M S m
  u n).
- **Messages.** A 5-byte prefix (a compressed flag and a length) before
  each message. This side sends ``identity``; ``gzip`` / ``deflate`` from a
  peer are read with ``zlib``. Both sides refuse a message past
  :data:`MAX_MESSAGE_BYTES` (grpcio's default, 4 MiB) with
  ``RESOURCE_EXHAUSTED`` and grpcio's wording.
- **Replies.** Headers, the messages, then trailers with ``grpc-status`` and
  a percent-encoded ``grpc-message``; an error before any message is
  trailers-only. An unknown method answers ``UNIMPLEMENTED``.
- **Cancellation and deadlines.** A cancel is ``RST_STREAM CANCEL``; an
  expired deadline gives ``DEADLINE_EXCEEDED`` at the client and cancels the
  server's context.

:class:`GrpcDataPlane`, :class:`GrpcStageClient` and :class:`ForwardStream`
have the JAX names and behaviour, faults included: the health answer reads
``layer_start`` / ``layer_end``, which a stage's ``health()`` does not
return, so both planes answer 0 for them (ROADMAP §3 item 4). Tensors ride
as ``utils/serialization.py`` TPUT frames, zstd-compressed as the JAX
plane's are (level 3 for payloads of 4,096 bytes or more, where smaller),
so the 4 MiB receive limit falls on the compressed message. The client's
forward and transfer go through the fault seams ``comm.grpc.forward`` and
``comm.grpc.transfer_kv`` (``testing/faults.py`` ``wrap_rpc``).
"""

from __future__ import annotations

import enum
import heapq
import itertools
import math
import socket
import threading
import time
import zlib
from concurrent import futures
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from distributed_gpu_inference_torch.comm import h2, pb
from distributed_gpu_inference_torch.testing import faults as _faults
from distributed_gpu_inference_torch.utils.serialization import deserialize, serialize

SERVICE = "dgi_tpu.dataplane.v1.PipelineDataPlane"
#: grpcio's default receive limit, on both sides
MAX_MESSAGE_BYTES = 4 * 1024 * 1024
_TIMEOUT_UNITS = {"H": 3600.0, "M": 60.0, "S": 1.0, "m": 1e-3, "u": 1e-6, "n": 1e-9}


class StatusCode(enum.IntEnum):
    """grpc's status codes, by name and number."""

    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    PERMISSION_DENIED = 7
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    ABORTED = 10
    OUT_OF_RANGE = 11
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14
    DATA_LOSS = 15
    UNAUTHENTICATED = 16


class RpcError(Exception):
    """A call that ended with a status other than OK."""

    def __init__(self, code: StatusCode, details: str = "") -> None:
        super().__init__(f"{code.name}: {details}")
        self._code = code
        self._details = details

    def code(self) -> StatusCode:
        return self._code

    def details(self) -> str:
        return self._details


class _Status(Exception):
    """Ends a call on the server with ``code`` and ``details``."""

    def __init__(self, code: StatusCode, details: str = "") -> None:
        super().__init__(details)
        self.code = code
        self.details = details


_TRANSPORT = (h2.StreamReset, h2.ConnectionClosed, h2.ProtocolError)
_HTTP_STATUS = {"400": StatusCode.INTERNAL, "401": StatusCode.UNAUTHENTICATED,
                "403": StatusCode.PERMISSION_DENIED, "404": StatusCode.UNIMPLEMENTED,
                "429": StatusCode.UNAVAILABLE, "502": StatusCode.UNAVAILABLE,
                "503": StatusCode.UNAVAILABLE, "504": StatusCode.UNAVAILABLE}


# ---------------------------------------------------------------- wire helpers

def encode_timeout(seconds: float) -> str:
    """``grpc-timeout``: at most 8 digits, rounded up."""
    for unit, scale in (("m", 1e3), ("S", 1.0), ("M", 1 / 60), ("H", 1 / 3600)):
        value = max(1, math.ceil(seconds * scale))
        if value < 10 ** 8:
            return f"{value}{unit}"
    return "99999999H"


def decode_timeout(text: str) -> float:
    if not 2 <= len(text) <= 9 or text[-1] not in _TIMEOUT_UNITS or not text[:-1].isdigit():
        raise ValueError(f"bad grpc-timeout {text!r}")
    return int(text[:-1]) * _TIMEOUT_UNITS[text[-1]]


def quote_message(text: str) -> str:
    """Percent-encode ``grpc-message``: bytes outside 0x20-0x7E and '%'."""
    return "".join(chr(b) if 0x20 <= b <= 0x7E and b != 0x25 else f"%{b:02X}"
                   for b in text.encode("utf-8"))


def unquote_message(text: str) -> str:
    raw = text.encode("utf-8", "surrogateescape")
    out, i = bytearray(), 0
    while i < len(raw):
        if raw[i] == 0x25 and _is_hex(raw[i + 1:i + 3]):
            out.append(int(raw[i + 1:i + 3], 16))
            i += 3
        else:
            out.append(raw[i])
            i += 1
    return out.decode("utf-8", "replace")


def _is_hex(b: bytes) -> bool:
    return len(b) == 2 and all(c in b"0123456789abcdefABCDEF" for c in b)


def _send_message(stream: h2.Stream, message: bytes, end_stream: bool = False,
                  deadline: Optional[float] = None) -> None:
    """The 5-byte prefix (uncompressed, the length) and ``message``, not
    copied into one buffer."""
    stream.send_data(b"\x00" + len(message).to_bytes(4, "big"), deadline=deadline)
    stream.send_data(message, end_stream=end_stream, deadline=deadline)


def _decompress(body: bytes, encoding: str) -> bytes:
    if encoding == "gzip":
        return zlib.decompress(body, 16 + zlib.MAX_WBITS)
    if encoding == "deflate":
        return zlib.decompress(body)
    raise _Status(StatusCode.UNIMPLEMENTED,
                  f"Compressed message with encoding {encoding!r} is not supported")


def _read_message(stream: h2.Stream, deadline: Optional[float], side: str,
                  encoding: str = "identity") -> Optional[bytes]:
    """The next message of ``stream``; None at its end. Raises
    :class:`_Status` for a message past the limit (the stream is reset)."""
    prefix = stream.read_exact(5, deadline)
    if prefix is None:
        return None
    n = int.from_bytes(prefix[1:5], "big")
    if n > MAX_MESSAGE_BYTES:
        raise _Status(StatusCode.RESOURCE_EXHAUSTED,
                      f"{side}: Received message larger than max ({n} vs. {MAX_MESSAGE_BYTES})")
    body = stream.read_exact(n, deadline) if n else b""
    if body is None:
        raise h2.ProtocolError(h2.PROTOCOL_ERROR, "stream ended inside a message")
    if prefix[0] & 1:
        body = _decompress(body, encoding)
    return body


def _trailers_only(headers: List[Tuple[str, str]]) -> bool:
    """A reply whose first header block carries the status: no message."""
    return any(k == "grpc-status" for k, _ in headers)


def _status_of(stream: h2.Stream) -> Optional[Tuple[StatusCode, str]]:
    """The status the peer sent (in trailers, or a trailers-only reply)."""
    for block in (stream.trailers, stream.headers):
        if block:
            fields = dict(block)
            if "grpc-status" in fields:
                try:
                    code = StatusCode(int(fields["grpc-status"]))
                except ValueError:
                    code = StatusCode.UNKNOWN
                return code, unquote_message(fields.get("grpc-message", ""))
    return None


def _transport_error(stream: h2.Stream, exc: BaseException) -> RpcError:
    """The RpcError a failed stream ends a call with: the peer's status
    where it sent one before the reset, else one named after the fault."""
    status = _status_of(stream)
    if status is not None:
        return RpcError(*status)
    if isinstance(exc, h2.StreamReset):
        if exc.code == h2.REFUSED_STREAM:
            return RpcError(StatusCode.UNAVAILABLE, "Stream refused by the server")
        if exc.code == h2.CANCEL:
            return RpcError(StatusCode.CANCELLED, "Received RST_STREAM with error code 8")
        return RpcError(StatusCode.INTERNAL, f"Received RST_STREAM with error code {exc.code}")
    if isinstance(exc, h2.ConnectionClosed):
        return RpcError(StatusCode.UNAVAILABLE, f"Connection lost: {exc}")
    return RpcError(StatusCode.INTERNAL, str(exc))


def _tensor_msg(a: Any) -> Dict[str, bytes]:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a, order="C"))
    return {"frame": serialize(t, compress=True)}


def _tensor_arr(msg: Optional[Dict[str, Any]]) -> Optional[torch.Tensor]:
    if not msg or not msg.get("frame"):
        return None
    return deserialize(msg["frame"])


# ---------------------------------------------------------------- server

class ServicerContext:
    """What a handler gets beside its request (the grpcio names the JAX
    handlers use)."""

    def __init__(self, stream: h2.Stream) -> None:
        self._stream = stream
        self._cancelled = False
        # one writer of the call's frames at a time: the handler's replies,
        # or the trailers of the deadline or of a stop
        self._lock = threading.Lock()
        self.headers_sent = False
        self.done = False

    def abort(self, code: StatusCode, details: str) -> None:
        raise _Status(code, details)

    def is_active(self) -> bool:
        return not self._cancelled and not self.done


class _Deadlines:
    """One thread that calls ``expire(ctx)`` for each server context whose
    deadline passed while it was active."""

    def __init__(self, expire: Callable[[ServicerContext], None]) -> None:
        self._expire = expire
        self._heap: List[Tuple[float, int, ServicerContext]] = []
        self._cv = threading.Condition()
        self._count = itertools.count()
        self._stopped = False
        self._thread = threading.Thread(target=self._run, name="grpc-deadlines", daemon=True)
        self._thread.start()

    def watch(self, ctx: ServicerContext, deadline: float) -> None:
        with self._cv:
            heapq.heappush(self._heap, (deadline, next(self._count), ctx))
            self._cv.notify()

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._heap.clear()
            self._cv.notify()

    def _run(self) -> None:
        with self._cv:
            while not self._stopped:
                if not self._heap:
                    self._cv.wait()
                    continue
                when, _, ctx = self._heap[0]
                left = when - time.monotonic()
                if left > 0:
                    self._cv.wait(left)
                    continue
                heapq.heappop(self._heap)
                if ctx.is_active():
                    self._expire(ctx)


class GrpcDataPlane:
    """gRPC front for one stage worker (and optionally a PD KV receiver):
    the behaviour of ``comm/data_plane.py`` ``DataPlaneServer`` on another
    transport. The port is bound at construction (:attr:`port`); calls
    run on a pool of ``max_workers`` threads, a call holding its thread
    for its whole life, as grpcio's synchronous server does."""

    def __init__(self, stage: Any, host: str = "0.0.0.0", port: int = 0,
                 kv_receiver: Optional[Callable[[bytes], Dict[str, Any]]] = None,
                 max_workers: int = 8) -> None:
        self.stage = stage
        self.kv_receiver = kv_receiver
        # the engine/stage is single-threaded — serialize compute calls
        self._stage_lock = threading.Lock()
        self._pool = futures.ThreadPoolExecutor(max_workers=max_workers,
                                                thread_name_prefix="grpc-plane")
        self._listener = socket.create_server((host, port), backlog=64)
        self.port = self._listener.getsockname()[1]
        self._lock = threading.Condition()
        self._conns: List[h2.Connection] = []
        self._calls: Dict[h2.Stream, ServicerContext] = {}   # accepted, not finished
        self._stopped = False
        self._deadlines: Optional[_Deadlines] = None
        self._accept_thread: Optional[threading.Thread] = None
        u = "unary"
        self._methods = {
            f"/{SERVICE}/{name}": spec for name, spec in {
                "CreateSession": (u, self._create_session, pb.CREATE_SESSION_REQUEST,
                                  pb.CREATE_SESSION_RESPONSE),
                "Forward": (u, self._forward, pb.FORWARD_REQUEST, pb.FORWARD_RESPONSE),
                "StreamForward": ("stream", self._stream_forward, pb.FORWARD_REQUEST,
                                  pb.FORWARD_RESPONSE),
                "TransferKVCache": (u, self._transfer_kv, pb.TRANSFER_KV_REQUEST,
                                    pb.TRANSFER_KV_RESPONSE),
                "CloseSession": (u, self._close_session, pb.CLOSE_SESSION_REQUEST,
                                 pb.CLOSE_SESSION_RESPONSE),
                "HealthCheck": (u, self._health, pb.HEALTH_REQUEST, pb.HEALTH_RESPONSE),
            }.items()}

    # ------------------------------------------------------------ handlers

    def _create_session(self, request, context):
        out = self.stage.create_session(request["session_id"])
        return {"session_id": out.get("session_id", request["session_id"]),
                "existing": bool(out.get("existing", False))}

    def _do_forward(self, request, context):
        from distributed_gpu_inference_torch.comm.stage_worker import StageOutOfBlocksError

        x = _tensor_arr(request["x"])
        positions = _tensor_arr(request["positions"])
        if x is None or positions is None:
            context.abort(StatusCode.INVALID_ARGUMENT, "x and positions tensors required")
        try:
            with self._stage_lock:
                out = self.stage.forward(request["session_id"], x, positions,
                                         int(request["kv_len_after"]))
        except KeyError as exc:
            context.abort(StatusCode.NOT_FOUND, str(exc))
        except StageOutOfBlocksError as exc:
            context.abort(StatusCode.RESOURCE_EXHAUSTED, str(exc))
        resp: Dict[str, Any] = {"session_id": request["session_id"]}
        if "hidden" in out:
            resp["hidden"] = _tensor_msg(out["hidden"])
        if "logits" in out:
            resp["logits"] = _tensor_msg(out["logits"])
        return resp

    def _forward(self, request, context):
        return self._do_forward(request, context)

    def _stream_forward(self, request_iterator, context):
        """Bidi stream: one response per request, in order — a pipeline
        session's whole decode runs on one HTTP/2 stream."""
        for request in request_iterator:
            yield self._do_forward(request, context)

    def _transfer_kv(self, request, context):
        if self.kv_receiver is None:
            context.abort(StatusCode.UNIMPLEMENTED, "this endpoint is not a KV receiver")
        try:
            result = self.kv_receiver(request["handoff"])
        except Exception as exc:  # noqa: BLE001 — answered as the JAX plane does
            context.abort(StatusCode.INTERNAL, str(exc))
        return {"slot": int(result.get("slot", -1)),
                "bytes_received": len(request["handoff"])}

    def _close_session(self, request, context):
        self.stage.close_session(request["session_id"])
        return {"status": "closed"}

    def _health(self, request, context):
        # the stage answers "layer_range", so layer_start / layer_end are
        # 0 here, as in the JAX plane (ROADMAP §3 item 4)
        h = self.stage.health()
        return {
            "status": h.get("status", "ok"),
            "layer_start": int(h.get("layer_start", 0)),
            "layer_end": int(h.get("layer_end", 0)),
            "is_first": bool(h.get("is_first", False)),
            "is_last": bool(h.get("is_last", False)),
            "active_sessions": int(h.get("active_sessions", 0)),
            "free_blocks": int(h.get("free_blocks", 0)),
        }

    # ------------------------------------------------------------ transport

    def _accept_loop(self) -> None:
        while True:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            with self._lock:
                if self._stopped:
                    sock.close()
                    return
                self._conns = [c for c in self._conns if not c.closed]
                conn = h2.Connection(sock, client=False, on_stream=self._on_stream,
                                     name="grpc-plane-conn")
                self._conns.append(conn)
            conn.start()

    def _on_stream(self, stream: h2.Stream) -> None:
        """A new call (on the connection's reader thread): to the pool."""
        headers = stream.headers or []
        fields = dict(headers)
        deadline = None
        if "grpc-timeout" in fields:
            try:
                deadline = time.monotonic() + decode_timeout(fields["grpc-timeout"])
            except ValueError:
                pass
        ctx = ServicerContext(stream)
        with self._lock:
            if self._stopped:
                stream.reset(h2.REFUSED_STREAM)
                return
            self._calls[stream] = ctx
        if deadline is not None and self._deadlines is not None:
            self._deadlines.watch(ctx, deadline)
        try:
            self._pool.submit(self._serve, stream, ctx, fields, deadline)
        except RuntimeError:            # the pool shut down under us
            self._done(stream, ctx)

    def _serve(self, stream: h2.Stream, ctx: ServicerContext, fields: Dict[str, str],
               deadline: Optional[float]) -> None:
        try:
            method = self._methods.get(fields.get(":path", ""))
            if method is None:
                raise _Status(StatusCode.UNIMPLEMENTED, "Method not found!")
            kind, fn, req_spec, resp_spec = method
            encoding = fields.get("grpc-encoding", "identity")
            if kind == "unary":
                raw = _read_message(stream, deadline, "SERVER", encoding)
                if raw is None:
                    raise _Status(StatusCode.INTERNAL, "Missing request message")
                request = pb.decode(req_spec, raw)
                try:
                    response = fn(request, ctx)
                except (_Status,) + _TRANSPORT:
                    raise
                except Exception as exc:  # noqa: BLE001 — grpcio's answer
                    raise _Status(StatusCode.UNKNOWN,
                                  f"Exception calling application: {exc}") from None
                self._send(stream, ctx, pb.encode(resp_spec, response))
            else:
                def requests() -> Iterator[Dict[str, Any]]:
                    while True:
                        raw = _read_message(stream, None, "SERVER", encoding)
                        if raw is None:
                            return
                        yield pb.decode(req_spec, raw)

                try:
                    for response in fn(requests(), ctx):
                        self._send(stream, ctx, pb.encode(resp_spec, response))
                except (_Status,) + _TRANSPORT:
                    raise
                except Exception as exc:  # noqa: BLE001 — grpcio's answer
                    raise _Status(StatusCode.UNKNOWN,
                                  f"Exception iterating responses: {exc}") from None
            self._finish(stream, ctx, StatusCode.OK, "")
        except _Status as st:
            self._finish(stream, ctx, st.code, st.details)
        except _TRANSPORT + (TimeoutError,):
            ctx._cancelled = True       # the client is gone: nothing to answer
        finally:
            self._done(stream, ctx)

    def _send(self, stream: h2.Stream, ctx: ServicerContext, message: bytes) -> None:
        with ctx._lock:
            if ctx.done:
                raise h2.StreamReset(h2.CANCEL, "the call already ended")
            if not ctx.headers_sent:
                stream.send_headers([(":status", "200"),
                                     ("content-type", "application/grpc"),
                                     ("grpc-accept-encoding", "identity,deflate,gzip")])
                ctx.headers_sent = True
            _send_message(stream, message)

    def _finish(self, stream: h2.Stream, ctx: ServicerContext, code: StatusCode,
                details: str, wait: bool = True) -> None:
        """Trailers (trailers-only before any message); a client still
        sending is then told to stop (RST_STREAM NO_ERROR). ``wait=False``
        gives up where the handler is sending a reply."""
        if not ctx._lock.acquire(blocking=wait):
            return
        try:
            if ctx.done or ctx._cancelled:
                return
            ctx.done = True
            trailers = [("grpc-status", str(int(code)))]
            if details:
                trailers.append(("grpc-message", quote_message(details)))
            if not ctx.headers_sent:
                trailers = [(":status", "200"), ("content-type", "application/grpc")] + trailers
                ctx.headers_sent = True
            stream.send_headers(trailers, end_stream=True)
            if not stream.remote_closed:
                stream.reset(h2.NO_ERROR)
        except _TRANSPORT:
            pass
        finally:
            ctx._lock.release()

    def _expire(self, ctx: ServicerContext) -> None:
        """The deadline passed: the client hears DEADLINE_EXCEEDED (its own
        clock says so too) and the handler's context turns inactive."""
        self._finish(ctx._stream, ctx, StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded",
                     wait=False)
        ctx._cancelled = True

    def _done(self, stream: h2.Stream, ctx: ServicerContext) -> None:
        stream.release()
        with self._lock:
            self._calls.pop(stream, None)
            self._lock.notify_all()

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        self._deadlines = _Deadlines(self._expire)
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               name="grpc-plane-accept", daemon=True)
        self._accept_thread.start()

    def stop(self, grace: Optional[float] = 1.0) -> None:
        """GOAWAY to every client, then up to ``grace`` seconds for the
        calls in flight; those still running are cancelled as grpcio
        cancels them (``UNAVAILABLE``, "Cancelling all calls") and the
        connections closed."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            conns = list(self._conns)
        try:
            self._listener.shutdown(socket.SHUT_RDWR)   # wakes the accept
        except OSError:
            pass
        self._listener.close()
        for c in conns:
            c.send_goaway()
        end = time.monotonic() + (grace or 0.0)
        with self._lock:
            while self._calls and time.monotonic() < end:
                self._lock.wait(end - time.monotonic())
            left = list(self._calls.items())
        for stream, ctx in left:
            self._finish(stream, ctx, StatusCode.UNAVAILABLE, "Cancelling all calls",
                         wait=False)
            ctx._cancelled = True
        # every byte sent, then FIN, then a moment for each client to read
        # it all and close (grpcio closes once GOAWAY left it no stream)
        for c in conns:
            c.flush(0.5)
            c.half_close()
        end = time.monotonic() + 0.5
        for c in conns:
            c.wait_closed(end - time.monotonic())
            c.close("server stopped")
        self._pool.shutdown(wait=False, cancel_futures=True)
        if self._deadlines is not None:
            self._deadlines.stop()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)


# ---------------------------------------------------------------- client

class _Channel:
    """One HTTP/2 connection to ``target`` (``host:port``), made on first
    use and again after the server went away."""

    def __init__(self, target: str) -> None:
        host, _, port = target.rpartition(":")
        self.target = target
        self.host = host.strip("[]") or "127.0.0.1"
        self.port = int(port)
        self._lock = threading.Lock()
        self._conn: Optional[h2.Connection] = None
        self._old: List[h2.Connection] = []
        self._closed = False

    def _connection(self) -> h2.Connection:
        with self._lock:
            if self._closed:
                raise ValueError("Cannot invoke RPC on closed channel!")
            if self._conn is None or not self._conn.usable:
                if self._conn is not None:
                    self._old = [c for c in self._old if not c.closed] + [self._conn]
                try:
                    self._conn = h2.connect(self.host, self.port, name="grpc-client")
                except OSError as exc:
                    self._conn = None
                    raise RpcError(StatusCode.UNAVAILABLE,
                                   f"failed to connect to all addresses; last error: {exc}")
            return self._conn

    def start(self, method: str, timeout: Optional[float]) -> h2.Stream:
        headers = [(":method", "POST"), (":scheme", "http"), (":path", f"/{SERVICE}/{method}"),
                   (":authority", self.target), ("te", "trailers"),
                   ("content-type", "application/grpc"),
                   ("grpc-accept-encoding", "identity,deflate,gzip"),
                   ("user-agent", "dgi-torch-grpc/1")]
        if timeout is not None:
            headers.append(("grpc-timeout", encode_timeout(timeout)))
        for attempt in (0, 1):
            conn = self._connection()
            try:
                return conn.open_stream(headers)
            except _TRANSPORT:
                if attempt:             # a connection that went away as we opened
                    raise RpcError(StatusCode.UNAVAILABLE, "connection went away")
        raise AssertionError("unreachable")

    def close(self) -> None:
        with self._lock:
            self._closed = True
            conns = [c for c in self._old + [self._conn] if c is not None]
            self._conn, self._old = None, []
        for c in conns:
            c.close("channel closed")


def _read_reply(stream: h2.Stream, deadline: Optional[float]) -> Optional[bytes]:
    """The reply's one message, or None for a reply without one (its
    status then says why)."""
    headers = stream.wait_headers(deadline)
    if _trailers_only(headers):
        return None
    fields = dict(headers)
    status = fields.get(":status", "200")
    if status != "200":
        # gRPC's HTTP-to-status table
        raise _Status(_HTTP_STATUS.get(status, StatusCode.UNKNOWN), f"HTTP status {status}")
    return _read_message(stream, deadline, "CLIENT", fields.get("grpc-encoding", "identity"))


class GrpcStageClient:
    """Client for one remote stage over gRPC. Mirrors the call surface the
    HTTP pipeline session uses, plus a persistent streaming channel."""

    def __init__(self, target: str, timeout_s: float = 30.0) -> None:
        self.timeout_s = timeout_s
        self.channel = _Channel(target)

    def _unary(self, method: str, req_spec, resp_spec, msg: Dict[str, Any],
               timeout: Optional[float]) -> Dict[str, Any]:
        deadline = None if timeout is None else time.monotonic() + timeout
        body = pb.encode(req_spec, msg)
        stream = self.channel.start(method, timeout)
        try:
            try:
                _send_message(stream, body, end_stream=True, deadline=deadline)
            except h2.StreamReset:
                pass                    # answered before it took the request: read why
            reply = _read_reply(stream, deadline)
            if reply is not None:
                stream.wait_closed(deadline)
            status = _status_of(stream) or (StatusCode.UNKNOWN, "no grpc-status in the reply")
            if status[0] != StatusCode.OK:
                raise RpcError(*status)
            if reply is None:
                raise RpcError(StatusCode.INTERNAL, "no message in a unary reply")
            return pb.decode(resp_spec, reply)
        except _Status as st:
            stream.reset(h2.CANCEL)
            raise RpcError(st.code, st.details) from None
        except TimeoutError:
            stream.reset(h2.CANCEL)
            raise RpcError(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded") from None
        except _TRANSPORT as exc:
            raise _transport_error(stream, exc) from None
        finally:
            stream.release()

    def create_session(self, session_id: str) -> Dict[str, Any]:
        return self._unary("CreateSession", pb.CREATE_SESSION_REQUEST,
                           pb.CREATE_SESSION_RESPONSE, {"session_id": session_id},
                           self.timeout_s)

    def forward(self, session_id: str, x: Any, positions: Any,
                kv_len_after: int) -> Dict[str, torch.Tensor]:
        # chaos seam: drop/delay this hop like a flaky cross-host link
        # (no-op passthrough without an installed FaultPlan)
        resp = _faults.wrap_rpc(
            "comm.grpc.forward",
            lambda: self._unary("Forward", pb.FORWARD_REQUEST, pb.FORWARD_RESPONSE, {
                "session_id": session_id,
                "kv_len_after": int(kv_len_after),
                "x": _tensor_msg(x),
                "positions": _tensor_msg(positions),
            }, self.timeout_s),
            session_id=session_id,
        )
        return self._unpack_forward(resp)

    def open_stream(self) -> "ForwardStream":
        return ForwardStream(self)

    def transfer_kv(self, handoff: bytes) -> Dict[str, Any]:
        resp = _faults.wrap_rpc(
            "comm.grpc.transfer_kv",
            lambda: self._unary("TransferKVCache", pb.TRANSFER_KV_REQUEST,
                                pb.TRANSFER_KV_RESPONSE, {"handoff": handoff}, self.timeout_s),
            size=len(handoff),
        )
        return {"slot": resp["slot"], "bytes_received": resp["bytes_received"]}

    def close_session(self, session_id: str) -> None:
        self._unary("CloseSession", pb.CLOSE_SESSION_REQUEST, pb.CLOSE_SESSION_RESPONSE,
                    {"session_id": session_id}, self.timeout_s)

    def health(self) -> Dict[str, Any]:
        return dict(self._unary("HealthCheck", pb.HEALTH_REQUEST, pb.HEALTH_RESPONSE, {},
                                self.timeout_s))

    def close(self) -> None:
        self.channel.close()

    def _unpack_forward(self, resp: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        hidden = _tensor_arr(resp.get("hidden"))
        if hidden is not None:
            out["hidden"] = hidden
        logits = _tensor_arr(resp.get("logits"))
        if logits is not None:
            out["logits"] = logits
        return out


class ForwardStream:
    """One bidi StreamForward stream: ``step()`` sends a hop and waits for
    its (in-order) response **up to the client timeout** — a hung remote
    stage cancels the call and raises ``TimeoutError`` instead of wedging
    the pipeline driver; ``close()`` half-closes, waits at most min(timeout,
    2 s) for the server to finish, then cancels."""

    def __init__(self, client: GrpcStageClient) -> None:
        self._client = client
        self._stream = client.channel.start("StreamForward", None)

    def step(self, session_id: str, x: Any, positions: Any,
             kv_len_after: int) -> Dict[str, torch.Tensor]:
        timeout = self._client.timeout_s
        deadline = time.monotonic() + timeout
        body = pb.encode(pb.FORWARD_REQUEST, {
            "session_id": session_id,
            "kv_len_after": int(kv_len_after),
            "x": _tensor_msg(x),
            "positions": _tensor_msg(positions),
        })
        st = self._stream
        try:
            _send_message(st, body, deadline=deadline)
            headers = st.wait_headers(deadline)
            raw = None if _trailers_only(headers) else _read_message(
                st, deadline, "CLIENT", dict(headers).get("grpc-encoding", "identity"))
        except TimeoutError:
            st.reset(h2.CANCEL)
            raise TimeoutError(f"StreamForward hop timed out after {timeout}s") from None
        except _Status as s:
            st.reset(h2.CANCEL)
            raise RpcError(s.code, s.details) from None
        except _TRANSPORT as exc:
            raise _transport_error(st, exc) from None
        if raw is None:
            status = _status_of(st)
            if status is not None and status[0] != StatusCode.OK:
                raise RpcError(*status)
            raise ConnectionError("StreamForward closed by remote")
        return self._client._unpack_forward(pb.decode(pb.FORWARD_RESPONSE, raw))

    def close(self) -> None:
        st = self._stream
        try:
            st.send_data(b"", end_stream=True)      # half-close
            st.wait_closed(time.monotonic() + min(self._client.timeout_s, 2.0))
        except TimeoutError:
            st.reset(h2.CANCEL)     # remote never finished: don't wait forever
        except _TRANSPORT:
            pass
        finally:
            st.release()

    def __enter__(self) -> "ForwardStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
