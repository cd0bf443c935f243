"""A small HTTP/1.1 server on asyncio: the part of ``aiohttp.web`` that the
control plane's handlers use, so ``server/app.py`` carries the JAX plane's
handler bodies over line for line without aiohttp (the card's machine has
none).

- :class:`Application`: a mapping for shared state, a :class:`Router`,
  middlewares, ``on_startup`` / ``on_cleanup`` hooks.
- :class:`Router`: ``add_get`` / ``add_post`` / ``add_put`` /
  ``add_delete`` with ``{name}`` path segments, matched in registration
  order as aiohttp matches them (a static path registered before
  ``{job_id}`` wins). An unknown path answers 404, a known path with
  another method 405 with ``Allow``, both as aiohttp's plain-text bodies.
- :class:`Request`: ``method``, ``path``, ``query``, ``headers``
  (case-insensitive), ``match_info``, ``remote``, ``app``, ``read()`` /
  ``text()`` / ``json()`` and ``can_read_body`` — which turns False once
  the body was read, as aiohttp's does.
- :class:`Response` and :func:`json_response` with aiohttp's bodies and
  ``Content-Type`` headers.
- :class:`Server`: binds (port 0 draws a free port, :attr:`Server.port`),
  serves every connection as its own task (keep-alive, ``Content-Length``
  or chunked request bodies), so a handler that long-polls holds up no
  other request; :meth:`Server.stop` is a hard stop: in-flight requests
  die with their connections.
- :func:`run_app`: the CLI's blocking serve loop.

A handler that raises answers 500 with aiohttp's body; middlewares see
every handler call, including the ones that raise.
"""

from __future__ import annotations

import asyncio
import json
import re
import signal
import socket
import sys
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qsl, unquote, urlsplit

Handler = Callable[["Request"], Awaitable["Response"]]

_REASONS = {
    100: "Continue", 200: "OK", 201: "Created", 202: "Accepted",
    204: "No Content", 400: "Bad Request", 401: "Unauthorized",
    403: "Forbidden", 404: "Not Found", 405: "Method Not Allowed",
    408: "Request Timeout", 409: "Conflict", 410: "Gone",
    413: "Payload Too Large", 422: "Unprocessable Entity", 423: "Locked",
    429: "Too Many Requests", 500: "Internal Server Error",
    501: "Not Implemented", 502: "Bad Gateway", 503: "Service Unavailable",
    504: "Gateway Timeout",
}
# largest request head and body the server reads
MAX_HEAD_BYTES = 64 * 1024
MAX_BODY_BYTES = 64 * 1024 * 1024


class Headers:
    """Case-insensitive, read-only header mapping (first value wins)."""

    def __init__(self, items: List[Tuple[str, str]]) -> None:
        self._map: Dict[str, str] = {}
        for k, v in items:
            self._map.setdefault(k.lower(), v)

    def get(self, key: str, default: Any = None) -> Any:
        return self._map.get(key.lower(), default)


class Request:
    def __init__(self, app: "Application", method: str, target: str,
                 headers: Headers, body: bytes, remote: Optional[str]) -> None:
        parts = urlsplit(target)
        self.app = app
        self.method = method
        self.path = unquote(parts.path)
        self.query: Dict[str, str] = {}
        for k, v in parse_qsl(parts.query, keep_blank_values=True):
            self.query.setdefault(k, v)
        self.headers = headers
        self.remote = remote
        self.match_info: Dict[str, str] = {}
        self._body = body
        self._consumed = False

    @property
    def can_read_body(self) -> bool:
        return bool(self._body) and not self._consumed

    async def read(self) -> bytes:
        self._consumed = True
        return self._body

    async def text(self) -> str:
        return (await self.read()).decode("utf-8")

    async def json(self) -> Any:
        return json.loads(await self.text())


class Response:
    def __init__(self, *, body: Optional[bytes] = None, status: int = 200,
                 text: Optional[str] = None,
                 headers: Optional[Dict[str, str]] = None,
                 content_type: Optional[str] = None,
                 charset: Optional[str] = None) -> None:
        if body is not None and text is not None:
            raise ValueError("body and text are not allowed together")
        self.status = int(status)
        self.reason = _REASONS.get(self.status, "Unknown")
        self.headers: Dict[str, str] = dict(headers or {})
        if text is not None:
            charset = charset or "utf-8"
            body = text.encode(charset)
            content_type = content_type or "text/plain"
        self.body = body if body is not None else b""
        if not any(k.lower() == "content-type" for k in self.headers):
            ct = content_type or "application/octet-stream"
            if charset:
                ct += f"; charset={charset}"
            self.headers["Content-Type"] = ct


def json_response(data: Any = None, *, status: int = 200,
                  headers: Optional[Dict[str, str]] = None) -> Response:
    return Response(text=json.dumps(data), status=status, headers=headers,
                    content_type="application/json")


def middleware(f: Callable[..., Awaitable[Response]]) -> Callable[..., Awaitable[Response]]:
    """aiohttp's middleware marker; every middleware here has its
    signature, so nothing is recorded."""
    return f


class Router:
    def __init__(self) -> None:
        self._routes: List[Tuple[str, "re.Pattern[str]", Handler]] = []

    @staticmethod
    def _compile(path: str) -> "re.Pattern[str]":
        out, pos = "", 0
        for m in re.finditer(r"\{(\w+)\}", path):
            out += re.escape(path[pos:m.start()]) + f"(?P<{m.group(1)}>[^{{}}/]+)"
            pos = m.end()
        return re.compile(out + re.escape(path[pos:]) + r"\Z")

    def add_route(self, method: str, path: str, handler: Handler) -> None:
        self._routes.append((method.upper(), self._compile(path), handler))

    def add_get(self, path: str, handler: Handler) -> None:
        self.add_route("GET", path, handler)
        self.add_route("HEAD", path, handler)

    def add_post(self, path: str, handler: Handler) -> None:
        self.add_route("POST", path, handler)

    def add_put(self, path: str, handler: Handler) -> None:
        self.add_route("PUT", path, handler)

    def add_delete(self, path: str, handler: Handler) -> None:
        self.add_route("DELETE", path, handler)

    def resolve(self, method: str, path: str
                ) -> Tuple[Optional[Handler], Dict[str, str], List[str]]:
        """(handler, match_info, allowed methods) of the first route whose
        path matches with this method; handler None when none does."""
        allowed: List[str] = []
        for m, pattern, handler in self._routes:
            hit = pattern.match(path)
            if hit is None:
                continue
            if m == method:
                return handler, {k: unquote(v) for k, v in hit.groupdict().items()}, []
            allowed.append(m)
        return None, {}, allowed


class Application:
    def __init__(self, middlewares: Tuple[Any, ...] = ()) -> None:
        self.router = Router()
        self.middlewares = list(middlewares)
        self.on_startup: List[Callable[["Application"], Awaitable[None]]] = []
        self.on_cleanup: List[Callable[["Application"], Awaitable[None]]] = []
        self._state: Dict[str, Any] = {}

    def __getitem__(self, key: str) -> Any:
        return self._state[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self._state[key] = value

    async def startup(self) -> None:
        for hook in self.on_startup:
            await hook(self)

    async def cleanup(self) -> None:
        for hook in self.on_cleanup:
            await hook(self)

    async def handle(self, request: Request) -> Response:
        handler, match_info, allowed = self.router.resolve(request.method, request.path)
        request.match_info = match_info
        if handler is None:
            if allowed:
                methods = ",".join(sorted(set(allowed)))
                inner: Handler = _static_error(405, {"Allow": methods})
            else:
                inner = _static_error(404)
        else:
            inner = handler
        for mw in reversed(self.middlewares):
            inner = _bind(mw, inner)
        try:
            return await inner(request)
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — a handler bug answers 500
            return Response(status=500, text="500 Internal Server Error\n\n"
                            "Server got itself in trouble")


def _static_error(status: int, headers: Optional[Dict[str, str]] = None) -> Handler:
    async def answer(request: Request) -> Response:
        return Response(status=status, headers=headers,
                        text=f"{status}: {_REASONS[status]}")
    return answer


def _bind(mw: Any, inner: Handler) -> Handler:
    async def call(request: Request) -> Response:
        return await mw(request, inner)
    return call


class _BadRequest(Exception):
    pass


async def _read_head(reader: asyncio.StreamReader) -> Optional[bytes]:
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as exc:
        if exc.partial.strip():
            raise _BadRequest("truncated request head") from exc
        return None
    except asyncio.LimitOverrunError as exc:
        raise _BadRequest("request head too large") from exc
    return head


async def _read_body(reader: asyncio.StreamReader, headers: Headers) -> bytes:
    if "chunked" in (headers.get("Transfer-Encoding") or "").lower():
        chunks: List[bytes] = []
        total = 0
        while True:
            line = await reader.readline()
            size = int(line.split(b";")[0].strip() or b"0", 16)
            if size == 0:
                while (await reader.readline()) not in (b"\r\n", b"\n", b""):
                    pass
                return b"".join(chunks)
            total += size
            if total > MAX_BODY_BYTES:
                raise _BadRequest("request body too large")
            chunks.append(await reader.readexactly(size))
            await reader.readline()
    n = int(headers.get("Content-Length") or 0)
    if n < 0 or n > MAX_BODY_BYTES:
        raise _BadRequest("bad Content-Length")
    return await reader.readexactly(n) if n else b""


def _encode(resp: Response, head_only: bool, keep_alive: bool) -> bytes:
    lines = [f"HTTP/1.1 {resp.status} {resp.reason}"]
    for k, v in resp.headers.items():
        if k.lower() not in ("content-length", "connection"):
            lines.append(f"{k}: {v}")
    lines.append(f"Content-Length: {len(resp.body)}")
    lines.append("Connection: " + ("keep-alive" if keep_alive else "close"))
    head = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
    return head if head_only else head + resp.body


class Server:
    """Serves one :class:`Application` on a TCP socket."""

    def __init__(self, app: Application) -> None:
        self.app = app
        self.port = 0
        self._server: Optional[asyncio.base_events.Server] = None
        self._conns: set = set()

    async def start(self, host: str = "127.0.0.1", port: int = 0,
                    sock: Optional[socket.socket] = None) -> None:
        if sock is None:
            sock = socket.socket(socket.AF_INET6 if ":" in host else socket.AF_INET)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind((host, port))
        sock.listen(512)
        sock.setblocking(False)
        self.port = sock.getsockname()[1]
        self._server = await asyncio.start_server(
            self._serve, sock=sock, limit=MAX_HEAD_BYTES)

    async def stop(self) -> None:
        """Hard stop: close the listener and every open connection; the
        handlers running on them are cancelled."""
        if self._server is not None:
            self._server.close()
        for task, writer in list(self._conns):
            writer.transport.abort()
            task.cancel()
        if self._conns:
            await asyncio.gather(*(t for t, _ in list(self._conns)),
                                 return_exceptions=True)
        if self._server is not None:
            await self._server.wait_closed()
            self._server = None

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        entry = (asyncio.current_task(), writer)
        self._conns.add(entry)
        peer = writer.get_extra_info("peername")
        remote = peer[0] if isinstance(peer, tuple) and peer else None
        try:
            while True:
                head = await _read_head(reader)
                if head is None:
                    return
                text = head.decode("latin-1").split("\r\n")
                try:
                    method, target, version = text[0].split(" ", 2)
                except ValueError as exc:
                    raise _BadRequest("bad request line") from exc
                items = []
                for line in text[1:]:
                    if not line:
                        continue
                    k, _, v = line.partition(":")
                    items.append((k.strip(), v.strip()))
                headers = Headers(items)
                body = await _read_body(reader, headers)
                conn_hdr = (headers.get("Connection") or "").lower()
                keep_alive = (version.upper() == "HTTP/1.1" and conn_hdr != "close") \
                    or conn_hdr == "keep-alive"
                request = Request(self.app, method.upper(), target, headers, body, remote)
                resp = await self.app.handle(request)
                writer.write(_encode(resp, method.upper() == "HEAD", keep_alive))
                await writer.drain()
                if not keep_alive:
                    return
        except _BadRequest as exc:
            msg = f"400: Bad Request ({exc})"
            writer.write(_encode(Response(status=400, text=msg), False, False))
            try:
                await writer.drain()
            except (ConnectionError, OSError):
                pass
        except (ConnectionError, OSError, asyncio.IncompleteReadError):
            pass
        finally:
            self._conns.discard(entry)
            writer.close()


def run_app(app: Application, host: str = "0.0.0.0", port: int = 8080,
            print: Callable[..., None] = print) -> None:  # noqa: A002
    """Serve ``app`` until SIGINT/SIGTERM: startup hooks, the listener
    (port 0 draws a free one; the banner names the bound port), and on the
    way out the cleanup hooks."""

    async def serve() -> None:
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, stop.set)
            except (NotImplementedError, RuntimeError):
                pass
        await app.startup()
        server = Server(app)
        await server.start(host, port)
        if print is not None:
            print(f"======== Running on http://{host}:{server.port} ========\n"
                  "(Press CTRL+C to quit)")
            sys.stdout.flush()
        try:
            await stop.wait()
        finally:
            await server.stop()
            await app.cleanup()

    asyncio.run(serve())
