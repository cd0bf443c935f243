"""HTTP/2 over cleartext with prior knowledge (RFC 9113), client and server
side, on the standard library: the transport of the port's gRPC plane
(``comm/grpc_plane.py``).

One :class:`Connection` wraps one TCP socket:

- **Frames.** The client preface, then frames: DATA (padding included),
  HEADERS + CONTINUATION (header blocks through ``comm/hpack.py``),
  RST_STREAM, SETTINGS / ACK, PING / ACK, GOAWAY and WINDOW_UPDATE.
  PRIORITY and frame types this side does not know are ignored, as are
  SETTINGS ids it does not know (grpcio sends its own).
- **Flow control.** Both windows, the connection's and each stream's, are
  honoured when sending: DATA waits for window and is split at the peer's
  ``MAX_FRAME_SIZE`` (16,384 until it says otherwise). As receiver the
  connection advertises :data:`LOCAL_WINDOW` a stream,
  :data:`LOCAL_CONN_WINDOW` for the connection and :data:`LOCAL_MAX_FRAME`
  (8 MiB, 32 MiB and 4 MiB, so a port ↔ port hop moves a decode step's
  logits in one frame and a 4 MiB message without waiting for window). A
  stream's window is given back with WINDOW_UPDATE as its reader consumes
  the bytes, the connection's as frames arrive (a stream whose reader is
  slow holds back only itself).
- **Threads.** One reader thread parses frames and never writes to the
  socket; one writer thread sends what the others queue, so a thread that
  waits for window holds no lock the reader needs (a 0.5 MB reply cannot
  deadlock against the WINDOW_UPDATE that frees it). Streams hand data
  through ``memoryview`` slices of the frames: no per-byte Python loop on
  the data path.

A server-side connection calls ``on_stream(stream)`` on its reader thread
for each new stream once its request headers are in; the callee hands the
stream to a thread of its own.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from distributed_gpu_inference_torch.comm.hpack import Decoder, Encoder, Header, HPACKError

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

DATA, HEADERS, PRIORITY, RST_STREAM, SETTINGS, PUSH_PROMISE, PING, GOAWAY, \
    WINDOW_UPDATE, CONTINUATION = range(10)
END_STREAM = ACK = 0x1
END_HEADERS = 0x4
PADDED = 0x8
PRIORITY_FLAG = 0x20

HEADER_TABLE_SIZE, ENABLE_PUSH, MAX_CONCURRENT_STREAMS, INITIAL_WINDOW_SIZE, \
    MAX_FRAME_SIZE, MAX_HEADER_LIST_SIZE = range(1, 7)

NO_ERROR, PROTOCOL_ERROR, INTERNAL_ERROR, FLOW_CONTROL_ERROR, SETTINGS_TIMEOUT, \
    STREAM_CLOSED, FRAME_SIZE_ERROR, REFUSED_STREAM, CANCEL, COMPRESSION_ERROR = range(10)

DEFAULT_WINDOW = 65535
DEFAULT_MAX_FRAME = 16384
MAX_WINDOW = (1 << 31) - 1
MAX_FRAME_LIMIT = (1 << 24) - 1
_IOV_MAX = 512

#: what a connection advertises as receiver unless told otherwise: a
#: stream's window holds a whole message of grpcio's 4 MiB limit, and a
#: frame carries a decode step's logits (0.53 MB at llama3-8b) at once
LOCAL_WINDOW = 8 << 20
LOCAL_CONN_WINDOW = 32 << 20
LOCAL_MAX_FRAME = 4 << 20


class ConnectionClosed(ConnectionError):
    """The connection is gone (closed, lost, or a protocol error)."""


class StreamReset(ConnectionError):
    """The stream was reset (RST_STREAM from the peer, a cancel here, or
    refused by a GOAWAY)."""

    def __init__(self, code: int, detail: str = "") -> None:
        super().__init__(detail or f"stream reset with error code {code}")
        self.code = code


class ProtocolError(ConnectionError):
    def __init__(self, code: int, detail: str) -> None:
        super().__init__(detail)
        self.code = code


def _frame_header(length: int, ftype: int, flags: int, sid: int) -> bytes:
    return struct.pack(">I", length)[1:] + bytes([ftype, flags]) + struct.pack(">I", sid)


def _remaining(deadline: Optional[float]) -> Optional[float]:
    if deadline is None:
        return None
    left = deadline - time.monotonic()
    if left <= 0:
        raise TimeoutError("deadline passed")
    return left


class Stream:
    """One HTTP/2 stream. Every field is guarded by its connection's
    condition."""

    def __init__(self, conn: "Connection", sid: int) -> None:
        self.conn = conn
        self.id = sid
        self.send_window = conn.remote_initial_window
        self.headers: Optional[List[Header]] = None
        self.trailers: Optional[List[Header]] = None
        self.remote_closed = False      # END_STREAM received
        self.local_closed = False       # END_STREAM sent
        self.reset_code: Optional[int] = None
        self._chunks: Deque[memoryview] = deque()
        self._unacked = 0               # consumed, not yet given back

    # -- receiving

    def _check(self) -> None:
        if self.reset_code is not None:
            raise StreamReset(self.reset_code)
        if self.conn.closed:
            raise ConnectionClosed(self.conn.close_reason or "connection closed")

    def wait_headers(self, deadline: Optional[float] = None) -> List[Header]:
        """The first header block the peer sent on this stream."""
        cv = self.conn._cv
        with cv:
            while self.headers is None:
                self._check()
                cv.wait(_remaining(deadline))
            return self.headers

    def read_exact(self, n: int, deadline: Optional[float] = None) -> Optional[bytes]:
        """``n`` bytes of the stream's data; None when the peer ended the
        stream before any of them. Raises :class:`ProtocolError` when it
        ends in the middle, :class:`StreamReset` / :class:`ConnectionClosed`
        when the stream or the connection goes, ``TimeoutError`` at the
        deadline."""
        parts: List[memoryview] = []
        got = 0
        cv = self.conn._cv
        with cv:
            while got < n:
                while not self._chunks:
                    if self.reset_code is not None:
                        raise StreamReset(self.reset_code)
                    if self.remote_closed:
                        if got == 0:
                            return None
                        raise ProtocolError(PROTOCOL_ERROR, "stream ended inside a message")
                    self._check()
                    cv.wait(_remaining(deadline))
                chunk = self._chunks[0]
                take = min(len(chunk), n - got)
                if take == len(chunk):
                    self._chunks.popleft()
                else:
                    self._chunks[0] = chunk[take:]
                parts.append(chunk[:take])
                got += take
                self._consumed(take)
        if len(parts) == 1 and isinstance(parts[0].obj, bytes) and \
                len(parts[0]) == len(parts[0].obj):
            return parts[0].obj             # a whole frame's payload: no copy
        return b"".join(parts)

    def _consumed(self, n: int) -> None:
        self._unacked += n
        if self._unacked >= self.conn.local_window // 2 and not self.remote_closed \
                and self.reset_code is None:
            self.conn._queue(_frame_header(4, WINDOW_UPDATE, 0, self.id)
                             + struct.pack(">I", self._unacked))
            self._unacked = 0

    def wait_closed(self, deadline: Optional[float] = None) -> None:
        """Until the peer ended the stream (its data may stay unread)."""
        cv = self.conn._cv
        with cv:
            while not self.remote_closed:
                self._check()
                cv.wait(_remaining(deadline))

    # -- sending

    def _check_send(self) -> None:
        self._check()
        if self.local_closed:
            raise StreamReset(STREAM_CLOSED, "the stream's sending side is closed")

    def send_headers(self, headers: Sequence[Header], end_stream: bool = False) -> None:
        with self.conn._cv:
            self._check_send()
            self.conn._queue_headers(self.id, headers, end_stream)
            if end_stream:
                self.local_closed = True

    def send_data(self, data: bytes, end_stream: bool = False,
                  deadline: Optional[float] = None) -> None:
        """Send ``data``, waiting for window as needed (no lock is held
        while waiting), split at the peer's frame size."""
        view = memoryview(data).cast("B")
        if not len(view) and not end_stream:
            return
        pos, conn, cv = 0, self.conn, self.conn._cv
        with cv:
            while True:
                left = len(view) - pos
                avail = 0
                while left:
                    self._check_send()
                    avail = min(self.send_window, conn.send_window, conn.remote_max_frame)
                    if avail > 0:
                        break
                    cv.wait(_remaining(deadline))
                if not left:
                    self._check_send()
                n = min(left, avail)
                last = end_stream and n == left
                conn._queue(_frame_header(n, DATA, END_STREAM if last else 0, self.id),
                            view[pos:pos + n])
                self.send_window -= n
                conn.send_window -= n
                pos += n
                if last:
                    self.local_closed = True
                if pos == len(view):
                    return

    def reset(self, code: int = CANCEL) -> None:
        """RST_STREAM ``code`` unless the stream is already over."""
        with self.conn._cv:
            if self.reset_code is not None or (self.local_closed and self.remote_closed):
                self.conn._forget(self)
                return
            self.reset_code = code
            if not self.conn.closed:
                self.conn._queue(_frame_header(4, RST_STREAM, 0, self.id)
                                 + struct.pack(">I", code))
            self.conn._forget(self)
            self.conn._cv.notify_all()

    def release(self) -> None:
        """Drop the stream from the connection's table once its caller is
        done with it."""
        with self.conn._cv:
            self.conn._forget(self)


class Connection:
    """One HTTP/2 connection over ``sock``; ``client`` says which side this
    is. :meth:`start` sends the preface (client) and SETTINGS and starts the
    reader and writer threads."""

    def __init__(self, sock: socket.socket, client: bool,
                 on_stream: Optional[Callable[[Stream], None]] = None,
                 name: str = "h2") -> None:
        self.sock = sock
        self.client = client
        self.on_stream = on_stream
        self.local_window = LOCAL_WINDOW
        self.local_conn_window = LOCAL_CONN_WINDOW
        self.local_max_frame = LOCAL_MAX_FRAME
        self.name = name
        self._cv = threading.Condition(threading.Lock())
        self._out: Deque[bytes] = deque()
        self._sending = False           # the writer holds a batch not yet on the socket
        self._write_shut = False        # FIN sent: nothing more goes out
        self.streams: Dict[int, Stream] = {}
        self.next_id = 1 if client else 2
        self.last_peer_id = 0           # the highest stream id the peer opened
        self.remote_initial_window = DEFAULT_WINDOW
        self.remote_max_frame = DEFAULT_MAX_FRAME
        self.send_window = DEFAULT_WINDOW
        self._conn_unacked = 0
        self.closed = False
        self.close_reason = ""
        self.goaway: Optional[Tuple[int, int]] = None   # received: (last stream id, code)
        self.goaway_sent = False
        self._encoder = Encoder()
        self._decoder = Decoder()

    # -- life cycle

    def start(self) -> "Connection":
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        settings = [(INITIAL_WINDOW_SIZE, self.local_window),
                    (MAX_FRAME_SIZE, self.local_max_frame)]
        if self.client:
            settings.insert(0, (ENABLE_PUSH, 0))
        body = b"".join(struct.pack(">HI", k, v) for k, v in settings)
        with self._cv:
            if self.client:
                self._queue(PREFACE)
            self._queue(_frame_header(len(body), SETTINGS, 0, 0) + body)
            if self.local_conn_window > DEFAULT_WINDOW:
                self._queue(_frame_header(4, WINDOW_UPDATE, 0, 0)
                            + struct.pack(">I", self.local_conn_window - DEFAULT_WINDOW))
        for target, role in ((self._read_loop, "reader"), (self._write_loop, "writer")):
            threading.Thread(target=target, name=f"{self.name}-{role}", daemon=True).start()
        return self

    def close(self, reason: str = "closed") -> None:
        """Shut the socket; every waiting stream raises."""
        with self._cv:
            if self.closed:
                return
            self.closed = True
            self.close_reason = reason
            self._cv.notify_all()
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()

    def send_goaway(self, code: int = NO_ERROR) -> None:
        """GOAWAY naming the last stream the peer opened: no new streams."""
        with self._cv:
            if self.closed or self.goaway_sent:
                return
            self.goaway_sent = True
            self._queue(_frame_header(8, GOAWAY, 0, 0)
                        + struct.pack(">II", self.last_peer_id, code))

    def flush(self, timeout: float = 1.0) -> None:
        """Until everything queued is on the socket (or the timeout)."""
        end = time.monotonic() + timeout
        with self._cv:
            while (self._out or self._sending) and not self.closed:
                left = end - time.monotonic()
                if left <= 0:
                    return
                self._cv.wait(left)

    def half_close(self) -> None:
        """FIN after every byte written so far; frames queued later are
        dropped. The peer reads all of it before it sees the end (a plain
        close with its data unread could reset the connection first)."""
        with self._cv:
            if self.closed or self._write_shut:
                return
            self._write_shut = True
            self._out.clear()
        try:
            self.sock.shutdown(socket.SHUT_WR)
        except OSError:
            pass

    def wait_closed(self, timeout: float) -> bool:
        """Until the connection is closed (the peer's end read), at most
        ``timeout`` seconds."""
        end = time.monotonic() + timeout
        with self._cv:
            while not self.closed:
                left = end - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(left)
            return True

    @property
    def usable(self) -> bool:
        return not self.closed and self.goaway is None

    def open_stream(self, headers: Sequence[Header], end_stream: bool = False) -> Stream:
        """Client side: a new stream with ``headers`` sent."""
        with self._cv:
            if self.closed:
                raise ConnectionClosed(self.close_reason or "connection closed")
            if self.goaway is not None:
                raise StreamReset(REFUSED_STREAM, "connection going away")
            sid = self.next_id
            self.next_id += 2
            st = Stream(self, sid)
            self.streams[sid] = st
            self._queue_headers(sid, headers, end_stream)
            st.local_closed = end_stream
            return st

    # -- internals (called with the condition held)

    def _queue(self, *parts: bytes) -> None:
        if not self._write_shut:
            self._out.extend(parts)
            self._cv.notify_all()

    def _queue_headers(self, sid: int, headers: Sequence[Header], end_stream: bool) -> None:
        block = self._encoder.encode(headers)
        size = self.remote_max_frame
        first, rest = block[:size], block[size:]
        flags = (END_STREAM if end_stream else 0) | (0 if rest else END_HEADERS)
        parts = [_frame_header(len(first), HEADERS, flags, sid), first]
        while rest:
            piece, rest = rest[:size], rest[size:]
            parts += [_frame_header(len(piece), CONTINUATION, 0 if rest else END_HEADERS, sid),
                      piece]
        # one item: nothing may come between a block's frames
        self._queue(b"".join(parts))

    def _forget(self, st: Stream) -> None:
        if self.streams.get(st.id) is st:
            del self.streams[st.id]

    # -- the writer

    def _write_loop(self) -> None:
        try:
            while True:
                with self._cv:
                    while not self._out and not self.closed:
                        self._cv.wait()
                    if self.closed:
                        return
                    batch = [memoryview(b).cast("B") for b in self._out]
                    self._out.clear()
                    self._sending = True
                while batch:                     # scatter-gather: no joined copy
                    sent = self.sock.sendmsg(batch[:_IOV_MAX])
                    while sent:
                        if sent >= len(batch[0]):
                            sent -= len(batch.pop(0))
                        else:
                            batch[0], sent = batch[0][sent:], 0
                    while batch and not len(batch[0]):
                        batch.pop(0)
                with self._cv:
                    self._sending = False
                    self._cv.notify_all()        # flush() waiters
        except OSError as exc:
            self.close(f"write failed: {exc}")

    # -- the reader

    def _read_loop(self) -> None:
        f = self.sock.makefile("rb", buffering=1 << 20)
        try:
            if not self.client:
                if f.read(len(PREFACE)) != PREFACE:
                    raise ProtocolError(PROTOCOL_ERROR, "bad connection preface")
            while True:
                head = f.read(9)
                if len(head) < 9:
                    raise ConnectionClosed("peer closed the connection")
                length = int.from_bytes(head[:3], "big")
                ftype, flags = head[3], head[4]
                sid = int.from_bytes(head[5:9], "big") & 0x7FFFFFFF
                if length > self.local_max_frame:
                    raise ProtocolError(FRAME_SIZE_ERROR, f"frame of {length} bytes")
                payload = f.read(length) if length else b""
                if len(payload) < length:
                    raise ConnectionClosed("peer closed the connection inside a frame")
                if ftype == HEADERS:
                    block, end_stream = self._header_block(f, payload, flags, sid)
                    self._on_headers(sid, block, end_stream)
                else:
                    self._on_frame(ftype, flags, sid, payload)
        except ProtocolError as exc:
            self.send_goaway(exc.code)
            self.flush(0.5)
            self.close(f"protocol error: {exc}")
        except (OSError, ValueError) as exc:
            self.close(f"read failed: {exc}")
        finally:
            f.close()

    def _header_block(self, f, payload: bytes, flags: int, sid: int) -> Tuple[bytes, bool]:
        if sid == 0:
            raise ProtocolError(PROTOCOL_ERROR, "HEADERS on stream 0")
        view = memoryview(payload)
        start, end = 0, len(view)
        if flags & PADDED:
            if not end:
                raise ProtocolError(PROTOCOL_ERROR, "padded HEADERS without a pad length")
            end -= view[0]
            start = 1
        if flags & PRIORITY_FLAG:
            start += 5
        if start > end:
            raise ProtocolError(PROTOCOL_ERROR, "HEADERS padding past the frame")
        parts = [bytes(view[start:end])]
        more = not flags & END_HEADERS
        while more:
            head = f.read(9)
            if len(head) < 9:
                raise ConnectionClosed("peer closed the connection inside a header block")
            length = int.from_bytes(head[:3], "big")
            if head[3] != CONTINUATION or int.from_bytes(head[5:9], "big") & 0x7FFFFFFF != sid:
                raise ProtocolError(PROTOCOL_ERROR, "header block interrupted")
            if length > self.local_max_frame:
                raise ProtocolError(FRAME_SIZE_ERROR, f"frame of {length} bytes")
            parts.append(f.read(length))
            more = not head[4] & END_HEADERS
        return b"".join(parts), bool(flags & END_STREAM)

    def _on_headers(self, sid: int, block: bytes, end_stream: bool) -> None:
        try:
            headers = self._decoder.decode(block)
        except HPACKError as exc:
            raise ProtocolError(COMPRESSION_ERROR, str(exc)) from None
        new = None
        with self._cv:
            st = self.streams.get(sid)
            if st is None:
                if self.client or sid % 2 == 0 or sid <= self.last_peer_id:
                    return                   # a stream already over: ignored
                self.last_peer_id = sid
                if self.goaway_sent or self.closed:
                    self._queue(_frame_header(4, RST_STREAM, 0, sid)
                                + struct.pack(">I", REFUSED_STREAM))
                    return
                st = new = Stream(self, sid)
                self.streams[sid] = st
            if st.headers is None:
                st.headers = headers
            else:
                st.trailers = headers
            if end_stream:
                st.remote_closed = True
            self._cv.notify_all()
        if new is not None and self.on_stream is not None:
            self.on_stream(new)

    def _on_frame(self, ftype: int, flags: int, sid: int, payload: bytes) -> None:
        if ftype == DATA:
            self._on_data(flags, sid, payload)
        elif ftype == SETTINGS:
            if sid:
                raise ProtocolError(PROTOCOL_ERROR, "SETTINGS on a stream")
            if flags & ACK:
                return
            if len(payload) % 6:
                raise ProtocolError(FRAME_SIZE_ERROR, "SETTINGS length")
            with self._cv:
                for off in range(0, len(payload), 6):
                    key, value = struct.unpack_from(">HI", payload, off)
                    self._apply_setting(key, value)
                self._queue(_frame_header(0, SETTINGS, ACK, 0))
                self._cv.notify_all()
        elif ftype == WINDOW_UPDATE:
            if len(payload) != 4:
                raise ProtocolError(FRAME_SIZE_ERROR, "WINDOW_UPDATE length")
            inc = int.from_bytes(payload, "big") & 0x7FFFFFFF
            with self._cv:
                if sid == 0:
                    if not inc:
                        raise ProtocolError(PROTOCOL_ERROR, "WINDOW_UPDATE of 0")
                    self.send_window += inc
                    if self.send_window > MAX_WINDOW:
                        raise ProtocolError(FLOW_CONTROL_ERROR, "connection window overflow")
                else:
                    st = self.streams.get(sid)
                    if st is not None:
                        st.send_window += inc
                        if not inc or st.send_window > MAX_WINDOW:
                            self._queue(_frame_header(4, RST_STREAM, 0, sid) + struct.pack(
                                ">I", PROTOCOL_ERROR if not inc else FLOW_CONTROL_ERROR))
                            st.reset_code = FLOW_CONTROL_ERROR
                            self._forget(st)
                self._cv.notify_all()
        elif ftype == PING:
            if len(payload) != 8 or sid:
                raise ProtocolError(PROTOCOL_ERROR, "bad PING")
            if not flags & ACK:
                with self._cv:
                    self._queue(_frame_header(8, PING, ACK, 0) + payload)
        elif ftype == RST_STREAM:
            if len(payload) != 4:
                raise ProtocolError(FRAME_SIZE_ERROR, "RST_STREAM length")
            with self._cv:
                st = self.streams.get(sid)
                if st is not None:
                    st.reset_code = int.from_bytes(payload, "big")
                    self._forget(st)
                    self._cv.notify_all()
        elif ftype == GOAWAY:
            last, code = struct.unpack_from(">II", payload)
            last &= 0x7FFFFFFF
            with self._cv:
                self.goaway = (last, code)
                mine = (lambda s: s % 2 == 1) if self.client else (lambda s: s % 2 == 0)
                for st in list(self.streams.values()):
                    if mine(st.id) and st.id > last:
                        st.reset_code = REFUSED_STREAM
                        self._forget(st)
                self._cv.notify_all()
        elif ftype == CONTINUATION:
            raise ProtocolError(PROTOCOL_ERROR, "CONTINUATION without HEADERS")
        elif ftype == PUSH_PROMISE:
            raise ProtocolError(PROTOCOL_ERROR, "PUSH_PROMISE (push is disabled)")
        # PRIORITY and unknown frame types are ignored

    def _apply_setting(self, key: int, value: int) -> None:
        if key == INITIAL_WINDOW_SIZE:
            if value > MAX_WINDOW:
                raise ProtocolError(FLOW_CONTROL_ERROR, "initial window past 2^31-1")
            delta = value - self.remote_initial_window
            self.remote_initial_window = value
            for st in self.streams.values():
                st.send_window += delta
        elif key == MAX_FRAME_SIZE:
            if not DEFAULT_MAX_FRAME <= value <= MAX_FRAME_LIMIT:
                raise ProtocolError(PROTOCOL_ERROR, f"MAX_FRAME_SIZE {value}")
            self.remote_max_frame = value
        elif key == HEADER_TABLE_SIZE:
            self._encoder.set_max_table_size(value)
        elif key == ENABLE_PUSH and value > 1:
            raise ProtocolError(PROTOCOL_ERROR, f"ENABLE_PUSH {value}")
        # MAX_CONCURRENT_STREAMS, MAX_HEADER_LIST_SIZE and unknown ids: noted nowhere

    def _on_data(self, flags: int, sid: int, payload: bytes) -> None:
        if sid == 0:
            raise ProtocolError(PROTOCOL_ERROR, "DATA on stream 0")
        view = memoryview(payload)
        start, end = 0, len(view)
        if flags & PADDED:
            if not end or view[0] >= end:
                raise ProtocolError(PROTOCOL_ERROR, "DATA padding past the frame")
            end -= view[0]
            start = 1
        with self._cv:
            # the connection's window is given back on arrival
            self._conn_unacked += len(view)
            if self._conn_unacked >= self.local_conn_window // 2:
                self._queue(_frame_header(4, WINDOW_UPDATE, 0, 0)
                            + struct.pack(">I", self._conn_unacked))
                self._conn_unacked = 0
            st = self.streams.get(sid)
            if st is None or st.remote_closed:
                return                      # a stream already over: dropped
            if end > start:
                st._chunks.append(view[start:end])
            # padding counts against the window but is never read
            if len(view) - (end - start):
                st._consumed(len(view) - (end - start))
            if flags & END_STREAM:
                st.remote_closed = True
            self._cv.notify_all()


def connect(host: str, port: int, timeout: float = 10.0, **kw) -> Connection:
    """A started client connection to ``host:port``."""
    sock = socket.create_connection((host, port), timeout=timeout)
    sock.settimeout(None)
    return Connection(sock, client=True, **kw).start()
