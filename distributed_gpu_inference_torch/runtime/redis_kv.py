"""L3 KV spill tier on a remote RESP2 store (Redis), on sockets and threads.

The port's own copy of ``distributed_gpu_inference_tpu/runtime/redis_kv.py``
(the card's machine has no ``redis`` package; RESP2 is a few dozen lines):

- **Protocol**: the ``get(key) -> bytes | None`` / ``put(key, bytes)`` /
  ``delete(key)`` surface the spill chain consumes
  (``runtime/kv_cache.py`` ``_probe_spill`` / ``store_spilled`` /
  ``_quarantine``), so it drops into ``EngineConfig.spill_remote_store``.
  Keys and values are the JAX package's: a store shared by JAX and
  PyTorch workers serves both.
- **Async writeback**: ``put`` enqueues to a bounded queue drained by a
  daemon writer thread issuing ``SET key val PX ttl``; the serving path
  never blocks on the network. A full queue drops the oldest pending
  write: L3 is a cache, a lost spill is a future miss.
- **Fail-open**: connection errors make ``get`` a miss and ``put`` a no-op
  while a reconnect backs off; a slow server (a probe past
  ``probe_timeout_s``) backs off the same way, so a degraded server costs
  at most one slow probe per backoff window.
- **TTL** rides the server (PX), so entries expire even if this process
  dies.
- **Seams**: ``io.spill.redis.get`` / ``io.spill.redis.put``
  (``testing/faults.py`` ``io_fault``), inside the guarded blocks, so an
  injected error takes the path a real outage takes.

``remote_store_from_url`` maps config strings to stores:
``redis://[:password@]host[:port][/db]`` → :class:`RedisKVStore`,
``memory://`` → the in-process TTL dict (tests, single node).
"""

from __future__ import annotations

import queue
import socket
import threading
import time
from typing import Optional, Tuple
from urllib.parse import urlparse

from distributed_gpu_inference_torch.testing import faults as _faults


class RESPError(Exception):
    """Server-reported RESP error reply."""


def _encode_command(*args: bytes) -> bytes:
    """RESP2 array-of-bulk-strings command frame."""
    out = [b"*%d\r\n" % len(args)]
    for a in args:
        out.append(b"$%d\r\n%s\r\n" % (len(a), a))
    return b"".join(out)


class _Conn:
    """One blocking RESP connection with buffered reads."""

    def __init__(self, host: str, port: int, db: int, password: Optional[str],
                 timeout_s: float) -> None:
        self.sock = socket.create_connection((host, port), timeout=timeout_s)
        self.sock.settimeout(timeout_s)
        self._buf = b""
        if password:
            self.command(b"AUTH", password.encode())
        if db:
            self.command(b"SELECT", str(db).encode())

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def _read_line(self) -> bytes:
        while b"\r\n" not in self._buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("redis connection closed")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("redis connection closed")
            self._buf += chunk
        data, self._buf = self._buf[:n], self._buf[n:]
        return data

    def _read_reply(self):
        line = self._read_line()
        kind, rest = line[:1], line[1:]
        if kind == b"+":                      # simple string
            return rest
        if kind == b"-":                      # error
            raise RESPError(rest.decode(errors="replace"))
        if kind == b":":                      # integer
            return int(rest)
        if kind == b"$":                      # bulk string
            n = int(rest)
            if n == -1:
                return None
            data = self._read_exact(n)
            self._read_exact(2)               # trailing \r\n
            return data
        if kind == b"*":                      # array
            n = int(rest)
            if n == -1:
                return None
            return [self._read_reply() for _ in range(n)]
        raise RESPError(f"unknown RESP type byte {kind!r}")

    def command(self, *args: bytes):
        self.sock.sendall(_encode_command(*args))
        return self._read_reply()


class RedisKVStore:
    """L3 spill tier backed by a real Redis server (RESP2 over sockets).

    Implements the :class:`runtime.kv_cache.RemoteKVStore` protocol:
    ``get``/``put`` of opaque serialized page frames.
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 6379,
        db: int = 0,
        password: Optional[str] = None,
        ttl_s: float = 3600.0,
        key_prefix: str = "dgi:kv:",
        timeout_s: float = 2.0,
        probe_timeout_s: float = 0.25,
        writeback_queue: int = 256,
        reconnect_backoff_s: float = 5.0,
        conn_factory=None,           # tests inject a fake-connection factory
    ) -> None:
        self.ttl_s = ttl_s
        self.key_prefix = key_prefix
        self._timeout_s = timeout_s
        # reads sit on the engine admission path, serialized under _lock: a
        # slow-but-responsive server must not stall admissions for the full
        # connect timeout per probe, so GETs run under this much tighter
        # deadline and a breach trips the same _down_until backoff a
        # connection failure does (latency fail-open)
        self.probe_timeout_s = probe_timeout_s
        self._factory = conn_factory or (
            lambda: _Conn(host, port, db, password, timeout_s)
        )
        self._backoff = reconnect_backoff_s
        self._lock = threading.Lock()          # serializes the read conn
        self._conn: Optional[_Conn] = None
        self._down_until = 0.0
        self.stats = {"gets": 0, "hits": 0, "puts": 0, "dropped": 0,
                      "errors": 0, "slow_trips": 0}
        # async writeback: bounded queue + daemon writer (its own conn);
        # (key, None) is a delete tombstone (quarantine of a corrupt entry)
        self._q: "queue.Queue[Tuple[str, Optional[bytes]]]" = queue.Queue(
            maxsize=writeback_queue
        )
        self._stop = threading.Event()
        self._inflight = 0                     # dequeued, not yet durable
        self._wconn: Optional[_Conn] = None    # the writer's connection
        self._writer = threading.Thread(
            target=self._writeback_loop, name="redis-kv-writeback", daemon=True
        )
        self._writer.start()

    # ------------------------------------------------------------ plumbing

    def _get_conn(self) -> Optional[_Conn]:
        # backoff window suppresses probes even while a connection is live —
        # the slow-trip path (get() below) backs off WITHOUT dropping the
        # socket, so this check must come first
        if time.monotonic() < self._down_until:
            return None
        if self._conn is not None:
            return self._conn
        try:
            self._conn = self._factory()
        except (OSError, ConnectionError, RESPError):
            # RESPError covers AUTH/SELECT rejections at connect: a wrong
            # password must degrade to misses, not break the serving path
            self._down_until = time.monotonic() + self._backoff
            self.stats["errors"] += 1
            return None
        return self._conn

    def _drop_conn(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None
        self._down_until = time.monotonic() + self._backoff
        self.stats["errors"] += 1

    def _key(self, key: str) -> bytes:
        return (self.key_prefix + key).encode()

    # ------------------------------------------------------------ protocol

    def get(self, key: str) -> Optional[bytes]:
        """Synchronous read (the spill probe is on the admission path and a
        hit saves a whole prefill chunk); fail-open to a miss — on
        connection errors AND on latency: the probe runs under
        ``probe_timeout_s`` (much tighter than the connect timeout), and a
        deadline breach or a slow-but-successful reply trips the same
        ``_down_until`` backoff, so a degraded server costs at most one slow
        probe per backoff window instead of one per admission."""
        self.stats["gets"] += 1
        with self._lock:
            conn = self._get_conn()
            if conn is None:
                return None
            t0 = time.monotonic()
            try:
                # chaos seam INSIDE the guarded block: an injected io_error /
                # io_slow rides the exact fail-open path a real outage takes
                _faults.io_fault("io.spill.redis.get", key=key)
                conn.sock.settimeout(self.probe_timeout_s)
                data = conn.command(b"GET", self._key(key))
            except socket.timeout:
                self.stats["slow_trips"] += 1
                self._drop_conn()
                return None
            except (OSError, ConnectionError, RESPError):
                self._drop_conn()
                return None
            finally:
                if self._conn is not None:
                    try:
                        self._conn.sock.settimeout(self._timeout_s)
                    except OSError:
                        pass
            # a large payload can exceed the per-recv deadline in aggregate:
            # keep the hit, but stop probing for a backoff window
            if time.monotonic() - t0 > self.probe_timeout_s:
                self.stats["slow_trips"] += 1
                self._down_until = time.monotonic() + self._backoff
        if data is not None:
            self.stats["hits"] += 1
        return data

    def put(self, key: str, data: bytes) -> None:
        """Asynchronous writeback: enqueue and return; a full queue drops
        the OLDEST pending write (newest pages are the likeliest reuse)."""
        self.stats["puts"] += 1
        while True:
            try:
                self._q.put_nowait((key, data))
                return
            except queue.Full:
                try:
                    self._q.get_nowait()
                    self.stats["dropped"] += 1
                except queue.Empty:
                    pass

    def delete(self, key: str) -> None:
        """Best-effort async delete (quarantine of a corrupt/poisoned
        entry): rides the writeback queue as a ``(key, None)`` tombstone so
        it serializes after any pending put of the same key."""
        while True:
            try:
                self._q.put_nowait((key, None))
                return
            except queue.Full:
                try:
                    self._q.get_nowait()
                    self.stats["dropped"] += 1
                except queue.Empty:
                    pass

    # ------------------------------------------------------------ writer

    def _writeback_loop(self) -> None:
        px = str(int(self.ttl_s * 1000)).encode()
        while not self._stop.is_set():
            try:
                key, data = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            # the dequeued item is invisible to the queue but not yet
            # durable — flush() must count it until the SET/DEL lands,
            # or a stuck writer reads as drained
            self._inflight = 1
            self._write_one(key, data, px)
            self._inflight = 0

    def _write_one(self, key: str, data: Optional[bytes],
                   px: bytes) -> None:
        conn = self._wconn
        while not self._stop.is_set():
            if conn is None:
                try:
                    conn = self._factory()
                except (OSError, ConnectionError, RESPError):
                    self.stats["errors"] += 1
                    if self._stop.wait(self._backoff):
                        return
                    continue
            try:
                _faults.io_fault("io.spill.redis.put", key=key)
                if data is None:
                    conn.command(b"DEL", self._key(key))
                else:
                    conn.command(b"SET", self._key(key), data, b"PX", px)
                self._wconn = conn
                return
            except (OSError, ConnectionError, RESPError):
                # server-side rejections (MISCONF/OOM/READONLY) must
                # back off like connect failures — a tight
                # reconnect+SET spin would peg a core and hammer redis
                self.stats["errors"] += 1
                conn.close()
                conn = None
                self._wconn = None
                if self._stop.wait(self._backoff):
                    return

    def flush(self, timeout_s: float = 5.0) -> bool:
        """Drain pending writebacks (tests, graceful shutdown). Counts the
        dequeued-but-not-yet-durable item too: a writer stuck in its
        reconnect loop reports False at the deadline instead of reading
        as drained."""
        deadline = time.monotonic() + timeout_s
        while not self._q.empty() or self._inflight:
            if time.monotonic() > deadline:
                return False
            time.sleep(0.01)
        return True

    def close(self) -> None:
        self._stop.set()
        self._writer.join(timeout=2.0)
        if self._wconn is not None:
            self._wconn.close()
            self._wconn = None
        with self._lock:
            if self._conn is not None:
                self._conn.close()
                self._conn = None

    def ping(self) -> bool:
        with self._lock:
            conn = self._get_conn()
            if conn is None:
                return False
            try:
                return conn.command(b"PING") == b"PONG"
            except (OSError, ConnectionError, RESPError):
                self._drop_conn()
                return False


def remote_store_from_url(url: Optional[str], ttl_s: float = 3600.0):
    """Config-string → L3 store. ``redis://[:password@]host[:port][/db]`` →
    :class:`RedisKVStore`; ``memory://`` → in-process TTL dict; None/"" →
    no L3 tier."""
    if not url:
        return None
    parsed = urlparse(url)
    if parsed.scheme == "memory":
        from distributed_gpu_inference_torch.runtime.kv_cache import (
            RemoteKVStore,
        )

        return RemoteKVStore(ttl_s=ttl_s)
    if parsed.scheme != "redis":
        raise ValueError(f"unsupported KV remote url scheme: {url!r}")
    db = 0
    if parsed.path and parsed.path.strip("/"):
        db = int(parsed.path.strip("/"))
    return RedisKVStore(
        host=parsed.hostname or "127.0.0.1",
        port=parsed.port or 6379,
        db=db,
        password=parsed.password,
        ttl_s=ttl_s,
    )
