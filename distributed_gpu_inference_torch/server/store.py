"""Async persistence layer for the control plane.

The reference uses async SQLAlchemy + Postgres with a *missing* models module
(``server/app/db/database.py:25-28``; schema reconstructed in SURVEY §2.1 from
field usage in ``server/app/api/workers.py:199-218``, ``jobs.py:88-97``,
``services/reliability.py:45-127``, ``services/usage.py:171-186``). This store
implements that reconstructed contract on stdlib sqlite3:

- WAL-mode sqlite, one writer at a time, reads concurrent.
- All blocking calls pushed to a thread executor behind an asyncio lock, so
  the aiohttp control plane stays non-blocking.
- ``claim_next_job`` provides the atomic pull the reference gets from
  ``SELECT … FOR UPDATE SKIP LOCKED`` (``scheduler.py:194-234``) — sqlite has
  a single writer, so ``BEGIN IMMEDIATE`` + conditional UPDATE is equivalent.
- **Versioned in-place migrations** via ``PRAGMA user_version`` (the role
  alembic plays for the reference, ``server/alembic/env.py``): ``_SCHEMA``
  is the frozen v1 baseline, every later change is an entry in
  ``_MIGRATIONS``, and ``Store.__init__`` upgrades any older database file
  atomically per version. Fresh databases replay the full migration list,
  so the upgrade path is exercised on every open, not just on legacy files.

Rows are returned as plain dicts; JSON-typed columns are transparently
encoded/decoded.

The port's copy of ``distributed_gpu_inference_tpu/server/store.py``, on the
standard library and the port's own modules.
"""

from __future__ import annotations

import asyncio
import json
import os
import sqlite3
import time
import uuid
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

from ..testing import faults as _faults
from ..utils.data_structures import JobStatus, WorkerState

# Multi-writer contention knobs (replicated control planes share one
# database file; see docs/ENV_CONFIG.md). busy_timeout makes sqlite block
# up to N ms for the other plane's write transaction; the retry loop
# handles the SQLITE_BUSY that still escapes (deadlock-avoidance returns
# busy immediately when a deferred reader upgrades against a writer).
_BUSY_TIMEOUT_MS = int(os.environ.get("DGI_STORE_BUSY_TIMEOUT_MS", "5000"))
_LOCK_RETRIES = int(os.environ.get("DGI_STORE_LOCK_RETRIES", "6"))
_LOCK_RETRY_BASE_S = 0.02


def _is_locked(exc: BaseException) -> bool:
    if not isinstance(exc, sqlite3.OperationalError):
        return False
    msg = str(exc)
    return "locked" in msg or "busy" in msg

# Columns stored as JSON text.
_WORKER_JSON = {
    "supported_types",
    "loaded_models",
    "online_pattern",
    "config_override",
    "topology",
    "mesh_shape",
    "load_stats",
}
_JOB_JSON = {"params", "result", "checkpoint", "prefix_fps", "timeline"}

_SCHEMA = """
CREATE TABLE IF NOT EXISTS workers (
    id TEXT PRIMARY KEY,
    name TEXT NOT NULL DEFAULT '',
    region TEXT NOT NULL DEFAULT 'unknown',
    country TEXT, city TEXT, timezone TEXT,
    -- TPU capability surface (reference stores gpu_model/gpu_memory_gb etc.)
    accelerator TEXT NOT NULL DEFAULT 'tpu',
    chip_generation TEXT, num_chips INTEGER NOT NULL DEFAULT 1,
    hbm_gb_per_chip REAL NOT NULL DEFAULT 16.0,
    hbm_used_gb REAL NOT NULL DEFAULT 0.0,
    topology TEXT, mesh_shape TEXT,
    cpu_cores INTEGER, ram_gb REAL,
    supported_types TEXT NOT NULL DEFAULT '[]',
    loaded_models TEXT NOT NULL DEFAULT '[]',
    status TEXT NOT NULL DEFAULT 'idle',
    role TEXT NOT NULL DEFAULT 'hybrid',
    current_job_id TEXT,
    last_heartbeat REAL,
    registered_at REAL NOT NULL,
    supports_direct INTEGER NOT NULL DEFAULT 0,
    direct_url TEXT,
    -- auth (hashes only at rest: reference workers.py:199-235)
    auth_token_hash TEXT, refresh_token_hash TEXT, signing_secret TEXT,
    token_expires_at REAL,
    failed_auth_attempts INTEGER NOT NULL DEFAULT 0,
    last_failed_auth REAL, locked_until REAL,
    -- reliability (reference reliability.py:45-127)
    reliability_score REAL NOT NULL DEFAULT 0.5,
    success_rate REAL NOT NULL DEFAULT 1.0,
    total_jobs INTEGER NOT NULL DEFAULT 0,
    completed_jobs INTEGER NOT NULL DEFAULT 0,
    failed_jobs INTEGER NOT NULL DEFAULT 0,
    avg_latency_ms REAL NOT NULL DEFAULT 0.0,
    unexpected_offline_count INTEGER NOT NULL DEFAULT 0,
    total_online_seconds REAL NOT NULL DEFAULT 0.0,
    total_sessions INTEGER NOT NULL DEFAULT 0,
    avg_session_minutes REAL NOT NULL DEFAULT 0.0,
    current_session_start REAL,
    online_pattern TEXT NOT NULL DEFAULT '{}',
    -- remote config (reference workers.py:491-546)
    config_version INTEGER NOT NULL DEFAULT 0,
    config_override TEXT,
    last_config_sync REAL
);

CREATE TABLE IF NOT EXISTS jobs (
    id TEXT PRIMARY KEY,
    type TEXT NOT NULL,
    params TEXT NOT NULL DEFAULT '{}',
    priority INTEGER NOT NULL DEFAULT 0,
    status TEXT NOT NULL DEFAULT 'queued',
    preferred_region TEXT,
    allow_cross_region INTEGER NOT NULL DEFAULT 1,
    actual_region TEXT,
    client_ip TEXT, client_region TEXT,
    worker_id TEXT,
    result TEXT, error TEXT,
    timeout_seconds REAL NOT NULL DEFAULT 300.0,
    retry_count INTEGER NOT NULL DEFAULT 0,
    max_retries INTEGER NOT NULL DEFAULT 3,
    created_at REAL NOT NULL,
    started_at REAL, completed_at REAL,
    actual_duration_ms REAL
);
CREATE INDEX IF NOT EXISTS idx_jobs_status_priority
    ON jobs (status, priority DESC, created_at);
CREATE INDEX IF NOT EXISTS idx_jobs_worker ON jobs (worker_id);

CREATE TABLE IF NOT EXISTS enterprises (
    id TEXT PRIMARY KEY,
    name TEXT NOT NULL,
    contact_email TEXT,
    custom_pricing TEXT,            -- JSON {job_type: price-per-unit}
    price_plan_id TEXT,
    allow_logging INTEGER NOT NULL DEFAULT 1,
    retention_days INTEGER NOT NULL DEFAULT 30,
    anonymize_data INTEGER NOT NULL DEFAULT 0,
    encrypt_fields INTEGER NOT NULL DEFAULT 0,
    created_at REAL NOT NULL
);

CREATE TABLE IF NOT EXISTS price_plans (
    id TEXT PRIMARY KEY,
    name TEXT NOT NULL,
    prices TEXT NOT NULL DEFAULT '{}',   -- JSON {job_type: price-per-unit}
    created_at REAL NOT NULL
);

CREATE TABLE IF NOT EXISTS api_keys (
    id TEXT PRIMARY KEY,
    enterprise_id TEXT NOT NULL,
    key_hash TEXT NOT NULL,
    name TEXT,
    active INTEGER NOT NULL DEFAULT 1,
    created_at REAL NOT NULL,
    last_used_at REAL
);
CREATE INDEX IF NOT EXISTS idx_api_keys_hash ON api_keys (key_hash);

CREATE TABLE IF NOT EXISTS usage_records (
    id TEXT PRIMARY KEY,
    enterprise_id TEXT,
    job_id TEXT NOT NULL,
    job_type TEXT NOT NULL,
    worker_id TEXT,
    units REAL NOT NULL DEFAULT 0.0,     -- tokens / pixels / seconds
    unit_kind TEXT NOT NULL DEFAULT 'tokens',
    cost REAL NOT NULL DEFAULT 0.0,
    created_at REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_usage_ent_time
    ON usage_records (enterprise_id, created_at);

CREATE TABLE IF NOT EXISTS bills (
    id TEXT PRIMARY KEY,
    enterprise_id TEXT NOT NULL,
    period_start REAL NOT NULL,
    period_end REAL NOT NULL,
    total_cost REAL NOT NULL DEFAULT 0.0,
    line_items TEXT NOT NULL DEFAULT '[]',
    status TEXT NOT NULL DEFAULT 'open',
    created_at REAL NOT NULL
);

CREATE TABLE IF NOT EXISTS audit_log (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    ts REAL NOT NULL,
    event TEXT NOT NULL,
    actor TEXT,
    detail TEXT
);
"""

_BASELINE_VERSION = 1

# Ordered (version, statement) pairs. All statements of one version apply in
# one transaction and ``PRAGMA user_version`` advances with it — a crash
# mid-version leaves the file at the previous version, to be retried. The
# baseline ``_SCHEMA`` is FROZEN at v1: schema evolution happens here.
_MIGRATIONS = [
    # v2: jobs carry the enterprise that submitted them, so usage/billing can
    # attribute work without joining through api_keys at query time
    (2, "ALTER TABLE jobs ADD COLUMN enterprise_id TEXT"),
    (2, "CREATE INDEX IF NOT EXISTS idx_jobs_enterprise "
        "ON jobs (enterprise_id)"),
    # v3: PD disaggregation — decode-capable workers advertise the data-plane
    # URL prefill peers push KV handoffs to (server/pd_flow.py)
    (3, "ALTER TABLE workers ADD COLUMN data_plane_url TEXT"),
    # v4: registration idempotency — a register retried after a lost
    # response (server flap) must land on the SAME worker row, keyed by the
    # machine fingerprint the worker already sends (worker/machine_id.py)
    (4, "ALTER TABLE workers ADD COLUMN machine_fingerprint TEXT"),
    (4, "CREATE INDEX IF NOT EXISTS idx_workers_fingerprint "
        "ON workers (machine_fingerprint)"),
    # v5: crash-safe generation — every claim bumps the job's
    # assignment_epoch (the fence a zombie worker's late complete_job or
    # stale checkpoint is rejected against), and workers piggyback a
    # portable PreemptedSequence checkpoint on heartbeats so a requeued
    # job resumes instead of regenerating. Direct (queue-less) SSE streams
    # checkpoint into their own table keyed by stream_id.
    (5, "ALTER TABLE jobs ADD COLUMN assignment_epoch INTEGER "
        "NOT NULL DEFAULT 0"),
    (5, "ALTER TABLE jobs ADD COLUMN checkpoint TEXT"),
    (5, "CREATE TABLE IF NOT EXISTS stream_checkpoints ("
        " stream_id TEXT PRIMARY KEY,"
        " worker_id TEXT,"
        " epoch INTEGER NOT NULL DEFAULT 0,"
        " state TEXT,"
        " updated_at REAL)"),
    # v6: cache-aware routing — jobs carry the request's prefix boundary
    # fingerprints (computed client- or server-side, utils/prefixes.py) so
    # claim/scoring can prefer the worker already holding the prefix;
    # workers persist their advertised radix summary (a control-plane
    # restart warm-starts routing instead of going blind) and a graded
    # load snapshot from the batcher heartbeat stats (the binary
    # current_job_id load signal lies for batcher-backed workers running
    # many jobs concurrently).
    (6, "ALTER TABLE jobs ADD COLUMN prefix_fps TEXT"),
    (6, "ALTER TABLE workers ADD COLUMN load_stats TEXT"),
    (6, "CREATE TABLE IF NOT EXISTS worker_prefix_summaries ("
        " worker_id TEXT PRIMARY KEY,"
        " seq INTEGER NOT NULL DEFAULT 0,"
        " block_chars INTEGER NOT NULL DEFAULT 64,"
        " entries TEXT,"
        " updated_at REAL)"),
    # v7: fast-restart fencing — each worker PROCESS mints a boot_id at
    # startup and sends it with registration. A re-registration on the
    # same fingerprint with a DIFFERENT boot_id proves the previous
    # incarnation is dead even when the restart beat the heartbeat
    # timeout (fast supervisor): its RUNNING jobs requeue immediately
    # instead of stranding until the job timeout. A credential-blip
    # re-register from the SAME process keeps its boot_id and its work.
    (7, "ALTER TABLE workers ADD COLUMN boot_id TEXT"),
    # v8: SLO-native overload control — usage records carry the tenant
    # and tier the plane admitted the job under, so per-tenant accounting
    # (and the fairness story behind the admission budgets) is auditable
    # from the same table billing reads.
    (8, "ALTER TABLE usage_records ADD COLUMN tenant TEXT"),
    (8, "ALTER TABLE usage_records ADD COLUMN tier TEXT"),
    (8, "CREATE INDEX IF NOT EXISTS idx_usage_tenant "
        "ON usage_records (tenant, created_at)"),
    # v9: request flight recorder — the merged per-request timeline is
    # stored with the job at completion (bounded by the recorder's
    # per-job event cap), so GET /debug/requests/{id}/timeline survives a
    # control-plane restart and post-mortems read from the same row the
    # result lives on. Advisory: a write failure is swallowed — the
    # recorder can never fail a request.
    (9, "ALTER TABLE jobs ADD COLUMN timeline TEXT"),
    # v10: replicated control planes — every claim stamps the plane that
    # brokered it. The assignment_epoch remains THE fence (a stale plane's
    # late complete/checkpoint 409s exactly like a stale worker's); the
    # plane_id column makes the broker auditable per epoch, so chaos tests
    # and post-mortems can prove WHICH plane's write was fenced out.
    (10, "ALTER TABLE jobs ADD COLUMN plane_id TEXT"),
]

SCHEMA_VERSION = max(
    [v for v, _ in _MIGRATIONS], default=_BASELINE_VERSION
)


def _encode(table_json: set, row: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in row.items():
        if k in table_json and v is not None and not isinstance(v, str):
            v = json.dumps(v)
        elif isinstance(v, bool):
            v = int(v)
        out[k] = v
    return out


def _decode(table_json: set, row: sqlite3.Row) -> Dict[str, Any]:
    d = dict(row)
    for k in table_json:
        if k in d and isinstance(d[k], str):
            try:
                d[k] = json.loads(d[k])
            except (ValueError, TypeError):
                pass
    return d


class Store:
    """Async facade over a WAL sqlite database (control-plane state)."""

    def __init__(self, path: str = ":memory:") -> None:
        self._path = path
        # one connection PER STORE, serialized writes within a plane;
        # check_same_thread off because we hop through the default executor.
        # Replicated planes each open their own Store on the same file:
        # WAL + busy_timeout + the locked-retry loop make cross-plane
        # writes safe (sqlite serializes writers; fenced conditional
        # UPDATEs decide races).
        self._conn = sqlite3.connect(
            path, check_same_thread=False, isolation_level=None
        )
        self._conn.row_factory = sqlite3.Row
        if path != ":memory:":
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute(f"PRAGMA busy_timeout={_BUSY_TIMEOUT_MS}")
        self._conn.execute("PRAGMA foreign_keys=ON")
        try:
            self._locked_retry(self._migrate)
        except BaseException:
            self._conn.close()
            raise
        self._lock = asyncio.Lock()

    def _rollback(self) -> None:
        """Best-effort ROLLBACK: when BEGIN itself lost a lock race there
        is no transaction to roll back, and that secondary error must not
        mask the original one."""
        try:
            self._conn.execute("ROLLBACK")
        except sqlite3.OperationalError:
            pass

    def _locked_retry(self, fn: Callable[[], Any]) -> Any:
        """Run ``fn`` (a whole transaction), retrying on SQLITE_BUSY with
        capped exponential backoff. With a single plane this never fires;
        with replicated planes it absorbs the write-lock collisions
        busy_timeout lets through. The transaction either fully commits or
        fully rolls back per attempt, so a retry re-reads fresh state —
        fenced UPDATEs (claim, transition) stay correct across planes."""
        for attempt in range(_LOCK_RETRIES + 1):
            try:
                return fn()
            except sqlite3.OperationalError as exc:
                if not _is_locked(exc) or attempt >= _LOCK_RETRIES:
                    raise
                self._rollback()
                time.sleep(min(0.25, _LOCK_RETRY_BASE_S * (2 ** attempt)))

    def _migrate(self) -> None:
        """Bring the database to ``SCHEMA_VERSION`` in place.

        version 0 means either a fresh file or a legacy pre-versioning
        database; both get the v1 baseline (``IF NOT EXISTS`` makes it a
        no-op on legacy files, whose tables ARE the v1 shape) and then
        replay every migration beyond their version.
        """
        (ver,) = self._conn.execute("PRAGMA user_version").fetchone()
        if ver == 0:
            # executescript issues an implicit COMMIT, so the baseline runs
            # in autocommit (IF NOT EXISTS makes it a no-op against a peer's
            # concurrent bootstrap). The version stamp must re-check under
            # the write lock: a racer that also read 0 must not clobber a
            # peer that already advanced past the baseline, or it would
            # re-apply ALTERs against the migrated schema.
            self._conn.executescript(_SCHEMA)
            self._conn.execute("BEGIN IMMEDIATE")
            try:
                (cur,) = self._conn.execute(
                    "PRAGMA user_version"
                ).fetchone()
                if cur == 0:
                    self._conn.execute(
                        f"PRAGMA user_version={_BASELINE_VERSION}"
                    )
                self._conn.execute("COMMIT")
            except BaseException:
                self._rollback()
                raise
            ver = cur if cur > 0 else _BASELINE_VERSION
        if ver > SCHEMA_VERSION:
            raise RuntimeError(
                f"database {self._path!r} is at schema version {ver}, newer "
                f"than this build's {SCHEMA_VERSION} — refusing to open"
            )
        pending = sorted(
            {v for v, _ in _MIGRATIONS if v > ver}
        )
        for v in pending:
            # IMMEDIATE + re-check: two planes opening the same fresh file
            # concurrently must not both apply a version (the second ALTER
            # TABLE would fail on a duplicate column)
            self._conn.execute("BEGIN IMMEDIATE")
            try:
                (cur_ver,) = self._conn.execute(
                    "PRAGMA user_version"
                ).fetchone()
                if cur_ver >= v:
                    self._conn.execute("COMMIT")
                    continue
                for mv, sql in _MIGRATIONS:
                    if mv == v:
                        self._conn.execute(sql)
                self._conn.execute(f"PRAGMA user_version={v}")
                self._conn.execute("COMMIT")
            except BaseException:
                self._rollback()
                raise

    async def _run(self, fn, *args):
        async with self._lock:
            loop = asyncio.get_running_loop()
            return await loop.run_in_executor(None, fn, *args)

    def close(self) -> None:
        self._conn.close()

    # -- generic helpers ---------------------------------------------------

    def _exec(self, sql: str, params: Sequence[Any] = ()) -> None:
        self._locked_retry(lambda: self._conn.execute(sql, params))

    def _query(self, sql: str, params: Sequence[Any] = ()) -> List[sqlite3.Row]:
        return self._conn.execute(sql, params).fetchall()

    async def execute(self, sql: str, params: Sequence[Any] = ()) -> None:
        # chaos seam: an installed FaultPlan can lose this mutation (drop)
        # or fail it like a wedged backend (error) — no-op passthrough
        # otherwise (testing/faults.py)
        if _faults.store_fault("server.store.execute", sql=sql):
            return
        await self._run(self._exec, sql, params)

    async def query(
        self, sql: str, params: Sequence[Any] = ()
    ) -> List[Dict[str, Any]]:
        rows = await self._run(self._query, sql, params)
        return [dict(r) for r in rows]

    # -- workers -----------------------------------------------------------

    async def upsert_worker(self, worker: Dict[str, Any]) -> None:
        row = _encode(_WORKER_JSON, dict(worker))
        row.setdefault("registered_at", time.time())
        cols = ", ".join(row)
        ph = ", ".join("?" for _ in row)
        upd = ", ".join(f"{c}=excluded.{c}" for c in row if c != "id")
        await self.execute(
            f"INSERT INTO workers ({cols}) VALUES ({ph}) "
            f"ON CONFLICT(id) DO UPDATE SET {upd}",
            list(row.values()),
        )

    async def get_worker(self, worker_id: str) -> Optional[Dict[str, Any]]:
        rows = await self._run(
            self._query, "SELECT * FROM workers WHERE id=?", (worker_id,)
        )
        return _decode(_WORKER_JSON, rows[0]) if rows else None

    async def update_worker(self, worker_id: str, **fields: Any) -> None:
        if not fields:
            return
        row = _encode(_WORKER_JSON, fields)
        sets = ", ".join(f"{k}=?" for k in row)
        await self.execute(
            f"UPDATE workers SET {sets} WHERE id=?",
            [*row.values(), worker_id],
        )

    async def list_workers(
        self,
        status: Optional[Iterable[str]] = None,
        region: Optional[str] = None,
        supports_type: Optional[str] = None,
    ) -> List[Dict[str, Any]]:
        sql, params = "SELECT * FROM workers", []
        clauses = []
        if status is not None:
            vals = [s.value if isinstance(s, WorkerState) else s for s in status]
            clauses.append(f"status IN ({','.join('?' * len(vals))})")
            params += vals
        if region is not None:
            clauses.append("region=?")
            params.append(region)
        if clauses:
            sql += " WHERE " + " AND ".join(clauses)
        rows = await self._run(self._query, sql, params)
        out = [_decode(_WORKER_JSON, r) for r in rows]
        if supports_type is not None:
            out = [w for w in out if supports_type in (w.get("supported_types") or [])]
        return out

    async def delete_worker(self, worker_id: str) -> None:
        await self.execute("DELETE FROM workers WHERE id=?", (worker_id,))

    async def reserve_worker_id_for_fingerprint(
        self, fingerprint: str, candidate_id: str
    ) -> str:
        """Atomic lookup-or-reserve of the worker row for a machine
        fingerprint (registration idempotency). A plain SELECT-then-INSERT
        in the handler is check-then-act: two concurrent registers (a
        client retry racing its own slow original) would both see no row
        and mint duplicate workers. ``BEGIN IMMEDIATE`` + conditional
        insert makes the reservation atomic — the same pattern
        ``claim_next_job`` uses."""
        # chaos seam: a dropped reservation write models a lost insert —
        # the candidate id is still returned, and the follow-up upsert
        # creates the row (the retry path the scenario exercises)
        if _faults.store_fault(
            "server.store.execute", sql="INSERT INTO workers (reserve)"
        ):
            return candidate_id

        def txn() -> str:
            self._conn.execute("BEGIN IMMEDIATE")
            try:
                row = self._conn.execute(
                    "SELECT id FROM workers WHERE machine_fingerprint=?",
                    (fingerprint,),
                ).fetchone()
                if row is not None:
                    self._conn.execute("COMMIT")
                    return row["id"]
                self._conn.execute(
                    "INSERT INTO workers (id, machine_fingerprint, "
                    "registered_at) VALUES (?, ?, ?)",
                    (candidate_id, fingerprint, time.time()),
                )
                self._conn.execute("COMMIT")
                return candidate_id
            except BaseException:
                self._rollback()
                raise

        return await self._run(self._locked_retry, txn)

    async def try_transition_job(self, job_id: str, from_status: str,
                                 owned_by: Optional[str] = None,
                                 **fields: Any) -> bool:
        """Conditionally update a job only if it is still in
        ``from_status`` (and, when ``owned_by`` is given, still assigned to
        that worker); returns True when this caller won the transition.
        The single UPDATE is atomic, so two concurrent duplicate
        completions cannot both apply terminal effects."""
        # chaos seam: a dropped transition is a lost write — the job stays
        # in from_status and the caller takes its lost-the-race path
        if _faults.store_fault(
            "server.store.execute", sql=f"UPDATE jobs (transition {from_status})"
        ):
            return False
        row = _encode(_JOB_JSON, fields)
        sets = ", ".join(f"{k}=?" for k in row)
        sql = f"UPDATE jobs SET {sets} WHERE id=? AND status=?"
        params: List[Any] = [*row.values(), job_id, from_status]
        if owned_by is not None:
            sql += " AND worker_id=?"
            params.append(owned_by)

        def txn() -> bool:
            cur = self._conn.execute(sql, params)
            return cur.rowcount == 1

        return await self._run(self._locked_retry, txn)

    # -- jobs --------------------------------------------------------------

    async def create_job(self, job: Dict[str, Any]) -> str:
        row = _encode(_JOB_JSON, dict(job))
        row.setdefault("id", str(uuid.uuid4()))
        row.setdefault("created_at", time.time())
        row.setdefault("status", JobStatus.QUEUED.value)
        cols = ", ".join(row)
        ph = ", ".join("?" for _ in row)
        await self.execute(
            f"INSERT INTO jobs ({cols}) VALUES ({ph})", list(row.values())
        )
        return row["id"]

    async def get_job(self, job_id: str) -> Optional[Dict[str, Any]]:
        rows = await self._run(
            self._query, "SELECT * FROM jobs WHERE id=?", (job_id,)
        )
        return _decode(_JOB_JSON, rows[0]) if rows else None

    async def update_job(self, job_id: str, **fields: Any) -> None:
        if not fields:
            return
        row = _encode(_JOB_JSON, fields)
        sets = ", ".join(f"{k}=?" for k in row)
        await self.execute(
            f"UPDATE jobs SET {sets} WHERE id=?", [*row.values(), job_id]
        )

    async def list_jobs(
        self,
        status: Optional[Iterable[str]] = None,
        worker_id: Optional[str] = None,
        limit: int = 100,
    ) -> List[Dict[str, Any]]:
        sql, params = "SELECT * FROM jobs", []
        clauses = []
        if status is not None:
            vals = [s.value if isinstance(s, JobStatus) else s for s in status]
            clauses.append(f"status IN ({','.join('?' * len(vals))})")
            params += vals
        if worker_id is not None:
            clauses.append("worker_id=?")
            params.append(worker_id)
        if clauses:
            sql += " WHERE " + " AND ".join(clauses)
        sql += " ORDER BY priority DESC, created_at LIMIT ?"
        params.append(limit)
        rows = await self._run(self._query, sql, params)
        return [_decode(_JOB_JSON, r) for r in rows]

    async def claim_next_job(
        self,
        worker_id: str,
        supported_types: Sequence[str],
        region: Optional[str] = None,
        prefer: Optional[Any] = None,
        prefer_window: int = 32,
        plane_id: Optional[str] = None,
    ) -> Optional[Dict[str, Any]]:
        """Atomically claim the best queued job for this worker.

        Equivalent of the reference's ``SELECT … FOR UPDATE SKIP LOCKED``
        claim (``scheduler.py:194-234``): priority DESC then FIFO, filtered to
        the worker's supported types, region-preferring jobs honored.

        ``prefer``: optional sync callable ``row_dict -> float`` (cache-aware
        routing affinity, ``server/prefix_routing.py``). Within the HEAD
        priority band only — and at most ``prefer_window`` eligible rows —
        the highest-preference job wins, FIFO breaking ties. Priority
        ordering is never violated and a job can be deferred by at most
        ``prefer_window - 1`` positions, so affinity is a bounded
        reordering, not a starvation risk. The callable runs inside the
        claim transaction: it must be pure and in-memory (no store access).

        ``plane_id``: the control-plane replica brokering this claim,
        stamped on the row alongside the epoch bump. With replicated
        planes sharing this file, two planes CAN race the same queued row:
        the conditional UPDATE's ``status=QUEUED`` guard decides the
        winner and the loser re-scans (returns None this poll).
        """

        def txn() -> Optional[sqlite3.Row]:
            if not supported_types:
                return None
            self._conn.execute("BEGIN IMMEDIATE")
            try:
                ph = ",".join("?" * len(supported_types))
                # scan deep enough that a run of region-restricted jobs at the
                # head of the queue cannot starve claimable work behind them
                rows = self._conn.execute(
                    f"SELECT * FROM jobs WHERE status=? AND type IN ({ph}) "
                    "ORDER BY priority DESC, created_at LIMIT 1000",
                    [JobStatus.QUEUED.value, *supported_types],
                ).fetchall()
                pick = None
                cands: List[sqlite3.Row] = []
                for r in rows:
                    pref = r["preferred_region"]
                    if (
                        pref
                        and region
                        and pref != region
                        and not r["allow_cross_region"]
                    ):
                        continue
                    # PD stage jobs are pinned to the worker holding (or
                    # receiving) the KV — nobody else may claim them
                    # (server/pd_flow.py sets target_worker). Substring
                    # pre-check keeps the hot claim path from JSON-parsing
                    # every candidate's (possibly multi-MB prompt-bearing)
                    # params inside the write transaction.
                    raw_params = r["params"] or "{}"
                    if '"target_worker"' in raw_params:
                        try:
                            target = json.loads(raw_params).get(
                                "target_worker"
                            )
                        except ValueError:
                            target = None
                        if target and target != worker_id:
                            continue
                    if prefer is None:
                        pick = r
                        break
                    if cands and r["priority"] != cands[0]["priority"]:
                        break   # never cross a priority band for affinity
                    cands.append(r)
                    if len(cands) >= max(1, prefer_window):
                        break
                if prefer is not None and cands:
                    best, best_score = cands[0], None
                    for r in cands:
                        try:
                            s = float(prefer(dict(r)))
                        except Exception:  # noqa: BLE001 — advisory only
                            s = 0.0
                        if best_score is None or s > best_score:
                            best, best_score = r, s
                    pick = best
                if pick is None:
                    self._conn.execute("COMMIT")
                    return None
                now = time.time()
                # every claim is a fresh assignment epoch: a zombie still
                # working the previous assignment fails the epoch fence on
                # complete/checkpoint even if THIS worker reclaims the job
                cur = self._conn.execute(
                    "UPDATE jobs SET status=?, worker_id=?, started_at=?, "
                    "actual_region=?, plane_id=?, "
                    "assignment_epoch=assignment_epoch+1 "
                    "WHERE id=? AND status=?",
                    (
                        JobStatus.RUNNING.value,
                        worker_id,
                        now,
                        region,
                        plane_id,
                        pick["id"],
                        JobStatus.QUEUED.value,
                    ),
                )
                if cur.rowcount != 1:
                    # raced: a peer plane claimed (or a sweep moved) this
                    # row between our scan and the UPDATE. Single-writer
                    # deployments never hit this; with replicated planes
                    # the loser simply reports no job this poll.
                    self._rollback()
                    return None
                self._conn.execute("COMMIT")
                return self._conn.execute(
                    "SELECT * FROM jobs WHERE id=?", (pick["id"],)
                ).fetchone()
            except BaseException:
                self._rollback()
                raise

        row = await self._run(self._locked_retry, txn)
        return _decode(_JOB_JSON, row) if row is not None else None

    # -- prefix summaries (cache-aware routing) ----------------------------

    async def save_prefix_summary(self, worker_id: str, seq: int,
                                  block_chars: int, entries_json: str,
                                  updated_at: float) -> None:
        """Write-through persistence of a worker's advertised radix
        summary (``server/prefix_routing.py`` keeps the hot in-memory
        copy; this row exists so a restarted control plane warm-starts
        routing instead of going locality-blind)."""
        await self.execute(
            "INSERT INTO worker_prefix_summaries "
            "(worker_id, seq, block_chars, entries, updated_at) "
            "VALUES (?,?,?,?,?) ON CONFLICT(worker_id) DO UPDATE SET "
            "seq=excluded.seq, block_chars=excluded.block_chars, "
            "entries=excluded.entries, updated_at=excluded.updated_at",
            (worker_id, int(seq), int(block_chars), entries_json,
             float(updated_at)),
        )

    async def delete_prefix_summary(self, worker_id: str) -> None:
        await self.execute(
            "DELETE FROM worker_prefix_summaries WHERE worker_id=?",
            (worker_id,),
        )

    # -- stream checkpoints (direct-mode failover) -------------------------

    async def save_stream_checkpoint(self, stream_id: str, worker_id: str,
                                     epoch: int, state: Any) -> bool:
        """Fenced upsert of a direct stream's generation checkpoint.

        Accepts when the stream is unknown, when ``epoch`` advances past the
        stored one, or when the SAME owner re-checkpoints at its current
        epoch. A zombie worker (whose stream was adopted by a failover peer,
        bumping the epoch) is rejected — its stale state must never clobber
        the live continuation. Returns True when the write landed."""
        # chaos seam: a checkpoint write through a dark/slow
        # store raises OperationalError or is silently lost — the pushers
        # upstream already tolerate both (staleness, not failure)
        if _faults.store_fault("server.store.checkpoint",
                               stream_id=stream_id):
            return False

        def txn() -> bool:
            self._conn.execute("BEGIN IMMEDIATE")
            try:
                row = self._conn.execute(
                    "SELECT epoch, worker_id FROM stream_checkpoints "
                    "WHERE stream_id=?", (stream_id,),
                ).fetchone()
                if row is not None:
                    stored = int(row["epoch"] or 0)
                    if epoch < stored or (
                        epoch == stored
                        and row["worker_id"] not in (None, worker_id)
                    ):
                        self._conn.execute("COMMIT")
                        return False
                self._conn.execute(
                    "INSERT INTO stream_checkpoints "
                    "(stream_id, worker_id, epoch, state, updated_at) "
                    "VALUES (?,?,?,?,?) ON CONFLICT(stream_id) DO UPDATE "
                    "SET worker_id=excluded.worker_id, "
                    "epoch=excluded.epoch, state=excluded.state, "
                    "updated_at=excluded.updated_at",
                    (stream_id, worker_id, int(epoch),
                     json.dumps(state), time.time()),
                )
                self._conn.execute("COMMIT")
                return True
            except BaseException:
                self._rollback()
                raise

        return await self._run(self._locked_retry, txn)

    async def adopt_stream_checkpoint(
        self, stream_id: str, worker_id: str
    ) -> Optional[Dict[str, Any]]:
        """Atomically hand a stream's latest checkpoint to a failover
        worker: bumps the epoch (fencing out the previous owner's late
        writes) and records the adopter as the new owner. Returns
        ``{"state", "epoch"}`` or None when no checkpoint exists."""

        def txn() -> Optional[Dict[str, Any]]:
            self._conn.execute("BEGIN IMMEDIATE")
            try:
                row = self._conn.execute(
                    "SELECT epoch, state FROM stream_checkpoints "
                    "WHERE stream_id=?", (stream_id,),
                ).fetchone()
                if row is None or row["state"] is None:
                    self._conn.execute("COMMIT")
                    return None
                new_epoch = int(row["epoch"] or 0) + 1
                self._conn.execute(
                    "UPDATE stream_checkpoints SET worker_id=?, epoch=?, "
                    "updated_at=? WHERE stream_id=?",
                    (worker_id, new_epoch, time.time(), stream_id),
                )
                self._conn.execute("COMMIT")
                try:
                    state = json.loads(row["state"])
                except (ValueError, TypeError):
                    state = None
                if state is None:
                    return None
                return {"state": state, "epoch": new_epoch}
            except BaseException:
                self._rollback()
                raise

        return await self._run(self._locked_retry, txn)

    async def delete_stream_checkpoint(self, stream_id: str, worker_id: str,
                                       epoch: int) -> bool:
        """Fenced cleanup when a stream finishes normally: only the current
        owner at the current (or newer) epoch may delete — a zombie's late
        "done" must not erase the checkpoint its replacement still needs."""

        def txn() -> bool:
            cur = self._conn.execute(
                "DELETE FROM stream_checkpoints WHERE stream_id=? "
                "AND (worker_id IS NULL OR worker_id=?) AND epoch<=?",
                (stream_id, worker_id, int(epoch)),
            )
            return cur.rowcount == 1

        return await self._run(self._locked_retry, txn)

    async def get_stream_checkpoint(
        self, stream_id: str
    ) -> Optional[Dict[str, Any]]:
        rows = await self._run(
            self._query,
            "SELECT * FROM stream_checkpoints WHERE stream_id=?",
            (stream_id,),
        )
        if not rows:
            return None
        d = dict(rows[0])
        if isinstance(d.get("state"), str):
            try:
                d["state"] = json.loads(d["state"])
            except (ValueError, TypeError):
                pass
        return d

    # -- queue stats -------------------------------------------------------

    async def queue_stats(self) -> Dict[str, Any]:
        rows = await self._run(
            self._query,
            "SELECT status, COUNT(*) AS n FROM jobs GROUP BY status",
        )
        by_status = {r["status"]: r["n"] for r in rows}
        workers = await self._run(
            self._query,
            "SELECT status, COUNT(*) AS n FROM workers GROUP BY status",
        )
        w_by_status = {r["status"]: r["n"] for r in workers}
        return {
            "jobs": by_status,
            "queued": by_status.get(JobStatus.QUEUED.value, 0),
            "running": by_status.get(JobStatus.RUNNING.value, 0),
            "workers": w_by_status,
            "idle_workers": w_by_status.get(WorkerState.IDLE.value, 0),
        }

    # -- enterprise / billing ---------------------------------------------

    async def insert(self, table: str, row: Dict[str, Any],
                     json_cols: Optional[set] = None) -> str:
        jc = json_cols if json_cols is not None else _detect_json_cols(table)
        row = _encode(jc, dict(row))
        row.setdefault("id", str(uuid.uuid4()))
        row.setdefault("created_at", time.time())
        cols = ", ".join(row)
        ph = ", ".join("?" for _ in row)
        await self.execute(
            f"INSERT INTO {table} ({cols}) VALUES ({ph})", list(row.values())
        )
        return row["id"]

    async def get(self, table: str, row_id: str) -> Optional[Dict[str, Any]]:
        rows = await self._run(
            self._query, f"SELECT * FROM {table} WHERE id=?", (row_id,)
        )
        return _decode(_detect_json_cols(table), rows[0]) if rows else None

    async def audit(self, event: str, actor: Optional[str] = None,
                    detail: Optional[Dict[str, Any]] = None) -> None:
        await self.execute(
            "INSERT INTO audit_log (ts, event, actor, detail) VALUES (?,?,?,?)",
            (time.time(), event, actor, json.dumps(detail or {})),
        )


_TABLE_JSON = {
    "workers": _WORKER_JSON,
    "jobs": _JOB_JSON,
    "enterprises": {"custom_pricing"},
    "price_plans": {"prices"},
    "bills": {"line_items"},
    "usage_records": set(),
    "api_keys": set(),
    "audit_log": {"detail"},
    "stream_checkpoints": {"state"},
}


def _detect_json_cols(table: str) -> set:
    return _TABLE_JSON.get(table, set())
