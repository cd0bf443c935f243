"""Harness of the PyTorch port: a live control plane on a loopback socket,
N real port workers behind it, and a chaos runner that plays a seeded
:class:`FleetFaultPlan` against them while traffic runs.

The port's copy of ``distributed_gpu_inference_tpu/testing/harness.py``
``LiveControlPlane`` / ``FleetWorker`` / ``FakeFleetWorker`` /
``LiveFleet`` / ``FleetAutoscaler``. :class:`LiveControlPlane` serves the
port's own plane (``server/app.py``) on a background event loop.
:class:`LiveFleet` takes a ``plane_factory`` (or a list of planes), each an
object with ``__enter__`` / ``__exit__`` (cold start, hard stop), ``start``
/ ``kill`` (a restart on the same port), ``alive``, ``url``, ``port`` and
``sweep()`` (one pass of the plane's guarantee sweeps): the port's
:class:`LiveControlPlane`, the JAX package's, or ``chip_smoke.py``
``StandInPlane``.

Fault registries: the port's seams (workers, engines, the KV tiers, and a
port plane's store and the port SDK) consult ``testing/faults.py`` here. A
plane from the JAX package fires its store seams (``server.*``) and the JAX
SDK its client seam (``sdk.*``) on the JAX package's registry, which the
caller passes as ``plane_faults`` (anything with ``FaultPlan``,
``FaultRule`` and ``active``). The chaos runner installs a plan on each
registry and arms every rule in the one that owns its site
(:func:`plane_side`). A port plane names its registry (``faults``, the
port's own), so a fleet on port planes needs no ``plane_faults``: its
plane-side rules go to the one port plan. An event that needs a plane-side
rule fails when no registry is known, rather than arming a rule nothing
would ever consult.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import socket
import threading
import time
import uuid
from typing import Any, Callable, Coroutine, Dict, List, Optional, Sequence, Tuple, Union

from . import faults as _faults
from .faults import FaultPlan, FaultRule, FleetFaultPlan


class LiveControlPlane:
    """Context manager: the port's control plane served on a loopback port
    from a background event loop, plus direct access to its services.

    :meth:`kill` hard-stops the server mid-traffic (in-flight requests die,
    the store connection closes — the db FILE and its WAL survive for peer
    planes), and :meth:`start` after a kill rebuilds the replica cold on
    the SAME port, so endpoint lists held by workers and SDK clients keep
    working. ``state_kw`` go to ``server/app.py`` ``ServerState``."""

    def __init__(self, **state_kw: Any) -> None:
        self._state_kw = state_kw
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._server: Optional[Any] = None
        self._app: Optional[Any] = None
        self.state: Optional[Any] = None
        self.port: int = 0
        self.alive = False

    # -- lifecycle -----------------------------------------------------------

    def __enter__(self) -> "LiveControlPlane":
        self.start()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.kill()

    def start(self) -> None:
        """Cold start (or cold RESTART after :meth:`kill`): fresh loop,
        fresh ServerState over the same ``db_path``."""
        if self.alive:
            return
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop.run_forever, name="live-control-plane",
            daemon=True,
        )
        self._thread.start()
        self.call(self._start())
        self.alive = True

    def kill(self) -> None:
        """Hard stop. Safe to call twice; :meth:`start` afterwards is a
        restart on the same port."""
        if self._loop is None:
            return
        self.alive = False
        try:
            self.call(self._stop(), timeout_s=15.0)
        finally:
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(timeout=10.0)
            self._loop.close()
            self._loop = None
            self._thread = None
            self._server = None

    async def _start(self) -> None:
        from ..server.app import ServerState, create_app
        from ..server.web import Server

        # ServerState (its Store and asyncio primitives) is built on the
        # server loop so nothing binds to the caller's thread
        self.state = ServerState(**self._state_kw)
        app = create_app(self.state, start_background=False)
        sock = socket.socket()
        # a restart must land on the port the first start drew
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind(("127.0.0.1", self.port))
        self._server = Server(app)
        await self._server.start(sock=sock)
        self.port = self._server.port
        self._app = app

    async def _stop(self) -> None:
        if self._server is not None:
            await self._server.stop()
            await self._app.cleanup()
        if self.state is not None:
            self.state.store.close()

    # -- access --------------------------------------------------------------

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    @property
    def faults(self) -> Any:
        """The fault registry this plane's seams consult (the port's)."""
        return _faults

    def call(self, coro: Coroutine, timeout_s: float = 30.0) -> Any:
        """Run a coroutine on the server loop from the caller's thread."""
        return asyncio.run_coroutine_threadsafe(
            coro, self._loop
        ).result(timeout=timeout_s)

    def sweep(self, now: Optional[float] = None) -> Dict[str, List[str]]:
        return self.call(self.state.guarantee.sweep(now=now))

    def query(self, sql: str, params: tuple = ()) -> List[Dict[str, Any]]:
        return self.call(self.state.store.query(sql, params))

    def job(self, job_id: str) -> Optional[Dict[str, Any]]:
        return self.call(self.state.store.get_job(job_id))

    def worker(self, worker_id: str) -> Optional[Dict[str, Any]]:
        return self.call(self.state.store.get_worker(worker_id))

# engine geometry every fleet member shares unless overridden: tiny model,
# per-token checkpoint cadence (a seeded kill point must always have a
# checkpoint to resume from), a deep queue so backpressure is the PLANE's
# decision (submit_queue_limit), not the batcher's
DEFAULT_FLEET_ENGINE = {
    "model": "llama3-tiny",
    "max_batch_size": 4,
    "max_seq_len": 160,
    "multi_step": 4,
    "checkpoint_interval_tokens": 1,
    "serving": {"queue_limit": 4096, "default_timeout_s": 120.0},
}

# sites whose seams live on the plane's side of the wire (its store, the
# SDK client): rules for them go to the plane-side registry
PLANE_SITE_PREFIXES = ("server.", "sdk.")


def plane_side(site: str) -> bool:
    """True when ``site`` is consulted by the plane's registry."""
    return site.startswith(PLANE_SITE_PREFIXES)


class FleetWorker:
    """One fleet replica: a REAL port ``worker.main.Worker`` wired as in
    production — batcher-backed ``TorchLLMEngine``, ``DirectServer``,
    stream checkpoint sink, heartbeat + poll threads — except registration
    uses a STABLE synthetic machine fingerprint (an in-process fleet would
    otherwise collapse onto one worker row), and the heartbeat loop is
    gateable so blackout/partition events can silence it. ``kill()`` is a
    hard crash (no drain, no offline call); ``start()`` after a kill is a
    cold restart-with-reregistration that lands on the same worker row.

    The engine runs on the card unless ``engine_config`` says
    ``device: "cpu"``. ``weights`` gives every (re)start the same weights,
    a JAX params tree as numpy (``models/convert.py``
    ``params_from_numpy``); None draws them from the engine's seed, or
    loads the ``checkpoint_path`` that ``engine_config`` names."""

    def __init__(self, index: int, plane_url: Any,
                 engine_config: Optional[Dict[str, Any]] = None,
                 hb_interval_s: float = 0.2,
                 poll_interval_s: float = 0.05,
                 role: Optional[str] = None,
                 pd_data_plane: bool = False,
                 region: str = "us-west",
                 weights: Optional[Dict[str, Any]] = None) -> None:
        self.index = index
        self.plane_url = plane_url
        self.engine_config = dict(engine_config or DEFAULT_FLEET_ENGINE)
        self.hb_interval_s = hb_interval_s
        self.poll_interval_s = poll_interval_s
        self.role = role
        # PD split fleets: serve the worker's KV data plane (/kv/transfer)
        # and register its URL; every member of a PD fleet runs one (role
        # rebalance can hand decode work to any of them)
        self.pd_data_plane = pd_data_plane
        self.region = region
        self.weights = weights
        self.tag = f"fw{index}"
        # stable across restarts of THIS member: re-registration must land
        # on the same worker row (rejoin accounting, job requeue)
        self.fingerprint = f"fleet-{index}-{uuid.uuid4().hex[:8]}"
        self.alive = False
        self.worker: Optional[Any] = None
        self.llm: Optional[Any] = None
        self.server: Optional[Any] = None
        self.api: Optional[Any] = None
        self.worker_id: Optional[str] = None
        self._hb_blocked = threading.Event()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    @property
    def device(self) -> str:
        return str(self.engine_config.get("device", "cuda"))

    def _engine_config(self) -> Dict[str, Any]:
        cfg = dict(self.engine_config)
        if self.weights is not None:
            from ..models.convert import params_from_numpy

            cfg["params"] = params_from_numpy(self.weights, self.device)
        return cfg

    def _topology(self) -> Any:
        from ..utils.data_structures import TpuTopology
        from ..worker.main import probe_topology

        if self.device == "cpu":
            return TpuTopology(chip_type="cpu", num_chips=1, hbm_gb_per_chip=4.0)
        return probe_topology()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """Cold start (or cold RESTART): fresh engine, fresh server, fresh
        credentials — registered on the stable fingerprint."""
        from ..utils.config import WorkerConfig
        from ..utils.data_structures import WorkerState
        from ..worker.api_client import APIClient
        from ..worker.direct_server import DirectServer
        from ..worker.engines.llm import TorchLLMEngine
        from ..worker.main import Worker

        llm = TorchLLMEngine(self._engine_config())
        llm.load_model()
        # per-replica chaos targeting (rules match {"worker": tag})
        llm.fault_tag = self.tag
        api = APIClient(self.plane_url, backoff_s=0.0)
        api.fault_tag = self.tag
        cfg = WorkerConfig(
            name=self.tag, region=self.region,
            heartbeat_interval_s=self.hb_interval_s,
            poll_interval_s=self.poll_interval_s,
        )
        cfg.task_types = ["llm"]
        w = Worker(cfg, api=api, topology=self._topology())
        w.engines = {"llm": llm}
        w.fault_tag = self.tag
        llm.checkpoint_sink = w.push_stream_checkpoint
        ds = DirectServer(w, host="127.0.0.1", port=0)
        ds.start()
        # the heartbeat carries the direct server's latency / error samples
        # for the plane's gray-failure health scoring
        w._direct = ds
        info: Dict[str, Any] = {
            "name": self.tag, "region": self.region,
            "machine_fingerprint": self.fingerprint,
            "supported_types": ["llm"], "supports_direct": True,
            "direct_url": f"http://127.0.0.1:{ds.port}",
            "topology": w.topology.to_dict(),
            # fresh per cold (re)start: a restart that beats the heartbeat
            # timeout still requeues the dead incarnation's RUNNING jobs
            "boot_id": w.boot_id,
        }
        if self.role:
            info["role"] = self.role
        if self.pd_data_plane:
            # the worker's own KV data plane, on a free loopback port
            cfg.pd_data_plane_url = "http://127.0.0.1:0"
            w._start_pd_plane()
            info["data_plane_url"] = f"http://127.0.0.1:{w._pd_plane.port}"
        try:
            api.register(info)
        except BaseException:
            ds.stop()
            if w._pd_plane is not None:
                w._pd_plane.stop()
            llm.unload()
            raise
        self.worker_id = api.worker_id
        w.state = WorkerState.IDLE
        self.worker, self.llm, self.server, self.api = w, llm, ds, api
        self._hb_blocked.clear()
        self._stop.clear()
        w._heartbeat_once()   # first beat lands before traffic arrives
        self._threads = [
            threading.Thread(target=self._hb_loop,
                             name=f"{self.tag}-hb", daemon=True),
            threading.Thread(target=w._main_loop,
                             name=f"{self.tag}-poll", daemon=True),
        ]
        for t in self._threads:
            t.start()
        self.alive = True

    def _hb_loop(self) -> None:
        w = self.worker
        while not self._stop.wait(self.hb_interval_s):
            if self._hb_blocked.is_set():
                continue   # blackout/partition window: beats are "lost"
            try:
                w._heartbeat_once()
            except Exception:  # noqa: BLE001 — outage: next tick retries
                pass

    def kill(self) -> None:
        """Hard crash: servers and threads stop mid-flight — no drain, no
        graceful offline, no checkpoint push. The plane finds out the way
        it would in production: heartbeats stop arriving. The engine's
        unload waits out the round in flight, so no device work outlives
        the crash and the restart can reclaim the card's memory."""
        if not self.alive:
            return
        self.alive = False
        self._stop.set()
        if self.api is not None:
            # the process's connections die with it: nothing of the dead
            # incarnation (a release, a completion, a checkpoint) reaches
            # the plane, which requeues its jobs when the heartbeats stop
            self.api.close()
        w = self.worker
        if w is not None:
            w._shutdown.set()             # stops the poll loop
        if self.server is not None:
            self.server.stop()            # in-flight sockets die abruptly
        if w is not None and w._pd_plane is not None:
            # the KV receiver dies with the process: in-flight handoff
            # sessions are lost, senders see refused connections
            try:
                w._pd_plane.stop()
            except Exception:  # noqa: BLE001 — a crash is not graceful
                pass
            w._pd_plane = None
        if self.llm is not None:
            # resolves outstanding batcher futures with errors and stops
            # the engine — concurrent requests see a crashed process
            try:
                self.llm.unload()
            except Exception:  # noqa: BLE001 — a crash is not graceful
                pass
        for t in self._threads:
            t.join(timeout=10.0)
        self._threads = []
        if w is not None and w._job_pool is not None:
            # jobs in flight saw the engine die: let their threads unwind
            # (they release their claims) before the member is reused
            w._job_pool.shutdown(wait=True)
        self.worker = self.llm = self.server = self.api = None

    def stop(self) -> None:
        """Teardown at harness exit (not a chaos event)."""
        self.kill()

    # -- chaos windows -------------------------------------------------------

    def blackout(self, on: bool) -> None:
        """Heartbeats stop/resume while the replica keeps serving — the
        one-directional partition that gets a LIVE worker swept offline."""
        if on:
            self._hb_blocked.set()
        else:
            self._hb_blocked.clear()

    def partition_rules(self) -> List[FaultRule]:
        """Rules a bidirectional partition arms: the replica's direct
        endpoint hard-drops every request/stream event, and its OWN
        control-plane calls (completions, checkpoints, polls) fail like a
        cut wire. Heartbeats are gated separately (:meth:`blackout`)."""
        return [
            FaultRule(site="worker.direct.request", kind="flap",
                      times=None, match={"worker": self.tag}),
            FaultRule(site="worker.direct.stream", kind="flap",
                      times=None, match={"worker": self.tag}),
            FaultRule(site="worker.api.request", kind="flap",
                      times=None, match={"worker": self.tag}),
        ]

    def handoff_rules(self) -> List[FaultRule]:
        """Rules a ``handoff_partition`` arms: THIS replica's outbound KV
        handoff pushes hard-drop."""
        return [
            FaultRule(site="worker.pd.push", kind="flap", times=None,
                      match={"worker": self.tag}),
        ]

    def handoff_delay_rules(self, delay_s: float) -> List[FaultRule]:
        """Per-piece latency on THIS replica's outbound KV pushes."""
        return [
            FaultRule(site="worker.pd.push", kind="delay",
                      delay_s=delay_s, times=None,
                      match={"worker": self.tag}),
        ]

    def slow_rules(self, delay_s: float) -> List[FaultRule]:
        """Latency injection: every direct request admission and stream
        event of THIS replica pays ``delay_s``."""
        return [
            FaultRule(site="worker.direct.request", kind="delay",
                      delay_s=delay_s, times=None,
                      match={"worker": self.tag}),
            FaultRule(site="worker.direct.stream", kind="delay",
                      delay_s=delay_s, times=None,
                      match={"worker": self.tag}),
        ]

    def jitter_rules(self, delay_s: float, prob: float) -> List[FaultRule]:
        """Gray jitter: each direct request/stream event of THIS replica
        pays ``delay_s`` at ``prob`` — a fat tail, not a shifted median."""
        return [
            FaultRule(site="worker.direct.request", kind="delay",
                      delay_s=delay_s, prob=prob, times=None,
                      match={"worker": self.tag}),
            FaultRule(site="worker.direct.stream", kind="delay",
                      delay_s=delay_s, prob=prob, times=None,
                      match={"worker": self.tag}),
        ]

    def flaky_rules(self, prob: float) -> List[FaultRule]:
        """Gray flakiness: THIS replica's direct admission answers HTTP 500
        at ``prob`` while the process — and its heartbeats — stay up."""
        return [
            FaultRule(site="worker.direct.request", kind="error",
                      status=500, prob=prob, times=None,
                      match={"worker": self.tag}),
        ]

    # -- introspection -------------------------------------------------------

    def engine_quiet(self) -> bool:
        return self.llm is None or self.llm.engine is None \
            or self.llm.engine.num_active == 0


class FakeFleetWorker:
    """Engine-free fleet member: registers, heartbeats, claims and
    INSTANTLY completes jobs through the port's ``APIClient`` — the full
    control-plane protocol (signing, epoch-fenced completion, plane
    failover) with no engine, no batcher, no direct server. Exposes the
    lifecycle subset the chaos driver touches (``alive`` / ``kill`` /
    ``start`` / ``blackout``).

    :attr:`completed` counts the jobs whose completion the plane
    acknowledged. The plane marks a job completed before its answer
    reaches the member, so a caller that saw the job completed could read
    the count before the member did; a read therefore waits for a poll
    iteration in flight (claim → complete → count) to finish first."""

    def __init__(self, index: int, plane_url: Any,
                 hb_interval_s: float = 0.2,
                 poll_interval_s: float = 0.05,
                 region: str = "us-west") -> None:
        self.index = index
        self.plane_url = plane_url
        self.hb_interval_s = hb_interval_s
        self.poll_interval_s = poll_interval_s
        self.region = region
        self.tag = f"fk{index}"
        self.fingerprint = f"fake-{index}-{uuid.uuid4().hex[:8]}"
        self.alive = False
        self.api: Optional[Any] = None
        self.worker_id: Optional[str] = None
        self._completed = 0         # jobs this member instantly served
        # held by the poll loop across claim → complete → count
        self._serving = threading.Lock()
        self.heartbeats = 0         # beats that reached a plane
        self._hb_blocked = threading.Event()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    def start(self) -> None:
        from ..worker.api_client import APIClient

        api = APIClient(self.plane_url, backoff_s=0.0)
        api.fault_tag = self.tag
        api.register({
            "name": self.tag, "region": self.region,
            "machine_fingerprint": self.fingerprint,
            "supported_types": ["llm"], "supports_direct": False,
        })
        self.worker_id = api.worker_id
        self.api = api
        self._hb_blocked.clear()
        self._stop.clear()
        try:
            api.heartbeat(status="idle")
            self.heartbeats += 1
        except Exception:  # noqa: BLE001 — loop beats catch up
            pass
        self._threads = [
            threading.Thread(target=self._hb_loop,
                             name=f"{self.tag}-hb", daemon=True),
            threading.Thread(target=self._poll_loop,
                             name=f"{self.tag}-poll", daemon=True),
        ]
        for t in self._threads:
            t.start()
        self.alive = True

    def _hb_loop(self) -> None:
        while not self._stop.wait(self.hb_interval_s):
            if self._hb_blocked.is_set():
                continue
            try:
                self.api.heartbeat(status="idle")
                self.heartbeats += 1
            except Exception:  # noqa: BLE001 — outage: next tick retries
                pass

    @property
    def completed(self) -> int:
        with self._serving:
            return self._completed

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            with self._serving:
                try:
                    job = self.api.fetch_next_job()
                    if job is None:
                        continue
                    self.api.complete_job(
                        job["id"], True,
                        result={"text": f"fake:{job['id']}"},
                        assignment_epoch=job.get("assignment_epoch"),
                    )
                    self._completed += 1
                except Exception:  # noqa: BLE001 — outage: next tick retries
                    pass

    def blackout(self, on: bool) -> None:
        if on:
            self._hb_blocked.set()
        else:
            self._hb_blocked.clear()

    def kill(self) -> None:
        if not self.alive:
            return
        self.alive = False
        self._stop.set()
        for t in self._threads:
            t.join(timeout=10.0)
        self._threads = []
        if self.api is not None:
            self.api.close()
            self.api = None

    def stop(self) -> None:
        self.kill()


Member = Union[FleetWorker, FakeFleetWorker, Any]


class LiveFleet:
    """Context manager: control planes + N real workers + a seeded chaos
    driver. The production composition in one object:

    - every member is a real ``Worker`` (shared serving claims, stream
      checkpoints, drain/zombie fencing) serving through the batcher;
    - a sweeper thread runs the planes' guarantee sweeps on a fast cadence,
      like the production background worker;
    - :meth:`run_chaos` executes a :class:`FleetFaultPlan` against
      wall-clock offsets while the caller drives traffic, calling
      ``on_event(kind)`` for every event (a JAX plane's caller records it
      in the plane's ``chaos_*`` metrics) and stamping the plan's trace.

    ``plane_factory()`` builds the plane (or ``planes`` gives them built, a
    cohort of replicas); ``member_factory(index, target, role)`` builds a
    member (one fleet may then hold JAX and port members), by default a
    :class:`FleetWorker` (``fake_engines``: a :class:`FakeFleetWorker`)
    with this fleet's settings; ``target`` is the plane URL, or the list of
    every plane's URL when there are several."""

    def __init__(self, n: int = 2,
                 engine_config: Optional[Dict[str, Any]] = None,
                 plane_factory: Optional[Callable[[], Any]] = None,
                 planes: Optional[Sequence[Any]] = None,
                 hb_interval_s: float = 0.2,
                 poll_interval_s: float = 0.05,
                 sweep_interval_s: float = 0.25,
                 roles: Optional[List[Optional[str]]] = None,
                 pd_data_plane: bool = False,
                 fake_engines: bool = False,
                 member_factory: Optional[Callable[..., Member]] = None,
                 on_event: Optional[Callable[[str], None]] = None,
                 plane_faults: Optional[Any] = None) -> None:
        self.n = n
        self.engine_config = dict(engine_config or DEFAULT_FLEET_ENGINE)
        self.hb_interval_s = hb_interval_s
        self.poll_interval_s = poll_interval_s
        self.sweep_interval_s = sweep_interval_s
        self.roles = list(roles) if roles is not None else [None] * n
        if len(self.roles) != n:
            raise ValueError("roles must have one entry per member")
        self.pd_data_plane = pd_data_plane
        self.fake_engines = fake_engines
        self.member_factory = member_factory
        self.on_event = on_event
        self.plane_faults = plane_faults
        if planes is not None:
            self.planes: List[Any] = list(planes)
        elif plane_factory is not None:
            self.planes = [plane_factory()]
        else:
            raise ValueError("a LiveFleet needs planes or a plane_factory")
        if not self.planes:
            raise ValueError("a LiveFleet needs at least one plane")
        self.plane = self.planes[0]
        if self.plane_faults is None:
            # a port plane names its registry (the port's own)
            self.plane_faults = getattr(self.plane, "faults", None)
        self.members: List[Member] = []
        self._sweep_stop = threading.Event()
        self._sweeper: Optional[threading.Thread] = None
        self._chaos_thread: Optional[threading.Thread] = None
        self._chaos_failure: Optional[BaseException] = None

    # -- lifecycle -----------------------------------------------------------

    def __enter__(self) -> "LiveFleet":
        try:
            for p in self.planes:
                p.__enter__()
            for i in range(self.n):
                m = self._build_member(i, role=self.roles[i])
                m.start()
                self.members.append(m)
            self._sweep_stop.clear()
            self._sweeper = threading.Thread(
                target=self._sweep_loop, name="fleet-sweeper", daemon=True
            )
            self._sweeper.start()
        except BaseException:
            self.__exit__(None, None, None)
            raise
        return self

    def _build_member(self, index: int, role: Optional[str] = None) -> Member:
        # members get EVERY plane endpoint (single plane: the one URL) — the
        # APIClient's sticky health-probed failover owns which is active
        urls = self.plane_urls
        target = urls[0] if len(urls) == 1 else urls
        if self.member_factory is not None:
            return self.member_factory(index, target, role)
        if self.fake_engines:
            return FakeFleetWorker(
                index, target,
                hb_interval_s=self.hb_interval_s,
                poll_interval_s=self.poll_interval_s,
            )
        return FleetWorker(
            index, target, self.engine_config,
            hb_interval_s=self.hb_interval_s,
            poll_interval_s=self.poll_interval_s,
            role=role,
            pd_data_plane=self.pd_data_plane,
        )

    def __exit__(self, *exc: Any) -> None:
        try:
            self.wait_chaos(timeout_s=30.0)
        finally:
            self._sweep_stop.set()
            if self._sweeper is not None:
                self._sweeper.join(timeout=5.0)
            for m in self.members:
                try:
                    m.stop()
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass
            for p in self.planes:
                try:
                    p.__exit__(None, None, None)
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass

    def _sweep_loop(self) -> None:
        while not self._sweep_stop.wait(self.sweep_interval_s):
            # sweeps must survive plane chaos: run on the first ALIVE
            # replica (the sweeps are fenced conditional writes)
            for p in self.planes:
                if not p.alive:
                    continue
                try:
                    p.sweep()
                    break
                except Exception:  # noqa: BLE001 — next plane / next tick
                    continue

    @property
    def url(self) -> str:
        return self.plane.url

    @property
    def plane_urls(self) -> List[str]:
        return [p.url for p in self.planes]

    def any_plane(self) -> Any:
        """The first ALIVE plane (for queries while chaos may have killed
        the primary)."""
        for p in self.planes:
            if p.alive:
                return p
        return self.plane

    def alive_members(self) -> List[Member]:
        return [m for m in self.members if m.alive]

    # -- elastic capacity ----------------------------------------------------

    def scale_out(self, role: Optional[str] = None) -> Member:
        """Add one COLD replica after the existing members (chaos-plan
        worker indices stay stable). Blocks until it is registered and
        heartbeating — a caller measuring cold-start lead time times this
        call."""
        m = self._build_member(len(self.members), role=role)
        m.start()
        self.members.append(m)
        self.roles.append(role)
        return m

    def scale_in(self) -> Optional[Member]:
        """Retire the most recently added ALIVE replica (LIFO), abruptly:
        the plane's sweeps requeue what it was running. None when only one
        replica is alive (never scale to zero)."""
        alive = self.alive_members()
        if len(alive) <= 1:
            return None
        victim = alive[-1]
        victim.kill()
        return victim

    # -- chaos driver --------------------------------------------------------

    def run_chaos(self, plan: FleetFaultPlan,
                  block: bool = False) -> threading.Thread:
        """Execute ``plan`` on a background thread (or inline with
        ``block=True``): each event fires at its wall-clock offset from
        now; windowed events arm their effect and disarm it ``duration_s``
        later. A :class:`FaultPlan` seeded from the fleet plan is installed
        in each registry for the whole run, so callers must not hold their
        own installed plans concurrently."""
        if self._chaos_thread is not None and \
                self._chaos_thread.is_alive():
            raise RuntimeError("a chaos run is already in flight")
        self._chaos_failure = None

        def drive() -> None:
            try:
                self._drive_chaos(plan)
            except BaseException as exc:  # noqa: BLE001 — surfaced on wait
                self._chaos_failure = exc

        t = threading.Thread(target=drive, name="fleet-chaos", daemon=True)
        self._chaos_thread = t
        t.start()
        if block:
            self.wait_chaos()
        return t

    def wait_chaos(self, timeout_s: float = 120.0) -> None:
        """Join the in-flight chaos run; re-raises a driver failure."""
        t = self._chaos_thread
        if t is not None:
            t.join(timeout=timeout_s)
            self._chaos_thread = None
        if self._chaos_failure is not None:
            failure, self._chaos_failure = self._chaos_failure, None
            raise failure

    def _emit(self, kind: str) -> None:
        if self.on_event is None:
            return
        try:
            self.on_event(kind)
        except Exception:  # noqa: BLE001 — metrics are best-effort
            pass

    @contextlib.contextmanager
    def chaos_plans(self, seed: int):
        """Install the run's plans → ``(port plan, plane-side plan or
        None)``."""
        pf = self.plane_faults
        with _faults.active(FaultPlan(seed)) as fp:
            if pf is None:
                yield fp, None
            elif pf is _faults:
                # a port plane consults the port's registry: one plan
                yield fp, fp
            else:
                with pf.active(pf.FaultPlan(seed)) as pp:
                    yield fp, pp

    def arm(self, rule: FaultRule, plans: Tuple[Any, Any]) -> Callable[[], None]:
        """Arm ``rule`` in the registry that owns its site → its disarm."""
        fp, pp = plans
        if not plane_side(rule.site):
            armed = fp.add_rule(rule)
            return lambda: fp.remove_rule(armed)
        if pp is None:
            raise ValueError(
                f"fault site {rule.site!r} is consulted on the plane's side: "
                "pass the plane's faults module as plane_faults"
            )
        fields = {f.name: getattr(rule, f.name)
                  for f in dataclasses.fields(rule) if f.name not in ("hits", "fired")}
        armed = pp.add_rule(self.plane_faults.FaultRule(**fields))
        return lambda: pp.remove_rule(armed)

    def _drive_chaos(self, plan: FleetFaultPlan) -> None:
        t0 = time.monotonic()
        pending = sorted(plan.events, key=lambda e: e.at_s)
        undo: List[tuple] = []   # (due_at_offset, fn)
        with self.chaos_plans(plan.seed) as plans:
            while pending or undo:
                now = time.monotonic() - t0
                for due, fn in [u for u in undo if u[0] <= now]:
                    undo.remove((due, fn))
                    fn()
                while pending and pending[0].at_s <= now:
                    ev = pending.pop(0)
                    plan.record(now, ev.kind, ev.worker)
                    self._emit(ev.kind)
                    end = self._execute(ev, plans)
                    if end is not None:
                        # the window runs from the ACTUAL arm time: a kill
                        # or restart before it can block the driver past
                        # at_s, and anchoring the disarm to the scheduled
                        # offset would collapse the window on a slow box
                        undo.append((
                            (time.monotonic() - t0) + ev.duration_s, end
                        ))
                time.sleep(0.02)

    def _arm_all(self, rules: List[FaultRule],
                 plans: Tuple[Any, Any]) -> Callable[[], None]:
        undo = [self.arm(r, plans) for r in rules]
        return lambda: [u() for u in undo]

    def _execute(self, ev: Any, plans: Tuple[Any, Any]) -> Optional[Callable[[], Any]]:
        """Apply one fleet event; returns the disarm callback for windowed
        kinds (None for kill/restart)."""
        member = (
            self.members[ev.worker]
            if ev.worker >= 0 and not ev.kind.startswith("plane_") else None
        )
        if ev.kind == "kill":
            member.kill()
            return None
        if ev.kind == "restart":
            member.start()
            return None
        if ev.kind == "blackout":
            member.blackout(True)
            return lambda: member.blackout(False)
        if ev.kind == "partition":
            member.blackout(True)
            heal_rules = self._arm_all(member.partition_rules(), plans)

            def heal() -> None:
                heal_rules()
                member.blackout(False)

            return heal
        if ev.kind in ("slow", "degrade"):
            # degrade reuses the slow seam with a far heavier delay over a
            # far longer window (the replica heartbeats fine throughout)
            return self._arm_all(member.slow_rules(ev.delay_s), plans)
        if ev.kind == "jitter":
            return self._arm_all(member.jitter_rules(ev.delay_s, ev.prob), plans)
        if ev.kind == "flaky":
            return self._arm_all(member.flaky_rules(ev.prob), plans)
        if ev.kind == "pressure":
            return self._arm_all([FaultRule(
                site="kv.block.alloc", kind="pressure", prob=ev.prob,
            )], plans)
        if ev.kind == "handoff_partition":
            rules = (member.handoff_rules() if member is not None else
                     [FaultRule(site="worker.pd.push", kind="flap",
                                times=None)])
            return self._arm_all(rules, plans)
        if ev.kind == "handoff_corrupt":
            # fleet-wide: receivers see truncated handoff messages at prob
            return self._arm_all([FaultRule(
                site="kv.receiver.message", kind="truncate", cut=48,
                prob=ev.prob, times=None,
            )], plans)
        if ev.kind == "handoff_delay":
            rules = (member.handoff_delay_rules(ev.delay_s)
                     if member is not None else
                     [FaultRule(site="worker.pd.push", kind="delay",
                                delay_s=ev.delay_s, times=None)])
            return self._arm_all(rules, plans)
        if ev.kind == "disk_full":
            # every durable WRITE surface fails for the window: the plane's
            # store mutations (sql-matched, so reads keep serving) and
            # checkpoint upserts, the workers' spill puts and file persists
            return self._arm_all([
                FaultRule(site=s, kind="error", times=None, **kw)
                for s, kw in (
                    ("server.store.execute", {"match": {"sql": "INSERT*"}}),
                    ("server.store.execute", {"match": {"sql": "UPDATE*"}}),
                    ("server.store.checkpoint", {}),
                    ("io.spill.*.put", {}),
                    ("io.file.write", {}),
                )], plans)
        if ev.kind == "io_error":
            # flaky device: spill reads AND writes fail at prob, and the
            # plane's checkpoint writes too
            return self._arm_all([
                FaultRule(site=s, kind="error", prob=ev.prob, times=None)
                for s in ("io.spill.*", "server.store.checkpoint")], plans)
        if ev.kind == "io_slow":
            # browned-out device: every spill op pays delay_s
            return self._arm_all([FaultRule(
                site="io.spill.*", kind="delay", delay_s=ev.delay_s,
                times=None,
            )], plans)
        if ev.kind == "corrupt_read":
            # bit rot: spill frames and handoff staging read back flipped
            return self._arm_all([
                FaultRule(site=s, kind="corrupt", prob=ev.prob, times=None)
                for s in ("io.spill.remote.get", "io.handoff.stage")], plans)
        if ev.kind == "torn_write":
            # power-loss torn writes: spilled frames persist a prefix only
            return self._arm_all([FaultRule(
                site="io.spill.remote.put", kind="truncate", cut=32,
                prob=ev.prob, times=None,
            )], plans)
        if ev.kind == "plane_kill":
            # ev.worker indexes the PLANE cohort for plane events
            self.planes[ev.worker].kill()
            return None
        if ev.kind == "plane_restart":
            self.planes[ev.worker].start()
            return None
        if ev.kind in ("plane_partition", "plane_slow"):
            # cut (or tax) every request ADDRESSED TO this plane at the
            # client seams — worker API calls and SDK calls — while the
            # plane process itself stays up
            pat = f"*:{self.planes[ev.worker].port}"
            kw: Dict[str, Any] = (
                {"kind": "flap"} if ev.kind == "plane_partition"
                else {"kind": "delay", "delay_s": ev.delay_s}
            )
            return self._arm_all([
                FaultRule(site="worker.api.request", times=None,
                          match={"server": pat}, **kw),
                FaultRule(site="sdk.client.request", times=None,
                          match={"server": pat}, **kw),
            ], plans)
        raise ValueError(f"unknown fleet event kind {ev.kind!r}")


class FleetAutoscaler:
    """Ticker thread wiring a brownout autoscaler (``server/autoscaler.py``
    ``BrownoutAutoscaler`` of either package, or anything with its
    ``tick`` / ``note_scale_out_started`` / ``note_replica_serving``) to a
    :class:`LiveFleet`: every ``tick_s`` the controller sees the CURRENT
    alive replica count (chaos kills included) and a utilization estimate
    from ``queue_stats()`` — the plane's queue statistics
    (``{"queued": n, "workers": {"busy": b, "idle": i}}``), which the
    caller reads from its plane; ``scale_out`` adds a cold replica (the
    bring-up is timed and fed back as the cold-start lead time),
    ``scale_in`` retires the youngest."""

    def __init__(self, fleet: LiveFleet, autoscaler: Any,
                 queue_stats: Callable[[], Dict[str, Any]],
                 tick_s: float = 0.5,
                 scale_out_role: Optional[str] = None,
                 rebalancer: Optional[Any] = None) -> None:
        self.fleet = fleet
        self.autoscaler = autoscaler
        self.queue_stats = queue_stats
        self.tick_s = tick_s
        self.scale_out_role = scale_out_role
        # predictive rebalance: its starved-side suggestion (ticked every
        # loop) overrides the static scale_out_role
        self.rebalancer = rebalancer
        self.actions: List[tuple] = []       # (wall_offset_s, action)
        self._t0 = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._failure: Optional[BaseException] = None

    def _utilization(self) -> Optional[float]:
        """Coarse fleet utilization in [0, 1]: queued work saturates to
        1.0; otherwise the busy fraction of live workers."""
        try:
            stats = self.queue_stats()
        except Exception:  # noqa: BLE001 — plane busy: skip this tick
            return None
        if int(stats.get("queued") or 0) > 0:
            return 1.0
        w = stats.get("workers") or {}
        busy = int(w.get("busy") or 0)
        idle = int(w.get("idle") or 0)
        return busy / (busy + idle) if (busy + idle) else None

    def _loop(self) -> None:
        while not self._stop.wait(self.tick_s):
            replicas = len(self.fleet.alive_members())
            suggested = None
            if self.rebalancer is not None:
                try:
                    suggested = self.rebalancer.tick()
                except Exception:  # noqa: BLE001 — advisory
                    suggested = None
            action = self.autoscaler.tick(replicas, self._utilization())
            if action == "scale_out":
                self.actions.append(
                    (time.monotonic() - self._t0, "scale_out"))
                self.autoscaler.note_scale_out_started()
                self.fleet.scale_out(role=suggested or self.scale_out_role)
                # scale_out blocks through engine build + registration +
                # first heartbeat: this IS the cold-start lead time
                self.autoscaler.note_replica_serving()
            elif action == "scale_in":
                self.actions.append(
                    (time.monotonic() - self._t0, "scale_in"))
                self.fleet.scale_in()

    def start(self) -> "FleetAutoscaler":
        self._t0 = time.monotonic()

        def run() -> None:
            try:
                self._loop()
            except BaseException as exc:  # noqa: BLE001 — surfaced on stop
                self._failure = exc

        self._thread = threading.Thread(
            target=run, name="fleet-autoscaler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 60.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
            self._thread = None
        if self._failure is not None:
            failure, self._failure = self._failure, None
            raise failure
