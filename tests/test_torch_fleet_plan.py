"""The fleet chaos schedule and the fakes' wire, port against JAX: the
port's ``testing/faults.py`` ``FleetFaultPlan`` is the JAX generator copied,
so every seed, suite geometry and replay flag must name the same events
and print the same text in both packages; ``testing/fakes.py``
``make_stream_messages`` must write the JAX writer's bytes; and the port
harness must arm each fault rule in the registry that owns its site (the
port's seams here, the JAX plane's store and SDK seams there). No
tolerance: everything is compared exactly."""

import dataclasses

import pytest

pytest.importorskip("torch")

from distributed_gpu_inference_torch.testing import fakes as tfakes  # noqa: E402
from distributed_gpu_inference_torch.testing import faults as tfaults  # noqa: E402
from distributed_gpu_inference_torch.testing import harness as tharness  # noqa: E402
from distributed_gpu_inference_tpu.testing import fakes as jfakes  # noqa: E402
from distributed_gpu_inference_tpu.testing import faults as jfaults  # noqa: E402

N_SEEDS = 25

# each suite's kinds and geometry, as its replay flag reconstructs them
SUITES = {
    "fleet": ([], jfaults.FLEET_EVENT_KINDS, jfaults.FLEET_CHAOS_WORKERS),
    "pd": (["--pd"], jfaults.PD_CHAOS_KINDS, jfaults.PD_CHAOS_WORKERS),
    "planes": (["--planes"], jfaults.PLANE_CHAOS_KINDS, jfaults.PLANE_CHAOS_WORKERS),
    "gray": (["--gray"], jfaults.GRAY_CHAOS_KINDS, jfaults.GRAY_CHAOS_WORKERS),
    "io": (["--io"], jfaults.IO_CHAOS_SUITE_KINDS, jfaults.IO_CHAOS_WORKERS),
}

CONSTANTS = ("FLEET_EVENT_KINDS", "HANDOFF_EVENT_KINDS", "PLANE_EVENT_KINDS",
             "GRAY_EVENT_KINDS", "IO_CHAOS_KINDS", "ALL_FLEET_EVENT_KINDS",
             "FLEET_CHAOS_WORKERS", "FLEET_CHAOS_DURATION_S", "PD_CHAOS_WORKERS",
             "PD_CHAOS_KINDS", "PLANE_CHAOS_PLANES", "PLANE_CHAOS_WORKERS",
             "PLANE_CHAOS_KINDS", "GRAY_CHAOS_WORKERS", "GRAY_CHAOS_KINDS",
             "IO_CHAOS_WORKERS", "IO_CHAOS_SUITE_KINDS")


def _events(plan):
    return [dataclasses.astuple(e) for e in plan.events]


def test_suite_constants_equal():
    for name in CONSTANTS:
        assert getattr(tfaults, name) == getattr(jfaults, name), name


@pytest.mark.parametrize("suite", sorted(SUITES))
def test_schedules_equal_for_every_suite_seed(suite):
    _, kinds, workers = SUITES[suite]
    for seed in range(N_SEEDS):
        kw = dict(n_workers=workers, kinds=kinds, n_planes=jfaults.PLANE_CHAOS_PLANES)
        port, ref = tfaults.FleetFaultPlan(seed, **kw), jfaults.FleetFaultPlan(seed, **kw)
        assert port.describe() == ref.describe(), (suite, seed)
        assert _events(port) == _events(ref), (suite, seed)
        assert port.events, (suite, seed)


@pytest.mark.parametrize("duration,workers,disruptions", [(6.0, 2, 2), (9.5, 4, 1),
                                                           (2.0, 3, 3)])
def test_schedules_equal_off_the_suite_geometry(duration, workers, disruptions):
    for seed in range(N_SEEDS):
        kw = dict(n_workers=workers, duration_s=duration, max_disruptions=disruptions,
                  kinds=jfaults.ALL_FLEET_EVENT_KINDS)
        assert tfaults.FleetFaultPlan(seed, **kw).describe() == \
            jfaults.FleetFaultPlan(seed, **kw).describe(), seed


@pytest.mark.parametrize("suite", sorted(SUITES))
def test_replay_prints_the_same_text(suite, capsys):
    flags = SUITES[suite][0]
    for argv in (["--replay", "7"], ["--replay", "3", "--workers", "4",
                                     "--duration", "9.5"]):
        assert jfaults._replay_main(argv + flags) == 0
        ref = capsys.readouterr().out
        assert tfaults._replay_main(argv + flags) == 0
        assert capsys.readouterr().out == ref, argv + flags
        assert ref.strip()


def test_replay_with_explicit_kinds_and_mixed_flags(capsys):
    argv = ["--replay", "11", "--kinds", "kill,torn_write,plane_slow"]
    jfaults._replay_main(argv)
    ref = capsys.readouterr().out
    tfaults._replay_main(argv)
    assert capsys.readouterr().out == ref
    for mod in (tfaults, jfaults):
        with pytest.raises(SystemExit):
            mod._replay_main(["--replay", "1", "--gray", "--io"])
        assert "mutually exclusive" in capsys.readouterr().err


def test_unknown_kinds_raise_the_same_message():
    msgs = []
    for mod in (tfaults, jfaults):
        with pytest.raises(ValueError) as ei:
            mod.FleetFaultPlan(0, kinds=("kill", "meteor"))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] and "unknown fleet event kind 'meteor'" in msgs[0]


@pytest.mark.parametrize("suite", sorted(SUITES))
def test_windows_never_overlap(suite):
    """Generated disruptions are sequential: a 2-replica fleet always keeps
    a live replica, which the suites' liveness assertions rely on."""
    _, kinds, workers = SUITES[suite]
    for seed in range(60):
        plan = tfaults.FleetFaultPlan(seed, n_workers=workers, kinds=kinds)
        windows, down = [], {}
        for e in plan.events:
            if e.kind in ("kill", "plane_kill"):
                down[(e.kind, e.worker)] = e.at_s
            elif e.kind in ("restart", "plane_restart"):
                windows.append((down.pop((e.kind.replace("restart", "kill"), e.worker)),
                                e.at_s))
            elif e.duration_s:
                windows.append((e.at_s, e.at_s + e.duration_s))
        assert not down, (seed, "kill without a paired restart")
        windows.sort()
        for (_, e1), (s2, _) in zip(windows, windows[1:]):
            assert e1 <= s2, (seed, windows)


def test_filter_stream_matches_the_jax_plan():
    msgs = [bytes([i]) * (i + 3) for i in range(12)]
    rules = [("drop", {"after": 1, "times": 2}), ("duplicate", {"prob": 0.5}),
             ("reorder", {"after": 5, "times": 2}), ("truncate", {"cut": 2})]
    out = {}
    for name, mod in (("port", tfaults), ("jax", jfaults)):
        plan = mod.FaultPlan(9, [mod.FaultRule(site="x.msg", kind=k, **kw)
                                 for k, kw in rules])
        got = list(plan.filter_stream("x.msg", msgs, ctx_fn=lambda m: {"n": len(m)}))
        out[name] = (got, plan.trace)
    assert out["port"] == out["jax"]
    assert out["port"][0] != msgs


@pytest.mark.parametrize("kw", [
    dict(key="k1", prompt=list(range(10))),
    dict(key="long", prompt=[5] * 17, block_size=8, piece_blocks=3, max_new_tokens=9,
         pending_token=42),
    dict(key="one", prompt=[1], block_size=4, piece_blocks=1),
])
def test_make_stream_messages_writes_the_jax_bytes(kw):
    port, ref = tfakes.make_stream_messages(**kw), jfakes.make_stream_messages(**kw)
    assert port == ref
    assert [tfakes.stream_kind(m) for m in port] == [jfakes.stream_kind(m) for m in ref]
    assert tfakes.stream_kind(b"blob") == jfakes.stream_kind(b"blob") == "blob"


def test_fake_engine_block_accounting_matches():
    engines = [tfakes.FakeKVEngine(num_blocks=8), jfakes.FakeKVEngine(num_blocks=8)]
    for eng in engines:
        blocks, _ = eng.manager.allocate_sequence("a", list(range(9)))
        eng.manager.append_token("a", 3)
        eng.manager.allocate_sequence("b", [1, 2])
        eng.manager.free_sequence("a")
    assert engines[0].manager.free_blocks == engines[1].manager.free_blocks
    assert engines[0].leaked_blocks() == engines[1].leaked_blocks() == 0


# -- the harness's rule routing ------------------------------------------------


class _Plane:
    alive, url, port = True, "http://127.0.0.1:9", 9

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


class _Member:
    def __init__(self, i):
        self.tag, self.alive = f"m{i}", True

    def blackout(self, on):
        pass

    def __getattr__(self, name):     # the FleetWorker rule helpers
        return getattr(tharness.FleetWorker(0, "http://x"), name)


def _armed(kind, plane_faults=jfaults, **ev):
    fl = tharness.LiveFleet(n=0, planes=[_Plane()], plane_faults=plane_faults)
    fl.members = [_Member(0)]
    with fl.chaos_plans(seed=1) as plans:
        undo = fl._execute(tfaults.FleetEvent(0.0, kind, ev.pop("worker", -1),
                                              duration_s=1.0, **ev), plans)
        sites = [sorted(r.site for r in p.rules) if p is not None else None
                 for p in plans]
        undo()
        left = [len(p.rules) if p is not None else 0 for p in plans]
    return sites, left


@pytest.mark.parametrize("kind,ev,port,plane", [
    ("io_error", {"prob": 0.5}, ["io.spill.*"], ["server.store.checkpoint"]),
    ("disk_full", {}, ["io.file.write", "io.spill.*.put"],
     ["server.store.checkpoint", "server.store.execute", "server.store.execute"]),
    ("plane_partition", {"worker": 0}, ["worker.api.request"], ["sdk.client.request"]),
    ("plane_slow", {"worker": 0, "delay_s": 0.01}, ["worker.api.request"],
     ["sdk.client.request"]),
    ("pressure", {"prob": 0.3}, ["kv.block.alloc"], []),
    ("torn_write", {"prob": 0.3}, ["io.spill.remote.put"], []),
    ("partition", {"worker": 0}, ["worker.api.request", "worker.direct.request",
                                  "worker.direct.stream"], []),
])
def test_each_rule_is_armed_in_the_registry_that_owns_its_site(kind, ev, port, plane):
    sites, left = _armed(kind, **ev)
    assert sites == [port, plane]
    assert left == [0, 0]        # every window disarms in both registries


def test_plane_side_rules_fire_on_the_plane_seams_only():
    fl = tharness.LiveFleet(n=0, planes=[_Plane()], plane_faults=jfaults)
    with fl.chaos_plans(seed=3) as plans:
        assert tfaults.current() is plans[0] and jfaults.current() is plans[1]
        fl._execute(tfaults.FleetEvent(0.0, "io_error", -1, duration_s=1.0, prob=1.0),
                    plans)
        with pytest.raises(OSError):
            jfaults.io_fault("server.store.checkpoint")
        with pytest.raises(OSError):
            tfaults.io_fault("io.spill.host.get")
        # the port registry never holds the plane's site, nor the plane's
        # the worker's
        assert tfaults.current().fire("server.store.checkpoint") is None
        assert jfaults.current().fire("io.spill.host.get") is None
    assert tfaults.current() is None and jfaults.current() is None


def test_a_plane_side_event_without_plane_faults_refuses():
    with pytest.raises(ValueError, match="plane_faults"):
        _armed("disk_full", plane_faults=None)
    sites, _ = _armed("pressure", plane_faults=None, prob=0.5)
    assert sites == [["kv.block.alloc"], None]
