"""The port's control-plane services (``distributed_gpu_inference_torch/
server/``) against the JAX package's (``distributed_gpu_inference_tpu/
server/``): each scenario runs once per package on the same seeded inputs
(numpy seed, one frozen clock) and must give equal outputs — scheduler
ranks, scores and claims, admission decisions, prefix-routing affinities
and KV-route choices, health transitions, calibration estimates, the
task-guarantee sweep, usage and bills, flight-recorder timelines, the PD
scheduler's placements and estimates, replication hints, reliability
predictions, worker configs, signing and privacy.

Store-backed scenarios normalise uuids to their order of first appearance.
"""

import asyncio
import importlib
import json
import time
from typing import Any, Callable, Dict, List

import numpy as np
import pytest

pytest.importorskip("torch")

PKGS = ("distributed_gpu_inference_tpu", "distributed_gpu_inference_torch")
T0 = 1_760_000_000.0
REGIONS = ["us-west", "us-east", "eu-west", "asia-east", "unknown"]


class Pkg:
    def __init__(self, root: str) -> None:
        self.root = root

    def __call__(self, rel: str) -> Any:
        return importlib.import_module(f"{self.root}.{rel}")


def both(scenario: Callable[[Pkg], Any]) -> Any:
    jax_out, port_out = (scenario(Pkg(root)) for root in PKGS)
    assert port_out == jax_out
    return port_out


def run(coro: Any) -> Any:
    return asyncio.run(coro)


@pytest.fixture(autouse=True)
def frozen_clock(monkeypatch):
    clock = {"t": T0}
    monkeypatch.setattr(time, "time", lambda: clock["t"])
    return clock


def normalise(obj: Any, ids: Dict[str, str]) -> Any:
    """Replace every uuid-looking string by its order of first appearance."""
    if isinstance(obj, dict):
        return {normalise(k, ids): normalise(v, ids) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [normalise(v, ids) for v in obj]
    if isinstance(obj, str) and (len(obj) == 36 and obj.count("-") == 4
                                 or len(obj) == 32 and all(c in "0123456789abcdef" for c in obj)):
        return ids.setdefault(obj, f"id{len(ids)}")
    return obj


def seeded_workers(rng: np.random.Generator, n: int) -> List[Dict[str, Any]]:
    out = []
    for i in range(n):
        out.append({
            "id": f"w{i}", "name": f"w{i}",
            "region": REGIONS[int(rng.integers(len(REGIONS)))],
            "supported_types": ["llm"] if i % 3 else ["llm", "embedding"],
            "status": "idle" if rng.random() < 0.7 else "busy",
            "last_heartbeat": T0 - float(rng.integers(0, 60)),
            "num_chips": int(rng.choice([1, 2, 4, 8])),
            "reliability_score": round(float(rng.random()), 3),
            "completed_jobs": int(rng.integers(0, 50)),
            "avg_latency_ms": float(rng.integers(50, 900)),
        })
    return out


# ---------------------------------------------------------------------------
# scheduler, reliability, task guarantee (store-backed)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_ranks_scores_and_claims_agree(seed):
    def scenario(P: Pkg) -> Any:
        rng = np.random.default_rng(seed)
        sched_mod = P("server.scheduler")

        async def body() -> Any:
            s = P("server.store").Store()
            rel = P("server.reliability").ReliabilityService(s)
            sched = sched_mod.SmartScheduler(s, rel)
            for w in seeded_workers(rng, 6):
                await s.upsert_worker(w)
            jobs = []
            for j in range(8):
                jobs.append({
                    "type": "llm" if j % 4 else "embedding",
                    "params": {"max_new_tokens": int(rng.integers(8, 512)),
                               "prompt": "p" * int(rng.integers(1, 400))},
                    "priority": int(rng.integers(0, 3)),
                    "preferred_region": REGIONS[int(rng.integers(4))],
                })
            out: Dict[str, Any] = {"ranks": [], "scores": []}
            for job in jobs:
                ranked = await sched.rank_workers(job)
                out["ranks"].append([w["id"] for w in ranked])
                out["scores"].append([sched.score_worker(w, job) for w in ranked])
                await s.create_job(dict(job))
            out["durations"] = [sched_mod.estimate_job_duration_s(
                j["type"], j["params"], 4) for j in jobs]
            out["distance"] = [[sched_mod.region_distance(a, b) for b in REGIONS]
                               for a in REGIONS]
            out["stats"] = await sched.get_queue_stats()
            claims = []
            for wid in ["w0", "w1", "w2", "w3", "w4", "w5", "w0"]:
                job = await sched.atomic_assign_job(wid)
                claims.append(None if job is None else
                              (job["type"], job["priority"], job["assignment_epoch"]))
            out["claims"] = claims
            out["after"] = await sched.get_queue_stats()
            s.close()
            return out

        return run(body())

    out = both(scenario)
    assert any(c is not None for c in out["claims"])


@pytest.mark.parametrize("seed", [0, 1])
def test_reliability_events_and_predictions_agree(seed):
    def scenario(P: Pkg) -> Any:
        rng = np.random.default_rng(seed)

        async def body() -> Any:
            s = P("server.store").Store()
            rel = P("server.reliability").ReliabilityService(s)
            for w in seeded_workers(rng, 3):
                await s.upsert_worker(w)
            events = ["complete", "fail", "unexpected_offline", "graceful_offline",
                      "long_session", "fast_response"]
            scores = []
            for k in range(24):
                wid = f"w{int(rng.integers(3))}"
                ev = events[int(rng.integers(len(events)))]
                scores.append(await rel.record_event(
                    wid, ev, latency_ms=float(rng.integers(10, 3000)),
                    now=T0 + k))
                await rel.update_online_pattern(wid, bool(rng.random() < 0.6),
                                                now=T0 + 3600.0 * k)
            preds = []
            for i in range(3):
                w = await s.get_worker(f"w{i}")
                preds.append((rel.predict_online_probability(w, now=T0 + 7200.0),
                              rel.predict_remaining_online_time(w, now=T0 + 7200.0)))
            s.close()
            return scores, preds

        return run(body())

    both(scenario)


def test_task_guarantee_sweep_agrees():
    def scenario(P: Pkg) -> Any:
        rng = np.random.default_rng(7)
        tg = P("server.task_guarantee")

        async def body() -> Any:
            s = P("server.store").Store()
            rel = P("server.reliability").ReliabilityService(s)
            g = tg.TaskGuaranteeService(s, rel, heartbeat_timeout_s=30.0)
            sched = P("server.scheduler").SmartScheduler(s, rel)
            for w in seeded_workers(rng, 4):
                w["status"] = "idle"
                await s.upsert_worker(w)
            for j in range(10):
                await s.create_job({"type": "llm", "params": {"max_new_tokens": 16},
                                    "max_retries": int(rng.integers(0, 3)),
                                    "timeout_seconds": float(rng.choice([5, 600]))})
            for wid in ["w0", "w1", "w2", "w3", "w0", "w1"]:
                await sched.atomic_assign_job(wid)
            # two workers go quiet past the heartbeat timeout
            await s.update_worker("w0", last_heartbeat=T0 - 100.0)
            await s.update_worker("w2", last_heartbeat=T0 - 100.0)
            swept = await g.sweep(now=T0 + 20.0)
            off = await g.handle_worker_offline("w3", graceful=True)
            rows = await s.query(
                "SELECT id, status, retry_count, worker_id, assignment_epoch "
                "FROM jobs ORDER BY created_at, id", ())
            workers = await s.query("SELECT id, status FROM workers ORDER BY id", ())
            s.close()
            ids: Dict[str, str] = {}
            # ids in creation order first, so both runs name them alike
            order = {r["id"]: i for i, r in enumerate(sorted(
                rows, key=lambda r: (r["status"], r["retry_count"])))}
            del order
            return normalise({"swept": {k: sorted(v) for k, v in swept.items()},
                              "offline": sorted(off) if isinstance(off, list) else off,
                              "rows": sorted((r["status"], r["retry_count"],
                                              r["worker_id"], r["assignment_epoch"])
                                             for r in rows),
                              "workers": workers}, ids)

        return run(body())

    out = both(scenario)
    assert any(out["swept"].values())


def test_usage_records_and_bills_agree():
    def scenario(P: Pkg) -> Any:
        rng = np.random.default_rng(3)
        usage = P("server.usage")

        async def body() -> Any:
            s = P("server.store").Store()
            u = usage.UsageService(s)
            await s.insert("enterprises", {"id": "ent1", "name": "acme",
                                           "custom_pricing": {"llm": 0.5}})
            recs = []
            types = ["llm", "embedding", "image_gen", "whisper", "vision"]
            for k in range(12):
                jt = types[int(rng.integers(len(types)))]
                job = {"id": f"job{k}", "type": jt, "worker_id": "w0",
                       "params": {"max_new_tokens": 32, "texts": ["a", "b"],
                                  "width": 256, "height": 256},
                       "result": {"usage": {"completion_tokens": int(rng.integers(1, 200)),
                                            "prompt_tokens": 7},
                                  "duration_s": 2.5, "embeddings": [[0.0]] * 2}}
                rec = await u.record_job_usage(job, enterprise_id="ent1" if k % 2 else None)
                recs.append({k2: v for k2, v in rec.items() if k2 != "id"})
            bill = await u.generate_bill("ent1", T0 - 10.0, T0 + 10.0)
            out = {"units": [usage.units_from_result(t, {"max_new_tokens": 9},
                                                     {"usage": {"completion_tokens": 4}})
                             for t in types],
                   "recs": recs,
                   "bill": {k: v for k, v in bill.items() if k != "id"},
                   "hourly": await u.hourly_summary("ent1", since=T0 - 3600.0),
                   "tenants": await u.tenant_summary(since=T0 - 3600.0),
                   "platform": await u.platform_stats()}
            s.close()
            return normalise(out, {})

        return run(body())

    both(scenario)


# ---------------------------------------------------------------------------
# admission, prefix routing, calibration, replication, health
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admission_decisions_agree(seed):
    def scenario(P: Pkg) -> Any:
        rng = np.random.default_rng(seed)
        adm = P("server.admission")
        wc = P("server.worker_config").WorkerConfigService(
            P("server.store").Store())
        wc.set_submit_queue_limit(20)
        ctl = adm.AdmissionController(adm.AdmissionConfig(
            enabled=True, rate_tokens_per_s=float(rng.choice([0, 200, 2000])),
            max_tenants=4))
        out = []
        for k in range(40):
            body = {"tenant": f"t{int(rng.integers(6))}",
                    "tier": ["paid", "free", "batch", "weird"][int(rng.integers(4))],
                    "params": {"max_new_tokens": int(rng.integers(1, 600)),
                               "prompt": "x" * int(rng.integers(0, 2000))}}
            tenant, tier = adm.tenant_of(body)
            cost = adm.estimate_cost_tokens(body["params"])
            d = ctl.decide(tenant, tier, cost, queued=int(rng.integers(0, 25)),
                           active_workers=int(rng.integers(0, 4)), worker_config=wc,
                           now=T0 + 0.25 * k,
                           decode_tokens=body["params"]["max_new_tokens"])
            out.append((tenant, tier, cost, d.action, d.admitted,
                        json.loads(json.dumps(d.flight_attrs(), default=str))))
        return out, ctl.snapshot(), dict(ctl.stats)

    both(scenario)


def _summaries(P: Pkg, rng: np.random.Generator, prompts: List[str]):
    ps = P("runtime.prefix_summary")
    sets = []
    for w in range(3):
        hs = ps.PrefixHotSet(top_n=16)
        for p in prompts:
            if rng.random() < 0.5:
                hs.note(p)
        sets.append(hs)
    return sets


@pytest.mark.parametrize("seed", [0, 1])
def test_prefix_routing_scores_and_routes_agree(seed):
    def scenario(P: Pkg) -> Any:
        rng = np.random.default_rng(seed)
        pr = P("server.prefix_routing")
        pf = P("utils.prefixes")
        heads = ["system: you are helpful " * 8, "doc header " * 20, "tool spec " * 15]
        prompts = [heads[int(rng.integers(3))] + f" q{i} " + "z" * int(rng.integers(0, 300))
                   for i in range(10)]
        cfg = pr.RoutingConfig()
        reg = pr.PrefixRegistry(cfg)
        results = []
        for w, hs in enumerate(_summaries(P, rng, prompts)):
            res = reg.ingest(f"w{w}", hs.wire(), now=T0)
            results.append((res.reason, res.resync) if hasattr(res, "reason") else str(res))
        out: Dict[str, Any] = {"ingest": results, "aff": [], "best": [], "route": []}
        for p in prompts:
            fps = pf.prefix_fingerprints(pf.canonical_prompt_text(p))
            out["aff"].append([reg.affinity(f"w{w}", fps, now=T0 + 1.0) for w in range(3)])
            out["best"].append(reg.best_match(["w0", "w1", "w2"], fps, now=T0 + 1.0))
        out["sanitize"] = [pf.sanitize_fingerprints(x) for x in
                           (["ab12"], ["ab12", "XYZ"], "nope", ["0" * 33])]
        for k in range(24):
            out["route"].append(pr.decide_kv_route(
                cfg, request_blocks=int(rng.integers(1, 12)),
                matched_blocks=int(rng.integers(0, 12)),
                tier=["device", "host", "remote"][int(rng.integers(3))],
                warm_headroom=float(rng.random()), cold_headroom=float(rng.random()),
                warm_is_cold=bool(rng.random() < 0.2),
                cold_inflight_pulls=int(rng.integers(0, 3))))
        out["metrics"] = reg.stats_for_metrics(now=T0 + 1.0)
        return json.loads(json.dumps(out, default=str))

    both(scenario)


def test_calibration_and_migrate_hints_agree():
    def scenario(P: Pkg) -> Any:
        rng = np.random.default_rng(11)
        pr = P("server.prefix_routing")
        cal_mod = P("server.calibration")
        cfg = pr.RoutingConfig()
        cfg.update({"calibrate": True})
        cal = cal_mod.CostCalibration(cfg)
        hints = cal_mod.MigrateHintTracker(cfg)
        landed = []
        for k in range(30):
            t = T0 + k
            ev = [("batcher.enqueued", t, None),
                  ("batcher.admitted", t + float(rng.random()),
                   {"tokens": int(rng.integers(1, 900))}),
                  ("batcher.first_token", t + 1.0 + float(rng.random()), None)]
            landed.append(cal.ingest_trace(f"w{k % 3}", f"tr{k}", ev))
            cal.ingest_kv_migrate(f"w{k % 3}", {
                "pull_bytes_host": float(1e6 * (k + 1)), "pull_ms_host": float(3 * (k + 1)),
                "pull_bytes_remote": float(5e5 * (k + 1) * (k % 2)),
                "pull_ms_remote": float(7 * (k + 1))})
            hints.note(f"w{k % 2}", now=t)
        return (landed, cal.snapshot(),
                [(cal.prefill_tps(f"w{i}"), cal.queue_wait_s(f"w{i}"),
                  cal.bandwidth(f"w{i}", "host")) for i in range(3)],
                [hints.inflight(f"w{i}", now=T0 + 29.5) for i in range(3)])

    both(scenario)


def test_replication_hints_agree():
    def scenario(P: Pkg) -> Any:
        rng = np.random.default_rng(5)
        pr = P("server.prefix_routing")
        cfg = pr.RoutingConfig()
        cfg.update({"replicate": True})
        reg = pr.PrefixRegistry(cfg)
        prompts = ["shared head " * 30 + f" tail {i}" for i in range(6)]
        for w, hs in enumerate(_summaries(P, rng, prompts)):
            reg.ingest(f"w{w}", hs.wire(), now=T0)
        planner = P("server.replication").ReplicationPlanner(cfg, reg)
        pf = P("utils.prefixes")
        for k in range(40):
            p = prompts[int(rng.integers(len(prompts)))]
            planner.note_query(pf.prefix_fingerprints(pf.canonical_prompt_text(p)),
                               now=T0 + 0.05 * k)
        sources = [{"id": f"w{i}", "data_plane_url": f"http://127.0.0.1:{9000 + i}"}
                   for i in range(3)]
        return ([planner.hints_for(f"w{i}", sources, now=T0 + 2.0) for i in range(3)],
                planner.snapshot())

    both(scenario)


@pytest.mark.parametrize("seed", [0, 1])
def test_health_transitions_agree(seed):
    def scenario(P: Pkg) -> Any:
        rng = np.random.default_rng(seed)
        h = P("server.health")
        transitions = []
        svc = h.HealthService(h.HealthConfig(enabled=True, hedge=True, grace_s=1.0,
                                             probation_after_s=2.0),
                              on_transition=lambda *a: transitions.append(a))
        states = []
        for k in range(60):
            now = T0 + 0.2 * k
            for w in range(4):
                slow = 12.0 if (w == 3 and 10 <= k < 40) else 1.0
                svc.observe(f"w{w}", float(rng.gamma(2.0, 20.0)) * slow, now=now)
            if k % 7 == 0:
                svc.observe_error("w2", count=int(rng.integers(0, 3)), now=now)
            svc.ingest("w1", {"heartbeat_rtt_ms": float(rng.integers(1, 50))}, now=now)
            svc.evaluate(now=now)
            states.append(svc.states())
            if svc.state("w3") == "probation":
                svc.allow_canary("w3")
        return (transitions, states, svc.snapshot(now=T0 + 12.0),
                svc.hedge_delay_ms(now=T0 + 12.0),
                svc.admissible(["w0", "w1", "w2", "w3"]))

    out = both(scenario)
    assert out[0], "no transition happened"


# ---------------------------------------------------------------------------
# flight recorder, PD scheduler
# ---------------------------------------------------------------------------


def test_flight_recorder_timelines_agree(frozen_clock):
    def scenario(P: Pkg) -> Any:
        rng = np.random.default_rng(9)
        fr = P("server.flight_recorder").FlightRecorder()
        out = []
        for k in range(6):
            frozen_clock["t"] = T0 + k
            tid = f"trace{k}"
            fr.note(tid, "server.admission", job_id=f"job{k}", decision="accept")
            fr.note(tid, "server.route", job_id=f"job{k}", choice="warm")
            events = [["worker.poll", T0 + k + 0.01, None],
                      ["batcher.enqueued", T0 + k + 0.02, None],
                      ["batcher.admitted", T0 + k + 0.03 + float(rng.random()) * 0.01,
                       {"tokens": 12}],
                      ["batcher.first_token", T0 + k + 0.2, None],
                      ["worker.done", T0 + k + 0.5, None]]
            wire = {"trace_id": tid, "source": f"worker:w{k % 2}", "events": events,
                    "done": True, "dropped": 0}
            out.append(fr.ingest_wire(f"w{k % 2}", wire))
            out.append(fr.ingest_wire(f"w{k % 2}", wire))    # re-delivery: no change
            frozen_clock["t"] = T0 + k + 0.6
            fr.note(tid, "server.completed", job_id=f"job{k}")
            fr.finalize(tid, "completed")
        return (out, [fr.timeline_for_job(f"job{k}") for k in range(6)],
                fr.slowest(), dict(fr.stats))

    both(scenario)


def test_pd_scheduler_placements_and_estimates_agree():
    def scenario(P: Pkg) -> Any:
        rng = np.random.default_rng(4)
        pd = P("server.pd_scheduler")
        ds = P("utils.data_structures")
        sched = pd.PrefillDecodeScheduler()
        roles = [ds.WorkerRole.PREFILL, ds.WorkerRole.DECODE, ds.WorkerRole.HYBRID]
        for i in range(5):
            topo = ds.TpuTopology.from_dict({
                "chip_type": ["v5e", "v4", "cpu", "NVIDIA H100 80GB HBM3"][i % 4],
                "num_chips": int(rng.choice([1, 4])), "hbm_gb_per_chip": 16.0,
                "mesh_shape": [1], "mesh_axis_names": ["data"],
                "ici_bandwidth_gbps": 400.0, "dcn_bandwidth_gbps": 25.0,
                "peak_bf16_tflops": float(rng.choice([197.0, 989.0]))})
            sched.register_worker(pd.WorkerCapability.from_topology(
                f"w{i}", topo, role=roles[i % 3], max_prefill_batch=2,
                max_decode_batch=3))
        out = []
        for k in range(14):
            req = pd.PDRequest(request_id=f"r{k}",
                               prompt_tokens=int(rng.integers(10, 4000)),
                               max_new_tokens=int(rng.integers(1, 512)),
                               priority=int(rng.integers(0, 3)), arrival=T0 + k)
            p = sched.place_prefill(req)
            d = sched.place_decode(req)
            out.append((p, d, req.kv_bytes, sched.estimate_prefill_latency_ms(req),
                        sched.estimate_decode_tpot_ms(req),
                        sched.estimate_migration_ms(req, p or "w0", d or "w1"),
                        sched.capacity_by_role()))
            if k % 3 == 2:
                sched.release(req)
        out.append(sched.preflip_role("prefill"))
        out.append(sched.restore_preflips())
        out.append(sched.get_stats())
        return out

    both(scenario)


# ---------------------------------------------------------------------------
# worker config, security, privacy, geo
# ---------------------------------------------------------------------------


def test_worker_config_merge_and_accept_rules_agree():
    def scenario(P: Pkg) -> Any:
        rng = np.random.default_rng(2)
        wc = P("server.worker_config")
        cfg = wc.WorkerRemoteConfig.from_dict({
            "version": 3, "load_control": {"acceptance_rate": 0.5,
                                           "max_concurrent_jobs": 2,
                                           "max_queue_depth": 10,
                                           "tier_queue_fractions": {"free": 0.5}},
            "model_configs": {"llm": {"model_id": "llama3-8b", "quantization": "int8"}},
        })
        svc = wc.WorkerConfigService(P("server.store").Store())
        svc.set_submit_queue_limit(10)
        acc = [svc.should_accept_submission(int(rng.integers(0, 14)),
                                            int(rng.integers(0, 3)),
                                            tier=["paid", "free", "batch"][k % 3])
               for k in range(20)]
        return cfg.to_dict(), acc

    both(scenario)


def test_request_signatures_verify_across_packages():
    jsec = importlib.import_module("distributed_gpu_inference_tpu.server.security")
    tsec = importlib.import_module("distributed_gpu_inference_torch.server.security")
    from distributed_gpu_inference_torch.worker import api_client

    # the port's worker client signs with the plane's one canonicalization
    assert api_client.RequestSigner is tsec.RequestSigner
    body = b'{"status": "idle"}'
    for signer, verifier in ((jsec.RequestSigner(), tsec.RequestSigner()),
                             (tsec.RequestSigner(), jsec.RequestSigner())):
        h = signer.sign("s3cret", "POST", "/api/v1/workers/w/heartbeat", body)
        assert verifier.verify("s3cret", "POST", "/api/v1/workers/w/heartbeat", body,
                               h["X-Timestamp"], h["X-Signature"])
        assert not verifier.verify("s3cret", "POST", "/api/v1/workers/w/heartbeat",
                                   body + b" ", h["X-Timestamp"], h["X-Signature"])
    for sec in (jsec, tsec):
        bundle, stored = sec.TokenManager(salt="s").issue()
        other = tsec if sec is jsec else jsec
        assert other.TokenManager(salt="s").verify(
            bundle.auth_token, stored["auth_token_hash"], stored["token_expires_at"])

    def scenario(P: Pkg) -> Any:
        s = P("server.security")
        pol = s.LockoutPolicy()
        st = s.LockoutState()
        out = []
        for k in range(7):
            st = pol.record_failure(st, now=T0 + k)
            out.append((st.failed_attempts, st.locked_until, pol.is_locked(st, now=T0 + k)))
        out.append(pol.is_locked(st, now=T0 + 3600.0))
        return out

    both(scenario)


def test_privacy_anonymizer_and_encryption_agree():
    def scenario(P: Pkg) -> Any:
        pv = P("server.privacy")
        a = pv.Anonymizer()
        text = "mail bob@example.com or call +1 415-555-0100, card 4111 1111 1111 1111"
        return (a.truncate_ip("203.0.113.77"), a.truncate_ip("2001:db8::1"),
                a.scrub_text(text), a.pseudonym("user-42"),
                a.anonymize_record({"client_ip": "198.51.100.9", "prompt": text}))

    both(scenario)
    jpv = importlib.import_module("distributed_gpu_inference_tpu.server.privacy")
    tpv = importlib.import_module("distributed_gpu_inference_torch.server.privacy")
    token = jpv.FieldEncryptor("pass").encrypt_field({"secret": "field"})
    assert tpv.FieldEncryptor("pass").decrypt_field(token) == {"secret": "field"}


def test_privacy_without_cryptography_names_it(monkeypatch):
    import sys

    tpv = importlib.import_module("distributed_gpu_inference_torch.server.privacy")
    monkeypatch.setitem(sys.modules, "cryptography", None)
    monkeypatch.setitem(sys.modules, "cryptography.fernet", None)
    with pytest.raises(RuntimeError, match="cryptography"):
        tpv.FieldEncryptor("pass")
    assert tpv.Anonymizer().truncate_ip("203.0.113.77")


def test_geo_resolver_runs_on_urllib_off_the_loop():
    import http.server
    import threading

    tgeo = importlib.import_module("distributed_gpu_inference_torch.server.geo")
    seen: List[str] = []

    class H(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802
            seen.append((self.path, threading.current_thread().name))
            body = json.dumps({"countryCode": "DE"}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/json/{{ip}}"
        geo = tgeo.GeoService([tgeo.make_http_resolver(url, "countryCode")])

        async def body():
            loop_thread = threading.current_thread().name
            region = await geo.detect_client_region("8.8.8.8")
            return loop_thread, region

        loop_thread, region = asyncio.run(body())
        assert region == tgeo.region_for_country("DE") == "eu-central"
        assert [p for p, _ in seen] == ["/json/8.8.8.8"]
        assert asyncio.run(geo.detect_client_region("10.0.0.1")) == "unknown"
    finally:
        srv.shutdown()


# ---------------------------------------------------------------------------
# metrics text without prometheus_client
# ---------------------------------------------------------------------------


def test_prom_text_writes_what_prometheus_client_writes():
    prom = pytest.importorskip("prometheus_client")
    from distributed_gpu_inference_torch.server import prom_text

    outs = []
    for m in (prom, prom_text):
        r = m.CollectorRegistry()
        c = m.Counter("req_total", 'Requests "quoted"', ["job_type", "status"], registry=r)
        g = m.Gauge("depth", "Queue depth", registry=r)
        g2 = m.Gauge("wstate", "per worker", ["worker"], registry=r)
        h = m.Histogram("lat_seconds", "Latency", ["phase"], registry=r,
                        buckets=(0.1, 1, 10))
        h2 = m.Histogram("e2e_seconds", "E2E", registry=r)
        c.labels("llm", 'done"\n').inc()
        c.labels(job_type="llm", status="rejected").inc(2.5)
        g.set(12345678.0)
        g2.labels("w1").set(2)
        g2.labels(worker="w1").dec()
        for v in (0.05, 0.5, 50.0):
            h.labels("queue").observe(v)
        h2.observe(0.3)
        outs.append([ln for ln in m.generate_latest(r).decode().splitlines()
                     if "_created" not in ln])
    assert outs[1] == outs[0]


def test_metrics_text_agrees_with_the_jax_plane_s_prometheus_client():
    # the JAX plane writes /metrics with prometheus_client, the port's
    # always with server/prom_text.py: the same samples, less *_created
    pytest.importorskip("prometheus_client")

    def text(P: Pkg) -> Any:
        m = P("server.observability").MetricsCollector()
        m.record_request("llm", "completed", 0.25)
        m.record_request("embedding", "failed", 3.0)
        return [ln for ln in m.render().decode().splitlines() if "_created" not in ln]

    both(text)


def test_torch_profiler_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    import torch

    from distributed_gpu_inference_torch.server import observability as tobs

    monkeypatch.undo()   # the profiler reads the real clock
    with tobs.torch_profiler_trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    traces = list(tmp_path.glob("trace-*.json"))
    assert len(traces) == 1 and json.loads(traces[0].read_text())["traceEvents"]
