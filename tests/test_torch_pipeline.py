"""Pipeline stages on the port (CPU, f32, ``llama3-tiny`` / ``qwen2.5-tiny``,
the JAX package's weights carried over with ``models/convert.py``): the
ports of ``tests/test_comm_pipeline.py`` and of
``tests/test_concurrency.py``'s stage churn, held to the JAX package.

- planning (``parallel/pipeline.py``): ``uniform_stages``,
  ``create_shard_plan`` (its errors too), ``slice_stage_params`` on dense,
  int8 and tied trees (views of the whole tree), ``layer_param_bytes``,
  ``ModelShardConfig`` and ``SessionConfig``;
- stage workers: a two-stage forward's hidden and logits against JAX's two
  stages and the whole model (rtol = atol = 1e-4, the JAX test's bound;
  f32 on both sides), dense and int8; sessions, the free list, threads;
  the B > 1 shared block list in both packages;
- the data plane over real sockets: the session routes' statuses against
  the JAX plane's for the same requests;
- sessions over the planes: greedy tokens equal to the JAX engine's,
  recovery mid-generation, no spare, ``max_length``, the LRU manager, a
  fault rule on ``comm.session.forward``; and mixed routes (JAX session on
  port stages, port session on JAX stages, a JAX stage 0 with a port
  stage 1), tokens compared exactly.
"""

import dataclasses
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import httpx  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_gpu_inference_torch.comm import data_plane as tplane  # noqa: E402
from distributed_gpu_inference_torch.comm import session as tsession  # noqa: E402
from distributed_gpu_inference_torch.comm import stage_worker as tstage  # noqa: E402
from distributed_gpu_inference_torch.comm.wire import pack_message  # noqa: E402
from distributed_gpu_inference_torch.models import configs as tconfigs  # noqa: E402
from distributed_gpu_inference_torch.models.convert import (  # noqa: E402
    params_from_numpy,
    params_to_numpy,
)
from distributed_gpu_inference_torch.parallel import pipeline as tpipe  # noqa: E402
from distributed_gpu_inference_torch.testing import faults as tfaults  # noqa: E402
from distributed_gpu_inference_torch.utils import data_structures as tds  # noqa: E402
from distributed_gpu_inference_tpu.comm import data_plane as jplane  # noqa: E402
from distributed_gpu_inference_tpu.comm import session as jsession  # noqa: E402
from distributed_gpu_inference_tpu.comm import stage_worker as jstage  # noqa: E402
from distributed_gpu_inference_tpu.models import configs as jconfigs  # noqa: E402
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402
from distributed_gpu_inference_tpu.ops.quantization import quantize_params  # noqa: E402
from distributed_gpu_inference_tpu.parallel import pipeline as jpipe  # noqa: E402
from distributed_gpu_inference_tpu.runtime.engine import EngineConfig, TPUEngine  # noqa: E402
from distributed_gpu_inference_tpu.utils import data_structures as jds  # noqa: E402

MODEL = "llama3-tiny"
PROMPT = [5, 17, 3, 99, 42, 7, 256, 31]
TOL = dict(rtol=1e-4, atol=1e-4)   # f32 on both sides (the JAX test's bound)
GEOM = dict(num_blocks=64, max_blocks_per_seq=8, dtype="float32")
SESSION = dict(max_length=64, max_retries_per_hop=2, retry_backoff_s=0.01)


@pytest.fixture(scope="module")
def weights():
    """(JAX tree, numpy tree, the port's tree on the CPU)."""
    jp = jllama.init_params(jconfigs.get_model_config(MODEL), jax.random.PRNGKey(0),
                            jnp.float32)
    npt = jax.tree.map(np.asarray, jp)
    return jp, npt, params_from_numpy(npt, "cpu")


@pytest.fixture(scope="module")
def oracle(weights):
    """The JAX engine's greedy tokens for PROMPT (the JAX test's reference)."""
    eng = TPUEngine(MODEL, EngineConfig(max_batch_size=1, max_seq_len=64, block_size=16,
                                        prefill_buckets=(8, 16, 32), dtype="float32"),
                    params=weights[0])
    return eng.generate([jds.InferenceRequest(
        prompt_token_ids=list(PROMPT),
        sampling=jds.SamplingParams(max_new_tokens=6, temperature=0.0))])[0].token_ids


def _tstage(weights, rng, **kw):
    return tstage.PipelineStageWorker(MODEL, rng, full_params=weights[2], device="cpu",
                                      **{**GEOM, **kw})


def _jstage(weights, rng, **kw):
    return jstage.PipelineStageWorker(MODEL, rng, full_params=weights[0], **{**GEOM, **kw})


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layers,stages", [(2, 1), (2, 2), (32, 2), (32, 3), (7, 4),
                                           (80, 6), (5, 5)])
def test_uniform_stages_match_jax(layers, stages):
    assert tpipe.uniform_stages(layers, stages) == jpipe.uniform_stages(layers, stages)


def _plan_or_error(mod, cfg, hbm):
    try:
        return mod.create_shard_plan(cfg, hbm)
    except ValueError as exc:
        return f"ValueError: {exc}"


GIB = 1 << 30


@pytest.mark.parametrize("model,hbm", [
    ("llama3-8b", [80 * GIB, 80 * GIB]),
    ("llama3-8b", [80 * GIB, 40 * GIB, 16 * GIB]),
    ("llama3-8b", [16 * GIB, 16 * GIB]),               # fits 24 of 32 layers
    ("llama3-8b", [80 * GIB, 100 << 20]),              # stage 1 fits none
    ("llama3-tiny", [1 << 20] * 3),                    # 3 stages > 2 layers
    ("llama3-70b", [80 * GIB] * 4),
    ("mixtral-8x7b", [80 * GIB, 80 * GIB]),
    ("mixtral-8x7b", [96 * GIB, 64 * GIB, 32 * GIB]),
])
def test_create_shard_plan_matches_jax(model, hbm):
    got = _plan_or_error(tpipe, tconfigs.get_model_config(model), hbm)
    assert got == _plan_or_error(jpipe, jconfigs.get_model_config(model), hbm)


@pytest.mark.parametrize("model", ["llama3-tiny", "llama3-8b", "mixtral-8x7b", "qwen2.5-tiny"])
@pytest.mark.parametrize("nbytes", [1, 2, 4])
def test_layer_param_bytes_match_jax(model, nbytes):
    assert tconfigs.get_model_config(model).layer_param_bytes(nbytes) == \
        jconfigs.get_model_config(model).layer_param_bytes(nbytes)


def _tree(model, mode):
    cfg = jconfigs.get_model_config(model, num_layers=4)
    jp = jllama.init_params(cfg, jax.random.PRNGKey(1), jnp.float32)
    jp = quantize_params(jp, mode)
    npt = jax.tree.map(np.asarray, jp)
    return jp, params_from_numpy(npt, "cpu")


def _storages(tree):
    out = set()
    for v in tree.values():
        out |= _storages(v) if isinstance(v, dict) else {v.untyped_storage().data_ptr()}
    return out


@pytest.mark.parametrize("model,mode", [("llama3-tiny", None), ("llama3-tiny", "int8"),
                                        ("qwen2.5-tiny", None), ("qwen2.5-tiny", "int8")])
@pytest.mark.parametrize("rng", [(0, 1), (1, 3), (3, 4), (0, 4), (2, 4)])
def test_slice_stage_params_match_jax_as_views(model, mode, rng):
    jp, tp = _tree(model, mode)
    want = jax.tree.map(np.asarray, jpipe.slice_stage_params(jp, *rng, num_layers=4))
    got = tpipe.slice_stage_params(tp, *rng, num_layers=4)
    got_np = params_to_numpy(got)
    assert jax.tree_util.tree_structure(got_np) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree.leaves(got_np), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    # views of the whole tree: no leaf has storage of its own
    assert _storages(got) <= _storages(tp)
    # a tied model's last stage keeps the embedding as its head
    if model == "qwen2.5-tiny" and rng[1] == 4:
        assert "embedding" in got and "lm_head" not in got


SHARD_CASES = [
    dict(stages=[(0, 2), (2, 4)]),
    dict(stages=[(1, 2), (2, 4)]),
    dict(stages=[(0, 2), (2, 3)]),
    dict(stages=[(0, 2), (3, 4)]),
    dict(stages=[(0, 3), (2, 4)]),
    dict(stages=[(0, 2), (2, 4)], stage_workers=["w0"]),
    dict(stages=[(0, 2), (2, 4)], stage_workers=["w0", "w1"]),
    dict(stages=[]),
]


def _shard_outcome(ds, case):
    try:
        cfg = ds.ModelShardConfig("m", 4, stages=[ds.BlockRange(*r) for r in case["stages"]],
                                  stage_workers=list(case.get("stage_workers", [])))
        cfg.validate()
        return ("ok", cfg.num_stages, [cfg.stage_for_layer(i) for i in range(4)],
                [(w, (r.start, r.end)) for w, r in cfg.get_inference_route()])
    except ValueError as exc:
        return f"ValueError: {exc}"


@pytest.mark.parametrize("case", range(len(SHARD_CASES)))
def test_model_shard_config_matches_jax(case):
    assert _shard_outcome(tds, SHARD_CASES[case]) == _shard_outcome(jds, SHARD_CASES[case])


def test_session_config_defaults_match_jax():
    # the port keeps the fields a session reads, each with JAX's default
    port, jax = dataclasses.asdict(tds.SessionConfig()), dataclasses.asdict(jds.SessionConfig())
    assert set(port) == {"max_length", "max_retries_per_hop", "retry_backoff_s"}
    assert port == {k: jax[k] for k in port}


def test_stage_worker_runs_on_cuda_unless_asked(weights):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tstage.PipelineStageWorker(MODEL, (0, 2), full_params=weights[2], **GEOM)


# ---------------------------------------------------------------------------
# stage workers in process
# ---------------------------------------------------------------------------


def _run_two(stages, sid, chunks):
    """Drive ``chunks`` [(tokens, positions, kv_len_after)] through two
    stages → [(hidden of stage 1, logits)] as numpy."""
    for st in stages:
        st.create_session(sid)
    outs = []
    for toks, pos, n in chunks:
        h = stages[0].forward(sid, toks, pos, n)["hidden"]
        out = stages[1].forward(sid, h, pos, n)
        outs.append((np.asarray(out["hidden"]), np.asarray(out["logits"])))
    return outs


def _chunks():
    s = len(PROMPT)
    return [(np.asarray([PROMPT], np.int32), np.arange(s, dtype=np.int32)[None], s),
            (np.asarray([[11]], np.int32), np.asarray([[s]], np.int32), s + 1),
            (np.asarray([[300]], np.int32), np.asarray([[s + 1]], np.int32), s + 2)]


def _full_model_logits(weights, toks):
    cfg = jconfigs.get_model_config(MODEL)
    kv = jllama.init_kv_pools(cfg, 64, 16, jnp.float32)
    s = len(toks)
    table = np.zeros((1, 8), np.int32)
    table[0] = np.arange(1, 9)
    out = jllama.forward_chunk(
        cfg, weights[0], jnp.asarray(np.asarray(toks, np.int32)[None]),
        jnp.asarray(np.arange(s, dtype=np.int32)[None]), kv, jnp.asarray(table),
        jnp.asarray(np.asarray([s], np.int32)), block_size=16, last_only=False)
    return np.asarray(out.logits, np.float32)


def test_two_stage_forward_matches_jax_and_the_whole_model(weights):
    ranges = [(0, 1), (1, 2)]
    port = _run_two([_tstage(weights, r) for r in ranges], "s1", _chunks())
    ref = _run_two([_jstage(weights, r) for r in ranges], "s1", _chunks())
    for (th, tl), (jh, jl) in zip(port, ref):
        np.testing.assert_allclose(th, jh, **TOL)
        np.testing.assert_allclose(tl, jl, **TOL)
    # the whole model over prompt + the two decode tokens, position by position
    whole = _full_model_logits(weights, PROMPT + [11, 300])
    np.testing.assert_allclose(port[0][1][0], whole[0, :len(PROMPT)], **TOL)
    np.testing.assert_allclose(port[1][1][0, 0], whole[0, len(PROMPT)], **TOL)
    np.testing.assert_allclose(port[2][1][0, 0], whole[0, len(PROMPT) + 1], **TOL)


@pytest.mark.parametrize("model,mode", [("llama3-tiny", "int8"), ("qwen2.5-tiny", None),
                                        ("qwen2.5-tiny", "int8")])
def test_two_stage_forward_matches_jax_on_quantized_and_tied_trees(model, mode):
    jp, tp = _tree(model, mode)
    cfg_t = tconfigs.get_model_config(model, num_layers=4)
    cfg_j = jconfigs.get_model_config(model, num_layers=4)
    ranges = [(0, 3), (3, 4)]
    port = _run_two([tstage.PipelineStageWorker(cfg_t, r, full_params=tp, device="cpu", **GEOM)
                     for r in ranges], "q", _chunks())
    ref = _run_two([jstage.PipelineStageWorker(cfg_j, r, full_params=jp, **GEOM)
                    for r in ranges], "q", _chunks())
    for (th, tl), (jh, jl) in zip(port, ref):
        np.testing.assert_allclose(th, jh, **TOL)
        np.testing.assert_allclose(tl, jl, **TOL)


def test_rows_of_a_b2_session_share_pages_in_both_packages(weights):
    """All rows of a session get its one block list and kv_lens (JAX
    ``stage_worker.py:190-191``, mirrored): row 0 writes positions 0-3,
    row 1 positions 4-7 of the same pages, so row 1 attends over row 0's
    tokens as if they were its own prefix."""
    toks = np.asarray([PROMPT[:4] + [0] * 4, [0] * 4 + PROMPT[4:]], np.int32)
    pos = np.asarray([[0, 1, 2, 3, -1, -1, -1, -1], [-1, -1, -1, -1, 4, 5, 6, 7]], np.int32)
    ranges = [(0, 1), (1, 2)]
    port = _run_two([_tstage(weights, r) for r in ranges], "b2", [(toks, pos, 8)])[0]
    ref = _run_two([_jstage(weights, r) for r in ranges], "b2", [(toks, pos, 8)])[0]
    np.testing.assert_allclose(port[1], ref[1], **TOL)
    # one block list for the two rows: the session holds one sequence's blocks
    st = _tstage(weights, (0, 1))
    st.create_session("b2")
    st.forward("b2", toks, pos, 8)
    assert st.health()["free_blocks"] == 62
    # row 1's logits at positions 4-7 are those of the whole prompt alone
    whole = _full_model_logits(weights, PROMPT)
    for got in (port[1], ref[1]):
        np.testing.assert_allclose(got[1, 4:], whole[0, 4:], **TOL)
        np.testing.assert_allclose(got[0, :4], whole[0, :4], **TOL)


def test_stage_session_isolation(weights):
    st = _tstage(weights, (0, 2))
    st.create_session("a")
    st.create_session("b")
    assert st.create_session("a") == {"session_id": "a", "existing": True}
    assert st.health()["active_sessions"] == 2
    st.forward("a", np.asarray([PROMPT * 3], np.int32),
               np.arange(24, dtype=np.int32)[None], 24)
    assert st.health()["free_blocks"] == 61
    st.close_session("a")
    h = st.health()
    assert h["active_sessions"] == 1 and h["free_blocks"] == 63
    assert h["stats"] == {"forwards": 1, "sessions_created": 2, "sessions_closed": 1,
                          "tokens_processed": 24}
    assert set(h) == set(_jstage(weights, (0, 2)).health())


def test_stage_out_of_blocks_and_unknown_session(weights):
    st = _tstage(weights, (0, 2), num_blocks=4, max_blocks_per_seq=2)
    st.create_session("a")
    with pytest.raises(tstage.StageOutOfBlocksError, match="per-seq limit 2"):
        st.forward("a", np.asarray([PROMPT * 5], np.int32),
                   np.arange(40, dtype=np.int32)[None], 40)
    st.forward("a", np.asarray([PROMPT * 4], np.int32), np.arange(32, dtype=np.int32)[None], 32)
    st.create_session("b")
    with pytest.raises(tstage.StageOutOfBlocksError, match="exhausted"):
        st.forward("b", np.asarray([PROMPT * 4], np.int32),
                   np.arange(32, dtype=np.int32)[None], 32)
    with pytest.raises(KeyError, match="unknown session"):
        st.forward("nope", np.asarray([[1]], np.int32), np.asarray([[0]], np.int32), 1)


def test_replay_never_moves_kv_len_back(weights):
    st = _tstage(weights, (0, 2))
    st.create_session("r")
    first = st.forward("r", np.asarray([PROMPT], np.int32), np.arange(8, dtype=np.int32)[None], 8)
    st.forward("r", np.asarray([[9]], np.int32), np.asarray([[8]], np.int32), 9)
    again = st.forward("r", np.asarray([PROMPT], np.int32), np.arange(8, dtype=np.int32)[None], 8)
    assert st._sessions["r"].kv_len == 9
    assert torch.equal(first["hidden"], again["hidden"])     # page rewrites are idempotent


def test_stage_worker_sessions_under_threads(weights):
    """Six threads create, forward and close sessions on one stage: every
    block returns exactly once (the port of test_concurrency.py:118, with
    forwards that take blocks)."""
    st = _tstage(weights, (0, 2), num_blocks=128, max_blocks_per_seq=4)
    barrier = threading.Barrier(6)
    errors = []

    def churn(tid):
        try:
            barrier.wait(timeout=30)
            for i in range(25):
                sid = f"s{tid}-{i}"
                st.create_session(sid)
                st.forward(sid, np.asarray([PROMPT * 5], np.int32),
                           np.arange(40, dtype=np.int32)[None], 40)
                st.close_session(sid)
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=churn, args=(t,)) for t in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    h = st.health()
    assert h["active_sessions"] == 0 and h["free_blocks"] == 127
    assert sorted(st._free) == list(range(1, 128))
    assert h["stats"]["forwards"] == 150


# ---------------------------------------------------------------------------
# the data plane over real sockets
# ---------------------------------------------------------------------------


def _bad_requests():
    good = {"session_id": "s", "kv_len_after": 8}
    tensors = {"x": np.asarray([PROMPT], np.int32),
               "positions": np.arange(8, dtype=np.int32)[None]}
    return {
        "create without id": ("/inference/create_session", b'{}', "json"),
        "create empty id": ("/inference/create_session", b'{"session_id": ""}', "json"),
        "create not json": ("/inference/create_session", b'{nope', "json"),
        "close unknown": ("/inference/close", b'{"session_id": "zz"}', "json"),
        "forward garbage": ("/inference/forward", b"garbage", "bin"),
        "forward empty": ("/inference/forward", b"", "bin"),
        "forward unknown session": ("/inference/forward",
                                    pack_message({**good, "session_id": "zz"}, tensors), "bin"),
        "forward no session id": ("/inference/forward",
                                  pack_message({"kv_len_after": 8}, tensors), "bin"),
        "forward no positions": ("/inference/forward",
                                 pack_message(good, {"x": tensors["x"]}), "bin"),
        "forward out of blocks": ("/inference/forward",
                                  pack_message({**good, "kv_len_after": 4000}, tensors), "bin"),
        "forward bad shape": ("/inference/forward",
                              pack_message(good, {"x": np.zeros((1, 8, 3), np.float32),
                                                  "positions": tensors["positions"]}), "bin"),
    }


BAD = _bad_requests()


@pytest.fixture(scope="module")
def both_planes(weights):
    """A port plane and a JAX plane, each serving a whole-model stage with a
    live session "s"."""
    t = _tstage(weights, (0, 2))
    j = _jstage(weights, (0, 2))
    for st in (t, j):
        st.create_session("s")
    tp = tplane.DataPlaneServer(stage=t)
    jp = jplane.DataPlaneServer(j, host="127.0.0.1", port=0)
    tp.start()
    jp.start()
    yield tp.url, f"http://127.0.0.1:{jp.bound_port}"
    tp.stop()
    jp.stop()


@pytest.mark.parametrize("name", sorted(BAD))
def test_session_routes_answer_as_the_jax_plane(both_planes, name):
    path, body, kind = BAD[name]
    ctype = "application/json" if kind == "json" else "application/octet-stream"
    got = [httpx.post(url + path, content=body, headers={"Content-Type": ctype},
                      timeout=30).status_code for url in both_planes]
    assert got[0] == got[1], (name, got)
    want = {"create without id": 400, "create empty id": 400, "forward garbage": 400,
            "forward empty": 400, "forward unknown session": 404,
            "forward out of blocks": 507, "close unknown": 200, "forward bad shape": 500}
    if name in want:
        assert got[0] == want[name]


def test_forward_and_health_over_the_port_plane(both_planes, weights):
    url = both_planes[0]
    r = httpx.post(url + "/inference/create_session", json={"session_id": "h"}, timeout=30)
    assert r.json() == {"session_id": "h", "existing": False}
    ws = tsession.WorkerSession(url, tds.BlockRange(0, 2), timeout_s=30)
    out = ws.forward("h", np.asarray([PROMPT], np.int32), np.arange(8, dtype=np.int32)[None], 8)
    assert out["logits"].dtype == torch.float32 and tuple(out["logits"].shape) == (1, 8, 512)
    h = ws.health()
    assert h["layer_range"] == [0, 2] and h["active_sessions"] == 2
    ws.close("h")
    assert ws.health()["active_sessions"] == 1


def test_a_plane_without_a_stage_answers_404():
    plane = tplane.DataPlaneServer()
    plane.start()
    try:
        for path in tplane._SESSION_ROUTES:
            assert httpx.post(plane.url + path, content=b"{}", timeout=30).status_code == 404
    finally:
        plane.stop()


# ---------------------------------------------------------------------------
# sessions over the planes
# ---------------------------------------------------------------------------


class Cluster:
    """Stages (port or JAX, by ``kinds``) for (0, 1), (1, L) and a spare
    (1, L), each behind its package's data plane on 127.0.0.1."""

    def __init__(self, weights, kinds=("t", "t", "t")):
        L = jconfigs.get_model_config(MODEL).num_layers
        self.ranges = [(0, 1), (1, L), (1, L)]
        self.stages, self.planes, self.urls = [], [], []
        for kind, rng in zip(kinds, self.ranges):
            if kind == "t":
                st = _tstage(weights, rng)
                plane = tplane.DataPlaneServer(stage=st)
                plane.start()
                url = plane.url
            else:
                st = _jstage(weights, rng)
                plane = jplane.DataPlaneServer(st, host="127.0.0.1", port=0)
                plane.start()
                url = f"http://127.0.0.1:{plane.bound_port}"
            self.stages.append(st)
            self.planes.append(plane)
            self.urls.append(url)

    def route(self, mod=tsession, n=2):
        return [mod.WorkerSession(u, (tds if mod is tsession else jds).BlockRange(*r),
                                  timeout_s=30.0)
                for u, r in zip(self.urls[:n], self.ranges)]

    def session(self, mod=tsession, spare=False):
        ds = tds if mod is tsession else jds
        spares = [mod.WorkerSession(self.urls[2], ds.BlockRange(*self.ranges[2]),
                                    timeout_s=30.0)] if spare else None
        return mod.DistributedInferenceSession(self.route(mod), ds.SessionConfig(**SESSION),
                                               spare_workers=spares)

    def stop(self):
        for p in self.planes:
            p.stop()


@pytest.fixture()
def cluster(weights):
    c = Cluster(weights)
    yield c
    c.stop()


def test_pipeline_greedy_matches_engine(cluster, oracle):
    sess = cluster.session()
    sess.setup()
    assert sess.generate_greedy(PROMPT, max_new_tokens=6) == oracle
    sess.close()
    for st in cluster.stages[:2]:
        assert st.health()["active_sessions"] == 0 and st.health()["free_blocks"] == 63


def test_pipeline_failure_recovery_mid_generation(cluster, oracle):
    """Kill stage 1's plane mid-generation: the session reroutes to the
    spare, replays the history and finishes with the same tokens."""
    sess = cluster.session(spare=True)
    sess.setup()
    logits = sess.step(np.asarray(PROMPT, np.int32)[None, :])
    toks = [int(torch.argmax(logits[0, -1]))]
    at_kill = None
    for i in range(5):
        if i == 2:
            cluster.planes[1].stop()
            at_kill = len(sess.history)
        logits = sess.step(np.asarray([[toks[-1]]], np.int32))
        toks.append(int(torch.argmax(logits[0, -1])))
    assert toks == oracle
    assert sess.stats["reroutes"] == 1 and sess.stats["hop_failures"] == 1
    assert sess.stats["retries"] == SESSION["max_retries_per_hop"]
    assert sess.stats["replayed_chunks"] == at_kill == 3
    assert sess.route[1].base_url == cluster.urls[2]
    sess.close()
    assert cluster.stages[2].health()["free_blocks"] == 63


def test_pipeline_no_spare_raises(cluster):
    sess = cluster.session()
    sess.setup()
    sess.step(np.asarray(PROMPT, np.int32)[None, :])
    cluster.planes[1].stop()
    with pytest.raises(tsession.PipelineHopError, match="no spare"):
        sess.step(np.asarray([[1]], np.int32))


def test_session_max_length_enforced(cluster):
    sess = tsession.DistributedInferenceSession(cluster.route(),
                                                tds.SessionConfig(max_length=4))
    sess.setup()
    with pytest.raises(ValueError, match="max_length"):
        sess.step(np.asarray(PROMPT, np.int32)[None, :])
    sess.close()


def test_a_4xx_other_than_404_raises_at_once(cluster):
    sess = cluster.session()
    sess.setup()
    with tfaults.active(tfaults.FaultPlan(rules=[tfaults.FaultRule(
            site="comm.session.forward", kind="error", status=409, times=1)])):
        with pytest.raises(tsession.PipelineHopError, match="409"):
            sess.step(np.asarray(PROMPT, np.int32)[None, :])
    assert sess.stats["retries"] == 0


def test_a_dropped_hop_is_retried(cluster, oracle):
    """A ``comm.session.forward`` rule drops stage 1's second forward: one
    retry, the same tokens, no reroute."""
    sess = cluster.session(spare=True)
    plan = tfaults.FaultPlan(seed=0, rules=[tfaults.FaultRule(
        site="comm.session.forward", kind="drop", after=3, times=1,
        match={"url": cluster.urls[1]})])
    with tfaults.active(plan):
        toks = sess.generate_greedy(PROMPT, max_new_tokens=6)
    assert toks == oracle
    assert sess.stats["retries"] == 1 and sess.stats["reroutes"] == 0
    assert [(site, kind) for site, kind, _ in plan.trace] == [("comm.session.forward", "drop")]
    sess.close()


def test_concurrent_sessions_equal_their_solo_runs(cluster, oracle):
    other = [9, 8, 7, 6, 5, 4, 3, 2, 1, 0, 11]
    solo = cluster.session().generate_greedy(other, max_new_tokens=6)
    out = {}

    def run(key, prompt):
        out[key] = cluster.session().generate_greedy(prompt, max_new_tokens=6)

    threads = [threading.Thread(target=run, args=(k, p))
               for k, p in (("a", PROMPT), ("b", other))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert out == {"a": oracle, "b": solo}


class _FakeSession:
    def __init__(self, sid):
        self.session_id = sid
        self.closed = False

    def close(self):
        self.closed = True


def test_session_manager_lru_eviction():
    mgr = tsession.SessionManager(max_sessions=2)
    a, b, c = _FakeSession("a"), _FakeSession("b"), _FakeSession("c")
    mgr.add(a)
    mgr.add(b)
    assert mgr.get("a") is a  # touch a → b becomes LRU
    mgr.add(c)
    assert len(mgr) == 2
    assert b.closed
    assert mgr.get("b") is None
    mgr.close_all()
    assert a.closed and c.closed and len(mgr) == 0


# ---------------------------------------------------------------------------
# mixed routes: one package's session over the other's stages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kinds,client", [
    (("t", "t", "t"), jsession),     # JAX session (httpx) on port stages
    (("j", "j", "j"), tsession),     # port session on JAX stages (aiohttp)
    (("j", "t", "t"), tsession),     # JAX stage 0, port stage 1
    (("j", "t", "t"), jsession),
])
def test_mixed_routes_give_the_jax_engine_tokens(weights, oracle, kinds, client):
    c = Cluster(weights, kinds)
    try:
        sess = c.session(client)
        sess.setup()
        assert sess.generate_greedy(PROMPT, max_new_tokens=6) == oracle
        sess.close()
    finally:
        c.stop()


def test_jax_session_recovers_onto_a_port_spare(weights, oracle):
    c = Cluster(weights, ("j", "j", "t"))
    try:
        sess = c.session(jsession, spare=True)
        sess.setup()
        logits = sess.step(np.asarray(PROMPT, np.int32)[None, :])
        toks = [int(np.argmax(logits[0, -1]))]
        for i in range(5):
            if i == 1:
                c.planes[1].stop()
            logits = sess.step(np.asarray([[toks[-1]]], np.int32))
            toks.append(int(np.argmax(logits[0, -1])))
        assert toks == oracle
        assert sess.stats["reroutes"] == 1 and sess.stats["replayed_chunks"] == 2
        sess.close()
    finally:
        c.stop()
