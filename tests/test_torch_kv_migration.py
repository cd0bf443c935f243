"""Cluster KV migration on the port (CPU, f32, ``llama3-tiny``, the same
weights as the JAX package's engines through ``models/convert.py``): the
ports of ``tests/test_kv_migration.py``'s engine-pair and worker cases —
prefix-only frames exported by the JAX package adopt in the port and the
port's adopt in the JAX package, every frame re-encoded by the port
byte-identical to the JAX writer's and the adopted pool pages bit-identical
to the frames; a prefix served from the host spill tier; a partially warm
puller shipped only its missing blocks; a corrupt piece and a lost piece
abort without leaks; the worker's pull end to end over two port
data planes with its fallbacks (dead peer, 4xx pin-out, backoff, budget);
and ``kv_replicate``'s background pull. Greedy ids and frames compared
exactly."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_gpu_inference_torch.comm.data_plane import DataPlaneServer  # noqa: E402
from distributed_gpu_inference_torch.models.convert import params_from_numpy  # noqa: E402
from distributed_gpu_inference_torch.runtime import engine as tengine  # noqa: E402
from distributed_gpu_inference_torch.runtime import kv_handoff as tkh  # noqa: E402
from distributed_gpu_inference_torch.utils import data_structures as tds  # noqa: E402
from distributed_gpu_inference_torch.utils import serialization as tser  # noqa: E402
from distributed_gpu_inference_torch.utils.prefixes import (  # noqa: E402
    canonical_prompt_text,
    prefix_fingerprints,
)
from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine  # noqa: E402
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402
from distributed_gpu_inference_tpu.models.configs import get_model_config  # noqa: E402
from distributed_gpu_inference_tpu.runtime import engine as jengine  # noqa: E402
from distributed_gpu_inference_tpu.runtime import kv_handoff as jkh  # noqa: E402
from distributed_gpu_inference_tpu.utils import data_structures as jds  # noqa: E402

MODEL = "llama3-tiny"
GEOM = dict(max_batch_size=2, max_seq_len=160, multi_step=4, dtype="float32",
            prefill_buckets=(16, 32, 64, 128))
PROMPT = list(range(4, 4 + 96))          # 6 full blocks of 16


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(get_model_config(MODEL), jax.random.PRNGKey(3), jnp.float32)
    return jp, jax.tree.map(np.asarray, jp)


def _jax(weights, **kw):
    return jengine.TPUEngine(MODEL, jengine.EngineConfig(**GEOM, **kw), params=weights[0])


def _port(weights, **kw):
    return tengine.TorchEngine(MODEL, tengine.EngineConfig(**GEOM, **kw),
                               params=params_from_numpy(weights[1], "cpu"), device="cpu")


def _greedy(eng, ds, prompt=PROMPT, n=8):
    req = ds.InferenceRequest(prompt_token_ids=list(prompt),
                              sampling=ds.SamplingParams(max_new_tokens=n))
    slot = eng.submit_batch([req])[0]
    while eng.slots[slot] is not None and eng.slots[slot].finish_reason is None:
        eng.decode_step()
    return eng.finish_slot(slot)


@pytest.fixture(scope="module")
def donor(weights):
    """A JAX engine whose radix holds PROMPT, and its greedy ids."""
    eng = _jax(weights)
    return eng, list(_greedy(eng, jds).token_ids)


def _reencoded(msg):
    kind, meta, payload = tkh._unpack_stream(msg)
    if kind != tkh._KIND_PIECE:
        return tkh._pack_stream(kind, meta, payload)
    pages, scales = tkh._read_pages(payload, None)
    return tkh._piece_frame(meta["key"], meta["block_lo"], pages, scales)


def test_jax_prefix_frames_adopt_in_the_port(weights, donor):
    jeng, ref = donor
    frames, info = jkh.export_prefix_frames(jeng, PROMPT, "k1")
    assert info == {"dev_blocks": 6, "spill_blocks": 0}
    assert all(_reencoded(f) == f for f in frames)
    cold = _port(weights)
    rx = tkh.HandoffReceiver(cold)
    last = [rx.handle(f) for f in frames][-1]
    assert last["state"] == "committed" and last["prefix_only"] is True
    assert rx.stats["prefix_commits"] == 1
    # the adopted pool pages equal the frames' pages, bit for bit
    blocks = cold.manager.radix.match_prefix(PROMPT)
    assert len(blocks) == 6
    pages = torch.cat([tkh._read_pages(tkh._unpack_stream(f)[2], None)[0] for f in frames[1:-1]])
    got = torch.stack([torch.stack((cold.kv["k"][:, b], cold.kv["v"][:, b]), 1)
                       for b in blocks])
    assert torch.equal(got.view(torch.int32), pages.view(torch.int32))
    # a transfer is not a serving request: the query stats are untouched
    assert cold.manager.stats.prefix_queries == 0
    out = _greedy(cold, tds)
    assert list(out.token_ids) == ref and out.cached_tokens >= 80


def test_port_prefix_frames_adopt_in_jax(weights, donor):
    _, ref = donor
    warm = _port(weights)
    assert list(_greedy(warm, tds).token_ids) == ref
    frames, info = tkh.export_prefix_frames(warm, PROMPT, "k2", piece_blocks=4)
    assert info == {"dev_blocks": 6, "spill_blocks": 0}
    assert [tkh.message_kind(f) for f in frames] == ["begin", "piece", "piece", "commit"]
    cold = _jax(weights)
    rx = jkh.HandoffReceiver(cold)
    assert [rx.handle(f) for f in frames][-1]["state"] == "committed"
    out = _greedy(cold, jds)
    assert list(out.token_ids) == ref and out.cached_tokens >= 80


def test_prefix_export_serves_from_the_spill_tier(weights, donor):
    _, ref = donor
    warm = _port(weights, spill_host_blocks=64)
    _greedy(warm, tds)
    warm.manager.clear_cached(spill=True)
    warm._apply_pending()
    assert len(warm.manager.host_store) > 0
    l2 = warm.manager.stats.l2_hits
    frames, info = tkh.export_prefix_frames(warm, PROMPT, "k3")
    assert info["dev_blocks"] == 0 and info["spill_blocks"] > 0
    assert warm.manager.stats.l2_hits == l2          # peer demand is not ours
    cold = _port(weights)
    rx = tkh.HandoffReceiver(cold)
    for f in frames:
        rx.handle(f)
    out = _greedy(cold, tds)
    assert list(out.token_ids) == ref and out.cached_tokens > 0


def test_partial_overlap_ships_only_missing_blocks(weights, donor):
    jeng, ref = donor
    warm = _port(weights)
    _greedy(warm, tds)
    cold = _port(weights)
    _greedy(cold, tds, PROMPT[:40])                  # 2 full blocks cached
    frames, info = tkh.export_prefix_frames(warm, PROMPT, "k5", start_block=2)
    assert info["dev_blocks"] + info["spill_blocks"] == 4
    full, _ = tkh.export_prefix_frames(warm, PROMPT, "k5f")
    pieces = [f for f in frames if tkh.message_kind(f) == "piece"]
    assert 0 < sum(map(len, pieces)) < sum(len(f) for f in full
                                           if tkh.message_kind(f) == "piece")
    assert tkh._unpack_stream(pieces[0])[1]["block_lo"] == 2
    rx = tkh.HandoffReceiver(cold)
    assert [rx.handle(f) for f in frames][-1]["state"] == "committed"
    out = _greedy(cold, tds)
    assert list(out.token_ids) == ref and out.cached_tokens >= 80
    assert tkh.export_prefix_frames(warm, PROMPT, "k6", start_block=6)[0] == []


def test_corrupt_piece_aborts_session_without_leaks(weights, donor):
    jeng, _ = donor
    frames, _ = jkh.export_prefix_frames(jeng, PROMPT, "k7")
    cold = _port(weights)
    free, radix = cold.manager.num_free, len(cold.manager.radix)
    rx = tkh.HandoffReceiver(cold)
    rx.handle(frames[0])
    with pytest.raises(Exception):
        rx.handle(frames[1][:-24])
    assert "k7" not in rx._sessions
    assert cold.manager.num_free == free and len(cold.manager.radix) == radix
    assert not cold.manager.pending.uploads
    with pytest.raises(ValueError):
        rx.handle(frames[-1])


def test_commit_with_lost_piece_aborts(weights, donor):
    jeng, _ = donor
    frames, _ = jkh.export_prefix_frames(jeng, PROMPT, "k8", piece_blocks=2)
    cold = _port(weights)
    free = cold.manager.num_free
    rx = tkh.HandoffReceiver(cold)
    for f in frames[:-2]:                            # the last piece is lost
        rx.handle(f)
    with pytest.raises(ValueError, match="unstaged"):
        rx.handle(frames[-1])
    assert "k8" not in rx._sessions and cold.manager.num_free == free


def test_export_request_codec_matches_jax():
    kw = dict(key="k", token_ids=[1, 2, 300, 70000], model_name=MODEL, block_size=16,
              int8_kv=True, max_blocks=8, start_block=2)
    raw = tkh.pack_export_request(**kw)
    assert raw == jkh.pack_export_request(**kw)
    assert tkh.pack_export_request(**kw, fp="abc") == jkh.pack_export_request(**kw, fp="abc")
    assert tkh.unpack_export_request(raw) == jkh.unpack_export_request(raw)
    with pytest.raises(ValueError, match="version"):
        tkh.unpack_export_request(tser.packb({**tser.unpackb(raw), "v": 2}))
    body = tkh._frame_blobs(b"a", b"bb")
    assert tkh.split_frames(body) == jkh.split_frames(body) == [b"a", b"bb"]
    with pytest.raises(ValueError, match="truncated"):
        tkh.split_frames(body[:-1])


# -- the worker's pull over two port data planes

SYSTEM = "s" * 128                       # 8 KV blocks, 2 fingerprint blocks


@pytest.fixture()
def pair(weights):
    out = []
    for _ in range(2):
        llm = TorchLLMEngine({"model": MODEL, "max_batch_size": 2, "max_seq_len": 256,
                              "multi_step": 4, "dtype": "float32", "device": "cpu",
                              "params": params_from_numpy(weights[1], "cpu"),
                              "serving": {"queue_limit": 64, "default_timeout_s": 60.0}})
        llm.load_model()
        plane = DataPlaneServer(kv_receiver=llm.kv_receiver, kv_exporter=llm.kv_export)
        plane.start()
        out.append((llm, plane))
    yield out
    for llm, plane in out:
        plane.stop()
        llm.unload()


def test_worker_pull_end_to_end_and_fallbacks(pair):
    (warm, warm_plane), (cold, _) = pair
    warm_url = warm_plane.url
    prompt = SYSTEM + "q" * 24
    ref = warm.inference({"prompt": prompt, "max_new_tokens": 16})
    hint = {"worker_id": "warm", "data_plane_url": warm_url, "matched_blocks": 2,
            "tier": "dev"}
    out = cold.inference({"prompt": prompt, "max_new_tokens": 16,
                          "kv_migrate_from": dict(hint)})
    assert out["text"] == ref["text"] and out["usage"]["cached_tokens"] >= 128
    st = cold.kv_migrate_stats
    assert st["pulled"] == 1 and st["pull_blocks"] >= 8 and st["pull_bytes"] > 0
    assert st["pull_bytes_dev"] == st["pull_bytes"] and st["pull_ms_dev"] >= 1
    assert warm.kv_migrate_stats["exports"] == 1
    assert warm.kv_migrate_stats["export_bytes"] > 0
    assert cold.kv_migrate_wire_stats()["prefix_commits"] == 1
    # still hinted but already warm here: the local probe skips the pull
    out2 = cold.inference({"prompt": prompt, "max_new_tokens": 16,
                           "kv_migrate_from": dict(hint)})
    assert out2["text"] == ref["text"]
    assert st["pulled"] == 1 and st["local_hits"] == 1
    assert warm.kv_migrate_stats["exports"] == 1
    # a dead peer: recompute, never a client error
    prompt2 = "t" * 128 + "u" * 24
    ref2 = warm.inference({"prompt": prompt2, "max_new_tokens": 16})
    out3 = cold.inference({"prompt": prompt2, "max_new_tokens": 16,
                           "kv_migrate_from": {"data_plane_url": "http://127.0.0.1:9"}})
    assert out3["text"] == ref2["text"] and st["aborted"] == 1
    # a peer that rejects the pull (4xx) is pinned out
    prompt3 = "w" * 128 + "x" * 24
    ref3 = warm.inference({"prompt": prompt3, "max_new_tokens": 8})
    warm.kv_migrate_enabled = False                  # the export answers 400
    out4 = cold.inference({"prompt": prompt3, "max_new_tokens": 8,
                           "kv_migrate_from": dict(hint)})
    assert out4["text"] == ref3["text"] and st["aborted"] == 2
    _, until = cold._kvmig_backoff[warm_url]
    assert until - time.monotonic() > 60.0
    warm.kv_migrate_enabled = True
    cold._kvmig_backoff.pop(warm_url, None)
    # an armed backoff window skips the pull outright
    cold._kvmig_backoff["http://127.0.0.1:9"] = (2, time.monotonic() + 60.0)
    before = st["fallback_recompute"]
    cold.inference({"prompt": "v" * 128 + "w" * 8, "max_new_tokens": 8,
                    "kv_migrate_from": {"data_plane_url": "http://127.0.0.1:9"}})
    assert st["fallback_recompute"] == before + 1
    # no budget: recompute
    cold._kvmig_budget = 0
    cold.inference({"prompt": "y" * 128 + "z" * 8, "max_new_tokens": 8,
                    "kv_migrate_from": dict(hint)})
    assert st["fallback_recompute"] == before + 2
    assert not cold._handoff_rx._sessions


def test_kv_replicate_pulls_the_hinted_prefix(pair):
    (warm, warm_plane), (cold, _) = pair
    prompt = SYSTEM + "r" * 24
    ref = warm.inference({"prompt": prompt, "max_new_tokens": 8})
    hot = cold.prefix_hot
    fps = prefix_fingerprints(canonical_prompt_text(prompt), hot.block_chars, hot.max_blocks)
    assert fps
    n = cold.kv_replicate([{"fps": fps, "data_plane_url": warm_plane.url, "tier": "dev"},
                           {"fps": "not-a-list"}])
    assert n == 1
    deadline = time.time() + 30
    while cold.kv_migrate_stats["replicated"] < 1 and time.time() < deadline:
        time.sleep(0.01)
    assert cold.kv_migrate_stats["replicated"] == 1
    assert set(fps) <= set(hot.snapshot())
    out = cold.inference({"prompt": prompt, "max_new_tokens": 8})
    assert out["text"] == ref["text"] and out["usage"]["cached_tokens"] >= 128
    # an unknown fingerprint is an honest miss
    cold.kv_replicate([{"fps": ["f" * 16], "data_plane_url": warm_plane.url}])
    deadline = time.time() + 30
    while cold.kv_migrate_stats["replicate_miss"] < 1 and time.time() < deadline:
        time.sleep(0.01)
    assert cold.kv_migrate_stats["replicate_miss"] == 1
