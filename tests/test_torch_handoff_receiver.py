"""The port's ``HandoffReceiver`` session machine (``runtime/kv_handoff.py``)
on the JAX package's ``FakeKVEngine`` (real receiver code and block
accounting, no model) fed the JAX package's streamed-handoff messages
(``testing/fakes.make_stream_messages``, framed by the JAX writer): the
cases of ``tests/test_handoff_receiver_purge.py``, the purge policy of
``tests/test_kv_handoff_wire.py`` and the idempotency / purge-reason cases
of ``tests/test_pd_chaos.py``. No tolerance: block ids, counters and
session tables are compared exactly."""

import time
import types

import numpy as np
import pytest

pytest.importorskip("torch")

from distributed_gpu_inference_torch.runtime import kv_handoff as tkh  # noqa: E402
from distributed_gpu_inference_torch.testing import faults as tfaults  # noqa: E402
from distributed_gpu_inference_torch.utils import serialization as tser  # noqa: E402
from distributed_gpu_inference_torch.utils.data_structures import (  # noqa: E402
    InferenceRequest,
    SamplingParams,
)
from distributed_gpu_inference_tpu.testing.fakes import (  # noqa: E402
    FakeKVEngine,
    make_stream_messages,
)

PROMPT = list(range(10))     # 10 tokens, block size 4 → 3 blocks (with the pending one)


def _receiver():
    eng = FakeKVEngine(num_blocks=16)
    return eng, tkh.HandoffReceiver(eng)


def _messages(key):
    return make_stream_messages(key, PROMPT)


# -- tests/test_handoff_receiver_purge.py


def test_full_stream_commits_on_fake_engine():
    eng, rx = _receiver()
    out = None
    for msg in _messages("k1"):
        out = rx.handle(msg)
    assert out["state"] == "committed" and out["streamed"] is True
    assert eng.binds == 1 and rx._sessions == {}
    blocks = eng.manager.seq_blocks["r-k1-pd"]
    needed = -(-len(PROMPT) // eng.cfg.block_size)
    assert all(blocks[i] in eng.manager.applied for i in range(needed))
    # the page of block i carries the value i (the fake's tagging)
    assert [float(eng.manager.applied[blocks[i]].flatten()[0]) for i in range(needed)] \
        == [0.0, 1.0, 2.0]
    assert eng.leaked_blocks() == 0
    assert eng._last_tokens[out["slot"]] == 7
    assert list(eng._slot_keys[out["slot"]]) == [1, 2, 3, 4]


def test_ttl_expiry_frees_blocks_and_rejects_late_pieces():
    eng, rx = _receiver()
    msgs = _messages("k1")
    rx.handle(msgs[0])
    rx.handle(msgs[1])
    assert len(eng.manager.free_blocks) < eng.manager.num_blocks
    rx._sessions["k1"].last_activity -= rx.SESSION_TTL_S + 1.0
    rx._purge_stale()
    assert "k1" not in rx._sessions and eng.leaked_blocks() == 0
    assert len(eng.manager.free_blocks) == eng.manager.num_blocks
    assert eng.manager.pending.uploads == []
    with pytest.raises(ValueError, match="no streamed handoff session"):
        rx.handle(msgs[2])
    with pytest.raises(ValueError, match="no streamed handoff session"):
        rx.handle(msgs[-1])
    assert eng.binds == 0


def test_no_progress_backstop_purges_warm_but_stalled_session():
    eng, rx = _receiver()
    msgs = _messages("k1")
    rx.handle(msgs[0])
    rx.handle(msgs[1])
    progress_before = rx._sessions["k1"].last_progress
    rx.handle(msgs[1])                   # a duplicate piece: no new block
    assert rx._sessions["k1"].last_progress == progress_before
    rx.handle(msgs[2])                   # a new block is progress
    assert rx._sessions["k1"].last_progress >= progress_before
    rx._sessions["k1"].last_progress -= rx.SESSION_MAX_NO_PROGRESS_S + 1.0
    rx._purge_stale()
    assert "k1" not in rx._sessions and eng.leaked_blocks() == 0
    assert rx.stats["purged_no_progress"] == 1 and rx.stats["sessions_purged"] == 1
    with pytest.raises(ValueError, match="no streamed handoff session"):
        rx.handle(msgs[-1])


def test_malformed_piece_aborts_session_immediately():
    eng, rx = _receiver()
    msgs = _messages("k1")
    rx.handle(msgs[0])
    with pytest.raises(Exception):
        rx.handle(msgs[1][:40])          # a valid header, a mangled payload
    assert "k1" not in rx._sessions and eng.leaked_blocks() == 0


def test_commit_with_lost_piece_aborts_instead_of_binding_garbage():
    eng, rx = _receiver()
    msgs = _messages("k1")
    rx.handle(msgs[0])
    rx.handle(msgs[1])                   # blocks 0-1; block 2's piece is lost
    with pytest.raises(ValueError, match="unstaged blocks"):
        rx.handle(msgs[-1])
    assert "k1" not in rx._sessions and eng.binds == 0 and eng.leaked_blocks() == 0


def test_message_kind_names_each_frame():
    msgs = _messages("k1")
    assert [tkh.message_kind(m) for m in (msgs[0], msgs[1], msgs[-1])] == \
        ["begin", "piece", "commit"]
    assert tkh.message_kind(tkh.abort_message("k1")) == "abort"
    assert tkh.message_kind(b"notastream") == "blob"


# -- tests/test_pd_chaos.py: idempotency and counted purge reasons


def test_receiver_duplicate_begin_is_idempotent():
    eng, rx = _receiver()
    msgs = _messages("k1")
    rx.handle(msgs[0])
    out = rx.handle(msgs[0])             # a retried begin (its ACK was lost)
    assert out["state"] == "begun" and out.get("duplicate") is True
    assert rx.stats["begin_duplicates"] == 1
    kind, meta, payload = tkh._unpack_stream(_messages("k1")[0])
    meta["request"]["request_id"] = "someone-else"
    with pytest.raises(ValueError, match="already begun"):
        rx.handle(tkh._pack_stream(kind, meta, payload))
    for m in msgs[1:]:
        out = rx.handle(m)
    assert out["state"] == "committed" and eng.leaked_blocks() == 0


def test_receiver_commit_replay_answers_original_slot():
    eng, rx = _receiver()
    msgs = _messages("k2")
    for m in msgs:
        out = rx.handle(m)
    replay = rx.handle(msgs[-1])         # a retried commit (its ACK was lost)
    assert replay["state"] == "committed" and replay["slot"] == out["slot"]
    assert replay.get("replay") is True
    assert rx.stats["commit_replays"] == 1 and eng.binds == 1


def test_receiver_purge_reasons_counted():
    eng, rx = _receiver()
    rx.handle(_messages("k3")[0])
    rx._sessions["k3"].last_activity -= tkh.HandoffReceiver.SESSION_TTL_S + 1
    rx._purge_stale()
    assert rx.stats["purged_ttl"] == 1
    rx.handle(_messages("k4")[0])
    out = rx.handle(tkh.abort_message("k4"))
    assert out["state"] == "aborted" and rx.stats["rx_aborts"] == 1
    assert eng.leaked_blocks() == 0


def test_session_cap_evicts_the_stalest():
    eng = FakeKVEngine(num_blocks=64)
    rx = tkh.HandoffReceiver(eng)
    rx.MAX_SESSIONS = 3
    for i in range(4):
        rx.handle(make_stream_messages(f"c{i}", [1, 2, 3])[0])
        rx._sessions[f"c{i}"].last_activity -= 10 - i     # c0 stalest
    assert set(rx._sessions) == {"c1", "c2", "c3"}
    assert rx.stats["purged_cap"] == 1 and rx.stats["sessions_purged"] == 1
    assert eng.leaked_blocks() == 0


def test_receiver_message_seam_truncates_a_piece_and_aborts():
    # one rule text drives either package: truncate the piece in transit
    eng, rx = _receiver()
    msgs = _messages("k5")
    plan = tfaults.FaultPlan(0, [tfaults.FaultRule(
        site="kv.receiver.message", kind="truncate", cut=40, times=1)])
    rx.handle(msgs[0])
    with tfaults.active(plan):
        with pytest.raises(Exception):
            rx.handle(msgs[1])
    assert "k5" not in rx._sessions and eng.leaked_blocks() == 0
    assert [t[0] for t in plan.trace] == ["kv.receiver.message"]


def test_staging_seam_error_aborts_the_session():
    eng, rx = _receiver()
    msgs = _messages("k6")
    rx.handle(msgs[0])
    plan = tfaults.FaultPlan(0, [tfaults.FaultRule(site="io.handoff.stage", kind="error")])
    with tfaults.active(plan):
        with pytest.raises(OSError):
            rx.handle(msgs[1])
    assert "k6" not in rx._sessions and eng.leaked_blocks() == 0


# -- tests/test_kv_handoff_wire.py: the purge policy on a stub engine


def _stub_receiver():
    manager = types.SimpleNamespace(
        pending=types.SimpleNamespace(uploads=[], scale_uploads=[]),
        seq_blocks={}, free_sequence=lambda *a, **kw: None,
    )
    rx = tkh.HandoffReceiver.__new__(tkh.HandoffReceiver)
    rx.engine = types.SimpleNamespace(manager=manager, _apply_pending=lambda: None)
    rx._sessions = {}
    rx.stats = {"sessions_purged": 0}
    return rx


def _session():
    req = InferenceRequest(prompt_token_ids=[1, 2, 3],
                           sampling=SamplingParams(max_new_tokens=4))
    return tkh._AdoptSession(seq_id="s", request=req, block_size=16, blocks=[0],
                             cached_tokens=0, prompt_len=3)


def _payload():
    import torch

    return tser.serialize(torch.from_numpy(np.zeros((1, 2), np.float32)))


def test_purge_is_inactivity_based_not_age_based():
    rx = _stub_receiver()
    old = _session()
    old.last_activity = time.monotonic() - 1.0
    rx._sessions = {"live": old}
    rx._purge_stale()
    assert "live" in rx._sessions
    stale = _session()
    stale.last_activity = time.monotonic() - tkh.HandoffReceiver.SESSION_TTL_S - 1
    rx._sessions["stale"] = stale
    rx._purge_stale()
    assert "stale" not in rx._sessions and "live" in rx._sessions


def test_no_progress_backstop_bounds_trickling_donors():
    rx = _stub_receiver()
    s = _session()
    s.last_activity = time.monotonic()
    s.last_progress = time.monotonic() - tkh.HandoffReceiver.SESSION_MAX_NO_PROGRESS_S - 1
    progressing = _session()
    progressing.last_activity = time.monotonic()
    progressing.last_progress = time.monotonic() - 60.0
    rx._sessions = {"trickle": s, "big-migration": progressing}
    rx._purge_stale()
    assert "trickle" not in rx._sessions and "big-migration" in rx._sessions


def test_piece_with_new_block_refreshes_progress_clock():
    rx = _stub_receiver()
    s = _session()
    stale = time.monotonic() - tkh.HandoffReceiver.SESSION_MAX_NO_PROGRESS_S + 9
    s.last_progress = stale
    rx._sessions = {"k": s}
    payload = _payload()
    rx._piece({"key": "k", "block_lo": 0}, payload, len(payload))
    assert s.last_progress > stale
    s.last_progress = stale
    rx._piece({"key": "k", "block_lo": 0}, payload, len(payload))
    assert s.last_progress == stale


def test_piece_refreshes_last_activity():
    rx = _stub_receiver()
    sess = _session()
    sess.last_activity = time.monotonic() - tkh.HandoffReceiver.SESSION_TTL_S + 5
    rx._sessions = {"k": sess}
    before = sess.last_activity
    payload = _payload()
    rx._piece({"key": "k", "block_lo": 99}, payload, len(payload))
    assert rx._sessions["k"].last_activity > before
