"""The port's gRPC plane (``comm/{pb,h2,grpc_plane}.py``, the standard
library only) held to the JAX package's grpcio plane on the CPU
(``llama3-tiny`` in f32, the JAX weights carried over with
``models/convert.py``):

- ``pb``: bytes equal to JAX ``pb``'s on seeded messages of every spec,
  each decoding the other's output; the JAX package's five codec tests;
  the specs against ``google.protobuf`` messages built with
  ``descriptor_pb2`` from ``proto/inference.proto``.
- the interop matrix {port server, JAX grpcio server} x {port client, JAX
  grpcio client}: health (``layer_start`` 0 from both, a mirrored reference
  fault), the session lifecycle, unary Forward, StreamForward greedy equal
  to unary, the error codes (unknown session, no receiver, out of blocks,
  unknown method), the KV receiver, logits (port against JAX at rtol =
  atol = 1e-4, each server's logits bitwise equal through both clients,
  port over gRPC bitwise equal to port over HTTP), the hung-stage timeout,
  ``DEADLINE_EXCEEDED``, the 4 MiB receive limit both ways with grpcio's
  code and wording, a reply of several MB across the flow-control windows,
  grpcio's ``x-trace-bin`` metadata and gzip requests, 9 streams on 8
  workers, ``stop(grace)`` with a stream in flight;
- the fault seam ``comm.grpc.forward`` in both packages.
"""

import re
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
grpc = pytest.importorskip("grpc")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_gpu_inference_torch.comm import data_plane as tplane  # noqa: E402
from distributed_gpu_inference_torch.comm import grpc_plane as tgp  # noqa: E402
from distributed_gpu_inference_torch.comm import h2  # noqa: E402
from distributed_gpu_inference_torch.comm import pb as tpb  # noqa: E402
from distributed_gpu_inference_torch.comm import stage_worker as tstage  # noqa: E402
from distributed_gpu_inference_torch.comm.session import WorkerSession  # noqa: E402
from distributed_gpu_inference_torch.models.convert import params_from_numpy  # noqa: E402
from distributed_gpu_inference_torch.testing import faults as tfaults  # noqa: E402
from distributed_gpu_inference_torch.utils.data_structures import BlockRange  # noqa: E402
from distributed_gpu_inference_tpu.comm import grpc_plane as jgp  # noqa: E402
from distributed_gpu_inference_tpu.comm import pb as jpb  # noqa: E402
from distributed_gpu_inference_tpu.comm import stage_worker as jstage  # noqa: E402
from distributed_gpu_inference_tpu.models import configs as jconfigs  # noqa: E402
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402
from distributed_gpu_inference_tpu.testing import faults as jfaults  # noqa: E402

MODEL = "llama3-tiny"
TOL = dict(rtol=1e-4, atol=1e-4)   # f32 on both sides, as tests/test_torch_pipeline.py
GEOM = dict(num_blocks=64, max_blocks_per_seq=8, dtype="float32")
SERVERS = ("port", "jax")
CLIENTS = ("port", "jax")
LIMIT = 4 * 1024 * 1024
SPECS = {name: getattr(jpb, name) for name in (
    "TENSOR", "CREATE_SESSION_REQUEST", "CREATE_SESSION_RESPONSE", "FORWARD_REQUEST",
    "FORWARD_RESPONSE", "TRANSFER_KV_REQUEST", "TRANSFER_KV_RESPONSE",
    "CLOSE_SESSION_REQUEST", "CLOSE_SESSION_RESPONSE", "HEALTH_REQUEST", "HEALTH_RESPONSE")}


# ---------------------------------------------------------------------------
# the proto3 codec
# ---------------------------------------------------------------------------


def _random_msg(spec, rng, depth=0):
    out = {}
    for num, (name, kind) in sorted(spec.items()):
        r = rng.random()
        if r < 0.15:
            continue                               # absent
        if kind == "string":
            out[name] = "" if r < 0.25 else "".join(
                rng.choice(list("abcxyz-é日0")) for _ in range(rng.integers(1, 40)))
        elif kind == "bytes":
            out[name] = b"" if r < 0.25 else rng.bytes(int(rng.integers(1, 300)))
        elif kind == "varint":
            out[name] = 0 if r < 0.25 else int(rng.choice(
                [1, 127, 128, 300, 2 ** 31 - 1, -1, -5, -(2 ** 31)]))
        elif kind == "bool":
            out[name] = bool(r < 0.6)
        else:
            out[name] = _random_msg(kind[1], rng, depth + 1)
    return out


@pytest.mark.parametrize("spec_name", sorted(SPECS))
def test_pb_bytes_equal_jax_and_decode_each_other(spec_name):
    spec = SPECS[spec_name]
    assert getattr(tpb, spec_name) == spec
    rng = np.random.default_rng(sum(map(ord, spec_name)))
    for _ in range(40):
        msg = _random_msg(spec, rng)
        data = tpb.encode(spec, msg)
        assert data == jpb.encode(spec, msg)
        assert tpb.decode(spec, data) == jpb.decode(spec, data)
        assert tpb.deserializer(spec)(jpb.serializer(spec)(msg)) == \
            jpb.deserializer(spec)(tpb.serializer(spec)(msg))


def test_pb_roundtrip_all_kinds():
    msg = {"session_id": "sess-1", "kv_len_after": 300, "x": {"frame": b"\x01\x02\x03"},
           "positions": {"frame": b""}}
    out = tpb.decode(tpb.FORWARD_REQUEST, tpb.encode(tpb.FORWARD_REQUEST, msg))
    assert out["session_id"] == "sess-1" and out["kv_len_after"] == 300
    assert out["x"]["frame"] == b"\x01\x02\x03"
    assert out["positions"] is None or out["positions"]["frame"] == b""


def test_pb_defaults_and_unknown_fields():
    out = tpb.decode(tpb.HEALTH_RESPONSE, b"")
    assert out["status"] == "" and out["free_blocks"] == 0 and out["is_last"] is False
    data = tpb.encode(tpb.CLOSE_SESSION_RESPONSE, {"status": "closed"})
    data += tpb._encode_varint(99 << 3 | 0) + tpb._encode_varint(7)
    assert tpb.decode(tpb.CLOSE_SESSION_RESPONSE, data)["status"] == "closed"


def test_pb_negative_and_bool():
    spec = {1: ("a", "varint"), 2: ("b", "bool")}
    out = tpb.decode(spec, tpb.encode(spec, {"a": -5, "b": True}))
    assert out["a"] == -5 and out["b"] is True


def test_pb_wire_compat_with_protobuf_manual():
    assert tpb.encode(tpb.CREATE_SESSION_REQUEST, {"session_id": "hi"}) == b"\x0a\x02hi"


def test_pb_truncated_fixed_fields_raise():
    spec = {1: ("a", "varint")}
    good = tpb.encode(spec, {"a": 3})
    with pytest.raises(ValueError, match="truncated fixed64"):
        tpb.decode(spec, good + tpb._encode_varint(9 << 3 | 1) + b"\x00\x01\x02")
    with pytest.raises(ValueError, match="truncated fixed32"):
        tpb.decode(spec, good + tpb._encode_varint(9 << 3 | 5) + b"\x00\x01")
    out = tpb.decode(spec, good + tpb._encode_varint(9 << 3 | 1) + b"\x00" * 8
                     + tpb._encode_varint(10 << 3 | 5) + b"\x00" * 4)
    assert out["a"] == 3


_PROTO_TYPES = {"string": 9, "bytes": 12, "int32": 5, "int64": 3, "bool": 8}


def _proto_classes():
    """Message classes of ``proto/inference.proto``, built with
    ``descriptor_pb2`` from the file's text (no protoc) → {name: (class,
    {number: (field name, proto type)})}."""
    pytest.importorskip("google.protobuf")
    from google.protobuf import descriptor_pb2, descriptor_pool, message_factory

    import pathlib

    text = (pathlib.Path(__file__).resolve().parents[1] / "proto/inference.proto").read_text()
    text = re.sub(r"//[^\n]*", "", text)
    fdp = descriptor_pb2.FileDescriptorProto(name="inference_test.proto",
                                             package="dgi_tpu.dataplane.v1", syntax="proto3")
    fields = {}
    for name, body in re.findall(r"message (\w+) \{([^}]*)\}", text):
        m = fdp.message_type.add(name=name)
        fields[name] = {}
        for opt, ftype, fname, num in re.findall(r"(optional )?(\w+) (\w+) = (\d+);", body):
            f = m.field.add(name=fname, number=int(num), label=1)
            if ftype in _PROTO_TYPES:
                f.type = _PROTO_TYPES[ftype]
            else:
                f.type, f.type_name = 11, f".dgi_tpu.dataplane.v1.{ftype}"
            if opt:
                f.proto3_optional = True
                f.oneof_index = len(m.oneof_decl)
                m.oneof_decl.add(name=f"_{fname}")
            fields[name][int(num)] = (fname, ftype)
    pool = descriptor_pool.DescriptorPool()
    pool.Add(fdp)
    return {name: (message_factory.GetMessageClass(
        pool.FindMessageTypeByName(f"dgi_tpu.dataplane.v1.{name}")), fields[name])
        for name in fields}


_SPEC_OF = {"Tensor": "TENSOR", "CreateSessionRequest": "CREATE_SESSION_REQUEST",
            "CreateSessionResponse": "CREATE_SESSION_RESPONSE",
            "ForwardRequest": "FORWARD_REQUEST", "ForwardResponse": "FORWARD_RESPONSE",
            "TransferKVRequest": "TRANSFER_KV_REQUEST",
            "TransferKVResponse": "TRANSFER_KV_RESPONSE",
            "CloseSessionRequest": "CLOSE_SESSION_REQUEST",
            "CloseSessionResponse": "CLOSE_SESSION_RESPONSE",
            "HealthRequest": "HEALTH_REQUEST", "HealthResponse": "HEALTH_RESPONSE"}


def _fill(proto_msg, msg):
    for k, v in msg.items():
        if isinstance(v, dict):
            getattr(proto_msg, k).SetInParent()
            _fill(getattr(proto_msg, k), v)
        else:
            setattr(proto_msg, k, v)


def test_pb_against_google_protobuf_messages_from_the_proto_file():
    classes = _proto_classes()
    assert set(classes) == set(_SPEC_OF)
    for name, (cls, fields) in classes.items():
        spec = getattr(tpb, _SPEC_OF[name])
        # the spec's field numbers and names are the file's
        assert {n: f for n, (f, _) in fields.items()} == {n: f for n, (f, _) in spec.items()}
        rng = np.random.default_rng(len(name))
        for _ in range(25):
            msg = _random_msg(spec, rng)
            if name == "TransferKVResponse" and msg.get("bytes_received"):
                msg["bytes_received"] = 2 ** 40 + 7        # the one int64 field
            ref = cls()
            _fill(ref, msg)
            wire = ref.SerializeToString(deterministic=True)
            assert tpb.encode(spec, msg) == wire, (name, msg)
            back = cls()
            back.ParseFromString(tpb.encode(spec, msg))
            assert back == ref
            assert tpb.decode(spec, wire) == tpb.decode(spec, tpb.encode(spec, msg))


# ---------------------------------------------------------------------------
# the interop matrix
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(jconfigs.get_model_config(MODEL, dtype="float32"),
                            jax.random.PRNGKey(0), jnp.float32)
    npt = jax.tree.map(np.asarray, jp)
    return jp, params_from_numpy(npt, "cpu")


def _stage(kind, weights):
    n = jconfigs.get_model_config(MODEL).num_layers
    if kind == "port":
        return tstage.PipelineStageWorker(MODEL, (0, n), full_params=weights[1], device="cpu",
                                          **GEOM)
    return jstage.PipelineStageWorker(MODEL, (0, n), full_params=weights[0], **GEOM)


def _server(kind, stage, **kw):
    cls = tgp.GrpcDataPlane if kind == "port" else jgp.GrpcDataPlane
    srv = cls(stage, host="127.0.0.1", port=0, **kw)
    srv.start()
    return srv


def _client(kind, port, timeout_s=60.0):
    cls = tgp.GrpcStageClient if kind == "port" else jgp.GrpcStageClient
    return cls(f"127.0.0.1:{port}", timeout_s=timeout_s)


@pytest.fixture(scope="module")
def planes(weights):
    """{kind: (server, stage)} over the same weights."""
    out = {}
    for kind in SERVERS:
        stage = _stage(kind, weights)
        out[kind] = (_server(kind, stage), stage)
    yield out
    for srv, _ in out.values():
        srv.stop(0)


def _arr(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _chunk(tokens, start):
    return (np.asarray([tokens], np.int32),
            np.asarray([range(start, start + len(tokens))], np.int32))


def _failure(fn):
    """→ (status name, details) of the RpcError ``fn`` raises (grpcio's or
    the port's)."""
    with pytest.raises((grpc.RpcError, tgp.RpcError)) as ei:
        fn()
    return ei.value.code().name, ei.value.details()


def _unknown_method(kind, client):
    if kind == "port":
        return client._unary("NoSuchMethod", tpb.HEALTH_REQUEST, tpb.HEALTH_RESPONSE, {}, 5.0)
    return client.channel.unary_unary(f"/{tgp.SERVICE}/NoSuchMethod")(b"", timeout=5.0)


class _Fake:
    """A stage of scripted answers; ``gate`` holds its forwards."""

    def __init__(self, status="ok", gate=None):
        self.status, self.gate, self.seen = status, gate, []
        self.reply = None           # a forward's answer, in place of the small hidden

    def create_session(self, sid):
        return {"session_id": sid, "existing": False}

    def close_session(self, sid):
        return None

    def health(self):
        return {"status": self.status}

    def forward(self, sid, x, positions, kv_len_after):
        self.seen.append(sid)
        if self.gate is not None:
            self.gate.wait(timeout=10.0)
            raise KeyError(sid)
        return self.reply or {"hidden": np.zeros((1, 1, 4), np.float32)}


@pytest.mark.parametrize("server", SERVERS)
@pytest.mark.parametrize("client_kind", CLIENTS)
def test_health_and_session_lifecycle(planes, server, client_kind):
    srv, _ = planes[server]
    c = _client(client_kind, srv.port)
    try:
        h = c.health()
        # the stage answers layer_range: both planes zero these (ROADMAP §3 item 4)
        assert h == {"status": "ok", "layer_start": 0, "layer_end": 0, "is_first": True,
                     "is_last": True, "active_sessions": h["active_sessions"],
                     "free_blocks": h["free_blocks"]}
        sid = f"life-{server}-{client_kind}"
        assert c.create_session(sid) == {"session_id": sid, "existing": False}
        assert c.create_session(sid)["existing"] is True
        c.close_session(sid)
        assert c.create_session(sid)["existing"] is False
        c.close_session(sid)
    finally:
        c.close()


@pytest.mark.parametrize("server", SERVERS)
@pytest.mark.parametrize("client_kind", CLIENTS)
def test_stream_forward_greedy_equals_unary(planes, server, client_kind):
    srv, _ = planes[server]
    c = _client(client_kind, srv.port)
    prompt = list(range(30, 46))

    def greedy(out):
        return int(np.argmax(_arr(out["logits"])[0, -1]))

    def run(sid, call):
        c.create_session(sid)
        out = call(sid, *_chunk(prompt, 0), len(prompt))
        assert _arr(out["logits"]).shape == (1, 16, jconfigs.get_model_config(MODEL).vocab_size)
        assert _arr(out["hidden"]).shape[:2] == (1, 16)
        toks, n = [greedy(out)], len(prompt)
        for _ in range(5):
            toks.append(greedy(call(sid, *_chunk([toks[-1]], n), n + 1)))
            n += 1
        c.close_session(sid)
        return toks

    try:
        unary = run(f"u-{server}-{client_kind}", c.forward)
        with c.open_stream() as stream:
            streamed = run(f"s-{server}-{client_kind}", stream.step)
        assert streamed == unary
    finally:
        c.close()


def test_logits_across_servers_clients_and_the_http_plane(planes):
    x, pos = _chunk(list(range(60, 76)), 0)
    logits = {}
    for server in SERVERS:
        srv, _ = planes[server]
        for client_kind in CLIENTS:
            c = _client(client_kind, srv.port)
            sid = f"cmp-{server}-{client_kind}"
            c.create_session(sid)
            logits[server, client_kind] = _arr(c.forward(sid, x, pos, 16)["logits"])
            c.close_session(sid)
            c.close()
    # one server's compute through either client: the same bits
    for server in SERVERS:
        np.testing.assert_array_equal(logits[server, "port"], logits[server, "jax"])
    np.testing.assert_allclose(logits["port", "port"], logits["jax", "jax"], **TOL)
    # the port over gRPC against the port over HTTP, same stage: bitwise
    http = tplane.DataPlaneServer(stage=planes["port"][1])
    http.start()
    try:
        ws = WorkerSession(http.url, BlockRange(0, 2), timeout_s=60.0)
        ws.create("cmp-http")
        got = ws.forward("cmp-http", x, pos, 16)["logits"].numpy()
        ws.close("cmp-http")
    finally:
        http.stop()
    np.testing.assert_array_equal(got, logits["port", "port"])


@pytest.mark.parametrize("server", SERVERS)
@pytest.mark.parametrize("client_kind", CLIENTS)
def test_error_codes(planes, server, client_kind):
    srv, _ = planes[server]
    c = _client(client_kind, srv.port)
    x, pos = _chunk(list(range(4)), 0)
    sid = f"oob-{server}-{client_kind}"
    try:
        got = {
            "unknown session": _failure(lambda: c.forward("no-such-session", x, pos, 4)),
            "no receiver": _failure(lambda: c.transfer_kv(b"x")),
            "unknown method": _failure(lambda: _unknown_method(client_kind, c)),
        }
        c.create_session(sid)
        # 9 blocks of 16 > max_blocks_per_seq 8
        got["out of blocks"] = _failure(lambda: c.forward(sid, x, pos, 9 * 16))
        c.close_session(sid)
    finally:
        c.close()
    assert got == {
        "unknown session": ("NOT_FOUND", "'unknown session no-such-session'"),
        "no receiver": ("UNIMPLEMENTED", "this endpoint is not a KV receiver"),
        "unknown method": ("UNIMPLEMENTED", "Method not found!"),
        "out of blocks": ("RESOURCE_EXHAUSTED",
                          f"session {sid} needs 9 blocks > per-seq limit 8"),
    }


@pytest.mark.parametrize("server", SERVERS)
@pytest.mark.parametrize("client_kind", CLIENTS)
def test_transfer_kv_receiver(server, client_kind):
    received = []

    def receiver(raw):
        received.append(len(raw))
        if raw == b"boom":
            raise RuntimeError("receiver refused the handoff")
        return {"slot": 3}

    srv = _server(server, _Fake(), kv_receiver=receiver)
    c = _client(client_kind, srv.port)
    try:
        assert c.transfer_kv(b"\x00" * 1024) == {"slot": 3, "bytes_received": 1024}
        assert received == [1024]
        assert _failure(lambda: c.transfer_kv(b"boom")) == \
            ("INTERNAL", "receiver refused the handoff")
    finally:
        c.close()
        srv.stop(0)


@pytest.mark.parametrize("server", SERVERS)
@pytest.mark.parametrize("client_kind", CLIENTS)
def test_receive_limit_both_ways(server, client_kind):
    """4,194,304 bytes of message pass and 4,194,305 fail with grpcio's code
    and words: requests at the server, replies at the client. Tensors ride
    zstd-compressed in both planes, so the limit falls on the compressed
    message: f32 activations whose raw frame is past 4 MiB pass where they
    compress below it, and fail both ways where they do not."""
    fake = _Fake()
    srv = _server(server, fake, kv_receiver=lambda raw: {"slot": 1})
    c = _client(client_kind, srv.port)
    # TransferKVRequest: tag 1 + a 4-byte length + the bytes
    req = {n: b"\x07" * (n - 5) for n in (LIMIT, LIMIT + 1)}
    assert all(len(tpb.encode(tpb.TRANSFER_KV_REQUEST, {"handoff": v})) == n
               for n, v in req.items())
    # HealthResponse: tag 1 + a 4-byte length + the status
    status = {n: "s" * (n - 5) for n in (LIMIT, LIMIT + 1)}
    try:
        assert c.transfer_kv(req[LIMIT])["bytes_received"] == LIMIT - 5
        assert _failure(lambda: c.transfer_kv(req[LIMIT + 1])) == (
            "RESOURCE_EXHAUSTED", f"SERVER: Received message larger than max "
            f"({LIMIT + 1} vs. {LIMIT})")
        fake.status = status[LIMIT]
        assert len(c.health()["status"]) == LIMIT - 5
        fake.status = status[LIMIT + 1]
        assert _failure(c.health) == (
            "RESOURCE_EXHAUSTED", f"CLIENT: Received message larger than max "
            f"({LIMIT + 1} vs. {LIMIT})")
        # the connection still serves
        fake.status = "ok"
        assert c.health()["status"] == "ok"
        # f32 normals compress to ~0.93 of raw: 34 rows of 32,000 are 4.35 MB
        # raw and ~4.03 MB compressed; 37 rows compress to ~4.39 MB
        rng = np.random.default_rng(5)
        rows = {n: rng.standard_normal((1, n, 32_000)).astype(np.float32) for n in (34, 37)}
        assert rows[34].nbytes > LIMIT
        pos = np.arange(34, dtype=np.int32)[None]
        assert c.forward("s", rows[34], pos, 34)["hidden"].shape == (1, 1, 4)
        code, details = _failure(lambda: c.forward("s", rows[37], pos, 37))
        assert code == "RESOURCE_EXHAUSTED" and details.startswith(
            "SERVER: Received message larger than max (") and details.endswith(f" vs. {LIMIT})")
        fake.reply = {"logits": rows[34]}
        got = c.forward("s", np.zeros((1, 1, 4), np.float32), pos[:, :1], 1)["logits"]
        assert np.array_equal(np.asarray(got), rows[34])
        fake.reply = {"logits": rows[37]}
        code, details = _failure(lambda: c.forward("s", np.zeros((1, 1, 4), np.float32),
                                                   pos[:, :1], 1))
        assert code == "RESOURCE_EXHAUSTED" and details.startswith(
            "CLIENT: Received message larger than max (") and details.endswith(f" vs. {LIMIT})")
    finally:
        c.close()
        srv.stop(0)


@pytest.mark.parametrize("server,client_kind,window", [
    (s, c, None) for s in SERVERS for c in CLIENTS] + [
    (s, c, h2.DEFAULT_WINDOW) for s, c in (("port", "port"), ("port", "jax"), ("jax", "port"))])
def test_reply_of_several_mb_crosses_the_windows(server, client_kind, window, monkeypatch):
    if window is not None:
        # the port's side advertises HTTP/2's default window and frame size
        monkeypatch.setattr(h2, "LOCAL_WINDOW", window)
        monkeypatch.setattr(h2, "LOCAL_CONN_WINDOW", window)
        monkeypatch.setattr(h2, "LOCAL_MAX_FRAME", h2.DEFAULT_MAX_FRAME)
    rng = np.random.default_rng(3)
    text = rng.integers(ord("a"), ord("h") + 1, size=3_000_000, dtype=np.uint8).tobytes().decode()
    srv = _server(server, _Fake(status=text), kv_receiver=lambda raw: {"slot": len(raw)})
    c = _client(client_kind, srv.port)
    try:
        for _ in range(2):
            assert c.health()["status"] == text
        blob = rng.bytes(3_500_000)
        assert c.transfer_kv(blob) == {"slot": len(blob), "bytes_received": len(blob)}
    finally:
        c.close()
        srv.stop(0)


@pytest.mark.parametrize("server", SERVERS)
@pytest.mark.parametrize("client_kind", CLIENTS)
def test_hung_stage_step_times_out(server, client_kind):
    release = threading.Event()
    srv = _server(server, _Fake(gate=release))
    c = _client(client_kind, srv.port, timeout_s=0.4)
    try:
        stream = c.open_stream()
        x, pos = _chunk([1, 2, 3, 4], 0)
        t0 = time.monotonic()
        with pytest.raises(TimeoutError, match="timed out"):
            stream.step("s", x, pos, 4)
        assert time.monotonic() - t0 < 5.0
        stream.close()      # bounded too: cancel, not an unbounded drain
        assert time.monotonic() - t0 < 8.0
    finally:
        release.set()
        c.close()
        srv.stop(0)


@pytest.mark.parametrize("server", SERVERS)
@pytest.mark.parametrize("client_kind", CLIENTS)
def test_unary_deadline_exceeded(server, client_kind):
    release = threading.Event()
    fake = _Fake(gate=release)
    srv = _server(server, fake)
    c = _client(client_kind, srv.port, timeout_s=0.3)
    try:
        x, pos = _chunk([1, 2], 0)
        t0 = time.monotonic()
        assert _failure(lambda: c.forward("d", x, pos, 2)) == \
            ("DEADLINE_EXCEEDED", "Deadline Exceeded")
        assert time.monotonic() - t0 < 3.0
    finally:
        release.set()
        c.close()
        srv.stop(0)


def test_port_server_cancels_the_context_at_the_deadline():
    release = threading.Event()
    seen = {}

    class Stage(_Fake):
        def forward(self, sid, x, positions, kv_len_after):
            time.sleep(1.5)             # past the 0.5 s deadline
            seen["active"] = self.ctx.is_active()
            release.set()
            return {"hidden": np.zeros((1, 1, 4), np.float32)}

    stage = Stage()
    srv = _server("port", stage)
    real = srv._methods[f"/{tgp.SERVICE}/Forward"]

    def forward(request, context):
        stage.ctx = context
        return real[1](request, context)

    srv._methods[f"/{tgp.SERVICE}/Forward"] = (real[0], forward, *real[2:])
    c = _client("jax", srv.port, timeout_s=0.5)
    try:
        x, pos = _chunk([1, 2], 0)
        assert _failure(lambda: c.forward("d", x, pos, 2))[0] == "DEADLINE_EXCEEDED"
        assert release.wait(10.0) and seen["active"] is False
    finally:
        c.close()
        srv.stop(0)


def test_grpcio_metadata_and_gzip_on_the_port_server():
    """grpcio writes a ``-bin`` value base64 and Huffman-coded (the one
    Huffman string its client sends), and gzip when asked: both served."""
    fake = _Fake(status="served with metadata")
    srv = _server("port", fake)
    c = _client("jax", srv.port)
    try:
        trace = bytes(range(256)) * 3
        out = c._health({}, timeout=5.0, metadata=(("x-trace-bin", trace),
                                                    ("x-tenant", "blue")))
        assert out["status"] == "served with metadata"
        fake.status = "ok"
        out = c._health({}, timeout=5.0, compression=grpc.Compression.Gzip)
        assert out["status"] == "ok"
        # a gzip request of a large message
        srv.kv_receiver = lambda raw: {"slot": 2}
        blob = b"\x00" * 1_000_000
        assert c.transfer_kv(blob) == {"slot": 2, "bytes_received": len(blob)}
        assert c._transfer({"handoff": blob}, timeout=5.0,
                           compression=grpc.Compression.Gzip)["bytes_received"] == len(blob)
    finally:
        c.close()
        srv.stop(0)


@pytest.mark.parametrize("server", SERVERS)
@pytest.mark.parametrize("client_kind", CLIENTS)
def test_nine_streams_on_eight_workers(server, client_kind):
    """Eight open streams hold the eight handler threads: a ninth waits
    until one of them closes, then is served."""
    srv = _server(server, _Fake(), max_workers=8)
    c = _client(client_kind, srv.port, timeout_s=20.0)
    x, pos = _chunk([1], 0)
    streams = [c.open_stream() for _ in range(8)]
    try:
        for s in streams:
            assert "hidden" in s.step("a", x, pos, 1)
        ninth, done = c.open_stream(), []
        t = threading.Thread(target=lambda: done.append(ninth.step("b", x, pos, 1)))
        t.start()
        t.join(0.6)
        assert not done                      # queued behind the eight
        streams.pop().close()
        t.join(10.0)
        assert done and "hidden" in done[0]
        ninth.close()
    finally:
        for s in streams:
            s.close()
        c.close()
        srv.stop(0)


@pytest.mark.parametrize("client_kind", CLIENTS)
def test_stop_with_a_stream_in_flight(client_kind):
    """``stop(grace)`` while a stream's forward runs: the client sees the
    code the JAX server gives it."""
    got = {}
    for server in SERVERS:
        release = threading.Event()
        fake = _Fake(gate=release)
        srv = _server(server, fake)
        c = _client(client_kind, srv.port, timeout_s=20.0)
        stream = c.open_stream()
        out = []

        def step():
            try:
                stream.step("s", *_chunk([1], 0), 1)
            except (grpc.RpcError, tgp.RpcError) as exc:
                out.append((exc.code().name, exc.details()))

        t = threading.Thread(target=step)
        t.start()
        wait_for = time.monotonic() + 10.0
        while not fake.seen and time.monotonic() < wait_for:
            time.sleep(0.01)            # the forward is in flight
        assert fake.seen
        t0 = time.monotonic()
        ev = srv.stop(0.3)
        t.join(10.0)
        got[server] = out
        assert time.monotonic() - t0 < 5.0
        release.set()                   # the handler returns: grpcio's stop ends
        if ev is not None:
            ev.wait(5.0)
        stream.close()
        c.close()
    assert got["port"] == got["jax"] == [("UNAVAILABLE", "Cancelling all calls")]


@pytest.mark.parametrize("server", SERVERS)
@pytest.mark.parametrize("client_kind", CLIENTS)
def test_calls_after_stop_are_unavailable(server, client_kind):
    """A client whose server stopped (GOAWAY, then the connection closed)
    gets UNAVAILABLE on its next call, from either server."""
    srv = _server(server, _Fake())
    c = _client(client_kind, srv.port, timeout_s=5.0)
    try:
        assert c.health()["status"] == "ok"
        srv.stop(0)
        if server == "jax":
            srv._server.wait_for_termination(5.0)   # grpcio stops in the background
        code, _ = _failure(c.health)
        assert code == "UNAVAILABLE"
    finally:
        c.close()


# ---------------------------------------------------------------------------
# the fault seam
# ---------------------------------------------------------------------------


def test_fault_seam_comm_grpc_forward_in_both_packages(planes):
    x, pos = _chunk([5, 6], 0)
    traces = {}
    for kind, faults, plan_cls, rule_cls in (
            ("port", tfaults, tfaults.FaultPlan, tfaults.FaultRule),
            ("jax", jfaults, jfaults.FaultPlan, jfaults.FaultRule)):
        c = _client(kind, planes[kind][0].port)
        c.create_session("f")
        plan = plan_cls(seed=3, rules=[rule_cls(site="comm.grpc.forward", kind="drop",
                                                times=1, match={"session_id": "f"}),
                                       rule_cls(site="comm.grpc.transfer_kv", kind="error",
                                                times=1)])
        with faults.active(plan):
            with pytest.raises(faults.FaultInjected, match="comm.grpc.forward"):
                c.forward("f", x, pos, 2)
            assert "logits" in c.forward("f", x, pos, 2)
            with pytest.raises(faults.FaultInjected, match="comm.grpc.transfer_kv"):
                c.transfer_kv(b"x")
        traces[kind] = list(plan.trace)
        c.close_session("f")
        c.close()
    assert traces["port"] == traces["jax"] and len(traces["port"]) == 2


# ---------------------------------------------------------------------------
# HTTP/2 frames grpcio does not send, on the port's server
# ---------------------------------------------------------------------------


def _raw_h2(port):
    import socket

    sock = socket.create_connection(("127.0.0.1", port), timeout=10.0)
    f = sock.makefile("rb")

    def send(ftype, flags, sid, payload=b""):
        sock.sendall(h2._frame_header(len(payload), ftype, flags, sid) + payload)

    def frames():
        while True:
            head = f.read(9)
            if len(head) < 9:
                return
            n = int.from_bytes(head[:3], "big")
            yield head[3], head[4], int.from_bytes(head[5:9], "big"), f.read(n)

    return sock, send, frames()


def test_padding_continuation_priority_unknown_frames_and_ping():
    import struct

    from distributed_gpu_inference_torch.comm import hpack

    srv = _server("port", _Fake(status="padded ok"))
    sock, send, frames = _raw_h2(srv.port)
    try:
        sock.sendall(h2.PREFACE)
        # an unknown SETTINGS id (grpcio sends its own) and a small frame size
        send(h2.SETTINGS, 0, 0, struct.pack(">HI", 0xFE03, 1)
             + struct.pack(">HI", h2.MAX_FRAME_SIZE, 16384))
        send(h2.PRIORITY, 0, 1, b"\x00\x00\x00\x00\x10")
        send(0x20, 0xFF, 0, b"an extension frame")
        send(h2.PING, 0, 0, b"pingpong")
        block = hpack.Encoder().encode([
            (":method", "POST"), (":scheme", "http"),
            (":path", f"/{tgp.SERVICE}/HealthCheck"), (":authority", "x"),
            ("content-type", "application/grpc"), ("te", "trailers")])
        cut = len(block) // 2
        # HEADERS padded, with a priority, then CONTINUATION
        send(h2.HEADERS, h2.PADDED | h2.PRIORITY_FLAG, 1,
             bytes([3]) + b"\x00\x00\x00\x00\x10" + block[:cut] + b"\x00" * 3)
        send(h2.CONTINUATION, h2.END_HEADERS, 1, block[cut:])
        # the empty request message, in a padded DATA frame ending the stream
        send(h2.DATA, h2.PADDED | h2.END_STREAM, 1, bytes([4]) + b"\x00" * 5 + b"\x00" * 4)
        dec, seen, data, blocks = hpack.Decoder(), [], b"", []
        for ftype, flags, sid, payload in frames:
            seen.append((ftype, flags & h2.ACK if ftype in (h2.SETTINGS, h2.PING) else 0))
            if ftype == h2.PING:
                assert payload == b"pingpong" and flags & h2.ACK
            if ftype == h2.HEADERS and sid == 1:
                blocks.append(dict(dec.decode(payload)))
                if flags & h2.END_STREAM:
                    break
            if ftype == h2.DATA and sid == 1:
                data += payload
        assert (h2.SETTINGS, 0) in seen and (h2.SETTINGS, h2.ACK) in seen
        assert (h2.PING, h2.ACK) in seen
        assert blocks[0][":status"] == "200" and blocks[-1]["grpc-status"] == "0"
        reply = tpb.decode(tpb.HEALTH_RESPONSE, data[5:])
        assert reply["status"] == "padded ok" and int.from_bytes(data[1:5], "big") == len(data) - 5
    finally:
        sock.close()
        srv.stop(0)


def test_malformed_header_block_is_a_compression_error():
    import struct

    srv = _server("port", _Fake())
    sock, send, frames = _raw_h2(srv.port)
    try:
        sock.sendall(h2.PREFACE)
        send(h2.SETTINGS, 0, 0)
        send(h2.HEADERS, h2.END_HEADERS, 1, b"\xbe")    # index 62 of an empty table
        goaway = [p for t, _, _, p in frames if t == h2.GOAWAY]
        assert goaway and struct.unpack(">II", goaway[0][:8])[1] == h2.COMPRESSION_ERROR
    finally:
        sock.close()
        srv.stop(0)


def test_concurrent_calls_on_one_connection_stress(monkeypatch):
    """16 threads share one client connection (and the server's one
    connection) with small windows and a short switch interval: every
    answer is its own call's, and no stream or call is left behind."""
    import sys

    monkeypatch.setattr(h2, "LOCAL_WINDOW", h2.DEFAULT_WINDOW)
    monkeypatch.setattr(h2, "LOCAL_CONN_WINDOW", 4 * h2.DEFAULT_WINDOW)
    monkeypatch.setattr(h2, "LOCAL_MAX_FRAME", h2.DEFAULT_MAX_FRAME)
    srv = _server("port", _Fake(), kv_receiver=lambda raw: {"slot": raw[0] * 1000 + len(raw)},
                  max_workers=16)
    c = _client("port", srv.port, timeout_s=60.0)
    errors, wrong = [], []
    old = sys.getswitchinterval()

    def worker(t):
        rng = np.random.default_rng(t)
        try:
            for _ in range(8):
                n = int(rng.integers(1, 150_000))
                out = c.transfer_kv(bytes([t]) * n)
                if out != {"slot": t * 1000 + n, "bytes_received": n}:
                    wrong.append((t, n, out))
        except Exception as exc:  # noqa: BLE001 — asserted below
            errors.append(exc)

    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    try:
        assert not errors and not wrong, (errors[:3], wrong[:3])
        assert not c.channel._conn.streams and c.channel._conn.usable
        deadline = time.monotonic() + 5.0
        while srv._calls and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not srv._calls
    finally:
        c.close()
        srv.stop(0)
