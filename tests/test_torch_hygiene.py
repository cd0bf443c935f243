"""Hygiene of the PyTorch port: it imports nothing of JAX or of the JAX
package (nor aiohttp, httpx, pydantic, transformers, msgpack, ml_dtypes,
redis, safetensors, tokenizers, regex, grpc, h2, hpack or hyperframe, which the
card's machine lacks;
PyYAML only lazily, behind an error naming it, jinja2 only where a chat
template is compiled, and zstandard only to read a zstd spill frame),
runs on CUDA unless asked for the CPU, its kernel wrappers never
fall back to the plain version for a tensor that is not on the CPU, and
the engine refuses on the card a model the kernels do not take. Tests
that need the card carry the ``gpu`` marker and skip without one."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distributed_gpu_inference_torch.ops import paged_attention as tpa  # noqa: E402
from distributed_gpu_inference_torch.runtime.engine import TorchEngine  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "distributed_gpu_inference_tpu", "aiohttp", "httpx",
             "pydantic", "transformers", "msgpack", "ml_dtypes", "redis",
             "safetensors", "tokenizers", "regex", "grpc", "h2", "hpack", "hyperframe")


def _port_files():
    files = sorted((ROOT / "distributed_gpu_inference_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_nothing_of_jax():
    files = _port_files()
    assert len(files) > 10 and all(f.is_file() for f in files)
    # the quantized slice's modules and the kernel loader are among them
    assert {"quantization.py", "qmm.py", "paged_attention.py", "_build.py",
            "direct_server.py", "llm.py", "chip_smoke.py", "main.py", "api_client.py",
            "cli.py", "machine_id.py", "config.py", "backoff.py", "prefixes.py",
            "prefix_summary.py", "io_guard.py", "faults.py", "flight.py", "redis_kv.py",
            "serialization.py", "kv_cache.py", "speculative.py", "engine.py", "batcher.py",
            "llama.py", "attention.py", "convert.py", "loader.py", "safetensors.py",
            "hf_tokenizer.py", "wire.py", "session.py", "stage_worker.py",
            "pipeline.py", "mesh.py", "sharding.py", "tp.py",
            "bert_chars.py", "radix.py", "pb.py", "hpack.py", "h2.py",
            "grpc_plane.py"} <= {f.name for f in files}
    assert (ROOT / "distributed_gpu_inference_torch/runtime/speculative.py") in files
    assert (ROOT / "distributed_gpu_inference_torch/testing/faults.py") in files
    assert (ROOT / "distributed_gpu_inference_torch/worker/engines/__init__.py") in files
    offenders = {
        str(f.relative_to(ROOT)): sorted(set(_imported_roots(f)) & set(FORBIDDEN))
        for f in files
    }
    assert {k: v for k, v in offenders.items() if v} == {}


def test_pd_modules_import_nothing_of_jax():
    # the KV handoff, the data plane and chip_smoke.py's phase 16 carry no
    # JAX, no module of the JAX package and no aiohttp/httpx/msgpack
    pd = [ROOT / "distributed_gpu_inference_torch" / rel for rel in (
        "comm/__init__.py", "comm/data_plane.py", "runtime/kv_handoff.py")]
    assert set(pd) <= set(_port_files())
    for f in pd + [ROOT / "chip_smoke.py"]:
        assert not set(_imported_roots(f)) & set(FORBIDDEN), f
    assert "pd_phase" in (ROOT / "chip_smoke.py").read_text()


def test_pipeline_modules_import_nothing_of_jax():
    # the wire, the stage worker, the session and the stage planner carry no
    # JAX, no module of the JAX package, no aiohttp/httpx/grpc/msgpack (and
    # zstandard only lazily, see below); chip_smoke.py's phase 21 drives
    # the pipeline on the card
    pipeline = [ROOT / "distributed_gpu_inference_torch" / rel for rel in (
        "comm/wire.py", "comm/session.py", "comm/stage_worker.py",
        "parallel/__init__.py", "parallel/pipeline.py")]
    assert set(pipeline) <= set(_port_files())
    for f in pipeline + [ROOT / "chip_smoke.py"]:
        assert not set(_imported_roots(f)) & set(FORBIDDEN), f
    assert "def pipeline_phase(" in (ROOT / "chip_smoke.py").read_text()


def test_seq_modules_import_nothing_of_jax():
    # ring and Ulysses attention, the partial-softmax reads, the group's
    # collectives, the block sharding and the ranks carry no JAX and no
    # module of the JAX package; chip_smoke.py's phase 24 drives them
    seq = [ROOT / "distributed_gpu_inference_torch" / rel for rel in (
        "parallel/ring_attention.py", "parallel/mesh.py", "parallel/sharding.py",
        "runtime/tp.py", "runtime/engine.py")]
    assert set(seq) <= set(_port_files())
    for f in seq + [ROOT / "chip_smoke.py"]:
        assert not set(_imported_roots(f)) & set(FORBIDDEN), f
    assert "def seq_phase(" in (ROOT / "chip_smoke.py").read_text()


def test_native_mesh_and_stage_pipeline_modules_import_nothing_of_jax():
    # the C++ radix index's loader and wrapper (ctypes, the standard
    # library's, is theirs), the seq x model mesh and the in-mesh stage
    # pipeline carry no JAX and no module of the JAX package (not even its
    # native/, which imports no JAX); chip_smoke.py's phase 26 drives them
    native = [ROOT / "distributed_gpu_inference_torch" / rel for rel in (
        "native/__init__.py", "native/radix.py")]
    mesh = [ROOT / "distributed_gpu_inference_torch" / rel for rel in (
        "parallel/mesh.py", "parallel/sharding.py", "parallel/ring_attention.py",
        "parallel/pipeline.py", "runtime/tp.py", "runtime/engine.py",
        "runtime/kv_cache.py", "runtime/kv_handoff.py", "worker/engines/llm.py")]
    assert set(native + mesh) <= set(_port_files())
    for f in native + mesh + [ROOT / "chip_smoke.py"]:
        assert not set(_imported_roots(f)) & set(FORBIDDEN), f
    assert all("ctypes" in set(_imported_roots(f)) for f in native)
    assert (ROOT / "distributed_gpu_inference_torch/native/src/radix_index.cpp").is_file()
    assert "def mesh_phase(" in (ROOT / "chip_smoke.py").read_text()


def test_grpc_modules_import_nothing_of_jax_or_grpc():
    # the proto3 codec, HPACK, HTTP/2 and the gRPC plane are the standard
    # library's: no grpcio, h2, hpack or hyperframe, no JAX and no module
    # of the JAX package (not even its comm/pb.py, which imports no JAX);
    # chip_smoke.py's phase 28 drives them
    grpc_files = [ROOT / "distributed_gpu_inference_torch" / "comm" / name for name in (
        "pb.py", "hpack.py", "h2.py", "grpc_plane.py", "__init__.py")]
    assert set(grpc_files) <= set(_port_files())
    for f in grpc_files + [ROOT / "chip_smoke.py"]:
        assert not set(_imported_roots(f)) & set(FORBIDDEN), f
    assert "def grpc_phase(" in (ROOT / "chip_smoke.py").read_text()


def test_a_seq_engine_runs_on_the_card_unless_asked(monkeypatch):
    # ranks on the default device need CUDA, and a seq axis needs its ranks
    from distributed_gpu_inference_torch.parallel.mesh import MeshPlan

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchEngine("llama3-tiny", rank_devices=["cuda", "cuda"], mesh=MeshPlan(seq=2))
    with pytest.raises(ValueError, match="seq axis of 2 needs 2 rank devices"):
        TorchEngine("llama3-tiny", device="cpu", mesh=MeshPlan(seq=2))


def test_a_pd_data_plane_loads_no_stage_and_no_model():
    # a PD-only user of the data plane reads its KV routes without the
    # stage worker, the model or the tensor message (each loaded on a
    # stage's first session request); the package's comm names stay lazy
    code = ("import sys, distributed_gpu_inference_torch.comm.data_plane as dp; "
            "assert dp.DataPlaneServer; "
            "print(sorted(m for m in sys.modules if m.startswith("
            "'distributed_gpu_inference_torch.') and m.split('.')[1] in ('comm', 'models')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "['distributed_gpu_inference_torch.comm', " \
        "'distributed_gpu_inference_torch.comm.data_plane']", out


def test_fleet_harness_imports_nothing_of_jax():
    # the fleet harness and the fakes take the plane from outside: no JAX,
    # no module of the JAX package, no aiohttp/httpx; chip_smoke.py's
    # phase 18 drives the fleet on the card
    fleet = [ROOT / "distributed_gpu_inference_torch" / rel for rel in (
        "testing/harness.py", "testing/fakes.py", "testing/faults.py")]
    assert set(fleet) <= set(_port_files())
    for f in fleet + [ROOT / "chip_smoke.py"]:
        assert not set(_imported_roots(f)) & set(FORBIDDEN), f
    assert "def fleet_phase(" in (ROOT / "chip_smoke.py").read_text()


def _import_sites(path, root):
    """(enclosing function name or None, line) of each import of ``root``."""
    out = []

    def walk(node, fn):
        for child in ast.iter_child_nodes(node):
            name = child.name if isinstance(child, (ast.FunctionDef,
                                                    ast.AsyncFunctionDef)) else fn
            if isinstance(child, ast.Import) and any(
                    a.name.split(".")[0] == root for a in child.names):
                out.append((fn, child.lineno))
            elif isinstance(child, ast.ImportFrom) and child.level == 0 and \
                    (child.module or "").split(".")[0] == root:
                out.append((fn, child.lineno))
            walk(child, name)

    walk(ast.parse(path.read_text()), None)
    return out


def test_control_plane_and_sdk_import_nothing_of_jax():
    # the port's plane, its HTTP layer, the SDK and the harness's live
    # plane carry no JAX, no module of the JAX package, no aiohttp/httpx;
    # chip_smoke.py's phase 25 runs them beside the card
    plane = sorted((ROOT / "distributed_gpu_inference_torch" / "server").glob("*.py")) + \
        sorted((ROOT / "distributed_gpu_inference_torch" / "sdk").glob("*.py"))
    names = {f.name for f in plane}
    assert {"app.py", "web.py", "store.py", "scheduler.py", "admission.py",
            "prefix_routing.py", "health.py", "task_guarantee.py", "observability.py",
            "plane_cluster.py", "pd_scheduler.py", "pd_flow.py", "privacy.py",
            "prom_text.py", "client.py"} <= names
    assert set(plane) <= set(_port_files())
    for f in plane + [ROOT / "distributed_gpu_inference_torch/testing/harness.py",
                      ROOT / "chip_smoke.py"]:
        assert not set(_imported_roots(f)) & set(FORBIDDEN), f
    assert "def deployment_phase(" in (ROOT / "chip_smoke.py").read_text()


@pytest.mark.parametrize("root,module,functions", [
    ("prometheus_client", None, None),
    ("opentelemetry", "server/observability.py", {"_otel"}),
    ("cryptography", "server/privacy.py", {"_load_crypto"}),
])
def test_optional_plane_packages_are_imported_only_lazily(root, module, functions):
    # the card has none of them: each is imported inside the one function
    # that turns its absence into a fallback or an error naming it.
    # /metrics is always server/prom_text.py, so prometheus_client is
    # imported nowhere
    sites = {str(f.relative_to(ROOT)): _import_sites(f, root) for f in _port_files()}
    sites = {k: v for k, v in sites.items() if v}
    if module is None:
        assert sites == {}
        return
    assert list(sites) == [f"distributed_gpu_inference_torch/{module}"]
    assert {fn for fn, _ in sites[f"distributed_gpu_inference_torch/{module}"]} == functions


def test_the_plane_imports_without_its_optional_packages():
    code = ("import sys\n"
            "for m in ('prometheus_client', 'opentelemetry', 'cryptography', 'aiohttp', "
            "'httpx', 'jax'):\n"
            "    sys.modules[m] = None\n"
            "from distributed_gpu_inference_torch.server.app import ServerState, create_app\n"
            "from distributed_gpu_inference_torch.sdk import InferenceClient\n"
            "st = ServerState()\n"
            "create_app(st, start_background=False)\n"
            "st.metrics.record_request('llm', 'completed', 0.1)\n"
            "text = st.metrics.render().decode()\n"
            "assert 'inference_requests_total{job_type=\"llm\",status=\"completed\"} 1.0' "
            "in text, text\n"
            "assert not st.tracing.enabled\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_yaml_is_imported_only_lazily_behind_its_error():
    # PyYAML may be missing on the card: one import, inside the function
    # that turns its absence into an error naming it
    sites = {str(f.relative_to(ROOT)): _import_sites(f, "yaml") for f in _port_files()}
    sites = {k: v for k, v in sites.items() if v}
    assert list(sites) == ["distributed_gpu_inference_torch/utils/config.py"]
    assert [fn for fn, _ in sites["distributed_gpu_inference_torch/utils/config.py"]] == [
        "_yaml"]


def test_zstandard_is_imported_only_where_a_zstd_frame_is_read():
    # the card has no zstandard: the spill wire writes uncompressed frames,
    # and only reading a JAX writer's zstd frame imports it, lazily
    sites = {str(f.relative_to(ROOT)): _import_sites(f, "zstandard") for f in _port_files()}
    sites = {k: v for k, v in sites.items() if v}
    assert list(sites) == ["distributed_gpu_inference_torch/utils/serialization.py"]
    assert [fn for fn, _ in sites["distributed_gpu_inference_torch/utils/serialization.py"]] \
        == ["deserialize"]


def test_jinja2_is_imported_only_where_a_chat_template_is_compiled():
    # jinja2 comes with PyTorch, but only the chat-template path needs it
    sites = {str(f.relative_to(ROOT)): _import_sites(f, "jinja2") for f in _port_files()}
    sites = {k: v for k, v in sites.items() if v}
    assert list(sites) == ["distributed_gpu_inference_torch/utils/hf_tokenizer.py"]
    assert {fn for fn, _ in sites["distributed_gpu_inference_torch/utils/hf_tokenizer.py"]} \
        == {"_jinja"}


def test_pillow_is_imported_only_where_an_image_needs_it():
    # the card has no Pillow: the port writes and reads its own PNGs, reads
    # its own JPEGs and resizes itself; only a vision request in another
    # format (GIF, BMP, WebP, TIFF) imports it
    sites = {str(f.relative_to(ROOT)): _import_sites(f, "PIL") for f in _port_files()}
    sites = {k: v for k, v in sites.items() if v}
    assert list(sites) == ["distributed_gpu_inference_torch/worker/engines/vision.py"]
    assert [fn for fn, _ in sites["distributed_gpu_inference_torch/worker/engines/vision.py"]] \
        == ["_pillow"]


def test_image_modules_import_nothing_of_jax_or_pillow():
    # the JPEG decoder, the resize, the PNG reader and the native loader
    # (ctypes, the standard library's) carry no JAX, no module of the JAX
    # package and no Pillow; chip_smoke.py's phase 27 drives them on the card
    image = [ROOT / "distributed_gpu_inference_torch" / rel for rel in (
        "utils/jpeg.py", "utils/resize.py", "utils/png.py", "native/__init__.py")]
    assert set(image) <= set(_port_files())
    for f in image + [ROOT / "chip_smoke.py"]:
        roots = set(_imported_roots(f))
        assert not roots & set(FORBIDDEN + ("PIL",)), f
    assert "ctypes" in set(_imported_roots(image[0]))
    assert (ROOT / "distributed_gpu_inference_torch/native/src/image_codec.cpp").is_file()
    assert "def photo_phase(" in (ROOT / "chip_smoke.py").read_text()


def test_the_package_ships_its_kernel_and_native_sources():
    # an installed port builds its CUDA kernels and its host library from
    # the sources its package data carries
    import tomllib

    data = tomllib.loads((ROOT / "pyproject.toml").read_text())
    globs = data["tool"]["setuptools"]["package-data"]["distributed_gpu_inference_torch"]
    pkg = ROOT / "distributed_gpu_inference_torch"
    shipped = {p for g in globs for p in pkg.glob(g)}
    sources = {p for sub, pattern in (("csrc", "*.cu"), ("csrc", "*.cuh"),
                                      ("native/src", "*.cpp")) for p in (pkg / sub).glob(pattern)}
    assert {"radix_index.cpp", "image_codec.cpp"} <= {p.name for p in sources}
    assert sources <= shipped, sorted(str(p) for p in sources - shipped)


def test_yaml_config_without_pyyaml_raises_naming_it(tmp_path, monkeypatch):
    import sys

    from distributed_gpu_inference_torch.utils.config import ConfigError, load_worker_config

    monkeypatch.setitem(sys.modules, "yaml", None)       # import yaml → ImportError
    p = tmp_path / "config.yaml"
    p.write_text("region: eu-west\n")
    with pytest.raises(ConfigError, match="PyYAML"):
        load_worker_config(p, environ={})
    # a JSON file needs no PyYAML, whatever its suffix
    p.write_text('{"region": "eu-west"}')
    assert load_worker_config(p, environ={}).region == "eu-west"


def test_engine_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchEngine("llama3-tiny")


def _meta_calls(d, dtype):
    """Each kernel wrapper on meta tensors; each must raise."""
    q = torch.empty((1, 16, 4, d), dtype=dtype, device="meta")
    pool = torch.empty((3, 2, 16, d), dtype=dtype, device="meta")
    idx = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    pos = torch.zeros((1, 16), dtype=torch.int32, device="meta")
    lens = torch.zeros((1,), dtype=torch.int32, device="meta")
    tpa.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        tpa.ragged_paged_attention(q, pool, pool, idx, pos, lens, 16)
    stacked = pool[None]
    with pytest.raises(ValueError, match="CUDA tensor"):
        tpa.paged_decode_attention_fused(
            q[:, :1], stacked[0, :1, :, :1].reshape(1, 1, 2, d),
            stacked[0, :1, :, :1].reshape(1, 1, 2, d), stacked, stacked, 0,
            idx, pos[:, :1], lens, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tpa.qmm_w8a16(torch.empty((4, 64), dtype=dtype, device="meta"),
                      torch.empty((2, 64, 32), dtype=torch.int8, device="meta"),
                      torch.empty((2, 1, 32), dtype=torch.float32, device="meta"), 1)
    assert tpa.launch_counts() == {
        "ragged_paged_attention": 0, "paged_decode_attention_fused": 0,
        "qmm_w8a16": 0,
    }


def test_kernel_wrappers_refuse_non_cpu_tensors_without_cuda():
    # meta tensors are neither on the CPU nor on a card: the wrappers must
    # raise instead of quietly computing the plain version
    _meta_calls(64, torch.bfloat16)


@pytest.mark.parametrize("d,dtype", [(16, torch.bfloat16), (64, torch.float32)])
def test_kernel_wrappers_refuse_non_cpu_tensors_of_routed_shapes(d, dtype):
    # shapes and dtypes the kernels do not take raise too: no wrapper
    # computes the plain version for a tensor that is not on the CPU
    _meta_calls(d, dtype)


@pytest.mark.parametrize("pool", [torch.bfloat16, torch.int8, torch.float8_e4m3fn])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("head_dim", [16, 32, 64, 128, 256])
def test_attention_routing_rule(head_dim, dtype, pool):
    # the kernels take bf16 activations at head dims 32/64/128/256 over
    # bf16, int8 and fp8 pools; not the tiny models' 16, nor float32
    want = head_dim in (32, 64, 128, 256) and dtype == torch.bfloat16
    assert tpa.kernel_takes(head_dim, dtype, pool) is want
    assert tpa.kernel_takes(head_dim, dtype, torch.float32) is False


@pytest.mark.parametrize("model,dtype,kv,takes", [
    ("llama3-mini", torch.bfloat16, torch.bfloat16, True),   # head_dim 32
    ("llama3-mini", torch.bfloat16, torch.int8, True),
    ("llama3-8b", torch.bfloat16, torch.float8_e4m3fn, True),
    ("qwen2.5-0.5b", torch.bfloat16, torch.bfloat16, True),  # head_dim 64
    ("llama3-tiny", torch.bfloat16, torch.bfloat16, False),  # head_dim 16
    ("llama3-mini", torch.float32, torch.float32, False),
    ("llama3-8b", torch.float16, torch.float16, False),
])
def test_engine_refuses_on_the_card_a_model_the_kernels_do_not_take(model, dtype, kv,
                                                                    takes):
    from distributed_gpu_inference_torch.models.configs import get_model_config
    from distributed_gpu_inference_torch.runtime.engine import check_kernels_take

    cfg = get_model_config(model)
    if takes:
        check_kernels_take(cfg, dtype, kv)
    else:
        with pytest.raises(ValueError, match="CUDA attention kernels take"):
            check_kernels_take(cfg, dtype, kv)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: pytest -m gpu)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_the_card(cuda):
    from distributed_gpu_inference_torch.ops.attention import paged_attention_ref

    rng = np.random.default_rng(0)
    b, s, nh, hkv, d, bk, m = 3, 32, 8, 2, 128, 16, 6
    n = 1 + b * m
    t = lambda a, dt=torch.bfloat16: torch.tensor(a, dtype=dt, device=cuda)  # noqa: E731
    kp = t(rng.standard_normal((2, n, hkv, bk, d)))
    vp = t(rng.standard_normal((2, n, hkv, bk, d)))
    tables = t(np.arange(1, n).reshape(b, m), torch.int32)
    lens = t([40, 90, 0], torch.int32)
    pos = np.full((b, s), -1)
    pos[0, :1] = 39
    pos[1, :32] = np.arange(58, 90)
    pos = t(pos, torch.int32)
    q = t(rng.standard_normal((b, s, nh, d)))
    got = tpa.ragged_paged_attention(q, kp[1], vp[1], tables, pos, lens, bk)
    want = paged_attention_ref(q, kp[1], vp[1], tables, pos, lens, bk)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-3, rtol=1e-2)
    q1 =t(rng.standard_normal((b, 1, nh, d)))
    nk = t(rng.standard_normal((b, 1, hkv, d)))
    nv = t(rng.standard_normal((b, 1, hkv, d)))
    p1 = (lens - 1).clamp(min=-1)[:, None].to(torch.int32)
    kp2, vp2 = kp.clone(), vp.clone()
    got, _, _ = tpa.paged_decode_attention_fused(q1, nk, nv, kp, vp, 0, tables,
                                                 p1, lens, bk)
    want, _, _ = tpa.paged_decode_attention_fused_plain(q1, nk, nv, kp2, vp2, 0,
                                                        tables, p1, lens, bk)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-3, rtol=1e-2)
    assert torch.equal(kp, kp2) and torch.equal(vp, vp2)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_qmm_kernel_matches_plain_version_on_the_card(cuda, mode):
    # f32 accumulation and one rounding on both sides: one bf16 ulp
    from distributed_gpu_inference_torch.ops import qmm
    from distributed_gpu_inference_torch.ops.quantization import quantize_weight

    rng = np.random.default_rng(1)
    w = torch.tensor(rng.standard_normal((3, 512, 384)) * 0.05, dtype=torch.float32,
                     device=cuda)
    q = quantize_weight(w, mode)
    qmm.qmm_w8a16.launches = 0
    for m in (1, 8, 40, qmm.MAX_KERNEL_ROWS):
        x = torch.tensor(rng.standard_normal((m, 512)), dtype=torch.bfloat16, device=cuda)
        for layer in range(3):
            got = qmm.qmm_w8a16(x, q["qw"], q["scale"], layer)
            want = qmm.qmm_plain(x, q["qw"], q["scale"], layer)
            torch.testing.assert_close(got.float(), want.float(), atol=2e-3, rtol=1e-2)
    assert qmm.qmm_w8a16.launches == 12
    # above the row bound the library route serves, without a launch
    x = torch.tensor(rng.standard_normal((qmm.MAX_KERNEL_ROWS + 1, 512)),
                     dtype=torch.bfloat16, device=cuda)
    got = qmm.qmm_w8a16(x, q["qw"], q["scale"], 2)
    torch.testing.assert_close(got.float(), qmm.qmm_plain(x, q["qw"], q["scale"], 2).float(),
                               atol=2e-2, rtol=2e-2)
    assert qmm.qmm_w8a16.launches == 12


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_qmm_one_deterministic_launch_a_call_on_the_card(cuda, mode):
    # every row path (M 1, 8: 8-row mma groups; 16 < M: wmma tiles; two row
    # groups at 128), narrow and wide N, and K = 1408 / 4112, whose plans end
    # in a short last split (4 x 6 stages ending in 4; 13 x 5 ending in a
    # 16-row stage); one bf16 ulp against the plain version, as in chip_smoke
    from distributed_gpu_inference_torch.ops import qmm
    from distributed_gpu_inference_torch.ops.quantization import quantize_weight

    rng = np.random.default_rng(4)
    dev_idx = cuda.index if cuda.index is not None else torch.cuda.current_device()
    shapes = [(1408, 16), (4112, 1024), (4096, 14336)]
    assert qmm.split_plan(8, 1408, 16) == (4, 384)
    assert qmm.split_plan(8, 4112, 1024) == (13, 320)
    for k, n in shapes:
        w = torch.tensor(rng.standard_normal((2, k, n)) * k ** -0.5, dtype=torch.float32,
                         device=cuda)
        q = quantize_weight(w, mode)
        del w
        for m in (1, 8, 40, 128):
            x = torch.tensor(rng.standard_normal((m, k)), dtype=torch.bfloat16, device=cuda)
            before = qmm.qmm_w8a16.launches
            got = qmm.qmm_w8a16(x, q["qw"], q["scale"], 1)
            again = qmm.qmm_w8a16(x, q["qw"], q["scale"], 1)
            torch.cuda.synchronize()
            assert qmm.qmm_w8a16.launches == before + 2          # one launch a call
            want = qmm.qmm_plain(x, q["qw"], q["scale"], 1)
            torch.testing.assert_close(got.float(), want.float(), atol=2e-3, rtol=1e-2)
            assert torch.equal(got.view(torch.int16), again.view(torch.int16))
            # the arrival counters are all back at zero after every shape
            scratch = qmm._scratch_by_device.get(dev_idx)
            if scratch is not None:
                assert int(scratch.counters.abs().sum()) == 0
        # a CUDA-graph replay gives the eager call's bits
        x = torch.tensor(rng.standard_normal((8, k)), dtype=torch.bfloat16, device=cuda)
        eager = qmm.qmm_w8a16(x, q["qw"], q["scale"], 0)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = qmm.qmm_w8a16(x, q["qw"], q["scale"], 0)
        graph.replay()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(eager.view(torch.int16), captured.view(torch.int16))
    assert int(qmm._scratch_by_device[dev_idx].counters.abs().sum()) == 0
    # above the row bound: the library route, no launch
    before = qmm.qmm_w8a16.launches
    x = torch.tensor(rng.standard_normal((qmm.MAX_KERNEL_ROWS + 1, 4096)),
                     dtype=torch.bfloat16, device=cuda)
    got = qmm.qmm_w8a16(x, q["qw"], q["scale"], 1)
    torch.testing.assert_close(got.float(), qmm.qmm_plain(x, q["qw"], q["scale"], 1).float(),
                               atol=2e-2, rtol=2e-2)
    assert qmm.qmm_w8a16.launches == before


@pytest.mark.gpu
def test_qmm_scratch_is_ordered_across_streams_on_the_card(cuda):
    # two threads on a CUDA stream each share the device's one split-K
    # scratch: every result bitwise the same call's alone, the counters
    # back at zero (chip_smoke.py phase 21 (d) runs the same check)
    import chip_smoke

    n, bad = chip_smoke.qmm_streams_check(torch, cuda)
    assert (n, bad) == (2 * chip_smoke.QMM_STREAM_ROUNDS, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantized_attention_kernels_match_plain_versions_on_the_card(cuda, kind):
    from distributed_gpu_inference_torch.ops.attention import (
        paged_attention_ref,
        quantize_kv_pool,
    )
    from distributed_gpu_inference_torch.ops.quantization import to_float8_e4m3

    rng = np.random.default_rng(2)
    b, s, nh, hkv, d, bk, m = 3, 32, 8, 2, 128, 16, 6
    n = 1 + b * m
    t = lambda a, dt=torch.bfloat16: torch.tensor(a, dtype=dt, device=cuda)  # noqa: E731
    kf = t(rng.standard_normal((2, n, hkv, bk, d)))
    vf = t(rng.standard_normal((2, n, hkv, bk, d)))
    if kind == "int8":
        pk = [quantize_kv_pool(kf[i]) for i in range(2)]
        pv = [quantize_kv_pool(vf[i]) for i in range(2)]
        kp, ks = torch.stack([c for c, _ in pk]), torch.stack([x for _, x in pk])
        vp, vs = torch.stack([c for c, _ in pv]), torch.stack([x for _, x in pv])
    else:
        kp, vp, ks, vs = to_float8_e4m3(kf), to_float8_e4m3(vf), None, None
    tables = t(np.arange(1, n).reshape(b, m), torch.int32)
    lens = t([40, 90, 0], torch.int32)
    pos = np.full((b, s), -1)
    pos[0, :1] = 39
    pos[1, :32] = np.arange(58, 90)
    pos = t(pos, torch.int32)
    q = t(rng.standard_normal((b, s, nh, d)))
    sl = {} if ks is None else dict(k_scale=ks[1], v_scale=vs[1])
    got = tpa.ragged_paged_attention(q, kp[1], vp[1], tables, pos, lens, bk, **sl)
    want = paged_attention_ref(q, kp[1], vp[1], tables, pos, lens, bk, **sl)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-3, rtol=1e-2)
    q1 = t(rng.standard_normal((b, 1, nh, d)))
    nk = t(rng.standard_normal((b, 1, hkv, d)) * 3)
    nv = t(rng.standard_normal((b, 1, hkv, d)))
    p1 = (lens - 1).clamp(min=-1)[:, None].to(torch.int32)
    kp2, vp2 = kp.clone(), vp.clone()
    sc = {} if ks is None else dict(k_scale=ks, v_scale=vs)
    sc2 = {} if ks is None else dict(k_scale=ks.clone(), v_scale=vs.clone())
    got, _, _ = tpa.paged_decode_attention_fused(q1, nk, nv, kp, vp, 0, tables, p1, lens, bk,
                                                 **sc)
    want, _, _ = tpa.paged_decode_attention_fused_plain(q1, nk, nv, kp2, vp2, 0, tables, p1,
                                                        lens, bk, **sc2)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-3, rtol=1e-2)
    assert torch.equal(kp.view(torch.uint8), kp2.view(torch.uint8))
    assert torch.equal(vp.view(torch.uint8), vp2.view(torch.uint8))
    if ks is not None:
        assert torch.equal(sc["k_scale"], sc2["k_scale"])
        assert torch.equal(sc["v_scale"], sc2["v_scale"])


@pytest.mark.gpu
def test_seeded_sampling_on_the_card_matches_the_cpu(cuda):
    # integer threefry and the op-for-op logarithm give the same noise on
    # the card as on the CPU (and so as jax.random): identical tokens
    from distributed_gpu_inference_torch.ops import sampling

    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((4, 1000)) * 3).astype(np.float32)
    keys = rng.integers(0, 2**32, (4, 2), dtype=np.uint32)
    ctl = (np.array([0.0, 0.7, 1.0, 1.5], np.float32), np.array([0, 50, 0, 5], np.int32),
           np.ones(4, np.float32))
    pos = [3, 17, 400, 9]
    cpu = sampling.sample_tokens_per_slot(torch.from_numpy(logits), keys, pos,
                                          *map(torch.from_numpy, ctl))
    gpu = sampling.sample_tokens_per_slot(torch.from_numpy(logits).to(cuda), keys, pos,
                                          *(torch.from_numpy(a).to(cuda) for a in ctl))
    assert torch.equal(gpu.cpu(), cpu)
    k = torch.from_numpy(keys.astype(np.int64))
    assert torch.equal(sampling.gumbel(k.to(cuda), 4099).cpu().view(torch.int32),
                       sampling.gumbel(k, 4099).view(torch.int32))


def _pools(kind, kf, vf):
    """bf16 stacked pools [L, N, ...] → (k, v, k_scale, v_scale) in ``kind``."""
    from distributed_gpu_inference_torch.ops.attention import quantize_kv_pool
    from distributed_gpu_inference_torch.ops.quantization import to_float8_e4m3

    if kind == "bf16":
        return kf, vf, None, None
    if kind == "fp8":
        return to_float8_e4m3(kf), to_float8_e4m3(vf), None, None
    pk = [quantize_kv_pool(kf[i]) for i in range(kf.shape[0])]
    pv = [quantize_kv_pool(vf[i]) for i in range(vf.shape[0])]
    return (torch.stack([c for c, _ in pk]), torch.stack([c for c, _ in pv]),
            torch.stack([x for _, x in pk]), torch.stack([x for _, x in pv]))


def _bits(t):
    return t.view(torch.uint8) if t.element_size() == 1 else t.view(torch.int16)


@pytest.mark.gpu
@pytest.mark.parametrize("d,bk,kind,nh,window", [
    (32, 16, "bf16", 8, None), (32, 16, "int8", 8, 300),
    (64, 8, "bf16", 8, None), (64, 32, "int8", 8, 300), (128, 16, "bf16", 48, 300),
    (128, 8, "fp8", 8, None), (128, 32, "int8", 40, None), (256, 32, "bf16", 8, 300),
    (256, 8, "int8", 8, None), (256, 16, "fp8", 8, 300),
])
def test_split_kernels_match_plain_versions_on_the_card(cuda, d, bk, kind, nh, window):
    # 2048-key rows over many splits (8 at every Bk), a window that crosses
    # split boundaries, a decode row whose position is slot 0 of a fresh
    # page, an inactive row; qpk 24 and 20 spread a head group over two
    # blocks of the fused kernel (16 query heads a block). Tolerances are the smoke
    # run's (atol 3e-3 ragged / 2e-3 fused, rtol 1e-2; the ragged kernel over
    # an int8 pool also rounds code*scale to bf16: + 2^-9 max|value|).
    from distributed_gpu_inference_torch.ops.attention import dequantize_kv, paged_attention_ref

    rng = np.random.default_rng(d + bk)
    hkv, keys = 2, 2048
    m = keys // bk
    b = 4
    n = 1 + b * m
    t = lambda a, dt=torch.bfloat16: torch.tensor(a, dtype=dt, device=cuda)  # noqa: E731
    kp, vp, ks, vs = _pools(kind, t(rng.standard_normal((2, n, hkv, bk, d))),
                            t(rng.standard_normal((2, n, hkv, bk, d))))
    tables = np.arange(1, n, dtype=np.int32).reshape(b, m)
    tables[2] = 0
    tables = t(tables, torch.int32)
    pages, splits = tpa.kv_split_plan(m, bk)
    assert splits >= 8
    slot0 = 9 * bk                                   # first slot of page 9
    lens = t([keys, slot0 + 1, 0, 700], torch.int32)
    atol = 3e-3
    if kind == "int8":
        atol += 2.0 ** -9 * float(max(dequantize_kv(kp[1], ks[1][:, None, :, None]).abs().max(),
                                      dequantize_kv(vp[1], vs[1][:, None, :, None]).abs().max()))
    sl = {} if ks is None else dict(k_scale=ks[1], v_scale=vs[1])

    # ---- ragged: a 48-wide chunk at the end of a 2048-key row, a decode
    # row at slot 0, a pad row, a first chunk
    s = 48
    pos = np.full((b, s), -1)
    pos[0] = np.arange(keys - s, keys)
    pos[1, 0] = slot0
    pos[3] = np.arange(s)
    pos = t(pos, torch.int32)
    lens_r = t([keys, slot0 + 1, 0, s], torch.int32)
    q = t(rng.standard_normal((b, s, nh, d)))
    want = paged_attention_ref(q, kp[1], vp[1], tables, pos, lens_r, bk, window=window, **sl)
    got = tpa.ragged_paged_attention(q, kp[1], vp[1], tables, pos, lens_r, bk, window=window,
                                     **sl)
    again = tpa.ragged_paged_attention(q, kp[1], vp[1], tables, pos, lens_r, bk, window=window,
                                       **sl)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=1e-2)
    assert torch.equal(_bits(got), _bits(again))               # bitwise repeatable
    assert bool((got[pos < 0] == 0).all())

    # ---- fused decode over the same pools
    q1 = t(rng.standard_normal((b, 1, nh, d)))
    nk = t(rng.standard_normal((b, 1, hkv, d)) * 3)
    nv = t(rng.standard_normal((b, 1, hkv, d)))
    p1 = (lens - 1).clamp(min=-1)[:, None].to(torch.int32)
    kp2, vp2 = kp.clone(), vp.clone()
    sc = {} if ks is None else dict(k_scale=ks, v_scale=vs)
    sc2 = {} if ks is None else dict(k_scale=ks.clone(), v_scale=vs.clone())
    got, _, _ = tpa.paged_decode_attention_fused(q1, nk, nv, kp, vp, 1, tables, p1, lens, bk,
                                                 window=window, **sc)
    want, _, _ = tpa.paged_decode_attention_fused_plain(q1, nk, nv, kp2, vp2, 1, tables, p1,
                                                        lens, bk, window=window, **sc2)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-3, rtol=1e-2)
    assert bool((got[2] == 0).all())                           # inactive row
    assert torch.equal(_bits(kp), _bits(kp2)) and torch.equal(_bits(vp), _bits(vp2))
    if ks is not None:
        assert torch.equal(_bits(sc["k_scale"]), _bits(sc2["k_scale"]))
        assert torch.equal(_bits(sc["v_scale"]), _bits(sc2["v_scale"]))
    # the same step again (the rows are already written): the same bits
    again, _, _ = tpa.paged_decode_attention_fused(q1, nk, nv, kp, vp, 1, tables, p1, lens, bk,
                                                   window=window, **sc)
    assert torch.equal(_bits(got), _bits(again))
    assert torch.equal(_bits(kp), _bits(kp2))


@pytest.mark.gpu
def test_small_head_dim_model_serves_through_the_kernels_on_the_card(cuda):
    # llama3-mini (head_dim 32, the worker's default model) on the card:
    # both attention kernels launch, no round fails
    from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine

    llm = TorchLLMEngine({"model": "llama3-mini", "max_batch_size": 4,
                          "max_seq_len": 256, "device": "cuda", "seed": 0})
    llm.load_model()
    try:
        tpa.reset_launch_counts()
        outs = llm.batch_inference([{"prompt": f"request {i}", "max_new_tokens": 16,
                                     "ignore_eos": True} for i in range(4)])
        counts = tpa.launch_counts()
        assert all(o["usage"]["completion_tokens"] == 16 for o in outs)
        assert counts["ragged_paged_attention"] > 0
        assert counts["paged_decode_attention_fused"] > 0
        # the engine is still usable: no round failed part-way
        assert llm.inference({"prompt": "again", "max_new_tokens": 4})["usage"][
            "completion_tokens"] >= 1
    finally:
        llm.unload()


@pytest.mark.gpu
def test_worker_process_serves_drains_and_resumes_on_the_card(cuda):
    # chip_smoke.py phase 13 at llama3-mini (int8 weights): the CLI-started
    # worker against the stand-in plane serves polled jobs and a direct
    # stream, drains a job that a restarted worker resumes, and all three
    # kernels launch
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _, _, prompts = smoke.serving_prompts()
    _, _, counts, _ = smoke.worker_phase(torch, tpa, "gpu test", prompts, model="llama3-mini")
    assert all(n > 0 for n in counts.values()), counts


@pytest.mark.gpu
def test_spill_and_l2_restore_on_the_card(cuda):
    # chip_smoke.py phase 14 check (c) at llama3-mini: A's pages spill when
    # fillers evict them, come back from the host tier bitwise equal, and
    # the greedy stream equals the L1-hit run through both attention kernels
    import importlib.util

    from distributed_gpu_inference_torch.utils.data_structures import compute_prefix_hash
    from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    llm = TorchLLMEngine({"model": "llama3-mini", "max_batch_size": 8, "max_seq_len": 512,
                          "num_blocks": smoke.SPILL_POOL_BLOCKS, "kv_spill_host_blocks": 64,
                          "device": "cuda", "seed": 0, "prefix_summary_top_n": 0})
    llm.load_model()
    witness = None
    try:
        keys = [compute_prefix_hash(llm.tokenizer.encode(smoke.spill_text(0)), (i + 1) * 16)
                for i in range(smoke.SPILL_RESTORED)]
        tpa.reset_launch_counts()
        *_, witness = smoke.spill_restore_check(torch, llm, keys, "gpu test")
        counts = tpa.launch_counts()
        assert counts["ragged_paged_attention"] > 0
        assert counts["paged_decode_attention_fused"] > 0
        assert llm.engine.manager.get_stats()["l2_hits"] == len(keys)
    finally:
        if witness is not None:
            witness.close()
        llm.unload()


@pytest.mark.gpu
def test_speculative_greedy_streams_on_the_card(cuda):
    # chip_smoke.py phase 15 checks (a)-(c) and (h) at llama3-mini: the
    # speculating engine's greedy streams are the target's argmax under a
    # teacher-forced re-score (near-ties aside), the verify rows ride the
    # ragged kernel and never the fused one, and the allocator ends as a
    # never-speculated engine's
    import importlib.util

    from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _, _, prompts = smoke.serving_prompts()
    base = {"model": "llama3-mini", "max_batch_size": smoke.SERVE_BATCH,
            "max_seq_len": smoke.MAX_SEQ, "device": "cuda", "seed": 0,
            "prefix_summary_top_n": 0}
    llm = TorchLLMEngine({**base, "speculative_decode": True,
                          "spec_num_draft_tokens": smoke.SPEC_K})
    llm.load_model()
    plain = TorchLLMEngine({**base, "params": llm.engine.params})
    plain.load_model()
    try:
        counts, routes, rows = smoke.spec_pass(torch, tpa, "gpu test", llm, plain, prompts,
                                               quantized=False)
    finally:
        plain.unload()
        llm.unload()
    assert counts["paged_decode_attention_fused"] == 0
    assert routes.ragged_s.get(smoke.SPEC_K + 1, 0) > 0
    assert all(len(t) == smoke.SPEC_TOKENS for _, t in rows)


@pytest.mark.gpu
def test_device_migration_and_streamed_export_bit_identical_on_the_card(cuda):
    # chip_smoke.py phase 16 (a)/(c) at llama3-mini with bf16 and int8
    # pools: migrate_kv_device and a streamed export adopted by a second
    # engine leave pages (and scales) bit-identical to the donor's, and the
    # continued greedy stream equals the donor's own
    from distributed_gpu_inference_torch.runtime import kv_handoff as tkh
    from distributed_gpu_inference_torch.runtime.engine import EngineConfig
    from distributed_gpu_inference_torch.utils.data_structures import (
        InferenceRequest,
        SamplingParams,
    )

    def req():
        return InferenceRequest(prompt_token_ids=[(i * 7 + 3) % 2000 for i in range(300)],
                                sampling=SamplingParams(max_new_tokens=16, ignore_eos=True))

    def raw(t):
        return t.contiguous().view(torch.uint8)

    for kv in (None, "int8"):
        cfg = dict(max_batch_size=2, max_seq_len=512, kv_cache_dtype=kv,
                   prefill_buckets=(16, 32, 64, 128))
        a = TorchEngine("llama3-mini", EngineConfig(**cfg), seed=0, device="cuda")
        b = TorchEngine("llama3-mini", EngineConfig(**cfg), params=a.params, device="cuda")
        ref = a.generate([req()], use_multi_step=True)[0].token_ids
        a.manager.clear_cached()
        slot = a.submit(req())
        blocks = list(a.manager.seq_blocks[a.slots[slot].seq_id])
        dslot = tkh.migrate_kv_device(a, b, slot)
        dblocks = list(b.manager.seq_blocks[b.slots[dslot].seq_id])
        for key in a.kv:
            assert torch.equal(raw(a.kv[key][:, blocks]), raw(b.kv[key][:, dblocks])), key
        a.finish_slot(slot, cache=False)
        while b.slots[dslot].finish_reason is None:
            b.decode_multi()
        assert b.finish_slot(dslot).token_ids == ref
        b.manager.clear_cached()
        a.manager.clear_cached()
        exp = tkh.StreamedExport(a, req(), "card", piece_blocks=4)
        rx = tkh.HandoffReceiver(b)
        gathered = {}
        real = a.gather_pages

        def gather(bids, wait=True):
            out = real(bids, wait=wait)
            gathered.update({bid: None for bid in bids})
            return out

        a.gather_pages = gather
        try:
            out = [rx.handle(m) for m in exp.messages()][-1]
        finally:
            del a.gather_pages
        assert exp.bytes_before_first_token > 0
        s = b.slots[out["slot"]]
        for lb, bid in enumerate(b.manager.seq_blocks[s.seq_id][:300 // 16]):
            src = list(gathered)[lb]
            for key in a.kv:
                assert torch.equal(raw(a.kv[key][:, src]), raw(b.kv[key][:, bid])), key
        while b.slots[out["slot"]].finish_reason is None:
            b.decode_multi()
        assert b.finish_slot(out["slot"]).token_ids == ref
        del a, b
        torch.cuda.empty_cache()
