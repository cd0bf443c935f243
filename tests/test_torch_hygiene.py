"""Hygiene of the PyTorch port: it imports nothing of JAX or of the JAX
package (nor aiohttp, httpx or transformers, which the card's machine
lacks), runs on CUDA unless asked for the CPU, its kernel wrappers never
fall back to the plain version for a tensor that is not on the CPU, and
the engine refuses on the card a model the kernels do not take. Tests
that need the card carry the ``gpu`` marker and skip without one."""

import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distributed_gpu_inference_torch.ops import paged_attention as tpa  # noqa: E402
from distributed_gpu_inference_torch.runtime.engine import TorchEngine  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "distributed_gpu_inference_tpu", "aiohttp", "httpx",
             "transformers")


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
            "direct_server.py", "llm.py", "chip_smoke.py"} <= {f.name for f in files}
    offenders = {
        str(f.relative_to(ROOT)): sorted(set(_imported_roots(f)) & set(FORBIDDEN))
        for f in files
    }
    assert {k: v for k, v in offenders.items() if v} == {}


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
