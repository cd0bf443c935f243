"""Hygiene of the PyTorch port: it imports nothing of JAX or of the JAX
package, runs on CUDA unless asked for the CPU, and its kernel wrappers
never fall back to the plain version for a tensor that is not on the CPU.
Tests that need the card carry the ``gpu`` marker and skip without one."""

import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distributed_gpu_inference_torch.ops import paged_attention as tpa  # noqa: E402
from distributed_gpu_inference_torch.runtime.engine import TorchEngine  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "distributed_gpu_inference_tpu")


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
            "chip_smoke.py"} <= {f.name for f in files}
    offenders = {
        str(f.relative_to(ROOT)): sorted(set(_imported_roots(f)) & set(FORBIDDEN))
        for f in files
    }
    assert {k: v for k, v in offenders.items() if v} == {}


def test_engine_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchEngine("llama3-tiny")


def test_kernel_wrappers_refuse_non_cpu_tensors_without_cuda():
    # meta tensors are neither on the CPU nor on a card: the wrappers must
    # raise instead of quietly computing the plain version
    q = torch.empty((1, 16, 4, 64), dtype=torch.bfloat16, device="meta")
    pool = torch.empty((3, 2, 16, 64), dtype=torch.bfloat16, device="meta")
    idx = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    pos = torch.zeros((1, 16), dtype=torch.int32, device="meta")
    lens = torch.zeros((1,), dtype=torch.int32, device="meta")
    tpa.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        tpa.ragged_paged_attention(q, pool, pool, idx, pos, lens, 16)
    stacked = pool[None]
    with pytest.raises(ValueError, match="CUDA tensor"):
        tpa.paged_decode_attention_fused(
            q[:, :1], stacked[0, :1, :, :1].reshape(1, 1, 2, 64),
            stacked[0, :1, :, :1].reshape(1, 1, 2, 64), stacked, stacked, 0,
            idx, pos[:, :1], lens, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tpa.qmm_w8a16(torch.empty((4, 64), dtype=torch.bfloat16, device="meta"),
                      torch.empty((2, 64, 32), dtype=torch.int8, device="meta"),
                      torch.empty((2, 1, 32), dtype=torch.float32, device="meta"), 1)
    assert tpa.launch_counts() == {
        "ragged_paged_attention": 0, "paged_decode_attention_fused": 0,
        "qmm_w8a16": 0,
    }


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
