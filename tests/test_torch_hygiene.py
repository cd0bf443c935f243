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
    assert tpa.launch_counts() == {
        "ragged_paged_attention": 0, "paged_decode_attention_fused": 0,
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
