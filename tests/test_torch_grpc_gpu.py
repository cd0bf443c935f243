"""The gRPC stage plane on the card (``gpu``): llama3-8b at full width and
a small depth, int8 weights and bf16 pools, two ``PipelineStageWorker`` s
on cuda:0, each behind a ``GrpcDataPlane`` and a ``DataPlaneServer`` on
127.0.0.1. A prompt prefilled in chunks of 7 tokens, then greedy decode:
the tokens over ``StreamForward`` equal those over HTTP, every step's
logits bit for bit, and the stages launch all three kernels. The file
imports no JAX, so the card runs it as it is:

    python3 -m pytest -m gpu tests/test_torch_grpc_gpu.py --noconftest"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distributed_gpu_inference_torch.comm.data_plane import DataPlaneServer  # noqa: E402
from distributed_gpu_inference_torch.comm.grpc_plane import (  # noqa: E402
    GrpcDataPlane,
    GrpcStageClient,
)
from distributed_gpu_inference_torch.comm.session import WorkerSession  # noqa: E402
from distributed_gpu_inference_torch.comm.stage_worker import PipelineStageWorker  # noqa: E402
from distributed_gpu_inference_torch.models.configs import get_model_config  # noqa: E402
from distributed_gpu_inference_torch.ops import paged_attention as pa  # noqa: E402
from distributed_gpu_inference_torch.parallel.pipeline import (  # noqa: E402
    slice_stage_params,
    uniform_stages,
)
from distributed_gpu_inference_torch.runtime.engine import (  # noqa: E402
    EngineConfig,
    engine_params,
)
from distributed_gpu_inference_torch.utils.data_structures import BlockRange  # noqa: E402

LAYERS = 2
CHUNK = 7
TOKENS = 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: pytest -m gpu)")
    return torch.device("cuda")


def _greedy(hop, prompt):
    toks, logits_seen = [], []

    def step(ids, start):
        x = np.asarray([ids], np.int32)
        pos = np.asarray([list(range(start, start + len(ids)))], np.int32)
        for i in range(2):
            out = hop(i, x, pos, start + len(ids))
            x = out["hidden"]
        logits_seen.append(out["logits"])
        return int(torch.argmax(out["logits"][0, -1]))

    for c in range(0, len(prompt), CHUNK):
        tok = step(prompt[c:c + CHUNK], c)
    toks, n = [tok], len(prompt)
    while len(toks) < TOKENS:
        toks.append(step([toks[-1]], n))
        n += 1
    return toks, logits_seen


@pytest.mark.gpu
def test_two_stages_over_grpc_equal_http(cuda):
    cfg = get_model_config("llama3-8b", num_layers=LAYERS)
    params = engine_params(cfg, EngineConfig(quantization="int8"), None, 0, cuda)
    plan = uniform_stages(LAYERS, 2)
    stages = [PipelineStageWorker(cfg, r, params=slice_stage_params(params, *r,
                                                                    num_layers=LAYERS),
                                  num_blocks=16, max_blocks_per_seq=8, dtype="bfloat16")
              for r in plan]
    grpcs = [GrpcDataPlane(st, host="127.0.0.1", port=0) for st in stages]
    https = [DataPlaneServer(stage=st) for st in stages]
    for p in grpcs + https:
        p.start()
    clients = [GrpcStageClient(f"127.0.0.1:{g.port}", timeout_s=120.0) for g in grpcs]
    sessions = [WorkerSession(h.url, BlockRange(*r), timeout_s=120.0)
                for h, r in zip(https, plan)]
    prompt = np.random.default_rng(28).integers(0, cfg.vocab_size, size=40).tolist()
    try:
        for c in clients:
            c.create_session("g")
        streams = [c.open_stream() for c in clients]
        torch.cuda.synchronize()
        pa.reset_launch_counts()
        got = _greedy(lambda i, *a: streams[i].step("g", *a), prompt)
        torch.cuda.synchronize()
        counts = pa.launch_counts()
        for s in streams:
            s.close()
        for ws in sessions:
            ws.create("h")
        want = _greedy(lambda i, *a: sessions[i].forward("h", *a), prompt)
    finally:
        for c in clients:
            c.close()
        for p in grpcs:
            p.stop(0)
        for p in https:
            p.stop()
    assert got[0] == want[0] and len(got[0]) == TOKENS
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    assert all(counts[k] > 0 for k in ("ragged_paged_attention", "paged_decode_attention_fused",
                                       "qmm_w8a16")), counts
