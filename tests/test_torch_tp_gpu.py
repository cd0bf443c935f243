"""Tensor parallelism on the card (``gpu``): ``chip_smoke.py`` phase 23's (a)
and (b) at llama3-8b width and a small depth, two ranks on cuda:0 over
gloo. The file imports no JAX, so the card runs it as it is:

    python3 -m pytest -m gpu tests/test_torch_tp_gpu.py --noconftest

(a) int8 weights and int8 pools: both ranks launch the ragged kernel and
the quantized matmul and never the fused decode kernel (an int8 decode
step under tensor parallelism writes through the max-reduced quantize and
reads through the ragged kernel), the replicated scale pools agree bit for
bit, and the first-token logits agree with the one-rank engine's. (b) bf16
pools: both ranks launch the fused decode kernel."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distributed_gpu_inference_torch.models.configs import get_model_config  # noqa: E402
from distributed_gpu_inference_torch.runtime.engine import (  # noqa: E402
    EngineConfig,
    TorchEngine,
)
from distributed_gpu_inference_torch.utils.data_structures import (  # noqa: E402
    InferenceRequest,
    SamplingParams,
)

LAYERS = 2
# first-token logits, tp 2 against tp 1, relative L2: bf16 row-parallel
# partial sums are rounded before the all-reduce (two layers)
LOGITS_REL = 5e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: pytest -m gpu)")
    return torch.device("cuda")


def _engine(kv, tp):
    cfg = get_model_config("llama3-8b", num_layers=LAYERS)
    return TorchEngine(cfg, EngineConfig(max_batch_size=4, max_seq_len=512,
                                         enable_prefix_cache=False, quantization="int8",
                                         kv_cache_dtype=kv),
                       seed=0, rank_devices=["cuda:0"] * tp if tp > 1 else None)


def _first_logits(engine, prompts):
    seen = []
    real = engine._sample

    def sample(logits, rows, positions, mode):
        seen.append(logits.float().clone())
        return real(logits, rows, positions, mode)

    engine._sample = sample
    reqs = [InferenceRequest(prompt_token_ids=p, sampling=SamplingParams(
        max_new_tokens=9, temperature=0.0, ignore_eos=True)) for p in prompts]
    slots = engine.submit_batch(reqs)
    engine.decode_multi(8)
    del engine._sample
    torch.cuda.synchronize()
    return seen[0][:len(prompts)], slots


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["int8", None], ids=["int8-pools", "bf16-pools"])
def test_two_ranks_on_one_card_run_the_kernels(cuda, kv):
    rng = np.random.default_rng(0)
    # one prefill bucket (64): the first sample is the whole wave's
    prompts = [list(map(int, rng.integers(1, 128000, n))) for n in (40, 50, 60, 64)]
    one = _engine(kv, 1)
    want, _ = _first_logits(one, prompts)
    del one
    two = _engine(kv, 2)
    try:
        assert two.get_stats()["tp"]["backend"] == "gloo"
        two.reset_rank_launch_counts()
        got, slots = _first_logits(two, prompts)
        counts = two.rank_launch_counts()
        for c in counts:
            assert c["ragged_paged_attention"] > 0 and c["qmm_w8a16"] > 0, counts
            assert (c["paged_decode_attention_fused"] > 0) == (kv is None), counts
        rel = float((got - want).norm() / want.norm())
        assert rel < LOGITS_REL, rel
        assert all(len(two.slots[s].generated) == 9 for s in slots)
        if kv == "int8":
            pools = two.rank_pools()
            for name in ("k_scale", "v_scale"):
                assert np.array_equal(pools[0][name], pools[1][name])
    finally:
        two.shutdown()
