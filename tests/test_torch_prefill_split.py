"""Does a prompt that fits in one prefill chunk take the same arithmetic
through ``submit_chunked_step`` (one row: the path ``StreamedExport``
prefills by) as through ``submit_batch`` (the one-shot and local paths)?

For each package's engine (the JAX ``TPUEngine`` and the port's
``TorchEngine``, CPU, ``llama3-tiny``, int8 KV pool, f32 and bf16 compute,
the same numpy-seeded weights), one 40-token prompt is prefilled through
``submit_batch`` alone, through ``submit_batch`` beside a second request,
and through ``submit_chunked_start`` / ``submit_chunked_step``. The pages
each path writes (int8 codes and their scales, exported with
``export_slot_kv``) and the greedy ids that follow must be bitwise equal
to the lone ``submit_batch``'s.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_gpu_inference_torch.models.convert import params_from_numpy  # noqa: E402
from distributed_gpu_inference_torch.runtime import engine as tengine  # noqa: E402
from distributed_gpu_inference_torch.runtime import kv_handoff as tkh  # noqa: E402
from distributed_gpu_inference_torch.utils import data_structures as tds  # noqa: E402
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402
from distributed_gpu_inference_tpu.models.configs import get_model_config  # noqa: E402
from distributed_gpu_inference_tpu.runtime import engine as jengine  # noqa: E402
from distributed_gpu_inference_tpu.runtime import kv_handoff as jkh  # noqa: E402
from distributed_gpu_inference_tpu.utils import data_structures as jds  # noqa: E402

MODEL = "llama3-tiny"
PROMPT = [(i * 37 + 11) % 500 for i in range(40)]     # one chunk (bucket 64)
OTHER = [(i * 53 + 7) % 500 for i in range(24)]
NEW = 12


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(get_model_config(MODEL), jax.random.PRNGKey(7), jnp.float32)
    return jp, jax.tree.map(np.asarray, jp)


def _engine(pkg, dtype, weights):
    geom = dict(max_batch_size=2, max_seq_len=128, block_size=16,
                prefill_buckets=(16, 32, 64), dtype=dtype, multi_step=4,
                kv_cache_dtype="int8")
    if pkg == "jax":
        params = jax.tree.map(lambda a: a.astype(getattr(jnp, dtype)), weights[0])
        return jengine.TPUEngine(MODEL, jengine.EngineConfig(**geom), params=params), jds, jkh
    return (tengine.TorchEngine(MODEL, tengine.EngineConfig(**geom),
                                params=params_from_numpy(weights[1], "cpu"), device="cpu"),
            tds, tkh)


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


def _prefill(pkg, dtype, weights, path):
    eng, ds, kh = _engine(pkg, dtype, weights)
    req = ds.InferenceRequest(prompt_token_ids=list(PROMPT),
                              sampling=ds.SamplingParams(max_new_tokens=NEW))
    if path == "batch":
        slot = eng.submit_batch([req])[0]
    elif path == "batch-beside-another":
        other = ds.InferenceRequest(prompt_token_ids=list(OTHER),
                                    sampling=ds.SamplingParams(max_new_tokens=NEW))
        slot = eng.submit_batch([req, other])[0]
    else:
        adm = eng.submit_chunked_start(req)
        while not eng.submit_chunked_step(adm):
            pass
        slot = adm.slot
    h = kh.export_slot_kv(eng, slot)
    while eng.slots[slot].finish_reason is None:
        eng.decode_step()
    return _host(h.pages), _host(h.scale_pages), list(eng.finish_slot(slot).token_ids)


@pytest.fixture(scope="module")
def lone_batch(weights):
    """The lone ``submit_batch``'s pages and ids, by (package, dtype)."""
    cache = {}

    def get(pkg, dtype):
        if (pkg, dtype) not in cache:
            cache[pkg, dtype] = _prefill(pkg, dtype, weights, "batch")
        return cache[pkg, dtype]

    return get


@pytest.mark.parametrize("path", ["batch-beside-another", "chunked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_one_chunk_prefills_alike_through_both_entry_points(weights, lone_batch, pkg,
                                                            dtype, path):
    pages, scales, ids = lone_batch(pkg, dtype)
    got_pages, got_scales, got_ids = _prefill(pkg, dtype, weights, path)
    assert np.array_equal(got_pages, pages)
    assert np.array_equal(got_scales, scales)
    assert got_ids == ids and len(ids) == NEW


@pytest.mark.parametrize("prompt_len,chunks", [(40, 1), (100, 2)])
def test_a_one_chunk_prompt_takes_submit_batch_s_forward_shape(weights, prompt_len, chunks):
    """On the card the forward's row count decides how qmm splits its
    work, so the CPU equality above does not carry over by itself: the
    port's ``submit_batch`` prefills a prompt alone in its bucket through
    the forward a ``submit_chunked_step`` chunk takes (one row, the slot's
    table row), and a longer prompt takes one row a chunk."""
    eng, ds, _ = _engine("port", "float32", weights)
    seen = []
    real = eng._forward

    def spy(toks_pos, tables, lens, **kw):
        seen.append((toks_pos.shape, int(np.flatnonzero(lens)[0]), tuple(lens.shape),
                     tuple(np.asarray(tables).shape)))
        return real(toks_pos, tables, lens, **kw)

    eng._forward = spy
    ids = [(i * 31 + 5) % 500 for i in range(prompt_len)]
    req = ds.InferenceRequest(prompt_token_ids=ids, sampling=ds.SamplingParams(max_new_tokens=2))
    if chunks == 1:
        slot = eng.submit_batch([req])[0]
        eng.finish_slot(slot)
    # another prompt of the same length (no prefix-cache hit)
    adm = eng.submit_chunked_start(ds.InferenceRequest(
        prompt_token_ids=[(t + 1) % 500 for t in ids],
        sampling=ds.SamplingParams(max_new_tokens=2)))
    while not eng.submit_chunked_step(adm):
        pass
    if chunks == 1:
        batch, chunked = seen
        assert chunked == batch and batch[0][1] == 1
        assert batch[3] == (1, eng.cfg.max_blocks_per_seq)
    else:
        assert [s[0][1] for s in seen] == [1, 1] and all(s[1] == 0 for s in seen)
