"""The port's C++ radix prefix index (``distributed_gpu_inference_torch/
native/``, built from its own ``src/radix_index.cpp`` into ``build/native/``)
against the JAX package's two indexes:

- seeded fuzzed operation sequences (match, insert, contains, is_leaf,
  remove with the interior-eviction refusal) give identical results on the
  port's native index, JAX's Python ``RadixPrefixIndex`` and JAX's
  ``NativeRadixPrefixIndex``, with token ids as lists and as int32 arrays;
- the port's block manager and engine hold the native index when it
  builds, the manager's lifecycle matches the JAX manager's, and the
  prefix-hit greedy streams are those of the Python index and of the JAX
  engine;
- the build writes a temporary file and renames it, so concurrent builders
  never load a half-written library; without a compiler the Python index
  is taken with a logged warning.

Skipped only where no C++ compiler exists, as JAX's
``tests/test_native_radix.py`` is."""

import ctypes
import logging
import os
import pathlib
import random
import shutil
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_gpu_inference_torch import native as tnative  # noqa: E402
from distributed_gpu_inference_torch.models.convert import params_from_numpy  # noqa: E402
from distributed_gpu_inference_torch.native.radix import NativeRadixPrefixIndex  # noqa: E402
from distributed_gpu_inference_torch.runtime import engine as tengine  # noqa: E402
from distributed_gpu_inference_torch.runtime import kv_cache as tkv  # noqa: E402
from distributed_gpu_inference_torch.utils import data_structures as tds  # noqa: E402
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402
from distributed_gpu_inference_tpu.models.configs import get_model_config  # noqa: E402
from distributed_gpu_inference_tpu.native.radix import (  # noqa: E402
    NativeRadixPrefixIndex as JNativeIndex,
)
from distributed_gpu_inference_tpu.runtime import engine as jengine  # noqa: E402
from distributed_gpu_inference_tpu.runtime import kv_cache as jkv  # noqa: E402
from distributed_gpu_inference_tpu.utils import data_structures as jds  # noqa: E402

needs_cxx = pytest.mark.skipif(shutil.which(os.environ.get("CXX", "g++")) is None,
                               reason="no C++ compiler")

MODEL = "llama3-tiny"
ROOT = pathlib.Path(__file__).resolve().parents[1]


@needs_cxx
def test_the_library_builds_from_the_repo_source():
    assert tnative.native_available()
    path = tnative.library_path()
    assert path.parent == tnative.BUILD_DIR and path.is_file()
    assert tnative.BUILD_DIR == ROOT / "build" / "native"
    assert tnative.SRC == ROOT / "distributed_gpu_inference_torch/native/src/radix_index.cpp"
    idx = tkv.make_radix_index(4)
    assert isinstance(idx, NativeRadixPrefixIndex) and idx.native
    assert idx.insert([1, 2, 3, 4, 5, 6, 7, 8], [10, 11]) == 2
    assert idx.match_prefix([1, 2, 3, 4, 5, 6, 7, 8, 9]) == [10, 11]
    assert idx.match_prefix(np.array([1, 2, 3, 4, 9, 9, 9, 9], np.int32)) == [10]
    assert idx.match_prefix([]) == [] and idx.insert([], []) == 0
    # 6 tokens = 1 full block: a partial tail is never indexed
    assert idx.insert([5, 5, 5, 5, 6, 6], [20, 21]) == 1 and len(idx) == 3
    with pytest.raises(ValueError, match="cannot evict interior radix block 10"):
        idx.remove_block(10)
    idx.remove_block(11)
    idx.remove_block(99)                        # absent: a no-op
    assert idx.is_leaf(10) and not idx.contains_block(11) and len(idx) == 2


def _apply(idx, op, args):
    if op == "match":
        return idx.match_prefix(args)
    if op == "insert":
        return idx.insert(*args)
    if op == "probe":
        return idx.contains_block(args), idx.is_leaf(args)
    try:
        idx.remove_block(args)
    except ValueError as exc:
        return ("refused", str(exc))
    return ("removed", idx.contains_block(args))


def _ops(seed, bs, steps=500):
    rng = random.Random(seed)
    next_block, inserted, out = 1, [], []
    for _ in range(steps):
        r = rng.random()
        toks = [rng.randrange(0, 6) for _ in range(rng.randrange(0, 8 * bs))]
        if rng.random() < 0.5:
            toks = np.asarray(toks, np.int32)
        if r < 0.4:
            out.append(("match", toks))
        elif r < 0.75:
            n_full = len(toks) // bs
            blocks = list(range(next_block, next_block + n_full + rng.randrange(0, 2)))
            next_block += len(blocks)
            inserted.extend(blocks)
            out.append(("insert", (toks, blocks)))
        elif inserted:
            bid = rng.choice(inserted + [10 ** 6])
            out.append(("probe" if r < 0.85 else "remove", bid))
    return out


@needs_cxx
@pytest.mark.parametrize("seed,bs", [(7, 4), (11, 16), (13, 1)])
def test_fuzzed_sequences_match_both_jax_indexes(seed, bs):
    indexes = [NativeRadixPrefixIndex(bs), jkv.RadixPrefixIndex(bs), JNativeIndex(bs),
               tkv.RadixPrefixIndex(bs)]
    refusals = 0
    for step, (op, args) in enumerate(_ops(seed, bs)):
        got = [_apply(idx, op, args) for idx in indexes]
        assert all(g == got[0] for g in got), (step, op, got)
        refusals += op == "remove" and got[0][0] == "refused"
        assert len({len(idx) for idx in indexes}) == 1, step
    assert refusals > 0           # the interior-eviction refusal was met


@needs_cxx
def test_the_block_manager_holds_the_native_index_and_matches_jax():
    mgr = tkv.PagedKVCacheManager(32, block_size=4)
    jmgr = jkv.PagedKVCacheManager(32, block_size=4)
    assert isinstance(mgr.radix, NativeRadixPrefixIndex)
    prompts = [list(range(10)), list(range(10)) + [50, 51, 52, 53], list(range(6)),
               [9, 9, 9, 9, 1, 2]]
    for i, p in enumerate(prompts * 2):
        got = mgr.allocate_sequence(f"s{i}", p)
        want = jmgr.allocate_sequence(f"s{i}", p)
        assert got == want, (i, got, want)
        mgr.free_sequence(f"s{i}", cache=True)
        jmgr.free_sequence(f"s{i}", cache=True)
        assert len(mgr.radix) == len(jmgr.radix)
    assert mgr.get_stats()["prefix_hit_tokens"] == jmgr.get_stats()["prefix_hit_tokens"] > 0


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(get_model_config(MODEL), jax.random.PRNGKey(5), jnp.float32)
    return jp, jax.tree.map(np.asarray, jp)


def _req(ds, prompt, n=6):
    return ds.InferenceRequest(prompt_token_ids=list(prompt),
                               sampling=ds.SamplingParams(max_new_tokens=n, temperature=0.0))


@needs_cxx
def test_prefix_hit_streams_are_unchanged(weights, monkeypatch):
    geom = dict(max_batch_size=2, max_seq_len=128, prefill_buckets=(16, 32, 64),
                dtype="float32", enable_prefix_cache=True)
    base = [int(t) for t in np.random.default_rng(9).integers(1, 500, 40)]
    prompts = [base, base[:32] + [7, 8, 9, 10, 11], base + [3] * 20]

    def run(eng, ds):
        return [list(eng.generate([_req(ds, p)])[0].token_ids) for p in prompts]

    eng = tengine.TorchEngine(MODEL, tengine.EngineConfig(**geom),
                              params=params_from_numpy(weights[1], "cpu"), device="cpu")
    assert isinstance(eng.manager.radix, NativeRadixPrefixIndex)
    got = run(eng, tds)
    assert eng.manager.get_stats()["prefix_hit_tokens"] >= 64
    monkeypatch.setattr(tkv, "make_radix_index", tkv.RadixPrefixIndex)
    py = tengine.TorchEngine(MODEL, tengine.EngineConfig(**geom),
                             params=params_from_numpy(weights[1], "cpu"), device="cpu")
    assert type(py.manager.radix) is tkv.RadixPrefixIndex
    assert run(py, tds) == got
    assert py.manager.get_stats()["prefix_hit_tokens"] == \
        eng.manager.get_stats()["prefix_hit_tokens"]
    jeng = jengine.TPUEngine(MODEL, jengine.EngineConfig(**geom), params=weights[0])
    assert run(jeng, jds) == got


@needs_cxx
def test_concurrent_builds_never_leave_a_half_written_library(tmp_path):
    out = tmp_path / "lib.so"
    oks = []
    threads = [threading.Thread(target=lambda: oks.append(tnative._compile(tnative.SRC, out)))
               for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert oks == [True] * 3
    assert [p.name for p in tmp_path.iterdir()] == ["lib.so"]     # no temporary left
    assert ctypes.CDLL(str(out)).radix_size is not None


def test_without_a_compiler_the_python_index_is_taken_with_a_warning(
        tmp_path, monkeypatch, caplog):
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_lib_tried", False)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with caplog.at_level(logging.WARNING, logger="torch_native"):
        idx = tkv.make_radix_index(16)
    assert type(idx) is tkv.RadixPrefixIndex
    assert any("native build unavailable" in r.getMessage() for r in caplog.records)
    assert any("using the Python fallback" in r.getMessage() for r in caplog.records)
