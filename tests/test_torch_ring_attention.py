"""Sequence parallelism in the PyTorch port against the JAX package, on the
CPU with gloo ranks (one spawned process a rank, ``runtime/tp.py``
``run_group``), seeded numpy inputs:

- ring and Ulysses attention (``parallel/ring_attention.py``), each rank
  with its slice of the sequence, against JAX
  ``ops.attention.dense_causal_attention`` of the whole sequence at seq 2
  and 4, with short ``lengths``: f32 within 1e-5, bf16 within 2e-2;
- the partial-softmax reads of block-sharded pools (paged decode and
  chunk, bf16 and int8 pools) against JAX ``paged_attention_xla`` on the
  unsharded pool, and the contiguous decode op against JAX's own
  ``seq_parallel_decode_attention`` on a 2-device CPU mesh;
- ``TPGroup``'s ring hop, all-to-all and all-gather against numpy, with
  their counts;
- the refusals by name: indivisible KV heads for Ulysses, an uneven pool,
  a mesh with both axes, and the engine's seq validation."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_gpu_inference_torch.models.configs import (  # noqa: E402
    get_model_config as tget,
)
from distributed_gpu_inference_torch.parallel import ring_attention as tra  # noqa: E402
from distributed_gpu_inference_torch.parallel.mesh import MeshPlan as TMeshPlan  # noqa: E402
from distributed_gpu_inference_torch.parallel.sharding import (  # noqa: E402
    block_range,
    seq_num_blocks,
    shard_kv_blocks,
)
from distributed_gpu_inference_torch.runtime import engine as tengine  # noqa: E402
from distributed_gpu_inference_torch.runtime import tp as tp_ranks  # noqa: E402
from distributed_gpu_inference_torch.runtime.speculative import SpecDecodeConfig  # noqa: E402
from distributed_gpu_inference_tpu.ops import attention as jattn  # noqa: E402
from distributed_gpu_inference_tpu.parallel import ring_attention as jra  # noqa: E402
from distributed_gpu_inference_tpu.parallel.mesh import MeshPlan, make_mesh  # noqa: E402

TOL = {"f32": 1e-5, "bf16": 2e-2}
BS = 16


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Each rank takes the parent's thread count: two threads a process
    keep a file's ranks from crowding the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _dt(name):
    return torch.bfloat16 if name == "bf16" else torch.float32


def _rounded(a, name):
    """``a`` (f32) rounded to the dtype ``name`` and back: both packages
    then read the same values."""
    return torch.tensor(a).to(_dt(name)).float().numpy()


# -- rank bodies (module level: the spawned ranks import them) -----------------


def _attend_rank(group, q, k, v, lengths, dtype):
    n, r = group.size, group.rank
    per = q.shape[1] // n
    rows = slice(r * per, (r + 1) * per)

    def t(a):
        return torch.tensor(a[:, rows]).to(_dt(dtype))

    lens = torch.tensor(lengths)
    out = {"ring": tra.ring_self_attention(t(q), t(k), t(v), lens, group).float().numpy()}
    if k.shape[2] % n == 0:
        out["ulysses"] = tra.ulysses_self_attention(t(q), t(k), t(v), lens,
                                                    group).float().numpy()
    out["stats"] = dict(group.stats)
    return out


def _paged_rank(group, q, pools, tables, positions, kv_lens, dtype):
    n, r = group.size, group.rank
    pool_dt = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[dtype]
    kv = {k: torch.tensor(v).to(torch.bfloat16 if k.endswith("_scale") else pool_dt)
          for k, v in pools.items()}
    local = shard_kv_blocks({k: v[None] for k, v in kv.items()}, r, n)
    local = {k: v[0] for k, v in local.items()}
    qt = torch.tensor(q).to(torch.bfloat16 if dtype != "f32" else torch.float32)
    tab, pos, lens = (torch.tensor(a) for a in (tables, positions, kv_lens))
    dec = tra.seq_parallel_paged_decode_attention(
        qt[:, -1:], local["k"], local["v"], tab, pos[:, -1:], lens, group, BS,
        k_scale=local.get("k_scale"), v_scale=local.get("v_scale"))
    chunk = tra.seq_parallel_paged_chunk_attention(
        qt, local["k"], local["v"], tab, pos, lens, group, BS, pages_per_step=3,
        k_scale=local.get("k_scale"), v_scale=local.get("v_scale"))
    return {"decode": dec.float().numpy(), "chunk": chunk.float().numpy()}


def _decode_rank(group, q, k, v, lengths):
    n, r = group.size, group.rank
    per = k.shape[1] // n
    rows = slice(r * per, (r + 1) * per)
    out = tra.seq_parallel_decode_attention(
        torch.tensor(q), torch.tensor(k[:, rows]), torch.tensor(v[:, rows]),
        torch.tensor(lengths), group)
    return out.numpy()


def _collectives_rank(group, x):
    r, n = group.rank, group.size
    mine = torch.tensor(x[r])
    return {"hop": group.ring_hop(mine).numpy(),
            "a2a": group.all_to_all(mine, split_dim=1, concat_dim=0).numpy(),
            "gather": group.all_gather(mine).numpy(),
            "stats": dict(group.stats)}


# -- ring and Ulysses ----------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_ring_and_ulysses_equal_dense_causal_attention(n):
    rng = np.random.default_rng(n)
    b, s, nh, hkv, d = 2, 8 * n, 8, 4, 16
    q = rng.standard_normal((b, s, nh, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    lengths = np.array([s, s - 5], np.int32)    # a short row: padded tail
    dense = jax.jit(jattn.dense_causal_attention)
    for dtype in ("f32", "bf16"):
        qr, kr, vr = (_rounded(a, dtype) for a in (q, k, v))
        outs = tp_ranks.run_group(_attend_rank, ["cpu"] * n, qr, kr, vr, lengths, dtype,
                                  timeout_s=60.0)
        jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
        want = np.asarray(dense(*(jnp.asarray(a, jdt) for a in (qr, kr, vr)),
                                jnp.asarray(lengths)).astype(jnp.float32))
        for impl in ("ring", "ulysses"):
            got = np.concatenate([o[impl] for o in outs], axis=1)
            for row, length in enumerate(lengths):     # padded queries are unread
                np.testing.assert_allclose(got[row, :length], want[row, :length],
                                           atol=TOL[dtype], rtol=TOL[dtype],
                                           err_msg=f"{impl} at seq {n}, {dtype}")
        for o in outs:
            assert o["stats"]["ring_hop"] == n - 1
            assert o["stats"]["all_to_all"] == 4


# -- partial-softmax reads of block-sharded pools --------------------------------


def _paged_inputs(rng, dtype):
    n_blocks, hkv, d, nh = 8, 2, 16, 4
    kv_lens = np.array([60, 20], np.int32)
    # global ids spread over both ranks' halves of the pool
    tables = np.array([[5, 1, 6, 2], [3, 7, 0, 0]], np.int32)
    s = 5
    positions = (kv_lens[:, None] - s + np.arange(s)[None, :]).astype(np.int32)
    q = _rounded(rng.standard_normal((2, s, nh, d)).astype(np.float32),
                 "f32" if dtype == "f32" else "bf16")
    if dtype == "int8":
        pools = {name: rng.integers(-127, 128, (n_blocks, hkv, BS, d)).astype(np.int8)
                 for name in ("k", "v")}
        for name in ("k_scale", "v_scale"):
            pools[name] = _rounded(rng.uniform(0.005, 0.03, (n_blocks, BS)).astype(np.float32),
                                   "bf16")
    else:
        pools = {name: _rounded(rng.standard_normal((n_blocks, hkv, BS, d)).astype(np.float32),
                                dtype) for name in ("k", "v")}
    return q, pools, tables, positions, kv_lens


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_sharded_pool_reads_equal_paged_attention_xla(dtype):
    q, pools, tables, positions, kv_lens = _paged_inputs(np.random.default_rng(3), dtype)
    outs = tp_ranks.run_group(_paged_rank, ["cpu", "cpu"], q, pools, tables, positions,
                              kv_lens, dtype, timeout_s=60.0)
    ref = jax.jit(jattn.paged_attention_xla, static_argnames=("block_size",))
    qdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    pdt = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}[dtype]
    scales = {}
    if dtype == "int8":      # the JAX layout repeats a token's scale over D
        scales = {f"{n}_scale": jnp.asarray(np.repeat(pools[f"{n}_scale"][..., None], 16, -1),
                                            jnp.bfloat16) for n in ("k", "v")}
    args = (jnp.asarray(pools["k"], pdt), jnp.asarray(pools["v"], pdt),
            jnp.asarray(tables))
    want_chunk = ref(jnp.asarray(q, qdt), *args, jnp.asarray(positions), jnp.asarray(kv_lens),
                     block_size=BS, **scales)
    want_dec = ref(jnp.asarray(q[:, -1:], qdt), *args, jnp.asarray(positions[:, -1:]),
                   jnp.asarray(kv_lens), block_size=BS, **scales)
    tol = 1e-5 if dtype == "f32" else 2e-2
    for o in outs:     # every rank returns the merged result
        np.testing.assert_allclose(o["chunk"], np.asarray(want_chunk, np.float32),
                                   atol=tol, rtol=tol)
        np.testing.assert_allclose(o["decode"], np.asarray(want_dec, np.float32),
                                   atol=tol, rtol=tol)


def test_contiguous_decode_equals_the_jax_shard_map_op():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    lengths = np.array([32, 9], np.int32)
    outs = tp_ranks.run_group(_decode_rank, ["cpu", "cpu"], q, k, v, lengths,
                              timeout_s=60.0)
    mesh = make_mesh(MeshPlan(seq=2), jax.devices()[:2], keep_trivial_axes=False)
    want = jax.jit(lambda *a: jra.seq_parallel_decode_attention(*a, mesh))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths))
    for got in outs:
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)


def test_one_rank_ops_take_no_group():
    """With ``group=None`` (an axis of one) the ops are the plain reads."""
    q, pools, tables, positions, kv_lens = _paged_inputs(np.random.default_rng(5), "f32")
    kv = {k: torch.tensor(v) for k, v in pools.items()}
    got = tra.seq_parallel_paged_chunk_attention(
        torch.tensor(q), kv["k"], kv["v"], torch.tensor(tables), torch.tensor(positions),
        torch.tensor(kv_lens), None, BS)
    from distributed_gpu_inference_torch.ops.attention import paged_attention_ref
    want = paged_attention_ref(torch.tensor(q), kv["k"], kv["v"], torch.tensor(tables),
                               torch.tensor(positions), torch.tensor(kv_lens), BS)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


# -- the group's collectives ------------------------------------------------------


@pytest.mark.parametrize("n", [2, 3])
def test_group_collectives_equal_numpy(n):
    x = np.random.default_rng(n).standard_normal((n, 2, 3 * n)).astype(np.float32)
    outs = tp_ranks.run_group(_collectives_rank, ["cpu"] * n, x, timeout_s=60.0)
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["hop"], x[(r - 1) % n])
        np.testing.assert_array_equal(o["gather"], x)
        parts = [np.split(x[j], n, axis=1)[r] for j in range(n)]
        np.testing.assert_array_equal(o["a2a"], np.concatenate(parts, axis=0))
        assert (o["stats"]["ring_hop"], o["stats"]["all_to_all"],
                o["stats"]["all_gather"]) == (1, 1, 1)


# -- refusals ---------------------------------------------------------------------


class _Axis:
    def __init__(self, rank, size):
        self.rank, self.size = rank, size


def test_refusals_by_name():
    q = torch.zeros((1, 4, 6, 8))
    kv = torch.zeros((1, 4, 3, 8))
    with pytest.raises(ValueError, match="ulysses needs num_kv_heads 3 divisible by the "
                                         "seq axis 2"):
        tra.ulysses_self_attention(q, kv, kv, torch.tensor([4]), _Axis(0, 2))
    with pytest.raises(ValueError, match="pool blocks 9 not divisible by seq axis 2"):
        block_range(9, 0, 2)
    with pytest.raises(ValueError, match="pool blocks 9 not divisible by seq axis 2"):
        shard_kv_blocks({"k": torch.zeros((1, 9, 1, 16, 8))}, 0, 2)
    assert seq_num_blocks(9, 2) == 10 and block_range(10, 1, 2) == (5, 10)
    # a seq x model plan is an engine's 2-D plan (tests/test_torch_mesh_2d.py)
    assert TMeshPlan(seq=2, model=2).engine_axis() == (2, 2)
    with pytest.raises(ValueError, match="no data or stage axis"):
        TMeshPlan(data=2).engine_axis()
    assert TMeshPlan(seq=2).engine_axis() == (2, 1)
    geom = dict(max_batch_size=2, max_seq_len=96, block_size=16, prefill_buckets=(16, 32),
                dtype="float32")
    with pytest.raises(ValueError, match="kv_seq_sharded needs a mesh with a seq axis > 1"):
        tengine.TorchEngine("llama3-tiny", tengine.EngineConfig(**geom, kv_seq_sharded=True),
                            device="cpu")
    with pytest.raises(ValueError, match="sliding-window"):
        tengine.TorchEngine("mistral-tiny", tengine.EngineConfig(**geom, kv_seq_sharded=True),
                            rank_devices=["cpu"] * 2, mesh=TMeshPlan(seq=2))
    with pytest.raises(ValueError, match="speculative"):
        tengine.TorchEngine("llama3-tiny", tengine.EngineConfig(
            **geom, speculative=SpecDecodeConfig(num_draft_tokens=2)),
            rank_devices=["cpu"] * 2, mesh=TMeshPlan(seq=2))
    with pytest.raises(ValueError, match="speculative \\+ kv_seq_sharded is fenced"):
        tengine.TorchEngine("llama3-tiny", tengine.EngineConfig(
            **geom, kv_seq_sharded=True, speculative=SpecDecodeConfig(num_draft_tokens=2)),
            rank_devices=["cpu"] * 2, mesh=TMeshPlan(seq=2))
    tiny = tget("llama3-tiny")      # 2 KV heads
    with pytest.raises(ValueError, match="ulysses needs num_kv_heads 2 divisible by the "
                                         "seq axis 4"):
        tengine.TorchEngine(tiny, tengine.EngineConfig(**geom, seq_parallel_impl="ulysses"),
                            rank_devices=["cpu"] * 4, mesh=TMeshPlan(seq=4))
    with pytest.raises(ValueError, match="seq axis of 2 needs 2 rank devices"):
        tengine.TorchEngine(tiny, tengine.EngineConfig(**geom), rank_devices=["cpu"] * 3,
                            mesh=TMeshPlan(seq=2))
