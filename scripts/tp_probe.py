"""Probe tensor parallelism with two ranks on one card: an NCCL group and
a gloo group given CUDA tensors, then llama3-8b (int8 weights, random from
seed 0) at tp 2 on cuda:0 against tp 1, with int8 and with bf16 pools:
load and generate times, the streams equal to tp 1's, each rank's launches
and collectives, a decode step's ms at batch 8, and (int8) whether the
ranks' scale pools agree. Run from the repo's root:

    python3 scripts/tp_probe.py          # on a machine with a card
    CPU=1 python3 scripts/tp_probe.py    # llama3-tiny on two CPU ranks
"""
import datetime, json, multiprocessing as mp, os, subprocess, sys, tempfile, time, traceback
import numpy as np
import torch
import torch.distributed as dist


def _nccl(rank, path, q):
    try:
        torch.cuda.set_device(0)
        store = dist.FileStore(path, 2)
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = datetime.timedelta(seconds=30)
        pg = dist.ProcessGroupNCCL(dist.PrefixStore("p", store), rank, 2, opts)
        t = torch.full((4,), float(rank + 1), device="cuda:0")
        pg.allreduce([t]).wait()
        torch.cuda.synchronize()
        q.put((rank, "ok", t.tolist()))
    except BaseException as e:
        q.put((rank, "error", f"{type(e).__name__}: {str(e)[:400]}"))


def _gloo_native(rank, path, q):
    try:
        store = dist.FileStore(path, 2)
        pg = dist.ProcessGroupGloo(dist.PrefixStore("g", store), rank, 2, datetime.timedelta(seconds=30))
        t = torch.full((4,), float(rank + 1), device="cuda:0", dtype=torch.bfloat16)
        pg.allreduce([t]).wait()
        torch.cuda.synchronize()
        b = torch.full((3,), float(rank), device="cuda:0")
        o = dist.BroadcastOptions(); o.rootRank = 0
        pg.broadcast([b], o).wait(); torch.cuda.synchronize()
        q.put((rank, "ok", t.float().tolist() + b.tolist()))
    except BaseException as e:
        q.put((rank, "error", f"{type(e).__name__}: {str(e)[:400]}"))


def probe(fn):
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    path = os.path.join(tempfile.mkdtemp(), "s")
    ps = [ctx.Process(target=fn, args=(r, path, q)) for r in range(2)]
    for p in ps: p.start()
    out = []
    try:
        for _ in ps: out.append(q.get(timeout=120))
    except Exception as e:
        out.append(("timeout", str(e)))
    for p in ps:
        p.join(30)
        if p.is_alive(): p.kill()
    return sorted(map(str, out))


CPU = os.environ.get("CPU") == "1"
MODEL = "llama3-tiny" if CPU else "llama3-8b"
DEV = "cpu" if CPU else "cuda:0"
if CPU:
    torch.cuda.synchronize = lambda *a: None
    torch.cuda.empty_cache = lambda *a: None
    torch.cuda.reset_peak_memory_stats = lambda *a: None
    torch.cuda.max_memory_allocated = lambda *a: 0


def main():
    CPU or print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    print("torch", torch.__version__, torch.version.cuda, flush=True)
    if not CPU:
        print("NCCL two ranks on cuda:0:", probe(_nccl), flush=True)
        print("gloo native CUDA tensors:", probe(_gloo_native), flush=True)
    sys.path.insert(0, ".")
    from distributed_gpu_inference_torch.ops import _build, paged_attention as pa
    from distributed_gpu_inference_torch.runtime.engine import TorchEngine, EngineConfig
    from distributed_gpu_inference_torch.utils.data_structures import InferenceRequest, SamplingParams
    if not CPU:
        print("build s", _build.build(), flush=True)
    rng = np.random.default_rng(0)
    lens = [64, 120, 200, 256, 333, 400, 512, 600]
    prompts = [list(map(int, rng.integers(1, 500 if CPU else 128000, n))) for n in lens]
    def reqs():
        return [InferenceRequest(prompt_token_ids=p, sampling=SamplingParams(max_new_tokens=32, temperature=0.0)) for p in prompts]
    for kv in ("int8", None):
        cfg = lambda: EngineConfig(max_batch_size=8, max_seq_len=1024, quantization="int8", kv_cache_dtype=kv, enable_prefix_cache=False)
        t0 = time.time()
        one = TorchEngine(MODEL, cfg(), seed=0, device=DEV)
        t1 = time.time()
        a = [r.token_ids for r in one.generate(reqs(), use_multi_step=True)]
        torch.cuda.synchronize(); t2 = time.time()
        del one; torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        two = TorchEngine(MODEL, cfg(), seed=0, rank_devices=[DEV, DEV])
        t3 = time.time()
        print(kv, "tp1 load", t1 - t0, "gen", t2 - t1, "tp2 load", t3 - t2, "rank0 peak GB", torch.cuda.max_memory_allocated() / 1e9, flush=True)
        two.reset_rank_launch_counts(); two.rank_collective_stats(reset=True)
        t3 = time.time()
        b = [r.token_ids for r in two.generate(reqs(), use_multi_step=True)]
        torch.cuda.synchronize(); t4 = time.time()
        same = sum(x == y for x, y in zip(a, b))
        first_diff = [next((i for i, (u, v) in enumerate(zip(x, y)) if u != v), None) for x, y in zip(a, b)]
        print(kv, "tp2 gen s", t4 - t3, "streams equal", same, "/8, first diffs", first_diff, flush=True)
        print("counts", two.rank_launch_counts(), flush=True)
        print("collectives", two.rank_collective_stats(), flush=True)
        # one decode step time
        two.rank_collective_stats(reset=True)
        r = [InferenceRequest(prompt_token_ids=p[:64], sampling=SamplingParams(max_new_tokens=40, temperature=0.0, ignore_eos=True)) for p in prompts]
        slots = two.submit_batch(r)
        torch.cuda.synchronize(); t5 = time.time()
        two.decode_multi(16); torch.cuda.synchronize(); t6 = time.time()
        print("decode 16 steps ms/step", (t6 - t5) * 1000 / 16, "collectives", two.rank_collective_stats(), flush=True)
        if kv == "int8":
            pools = two.rank_pools()
            print("scales rank0==rank1", all(np.array_equal(pools[0][k], pools[1][k]) for k in pools[0]), flush=True)
        two.shutdown()
        del two; torch.cuda.empty_cache()


if __name__ == "__main__":
    try:
        main()
    except Exception:
        traceback.print_exc(); sys.exit(1)
