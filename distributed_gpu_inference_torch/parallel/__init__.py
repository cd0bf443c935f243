"""Parallelism of the PyTorch port: the host-side planning of layer-sharded
pipeline stages (``pipeline.py``). Tensor parallelism, ring and Ulysses
attention and the in-mesh pipeline of the JAX package's ``parallel/`` wait
for a ``torch.distributed`` slice (ROADMAP §1 item 7)."""

from distributed_gpu_inference_torch.parallel.pipeline import (  # noqa: F401
    create_shard_plan,
    device_bytes,
    slice_stage_params,
    uniform_stages,
)
