"""distributed_gpu_inference_torch — the serving engine on PyTorch and CUDA.

A port of ``distributed_gpu_inference_tpu`` (the JAX package, kept beside
it as the reference) to one NVIDIA Hopper card. Module names mirror the
JAX package so each counterpart is easy to find:

- ``models/``   model registry, the Llama-class decoder over paged KV, and
                the numpy weight bridge (``models/convert.py``)
- ``ops/``      paged attention (plain PyTorch version + hand-written CUDA
                kernels in ``csrc/``, built with ``nvcc`` at first use),
                token sampling
- ``runtime/``  KV block manager, the slot engine (``TorchEngine``) and the
                continuous batcher
- ``worker/``   the worker's LLM engine API (``TorchLLMEngine``) and its direct
                HTTP server (``DirectServer``)
- ``utils/``    request/response dataclasses

Subpackages are imported lazily — ``import distributed_gpu_inference_torch``
does not pull in torch.
"""

__version__ = "0.1.0"

_SUBPACKAGES = (
    "utils",
    "models",
    "ops",
    "runtime",
    "worker",
)


def __getattr__(name):
    if name in _SUBPACKAGES:
        import importlib

        mod = importlib.import_module(f"{__name__}.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
