"""Client SDK of the PyTorch port (the port's copy of
``distributed_gpu_inference_tpu/sdk``, on ``http.client``).

Parity surface: reference ``sdk/python/inference_client.py`` (C37).
"""

from .client import (
    InferenceClient,
    InferenceClientError,
    NoWorkersAvailable,
    chat,
    embed,
    generate_image,
)

__all__ = [
    "InferenceClient",
    "InferenceClientError",
    "NoWorkersAvailable",
    "chat",
    "embed",
    "generate_image",
]
