"""Control plane of the PyTorch port: REST API, store, schedulers, fleet
services.

The port's copy of ``distributed_gpu_inference_tpu/server``, on the standard
library and the port's own modules (no aiohttp: ``web.py`` is a small
asyncio HTTP/1.1 server with the surface the handlers use). The wire is the
JAX plane's — routes, status codes, JSON bodies, headers, HMAC signing,
``assignment_epoch`` fencing and the sqlite schema — so JAX workers and the
JAX SDK talk to this plane, and port workers and the port SDK to the JAX
one. The control plane never touches tensors: it moves JSON params and
results only.
"""
