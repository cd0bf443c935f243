"""Data plane of the PyTorch port, on the standard library: the KV handoff
and migration routes and the pipeline stages' session routes
(``data_plane.py``), the binary tensor message (``wire.py``), the stage
worker that owns a range of layers (``stage_worker.py``), the client
session that walks a route of stages (``session.py``), and the gRPC plane
(``grpc_plane.py``: the proto3 codec of ``pb.py`` over gRPC's HTTP/2
protocol, ``h2.py`` and ``hpack.py``, interoperable with grpcio).

The names below load their module on first use, so a PD-only user of the
data plane does not load the stage worker and the model."""

_EXPORTS = {
    "pack_message": "wire",
    "unpack_message": "wire",
    "PipelineStageWorker": "stage_worker",
    "DistributedInferenceSession": "session",
    "PipelineHopError": "session",
    "SessionManager": "session",
    "WorkerSession": "session",
    "GrpcDataPlane": "grpc_plane",
    "GrpcStageClient": "grpc_plane",
    "ForwardStream": "grpc_plane",
    "RpcError": "grpc_plane",
    "StatusCode": "grpc_plane",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        value = getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
