"""Engine registry: per-task-type inference engines.

The port of ``distributed_gpu_inference_tpu/worker/engines/__init__.py``:
the same ``ALIASES``, ``register_engine`` / ``_OVERRIDES`` hook and
``create_engine``, and the same five task types: ``llm``
(``TorchLLMEngine``), ``embedding``, ``vision``, ``whisper`` and
``image_gen``, each imported on first use. Any other task type raises
``KeyError`` naming it, and ``Worker.load_engines`` drops that type as the
JAX worker drops a type whose engine cannot load.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, List, Optional

from .base import BaseEngine, EngineLoadError, GenerationConfig, GenerationResult

# task type → module path : class name (imported on first use)
ENGINE_REGISTRY: Dict[str, str] = {
    "llm": "distributed_gpu_inference_torch.worker.engines.llm:TorchLLMEngine",
    "embedding": "distributed_gpu_inference_torch.worker.engines.embedding:EmbeddingEngine",
    "image_gen": "distributed_gpu_inference_torch.worker.engines.image_gen:ImageGenEngine",
    "vision": "distributed_gpu_inference_torch.worker.engines.vision:VisionEngine",
    "whisper": "distributed_gpu_inference_torch.worker.engines.whisper:WhisperEngine",
}

ALIASES: Dict[str, str] = {
    "text": "llm",
    "chat": "llm",
    "text-generation": "llm",
    "embed": "embedding",
    "embeddings": "embedding",
    "image": "image_gen",
    "txt2img": "image_gen",
    "vlm": "vision",
    "image_qa": "vision",
    "asr": "whisper",
    "speech": "whisper",
}

_OVERRIDES: Dict[str, Callable[..., BaseEngine]] = {}


def resolve_task_type(task_type: str) -> str:
    t = task_type.lower().strip()
    return ALIASES.get(t, t)


def register_engine(task_type: str, factory: Callable[..., BaseEngine]) -> None:
    """Test/extension hook: override a task type with a custom factory."""
    _OVERRIDES[resolve_task_type(task_type)] = factory


def available_task_types() -> List[str]:
    return sorted(set(ENGINE_REGISTRY) | set(_OVERRIDES))


def get_engine_class(task_type: str) -> Callable[..., BaseEngine]:
    t = resolve_task_type(task_type)
    if t in _OVERRIDES:
        return _OVERRIDES[t]
    spec = ENGINE_REGISTRY.get(t)
    if spec is None:
        raise KeyError(
            f"no engine for task type {task_type!r} in the PyTorch port; "
            f"known: {available_task_types()}"
        )
    module_path, _, cls_name = spec.partition(":")
    return getattr(importlib.import_module(module_path), cls_name)


def create_engine(task_type: str, config: Optional[Dict[str, Any]] = None
                  ) -> BaseEngine:
    """Instantiate (not yet loaded) the engine for a task type."""
    return get_engine_class(task_type)(config or {})


__all__ = [
    "BaseEngine",
    "EngineLoadError",
    "GenerationConfig",
    "GenerationResult",
    "ENGINE_REGISTRY",
    "ALIASES",
    "available_task_types",
    "create_engine",
    "get_engine_class",
    "register_engine",
    "resolve_task_type",
]
