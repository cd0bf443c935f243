"""Worker-side configuration on the standard library.

The port's counterpart of ``distributed_gpu_inference_tpu/utils/config.py``:
the same sections, field names, defaults and ``DEFAULT_ENGINE_CONFIGS``, as
dataclasses instead of pydantic models (the card's machine has no
pydantic). Precedence is the JAX loader's: defaults < file < env
(``TPU_WORKER_`` variables, ``__`` nests), with a ``.env`` file folded into
the environment when reading from it.

What pydantic did for the JAX package, :func:`build` does by hand, with
pydantic's lax rules:

- it coerces values to each field's type (env values arrive as strings):
  bool from ``true``/``yes``/``on``/``1``... and 0/1, int from integral
  floats and numeric strings, float from numbers and numeric strings,
  ``Optional``, lists, dicts and the ``working_hours`` pair; a ``str`` field
  takes only a string;
- it drops keys a section does not define (``EngineModelConfig`` has no
  ``kv_cache_dtype``, so a worker never passes one to its engine);
- it rejects a value it cannot coerce with :class:`ConfigError`, naming
  the dotted key.

The file format is JSON (a JSON file is also valid YAML, so the JAX loader
reads the same file). A ``.yaml``/``.yml`` file that is not JSON is read
through PyYAML when the Python running the worker has it; otherwise
reading it raises :class:`ConfigError` naming the missing package.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import logging
import os
import typing
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Set, Tuple

from distributed_gpu_inference_torch.runtime.io_guard import atomic_write_text
from distributed_gpu_inference_torch.utils.data_structures import KV_BLOCK_TOKENS

log = logging.getLogger(__name__)

ENV_PREFIX = "TPU_WORKER_"

# Serving knobs obsoleted by ragged serving rounds: still accepted (saved
# configs keep deploying) but warned once per process and key.
DEPRECATED_SERVING_KEYS: Dict[str, str] = {
    "subwave": (
        "the ragged serving path admits by appending chunk rows to the "
        "next decode round — there are no admission sub-waves to shape "
        "there; the legacy wave admission (serving.ragged: false, or "
        "serving.mode: direct) still splits its waves by it"
    ),
    "interleave": (
        "prefill chunks co-dispatch WITH decode rows in a ragged round — "
        "there are no separate dispatches left to interleave there; the "
        "legacy wave admission (serving.ragged: false, or serving.mode: "
        "direct) still runs this many decode steps between sub-waves"
    ),
    "max_horizon": (
        "still caps the pure-decode scan horizon, but it is no longer the "
        "TTFT-shaping knob: admission latency is bounded by the ragged "
        "round itself, not by capping decode-scan depth"
    ),
}
_deprecated_serving_warned: Set[str] = set()


def warn_deprecated_serving_key(key: str, source: str) -> None:
    """One-time (per process, per key) deprecation warning for obsoleted
    serving knobs."""
    if key not in DEPRECATED_SERVING_KEYS \
            or key in _deprecated_serving_warned:
        return
    _deprecated_serving_warned.add(key)
    log.warning(
        "serving.%s (%s) is deprecated since the ragged serving round: %s",
        key, source, DEPRECATED_SERVING_KEYS[key],
    )


class ConfigError(ValueError):
    """A config value that cannot be coerced to its field's type."""


@dataclass
class ServerConfig:
    """Control-plane endpoint + credentials."""

    url: str = "http://127.0.0.1:8000"
    fallback_urls: List[str] = field(default_factory=list)
    api_key: Optional[str] = None
    worker_id: Optional[str] = None
    auth_token: Optional[str] = None
    refresh_token: Optional[str] = None
    signing_secret: Optional[str] = None
    request_timeout_s: float = 30.0
    verify_tls: bool = True


@dataclass
class TpuConfig:
    """Accelerator section (named as in the JAX package, whose config file
    the port reads; the port serves on one CUDA device)."""

    chip_type: str = "auto"
    mesh_shape: Optional[List[int]] = None
    mesh_axis_names: List[str] = field(default_factory=lambda: ["data"])
    hbm_utilization: float = 0.9
    kv_cache_block_tokens: int = KV_BLOCK_TOKENS
    max_model_len: int = 8192
    dtype: str = "bfloat16"


@dataclass
class DirectConfig:
    """Worker-hosted direct inference endpoint."""

    enabled: bool = False
    host: str = "0.0.0.0"
    port: int = 8471
    public_url: Optional[str] = None


@dataclass
class LoadControlConfig:
    """Volunteer-friendly load shaping."""

    acceptance_rate: float = 1.0
    max_concurrent_jobs: int = 4
    max_jobs_per_hour: int = 0          # 0 = unlimited
    hbm_limit_fraction: float = 0.95
    working_hours: Optional[Tuple[int, int]] = None   # (start_h, end_h) local
    job_type_weights: Dict[str, float] = field(default_factory=dict)
    cooldown_seconds: float = 0.0


@dataclass
class ServingConfig:
    """Batcher-backed serving front end (``engines.<type>.serving.*``): the
    JAX package's keys and defaults. ``target_step_ms`` / ``queue_limit`` /
    ``max_wait_ms`` / ``ragged`` and the other keys of
    ``worker/engines/llm.py`` ``SERVING_REMOTE_KEYS`` retune a live batcher;
    ``abandon_deadlines`` / ``deadline_grace_s`` / ``predictive_abandon``
    turn on the batcher's deadline abandonment; the port refuses at load
    what it does not serve (``mode: direct``)."""

    mode: str = "batcher"
    target_step_ms: float = 100.0
    max_horizon: int = 64
    min_horizon: int = 1
    multi_step: int = 8
    adaptive: bool = True
    max_wait_ms: float = 5.0
    queue_limit: int = 1024
    default_timeout_s: float = 300.0
    max_preemptions: int = 3
    subwave: int = 0
    interleave: int = 0
    spec_max_batch: int = 2
    spec_max_active: int = 2
    ragged: Optional[bool] = None
    prefill_budget: int = 0
    ragged_chunk: Optional[int] = None
    abandon_deadlines: bool = False
    deadline_grace_s: float = 0.5
    predictive_abandon: bool = False


@dataclass
class EngineModelConfig:
    """Per-task-type engine/model selection."""

    engine: str = "jax"
    model: str = "llama3-tiny"
    dtype: str = "bfloat16"
    quantization: Optional[str] = None  # int8 | fp8 | None
    serving: Optional[ServingConfig] = None   # None → engine defaults
    extra: Dict[str, Any] = field(default_factory=dict)


DEFAULT_ENGINE_CONFIGS: Dict[str, EngineModelConfig] = {
    "llm": EngineModelConfig(engine="jax", model="llama3-8b"),
    "embedding": EngineModelConfig(engine="jax-embedding", model="llama3-8b"),
    "vision": EngineModelConfig(engine="jax-vision", model="llama3-8b-vision"),
    "image_gen": EngineModelConfig(engine="jax-diffusion", model="tiny-diffusion"),
    "whisper": EngineModelConfig(engine="jax-whisper", model="tiny-whisper"),
}


@dataclass
class WorkerConfig:
    """Root worker configuration."""

    name: str = "tpu-worker"
    region: str = "us-central"
    task_types: List[str] = field(default_factory=lambda: ["llm"])
    role: str = "hybrid"
    pd_data_plane_url: Optional[str] = None
    server: ServerConfig = field(default_factory=ServerConfig)
    tpu: TpuConfig = field(default_factory=TpuConfig)
    direct: DirectConfig = field(default_factory=DirectConfig)
    load_control: LoadControlConfig = field(default_factory=LoadControlConfig)
    engines: Dict[str, EngineModelConfig] = field(default_factory=dict)
    poll_interval_s: float = 2.0
    heartbeat_interval_s: float = 30.0
    log_level: str = "INFO"
    config_version: int = 0             # server-pushed remote config version

    def engine_for(self, task_type: str) -> EngineModelConfig:
        if task_type in self.engines:
            return self.engines[task_type]
        if task_type in DEFAULT_ENGINE_CONFIGS:
            # a copy: callers may mutate; the process-wide defaults must not
            return copy.deepcopy(DEFAULT_ENGINE_CONFIGS[task_type])
        raise KeyError(f"no engine config for task type {task_type!r}")


# ---------------------------------------------------------------------------
# validation: pydantic's lax coercion, by hand
# ---------------------------------------------------------------------------

_TRUE = {"1", "true", "yes", "on", "t", "y"}
_FALSE = {"0", "false", "no", "off", "f", "n"}


def _coerce(tp: Any, value: Any, where: str) -> Any:
    origin = typing.get_origin(tp)
    args = typing.get_args(tp)
    if origin is typing.Union:                      # Optional[X]
        if value is None:
            return None
        (inner,) = [a for a in args if a is not type(None)]
        return _coerce(inner, value, where)
    if dataclasses.is_dataclass(tp):
        if isinstance(value, tp):
            return value
        if not isinstance(value, dict):
            raise ConfigError(f"{where}: expected a mapping, got {value!r}")
        return build(tp, value, where)
    if tp is Any:
        return value
    if tp is str:
        if isinstance(value, str):
            return value
        raise ConfigError(f"{where}: expected a string, got {value!r}")
    if tp is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, (int, float)) and value in (0, 1):
            return bool(value)
        if isinstance(value, str) and value.lower() in _TRUE | _FALSE:
            return value.lower() in _TRUE
        raise ConfigError(f"{where}: expected a boolean, got {value!r}")
    if tp is int:
        if isinstance(value, (bool, int)):
            return int(value)
        if isinstance(value, float) and value.is_integer():
            return int(value)
        if isinstance(value, str):
            try:
                return int(value.strip())
            except ValueError:
                try:
                    f = float(value.strip())
                except ValueError:
                    f = None
                if f is not None and f.is_integer() and "e" not in value.lower():
                    return int(f)
        raise ConfigError(f"{where}: expected an integer, got {value!r}")
    if tp is float:
        if isinstance(value, (bool, int, float)):
            return float(value)
        if isinstance(value, str):
            try:
                return float(value.strip())
            except ValueError:
                pass
        raise ConfigError(f"{where}: expected a number, got {value!r}")
    if origin in (list, List):
        if not isinstance(value, (list, tuple)):
            raise ConfigError(f"{where}: expected a list, got {value!r}")
        return [_coerce(args[0], v, f"{where}[{i}]") for i, v in enumerate(value)]
    if origin in (tuple, Tuple):
        if not isinstance(value, (list, tuple)) or len(value) != len(args):
            raise ConfigError(
                f"{where}: expected {len(args)} values, got {value!r}")
        return tuple(_coerce(a, v, f"{where}[{i}]")
                     for i, (a, v) in enumerate(zip(args, value)))
    if origin in (dict, Dict):
        if not isinstance(value, dict):
            raise ConfigError(f"{where}: expected a mapping, got {value!r}")
        return {_coerce(args[0], k, where): _coerce(args[1], v, f"{where}.{k}")
                for k, v in value.items()}
    raise ConfigError(f"{where}: unsupported field type {tp!r}")


def build(cls: type, data: Dict[str, Any], where: str = "") -> Any:
    """A dataclass section from a mapping: known keys coerced to their
    field's type, unknown keys dropped, missing keys left at their
    defaults. Raises :class:`ConfigError` naming the dotted key."""
    hints = typing.get_type_hints(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name in data:
            kw[f.name] = _coerce(hints[f.name], data[f.name],
                                 f"{where}.{f.name}" if where else f.name)
    out = cls(**kw)
    if cls is ServingConfig:
        for key in set(data) & DEPRECATED_SERVING_KEYS.keys():
            warn_deprecated_serving_key(key, "worker config")
    return out


def config_dict(obj: Any) -> Any:
    """A config (or section) as plain JSON-ready data: tuples as lists, as
    the JAX package's ``model_dump(mode="json")`` gives them."""
    if dataclasses.is_dataclass(obj):
        return {f.name: config_dict(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: config_dict(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [config_dict(v) for v in obj]
    return obj


# ---------------------------------------------------------------------------
# loading: defaults < file < env
# ---------------------------------------------------------------------------


def load_dotenv(path: str | Path = ".env", override: bool = False) -> Dict[str, str]:
    """Minimal dotenv loader: KEY=VALUE lines, ``#`` comments."""
    loaded: Dict[str, str] = {}
    p = Path(path)
    if not p.exists():
        return loaded
    for line in p.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, val = line.partition("=")
        key, val = key.strip(), val.strip().strip("'\"")
        if override or key not in os.environ:
            os.environ[key] = val
        loaded[key] = val
    return loaded


def _deep_update(base: Dict[str, Any], upd: Dict[str, Any]) -> Dict[str, Any]:
    for k, v in upd.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_update(base[k], v)
        else:
            base[k] = v
    return base


def _yaml():
    """PyYAML, or ConfigError naming it when this Python lacks it."""
    try:
        import yaml
    except ImportError as exc:
        raise ConfigError(
            "reading a YAML config needs the PyYAML package, which this "
            "Python does not have; write the config as JSON (a JSON file is "
            "valid YAML, so both packages' workers read it)"
        ) from exc
    return yaml


def _parse_composite(raw: str) -> Any:
    """An env value that looks like a list or mapping: JSON, else YAML when
    PyYAML is there, else the string as it is (its field then rejects it)."""
    try:
        return json.loads(raw)
    except ValueError:
        pass
    try:
        return _yaml().safe_load(raw)
    except Exception:  # noqa: BLE001 — no PyYAML, or not YAML either
        return raw


def _env_overrides(environ: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    """TPU_WORKER_SERVER__URL=... → {"server": {"url": ...}} (``__`` nests).

    Values stay strings except list/mapping-looking composites; the field
    coercion of :func:`build` does the rest, so a numeric-looking API key or
    worker name stays a string."""
    environ = os.environ if environ is None else environ
    out: Dict[str, Any] = {}
    for key, raw in environ.items():
        if not key.startswith(ENV_PREFIX):
            continue
        path = key[len(ENV_PREFIX):].lower().split("__")
        val: Any = raw
        if raw.startswith(("[", "{")):
            val = _parse_composite(raw)
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = val
    return out


def _read_config_file(path: str | Path) -> Dict[str, Any]:
    """One config file's mapping: JSON, or YAML through PyYAML for a
    ``.yaml``/``.yml`` file that is not JSON."""
    p = Path(path)
    text = p.read_text()
    try:
        data = json.loads(text) if text.strip() else {}
    except ValueError:
        if p.suffix.lower() not in (".yaml", ".yml"):
            raise ConfigError(f"config file {path} is not valid JSON") from None
        data = _yaml().safe_load(text) or {}
    if not isinstance(data, dict):
        raise ConfigError(f"config file {path} must contain a mapping")
    return data


def load_worker_config(
    yaml_path: Optional[str | Path] = None,
    environ: Optional[Dict[str, str]] = None,
    dotenv_path: str | Path = ".env",
    missing_ok: bool = False,
) -> WorkerConfig:
    """Build a WorkerConfig with precedence env > file > defaults.

    A path that does not exist raises unless ``missing_ok=True``. ``.env``
    is only folded into the process environment when reading from it
    (``environ is None``)."""
    if environ is None:
        load_dotenv(dotenv_path)
    data: Dict[str, Any] = {}
    if yaml_path is not None:
        p = Path(yaml_path)
        if p.exists():
            _deep_update(data, _read_config_file(p))
        elif not missing_ok:
            raise FileNotFoundError(f"config file not found: {yaml_path}")
    _deep_update(data, _env_overrides(environ))
    return build(WorkerConfig, data)


def save_worker_config(cfg: WorkerConfig, path: str | Path) -> None:
    """Persist the config as JSON (the worker writes issued credentials
    back after registration), atomically: a crash mid-save must leave the
    previous file intact, never a truncated one that locks the worker out
    on restart."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    atomic_write_text(p, json.dumps(config_dict(cfg), indent=2) + "\n")


def set_dotted(cfg: WorkerConfig, dotted_key: str, value: Any) -> WorkerConfig:
    """``set server.url http://…`` style dotted update; the result is
    validated again (KeyError for an unknown key, ConfigError for a value
    its field rejects)."""
    data = config_dict(cfg)
    node = data
    parts = dotted_key.split(".")
    for p in parts[:-1]:
        if p not in node or not isinstance(node[p], dict):
            raise KeyError(f"unknown config section {p!r} in {dotted_key!r}")
        node = node[p]
    if parts[-1] not in node:
        raise KeyError(f"unknown config key {dotted_key!r}")
    node[parts[-1]] = value
    return build(WorkerConfig, data)
