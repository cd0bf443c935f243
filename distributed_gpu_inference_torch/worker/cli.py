"""Worker CLI: setup wizard + start/status/set/show commands.

The port of ``distributed_gpu_inference_tpu/worker/cli.py`` on the
standard library: the config is the JAX worker's YAML file (``--config``,
default ``config.yaml``, read and written through ``utils/yaml_config.py``;
a ``.json`` path is read and written as JSON) and ``status`` makes its
server round trip on ``http.client``. ``start`` persists the credentials
the plane issues, so a restarted worker verifies them and keeps its worker
id.

    python -m distributed_gpu_inference_torch.worker.cli start --config worker.yaml

Every wizard prompt has a default, so ``yes "" | torch-worker setup``
writes a valid config.
"""

from __future__ import annotations

import argparse
import builtins
import http.client
import json
import sys
from pathlib import Path
from typing import Any, Callable, List, Optional
from urllib.parse import urlsplit

from distributed_gpu_inference_torch.utils.config import (
    ConfigError,
    WorkerConfig,
    config_dict,
    load_worker_config,
    save_worker_config,
    set_dotted,
)

DEFAULT_CONFIG_PATH = "config.yaml"
REGIONS = ("us-west", "us-east", "eu-west", "eu-central", "asia-east",
           "asia-southeast")
TASK_TYPES = ("llm",)
STATUS_TIMEOUT_S = 5.0


class ConfigWizard:
    """Interactive setup. ``input_fn``/``print_fn`` are injectable for
    tests."""

    def __init__(self, input_fn: Optional[Callable[[str], str]] = None,
                 print_fn: Callable[[str], None] = print) -> None:
        # resolve builtins.input lazily so monkeypatched inputs work
        self._input = input_fn or (lambda prompt: builtins.input(prompt))
        self._print = print_fn

    def _ask(self, prompt: str, default: str) -> str:
        try:
            raw = self._input(f"{prompt} [{default}]: ").strip()
        except (EOFError, StopIteration):
            raw = ""
        return raw or default

    def _ask_bool(self, prompt: str, default: bool) -> bool:
        raw = self._ask(prompt + " (y/n)", "y" if default else "n").lower()
        return raw in ("y", "yes", "true", "1")

    def _ask_number(self, prompt: str, default, cast):
        """Re-prompt on a bad number instead of discarding the answers so
        far."""
        for _ in range(3):
            raw = self._ask(prompt, str(default))
            try:
                return cast(raw)
            except ValueError:
                self._print(f"  not a valid number: {raw!r}")
        self._print(f"  using default {default}")
        return cast(str(default))

    def run(self, base: Optional[WorkerConfig] = None) -> WorkerConfig:
        from distributed_gpu_inference_torch.worker.main import probe_topology

        cfg = base or WorkerConfig()
        self._print("== PyTorch worker setup ==")
        try:
            topo = probe_topology()
            self._print(
                f"detected accelerator: {topo.chip_type} x{topo.num_chips} "
                f"({topo.hbm_gb_per_chip:.0f} GiB/card, "
                f"{topo.peak_bf16_tflops:.0f} bf16 TFLOP/s/card)"
            )
        except RuntimeError as exc:
            self._print(f"detected accelerator: none ({exc})")

        cfg.name = self._ask("worker name", cfg.name)
        cfg.server.url = self._ask("control-plane URL", cfg.server.url)
        cfg.region = self._ask(f"region {list(REGIONS)}", cfg.region)
        types = self._ask(
            f"task types (comma-sep of {list(TASK_TYPES)})",
            ",".join(cfg.task_types),
        )
        cfg.task_types = [t.strip() for t in types.split(",") if t.strip()]

        if self._ask_bool("configure load control", False):
            lc = cfg.load_control
            lc.acceptance_rate = self._ask_number(
                "acceptance rate 0..1", lc.acceptance_rate, float
            )
            lc.max_jobs_per_hour = self._ask_number(
                "max jobs/hour (0 = unlimited)", lc.max_jobs_per_hour, int
            )
            lc.cooldown_seconds = self._ask_number(
                "cooldown seconds between jobs", lc.cooldown_seconds, float
            )
            hours = self._ask("working hours start-end (e.g. 9-17, empty=all)",
                              "")
            if hours and "-" in hours:
                a, _, b = hours.partition("-")
                try:
                    lc.working_hours = (int(a), int(b))
                except ValueError:
                    self._print(f"  ignoring invalid hours: {hours!r}")

        if self._ask_bool("enable direct inference endpoint", False):
            cfg.direct.enabled = True
            cfg.direct.port = self._ask_number(
                "direct port", cfg.direct.port, int
            )
            cfg.direct.public_url = self._ask(
                "public URL clients reach this worker at",
                cfg.direct.public_url or f"http://localhost:{cfg.direct.port}",
            ) or None
        return cfg


# ---------------------------------------------------------------------------
# commands
# ---------------------------------------------------------------------------


def cmd_setup(args: argparse.Namespace) -> int:
    path = Path(args.config)
    base = load_worker_config(path) if path.exists() else None
    cfg = ConfigWizard().run(base)
    save_worker_config(cfg, path)
    print(f"wrote {path}")
    return 0


def cmd_start(args: argparse.Namespace,
              on_worker: Optional[Callable[[Any], None]] = None) -> int:
    """Run the worker until it drains. ``on_worker`` (for callers that run
    this in a thread) receives the Worker before it starts, so they can
    call ``request_shutdown``; signal handlers are then not installed."""
    import logging

    from distributed_gpu_inference_torch.worker.main import Worker

    logging.basicConfig(
        level=getattr(logging, args.log_level.upper(), logging.INFO),
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    cfg = load_worker_config(args.config, missing_ok=True)
    path = Path(args.config)

    def persist(creds):
        cfg.server.worker_id = creds["worker_id"]
        cfg.server.auth_token = creds["auth_token"]
        cfg.server.refresh_token = creds["refresh_token"]
        cfg.server.signing_secret = creds["signing_secret"]
        save_worker_config(cfg, path)

    worker = Worker(cfg, on_credentials=persist)
    if on_worker is not None:
        on_worker(worker)
    worker.start(install_signal_handlers=on_worker is None)
    return 0


def _server_status(cfg: WorkerConfig) -> dict:
    """GET /api/v1/workers/{id} on the plane: status, reliability score,
    last heartbeat."""
    url = urlsplit(cfg.server.url.rstrip("/"))
    cls = (http.client.HTTPSConnection if url.scheme == "https"
           else http.client.HTTPConnection)
    headers = {}
    if cfg.server.api_key:
        headers["X-API-Key"] = cfg.server.api_key
    if cfg.server.auth_token:
        headers["Authorization"] = f"Bearer {cfg.server.auth_token}"
    conn = cls(url.hostname, url.port, timeout=STATUS_TIMEOUT_S)
    try:
        conn.request("GET", f"{url.path}/api/v1/workers/{cfg.server.worker_id}",
                     headers=headers)
        resp = conn.getresponse()
        body = resp.read()
    finally:
        conn.close()
    if resp.status != 200:
        return {"server_status": f"HTTP {resp.status}"}
    remote = json.loads(body)
    return {"server_status": remote.get("status"),
            "reliability_score": remote.get("reliability_score"),
            "last_heartbeat": remote.get("last_heartbeat")}


def cmd_status(args: argparse.Namespace) -> int:
    cfg = load_worker_config(args.config, missing_ok=True)
    out = {
        "config": str(Path(args.config).resolve()),
        "name": cfg.name,
        "region": cfg.region,
        "task_types": cfg.task_types,
        "server_url": cfg.server.url,
        "registered": bool(cfg.server.worker_id),
        "worker_id": cfg.server.worker_id,
        "direct_enabled": cfg.direct.enabled,
    }
    if cfg.server.worker_id and not args.local:
        try:
            out.update(_server_status(cfg))
        except Exception as exc:  # noqa: BLE001 — status must never crash
            out["server_status"] = f"unreachable: {exc}"
    print(json.dumps(out, indent=2))
    return 0


def cmd_set(args: argparse.Namespace) -> int:
    cfg = load_worker_config(args.config, missing_ok=True)
    value: Any = args.value
    # parse JSON-ish scalars so `set load_control.acceptance_rate 0.5` works
    try:
        value = json.loads(args.value)
    except ValueError:
        pass
    try:
        cfg = set_dotted(cfg, args.key, value)
    except KeyError:
        print(f"error: unknown config key {args.key!r}", file=sys.stderr)
        return 1
    except ConfigError as exc:
        print(f"error: invalid value for {args.key!r}: {exc}",
              file=sys.stderr)
        return 1
    save_worker_config(cfg, args.config)
    print(f"{args.key} = {value!r}")
    return 0


def cmd_show(args: argparse.Namespace) -> int:
    cfg = load_worker_config(args.config, missing_ok=True)
    data = config_dict(cfg)
    for k in ("auth_token", "refresh_token", "signing_secret", "api_key"):
        if data.get("server", {}).get(k):
            data["server"][k] = "***"         # never print secrets
    print(json.dumps(data, indent=2))
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="torch-worker",
        description="inference worker on PyTorch/CUDA",
    )
    ap.add_argument("--config", default=DEFAULT_CONFIG_PATH)
    # --config is also taken after the command (`start --config w.json`)
    after = argparse.ArgumentParser(add_help=False)
    after.add_argument("--config", default=argparse.SUPPRESS)
    sub = ap.add_subparsers(dest="command", required=True)

    sub.add_parser("setup", parents=[after],
                   help="interactive configuration wizard")
    p_start = sub.add_parser("start", parents=[after], help="run the worker")
    p_start.add_argument("--log-level", default="INFO")
    p_status = sub.add_parser("status", parents=[after],
                              help="local + server-side status")
    p_status.add_argument("--local", action="store_true",
                          help="skip the server round trip")
    p_set = sub.add_parser("set", parents=[after],
                           help="dotted config update, e.g. "
                           "load_control.acceptance_rate 0.5")
    p_set.add_argument("key")
    p_set.add_argument("value", help="a value that starts with '-' follows '--'")
    sub.add_parser("show", parents=[after],
                   help="print config (secrets masked)")
    return ap


_COMMANDS = {
    "setup": cmd_setup,
    "start": cmd_start,
    "status": cmd_status,
    "set": cmd_set,
    "show": cmd_show,
}


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return _COMMANDS[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
