"""The port's worker config (``utils/config.py``, dataclasses on the
standard library) against the JAX package's pydantic loader: the same
files and environment give the same values — defaults, precedence, type
coercion of env strings, unknown keys dropped (an engine never sees
``kv_cache_dtype``), ``working_hours`` — the same values are rejected, a
file either package wrote loads in the other, and both CLIs' ``set`` /
``show`` / ``status --local`` agree. The sample sections come from
``docs/worker-guide.md``."""

import json
import pathlib
import re

import pytest
import yaml
from pydantic import ValidationError

from distributed_gpu_inference_torch.utils import config as tc
from distributed_gpu_inference_torch.worker import cli as tcli
from distributed_gpu_inference_tpu.utils import config as jc
from distributed_gpu_inference_tpu.worker import cli as jcli

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _both(path=None, env=None):
    """(port, JAX) configs of one file and environment, as plain data."""
    t = tc.load_worker_config(path, environ=env or {})
    j = jc.load_worker_config(path, environ=env or {})
    return tc.config_dict(t), j.model_dump(mode="json")


def _guide_sample():
    """The YAML sections of docs/worker-guide.md that configure one worker
    (load control, direct mode, the llm engine), merged."""
    text = (ROOT / "docs/worker-guide.md").read_text()
    blocks = [yaml.safe_load(b) for b in re.findall(r"```yaml\n(.*?)```", text, re.S)]
    merged = {}
    for b in blocks:
        if set(b) & {"load_control", "direct", "engines"}:
            merged.update(b)
    assert {"load_control", "direct", "engines"} <= set(merged)
    return merged


ENV_CASES = {
    "defaults": {},
    "scalars": {"TPU_WORKER_SERVER__URL": "http://env:1234",
                "TPU_WORKER_POLL_INTERVAL_S": "0.5",
                "TPU_WORKER_HEARTBEAT_INTERVAL_S": "3",
                "TPU_WORKER_CONFIG_VERSION": "4.0"},
    "bools": {"TPU_WORKER_DIRECT__ENABLED": "yes",
              "TPU_WORKER_SERVER__VERIFY_TLS": "0"},
    "bools-upper": {"TPU_WORKER_DIRECT__ENABLED": "TRUE",
                    "TPU_WORKER_SERVER__VERIFY_TLS": "Off"},
    "composites": {"TPU_WORKER_TASK_TYPES": '["llm", "embedding"]',
                   "TPU_WORKER_LOAD_CONTROL__WORKING_HOURS": "[22, 6]",
                   "TPU_WORKER_LOAD_CONTROL__JOB_TYPE_WEIGHTS": '{"llm": "0.5"}',
                   "TPU_WORKER_SERVER__FALLBACK_URLS": '["http://b:1", "http://c:2"]'},
    "numeric-strings-stay-strings": {"TPU_WORKER_SERVER__API_KEY": "123456",
                                     "TPU_WORKER_NAME": "007"},
    "engines-unknown-keys-dropped": {
        "TPU_WORKER_ENGINES": json.dumps({"llm": {
            "model": "llama3-8b", "quantization": "int8", "kv_cache_dtype": "int8",
            "serving": {"target_step_ms": "50", "ragged": "false", "bogus": 1},
            "extra": {"tp_size": 1}}}),
        "TPU_WORKER_NOT_A_FIELD": "x"},
}


@pytest.mark.parametrize("case", sorted(ENV_CASES))
def test_env_through_both_loaders_gives_the_same_values(case):
    port, jax_ = _both(env=ENV_CASES[case])
    assert port == jax_


def test_unknown_engine_keys_never_reach_the_engine():
    env = ENV_CASES["engines-unknown-keys-dropped"]
    cfg = tc.load_worker_config(environ=env)
    llm = tc.config_dict(cfg.engine_for("llm"))
    assert "kv_cache_dtype" not in llm and "bogus" not in llm["serving"]
    assert llm["serving"]["target_step_ms"] == 50.0 and llm["serving"]["ragged"] is False
    assert cfg.load_control.working_hours is None


@pytest.mark.parametrize("fmt", ["yaml", "json"])
def test_files_through_both_loaders_give_the_same_values(tmp_path, fmt):
    data = _guide_sample()
    data.update({"region": "eu-west", "server": {"url": "http://cp:9000"},
                 "poll_interval_s": 5, "unknown_top_level": {"a": 1}})
    p = tmp_path / f"config.{fmt}"
    p.write_text(yaml.safe_dump(data) if fmt == "yaml" else json.dumps(data))
    port, jax_ = _both(p)
    assert port == jax_
    assert port["load_control"]["working_hours"] == [9, 17]
    assert port["engines"]["llm"]["extra"] == {"tp_size": 4}
    # env still wins over the file
    port, jax_ = _both(p, {"TPU_WORKER_REGION": "ap-east",
                           "TPU_WORKER_LOAD_CONTROL__MAX_CONCURRENT_JOBS": "8"})
    assert port == jax_ and port["region"] == "ap-east"
    assert port["load_control"]["max_concurrent_jobs"] == 8


def test_a_file_either_package_saved_loads_the_same_in_the_other(tmp_path):
    cfg = tc.load_worker_config(environ=ENV_CASES["composites"])
    cfg.server.auth_token = "tok123"
    tc.save_worker_config(cfg, tmp_path / "port.json")
    jcfg = jc.load_worker_config(environ=ENV_CASES["composites"])
    jcfg.server.auth_token = "tok123"
    jc.save_worker_config(jcfg, tmp_path / "jax.yaml")
    for p in (tmp_path / "port.json", tmp_path / "jax.yaml"):
        port, jax_ = _both(p)
        assert port == jax_ == tc.config_dict(cfg)
    # what the port writes is JSON
    assert json.loads((tmp_path / "port.json").read_text())["server"]["auth_token"] == "tok123"


@pytest.mark.parametrize("env", [
    {"TPU_WORKER_LOAD_CONTROL__ACCEPTANCE_RATE": "abc"},
    {"TPU_WORKER_DIRECT__ENABLED": "maybe"},
    {"TPU_WORKER_DIRECT__PORT": "80.5"},
    {"TPU_WORKER_LOAD_CONTROL__WORKING_HOURS": "[1, 2, 3]"},
    {"TPU_WORKER_TASK_TYPES": "llm"},
])
def test_both_loaders_reject_the_same_values(env):
    with pytest.raises(ValidationError):
        jc.load_worker_config(environ=env)
    with pytest.raises(tc.ConfigError):
        tc.load_worker_config(environ=env)


def test_defaults_and_engine_table_match():
    assert tc.config_dict(tc.WorkerConfig()) == jc.WorkerConfig().model_dump(mode="json")
    assert {k: tc.config_dict(v) for k, v in tc.DEFAULT_ENGINE_CONFIGS.items()} == {
        k: v.model_dump(mode="json") for k, v in jc.DEFAULT_ENGINE_CONFIGS.items()}
    e = tc.WorkerConfig().engine_for("llm")
    e.model = "mutated"                           # a copy, not the shared default
    assert tc.DEFAULT_ENGINE_CONFIGS["llm"].model == "llama3-8b"
    with pytest.raises(KeyError):
        tc.WorkerConfig().engine_for("nope")


def test_set_dotted_matches():
    t = tc.set_dotted(tc.WorkerConfig(), "load_control.working_hours", [9, 17])
    j = jc.set_dotted(jc.WorkerConfig(), "load_control.working_hours", [9, 17])
    assert tc.config_dict(t) == j.model_dump(mode="json")
    for mod in (tc, jc):
        with pytest.raises(KeyError):
            mod.set_dotted(mod.WorkerConfig(), "server.nope", 1)


def test_dotenv_is_folded_in_only_when_reading_the_environment(tmp_path, monkeypatch):
    monkeypatch.delenv("TPU_WORKER_REGION", raising=False)
    p = tmp_path / ".env"
    p.write_text("# comment\nTPU_WORKER_REGION=ap-east\nBAD LINE\n")
    assert tc.load_worker_config(environ={}, dotenv_path=p).region == "us-central"
    cfg = tc.load_worker_config(dotenv_path=p)
    assert cfg.region == "ap-east"
    monkeypatch.delenv("TPU_WORKER_REGION", raising=False)


def test_missing_file_raises_unless_missing_ok():
    with pytest.raises(FileNotFoundError):
        tc.load_worker_config("/nonexistent/config.json", environ={})
    assert tc.load_worker_config("/nonexistent/config.json", environ={},
                                 missing_ok=True).name == "tpu-worker"


def test_deprecated_serving_keys_warn_once(caplog):
    tc._deprecated_serving_warned.clear()
    with caplog.at_level("WARNING"):
        tc.build(tc.ServingConfig, {"subwave": 2, "max_horizon": 16})
        tc.build(tc.ServingConfig, {"subwave": 3})
    assert caplog.text.count("serving.subwave") == 1
    assert caplog.text.count("serving.max_horizon") == 1


# -- both CLIs ------------------------------------------------------------------------


def _run(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("key,value", [
    ("load_control.acceptance_rate", "0.25"),
    ("server.url", "http://x:9"),
    ("load_control.working_hours", "[9, 17]"),
    ("direct.enabled", "true"),
])
def test_set_and_show_through_both_clis_agree(tmp_path, capsys, key, value):
    shown = []
    for main, name in ((tcli.main, "port.json"), (jcli.main, "jax.yaml")):
        p = str(tmp_path / name)
        assert _run(main, ["--config", p, "set", key, value], capsys)[0] == 0
        assert _run(main, ["--config", p, "set", "server.auth_token", "sekrit"], capsys)[0] == 0
        rc, out, _ = _run(main, ["--config", p, "show"], capsys)
        assert rc == 0 and "sekrit" not in out
        shown.append(json.loads(out))
    assert shown[0] == shown[1]
    assert shown[0]["server"]["auth_token"] == "***"


@pytest.mark.parametrize("key,value,error", [
    ("server.uri", "http://x", "unknown config key"),
    ("load_control.acceptance_rate", '"abc"', "invalid value"),
])
def test_set_errors_through_both_clis_agree(tmp_path, capsys, key, value, error):
    for main, name in ((tcli.main, "port.json"), (jcli.main, "jax.yaml")):
        rc, _, err = _run(main, ["--config", str(tmp_path / name), "set", key, value], capsys)
        assert rc == 1 and error in err


def test_status_local_through_both_clis_agrees(tmp_path, capsys):
    outs = []
    for main, name in ((tcli.main, "port.json"), (jcli.main, "jax.yaml")):
        p = str(tmp_path / name)
        _run(main, ["--config", p, "set", "name", "w9"], capsys)
        rc, out, _ = _run(main, ["--config", p, "status", "--local"], capsys)
        assert rc == 0
        outs.append({k: v for k, v in json.loads(out).items() if k != "config"})
    assert outs[0] == outs[1]
    assert outs[0]["name"] == "w9" and outs[0]["registered"] is False
    assert "server_status" not in outs[0]


def test_status_reports_an_unreachable_server(tmp_path, capsys):
    p = str(tmp_path / "port.json")
    _run(tcli.main, ["--config", p, "set", "server.worker_id", "w-1"], capsys)
    _run(tcli.main, ["--config", p, "set", "server.url", "http://127.0.0.1:1"], capsys)
    rc, out, _ = _run(tcli.main, ["status", "--config", p], capsys)
    assert rc == 0 and "unreachable" in json.loads(out)["server_status"]


def test_status_reads_the_real_plane(tmp_path, capsys):
    from distributed_gpu_inference_tpu.testing.harness import LiveControlPlane
    from distributed_gpu_inference_torch.worker.api_client import APIClient

    with LiveControlPlane() as cp:
        api = APIClient(cp.url)
        api.register({"name": "w", "region": "eu-west"})
        p = str(tmp_path / "port.json")
        # "--" ends the options: the plane's auth token (token_urlsafe) starts
        # with "-" one time in 64, and argparse would read it as an option
        for key, value in (("server.url", cp.url), ("server.worker_id", api.worker_id),
                           ("server.auth_token", api.auth_token)):
            _run(tcli.main, ["--config", p, "set", key, "--", value], capsys)
        rc, out, _ = _run(tcli.main, ["--config", p, "status"], capsys)
    out = json.loads(out)
    assert rc == 0 and out["registered"] is True and out["server_status"] == "idle"
    assert "reliability_score" in out


def test_set_takes_a_value_that_starts_with_a_dash(tmp_path, capsys):
    p = str(tmp_path / "port.json")
    rc, _, _ = _run(tcli.main, ["--config", p, "set", "server.auth_token", "--", "-pq_x"],
                    capsys)
    assert rc == 0 and tc.load_worker_config(p, environ={}).server.auth_token == "-pq_x"


def test_setup_wizard_writes_a_config_the_jax_loader_reads(tmp_path, monkeypatch, capsys):
    p = tmp_path / "config.json"
    answers = iter([""] * 20)
    monkeypatch.setattr("builtins.input", lambda prompt="": next(answers, ""))
    assert tcli.main(["--config", str(p), "setup"]) == 0
    port, jax_ = _both(p)
    assert port == jax_ and port["task_types"] == ["llm"]


def test_wizard_custom_answers():
    it = iter(["edge-worker-7", "http://cp.example.com:8000", "eu-west", "llm",
               "y", "0,8", "0.8", "20", "5", "9-17", "y", "9001", "http://edge7:9001"])
    lines = []
    cfg = tcli.ConfigWizard(input_fn=lambda p: next(it, ""), print_fn=lines.append).run()
    assert (cfg.name, cfg.server.url, cfg.region) == (
        "edge-worker-7", "http://cp.example.com:8000", "eu-west")
    assert cfg.load_control.acceptance_rate == 0.8
    assert any("not a valid number" in line for line in lines)
    assert cfg.load_control.working_hours == (9, 17)
    assert cfg.direct.enabled and cfg.direct.port == 9001
    assert cfg.direct.public_url == "http://edge7:9001"
