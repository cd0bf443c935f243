"""The port's YAML (``utils/yaml_config.py``) against PyYAML 6 (CPU).

- ``safe_dump`` is byte-equal to ``yaml.safe_dump(data, sort_keys=False)``
  on hypothesis configs (None, bool, int, float, str, nested lists and
  dicts, keys long, empty or over lines) and on default and filled-in
  ``WorkerConfig`` dumps.
- ``safe_load`` equals ``yaml.safe_load`` on a corpus of hand-written
  documents, refuses what PyYAML refuses, and refuses anchors, aliases,
  tags, merge keys and directives by name and line; it reads back every
  hypothesis config either dumper wrote.
- A worker config written by either package loads equal in the other,
  with PyYAML blocked in the port: the JAX worker's ``config.yaml``
  (``tests/fixtures/config``) gives the port the ``WorkerConfig`` JAX
  builds from it, and the port's ``save_worker_config`` to a ``.yaml``
  path is byte-identical to JAX's.
"""

import copy
import json
import math
import pathlib
import sys

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from distributed_gpu_inference_torch.utils import config as tc
from distributed_gpu_inference_torch.utils import yaml_config as ty
from distributed_gpu_inference_torch.worker import cli as tcli

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures" / "config"
SETTINGS = settings(max_examples=120, deadline=None,
                    suppress_health_check=[HealthCheck.too_slow])


def _same(a, b) -> bool:
    """Equal, with NaN equal to NaN and -0.0 told from 0.0."""
    return repr(a) == repr(b)


scalars = (st.none() | st.booleans() | st.integers(-2**70, 2**70)
           | st.floats(allow_nan=True, allow_infinity=True) | st.text(max_size=130))
keys = st.text(max_size=20) | st.text(min_size=120, max_size=140) | st.sampled_from(
    ["yes", "123", "<<", "=", "~", "null", "a: b", "- x", "#c", "key with spaces", "x\ny"])
values = st.recursive(scalars, lambda inner: st.lists(inner, max_size=4)
                      | st.dictionaries(keys, inner, max_size=4), max_leaves=24)
configs = st.dictionaries(keys, values, max_size=8)


# -- the dumper -------------------------------------------------------------------------

@SETTINGS
@given(data=configs)
def test_safe_dump_is_pyyamls_byte_for_byte(data):
    text = ty.safe_dump(data)
    assert text == yaml.safe_dump(data, sort_keys=False)
    assert _same(ty.safe_load(text), data)


@SETTINGS
@given(data=values)
def test_any_value_dumps_and_loads_as_pyyaml_does(data):
    text = yaml.safe_dump(data, sort_keys=False)
    assert ty.safe_dump(data) == text
    assert _same(ty.safe_load(text), yaml.safe_load(text))


@pytest.mark.parametrize("value", [
    "", "yes", "No", "on", "0x1F", "0o17", "1e5", "1.0e+5", "1_000", "190:20:30", ".inf", ".NaN",
    "2001-12-14", "2001-12-14 21:59:43.10 -5", "~", "null", "<<", "=", " lead", "trail ",
    "a: b", "a #b", "- x", "? x", "it's", 'say "hi"', "line1\nline2", "a\n\nb\n", "\tx",
    "caf\u00e9 \u2603 \U0001F600", "\x00\x07\x1b\x7f\x85\xa0\u2028\ufeff", "x" * 200,
    " ".join(["word"] * 40), "it's " * 30, "\u00e9 " * 50, "---", "...", "-", "?", ":",
    1.0, -0.5, 1e17, 1e-5, 5e-324, 1e300, float("inf"), -float("inf"), float("nan"), -0.0,
    0, -1, 2**64, True, False, None, [], {}, [[]], {"": {}},
])
def test_scalars_and_corner_cases_dump_as_pyyaml(value):
    for data in (value, {"key": value}, [value],
                 {"k": [copy.deepcopy(value), {"n": copy.deepcopy(value)}]}):
        assert ty.safe_dump(data) == yaml.safe_dump(data, sort_keys=False)
        assert _same(ty.safe_load(ty.safe_dump(data)), yaml.safe_load(ty.safe_dump(data)))


def test_a_shared_list_is_refused_where_pyyaml_writes_an_anchor():
    shared = [1, 2]
    with pytest.raises(ValueError, match="anchor"):
        ty.safe_dump({"a": shared, "b": shared})
    with pytest.raises(TypeError):
        ty.safe_dump({"a": (1, 2)})


# -- the loader -------------------------------------------------------------------------

DOCS = [
    "", "# only a comment\n", "---\n", "--- \n...\n", "a: 1\n", "a: 1", "key:\n", "key: ~\n",
    "server:\n  url: http://localhost:8000\n  api_key: null\nregion: eu-west\n",
    "list:\n- a\n- b\n", "list:\n  - a\n  - b\n", "- a\n- b: 1\n  c: 2\n- - x\n  - y\n",
    "a: [1, 2, 3]\nb: {x: 1, y: [a, b]}\n", 'a: {"x":1, "y": "z"}\n', "a: [a, b, ]\n",
    "a: {a, b: 1}\n", "a: [\n  1,\n  2\n]\n", "m: {a: 1,\n  b: 2}  # c\n",
    "a: [x: 1, 'y': [2]]\n",
    "bools: [yes, No, ON, off, true, False, y, n]\n",
    "ints: [0, -0, 012, 0x1F, 0b101, 1_000, 190:20:30, +5, 0o17, 08, 0_]\n",
    "floats: [1.5, .5, -.inf, .NaN, 1.0e+5, 1e5, 1., 190:20:30.15, 6.8523015e+5, 1_000.5]\n",
    "nulls: [~, null, Null, NULL, '' ]\n",
    "ts: 2001-12-14\nt2: 2001-12-14t21:59:43.10-05:00\nt3: 2001-12-14 21:59:43.10\n"
    "t4: 2001-12-15T02:59:43.1Z\nt5: 2002-12-14\n",
    "s1: 'it''s'\ns2: \"tab\\there \\u00e9 \\x41 \\U0001F600 \\\\ \\\" \\/\"\n",
    "folded: >\n  one\n  two\n\n  three\n\n\nafter: x\n",
    "literal: |\n  line1\n   indented\n  line3\nnext: 1\n",
    "keep: |+\n  a\n\n\nstrip: |-\n  b\n\nclip: |\n  c\n\n",
    "ind: |2\n    two more\n  base\n", "fold2: >-\n  a\n   b\n  c\n",
    "plain: this is\n  a multi line\n\n  plain scalar\nx: 1\n",
    "q: 'multi\n  line\n\n  single'\ndq: \"multi\n  line \\\n  escaped\"\n",
    "# c\na: 1 # trailing\n# between\nb: 2\n\n\nc: 3\n",
    "url: http://a.b/c?d=e#frag\ncolon: a:b\nhash: a#b\n",
    "---\na: 1\n...\n", "--- |\n  text\n", "--- [1, 2]\n", "--- 5\n",
    "nested:\n  deeper:\n    deepest:\n    - 1\n    - [2, 3]\n    - {k: v}\n",
    "empty_list: []\nempty_map: {}\n",
    "key with spaces: value with spaces\n'quoted key': 1\n\"dq key\": 2\n",
    "a:\n  - b:\n      c: 1\n    d: 2\n", "seq_of_seq:\n- - a\n  - b\n- - c\n",
    "  indented: 1\n  root: 2\n", "a: 'x' # comment\nb: \"y\"#c\n", "unicode: caf\u00e9 \u2603\n",
    "? long key\n: value\n? 'multi\n\n  line'\n: 2\n? ''\n: 3\n", "? bare\nnext: 1\n",
    "a: [1, [2, [3, {b: c}]]]\n", "a: {b: {c: [d]}}\n", "k: v\n...\n",
    "long: aaaa bbbb\n  cccc\n", "a: x #c\n  y\n", "a:\r\n  b: 1\r\n",
    # what PyYAML refuses
    "x: -\n", "x: - a\n", "a:\n  b: 1\n c: 2\n", "a: b: c\n", "a: 'unclosed\n", "\ta: 1\n",
    "a:\t1\n", "? [a]\n: 1\n", "--- a\n--- b\n", "a: 1\n- b\n", "[a, b\n", "{a: 1\n",
    "a: |\n  x\n b: 1\n", "a: \"\\q\"\n", "a: =\n", "a: 1\n...\n---\nb: 2\n", "a: |0\n  x\n",
    "a: \"\\x4\"\n", "a: {b: }: c\n", "- a\nb: 1\n", "a: b\n  c: d\n", "a: \x01\n",
]


@pytest.mark.parametrize("doc", DOCS, ids=range(len(DOCS)))
def test_safe_load_gives_pyyamls_answer(doc):
    try:
        want = yaml.safe_load(doc)
    except yaml.YAMLError:
        with pytest.raises(ty.ConfigError, match=r"^YAML line \d+: "):
            ty.safe_load(doc)
        return
    assert _same(ty.safe_load(doc), want)


@pytest.mark.parametrize("doc,what,line", [
    ("a: &anc 1\nb: *anc\n", "an anchor", 1),
    ("a: 1\nb: *anc\n", "an alias", 2),
    ("a: !!str 1\n", "a tag", 1),
    ("x: 1\n<<: {a: 1}\n", "merge key", 2),
    ("%YAML 1.1\n---\na: 1\n", "a directive", 1),
    ("a:\n  b: [1, &x 2]\n", "an anchor", 2),
    ("a: 1\n---\nb: 2\n", "a second document", 2),
    ("? [a, b]\n: 1\n", "a complex key", 1),
])
def test_what_a_config_does_not_need_is_refused_by_name_and_line(doc, what, line):
    with pytest.raises(ty.ConfigError, match=rf"^YAML line {line}: .*{what}"):
        ty.safe_load(doc)


# -- worker configs across the packages, PyYAML blocked in the port ---------------------

@pytest.fixture
def no_pyyaml(monkeypatch):
    from distributed_gpu_inference_tpu.utils import config  # noqa: F401 — imports yaml first

    monkeypatch.setitem(sys.modules, "yaml", None)
    monkeypatch.setitem(sys.modules, "zstandard", None)


def test_the_jax_workers_config_yaml_loads_to_the_same_worker_config(no_pyyaml):
    from distributed_gpu_inference_tpu.utils import config as jc

    raw = (FIXTURES / "config.yaml").read_text()
    twin = json.loads((FIXTURES / "config.json").read_text())
    assert ty.safe_load(raw) == twin
    port = tc.load_worker_config(FIXTURES / "config.yaml", environ={})
    assert tc.config_dict(port) == twin
    assert tc.config_dict(tc.load_worker_config(FIXTURES / "config.json", environ={})) == twin
    jax_cfg = jc.load_worker_config(FIXTURES / "config.yaml", environ={})
    assert tc.config_dict(port) == jax_cfg.model_dump(mode="json")
    assert port.server.auth_token == "tok_-8Zx:q'Lm#2" and port.server.api_key == "0123"


ENVS = [
    {},
    {"TPU_WORKER_LOAD_CONTROL__WORKING_HOURS": "[9, 17]", "TPU_WORKER_REGION": "eu-west",
     "TPU_WORKER_NAME": "a long worker name that folds " * 4,
     "TPU_WORKER_ENGINES": '{"llm": {"model": "x", "extra": {"a": [1, 2], "b": "yes"}}}'},
    {"TPU_WORKER_TASK_TYPES": "[llm, embedding]", "TPU_WORKER_SERVER__FALLBACK_URLS":
     "['http://a:1', \"http://b:2\"]", "TPU_WORKER_DIRECT__ENABLED": "on"},
]


@pytest.mark.parametrize("env", ENVS, ids=range(len(ENVS)))
def test_a_config_either_package_writes_loads_equal_in_the_other(tmp_path, env, no_pyyaml):
    from distributed_gpu_inference_tpu.utils import config as jc

    port, jax_cfg = tc.load_worker_config(environ=env), jc.load_worker_config(environ=env)
    assert tc.config_dict(port) == jax_cfg.model_dump(mode="json")
    port.server.auth_token = jax_cfg.server.auth_token = "tok: 'x' # y"
    tc.save_worker_config(port, tmp_path / "port.yaml")
    jc.save_worker_config(jax_cfg, tmp_path / "jax.yaml")
    assert (tmp_path / "port.yaml").read_bytes() == (tmp_path / "jax.yaml").read_bytes()
    want = jax_cfg.model_dump(mode="json")
    assert tc.config_dict(tc.load_worker_config(tmp_path / "jax.yaml", environ={})) == want
    assert jc.load_worker_config(tmp_path / "port.yaml", environ={}).model_dump(
        mode="json") == want
    # elsewhere than .yaml / .yml the port writes JSON, which both read
    tc.save_worker_config(port, tmp_path / "port.json")
    assert json.loads((tmp_path / "port.json").read_text()) == want


@pytest.mark.parametrize("raw,want", [
    ("[9, 17]", [9, 17]), ('{"a": 1}', {"a": 1}), ("[a, 'b', yes]", ["a", "b", True]),
    ("{a: [1, 2]}", {"a": [1, 2]}), ("[unclosed", "[unclosed"), ("{a: &x 1}", "{a: &x 1}"),
])
def test_env_composites_parse_as_the_jax_loader_parses_them(raw, want, no_pyyaml):
    assert tc._env_overrides({"TPU_WORKER_X": raw}) == {"x": want}


def test_the_cli_defaults_to_config_yaml():
    assert tcli.build_parser().parse_args(["show"]).config == "config.yaml"


def test_nan_and_inf_round_trip():
    data = {"a": float("nan"), "b": [float("inf"), -float("inf")], "c": -0.0}
    back = ty.safe_load(ty.safe_dump(data))
    assert math.isnan(back["a"]) and back["b"] == [math.inf, -math.inf]
    assert math.copysign(1.0, back["c"]) == -1.0
