"""The in-tree YAML reader (config.parse_yaml): the subset the config schema
uses, checked against PyYAML's ``safe_load`` where PyYAML is importable, and
malformed or out-of-subset input that must raise."""

import glob
import os

import pytest

from climate_sim_tpu.config import YAMLError, load_yaml_file, parse_yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_FILES = sorted(
    glob.glob(os.path.join(REPO, "configs", "*.yaml"))
    + glob.glob(os.path.join(REPO, "tests", "fixtures", "*.yaml"))
)


def _safe_load(text):
    yaml = pytest.importorskip("yaml")
    return yaml.safe_load(text)


@pytest.mark.parametrize("path", CONFIG_FILES, ids=os.path.basename)
def test_repo_configs_parse_like_pyyaml(path):
    text = open(path).read()
    got = parse_yaml(text)
    assert isinstance(got, dict) and got
    try:
        import yaml
    except ImportError:
        return
    assert got == yaml.safe_load(text)
    load_yaml_file(path)  # and the schema accepts it


CASES = {
    "block_nested": "grid:\n  nx: 64\n  ny: 32\nphysics:\n  D: 0.05\n",
    "flow_mapping": "grid: { nx: 4096, ny: 4096, dx: 1.0, dy: 1.0 }\n",
    "nested_flow": "a: {b: {c: 1, d: 'x'}, e: ~}\n",
    "empty_flow": "a: {}\nb: { }\n",
    "trailing_comma": "a: {x: 1, y: 2,}\n",
    "comments": "# head\na: 1  # tail\n  # indented comment\nb: 'has # inside'\n",
    "quotes": "a: \"dq \\\"esc\\\" \\u00e9\"\nb: 'sq ''esc'''\nc: \"#x\"\n",
    "null_blocks": "grid:\nphysics:\ntime:\nbc: dirichlet\n",
    "scalars": ("i: 42\nneg: -7\nf: 0.5\ng: -2.5\nh: .5\nz: 0x1F\n"
                "t: true\nT: True\ny: yes\nn: no\no: off\nnl: null\ntl: ~\n"
                "inf: .inf\nninf: -.inf\ns: plain text\nd: host:1234,2,0\n"),
    "document_markers": "---\na: 1\n...\n",
    "deep_block": "a:\n  b:\n    c:\n      d: 1\n  e: 2\nf: 3\n",
    "quoted_keys": "'a b': 1\n\"c\": 2\n",
    "empty_document": "",
    "only_comments": "# nothing\n\n   # here\n",
    "flow_top_level": "{a: 1, b: {c: 2}}\n",
}


@pytest.mark.parametrize("name", list(CASES))
def test_subset_matches_pyyaml(name):
    text = CASES[name]
    assert parse_yaml(text) == _safe_load(text)


def test_exponent_without_dot_is_a_float():
    """The one deliberate difference from YAML 1.1: ``1e-3`` is a float
    here (PyYAML reads a string); the schema converts with float() anyway."""
    assert parse_yaml("dt: 1e-3\n") == {"dt": 1e-3}


MALFORMED = {
    "block_sequence": "a:\n  - 1\n  - 2\n",
    "flow_sequence": "a: [1, 2]\n",
    "bad_indent": "a: 1\n  b: 2\n",
    "dedent_below_document": "  a: 1\nb: 2\n",
    "unclosed_flow": "a: {b: 1\n",
    "missing_colon_in_flow": "a: {b 1}\n",
    "unterminated_quote": "a: \"abc\n",
    "nested_on_one_line": "a: b: c\n",
    "duplicate_key": "a: 1\na: 2\n",
    "duplicate_flow_key": "a: {b: 1, b: 2}\n",
    "tab_indent": "a:\n\tb: 1\n",
    "anchor": "a: &x 1\n",
    "alias": "a: *x\n",
    "tag": "a: !!str 1\n",
    "literal_block": "a: |\n  text\n",
    "trailing_garbage": "a: \"x\" y\n",
    "key_without_colon": "just a line\n",
    "bad_escape": "a: \"\\q\"\n",
}


@pytest.mark.parametrize("name", list(MALFORMED))
def test_malformed_raises(name):
    with pytest.raises(YAMLError):
        parse_yaml(MALFORMED[name])


def test_error_names_the_line(tmp_path):
    p = tmp_path / "bad.yaml"
    p.write_text("grid: { nx: 64 }\ntime:\n  - 1\n")
    with pytest.raises(YAMLError, match="line 3"):
        load_yaml_file(str(p))
