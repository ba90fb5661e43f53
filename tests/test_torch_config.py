"""``ExpConfig.from_yaml`` without PyYAML (the GPU machine has none): the
port's flat reader gives what ``yaml.safe_load`` gives on every config file
of the repo, and refuses what it does not read."""

import sys
from pathlib import Path

import pytest
import yaml

from audio2face_tpu_torch.config import ExpConfig, read_flat_yaml

REPO = Path(__file__).resolve().parents[1]
CONFIG_FILES = sorted([REPO / "config.yaml", *(REPO / "configs").glob("*.yaml")])


def _typed(d):
    return {k: (type(v), v) for k, v in d.items()}


@pytest.mark.parametrize("path", CONFIG_FILES, ids=lambda p: p.name)
def test_flat_reader_equals_safe_load_on_the_repo_configs(path, monkeypatch):
    text = path.read_text()
    want = yaml.safe_load(text)
    assert _typed(read_flat_yaml(text)) == _typed(want)
    with_yaml = ExpConfig.from_yaml(str(path))
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert ExpConfig.from_yaml(str(path)) == with_yaml


@pytest.mark.parametrize("line", [
    "lr: 1e-4", "lr: 1.0e-4", "a: .5", "a: 1.", "a: -3", "a: +5", "a: 1_000", "a: 0",
    "a: 'x''y'", 'a: "q # r"  # comment', "a: [2, 1]", "a: [-1, 1]", "a: []", "a:", "a: ~",
    "a: null", "a: yes", "a: Off", "a: True", "a: x#y", "a: hello world", "a: -x",
    "# only a comment", "---",
])
def test_flat_reader_scalars_equal_safe_load(line):
    assert _typed(read_flat_yaml(line)) == _typed(yaml.safe_load(line) or {})


@pytest.mark.parametrize("text", [
    "a: 0x10", "a: 010", "a: 1:20", "a: .inf", "a: 2001-01-01", "a: &x 1", "a: !!str 1",
    "a: |", "a: -", "a: {b: 1}", "a:\n  b: 1", "just text", 'a: "esc\\"aped"',
])
def test_flat_reader_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        read_flat_yaml(text)
