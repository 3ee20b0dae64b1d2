"""The port's config system against the reference's: its own YAML loader
(detzero_tpu_torch.core.yaml_subset) equal to PyYAML's safe_load on every
file under configs/ and on the constructs of the subset; cfg_from_yaml_file
(the _BASE_CONFIG_ include, resolved against the working directory) equal
to the reference's Config on every detection config; cfg_from_list's type
rules; the registry and the logger."""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from detzero_tpu.core import config as ref_config
from detzero_tpu_torch.core import config, logger, registry
from detzero_tpu_torch.core.yaml_subset import safe_load

REPO = Path(__file__).resolve().parent.parent
YAMLS = sorted(str(p.relative_to(REPO))
               for p in REPO.glob("configs/**/*.yaml"))
DET = [p for p in YAMLS if "/det_model_cfgs/" in p]


@pytest.fixture(autouse=True)
def at_repo_root(monkeypatch):
    monkeypatch.chdir(REPO)


def test_every_config_found():
    assert len(YAMLS) >= 30 and len(DET) >= 10


@pytest.mark.parametrize("path", YAMLS)
def test_loader_equals_pyyaml(path):
    text = (REPO / path).read_text()
    assert safe_load(text) == yaml.safe_load(text)


SNIPPETS = [
    # scalars as YAML 1.1 resolves them: 1e-3 (no dot) is a string
    "a: 1_000\nb: 010\nc: 0x1f\nd: 1e-3\ne: 1.5e+3\nf: .5\ng: -.inf\n"
    "h: yes\ni: ~\nj:\nk: 'it''s'\nl: \"x\\ty\"\nm: 1:30\nn: -0b101\n"
    "o: Off\np: +12\nq: 3.\nr: -1.5:30.0\ns: null\nt: NO\n",
    # nested flow collections, spanning lines, with comments after them
    "a: [1, [2, {b: c, d: [e]}], 'q, r', \"s # t\"]  # u\n"
    "b: [x,\n    y,   # more\n    z]\nc: {}\nd: []\ne: {k: , l: 2}\n",
    # block lists of scalars, of mappings, of lists; a list at a key's
    # indent; a null item
    "a:\n- 1\n- k: 2\n  l: [3]\n-\n  - z\n- - w\nb:\n  c:\n  - 4\n  d: 5\n",
    "- a\n- b # c\n-\n",
    "[1, 2,\n 3]\n",
    "# only a comment\n",
    "'quoted key': 1\n\"q2\": {\"x\": 'y'}\n",
]


@pytest.mark.parametrize("text", SNIPPETS)
def test_loader_equals_pyyaml_on_the_subset(text):
    assert safe_load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: &x 1\n", "a: *x\n", "a: !tag 1\n", "a: |\n  b\n", "---\na: 1\n",
    "a:\n\tb: 1\n"])
def test_loader_refuses_what_is_outside_the_subset(text):
    with pytest.raises(ValueError):
        safe_load(text)


@pytest.mark.parametrize("path", DET)
def test_cfg_from_yaml_file_equals_reference(path):
    ref = ref_config.cfg_from_yaml_file(path, ref_config.Config())
    got = config.cfg_from_yaml_file(path, config.Config())
    assert got == ref
    assert got.TAG == Path(path).stem
    assert isinstance(got.get("DATA_PROCESSOR", [{}])[0], config.Config)


SETS = [
    ["OPTIMIZATION.LR", "0.01", "OPTIMIZATION.NUM_EPOCHS", "3"],
    ["OPTIMIZATION.LR", "1", "MODEL.WITH_IOU", "0"],       # int -> float, bool
    ["POINT_CLOUD_RANGE", "(-10, -10, -2, 10, 10, 4)"],     # tuple -> list
    ["NEW.KEY.PATH", "[1, 2]", "DATASET", "SyntheticWaymoDataset"],
    ["MODEL.NAME", "not_a_literal value"],                  # kept a string
]


@pytest.mark.parametrize("sets", SETS)
def test_cfg_from_list_equals_reference(sets):
    path = "configs/det_model_cfgs/centerpoint_5sweeps.yaml"
    ref = ref_config.cfg_from_list(
        sets, ref_config.cfg_from_yaml_file(path, ref_config.Config()))
    got = config.cfg_from_list(
        sets, config.cfg_from_yaml_file(path, config.Config()))
    assert got == ref
    assert all(type(got.get_nested(k)) is type(ref.get_nested(k))
               for k in sets[0::2])


def test_cfg_from_list_refuses_a_type_change():
    cfg = config.cfg_from_yaml_file(
        "configs/det_model_cfgs/centerpoint_5sweeps.yaml", config.Config())
    for bad in (["OPTIMIZATION.LR", "'fast'"], ["MODEL.NAME", "3"]):
        with pytest.raises(ValueError, match="type mismatch"):
            config.cfg_from_list(bad, cfg)


def test_registry_and_seeding():
    reg = registry.Registry("things")

    @reg.register()
    class Thing:
        pass

    assert reg.get("Thing") is Thing and "Thing" in reg
    with pytest.raises(KeyError, match="already registered"):
        reg.register("Thing")(Thing)
    with pytest.raises(KeyError, match="not found"):
        reg.get("Other")
    logger.set_random_seed(3)
    a = (np.random.rand(), torch.rand(1).item())
    logger.set_random_seed(3)
    assert (np.random.rand(), torch.rand(1).item()) == a
    assert logger.get_rank() == 0
