"""The YOLO v3, v5, v6 and v8 graph files in the PyTorch port against bsyolo_tpu: every file's spec and
parameters (count, names, shapes) equal the JAX package's (``zoo_port.assert_graph_is_jax``); the YOLO-World
and YOLO-NAS files, which raised naming ROADMAP item 13 until the port built them, parse as JAX's; the bundled
dataset YAMLs read as the JAX package reads its copies."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent))

import jax  # noqa: F401  (JAX before torch, as the other port tests import them)
import torch  # noqa: F401

from zoo_port import GRAPHS_V3_V8, assert_graph_is_jax

JAX_MODELS = Path(__file__).resolve().parent.parent / "bsyolo_tpu" / "cfg" / "models"
JAX_DATASETS = Path(__file__).resolve().parent.parent / "bsyolo_tpu" / "cfg" / "datasets"


@pytest.mark.parametrize("name", GRAPHS_V3_V8)
def test_graph_parameters_equal_jax(name):
    assert_graph_is_jax(name)


def test_graph_files_are_the_jax_packages():
    """The 36 graph files of this slice, byte for byte the JAX package's."""
    from bsyolo_tpu_torch.cfg import CFG_ROOT

    from zoo_port import GRAPHS_V9_V11

    for name in GRAPHS_V3_V8 + GRAPHS_V9_V11:
        (mine,) = (CFG_ROOT / "models").rglob(name)
        assert mine.read_bytes() == (JAX_MODELS / mine.parent.name / name).read_bytes(), name


@pytest.mark.parametrize("family", ["v8/yolov8-world.yaml", "v8/yolov8-worldv2.yaml", "nas/yolo_nas_s.yaml"])
def test_later_families_raise_naming_item_13(family):
    """The families that raised naming ROADMAP item 13 until the port built them (13.2 YOLO-World, 13.3 YOLO-NAS):
    the JAX package's file now parses, its head is WorldDetect or NASDetect, and the port's graph of it is JAX's;
    the parser's error for a module it does not know still names the module."""
    from bsyolo_tpu_torch.nn.parser import load_model_yaml, parse_model_yaml

    spec = parse_model_yaml(load_model_yaml(JAX_MODELS / family))
    assert spec.head.module == ("NASDetect" if "nas" in family else "WorldDetect") and spec.task == "detect"
    assert_graph_is_jax(str(JAX_MODELS / family))
    d = load_model_yaml(JAX_MODELS / family)
    d["head"][0] = [-1, 1, "SAM2Block", [64]]
    with pytest.raises(NotImplementedError, match="SAM2Block"):
        parse_model_yaml(d)


@pytest.mark.parametrize("name", sorted(p.name for p in JAX_DATASETS.glob("*.yaml")))
def test_dataset_yaml_reads_as_jax(name):
    """``data=<name>`` resolves to the port's bundled copy with the JAX package's classes; the raw file reads as
    PyYAML reads it."""
    import yaml

    from bsyolo_tpu.data.dataset import load_dataset_yaml as jax_load

    from bsyolo_tpu_torch.cfg import CFG_ROOT, read_yaml
    from bsyolo_tpu_torch.data import load_dataset_yaml

    mine = CFG_ROOT / "datasets" / name
    assert mine.read_bytes() == (JAX_DATASETS / name).read_bytes()
    assert read_yaml(mine) == yaml.safe_load(mine.read_text())
    got, want = load_dataset_yaml(name), jax_load(name)
    assert got["nc"] == want.get("nc", len(want["names"])) and got["names"] == {
        int(k): str(v) for k, v in want["names"].items()}
