"""The YOLO v9 and v10 graph files and the YOLO11 stock and TPU-stem variants in the PyTorch port against
bsyolo_tpu: every file's spec and parameters (count, names, shapes) equal the JAX package's
(``zoo_port.assert_graph_is_jax``)."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent))

import jax  # noqa: F401  (JAX before torch, as the other port tests import them)
import torch  # noqa: F401

from zoo_port import GRAPHS_V9_V11, assert_graph_is_jax


@pytest.mark.parametrize("name", GRAPHS_V9_V11)
def test_graph_parameters_equal_jax(name):
    assert_graph_is_jax(name)


@pytest.mark.parametrize("name,scale", [("yolov9t.yaml", ""), ("yolov10n.yaml", "n"), ("yolov8n-p2.yaml", "n"),
                                        ("yolov5n-p6.yaml", "n"), ("yolov8n-cls-resnet50.yaml", "n"),
                                        ("yolov3-tiny.yaml", "")])
def test_facade_resolves_the_names_users_call(name, scale):
    """``YOLO("yolov8n-p2.yaml")`` and the rest resolve as the JAX facade resolves them: the same graph file, scale,
    task and head, on the CPU when asked."""
    from bsyolo_tpu.cfg import model_yaml_path as jax_path

    from bsyolo_tpu_torch import YOLO
    from bsyolo_tpu_torch.cfg import model_yaml_path

    m = YOLO(name, device="cpu")
    assert model_yaml_path(name).name == jax_path(name).name and m.spec.scale == scale
    assert next(m.model.parameters()).device.type == "cpu" and m.task in ("detect", "classify")
