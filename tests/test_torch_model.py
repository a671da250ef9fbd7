"""Whole-graph parity of the PyTorch port (bsyolo_tpu_torch.nn.model) against bsyolo_tpu.

Parameter counts must be equal; the yolo11n forward on carried weights must
agree within rtol 1e-4, atol 1e-4 (float32, NCHW vs NHWC sums in other orders).
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import jax
import jax.numpy as jnp
import torch

from torch_port import jax_spec, nchw, port_module_from_jax, port_spec, random_variables, to_plain_dict, variable_shapes

IMG = 64


@pytest.mark.parametrize("name,scale", [("yolo11.yaml", "n"), ("yolo11.yaml", "s"), ("yolo11old.yaml", "")])
def test_param_count_equals_jax(name, scale):
    from bsyolo_tpu.nn.model import DetectionGraph, count_params as jax_count
    from bsyolo_tpu_torch.nn.model import build_model, count_params

    shapes = variable_shapes(DetectionGraph(jax_spec(name, scale)), (1, IMG, IMG, 3))
    port = build_model(port_spec(name, scale), "cpu", seed=0)
    assert count_params(port) == jax_count(shapes)


@pytest.fixture(scope="module")
def yolo11n_pair():
    from bsyolo_tpu.nn.model import DetectionGraph
    from bsyolo_tpu_torch.nn.model import build_model

    jmodel = DetectionGraph(jax_spec("yolo11n.yaml"))
    variables = random_variables(variable_shapes(jmodel, (1, IMG, IMG, 3)), seed=1)
    port = port_module_from_jax(build_model(port_spec("yolo11n.yaml"), "cpu", seed=0), variables)
    return jmodel, variables, port


def test_yolo11n_forward_matches_jax(yolo11n_pair, rng):
    jmodel, variables, port = yolo11n_pair
    x = rng.uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(nchw(x)))
    assert len(got) == len(want) == 3
    for level, (g, w) in enumerate(zip(got, want)):
        side = IMG // 8 // 2**level
        assert g.shape == (2, 76, side, side)
        np.testing.assert_allclose(g.numpy(), nchw(w), rtol=1e-4, atol=1e-4)


def test_state_dict_round_trips_through_jax_converter(yolo11n_pair):
    """The port's state_dict, through the JAX package's own convert_state_dict
    (strict), reproduces the JAX variables exactly."""
    from bsyolo_tpu.utils.torch_weights import convert_state_dict

    _, variables, port = yolo11n_pair
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back, report = convert_state_dict(sd, variables, strict=True)
    assert report == {"missing": [], "unused": []}
    want = jax.tree_util.tree_leaves_with_path(to_plain_dict(variables))
    got = dict(jax.tree_util.tree_leaves_with_path(to_plain_dict(back)))
    assert len(got) == len(want)
    for path, w in want:
        np.testing.assert_array_equal(np.asarray(got[path]), w)


def test_load_reference_state_dict(tmp_path):
    """YOLO.load reads a .pt state_dict (weights_only), drops dfl/anchors/strides, matches every key."""
    from bsyolo_tpu_torch import YOLO

    src = YOLO("yolo11n.yaml", device="cpu", seed=5)
    sd = {k: v.clone() for k, v in src.model.state_dict().items()}
    sd["model.28.dfl.conv.weight"] = torch.arange(16.0).view(1, 16, 1, 1)
    sd["model.28.anchors"] = torch.zeros(2, 8400)
    sd["model.28.strides"] = torch.zeros(1, 8400)
    torch.save({"model": sd}, tmp_path / "w.pt")
    dst = YOLO("yolo11n.yaml", device="cpu", seed=6).load(tmp_path / "w.pt")
    for k, v in src.model.state_dict().items():
        torch.testing.assert_close(dst.model.state_dict()[k], v, rtol=0, atol=0)
    sd.pop("model.0.conv.weight")
    torch.save(sd, tmp_path / "missing.pt")
    with pytest.raises(RuntimeError, match="model.0.conv.weight"):
        dst.load(tmp_path / "missing.pt")
