"""Whole-graph forward of the YOLO v3, v5, v6, v8, v9 and v10 graphs in the PyTorch port against bsyolo_tpu.

Seeded JAX variables carried into the port (``state_dict_from_jax``), one batch of 2 at 64 px through both
graphs in eval mode; every head map (both branches of YOLOv10's head, a Segment head's prototypes, a
Classify head's logits) within rtol 1e-4, atol 2e-4. The graphs cover the new layers: MaxPool2d and
ZeroPad2d (yolov3-tiny), four levels (yolov5n-p6), ReLU and the bare transposed conv (yolov6n), the legacy
heads (yolov8n, -seg), Ghost blocks, the ResNet stages, ELAN1/AConv (yolov9t), CBLinear/CBFuse (yolov9e),
C2fCIB/PSA/v10Detect (yolov10n).
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
RTOL, ATOL = 1e-4, 2e-4
GRAPHS = ["yolov3-tiny.yaml", "yolov5n-p6.yaml", "yolov6n.yaml", "yolov8n.yaml", "yolov8n-ghost.yaml",
          "yolov8n-seg.yaml", "yolov8n-cls-resnet50.yaml", "yolov9t.yaml", "yolov10n.yaml", "yolov9e.yaml"]


@pytest.fixture(autouse=True)
def silu_after():
    """yolov6's ReLU is a module global of the JAX package, set at trace time: put SiLU back for later tests."""
    yield
    from bsyolo_tpu.nn.modules import set_default_act

    set_default_act("silu")


@pytest.mark.parametrize("name", GRAPHS)
def test_forward_matches_jax(name, rng):
    from bsyolo_tpu.nn.model import DetectionGraph

    from bsyolo_tpu_torch.nn.model import build_model

    jmodel = DetectionGraph(jax_spec(name))
    variables = to_plain_dict(random_variables(variable_shapes(jmodel, (1, IMG, IMG, 3)), seed=GRAPHS.index(name)))
    port = port_module_from_jax(build_model(port_spec(name), "cpu"), variables)
    x = rng.uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(nchw(x)))
    if isinstance(want, jax.Array):  # Classify: (B, nc) logits
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
        return
    wm = [nchw(w) if np.asarray(w).ndim == 4 else np.asarray(w) for w in jax.tree_util.tree_leaves(
        [want[k] for k in ("one2many", "one2one")] if "one2one" in want else
        ([want["feats"], want["proto"]] if isinstance(want, dict) else want))]
    gm = [g.numpy() for g in jax.tree_util.tree_leaves(
        [got[k] for k in ("one2many", "one2one")] if isinstance(got, dict) and "one2one" in got else
        ([got["feats"], got["proto"]] if isinstance(got, dict) else got))]
    assert len(gm) == len(wm) >= 2
    for g, w in zip(gm, wm):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
