"""The bf16 graph and int8 inference on the YOLO v6, v8, v9 and v10 graphs in the PyTorch port against bsyolo_tpu.

bf16: yolov8n and yolov10n (both branches of its head) at 128 px, the port's ``cast_inference_graph`` against
the JAX ``dtype=bfloat16`` graph, jitted: every bfloat16 head level within ``GRAPH_NORM`` of the JAX level's
norm and more than ``F32_GAP`` from float32 (tests/test_torch_bf16.py's gates). int8: yolov6n (ReLU) and
yolov9t (RepConv, ELAN1, AConv) at 64 px, each calibrated by its own package on the same batches: the scales
within 1e-5, and every quantizable Conv, in static int8 with the JAX scales and fed the input its jitted JAX
ConvBN saw, giving that ConvBN's output within ``CONV_RTOL`` (tests/test_torch_int8.py's gate).
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import jax
import jax.numpy as jnp
import torch

from bsyolo_tpu.nn import modules as JM
from torch_port import jax_spec, nchw, port_module_from_jax, port_spec, random_variables, variable_shapes

GRAPH_NORM, F32_GAP = 7.5e-3, 1e-3
CONV_RTOL = 1e-5


@pytest.fixture(autouse=True)
def jax_modes_off():
    """The JAX package's int8 switch and activation are module globals read at trace time: reset them."""
    yield
    JM.set_int8_inference(False)
    JM.set_int8_calibration(False)
    JM.set_default_act("silu")


def _pair(name, size, seed):
    from bsyolo_tpu.nn.model import DetectionGraph

    from bsyolo_tpu_torch.nn.model import build_model

    spec = jax_spec(name)
    variables = random_variables(variable_shapes(DetectionGraph(spec), (1, size, size, 3)), seed=seed)
    return spec, variables, port_module_from_jax(build_model(port_spec(name), "cpu"), variables)


def _levels(out):
    if isinstance(out, dict):
        return list(out["one2many"]) + list(out["one2one"])
    return list(out)


@pytest.mark.parametrize("name", ["yolov8n.yaml", "yolov10n.yaml"])
def test_graph_bf16_matches_jax(name, rng):
    from bsyolo_tpu.nn.model import DetectionGraph

    from bsyolo_tpu_torch.nn.model import cast_inference_graph

    spec, variables, port = _pair(name, 128, seed=4)
    x = rng.uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    jb = DetectionGraph(spec, dtype=jnp.bfloat16)
    want = _levels(jax.jit(lambda v, x: jb.apply(v, x, train=False))(variables, jnp.asarray(x)))
    xt = torch.from_numpy(nchw(x))
    with torch.no_grad():
        f32 = _levels(port(xt))
        got = _levels(cast_inference_graph(port)(xt))
    assert len(got) == len(want) == (6 if "v10" in name else 3)
    for g, f, w in zip(got, f32, want):
        g64, w64 = g.double().numpy(), nchw(np.asarray(w, np.float32)).astype(np.float64)
        err = np.linalg.norm(g64 - w64) / np.linalg.norm(w64)
        gap = np.linalg.norm(g64 - f.double().numpy()) / np.linalg.norm(f.double().numpy())
        print(f"{name} level {tuple(g.shape)}: {err:.3g} of the JAX bf16 level's norm; {gap:.3g} from float32")
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16 and err <= GRAPH_NORM and gap > F32_GAP


@pytest.mark.parametrize("name,n_convs", [("yolov6n.yaml", 53), ("yolov9t.yaml", 221)])
def test_int8_conv_codes_match_jitted_jax(name, n_convs):
    import flax.linen as nn

    from bsyolo_tpu.nn.model import DetectionGraph
    from bsyolo_tpu.nn.quant import calibrate_int8 as jax_calibrate

    from bsyolo_tpu_torch.nn.modules import quantizable_convs, scale_key, set_int8_inference
    from bsyolo_tpu_torch.nn.quant import calibrate_int8
    from bsyolo_tpu_torch.utils.weights import scales_from_jax

    spec, variables, port = _pair(name, 64, seed=5)
    jmodel = DetectionGraph(spec)
    brng = np.random.default_rng(7)
    batches = [brng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32) for _ in range(2)]
    jax_scales = jax_calibrate(jmodel, variables, [jnp.asarray(b) for b in batches])
    scales = calibrate_int8(port, [torch.from_numpy(nchw(b)) for b in batches])
    want_scales = scales_from_jax(jax_scales)
    assert set(scales) == set(want_scales) and len(scales) == n_convs
    np.testing.assert_allclose([scales[k] for k in sorted(want_scales)],
                               [want_scales[k] for k in sorted(want_scales)], rtol=1e-5)

    def run(v, xx):
        convs = {}

        def record(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if isinstance(context.module, JM.ConvBN) and context.method_name == "__call__":
                convs["/".join(context.module.scope.path) + "/conv"] = (args[0], out)  # keyed as its scale
            return out

        with nn.intercept_methods(record):
            return jmodel.apply(v, xx, train=False), convs

    x = np.random.default_rng(8).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    JM.set_int8_inference(True, jax_scales)
    _, jconvs = jax.jit(run)(variables, jnp.asarray(x))
    JM.set_int8_inference(False)
    convs = dict(zip(scales_from_jax(dict.fromkeys(jconvs, 0.0)), jconvs.values()))
    set_int8_inference(port, True, want_scales)
    try:
        quantizable = quantizable_convs(port)
        assert len(quantizable) == n_convs
        if name == "yolov6n.yaml":
            assert {type(m.act).__name__ for _, m in quantizable} == {"ReLU"}
        with torch.no_grad():
            for conv_name, m in quantizable:
                xin, want = (nchw(a) for a in convs[scale_key(conv_name)])
                got = m(torch.tensor(xin)).numpy()
                np.testing.assert_allclose(got, want, rtol=CONV_RTOL, atol=CONV_RTOL * np.abs(want).max(),
                                           err_msg=conv_name)
    finally:
        set_int8_inference(port, False)
