"""Int8 inference in the port against the JAX package, on the CPU.

Covers ``bsyolo_tpu_torch/kernels/int8_matmul.py`` (``quantize_sym`` and the
plain version of the int8 matmul kernel), the int8 mode of
``nn/modules.py::Conv``, ``nn/quant.py::calibrate_int8``,
``utils/weights.py::scales_from_jax`` and int8 predict. Weights are drawn with
numpy and carried into the port with ``state_dict_from_jax``; scales
calibrated by the JAX package are carried over with ``scales_from_jax``.

Tolerances:
- codes, scales and the int8 product: exact (int32 sums are exact on both
  sides, and the dequantization runs in the same float32 order);
- one Conv against ``ConvBN``: rtol 1e-5, atol 1e-6 (the same codes; only
  BatchNorm's float32 order differs);
- whole graphs: a code can flip where a float layer before a quantize
  differs in its last bit and lands on a rounding boundary, so the head maps
  are held to GRAPH_RTOL of their scale, which is at least 10 times tighter
  than the int8-against-float gap the same test measures;
- predict rows: classes equal, scores within rtol 1e-5, boxes within 1e-3 px
  (as tests/test_torch_predict.py).
"""

import copy
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

IMG = 128
CONV_RTOL = 1e-5
GRAPH_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _reset_jax_mode():
    """The JAX mode is process-wide: leave it off after every test."""
    yield
    JM.set_int8_inference(False)
    JM.set_int8_calibration(False)


def _codes(rng, shape):
    return rng.integers(-128, 128, shape, dtype=np.int8)


@pytest.mark.parametrize("axis", [None, 0, 1, (0, 1)])
def test_quantize_sym_matches_jax(rng, axis):
    from bsyolo_tpu.kernels.int8_matmul import quantize_sym as jax_quantize
    from bsyolo_tpu_torch.kernels.int8_matmul import quantize_sym

    x = (rng.normal(0, 3, (64, 48)) * rng.uniform(0, 2, (1, 48))).astype(np.float32)
    x[:, 5] = 0.0  # an all-zero column: the 1e-8 floor
    wq, ws = jax_quantize(jnp.asarray(x), axis=axis)
    gq, gs = quantize_sym(torch.from_numpy(x), axis=axis)
    assert gq.dtype == torch.int8 and gq.shape == wq.shape and gs.shape == ws.shape
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_reference_matches_pallas_interpret(rng, out_dtype):
    """The plain version equals the Pallas kernel (interpret mode) at its own test's shape, exactly."""
    from bsyolo_tpu.kernels.int8_matmul import int8_matmul as jax_int8_matmul
    from bsyolo_tpu_torch.kernels.int8_matmul import int8_matmul

    x, w = _codes(rng, (512, 128)), _codes(rng, (128, 128))
    sw = rng.uniform(1e-3, 2e-2, (128,)).astype(np.float32)
    sx = np.float32(0.037)
    want = jax_int8_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sw), jnp.asarray(sx),
                           out_dtype=getattr(jnp, out_dtype), interpret=True)
    got = int8_matmul(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(sw), torch.tensor(sx),
                      getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype) and got.shape == (512, 128)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want).astype(np.float32))


@pytest.mark.parametrize("m,k,n", [(37, 27, 20), (1, 1, 1), (300, 2304, 7)])
def test_reference_ragged_matches_int32_product(rng, m, k, n):
    """Shapes the Pallas kernel cannot take, against numpy's int32 product and the same dequantization."""
    from bsyolo_tpu_torch.kernels.int8_matmul import int8_matmul_reference

    x, w = _codes(rng, (m, k)), _codes(rng, (k, n))
    sw = rng.uniform(1e-3, 2e-2, (n,)).astype(np.float32)
    sx = np.float32(0.011)
    want = (x.astype(np.int32) @ w.astype(np.int32)).astype(np.float32) * (sx * sw)
    got = int8_matmul_reference(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(sw), torch.tensor(sx))
    np.testing.assert_array_equal(got.numpy(), want)


def test_cuda_entry_refuses_cpu_tensors():
    from bsyolo_tpu_torch.kernels.int8_matmul import int8_matmul_cuda

    before = int8_matmul_cuda.launches
    x = torch.zeros(4, 16, dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        int8_matmul_cuda(x, x.t().contiguous(), torch.ones(4), torch.tensor(1.0))
    assert int8_matmul_cuda.launches == before


def _conv_pair(rng, c1, c2, k, s, g=1):
    """A JAX ConvBN and the port's Conv with the same seeded weights."""
    from bsyolo_tpu_torch.nn.modules import Conv

    jconv = JM.ConvBN(c2, k, s, g=g)
    variables = random_variables(variable_shapes(jconv, (1, 16, 16, c1)), seed=int(rng.integers(1 << 30)))
    return jconv, variables, port_module_from_jax(Conv(c1, c2, k, s, g=g), variables)


def _jit_apply(module, variables, x):
    """A JAX module's eval forward, jitted afresh (the int8 mode is read at trace
    time), as the JAX predictor and exporter run it."""
    return jax.jit(lambda v, xx: module.apply(v, xx, train=False))(variables, jnp.asarray(x))


@pytest.mark.parametrize("mode", ["dynamic", "static"])
@pytest.mark.parametrize("k,s", [(1, 1), (3, 1), (3, 2), (1, 2)])
def test_conv_int8_matches_jax(rng, k, s, mode):
    from bsyolo_tpu_torch.nn.modules import set_int8_inference

    jconv, variables, conv = _conv_pair(rng, 24, 40, k, s)
    x = rng.normal(0, 1, (2, 15, 17, 24)).astype(np.float32)
    scales = {"conv": 0.8 * float(np.abs(x).max())} if mode == "static" else None  # static clips the top codes
    float_out = jconv.apply(variables, jnp.asarray(x), train=False)
    JM.set_int8_inference(True, scales)
    want = nchw(_jit_apply(jconv, variables, x))
    set_int8_inference(conv, True, scales)
    with torch.no_grad():
        got = conv(torch.from_numpy(nchw(x))).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.abs(want - nchw(float_out)).max() > 1e-4  # quantized, not a no-op


def test_static_codes_follow_jitted_jax(rng):
    """In static mode the JAX scale is a constant, and XLA compiles x / sx into x
    times the float32 reciprocal of sx, whose rounding differs from the division
    at some .5 boundaries. The port quantizes static inputs the same way, so its
    codes equal the jitted JAX codes on inputs placed at those boundaries."""
    from bsyolo_tpu_torch.nn.modules import set_int8_inference

    jconv, variables, conv = _conv_pair(rng, 16, 8, 1, 1)
    amax = 3.7
    sx = np.float32(amax / 127.0)
    near = (np.arange(-126, 126) + 0.5).astype(np.float32) * sx  # on the rounding boundaries, up to rounding
    x = np.resize(np.concatenate([near, np.nextafter(near, 0), np.nextafter(near, 1)]), (1, 6, 8, 16))
    flat = x.ravel()
    assert (np.round(flat / sx) != np.round(flat * (np.float32(1) / sx))).sum() > 0  # the two roundings differ here
    JM.set_int8_inference(True, {"conv": amax})
    want = nchw(_jit_apply(jconv, variables, x))
    set_int8_inference(conv, True, {"conv": amax})
    with torch.no_grad():
        got = conv(torch.from_numpy(nchw(x))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_weight_codes_follow_jitted_jax(rng):
    """The jitted JAX graph's weight scale amax / 127 is amax times the float32
    1/127, one ulp off the division for some amax. Each output channel gets
    such an amax and weights on the rounding boundaries of its scale; a one-hot
    input reads every weight code out, and the port's equal the jitted JAX ones."""
    from bsyolo_tpu_torch.nn.modules import set_int8_inference

    jconv, variables, conv = _conv_pair(rng, 16, 8, 1, 1)
    inv = np.float32(1) / np.float32(127)
    cand = rng.uniform(0.1, 1.0, 4096).astype(np.float32)
    amax = cand[cand / np.float32(127) != cand * inv][:8]
    sw = amax * inv
    n = np.arange(1, 16, dtype=np.float32)
    kernel = np.empty((1, 1, 16, 8), np.float32)
    kernel[0, 0, 0] = amax
    kernel[0, 0, 1:] = (n[:, None] + 0.5) * sw * np.where(n % 2, 1, -1)[:, None]  # halfway between two codes
    w = kernel[0, 0]
    assert (np.round(w / sw) != np.round(w / (amax / np.float32(127)))).any()  # the two scales give other codes here
    variables = {**variables, "params": {**variables["params"], "conv": {"kernel": kernel}}}
    port_module_from_jax(conv, variables)
    x = np.zeros((1, 4, 4, 16), np.float32)
    x.reshape(16, 16)[np.arange(16), np.arange(16)] = 1.0  # pixel i carries input channel i
    JM.set_int8_inference(True, {"conv": 1.0})
    want = nchw(_jit_apply(jconv, variables, x))
    set_int8_inference(conv, True, {"conv": 1.0})
    with torch.no_grad():
        got = conv(torch.from_numpy(nchw(x))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_grouped_conv_and_train_mode_stay_float(rng):
    from bsyolo_tpu_torch.nn.modules import Conv, set_int8_inference

    x = torch.from_numpy(nchw(rng.normal(0, 1, (2, 8, 8, 32)).astype(np.float32)))
    dw = Conv(32, 32, 3, 1, g=32).eval()
    with torch.no_grad():
        want = dw(x)
        set_int8_inference(dw, True)
        np.testing.assert_array_equal(dw(x).numpy(), want.numpy())

    conv = Conv(32, 16, 3, 1).train()
    twin = copy.deepcopy(conv)
    set_int8_inference(conv, True)
    with torch.no_grad():
        np.testing.assert_array_equal(conv(x).numpy(), twin(x).numpy())
        np.testing.assert_array_equal(conv.bn.running_mean.numpy(), twin.bn.running_mean.numpy())


def test_scales_missing_a_key_fall_back_to_dynamic(rng):
    from bsyolo_tpu_torch.nn.modules import int8_inference, set_int8_inference

    _, _, conv = _conv_pair(rng, 16, 32, 3, 1)
    x = torch.from_numpy(nchw(rng.normal(0, 1, (2, 12, 12, 16)).astype(np.float32)))
    with torch.no_grad():
        set_int8_inference(conv, True)
        dynamic = conv(x)
        set_int8_inference(conv, True, {"not.a.conv": 1.0})
        np.testing.assert_array_equal(conv(x).numpy(), dynamic.numpy())
        set_int8_inference(conv, True, {})
        np.testing.assert_array_equal(conv(x).numpy(), dynamic.numpy())
        assert int8_inference(conv)
        set_int8_inference(conv, False)
        assert not int8_inference(conv)


def test_new_weights_are_quantized_anew(rng):
    """The cached weight codes follow load_state_dict: no stale codes after new weights."""
    from bsyolo_tpu_torch.nn.modules import set_int8_inference

    _, _, conv = _conv_pair(rng, 16, 32, 3, 1)
    _, _, other = _conv_pair(rng, 16, 32, 3, 1)
    x = torch.from_numpy(nchw(rng.normal(0, 1, (1, 10, 10, 16)).astype(np.float32)))
    set_int8_inference(conv, True)
    set_int8_inference(other, True)
    with torch.no_grad():
        before = conv(x)
        conv.load_state_dict(other.state_dict())
        after = conv(x)
        np.testing.assert_array_equal(after.numpy(), other(x).numpy())
    assert (after - before).abs().max() > 1e-3


def test_dilated_conv_raises_in_int8_mode():
    from bsyolo_tpu_torch.nn.modules import Conv, set_int8_inference

    conv = Conv(8, 8, 3, 1, d=2).eval()
    set_int8_inference(conv, True)
    with pytest.raises(NotImplementedError, match="dilation"):
        conv(torch.zeros(1, 8, 8, 8))


def test_calibration_leaves_mode_off_and_hooks_removed_on_error(rng):
    from bsyolo_tpu_torch.nn.modules import Conv, int8_inference, set_int8_inference
    from bsyolo_tpu_torch.nn.quant import calibrate_int8

    model = torch.nn.Sequential(Conv(8, 16, 3), Conv(16, 16, 3, g=16)).eval()
    set_int8_inference(model, True)
    with pytest.raises(RuntimeError):
        calibrate_int8(model, [torch.zeros(1, 8, 8, 8), torch.zeros(1, 5, 8, 8)])  # the second has 5 channels
    assert not int8_inference(model)
    assert all(not m._forward_pre_hooks for m in model.modules())
    scales = calibrate_int8(model, [torch.full((1, 8, 6, 6), -2.0), torch.full((2, 8, 6, 6), 0.5)])
    assert scales == {"0.conv": 2.0}  # the depthwise conv is not quantizable
    with pytest.raises(ValueError, match="no quantizable"):
        calibrate_int8(model[1], [torch.zeros(1, 16, 4, 4)])


def test_scales_from_jax_keys():
    from bsyolo_tpu_torch.utils.weights import scales_from_jax

    got = scales_from_jax({"m0/conv": 1.5, "m2/m_0/cv1/conv": 2, "m23/cv2_0_0/conv": 3.0, "m9/dw/conv": 4.0})
    assert got == {"model.0.conv": 1.5, "model.2.m.0.cv1.conv": 2.0, "model.23.cv2.0.0.conv": 3.0,
                   "model.9.conv": 4.0}


GRAPHS = {  # name -> (model YAML, number of quantizable convs)
    "tiny": (str(Path(__file__).parent / "fixtures/tiny.yaml"), 34),
    "yolo11n": ("yolo11n.yaml", 74),
}


@pytest.fixture(scope="module", params=list(GRAPHS))
def calibrated(request):
    """One graph on both sides with the same weights, each calibrated by its own
    package on the same two batches; the JAX scales and the port's."""
    from bsyolo_tpu.nn.model import DetectionGraph
    from bsyolo_tpu.nn.quant import calibrate_int8 as jax_calibrate
    from bsyolo_tpu_torch.nn.model import DetectionGraph as PortGraph
    from bsyolo_tpu_torch.nn.quant import calibrate_int8

    name = request.param
    path, n_convs = GRAPHS[name]
    spec = jax_spec(path)
    jmodel = DetectionGraph(spec)
    variables = random_variables(variable_shapes(jmodel, (1, IMG, IMG, 3)), seed=2)
    port = port_module_from_jax(PortGraph(port_spec(path)), variables)
    brng = np.random.default_rng(7)
    batches = [brng.uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32) for _ in range(2)]
    jax_scales = jax_calibrate(jmodel, variables, [jnp.asarray(b) for b in batches])
    scales = calibrate_int8(port, [torch.from_numpy(nchw(b)) for b in batches])
    return dict(name=name, n_convs=n_convs, jmodel=jmodel, spec=spec, variables=variables, port=port,
                batches=batches, jax_scales=jax_scales, scales=scales)


def test_calibration_matches_jax(calibrated):
    from bsyolo_tpu_torch.utils.weights import scales_from_jax

    want = scales_from_jax(calibrated["jax_scales"])
    got = calibrated["scales"]
    assert set(got) == set(want)
    assert len(got) == calibrated["n_convs"]
    keys = sorted(want)
    np.testing.assert_allclose([got[k] for k in keys], [want[k] for k in keys], rtol=1e-5)


@pytest.fixture(scope="module")
def int8_runs(calibrated):
    """One batch through both graphs in static int8 with the JAX scales, and
    through the port in float. The JAX run also returns every ConvBN's input
    and output, keyed as its scale is."""
    import flax.linen as nn

    from bsyolo_tpu_torch.nn.modules import set_int8_inference
    from bsyolo_tpu_torch.utils.weights import scales_from_jax

    jmodel, variables, port = calibrated["jmodel"], calibrated["variables"], calibrated["port"]

    def run(v, xx):
        convs = {}

        def record(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if isinstance(context.module, JM.ConvBN) and context.method_name == "__call__":
                convs["/".join(context.module.scope.path) + "/conv"] = (args[0], out)  # keyed as its scale
            return out

        with nn.intercept_methods(record):
            return jmodel.apply(v, xx, train=False), convs

    x = np.random.default_rng(8).uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    JM.set_int8_inference(True, calibrated["jax_scales"])
    try:
        want, convs = jax.jit(run)(variables, jnp.asarray(x))
    finally:
        JM.set_int8_inference(False)
    xt = torch.from_numpy(nchw(x))
    with torch.no_grad():
        ref = port(xt)
        set_int8_inference(port, True, scales_from_jax(calibrated["jax_scales"]))
        try:
            got = port(xt)
        finally:
            set_int8_inference(port, False)
    return dict(want=[nchw(w) for w in want], got=[g.numpy() for g in got], ref=[f.numpy() for f in ref],
                convs={k: (nchw(i), nchw(o)) for k, (i, o) in convs.items()})


def test_graph_int8_convs_match_jax(calibrated, int8_runs):
    """Every quantizable Conv of the port's graph, in static int8 with the carried
    JAX scales and fed the input its JAX ConvBN saw, gives that ConvBN's output:
    the same codes, within CONV_RTOL (BatchNorm's float order differs)."""
    from bsyolo_tpu_torch.nn.modules import quantizable_convs, scale_key, set_int8_inference
    from bsyolo_tpu_torch.utils.weights import scales_from_jax

    port, jax_convs = calibrated["port"], int8_runs["convs"]
    convs = dict(zip(scales_from_jax(dict.fromkeys(jax_convs, 0.0)), jax_convs.values()))
    set_int8_inference(port, True, scales_from_jax(calibrated["jax_scales"]))
    try:
        quantizable = quantizable_convs(port)
        assert len(quantizable) == calibrated["n_convs"]
        with torch.no_grad():
            for name, m in quantizable:
                x, want = convs[scale_key(name)]
                got = m(torch.tensor(x)).numpy()
                np.testing.assert_allclose(got, want, rtol=CONV_RTOL, atol=CONV_RTOL * np.abs(want).max(),
                                           err_msg=name)
    finally:
        set_int8_inference(port, False)


def test_graph_int8_head_maps_match_jax(calibrated, int8_runs):
    """The whole graph run free. One code that flips at a rounding boundary (a
    float layer before a quantize differing in its last bit) moves later codes
    too, so yolo11n's port and JAX head maps agree in most elements, not all:
    the median |difference| stays within GRAPH_RTOL of the scale, at least 10
    times below the median int8-against-float gap, and the largest within
    twice the largest gap. tiny.yaml has no such flip on this batch and agrees
    everywhere within GRAPH_RTOL."""
    for got, want, ref in zip(int8_runs["got"], int8_runs["want"], int8_runs["ref"]):
        scale = np.abs(want).max()
        diff, gap = np.abs(got - want), np.abs(got - ref)
        assert np.median(gap) >= 10 * GRAPH_RTOL * scale  # int8 really ran
        assert np.median(diff) <= GRAPH_RTOL * scale
        if calibrated["name"] == "tiny":
            assert diff.max() <= GRAPH_RTOL * scale
        else:
            assert diff.max() <= 2 * gap.max()


@pytest.mark.parametrize("calibrated", ["tiny"], indirect=True)
def test_int8_predict_matches_jax(calibrated):
    """YOLO.predict with int8 on, against the JAX DetectionPredictor built after
    set_int8_inference(True, scales), on tiny.yaml, whose codes agree on these
    frames, row by row; and the same frames in float give other rows."""
    from bsyolo_tpu.engine.predictor import DetectionPredictor
    from bsyolo_tpu_torch import YOLO
    from bsyolo_tpu_torch.nn.modules import int8_inference, set_int8_inference
    from bsyolo_tpu_torch.utils.weights import scales_from_jax

    rng = np.random.default_rng(12)
    frames = [rng.integers(0, 256, (96, 128, 3), dtype=np.uint8), rng.integers(0, 256, (128, 128, 3), dtype=np.uint8)]
    port = YOLO(GRAPHS["tiny"][0], device="cpu")
    port_module_from_jax(port.model, calibrated["variables"])
    float_rows = [r.boxes.data for r in port.predict(frames, imgsz=IMG, conf=0.001, batch=2)]
    JM.set_int8_inference(True, calibrated["jax_scales"])
    predictor = DetectionPredictor(calibrated["jmodel"], calibrated["spec"], calibrated["variables"], conf=0.001,
                                   imgsz=IMG, batch=2, names=port.names)
    want = [np.asarray(r.boxes.data) for r in predictor(frames)]
    set_int8_inference(port.model, True, scales_from_jax(calibrated["jax_scales"]))
    assert int8_inference(port.model)
    got = [r.boxes.data for r in port.predict(frames, imgsz=IMG, conf=0.001, batch=2)]
    for g, w, f in zip(got, want, float_rows):
        assert g.shape == w.shape and len(g) > 10
        np.testing.assert_array_equal(g[:, 5], w[:, 5])
        np.testing.assert_allclose(g[:, 4], w[:, 4], rtol=1e-5, atol=0)
        np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=1e-3)
        assert g.shape != f.shape or np.abs(g[:, 4] - f[:, 4]).max() > 1e-4  # int8 changed the scores
