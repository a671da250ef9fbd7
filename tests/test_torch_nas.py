"""YOLO-NAS in the PyTorch port against bsyolo_tpu: the blocks, the graphs, the 17-bin decode, the facade.

Blocks at narrow widths with the graph's ReLU (QARepVGGBlock with and without its identity branch, the CSP
layer with and without its intermediates, the stem, a stage, the up-merge, the down stage, the head) fed the
same inputs and seeded weights: within rtol 1e-4. tests/fixtures/tiny_nas.yaml at 96 x 128 px: head maps
(B, 4 * 17 + nc, H, W) within rtol 1e-4. yolo_nas_s, -m and -l: specs, parameter names, shapes and counts equal
JAX's, within 5 % of the published 19.0 M, 51.1 M and 66.9 M. The 17-bin decode and NMS equal JAX's
``detect_postprocess(reg_max=17)`` and differ from a 16-bin decode; ``postprocess_nas`` equals JAX's;
``NAS("x.pt")`` raises. One SGD step (the 17-bin DFL loss): loss items within 2e-3 of JAX's, params, EMA and
BatchNorm statistics at the train-step gate, the momentum slot within 2e-3 of each tensor's scale of JAX's
(``test_sgd_step_matches_jax``); int8 on
the JAX package's quantized set (the 1x1 branches and the head's predictions stay float); ``NAS.predict`` rows
as the JAX facade's.
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
from bsyolo_tpu.nn import modules_nas as JN
from torch_port import (jax_spec, nchw, nhwc, port_batch, port_module_from_jax, port_spec, random_variables,
                        task_batch, to_plain_dict, variable_shapes)

RTOL = 1e-4
CONV_RTOL = 1e-5  # tests/test_torch_int8.py's
# the train step's momentum slot against JAX's, of each tensor's largest JAX element (against a float64 copy of the
# port's graph the port's slot measured 3.8e-4 of that scale and JAX's 9.4e-4); a tensor whose slot is below
# GRAD_FLOOR of the largest (a bias before a BatchNorm: analytically zero, float32 noise on either side) is held
# to GRAD_FLOOR of the largest
SLOT_RTOL, GRAD_FLOOR = 2e-3, 1e-3
TINY_NAS = str(Path(__file__).parent / "fixtures" / "tiny_nas.yaml")
IMG = 96


@pytest.fixture(autouse=True)
def jax_globals_reset():
    """The JAX package's activation and int8 switches are module globals read at trace time: reset them."""
    yield
    JM.set_default_act("silu")
    JM.set_int8_inference(False)
    JM.set_int8_calibration(False)


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=rtol * np.abs(want).max())


def _port(x):
    return [torch.from_numpy(nchw(a)) for a in x] if isinstance(x, list) else torch.from_numpy(nchw(x))


def _blocks():
    from bsyolo_tpu_torch.nn import modules_nas as P

    r = np.random.default_rng(5)
    m = lambda *s: r.uniform(-1, 1, s).astype(np.float32)  # noqa: E731
    return {
        "QARepVGG-identity": (JN.QARepVGGBlock(8, 1), P.QARepVGGBlock(8, 8, 1), m(2, 9, 7, 8)),
        "QARepVGG-stride2": (JN.QARepVGGBlock(16, 2), P.QARepVGGBlock(8, 16, 2), m(2, 9, 7, 8)),
        "CSP": (JN.YoloNASCSPLayer(16, 2, 8), P.YoloNASCSPLayer(12, 16, 2, 8), m(2, 8, 6, 12)),
        "CSP-intermediates": (JN.YoloNASCSPLayer(16, 2, 8, True), P.YoloNASCSPLayer(12, 16, 2, 8, True),
                              m(2, 8, 6, 12)),
        "stem": (JN.YoloNASStem(8), P.YoloNASStem(3, 8), m(2, 16, 12, 3)),
        "stage": (JN.YoloNASStage(16, 2, 8, True), P.YoloNASStage(8, 16, 2, 8, True), m(2, 10, 8, 8)),
        "up-merge": (JN.NASUpMerge(16, 1, 8), P.NASUpMerge((24, 12, 8), 16, 1, 8),
                     [m(2, 4, 3, 24), m(2, 8, 6, 12), m(2, 16, 12, 8)]),
        "down": (JN.NASDown(16, 1, 8), P.NASDown((12, 8), 16, 1, 8), [m(2, 8, 6, 12), m(2, 4, 3, 8)]),
        "head": (JN.NASDetect(3, (8, 16), (8, 16), inter=(8, 16)), P.NASDetect(3, (8, 16), (8, 16), (8, 16)),
                 [m(2, 8, 6, 8), m(2, 4, 3, 16)]),
    }


@pytest.mark.parametrize("name", list(_blocks()))
def test_block_matches_jax(name):
    from bsyolo_tpu_torch.nn.modules import set_activation

    jmod, pmod, x = _blocks()[name]
    JM.set_default_act("relu")
    xj = [jnp.asarray(a) for a in x] if isinstance(x, list) else jnp.asarray(x)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), xj))
    v = to_plain_dict(random_variables(shapes, seed=len(name)))
    want = jmod.apply(v, xj)
    set_activation(pmod, "relu")
    port_module_from_jax(pmod, v)
    with torch.no_grad():
        got = pmod(_port(x))
    if name == "head":
        assert [g.shape[1] for g in got] == [4 * 17 + 3] * 2
        for g, w in zip(got, want):
            _close(nhwc(g.numpy()), w)
    else:
        _close(nhwc(got.numpy()), want)


@pytest.fixture(scope="module")
def tiny():
    """(JAX DetectionGraph, seeded variables, the port's graph with them) of tiny_nas.yaml."""
    from bsyolo_tpu.nn.model import DetectionGraph

    from bsyolo_tpu_torch.nn.model import build_model

    jm = DetectionGraph(jax_spec(TINY_NAS))
    v = to_plain_dict(random_variables(variable_shapes(jm, (1, IMG, IMG, 3)), seed=1))
    pm = port_module_from_jax(build_model(port_spec(TINY_NAS), "cpu"), v)
    JM.set_default_act("silu")  # variable_shapes traced the ReLU graph
    return jm, v, pm


@pytest.fixture(scope="module")
def tiny_maps(tiny):
    """Both packages' head maps of one seeded batch at 96 x 128 px: (JAX NHWC levels, port NCHW levels)."""
    jm, v, pm = tiny
    x = np.random.default_rng(2).uniform(0, 1, (2, IMG, 128, 3)).astype(np.float32)
    want = jm.apply(v, jnp.asarray(x))
    JM.set_default_act("silu")
    with torch.no_grad():
        got = pm(_port(x))
    return want, got


def test_graph_head_maps_match_jax(tiny, tiny_maps):
    _, _, pm = tiny
    want, got = tiny_maps
    assert pm.spec.act == "relu" and pm.spec.reg_max == 17 and pm.spec.head_strides == (8, 16, 32)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape[1] == 4 * 17 + pm.spec.nc
        _close(nhwc(g.numpy()), w)


@pytest.mark.parametrize("name,published_m", [("yolo_nas_s", 19.0), ("yolo_nas_m", 51.1), ("yolo_nas_l", 66.9)])
def test_graphs_are_jax_within_the_published_budget(name, published_m):
    """tests/test_fastsam_nas.py's budgets, counted on the port's graph."""
    from bsyolo_tpu_torch import NAS
    from bsyolo_tpu_torch.nn.model import count_params
    from zoo_port import assert_graph_is_jax

    assert_graph_is_jax(name + ".yaml")
    JM.set_default_act("silu")
    m = NAS(name, device="cpu")
    n = count_params(m.model) / 1e6
    print(f"{name}: {n:.3f} M parameters")
    assert m.spec.reg_max == 17 and m.spec.head_strides == (8, 16, 32) and m.spec.act == "relu"
    assert abs(n - published_m) / published_m < 0.05, (name, n)


def test_17_bin_decode_matches_jax(tiny, tiny_maps):
    """The predictor's and validator's decode of the NAS head: the plain 17-bin decode and NMS, equal to JAX's
    ``detect_postprocess(reg_max=17)``; a 16-bin decode of the same maps differs."""
    from bsyolo_tpu.kernels.postprocess import detect_postprocess as jpost

    from bsyolo_tpu_torch.kernels.postprocess import detect_postprocess

    _, _, pm = tiny
    want_maps, got_maps = tiny_maps
    kw = dict(conf_thres=0.0001, iou_thres=0.7, max_det=30)
    strides, nc = pm.spec.head_strides, pm.spec.nc
    want = np.asarray(jpost(want_maps, strides, nc, reg_max=17, **kw))
    got = detect_postprocess(got_maps, strides, nc, reg_max=pm.spec.reg_max, **kw).numpy()
    assert got.shape == want.shape == (2, 30, 6) and (want[..., 4] > 0).sum() >= 20
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    bad = detect_postprocess(got_maps, strides, nc, reg_max=16, **kw).numpy()
    assert not np.allclose(bad, want, atol=1e-3)


def test_postprocess_nas_matches_jax():
    from bsyolo_tpu.models.nas import postprocess_nas as jpost

    from bsyolo_tpu_torch.models.nas import postprocess_nas

    rng = np.random.default_rng(4)
    xy = rng.uniform(0, 500, (2, 400, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 90, (2, 400, 2))], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (2, 400, 5)).astype(np.float32)
    for conf, iou in ((0.25, 0.7), (0.6, 0.5)):
        want = np.asarray(jpost(jnp.asarray(boxes), jnp.asarray(scores), conf, iou, 100))
        got = postprocess_nas(torch.from_numpy(boxes), torch.from_numpy(scores), conf, iou, 100).numpy()
        assert got.shape == want.shape == (2, 100, 6)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


def test_nas_refuses_pickled_checkpoints():
    from bsyolo_tpu_torch import NAS

    with pytest.raises(NotImplementedError, match="super-gradients"):
        NAS("yolo_nas_s.pt")
    with pytest.raises(NotImplementedError):
        NAS("x.pt")
    assert NAS(TINY_NAS, device="cpu").spec.head.module == "NASDetect"


def test_sgd_step_matches_jax(tiny):
    """One SGD step with the 17-bin DFL loss from the same weights and batch, held to JAX's step: loss items within
    2e-3; BatchNorm statistics at tests/test_torch_train_step.py's gate; the momentum slot (the
    clipped gradient plus weight decay) tensor by tensor within SLOT_RTOL of that tensor's largest JAX element, and
the params' and EMA's moves in this step within the same share of the move JAX's slot made.
    Through 14 train-mode BatchNorms and ReLUs of QARepVGG blocks with saturated class logits the two float32
    gradients part by more than that gate's 1e-4 of the whole slot (ROADMAP, known differences)."""
    from bsyolo_tpu.engine.optim import OptimConfig as JOpt
    from bsyolo_tpu.engine.train_step import StepConfig as JStep, init_train_state as jinit, make_train_step as jmake
    from bsyolo_tpu.losses import DetectionLossConfig as JLoss

    from bsyolo_tpu_torch.engine.optim import OptimConfig
    from bsyolo_tpu_torch.engine.train_step import StepConfig, init_train_state, make_train_step, task_criterion
    from bsyolo_tpu_torch.losses import DetectionLossConfig
    from bsyolo_tpu_torch.nn.model import build_model
    from bsyolo_tpu_torch.utils.weights import state_dict_from_jax, train_state_to_jax

    jm, v, _ = tiny
    spec = jax_spec(TINY_NAS)
    common = dict(batch_size=2, nb=5, nw=2, use_adamw=False, weight_decay=0.0005)
    okw = dict(name="SGD", lr0=0.01, epochs=4, nbs=2, warmup_bias_lr=0.1)
    jcfg = JStep(loss=JLoss(nc=spec.nc, strides=spec.head_strides, reg_max=17), optim=JOpt(**okw), **common)
    jstep = jmake(jm, jcfg)
    jstate = jinit({k: jax.tree_util.tree_map(jnp.asarray, x) for k, x in v.items()}, jcfg)
    pm = build_model(port_spec(TINY_NAS), "cpu")
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    pcfg = StepConfig(loss=DetectionLossConfig(nc=spec.nc, strides=spec.head_strides, reg_max=pm.spec.reg_max),
                      optim=OptimConfig(**okw), **common)
    pstate = init_train_state(pm, pcfg)
    pstep = make_train_step(pm, pcfg, *task_criterion(pm.spec))
    batch = {k: x for k, x in task_batch(7, 2, 64, 6, spec.nc, "detect").items() if k != "keypoints"}
    jstate, jmet = jstep(jstate, {k: jnp.asarray(x) for k, x in batch.items()})
    want = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), jstate)
    pbatch = {k: torch.as_tensor(x).long() if k == "cls" else torch.as_tensor(x) for k, x in port_batch(batch).items()}
    JM.set_default_act("silu")
    pstate, pmet = pstep(pstate, pbatch)
    for k in ("loss", "box_loss", "cls_loss", "dfl_loss"):
        np.testing.assert_allclose(float(pmet[k]), float(jmet[k]), rtol=2e-3, err_msg=k)
    got = train_state_to_jax(pstate, want)
    flat = lambda tree: dict(jax.tree_util.tree_flatten_with_path(to_plain_dict(tree))[0])  # noqa: E731
    for path, g in flat(got["batch_stats"]).items():
        np.testing.assert_allclose(g, flat(want.batch_stats)[path], rtol=1e-4, atol=1e-6,
                                   err_msg="batch_stats" + jax.tree_util.keystr(path))
    g_slot, w_slot = flat(got["slot0"]), flat(want.slot0)
    whole = max(float(np.abs(w).max()) for w in w_slot.values())
    # each slot tensor's scale: its largest element, at least GRAD_FLOOR of the largest in the whole slot
    scale = {k: max(float(np.abs(w).max()), GRAD_FLOOR * whole) for k, w in w_slot.items()}
    gap, where = max((float(np.abs(g_slot[k] - w).max()) / scale[k], jax.tree_util.keystr(k)) for k, w in w_slot.items())
    print(f"slot0: {gap:.3g} of the tensor's scale from JAX's at {where}")
    assert gap <= SLOT_RTOL, where
    # the params and EMA moved by a multiple of the slot (the group's learning rate, Nesterov's momentum, the EMA's
    # decay): each move held to SLOT_RTOL of its slot's scale times that multiple, as JAX's step took it
    start = flat(v["params"])
    for field in ("params", "ema_params"):
        for k, g in flat(got[field]).items():
            w_move, g_move = np.asarray(flat(getattr(want, field))[k]) - start[k], np.asarray(g) - start[k]
            top = float(np.abs(w_slot[k]).max())
            tol = SLOT_RTOL * float(np.abs(w_move).max()) * scale[k] / top if top else 0.0
            np.testing.assert_allclose(g_move, w_move, rtol=0, atol=tol + 1e-6, err_msg=field + jax.tree_util.keystr(k))


def test_int8_follows_jitted_jax(tiny):
    """The quantized set is JAX's (every ConvBN: QARepVGG's 3x3 branch among them; its 1x1 branch, the
    up-merge's transposed conv and the head's predictions stay float): scales within 1e-5, and every quantized
    conv, fed its jitted JAX ConvBN's input, gives that ConvBN's output within CONV_RTOL."""
    import flax.linen as nn

    from bsyolo_tpu.nn.quant import calibrate_int8 as jax_calibrate

    from bsyolo_tpu_torch.nn.modules import quantizable_convs, scale_key, set_int8_inference
    from bsyolo_tpu_torch.nn.quant import calibrate_int8
    from bsyolo_tpu_torch.utils.weights import scales_from_jax

    jm, v, pm = tiny
    brng = np.random.default_rng(7)
    batches = [brng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32) for _ in range(2)]
    jax_scales = jax_calibrate(jm, v, [jnp.asarray(b) for b in batches])
    scales = calibrate_int8(pm, [torch.from_numpy(nchw(b)) for b in batches])
    want_scales = scales_from_jax(jax_scales)
    assert set(scales) == set(want_scales) == {scale_key(n) for n, _ in quantizable_convs(pm)}
    assert any("branch_3x3" in k for k in scales)
    assert not any(s in k for k in scales for s in ("branch_1x1", "cls_pred", "reg_pred", "upsample"))
    np.testing.assert_allclose([scales[k] for k in sorted(want_scales)],
                               [want_scales[k] for k in sorted(want_scales)], rtol=1e-5)

    def run(variables, xx):
        convs = {}

        def record(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if isinstance(context.module, JM.ConvBN) and context.method_name == "__call__":
                convs["/".join(context.module.scope.path) + "/conv"] = (args[0], out)
            return out

        with nn.intercept_methods(record):
            return jm.apply(variables, xx, train=False), convs

    x = np.random.default_rng(8).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    JM.set_int8_inference(True, jax_scales)
    _, jconvs = jax.jit(run)(v, jnp.asarray(x))
    JM.set_int8_inference(False)
    convs = dict(zip(scales_from_jax(dict.fromkeys(jconvs, 0.0)), jconvs.values()))
    set_int8_inference(pm, True, want_scales)
    try:
        assert {type(m.act).__name__ for _, m in quantizable_convs(pm)} == {"ReLU", "Identity"}
        with torch.no_grad():
            for conv_name, m in quantizable_convs(pm):
                xin, want = (nchw(a) for a in convs[scale_key(conv_name)])
                got = m(torch.tensor(xin)).numpy()
                np.testing.assert_allclose(got, want, rtol=CONV_RTOL, atol=CONV_RTOL * np.abs(want).max(),
                                           err_msg=conv_name)
    finally:
        set_int8_inference(pm, False)


def test_predict_matches_the_jax_facade(tiny):
    from bsyolo_tpu import YOLO as JaxYOLO

    from bsyolo_tpu_torch import NAS
    from zoo_port import paired_rows

    _, v, _ = tiny
    rng = np.random.default_rng(8)
    frames = [rng.integers(0, 256, (72, 96, 3), dtype=np.uint8), rng.integers(0, 256, (96, 96, 3), dtype=np.uint8)]
    jy = JaxYOLO(TINY_NAS)
    jy.variables = v
    port = NAS(TINY_NAS, device="cpu")
    port_module_from_jax(port.model, v)
    kw = dict(imgsz=IMG, conf=0.3, batch=2)
    want = [np.asarray(r.boxes.data) for r in jy.predict(frames, **kw)]
    got = [r.boxes.data for r in port.predict(frames, **kw)]
    for g, w in zip(got, want):
        assert len(g) == len(w) >= 5 and len(paired_rows(g, w)) == len(w)


def test_checkpoints_load_in_both_directions(tiny, tmp_path):
    """A port ``.ckpt`` of the NAS graph (``bottlenecks_{i}_cv{k}`` paths, plain 1x1 convs, the transposed conv)
    loads into the JAX facade with every variable equal, and a JAX one into the port's; the bundled graph files
    are the JAX package's."""
    from bsyolo_tpu import YOLO as JaxYOLO

    from bsyolo_tpu_torch import NAS, YOLO
    from bsyolo_tpu_torch.cfg import CFG_ROOT
    from bsyolo_tpu_torch.utils.weights import state_dict_from_jax
    from zoo_port import leaves

    _, v, pm = tiny
    port = NAS(TINY_NAS, device="cpu")
    port_module_from_jax(port.model, v)
    port.save(tmp_path / "port.ckpt")
    jy = JaxYOLO(str(tmp_path / "port.ckpt"))
    got, want = dict(leaves(to_plain_dict(jy.variables))), dict(leaves(v))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg="/".join(k))
    jy = JaxYOLO(TINY_NAS)  # a JAX facade built from a checkpoint saves the checkpoint's path as its graph
    jy.variables = v
    jy.save(str(tmp_path / "jax.ckpt"))
    back = YOLO(tmp_path / "jax.ckpt", device="cpu")
    assert back.spec.reg_max == 17
    sd, ref = back.model.state_dict(), state_dict_from_jax(v)
    assert {k for k in sd if not k.endswith("num_batches_tracked")} == set(ref)
    for k, t in ref.items():
        torch.testing.assert_close(sd[k], t, rtol=0, atol=0, msg=k)
    for name in ("yolo_nas_s", "yolo_nas_m", "yolo_nas_l"):
        jax_file = Path(__file__).resolve().parents[1] / "bsyolo_tpu" / "cfg" / "models" / "nas" / f"{name}.yaml"
        assert (CFG_ROOT / "models" / "nas" / f"{name}.yaml").read_bytes() == jax_file.read_bytes()


def test_index_layer_matches_jax(tmp_path):
    """The JAX graph's ``Index`` layer (the last of its inputs; parsed with the multi-input NAS layers): the spec,
    parameters and head maps of a graph that routes through one equal JAX's."""
    from bsyolo_tpu.nn.model import DetectionGraph

    from bsyolo_tpu_torch.nn.model import build_model
    from zoo_port import assert_graph_is_jax

    path = tmp_path / "index.yaml"
    path.write_text("nc: 2\nbackbone:\n  - [-1, 1, Conv, [8, 3, 2]]\n  - [-1, 1, Conv, [16, 3, 2]]\n"
                    "  - [-1, 1, Conv, [16, 3, 2]]\n  - [[1, 2], 1, Index, []]\n  - [-1, 1, Conv, [32, 3, 2]]\n"
                    "head:\n  - [[3, 4], 1, Detect, [nc]]\n")
    assert_graph_is_jax(str(path))
    jm = DetectionGraph(jax_spec(str(path)))
    v = to_plain_dict(random_variables(variable_shapes(jm, (1, 64, 64, 3)), seed=4))
    pm = port_module_from_jax(build_model(port_spec(str(path)), "cpu"), v)
    assert pm.spec.layers[3].module == "Index" and pm.spec.layers[3].c2 == 16
    x = np.random.default_rng(5).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        got = pm(_port(x))
    for g, w in zip(got, jm.apply(v, jnp.asarray(x))):
        _close(nhwc(g.numpy()), w)
