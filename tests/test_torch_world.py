"""YOLO-World in the PyTorch port against bsyolo_tpu: the blocks, the graph with its text, the facade's text.

Blocks at narrow widths (MaxSigmoidAttnBlock with and without its embedding conv, C2fAttn, ImagePoolingAttn,
ContrastiveHead, BNContrastiveHead) and ImagePoolingAttn's pooling on maps whose sides 3 does not divide, fed the
same inputs and seeded weights: within rtol 1e-4. Whole graphs (tests/fixtures/tinyworld.yaml, which is
yolov8-worldv2's shape, and ``TINY_IPA``, yolov8-world's with ImagePoolingAttn and the plain contrastive head)
at 96 x 128 px: head maps within rtol 1e-4 with a text of batch 1 and of batch 2, and with the placeholder
text, which equals JAX's. yolov8s-world and -worldv2 at full width: specs, parameter names, shapes and counts
equal JAX's. ``set_classes`` with an array, a list, a dict and both ``.npz`` layouts (a "/" synonym among the
names) and with none (hashed n-grams, byte-equal to JAX's): the text and the predict rows equal the JAX
facade's. ``half=True`` keeps the text: head maps within tests/test_torch_bf16.py's graph gate. Int8: the
calibrated scales and every quantized conv's output as JAX's (tests/test_torch_int8.py's gates), with the
bound text seen in calibration; the contrastive branch's 1x1 convs stay float.
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
from torch_port import (jax_spec, nchw, nhwc, port_module_from_jax, port_spec, random_variables, to_plain_dict,
                        variable_shapes)

RTOL = 1e-4
GRAPH_NORM, F32_GAP = 7.5e-3, 1e-3  # tests/test_torch_bf16.py's graph gates
CONV_RTOL = 1e-5  # tests/test_torch_int8.py's
TINY_WORLD = str(Path(__file__).parent / "fixtures" / "tinyworld.yaml")
# yolov8-world.yaml's shape at toy width: C2fAttn, ImagePoolingAttn over two levels, WorldDetect without BatchNorm
TINY_IPA = """nc: 3
backbone:
  - [-1, 1, Conv, [16, 3, 2]]
  - [-1, 1, Conv, [32, 3, 2]]
  - [-1, 1, C2f, [32, True]]
  - [-1, 1, Conv, [32, 3, 2]]
  - [-1, 1, C2f, [32, True]]
  - [-1, 1, Conv, [64, 3, 2]]
  - [-1, 1, SPPF, [64, 5]]
head:
  - [-1, 1, nn.Upsample, [None, 2, "nearest"]]
  - [[-1, 4], 1, Concat, [1]]
  - [-1, 1, C2fAttn, [32, 32, 2]]
  - [[9, 6], 1, ImagePoolingAttn, [32]]
  - [9, 1, Conv, [32, 3, 2]]
  - [[-1, 6], 1, Concat, [1]]
  - [-1, 1, C2fAttn, [64, 32, 2]]
  - [[9, 13], 1, WorldDetect, [nc, 512, False]]
"""
IMG = 96


@pytest.fixture(autouse=True)
def jax_modes_off():
    """The JAX package's int8 switches are module globals read at trace time: reset them."""
    yield
    JM.set_int8_inference(False)
    JM.set_int8_calibration(False)


@pytest.fixture(scope="module")
def tiny_ipa(tmp_path_factory):
    path = tmp_path_factory.mktemp("world") / "tinyipa.yaml"
    path.write_text(TINY_IPA)
    return str(path)


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=rtol * np.abs(want).max())


def _block(jmod, pmod, inputs, seed):
    """Seeded variables of ``jmod`` on ``inputs`` (NHWC), loaded into ``pmod``: (JAX output, variables)."""
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *inputs))
    v = to_plain_dict(random_variables(shapes, seed))
    port_module_from_jax(pmod, v)
    return jmod.apply(v, *inputs), v


def _graph(name, seed=1):
    """(JAX DetectionGraph, its seeded variables, the port's graph with them)."""
    from bsyolo_tpu.nn.model import DetectionGraph

    from bsyolo_tpu_torch.nn.model import build_model

    jm = DetectionGraph(jax_spec(name))
    v = to_plain_dict(random_variables(variable_shapes(jm, (1, IMG, IMG, 3)), seed))
    return jm, v, port_module_from_jax(build_model(port_spec(name), "cpu"), v)


@pytest.mark.parametrize("hw", [(7, 5), (11, 10), (3, 3), (2, 8), (13, 16)])
def test_adaptive_max_pool2d_matches_jax(hw):
    """ImagePoolingAttn pools with ``F.adaptive_max_pool2d``, whose regions are the JAX function's."""
    x = np.random.default_rng(hw[0] * 31 + hw[1]).normal(size=(2, *hw, 5)).astype(np.float32)
    want = np.asarray(JM.adaptive_max_pool2d(jnp.asarray(x), 3))
    got = torch.nn.functional.adaptive_max_pool2d(torch.from_numpy(nchw(x)), 3)
    np.testing.assert_array_equal(nhwc(got.numpy()), want)


def _text(rng, b, k, d=512):
    return rng.normal(size=(b, k, d)).astype(np.float32)


@pytest.mark.parametrize("c1,ec", [(12, 8), (8, 8)], ids=["embed-conv", "no-embed-conv"])
def test_max_sigmoid_attn_block_matches_jax(c1, ec, rng):
    from bsyolo_tpu_torch.nn.modules import MaxSigmoidAttnBlock

    x, g = rng.uniform(-1, 1, (2, 9, 7, c1)).astype(np.float32), _text(rng, 2, 4)
    pm = MaxSigmoidAttnBlock(c1, 16, 2, ec, 512)
    assert (pm.ec is None) == (c1 == ec)
    want, _ = _block(JM.MaxSigmoidAttnBlock(16, 2, ec, 512), pm, (jnp.asarray(x), jnp.asarray(g)), seed=2)
    with torch.no_grad():
        got = pm(torch.from_numpy(nchw(x)), torch.from_numpy(g))
    _close(nhwc(got.numpy()), want)


def test_c2f_attn_matches_jax(rng):
    from bsyolo_tpu_torch.nn.modules import C2fAttn

    x, g = rng.uniform(-1, 1, (2, 10, 8, 24)).astype(np.float32), _text(rng, 2, 3)
    pm = C2fAttn(24, 32, 2, 16, 2)
    want, _ = _block(JM.C2fAttn(32, 2, 16, 2), pm, (jnp.asarray(x), jnp.asarray(g)), seed=3)
    with torch.no_grad():
        got = pm(torch.from_numpy(nchw(x)), torch.from_numpy(g))
    _close(nhwc(got.numpy()), want)


def test_image_pooling_attn_matches_jax(rng):
    from bsyolo_tpu_torch.nn.modules import ImagePoolingAttn

    feats = [rng.uniform(-1, 1, (2, 11, 7, 16)).astype(np.float32), rng.uniform(-1, 1, (2, 5, 4, 24)).astype(np.float32)]
    text = _text(rng, 2, 6)
    pm = ImagePoolingAttn(32, (16, 24))
    want, _ = _block(JM.ImagePoolingAttn(32, (16, 24)), pm, ([jnp.asarray(f) for f in feats], jnp.asarray(text)), 4)
    with torch.no_grad():
        got = pm([torch.from_numpy(nchw(f)) for f in feats], torch.from_numpy(text))
    assert got.shape == (2, 6, 512)
    _close(got.numpy(), want)


@pytest.mark.parametrize("bn", [False, True], ids=["ContrastiveHead", "BNContrastiveHead"])
def test_contrastive_heads_match_jax(bn, rng):
    from bsyolo_tpu_torch.nn.modules import BNContrastiveHead, ContrastiveHead

    x, w = rng.uniform(-1, 1, (2, 6, 5, 32)).astype(np.float32), _text(rng, 2, 7, 32)
    pm, jmod = (BNContrastiveHead(32), JM.BNContrastiveHead(32)) if bn else (ContrastiveHead(), JM.ContrastiveHead())
    want, v = _block(jmod, pm, (jnp.asarray(x), jnp.asarray(w)), seed=5)
    assert v["params"]["logit_scale"].shape == () and pm.logit_scale.shape == ()
    with torch.no_grad():
        got = pm(torch.from_numpy(nchw(x)), torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == (2, 7, 6, 5)
    _close(nhwc(got.numpy()), want)


@pytest.mark.parametrize("which", ["tinyworld", "tiny_ipa"])
def test_graph_head_maps_match_jax(which, tiny_ipa, rng):
    """Head maps (B, 64 + K, H, W) with the placeholder, and bound texts of batch 1 (broadcast) and of batch 2."""
    from bsyolo_tpu_torch.nn.model import bind_text

    name = TINY_WORLD if which == "tinyworld" else tiny_ipa
    jm, v, pm = _graph(name)
    x = rng.uniform(0, 1, (2, IMG, 128, 3)).astype(np.float32)
    xt = torch.from_numpy(nchw(x))
    placeholder = np.random.default_rng(0).normal(size=(1, pm.spec.nc, 512)).astype(np.float32)
    np.testing.assert_array_equal(pm.txt_feats.numpy(), placeholder)
    assert "txt_feats" not in pm.state_dict()
    for text in (None, _text(rng, 1, 5), _text(rng, 2, 4)):
        want = jm.apply(v, jnp.asarray(x)) if text is None else jm.apply(v, jnp.asarray(x), text=jnp.asarray(text))
        if text is not None:
            bind_text(pm, text)
        with torch.no_grad():
            got = pm(xt)
        k = pm.spec.nc if text is None else text.shape[1]
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g.shape[1] == 64 + k
            _close(nhwc(g.numpy()), w)


@pytest.mark.parametrize("name", ["yolov8s-world.yaml", "yolov8s-worldv2.yaml"])
def test_full_width_graphs_are_jax(name):
    """Spec, parameter names, shapes and counts of the full-width graphs (scale s, nc 80) equal JAX's."""
    from bsyolo_tpu.nn.model import DetectionGraph, count_params as jax_count

    from bsyolo_tpu_torch.nn.model import build_model, count_params
    from zoo_port import assert_graph_is_jax

    assert_graph_is_jax(name)
    spec = port_spec(name)
    assert spec.scale == "s" and spec.world and spec.reg_max == 16
    n = count_params(build_model(spec, "cpu"))
    assert n == jax_count(variable_shapes(DetectionGraph(jax_spec(name)), (1, 64, 64, 3)))
    print(f"{name}: {n:,} parameters")


def test_hashed_text_embeddings_are_jax_bytes():
    from bsyolo_tpu.utils import text_embed as J

    from bsyolo_tpu_torch.utils import text_embed as P

    names = ["person", "bus", "Traffic Light", "dog/canine", "", "a", "évent"]
    for seed in (0, 7):
        got, want = P.hashed_text_embeddings(names, seed=seed), J.hashed_text_embeddings(names, seed=seed)
        assert got.dtype == want.dtype == np.float32 and got.tobytes() == want.tobytes()
    assert P.hashed_text_embeddings(["x"], dim=64).tobytes() == J.hashed_text_embeddings(["x"], dim=64).tobytes()


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """A {name: vector} table and its two .npz layouts."""
    rng = np.random.default_rng(11)
    vecs = {n: rng.normal(size=512).astype(np.float32) for n in ("person", "bus", "dog", "canine")}
    d = tmp_path_factory.mktemp("tables")
    np.savez(d / "per_name.npz", **vecs)
    np.savez(d / "bulk.npz", names=np.asarray(list(vecs)), vectors=np.stack(list(vecs.values())))
    return vecs, str(d / "per_name.npz"), str(d / "bulk.npz")


def test_text_tables_resolve_as_jax(tables):
    from bsyolo_tpu.utils import text_embed as J

    from bsyolo_tpu_torch.utils import text_embed as P

    vecs, per_name, bulk = tables
    names = ["person", "bus", "dog/canine"]
    for src in (vecs, per_name, bulk):
        np.testing.assert_array_equal(P.resolve_text_embeddings(names, src), J.resolve_text_embeddings(names, src))
    assert set(P.load_text_embeddings(per_name)) == set(P.load_text_embeddings(bulk)) == set(vecs)
    with pytest.raises(KeyError, match="zebra"):
        P.resolve_text_embeddings(["zebra"], per_name)


@pytest.fixture(scope="module")
def facades(tiny_ipa):
    """The JAX facade and the port's on one set of seeded weights of the TINY_IPA graph."""
    from bsyolo_tpu import YOLOWorld as JaxWorld

    from bsyolo_tpu_torch import YOLOWorld

    _, v, _ = _graph(tiny_ipa, seed=6)
    jy = JaxWorld(tiny_ipa)
    jy.variables = v
    port = YOLOWorld(tiny_ipa, device="cpu")
    port_module_from_jax(port.model, v)
    return jy, port


FRAMES = [np.random.default_rng(20 + i).integers(0, 256, (80, 96, 3), dtype=np.uint8) for i in range(2)]


@pytest.mark.parametrize("kind", ["array", "list", "dict", "per_name_npz", "bulk_npz", "hashed"])
def test_set_classes_predicts_as_the_jax_facade(kind, facades, tables):
    from zoo_port import paired_rows

    jy, port = facades
    vecs, per_name, bulk = tables
    names = ["person", "bus", "dog/canine"]
    direct = np.stack([vecs["person"], vecs["bus"], (vecs["dog"] + vecs["canine"]) / 2])
    emb = {"array": direct, "list": direct.tolist(), "dict": vecs, "per_name_npz": per_name, "bulk_npz": bulk,
           "hashed": None}[kind]
    jy.set_classes(names, embeddings=emb)
    port.set_classes(names, embeddings=emb)
    np.testing.assert_allclose(port.txt_feats, np.asarray(jy.txt_feats), rtol=1e-6, atol=1e-7)
    assert port.names == jy.names and port.spec.nc == 3
    np.testing.assert_array_equal(port.model.txt_feats.numpy(), port.txt_feats)
    kw = dict(imgsz=IMG, conf=0.25, batch=2)
    want = [np.asarray(r.boxes.data) for r in jy.predict(FRAMES, **kw)]
    got = [r.boxes.data for r in port.predict(FRAMES, **kw)]
    for g, w in zip(got, want):
        assert len(g) == len(w) >= 5 and len(paired_rows(g, w)) == len(w)
        assert set(g[:, 5].astype(int)) <= {0, 1, 2}


def test_half_keeps_the_text(facades, rng):
    """The bf16 copy (``half_graph``) reads the bound text: head maps within the bf16 graph gate of the JAX
    facade's bf16 graph with the same text, away from float32, and away from another text's maps."""
    from bsyolo_tpu_torch.nn.model import bind_text

    jy, port = facades
    port.set_classes(["a", "b", "c", "d"], embeddings=_text(rng, 1, 4)[0])
    jy.set_classes(["a", "b", "c", "d"], embeddings=np.asarray(port.txt_feats[0]))
    jmodel, jvars = jy._bf16_graph(IMG)  # the raw bf16 graph: the JAX facade binds its text in predict
    x = rng.uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    want = jax.jit(lambda v, x, t: jmodel.apply(v, x, train=False, text=t))(jvars, jnp.asarray(x), jy.txt_feats)
    xt = torch.from_numpy(nchw(x))
    half = port.half_graph()
    assert half.txt_feats is port.model.txt_feats
    with torch.no_grad():
        got, f32 = half(xt), port.model(xt)
        other = bind_text(half, np.random.default_rng(0).normal(size=(1, 4, 512)))(xt)
    for g, f, w, o in zip(got, f32, want, other):
        g64, w64 = g.double().numpy(), nchw(np.asarray(w, np.float32)).astype(np.float64)
        err = np.linalg.norm(g64 - w64) / np.linalg.norm(w64)
        gap = np.linalg.norm(g64 - f.double().numpy()) / np.linalg.norm(f.double().numpy())
        text_gap = np.abs(g64[:, 64:] - o.double().numpy()[:, 64:]).max()
        print(f"level {tuple(g.shape)}: {err:.3g} of the JAX bf16 level's norm, {gap:.3g} from float32")
        assert g.dtype == torch.bfloat16 and err <= GRAPH_NORM and gap > F32_GAP and text_gap > 1e-2
    port.set_classes(["a", "b"], embeddings=_text(rng, 1, 2)[0])
    assert port.half_graph() is not half and port.half_graph().txt_feats.shape == (1, 2, 512)


def test_int8_follows_jitted_jax_with_the_text(tiny_ipa):
    """Calibration sees the bound text (scales within 1e-5 of JAX's with its TextConditioned graph); every
    quantized conv (ConvBN only: WorldDetect's 1x1 convs, ImagePoolingAttn's projections stay float) gives its
    jitted JAX ConvBN's output within CONV_RTOL when fed that conv's input."""
    import flax.linen as nn

    from bsyolo_tpu.nn.model import TextConditioned
    from bsyolo_tpu.nn.quant import calibrate_int8 as jax_calibrate

    from bsyolo_tpu_torch.nn.model import bind_text
    from bsyolo_tpu_torch.nn.modules import quantizable_convs, scale_key, set_int8_inference
    from bsyolo_tpu_torch.nn.quant import calibrate_int8
    from bsyolo_tpu_torch.utils.weights import scales_from_jax

    jm, v, pm = _graph(tiny_ipa, seed=7)
    text = _text(np.random.default_rng(9), 1, 3)
    bind_text(pm, text[0])
    brng = np.random.default_rng(7)
    batches = [brng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32) for _ in range(2)]
    jax_scales = jax_calibrate(TextConditioned(jm, jnp.asarray(text)), v, [jnp.asarray(b) for b in batches])
    scales = calibrate_int8(pm, [torch.from_numpy(nchw(b)) for b in batches])
    want_scales = scales_from_jax(jax_scales)
    assert set(scales) == set(want_scales) == {scale_key(n) for n, _ in quantizable_convs(pm)}
    assert not any(".cv3." in k and k.endswith(".2.conv") or "projections" in k for k in scales)
    np.testing.assert_allclose([scales[k] for k in sorted(want_scales)],
                               [want_scales[k] for k in sorted(want_scales)], rtol=1e-5)
    placeholder_scales = calibrate_int8(pm, [torch.from_numpy(nchw(b)) for b in batches])
    bind_text(pm, np.random.default_rng(0).normal(size=(1, 3, 512)))
    assert calibrate_int8(pm, [torch.from_numpy(nchw(b)) for b in batches]) != placeholder_scales
    bind_text(pm, text)

    def run(variables, xx):
        convs = {}

        def record(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if isinstance(context.module, JM.ConvBN) and context.method_name == "__call__":
                convs["/".join(context.module.scope.path) + "/conv"] = (args[0], out)
            return out

        with nn.intercept_methods(record):
            return jm.apply(variables, xx, train=False, text=jnp.asarray(text)), convs

    x = np.random.default_rng(8).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    JM.set_int8_inference(True, jax_scales)
    _, jconvs = jax.jit(run)(v, jnp.asarray(x))
    JM.set_int8_inference(False)
    convs = dict(zip(scales_from_jax(dict.fromkeys(jconvs, 0.0)), jconvs.values()))
    set_int8_inference(pm, True, want_scales)
    try:
        with torch.no_grad():
            for conv_name, m in quantizable_convs(pm):
                xin, want = (nchw(a) for a in convs[scale_key(conv_name)])
                got = m(torch.tensor(xin)).numpy()
                np.testing.assert_allclose(got, want, rtol=CONV_RTOL, atol=CONV_RTOL * np.abs(want).max(),
                                           err_msg=conv_name)
    finally:
        set_int8_inference(pm, False)


def test_cli_predicts_a_world_graph(tmp_path, capsys):
    """``predict model=yolov8s-world.yaml``: the CLI builds the full-width graph (placeholder text, nc 80)."""
    from bsyolo_tpu_torch.cli import main
    from bsyolo_tpu_torch.data.imread import imwrite_png

    imwrite_png(tmp_path / "f.png", FRAMES[0])
    assert main(["predict", "model=yolov8s-world.yaml", f"source={tmp_path / 'f.png'}", "imgsz=64", "conf=0.5",
                 "device=cpu", f"project={tmp_path}", "name=pred", "save=False"]) == 0
    assert "1 frames" in capsys.readouterr().out


def test_val_reads_the_bound_text(facades, tmp_path):
    """``val`` of a YOLOWorld after ``set_classes`` runs the bound text (K class channels), and its metrics equal the
    JAX package's for that text (a JAX ``YOLO`` of the port's checkpoint, whose graph is ``TextConditioned``). The
    JAX ``YOLOWorld.val`` itself runs the placeholder text (ROADMAP, faults of the JAX package)."""
    from bsyolo_tpu import YOLO as JaxYOLO

    from test_torch_data import write_dataset

    _, port = facades
    data = write_dataset(tmp_path / "ds", n_train=2, n_val=4)
    port.set_classes(["red", "green", "blue"], embeddings=np.random.default_rng(5).normal(size=(3, 512)))
    port.save(tmp_path / "w.ckpt")
    seen = []
    hook = port.model.register_forward_hook(lambda m, args, out: seen.append(out))
    try:
        got = port.val(data=str(data), batch=4, imgsz=64).results_dict
    finally:
        hook.remove()
    np.testing.assert_array_equal(port.model.txt_feats.numpy(), port.txt_feats)
    assert [o.shape[1] for o in seen[0]] == [64 + 3] * 2
    want = JaxYOLO(str(tmp_path / "w.ckpt")).val(data=str(data), batch=4, imgsz=64).results_dict
    assert got.keys() == want.keys()
    np.testing.assert_allclose([float(got[k]) for k in want], [float(want[k]) for k in want], rtol=0, atol=1e-6)


def test_checkpoint_after_set_classes_keeps_the_graphs_width(tmp_path):
    """yolov8n-world's WorldDetect is c3 = max(64, min(nc, 100)) = 80 wide at the YAML's nc 80: after
    ``set_classes`` of 12 names, ``save`` records the class count the graph was built with, and ``YOLO(ckpt)``
    rebuilds it at that count (not at 12, which would make c3 64), binds the 12 rows and predicts the writer's
    rows."""
    from bsyolo_tpu_torch import YOLO, YOLOWorld

    names = [f"class{i}" for i in range(12)]
    m = YOLOWorld("yolov8n-world.yaml", device="cpu")
    m.set_classes(names)
    m.save(tmp_path / "w.ckpt")
    back = YOLO(tmp_path / "w.ckpt", device="cpu")
    assert back.model.spec.nc == 80 and back.spec.nc == 12 and list(back.names.values()) == names
    np.testing.assert_array_equal(back.txt_feats, m.txt_feats)
    frame = np.random.default_rng(3).integers(0, 256, (64, 80, 3), dtype=np.uint8)
    kw = dict(imgsz=64, conf=0.0001, max_det=20)
    want, got = m.predict(frame, **kw)[0].boxes.data, back.predict(frame, **kw)[0].boxes.data
    assert len(want) >= 5 and set(want[:, 5].astype(int)) <= set(range(12))
    np.testing.assert_array_equal(got, want)
