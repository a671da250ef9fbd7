"""RT-DETR's predict, val, bf16 graph and int8 inference in the PyTorch port against bsyolo_tpu, and its
trainer and CLI, on the tiny RT-DETR graph (tests/rtdetr_port.py) at 64 px: predict rows paired with the
JAX facade's (class equal, score within 1e-5, box within 1e-3 px; augment reverts to one scale), every val
metric within 1e-6 of the JAX facade's on the same weights, the bf16 graph within the block gate 1e-2
(norm-relative) of JAX's bf16 graph, the int8 conv set equal to the JAX package's harvest and each conv
within 1e-5 fed JAX's input; ``YOLO.train`` with its default amp, ``val``, ``predict`` and the CLI run."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import jax
import jax.numpy as jnp
import torch

from rtdetr_port import tiny_models, write_tiny_yaml
from torch_port import nchw, port_module_from_jax, random_variables, to_plain_dict, variable_shapes
from zoo_port import paired_rows

IMG = 64
BLOCK_NORM = 1e-2  # tests/test_torch_bf16.py's gate; measured 4.4e-3 (AIFI) to 5.8e-3 (the decoder layer)
# the whole graph through six decoder layers, where the port rounds every op to bfloat16 and XLA keeps some
# intermediates in float32: measured 1.5e-3 (encoder boxes) to 1.43e-2 (the last layer's class logits)
GRAPH_NORM = 2e-2


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(the tiny graph's YAML at nc 3, seeded variables as numpy)."""
    from bsyolo_tpu.nn.model import DetectionGraph

    from torch_port import jax_spec

    path = write_tiny_yaml(tmp_path_factory.mktemp("rtdetr") / "tinyrtdetr.yaml", nc=3)
    v = to_plain_dict(random_variables(variable_shapes(DetectionGraph(jax_spec(path)), (1, IMG, IMG, 3)), 9))
    return path, v


@pytest.fixture(scope="module")
def facades(tiny):
    from bsyolo_tpu import YOLO as JaxYOLO

    from bsyolo_tpu_torch import RTDETR

    path, v = tiny
    jy = JaxYOLO(path)
    jy.variables = v
    port = RTDETR(path, device="cpu")
    port_module_from_jax(port.model, v)
    return jy, port


def test_predict_matches_the_jax_facade(facades):
    """NMS-free predict: each frame's rows (the decoder's top 300 queries above conf) pair with the JAX
    facade's; augment warns and predicts at one scale; tiled predict refuses the graph."""
    jy, port = facades
    rng = np.random.default_rng(8)
    frames = [rng.integers(0, 256, (48, 64, 3), dtype=np.uint8), rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)]
    kw = dict(imgsz=IMG, conf=0.3, batch=2)
    want = [np.asarray(r.boxes.data) for r in jy.predict(frames, **kw)]
    got = [r.boxes.data for r in port.predict(frames, **kw)]
    for g, w in zip(got, want):
        assert len(g) == len(w) >= 5 and len(paired_rows(g, w)) == len(w)
    tta = [r.boxes.data for r in port.predict(frames, augment=True, **kw)]
    for a, b in zip(got, tta):
        np.testing.assert_array_equal(a, b)
    from bsyolo_tpu_torch.engine.tiled import predict_tiled

    with pytest.raises(NotImplementedError, match="RTDETRDecoder"):
        predict_tiled(port.model, port.spec, frames[0], tile=64)


def test_val_matches_the_jax_facade(facades, tmp_path):
    """``val`` of the same weights in both facades (conf 0.001: 300 rows per image, no NMS), every metric within
    1e-6, on a seeded set whose labels are the port's own predictions at conf 0.3, so that the metrics of
    random weights carry signal."""
    from test_torch_data import write_dataset

    jy, port = facades
    data = write_dataset(tmp_path / "ds", n_train=1, n_val=6)
    for r in port.predict(str(data.parent / "images" / "val"), imgsz=IMG, conf=0.3):
        h, w = r.orig_shape
        rows = [f"{int(c)} {(x1 + x2) / 2 / w} {(y1 + y2) / 2 / h} {(x2 - x1) / w} {(y2 - y1) / h}"
                for x1, y1, x2, y2, _, c in r.boxes.data[:16]]
        (data.parent / "labels" / "val" / f"{Path(r.path).stem}.txt").write_text("\n".join(rows) + "\n")
    got = port.val(data=str(data), batch=4, imgsz=IMG).results_dict
    want = jy.val(data=str(data), batch=4, imgsz=IMG).results_dict
    assert got.keys() == want.keys() and float(want["metrics/mAP50-95(B)"]) > 0
    np.testing.assert_allclose([float(got[k]) for k in want], [float(want[k]) for k in want], rtol=0, atol=1e-6)


def _bf16(x: np.ndarray) -> np.ndarray:
    """float32 values on the bfloat16 grid."""
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("name", ["AIFI", "MSDeformAttn", "DecoderLayer"])
def test_bf16_block_matches_jax(name):
    """The transformer's blocks with a bfloat16 compute dtype, fed the same bfloat16 input (float32 reference
    boxes) with the same float32 weights: the output dtype JAX's and within ``BLOCK_NORM`` of JAX's output."""
    import bsyolo_tpu.nn.transformer as JT

    import bsyolo_tpu_torch.nn.transformer as PT
    from bsyolo_tpu_torch.nn.model import set_compute_dtype

    rng = np.random.default_rng(12)
    shapes = ((6, 10), (3, 5), (2, 3))
    C, bf = 32, jnp.bfloat16
    q = _bf16(rng.normal(0, 1, (2, 7, C)))
    feats = _bf16(rng.normal(0, 1, (2, sum(h * w for h, w in shapes), C)))
    rb = rng.uniform(0.1, 0.9, (2, 7, 4)).astype(np.float32)
    x = _bf16(rng.normal(0, 1, (2, 6, 10, C)))
    if name == "AIFI":
        jm, pm, args = JT.AIFI(64, 4, dtype=bf), PT.AIFI(C, 64, 4), (x,)
        pargs = (torch.from_numpy(nchw(x)),)
    elif name == "MSDeformAttn":
        jm, pm, args = JT.MSDeformAttn(C, 3, 4, 4, dtype=bf), PT.MSDeformAttn(C, 3, 4, 4), (q, rb[:, :, None], feats)
        pargs = (torch.from_numpy(q), torch.from_numpy(rb[:, :, None]), torch.from_numpy(feats))
    else:
        jm = JT.DeformableTransformerDecoderLayer(C, 4, 64, 3, 4, dtype=bf)
        pm = PT.DeformableTransformerDecoderLayer(C, 4, 64, 3, 4)
        args, pargs = (q, rb, feats), (torch.from_numpy(q), torch.from_numpy(rb), torch.from_numpy(feats))
    jargs = tuple(jnp.asarray(a) if a is rb or (name == "MSDeformAttn" and i == 1) else jnp.asarray(a, bf)
                  for i, a in enumerate(args))
    extra = (shapes,) if name != "AIFI" else ()
    variables = to_plain_dict(random_variables(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *jargs,
                                                                                   *extra)), 13))
    want = jax.jit(lambda v, *a: jm.apply(v, *a, *extra))(variables, *jargs)
    pm = port_module_from_jax(pm, variables)
    set_compute_dtype(pm, torch.bfloat16)
    pargs = tuple(a if a.shape == rb.shape or (name == "MSDeformAttn" and i == 1) else a.to(torch.bfloat16)
                  for i, a in enumerate(pargs))
    with torch.no_grad():
        got = pm(*pargs, *extra)
    w = np.asarray(want, np.float32)
    g = got.float().numpy()
    if name == "AIFI":
        w = nchw(w)
    err = float(np.linalg.norm(g - w) / np.linalg.norm(w))
    print(f"bf16 {name}: {got.dtype} (JAX {want.dtype}), {err:.3g} of JAX's norm")
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16 and err <= BLOCK_NORM


def test_bf16_graph_matches_jax():
    """Eval mode of the tiny bf16 graph (every Linear and conv in bfloat16; boxes, sampling, softmaxes and
    the top-k float32) against JAX's ``DetectionGraph(dtype=bfloat16)`` at 48 px, where all 189 anchors are
    selected: each output within ``GRAPH_NORM`` of JAX's norm, after pairing the queries by anchor (bf16
    scores tie)."""
    from bsyolo_tpu.nn.model import DetectionGraph

    import bsyolo_tpu_torch.nn.transformer as PT
    from bsyolo_tpu_torch.nn.model import set_compute_dtype

    jm, variables, port, _ = tiny_models(hw=(48, 48), seed=5)
    jb = DetectionGraph(jm.spec, dtype=jnp.bfloat16)
    set_compute_dtype(port, torch.bfloat16)
    x = np.random.default_rng(6).uniform(0, 1, (2, 48, 48, 3)).astype(np.float32)
    mp = pytest.MonkeyPatch()
    jidx, pidx = [], []
    try:
        orig_j, orig_p = jax.lax.top_k, PT.top_k_stable

        def spy(a, k):
            v, i = orig_j(a, k)
            jax.debug.callback(lambda t: jidx.append(np.asarray(t)), i)
            return v, i

        mp.setattr(jax.lax, "top_k", spy)
        want = jax.jit(lambda v, a: jb.apply(v, a, train=False))(variables, jnp.asarray(x))
        jax.effects_barrier()
        mp.setattr(PT, "top_k_stable", lambda a, k: pidx.append(orig_p(a, k)[1].numpy()) or orig_p(a, k))
        with torch.no_grad():
            got = port(torch.from_numpy(nchw(x)))
    finally:
        mp.undo()
    assert got["dec_scores"].dtype == torch.bfloat16 and got["dec_bboxes"].dtype == torch.float32
    assert pidx[0].shape == jidx[0].shape == (2, 189)
    order = np.stack([np.argsort(p)[j] for p, j in zip(pidx[0], jidx[0])])  # the port's position of JAX's anchor
    errs = {}
    for k in ("dec_bboxes", "dec_scores", "enc_bboxes", "enc_scores"):
        g = got[k].float().numpy()
        if k.startswith("dec"):
            g = np.stack([g[:, b][:, order[b]] for b in range(2)], 1)
        else:
            g = np.stack([g[b][order[b]] for b in range(2)])
        w = np.asarray(want[k], np.float32)
        err = float(np.linalg.norm(g - w) / np.linalg.norm(w))
        print(f"bf16 {k}: {err:.3g} of JAX's norm")
        errs[k] = err
    assert max(errs.values()) <= GRAPH_NORM, errs


def test_int8_convs_match_the_jax_harvest():
    """Int8 inference quantizes exactly the convs JAX's ``calibrate_int8`` harvests (ConvBN with groups 1:
    the HGNetv2 and neck convs; not the depthwise ones, the decoder's input projections or its linear
    layers), with the same scales; each, fed the input its JAX ConvBN saw, gives that ConvBN's output within
    1e-5."""
    import flax.linen as nn

    import bsyolo_tpu.nn.modules as JM
    from bsyolo_tpu.nn.quant import calibrate_int8 as jax_calibrate

    from bsyolo_tpu_torch.nn.modules import quantizable_convs, scale_key, set_int8_inference
    from bsyolo_tpu_torch.nn.quant import calibrate_int8
    from bsyolo_tpu_torch.utils.weights import scales_from_jax

    jm, variables, port, _ = tiny_models(hw=(IMG, IMG), seed=7)
    brng = np.random.default_rng(7)
    batches = [brng.uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32) for _ in range(2)]
    jraw = jax_calibrate(jm, variables, [jnp.asarray(b) for b in batches])
    jax_scales = scales_from_jax(jraw)
    scales = calibrate_int8(port, [torch.from_numpy(nchw(b)) for b in batches])
    assert set(scales) == set(jax_scales) == {scale_key(n) for n, _ in quantizable_convs(port)}
    keys = sorted(scales)
    np.testing.assert_allclose([scales[k] for k in keys], [jax_scales[k] for k in keys], rtol=1e-5)

    def run(v, xx):
        convs = {}

        def record(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if isinstance(context.module, JM.ConvBN) and context.method_name == "__call__":
                convs["/".join(context.module.scope.path) + "/conv"] = (args[0], out)
            return out

        with nn.intercept_methods(record):
            return jm.apply(v, xx, train=False), convs

    x = np.random.default_rng(8).uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    JM.set_int8_inference(True, jraw)
    try:
        _, convs = jax.jit(run)(variables, jnp.asarray(x))
    finally:
        JM.set_int8_inference(False)
    convs = dict(zip(scales_from_jax(dict.fromkeys(convs, 0.0)), convs.values()))
    set_int8_inference(port, True, jax_scales)
    try:
        with torch.no_grad():
            for name, m in quantizable_convs(port):
                inp, want = (nchw(np.asarray(t)) for t in convs[scale_key(name)])
                got = m(torch.tensor(inp)).numpy()
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max(), err_msg=name)
            out = port(torch.from_numpy(nchw(x)))
        assert np.isfinite(out["dec_bboxes"].numpy()).all()
    finally:
        set_int8_inference(port, False)


def test_train_val_predict_and_cli(tiny, tmp_path, capsys):
    """``YOLO.train`` with its default amp (the bf16 graph, the DETR loss, the labels fed into the graph)
    for 2 epochs, ``val`` and ``val(half=True)``, int8 ``predict``; the CLI's train, val and predict."""
    from bsyolo_tpu_torch import RTDETR
    from bsyolo_tpu_torch.cli import main
    from bsyolo_tpu_torch.nn.modules import set_int8_inference
    from test_torch_data import write_dataset

    path, _ = tiny
    data = write_dataset(tmp_path / "ds", n_train=4, n_val=4)
    m = RTDETR(path, device="cpu")
    m.train(data=str(data), epochs=2, imgsz=IMG, batch=4, nbs=4, workers=0, plots=False, project=str(tmp_path),
            name="t")
    rows = list(__import__("csv").DictReader(open(m.trainer.csv_path)))
    assert [k for k in rows[0] if k.endswith("loss")] == ["bbox_loss", "cls_loss", "giou_loss", "loss"]
    assert all(np.isfinite(float(r["cls_loss"])) for r in rows)
    assert m.model.model[-1].dec_score_head[0].compute_dtype == torch.bfloat16
    for half in (False, True):
        assert 0 <= m.val(data=str(data), batch=4, imgsz=IMG, half=half).results_dict["fitness"] <= 1
    frames = [np.random.default_rng(1).integers(0, 256, (48, 64, 3), dtype=np.uint8)]
    set_int8_inference(m.model, True)
    try:
        r = m.predict(frames, imgsz=IMG, conf=0.0)
    finally:
        set_int8_inference(m.model, False)
    assert len(r[0]) == 300 and r[0].boxes.data.shape == (300, 6)
    assert main(["train", f"model={path}", f"data={data}", "epochs=1", "imgsz=64", "batch=4", "nbs=4", "workers=0",
                 "plots=False", "amp=False", "device=cpu", f"project={tmp_path}", "name=cli"]) == 0
    best = tmp_path / "cli" / "weights" / "best.ckpt"
    assert main(["detect", "val", f"model={best}", f"data={data}", "imgsz=64", "batch=4", "device=cpu"]) == 0
    capsys.readouterr()
    assert main(["predict", f"model={best}", f"source={data.parent / 'images' / 'val'}", "imgsz=64", "conf=0.0001",
                 "device=cpu", f"project={tmp_path}", "name=pred"]) == 0
    lines = capsys.readouterr().out.splitlines()  # the command line logs each frame and saves its drawing, as JAX's
    assert len(lines) == 5 and lines[-1].startswith("4 frames")
    assert len(list((tmp_path / "pred").glob("*.jpg"))) == 4
