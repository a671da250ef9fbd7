"""The port's bf16 graph (``nn.model.set_compute_dtype``, ``cast_inference_graph``;
``predict(half=True)``, ``val(half=True)``, the graph ``train(amp=True)`` leaves behind)
against bsyolo_tpu's ``dtype=jnp.bfloat16`` graph.

Blocks at narrow widths on 16 px maps, fed the same bfloat16 input (float32 where the JAX
graph hands the block float32, ELA's output) with the same float32 weights: the output
dtype equals the JAX block's (ELA float32, the others bfloat16) and the output is within
``BLOCK_NORM`` of the JAX block's, norm-relative. Whole graphs (tiny.yaml at 64 px and
yolo11n at 128 px, jitted JAX): bfloat16 head levels within ``GRAPH_NORM``, and away from
the port's own float32 levels by more than ``F32_GAP`` (the bf16 path ran). The port
rounds every op to bfloat16 where XLA keeps some intermediates in float32; each test
prints its figures. ``predict(half=True)`` against the JAX facade's on the bundled photos
letterboxed to 128 px, with and without ``augment``, without suppression (``iou=1.0``:
with random weights the default NMS turns bf16 rounding of near-tied scores into other
suppression decisions, between either package's bf16 and its own float32 rows as well): at
least ``MATCH_MIN`` (``MATCH_MIN_TTA``) of the rows paired one to one within
``MATCH_PX`` and ``MATCH_SCORE``. ``val(half=True)`` of an amp-
trained tiny.yaml against the JAX facade's: mAP50 and mAP50-95 within 0.02.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import jax
import jax.numpy as jnp
import torch

from torch_port import jax_spec, nchw, port_module_from_jax, port_spec, random_variables, variable_shapes

BLOCK_NORM = 1e-2  # measured 1.8e-4 (Attention) to 7.9e-3 (MSCAAttention)
GRAPH_NORM = 7.5e-3  # measured 3.9e-3 to 4.6e-3 (tiny.yaml at 64 px, yolo11n at 128 px)
F32_GAP = 1e-3
MATCH_PX, MATCH_SCORE, MATCH_MIN = 1.0, 1e-2, 0.95
# TTA's three passes compete for the 300 rows: bf16 rounding swaps more rows at the 300th rank
# (measured 0.883 to 0.910 paired)
MATCH_MIN_TTA = 0.85
VAL_ATOL = 0.02
IMG = 128
TINY = str(Path(__file__).parent / "fixtures" / "tiny.yaml")
PHOTOS = sorted((Path(__file__).parent / "fixtures" / "bsyolo8" / "images" / "train").glob("*.jpg"))


def _bf16(x: np.ndarray) -> np.ndarray:
    """float32 values on the bfloat16 grid (both packages then hold the same bfloat16 input)."""
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _norm_rel(got: np.ndarray, want: np.ndarray) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _blocks():
    from bsyolo_tpu.nn import modules as J
    from bsyolo_tpu_torch.nn import modules as P

    bf = jnp.bfloat16
    # name: (c1, input dtype, JAX module, port module)
    return {
        "Conv": (16, bf, lambda: J.ConvBN(24, 3, 2, dtype=bf), lambda: P.Conv(16, 24, 3, 2)),
        "DWConv": (16, jnp.float32, lambda: J.DWConvBN(16, 3, 1, dtype=bf), lambda: P.DWConv(16, 16, 3, 1)),
        "PMSFA": (32, bf, lambda: J.PMSFA(dtype=bf), lambda: P.PMSFA(32)),
        "C3k2_gai": (16, bf, lambda: J.C3k2_gai(32, 1, True, 1, 0.5, c3k=True, dtype=bf),
                     lambda: P.C3k2_gai(16, 32, 1, c3k=True, e=0.5, g=1, shortcut=True)),
        "C3k2": (16, jnp.float32, lambda: J.C3k2(32, 1, False, dtype=bf), lambda: P.C3k2(16, 32, 1, shortcut=False)),
        "SCDown": (16, bf, lambda: J.SCDown(32, 3, 2, dtype=bf), lambda: P.SCDown(16, 32, 3, 2)),
        "SPPF": (16, bf, lambda: J.SPPF(24, 5, dtype=bf), lambda: P.SPPF(16, 24, 5)),
        "Attention": (32, bf, lambda: J.Attention(32, num_heads=2, attn_ratio=0.5, dtype=bf),
                      lambda: P.Attention(32, num_heads=2, attn_ratio=0.5)),
        "C2PSA": (32, bf, lambda: J.C2PSA(32, 1, dtype=bf), lambda: P.C2PSA(32, 32, 1)),
        "MSCAAttention": (16, bf, lambda: J.MSCAAttention(16, dtype=bf), lambda: P.MSCAAttention(16)),
        "ELA": (32, bf, lambda: J.ELA(32, dtype=bf), lambda: P.ELA(32)),
    }


@pytest.mark.parametrize("name", list(_blocks()))
def test_block_bf16_matches_jax(name, rng):
    from bsyolo_tpu_torch.nn.model import set_compute_dtype

    c1, in_dtype, jfac, pfac = _blocks()[name]
    x = _bf16(rng.normal(0, 1, (2, 16, 16, c1)).astype(np.float32))
    jmod = jfac()
    jx = jnp.asarray(x, in_dtype)
    variables = random_variables(jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jx, train=False)),
                                 list(_blocks()).index(name))
    pmod = set_compute_dtype(port_module_from_jax(pfac(), variables), torch.bfloat16)
    want = jmod.apply(variables, jx, train=False)
    with torch.no_grad():
        got = pmod(torch.from_numpy(nchw(x)).to(torch.float32 if in_dtype == jnp.float32 else torch.bfloat16))
    err = _norm_rel(got.float().numpy(), nchw(np.asarray(want, np.float32)))
    print(f"{name}: {got.dtype} (JAX {want.dtype}), {err:.3g} of the JAX output's norm")
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    assert err <= BLOCK_NORM


def test_detect_head_bf16_matches_jax(rng):
    """Detect gets float32 levels (ELA's output) and returns bfloat16 levels, contiguous."""
    from bsyolo_tpu.nn.heads import Detect as JDetect
    from bsyolo_tpu_torch.nn.heads import Detect
    from bsyolo_tpu_torch.nn.model import set_compute_dtype

    feats = [rng.normal(0, 1, (2, s, s, c)).astype(np.float32) for s, c in ((16, 16), (8, 32))]
    jmod = JDetect(12, (16, 32), (8, 16), dtype=jnp.bfloat16)
    jf = [jnp.asarray(f) for f in feats]
    variables = random_variables(jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jf)), 7)
    pmod = set_compute_dtype(port_module_from_jax(Detect(12, (16, 32), (8, 16)), variables), torch.bfloat16)
    want = jmod.apply(variables, jf)
    with torch.no_grad():
        got = pmod([torch.from_numpy(nchw(f)) for f in feats])
    for g, w in zip(got, want):
        err = _norm_rel(g.float().numpy(), nchw(np.asarray(w, np.float32)))
        print(f"Detect level {tuple(g.shape)}: {err:.3g}")
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16 and g.is_contiguous() and err <= BLOCK_NORM


@pytest.fixture(scope="module")
def yolo11n():
    """(JAX float32 graph, JAX bf16 graph, seeded variables, the port's YOLO facade with them), 128 px."""
    from bsyolo_tpu.nn.model import DetectionGraph
    from bsyolo_tpu_torch import YOLO

    spec = jax_spec("yolo11n.yaml")
    variables = random_variables(variable_shapes(DetectionGraph(spec), (1, IMG, IMG, 3)), seed=1)
    port = YOLO("yolo11n.yaml", device="cpu")
    port_module_from_jax(port.model, variables)
    return DetectionGraph(spec), DetectionGraph(spec, dtype=jnp.bfloat16), variables, port


def _graph_case(case, yolo11n):
    from bsyolo_tpu.nn.model import DetectionGraph
    from bsyolo_tpu_torch.nn.model import build_model

    if case == "yolo11n":
        jf, jb, variables, port = yolo11n
        return jf, jb, variables, port.model, IMG
    spec = jax_spec(TINY)
    variables = random_variables(variable_shapes(DetectionGraph(spec), (1, 64, 64, 3)), seed=2)
    port = port_module_from_jax(build_model(port_spec(TINY), "cpu"), variables)
    return DetectionGraph(spec), DetectionGraph(spec, dtype=jnp.bfloat16), variables, port, 64


@pytest.mark.parametrize("case", ["tiny", "yolo11n"])
def test_graph_bf16_matches_jax(case, yolo11n, rng):
    from bsyolo_tpu_torch.nn.model import cast_inference_graph, compute_dtype, set_compute_dtype

    jf, jb, variables, port, size = _graph_case(case, yolo11n)
    x = rng.uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: jb.apply(v, x, train=False))(variables, jnp.asarray(x))
    xt = torch.from_numpy(nchw(x))
    with torch.no_grad():
        f32 = port(xt)
        half = cast_inference_graph(port)
        got = half(xt)
        set_compute_dtype(port, torch.bfloat16)
        try:
            per_call = port(xt)
        finally:
            set_compute_dtype(port, torch.float32)
    assert compute_dtype(port) == torch.float32 and compute_dtype(half) == torch.bfloat16
    for g, p, f, w in zip(got, per_call, f32, want):
        err, gap = _norm_rel(g.float().numpy(), nchw(np.asarray(w, np.float32))), _norm_rel(g.float().numpy(), f.numpy())
        print(f"{case} level {tuple(g.shape)}: {err:.3g} of the JAX bf16 level's norm; {gap:.3g} from float32")
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16 and g.is_contiguous()
        assert err <= GRAPH_NORM and gap > F32_GAP
        torch.testing.assert_close(g, p, rtol=0, atol=0)  # weights cast once = cast in every conv


def test_cast_inference_graph_shares_batchnorm_state(yolo11n):
    from bsyolo_tpu_torch.nn.model import cast_inference_graph
    from bsyolo_tpu_torch.nn.modules import cast_convs

    model = yolo11n[3].model
    half = cast_inference_graph(model)
    own, cast = dict(model.named_parameters()), dict(half.named_parameters())
    convs = {n for n, m in half.named_modules() if m in cast_convs(half)}
    for name, p in cast.items():
        if name.rsplit(".", 1)[0] in convs:
            assert p.dtype == torch.bfloat16 and own[name].dtype == torch.float32
            torch.testing.assert_close(p, own[name].to(torch.bfloat16), rtol=0, atol=0)
        else:  # BatchNorm and GroupNorm affine parameters, ELA's fusion weights: the float32 tensors themselves
            assert p is own[name] and p.dtype == torch.float32
    buffers = dict(model.named_buffers())
    assert all(b is buffers[n] for n, b in half.named_buffers())


def _frames():
    """The bundled photos letterboxed to IMG by the port (BGR): neither package resizes them again."""
    import cv2

    from bsyolo_tpu_torch.ops.letterbox import letterbox

    return [np.ascontiguousarray(letterbox(cv2.imread(str(p)), (IMG, IMG), "cpu").numpy()[::-1].transpose(1, 2, 0))
            for p in PHOTOS[:4]]


def _paired_fraction(got: np.ndarray, want: np.ndarray) -> float:
    """Rows paired one to one (same class, box within MATCH_PX, score within MATCH_SCORE, the
    closest score first) over the larger row count."""
    free = np.ones(len(want), bool)
    paired = 0
    for row in got:
        ok = (free & (want[:, 5] == row[5]) & (np.abs(want[:, 4] - row[4]) <= MATCH_SCORE)
              & (np.abs(want[:, :4] - row[:4]).max(1) <= MATCH_PX))
        if ok.any():
            cand = np.flatnonzero(ok)
            free[cand[np.argmin(np.abs(want[cand, 4] - row[4]))]] = False
            paired += 1
    return paired / max(len(got), len(want), 1)


@pytest.fixture(scope="module")
def jax_facade(yolo11n):
    from bsyolo_tpu import YOLO as JaxYOLO

    jy = JaxYOLO("yolo11n.yaml")
    jy.variables = yolo11n[2]
    return jy


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augment"])
def test_predict_half_matches_jax(augment, yolo11n, jax_facade):
    """Rows without suppression (iou 1.0: the top 300 candidates by score) pair with the JAX
    facade's. (With the default NMS, near-tied random-weight scores reorder which boxes
    suppress which, between either package's bf16 and its own float32 rows as well.)"""
    port = yolo11n[3]
    frames = _frames()
    kw = dict(imgsz=IMG, conf=0.001, batch=2, iou=1.0, augment=augment)
    heads = []
    hook = port.model.model[-1].register_forward_hook(lambda m, a, out: heads.append(out[0].dtype))
    try:
        got = [r.boxes.data for r in port.predict(frames, half=True, **kw)]
    finally:
        hook.remove()
    want = [np.asarray(r.boxes.data) for r in jax_facade.predict(frames, half=True, **kw)]
    f32 = [r.boxes.data for r in port.predict(frames, **kw)]
    fracs = [_paired_fraction(g, w) for g, w in zip(got, want)]
    print(f"predict(half=True, augment={augment}, iou=1.0): paired {fracs} of {[len(g) for g in got]} rows")
    assert heads == [] and port._half is not None  # the facade's float graph did not run, its bf16 copy did
    assert min(fracs) >= (MATCH_MIN_TTA if augment else MATCH_MIN)
    assert all(g.shape == (300, 6) for g in got)
    assert any(not np.allclose(g, f) for g, f in zip(got, f32))


def test_predict_tiled_on_the_half_graph_matches_jax(yolo11n):
    """predict_tiled on the facade's bf16 graph against the JAX predict_tiled on its bf16 graph and
    cast weights, a 200x300 frame in 128-px tiles, without suppression (iou 1.0)."""
    from bsyolo_tpu.engine.tiled import predict_tiled as jtiled
    from bsyolo_tpu.nn.model import cast_inference_params
    from bsyolo_tpu_torch.engine.tiled import predict_tiled

    _, jb, variables, port = yolo11n
    frame = np.random.default_rng(13).integers(0, 256, (200, 300, 3), dtype=np.uint8)
    kw = dict(tile=IMG, conf=0.001, iou=1.0, max_det=200)
    want = np.asarray(jtiled(jb, port.spec, cast_inference_params(variables), frame, mesh=None, **kw))
    got = predict_tiled(port.half_graph(), port.spec, frame, **kw)
    f32 = predict_tiled(port.model, port.spec, frame, **kw)
    frac = _paired_fraction(got, want)
    print(f"predict_tiled on the half graph: paired {frac} of {len(got)} rows (JAX {len(want)})")
    assert got.dtype == np.float32 and len(got) == 200 and frac >= MATCH_MIN_TTA
    assert not np.allclose(got, f32)


# --- the facade: train(amp=True) by default, val(half=True), the CLI ------------------------------


@pytest.fixture(scope="module")
def amp_trained(tmp_path_factory):
    """YOLO(tiny.yaml).train(...) with the default amp on a 3-class PNG dataset (24 train, 6 val
    frames), 64 px, augmentation off, 40 epochs: enough for validation metrics well above 0."""
    from test_torch_data import write_dataset
    from test_train_parity import AUG_OFF

    from bsyolo_tpu_torch import YOLO

    root = tmp_path_factory.mktemp("torch_bf16")
    data = write_dataset(root / "ds", n_train=24)
    m = YOLO(TINY, device="cpu")
    m.train(data=str(data), epochs=40, imgsz=64, batch=8, nbs=8, optimizer="SGD", lr0=0.02, warmup_epochs=0.0,
            workers=0, plots=False, close_mosaic=0, seed=3, max_gt=16, project=str(root / "runs"), name="amp",
            **AUG_OFF)
    return m, data


def test_train_defaults_to_amp_and_the_facade_keeps_the_bf16_graph(amp_trained):
    from bsyolo_tpu.engine.trainer import load_checkpoint as jax_load

    from bsyolo_tpu_torch import YOLO
    from bsyolo_tpu_torch.nn.model import cast_inference_graph, compute_dtype
    from bsyolo_tpu_torch.utils.weights import state_dict_from_jax

    m, _ = amp_trained
    assert m.trainer.args.amp is True and compute_dtype(m.trainer.model) == torch.bfloat16
    assert compute_dtype(m.model) == torch.bfloat16  # adopted, as the JAX facade adopts the trainer's graph
    assert not m.model.training  # predict after train runs eval-mode BatchNorm, as the JAX facade's train=False
    assert all(p.dtype == torch.float32 for p in m.model.parameters())
    heads = []
    hook = m.model.model[-1].register_forward_hook(lambda mod, a, out: heads.append(out))
    frames = [np.random.default_rng(0).integers(0, 256, (64, 64, 3), dtype=np.uint8)]
    try:
        m.predict(frames, imgsz=64, conf=0.001)  # no half: the adopted graph is bf16
    finally:
        hook.remove()
    x = heads[0]
    assert all(f.dtype == torch.bfloat16 for f in x)
    with torch.no_grad():  # the same head as the cast copy's: weights cast once = cast per conv
        from bsyolo_tpu_torch.ops.letterbox import letterbox

        img = letterbox(frames[0], (64, 64), "cpu")[None].float() / 255.0
        for a, b in zip(m.model(img), cast_inference_graph(m.model)(img)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    best = m.trainer.save_dir / "weights" / "best.ckpt"
    payload, _ = jax_load(best)  # the JAX package reads it: float32 parameters
    assert all(np.asarray(v).dtype == np.float32 for v in jax.tree_util.tree_leaves(payload["params"]))
    loaded = YOLO(best, device="cpu")  # a float32 graph with the checkpoint's EMA weights
    assert compute_dtype(loaded.model) == torch.float32 and loaded.spec.nc == 3
    saved = state_dict_from_jax({"params": payload["ema_params"]})
    for name, p in loaded.model.named_parameters():
        torch.testing.assert_close(p, saved[name], rtol=0, atol=0)


def test_val_half_matches_jax(amp_trained):
    """YOLO(best.ckpt).val(half=True) of both packages. The JAX facade rebuilds tiny.yaml's own
    2 classes from a checkpoint (ROADMAP queue 3), so its graph is built here with the data's 3."""
    from bsyolo_tpu import YOLO as JaxYOLO
    from bsyolo_tpu.engine.trainer import load_checkpoint as jax_load
    from bsyolo_tpu.nn import build_model as jax_build, load_model_yaml, parse_model_yaml

    from bsyolo_tpu_torch import YOLO

    m, data = amp_trained
    best = m.trainer.save_dir / "weights" / "best.ckpt"
    port = YOLO(best, device="cpu")
    got = port.val(data=str(data), batch=8, imgsz=64, half=True).results_dict
    f32 = port.val(data=str(data), batch=8, imgsz=64).results_dict
    jy = JaxYOLO(TINY)
    d = load_model_yaml(TINY)
    d["nc"] = 3
    jy.spec = parse_model_yaml(d)
    jy.model, _ = jax_build(jy.spec, img_size=64)
    payload, _ = jax_load(best)
    jy.variables = {"params": payload["ema_params"], "batch_stats": payload["batch_stats"]}
    want = jy.val(data=str(data), batch=8, imgsz=64, half=True).results_dict
    print(f"val(half=True): port {got}, JAX {want}; port float32 {f32}")
    assert want["metrics/mAP50(B)"] > 0.3
    for k in ("metrics/mAP50(B)", "metrics/mAP50-95(B)"):
        assert abs(got[k] - want[k]) <= VAL_ATOL, k
    assert port._half is not None


@pytest.mark.parametrize("mode", ["val", "predict"])
def test_cli_half_reaches_the_bf16_graph(mode, amp_trained, monkeypatch):
    from bsyolo_tpu_torch.cli import main
    from bsyolo_tpu_torch.model import YOLO

    m, data = amp_trained
    built = []
    half_graph = YOLO.half_graph
    monkeypatch.setattr(YOLO, "half_graph", lambda self: built.append(self) or half_graph(self))
    best = m.trainer.save_dir / "weights" / "best.ckpt"
    extra = [f"data={data}", "batch=8"] if mode == "val" else [f"source={data.parent / 'images' / 'val'}", "conf=0.001"]
    assert main([mode, f"model={best}", "imgsz=64", "device=cpu", "half=True", *extra]) == 0
    assert len(built) == 1 and built[0]._half is not None


def test_predict_after_amp_training_matches_the_jax_facade(amp_trained, tmp_path):
    """The facade's predict after train(): the adopted bf16 graph in eval mode, held against the JAX
    facade after its train() (the trainer's bf16 graph over the EMA weights and BatchNorm statistics,
    train=False). The port's facade had kept the trainer's train mode, so predict normalized each
    batch by its own statistics."""
    from bsyolo_tpu import YOLO as JaxYOLO
    from bsyolo_tpu.engine.trainer import load_checkpoint as jax_load
    from bsyolo_tpu.nn import load_model_yaml, parse_model_yaml
    from bsyolo_tpu.nn.model import DetectionGraph

    m, data = amp_trained
    payload, _ = jax_load(m.save(tmp_path / "adopted.ckpt"))  # the facade's weights and statistics, as saved
    jy = JaxYOLO(TINY)
    d = load_model_yaml(TINY)
    d["nc"] = 3
    jy.spec = parse_model_yaml(d)
    jy.model = DetectionGraph(jy.spec, dtype=jnp.bfloat16)  # what the JAX facade adopts after train(amp=True)
    jy.variables = {"params": payload["params"], "batch_stats": payload["batch_stats"]}
    frames = [np.random.default_rng(i).integers(0, 256, (64, 64, 3), dtype=np.uint8) for i in range(2)]
    kw = dict(imgsz=64, conf=0.001, iou=1.0, batch=2)
    got = [r.boxes.data for r in m.predict(frames, **kw)]
    want = [np.asarray(r.boxes.data) for r in jy.predict(frames, **kw)]
    fracs = [_paired_fraction(g, w) for g, w in zip(got, want)]
    print(f"predict after amp training: paired {fracs} of {[len(g) for g in got]} rows (JAX {[len(w) for w in want]})")
    assert not m.model.training and min(fracs) >= MATCH_MIN
