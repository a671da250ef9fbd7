"""The port's Classify task (nn.heads Classify, losses/classify, the train step's dropout generator,
data/cv.py gaussian_blur5 and equalize_hist, data/photometric.py RandAugment and the classify
transforms, data/classify.py, engine/classify.py, the predictor's classify branch and
Results.probs) against bsyolo_tpu and OpenCV, on the CPU.

tests/fixtures/tinycls.yaml (nc 2) at imgsz 64, the same seeded weights on both sides, carried from
JAX variables. Gates: the parameter count of yolo11n-cls (nc 1000 and 10) equal; logits within rtol
1e-4; the loss within 2e-3 and its gradient on the logits within 1e-6; one SGD step within
tests/test_torch_train_step.py's gate; gaussian_blur5 and equalize_hist byte-equal to OpenCV;
brightness_contrast, gamma and jpeg_compression byte-equal to the JAX functions; RandAugment's ops
byte-equal, its affine ones (rotate, shear, translate) within 1 grey level on at most 2 % of bytes;
the eval transform equal, the train transforms within 1 / 255 on at most 2 % of values (warps, the
HSV jitter); loader batches likewise;
validator metrics on the same logits equal; predict probabilities within 1e-6; one epoch through
the facade from the same weights: validation metrics equal and predicted probabilities within 1e-4.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import jax
import jax.numpy as jnp
import torch

from torch_port import jax_spec, nchw, port_spec, task_models, variable_shapes, write_cls_dataset

CLS = str(Path(__file__).parent / "fixtures" / "tinycls.yaml")
IMG = 64
AFFINE_OPS = (3, 10, 11, 12, 13)  # rotate, shear_x, shear_y, translate_x, translate_y


@pytest.fixture(scope="module")
def cls():
    return task_models(CLS, IMG, seed=5)


@pytest.mark.parametrize("nc", [1000, 10])
def test_parameter_count_at_full_width(nc):
    from bsyolo_tpu.nn import load_model_yaml as jload, parse_model_yaml as jparse
    from bsyolo_tpu.nn.model import DetectionGraph

    from bsyolo_tpu_torch.cfg import model_yaml_path
    from bsyolo_tpu_torch.nn.model import build_model, count_params
    from bsyolo_tpu_torch.nn.parser import load_model_yaml, parse_model_yaml

    d = load_model_yaml(model_yaml_path("yolo11n-cls.yaml"))
    d["nc"] = nc
    spec = parse_model_yaml(d, scale="n")
    jd = jload(str(Path(__file__).parents[1] / "bsyolo_tpu/cfg/models/11/yolo11-cls.yaml"))
    jd["nc"] = nc
    shapes = variable_shapes(DetectionGraph(jparse(jd, scale="n")), (1, 64, 64, 3))
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert spec.task == "classify" and spec.head.args == (nc,)
    assert count_params(build_model(spec, "cpu")) == want


def test_logits_and_loss_match_jax(cls):
    from bsyolo_tpu.losses.classify import classification_loss as jloss
    from bsyolo_tpu.losses.detect import init_loss_state as jinit

    from bsyolo_tpu_torch.losses import classification_loss, init_loss_state

    jm, spec, v, port = cls
    x = np.random.default_rng(0).uniform(0, 1, (4, IMG, IMG, 3)).astype(np.float32)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = port.model(torch.from_numpy(nchw(x)))
    assert port.task == "classify" and got.shape == (4, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    logits = np.random.default_rng(1).normal(0, 3, (6, 5)).astype(np.float32)
    labels = np.array([0, 4, 2, 2, 1, 3], np.int32)
    jt, ji, _ = jloss(jnp.asarray(logits), jnp.asarray(labels), jinit())
    jg = jax.grad(lambda z: jloss(z, jnp.asarray(labels), jinit())[0])(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_(True)
    t, items, state = classification_loss(lt, torch.from_numpy(labels), init_loss_state())
    t.backward()
    np.testing.assert_allclose([float(t), *items.detach().numpy()], [float(jt), *np.asarray(ji)], rtol=2e-3)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jg), rtol=0, atol=1e-6)


def test_dropout_draws_from_the_step_generator():
    """Train-mode dropout needs a generator (none: it raises); the step owns one and reseeds it from the
    iteration, so step n draws one mask whatever ran before, and eval mode draws nothing."""
    import dataclasses

    from bsyolo_tpu_torch.engine.optim import OptimConfig
    from bsyolo_tpu_torch.engine.train_step import StepConfig, init_train_state, make_train_step, task_criterion
    from bsyolo_tpu_torch.losses import DetectionLossConfig
    from bsyolo_tpu_torch.nn.model import build_model

    spec = dataclasses.replace(port_spec(CLS), dropout=0.5)
    x = torch.rand(4, 3, 32, 32)
    model = build_model(spec, "cpu")
    head = model.model[-1]
    assert head.dropout == 0.5
    with torch.no_grad():
        e1, e2 = model(x), model(x)
    torch.testing.assert_close(e1, e2)
    model.train()
    with pytest.raises(RuntimeError, match="Generator"):
        model(x)
    cfg = StepConfig(loss=DetectionLossConfig(nc=2, strides=(8,)), optim=OptimConfig(name="SGD", lr0=0.0, nbs=4),
                     batch_size=4, nb=2, nw=0, use_adamw=False, weight_decay=0.0, needs_dropout_rng=True)
    batch = {"img": x, "cls": torch.tensor([0, 1, 0, 1])}
    losses = []
    for _ in range(2):
        m = build_model(spec, "cpu")
        criterion, names = task_criterion(spec)
        state, step = init_train_state(m, cfg), make_train_step(m, cfg, criterion, names)
        assert m.model[-1].generator is not None and names == ("cls_loss",)
        losses.append([float(step(state, batch)[1]["loss"]) for _ in range(2)])
    assert losses[0] == losses[1] and losses[0][0] != losses[0][1]


def test_sgd_step_matches_jax(cls):
    """One SGD step with the cross-entropy from the same weights and batch (no dropout)."""
    from bsyolo_tpu.engine.optim import OptimConfig as JOpt
    from bsyolo_tpu.engine.train_step import StepConfig as JStep, init_train_state as jinit, make_train_step as jmake
    from bsyolo_tpu.losses import DetectionLossConfig as JLoss
    from bsyolo_tpu.losses.classify import classification_loss as jloss

    from bsyolo_tpu_torch.engine.optim import OptimConfig
    from bsyolo_tpu_torch.engine.train_step import StepConfig, init_train_state, make_train_step, task_criterion
    from bsyolo_tpu_torch.losses import DetectionLossConfig
    from bsyolo_tpu_torch.nn.model import build_model
    from bsyolo_tpu_torch.utils.weights import state_dict_from_jax, train_state_to_jax
    from test_torch_train_step import _compare_states

    jm, spec, v, _ = cls
    common = dict(batch_size=8, nb=5, nw=2, use_adamw=False, weight_decay=0.0005)
    okw = dict(name="SGD", lr0=0.01, epochs=4, nbs=8, warmup_bias_lr=0.1)
    jcfg = JStep(loss=JLoss(nc=2, strides=(8,)), optim=JOpt(**okw), **common)
    jstep = jmake(jm, jcfg, criterion=lambda o, b, ls, lc: jloss(o, b["cls"], ls, lc))
    jstate = jinit({k: jax.tree_util.tree_map(jnp.asarray, x) for k, x in v.items()}, jcfg)
    pm = build_model(port_spec(CLS), "cpu")
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    pcfg = StepConfig(loss=DetectionLossConfig(nc=2, strides=(8,)), optim=OptimConfig(**okw), **common)
    criterion, names = task_criterion(pm.spec)
    pstate, pstep = init_train_state(pm, pcfg), make_train_step(pm, pcfg, criterion, names)
    rng = np.random.default_rng(8)
    batch = {"img": rng.uniform(-1, 1, (8, 32, 32, 3)).astype(np.float32), "cls": rng.integers(0, 2, 8).astype(np.int32)}
    jstate, jmet = jstep(jstate, {k: jnp.asarray(x) for k, x in batch.items()})
    want = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), jstate)
    pstate, pmet = pstep(pstate, {"img": torch.from_numpy(nchw(batch["img"])), "cls": torch.from_numpy(batch["cls"]).long()})
    _compare_states(train_state_to_jax(pstate, want), want)
    np.testing.assert_allclose(float(pmet["loss"]), float(jmet["loss"]), rtol=1e-4)


@pytest.mark.parametrize("hw", [(3, 3), (7, 12), (40, 33), (224, 224)])
def test_blur_and_equalize_equal_opencv(hw):
    import cv2

    from bsyolo_tpu_torch.data.cv import equalize_hist, gaussian_blur5

    rng = np.random.default_rng(hw[0])
    for img in (rng.integers(0, 256, (*hw, 3), dtype=np.uint8), (rng.integers(0, 30, (*hw, 3)) * 7).astype(np.uint8)):
        np.testing.assert_array_equal(gaussian_blur5(img), cv2.GaussianBlur(img, (5, 5), 0))
        np.testing.assert_array_equal(gaussian_blur5(img[..., 0]), cv2.GaussianBlur(img[..., 0], (5, 5), 0))
        g = np.ascontiguousarray(img[..., 1])
        np.testing.assert_array_equal(equalize_hist(g), cv2.equalizeHist(g))
    flat = np.full(hw, 9, np.uint8)
    np.testing.assert_array_equal(equalize_hist(flat), cv2.equalizeHist(flat))


def test_photometric_ops_match_jax():
    from bsyolo_tpu.data import photometric as J

    from bsyolo_tpu_torch.data import photometric as P

    img = np.random.default_rng(2).integers(0, 256, (37, 50, 3), dtype=np.uint8)
    for b, c in ((0.1, -0.2), (-0.3, 0.5)):
        np.testing.assert_array_equal(P.brightness_contrast(img, b, c), J.brightness_contrast(img, b, c))
    for g in (0.5, 1.7):
        np.testing.assert_array_equal(P.gamma(img, g), J.gamma(img, g))
    for q in (75, 90):
        np.testing.assert_array_equal(P.jpeg_compression(img, q), J.jpeg_compression(img, q))


def _op_seeds():
    """The first seed whose generator's first draw picks each of RandAugment's 14 ops."""
    seeds = {}
    for s in range(300):
        seeds.setdefault(int(np.random.default_rng(s).integers(14)), s)
    return [seeds[k] for k in range(14)]


@pytest.mark.parametrize("op", range(14))
def test_rand_augment_ops_match_jax(op):
    from bsyolo_tpu.data.photometric import rand_augment as jra

    from bsyolo_tpu_torch.data.photometric import rand_augment

    seed = _op_seeds()[op]
    img = np.random.default_rng(op).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    img[10:30, 20:40] = (200, 30, 90)
    for magnitude in (9, 20):
        rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)
        a = jra(img.copy(), rj, num_ops=1, magnitude=magnitude)
        b = rand_augment(img.copy(), rp, num_ops=1, magnitude=magnitude)
        assert rj.random() == rp.random()  # the same draws were taken
        d = np.abs(a.astype(int) - b.astype(int))
        if op in AFFINE_OPS:
            assert d.max() <= 1 and (d > 0).mean() <= 0.02, (d.max(), (d > 0).mean())
        else:
            np.testing.assert_array_equal(b, a)


def _close_images(got, want):
    """Normalized images within 1 grey level, on at most 2 % of their values (RandAugment's warps;
    the HSV jitter's LUT on a few tail pixels, tests/test_torch_data.py)."""
    d = np.abs(got - want)
    assert d.max() <= 1.001 / 255 and (d > 1e-7).mean() <= 0.02, (d.max(), (d > 1e-7).mean())


@pytest.mark.parametrize("aa,erasing", [(None, 0.0), ("randaugment", 0.4), (None, 1.0)])
def test_classify_transforms_match_jax(aa, erasing):
    from bsyolo_tpu.data.photometric import classify_eval_transform as jeval, classify_train_transform as jtrain

    from bsyolo_tpu_torch.data.photometric import classify_eval_transform, classify_train_transform

    rng = np.random.default_rng(3)
    for hw in ((90, 120), (130, 70)):
        img = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
        for frac in (1.0, 0.875):
            np.testing.assert_array_equal(classify_eval_transform(img, 64, frac), jeval(img, 64, frac))
        for seed in range(6):
            rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)
            a = jtrain(img, rj, size=64, auto_augment=aa, erasing=erasing)
            b = classify_train_transform(img, rp, size=64, auto_augment=aa, erasing=erasing)
            assert rj.random() == rp.random() and b.dtype == np.float32 and b.shape == (64, 64, 3)
            _close_images(b, a)


def test_loader_batches_match_jax(tmp_path):
    from bsyolo_tpu.data.classify import ClassificationDataset as JDS, ClassifyLoader as JL

    from bsyolo_tpu_torch.data.classify import ClassificationDataset, ClassifyLoader

    root = write_cls_dataset(tmp_path, nc=3, n_train=5, n_val=2)
    for aug, aa in ((True, "randaugment"), (True, None), (False, None)):
        jd = JDS(root / "train", imgsz=32, augment=aug, auto_augment=aa)
        pd = ClassificationDataset(root / "train", imgsz=32, augment=aug, auto_augment=aa)
        assert pd.class_names == jd.class_names and pd.samples == jd.samples
        jl, pl = JL(jd, 4, shuffle=aug, seed=3, drop_last=aug), ClassifyLoader(pd, 4, shuffle=aug, seed=3, drop_last=aug)
        for ep in (0, 1):
            jl.set_epoch(ep)
            pl.set_epoch(ep)
            jb, pb = list(jl), list(pl)
            assert len(jb) == len(pb) == len(pl) == (3 if aug else 4)
            for a, b in zip(jb, pb):
                np.testing.assert_array_equal(b["cls"], a["cls"])
                _close_images(b["img"], a["img"])


def test_validator_matches_jax(cls):
    from bsyolo_tpu.engine.classify import ClassificationValidator as JVal

    from bsyolo_tpu_torch.engine.classify import ClassificationValidator

    jm, spec, v, port = cls
    rng = np.random.default_rng(4)
    batches = [{"img": np.zeros((b, 8, 8, 3), np.float32), "cls": rng.integers(0, 7, b)} for b in (5, 5, 3)]
    logits = [rng.normal(0, 1, (len(b["cls"]), 7)).astype(np.float32) for b in batches]
    it = iter(logits)
    jv = JVal(jm)
    jv._fwd = lambda variables, x: jnp.asarray(next(it))
    it2 = iter(logits)
    pv = ClassificationValidator(port.model, "cpu")
    pv._logits = lambda variables, img: torch.from_numpy(next(it2))
    want, got = jv(v, batches), pv(None, batches)
    assert got.results_dict == want.results_dict and 0 < got.top1 < got.top5 < 1


def test_predict_probs_and_results_match_jax(cls, tmp_path):
    from bsyolo_tpu.engine.predictor import DetectionPredictor
    from bsyolo_tpu.engine.results import Results as JResults

    from bsyolo_tpu_torch.engine.results import Results

    jm, spec, v, port = cls
    rng = np.random.default_rng(12)
    frames = [rng.integers(0, 256, (48, 64, 3), dtype=np.uint8), rng.integers(0, 256, (70, 50, 3), dtype=np.uint8)]
    want = DetectionPredictor(jm, spec, v, imgsz=IMG, batch=2, names=port.names)(frames)
    got = port.predict(frames, imgsz=IMG, batch=2)
    for g, w in zip(got, want):
        assert g.boxes is None and g.probs.data.shape == (2,)
        np.testing.assert_allclose(g.probs.data, np.asarray(w.probs.data), rtol=0, atol=1e-6)
    names = {i: f"k{i}" for i in range(8)}
    p = np.random.default_rng(5).dirichlet(np.ones(8)).astype(np.float32)
    r, j = (R(frames[0], "f.jpg", names, probs=p) for R in (Results, JResults))
    r.save_txt(tmp_path / "p.txt")
    j.save_txt(tmp_path / "j.txt")
    assert (tmp_path / "p.txt").read_text() == (tmp_path / "j.txt").read_text()
    assert r.summary() == j.summary() and r.probs.top5 == j.probs.top5 and r.probs.top1conf == j.probs.top1conf
    assert "k" in r.verbose_line and len(r) == 0


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    """One JAX and one port facade run of ``train`` (1 epoch), ``val`` and ``predict`` through
    ``YOLO("best.ckpt")``, both trainers' graphs built with the same drawn weights."""
    import bsyolo_tpu.engine.classify as JC
    from bsyolo_tpu import YOLO as JYOLO

    import bsyolo_tpu_torch.engine.classify as PC
    from bsyolo_tpu_torch import YOLO
    from bsyolo_tpu_torch.utils.weights import state_dict_from_jax
    from bsyolo_tpu.nn.model import DetectionGraph
    from torch_port import random_variables, to_plain_dict

    root = tmp_path_factory.mktemp("cls")
    data = write_cls_dataset(root / "ds", nc=2, n_train=8, n_val=4, seed=2)
    jm = DetectionGraph(jax_spec(CLS))
    v = to_plain_dict(random_variables(variable_shapes(jm, (1, 32, 32, 3)), 9))
    jbuild, pbuild = JC.build_model, PC.build_model

    def jfixed(spec, **kw):
        model, _ = jbuild(spec, **kw)
        return model, {k: jax.tree_util.tree_map(jnp.asarray, x) for k, x in v.items()}

    def pfixed(spec, device, seed=0, **kw):
        model = pbuild(spec, device, seed, **kw)
        model.load_state_dict(state_dict_from_jax(v), strict=True)
        return model

    kw = dict(data=str(data), epochs=1, imgsz=32, batch=8, nbs=8, optimizer="SGD", lr0=0.01, workers=0, amp=False,
              seed=3, project=str(root / "runs"))
    out = {"data": data}
    frames = [np.random.default_rng(9).integers(0, 256, (40, 48, 3), dtype=np.uint8)]
    JC.build_model, PC.build_model = jfixed, pfixed
    try:
        for side, Y, extra in (("jax", JYOLO, {}), ("port", YOLO, {"device": "cpu"})):
            m = Y(CLS, **extra)
            m.train(**kw, name=side)
            best = Y(str(root / "runs" / side / "weights" / "best.ckpt"), **extra)
            out[side] = {"train": m.metrics, "best": best, "val": best.val(data=str(data), batch=4, imgsz=32),
                         "pred": best.predict(frames, imgsz=32), "trainer": m.trainer}
    finally:
        JC.build_model, PC.build_model = jbuild, pbuild
    return out


def test_facade_train_val_predict_match_jax(legs):
    j, p = legs["jax"], legs["port"]
    assert p["best"].task == "classify" and p["best"].spec.nc == 2
    assert p["train"].results_dict == j["train"].results_dict
    assert p["val"].results_dict == j["val"].results_dict
    np.testing.assert_allclose(p["pred"][0].probs.data, np.asarray(j["pred"][0].probs.data), rtol=0, atol=1e-4)
    assert [w[2] for w in p["trainer"].loader_wait] == [2]


def test_cli_classify_task(legs, capsys, tmp_path):
    from bsyolo_tpu_torch.cli import TASK_MODELS, main

    assert TASK_MODELS["classify"] == "yolo11n-cls.yaml"
    best = str(Path(legs["port"]["trainer"].save_dir) / "weights" / "best.ckpt")
    src = str(legs["data"] / "val" / "c1")
    assert main(["classify", "predict", f"model={best}", "device=cpu", f"source={src}", "imgsz=32",
                 f"project={tmp_path}"]) == 0
    assert "top-1 classes" in capsys.readouterr().out
    assert main(["classify", "val", f"model={best}", "device=cpu", f"data={legs['data']}", "imgsz=32"]) == 0
    assert "metrics/accuracy_top1" in capsys.readouterr().out
