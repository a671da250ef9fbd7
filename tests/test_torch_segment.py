"""The port's Segment task (nn.heads Segment/Proto, ops.masks, the segment predictor, results,
validator, loss and train step, utils.coco RLE) against bsyolo_tpu, on the CPU.

tests/fixtures/tinyseg.yaml (nc 2, 8 prototypes) at imgsz 128 (imgsz 96 for the loss and the
step: the JAX loss takes its 100 mask anchors with ``jax.lax.top_k``, which needs at least 100
anchors), the same seeded weights on both sides, carried from JAX variables. Gates: the
parameter count of yolo11n-seg at full width equal; head maps and prototypes within rtol 1e-4;
``process_mask`` within 1e-5; predict rows with equal kept anchor indices, classes equal, boxes
within 1e-3 px; binarized masks at the frame's size equal wherever JAX's float mask is more than
1e-5 from 0.5 (``retina_masks`` alike); TAL masks identical and loss items within 2e-3; the
mask anchors selected as ``jax.lax.top_k`` selects them on tied weights; one SGD step within
tests/test_torch_train_step.py's gate; validator metrics on the same detections within 1e-6;
RLE and COCO dicts equal.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import jax
import jax.numpy as jnp
import torch

from torch_port import (jax_assign_weight, jax_spec, jax_val_batches, jittered_gt_rows, nchw, port_batch, port_spec,
                        task_batch, task_models, variable_shapes, write_task_dataset)

SEG = str(Path(__file__).parent / "fixtures" / "tinyseg.yaml")
PHOTO = Path(__file__).parent / "fixtures/bsyolo8/images/train/0.jpg"
IMG = 128


@pytest.fixture(scope="module")
def seg():
    return task_models(SEG, IMG, seed=4)


def test_parameter_count_at_full_width():
    from bsyolo_tpu.nn.model import DetectionGraph

    from bsyolo_tpu_torch.nn.model import build_model, count_params

    spec = port_spec("yolo11n-seg.yaml")
    assert spec.task == "segment" and spec.nc == 80 and spec.head.args[:3] == (80, 32, 64)
    shapes = variable_shapes(DetectionGraph(jax_spec("yolo11n-seg.yaml")), (1, 64, 64, 3))
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert count_params(build_model(spec, "cpu")) == want == 2876832


def test_head_maps_and_prototypes_match_jax(seg):
    jm, spec, v, port = seg
    x = np.random.default_rng(0).uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    want = jm.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port.model(torch.from_numpy(nchw(x)))
    assert port.task == "segment" and len(got["feats"]) == 2
    for g, w in zip(got["feats"], want["feats"]):
        assert g.shape[1] == 64 + 2 + 8
        np.testing.assert_allclose(g.numpy(), nchw(w), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["proto"].numpy(), nchw(want["proto"]), rtol=1e-4, atol=1e-4)


def test_mask_ops_match_jax():
    from bsyolo_tpu.ops import masks as J

    from bsyolo_tpu_torch.ops import masks as P

    rng = np.random.default_rng(1)
    proto = rng.normal(0, 2, (16, 20, 8)).astype(np.float32)
    coeffs = rng.normal(0, 1, (6, 8)).astype(np.float32)
    xy = rng.uniform(0, 60, (6, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(3, 30, (6, 2))], 1).astype(np.float32)
    for up in (True, False):
        want = J.process_mask(jnp.asarray(proto), jnp.asarray(coeffs), jnp.asarray(boxes), (64, 80), upsample=up)
        got = P.process_mask(torch.from_numpy(proto).permute(2, 0, 1), torch.from_numpy(coeffs),
                             torch.from_numpy(boxes), (64, 80), upsample=up)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    m = rng.uniform(0, 1, (3, 40, 50)).astype(np.float32)
    for size in ((17, 23), (80, 100), (40, 90)):
        np.testing.assert_allclose(P.scale_masks(torch.from_numpy(m), size).numpy(),
                                   np.asarray(J.scale_masks(jnp.asarray(m), size)), rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def frames():
    import cv2

    rng = np.random.default_rng(11)
    return [rng.integers(0, 256, (96, 128, 3), dtype=np.uint8), rng.integers(0, 256, (128, 100, 3), dtype=np.uint8),
            cv2.imread(str(PHOTO))]


def _jax_frame_masks(pred, frames, retina, results):
    """JAX's float masks at each frame's size, before the 0.5 threshold, from its predictor's own
    forward and host steps (``_to_results`` / ``_to_results_retina``, whose boxes in the frame's
    pixels come from ``results``)."""
    import cv2

    from bsyolo_tpu.ops.letterbox import letterbox_image, letterbox_params

    x = np.stack([np.ascontiguousarray(letterbox_image(f, (IMG, IMG))[0][..., ::-1]) for f in frames])
    outs = [np.asarray(o) for o in pred._forward(pred.variables, jnp.asarray(x))]
    res = []
    for i, f in enumerate(frames):
        h0, w0 = f.shape[:2]
        keep = outs[0][i][:, 4] > 0
        gain, (pw_f, ph_f), (ws, hs) = letterbox_params((h0, w0), (IMG, IMG))
        if not retina:
            ph, pw = round(ph_f - 0.1), round(pw_f - 0.1)
            m = outs[1][i][keep][:, ph : ph + hs, pw : pw + ws]
            res.append(np.stack([cv2.resize(k, (w0, h0), interpolation=cv2.INTER_LINEAR) for k in m]))
            continue
        c, proto = outs[1][i][keep], outs[2][i]
        ph, pw, nm = proto.shape
        m = 1.0 / (1.0 + np.exp(-(c @ proto.reshape(-1, nm).T).reshape(-1, ph, pw)))
        top, left = int(round(ph_f / IMG * ph - 0.1)), int(round(pw_f / IMG * pw - 0.1))
        m = m[:, max(top, 0) : ph - max(top, 0), max(left, 0) : pw - max(left, 0)]
        m = np.stack([cv2.resize(k, (w0, h0), interpolation=cv2.INTER_LINEAR) for k in m])
        x1, y1, x2, y2 = (np.asarray(results[i].boxes.data)[:, j].reshape(-1, 1, 1) for j in range(4))
        yy, xx = np.arange(h0, dtype=np.float32)[None, :, None], np.arange(w0, dtype=np.float32)[None, None, :]
        res.append(m * ((xx >= x1) & (xx < x2) & (yy >= y1) & (yy < y2)))
    return res


@pytest.mark.parametrize("retina", [False, True], ids=["masks", "retina_masks"])
def test_predict_rows_and_masks_match_jax(seg, frames, retina):
    from bsyolo_tpu.engine.predictor import DetectionPredictor

    jm, spec, v, port = seg
    pred = DetectionPredictor(jm, spec, v, conf=0.05, imgsz=IMG, batch=3, names=port.names, retina_masks=retina)
    want = pred(frames)
    got = port.predict(frames, imgsz=IMG, conf=0.05, batch=3, retina_masks=retina)
    floats = _jax_frame_masks(pred, frames, retina, want)
    n_masks = 0
    for g, w, f, mf in zip(got, want, frames, floats):
        gd, wd = g.boxes.data, np.asarray(w.boxes.data)
        assert gd.shape == wd.shape and len(gd) > 3
        np.testing.assert_array_equal(gd[:, 5], wd[:, 5])
        np.testing.assert_allclose(gd[:, :4], wd[:, :4], rtol=0, atol=1e-3)
        gm = g.masks.data
        assert gm.shape == (len(gd), *f.shape[:2]) and gm.dtype == np.float32
        np.testing.assert_array_equal(np.asarray(w.masks.data), (mf > 0.5).astype(np.float32))
        sure = np.abs(mf - 0.5) > 1e-5
        np.testing.assert_array_equal(gm[sure], (mf > 0.5)[sure])
        n_masks += int(gm.sum() > 0)
    assert n_masks >= 1


def test_predict_kept_anchor_indices_match_jax(seg):
    from bsyolo_tpu.kernels.postprocess import detect_postprocess as jpost

    from bsyolo_tpu_torch.kernels.postprocess import detect_postprocess

    jm, spec, v, port = seg
    x = np.random.default_rng(2).uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    jd, ji = jpost(jm.apply(v, jnp.asarray(x), train=False)["feats"], spec.head_strides, spec.nc, conf_thres=0.01,
                   return_idx=True)
    with torch.no_grad():
        pd, pi = detect_postprocess(port.model(torch.from_numpy(nchw(x)))["feats"], spec.head_strides, spec.nc,
                                    conf_thres=0.01, return_idx=True)
    assert int((np.asarray(ji) >= 0).sum()) > 20
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pd.numpy()[..., :4], np.asarray(jd)[..., :4], rtol=0, atol=1e-3)


def test_results_masks_and_unported_contours(seg, frames):
    (r,) = seg[3].predict(frames[0], imgsz=IMG, conf=0.05)
    assert r.keypoints is None and len(r.masks) == len(r)
    assert r[:2].masks.data.shape == (2, 96, 128)
    for call in (lambda: r.masks.xy, lambda: r.masks.xyn, lambda: r.save_txt("/nonexistent/x.txt")):
        with pytest.raises(NotImplementedError, match="item 31"):
            call()


def _loss_inputs(seg, size, seed=3, zero_head=False):
    jm, spec, v, _ = seg
    if zero_head:  # every anchor of a level gives the same logits: scores tie across the level
        v = jax.tree_util.tree_map(lambda a: a, v)
        for i in range(len(spec.head_strides)):
            for br in ("cv2", "cv3"):
                k = v["params"]["m7"]["detect"][f"{br}_{i}_2"]["kernel"]
                v["params"]["m7"]["detect"][f"{br}_{i}_2"]["kernel"] = np.zeros_like(k)
    batch = task_batch(seed, 2, size, 6, spec.nc, "segment")
    x = batch["img"].astype(np.float32) / 255
    jout = jm.apply(v, jnp.asarray(x), train=False)
    from bsyolo_tpu_torch.nn.model import build_model
    from bsyolo_tpu_torch.utils.weights import state_dict_from_jax

    pm = build_model(port_spec(SEG), "cpu")
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    with torch.no_grad():
        pout = pm(torch.from_numpy(nchw(x)))
    return spec, batch, jout, pout


@pytest.mark.parametrize("zero_head", [False, True], ids=["seeded", "tied"])
def test_segmentation_loss_and_tal_masks_match_jax(seg, zero_head):
    from bsyolo_tpu.losses.detect import DetectionLossConfig as JC, init_loss_state as jinit
    from bsyolo_tpu.losses.segment import segmentation_loss as jloss

    from bsyolo_tpu_torch.losses import DetectionLossConfig, init_loss_state, segmentation_loss
    from bsyolo_tpu_torch.losses.detect import detect_terms
    from bsyolo_tpu_torch.losses.segment import top_k_stable

    spec, batch, jout, pout = _loss_inputs(seg, 96, zero_head=zero_head)
    t = {k: torch.from_numpy(v) for k, v in batch.items() if k != "img"}
    _, want, _ = jloss(jout, *(jnp.asarray(batch[k]) for k in ("cls", "bboxes", "mask", "masks")), jinit(),
                       JC(nc=spec.nc, strides=spec.head_strides), nm=8)
    _, got, _ = segmentation_loss(pout, t["cls"].long(), t["bboxes"], t["mask"], t["masks"], init_loss_state(),
                                  DetectionLossConfig(nc=spec.nc, strides=spec.head_strides), nm=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3, atol=1e-6)
    jassign, jw = jax_assign_weight(jout["feats"], batch["cls"], batch["bboxes"], batch["mask"], spec.nc,
                                    spec.head_strides)
    terms = detect_terms(pout["feats"], t["cls"].long(), t["bboxes"], t["mask"], init_loss_state(),
                         DetectionLossConfig(nc=spec.nc, strides=spec.head_strides))
    np.testing.assert_array_equal(terms.assign.fg_mask.numpy(), jassign.fg_mask)
    np.testing.assert_array_equal(terms.assign.target_gt_idx.numpy(), jassign.target_gt_idx)
    # the 100 mask anchors: most weights are 0 and tie, so the order among ties decides which are taken
    _, want_idx = jax.lax.top_k(jnp.asarray(jw), 100)
    _, got_idx = top_k_stable(terms.weight, 100)
    assert int((jw == 0).sum(1).min()) > 100
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))


def test_top_k_stable_breaks_ties_as_jax():
    from bsyolo_tpu_torch.losses.segment import top_k_stable

    x = np.random.default_rng(5).integers(0, 4, (3, 257)).astype(np.float32) / 4
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 100)
    got_v, got_i = top_k_stable(torch.from_numpy(x), 100)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_sgd_step_matches_jax(seg):
    """One SGD step with the segmentation loss from the same weights and batch."""
    from bsyolo_tpu.engine.optim import OptimConfig as JOpt
    from bsyolo_tpu.engine.train_step import StepConfig as JStep, init_train_state as jinit, make_train_step as jmake
    from bsyolo_tpu.losses import DetectionLossConfig as JLoss
    from bsyolo_tpu.losses.segment import segmentation_loss as jloss

    from bsyolo_tpu_torch.engine.optim import OptimConfig
    from bsyolo_tpu_torch.engine.train_step import StepConfig, init_train_state, make_train_step, task_criterion
    from bsyolo_tpu_torch.losses import DetectionLossConfig
    from bsyolo_tpu_torch.nn.model import build_model
    from bsyolo_tpu_torch.utils.weights import state_dict_from_jax, train_state_to_jax
    from test_torch_train_step import _compare_states

    jm, spec, v, _ = seg
    common = dict(batch_size=2, nb=5, nw=2, use_adamw=False, weight_decay=0.0005)
    okw = dict(name="SGD", lr0=0.01, epochs=4, nbs=2, warmup_bias_lr=0.1)

    def jcrit(outputs, batch, ls, lc):
        return jloss(outputs, batch["cls"], batch["bboxes"], batch["mask"], batch["masks"], ls, lc, nm=8)

    jcfg = JStep(loss=JLoss(nc=spec.nc, strides=spec.head_strides), optim=JOpt(**okw), **common)
    jstep = jmake(jm, jcfg, criterion=jcrit, item_names=("box_loss", "seg_loss", "cls_loss", "dfl_loss"))
    jstate = jinit({k: jax.tree_util.tree_map(jnp.asarray, x) for k, x in v.items()}, jcfg)
    pm = build_model(port_spec(SEG), "cpu")
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    pcfg = StepConfig(loss=DetectionLossConfig(nc=spec.nc, strides=spec.head_strides), optim=OptimConfig(**okw),
                      **common)
    pstate = init_train_state(pm, pcfg)
    pstep = make_train_step(pm, pcfg, *task_criterion(pm.spec))
    batch = task_batch(7, 2, 96, 6, spec.nc, "segment")
    jstate, jmet = jstep(jstate, {k: jnp.asarray(x) for k, x in batch.items()})
    want = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), jstate)
    pb = port_batch(batch)
    pstate, pmet = pstep(pstate, {k: torch.as_tensor(x).long() if k == "cls" else torch.as_tensor(x)
                                  for k, x in pb.items()})
    _compare_states(train_state_to_jax(pstate, want), want)
    for k in ("loss", "box_loss", "seg_loss", "cls_loss", "dfl_loss"):
        np.testing.assert_allclose(float(pmet[k]), float(jmet[k]), rtol=1e-4, err_msg=k)


def test_validator_metrics_match_jax(seg, tmp_path):
    """Both validators over the JAX loader's batches of a seeded polygon dataset, fed the same
    detections (the ground truths, jittered) and masks (each box filled: constant prototypes)."""
    from bsyolo_tpu.engine.validator import SegmentationValidator as JVal
    from bsyolo_tpu.ops.masks import process_mask as jmask

    from bsyolo_tpu_torch.engine.validator import SegmentationValidator

    jm, spec, v, port = seg
    data = write_task_dataset(tmp_path / "ds", "segment", n_train=1, n_val=10)
    batches = jax_val_batches(data, "segment", 64)
    rng = np.random.default_rng(8)
    rows = [jittered_gt_rows(b, rng) for b in batches]
    nm, size = 8, 64
    proto = np.ones((len(batches[0]["img"]), size // 4, size // 4, nm), np.float32)
    coeffs = np.full((len(batches[0]["img"]), 20, nm), 0.5, np.float32)
    it = iter(rows)

    def jax_forward(variables, img):
        d = next(it)
        m = jax.vmap(lambda p, c, bx: jmask(p, c, bx, (size, size), upsample=False))(
            jnp.asarray(proto), jnp.asarray(coeffs), jnp.asarray(d[..., :4]))
        return jnp.asarray(d), (m > 0.5) & (jnp.asarray(d[..., 4]) > 0)[..., None, None]

    jv = JVal(jm, spec, names={0: "a", 1: "b"})
    jv._forward = jax_forward
    want = jv(v, batches).results_dict
    it2 = iter(rows)
    pv = SegmentationValidator(port.model, port.spec, names={0: "a", 1: "b"}, device="cpu",
                               forward_fn=lambda variables, img: (torch.from_numpy(next(it2)),
                                                                  torch.from_numpy(coeffs),
                                                                  torch.from_numpy(proto).permute(0, 3, 1, 2)))
    got = pv(None, [port_batch(b) for b in batches]).results_dict
    assert got.keys() == want.keys() and want["metrics/mAP50(M)"] > 0.1
    np.testing.assert_allclose([float(got[k]) for k in want], [float(want[k]) for k in want], rtol=0, atol=1e-6)


def test_rle_and_seg_json_match_jax():
    from bsyolo_tpu.utils import coco as J

    from bsyolo_tpu_torch.utils import coco as P

    rng = np.random.default_rng(9)
    masks = rng.uniform(0, 1, (4, 23, 31)) < np.array([0.0, 0.3, 0.7, 1.0])[:, None, None]
    for m in masks:
        assert P.encode_rle(m) == J.encode_rle(m)
        np.testing.assert_array_equal(P.decode_rle(P.encode_rle(m)), m.astype(np.uint8))
    dets = np.concatenate([rng.uniform(0, 20, (4, 4)), np.array([[0.9], [0.0], [0.4], [0.6]]),
                           rng.integers(0, 3, (4, 1))], 1)
    assert P.seg_pred_to_json(dets, masks, "images/12.jpg", class_map=[3, 5, 7]) == \
        J.seg_pred_to_json(dets, masks, "images/12.jpg", class_map=[3, 5, 7])


def test_unported_modes_on_task_graphs_raise_and_augment_reverts(seg, frames, tmp_path):
    """bf16 (half, amp) and int8 on a Segment graph run (ROADMAP item 12, refused until it was ported;
    tests/test_torch_task_bf16.py and test_torch_task_int8.py hold them against JAX); tiled predict
    raises, as the JAX package serves it for Detect graphs only;
    augment=True warns and predicts at one scale, as the JAX predictor does; the task follows the
    head, and the CLI takes the task's word."""
    from bsyolo_tpu_torch import YOLO
    from bsyolo_tpu_torch.cli import main
    from bsyolo_tpu_torch.engine.tiled import predict_tiled
    from bsyolo_tpu_torch.engine.trainer import DetectionTrainer
    from bsyolo_tpu_torch.nn.model import compute_dtype
    from bsyolo_tpu_torch.nn.modules import int8_inference, set_int8_inference

    port = seg[3]
    data = str(write_task_dataset(tmp_path / "ds", "segment", n_train=2, n_val=2))
    assert len(port.predict(frames[0], imgsz=IMG, half=True)[0].masks.data) and port._half is not None
    set_int8_inference(port.model, True)
    try:
        assert int8_inference(port.model) and port.predict(frames[0], imgsz=IMG)[0].masks is not None
    finally:
        set_int8_inference(port.model, False)
    trainer = DetectionTrainer(overrides=dict(model=SEG, data=data, device="cpu", plots=False, project=str(tmp_path)))
    trainer.setup()  # amp=True, the default: the bf16 graph
    assert compute_dtype(trainer.model) == torch.bfloat16
    with pytest.raises(NotImplementedError, match="Detect graphs only"):
        predict_tiled(port.model, port.spec, frames[0], tile=64)
    plain = port.predict(frames[:2], imgsz=IMG, conf=0.05)
    tta = port.predict(frames[:2], imgsz=IMG, conf=0.05, augment=True)
    for a, b in zip(plain, tta):
        np.testing.assert_array_equal(a.boxes.data, b.boxes.data)
        np.testing.assert_array_equal(a.masks.data, b.masks.data)
    with pytest.raises(ValueError, match="Segment head"):
        YOLO(SEG, task="pose", device="cpu")
    with pytest.raises(NotImplementedError, match="Detect head"):
        YOLO(str(Path(__file__).parent / "fixtures" / "tiny.yaml"), device="cpu").predict(frames[0], imgsz=64,
                                                                                          retina_masks=True)
    assert YOLO(SEG, task="segment", device="cpu").task == "segment"
    import cv2

    cv2.imwrite(str(tmp_path / "a.png"), frames[0])
    assert main(["segment", "predict", f"model={SEG}", "device=cpu", f"source={tmp_path}", "imgsz=64",
                 "retina_masks=True"]) == 0
    with pytest.raises(ValueError, match="Segment head"):
        main(["pose", "predict", f"model={SEG}", "device=cpu", f"source={tmp_path}"])
