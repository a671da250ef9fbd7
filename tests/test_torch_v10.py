"""YOLOv10 in the PyTorch port (v10Detect, its end-to-end loss, the NMS-free predict and val) against bsyolo_tpu.

``postprocess_e2e`` rows equal to JAX's (ties to the lower index, as ``jax.lax.top_k``); the end-to-end loss
(one-to-many at top-10 plus one-to-one at top-1, as the JAX trainer's criterion) within 2e-3 of JAX's on
yolov10n's head at 64 px; one SGD step of a tiny v10 graph (tests/fixtures/tiny.yaml with a v10Detect head)
within tests/test_torch_train_step.py's gate; ``YOLO.predict`` and ``YOLO.val`` of that graph against the JAX
facade: predict rows paired (class equal, score within 1e-5, box within 1e-3 px), val metrics within 1e-6 on
weights trained to carry signal.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import jax
import jax.numpy as jnp
import torch

from torch_port import (jax_spec, nchw, port_batch, port_module_from_jax, port_spec, random_variables, task_batch,
                        to_plain_dict, trained_task_checkpoint, variable_shapes)

TINY = Path(__file__).parent / "fixtures" / "tiny.yaml"
IMG = 64


@pytest.fixture(scope="module")
def tiny_v10(tmp_path_factory):
    """tests/fixtures/tiny.yaml with its Detect head swapped for v10Detect."""
    path = tmp_path_factory.mktemp("v10") / "tinyv10.yaml"
    path.write_text(TINY.read_text().replace(", Detect, [nc]]", ", v10Detect, [nc]]"))
    return str(path)


@pytest.fixture(scope="module")
def v10n():
    from bsyolo_tpu.nn.model import DetectionGraph

    from bsyolo_tpu_torch.nn.model import build_model

    jm = DetectionGraph(jax_spec("yolov10n.yaml"))
    v = to_plain_dict(random_variables(variable_shapes(jm, (1, IMG, IMG, 3)), seed=3))
    return jm, v, port_module_from_jax(build_model(port_spec("yolov10n.yaml"), "cpu"), v)


def _jax_e2e(outputs, batch, ls, lc):
    """The JAX trainer's criterion for a v10Detect graph (bsyolo_tpu/engine/trainer.py, E2EDetectLoss)."""
    from bsyolo_tpu.losses.detect import detection_loss

    t1, i1, new_ls = detection_loss(outputs["one2many"], batch["cls"], batch["bboxes"], batch["mask"], ls, lc)
    t2, i2, _ = detection_loss(outputs["one2one"], batch["cls"], batch["bboxes"], batch["mask"], ls,
                               lc._replace(tal_topk=1))
    return t1 + t2, i1 + i2, new_ls


@pytest.mark.parametrize("tied", [False, True], ids=["seeded", "tied"])
def test_postprocess_e2e_matches_jax(tied):
    from bsyolo_tpu.nn.heads import postprocess_e2e as jpost

    from bsyolo_tpu_torch.nn.heads import postprocess_e2e

    rng = np.random.default_rng(4)
    b, a, nc = 2, 700, 7
    xywh = np.concatenate([rng.uniform(0, 600, (b, a, 2)), rng.uniform(1, 90, (b, a, 2))], -1)
    scores = rng.integers(0, 6, (b, a, nc)) / 8 if tied else rng.uniform(0, 1, (b, a, nc))  # ties everywhere
    preds = np.concatenate([xywh, scores], -1).astype(np.float32)
    for max_det in (300, 1000):
        want = np.asarray(jpost(jnp.asarray(preds), max_det=max_det, nc=nc))
        got = postprocess_e2e(torch.from_numpy(preds), max_det=max_det, nc=nc).numpy()
        assert got.shape == want.shape == (b, min(max_det, a), 6)
        np.testing.assert_array_equal(got, want)


def _order_near_ties(rows, ref, rtol):
    """``rows`` (B, n, 6) with each run of rows whose ``ref`` scores lie within ``rtol`` of the row before
    ordered by (class, box): two rows of near-equal score may come in either order from the two packages
    (tests/test_torch_rtdetr.py reorders near-tied queries the same way)."""
    out = rows.copy()
    for b in range(rows.shape[0]):
        s = ref[b, :, 4]
        start = 0
        for i in range(1, len(s) + 1):
            if i == len(s) or abs(s[i] - s[i - 1]) > rtol * abs(s[i - 1]):
                run = rows[b, start:i]
                out[b, start:i] = run[np.lexsort((run[:, 3], run[:, 2], run[:, 1], run[:, 0], run[:, 5]))]
                start = i
    return out


def test_decoded_one_to_one_head_rows_match_jax(v10n, rng):
    """yolov10n's one-to-one head decoded (``decode_detections``, the xywh decode's plain version on the CPU) and
    selected: rows as JAX's."""
    from bsyolo_tpu.nn.heads import decode_detections as jdecode, postprocess_e2e as jpost

    from bsyolo_tpu_torch.nn.heads import decode_detections, postprocess_e2e

    jm, v, port = v10n
    x = rng.uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    jout = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, jnp.asarray(x))
    want = np.asarray(jpost(jdecode(jout["one2one"], (8, 16, 32), 80), max_det=300, nc=80))
    with torch.no_grad():
        got = postprocess_e2e(decode_detections(port(torch.from_numpy(nchw(x)))["one2one"], (8, 16, 32), 80), 300,
                              80).numpy()
    assert got.shape == want.shape == (2, 84, 6)
    got, want = _order_near_ties(got, want, rtol=1e-5), _order_near_ties(want, want, rtol=1e-5)
    np.testing.assert_array_equal(got[..., 5], want[..., 5])
    np.testing.assert_allclose(got[..., 4], want[..., 4], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=0, atol=1e-3)


def test_e2e_loss_matches_the_jax_trainers_criterion(v10n):
    from bsyolo_tpu.losses.detect import DetectionLossConfig as JC, init_loss_state as jinit

    from bsyolo_tpu_torch.engine.train_step import e2e_criterion, task_criterion
    from bsyolo_tpu_torch.losses import DetectionLossConfig, init_loss_state

    jm, v, port = v10n
    assert task_criterion(port.spec) == (e2e_criterion, ("box_loss", "cls_loss", "dfl_loss"))
    batch = task_batch(5, 2, IMG, 6, 80, "detect")
    x = batch["img"].astype(np.float32) / 255
    jout = jm.apply(v, jnp.asarray(x), train=False)
    jb = {k: jnp.asarray(batch[k]) for k in ("cls", "bboxes", "mask")}
    wt, wi, wls = _jax_e2e(jout, jb, jinit(), JC(nc=80, strides=(8, 16, 32)))
    with torch.no_grad():
        pout = port(torch.from_numpy(nchw(x)))
    pb = {k: torch.from_numpy(batch[k]) for k in ("cls", "bboxes", "mask")}
    pb["cls"] = pb["cls"].long()
    gt, gi, gls = e2e_criterion(pout, pb, init_loss_state(), DetectionLossConfig(nc=80, strides=(8, 16, 32)))
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(float(gt), float(wt), rtol=2e-3)
    assert int(gls.updates) == int(wls.updates)
    np.testing.assert_allclose(float(gls.iou_mean), float(wls.iou_mean), rtol=2e-3)


def test_sgd_step_matches_jax(tiny_v10):
    """One SGD step with the end-to-end loss from the same weights and batch: params, EMA, BatchNorm statistics
    (the one-to-one branch's too, which trains on detached levels) and momentum as the JAX step's."""
    from bsyolo_tpu.engine.optim import OptimConfig as JOpt
    from bsyolo_tpu.engine.train_step import StepConfig as JStep, init_train_state as jinit, make_train_step as jmake
    from bsyolo_tpu.losses import DetectionLossConfig as JLoss
    from bsyolo_tpu.nn.model import DetectionGraph

    from bsyolo_tpu_torch.engine.optim import OptimConfig
    from bsyolo_tpu_torch.engine.train_step import StepConfig, init_train_state, make_train_step, task_criterion
    from bsyolo_tpu_torch.losses import DetectionLossConfig
    from bsyolo_tpu_torch.nn.model import build_model
    from bsyolo_tpu_torch.utils.weights import state_dict_from_jax, train_state_to_jax
    from test_torch_train_step import _compare_states

    spec = jax_spec(tiny_v10)
    jm = DetectionGraph(spec)
    v = to_plain_dict(random_variables(variable_shapes(jm, (1, IMG, IMG, 3)), seed=6))
    common = dict(batch_size=2, nb=5, nw=2, use_adamw=False, weight_decay=0.0005)
    okw = dict(name="SGD", lr0=0.01, epochs=4, nbs=2, warmup_bias_lr=0.1)
    jcfg = JStep(loss=JLoss(nc=spec.nc, strides=spec.head_strides), optim=JOpt(**okw), **common)
    jstep = jmake(jm, jcfg, criterion=_jax_e2e, item_names=("box_loss", "cls_loss", "dfl_loss"))
    jstate = jinit({k: jax.tree_util.tree_map(jnp.asarray, x) for k, x in v.items()}, jcfg)
    pm = build_model(port_spec(tiny_v10), "cpu")
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    pcfg = StepConfig(loss=DetectionLossConfig(nc=spec.nc, strides=spec.head_strides), optim=OptimConfig(**okw),
                      **common)
    pstate = init_train_state(pm, pcfg)
    pstep = make_train_step(pm, pcfg, *task_criterion(pm.spec))
    batch = {k: x for k, x in task_batch(7, 2, IMG, 6, spec.nc, "detect").items() if k != "keypoints"}
    jstate, jmet = jstep(jstate, {k: jnp.asarray(x) for k, x in batch.items()})
    want = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), jstate)
    pstate, pmet = pstep(pstate, {k: torch.as_tensor(x).long() if k == "cls" else torch.as_tensor(x)
                                  for k, x in port_batch(batch).items()})
    _compare_states(train_state_to_jax(pstate, want), want)
    for k in ("loss", "box_loss", "cls_loss", "dfl_loss"):
        np.testing.assert_allclose(float(pmet[k]), float(jmet[k]), rtol=1e-4, err_msg=k)
    one2one_bn = "model.8.one2one_cv2.0.0.bn.running_mean"
    assert not np.allclose(pstate.batch_stats[one2one_bn].numpy(), state_dict_from_jax(v)[one2one_bn].numpy())


def _paired(got, want, box_px=1e-3, score_rtol=1e-5):
    """How many of ``want``'s rows pair one to one with a row of ``got`` of the same class, score and box."""
    free, n = np.ones(len(got), bool), 0
    for row in want:
        ok = free & (got[:, 5] == row[5]) & (np.abs(got[:, 4] - row[4]) <= score_rtol * abs(row[4])) & (
            np.abs(got[:, :4] - row[:4]).max(1) <= box_px)
        if ok.any():
            free[np.flatnonzero(ok)[0]] = False
            n += 1
    return n


def test_predict_matches_the_jax_facade(tiny_v10):
    """NMS-free predict on seeded weights: each frame's rows (those above conf of the one-to-one head's top
    300) pair with the JAX facade's; augment warns and predicts at one scale; tiled predict refuses the graph."""
    from bsyolo_tpu import YOLO as JaxYOLO
    from bsyolo_tpu.nn.model import DetectionGraph

    from bsyolo_tpu_torch import YOLO
    from bsyolo_tpu_torch.engine.tiled import predict_tiled

    rng = np.random.default_rng(8)
    frames = [rng.integers(0, 256, (48, 64, 3), dtype=np.uint8), rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)]
    v = to_plain_dict(random_variables(variable_shapes(DetectionGraph(jax_spec(tiny_v10)), (1, IMG, IMG, 3)), 9))
    jy = JaxYOLO(tiny_v10)
    jy.variables = v
    port = YOLO(tiny_v10, device="cpu")
    port_module_from_jax(port.model, v)
    kw = dict(imgsz=IMG, conf=0.3, batch=2)
    want = [np.asarray(r.boxes.data) for r in jy.predict(frames, **kw)]
    got = [r.boxes.data for r in port.predict(frames, **kw)]
    for g, w in zip(got, want):
        assert len(g) == len(w) >= 5 and _paired(g, w) == len(w)
    tta = [r.boxes.data for r in port.predict(frames, augment=True, **kw)]
    for a, b in zip(got, tta):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(NotImplementedError, match="v10Detect"):
        predict_tiled(port.model, port.spec, frames[0], tile=64)


def test_train_and_val_match_the_jax_facade(tiny_v10, tmp_path):
    """``YOLO.train`` in the port (the end-to-end loss) to weights that carry signal, then ``val`` of the same
    checkpoint in both facades: NMS-free, every metric within 1e-6."""
    from bsyolo_tpu import YOLO as JaxYOLO

    from bsyolo_tpu_torch import YOLO

    best, data = trained_task_checkpoint(tmp_path, "detect", tiny_v10, epochs=40)
    trained = YOLO(best, device="cpu")
    assert trained.spec.head.module == "v10Detect"
    got = trained.val(data=str(data), batch=4, imgsz=IMG).results_dict
    want = JaxYOLO(str(best)).val(data=str(data), batch=4, imgsz=IMG).results_dict
    assert got.keys() == want.keys() and float(want["metrics/mAP50(B)"]) > 0.3
    np.testing.assert_allclose([float(got[k]) for k in want], [float(want[k]) for k in want], rtol=0, atol=1e-6)


def test_cli_trains_validates_and_predicts_a_v10_graph(tiny_v10, tmp_path, capsys):
    """The CLI's train (the end-to-end loss), val and predict of a v10Detect graph."""
    from bsyolo_tpu_torch.cli import main
    from test_torch_data import write_dataset

    data = write_dataset(tmp_path / "ds", n_train=4, n_val=4)
    assert main(["train", f"model={tiny_v10}", f"data={data}", "epochs=1", "imgsz=64", "batch=4", "nbs=4", "workers=0",
                 "plots=False", "amp=False", "device=cpu", f"project={tmp_path}", "name=cli"]) == 0
    best = tmp_path / "cli" / "weights" / "best.ckpt"
    assert main(["detect", "val", f"model={best}", f"data={data}", "imgsz=64", "batch=4", "device=cpu"]) == 0
    capsys.readouterr()
    assert main(["predict", f"model={best}", f"source={data.parent / 'images' / 'val'}", "imgsz=64", "conf=0.0001",
                 "device=cpu", f"project={tmp_path}", "name=pred"]) == 0
    lines = capsys.readouterr().out.splitlines()  # the command line logs each frame and saves its drawing, as JAX's
    assert len(lines) == 5 and lines[-1].startswith("4 frames")
    assert len(list((tmp_path / "pred").glob("*.jpg"))) == 4
