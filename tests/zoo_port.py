"""Shared pieces of the zoo tests (tests/test_torch_zoo_*.py): the graph files of the YOLO v3, v5, v6, v8,
v9 and v10 families the port bundles, and the check that a graph's parameters are the JAX package's."""

from __future__ import annotations

import numpy as np

# each file builds at its first scale (v3 and v9 have none)
GRAPHS_V3_V8 = (
    "yolov3.yaml", "yolov3-tiny.yaml", "yolov3-spp.yaml", "yolov5.yaml", "yolov5-p6.yaml", "yolov6.yaml",
    "yolov8.yaml", "yolov8-seg.yaml", "yolov8-seg-p6.yaml", "yolov8-pose.yaml", "yolov8-pose-p6.yaml",
    "yolov8-obb.yaml", "yolov8-cls.yaml", "yolov8-cls-resnet50.yaml", "yolov8-cls-resnet101.yaml", "yolov8-p2.yaml",
    "yolov8-p6.yaml", "yolov8-ghost.yaml", "yolov8-ghost-p2.yaml", "yolov8-ghost-p6.yaml",
)
GRAPHS_V9_V11 = (
    "yolov9t.yaml", "yolov9s.yaml", "yolov9m.yaml", "yolov9c.yaml", "yolov9e.yaml", "yolov9c-seg.yaml",
    "yolov9e-seg.yaml", "yolov10.yaml", "yolov10n.yaml", "yolov10s.yaml", "yolov10m.yaml", "yolov10b.yaml",
    "yolov10l.yaml", "yolov10x.yaml", "yolo11-stock.yaml", "yolo11-tpu.yaml",
)


def _torch_shape(shape, leaf: str):
    if leaf != "kernel":
        return tuple(shape)
    perm = {4: (3, 2, 0, 1), 3: (2, 1, 0), 2: (1, 0)}.get(len(shape))
    return tuple(shape[i] for i in perm) if perm else tuple(shape)


def assert_graph_is_jax(name: str) -> None:
    """The port's spec of ``name`` (module, inputs, repeats, arguments, widths, strides of every layer; the saved
    layers, task, classes, head strides, activation) and its graph's parameters and BatchNorm statistics (count,
    names, shapes) equal the JAX package's, and ``jax_paths`` maps every tensor back onto its JAX path."""
    import jax

    from bsyolo_tpu.nn.model import DetectionGraph, count_params as jax_count

    from bsyolo_tpu_torch.nn.model import build_model, count_params
    from bsyolo_tpu_torch.utils.weights import flax_path_to_torch_key, jax_paths
    from torch_port import jax_spec, port_spec, variable_shapes

    js, ps = jax_spec(name), port_spec(name)
    assert [(l.module, l.f, l.n, l.args, l.c1, l.c2, l.stride) for l in ps.layers] == \
        [(l.module, l.f, l.n, l.args, l.c1, l.c2, l.stride) for l in js.layers]
    assert (ps.save, ps.task, ps.nc, ps.head_strides, ps.act, ps.scale, ps.kpt_shape) == \
        (js.save, js.task, js.nc, js.head_strides, js.act, js.scale, js.kpt_shape)
    shapes = variable_shapes(DetectionGraph(js), (1, 64, 64, 3))
    want = {}
    for collection, tree in shapes.items():
        for path, s in jax.tree_util.tree_flatten_with_path(tree)[0]:
            keys = tuple(p.key for p in path)
            want[flax_path_to_torch_key(collection, keys)] = (collection, keys, _torch_shape(s.shape, keys[-1]))
    port = build_model(ps, "cpu")
    assert count_params(port) == jax_count(shapes)
    got = {k: tuple(v.shape) for k, v in port.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert got == {k: v[2] for k, v in want.items()}
    assert jax_paths(port) == {k: v[:2] for k, v in want.items()}


# augmentation whose pixels the port reproduces byte for byte (tests/test_torch_trainer.py EXACT_PIXELS)
EXACT_PIXELS = dict(translate=0.0, scale=0.0, hsv_h=0.0, hsv_s=0.0, hsv_v=0.0)


def facade_legs(root, yaml: str, task: str, imgsz: int, fit_epochs: int):
    """A graph of ``task`` fitted in the port to a seeded set that is its own validation split
    (``torch_port.trained_task_checkpoint``), then one more epoch of ``YOLO.train`` in each facade from that
    checkpoint (SGD, batch 8, amp off, mosaic on, flips on, warps and HSV off, so both see the same batches):
    returns {"data", "best", "jax": the JAX facade, "port": the port's}."""
    from pathlib import Path

    from bsyolo_tpu import YOLO as JaxYOLO

    from bsyolo_tpu_torch import YOLO
    from torch_port import trained_task_checkpoint

    root = Path(root)
    best, data = trained_task_checkpoint(root / "fit", task, yaml, epochs=fit_epochs, imgsz=imgsz)
    kw = dict(data=str(data), epochs=1, imgsz=imgsz, batch=8, nbs=8, optimizer="SGD", lr0=0.002, warmup_epochs=0.0,
              workers=0, amp=False, plots=False, close_mosaic=0, seed=3, max_gt=16, pretrained=str(best),
              project=str(root / "runs"), **EXACT_PIXELS)
    jy, port = JaxYOLO(yaml), YOLO(yaml, device="cpu")
    jy.train(**kw, name="jax")
    port.train(**kw, name="port")
    return {"data": data, "best": best, "jax": jy, "port": port}


def rel_norm(a, b) -> float:
    """||a - b|| / ||b||, the norm floored at 1e-5 (tests/test_torch_trainer.py's)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-5))


def leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def assert_legs_match(legs, losses) -> None:
    """The leg's loss items (2e-3), its params, EMA and BatchNorm statistics after the epoch (1e-3 of each tensor's
    norm) and its validation metrics on weights that carry signal (1e-6) equal the JAX trainer's."""
    import csv

    from bsyolo_tpu_torch.utils.weights import train_state_to_jax

    jt, pt = legs["jax"].trainer, legs["port"].trainer
    with open(jt.csv_path) as f, open(pt.csv_path) as g:
        (rj,), (rp,) = list(csv.DictReader(f)), list(csv.DictReader(g))
    assert rj.keys() == rp.keys()
    for k in losses:
        np.testing.assert_allclose(float(rp[k]), float(rj[k]), rtol=2e-3, err_msg=k)
    ps = train_state_to_jax(pt.state, jt.state)
    for field in ("params", "ema_params", "batch_stats"):
        want, got = dict(leaves(getattr(jt.state, field))), dict(leaves(ps[field]))
        assert got.keys() == want.keys()
        worst = max(rel_norm(got[k], want[k]) for k in want)
        assert worst <= 1e-3, (field, worst)
    jm, pm = jt.metrics.results_dict, pt.metrics.results_dict
    assert jm.keys() == pm.keys() and float(jm["metrics/mAP50(B)"]) > 0.3
    np.testing.assert_allclose([float(pm[k]) for k in jm], [float(jm[k]) for k in jm], rtol=0, atol=1e-6)


def paired_rows(got, want, box_px: float = 1e-3, score_rtol: float = 1e-5):
    """(got row, want row) of each of ``want``'s rows that pairs one to one with a row of ``got`` of the same class
    and, within the tolerances, score and box."""
    free, pairs = np.ones(len(got), bool), []
    for j, row in enumerate(want):
        ok = free & (got[:, 5] == row[5]) & (np.abs(got[:, 4] - row[4]) <= score_rtol * abs(row[4])) & (
            np.abs(got[:, :4] - row[:4]).max(1) <= box_px)
        if ok.any():
            i = int(np.flatnonzero(ok)[0])
            free[i] = False
            pairs.append((i, j))
    return pairs
