"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Both packages get the same numbers: JAX variables are drawn with numpy from a
seed on the shapes ``jax.eval_shape`` reports for ``model.init`` (nothing
compiles), then carried into the port with ``state_dict_from_jax``. Weights
are drawn at U(+-sqrt(3 / fan_in)) with BatchNorm statistics away from the
identity, so the head's logits carry signal: at the default init they are
the bias alone and their order would be decided by float rounding.
"""

from __future__ import annotations

import numpy as np


def jax_spec(name: str, scale: str = ""):
    from bsyolo_tpu.cfg import model_yaml_path
    from bsyolo_tpu.nn import load_model_yaml, parse_model_yaml

    d = load_model_yaml(model_yaml_path(name))
    return parse_model_yaml(d, scale=scale or d.get("scale", ""))


def port_spec(name: str, scale: str = ""):
    from bsyolo_tpu_torch.cfg import model_yaml_path
    from bsyolo_tpu_torch.nn.parser import load_model_yaml, parse_model_yaml

    d = load_model_yaml(model_yaml_path(name))
    return parse_model_yaml(d, scale=scale or d.get("scale", ""))


def variable_shapes(module, x_shape):
    """Variable shapes of a flax module's init, without compiling it."""
    import jax
    import jax.numpy as jnp

    return jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros(x_shape, jnp.float32), train=False))


def random_variables(shapes, seed: int = 0):
    """Fill a variables shape-tree with seeded numpy draws (see module docstring)."""
    import jax

    rng = np.random.default_rng(seed)

    def draw(path, s):
        leaf = path[-1].key
        shape = tuple(s.shape)
        if leaf == "kernel":
            b = np.sqrt(3.0 / int(np.prod(shape[:-1])))
            v = rng.uniform(-b, b, shape)
        elif leaf in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif leaf in ("ch_weight", "sp_weight", "res_weight"):
            v = rng.uniform(-1.0, 1.0, shape)
        else:  # bias, mean
            v = rng.uniform(-0.1, 0.1, shape)
        return v.astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return jax.tree_util.tree_map(np.asarray, tree)


def to_plain_dict(tree):
    """Nested mappings (flax FrozenDict included) -> nested dicts."""
    if hasattr(tree, "items"):
        return {k: to_plain_dict(v) for k, v in tree.items()}
    return tree


def port_module_from_jax(module, variables):
    """Load JAX ``variables`` into a port ``module`` with every key matched; eval mode."""
    from bsyolo_tpu_torch.utils.weights import state_dict_from_jax

    module.load_state_dict(state_dict_from_jax(to_plain_dict(variables)), strict=True)
    return module.eval()


def nchw(x):
    return np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2))


def nhwc(x):
    return np.ascontiguousarray(np.asarray(x).transpose(0, 2, 3, 1))


# head levels of A = 700 anchors, not a multiple of the Pallas decode kernels' 512-anchor tile, none square
RAGGED_LEVELS = ((20, 25), (10, 14), (6, 10))


def head_levels(rng, b, sizes, no, sigma=2.0):
    """Seeded NHWC head levels (JAX layout), one (b, h, w, no) float32 map per size."""
    return [rng.normal(0, sigma, (b, h, w, no)).astype(np.float32) for h, w in sizes]


def pallas_head(levels, strides):
    """NHWC levels -> the Pallas decode entries' inputs: the (B, A, no) head, (A, 2)
    anchors and (A, 1) strides from the JAX ``make_anchors``."""
    import jax.numpy as jnp

    from bsyolo_tpu.ops.anchors import make_anchors

    flat = np.concatenate([f.reshape(f.shape[0], -1, f.shape[-1]) for f in levels], 1)
    anchors, stride_t = make_anchors([f.shape[1:3] for f in levels], strides)
    return jnp.asarray(flat), anchors, stride_t


def write_task_dataset(root, task: str, n_train: int = 8, n_val: int = 8, seed: int = 0, nkpt: int = 4, nc: int = 2):
    """A seeded PNG dataset of 64x64, 48x64 and 64x40 frames for the segment or pose task, 1 to 3
    instances each: convex polygons of 6 to 12 vertices filled in the image (segment rows
    ``cls x1 y1 ...``), or rectangles with ``nkpt`` keypoints inside, some of visibility 0 (pose rows
    ``cls cx cy w h kx ky v ...``, ``flip_idx`` swapping neighbours), of ``nc`` classes (1 or 2).
    Returns the data YAML's path."""
    from pathlib import Path

    from bsyolo_tpu_torch.data.cv import fill_poly
    from bsyolo_tpu_torch.data.imread import imwrite_png

    root = Path(root)
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        (root / "images" / split).mkdir(parents=True, exist_ok=True)
        (root / "labels" / split).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            h, w = ((64, 64), (48, 64), (64, 40))[i % 3]
            img = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
            rows = []
            for _ in range(int(rng.integers(1, 4))):
                c = int(rng.integers(0, 2)) % nc
                cx, cy = rng.uniform(0.3, 0.7) * w, rng.uniform(0.3, 0.7) * h
                rx, ry = rng.uniform(6, w / 3), rng.uniform(6, h / 3)
                if task == "segment":
                    ang = np.sort(rng.uniform(0, 2 * np.pi, int(rng.integers(6, 13))))
                    poly = np.stack([cx + rx * np.cos(ang), cy + ry * np.sin(ang)], -1).clip(0, [w - 1, h - 1])
                    mask = np.zeros((h, w), np.uint8)
                    fill_poly(mask, [np.round(poly).astype(np.int32)], 1)
                    img[mask > 0] = (40 + 80 * c, 200 - 60 * c, 120)
                    rows.append(f"{c} " + " ".join(f"{x / w:.6f} {y / h:.6f}" for x, y in poly))
                else:
                    x0, y0, x1, y1 = max(cx - rx, 0), max(cy - ry, 0), min(cx + rx, w - 1), min(cy + ry, h - 1)
                    img[int(y0) : int(y1), int(x0) : int(x1)] = (40 + 80 * c, 200 - 60 * c, 120)
                    k = np.stack([rng.uniform(x0, x1, nkpt) / w, rng.uniform(y0, y1, nkpt) / h,
                                  np.where(rng.uniform(0, 1, nkpt) < 0.8, 2.0, 0.0)], -1)
                    rows.append(f"{c} {(x0 + x1) / 2 / w:.6f} {(y0 + y1) / 2 / h:.6f} {(x1 - x0) / w:.6f} "
                                f"{(y1 - y0) / h:.6f} " + " ".join(f"{v:.6f}" for v in k.reshape(-1)))
            imwrite_png(root / "images" / split / f"{i:03d}.png", img)
            (root / "labels" / split / f"{i:03d}.txt").write_text("\n".join(rows) + "\n")
    extra = ""
    if task == "pose":
        flip = [j ^ 1 if (j ^ 1) < nkpt else j for j in range(nkpt)]
        extra = f"kpt_shape: [{nkpt}, 3]\nflip_idx: {flip}\n"
    names = "".join(f"  {i}: {n}\n" for i, n in enumerate("ab"[:nc]))
    (root / "data.yaml").write_text(f"path: {root}\ntrain: images/train\nval: images/val\n{extra}names:\n{names}")
    return root / "data.yaml"


def task_models(yaml: str, imgsz: int, seed: int):
    """(JAX graph, JAX spec, seeded variables as numpy, the port's YOLO on the CPU with those
    variables carried in) for a task graph."""
    from bsyolo_tpu.nn.model import DetectionGraph

    from bsyolo_tpu_torch import YOLO

    spec = jax_spec(yaml)
    jmodel = DetectionGraph(spec)
    variables = to_plain_dict(random_variables(variable_shapes(jmodel, (1, imgsz, imgsz, 3)), seed))
    port = YOLO(yaml, device="cpu")
    port_module_from_jax(port.model, variables)
    return jmodel, spec, variables, port


def jax_val_batches(data_yaml, task: str, imgsz: int, batch: int = 8):
    """The JAX package's val batches (NHWC, numpy) of a dataset, shuffle off, tail padded."""
    from bsyolo_tpu.data import DataLoader, YOLODataset, load_dataset_yaml

    d = load_dataset_yaml(str(data_yaml))
    ds = YOLODataset(d["val"], imgsz=imgsz, augment=False, max_gt=16, task=task, flip_idx=d.get("flip_idx"))
    return [{k: np.asarray(v) for k, v in b.items()} for b in DataLoader(ds, batch, shuffle=False, drop_last=False)]


def port_batch(batch):
    """A numpy batch (NHWC image) -> the port's (NCHW image tensor, the labels numpy)."""
    import torch

    return {**batch, "img": torch.from_numpy(nchw(batch["img"]))}


def jittered_gt_rows(batch, rng, max_det: int = 20):
    """(B, max_det, 6) rows from a batch's ground truths in input pixels, boxes jittered by up to
    3 px, random scores, a few extra false rows; conf 0 and class -1 on padding rows."""
    b, h, w = batch["img"].shape[:3]
    out = np.zeros((b, max_det, 6), np.float32)
    out[..., 5] = -1
    for i in range(b):
        m = batch["mask"][i] > 0
        xywh = batch["bboxes"][i][m] * [w, h, w, h]
        xyxy = np.concatenate([xywh[:, :2] - xywh[:, 2:] / 2, xywh[:, :2] + xywh[:, 2:] / 2], 1)
        rows = [np.concatenate([xyxy + rng.uniform(-3, 3, xyxy.shape), rng.uniform(0.3, 1, (len(xyxy), 1)),
                                batch["cls"][i][m, None]], 1)]
        false = rng.uniform(0, min(h, w) / 2, (2, 2))
        rows.append(np.concatenate([false, false + 10, rng.uniform(0.01, 0.3, (2, 1)), rng.integers(0, 2, (2, 1))], 1))
        r = np.concatenate(rows)[:max_det]
        out[i, : len(r)] = r
    return out


def jax_assign_weight(feats, gt_cls, gt_bboxes, gt_mask, nc: int, strides):
    """The JAX task losses' TAL assignment and mask-anchor weight, as ``bsyolo_tpu/losses/segment.py``
    and ``pose.py`` compute them on NHWC levels: (AssignResult as numpy, (B, A) weight)."""
    import jax
    import jax.numpy as jnp

    from bsyolo_tpu.losses.tal import task_aligned_assign
    from bsyolo_tpu.nn.modules import dfl_decode
    from bsyolo_tpu.ops.anchors import dist2bbox, make_anchors
    from bsyolo_tpu.ops.boxes import xywh2xyxy

    b = feats[0].shape[0]
    shapes = [(f.shape[1], f.shape[2]) for f in feats]
    h, w = shapes[0][0] * strides[0], shapes[0][1] * strides[0]
    flat = jnp.concatenate([jnp.asarray(f).reshape(b, -1, f.shape[-1]) for f in feats], 1)
    anchors, stride_t = make_anchors(shapes, strides, 0.5)
    gt_xyxy = xywh2xyxy(jnp.asarray(gt_bboxes) * jnp.asarray([w, h, w, h], jnp.float32))
    mask_gt = jnp.asarray(gt_mask).astype(bool) & (jnp.sum(gt_xyxy, -1) > 0)
    pred = dist2bbox(dfl_decode(flat[..., :64], 16), anchors[None], xywh=False)
    assign = task_aligned_assign(jax.nn.sigmoid(flat[..., 64 : 64 + nc]), pred * stride_t[None], anchors * stride_t,
                                 jnp.asarray(gt_cls), gt_xyxy, mask_gt, topk=10, num_classes=nc)
    weight = jnp.sum(assign.target_scores, -1) * assign.fg_mask
    return jax.tree_util.tree_map(np.asarray, assign), np.asarray(weight)


def task_batch(seed: int, b: int, size: int, m: int, nc: int, task: str, nkpt: int = 4):
    """A seeded padded-label batch (NHWC uint8 image) with the task's payload: overlap-encoded masks at
    size / 4 (segment) or (b, m, nkpt, 3) normalized keypoints (pose)."""
    rng = np.random.default_rng(seed)
    out = {"img": rng.integers(0, 255, (b, size, size, 3), dtype=np.uint8),
           "cls": rng.integers(0, nc, (b, m)).astype(np.int32),
           "bboxes": np.concatenate([rng.uniform(0.25, 0.75, (b, m, 2)), rng.uniform(0.1, 0.4, (b, m, 2))],
                                    -1).astype(np.float32),
           "mask": (rng.uniform(0, 1, (b, m)) < 0.8).astype(np.float32)}
    if task == "segment":
        out["masks"] = rng.integers(0, m + 1, (b, size // 4, size // 4)).astype(np.int32)
    else:
        out["keypoints"] = np.concatenate([rng.uniform(0, 1, (b, m, nkpt, 2)),
                                           (rng.uniform(0, 1, (b, m, nkpt, 1)) < 0.7) * 2.0], -1).astype(np.float32)
    return out


def write_obb_dataset(root, n_train: int = 8, n_val: int = 8, seed: int = 0, nc: int = 1, size: int = 64):
    """A seeded PNG dataset of ``size`` x ``size`` and ``size`` x 3/4 ``size`` frames with 1 to 3 rotated
    rectangles each, filled in the image, labelled as DOTA-style corner rows ``cls x1 y1 ... x4 y4``
    (normalized), of ``nc`` classes. Returns the data YAML's path."""
    from pathlib import Path

    from bsyolo_tpu_torch.data.cv import fill_poly
    from bsyolo_tpu_torch.data.imread import imwrite_png

    root = Path(root)
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        (root / "images" / split).mkdir(parents=True, exist_ok=True)
        (root / "labels" / split).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            h, w = (size, size) if i % 2 == 0 else (size * 3 // 4, size)
            img = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
            rows = []
            for _ in range(int(rng.integers(1, 4))):
                c = int(rng.integers(0, nc))
                cx, cy = rng.uniform(0.3, 0.7) * w, rng.uniform(0.3, 0.7) * h
                bw, bh = rng.uniform(0.25, 0.5) * min(h, w), rng.uniform(0.1, 0.25) * min(h, w)
                r = rng.uniform(-np.pi / 2, np.pi / 2)
                d = np.array([[bw / 2, bh / 2], [-bw / 2, bh / 2], [-bw / 2, -bh / 2], [bw / 2, -bh / 2]])
                pts = (d @ np.array([[np.cos(r), np.sin(r)], [-np.sin(r), np.cos(r)]]) + [cx, cy]).clip(0, [w - 1, h - 1])
                mask = np.zeros((h, w), np.uint8)
                fill_poly(mask, [np.round(pts).astype(np.int32)], 1)
                img[mask > 0] = (40 + 80 * (c % 3), 200 - 60 * (c % 3), 120)
                rows.append(f"{c} " + " ".join(f"{x / w:.6f} {y / h:.6f}" for x, y in pts))
            imwrite_png(root / "images" / split / f"{i:03d}.png", img)
            (root / "labels" / split / f"{i:03d}.txt").write_text("\n".join(rows) + "\n")
    names = "".join(f"  {i}: c{i}\n" for i in range(nc))
    (root / "data.yaml").write_text(f"path: {root}\ntrain: images/train\nval: images/val\nnames:\n{names}")
    return root / "data.yaml"


def write_cls_dataset(root, nc: int = 2, n_train: int = 4, n_val: int = 2, seed: int = 0, size: int = 48):
    """A seeded folder-per-class PNG set under ``root``/{train,val}/c<k>/: frames of about ``size`` px
    (some not square), each class a colour of its own under noise. Returns ``root``."""
    from pathlib import Path

    from bsyolo_tpu_torch.data.imread import imwrite_png

    root = Path(root)
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        for c in range(nc):
            d = root / split / f"c{c}"
            d.mkdir(parents=True, exist_ok=True)
            for i in range(n):
                h, w = (size, size + 8 * (i % 3)) if i % 2 else (size + 8 * (i % 3), size)
                img = rng.integers(0, 80, (h, w, 3), dtype=np.uint8)
                img[h // 4 : 3 * h // 4, w // 4 : 3 * w // 4] = (30 + 50 * c % 220, 200 - 40 * c % 180, 90 + 70 * c % 160)
                imwrite_png(d / f"{i:03d}.png", img)
    return root
