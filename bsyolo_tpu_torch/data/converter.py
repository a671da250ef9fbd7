"""Dataset converters (counterpart of ``bsyolo_tpu/data/converter.py``).

``convert_coco``: COCO instances JSON -> YOLO txt labels (boxes, or segment
polygons); ``autosplit``: a seeded train/val/test split of an image folder into
``autosplit_*.txt`` lists; ``convert_grounding``: grounding-caption JSON ->
YOLO labels over the most frequent phrases and a dataset YAML.
"""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path
from typing import Dict

from bsyolo_tpu_torch.utils import LOGGER

# COCO 91-index -> contiguous 80-class mapping (reference coco91_to_coco80_class)
def coco91_to_coco80() -> Dict[int, int]:
    missing = {12, 26, 29, 30, 45, 66, 68, 69, 71, 83}
    out = {}
    idx = 0
    for i in range(1, 91):
        if i in missing:
            continue
        out[i] = idx
        idx += 1
    return out


def convert_coco(
    annotations_json: str,
    save_dir: str = "yolo_labels",
    use_segments: bool = False,
    cls91to80: bool = True,
) -> Path:
    """Write YOLO-format labels/<image>.txt from a COCO annotation file."""
    save = Path(save_dir) / "labels"
    save.mkdir(parents=True, exist_ok=True)
    data = json.loads(Path(annotations_json).read_text())
    images = {im["id"]: im for im in data["images"]}
    mapping = coco91_to_coco80() if cls91to80 else None

    per_image = defaultdict(list)
    for ann in data["annotations"]:
        if ann.get("iscrowd"):
            continue
        per_image[ann["image_id"]].append(ann)

    n = 0
    for img_id, anns in per_image.items():
        im = images[img_id]
        w, h = im["width"], im["height"]
        lines = []
        for ann in anns:
            cid = ann["category_id"]
            cls = mapping.get(cid, None) if mapping else cid - 1
            if cls is None:
                continue
            if use_segments and ann.get("segmentation"):
                seg = ann["segmentation"]
                if isinstance(seg, list) and seg:
                    poly = seg[0]
                    xs = poly[0::2]
                    ys = poly[1::2]
                    norm = [f"{x / w:.6f} {y / h:.6f}" for x, y in zip(xs, ys)]
                    lines.append(f"{cls} " + " ".join(norm))
                    continue
            x, y, bw, bh = ann["bbox"]
            cx, cy = (x + bw / 2) / w, (y + bh / 2) / h
            lines.append(f"{cls} {cx:.6f} {cy:.6f} {bw / w:.6f} {bh / h:.6f}")
        stem = Path(im["file_name"]).stem
        (save / f"{stem}.txt").write_text("\n".join(lines) + ("\n" if lines else ""))
        n += 1
    LOGGER.info(f"converted {n} images -> {save}")
    return save


def autosplit(path, weights=(0.9, 0.1, 0.0), annotated_only: bool = False, seed: int = 0):
    """Split an images dir into autosplit_{train,val,test}.txt listings
    (reference data/utils.py:620; xView.yaml's split convention).

    Each image is assigned to a split by weighted draw (seeded for
    reproducibility). With ``annotated_only`` images lacking a label txt
    (images/ -> labels/ sibling convention) are skipped.
    """
    import random

    exts = {".jpg", ".jpeg", ".png", ".bmp", ".webp", ".tif", ".tiff"}
    path = Path(path)
    files = sorted(x for x in path.rglob("*.*") if x.suffix.lower() in exts)
    rng = random.Random(seed)
    names = ["autosplit_train.txt", "autosplit_val.txt", "autosplit_test.txt"]
    for n in names:
        (path.parent / n).unlink(missing_ok=True)
    counts = [0, 0, 0]
    from bsyolo_tpu_torch.data.dataset import img2label_path

    for img in files:
        if annotated_only:
            if not Path(img2label_path(str(img))).exists():
                continue
        i = rng.choices([0, 1, 2], weights=weights, k=1)[0]
        with open(path.parent / names[i], "a") as f:
            f.write(f"./{img.relative_to(path.parent).as_posix()}\n")
        counts[i] += 1
    LOGGER.info(f"autosplit {sum(counts)} images -> train/val/test = {counts}")
    return counts


def convert_grounding(
    json_file: str,
    img_path: str,
    out_dir: str,
    vocab_size: int = 80,
) -> str:
    """Grounding-caption JSON (Flickr30k/GQA layout: per-image ``caption`` +
    annotation ``tokens_positive`` char spans; reference GroundingDataset,
    data/dataset.py:283) -> YOLO labels + a phrase-vocabulary dataset yaml
    that the world trainer consumes directly.

    The reference keeps per-image phrase lists and samples up to 80 texts per
    step (RandomLoadText); here, as in the JAX package, the phrases collapse to the ``vocab_size`` most frequent across the json (a
    global open vocabulary); annotations whose phrase misses the cut are
    dropped and counted. Returns the dataset yaml path; images are reached
    through an ``images/train`` symlink to ``img_path`` (nothing is copied).
    """
    import numpy as np

    src = Path(img_path)
    out = Path(out_dir)
    ann = json.loads(Path(json_file).read_text())
    images = {int(x["id"]): x for x in ann["images"]}
    by_img: Dict[int, list] = defaultdict(list)
    for a in ann["annotations"]:
        if a.get("iscrowd"):
            continue
        by_img[int(a["image_id"])].append(a)

    def phrase(img, a) -> str:
        cap = img.get("caption", "")
        return " ".join(cap[t[0]: t[1]] for t in a.get("tokens_positive", [])).strip().lower()

    counts: Dict[str, int] = defaultdict(int)
    for img_id, anns in by_img.items():
        img = images[img_id]
        if not (src / img["file_name"]).exists():
            continue
        for a in anns:
            p = phrase(img, a)
            if p:
                counts[p] += 1
    vocab = [p for p, _ in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))[:vocab_size]]
    vid = {p: i for i, p in enumerate(vocab)}

    lbl_dir = out / "labels" / "train"
    lbl_dir.mkdir(parents=True, exist_ok=True)
    img_link = out / "images" / "train"
    img_link.parent.mkdir(parents=True, exist_ok=True)
    if not img_link.exists():
        img_link.symlink_to(src.resolve(), target_is_directory=True)

    n_img = n_box = n_drop = 0
    for img_id, anns in by_img.items():
        img = images[img_id]
        f = src / img["file_name"]
        if not f.exists():
            continue
        w, h = float(img["width"]), float(img["height"])
        lines = []
        for a in anns:
            p = phrase(img, a)
            if p not in vid:
                n_drop += 1
                continue
            box = np.asarray(a["bbox"], np.float64)  # xywh top-left pixels
            cx, cy = (box[0] + box[2] / 2) / w, (box[1] + box[3] / 2) / h
            bw, bh = box[2] / w, box[3] / h
            if bw <= 0 or bh <= 0:
                continue
            lines.append(f"{vid[p]} {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}")
            n_box += 1
        if lines:
            # keep any file_name sub-directories: img2label_path maps
            # images/train/<rel>.jpg -> labels/train/<rel>.txt
            lbl = lbl_dir / Path(img["file_name"]).with_suffix(".txt")
            lbl.parent.mkdir(parents=True, exist_ok=True)
            lbl.write_text("\n".join(lines))
            n_img += 1
    # phrases are arbitrary caption text: json.dumps-quote them so ':', '#',
    # quotes etc. survive yaml parsing (json strings are valid yaml scalars)
    names = "\n".join(f"  {i}: {json.dumps(p)}" for i, p in enumerate(vocab))
    yaml_path = out / "grounding.yaml"
    yaml_path.write_text(
        f"# converted from {json_file} (convert_grounding; vocab={len(vocab)})\n"
        f"path: {out.resolve()}\ntrain: images/train\nval: images/train\n"
        f"nc: {len(vocab)}\nnames:\n{names}\n"
    )
    LOGGER.info(
        f"convert_grounding: {n_img} images, {n_box} boxes, vocab {len(vocab)} "
        f"phrases ({n_drop} out-of-vocab annotations dropped)"
    )
    return str(yaml_path)
