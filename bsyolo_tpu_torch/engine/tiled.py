"""Tiled (SAHI-style) large-frame inference (counterpart of ``bsyolo_tpu/engine/tiled.py``).

A frame larger than the network's input is cut into overlapping tiles, built
on the model's device from one copy of the frame; the tiles go through one
batched forward, ``decode_detections`` and a per-tile
``non_max_suppression``; the survivors are shifted into the frame's pixels
and fused by one greedy NMS across tiles.

    from bsyolo_tpu_torch import YOLO
    from bsyolo_tpu_torch.engine.tiled import predict_tiled
    m = YOLO("yolo11n.yaml")
    dets = predict_tiled(m.model, m.spec, frame_bgr, tile=640)   # (n, 6) x1, y1, x2, y2, conf, cls
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from bsyolo_tpu_torch.nn.heads import decode_detections
from bsyolo_tpu_torch.ops.boxes import box_iou_pairwise
from bsyolo_tpu_torch.ops.nms import _greedy_keep, _top_k, non_max_suppression

MAX_WH = 7680.0  # class offset of the cross-tile NMS, as the per-tile one's
MAX_DET_PER_TILE = 100  # detections each tile passes on to the cross-tile NMS


def tile_grid(img_h: int, img_w: int, tile: int, overlap: float = 0.2) -> List[Tuple[int, int]]:
    """Top-left (y, x) corners of a covering tile grid; the last tile of a row or
    column ends at the frame's edge."""
    stride = max(1, int(tile * (1 - overlap)))

    def starts(size):
        if size <= tile:
            return [0]
        s = list(range(0, size - tile, stride))
        s.append(size - tile)
        return s

    return [(y, x) for y in starts(img_h) for x in starts(img_w)]


@torch.inference_mode()
def detect_tiles(
    model: torch.nn.Module,
    spec,
    tiles: torch.Tensor,  # (T, 3, tile, tile) float RGB in [0, 1]
    offsets: torch.Tensor,  # (T, 2) float (y, x) of each tile's top-left corner
    conf: float,
    iou: float,
    max_det: int,
) -> torch.Tensor:
    """Tiles -> (max_det, 6) fused detections in frame pixels, padded with conf 0, cls -1."""
    preds = decode_detections(model(tiles), spec.head_strides, spec.nc, reg_max=spec.reg_max)  # (T, A, 4 + nc)
    dets = non_max_suppression(preds, conf_thres=conf, iou_thres=iou, max_det=MAX_DET_PER_TILE, nc=spec.nc)
    shift = offsets.flip(-1).repeat(1, 2)  # (T, 4) x, y, x, y
    boxes = dets[..., :4] + shift[:, None, :] * (dets[..., 4:5] > 0)  # padding rows stay at 0
    flat = torch.cat([boxes, dets[..., 4:6]], -1).reshape(-1, 6)  # (T * K, 6)
    _, order = _top_k(flat[:, 4], flat.shape[0])  # stable: equal scores keep tile order
    flat = flat[order]
    shifted = flat[:, :4] + flat[:, 5:6] * MAX_WH
    keep = _greedy_keep(box_iou_pairwise(shifted, shifted)[None], (flat[:, 4] > 0)[None], iou)[0]
    top, idx = _top_k(torch.where(keep, flat[:, 4], -1.0), min(max_det, flat.shape[0]))
    pad = torch.zeros_like(flat[idx])
    pad[:, 5] = -1.0
    return torch.where((top > 0)[:, None], flat[idx], pad)


def predict_tiled(
    model: torch.nn.Module,
    spec,
    image: np.ndarray,  # (H, W, 3) BGR uint8
    tile: int = 640,
    overlap: float = 0.2,
    conf: float = 0.25,
    iou: float = 0.7,
    max_det: int = 300,
    mesh=None,
) -> np.ndarray:
    """Tiled detection on one large frame, on the model's device. Returns (n, 6)
    float32 rows x1, y1, x2, y2, conf, cls in the frame's pixels. Tiles are
    not letterboxed: a tile that runs past the frame is padded with 114 at the
    bottom and right."""
    if mesh is not None:
        raise NotImplementedError("sharding the tiles over a device mesh is not ported yet (ROADMAP queue 1, item 14)")
    if spec.head.module != "Detect":
        raise NotImplementedError(f"predict_tiled serves Detect graphs only, as the JAX package does; this is a "
                                  f"{spec.task} graph with a {spec.head.module} head")
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected a uint8 (h, w, 3) BGR frame, got {image.dtype} {image.shape}")
    device = next(model.parameters()).device
    h, w = image.shape[:2]
    grid = tile_grid(h, w, tile, overlap)
    frame = torch.from_numpy(np.ascontiguousarray(image)).to(device).permute(2, 0, 1).flip(0)  # (3, H, W) RGB
    tiles = torch.full((len(grid), 3, tile, tile), 114, dtype=torch.uint8, device=device)
    for i, (y, x) in enumerate(grid):
        patch = frame[:, y : y + tile, x : x + tile]
        tiles[i, :, : patch.shape[1], : patch.shape[2]] = patch
    offsets = torch.tensor(grid, dtype=torch.float32, device=device)
    out = detect_tiles(model, spec, tiles.float() / 255.0, offsets, conf, iou, max_det).cpu().numpy()
    return out[out[:, 4] > 0]
