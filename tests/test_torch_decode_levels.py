"""The decode kernels' level inputs (bsyolo_tpu_torch/kernels/decode.py).

The CUDA kernel reads the Detect head's levels in place and computes each
anchor's centre and stride from a table of the levels (``_layout``), so the
call sites no longer build anchors or a flattened head. On the CPU:

- the table, walked block by block as csrc/decode.cu walks it (block -> level
  by ``tile0``, cell i of the level at (i % W + 0.5, i / W + 0.5), the level's
  stride), covers every anchor once and gives centres and strides bit-equal to
  ``make_anchors`` at the paths' pyramids, with 4 levels and with ragged ones;
- the tile plan gives every SM at least two blocks at the paths' shapes and
  fits on an SM; ``_layout`` refuses what the kernel does not take;
- the plain versions on level inputs match ``fused_box_best_pallas`` on the
  flattened head and ``decode_detections_pallas`` on the levels (both in
  interpret mode): boxes within rtol 1e-5, atol 1e-4 px (float32 softmax sums
  in other orders), best logits equal, the class-logit output equal to the
  head's class channels, scores within rtol 1e-5, atol 1e-4;
- ``detect_postprocess`` on such pyramids matches the JAX package as
  tests/test_torch_postprocess.py holds it (indices and classes equal, scores
  within rtol 1e-5, boxes within 1e-3 px);
- the modules import and run their plain versions without nvcc.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import jax.numpy as jnp
import torch

from torch_port import head_levels, nchw, pallas_head

REPO = Path(__file__).resolve().parents[1]


def _square(side, strides=(8, 16, 32)):
    return tuple((side // s, side // s) for s in strides), strides


# name -> (level sizes, strides)
PYRAMIDS = {
    "640": _square(640),
    "544": _square(544),  # a 17 x 17 level: rows of 289 floats, not 16-byte multiples
    "448": _square(448),
    "1080p": (((136, 240), (68, 120), (34, 60)), (8, 16, 32)),  # a 1080x1920 frame padded to 1088x1920
    "p6-640": _square(640, (8, 16, 32, 64)),
    "ragged": (((37, 53), (19, 27), (10, 14)), (8, 16, 32)),
}


def _walk_table(lay):
    """Anchor centres (A, 2) and strides (A, 1) of one image as the kernel's blocks
    compute them from the level table, and how often each anchor was visited."""
    t = lay.table
    points = np.zeros((lay.a, 2), np.float32)
    strides = np.zeros((lay.a, 1), np.float32)
    visits = np.zeros(lay.a, int)
    for block in range(t.tiles):
        level = max(k for k in range(t.levels) if block >= t.tile0[k])
        i0 = (block - t.tile0[level]) * lay.tile
        cells = np.arange(i0, min(i0 + lay.tile, t.hw[level]))
        rows = t.first[level] + cells
        points[rows, 0] = (cells % t.w[level]).astype(np.float32) + np.float32(0.5)
        points[rows, 1] = (cells // t.w[level]).astype(np.float32) + np.float32(0.5)
        strides[rows, 0] = np.float32(t.stride[level])
        visits[rows] += 1
    return points, strides, visits


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("epilogue", [0, 1], ids=["box", "xywh"])
@pytest.mark.parametrize("pyramid", list(PYRAMIDS))
def test_level_table_gives_make_anchors_bit_for_bit(pyramid, epilogue, b):
    from bsyolo_tpu_torch.kernels.decode import _layout
    from bsyolo_tpu_torch.ops.anchors import make_anchors

    sizes, strides = PYRAMIDS[pyramid]
    nc = 12
    lay = _layout(epilogue, tuple(torch.Size((b, 64 + nc, h, w)) for h, w in sizes), strides, nc)
    want_points, want_strides = make_anchors(sizes, strides, 0.5)
    points, stride_t, visits = _walk_table(lay)
    assert (lay.b, lay.no, lay.a) == (b, 64 + nc, sum(h * w for h, w in sizes))
    assert (visits == 1).all()
    np.testing.assert_array_equal(points, want_points.numpy())
    np.testing.assert_array_equal(stride_t, want_strides.numpy())


# (B, pyramid, nc) of the paths: plain predict at batch 1, 4 and 8, the TTA passes, 6 and 8 tiles, nc=80 at 224 px
PATH_SHAPES = [(1, "640", 12), (4, "640", 12), (8, "640", 12), (4, "544", 12), (4, "448", 12), (6, "640", 12),
               (2, "224", 80)]


@pytest.mark.parametrize("b,pyramid,nc", PATH_SHAPES)
def test_tile_plan_fills_the_card_and_fits_on_an_sm(b, pyramid, nc):
    from bsyolo_tpu_torch.kernels.decode import H100_SMS, SMEM_LIMIT, TILES, tile_anchors, tile_smem

    sizes = _square(224)[0] if pyramid == "224" else PYRAMIDS[pyramid][0]
    hws = tuple(h * w for h, w in sizes)
    for epilogue in (0, 1):
        tile = tile_anchors(epilogue, b, hws, nc)
        assert tile in TILES and tile_smem(epilogue, tile, nc) <= SMEM_LIMIT
        assert b * sum(-(-hw // tile) for hw in hws) >= 2 * H100_SMS
        larger = [t for t in TILES if t > tile]  # the largest tile that still gives two blocks per SM
        assert all(b * sum(-(-hw // t) for hw in hws) < 2 * H100_SMS for t in larger)


def test_layout_refuses_what_the_kernel_does_not_take():
    from bsyolo_tpu_torch.kernels.decode import MAX_NC, SMEM_LIMIT, TILES, _layout, tile_smem

    level = torch.Size((2, 76, 4, 4))
    with pytest.raises(ValueError, match="1 to 4 levels"):
        _layout(0, (level,) * 5, (8, 16, 32, 64, 128), 12)
    with pytest.raises(ValueError, match="1 to 4 levels"):
        _layout(1, (), (), 12)
    with pytest.raises(ValueError, match="strides"):
        _layout(0, (level, level), (8,), 12)
    with pytest.raises(ValueError, match="one B and one no"):
        _layout(0, (level, torch.Size((1, 76, 2, 2))), (8, 16), 12)
    with pytest.raises(ValueError, match="fewer than"):
        _layout(1, (level,), (8,), 13)
    with pytest.raises(ValueError, match="classes"):
        _layout(1, (torch.Size((1, 64 + MAX_NC + 1, 2, 2)),), (8,), MAX_NC + 1)
    assert tile_smem(1, TILES[-1], MAX_NC) <= SMEM_LIMIT < tile_smem(1, TILES[-1], MAX_NC + 1)
    assert _layout(1, (torch.Size((1, 64 + MAX_NC, 2, 2)),), (8,), MAX_NC).tile == TILES[-1]


@pytest.mark.parametrize("nc", [12, 80])
@pytest.mark.parametrize("pyramid", ["p6-640", "ragged", "544"])
def test_plain_versions_on_levels_match_the_pallas_kernels(rng, pyramid, nc):
    """box_best_reference against fused_box_best_pallas on the flattened head;
    decode_xywh_reference against decode_detections_pallas on the levels. B = 2;
    640-px pyramids halved in size to keep the interpret runs short."""
    from bsyolo_tpu.kernels.decode import decode_detections_pallas, fused_box_best_pallas
    from bsyolo_tpu_torch.kernels.decode import box_best, decode_xywh

    sizes, strides = PYRAMIDS[pyramid]
    if pyramid != "ragged":
        sizes = tuple((h // 2, w // 2) for h, w in sizes)
    levels = head_levels(rng, 2, sizes, 64 + nc)
    ports = [torch.from_numpy(nchw(f)) for f in levels]
    flat, anchors, stride_t = pallas_head(levels, strides)
    want_boxes, want_best = fused_box_best_pallas(flat, anchors, stride_t, nc=nc, interpret=True)
    boxes, best, cls = box_best(ports, strides, nc)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(want_boxes), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(best.numpy(), np.asarray(want_best))
    np.testing.assert_array_equal(cls.numpy(), np.asarray(flat)[..., 64:])
    want = np.asarray(decode_detections_pallas([jnp.asarray(f) for f in levels], strides, nc, interpret=True))
    got = decode_xywh(ports, strides, nc).numpy()
    assert got.shape == want.shape == (2, sum(h * w for h, w in sizes), 4 + nc)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("pyramid", ["p6-640", "ragged"])
def test_detect_postprocess_on_levels_matches_jax(rng, pyramid):
    from bsyolo_tpu.kernels.postprocess import detect_postprocess as jax_postprocess
    from bsyolo_tpu_torch.kernels.postprocess import detect_postprocess

    sizes, strides = PYRAMIDS[pyramid]
    sizes = tuple((h // 4, w // 4) for h, w in sizes) if pyramid != "ragged" else sizes
    nc = 12
    levels = head_levels(rng, 2, sizes, 64 + nc, sigma=1.5)
    kw = dict(conf_thres=0.25, iou_thres=0.6, max_det=60, pre_k=512, return_idx=True)
    want, want_idx = jax_postprocess([jnp.asarray(f) for f in levels], strides, nc, use_pallas=True, interpret=True,
                                     **kw)
    got, got_idx = detect_postprocess([torch.from_numpy(nchw(f)) for f in levels], strides, nc, **kw)
    want, got = np.asarray(want), got.numpy()
    assert (want[..., 4] > 0).sum() > 20  # NMS kept real detections
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got[..., 5], want[..., 5])
    np.testing.assert_allclose(got[..., 4], want[..., 4], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=0, atol=1e-3)


def test_decode_modules_run_their_plain_versions_without_nvcc(tmp_path):
    """With no nvcc on PATH or in CUDA_HOME, the decode modules import and decode CPU
    levels (4 of them) with their plain versions; nothing is built or loaded."""
    env = {**os.environ, "PATH": str(tmp_path), "CUDA_HOME": str(tmp_path), "PYTHONPATH": str(REPO)}
    code = """
import torch
from bsyolo_tpu_torch.kernels import build, decode
from bsyolo_tpu_torch.kernels.postprocess import detect_postprocess
from bsyolo_tpu_torch.nn.heads import decode_detections
g = torch.Generator().manual_seed(0)
feats = [torch.randn((1, 76, s, s), generator=g) for s in (8, 4, 2, 1)]
boxes, best, cls = decode.box_best(feats, (8, 16, 32, 64), 12)
out = decode_detections(feats, (8, 16, 32, 64), 12)
dets = detect_postprocess(feats, (8, 16, 32, 64), 12, conf_thres=0.0)
assert boxes.shape == (1, 85, 4) and out.shape == (1, 85, 16) and dets.shape == (1, 300, 6)
assert decode._entry is None and not build.BUILD_LOG and not build._libs
print('ok')
"""
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
