"""The port's non_max_suppression (ops/nms.py) against bsyolo_tpu.ops.nms.non_max_suppression.

Both get the same seeded (B, A, 4 + nc) decoded predictions (xywh pixels,
sigmoid scores). Kept anchor indices and classes must be equal, scores
within rtol 1e-5, boxes within atol 1e-4 px (xywh -> xyxy in float32).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch


def _preds(rng, b, a, nc, saturate=False):
    """Boxes clustered so NMS has work; scores sigmoid of spread logits. With
    ``saturate`` a third of the logits are large enough that float32 sigmoid
    returns exactly 1.0, so many scores tie and only the index order decides."""
    centres = rng.uniform(0, 128, (b, a, 2))
    wh = rng.uniform(4, 40, (b, a, 2))
    logits = rng.normal(-1.0, 2.5, (b, a, nc))
    if saturate:
        logits = np.where(rng.uniform(size=logits.shape) < 0.33, 25.0 + rng.uniform(0, 5, logits.shape), logits)
    scores = 1.0 / (1.0 + np.exp(-logits.astype(np.float32)))
    return np.concatenate([centres, wh, scores], -1).astype(np.float32)


CASES = {
    "multi-label": dict(),
    "best-class": dict(multi_label=False),
    "agnostic": dict(agnostic=True),
    "saturated-ties": dict(saturate=True),
    "saturated-ties-best-class": dict(saturate=True, multi_label=False),
    "padded": dict(max_det=300, pre_k=64),
    "nc80": dict(nc=80, a=400),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_non_max_suppression_matches_jax(rng, case):
    from bsyolo_tpu.ops.nms import non_max_suppression as jnms
    from bsyolo_tpu_torch.ops.nms import non_max_suppression

    kw = dict(CASES[case])
    nc, a, saturate = kw.pop("nc", 12), kw.pop("a", 900), kw.pop("saturate", False)
    kw = {**dict(conf_thres=0.25, iou_thres=0.6, max_det=60, pre_k=512, return_idx=True), **kw}
    pred = _preds(rng, 2, a, nc, saturate)
    if saturate:
        assert (pred[..., 4:] == 1.0).sum() > 1000
    want, want_idx = jnms(jnp.asarray(pred), nc=nc, **kw)
    got, got_idx = non_max_suppression(torch.from_numpy(pred), nc=nc, **kw)
    want, got = np.asarray(want), got.numpy()
    assert got.shape == want.shape == (2, kw["max_det"], 6)
    assert (want[..., 4] > 0).sum() > 20  # NMS kept real detections
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got[..., 5], want[..., 5])
    np.testing.assert_allclose(got[..., 4], want[..., 4], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=0, atol=1e-4)
    if kw["max_det"] > kw["pre_k"]:
        assert (got[:, kw["pre_k"] :, 4] == 0).all() and (got[:, kw["pre_k"] :, 5] == -1).all()
        assert (got_idx.numpy()[:, kw["pre_k"] :] == -1).all()


def test_nc_is_inferred_from_the_width(rng):
    from bsyolo_tpu_torch.ops.nms import non_max_suppression

    pred = torch.from_numpy(_preds(rng, 1, 300, 7))
    torch.testing.assert_close(non_max_suppression(pred), non_max_suppression(pred, nc=7), rtol=0, atol=0)
