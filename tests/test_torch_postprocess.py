"""The port's detect_postprocess (decode + logit-domain NMS) against bsyolo_tpu.

The JAX side runs its Pallas decode in interpret mode (use_pallas=True), or
its XLA decode for reg_max=17. Kept anchor indices and classes must be equal,
scores within rtol 1e-5, boxes within atol 1e-3 px (as tests/test_kernels.py).
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import jax.numpy as jnp
import torch

from torch_port import nchw


def _feats(rng, nc, b, img, reg_max=16):
    sizes = [img // s for s in (8, 16, 32)]
    return [rng.normal(0, 1.5, (b, s, s, 4 * reg_max + nc)).astype(np.float32) for s in sizes]


@pytest.mark.parametrize(
    "nc,multi_label,agnostic,reg_max",
    [(12, True, False, 16), (12, False, False, 16), (12, True, True, 16), (80, True, False, 16), (5, True, False, 17)],
)
def test_detect_postprocess_matches_jax(rng, nc, multi_label, agnostic, reg_max):
    from bsyolo_tpu.kernels.postprocess import detect_postprocess as jax_postprocess
    from bsyolo_tpu_torch.kernels.postprocess import detect_postprocess

    feats = _feats(rng, nc, 2, 128, reg_max)
    kw = dict(conf_thres=0.25, iou_thres=0.6, max_det=60, pre_k=512, multi_label=multi_label, agnostic=agnostic,
              return_idx=True, reg_max=reg_max)
    want, want_idx = jax_postprocess([jnp.asarray(f) for f in feats], (8, 16, 32), nc, use_pallas=True,
                                     interpret=True, **kw)
    got, got_idx = detect_postprocess([torch.from_numpy(nchw(f)) for f in feats], (8, 16, 32), nc, **kw)
    want, got = np.asarray(want), got.numpy()
    assert got.shape == want.shape == (2, 60, 6)
    assert (want[..., 4] > 0).sum() > 20  # NMS kept real detections
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got[..., 5], want[..., 5])
    np.testing.assert_allclose(got[..., 4], want[..., 4], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=0, atol=1e-3)


def test_padding_rows_when_max_det_exceeds_candidates(rng):
    """max_det above the candidate count pads with conf 0, cls -1, index -1, as in JAX."""
    from bsyolo_tpu.kernels.postprocess import detect_postprocess as jax_postprocess
    from bsyolo_tpu_torch.kernels.postprocess import detect_postprocess

    feats = _feats(rng, 3, 1, 64)
    kw = dict(conf_thres=0.1, max_det=300, pre_k=64, multi_label=False, return_idx=True)
    want, want_idx = jax_postprocess([jnp.asarray(f) for f in feats], (8, 16, 32), 3, **kw)
    got, got_idx = detect_postprocess([torch.from_numpy(nchw(f)) for f in feats], (8, 16, 32), 3, **kw)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got.numpy()[..., 5], np.asarray(want)[..., 5])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-3)
