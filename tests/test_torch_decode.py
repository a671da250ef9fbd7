"""The port's xywh decode (kernels/decode.py decode_xywh, nn/heads.py decode_detections).

On the CPU the plain version ``decode_xywh_reference`` (what ``decode_xywh``
and ``decode_detections`` run for CPU levels) is held against the Pallas
kernel ``decode_detections_pallas`` in interpret mode and against the XLA
``decode_detections``: within rtol 1e-5, atol 1e-4 (float32 softmax sums in
other orders), the cases of tests/test_kernels.py. Where one side sits far
below another the Pallas kernel returns NaN, so that case is held against
the XLA function alone. The CUDA kernel itself is held against the plain
version by tests/test_torch_cuda.py, which runs only where a card is present.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import jax.numpy as jnp
import torch

from torch_port import RAGGED_LEVELS, head_levels, nchw, pallas_head


@pytest.mark.parametrize("nc,sizes", [(12, ((8, 8), (4, 4))), (80, ((16, 16), (8, 8), (4, 4)))])
def test_decode_detections_matches_pallas_and_xla(rng, nc, sizes):
    from bsyolo_tpu.kernels.decode import decode_detections_pallas
    from bsyolo_tpu.nn.heads import decode_detections as jdecode
    from bsyolo_tpu_torch.nn.heads import decode_detections

    strides = tuple(64 // s[0] for s in sizes)
    feats = head_levels(rng, 2, sizes, 64 + nc)
    jfeats = [jnp.asarray(f) for f in feats]
    pallas = np.asarray(decode_detections_pallas(jfeats, strides, nc, interpret=True))
    xla = np.asarray(jdecode(jfeats, strides, nc))
    got = decode_detections([torch.from_numpy(nchw(f)) for f in feats], strides, nc).numpy()
    assert got.shape == pallas.shape == (2, sum(h * w for h, w in sizes), 4 + nc)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, xla, rtol=1e-5, atol=1e-4)


def _port(levels, nc):
    from bsyolo_tpu_torch.kernels.decode import decode_xywh

    return decode_xywh([torch.from_numpy(nchw(f)) for f in levels], (8, 16, 32), nc).numpy()


@pytest.mark.parametrize("nc", [3, 12, 80])
def test_plain_decode_xywh_matches_pallas_kernel_on_a_ragged_tile(rng, nc):
    """A = 700 is not a multiple of the TPU kernel's 512-anchor tile; B = 2; ragged levels."""
    from bsyolo_tpu.kernels.decode import fused_decode_pallas

    levels = head_levels(rng, 2, RAGGED_LEVELS, 64 + nc)
    want = np.asarray(fused_decode_pallas(*pallas_head(levels, (8, 16, 32)), nc=nc, interpret=True))
    got = _port(levels, nc)
    assert got.shape == want.shape == (2, 700, 4 + nc)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_side_far_below_the_others_stays_finite(rng):
    """Side 1's logits 120 below the rest: the Pallas kernel's single row max
    underflows that side to 0/0 = NaN; a softmax per side does not."""
    from bsyolo_tpu.kernels.decode import fused_decode_pallas
    from bsyolo_tpu.nn.modules import dfl_decode
    from bsyolo_tpu.ops.anchors import dist2bbox

    nc = 12
    levels = head_levels(rng, 2, RAGGED_LEVELS, 64 + nc)
    for f in levels:
        f[..., 16:32] -= 120.0
    flat, anchors, strides = pallas_head(levels, (8, 16, 32))
    pallas = np.asarray(fused_decode_pallas(flat, anchors, strides, nc=nc, interpret=True))
    assert np.isnan(pallas[..., :4]).any()  # the fault the port does not copy
    dist = dfl_decode(flat[..., :64], 16)
    want = np.asarray(dist2bbox(dist, anchors[None], xywh=True) * strides[None])
    got = _port(levels, nc)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[..., :4], want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got[..., 4:], 1 / (1 + np.exp(-np.asarray(flat)[..., 64:].astype(np.float64))),
                               rtol=1e-5)


@pytest.mark.parametrize("reg_max,extra", [(16, 7), (17, 0)], ids=["wider-head", "reg_max17"])
def test_decode_detections_wider_head_and_other_reg_max_match_xla(rng, reg_max, extra):
    """Channels past 4 * reg_max + nc are ignored; reg_max 17 takes the plain version."""
    from bsyolo_tpu.nn.heads import decode_detections as jdecode
    from bsyolo_tpu_torch.nn.heads import decode_detections

    nc, sizes = 5, ((8, 8), (4, 4), (2, 2))
    feats = head_levels(rng, 2, sizes, 4 * reg_max + nc + extra)
    want = np.asarray(jdecode([jnp.asarray(f) for f in feats], (8, 16, 32), nc, reg_max=reg_max))
    got = decode_detections([torch.from_numpy(nchw(f)) for f in feats], (8, 16, 32), nc, reg_max=reg_max).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_cuda_entry_refuses_cpu_tensors():
    from bsyolo_tpu_torch.kernels.decode import decode_xywh_cuda

    with pytest.raises(ValueError, match="CUDA device"):
        decode_xywh_cuda([torch.zeros(1, 76, 2, 5)], (8,), 12)
    assert decode_xywh_cuda.launches == 0


def test_both_kernels_are_registered():
    from bsyolo_tpu_torch import kernels
    from bsyolo_tpu_torch.kernels.build import CSRC

    assert set(kernels.KERNELS) == {"decode_box_best", "decode_xywh", "int8_matmul"}
    for _, src in kernels.KERNELS.values():
        assert (CSRC / f"{src}.cu").is_file()
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == {"decode_box_best": 0, "decode_xywh": 0, "int8_matmul": 0}
