"""The decode's bfloat16 and float16 levels (kernels/decode.py box_best, decode_xywh) on the CPU.

The Pallas kernels cast their inputs to float32, so they decode 2-byte heads;
the port's plain versions (what CPU levels run) cast to float32 first and
must give the same outputs. Both sides get the same 2-byte values: levels are
drawn in float32 with numpy, rounded to the 2-byte type in torch, and handed
to JAX as that type. Tolerance: rtol 1e-5, atol 1e-4 px (float32 softmax
sums in other orders), as tests/test_torch_decode.py. The CUDA kernels on
2-byte levels are held against the plain versions by tests/test_torch_cuda.py.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import jax.numpy as jnp
import torch

from torch_port import RAGGED_LEVELS, head_levels, nchw, pallas_head

# a P6 pyramid whose last level has odd H * W, and the ragged levels of A = 700
SIZES = {"ragged": (RAGGED_LEVELS, (8, 16, 32)), "p6-odd": (((10, 10), (5, 5), (3, 3), (1, 1)), (8, 16, 32, 64))}


def _two_byte_levels(rng, sizes, nc, dtype):
    """(NHWC float32 numpy holding the 2-byte values, NCHW 2-byte torch levels)."""
    levels = head_levels(rng, 2, sizes, 64 + nc)
    port = [torch.from_numpy(nchw(f)).to(dtype) for f in levels]
    exact = [np.ascontiguousarray(p.float().numpy().transpose(0, 2, 3, 1)) for p in port]
    return exact, port


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("sizes", list(SIZES))
def test_box_best_on_2_byte_levels_matches_pallas(rng, dtype, sizes):
    from bsyolo_tpu.kernels.decode import fused_box_best_pallas
    from bsyolo_tpu_torch.kernels.decode import box_best

    nc = 12
    levels, strides = SIZES[sizes]
    exact, port = _two_byte_levels(rng, levels, nc, getattr(torch, dtype))
    flat, anchors, stride_t = pallas_head(exact, strides)
    want_boxes, want_best = fused_box_best_pallas(flat.astype(getattr(jnp, dtype)), anchors, stride_t, nc=nc,
                                                  interpret=True)
    boxes, best, cls = box_best(port, strides, nc)
    assert boxes.dtype == best.dtype == cls.dtype == torch.float32
    np.testing.assert_allclose(boxes.numpy(), np.asarray(want_boxes, np.float32), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(best.numpy(), np.asarray(want_best, np.float32).reshape(best.shape), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(cls.numpy(), np.asarray(flat)[..., 64 : 64 + nc])


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("sizes", list(SIZES))
def test_decode_xywh_on_2_byte_levels_matches_pallas(rng, dtype, sizes):
    from bsyolo_tpu.kernels.decode import fused_decode_pallas
    from bsyolo_tpu_torch.kernels.decode import decode_xywh

    nc = 12
    levels, strides = SIZES[sizes]
    exact, port = _two_byte_levels(rng, levels, nc, getattr(torch, dtype))
    flat, anchors, stride_t = pallas_head(exact, strides)
    want = np.asarray(fused_decode_pallas(flat.astype(getattr(jnp, dtype)), anchors, stride_t, nc=nc,
                                          interpret=True), np.float32)
    got = decode_xywh(port, strides, nc)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_cuda_entry_refuses_mixed_dtypes_before_the_card():
    """The wrapper's checks run before the library loads: CPU levels are refused as such."""
    from bsyolo_tpu_torch.kernels.decode import box_best_cuda

    with pytest.raises(ValueError, match="CUDA device"):
        box_best_cuda([torch.zeros(1, 76, 2, 2), torch.zeros(1, 76, 1, 1, dtype=torch.bfloat16)], (8, 16), 12)
    assert box_best_cuda.launches == 0
