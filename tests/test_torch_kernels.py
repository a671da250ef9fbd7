"""The port's DFL box-decode kernel (bsyolo_tpu_torch/kernels/decode.py box_best).

On the CPU, the plain version ``box_best_reference`` (what ``box_best`` runs
for CPU levels) is held against the Pallas kernel ``fused_box_best_pallas``
in interpret mode on the flattened head: boxes within rtol 1e-5, atol 1e-4 px
(float32 softmax sums in other orders), best logits equal, and the class-logit
output equal to the head's class channels. The CUDA kernel itself is held
against the plain version by tests/test_torch_cuda.py, which runs only where
a card is present.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import torch

from torch_port import RAGGED_LEVELS, head_levels, nchw, pallas_head

REPO = Path(__file__).resolve().parents[1]
STRIDES = (8, 16, 32)


def _port(levels, nc, device="cpu"):
    from bsyolo_tpu_torch.kernels.decode import box_best

    boxes, best, cls = box_best([torch.from_numpy(nchw(f)).to(device) for f in levels], STRIDES, nc)
    return boxes.cpu().numpy(), best.cpu().numpy(), cls.cpu().numpy()


@pytest.mark.parametrize("nc", [12, 80])
def test_plain_box_best_matches_pallas_kernel(rng, nc):
    """A = 700 is not a multiple of the TPU kernel's 512-anchor tile; B = 2; ragged levels."""
    from bsyolo_tpu.kernels.decode import fused_box_best_pallas

    levels = head_levels(rng, 2, RAGGED_LEVELS, 64 + nc)
    flat, anchors, strides = pallas_head(levels, STRIDES)
    want_boxes, want_best = fused_box_best_pallas(flat, anchors, strides, nc=nc, interpret=True)
    boxes, best, cls = _port(levels, nc)
    assert boxes.shape == (2, 700, 4) and best.shape == (2, 700) and cls.shape == (2, 700, nc)
    np.testing.assert_allclose(boxes, np.asarray(want_boxes), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(best, np.asarray(want_best))
    np.testing.assert_array_equal(cls, np.asarray(flat)[..., 64:])


def test_side_far_below_the_others_stays_finite(rng):
    """Side 1's logits 120 below the rest: the Pallas kernel's single row max
    underflows that side to 0/0 = NaN; a softmax per side does not. Held
    against the XLA composition dfl_decode + dist2bbox."""
    from bsyolo_tpu.nn.modules import dfl_decode
    from bsyolo_tpu.ops.anchors import dist2bbox

    nc = 12
    levels = head_levels(rng, 2, RAGGED_LEVELS, 64 + nc)
    for f in levels:
        f[..., 16:32] -= 120.0
    flat, anchors, strides = pallas_head(levels, STRIDES)
    dist = dfl_decode(flat[..., :64], 16)
    want = np.asarray(dist2bbox(dist, anchors[None], xywh=False) * strides[None])
    boxes, best, _ = _port(levels, nc)
    assert np.isfinite(boxes).all()
    np.testing.assert_allclose(boxes, want, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(best, np.asarray(flat)[..., 64:].max(-1))


def test_cuda_entry_refuses_cpu_tensors():
    from bsyolo_tpu_torch.kernels.decode import box_best_cuda

    with pytest.raises(ValueError, match="CUDA device"):
        box_best_cuda([torch.zeros(1, 76, 2, 5)], (8,), 12)
    assert box_best_cuda.launches == 0


def test_decode_imports_without_nvcc(tmp_path, monkeypatch):
    """Importing the kernel modules builds nothing; asking for the build without nvcc says so."""
    env = {**os.environ, "PATH": str(tmp_path), "CUDA_HOME": str(tmp_path), "PYTHONPATH": str(REPO)}
    code = "import bsyolo_tpu_torch.kernels.decode, bsyolo_tpu_torch.kernels.postprocess; print('ok')"
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr

    from bsyolo_tpu_torch.kernels import build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()
