"""The port's DFL box-decode kernel (bsyolo_tpu_torch/kernels/decode.py).

On the CPU, the plain version ``box_best_reference`` is held against the
Pallas kernel ``fused_box_best_pallas`` in interpret mode: boxes within rtol
1e-5, atol 1e-4 px (float32 softmax sums in other orders), best logits equal.
The CUDA kernel itself is held against the plain version by
tests/test_torch_cuda.py, which runs only where a card is present.
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

REPO = Path(__file__).resolve().parents[1]


def _inputs(rng, b, a, nc):
    flat = rng.normal(0, 2, (b, a, 64 + nc)).astype(np.float32)  # JAX layout (B, A, no)
    anchors = rng.uniform(0, 40, (a, 2)).astype(np.float32)
    strides = rng.choice([8.0, 16.0, 32.0], (a, 1)).astype(np.float32)
    return flat, anchors, strides


def _port(flat, anchors, strides, nc, device="cpu"):
    from bsyolo_tpu_torch.kernels.decode import box_best

    head = torch.from_numpy(np.ascontiguousarray(flat.transpose(0, 2, 1))).to(device)  # port layout (B, no, A)
    boxes, best = box_best(head, torch.from_numpy(anchors).to(device), torch.from_numpy(strides).to(device), nc)
    return boxes.cpu().numpy(), best.cpu().numpy()


@pytest.mark.parametrize("nc", [12, 80])
def test_plain_box_best_matches_pallas_kernel(rng, nc):
    """A = 700 is not a multiple of the TPU kernel's 512-anchor tile; B = 2."""
    from bsyolo_tpu.kernels.decode import fused_box_best_pallas

    flat, anchors, strides = _inputs(rng, 2, 700, nc)
    want_boxes, want_best = fused_box_best_pallas(
        jnp.asarray(flat), jnp.asarray(anchors), jnp.asarray(strides), nc=nc, interpret=True
    )
    boxes, best = _port(flat, anchors, strides, nc)
    assert boxes.shape == (2, 700, 4) and best.shape == (2, 700)
    np.testing.assert_allclose(boxes, np.asarray(want_boxes), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(best, np.asarray(want_best))


def test_side_far_below_the_others_stays_finite(rng):
    """Side 1's logits 120 below the rest: the Pallas kernel's single row max
    underflows that side to 0/0 = NaN; a softmax per side does not. Held
    against the XLA composition dfl_decode + dist2bbox."""
    from bsyolo_tpu.nn.modules import dfl_decode
    from bsyolo_tpu.ops.anchors import dist2bbox

    nc = 12
    flat, anchors, strides = _inputs(rng, 2, 700, nc)
    flat[..., 16:32] -= 120.0
    dist = dfl_decode(jnp.asarray(flat[..., :64]), 16)
    want = np.asarray(dist2bbox(dist, jnp.asarray(anchors)[None], xywh=False) * jnp.asarray(strides)[None])
    boxes, best = _port(flat, anchors, strides, nc)
    assert np.isfinite(boxes).all()
    np.testing.assert_allclose(boxes, want, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(best, flat[..., 64:].max(-1))


def test_cuda_entry_refuses_cpu_tensors():
    from bsyolo_tpu_torch.kernels.decode import box_best_cuda

    head = torch.zeros(1, 76, 10)
    with pytest.raises(ValueError, match="CUDA tensor"):
        box_best_cuda(head, torch.zeros(10, 2), torch.ones(10, 1), 12)
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

