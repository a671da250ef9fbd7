"""The port's CUDA kernels and predict path on the card, held against their plain versions.

Every test here needs a CUDA card and nvcc; where there is none they skip.
The file imports neither JAX nor the JAX package, so it also runs on a
machine that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: boxes within rtol 1e-5, atol 2e-3 px (float32 softmax sums in
another order, times strides up to 32); best logits equal (a max is exact).
TF32 is turned off, so the card and the CPU compute the same float32 function.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _head(rng, b, a, nc):
    """Port layout (B, no, A), anchors (A, 2), strides (A, 1); image 0 has side 1 far below the others."""
    head = rng.normal(0, 2, (b, 64 + nc, a)).astype(np.float32)
    head[0, 16:32] -= 120.0
    anchors = rng.uniform(0, 80, (a, 2)).astype(np.float32)
    strides = rng.choice([8.0, 16.0, 32.0], (a, 1)).astype(np.float32)
    return [torch.from_numpy(t) for t in (head, anchors, strides)]


@pytest.mark.parametrize("b,a,nc", [(1, 8400, 12), (8, 8400, 12), (2, 700, 80)])
def test_decode_kernel_matches_plain_version(cuda_device, b, a, nc):
    from bsyolo_tpu_torch.kernels.decode import box_best_cuda, box_best_reference

    head, anchors, strides = _head(np.random.default_rng(a + nc), b, a, nc)
    before = box_best_cuda.launches
    boxes, best = box_best_cuda(*(t.to(cuda_device) for t in (head, anchors, strides)), nc)
    torch.cuda.synchronize()
    assert box_best_cuda.launches == before + 1
    want_boxes, want_best = box_best_reference(head, anchors, strides, nc)
    assert torch.isfinite(boxes).all()
    np.testing.assert_allclose(boxes.cpu().numpy(), want_boxes.numpy(), rtol=1e-5, atol=2e-3)
    np.testing.assert_array_equal(best.cpu().numpy(), want_best.numpy())


def test_decode_kernel_refuses_what_it_does_not_take(cuda_device):
    from bsyolo_tpu_torch.kernels.decode import box_best_cuda

    head, anchors, strides = (t.to(cuda_device) for t in _head(np.random.default_rng(0), 1, 64, 12))
    with pytest.raises(TypeError, match="float32"):
        box_best_cuda(head.half(), anchors, strides, 12)
    with pytest.raises(ValueError, match="contiguous"):
        box_best_cuda(head.transpose(1, 2), anchors, strides, 12)
    with pytest.raises(ValueError, match="anchors"):
        box_best_cuda(head, anchors.cpu(), strides, 12)


def test_postprocess_on_the_card_goes_through_the_kernel(cuda_device):
    """detect_postprocess on CUDA maps launches the kernel once and keeps the CPU's detections."""
    from bsyolo_tpu_torch.kernels.decode import box_best_cuda
    from bsyolo_tpu_torch.kernels.postprocess import detect_postprocess

    rng = np.random.default_rng(5)
    feats = [torch.from_numpy(rng.normal(0, 1.5, (2, 76, s, s)).astype(np.float32)) for s in (16, 8, 4)]
    kw = dict(conf_thres=0.25, iou_thres=0.6, max_det=60, pre_k=512, return_idx=True)
    want, want_idx = detect_postprocess(feats, (8, 16, 32), 12, **kw)
    before = box_best_cuda.launches
    got, got_idx = detect_postprocess([f.to(cuda_device) for f in feats], (8, 16, 32), 12, **kw)
    assert box_best_cuda.launches == before + 1
    np.testing.assert_array_equal(got_idx.cpu().numpy(), want_idx.numpy())
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5, atol=2e-3)
