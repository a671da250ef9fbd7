"""The port's CUDA kernels and predict path on the card, held against their plain versions.

Every test here needs a CUDA card and nvcc; where there is none they skip.
The file imports neither JAX nor the JAX package, so it also runs on a
machine that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: boxes within rtol 1e-5, atol 2e-3 px (float32 softmax sums in
another order, times strides up to 32); best logits equal (a max is exact)
and the class-logit output equal (a copy);
sigmoid scores within rtol 1e-5 (the kernel's expf against torch's exp);
the int8 matmul exactly equal (int32 sums, the same float32 dequantization);
an int8 Conv within rtol 1e-5, atol 1e-6 (the same codes; BatchNorm on the
card sums in another order).
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


def _levels(rng, b, sizes, nc):
    """Port layout: one (B, 64 + nc, h, w) float32 map per level; image 0 has side 1 far below the others."""
    levels = [rng.normal(0, 2, (b, 64 + nc, h, w)).astype(np.float32) for h, w in sizes]
    for f in levels:
        f[0, 16:32] -= 120.0
    return [torch.from_numpy(f) for f in levels]


def _square(side, strides=(8, 16, 32)):
    return tuple((side // s, side // s) for s in strides), strides


# (B, level sizes, strides, nc) of the paths: plain predict at batch 1, 4 and 8 at 640 px, the 544 and 448 TTA
# passes at batch 4, 6 and 8 tiles of 640, nc = 80 on ragged levels, and a P6 pyramid of 4 levels
DECODE_SHAPES = {
    "b1-640": (1, *_square(640), 12),
    "b4-640": (4, *_square(640), 12),
    "b8-640": (8, *_square(640), 12),
    "b4-544": (4, *_square(544), 12),
    "b4-448": (4, *_square(448), 12),
    "6tiles-640": (6, *_square(640), 12),
    "nc80-ragged": (2, ((37, 53), (19, 27), (10, 14)), (8, 16, 32), 80),
    "p6-640": (2, *_square(640, (8, 16, 32, 64)), 12),
}


@pytest.mark.parametrize("shape", list(DECODE_SHAPES))
def test_decode_kernel_matches_plain_version(cuda_device, shape):
    from bsyolo_tpu_torch.kernels.decode import box_best_cuda, box_best_reference

    b, sizes, strides, nc = DECODE_SHAPES[shape]
    levels = _levels(np.random.default_rng(b + nc + len(sizes)), b, sizes, nc)
    before = box_best_cuda.launches
    boxes, best, cls = box_best_cuda([f.to(cuda_device) for f in levels], strides, nc)
    torch.cuda.synchronize()
    assert box_best_cuda.launches == before + 1
    want_boxes, want_best, want_cls = box_best_reference(levels, strides, nc)
    assert torch.isfinite(boxes).all() and cls.is_contiguous()
    np.testing.assert_allclose(boxes.cpu().numpy(), want_boxes.numpy(), rtol=1e-5, atol=2e-3)
    np.testing.assert_array_equal(best.cpu().numpy(), want_best.numpy())
    np.testing.assert_array_equal(cls.cpu().numpy(), want_cls.numpy())


def _refusals(kernel, cuda_device):
    """A half, a non-contiguous, a CPU level, and a fifth level."""
    levels = [f.to(cuda_device) for f in _levels(np.random.default_rng(0), 1, ((8, 8), (4, 4)), 12)]
    with pytest.raises(TypeError, match="float32"):
        kernel([levels[0], levels[1].half()], (8, 16), 12)
    with pytest.raises(ValueError, match="contiguous"):
        kernel([levels[0], levels[1].transpose(2, 3)], (8, 16), 12)
    with pytest.raises(ValueError, match="one CUDA device"):
        kernel([levels[0], levels[1].cpu()], (8, 16), 12)
    with pytest.raises(ValueError, match="1 to 4 levels"):
        kernel(levels + levels[1:] * 3, (8, 16, 32, 64, 128), 12)


def test_decode_kernel_refuses_what_it_does_not_take(cuda_device):
    from bsyolo_tpu_torch.kernels.decode import box_best_cuda

    before = box_best_cuda.launches
    _refusals(box_best_cuda, cuda_device)
    assert box_best_cuda.launches == before


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


@pytest.mark.parametrize("shape", list(DECODE_SHAPES))
def test_decode_xywh_kernel_matches_plain_version(cuda_device, shape):
    from bsyolo_tpu_torch.kernels.decode import decode_xywh_cuda, decode_xywh_reference

    b, sizes, strides, nc = DECODE_SHAPES[shape]
    levels = _levels(np.random.default_rng(b + nc + len(sizes) + 1), b, sizes, nc)
    before = decode_xywh_cuda.launches
    got = decode_xywh_cuda([f.to(cuda_device) for f in levels], strides, nc)
    torch.cuda.synchronize()
    assert decode_xywh_cuda.launches == before + 1
    want = decode_xywh_reference(levels, strides, nc).numpy()
    got = got.cpu().numpy()
    assert got.shape == (b, sum(h * w for h, w in sizes), 4 + nc) and np.isfinite(got).all()
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=1e-5, atol=2e-3)
    np.testing.assert_allclose(got[..., 4:], want[..., 4:], rtol=1e-5, atol=0)


def test_decode_xywh_kernel_refuses_what_it_does_not_take(cuda_device):
    from bsyolo_tpu_torch.kernels.decode import MAX_NC, decode_xywh_cuda

    before = decode_xywh_cuda.launches
    _refusals(decode_xywh_cuda, cuda_device)
    wide = torch.zeros((1, 64 + MAX_NC + 1, 4, 4), device=cuda_device)
    with pytest.raises(ValueError, match="classes"):
        decode_xywh_cuda([wide], (8,), MAX_NC + 1)
    assert decode_xywh_cuda.launches == before


def test_decode_kernels_read_unaligned_levels(cuda_device):
    """Levels that start 4 bytes past a 16-byte boundary (views into a larger buffer)
    take the 4-byte copies and give the plain version's outputs."""
    from bsyolo_tpu_torch.kernels.decode import (box_best_cuda, box_best_reference, decode_xywh_cuda,
                                                 decode_xywh_reference)

    levels = _levels(np.random.default_rng(3), 2, _square(256)[0], 12)
    shifted = []
    for f in levels:
        buf = torch.empty(f.numel() + 1, device=cuda_device)
        shifted.append(buf[1:].view(f.shape).copy_(f))
        assert shifted[-1].is_contiguous() and shifted[-1].data_ptr() % 16 == 4
    boxes, best, cls = box_best_cuda(shifted, (8, 16, 32), 12)
    want_boxes, want_best, want_cls = box_best_reference(levels, (8, 16, 32), 12)
    np.testing.assert_allclose(boxes.cpu().numpy(), want_boxes.numpy(), rtol=1e-5, atol=2e-3)
    np.testing.assert_array_equal(best.cpu().numpy(), want_best.numpy())
    np.testing.assert_array_equal(cls.cpu().numpy(), want_cls.numpy())
    got = decode_xywh_cuda(shifted, (8, 16, 32), 12).cpu().numpy()
    want = decode_xywh_reference(levels, (8, 16, 32), 12).numpy()
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=1e-5, atol=2e-3)
    np.testing.assert_allclose(got[..., 4:], want[..., 4:], rtol=1e-5, atol=0)


def _device_kernels(fn, reps=3):
    """Names of the device kernels ``reps`` calls of ``fn`` ran, in the order they started,
    from torch.profiler. A profiler session now and then records no device event at all;
    such a session is run again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # first call: library, layout
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if events:
            break
    return [e.name for e in sorted(events, key=lambda e: e.time_range.start)]


def test_one_device_kernel_per_decode_call(cuda_device):
    """decode_detections and the decode stage of detect_postprocess (box_best) each run
    one device kernel per call, the decode kernel; detect_postprocess runs that kernel
    first and then exactly the kernels of nms_from_logits on its outputs."""
    from bsyolo_tpu_torch.kernels.decode import box_best
    from bsyolo_tpu_torch.kernels.postprocess import detect_postprocess
    from bsyolo_tpu_torch.nn.heads import decode_detections
    from bsyolo_tpu_torch.ops.nms import nms_from_logits

    levels = [f.to(cuda_device) for f in _levels(np.random.default_rng(4), 4, _square(640)[0], 12)]
    for fn in (lambda: decode_detections(levels, (8, 16, 32), 12), lambda: box_best(levels, (8, 16, 32), 12)):
        names = _device_kernels(fn)
        assert len(names) == 3 and all("decode_kernel" in n for n in names), names
    post = _device_kernels(lambda: detect_postprocess(levels, (8, 16, 32), 12, conf_thres=0.001), reps=1)
    boxes, best, cls = box_best(levels, (8, 16, 32), 12)
    nms = _device_kernels(lambda: nms_from_logits(boxes, cls, best, conf_thres=0.001), reps=1)
    assert "decode_kernel" in post[0] and not any("decode_kernel" in n for n in post[1:]), post[:3]
    assert len(post) == 1 + len(nms)


def test_decode_detections_on_the_card_goes_through_the_kernel(cuda_device):
    """decode_detections on CUDA maps launches the xywh kernel once and agrees with the CPU."""
    from bsyolo_tpu_torch.kernels.decode import decode_xywh_cuda
    from bsyolo_tpu_torch.nn.heads import decode_detections

    rng = np.random.default_rng(6)
    feats = [torch.from_numpy(rng.normal(0, 2, (2, 76 + 3, s, s)).astype(np.float32)) for s in (16, 8, 4)]
    want = decode_detections(feats, (8, 16, 32), 12).numpy()
    before = decode_xywh_cuda.launches
    got = decode_detections([f.to(cuda_device) for f in feats], (8, 16, 32), 12)
    assert decode_xywh_cuda.launches == before + 1
    np.testing.assert_allclose(got[..., :4].cpu().numpy(), want[..., :4], rtol=1e-5, atol=2e-3)
    np.testing.assert_allclose(got[..., 4:].cpu().numpy(), want[..., 4:], rtol=1e-5, atol=0)


def test_tta_and_tiled_predict_on_the_card_launch_the_xywh_kernel(cuda_device):
    """predict(augment=True): 3 launches per batch and none of the box-best kernel;
    predict_tiled: 1 launch per call. Both give finite (n, 6) rows."""
    from bsyolo_tpu_torch import YOLO, kernels
    from bsyolo_tpu_torch.engine.tiled import predict_tiled

    model = YOLO("yolo11n.yaml", device=cuda_device)
    rng = np.random.default_rng(9)
    frames = [rng.integers(0, 256, (96, 128, 3), dtype=np.uint8) for _ in range(3)]
    kernels.reset_launch_counts()
    res = model.predict(frames, imgsz=128, conf=0.001, batch=2, augment=True)
    assert kernels.launch_counts() == {"decode_box_best": 0, "decode_xywh": 3 * 2, "int8_matmul": 0}
    assert all(r.boxes.data.shape[1] == 6 and np.isfinite(r.boxes.data).all() for r in res)
    kernels.reset_launch_counts()
    dets = predict_tiled(model.model, model.spec, rng.integers(0, 256, (200, 300, 3), dtype=np.uint8), tile=128,
                         conf=0.001)
    assert kernels.launch_counts() == {"decode_box_best": 0, "decode_xywh": 1, "int8_matmul": 0}
    assert dets.ndim == 2 and dets.shape[1] == 6 and np.isfinite(dets).all()


# the yolo11n path at batch 4, 640 px: stem, model.3, model.28.cv2.1.0; the Pallas test's shape; ragged ones
INT8_SHAPES = [(409600, 27, 16), (25600, 576, 64), (6400, 1152, 64), (512, 128, 128), (1000, 27, 20), (1, 1, 1),
               (77, 48, 200)]


def _int8_operands(device, m, k, n, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=device, generator=g)
    w = torch.randint(-128, 128, (k, n), dtype=torch.int8, device=device, generator=g)
    sw = torch.rand(n, device=device, generator=g) * 0.02 + 1e-3
    return x, w, sw, torch.tensor(0.013, device=device)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", INT8_SHAPES)
def test_int8_matmul_kernel_equals_plain_version(cuda_device, m, k, n, out_dtype):
    from bsyolo_tpu_torch.kernels.int8_matmul import int8_matmul_cuda, int8_matmul_reference

    x, w, sw, sx = _int8_operands(cuda_device, m, k, n, m + k + n)
    before = int8_matmul_cuda.launches
    got = int8_matmul_cuda(x, w, sw, sx, out_dtype)
    torch.cuda.synchronize()
    assert int8_matmul_cuda.launches == before + 1
    want = int8_matmul_reference(x, w, sw, sx, out_dtype)
    assert got.dtype == out_dtype and got.shape == (m, n)
    assert torch.equal(got, want)
    # the weight as the conv path holds it, the transpose of an (N, K) tensor: read in place
    assert torch.equal(int8_matmul_cuda(x, w.t().contiguous().t(), sw, sx, out_dtype), want)


# every tile width (N from 8 to 300, 300 as two tiles of 256), K within one stage, across two, ragged and long;
# M = 333 takes 64-row tiles, M = 17000 128-row ones (133 tiles of 128 on 132 SMs)
@pytest.mark.parametrize("m", [333, 17000])
@pytest.mark.parametrize("k", [16, 27, 48, 2304])
@pytest.mark.parametrize("n", [8, 16, 20, 32, 64, 128, 200, 256, 300])
def test_int8_matmul_every_tile_equals_plain_version(cuda_device, m, k, n):
    """Exact at every tile plan, float32 and bfloat16 out, with x read in place from
    rows at a 16-byte pitch (as the conv path writes them) and from contiguous rows."""
    from bsyolo_tpu_torch.kernels.int8_matmul import (Int8Weight, empty_rows, int8_matmul_prepared,
                                                      int8_matmul_reference, tma_readable)

    x, w, sw, sx = _int8_operands(cuda_device, m, k, n, 7 * m + 3 * k + n)
    strided = empty_rows(m, k, cuda_device).copy_(x)
    assert tma_readable(strided)
    weight = Int8Weight(w, sw)
    for out_dtype in (torch.float32, torch.bfloat16):
        want = int8_matmul_reference(x, w, sw, sx, out_dtype)
        for xx in (strided, x):
            got = int8_matmul_prepared(xx, weight, sx, out_dtype)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (out_dtype, xx.stride())


def test_int8_matmul_persistent_walk(cuda_device):
    """Many more tiles than blocks: each block walks several tiles, across two tiles of N,
    the weight riding in the stages, its ring running on from one tile into the next; exact."""
    from bsyolo_tpu_torch.kernels.int8_matmul import int8_matmul_cuda, int8_matmul_reference, tile_plan

    m, k, n = 132 * 128 * 3 + 5, 300, 300
    plan = tile_plan(m, n, k)
    assert plan.bn == 256 and not plan.resident and -(-m // plan.bm) * 2 > 8 * 132
    x, w, sw, sx = _int8_operands(cuda_device, m, k, n, 11)
    got = int8_matmul_cuda(x, w, sw, sx)
    assert torch.equal(got, int8_matmul_reference(x, w, sw, sx))


@pytest.mark.parametrize("m,k,n", [(409600, 27, 16), (102400, 48, 64), (102400, 576, 64), (40000, 256, 200)])
def test_int8_matmul_resident_weight_equals_streamed(cuda_device, m, k, n):
    """Where the plan keeps the weight in shared memory (blocks walk several tiles), the
    same product with the weight streamed through the stages instead gives the same
    output, and both equal the plain version."""
    from bsyolo_tpu_torch.kernels.int8_matmul import Int8Weight, _launch, int8_matmul_reference, tile_plan

    x, w, sw, sx = _int8_operands(cuda_device, m, k, n, 13)
    weight = Int8Weight(w, sw)
    plan = tile_plan(m, n, k)
    assert plan.resident
    want = int8_matmul_reference(x, w, sw, sx)
    assert torch.equal(_launch(x, weight, sx, torch.float32, plan), want)
    assert torch.equal(_launch(x, weight, sx, torch.float32, plan._replace(resident=False, stages=2)), want)


def test_int8_matmul_reads_strided_x_in_place(cuda_device):
    """The stem's x (K = 27) in rows 32 bytes apart, and a prepared weight: one device
    kernel per call, the int8 matmul's, and no padding copy."""
    from bsyolo_tpu_torch.kernels.int8_matmul import Int8Weight, empty_rows, int8_matmul_prepared

    x, w, sw, sx = _int8_operands(cuda_device, 4096, 27, 16, 5)
    x = empty_rows(4096, 27, cuda_device).copy_(x)
    weight = Int8Weight(empty_rows(16, 27, cuda_device).copy_(w.t()).t(), sw)
    kernels = _device_kernels(lambda: int8_matmul_prepared(x, weight, sx))  # after a first launch: library, descriptor
    assert len(kernels) == 3 and all("int8_matmul_kernel" in name for name in kernels), kernels


def test_int8_matmul_kernel_refuses_what_it_does_not_take(cuda_device):
    from bsyolo_tpu_torch.kernels.int8_matmul import int8_matmul_cuda

    x = torch.zeros((64, 32), dtype=torch.int8, device=cuda_device)
    w = torch.zeros((32, 16), dtype=torch.int8, device=cuda_device)
    sw, sx = torch.ones(16, device=cuda_device), torch.tensor(1.0, device=cuda_device)
    with pytest.raises(TypeError, match="int8"):
        int8_matmul_cuda(x.float(), w, sw, sx)
    with pytest.raises(ValueError, match="x"):
        int8_matmul_cuda(x, w[:16], sw, sx)
    with pytest.raises(ValueError, match="sw"):
        int8_matmul_cuda(x, w, sw[:8], sx)
    with pytest.raises(ValueError, match="sx"):
        int8_matmul_cuda(x, w, sw, sx.cpu())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        int8_matmul_cuda(x, w, sw, sx, torch.float16)


@pytest.mark.parametrize("k,s,static", [(1, 1, False), (3, 1, True), (3, 2, False)])
def test_int8_conv_on_the_card_equals_the_cpu(cuda_device, k, s, static):
    """One int8 Conv on the card against the same Conv on the CPU; one launch each call."""
    from bsyolo_tpu_torch.kernels.int8_matmul import int8_matmul_cuda
    from bsyolo_tpu_torch.nn.modules import Conv, set_int8_inference

    rng = np.random.default_rng(k * 10 + s)
    torch.manual_seed(k * 10 + s)
    host = Conv(48, 64, k, s).eval()
    with torch.no_grad():
        host.bn.running_mean.uniform_(-0.1, 0.1)
        host.bn.running_var.uniform_(0.5, 1.5)
    x = torch.from_numpy(rng.normal(0, 1, (4, 48, 40, 40)).astype(np.float32))
    card = Conv(48, 64, k, s).to(cuda_device).eval()
    card.load_state_dict(host.state_dict())
    scales = {"conv": 0.9 * x.abs().max().item()} if static else None
    set_int8_inference(host, True, scales)
    set_int8_inference(card, True, scales)
    before = int8_matmul_cuda.launches
    with torch.inference_mode():
        want = host(x)
        got = card(x.to(cuda_device))
    torch.cuda.synchronize()
    assert int8_matmul_cuda.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def test_int8_predict_on_the_card_launches_the_int8_kernel(cuda_device):
    """Calibrated int8 predict: one int8 matmul launch per quantizable conv per batch; off again, none."""
    from bsyolo_tpu_torch import YOLO, kernels
    from bsyolo_tpu_torch.nn.modules import quantizable_convs, set_int8_inference
    from bsyolo_tpu_torch.nn.quant import calibrate_int8
    from bsyolo_tpu_torch.ops.letterbox import letterbox

    model = YOLO("yolo11n.yaml", device=cuda_device)
    rng = np.random.default_rng(10)
    frames = [rng.integers(0, 256, (96, 128, 3), dtype=np.uint8) for _ in range(3)]
    batch = torch.stack([letterbox(f, (128, 128), cuda_device) for f in frames]).float() / 255.0
    scales = calibrate_int8(model.model, [batch])
    assert len(scales) == len(quantizable_convs(model.model)) == 74
    set_int8_inference(model.model, True, scales)
    kernels.reset_launch_counts()
    res = model.predict(frames, imgsz=128, conf=0.001, batch=2)
    assert kernels.launch_counts() == {"decode_box_best": 2, "decode_xywh": 0, "int8_matmul": 74 * 2}
    assert all(r.boxes.data.shape[1] == 6 and np.isfinite(r.boxes.data).all() for r in res)
    set_int8_inference(model.model, False)
    kernels.reset_launch_counts()
    model.predict(frames[:2], imgsz=128, conf=0.001, batch=2)
    assert kernels.launch_counts() == {"decode_box_best": 1, "decode_xywh": 0, "int8_matmul": 0}


def _tiny_graph(seed, nc=2):
    """tests/fixtures/tiny.yaml on the CPU, weights from a seeded generator (head scaled so its logits spread)."""
    from pathlib import Path

    from bsyolo_tpu_torch.nn.model import build_model
    from bsyolo_tpu_torch.nn.parser import load_model_yaml, parse_model_yaml

    d = load_model_yaml(str(Path(__file__).parent / "fixtures" / "tiny.yaml"))
    d["nc"] = nc
    spec = parse_model_yaml(d)
    model = build_model(spec, "cpu", seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(torch.empty(t.shape).uniform_(0.5, 1.5, generator=g))
            elif name.endswith("running_mean"):
                t.copy_(torch.empty(t.shape).uniform_(-0.1, 0.1, generator=g))
    return spec, model


def _tiny_batch(seed, b, hw, nc=2, m=4):
    rng = np.random.default_rng(seed)
    h, w = hw
    img = rng.integers(0, 60, (b, 3, h, w), dtype=np.uint8)
    cls, boxes, mask = np.zeros((b, m), np.int64), np.zeros((b, m, 4), np.float32), np.zeros((b, m), np.float32)
    for i in range(b):
        for j in range(int(rng.integers(1, m))):
            bw, bh = int(rng.integers(w // 8, w // 2)), int(rng.integers(h // 8, h // 2))
            x0, y0 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            c = int(rng.integers(0, nc))
            img[i, :, y0 : y0 + bh, x0 : x0 + bw] = 120 + 100 * c
            boxes[i, j], cls[i, j], mask[i, j] = [(x0 + bw / 2) / w, (y0 + bh / 2) / h, bw / w, bh / h], c, 1
    return {"img": img, "cls": cls, "bboxes": boxes, "mask": mask}


def test_train_step_on_the_card_equals_the_cpu(cuda_device):
    """One SGD step of tiny.yaml at 64 px, batch 2, card against CPU from the same weights and
    batch: loss within rtol 1e-4; params, EMA and BatchNorm statistics within rtol 1e-4 /
    atol 1e-6; the momentum buffers and the accumulator within rtol 1e-4 / atol 1e-4 of the
    largest magnitude in the slot (gradient sums, whose small elements cancel); no kernel of
    the port launched."""
    from bsyolo_tpu_torch import kernels
    from bsyolo_tpu_torch.engine.optim import OptimConfig
    from bsyolo_tpu_torch.engine.train_step import StepConfig, init_train_state, make_train_step
    from bsyolo_tpu_torch.losses import DetectionLossConfig

    spec, host = _tiny_graph(3)
    card = _tiny_graph(3)[1].to(cuda_device)
    cfg = StepConfig(loss=DetectionLossConfig(nc=spec.nc, strides=spec.head_strides),
                     optim=OptimConfig(name="SGD", lr0=0.01, nbs=4, warmup_bias_lr=0.1), batch_size=2, nb=5, nw=2,
                     use_adamw=False, weight_decay=5e-4)
    batch = _tiny_batch(4, 2, (64, 64))
    out = {}
    kernels.reset_launch_counts()
    for label, model, dev in (("cpu", host, "cpu"), ("card", card, cuda_device)):
        state = init_train_state(model, cfg)
        state, metrics = make_train_step(model, cfg)(state, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        out[label] = (state, metrics)
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNELS}
    (hs, hm), (cs, cm) = out["cpu"], out["card"]
    assert cm["updated"] == hm["updated"] == 1 and cs.acc_grads is not None and cs.slot1 is None
    np.testing.assert_allclose(float(cm["loss"]), float(hm["loss"]), rtol=1e-4)
    for field in ("params", "ema_params", "batch_stats", "slot0", "acc_grads"):
        tensors = getattr(hs, field)
        atol = 1e-6 if field in ("params", "ema_params", "batch_stats") else 1e-4 * max(
            t.abs().max().item() for t in tensors.values())
        for name, want in tensors.items():
            got = getattr(cs, field)[name].detach().cpu()
            np.testing.assert_allclose(got.numpy(), want.detach().numpy(), rtol=1e-4, atol=atol, err_msg=f"{field} {name}")


def test_validator_on_the_card_launches_the_box_kernel_once_per_batch(cuda_device):
    """DetectionValidator on the card: one decode_box launch per batch at two canvas shapes,
    the plain decode never; the same metrics and confusion matrix as on the CPU."""
    from bsyolo_tpu_torch import kernels
    from bsyolo_tpu_torch.engine.validator import DetectionValidator
    from bsyolo_tpu_torch.kernels import decode

    spec, host = _tiny_graph(5)
    card = _tiny_graph(5)[1].to(cuda_device)
    batches = [_tiny_batch(10 + i, 4, hw) for i, hw in enumerate(((64, 64), (64, 64), (64, 32)))]
    for i, b in enumerate(batches):
        b["im_idx"] = np.arange(4 * i, 4 * i + 4)
    batches[-1]["im_idx"][-1] = -1
    plain, calls = decode.box_best_reference, []
    decode.box_best_reference = lambda *a, **k: calls.append(1) or plain(*a, **k)
    try:
        kernels.reset_launch_counts()
        got = DetectionValidator(card, spec, device=cuda_device)(None, batches)
        assert kernels.launch_counts() == {"decode_box_best": 3, "decode_xywh": 0, "int8_matmul": 0} and not calls
    finally:
        decode.box_best_reference = plain
    want = DetectionValidator(host, spec, device="cpu")(None, batches)
    np.testing.assert_allclose(list(got.results_dict.values()), list(want.results_dict.values()), rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(got.confusion_matrix.matrix, want.confusion_matrix.matrix)


# (B, level sizes, strides, nc) for 2-byte levels: the predict shape; a P6 pyramid whose 5 x 5 level has odd
# H * W (plain loads); 6 x 6 and 2 x 2 levels of even H * W not a multiple of 8 (2-byte pairs)
HALF_SHAPES = {
    "b4-640": (4, *_square(640), 12),
    "p6-odd": (2, ((40, 40), (20, 20), (10, 10), (5, 5)), (8, 16, 32, 64), 12),
    "pairs": (2, ((12, 12), (6, 6), (2, 2)), (8, 16, 32), 80),
}


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("shape", list(HALF_SHAPES))
def test_decode_kernels_take_2_byte_levels(cuda_device, shape, dtype):
    """bfloat16 and float16 levels: both kernels against their plain versions on the same levels
    (the plain versions cast to float32 first), at the f32 tolerances; float32 outputs."""
    from bsyolo_tpu_torch.kernels.decode import (box_best_cuda, box_best_reference, decode_xywh_cuda,
                                                 decode_xywh_reference)

    b, sizes, strides, nc = HALF_SHAPES[shape]
    levels = [f.to(getattr(torch, dtype)) for f in _levels(np.random.default_rng(b + nc), b, sizes, nc)]
    on_card = [f.to(cuda_device) for f in levels]
    boxes, best, cls = box_best_cuda(on_card, strides, nc)
    want_boxes, want_best, want_cls = box_best_reference(levels, strides, nc)
    assert boxes.dtype == best.dtype == cls.dtype == torch.float32
    np.testing.assert_allclose(boxes.cpu().numpy(), want_boxes.numpy(), rtol=1e-5, atol=2e-3)
    np.testing.assert_array_equal(best.cpu().numpy(), want_best.numpy())
    np.testing.assert_array_equal(cls.cpu().numpy(), want_cls.numpy())
    got = decode_xywh_cuda(on_card, strides, nc).cpu().numpy()
    want = decode_xywh_reference(levels, strides, nc).numpy()
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=1e-5, atol=2e-3)
    np.testing.assert_allclose(got[..., 4:], want[..., 4:], rtol=1e-5, atol=0)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_decode_kernels_read_misaligned_2_byte_levels(cuda_device, dtype):
    """2-byte levels that start 2 bytes past a 16-byte boundary: the 16-byte and 4-byte copies
    are both out of reach, so every level takes the plain loads."""
    from bsyolo_tpu_torch.kernels.decode import (box_best_cuda, box_best_reference, decode_xywh_cuda,
                                                 decode_xywh_reference)

    levels = [f.to(getattr(torch, dtype)) for f in _levels(np.random.default_rng(4), 2, _square(256)[0], 12)]
    shifted = []
    for f in levels:
        buf = torch.empty(f.numel() + 1, dtype=f.dtype, device=cuda_device)
        shifted.append(buf[1:].view(f.shape).copy_(f))
        assert shifted[-1].data_ptr() % 16 == 2
    boxes, best, cls = box_best_cuda(shifted, (8, 16, 32), 12)
    want_boxes, want_best, want_cls = box_best_reference(levels, (8, 16, 32), 12)
    np.testing.assert_allclose(boxes.cpu().numpy(), want_boxes.numpy(), rtol=1e-5, atol=2e-3)
    np.testing.assert_array_equal(best.cpu().numpy(), want_best.numpy())
    np.testing.assert_array_equal(cls.cpu().numpy(), want_cls.numpy())
    got = decode_xywh_cuda(shifted, (8, 16, 32), 12).cpu().numpy()
    want = decode_xywh_reference(levels, (8, 16, 32), 12).numpy()
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=1e-5, atol=2e-3)
    np.testing.assert_allclose(got[..., 4:], want[..., 4:], rtol=1e-5, atol=0)


def _png_dataset(root, n_train=16, n_val=6, size=64, seed=0):
    """A seeded 2-class PNG dataset (filled rectangles) in the images/ and labels/ layout."""
    from bsyolo_tpu_torch.data.imread import imwrite_png

    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
        for i in range(n):
            img = rng.integers(0, 60, (size, size, 3), dtype=np.uint8)
            rows = []
            for _ in range(int(rng.integers(1, 3))):
                w = int(rng.integers(12, 28))
                x0, y0, c = int(rng.integers(0, size - w)), int(rng.integers(0, size - w)), int(rng.integers(0, 2))
                img[y0 : y0 + w, x0 : x0 + w] = (220, 60, 60) if c == 0 else (60, 220, 60)
                rows.append(f"{c} {(x0 + w / 2) / size} {(y0 + w / 2) / size} {w / size} {w / size}")
            imwrite_png(root / "images" / split / f"{i:03d}.png", img)
            (root / "labels" / split / f"{i:03d}.txt").write_text("\n".join(rows) + "\n")
    (root / "data.yaml").write_text(f"path: {root}\ntrain: images/train\nval: images/val\nnames:\n  0: a\n  1: b\n")
    return root / "data.yaml"


def test_yolo_train_one_epoch_on_the_card(cuda_device, tmp_path):
    """YOLO.train on tiny.yaml at 64 px for one epoch on the card: finite losses, a results.csv row,
    best.ckpt and last.ckpt written; the validation launched decode_box once per val batch and the
    plain decode never; the trained weights stay on the card."""
    from pathlib import Path

    from bsyolo_tpu_torch import YOLO, kernels
    from bsyolo_tpu_torch.kernels import decode

    data = _png_dataset(tmp_path / "ds")
    m = YOLO(str(Path(__file__).parent / "fixtures" / "tiny.yaml"))
    plain, calls = decode.box_best_reference, []
    decode.box_best_reference = lambda *a, **k: calls.append(1) or plain(*a, **k)
    try:
        kernels.reset_launch_counts()
        m.train(data=str(data), epochs=1, imgsz=64, batch=8, nbs=8, workers=0, amp=False, plots=False,
                project=str(tmp_path / "runs"), name="card")
        counts = kernels.launch_counts()
    finally:
        decode.box_best_reference = plain
    assert counts == {"decode_box_best": 1, "decode_xywh": 0, "int8_matmul": 0} and not calls  # 6 val images, batch 8
    rows = (tmp_path / "runs" / "card" / "results.csv").read_text().splitlines()
    assert len(rows) == 2 and all(np.isfinite(float(x)) for x in rows[1].split(","))
    assert (tmp_path / "runs" / "card" / "weights" / "best.ckpt").exists()
    assert next(m.model.parameters()).device == cuda_device and m.trainer.state.step == 2


def test_yolo_val_launches_the_box_kernel_once_per_batch(cuda_device, tmp_path):
    """YOLO(<ckpt>).val on the card: one decode_box launch per validation batch (6 images at batch 4:
    2 batches); metrics equal the CPU's."""
    from pathlib import Path

    from bsyolo_tpu_torch import YOLO, kernels

    data = _png_dataset(tmp_path / "ds")
    host = YOLO(str(Path(__file__).parent / "fixtures" / "tiny.yaml"), device="cpu")  # seeded weights, 2 classes
    path = host.save(tmp_path / "w.ckpt")
    card = YOLO(path)
    kernels.reset_launch_counts()
    got = card.val(data=str(data), batch=4, imgsz=64)
    assert kernels.launch_counts() == {"decode_box_best": 2, "decode_xywh": 0, "int8_matmul": 0}
    want = YOLO(path, device="cpu").val(data=str(data), batch=4, imgsz=64)
    np.testing.assert_allclose(list(got.results_dict.values()), list(want.results_dict.values()), atol=1e-6)


# --- the bf16 graph (half, amp) ------------------------------------------------------------------

HALF_HEAD_NORM = 1e-2  # bf16 head levels, card against CPU: cuDNN's and the CPU's bf16 convolutions round apart


def _seeded_yolo11n(device):
    """yolo11n with seeded weights that spread the head's logits (the default init ties every score)."""
    from bsyolo_tpu_torch import YOLO

    m = YOLO("yolo11n.yaml", device="cpu")
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, t in m.model.state_dict().items():
            if t.dim() >= 2:
                t.copy_(torch.empty(t.shape).uniform_(-1, 1, generator=g) * (3.0 / t[0].numel()) ** 0.5)
            elif name.endswith(("running_var", "bn.weight")):
                t.copy_(torch.empty(t.shape).uniform_(0.5, 1.5, generator=g))
            elif t.is_floating_point():
                t.copy_(torch.empty(t.shape).uniform_(-0.1, 0.1, generator=g))
    card = YOLO("yolo11n.yaml", device=device)
    card.model.load_state_dict(m.model.state_dict())
    return m, card


def test_bf16_graph_on_the_card_matches_the_cpu(cuda_device):
    """The facade's bf16 graph (half_graph) on the card against the same graph on the CPU: bfloat16
    head levels, each within HALF_HEAD_NORM of the CPU's, norm-relative."""
    host, card = _seeded_yolo11n(cuda_device)
    x = torch.from_numpy(np.random.default_rng(5).uniform(0, 1, (2, 3, 128, 128)).astype(np.float32))
    with torch.inference_mode():
        want = host.half_graph()(x)
        got = card.half_graph()(x.to(cuda_device))
    for g, w in zip(got, want):
        err = ((g.float().cpu() - w.float()).norm() / w.float().norm()).item()
        print(f"bf16 level {tuple(g.shape)}: card vs CPU {err:.3g} of the norm")
        assert g.dtype == w.dtype == torch.bfloat16 and g.is_contiguous() and err <= HALF_HEAD_NORM


def test_half_predict_launches_the_decode_kernels_on_bf16_levels(cuda_device):
    """predict(half=True): decode_box once per batch, on the bf16 head, never the plain version; with
    augment, decode_xywh three times per batch; predict_tiled on the half graph, decode_xywh once.
    The kernels' outputs on that head equal their plain versions' on the same levels."""
    from bsyolo_tpu_torch import kernels
    from bsyolo_tpu_torch.engine.tiled import predict_tiled
    from bsyolo_tpu_torch.kernels import decode

    _, card = _seeded_yolo11n(cuda_device)
    frames = [np.random.default_rng(i).integers(0, 256, (96, 128, 3), dtype=np.uint8) for i in range(3)]
    heads = []
    half = card.half_graph()
    half.model[-1].register_forward_hook(lambda m, a, out: heads.append(out))
    calls = []
    plain_box, plain_xywh = decode.box_best_reference, decode.decode_xywh_reference
    decode.box_best_reference = lambda *a, **k: calls.append(1) or plain_box(*a, **k)
    decode.decode_xywh_reference = lambda *a, **k: calls.append(1) or plain_xywh(*a, **k)
    try:
        kernels.reset_launch_counts()
        res = card.predict(frames, imgsz=128, conf=0.001, batch=2, half=True)
        assert kernels.launch_counts() == {"decode_box_best": 2, "decode_xywh": 0, "int8_matmul": 0}
        kernels.reset_launch_counts()
        card.predict(frames, imgsz=128, conf=0.001, batch=2, half=True, augment=True)
        assert kernels.launch_counts() == {"decode_box_best": 0, "decode_xywh": 6, "int8_matmul": 0}
        kernels.reset_launch_counts()
        tiled = predict_tiled(card.half_graph(), card.spec, np.zeros((200, 300, 3), np.uint8) + 90, tile=128,
                              conf=0.001)
        assert kernels.launch_counts() == {"decode_box_best": 0, "decode_xywh": 1, "int8_matmul": 0}
    finally:
        decode.box_best_reference, decode.decode_xywh_reference = plain_box, plain_xywh
    assert not calls and all(f.dtype == torch.bfloat16 for feats in heads for f in feats)
    assert all(np.isfinite(r.boxes.data).all() for r in res) and np.isfinite(tiled).all()
    spec, feats = card.spec, heads[0]
    boxes, best, cls = decode.box_best_cuda(feats, spec.head_strides, spec.nc)
    wb, wbest, wcls = plain_box(feats, spec.head_strides, spec.nc)
    np.testing.assert_allclose(boxes.cpu().numpy(), wb.cpu().numpy(), rtol=1e-5, atol=2e-3)
    assert torch.equal(best, wbest) and torch.equal(cls, wcls)
    xywh, want = decode.decode_xywh_cuda(feats, spec.head_strides, spec.nc), plain_xywh(feats, spec.head_strides, spec.nc)
    np.testing.assert_allclose(xywh.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=2e-3)


@pytest.mark.parametrize("k,s,static", [(1, 1, False), (3, 2, True)])
def test_int8_conv_on_the_half_graph_returns_bf16(cuda_device, k, s, static):
    """An int8 Conv computing in bfloat16: the kernel's bf16 epilogue on the card equals the plain
    version's bf16 epilogue on the CPU exactly (the same codes, int32 sums, one rounding), and the
    Conv returns bfloat16."""
    from bsyolo_tpu_torch.kernels.int8_matmul import int8_matmul_cuda
    from bsyolo_tpu_torch.nn.model import set_compute_dtype
    from bsyolo_tpu_torch.nn.modules import Conv, set_int8_inference

    rng = np.random.default_rng(k * 10 + s)
    torch.manual_seed(k * 10 + s)
    host = set_compute_dtype(Conv(48, 64, k, s).eval(), torch.bfloat16)
    card = set_compute_dtype(Conv(48, 64, k, s).to(cuda_device).eval(), torch.bfloat16)
    card.load_state_dict(host.state_dict())
    x = torch.from_numpy(rng.normal(0, 1, (4, 48, 40, 40)).astype(np.float32)).to(torch.bfloat16)
    scales = {"conv": 0.9 * x.float().abs().max().item()} if static else None
    set_int8_inference(host, True, scales)
    set_int8_inference(card, True, scales)
    before = int8_matmul_cuda.launches
    with torch.inference_mode():
        want, got = host._int8_conv(x), card._int8_conv(x.to(cuda_device))
        out = card(x.to(cuda_device))
    torch.cuda.synchronize()
    assert int8_matmul_cuda.launches == before + 2
    assert got.dtype == want.dtype == out.dtype == torch.bfloat16
    assert torch.equal(got.cpu(), want)


def test_yolo_train_with_the_default_amp_on_the_card(cuda_device, tmp_path):
    """YOLO.train with amp left at its default (True) on tiny.yaml at 64 px: the bf16 graph, float32
    parameters, finite losses; the validation launches decode_box once on bf16 levels."""
    from pathlib import Path

    from bsyolo_tpu_torch import YOLO, kernels
    from bsyolo_tpu_torch.nn.model import compute_dtype

    data = _png_dataset(tmp_path / "ds")
    m = YOLO(str(Path(__file__).parent / "fixtures" / "tiny.yaml"))
    kernels.reset_launch_counts()
    m.train(data=str(data), epochs=1, imgsz=64, batch=8, nbs=8, workers=0, plots=False,
            project=str(tmp_path / "runs"), name="amp")
    assert kernels.launch_counts() == {"decode_box_best": 1, "decode_xywh": 0, "int8_matmul": 0}
    assert m.trainer.args.amp is True and compute_dtype(m.model) == torch.bfloat16
    assert all(p.dtype == torch.float32 and p.device == cuda_device for p in m.model.parameters())
    rows = (tmp_path / "runs" / "amp" / "results.csv").read_text().splitlines()
    assert len(rows) == 2 and all(np.isfinite(float(x)) for x in rows[1].split(","))


# --- the product path: tracking and the parking-violation application ------------------------------


def test_grfb_unet_on_the_card_matches_the_cpu(cuda_device):
    """GRFB-UNet at the application's width (base_c 32) on an odd 100 x 140 input: the card's logits
    within 1e-3 of the CPU's norm (TF32 off: cuDNN's float32 convolutions sum in another order)."""
    from bsyolo_tpu_torch.app import GRFBUNet
    from bsyolo_tpu_torch.app.grfb_unet import _init_from_generator

    host = GRFBUNet(num_classes=2, base_c=32)
    _init_from_generator(host, torch.Generator().manual_seed(0))
    card = GRFBUNet(num_classes=2, base_c=32).to(cuda_device).eval()
    card.load_state_dict(host.state_dict())
    x = torch.from_numpy(np.random.default_rng(6).normal(0, 1, (1, 3, 100, 140)).astype(np.float32))
    with torch.inference_mode():
        want = host.eval()(x)
        got = card(x.to(cuda_device)).cpu()
    err = ((got - want).norm() / want.norm()).item()
    print(f"GRFB-UNet card vs CPU: {err:.3g} of the norm")
    assert got.shape == want.shape == (1, 2, 100, 140) and err <= 1e-3


def test_segmenter_mask_on_the_card_matches_the_cpu(cuda_device):
    """BlindwaySegmenter on the card against the CPU on a 240 x 320 frame (resize 128): the networks'
    inputs within 1 ulp (the resize is integer arithmetic, the normalization three correctly rounded
    float32 operations), the masks equal but where the two logits nearly tie, at most 1e-3 of the
    pixels."""
    from bsyolo_tpu_torch.app import BlindwaySegmenter

    frame = np.random.default_rng(7).integers(0, 256, (240, 320, 3), dtype=np.uint8)
    host = BlindwaySegmenter(base_c=16, resize=128, device="cpu")
    card = BlindwaySegmenter(base_c=16, resize=128, device=cuda_device)
    card.model.load_state_dict(host.model.state_dict())
    torch.testing.assert_close(card.network_input(frame).cpu(), host.network_input(frame), rtol=0, atol=2e-6)
    got, want = card(frame), host(frame)
    assert got.shape == want.shape == (240, 320) and got.dtype == np.uint8
    assert (got != want).mean() <= 1e-3


def test_track_launches_the_box_kernel_once_per_frame(cuda_device):
    """YOLO.track over 6 frames at batch 1: decode_box once per frame, its plain version never, and
    every tracked row carries an integer track id."""
    from pathlib import Path

    from bsyolo_tpu_torch import YOLO, kernels
    from bsyolo_tpu_torch.kernels import decode

    m = YOLO(str(Path(__file__).parent / "fixtures" / "tiny.yaml"))
    frames = [np.full((96, 128, 3), 40 + 10 * i, np.uint8) for i in range(6)]
    plain, calls = decode.box_best_reference, []
    decode.box_best_reference = lambda *a, **k: calls.append(1) or plain(*a, **k)
    try:
        kernels.reset_launch_counts()
        results = m.track(frames, imgsz=96, conf=0.0001,
                          tracker=str(Path(__file__).parent / "fixtures" / "trackertest.yaml"))
        counts = kernels.launch_counts()
    finally:
        decode.box_best_reference = plain
    assert counts == {"decode_box_best": 6, "decode_xywh": 0, "int8_matmul": 0} and not calls
    assert len(results) == 6 and all(r.boxes.is_track for r in results if len(r))
    ids = np.concatenate([r.boxes.id for r in results if len(r)])
    assert len(ids) and np.array_equal(ids, np.round(ids))


# --- real photos: JPEG files through the reader thread ---------------------------------------------------------

# card vs CPU rows: chip_smoke.py's pairing (same class, box within 0.05 px, score within 1e-4, at least 0.98 of
# the rows): near-tied scores may swap rows or cross the NMS and max_det boundaries under float rounding
PHOTO_BOX_PX, PHOTO_SCORE, PHOTO_MIN_FRACTION = 0.05, 1e-4, 0.98


def _paired_fraction(got: np.ndarray, want: np.ndarray) -> float:
    free = np.ones(len(want), bool)
    n = 0
    for row in got:
        ok = free & (want[:, 5] == row[5]) & (np.abs(want[:, :4] - row[:4]).max(1) <= PHOTO_BOX_PX)
        ok &= np.abs(want[:, 4] - row[4]) <= PHOTO_SCORE
        if ok.any():
            free[np.flatnonzero(ok)[0]] = False
            n += 1
    return n / max(len(got), len(want), 1)


def test_predict_from_jpeg_files_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """predict over the bsyolo8 photos' directory at batch 4: the decode kernel once per batch, the rows
    paired with the CPU's, the label files one per photo."""
    from pathlib import Path

    from bsyolo_tpu_torch import kernels

    photos = Path(__file__).parent / "fixtures" / "bsyolo8" / "images" / "train"
    host, card = _seeded_yolo11n(cuda_device)
    kernels.reset_launch_counts()
    got = card.predict(str(photos), imgsz=320, conf=0.001, batch=4, save_txt=True, project=str(tmp_path), name="p")
    assert kernels.launch_counts() == {"decode_box_best": 2, "decode_xywh": 0, "int8_matmul": 0}
    want = host.predict(str(photos), imgsz=320, conf=0.001, batch=4)
    assert [r.path for r in got] == [r.path for r in want] and len(got) == 8
    n = sum(len(r) for r in want)
    frac = sum(_paired_fraction(g.boxes.data, w.boxes.data) * max(len(g), len(w)) for g, w in zip(got, want)) / n
    assert n > 0 and frac >= PHOTO_MIN_FRACTION
    assert len(list((tmp_path / "p" / "labels").glob("*.txt"))) == 8
    assert 0 <= card.predictor.reader_wait <= card.predictor.wall


# the Segment (nc 80, 32 mask coefficients) and Pose (nc 1, 17 x 3 keypoints) heads at 640 px: levels
# with channels past 64 + nc, which the box kernel must step over
TASK_HEADS = {"segment": (4, 80, 32), "pose": (4, 1, 51)}


@pytest.mark.parametrize("task", list(TASK_HEADS))
def test_decode_kernel_reads_task_heads(cuda_device, task):
    from bsyolo_tpu_torch.kernels.decode import box_best_cuda, box_best_reference

    b, nc, extra = TASK_HEADS[task]
    sizes, strides = _square(640)
    rng = np.random.default_rng(nc + extra)
    levels = []
    for h, w in sizes:
        f = rng.normal(0, 2, (b, 64 + nc + extra, h, w)).astype(np.float32)
        f[:, 64 + nc :] = 1e4 * np.sign(f[:, 64 + nc :])  # read as a class or a bin, these would show
        levels.append(torch.from_numpy(f))
    before = box_best_cuda.launches
    boxes, best, cls = box_best_cuda([f.to(cuda_device) for f in levels], strides, nc)
    torch.cuda.synchronize()
    assert box_best_cuda.launches == before + 1
    want_boxes, want_best, want_cls = box_best_reference(levels, strides, nc)
    assert float(best.abs().max()) < 100
    np.testing.assert_allclose(boxes.cpu().numpy(), want_boxes.numpy(), rtol=1e-5, atol=2e-3)
    np.testing.assert_array_equal(best.cpu().numpy(), want_best.numpy())
    np.testing.assert_array_equal(cls.cpu().numpy(), want_cls.numpy())


@pytest.mark.parametrize("graph", ["tinyseg.yaml", "tinypose.yaml"])
def test_task_predict_on_the_card_matches_the_cpu(cuda_device, graph):
    """Segment (masks and retina masks) and Pose (keypoints) predict on the card against the CPU, from
    the same weights: one box-kernel launch per batch, rows within 2e-3 px, masks equal on at least
    0.999 of the pixels, keypoints within 2e-3 px."""
    from pathlib import Path

    from bsyolo_tpu_torch import YOLO
    from bsyolo_tpu_torch.kernels.decode import box_best_cuda

    path = str(Path(__file__).parent / "fixtures" / graph)
    host = YOLO(path, device="cpu")
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in host.model.parameters():
            p.copy_(torch.empty_like(p).uniform_(-1, 1, generator=g) * (3.0 / max(p[0].numel(), 1)) ** 0.5)
    card = YOLO(path, device="cuda")
    card.model.load_state_dict(host.model.state_dict())
    frames = [np.random.default_rng(i).integers(0, 256, (96, 128, 3), dtype=np.uint8) for i in range(4)]
    for kw in ({}, {"retina_masks": True}) if "seg" in graph else ({},):
        before = box_best_cuda.launches
        got = card.predict(frames, imgsz=128, conf=0.05, batch=2, **kw)
        assert box_best_cuda.launches == before + 2
        want = host.predict(frames, imgsz=128, conf=0.05, batch=2, **kw)
        for a, b in zip(got, want):
            assert a.boxes.data.shape == b.boxes.data.shape and len(a) > 0
            np.testing.assert_allclose(a.boxes.data[:, :4], b.boxes.data[:, :4], rtol=0, atol=2e-3)
            if a.masks is not None:
                assert np.mean(a.masks.data == b.masks.data) >= 0.999
            if a.keypoints is not None:
                np.testing.assert_allclose(a.keypoints.data[..., :2], b.keypoints.data[..., :2], rtol=0, atol=2e-3)


@pytest.mark.parametrize("graph", ["tinyobb.yaml", "tinycls.yaml"])
def test_obb_and_classify_predict_on_the_card_match_the_cpu(cuda_device, graph):
    """OBB (rotated rows) and Classify (probabilities) predict on the card against the CPU, from the same
    weights: no kernel of the port launches; rows within 2e-3 px and 1e-5 rad, probabilities within 1e-6."""
    from pathlib import Path

    from bsyolo_tpu_torch import YOLO, kernels

    path = str(Path(__file__).parent / "fixtures" / graph)
    host = YOLO(path, device="cpu")
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in host.model.parameters():
            p.copy_(torch.empty_like(p).uniform_(-1, 1, generator=g) * (3.0 / max(p[0].numel(), 1)) ** 0.5)
    card = YOLO(path, device="cuda")
    card.model.load_state_dict(host.model.state_dict())
    frames = [np.random.default_rng(i).integers(0, 256, (96, 128, 3), dtype=np.uint8) for i in range(4)]
    before = kernels.launch_counts()
    got = card.predict(frames, imgsz=128, conf=0.05, batch=2)
    assert kernels.launch_counts() == before
    want = host.predict(frames, imgsz=128, conf=0.05, batch=2)
    for a, b in zip(got, want):
        if "cls" in graph:
            np.testing.assert_allclose(a.probs.data, b.probs.data, rtol=0, atol=1e-6)
            continue
        assert a.obb.data.shape == b.obb.data.shape and len(a) > 0
        np.testing.assert_allclose(a.obb.data[:, :4], b.obb.data[:, :4], rtol=0, atol=2e-3)
        np.testing.assert_allclose(a.obb.data[:, 6], b.obb.data[:, 6], rtol=0, atol=1e-5)


@pytest.mark.parametrize("task", list(TASK_HEADS))
def test_decode_kernel_reads_bf16_task_heads(cuda_device, task):
    """The bf16 graph's Segment and Pose heads (predict and val with half=True, the amp trainer's validation):
    bfloat16 levels of 64 + nc + extra channels, against the plain version on the same levels."""
    from bsyolo_tpu_torch.kernels.decode import box_best_cuda, box_best_reference

    b, nc, extra = TASK_HEADS[task]
    sizes, strides = _square(640)
    rng = np.random.default_rng(2 * nc + extra)
    levels = []
    for h, w in sizes:
        f = rng.normal(0, 2, (b, 64 + nc + extra, h, w)).astype(np.float32)
        f[:, 64 + nc :] = 1e4 * np.sign(f[:, 64 + nc :])
        levels.append(torch.from_numpy(f).to(torch.bfloat16))
    before = box_best_cuda.launches
    boxes, best, cls = box_best_cuda([f.to(cuda_device) for f in levels], strides, nc)
    torch.cuda.synchronize()
    assert box_best_cuda.launches == before + 1
    want_boxes, want_best, want_cls = box_best_reference(levels, strides, nc)
    assert boxes.dtype == torch.float32 and float(best.abs().max()) < 100
    np.testing.assert_allclose(boxes.cpu().numpy(), want_boxes.numpy(), rtol=1e-5, atol=2e-3)
    np.testing.assert_array_equal(best.cpu().numpy(), want_best.numpy())
    np.testing.assert_array_equal(cls.cpu().numpy(), want_cls.numpy())


# int8 products of the task graphs at batch 4: Proto's cv2 (576 -> 64) and cv3 (64 -> 32) at 160 x 160, the
# yolo11n-obb stem at 1024 px, Classify's 1x1 conv to 1280 channels on a 7 x 7 map
TASK_INT8_SHAPES = [(102400, 576, 64), (102400, 64, 32), (1048576, 27, 16), (196, 256, 1280)]


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", TASK_INT8_SHAPES)
def test_int8_matmul_on_task_graph_shapes_equals_plain_version(cuda_device, m, k, n, out_dtype):
    from bsyolo_tpu_torch.kernels.int8_matmul import (Int8Weight, empty_rows, int8_matmul_cuda, int8_matmul_prepared,
                                                      int8_matmul_reference)

    x, w, sw, sx = _int8_operands(cuda_device, m, k, n, m + k + n)
    rows = empty_rows(m, k, cuda_device).copy_(x)  # as the conv path lays out its im2col rows
    weight = Int8Weight(empty_rows(n, k, cuda_device).copy_(w.t()).t(), sw)
    before = int8_matmul_cuda.launches
    got = int8_matmul_prepared(rows, weight, sx, out_dtype)
    torch.cuda.synchronize()
    assert int8_matmul_cuda.launches == before + 1
    assert got.dtype == out_dtype and got.shape == (m, n)
    assert torch.equal(got, int8_matmul_reference(x, w, sw, sx, out_dtype))


@pytest.mark.parametrize("graph", ["tinyseg.yaml", "tinypose.yaml", "tinyobb.yaml", "tinycls.yaml"])
def test_half_and_int8_task_predict_on_the_card_match_the_cpu(cuda_device, graph):
    """predict(half=True) and int8 predict of the four task graphs on the card against the CPU from the same
    weights and scales: the box kernel once per batch on Segment and Pose heads, the int8 kernel once per
    quantized conv per batch; bf16 rows without suppression (iou 1.0: cuDNN's and the CPU's bf16 convolutions
    round apart, and near-tied scores would suppress other rows) at least 0.9 within 1 px of a CPU row,
    probabilities within 1e-2; int8 probabilities within 1e-3 and rows as counts only (a code that flips moves
    later ones)."""
    from pathlib import Path

    from bsyolo_tpu_torch import YOLO, kernels
    from bsyolo_tpu_torch.nn.modules import quantizable_convs, set_int8_inference
    from bsyolo_tpu_torch.nn.quant import calibrate_int8

    path = str(Path(__file__).parent / "fixtures" / graph)
    host = YOLO(path, device="cpu")
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in host.model.parameters():
            p.copy_(torch.empty_like(p).uniform_(-1, 1, generator=g) * (3.0 / max(p[0].numel(), 1)) ** 0.5)
    card = YOLO(path, device="cuda")
    card.model.load_state_dict(host.model.state_dict())
    frames = [np.random.default_rng(i).integers(0, 256, (96, 128, 3), dtype=np.uint8) for i in range(4)]
    detects = "seg" in graph or "pose" in graph
    before = kernels.launch_counts()
    got = card.predict(frames, imgsz=128, conf=0.05, batch=2, half=True, iou=1.0)
    after = kernels.launch_counts()
    assert after["decode_box_best"] - before["decode_box_best"] == (2 if detects else 0)
    want = host.predict(frames, imgsz=128, conf=0.05, batch=2, half=True, iou=1.0)
    for a, b in zip(got, want):
        if "cls" in graph:
            np.testing.assert_allclose(a.probs.data, b.probs.data, rtol=0, atol=1e-2)
            continue
        da, db = (a.obb.data, b.obb.data) if "obb" in graph else (a.boxes.data, b.boxes.data)
        close = [np.abs(db[:, :4] - r[:4]).max(1).min() <= 1.0 if len(db) else False for r in da]
        assert len(da) > 0 and np.mean(close) >= 0.9
    x = torch.rand(2, 3, 128, 128, generator=torch.Generator().manual_seed(6))
    scales = calibrate_int8(host.model, [x])
    n_convs = len(quantizable_convs(card.model))
    set_int8_inference(card.model, True, scales)
    set_int8_inference(host.model, True, scales)
    before = kernels.launch_counts()
    got = card.predict(frames, imgsz=128, conf=0.05, batch=2)
    after = kernels.launch_counts()
    assert after["int8_matmul"] - before["int8_matmul"] == 2 * n_convs
    want = host.predict(frames, imgsz=128, conf=0.05, batch=2)
    for a, b in zip(got, want):
        if "cls" in graph:
            np.testing.assert_allclose(a.probs.data, b.probs.data, rtol=0, atol=1e-3)
        else:
            assert abs(len(a) - len(b)) <= max(2, len(b) // 10)
