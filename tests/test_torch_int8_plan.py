"""How the int8 matmul kernel's launch is planned and fed, checked on the CPU.

Covers the pure-Python parts of ``bsyolo_tpu_torch/kernels/int8_matmul.py``
that decide what the CUDA kernel is given: ``tile_plan`` (tile rows, tile
width and stages, checked against every product of the yolo11n int8 path and
a few ragged shapes), ``tma_readable`` (which operands the kernel reads in
place), and the int8 conv's operands: its im2col rows at a 16-byte pitch and
its cached weight, with the conv's output against the JAX ``_RawConv`` int8
branch (through ``ConvBN``). Tolerances: exact for layouts and codes; the conv
within rtol 1e-5, atol 1e-6, as ``tests/test_torch_int8.py`` (the same codes,
BatchNorm's float32 order differs).
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from bsyolo_tpu.nn import modules as JM
from torch_port import nchw, port_module_from_jax, random_variables, variable_shapes

# (M, K, N) of the int8 matmul of each of yolo11n's 74 quantizable convs, batch 4 at 640 px, in graph order;
# test_path_shapes_are_the_graphs checks the list against the port's graph
PATH_SHAPES = [
    (409600, 27, 16), (102400, 144, 32), (102400, 32, 32), (102400, 144, 16), (102400, 16, 16), (102400, 48, 64),
    (25600, 576, 64), (25600, 64, 64), (25600, 288, 32), (25600, 32, 32), (25600, 96, 128), (25600, 128, 128),
    (6400, 128, 128), (6400, 64, 32), (6400, 288, 32), (6400, 32, 32), (6400, 288, 32), (6400, 32, 32),
    (6400, 64, 32), (6400, 64, 64), (6400, 192, 128), (6400, 128, 256), (1600, 256, 256), (1600, 128, 64),
    (1600, 576, 64), (1600, 64, 64), (1600, 576, 64), (1600, 64, 64), (1600, 128, 64), (1600, 128, 128),
    (1600, 384, 256), (1600, 256, 128), (1600, 512, 256), (1600, 256, 256), (1600, 128, 256), (1600, 128, 128),
    (1600, 128, 256), (1600, 256, 128), (1600, 256, 256), (6400, 384, 128), (6400, 576, 32), (6400, 288, 64),
    (6400, 192, 128), (25600, 256, 64), (25600, 288, 16), (25600, 144, 32), (25600, 96, 64), (6400, 576, 64),
    (6400, 448, 128), (6400, 576, 32), (6400, 288, 64), (6400, 192, 128), (6400, 128, 128), (1600, 384, 256),
    (1600, 128, 64), (1600, 576, 64), (1600, 576, 64), (1600, 576, 64), (1600, 576, 64), (1600, 128, 64),
    (1600, 128, 128), (1600, 384, 256), (25600, 576, 64), (25600, 576, 64), (25600, 64, 64), (25600, 64, 64),
    (6400, 1152, 64), (6400, 576, 64), (6400, 128, 64), (6400, 64, 64), (1600, 2304, 64), (1600, 576, 64),
    (1600, 256, 64), (1600, 64, 64),
]
RAGGED_SHAPES = [(1000, 27, 20), (1, 1, 1), (300, 2304, 7)]


def test_path_shapes_are_the_graphs():
    """PATH_SHAPES is what the port's yolo11n hands the kernel: one forward at 640 px
    (batch 1; M scales with the batch) with a hook on every quantizable conv."""
    from bsyolo_tpu_torch import YOLO
    from bsyolo_tpu_torch.nn.modules import quantizable_convs

    model = YOLO("yolo11n.yaml", device="cpu").model
    shapes = []

    def record(m, args):
        b, c, h, w = args[0].shape
        (k, _), (s, _), (p, _) = m.conv.kernel_size, m.conv.stride, m.conv.padding
        shapes.append((4 * b * ((h + 2 * p - k) // s + 1) * ((w + 2 * p - k) // s + 1), c * k * k, m.conv.out_channels))

    hooks = [m.register_forward_pre_hook(record) for _, m in quantizable_convs(model)]
    with torch.inference_mode():
        model(torch.zeros((1, 3, 640, 640)))
    for h in hooks:
        h.remove()
    assert shapes == PATH_SHAPES


@pytest.mark.parametrize("m,k,n", sorted(set(PATH_SHAPES)) + RAGGED_SHAPES)
def test_tile_plan_is_legal(m, k, n):
    """For float32 and bfloat16 out: a wgmma width (a multiple of 8, at most 256); 64
    or 128 rows, 128 only where that still gives every SM a tile (and never beside a
    256-wide tile); the narrowest width that holds N up to 256, or, with 64-row
    tiles, a narrower one whose tiles still fit on the SMs at once; stages of 32, 64
    or 128 bytes of K, as narrow as K allows; 1 to MAX_STAGES of them; the weight kept
    only where it is one tile wide and the blocks walk several tiles; shared memory
    within 227 KB."""
    from bsyolo_tpu_torch.kernels.int8_matmul import H100_SMS, MAX_STAGES, SMEM_LIMIT, smem_bytes, tile_plan

    for out_bytes in (4, 2):
        plan = tile_plan(m, n, k, out_bytes)
        bm, bn, kb, stages, resident = plan
        tiles = -(-m // bm) * -(-n // bn)
        narrowest = next(b for b in (16, 32, 64, 128, 256) if b >= min(n, 256))
        assert bn % 8 == 0 and bn <= 256
        assert bn == narrowest or (bm == 64 and bn < narrowest and tiles <= H100_SMS)
        assert bm in (64, 128) and 1 <= stages <= MAX_STAGES
        assert (bm == 128) == (narrowest < 256 and -(-m // 128) * -(-n // narrowest) >= H100_SMS)
        assert kb in (32, 64, 128) and (kb == 32 or kb // 2 < min(k, 128))
        assert not resident or (n <= bn and tiles >= 4 * H100_SMS)
        assert smem_bytes(plan, k, out_bytes) <= SMEM_LIMIT == 227 * 1024


def test_large_path_products_keep_their_weight():
    """On the yolo11n path, where each block walks several tiles (M of 102,400 and
    409,600: 800 and 3,200 tiles), it reads the weight once and keeps it; at M of
    25,600 and below (200 tiles or fewer) the weight rides in the stages. A weight
    wider than one tile or too deep for 227 KB streams."""
    from bsyolo_tpu_torch.kernels.int8_matmul import tile_plan

    assert all(tile_plan(m, n, k).resident == (m >= 102400) for m, k, n in PATH_SHAPES)
    assert not tile_plan(100000, 300, 64).resident  # two tiles of N
    assert not tile_plan(100000, 256, 8192).resident  # 2 MB of weight


def test_tile_plan_follows_the_card():
    """The rows per tile follow the SM count it is given; stages follow shared memory."""
    from bsyolo_tpu_torch.kernels.int8_matmul import tile_plan

    assert tile_plan(25600, 64, 576).bm == 128  # 200 tiles of 128 rows on 132 SMs
    assert tile_plan(25600, 64, 576, sms=264).bm == 64
    assert tile_plan(6400, 64, 576)[:2] == (64, 64)  # 100 tiles
    assert tile_plan(1600, 256, 512)[:2] == (64, 64)  # 100 tiles of 64 x 64, not 25 of 64 x 256
    assert tile_plan(1600, 256, 512, sms=264)[:2] == (64, 32)
    assert tile_plan(409600, 16, 27)[:3] == (128, 16, 32)  # the stem: 32-byte stages


def _rows(k, pitch, rows=8, offset=0):
    """A (rows, k) int8 view of rows ``pitch`` bytes apart, starting ``offset`` bytes in."""
    return torch.zeros(rows * pitch + 64, dtype=torch.int8)[offset:offset + rows * pitch].view(rows, pitch)[:, :k]


@pytest.mark.parametrize("t,readable", [
    (_rows(27, 32), True),  # the stem's im2col rows
    (_rows(48, 48), True),  # a contiguous K that is a multiple of 16
    (_rows(27, 27), False),  # contiguous K = 27: rows 27 bytes apart
    (_rows(16, 24), False),  # a pitch that is not a multiple of 16
    (_rows(32, 32, offset=8), False),  # a start that is not 16-byte aligned
    (_rows(32, 32, offset=16), True),
    (_rows(16, 16).t(), False),  # K not contiguous
    (_rows(64, 16 * 5)[:, 16:], True),  # a column window starting at a 16-byte boundary
    (torch.zeros((1, 16), dtype=torch.int8), True),
], ids=["stem-pitched", "contiguous-48", "contiguous-27", "pitch-24", "misaligned", "aligned-offset", "transposed",
        "column-window", "one-row"])
def test_tma_readable(t, readable):
    from bsyolo_tpu_torch.kernels.int8_matmul import tma_readable

    assert tma_readable(t) is readable


@pytest.mark.parametrize("k", [1, 16, 27, 48, 100])
def test_empty_rows_and_pitched(k):
    """empty_rows is read in place; pitched returns what is readable as it is and copies
    the rest into rows at a 16-byte pitch, with the same values."""
    from bsyolo_tpu_torch.kernels.int8_matmul import empty_rows, pitched, tma_readable

    rows = empty_rows(5, k, "cpu")
    assert rows.shape == (5, k) and tma_readable(rows) and rows.stride(0) == -(-k // 16) * 16
    assert pitched(rows) is rows
    src = torch.arange(5 * k, dtype=torch.int64).remainder(255).sub(127).to(torch.int8).view(5, k)
    copy = pitched(src)
    assert tma_readable(copy) and torch.equal(copy, src)
    assert (copy is src) == (k % 16 == 0)


def _conv_pair(rng, c1, c2, k, s):
    from bsyolo_tpu_torch.nn.modules import Conv

    jconv = JM.ConvBN(c2, k, s)
    variables = random_variables(variable_shapes(jconv, (1, 16, 16, c1)), seed=int(rng.integers(1 << 30)))
    return jconv, variables, port_module_from_jax(Conv(c1, c2, k, s), variables)


@pytest.fixture(autouse=True)
def _reset_jax_mode():
    yield
    JM.set_int8_inference(False)


# the stem (3 -> 16, k3 s2: K = 27) and 1x1 convs with K = 24 (pitch 32) and K = 32 (pitch 32, in place)
@pytest.mark.parametrize("c1,c2,k,s", [(3, 16, 3, 2), (24, 40, 1, 1), (32, 16, 1, 1)], ids=["stem", "1x1-24", "1x1-32"])
@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_conv_int8_feeds_the_kernel_pitched_rows(rng, monkeypatch, c1, c2, k, s, mode):
    """The int8 conv hands the matmul an x whose rows lie at a 16-byte pitch and whose
    first K columns are the unpadded im2col of its codes, and a cached weight that the
    kernel reads in place; its output matches the JAX ConvBN's int8 branch."""
    from bsyolo_tpu_torch.kernels import int8_matmul as im
    from bsyolo_tpu_torch.nn.modules import set_int8_inference

    jconv, variables, conv = _conv_pair(rng, c1, c2, k, s)
    x = rng.normal(0, 1, (2, 15, 17, c1)).astype(np.float32)
    scales = {"conv": 0.8 * float(np.abs(x).max())} if mode == "static" else None
    JM.set_int8_inference(True, scales)
    want = nchw(jax.jit(lambda v, xx: jconv.apply(v, xx, train=False))(variables, jnp.asarray(x)))
    set_int8_inference(conv, True, scales)

    seen = []

    def spy(x_i8, weight, sx, out_dtype=torch.float32):
        seen.append((x_i8, weight, sx))
        return im.int8_matmul_reference(x_i8, weight.w, weight.sw, sx, out_dtype)

    monkeypatch.setattr(im, "int8_matmul_prepared", spy)
    xt = torch.from_numpy(nchw(x))
    with torch.no_grad():
        got = conv(xt).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    (cols, weight, sx), = seen
    K = c1 * k * k
    assert cols.shape[1] == K and im.tma_readable(cols) and cols.stride(0) == -(-K // 16) * 16
    assert im.tma_readable(weight.w.t()) and weight.w.shape == (K, c2)
    # the same codes, unfolded independently: (B, C * k * k, L) -> (B * L, K), K ordered (cin, kh, kw)
    q = torch.round(xt / sx).clamp(-127, 127) if mode == "dynamic" else torch.round(xt * torch.reciprocal(sx)).clamp(-127, 127)
    unfolded = F.unfold(q, k, padding=k // 2, stride=s).transpose(1, 2).reshape(-1, K)
    assert torch.equal(cols.float(), unfolded)
