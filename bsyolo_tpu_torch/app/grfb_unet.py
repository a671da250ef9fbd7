"""GRFB-UNet tactile-paving segmentation network in PyTorch, NCHW (counterpart of
``bsyolo_tpu/app/grfb_unet.py``).

Reference: sys/src/GRFBUNet.py: a UNet whose Down blocks append a GRFB (group
receptive field block): three dilated-conv branches (dilations visual,
2 * visual, 3 * visual) and a shortcut, fused at scale 0.1. The application
uses in_channels 3, num_classes 2, base_c 32 (sys/videobytetrack.py:220-223).
The JAX package has no Pallas kernel here, and neither has the port: the
convolutions are cuDNN's (``F.conv2d``), as the detector's are. Module names
follow the flax ones (``down1.grfb.b0.0.conv``), so ``utils/weights.py
grfb_unet_state_dict_from_jax`` carries JAX variables across.

``BlindwaySegmenter`` does its whole frame-to-mask work on the model's device
and makes one device-to-host copy, the (H, W) uint8 mask.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from bsyolo_tpu_torch.ops.resize import resize_linear_u8

BN_EPS = 1e-5  # flax's BatchNorm epsilon in the JAX graph


def _bn(c: int, flax_momentum: float) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS, momentum=1.0 - flax_momentum)


class BasicConv(nn.Module):
    """conv + BN + optional ReLU (reference GRFBUNet.py BasicConv)."""

    def __init__(self, c1: int, c2: int, k: int = 1, p: int = 0, d: int = 1, g: int = 1, relu: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, padding=p, dilation=d, groups=g, bias=False)
        self.bn = _bn(c2, 0.99)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


class GRFB(nn.Module):
    """Group receptive field block (reference GRFBUNet.py:95-143)."""

    def __init__(self, c1: int, c2: int, scale: float = 0.1, visual: int = 12):
        super().__init__()
        ip, v = c1 // 8, visual  # inter_planes
        self.scale = scale
        self.b0 = nn.Sequential(
            BasicConv(c1, 2 * ip), BasicConv(2 * ip, 2 * ip, 3, p=v, d=v, relu=False), BasicConv(2 * ip, 2 * ip))
        self.b1 = nn.Sequential(
            BasicConv(c1, ip), BasicConv(ip, 2 * ip, 3, p=1, g=ip), BasicConv(2 * ip, 2 * ip),
            BasicConv(2 * ip, 2 * ip, 3, p=2 * v, d=2 * v, relu=False), BasicConv(2 * ip, 2 * ip))
        self.b2 = nn.Sequential(
            BasicConv(c1, ip), BasicConv(ip, 2 * ip, 3, p=1, g=ip), BasicConv(2 * ip, 2 * ip),
            BasicConv(2 * ip, 2 * ip, 3, p=1, g=2 * ip), BasicConv(2 * ip, 2 * ip),
            BasicConv(2 * ip, 2 * ip, 3, p=3 * v, d=3 * v, relu=False), BasicConv(2 * ip, 2 * ip))
        self.linear = BasicConv(c1 + 6 * ip, c2, relu=False)
        self.shortcut = BasicConv(c1, c2, relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.linear(torch.cat([x, self.b0(x), self.b1(x), self.b2(x)], 1))
        return F.relu(out * self.scale + self.shortcut(x))


class DoubleConv(nn.Module):
    """Two conv + BN + ReLU, then a GRFB in the encoder's Down blocks."""

    def __init__(self, c1: int, c2: int, mid: int = 0, with_grfb: bool = False):
        super().__init__()
        mid = mid or c2
        self.c0_conv = nn.Conv2d(c1, mid, 3, padding=1, bias=False)
        self.c0_bn = _bn(mid, 0.9)
        self.c1_conv = nn.Conv2d(mid, c2, 3, padding=1, bias=False)
        self.c1_bn = _bn(c2, 0.9)
        self.grfb = GRFB(c2, c2) if with_grfb else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.c0_bn(self.c0_conv(x)))
        x = F.relu(self.c1_bn(self.c1_conv(x)))
        return self.grfb(x) if self.grfb is not None else x


class Down(DoubleConv):
    """2x2 max pool (odd sizes floored, as flax's VALID pool), then a DoubleConv with a GRFB."""

    def __init__(self, c1: int, c2: int):
        super().__init__(c1, c2, with_grfb=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(F.max_pool2d(x, 2, 2))


class Up(DoubleConv):
    """x2 bilinear upsampling (half-pixel centres, edges clamped: ``jax.image.resize``'s bilinear when
    enlarging), zero padding to the skip's size, concatenation after the skip, then a DoubleConv."""

    def __init__(self, c1: int, c2: int, bilinear: bool = True):
        super().__init__(c1, c2, mid=c1 // 2 if bilinear else 0)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
        dh, dw = skip.shape[2] - x.shape[2], skip.shape[3] - x.shape[3]
        x = F.pad(x, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        return super().forward(torch.cat([skip, x], 1))


class GRFBUNet(nn.Module):
    """UNet with a GRFB-augmented encoder (reference GRFBUNet.py:145-176): (B, 3, H, W) -> (B,
    num_classes, H, W) logits."""

    def __init__(self, num_classes: int = 2, base_c: int = 32, bilinear: bool = True):
        super().__init__()
        c, factor = base_c, 2 if bilinear else 1
        self.in_conv = DoubleConv(3, c)
        self.down1 = Down(c, c * 2)
        self.down2 = Down(c * 2, c * 4)
        self.down3 = Down(c * 4, c * 8)
        self.down4 = Down(c * 8, c * 16 // factor)
        self.up1 = Up(c * 16 // factor + c * 8, c * 8 // factor, bilinear)
        self.up2 = Up(c * 8 // factor + c * 4, c * 4 // factor, bilinear)
        self.up3 = Up(c * 4 // factor + c * 2, c * 2 // factor, bilinear)
        self.up4 = Up(c * 2 // factor + c, c, bilinear)
        self.out_conv = nn.Conv2d(c, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.in_conv(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        y = self.up1(self.down4(x4), x4)
        y = self.up2(y, x3)
        y = self.up3(y, x2)
        return self.out_conv(self.up4(y, x1))


# normalization constants from the reference app (sys/videobytetrack.py:102-103), RGB
BLINDWAY_MEAN = (0.709, 0.381, 0.224)
BLINDWAY_STD = (0.127, 0.079, 0.043)


def segment_size(h: int, w: int, resize: int):
    """The network's input size for an (h, w) frame: the short side to ``resize``, each side snapped
    to a multiple of 16 (which keeps the UNet's pool and upsampling path shape-stable)."""
    r = resize / min(h, w)
    return int(round(h * r / 16)) * 16, int(round(w * r / 16)) * 16


class BlindwaySegmenter:
    """Tactile-paving mask of a frame, as the reference's segment_image (sys/videobytetrack.py:169-203):
    short-side resize to ``resize``, normalize, GRFB-UNet, argmax, the class map resized back to the
    frame and thresholded to {0, 255}.

    Every step runs on ``device`` (``cuda:0`` by default; raises without a card): the uint8 frame is
    uploaded, resized with OpenCV's 8-bit INTER_LINEAR arithmetic (``ops/resize.py``, byte-equal to
    the JAX package's ``cv2.resize``), normalized, segmented; the {0, 1} class map is resized back the
    same way and kept where it is above 0; one copy brings the (H, W) uint8 mask to the host.

    ``state_dict``: weights to load (``grfb_unet_state_dict_from_jax`` carries JAX variables);
    none: initialised from ``seed`` with an explicit generator (no trained weights are in the
    repository, ROADMAP queue 1, item 28)."""

    def __init__(self, state_dict=None, num_classes: int = 2, base_c: int = 32, resize: int = 565, seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None):
        from bsyolo_tpu_torch import select_device

        self.device = select_device(device)
        self.resize = resize
        self.model = GRFBUNet(num_classes=num_classes, base_c=base_c)
        if state_dict is None:
            _init_from_generator(self.model, torch.Generator().manual_seed(seed))
        else:
            self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device).eval()
        self._mean = torch.tensor(BLINDWAY_MEAN, device=self.device).view(1, 3, 1, 1)
        self._std = torch.tensor(BLINDWAY_STD, device=self.device).view(1, 3, 1, 1)

    def network_input(self, frame_bgr: np.ndarray) -> torch.Tensor:
        """(H, W, 3) BGR uint8 frame -> the network's (1, 3, h, w) normalized RGB float32 input, on the
        device."""
        if frame_bgr.dtype != np.uint8 or frame_bgr.ndim != 3 or frame_bgr.shape[2] != 3:
            raise ValueError(f"expected a uint8 (H, W, 3) BGR frame, got {frame_bgr.dtype} {frame_bgr.shape}")
        x = torch.from_numpy(np.ascontiguousarray(frame_bgr)).to(self.device).permute(2, 0, 1)
        x = resize_linear_u8(x, segment_size(*frame_bgr.shape[:2], self.resize))
        # a product by 1 / 255, not a division: CUDA divides a tensor by a scalar as a product by its
        # reciprocal, so this way the card and the CPU give the same input
        x = x.flip(0)[None].float() * (1.0 / 255.0)
        return (x - self._mean) / self._std

    @staticmethod
    def mask_from_logits(logits: torch.Tensor, size) -> np.ndarray:
        """(1, num_classes, h, w) logits -> the (H, W) uint8 {0, 255} mask at ``size`` = (H, W), on the host."""
        cls = logits.argmax(1)[0].to(torch.uint8)
        return ((resize_linear_u8(cls, size) > 0).to(torch.uint8) * 255).cpu().numpy()

    @torch.inference_mode()
    def __call__(self, frame_bgr: np.ndarray) -> np.ndarray:
        """frame (H, W, 3) BGR uint8 -> mask (H, W) uint8 in {0, 255}, on the host."""
        return self.mask_from_logits(self.model(self.network_input(frame_bgr)), frame_bgr.shape[:2])


def _init_from_generator(model: nn.Module, g: torch.Generator) -> None:
    """Seeded initialisation: convolution kernels from flax's default (LeCun normal: variance
    1 / fan_in, truncated at 2 standard deviations), biases 0, BatchNorm at the identity."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                std = (1.0 / (m.weight[0].numel())) ** 0.5 / 0.87962566103423978
                m.weight.copy_(torch.nn.init.trunc_normal_(torch.empty(m.weight.shape), 0.0, std, -2 * std, 2 * std,
                                                           generator=g))
                if m.bias is not None:
                    m.bias.zero_()
