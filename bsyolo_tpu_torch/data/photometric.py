"""Photometric augmentations and the classification transforms (counterpart of
``bsyolo_tpu/data/photometric.py``): the reference's Albumentations list at its
probabilities, RandAugment, and the classify eval and train pipelines, through
``data/cv.py`` and the port's JPEG codec, deterministic under a caller's
Generator: one seed draws what the JAX functions draw, in the same order.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from bsyolo_tpu_torch.data import cv


def blur(img: np.ndarray, k: int = 7) -> np.ndarray:
    return cv.blur(img, max(3, int(k) | 1))


def median_blur(img: np.ndarray, k: int = 7) -> np.ndarray:
    return cv.median_blur(img, max(3, int(k) | 1))


def to_gray(img: np.ndarray) -> np.ndarray:
    return cv.gray2rgb(cv.rgb2gray(img))


def clahe(img: np.ndarray, clip_limit: float = 4.0, tile: int = 8) -> np.ndarray:
    """Contrast-limited adaptive histogram equalization on the L channel."""
    return cv.clahe(img, clip_limit, tile)


def photometric_suite(img: np.ndarray, rng: np.random.Generator, p: float = 1.0) -> np.ndarray:
    """Blur, MedianBlur, ToGray and CLAHE, each at p = 0.01, after one draw against ``p``
    (the reference's RandomBrightnessContrast, RandomGamma and ImageCompression are at p = 0)."""
    if rng.random() >= p:
        return img
    if rng.random() < 0.01:
        img = blur(img, int(rng.integers(3, 8)))
    if rng.random() < 0.01:
        img = median_blur(img, int(rng.integers(3, 8)))
    if rng.random() < 0.01:
        img = to_gray(img)
    if rng.random() < 0.01:
        img = clahe(img)
    return img


def brightness_contrast(img: np.ndarray, brightness: float = 0.0, contrast: float = 0.0) -> np.ndarray:
    """alpha = 1 + contrast, beta = 255 * brightness (Albumentations' semantics), clipped."""
    out = img.astype(np.float32) * (1.0 + contrast) + 255.0 * brightness
    return np.clip(out, 0, 255).astype(np.uint8)


def gamma(img: np.ndarray, g: float = 1.0) -> np.ndarray:
    lut = np.clip(((np.arange(256) / 255.0) ** g) * 255.0, 0, 255).astype(np.uint8)
    return lut[img]


def jpeg_compression(img: np.ndarray, quality: int = 75) -> np.ndarray:
    """An RGB image through the port's JPEG encoder at ``quality`` and back (the bytes of
    ``cv2.imencode`` and the pixels of ``cv2.imdecode``)."""
    from bsyolo_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg

    return np.ascontiguousarray(decode_jpeg(encode_jpeg(np.ascontiguousarray(img[..., ::-1]), int(quality)))[..., ::-1])


# --- the classification transforms ----------------------------------------------------------------

DEFAULT_MEAN = (0.0, 0.0, 0.0)
DEFAULT_STD = (1.0, 1.0, 1.0)
DEFAULT_CROP_FRACTION = 1.0


def rand_augment(img: np.ndarray, rng: np.random.Generator, num_ops: int = 2, magnitude: int = 9) -> np.ndarray:
    """RandAugment on uint8 RGB: ``num_ops`` ops drawn from the 14 of torchvision's T.RandAugment at
    ``magnitude`` on the 31-bin scale; each op draws its own sign. The affine ops fill with grey 128."""
    m = magnitude / 31.0
    h, w = img.shape[:2]

    def sign():
        return 1 if rng.random() < 0.5 else -1

    def _affine(mat):
        return cv.warp_affine(img, mat, (w, h), border_value=(128, 128, 128))

    def _blend(other, factor):
        return np.clip(img.astype(np.float32) * factor + other.astype(np.float32) * (1 - factor), 0, 255
                       ).astype(np.uint8)

    def shear_x():
        return _affine(np.float32([[1, m * 0.3 * sign(), 0], [0, 1, 0]]))

    def shear_y():
        return _affine(np.float32([[1, 0, 0], [m * 0.3 * sign(), 1, 0]]))

    def translate_x():
        return _affine(np.float32([[1, 0, m * 150 / 331 * w * sign()], [0, 1, 0]]))

    def translate_y():
        return _affine(np.float32([[1, 0, 0], [0, 1, m * 150 / 331 * h * sign()]]))

    def rotate():
        return _affine(cv.rotation_matrix_2d((w / 2, h / 2), m * 30 * sign(), 1.0))

    def brightness():
        return _blend(np.zeros_like(img), 1 + m * 0.9 * sign())

    def contrast():
        return _blend(np.full_like(img, int(img.astype(np.float32).mean())), 1 + m * 0.9 * sign())

    def color():
        return _blend(cv.gray2rgb(cv.rgb2gray(img)), 1 + m * 0.9 * sign())

    def sharpness():
        return _blend(cv.gaussian_blur5(img), 1 + m * 0.9 * sign())

    def posterize():
        shift = 8 - max(8 - int(round(m * 4)), 4)
        return ((img >> shift) << shift).astype(np.uint8)

    def solarize():
        thr = int(255 * (1 - m))
        return np.where(img >= thr, 255 - img, img).astype(np.uint8)

    def autocontrast():
        out = img.astype(np.float32)
        for c in range(3):
            lo, hi = out[..., c].min(), out[..., c].max()
            if hi > lo:
                out[..., c] = (out[..., c] - lo) * 255.0 / (hi - lo)
        return out.astype(np.uint8)

    def equalize():
        out = img.copy()
        for c in range(3):
            out[..., c] = cv.equalize_hist(np.ascontiguousarray(out[..., c]))
        return out

    ops = (lambda: img, autocontrast, equalize, rotate, solarize, color, posterize, contrast, brightness, sharpness,
           shear_x, shear_y, translate_x, translate_y)
    for _ in range(num_ops):
        img = ops[int(rng.integers(len(ops)))]()
    return img


def _normalize(img: np.ndarray, mean: Sequence[float], std: Sequence[float]) -> np.ndarray:
    return (img.astype(np.float32) / 255.0 - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def classify_eval_transform(img: np.ndarray, size: int = 224, crop_fraction: float = DEFAULT_CROP_FRACTION,
                            mean: Sequence[float] = DEFAULT_MEAN, std: Sequence[float] = DEFAULT_STD) -> np.ndarray:
    """The shortest edge resized to ``size / crop_fraction`` (INTER_LINEAR), the centre ``size`` square
    cropped, float32 (size, size, 3) normalized by ``mean`` and ``std`` on the [0, 1] scale."""
    scale = int(np.floor(size / crop_fraction))
    h, w = img.shape[:2]
    r = scale / min(h, w)
    img = cv.resize(img, (max(scale, int(round(w * r))), max(scale, int(round(h * r)))), cv.INTER_LINEAR)
    h, w = img.shape[:2]
    top, left = (h - size) // 2, (w - size) // 2
    return _normalize(img[top : top + size, left : left + size], mean, std)


def classify_train_transform(img: np.ndarray, rng: np.random.Generator, size: int = 224,
                             scale: Tuple[float, float] = (0.08, 1.0), ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
                             hflip: float = 0.5, vflip: float = 0.0, hsv_h: float = 0.015, hsv_s: float = 0.4,
                             hsv_v: float = 0.4, erasing: float = 0.0, auto_augment: Optional[str] = None,
                             mean: Sequence[float] = DEFAULT_MEAN, std: Sequence[float] = DEFAULT_STD) -> np.ndarray:
    """A random resized crop (10 tries, else the centre square), resized to ``size`` (INTER_LINEAR), flips,
    RandAugment where ``auto_augment`` names a policy (it stands for autoaugment and augmix too) or else the
    HSV jitter, normalization, then random erasing with probability ``erasing``: float32 (size, size, 3)."""
    from bsyolo_tpu_torch.data.augment import random_hsv

    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target = area * rng.uniform(*scale)
        ar = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        cw, ch = int(round(np.sqrt(target * ar))), int(round(np.sqrt(target / ar)))
        if cw <= w and ch <= h:
            x0, y0 = int(rng.integers(0, w - cw + 1)), int(rng.integers(0, h - ch + 1))
            img = img[y0 : y0 + ch, x0 : x0 + cw]
            break
    else:
        s = min(h, w)
        img = img[(h - s) // 2 : (h + s) // 2, (w - s) // 2 : (w + s) // 2]
    img = cv.resize(np.ascontiguousarray(img), (size, size), cv.INTER_LINEAR)
    if hflip > 0 and rng.random() < hflip:
        img = img[:, ::-1]
    if vflip > 0 and rng.random() < vflip:
        img = img[::-1]
    img = np.ascontiguousarray(img)
    if auto_augment:
        img = rand_augment(img, rng)
    elif hsv_h or hsv_s or hsv_v:
        img = random_hsv(img, rng, hsv_h, hsv_s, hsv_v)
    out = _normalize(img, mean, std)
    if erasing > 0 and rng.random() < erasing:
        eh, ew = int(size * rng.uniform(0.05, 0.2)), int(size * rng.uniform(0.05, 0.2))
        y0, x0 = int(rng.integers(0, size - eh)), int(rng.integers(0, size - ew))
        out[y0 : y0 + eh, x0 : x0 + ew] = rng.normal(size=(eh, ew, 3)).astype(np.float32)
    return out
