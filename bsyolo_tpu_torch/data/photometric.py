"""The photometric augmentations of the detect path (counterpart of the detect part of
``bsyolo_tpu/data/photometric.py``): the reference's Albumentations list at its
probabilities, through ``data/cv.py``, deterministic under a caller's Generator."""

from __future__ import annotations

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
