"""Image-batch normalization inside the step (counterpart of ``bsyolo_tpu/ops/normalize.py``).

Batches travel to the card as uint8 (a quarter of float32's bytes) and become
model-ready floats in one place, on the card.
"""

from __future__ import annotations

import torch


def normalize_image_batch(x: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [0, 1]; float inputs pass through unchanged."""
    if x.dtype == torch.uint8:
        return x.float() / 255.0
    return x
