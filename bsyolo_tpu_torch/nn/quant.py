"""Post-training int8 calibration (counterpart of ``bsyolo_tpu/nn/quant.py``).

Max calibration: a float forward over a few batches records each quantizable
conv's input abs-max; the maxima become static activation scales.

    scales = calibrate_int8(model, batches)   # {"model.0.conv": 1.0, ...}
    set_int8_inference(model, True, scales)   # static int8
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch

from bsyolo_tpu_torch.nn.modules import quantizable_convs, scale_key, set_int8_calibration


def calibrate_int8(model: torch.nn.Module, batches: Iterable) -> Dict[str, float]:
    """Run ``batches`` (float NCHW tensors or arrays, as the graph takes them) through
    ``model`` in float and eval mode; returns ``{conv name: running max of |input|}``
    for ``set_int8_inference``. Int8 inference is left off and the hooks removed,
    also when a batch raises."""
    was_training = model.training
    device = next(model.parameters()).device
    model.eval()
    set_int8_calibration(model, True)
    try:
        with torch.inference_mode():
            for x in batches:
                model(torch.as_tensor(x, device=device))
        scales = {scale_key(name): float(m.conv.calib_absmax)
                  for name, m in quantizable_convs(model) if m.conv.calib_absmax is not None}
    finally:
        set_int8_calibration(model, False)
        model.train(was_training)
    if not scales:
        raise ValueError("calibration saw no quantizable convs (no Conv with groups=1?)")
    return scales
