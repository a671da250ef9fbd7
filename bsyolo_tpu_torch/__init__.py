"""PyTorch/CUDA port of bsyolo_tpu: the BS-YOLO detector served on an NVIDIA H100.

Entry points run on CUDA unless the caller names another device; with no
CUDA present they raise instead of falling back to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def select_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``cuda:0`` by default, else the device asked for; raises when CUDA is
    asked for (explicitly or by default) and none is present."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but CUDA is not available; pass device='cpu' to run on the host"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


from bsyolo_tpu_torch.model import YOLO  # noqa: E402  (needs select_device above)

__all__ = ["YOLO", "select_device"]
