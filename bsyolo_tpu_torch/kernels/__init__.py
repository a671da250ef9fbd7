"""Hand-written CUDA kernels of the port, each with its plain PyTorch version.

Every kernel wrapper counts its launches in a ``launches`` attribute, so a run
can show that a path went through the kernel and not its plain version.
"""

from __future__ import annotations

from typing import Dict

from bsyolo_tpu_torch.kernels import decode

# kernel name -> (wrapper with a launch count, CUDA source stem)
KERNELS = {"decode_box_best": (decode.box_best_cuda, "decode_box")}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, (fn, _) in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn, _ in KERNELS.values():
        fn.launches = 0
