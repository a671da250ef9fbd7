#!/usr/bin/env python3
"""The decode stage of the port's predict paths on one NVIDIA card, to compare trees.

    python3 decode_bench.py [--tree DIR] [--reps N]

Imports ``bsyolo_tpu_torch`` from DIR (default: the directory of this script),
so the same measurement runs on an unpacked archive of another commit, builds
that tree's kernels, and times the decode stage as the paths call it on seeded
head maps at the paths' shapes (yolo11n's three levels, nc 12):

- plain predict: ``kernels/postprocess.detect_postprocess`` with its NMS
  (``nms_from_logits``) replaced by a function that returns its inputs, so
  each call runs what the postprocess runs before NMS: B = 1, 4 and 8 at
  640 px; B = 2 at 224 px with nc 80;
- TTA and tiled predict: ``nn/heads.decode_detections``: B = 4 at 640, 544 and
  448 px (the TTA passes), B = 6 and 8 at 640 px (tiles).

Each call reads its head maps from a ring of copies larger than the 50 MB L2.
For each shape: device time per call (torch.profiler: every device kernel the
calls ran), device kernels per call, device time of the decode kernel alone,
host time per call (a loop of calls that does not wait for the card), and time
per call from CUDA events. Works on any tree of the port: their
``detect_postprocess`` and ``decode_detections`` take the Detect head's
per-level maps. Prints the card's name and power limit, then one JSON object
per shape. Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

STRIDES = (8, 16, 32)
# (entry, label, B, image side, nc)
SHAPES = (
    ("detect_postprocess", "B1 640", 1, 640, 12),
    ("detect_postprocess", "B4 640", 4, 640, 12),
    ("detect_postprocess", "B8 640", 8, 640, 12),
    ("detect_postprocess", "B2 224 nc80", 2, 224, 80),
    ("decode_detections", "B4 640", 4, 640, 12),
    ("decode_detections", "B4 544", 4, 544, 12),
    ("decode_detections", "B4 448", 4, 448, 12),
    ("decode_detections", "B6 640", 6, 640, 12),
    ("decode_detections", "B8 640", 8, 640, 12),
)


def measure(fn, ring, reps: int) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for levels in ring[:3]:
        fn(levels)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(ring[i % len(ring)])
    end.record()
    torch.cuda.synchronize()
    event_us = start.elapsed_time(end) * 1e3 / reps
    t0 = time.perf_counter()
    for i in range(reps):
        fn(ring[i % len(ring)])
    host_us = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(ring[i % len(ring)])
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernel = [e for e in events if "decode" in e.name]
    return {
        "device_us": sum(e.time_range.end - e.time_range.start for e in events) / reps,
        "kernels_per_call": len(events) / reps,
        "decode_kernel_us": sum(e.time_range.end - e.time_range.start for e in kernel) / reps,
        "host_us": host_us,
        "event_us": event_us,
        "device_items": sorted({e.name[:60] for e in events}),
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=str(Path(__file__).resolve().parent), help="checkout to import the port from")
    parser.add_argument("--reps", type=int, default=200)
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("decode_bench: no CUDA card is available; this script runs only on one", file=sys.stderr)
        return 1
    import bsyolo_tpu_torch
    from bsyolo_tpu_torch.kernels import postprocess
    from bsyolo_tpu_torch.nn.heads import decode_detections

    postprocess.nms_from_logits = lambda *inputs, **_: inputs  # detect_postprocess stops before its NMS
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"package {Path(bsyolo_tpu_torch.__file__).parent}; torch {torch.__version__} CUDA {torch.version.cuda}")
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(0)
    for entry, label, b, side, nc in SHAPES:
        levels = [torch.randn((b, 64 + nc, side // s, side // s), generator=g, device=dev) * 2.0 for s in STRIDES]
        ring = [[f.clone() for f in levels] for _ in range(max(2, math.ceil(120e6 / sum(f.nbytes for f in levels))))]
        if entry == "detect_postprocess":
            row = measure(lambda f, nc=nc: postprocess.detect_postprocess(f, STRIDES, nc), ring, args.reps)
        else:
            row = measure(lambda f, nc=nc: decode_detections(f, STRIDES, nc), ring, args.reps)
        print(json.dumps({"entry": entry, "shape": label, "anchors": sum((side // s) ** 2 for s in STRIDES), **row}))
        del ring
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
