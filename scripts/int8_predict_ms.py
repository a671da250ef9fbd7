#!/usr/bin/env python3
"""Time the port's live int8 predict of yolo11n (forward and decode) on one CUDA card.

    python3 scripts/int8_predict_ms.py [ROOT] [--calls N]

Imports ``bsyolo_tpu_torch`` from ROOT (a checkout of this repository; this one by
default), so that two checkouts can be compared on one card by running this script
for each in turns (a, b, b, a). The graph is yolo11n (nc 12, seed 0) at 640 px,
batch 4, on uniform random input; int8 uses static scales calibrated on four
uniform batches (seed 0). Prints the card's name and power limit, then one JSON
line: ms per batch of int8 and of float, each the median over 5 rounds of N calls
(host clock, the card synchronized around each round), and the ``int8_matmul``
launches of one int8 forward.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

IMGSZ, BATCH, ROUNDS = 640, 4, 5


def main() -> int:
    args = sys.argv[1:]
    calls = 20
    if "--calls" in args:
        i = args.index("--calls")
        calls = int(args[i + 1])
        del args[i : i + 2]
    root = Path(args[0] if args else Path(__file__).resolve().parents[1]).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("int8_predict_ms: no CUDA card is available", file=sys.stderr)
        return 1
    from bsyolo_tpu_torch import YOLO, kernels
    from bsyolo_tpu_torch.nn.heads import decode_detections
    from bsyolo_tpu_torch.nn.modules import set_int8_inference
    from bsyolo_tpu_torch.nn.quant import calibrate_int8

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    model = YOLO("yolo11n.yaml", seed=0)
    graph, spec = model.model.eval(), model.spec
    dev = next(graph.parameters()).device
    rng = np.random.default_rng(0)
    calib = [torch.from_numpy(rng.uniform(0, 1, (BATCH, 3, IMGSZ, IMGSZ)).astype(np.float32)).to(dev)
             for _ in range(4)]
    scales = calibrate_int8(graph, calib)
    x = torch.rand((BATCH, 3, IMGSZ, IMGSZ), generator=torch.Generator().manual_seed(1)).to(dev)

    def predict():
        with torch.inference_mode():
            return decode_detections(graph(x), spec.head_strides, spec.nc, spec.reg_max)

    def rounds(int8: bool):
        set_int8_inference(graph, int8, scales if int8 else None)
        for _ in range(3):
            predict()
        out = []
        for _ in range(ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                predict()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3 / calls)
        return out

    int8_ms = rounds(True)  # in turns: int8, float, float, int8
    float_ms = rounds(False) + rounds(False)
    int8_ms += rounds(True)
    set_int8_inference(graph, True, scales)
    kernels.reset_launch_counts()
    predict()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()["int8_matmul"]
    print(json.dumps({"root": str(root), "card": card, "torch": torch.__version__, "imgsz": IMGSZ, "batch": BATCH,
                      "calls": calls, "int8_ms": statistics.median(int8_ms), "float_ms": statistics.median(float_ms),
                      "int8_ms_rounds": int8_ms, "float_ms_rounds": float_ms,
                      "int8_matmul_per_forward": launches}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
